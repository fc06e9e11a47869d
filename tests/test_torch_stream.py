"""Port parity: host-resident streams (`core.stream`), their spill to
disk, the stream cache, and the out-of-core plan models.

* The port's host stream equals the JAX package's `host_stream` element
  for element (words compared as uint32), padding included.
* Spills: a round trip is bitwise; a corrupted checksum raises
  `StreamIntegrityError` and `load_or_rebuild` rebuilds; a directory
  spilled by the JAX package loads and verifies in the port, and the
  port's spill loads in the JAX package (the same ``.npy`` files, the same
  CRC over bytes).
* The stream cache builds each key once under 16 threads.
* The byte models equal the JAX package's term for term, and the
  streaming decision, ``chunk_m`` and ``n_chunks`` agree at equal
  ``block_m``.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro.core import alto as jalto
from repro.core import plan as jplan
from repro.core import stream as jstream
from repro.sparse import synthetic as jsyn
from repro_torch import interop
from repro_torch.core import alto as talto
from repro_torch.core import heuristics as theur
from repro_torch.core import plan as tplan
from repro_torch.core import stream as tstream
from repro_torch.core import views as tviews
from repro_torch.sparse import synthetic as tsyn

DIMS = (30, 24, 20)


def _port_tensor(ref):
    m = ref.meta
    return interop.alto_tensor(
        np.asarray(ref.words), np.asarray(ref.values),
        np.asarray(ref.part_start), np.asarray(ref.part_end), dims=m.dims,
        nnz=m.nnz, n_partitions=m.n_partitions, temp_rows=m.temp_rows,
        fiber_reuse=m.fiber_reuse, device="cpu")


@pytest.fixture(scope="module")
def pair():
    x = jsyn.blocked_tensor(DIMS, 900, block=6, n_blocks=6, seed=5,
                            count_data=True)
    jat = jalto.build(x, n_partitions=8)
    return jat, _port_tensor(jat)


def _assert_same_stream(hs: tstream.HostStream, js) -> None:
    assert hs.length == js.length and hs.mode == js.mode
    np.testing.assert_array_equal(hs.rows.numpy(), np.asarray(js.rows))
    np.testing.assert_array_equal(hs.words.numpy().view(np.uint32),
                                  np.asarray(js.words))
    np.testing.assert_array_equal(hs.values.numpy(), np.asarray(js.values))


@pytest.mark.parametrize("mode", range(3))
def test_host_stream_matches_reference(pair, mode):
    jat, at = pair
    js = jstream.host_stream(jat, mode)
    hs = tstream.host_stream(at, mode)
    _assert_same_stream(hs, js)
    assert hs.rows.shape[0] % tstream.STREAM_ALIGN == 0
    assert hs.rows.dtype == torch.int32 and hs.words.dtype == torch.int32
    assert not hs.pinned                         # a CPU tensor's stream
    assert tstream.stream_checksum(hs.rows, hs.words, hs.values) \
        == jstream.stream_checksum(js.rows, js.words, js.values)
    # an in-core view adapts to the same stream, and its in-core prefix is
    # element for element the view
    view = talto.oriented_view_device(at, mode)
    _assert_same_stream(tstream.ensure_host(view), js)
    assert torch.equal(hs.rows[:hs.length], view.rows)
    assert tstream.ensure_host(hs) is hs


@pytest.mark.parametrize("block_m", [8, 64, 1024])
def test_padded_len_and_zero_copy_chunks(pair, block_m):
    _, at = pair
    hs = tstream.host_stream(at, 1)
    js = jstream.host_stream(pair[0], 1)
    assert hs.padded_len(block_m) == js.padded_len(block_m)
    start = hs.padded_len(block_m) - block_m
    rows, words, values = hs.chunk(start, start + block_m)
    assert rows.data_ptr() == hs.rows[start:].data_ptr()
    assert words.shape == (block_m, hs.words.shape[1])
    assert values.data_ptr() == hs.values[start:].data_ptr()
    with pytest.raises(ValueError, match="STREAM_ALIGN"):
        hs.padded_len(3)


@pytest.mark.parametrize("n", [0, 1, 1000, 1024, 1500])
def test_pad_host_stream_matches_reference(n):
    rng = np.random.default_rng(n)
    rows = np.sort(rng.integers(0, 9, size=n)).astype(np.int32)
    words = rng.integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    values = rng.standard_normal(n).astype(np.float32)
    want = jstream.pad_host_stream(rows, words, values,
                                   tstream.STREAM_ALIGN)
    got = tstream.pad_host_stream(
        torch.from_numpy(rows), torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(values), tstream.STREAM_ALIGN)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


def test_memmap_round_trip_and_integrity(pair, tmp_path):
    _, at = pair
    hs = tstream.host_stream(at, 0)
    mapped = tstream.to_memmap(hs, tmp_path / "s")
    assert mapped.directory == tmp_path / "s" and not mapped.pinned
    for a, b in zip((mapped.rows, mapped.words, mapped.values),
                    (hs.rows, hs.words, hs.values)):
        assert torch.equal(a, b)
    assert mapped.checksum == tstream.stream_checksum(hs.rows, hs.words,
                                                      hs.values)
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == [
        "checksum.npy", "length.npy", "rows.npy", "values.npy", "words.npy"]
    # corrupt one payload byte behind the stored checksum
    tstream.integrity_stats_clear()
    vals = np.load(tmp_path / "s" / "values.npy")
    vals[5] += 1.0
    np.save(tmp_path / "s" / "values.npy", vals)
    with pytest.raises(tstream.StreamIntegrityError, match="checksum"):
        tstream.from_memmap(tmp_path / "s", at.meta, 0)
    assert tstream.integrity_stats()["checksum_failures"] == 1
    rebuilt = tstream.load_or_rebuild(tmp_path / "s", at, 0)
    assert torch.equal(rebuilt.values, hs.values)
    assert tstream.integrity_stats() == {"checksum_failures": 2,
                                         "rebuilds": 1}
    assert tstream.from_memmap(tmp_path / "s", at.meta, 0).checksum \
        == mapped.checksum
    # an unreadable directory rebuilds too
    fresh = tstream.load_or_rebuild(tmp_path / "missing", at, 0)
    assert torch.equal(fresh.rows, hs.rows)


def test_spills_are_shared_with_the_reference(pair, tmp_path):
    jat, at = pair
    js = jstream.to_memmap(jstream.host_stream(jat, 2), tmp_path / "jax")
    hs = tstream.from_memmap(tmp_path / "jax", at.meta, 2)
    assert hs.checksum == js.checksum
    _assert_same_stream(hs, js)
    tstream.to_memmap(tstream.host_stream(at, 2), tmp_path / "port")
    back = jstream.from_memmap(tmp_path / "port", jat.meta, 2)
    assert back.checksum == js.checksum
    _assert_same_stream(hs, back)


def test_interop_host_stream(pair):
    jat, at = pair
    js = jstream.host_stream(jat, 1)
    hs = interop.host_stream(at.meta, 1, js.length, js.rows, js.words,
                             js.values)
    _assert_same_stream(hs, js)
    _assert_same_stream(tstream.host_stream(at, 1), js)


def test_append_stream_in_memory_and_spilled(tmp_path):
    a = talto.build_device(tsyn.uniform_tensor(DIMS, 300, seed=1),
                           n_partitions=4, device="cpu")
    b = talto.build_device(tsyn.uniform_tensor(DIMS, 500, seed=2),
                           n_partitions=4, device="cpu")
    fresh = tstream.append_stream(tstream.host_stream(a, 0), b)
    assert fresh.directory is None
    assert torch.equal(fresh.rows, tstream.host_stream(b, 0).rows)
    spilled = tstream.to_memmap(tstream.host_stream(a, 0), tmp_path)
    old_rows = spilled.rows.clone()
    grown = tstream.append_stream(spilled, b)
    assert grown.directory == tmp_path and grown.length == fresh.length
    assert torch.equal(grown.words, fresh.words)
    assert torch.equal(spilled.rows, old_rows)    # old maps stay valid


def test_stream_cache_builds_each_key_once(monkeypatch):
    """16 threads over 8 (tensor, mode) keys: one build per key, and the
    same object for the same key; streams live beside views."""
    monkeypatch.delenv("REPRO_VIEW_CACHE_BYTES", raising=False)
    monkeypatch.delenv("REPRO_VIEW_CACHE_SIZE", raising=False)
    tensors = [talto.build_device(tsyn.uniform_tensor(DIMS, 200, seed=i),
                                  n_partitions=2, device="cpu")
               for i in range(4)]
    keys = [(at, m) for at in tensors for m in (0, 1)]
    tviews.cache_clear()
    got, errors = {}, []
    barrier = threading.Barrier(16)

    def work(i):
        try:
            barrier.wait()
            at, m = keys[i % len(keys)]
            got[i] = tviews.get_stream(at, m)
        except BaseException as e:      # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    stats = tviews.cache_stats()
    assert stats["builds"] == len(keys)
    assert stats["bytes"] == sum(got[i].nbytes() for i in range(len(keys)))
    for i in range(len(keys), 16):
        assert got[i] is got[i % len(keys)]
    view = tviews.get_view(tensors[0], 0)
    assert isinstance(view, talto.OrientedView)
    assert tviews.cache_stats()["builds"] == len(keys) + 1
    assert tviews.invalidate(tensors[0]) == 3     # two streams, one view
    tviews.cache_clear()


# ---------------------------------------------------------------------------
# Out-of-core plan models
# ---------------------------------------------------------------------------

def _metas():
    """(port meta, JAX meta) pairs: W = 1 and W = 2 encodings."""
    out = []
    for dims, nnz in (((30, 24, 20), 900), ((22476, 22476, 23_776_223),
                                            5000)):
        jat = jalto.build(jsyn.uniform_tensor(dims, nnz, seed=0),
                          n_partitions=8)
        out.append((_port_tensor(jat).meta, jat.meta))
    return out


@pytest.mark.parametrize("rank", [4, 16])
def test_byte_models_term_by_term(rank):
    for meta, jmeta in _metas():
        L = theur.stream_len(meta)
        W = meta.enc.n_words
        for db in (4, 8):
            elem = W * 4 + 4 + db
            assert tplan.stream_elem_bytes(meta, db) == elem \
                == jplan.stream_elem_bytes(jmeta, db)
            imax = max(meta.dims)
            resident = (sum(meta.dims) * rank * db + 2 * imax * rank * db
                        + 4 + rank * db)
            assert tplan.streaming_resident_bytes(meta, rank, db) \
                == resident == jplan.streaming_resident_bytes(jmeta, rank,
                                                              db)
            assert tplan.incore_working_set_bytes(meta, rank, db) \
                == L * elem + resident \
                == jplan.incore_working_set_bytes(jmeta, rank, db)
            for cm in (8, 1024, 4096):
                assert tplan.chunk_hbm_bytes(meta, cm, rank, db) \
                    == 2 * cm * elem + resident \
                    == jplan.chunk_hbm_bytes(jmeta, cm, rank, db)
                assert tplan.chunk_count(meta, cm) == -(-L // cm) \
                    == jplan.chunk_count(jmeta, cm)


@pytest.mark.parametrize("align", [8, 256, 1024])
def test_streaming_decision_and_chunks_match_reference(align):
    for meta, jmeta in _metas():
        resident = tplan.streaming_resident_bytes(meta, 16)
        incore = tplan.incore_working_set_bytes(meta, 16)
        elem = tplan.stream_elem_bytes(meta)
        for budget in (resident - 1, resident + 2 * elem * align,
                       resident + 2 * elem * 1000, incore - 1, incore,
                       incore + 1):
            assert tplan.needs_streaming(meta, 16, budget) \
                == jplan.needs_streaming(jmeta, 16, budget) \
                == (incore > budget)
            cm = tplan.choose_chunk_m(meta, 16, budget, align)
            assert cm == jplan.choose_chunk_m(jmeta, 16, budget, align)
            assert cm % align == 0 and cm >= align


def test_make_plan_streams_like_the_reference(monkeypatch):
    """At the JAX package's block_m (8 under vmem_limit=0, the port's for
    a stream this short) both plans pick the same StreamPlan; the env
    budget and force_carry work as in JAX."""
    monkeypatch.delenv("REPRO_DEVICE_BYTES", raising=False)
    meta, jmeta = _metas()[0]
    for chunks in (3, 4, 8):
        budget = (tplan.streaming_resident_bytes(meta, 4)
                  + 2 * tplan.stream_elem_bytes(meta)
                  * -(-theur.stream_len(meta) // chunks))
        tp = tplan.make_plan(meta, 4, device_bytes=budget)
        jp = jplan.make_plan(jmeta, 4, backend="pallas", interpret=True,
                             vmem_limit=0, device_bytes=budget)
        assert [m.block_m for m in tp.modes] == [m.block_m for m in jp.modes]
        assert dataclasses.asdict(tp.streaming) \
            == dataclasses.asdict(jp.streaming)
        assert tp.traversals() == ("oriented_carry",) * 3
    assert tplan.make_plan(meta, 4).streaming is None
    assert tplan.make_plan(meta, 4, device_bytes=1 << 40).streaming is None
    monkeypatch.setenv("REPRO_DEVICE_BYTES",
                       str(tplan.streaming_resident_bytes(meta, 4) + 1))
    assert tplan.default_device_bytes() is not None
    assert tplan.make_plan(meta, 4).streaming is not None
    mp = tplan.static_mode_plan(meta, 0, 4, force_carry=True)
    assert mp.traversal is theur.Traversal.ORIENTED_CARRY


def test_streaming_views_are_host_streams():
    at = talto.build_device(tsyn.uniform_tensor(DIMS, 400, seed=3),
                            n_partitions=4, device="cpu")
    meta = at.meta
    budget = tplan.streaming_resident_bytes(meta, 4) + 1
    tp = tplan.make_plan(meta, 4, device_bytes=budget)
    views = tplan.build_views(at, tp)
    assert sorted(views) == [0, 1, 2]
    assert all(isinstance(v, tstream.HostStream) for v in views.values())
    incore = tplan.build_views(at, dataclasses.replace(tp, streaming=None))
    assert all(isinstance(v, talto.OrientedView) for v in incore.values())
    tviews.cache_clear()
