"""Roofline terms from a traced step, under the H100's constants.

Hardware model (one NVIDIA H100 SXM, dense rates):

  compute term    = FLOPs / PEAK_FLOPS             (per-device FLOPs)
  memory term     = bytes / HBM_BW                 (per-device bytes)
  collective term = intra-node bytes / NVLINK_BW
                    + node-crossing bytes / IB_BW  (per-device operand bytes)

The dry run (`launch/dryrun.py`) traces one step on each device's local
shards and counts what runs there: FLOPs of the matmul-class ops that
``torch.utils.flop_counter`` knows, bytes read and written by every
local op that is not a view (unfused: an upper bound on the traffic a
fused step moves), and a record of the ``_c10d_functional`` collectives
the DTensor redistributions issued (kind, operand bytes, the ranks of
the group). `collective_stats` sums that record. Ranks are laid out
row-major, ``GPUS_PER_NODE`` to a node, so a group whose ranks lie on
more than one node crosses the node boundary: with 8 GPUs a node, the
16-wide ``model`` axis spans two nodes.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 Tensor Core GPU datasheet, SXM5 part: 989.4 TFLOP/s dense
# bf16 (1,979 with sparsity), 3.35 TB/s HBM3.
PEAK_FLOPS = 989e12      # bf16 FLOP/s / GPU
HBM_BW = 3.35e12         # bytes/s / GPU
# Same datasheet: NVLink 4 at 900 GB/s a GPU in total, 450 GB/s a
# direction, within an 8-GPU HGX H100 node.
NVLINK_BW = 450e9        # bytes/s / GPU, one direction
# NVIDIA DGX H100 user guide: one ConnectX-7 NDR 400 Gb/s InfiniBand port
# a GPU across nodes, 50 GB/s a direction.
IB_BW = 50e9             # bytes/s / GPU, one direction
GPUS_PER_NODE = 8

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a traced step issued on this device."""
    kind: str                    # one of COLLECTIVES
    bytes: int                   # operand bytes
    ranks: tuple[int, ...]       # the group's global ranks

    @property
    def crosses_node(self) -> bool:
        return len({r // GPUS_PER_NODE for r in self.ranks}) > 1


def collective_stats(record) -> dict:
    """Per-kind operand bytes and counts of a record of `Collective`s,
    and the bytes of groups within one node and across nodes."""
    bytes_by_kind = {k: 0 for k in COLLECTIVES}
    count_by_kind = {k: 0 for k in COLLECTIVES}
    inter = 0
    for c in record:
        count_by_kind[c.kind] += 1
        bytes_by_kind[c.kind] += c.bytes
        if c.crosses_node:
            inter += c.bytes
    total = sum(bytes_by_kind.values())
    return {"bytes": bytes_by_kind, "counts": count_by_kind,
            "total_bytes": total, "inter_node_bytes": inter,
            "intra_node_bytes": total - inter}


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per device
    bytes_hbm: float             # per device
    bytes_collective: float      # per device
    bytes_collective_inter: float  # per device, groups crossing a node
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops_global: float    # 6·N·D (train) or 2·N·D (serve)
    useful_ratio: float          # model_flops_per_dev / flops

    def to_dict(self):
        return dataclasses.asdict(self)


def derive_terms(flops: float, bytes_hbm: float, bytes_coll: float,
                 model_flops_global: float, n_chips: int,
                 bytes_coll_inter: float = 0.0) -> RooflineTerms:
    """The JAX package's terms; the collective bytes split by whether
    their group crosses a node (``bytes_coll_inter`` of ``bytes_coll``)."""
    t_c = flops / PEAK_FLOPS
    t_m = bytes_hbm / HBM_BW
    t_x = (bytes_coll - bytes_coll_inter) / NVLINK_BW \
        + bytes_coll_inter / IB_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    bottleneck = max(terms, key=terms.get)
    useful = (model_flops_global / n_chips) / max(flops, 1.0)
    return RooflineTerms(flops=flops, bytes_hbm=bytes_hbm,
                         bytes_collective=bytes_coll,
                         bytes_collective_inter=bytes_coll_inter,
                         t_compute=t_c, t_memory=t_m, t_collective=t_x,
                         bottleneck=bottleneck,
                         model_flops_global=model_flops_global,
                         useful_ratio=useful)


def model_flops(cfg, shape, n_active_params: int) -> float:
    """6·N·D for training, 2·N·D per forward token for serving."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active_params * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active_params * tokens
    # decode: one token per sequence
    return 2.0 * n_active_params * shape.global_batch


def slstm_flops_correction(cfg, shape, n_slstm_layers: int) -> float:
    """The JAX package's correction for a scan body its cost analysis
    counts once: the remaining (S-1) sLSTM steps, 4 recurrent PxP matmuls
    a head. The dry run does not add it: an eager trace runs every step,
    so its count already holds them."""
    if n_slstm_layers == 0 or shape.kind == "decode":
        return 0.0
    B = shape.global_batch
    S = shape.seq_len
    H = cfg.n_heads
    P = cfg.d_model // H
    per_step = 4 * 2 * B * H * P * P + 40 * B * H * P
    return float(n_slstm_layers * (S - 1) * per_step)
