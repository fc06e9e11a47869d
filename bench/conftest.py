"""Pytest settings of the benchmark's tests: the ``card`` marker.

A test marked ``card`` needs a CUDA device and the kernels' toolchain; it
takes the ``card`` fixture, which skips it here when there is none. Run
them on the card with ``PYTHONPATH=src python -m pytest -m card bench``.
"""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several worker processes,
    and a CPU torch in each with a thread per core oversubscribes them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# Small stand-ins of each configuration: the same generator and rank as
# the configuration, every mode at least as long as the rank (a shorter
# mode makes the CP-ALS solve singular), a few hundred nonzeros.
SMALL = {
    "uniform": dict(dims=[40, 40, 300], nnz=800),
    "blocked": dict(dims=[40, 24, 20, 18], nnz=800,
                    generator={"kind": "blocked", "block": 6, "n_blocks": 8,
                               "count_max": 14, "layout_seed": 1}),
}


def small_config(config: dict) -> dict:
    """``config`` at a stand-in shape that a CPU test run holds."""
    small = dict(config)
    small.update(SMALL[config["generator"]["kind"]])
    small["n_partitions"] = 8
    return small


@pytest.fixture
def small_cell():
    """A factory: the cell ``name`` with its configuration at a small
    stand-in shape; its traffic, solve loop and limits as they are."""
    from bench import harness

    def make(name: str):
        cell = harness.load_cell(name)
        cell.config = small_config(cell.config)
        return cell
    return make
