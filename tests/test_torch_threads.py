"""Torch's intra-op threads in the port's tests under pytest-xdist.

Every port test file imports this module, as ``test_torch_threads`` (the
name pytest gives it; the card's machine has a site package named
``tests``), so each xdist worker runs ``pin_threads`` while it collects,
before its first test, whichever files it is given. Under xdist each
worker runs torch on ``cpu_count // workers`` threads, and the processes
it starts (rank workers, loader processes, subprocesses) start at the same
count through ``OMP_NUM_THREADS``: at torch's default every one of 6
workers ran a pool as wide as the machine, 48 threads on 8 cores, and the
3xTF32 model tests ran 30-100x slower than alone. A serial run keeps
torch's default. Imports torch and nothing of JAX or the JAX package, so
the card's test file imports it too.
"""
import os

import pytest
import torch


def xdist_threads(environ=os.environ, cpu_count=None):
    """The intra-op threads of one xdist worker: the cores shared among the
    workers, at least one; None outside xdist (a serial run)."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    return max(1, (cpu_count or os.cpu_count() or 1) // int(workers))


def pin_threads():
    """Set this process's intra-op threads, and its children's through
    ``OMP_NUM_THREADS``, to ``xdist_threads()``; a serial run is left as it
    is. Returns the count set, or None."""
    threads = xdist_threads()
    if threads is not None:
        torch.set_num_threads(threads)
        os.environ["OMP_NUM_THREADS"] = str(threads)
    return threads


PINNED = pin_threads()


@pytest.mark.parametrize("workers,cpus,want", [
    (None, 8, None), ("1", 8, 8), ("6", 8, 1), ("4", 8, 2), ("3", 32, 10),
    ("16", 8, 1)])
def test_xdist_threads_share_the_cores(workers, cpus, want):
    environ = {} if workers is None else {"PYTEST_XDIST_WORKER_COUNT": workers}
    assert xdist_threads(environ, cpus) == want


def test_this_process_runs_at_the_pinned_count():
    """Under xdist this worker and its children run at the shared count; a
    serial run keeps torch's default (PINNED is None)."""
    assert PINNED == xdist_threads()
    if PINNED is not None:
        assert torch.get_num_threads() == PINNED
        assert os.environ["OMP_NUM_THREADS"] == str(PINNED)
