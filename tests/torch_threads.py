"""How many CPU threads torch may use in the port's tests: the one place
that sets it. Two decisions, kept apart:

* the budget, a speed decision. Under pytest-xdist every worker's torch
  would size its intra-op pool to every core of the host, so six workers
  ask for six times the cores, and the small ops of these tests then run
  many times slower than alone. ``shared_cores`` gives each worker its
  share, ``budget()``; without xdist torch keeps what it has (every core,
  unless ``OMP_NUM_THREADS`` says otherwise). Every
  ``tests/test_torch_*.py`` imports it by name::

      from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

* a fixed count, a correctness decision. torch's CPU kernels split their
  sums by thread, so the thread count sets the order of a reduction.
  ``one_thread`` is for the tests that compare two torch paths bit for
  bit, which hold only when both reduce in one order; ``held_at(n)`` for a
  comparison that its tolerance holds at some counts and not at others.

The rank processes of ``torch_parallel_ranks.py`` (up to four at once
inside one worker) run on one thread each, ``held_at(1)``.

Imports torch and pytest only (the card's machine has no JAX); imported
as ``torch_threads``.
"""

import contextlib
import os

import pytest
import torch


def budget() -> int:
    """The torch threads of one test worker: the host's cores over the
    xdist workers, at least one; without xdist, torch's current count."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return torch.get_num_threads()
    return max(1, (os.cpu_count() or 1) // int(workers))


@contextlib.contextmanager
def held_at(n: int):
    """torch on ``n`` CPU threads inside; the count before, after."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True, scope="module")
def shared_cores():
    """The module's tests run on the worker's share of the cores."""
    with held_at(budget()):
        yield


@pytest.fixture
def one_thread():
    """The test's torch on one thread: one order of every reduction, for
    the tests that hold two torch paths equal bit for bit."""
    with held_at(1):
        yield
