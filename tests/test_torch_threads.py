"""The thread policy of the port's tests (``tests/torch_threads.py``): inside
a test, torch runs on the worker's share of the cores, on one thread under
``one_thread``, on ``n`` under ``held_at(n)``; and every port test file
takes the share."""

import ast
import glob
import os

import pytest
import torch

from torch_threads import budget, held_at, one_thread, shared_cores  # noqa: F401 (fixtures)

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.mark.parametrize("policy,want", [("budget", None), ("one_thread", 1),
                                         ("held_at", 3)])
def test_threads_inside_a_test(request, policy, want):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is not None:
        assert budget() == max(1, (os.cpu_count() or 1) // int(workers))
    if policy == "one_thread":
        request.getfixturevalue("one_thread")
    if policy == "held_at":
        with held_at(want):
            assert torch.get_num_threads() == want
        assert torch.get_num_threads() == budget()
    else:
        assert torch.get_num_threads() == (want or budget())


def test_every_port_test_file_takes_the_share():
    missing = []
    for path in sorted(glob.glob(os.path.join(HERE, "test_torch_*.py"))):
        tree = ast.parse(open(path).read())
        if not any(isinstance(n, ast.ImportFrom) and n.module == "torch_threads"
                   and "shared_cores" in (a.name for a in n.names) for n in tree.body):
            missing.append(os.path.basename(path))
    assert not missing, missing
