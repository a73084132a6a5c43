"""Torch's intra-op threads in the port's CPU tests: under pytest-xdist
the workers share the machine's cores, so each worker takes its share of
them. Torch's default, every core in every process, oversubscribes the
cores several times over and makes the tests several times slower (its
worker threads spin while they wait for a core). Imported by every
tests/test_torch_*.py; a run without xdist keeps torch's default."""

import os

import torch


def share_cores() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


share_cores()
