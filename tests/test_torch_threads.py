"""``tests/torch_threads.py``: an xdist worker runs torch at its share of
the cores, and a process outside xdist keeps torch's default.

Each case imports the module in a fresh process, so no earlier test in
the same worker can change what it reads.
"""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))

PROBE = """
import os, torch
env, default = dict(os.environ), torch.get_num_threads()
import torch_threads
print(default, torch.get_num_threads(), int(os.environ == env))
"""


def probe(workers):
    env = dict(os.environ)
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = str(workers)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (HERE, env.get("PYTHONPATH")) if p)
    out = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    return map(int, out.stdout.split())


def cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


@pytest.mark.parametrize("workers", [None, 1, 2, 6, 64])
def test_worker_runs_torch_at_its_share_of_the_cores(workers):
    default, threads, env_unchanged = probe(workers)
    assert env_unchanged
    if workers is None:
        assert threads == default
        return
    n = cores()
    assert threads >= 1
    # The workers' pools fit the cores, and no whole share is left idle.
    assert threads * workers <= max(n, workers)
    assert (threads + 1) * workers > n
