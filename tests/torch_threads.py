"""Each pytest-xdist worker's share of the cores for torch.

Under ``pytest -n N`` each worker is one process whose torch intra-op
pool runs one thread per core, so N workers run N pools on the same
cores and the port's torch-heavy files slow one another down several
times over for no gain: at one thread each they pass within the same
tolerances. Importing this module in an xdist worker sets
``torch.set_num_threads(cores // N)`` (at least 1), where ``cores`` are
the CPUs the process may run on; outside xdist it changes nothing. Every
worker collects every test file, so the port's test files import it and
the budget holds in each worker before its first test runs. It goes
through torch's API, not the environment, so the subprocesses a test
starts inherit nothing from it.
"""

import os

import torch


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    torch.set_num_threads(max(1, _cores() // int(_workers)))
