"""Spawned ranks of one world.

:func:`run_ranks` starts one process per rank with the ``"spawn"`` method
(``fork`` is unsafe once CUDA is up), joins them by one deadline and
kills what is left, so a rank that hangs fails its caller instead of
holding it.  Each rank initialises its own process group: the meshes of
:mod:`repro_torch.launch.mesh` need one.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence


def run_ranks(target: Callable, world: int, args: Sequence = (), *,
              timeout_s: float) -> None:
    """Runs ``target(rank, *args)`` for ``rank`` in ``range(world)``, each
    in a spawned process, all joined within ``timeout_s`` seconds; raises
    ``RuntimeError`` naming the exit codes and the killed ranks if a rank
    failed or was still running then."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if hung or any(codes):
        raise RuntimeError(f"ranks exited with codes {codes}; ranks {hung} "
                           f"were still running after {timeout_s}s and were "
                           f"killed")
