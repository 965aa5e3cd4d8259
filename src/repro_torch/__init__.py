"""repro_torch — the Graphical Join (GJ) on PyTorch and CUDA.

The port of ``repro`` (the JAX/TPU reference, which stays beside it) to an
NVIDIA H100.  It imports torch and numpy, never jax and never ``repro``:
the host phases are its own copies of the reference's numpy modules, and
the device phases run on hand-written CUDA kernels (``kernels/csrc``).

    from repro_torch import GraphicalJoin
    gj = GraphicalJoin(catalog, query)            # device="cuda"
    rows = gj.desummarize(gj.run())
"""

from repro_torch.core.api import GraphicalJoin

__all__ = ["GraphicalJoin"]
