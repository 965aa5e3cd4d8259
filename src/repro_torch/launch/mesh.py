"""Device meshes (``repro/launch/mesh.py``).

Each function builds a ``torch.distributed`` ``DeviceMesh`` over the ranks
of the default process group, one rank per mesh position, as the
reference's ``jax.make_mesh`` lays out devices.  They are functions (not
module constants), so importing this module touches no distributed state.

``device`` is explicit, ``"cuda"`` by default; a ``"cuda"`` mesh without a
card raises.  The caller initialises the default process group and names
its backend (NCCL for ``"cuda"``, gloo for ``"cpu"``; gloo's collectives
also take CUDA tensors); without one, every function here raises.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device


def _world_size() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs an initialised process "
                           "group (torch.distributed.init_process_group)")
    return dist.get_world_size()


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *,
              device: Union[str, torch.device] = "cuda"):
    """A mesh of ``shape`` named ``axes`` over every rank of the world."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    world = _world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} holds {math.prod(shape)} "
                         f"ranks; the world has {world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "cuda"):
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_local_mesh(model: int = 1, *,
                    device: Union[str, torch.device] = "cuda"):
    """Every rank of the world, as ``('data', 'model')``."""
    dev = resolve_device(device)
    n = _world_size()
    if model < 1 or n % model:
        raise ValueError(f"a world of {n} ranks does not split into model "
                         f"groups of {model}")
    return make_mesh((n // model, model), ("data", "model"), device=dev)
