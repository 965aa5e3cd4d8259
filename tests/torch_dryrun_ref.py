"""The reference's side of the dry-run tests: per-device argument bytes of
a cell from its shardings on a ``jax.sharding.AbstractMesh``, computed
in-process as ``tests/test_torch_sharding.py`` computes specs (no
compile, no devices).

Shared by ``tests/test_torch_dryrun.py`` and
``tests/test_torch_roofline.py``.
"""

import math

import jax
from jax.sharding import AbstractMesh, NamedSharding

from repro.dist.sharding import SP_FSDP_RULES as REF_SP_FSDP_RULES
from repro.launch import specs as ref_specs
from repro.models.attention import KVCache as RefKVCache

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import unit_layers

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _no_pos(tree):
    """The reference's caches without their ``pos`` scalars: the port's
    ``KVCache.pos`` is a Python int, not a tensor."""
    return jax.tree.map(lambda c: c._replace(pos=None)
                        if isinstance(c, RefKVCache) else c, tree,
                        is_leaf=lambda c: isinstance(c, RefKVCache))


def reference_argument_bytes(arch: str, shape: str, multi_pod: bool,
                             layers: int, preset: str = "default") -> int:
    """The sum over every argument of the reference's cell (parameters,
    optimizer state, batch, caches) of its ``NamedSharding.shard_shape``
    bytes: what one device holds."""
    amesh = AbstractMesh(*MESHES[multi_pod])
    rules = REF_SP_FSDP_RULES if preset == "sp_fsdp" else None
    _, args, shardings, _, _, _ = ref_specs.build_cell(
        arch, shape, amesh, rules=rules, overrides=dict(num_layers=layers))
    leaves = jax.tree.leaves(_no_pos(args))
    shs = jax.tree.leaves(_no_pos(shardings),
                          is_leaf=lambda s: isinstance(s, NamedSharding))
    assert len(leaves) == len(shs)
    return sum(math.prod(shard_shape(sh, leaf.shape)) * leaf.dtype.itemsize
               for leaf, sh in zip(leaves, shs))


def shard_shape(sh: NamedSharding, shape) -> tuple:
    """``sh.shard_shape(shape)``; for a dim its mesh axes do not divide
    (8 KV heads on a 16-way axis under ``SP_FSDP_RULES``, which
    ``shard_shape`` refuses) the padded shard a compiled program holds:
    the size over the number of shards, rounded up, as DTensor's first
    ranks hold."""
    try:
        return tuple(sh.shard_shape(shape))
    except ValueError:
        sizes = dict(zip(sh.mesh.axis_names, sh.mesh.axis_sizes))
        spec = tuple(sh.spec) + (None,) * (len(shape) - len(tuple(sh.spec)))
        out = []
        for size, entry in zip(shape, spec):
            axes = () if entry is None else (entry,) \
                if isinstance(entry, str) else tuple(entry)
            out.append(-(-size // math.prod(sizes[a] for a in axes)))
        return tuple(out)


def unit(arch: str) -> int:
    return unit_layers(get_config(arch))
