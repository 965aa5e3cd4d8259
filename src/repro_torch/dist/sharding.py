"""Logical-axis -> mesh-axis sharding rules (``repro/dist/sharding.py``).

A :class:`ShardingRules` maps each *logical* parameter axis name (the
tuples the models declare through ``layers.declare``) to the mesh axes it
shards over: ``None`` (replicate), a single mesh-axis name, or a tuple of
them.  ``param_specs`` applies the rules to a model's logical axes
(``LM.logical_axes()``), dropping mesh axes the mesh doesn't have and
never using one mesh axis twice in a single spec, as the reference does.

A spec is the port's stand-in for ``jax.sharding.PartitionSpec``: a tuple
with one entry per leading tensor dim, each ``None``, a mesh-axis name or
a tuple of names, trailing ``None``s dropped.  :func:`placements` turns a
spec into DTensor placements over a torch ``DeviceMesh``, one per mesh
dim.  The rules read only the mesh's dim names, so they run on any mesh,
a fake process group's included; importing this module touches no
distributed state.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple, Union

AxisSpec = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisSpec, ...]


def _as_tuple(spec: AxisSpec) -> Tuple[str, ...]:
    if spec is None:
        return ()
    if isinstance(spec, str):
        return (spec,)
    return tuple(spec)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A ``DeviceMesh``'s dim names; a mesh without names raises."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the sharding rules need a mesh with named dims")
    return tuple(names)


@dataclass(frozen=True)
class ShardingRules:
    """Mapping: logical axis name -> mesh axes (None/str/tuple)."""

    rules: Mapping[str, AxisSpec] = field(default_factory=dict)

    def with_overrides(self, **kw: AxisSpec) -> "ShardingRules":
        merged = dict(self.rules)
        merged.update(kw)
        return ShardingRules(merged)

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return _as_tuple(self.rules.get(logical))

    def spec_for(self, axes: Tuple[Optional[str], ...], mesh) -> Spec:
        """The spec for one parameter's logical-axes tuple."""
        names = mesh_axis_names(mesh)
        used: set = set()
        parts: List[AxisSpec] = []
        for logical in axes:
            cand = tuple(a for a in self.mesh_axes(logical)
                         if a in names and a not in used)
            used.update(cand)
            if not cand:
                parts.append(None)
            elif len(cand) == 1:
                parts.append(cand[0])
            else:
                parts.append(cand)
        while parts and parts[-1] is None:  # trailing Nones are implicit
            parts.pop()
        return tuple(parts)


# Megatron-style tensor parallelism over the 'model' axis: shard the
# per-head/per-neuron dimensions, replicate d_model (activations stay
# contracted over replicated embed).
DEFAULT_RULES = ShardingRules({
    "embed": None,
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head": None,
    "ff": ("model",),
    "moe_ff": ("model",),
    "experts": None,
    "expert_cap": None,
    "layers": None,
    "audio": None,
})

# Sequence-parallel FSDP preset (the dry-run's 'sp_fsdp' grid): params
# additionally sharded over the data axes on their embed dimension;
# activations get a (batch, seq->model) constraint via
# repro_torch.dist.act_sharding.
SP_FSDP_RULES = DEFAULT_RULES.with_overrides(embed=("data",))


def param_specs(
    logical_axes: Dict[str, Tuple[Optional[str], ...]],
    mesh,
    rules: ShardingRules = DEFAULT_RULES,
) -> Dict[str, Spec]:
    """The spec per parameter name from its logical axes."""
    return {name: rules.spec_for(axes, mesh)
            for name, axes in logical_axes.items()}


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements for ``spec`` over ``mesh``, one per mesh dim in
    mesh order: ``Shard(d)`` on each mesh dim that tensor dim ``d``'s
    entry names, ``Replicate()`` on the others.

    DTensor splits a tensor dim over several mesh dims in mesh order, the
    first the outermost, so an entry whose mesh axes come in another
    order (JAX's ``("data", "pod")`` on a ``(pod, data, model)`` mesh)
    would lay the shards out otherwise than JAX does; it raises, as does
    a mesh axis the mesh lacks or one named twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    out: list = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        idx = []
        for a in _as_tuple(entry):
            if a not in names:
                raise ValueError(f"spec {spec}: the mesh {names} has no "
                                 f"axis {a!r}")
            if a in seen:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {d}'s mesh axes "
                             f"{_as_tuple(entry)} are not in the mesh's "
                             f"order {names}; DTensor would lay it out "
                             f"otherwise than the spec says")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)
