"""Op-count analysis of what runs, beneath DTensor: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference re-derives the three roofline inputs from compiled HLO
text, multiplying each ``while`` body by its trip count.  The port has no
HLO and no ``while``: its layer loop is Python, so every layer's ops are
dispatched one by one.  :class:`OpCounter` is a ``TorchDispatchMode``
that counts them as they run:

  * flops            -- every matrix product (``mm``, ``bmm``, ``addmm``,
                        ``baddbmm``, attention kernels, convolutions:
                        ``torch.utils.flop_counter``'s formulas), so
                        attention's score and value products too, as
                        ``analyze_hlo`` counts each ``dot``;
  * bytes            -- per op: operand plus result bytes of each tensor
                        (views, allocations and waits move none);
  * collective bytes -- operand bytes of each functional collective,
                        by the reference's five ``COLLECTIVE_KINDS``.

Counts are per device: an op on DTensors is first seen at global shapes
(counted into ``flops_global`` only), then DTensor runs it on this
rank's local shards beneath the counter, with the collectives its
redistributions need, and those local ops are the per-device counts.
Plain ops outside DTensor count in both: a single-device run's per-device
and global counts are equal.  Plain ops in a per-shard region (attention's
``per_shard_heads``, recurrences under ``act_sharding.by_rows``) run on
local shards, so ``flops_global`` counts them at their local size.  An op
inside ``models.layers.counted_as(n)`` (a loop on meta that runs one step
for ``n``: ``layers.uniform_loop``) counts ``n`` times, as a ``while`` body
counts its trip count.  Ops that DTensor's sharding propagation runs on
fake tensors are not counted.

Not counted, or counted otherwise than in the reference:

  * fusion: eager dispatch has none, so every elementwise op reads and
    writes its tensors in memory; a compiled graph (``torch.compile``,
    or XLA's fused HLO) would keep most of those passes on chip, so the
    bytes here are an eager-mode figure, above a fused one;
  * ops that XLA would simplify away (a dot of contraction size 1, a
    recomputation it can share) are counted as they run;
  * on a CPU process group DTensor's all-to-all falls back to an
    all-gather and a chunk (torch warns), so a fake CPU world counts an
    all-gather where NCCL would run an all-to-all.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.layers import trip_count

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# the functional collectives (``torch.ops._c10d_functional``), by the
# prefix of their name; any other is a point-to-point move
_COLLECTIVE_PREFIX = (("all_gather", "all-gather"),
                      ("all_reduce", "all-reduce"),
                      ("reduce_scatter", "reduce-scatter"),
                      ("all_to_all", "all-to-all"))
_NO_BYTES = {"empty", "empty_strided", "empty_like", "detach", "alias",
             "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
             "_local_scalar_dense", "set_", "resize_"}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _collective_kind(func) -> Optional[str]:
    if func.namespace != "_c10d_functional":
        return None
    name = func.__name__.split(".")[0]
    if name in ("wait_tensor", "_wrap_tensor_autograd"):
        return None
    for prefix, kind in _COLLECTIVE_PREFIX:
        if name.startswith(prefix):
            return kind
    return "collective-permute"


def _flops(func, args, kwargs, out) -> float:
    from torch.utils.flop_counter import flop_registry
    f = flop_registry.get(func.overloadpacket)
    if f is None:
        return 0.0
    return float(f(*args, **kwargs, out_val=out))


class OpCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active (``with
    OpCounter() as c: ...``); then :meth:`summary`.  With ``modules``
    each record carries the innermost module path
    (``torch.distributed._tools.mod_tracker.ModTracker``) in which the
    op ran, forward or backward, named from ``root`` (the model) when
    given."""

    def __init__(self, *, modules: bool = True, root=None) -> None:
        super().__init__()
        self.flops = 0.0
        self.flops_global = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in
                                              COLLECTIVE_KINDS}
        self.collective_count = 0
        # (kind, module, shapes) -> [count, flops, bytes, collective bytes]
        self._records: Dict[tuple, list] = defaultdict(
            lambda: [0, 0.0, 0.0, 0.0])
        self._pass = None
        self._beneath = 0           # inside DTensor's run of an op
        self._tracker = None
        if modules:
            from torch.distributed._tools.mod_tracker import ModTracker
            self._tracker = ModTracker()
            if root is not None and hasattr(self._tracker, "_get_mod_name"):
                # name every module by its path from ``root`` (a step
                # that calls ``lm.loss`` never calls ``lm`` itself)
                self._tracker._get_mod_name(root)

    def __enter__(self):
        if self._tracker is not None:
            self._tracker.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        if self._tracker is not None:
            self._tracker.__exit__(*exc)
        return out

    def _module(self) -> str:
        if self._tracker is None:
            return ""
        parents = [p for p in self._tracker.parents if p != "Global"]
        name = max(parents, key=len) if parents else ""
        return name + (" (backward)" if self._tracker.is_bw else "")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor(t) for t in _tensors((args, kwargs))):
            if self._pass is func:
                # the second visit: let DTensor run it, beneath this mode
                self._pass = None
                return NotImplemented
            self._pass = func
            self._beneath += 1
            TorchDispatchMode.__enter__(self)    # active again beneath
            try:
                out = func(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
                self._beneath -= 1
            self.flops_global += _flops(func, args, kwargs, out) * \
                trip_count()
            return out
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out               # DTensor's sharding propagation
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        n = trip_count()
        if n == 0:
            return
        flops = _flops(func, args, kwargs, out) * n
        kind = _collective_kind(func)
        ins = _tensors((args, kwargs))
        name = func.__name__.split(".")[0]
        nbytes = 0.0
        if not func.is_view and name not in _NO_BYTES:
            nbytes = float(sum(map(_nbytes, ins))
                           + sum(map(_nbytes, _tensors(out)))) * n
        coll = 0.0
        if kind is not None:
            coll = float(sum(map(_nbytes, ins))) * n
            self.collectives[kind] += coll
            self.collective_count += n
        self.flops += flops
        if not self._beneath:
            self.flops_global += flops
        self.bytes += nbytes
        key = (f"{func.namespace}.{name}", kind, self._module(),
               tuple(tuple(t.shape) for t in ins))
        rec = self._records[key]
        rec[0] += n
        rec[1] += flops
        rec[2] += nbytes
        rec[3] += coll

    def records(self) -> List[Dict]:
        """One record per (op, module, operand shapes), heaviest bytes
        first: its ``kind`` (``aten.mm``, ``_c10d_functional.all_reduce``),
        ``collective`` kind or None, ``module`` path, ``shapes``,
        ``count`` and its totals of ``flops``, ``bytes`` and
        ``collective_bytes``."""
        out = [dict(kind=k, collective=c, module=m, shapes=s, count=r[0],
                    flops=r[1], bytes=r[2], collective_bytes=r[3])
               for (k, c, m, s), r in self._records.items()]
        out.sort(key=lambda d: -(d["bytes"] + d["collective_bytes"]))
        return out

    def summary(self) -> Dict:
        """The reference's ``analyze_hlo`` keys (per device) and
        ``flops_global``."""
        coll = dict(self.collectives)
        coll["total"] = sum(self.collectives.values())
        return {"flops": self.flops, "bytes": self.bytes,
                "collective_bytes": coll["total"], "collectives": coll,
                "collective_count": self.collective_count,
                "flops_global": self.flops_global}

