"""Checkpoint store implementation (see the package docstring for its
guarantees), on the reference's on-disk format (``repro/checkpoint/
store.py``), so a checkpoint written by either package restores in the
other:

* ``step_<n:010d>`` directories, written as ``.tmp`` and committed by an
  atomic rename after every file is fsynced;
* one raw ``.bin`` file per leaf, named after its key;
* ``manifest.json`` with ``step``, ``extra`` and ``leaves`` (``key``,
  ``file``, ``dtype``, ``shape``, ``crc32``).

Keys are the reference's tree paths: dict keys sorted and joined by
``/``, a NamedTuple field as ``.name``, a sequence index as its number,
so a ``TrainState`` gives ``.params/<name>``, ``.opt/.step``,
``.opt/.m/<name>`` and ``.opt/.v/<name>``.  A dict whose keys name the
layers of a stack (``segments.<s>.<i>.<rest>``, the port's LM
parameters) is stored as the reference stores it: one leaf per stacked
parameter, the layers on its leading axis, under the reference's name
(``interop.lm_reference_name`` under ``prefixes``, the model's
``reference_prefixes``; without them, the dense, moe, gemma3, vlm
and audio families' names).  Its bytes are the layers' bytes in
index order, so the layers are written one after another and read back
as views of one buffer, never stacked in memory.

Leaves are torch tensors (on any device), numpy arrays or Python
scalars.  bfloat16 is written as its raw 2-byte words under dtype
``"bfloat16"`` and read back with ``torch.frombuffer``, without
``ml_dtypes``.  Every leaf's crc32 is checked before it is used.  Leaves
are written and read by ``IO_THREADS`` threads (``zlib.crc32`` and file
IO release the interpreter lock).  The reference's ``shardings=`` (an
elastic restore onto a mesh) has no counterpart on one card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.interop import lm_reference_name

IO_THREADS = min(8, os.cpu_count() or 1)

DTYPES = {str(t).removeprefix("torch."): t for t in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


@dataclass
class _Leaf:
    """One manifest leaf: its key, dtype name and shape, and its parts in
    byte order (one part, or a stack's layers with their indices)."""

    key: str
    dtype: str
    shape: List[int]
    parts: List[Tuple[Tuple[int, ...], Any]]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return str(np.asarray(x).dtype)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _stack(key: str, parts: List[Tuple[Tuple[int, ...], Any]]) -> _Leaf:
    parts = sorted(parts, key=lambda p: p[0])
    lead = tuple(int(n) + 1 for n in np.max([i for i, _ in parts], axis=0))
    if len(parts) != int(np.prod(lead)):
        raise ValueError(f"{key}: layers {[i for i, _ in parts]} do not "
                         f"fill a {list(lead)} stack")
    first = parts[0][1]
    for _, t in parts:
        if tuple(t.shape) != tuple(first.shape) or \
                _dtype_name(t) != _dtype_name(first):
            raise ValueError(f"{key}: layers differ in shape or dtype")
    return _Leaf(key, _dtype_name(first), list(lead) + list(first.shape),
                 parts)


def _flatten(tree: Any, path: str = "",
             prefixes: Optional[Mapping[str, str]] = None) -> List[_Leaf]:
    """The reference's ``tree_flatten_with_path`` keys, in its order."""
    join = (lambda k: f"{path}/{k}") if path else (lambda k: str(k))
    if tree is None:
        return []
    if _is_namedtuple(tree):
        return [leaf for f in tree._fields
                for leaf in _flatten(getattr(tree, f), join(f".{f}"),
                                     prefixes)]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, x in enumerate(tree)
                for leaf in _flatten(x, join(i), prefixes)]
    if isinstance(tree, Mapping):
        groups: Dict[str, List[Tuple[Tuple[int, ...], Any]]] = {}
        subtrees = {}
        for k, v in tree.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                ref, idx = lm_reference_name(str(k), prefixes)
                groups.setdefault(ref, []).append((idx, v))
            else:
                subtrees[str(k)] = v
        clash = set(groups) & set(subtrees)
        if clash:
            raise ValueError(f"keys {sorted(clash)} name both a stack and "
                             f"a subtree")
        out = []
        for k in sorted(set(groups) | set(subtrees)):
            if k in subtrees:
                out.extend(_flatten(subtrees[k], join(k), prefixes))
            elif any(idx == () for idx, _ in groups[k]):
                if len(groups[k]) > 1:
                    raise ValueError(f"{join(k)}: a leaf and stacked "
                                     f"layers share the name")
                x = groups[k][0][1]
                out.append(_Leaf(join(k), _dtype_name(x), list(x.shape),
                                 [((), x)]))
            else:
                out.append(_stack(join(k), groups[k]))
        return out
    x = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return [_Leaf(path, _dtype_name(x), list(x.shape), [((), x)])]


def _unflatten(like: Any, values: Dict[str, Any], path: str = "",
               prefixes: Optional[Mapping[str, str]] = None) -> Any:
    """``like``'s structure with each leaf (or stacked layer) taken from
    ``values``, which maps a key to its array, or a stack's key to
    ``{index: layer}``."""
    join = (lambda k: f"{path}/{k}") if path else (lambda k: str(k))
    if like is None:
        return None
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), values,
                                       join(f".{f}"), prefixes)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, values, join(i), prefixes)
                          for i, x in enumerate(like))
    if isinstance(like, Mapping):
        out = {}
        for k, v in like.items():
            if isinstance(v, (torch.Tensor, np.ndarray)):
                ref, idx = lm_reference_name(str(k), prefixes)
                got = values[join(ref)]
                out[k] = got[idx] if idx else got
            else:
                out[k] = _unflatten(v, values, join(str(k)), prefixes)
        return out
    return values[path]


def _host_bytes(x) -> np.ndarray:
    """A leaf's raw bytes as a host uint8 array (a view where it can be);
    a card tensor comes down through the staged download."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous().reshape(-1).view(torch.uint8)
        if t.device.type == "cuda":
            from repro_torch.core.engine import _download
            return _download(t)
        return t.cpu().numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _host_copy(x) -> np.ndarray:
    """A leaf's raw bytes in a new host array (a snapshot)."""
    b = _host_bytes(x)
    on_card = isinstance(x, torch.Tensor) and x.device.type == "cuda"
    return b if on_card else b.copy()


def _to_host(leaves: List[_Leaf]) -> List[_Leaf]:
    return [_Leaf(l.key, l.dtype, l.shape,
                  [(i, _host_copy(p)) for i, p in l.parts]) for l in leaves]


def _fname(key: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", key) + ".bin"


def _write_leaf(directory: str, leaf: _Leaf) -> Dict:
    crc = 0
    with open(os.path.join(directory, _fname(leaf.key)), "wb") as f:
        for _, p in leaf.parts:
            b = _host_bytes(p)
            crc = zlib.crc32(b, crc)
            f.write(b)
        f.flush()
        os.fsync(f.fileno())
    return {"key": leaf.key, "file": _fname(leaf.key), "dtype": leaf.dtype,
            "shape": leaf.shape, "crc32": crc & 0xFFFFFFFF}


def _commit(directory: str, step: int, leaves: List[_Leaf],
            extra: Optional[Dict]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with ThreadPoolExecutor(IO_THREADS) as pool:
        metas = list(pool.map(lambda l: _write_leaf(tmp, l), leaves))
    manifest = {"step": step, "extra": extra or {}, "leaves": metas}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # the atomic commit point
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[Dict] = None, *,
                    prefixes: Optional[Mapping[str, str]] = None) -> str:
    """Synchronous atomic save.  Returns the committed path."""
    return _commit(directory, step, _flatten(tree, prefixes=prefixes), extra)


def _read_leaf(path: str, meta: Dict) -> Any:
    """A leaf's file, crc-checked, as a tensor (or, for a dtype numpy has,
    also the numpy array viewing the same bytes)."""
    fpath = os.path.join(path, meta["file"])
    raw = np.empty(os.path.getsize(fpath), np.uint8)
    with open(fpath, "rb") as f:
        if f.readinto(memoryview(raw)) != raw.size:
            raise IOError(f"checkpoint corruption in {meta['key']} "
                          f"(short read)")
    crc = zlib.crc32(raw) & 0xFFFFFFFF
    if crc != meta["crc32"]:
        raise IOError(f"checkpoint corruption in {meta['key']} "
                      f"(crc {crc} != {meta['crc32']})")
    dtype = DTYPES[meta["dtype"]]
    t = torch.frombuffer(raw, dtype=dtype) if raw.size else \
        torch.empty(0, dtype=dtype)
    return t.reshape(meta["shape"])


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None, *, into: bool = False,
                       prefixes: Optional[Mapping[str, str]] = None
                       ) -> Tuple[Any, int, Dict]:
    """Restore the latest (or a specific) checkpoint into ``tree_like``'s
    structure: each tensor leaf comes back as a tensor on that leaf's
    device (a numpy leaf as numpy), in the checkpoint's dtype.  With
    ``into``, each tensor is copied into ``tree_like``'s own (same shape),
    which is returned, so a restore needs no second copy of the state on
    the device."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {l["key"]: l for l in manifest["leaves"]}

    def restore(leaf: _Leaf):
        meta = by_key[leaf.key]
        if list(meta["shape"]) != leaf.shape and into:
            raise ValueError(f"{leaf.key}: shape {meta['shape']} in the "
                             f"checkpoint, {leaf.shape} to restore into")
        full = _read_leaf(path, meta)
        out = {}
        for idx, like in leaf.parts:
            got = full[idx] if idx else full
            if isinstance(like, torch.Tensor):
                if into:
                    with torch.no_grad():
                        like.copy_(got)
                    got = like
                else:
                    got = got.to(like.device, copy=True)
            else:
                got = got.numpy().copy()
            out[idx] = got
        return leaf.key, out.get((), out)

    with ThreadPoolExecutor(IO_THREADS) as pool:
        values = dict(pool.map(restore, _flatten(tree_like,
                                                 prefixes=prefixes)))
    return _unflatten(tree_like, values, prefixes=prefixes), \
        manifest["step"], manifest["extra"]


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name,
                                             "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


class CheckpointManager:
    """Async save + retention + resume; LM parameters under the names
    ``prefixes`` give (a model's ``reference_prefixes``)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 prefixes: Optional[Mapping[str, str]] = None) -> None:
        self.directory = directory
        self.keep = keep
        self.prefixes = prefixes
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Join the background save; re-raise its failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> None:
        """Copy the state to the host now; write + commit + GC in the
        background."""
        self.wait()
        host = _to_host(_flatten(tree, prefixes=self.prefixes))

        def work():
            try:
                _commit(self.directory, step, host, extra)
                self._gc()
            except BaseException as exc:       # re-raised by wait()
                self._error = exc

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> str:
        self.wait()
        path = save_checkpoint(self.directory, step, tree, extra,
                               prefixes=self.prefixes)
        self._gc()
        return path

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                into: bool = False):
        self.wait()
        return restore_checkpoint(self.directory, tree_like, step, into=into,
                                  prefixes=self.prefixes)

    def latest_step(self) -> Optional[int]:
        steps = available_steps(self.directory)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        steps = available_steps(self.directory)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
