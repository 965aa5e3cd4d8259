"""GFJS container format — the compute-and-reuse store/load path **and**
the wire format of the shard-action protocol (repro_torch/dist/actions.py).

Single container: an 8-byte magic+version, a JSON manifest (level
structure, dtypes, domains metadata), then compressed binary blobs.  Each
level's freq column and each variable's code column are separate blobs so a
loader can stream one column at a time; domains (the raw dictionary values)
are stored so the container is self-contained.

The container is a byte string first (:func:`gfjs_to_bytes` /
:func:`gfjs_from_bytes`, :func:`encoded_query_to_bytes` /
:func:`encoded_query_from_bytes`) and a file second (:func:`save_gfjs` /
:func:`load_gfjs` just add the filesystem round-trip): the process-pool
shard executor ships per-shard ``EncodedQuery`` slices out and GFJS blobs
back through exactly the on-disk codec, so a worker reply could be spilled
to disk and loaded years later unchanged.

Compression codec: zstd when the ``zstandard`` package is importable, else
stdlib zlib.  The codec is recorded both in the file header flags and per
blob in the manifest, so a reader with either capability set can decode
files written by the other (zstd-written files still need zstandard to
*read*, and loaders raise a clear error if it's absent).

The paper stores GFJS as one CSV per column; we keep the per-column layout
but use dictionary codes + compression, which is the columnar-RDBMS-internal
encoding the paper says would make GJ "even faster".  A `to_csv` escape
hatch writes the paper's exact format for the storage benchmark.
"""

from __future__ import annotations

import io
import json
import os
import struct
import zlib
from typing import BinaryIO, Dict, List, Optional, Tuple

import numpy as np

try:  # optional: the container may not ship zstandard
    import zstandard  # type: ignore
except ImportError:  # pragma: no cover - depends on environment
    zstandard = None

from repro_torch.core.gfjs import GFJS, LevelSummary, ShardedGFJS
from repro_torch.relational.encoding import Domain

MAGIC = b"GFJS"
VERSION = 2

ENC_MAGIC = b"GJEQ"    # EncodedQuery container (shard-action wire format)
ENC_VERSION = 1

CODEC_ZSTD = "zstd"
CODEC_ZLIB = "zlib"
_CODEC_FLAG = {CODEC_ZSTD: 1, CODEC_ZLIB: 2}
_FLAG_CODEC = {v: k for k, v in _CODEC_FLAG.items()}


def default_codec() -> str:
    """zstd when available, else the always-present zlib fallback."""
    return CODEC_ZSTD if zstandard is not None else CODEC_ZLIB


def compress_bytes(raw: bytes, *, codec: Optional[str] = None,
                   level: int = 3) -> Tuple[str, bytes]:
    """Compress ``raw``; returns (codec actually used, payload)."""
    codec = default_codec() if codec is None else codec
    if codec == CODEC_ZSTD:
        if zstandard is None:
            raise RuntimeError("zstd codec requested but zstandard is not installed")
        return codec, zstandard.ZstdCompressor(level=level).compress(raw)
    if codec == CODEC_ZLIB:
        return codec, zlib.compress(raw, level)
    raise ValueError(f"unknown codec {codec!r}")


def decompress_bytes(payload: bytes, codec: str,
                     *, max_output_size: int = 1 << 34) -> bytes:
    if codec == CODEC_ZSTD:
        if zstandard is None:
            raise RuntimeError(
                "file was written with the zstd codec but zstandard is not "
                "installed; install it or re-save with the zlib codec")
        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=max_output_size)
    if codec == CODEC_ZLIB:
        return zlib.decompress(payload)
    raise ValueError(f"unknown codec {codec!r}")


class _BlobWriter:
    """Accumulates named compressed array blobs + their manifest entries."""

    def __init__(self, codec: Optional[str], level: int) -> None:
        self.codec = default_codec() if codec is None else codec
        self.level = level
        self.blobs: List[Dict] = []
        self.body = io.BytesIO()

    def add(self, name: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        used, comp = compress_bytes(arr.tobytes(), codec=self.codec,
                                    level=self.level)
        off = self.body.tell()
        self.body.write(comp)
        self.blobs.append({"name": name, "offset": off, "nbytes": len(comp),
                           "dtype": str(arr.dtype), "shape": list(arr.shape),
                           "codec": used})

    def finish(self, magic: bytes, version: int, manifest: Dict) -> bytes:
        manifest["blobs"] = self.blobs
        mjson = json.dumps(manifest).encode()
        out = io.BytesIO()
        out.write(magic)
        out.write(struct.pack("<HH", version, _CODEC_FLAG[self.codec]))
        out.write(struct.pack("<Q", len(mjson)))
        out.write(mjson)
        out.write(self.body.getvalue())
        return out.getvalue()


def _open_container(data: bytes, magic: bytes, what: str):
    """(version, manifest, get) for a container byte string."""
    if data[:4] != magic:
        raise ValueError(f"not a {what} container (bad magic)")
    (version, codec_flag) = struct.unpack("<HH", data[4:8])
    header_codec = _FLAG_CODEC.get(codec_flag, CODEC_ZSTD)
    (mlen,) = struct.unpack("<Q", data[8:16])
    manifest = json.loads(data[16:16 + mlen])
    body = data[16 + mlen:]

    def get(name: str) -> np.ndarray:
        for b in manifest["blobs"]:
            if b["name"] == name:
                raw = decompress_bytes(
                    body[b["offset"]: b["offset"] + b["nbytes"]],
                    b.get("codec", header_codec))
                return np.frombuffer(
                    raw, dtype=np.dtype(b["dtype"])).reshape(b["shape"]).copy()
        raise KeyError(name)

    return version, manifest, get


def gfjs_to_bytes(gfjs, *, level: int = 3,
                  codec: Optional[str] = None) -> bytes:
    """Serialize a :class:`GFJS` or :class:`ShardedGFJS` to a byte string.

    Identical format to :func:`save_gfjs` files — a sharded summary writes
    one set of level blobs per shard (``shard{i}/...``) plus the shared
    domains and partition metadata.  This is also the GFJS half of the
    shard-action wire format (workers return their shard's summary as one
    of these blobs).
    """
    w = _BlobWriter(codec, level)

    def add_levels(g: GFJS, prefix: str) -> List[Dict]:
        for i, lvl in enumerate(g.levels):
            w.add(f"{prefix}level{i}/freq", lvl.freq)
            for v in lvl.vars:
                w.add(f"{prefix}level{i}/key/{v}", lvl.key_cols[v])
        return [{"vars": list(l.vars)} for l in g.levels]

    manifest = {
        "version": VERSION,
        "codec": w.codec,
        "join_size": gfjs.join_size,
        "column_order": gfjs.column_order,
        "domains": list(gfjs.domains.keys()),
    }
    if isinstance(gfjs, ShardedGFJS):
        manifest["sharded"] = {"partition_var": gfjs.partition_var,
                               "salt": int(gfjs.salt)}
        manifest["shards"] = [
            {"join_size": s.join_size,
             "levels": add_levels(s, f"shard{i}/")}
            for i, s in enumerate(gfjs.shards)]
    else:
        manifest["levels"] = add_levels(gfjs, "")
    for v, dom in gfjs.domains.items():
        w.add(f"domain/{v}", dom.values)
    return w.finish(MAGIC, VERSION, manifest)


def save_gfjs(gfjs, path: str, *, level: int = 3,
              codec: Optional[str] = None) -> int:
    """Write the summary; returns bytes on disk (Table 4's metric).

    Accepts a :class:`GFJS` or a :class:`ShardedGFJS` (the cache's spill
    path round-trips both transparently); the file body is exactly
    :func:`gfjs_to_bytes`.
    """
    data = gfjs_to_bytes(gfjs, level=level, codec=codec)
    with open(path, "wb") as f:
        f.write(data)
    return os.path.getsize(path)


def gfjs_from_bytes(data: bytes):
    """Load a GFJS/ShardedGFJS from a :func:`gfjs_to_bytes` byte string."""
    if data[:4] != MAGIC:
        raise ValueError("not a GFJS container (bad magic)")
    (version, codec_flag) = struct.unpack("<HH", data[4:8])
    if version == 1:
        # v1 headers packed version as one <I (no codec flag) and wrote
        # zstd-only blobs without per-blob codec entries
        header_codec = CODEC_ZSTD
    elif version == VERSION:
        header_codec = _FLAG_CODEC.get(codec_flag, CODEC_ZSTD)
    else:
        raise ValueError(f"unsupported GFJS version {version}")
    (mlen,) = struct.unpack("<Q", data[8:16])
    manifest = json.loads(data[16:16 + mlen])
    body = data[16 + mlen:]

    def get(name: str) -> np.ndarray:
        for b in manifest["blobs"]:
            if b["name"] == name:
                raw = decompress_bytes(
                    body[b["offset"]: b["offset"] + b["nbytes"]],
                    b.get("codec", header_codec))
                return np.frombuffer(raw, dtype=np.dtype(b["dtype"])).reshape(b["shape"]).copy()
        raise KeyError(name)

    domains = {v: Domain(v, get(f"domain/{v}")) for v in manifest["domains"]}

    def read_levels(levels_meta: List[Dict], prefix: str) -> List[LevelSummary]:
        levels: List[LevelSummary] = []
        for i, meta in enumerate(levels_meta):
            vars_ = tuple(meta["vars"])
            freq = get(f"{prefix}level{i}/freq")
            keys = {v: get(f"{prefix}level{i}/key/{v}") for v in vars_}
            levels.append(LevelSummary(vars_, keys, freq))
        return levels

    if "sharded" in manifest:
        shards = [
            GFJS(read_levels(sm["levels"], f"shard{i}/"),
                 list(manifest["column_order"]), int(sm["join_size"]), domains)
            for i, sm in enumerate(manifest["shards"])]
        return ShardedGFJS(shards, list(manifest["column_order"]),
                           int(manifest["join_size"]), domains,
                           manifest["sharded"]["partition_var"],
                           int(manifest["sharded"]["salt"]))
    return GFJS(read_levels(manifest["levels"], ""),
                list(manifest["column_order"]),
                int(manifest["join_size"]), domains)


def load_gfjs(path: str):
    """Load a summary written by :func:`save_gfjs` (GFJS or ShardedGFJS)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError(f"{path} is not a GFJS file")
    return gfjs_from_bytes(data)


# ---------------------------------------------------------------------------
# EncodedQuery (de)serialization — the outbound shard-action wire format.
# ---------------------------------------------------------------------------

def encoded_query_to_bytes(enc, *, level: int = 3,
                           codec: Optional[str] = None) -> bytes:
    """Serialize an :class:`~repro_torch.relational.encoding.EncodedQuery`.

    Everything a worker needs to run the per-shard pipeline rides in one
    self-describing container: the :class:`JoinQuery` shape (name, table
    occurrences, projection), the shared per-variable domains (raw
    dictionary values, so decode works worker-side too), and each
    occurrence's encoded code columns.  Replicated-by-reference arrays are
    materialized in the blob — the wire carries values, not aliases.
    """
    q = enc.query
    w = _BlobWriter(codec, level)
    for v, dom in enc.domains.items():
        w.add(f"domain/{v}", dom.values)
    for i, cols in enumerate(enc.encoded_tables):
        for v, arr in cols.items():
            w.add(f"occ{i}/{v}", arr)
    manifest = {
        "version": ENC_VERSION,
        "codec": w.codec,
        "query": {
            "name": q.name,
            "tables": [[qt.table, [list(cv) for cv in qt.var_map]]
                       for qt in q.tables],
            "output": list(q.output) if q.output is not None else None,
        },
        "domains": list(enc.domains.keys()),
        "occurrences": [sorted(cols.keys()) for cols in enc.encoded_tables],
    }
    return w.finish(ENC_MAGIC, ENC_VERSION, manifest)


def encoded_query_from_bytes(data: bytes):
    """Inverse of :func:`encoded_query_to_bytes`."""
    from repro_torch.relational.encoding import EncodedQuery
    from repro_torch.relational.query import JoinQuery, QueryTable
    version, manifest, get = _open_container(
        data, ENC_MAGIC, "EncodedQuery")
    if version != ENC_VERSION:
        raise ValueError(f"unsupported EncodedQuery version {version}")
    qm = manifest["query"]
    query = JoinQuery(
        qm["name"],
        tuple(QueryTable(t, tuple((c, v) for c, v in vm))
              for t, vm in qm["tables"]),
        tuple(qm["output"]) if qm["output"] is not None else None,
    )
    domains = {v: Domain(v, get(f"domain/{v}")) for v in manifest["domains"]}
    encoded_tables = [
        {v: get(f"occ{i}/{v}") for v in occ_vars}
        for i, occ_vars in enumerate(manifest["occurrences"])]
    return EncodedQuery(query, domains, encoded_tables)


def gfjs_to_csv(gfjs: GFJS, directory: str) -> int:
    """Paper-exact format: one CSV of (value,freq) pairs per column."""
    os.makedirs(directory, exist_ok=True)
    total = 0
    for i, lvl in enumerate(gfjs.levels):
        for v in lvl.vars:
            p = os.path.join(directory, f"{v}.csv")
            vals = gfjs.domains[v].decode(lvl.key_cols[v])
            with open(p, "w") as f:
                for val, fr in zip(vals, lvl.freq):
                    f.write(f"{val},{fr}\n")
            total += os.path.getsize(p)
    return total
