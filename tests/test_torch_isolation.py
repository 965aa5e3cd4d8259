"""The port stands alone: no jax, no ``repro``, and an explicit device.

A child process with ``jax`` and ``repro`` blocked imports ``repro_torch``
and runs Figure 1 on the CPU, desummarizes it and aggregates from it, then
calls ``ops.dense_message`` and ``ops.rle_expand``, answers a COUNT
through a ``JoinServer`` in front of a ``JoinService``, and runs a
``partitions=2`` build; a source scan finds no jax or ``repro`` import
under ``src/repro_torch/`` (the serving and partitioning modules
included) or in ``chip_smoke.py``; and a ``cuda`` entry point without a
card raises instead of running on the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.core.potentials import Factor
from repro_torch.dist.partition import partition_histogram
from repro_torch.relational.synth import figure1
from repro_torch.summary import JoinService
from repro_torch.summary.algebra import SummaryFrame

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
from repro_torch.relational.synth import figure1
cat, q = figure1()
gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
gfjs = gj.run()
rows = gj.desummarize(gfjs)
by_a = gj.aggregate("count", by=["A"], gfjs=gfjs)
import torch
from repro_torch.kernels import ops
msg = ops.dense_message(torch.ones((2, 3), dtype=torch.int32),
                        torch.full((3, 1), 7, dtype=torch.int32))
col = ops.rle_expand(torch.tensor([4, 5], dtype=torch.int32),
                     torch.tensor([2, 3], dtype=torch.int32), 3)
from repro_torch.serve import JoinServer
from repro_torch.summary import JoinService
server = JoinServer(JoinService(cat, device="cpu"))
n = server.frame(q).frame.count()
sharded = repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2).run()
assert sharded.num_partitions == 2 and sharded.join_size == n
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(rows["A"]), by_a["A"].tolist(), by_a["count"].tolist(),
      msg[:, 0].tolist(), col.tolist(), n)
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "32 ['a3'] [32] [21, 21] [4, 4, 5] 32"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)", re.M)


def test_source_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    names = {str(f.relative_to(ROOT / "src" / "repro_torch"))
             for f in files[:-1]}
    assert {"obs/check.py", "summary/cache.py", "summary/incremental.py",
            "summary/msgcache.py", "summary/service.py",
            "serve/server.py", "serve/__init__.py", "dist/partition.py",
            "dist/actions.py", "dist/__init__.py", "ft/straggler.py"} <= names
    bad = {str(f.relative_to(ROOT)): _IMPORT.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


@pytest.mark.parametrize("entry", ["facade", "generate", "desummarize",
                                   "build_factor", "segment_weighted_sum",
                                   "group_runs_device", "summary_frame",
                                   "maybe_dense_message", "join_service",
                                   "partition_histogram",
                                   "partitioned_facade"])
def test_cuda_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat, q = figure1()
    if entry in ("facade", "partitioned_facade"):
        kw = dict(partitions=2) if entry == "partitioned_facade" else {}
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.GraphicalJoin(cat, q, **kw)
        return
    gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
    gfjs = gj.run()
    ones = np.ones(3, np.int64)
    calls = {
        "generate": lambda: engine.generate_gfjs(gj.generator,
                                                 gj.enc.domains),
        "desummarize": lambda: engine.desummarize(gfjs),
        "build_factor": lambda: engine.build_factor({"A": ones}, {"A": 2}),
        "segment_weighted_sum": lambda: engine.segment_weighted_sum(
            np.zeros(3, np.int32), ones, ones, 1),
        "group_runs_device": lambda: engine.group_runs_device(ones),
        "summary_frame": lambda: SummaryFrame.of(gfjs),
        "maybe_dense_message": lambda: engine.maybe_dense_message(
            Factor(("P", "V"), np.zeros((1, 2), np.int64), ones[:1],
                   ones[:1], (1, 1)), "V", ones[:1]),
        "join_service": lambda: JoinService(cat),
        "partition_histogram": lambda: partition_histogram(ones, 2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
