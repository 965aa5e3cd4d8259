"""The port stands alone: no jax, no ``repro``, and an explicit device.

A child process with ``jax`` and ``repro`` blocked imports ``repro_torch``
and runs Figure 1 on the CPU, desummarizes it and aggregates from it; a source scan finds no jax or ``repro``
import under ``src/repro_torch/`` or in ``chip_smoke.py``; and a ``cuda``
entry point without a card raises instead of running on the CPU.
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
from repro_torch.relational.synth import figure1
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
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print(len(rows["A"]), by_a["A"].tolist(), by_a["count"].tolist())
"""


def test_port_runs_with_jax_and_reference_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "32 ['a3'] [32]"


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)", re.M)


def test_source_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = {str(f.relative_to(ROOT)): _IMPORT.findall(f.read_text())
           for f in files}
    assert not {f: m for f, m in bad.items() if m}


@pytest.mark.parametrize("entry", ["facade", "generate", "desummarize",
                                   "build_factor", "segment_weighted_sum",
                                   "group_runs_device", "summary_frame"])
def test_cuda_without_a_card_raises(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cat, q = figure1()
    if entry == "facade":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            repro_torch.GraphicalJoin(cat, q)
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
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
