"""A run loads no JAX and no JAX package; the reference imports nothing of
the program."""

import ast
import json
import os
import subprocess
import sys

import pytest

from gjbench.run import FORBIDDEN
from gjbench.tests.conftest import ROOT

PKG = ROOT / "gjbench"


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((PKG / "reference").glob("*.py")):
        tops = set(imported_tops(path))
        assert not tops & {"repro_torch", *FORBIDDEN}, path


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    for path in sorted(PKG.rglob("*.py")):
        if "tests" in path.parts:
            continue
        assert not set(imported_tops(path)) & set(FORBIDDEN), path


@pytest.mark.parametrize("names, found", [
    (["repro_torch", "repro_torch.core.api", "reprox", "jaxtyping"], []),
    (["repro.core.api", "repro_torch"], ["repro"]),
    (["jax.numpy", "jaxlib", "flax.linen", "numpy"], ["flax", "jax",
                                                      "jaxlib"]),
])
def test_forbidden_names_are_compared_whole(names, found):
    from gjbench import run
    assert run.forbidden_modules(names) == found


RUN_SMALL = """
import json, sys
from gjbench import bench, run
from gjbench.tests.conftest import SMALL
out = {}
for name in %r:
    cell = bench.cell(name)
    r = run.drive(cell, 2**31 + 1, 0.2, True, "cpu",
                  sizes=SMALL[cell.config["name"]])
    out[name] = r["correct"]
print(json.dumps({"correct": out, "forbidden": run.forbidden_modules()}))
"""


def env():
    e = dict(os.environ)
    e["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    return e


def test_a_run_loads_no_forbidden_module():
    cells = ["lastfm.a2_rows", "lastfm.a2_aggs"]
    p = subprocess.run([sys.executable, "-c", RUN_SMALL % (cells,)],
                       capture_output=True, text=True, env=env(), cwd=ROOT,
                       timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["forbidden"] == [] and all(out["correct"].values())


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import sys, gjbench.reference.join, gjbench.reference.rows; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax'}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env(), cwd=ROOT, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_without_a_card_the_command_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "gjbench/run.py", "--workload",
                        "lastfm.a2_rows", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       env=env(), cwd=ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
