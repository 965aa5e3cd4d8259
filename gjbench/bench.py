"""``BENCHMARK.json`` and the files its names lead to.

A cell names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``); every metric, end-to-end or per-layer, is
read by ``metrics/<name>.py``.  A metric with a ``workloads`` key is
reported in those cells only; one without it in every cell (a per-layer
metric: in every cell that reports the end-to-end metric it ``moves``).
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable            # read(window) -> Optional[float]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``, loaded by path (names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"gjbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _applies(entry: dict, cell: str, reported: Optional[set] = None) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def parts(config: str, traffic: str) -> Tuple[dict, dict]:
    """A configuration's and a traffic mix's files, by name."""
    cfg = load_json(HERE / "configs" / f"{config}.json")
    cfg["name"] = config
    mix = load_json(HERE / "traffic" / f"{traffic}.json")
    mix["name"] = traffic
    return cfg, mix


def cell(name: str, sp: Optional[dict] = None) -> Cell:
    sp = spec() if sp is None else sp
    try:
        w = next(w for w in sp["workloads"] if w["name"] == name)
    except StopIteration:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json") from None
    config, traffic = parts(w["config"], w["traffic"])
    e2e = [m for m in sp["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in sp["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), config, traffic,
                [Metric(m["name"], m["unit"], reader(m["name"])) for m in e2e],
                [Metric(m["name"], m["unit"], reader(m["name"]))
                 for m in layer])
