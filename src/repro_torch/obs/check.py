"""Validate an emitted Chrome trace file (CI smoke gate).

    python -m repro_torch.obs.check BENCH_dist.trace.json [--expect-shards]
    python -m repro_torch.obs.check BENCH_serve.trace.json --expect-server
    python -m repro_torch.obs.check BENCH_workload.trace.json --expect-msgcache

Asserts the file parses as Chrome trace-event JSON and contains one span
per executor phase, at least one per-step elimination span carrying
product/drift annotations, and (with ``--expect-shards``) per-shard
spans whose parent is the summarize phase span.  With
``--expect-server`` the trace must additionally profile the serving
front-end: ``server:request`` spans each carrying a ``source``
annotation, and collapsed requests carrying a ``build_span_id`` that
resolves to a real ``server:build`` span — the span-level record of the
latch handoff (DESIGN.md §18).  With ``--expect-msgcache`` the trace
must profile elimination-message reuse (DESIGN.md §20): ``msg:<fp>``
probe spans each carrying ``var`` and ``hit`` annotations, at least one
of them a hit — the span-level proof that a warm build actually skipped
a product.  Exit 0 on success, non-zero with a message on any violation.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

#: Executor phases every traced pipeline run must produce.  Partitioned
#: runs build generators per shard (inside shard spans) and add a
#: partition phase instead of a monolithic build_generator.
REQUIRED_PHASES = ("build_model", "plan", "build_generator", "summarize")
REQUIRED_PHASES_SHARDED = ("build_model", "plan", "partition", "summarize")


def validate(doc: Any, *, expect_shards: bool = False,
             expect_server: bool = False,
             expect_msgcache: bool = False) -> List[str]:
    """Return a list of violations (empty == valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["not a Chrome trace object (missing 'traceEvents')"]
    events = doc["traceEvents"]
    if not isinstance(events, list) or not events:
        return ["'traceEvents' is empty"]

    complete = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event[{i}] is not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "M"):
            errs.append(f"event[{i}] has unsupported ph={ph!r}")
            continue
        if ph == "X":
            for key in ("name", "ts", "dur", "pid", "tid"):
                if key not in ev:
                    errs.append(f"event[{i}] ({ev.get('name')!r}) missing {key!r}")
            if ev.get("dur", 0) < 0:
                errs.append(f"event[{i}] ({ev.get('name')!r}) has negative dur")
            complete.append(ev)

    names = [ev["name"] for ev in complete if "name" in ev]
    required = REQUIRED_PHASES_SHARDED if expect_shards else REQUIRED_PHASES
    for phase in required:
        if f"phase:{phase}" not in names:
            errs.append(f"missing executor phase span 'phase:{phase}'")

    # the step spans, not their ``substep`` children (product, marginal)
    elim = [ev for ev in complete if ev["name"].startswith("eliminate:")
            and ev.get("cat") != "substep"]
    if not elim:
        errs.append("no elimination-step spans ('eliminate:<var>')")
    for ev in elim:
        args = ev.get("args", {})
        if "product" not in args:
            errs.append(f"{ev['name']} span missing 'product' annotation")
        if "est" in args and "drift" not in args:
            errs.append(f"{ev['name']} span has est but no 'drift'")

    if expect_shards:
        by_id = {ev.get("args", {}).get("span_id"): ev for ev in complete}
        shards = [ev for ev in complete if ev["name"].startswith("shard:")]
        if not shards:
            errs.append("no per-shard spans ('shard:<i>')")
        for ev in shards:
            pid = ev.get("args", {}).get("parent_id")
            parent = by_id.get(pid)
            if parent is None or parent["name"] != "phase:summarize":
                errs.append(f"{ev['name']} is not parented to phase:summarize")

    if expect_server:
        by_id = {ev.get("args", {}).get("span_id"): ev for ev in complete}
        reqs = [ev for ev in complete if ev["name"] == "server:request"]
        builds = [ev for ev in complete if ev["name"] == "server:build"]
        if not reqs:
            errs.append("no serving spans ('server:request')")
        for ev in reqs:
            if "source" not in ev.get("args", {}):
                errs.append("server:request span missing 'source' annotation")
                break
        collapsed = [ev for ev in reqs
                     if ev.get("args", {}).get("collapsed")]
        if collapsed and not builds:
            errs.append("collapsed server:request spans but no "
                        "'server:build' span")
        for ev in collapsed:
            bid = ev.get("args", {}).get("build_span_id")
            if bid is None:
                continue            # leader ran untraced (null span id)
            build = by_id.get(bid)
            if build is None or build["name"] != "server:build":
                errs.append("collapsed server:request carries build_span_id "
                            f"{bid!r} that is not a server:build span")

    if expect_msgcache:
        probes = [ev for ev in complete if ev["name"].startswith("msg:")]
        if not probes:
            errs.append("no message-cache probe spans ('msg:<fingerprint>')")
        for ev in probes:
            args = ev.get("args", {})
            if "var" not in args:
                errs.append(f"{ev['name']} span missing 'var' annotation")
            if "hit" not in args:
                errs.append(f"{ev['name']} span missing 'hit' annotation")
        if probes and not any(ev.get("args", {}).get("hit")
                              for ev in probes):
            errs.append("msg: probe spans present but none is a hit — "
                        "the warm run never reused a message")
    return errs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="trace file to validate")
    ap.add_argument("--expect-shards", action="store_true",
                    help="require per-shard spans parented to summarize")
    ap.add_argument("--expect-server", action="store_true",
                    help="require server:request spans with source "
                         "annotations and latch-handoff build links")
    ap.add_argument("--expect-msgcache", action="store_true",
                    help="require msg:<fp> probe spans with var/hit "
                         "annotations and at least one hit")
    ns = ap.parse_args(argv)
    try:
        with open(ns.path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"FAIL {ns.path}: {e}")
        return 2
    errs = validate(doc, expect_shards=ns.expect_shards,
                    expect_server=ns.expect_server,
                    expect_msgcache=ns.expect_msgcache)
    if errs:
        for e in errs:
            print(f"FAIL {ns.path}: {e}")
        return 1
    n = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X")
    print(f"OK {ns.path}: {n} spans, all executor phases present")
    return 0


if __name__ == "__main__":
    sys.exit(main())
