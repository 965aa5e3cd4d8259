"""The traffic: closed loops with one client, as a traffic file sets them.

``fresh_query``: each unit is one query, from a new ``GraphicalJoin`` to
its rows as device-resident code columns (``run()`` then
``desummarize(decode=False)``); nothing is cached between queries, and a
query's columns and summary are released before the next starts.  The
last query's columns are kept past the window for the comparison.

``summary_aggs``: one ``JoinService`` holds the query's summary, built in
set-up; each unit is one aggregate request.  A round asks every kind of
the traffic file once, in an order drawn from the seed.

Each loop's ``checks`` compare what the window produced with the plain
reference (:mod:`gjbench.reference`) and return ``{name: (value,
limit)}``; a run is correct where no value passes its limit.
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np

from gjbench.data import Data
from gjbench.reference import join, rows
from gjbench.window import Unit, Window


def now() -> float:
    return time.perf_counter()


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def program_inputs(cfg: dict, traffic: dict, data: Data):
    """The program's catalog and query, built from the benchmark's tables."""
    from repro_torch.relational.query import JoinQuery
    from repro_torch.relational.table import Catalog, Table
    cat = Catalog.of(*[Table(t, dict(cols)) for t, cols in data.tables.items()])
    q = cfg["queries"][traffic["query"]]
    return cat, JoinQuery.of(traffic["query"], [(t, dict(b)) for t, b in q])


class Loop:
    def __init__(self, cfg: dict, traffic: dict, data: Data, dev, seed: int,
                 tracer=None) -> None:
        self.cfg, self.traffic, self.data = cfg, traffic, data
        self.dev, self.seed, self.tracer = dev, seed, tracer
        self.query = cfg["queries"][traffic["query"]]
        self.cat, self.jq = program_inputs(cfg, traffic, data)

    def span(self, name: str):
        return self.tracer.span(name, cat="gjbench") if self.tracer \
            else contextlib.nullcontext()

    def unit(self, kind: str, fn) -> Unit:
        """Run one unit; a unit that raises is counted as failed."""
        t0 = now()
        try:
            with self.span(f"gjbench:{kind}"):
                u = fn()
                sync(self.dev)
        except Exception:                                  # noqa: BLE001
            traceback.print_exc(file=sys.stderr)
            return Unit(kind, t0, now(), failed=True)
        u.t0, u.t1 = t0, now()
        return u

    def tree(self) -> join.Tree:
        return join.build(self.query, self.data.tables)


class FreshQuery(Loop):
    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        self.last: Optional[Tuple[dict, dict]] = None

    def _query(self) -> Unit:
        import repro_torch
        gj = repro_torch.GraphicalJoin(self.cat, self.jq, device=self.dev,
                                       tracer=self.tracer)
        gfjs = gj.run()
        cols = gj.desummarize(gfjs, decode=False)
        n = {int(c.numel()) for c in cols.values()}
        self.last = (cols, {v: gfjs.domains[v].values for v in cols})
        u = Unit("query", 0.0, 0.0, rows=max(n), timings=dict(gj.timings))
        u.timings["join_size"] = gfjs.join_size
        return u

    def round(self) -> List[Unit]:
        self.last = None                  # the previous query's rows go
        return [self.unit("query", self._query)]

    def warm(self) -> None:
        self.round()
        self.last = None

    def release(self) -> None:
        """Only the last query's columns and domains outlive the window."""

    def checks(self, window: Window) -> Dict[str, Tuple[int, int]]:
        tree = self.tree()
        want = join.count(tree)
        counts = [u.rows for u in window.done] + \
            [int(u.timings["join_size"]) for u in window.done]
        return rows_checks(tree, counts, self.last, self.seed, want)


def rows_checks(tree: join.Tree, counts: List[int], output, seed: int,
                want: int) -> Dict[str, Tuple[int, int]]:
    """``row_count_gap``: the largest |rows - ``want``| over the units;
    ``row_multiset_gap``: how many of the fingerprints of ``output``
    (columns, values) differ from the reference's."""
    gap = max((abs(c - want) for c in counts), default=want)
    if output is None:
        miss = rows.SALTS
    else:
        try:
            got, n = rows.fingerprint(*output, seed)
            gap = max(gap, abs(n - want))
            miss = sum(a != b for a, b in zip(got, rows.expected(tree, seed)))
        except ValueError as exc:
            print(f"rows: {exc}", file=sys.stderr)
            miss = rows.SALTS
    return {"row_count_gap": (gap, 0), "row_multiset_gap": (miss, 0)}


class SummaryAggs(Loop):
    def __init__(self, *a, **kw) -> None:
        super().__init__(*a, **kw)
        from repro_torch.summary import JoinService
        self.kinds = self.traffic["kinds"]
        self.rng = np.random.default_rng([self.seed, 1])
        self.answers: List[Tuple[str, object]] = []
        self.svc = JoinService(self.cat, device=self.dev, incremental=False,
                               byte_budget=int(self.traffic["byte_budget"]))
        with self.span("gjbench:build"):
            self.svc.frame(self.jq)        # the summary this traffic reads
            sync(self.dev)

    def ask(self, kind: dict):
        if kind.get("by"):
            return self.svc.group_by(self.jq, kind["by"], count="count")
        return self.svc.count(self.jq)

    def _request(self, kind: dict) -> Unit:
        ans = self.ask(kind)
        self.answers.append((kind["name"], ans))
        return Unit(kind["name"], 0.0, 0.0)

    def round(self) -> List[Unit]:
        order = self.rng.permutation(len(self.kinds))
        return [self.unit(self.kinds[i]["name"],
                          lambda k=self.kinds[i]: self._request(k))
                for i in order]

    def warm(self) -> None:
        for k in self.kinds:
            self.ask(k)

    def release(self) -> None:
        self.svc = None

    def reference(self, ring: str = "count") -> Dict[str, object]:
        tree = self.tree()
        out = {}
        for k in self.kinds:
            if k.get("by"):
                (var,) = k["by"]
                out[k["name"]] = join.group_count(tree, var, ring)
            else:
                out[k["name"]] = join.count(tree, ring)
        return out

    def checks(self, window: Window) -> Dict[str, Tuple[int, int]]:
        return agg_checks(self.answers, self.reference())


def answer_gap(got, want) -> int:
    """The largest |count - reference| of one answer (a group missing on
    one side counts as 0 there)."""
    if not isinstance(want, dict):
        return abs(int(got) - int(want))
    (key,) = [k for k in want if k != "count"]
    keys = np.union1d(np.asarray(got[key]), want[key])

    def at(ans):
        out = np.zeros(len(keys), np.int64)
        out[np.searchsorted(keys, np.asarray(ans[key]))] = \
            np.asarray(ans["count"], np.int64)
        return out

    return int(np.abs(at(got) - at(want)).max()) if len(keys) else 0


def agg_checks(answers, reference) -> Dict[str, Tuple[int, int]]:
    """``answers_wrong``: answers unequal to the reference's;
    ``count_gap``: the largest |count - reference| over all answers."""
    gaps = [answer_gap(a, reference[k]) for k, a in answers]
    wrong = sum(g != 0 for g in gaps)
    if not answers:
        wrong = 1
    return {"answers_wrong": (wrong, 0), "count_gap": (max(gaps, default=0), 0)}


LOOPS = {"fresh_query": FreshQuery, "summary_aggs": SummaryAggs}
