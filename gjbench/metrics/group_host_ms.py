"""GROUP BY's time on the host: each ``frame:group_by`` span less its
outermost ``engine:*`` and ``kernel:*`` descendants (found by
``parent_id``), summed per request, mean over the requests that group,
in ms."""

from collections import defaultdict

from gjbench.metrics.download_ready_ms import per_unit


def read(window):
    units = per_unit(window, lambda s: s.name == "frame:group_by",
                     queries=False)
    if units is None:
        return None
    kids = defaultdict(list)
    for s in window.spans:
        kids[s.parent_id].append(s)

    def engine_s(span) -> float:
        return sum(c.seconds if c.name.startswith(("engine:", "kernel:"))
                   else engine_s(c) for c in kids[span.span_id])

    groups = [v for v in units.values() if v]
    return 1e3 * sum(s.seconds - engine_s(s) for v in groups for s in v) \
        / len(groups)
