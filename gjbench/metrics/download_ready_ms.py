"""The program's ``engine:download:ready`` spans, mean per query, in ms:
the host waiting for the kernels that make each level it downloads.

This file also holds what the readers of the program's spans share: a
unit's spans are those with the ``trace_id`` of its root span, the
harness's ``gjbench:<kind>``.  Each reader returns None where the window
has no such spans (an untraced run, or a program without them).
"""


def roots(window, queries: bool = True) -> list:
    """The root spans of the window's done units (a root lies inside its
    unit's times): its queries, or else its aggregate requests."""
    done = {}
    for u in window.done:
        if (u.kind == "query") == queries:
            done.setdefault(f"gjbench:{u.kind}", []).append((u.t0, u.t1))
    return [s for s in window.spans
            if getattr(s, "trace_id", None) is not None
            and any(a <= s.t0 and s.t1 <= b for a, b in done.get(s.name, ()))]


def per_unit(window, pick, queries: bool = True):
    """``{trace_id: [spans picked]}`` with one key per unit, or None where
    no unit holds a span that ``pick`` takes."""
    units = {s.trace_id: [] for s in roots(window, queries)}
    found = False
    for s in window.spans:
        got = units.get(getattr(s, "trace_id", None))
        if got is not None and pick(s):
            got.append(s)
            found = True
    return units if found else None


def mean_ms(window, pick, queries: bool = True):
    """The seconds of the spans ``pick`` takes, summed per unit, mean over
    the units, in ms."""
    units = per_unit(window, pick, queries)
    if units is None:
        return None
    return 1e3 * sum(s.seconds for v in units.values() for s in v) \
        / len(units)


def read(window):
    return mean_ms(window, lambda s: s.name == "engine:download:ready")
