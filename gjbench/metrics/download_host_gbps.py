"""The host's rate into fresh pages while downloading: the ``bytes`` over
the seconds of the queries' ``engine:download:host`` spans, in GB/s."""

from gjbench.metrics.download_ready_ms import per_unit


def read(window):
    units = per_unit(window, lambda s: s.name == "engine:download:host")
    if units is None:
        return None
    spans = [s for v in units.values() for s in v]
    seconds = sum(s.seconds for s in spans)
    if seconds <= 0:
        return None
    return sum(s.args.get("bytes", 0) for s in spans) / seconds / 1e9
