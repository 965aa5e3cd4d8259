"""The 90th percentile (nearest rank) of query-to-rows latency over every
query of the window, failed ones counted as the slowest."""

import math


def read(window):
    q = [u for u in window.units if u.kind == "query"]
    if not q:
        return None
    lat = sorted(math.inf if u.failed else u.seconds for u in q)
    return lat[math.ceil(0.9 * len(lat)) - 1]
