"""The planner's statistics pass (``plan:stats``: the potentials of every
table occurrence, on the host), mean per query, in ms."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.name == "plan:stats")
