"""The planner's order search (``plan:orders``: the candidate orders
simulated and scored), mean per query, in ms."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.name == "plan:orders")
