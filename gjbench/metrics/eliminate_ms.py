"""The elimination steps (``eliminate:<v>`` and ``eliminate:bag[...]``,
category ``step``; their ``substep`` children, the product and the
marginal, are inside them), mean per query, in ms."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.cat == "step"
                   and s.name.startswith("eliminate:"))
