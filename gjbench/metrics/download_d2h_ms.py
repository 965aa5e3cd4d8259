"""The program's ``engine:download:d2h`` spans, mean per query, in ms: the
host waiting on the card's copies of each level into host memory."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.name == "engine:download:d2h")
