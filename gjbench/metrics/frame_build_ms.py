"""``SummaryFrame.of``'s copy of the summary's weights (``frame:of``),
mean per aggregate request, in ms."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.name == "frame:of", queries=False)
