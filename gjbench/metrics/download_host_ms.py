"""The program's ``engine:download:host`` spans, mean per query, in ms:
the host copying (and widening) each downloaded level out of pinned
memory into its new pageable array, page faults included."""

from gjbench.metrics.download_ready_ms import mean_ms


def read(window):
    return mean_ms(window, lambda s: s.name == "engine:download:host")
