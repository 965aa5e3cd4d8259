"""``torch.cuda.max_memory_allocated()`` over the window (reset at its
start), in GB."""


def read(window):
    return None if window.peak_bytes is None else window.peak_bytes / 1e9
