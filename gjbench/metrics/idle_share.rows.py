"""The card's idle share of the traced window of a rows cell, in %: one
less the union of its kernel and copy intervals over the window."""


def read(window):
    dt = window.device
    return None if dt is None else 100.0 * (1.0 - dt.busy_s / dt.window_s)
