"""GFJS generation (``timings["summarize"]``, with the device wait and the
download), mean per query, in ms."""


def read(window):
    q = [u for u in window.done if u.kind == "query"]
    return window.mean([1e3 * u.timings.get("summarize", 0.0) for u in q])
