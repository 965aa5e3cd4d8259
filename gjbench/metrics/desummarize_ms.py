"""Desummarization to code columns (``timings["desummarize"]``), mean per
query, in ms."""


def read(window):
    q = [u for u in window.done if u.kind == "query"]
    return window.mean([1e3 * u.timings.get("desummarize", 0.0) for u in q])
