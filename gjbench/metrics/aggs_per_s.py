"""Aggregate answers completed per second of the window."""


def read(window):
    a = [u for u in window.done if u.kind != "query"]
    return len(a) / window.seconds if a else None
