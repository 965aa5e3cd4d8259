"""Join rows delivered as device-resident code columns, per second of the
window (whole queries only)."""


def read(window):
    q = [u for u in window.done if u.kind == "query"]
    return sum(u.rows for u in q) / window.seconds if q else None
