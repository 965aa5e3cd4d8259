"""The program's ``engine:upload`` and ``engine:download`` spans, mean per
aggregate request, in ms."""


def read(window):
    a = [u for u in window.done if u.kind != "query"]
    if not a or not window.spans:
        return None
    return 1e3 * window.span_seconds("engine:upload",
                                     "engine:download") / len(a)
