"""The program's ``engine:download`` spans, mean per query, in ms: the
wait for the kernels that make a level plus its copy to the host."""


def read(window):
    q = [u for u in window.done if u.kind == "query"]
    if not q or not window.spans:
        return None
    return 1e3 * window.span_seconds("engine:download") / len(q)
