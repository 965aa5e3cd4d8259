"""The facade's and planner's host phases (``timings`` build_model + plan
+ build_generator), mean per query, in ms."""


def read(window):
    q = [u for u in window.done if u.kind == "query"]
    return window.mean([1e3 * sum(u.timings.get(k, 0.0) for k in
                                  ("build_model", "plan", "build_generator"))
                        for u in q])
