"""Serving layer: the Graphical-Join serving front-end (``server.py``).

The reference's package also re-exports its LM engine
(``repro/serve/engine.py``: ``ServeEngine``, ``ServeConfig``,
``make_serve_step``, ``RelationalFeatureProvider``).  That engine is not
ported yet (ROADMAP.md queue 1, the LM, training and serving stack), so
asking for those names raises :class:`AttributeError` naming that item.
Re-exports resolve lazily (PEP 562), as in the reference.
"""

_ENGINE = {"RelationalFeatureProvider", "ServeConfig", "ServeEngine",
           "make_serve_step"}
_SERVER = {"AdmissionRejected", "DeadlineExceeded", "JoinServer",
           "SingleFlight", "lookup_rows"}

__all__ = sorted(_SERVER)


def __getattr__(name):
    import importlib
    if name in _ENGINE:
        raise AttributeError(
            f"{name!r} belongs to the LM serving engine, which is not ported "
            "yet (ROADMAP.md queue 1: LM, training and serving stack)")
    if name in _SERVER:
        return getattr(importlib.import_module("repro_torch.serve.server"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
