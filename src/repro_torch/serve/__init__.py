"""Serving layer: the LM engine (``engine.py``) and the Graphical-Join
serving front-end (``server.py``).

Submodule re-exports resolve lazily (PEP 562), as in the reference:
consumers of the :class:`JoinServer` alone never import the models.
"""

_ENGINE = {"RelationalFeatureProvider", "ServeConfig", "ServeEngine",
           "make_serve_step"}
_SERVER = {"AdmissionRejected", "DeadlineExceeded", "JoinServer",
           "SingleFlight", "lookup_rows"}

__all__ = sorted(_ENGINE | _SERVER)


def __getattr__(name):
    import importlib
    if name in _ENGINE:
        return getattr(importlib.import_module("repro_torch.serve.engine"),
                       name)
    if name in _SERVER:
        return getattr(importlib.import_module("repro_torch.serve.server"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
