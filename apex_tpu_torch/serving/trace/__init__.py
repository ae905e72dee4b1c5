"""apex_tpu_torch.serving.trace — the request x-ray.

Fleet-wide distributed tracing (one causal span tree per request, the
global id as trace id), per-request critical-path TTFT attribution with
a digit-exact partition identity, and SLO burn-rate accounting — see
emit.py / analyze.py / slo.py module docstrings and docs/serving.md
("Tracing & critical path"). The gate is
``python -m apex_tpu_torch.serving.trace run.jsonl``.

Attribute access is lazy (PEP 562, the package-wide contract); every
submodule here is plain Python (copied from apex_tpu/serving/trace/,
which imports no JAX): a stream is x-rayable on any box.
"""

_EXPORTS = {
    "ROOT_SPAN": "emit",
    "TraceEmitter": "emit",
    "ATTRIBUTION_PRIORITY": "analyze",
    "REQUEST_PHASES": "analyze",
    "RequestTrace": "analyze",
    "TraceReport": "analyze",
    "build_traces": "analyze",
    "check_identity": "analyze",
    "decompose": "analyze",
    "FAST_BURN": "slo",
    "SLOMonitor": "slo",
}

# ``analyze`` stays a SUBMODULE name (the function of the same name is
# ``trace.analyze.analyze``) — exporting both would shadow the module.
__all__ = sorted(_EXPORTS) + ["analyze", "emit", "slo"]

_SUBMODULES = frozenset(__all__) - frozenset(_EXPORTS)


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        mod = importlib.import_module(
            f"apex_tpu_torch.serving.trace.{_EXPORTS[name]}"
        )
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.serving.trace.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.serving.trace' has no attribute {name!r}"
    )


def __dir__():
    return sorted(set(globals()) | set(__all__))
