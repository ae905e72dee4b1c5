"""apex_tpu_torch.serving.fleet — N replicas behind one resilient front door.

Replica failover on the remediation policy, prefill/decode
disaggregation with a ledgered KV handoff, prefix-cache-aware placement
and SLO-driven elastic scaling — see router.py's module docstring and
docs/serving.md ("Fleet"). The gate is
``python -m apex_tpu_torch.serving --selftest --fleet``.

Attribute access is lazy (PEP 562), as in apex_tpu/serving/fleet/:
``prefix``/``handoff``/``autoscaler`` import no torch, and the
engine-touching router/replica load on demand.
"""

_EXPORTS = {
    # policy and bookkeeping
    "RadixPrefixIndex": "prefix",
    "HandoffLedger": "handoff",
    "HandoffEntry": "handoff",
    "FleetAutoscaler": "autoscaler",
    # engine-touching orchestration
    "Replica": "replica",
    "FleetConfig": "router",
    "FleetRouter": "router",
    "engine_factory": "router",
}

__all__ = sorted(_EXPORTS) + [
    "autoscaler", "handoff", "prefix", "replica", "router",
]

_SUBMODULES = frozenset(__all__) - frozenset(_EXPORTS)


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        mod = importlib.import_module(
            f"apex_tpu_torch.serving.fleet.{_EXPORTS[name]}"
        )
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.serving.fleet.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.serving.fleet' has no attribute {name!r}"
    )


def __dir__():
    return sorted(set(globals()) | set(__all__))
