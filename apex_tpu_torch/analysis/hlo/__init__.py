"""What one step really did, audited (counterpart of
apex_tpu/analysis/hlo/).

The trace passes and the xray ledger see what the program ASKS for; this
subpackage audits what the step DID. The JAX package reads XLA's
optimized HLO; eager torch compiles nothing, so the port reads the
recorder's capture of one step (``parser``: the dispatched c10d ops with
their process groups, the state tensors' storages before and after, the
outputs, the allocator's watermarks), attributes each op's group to a
layout axis (``attribution``), and audits it: the ghost-collective
differ (``comms_diff``, dispatched against ledger-predicted traffic),
the replicated-state auditor (``sharding_audit``, >= 1 MiB state whole on
every rank of a parallel axis) and the memory differ (``memory_diff``,
the recorded state and the allocator against the HBM ledger). The audits
register as trace passes (``hlo-comms``, ``hlo-sharding``,
``hlo-memory``) so ``run_passes`` and ``python -m
apex_tpu_torch.analysis`` run them with the others.

Lazy attribute access (PEP 562), as the parent package: importing
``apex_tpu_torch.analysis.hlo`` imports neither torch nor the audits.
"""

_EXPORTS = {
    # parser
    "HloModule": "parser",
    "HloCollective": "parser",
    "HloParam": "parser",
    "HloShape": "parser",
    "COLLECTIVE_KINDS": "parser",
    "KIND_CLASS": "parser",
    "state_leaves": "parser",
    # attribution (stdlib only)
    "LayoutMesh": "attribution",
    "layout_mesh": "attribution",
    "mesh_axis_partitions": "attribution",
    "classify_replica_groups": "attribution",
    "classify_source_target_pairs": "attribution",
    "canon_axis_key": "attribution",
    "AXIS_NONE": "attribution",
    "AXIS_UNKNOWN": "attribution",
    # audits
    "audit_comms": "comms_diff",
    "OP_CLASS": "comms_diff",
    "audit_entry_shardings": "sharding_audit",
    "audit_memory": "memory_diff",
    "COMPONENT_ROOTS": "memory_diff",
    "largest_buffers": "memory_diff",
}

__all__ = sorted(_EXPORTS) + [
    "parser", "attribution", "comms_diff", "sharding_audit", "memory_diff",
]

_SUBMODULES = frozenset(__all__) - frozenset(_EXPORTS)


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        mod = importlib.import_module(
            f"apex_tpu_torch.analysis.hlo.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.analysis.hlo.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.analysis.hlo' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
