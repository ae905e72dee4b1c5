"""Static analysis of the port: the AST lint, the concurrency analyzer and
the trace passes over one recorded step, one framework (counterpart of
apex_tpu/analysis/).

The pre-flight validation layer: the port's correctness-by-construction
claims — mixed precision with chosen f32 islands, hand-wired collectives,
one host sync a step, a threaded host runtime with documented
handshakes — checked by auditors that report structured :class:`Finding`
records through a reason-carrying allowlist and the shared telemetry
schema (``kind="analysis"`` via ``monitor.MetricRouter``):

- ``precision``   — unintended low -> f32/f64 promotions among the
  step's recorded aten ops (precision.py)
- ``collective``  — groups outside the layout, point-to-point edges that
  are no permutation or leave a gap in a pipeline chain, collectives
  over one-rank groups (collectives.py, over ``monitor.xray.ledger``)
- ``host-sync``   — host reads of device values inside the step
  (host_sync.py; on the card held to ``torch.cuda.set_sync_debug_mode``)
- ``lint``        — the source rules (lint.py)
- ``concurrency`` — the static race/deadlock analyzer over the threaded
  host runtime (concurrency/), pure AST
- ``donation``    — declared in-place state against the storage the step
  really reused (donation.py)
- ``hlo-comms``, ``hlo-sharding``, ``hlo-memory`` — the recorded step's
  dispatched collectives against the ledger, state whole on every rank
  of a parallel axis, and the step's memory against the HBM ledger
  (hlo/)
- ``trace_smoke`` — a two-step profiler capture through the timeline
  analyzer (``monitor.xray.timeline``): the trace schema's drift check
- ``autofix``     — prescriptions derived from the findings, applied to
  step builders whose specs are data, re-audited to a fixpoint
  (autofix/, ``--fix``)

The trace passes run ONE eager step of the target under a recorder
(passes.py's docstring says why and what that costs). CLI:
``python -m apex_tpu_torch.analysis`` runs the AST rules over
``apex_tpu_torch/``, the trace passes over the GPT and BERT steps on a
gloo world of 4 ranks (``--device cpu`` on the CPU; the card by
default) and the trace smoke, exiting non-zero on an unallowlisted
finding or a stale entry; ``--fix`` runs autofix over
``targets.FIXABLE_TARGETS``.

Attribute access is lazy (PEP 562): importing this package imports
neither torch nor the passes, so the AST half and goodput's sentinel run
on any box.
"""

_EXPORTS = {
    # findings / allowlist (stdlib only)
    "Finding": "findings",
    "AllowlistEntry": "findings",
    "Allowlist": "findings",
    "AnalysisResult": "findings",
    "SEV_ERROR": "findings",
    "SEV_WARNING": "findings",
    "SEV_INFO": "findings",
    "merge_findings": "findings",
    # trace-pass framework
    "TRACE_PASSES": "passes",
    "trace_pass": "passes",
    "StepTarget": "passes",
    "StepContext": "passes",
    "Recorder": "passes",
    "op_site": "passes",
    "run_passes": "passes",
    # lint framework (stdlib only)
    "LINT_RULES": "lint",
    "lint_rule": "lint",
    "LintContext": "lint",
    "run_lint": "lint",
    "collect_sources": "lint",
    "LEDGERED_OPS": "lint",
    # concurrency passes (stdlib only)
    "run_concurrency": "concurrency",
    "CONCURRENCY_PASSES": "concurrency",
    # repo allowlist + CLI targets
    "REPO_ALLOWLIST": "allowlist",
    "repo_allowlist": "allowlist",
    "gpt_step_target": "targets",
    "gpt_compressed_step_target": "targets",
    "bert_step_target": "targets",
    "gpt_pp_step_target": "targets",
    "gpt_zero_naive_step_target": "targets",
    "FIXABLE_TARGETS": "targets",
    "all_targets": "targets",
    # the trace smoke
    "timeline_smoke_findings": "trace_smoke",
}

__all__ = sorted(_EXPORTS) + [
    "findings", "passes", "precision", "collectives", "host_sync", "lint",
    "allowlist", "targets", "concurrency", "donation", "hlo", "autofix",
    "trace_smoke",
]

_SUBMODULES = frozenset(__all__) - frozenset(_EXPORTS)


def __getattr__(name):
    import importlib

    if name in _EXPORTS:
        mod = importlib.import_module(
            f"apex_tpu_torch.analysis.{_EXPORTS[name]}")
        return getattr(mod, name)
    if name in _SUBMODULES:
        return importlib.import_module(f"apex_tpu_torch.analysis.{name}")
    raise AttributeError(
        f"module 'apex_tpu_torch.analysis' has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
