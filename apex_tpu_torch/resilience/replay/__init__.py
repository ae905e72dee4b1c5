"""Deterministic replay & divergence forensics (counterpart of
apex_tpu/resilience/replay/).

- ``journal``  — the flight recorder: per-step nondeterminism inputs
  (batch ids + content crc, chaos arms, lr_scale) and output
  fingerprints (loss, verdict, per-layer layer_out_rms),
  ``kind="journal"`` records through the MetricRouter plus a
  checkpoint-anchored sidecar jsonl; host-only.
- ``replayer`` — checkpoint-anchored re-execution through the GPT step
  of ``targets.build_gpt_training`` (the step the GPT example trains
  with), compared bitwise on the recording device;
  ``determinism_guard`` is the one home of the numerics flags.
- ``bisect``   — binary-search the first divergent step across the
  verified anchors, then name the leaf and the layer: one
  ``kind="divergence"`` forensic record.
- ``targets``  — the GPT training step, built in one place.

CLI: ``python -m apex_tpu_torch.resilience.replay`` (verify /
``--bisect`` / ``--diff`` / the exit-nonzero ``--selftest`` gate).
"""

from apex_tpu_torch.resilience.replay.bisect import (
    bisect_divergence,
    format_divergence,
)
from apex_tpu_torch.resilience.replay.journal import (
    JOURNAL_FILENAME,
    FlightRecorder,
    Journal,
    batch_crc,
    journal_path,
    load_journal,
)
from apex_tpu_torch.resilience.replay.replayer import (
    GPTReplayContext,
    ReplayError,
    ReplayReport,
    build_context,
    compare_journals,
    determinism_guard,
    numerics_flags_kept,
    replay_segment,
    verified_anchor_steps,
)
from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    GPTTraining,
    GPTTrainState,
    build_gpt_training,
    synthetic_corpus,
)

__all__ = [
    "JOURNAL_FILENAME", "FlightRecorder", "GPTReplayContext",
    "GPTTargetConfig", "GPTTrainState", "GPTTraining", "Journal",
    "ReplayError", "ReplayReport", "batch_crc", "bisect_divergence",
    "build_context", "build_gpt_training", "compare_journals",
    "determinism_guard", "format_divergence", "journal_path",
    "load_journal", "numerics_flags_kept", "replay_segment",
    "synthetic_corpus", "verified_anchor_steps",
]
