"""The GPT training step, built in one place (``targets``)."""

from apex_tpu_torch.resilience.replay.targets import (
    GPTTargetConfig,
    GPTTraining,
    GPTTrainState,
    build_gpt_training,
    synthetic_corpus,
)

__all__ = ["GPTTargetConfig", "GPTTrainState", "GPTTraining",
           "build_gpt_training", "synthetic_corpus"]
