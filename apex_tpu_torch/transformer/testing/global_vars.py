"""Megatron-style global variables (counterpart of
apex_tpu/transformer/testing/global_vars.py; ref:
apex/transformer/testing/global_vars.py:26-200).

The process-global args, microbatch calculator, tensorboard writer and
timers, with initialize-once semantics: :func:`set_global_variables`
parses the args and builds the other three, each getter of an
initialized variable asserts it was set, and
:func:`destroy_global_variables` clears them all. :func:`set_args` sets
the args alone (what ``run_bert`` and ``run_gpt`` read when called
without args). The writer is ``torch.utils.tensorboard``'s, made on the
last rank when ``--tensorboard-dir`` is given and the ``tensorboard``
package is importable (None otherwise, as the reference skips it).
"""

from apex_tpu_torch.parallel.pipeline.microbatches import (
    build_num_microbatches_calculator,
)
from apex_tpu_torch.utils.timers import Timers

__all__ = ["destroy_global_variables", "get_adlr_autoresume", "get_args",
           "get_current_global_batch_size", "get_num_microbatches",
           "get_tensorboard_writer", "get_timers", "set_args",
           "set_global_variables", "update_num_microbatches"]

_GLOBAL_ARGS = None
_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TENSORBOARD_WRITER = None
_GLOBAL_ADLR_AUTORESUME = None
_GLOBAL_TIMERS = None


def get_args():
    """The args set by :func:`set_global_variables` or :func:`set_args`."""
    _ensure_var_is_initialized(_GLOBAL_ARGS, "args")
    return _GLOBAL_ARGS


def set_args(args) -> None:
    """Sets the process-global args alone (None clears them)."""
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args


def get_num_microbatches() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get()


def get_current_global_batch_size() -> int:
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR.get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int, *,
                            consistency_check: bool = True) -> None:
    """The number of microbatches after ``consumed_samples`` (no effect
    unless ``--rampup-batch-size`` is set; ref global_vars.py:48-60)."""
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR.update(consumed_samples,
                                               consistency_check)


def get_tensorboard_writer():
    """The writer, or None; no initialization check (ref :69)."""
    return _GLOBAL_TENSORBOARD_WRITER


def get_adlr_autoresume():
    """None (the reference's ADLR hook is not built); no initialization
    check (ref :75)."""
    return _GLOBAL_ADLR_AUTORESUME


def get_timers():
    _ensure_var_is_initialized(_GLOBAL_TIMERS, "timers")
    return _GLOBAL_TIMERS


def set_global_variables(extra_args_provider=None, args_defaults={},
                         override_args={}, ignore_unknown_args=False,
                         args=None):
    """Parses the args and sets them, the microbatch calculator, the
    tensorboard writer and the timers; returns the args."""
    from apex_tpu_torch.transformer.testing.arguments import parse_args

    global _GLOBAL_ARGS
    _ensure_var_is_not_initialized(_GLOBAL_ARGS, "args")
    parsed = _GLOBAL_ARGS = parse_args(
        extra_args_provider=extra_args_provider, defaults=args_defaults,
        override_args=override_args,
        ignore_unknown_args=ignore_unknown_args, args=args)
    _build_num_microbatches_calculator(parsed)
    _set_tensorboard_writer(parsed)
    _set_timers()
    return parsed


def destroy_global_variables() -> None:
    """Resets every global (the writer closed), so a process may set them
    again."""
    global _GLOBAL_ARGS, _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    global _GLOBAL_TENSORBOARD_WRITER, _GLOBAL_ADLR_AUTORESUME, _GLOBAL_TIMERS
    if _GLOBAL_TENSORBOARD_WRITER is not None:
        _GLOBAL_TENSORBOARD_WRITER.close()
    _GLOBAL_ARGS = None
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
    _GLOBAL_TENSORBOARD_WRITER = None
    _GLOBAL_ADLR_AUTORESUME = None
    _GLOBAL_TIMERS = None


def _build_num_microbatches_calculator(args) -> None:
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _ensure_var_is_not_initialized(_GLOBAL_NUM_MICROBATCHES_CALCULATOR,
                                   "num microbatches calculator")
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        rank=args.rank, rampup_batch_size=args.rampup_batch_size,
        global_batch_size=args.global_batch_size,
        micro_batch_size=args.micro_batch_size,
        data_parallel_size=args.data_parallel_size)


def _set_tensorboard_writer(args) -> None:
    global _GLOBAL_TENSORBOARD_WRITER
    _ensure_var_is_not_initialized(_GLOBAL_TENSORBOARD_WRITER,
                                   "tensorboard writer")
    if getattr(args, "tensorboard_dir", None) and \
            args.rank == args.world_size - 1:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # torch without the tensorboard package
            return  # the reference prints "no tensorboard, skipping"
        _GLOBAL_TENSORBOARD_WRITER = SummaryWriter(
            log_dir=args.tensorboard_dir,
            max_queue=args.tensorboard_queue_size)


def _set_timers() -> None:
    global _GLOBAL_TIMERS
    _ensure_var_is_not_initialized(_GLOBAL_TIMERS, "timers")
    _GLOBAL_TIMERS = Timers()


def _ensure_var_is_initialized(var, name):
    assert var is not None, f"{name} is not initialized."


def _ensure_var_is_not_initialized(var, name):
    assert var is None, f"{name} is already initialized."
