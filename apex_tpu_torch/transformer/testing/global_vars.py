"""The process-global args (counterpart of the args part of
apex_tpu/transformer/testing/global_vars.py): what ``run_bert`` reads
when it is called without args."""

__all__ = ["get_args", "set_args"]

_GLOBAL_ARGS = None


def get_args():
    """The args set by :func:`set_args`."""
    assert _GLOBAL_ARGS is not None, "args is not initialized."
    return _GLOBAL_ARGS


def set_args(args) -> None:
    """Sets the process-global args (None clears them)."""
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args
