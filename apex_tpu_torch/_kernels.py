"""Build, load and launch the hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` exposes a plain C function that launches
its kernel on the stream it is given and returns the launch's
``cudaError_t``. It is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library under ``build/apex_tpu_torch/`` at the repository root,
named by a hash of the source, every shared header ``csrc/*.cuh`` (the
sources include them from ``csrc/``) and the flags, so an edited source
or header is rebuilt and an unchanged one is reused. The build runs at
the first launch (or at :func:`build_all`, which starts one ``nvcc`` per
source in parallel); nothing here touches CUDA when the module is
imported.

Every launch goes through :class:`Kernel`, which raises on a nonzero
``cudaError_t`` and counts the launch in ``Kernel.launches``, a plain
integer: a run reads the counts to show that its path went through the
kernels.

The device rule that replaces the JAX package's ``impl=`` switch
(``ops/_dispatch.py``) also lives here: a CUDA tensor goes to the
kernel or raises, a CPU tensor takes the plain PyTorch version.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

__all__ = [
    "ADAM", "FLASH_BWD_DKV", "FLASH_BWD_DQ", "FLASH_FWD", "KERNELS",
    "LAYER_NORM_BWD", "LAYER_NORM_BWD_LOOP", "LAYER_NORM_FWD",
    "NORM_FWD_LOOP", "RMS_NORM_BWD", "RMS_NORM_FWD", "SUMSQ_FLAT", "Kernel",
    "build_all", "dtype_code", "launch_counts", "reset_launch_counts",
    "resolve_device", "wants_grad",
]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "build" / "apex_tpu_torch"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for and there is none, so a
    CPU-only host never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: apex_tpu_torch runs on the GPU by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def wants_grad(*tensors) -> bool:
    """Does a call on these tensors (None allowed) record a gradient? The
    ops take their autograd Function, whose backward is a kernel, only
    then; under ``torch.no_grad()`` they launch the forward kernel alone."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code for ``t``; raises for a dtype they lack."""
    code = _DTYPES.get(t.dtype)
    if code is None:
        raise TypeError(
            f"the CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return code


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {path})")
    return path


def _library_path(source: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{source}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"lib{source}-{h.hexdigest()[:16]}.so"


def _start_build(source: str) -> Optional[subprocess.Popen]:
    """Starts nvcc for ``source`` unless its library is built already."""
    out = _library_path(source)
    if out.exists():
        return None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.out, proc.tmp = out, tmp  # type: ignore[attr-defined]
    return proc


def _finish_build(proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(proc.tmp, proc.out)  # type: ignore[attr-defined]


class Kernel:
    """One C entry point of a kernel library, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            path = _library_path(self.source)
            if not path.exists():
                proc = _start_build(self.source)
                if proc is not None:
                    _finish_build(proc)
            fn = getattr(ctypes.CDLL(str(path)), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        """Launches on the current stream; ``args`` exclude the stream."""
        fn = self._load()
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed with cudaError_t {err}")
        self.launches += 1


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong

LAYER_NORM_FWD = Kernel(
    "layer_norm", "layer_norm_fwd",
    # x, w, b, y, rows, hidden, eps, dtype, stream
    [_P, _P, _P, _P, _I, _I, _F, _I, _P],
)
FLASH_FWD = Kernel(
    "flash_attention", "flash_fwd",
    # q, k, v, kpm, o, lse, bh, sq, sk, d, heads, group, splits, scale,
    # causal, window, dtype, stream
    [_P] * 6 + [_I] * 7 + [_F, _I, _I, _I, _P],
)
LAYER_NORM_BWD = Kernel(
    "layer_norm", "layer_norm_bwd",
    # x, w, dy, dx, part, out, rows, hidden, part_blocks, eps, dtype, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
)
FLASH_BWD_DQ = Kernel(
    "flash_attention_bwd", "flash_bwd_dq",
    # q, k, v, do, lse, delta, kpm, dq, bh, sq, sk, d, heads, group, scale,
    # causal, window, dtype, stream
    [_P] * 8 + [_I] * 6 + [_F, _I, _I, _I, _P],
)
FLASH_BWD_DKV = Kernel(
    "flash_attention_bwd", "flash_bwd_dkv",
    # q, k, v, do, lse, delta, kpm, dk, dv, work, bh, sq, sk, d, heads,
    # group, splits, scale, causal, window, dtype, stream
    [_P] * 10 + [_I] * 7 + [_F, _I, _I, _I, _P],
)
ADAM = Kernel(
    "adam", "adam_update",
    # g, p, m, v, bc1, bc2, upd, m_out, v_out, n, -lr, beta1, 1 - beta1,
    # beta2, 1 - beta2, eps, weight_decay, adam_w, stream
    [_P] * 9 + [_L] + [_F] * 7 + [_I, _P],
)
RMS_NORM_FWD = Kernel(
    "layer_norm", "rms_norm_fwd",
    # x, w, y, rows, hidden, eps, dtype, stream
    [_P, _P, _P, _I, _I, _F, _I, _P],
)
RMS_NORM_BWD = Kernel(
    "layer_norm", "rms_norm_bwd",
    # x, w, dy, dx, part, out, rows, hidden, part_blocks, eps, dtype, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
)
SUMSQ_FLAT = Kernel(
    "l2norm", "sumsq_flat",
    # x, n, part, part_blocks, out, stream
    [_P, _L, _P, _I, _P, _P],
)
# The norms' loop kernels on any input (not a path's kernels: the card
# checks and timings compare the register-resident rows with them).
NORM_FWD_LOOP = Kernel(
    "layer_norm", "norm_fwd_loop",
    # x, w, b, y, rows, hidden, eps, rms, dtype, stream
    [_P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
)
LAYER_NORM_BWD_LOOP = Kernel(
    "layer_norm", "layer_norm_bwd_loop", LAYER_NORM_BWD.argtypes)
KERNELS: Dict[str, Kernel] = {
    k.symbol: k for k in (LAYER_NORM_FWD, LAYER_NORM_BWD, RMS_NORM_FWD,
                          RMS_NORM_BWD, FLASH_FWD, FLASH_BWD_DQ,
                          FLASH_BWD_DKV, ADAM, SUMSQ_FLAT)
}


def build_all() -> float:
    """Builds every kernel library (one nvcc per source, all at once)
    and loads it; returns the seconds it took."""
    t0 = time.perf_counter()
    procs = [p for p in (_start_build(s) for s in
                         sorted({k.source for k in KERNELS.values()}))
             if p is not None]
    errors = []
    for p in procs:  # wait for every nvcc, even after one has failed
        try:
            _finish_build(p)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS.values():
        k._load()
    return time.perf_counter() - t0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
