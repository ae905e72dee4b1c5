"""Quantized gradient collectives with error feedback (counterpart of
apex_tpu/parallel/compress.py, after EQuARX, arXiv:2506.17615).

An all-reduce over ``n`` ranks runs as two quantized phases:

    phase 1 (reduce-scatter): split the local array into n chunks,
        block-quantize each chunk, ``all_to_all`` the payload and the
        per-block fp32 scales, dequantize and sum the n rows locally in
        rank order, so each rank holds the fp32 sum of its chunk;
    phase 2 (all-gather): re-quantize the reduced chunk, ``all_gather``
        payload and scales, dequantize each rank's chunk with its own
        scales.

Every exchange goes through ``parallel_state.all_to_all`` and
``all_gather`` on the wire arrays themselves (the payload in its wire
dtype and the fp32 scales), so under gloo with CUDA tensors every byte
shows in ``parallel_state.STAGED``. The fp8 payload crosses as a
``uint8`` view of its bits: gloo has no float8 type, and a bit view
moves the same bytes.

Error feedback: each caller that iterates (the DDP gradient sync, the
ZeRO optimizers) carries a residual; the local quantization error is
added to the next step's gradient before quantizing (``acc = g + e``,
``e' = acc - dequant(quant(acc))``), so the sum of the transmitted
updates plus the last residual is the sum of the true gradients.
Residuals of non-finite elements are reset to zero.

Non-finite blocks: a block holding NaN or Inf gets a NaN scale and a zero
payload, so every element of it dequantizes to NaN on every rank and the
grad scaler's ``found_inf`` fires as on the exact path. The found_inf
consensus itself is never compressed.

The quotient is ``x / scale``, a division, as JAX writes it (a multiply
by the reciprocal rounds otherwise and gives other codes); ``round``
rounds half to even on both sides. Leaves under ``min_elements`` take the
exact all-reduce.

``group`` is a ``torch.distributed`` process group (``parallel_state``'s
``get_group("dp")`` for the data-parallel axis); with None (no group)
each function is the identity of a world of one, as the exact helpers of
``parallel_state`` are.
"""

import dataclasses
import math
from typing import Dict, Tuple

import torch

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = [
    "CompressionConfig", "dequantize_blockwise", "ef_init", "ef_update",
    "predicted_psum_wire_bytes", "quantize_blockwise",
    "quantized_all_gather", "quantized_psum", "quantized_psum_scatter",
]

# wire dtype and the largest code: e4m3's largest finite magnitude is
# 448, and the scale maps a block's amax to half of it, so rounding near
# the amax cannot overflow
_WIRE_DTYPES = {"int8": (torch.int8, 127.0),
                "fp8": (torch.float8_e4m3fn, 224.0)}


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """How a gradient collective travels the wire (the JAX fields and
    defaults): ``dtype`` "int8" (block-scaled symmetric int8) or "fp8"
    (e4m3 payload); ``block_size`` elements per fp32 scale;
    ``error_feedback``, whether callers carry the residual; and
    ``min_elements``, below which a leaf takes the exact all-reduce."""

    dtype: str = "int8"
    block_size: int = 128
    error_feedback: bool = True
    min_elements: int = 16

    def __post_init__(self):
        if self.dtype not in _WIRE_DTYPES:
            raise ValueError(f"compression dtype {self.dtype!r} is not one "
                             f"of {sorted(_WIRE_DTYPES)}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got "
                             f"{self.block_size}")

    @property
    def wire_dtype(self) -> torch.dtype:
        return _WIRE_DTYPES[self.dtype][0]

    @property
    def qmax(self) -> float:
        return _WIRE_DTYPES[self.dtype][1]


def _num_blocks(n: int, block_size: int) -> int:
    return max(1, -(-n // block_size))


def _quantize_rows(rows: torch.Tensor, config: CompressionConfig):
    """Row-wise :func:`quantize_blockwise` of a (r, n) fp32 tensor: each
    row padded with zeros to whole blocks on its own, as JAX's ``vmap``
    of the 1-D function does. Returns ((r, n) payload, (r, nb) scales)."""
    bs, qmax = config.block_size, config.qmax
    r, n = rows.shape
    nb = _num_blocks(n, bs)
    xp = torch.nn.functional.pad(rows, (0, nb * bs - n)).reshape(r, nb, bs)
    amax = xp.abs().amax(dim=2)  # NaN propagates
    one = torch.ones((), dtype=torch.float32, device=rows.device)
    # divide by a tensor on amax's device: CUDA turns a division by a
    # host scalar into a multiply by its reciprocal, one ulp off the true
    # quotient the CPU (and JAX) compute
    scales = torch.where(amax > 0, amax / torch.full_like(amax, qmax), one)
    # a NaN amax fails the > 0 test and would take scale 1.0: any
    # non-finite block gets a NaN scale instead
    scales = torch.where(torch.isfinite(amax), scales,
                         torch.full_like(scales, math.nan))
    q = xp / scales[:, :, None]
    if not config.wire_dtype.is_floating_point:
        q = torch.round(q)  # half to even, as jnp.round
    # the float wire keeps the quotient: the cast rounds to nearest
    q = torch.where(torch.isfinite(q), q.clamp(-qmax, qmax),
                    torch.zeros((), dtype=q.dtype, device=q.device))
    payload = q.reshape(r, nb * bs)[:, :n].to(config.wire_dtype)
    return payload, scales


def _dequantize_rows(payload: torch.Tensor, scales: torch.Tensor,
                     config: CompressionConfig) -> torch.Tensor:
    """Row-wise :func:`dequantize_blockwise`: (r, n) fp32."""
    bs = config.block_size
    r, n = payload.shape
    nb = scales.shape[1]
    qp = torch.nn.functional.pad(payload.float(), (0, nb * bs - n))
    out = qp.reshape(r, nb, bs) * scales.float()[:, :, None]
    return out.reshape(r, nb * bs)[:, :n]


def quantize_blockwise(x: torch.Tensor,
                       config: CompressionConfig = CompressionConfig()):
    """``(payload, scales)`` of ``x`` flattened: the payload in the wire
    dtype at ``x``'s length, and one fp32 scale a block of
    ``block_size`` (a ragged last block is padded with zeros, which
    quantize exactly). The error an element is at most half its block's
    scale, ``amax / (2 qmax)``. A block with NaN or Inf gets a NaN scale
    and a zero payload, so it dequantizes to NaN."""
    payload, scales = _quantize_rows(x.reshape(1, -1).float(), config)
    return payload[0], scales[0]


def dequantize_blockwise(payload: torch.Tensor, scales: torch.Tensor,
                         config: CompressionConfig = CompressionConfig()
                         ) -> torch.Tensor:
    """fp32 of ``payload``'s length: each element times its block's
    scale; a NaN scale spreads NaN over its block."""
    return _dequantize_rows(payload[None], scales[None], config)[0]


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The payload as the collective moves it: fp8 as its uint8 bits
    (gloo has no float8 type), int8 as it is."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _unwire(t: torch.Tensor, config: CompressionConfig) -> torch.Tensor:
    return t.view(config.wire_dtype)


def _quantized_reduce_chunks(rows: torch.Tensor, config: CompressionConfig,
                             group):
    """Phase 1 on an (n, chunk) fp32 layout, row j bound for rank j:
    quantize the rows, ``all_to_all`` payload and scales, dequantize and
    sum the n received rows in rank order. Returns (the reduced fp32
    chunk, what this rank's quantizer sent, dequantized, as ``rows``)."""
    payload, scales = _quantize_rows(rows, config)
    # the error-feedback term, computed before the exchange
    transmitted = _dequantize_rows(payload, scales, config)
    p2 = _unwire(ps.all_to_all(_wire(payload), group), config)
    s2 = ps.all_to_all(scales, group)
    deq = _dequantize_rows(p2, s2, config)
    red = deq[0]
    for i in range(1, deq.shape[0]):  # a fixed order
        red = red + deq[i]
    return red, transmitted


def _gather_rows(payload: torch.Tensor, scales: torch.Tensor,
                 config: CompressionConfig, group) -> torch.Tensor:
    """All-gathers one quantized chunk a rank and dequantizes each rank's
    chunk with its own scales (each carries its own ragged last block):
    the flat fp32 concatenation in rank order."""
    n = ps.group_size(group)
    pg = _unwire(ps.all_gather(_wire(payload), group), config)
    sg = ps.all_gather(scales, group)
    return _dequantize_rows(pg.reshape(n, -1), sg.reshape(n, -1),
                            config).reshape(-1)


def quantized_psum(x: torch.Tensor, group,
                   config: CompressionConfig = CompressionConfig(),
                   return_transmitted: bool = False):
    """Block-scaled quantized all-reduce (sum) of ``x`` over ``group``:
    ``psum`` up to two quantization errors (phase 1 on the operands,
    phase 2 on the reduced chunks); integers that are exact multiples of
    their block's scale come through digit for digit. With
    ``return_transmitted`` also returns the fp32 value this rank's
    phase 1 sent (``x``'s shape), the error-feedback subtraction term.
    A leaf under ``min_elements`` takes the exact all-reduce and sends
    itself."""
    n = ps.group_size(group)
    size = x.numel()
    if n <= 1 or size < config.min_elements:
        out = ps.all_reduce(x, group)
        return (out, x.float()) if return_transmitted else out
    flat = x.reshape(-1).float()
    pad = -size % n
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    red, transmitted = _quantized_reduce_chunks(flat.reshape(n, -1), config,
                                                group)
    p3, s3 = quantize_blockwise(red, config)
    gathered = _gather_rows(p3, s3, config, group)
    out = gathered[:size].reshape(x.shape).to(x.dtype)
    if return_transmitted:
        return out, transmitted.reshape(-1)[:size].reshape(x.shape)
    return out


def quantized_psum_scatter(flat: torch.Tensor, group,
                           config: CompressionConfig = CompressionConfig(),
                           return_transmitted: bool = False):
    """Quantized reduce-scatter of a 1-D buffer (phase 1 alone): this
    rank's fp32 chunk of the sum. The length must divide by the group's
    size (the ZeRO flat buffers are padded to it). With
    ``return_transmitted`` also the fp32 value sent, at the input's
    length."""
    n = ps.group_size(group)
    if n <= 1:
        out = ps.reduce_scatter(flat, group)
        return (out, flat.float()) if return_transmitted else out
    size = flat.shape[0]
    if size % n:
        raise ValueError(
            f"quantized_psum_scatter needs length divisible by the axis "
            f"size, got {size} over n={n} (pad the flat buffer first, as "
            f"the ZeRO optimizers do)")
    red, transmitted = _quantized_reduce_chunks(
        flat.reshape(n, -1).float(), config, group)
    if return_transmitted:
        return red, transmitted.reshape(size)
    return red


def quantized_all_gather(shard: torch.Tensor, group,
                         config: CompressionConfig = CompressionConfig()
                         ) -> torch.Tensor:
    """Quantized tiled all-gather of a 1-D shard: quantize, gather
    payload and scales, dequantize each rank's shard with its own scales,
    in ``shard``'s dtype. No error feedback (a gather accumulates
    nothing); the ZeRO parameter gather stays exact."""
    if ps.group_size(group) <= 1:
        return ps.all_gather(shard, group)
    payload, scales = quantize_blockwise(shard, config)
    return _gather_rows(payload, scales, config, group).to(shard.dtype)


def ef_init(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Zero fp32 residuals, one a gradient, by name."""
    return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for n, g in grads.items()}


def ef_update(acc: torch.Tensor, transmitted: torch.Tensor) -> torch.Tensor:
    """A residual after transmission, ``acc - transmitted`` in fp32, reset
    to zero wherever either is non-finite (a poisoned block sends NaN for
    every element it covers; found_inf skips that step, and a NaN
    residual would poison every later one). ``acc`` is the compensated
    gradient ``g + e``."""
    acc, sent = acc.float(), transmitted.float()
    return torch.where(torch.isfinite(acc) & torch.isfinite(sent),
                       acc - sent, torch.zeros((), device=acc.device))


def predicted_psum_wire_bytes(size: int, n: int,
                              config: CompressionConfig = CompressionConfig()
                              ) -> Tuple[int, int]:
    """``(payload_bytes, ici_bytes)`` of one :func:`quantized_psum` of a
    ``size``-element leaf over ``n`` ranks, by the JAX ledger's
    conventions: an all_to_all books its whole input and ``(n - 1) / n``
    of it on the wire, a tiled all_gather the local shard and ``n - 1``
    shards on the wire. Phase 1 sends an (n, chunk) payload and (n, nb)
    scales, phase 2 gathers one chunk and its scales."""
    if n <= 1 or size < config.min_elements:
        nbytes = size * 4
        return nbytes, math.ceil(2 * (n - 1) * nbytes / n) if n > 1 else 0
    item = torch.empty((), dtype=config.wire_dtype).element_size()
    chunk = -(-size // n)
    nb = _num_blocks(chunk, config.block_size)
    p1_payload, p1_scales = n * chunk * item, n * nb * 4
    p2_payload, p2_scales = chunk * item, nb * 4
    payload = p1_payload + p1_scales + p2_payload + p2_scales
    ici = (math.ceil((n - 1) * p1_payload / n)
           + math.ceil((n - 1) * p1_scales / n)
           + (n - 1) * p2_payload + (n - 1) * p2_scales)
    return payload, ici
