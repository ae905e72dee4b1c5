"""Analytic HBM ledger: closed-form per-device peak-memory prediction
(counterpart of apex_tpu/monitor/xray/hbm/model.py, copied as it is
there: pure arithmetic, no torch, the JAX package's values on the same
inputs).

It predicts, from a (model config, parallelism, optimizer, schedule)
tuple and without running anything, how many bytes of device memory a
training step or a serving pool pins. The prediction is a
:class:`HbmBreakdown`, a tuple of named :class:`Component` rows whose byte
sum IS the predicted peak (no "misc" slack term). Components are either
*resident* (pinned across steps: weights, optimizer state) or
*transient* (live only inside a step: grads, activation stash,
compression send buffers).

The layout conventions are the JAX package's, and they are the port's
too: ``gpt_param_elements`` is the element count of the port's
``GPTModel`` (flax ``(in, out)`` kernels, vocab-sharded embeddings under
tp), and ``kv_pool_bytes`` the bytes of the serving engine's
``k_pool`` and ``v_pool``. The activation stash models XLA's buffers
under a remat policy (``"full"`` by default); an eager PyTorch step
without recompute keeps what autograd saves, so its measured peak is
read beside the prediction, not forced onto it. ``dtype_bytes`` takes
torch dtypes as well as names.
"""

import dataclasses
import json
import math
from typing import Dict, Mapping, Optional, Tuple

__all__ = [
    "DTYPE_BYTES",
    "ZERO_FLAT_CHUNK",
    "Component",
    "HbmBreakdown",
    "TransformerDims",
    "StashDepth",
    "STASH_SCHEDULES",
    "FitVerdict",
    "dtype_bytes",
    "gpt_param_elements",
    "adam_state_bytes",
    "zero_padded_total",
    "zero_shard_elements",
    "distributed_adam_state_bytes",
    "stash_depth",
    "activation_stash_bytes",
    "kv_pool_bytes",
    "predict_train_memory",
    "predict_serving_memory",
    "predict_fits",
]

#: bytes per element for every dtype name the ledger accepts (numpy/torch
#: and HLO spellings both)
DTYPE_BYTES: Dict[str, int] = {
    "float64": 8, "f64": 8, "int64": 8, "s64": 8, "uint64": 8, "u64": 8,
    "float32": 4, "f32": 4, "int32": 4, "s32": 4, "uint32": 4, "u32": 4,
    "bfloat16": 2, "bf16": 2, "float16": 2, "f16": 2,
    "int16": 2, "s16": 2, "uint16": 2, "u16": 2,
    "int8": 1, "s8": 1, "uint8": 1, "u8": 1, "bool": 1, "pred": 1,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

#: ``ops/multi_tensor.CHUNK_SIZE`` — the flat-buffer padding quantum the
#: ZeRO optimizer state inherits. Mirrored here (not imported) so the
#: ledger stays pure arithmetic; a test asserts the two agree.
ZERO_FLAT_CHUNK = 2048 * 32


def _dtype_name(dtype) -> str:
    """The ledger's name of a dtype given by name or as a torch dtype
    (``torch.float32`` -> ``"float32"``), so records read the same."""
    name = getattr(dtype, "name", None) or str(dtype)
    return name[len("torch."):] if name.startswith("torch.") else name


def dtype_bytes(dtype) -> int:
    """Bytes per element for a dtype given by name, or a torch dtype (or
    anything whose ``str()``/``.name`` is a known name)."""
    name = _dtype_name(dtype)
    try:
        return DTYPE_BYTES[name]
    except KeyError:
        raise ValueError(
            f"unknown dtype {name!r} — the ledger only books dtypes it "
            f"can size exactly (have {sorted(DTYPE_BYTES)})"
        ) from None


@dataclasses.dataclass(frozen=True)
class Component:
    """One row of the breakdown: a named byte count.

    ``transient`` marks bytes that live only inside a step (grads,
    activation stash, send buffers) — XLA books them as temps, so the
    differ holds them to a band instead of an exact match. ``detail``
    is a human string explaining the arithmetic (shown by
    :meth:`HbmBreakdown.format`).
    """

    name: str
    bytes: int
    transient: bool = False
    detail: str = ""

    def __post_init__(self):
        if self.bytes < 0:
            raise ValueError(f"component {self.name!r} has negative bytes")

    def to_dict(self) -> dict:
        return {
            "name": self.name, "bytes": int(self.bytes),
            "transient": bool(self.transient), "detail": self.detail,
        }


@dataclasses.dataclass(frozen=True)
class HbmBreakdown:
    """A per-device peak prediction as its component partition.

    ``peak_bytes`` is DEFINED as the component sum — the partition
    identity. Serialization keeps every count an exact int so the
    identity survives a json round trip ``==``-for-``==``.
    """

    components: Tuple[Component, ...]
    label: str = ""
    capacity_bytes: Optional[int] = None

    def __post_init__(self):
        names = [c.name for c in self.components]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate component names in {names}")

    @property
    def peak_bytes(self) -> int:
        return sum(c.bytes for c in self.components)

    @property
    def resident_bytes(self) -> int:
        return sum(c.bytes for c in self.components if not c.transient)

    @property
    def transient_bytes(self) -> int:
        return sum(c.bytes for c in self.components if c.transient)

    def component(self, name: str) -> Optional[Component]:
        for c in self.components:
            if c.name == name:
                return c
        return None

    def component_bytes(self, name: str) -> int:
        c = self.component(name)
        return 0 if c is None else c.bytes

    def headroom_bytes(self) -> Optional[int]:
        if self.capacity_bytes is None:
            return None
        return self.capacity_bytes - self.peak_bytes

    def with_components(self, *extra: Component) -> "HbmBreakdown":
        return dataclasses.replace(
            self, components=self.components + tuple(extra)
        )

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "capacity_bytes": self.capacity_bytes,
            "peak_bytes": int(self.peak_bytes),
            "components": [c.to_dict() for c in self.components],
        }

    @classmethod
    def from_dict(cls, d: Mapping) -> "HbmBreakdown":
        comps = tuple(
            Component(
                name=c["name"], bytes=int(c["bytes"]),
                transient=bool(c.get("transient", False)),
                detail=c.get("detail", ""),
            )
            for c in d.get("components", ())
        )
        out = cls(
            components=comps, label=d.get("label", ""),
            capacity_bytes=d.get("capacity_bytes"),
        )
        declared = d.get("peak_bytes")
        if declared is not None and int(declared) != out.peak_bytes:
            raise ValueError(
                f"breakdown {out.label!r} violates the partition identity: "
                f"declared peak {declared} != component sum {out.peak_bytes}"
            )
        return out

    def round_trip(self) -> "HbmBreakdown":
        """json dumps->loads->from_dict; the identity pin's transport."""
        return self.from_dict(json.loads(json.dumps(self.to_dict())))

    def format(self) -> str:
        width = max([len(c.name) for c in self.components] + [9])
        lines = [f"HBM ledger {self.label or '(unlabeled)'}:"]
        for c in self.components:
            tag = "transient" if c.transient else "resident "
            lines.append(
                f"  {c.name:<{width}}  {c.bytes / 2**20:10.2f} MiB  {tag}"
                + (f"  {c.detail}" if c.detail else "")
            )
        lines.append(
            f"  {'predicted peak':<{width}}  "
            f"{self.peak_bytes / 2**20:10.2f} MiB"
        )
        if self.capacity_bytes is not None:
            lines.append(
                f"  {'capacity':<{width}}  "
                f"{self.capacity_bytes / 2**20:10.2f} MiB"
            )
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class TransformerDims:
    """The model-geometry subset the ledger needs (duck-typed from the
    repo's ``TransformerConfig`` via :meth:`from_config`)."""

    num_layers: int
    hidden_size: int
    num_attention_heads: int
    vocab_size: int
    max_position_embeddings: int
    ffn_hidden_size: Optional[int] = None  # None -> 4*hidden_size

    @property
    def ffn(self) -> int:
        return (
            4 * self.hidden_size
            if self.ffn_hidden_size is None else self.ffn_hidden_size
        )

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_config(cls, cfg) -> "TransformerDims":
        return cls(
            num_layers=cfg.num_layers,
            hidden_size=cfg.hidden_size,
            num_attention_heads=cfg.num_attention_heads,
            vocab_size=cfg.vocab_size,
            max_position_embeddings=cfg.max_position_embeddings,
            ffn_hidden_size=getattr(cfg, "ffn_hidden_size", None),
        )


def _exact_div(n: int, d: int, what: str) -> int:
    if n % d:
        raise ValueError(f"{what}: {n} is not divisible by {d}")
    return n // d


def gpt_param_elements(dims: TransformerDims, tp: int = 1) -> int:
    """Per-device parameter ELEMENT count of ``models/gpt.py`` under
    tensor parallelism ``tp`` — the exact flax tree, leaf for leaf.

    Layout (tested against the port model's ``numel``):
    position embeddings ``(P, h)`` replicated; vocab-parallel word
    embeddings ``(V/tp, h)``; final layernorm scale+bias; per layer two
    layernorms (scale+bias each), column-parallel QKV ``(h, 3h/tp)`` +
    bias ``3h/tp``, row-parallel attention output ``(h/tp, h)`` + full
    bias ``h``, column-parallel ``(h, ffn/tp)`` + bias ``ffn/tp``,
    row-parallel ``(ffn/tp, h)`` + full bias ``h``.
    """
    h = dims.hidden_size
    qkv = 3 * h
    tp_qkv = _exact_div(qkv, tp, "qkv out dim / tp")
    tp_h = _exact_div(h, tp, "hidden / tp")
    tp_ffn = _exact_div(dims.ffn, tp, "ffn / tp")
    vocab_shard = _exact_div(dims.vocab_size, tp, "vocab / tp")
    per_layer = (
        2 * h            # input layernorm scale + bias
        + h * tp_qkv + tp_qkv   # column-parallel QKV kernel + bias
        + tp_h * h + h          # row-parallel attn output kernel + full bias
        + 2 * h          # post-attention layernorm
        + h * tp_ffn + tp_ffn   # column-parallel h->ffn kernel + bias
        + tp_ffn * h + h        # row-parallel ffn->h kernel + full bias
    )
    return (
        dims.max_position_embeddings * h   # position embeddings (replicated)
        + vocab_shard * h                  # vocab-parallel word embeddings
        + 2 * h                            # final layernorm
        + dims.num_layers * per_layer
    )


def adam_state_bytes(param_elements: int) -> int:
    """``fused_adam`` state: fp32 ``exp_avg`` + ``exp_avg_sq`` mirroring
    the param tree, plus the int32 step scalar."""
    return 2 * 4 * param_elements + 4


def zero_padded_total(total_elements: int, axis_size: int,
                      chunk: int = ZERO_FLAT_CHUNK) -> int:
    """The ZeRO flat-buffer length for ``total_elements`` params:
    ``flatten_pytree`` pads to a ``chunk`` multiple (minimum one chunk),
    then ``_padded_flatten`` rounds up to a multiple of ``axis_size``."""
    if total_elements < 0 or axis_size < 1:
        raise ValueError(
            f"need total_elements >= 0 and axis_size >= 1, got "
            f"{total_elements}, {axis_size}"
        )
    chunked = max(chunk, ((total_elements + chunk - 1) // chunk) * chunk)
    return ((chunked + axis_size - 1) // axis_size) * axis_size


def zero_shard_elements(total_elements: int, axis_size: int,
                        chunk: int = ZERO_FLAT_CHUNK) -> int:
    """One rank's slice of the padded ZeRO flat buffer."""
    return zero_padded_total(total_elements, axis_size, chunk) // axis_size


def distributed_adam_state_bytes(
    total_elements: int,
    axis_size: int,
    store_param_remainders: bool = False,
    error_feedback: bool = False,
    chunk: int = ZERO_FLAT_CHUNK,
) -> int:
    """Per-rank ``distributed_fused_adam`` state bytes.

    master shard (fp32, or uint16 remainders when
    ``store_param_remainders`` — the bf16 param carries the high half)
    + two fp32 moment shards + the int32 step scalar + the
    error-feedback residual (a whole padded flat buffer's shard under
    compression EF, a zero-byte-ish fp32 scalar otherwise).
    """
    shard = zero_shard_elements(total_elements, axis_size, chunk)
    master = shard * (2 if store_param_remainders else 4)
    moments = 2 * shard * 4
    ef = shard * 4 if error_feedback else 4
    return 4 + master + moments + ef


@dataclasses.dataclass(frozen=True)
class StashDepth:
    """How many microbatch stashes a stage holds at once, per schedule.

    ``activation_depth`` counts forward stashes awaiting their backward
    (B) pass; ``w_depth`` counts zero-bubble's deferred weight-grad (W)
    input stashes — the extra memory that schedule pays for its zero
    bubble. Derived from ``pipeline/algebra.schedule_cost``:

    - ``no_pipelining``: grad accumulation frees each microbatch's
      stash after its fused backward -> depth 1, no W stash.
    - ``1f1b`` (compiled two-scan formulation): the forward scan
      completes before the reversed backward scan starts, so all M
      stashes are live at the scan boundary -> depth M.
    - ``interleaved``: M stashes per model chunk -> M*V.
    - ``zero_bubble``: the B scan consumes the M forward stashes like
      1f1b, but each B tick emits a deferred-W input that survives
      until its bubble-slot/filler tick; the worst-placed stage (all
      bubbles before its B window) still holds every one of the M
      W-stashes when its B scan ends -> w_depth M.
    """

    schedule: str
    activation_depth: int
    w_depth: int

    @property
    def total_depth(self) -> int:
        return self.activation_depth + self.w_depth


#: schedules the stash model covers — must stay equal to
#: ``parallel/pipeline/algebra.SCHEDULES`` (tested; the geometry rules
#: below mirror ``schedule_cost``'s validation rather than importing it,
#: so the feasibility oracle stays pure arithmetic)
STASH_SCHEDULES = ("no_pipelining", "1f1b", "interleaved", "zero_bubble")


def stash_depth(schedule: str, num_stages: int, num_microbatches: int,
                num_model_chunks: int = 1) -> StashDepth:
    """Stash depths for a registered schedule; validates the (P, M, V)
    geometry with the same rules as ``pipeline/algebra.schedule_cost``
    (agreement is pin-tested against the algebra module)."""
    p, m, v = num_stages, num_microbatches, num_model_chunks
    if schedule not in STASH_SCHEDULES:
        raise ValueError(
            f"no stash model for schedule {schedule!r} "
            f"(have {STASH_SCHEDULES})"
        )
    if p < 1 or m < 1 or v < 1:
        raise ValueError(
            f"need num_stages/num_microbatches/num_model_chunks >= 1, "
            f"got ({p}, {m}, {v})"
        )
    if schedule == "interleaved":
        if v < 2:
            raise ValueError(
                f"interleaved needs num_model_chunks >= 2, got {v}"
            )
        if m % p:
            raise ValueError(
                f"interleaved needs num_microbatches ({m}) divisible by "
                f"num_stages ({p})"
            )
    if schedule == "no_pipelining":
        return StashDepth(schedule, 1, 0)
    if schedule == "1f1b":
        return StashDepth(schedule, m, 0)
    if schedule == "interleaved":
        return StashDepth(schedule, m * v, 0)
    return StashDepth(schedule, m, m)


#: stashed floats per token per LAYER under each remat policy: "full"
#: keeps only the layer input (everything else recomputed), "selective"
#: adds the attention output (flash-style: scores recomputed, context
#: kept), "none" keeps the classic residual-stream intermediates
#: (ln1 out, qkv, attn context, attn out, ln2 out, ffn hidden ~ 4h,
#: ffn out) ~ 10 stream-widths per token.
REMAT_STASH_FLOATS_PER_TOKEN: Dict[str, int] = {
    "full": 1,
    "selective": 2,
    "none": 10,
}


def activation_stash_bytes(
    dims: TransformerDims,
    microbatch_tokens: int,
    *,
    layers_per_stage: Optional[int] = None,
    remat: str = "full",
    compute_dtype: str = "bfloat16",
    schedule: str = "no_pipelining",
    num_stages: int = 1,
    num_microbatches: int = 1,
    num_model_chunks: int = 1,
) -> int:
    """Peak per-device activation-stash bytes: per-microbatch stash
    (layers * remat coefficient * tokens * hidden * dtype) times the
    schedule's stash depth."""
    try:
        coeff = REMAT_STASH_FLOATS_PER_TOKEN[remat]
    except KeyError:
        raise ValueError(
            f"unknown remat policy {remat!r} "
            f"(have {sorted(REMAT_STASH_FLOATS_PER_TOKEN)})"
        ) from None
    layers = (
        dims.num_layers if layers_per_stage is None else layers_per_stage
    )
    depth = stash_depth(
        schedule, num_stages, num_microbatches, num_model_chunks
    )
    per_mb = (
        layers * coeff * microbatch_tokens * dims.hidden_size
        * dtype_bytes(compute_dtype)
    )
    return per_mb * depth.total_depth


def kv_pool_bytes(
    *,
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    num_blocks: int,
    block_size: int,
    cache_dtype: str = "bfloat16",
) -> int:
    """The serving block pool: one ``(num_blocks, h_kv, block_size,
    head_dim)`` array per cached K and per cached V leaf, one K/V pair
    per layer (``CacheSpec.pool_shapes``)."""
    per_leaf = num_blocks * num_kv_heads * block_size * head_dim
    return 2 * num_layers * per_leaf * dtype_bytes(cache_dtype)


def predict_train_memory(
    dims: TransformerDims,
    *,
    tp: int = 1,
    params_dtype: str = "float32",
    compute_dtype: str = "bfloat16",
    grads_dtype: Optional[str] = None,
    microbatch_size: int = 1,
    seq_len: int,
    token_dtype: str = "int32",
    optimizer: str = "fused_adam",
    zero_axis_size: Optional[int] = None,
    store_param_remainders: bool = False,
    error_feedback: bool = False,
    grad_scaler: bool = False,
    remat: str = "full",
    schedule: str = "no_pipelining",
    num_stages: int = 1,
    num_microbatches: int = 1,
    num_model_chunks: int = 1,
    layers_per_stage: Optional[int] = None,
    compression_wire_dtype: Optional[str] = None,
    label: str = "",
    capacity_bytes: Optional[int] = None,
) -> HbmBreakdown:
    """Per-device training-step breakdown for a GPT-family model.

    ``microbatch_size`` is the PER-DEVICE microbatch; ``seq_len`` the
    sequence length; the data component books tokens+labels at
    ``token_dtype``. ``optimizer`` is ``"fused_adam"`` (replicated
    fp32 moments) or ``"distributed_fused_adam"`` (ZeRO shard over
    ``zero_axis_size`` ranks, padding conventions included).
    ``compression_wire_dtype`` books the quantized reduce-scatter send
    buffer (one flat grad buffer at the wire dtype, plus its fp32
    residual when ``error_feedback``).
    """
    params_dtype, compute_dtype, token_dtype = (
        _dtype_name(d) for d in (params_dtype, compute_dtype, token_dtype))
    if grads_dtype is not None:
        grads_dtype = _dtype_name(grads_dtype)
    if compression_wire_dtype is not None:
        compression_wire_dtype = _dtype_name(compression_wire_dtype)
    p_elems = gpt_param_elements(dims, tp=tp)
    p_bytes = dtype_bytes(params_dtype)
    g_bytes = dtype_bytes(grads_dtype or params_dtype)
    comps = [
        Component(
            "weights", p_elems * p_bytes,
            detail=f"{p_elems} x {params_dtype}",
        ),
        Component(
            "grads", p_elems * g_bytes, transient=True,
            detail=f"{p_elems} x {grads_dtype or params_dtype}",
        ),
    ]
    if optimizer == "fused_adam":
        opt = adam_state_bytes(p_elems)
        opt_detail = "fused_adam: 2 fp32 moments + int32 step"
    elif optimizer == "distributed_fused_adam":
        if not zero_axis_size or zero_axis_size < 1:
            raise ValueError(
                "distributed_fused_adam needs zero_axis_size >= 1"
            )
        opt = distributed_adam_state_bytes(
            p_elems, zero_axis_size,
            store_param_remainders=store_param_remainders,
            error_feedback=error_feedback,
        )
        opt_detail = (
            f"ZeRO shard of {zero_padded_total(p_elems, zero_axis_size)} "
            f"padded elements over {zero_axis_size} ranks"
        )
    else:
        raise ValueError(
            f"no optimizer-state model for {optimizer!r} (have fused_adam, "
            f"distributed_fused_adam)"
        )
    comps.append(Component("optimizer_state", opt, detail=opt_detail))
    if grad_scaler:
        # GradScaler: fp32 scale + 3 int32 trackers
        comps.append(
            Component("scaler_state", 16, detail="GradScaler: 4 scalars")
        )
    tokens = microbatch_size * seq_len
    comps.append(
        Component(
            "batch_data", 2 * tokens * dtype_bytes(token_dtype),
            detail=f"tokens+labels: {microbatch_size}x{seq_len} "
                   f"{token_dtype}",
        )
    )
    act = activation_stash_bytes(
        dims, tokens,
        layers_per_stage=layers_per_stage, remat=remat,
        compute_dtype=compute_dtype, schedule=schedule,
        num_stages=num_stages, num_microbatches=num_microbatches,
        num_model_chunks=num_model_chunks,
    )
    comps.append(
        Component(
            "activation_stash", act, transient=True,
            detail=f"remat={remat}, schedule={schedule}",
        )
    )
    if compression_wire_dtype is not None:
        axis = zero_axis_size or 1
        flat = zero_padded_total(p_elems, axis)
        wire = flat * dtype_bytes(compression_wire_dtype)
        comps.append(
            Component(
                "compression_buffers", wire, transient=True,
                detail=f"flat grad send buffer at "
                       f"{compression_wire_dtype}",
            )
        )
    return HbmBreakdown(
        components=tuple(comps), label=label,
        capacity_bytes=capacity_bytes,
    )


def predict_serving_memory(
    *,
    num_layers: int,
    num_kv_heads: int,
    head_dim: int,
    num_blocks: int,
    block_size: int,
    cache_dtype: str = "bfloat16",
    weights_bytes: int = 0,
    label: str = "",
    capacity_bytes: Optional[int] = None,
) -> HbmBreakdown:
    """Serving-side breakdown: the KV block pool plus (optionally) the
    resident weights, for the fleet router's placement math."""
    comps = []
    if weights_bytes:
        comps.append(Component("weights", weights_bytes))
    comps.append(
        Component(
            "kv_pool",
            kv_pool_bytes(
                num_layers=num_layers, num_kv_heads=num_kv_heads,
                head_dim=head_dim, num_blocks=num_blocks,
                block_size=block_size, cache_dtype=cache_dtype,
            ),
            detail=f"{num_blocks} blocks x {block_size} tokens x "
                   f"{num_layers} layers",
        )
    )
    return HbmBreakdown(
        components=tuple(comps), label=label,
        capacity_bytes=capacity_bytes,
    )


@dataclasses.dataclass(frozen=True)
class FitVerdict:
    """:func:`predict_fits` answer: does the predicted peak fit under
    the capacity with the required free fraction to spare?"""

    fits: bool
    peak_bytes: int
    capacity_bytes: int
    headroom_bytes: int
    utilization: float
    headroom_fraction: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def predict_fits(
    breakdown: HbmBreakdown,
    capacity_bytes: int,
    headroom_fraction: float = 0.0,
) -> FitVerdict:
    """The feasibility oracle for the config matrix / tuner (ROADMAP
    items 1-2): ``fits`` iff the predicted peak leaves at least
    ``headroom_fraction`` of ``capacity_bytes`` free. Pure arithmetic —
    safe to call for thousands of virtual configs without a device."""
    if capacity_bytes <= 0:
        raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
    if not (0.0 <= headroom_fraction < 1.0):
        raise ValueError(
            f"headroom_fraction must be in [0, 1), got {headroom_fraction}"
        )
    peak = breakdown.peak_bytes
    budget = math.floor(capacity_bytes * (1.0 - headroom_fraction))
    return FitVerdict(
        fits=peak <= budget,
        peak_bytes=peak,
        capacity_bytes=int(capacity_bytes),
        headroom_bytes=int(capacity_bytes) - peak,
        utilization=peak / capacity_bytes,
        headroom_fraction=headroom_fraction,
    )
