"""Continuous batching over the block-allocated KV pool (counterpart of
apex_tpu/serving/engine.py).

The engine runs a tick loop. Each tick admits up to
``max_prefills_per_tick`` queued requests (one prefill each, at the
prompt's own length), then advances every in-flight request by one token
through ONE batched decode step: requests join and leave the batch at
tick granularity. Per-lane state (position, block table, last token,
temperature) lives on the host and is handed to the step as tensors, so
positions diverge freely. The JAX engine ``vmap``s a single-sequence
decode over lanes; here the lanes are the batch dimension.

What the JAX engine needs and this one does not: prefill buckets and the
ahead-of-time compiles of every bucket (PyTorch runs eagerly, and the
flash kernel masks ragged sequence edges itself, so a prompt runs at its
own length). Two contracts of the JAX engine take another form here:

- **Zero steady-state recompiles.** Nothing compiles, but a kernel
  library is built and loaded at its first use. :meth:`start` loads
  every kernel the model's path runs (inside a ``compile`` goodput
  span), and :attr:`steady_state_compiles` counts each kernel loaded
  after it, through the one recompile sentinel of the port
  (``monitor.xray.compile_watch.CompileWatcher`` over
  ``_kernels.library_loads``, as the JAX engine's): 0 in a healthy
  steady state.
- **Donation.** The pool is written in place: ``k_pool`` and ``v_pool``
  keep their storage across ticks and across :meth:`adopt`, and no
  second pool is ever allocated.

Block reservation differs from JAX's: a request reserves
``blocks_needed(prompt + max_new)`` blocks, where the JAX engine
reserves at least its prefill bucket's blocks (``max(blocks_needed(...),
bucket // block_size)``). A 17-token prompt with 1 new token at block
size 8 takes 3 blocks here and 4 there, so under a tight pool admission
order and handoff bytes can differ; the outcomes both engines fix (each
request's tokens, terminal state and reason) do not.

Robustness surface (the JAX engine's):

- **bounded admission queue and load shedding**: ``submit`` never raises
  on client input; it queues the request or rejects it with a booked
  reason (``queue_full``, ``ttft_budget``, ``malformed``, ``too_long``,
  ``draining``);
- **per-request deadlines**, enforced at every tick, in queue and in
  batch;
- **wedged-decode defense**: a ``watchdog=`` with ``.beat(t)`` is beaten
  once per tick, and :meth:`inflight_table` is the forensic table of the
  requests in flight;
- **graceful drain**: :meth:`drain` stops admission, finishes or
  deadline-evicts the in-flight requests within the grace budget and
  books a terminal state for every request;
- **chaos drills**: a :class:`~apex_tpu_torch.resilience.chaos.FaultPlan`
  injects slow-decode ticks and host-loop wedges inside the tick;
- **fleet KV handoff**: :meth:`extract` and :meth:`adopt` move a
  request mid-decode between engines with its KV blocks.

Telemetry: ``kind="request"`` lifecycle records (lifecycle.py), the
``prefill``, ``decode`` and ``drain`` goodput spans, the request x-ray's
``kind="trace"`` spans (the ``trace=`` hook on ``emit_request_record``)
and, every ``memory_interval_ticks``, a ``kind="memory"`` KV-pool record.
"""

import collections
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _kernels
from apex_tpu_torch._kernels import resolve_device
from apex_tpu_torch.models.generate import sample_next_token
from apex_tpu_torch.monitor.goodput.spans import span
from apex_tpu_torch.monitor.xray.hbm.live import kv_pool_fields
from apex_tpu_torch.serving.kvcache import (
    BlockAllocator,
    PagedKV,
    blocks_needed,
)
from apex_tpu_torch.serving.loadgen import percentile
from apex_tpu_torch.serving.lifecycle import (
    ADMITTED,
    CANCELLED,
    COMPLETED,
    DECODE,
    FAILED,
    PREFILL,
    QUEUED,
    REJECTED,
    TIMED_OUT,
    Request,
    emit_request_record,
    transition,
)
from apex_tpu_torch.serving.trace.emit import TraceEmitter

logger = logging.getLogger("apex_tpu_torch.serving")

__all__ = ["ServingConfig", "ServingEngine", "path_kernels"]


def _ema(old: Optional[float], x: float, alpha: float = 0.5) -> float:
    return x if old is None else (1.0 - alpha) * old + alpha * x


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Engine geometry and admission policy.

    ``lanes`` bounds concurrent in-flight decodes; ``num_blocks`` x
    ``block_size`` tokens is the whole KV pool; ``max_seq_len`` caps one
    request's prompt + generation. ``ttft_budget_s`` arms the
    admission-time TTFT estimate: beyond it, submissions are rejected
    with ``ttft_budget`` instead of queueing into a wait they cannot
    meet. ``top_k``/``top_p`` apply to every request; ``temperature`` is
    per request. ``seed`` seeds the engine's sampling generator.
    ``collect_logits`` keeps each request's fp32 next-token logits of
    every step on the host (tests and debugging; a vocab-sized copy a
    lane a tick). ``memory_interval_ticks`` is the cadence of the
    ``kind="memory"`` KV-pool records; None disables them.
    """

    lanes: int = 4
    block_size: int = 16
    num_blocks: int = 64
    max_seq_len: int = 128
    max_queue_depth: int = 16
    ttft_budget_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    max_prefills_per_tick: int = 1
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    collect_logits: bool = False
    memory_interval_ticks: Optional[int] = 50

    def __post_init__(self):
        if self.lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {self.lanes}")
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.max_seq_len % self.block_size:
            raise ValueError(
                f"max_seq_len ({self.max_seq_len}) must divide into "
                f"block_size ({self.block_size}) blocks")
        if self.num_blocks < self.max_seq_len // self.block_size:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) cannot hold even one "
                f"max_seq_len ({self.max_seq_len}) request "
                f"({self.max_seq_len // self.block_size} blocks)")
        if self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.max_prefills_per_tick < 1:
            raise ValueError(
                f"max_prefills_per_tick must be >= 1, got "
                f"{self.max_prefills_per_tick}")
        if (self.memory_interval_ticks is not None
                and self.memory_interval_ticks < 1):
            raise ValueError(
                f"memory_interval_ticks must be >= 1 or None, got "
                f"{self.memory_interval_ticks}")

    @property
    def max_blocks_per_lane(self) -> int:
        return self.max_seq_len // self.block_size


def path_kernels(model) -> Tuple[_kernels.Kernel, ...]:
    """The kernels a serving pass of ``model`` launches on the card: its
    norm's forward and the flash forward (prefill and split-KV decode)."""
    norm = (_kernels.RMS_NORM_FWD
            if model.config.normalization == "rmsnorm"
            else _kernels.LAYER_NORM_FWD)
    return norm, _kernels.FLASH_FWD


class ServingEngine:
    """The tick-loop scheduler (module docstring).

    Drive it::

        eng = ServingEngine(model, ServingConfig(...), router=router,
                            fault_plan=plan, watchdog=dog)   # on cuda
        eng.start()                          # loads the path's kernels
        req = eng.submit(prompt, max_new_tokens=32)   # queued/rejected
        while not eng.idle:
            eng.tick()
        eng.drain(grace_s=...)               # on a termination notice

    ``model`` is a :class:`~apex_tpu_torch.models.GPTModel` on
    ``device`` (CUDA unless the caller names another). ``router``
    receives the request records, the goodput spans, the trace spans and
    the KV-pool records; ``watchdog`` is anything with ``.beat(t)``,
    beaten once per tick; ``fault_plan`` injects the serving faults.
    """

    def __init__(self, model, config: ServingConfig, device="cuda",
                 router=None, fault_plan=None, watchdog=None,
                 time_fn=time.monotonic):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the engine was "
                             f"asked for {self.device}")
        self.model = model
        self.config = config
        self.router = router
        self.fault_plan = fault_plan
        self.watchdog = watchdog
        self.time_fn = time_fn
        #: the request x-ray's span producer; the fleet stamps ``site``
        #: with the replica incarnation so span ids stay unique across
        #: restarts (trace/emit.py)
        self.trace = TraceEmitter(router, time_fn=time_fn)
        mcfg = model.config
        if (mcfg.max_position_embeddings
                and config.max_seq_len > mcfg.max_position_embeddings):
            raise ValueError(
                f"max_seq_len ({config.max_seq_len}) exceeds the model's "
                f"max_position_embeddings ({mcfg.max_position_embeddings})")
        self._vocab = mcfg.vocab_size

        # the pool: one (layers, num_blocks, h_kv, block_size, hd) tensor
        # per side, in the compute dtype the model's cache path writes
        shape = (mcfg.num_layers, config.num_blocks,
                 mcfg.num_query_groups or mcfg.num_attention_heads,
                 config.block_size, mcfg.kv_channels)
        self.k_pool = torch.zeros(shape, dtype=mcfg.compute_dtype,
                                  device=self.device)
        self.v_pool = torch.zeros_like(self.k_pool)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)

        self.allocator = BlockAllocator(config.num_blocks)
        self._queue: "collections.deque[Request]" = collections.deque()
        self._active: Dict[int, Request] = {}
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self._tick = 0
        self._draining = False
        self._drain_report: Optional[dict] = None
        self._started = False
        self._prefill_ema: Optional[float] = None
        self._decode_ema: Optional[float] = None
        self._steady_compiles = 0
        self._compile_watch = None

        B, MB = config.lanes, config.max_blocks_per_lane
        self._tables = np.full((B, MB), config.num_blocks, np.int64)
        self._positions = np.zeros((B,), np.int64)
        self._last_tok = np.zeros((B,), np.int64)
        self._temps = np.zeros((B,), np.float32)

    # -- start: every kernel load of the engine's life happens here --------

    def start(self) -> "ServingEngine":
        """Load every kernel the model's serving path runs (building a
        library that is missing), booked as a ``compile`` goodput span;
        any kernel loaded after this counts in
        :attr:`steady_state_compiles`. On the CPU nothing is loaded."""
        if self._started:
            return self
        with span("compile", router=self.router, step=-1):
            if self.device.type == "cuda":
                for k in path_kernels(self.model):
                    k._load()
        from apex_tpu_torch.monitor.xray.compile_watch import CompileWatcher

        self._compile_watch = CompileWatcher(router=self.router)
        self._started = True
        cfg = self.config
        logger.info("serving engine ready: %d lanes, %d blocks x %d tokens",
                    cfg.lanes, cfg.num_blocks, cfg.block_size)
        return self

    def _ensure_started(self) -> None:
        if not self._started:
            self.start()

    @property
    def steady_state_compiles(self) -> int:
        """Kernels loaded after :meth:`start`, as of the last tick: the
        zero-recompile contract's violation counter."""
        return self._steady_compiles

    def _watch_compiles(self, t: int) -> None:
        rec = self._compile_watch.on_step(t)
        if rec is not None:
            self._steady_compiles += int(rec["compiles"])
            logger.warning("serving steady-state kernel load at tick %d: "
                           "a kernel escaped start()", t)

    def acknowledge_compiles(self) -> None:
        """Re-anchor the compile watcher after a booked external burst:
        the count is process-wide, so a fleet starting a new replica (its
        own ``compile`` span) would otherwise land on every survivor's
        violation counter."""
        if self._compile_watch is not None:
            self._compile_watch.rebaseline()

    # -- admission ----------------------------------------------------------

    def _validate_submission(self, prompt, max_new_tokens, temperature,
                             deadline_s) -> Tuple[
            Optional[np.ndarray], int, float, Optional[float],
            Optional[str], Optional[str]]:
        """(prompt_array, max_new, temperature, deadline_s, reason,
        detail); reason None = valid. On invalid input the parsed fields
        fall back to inert defaults so the rejected Request still
        constructs."""
        def bad(detail, reason="malformed"):
            return None, 1, 0.0, None, reason, detail

        try:
            n_new = int(max_new_tokens)
        except (TypeError, ValueError):
            return bad(f"max_new_tokens {max_new_tokens!r} is not an "
                       f"integer")
        try:
            temp = float(temperature)
        except (TypeError, ValueError):
            return bad(f"temperature {temperature!r} is not a number")
        try:
            ddl = None if deadline_s is None else float(deadline_s)
        except (TypeError, ValueError):
            return bad(f"deadline_s {deadline_s!r} is not a number")
        try:
            arr = np.asarray(prompt)
        except Exception:
            return bad("prompt is not array-like")
        if arr.ndim != 1 or arr.size == 0:
            return bad(f"prompt must be a nonempty 1-d token array, got "
                       f"shape {arr.shape}")
        if not np.issubdtype(arr.dtype, np.integer):
            return bad(f"prompt dtype {arr.dtype} not integer")
        if self._vocab and (arr.min() < 0 or arr.max() >= self._vocab):
            return bad(f"prompt token out of vocab [0, {self._vocab})")
        if n_new < 1:
            return bad(f"max_new_tokens must be >= 1, got {n_new}")
        cfg = self.config
        if arr.size + n_new > cfg.max_seq_len:
            return bad(
                f"prompt ({arr.size}) + max_new_tokens ({n_new}) exceeds "
                f"max_seq_len ({cfg.max_seq_len})", reason="too_long")
        return arr.astype(np.int64), n_new, temp, ddl, None, None

    def estimated_ttft_s(self) -> Optional[float]:
        """Admission-time TTFT estimate for a new submission: queue depth
        x the measured per-admission cost (prefill + one decode tick),
        over the per-tick admission width. None until a prefill has been
        measured."""
        if self._prefill_ema is None:
            return None
        per = self._prefill_ema + (self._decode_ema or 0.0)
        return (len(self._queue) + 1) * per / self.config.max_prefills_per_tick

    def submit(self, prompt, max_new_tokens: int, temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               rid: Optional[int] = None,
               tags: Optional[dict] = None) -> Request:
        """The request is QUEUED, or REJECTED with a reason; this method
        never raises on bad input and never buffers beyond the bounds.

        ``rid`` lets a fleet router supply a fleet-wide request id (the
        stream's closure check keys on ``id``); ``tags`` are merged into
        every record the request emits (replica, attempt, prefix hit).
        """
        self._ensure_started()
        now = self.time_fn()
        if rid is None:
            rid = self._next_rid
            self._next_rid += 1
        else:
            rid = int(rid)
            self._next_rid = max(self._next_rid, rid + 1)
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        arr, n_new, temp, ddl, bad_reason, detail = self._validate_submission(
            prompt, max_new_tokens, temperature, deadline_s)
        req = Request(rid=rid, prompt=arr, max_new_tokens=max(n_new, 1),
                      temperature=temp, deadline_s=ddl, submit_t=now,
                      tags=dict(tags) if tags else {})
        self._requests[rid] = req

        def reject(reason, **extra):
            transition(req, REJECTED, now=now, reason=reason)
            emit_request_record(self.router, self._tick, req,
                                trace=self.trace, **extra)
            logger.warning("request %d rejected (%s)%s", rid, reason,
                           f": {detail}" if detail else "")
            return req

        if self._draining:
            return reject("draining")
        if bad_reason is not None:
            return reject(bad_reason, detail=detail)
        # the TTFT estimate first: a shallow queue over a slow engine is
        # still an unmeetable wait; the depth bound covers the cold
        # window before the EMAs exist
        est = self.estimated_ttft_s()
        if (self.config.ttft_budget_s is not None and est is not None
                and est > self.config.ttft_budget_s):
            return reject("ttft_budget", estimated_ttft_s=est)
        if len(self._queue) >= self.config.max_queue_depth:
            return reject("queue_full")
        transition(req, QUEUED, now=now)
        self._queue.append(req)
        emit_request_record(self.router, self._tick, req, trace=self.trace)
        return req

    def cancel(self, rid: int) -> bool:
        """Client abandon: evict ``rid`` wherever it is; True if it was
        live (terminal or unknown requests are a no-op)."""
        req = self._requests.get(rid)
        if req is None or req.terminal:
            return False
        if req.state == QUEUED:
            self._queue.remove(req)
            transition(req, CANCELLED, now=self.time_fn(),
                       reason="client_cancel")
            emit_request_record(self.router, self._tick, req,
                                trace=self.trace)
            return True
        self._release(req, CANCELLED, "client_cancel")
        return True

    # -- placement ----------------------------------------------------------

    def _free_lane(self) -> Optional[int]:
        for lane in range(self.config.lanes):
            if lane not in self._active:
                return lane
        return None

    def _try_place(self, req: Request) -> Optional[Tuple[int, Tuple[int, ...]]]:
        """(lane, blocks) or None when capacity is short: the request
        then waits in the bounded queue. The worst case is reserved up
        front, so a decode can never stall on pool memory (module
        docstring: no bucket floor, unlike the JAX engine)."""
        lane = self._free_lane()
        if lane is None:
            return None
        ids = self.allocator.alloc(blocks_needed(
            req.prompt_len + req.max_new_tokens, self.config.block_size))
        if ids is None:
            return None
        return lane, ids

    # -- the tick loop ------------------------------------------------------

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active

    def tick(self) -> int:
        """One scheduler iteration; returns the tick number executed."""
        self._ensure_started()
        t = self._tick
        self._expire(self.time_fn())
        if self.fault_plan is not None:
            # the wedge blocks here, inside the loop the watchdog guards
            hang_t0 = self.time_fn()
            self.fault_plan.maybe_hang(t)
            hang_s = self.time_fn() - hang_t0
            if hang_s > 0.0:
                self.trace.stall(t, list(self._active.values()),
                                 hang_t0, hang_s)
        n_pref = 0
        while (self._queue and not self._draining
               and n_pref < self.config.max_prefills_per_tick):
            placement = self._try_place(self._queue[0])
            if placement is None:
                break
            req = self._queue.popleft()
            req.lane, req.blocks = placement
            transition(req, ADMITTED, now=self.time_fn())
            emit_request_record(self.router, t, req, trace=self.trace)
            self._run_prefill(req, t)
            n_pref += 1
        if self._active:
            self._run_decode(t)
        if self.watchdog is not None:
            self.watchdog.beat(t)
        self._watch_compiles(t)
        interval = self.config.memory_interval_ticks
        if (self.router is not None and interval is not None
                and t % interval == 0):
            self.router.event("memory", t, **kv_pool_fields(
                num_blocks=self.allocator.num_blocks,
                free_blocks=self.allocator.free_blocks,
                block_size=self.config.block_size,
                live_tokens=sum(int(self._positions[lane])
                                for lane in self._active),
                peak_used_blocks=self.allocator.peak_used_blocks,
            ))
        self._tick += 1
        return t

    def _table_tensor(self, lanes, n_blocks: int):
        return torch.as_tensor(self._tables[lanes, :n_blocks],
                               device=self.device)

    def _clear_lane(self, lane: int) -> None:
        self._tables[lane, :] = self.config.num_blocks
        self._positions[lane] = 0
        self._last_tok[lane] = 0
        self._temps[lane] = 0.0

    @torch.no_grad()
    def _run_prefill(self, req: Request, t: int) -> None:
        cfg = self.config
        transition(req, PREFILL, now=self.time_fn())
        emit_request_record(self.router, t, req, trace=self.trace)
        lane, L = req.lane, req.prompt_len
        self._tables[lane, :] = cfg.num_blocks
        self._tables[lane, :len(req.blocks)] = req.blocks
        t0 = time.perf_counter()
        try:
            with span("prefill", router=self.router, step=t):
                tokens = torch.as_tensor(req.prompt, device=self.device)[None]
                cache = PagedKV(self.k_pool, self.v_pool,
                                self._table_tensor([lane], len(req.blocks)),
                                torch.zeros(1, dtype=torch.long,
                                            device=self.device))
                h = self.model.hidden_states(tokens, cache=cache)
                # only the last position's logits: the next token
                last = self.model.logits(h[-1:])[:, 0]
                tok = int(sample_next_token(
                    last, [req.temperature], self.generator,
                    top_k=cfg.top_k, top_p=cfg.top_p)[0])
        except Exception as e:
            logger.exception("prefill failed for request %d", req.rid)
            self._clear_lane(lane)
            self.allocator.free(req.blocks)
            transition(req, FAILED, now=self.time_fn(),
                       reason=f"engine_error: {type(e).__name__}")
            emit_request_record(self.router, t, req, trace=self.trace)
            return
        self._prefill_ema = _ema(self._prefill_ema, time.perf_counter() - t0)
        req.first_token_t = self.time_fn()
        req.tokens_out.append(tok)
        if cfg.collect_logits:
            req.logits = (req.logits or []) + [last[0].float().cpu().numpy()]
        if len(req.tokens_out) >= req.max_new_tokens:
            # single-token request: the prefill is the whole generation
            self._clear_lane(lane)
            self.allocator.free(req.blocks)
            transition(req, COMPLETED, now=self.time_fn())
            emit_request_record(self.router, t, req, trace=self.trace)
            return
        transition(req, DECODE, now=self.time_fn())
        emit_request_record(self.router, t, req, trace=self.trace)
        self._positions[lane] = L
        self._last_tok[lane] = tok
        self._temps[lane] = req.temperature
        self._active[lane] = req

    @torch.no_grad()
    def _run_decode(self, t: int) -> None:
        cfg = self.config
        lanes = sorted(self._active)
        t0 = time.perf_counter()
        try:
            with span("decode", router=self.router, step=t):
                if self.fault_plan is not None:
                    # inside the span: the inflated tick is exactly the
                    # span a stall warning flags
                    self.fault_plan.maybe_slow_decode(t)
                pos = self._positions[lanes]
                # the blocks that hold the furthest lane's position; a
                # lane with fewer reserved blocks has sentinel entries
                # there, which PagedKV reads from a real block behind the
                # decode mask
                n_blocks = int(pos.max()) // cfg.block_size + 1
                cache = PagedKV(self.k_pool, self.v_pool,
                                self._table_tensor(lanes, n_blocks),
                                torch.as_tensor(pos, device=self.device))
                tokens = torch.as_tensor(self._last_tok[lanes],
                                         device=self.device)[:, None]
                h = self.model.hidden_states(tokens, cache=cache,
                                             decode_step=True)
                logits = self.model.logits(h)[:, 0]
                nxts = sample_next_token(
                    logits, self._temps[lanes], self.generator,
                    top_k=cfg.top_k, top_p=cfg.top_p).cpu().numpy()
                rows = (logits.float().cpu().numpy()
                        if cfg.collect_logits else None)
        except Exception as e:
            logger.exception("decode tick %d failed", t)
            for req in list(self._active.values()):
                self._release(req, FAILED, f"engine_error: {type(e).__name__}")
            raise
        self._decode_ema = _ema(self._decode_ema, time.perf_counter() - t0)
        for i, lane in enumerate(lanes):
            req = self._active[lane]
            tok = int(nxts[i])
            req.tokens_out.append(tok)
            if rows is not None:
                req.logits = (req.logits or []) + [rows[i]]
            if len(req.tokens_out) >= req.max_new_tokens:
                self._release(req, COMPLETED, None)
            else:
                self._positions[lane] += 1
                self._last_tok[lane] = tok

    def _release(self, req: Request, state: str,
                 reason: Optional[str]) -> None:
        """Evict ``req`` from its lane, reclaim its blocks, book the
        terminal state: the one eviction path, so blocks never leak past
        an ending."""
        lane = req.lane
        if lane is not None and self._active.get(lane) is req:
            del self._active[lane]
            self._clear_lane(lane)
        self.allocator.free(req.blocks)
        transition(req, state, now=self.time_fn(), reason=reason)
        emit_request_record(self.router, self._tick, req, trace=self.trace)

    def _expire(self, now: float) -> None:
        """Deadline enforcement, every tick, queue and batch alike."""
        for req in [r for r in self._queue
                    if r.expires_at() is not None and now > r.expires_at()]:
            self._queue.remove(req)
            transition(req, TIMED_OUT, now=now, reason="deadline")
            emit_request_record(self.router, self._tick, req,
                                trace=self.trace)
        for req in [r for r in self._active.values()
                    if r.expires_at() is not None and now > r.expires_at()]:
            self._release(req, TIMED_OUT, "deadline")

    # -- fleet KV handoff (extract/adopt) -----------------------------------

    def extract(self, rid: int) -> Optional[dict]:
        """Remove a mid-decode request from this engine without booking a
        terminal state, returning the payload :meth:`adopt` installs on
        another engine (the fleet's prefill/decode disaggregation).

        The payload carries the request, its lane's decode cursor
        (position, last sampled token) and the contents of its KV blocks
        on the host, one device-to-host copy of ``pool[:, ids]`` per
        side (``kv["k"]``, ``kv["v"]``: host tensors, since numpy has no
        bfloat16), with ``n_blocks`` and their ``bytes``. None unless
        ``rid`` is live in a decode lane. The lane and blocks are
        reclaimed here; the request leaves this engine's books.
        """
        req = self._requests.get(rid)
        if req is None or req.state != DECODE or req.lane is None:
            return None
        lane = req.lane
        if self._active.get(lane) is not req:
            return None
        ids = torch.as_tensor(req.blocks, device=self.device)
        kv = {"k": self.k_pool[:, ids].cpu(), "v": self.v_pool[:, ids].cpu()}
        payload = {
            "request": req,
            "position": int(self._positions[lane]),
            "last_token": int(self._last_tok[lane]),
            "kv": kv,
            "n_blocks": len(req.blocks),
            "bytes": int(sum(x.numel() * x.element_size()
                             for x in kv.values())),
        }
        del self._active[lane]
        self._clear_lane(lane)
        self.allocator.free(req.blocks)
        req.lane, req.blocks = None, ()
        del self._requests[rid]
        # the decode segment on this engine ends here; the request's
        # story continues on the adopter (or at the fleet)
        self.trace.extracted(self._tick, req)
        return payload

    def adopt(self, payload: dict) -> bool:
        """Install an :meth:`extract` payload into a free lane: allocate
        blocks, write the handed-off KV into them in place (only the
        adopted blocks; the JAX engine rebuilds its whole pool on the
        host, with the same result), and resume the decode cursor where
        the source left it. False when this engine cannot take it (no
        free lane, pool short, rid already present, or another pool
        geometry); the request is untouched then, so adoption is
        all-or-nothing like ``alloc``.

        Greedy (temperature 0) decode resumes bit-identically: the KV
        bytes are the whole cursor. Sampled decode resumes on this
        engine's own generator.
        """
        self._ensure_started()
        req: Request = payload["request"]
        if req.rid in self._requests or req.state != DECODE:
            return False
        kv = payload["kv"]
        if set(kv) != {"k", "v"} or any(
                x.dtype != self.k_pool.dtype or x.dim() != 5
                or x.shape[0] != self.k_pool.shape[0]
                or x.shape[2:] != self.k_pool.shape[2:]
                for x in kv.values()):
            return False
        lane = self._free_lane()
        if lane is None:
            return False
        ids = self.allocator.alloc(payload["n_blocks"])
        if ids is None:
            return False
        idx = torch.as_tensor(ids, device=self.device)
        self.k_pool[:, idx] = kv["k"].to(self.device)
        self.v_pool[:, idx] = kv["v"].to(self.device)
        req.lane, req.blocks = lane, ids
        self._requests[req.rid] = req
        self._active[lane] = req
        self._tables[lane, :] = self.config.num_blocks
        self._tables[lane, :len(ids)] = ids
        self._positions[lane] = payload["position"]
        self._last_tok[lane] = payload["last_token"]
        self._temps[lane] = req.temperature
        self.trace.adopted(self._tick, req)
        return True

    # -- drain --------------------------------------------------------------

    def drain(self, grace_s: Optional[float] = None,
              deadline: Optional[float] = None) -> dict:
        """Graceful drain: stop admitting, reject the still-queued,
        finish or deadline-evict the in-flight within the grace budget,
        and book a terminal state for every request.

        ``deadline`` is an absolute instant on ``time_fn``'s clock;
        ``grace_s`` is relative from now. With neither, the drain runs
        until the batch empties (the requests' own deadlines still
        apply). Returns a summary dict. Re-entrant: a second call
        returns the first drain's summary marked ``redundant=True`` and
        runs nothing again; ``submit`` after a drain rejects with
        ``draining``.
        """
        self._ensure_started()
        if self._drain_report is not None:
            return dict(self._drain_report, redundant=True)
        self._draining = True
        t0 = self.time_fn()
        if deadline is None and grace_s is not None:
            deadline = t0 + grace_s
        inflight0 = list(self._active.values())
        evicted = 0
        with span("drain", router=self.router, step=self._tick):
            while self._queue:
                req = self._queue.popleft()
                transition(req, REJECTED, now=self.time_fn(),
                           reason="draining")
                emit_request_record(self.router, self._tick, req,
                                    trace=self.trace)
            while self._active:
                if deadline is not None and self.time_fn() > deadline:
                    for req in list(self._active.values()):
                        self._release(req, TIMED_OUT, "drain_deadline")
                        evicted += 1
                    break
                self.tick()
        # summarize by the actual endings of the requests in flight at
        # drain start: one whose own deadline expired inside the window
        # is a timeout, not a finish
        finished = sum(1 for r in inflight0 if r.state == COMPLETED)
        timed_out = sum(1 for r in inflight0
                        if r.state == TIMED_OUT
                        and r.reason != "drain_deadline")
        out = {
            "drain_s": self.time_fn() - t0,
            "finished": finished,
            "evicted": evicted,
            "timed_out": timed_out,
        }
        self._drain_report = dict(out)
        logger.info(
            "drain complete in %.3fs: %d finished, %d deadline-evicted, "
            "%d timed out on their own deadlines",
            out["drain_s"], finished, evicted, timed_out)
        return out

    @property
    def draining(self) -> bool:
        return self._draining

    # -- introspection ------------------------------------------------------

    def inflight_table(self) -> dict:
        """The forensic table of the requests in flight (for an incident
        bundle): best-effort reads only."""
        rows = []
        for lane, req in list(self._active.items()):
            rows.append({
                "id": req.rid, "lane": lane, "state": req.state,
                "prompt_len": req.prompt_len,
                "tokens_out": len(req.tokens_out),
                "max_new": req.max_new_tokens,
                "deadline_s": req.deadline_s,
            })
        return {
            "requests": rows,
            "queued": len(self._queue),
            "tick": self._tick,
            "free_blocks": self.allocator.free_blocks,
        }

    def requests(self) -> List[Request]:
        return list(self._requests.values())

    def stats(self) -> dict:
        """Aggregate outcome: per-terminal counts, reasons, TTFT
        percentiles over requests that got a first token, the p50 time
        per generated token after the first, and the steady-state kernel
        load counter."""
        counts: Dict[str, int] = {}
        reasons: Dict[str, int] = {}
        ttfts: List[float] = []
        per_token: List[float] = []
        tokens = live = 0
        for req in self._requests.values():
            if req.terminal:
                counts[req.state] = counts.get(req.state, 0) + 1
                if req.reason:
                    reasons[req.reason] = reasons.get(req.reason, 0) + 1
            else:
                live += 1
            if req.ttft_s is not None:
                ttfts.append(req.ttft_s)
            n = len(req.tokens_out)
            if req.state == COMPLETED and n > 1:
                per_token.append((req.end_t - req.first_token_t) / (n - 1))
            tokens += n
        return {
            "submitted": self._next_rid,
            "live": live,
            "terminal": counts,
            "reasons": reasons,
            "tokens_out": tokens,
            "ttft_p50_s": percentile(ttfts, 50.0),
            "ttft_p99_s": percentile(ttfts, 99.0),
            "per_token_p50_s": percentile(per_token, 50.0),
            "prefill_ema_s": self._prefill_ema,
            "decode_ema_s": self._decode_ema,
            "ticks": self._tick,
            "steady_state_compiles": self._steady_compiles,
            "free_blocks": self.allocator.free_blocks,
            "kv_pool_peak_blocks": self.allocator.peak_used_blocks,
        }
