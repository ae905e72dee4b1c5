"""Fault injection for deterministic recovery-path testing (counterpart
of apex_tpu/resilience/chaos.py).

Every recovery path in this package is only trustworthy if a test drives
it on purpose. These utilities inject the three production failure modes
on demand, deterministically:

- **NaN losses/grads at chosen steps** — ``poison_loss`` is a
  multiplicative poison (``loss * NaN`` when armed), so
  both the loss value and every gradient flowing through it go
  non-finite, exactly like a real overflow; the host arms it per step
  through a ``FaultPlan``.
- **Preemption** — ``simulate_sigterm`` delivers a real SIGTERM to this
  process, driving the actual AutoResume signal path, not a mock.
- **Hangs and slow hosts** — ``wedge`` blocks the calling thread forever
  (a hung collective / stuck host fetch stand-in that delivers NOTHING:
  no signal, no exception — exactly the failure class only the stall
  watchdog's escalation ladder can answer), and ``FaultPlan``'s
  ``slow_steps`` inject a per-step artificial delay (the straggler /
  thermal-throttle shape the warn level flags without escalating).
- **Serving overload shapes** — the four production failure modes of a
  request-serving loop (``apex_tpu_torch.serving``):
  ``slow_decode_steps`` inflate chosen scheduler ticks (a thermally
  throttled / contended decode the admission controller must absorb by
  SHEDDING, not queue growth), ``abandon_requests`` name request
  ordinals whose client disconnects mid-flight (the engine must book
  ``cancelled`` and reclaim the KV blocks), ``malformed_requests`` name
  ordinals submitted as garbage (empty prompt — the admission layer
  must reject-with-reason, never crash the batch), and ``burst_steps``
  inject ``burst_n`` simultaneous arrivals (the Poisson tail that blows
  a bounded queue). All consumed by the serving load generator /
  engine, step-or-ordinal keyed like every other fault here.
- **Silent in-memory corruption** — ``bitflip_leaf`` XORs one bit of
  one element of one live param/opt-state leaf (seeded, sharding-
  preserving): the SDC shape that sails PAST the anomaly sentinel (a
  low mantissa bit moves the loss by parts-per-thousand, nothing
  spikes) and past every checkpoint-file check (the corrupt state is
  faithfully saved and faithfully fingerprinted). Only the replay
  referee catches it — the clean re-execution
  diverges from the journaled trajectory at the flip — and the
  bisector pins the step and the leaf. ``FaultPlan.bitflip_steps``
  schedules it.

- **Disk corruption** — ``corrupt_checkpoint`` bit-flips or truncates a
  saved step directory's largest file in place (silent disk rot, a torn
  write on a non-atomic backend), and ``corrupt_latest_checkpoint`` does
  it to the newest finalized step; only the integrity manifest catches
  either.

``FaultPlan`` schedules all of these by global step with consumed-once
semantics: after a rollback re-winds the loop, the REPLAYED step runs
clean — which is what makes the recovered trajectory comparable to an
uninjected run in tests (persistent=True disables that for testing the
halt path).
"""

import dataclasses
import logging
import os
import signal as _signal
import threading
import time
from typing import FrozenSet, Iterable, Optional, Set, Union

import numpy as np
import torch

from apex_tpu_torch.utils.pytree import map_tensors, tree_leaves_with_path

logger = logging.getLogger("apex_tpu_torch.resilience")

__all__ = [
    "FaultPlan", "bitflip_leaf", "corrupt_checkpoint",
    "corrupt_latest_checkpoint", "parse_steps", "poison_loss",
    "simulate_sigterm", "wedge",
]


def poison_loss(loss, armed):
    """``loss * NaN`` when ``armed`` is truthy, identity otherwise.

    Multiplicative (``loss + NaN`` would leave the gradients finite), so
    the loss and every gradient through it go non-finite, like a real
    blowup. ``armed`` may be a number or a 0-d tensor on any device; it
    is not read on the host, and a number is filled in on the loss's
    device (no blocking copy from the host).
    """
    if isinstance(armed, torch.Tensor):
        armed = armed.to(loss.device).bool()
    else:
        armed = torch.full((), bool(armed), device=loss.device)
    return loss * torch.where(armed, float("nan"), 1.0)


def parse_steps(spec: Union[str, Iterable[int], None]) -> FrozenSet[int]:
    """Parse '3,7,10-12' (or any int iterable) into a step set."""
    if spec is None:
        return frozenset()
    if isinstance(spec, str):
        out: Set[int] = set()
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "-" in part:
                lo, hi = part.split("-", 1)
                out.update(range(int(lo), int(hi) + 1))
            else:
                out.add(int(part))
        return frozenset(out)
    return frozenset(int(s) for s in spec)


def wedge(timeout_s: Optional[float] = None) -> None:
    """Block the calling thread on an Event nobody sets — the hung-
    collective / stuck-host-fetch stand-in.

    Unlike a sleep, the block is indefinite by default (a hung job does
    not time itself out; the escalating watchdog must end it) and unlike
    raising, it delivers nothing the ``except`` ladder could catch.
    ``timeout_s`` bounds the wedge for unit tests only.
    """
    logger.warning(
        "chaos: wedging this thread %s",
        "forever (incident ladder must end the job)"
        if timeout_s is None else f"for {timeout_s:.3f}s",
    )
    # concurrency.unbounded-wait fires here by design (allowlisted): a
    # fresh private Event nobody can set, so the wait is unbounded and
    # unpreemptable from Python — only the watchdog's escalation ladder
    # (or timeout_s in tests) ends it, exactly like the real hang
    threading.Event().wait(timeout_s)


@dataclasses.dataclass
class FaultPlan:
    """Step-keyed fault schedule with consumed-once semantics.

    ``nan_steps``: steps whose loss gets poisoned (see ``poison_loss``).
    ``sigterm_steps``: steps after which a real SIGTERM is delivered.
    ``hang_steps``: steps at which the host loop wedges (see ``wedge``;
    ``hang_timeout_s`` bounds it for tests — production drills leave it
    None so only the incident ladder ends the job).
    ``slow_steps``: steps delayed by ``slow_s`` wall seconds (straggler
    injection: slow enough to blow a stall deadline, not a hang).
    ``bitflip_steps``: steps AFTER which one live param/opt-state bit is
    flipped in memory (see ``bitflip_leaf``; ``bitflip_bit`` /
    ``bitflip_seed`` pick the bit and the leaf) — the silent-corruption
    fault the replay bisector exists to localize.
    ``slow_decode_steps``: serving scheduler ticks delayed by
    ``slow_decode_s`` wall seconds inside the decode span (the serving
    straggler shape; the engine consumes it per tick).
    ``abandon_requests``: request ORDINALS (submission order, 0-based)
    whose client abandons them after submission — the serving load
    generator cancels them on its next pump.
    ``malformed_requests``: request ordinals submitted malformed (empty
    prompt) instead of their real payload.
    ``burst_steps``: load-generator pumps at which ``burst_n`` extra
    arrivals land at once (the burst-arrival overload shape).
    ``kill_replica_steps``: fleet-router ticks at which a serving
    replica is killed outright (heartbeats stop, in-flight KV vanishes
    — the process-death shape the fleet's failover path must answer by
    re-dispatching; serving.fleet, docs/serving.md "Fleet"). The
    router picks the victim (the busiest live replica, deterministic).
    ``persistent``: re-arm faults on replay (halt-path testing) instead
    of the default fire-once behavior (recovery-path testing).
    """

    nan_steps: FrozenSet[int] = frozenset()
    sigterm_steps: FrozenSet[int] = frozenset()
    hang_steps: FrozenSet[int] = frozenset()
    slow_steps: FrozenSet[int] = frozenset()
    bitflip_steps: FrozenSet[int] = frozenset()
    slow_decode_steps: FrozenSet[int] = frozenset()
    abandon_requests: FrozenSet[int] = frozenset()
    malformed_requests: FrozenSet[int] = frozenset()
    burst_steps: FrozenSet[int] = frozenset()
    kill_replica_steps: FrozenSet[int] = frozenset()
    slow_s: float = 0.0
    slow_decode_s: float = 0.0
    burst_n: int = 8
    hang_timeout_s: Optional[float] = None
    bitflip_bit: int = 12
    bitflip_seed: int = 0
    persistent: bool = False

    def __post_init__(self):
        self.nan_steps = parse_steps(self.nan_steps)
        self.sigterm_steps = parse_steps(self.sigterm_steps)
        self.hang_steps = parse_steps(self.hang_steps)
        self.slow_steps = parse_steps(self.slow_steps)
        self.bitflip_steps = parse_steps(self.bitflip_steps)
        self.slow_decode_steps = parse_steps(self.slow_decode_steps)
        self.abandon_requests = parse_steps(self.abandon_requests)
        self.malformed_requests = parse_steps(self.malformed_requests)
        self.burst_steps = parse_steps(self.burst_steps)
        self.kill_replica_steps = parse_steps(self.kill_replica_steps)
        self._fired_nan: Set[int] = set()
        self._fired_sigterm: Set[int] = set()
        self._fired_hang: Set[int] = set()
        self._fired_slow: Set[int] = set()
        self._fired_bitflip: Set[int] = set()
        self._fired_slow_decode: Set[int] = set()
        self._fired_abandon: Set[int] = set()
        self._fired_malformed: Set[int] = set()
        self._fired_burst: Set[int] = set()
        self._fired_kill_replica: Set[int] = set()

    def _due(self, step: int, steps: FrozenSet[int], fired: Set[int]) -> bool:
        if step in steps and (self.persistent or step not in fired):
            fired.add(step)
            return True
        return False

    def take_nan(self, step: int) -> float:
        """1.0 if a NaN should poison this step's loss, else 0.0."""
        if self._due(int(step), self.nan_steps, self._fired_nan):
            return 1.0
        return 0.0

    def maybe_sigterm(self, step: int) -> bool:
        if self._due(int(step), self.sigterm_steps, self._fired_sigterm):
            simulate_sigterm()
            return True
        return False

    def maybe_slow(self, step: int) -> bool:
        """Inject the per-step artificial delay when scheduled."""
        if self._due(int(step), self.slow_steps, self._fired_slow):
            logger.warning(
                "chaos: slowing step %d by %.3fs", int(step), self.slow_s
            )
            time.sleep(self.slow_s)
            return True
        return False

    def maybe_hang(self, step: int) -> bool:
        """Wedge the calling (host-loop) thread when scheduled."""
        if self._due(int(step), self.hang_steps, self._fired_hang):
            wedge(self.hang_timeout_s)
            return True
        return False

    def maybe_slow_decode(self, step: int) -> bool:
        """Inflate serving scheduler tick ``step`` by ``slow_decode_s``
        (called INSIDE the decode span so the stall warn flags exactly
        the inflated tick)."""
        if self._due(int(step), self.slow_decode_steps,
                     self._fired_slow_decode):
            logger.warning(
                "chaos: slowing decode tick %d by %.3fs",
                int(step), self.slow_decode_s,
            )
            time.sleep(self.slow_decode_s)
            return True
        return False

    def take_abandon(self, ordinal: int) -> bool:
        """True when request ``ordinal`` should be client-abandoned."""
        return self._due(int(ordinal), self.abandon_requests,
                         self._fired_abandon)

    def take_malformed(self, ordinal: int) -> bool:
        """True when request ``ordinal`` should be submitted malformed."""
        return self._due(int(ordinal), self.malformed_requests,
                         self._fired_malformed)

    def take_burst(self, step: int) -> int:
        """Extra arrivals to inject at load-generator pump ``step``
        (``burst_n`` when scheduled, else 0)."""
        if self._due(int(step), self.burst_steps, self._fired_burst):
            logger.warning(
                "chaos: injecting a burst of %d arrivals at pump %d",
                self.burst_n, int(step),
            )
            return int(self.burst_n)
        return 0

    def take_kill_replica(self, step: int) -> bool:
        """True when a serving replica should be killed at fleet tick
        ``step`` (the fleet router consumes this and kills its busiest
        live replica — deterministic victim choice, seeded drills)."""
        if self._due(int(step), self.kill_replica_steps,
                     self._fired_kill_replica):
            logger.warning(
                "chaos: killing a serving replica at fleet tick %d",
                int(step),
            )
            return True
        return False

    def maybe_bitflip(self, step: int, tree, path_filter=None):
        """``(new_tree, info)`` with one bit flipped when scheduled for
        ``step``, else ``(tree, None)`` — apply to the live state AFTER
        the step completes (the flip then lands in any checkpoint saved
        at the next boundary, which is what lets the replay bisector
        pin the exact leaf)."""
        if self._due(int(step), self.bitflip_steps, self._fired_bitflip):
            return bitflip_leaf(tree, bit=self.bitflip_bit,
                                seed=self.bitflip_seed,
                                path_filter=path_filter)
        return tree, None


def simulate_sigterm() -> None:
    """Deliver a real SIGTERM to this process (drives the actual
    AutoResume handler, unlike setting its flag directly)."""
    os.kill(os.getpid(), _signal.SIGTERM)


def bitflip_leaf(tree, bit: int = 12, seed: int = 0,
                 path_filter: Optional[str] = None):
    """Flip one bit of one element of one leaf of a live tensor tree.

    ``tree`` is a tensor, or dicts, lists and tuples of tensors (the
    ``utils.pytree`` collections; ``dict(model.named_parameters())``
    too). Returns ``(new_tree, info)``: ``new_tree`` shares every leaf
    but the flipped one, which is a patched copy on the leaf's device in
    its dtype; ``info`` records the leaf's path in the
    ``jax.tree_util.keystr`` form of the nested dicts it stands for (so
    a path reads the same as the JAX package's), the flat element index,
    the bit, and the values before and after. Deterministic: the leaf is
    chosen by ``seed`` among the (optionally ``path_filter``-matching)
    floating leaves in the JAX leaf order, the element by the JAX
    package's seeded multiplicative hash.

    ``bit`` indexes from the LSB of the element's integer view; the
    default 12 lands in a float32's low mantissa: a parts-per-thousand
    change that no loss-spike sentinel notices.
    """
    candidates = [
        (path, leaf) for path, leaf in tree_leaves_with_path(tree)
        if leaf.is_floating_point() and leaf.numel() > 0
        and (path_filter is None or path_filter in path)
    ]
    if not candidates:
        raise ValueError(
            f"no float leaf to flip (path_filter={path_filter!r})"
        )
    keystr, leaf = candidates[seed % len(candidates)]
    flat = leaf.detach().reshape(-1).cpu().clone()
    n = flat.numel()
    idx = (seed * 2654435761 + n // 2) % n
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        flat.element_size()]
    view = flat.view(ints).numpy()
    before = flat[idx].item()
    view[idx] ^= np.array(1 << bit, dtype=f"u{flat.element_size()}").view(
        view.dtype)
    after = flat[idx].item()
    patched = flat.reshape(leaf.shape).to(leaf.device)
    info = {
        "path": keystr, "element": int(idx), "bit": int(bit),
        "before": before, "after": after,
        "dtype": str(leaf.dtype).replace("torch.", ""),
        "shape": list(leaf.shape),
    }
    logger.warning("chaos: bit-flipped %s[%d] bit %d (%r -> %r)",
                   keystr, idx, bit, before, after)
    return map_tensors(lambda t: patched if t is leaf else t, tree), info


def _payload_files(step_dir: str):
    """Checkpoint payload files, largest first (stable tiebreak on name):
    the tensor payload dominates, so "largest first" deterministically
    targets real tensor bytes."""
    files = []
    for root, _, names in os.walk(step_dir):
        for n in names:
            p = os.path.join(root, n)
            files.append((-os.path.getsize(p), os.path.relpath(p, step_dir), p))
    files.sort()
    return [p for _, _, p in files]


def corrupt_checkpoint(step_dir: str, mode: str = "bitflip", seed: int = 0) -> str:
    """Corrupt a checkpoint directory in place; returns the file touched.

    ``bitflip``: XOR one byte (position seeded) of a payload file (the
    largest for seed 0) with 0x40: silent disk rot. ``truncate``: cut
    that file to half: a torn write on a non-atomic backend. Both leave
    the directory structure intact, so only content verification (the
    manifest) can catch them. The JAX package's function, byte for byte.
    """
    files = _payload_files(step_dir)
    if not files:
        raise FileNotFoundError(f"no files to corrupt under {step_dir}")
    target = files[seed % len(files)]
    size = os.path.getsize(target)
    if mode == "truncate":
        with open(target, "rb+") as f:
            f.truncate(max(size // 2, 0))
    elif mode == "bitflip":
        if size == 0:
            raise ValueError(f"cannot bit-flip empty file {target}")
        pos = (seed * 2654435761 + size // 2) % size
        with open(target, "rb+") as f:
            f.seek(pos)
            b = f.read(1)
            f.seek(pos)
            f.write(bytes([b[0] ^ 0x40]))
    else:
        raise ValueError(f"unknown corruption mode: {mode!r}")
    return target


def corrupt_latest_checkpoint(
    directory: str, mode: str = "bitflip", seed: int = 0
) -> Optional[str]:
    """Corrupt the NEWEST finalized step dir; returns it (None if empty)."""
    from apex_tpu_torch.utils.checkpoint import finalized_steps

    steps = finalized_steps(directory)
    if not steps:
        return None
    step_dir = os.path.join(os.path.abspath(directory), f"step_{steps[-1]}")
    corrupt_checkpoint(step_dir, mode=mode, seed=seed)
    return step_dir
