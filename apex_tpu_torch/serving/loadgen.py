"""Poisson load generation and latency statistics for the serving core.

The overload drill's traffic source: seeded exponential inter-arrival
gaps (a Poisson process at ``rate_rps``), seeded prompt/generation-
length and temperature draws, and the chaos hooks — a
:class:`~apex_tpu_torch.resilience.chaos.FaultPlan`'s ``burst_steps`` inject
``burst_n`` simultaneous arrivals at a pump, ``malformed_requests``
swap chosen ordinals' payloads for garbage, and ``abandon_requests``
cancel chosen ordinals on the NEXT pump (the client-disconnect shape:
the request is already in the engine when it is abandoned).

Everything is seeded through one ``np.random.RandomState`` so a drill
replays exactly, and the clock is injected (``time_fn``) so tests can drive virtual time.

:func:`percentile` is the one latency-statistics home (nearest-rank
with linear interpolation, the numpy default) shared by the engine's
``stats()`` and the drills. Copied from apex_tpu/serving/loadgen.py,
which imports no JAX.
"""

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["percentile", "PoissonLoadGenerator", "LoadReport"]


def percentile(xs: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile of ``xs`` (linear interpolation), or None on
    an empty sample — None-not-fake-number."""
    if not xs:
        return None
    return float(np.percentile(np.asarray(list(xs), np.float64), p))


@dataclasses.dataclass
class LoadReport:
    """What one load run produced (the bench section's raw material)."""

    submitted: int
    ttft_s: List[float]
    per_token_s: List[float]
    tokens_out: int

    def summary(self) -> dict:
        return {
            "submitted": self.submitted,
            "tokens_out": self.tokens_out,
            "ttft_p50_s": percentile(self.ttft_s, 50.0),
            "ttft_p99_s": percentile(self.ttft_s, 99.0),
            "per_token_p50_s": percentile(self.per_token_s, 50.0),
            "per_token_p99_s": percentile(self.per_token_s, 99.0),
        }


class PoissonLoadGenerator:
    """Submit seeded Poisson arrivals into a ServingEngine.

    Drive it from the serving loop::

        gen = PoissonLoadGenerator(rate_rps=20, vocab=512, seed=0,
                                   n_requests=100, fault_plan=plan)
        while not gen.done or not eng.idle:
            gen.pump(eng)
            eng.tick()

    :meth:`pump` submits every arrival whose (seeded) arrival time has
    passed, applies the chaos faults, and returns the newly-submitted
    requests. Arrival times are anchored at the first pump.
    """

    def __init__(
        self,
        rate_rps: float,
        vocab: int,
        n_requests: int,
        prompt_len: Tuple[int, int] = (4, 24),
        max_new: Tuple[int, int] = (4, 16),
        temperature: float = 0.0,
        deadline_s: Optional[float] = None,
        seed: int = 0,
        fault_plan=None,
        time_fn=None,
    ):
        if rate_rps <= 0:
            raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
        if n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {n_requests}")
        import time as _time

        self.rate_rps = float(rate_rps)
        self.vocab = int(vocab)
        self.n_requests = int(n_requests)
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.temperature = float(temperature)
        self.deadline_s = deadline_s
        self.fault_plan = fault_plan
        self.time_fn = time_fn if time_fn is not None else _time.monotonic
        self._rng = np.random.RandomState(seed)
        # the whole arrival schedule up front: exponential gaps at the
        # requested rate, relative to the first pump
        gaps = self._rng.exponential(1.0 / self.rate_rps, size=n_requests)
        self._arrivals = np.cumsum(gaps)
        self._next = 0
        self._pump_n = 0
        self._t0: Optional[float] = None
        self._ordinal = 0
        self._pending_abandon: List[int] = []
        self.submitted = []  # Request objects, submission order

    @property
    def done(self) -> bool:
        return self._next >= self.n_requests

    @property
    def start_t(self) -> Optional[float]:
        """Monotonic instant of the first pump (None before it)."""
        return self._t0

    def _draw_request(self, malformed: bool):
        if malformed:
            # the malformed-prompt fault: an empty payload — admission
            # must reject-with-reason, never crash the batch
            return np.zeros((0,), np.int32), 1
        lo, hi = self.prompt_len
        plen = int(self._rng.randint(lo, hi + 1))
        lo_n, hi_n = self.max_new
        n_new = int(self._rng.randint(lo_n, hi_n + 1))
        prompt = self._rng.randint(
            0, self.vocab, size=plen).astype(np.int32)
        return prompt, n_new

    def _submit_one(self, engine):
        n = self._ordinal
        self._ordinal += 1
        malformed = (self.fault_plan is not None
                     and self.fault_plan.take_malformed(n))
        prompt, n_new = self._draw_request(malformed)
        req = engine.submit(
            prompt, max_new_tokens=n_new, temperature=self.temperature,
            deadline_s=self.deadline_s,
        )
        self.submitted.append(req)
        if self.fault_plan is not None and self.fault_plan.take_abandon(n):
            # abandoned on the NEXT pump: the client got the request in,
            # then disconnected mid-flight
            self._pending_abandon.append(req.rid)
        return req

    def pump(self, engine, now: Optional[float] = None) -> list:
        """Submit every arrival due by ``now``; apply pending abandons
        and this pump's burst fault; returns the new requests."""
        now = self.time_fn() if now is None else now
        if self._t0 is None:
            self._t0 = now
        for rid in self._pending_abandon:
            engine.cancel(rid)
        self._pending_abandon = []
        out = []
        while (self._next < self.n_requests
               and now - self._t0 >= self._arrivals[self._next]):
            self._next += 1
            out.append(self._submit_one(engine))
        if self.fault_plan is not None:
            for _ in range(self.fault_plan.take_burst(self._pump_n)):
                out.append(self._submit_one(engine))
        self._pump_n += 1
        return out

    def report(self) -> LoadReport:
        """Latency report over the COMPLETED requests this generator
        submitted (shed/evicted requests have no completion latency to
        report — they are counted by the engine's stats)."""
        ttfts, per_tok, tokens = [], [], 0
        for req in self.submitted:
            tokens += len(req.tokens_out)
            if req.ttft_s is not None:
                ttfts.append(req.ttft_s)
            if (req.state == "completed" and req.end_t is not None
                    and req.first_token_t is not None
                    and len(req.tokens_out) > 1):
                per_tok.append(
                    (req.end_t - req.first_token_t)
                    / (len(req.tokens_out) - 1)
                )
        return LoadReport(
            submitted=len(self.submitted), ttft_s=ttfts,
            per_token_s=per_tok, tokens_out=tokens,
        )
