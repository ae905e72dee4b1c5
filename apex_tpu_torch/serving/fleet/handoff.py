"""KV handoff ledger: the block-id exchange between pools, audited.

Disaggregated serving moves a request's KV cache between replicas — a
prefill replica's pool blocks are read out and scattered into a decode
replica's pool (``ServingEngine.extract``/``adopt``). That transfer is
traffic, and the repo's rule for traffic is the xray collective
ledger's: every byte that moves is BOOKED, both sides, so "did the
bytes arrive" is an audit over records instead of a hope. The
:class:`HandoffLedger` here is that rule applied to handoffs — each
exchange is booked twice (``side="out"`` at extract, ``side="in"`` at
adopt) as ``kind="handoff"`` records through the shared MetricRouter
schema:

    {"t", "step", "kind": "handoff", "host", "seq", "id", "src",
     "dst", "blocks", "bytes", "side", "trace"}

(``trace`` duplicates the request's global id under the trace-id key so
a jq over the stream joins the byte audit with the request's span tree
— the x-ray cross-link, docs/serving.md.)

and :meth:`audit` closes the loop: every ``seq`` must have exactly one
``out`` and one ``in`` with EQUAL bytes and block counts — a half-booked
or size-mismatched handoff is a lost cache, surfaced loudly. An
``abandon(seq)`` books the deliberate exception (adoption refused
everywhere, request re-queued from scratch) so the audit distinguishes
"we chose to drop the blocks" from "the blocks vanished".

Copied from apex_tpu/serving/fleet/handoff.py (no JAX): the ledger is pure
bookkeeping — the device copies live in the engine.
"""

import dataclasses
from typing import Dict, List, Optional

__all__ = ["HandoffLedger", "HandoffEntry"]


@dataclasses.dataclass
class HandoffEntry:
    """One booked exchange (both sides land here as they happen)."""

    seq: int
    rid: int
    src: str
    n_blocks: int
    bytes_out: int
    dst: Optional[str] = None
    bytes_in: Optional[int] = None
    blocks_in: Optional[int] = None
    abandoned: bool = False

    @property
    def matched(self) -> bool:
        return (not self.abandoned
                and self.bytes_in == self.bytes_out
                and self.blocks_in == self.n_blocks)


class HandoffLedger:
    """Both-sides bookkeeping for fleet KV handoffs (module docstring).

    ``router=None`` keeps the ledger in-memory only (un-wired library
    cost: records are a no-op, the audit still works).
    """

    def __init__(self, router=None):
        self.router = router
        self._entries: Dict[int, HandoffEntry] = {}
        self._next_seq = 0

    def book_out(self, rid: int, src: str, n_blocks: int, nbytes: int,
                 tick: int) -> int:
        """Book the extract side; returns the exchange's ``seq``."""
        seq = self._next_seq
        self._next_seq += 1
        self._entries[seq] = HandoffEntry(
            seq=seq, rid=int(rid), src=str(src), n_blocks=int(n_blocks),
            bytes_out=int(nbytes),
        )
        if self.router is not None:
            self.router.event(
                "handoff", int(tick), seq=seq, id=int(rid), src=str(src),
                dst=None, blocks=int(n_blocks), bytes=int(nbytes),
                side="out", trace=int(rid),
            )
        return seq

    def book_in(self, seq: int, dst: str, n_blocks: int, nbytes: int,
                tick: int) -> None:
        """Book the adopt side of exchange ``seq`` (unknown/duplicate
        seqs are refused loudly — a double-booked receive is exactly
        the corruption the audit exists to catch)."""
        entry = self._entries.get(seq)
        if entry is None:
            raise ValueError(f"handoff seq {seq} was never booked out")
        if entry.bytes_in is not None or entry.abandoned:
            raise ValueError(
                f"handoff seq {seq} already closed "
                f"({'abandoned' if entry.abandoned else 'received'}) — "
                f"one adopt per extract"
            )
        entry.dst = str(dst)
        entry.bytes_in = int(nbytes)
        entry.blocks_in = int(n_blocks)
        if self.router is not None:
            self.router.event(
                "handoff", int(tick), seq=int(seq), id=entry.rid,
                src=entry.src, dst=str(dst), blocks=int(n_blocks),
                bytes=int(nbytes), side="in", trace=entry.rid,
            )

    def abandon(self, seq: int, tick: int, reason: str) -> None:
        """Book a deliberate drop: no replica could adopt, the request
        re-queues from scratch and the extracted blocks are discarded.
        The audit then treats the exchange as CLOSED, not lost."""
        entry = self._entries.get(seq)
        if entry is None:
            raise ValueError(f"handoff seq {seq} was never booked out")
        if entry.bytes_in is not None or entry.abandoned:
            raise ValueError(f"handoff seq {seq} already closed")
        entry.abandoned = True
        if self.router is not None:
            self.router.event(
                "handoff", int(tick), seq=int(seq), id=entry.rid,
                src=entry.src, dst=None, blocks=entry.n_blocks,
                bytes=0, side="abandoned", reason=str(reason),
                trace=entry.rid,
            )

    def entries(self) -> List[HandoffEntry]:
        return list(self._entries.values())

    def audit(self) -> dict:
        """The closure report the drills assert on: every exchange
        either matched (bytes/blocks equal both sides) or was
        deliberately abandoned; ``open``/``mismatched`` list the seqs
        that violate it (empty in a healthy fleet)."""
        open_seqs, mismatched = [], []
        bytes_out = bytes_in = 0
        for e in self._entries.values():
            bytes_out += e.bytes_out
            if e.abandoned:
                continue
            if e.bytes_in is None:
                open_seqs.append(e.seq)
                continue
            bytes_in += e.bytes_in
            if not e.matched:
                mismatched.append(e.seq)
        n_abandoned = sum(1 for e in self._entries.values() if e.abandoned)
        return {
            "handoffs": len(self._entries),
            "abandoned": n_abandoned,
            "bytes_out": bytes_out,
            "bytes_in": bytes_in,
            "open": sorted(open_seqs),
            "mismatched": sorted(mismatched),
            "matched": not open_seqs and not mismatched and (
                bytes_in == bytes_out
                - sum(e.bytes_out for e in self._entries.values()
                      if e.abandoned)
            ),
        }
