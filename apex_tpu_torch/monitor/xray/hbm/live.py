"""Live device-memory records (counterpart of
apex_tpu/monitor/xray/hbm/live.py): only :func:`kv_pool_fields`, the
serving engine's ``kind="memory"`` KV-pool record, copied as it is
there (plain Python). The training watermark monitor is not ported yet.
"""

from typing import Optional

__all__ = ["kv_pool_fields"]


def kv_pool_fields(*, num_blocks: int, free_blocks: int, block_size: int,
                   live_tokens: int,
                   peak_used_blocks: Optional[int] = None) -> dict:
    """KV block-pool occupancy + internal fragmentation as
    ``kind="memory"`` record fields (the serving engine calls this from
    ``tick()``).

    ``live_tokens`` is the sum of in-flight sequence positions;
    fragmentation is the fraction of RESERVED pool capacity holding no
    live token (tail waste of partially-filled blocks) — the number the
    prefix-aware placer needs to distinguish "full" from "fragmented".
    """
    used = num_blocks - free_blocks
    if used < 0:
        raise ValueError(
            f"free_blocks {free_blocks} exceeds num_blocks {num_blocks}"
        )
    reserved_tokens = used * block_size
    fragmentation = 0.0
    if reserved_tokens:
        fragmentation = max(0.0, 1.0 - live_tokens / reserved_tokens)
    fields = {
        "scope": "kv_pool",
        "num_blocks": num_blocks,
        "used_blocks": used,
        "free_blocks": free_blocks,
        "occupancy": used / num_blocks if num_blocks else 0.0,
        "live_tokens": live_tokens,
        "fragmentation": fragmentation,
    }
    if peak_used_blocks is not None:
        fields["kv_pool_peak_blocks"] = peak_used_blocks
    return fields
