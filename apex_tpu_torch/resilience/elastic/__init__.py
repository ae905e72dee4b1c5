"""Elastic restart: checkpoints at any world size, restored across a
change of layout (counterpart of apex_tpu/resilience/elastic/).

- ``layout``   — how a live state lies over the ranks (dp x tp) and the
  global tree it stands for; a checkpoint holds the global tree.
- ``topology`` — the manifest's topology block (per-leaf global shape,
  dtype, split, the ZeRO marker) written at save time.
- ``reshard``  — :func:`restore_resharded`: a step saved on layout A
  onto layout B, the ZeRO flat buffers regrouped across a change of dp,
  each leaf's crc32 verified over its global array, and a reasoned
  :class:`ElasticRestoreError` on any mismatch it cannot prove safe.
- ``__main__`` — ``python -m apex_tpu_torch.resilience.elastic``: the
  exit-nonzero selftest, 4 -> 2 -> 4 ranks in one spawned world.

``AutoResume`` (utils/autoresume.py) and the verified restore of
``resilience.integrity`` route through here whenever the saved layout
differs from the live one, or the world is larger than one.
"""

from apex_tpu_torch.resilience.elastic.reshard import (
    needs_reshard,
    restore_resharded,
)
from apex_tpu_torch.resilience.elastic.topology import (
    TOPOLOGY_VERSION,
    ElasticRestoreError,
    is_ef_path,
    live_mesh,
    topology_block,
)

__all__ = ["TOPOLOGY_VERSION", "ElasticRestoreError", "is_ef_path",
           "live_mesh", "needs_reshard", "restore_resharded",
           "topology_block"]
