"""Elastic restart: the manifest's topology block and the refusal of a
restore across a change of layout (the resharder comes with a later
slice of the port)."""

from apex_tpu_torch.resilience.elastic.topology import (
    TOPOLOGY_VERSION,
    ElasticRestoreError,
    check_restorable,
    is_ef_path,
    live_mesh,
    topology_block,
)

__all__ = ["TOPOLOGY_VERSION", "ElasticRestoreError", "check_restorable",
           "is_ef_path", "live_mesh", "topology_block"]
