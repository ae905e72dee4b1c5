"""``apex.contrib.peer_memory`` import surface (counterpart of
apex_tpu/contrib/peer_memory.py; the reference is PeerMemoryPool and
PeerHaloExchanger1d over CUDA IPC).

The port's halo exchange is a pair of tagged point-to-point messages
over a process group (``parallel_state.p2p``), with no memory pool of
its own; it lives in ``contrib.bottleneck.halo_exchange_1d`` and is
re-exported here under the reference's path."""

from apex_tpu_torch.contrib.bottleneck import halo_exchange_1d

__all__ = ["halo_exchange_1d"]
