"""Stage-edge communication for pipeline parallelism (counterpart of
apex_tpu/parallel/pipeline/p2p.py; ref: apex/transformer/pipeline_parallel/
p2p_communication.py).

Two families, both over the pp group of ``parallel_state``
(``axis_name="pp"``), with the tensors' own shapes and dtypes:

- the JAX functions (``send_forward_recv_forward``,
  ``send_backward_recv_backward``, ``ring_forward``,
  ``ring_send_last_to_first`` and their aliases ``send_forward``,
  ``recv_forward``, ``send_backward``, ``recv_backward``) are collectives
  of the whole pp group with ``ppermute``'s result: every stage passes a
  tensor, each receives its source's along the edges of
  :func:`forward_edges` and the rest, and a stage with no source
  receives zeros;
- the paired operations of the host-driven schedules, as the reference
  has them: :func:`send_forward_recv_backward` and
  :func:`send_backward_recv_forward`, which the last and the first stage
  skip (``None``).

Activations travel under :data:`FORWARD_TAG` and gradients under
:data:`BACKWARD_TAG`, so the two streams between one pair of stages
never cross. Outside a pp group (pp = 1) every function returns what a
one-stage ``ppermute`` would: its input along a ring, zeros along a
chain.
"""

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import parallel_state as ps

__all__ = [
    "BACKWARD_TAG", "FORWARD_TAG", "backward_edges", "forward_edges",
    "last_to_first_edges", "permute", "recv_backward", "recv_forward",
    "ring_edges", "ring_forward", "ring_send_last_to_first", "send_backward",
    "send_backward_recv_backward", "send_backward_recv_forward",
    "send_forward", "send_forward_recv_backward",
    "send_forward_recv_forward",
]

FORWARD_TAG, BACKWARD_TAG = 0, 1


# -- the edge grammar (the JAX module's) -------------------------------------

def forward_edges(n: int) -> List[Tuple[int, int]]:
    """Linear +1 chain: rank r sends to r+1; the last rank sends nowhere."""
    return [(i, i + 1) for i in range(n - 1)]


def backward_edges(n: int) -> List[Tuple[int, int]]:
    """Linear -1 chain: rank r sends to r-1; rank 0 sends nowhere."""
    return [(i + 1, i) for i in range(n - 1)]


def ring_edges(n: int) -> List[Tuple[int, int]]:
    """Full ring: every rank sends to (r+1) mod n."""
    return [(i, (i + 1) % n) for i in range(n)]


def last_to_first_edges(n: int) -> List[Tuple[int, int]]:
    """The single wrap edge closing the ring: rank n-1 to rank 0."""
    return [(n - 1, 0)]


def permute(x: torch.Tensor, edges, axis_name: str = "pp",
            tag: int = FORWARD_TAG) -> torch.Tensor:
    """``ppermute`` of ``x`` over the pp group along ``edges`` ((src,
    dst) stage pairs, a partial permutation): this stage's source's
    ``x``, or zeros where no edge ends here."""
    group = ps.get_group(axis_name)
    me = 0 if group is None else dist.get_rank(group)
    dst = [d for s, d in edges if s == me]
    src = [s for s, d in edges if d == me]
    if group is None:  # one stage: only a self-edge moves data
        return x.clone() if src else torch.zeros_like(x)
    got = ps.p2p(group, [(x, d, tag) for d in dst],
                 [(x, s, tag) for s in src])
    ps.wait_sends()
    return got[0] if got else torch.zeros_like(x)


def send_forward_recv_forward(x: torch.Tensor, axis_name: str = "pp"
                              ) -> torch.Tensor:
    """Ship activations one stage downstream: rank r receives rank r-1's
    ``x``; rank 0 receives zeros."""
    n = ps.group_size(ps.get_group(axis_name))
    return permute(x, forward_edges(n), axis_name, FORWARD_TAG)


def send_backward_recv_backward(g: torch.Tensor, axis_name: str = "pp"
                                ) -> torch.Tensor:
    """Ship gradients one stage upstream: rank r receives rank r+1's
    ``g``; the last stage receives zeros."""
    n = ps.group_size(ps.get_group(axis_name))
    return permute(g, backward_edges(n), axis_name, BACKWARD_TAG)


def ring_forward(x: torch.Tensor, axis_name: str = "pp") -> torch.Tensor:
    """Full ring shift: rank r receives rank r-1's ``x``, rank 0 receives
    rank P-1's."""
    n = ps.group_size(ps.get_group(axis_name))
    return permute(x, ring_edges(n), axis_name, FORWARD_TAG)


def ring_send_last_to_first(x: torch.Tensor, axis_name: str = "pp"
                            ) -> torch.Tensor:
    """The last stage's ``x`` arrives at stage 0; every other stage
    receives zeros."""
    n = ps.group_size(ps.get_group(axis_name))
    return permute(x, last_to_first_edges(n), axis_name, FORWARD_TAG)


# the JAX module's aliases: in an SPMD collective both sides are one call

def recv_forward(x_sent_upstream, axis_name: str = "pp"):
    return send_forward_recv_forward(x_sent_upstream, axis_name)


def send_forward(x, axis_name: str = "pp"):
    return send_forward_recv_forward(x, axis_name)


def recv_backward(g_sent_downstream, axis_name: str = "pp"):
    return send_backward_recv_backward(g_sent_downstream, axis_name)


def send_backward(g, axis_name: str = "pp"):
    return send_backward_recv_backward(g, axis_name)


# -- the paired operations of the host-driven schedules ----------------------

def send_forward_recv_backward(output: torch.Tensor, axis_name: str = "pp"
                               ) -> Optional[torch.Tensor]:
    """Sends this stage's ``output`` to the next stage and receives the
    gradient of it from there (ref p2p_communication.py
    ``send_forward_recv_backward``), both posted before either is waited
    for; the last stage sends and receives nothing and returns None."""
    group = ps.get_group(axis_name)
    if group is None or dist.get_rank(group) == ps.group_size(group) - 1:
        return None
    nxt = dist.get_rank(group) + 1
    got = ps.p2p(group, [(output, nxt, FORWARD_TAG)],
                 [(output, nxt, BACKWARD_TAG)])[0]
    ps.wait_sends()
    return got


def send_backward_recv_forward(input_grad: torch.Tensor,
                               axis_name: str = "pp"
                               ) -> Optional[torch.Tensor]:
    """Sends the gradient of this stage's input to the previous stage and
    receives its next activation from there (ref ``send_backward_recv_
    forward``); the first stage returns None."""
    group = ps.get_group(axis_name)
    if group is None or dist.get_rank(group) == 0:
        return None
    prev = dist.get_rank(group) - 1
    got = ps.p2p(group, [(input_grad, prev, BACKWARD_TAG)],
                 [(input_grad, prev, FORWARD_TAG)])[0]
    ps.wait_sends()
    return got
