"""Pipeline schedules (counterpart of apex_tpu/parallel/pipeline/
schedules.py; ref: apex/transformer/pipeline_parallel/schedules/).

The JAX schedules are one ``lax.scan`` over clock ticks whose backward is
``jax.grad`` through the scan. Here they are the reference's host-driven
loops: each stage runs its own sequence of forward and backward steps,
one micro-batch (and, interleaved, one model chunk) at a time, in the
reference's order, and talks to its neighbours by point-to-point sends
and receives (``parallel_state.p2p``: sends posted and waited for when
the schedule ends, receives blocking, activations and gradients under
their own tags):

- **1F1B** (``forward_backward_pipelining_without_interleaving``, ref
  fwd_bwd_pipelining_without_interleaving.py): ``P - r - 1`` warm-up
  forwards on stage r, then one forward and one backward in turn, then
  the cool-down backwards; a stage holds at most ``P - r`` micro-batches'
  activations;
- **interleaved** (``forward_backward_pipelining_with_interleaving``,
  ref fwd_bwd_pipelining_with_interleaving.py): chunk v on rank r is
  global stage ``v P + r``; the order is the reference's group-of-P
  depth-first one (virtual micro-batch k runs chunk ``(k mod VP) // P``
  on micro-batch ``(k // VP) P + k mod P``; backwards take the chunks in
  reverse), with ``2 (P - r - 1) + (V - 1) P`` warm-up forwards (all of
  them when M = P). It requires ``M % P == 0``, as JAX does. At P = 2
  with V > 1 both streams run between one ordered pair of ranks, in
  messages of one shape: the gradients then take the pp group's twin
  (``parallel_state.p2p``), so no backend mixes the two streams, tags or
  none;
- **zero bubble** (``forward_backward_zero_bubble``, JAX's B/W split):
  the forward runs JAX's T = M + P - 1 clock ticks (stage r runs
  micro-batch t - r at tick t, nothing on a bubble tick) and keeps every
  micro-batch's input and autograd graph; the backward runs the clock
  reversed (reverse tick q replays tick T - 1 - q, so a stage takes the
  micro-batches last to first). Each tick's cotangent is the last
  stage's loss seed or the gradient received from downstream. B, the
  input's gradient (``torch.autograd.grad(y, x, dy, retain_graph=
  True)``), is sent upstream at once; W, the parameters' gradient
  (``torch.autograd.grad(y, params, dy)``), runs after that send, while
  the message travels, and is summed. Each W call walks the stage's
  graph again, activation gradients included: the split costs one more
  backward pass through the activations. A bubble tick adds nothing,
  JAX's exact zeros. Every micro-batch's graph stays on the stage until
  its backward, as the JAX scan's stash does (under ``remat``, its stage
  input and output only).

A stage's input is a received tensor made a leaf with ``requires_grad``;
its backward is ``torch.autograd.backward(output, grad_tensors=
received_grad)`` restricted to the stage's input and parameters, and the
input's gradient goes upstream. The last stage computes each
micro-batch's loss and backs up ``loss / M``, so the gradients are those
of the mean loss, as JAX's. It then broadcasts the mean loss and the
per-micro-batch losses over the pp group, so every stage returns the
same values (JAX's ``_publish_losses``).

``params`` is a tree (dicts, lists, tuples) of tensors that require
grad, and the gradients come back in its structure, in its dtypes, with
zeros for a tensor the stage does not reach. The parameters' ``.grad``
are left as they were.

``remat=True`` (JAX's default, ``jax.checkpoint`` of the stage function)
runs each stage forward, one micro-batch of one chunk, under
``parallel.random.checkpoint``, and on the last global stage its loss
with it: a micro-batch in flight keeps only its stage input (and the
dropout generators' states), and its backward runs the forward again,
with the same masks. At fp32 the values are bit-equal to ``remat=False``.
Zero bubble walks a stage's graph twice (B, then W), so each walk
recomputes it: two recomputes a micro-batch. ``tick_block_remat = B``
bounds JAX's scan, whose carry stashes one boundary tensor a tick, by
checkpointing blocks of B ticks (O(T / B + B) stashed, with the blocks'
forward run again). A host-driven schedule has no carry; what it keeps a
micro-batch in flight is that boundary tensor under ``remat=True``, at
most P of them in 1F1B. So here ``0 < B < T`` (T the schedule's ticks,
``V M + P - 1``) recomputes each stage forward as ``remat=True`` does,
which is the memory JAX's blocks bound, and B >= T or 0 leaves
``remat`` alone, as JAX's scan falls through to the plain one; a
negative B raises. The boundary tensor a stage receives has the shape and
dtype of the micro-batch input (``stage_fn`` keeps its input's shape,
as the JAX scan requires); ``forward_backward_with_pre_post`` is given
``tensor_shape`` and ``dtype``, as Megatron's schedules are.
"""

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.parallel.pipeline.p2p import BACKWARD_TAG, FORWARD_TAG
from apex_tpu_torch.parallel.random import checkpoint

__all__ = [
    "build_model", "forward_backward_no_pipelining",
    "forward_backward_pipelining_with_interleaving",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_with_pre_post", "forward_backward_zero_bubble",
    "forward_backward_zero_bubble_with_pre_post",
    "get_forward_backward_func", "pipeline_forward",
    "pipeline_forward_interleaved", "schedule_order",
]

Tensors = Dict[str, torch.Tensor]


def _micro(tree: Any, i: int) -> Any:
    """Micro-batch ``i`` of a tensor collection stacked on dim 0."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _micro(v, i) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_micro(v, i) for v in tree)
    raise TypeError(f"not a tensor collection: {type(tree).__name__}")


def _leading_dim(tree: Any) -> int:
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.shape[0]


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def _rebuild(tree: Any, it) -> Any:
    """``tree``'s structure with the next values of the iterator ``it``."""
    if isinstance(tree, torch.Tensor):
        return next(it)
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    return type(tree)(_rebuild(v, it) for v in tree)


def forward_backward_no_pipelining(
        forward_step_fn: Callable[[Tensors, Any], torch.Tensor],
        params: Tensors, microbatches: Any, *,
        grad_sync_fn: Optional[Callable[[Tensors], Tensors]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Tensors]:
    """``forward_step_fn(params, microbatch)`` gives a scalar loss that
    depends on ``params`` (name: tensor requiring grad, e.g.
    ``dict(model.named_parameters())``); ``microbatches`` is a tensor
    collection whose leaves stack the micro-batches on dim 0. The
    gradients are summed over the micro-batches in the parameters' dtype
    (a parameter the loss does not reach gets zeros), divided by their
    number and handed once to ``grad_sync_fn`` (the reference's no_sync on
    all but the last). Returns ``(mean_loss, losses, grads)``; the losses
    are detached.

    The first micro-batch's gradients are the running sum, and the sums
    and the division are multi-tensor operations (``torch._foreach_*``): a
    few launches a step, not one per tensor."""
    num_micro = _leading_dim(microbatches)
    names = list(params)
    acc, losses = None, []
    for i in range(num_micro):
        loss = forward_step_fn(params, _micro(microbatches, i))
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = [torch.zeros_like(params[n]) if g is None else g
                 for n, g in zip(names, grads)]
        acc = grads if acc is None else torch._foreach_add(acc, grads)
        losses.append(loss.detach())
    if num_micro > 1:
        acc = torch._foreach_div(acc, num_micro)
    grads = dict(zip(names, acc))
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    losses = torch.stack(losses)
    return losses.mean(), losses, grads


# -- the host-driven schedules -----------------------------------------------

def schedule_order(num_stages: int, rank: int, num_micro: int,
                   num_model_chunks: int = 1, interleaved: bool = False,
                   forward_only: bool = False) -> List[Tuple[str, int, int]]:
    """Stage ``rank``'s steps, in order, as ``("F" or "B", chunk,
    micro-batch)``: the reference's warm-up, steady 1F1B and cool-down
    phases (module docstring)."""
    P, M, V = num_stages, num_micro, num_model_chunks
    total = M * V
    if forward_only or (interleaved and M == P):
        warmup = total
    elif interleaved:
        warmup = min(2 * (P - rank - 1) + (V - 1) * P, total)
    else:
        warmup = min(P - rank - 1, M)

    def step(kind, k):
        v = (k % (P * V)) // P
        return (kind, V - 1 - v if kind == "B" else v,
                (k // (P * V)) * P + k % P)

    order = [step("F", k) for k in range(warmup)]
    if forward_only:
        return order
    for i in range(total - warmup):
        order += [step("F", warmup + i), step("B", i)]
    order += [step("B", k) for k in range(total - warmup, total)]
    return order


def _chunk(params: Any, v: int, num_model_chunks: int) -> Any:
    """Model chunk ``v``'s parameters: row ``v`` of every leaf of a tree
    stacked on a leading V dim."""
    if num_model_chunks == 1:
        return params
    return _rebuild(params, iter([t[v] for t in _leaves(params)]))


def _recomputes(remat: bool, tick_block_remat: int, num_ticks: int) -> bool:
    """Does each stage forward run under a checkpoint? (module
    docstring: ``remat``, or a block of ticks shorter than the run)"""
    if tick_block_remat < 0:
        raise ValueError(f"tick_block_remat must be >= 0, got "
                         f"{tick_block_remat}")
    return remat or 0 < tick_block_remat < num_ticks


def _stage_loss(stage_fn, loss_fn, params, x, m):
    return loss_fn(stage_fn(params, x), m)


def _run(stage_fn: Callable, params: Any, first_input: Callable[[int], Any],
         loss_fn: Optional[Callable[[Any, int], torch.Tensor]], like: Any,
         num_micro: int, num_model_chunks: int, interleaved: bool,
         axis_name: str, leaves: Sequence[torch.Tensor], remat: bool,
         tick_block_remat: int):
    """Runs this stage's steps. ``first_input(m)`` is global stage 0's
    input of micro-batch m; ``loss_fn(y, m)`` the last global stage's
    loss of its output (None: forward only). Returns ``(outputs, losses,
    grads)``: the last stage's outputs (forward only) or per-micro-batch
    losses, and the gradients of ``leaves`` (None when forward only)."""
    group = ps.get_group(axis_name)
    P = ps.group_size(group)
    r = 0 if group is None else dist.get_rank(group)
    V, M = num_model_chunks, num_micro
    forward_only = loss_fn is None
    run_stage, run_stage_loss = stage_fn, functools.partial(
        _stage_loss, stage_fn, loss_fn)
    if _recomputes(remat, tick_block_remat, V * M + P - 1):
        run_stage, run_stage_loss = (checkpoint(run_stage),
                                     checkpoint(run_stage_loss))
    last_stage = V * P - 1
    prev, nxt = (r - 1) % P, (r + 1) % P
    # one stage with V chunks: its ring edge is these FIFOs
    ring = {FORWARD_TAG: [], BACKWARD_TAG: []}

    def send(t, peer, tag):
        if P > 1:
            ps.p2p(group, [(t, peer, tag)])
        else:
            ring[tag].append(t.detach())

    def recv(like, peer, tag):
        if P > 1:
            return ps.p2p(group, (), [(like, peer, tag)])[0]
        return ring[tag].pop(0)

    stash = [[] for _ in range(V)]
    outputs, losses = {}, {}
    wanted = [t for t in leaves if t.requires_grad]
    old = [t.grad for t in wanted]
    for t in wanted:
        t.grad = None
    try:
        for kind, v, m in schedule_order(P, r, M, V, interleaved,
                                         forward_only):
            g = v * P + r
            if kind == "F":
                if g == 0:
                    x = first_input(m)
                else:
                    x = recv(like, prev, FORWARD_TAG)
                    if not forward_only:
                        x.requires_grad_(True)
                if g == last_stage and not forward_only:
                    loss = run_stage_loss(_chunk(params, v, V), x, m)
                    losses[m] = loss.detach().float()
                    stash[v].append((x, loss / M, g))
                    continue
                y = run_stage(_chunk(params, v, V), x)
                if g == last_stage:
                    outputs[m] = y
                    continue
                send(y, nxt, FORWARD_TAG)
                if not forward_only:
                    stash[v].append((x, y, g))
                continue
            x, y, g = stash[v].pop(0)
            inputs = wanted + ([x] if g > 0 else [])
            if g == last_stage:
                torch.autograd.backward(y, inputs=inputs)
            else:
                torch.autograd.backward(
                    y, grad_tensors=recv(y, nxt, BACKWARD_TAG),
                    inputs=inputs)
            if g > 0:
                send(torch.zeros_like(x) if x.grad is None else x.grad,
                     prev, BACKWARD_TAG)
        grads = None if forward_only else [
            torch.zeros_like(t) if t.grad is None else t.grad
            for t in wanted]
    finally:
        for t, o in zip(wanted, old):
            t.grad = o
    ps.wait_sends()
    if grads is not None:  # zeros for what does not require grad
        it = iter(grads)
        grads = [next(it) if t.requires_grad else torch.zeros_like(t)
                 for t in leaves]
    return outputs, losses, grads


def _publish_losses(losses: Dict[int, torch.Tensor], num_micro: int,
                    axis_name: str, device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """The last stage's mean loss and per-micro-batch losses on every
    stage of the pp group (one broadcast)."""
    group = ps.get_group(axis_name)
    if losses:
        per = torch.stack([losses[m] for m in range(num_micro)])
        packed = torch.cat([per.mean()[None], per])
    else:
        packed = torch.zeros(num_micro + 1, dtype=torch.float32,
                             device=device)
    packed = ps.broadcast(packed, group, ps.group_size(group) - 1)
    return packed[0], packed[1:]


def _device(tree: Any):
    return _leaves(tree)[0].device


def pipeline_forward(stage_fn: Callable[[Any, Any], Any], params: Any,
                     microbatches: Any, *, axis_name: str = "pp",
                     remat: bool = True, tick_block_remat: int = 0
                     ) -> Optional[torch.Tensor]:
    """Runs M micro-batches (a tensor stacked on dim 0, read on the first
    stage only, its shape on every stage) through the P stages, forward
    only. Returns the last stage's outputs stacked on dim 0 on the last
    stage, and None on every other stage (where JAX returns bubble
    garbage). The outputs carry the last stage's own autograd graph, not
    the other stages'."""
    outputs, _, _ = _run(stage_fn, params, lambda m: microbatches[m], None,
                         microbatches[0], _leading_dim(microbatches), 1,
                         False, axis_name, (), remat, tick_block_remat)
    return torch.stack([outputs[m] for m in sorted(outputs)]) \
        if outputs else None


def _check_interleaved(num_micro: int, num_model_chunks: int,
                       axis_name: str) -> None:
    group = ps.get_group(axis_name)
    P = ps.group_size(group)
    if num_micro % P != 0:
        raise ValueError(
            f"interleaved schedule requires num_microbatches ({num_micro}) "
            f"% pipeline size ({P}) == 0")


def pipeline_forward_interleaved(
        stage_fn: Callable[[Any, Any], Any], params_chunks: Any,
        microbatches: Any, *, num_model_chunks: int, axis_name: str = "pp",
        remat: bool = True, tick_block_remat: int = 0
) -> Optional[torch.Tensor]:
    """:func:`pipeline_forward` over this rank's ``num_model_chunks``
    chunks (a tree stacked on a leading V dim; chunk v is global stage
    ``v P + rank``) in the interleaved order. Requires ``M % P == 0``.
    The last stage's outputs on rank P-1, None elsewhere."""
    num_micro = _leading_dim(microbatches)
    _check_interleaved(num_micro, num_model_chunks, axis_name)
    outputs, _, _ = _run(stage_fn, params_chunks, lambda m: microbatches[m],
                         None, microbatches[0], num_micro, num_model_chunks,
                         True, axis_name, (), remat, tick_block_remat)
    return torch.stack([outputs[m] for m in sorted(outputs)]) \
        if outputs else None


def forward_backward_pipelining_without_interleaving(
        stage_fn: Callable[[Any, Any], Any],
        loss_fn: Callable[[Any, Any], torch.Tensor], params: Any,
        microbatches: Any, targets: Any, *, axis_name: str = "pp",
        remat: bool = True, tick_block_remat: int = 0,
        grad_sync_fn: Optional[Callable[[Any], Any]] = None):
    """1F1B (module docstring). ``loss_fn(last_stage_output, target)``
    gives each micro-batch's scalar loss on the last stage. Returns
    ``(loss, per_microbatch_losses, grads)``, the same loss and losses on
    every stage and this stage's gradients of the mean loss."""
    num_micro = _leading_dim(microbatches)
    leaves = _leaves(params)
    _, losses, grads = _run(
        stage_fn, params, lambda m: microbatches[m],
        lambda y, m: loss_fn(y, _micro(targets, m)), microbatches[0],
        num_micro, 1, False, axis_name, leaves, remat, tick_block_remat)
    grads = _rebuild(params, iter(grads))
    loss, per = _publish_losses(losses, num_micro, axis_name,
                                _device(params))
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    return loss, per, grads


def forward_backward_pipelining_with_interleaving(
        stage_fn: Callable[[Any, Any], Any],
        loss_fn: Callable[[Any, Any], torch.Tensor], params_chunks: Any,
        microbatches: Any, targets: Any, *, num_model_chunks: int,
        axis_name: str = "pp", remat: bool = True, tick_block_remat: int = 0,
        grad_sync_fn: Optional[Callable[[Any], Any]] = None):
    """The interleaved schedule (module docstring) over this rank's
    ``num_model_chunks`` chunks (a tree stacked on a leading V dim: chunk
    v is global stage ``v P + rank``). Requires ``M % P == 0``. Returns as
    1F1B does, the gradients in ``params_chunks``'
    structure."""
    num_micro = _leading_dim(microbatches)
    _check_interleaved(num_micro, num_model_chunks, axis_name)
    leaves = _leaves(params_chunks)
    _, losses, grads = _run(
        stage_fn, params_chunks, lambda m: microbatches[m],
        lambda y, m: loss_fn(y, _micro(targets, m)), microbatches[0],
        num_micro, num_model_chunks, True, axis_name, leaves, remat,
        tick_block_remat)
    grads = _rebuild(params_chunks, iter(grads))
    loss, per = _publish_losses(losses, num_micro, axis_name,
                                _device(params_chunks))
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    return loss, per, grads


def _combine_replicated_grads(tree: Any, axis_name: str) -> Any:
    """The pp sum of pp-replicated parameters' gradients (non-zero on one
    stage only): JAX's ``_combine_replicated_grads``, one all-reduce per
    dtype."""
    from apex_tpu_torch.parallel.ddp import all_reduce_gradients

    group = ps.get_group(axis_name)
    leaves = _leaves(tree)
    if group is None or not leaves:
        return tree
    summed = all_reduce_gradients(
        {str(i): t for i, t in enumerate(leaves)}, group,
        gradient_average=False)
    return _rebuild(tree, iter(summed.values()))


def forward_backward_with_pre_post(
        pre_fn: Callable[[Any, Any], Any], stage_fn: Callable[[Any, Any], Any],
        post_loss_fn: Callable[[Any, Any, Any], torch.Tensor],
        params: Dict[str, Any], inputs: Any, targets: Any, *,
        axis_name: str = "pp", remat: bool = True, num_model_chunks: int = 1,
        tick_block_remat: int = 0,
        grad_sync_fn: Optional[Callable[[Any], Any]] = None,
        tensor_shape: Sequence[int], dtype: torch.dtype):
    """The full model in one schedule: ``params`` is ``{"pre": ...,
    "stages": ..., "post": ...}``. ``pre`` (the embedding) runs on global
    stage 0 and ``post`` (final norm, head and loss) on the last one; both
    are replicated over pp, and their gradients (non-zero on one stage)
    are summed over the pp group. ``stages`` is this rank's chunk (its
    leaves stacked on a leading V dim when ``num_model_chunks`` > 1: 1F1B
    at V = 1, the interleaved schedule above). ``pre_fn(pre, input_mb) ->
    h``, ``stage_fn(chunk, h) -> h``, ``post_loss_fn(post, h, target_mb)
    -> scalar``. ``tensor_shape`` and ``dtype`` are those of ``h``, which
    a stage must know before it receives it. Returns ``(loss,
    per_microbatch_losses, grads)`` with ``grads`` shaped as ``params``."""
    num_micro = _leading_dim(inputs)
    V = num_model_chunks
    if V > 1:
        _check_interleaved(num_micro, V, axis_name)
    device = _device(params["stages"])
    like = torch.empty(tuple(tensor_shape), dtype=dtype, device=device)
    leaves = _leaves(params)
    _, losses, grads = _run(
        stage_fn, params["stages"],
        lambda m: pre_fn(params["pre"], _micro(inputs, m)),
        lambda y, m: post_loss_fn(params["post"], y, _micro(targets, m)),
        like, num_micro, V, V > 1, axis_name, leaves, remat,
        tick_block_remat)
    grads = _rebuild(params, iter(grads))
    for part in ("pre", "post"):
        grads[part] = _combine_replicated_grads(grads[part], axis_name)
    loss, per = _publish_losses(losses, num_micro, axis_name, device)
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    return loss, per, grads


# -- zero bubble (the B/W split) ----------------------------------------------

def _grad_or_zeros(outputs, inputs, grad_outputs, retain_graph=False):
    """``torch.autograd.grad`` with zeros for an input the outputs do not
    reach; ``[]`` for no inputs."""
    if not inputs:
        return []
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, got)]


def _accumulate(acc, grads):
    """``acc + grads`` elementwise over two lists (``grads`` when ``acc``
    is None)."""
    return grads if acc is None or not grads else torch._foreach_add(
        acc, grads)


def _zb_run(stage_fn: Callable, params: Any,
            first_input: Callable[[int], torch.Tensor],
            loss_fn: Callable[[Any, int], torch.Tensor], like: Any,
            num_micro: int, axis_name: str, leaves: Sequence[torch.Tensor],
            remat: bool, tick_block_remat: int,
            head: Sequence[torch.Tensor] = (), keep_dx: bool = False):
    """This stage's zero-bubble pass (module docstring). ``first_input(m)``
    is stage 0's input of micro-batch m; ``loss_fn(y, m)`` the last
    stage's loss of its output. Returns ``(losses, grads, head_grads,
    dxs)``: the last stage's per-micro-batch losses, the gradients of the
    mean loss for ``leaves`` and (on the last stage, zeros elsewhere)
    ``head``, and with ``keep_dx`` stage 0's input gradient by
    micro-batch."""
    group = ps.get_group(axis_name)
    P = ps.group_size(group)
    r = 0 if group is None else dist.get_rank(group)
    M, T = num_micro, num_micro + P - 1
    last = r == P - 1
    wanted = [t for t in leaves if t.requires_grad]
    head_wanted = [t for t in head if t.requires_grad]
    stash, losses, seeds, dxs = {}, {}, {}, {}
    acc = head_acc = None
    run_stage = stage_fn
    if _recomputes(remat, tick_block_remat, T):
        run_stage = checkpoint(stage_fn)
    for t in range(T):
        u = t - r  # the micro-batch of this stage's tick t
        if not 0 <= u < M:
            continue  # a bubble tick
        if r == 0:
            x = first_input(u)
        else:
            x = ps.p2p(group, (), [(like, r - 1, FORWARD_TAG)])[0]
            x.requires_grad_(True)
        y = run_stage(params, x)
        if not last:
            ps.p2p(group, [(y, r + 1, FORWARD_TAG)])
        stash[u] = (x, y)
    if last:
        # the loss seeds d(mean loss)/dy, one micro-batch at a time
        for u in range(M):
            y = stash[u][1].detach().requires_grad_(True)
            loss = loss_fn(y, u)
            losses[u] = loss.detach().float()
            dy, *dh = _grad_or_zeros(loss / M, [y] + head_wanted, None)
            seeds[u] = dy
            head_acc = _accumulate(head_acc, dh)
    for q in range(T):
        u = T - 1 - q - r  # reverse tick q replays forward tick T-1-q
        if not 0 <= u < M:
            continue
        x, y = stash.pop(u)
        dy = (seeds.pop(u) if last
              else ps.p2p(group, (), [(y, r + 1, BACKWARD_TAG)])[0])
        if r > 0 or keep_dx:
            # B: the input's gradient, sent upstream at once
            (dx,) = _grad_or_zeros(y, [x], dy, retain_graph=True)
            if r > 0:
                ps.p2p(group, [(dx, r - 1, BACKWARD_TAG)])
            else:
                dxs[u] = dx
        # W: the parameters' gradient, while the edge is in flight
        acc = _accumulate(acc, _grad_or_zeros(y, wanted, dy))
    ps.wait_sends()
    it = iter(acc if acc is not None else [])
    grads = [next(it) if t.requires_grad else torch.zeros_like(t)
             for t in leaves]
    it = iter(head_acc if head_acc is not None else [])
    head_grads = [next(it) if t.requires_grad and last
                  else torch.zeros_like(t) for t in head]
    return losses, grads, head_grads, dxs


def forward_backward_zero_bubble(
        stage_fn: Callable[[Any, Any], Any],
        loss_fn: Callable[[Any, Any], torch.Tensor], params: Any,
        microbatches: Any, targets: Any, *, axis_name: str = "pp",
        remat: bool = True, tick_block_remat: int = 0,
        grad_sync_fn: Optional[Callable[[Any], Any]] = None):
    """The zero-bubble schedule (module docstring): the signature and the
    gradients of :func:`forward_backward_pipelining_without_interleaving`,
    its backward split into B and W. ``algebra.zero_bubble_cost(P, M)``
    counts its ticks. W repeats B's walk through the activations (module
    docstring), so a step costs more than 1F1B's: one more activation
    backward a micro-batch, with its kernels and SP collectives. Returns
    ``(loss, per_microbatch_losses, grads)``."""
    num_micro = _leading_dim(microbatches)
    leaves = _leaves(params)
    losses, grads, _, _ = _zb_run(
        stage_fn, params, lambda m: microbatches[m],
        lambda y, m: loss_fn(y, _micro(targets, m)), microbatches[0],
        num_micro, axis_name, leaves, remat, tick_block_remat)
    grads = _rebuild(params, iter(grads))
    loss, per = _publish_losses(losses, num_micro, axis_name,
                                _device(params))
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    return loss, per, grads


def forward_backward_zero_bubble_with_pre_post(
        pre_fn: Callable[[Any, Any], Any], stage_fn: Callable[[Any, Any], Any],
        post_loss_fn: Callable[[Any, Any, Any], torch.Tensor],
        params: Dict[str, Any], inputs: Any, targets: Any, *,
        axis_name: str = "pp", remat: bool = True, tick_block_remat: int = 0,
        grad_sync_fn: Optional[Callable[[Any], Any]] = None,
        tensor_shape: Sequence[int], dtype: torch.dtype):
    """:func:`forward_backward_with_pre_post` with the zero-bubble
    backward: ``pre`` on stage 0, the stages, ``post`` and the loss on the
    last stage, gradients equal to 1F1B's. The last stage's seeds come
    from the head's loss, and stage 0's input gradient of micro-batch m
    (reverse tick (M-1-m) + (P-1)) is the embedding output's cotangent,
    which ``pre``'s backward takes once the pass ends. The pre and post
    gradients are summed over pp. ``tensor_shape`` and ``dtype`` are
    those of the hidden states between stages. Like
    :func:`forward_backward_zero_bubble` it costs more than 1F1B: W
    repeats B's activation backward."""
    num_micro = _leading_dim(inputs)
    device = _device(params["stages"])
    like = torch.empty(tuple(tensor_shape), dtype=dtype, device=device)
    embedded = {}

    def first_input(m):
        embedded[m] = pre_fn(params["pre"], _micro(inputs, m))
        return embedded[m].detach().requires_grad_(True)

    losses, stage_grads, post_grads, dxs = _zb_run(
        stage_fn, params["stages"], first_input,
        lambda y, m: post_loss_fn(params["post"], y, _micro(targets, m)),
        like, num_micro, axis_name, _leaves(params["stages"]), remat,
        tick_block_remat, head=_leaves(params["post"]), keep_dx=True)
    pre_leaves = _leaves(params["pre"])
    pre_wanted = [t for t in pre_leaves if t.requires_grad]
    acc = None
    for m in sorted(dxs):  # stage 0 only
        acc = _accumulate(acc, _grad_or_zeros(embedded.pop(m), pre_wanted,
                                              dxs[m]))
    it = iter(acc if acc is not None else [])
    pre_grads = [next(it) if t.requires_grad and acc is not None
                 else torch.zeros_like(t) for t in pre_leaves]
    grads = {
        "pre": _combine_replicated_grads(
            _rebuild(params["pre"], iter(pre_grads)), axis_name),
        "stages": _rebuild(params["stages"], iter(stage_grads)),
        "post": _combine_replicated_grads(
            _rebuild(params["post"], iter(post_grads)), axis_name),
    }
    loss, per = _publish_losses(losses, num_micro, axis_name, device)
    if grad_sync_fn is not None:
        grads = grad_sync_fn(grads)
    return loss, per, grads


def get_forward_backward_func(
        virtual_pipeline_model_parallel_size: Optional[int],
        pipeline_model_parallel_size: int,
        zero_bubble: bool = False) -> Callable:
    """Schedule dispatcher (ref: schedules/__init__.py:22): interleaved iff
    virtual pp is set, 1F1B iff pp > 1 (the zero-bubble B/W split with
    ``zero_bubble``), else plain gradient accumulation, with the JAX
    function's errors (virtual pp has no zero-bubble variant). The
    zero-bubble function's W pass repeats B's activation backward, so it
    is slower than 1F1B, not faster (:func:`forward_backward_zero_bubble`)."""
    if virtual_pipeline_model_parallel_size is not None:
        if pipeline_model_parallel_size <= 1:
            raise ValueError(
                "virtual pipeline parallelism requires "
                "pipeline_model_parallel_size > 1")
        if zero_bubble:
            raise ValueError(
                "zero_bubble has no interleaved variant: pick virtual PP "
                "(bubble/V) or the B/W split, not both")
        return functools.partial(
            forward_backward_pipelining_with_interleaving,
            num_model_chunks=virtual_pipeline_model_parallel_size)
    if pipeline_model_parallel_size > 1:
        if zero_bubble:
            return forward_backward_zero_bubble
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


def build_model(model_provider_func: Callable[..., Any], pipeline_rank: int,
                pipeline_world_size: int,
                virtual_pipeline_model_parallel_size: Optional[int] = None,
                **kwargs) -> List[Any]:
    """This stage's model chunk(s), each built by
    ``model_provider_func(pre_process=..., post_process=..., **kwargs)``
    (ref: schedules/common.py:30-108): ``pre_process`` only for global
    stage 0, ``post_process`` only for the last; chunk v on rank r is
    global stage ``v P + r``."""
    v = virtual_pipeline_model_parallel_size or 1
    chunks = []
    for chunk_id in range(v):
        global_stage = chunk_id * pipeline_world_size + pipeline_rank
        chunks.append(model_provider_func(
            pre_process=global_stage == 0,
            post_process=global_stage == v * pipeline_world_size - 1,
            **kwargs))
    return chunks
