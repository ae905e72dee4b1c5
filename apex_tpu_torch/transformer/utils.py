"""Training-loop utilities (counterpart of apex_tpu/transformer/utils.py;
ref: apex/transformer/pipeline_parallel/utils.py).

- :func:`average_losses_across_data_parallel_group` — the dp mean of
  losses;
- :func:`calc_params_l2_norm` — the tp-aware global parameter norm;
- :func:`get_ltor_masks_and_position_ids` — GPT input preprocessing;
- :func:`report_memory` — the card's allocated and peak bytes;
- :func:`print_params_min_max_norm` — min, max and norm a parameter.
"""

from typing import Any, Callable, Optional, Tuple

import torch

from apex_tpu_torch.parallel import parallel_state as ps
from apex_tpu_torch.utils.pytree import (
    leaf_order,
    tree_leaves,
    tree_leaves_with_path,
)

__all__ = ["average_losses_across_data_parallel_group",
           "calc_params_l2_norm", "get_ltor_masks_and_position_ids",
           "print_params_min_max_norm", "report_memory"]


def average_losses_across_data_parallel_group(losses, group="dp"
                                              ) -> torch.Tensor:
    """The losses stacked in fp32 and averaged over the data-parallel
    group (``"dp"``: ``parallel_state``'s; None: no collective), as one
    all-reduce (ref :242)."""
    stacked = torch.stack([torch.as_tensor(loss, dtype=torch.float32)
                           .reshape(()) for loss in losses])
    if group == "dp":
        group = ps.get_data_parallel_group()
    return ps.all_reduce(stacked, group) / ps.group_size(group)


def calc_params_l2_norm(params: Any,
                        tp_duplicate_predicate: Optional[
                            Callable[[str], bool]] = None,
                        group=None) -> torch.Tensor:
    """Global L2 norm of a tensor collection, summed in fp32 leaf by leaf
    in the JAX leaf order; a 0-d tensor on the leaves' device.

    With ``group`` (the tensor-parallel group) the ranks' partial sums are
    all-reduced over it, and ``tp_duplicate_predicate(path)`` marks the
    tp-replicated tensors (norms, the position table, row-parallel
    biases), counted on tp rank 0 only (the reference's
    ``tensor_model_parallel`` attribute check). ``path`` is a dict key
    with ``/`` for ``.``, as the JAX function joins a tree path; the
    predicate needs ``params`` to be a dict."""
    counted_here = group is None or torch.distributed.get_rank(group) == 0
    if group is not None and tp_duplicate_predicate is not None:
        if not isinstance(params, dict):
            raise TypeError("a tp_duplicate_predicate needs a dict of "
                            "tensors by name")
        items = [(n, params[n]) for n in leaf_order(params)]
    else:
        items = [(None, p) for p in tree_leaves(params)]
    total = 0.0
    for name, p in items:
        sq = p.float().square().sum()
        if name is not None and not counted_here and \
                tp_duplicate_predicate(name.replace(".", "/")):
            sq = torch.zeros_like(sq)
        total = total + sq
    total = torch.as_tensor(total, dtype=torch.float32)
    if group is not None:
        total = ps.all_reduce(total, group)
    return torch.sqrt(total)


def get_ltor_masks_and_position_ids(
        data: torch.Tensor, eod_token: int,
        reset_position_ids: bool = False,
        reset_attention_mask: bool = False,
        eod_mask_loss: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Left-to-right LM masks (ref :303) of ``data`` (b, s) tokens:
    ``(attention_mask, loss_mask, position_ids)``, the mask True where a
    score is MASKED, ``(b or 1, 1, s, s)``. The document-reset variants
    restart positions after each EOD token and keep attention within a
    document, by cumulative counts (no loop over tokens), as JAX's."""
    b, s = data.shape
    dev = data.device
    causal = torch.triu(torch.ones(s, s, dtype=torch.bool, device=dev), 1)
    loss_mask = torch.ones(b, s, dtype=torch.float32, device=dev)
    is_eod = data == eod_token
    if eod_mask_loss:
        loss_mask = torch.where(is_eod, torch.zeros_like(loss_mask),
                                loss_mask)
    idx = torch.arange(s, device=dev).expand(b, s)
    position_ids = idx
    # docs[i]: the EODs strictly before position i
    docs = torch.cumsum(is_eod.long(), dim=1) - is_eod.long()
    if reset_position_ids:
        # doc_start[i] = (the last EOD strictly before i) + 1, a shifted
        # running max
        marker = torch.where(is_eod, idx, torch.full_like(idx, -1))
        last_eod = torch.cummax(marker, dim=1).values
        prev_last = torch.cat([torch.full((b, 1), -1, dtype=last_eod.dtype,
                                          device=dev), last_eod[:, :-1]], 1)
        position_ids = idx - (prev_last + 1)
    if reset_attention_mask:
        same_doc = docs[:, :, None] == docs[:, None, :]
        attention_mask = causal[None] | ~same_doc
    else:
        attention_mask = causal.expand(1, s, s)
    return attention_mask[:, None], loss_mask, position_ids


def report_memory(name: str) -> str:
    """(ref :253) The card's allocated and peak MB (``cuda:i`` each
    visible card; the CPU reports none, as JAX's CPU devices report 0),
    printed and returned."""
    mb = 1024.0 * 1024.0
    parts = [f"{name} memory (MB)"]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            parts.append(
                f"| cuda:{i} in_use: "
                f"{torch.cuda.memory_allocated(i) / mb:.1f} peak: "
                f"{torch.cuda.max_memory_allocated(i) / mb:.1f}")
    else:
        parts.append("| cpu:0 in_use: 0.0 peak: 0.0")
    text = " ".join(parts)
    print(text, flush=True)
    return text


def print_params_min_max_norm(params: Any, iteration: int) -> str:
    """(ref :265) One line a parameter, in the JAX leaf order: iteration,
    index, min, max and 2-norm in fp32; printed and returned."""
    lines = ["iteration, index, min, max, norm"]
    for i, (_, p) in enumerate(tree_leaves_with_path(params)):
        pf = p.detach().float()
        lines.append(f"{iteration:7d}, {i:4d}, {float(pf.min()):.6E}, "
                     f"{float(pf.max()):.6E}, "
                     f"{float(torch.linalg.vector_norm(pf)):.6E}")
    text = "\n".join(lines)
    print(text, flush=True)
    return text
