"""2:4 structured sparsity (counterpart of
apex_tpu/contrib/sparsity/__init__.py; ref: apex.contrib.sparsity)."""

from apex_tpu_torch.contrib.sparsity.asp import (
    ASP,
    MaskedState,
    compute_sparse_masks,
    default_eligibility,
    masked_update,
    prune,
    replace_masks,
)
from apex_tpu_torch.contrib.sparsity.permutation import (
    apply_permutation,
    exhaustive_search,
    invert_permutation,
    permute_and_mask,
    search_for_good_permutation,
)
from apex_tpu_torch.contrib.sparsity.sparse_masklib import (
    create_mask,
    fill,
    m4n2_1d,
    m4n2_2d_best,
    mn_1d_best,
    mn_2d_best,
)

__all__ = [
    "ASP",
    "MaskedState",
    "compute_sparse_masks",
    "default_eligibility",
    "masked_update",
    "prune",
    "replace_masks",
    "apply_permutation",
    "invert_permutation",
    "exhaustive_search",
    "permute_and_mask",
    "search_for_good_permutation",
    "create_mask",
    "fill",
    "m4n2_1d",
    "m4n2_2d_best",
    "mn_1d_best",
    "mn_2d_best",
]
