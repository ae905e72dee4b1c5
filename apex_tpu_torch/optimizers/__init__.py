"""Optimizers, each a transform of the optax shape (``init`` and
``update`` over dicts of named tensors): fused Adam on the hand-written
Adam kernel, ZeRO-2 Adam at a data-parallel world of one, which clips
with the hand-written sum-of-squares kernel, fused LAMB (its norms on
the sum-of-squares kernel), and, plain torch as in JAX, momentum SGD,
NovoGrad, Adagrad, LARC and Adam with weight averaging;
``clip_grad_norm``."""

from apex_tpu_torch.optimizers._fused_kernels import (
    adam_flat,
    l2norm_flat,
    sumsq_flat,
)
from apex_tpu_torch.optimizers.clip_grad import clip_grad_norm
from apex_tpu_torch.optimizers.distributed_fused_adam import (
    DistributedFusedAdam,
    DistributedFusedAdamState,
    distributed_fused_adam,
)
from apex_tpu_torch.optimizers.fused_adagrad import (
    FusedAdagrad,
    FusedAdagradState,
    fused_adagrad,
)
from apex_tpu_torch.optimizers.fused_adam import (
    AdamTransform,
    FusedAdam,
    FusedAdamState,
    fused_adam,
)
from apex_tpu_torch.optimizers.fused_adam_swa import (
    FusedAdamSWA,
    FusedAdamSWAState,
    fused_adam_swa,
    swa_params,
)
from apex_tpu_torch.optimizers.fused_lamb import (
    FusedLAMB,
    FusedLAMBState,
    FusedMixedPrecisionLamb,
    fused_lamb,
)
from apex_tpu_torch.optimizers.fused_novograd import (
    FusedNovoGrad,
    FusedNovoGradState,
    fused_novograd,
)
from apex_tpu_torch.optimizers.fused_sgd import (
    FusedSGD,
    FusedSGDState,
    SGDTransform,
    fused_sgd,
)
from apex_tpu_torch.optimizers.larc import LARC, LARCState, larc, \
    larc_scaling
from apex_tpu_torch.optimizers.transform import Transform, chain

__all__ = ["AdamTransform", "DistributedFusedAdam",
           "DistributedFusedAdamState", "FusedAdagrad", "FusedAdagradState",
           "FusedAdam", "FusedAdamSWA", "FusedAdamSWAState",
           "FusedAdamState", "FusedLAMB", "FusedLAMBState",
           "FusedMixedPrecisionLamb", "FusedNovoGrad", "FusedNovoGradState",
           "FusedSGD", "FusedSGDState", "LARC", "LARCState", "SGDTransform",
           "Transform", "adam_flat", "chain", "clip_grad_norm",
           "distributed_fused_adam", "fused_adagrad", "fused_adam",
           "fused_adam_swa", "fused_lamb", "fused_novograd", "fused_sgd",
           "l2norm_flat", "larc", "larc_scaling", "sumsq_flat",
           "swa_params"]
