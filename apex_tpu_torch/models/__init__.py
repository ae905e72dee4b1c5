"""The GPT model (and the Llama family on it), its loss, its decoding
loop, the pipelined GPT's parts (``models.gpt_pipeline``), BERT, the ResNet family, conversion of JAX weights and training
state, and the import of transformers Llama weights."""

from apex_tpu_torch.models.bert import (
    BertModel,
    Pooler,
    bert_extended_attention_mask,
)
from apex_tpu_torch.models.convert import (
    bert_params_from_jax,
    bert_tp_params_from_jax,
    bottleneck_params_from_jax,
    fused_adam_state_from_jax,
    gpt_params_from_jax,
    gpt_pipeline_params_from_jax,
    gpt_tp_params_from_jax,
    group_norm_params_from_jax,
    moe_params_from_jax,
    multihead_attn_params_from_jax,
    resnet_params_from_jax,
    rnn_params_from_jax,
    scaler_state_from_jax,
)
from apex_tpu_torch.models.generate import (
    beam_search,
    generate,
    sample_next_token,
)
from apex_tpu_torch.models.gpt import (
    Embedding,
    GPTModel,
    gpt2_small_config,
    gpt_loss_fn,
    megatron_bert_345m_config,
    tinyllama_1_1b_config,
)
from apex_tpu_torch.models.hf_import import (
    config_from_hf_llama,
    llama_from_hf,
    mistral_from_hf,
    params_from_hf_llama,
    params_to_hf_llama,
)
from apex_tpu_torch.models.resnet import (
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    ResNet101,
    ResNet152,
    cross_entropy_loss,
)

__all__ = [
    "BertModel", "Embedding", "GPTModel", "Pooler", "ResNet", "ResNet18",
    "beam_search",
    "ResNet34", "ResNet50", "ResNet101", "ResNet152", "bert_extended_attention_mask",
    "bert_params_from_jax", "bert_tp_params_from_jax",
    "bottleneck_params_from_jax", "group_norm_params_from_jax",
    "multihead_attn_params_from_jax", "rnn_params_from_jax",
    "config_from_hf_llama", "cross_entropy_loss",
    "fused_adam_state_from_jax", "generate", "gpt2_small_config",
    "gpt_loss_fn", "gpt_params_from_jax", "gpt_pipeline_params_from_jax",
    "gpt_tp_params_from_jax", "llama_from_hf", "moe_params_from_jax",
    "megatron_bert_345m_config", "mistral_from_hf",
    "params_from_hf_llama", "params_to_hf_llama", "resnet_params_from_jax",
    "sample_next_token", "scaler_state_from_jax", "tinyllama_1_1b_config",
]
