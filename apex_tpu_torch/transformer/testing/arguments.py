"""Megatron-style arguments for the standalone BERT (counterpart of
apex_tpu/transformer/testing/arguments.py).

Only the flags the port reads: those of ``transformer_config_from_args``
and of ``standalone_bert``'s model, data and optimizer, with the
reference's names and defaults, so the same launch line works on both
for what the port supports. Any other flag of the reference is unknown
here and fails the parse (``ignore_unknown_args`` passes it by), so no
run accepts a knob it would not honour. What differs:
- ``params_dtype`` is a torch dtype (``--fp16``/``--bf16`` map as in the
  reference); ``transformer_config_from_args`` makes it the compute
  dtype, and parameters stay fp32;
- the port runs in one process. ``world_size`` is ``WORLD_SIZE`` when it
  is set, else the model-parallel size the flags ask for, so a tensor or
  pipeline size the port lacks reaches the entry point's refusal
  (``standalone_bert.run_bert``) instead of being clamped away.
"""

import argparse
import os

import torch


def parse_args(extra_args_provider=None, defaults={}, override_args={},
               ignore_unknown_args=False, args=None):
    """Parse the arguments (ref arguments.py:23-120).

    ``args``: optional explicit argv list (the reference reads sys.argv;
    tests pass lists).
    """
    parser = argparse.ArgumentParser(description="Megatron-LM Arguments",
                                     allow_abbrev=False)
    add = parser.add_argument
    # network size
    add("--num-layers", type=int, default=None)
    add("--hidden-size", type=int, default=None)
    add("--ffn-hidden-size", type=int, default=None)
    add("--num-attention-heads", type=int, default=None)
    add("--max-position-embeddings", type=int, default=None)
    add("--make-vocab-size-divisible-by", type=int, default=128)
    add("--layernorm-epsilon", type=float, default=1e-5)
    add("--bert-no-binary-head", action="store_false",
        dest="bert_binary_head")
    # regularization and the optimizer
    add("--attention-dropout", type=float, default=0.1)
    add("--hidden-dropout", type=float, default=0.1)
    add("--weight-decay", type=float, default=0.01)
    add("--adam-beta1", type=float, default=0.9)
    add("--adam-beta2", type=float, default=0.999)
    add("--adam-eps", type=float, default=1e-8)
    add("--lr", type=float, default=None)
    # training and data
    add("--micro-batch-size", type=int, default=None)
    add("--global-batch-size", type=int, default=None)
    add("--train-iters", type=int, default=None)
    add("--seq-length", type=int, default=None)
    add("--seed", type=int, default=1234)
    # mixed precision
    add("--fp16", action="store_true")
    add("--bf16", action="store_true")
    # distributed
    add("--tensor-model-parallel-size", type=int, default=1)
    add("--pipeline-model-parallel-size", type=int, default=1)
    add("--sequence-parallel", action="store_true")

    if extra_args_provider is not None:
        parser = extra_args_provider(parser)

    if ignore_unknown_args:
        parsed, _ = parser.parse_known_args(args)
    else:
        parsed = parser.parse_args(args)

    # apply defaults that were not explicitly set on the command line
    for key, value in defaults.items():
        if getattr(parsed, key, None) is None:
            setattr(parsed, key, value)

    return validate_args(parsed, override_args)


def validate_args(args, override_args={}):
    """The reference's post-parse derivations (arguments.py:60-320) of
    the flags above."""
    for key in override_args:
        setattr(args, key, override_args[key])

    world = os.getenv("WORLD_SIZE")
    args.world_size = (
        int(world) if world is not None
        else args.tensor_model_parallel_size
        * args.pipeline_model_parallel_size
    )

    # tensor/pipeline sizes clamp to the world like the reference
    args.tensor_model_parallel_size = min(
        args.tensor_model_parallel_size, args.world_size
    )
    assert args.world_size % args.tensor_model_parallel_size == 0, (
        f"world size ({args.world_size}) is not divisible by tensor model "
        f"parallel size ({args.tensor_model_parallel_size})"
    )
    args.pipeline_model_parallel_size = min(
        args.pipeline_model_parallel_size,
        args.world_size // args.tensor_model_parallel_size,
    )
    model_parallel_size = (
        args.pipeline_model_parallel_size * args.tensor_model_parallel_size
    )
    assert args.world_size % model_parallel_size == 0, (
        f"world size ({args.world_size}) is not divisible by tensor "
        f"({args.tensor_model_parallel_size}) times pipeline "
        f"({args.pipeline_model_parallel_size}) parallel sizes"
    )
    args.data_parallel_size = args.world_size // model_parallel_size

    # batch sizes (ref :143-151)
    assert args.micro_batch_size is not None
    assert args.micro_batch_size > 0
    if args.global_batch_size is None:
        args.global_batch_size = args.micro_batch_size * args.data_parallel_size
    assert args.global_batch_size > 0

    # params dtype (ref :165-180)
    args.params_dtype = torch.float32
    if args.fp16:
        assert not args.bf16
        args.params_dtype = torch.float16
    if args.bf16:
        assert not args.fp16
        args.params_dtype = torch.bfloat16

    # consistency checks (ref :240-280)
    if args.ffn_hidden_size is None:
        args.ffn_hidden_size = 4 * args.hidden_size
    assert args.hidden_size % args.num_attention_heads == 0
    assert args.seq_length is not None
    if args.max_position_embeddings is not None:
        assert args.max_position_embeddings >= args.seq_length

    # sequence parallelism needs tensor parallelism (ref :300-310)
    if args.sequence_parallel:
        assert args.tensor_model_parallel_size > 1, (
            "sequence parallelism requires tensor parallelism"
        )

    return args


def transformer_config_from_args(args):
    """Map a parsed namespace onto ``TransformerConfig`` (the reference's
    tests thread args into their transformer layers field by field)."""
    from apex_tpu_torch.transformer import TransformerConfig

    return TransformerConfig(
        num_layers=args.num_layers,
        hidden_size=args.hidden_size,
        num_attention_heads=args.num_attention_heads,
        vocab_size=args.padded_vocab_size
        if getattr(args, "padded_vocab_size", None)
        else args.make_vocab_size_divisible_by,
        max_position_embeddings=args.max_position_embeddings,
        ffn_hidden_size=args.ffn_hidden_size,
        hidden_dropout=args.hidden_dropout,
        attention_dropout=args.attention_dropout,
        layernorm_epsilon=args.layernorm_epsilon,
        sequence_parallel=args.sequence_parallel,
        compute_dtype=args.params_dtype,
    )
