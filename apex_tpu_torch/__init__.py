"""apex_tpu_torch: the PyTorch/CUDA port of apex_tpu for NVIDIA Hopper.

A package of its own beside ``apex_tpu`` (the JAX reference, which it
never imports). It holds GPT serving end to end (the transformer stack,
the GPT model, ``generate`` and the continuous-batching engine) and the
single-GPU GPT training step (the loss, loss scaling, the anomaly
sentinel and fused Adam, built by ``resilience.replay.build_gpt_training``),
and the Llama family on the same model (rope, RMSNorm, GQA, SwiGLU; the
transformers import in ``models.hf_import``), served by the engine and
fine-tuned by ``examples.llama.finetune_llama`` through ZeRO-2 Adam at a
data-parallel world of one; BERT (``models.bert``), served by its
eval-mode forward and pre-trained by
``transformer.testing.standalone_bert``, with dropout, the unfused
``CoreAttention`` and the scaled-softmax family; and tensor, sequence
and data parallelism over ``torch.distributed`` (``parallel``: process
groups laid out as the JAX mesh, the tensor- and sequence-parallel
regions and layers, DDP, ZeRO-2 Adam at dp > 1, SyncBatchNorm), which
the GPT step runs at tp x dp, pipeline parallelism (``parallel.pipeline``:
1F1B, interleaved and zero-bubble schedules) and context parallelism
(``parallel.ring_attention``: ring and Ulysses attention and decode over
a sharded cache, ``examples.long_context.train_ring_cp``); and Apex's
amp front end (``amp``: O0-O3, O1's cast engine, ``AmpOptimizer``;
``fp16_utils``; the remaining fused optimizers; the ``mlp``,
``fused_dense`` and ``normalization`` modules; ``examples.simple``,
``examples.imagenet`` and ``examples.dcgan``); and compressed gradient
collectives with error feedback (``parallel.compress``, in DDP, ZeRO
Adam and ZeRO LAMB), ZeRO's param remainders, the layer-RMS taps, and
BERT, KV-cache decode and MoE at tp > 1; and serving's front end and its
example (``examples.serving.serve_gpt``: SIGTERM drain, the incident
ladder of ``resilience.health``), beam search, and the monitor's
instruments (``monitor``: FLOPs/MFU, the metric bag, the stall watchdog
and profiler trigger, the HBM x-ray, goodput and fleet checks). All nine
Pallas kernels of the TPU package
are rewritten by hand in CUDA C++ for ``sm_90a`` (``csrc/``, built and
loaded by ``_kernels``).

Device rule (replacing the JAX package's ``impl=`` switch): a CUDA
tensor goes to the hand-written kernel or raises; a CPU tensor takes the
plain PyTorch version. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
