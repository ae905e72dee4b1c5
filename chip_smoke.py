"""Drive the PyTorch/H100 port on one CUDA card, end to end.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and no phase's exception is
swallowed:

1. device: a CUDA card must be present; prints ``nvidia-smi``'s name and
   power limit;
2. build: compiles every kernel of ``apex_tpu_torch/csrc`` with ``nvcc``
   (one process per source, all at once) and prints the seconds; then
   the native host library (``apex_tpu_torch/csrc/apex_tpu_C.cpp``,
   built with ``g++`` on this host and loaded, its ABI checked) gathers
   GPT-2 training's, TinyLlama's and an 8.4 MB (threaded) batch from a
   token file, bit-equal to numpy's fancy index, both timed
   (``native``);
3. kernel parity: each kernel against its plain PyTorch version on the
   card, in fp32 and bf16 where it takes bf16, at the main paths' shapes
   and the edge cases (ragged lengths, a fully padded row, GQA 12/4 and
   Llama's 32/4, a sliding window, causal and window with sq != sk; flash
   forward and backward at Llama training's (4,32,2048,64) over
   (4,4,2048,64) and at head_dim 128 and 80, the forward at a 1536-token
   Llama prefill in bf16, its lse in both dtypes, and the split decode:
   Llama's 32/4 over 8 splits with a dead and a full lane, sk = 1000, a
   window at sq = 1; flash forward (prefill, split and unsplit decode) and
   backward at head_dim 256 and 160 and at batch x heads = 65,600, in both
   dtypes; flash forward and backward at BERT-345M's non-causal
   (4,16,512,64), without and with key padding of lengths 512/400/137/1
   (a row that keeps one key), in both dtypes, and the forward at BERT
   serving's (32,16,512,64) with the serving batch's own 32 lengths;
   flash forward and backward at GPT-2's heads at tp = 2, causal
   (4,6,1024,64), in both dtypes, and at TinyLlama's under Ulysses at cp
   = 4, causal GQA (4,8,2048,64) over (4,1,2048,64) with the CP batch's
   key padding, in both dtypes;
   LayerNorm forward at GPT-2's (8192, 768), (768, 768) and (8, 768), at
   BERT's (2048, 1024) and serving's (16384, 1024), GPT-2's rows at tp
   = 2 under sequence parallelism (2048, 768), at hidden 770 and on an
   unaligned input (the loop); LayerNorm backward at rows {1, 1000, 8192}
   x hidden {768, 1000, 1024, 1600, 1001} and at (2048, 1024) and (2048,
   768), without weight, and on an unaligned input, against the plain
   version
   and against the loop kernel on the same inputs; Adam over
   GPT-2 small's 124,439,808 parameters and a ragged length, both decay
   modes, steps 1 and 10; RMSNorm forward and backward at rows {1, 4, 1000,
   1024, 2048, 8192} x hidden {2048, 1000, 770}, with and without weight, the
   forward's
   routes at hidden 4096, 5120 and an unaligned input, and the backward's
   loop on an unaligned input; the norm forwards' register-resident row
   bit-equal to their loop, and the RMSNorm forward's output bit-equal to
   digests recorded from its earlier build (GOLDEN_RMS_FWD); the sum of
   squares at 1, 1,000,003, one ZeRO shard of GPT-2 small at tp = 2 x
   dp = 2 (31,358,976) and TinyLlama's 1,100,048,384 elements, also
   against an fp64 sum); prints each case's error and tolerance, and checks
   that a second call on the same inputs is bit-equal; then times each
   kernel, its plain version and the one PyTorch call that computes the
   same function (the timed flash outputs held to the same tolerances; the
   flash, LayerNorm and RMSNorm forward, the RMSNorm backward and the flash
   backward kernels and their library calls in turns over three rounds,
   medians, with each kernel's share of its bound; BERT's rows: flash
   forward and backward at (4,16,512,64) non-causal with and without key
   padding, the forward at serving's (32,16,512,64) with its lengths,
   LayerNorm forward at (2048, 1024) and (16384, 1024) and backward at
   (2048, 1024), in bf16 and fp32; the flash decode step of a tp = 2
   rank of GPT-2 small, (8,6,1,64) over a 256-slot cache, and the sum of
   squares over one ZeRO LAMB shard of BERT-345M at dp = 4 (84,082,688);
   the contrib MHA example's widest point: flash forward and backward at
   (120,16,64,64) non-causal, with and without encdec's key padding
   (``mha_kpm``), and LayerNorm forward and backward at (7680, 1024), in
   fp32 and bf16 (an fp32 row's bound is the fp32 peak);
   the decode-shape rows
   and the LayerNorm backward also as CUDA graphs of the kernel alone and
   of the library call, and the LayerNorm backward's loop kernel both ways
   beside it);
4. serving: GPT-2 small at full width (12 x 768, vocab 50257, 1024
   positions, seeded random weights, params fp32, compute bf16) behind
   the continuous-batching engine answers 24 requests; the launch counts
   of both forward kernels must grow during this run. Then the logits of a
   short input on the card agree with the plain path on the CPU, and in
   fp32 the engine's greedy tokens equal ``generate``'s on the same
   prompts;
4b. serving_fleet: the serving front end at GPT-2 small's full width
   (bf16, the same seeded weights): (a) one 8-lane engine with a record
   router serves 24 requests of the serving workload plus fillers that
   overflow its 32-deep queue (``queue_full``), books malformed,
   out-of-vocab and too-long refusals, then arms a TTFT budget of
   ``TTFT_BUDGET_FACTOR`` x its measured per-admission cost and sheds
   ``ttft_budget`` only after an injected slow-decode tick; a drain
   mid-load finishes the in-flight and rejects the queued as
   ``draining``, and a zero-grace drain on a second engine evicts by
   deadline; every request has one terminal record, the pool is free
   and kept its storage, no kernel loaded after ``start()``, the goodput
   identity holds with ``==`` and the x-ray passes; (b) in fp32, a
   prefill and a decode replica give ``generate``'s greedy tokens on 4
   requests through KV handoffs whose ledger closes matched with n_blocks
   x 12 x 2 x 12 x 16 x 64 x 4 bytes each; (c) 3 replicas (1 prefill, 2
   decode) under a seeded ``PoissonLoadGenerator`` with a replica kill
   mid-load and the autoscaler armed: the kill, the re-dispatch, a
   restart, a readmission and a scale-up happen, every global id has one
   terminal record, the ledger (589,824 bytes a block) is matched, the
   x-ray and the goodput identity hold; logs tokens/s, TTFT p50/p99, time
   per output token, handoff bytes and ms, ticks from the kill to the
   detection and the readmission, and drain seconds;
4c. serve_gpt: the serving example and the monitor at GPT-2 small's
   width (seed 0, fp32 params, bf16 compute): (a) ``python -m
   apex_tpu_torch.examples.serving.serve_gpt`` at 12 x 768, vocab 50257,
   rope positions, 8 lanes x 512 blocks of 16, 96 Poisson requests at 12
   req/s (prompts 32-768, 32-64 new tokens), queue 16, TTFT budget 2 s,
   deadline 30 s and the JAX drill's chaos faults, SIGTERM once 40
   request records exist (grace 60 s): it drains and exits 0, one
   terminal record an id, shedding with reasons, the goodput identity with
   ``==``, no steady-state kernel load, #1 and #5 launched; (b) the same
   model with 24 requests, a wedge at tick 20 and the incident ladder at
   2 s x (1, 1.5, 3): exit 43 within 30 s of the wedge, the dump, the
   terminate record and the incident span in the stream, whose goodput
   identity holds; (c) beam search on GPT-2 small, 2 prompts of 64, 4
   beams, 32 new tokens: bf16 launches #1 and #5, fp32 on the card gives
   the CPU's plain tokens and scores within 1e-4, one beam is greedy
   ``generate``; a ``MetricBag`` fed ``global_grad_norm`` (#9) of a
   backward's grads on the card, read in one fetch, against an fp64 norm;
   (d) the GPT example at the training phase's shape for 6 steps with
   ``--log-interval 2``, a profiled window at steps 3-4, ``--xray-hbm``
   and a 120 s stall deadline: three metrics records with a finite loss
   and grad norm and 0 < MFU <= 1.05, one fetch an interval, a memory
   record under the card's capacity, a Chrome trace naming #1, #2 and
   #5-#8, no stall; ``oom_guard`` around an allocation larger than the
   card; the ledger's GPT-2 small parameters (124,439,808) and KV pool
   (512 x 589,824 bytes) against the model and the engine; logs each
   drill's tokens/s, TTFT p50/p99, shed share, drain seconds and seconds
   from the wedge to the exit, and the example's step ms, tokens/s, MFU,
   profiled against unprofiled step ms, and predicted against measured
   resident and peak bytes;
5. training: ``build_gpt_training`` at GPT-2 small's full width (micro
   batch 8, global batch 16, seq 1024, lr 3e-4) on the synthetic corpus
   written as a token file and read through ``_native`` (as every GPT
   phase reads it; the first batches' crc32s are logged), one warm-up
   step (after which every one of the 148 parameters must
   hold a finite gradient) and 8 measured steps: finite losses, every
   verdict OK, the last loss below the first, and all six kernels'
   launch counts grow. Then on a small model: loss and every gradient on
   the card agree with the CPU, 3 bf16 training steps give the CPU's
   verdicts, loss scales and losses, and an ``inject_nan`` step is
   skipped with params and Adam state bit-unchanged and the scale halved;
6. Llama serving: TinyLlama-1.1B at full width and depth (22 x 2048, 32
   heads over 4 KV heads, SwiGLU 5632, vocab 32000, RoPE, RMSNorm, untied
   fp32 head; seeded random weights, params fp32, compute bf16) behind an
   8-lane engine (16-token blocks, ``max_seq_len`` 2048) answers 24
   greedy requests (prompts of 32-1536 tokens, 32-64 new tokens each);
   all 24 must complete and the RMSNorm and flash forward kernels must
   run. Then, in fp32, every decode step of two lanes at different
   positions gives the logits of a full forward of the same prefix, and
   the logits of a 32-token input on the card agree with the plain path
   on the CPU;
7. Llama fine-tuning: the fine-tuning example
   (``examples/llama/finetune_llama.main``, with ``--metrics-jsonl`` and
   ``--xray-hbm``) on TinyLlama-1.1B at full width and depth, bf16
   compute, batch 4 x 2048, lr 1e-3, clip 1.0, through
   ``distributed_fused_adam`` at a data-parallel world of one, 1 + 5
   steps: the loss falls over the 5, the sum-of-squares kernel computes
   the clip factor once per step, the RMSNorm and flash kernels run, the
   goodput identity holds with ``==``, the allocator's peak over the
   first step is within ``LLAMA_HBM_BAND`` of the composed HBM ledger's
   prediction, and the recompile sentinel flags nothing after the first
   step; one more step of the trained state gives all 157 parameters a
   finite gradient;
7b. Llama recovery (``llama_runtime``): the example at TinyLlama's width
   and depth ``LLAMA_RUNTIME_LAYERS`` (2, cut from 22 so the checkpoints
   fit the time), 4 x 2048: 2 + 2 uninterrupted steps; 2 steps saved
   (``--save``) and a rerun resumed for 2 more, its losses and every
   leaf's crc32 (parameters and ZeRO state) equal to the uninterrupted
   run's, its journal (both incarnations) diffing clean against the
   uninterrupted one's (``replay --diff``); a process under a
   ``--run-deadline`` far shorter than its run ends in exit 43 after the
   dump and terminate records. It logs the checkpoint's bytes, the save
   and restore ms and the seconds;
8. ResNet-50: ``apex_tpu_torch.bench``, the twin of ``bench.py``, at its
   size (224^2, batch 256, seeded random images and weights): O2 (bf16
   compute, fp32 parameters, cuDNN's autotuner on), then O0 (fp32, TF32
   and the autotuner off), each 3 warm-up
   steps of loss, backward and ``fused_sgd``, then a step timed by the
   slope between chains of 1 and 11 steps (best of 2 each); finite losses
   that fall in each mode; then a small fp32 ResNet's loss, every gradient and
   its new batch statistics on the card against the CPU;
9. BERT serving: Megatron BERT-345M at full width and depth (24 x 1024,
   16 heads, FFN 4096, vocab 30592, 512 positions, two tokentypes, the
   binary head; seeded random weights, params fp32, compute bf16) in eval
   mode over 32 sequences of lengths 64-512 (``numpy.RandomState(0)``)
   padded to 512, with ``attention_mask`` and ``tokentype_ids``: one
   warm-up and 5 timed passes (sequences/s and real tokens/s); finite MLM
   and NSP logits, the LayerNorm and flash forward kernels run, changing
   the padded tokens leaves the kept positions' logits bit-equal, and a
   short padded fp32 batch's logits on the card agree with the CPU;
10. BERT pre-training: the standalone BERT (``standalone_bert``, the body
   of ``run_bert``) at Megatron BERT-345M (micro batch 4, global batch 8,
   seq 512, lr 1e-4, bf16): one warm-up step (the loss within 1.0 of ln
   30592, every one of the 301 parameters a finite gradient) and 5
   measured steps (tokens/s, step ms); six kernels run; then one step
   (as one serving pass before it) under ``torch.profiler``: device time,
   idle share and the top kernels;
11. BERT dropout: BERT-345M in training mode with 0.1 hidden and
   attention dropout (the CoreAttention path) on one fixed padded 4 x 512
   batch, 8 ``fused_adam`` steps at lr 1e-4: the loss falls, no flash
   kernel runs, the LayerNorm and Adam kernels do; then the dropout's kept
   share and scale on the card and two models of one seed bit-equal;
12. (Before it, the spawned runs of phases 12 (c), 13 (b, c), 14, 15,
   18b's spatial bottleneck, 21's ep and 23 run as jobs of one shared
   world of 4 ranks
   (``gloo_world``), which so pays the processes' start, and the import
   of ``torch._dynamo`` that torch's activation checkpoint makes on its
   first call, once; each phase then checks and logs its jobs' results.)
   GPT-2 small at tp = 2 x dp = 2 with sequence parallelism (full
   width, vocab 50257 padded to 50304 so that it divides by tp, seed 0):
   the GPT example under ``torch.distributed.run``, 4 ranks on this one
   card over gloo (NCCL refuses two ranks on one card; gloo moves each
   collective's CUDA tensors through pinned host memory, every kernel
   and product still runs on the card), depth 4 (cut from 12), micro
   batch 4, global 16, seq 1024: (a) ZeRO-2, 1 + 3 steps, (b) DDP and
   ``fused_adam``, 1 + 2 steps; per-step loss, verdict and tokens/s,
   every rank's peak memory, the first loss within 0.5 of ln 50304 and
   every verdict OK, and rank 0's launch counts (#1, #2, #5, #6, #7
   grow, and #8 under DDP); then (c) the same 4 ranks at 2 layers and
   seq 256 on the card's kernels and on the CPU's plain versions from
   the same weights: 3 bf16 ZeRO steps within the training tolerances,
   2 fp32 steps of the model, the dp all-reduce and ``fused_adam`` to
   1e-4; and (d) one step of GPT-2 small in a NCCL world of one;
13. GPT-2 small pipelined, 4 ranks on this card over gloo (each p2p
   message staged through pinned host memory), vocab 50304, micro batch
   4, M = 4, seq 1024, bf16, random weights from seed 0: (a)
   ``standalone_gpt`` under ``torch.distributed.run`` at pp = 2 x tp = 2
   with sequence parallelism (1F1B) at depth 4 (cut from 12), 1 + 1
   steps, and (b) the interleaved schedule at pp = 4 with V = 3 chunks of
   one layer (``forward_backward_with_pre_post(num_model_chunks=3)``)
   in the shared world, 1 + 1 steps: finite losses, the first within 0.5 of ln
   50304, the layout, and #1, #2, #5, #6, #7 and #8 launched on the first
   and the last stage; per-step ms and tokens/s, every rank's peak memory
   and the p2p messages and bytes staged a step; then (c) the same 4
   ranks at pp = 2 x tp = 2 with SP, 2 layers at seq 128, on the card's
   kernels and on the CPU's plain versions from the same weights: 3 bf16
   steps (losses 2e-3 relative, parameters 2e-3 absolute) and 2 fp32
   steps (losses 1e-5 relative, each tensor 1e-4 relative in norm);
14. GPT-2 small pipelined at pp = 2 x tp = 2 with SP through the
   zero-bubble B/W split (``GPTPipelineTraining(zero_bubble=True)``, the
   1F1B run's settings, depth 4) in the shared world, 1 + 1 steps: the
   checks of
   13 (a), per-step ms, tokens/s, peak memory and staged p2p beside
   ``algebra``'s zero-bubble and 1F1B costs at (2, 4); then zero bubble
   against 1F1B from the same weights at 2 layers, seq 128, fp32, 2
   steps: losses 1e-5 relative, every gradient 1e-4 relative in norm;
15. context parallelism: TinyLlama-1.1B at full width, 22 layers cut to 2,
   cp = 4 on 4 ranks of this card over gloo (ring messages, all-to-alls
   and gradient sums staged through pinned host memory), batch 4 x 2048
   tokens (512 a rank) of ragged documents of 1024-2048 tokens, bf16:
   ``train_ring_cp``'s step through ring attention and through Ulysses,
   1 + 3 steps each: finite losses, the first within 0.5 of ln 32000 +
   2048 x 0.02^2 / 2, every rank's parameters the same after each step
   (digests), step ms, tokens/s, every rank's peak memory and what was
   staged a step, and one more step profiled on the last rank, whose
   causal ring work is the most (the ring chunk updates' share); then
   one step of each at cp = 4 against one model at
   cp = 1 from the same weights and batch (fp32: per-token losses rtol
   2e-4 atol 2e-5, every gradient 1e-4 relative in norm; bf16: the mean
   loss 2e-3 relative); then fp32 KV-cache decode over cp = 4 (1024
   prompt tokens prefilled, 16 teacher-forced steps, which run #3 alone:
   the prefill's ring and ``cp_decode_attention`` are plain, as JAX's)
   against the cp = 1 uncached forward, rtol 2e-4, atol 2e-4;
16. amp, ImageNet: the ported ``examples/imagenet/main_amp.py`` on
   ResNet-50 at 224^2, batch 256 (seeded random images and weights)
   through ``amp.initialize`` and ``fused_sgd``: O0 (TF32 and cuDNN's
   autotuner off, as the bench's), O1, O2
   and O3 in bf16 and O2 in fp16 with dynamic scaling, 3 warm-up and 10
   timed steps each: images/s, step ms, peak memory, finite falling
   losses, the scale, O1's casts a forward beside the 53 convolutions
   and one linear, bf16 O2 against the bench's O2 of phase 8, and a
   profile of two O2 steps;
17. amp, DCGAN: the ported ``examples/dcgan/main_amp.py`` at the JAX
   example's defaults (batch 64, 32^2, nz 100), 50 steps of fp16 O2:
   three scalers, an overflow injected into D's fake loss at step 10
   skips D's step and halves that scaler alone, G's step and scaler go
   on; #8 runs;
18. amp, simple: the ported ``examples/simple/amp_mlp_train.py``, 60
   steps of fp16 O2 with an overflow injected at step 10: that step
   leaves params, masters and Adam state bit-unchanged and halves the
   scale, the loss falls, #1, #8 and #9 run; then ``amp_parity``: the
   simple example (fp32 O0, bf16 and fp16 O2) for 3 steps on the card
   against the CPU from the same weights and data (losses, parameters,
   scales, skips), the DCGAN (fp32 O0, bf16 and fp16 O2) for 3 steps
   (losses, scales, skips; its parameters logged), its fp32 gradients
   from the same weights, and its amp step (AmpOptimizer over #8 on D
   with two losses and on G, O0 and fp16 O2) for 3 steps from the same
   gradients (scales, masters, parameters), the O1 probe's
   dtypes on the card equal to the CPU's, the normalization modules
   forward and backward (launching #1-#4) in fp32 and bf16, and
   ``fused_lamb`` (launching #9), ``fused_novograd``, ``fused_adagrad``,
   ``fused_adam_swa``, LARC and ``clip_grad_norm`` for 3 steps;
18b. contrib: the MHA modules (a 2-layer stack at hidden 1024, 16
   heads, norm-add self-attention and encdec with key padding and a
   fully padded row, whose output must be the last projection's bias) on
   the card in fp32 and bf16 against the plain path on the CPU in fp32,
   output and every gradient (``CONTRIB_TOL``); the MHA example's loop at
   full width (18 layers, seq 64) at 10 and 120 sequences, norm-add self
   and encdec, fp32 and bf16, slope-timed (the counted ``contrib``
   path); the ResNet-50 bottleneck blocks (stage 1 and stride 2, 56 x
   56, batch 32) in bf16 against fp32, GroupNorm + swish (8 x 320 x 64 x
   64) in bf16 against fp32, the transducer (8 x 256 x 64 x 1024), focal
   loss (4 x 120,087 anchors x 96 classes) and ``index_mul_2d`` card
   against CPU with their gradients, ASP's masks over GPT-2 small exactly
   2:4, and a 2-layer LSTM and mLSTM at hidden 1024 card against CPU;
   the seconds of each part; and, in the shared world of 4, the spatial
   bottleneck at cp = 4 (``SPATIAL_CASES``) against the unsharded block;
19. one step of ``fused_adam``, ``fused_lamb``, ``fused_novograd``,
   ``fused_adagrad`` and ``fused_adam_swa`` over BERT-345M's parameters:
   ms and launches, recorded for a later performance issue;
20. recompute: GPT-2 small (12 x 768, vocab 50257) at
   ``recompute_granularity`` None, "selective" and "full" from one seed,
   1 + 3 steps of 2 micro-batches of 8 x 1024 through ``fused_adam``:
   step ms, peak memory, what a forward leaves for its backward, launches
   a step; losses and parameters bit-equal to None's (else 1e-6 relative
   in norm); then hidden and attention dropout 0.1, 2 steps each:
   gradients, losses and the generators' states equal to None's;
21. MoE: GPT-2 small with 8 experts a layer (top-2, capacity factor
   1.25), 8 x 1024 tokens, 1 + 5 steps of the loss plus
   ``total_moe_aux_loss``: tokens/s, peak memory, each layer's dropped
   share; at depth 2 in fp32 the card against the CPU; then at depth 2
   (cut from 12) with the experts over dp = 4 ranks of this card over
   gloo, fp32, each rank against ep = 1 on its tokens, and the
   all-to-alls staged a rank;
22. FP8: ``quantize`` card against CPU bit-equal at GPT-2's MLP shapes,
   ``fp8_dense`` card against CPU, the QDQ dense's, a bf16 matmul's and
   ``torch._scaled_mm``'s times on the same operands (the last a library
   row, not on the path), and the FP8 example's 60 steps;
23. the pipeline at pp = 2 x tp = 2 with SP (1F1B) at GPT-2 small's
   width and depth 2, ``remat`` True against False from the same
   weights, fp32 (bit-equal) and bf16: peak memory a rank, launches and
   staged collectives a step; the pipelined phases 13 and 14 run at
   JAX's default, ``remat=True``;
24. the multi-GPU tail, as jobs of one world of 4 ranks and one of 2:
   GPT-2 small (depth 4, cut from 12) at tp = 2 x dp = 2 through the
   training target, 1 + 1 steps, with
   int8 (ZeRO with the layer-RMS taps, and DDP) and fp8 (ZeRO) gradient
   collectives beside the exact ZeRO and DDP runs from the same weights
   (the staged bytes a step differ from the exact run's by the predicted
   difference of the data-parallel sync alone, byte for byte), and at 2
   layers card against plain; BERT-345M through ``standalone_bert`` at
   tp = 2 x dp = 2 with SP, 1 + 2 steps, and at 2 layers card against
   plain in fp32; GPT-2 small's
   KV-cache prefill and decode at tp = 2 with and without SP against the
   full forward (bf16 on the card, fp32 plain at 2 layers); ZeRO LAMB
   (exact and int8) and ZeRO Adam with remainders (rebuilt master bit
   for bit against the fp32 run's) over BERT-345M's shapes at dp = 4;
   GPT-2 small with 8 experts at tp = 2 (depth 2) against tp = 1, and
   with SP card against plain (the compressed and exact runs also log
   the collective-traffic ledger's bytes a step by axis, beside what
   gloo staged); and ``gpt_elastic``, GPT-2 small's width
   at depth 2 under ZeRO-2 in the world of 4: the elastic trip (3 steps
   at dp 4 and a verified save, restored at dp 2 on ranks {0, 1}, 2
   steps and a save, restored at dp 4 and 2 steps; every restore held
   leaf for leaf, the flat buffers on the common prefix with zero
   padding and every crc32 to its manifest; the losses within 1e-4 of an
   uninterrupted dp-4 run, and every leaf of the state within 1e-2 of how
   far that run's steps moved it), then the remediation selftest's SDC case (a
   bit flipped after step 3, confirmed by the canary with the step and
   the leaf, quarantined 4 -> 2 with the corrupt checkpoints moved
   aside, readmitted 2 -> 4 after 2 clean steps; one terminal verdict,
   the goodput identity ``==``, the final loss within 5e-2 of the clean
   reference) and its false-positive clear; it prints each rank's
   checkpoint bytes, save and restore ms, the canary's replayed step ms
   and the seconds;
25. the GPT example's recovery path at GPT-2 small's full width and
   depth 4 (cut from 12 for the script's time), in process through
   ``main(argv)``, 6 steps a run: a clean run saved
   every 2 steps and the same with one parameter bit flipped after step
   3; the clean run's replay bitwise with zero divergence, the flipped
   run's replay diverging (exit 2) and its bisect naming step 4, the
   exact leaf and anchors 2 and 4; a SIGTERM after step 3 ending in a
   verified step-4 checkpoint, and a rerun over that checkpoint
   bit-flipped on disk falling back to step 2 with the clean run's
   losses bit for bit; a NaN at step 3 with no skip budget rolled back
   and completed. It logs the bytes of a checkpoint, the save, sha256,
   crc32, restore and replay times and the free disk space, and removes
   its directories;
26. prints the ``kernels`` line (all nine kernels; ``launches`` is the
   count of the kernel's first path below that runs it, and
   ``launches_by_path`` has every path's), then as the last line
   ``{"ok": true, "device": {...}}``.

The paths, each driven with the counts set to 0 just before it and read
just after: ``serving``, ``serving_fleet`` (its three parts; the fp32
``generate`` references run before the counts are set to 0) and
``training`` (GPT-2 small), ``llama_serving``
and ``llama_finetune`` (TinyLlama-1.1B), ``llama_runtime`` (its three
in-process runs), ``resnet`` (ResNet-50, which
runs none of the nine kernels), ``bert_serving``, ``bert_pretrain`` and
``bert_dropout`` (Megatron BERT-345M), ``gpt_parallel`` and
``gpt_parallel_ddp`` (GPT-2 small at tp = 2 x dp = 2; each run's ranks
start at 0 and rank 0 reports its counts), and ``gpt_pipeline`` and
``gpt_pipeline_interleaved`` (GPT-2 small pipelined; each run's counts
start at 0 after its build, and rank 0, a first-stage rank, reports
them, its last-stage rank's checked beside them), ``gpt_pipeline_zero_
bubble`` (likewise), and ``llama_cp_ring``, ``llama_cp_ulysses`` and
``llama_cp_decode`` (TinyLlama at cp = 4; each job's counts start at 0
when its model is built and are read before any cp = 1 reference runs,
and rank 0 reports them), and ``amp_imagenet``, ``amp_dcgan`` and
``amp_mlp`` (the three amp examples; ResNet-50 runs none of the nine),
``contrib`` (the MHA example's sweep in phase 18b),
``gpt_recompute_none``, ``_selective``, ``_full`` and ``_dropout``,
``gpt_moe``, ``gpt_moe_ep`` (rank 0), ``fp8`` (none of the nine),
``gpt_pipeline_no_remat`` (rank 0 of the bf16 run), and
``gpt_compress_zero`` and ``gpt_compress_ddp`` (rank 0 of each example
run), ``bert_tp`` (rank 0), ``gpt_tp_decode`` (rank 0's prefill and
decode steps), ``zero_lamb_remainders`` (rank 0's exact LAMB run) and
``gpt_moe_tp`` (rank 0's SP pass), and ``serve_gpt`` (the SIGTERM
drill's process), ``serve_gpt_beam`` (the bf16 beam search),
``monitor_grad_norm`` (``global_grad_norm``) and ``gpt_monitor`` (the GPT
example's process under its telemetry flags), and ``gpt_resilience``
(every step and replay of phase 25). Every path's kernels must have
launched. ``python3 chip_smoke.py --tail`` (development) runs only the
build and phase 24, ``--elastic`` only the build and phase 24's
``gpt_elastic`` jobs (in a world of 4 of their own), ``--serve-gpt``
only the build and phase 4c, and ``--resilience`` only the build and
phase 25, and ``--llama-runtime`` only the build and phase 7b, and
``--contrib`` only the build and phase 18b (without the spatial job);
none prints a result. Every temp file of a run goes into one directory that
the script removes when it ends.
"""

import gc
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

START = time.perf_counter()
SEED = 0
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense tensor-core bf16
FP32_FLOPS = 67e12          # fp32 outside the tensor cores

# tolerances of kernel vs plain version, as (atol, rtol)
TOL = {
    # fp32: the same arithmetic summed in another order
    ("layer_norm_fwd", torch.float32): (1e-5, 1e-5),
    # bf16: both round an fp32 result to bf16, so they may differ by one
    # bf16 ulp (2^-8 relative)
    ("layer_norm_fwd", torch.bfloat16): (1e-2, 1e-2),
    # fp32: scalar-FMA dot products vs cuBLAS fp32 (TF32 off)
    ("flash_fwd", torch.float32): (2e-5, 1e-4),
    # bf16: the kernel rounds the unnormalised P of its running max to
    # bf16, the plain version the normalised softmax (attention.py:155)
    ("flash_fwd", torch.bfloat16): (2e-2, 2e-2),
    # lse: fp32 statistics of the same scores summed in another order (and,
    # in bf16, exp by ex2.approx); the backward reads it as exp(s - lse)
    ("flash_fwd lse", torch.float32): (2e-5, 1e-4),
    ("flash_fwd lse", torch.bfloat16): (1e-4, 1e-4),
    # dx: the same fp32 arithmetic in another order / one bf16 rounding
    ("layer_norm_bwd", torch.float32): (1e-4, 1e-4),
    ("layer_norm_bwd", torch.bfloat16): (2e-2, 2e-2),
    # dgamma, dbeta: fp32 sums over up to 8192 rows in another order
    ("layer_norm_bwd dgamma/dbeta", torch.float32): (2e-3, 1e-4),
    ("layer_norm_bwd dgamma/dbeta", torch.bfloat16): (2e-3, 1e-4),
    # fp32: scalar-FMA sums over up to 1024 keys or queries in another
    # order; bf16: one rounding of the output, and p and ds rounded to
    # bf16 from fp32 values that may differ in their last bits
    ("flash_bwd_dq", torch.float32): (1e-4, 1e-4),
    ("flash_bwd_dq", torch.bfloat16): (2e-2, 2e-2),
    ("flash_bwd_dkv", torch.float32): (1e-4, 1e-4),
    ("flash_bwd_dkv", torch.bfloat16): (2e-2, 2e-2),
    # every operation explicitly rounded as the plain version rounds it
    ("adam_update", torch.float32): (0.0, 0.0),
    # RMSNorm as LayerNorm: the same fp32 arithmetic in another order, or
    # one bf16 rounding of the output
    ("rms_norm_fwd", torch.float32): (1e-5, 1e-5),
    ("rms_norm_fwd", torch.bfloat16): (1e-2, 1e-2),
    ("rms_norm_bwd", torch.float32): (1e-4, 1e-4),
    ("rms_norm_bwd", torch.bfloat16): (2e-2, 2e-2),
    # dgamma: fp32 sums over up to 8192 rows in another order
    ("rms_norm_bwd dgamma", torch.float32): (2e-3, 1e-4),
    ("rms_norm_bwd dgamma", torch.bfloat16): (2e-3, 1e-4),
    # fp32 partial sums of about a thousand terms per thread, then a tree,
    # against torch.sum's cascade: relative
    ("sumsq_flat", torch.float32): (0.0, 1e-5),
}
N_GPT2_SMALL = 124_439_808  # parameters of GPT-2 small (tied head)
N_TINYLLAMA = 1_100_048_384  # parameters of TinyLlama-1.1B (untied head)


def zero_shard_tp2(layers: int) -> int:
    """One ZeRO shard of GPT-2 small at tp = 2 (vocab 50304) and
    ``layers`` deep: a rank holds half the table, 19,316,736, the
    positions, 786,432, ``layers`` layers of 3,546,240 and the final norm,
    1,536, flattened and padded to whole chunks of 65,536, and each of
    dp = 2 ranks keeps half."""
    held = 19_316_736 + 786_432 + layers * 3_546_240 + 1_536
    return -(-held // 65_536) * 65_536 // 2


# 12 layers: 62,659,584 parameters a rank, padded to 957 chunks
ZERO_SHARD_TP2 = zero_shard_tp2(12)
assert ZERO_SHARD_TP2 == 31_358_976
# BERT-345M's 336,267,266 parameters flattened and padded to 5,132 chunks
# of 65,536 = 336,330,752, of which each of dp = 4 ranks keeps a quarter:
# one ZeRO LAMB shard (zero_lamb_remainders)
LAMB_SHARD_BERT = 84_082_688
# the kernels each path must launch; a kernel's "launches" in the kernels
# line is the count of the first path here that runs it
PATH_KERNELS = {
    "serving": ("layer_norm_fwd", "flash_fwd"),
    # the serving front end: engine records and drain, the disaggregated
    # pair and the chaos fleet (prefill and split-KV decode on every
    # replica)
    "serving_fleet": ("layer_norm_fwd", "flash_fwd"),
    # the serving example's SIGTERM drill (its process's counts), beam
    # search in bf16, the bag's global_grad_norm, and the GPT example
    # under its telemetry flags (its process's counts)
    "serve_gpt": ("layer_norm_fwd", "flash_fwd"),
    "serve_gpt_beam": ("layer_norm_fwd", "flash_fwd"),
    "monitor_grad_norm": ("sumsq_flat",),
    "gpt_monitor": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                    "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "training": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                 "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "llama_serving": ("rms_norm_fwd", "flash_fwd"),
    "llama_finetune": ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd",
                       "flash_bwd_dq", "flash_bwd_dkv", "sumsq_flat"),
    # bench.py's ResNet-50 step: the JAX package runs it on no Pallas
    # kernel, so the port's runs on none of its own either
    "resnet": (),
    "bert_serving": ("layer_norm_fwd", "flash_fwd"),
    "bert_pretrain": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                      "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # attention dropout takes CoreAttention: no flash kernel (checked)
    "bert_dropout": ("layer_norm_fwd", "layer_norm_bwd", "adam_update"),
    # GPT-2 small at tp = 2 x dp = 2 with sequence parallelism, counted on
    # rank 0: under ZeRO Adam runs in plain ops, under DDP on #8
    "gpt_parallel": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                     "flash_bwd_dq", "flash_bwd_dkv"),
    "gpt_parallel_ddp": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                         "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # GPT-2 small pipelined (standalone_gpt): pp = 2 x tp = 2 with SP
    # (1F1B), and pp = 4 with V = 3 chunks (interleaved); counted on the
    # first stage, and checked on the last
    "gpt_pipeline": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                     "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "gpt_pipeline_interleaved": ("layer_norm_fwd", "layer_norm_bwd",
                                 "flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv", "adam_update"),
    # the same at pp = 2 x tp = 2 through the zero-bubble B/W split
    "gpt_pipeline_zero_bubble": ("layer_norm_fwd", "layer_norm_bwd",
                                 "flash_fwd", "flash_bwd_dq",
                                 "flash_bwd_dkv", "adam_update"),
    # TinyLlama-1.1B at cp = 4, counted on rank 0: the ring's chunk update
    # is plain torch (JAX's is jnp); Ulysses runs the flash kernels on the
    # cp-gathered sequence with the heads split over cp
    "llama_cp_ring": ("rms_norm_fwd", "rms_norm_bwd", "adam_update"),
    "llama_cp_ulysses": ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd",
                         "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # prefill over cp (the ring) and decode through cp_decode_attention,
    # both plain as JAX's: #3 alone; the counts are read before the cp = 1
    # reference forward runs
    "llama_cp_decode": ("rms_norm_fwd",),
    # the amp examples: ResNet-50 at every level runs none of the nine
    # (as bench.py's step); DCGAN's two Adams run #8; the simple example's
    # input LayerNorm #1, its Adam #8 and its clip_grad_norm #9
    "amp_imagenet": (),
    "amp_dcgan": ("adam_update",),
    "amp_mlp": ("layer_norm_fwd", "adam_update", "sumsq_flat"),
    # GPT-2 small trained at each recompute granularity: "selective"
    # reruns #5 (and the QKV/output products) in the backward, "full" #1
    # and #5 too; with dropout 0.1 the attention takes CoreAttention
    "gpt_recompute_none": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                           "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "gpt_recompute_selective": ("layer_norm_fwd", "layer_norm_bwd",
                                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                "adam_update"),
    "gpt_recompute_full": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                           "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "gpt_recompute_dropout": ("layer_norm_fwd", "layer_norm_bwd",
                              "adam_update"),
    # GPT-2 small with 8 experts a layer; at ep = 4 over gloo (rank 0, one
    # forward and backward, no optimizer)
    "gpt_moe": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    "gpt_moe_ep": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                   "flash_bwd_dq", "flash_bwd_dkv"),
    # the QDQ fp8_dense and its example run none of the nine (JAX's run no
    # Pallas kernel either)
    "fp8": (),
    # pp = 2 x tp = 2 at remat=False (rank 0, the bf16 run)
    "gpt_pipeline_no_remat": ("layer_norm_fwd", "layer_norm_bwd",
                              "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                              "adam_update"),
    # GPT-2 small at tp = 2 x dp = 2 with SP and int8 gradient
    # collectives (rank 0): under ZeRO Adam in plain ops, under DDP on #8
    "gpt_compress_zero": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                          "flash_bwd_dq", "flash_bwd_dkv"),
    "gpt_compress_ddp": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                         "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # Megatron BERT-345M through standalone_bert at tp = 2 x dp = 2 (rank 0)
    "bert_tp": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # GPT-2 small's KV-cache prefill and split-KV decode at tp = 2 (rank 0)
    "gpt_tp_decode": ("layer_norm_fwd", "flash_fwd"),
    # ZeRO LAMB's global norm (rank 0 of dp = 4); ZeRO Adam with
    # remainders sets no max_grad_norm, so runs none of the nine
    "zero_lamb_remainders": ("sumsq_flat",),
    # GPT-2 small with 8 experts at tp = 2 with SP (rank 0, one pass)
    "gpt_moe_tp": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                   "flash_bwd_dq", "flash_bwd_dkv"),
    # the GPT example's recovery path at GPT-2 small width: checkpointed
    # runs, bitwise replays and the bisect, SIGTERM resume, corrupt-latest
    # fallback and the NaN rollback (the phase's whole run of steps)
    "gpt_resilience": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                       "flash_bwd_dq", "flash_bwd_dkv", "adam_update"),
    # the elastic trip and the remediation loop over 4 ranks (ZeRO-2:
    # Adam in plain ops, 0 launches of #8), counted on rank 0
    "gpt_elastic": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                    "flash_bwd_dq", "flash_bwd_dkv"),
    # the Llama example's recovery path at TinyLlama width (depth cut):
    # the uninterrupted run, the saved run and its resumed rerun
    "llama_runtime": ("rms_norm_fwd", "rms_norm_bwd", "flash_fwd",
                      "flash_bwd_dq", "flash_bwd_dkv", "sumsq_flat"),
    "contrib": ("layer_norm_fwd", "layer_norm_bwd", "flash_fwd",
                "flash_bwd_dq", "flash_bwd_dkv"),
}
FORWARD_KERNELS = PATH_KERNELS["serving"]
KERNEL_META = {  # name: (source, TPU kernel it replaces)
    "layer_norm_fwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                       "apex_tpu/ops/layer_norm.py:81"),
    "layer_norm_bwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                       "apex_tpu/ops/layer_norm.py:90"),
    "flash_fwd": ("apex_tpu_torch/csrc/flash_attention.cu",
                  "apex_tpu/ops/attention.py:122"),
    "flash_bwd_dq": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                     "apex_tpu/ops/attention.py:247"),
    "flash_bwd_dkv": ("apex_tpu_torch/csrc/flash_attention_bwd.cu",
                      "apex_tpu/ops/attention.py:289"),
    "adam_update": ("apex_tpu_torch/csrc/adam.cu",
                    "apex_tpu/optimizers/_fused_kernels.py:33"),
    "rms_norm_fwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                     "apex_tpu/ops/layer_norm.py:115"),
    "rms_norm_bwd": ("apex_tpu_torch/csrc/layer_norm.cu",
                     "apex_tpu/ops/layer_norm.py:121"),
    "sumsq_flat": ("apex_tpu_torch/csrc/l2norm.cu",
                   "apex_tpu/optimizers/_fused_kernels.py:121"),
}


def log(*a):
    print(*a, flush=True)


def device_phase() -> str:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is "
                 "false); this script runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def graph_ms(fn, iters: int = 50) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the kernels' own time, without the host's launch
    cost that ``time_ms`` includes where a call is short."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def in_turns(fns, rounds: int = 3, iters: int = 50):
    """``time_ms`` of each of ``fns`` (name: callable), taken in turns over
    ``rounds`` rounds; the median of each, and every round's times."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(time_ms(fn, iters))
    return {name: statistics.median(ms) for name, ms in times.items()}, times


def check(name, dtype, case, out, ref, errors, tol_key=None):
    atol, rtol = TOL[(tol_key or name, dtype)]
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    err = (out - ref).abs()
    bad = err > atol + rtol * ref.abs()
    mx = float(err.max()) if err.numel() else 0.0
    log(f"parity {name} {case} {str(dtype)[6:]}: max_abs_err={mx:.3e} "
        f"(atol {atol}, rtol {rtol})")
    if bool(bad.any()):
        raise AssertionError(f"{name} {case}: {int(bad.sum())} elements "
                             f"outside tolerance, max_abs_err {mx}")
    errors.setdefault(name, {})[dtype] = max(
        errors.get(name, {}).get(dtype, 0.0), mx)
    return mx


# -- kernel parity ---------------------------------------------------------

def ln_inputs(rows, hidden, dtype, gen):
    x = (torch.randn(rows, hidden, generator=gen, device="cuda") * 3 + 1)
    w = torch.randn(hidden, generator=gen, device="cuda")
    b = torch.randn(hidden, generator=gen, device="cuda")
    return x.to(dtype), w, b


def ln_parity(errors):
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        for rows, hidden in ((1, 768), (8, 768), (768, 768), (1000, 768),
                             (8192, 768), (1, 1000), (1000, 1000),
                             (8192, 1000), (77, 770), (8192, 770),
                             (2048, 1024), (16384, 1024), (2048, 768),
                             (4096, 768)):
            x, w, b = ln_inputs(rows, hidden, dtype, gen)
            out = ln.layer_norm(x, w, b, 1e-5)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != x.shape:
                raise AssertionError("layer_norm_fwd: wrong dtype/shape")
            case = f"rows={rows} hidden={hidden}"
            check("layer_norm_fwd", dtype, case, out,
                  ln._ln_ref(x, w, b, 1e-5), errors)
            same_twice("layer_norm_fwd", case, (out,),
                       (ln.layer_norm(x, w, b, 1e-5),))
        # the loop, for an input 2 or 4 bytes off a 16-byte line
        buf, w, b = ln_inputs(1, 300 * 768 + 1, dtype, gen)
        x = buf[0, 1:].view(300, 768)
        check("layer_norm_fwd", dtype, "rows=300 hidden=768 unaligned view",
              ln.layer_norm(x, w[:768], b[:768], 1e-5),
              ln._ln_ref(x, w[:768], b[:768], 1e-5), errors)


def attn_inputs(b, h, h_kv, sq, sk, d, dtype, gen):
    q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, h_kv, sk, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, h_kv, sk, d, generator=gen, device="cuda").to(dtype)
    return q, k, v


def decode_kpm(lanes, sk, gen):
    """Per-lane cache lengths; lane 0 is fully padded (a dead row)."""
    lens = torch.randint(1, sk + 1, (lanes,), generator=gen, device="cuda")
    lens[0] = 0
    lens[1] = sk
    return torch.arange(sk, device="cuda")[None, :] >= lens[:, None]


def flash_cases(gen):
    """(label, q, k, v, causal, kpm, window) at the path's shapes and the
    edge cases, for one dtype at a time."""
    def cases(dtype):
        for sq in (16, 100, 1024):
            q, k, v = attn_inputs(1, 12, 12, sq, sq, 64, dtype, gen)
            yield f"prefill causal (1,12,{sq},64)", q, k, v, True, None, None
        q, k, v = attn_inputs(8, 12, 12, 1, 1024, 64, dtype, gen)
        yield ("decode (8,12,1,64) sk=1024 key-padding", q, k, v, False,
               decode_kpm(8, 1024, gen), None)
        q, k, v = attn_inputs(2, 12, 4, 300, 300, 64, dtype, gen)
        yield "GQA 12q/4kv causal (2,12,300,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 32, 4, 600, 600, 64, dtype, gen)
        yield "GQA 32q/4kv causal (1,32,600,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(8, 32, 4, 1, 2048, 64, dtype, gen)
        yield ("GQA 32q/4kv decode (8,32,1,64) sk=2048 key-padding, a dead "
               "and a full lane", q, k, v, False, decode_kpm(8, 2048, gen),
               None)
        q, k, v = attn_inputs(1, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "window=256 causal (1,12,1024,64)", q, k, v, True, None, 256
        q, k, v = attn_inputs(1, 12, 12, 77, 200, 64, dtype, gen)
        yield "causal sq!=sk (1,12,77,64) sk=200", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 4, 77, 300, 64, dtype, gen)
        yield ("window=100 causal sq!=sk GQA 12q/4kv (1,12,77,64) sk=300", q,
               k, v, True, None, 100)
        # decode with sk a multiple of neither 64 nor the split (16 splits
        # of one tile), and decode under a sliding window
        q, k, v = attn_inputs(4, 32, 4, 1, 1000, 64, dtype, gen)
        yield ("GQA 32q/4kv decode (4,32,1,64) sk=1000 key-padding", q, k, v,
               False, decode_kpm(4, 1000, gen), None)
        q, k, v = attn_inputs(3, 8, 2, 1, 700, 64, dtype, gen)
        yield ("GQA 8q/2kv decode (3,8,1,64) sk=700 window=130 key-padding",
               q, k, v, True, decode_kpm(3, 700, gen), 130)
        # the tensor-core kernels' wider instantiation: d = 128, and d = 80
        # zero-padded to it (five 16-wide steps)
        q, k, v = attn_inputs(2, 16, 2, 512, 512, 128, dtype, gen)
        yield "GQA 16q/2kv causal d=128 (2,16,512,128)", q, k, v, True, None, \
            None
        q, k, v = attn_inputs(2, 12, 12, 300, 300, 80, dtype, gen)
        yield "causal d=80 (2,12,300,80)", q, k, v, True, None, None
        yield from wide_flash_cases(dtype, gen)
        q, k, v = attn_inputs(4, 8, 8, 1, 1000, 256, dtype, gen)
        yield ("decode d=256 (4,8,1,256) sk=1000 key-padding", q, k, v, False,
               decode_kpm(4, 1000, gen), None)
        q, k, v = attn_inputs(400, 2, 2, 1, 300, 160, dtype, gen)
        yield ("decode d=160 (400,2,1,160) sk=300 key-padding", q, k, v,
               False, decode_kpm(400, 300, gen), None)
        q, k, v = attn_inputs(4100, 16, 4, 1, 40, 64, dtype, gen)
        yield ("b*h=65600 decode GQA 16q/4kv (4100,16,1,64) sk=40 "
               "key-padding", q, k, v, False, decode_kpm(4100, 40, gen), None)
        yield from bert_flash_cases(dtype, gen)
        yield from gpt_training_flash_cases(dtype, gen)
        yield ulysses_flash_case(dtype, gen)
        q, k, v = attn_inputs(32, 16, 16, 512, 512, 64, dtype, gen)
        yield (BERT_SERVING_FLASH, q, k, v, False,
               lens_kpm(bert_serving_draw()[1].tolist(), 512), None)
        if dtype == torch.bfloat16:  # the Llama paths' shapes, in their dtype
            q, k, v = attn_inputs(1, 32, 4, 1536, 1536, 64, dtype, gen)
            yield ("Llama prefill GQA 32q/4kv causal (1,32,1536,64)", q, k, v,
                   True, None, None)
            q, k, v = attn_inputs(4, 32, 4, 2048, 2048, 64, dtype, gen)
            yield ("Llama training GQA 32q/4kv causal (4,32,2048,64)", q, k,
                   v, True, None, None)
    return cases


# BERT-345M's padded batch in the kernel-parity cases: the last row keeps
# one key of 512
BERT_LENS = (512, 400, 137, 1)


def lens_kpm(lens, sk):
    """(len(lens), sk) key-padding mask of these lengths (True = padded)."""
    lens = torch.tensor(lens, device="cuda")
    return torch.arange(sk, device="cuda")[None, :] >= lens[:, None]


BERT_SERVING_FLASH = ("BERT serving non-causal (32,16,512,64) key-padding, "
                      "the serving batch's 32 lengths")


# the contrib MHA example (apex_tpu_torch/examples/multihead_attn) at its
# sweep's top: 120 sequences of 64 tokens, hidden 1024, 16 heads of 64
MHA_FLASH_SHAPE = (120, 16, 16, 64, 64, 64)  # b, h, h_kv, sq, sk, d
MHA_ROWS = 120 * 64  # the pre-LayerNorm's rows


def mha_kpm(b=120, sk=64):
    """Encdec's key padding at the example's shape: sequence i keeps
    64 - (7i mod 65) keys, so lengths run over 0-64: sequence 0 keeps all
    and sequence 37 none (a fully padded row, whose output is zeros)."""
    return lens_kpm([64 - (7 * i) % 65 for i in range(b)], sk)


def mha_flash_label(padded, dtype):
    return ("contrib MHA non-causal (120,16,64,64)"
            + (" encdec key-padding" if padded else "")
            + f" {str(dtype)[6:]}")


def bert_flash_cases(dtype, gen):
    """BERT-345M's attention: non-causal (4,16,512,64), without and with a
    key-padding row (one row keeps a single key)."""
    q, k, v = attn_inputs(4, 16, 16, 512, 512, 64, dtype, gen)
    yield "BERT non-causal (4,16,512,64)", q, k, v, False, None, None
    yield ("BERT non-causal (4,16,512,64) key-padding, lengths "
           "512/400/137/1", q, k, v, False, lens_kpm(BERT_LENS, 512), None)


# GPT-2 small's attention at tp = 2: 6 of its 12 heads a rank, micro batch 4
GPT_TP2_FLASH = "GPT-2 tp=2 training causal (4,6,1024,64)"
# and at tp = 1 (the interleaved pipeline): all 12 heads, micro batch 4
GPT_TP1_MB4_FLASH = "GPT-2 tp=1 micro batch 4 training causal (4,12,1024,64)"


def gpt_training_flash_cases(dtype, gen):
    q, k, v = attn_inputs(4, 6, 6, 1024, 1024, 64, dtype, gen)
    yield GPT_TP2_FLASH, q, k, v, True, None, None
    q, k, v = attn_inputs(4, 12, 12, 1024, 1024, 64, dtype, gen)
    yield GPT_TP1_MB4_FLASH, q, k, v, True, None, None


# TinyLlama's attention under Ulysses at cp = 4: 32 / 4 query heads over
# 4 / 4 KV heads a rank, the cp-gathered 2048 tokens, the CP batch's ragged
# documents as key padding
ULYSSES_FLASH = ("Ulysses cp=4 GQA 8q/1kv causal (4,8,2048,64) key-padding, "
                 "the CP batch's lengths")


def ulysses_flash_case(dtype, gen):
    q, k, v = attn_inputs(4, 8, 1, 2048, 2048, 64, dtype, gen)
    return ULYSSES_FLASH, q, k, v, True, cp_kpm(), None


def wide_flash_cases(dtype, gen):
    """The forward and backward cases of the widest instantiation (head_dim
    256, and 160 zero-padded to it) and of batch x heads past the grid's y
    limit of 65535."""
    q, k, v = attn_inputs(2, 8, 2, 300, 300, 256, dtype, gen)
    yield "GQA 8q/2kv causal d=256 (2,8,300,256)", q, k, v, True, None, None
    q, k, v = attn_inputs(1, 4, 2, 77, 200, 256, dtype, gen)
    yield ("window=60 causal sq!=sk GQA 4q/2kv d=256 (1,4,77,256) sk=200", q,
           k, v, True, None, 60)
    q, k, v = attn_inputs(2, 4, 4, 150, 150, 160, dtype, gen)
    yield "non-causal d=160 (2,4,150,160)", q, k, v, False, None, None
    q, k, v = attn_inputs(4100, 16, 16, 20, 20, 64, dtype, gen)
    yield "b*h=65600 causal (4100,16,20,64)", q, k, v, True, None, None
    q, k, v = attn_inputs(4100, 16, 4, 9, 9, 256, dtype, gen)
    yield ("b*h=65600 GQA 16q/4kv d=256 (4100,16,9,256)", q, k, v, False,
           None, None)


def flash_parity(errors):
    from apex_tpu_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = flash_cases(gen)
    for dtype in (torch.float32, torch.bfloat16):
        for label, q, k, v, causal, kpm, window in cases(dtype):
            scale = 1.0 / math.sqrt(q.shape[-1])
            out, lse = at._flash_kernel(q, k, v, scale, causal, kpm, window)
            torch.cuda.synchronize()
            if out.dtype != dtype or out.shape != q.shape:
                raise AssertionError("flash_fwd: wrong dtype/shape")
            splits = at._decode_splits(q, k)
            if splits > 1:
                label += f", {splits} splits"
            ref, rl = at._flash_fwd_ref(q, k, v, scale, causal, kpm, window)
            check("flash_fwd", dtype, label, out, ref, errors)
            check("flash_fwd", dtype, label + " lse", lse, rl, errors,
                  tol_key="flash_fwd lse")
            if kpm is not None and bool(kpm[0].all()):
                if torch.count_nonzero(out[0]) != 0 or not bool(
                        (lse[0] == 1e30).all()):
                    raise AssertionError(f"flash_fwd {label}: the dead lane "
                                         f"is not o = 0, lse = +1e30")
            same_twice("flash_fwd", label, (out, lse), at._flash_kernel(
                q, k, v, scale, causal, kpm, window))


def same_twice(name, case, first, second):
    """Asserts that a repeat call on the same inputs is bit-equal."""
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{name} {case}: a repeat call differs")


def ln_bwd_parity(errors):
    """The LayerNorm backward against its plain version and against the
    loop kernel on the same inputs: at GPT-2's hidden 768 (3 vectors a lane
    in bf16), 1000, BERT-large's 1024 and GPT-2 XL's 1600 (7 vectors a lane
    in bf16, 13 in fp32: the loop), where the register-resident rows take
    the aligned shapes, and at the loop's own shapes (hidden 1001, not a
    multiple of the vector; an unaligned view); with and without w. Every
    case's repeat call is bit-equal."""
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def one(dtype, case, x, w, dy):
        got = ln._ln_bwd_kernel(x, w, dy, 1e-5)
        torch.cuda.synchronize()
        if got[0].dtype != dtype or got[0].shape != x.shape:
            raise AssertionError("layer_norm_bwd: wrong dtype/shape")
        for against, ref in (("", ln._ln_bwd_ref(x, w, dy, 1e-5)),
                             (" vs loop", ln._ln_bwd_kernel(x, w, dy, 1e-5,
                                                            loop=True))):
            check("layer_norm_bwd", dtype, f"{case} dx{against}", got[0],
                  ref[0], errors)
            for part, g, r in (("dgamma", got[1], ref[1]),
                               ("dbeta", got[2], ref[2])):
                check("layer_norm_bwd", dtype, f"{case} {part}{against}", g,
                      r, errors, tol_key="layer_norm_bwd dgamma/dbeta")
        same_twice("layer_norm_bwd", case, got,
                   ln._ln_bwd_kernel(x, w, dy, 1e-5))

    def grads(rows, hidden, dtype):
        return torch.randn(rows, hidden, generator=gen,
                           device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for rows in (1, 1000, 8192):
            for hidden in (768, 1000, 1024, 1600, 1001):
                x, w, _ = ln_inputs(rows, hidden, dtype, gen)
                one(dtype, f"rows={rows} hidden={hidden}", x, w,
                    grads(rows, hidden, dtype))
        # BERT-345M's rows: 4 x 512 tokens of hidden 1024; GPT-2's under
        # sequence parallelism at tp = 2: 4 x 1024 / 2 tokens of 768, and
        # at tp = 1 (the interleaved pipeline): 4 x 1024 tokens
        for rows, hidden in ((2048, 1024), (2048, 768), (4096, 768)):
            x, w, _ = ln_inputs(rows, hidden, dtype, gen)
            one(dtype, f"rows={rows} hidden={hidden}", x, w,
                grads(rows, hidden, dtype))
        x, _, _ = ln_inputs(1000, 768, dtype, gen)
        one(dtype, "rows=1000 hidden=768 no weight", x, None,
            grads(1000, 768, dtype))
        # the loop, for an input 2 or 4 bytes off a 16-byte line
        buf, w, _ = ln_inputs(1, 300 * 768 + 1, dtype, gen)
        one(dtype, "rows=300 hidden=768 unaligned view",
            buf[0, 1:].view(300, 768), w[:768], grads(300, 768, dtype))


def flash_bwd_cases(gen):
    """(label, q, k, v, causal, kpm, window) of the training shape and the
    edge cases, for one dtype at a time."""
    def cases(dtype):
        q, k, v = attn_inputs(8, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "causal (8,12,1024,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(2, 12, 12, 512, 512, 64, dtype, gen)
        yield "non-causal (2,12,512,64)", q, k, v, False, None, None
        q, k, v = attn_inputs(2, 12, 4, 300, 300, 64, dtype, gen)
        yield "GQA 12q/4kv causal (2,12,300,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 32, 4, 600, 600, 64, dtype, gen)
        yield "GQA 32q/4kv causal (1,32,600,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 12, 1024, 1024, 64, dtype, gen)
        yield "window=256 causal (1,12,1024,64)", q, k, v, True, None, 256
        q, k, v = attn_inputs(4, 12, 12, 256, 256, 64, dtype, gen)
        yield ("key padding, dead row (4,12,256,64)", q, k, v, True,
               decode_kpm(4, 256, gen), None)
        q, k, v = attn_inputs(2, 12, 12, 100, 100, 64, dtype, gen)
        yield "ragged s=100 causal (2,12,100,64)", q, k, v, True, None, None
        q, k, v = attn_inputs(1, 12, 12, 77, 200, 64, dtype, gen)
        yield "causal sq!=sk (1,12,77,64) sk=200", q, k, v, True, None, None
        yield from wide_flash_cases(dtype, gen)
        yield from bert_flash_cases(dtype, gen)
        yield from gpt_training_flash_cases(dtype, gen)
        yield ulysses_flash_case(dtype, gen)
        if dtype == torch.bfloat16:  # the Llama training shape, in its dtype
            q, k, v = attn_inputs(4, 32, 4, 2048, 2048, 64, dtype, gen)
            yield ("Llama training GQA 32q/4kv causal (4,32,2048,64)", q, k,
                   v, True, None, None)
            # the tensor-core kernels' wider instantiation: d = 128, and
            # d = 80 zero-padded to it (five 16-wide steps)
            q, k, v = attn_inputs(2, 16, 2, 512, 512, 128, dtype, gen)
            yield "GQA 16q/2kv causal d=128 (2,16,512,128)", q, k, v, True, \
                None, None
            q, k, v = attn_inputs(2, 12, 12, 300, 300, 80, dtype, gen)
            yield "causal d=80 (2,12,300,80)", q, k, v, True, None, None
    return cases


def flash_bwd_parity(errors):
    from apex_tpu_torch.ops import attention as at

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = flash_bwd_cases(gen)
    for dtype in (torch.float32, torch.bfloat16):
        for label, q, k, v, causal, kpm, window in cases(dtype):
            scale = 1.0 / math.sqrt(q.shape[-1])
            args = (scale, causal, kpm, window)
            o, lse = at._flash_kernel(q, k, v, *args)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            delta = (do.float() * o.float()).sum(-1)
            got = at._flash_bwd_kernel(q, k, v, do, lse, delta, *args)
            torch.cuda.synchronize()
            ref = at._flash_bwd_ref(q, k, v, do, lse, delta, *args)
            for g, r, t in zip(got, ref, (q, k, v)):
                if g.dtype != dtype or g.shape != t.shape:
                    raise AssertionError("flash backward: wrong dtype/shape")
            check("flash_bwd_dq", dtype, label + " dq", got[0], ref[0],
                  errors)
            check("flash_bwd_dkv", dtype, label + " dk", got[1], ref[1],
                  errors)
            check("flash_bwd_dkv", dtype, label + " dv", got[2], ref[2],
                  errors)
            if kpm is not None and torch.count_nonzero(
                    got[0][kpm.all(dim=1)]) != 0:
                raise AssertionError("flash backward: a dead row has a "
                                     "nonzero dq")
            same_twice("flash backward", label, got, at._flash_bwd_kernel(
                q, k, v, do, lse, delta, *args))


def adam_inputs(n, gen):
    g, p, m = (torch.randn(n, generator=gen, device="cuda") for _ in range(3))
    v = torch.rand(n, generator=gen, device="cuda") * 1e-2
    return g, p, m * 1e-1, v


ADAM_HYPER = dict(lr=3e-4, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01)


def adam_parity(errors):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for n in (N_GPT2_SMALL, 1_000_003):
        g, p, m, v = adam_inputs(n, gen)
        for adam_w_mode in (True, False):
            for step in (1, 10):
                stepf = torch.tensor(float(step), device="cuda")
                bc1, bc2 = 1.0 - 0.9 ** stepf, 1.0 - 0.999 ** stepf
                kw = dict(ADAM_HYPER, adam_w_mode=adam_w_mode)
                got = fk._adam_kernel(g, p, m, v, bc1, bc2, **kw)
                torch.cuda.synchronize()
                ref = fk._adam_flat_ref(g, p, m, v, bc1, bc2, **kw)
                case = (f"n={n} {'adamw' if adam_w_mode else 'l2'} "
                        f"step={step}")
                for part, a, b in zip(("update", "m", "v"), got, ref):
                    check("adam_update", torch.float32, f"{case} {part}", a, b,
                          errors)
                same_twice("adam_update", case, got,
                           fk._adam_kernel(g, p, m, v, bc1, bc2, **kw))
                del got, ref


def rms_parity(errors):
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for dtype in (torch.float32, torch.bfloat16):
        # TinyLlama at cp = 4: 2048 rows, a cp rank's 4 x 512 tokens in
        # training; 1024 (the decode prefill's 4 x 256) and 4 (a decode
        # step)
        for rows in (1, 4, 1000, 1024, 2048, 8192):
            for hidden in (2048, 1000, 770):
                for weighted in (True, False):
                    x, w, _ = ln_inputs(rows, hidden, dtype, gen)
                    w = w if weighted else None
                    dy = torch.randn(rows, hidden, generator=gen,
                                     device="cuda").to(dtype)
                    case = (f"rows={rows} hidden={hidden} "
                            f"{'weight' if weighted else 'no weight'}")
                    out = ln.rms_norm(x, w, 1e-5)
                    torch.cuda.synchronize()
                    if out.dtype != dtype or out.shape != x.shape:
                        raise AssertionError("rms_norm_fwd: wrong dtype/shape")
                    check("rms_norm_fwd", dtype, case, out,
                          ln._rms_ref(x, w, 1e-5), errors)
                    same_twice("rms_norm_fwd", case, (out,),
                               (ln.rms_norm(x, w, 1e-5),))
                    got = ln._rms_bwd_kernel(x, w, dy, 1e-5)
                    torch.cuda.synchronize()
                    ref = ln._rms_bwd_ref(x, w, dy, 1e-5)
                    if got[0].dtype != dtype or got[0].shape != x.shape:
                        raise AssertionError("rms_norm_bwd: wrong dtype/shape")
                    check("rms_norm_bwd", dtype, case + " dx", got[0], ref[0],
                          errors)
                    check("rms_norm_bwd", dtype, case + " dgamma", got[1],
                          ref[1], errors, tol_key="rms_norm_bwd dgamma")
                    same_twice("rms_norm_bwd", case, got,
                               ln._rms_bwd_kernel(x, w, dy, 1e-5))
        # the forward's routes: the register-resident row at its widest
        # (hidden 4096 bf16: 16 vectors a lane), and the loop for a row
        # beyond the register budget and for an unaligned input
        for rows, hidden in ((77, 4096), (77, 5120)):
            x, w, _ = ln_inputs(rows, hidden, dtype, gen)
            check("rms_norm_fwd", dtype, f"rows={rows} hidden={hidden}",
                  ln.rms_norm(x, w, 1e-5), ln._rms_ref(x, w, 1e-5), errors)
        buf, _, _ = ln_inputs(1, 300 * 2048 + 1, dtype, gen)
        x = buf[0, 1:].view(300, 2048)  # 2 or 4 bytes off a 16-byte line
        w = torch.randn(2048, generator=gen, device="cuda")
        check("rms_norm_fwd", dtype, "rows=300 hidden=2048 unaligned view",
              ln.rms_norm(x, w, 1e-5), ln._rms_ref(x, w, 1e-5), errors)
        # the backward's loop, for an unaligned x
        dy = torch.randn(300, 2048, generator=gen, device="cuda").to(dtype)
        got = ln._rms_bwd_kernel(x, w, dy, 1e-5)
        ref = ln._rms_bwd_ref(x, w, dy, 1e-5)
        case = "rows=300 hidden=2048 unaligned view"
        check("rms_norm_bwd", dtype, case + " dx", got[0], ref[0], errors)
        check("rms_norm_bwd", dtype, case + " dgamma", got[1], ref[1], errors,
              tol_key="rms_norm_bwd dgamma")
        same_twice("rms_norm_bwd", case, got, ln._rms_bwd_kernel(x, w, dy,
                                                                 1e-5))


# The RMSNorm forward's output (the first 16 hex digits of its sha256) on
# golden_input, recorded from its build before the LayerNorm forward came
# to share its kernels (the register-resident row where it fits, the loop
# at hidden 770): (dtype, rows, hidden, weighted) -> digest.
GOLDEN_RMS_FWD = {
    ("bfloat16", 8192, 2048, True): "3ab4b7fe8683a274",
    ("bfloat16", 8, 2048, True): "fdc9a65e00ac86d7",
    ("bfloat16", 8, 2048, False): "2c0039c0a99c0dd8",
    ("bfloat16", 77, 4096, True): "fea0c7ce19df10a0",
    ("bfloat16", 77, 1000, True): "c1dab8b7a2a7b4a1",
    ("bfloat16", 77, 770, True): "2690fc6487d8b1ee",
    ("float32", 300, 2048, True): "44879931e3be4d0b",
    ("float32", 77, 1000, False): "e56d56302bba85f6",
}


def golden_input(rows, hidden, dtype):
    """x (rows, hidden) in dtype and fp32 w, from integer arithmetic on
    the CPU, so that their bits do not depend on the card or on torch's
    random generators."""
    i = torch.arange(rows * hidden, dtype=torch.int64)
    x = ((i * 2654435761) % 65521).float() / 65521 * 8 - 4
    j = torch.arange(hidden, dtype=torch.int64)
    w = ((j * 40503) % 997).float() / 997 + 0.5
    return x.view(rows, hidden).to(dtype).cuda(), w.cuda()


def digest(t):
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def norm_routes():
    """The LayerNorm and RMSNorm forwards' register-resident row against
    their loop kernel on the same inputs (bit-equal: the same arithmetic in
    the same order), and the RMSNorm forward against GOLDEN_RMS_FWD."""
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    for dtype in (torch.float32, torch.bfloat16):
        for rms, rows, hidden in ((False, 8192, 768), (False, 768, 768),
                                  (False, 8, 768), (False, 77, 4096),
                                  (True, 8192, 2048), (True, 8, 2048),
                                  (True, 77, 4096)):
            x, w, b = ln_inputs(rows, hidden, dtype, gen)
            for wt, bt in ((w, b), (w, None), (None, None)):
                if rms and bt is not None:
                    continue
                row = ln.rms_norm(x, wt) if rms else ln.layer_norm(x, wt, bt)
                case = (f"{'rms_norm_fwd' if rms else 'layer_norm_fwd'} "
                        f"({rows},{hidden}) {str(dtype)[6:]} "
                        f"w={wt is not None} b={bt is not None}")
                if not torch.equal(row, ln._norm_fwd_loop(x, wt, bt, 1e-5,
                                                          rms)):
                    raise AssertionError(f"{case}: the row and the loop "
                                         f"differ")
                log(f"route {case}: row bit-equal to the loop")
    for (dt, rows, hidden, weighted), want in GOLDEN_RMS_FWD.items():
        x, w = golden_input(rows, hidden, getattr(torch, dt))
        got = digest(ln.rms_norm(x, w if weighted else None, 1e-5))
        log(f"golden rms_norm_fwd ({rows},{hidden}) {dt} weighted="
            f"{weighted}: {got} (recorded {want})")
        if got != want:
            raise AssertionError(f"rms_norm_fwd ({rows},{hidden}) {dt}: "
                                 f"output digest {got}, recorded {want}")


def fp64_sumsq(x):
    """The sum of squares in fp64, a chunk at a time (x may be 4.4 GB)."""
    return sum(float((c.double() ** 2).sum()) for c in x.split(1 << 26))


def sumsq_parity(errors):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    for n in (1, 1_000_003, ZERO_SHARD_TP2, N_TINYLLAMA):
        x = torch.randn(n, generator=gen, device="cuda")
        # the aligned buffer (float4 loads) and an unaligned view of it
        # (the scalar loop)
        for case, t in ((f"n={n}", x), (f"n={n - 1} unaligned view", x[1:])):
            if t.numel() == 0:
                continue
            got = fk.sumsq_flat(t)
            torch.cuda.synchronize()
            if got.dtype != torch.float32 or got.shape != ():
                raise AssertionError("sumsq_flat: wrong dtype/shape")
            check("sumsq_flat", torch.float32, case, got,
                  fk._sumsq_flat_ref(t), errors)
            exact = fp64_sumsq(t)
            rel = abs(float(got) - exact) / exact
            log(f"parity sumsq_flat {case} against fp64: relative error "
                f"{rel:.3e} (tol 1e-5)")
            if rel > 1e-5:
                raise AssertionError(f"sumsq_flat {case}: relative error "
                                     f"{rel} against the fp64 sum")
            same_twice("sumsq_flat", case, (got,), (fk.sumsq_flat(t),))
        del x
    torch.cuda.empty_cache()


# -- kernel timing ---------------------------------------------------------

def peak_flops(dtype):
    """The card's peak rate for products of ``dtype``: the tensor cores'
    for bf16, the fp32 units' for fp32 (the kernels' fp32 path is
    scalar)."""
    return BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS


def bound(bytes_moved, flops, peak_flops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_layer_norm(rows, hidden, graph=False, dtype=torch.bfloat16):
    """The forward at one shape: the kernel (through ``layer_norm``) and the
    library call timed in turns over three rounds, medians; with ``graph``,
    both also as CUDA graphs."""
    import torch.nn.functional as F

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x, w, b = ln_inputs(rows, hidden, dtype, gen)
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    esize = x.element_size()
    b_ms, by = bound(2 * rows * hidden * esize + 2 * hidden * 4,
                     8 * rows * hidden, FP32_FLOPS)
    err = float((ln.layer_norm(x, w, b) .float()
                 - ln._ln_ref(x, w, b, 1e-5).float()).abs().max())
    med, rounds = in_turns({
        "kernel": lambda: ln.layer_norm(x, w, b),
        "library": lambda: F.layer_norm(x, (hidden,), wl, bl)})
    out = {
        "shape": f"x ({rows},{hidden}) {str(dtype)[6:]}",
        "max_abs_err": err, "ms": med["kernel"],
        "plain_ms": time_ms(lambda: ln._ln_ref(x, w, b, 1e-5)),
        "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / med["kernel"],
        "library_ms": med["library"], "rounds": rounds,
    }
    if graph:
        y = torch.empty_like(x)
        out["graph_ms"] = graph_ms(lambda: _kernels.LAYER_NORM_FWD(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), rows,
            hidden, 1e-5, _kernels.dtype_code(x)))
        out["library_graph_ms"] = graph_ms(
            lambda: F.layer_norm(x, (hidden,), wl, bl))
        out["graph_bound_share"] = b_ms / out["graph_ms"]
    return out


def flash_fwd_launcher(q, k, v, kpm, scale, causal, window=None):
    """A closure that launches the forward kernel alone at these inputs (the
    wrapper's checks, reshapes and allocations done once, outside it)."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops import attention as at

    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    kpm32 = at._check_kernel_args(q, k, v, kpm)
    q3 = q.reshape(b * h, sq, d).contiguous()
    k3, v3 = (t.reshape(b * h_kv, sk, d).contiguous() for t in (k, v))
    o = torch.empty_like(q3)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device="cuda")
    splits = at._decode_splits(q, k)

    def launch():
        _kernels.FLASH_FWD(
            q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
            None if kpm32 is None else kpm32.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b * h, sq, sk, d, h, h // h_kv, splits,
            float(scale), int(causal), int(window or 0),
            _kernels.dtype_code(q))
    return launch


FLASH_FWD_ROUNDS = 3


def time_flash(label, q, k, v, causal, kpm, errors, graph=False):
    """The forward at one shape: the kernel (through ``flash_attention``)
    and the library call timed in turns, FLASH_FWD_ROUNDS rounds, medians;
    with ``graph``, both a second way, as CUDA graphs of the kernel alone
    and of the library call."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as at

    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    # the (query, key) pairs this run's masks keep, and the keys it needs
    keep = torch.ones(b, sq, sk, dtype=torch.bool, device="cuda")
    if causal:
        keep &= ~at.causal_mask(sq, sk, "cuda")
    if kpm is not None:
        keep &= ~kpm[:, None, :]
    pairs = int(keep.sum()) * h
    keys = int(keep.any(dim=1).sum()) * k.shape[1]
    esize = q.element_size()
    b_ms, by = bound((2 * q.numel() + 2 * keys * d) * esize
                     + b * h * sq * 4 + (kpm.numel() if kpm is not None else 0),
                     4 * pairs * d, peak_flops(q.dtype))
    out = at.flash_attention(q, k, v, causal=causal, key_padding_mask=kpm)
    ref = at._flash_ref(q, k, v, scale, causal, None, kpm)
    err = check("flash_fwd", q.dtype, label, out, ref, errors)
    del out, ref
    attn_mask = None if kpm is None else ~kpm[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal, scale=scale,
            enable_gqa=h != k.shape[1])

    med, rounds = in_turns({
        "kernel": lambda: at.flash_attention(q, k, v, causal=causal,
                                             key_padding_mask=kpm),
        "library": library}, FLASH_FWD_ROUNDS)
    row = {
        "shape": label, "max_abs_err": err, "ms": med["kernel"],
        "plain_ms": time_ms(lambda: at._flash_ref(
            q, k, v, scale, causal, None, kpm), iters=10),
        "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / med["kernel"],
        "library_ms": med["library"], "rounds": rounds,
    }
    if graph:
        row["graph_ms"] = graph_ms(flash_fwd_launcher(q, k, v, kpm, scale,
                                                      causal))
        row["library_graph_ms"] = graph_ms(library)
        row["graph_bound_share"] = b_ms / row["graph_ms"]
    return row


def time_layer_norm_bwd(rows, hidden, dtype=torch.bfloat16):
    """The backward at one shape: the kernel (through the wrapper), the
    loop kernel on the same inputs and the library's backward timed in
    turns over three rounds, medians; then the kernel's and the loop's
    launches alone and the library's backward kernel
    (``aten.native_layer_norm_backward``) as CUDA graphs."""
    import torch.nn.functional as F

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    x, w, b = ln_inputs(rows, hidden, dtype, gen)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").to(dtype)
    # reads x and dy, writes dx; reads w, writes dgamma and dbeta (fp32)
    b_ms, by = bound(3 * rows * hidden * x.element_size() + 3 * hidden * 4,
                     12 * rows * hidden, FP32_FLOPS)
    got = ln._ln_bwd_kernel(x, w, dy, 1e-5)
    ref = ln._ln_bwd_ref(x, w, dy, 1e-5)
    xl = x.detach().requires_grad_(True)
    wl = w.to(dtype).requires_grad_(True)
    bl = b.to(dtype).requires_grad_(True)
    yl = F.layer_norm(xl, (hidden,), wl, bl)
    med, rounds = in_turns({
        "kernel": lambda: ln._ln_bwd_kernel(x, w, dy, 1e-5),
        "loop": lambda: ln._ln_bwd_kernel(x, w, dy, 1e-5, loop=True),
        "library": lambda: torch.autograd.grad(
            yl, (xl, wl, bl), dy, retain_graph=True)})
    dx = torch.empty_like(x)
    blocks = -(-rows // ln._LN_BWD_ROWS)
    part = torch.empty((2, blocks, hidden), dtype=torch.float32,
                       device="cuda")
    out = torch.empty((2, hidden), dtype=torch.float32, device="cuda")

    def launch(kernel):
        return lambda: kernel(
            x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            part.data_ptr(), out.data_ptr(), rows, hidden, blocks, 1e-5,
            _kernels.dtype_code(x))

    wd, bd = wl.detach(), bl.detach()
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [hidden], wd, bd,
                                                     1e-5)
    row = {
        "shape": f"x, dy ({rows},{hidden}) {str(dtype)[6:]}",
        "max_abs_err": float((got[0].float() - ref[0].float()).abs().max()),
        "ms": med["kernel"], "loop_ms": med["loop"],
        "plain_ms": time_ms(lambda: ln._ln_bwd_ref(x, w, dy, 1e-5)),
        "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / med["kernel"],
        "library_ms": med["library"], "rounds": rounds,
        "graph_ms": graph_ms(launch(_kernels.LAYER_NORM_BWD)),
        "loop_graph_ms": graph_ms(launch(_kernels.LAYER_NORM_BWD_LOOP)),
        "library_graph_ms": graph_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [hidden], mean, rstd, wd, bd, [True, True, True])),
    }
    row["graph_bound_share"] = b_ms / row["graph_ms"]
    log(f"time layer_norm_bwd {row['shape']} loop kernel: {row['loop_ms']:.4f}"
        f" ms in turns, {row['loop_graph_ms']:.4f} ms as a graph")
    return row


FLASH_BWD_ROUNDS = 3


def time_flash_bwd(gen, b, h, h_kv, s, errors, d=64, causal=True, kpm=None,
                   dtype=torch.bfloat16):
    """dq and dk/dv at a training shape, (b, h, s, d) queries over h_kv
    key/value heads, in ``dtype``, causal or not, with or without a
    key-padding row. The plain version and the library call
    compute the whole backward (dq, dk and dv) and stand in both rows.
    The two kernels and the library's forward and forward+backward are
    timed in turns, FLASH_BWD_ROUNDS rounds, and each keeps its median, so
    that the kernels and the library are compared within one run."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import attention as at

    q, k, v = attn_inputs(b, h, h_kv, s, s, d, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    scale = 1.0 / math.sqrt(d)
    o, lse = at._flash_kernel(q, k, v, scale, causal, kpm)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, kpm)
    # the (query, key) pairs the masks keep
    keep = at._keep_mask(s, s, causal, None, kpm, "cuda").expand(b, 1, s, s)
    pairs = int(keep.sum()) * h
    got = at._flash_bwd_kernel(*args)
    ref = at._flash_bwd_ref(*args)
    plain_ms = time_ms(lambda: at._flash_bwd_ref(*args), iters=10)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    attn_mask = None if kpm is None else ~kpm[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=attn_mask,
                                              is_causal=causal, scale=scale,
                                              enable_gqa=h != h_kv)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa(), (qs, ks, vs), do)

    def sdpa_fwd():
        with torch.no_grad():
            sdpa()

    dq_fn, dkv_fn = flash_bwd_launchers(*args)
    rounds = {"dq": [], "dkv": [], "library": []}
    for _ in range(FLASH_BWD_ROUNDS):
        rounds["dq"].append(time_ms(dq_fn))
        rounds["dkv"].append(time_ms(dkv_fn))
        fwd_ms = time_ms(sdpa_fwd)
        rounds["library"].append(time_ms(sdpa_fwd_bwd) - fwd_ms)
    log(f"time flash backward rounds (b={b} h={h} h_kv={h_kv} s={s} d={d}): "
        + json.dumps(rounds))
    med = {name: statistics.median(ms) for name, ms in rounds.items()}
    esize = q.element_size()
    q_t = b * h * s * d * esize  # bytes of one (b, h, s, d) tensor
    kv_t = b * h_kv * s * d * esize  # bytes of one (b, h_kv, s, d) tensor
    rows = b * h * s * 4  # bytes of one fp32 (b, h, s) row vector
    # dq: reads q, k, v, dO, lse, delta, writes dq; dk/dv: reads the same,
    # writes dk and dv
    dq_bound = bound(3 * q_t + 2 * kv_t + 2 * rows, 3 * 2 * pairs * d,
                     peak_flops(dtype))
    dkv_bound = bound(2 * q_t + 4 * kv_t + 2 * rows, 4 * 2 * pairs * d,
                      peak_flops(dtype))
    name = str(dtype)[6:]
    label = (f"q,dO ({b},{h},{s},{d}) k,v ({b},{h_kv},{s},{d}) {name}"
             if h != h_kv else f"q,k,v,dO ({b},{h},{s},{d}) {name}")
    label += " causal" if causal else " non-causal"
    if kpm is not None:
        label += " key-padding"
    out = []
    for name, parts, bnd in (("flash_bwd_dq", ((0, "dq"),), dq_bound),
                             ("flash_bwd_dkv", ((1, "dk"), (2, "dv")),
                              dkv_bound)):
        err = max(check(name, q.dtype, f"{label} {part}", got[i], ref[i],
                        errors) for i, part in parts)
        ms = med[name[len("flash_bwd_"):]]
        out.append({"shape": label, "max_abs_err": err, "ms": ms,
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "bound_share": bnd[0] / ms, "plain_ms": plain_ms,
                    "library_ms": med["library"]})
    return [out[0]], [out[1]]


def flash_bwd_launchers(q, k, v, do, lse, delta, scale, causal, kpm=None):
    """Closures that launch the dq and the dk/dv kernel alone at these
    inputs (the wrapper's checks and reshapes done once, outside the timed
    launches)."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops import attention as at

    b, h, sq, d = q.shape
    h_kv, sk = k.shape[1], k.shape[2]
    q3, do3 = (t.reshape(b * h, sq, d).contiguous() for t in (q, do))
    k3, v3 = (t.reshape(b * h_kv, sk, d).contiguous() for t in (k, v))
    dq, dk, dv = (torch.empty_like(t) for t in (q3, k3, v3))
    splits = at._dkv_splits(q, k)
    work = torch.empty(2 * splits * k3.numel(), device="cuda")
    lse, delta = lse.contiguous(), delta.contiguous()
    kpm32 = at._check_kernel_args(q, k, v, kpm)
    ins = (q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), do3.data_ptr(),
           lse.data_ptr(), delta.data_ptr(),
           None if kpm32 is None else kpm32.data_ptr())
    shape = (b * h, sq, sk, d, h, h // h_kv)
    tail = (float(scale), int(causal), 0, _kernels.dtype_code(q))
    return (lambda: _kernels.FLASH_BWD_DQ(*ins, dq.data_ptr(), *shape, *tail),
            lambda: _kernels.FLASH_BWD_DKV(*ins, dk.data_ptr(), dv.data_ptr(),
                                           work.data_ptr(), *shape, splits,
                                           *tail))


def time_adam(n):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    g, p, m, v = adam_inputs(n, gen)
    stepf = torch.tensor(10.0, device="cuda")
    bc1, bc2 = 1.0 - 0.9 ** stepf, 1.0 - 0.999 ** stepf
    kw = dict(ADAM_HYPER, adam_w_mode=True)
    got = fk._adam_kernel(g, p, m, v, bc1, bc2, **kw)
    ref = fk._adam_flat_ref(g, p, m, v, bc1, bc2, **kw)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    del got, ref
    # reads g, p, m, v and writes the update, m and v, all fp32
    b_ms, by = bound(7 * 4 * n, 12 * n, FP32_FLOPS)
    pl = torch.nn.Parameter(p.clone())
    pl.grad = g.clone()
    opt = torch.optim.AdamW([pl], lr=ADAM_HYPER["lr"], eps=ADAM_HYPER["eps"],
                            weight_decay=ADAM_HYPER["weight_decay"],
                            fused=True)
    return {
        "shape": f"g, p, m, v ({n},) fp32, AdamW",
        "max_abs_err": err,
        "ms": time_ms(lambda: fk._adam_kernel(g, p, m, v, bc1, bc2, **kw),
                      iters=20),
        "plain_ms": time_ms(lambda: fk._adam_flat_ref(
            g, p, m, v, bc1, bc2, **kw), iters=10),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(opt.step, iters=20),
    }


def time_rms_norm(rows, hidden, graph=False):
    """The forward at one shape: the kernel (through ``rms_norm``) and the
    library call timed in turns over three rounds, medians; with ``graph``,
    both also as CUDA graphs."""
    import torch.nn.functional as F

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    x, w, _ = ln_inputs(rows, hidden, torch.bfloat16, gen)
    wl = w.to(x.dtype)
    # reads x and w, writes y; x^2, the sum, x * rstd * w per element
    b_ms, by = bound(2 * rows * hidden * x.element_size() + hidden * 4,
                     4 * rows * hidden, FP32_FLOPS)
    err = float((ln.rms_norm(x, w).float()
                 - ln._rms_ref(x, w, 1e-5).float()).abs().max())
    med, rounds = in_turns({
        "kernel": lambda: ln.rms_norm(x, w),
        "library": lambda: F.rms_norm(x, (hidden,), wl, 1e-5)})
    row = {
        "shape": f"x ({rows},{hidden}) bf16",
        "max_abs_err": err, "ms": med["kernel"],
        "plain_ms": time_ms(lambda: ln._rms_ref(x, w, 1e-5)),
        "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / med["kernel"],
        "library_ms": med["library"], "rounds": rounds,
    }
    if graph:
        y = torch.empty_like(x)
        row["graph_ms"] = graph_ms(lambda: _kernels.RMS_NORM_FWD(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), rows, hidden, 1e-5,
            _kernels.dtype_code(x)))
        row["library_graph_ms"] = graph_ms(
            lambda: F.rms_norm(x, (hidden,), wl, 1e-5))
        row["graph_bound_share"] = b_ms / row["graph_ms"]
    return row


def time_rms_norm_bwd(rows, hidden):
    import torch.nn.functional as F

    from apex_tpu_torch.ops import layer_norm as ln

    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x, w, _ = ln_inputs(rows, hidden, torch.bfloat16, gen)
    dy = torch.randn(rows, hidden, generator=gen, device="cuda").bfloat16()
    # reads x and dy, writes dx (bf16); reads w, writes dgamma
    b_ms, by = bound(3 * rows * hidden * 2 + 2 * hidden * 4,
                     10 * rows * hidden, FP32_FLOPS)
    got = ln._rms_bwd_kernel(x, w, dy, 1e-5)
    ref = ln._rms_bwd_ref(x, w, dy, 1e-5)
    xl = x.detach().requires_grad_(True)
    wl = w.bfloat16().requires_grad_(True)
    yl = F.rms_norm(xl, (hidden,), wl, 1e-5)
    # the kernel and the library's backward in turns, three rounds, medians
    # (the library's time moved by 3x between earlier runs)
    med, rounds = in_turns({
        "kernel": lambda: ln._rms_bwd_kernel(x, w, dy, 1e-5),
        "library": lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                               retain_graph=True)})
    return {
        "shape": f"x, dy ({rows},{hidden}) bf16",
        "max_abs_err": float((got[0].float() - ref[0].float()).abs().max()),
        "ms": med["kernel"],
        "plain_ms": time_ms(lambda: ln._rms_bwd_ref(x, w, dy, 1e-5)),
        "bound_ms": b_ms, "bound_by": by, "bound_share": b_ms / med["kernel"],
        "library_ms": med["library"], "rounds": rounds,
    }


def time_sumsq(n):
    from apex_tpu_torch.optimizers import _fused_kernels as fk

    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = torch.randn(n, generator=gen, device="cuda")
    # reads x once; a multiply and an add per element
    b_ms, by = bound(4 * n, 2 * n, FP32_FLOPS)
    out = {
        "shape": f"x ({n},) fp32",
        "max_abs_err": float((fk.sumsq_flat(x) - fk._sumsq_flat_ref(x)).abs()),
        "ms": time_ms(lambda: fk.sumsq_flat(x), iters=20),
        "plain_ms": time_ms(lambda: fk._sumsq_flat_ref(x), iters=10),
        "bound_ms": b_ms, "bound_by": by,
        "library_ms": time_ms(lambda: torch.linalg.vector_norm(x) ** 2,
                              iters=20),
    }
    del x
    torch.cuda.empty_cache()
    return out


def kernel_timings(errors):
    """Times every kernel at its path's shapes; the flash shapes' outputs
    are held to the flash tolerances too."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    # each LayerNorm shape also as a graph: through the wrapper, a call
    # of under 10 us on the card is timed at the host's launch rate
    out = {"layer_norm_fwd": [time_layer_norm(768, 768, graph=True),
                              time_layer_norm(8, 768, graph=True),
                              time_layer_norm(8192, 768, graph=True)]}
    q, k, v = attn_inputs(1, 12, 12, 768, 768, 64, torch.bfloat16, gen)
    prefill = time_flash("prefill causal q,k,v (1,12,768,64) bf16",
                         q, k, v, True, None, errors)
    q, k, v = attn_inputs(8, 12, 12, 1, 1024, 64, torch.bfloat16, gen)
    lens = torch.tensor([32, 100, 300, 500, 700, 800, 900, 1024],
                        device="cuda")
    kpm = torch.arange(1024, device="cuda")[None, :] >= lens[:, None]
    decode = time_flash("decode q (8,12,1,64) k,v (8,12,1024,64) bf16 "
                        "key-padding", q, k, v, False, kpm, errors,
                        graph=True)
    out["flash_fwd"] = [prefill, decode]
    q, k, v = attn_inputs(1, 32, 4, 1024, 1024, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        "Llama prefill causal q (1,32,1024,64) k,v (1,4,1024,64) bf16",
        q, k, v, True, None, errors))
    # the training shapes, where the fine-tuning and GPT-2 steps spend the
    # forward's time, and the Llama engine's decode step (lanes at cache
    # lengths of the serving run's spread, in a 2048-key cache)
    q, k, v = attn_inputs(4, 32, 4, 2048, 2048, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        "Llama training causal q (4,32,2048,64) k,v (4,4,2048,64) bf16",
        q, k, v, True, None, errors))
    q, k, v = attn_inputs(8, 12, 12, 1024, 1024, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        "GPT-2 training causal q,k,v (8,12,1024,64) bf16", q, k, v, True,
        None, errors))
    q, k, v = attn_inputs(4, 6, 6, 1024, 1024, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        "GPT-2 tp=2 training causal q,k,v (4,6,1024,64) bf16", q, k, v,
        True, None, errors))
    # gpt_tp_decode's step: a tp rank's 6 heads over a 256-slot cache,
    # the 8 lanes 129-160 positions in
    q, k, v = attn_inputs(8, 6, 6, 1, 256, 64, torch.bfloat16, gen)
    kpm = torch.arange(256, device="cuda")[None, :] >= torch.arange(
        129, 161, 4, device="cuda")[:, None]
    out["flash_fwd"].append(time_flash(
        "GPT-2 tp=2 decode q (8,6,1,64) k,v (8,6,256,64) bf16 key-padding",
        q, k, v, False, kpm, errors, graph=True))
    del q, k, v
    q, k, v = attn_inputs(8, 32, 4, 1, 2048, 64, torch.bfloat16, gen)
    lens = torch.tensor([64, 300, 500, 800, 1000, 1200, 1500, 1600],
                        device="cuda")
    kpm = torch.arange(2048, device="cuda")[None, :] >= lens[:, None]
    out["flash_fwd"].append(time_flash(
        "Llama decode q (8,32,1,64) k,v (8,4,2048,64) bf16 key-padding",
        q, k, v, False, kpm, errors, graph=True))
    # head_dim 256 (Gemma-2B's 8 query heads over one kv head), at a
    # training shape
    q, k, v = attn_inputs(4, 8, 1, 2048, 2048, 256, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        "d=256 training causal q (4,8,2048,256) k,v (4,1,2048,256) bf16",
        q, k, v, True, None, errors))
    del q, k, v
    # BERT-345M's pre-training and serving attention, non-causal
    q, k, v = attn_inputs(4, 16, 16, 512, 512, 64, torch.bfloat16, gen)
    bert_kpm = lens_kpm(BERT_LENS, 512)
    for kpm in (None, bert_kpm):
        out["flash_fwd"].append(time_flash(
            "BERT non-causal q,k,v (4,16,512,64) bf16"
            + (" key-padding 512/400/137/1" if kpm is not None else ""),
            q, k, v, False, kpm, errors))
    q, k, v = attn_inputs(32, 16, 16, 512, 512, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(
        BERT_SERVING_FLASH + " bf16", q, k, v, False,
        lens_kpm(bert_serving_draw()[1].tolist(), 512), errors))
    q, k, v = attn_inputs(4, 8, 1, 2048, 2048, 64, torch.bfloat16, gen)
    out["flash_fwd"].append(time_flash(ULYSSES_FLASH + " bf16", q, k, v,
                                       True, cp_kpm(), errors))
    del q, k, v
    # the contrib MHA example's widest point, fp32 (its dtype) and bf16:
    # self-attention, and encdec with the key padding of MHA_LENS
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = attn_inputs(*MHA_FLASH_SHAPE, dtype, gen)
        for kpm in (None, mha_kpm()):
            out["flash_fwd"].append(time_flash(
                mha_flash_label(kpm is not None, dtype), q, k, v, False, kpm,
                errors))
        del q, k, v
    # BERT-345M's rows, bf16 and the LM head's fp32: pre-training's 4 x 512
    # tokens of 1024 and serving's 32 x 512
    out["layer_norm_fwd"] += [time_layer_norm(rows, 1024, dtype=dtype)
                              for rows in (2048, 16384)
                              for dtype in (torch.bfloat16, torch.float32)]
    # GPT-2's rows under sequence parallelism at tp = 2
    out["layer_norm_fwd"].append(time_layer_norm(2048, 768))
    # the contrib MHA's pre-LayerNorm at the example's widest point
    out["layer_norm_fwd"] += [time_layer_norm(MHA_ROWS, 1024, dtype=dtype)
                              for dtype in (torch.float32, torch.bfloat16)]
    # GPT-2 training's rows (eight warps a block), and GPT-2 XL's width
    # (four warps a block)
    out["layer_norm_bwd"] = [time_layer_norm_bwd(8192, 768),
                             time_layer_norm_bwd(8192, 1600),
                             time_layer_norm_bwd(2048, 1024),
                             time_layer_norm_bwd(2048, 1024, torch.float32),
                             time_layer_norm_bwd(2048, 768)]
    dq, dkv = time_flash_bwd(gen, 8, 12, 12, 1024, errors)
    ldq, ldkv = time_flash_bwd(gen, 4, 32, 4, 2048, errors)
    wdq, wdkv = time_flash_bwd(gen, 4, 8, 1, 2048, errors, d=256)
    bdq, bdkv = time_flash_bwd(gen, 4, 16, 16, 512, errors, causal=False)
    pdq, pdkv = time_flash_bwd(gen, 4, 16, 16, 512, errors, causal=False,
                               kpm=bert_kpm)
    tdq, tdkv = time_flash_bwd(gen, 4, 6, 6, 1024, errors)  # GPT-2, tp = 2
    udq, udkv = time_flash_bwd(gen, 4, 8, 1, 2048, errors,  # Ulysses cp = 4
                               kpm=cp_kpm())
    out["flash_bwd_dq"] = dq + ldq + wdq + bdq + pdq + tdq + udq
    out["flash_bwd_dkv"] = dkv + ldkv + wdkv + bdkv + pdkv + tdkv + udkv
    # the contrib MHA example's widest point, with and without MHA_LENS
    for dtype in (torch.float32, torch.bfloat16):
        for kpm in (None, mha_kpm()):
            mdq, mdkv = time_flash_bwd(gen, *MHA_FLASH_SHAPE[:3],
                                       MHA_FLASH_SHAPE[3], errors,
                                       causal=False, kpm=kpm, dtype=dtype)
            out["flash_bwd_dq"] += mdq
            out["flash_bwd_dkv"] += mdkv
    out["layer_norm_bwd"] += [time_layer_norm_bwd(MHA_ROWS, 1024, dtype)
                              for dtype in (torch.float32, torch.bfloat16)]
    out["adam_update"] = [time_adam(N_GPT2_SMALL)]
    out["rms_norm_fwd"] = [time_rms_norm(8192, 2048),
                           time_rms_norm(8, 2048, graph=True),
                           time_rms_norm(2048, 2048)]  # a cp rank's rows
    out["rms_norm_bwd"] = [time_rms_norm_bwd(8192, 2048),
                           time_rms_norm_bwd(2048, 2048)]
    out["sumsq_flat"] = [time_sumsq(N_TINYLLAMA), time_sumsq(ZERO_SHARD_TP2),
                         time_sumsq(LAMB_SHARD_BERT)]
    for name, rows in out.items():
        for r in rows:
            share = (f", {100 * r['bound_share']:.1f}% of bound"
                     if "bound_share" in r else "")
            graphed = (f"; as CUDA graphs: kernel {r['graph_ms']:.4f} ms"
                       f"{share_of(r, 'graph_bound_share')}, library "
                       f"{r['library_graph_ms']:.4f} ms"
                       if "graph_ms" in r else "")
            log(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}){share}"
                f"{graphed}")
            if "rounds" in r:
                log(f"time {name} {r['shape']} rounds: "
                    + json.dumps(r["rounds"]))
    return out


def share_of(row, key):
    return f" ({100 * row[key]:.1f}% of bound)" if key in row else ""


# -- serving ---------------------------------------------------------------

def serving_phase(smi):
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, generate, gpt2_small_config
    from apex_tpu_torch.serving.profile import (
        make_requests,
        serve,
        serving_config,
    )

    cfg = serving_config(SEED)
    mcfg = gpt2_small_config()
    model = GPTModel(mcfg, device="cuda", seed=SEED)
    rs = np.random.RandomState(SEED)
    serve(model, make_requests(1, mcfg.vocab_size, rs), cfg)  # warm-up

    requests = make_requests(24, mcfg.vocab_size, rs)
    _kernels.reset_launch_counts()
    eng, reqs, wall = serve(model, requests, cfg)
    launches = _kernels.launch_counts()
    stats = eng.stats()
    done = stats["terminal"].get("completed", 0)
    if done != len(reqs):
        raise AssertionError(f"only {done} of {len(reqs)} requests "
                             f"completed: {stats['terminal']}")
    for r in reqs:
        if len(r.tokens_out) != r.max_new_tokens or not all(
                0 <= t < mcfg.vocab_size for t in r.tokens_out):
            raise AssertionError(f"request {r.rid}: bad tokens")
    for name in FORWARD_KERNELS:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"serving run")
    serving = {
        "model": "gpt2-small 12x768 vocab 50257 (random weights, bf16)",
        "requests": len(reqs), "completed": done,
        "tokens_out": stats["tokens_out"],
        "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
        "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "per_token_p50_ms": stats["per_token_p50_s"] * 1e3,
        "ticks": stats["ticks"], "launches": launches, "gpu": smi,
    }
    log("serving " + json.dumps(serving))

    # logits of a short input: kernels on the card vs plain path on CPU
    tokens = torch.as_tensor(rs.randint(0, mcfg.vocab_size, (1, 64)))
    f32 = gpt2_small_config(compute_dtype=torch.float32)
    gpu32 = GPTModel(f32, device="cuda", seed=SEED)
    cpu32 = GPTModel(f32, device="cpu", seed=SEED)
    cpu32.load_state_dict({k: v.cpu() for k, v in gpu32.state_dict().items()})
    with torch.no_grad():
        lg = gpu32(tokens.cuda()).cpu()
        lc = cpu32(tokens)
    if lg.shape != (1, 64, mcfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("logits: wrong shape or non-finite")
    lerr = float((lg - lc).abs().max())
    log(f"logits card vs cpu plain (fp32, 1x64 tokens): max_abs_err="
        f"{lerr:.3e} (atol 2e-3)")
    if lerr > 2e-3:
        raise AssertionError(f"logits disagree with the plain path: {lerr}")

    # exact tokens: the engine's greedy decode equals generate's, in fp32
    reqs32 = make_requests(4, mcfg.vocab_size, rs)
    eng32, out32, _ = serve(gpu32, [(p[:200], 16) for p, _ in reqs32], cfg)
    for r in out32:
        want = generate(gpu32, r.prompt[None], r.max_new_tokens)
        want = want[0, r.prompt_len:].tolist()
        if r.tokens_out != want:
            raise AssertionError(f"request {r.rid}: engine {r.tokens_out} "
                                 f"!= generate {want}")
    log(f"engine == generate on {len(out32)} fp32 greedy requests")
    return launches, serving


# -- the serving front end ---------------------------------------------------

# the TTFT budget the single engine arms after its load: this many times
# its measured per-admission cost (prefill + one decode tick, the EMAs
# estimated_ttft_s reads), so only the injected slow tick can breach it
TTFT_BUDGET_FACTOR = 3.0
# the chaos drill's kill lands mid-load: the prefill replica then holds
# most of the queue
FLEET_KILL_TICK = 8
# GPT-2 small's KV bytes a 16-token block: 12 layers x (K, V) x 12 heads
# x 16 tokens x 64 dims x itemsize
KV_BLOCK_ELEMENTS = 12 * 2 * 12 * 16 * 64


def _terminal_once(records, ids):
    """Every id in ``ids`` has exactly one terminal request record, and no
    other id has one."""
    seen = {}
    for r in records:
        if r.get("kind") == "request" and r.get("terminal"):
            seen.setdefault(r["id"], []).append(r["state"])
    return set(seen) == set(ids) and all(len(v) == 1 for v in seen.values())


def _identity(records):
    from apex_tpu_torch.monitor.goodput import account

    rep = account(records)
    lhs = rep.productive_s
    for phase in sorted(rep.badput_s):
        lhs = lhs + rep.badput_s[phase]
    return lhs + rep.unattributed_s == rep.wall_s and rep.productive_s > 0.0


def _latency(reqs):
    from apex_tpu_torch.serving import percentile

    ttft = [r.ttft_s for r in reqs if r.ttft_s is not None]
    tpot = [(r.end_t - r.first_token_t) / (len(r.tokens_out) - 1)
            for r in reqs if r.state == "completed" and len(r.tokens_out) > 1]
    return {"ttft_p50_ms": percentile(ttft, 50.0) * 1e3,
            "ttft_p99_ms": percentile(ttft, 99.0) * 1e3,
            "per_token_p50_ms": percentile(tpot, 50.0) * 1e3}


def _handoffs(records, itemsize):
    """(n, bytes, ms per handoff, every booking's bytes follow the block
    formula) from the ledger's and the x-ray's records."""
    outs = [r for r in records
            if r.get("kind") == "handoff" and r.get("side") == "out"]
    ms = [r["dur_s"] * 1e3 for r in records
          if r.get("kind") == "trace" and r.get("name") == "handoff"]
    exact = all(r["bytes"] == r["blocks"] * KV_BLOCK_ELEMENTS * itemsize
                for r in outs)
    return (len(outs), sum(r["bytes"] for r in outs),
            statistics.median(ms) if ms else None, exact)


def serving_fleet_phase(smi):
    """Phase 4b (module docstring): the engine's records, shedding and
    drain, the disaggregated pair and the chaos fleet, at GPT-2 small's
    full width."""
    import dataclasses

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, generate, gpt2_small_config
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.goodput import run_header
    from apex_tpu_torch.resilience.chaos import FaultPlan
    from apex_tpu_torch.serving import (
        PoissonLoadGenerator,
        ServingConfig,
        ServingEngine,
    )
    from apex_tpu_torch.serving.fleet import (
        FleetConfig,
        FleetRouter,
        engine_factory,
    )
    from apex_tpu_torch.serving.profile import make_requests, serving_config
    from apex_tpu_torch.serving.trace.analyze import analyze as xray

    t_phase = time.perf_counter()
    mcfg = gpt2_small_config()
    vocab = mcfg.vocab_size
    model = GPTModel(mcfg, device="cuda", seed=SEED)
    gpu32 = GPTModel(gpt2_small_config(compute_dtype=torch.float32),
                     device="cuda", seed=SEED)
    rs = np.random.RandomState(SEED + 1)
    main_reqs = make_requests(24, vocab, rs)
    pair_reqs = [(p[:200], 16) for p, _ in make_requests(4, vocab, rs)]
    drain_reqs = make_requests(6, vocab, rs)
    refs = [generate(gpu32, p[None], n)[0, len(p):].tolist()
            for p, n in pair_reqs]
    kinds = ("request", "run", "span", "trace", "memory", "fleet",
             "handoff", "slo")
    out = {"model": "gpt2-small 12x768 vocab 50257 (random weights)",
           "gpu": smi}

    def fail(msg):
        raise AssertionError(f"serving_fleet: {msg}")

    _kernels.reset_launch_counts()
    # -- (a) one engine: records, shedding, drain, closure ----------------
    mem = MemorySink(kinds=kinds, max_records=None)
    router = MetricRouter([mem])
    run_header(router, "serving-fleet-a")
    plan = FaultPlan()
    cfg = serving_config(SEED)
    eng = ServingEngine(model, cfg, router=router, fault_plan=plan).start()
    ptrs = (eng.k_pool.data_ptr(), eng.v_pool.data_ptr())
    t0 = time.perf_counter()
    reqs = [eng.submit(p, n) for p, n in main_reqs]
    filler = [eng.submit(rs.randint(0, vocab, size=32), 2)
              for _ in range(cfg.max_queue_depth - len(reqs) + 2)]
    while not eng.idle:
        eng.tick()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if any(r.state != "completed" for r in reqs):
        fail(f"main load: {eng.stats()['terminal']}")
    shed = [r.reason for r in filler if r.state == "rejected"]
    if shed != ["queue_full"] * 2:
        fail(f"queue overflow shed {shed}, expected 2 x queue_full")
    refused = [eng.submit(np.zeros((0,), np.int64), 4),
               eng.submit(np.array([vocab]), 4),
               eng.submit(rs.randint(0, vocab, size=1000), 100)]
    if [r.reason for r in refused] != ["malformed", "malformed", "too_long"]:
        fail(f"refusals booked {[r.reason for r in refused]}")
    tokens = sum(len(r.tokens_out) for r in reqs + filler)
    out["engine"] = {"requests": len(reqs), "fillers": len(filler),
                     "tokens_out": tokens, "wall_s": wall,
                     "tokens_per_s": tokens / wall, **_latency(reqs)}
    # arm the budget from the engine's own measured cost; only the
    # injected slow tick may breach it
    est0 = eng.estimated_ttft_s()
    budget = TTFT_BUDGET_FACTOR * est0
    eng.config = dataclasses.replace(cfg, ttft_budget_s=budget)
    calm = eng.submit(rs.randint(0, vocab, size=32), 4)
    calm_state = calm.state
    plan.slow_decode_steps = frozenset({eng._tick})
    plan.slow_decode_s = 2.0 * budget
    eng.tick()
    est1 = eng.estimated_ttft_s()
    hot = eng.submit(rs.randint(0, vocab, size=32), 4)
    if calm_state != "queued" or hot.reason != "ttft_budget":
        fail(f"TTFT shedding: before the fault {calm_state} "
             f"({calm.reason}), after it {hot.state} ({hot.reason}); "
             f"estimates {est0:.4f} -> {est1:.4f} s, budget {budget:.4f}")
    eng.config = cfg
    while not eng.idle:
        eng.tick()
    mid = [eng.submit(p, n) for p, n in drain_reqs]
    for _ in range(3):
        eng.tick()
    inflight = [r for r in mid if r.state == "decode"]
    queued = [r for r in mid if r.state == "queued"]
    report = eng.drain(grace_s=60.0)
    if (not inflight or not queued
            or any(r.state != "completed" for r in inflight)
            or any(r.reason != "draining" for r in queued)
            or eng.drain().get("redundant") is not True):
        fail(f"drain mid-load: {report}")
    eng2 = ServingEngine(model, ServingConfig(
        lanes=1, block_size=16, num_blocks=64, max_seq_len=1024),
        router=router).start()
    # a fresh id on the shared stream: its x-ray keys on ids
    r_e = eng2.submit(*drain_reqs[0], rid=len(eng.requests()))
    eng2.tick()
    report2 = eng2.drain(grace_s=0.0)
    if (r_e.reason, report2["evicted"]) != ("drain_deadline", 1):
        fail(f"zero-grace drain: {r_e.state} {r_e.reason} {report2}")
    router.close()
    recs = mem.snapshot()
    ids = [r.rid for r in eng.requests()] + [r.rid for r in eng2.requests()]
    checks = {
        "one terminal record a request": _terminal_once(recs, set(ids)),
        "pool free": (eng.allocator.free_blocks == cfg.num_blocks
                      and eng2.allocator.free_blocks == 64),
        "pool kept its storage": (eng.k_pool.data_ptr(),
                                  eng.v_pool.data_ptr()) == ptrs,
        "no kernel loaded after start()": (eng.steady_state_compiles
                                           == eng2.steady_state_compiles
                                           == 0),
        "goodput identity ==": _identity(recs),
        "x-ray passes": xray(recs).ok,
        "memory records": any(r["kind"] == "memory" for r in recs),
    }
    if not all(checks.values()):
        fail(f"engine checks {checks}")
    out["engine"].update(
        shed=eng.stats()["reasons"], ttft_budget_s=budget,
        estimate_before_s=est0, estimate_after_s=est1,
        drain_s=report["drain_s"], drain=report,
        zero_grace_drain_s=report2["drain_s"])
    log(f"serving_fleet (a) engine: {out['engine']['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {out['engine']['ttft_p50_ms']:.1f} ms p99 "
        f"{out['engine']['ttft_p99_ms']:.1f} ms, drain "
        f"{report['drain_s']:.3f} s; " + ", ".join(checks))

    # -- (b) the disaggregated pair in fp32: tokens through a handoff ------
    mem_b = MemorySink(kinds=kinds, max_records=None)
    router_b = MetricRouter([mem_b])
    run_header(router_b, "serving-fleet-b")
    cfg_b = ServingConfig(lanes=8, block_size=16, num_blocks=64,
                          max_seq_len=1024)
    fleet_b = FleetRouter(engine_factory(gpu32, cfg_b, router=router_b),
                          FleetConfig(replicas=2, prefill_replicas=1),
                          router=router_b).start()
    pair = [fleet_b.submit(p, n) for p, n in pair_reqs]
    while not fleet_b.idle:
        fleet_b.tick()
    fleet_b.drain(grace_s=10.0)
    router_b.close()
    recs_b = mem_b.snapshot()
    n_h, bytes_h, ms_h, exact = _handoffs(recs_b, 4)
    audit = fleet_b.ledger.audit()
    if [r.tokens_out for r in pair] != refs:
        fail("fp32 tokens through a handoff differ from generate's")
    if not (audit["matched"] and n_h >= len(pair) and exact
            and audit["bytes_in"] == audit["bytes_out"] == bytes_h):
        fail(f"handoff ledger {audit}, formula held: {exact}")
    if not (_terminal_once(recs_b, set(range(len(pair))))
            and xray(recs_b).ok and _identity(recs_b)):
        fail("the pair's stream does not close")
    out["pair"] = {"handoffs": n_h, "bytes": bytes_h, "ms_per_handoff": ms_h,
                   "bytes_per_block": KV_BLOCK_ELEMENTS * 4}
    log(f"serving_fleet (b) fp32 pair: generate's tokens on {len(pair)} "
        f"requests through {n_h} handoffs, {bytes_h} B, ledger matched")

    # -- (c) the chaos drill ----------------------------------------------
    mem_c = MemorySink(kinds=kinds, max_records=None)
    router_c = MetricRouter([mem_c])
    run_header(router_c, "serving-fleet-c")
    fleet = FleetRouter(
        engine_factory(model, serving_config(SEED), router=router_c),
        FleetConfig(replicas=3, prefill_replicas=1, miss_ticks_to_detect=2,
                    # the autoscaler's budget (admission never sheds):
                    # under the standing load it breaches at once
                    ttft_budget_s=1e-4, breach_ticks=2, min_replicas=1,
                    max_replicas=4),
        router=router_c,
        fault_plan=FaultPlan(kill_replica_steps={FLEET_KILL_TICK})).start()
    gen = PoissonLoadGenerator(rate_rps=40.0, vocab=vocab, n_requests=24,
                               prompt_len=(32, 768), max_new=(32, 64),
                               seed=SEED)
    t0 = time.perf_counter()
    # the seeded schedule injected at once (virtual time), so the kill
    # finds a loaded victim
    gen.pump(fleet, now=0.0)
    gen.pump(fleet, now=1e6)
    n = 0
    while not fleet.idle and n < 2000:
        fleet.tick()
        n += 1
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    for _ in range(6):  # probation needs clean ticks past idle
        fleet.tick()
    t0 = time.perf_counter()
    fleet_report = fleet.drain(grace_s=30.0)
    drain_c = time.perf_counter() - t0
    router_c.close()
    recs_c = mem_c.snapshot()
    fleet_recs = [r for r in recs_c if r.get("kind") == "fleet"]
    at = {}
    for r in fleet_recs:
        at.setdefault((r.get("check"), r.get("action")), r["step"])
    done = fleet.requests()
    tokens_c = sum(len(r.tokens_out) for r in done)
    n_hc, bytes_hc, ms_hc, exact_c = _handoffs(recs_c, 2)
    audit_c = fleet.ledger.audit()
    checks = {
        "kill": ("chaos", "kill_replica") in at,
        "re-dispatched": fleet.redispatched > 0 and any(
            r.get("attempt", 1) > 1 for r in recs_c
            if r.get("kind") == "request"),
        "restart": ("replica", "restarted") in at,
        "readmit": ("replica", "readmitted") in at,
        "scale-up": ("autoscale", "added") in at,
        "all completed": (len(done) == 24
                          and all(r.state == "completed" for r in done)),
        "one terminal record a global id": _terminal_once(
            recs_c, set(range(24))),
        "ledger matched": audit_c["matched"] and exact_c and n_hc > 0,
        "x-ray passes": xray(recs_c).ok,
        "goodput identity ==": _identity(recs_c),
        "no kernel loaded after start()": sum(
            rep.engine.steady_state_compiles for rep in fleet.replicas) == 0,
    }
    if not all(checks.values()):
        fail(f"chaos drill checks {checks}; fleet actions "
             f"{sorted(at.items(), key=lambda kv: kv[1])}")
    kill = at[("chaos", "kill_replica")]
    out["fleet"] = {
        "requests": len(done), "tokens_out": tokens_c, "ticks": n,
        "wall_s": wall_c, "tokens_per_s": tokens_c / wall_c,
        **_latency(done), "handoffs": n_hc, "handoff_bytes": bytes_hc,
        "ms_per_handoff": ms_hc, "redispatched": fleet.redispatched,
        "kill_tick": kill,
        "ticks_kill_to_detect": at[("replica", "detected")] - kill,
        "ticks_kill_to_readmit": at[("replica", "readmitted")] - kill,
        "scale_up_tick": at[("autoscale", "added")],
        "replicas": len(fleet.replicas), "drain_s": drain_c,
        "drain": {k: v for k, v in fleet_report.items() if k != "replicas"},
    }
    launches = _kernels.launch_counts()
    for name in PATH_KERNELS["serving_fleet"]:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"serving_fleet (c) chaos drill: {out['fleet']['tokens_per_s']:.1f} "
        f"tokens/s over {n} ticks, kill at tick {kill}, detected +"
        f"{out['fleet']['ticks_kill_to_detect']}, readmitted +"
        f"{out['fleet']['ticks_kill_to_readmit']}; " + ", ".join(checks))
    log("serving_fleet " + json.dumps(out))
    return launches, out


# -- training --------------------------------------------------------------

TRAIN_STEPS = 8


# -- the serving example and the monitor -------------------------------------

SERVE_GPT_MODEL = ["--layers", "12", "--hidden", "768", "--heads", "12",
                   "--vocab", "50257", "--max-seq-len", "1024", "--lanes",
                   "8", "--block-size", "16", "--blocks", "512",
                   "--seed", str(SEED)]
SERVE_GPT_LOAD = ["--rate", "12", "--prompt-len", "32", "768",
                  "--max-new", "32", "64"]
# the JAX overload drill's own faults
SERVE_GPT_DRILL = ["--requests", "96", *SERVE_GPT_LOAD, "--queue-depth", "16",
                   "--ttft-budget", "2", "--deadline", "30",
                   "--chaos-slow-decode-steps", "30,60",
                   "--chaos-slow-decode-s", "0.3",
                   "--chaos-abandon", "5,15,25", "--chaos-malformed", "10,20",
                   "--chaos-burst-steps", "40", "--chaos-burst-n", "12"]
SERVE_GPT_WEDGE = ["--requests", "24", *SERVE_GPT_LOAD,
                   "--chaos-hang-step", "20", "--stall-deadline", "2",
                   "--stall-dump-after", "1.5", "--stall-terminate-after", "3"]
SERVE_GPT_SIGTERM_AFTER = 40  # request records in the stream
SERVE_GPT_GRACE_S = 60.0
GPT_MONITOR_ARGV = ["--vocab", "50257", "--seq-len", "1024", "--layers", "12",
                    "--hidden", "768", "--heads", "12", "--micro-batch", "8",
                    "--global-batch", "16", "--steps", "6",
                    "--log-interval", "2", "--profile-step", "3",
                    "--xray-hbm", "--stall-deadline", "120"]
# each training kernel's names in a profiler trace (the __global__ symbols
# of its source)
TRACE_KERNELS = {
    "layer_norm_fwd": ("norm_fwd_row_kernel", "norm_fwd_kernel"),
    "layer_norm_bwd": ("ln_bwd_row_kernel", "norm_bwd_kernel"),
    "flash_fwd": ("flash_fwd_mma", "flash_fwd_kernel"),
    "flash_bwd_dq": ("flash_bwd_dq_mma", "flash_bwd_dq_kernel"),
    "flash_bwd_dkv": ("flash_bwd_dkv_mma", "flash_bwd_dkv_kernel"),
    "adam_update": ("adam_kernel",),
}


def _jsonl(path):
    out = []
    with open(path) as f:
        for line in f:
            try:
                out.append(json.loads(line))
            except ValueError:
                pass  # a line being written
    return out


def _serve_gpt_proc(extra, tmp, name):
    """Starts the serving example with its output in a file."""
    import os

    jsonl = os.path.join(tmp, f"{name}.jsonl")
    out = open(os.path.join(tmp, f"{name}.out"), "w")
    env = dict(os.environ, APEX_TPU_PREEMPTION_GRACE_S=str(SERVE_GPT_GRACE_S))
    proc = subprocess.Popen(
        [sys.executable, "-m", "apex_tpu_torch.examples.serving.serve_gpt",
         *SERVE_GPT_MODEL, *extra, "--metrics-jsonl", jsonl],
        stdout=out, stderr=subprocess.STDOUT, text=True, env=env)
    return proc, jsonl, out


def _goodput_identity(records):
    from apex_tpu_torch.monitor.goodput import BADPUT_PHASES

    (g,) = [r for r in records if r.get("kind") == "goodput"][-1:]
    total = g["productive_s"]
    for phase in BADPUT_PHASES:
        total = total + g[f"badput_{phase}_s"]
    return total + g["unattributed_s"] == g["wall_s"] and g["productive_s"] > 0


def serve_gpt_sigterm_drill(tmp):
    """(a): the overload drill under a mid-load SIGTERM."""
    import signal

    from apex_tpu_torch.monitor.xray.hbm import predict_serving_memory

    proc, jsonl, out = _serve_gpt_proc(SERVE_GPT_DRILL, tmp, "sigterm")
    try:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < 120 and proc.poll() is None:
            time.sleep(0.05)
            try:
                with open(jsonl) as f:
                    n = f.read().count('"kind": "request"')
            except FileNotFoundError:
                continue
            if n >= SERVE_GPT_SIGTERM_AFTER:
                break
        if proc.poll() is not None or n < SERVE_GPT_SIGTERM_AFTER:
            raise AssertionError(f"serve_gpt ended or stalled before the "
                                 f"SIGTERM ({n} request records)")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
        out.close()
    text = open(out.name).read()
    if rc != 0 or "termination notice: draining" not in text:
        raise AssertionError(f"serve_gpt SIGTERM drill rc={rc}:\n"
                             f"{text[-4000:]}")
    summary = json.loads(text.strip().splitlines()[-1])
    records = _jsonl(jsonl)
    ids = {r["id"] for r in records if r.get("kind") == "request"}
    if not _terminal_once(records, ids) or len(ids) != summary["submitted"]:
        raise AssertionError("serve_gpt: not one terminal record an id")
    reasons = summary["reasons"]
    shed = reasons.get("ttft_budget", 0) + reasons.get("queue_full", 0)
    if shed == 0 or not reasons.get("malformed") or not reasons.get(
            "client_cancel"):
        raise AssertionError(f"serve_gpt: reasons {reasons}")
    if not _goodput_identity(records):
        raise AssertionError("serve_gpt: the goodput identity broke")
    if summary["steady_state_compiles"] != 0:
        raise AssertionError(f"serve_gpt: {summary['steady_state_compiles']}"
                             f" steady-state kernel loads")
    pool = predict_serving_memory(num_layers=12, num_kv_heads=12,
                                  head_dim=64, num_blocks=512, block_size=16)
    if not (summary["kv_pool_bytes"] == pool.component_bytes("kv_pool")
            == 512 * 589_824):
        raise AssertionError(f"KV pool {summary['kv_pool_bytes']} bytes, "
                             f"ledger {pool.component_bytes('kv_pool')}")
    drill = {
        "tokens_per_s": summary["tokens_per_s"],
        "ttft_p50_ms": summary["ttft_p50_s"] * 1e3,
        "ttft_p99_ms": summary["ttft_p99_s"] * 1e3,
        "submitted": summary["submitted"], "terminal": summary["terminal"],
        "reasons": reasons, "shed_share": shed / summary["submitted"],
        "drain_s": summary["drain"]["drain_s"],
        "drain": summary["drain"], "wall_s": summary["wall_s"],
        "kv_pool_bytes": summary["kv_pool_bytes"],
    }
    log("serve_gpt sigterm drill " + json.dumps(drill))
    return summary["launch_counts"], drill


def serve_gpt_wedge_drill(tmp):
    """(b): the wedge at tick 20 and the incident ladder's exit."""
    from apex_tpu_torch.monitor.goodput import account

    proc, jsonl, out = _serve_gpt_proc(SERVE_GPT_WEDGE, tmp, "wedge")
    try:
        rc = proc.wait(timeout=180)
        t_exit = time.monotonic()
    finally:
        if proc.poll() is None:
            proc.kill()
        out.close()
    text = open(out.name).read()
    if rc != 43:
        raise AssertionError(f"serve_gpt wedge drill rc={rc}:\n"
                             f"{text[-4000:]}")
    records = _jsonl(jsonl)
    stages = [(r["kind"], r.get("stage") or r.get("phase")) for r in records]
    need = [("stall", None), ("incident", "dump"), ("span", "incident"),
            ("incident", "terminate")]
    if any(k not in stages for k in need):
        raise AssertionError(f"serve_gpt wedge: records {stages[-12:]}")
    dump, term = (stages.index(("incident", s)) for s in ("dump", "terminate"))
    span = records[stages.index(("span", "incident"))]
    # the span starts at the last heartbeat (CLOCK_MONOTONIC, shared by
    # both processes): the wedge
    wedge_to_exit = t_exit - span["start"]
    rep = account(records)
    lhs = rep.productive_s
    for phase in sorted(rep.badput_s):
        lhs = lhs + rep.badput_s[phase]
    identity = lhs + rep.unattributed_s == rep.wall_s
    if not dump < term or wedge_to_exit > 30.0 or not identity:
        raise AssertionError(f"serve_gpt wedge: dump {dump} terminate {term}"
                             f" wedge-to-exit {wedge_to_exit:.1f} s, "
                             f"identity {identity}")
    wedge = {"exit_code": rc, "wedge_to_exit_s": wedge_to_exit,
             "incident_span_s": span["dur_s"],
             "dump_overdue_s": records[dump]["overdue_s"],
             "terminate_overdue_s": records[term]["overdue_s"],
             "badput_incident_s": rep.badput_s.get("incident"),
             "inflight_at_dump": len(records[dump].get("requests", []))}
    log("serve_gpt wedge drill " + json.dumps(wedge))
    return wedge


def serve_gpt_beam_and_bag():
    """(c): beam search in bf16 and fp32 on GPT-2 small, and the bag."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import (
        GPTModel,
        beam_search,
        generate,
        gpt2_small_config,
        gpt_loss_fn,
    )
    from apex_tpu_torch.monitor import (
        global_grad_norm,
        host_fetch_count,
        metric_bag,
        read_bag,
    )
    from apex_tpu_torch.monitor.xray.hbm import (
        TransformerDims,
        gpt_param_elements,
    )

    mcfg = gpt2_small_config()
    model = GPTModel(mcfg, device="cuda", seed=SEED)
    numel = sum(p.numel() for p in model.parameters())
    ledger = gpt_param_elements(TransformerDims.from_config(mcfg))
    if not numel == ledger == N_GPT2_SMALL:
        raise AssertionError(f"GPT-2 small: {numel} parameters, ledger "
                             f"{ledger}")
    prompts = np.random.RandomState(SEED).randint(0, mcfg.vocab_size, (2, 64))
    beam_search(model, prompts[:, :8], 2, 4)  # warm-up
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, scores = beam_search(model, prompts, 32, 4)
    torch.cuda.synchronize()
    beam_ms = (time.perf_counter() - t0) * 1e3
    launches = _kernels.launch_counts()
    if tokens.shape != (2, 4, 96) or not torch.isfinite(scores).all() or \
            not bool((tokens[:, :, 64:] < mcfg.vocab_size).all()):
        raise AssertionError("bf16 beam search: bad tokens or scores")

    f32 = gpt2_small_config(compute_dtype=torch.float32)
    gpu32 = GPTModel(f32, device="cuda", seed=SEED)
    cpu32 = GPTModel(f32, device="cpu", seed=SEED)
    cpu32.load_state_dict({k: v.cpu() for k, v in gpu32.state_dict().items()})
    tc, sc = beam_search(gpu32, prompts, 32, 4)
    tp, sp = beam_search(cpu32, prompts, 32, 4, device="cpu")
    serr = float((sc.cpu() - sp).abs().max())
    log(f"beam search fp32 card vs cpu plain (2 x 64 prompts, 4 beams, 32 "
        f"new): tokens equal {torch.equal(tc.cpu(), tp)}, scores "
        f"max_abs_err={serr:.3e} (atol 1e-4)")
    if not torch.equal(tc.cpu(), tp) or serr > 1e-4:
        raise AssertionError("fp32 beam search disagrees with the plain path")
    one, _ = beam_search(gpu32, prompts, 32, 1)
    if not torch.equal(one[:, 0], generate(gpu32, prompts, 32)):
        raise AssertionError("one beam is not greedy generate")
    del gpu32, cpu32

    # the bag: global_grad_norm (#9) of a backward's grads, one fetch
    rs = np.random.RandomState(SEED + 1)
    x = torch.as_tensor(rs.randint(0, mcfg.vocab_size, (2, 128)),
                        device="cuda")
    loss = gpt_loss_fn(model(x[:, :-1], labels=x[:, 1:]))
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    bag = metric_bag({"grad_norm": "mean", "loss": "mean"})
    fetches = host_fetch_count()
    bag.add(grad_norm=global_grad_norm(grads), loss=loss.detach())
    torch.cuda.synchronize()
    norm_launches = _kernels.launch_counts()
    vals = read_bag(bag)
    ref = math.sqrt(sum(float(g.double().square().sum())
                        for g in grads.values()))
    rel = abs(vals["grad_norm"] - ref) / ref
    if host_fetch_count() - fetches != 1 or rel > 1e-5 or not math.isfinite(
            vals["loss"]):
        raise AssertionError(f"bag: {vals}, fp64 norm {ref}, fetches "
                             f"{host_fetch_count() - fetches}")
    beam = {"beam_ms_bf16": beam_ms, "fp32_scores_max_abs_err": serr,
            "grad_norm_rel_err_vs_fp64": rel, "parameters": numel}
    log("serve_gpt beam and bag " + json.dumps(beam))
    del model, grads
    torch.cuda.empty_cache()
    return launches, norm_launches, beam


def gpt_monitor_run(tmp):
    """(d): the GPT example under its telemetry flags."""
    import os

    jsonl = os.path.join(tmp, "gpt.jsonl")
    prof = os.path.join(tmp, "profiles")
    cmd = [sys.executable, "-m", "apex_tpu_torch.examples.gpt.pretrain_gpt",
           *GPT_MONITOR_ARGV, "--metrics-jsonl", jsonl, "--profile-dir", prof]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the GPT example exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-4000:]}")
    step_ms = [float(line.split()[11]) for line in proc.stdout.splitlines()
               if line.startswith("step ")]
    (tel,) = [json.loads(line)["telemetry"]
              for line in proc.stdout.splitlines()
              if line.startswith('{"telemetry"')]
    records = _jsonl(jsonl)
    metrics = [r for r in records if r["kind"] == "metrics"]
    mfus = [r["mfu"] for r in metrics]
    if len(metrics) != 3 or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            and r["tokens_per_s"] > 0 for r in metrics) or not all(
            m is not None and 0.0 < m <= 1.05 for m in mfus):
        raise AssertionError(f"GPT example metrics: {metrics}")
    if not tel["host_fetches"] == tel["intervals"] == 3:
        raise AssertionError(f"GPT example fetches: {tel}")
    memory = [r for r in records
              if r["kind"] == "memory" and r.get("scope") == "device"]
    if not memory or any(r["peak_bytes_in_use"] > r["capacity_bytes"]
                         for r in memory):
        raise AssertionError(f"GPT example memory records: {memory}")
    if tel["stalls"] or [r for r in records if r["kind"] in ("stall",
                                                             "incident")]:
        raise AssertionError("GPT example: a stall record")
    (trace,) = tel["captures"]
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    missing = [k for k, subs in TRACE_KERNELS.items()
               if not any(s in n for n in names for s in subs)]
    if missing:
        raise AssertionError(f"the trace names no kernel of {missing}")
    hs = tel["hbm"]
    mon = {
        "step_ms": step_ms,
        "profiled_step_ms": statistics.mean(step_ms[3:5]),
        "unprofiled_step_ms": statistics.mean(step_ms[1:3] + step_ms[5:]),
        "tokens_per_s": [r["tokens_per_s"] for r in metrics],
        "mfu": mfus, "peak_flops": tel["peak_flops"],
        "flops_per_step": tel["flops_per_step"],
        "host_fetches": tel["host_fetches"], "intervals": tel["intervals"],
        "trace_kernels": len(names),
        "predicted_resident_bytes": hs["predicted_resident_bytes"],
        "measured_resident_bytes": memory[-1]["bytes_in_use"],
        "predicted_peak_bytes": hs["predicted_peak_bytes"],
        "measured_peak_bytes": hs["achieved_peak_bytes"],
        "capacity_bytes": memory[-1]["capacity_bytes"],
    }
    log("gpt monitor " + json.dumps(mon))
    return tel["launch_counts"], mon


def oom_guard_check():
    from apex_tpu_torch.monitor import MemorySink, MetricRouter
    from apex_tpu_torch.monitor.xray.hbm import oom_guard

    mem = MemorySink()
    router = MetricRouter([mem])
    total = torch.cuda.mem_get_info()[1]
    try:
        with oom_guard(router, 0, capacity_bytes=total):
            torch.empty(2 * total, dtype=torch.uint8, device="cuda")
        raise AssertionError("an allocation of twice the card succeeded")
    except torch.cuda.OutOfMemoryError:
        pass
    router.close()
    oom = [r for r in mem.records if r["kind"] == "oom"]
    if len(oom) != 1 or oom[0]["capacity_bytes"] != total:
        raise AssertionError(f"oom_guard records: {oom}")
    torch.cuda.empty_cache()
    log(f"oom_guard: one kind='oom' record, OutOfMemoryError re-raised "
        f"({2 * total} bytes asked of {total})")


def serve_gpt_phase(smi):
    """Phase 4c (module docstring): the serving example's drills, beam
    search, the bag and the GPT example's monitor."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="serve_gpt-")
    try:
        t0 = time.perf_counter()
        serve_launches, drill = serve_gpt_sigterm_drill(tmp)
        t1 = time.perf_counter()
        wedge = serve_gpt_wedge_drill(tmp)
        t2 = time.perf_counter()
        beam_launches, norm_launches, beam = serve_gpt_beam_and_bag()
        t3 = time.perf_counter()
        gpt_launches, mon = gpt_monitor_run(tmp)
        oom_guard_check()
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"serve_gpt phase: sigterm drill {t1 - t0:.1f} s, wedge drill "
        f"{t2 - t1:.1f} s, beam and bag {t3 - t2:.1f} s, GPT monitor "
        f"{t4 - t3:.1f} s")
    log("serve_gpt " + json.dumps({"sigterm": drill, "wedge": wedge,
                                   "beam": beam, "monitor": mon, "gpu": smi}))
    return {"serve_gpt": serve_launches, "serve_gpt_beam": beam_launches,
            "monitor_grad_norm": norm_launches,
            "gpt_monitor": gpt_launches}, mon


def token_file_lm(vocab, seq_len, n_tokens=200_000):
    """The synthetic corpus written as a token file (``synthetic_corpus``)
    and read as the examples read it: memory-mapped
    (``data.IndexedTokenDataset``), each batch gathered by the native host
    library (``_native``)."""
    from apex_tpu_torch.data import IndexedTokenDataset, LMDataset
    from apex_tpu_torch.resilience.replay import synthetic_corpus

    return LMDataset(IndexedTokenDataset(synthetic_corpus(vocab, n_tokens)),
                     seq_len)


# the token-file gathers timed on the card's host: GPT-2 training's
# global batch (16 x 1025 int32, 65.6 kB), TinyLlama fine-tuning's
# (4 x 2049) and a 1024 x 2049 batch (8.4 MB, past the library's 8 MB
# threshold: striped over threads)
NATIVE_GATHERS = ((16, 1024), (4, 2048), (1024, 2048))


def native_phase(smi):
    """The native host library on the card's host: built with g++ from the
    checkout's ``apex_tpu_torch/csrc/apex_tpu_C.cpp`` (or taken from the
    build cache) and loaded, its ABI checked; then each NATIVE_GATHERS
    batch gathered from a token file through ``LMDataset.batch``
    (``_native.gather_rows``), bit-equal to numpy's fancy index of the
    same rows (the plain version), both timed (median of 20)."""
    from apex_tpu_torch import _kernels, _native

    t0 = time.perf_counter()
    _native.library()
    out = {"gpu": smi, "library": os.path.relpath(
        _kernels.host_library_path("apex_tpu_C"),
        os.path.dirname(os.path.abspath(__file__))),
        "build_and_load_s": time.perf_counter() - t0,
        "abi": _native.ABI_VERSION, "threads": _native._MT_THREADS}
    lm = token_file_lm(50257, 2048, n_tokens=1024 * 2048 + 1)
    tokens = np.asarray(lm.ds.tokens)
    rows = []
    for n, seq in NATIVE_GATHERS:
        offs = np.arange(n, dtype=np.int64) * seq
        got = _native.gather_rows(lm.ds.tokens, offs, seq + 1)
        want = tokens[offs[:, None] + np.arange(seq + 1)]
        if not np.array_equal(got, want):
            raise AssertionError(f"gather_rows ({n}, {seq + 1}) differs "
                                 f"from numpy's")

        def ms(fn):
            ts = []
            for _ in range(20):
                t = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t) * 1e3)
            return statistics.median(ts)

        rows.append({
            "rows": n, "row_len": seq + 1, "bytes": got.nbytes,
            "threaded": got.nbytes >= _native._MT_BYTES_THRESHOLD,
            "native_ms": ms(lambda: _native.gather_rows(
                lm.ds.tokens, offs, seq + 1)),
            "numpy_ms": ms(lambda: tokens[offs[:, None]
                                          + np.arange(seq + 1)])})
    out["gathers"] = rows
    log("native " + json.dumps(out))
    return out


def training_phase(smi):
    """GPT-2 small at full width through ``build_gpt_training``: one
    warm-up step, then TRAIN_STEPS measured steps."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import gpt2_small_config
    from apex_tpu_torch.resilience import VERDICT_OK, verdict_name
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
    )
    from apex_tpu_torch.resilience.replay.journal import batch_crc

    cfg = GPTTargetConfig(vocab=50257, seq_len=1024, layers=12, hidden=768,
                          heads=12, micro_batch=8, global_batch=16, lr=3e-4,
                          weight_decay=0.01, seed=SEED)
    tr = build_gpt_training(cfg, device="cuda")
    if tr.transformer_config != gpt2_small_config():
        raise AssertionError("the training target is not GPT-2 small")
    state = tr.init_state()
    n_params = sum(p.numel() for p in state.params.values())
    if len(state.params) != 148 or n_params != N_GPT2_SMALL:
        raise AssertionError(f"{len(state.params)} parameters of "
                             f"{n_params} elements")
    lm = token_file_lm(cfg.vocab, cfg.seq_len)

    def batch(i):
        first = (i * cfg.global_batch) % (len(lm) - cfg.global_batch + 1)
        return tr.reshape_batch(*lm.batch(range(first,
                                                first + cfg.global_batch)))

    # the first batches' crc32s (the journal's batch_crc): the token file's
    # bytes through the native gather, the same on any host
    crcs = [batch_crc(*lm.batch(range(i * cfg.global_batch,
                                      (i + 1) * cfg.global_batch)))
            for i in range(3)]
    log(f"training: token file {lm.ds.prefix}.bin ({len(lm.ds)} tokens), "
        f"first batches' crc32 {crcs}")
    state, loss0, verdict0, _ = tr.train_step(state, *batch(0))  # warm-up
    torch.cuda.synchronize()
    bad = [n for n, p in state.params.items()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    if bad or verdict0 != VERDICT_OK:
        raise AssertionError(f"warm-up step: verdict {verdict0}, no finite "
                             f"gradient for {bad}")
    log(f"training warm-up: loss {loss0:.4f}; all 148 parameters got a "
        f"finite gradient")

    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps, t_all = [], 0.0
    for i in range(1, TRAIN_STEPS + 1):
        x, y = batch(i)
        t0 = time.perf_counter()
        state, loss, verdict, metrics = tr.train_step(state, x, y)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        t_all += ms
        steps.append(dict(step=i, loss=loss, grad_norm=metrics["grad_norm"],
                          loss_scale=metrics["loss_scale"],
                          verdict=verdict_name(verdict), step_ms=ms))
        log(f"train step {i} loss {loss:.4f} grad_norm "
            f"{metrics['grad_norm']:.4f} loss_scale "
            f"{metrics['loss_scale']:.1f} verdict {verdict_name(verdict)} "
            f"step_ms {ms:.2f}")
    launches = _kernels.launch_counts()
    tokens = TRAIN_STEPS * cfg.global_batch * cfg.seq_len
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if any(r["verdict"] != "ok" for r in steps):
        raise AssertionError(f"verdicts: {[r['verdict'] for r in steps]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    for name in PATH_KERNELS["training"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"training run")
    training = {
        "model": "gpt2-small 12x768 vocab 50257 (random weights, bf16 "
                 "compute, fp32 params)",
        "micro_batch": cfg.micro_batch, "global_batch": cfg.global_batch,
        "seq_len": cfg.seq_len, "steps": TRAIN_STEPS,
        "tokens_per_s": tokens / (t_all / 1e3),
        "step_ms_mean": t_all / TRAIN_STEPS,
        "step_ms_min": min(r["step_ms"] for r in steps),
        "first_loss": losses[0], "last_loss": losses[-1],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "first_batch_crc32": crcs,
        "launches": launches,
        "launches_per_step": {k: n / TRAIN_STEPS for k, n in launches.items()},
        "gpu": smi,
    }
    log(f"training: {training['tokens_per_s']:.1f} tokens/s over "
        f"{TRAIN_STEPS} steps of {cfg.global_batch} x {cfg.seq_len} tokens")
    log("training " + json.dumps(training))
    del tr, state
    torch.cuda.empty_cache()
    return launches, training


SMALL_TARGET = dict(vocab=512, seq_len=64, layers=2, hidden=128, heads=2,
                    micro_batch=2, global_batch=4)


def training_card_vs_plain():
    """The repair check and the step's control flow, card against CPU."""
    from apex_tpu_torch.models import GPTModel, gpt_loss_fn
    from apex_tpu_torch.resilience import VERDICT_SKIP
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
    )
    from apex_tpu_torch.transformer import TransformerConfig

    # loss and every gradient of a small fp32 GPT: the kernels' backward
    # against the plain backward on the CPU; 1e-5 + 1e-3 relative (fp32
    # sums in another order through two layers)
    tcfg = TransformerConfig(num_layers=2, hidden_size=128,
                             num_attention_heads=2, vocab_size=512,
                             max_position_embeddings=64, hidden_dropout=0.0,
                             attention_dropout=0.0,
                             compute_dtype=torch.float32)
    gpu = GPTModel(tcfg, device="cuda", seed=SEED)
    cpu = GPTModel(tcfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rs = np.random.RandomState(SEED + 9)
    tokens = torch.as_tensor(rs.randint(0, 512, (2, 64)))
    labels = torch.as_tensor(rs.randint(0, 512, (2, 64)))
    lg = gpt_loss_fn(gpu(tokens.cuda(), labels=labels.cuda()))
    lg.backward()
    lc = gpt_loss_fn(cpu(tokens, labels=labels))
    lc.backward()
    named = dict(cpu.named_parameters())
    gerr = 0.0
    for name, p in gpu.named_parameters():
        ref = named[name].grad
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{name}: no finite gradient on the card")
        err = (p.grad.cpu() - ref).abs()
        if bool((err > 1e-5 + 1e-3 * ref.abs()).any()):
            raise AssertionError(f"{name}: card gradient differs by "
                                 f"{float(err.max())}")
        gerr = max(gerr, float(err.max()))
    lerr = abs(lg.item() - lc.item())
    log(f"small GPT fp32 card vs cpu: loss err {lerr:.3e}, max grad err "
        f"{gerr:.3e} over {len(named)} parameters (atol 1e-5, rtol 1e-3)")
    if lerr > 1e-4:
        raise AssertionError(f"loss differs by {lerr}")

    # 3 bf16 steps of the small target from the same init: the same
    # verdicts and loss scales, losses within 1e-2 relative (bf16
    # activations rounded at the same points, summed in another order)
    cfg = GPTTargetConfig(**SMALL_TARGET)
    tg, tc = (build_gpt_training(cfg, device=d) for d in ("cuda", "cpu"))
    sg, sc = tg.init_state(), tc.init_state()
    tc.model.load_state_dict({k: v.cpu()
                              for k, v in tg.model.state_dict().items()})
    lm = token_file_lm(cfg.vocab, cfg.seq_len, 20_000)
    for i in range(3):
        x, y = tg.reshape_batch(*lm.batch(range(4 * i, 4 * i + 4)))
        sg, loss_g, v_g, m_g = tg.train_step(sg, x, y)
        sc, loss_c, v_c, m_c = tc.train_step(sc, x, y)
        log(f"small target step {i}: card loss {loss_g:.5f} cpu loss "
            f"{loss_c:.5f}, verdicts {v_g}/{v_c}, loss scales "
            f"{m_g['loss_scale']}/{m_c['loss_scale']}")
        if (v_g, m_g["loss_scale"]) != (v_c, m_c["loss_scale"]):
            raise AssertionError("card and cpu steps disagree")
        if abs(loss_g - loss_c) > 1e-2 * abs(loss_c):
            raise AssertionError(f"losses differ: {loss_g} vs {loss_c}")

    # an inject_nan step: SKIP, params and Adam state bit-unchanged, the
    # loss scale halved
    params = {n: p.detach().clone() for n, p in sg.params.items()}
    moments = {n: (sg.opt.exp_avg[n].clone(), sg.opt.exp_avg_sq[n].clone())
               for n in sg.params}
    step, scale = int(sg.opt.step), float(sg.scaler.scale)
    x, y = tg.reshape_batch(*lm.batch(range(12, 16)))
    sg, loss, verdict, metrics = tg.train_step(sg, x, y, inject_nan=1.0)
    same = all(torch.equal(p, params[n]) and
               torch.equal(sg.opt.exp_avg[n], moments[n][0]) and
               torch.equal(sg.opt.exp_avg_sq[n], moments[n][1])
               for n, p in sg.params.items())
    if not (verdict == VERDICT_SKIP and same and int(sg.opt.step) == step
            and metrics["loss_scale"] == scale / 2):
        raise AssertionError(f"inject_nan step: verdict {verdict}, state "
                             f"unchanged {same}, scale "
                             f"{metrics['loss_scale']} (was {scale})")
    log(f"inject_nan step: verdict skip, params and Adam state bit-unchanged,"
        f" loss scale {scale} -> {metrics['loss_scale']}")


# -- Llama -------------------------------------------------------------------

LLAMA_ENGINE = dict(lanes=8, block_size=16, max_seq_len=2048,
                    num_blocks=8 * 128, max_queue_depth=32)
LLAMA_DECODE_ATOL = 2e-3  # fp32 decode step vs full forward, |logits| ~ 1


def llama_requests(n, vocab, rs):
    """``n`` (prompt, max_new_tokens): prompts of 32-1536 random tokens,
    32-64 new tokens each."""
    return [(rs.randint(0, vocab, size=int(rs.randint(32, 1537))),
             int(rs.randint(32, 65))) for _ in range(n)]


class DecodeRecorder:
    """Stands in for the model behind an engine and keeps, for each
    decode step, every lane's prefix (prompt and tokens so far) and the
    logits the step gave it."""

    def __init__(self, model):
        self.model, self.engine, self.steps = model, None, []
        self._decoding = False

    def __getattr__(self, name):
        return getattr(self.model, name)

    def hidden_states(self, tokens, cache=None, decode_step=False):
        self._decoding = decode_step
        return self.model.hidden_states(tokens, cache=cache,
                                        decode_step=decode_step)

    def logits(self, h):
        out = self.model.logits(h)
        if self._decoding:  # the engine's lanes, in the batch's order
            active = self.engine._active
            self.steps.append([
                (np.concatenate([active[lane].prompt,
                                 active[lane].tokens_out]), out[i, 0].cpu())
                for i, lane in enumerate(sorted(active))])
        return out


def llama_serving_phase(smi):
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, tinyllama_1_1b_config
    from apex_tpu_torch.serving import ServingConfig, ServingEngine
    from apex_tpu_torch.serving.profile import serve

    mcfg = tinyllama_1_1b_config()
    model = GPTModel(mcfg, device="cuda", seed=SEED)
    cfg = ServingConfig(**LLAMA_ENGINE, seed=SEED)
    requests = llama_requests(24, mcfg.vocab_size, np.random.RandomState(SEED))
    warm = np.random.RandomState(SEED + 1)
    serve(model, [(warm.randint(0, mcfg.vocab_size, 64), 4)], cfg)

    _kernels.reset_launch_counts()
    eng, reqs, wall = serve(model, requests, cfg)
    launches = _kernels.launch_counts()
    stats = eng.stats()
    done = stats["terminal"].get("completed", 0)
    if done != len(reqs):
        raise AssertionError(f"only {done} of {len(reqs)} Llama requests "
                             f"completed: {stats['terminal']} "
                             f"{stats['reasons']}")
    for r in reqs:
        if len(r.tokens_out) != r.max_new_tokens or not all(
                0 <= t < mcfg.vocab_size for t in r.tokens_out):
            raise AssertionError(f"Llama request {r.rid}: bad tokens")
    for name in PATH_KERNELS["llama_serving"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"Llama serving run")
    serving = {
        "model": "TinyLlama-1.1B 22x2048 GQA 32/4 vocab 32000 (random "
                 "weights, bf16 compute, fp32 params)",
        "requests": len(reqs), "completed": done,
        "prompt_tokens": int(sum(r.prompt_len for r in reqs)),
        "tokens_out": stats["tokens_out"],
        "wall_s": wall, "tokens_per_s": stats["tokens_out"] / wall,
        "ttft_p50_ms": stats["ttft_p50_s"] * 1e3,
        "ttft_p99_ms": stats["ttft_p99_s"] * 1e3,
        "per_token_p50_ms": stats["per_token_p50_s"] * 1e3,
        "ticks": stats["ticks"], "kv_pool_peak_blocks":
            stats["kv_pool_peak_blocks"], "launches": launches, "gpu": smi,
    }
    log("llama serving " + json.dumps(serving))
    del model, eng
    torch.cuda.empty_cache()

    # fp32, the same weights (same seed, same fp32 params): each decode step
    # of two lanes at different positions against a full forward of the
    # lane's prefix; a rope table gathered at the wrong positions fails here
    f32 = tinyllama_1_1b_config(compute_dtype=torch.float32)
    gpu32 = GPTModel(f32, device="cuda", seed=SEED)
    rec = DecodeRecorder(gpu32)
    eng32 = ServingEngine(rec, cfg, device="cuda")
    rec.engine = eng32
    rs = np.random.RandomState(SEED + 2)
    for length in (300, 1100):
        eng32.submit(rs.randint(0, mcfg.vocab_size, length), 6)
    while not eng32.idle:
        eng32.tick()
    two_lanes = [step for step in rec.steps if len(step) == 2]
    if not two_lanes or any(len(a) == len(b) for (a, _), (b, _) in two_lanes):
        raise AssertionError("no decode step with two lanes at different "
                             "positions")
    derr = 0.0
    with torch.no_grad():
        for step in rec.steps:
            for prefix, got in step:
                want = gpu32(torch.as_tensor(prefix[None], device="cuda"))
                derr = max(derr, float((got - want[0, -1].cpu()).abs().max()))
    log(f"llama fp32 decode vs full forward: {len(rec.steps)} steps, "
        f"{len(two_lanes)} with two lanes at positions "
        f"{[len(p) - 1 for p, _ in two_lanes[0]]}: max_abs_err {derr:.3e} "
        f"(atol {LLAMA_DECODE_ATOL})")
    if derr > LLAMA_DECODE_ATOL:
        raise AssertionError(f"decode logits differ from the full forward "
                             f"by {derr}")

    # fp32 logits of a 32-token input: the kernels on the card against the
    # plain path on the CPU, at full width and depth
    t0 = time.perf_counter()
    cpu32 = GPTModel(f32, device="cpu", seed=SEED)
    cpu32.load_state_dict({k: v.cpu() for k, v in gpu32.state_dict().items()})
    tokens = torch.as_tensor(rs.randint(0, mcfg.vocab_size, (1, 32)))
    with torch.no_grad():
        lg = gpu32(tokens.cuda()).cpu()
        lc = cpu32(tokens)
    if lg.shape != (1, 32, mcfg.vocab_size) or not torch.isfinite(lg).all():
        raise AssertionError("Llama logits: wrong shape or non-finite")
    lerr = float((lg - lc).abs().max())
    log(f"llama logits card vs cpu plain (fp32, 1x32 tokens): max_abs_err="
        f"{lerr:.3e} (atol 2e-3), {time.perf_counter() - t0:.1f} s")
    if lerr > 2e-3:
        raise AssertionError(f"Llama logits disagree with the plain path: "
                             f"{lerr}")
    del gpu32, cpu32, eng32, rec
    gc.collect()  # the recorder and its engine refer to each other
    torch.cuda.empty_cache()
    return launches, serving


LLAMA_STEPS = 5
# the HBM x-ray's band at TinyLlama's fine-tuning step: the allocator's
# peak over the first step against the composed ledger's prediction,
# which counts the weights, one gradient each, the ZeRO state and the
# batch, and no activations (the JAX example's composition): the peak
# adds the bf16 activations the backward keeps (1.80x on an H100 80GB
# HBM3 at 700 W)
LLAMA_HBM_BAND = (1.0, 2.5)


def llama_finetune_phase(smi):
    """The fine-tuning example (``finetune_llama.main``) on TinyLlama-1.1B
    at full width and depth (``--model tinyllama-1.1b --bf16``), 1 +
    LLAMA_STEPS steps of 4 x 2048 tokens, with ``--metrics-jsonl`` and
    ``--xray-hbm``: the goodput identity,
    the HBM prediction against the allocator's peak (LLAMA_HBM_BAND), no
    recompile after the first step, the path's kernels; then one more
    step of the trained state with every gradient checked finite."""
    import os
    import tempfile

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.llama import finetune_llama

    batch, seq_len = 4, 2048
    tmp = tempfile.mkdtemp(prefix="llama_finetune-")
    jsonl = os.path.join(tmp, "llama.jsonl")
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps = 1 + LLAMA_STEPS
    t0 = time.perf_counter()
    recs = finetune_llama.main(
        ["--model", "tinyllama-1.1b", "--bf16", "--steps", str(steps),
         "--batch", str(batch), "--seq-len", str(seq_len), "--lr", "1e-3",
         "--clip", "1.0", "--seed", str(SEED), "--metrics-jsonl", jsonl,
         "--xray-hbm"])
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    model = recs.finetune.model
    n_params = sum(p.numel() for p in model.parameters())
    n_tensors = len(list(model.parameters()))
    if (n_tensors, n_params) != (157, N_TINYLLAMA):
        raise AssertionError(f"{n_tensors} parameters of {n_params} elements")
    records = _jsonl(jsonl)
    losses = [r["loss"] for r in recs]
    timed = [r["step_ms"] for r in recs[1:]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite Llama loss: {losses}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"the Llama loss did not fall: {losses}")
    if launches["sumsq_flat"] != steps:
        raise AssertionError(f"the clip ran sumsq_flat "
                             f"{launches['sumsq_flat']} times in {steps} "
                             f"steps")
    for name in PATH_KERNELS["llama_finetune"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"Llama fine-tuning run")
    (g,) = [r for r in records if r["kind"] == "goodput"]
    if not _goodput_identity(records):
        raise AssertionError(f"the goodput identity does not hold: {g}")
    compiles = [r for r in records if r["kind"] == "compile"]
    if [r for r in compiles if r["recompile"]]:
        raise AssertionError(f"a recompile after step 1: {compiles}")
    (alloc,) = [r for r in records if r["kind"] == "memory"
                and r.get("scope") == "allocator"]
    ratio = alloc["total_bytes"] / alloc["predicted_peak_bytes"]
    if not LLAMA_HBM_BAND[0] <= ratio <= LLAMA_HBM_BAND[1]:
        raise AssertionError(
            f"the allocator's peak {alloc['total_bytes']} B is {ratio:.3f}x "
            f"the predicted {alloc['predicted_peak_bytes']} B, outside "
            f"{LLAMA_HBM_BAND}")
    device_mem = [r for r in records if r["kind"] == "memory"
                  and r.get("scope") == "device"]
    # one more step of the trained state: every parameter gets a finite
    # gradient (not counted in the path's launches)
    loss_x, bad = recs.finetune.step(check_grads=True)
    if bad or not math.isfinite(loss_x):
        raise AssertionError(f"a further step: loss {loss_x}, no finite "
                             f"gradient for {bad}")
    log(f"llama fine-tuning: all 157 parameters got a finite gradient "
        f"(loss {loss_x:.4f})")
    tokens = LLAMA_STEPS * batch * seq_len
    finetune = {
        "model": "TinyLlama-1.1B 22x2048 GQA 32/4 vocab 32000 (random "
                 "weights, bf16 compute, fp32 params), ZeRO-2 Adam at dp=1, "
                 "through the example's main",
        "batch": batch, "seq_len": seq_len, "steps": LLAMA_STEPS,
        "lr": 1e-3, "clip": 1.0,
        "tokens_per_s": tokens / (sum(timed) / 1e3),
        "step_ms_mean": sum(timed) / LLAMA_STEPS,
        "step_ms_min": min(timed),
        "warmup_loss": losses[0], "first_loss": losses[1],
        "last_loss": losses[-1], "losses": losses[1:],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "wall_s": wall,
        "hbm": {"predicted_peak_bytes": alloc["predicted_peak_bytes"],
                "allocator_peak_bytes": alloc["total_bytes"],
                "allocator_argument_bytes": alloc["argument_bytes"],
                "ratio": ratio, "band": LLAMA_HBM_BAND,
                "watermark_peak_bytes": (device_mem[-1]["peak_bytes_in_use"]
                                         if device_mem else None)},
        "goodput": {k: g[k] for k in g if k.endswith("_s")},
        "compile_records": [{k: r[k] for k in ("step", "compiles",
                                                "compile_seconds",
                                                "recompile")}
                            for r in compiles],
        "launches": launches,
        "launches_per_step": {k: n / steps for k, n in launches.items()},
        "gpu": smi,
    }
    log(f"llama fine-tuning: {finetune['tokens_per_s']:.1f} tokens/s over "
        f"{LLAMA_STEPS} steps of {batch} x {seq_len} tokens, peak "
        f"{finetune['peak_mem_gb']:.2f} GB, hbm allocator/predicted "
        f"{ratio:.3f}")
    log("llama finetune " + json.dumps(finetune))
    del recs, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, finetune


# the Llama recovery phase: TinyLlama-1.1B's width (hidden 2048, 32 heads
# over 4 KV heads, SwiGLU 5632, vocab 32,000) at depth 2, cut from 22 so
# that its four runs, two saves and a restore (about 3.5 GB a checkpoint:
# 219M fp32 parameters and their ZeRO master and moments) fit the
# script's time; batch 4 x 2048 in bf16, 2 steps saved and 2 resumed
LLAMA_RUNTIME_LAYERS = 2
LLAMA_RUNTIME_STEPS = (2, 2)
LLAMA_RUNTIME_ARGV = ["--batch", "4", "--seq-len", "2048", "--lr", "1e-3",
                      "--clip", "1.0", "--seed", str(SEED)]
# the wedge: a run deadline far under the run (its steps take about 100 ms
# each at this depth), in a process of its own (exit 43 ends it)
LLAMA_WEDGE_STEPS, LLAMA_WEDGE_DEADLINE = 200, 0.2
_LLAMA_WEDGE = """
import sys, torch
from apex_tpu_torch.examples.llama import finetune_llama
from apex_tpu_torch.models import GPTModel, tinyllama_1_1b_config
model = GPTModel(tinyllama_1_1b_config(num_layers={layers}),
                 device="cuda", seed={seed})
finetune_llama.main(sys.argv[1:], model=model)
"""


def llama_runtime_phase(smi):
    """The Llama example's recovery path at TinyLlama's width, depth
    LLAMA_RUNTIME_LAYERS, in process through ``main(argv, model=)``: (a)
    k + n uninterrupted steps, journaled; (b) k steps saved; (c) the rerun
    resumed from (b) for n more and saved: every leaf of its state
    bit-equal by crc32 to (a)'s, the losses bit for bit, the resumed
    journal diffing clean against (a)'s (``replay --diff``); (d) a run
    under a ``--run-deadline`` far under it ends in exit 43."""
    import os
    import shutil
    import tempfile

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.llama import finetune_llama
    from apex_tpu_torch.models import GPTModel, tinyllama_1_1b_config
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.replay.__main__ import main as replay

    k, n = LLAMA_RUNTIME_STEPS
    tmp = tempfile.mkdtemp(prefix="llama_runtime-")
    free = shutil.disk_usage(tmp).free
    log(f"llama_runtime: {tmp} has {free / 1e9:.1f} GB free")
    A, B = os.path.join(tmp, "A"), os.path.join(tmp, "B")
    out = {"gpu": smi, "layers": LLAMA_RUNTIME_LAYERS, "k": k, "n": n}
    t_start = time.perf_counter()

    def model():
        return GPTModel(tinyllama_1_1b_config(
            num_layers=LLAMA_RUNTIME_LAYERS), device="cuda", seed=SEED)

    def run(argv, name):
        t0 = time.perf_counter()
        jsonl = os.path.join(tmp, f"{name}.jsonl")
        recs = finetune_llama.main([*LLAMA_RUNTIME_ARGV, *argv,
                                    "--metrics-jsonl", jsonl],
                                   model=model())
        secs = time.perf_counter() - t0
        fp = integrity.tree_fingerprint(recs.finetune.checkpoint_state())
        losses = {r["step"]: r["loss"] for r in recs}
        records = _jsonl(jsonl)
        del recs
        gc.collect()
        torch.cuda.empty_cache()
        return losses, fp, records, secs

    _kernels.reset_launch_counts()
    try:
        # (a) uninterrupted, journaled into its metrics stream (no save)
        a, fp_a, _, out["run_a_s"] = run(
            ["--steps", str(k + n), "--journal"], "a")
        # (b) k steps saved; (c) resumed for n more, saved
        b, _, b_recs, out["run_b_s"] = run(
            ["--steps", str(k), "--save", B], "b")
        c, fp_c, c_recs, out["run_c_s"] = run(
            ["--steps", str(n), "--save", B], "c")
        launches = _kernels.launch_counts()
        if sorted(b) != list(range(k)) or sorted(c) != list(
                range(k, k + n)):
            raise AssertionError(f"steps: saved {sorted(b)}, resumed "
                                 f"{sorted(c)}")
        if any(a[i] != x for i, x in {**b, **c}.items()):
            raise AssertionError(f"losses: uninterrupted {a}, saved {b}, "
                                 f"resumed {c}")
        differ = [la["path"] for la, lc in zip(fp_a["leaves"],
                                               fp_c["leaves"])
                  if la["crc32"] != lc["crc32"]]
        if fp_a["structure_hash"] != fp_c["structure_hash"] or differ:
            raise AssertionError(f"resumed state differs from the "
                                 f"uninterrupted run's at {differ[:5]}")
        out["leaves"] = len(fp_c["leaves"])
        step_dir = os.path.join(B, f"step_{k}")
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(step_dir, f))
            for f in os.listdir(step_dir))
        out["save_ms"] = [r["dur_s"] * 1e3 for r in b_recs + c_recs
                          if r["kind"] == "span"
                          and r["phase"] == "ckpt_save"]
        out["restore_ms"] = [r["dur_s"] * 1e3 for r in c_recs
                             if r["kind"] == "span"
                             and r["phase"] == "ckpt_restore"]
        # the resumed run's journal (both incarnations) against (a)'s
        rc = replay(["--diff", os.path.join(tmp, "a.jsonl"),
                     os.path.join(B, "replay-journal.jsonl")])
        if rc != 0:
            raise AssertionError(f"replay --diff of the resumed journal "
                                 f"exited {rc}")
        # (d) the wedge
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _LLAMA_WEDGE.format(
                layers=LLAMA_RUNTIME_LAYERS, seed=SEED),
             *LLAMA_RUNTIME_ARGV, "--steps", str(LLAMA_WEDGE_STEPS),
             "--run-deadline", str(LLAMA_WEDGE_DEADLINE),
             "--metrics-jsonl", os.path.join(tmp, "d.jsonl")],
            capture_output=True, text=True, timeout=300)
        out["wedge_s"] = time.perf_counter() - t0
        incidents = [r.get("stage") for r in
                     _jsonl(os.path.join(tmp, "d.jsonl"))
                     if r["kind"] == "incident"]
        if proc.returncode != 43 or "terminate" not in incidents:
            raise AssertionError(f"the wedge exited {proc.returncode} "
                                 f"(incident stages {incidents}):\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        out["wedge_incident_stages"] = incidents
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["losses"] = [a[i] for i in sorted(a)]
    out["phase_s"] = time.perf_counter() - t_start
    log("llama_runtime " + json.dumps(out))
    return launches, out


# -- ResNet-50 ----------------------------------------------------------------

# bench.py's headline step at its size (ResNet-50, 224^2, batch 256)
RESNET = dict(model_name="resnet50", image_size=224, batch=256, warmup=3,
              steps=10)


def resnet_phase(smi):
    """The twin of bench.py (``apex_tpu_torch.bench``) at full width: O2,
    then O0 with TF32 off, each 3 warm-up steps on one fixed batch and a
    step timed by the slope between chains of 1 and 11 steps (best of 2
    each); finite losses that fall over each mode's steps. Then the small
    fp32 ResNet's step, card against CPU."""
    from apex_tpu_torch import _kernels, bench

    _kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rec = bench.run(device="cuda", seed=SEED, **RESNET)
    bench_s = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    for mode in ("O2", "O0"):
        losses = rec[mode]["losses"]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"ResNet-50 {mode}: the loss did not fall: "
                                 f"{losses}")
        log(f"resnet50 {mode}: {rec[mode]['imgs_per_s']:.1f} images/s, "
            f"{rec[mode]['step_ms']:.2f} ms a step, peak "
            f"{rec[mode]['peak_mem_gb']:.2f} GB, losses {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}")
    log(f"resnet50 O2/O0: {rec['o2_over_o0']:.3f} ({smi})")
    log("resnet " + json.dumps(rec))
    t0 = time.perf_counter()
    resnet_card_vs_plain()
    log(f"resnet phase: the bench {bench_s:.1f} s, card against CPU "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    return launches, rec


def resnet_card_vs_plain():
    """A small fp32 ResNet (a BasicBlock stage and a strided one, 8
    filters, 32^2 images, batch 4): loss, every gradient and the updated
    batch_stats of a training forward on the card against the CPU, at
    atol 1e-4 and rtol 1e-3 (cuDNN's and oneDNN's fp32 convolutions, TF32
    off, sum in another order through the BatchNorms' batch statistics)."""
    from apex_tpu_torch.models import resnet

    def model(device):
        return resnet.ResNet([1, 2], resnet.BasicBlock, num_classes=10,
                             num_filters=8, device=device, seed=SEED)

    gpu, cpu = model("cuda"), model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    with torch.no_grad():  # a zero-init scale would zero its branch's grads
        for m in (gpu, cpu):
            for name, p in m.named_parameters():
                if name.endswith("scale"):
                    p.fill_(0.7)
    rs = np.random.RandomState(SEED + 16)
    x = torch.as_tensor(rs.randn(4, 32, 32, 3).astype(np.float32))
    labels = torch.as_tensor(rs.randint(0, 10, (4,)))
    lg = resnet.cross_entropy_loss(gpu(x.cuda(), train=True), labels.cuda())
    lg.backward()
    lc = resnet.cross_entropy_loss(cpu(x, train=True), labels)
    lc.backward()
    worst = abs(lg.item() - lc.item())
    if worst > 1e-4 + 1e-3 * abs(lc.item()):
        raise AssertionError(f"ResNet loss differs by {worst}")
    named = dict(cpu.named_parameters())
    buffers = dict(cpu.named_buffers())
    pairs = [(n, p.grad, named[n].grad) for n, p in gpu.named_parameters()]
    pairs += [(n, b, buffers[n]) for n, b in gpu.named_buffers()]
    for name, got, ref in pairs:
        if got is None or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: nothing finite on the card")
        err = (got.cpu() - ref).abs()
        if bool((err > 1e-4 + 1e-3 * ref.abs()).any()):
            raise AssertionError(f"ResNet {name}: card differs by "
                                 f"{float(err.max())}")
        worst = max(worst, float(err.max()))
    log(f"small ResNet fp32 card vs cpu: loss, {len(named)} gradients and "
        f"{len(buffers)} batch statistics, max abs err {worst:.3e} (atol "
        f"1e-4, rtol 1e-3)")


# -- BERT --------------------------------------------------------------------

def log_profile(label, fn):
    """Logs one call of ``fn`` under ``torch.profiler``: wall and device
    ms, the device's idle share, the 12 kernels with the most device time
    and the 12 host operations with the most self CPU time (after the
    path's launch counts were read)."""
    from apex_tpu_torch.utils.profiling import profile_device

    torch.cuda.synchronize()
    rep = profile_device(lambda: (fn(), torch.cuda.synchronize()), top=12)
    log(f"profile {label}: wall {rep['wall_ms']:.2f} ms, device "
        f"{rep['device_ms']:.2f} ms, idle {100 * rep['device_idle_share']:.1f}"
        f"% " + json.dumps(rep["top"]))
    log(f"profile {label} host: " + json.dumps(rep["host_top"]))


BERT_SERVING = dict(batch=32, seq_len=512, min_len=64, passes=5)


def bert_serving_draw():
    """The serving batch's RandomState and its first draw, the 32 lengths
    (the kernel-parity cases take the same lengths)."""
    c = BERT_SERVING
    rs = np.random.RandomState(SEED)
    return rs, rs.randint(c["min_len"], c["seq_len"] + 1, c["batch"])


def bert_batch(n, seq_len, lengths, vocab, rs):
    """Tokens, attention_mask (1 = keep) and tokentype_ids (segment 1 from
    half of each length) of ``n`` sequences of these lengths padded to
    ``seq_len``, on the card."""
    tokens = rs.randint(0, vocab, (n, seq_len))
    pos = np.arange(seq_len)[None, :]
    lens = np.asarray(lengths)[:, None]
    mask = (pos < lens).astype(np.int64)
    types = ((pos >= lens // 2) & (pos < lens)).astype(np.int64)
    tokens = tokens * mask
    return tuple(torch.as_tensor(x).cuda() for x in (tokens, mask, types))


def bert_serving_phase(smi):
    """BERT-345M's eval-mode forward over a padded batch: one warm-up pass,
    then timed passes; the padding check and card against CPU."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import BertModel, megatron_bert_345m_config

    c = BERT_SERVING
    cfg = megatron_bert_345m_config()
    model = BertModel(cfg, device="cuda", seed=SEED).eval()
    rs, lengths = bert_serving_draw()
    tokens, mask, types = bert_batch(c["batch"], c["seq_len"], lengths,
                                     cfg.vocab_size, rs)
    with torch.no_grad():
        model(tokens, mask, types)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(c["passes"]):
            logits, nsp = model(tokens, mask, types)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    if logits.shape != (c["batch"], c["seq_len"], cfg.vocab_size) or \
            nsp.shape != (c["batch"], 2):
        raise AssertionError("BERT logits: wrong shape")
    if not (torch.isfinite(logits).all() and torch.isfinite(nsp).all()):
        raise AssertionError("BERT logits: non-finite")
    for name in PATH_KERNELS["bert_serving"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"BERT serving run")
    real = int(lengths.sum())
    serving = {
        "model": "Megatron BERT-345M 24x1024 vocab 30592 (random weights, "
                 "bf16 compute, fp32 params), eval-mode forward",
        "batch": c["batch"], "seq_len": c["seq_len"], "passes": c["passes"],
        "real_tokens": real, "wall_s": wall,
        "sequences_per_s": c["passes"] * c["batch"] / wall,
        "real_tokens_per_s": c["passes"] * real / wall,
        "pass_ms": wall / c["passes"] * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_pass": {k: n / c["passes"]
                              for k, n in launches.items()},
        "gpu": smi,
    }
    log(f"bert serving: {serving['sequences_per_s']:.1f} sequences/s, "
        f"{serving['real_tokens_per_s']:.1f} real tokens/s "
        f"({serving['pass_ms']:.2f} ms a pass of {c['batch']} x "
        f"{c['seq_len']})")
    log("bert serving " + json.dumps(serving))
    with torch.no_grad():
        log_profile("bert serving pass", lambda: model(tokens, mask, types))

    # the padded tokens do not reach the kept positions: bit-equal
    other = torch.where(mask.bool(), tokens, (tokens + 7) % cfg.vocab_size)
    with torch.no_grad():
        logits2, nsp2 = model(other, mask, types)
    keep = mask.bool()
    if not (torch.equal(logits[keep], logits2[keep])
            and torch.equal(nsp, nsp2)):
        raise AssertionError("BERT: changing the padded tokens changed the "
                             "kept positions' logits")
    log("bert serving: changing the padded tokens leaves the kept positions'"
        " logits bit-equal")
    del logits, logits2, model
    torch.cuda.empty_cache()
    bert_card_vs_plain()
    return launches, serving


def bert_card_vs_plain():
    """A short padded fp32 batch through BERT-345M at full width: logits
    and NSP logits on the card against the plain path on the CPU, atol
    2e-3 (24 layers of fp32 arithmetic summed in another order)."""
    from apex_tpu_torch.models import BertModel, megatron_bert_345m_config

    f32 = megatron_bert_345m_config(compute_dtype=torch.float32)
    gpu = BertModel(f32, device="cuda", seed=SEED).eval()
    cpu = BertModel(f32, device="cpu", seed=SEED + 1).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rs = np.random.RandomState(SEED + 20)
    tokens, mask, types = bert_batch(2, 64, [64, 40], f32.vocab_size, rs)
    with torch.no_grad():
        lg, ng = (t.cpu() for t in gpu(tokens, mask, types))
        lc, nc = cpu(tokens.cpu(), mask.cpu(), types.cpu())
    err = max(float((lg - lc).abs().max()), float((ng - nc).abs().max()))
    log(f"bert logits card vs cpu plain (fp32, 2x64 tokens, lengths 64/40): "
        f"max_abs_err={err:.3e} (atol 2e-3)")
    if not torch.isfinite(lg).all() or err > 2e-3:
        raise AssertionError(f"BERT logits disagree with the plain path: "
                             f"{err}")
    del gpu, cpu
    torch.cuda.empty_cache()


BERT_PRETRAIN_ARGV = (
    "--num-layers 24 --hidden-size 1024 --num-attention-heads 16 "
    "--seq-length 512 --max-position-embeddings 512 --micro-batch-size 4 "
    "--global-batch-size 8 --lr 1e-4 --bf16 --train-iters 7").split()
BERT_VOCAB = 30592  # bert-large-uncased's 30522, padded to a multiple of 128


def bert_pretrain_phase(smi):
    """The standalone BERT (``standalone_bert``, the body of ``run_bert``)
    at Megatron BERT-345M: one warm-up step, 5 measured steps, then one
    step under ``torch.profiler``."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.transformer.testing import parse_args
    from apex_tpu_torch.transformer.testing.standalone_bert import (
        BertPretraining,
    )

    args = parse_args(args=BERT_PRETRAIN_ARGV)
    args.padded_vocab_size = BERT_VOCAB
    run = BertPretraining(args, device="cuda")
    n_params = sum(p.numel() for p in run.model.parameters())
    n_tensors = len(list(run.model.parameters()))
    if (n_tensors, n_params) != (301, 336_267_266):
        raise AssertionError(f"{n_tensors} parameters of {n_params} elements")
    loss0, grads = run.step(0)  # warm-up
    loss0 = float(loss0)
    bad = [n for n, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad or not math.isfinite(loss0):
        raise AssertionError(f"warm-up step: loss {loss0}, no finite "
                             f"gradient for {bad}")
    if abs(loss0 - math.log(BERT_VOCAB)) > 1.0:
        raise AssertionError(f"the first loss {loss0} is not within 1.0 of "
                             f"ln {BERT_VOCAB}")
    log(f"bert pretrain warm-up: loss {loss0:.4f} (ln {BERT_VOCAB} = "
        f"{math.log(BERT_VOCAB):.4f}); all 301 parameters got a finite "
        f"gradient")
    del grads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    steps, t_all = [], 0.0
    for i in range(1, run.steps - 1):  # the last batch is profiled
        t0 = time.perf_counter()
        loss, _ = run.step(i)
        loss = float(loss)
        ms = (time.perf_counter() - t0) * 1e3
        t_all += ms
        steps.append(dict(step=i, loss=loss, step_ms=ms))
        log(f"bert step {i} loss {loss:.4f} step_ms {ms:.2f}")
    launches = _kernels.launch_counts()
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite BERT loss: {losses}")
    for name in PATH_KERNELS["bert_pretrain"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"BERT pre-training run")
    n = len(steps)
    tokens = n * args.global_batch_size * args.seq_length
    pretrain = {
        "model": "Megatron BERT-345M 24x1024 vocab 30592 (random weights, "
                 "bf16 compute, fp32 params), standalone_bert",
        "micro_batch": args.micro_batch_size,
        "global_batch": args.global_batch_size, "seq_len": args.seq_length,
        "lr": args.lr, "steps": n,
        "tokens_per_s": tokens / (t_all / 1e3),
        "step_ms_mean": t_all / n,
        "step_ms_min": min(r["step_ms"] for r in steps),
        "warmup_loss": loss0, "losses": losses,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_step": {k: c / n for k, c in launches.items()},
        "gpu": smi,
    }
    log(f"bert pretrain: {pretrain['tokens_per_s']:.1f} tokens/s over {n} "
        f"steps of {args.global_batch_size} x {args.seq_length} tokens, "
        f"{pretrain['step_ms_mean']:.2f} ms a step, peak "
        f"{pretrain['peak_mem_gb']:.2f} GB")
    log("bert pretrain " + json.dumps(pretrain))
    log_profile("bert pretrain step", lambda: run.step(run.steps - 1))
    del run
    torch.cuda.empty_cache()
    return launches, pretrain


BERT_DROPOUT = dict(batch=4, seq_len=512, steps=8, lr=1e-4)
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def bert_dropout_phase(smi):
    """BERT-345M in training mode with Megatron's 0.1 hidden and attention
    dropout (the CoreAttention path) on one fixed padded batch, through
    ``fused_adam``; then the dropout's statistics on the card."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import BertModel, megatron_bert_345m_config
    from apex_tpu_torch.optimizers import fused_adam

    c = BERT_DROPOUT
    cfg = megatron_bert_345m_config()
    model = BertModel(cfg, device="cuda", seed=SEED)
    rs = np.random.RandomState(SEED + 30)
    lengths = rs.randint(64, c["seq_len"] + 1, c["batch"])
    tokens, mask, types = bert_batch(c["batch"], c["seq_len"], lengths,
                                     cfg.vocab_size, rs)
    labels = torch.as_tensor(rs.randint(0, cfg.vocab_size, tokens.shape),
                             device="cuda")
    keep = mask.float()
    params = dict(model.named_parameters())
    opt = fused_adam(lr=c["lr"], weight_decay=0.01)
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _kernels.reset_launch_counts()
    losses, t_all = [], 0.0
    for i in range(c["steps"]):
        t0 = time.perf_counter()
        lm, nsp = model(tokens, mask, types, lm_labels=labels)
        loss = (lm * keep).sum() / keep.sum()
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()), allow_unused=True)))
        grads = {n: torch.zeros_like(p) if grads[n] is None else grads[n]
                 for n, p in params.items()}
        updates, state = opt.update(grads, state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(updates[n])
        losses.append(float(loss))
        ms = (time.perf_counter() - t0) * 1e3
        t_all += ms
        log(f"bert dropout step {i} loss {losses[-1]:.4f} step_ms {ms:.2f}")
    launches = _kernels.launch_counts()
    if not torch.isfinite(nsp).all():
        raise AssertionError("BERT dropout: non-finite NSP logits")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite BERT dropout loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the BERT dropout loss did not fall: {losses}")
    for name in PATH_KERNELS["bert_dropout"]:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"BERT dropout run")
    ran = {name: launches[name] for name in FLASH_KERNELS if launches[name]}
    if ran:
        raise AssertionError(f"the flash kernels ran on the CoreAttention "
                             f"path: {ran}")
    tokens_n = c["steps"] * c["batch"] * c["seq_len"]
    dropout = {
        "model": "Megatron BERT-345M 24x1024 vocab 30592, hidden and "
                 "attention dropout 0.1 (CoreAttention), bf16 compute",
        "batch": c["batch"], "seq_len": c["seq_len"], "steps": c["steps"],
        "lr": c["lr"], "losses": losses,
        "tokens_per_s": tokens_n / (t_all / 1e3),
        "step_ms_mean": t_all / c["steps"],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "gpu": smi,
    }
    log(f"bert dropout: losses {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{c['steps']} steps, {dropout['step_ms_mean']:.2f} ms a step, peak "
        f"{dropout['peak_mem_gb']:.2f} GB; flash launches 0")
    log("bert dropout " + json.dumps(dropout))
    del model, params, state, grads, updates
    torch.cuda.empty_cache()
    dropout_statistics()
    return launches, dropout


def dropout_statistics():
    """A small BERT's dropout modules on the card: the kept share of 2^24
    elements within 4 sigma of 0.9, every kept element x / bf16(0.9) (its
    mean 1/0.9 to bf16's rounding of the divisor), and the model's train
    forward bit-equal for two models of one seed."""
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.transformer import TransformerConfig

    cfg = TransformerConfig(num_layers=2, hidden_size=64,
                            num_attention_heads=4, vocab_size=128,
                            max_position_embeddings=64)
    model = BertModel(cfg, device="cuda", seed=SEED + 40)
    n, rate = 1 << 24, cfg.hidden_dropout
    out = model.embedding.dropout(torch.ones(n, dtype=torch.bfloat16,
                                             device="cuda"))
    kept = out != 0
    share = float(kept.float().mean())
    sigma = math.sqrt(rate * (1 - rate) / n)
    scale = float(out[kept].double().mean())
    want = float(torch.ones((), dtype=torch.bfloat16)
                 / torch.tensor(1 - rate, dtype=torch.bfloat16))
    log(f"dropout on the card: kept share {share:.6f} (0.9 +- 4 sigma = "
        f"{4 * sigma:.2e}), kept scale mean {scale:.6f} (1/0.9 = "
        f"{1 / 0.9:.6f}; x / bf16(0.9) = {want:.6f})")
    if abs(share - (1 - rate)) > 4 * sigma:
        raise AssertionError(f"kept share {share} outside 4 sigma of 0.9")
    if not bool((out[kept] == want).all()) or \
            abs(scale - 1 / (1 - rate)) > 2 ** -7:
        raise AssertionError(f"kept scale {scale} is not 1/0.9")
    rs = np.random.RandomState(SEED + 41)
    tokens, mask, types = bert_batch(2, 64, [64, 30], 128, rs)
    one, twin = (BertModel(cfg, device="cuda", seed=SEED + 42)
                 for _ in range(2))
    a, b = one(tokens, mask, types), twin(tokens, mask, types)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("two models of one seed drew different masks")
    log("dropout on the card: two models of one seed give bit-equal train "
        "forwards")


# -- GPT-2 small at tp = 2 x dp = 2 ------------------------------------------

# 50257 does not divide by tp = 2 (the JAX VocabParallelEmbedding refuses
# it too): the table is padded to a multiple of 128, as Megatron-LM's
# --make-vocab-size-divisible-by 128 pads GPT-2's vocabulary
GPT_PARALLEL_VOCAB = 50304
# the ZeRO and DDP runs at depth 4 (cut from 12, as the 1F1B run's, to
# keep the whole script under its time limit on a slow host)
GPT_PARALLEL_LAYERS = 4
GPT_PARALLEL_ARGV = (
    "--vocab", str(GPT_PARALLEL_VOCAB), "--seq-len", "1024", "--layers",
    str(GPT_PARALLEL_LAYERS), "--hidden", "768", "--heads", "12",
    "--micro-batch", "4", "--global-batch", "16", "--tp", "2", "--seed",
    str(SEED),
    "--dist-backend", "gloo")
GPT_PARALLEL_RANKS = 4
# the CPU threads of each spawned rank: the host's cores shared by the 4
# ranks (8 cores on the card's machine, 2 a rank), for the plain CPU
# versions the card is held against
RANK_THREADS = max(1, len(os.sched_getaffinity(0)) // GPT_PARALLEL_RANKS)
# NCCL refuses two ranks on one card, so the 4 ranks share it over gloo,
# which moves the CUDA tensors of each collective through host memory
GLOO_TRANSPORT = ("gloo: 4 ranks on one card; each collective's CUDA "
                  "tensors staged through host memory")


def run_gpt_example(extra, steps):
    """The GPT example under ``torch.distributed.run``: 4 ranks of GPT-2
    small at tp = 2 x dp = 2 with sequence parallelism on this card.
    Returns its step records, rank 0's closing JSON and the wall time."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(GPT_PARALLEL_RANKS), "-m",
           "apex_tpu_torch.examples.gpt.pretrain_gpt", *GPT_PARALLEL_ARGV,
           "--steps", str(steps), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    records, summary = [], None
    for line in proc.stdout.splitlines():
        if line.startswith("step "):
            f = line.split()
            records.append(dict(step=int(f[1]), loss=float(f[3]),
                                grad_norm=float(f[5]),
                                loss_scale=float(f[7]),
                                tokens_per_s=float(f[9]),
                                step_ms=float(f[11]), verdict=f[13]))
        elif line.startswith("{"):
            summary = json.loads(line)
    if len(records) != steps or summary is None:
        raise AssertionError(f"the example printed {len(records)} steps of "
                             f"{steps}:\n{proc.stdout[-3000:]}")
    return records, summary, wall


#: the GPT example's launches under ``torch.distributed.run``: name, extra
#: flags, steps
GPT_PARALLEL_RUNS = (("gpt_parallel", ("--zero",), 4),
                     ("gpt_parallel_ddp", (), 3))


def gpt_parallel_phase(smi, world, examples):
    """(a) ZeRO, (b) DDP through the example at full width (``examples``:
    :func:`run_gpt_example`'s results by name, from
    :func:`multi_rank_runs`); (c) card against plain at small depth; (d)
    one NCCL step at a world of one."""
    torch.cuda.empty_cache()
    paths, report = {}, {"transport": GLOO_TRANSPORT, "gpu": smi}
    for name, extra, steps in GPT_PARALLEL_RUNS:
        kernels = PATH_KERNELS[name]
        records, summary, wall = examples[name]
        for r in records:
            log(f"{name} step {r['step']} loss {r['loss']:.4f} grad_norm "
                f"{r['grad_norm']:.4f} verdict {r['verdict']} tokens_per_s "
                f"{r['tokens_per_s']:.1f} step_ms {r['step_ms']:.2f} "
                f"({GLOO_TRANSPORT})")
        losses = [r["loss"] for r in records]
        if not all(math.isfinite(x) for x in losses) or any(
                r["verdict"] != "ok" for r in records):
            raise AssertionError(f"{name}: {records}")
        first = losses[0] - math.log(GPT_PARALLEL_VOCAB)
        if abs(first) > 0.5:
            raise AssertionError(f"{name}: first loss {losses[0]} is not "
                                 f"near ln {GPT_PARALLEL_VOCAB}")
        if (summary["world"], summary["tp"], summary["dp"],
                summary["sequence_parallel"]) != (4, 2, 2, True):
            raise AssertionError(f"{name}: layout {summary}")
        counts = summary["launch_counts_rank0"]
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: {missing} not launched on rank 0")
        if "--zero" in extra and (
                counts["adam_update"] != 0 or summary["zero_shard_len"]
                != zero_shard_tp2(GPT_PARALLEL_LAYERS)):
            raise AssertionError(f"{name}: Adam kernel launched or shard "
                                 f"{summary['zero_shard_len']}")
        paths[name] = counts
        measured = records[1:]
        report[name] = {
            "model": f"gpt2-small {GPT_PARALLEL_LAYERS}x768 vocab "
                     f"{GPT_PARALLEL_VOCAB} (random weights, bf16 compute, "
                     "fp32 params), tp=2 dp=2 sp",
            "steps": len(measured), "micro_batch": 4, "global_batch": 16,
            "seq_len": 1024, "first_loss": losses[0],
            "tokens_per_s_mean": statistics.mean(
                r["tokens_per_s"] for r in measured),
            "step_ms_mean": statistics.mean(r["step_ms"] for r in measured),
            "peak_mem_gb_by_rank": summary["peak_mem_gb_by_rank"],
            "launches_rank0": counts,
            "launches_per_step_rank0": {k: n / steps
                                        for k, n in counts.items()},
            "staged_per_step_rank0": {
                k: n / steps for k, n in
                summary["staged_through_host_rank0"].items()},
            "wall_s": wall}
        log(f"{name} " + json.dumps(report[name]))
    report["card_vs_plain"] = gpt_parallel_card_vs_plain(
        world["parallel_card_vs_plain"])
    report["nccl_world_of_one"] = nccl_world_of_one()
    return paths, report


CARD_VS_PLAIN = dict(vocab=GPT_PARALLEL_VOCAB, seq_len=256, layers=2,
                     hidden=768, heads=12, tp=2, micro_batch=2,
                     global_batch=4, seed=SEED, zero=True)


def parallel_card_vs_plain_args(target=CARD_VS_PLAIN):
    """``parallel_workers.card_vs_plain_worker``'s arguments: ``target``
    and its 3 batches of the synthetic stream, 2 fp32 steps, the card."""
    seq = target["seq_len"]
    lm = token_file_lm(target["vocab"], seq, 20_000)
    batches = [tuple(a.reshape(1, 4, seq) for a in lm.batch(range(4 * i,
                                                                4 * i + 4)))
               + (0.0,) for i in range(3)]
    return target, batches, 2, "cuda"


def gpt_parallel_card_vs_plain(ranks):
    """``ranks``: ``card_vs_plain_worker``'s results, the same 4 ranks and
    seed, 2 layers of GPT-2 small's width at seq 256: ZeRO training in
    bf16 (3 steps) and an fp32 loop of the model, the data-parallel
    all-reduce and fused_adam (2 steps), on the card's kernels and on the
    CPU's plain versions over gloo."""
    target = CARD_VS_PLAIN
    lr = 3e-4
    worst = {"bf16_loss": 0.0, "bf16_param": 0.0, "fp32_loss": 0.0,
             "fp32_param": 0.0, "fp32_param_abs": 0.0, "fp32_k_bias": 0.0}
    for r, out in enumerate(ranks):
        card, cpu = out["bf16"]["card"], out["bf16"]["plain"]
        # bf16: test_torch_training.py's tolerances
        for sg, sc in zip(card["steps"], cpu["steps"]):
            if (sg["verdict"], sg["loss_scale"]) != (sc["verdict"],
                                                     sc["loss_scale"]):
                raise AssertionError(f"rank {r}: {sg} vs {sc}")
            rel = abs(sg["loss"] - sc["loss"]) / abs(sc["loss"])
            worst["bf16_loss"] = max(worst["bf16_loss"], rel)
            if rel > 2e-3:
                raise AssertionError(f"rank {r} bf16 loss {sg} vs {sc}")
        for n, want in cpu["params"].items():
            err = float(np.abs(card["params"][n] - want).max())
            worst["bf16_param"] = max(worst["bf16_param"], err)
            if err > 2e-3:
                raise AssertionError(f"rank {r} bf16 {n}: {err}")
        card, cpu = out["fp32"]["card"], out["fp32"]["plain"]
        hold_fp32_to_plain(r, card["losses"], cpu["losses"], card["params"],
                           cpu["params"], target["hidden"] // target["heads"],
                           lr, worst)
        missing = [k for k in PATH_KERNELS["gpt_parallel"]
                   if out["launches"][k] == 0]
        if missing:
            raise AssertionError(f"rank {r}: {missing} not launched")
    result = {"ranks": len(ranks), **worst,
              "losses_bf16_card_rank0": [
                  x["loss"] for x in ranks[0]["bf16"]["card"]["steps"]]}
    log("gpt_parallel card vs plain (2 x 768, seq 256, 4 ranks, bf16 "
        "ZeRO steps to 2e-3, fp32 loop to 1e-4 relative in norm): "
        + json.dumps(result))
    return result


def hold_fp32_to_plain(r, card_losses, cpu_losses, card_params, cpu_params,
                       head_dim, lr, worst, loss_rtol=1e-4, zero_init=()):
    """fp32 training on the card against the CPU's plain versions: losses
    ``loss_rtol`` relative and each tensor 1e-4 relative in norm. Not
    element by element: Adam's first steps move an element by about lr
    whatever its gradient's size, so an element whose gradient nearly
    cancels (a few of the position table's 786,432 in a first run) moves
    either way on the two sides. The key bias's gradient is 0 in exact
    arithmetic (the softmax is invariant to it), so all of it moves on
    rounding noise: held to 2 lr a step, element by element. A tensor
    named in ``zero_init`` starts at zero, so its whole value is Adam's
    updates, where such an element weighs most: held to 1e-2 relative in
    norm (its gradients are held beside this). ``worst`` gathers the
    largest errors."""
    for lg, lc in zip(card_losses, cpu_losses):
        rel = abs(lg - lc) / abs(lc)
        worst["fp32_loss"] = max(worst["fp32_loss"], rel)
        if rel > loss_rtol:
            raise AssertionError(f"rank {r} fp32 losses {card_losses}"
                                 f" vs {cpu_losses}")
    for n, want in cpu_params.items():
        got = card_params[n]
        if n.endswith("query_key_value.bias"):
            k = np.zeros(want.shape, bool).reshape(
                want.shape[:-1] + (-1, 3, head_dim))
            k[..., 1, :] = True
            k = k.reshape(want.shape)
            kerr = float(np.abs(got - want)[k].max())
            worst["fp32_k_bias"] = max(worst["fp32_k_bias"], kerr)
            if kerr > 2 * lr * len(card_losses):
                raise AssertionError(f"rank {r} {n} key bias: {kerr}")
            got, want = got[~k], want[~k]
        rel = float(np.linalg.norm(got - want)
                    / max(np.linalg.norm(want), 1e-30))
        if n in zero_init:
            worst["fp32_zero_init"] = max(worst.get("fp32_zero_init", 0.0),
                                          rel)
            if rel > 1e-2:
                raise AssertionError(f"rank {r} fp32 {n} (zero at init): "
                                     f"relative error {rel} in norm")
            continue
        worst["fp32_param"] = max(worst["fp32_param"], rel)
        worst["fp32_param_abs"] = max(worst["fp32_param_abs"], float(
            np.abs(got - want).max()))
        if rel > 1e-4:
            raise AssertionError(f"rank {r} fp32 {n}: relative error "
                                 f"{rel} in norm")


def nccl_world_of_one():
    """One step of GPT-2 small (tp = dp = 1, vocab 50304) in a NCCL world
    of one: the gradient, loss and overflow-flag all-reduces run through
    NCCL on the card."""
    import tempfile

    import torch.distributed as dist

    from apex_tpu_torch.parallel import parallel_state as ps
    from apex_tpu_torch.resilience import VERDICT_OK
    from apex_tpu_torch.resilience.replay import (
        GPTTargetConfig,
        build_gpt_training,
    )
    from apex_tpu_torch.transformer.testing.commons import (
        initialize_distributed,
    )

    cfg = GPTTargetConfig(vocab=GPT_PARALLEL_VOCAB, seq_len=1024, layers=12,
                          hidden=768, heads=12, micro_batch=8,
                          global_batch=16, seed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed("nccl", init_method=f"file://{tmp}/store",
                               world_size=1, rank=0)
        try:
            backend = dist.get_backend()
            tr = build_gpt_training(cfg, device="cuda")
            state = tr.init_state()
            lm = token_file_lm(cfg.vocab, cfg.seq_len)
            x, y = tr.reshape_batch(*lm.batch(range(cfg.global_batch)))
            t0 = time.perf_counter()
            state, loss, verdict, metrics = tr.train_step(state, x, y)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            groups = (ps.get_tensor_model_parallel_group(),
                      ps.get_data_parallel_group())
            if backend != "nccl" or any(
                    dist.get_backend(g) != "nccl" for g in groups):
                raise AssertionError(f"backend {backend}")
        finally:
            ps.destroy_model_parallel()
            dist.destroy_process_group()
    if verdict != VERDICT_OK or not math.isfinite(loss):
        raise AssertionError(f"NCCL step: verdict {verdict}, loss {loss}")
    result = {"backend": backend, "loss": loss,
              "grad_norm": metrics["grad_norm"], "step_ms": ms}
    log("gpt_parallel NCCL world of one: " + json.dumps(result))
    del tr, state
    torch.cuda.empty_cache()
    return result


# -- GPT-2 small pipelined: pp = 2 x tp = 2, and interleaved at pp = 4 -------

GPT_PIPELINE_ARGV = (
    "--num-layers", "12", "--hidden-size", "768", "--num-attention-heads",
    "12", "--seq-length", "1024", "--max-position-embeddings", "1024",
    "--make-vocab-size-divisible-by", str(GPT_PARALLEL_VOCAB), "--bf16",
    "--micro-batch-size", "4", "--global-batch-size", "16", "--seed",
    str(SEED))
# the 1F1B and zero-bubble runs at depth 4 (cut from 12, and to 1 + 1
# steps, to keep the whole script under its time limit on a slow host)
PIPELINE_LAYERS = 4
GPT_PIPELINE_1F1B = ("--pipeline-model-parallel-size", "2",
                     "--tensor-model-parallel-size", "2",
                     "--sequence-parallel", "--num-layers",
                     str(PIPELINE_LAYERS), "--train-iters", "2",
                     "--distributed-backend", "gloo")
# 12 layers = pp 4 x V 3 chunks x 1 layer
GPT_PIPELINE_INTERLEAVED = ("--pipeline-model-parallel-size", "4",
                            "--num-layers-per-virtual-pipeline-stage", "1",
                            "--train-iters", "2")
# 2 layers, one a stage, at seq 128: small, to keep the whole script near
# 1,000 s
PIPELINE_CARD_VS_PLAIN_ARGV = (
    "--num-layers", "2", "--hidden-size", "768", "--num-attention-heads",
    "12", "--seq-length", "128", "--max-position-embeddings", "128",
    "--make-vocab-size-divisible-by", str(GPT_PARALLEL_VOCAB),
    "--pipeline-model-parallel-size", "2", "--tensor-model-parallel-size",
    "2", "--sequence-parallel", "--micro-batch-size", "2",
    "--global-batch-size", "4", "--train-iters", "3", "--lr", "3e-4",
    "--seed", str(SEED))


def run_standalone_gpt(extra):
    """``standalone_gpt`` under ``torch.distributed.run``, 4 ranks on this
    card over gloo: its per-step losses, rank 0's closing JSON and the
    wall time."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(GPT_PARALLEL_RANKS), "-m",
           "apex_tpu_torch.transformer.testing.standalone_gpt",
           *GPT_PIPELINE_ARGV, *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[2:])} exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    losses, summary = [], None
    for line in proc.stdout.splitlines():
        if line.startswith("iteration"):
            losses.append(float(line.split()[-1]))
        elif line.startswith("{"):
            summary = json.loads(line)
    if summary is None or len(losses) != summary["steps"]:
        raise AssertionError(f"standalone_gpt printed {len(losses)} steps:"
                             f"\n{proc.stdout[-3000:]}")
    return losses, summary, wall


def check_pipeline_run(name, summary, layout, kernels):
    """Finite losses, the first within 0.5 of what a random head gives
    (ln(vocab) + 768 HEAD_STD^2 / 2: the head is drawn at JAX's std, see
    ``models.gpt_pipeline.HEAD_STD``), the (tp, pp, dp, V, SP) layout,
    and each of ``kernels`` launched on the first and the last stage."""
    from apex_tpu_torch.models.gpt_pipeline import HEAD_STD

    losses = summary["losses"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: losses {losses}")
    expected = math.log(GPT_PARALLEL_VOCAB) + 768 * HEAD_STD ** 2 / 2
    if abs(losses[0] - expected) > 0.5:
        raise AssertionError(f"{name}: first loss {losses[0]} is not near "
                             f"ln {GPT_PARALLEL_VOCAB} + 768 x "
                             f"{HEAD_STD}^2 / 2 = {expected}")
    got = (summary["tp"], summary["pp"], summary["dp"],
           summary["num_model_chunks"], summary["sequence_parallel"])
    if got != layout:
        raise AssertionError(f"{name}: layout {got}, not {layout}")
    for stage in ("first", "last"):
        counts = summary[f"launch_counts_{stage}_stage"]
        missing = [k for k in kernels if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: {missing} not launched on the "
                                 f"{stage} stage")


PIPELINE_WORKERS = "apex_tpu_torch.transformer.testing.pipeline_workers"
#: the spawned runs of the 4-rank phases before the tail, as jobs of one
#: world of 4 (name, rank function, its arguments): the tp x dp card
#: against plain; the pipeline's interleaved schedule, card against plain,
#: zero bubble and zero bubble against 1F1B, and remat True against False
#: in fp32 and bf16; TinyLlama at cp = 4; MoE at ep = 4
# the spatial bottleneck over cp = 4 (H split in 4), fp32 on the card:
# a stride-1 block and a stride-2 one, in training mode; (N, H, W, C)
SPATIAL_CASES = [dict(channels=(64, 16, 64), stride=1, train=True,
                      shape=(4, 32, 32, 64), seed=SEED),
                 dict(channels=(64, 32, 128), stride=2, train=True,
                      shape=(4, 32, 32, 64), seed=SEED + 1)]
# each rank's rows against the unsharded block: fp32 convolutions and the
# BatchNorms' sums in another order over 4 ranks, relative to each
# tensor's largest element (the gradients of sum(out ** 2) cancel more);
# the running statistics absolute
SPATIAL_TOL = dict(out=1e-4, dx=1e-3, params=1e-3, stats=1e-5)


GLOO_JOBS = (
    ("parallel_card_vs_plain",
     "apex_tpu_torch.transformer.testing.parallel_workers:"
     "card_vs_plain_worker", lambda: parallel_card_vs_plain_args()),
    ("interleaved", f"{PIPELINE_WORKERS}:interleaved_worker",
     lambda: (GPT_PIPELINE_ARGV + GPT_PIPELINE_INTERLEAVED, "cuda")),
    ("card_vs_plain", f"{PIPELINE_WORKERS}:card_vs_plain_worker",
     lambda: (PIPELINE_CARD_VS_PLAIN_ARGV, 2, "cuda")),
    ("zero_bubble", f"{PIPELINE_WORKERS}:interleaved_worker",
     lambda: (GPT_PIPELINE_ARGV + GPT_PIPELINE_ZERO_BUBBLE, "cuda", True)),
    ("zero_bubble_vs_1f1b",
     "apex_tpu_torch.transformer.testing.cp_workers:"
     "zero_bubble_vs_1f1b_worker",
     lambda: (ZERO_BUBBLE_VS_1F1B_ARGV, "cuda")),
    ("remat_fp32", f"{PIPELINE_WORKERS}:remat_worker",
     lambda: (PIPELINE_REMAT_ARGV, "cuda")),
    ("remat_bf16", f"{PIPELINE_WORKERS}:remat_worker",
     lambda: (PIPELINE_REMAT_ARGV + ("--bf16",), "cuda")),
    ("llama_cp", "apex_tpu_torch.transformer.testing.cp_workers:"
     "cp_card_worker", lambda: (cp_jobs(), "cuda")),
    ("moe_ep", "apex_tpu_torch.transformer.testing.recompute_workers:"
     "moe_gpt_ep_worker", lambda: (MOE_EP, 4, 1024, "cuda")),
    ("spatial_bottleneck", "apex_tpu_torch.transformer.testing."
     "contrib_workers:spatial_bottleneck_worker",
     lambda: (SPATIAL_CASES, "cuda")),
)


def gloo_world():
    """The 4-rank phases' spawned runs (:data:`GLOO_JOBS`) in one world of
    4 ranks, which so pays the processes' start and their first
    activation checkpoint's imports once (torch's checkpoint imports
    ``torch._dynamo`` on its first call in a process: 25-50 s of the
    first step of each pipelined world on the card's host, where eight
    worlds paid their starts eight times). Returns ``({name: every rank's
    result}, seconds)``."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(jobs_worker, GPT_PARALLEL_RANKS, args=(
        [(fn, args()) for _, fn, args in GLOO_JOBS],),
        threads=RANK_THREADS, timeout=1200.0)
    seconds = time.perf_counter() - t0
    log(f"the shared world of 4 ran {seconds:.1f} s ({GLOO_TRANSPORT})")
    return {name: [r[i] for r in ranks]
            for i, (name, _, _) in enumerate(GLOO_JOBS)}, seconds


def multi_rank_runs():
    """Every spawned run of the multi-rank phases: the ZeRO LAMB world
    alone (:func:`zero_world`, the one that needs 40 GB of the card), then
    three lanes side by side: the shared world of 4 (:func:`gloo_world`);
    the tail's world of 4 (:func:`tail_world_of_4`); the tail's world of
    2, then the GPT example's launches (:data:`GPT_PARALLEL_RUNS`) and
    ``standalone_gpt``'s 1F1B under ``torch.distributed.run``. Each
    lane's ranks spend most of their time in process starts and in gloo's
    copies through host memory, with the card idle, so the lanes share
    the host's cores (their step times, compared with nothing, are those
    of runs side by side) and the card's memory (about 60 GB at most).
    The phases check the results afterwards, in the script's order.
    Returns ``{"zero": ..., "world": ..., "tail": ..., "launches":
    {...}}``."""
    from concurrent.futures import ThreadPoolExecutor

    def launches():
        out = {"two": tail_world_of_2()}
        for name, extra, steps in GPT_PARALLEL_RUNS:
            out[name] = run_gpt_example(extra, steps)
        out["gpt_pipeline"] = run_standalone_gpt(GPT_PIPELINE_1F1B)
        return out

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zero = zero_world()
    t1 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        lanes = {"world": pool.submit(timed, lambda: gloo_world()[0]),
                 "tail": pool.submit(timed, tail_world_of_4),
                 "launches": pool.submit(timed, launches)}
    out, seconds = {"zero": zero}, {}
    for name, lane in lanes.items():
        out[name], seconds[name] = lane.result()
    log(f"multi-rank runs: the ZeRO LAMB world {t1 - t0:.1f} s, then lanes "
        f"{json.dumps(seconds)} s side by side, "
        f"{time.perf_counter() - t1:.1f} s ({GLOO_TRANSPORT})")
    return out


def gpt_pipeline_phase(smi, world, standalone):
    """(a) ``standalone_gpt`` at GPT-2 small's full width and depth 4, pp =
    2 x tp = 2 with SP, 1F1B, 1 + 1 steps (``standalone``: its
    :func:`run_standalone_gpt` result); (b) the interleaved schedule at
    pp = 4, V = 3 (``world``: :func:`gloo_world`'s results), 1 + 1
    steps; (c) card against plain at 2 layers and seq 128."""
    torch.cuda.empty_cache()
    paths, report = {}, {"transport": GLOO_TRANSPORT, "gpu": smi}
    _, summary, wall = standalone
    inter = world["interleaved"][0]
    runs = (("gpt_pipeline", summary, (2, 2, 1, 1, True), wall,
             PIPELINE_LAYERS),
            ("gpt_pipeline_interleaved", inter, (1, 4, 1, 3, False),
             None, 12))
    for name, out, layout, wall, layers in runs:
        check_pipeline_run(name, out, layout, PATH_KERNELS[name])
        steps = out["steps"]
        paths[name] = out["launch_counts_first_stage"]
        report[name] = {
            "model": f"gpt2-small {layers}x768 vocab {GPT_PARALLEL_VOCAB} "
                     "(random weights, bf16 compute, fp32 params), "
                     f"tp={out['tp']} pp={out['pp']} dp={out['dp']} "
                     f"V={out['num_model_chunks']}"
                     + (" sp" if out["sequence_parallel"] else ""),
            "num_micro": out["num_micro"], "micro_batch": 4,
            "seq_len": 1024, "steps": steps, "losses": out["losses"],
            "step_ms": out["step_ms"],
            "step_ms_mean_after_first": out["step_ms_mean_after_first"],
            "tokens_per_s": out["tokens_per_s"],
            "peak_mem_gb_by_rank": out["peak_mem_gb_by_rank"],
            "launches_per_step_first_stage": {
                k: n / steps for k, n in
                out["launch_counts_first_stage"].items()},
            "launches_per_step_last_stage": {
                k: n / steps for k, n in
                out["launch_counts_last_stage"].items()},
            "staged_per_step_rank0": {
                k: n / steps for k, n in out["staged_rank0"].items()},
            "wall_s": wall}
        log(f"{name} ({GLOO_TRANSPORT}; tokens/s compared with nothing) "
            + json.dumps(report[name]))
    report["card_vs_plain"] = gpt_pipeline_card_vs_plain(
        world["card_vs_plain"])
    return paths, report


def gpt_pipeline_card_vs_plain(ranks):
    """``ranks``: ``card_vs_plain_worker``'s results, the same 4 ranks at
    pp = 2 x tp = 2 with SP, 2 layers of GPT-2 small's width at seq 128,
    from one seed: 3 bf16 steps within ``gpt_parallel_card_vs_plain``'s
    bounds (losses 2e-3 relative, parameters 2e-3 absolute), and 2 fp32
    steps (losses 1e-5 relative, every step's gradients and the final
    tensors 1e-4 relative in norm; the tensors that start at zero 1e-2
    and the key bias 2 lr a step element by element,
    ``hold_fp32_to_plain``)."""
    lr = 3e-4
    worst = {"bf16_loss": 0.0, "bf16_param": 0.0, "fp32_loss": 0.0,
             "fp32_param": 0.0, "fp32_param_abs": 0.0, "fp32_k_bias": 0.0}
    for r, out in enumerate(ranks):
        card, cpu = out["bf16"]["card"], out["bf16"]["plain"]
        for lg, lc in zip(card["losses"], cpu["losses"]):
            rel = abs(lg - lc) / abs(lc)
            worst["bf16_loss"] = max(worst["bf16_loss"], rel)
            if rel > 2e-3:
                raise AssertionError(f"rank {r} bf16 losses "
                                     f"{card['losses']} vs {cpu['losses']}")
        for n, want in cpu["params"].items():
            err = float(np.abs(card["params"][n] - want).max())
            worst["bf16_param"] = max(worst["bf16_param"], err)
            if err > 2e-3:
                raise AssertionError(f"rank {r} bf16 {n}: {err}")
        card, cpu = out["fp32"]["card"], out["fp32"]["plain"]
        for i, rels in enumerate(out["fp32"]["grad_rel"]):
            for n, rel in rels.items():
                worst["fp32_grad"] = max(worst.get("fp32_grad", 0.0), rel)
                if rel > 1e-4:
                    raise AssertionError(f"rank {r} fp32 step {i} gradient "
                                         f"{n}: relative error {rel} in norm")
        hold_fp32_to_plain(r, card["losses"], cpu["losses"], card["params"],
                           cpu["params"], 768 // 12, lr, worst,
                           loss_rtol=1e-5, zero_init=out["zero_init"])
        missing = [k for k in PATH_KERNELS["gpt_pipeline"]
                   if out["launches"][k] == 0]
        if missing:
            raise AssertionError(f"rank {r}: {missing} not launched")
    result = {"ranks": len(ranks), **worst,
              "losses_bf16_card_rank0": ranks[0]["bf16"]["card"]["losses"]}
    log("gpt_pipeline card vs plain (2 x 768, seq 128, pp 2 x tp 2 sp, bf16 "
        "to 2e-3, fp32 losses to 1e-5, every step's gradients and the "
        "tensors to 1e-4 relative in norm, those zero at init to 1e-2): "
        + json.dumps(result))
    return result


# -- the zero-bubble schedule ------------------------------------------------

# GPT-2 small at pp = 2 x tp = 2 with SP through the B/W split: the 1F1B
# run's settings (GPT_PIPELINE_1F1B), 1 + 1 steps
GPT_PIPELINE_ZERO_BUBBLE = ("--pipeline-model-parallel-size", "2",
                            "--tensor-model-parallel-size", "2",
                            "--sequence-parallel", "--num-layers",
                            str(PIPELINE_LAYERS), "--train-iters", "2")
# zero bubble against 1F1B: 2 layers at seq 128 in fp32, 2 steps
ZERO_BUBBLE_VS_1F1B_ARGV = PIPELINE_CARD_VS_PLAIN_ARGV + ("--train-iters",
                                                           "2")


def gpt_pipeline_zero_bubble_phase(smi, world):
    """(a) ``GPTPipelineTraining(zero_bubble=True)`` at GPT-2 small's full
    width and depth 4, pp = 2 x tp = 2 with SP, 1 + 1 steps; (b) zero
    bubble against 1F1B from the same weights at 2 layers, seq 128, fp32
    (``world``: :func:`gloo_world`'s results)."""
    from apex_tpu_torch.parallel.pipeline import algebra

    name = "gpt_pipeline_zero_bubble"
    out = world["zero_bubble"][0]
    if out["schedule"] != "zero_bubble":
        raise AssertionError(f"{name}: ran {out['schedule']}")
    check_pipeline_run(name, out, (2, 2, 1, 1, True), PATH_KERNELS[name])
    steps = out["steps"]
    cost = {s: {**vars(c), "bubble_fraction": c.bubble_fraction}
            for s, c in (("zero_bubble", algebra.zero_bubble_cost(2, 4)),
                         ("1f1b", algebra.one_f_one_b_cost(2, 4)))}
    report = {
        "transport": GLOO_TRANSPORT, "gpu": smi,
        "model": f"gpt2-small {PIPELINE_LAYERS}x768 vocab "
                 f"{GPT_PARALLEL_VOCAB} (random weights, bf16 compute, fp32 "
                 "params), tp=2 pp=2 dp=1 sp, zero bubble",
        "num_micro": out["num_micro"], "micro_batch": 4, "seq_len": 1024,
        "steps": steps, "losses": out["losses"], "step_ms": out["step_ms"],
        "step_ms_mean_after_first": out["step_ms_mean_after_first"],
        "tokens_per_s": out["tokens_per_s"],
        "peak_mem_gb_by_rank": out["peak_mem_gb_by_rank"],
        "launches_per_step_first_stage": {
            k: n / steps for k, n in out["launch_counts_first_stage"].items()},
        "launches_per_step_last_stage": {
            k: n / steps for k, n in out["launch_counts_last_stage"].items()},
        "staged_per_step_rank0": {
            k: n / steps for k, n in out["staged_rank0"].items()},
        "algebra": cost}
    log(f"{name} ({GLOO_TRANSPORT}; tokens/s compared with nothing) "
        + json.dumps(report))
    ranks = world["zero_bubble_vs_1f1b"]
    worst_loss = worst_grad = 0.0
    for r, res in enumerate(ranks):
        for a, b in zip(res["zero_bubble"], res["1f1b"]):
            worst_loss = max(worst_loss, abs(a - b) / abs(b))
        for step, (tensor, rel) in enumerate(res["grad_rel_worst"]):
            worst_grad = max(worst_grad, rel)
            if rel > 1e-4:
                raise AssertionError(f"{name} vs 1f1b: rank {r} step {step} "
                                     f"{tensor} {rel} relative in norm")
    if worst_loss > 1e-5:
        raise AssertionError(f"{name} vs 1f1b: losses {worst_loss} relative")
    report["vs_1f1b"] = {
        "layers": 2, "seq_len": 128, "dtype": "fp32", "steps": 2,
        "loss_rel": worst_loss, "grad_rel_in_norm": worst_grad,
        "losses_rank0": ranks[0]["zero_bubble"]}
    log(f"{name} against 1F1B (2 x 768, seq 128, fp32, same weights; "
        "losses to 1e-5, every gradient to 1e-4 relative in norm): "
        + json.dumps(report["vs_1f1b"]))
    return {name: out["launch_counts_first_stage"]}, report


# -- context parallelism -----------------------------------------------------

CP_RANKS = 4
CP_LAYERS = 2  # TinyLlama-1.1B's 22 layers cut to 2: four replicas share
#                the card, and the whole script stays near 1,000 s
CP_STEPS = 3
# the published context, 512 tokens a rank, ragged documents of
# 1024-2048 tokens (the JAX example's data at this size)
CP_BATCH = dict(batch=4, seq_len=2048, vocab=32000, doc_len_min=1024,
                seed=SEED)
CP_DECODE = dict(prompt=1024, total=1040)


def cp_fields(mode, dtype=torch.bfloat16):
    """TinyLlama-1.1B's config at CP_LAYERS layers with attention over cp
    (``mode``), as a dict a spawned rank rebuilds."""
    import dataclasses

    from apex_tpu_torch.models.gpt import tinyllama_1_1b_config

    return dataclasses.asdict(tinyllama_1_1b_config(
        num_layers=CP_LAYERS, compute_dtype=dtype,
        context_parallel_mode=mode))


def cp_kpm():
    """The CP batch's key-padding mask (True = padded), on the card."""
    from apex_tpu_torch.examples.long_context.train_ring_cp import make_batch

    return torch.as_tensor(make_batch(**CP_BATCH)["kpm"], device="cuda")


def cp_jobs():
    """``cp_workers.cp_card_worker``'s jobs: the ring and Ulysses training
    runs (one more step profiled), cp = 4 against cp = 1 in fp32 and bf16,
    and decode over cp."""
    jobs = [dict(kind="train", cp=CP_RANKS, config=cp_fields(mode),
                 batch=CP_BATCH, steps=CP_STEPS, lr=1e-3, profile=True)
            for mode in ("ring", "ulysses")]
    jobs += [dict(kind="vs_single", cp=CP_RANKS, config=cp_fields(mode, dt),
                  batch=CP_BATCH)
             for dt in (torch.float32, torch.bfloat16)
             for mode in ("ring", "ulysses")]
    jobs.append(dict(kind="decode", cp=CP_RANKS,
                     config=cp_fields("ring", torch.float32),
                     batch=CP_BATCH, **CP_DECODE))
    return jobs


def llama_cp_phase(smi, ranks):
    """TinyLlama-1.1B at full width, 2 layers, cp = 4 on 4 ranks of this
    card over gloo: ``train_ring_cp``'s step through the ring and through
    Ulysses (1 + 3 steps each, one more profiled), the CP step against a
    cp = 1 model from the same weights (fp32 losses and gradients, bf16
    mean loss), and KV-cache decode over cp against a cp = 1 forward
    (``ranks``: ``cp_card_worker``'s results of :func:`cp_jobs`)."""
    paths, report = {}, {"transport": GLOO_TRANSPORT, "gpu": smi}
    tokens = CP_BATCH["batch"] * CP_BATCH["seq_len"]
    for i, mode in enumerate(("ring", "ulysses")):
        name = f"llama_cp_{mode}"
        res = [r[i] for r in ranks]
        losses = [rec["loss"] for rec in res[0]["records"]]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: losses {losses}")
        std = 0.02  # the untied head's init std (models.gpt.init_params)
        expected = math.log(32000) + 2048 * std ** 2 / 2
        if abs(losses[0] - expected) > 0.5:
            raise AssertionError(f"{name}: first loss {losses[0]} is not "
                                 f"near ln 32000 + 2048 x {std}^2 / 2 = "
                                 f"{expected}")
        for step in range(len(losses)):
            digests = {r["records"][step]["digest"] for r in res}
            if len(digests) != 1:
                raise AssertionError(f"{name}: ranks' parameters differ "
                                     f"after step {step}")
        counts = res[0]["launches"]
        missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: {missing} not launched on rank 0")
        paths[name] = counts
        measured = res[0]["records"][1:]
        step_ms = statistics.mean(rec["ms"] for rec in measured)
        report[name] = {
            "model": f"tinyllama-1.1b {CP_LAYERS}x2048 (22 layers cut to "
                     f"{CP_LAYERS}), 32q/4kv heads, vocab 32000, random "
                     "weights, bf16 compute, fp32 params",
            "cp": CP_RANKS, "batch": CP_BATCH["batch"],
            "seq_len": CP_BATCH["seq_len"], "losses": losses,
            "step_ms": [rec["ms"] for rec in res[0]["records"]],
            "step_ms_mean_after_first": step_ms,
            "tokens_per_s": tokens / step_ms * 1e3,
            "peak_mem_gb_by_rank": [r["peak_mem_gb"] for r in res],
            "launches_per_step_rank0": {
                k: n / len(losses) for k, n in counts.items()},
            "staged_per_step_rank0": measured[-1]["staged"]}
        prof = res[-1]["profile"]
        report[name]["profile"] = {k: prof[k] for k in (
            "wall_ms", "device_ms", "device_idle_share", "spans",
            "chunk_update_host_share",
            "chunk_update_device_share_of_device_time", "top")}
        log(f"{name} ({GLOO_TRANSPORT}; tokens/s compared with nothing) "
            + json.dumps(report[name]))
    cases = [(mode, dt) for dt in ("fp32", "bf16")
             for mode in ("ring", "ulysses")]
    vs = {}
    for j, (mode, dt) in enumerate(cases, start=2):
        res = ranks[0][j]
        rel = (abs(res["cp_mean_loss"] - res["single_mean_loss"])
               / abs(res["single_mean_loss"]))
        row = {"cp_mean_loss": res["cp_mean_loss"],
               "single_mean_loss": res["single_mean_loss"],
               "mean_loss_rel": rel}
        if dt == "fp32":
            row.update({k: res[k] for k in (
                "loss_max_abs_err", "loss_max_rel_err", "worst_grad",
                "worst_grad_rel")})
            if not res["loss_ok"]:
                raise AssertionError(f"cp {mode} fp32: per-token losses off "
                                     f"by {res['loss_max_abs_err']} abs")
            if res["worst_grad_rel"] > 1e-4:
                raise AssertionError(f"cp {mode} fp32: {res['worst_grad']} "
                                     f"{res['worst_grad_rel']} in norm")
        elif rel > 2e-3:
            raise AssertionError(f"cp {mode} bf16: mean loss {rel} relative")
        vs[f"{mode} {dt}"] = row
    report["vs_cp1"] = vs
    log("llama cp=4 against cp=1, same weights and batch (fp32 per-token "
        "losses rtol 2e-4 atol 2e-5, every gradient 1e-4 in norm; bf16 mean "
        "loss 2e-3): " + json.dumps(vs))
    res = ranks[0][-1]
    got = torch.as_tensor(res["decoded"])
    want = torch.as_tensor(res["reference"])[:, CP_DECODE["prompt"]:]
    err = (got - want).abs()
    if not torch.allclose(got, want, rtol=2e-4, atol=2e-4):
        raise AssertionError(f"llama_cp_decode: logits off by "
                             f"{float(err.max())}")
    counts = res["launches"]
    missing = [k for k in PATH_KERNELS["llama_cp_decode"] if counts[k] == 0]
    if missing:
        raise AssertionError(f"llama_cp_decode: {missing} not launched")
    paths["llama_cp_decode"] = counts
    report["llama_cp_decode"] = {
        "prompt": CP_DECODE["prompt"],
        "decode_steps": CP_DECODE["total"] - CP_DECODE["prompt"],
        "logits_max_abs_err": float(err.max()), "launches_rank0": counts}
    log("llama_cp_decode (fp32, prefill over cp=4, decode through "
        "cp_decode_attention, against the cp=1 uncached forward, rtol 2e-4 "
        "atol 2e-4): " + json.dumps(report["llama_cp_decode"]))
    return paths, report



# -- amp front end (PR 12) ----------------------------------------------------

AMP_IMAGENET = dict(batch=256, image_size=224, warmup=3, steps=10)
AMP_IMAGENET_RUNS = (("O0", "bfloat16"), ("O1", "bfloat16"),
                     ("O2", "bfloat16"), ("O3", "bfloat16"),
                     ("O2", "float16"))
RESNET50_CONVS, RESNET50_LINEARS = 53, 1


def amp_imagenet_phase(smi, bench_rec):
    """The ported ImageNet example (``examples/imagenet/main_amp.py``) on
    ResNet-50 at 224^2, batch 256, seeded random images and weights,
    through ``amp.initialize`` and ``fused_sgd``: O0 (TF32 and cuDNN's
    autotuner off, as the bench's O0), O1, O2 and O3 in bf16 and O2 in fp16 with dynamic
    scaling, each 3 warm-up and 10 timed steps. Per level images/s, step
    ms, peak memory, the losses (finite and falling) and the scale; O1's
    casts per forward beside the convolutions and linears; bf16 O2's
    images/s against the bench's hand-cast O2 from this run, and a
    profile of two O2 steps."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.imagenet import main_amp

    c = AMP_IMAGENET
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    report = {}
    _kernels.reset_launch_counts()
    try:
        for level, half in AMP_IMAGENET_RUNS:
            tf32 = level != "O0"
            # the autotuner as the bench sets it: off for O0's fp32
            torch.backends.cudnn.benchmark = level != "O0"
            torch.backends.cudnn.allow_tf32 = tf32 and flags[1]
            torch.backends.cuda.matmul.allow_tf32 = tf32 and flags[2]
            profile = level == "O2" and half == "bfloat16"
            args = main_amp.parse_args([
                "--opt-level", level, "--half", half, "--batch-size",
                str(c["batch"]), "--image-size", str(c["image_size"]),
                "--warmup", str(c["warmup"]), "--steps",
                str(c["warmup"] + c["steps"]), "--seed", str(SEED),
                "--profile-steps", "2" if profile else "0"])
            casts = []
            rec = main_amp.train(args, log=lambda line: None, casts=casts)
            losses = rec["losses"]
            if not all(map(math.isfinite, losses)):
                raise AssertionError(f"amp_imagenet {level} {half}: "
                                     f"non-finite losses {losses}")
            if not losses[-1] < losses[0]:
                raise AssertionError(f"amp_imagenet {level} {half}: the "
                                     f"loss did not fall: {losses}")
            name = f"{level}_{half}"
            report[name] = {k: rec[k] for k in (
                "imgs_per_s", "step_ms", "peak_mem_gb", "losses", "scales",
                "skipped")}
            report[name]["tf32"] = torch.backends.cudnn.allow_tf32
            log(f"amp_imagenet {level} {half}: {rec['imgs_per_s']:.1f} "
                f"images/s, {rec['step_ms']:.2f} ms a step, peak "
                f"{rec['peak_mem_gb']:.2f} GB, losses {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}, scale {rec['scales'][-1]}, skipped "
                f"{sum(rec['skipped'])} of {len(losses)} ({smi})")
            if level == "O1":
                if len(set(casts)) != 1 or casts[0] <= 0:
                    raise AssertionError(f"O1 casts per forward: {casts}")
                report[name]["casts_per_forward"] = casts[0]
                log(f"amp_imagenet O1: the cast engine cast {casts[0]} "
                    f"tensors a forward, beside {RESNET50_CONVS} "
                    f"convolutions and {RESNET50_LINEARS} linear")
            if profile:
                prof = rec["profile"]
                report[name]["profile"] = prof
                log(f"profile amp_imagenet O2 (2 steps): wall "
                    f"{prof['wall_ms']:.2f} ms, device "
                    f"{prof['device_ms']:.2f} ms, idle "
                    f"{100 * prof['device_idle_share']:.1f}% "
                    + json.dumps(prof["top"]))
                log("profile amp_imagenet O2 host: "
                    + json.dumps(prof["host_top"]))
            del rec
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    launches = _kernels.launch_counts()
    o2 = report["O2_bfloat16"]["imgs_per_s"]
    report["bench_o2_imgs_per_s"] = bench_rec["O2"]["imgs_per_s"]
    report["o2_over_bench_o2"] = o2 / bench_rec["O2"]["imgs_per_s"]
    log(f"amp_imagenet O2 bf16 {o2:.1f} images/s against the bench's O2 "
        f"{bench_rec['O2']['imgs_per_s']:.1f} in this run: ratio "
        f"{report['o2_over_bench_o2']:.4f} ({smi})")
    log("amp_imagenet " + json.dumps(report))
    return launches, report


AMP_DCGAN = dict(steps=50, inject=(10, 1))


def amp_dcgan_phase(smi):
    """The ported DCGAN (``examples/dcgan/main_amp.py``) at the JAX
    example's defaults (batch 64, 32^2, nz 100), 50 steps of fp16 O2: two
    models, two ``AmpOptimizer``s, three scaled losses. An overflow
    injected into D's fake loss at step 10 skips D's step and halves that
    scaler alone; D's real-loss scaler and G's step and scaler go on."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.dcgan import main_amp

    c = AMP_DCGAN
    args = main_amp.parse_args(["--opt-level", "O2", "--half", "float16",
                                "--steps", str(c["steps"]), "--seed",
                                str(SEED)])
    _kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = main_amp.train(args, log=lambda line: None,
                          inject_overflow=c["inject"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    for r in recs:
        if not (math.isfinite(r["errD"]) and math.isfinite(r["errG"])):
            raise AssertionError(f"amp_dcgan: non-finite losses {r}")
    step = c["inject"][0]
    prev, hit = recs[step - 1], recs[step]
    if not (hit["d_skipped"] and hit["scale_d1"] == prev["scale_d1"] / 2
            and hit["scale_d0"] == prev["scale_d0"]
            and not hit["g_skipped"] and hit["scale_g"] == prev["scale_g"]):
        raise AssertionError(f"amp_dcgan: the injected overflow at step "
                             f"{step}: before {prev}, at {hit}")
    for name in PATH_KERNELS["amp_dcgan"]:
        if launches[name] == 0:
            raise AssertionError(f"amp_dcgan: {name} never launched")
    report = {"steps": c["steps"], "ms_per_step": wall * 1e3 / c["steps"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "errD": [r["errD"] for r in recs],
              "errG": [r["errG"] for r in recs],
              "scales": {k: [r[k] for r in recs]
                         for k in ("scale_d0", "scale_d1", "scale_g")},
              "d_skipped": [i for i, r in enumerate(recs) if r["d_skipped"]],
              "g_skipped": [i for i, r in enumerate(recs) if r["g_skipped"]]}
    log(f"amp_dcgan fp16 O2: {report['ms_per_step']:.2f} ms a step (host "
        f"clock, syncs each step), peak {report['peak_mem_gb']:.2f} GB, "
        f"errD {recs[0]['errD']:.4f} -> {recs[-1]['errD']:.4f}, errG "
        f"{recs[0]['errG']:.4f} -> {recs[-1]['errG']:.4f}; D skipped "
        f"{report['d_skipped']}, G skipped {report['g_skipped']}; at the "
        f"injected step {step}: D0 {hit['scale_d0']}, D1 "
        f"{prev['scale_d1']} -> {hit['scale_d1']}, G {hit['scale_g']} "
        f"({smi})")
    log("amp_dcgan " + json.dumps(report))
    return launches, report


AMP_MLP = dict(steps=60, inject=10)


def amp_mlp_phase(smi):
    """The ported simple example (``examples/simple/amp_mlp_train.py``),
    60 steps of fp16 O2 with an overflow injected at step 10: that step
    is skipped with the parameters, masters and Adam state bit-unchanged
    and the scale halved; the loss falls; #1 (the input LayerNorm), #8
    (Adam, per tensor) and #9 (``clip_grad_norm``) launch."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.simple import amp_mlp_train

    c = AMP_MLP
    args = amp_mlp_train.parse_args([
        "--steps", str(c["steps"]), "--opt-level", "O2", "--half",
        "float16", "--inject-overflow-at", str(c["inject"]), "--seed",
        str(SEED)])
    snap = {}

    def clone(d):
        return {k: v.detach().clone() for k, v in d.items()}

    def hook(i, params, state, info):
        if i in (c["inject"] - 1, c["inject"]):
            snap[i] = (clone(params), clone(state.master),
                       clone(state.inner.exp_avg),
                       clone(state.inner.exp_avg_sq), int(state.inner.step),
                       float(state.scaler.scale))

    _kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recs = amp_mlp_train.train(args, log=lambda line: None, hook=hook)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _kernels.launch_counts()
    before, after = snap[c["inject"] - 1], snap[c["inject"]]
    same = all(torch.equal(a[k], b[k]) for a, b in zip(before[:4], after[:4])
               for k in a)
    if not (recs[c["inject"]]["skipped"] and same
            and before[4] == after[4] and after[5] == before[5] / 2):
        raise AssertionError(f"amp_mlp: step {c['inject']} was not a clean "
                             f"skip: record {recs[c['inject']]}, state "
                             f"unchanged {same}, Adam step {before[4]} -> "
                             f"{after[4]}, scale {before[5]} -> {after[5]}")
    losses = [r["loss"] for r in recs]
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"amp_mlp: losses {losses}")
    for name in PATH_KERNELS["amp_mlp"]:
        if launches[name] == 0:
            raise AssertionError(f"amp_mlp: {name} never launched")
    report = {"ms_per_step": wall * 1e3 / c["steps"], "losses": losses,
              "scales": [r["scale"] for r in recs],
              "skipped": [i for i, r in enumerate(recs) if r["skipped"]]}
    log(f"amp_mlp fp16 O2: {report['ms_per_step']:.3f} ms a step (host "
        f"clock, one host read a step), loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, skipped {report['skipped']}, the injected step "
        f"{c['inject']} left params, masters and Adam state bit-unchanged "
        f"and took the scale {before[5]} -> {after[5]} ({smi})")
    log("amp_mlp " + json.dumps(report))
    return launches, report


# -- contrib and the RNNs ------------------------------------------------------

# the MHA example's sweep in the phase: its two ends, 10 and 120 sequences
MHA_ARGV = ["--seq-length", "64", "--layers", "18", "--hidden-dim", "1024",
            "--heads", "16", "--num-seqs-start", "10", "--num-seqs-stop",
            "120", "--num-seqs-inc", "110"]
MHA_CASES = (("self --norm-add --biases", ["--norm-add", "--biases"]),
             ("encdec", ["--encdec-attn"]))
# card against plain, relative in norm: fp32 the same products and sums
# in another order (cuBLAS against the CPU's GEMMs through a 1024-wide
# stack); bf16 against the fp32 plain path, activations rounded to bf16 at
# each layer (unit roundoff 2^-8), the gradients through more roundings;
# the bottleneck's input gradient passes three BatchNorm backwards, each
# of which subtracts from the bf16 gradient its batch mean and its
# projection on the normalised activation (differences of nearly equal
# terms, 5e-2 of it at a toy width on the CPU)
CONTRIB_TOL = {"fp32": 1e-5, "fp32 grad": 1e-4, "bf16": 2e-2,
               "bf16 grad": 5e-2, "bf16 bn input grad": 1e-1}
# the ResNet-50 bottleneck blocks at stage 1 (56 x 56): its repeated block
# and the first block of stage 2 (stride 2); batch 32
BOTTLENECKS = (("stage-1 256->64->256", (256, 64, 256, 1)),
               ("stride-2 256->128->512", (256, 128, 512, 2)))
BOTTLENECK_BATCH = 32
# a diffusion UNet's GroupNorm + swish (the reference kernel's hot shape)
GROUP_NORM_SHAPE, GROUP_NORM_GROUPS = (8, 320, 64, 64), 32
# an ASR transducer's joint output: 8 utterances, 256 frames, 64 label
# positions, 1024 word pieces (0.54 GB of fp32 logits)
TRANSDUCER_SHAPE = (8, 256, 64, 1024)
# a RetinaNet head at 800 x 800 (MLPerf's 120,087 anchors an image) over
# COCO's 91 classes padded to 96, 4 images
FOCAL_SHAPE, FOCAL_REAL = (4 * 120_087, 96), 91
# OpenFold's indexed multiply: 262,144 rows gathering from 65,536
INDEX_MUL = dict(m=65_536, n=262_144, h=128)
RNN_SHAPE = dict(seq=32, batch=16, hidden=1024, layers=2)


def _rel(got, ref):
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    return float((got - ref).norm() / max(float(ref.norm()), 1e-30))


def _held(name, rel, tol, report):
    report[name] = rel
    log(f"contrib {name}: {rel:.3e} relative in norm (tol {tol})")
    if not rel <= tol:
        raise AssertionError(f"contrib {name}: {rel} relative in norm "
                             f"(tol {tol})")


def mha_card_vs_plain(report):
    """A 2-layer stack of each MHA module at the example's width (4
    sequences of 64; encdec over 48 encoder positions with key padding and
    a fully padded row) on the card through the kernels, fp32 and bf16,
    against the plain path on the CPU in fp32 from the same weights: the
    output, the input gradients and every parameter gradient of
    sum(out ** 2)."""
    from apex_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn

    gen = torch.Generator().manual_seed(SEED + 40)
    x = torch.randn(64, 4, 1024, generator=gen)
    enc = torch.randn(48, 4, 1024, generator=gen)
    kpm = torch.zeros(4, 48, dtype=torch.bool)
    kpm[1], kpm[2, -11:] = True, True
    for name, cls, kw in (
            ("self", SelfMultiheadAttn, dict(bias=True,
                                             include_norm_add=True)),
            ("encdec", EncdecMultiheadAttn, dict(bias=True))):
        def run(device, dtype):
            mods = [cls(1024, 16, device=device, seed=SEED + i, **kw)
                    for i in range(2)]
            h = x.to(device, dtype).detach().requires_grad_(True)
            e = enc.to(device, dtype).detach().requires_grad_(True)
            y = h
            for m in mods:
                y = (m(y, e, key_padding_mask=kpm.to(device))
                     if name == "encdec" else m(y))
            y.float().square().sum().backward()
            grads = [p.grad for m in mods for p in m.parameters()]
            if name == "encdec":
                # sequence 1's keys are all padded: its attention output is
                # zeros, so the stack's output there is the last output
                # projection's bias
                bias = mods[-1].out_proj_bias.detach().to(dtype)
                if not torch.equal(y[:, 1].detach(), bias.expand(64, -1)):
                    raise AssertionError(f"mha encdec {device} {dtype}: the "
                                         "fully padded row is not zeros")
            return y, [h.grad] + ([e.grad] if name == "encdec" else []), \
                grads

        ref = run("cpu", torch.float32)
        for dtype, key in ((torch.float32, "fp32"), (torch.bfloat16,
                                                     "bf16")):
            y, dx, grads = run("cuda", dtype)
            _held(f"mha {name} {key} out", _rel(y, ref[0]), CONTRIB_TOL[key],
                  report)
            _held(f"mha {name} {key} input grads",
                  max(_rel(a, b) for a, b in zip(dx, ref[1])),
                  CONTRIB_TOL[key + " grad"], report)
            _held(f"mha {name} {key} param grads (worst)",
                  max(_rel(a, b) for a, b in zip(grads, ref[2])),
                  CONTRIB_TOL[key + " grad"], report)
            del y, dx, grads


def mha_example_sweep(report):
    """The example's loop at full width (hidden 1024, 16 heads, seq 64, 18
    layers), forward and backward, at 10 and 120 sequences, each case in
    fp32 and bf16; returns the launch counts of the sweep alone."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.examples.multihead_attn import (
        perf_test_multihead_attn as ex,
    )

    _kernels.reset_launch_counts()
    for name, extra in MHA_CASES:
        for dtype in ("fp32", "bf16"):
            args = ex.parse_args(MHA_ARGV + extra
                                 + (["--bf16"] if dtype == "bf16" else []))
            rows = ex.run(args, log=log, reps=1, target_signal=0.05,
                          max_span=8)
            report[f"mha {name} {dtype}"] = rows
    torch.cuda.synchronize()
    return _kernels.launch_counts()


def bottleneck_card(report):
    """Each block in bf16 on the card, forward and backward in training
    mode (batch statistics), against the same block in fp32 from the same
    weights: output, input gradient and every parameter gradient of
    mean(out ** 2); the bf16 step's ms (CUDA events, 10 steps)."""
    from apex_tpu_torch.contrib import Bottleneck

    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    for name, (cin, mid, cout, stride) in BOTTLENECKS:
        blocks = {dt: Bottleneck(cin, mid, cout, stride=stride,
                                 compute_dtype=dt, device="cuda", seed=SEED)
                  for dt in (torch.float32, torch.bfloat16)}
        x = torch.randn(BOTTLENECK_BATCH, cin, 56, 56, generator=gen,
                        device="cuda").contiguous(
                            memory_format=torch.channels_last)

        def step(block):
            xi = x.detach().requires_grad_(True)
            y = block(xi, train=True)
            y.float().square().mean().backward()
            return y, xi.grad

        got = {}
        for dt, block in blocks.items():
            block.zero_grad()
            y, dx = step(block)
            got[dt] = (y, dx, [p.grad.clone() for p in block.parameters()])
        (y32, dx32, g32), (y16, dx16, g16) = got.values()
        _held(f"bottleneck {name} bf16 out", _rel(y16, y32),
              CONTRIB_TOL["bf16"], report)
        _held(f"bottleneck {name} bf16 input grad", _rel(dx16, dx32),
              CONTRIB_TOL["bf16 bn input grad"], report)
        # the parameter gradients as one vector: a BatchNorm's bias and
        # scale gradients are sums over the batch that cancel, each alone
        # far smaller than the convolutions'
        _held(f"bottleneck {name} bf16 param grads",
              _rel(torch.cat([g.flatten() for g in g16]),
                   torch.cat([g.flatten() for g in g32])),
              CONTRIB_TOL["bf16 grad"], report)
        report[f"bottleneck {name} bf16 fwd+bwd ms"] = time_ms(
            lambda: step(blocks[torch.bfloat16]), iters=10)
        del got, x


def group_norm_card(report):
    """GroupNorm + swish in bf16 (channels-last) against the fp32 plain
    version of the same input, 1.56e-2 elementwise (one bf16 rounding of
    an fp32 result); its ms beside ``F.group_norm`` + ``F.silu``'s."""
    import torch.nn.functional as F

    from apex_tpu_torch.contrib import group_norm

    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    n, c, h, w = GROUP_NORM_SHAPE
    x = (torch.randn(n, c, h, w, generator=gen, device="cuda") * 3 + 1) \
        .to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    wt = torch.randn(c, generator=gen, device="cuda")
    bs = torch.randn(c, generator=gen, device="cuda")
    got = group_norm(x, GROUP_NORM_GROUPS, wt, bs, act="swish")
    ref = group_norm(x.float(), GROUP_NORM_GROUPS, wt, bs, act="swish")
    err = (got.float() - ref).abs()
    if bool((err > 1.56e-2 + 1.56e-2 * ref.abs()).any()):
        raise AssertionError(f"group_norm bf16: {float(err.max())}")
    report["group_norm bf16 max_abs_err"] = float(err.max())
    report["group_norm bf16 ms"] = time_ms(
        lambda: group_norm(x, GROUP_NORM_GROUPS, wt, bs, act="swish"))
    wl, bl = wt.to(x.dtype), bs.to(x.dtype)
    report["group_norm bf16 library ms"] = time_ms(
        lambda: F.silu(F.group_norm(x, GROUP_NORM_GROUPS, wl, bl)))


def transducer_card(report):
    """The loss and its gradient at an ASR size, fp32, card against CPU
    (the same wavefront; the log-softmax summed in another order): loss
    1e-5 and gradient 1e-5 relative in norm; the card's forward+backward
    ms."""
    from apex_tpu_torch.contrib import transducer_loss

    b, t, u, v = TRANSDUCER_SHAPE
    gen = torch.Generator().manual_seed(SEED + 43)
    x = torch.randn(b, t, u, v, generator=gen)
    label = torch.randint(1, v, (b, u - 1), generator=gen)
    f_len = torch.randint(t // 2, t + 1, (b,), generator=gen)
    y_len = torch.randint(u // 2, u, (b,), generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).detach().requires_grad_(True)
        loss = transducer_loss(xd, label.to(dev), f_len.to(dev),
                               y_len.to(dev), 0)
        loss.sum().backward()
        out[dev] = (loss.detach(), xd.grad)
    _held("transducer loss", _rel(out["cuda"][0], out["cpu"][0]),
          CONTRIB_TOL["fp32"], report)
    _held("transducer grad", _rel(out["cuda"][1], out["cpu"][1]),
          CONTRIB_TOL["fp32"], report)
    xc = x.cuda().requires_grad_(True)
    args = (label.cuda(), f_len.cuda(), y_len.cuda(), 0)
    report["transducer fp32 fwd+bwd ms"] = time_ms(
        lambda: torch.autograd.grad(transducer_loss(xc, *args).sum(), xc),
        iters=3)
    del out, xc


def small_ops_card(report):
    """Focal loss over a detection head's anchors and ``index_mul_2d`` at
    OpenFold's rows, card against CPU: value and gradients 1e-5 relative
    in norm (fp32 sums in another order; the gather exact)."""
    from apex_tpu_torch.contrib import focal_loss, index_mul_2d

    gen = torch.Generator().manual_seed(SEED + 44)
    n, k = FOCAL_SHAPE
    logits = torch.randn(n, k, generator=gen) * 2
    targets = torch.randint(-2, FOCAL_REAL, (n,), generator=gen)
    targets[torch.rand(n, generator=gen) < 0.9] = -1  # mostly negatives
    npos = float(max(int((targets >= 0).sum()), 1))
    out = {}
    for dev in ("cuda", "cpu"):
        xd = logits.to(dev).detach().requires_grad_(True)
        loss = focal_loss(xd, targets.to(dev), npos, FOCAL_REAL, 0.25, 2.0,
                          0.1)
        loss.backward()
        out[dev] = (loss.detach(), xd.grad)
    _held("focal_loss", _rel(out["cuda"][0], out["cpu"][0]),
          CONTRIB_TOL["fp32"], report)
    _held("focal_loss grad", _rel(out["cuda"][1], out["cpu"][1]),
          CONTRIB_TOL["fp32"], report)
    m, rows, h = INDEX_MUL["m"], INDEX_MUL["n"], INDEX_MUL["h"]
    in1 = torch.randn(m, h, generator=gen)
    in2 = torch.randn(rows, h, generator=gen)
    idx = torch.randint(0, m, (rows,), generator=gen)
    ct = torch.randn(rows, h, generator=gen)
    out = {}
    for dev in ("cuda", "cpu"):
        a = in1.to(dev).detach().requires_grad_(True)
        b = in2.to(dev).detach().requires_grad_(True)
        y = index_mul_2d(a, b, idx.to(dev))
        y.backward(ct.to(dev))
        out[dev] = (y.detach(), a.grad, b.grad)
    if not torch.equal(out["cuda"][0].cpu(), out["cpu"][0]):
        raise AssertionError("index_mul_2d: card output differs")
    _held("index_mul_2d in1 grad", _rel(out["cuda"][1], out["cpu"][1]),
          CONTRIB_TOL["fp32"], report)
    _held("index_mul_2d in2 grad", _rel(out["cuda"][2], out["cpu"][2]),
          CONTRIB_TOL["fp32"], report)


def asp_gpt2_card(report):
    """ASP's 2:4 masks over GPT-2 small's GEMM kernels on the card:
    every eligible kernel's mask exactly 2:4 along its pruned (input)
    axis, the first block's QKV mask equal to the CPU's, and the ms."""
    from apex_tpu_torch.contrib.sparsity import (
        compute_sparse_masks,
        default_eligibility,
    )
    from apex_tpu_torch.models import GPTModel, gpt2_small_config

    model = GPTModel(gpt2_small_config(), device="cuda", seed=SEED)
    params = {n: p.detach() for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = compute_sparse_masks(params)
    torch.cuda.synchronize()
    report["asp gpt2 masks ms"] = (time.perf_counter() - t0) * 1e3
    eligible = [n for n, p in params.items() if default_eligibility(n, p)]
    for name in eligible:
        groups = masks[name].movedim(-2, -1).reshape(-1, 4)
        if not bool((groups.sum(dim=1) == 2).all()):
            raise AssertionError(f"asp {name}: not exactly 2:4")
    first = next(n for n in eligible if "query_key_value" in n)
    cpu = compute_sparse_masks({first: params[first].cpu()})[first]
    if not torch.equal(masks[first].cpu(), cpu):
        raise AssertionError(f"asp {first}: card mask differs from the CPU")
    report["asp gpt2 eligible kernels"] = len(eligible)
    report["asp gpt2 pruned weights"] = sum(
        int((masks[n] == 0).sum()) for n in eligible)
    del model, params, masks


def rnn_card(report):
    """A 2-layer LSTM and an mLSTM at hidden 1024, fp32, card against CPU
    from the same weights: output and input gradient 1e-5 and 1e-4
    relative in norm (fp32 GEMMs summed in another order through 32
    steps); the card's forward+backward ms."""
    from apex_tpu_torch.rnn import LSTM, mLSTM

    c = RNN_SHAPE
    gen = torch.Generator().manual_seed(SEED + 45)
    xs = torch.randn(c["seq"], c["batch"], c["hidden"], generator=gen)
    for name, factory in (("LSTM", LSTM), ("mLSTM", mLSTM)):
        out = {}
        for dev in ("cuda", "cpu"):
            model = factory(c["hidden"], c["hidden"], num_layers=c["layers"],
                            device=dev, seed=SEED)
            x = xs.to(dev).detach().requires_grad_(True)
            h, _ = model(x)
            h.square().sum().backward()
            out[dev] = (h.detach(), x.grad)
            if dev == "cuda":
                report[f"{name} fwd+bwd ms"] = time_ms(
                    lambda: torch.autograd.grad(model(x)[0].sum(), x),
                    iters=3)
        _held(f"{name} out", _rel(out["cuda"][0], out["cpu"][0]),
              CONTRIB_TOL["fp32"], report)
        _held(f"{name} input grad", _rel(out["cuda"][1], out["cpu"][1]),
              CONTRIB_TOL["fp32 grad"], report)


def contrib_phase(smi):
    """The contrib zoo and the RNNs on the card: the MHA modules card
    against plain, the MHA example's loop (the counted ``contrib`` path:
    #1, #2, #5, #6, #7), the ResNet-50 bottleneck blocks, GroupNorm +
    swish, the transducer, focal loss, ``index_mul_2d``, ASP over GPT-2
    small and the LSTMs; every check's error and every time in one
    ``contrib`` line."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report = {"gpu": smi, "seconds": {}}
    launches = None
    for fn in (mha_card_vs_plain, mha_example_sweep, bottleneck_card,
               group_norm_card, transducer_card, small_ops_card,
               asp_gpt2_card, rnn_card):
        t1 = time.perf_counter()
        counts = fn(report)
        launches = launches or counts
        torch.cuda.empty_cache()
        report["seconds"][fn.__name__] = time.perf_counter() - t1
    report["phase_s"] = time.perf_counter() - t0
    log("contrib " + json.dumps(report))
    log(f"contrib phase {report['phase_s']:.1f} s ({smi})")
    return launches, report


def _close(name, got, ref, rtol, atol, errors):
    """Max abs error of ``got`` (card) against ``ref`` (CPU); raises past
    ``atol + rtol * |ref|``."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    err = (got - ref).abs()
    if bool((err > atol + rtol * ref.abs()).any()) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"amp_parity {name}: card differs by "
                             f"{float(err.max())} (rtol {rtol}, atol {atol})")
    errors[name] = max(errors.get(name, 0.0), float(err.max()))


def _close_norm(name, got, ref, tol, errors, tensor=""):
    """``|got - ref| / |ref|`` in the 2-norm, ``got`` (card) against
    ``ref`` (CPU); raises past ``tol``. An all-zero reference fails unless
    ``got`` equals it."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    rel = float((got - ref).norm() / max(float(ref.norm()), 1e-30))
    if not rel <= tol or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"amp_parity {name} {tensor}: card differs by "
                             f"{rel} relative in norm (tol {tol})")
    errors[name] = max(errors.get(name, 0.0), rel)


# amp_parity's tolerances for the two examples' 3 steps, card against CPU.
# simple: (level, half, losses rtol, parameters (rtol, atol)); fp32 O0 at
# 1e-4 relative (+1e-6: the GEMMs and the LayerNorm kernel sum in another
# order). At O2 Adam's update is about lr = 1e-3 an element whatever the
# gradient's size, so a gradient that a half rounding tips moves its element
# by up to 2 lr a step: bf16 parameters at atol 5e-3 (below 3 steps x 2 lr,
# 2.5x the 2.0e-3 measured on an H100), fp16 at 2e-3.
# dcgan: (level, half, first step's losses rtol, later steps' losses rtol)
# of the example's 3 steps. The first step starts from the same weights; by
# the next, Adam has moved the weights whose gradients sit at the rounding
# level by about lr, differently on the two sides (on an H100 at fp32, errD
# differed by 8.4e-5 relative at step 3 in one run of four, 2.2e-6-2.5e-6
# in the others), so fp32's later steps are held at 5e-4. The half levels at 5-8x
# what the H100 measured (6.7e-4 bf16, 3.6e-4 fp16 relative), under one
# rounding of a loss in their dtype.
# "dcgan step": the masters' (rtol, atol) after 3 amp steps from the same
# gradients. #8 and the plain Adam agree bit for bit in adam_parity, but the
# bias correction 1 - beta2**t is an fp32 pow on each side, and the card's
# and the CPU's round 0.999**2 an ulp apart: 3e-5 of the correction, about
# 1.5e-5 of that step's update (the H100 measured 3.7e-9 on a master);
# atol 2e-8 is 1e-4 of lr.
AMP_PARITY = {
    "simple": (("O0", "bfloat16", 1e-4, (1e-4, 1e-6)),
               ("O2", "bfloat16", 2e-2, (0.0, 5e-3)),
               ("O2", "float16", 2e-3, (2e-3, 2e-3))),
    "dcgan": (("O0", "bfloat16", 1e-5, 5e-4),
              ("O2", "bfloat16", 5e-3, 5e-3),
              ("O2", "float16", 2e-3, 2e-3)),
    "dcgan step": (1e-6, 2e-8),
}


def amp_parity():
    """The amp slice on the card against its plain path on the CPU from
    the same weights and data, at small sizes; raises on any difference
    past the stated tolerance. Returns the worst error of each check."""
    from apex_tpu_torch import _kernels, amp
    from apex_tpu_torch.amp.probe import o1_probe
    from apex_tpu_torch.examples.dcgan import main_amp as dcgan
    from apex_tpu_torch.examples.simple import amp_mlp_train
    from apex_tpu_torch.normalization import FusedLayerNorm, FusedRMSNorm
    from apex_tpu_torch.ops.mlp import mlp_init
    import apex_tpu_torch.optimizers as opts

    errors = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        # (a) the simple example, 3 steps; scales and skips exactly, the
        # losses and final parameters at AMP_PARITY's tolerances
        rs = np.random.RandomState(SEED + 30)
        x = rs.randn(512, 256).astype(np.float32)
        y = (x @ rs.randn(256).astype(np.float32))[:, None]
        init = {k: v.numpy() for k, v in mlp_init(
            SEED, amp_mlp_train.SIZES, device="cpu").items()}
        for level, half, tol, (prtol, patol) in AMP_PARITY["simple"]:
            runs = {}
            for dev in ("cuda", "cpu"):
                final = {}
                args = amp_mlp_train.parse_args([
                    "--steps", "3", "--opt-level", level, "--half", half,
                    "--device", dev, "--inject-overflow-at", "1"])
                recs = amp_mlp_train.train(
                    args, params=init, data=(x, y), log=lambda line: None,
                    hook=lambda i, p, s, info: final.update(p))
                runs[dev] = (recs, final)
            (gr, gp), (cr, cp) = runs["cuda"], runs["cpu"]
            if [(r["scale"], r["skipped"]) for r in gr] != \
                    [(r["scale"], r["skipped"]) for r in cr]:
                raise AssertionError(f"amp_parity simple {level} {half}: "
                                     f"{gr} against {cr}")
            key = f"simple {level} {half}"
            _close(key + " losses", torch.tensor([r["loss"] for r in gr]),
                   torch.tensor([r["loss"] for r in cr]), tol, 0.0, errors)
            for n in gp:
                _close(key + " params", gp[n], cp[n], prtol, patol, errors)
        # (b) the DCGAN at batch 8 from one seed. (b1) 3 steps of the
        # example at fp32 O0, bf16 O2 and fp16 O2: scales and skips exactly,
        # the losses at AMP_PARITY's relative tolerance. Its parameters
        # after those steps are logged, not held: Adam's first steps move an
        # element by about lr whatever its gradient's size, so the
        # gradients at the rounding level (the biases before GroupNorm) take
        # lr-sized steps that differ between any two summation orders. What
        # makes those steps is held instead, each from identical inputs:
        # (b2) the gradients of D's real and fake losses and of G's loss at
        # fp32, 1e-4 relative in norm (the CPU tests' bound against JAX);
        # (b3) the amp step, AmpOptimizer over fused_adam (#8) on D (two
        # losses, unscale_grads + step_unscaled) and G (step) for 3 steps
        # of the same scaled gradients, at O0 and fp16 O2 (masters; D's
        # third step overflows there, 0.52 x 2 x 65536 > 65504, and is
        # skipped): the scales exactly, the masters at AMP_PARITY's
        # "dcgan step" tolerances, the fp16 parameters to one fp16 ulp
        # (2^-10 relative, 2^-24 absolute: the subnormals' step)
        rs = np.random.RandomState(SEED + 31)
        data = [(rs.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32),
                 rs.randn(8, 100).astype(np.float32)) for _ in range(3)]
        for level, half, tol0, tol in AMP_PARITY["dcgan"]:
            runs, nets = {}, {}
            for dev in ("cuda", "cpu"):
                args = dcgan.parse_args(["--opt-level", level, "--half",
                                         half, "--batch-size", "8",
                                         "--steps", "3", "--device", dev])
                nets[dev] = dcgan.build_models(32, 100, dev, SEED)
                runs[dev] = dcgan.train(args, models=nets[dev], data=data,
                                        log=lambda line: None)
            key = f"dcgan {level} {half if level != 'O0' else 'fp32'}"
            for k in ("scale_d0", "scale_d1", "scale_g", "d_skipped",
                      "g_skipped"):
                if [r[k] for r in runs["cuda"]] != \
                        [r[k] for r in runs["cpu"]]:
                    raise AssertionError(f"amp_parity {key} {k}: "
                                         f"{runs['cuda']} against "
                                         f"{runs['cpu']}")
            for k in ("errD", "errG"):
                got, ref = (torch.tensor([r[k] for r in runs[dev]])
                            for dev in ("cuda", "cpu"))
                _close(f"{key} {k} first step", got[:1], ref[:1], tol0, 0.0,
                       errors)
                _close(f"{key} {k}", got[1:], ref[1:], tol, 0.0, errors)
            worst = 0.0
            for gnet, cnet in zip(nets["cuda"], nets["cpu"]):
                cref = dict(cnet.named_parameters())
                for n, t in gnet.named_parameters():
                    t, r = t.detach().float().cpu(), cref[n].detach().float()
                    worst = max(worst, float((t - r).norm() / r.norm()))
            errors[f"{key} params after 3 steps, logged"] = worst
        grads = {}
        for dev in ("cuda", "cpu"):
            g, d = dcgan.build_models(32, 100, dev, SEED)
            real, z = (torch.as_tensor(a, device=dev) for a in data[0])
            fake = g(z)
            out = {}
            for name, net, logits, label in (
                    ("D real", d, lambda: d(real), 1.0),
                    ("D fake", d, lambda: d(fake.detach()), 0.0),
                    ("G", g, lambda: d(fake), 1.0)):
                lg = logits()
                loss = dcgan.bce_with_logits(
                    lg, torch.full_like(lg, label)).mean()
                out[name] = dict(zip(
                    [n for n, _ in net.named_parameters()],
                    torch.autograd.grad(loss, list(net.parameters()),
                                        retain_graph=True)))
            grads[dev] = out
        for name, ref in grads["cpu"].items():
            for n, t in grads["cuda"][name].items():
                _close_norm(f"dcgan fp32 {name} grads", t, ref[n], 1e-4,
                            errors, n)
        mrtol, matol = AMP_PARITY["dcgan step"]
        for level, half in (("O0", torch.float32), ("O2", torch.float16)):
            _kernels.reset_launch_counts()
            res = {}
            for dev in ("cuda", "cpu"):
                g, d = dcgan.build_models(32, 100, dev, SEED)
                d, d_amp, _ = amp.initialize(
                    d, opts.fused_adam(lr=2e-4, betas=(0.5, 0.999)),
                    opt_level=level, half_dtype=half, num_losses=2)
                g, g_amp, _ = amp.initialize(
                    g, opts.fused_adam(lr=2e-4, betas=(0.5, 0.999)),
                    opt_level=level, half_dtype=half)
                dp, gp = dict(d.named_parameters()), \
                    dict(g.named_parameters())
                ds, gs = d_amp.init(dp), g_amp.init(gp)

                def scaled(gr, params, scaler, k, dev=dev):
                    """The CPU gradients of one loss, varied by step, in
                    each parameter's dtype times that loss's scale."""
                    return {n: (t * (1.0 + 0.5 * k) * scaler.scale.cpu())
                            .to(device=dev, dtype=params[n].dtype)
                            for n, t in gr.items()}

                for k in range(3):
                    unscaled, infs = {}, {}
                    for i, name in enumerate(("D real", "D fake")):
                        unscaled[i], infs[i] = d_amp.unscale_grads(
                            scaled(grads["cpu"][name], dp, ds.scaler[i], k),
                            ds, loss_id=i)
                    dp, ds, _ = d_amp.step_unscaled(
                        {n: unscaled[0][n] + unscaled[1][n] for n in dp},
                        ds, dp, infs)
                    gp, gs, _ = g_amp.step(
                        scaled(grads["cpu"]["G"], gp, gs.scaler, k), gs, gp)
                res[dev] = ((d, ds), (g, gs))
            if _kernels.launch_counts()["adam_update"] == 0:
                raise AssertionError("amp_parity: the DCGAN's amp step "
                                     "never launched adam_update")
            key = f"dcgan step {level}"
            scales = {dev: [float(s.scale) for s in (*ds.scaler,
                                                     gs.scaler)]
                      for dev, ((_, ds), (_, gs)) in res.items()}
            if scales["cuda"] != scales["cpu"]:
                raise AssertionError(f"amp_parity {key}: scales {scales}")
            for (gm, gst), (cm, cst) in zip(res["cuda"], res["cpu"]):
                for n in cst.master:
                    _close(f"{key} masters", gst.master[n], cst.master[n],
                           mrtol, matol, errors)
                cref = dict(cm.named_parameters())
                for n, t in gm.named_parameters():
                    if t.dtype != cref[n].dtype:
                        raise AssertionError(f"amp_parity {key} {n}: "
                                             f"{t.dtype} on the card, "
                                             f"{cref[n].dtype} on the CPU")
                    rtol, atol = ((mrtol, matol) if t.dtype == torch.float32
                                  else (2.0 ** -10, 2.0 ** -24))
                    _close(f"{key} params", t, cref[n], rtol, atol, errors)
        # (c) the O1 probe: every stage's dtype on the card is the CPU's
        # (which the CPU tests hold to JAX's O1), bf16 values 2e-2
        rs = np.random.RandomState(SEED + 32)
        x, w = (torch.as_tensor(rs.randn(*s).astype(np.float32))
                for s in ((64, 128), (128, 64)))
        g = torch.as_tensor(1.0 + 0.1 * rs.randn(64).astype(np.float32))
        with amp.cast_ops(torch.bfloat16):
            card = o1_probe(x.cuda(), w.cuda(), g.cuda())
            cpu = o1_probe(x, w, g)
        for k in cpu:
            if card[k].dtype != cpu[k].dtype:
                raise AssertionError(f"amp_parity O1 probe {k}: "
                                     f"{card[k].dtype} on the card, "
                                     f"{cpu[k].dtype} on the CPU")
        _close("o1 probe matmul", card["matmul"], cpu["matmul"], 2e-2, 2e-2,
               errors)
        errors["o1 probe dtypes"] = {k: str(v.dtype)[6:]
                                     for k, v in card.items()}
        # (d) the normalization modules, forward and backward, fp32 and
        # bf16 at the kernels' tolerances; they launch #1-#4
        _kernels.reset_launch_counts()
        for cls, fwd, bwd in ((FusedLayerNorm, "layer_norm_fwd",
                               "layer_norm_bwd"),
                              (FusedRMSNorm, "rms_norm_fwd",
                               "rms_norm_bwd")):
            for dtype in (torch.float32, torch.bfloat16):
                xs = torch.as_tensor(rs.randn(4, 8, 1024).astype(
                    np.float32)).to(dtype)
                dy = torch.as_tensor(rs.randn(4, 8, 1024).astype(
                    np.float32)).to(dtype)
                outs = {}
                for dev in ("cuda", "cpu"):
                    m = cls((8, 1024), device=dev, memory_efficient=True)
                    with torch.no_grad():
                        m.weight.copy_(1.0 + 0.1 * torch.arange(
                            8 * 1024).reshape(8, 1024).sin())
                    xi = xs.to(dev).requires_grad_()
                    out = m(xi)
                    out.backward(dy.to(dev))
                    outs[dev] = (out, xi.grad, m.weight.grad)
                atol, rtol = TOL[(fwd, dtype)]
                _close(f"{cls.__name__} {str(dtype)[6:]} out",
                       outs["cuda"][0], outs["cpu"][0], rtol, atol, errors)
                atol, rtol = TOL[(bwd, dtype)]
                _close(f"{cls.__name__} {str(dtype)[6:]} dx",
                       outs["cuda"][1], outs["cpu"][1], rtol, atol, errors)
                _close(f"{cls.__name__} {str(dtype)[6:]} dw",
                       outs["cuda"][2], outs["cpu"][2], 1e-4, 2e-3, errors)
        counts = _kernels.launch_counts()
        for name in ("layer_norm_fwd", "layer_norm_bwd", "rms_norm_fwd",
                     "rms_norm_bwd"):
            if counts[name] == 0:
                raise AssertionError(f"amp_parity: the normalization "
                                     f"modules never launched {name}")
        # (e) each new optimizer and clip_grad_norm, 3 steps in fp32:
        # updates and states 1e-5 relative + 1e-7 (LAMB's norms through
        # #9 sum in another order); LAMB and the clip launch #9
        shapes = {"a": (257, 129), "b": (1000,), "c.w": (64, 3, 3)}
        cases = {
            "fused_lamb": opts.fused_lamb(lr=1e-2, weight_decay=0.01),
            "fused_novograd": opts.fused_novograd(lr=1e-2,
                                                  weight_decay=1e-3),
            "fused_adagrad": opts.fused_adagrad(lr=1e-2, weight_decay=1e-3),
            "fused_adam_swa": opts.fused_adam_swa(0.9, lr=1e-2,
                                                  weight_decay=1e-3),
            "larc": opts.larc(opts.fused_sgd(lr=0.1, momentum=0.9), lr=0.1),
        }
        for name, tx in cases.items():
            params = {n: torch.as_tensor(rs.randn(*s).astype(np.float32))
                      for n, s in shapes.items()}
            grads = [{n: torch.as_tensor(rs.randn(*s).astype(np.float32))
                      for n, s in shapes.items()} for _ in range(3)]
            _kernels.reset_launch_counts()
            result = {}
            for dev in ("cuda", "cpu"):
                p = {n: t.to(dev) for n, t in params.items()}
                st = tx.init(p)
                for g in grads:
                    upd, st = tx.update({n: t.to(dev) for n, t in g.items()},
                                        st, p)
                    p = {n: p[n] + upd[n] for n in p}
                result[dev] = p
            for n in shapes:
                _close(f"{name} params", result["cuda"][n],
                       result["cpu"][n], 1e-5, 1e-7, errors)
            if name == "fused_lamb" and \
                    _kernels.launch_counts()["sumsq_flat"] == 0:
                raise AssertionError("amp_parity: fused_lamb never "
                                     "launched sumsq_flat")
        for norm_type in (2.0, float("inf"), 1.5):
            g = {n: torch.as_tensor(rs.randn(*s).astype(np.float32))
                 for n, s in shapes.items()}
            gc_, nc = opts.clip_grad_norm({n: t.cuda() for n, t in g.items()},
                                          0.5, norm_type)
            gp_, np_ = opts.clip_grad_norm(g, 0.5, norm_type)
            _close(f"clip_grad_norm {norm_type} norm", nc, np_, 1e-5, 0.0,
                   errors)
            for n in g:
                _close(f"clip_grad_norm {norm_type}", gc_[n], gp_[n], 1e-5,
                       1e-7, errors)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = tf32
    log("amp_parity (card against the CPU's plain path; tolerances in "
        "chip_smoke.amp_parity): " + json.dumps(errors))
    return errors


OPT_TIMING_STEPS = 3


def amp_optimizer_timings(smi):
    """One step of ``fused_adam``, ``fused_lamb``, ``fused_novograd``,
    ``fused_adagrad`` and ``fused_adam_swa`` over Megatron BERT-345M's
    parameters (``models.bert``, fp32) and seeded random gradients: the
    mean of 3 steps after one warm-up step (CUDA events) and the kernels
    each step launches. Recorded for a later performance issue."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import BertModel, megatron_bert_345m_config
    import apex_tpu_torch.optimizers as opts

    model = BertModel(megatron_bert_345m_config(), device="cuda", seed=SEED)
    params = {n: p.detach() for n, p in model.named_parameters()}
    del model
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = {n: torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    rows = {}
    for name, tx in (("fused_adam", opts.fused_adam(lr=1e-4)),
                     ("fused_lamb", opts.fused_lamb(lr=1e-4)),
                     ("fused_novograd", opts.fused_novograd(lr=1e-4)),
                     ("fused_adagrad", opts.fused_adagrad(lr=1e-4)),
                     ("fused_adam_swa", opts.fused_adam_swa(0.9, lr=1e-4))):
        state = tx.init(params)
        _, state = tx.update(grads, state, params)  # warm-up
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(OPT_TIMING_STEPS):
            _, state = tx.update(grads, state, params)
        e1.record()
        torch.cuda.synchronize()
        counts = _kernels.launch_counts()
        rows[name] = {
            "ms": e0.elapsed_time(e1) / OPT_TIMING_STEPS,
            "launches_per_step": {k: v // OPT_TIMING_STEPS
                                  for k, v in counts.items() if v},
            "tensors": len(params), "parameters": n_params}
        del state
        torch.cuda.empty_cache()
    log(f"optimizer steps over BERT-345M's {n_params:,} parameters in "
        f"{len(params)} tensors, fp32 ({smi}): " + json.dumps(rows))
    return rows

# -- recompute, MoE and FP8 ----------------------------------------------------

RECOMPUTE = dict(micro_batch=8, seq_len=1024, num_micro=2, warmup=1, steps=3,
                 lr=3e-4, weight_decay=0.01)
GRANULARITIES = (None, "selective", "full")


def _recompute_run(granularity, dropout, steps, num_micro, keep_grads=False):
    """GPT-2 small at ``granularity`` (hidden and attention dropout
    ``dropout``) trained ``steps`` steps of ``num_micro`` micro-batches
    of 8 x 1024 seeded random tokens through ``fused_adam``, from seed 0.
    Returns the losses, each step's ms, the peak memory and launch counts
    of the steps after the first, the first step's gradients (with
    ``keep_grads``) and the final parameters (both on the host, so that
    no run's peak counts another's), and the dropout generators'
    states."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, gpt2_small_config
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer.layer import ShardAwareDropout

    cfg = gpt2_small_config(recompute_granularity=granularity,
                            hidden_dropout=dropout, attention_dropout=dropout)
    model = GPTModel(cfg, device="cuda", seed=SEED).train()
    params = dict(model.named_parameters())
    tx = fused_adam(lr=RECOMPUTE["lr"],
                    weight_decay=RECOMPUTE["weight_decay"])
    state = tx.init(params)
    gen = torch.Generator().manual_seed(SEED + 1)
    mb, seq = RECOMPUTE["micro_batch"], RECOMPUTE["seq_len"]
    tokens = torch.randint(0, cfg.vocab_size, (steps, num_micro, mb, seq),
                           generator=gen).cuda()
    losses, step_ms, first_grads, forward_gb = [], [], None, None
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        total = 0.0
        for m in range(num_micro):
            toks = tokens[i, m]
            loss = gpt_loss_fn(model(toks, labels=torch.roll(toks, -1, 1)))
            if i == 1 and m == 0:  # what the forward keeps for the backward
                forward_gb = (torch.cuda.memory_allocated() / 1e9,
                              torch.cuda.max_memory_allocated() / 1e9)
            (loss / num_micro).backward()
            total = total + loss.detach() / num_micro
        grads = {n: p.grad for n, p in params.items()}
        if keep_grads and i == 0:  # on the host: the card's peak is this run's
            first_grads = {n: g.cpu() for n, g in grads.items()}
        updates, state = tx.update(grads, state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(updates[n])
        losses.append(float(total))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _kernels.launch_counts()
    gens = []
    for m in model.modules():
        if isinstance(m, ShardAwareDropout) and m.generator is not None:
            gens.append(m.generator.get_state())
    out = dict(losses=losses, step_ms=step_ms,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               mem_gb_after_forward=forward_gb[0],
               peak_mem_gb_in_forward=forward_gb[1],
               launches=launches,
               launches_per_step={k: n / (steps - 1)
                                  for k, n in launches.items()},
               first_grads=first_grads,
               params={n: p.detach().cpu() for n, p in params.items()},
               generator_states=gens)
    del model, state, params
    return out


def _compare_runs(a, b):
    """(bit-equal?, the largest relative error in norm) over the first
    step's gradients (when kept) and the final parameters."""
    worst, equal = 0.0, True
    pairs = [(a["params"], b["params"])]
    if a["first_grads"] is not None:
        pairs.append((a["first_grads"], b["first_grads"]))
    for x, y in pairs:
        for n, t in x.items():
            equal &= bool(torch.equal(t, y[n]))
            worst = max(worst, float((t - y[n]).float().norm()
                                     / max(float(y[n].float().norm()),
                                           1e-30)))
    return equal, worst


def gpt_recompute_phase(smi):
    """GPT-2 small (12 x 768, vocab 50257) at ``recompute_granularity``
    None, "selective" and "full" from one seed: 1 warm-up and 3 timed
    steps of 2 micro-batches of 8 x 1024 through ``fused_adam`` (#8):
    step ms, peak memory, what the first timed forward leaves allocated
    for its backward, and launches per step; the losses and the
    parameters after every step bit-equal to None's (else held at 1e-6
    relative in norm). Then hidden and attention dropout 0.1 (the
    CoreAttention path), 2 steps of one micro-batch at each granularity:
    gradients, losses (the second step's masks) and the generators'
    states after the steps equal to None's."""
    torch.cuda.empty_cache()
    runs, report = {}, {"gpu": smi, "model": "gpt2-small 12x768 vocab "
                        "50257 (random weights, bf16 compute, fp32 params)",
                        "micro_batch": RECOMPUTE["micro_batch"],
                        "seq_len": RECOMPUTE["seq_len"],
                        "num_micro": RECOMPUTE["num_micro"]}
    steps = RECOMPUTE["warmup"] + RECOMPUTE["steps"]
    for g in GRANULARITIES:
        runs[g] = _recompute_run(g, 0.0, steps, RECOMPUTE["num_micro"],
                                 keep_grads=True)
        torch.cuda.empty_cache()
    paths = {}
    tokens = RECOMPUTE["micro_batch"] * RECOMPUTE["seq_len"] * \
        RECOMPUTE["num_micro"]
    for g, out in runs.items():
        name = f"gpt_recompute_{g or 'none'}"
        paths[name] = out["launches"]
        timed = out["step_ms"][1:]
        row = {"losses": out["losses"], "step_ms": out["step_ms"],
               "step_ms_mean": statistics.mean(timed),
               "tokens_per_s": tokens / statistics.mean(timed) * 1e3,
               "peak_mem_gb": out["peak_mem_gb"],
               "mem_gb_after_forward": out["mem_gb_after_forward"],
               "peak_mem_gb_in_forward": out["peak_mem_gb_in_forward"],
               "launches_per_step": {k: v for k, v in
                                     out["launches_per_step"].items() if v}}
        if g is not None:
            equal, worst = _compare_runs(out, runs[None])
            row.update(bit_equal_to_none=equal, rel_in_norm_to_none=worst,
                       losses_equal=out["losses"] == runs[None]["losses"])
            if not equal and worst > 1e-6:
                raise AssertionError(f"recompute {g}: parameters or "
                                     f"gradients {worst} from None's")
        for k in PATH_KERNELS[name]:
            if out["launches"][k] == 0:
                raise AssertionError(f"{name}: {k} not launched")
        report[name] = row
        log(f"{name} ({smi}): " + json.dumps(row))
    del runs
    torch.cuda.empty_cache()
    drop = {}
    for g in GRANULARITIES:
        drop[g] = _recompute_run(g, 0.1, 2, 1, keep_grads=True)
        torch.cuda.empty_cache()
    paths["gpt_recompute_dropout"] = drop["full"]["launches"]
    for g in ("selective", "full"):
        equal, worst = _compare_runs(drop[g], drop[None])
        same_states = all(torch.equal(a, b) for a, b in zip(
            drop[g]["generator_states"], drop[None]["generator_states"]))
        row = {"losses": drop[g]["losses"],
               "losses_none": drop[None]["losses"],
               "bit_equal_to_none": equal, "rel_in_norm_to_none": worst,
               "generator_states_equal": same_states,
               "peak_mem_gb": drop[g]["peak_mem_gb"],
               "peak_mem_gb_none": drop[None]["peak_mem_gb"],
               "mem_gb_after_forward": drop[g]["mem_gb_after_forward"],
               "mem_gb_after_forward_none":
                   drop[None]["mem_gb_after_forward"]}
        log(f"gpt_recompute dropout 0.1 {g} against None: "
            + json.dumps(row))
        if not (same_states and drop[g]["losses"] == drop[None]["losses"]
                and (equal or worst <= 1e-6)):
            raise AssertionError(f"dropout recompute {g}: {row}")
        report[f"dropout_{g}"] = row
    for k in PATH_KERNELS["gpt_recompute_dropout"]:
        if paths["gpt_recompute_dropout"][k] == 0:
            raise AssertionError(f"gpt_recompute_dropout: {k} not launched")
    del drop
    torch.cuda.empty_cache()
    return paths, report


MOE = dict(num_moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_TRAIN = dict(micro_batch=8, seq_len=1024, warmup=1, steps=5, lr=3e-4)


def _moe_step(model, cfg, tokens):
    from apex_tpu_torch.models.gpt import gpt_loss_fn
    from apex_tpu_torch.transformer.moe import total_moe_aux_loss

    loss = gpt_loss_fn(model(tokens, labels=torch.roll(tokens, -1, 1)))
    aux = total_moe_aux_loss(model, cfg)
    (loss + aux).backward()
    return loss.detach(), aux.detach()


def gpt_moe_phase(smi):
    """GPT-2 small with 8 experts a layer (top-2, capacity factor 1.25),
    micro-batch 8 x 1024, 1 + 5 steps of the loss plus
    ``total_moe_aux_loss`` through ``fused_adam``: tokens/s, peak memory,
    each layer's share of dropped assignments; then at depth 2, fp32, 2 x
    256 tokens, the card against the CPU's plain path from the same
    weights: the loss and aux rtol 1e-5, each layer's dropped share
    equal, every gradient 1e-4 relative in norm."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.models import GPTModel, gpt2_small_config
    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.transformer.moe import MoEMLP

    torch.cuda.empty_cache()
    cfg = gpt2_small_config(**MOE)
    model = GPTModel(cfg, device="cuda", seed=SEED)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    tx = fused_adam(lr=MOE_TRAIN["lr"], weight_decay=0.01)
    state = tx.init(params)
    mb, seq = MOE_TRAIN["micro_batch"], MOE_TRAIN["seq_len"]
    steps = MOE_TRAIN["warmup"] + MOE_TRAIN["steps"]
    gen = torch.Generator().manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab_size, (steps, mb, seq),
                           generator=gen).cuda()
    losses, auxes, step_ms = [], [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        loss, aux = _moe_step(model, cfg, tokens[i])
        updates, state = tx.update({n: p.grad for n, p in params.items()},
                                   state, params)
        with torch.no_grad():
            for n, p in params.items():
                p.add_(updates[n])
        losses.append(float(loss))
        auxes.append(float(aux))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = _kernels.launch_counts()
    dropped = [float(m.dropped_share) for m in model.modules()
               if isinstance(m, MoEMLP)]
    timed = step_ms[1:]
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"gpt_moe losses {losses} aux {auxes}")
    for k in PATH_KERNELS["gpt_moe"]:
        if launches[k] == 0:
            raise AssertionError(f"gpt_moe: {k} not launched")
    report = {
        "gpu": smi, "model": "gpt2-small 12x768 vocab 50257, 8 experts "
        "top-2 cf 1.25 a layer (random weights, bf16 compute, fp32 params)",
        "parameters": n_params, "micro_batch": mb, "seq_len": seq,
        "steps": steps, "losses": losses, "aux_losses": auxes,
        "step_ms": step_ms, "step_ms_mean": statistics.mean(timed),
        "tokens_per_s": mb * seq / statistics.mean(timed) * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "dropped_share_by_layer_last_step": dropped,
        "launches_per_step": {k: n / (steps - 1)
                              for k, n in launches.items() if n}}
    log(f"gpt_moe ({smi}): " + json.dumps(report))
    del model, state, params, tokens
    torch.cuda.empty_cache()

    small = gpt2_small_config(num_layers=2, compute_dtype=torch.float32,
                              **MOE)
    toks = torch.randint(0, small.vocab_size, (2, 256),
                         generator=torch.Generator().manual_seed(SEED + 3))
    sides = {}
    for dev in ("cuda", "cpu"):
        m = GPTModel(small, device=dev, seed=SEED)
        if dev == "cpu":
            m.load_state_dict({n: t.cpu() for n, t in
                               sides["cuda"]["state"].items()})
        loss, aux = _moe_step(m, small, toks.to(dev))
        sides[dev] = dict(
            state={n: t.detach().clone() for n, t in m.state_dict().items()},
            loss=float(loss), aux=float(aux),
            dropped=[float(x.dropped_share) for x in m.modules()
                     if isinstance(x, MoEMLP)],
            grads={n: p.grad.detach().cpu() for n, p in
                   m.named_parameters()})
    card, cpu = sides["cuda"], sides["cpu"]
    worst = max(float((g - cpu["grads"][n]).norm()
                      / max(float(cpu["grads"][n].norm()), 1e-30))
                for n, g in card["grads"].items())
    result = {"loss_card": card["loss"], "loss_cpu": cpu["loss"],
              "aux_card": card["aux"], "aux_cpu": cpu["aux"],
              "dropped_card": card["dropped"], "dropped_cpu": cpu["dropped"],
              "grad_rel_in_norm_worst": worst}
    log("gpt_moe card vs plain (2 x 768, 8 experts top-2, fp32, 2 x 256 "
        "tokens; loss and aux 1e-5, dropped shares equal, gradients 1e-4 "
        "relative in norm): " + json.dumps(result))
    if (abs(card["loss"] - cpu["loss"]) > 1e-5 * abs(cpu["loss"])
            or abs(card["aux"] - cpu["aux"]) > 1e-5 * abs(cpu["aux"])
            or card["dropped"] != cpu["dropped"] or worst > 1e-4):
        raise AssertionError(f"gpt_moe card vs plain: {result}")
    report["card_vs_plain"] = result
    del sides
    torch.cuda.empty_cache()
    return launches, report


MOE_EP = dict(num_layers=2, hidden_size=768, num_attention_heads=12,
              vocab_size=50257, max_position_embeddings=1024,
              hidden_dropout=0.0, attention_dropout=0.0,
              compute_dtype=torch.float32, **MOE)


def gpt_moe_ep_phase(smi, ranks):
    """GPT-2 small's width at depth 2 (cut from 12: four processes share
    the card and every all-to-all is staged through the host) with 8
    experts split over dp = 4 ranks of this card over gloo (2 a rank),
    fp32, 4 x 1024 tokens a rank: one forward and backward, each rank
    held to ep = 1 with all 8 experts on its own tokens (the loss and aux
    1e-5, the final hidden states 1e-5 and every gradient 1e-4 relative
    in norm; an expert's summed over the ranks, as the all-to-all's
    backward sums it); the all-to-alls and bytes staged a rank."""
    for r, out in enumerate(ranks):
        if (abs(out["loss_ep"] - out["loss_one"]) > 1e-5 * out["loss_one"]
                or abs(out["aux_ep"] - out["aux_one"]) > 1e-5 * out["aux_one"]
                or out["hidden_rel"] > 1e-5
                or out["grad_rel_worst"][1] > 1e-4
                or out["staged_ep"]["collectives"] == 0):
            raise AssertionError(f"gpt_moe_ep rank {r}: {out}")
        for k in PATH_KERNELS["gpt_moe_ep"]:
            if out["launches_ep"][k] == 0:
                raise AssertionError(f"gpt_moe_ep rank {r}: {k} not "
                                     "launched")
    report = {"gpu": smi, "transport": GLOO_TRANSPORT,
              "ranks": [{k: v for k, v in out.items() if k != "launches_ep"}
                        for out in ranks]}
    log("gpt_moe_ep (2 x 768, 8 experts over dp 4, fp32, 4 x 1024 tokens a "
        "rank; ep 4 against ep 1 on each rank's tokens): "
        + json.dumps(report))
    return ranks[0]["launches_ep"], report


def spatial_bottleneck_phase(smi, ranks):
    """``contrib.SpatialBottleneck`` with H split over cp = 4 ranks of this
    card over gloo (``SPATIAL_CASES``): every rank's rows, forward and
    backward, against the unsharded ``Bottleneck`` on the whole input
    (``SPATIAL_TOL``), and the halo messages each rank staged."""
    for r, cases in enumerate(ranks):
        for case, out in zip(SPATIAL_CASES, cases):
            errs = dict(out=out["err_out"] / out["scale_out"],
                        dx=out["err_dx"] / out["scale_dx"],
                        params=out["err_params"], stats=out["err_stats"])
            bad = [k for k, v in errs.items() if not v <= SPATIAL_TOL[k]]
            if bad or out["staged"]["p2p"] == 0:
                raise AssertionError(f"spatial_bottleneck rank {r} {case}: "
                                     f"{errs}, staged {out['staged']}")
    report = {"gpu": smi, "transport": GLOO_TRANSPORT, "ranks": [
        [{k: out[k] for k in ("err_out", "scale_out", "err_dx", "scale_dx",
                              "err_params", "err_stats", "staged")}
         for out in cases] for cases in ranks]}
    log("spatial_bottleneck (cp = 4, fp32, against the unsharded block): "
        + json.dumps(report))
    return report


FP8_SHAPES = dict(x=(8192, 768), w=(768, 3072))
# card against CPU, relative in norm: the output, fp32 products summed in
# another order; the gradients pass the e4m3 cast, where a product that
# rounds otherwise lands a few elements across an e4m3 rounding midpoint,
# each one e4m3 step (up to 2^-3 relative) apart
FP8_TOL = {"y": 1e-5, "grad_x": 1e-3, "grad_w": 1e-3}


def fp8_phase(smi):
    """``amp.fp8`` on the card at GPT-2's MLP shapes (x 8192 x 768, w 768 x
    3072): ``quantize`` bit-equal to the CPU's in both formats; the QDQ
    ``fp8_dense`` (fp32 compute) forward, returned states and gradients
    against the CPU's (states equal, the rest ``FP8_TOL`` relative in
    norm);
    the times of the QDQ dense (fp32 and bf16 compute), a bf16
    ``torch.matmul`` and ``torch._scaled_mm`` on the same fp8 operands
    (timed only: a library row, not on the path); then the FP8 example's
    60 steps on the card: the loss falls, its qerr."""
    from apex_tpu_torch import _kernels
    from apex_tpu_torch.amp import fp8
    from apex_tpu_torch.examples.fp8 import train_fp8_mlp

    _kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(SEED + 4)
    x = torch.randn(*FP8_SHAPES["x"], generator=gen) * 3.0
    w = torch.randn(*FP8_SHAPES["w"], generator=gen) / math.sqrt(768)
    report = {"gpu": smi, "shapes": FP8_SHAPES}
    for fmt in ("e4m3", "e5m2"):
        for name, t in (("x", x), ("w", w)):
            scale = torch.tensor(fp8.FP8_MAX[fmt]) / t.abs().max()
            card = fp8.quantize(t.cuda(), scale.cuda(), fmt)
            cpu = fp8.quantize(t, scale, fmt)
            if not torch.equal(card.view(torch.uint8).cpu(),
                               cpu.view(torch.uint8)):
                raise AssertionError(f"fp8 quantize {fmt} {name}: card and "
                                     "CPU bits differ")
    report["quantize_bit_equal"] = True
    states = {}
    for dev in ("cuda", "cpu"):
        sx = fp8.update_fp8_state(fp8.init_fp8_state(8, dev),
                                  float(x.abs().max()))
        sw = fp8.update_fp8_state(fp8.init_fp8_state(8, dev),
                                  float(w.abs().max()))
        xt = x.to(dev, copy=True).requires_grad_()
        wt = w.to(dev, copy=True).requires_grad_()
        y, (nsx, nsw) = fp8.fp8_dense(xt, wt, sx, sw)
        dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(
            SEED + 5)).to(dev)
        gx, gw = torch.autograd.grad(y, [xt, wt], dy)
        states[dev] = [t.detach().cpu() for t in (y, gx, gw)] + [
            nsx.amax_history.cpu(), nsx.scale.cpu(), nsw.scale.cpu()]
    errs = {}
    for i, name in enumerate(("y", "grad_x", "grad_w")):
        a, b = states["cuda"][i], states["cpu"][i]
        errs[name] = float((a - b).norm() / b.norm())
    if any(errs[k] > FP8_TOL[k] for k in errs) or not all(
            torch.equal(a, b) for a, b in zip(states["cuda"][3:],
                                               states["cpu"][3:])):
        raise AssertionError(f"fp8_dense card vs CPU: {errs}")
    report["fp8_dense_card_vs_cpu_rel_in_norm"] = errs

    xc, wc = x.cuda(), w.cuda()
    sx = fp8.update_fp8_state(fp8.init_fp8_state(8, "cuda"),
                              float(x.abs().max()))
    sw = fp8.update_fp8_state(fp8.init_fp8_state(8, "cuda"),
                              float(w.abs().max()))
    qx, qw = fp8.quantize(xc, sx.scale), fp8.quantize(wc, sw.scale)
    qw_cols = qw.t().contiguous().t()  # column-major, as _scaled_mm wants
    xb, wb = xc.bfloat16(), wc.bfloat16()
    inv_x, inv_w = 1.0 / sx.scale, 1.0 / sw.scale
    m, k = FP8_SHAPES["x"]
    n = FP8_SHAPES["w"][1]
    flops = 2 * m * k * n
    timings = {
        "qdq_dense_fp32_ms": time_ms(lambda: fp8.fp8_dense(xc, wc, sx, sw)),
        "qdq_dense_bf16_ms": time_ms(lambda: fp8.fp8_dense(
            xc, wc, sx, sw, compute_dtype=torch.bfloat16)),
        "matmul_bf16_ms": time_ms(lambda: torch.matmul(xb, wb)),
        "scaled_mm_fp8_ms": time_ms(lambda: torch._scaled_mm(
            qx, qw_cols, scale_a=inv_x, scale_b=inv_w,
            out_dtype=torch.bfloat16)),
        "bound_bf16_ms": bound((m * k + k * n + m * n) * 2, flops,
                               BF16_FLOPS)[0],
        "bound_fp8_ms": bound(m * k + k * n + m * n * 2, flops,
                              2 * BF16_FLOPS)[0]}
    report["timings"] = timings
    lines = []
    records = train_fp8_mlp.train(train_fp8_mlp.parse_args([]),
                                  log=lines.append)
    report["example"] = {
        "demo": lines[0], "steps": len(records),
        "loss_first": records[0]["loss"], "loss_last": records[-1]["loss"],
        "qerr_first": records[0]["qerr"], "qerr_last": records[-1]["qerr"],
        "qerr_max": max(r["qerr"] for r in records)}
    log(f"fp8 ({smi}): " + json.dumps(report))
    return _kernels.launch_counts(), report


# GPT-2 small's width at depth 2, one layer a stage (cut from 12 to keep
# the whole script near 1,000 s)
PIPELINE_REMAT_ARGV = tuple(
    "2" if i and GPT_PIPELINE_ARGV[i - 1] == "--num-layers" else a
    for i, a in enumerate(GPT_PIPELINE_ARGV) if a != "--bf16") + (
    "--pipeline-model-parallel-size", "2", "--tensor-model-parallel-size",
    "2", "--sequence-parallel", "--train-iters", "2")


def gpt_pipeline_remat_phase(smi, world):
    """GPT-2 small's width at depth 2 at pp = 2 x tp = 2 with SP (1F1B, 4
    ranks over gloo), ``remat`` True and then False from the same
    weights, 2 steps each, in
    fp32 (every loss and gradient bit-equal) and in bf16 (the memory of
    the path's own precision): each run's peak memory a rank, launches
    and staged bytes a step (``world``: :func:`gloo_world`'s
    results)."""
    ranks = list(zip(world["remat_fp32"], world["remat_bf16"]))
    report = {"gpu": smi, "transport": GLOO_TRANSPORT}
    for i, precision in enumerate(("fp32", "bf16")):
        outs = [r[i] for r in ranks]
        if precision == "fp32" and not all(o["bit_equal"] for o in outs):
            raise AssertionError("gpt_pipeline remat True vs False at fp32: "
                                 + json.dumps([o["max_abs_diff"]
                                               for o in outs]))
        report[precision] = {
            "bit_equal_by_rank": [o["bit_equal"] for o in outs],
            "max_abs_diff_by_rank": [o["max_abs_diff"] for o in outs],
            **{f"remat_{flag}": {
                "peak_mem_gb_by_rank": [o[f"remat_{flag}"]["peak_mem_gb"]
                                        for o in outs],
                "losses": outs[0][f"remat_{flag}"]["losses"],
                "launches_per_step_rank0":
                    outs[0][f"remat_{flag}"]["launches_per_step"],
                "launches_per_step_last_stage":
                    outs[-1][f"remat_{flag}"]["launches_per_step"],
                "staged_per_step_rank0":
                    outs[0][f"remat_{flag}"]["staged_per_step"]}
               for flag in (True, False)}}
    log("gpt_pipeline remat True against False (pp 2 x tp 2 sp, 2 x 768, "
        "4 x 1024, M = 4; fp32 bit-equal): " + json.dumps(report))
    return ranks[0][1]["remat_False"]["launches"], report


# -- the multi-GPU tail -----------------------------------------------------
#
# Its 4-rank checks run as jobs of one spawned world and its 2-rank checks
# as jobs of another, so the phase pays the processes' start twice
# (``distributed_test_base.jobs_worker``); each job resets the launch
# counts before its path and reads them after it.

# GPT-2 small at tp = 2 x dp = 2 with SP through the training target (the
# example's step) at full width, 1 + 2 steps a run: the exact ZeRO and DDP
# runs and their int8 (ZeRO with the layer-RMS taps) and fp8 (ZeRO)
# compressed twins, from one draw of the weights
# depth 4 (cut from 12) and 1 + 1 steps, to keep the whole script under
# its time limit on a slow host
COMPRESS_TARGET = dict(vocab=GPT_PARALLEL_VOCAB, seq_len=1024, layers=4,
                       hidden=768, heads=12, tp=2, micro_batch=4,
                       global_batch=16, seed=SEED, sequence_parallel=True)
COMPRESS_STEPS = 2
COMPRESS_RUNS = {
    "exact zero": dict(zero=True),
    "int8 zero": dict(zero=True, compression="int8", collect_layer_rms=True),
    "fp8 zero": dict(zero=True, compression="fp8"),
    "exact ddp": dict(zero=False),
    "int8 ddp": dict(zero=False, compression="int8"),
}
# the compressed runs' paths and the exact run each is held to
COMPRESS_PATHS = {"int8 zero": ("gpt_compress_zero", "exact zero"),
                  "fp8 zero": (None, "exact zero"),
                  "int8 ddp": ("gpt_compress_ddp", "exact ddp")}
FLAT_CHUNK = 2048 * 32  # ops.multi_tensor.CHUNK_SIZE: flat buffers pad to it


def _blocks(n, block=128):
    return max(1, -(-n // block))


def staged_scatter_bytes(padded, n, item, block=128):
    """What ``quantized_psum_scatter`` of a ``padded``-element buffer over
    n ranks stages through the host on one rank: two all-to-alls, the
    (n, chunk) payload and the (n, nb) fp32 scales, each copied in and
    out."""
    chunk = padded // n
    return 2 * (n * chunk * item + n * _blocks(chunk, block) * 4)


def staged_psum_bytes(size, n, item, block=128):
    """What ``quantized_psum`` of one ``size``-element leaf stages on one
    rank: phase 1's two all-to-alls, and phase 2's two all-gathers (one
    chunk in, n out)."""
    chunk = -(-size // n)
    nb = _blocks(chunk, block)
    return 2 * (n * chunk * item + n * nb * 4) + (n + 1) * (chunk * item
                                                            + nb * 4)


def predicted_dp_staged(numels, dp, zero, compression):
    """Bytes the data-parallel gradient sync stages a step on one rank:
    the exact reduce-scatter of the flat fp32 buffer (in, and its shard
    out) or in-place all-reduce (in and out), or the quantized ones (the
    payload's itemsize is 1 in int8 and fp8); and its collectives."""
    total = sum(numels)
    padded = -(-total // FLAT_CHUNK) * FLAT_CHUNK
    padded = -(-padded // dp) * dp
    if compression is None:
        return ((padded * 4 + padded // dp * 4, 1) if zero
                else (2 * padded * 4, 1))
    if zero:
        return staged_scatter_bytes(padded, dp, 1), 2
    # a leaf under min_elements (16) takes the exact in-place all-reduce
    return (sum(staged_psum_bytes(n, dp, 1) if n >= 16 else 2 * 4 * n
                for n in numels),
            sum(4 if n >= 16 else 1 for n in numels))


def compress_batches(target, steps):
    """``steps`` batches of the synthetic stream (the example's) in the
    step's (num_micro, micro_batch x dp, seq) layout, at dp = 2."""
    seq, gb = target["seq_len"], target["global_batch"]
    shape = (gb // (target["micro_batch"] * 2), target["micro_batch"] * 2,
             seq)
    lm = token_file_lm(target["vocab"], seq)
    return [tuple(a.reshape(shape) for a in lm.batch(range(gb * i,
                                                           gb * (i + 1))))
            + (0.0,) for i in range(steps)]


def gpt_compress_phase(smi, full, small):
    """``full``: the ranks' ``compress_runs_worker`` results at GPT-2
    small's width at depth 4 (``COMPRESS_RUNS``): finite losses, every
    verdict ok, the first loss equal to the exact run's (the same weights
    and batch), a positive finite layer RMS value a layer every step;
    step ms, peak memory a rank, the collective-traffic ledger's bytes a
    step by axis (tp and dp) and the collectives and bytes staged a
    step a rank beside the
    exact run's, whose difference must be the predicted difference of the
    data-parallel sync (and the RMS vector's two all-reduces) alone, byte
    for byte: the rest of the step stages the same. ``small``: card
    against plain (:func:`compress_card_vs_plain`)."""
    from apex_tpu_torch.resilience import VERDICT_OK

    out, paths = full[0], {}
    report = {"transport": GLOO_TRANSPORT, "gpu": smi,
              "model": f"gpt2-small {COMPRESS_TARGET['layers']}x768 vocab "
                       f"{GPT_PARALLEL_VOCAB} "
                       "(random weights, bf16 compute, fp32 params), "
                       "tp=2 dp=2 sp, build_gpt_training"}
    for name, (path, ref) in COMPRESS_PATHS.items():
        run, base = out[(name, "card")], out[(ref, "card")]
        extra = COMPRESS_RUNS[name]
        zero = extra["zero"]
        kernels = PATH_KERNELS["gpt_compress_zero" if zero
                               else "gpt_compress_ddp"]
        losses = run["losses"]
        if (any(run["launches"][k] == 0 for k in kernels)
                or not all(math.isfinite(x) for x in losses)
                or any(v != VERDICT_OK for v in run["verdicts"])
                or losses[0] != base["losses"][0]):
            raise AssertionError(f"{name}: {run} vs {base['losses']}")
        rms_bytes, rms_coll = 0, 0
        if extra.get("collect_layer_rms"):
            depth = COMPRESS_TARGET["layers"]
            for rms in run["layer_rms"]:
                if len(rms) != depth or not all(math.isfinite(v) and v > 0
                                                for v in rms):
                    raise AssertionError(f"{name}: layer rms {rms}")
            # the RMS vector's two all-reduces (the mean over tp, then
            # dp) of one fp32 value a layer, each staged in and out
            rms_bytes, rms_coll = 2 * 2 * depth * 4, 2
        pred_exact, coll_exact = predicted_dp_staged(run["numels"], 2, zero,
                                                     None)
        pred, coll = predicted_dp_staged(run["numels"], 2, zero,
                                         extra["compression"])
        saved = base["staged"]["bytes"] - run["staged"]["bytes"] + rms_bytes
        more = (run["staged"]["collectives"] - base["staged"]["collectives"]
                - rms_coll)
        if (abs(saved - (pred_exact - pred)) > 0.5
                or abs(more - (coll - coll_exact)) > 1e-9):
            raise AssertionError(
                f"{name}: staged {run['staged']} vs exact {base['staged']}: "
                f"the dp sync saved {saved} bytes a step, predicted "
                f"{pred_exact - pred}; {more} more collectives, predicted "
                f"{coll - coll_exact}")
        report[name] = {
            "steps": COMPRESS_STEPS - 1, "losses": losses,
            "exact_losses": base["losses"],
            "step_ms_mean": statistics.mean(run["step_ms"][1:]),
            "exact_step_ms_mean": statistics.mean(base["step_ms"][1:]),
            "peak_mem_gb_by_rank": [r[(name, "card")]["peak_mem_gb"]
                                    for r in full],
            "exact_peak_mem_gb_by_rank": [r[(ref, "card")]["peak_mem_gb"]
                                          for r in full],
            "staged_per_step_rank0": run["staged"],
            "exact_staged_per_step_rank0": base["staged"],
            # the collective-traffic ledger's logical payload a step by
            # axis (JAX's conventions), beside the gloo transport's staged
            # host copies above
            "comms_per_step_rank0": run["comms"],
            "exact_comms_per_step_rank0": base["comms"],
            "dp_sync_staged_bytes": {"predicted": pred,
                                     "exact_predicted": pred_exact,
                                     "saved_measured": saved},
            "dp_sync_collectives": {"compressed": coll, "exact": coll_exact},
            "layer_rms_last": run["layer_rms"][-1],
            "launches_rank0": run["launches"]}
        if set(run["comms"]) != {"tp", "dp"} or set(base["comms"]) != {
                "tp", "dp"}:
            raise AssertionError(f"{name}: the ledger's axes "
                                 f"{run['comms']}, exact {base['comms']}")
        log(f"gpt_compress {name} " + json.dumps(report[name]))
        if path is not None:
            paths[path] = run["launches"]
    report["card_vs_plain"] = compress_card_vs_plain(small)
    return paths, report


COMPRESS_CARD_VS_PLAIN = {
    "exact": dict(),
    "zero int8": dict(compression="int8", plain=True),
    "ddp int8": dict(zero=False, compression="int8", plain=True),
}
# compressed against exact losses on the card, relative: quantization
# error through Adam's first step (measured in the log)
COMPRESS_VS_EXACT_RTOL = 1e-2


def compress_card_vs_plain(ranks):
    """``ranks``: ``compress_runs_worker``'s results at CARD_VS_PLAIN's
    size (2 layers of GPT-2 small, seq 256, tp = 2 x dp = 2 with SP,
    bf16, 2 steps): the exact ZeRO step, and the int8 ZeRO and DDP steps
    on the card and on the CPU from the same weights: each compressed run
    card against plain at ``test_torch_training.py``'s tolerances
    (verdicts equal, losses 2e-3 relative, parameters 2e-3 absolute), and
    against the exact run on the card (the first loss equal, the rest
    ``COMPRESS_VS_EXACT_RTOL``)."""
    worst = {"loss": 0.0, "param": 0.0, "vs_exact": 0.0}
    for r, out in enumerate(ranks):
        exact = out[("exact", "card")]["losses"]
        for name in ("zero int8", "ddp int8"):
            card, plain = out[(name, "card")], out[(name, "plain")]
            if card["verdicts"] != plain["verdicts"]:
                raise AssertionError(f"rank {r} {name}: verdicts")
            for a, b in zip(card["losses"], plain["losses"]):
                worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
            for n, want in plain["params"].items():
                worst["param"] = max(worst["param"], float(
                    np.abs(card["params"][n] - want).max()))
            if card["losses"][0] != exact[0]:
                raise AssertionError(f"rank {r} {name}: first loss "
                                     f"{card['losses'][0]} vs {exact[0]}")
            for a, b in zip(card["losses"], exact):
                worst["vs_exact"] = max(worst["vs_exact"],
                                        abs(a - b) / abs(b))
            kernels = PATH_KERNELS["gpt_compress_zero" if "zero" in name
                                   else "gpt_compress_ddp"]
            if any(card["launches"][k] == 0 for k in kernels):
                raise AssertionError(f"rank {r} {name}: {card['launches']}")
    result = {"ranks": len(ranks), **worst,
              "losses_rank0": {f"{k[0]} {k[1]}": v["losses"]
                               for k, v in ranks[0].items()}}
    log("gpt_compress card vs plain (2 x 768, seq 256, 4 ranks, bf16, 2 "
        "steps; card vs plain losses 2e-3, params 2e-3, compressed vs "
        f"exact {COMPRESS_VS_EXACT_RTOL}): " + json.dumps(result))
    if (worst["loss"] > 2e-3 or worst["param"] > 2e-3
            or worst["vs_exact"] > COMPRESS_VS_EXACT_RTOL):
        raise AssertionError(f"gpt_compress card vs plain: {result}")
    return result


BERT_TP_ARGV = (
    "--num-layers 24 --hidden-size 1024 --num-attention-heads 16 "
    "--seq-length 512 --max-position-embeddings 512 "
    f"--make-vocab-size-divisible-by {BERT_VOCAB} --micro-batch-size 4 "
    "--global-batch-size 16 --lr 1e-4 --bf16 --train-iters 3 "
    "--tensor-model-parallel-size 2 --sequence-parallel").split()
N_BERT_345M = 336_267_266  # parameters of Megatron BERT-345M (binary head)
BERT_TP_CARD_VS_PLAIN = (
    "--num-layers 2 --hidden-size 1024 --num-attention-heads 16 "
    "--seq-length 512 --max-position-embeddings 512 "
    f"--make-vocab-size-divisible-by {BERT_VOCAB} --micro-batch-size 2 "
    "--global-batch-size 4 --lr 1e-4 --train-iters 1 "
    "--tensor-model-parallel-size 2 --sequence-parallel").split()


def bert_tp_phase(smi, summary, small):
    """``summary``: ``standalone_bert``'s run (``train``, as its ``main``
    runs it) of Megatron BERT-345M at tp = 2 x dp = 2 with SP, micro-batch
    4, global 16, 1 + 2 steps: the first loss within 1.0 of ln 30592,
    every rank's first-step gradients finite, the tp shards adding up to
    336,267,266 elements in 301 tensors a rank; step ms, peak memory and
    staged bytes a rank. ``small``: 2 layers at full width in fp32, one
    step card against plain (the loss 1e-4 relative, the gradients 1e-4
    relative in norm)."""
    losses = summary["losses"]
    counts = summary["launch_counts_rank0"]
    missing = [k for k in PATH_KERNELS["bert_tp"] if counts[k] == 0]
    if (missing or not summary["finite_grads_every_rank"]
            or summary["elements_over_tp"] != N_BERT_345M
            or summary["tensors_a_rank"] != 301
            or (summary["tp"], summary["dp"],
                summary["sequence_parallel"]) != (2, 2, True)
            or abs(losses[0] - math.log(BERT_VOCAB)) > 1.0
            or not all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"bert_tp: {summary} {missing}")
    steps = summary["steps"]
    report = {
        "model": "Megatron BERT-345M 24x1024 vocab 30592 (random weights, "
                 "bf16 compute, fp32 params), standalone_bert tp=2 dp=2 sp",
        "gpu": smi, "transport": GLOO_TRANSPORT, "losses": losses,
        "step_ms": summary["step_ms"],
        "step_ms_mean_after_first": summary["step_ms_mean_after_first"],
        "tokens_per_s": summary["tokens_per_s"],
        "peak_mem_gb_by_rank": summary["peak_mem_gb_by_rank"],
        "staged_per_step_rank0": {k: v / steps for k, v in
                                  summary["staged_rank0"].items()},
        "launches_per_step_rank0": {k: v / steps for k, v in counts.items()},
        "elements_over_tp": summary["elements_over_tp"]}
    log("bert_tp " + json.dumps(report))
    worst = {"loss": 0.0, "grad": 0.0}
    for r, out in enumerate(small):
        for a, b in zip(out["card"], out["plain"]):
            worst["loss"] = max(worst["loss"], abs(a - b) / abs(b))
        worst["grad"] = max(worst["grad"], out["grad_rel_worst"])
        if any(out["launches"][k] == 0 for k in PATH_KERNELS["bert_tp"]):
            raise AssertionError(f"bert_tp card vs plain rank {r}: "
                                 f"{out['launches']}")
    report["card_vs_plain"] = dict(worst, losses_rank0=small[0]["card"])
    log("bert_tp card vs plain (2 x 1024, seq 512, fp32, 4 ranks, 1 step; "
        "loss and gradients 1e-4): " + json.dumps(report["card_vs_plain"]))
    if worst["loss"] > 1e-4 or worst["grad"] > 1e-4:
        raise AssertionError(f"bert_tp card vs plain: {worst}")
    return counts, report


GPT2_TP_DECODE = dict(num_layers=12, hidden_size=768, num_attention_heads=12,
                      vocab_size=GPT_PARALLEL_VOCAB,
                      max_position_embeddings=1024, layernorm_epsilon=1e-5,
                      hidden_dropout=0.0, attention_dropout=0.0)
DECODE_TP = dict(lanes=8, prompt=128, steps=32, slots=256)
# bf16 on the card: each decode step's logits against the full forward's,
# absolute, of logits whose largest |value| is logged beside; the prefill
# and the split decode kernel round their bf16 outputs at other points
# than the full forward's flash prefill (flash_fwd's bf16 tolerance is
# 2e-2 relative)
DECODE_TP_BF16_ATOL = 5e-2
# fp32 on the CPU (plain versions), 2 layers: JAX's bound (2e-5) at this
# width's sums
DECODE_TP_FP32_ATOL = 1e-4
DECODE_CASES = ("tp", "tp_sp", "plain_fp32_tp", "plain_fp32_tp_sp")


def decode_jobs():
    """The 2-rank world's decode jobs, in ``DECODE_CASES``' order: GPT-2
    small at tp = 2 from a seed, without and with SP, bf16 on the card,
    then at 2 layers fp32 on the CPU; 8 prompts of 128 tokens into a
    256-slot cache and 32 teacher-forced decode steps."""
    rs = np.random.RandomState(SEED)
    total = DECODE_TP["prompt"] + DECODE_TP["steps"]
    tokens = rs.randint(0, GPT2_TP_DECODE["vocab_size"],
                        (DECODE_TP["lanes"], total))
    jobs = []
    for dev, layers, dtype in (("cuda", 12, torch.bfloat16),
                               ("cpu", 2, torch.float32)):
        for sp in (False, True):
            cfg = dict(GPT2_TP_DECODE, num_layers=layers,
                       sequence_parallel=sp, compute_dtype=dtype)
            jobs.append((f"{TP_WORKERS}:decode_tp_worker", (
                2, cfg, None, tokens, DECODE_TP["prompt"],
                DECODE_TP["slots"], dev, SEED, False)))
    return jobs


def gpt_tp_decode_phase(smi, ranks):
    """``ranks``: the 2-rank world's results of :func:`decode_jobs`: each
    step's logits (this rank's vocab shard) against the full forward's at
    that position, bf16 on the card (``DECODE_TP_BF16_ATOL``), and at 2
    layers in fp32 on the CPU's plain versions (``DECODE_TP_FP32_ATOL``);
    each rank caches its 6 of 12 heads; #1 and #5 launch in the prefill,
    #5 again in the decode steps as the split-KV kernel."""
    report = {"gpu": smi, "transport": GLOO_TRANSPORT}
    for i, name in enumerate(DECODE_CASES):
        outs = [r[i] for r in ranks]
        tol = DECODE_TP_FP32_ATOL if "plain" in name else DECODE_TP_BF16_ATOL
        worst = max(o["worst"] for o in outs)
        report[name] = {
            "worst_abs": worst, "atol": tol,
            "logit_max": max(o["logit_max"] for o in outs),
            "prefill_ms": outs[0]["prefill_ms"],
            "step_ms": outs[0]["step_ms"],
            "decode_splits": outs[0]["decode_splits"],
            "cache_heads": outs[0]["cache_heads"],
            "launches_prefill_rank0": outs[0]["launches_prefill"],
            "launches_decode_rank0": outs[0]["launches_decode"]}
        if worst > tol or outs[0]["cache_heads"] != 6:
            raise AssertionError(f"gpt_tp_decode {name}: {report[name]}")
        if "plain" not in name and (
                outs[0]["launches_decode"]["flash_fwd"] == 0
                or outs[0]["decode_splits"] < 2
                or any(outs[0]["launches_prefill"][k] == 0
                       for k in PATH_KERNELS["gpt_tp_decode"])):
            raise AssertionError(f"gpt_tp_decode {name}: {report[name]}")
    log("gpt_tp_decode (GPT-2 small tp=2, 8 x 128 prompt, 32 steps, 256 "
        "slots): " + json.dumps(report))
    first = ranks[0][0]
    counts = {k: first["launches_prefill"][k] + first["launches_decode"][k]
              for k in first["launches_prefill"]}
    return counts, report


def bert_345m_shapes():
    """Megatron BERT-345M's 301 parameters by name and shape (read off a
    one-layer build at full width on the CPU, its layer repeated 24
    times), so a flat buffer of them has the model's layout."""
    from apex_tpu_torch.models import BertModel, megatron_bert_345m_config

    one = BertModel(megatron_bert_345m_config(num_layers=1), device="cpu")
    shapes = {}
    for name, p in one.named_parameters():
        if name.startswith("transformer.layer_0."):
            for i in range(24):
                shapes[name.replace("layer_0", f"layer_{i}")] = tuple(p.shape)
        else:
            shapes[name] = tuple(p.shape)
    return shapes


ZERO_RANKS = 4
ZERO_STEPS = 1


def zero_lamb_remainders_phase(smi, ranks):
    """``ranks``: ``zero_bytes_worker`` over BERT-345M's 301 parameter
    shapes at dp = 4, gradients drawn on the card: ``distributed_fused_lamb``
    exact and int8 (#9 launches; the staged bytes a step differ by the
    predicted difference of the reduce-scatter alone), and
    ``distributed_fused_adam(store_param_remainders=True)`` over the same
    values in bf16 against the fp32 run: the master rebuilt from (bf16
    params, remainder) equal to the fp32 run's bit for bit, each bf16
    parameter its master's truncated high half, and the state's master
    half the fp32 run's bytes."""
    padded = ranks[0]["shard_len"] * ZERO_RANKS
    pred_exact = padded * 4 + padded // ZERO_RANKS * 4
    pred_int8 = staged_scatter_bytes(padded, ZERO_RANKS, 1)
    for r, out in enumerate(ranks):
        saved = (out["lamb_exact"]["staged"]["bytes"]
                 - out["lamb_int8"]["staged"]["bytes"])
        if (not out["master_bits_equal"] or not out["params_are_high_halves"]
                or 2 * out["master_bytes"]["remainders"]
                != out["master_bytes"]["fp32"]
                or out["n_params"] != N_BERT_345M
                or out["lamb_exact"]["launches"]["sumsq_flat"] == 0
                or out["lamb_int8"]["launches"]["sumsq_flat"] == 0
                or abs(saved - (pred_exact - pred_int8)) > 0.5):
            raise AssertionError(f"zero_lamb_remainders rank {r}: {out}")
    out = ranks[0]
    report = {"gpu": smi, "transport": GLOO_TRANSPORT, "dp": ZERO_RANKS,
              "steps": ZERO_STEPS, "shard_len": out["shard_len"],
              "lamb_dp_staged_bytes_predicted": {"exact": pred_exact,
                                                 "int8": pred_int8},
              **{k: out[k] for k in (
                  "lamb_exact", "lamb_int8", "adam_remainders", "adam_fp32",
                  "lamb_int8_vs_exact_max_abs", "master_bytes",
                  "master_bits_equal", "n_params")}}
    log("zero_lamb_remainders (BERT-345M's 301 shapes, dp 4): "
        + json.dumps(report))
    return out["lamb_exact"]["launches"], report


MOE_TP = dict(num_layers=2, hidden_size=768, num_attention_heads=12,
              vocab_size=GPT_PARALLEL_VOCAB, max_position_embeddings=1024,
              hidden_dropout=0.0, attention_dropout=0.0,
              compute_dtype=torch.float32, **MOE)


def gpt_moe_tp_phase(smi, ranks):
    """``ranks``: ``moe_tp_card_worker``'s results: GPT-2 small's width at
    depth 2 (cut from 12, as ``gpt_moe_ep``: two processes share the
    card) with 8 experts (top-2, cf 1.25) at tp = 2, fp32, 4 x 1024
    tokens, one forward and backward of the loss plus the aux: without SP
    against tp = 1 from the same weights (loss and aux 1e-5 relative,
    every gradient 1e-4 relative in norm); with SP (each rank routes its
    own sequence shard) on the card, and at 4 x 128 tokens against the
    CPU's plain versions (loss 1e-5, gradients 1e-4)."""
    for r, out in enumerate(ranks):
        if (abs(out["loss_tp2"] - out["loss_one"]) > 1e-5 * out["loss_one"]
                or abs(out["aux_tp2"] - out["aux_one"]) > 1e-5 * out["aux_one"]
                or out["grad_rel_tp2"] > 1e-4
                or abs(out["loss_sp_small_card"] - out["loss_sp_small_plain"])
                > 1e-5 * out["loss_sp_small_plain"]
                or out["grad_rel_sp_small"] > 1e-4
                or not math.isfinite(out["loss_sp"])
                or any(out["launches_sp"][k] == 0
                       for k in PATH_KERNELS["gpt_moe_tp"])):
            raise AssertionError(f"gpt_moe_tp rank {r}: {out}")
    report = {"gpu": smi, "transport": GLOO_TRANSPORT,
              "ranks": [{k: v for k, v in out.items()
                         if not k.startswith("launches")} for out in ranks]}
    log("gpt_moe_tp (2 x 768, 8 experts, tp 2, fp32, 4 x 1024 tokens; tp 2 "
        "against tp 1, SP card against plain at 4 x 128): "
        + json.dumps(report))
    return ranks[0]["launches_sp"], report


TESTING = "apex_tpu_torch.transformer.testing"
TP_WORKERS = f"{TESTING}.tp_workers"
ELASTIC_WORKERS = f"{TESTING}.elastic_workers"
#: the elastic path: GPT-2 small's width at depth 2, ZeRO-2, bf16 compute
#: with fp32 params, micro batch 4 x seq 1024, global batch 16, seed 0
ELASTIC_CFG = dict(vocab=50257, seq_len=1024, layers=2, hidden=768,
                   heads=12, micro_batch=4, global_batch=16, zero=True,
                   seed=SEED)
#: the trip's steps: at dp 4, then at dp 2 on ranks {0, 1}, then dp 4
ELASTIC_STEPS = (3, 2, 2)
#: the remediation selftest's sequences on the card: steps a sequence
#: (5: anchors at 2 and 4), the bit flip's step, the probation's clean
#: steps, and the segments the false-positive clear replays
REMEDIATION_CARD = dict(steps=5, flip_step=3, probation=2,
                        clear_segments=1)
#: the trip's losses after the round trip against the uninterrupted dp-4
#: run's, absolute: the dp-2 leg sums its two micro-batches in another
#: order, which moved them 9.5e-7 (PERF.md), while the run's loss falls
#: about 1.25e-2 a step, so a lost update lands far outside
ELASTIC_LOSS_TOL = 1e-4
#: the state after the trip against the uninterrupted run's, leaf by
#: leaf: |trip - uninterrupted| over |uninterrupted - first save|, how far
#: the same steps moved the leaf. A lost step of the four moves it about
#: a quarter; the sound trip's worst was Adam's first moment, 2.75e-3
#: (PERF.md has the readings)
ELASTIC_STATE_TOL = 1e-2


def elastic_jobs(tmp):
    """The ``gpt_elastic`` phase's jobs for the world of 4: the elastic
    trip and the remediation selftest's SDC and false-positive cases."""
    import os

    return [
        (f"{ELASTIC_WORKERS}:elastic_trip_worker",
         (ELASTIC_CFG, os.path.join(tmp, "trip"), "cuda", ELASTIC_STEPS)),
        (f"{ELASTIC_WORKERS}:remediation_worker",
         (os.path.join(tmp, "remediation"), "cuda",
          {k: v for k, v in ELASTIC_CFG.items() if k != "seed"},
          REMEDIATION_CARD["steps"], REMEDIATION_CARD["flip_step"],
          REMEDIATION_CARD["probation"],
          REMEDIATION_CARD["clear_segments"])),
    ]


def trip_against_uninterrupted(smi, out):
    """Holds the elastic trip (rank 0's :func:`elastic_trip_worker`
    result) to the uninterrupted dp-4 run: its losses to
    ``ELASTIC_LOSS_TOL``, and every leaf of its state to
    ``ELASTIC_STATE_TOL`` of how far the uninterrupted steps moved the
    leaf. Logs and returns the readings."""
    ref = out["losses"]["reference"]
    trip_losses = out["losses"]["sub"] + out["losses"]["back"]
    worst = max(abs(a - b) for a, b in zip(trip_losses, ref))
    # each leaf's distance from the uninterrupted run over how far those
    # steps moved it (both are over |uninterrupted|); the key bias moves by
    # rounding noise (elastic_workers._rel_diffs): printed, not bounded
    diff, moved = out["state_rel_diff"], out["state_moved"]
    ratio = {k: 0.0 if diff[k] == 0 else
             diff[k] / moved[k] if moved[k] else math.inf for k in diff}
    held = {k: v for k, v in ratio.items() if not k.endswith("['bias'] k")}
    state_path, state_worst = max(held.items(), key=lambda kv: kv[1])
    trip_report = {"loss_max_abs_diff": worst, "loss_tol": ELASTIC_LOSS_TOL,
                   "state_worst": [state_path, state_worst],
                   "state_tol": ELASTIC_STATE_TOL, "held": len(held),
                   "key_bias": {k: v for k, v in ratio.items()
                                if k not in held},
                   "diff_over_moved": ratio}
    log(f"gpt_elastic trip against the uninterrupted run ({smi}): "
        + json.dumps(trip_report))
    if not all(math.isfinite(x) for x in trip_losses) or \
            worst > ELASTIC_LOSS_TOL:
        raise AssertionError(f"gpt_elastic trip losses {trip_losses} vs "
                             f"the uninterrupted {ref}")
    if not state_worst <= ELASTIC_STATE_TOL:
        raise AssertionError(
            f"gpt_elastic trip state: {state_path} is {state_worst} of its "
            "steps' move off the uninterrupted run's")
    return trip_report


def gpt_elastic_phase(smi, trip, rem):
    """The ``gpt_elastic`` phase's checks on the world of 4's results:
    ``trip`` (every rank's :func:`elastic_trip_worker` result) and
    ``rem`` (rank 0's :func:`remediation_worker`). Prints each rank's
    checkpoint bytes, save and restore ms, the canary's replayed step ms,
    the launch counts and the seconds, each beside the card; returns the
    path's launch counts (rank 0's, both jobs)."""
    from apex_tpu_torch.monitor.goodput.accountant import account
    from apex_tpu_torch.resilience.remediation.__main__ import loop_checks

    out = trip[0]
    for name, held in out["checks"].items():
        if not all(held[k] for k in ("leaves_equal", "flat_prefix_equal",
                                     "crc32_equal")):
            raise AssertionError(f"gpt_elastic {name}: {held}")
    trip_report = trip_against_uninterrupted(smi, out)
    failures = []
    loop_checks(failures, rem, steps=REMEDIATION_CARD["steps"])
    if failures:
        raise AssertionError(f"gpt_elastic remediation: {failures}")
    records = rem["result"].records
    replay = [r["dur_s"] * 1e3 for r in records if r.get("kind") == "span"
              and r.get("phase") == "step" and r.get("replay")]
    restores = [r["dur_s"] * 1e3 for r in records if r.get("kind") == "span"
                and r.get("phase") == "ckpt_restore"]
    launches = {k: out["launches"][k] + rem["launches"][k]
                for k in out["launches"]}
    report = {
        "gpu": smi, "model": "gpt2-small 2x768 vocab 50257 (random "
        "weights, bf16 compute, fp32 params), ZeRO-2, dp 4 -> 2 -> 4",
        "transport": GLOO_TRANSPORT,
        "ckpt_bytes_written_by_rank": {
            step: [out["ckpt_bytes"][step] if r["rank"] == 0 else 0
                   for r in trip] for step in out["ckpt_bytes"]},
        "state_bytes_by_rank": {step: [r["state_bytes"].get(step)
                                       for r in trip]
                                for step in out["state_bytes"]},
        "save_block_ms_by_rank": {step: [r["save_ms"].get(step)
                                         for r in trip]
                                  for step in out["save_ms"]},
        "restore_reshard_ms_by_rank": {step: [r["restore_ms"].get(step)
                                              for r in trip]
                                       for step in out["restore_ms"]},
        "restore_checks": out["checks"],
        "losses": out["losses"],
        "trip_vs_uninterrupted": {k: v for k, v in trip_report.items()
                                  if k != "diff_over_moved"},
        "remediation": {
            "incarnations": [i["devices"] for i in
                             rem["result"].incarnations],
            "terminals": [(t.get("finding"), t.get("verdict"))
                          for t in rem["result"].terminals],
            "final_loss": rem["result"].losses.get(
                REMEDIATION_CARD["steps"] - 1),
            "reference_final_loss": rem["reference"].losses.get(
                REMEDIATION_CARD["steps"] - 1),
            "goodput": account(records,
                               run_id=rem["result"].run_id).fields(),
            "canary_replayed_step_ms": replay,
            "ckpt_restore_ms": restores,
            "builds": rem["builds"],
        },
        "launches_rank0": launches,
        "seconds": {"trip": out["seconds"], "remediation": rem["seconds"]},
    }
    log("gpt_elastic (GPT-2 small 2 layers, 4 ranks -> 2 -> 4; the trip's "
        "restores held leaf for leaf, flat buffers on the prefix, crc32 to "
        f"the manifest; losses to {ELASTIC_LOSS_TOL} and every leaf to "
        f"{ELASTIC_STATE_TOL} of its steps' move of the uninterrupted run; "
        "the remediation selftest's SDC and false-positive cases): "
        + json.dumps(report, default=str))
    return launches, report


def elastic_only(smi):
    """``--elastic``: the ``gpt_elastic`` phase alone in its own world of
    4 (development; the full script runs it in the tail's world)."""
    import shutil
    import tempfile

    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    tmp = tempfile.mkdtemp(prefix="gpt_elastic-")
    try:
        t0 = time.perf_counter()
        four = spawn(jobs_worker, GPT_PARALLEL_RANKS,
                     args=(elastic_jobs(tmp),), threads=RANK_THREADS,
                     timeout=900.0)
        log(f"gpt_elastic: the world of 4 ran "
            f"{time.perf_counter() - t0:.1f} s ({smi})")
        launches, _ = gpt_elastic_phase(smi, [r[0] for r in four],
                                        four[0][1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"gpt_elastic": launches}


def tail_world_of_4():
    """The multi-GPU tail's world of 4 ranks on this card: the compressed
    GPT runs, their card-against-plain check, BERT at tp = 2 x dp = 2 and
    its check, and the ``gpt_elastic`` jobs (the elastic trip and the
    remediation loop, which so pay no launch of their own). Returns every
    rank's results by job."""
    import shutil
    import tempfile

    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    elastic_tmp = tempfile.mkdtemp(prefix="gpt_elastic-")
    log(f"gpt_elastic: {elastic_tmp} has "
        f"{shutil.disk_usage(elastic_tmp).free / 1e9:.1f} GB free")
    t0 = time.perf_counter()
    four = spawn(jobs_worker, GPT_PARALLEL_RANKS, args=([
        (f"{TESTING}.parallel_workers:compress_runs_worker",
         (COMPRESS_TARGET, COMPRESS_RUNS,
          compress_batches(COMPRESS_TARGET, COMPRESS_STEPS), "cuda")),
        (f"{TESTING}.parallel_workers:compress_runs_worker",
         (CARD_VS_PLAIN, COMPRESS_CARD_VS_PLAIN,
          compress_batches(CARD_VS_PLAIN, 2), "cuda")),
        (f"{TP_WORKERS}:bert_train_worker", (BERT_TP_ARGV, "cuda")),
        (f"{TP_WORKERS}:bert_card_vs_plain_worker",
         (BERT_TP_CARD_VS_PLAIN, "cuda")),
        *elastic_jobs(elastic_tmp),
    ],), threads=RANK_THREADS, timeout=1200.0)
    shutil.rmtree(elastic_tmp, ignore_errors=True)
    log(f"multi-GPU tail: the world of 4 ran "
        f"{time.perf_counter() - t0:.1f} s ({GLOO_TRANSPORT})")
    return four


def zero_world():
    """The ZeRO LAMB and remainders job alone in a world of 4: over
    BERT-345M's shapes each rank holds about 10 GB of the card, so it
    shares the card with no other world. Returns every rank's result."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    t0 = time.perf_counter()
    ranks = spawn(jobs_worker, GPT_PARALLEL_RANKS, args=([
        (f"{TESTING}.compress_workers:zero_bytes_worker",
         (bert_345m_shapes(), ZERO_STEPS, "cuda", SEED))],),
        threads=RANK_THREADS, timeout=600.0)
    log(f"multi-GPU tail: the ZeRO LAMB world of 4 ran "
        f"{time.perf_counter() - t0:.1f} s ({GLOO_TRANSPORT})")
    return [r[0] for r in ranks]


def tail_world_of_2():
    """The multi-GPU tail's world of 2: the decode and MoE jobs at tp = 2.
    Returns every rank's results by job."""
    from apex_tpu_torch.transformer.testing.distributed_test_base import (
        jobs_worker,
        spawn,
    )

    t0 = time.perf_counter()
    two = spawn(jobs_worker, 2, args=(decode_jobs() + [
        (f"{TP_WORKERS}:moe_tp_card_worker",
         (MOE_TP, 4, 1024, 128, "cuda", SEED))],),
        threads=RANK_THREADS, timeout=600.0)
    log(f"multi-GPU tail: the world of 2 ran "
        f"{time.perf_counter() - t0:.1f} s ({GLOO_TRANSPORT})")
    return two


def tail_phases(smi, four=None, two=None, zero=None):
    """The multi-GPU tail's phases over :func:`tail_world_of_4`'s,
    :func:`tail_world_of_2`'s and :func:`zero_world`'s results (run here,
    one after the other, when not given). Returns their paths' launch
    counts."""
    torch.cuda.empty_cache()
    if zero is None:
        zero = zero_world()
    if four is None:
        four = tail_world_of_4()
    if two is None:
        two = tail_world_of_2()
    paths = {}
    job = [[r[i] for r in four] for i in range(6)]
    compressed, _ = gpt_compress_phase(smi, job[0], job[1])
    paths.update(compressed)
    paths["bert_tp"], _ = bert_tp_phase(smi, job[2][0], job[3])
    paths["zero_lamb_remainders"], _ = zero_lamb_remainders_phase(smi, zero)
    paths["gpt_tp_decode"], _ = gpt_tp_decode_phase(
        smi, [r[:len(DECODE_CASES)] for r in two])
    paths["gpt_moe_tp"], _ = gpt_moe_tp_phase(smi, [r[-1] for r in two])
    paths["gpt_elastic"], _ = gpt_elastic_phase(smi, job[4], job[5][0])
    log_memory("multi_gpu_tail")
    return paths

# depth 4, cut from 12 (as the GPT phases at tp x dp and pp are) to keep
# the whole script well inside its time limit on a slow host
RESILIENCE_ARGV = ["--vocab", "50257", "--seq-len", "1024", "--layers",
                   "4", "--hidden", "768", "--heads", "12", "--micro-batch",
                   "8", "--global-batch", "16", "--steps", "6",
                   "--log-interval", "2"]


def _resilience_run(argv, tmp, name):
    """One in-process run of the GPT example (``main(argv)``) with its
    records in ``<tmp>/<name>.jsonl``: (records by step, the jsonl's
    records, seconds). A rolled-back step's record is its last run's."""
    import os

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    jsonl = os.path.join(tmp, f"{name}.jsonl")
    t0 = time.perf_counter()
    records = pretrain_gpt.main([
        *RESILIENCE_ARGV, *argv, "--metrics-jsonl", jsonl,
        "--profile-dir", os.path.join(tmp, "profiles")])
    secs = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    by_step = {r["step"]: r for r in records}
    if not all(math.isfinite(r["loss"]) for r in by_step.values()):
        raise AssertionError(f"{name}: a non-finite loss in "
                             f"{[r['loss'] for r in records]}")
    return by_step, _jsonl(jsonl), secs


def _span_ms(records, phase, **match):
    return [{"step": r["step"], "ms": r["dur_s"] * 1e3}
            for r in records if r["kind"] == "span" and r["phase"] == phase
            and all(r.get(k) == v for k, v in match.items())]


def gpt_resilience_phase(smi):
    """The GPT example's recovery path at GPT-2 small width, in process
    (module docstring, phase 25): (a) a clean run saved every 2 steps,
    (b) the same with a bit flipped after step 3, (c) a bitwise replay
    of (a), (d) the replay of (b) diverging and its bisect, (e) a SIGTERM
    after step 3 and a rerun over a corrupted newest checkpoint, (f) a
    NaN at step 3 rolled back. Every step runs on the card."""
    import os
    import shutil
    import tempfile

    from apex_tpu_torch import _kernels
    from apex_tpu_torch.resilience import integrity
    from apex_tpu_torch.resilience.replay import load_journal
    from apex_tpu_torch.resilience.replay.__main__ import main as replay
    from apex_tpu_torch.utils.checkpoint import load_checkpoint

    tmp = tempfile.mkdtemp(prefix="gpt_resilience-")
    free = shutil.disk_usage(tmp).free
    log(f"gpt_resilience: {tmp} has {free / 1e9:.1f} GB free")
    A, B, C = (os.path.join(tmp, n) for n in "ABC")
    out = {"gpu": smi, "free_bytes_before": free}
    t_start = time.perf_counter()
    _kernels.reset_launch_counts()
    try:
        # (a) and (b)
        a, a_recs, out["run_a_s"] = _resilience_run(
            ["--save", A, "--save-interval", "2"], tmp, "a")
        if sorted(a) != list(range(6)) or any(
                r["verdict"] != "ok" for r in a.values()):
            raise AssertionError(f"run A: {a}")
        b, _, out["run_b_s"] = _resilience_run(
            ["--save", B, "--save-interval", "2", "--chaos-bitflip-step",
             "3"], tmp, "b")
        (flip,) = [e for e in load_journal(B).events
                   if e["event"] == "bitflip_injected"]
        if any(r["verdict"] != "ok" for r in b.values()):
            raise AssertionError("the sentinel flagged the bit flip")
        step_dir = os.path.join(A, "step_2")
        out["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(step_dir, n))
            for n in os.listdir(step_dir))
        out["checkpoint_files"] = len(os.listdir(step_dir))
        out["saves_a_ms"] = _span_ms(a_recs, "ckpt_save")
        t0 = time.perf_counter()
        if integrity.verify_checkpoint(step_dir, deep=True) != (True, "ok"):
            raise AssertionError("step 2 of A does not verify")
        out["sha256_ms"] = (time.perf_counter() - t0) * 1e3
        host = load_checkpoint(A, 2)
        t0 = time.perf_counter()
        integrity.tree_fingerprint(host)
        out["crc32_ms"] = (time.perf_counter() - t0) * 1e3
        del host
        # (c) a bitwise replay of A; (d) B diverges, and its bisect
        t0 = time.perf_counter()
        rc = replay([A, "--json", os.path.join(tmp, "replay_a.jsonl")])
        out["replay_a_s"] = time.perf_counter() - t0
        (rep,) = [r for r in _jsonl(os.path.join(tmp, "replay_a.jsonl"))
                  if r["kind"] == "replay"]
        if rc != 0 or not rep["ok"] or rep["mode"] != "bitwise" or (
                rep["steps_replayed"] != 6 or rep["anchors_checked"]
                != [2, 4, 6]):
            raise AssertionError(f"replay of A: rc {rc}, {rep}")
        out["replay_step_ms"] = _span_ms(
            _jsonl(os.path.join(tmp, "replay_a.jsonl")), "step",
            replay=True)
        if replay([B]) != 2:
            raise AssertionError("the replay of B found no divergence")
        t0 = time.perf_counter()
        rc = replay([B, "--bisect", "--json",
                     os.path.join(tmp, "bisect_b.jsonl")])
        out["bisect_b_s"] = time.perf_counter() - t0
        (div,) = [r for r in _jsonl(os.path.join(tmp, "bisect_b.jsonl"))
                  if r["kind"] == "divergence"]
        if rc != 0 or not div["found"] or div["step"] != 4 or (
                div["leaves"] != ["[0]" + flip["path"]]) or not (
                div["exact_leaves"]) or (div["clean_anchor"],
                                         div["dirty_anchor"]) != (2, 4):
            raise AssertionError(f"bisect of B: rc {rc}, {div}")
        out["bisect"] = {k: div[k] for k in (
            "step", "leaves", "exact_leaves", "clean_anchor",
            "dirty_anchor", "layer", "probes")}
        shutil.rmtree(A)
        shutil.rmtree(B)
        # (e) SIGTERM after step 3: a verified checkpoint at step 4; the
        # rerun over its corruption falls back to step 2
        c, _, out["run_c_s"] = _resilience_run(
            ["--save", C, "--save-interval", "2", "--chaos-sigterm-step",
             "3"], tmp, "c")
        if sorted(c) != [0, 1, 2, 3] or (
                integrity.verified_latest_step(C) != 4):
            raise AssertionError(
                f"SIGTERM run: steps {sorted(c)}, newest verified "
                f"{integrity.verified_latest_step(C)}")
        c2, c2_recs, out["run_c_resume_s"] = _resilience_run(
            ["--save", C, "--save-interval", "2", "--chaos-corrupt-latest",
             "bitflip"], tmp, "c2")
        if sorted(c2) != [2, 3, 4, 5] or any(
                c2[i]["loss"] != a[i]["loss"] for i in c2) or any(
                c[i]["loss"] != a[i]["loss"] for i in c):
            raise AssertionError(
                f"resume after SIGTERM and corruption: "
                f"{[c[i]['loss'] for i in c]} then "
                f"{[c2[i]['loss'] for i in c2]}, against "
                f"{[a[i]['loss'] for i in a]}")
        out["restore_ms"] = _span_ms(c2_recs, "ckpt_restore")
        # (f) a NaN at step 3 with no skip budget: rolled back, completed
        log_path = os.path.join(tmp, "anomalies.jsonl")
        f, f_recs, out["run_f_s"] = _resilience_run(
            ["--chaos-nan-steps", "3", "--skip-budget", "0",
             "--anomaly-log", log_path], tmp, "f")
        ladder = [(r["kind"], r["step"]) for r in _jsonl(log_path)]
        (summary,) = [r for r in f_recs if r["kind"] == "summary"]
        if ladder != [("rollback", 3), ("rollback_restore", 0)] or (
                sorted(f) != list(range(6))) or summary["rollbacks"] != 1:
            raise AssertionError(f"NaN rollback: {ladder}, {summary}")
        out["rollback_ms"] = _span_ms(f_recs, "rollback")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _kernels.launch_counts()
    out["phase_s"] = time.perf_counter() - t_start
    out["losses_a"] = [a[i]["loss"] for i in range(6)]
    log("gpt_resilience " + json.dumps(out))
    return launches, out


def log_memory(after):
    """What stays allocated on the card after a phase (a later phase's
    peak memory counts it), and the seconds since the script started."""
    log(f"memory after {after}: {torch.cuda.memory_allocated() / 1e9:.3f} GB "
        f"allocated, {time.perf_counter() - START:.1f} s since the start")


def check_paths(paths):
    for name, counts in paths.items():
        log(f"launches {name}: " + json.dumps(
            {k: counts[k] for k in PATH_KERNELS[name]}))
        missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
        if missing:
            raise AssertionError(f"path {name}: {missing} not launched")


def main():
    smi = device_phase()

    from apex_tpu_torch import _kernels

    log(f"build: {_kernels.build_all():.1f} s")
    native_phase(smi)
    if sys.argv[1:2] == ["--llama-runtime"]:
        # development: the Llama recovery phase alone, no kernels line and
        # no result line
        check_paths({"llama_runtime": llama_runtime_phase(smi)[0]})
        log(f"llama_runtime phase done in "
            f"{time.perf_counter() - START:.1f} s")
        return
    if sys.argv[1:2] == ["--serve-gpt"]:
        # development: phase 4c alone, no kernels line and no result line
        check_paths(serve_gpt_phase(smi)[0])
        log(f"serve_gpt phase done in {time.perf_counter() - START:.1f} s")
        return
    if sys.argv[1:2] == ["--resilience"]:
        # development: phase 25 alone, no kernels line and no result line
        check_paths({"gpt_resilience": gpt_resilience_phase(smi)[0]})
        log(f"gpt_resilience phase done in "
            f"{time.perf_counter() - START:.1f} s")
        return
    if sys.argv[1:2] == ["--elastic"]:
        # development: the gpt_elastic phase alone, no kernels line and no
        # result line
        check_paths(elastic_only(smi))
        log(f"gpt_elastic phase done in "
            f"{time.perf_counter() - START:.1f} s")
        return
    if sys.argv[1:2] == ["--contrib"]:
        # development: the contrib phase alone, no kernels line and no
        # result line
        check_paths({"contrib": contrib_phase(smi)[0]})
        log(f"contrib phase done in {time.perf_counter() - START:.1f} s")
        return
    if sys.argv[1:2] == ["--tail"]:
        # development: the multi-GPU tail's phases alone, no kernels line
        # and no result line
        check_paths(tail_phases(smi))
        log(f"tail phases done in {time.perf_counter() - START:.1f} s")
        return

    errors = {}
    for check_fn in (ln_parity, flash_parity, ln_bwd_parity, flash_bwd_parity,
                     adam_parity, rms_parity):
        check_fn(errors)
        log_memory(check_fn.__name__)
    norm_routes()
    sumsq_parity(errors)
    log_memory("sumsq_parity")
    timings = kernel_timings(errors)
    log_memory("kernel_timings")

    paths = {}
    paths["serving"], _ = serving_phase(smi)
    log_memory("serving")
    paths["serving_fleet"], _ = serving_fleet_phase(smi)
    log_memory("serving_fleet")
    serve_gpt, _ = serve_gpt_phase(smi)
    paths.update(serve_gpt)
    log_memory("serve_gpt")
    paths["training"], _ = training_phase(smi)
    training_card_vs_plain()
    log_memory("training")
    paths["llama_serving"], _ = llama_serving_phase(smi)
    log_memory("llama_serving")
    paths["llama_finetune"], _ = llama_finetune_phase(smi)
    log_memory("llama_finetune")
    paths["llama_runtime"], _ = llama_runtime_phase(smi)
    log_memory("llama_runtime")
    paths["resnet"], resnet_rec = resnet_phase(smi)
    log_memory("resnet")
    paths["bert_serving"], _ = bert_serving_phase(smi)
    log_memory("bert_serving")
    paths["bert_pretrain"], _ = bert_pretrain_phase(smi)
    log_memory("bert_pretrain")
    paths["bert_dropout"], _ = bert_dropout_phase(smi)
    log_memory("bert_dropout")
    runs = multi_rank_runs()
    world = runs["world"]
    parallel, _ = gpt_parallel_phase(smi, world, runs["launches"])
    paths.update(parallel)
    log_memory("gpt_parallel")
    pipeline, _ = gpt_pipeline_phase(smi, world,
                                     runs["launches"]["gpt_pipeline"])
    paths.update(pipeline)
    log_memory("gpt_pipeline")
    zero_bubble, _ = gpt_pipeline_zero_bubble_phase(smi, world)
    paths.update(zero_bubble)
    log_memory("gpt_pipeline_zero_bubble")
    cp, _ = llama_cp_phase(smi, world["llama_cp"])
    paths.update(cp)
    log_memory("llama_cp")
    paths["amp_imagenet"], _ = amp_imagenet_phase(smi, resnet_rec)
    log_memory("amp_imagenet")
    paths["amp_dcgan"], _ = amp_dcgan_phase(smi)
    log_memory("amp_dcgan")
    paths["amp_mlp"], _ = amp_mlp_phase(smi)
    log_memory("amp_mlp")
    paths["contrib"], _ = contrib_phase(smi)
    log_memory("contrib")
    amp_parity()
    log_memory("amp_parity")
    amp_optimizer_timings(smi)
    log_memory("amp_optimizer_timings")
    recompute, _ = gpt_recompute_phase(smi)
    paths.update(recompute)
    log_memory("gpt_recompute")
    paths["gpt_moe"], _ = gpt_moe_phase(smi)
    log_memory("gpt_moe")
    paths["gpt_moe_ep"], _ = gpt_moe_ep_phase(smi, world["moe_ep"])
    log_memory("gpt_moe_ep")
    spatial_bottleneck_phase(smi, world["spatial_bottleneck"])
    paths["fp8"], _ = fp8_phase(smi)
    log_memory("fp8")
    paths["gpt_pipeline_no_remat"], _ = gpt_pipeline_remat_phase(
        smi, world)
    del world
    log_memory("gpt_pipeline_remat")
    paths.update(tail_phases(smi, runs["tail"], runs["launches"]["two"],
                             runs["zero"]))
    del runs
    log_memory("tail")
    paths["gpt_resilience"], _ = gpt_resilience_phase(smi)
    log_memory("gpt_resilience")
    check_paths(paths)

    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        main_shape, *others = timings[name]
        main_path = next(p for p, ks in PATH_KERNELS.items() if name in ks)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[main_path][name],
            "main_path": main_path,
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            **main_shape,
            "max_abs_err_parity": {str(d)[6:]: e
                                   for d, e in errors[name].items()},
            "other_shapes": others,
        })
    log(json.dumps({"kernels": kernels, "gpu": smi}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def run_in_own_tmpdir(fn):
    """Runs ``fn`` with every temp file of the run, this process's and
    those of the processes it starts (the synthetic token corpora of the
    phases, which outlive each example's run as the JAX package's do, among
    them), in one directory that is removed when ``fn`` ends."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    os.environ["TMPDIR"] = tempfile.tempdir = tmp
    try:
        return fn()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    run_in_own_tmpdir(main)
