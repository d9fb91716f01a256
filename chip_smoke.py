#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result):

1. build: compile every CUDA kernel of the serve path from
   ``flexflow_tpu_torch/csrc`` with nvcc (one process per source, started
   together), and print the card's name and power limit;
2. kernels: call each kernel at the Llama-2-7B attention shapes the serve
   path gives it, in each cache variant (fp; int8 with per-key scales;
   paged, 512-position pages behind a shuffled table; int8 and paged), and
   hold it against its plain PyTorch version, in float32
   (``atol=rtol=2e-5``) and bfloat16 (``atol=rtol=1e-2``: both sides round
   to bfloat16, one bfloat16 step apart at most); a paged kernel must give
   the contiguous kernel's output bit for bit on the same logical cache.
   Time the kernel, the plain version and, for fp caches, one PyTorch
   library call computing the same function (``scaled_dot_product_attention``,
   a yardstick the port never calls; no single PyTorch call dequantizes
   int8 K/V or reads through a page table inside attention, so the other
   variants have none): the kernel and the library call as device time
   (``time_ms``, the port's ``search/measure.py:time_fn``: the calls
   queued behind a sleep kernel, so the host's issue time is not counted),
   the kernel also back to back as the host issues it (``call_ms``,
   ``measure.event_ms``: the host's time where that is the longer), the
   plain version back to back.  Every kernel runs on the tensor cores: in
   bfloat16 as mma.sync m16n8k16 products fed by a cp.async ring, in
   float32 as error-compensated TF32 (three mma.sync m16n8k8 passes, two
   for int8 caches); K1 and both K3 layouts are split-KV, K1 and K3
   per-token after a row plan kernel that groups the flat tokens by cache
   row on the device (chunks of 64 folded rows in bf16, 16 in f32).  A
   float32 kernel's bound counts its flops at the TF32 tensor-core rate
   times its passes (3, or 2 for int8), beside the CUDA-core bound
   (``cuda_core_bound_ms``);
2b. edge kernels: K2 at a ragged shape (3 query heads per KV head, tiles
   of 40 at positions off the block grid, one across f32's key splits)
   and the K3 batched layout at committed lengths on the block and split
   boundaries with a pad request, bf16 and f32, every variant, held
   against the plain versions;
2c. row edge kernels: the row-grouped K1 and K3 per-token kernels, bf16
   (``1e-2``) and f32 (``2e-5``), every variant, held against the plain
   versions, paged == contiguous: K1 at 3 query heads per KV head (with
   and without ALiBi) on 120 prompt tokens of one row at consecutive
   positions (an ALiBi prefill: 360 folded rows, six bf16 chunks or 23
   f32 ones), tokens of other rows scattered through the flat batch at
   positions on the block and split boundaries, and pads on the scratch
   row; K1 at 48 and 71 query heads on one KV head with scattered tokens
   and pads; K3 per-token at 2 query heads per KV head, and at 48 and 71
   on one KV head, 7-token trees scattered through the batch at committed
   depths on the boundaries, pads giving zeros;
3. tree kernels: the tree-attention kernel in both layouts at the
   speculative serve shapes (per-token: 512 flat rows, 56 real = 8
   requests x a 7-node tree, the rest scratch-row pads; batched: [8, 7]),
   in the four variants, held and timed as in phase 2, the library
   yardstick being one ``scaled_dot_product_attention`` over
   [committed; spec] keys under an explicit mask;
3b. k1 families: K1 at the other families' decode shapes, held and timed
   as in phase 2 (f32 and bf16): with ALiBi slopes at the MPT-7B shape (8
   real of 512 flat tokens, cache ``[9, 32, 2048, 128]``) in the four cache
   variants, the yardstick one ``scaled_dot_product_attention`` with the
   ALiBi bias and causal mask as a float mask; and at Falcon-7B's 71 and
   StarCoder's 48 query heads on one KV head (D 64 and 128), fp and paged;
4. parity: a 2-layer model at full Llama-2-7B width in float32 (TF32 off)
   serves the same prompts on the card (kernels) and on the CPU (plain
   versions) from the same seeded weights: greedy tokens must be equal and
   a prefill step's and a decode step's logits within ``atol=rtol=1e-3``
   (float32 GEMMs summed in another order at width 4096 and 11008);
5. spec parity: 2 layers at full Llama-2-7B width in float32 (TF32 off)
   with a draft of llama-68m's published shape: ``SpecInferManager`` on
   the card == ``RequestManager`` on the card == ``SpecInferManager`` on
   the CPU, and ``SpecDecodeScan`` on the card == the same, token for
   token (greedy);
6. variant parity: the same 2-layer float32 model and draft with int8
   weights, on int8 KV with 512-position pages: card and CPU serve
   identical greedy tokens incrementally and through ``SpecInferManager``;
   on the card the int8 contiguous, fp paged and fp contiguous caches serve
   too, and each paged run (incremental, ``SpecInferManager``,
   ``SpecDecodeScan``) equals its contiguous run token for token;
6b. family parity: MPT-7B and Falcon-7B at full width, 2 layers, float32
   (TF32 off), card vs CPU from the same seeded weights: greedy tokens
   equal (2 prompts of 64 and 200 tokens, 8 new tokens) and a prefill
   and a decode step's logits within ``atol=rtol=1e-3``; then MPT on the
   card with int8, paged and int8+paged KV (128-position pages), each
   paged run equal to its contiguous twin;
7. serve: the published Llama-2-7B shape (32 layers, bfloat16, seeded
   random weights) serves 8 prompts of 256-1800 tokens, 64 new tokens
   each, through ``RequestManager.generate``, then through
   ``SpecInferManager.generate`` (width 2, depth 3) and ``SpecDecodeScan``
   with the llama-68m-shaped draft, then both again with a perfect draft
   (width 1, depth 5: the LLM's embedding, first 2 layers, final norm and
   head, shared; the upper layers' o_proj/down_proj zeroed in the LLM);
8. int8 serve: the same model with int8 weights (``quantize_int8``), int8
   KV and 512-position pages serves the same 8 prompts incrementally; then
   two sessions of 8 prompts sharing a 1024-token system prefix, the
   second of which must reuse the first one's pages (1024 cached prompt
   tokens per request) and give the tokens of a run with an empty prefix
   index; then ``SpecDecodeScan`` with the perfect draft on the same int8
   paged caches;
9. mpt serve: MPT-7B's published shape (32 layers, bf16, ALiBi) serves the
   8 prompts, 64 new tokens, on fp caches and then on int8 KV with
   512-position pages: only K1's ALiBi variant of the cache launches (an
   ALiBi model's prefill runs through K1; K2 never);
10. family serve: OPT-6.7B and StarCoder at full width, 2 layers, bf16,
   the 8 prompts, 16 new tokens: every request finishes with in-range
   tokens, and K1 and K2 launch;
11. f32 serve: the published Llama-2-7B shape in float32 (the reference's
   default serving dtype; TF32 off for the GEMMs) serves the 8 prompts, 16
   new tokens each, through ``RequestManager.generate`` (f32 K2 on the
   prefill, f32 K1 on the decode steps), then through
   ``SpecInferManager.generate`` (width 2, depth 3: f32 K3 per-token on
   the verify) and ``SpecDecodeScan`` (f32 K3 batched on the verify) with
   the llama-68m-shaped draft;
12. serve lifecycle: the same f32 Llama-2-7B on 512-position pages with
   an 8 GiB host page tier, priority preemption and seeded ``decode_scan``
   faults under ``serve_with_arrivals``: the 8 prompts and 16 new tokens,
   a request whose TTL expires in the queue, two priority-5 arrivals that
   preempt two rows (spilled to the tier, restored at readmission), and a
   cancel; every ``ok`` stream equals an uninterrupted ``generate`` on the
   same deployment, the cancelled one is a prefix of its stream, and the
   spill, restore, checksum and page-copy times are logged beside their
   bound over the host link;
13. api default path: the same f32 Llama-2-7B through the user's entry
   point, ``LLM(ServeModelConfig(...)).compile(max_requests=8,
   max_tokens_per_batch=512, max_seq_len=2048)`` with the reference's
   defaults (LM-head gating, the chained decode stretch):
   ``serve_with_arrivals`` on a clock that counts model passes, 4 of the
   8 prompts at t=0 and 4 due once those decode, which join the running
   stretch at a segment boundary; the streams must equal the same
   deployment's with gating and chaining off, with joins, one read-back
   per chained stretch, and K1 and K2 launched; the chain's segments,
   joins, exit codes and the joiners' TTFT in passes (chained against
   unchained) are logged, then the 8 prompts' prefill stretch gated
   against ungated and the LM head alone; then ``ssms=[SSM(draft)]`` at 2
   layers of full width with seeded sampling (T=0.8 twice equal, T=1e-4
   equal to greedy).
14. spec mixed: mixed spec and plain rows at 7B f32 with flips and the
   commit flush, a ``spec_mask`` scan, then speculative serving of every
   family at 2 layers of full width.
15. control plane: the published Llama-2-7B shape in bf16 compiled through
   ``LLM.compile`` (defaults, a llama-68m-shaped draft in ``ssms``) with
   an SLO policy (latency-critical and batch lanes) and a brownout ladder
   that escalates on KV occupancy: ``serve_with_arrivals`` of the 8
   prompts, 32 new tokens, lanes alternating, on a pass-counting clock,
   with every observation hook off and on (``Telemetry``,
   ``StepProfiler``, a ``PlanHealthMonitor`` whose plan predicts the
   hooks-off run's median TTFT and TPOT), three times each, alternating:
   records equal; at least one level change and one output cap; the
   hooks' host overhead share of the median wall, the profiler's per-tick
   phase budget (``host_admit``, ``host_prepare``, ``dispatch``,
   ``readback``) and counters (``host_syncs`` equal to the read-backs);
   the spec manager with its hooks (K3), equal to it with them off; the
   exports validated and summarised by ``tools.trace_report``, and two
   hooks-on runs' counters equal under ``tools.bench_compare``.
16. fleet, migration and replay: the published Llama-2-7B shape in float32
   (TF32 off), every deployment serving one model's parameter tensors
   with its own KV (4 slots, ``max_seq_len`` 2048), the 8 prompts, 16 new
   tokens: a one-replica oracle; ``LLM.fleet`` over two replicas with
   replica 0 killed mid-decode (streams equal the oracle's, every request
   ``ok``, the victim's requests failed over under their rids, and
   ``torch.cuda.memory_allocated`` falls by the victim's KV bytes); a
   rolling contiguous → paged migration over the fleet (a replica keeps
   admission open at every tick); ``LLM.attach_migration`` on a
   speculative deployment (contiguous → paged mid-decode, then a spec-off
   flip on the fast path); the kill run again with seeded sampling and
   one injected ``fleet_dispatch`` fault, recorded with a
   ``TrafficTraceRecorder``, replayed on a fresh fleet with zero
   mismatches, and ``tools/replay_report.py --check`` exiting 0 on the
   artifact.  Logs each migration's drain, rebuild and readmit walls,
   the recompute tokens, the downtime in admission-closed ticks and the
   failed-over requests' passes from the kill to their next token.
17. tensor parallelism, two shards on the one card (``devices=["cuda:0",
   "cuda:0"]``: the collectives' local implementation; NCCL across cards
   needs two cards): K1, K2 and both K3 layouts at the shard-local shapes
   of Llama-2-7B at ``tp=2`` (16 query heads on 16 KV heads: held against
   the plain versions and timed, fp caches) and of a 70B shape at ``tp=4``
   (16 query heads on 2 KV heads, a group of 8: held and timed), each
   beside one SDPA call (grouped heads folded into the query length);
   then (a) parity:
   Llama-2-7B at full width, 4 layers, float32 (TF32 off), ``tp=2``
   against ``tp=1`` from the same seeded weights (the ``tp=1`` deployment
   built, recorded and freed first): a prefill chunk's logits within
   ``atol=rtol=1e-3`` (float32 GEMMs whose two halves are summed apart),
   and equal 16-token greedy streams incrementally, through
   ``SpecInferManager`` and ``SpecDecodeScan`` (a ``tp=2`` llama-68m-shaped
   draft), and on int8 weights + int8 KV + 512-position pages; StarCoder's
   shape (48 query heads on one KV head: replicated attention) and
   MPT-7B's (ALiBi: each shard's slice of the slopes) at 2 layers; each
   shard's K1, K2 and K3 launches counted on its own; (b) serve: bf16
   Llama-2-7B at full depth through ``LLM.compile(tp=2)``, the 8 prompts,
   64 new tokens: TTFT, TPOT, each shard's weight and KV bytes and the
   collective calls, and the share of tokens equal to ``tp=1``'s (bf16
   partial sums round apart, so the share is printed, not required).
   Its times are two shards on one card: the shards' host issue and the
   reduces, not a speed-up.
18. pipeline parallelism, every stage on the one card (``pp=2``, and
   ``pp=2 x tp=2``): streams equal to ``pp=1``, each stage's launches,
   the bf16 7B at ``n_micro`` 2 and 1;
19. planner: ``MachineModel.for_mesh`` of a CUDA mesh with
   ``artifacts/h100_calib.json``'s measured constants (two of them
   measured again beside it); ``search_serve_plan`` of bf16 Llama-2-7B
   on ``meta`` at phase 7's capacities must choose ``tp1_pp1_m1``, its
   predicted TPOT and TTFT beside phase 7's measured ones and into a
   ``CalibrationLedger``; Llama-2-70B bf16 must be refused on one card
   and fit 80 GB a stage on four (priced only);
20. searched strategy, two shards on the one card: (a) the 4-layer
   float32 Llama of the 7B's widths served under ``strategy="search"``
   (and through ``SpecInferManager``), the all-``sample`` dict the search
   chooses at TINY widths, and a hand dict mixing ``sample``,
   ``channel_out``, ``channel_in``, ``head`` and ``entry`` (an all-to-all
   runs): each greedy stream equal to ``tp=1``'s, each shard launching K1
   and K2 (K3 on the speculative run); (b) the bf16 Llama-2-7B at full
   depth through ``InferenceManager(mesh=tp2 on one card,
   strategy="search")``, 8 requests of 64 tokens: the searched dict, its
   ``simulate`` total and ``plan_memory_bytes`` a device beside the
   Megatron dict's, and the measured TTFT and TPOT.
21. training, through ``FFModel`` on the card in float32 (TF32 off):
   (a) the Transformer classifier at BERT-base width (hidden 768, 12
   heads, ff 3072), 2 layers, batch 8, sequence 128, 16 classes, 3 steps
   of SGD (momentum 0.9) and 3 of Adam on the card and on the CPU from
   the same seeded weights (``load_params``) and batches: losses within
   ``rtol 1e-4`` (float32 products summed in another order at width
   3072), parameters within ``1e-5`` under SGD and ``2 * alpha * steps``
   under Adam (whose step on a near-zero gradient is about ``alpha``
   whatever its rounding); (b) the same classifier at 12 layers and
   sequence 512 trained by ``fit`` with Adam (lr 1e-4) for 4 epochs of a
   64-sample learnable set (labels a fixed random projection of the
   pooled input): the median step time after 2 warm-up steps (each step
   between two ``torch.cuda.synchronize``), samples/s, tokens/s, three
   times the ops' forward flops over the step as a share of the f32
   rate, peak memory, and the first and last epoch's loss, which must
   fall; (c) the MNIST MLP example (``examples/mnist_mlp.py``) with its
   defaults, one epoch, then ``evaluate``: accuracy at least 0.99.  No
   kernel is launched: the training path's compute is torch ops.
22. training on a mesh, every shard on the one card, float32 (TF32 off):
   (a) phase 21(a)'s 2-layer BERT-base-width classifier on one device,
   ``dp=2`` (``["cuda:0"] * 2``) and ``dp=2 x tp=2`` (``["cuda:0"] * 4``,
   the Megatron dict: attention ``head``, ``ff1`` ``channel_out``,
   ``ff2`` ``channel_in`` over ``tp``, ``sample`` over ``dp``) from the
   same weights and batches, 3 steps of SGD (momentum 0.9) and 3 of Adam:
   losses within ``rtol 1e-4`` of one device's, parameters within phase
   21's tolerances, the collective calls by kind and the gradient
   all-reduces a step; (b) phase 21(b)'s 12-layer, sequence-512
   classifier trained by ``fit`` with Adam at ``dp=2`` for 2 epochs of
   its synthetic set: the median step, samples/s, peak memory and the
   loss falling, beside phase 21(b)'s one-device step (two shards on one
   card measure the executor and the collectives, not a speed-up);
   (c) a checkpoint written at ``dp=2 x tp=2`` restored on one device and
   on ``dp=2`` with equal parameters, then one epoch of the MNIST MLP
   through ``fit(DataLoader(..., native="auto"))``, whose engine must be
   the native one.  No kernel is launched.
23. the training planner, float32 (TF32 off): (a) the standard op-cost
   probes (``search/measure.py:calibrate_standard_probes``: the JAX
   package's probe list, each op's ``forward`` as device time) into a
   cache under ``build/``, each probe's microseconds and a linear's
   TFLOP/s, and the ``train_step_factor`` probe (the 784-512-512-10 MLP
   at batch 64, forward against forward, backward and SGD); (b) phase
   21(b)'s 12-layer, sequence-512 classifier on a ``dp=2 x tp=2`` mesh
   with every shard on the card: ``compile`` with the joint search (graph
   rewrites and placements), ``search_budget=200`` and
   ``search_alpha=0.001``, its
   fused nodes by type and its searched dict; the unfused model compiled data-parallel
   on the same mesh, its weights carried onto the fused graph through
   ``remap_params``, 3 Adam steps on both: losses within phase 22(a)'s
   ``rtol 1e-4``, then 4 more steps each, timed; (c) ``simulate`` of a
   training step under the calibrated ``h100`` spec with (a)'s cache as
   ``measured`` (equal to the roofline price where no op has a probe's
   shape), for both plans, beside their median measured steps (not
   comparable while four shards share one card; the f32 steps run on the
   CUDA cores, the spec prices heavy ops at the bf16 tensor-core peak).
   No kernel is launched.
24. the conv nets and DLRM, float32 (TF32 off for the GEMMs and cuDNN):
   (a) every op of slice 11c-i on the card against the same module on
   the CPU (``tools/op_parity.py``: the shape ops; ``Conv2D`` with
   ``"SAME"`` at strides 1, 2 and 4, ``"VALID"``, an int padding and two
   groups; ``Pool2D`` max and average, ``"SAME"`` and ``"VALID"``;
   ``BatchNorm`` in training and outside it; ``AddBiasResidualLayerNorm``;
   ``Embedding`` with ``aggr`` none, sum and avg), forward and gradients
   within ``rtol 1e-4``, ``atol 1e-5``; (b) the reference's ResNet-18 at
   ImageNet width (``(3, 224, 224)``, 1000 classes, widths 64-512), batch
   32, SGD (lr 0.01, momentum 0.9) by ``fit``, 2 epochs of a 256-image
   learnable set (labels a fixed random projection of the pooled input):
   the median step after 2 warm-up steps (each between two
   ``torch.cuda.synchronize``), images/s, three times the forward flops
   over the step as a share of the f32 rate, peak memory, and the epoch
   losses, which must fall; (c) the same ResNet-18 at ``dp=2``, both
   shards on the card, 3 SGD steps from (b)'s weights and first batches:
   losses within ``rtol 1e-4`` of one device's (BatchNorm's statistics
   are the global batch's), the collectives a step by kind; (d) AlexNet
   and the compact Inception at the builders' ``(3, 64, 64)``, batch 32:
   one epoch of ``fit``, then ``evaluate``: finite losses, softmax rows
   summing to 1 within ``1e-5``; (e) DLRM at the facebookresearch/dlrm
   Criteo Kaggle widths (dense 13, bottom 512-256-64-16, 26 tables of
   10^6 rows x 16, top 512-256-1; the real row counts come from the
   dataset), batch 128, on ``{"dp": 2, "mp": 2}`` with four shards on the
   card, the tables ``entry``-sharded over ``mp``: 3 SGD steps of
   ``binary_crossentropy``, losses within ``rtol 1e-4`` of one device's
   from the same weights and batches, the steps and peak memory.  No
   kernel is launched: conv, pool and the rest are torch ops, as XLA
   lowers them in the reference;
25. MoE, the decode heads and the cache, float32 (TF32 off): (a) every op
   of the slice (``tools/op_parity.py``'s ``SLICE_11C_II`` cases:
   ``GroupBy`` with random and with tied gates, ``Experts`` with and
   without a hidden layer, ``Aggregate``, ``AggregateSpec``, ``ArgMax``,
   ``TopK``, ``ArgTopK``, ``BeamTopK`` on logits whose largest values
   tie, ``Sampling``, ``Cache``) on the card against the CPU: forward and
   gradients within ``rtol 1e-4``, ``atol 1e-5``, indices equal element
   for element, every sampled token inside the CPU's nucleus mask and
   one seed giving the same tokens twice; (b) one MoE layer at
   mistralai/Mixtral-8x7B-v0.1's expert widths (hidden 4096, expert
   hidden 14336, 8 experts, top-2; the reference's ReLU MLP with biases,
   not Mixtral's SwiGLU) in ``build_moe_classifier``, batch 1024,
   capacity factor 2.0 (C = 512), SGD by ``fit``, 2 warm-up and 6 timed
   steps over 2 batches of learnable labels: the median step and its
   spread, tokens/s, three times the forward flops over the step as a
   share of the f32 rate, peak memory, and the loss on those batches
   before and after, which must fall; (c) the classifier at hidden 1024,
   expert hidden 4096, 8 experts, batch 256 on ``{"ep": 2}`` and ``{"dp":
   2, "ep": 2}`` with every shard on the card, against one device from
   the same weights: the forward within ``atol 1e-5``, 2 SGD steps'
   losses within ``rtol 1e-4`` and the parameters after within ``atol
   1e-5``, the collectives a step by kind; (d) ``dense(4096 -> 32000)``
   (Llama-7B's vocabulary) over 64 rows into every decode head, behind a
   cache, on one device and on ``{"tp": 2}`` (two shards on the card):
   the outputs equal the CPU's (indices exactly), the sampled tokens
   inside the CPU's nucleus mask, and the cache in use mode replays the
   value it stored in refresh mode.  No kernel is launched: the MoE
   products and the heads' selections are torch ops, as XLA lowers them
   in the reference.
26. the builder's serve path and the frontends: (a) Llama-2-7B (bf16,
   32 layers) recorded as the reference's builder calls on an ``FFModel``
   (``build_model(ff, cfg, 512, attention=tree_inc_...)``) and served by
   ``InferenceManager(ff)``, its weights copied on the card from the
   family model's by node name: phase 13's 8 prompts for 16 new tokens,
   in turns with the family model (family, builder, builder, family),
   greedy streams equal to the family model's and K1 and K2 launched as
   often, TTFT and TPOT beside the family's; (b) a llama-68m-shaped
   builder draft (``spec_inc_...``) with that target through
   ``SpecInferManager`` and ``SpecDecodeScan`` (width 2, depth 3): K3 in
   both layouts, streams and launches equal to the family path's; (c)
   ``from_torch`` of a BERT-base-width encoder block (hidden 768, 12
   heads, ffn 3072, batch 8, sequence 128, f32, TF32 off): its card
   forward within ``1e-4`` of the module's, two SGD steps (MSE) with
   losses within ``rtol 1e-4`` of ``torch.optim.SGD``'s and parameters
   within ``1e-5``; a Keras ``Sequential`` CNN on 4096 28x28 images: one
   epoch of Adam, the loss falls.
27. pipeline and ring-attention training, float32 (TF32 off), every shard
   on the one card: (a) the BERT-base-width classifier (12 layers,
   sequence 512, batch 8, 16 classes) with ``pipeline="force"`` and 4
   microbatches on ``{"pp": 2}``, ``{"pp": 4}`` and ``{"pp": 2, "dp":
   2}`` against the same seeded model on one device: the carve, 3 SGD
   steps (lr 1e-3) of losses (``rtol 1e-4``) and parameters (``atol
   1e-5``), the median step of 6, each shard's core, parameter and slot
   bytes, peak memory,
   and the stage applications and shift calls a step, required equal to
   the GPipe schedule's; (b) ``pipeline="auto"`` on ``{"pp": 4}``: the
   kind chosen and both plans' prices on the ``h100`` machine model,
   beside the measured step of the plan that ran; (c) the classifier at
   width 768, 12 heads, 2 layers, sequence 4096, batch 2 with ring
   attention (``{"sequence": ("sp",)}`` on every attention op) on
   ``{"sp": 4}`` and ``{"dp": 2, "sp": 2}`` against one device: logits
   (``atol 1e-5``), 2 SGD steps' losses (``rtol 1e-4``), the median step,
   peak memory and the shift calls a step.
Every kernel count is set to 0 just before each path and read just after,
per cache variant, and every plain version is counted too: each path must
launch its kernels in its variant (K1 and K2 on the incremental paths,
``tree_attention`` on the host speculative path and the drafts' steps,
``tree_attention_batched`` on the device one) and run no plain version.
Speculative streams must finish with 64 in-range tokens; their share of
tokens equal to the incremental run is printed, not required (bf16 streams
may part at a rounding tie).

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record (one entry per kernel and cache variant
in bf16 and, suffixed ``/f32``, in float32, K1's ALiBi variants, K1
at 71 and 48 query heads per KV head, and, suffixed ``7b-tp2-shard``,
the kernels at phase 17's shard-local shape with its launches over both
shards and phase 18's ``pp=2 x tp=2`` launches: all four in float32, K1
and K2 in bf16; suffixed ``7b-pp2``, phase 18's launches alone, beside
the times of their shape; phase 20's launches in the fp rows, f32 for
(a) and bf16 for (b); phase 26's builder-path launches in the bf16 fp
rows) and ``{"ok": true, "device": {...}}``.  Exits non-zero without a CUDA
device.
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM, data sheet
# dense, data sheet: f32 on the CUDA cores, TF32 and bf16 tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 494.7e12, "bfloat16": 989e12}
VARIANTS = ("fp", "int8", "paged", "int8+paged")
PAGE = 512          # the serve path's page size (the reference's default)


def log(*args):
    print(*args, flush=True)


def call_ms(fn, iters):
    """Milliseconds per call of ``fn`` run back to back as the host issues
    them (``search/measure.py:event_ms``): where the host takes longer to
    issue a call than the device to run it, this is the host's time."""
    from flexflow_tpu_torch.search.measure import event_ms

    return event_ms(fn, iters, warmup=1)


def time_ms(fn, iters):
    """Device milliseconds per call of ``fn``
    (``search/measure.py:time_fn``): ``iters`` calls queued behind a sleep
    kernel that holds the stream until the host has issued them all, the
    fastest of three such timings."""
    from flexflow_tpu_torch.search.measure import time_fn

    return time_fn(fn, iters=iters) * 1e3


def key_bytes(variant, d, itemsize):
    """Bytes of one key's K and V vectors of one head in ``variant``: int8
    values plus their two f32 scales, or two vectors of the dtype."""
    if variant.startswith("int8"):
        return 2 * d + 8
    return 2 * d * itemsize


def table_bytes(variant, r1, s):
    return 4 * r1 * (s // PAGE) if variant.endswith("paged") else 0


def decode_work(rows, pos, s, kv, qh, d, itemsize, kbytes):
    """(bytes, flops) decode attention must move/do for these inputs:
    q and out once, each row's K/V prefix up to its deepest token once
    (``kbytes`` per key and head)."""
    deepest = {}
    for r, p in zip(rows, pos):
        deepest[r] = max(deepest.get(r, 0), min(p, s - 1) + 1)
    t = len(rows)
    kv_bytes = sum(deepest.values()) * kv * kbytes
    nbytes = 2 * t * qh * d * itemsize + 8 * t + kv_bytes
    flops = sum(4 * (min(p, s - 1) + 1) * qh * d for p in pos)
    return nbytes, flops


def prefill_work(rows, pstart, bq, s, kv, qh, d, itemsize, kbytes):
    deepest = {}
    for r, p in zip(rows, pstart):
        deepest[r] = max(deepest.get(r, 0), min(p + bq - 1, s - 1) + 1)
    g = len(rows)
    kv_bytes = sum(deepest.values()) * kv * kbytes
    nbytes = 2 * g * bq * qh * d * itemsize + 8 * g + kv_bytes
    flops = sum(4 * (min(p + b, s - 1) + 1) * qh * d
                for p in pstart for b in range(bq))
    return nbytes, flops


def bound(nbytes, flops, dtype_name, variant="fp"):
    """(least ms, "bytes" or "operations", CUDA-core ms or None): bytes at
    the HBM rate against flops at the dtype's peak; float32 flops as
    error-compensated TF32 on the tensor cores, 3 passes (2 for an int8
    cache, whose values are exact in TF32), with the bound at the CUDA
    cores' f32 rate third."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    core = None
    if dtype_name == "float32":
        passes = 2 if variant.startswith("int8") else 3
        t_ops = passes * flops / PEAK_FLOPS["tf32"] * 1e3
        core = max(t_bytes, flops / PEAK_FLOPS["float32"] * 1e3)
    else:
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops
            else (t_ops, "operations")) + (core,)


def cache_variants(att, kv_quant, kc, vc, seed):
    """{variant: (k, v, cache kwargs)} of one logical fp cache: fp, int8
    (``kv_quant`` of it: the serve path's quantizer) and both behind a
    shuffled page table (physical pages out of logical order)."""
    import torch

    r1, _, s = kc.shape[:3]
    table = torch.randperm(r1 * (s // PAGE), generator=torch.Generator()
                           .manual_seed(seed)).reshape(r1, -1).int()
    table = table.to(kc.device)
    kq, ks = kv_quant(kc)
    vq, vs = kv_quant(vc)
    pk, pv, pkq, pvq, pks, pvs = (att.page_layout(t, table, PAGE)
                                  for t in (kc, vc, kq, vq, ks, vs))
    return {
        "fp": (kc, vc, {}),
        "int8": (kq, vq, dict(k_scale=ks, v_scale=vs)),
        "paged": (pk, pv, dict(page_table=table, page_size=PAGE)),
        "int8+paged": (pkq, pvq, dict(k_scale=pks, v_scale=pvs,
                                      page_table=table, page_size=PAGE)),
    }


def sdpa_ms(q, k, v, mask, scale):
    """Device milliseconds of one SDPA call computing attention of ``q``
    ``[N, QH, L, D]`` on ``k``/``v`` ``[N, KV, S, D]`` under ``mask``
    ``[N, 1, L, S]``, query head ``h`` reading KV head ``h // (QH / KV)``:
    the library yardstick of K1, K2 and K3.  Grouped query heads are
    folded into the query length (``q`` as ``[N, KV, G*L, D]``, the mask
    repeated ``G`` times), so the one call reads each KV head once, as the
    kernels do; the fold is checked once against the call on K and V
    repeated for every query head."""
    import torch
    import torch.nn.functional as F

    n, qh, length, d = q.shape
    g = qh // k.shape[1]
    qf = q.reshape(n, k.shape[1], g * length, d)
    mf = mask.repeat(1, 1, g, 1)

    def call():
        return F.scaled_dot_product_attention(qf, k, v, attn_mask=mf,
                                              scale=scale)

    if g > 1:
        want = F.scaled_dot_product_attention(
            q, k.repeat_interleave(g, 1), v.repeat_interleave(g, 1),
            attn_mask=mask, scale=scale)
        tol = 1e-3 if q.dtype == torch.float32 else 3e-2
        torch.testing.assert_close(call().reshape(n, qh, length, d), want,
                                   atol=tol, rtol=tol)
        del want
    return time_ms(call, 20)


def run_variants(att, torch, name, dn, tol, variants, head, tail, work,
                 library_ms, iters, slopes=None):
    """Kernel ``name`` on ``(*head, k, v, *tail)`` in each cache variant
    (with ALiBi ``slopes``, K1's ALiBi twin of each, named
    ``<variant>+alibi``): held against its plain version, paged ==
    contiguous bit for bit, timed.  ``work(variant) -> (bytes, flops)``;
    ``work`` None: held only, not timed.  Returns {(name, variant, dtype):
    result}."""
    fn, plain = getattr(att, name), getattr(att, name + "_plain")
    out, got = {}, {}
    for var, (k, v, kw) in variants.items():
        args = (*head, k, v, *tail)
        if slopes is not None:
            kw = dict(kw, slopes=slopes)
        got[var] = fn(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        err = (got[var].float() - want.float()).abs().max().item()
        torch.testing.assert_close(got[var].float(), want.float(), **tol)
        if work is None:
            out[(name, var, dn)] = dict(max_abs_err=err)
            continue
        nb, nf = work(var)
        bms, by, core = bound(nb, nf, dn, var)
        key = var if slopes is None else f"{var}+alibi"
        out[(name, key, dn)] = dict(
            max_abs_err=err, ms=time_ms(lambda: fn(*args, **kw), iters),
            call_ms=call_ms(lambda: fn(*args, **kw), iters),
            # the plain versions allocate gigabytes, which can synchronize
            # with the device: timed back to back, not behind a hold
            plain_ms=call_ms(lambda: plain(*args, **kw), 2),
            bound_ms=bms, bound_by=by,
            library_ms=library_ms if var == "fp" else None)
        if core is not None:
            out[(name, key, dn)]["cuda_core_bound_ms"] = core
        del want
    for paged, contiguous in (("paged", "fp"), ("int8+paged", "int8")):
        if paged in got and not torch.equal(got[paged], got[contiguous]):
            raise AssertionError(f"{name} {dn}: the {paged} kernel differs "
                                 f"from the {contiguous} one")
    return out


def phase_kernels(att, kv_quant, torch, dev, qh=32, kv=32,
                  variants=VARIANTS, label=""):
    """K1 and K2 at the 7B attention shapes (``qh`` query heads on ``kv``
    KV heads: the whole model's 32 on 32 by default), in each cache
    variant of ``variants``, vs their plain versions, each beside one SDPA
    call (``sdpa_ms``)."""
    d, s, r = 128, 2048, 8
    rows_k1 = list(range(8)) + [r] * 504            # 8 real tokens, 504 pads
    pos_k1 = [0, 2047, 1023, 300, 1800, 64, 1500, 777] + [0] * 504
    rows_k2, pstart = [0, 3, 5, 7], [0, 640, 1280, 1920]
    bq = 128
    g = torch.Generator().manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-2, rtol=1e-2)
        kc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
        vc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
        caches = {k: v for k, v in cache_variants(
            att, kv_quant, kc, vc, 1).items() if k in variants}
        scale = d ** -0.5
        itemsize = kc.element_size()

        q1 = torch.randn(len(rows_k1), qh, d, generator=g).to(dev, dtype)
        rows1 = torch.tensor(rows_k1, dtype=torch.int32, device=dev)
        pos1 = torch.tensor(pos_k1, dtype=torch.int32, device=dev)
        # library yardstick: SDPA over the 8 real tokens' gathered rows
        # (the pads' one-key work is negligible)
        ridx = torch.tensor(rows_k1[:8], device=dev)
        kg, vg = kc[ridx], vc[ridx]
        mask = (torch.arange(s, device=dev)[None, :]
                <= pos1[:8, None].long())[:, None, None, :]
        lib1 = sdpa_ms(q1[:8, :, None, :], kg, vg, mask, scale)
        del kg, vg
        results.update(run_variants(
            att, torch, "decode_attention", dn, tol, caches, (q1,),
            (rows1, pos1, scale),
            lambda var: (decode_work(rows_k1, pos_k1, s, kv, qh, d, itemsize,
                                     key_bytes(var, d, itemsize))[0]
                         + table_bytes(var, r + 1, s),
                         decode_work(rows_k1, pos_k1, s, kv, qh, d, itemsize,
                                     0)[1]),
            lib1, 50))

        q2 = torch.randn(len(rows_k2), bq, qh, d, generator=g).to(dev, dtype)
        rows2 = torch.tensor(rows_k2, dtype=torch.int32, device=dev)
        ps2 = torch.tensor(pstart, dtype=torch.int32, device=dev)
        ridx = rows2.long()
        kg, vg = kc[ridx], vc[ridx]
        qpos = ps2.long()[:, None] + torch.arange(bq, device=dev)
        mask = (torch.arange(s, device=dev)[None, None, :]
                <= qpos[:, :, None])[:, None]
        lib2 = sdpa_ms(q2.transpose(1, 2), kg, vg, mask, scale)  # [G,QH,Bq,D]
        del kg, vg
        results.update(run_variants(
            att, torch, "prefill_attention", dn, tol, caches, (q2,),
            (rows2, ps2, scale),
            lambda var: (prefill_work(rows_k2, pstart, bq, s, kv, qh, d,
                                      itemsize, key_bytes(var, d, itemsize)
                                      )[0] + table_bytes(var, r + 1, s),
                         prefill_work(rows_k2, pstart, bq, s, kv, qh, d,
                                      itemsize, 0)[1]),
            lib2, 20))
        del kc, vc, caches, q1, q2
        torch.cuda.empty_cache()
    for (name, var, dn), res in results.items():
        log(f"kernel{label} {name} {var} {dn}: " + " ".join(
            f"{k}={v}" for k, v in res.items()))
    return results


def phase_edge_kernels(att, kv_quant, torch, dev):
    """K2 and the split-KV K3 batched kernel at ragged shapes, bf16 and
    f32 (the tensor-core kernels of both), in every cache variant, vs
    their plain versions (``1e-2`` bf16, ``2e-5`` f32), paged ==
    contiguous: K2 with 3 query heads per KV head and tiles of 40 (120
    folded rows: a full and a part 64-row chunk) at positions off the
    block grid, one across f32's two key splits, the last tile ending at
    S - 1; K3 batched with committed
    lengths at the block and split boundaries (0, 1, 31, 32, 63, 64, 65,
    S - 1) and a pad request with no live key (zeros)."""
    d, s = 128, 2048
    g = torch.Generator().manual_seed(5)
    res = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=2e-5, rtol=2e-5))):
        dn = str(dtype).replace("torch.", "")
        kc, vc = (torch.randn(9, 4, s, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        variants = cache_variants(att, kv_quant, kc, vc, 6)
        q2 = torch.randn(3, 40, 12, d, generator=g).to(dev, dtype)
        res.update(run_variants(
            att, torch, "prefill_attention", dn, tol, variants, (q2,), (
                torch.tensor([0, 5, 2], dtype=torch.int32, device=dev),
                torch.tensor([1000, 0, s - 40], dtype=torch.int32,
                             device=dev), d ** -0.5),
            None, None, 0))
        clens = [0, 1, 31, 32, 63, 64, 65, s - 1, 0]
        r, p, pb = len(clens), 7, 8
        q3 = torch.randn(r, p, 8, d, generator=g).to(dev, dtype)
        sk, sv = (torch.randn(r + 1, 4, pb, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        kc, vc = (torch.randn(r + 1, 4, s, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        variants = cache_variants(att, kv_quant, kc, vc, 6)
        amask = torch.rand(r, p, pb, generator=g) < 0.4
        amask[:, :, 0] = True
        amask[-1] = False
        tail = (sk, sv, torch.tensor(list(range(r - 1)) + [r],
                                     dtype=torch.int32, device=dev),
                torch.tensor(clens, dtype=torch.int32, device=dev),
                amask.to(dev), d ** -0.5)
        res.update(run_variants(att, torch, "tree_attention_batched", dn,
                                tol, variants, (q3,), tail, None, None, 0))
        for var, (k, v, kw) in variants.items():
            out = att.tree_attention_batched(q3, k, v, *tail, **kw)
            if out[-1].float().abs().sum().item() != 0:
                raise AssertionError(f"tree_attention_batched {var} {dn}: a "
                                     "request with no live key gave "
                                     "non-zeros")
        del kc, vc, variants
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("edge kernels (ragged K2, K3 split boundaries): " + " ".join(
        f"{name}/{var}/{dn} err={v['max_abs_err']:.3g}"
        for (name, var, dn), v in res.items()))


def phase_row_edge_kernels(att, kv_quant, torch, dev):
    """The row-grouped K1 and K3 per-token kernels where the row plan and
    the splits have edges, bf16 and f32, every cache variant, vs their
    plain versions (``1e-2`` bf16, ``2e-5`` f32), paged == contiguous (see
    the module docstring, phase 2c)."""
    from flexflow_tpu_torch.serve import alibi_slopes

    s, r = 2048, 8                     # cache rows 0-7, scratch row 8
    g = torch.Generator().manual_seed(7)
    boundary = [0, 31, 32, 63, 64, 255, 256, 257, 511, 512, s - 1]
    rows_k1 = [0] * 120 + [1 + i % 7 for i in range(len(boundary))] + [r] * 40
    pos_k1 = list(range(900, 1020)) + boundary + [0] * 40
    order = torch.randperm(len(rows_k1), generator=g).tolist()
    rows1 = torch.tensor([rows_k1[i] for i in order], dtype=torch.int32,
                         device=dev)
    pos1 = torch.tensor([pos_k1[i] for i in order], dtype=torch.int32,
                        device=dev)
    # K3 per-token: five requests of a 7-token tree and pads, shuffled
    clen_of = [0, 1, 63, 256, s]
    p, pb = len(TREE_PARENTS), 8
    mask1 = torch.from_numpy(tree_mask(TREE_PARENTS, pb))
    n_pad = 30
    rows_t = [i // p for i in range(len(clen_of) * p)] + [r] * n_pad
    order = torch.randperm(len(rows_t), generator=g).tolist()
    rows_t = [rows_t[i] for i in order]
    real = [i for i, row in enumerate(rows_t) if row < r]
    clens_t = [clen_of[row] if row < r else 0 for row in rows_t]
    amask = torch.zeros(len(rows_t), pb, dtype=torch.bool)
    node = {}
    for i in real:                 # each request's nodes in flat order
        amask[i] = mask1[node.setdefault(rows_t[i], 0)]
        node[rows_t[i]] += 1
    pads = torch.tensor([row == r for row in rows_t], device=dev)
    tail3 = (torch.tensor(rows_t, dtype=torch.int32, device=dev),
             torch.tensor(clens_t, dtype=torch.int32, device=dev),
             amask.to(dev))
    res = {}
    for dtype, tol in ((torch.bfloat16, dict(atol=1e-2, rtol=1e-2)),
                       (torch.float32, dict(atol=2e-5, rtol=2e-5))):
        dn = str(dtype).replace("torch.", "")
        # (label, query heads, KV heads, D, with ALiBi too)
        for label, qh, kv, d, alibi in (("gq3", 12, 4, 128, True),
                                        ("gq48", 48, 1, 128, False),
                                        ("gq71", 71, 1, 64, False)):
            kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
                      for _ in range(2))
            variants = cache_variants(att, kv_quant, kc, vc, 8)
            q1 = torch.randn(len(rows_k1), qh, d, generator=g).to(dev, dtype)
            for slopes in (None, alibi_slopes(qh, dev)) if alibi else (None,):
                out = run_variants(att, torch, "decode_attention", dn, tol,
                                   variants, (q1,), (rows1, pos1, d ** -0.5),
                                   None, None, 0, slopes=slopes)
                tag = label + ("+alibi" if slopes is not None else "")
                res.update({(n, f"{v}+{tag}", dn_): x
                            for (n, v, dn_), x in out.items()})
            del kc, vc, variants, q1
        # K3 per-token at 2 query heads per KV head, and at Falcon-7B's 71
        # and StarCoder's 48 on one KV head
        for label, qh, kv, d in (("gq2", 8, 4, 128), ("gq48", 48, 1, 128),
                                 ("gq71", 71, 1, 64)):
            kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
                      for _ in range(2))
            sk, sv = (torch.randn(r + 1, kv, pb, d, generator=g).to(dev, dtype)
                      for _ in range(2))
            variants = cache_variants(att, kv_quant, kc, vc, 9)
            q3 = torch.randn(len(rows_t), qh, d, generator=g).to(dev, dtype)
            tail = (sk, sv, *tail3, d ** -0.5)
            out = run_variants(att, torch, "tree_attention", dn, tol,
                               variants, (q3,), tail, None, None, 0)
            res.update({(n, f"{v}+{label}", dn_): x
                        for (n, v, dn_), x in out.items()})
            for var, (k, v, kw) in variants.items():
                got = att.tree_attention(q3, k, v, *tail, **kw)
                if got[pads].float().abs().sum().item() != 0:
                    raise AssertionError(f"tree_attention {var} {label} {dn}: "
                                         "a pad token gave non-zeros")
            del kc, vc, sk, sv, variants, q3
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log("row edge kernels (row-grouped K1 and K3 per-token): " +
        " ".join(f"{name}/{var}/{dn} err={v['max_abs_err']:.3g}"
                 for (name, var, dn), v in res.items()))


def phase_parity(serve, torch, dev):
    """2 layers at full 7B width, f32: card (kernels) vs CPU (plain)."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve.ServeModelConfig(num_hidden_layers=2, dtype="float32")
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=512)
    cpu = serve.InferenceManager(serve.build_model(cfg), device="cpu", **kw)
    cpu.init_operators_inference(seed=1)
    gpu = serve.InferenceManager(serve.build_model(cfg), device=dev, **kw)
    gpu.init_operators_inference(dict(cpu.model.named_parameters()))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in (300, 287)]
    gen = serve.GenerationConfig(max_new_tokens=9)   # prefill + 8 decodes
    t0 = time.perf_counter()
    want = serve.RequestManager(cpu, gen).generate(prompts)
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = serve.RequestManager(gpu, gen).generate(prompts)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    if got != want:
        raise AssertionError(f"card tokens {got} != CPU tokens {want}")

    cpu.reset()
    gpu.reset()
    pbc, _ = serve.PrefillBatchConfig.build(
        [(0, prompts[0][:128], 0)], [128], 128, max_tokens=128,
        max_requests=2, device="cpu")
    bc = serve.BatchConfig.build([prompts[0][128]], [0], [128], [129],
                                 max_tokens=128, max_requests=2,
                                 device="cpu")
    errs = []
    for step in (pbc, bc):
        lc = cpu.forward(step)
        lg = gpu.forward(to_device(step, dev)).cpu()
        errs.append((lg - lc).abs().max().item())
        torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)
    log(f"parity: 2-layer 7B-width f32, tokens equal {got[0][:4]}..., "
        f"max |logit diff| prefill {errs[0]:.3e} decode {errs[1]:.3e}; "
        f"serve cpu {t_cpu:.1f}s card {t_gpu:.2f}s")


def tree_work(clens, trees, n_flat, pb, kv, qh, d, itemsize, kbytes):
    """(bytes, flops) tree attention must move/do for these inputs: each
    request's committed K/V prefix (``kbytes`` per key and head) and spec
    buffers once, q and out for every flat row, the index and mask
    arrays; 4*D flops per query head and live key of each real tree
    token."""
    nbytes = (sum(clens) * kv * kbytes
              + len(clens) * kv * pb * d * itemsize * 2
              + 2 * n_flat * qh * d * itemsize + 8 * n_flat + n_flat * pb)
    flops = sum(4 * (c + int(m.sum())) * qh * d
                for c, mask in zip(clens, trees) for m in mask)
    return nbytes, flops


# a width-2, depth-3 draft tree: node -> parent (root first)
TREE_PARENTS = [-1, 0, 0, 1, 2, 3, 3]


def tree_mask(parents, pb):
    import numpy as np

    m = np.zeros((len(parents), pb), bool)
    for i, par in enumerate(parents):
        if par >= 0:
            m[i] = m[par]
        m[i, i] = True
    return m


def phase_tree_kernels(att, kv_quant, torch, dev, qh=32, kv=32,
                       variants=VARIANTS, label=""):
    """K3 at the speculative serve shapes (``qh`` query heads on ``kv`` KV
    heads), both layouts, each cache variant of ``variants``, vs its plain
    version; timed beside one SDPA call over [committed; spec] keys."""
    import numpy as np

    d, s, r, pb = 128, 2048, 8, 8
    lens = np.linspace(256, 1800, r).astype(int).tolist()
    p = len(TREE_PARENTS)
    n_flat = 512
    mask1 = tree_mask(TREE_PARENTS, pb)                  # [P, Pb]
    real = r * p
    rows_t = [i // p for i in range(real)] + [r] * (n_flat - real)
    clens_t = [lens[i // p] for i in range(real)] + [0] * (n_flat - real)
    amask_t = np.zeros((n_flat, pb), bool)
    amask_t[:real] = np.tile(mask1, (r, 1))
    g = torch.Generator().manual_seed(0)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-2, rtol=1e-2)
        kc, vc = (torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        sk, sv = (torch.randn(r + 1, kv, pb, d, generator=g).to(dev, dtype)
                  for _ in range(2))
        caches = {k: v for k, v in cache_variants(
            att, kv_quant, kc, vc, 2).items() if k in variants}
        q = torch.randn(n_flat, qh, d, generator=g).to(dev, dtype)
        scale = d ** -0.5
        itemsize = kc.element_size()
        tok_tail = (sk, sv,
                    torch.tensor(rows_t, dtype=torch.int32, device=dev),
                    torch.tensor(clens_t, dtype=torch.int32, device=dev),
                    torch.from_numpy(amask_t).to(dev), scale)
        qb = q[:real].reshape(r, p, qh, d).contiguous()
        bat_tail = (sk, sv, torch.arange(r, dtype=torch.int32, device=dev),
                    torch.tensor(lens, dtype=torch.int32, device=dev),
                    torch.from_numpy(np.tile(mask1, (r, 1, 1))).to(dev),
                    scale)
        # library yardstick: one SDPA over each request's [committed; spec]
        # keys with an explicit mask (the same function for the real rows)
        kg = torch.cat([kc[:r], sk[:r]], dim=2)
        vg = torch.cat([vc[:r], sv[:r]], dim=2)
        committed = (torch.arange(s, device=dev)[None, :]
                     < bat_tail[3][:, None].long())           # [R, S]
        lib_mask = torch.cat([committed[:, None, :].expand(r, p, s),
                              bat_tail[4]], dim=2)[:, None]   # [R,1,P,S+Pb]
        lib = sdpa_ms(qb.transpose(1, 2), kg, vg, lib_mask,   # [R,QH,P,D]
                      scale)
        del kg, vg
        for name, head, tail, flat in (
                ("tree_attention", (q,), tok_tail, n_flat),
                ("tree_attention_batched", (qb,), bat_tail, real)):
            results.update(run_variants(
                att, torch, name, dn, tol, caches, head, tail,
                lambda var, flat=flat: (
                    tree_work(lens, [mask1] * r, flat, pb, kv, qh, d,
                              itemsize, key_bytes(var, d, itemsize))[0]
                    + table_bytes(var, r + 1, s),
                    tree_work(lens, [mask1] * r, flat, pb, kv, qh, d,
                              itemsize, 0)[1]),
                lib, 20))
        del kc, vc, sk, sv, q, qb, caches, tok_tail, bat_tail
        torch.cuda.empty_cache()
    for (name, var, dn), res in results.items():
        log(f"kernel{label} {name} {var} {dn}: " + " ".join(
            f"{k}={v}" for k, v in res.items()))
    return results


def alibi_bias(slopes, pos, s):
    """The ALiBi score bias ``slopes[h] * (key - pos[t])`` with the causal
    mask folded in (-inf past ``pos[t]``), float ``[T, QH, 1, S]``: the
    library yardstick's ``attn_mask``."""
    import torch

    key = torch.arange(s, device=pos.device)
    rel = (key[None, :] - pos[:, None].long()).float()           # [T, S]
    bias = slopes.float()[None, :, None] * rel[:, None, :]       # [T, QH, S]
    bias = bias.masked_fill(rel[:, None, :] > 0, float("-inf"))
    return bias[:, :, None, :]


def phase_k1_families(att, kv_quant, torch, dev):
    """K1 on the other families' decode shapes, vs its plain version: with
    ALiBi at the MPT-7B shape in every cache variant, and at the large
    multi-query groups of Falcon-7B (71 query heads on one KV head, D 64)
    and StarCoder (48, D 128).  Timed beside one
    ``scaled_dot_product_attention`` on the fp work (the ALiBi bias and the
    causal mask as a float mask; the one KV head broadcast to the group).
    Returns ({(name, variant, dtype): result}, {label: bytes the extra
    chunk passes re-read})."""
    import torch.nn.functional as F

    from flexflow_tpu_torch.serve import alibi_slopes

    s, r = 2048, 8
    rows_k1 = list(range(8)) + [r] * 504            # 8 real tokens, 504 pads
    pos_k1 = [0, 2047, 1023, 300, 1800, 64, 1500, 777] + [0] * 504
    g = torch.Generator().manual_seed(3)
    results, rereads = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).replace("torch.", "")
        tol = dict(atol=2e-5, rtol=2e-5) if dtype == torch.float32 \
            else dict(atol=1e-2, rtol=1e-2)
        rows1 = torch.tensor(rows_k1, dtype=torch.int32, device=dev)
        pos1 = torch.tensor(pos_k1, dtype=torch.int32, device=dev)
        ridx = torch.tensor(rows_k1[:8], device=dev)
        for label, qh, kv, d, alibi in (("alibi", 32, 32, 128, True),
                                        ("gq71", 71, 1, 64, False),
                                        ("gq48", 48, 1, 128, False)):
            kc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
            vc = torch.randn(r + 1, kv, s, d, generator=g).to(dev, dtype)
            q1 = torch.randn(len(rows_k1), qh, d, generator=g).to(dev, dtype)
            scale = d ** -0.5
            itemsize = kc.element_size()
            slopes = alibi_slopes(qh, dev) if alibi else None
            kg = kc[ridx].expand(8, qh, s, d)
            vg = vc[ridx].expand(8, qh, s, d)
            if alibi:
                mask = alibi_bias(slopes, pos1[:8], s).to(dtype)
            else:
                mask = (torch.arange(s, device=dev)[None, :]
                        <= pos1[:8, None].long())[:, None, None, :]
            qs = q1[:8, :, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, kg, vg, attn_mask=mask, scale=scale), 20)
            del kg, vg, mask
            variants = cache_variants(att, kv_quant, kc, vc, 4)
            if not alibi:   # the multi-query shapes: fp and paged caches
                variants = {v: variants[v] for v in ("fp", "paged")}

            def work(var, d=d, kv=kv, qh=qh, itemsize=itemsize):
                nb, nf = decode_work(rows_k1, pos_k1, s, kv, qh, d, itemsize,
                                     key_bytes(var, d, itemsize))
                return nb + table_bytes(var, r + 1, s), nf

            res = run_variants(att, torch, "decode_attention", dn, tol,
                               variants, (q1,), (rows1, pos1, scale), work,
                               lib, 50, slopes=slopes)
            for (name, var, dn_), v in res.items():
                results[(name, var if alibi else f"{var}+{label}", dn_)] = v
            if not alibi:
                # ceil(gq / row_tile) chunks of a lone token's folded rows
                # each stream the K/V prefix (f32 16 rows, bf16 64); the
                # must-move bytes count it once
                chunks = -(-qh // att.row_tile(dtype))
                kv_bytes = work("fp")[0] - decode_work(
                    rows_k1, pos_k1, s, kv, qh, d, itemsize, 0)[0]
                rereads[f"{label} {dn}"] = (chunks - 1) * kv_bytes
            del kc, vc, q1, variants
            torch.cuda.empty_cache()
    for (name, var, dn), res in results.items():
        log(f"kernel {name} {var} {dn}: " + " ".join(
            f"{k}={v}" for k, v in res.items()))
    log(f"k1 large groups: bytes the extra chunk passes re-read "
        f"(beyond the must-move bytes): {rereads}")
    return results, rereads


def draft_config(serve, dtype):
    """The published shape of JackFram/llama-68m, the draft model the
    SpecInfer paper pairs with Llama-7B."""
    return serve.ServeModelConfig(
        hidden_size=768, intermediate_size=3072, num_hidden_layers=2,
        num_attention_heads=12, num_key_value_heads=12, dtype=dtype)


def held_firsts(serve, im, prompts):
    """Prefill slots 0.. of ``im``'s caches with the prompts (a prefill
    stretch); the first generated token of each.  Request i keeps its
    binding to slot i (a paged cache keeps its pages) for a
    ``SpecDecodeScan`` to continue from: :func:`release_held` ends it."""

    class Held(serve.RequestManager):
        def _release_slot(self, req):
            self.slots[req.slot] = None
            req.slot = -1

    outs = Held(im, serve.GenerationConfig(max_new_tokens=1)).generate(
        prompts)
    return [o[0] for o in outs]


def release_held(ims, n):
    for im in ims:
        for rid in range(n):
            im.kv.release(rid)


def phase_spec_parity(serve, torch, dev):
    """2 layers at full 7B width + the llama-68m-shaped draft, f32: the
    speculative paths on the card and the CPU equal incremental decoding."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=32, max_seq_len=256,
              max_spec_tokens=8)
    ims = {}
    llm_cfg = serve.ServeModelConfig(num_hidden_layers=2, dtype="float32")
    for key, cfg, topk, seed in (("llm", llm_cfg, 0, 1),
                                 ("ssm", draft_config(serve, "float32"), 2,
                                  2)):
        cpu = serve.InferenceManager(serve.build_model(cfg), device="cpu",
                                     topk=topk, **kw)
        cpu.init_operators_inference(seed=seed)
        gpu = serve.InferenceManager(serve.build_model(cfg), device=dev,
                                     topk=topk, **kw)
        gpu.init_operators_inference(dict(cpu.model.named_parameters()))
        ims[key] = (cpu, gpu)
    (llm_c, llm_g), (ssm_c, ssm_g) = ims["llm"], ims["ssm"]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(3, llm_cfg.vocab_size, size=n).tolist()
               for n in (130, 77)]
    gen = serve.GenerationConfig(max_new_tokens=8)
    want = serve.RequestManager(llm_g, gen).generate(prompts)
    llm_g.reset()
    got = serve.SpecInferManager(llm_g, ssm_g, gen, width=2,
                                 depth=3).generate(prompts)
    t0 = time.perf_counter()
    got_cpu = serve.SpecInferManager(llm_c, ssm_c, gen, width=2,
                                     depth=3).generate(prompts)
    t_cpu = time.perf_counter() - t0
    llm_g.reset()
    ssm_g.reset()
    scan = scan_streams(serve, llm_g, ssm_g, prompts, 8)
    for name, out in (("card SpecInferManager", got),
                      ("CPU SpecInferManager", got_cpu),
                      ("card SpecDecodeScan", scan)):
        if out != want:
            raise AssertionError(f"{name} {out} != card incremental {want}")
    log(f"spec parity: 2-layer 7B-width f32 + llama-68m draft, tokens "
        f"equal {want[0][:4]}... on both speculative paths, card and CPU "
        f"(CPU spec serve {t_cpu:.1f}s)")


def scan_streams(serve, llm, ssm, prompts, n_new, width=2, depth=3):
    """Greedy streams of ``n_new`` tokens per prompt from a held prefill
    and one ``SpecDecodeScan.run`` window."""
    firsts = held_firsts(serve, llm, prompts)
    held_firsts(serve, ssm, prompts)
    n = len(prompts)
    lens = [len(p) for p in prompts]
    sc = serve.SpecDecodeScan(llm, ssm, width=width, depth=depth)
    em, _ = sc.run(sc.init_carry(firsts, lens, lens, [False] * n,
                                 budget=[n_new - 1] * n), n_new - 1)
    release_held((llm, ssm), n)
    em = em.cpu().numpy()
    return [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1) if t >= 0]
            for i in range(n)]


def stream_times(stamps, t0):
    """TTFT (s) and TPOT (ms) per request from token arrival stamps."""
    ttft = [stamps[r][0] - t0 for r in sorted(stamps)]
    tpot = [1e3 * (stamps[r][-1] - stamps[r][0]) / (len(stamps[r]) - 1)
            for r in sorted(stamps)]
    return ttft, tpot


def check_streams(outs, n_new, vocab, what):
    if any(len(o) != n_new for o in outs):
        raise AssertionError(f"{what}: a request did not finish with "
                             f"{n_new} tokens: {[len(o) for o in outs]}")
    if any(not 0 <= t < vocab for o in outs for t in o):
        raise AssertionError(f"{what}: token id out of range")


def equal_share(outs, ref):
    pairs = [(a, b) for o, w in zip(outs, ref) for a, b in zip(o, w)]
    return sum(a == b for a, b in pairs) / len(pairs)


COUNTED = ("decode_attention", "prefill_attention", "tree_attention",
           "tree_attention_batched")
PLAIN_CALLS = dict.fromkeys(COUNTED, 0)   # plain versions run on a path


def count_plain_versions(att):
    """Count every call of a kernel's plain version (the wrappers and the
    batched plain version reach them through the module)."""
    for name in COUNTED:
        plain = getattr(att, name + "_plain")

        def counting(*args, _plain=plain, _name=name, **kw):
            PLAIN_CALLS[_name] += 1
            return _plain(*args, **kw)

        setattr(att, name + "_plain", counting)


def counted(att, fn):
    """Run ``fn`` with every kernel count (per variant: the cache variants,
    and K1's ALiBi twins) and plain count set to 0 just before; returns
    (its result, the kernel counts just after, {(kernel, variant):
    launches}).  Raises if a plain version ran."""
    att.reset_counts()
    for name in COUNTED:
        PLAIN_CALLS[name] = 0
    out = fn()
    if any(PLAIN_CALLS.values()):
        raise AssertionError(f"plain versions ran on the card's path: "
                             f"{PLAIN_CALLS}")
    return out, {(name, var): n for name in COUNTED
                 for var, n in getattr(att, name).variant_launches.items()}


def require_launches(n, label, variant, names):
    """Every kernel in ``names`` launched in ``variant`` on the path, and
    no kernel in another variant."""
    for name in names:
        if n[(name, variant)] <= 0:
            raise AssertionError(f"{name} ({variant}) never launched on the "
                                 f"{label} path")
    other = {k: c for k, c in n.items() if k[1] != variant and c}
    if other:
        raise AssertionError(f"{label}: kernels of another cache variant "
                             f"launched: {other}")


def short(n):
    """The non-zero counts of a path, for the log."""
    return {f"{name}/{var}": c for (name, var), c in n.items() if c}


def phase_variant_parity(serve, att, torch, dev):
    """2 layers at full 7B width + the llama-68m-shaped draft, f32, int8
    weights: the card's kernels equal the CPU's plain versions on int8
    paged KV, and each paged cache serves its contiguous twin's tokens."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=1024,
              max_spec_tokens=8)
    cfgs = {"llm": (serve.ServeModelConfig(num_hidden_layers=2,
                                           dtype="float32"), 0, 1),
            "ssm": (draft_config(serve, "float32"), 2, 2)}

    def managers(device, kv_dtype, page, params=None):
        out = {}
        for key, (cfg, topk, seed) in cfgs.items():
            im = serve.InferenceManager(
                serve.build_model(cfg), device=device, topk=topk,
                kv_dtype=kv_dtype, kv_page_size=page, **kw)
            im.init_operators_inference(
                None if params is None else params[key], seed=seed)
            serve.quantize_int8(im)
            out[key] = im
        return out

    cpu = managers("cpu", "int8", PAGE)
    params = {key: {k: p.to(dev) for k, p in im.model.named_parameters()}
              for key, im in cpu.items()}
    rng = np.random.default_rng(3)
    # the first prompt's prefill and decode cross a page boundary
    prompts = [rng.integers(3, cfgs["llm"][0].vocab_size, size=n).tolist()
               for n in (560, 200)]
    gen = serve.GenerationConfig(max_new_tokens=8)

    def serve_all(ims, label, count=True):
        llm, ssm = ims["llm"], ims["ssm"]
        runs = (("incremental", lambda: serve.RequestManager(
                    llm, gen).generate(prompts)),
                ("spec host", lambda: serve.SpecInferManager(
                    llm, ssm, gen, width=2, depth=3).generate(prompts)),
                ("spec device", lambda: scan_streams(
                    serve, llm, ssm, prompts, 8)))
        outs, launches = {}, {}
        for path, fn in runs:
            llm.reset()
            ssm.reset()
            if count:
                outs[path], launches[path] = counted(att, fn)
            else:
                outs[path] = fn()
            if label == "CPU" and path == "spec host":
                break                      # the CPU's scan adds nothing
        return outs, launches

    t0 = time.perf_counter()
    want, _ = serve_all(cpu, "CPU", count=False)
    t_cpu = time.perf_counter() - t0
    del cpu
    card, launches = {}, {}
    for kv_dtype, page in (("int8", PAGE), ("int8", None), (None, PAGE),
                           (None, None)):
        var = ("int8" if kv_dtype else "fp") + ("+paged" if page else "")
        var = var.replace("fp+paged", "paged")
        card[var], launches[var] = serve_all(
            managers(dev, kv_dtype, page, params), var)
        torch.cuda.empty_cache()
    for path in ("incremental", "spec host"):
        if card["int8+paged"][path] != want[path]:
            raise AssertionError(
                f"{path} on int8 paged KV: card {card['int8+paged'][path]} "
                f"!= CPU {want[path]}")
    for paged, contiguous in (("int8+paged", "int8"), ("paged", "fp")):
        for path, toks in card[paged].items():
            if toks != card[contiguous][path]:
                raise AssertionError(
                    f"{path}: {paged} cache {toks} != {contiguous} cache "
                    f"{card[contiguous][path]}")
    for var, by_path in launches.items():
        require_launches(by_path["incremental"], f"{var} incremental", var,
                         ("decode_attention", "prefill_attention"))
        require_launches(by_path["spec host"], f"{var} spec host", var,
                         ("tree_attention",))
        require_launches(by_path["spec device"], f"{var} spec device", var,
                         ("tree_attention_batched", "tree_attention"))
    log(f"variant parity: 2-layer 7B-width f32, int8 weights + llama-68m "
        f"draft: int8 paged KV card == CPU (incremental "
        f"{card['int8+paged']['incremental'][0][:4]}..., spec host), each "
        f"paged run == its contiguous run on the card (incremental, spec "
        f"host, spec device); int8 vs fp KV tokens equal share "
        f"{equal_share(*(card[v]['incremental'] for v in ('int8', 'fp'))):.4f}"
        f" (CPU serve {t_cpu:.1f}s)")
    for var, by_path in launches.items():
        log(f"variant parity {var}: launches " + "; ".join(
            f"{path} {short(n)}" for path, n in by_path.items()))
    return launches


def mpt7b_config(serve, **kw):
    """mosaicml/mpt-7b's published shape (config.json: d_model 4096,
    n_heads 32, n_layers 32, expansion_ratio 4, vocab_size 50432,
    max_seq_len 2048, no_bias, ALiBi)."""
    return serve.ServeModelConfig.from_hf_config(dict(dict(
        model_type="mpt", d_model=4096, n_heads=32, n_layers=32,
        expansion_ratio=4, vocab_size=50432, max_seq_len=2048,
        no_bias=True, attn_config={"alibi": True}), **kw))


def falcon7b_config(serve, **kw):
    """tiiuae/falcon-7b's published shape (config.json: hidden_size 4544,
    71 heads, multi_query, parallel_attn, no bias, vocab_size 65024, 32
    layers; ffn_hidden_size 4 x hidden = 18176)."""
    return serve.ServeModelConfig.from_hf_config(dict(dict(
        model_type="falcon", hidden_size=4544, num_attention_heads=71,
        num_hidden_layers=32, multi_query=True, parallel_attn=True,
        bias=False, alibi=False, new_decoder_architecture=False,
        vocab_size=65024, layer_norm_epsilon=1e-5), **kw))


def opt67b_config(serve, **kw):
    """facebook/opt-6.7b's published shape (config.json: hidden_size 4096,
    ffn_dim 16384, 32 heads, 32 layers, vocab_size 50272, 2048 positions,
    do_layer_norm_before)."""
    return serve.ServeModelConfig.from_hf_config(dict(dict(
        model_type="opt", hidden_size=4096, ffn_dim=16384,
        num_attention_heads=32, num_hidden_layers=32, vocab_size=50272,
        max_position_embeddings=2048, do_layer_norm_before=True,
        word_embed_proj_dim=4096), **kw))


def starcoder_config(serve, **kw):
    """bigcode/starcoder's published shape (config.json: n_embd 6144,
    n_head 48, multi_query, n_inner 24576, n_layer 40, vocab_size 49152,
    n_positions 8192)."""
    return serve.ServeModelConfig.from_hf_config(dict(dict(
        model_type="gpt_bigcode", n_embd=6144, n_head=48, n_layer=40,
        multi_query=True, n_inner=24576, vocab_size=49152,
        n_positions=8192, layer_norm_epsilon=1e-5), **kw))


def phase_family_parity(serve, att, torch, dev):
    """MPT-7B and Falcon-7B at full width, 2 layers, f32 (TF32 off): card
    (kernels) vs CPU (plain versions) from the same seeded weights; then
    MPT on the card with int8 and paged caches, each paged run equal to its
    contiguous twin.  Returns {(family, variant): launches}."""
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=512)
    gen = serve.GenerationConfig(max_new_tokens=8)
    launches = {}
    for family, cfg in (
            ("mpt", mpt7b_config(serve, n_layers=2, torch_dtype="float32")),
            ("falcon", falcon7b_config(serve, num_hidden_layers=2,
                                       torch_dtype="float32"))):
        cpu = serve.InferenceManager(serve.build_model(cfg), device="cpu",
                                     **kw)
        cpu.init_operators_inference(seed=5)
        params = {k: p.to(dev) for k, p in cpu.model.named_parameters()}
        gpu = serve.InferenceManager(serve.build_model(cfg), device=dev, **kw)
        gpu.init_operators_inference(params)
        rng = np.random.default_rng(6)
        prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
                   for n in (64, 200)]
        t0 = time.perf_counter()
        want = serve.RequestManager(cpu, gen).generate(prompts)
        t_cpu = time.perf_counter() - t0
        got, n = counted(att, lambda: serve.RequestManager(
            gpu, gen).generate(prompts))
        if got != want:
            raise AssertionError(f"{family}: card tokens {got} != CPU tokens "
                                 f"{want}")
        variant = "fp+alibi" if cfg.use_alibi else "fp"
        require_launches(n, f"{family} parity", variant, (
            ("decode_attention",) if cfg.use_alibi
            else ("decode_attention", "prefill_attention")))
        launches[(family, variant)] = n
        cpu.reset()
        gpu.reset()
        pbc, _ = serve.PrefillBatchConfig.build(
            [(0, prompts[1][:128], 0)], [128], 128, max_tokens=128,
            max_requests=2, device="cpu")
        bc = serve.BatchConfig.build([prompts[1][128]], [0], [128], [129],
                                     max_tokens=128, max_requests=2,
                                     device="cpu")
        errs = []
        for step in (pbc, bc):
            lc = cpu.forward(step)
            lg = gpu.forward(to_device(step, dev)).cpu()
            errs.append((lg - lc).abs().max().item())
            torch.testing.assert_close(lg, lc, atol=1e-3, rtol=1e-3)
        log(f"family parity {family}: 2-layer full-width f32 "
            f"({cfg.num_attention_heads} heads on {cfg.kv_heads} KV heads), "
            f"tokens equal {got[0][:4]}..., max |logit diff| prefill "
            f"{errs[0]:.3e} decode {errs[1]:.3e} (CPU serve {t_cpu:.1f}s); "
            f"launches {short(n)}")
        if cfg.use_alibi:
            # the other ALiBi variants on the card: int8 and paged caches
            outs = {}
            for kv_dtype, page in (("int8", None), (None, 128),
                                   ("int8", 128)):
                var = ("int8" if kv_dtype else "fp") + \
                    ("+paged" if page else "")
                var = var.replace("fp+paged", "paged") + "+alibi"
                im = serve.InferenceManager(
                    serve.build_model(cfg), device=dev, kv_dtype=kv_dtype,
                    kv_page_size=page, **kw)
                im.init_operators_inference(params)
                outs[var], n = counted(att, lambda: serve.RequestManager(
                    im, gen).generate(prompts))
                require_launches(n, f"{family} {var}", var,
                                 ("decode_attention",))
                launches[(family, var)] = n
                del im
            if outs["paged+alibi"] != got or \
                    outs["int8+paged+alibi"] != outs["int8+alibi"]:
                raise AssertionError(f"{family}: a paged run differs from its "
                                     f"contiguous twin: {outs} vs {got}")
            log(f"family parity {family}: paged == contiguous on the card, "
                f"fp and int8 KV; int8 vs fp KV tokens equal share "
                f"{equal_share(outs['int8+alibi'], got):.4f}")
        del cpu, gpu, params
        torch.cuda.empty_cache()
    return launches


def to_device(bc, dev):
    """A batch config (or a prefill config around one) moved to ``dev``."""
    base = bc.base if hasattr(bc, "base") else bc
    moved = dataclasses.replace(base, **{
        f.name: getattr(base, f.name).to(dev)
        for f in dataclasses.fields(base)})
    return dataclasses.replace(bc, base=moved) if hasattr(bc, "base") \
        else moved


def serve_prompts(vocab):
    import numpy as np

    rng = np.random.default_rng(0)
    lens = np.linspace(256, 1800, 8).astype(int).tolist()
    return [rng.integers(3, vocab, size=n).tolist() for n in lens]


class Serving:
    """Timed runs of the 7B serve shape: ``generate`` through a manager
    whose token arrivals are stamped, and windows of ``SpecDecodeScan``."""

    def __init__(self, serve, att, torch, vocab):
        self.serve, self.att, self.torch = serve, att, torch
        self.vocab = vocab
        self.stamps = {}
        stamps = self.stamps

        class Stamped:
            def _append_token(self, req, tok):
                super()._append_token(req, tok)
                stamps.setdefault(req.rid, []).append(time.perf_counter())

        class TimedRM(Stamped, serve.RequestManager):
            pass

        class TimedSpec(Stamped, serve.SpecInferManager):
            rows_verified = 0   # requests summed over the verify passes

            def _verify_phase(self, verifying):
                self.rows_verified += len(verifying)
                super()._verify_phase(verifying)

        self.TimedRM, self.TimedSpec = TimedRM, TimedSpec

    def generate(self, label, manager, prompts, ref=None, n_new=64):
        """``manager.generate(prompts)``, ``n_new`` tokens each; returns
        (streams, launches, mean TTFT s, mean TPOT ms)."""
        self.stamps.clear()
        t0 = time.perf_counter()
        outs, n = counted(self.att, lambda: manager.generate(prompts))
        self.torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_streams(outs, n_new, self.vocab, label)
        ttft, tpot = stream_times(self.stamps, t0)
        extra = ""
        if ref is not None:
            extra = (f", tokens per LLM verify pass per request "
                     f"{(n_new - 1) * len(prompts) / manager.rows_verified:.3f} "
                     f"({manager.llm_steps} passes), equal to incremental "
                     f"{equal_share(outs, ref):.4f}")
        log(f"serve {label}: wall {wall:.2f}s, "
            f"{sum(map(len, outs)) / wall:.1f} tok/s{extra}; launches "
            f"{short(n)}")
        log(f"serve {label}: TTFT s " + " ".join(f"{x:.3f}" for x in ttft)
            + " | TPOT ms " + " ".join(f"{x:.2f}" for x in tpot))
        return outs, n, sum(ttft) / len(ttft), sum(tpot) / len(tpot)

    def scan(self, label, llm, ssm, prompts, width, depth, window, ref,
             n_new=64):
        """Prefill (held), then windows of ``window`` macro steps (one
        read-back each) until every request has its ``n_new`` tokens."""
        import numpy as np

        n_req = len(prompts)
        llm.reset()
        ssm.reset()
        t0 = time.perf_counter()
        firsts = held_firsts(self.serve, llm, prompts)
        held_firsts(self.serve, ssm, prompts)
        t_prefill = time.perf_counter() - t0
        lens = [len(p) for p in prompts]
        sc = self.serve.SpecDecodeScan(llm, ssm, width=width, depth=depth)
        carry = sc.init_carry(firsts, lens, lens, [False] * n_req,
                              budget=[n_new - 1] * n_req)
        ems = []

        def loop(carry):
            while not bool(carry["finished"].all()):
                em, carry = sc.run(carry, window)
                ems.append(em.cpu().numpy())

        t0 = time.perf_counter()
        _, n = counted(self.att, lambda: loop(carry))
        wall = time.perf_counter() - t0
        release_held((llm, ssm), n_req)
        em = np.concatenate(ems)
        outs = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1)
                               if t >= 0] for i in range(n_req)]
        check_streams(outs, n_new, self.vocab, label)
        # macro steps each request took part in: one LLM pass each
        took = [int(np.nonzero((em[:, i] >= 0).any(1))[0].max()) + 1
                for i in range(n_req)]
        after = n_new - 1
        log(f"serve {label}: prefill {t_prefill:.2f}s, {len(em)} macro "
            f"steps in {len(ems)} windows {wall:.2f}s, "
            f"{after * n_req / wall:.1f} tok/s after the first token, TPOT "
            f"{1e3 * wall / after:.2f} ms, tokens per LLM pass per request "
            f"{after * n_req / sum(took):.3f}, equal to incremental "
            f"{equal_share(outs, ref):.4f}; launches {short(n)}")
        return outs, n


def perfect_draft(serve, im, cfg, kw):
    """Zero the LLM's upper layers' o_proj/down_proj, so a 2-layer model
    sharing its embedding, first two layers, final norm and head predicts
    its argmax; returns that draft's manager (top-1)."""
    import torch

    lm = im.model
    with torch.no_grad():
        for layer in lm.model.layers[2:]:
            layer.self_attn.o_proj.zero_()
            layer.mlp.down_proj.kernel.zero_()
    pmodel = serve.build_model(dataclasses.replace(cfg, num_hidden_layers=2))
    pmodel.model.embed_tokens = lm.model.embed_tokens
    pmodel.model.layers = lm.model.layers[:2]
    pmodel.model.norm = lm.model.norm
    pmodel.lm_head = lm.lm_head
    perfect = serve.InferenceManager(pmodel, topk=1, **kw)
    return perfect.init_operators_inference(dict(pmodel.named_parameters()))


def phase_serve(serve, att, torch, dev):
    """The published Llama-2-7B shape, 8 requests: incremental, then
    speculative on the host and on the device with a llama-68m-shaped
    draft (width 2, depth 3), then both with a perfect draft (width 1,
    depth 5, as bench.py's ceiling row).  Returns ({path: launches}, mean
    TTFT s and TPOT ms of the incremental run)."""
    cfg = serve.ServeModelConfig(dtype="bfloat16")   # Llama-2-7B defaults
    kw = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
              max_spec_tokens=8, device=dev)
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), **kw)
    im.init_operators_inference(seed=0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    log(f"serve: 7B bf16 init {t_init:.1f}s, weights "
        f"{w_bytes / 1e9:.2f} GB, KV cache + spec buffers "
        f"{im.kv.allocated_bytes() / 1e9:.2f} GB, prefill tile "
        f"{im.prefill_tile}")
    run = Serving(serve, att, torch, cfg.vocab_size)
    prompts = serve_prompts(cfg.vocab_size)
    gen = serve.GenerationConfig(max_new_tokens=64)
    launches = {}

    torch.cuda.reset_peak_memory_stats()
    incr, launches["incremental"], ttft, tpot = run.generate(
        "incremental", run.TimedRM(im, gen), prompts)
    require_launches(launches["incremental"], "incremental", "fp",
                     ("decode_attention", "prefill_attention"))
    # the step logits the last stretch was drawn from are finite
    logits = im.forward(serve.BatchConfig.build(
        [incr[0][-1]], [0], [len(prompts[0]) + 63],
        [len(prompts[0]) + 64], max_tokens=512, max_requests=8, device=dev))
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")

    draft = serve.InferenceManager(
        serve.build_model(draft_config(serve, "bfloat16")), topk=2, **kw)
    draft.init_operators_inference(seed=1)
    im.reset()
    _, launches["spec host"], _, _ = run.generate(
        "spec host (llama-68m draft)",
        run.TimedSpec(im, draft, gen, width=2, depth=3), prompts, incr)
    _, launches["spec device"] = run.scan(
        "spec device (llama-68m draft)", im, draft, prompts, 2, 3, 63, incr)
    require_launches(launches["spec host"], "spec host", "fp",
                     ("tree_attention",))
    require_launches(launches["spec device"], "spec device", "fp",
                     ("tree_attention_batched",))
    del draft
    torch.cuda.empty_cache()

    perfect = perfect_draft(serve, im, cfg, kw)
    im.reset()
    incr_p, _, _, _ = run.generate("incremental (LLM of the perfect draft)",
                                   run.TimedRM(im, gen), prompts)
    im.reset()
    run.generate("spec host (perfect draft)",
                 run.TimedSpec(im, perfect, gen, width=1, depth=5), prompts,
                 incr_p)
    run.scan("spec device (perfect draft)", im, perfect, prompts, 1, 5, 11,
             incr_p)
    log(f"serve: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches, ttft, tpot


def phase_serve_int8(serve, att, torch, dev, bf16_ttft, bf16_tpot):
    """The Llama-2-7B shape with int8 weights, int8 KV and 512-position
    pages: the 8 prompts; two sessions sharing a 1024-token system prefix;
    the device speculative loop with the perfect draft."""
    import numpy as np

    cfg = serve.ServeModelConfig(dtype="bfloat16")
    kw = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
              max_spec_tokens=8, device=dev, kv_dtype="int8",
              kv_page_size=PAGE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), **kw)
    im.init_operators_inference(seed=0)    # bf16 weights, then int8
    n_q = serve.quantize_int8(im)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    log(f"int8 serve: 7B, {n_q} int8 weight matrices, init {t_init:.1f}s "
        f"(max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB with the bf16 weights), weights {w_bytes / 1e9:.2f} GB, int8 "
        f"KV cache + scales + spec buffers "
        f"{im.kv.allocated_bytes() / 1e9:.2f} GB, page {PAGE}, "
        f"{im.kv.n_pages - 1} pages")
    torch.cuda.reset_peak_memory_stats()
    run = Serving(serve, att, torch, cfg.vocab_size)
    prompts = serve_prompts(cfg.vocab_size)
    gen = serve.GenerationConfig(max_new_tokens=64)
    launches = {}

    incr, launches["incremental"], ttft, tpot = run.generate(
        "int8 incremental", run.TimedRM(im, gen), prompts)
    require_launches(launches["incremental"], "int8 incremental",
                     "int8+paged", ("decode_attention", "prefill_attention"))
    log(f"int8 serve: mean TTFT {ttft:.3f}s (bf16 {bf16_ttft:.3f}s), mean "
        f"TPOT {tpot:.2f} ms (bf16 {bf16_tpot:.2f} ms, x{tpot / bf16_tpot:.2f}"
        f"), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # two sessions of prompts sharing a 1024-token system prefix
    rng = np.random.default_rng(4)
    system = rng.integers(3, cfg.vocab_size, size=1024).tolist()
    sessions = [[system + rng.integers(3, cfg.vocab_size, size=int(n))
                 .tolist() for n in np.linspace(64, 896, 8)]
                for _ in range(2)]
    im.reset()
    results = []
    for i, ps in enumerate(sessions + [sessions[1]]):
        if i == 2:
            im.reset()                 # an empty prefix index
        hits0 = im.kv.prefix_hits
        rm = run.TimedRM(im, gen)
        outs, n, s_ttft, _ = run.generate(f"int8 prefix session {i}", rm, ps)
        require_launches(n, f"int8 prefix session {i}", "int8+paged",
                         ("decode_attention", "prefill_attention"))
        cached = [r.prefix_cached for r in rm.requests.values()]
        results.append((outs, s_ttft, sum(map(len, ps)) - sum(cached),
                        cached, im.kv.prefix_hits - hits0))
    (out0, ttft0, fed0, _, _), (out1, ttft1, fed1, cached1, hits1), \
        (out2, ttft2, fed2, _, _) = results
    if hits1 != 8 or cached1 != [1024] * 8:
        raise AssertionError(f"second session: {hits1} prefix hits, cached "
                             f"{cached1} (want 8 x 1024)")
    if out1 != out2:
        raise AssertionError("the second session's tokens differ from a run "
                             "of the same prompts with an empty index")
    log(f"int8 prefix sessions: session 0 TTFT {ttft0:.3f}s, prefilled "
        f"{fed0} tokens; session 1 TTFT {ttft1:.3f}s, prefilled {fed1} "
        f"tokens ({hits1} prefix hits, 1024 cached each), tokens equal to an "
        f"empty-index run (TTFT {ttft2:.3f}s, prefilled {fed2}); pool "
        f"{im.kv.snapshot()}")

    perfect = perfect_draft(serve, im, cfg, kw)
    im.reset()
    incr_p, _, _, _ = run.generate("int8 incremental (LLM of the perfect "
                                   "draft)", run.TimedRM(im, gen), prompts)
    _, launches["spec device"] = run.scan(
        "int8 spec device (perfect draft)", im, perfect, prompts, 1, 5, 11,
        incr_p)
    require_launches(launches["spec device"], "int8 spec device",
                     "int8+paged", ("tree_attention_batched",
                                    "tree_attention"))
    log(f"int8 serve: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return launches


def phase_serve_mpt(serve, att, torch, dev):
    """MPT-7B's published shape at full depth, bf16, seeded random weights:
    the 8 prompts of the Llama serve phase, 64 new tokens, through
    ``RequestManager.generate``, on fp caches, then on int8 KV with
    512-position pages; only K1's ALiBi variants launch (prefill goes
    through K1).  Returns {variant: launches}."""
    cfg = mpt7b_config(serve, torch_dtype="bfloat16")
    prompts = serve_prompts(cfg.vocab_size)
    gen = serve.GenerationConfig(max_new_tokens=64)
    run = Serving(serve, att, torch, cfg.vocab_size)
    launches = {}
    for kv_dtype, page, var in ((None, None, "fp+alibi"),
                                ("int8", PAGE, "int8+paged+alibi")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        im = serve.InferenceManager(
            serve.build_model(cfg), max_requests=8, max_tokens_per_batch=512,
            max_seq_len=2048, device=dev, kv_dtype=kv_dtype,
            kv_page_size=page)
        im.init_operators_inference(seed=0)     # the same weights twice
        torch.cuda.synchronize()
        w_bytes = sum(p.numel() * p.element_size()
                      for p in im.model.parameters())
        log(f"mpt serve {var}: MPT-7B bf16 ({cfg.num_hidden_layers} layers, "
            f"hidden {cfg.hidden_size}, ffn {cfg.intermediate_size}, vocab "
            f"{cfg.vocab_size}) init {time.perf_counter() - t0:.1f}s, "
            f"weights {w_bytes / 1e9:.2f} GB, KV cache "
            f"{im.kv.allocated_bytes() / 1e9:.2f} GB")
        outs, n, ttft, tpot = run.generate(f"mpt-7b {var}",
                                           run.TimedRM(im, gen), prompts)
        require_launches(n, f"mpt-7b {var}", var, ("decode_attention",))
        launches[var] = n
        log(f"mpt serve {var}: mean TTFT {ttft:.3f}s, mean TPOT "
            f"{tpot:.2f} ms, K1 launches {n[('decode_attention', var)]}, K2 "
            f"launches {sum(c for (k, _), c in n.items() if k == 'prefill_attention')}"
            f", max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del im
        torch.cuda.empty_cache()
    return launches


def phase_serve_families(serve, att, torch, dev):
    """OPT-6.7B and StarCoder at full width, 2 layers, bf16, seeded random
    weights: the 8 prompts, 16 new tokens each; every request finishes
    with in-range tokens, and K1 and K2 launch.  Returns {family:
    launches}."""
    gen = serve.GenerationConfig(max_new_tokens=16)
    launches = {}
    for family, cfg in (
            ("opt-6.7b", opt67b_config(serve, num_hidden_layers=2,
                                       torch_dtype="bfloat16")),
            ("starcoder", starcoder_config(serve, n_layer=2,
                                           torch_dtype="bfloat16"))):
        im = serve.InferenceManager(
            serve.build_model(cfg), max_requests=8, max_tokens_per_batch=512,
            max_seq_len=2048, device=dev)
        im.init_operators_inference(seed=0)
        prompts = serve_prompts(cfg.vocab_size)
        t0 = time.perf_counter()
        outs, n = counted(att, lambda: serve.RequestManager(
            im, gen).generate(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_streams(outs, 16, cfg.vocab_size, family)
        require_launches(n, family, "fp",
                         ("decode_attention", "prefill_attention"))
        launches[family] = n
        log(f"serve {family}: 2 layers at full width ({cfg.hidden_size} "
            f"hidden, {cfg.num_attention_heads} heads on {cfg.kv_heads} KV "
            f"heads, ffn {cfg.intermediate_size}), bf16: 8 requests x 16 "
            f"tokens in {wall:.2f}s; launches {short(n)}")
        del im
        torch.cuda.empty_cache()
    return launches


def phase_serve_f32(serve, att, torch, dev):
    """The published Llama-2-7B shape in float32 (TF32 off for the GEMMs),
    the 8 prompts, 16 new tokens each: incremental (f32 K2 on the
    prefill, f32 K1 on the decode steps), then ``SpecInferManager`` (f32
    K3 per-token on the verify) and ``SpecDecodeScan`` (f32 K3 batched on
    the verify) with the llama-68m-shaped draft.  Returns {path:
    launches}."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve.ServeModelConfig(dtype="float32")   # Llama-2-7B defaults
    kw = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
              max_spec_tokens=8, device=dev)
    n_new = 16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), **kw)
    im.init_operators_inference(seed=0)
    torch.cuda.synchronize()
    w_bytes = sum(p.numel() * p.element_size()
                  for p in im.model.parameters())
    log(f"f32 serve: 7B f32 init {time.perf_counter() - t0:.1f}s, weights "
        f"{w_bytes / 1e9:.2f} GB, KV cache + spec buffers "
        f"{im.kv.allocated_bytes() / 1e9:.2f} GB")
    run = Serving(serve, att, torch, cfg.vocab_size)
    prompts = serve_prompts(cfg.vocab_size)
    gen = serve.GenerationConfig(max_new_tokens=n_new)
    launches = {}
    incr, launches["incremental"], ttft, tpot = run.generate(
        "f32 incremental", run.TimedRM(im, gen), prompts, n_new=n_new)
    require_launches(launches["incremental"], "f32 incremental", "fp",
                     ("decode_attention", "prefill_attention"))
    draft = serve.InferenceManager(
        serve.build_model(draft_config(serve, "float32")), topk=2, **kw)
    draft.init_operators_inference(seed=1)
    im.reset()
    _, launches["spec host"], _, spec_tpot = run.generate(
        "f32 spec host (llama-68m draft)",
        run.TimedSpec(im, draft, gen, width=2, depth=3), prompts, incr,
        n_new=n_new)
    require_launches(launches["spec host"], "f32 spec host", "fp",
                     ("tree_attention",))
    _, launches["spec device"] = run.scan(
        "f32 spec device (llama-68m draft)", im, draft, prompts, 2, 3, 15,
        incr, n_new=n_new)
    require_launches(launches["spec device"], "f32 spec device", "fp",
                     ("tree_attention_batched", "tree_attention"))
    log(f"f32 serve: mean TTFT {ttft:.3f}s, mean TPOT {tpot:.2f} ms "
        f"(spec host {spec_tpot:.2f} ms), max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del im, draft
    torch.cuda.empty_cache()
    return launches


HOST_LINK_BYTES_PER_S = 64e9   # PCIe 5.0 x16, one direction (the spec)


class StateClock:
    """A virtual clock for ``serve_with_arrivals``: each reading advances
    ``tick`` seconds, and each trigger ``(ready, fn)`` runs ``fn`` once, at
    the first reading at which ``ready()`` holds."""

    def __init__(self, tick=1e-3):
        self.t = 0.0
        self.tick = tick
        self.triggers = []

    def when(self, ready, fn):
        self.triggers.append([ready, fn])

    def __call__(self):
        self.t += self.tick
        for trig in self.triggers:
            if trig[1] is not None and trig[0]():
                fn, trig[1] = trig[1], None
                fn()
        return self.t


def lifecycle_traffic(serve, rm, clock, prompts, n_new, vocab):
    """The arrivals of the lifecycle phase and their triggers: the 8
    prompts at t=0; a 9th at t=0 whose TTL expires in the queue; two
    priority-5 arrivals at t=1000, which the clock jumps to once every
    slot decodes, each preempting a row; and a cancel of request 0 once it
    holds 4 tokens.  Returns (arrivals, the priority-5 prompts)."""
    import numpy as np

    rng = np.random.default_rng(9)
    ttl_prompt, *urgent = [rng.integers(3, vocab, size=n).tolist()
                           for n in (300, 900, 1400)]
    arrivals = ([(0.0, p, n_new) for p in prompts]
                + [(0.0, ttl_prompt, n_new, {"ttl_s": 0.005})]
                + [(1000.0, p, n_new, {"priority": 5}) for p in urgent])
    first = range(len(prompts))
    clock.when(lambda: all(r in rm.requests and rm.requests[r].status is
                           serve.RequestStatus.DECODING for r in first),
               lambda: setattr(clock, "t", max(clock.t, 1000.0)))
    clock.when(lambda: 0 in rm.requests
               and len(rm.requests[0].generated) >= 4,
               lambda: rm.cancel(0))
    return arrivals, urgent


def phase_serve_lifecycle(serve, att, torch, dev):
    """The request lifecycle on the published Llama-2-7B shape in float32
    (TF32 off), 512-position pages, 8 slots, an 8 GiB host page tier and
    seeded ``decode_scan`` faults: ``serve_with_arrivals`` serves the 8
    prompts, 16 new tokens each, a request whose TTL expires in the queue,
    two priority-5 arrivals that preempt two rows (their pages spill to
    the tier; a flush of the prefix index at each preemption stands for a
    busy pool's churn, so the readmissions restore from the tier instead
    of hitting their own released pages), and a cancel.  The oracle is
    the same deployment after ``im.reset()``: a plain ``generate`` of the
    10 prompts served.  Returns the path's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve.ServeModelConfig(dtype="float32")   # Llama-2-7B defaults
    n_new = 16
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    im = serve.InferenceManager(
        serve.build_model(cfg), max_requests=8, max_tokens_per_batch=512,
        max_seq_len=2048, kv_page_size=PAGE, device=dev)
    im.init_operators_inference(seed=0)
    kv = im.kv
    res = serve.ResilienceConfig(
        preemption=True, host_tier_bytes=8 << 30,
        retry=serve.RetryPolicy(max_retries=2, backoff_s=0.0))
    # seed 1 draws under 0.3 at its 3rd and 5th decode_scan dispatch (the
    # phase makes 7; seed 0's first such draw is its 15th)
    inj = serve.FaultInjector(seed=1, p_by_site={"decode_scan": 0.3},
                              max_faults=2)
    rm = serve.RequestManager(im, serve.GenerationConfig(
        max_new_tokens=n_new), resilience=res, fault_injector=inj)
    rm.scan_chunk = 2   # decode stretches of 2 steps: 7 dispatches
    swaps = {"spill": [], "restore": []}

    def timed(kind, fn):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = fn(*args, **kw)
            torch.cuda.synchronize()
            if info:
                swaps[kind].append((time.perf_counter() - t0, info["pages"],
                                    info["nbytes"]))
            return info
        return run

    kv.spill = timed("spill", kv.spill)
    kv.restore = timed("restore", kv.restore)
    preempt = rm.preempt

    def preempt_under_churn(rid):
        preempt(rid)
        for key in list(kv._entries):
            kv._drop_entry(key)

    rm.preempt = preempt_under_churn
    clock = StateClock()
    prompts = serve_prompts(cfg.vocab_size)
    arrivals, urgent = lifecycle_traffic(serve, rm, clock, prompts, n_new,
                                         cfg.vocab_size)
    t0 = time.perf_counter()
    records, n = counted(att, lambda: rm.serve_with_arrivals(
        arrivals, clock=clock, quantum=2))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_launches(n, "lifecycle", "paged",
                     ("decode_attention", "prefill_attention"))
    outcomes = [records[r]["outcome"] for r in sorted(records)]
    expected = ["cancelled"] + ["ok"] * 7 + ["timeout", "ok", "ok"]
    if outcomes != expected:
        raise AssertionError(f"lifecycle outcomes {outcomes} != {expected}")
    snap = kv.snapshot()
    preemptions = sum(r.preemptions for r in rm.requests.values())
    counts = {"preemptions": preemptions,
              "pages_spilled": snap["pages_spilled"],
              "pages_restored": snap["pages_restored"],
              "recompute_tokens_saved": snap["recompute_tokens_saved"],
              "faults_injected": inj.injected,
              "retries": rm.retries["decode_scan"]}
    if preemptions < 2 or min(counts.values()) < 1:
        raise AssertionError(f"lifecycle counters: {counts}")
    if snap["restore_failures"]:
        raise AssertionError(f"{snap['restore_failures']} restore failures")
    # the oracle: the served prompts on the same deployment, uninterrupted
    kv.attach_host_tier(0)
    im.reset()
    served = prompts + urgent
    t_oracle = time.perf_counter()
    want = serve.RequestManager(im, serve.GenerationConfig(
        max_new_tokens=n_new)).generate(served)
    t_oracle = time.perf_counter() - t_oracle
    got = [records[r]["tokens"] for r in sorted(records) if r != 8]
    for i, (g, w) in enumerate(zip(got, want)):
        ok = g == w if i else (0 < len(g) < n_new and g == w[:len(g)])
        if not ok:
            raise AssertionError(f"lifecycle stream {i}: {g} vs the "
                                 f"uninterrupted {w}")
    check_streams(want, n_new, cfg.vocab_size, "lifecycle oracle")
    log(f"lifecycle: 7B f32, 512-position pages: wall {wall:.2f}s (oracle "
        f"{t_oracle:.2f}s); outcomes {outcomes}; {counts}, restore "
        f"failures 0, swap bytes {snap['swap_bytes']}; launches {short(n)}")
    for kind, runs in swaps.items():
        pages = sum(p for _, p, _ in runs)
        nbytes = sum(b for _, _, b in runs)
        secs = sum(s for s, _, _ in runs)
        log(f"lifecycle {kind}: {len(runs)} calls, {pages} pages, {nbytes} "
            f"bytes in {secs * 1e3:.3f} ms: {secs * 1e3 / max(pages, 1):.3f} "
            f"ms per page (D2H or H2D, CRC, page table), bound "
            f"{nbytes / max(pages, 1) / HOST_LINK_BYTES_PER_S * 1e3:.3f} ms "
            f"per page over the host link")
    # one page's parts, three times: the copy out into its pinned blocks,
    # the checksum, the copy in
    page = kv._read_page(0)
    parts = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for blk, src in zip(page.blocks, kv._page_blocks(0)):
            blk.copy_(src, non_blocking=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        page.verify()
        t2 = time.perf_counter()
        kv._write_page(0, page)
        torch.cuda.synchronize()
        parts.append((t1 - t0, t2 - t1, time.perf_counter() - t2))
    bound = page.nbytes / HOST_LINK_BYTES_PER_S * 1e3
    for label, i in (("D2H copy", 0), ("CRC32", 1), ("H2D copy", 2)):
        log(f"lifecycle page {label}: " + " / ".join(
            f"{p[i] * 1e3:.3f}" for p in parts) + f" ms for {page.nbytes} "
            f"bytes (bound {bound:.3f} ms over the host link)")
    log(f"lifecycle: phase wall {time.perf_counter() - t_phase:.1f}s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del im, rm, page
    torch.cuda.empty_cache()
    return n


class PassClock:
    """A virtual clock for ``serve_with_arrivals`` that counts model
    passes: each pass of ``im.run_step`` (a prefill chunk, a decode step,
    a joiner's flat prefill step) advances it ``pass_s`` seconds, and each
    reading ``tick_s`` more, so two serve paths on the same arrivals are
    compared in passes, not in the host's time.  ``attach`` counts the
    passes of more deployments (a fleet's replicas, a migration's
    successor: one card runs them in turn); each trigger ``(ready, fn)``
    runs ``fn`` once, at the first reading at which ``ready()`` holds."""

    def __init__(self, im=None, pass_s=1e-3, tick_s=1e-6):
        self.t = 0.0
        self.passes = 0
        self.pass_s, self.tick_s = pass_s, tick_s
        self.triggers = []
        if im is not None:
            self.attach(im)

    def attach(self, im):
        run_step = im.run_step

        def counted(*args, **kw):
            self.t += self.pass_s
            self.passes += 1
            return run_step(*args, **kw)

        im.run_step = counted
        return im

    def when(self, ready, fn):
        self.triggers.append([ready, fn])

    def __call__(self):
        self.t += self.tick_s
        for trig in self.triggers:
            if trig[1] is not None and trig[0]():
                fn, trig[1] = trig[1], None
                fn()
        return self.t


def api_traffic(prompts, n_new, max_tokens):
    """The first 4 prompts at t=0; the other 4 due one pass after the
    first 4's prefill chunks, once those decode."""
    chunks = sum(-(-len(p) // max_tokens) for p in prompts[:4])
    late = (chunks + 1.5) * 1e-3
    return ([(0.0, p, n_new) for p in prompts[:4]]
            + [(late, p, n_new) for p in prompts[4:]])


def phase_api_default(serve, att, torch, dev):
    """The reference's default serve path through the user's entry point:
    ``LLM(ServeModelConfig(...)).compile(max_requests=8,
    max_tokens_per_batch=512, max_seq_len=2048)`` on the published
    Llama-2-7B shape in float32 (TF32 off), LM-head gating and the chained
    stretch on (the defaults).  ``serve_with_arrivals`` on a pass-counting
    clock: 4 prompts at t=0, 4 more due once those decode, which join the
    running stretch.  The oracle is the same deployment with
    ``gate_lm_head`` and ``chain_segments`` off: streams equal, joins > 0,
    one read-back per chained stretch, K1 and K2 launched.  Then the
    prefill stretch of the 8 prompts gated against ungated, and the LM head
    alone; then ``ssms=[SSM(draft)]`` at 2 layers of full width: seeded
    sampling at T=0.8 twice (equal), and T=1e-4 equal to greedy.  Returns
    {path: launches}."""
    import collections
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = serve.ServeModelConfig(dtype="float32")   # Llama-2-7B defaults
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    n_new = 16
    # the earlier phases' managers sit in reference cycles (their wrapped
    # methods): collect them before the 7B f32 deployment is built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"api default: {torch.cuda.memory_allocated() / 1e9:.2f} GB held "
        f"before the build")
    t_phase = time.perf_counter()
    llm = serve.LLM(cfg).compile(device=dev, **caps)
    im, rm = llm.im, llm.rm
    if not (im.gate_lm_head and rm.chain_segments):
        raise AssertionError("LLM.compile's defaults: gating and chaining")
    prompts = serve_prompts(cfg.vocab_size)
    arrivals = api_traffic(prompts, n_new, caps["max_tokens_per_batch"])
    stretches = []
    inner = rm._decode_stretch

    def stretch(n):
        before = rm.readbacks
        inner(n)
        stretches.append((rm.readbacks - before, dict(rm.last_stretch),
                          dict(rm.last_exit_codes)))

    rm._decode_stretch = stretch
    launches = {}
    t0 = time.perf_counter()
    rec, launches["chained"] = counted(att, lambda: rm.serve_with_arrivals(
        arrivals, clock=PassClock(im)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require_launches(launches["chained"], "api default (chained, gated)",
                     "fp", ("decode_attention", "prefill_attention"))
    # the oracle: the same weights, gating and chaining off
    im.reset()
    im.gate_lm_head = False
    oracle = serve.RequestManager(im, rm.gen)
    oracle.chain_segments = False
    t0 = time.perf_counter()
    want, launches["oracle"] = counted(att, lambda: oracle.serve_with_arrivals(
        arrivals, clock=PassClock(im)))
    torch.cuda.synchronize()
    wall_oracle = time.perf_counter() - t0
    im.gate_lm_head = True
    got = [rec[r]["tokens"] for r in sorted(rec)]
    if got != [want[r]["tokens"] for r in sorted(want)]:
        raise AssertionError("api default: the chained, gated streams differ "
                             "from the oracle's")
    if any(not 0 < len(s) <= n_new or not all(0 <= t < cfg.vocab_size
                                              for t in s) for s in got):
        raise AssertionError(f"api default: bad streams {got}")
    joins = sum(s["joins"] for _, s, _ in stretches)
    if not stretches or joins < 1 or any(n != 1 for n, _, _ in stretches):
        raise AssertionError(f"api default: stretches {stretches}")
    codes = collections.Counter(c for _, _, ex in stretches
                                for c in ex.values())
    names = {serve.EXIT_RUNNING: "running", serve.EXIT_EOS: "eos",
             serve.EXIT_BUDGET: "budget"}
    log(f"api default: 7B f32, gated + chained: {len(stretches)} stretches, "
        f"segments {[s['segments'] for _, s, _ in stretches]}, steps "
        f"{[s['steps'] for _, s, _ in stretches]}, joins {joins}, read-backs "
        f"per stretch {[n for n, _, _ in stretches]}, exit codes "
        f"{ {names[c]: k for c, k in codes.items()} }; read-backs in all "
        f"{rm.readbacks} (oracle {oracle.readbacks}, {oracle.scan_runs} "
        f"stretches); wall {wall:.2f}s (oracle {wall_oracle:.2f}s); streams "
        f"equal the oracle's; launches {short(launches['chained'])} (oracle "
        f"{short(launches['oracle'])})")
    for r in sorted(rec)[4:]:
        ttft = [(d[r]["first_token_s"] - d[r]["arrival_s"]) * 1e3
                for d in (rec, want)]
        log(f"api default: joiner {r} ({rec[r]['prompt_len']} tokens) TTFT "
            f"{ttft[0]:.3f} passes chained (prefill start "
            f"{(rec[r]['prefill_start_s'] - rec[r]['arrival_s']) * 1e3:.3f}) "
            f"vs {ttft[1]:.3f} unchained, on the pass clock")
    # the prefill stretch of the 8 prompts, gated and ungated, and the LM
    # head alone: events around one call (the f32 GEMMs keep the device
    # busy), the head by device time
    tile = im.prefill_tile
    mt = caps["max_tokens_per_batch"]
    times = {}
    for gate in (False, True):
        chunks = []
        for slot, p in enumerate(prompts):
            for at in range(0, len(p), mt):
                take = min(mt, len(p) - at)
                seq = [0] * 8
                seq[slot] = at + take
                done = at + take == len(p)
                chunks.append(serve.PrefillBatchConfig.build(
                    [(slot, p[at: at + take], at)], seq, tile,
                    max_tokens=mt, max_requests=8, device=dev,
                    gate_slots=([slot] if done else []) if gate
                    else None)[0])
        im.reset()
        times[gate] = call_ms(lambda c=chunks: im.prefill_scan(c), 1)
    x = torch.randn(mt, cfg.hidden_size, device=dev)
    head = {n: time_ms(lambda r=n: im.model.lm_head(x[:r]), 10)
            for n in (mt, 8)}
    n_chunks = len(chunks)
    log(f"api default: prefill stretch of the 8 prompts ({n_chunks} chunks "
        f"of {mt}), 7B f32: ungated {times[False]:.3f} ms, gated "
        f"{times[True]:.3f} ms (events around one call); LM head "
        f"[{mt}, 4096] x [4096, 32000] {head[mt]:.6f} ms, gathered "
        f"[8, 4096] {head[8]:.6f} ms (device): {n_chunks} heads "
        f"{n_chunks * head[mt]:.3f} ms, "
        f"{n_chunks * head[mt] / times[False]:.4f} of the ungated stretch")
    del llm, rm, oracle, im, chunks, x, stretch, inner
    gc.collect()
    torch.cuda.empty_cache()
    # SpecInfer through the API: 2 layers of full width and the
    # llama-68m-shaped draft, seeded sampling
    wide = dataclasses.replace(cfg, num_hidden_layers=2)
    sprompts = [p[:300] for p in prompts]

    def spec(temperature, ssm=True):
        gen = serve.GenerationConfig(max_new_tokens=n_new,
                                     temperature=temperature, seed=7)
        api = serve.LLM(wide).compile(
            device=dev, generation_config=gen,
            ssms=[serve.SSM(draft_config(serve, "float32"))] if ssm else (),
            **caps)
        return counted(att, lambda: api.generate(sprompts))

    a, launches["spec"] = spec(0.8)
    require_launches(launches["spec"], "api spec (T=0.8)", "fp",
                     ("tree_attention",))
    b, _ = spec(0.8)
    if a != b:
        raise AssertionError("api spec: two seeded runs differ")
    tiny, _ = spec(1e-4)
    greedy, _ = spec(0.0)
    if tiny != greedy:
        raise AssertionError("api spec: T=1e-4 differs from greedy")
    incr, _ = spec(0.8, ssm=False)
    log(f"api spec: 2-layer 7B-width f32 + llama-68m draft, T=0.8 seed 7: "
        f"two runs equal, T=1e-4 equal to greedy; equal to sampled "
        f"incremental {equal_share(a, incr):.4f} (greedy vs T=0.8 "
        f"{equal_share(greedy, a):.4f}); launches {short(launches['spec'])}")
    log(f"api default: phase wall {time.perf_counter() - t_phase:.1f}s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    torch.cuda.empty_cache()
    return launches


def mixed_traffic(prompts, n_new):
    """The 8 prompts in pairs, 4 passes apart, alternating ``{"spec":
    True}`` and ``{"spec": False}``."""
    return [((i // 2) * 4e-3, p, n_new, {"spec": i % 2 == 0})
            for i, p in enumerate(prompts)]


def narrow_draft_config(serve, family):
    """A narrow draft of each family (1 layer, hidden 1024, the family's
    attention layout and vocab)."""
    f32 = dict(torch_dtype="float32")
    if family == "mpt":
        return mpt7b_config(serve, d_model=1024, n_heads=8, n_layers=1,
                            **f32)
    if family == "falcon":
        return falcon7b_config(serve, hidden_size=1024,
                               num_attention_heads=16, num_hidden_layers=1,
                               **f32)
    if family == "opt":
        return opt67b_config(serve, hidden_size=1024, ffn_dim=4096,
                             num_attention_heads=16, num_hidden_layers=1,
                             word_embed_proj_dim=1024, **f32)
    return starcoder_config(serve, n_embd=1024, n_head=8, n_layer=1,
                            n_inner=4096, **f32)


def spec_mixed_7b(serve, att, torch, dev, n_new=16):
    """Phase 14's 7B part: Llama-2-7B f32 through ``LLM.compile(ssms=
    [SSM(draft)])``, mixed spec and plain arrivals with flips, then
    ``SpecDecodeScan`` with a spec mask and a perfect draft.  Returns
    {path: launches}."""
    import numpy as np

    cfg = serve.ServeModelConfig(dtype="float32")   # Llama-2-7B defaults
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    gen = serve.GenerationConfig(max_new_tokens=n_new)
    llm = serve.LLM(cfg).compile(
        device=dev, generation_config=gen,
        ssms=[serve.SSM(draft_config(serve, "float32"))], **caps)
    im, rm = llm.im, llm.rm
    prompts = serve_prompts(cfg.vocab_size)
    launches = {}
    want, launches["oracle"] = counted(att, lambda: serve.RequestManager(
        im, rm.gen).generate(prompts))
    im.reset()
    rm.ssm.reset()
    live_states = (serve.RequestStatus.PREFILLING,
                   serve.RequestStatus.DECODING)
    st = dict(ticks=0, off=[], on=None, hwm=0, flush_tick=None,
              rows={"spec": [0, 0], "plain": [0, 0]})
    tick, sync, verify = rm._tick, rm._sync_kv, rm._verify_phase

    def hooked_tick():
        live = [r for r in rm._active()
                if r.status is serve.RequestStatus.DECODING]
        if not st["off"] and st["ticks"] >= 3 and any(
                r.spec and r.pending_commit for r in live):
            # every slotted spec row off: the next tick leaves speculation
            for r in rm._active():
                if r.spec:
                    rm.set_spec_mode(r.rid, False)
                    st["off"].append((r.rid, len(r.pending_commit)))
        elif st["off"] and st["on"] is None and rm.flushes:
            # a row that arrived plain, mid-decode
            was_spec = {rid for rid, _ in st["off"]}
            plain = [r for r in live if not r.spec and r.rid % 2
                     and r.rid not in was_spec
                     and len(r.generated) < n_new - 4]
            if plain:
                r = plain[0]
                rm.set_spec_mode(r.rid, True)
                st["on"] = (r.rid, len(r.generated), r.ssm_committed,
                            len(r.ssm_backlog))
        flushes = rm.flushes
        tick()
        if rm.flushes > flushes and st["flush_tick"] is None:
            st["flush_tick"] = st["ticks"]
        st["ticks"] += 1

    def hooked_sync():
        sync()
        snap = rm.kv_snapshot()
        live = [r for r in rm._active() if r.status in live_states]
        expect = sum(r.seq_len + r.ssm_committed for r in live)
        if (snap["live_tokens"] != expect or snap["occupancy_frac"]
                != expect / snap["capacity_tokens"]):
            raise AssertionError(f"spec mixed: KV gauges {snap} disagree "
                                 f"with the live depths ({expect} tokens)")
        st["hwm"] = max(st["hwm"], expect)

    def hooked_verify(verifying):
        before = {r.rid: (r.spec, len(r.generated)) for r in verifying}
        verify(verifying)
        for r in verifying:
            spec, n0 = before[r.rid]
            row = st["rows"]["spec" if spec else "plain"]
            row[0] += len(r.generated) - n0
            row[1] += 1

    rm._tick, rm._sync_kv, rm._verify_phase = (hooked_tick, hooked_sync,
                                               hooked_verify)
    t0 = time.perf_counter()
    rec, launches["mixed"] = counted(att, lambda: rm.serve_with_arrivals(
        mixed_traffic(prompts, n_new), clock=PassClock(im)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = [rec[r]["tokens"] for r in sorted(rec)]
    if got != want:
        raise AssertionError("spec mixed 7B: the mixed streams differ from "
                             "the incremental oracle's")
    if any(r["outcome"] != "ok" for r in rec.values()):
        raise AssertionError(f"spec mixed 7B: outcomes "
                             f"{[r['outcome'] for r in rec.values()]}")
    if not (st["off"] and st["on"] and rm.flushes and rm.macro_steps):
        raise AssertionError(f"spec mixed 7B: flips {st}, flushes "
                             f"{rm.flushes}, macro steps {rm.macro_steps}")
    snap = rm.kv_snapshot()
    if snap["hwm_tokens"] != st["hwm"] or snap["live_tokens"] != 0 or \
            not max(map(len, prompts)) < st["hwm"] <= sum(
                2 * (len(p) + n_new + 4) for p in prompts):
        raise AssertionError(f"spec mixed 7B: gauges {snap}, live-depth "
                             f"watermark {st['hwm']}")
    require_launches(launches["mixed"], "spec mixed 7B", "fp", (
        "decode_attention", "prefill_attention", "tree_attention"))
    per = {k: v[0] / v[1] for k, v in st["rows"].items() if v[1]}
    log(f"spec mixed 7B: Llama-2-7B f32 via LLM.compile(ssms=[llama-68m]), "
        f"8 arrivals alternating spec/plain: {rm.macro_steps} macro steps, "
        f"{rm.llm_steps} LLM passes on the spec path, flush dispatches "
        f"{rm.flushes} (tick {st['flush_tick']}, rows flipped off with "
        f"their pending commits {st['off']}), flipped on (rid, generated, "
        f"SSM depth, rebuilt feed) {st['on']}; tokens per LLM verify pass "
        f"per row: spec {per.get('spec', 0):.3f} over {st['rows']['spec'][1]}"
        f" row-passes, plain {per.get('plain', 0):.3f} over "
        f"{st['rows']['plain'][1]}; KV hwm {snap['hwm_tokens']} tokens "
        f"({snap['hwm_bytes'] / 1e9:.3f} GB, target + draft), streams equal "
        f"the oracle's, outcomes ok, wall {wall:.2f}s; launches "
        f"{short(launches['mixed'])} (oracle {short(launches['oracle'])})")
    # the device loop: spec_mask alternating, a perfect draft (the LLM's
    # upper layers zeroed), against a new oracle on the changed weights
    kw = dict(caps, max_spec_tokens=im.max_spec_tokens, device=dev)
    perfect = perfect_draft(serve, im, cfg, kw)
    im.reset()
    want = serve.RequestManager(im, rm.gen).generate(prompts)
    im.reset()
    mask = [i % 2 == 0 for i in range(len(prompts))]
    firsts = held_firsts(serve, im, prompts)
    held_firsts(serve, perfect, prompts)
    lens = [len(p) for p in prompts]
    sc = serve.SpecDecodeScan(im, perfect, width=1, depth=3,
                              eos_token_id=rm.gen.eos_token_id)
    carry = sc.init_carry(firsts, lens, lens, [False] * len(prompts),
                          spec_mask=mask, budget=[n_new - 1] * len(prompts))
    ems = []

    def loop(carry):
        while not bool(carry["finished"].all()):
            em, carry = sc.run(carry, 4)
            ems.append(em.cpu().numpy())

    t0 = time.perf_counter()
    _, launches["scan"] = counted(att, lambda: loop(carry))
    wall = time.perf_counter() - t0
    release_held((im, perfect), len(prompts))
    em = np.concatenate(ems)
    outs = [[firsts[i]] + [int(t) for t in em[:, i].reshape(-1) if t >= 0]
            for i in range(len(prompts))]
    if outs != want:
        raise AssertionError("spec mixed 7B scan: streams differ from the "
                             "incremental oracle's")
    live = (em >= 0).any(2)                       # [steps, R]
    emit = (em >= 0).sum(2)
    spec_rate = emit[:, mask].sum() / live[:, mask].sum()
    plain = [i for i, m in enumerate(mask) if not m]
    if not (spec_rate > 1 and (emit[:, plain][live[:, plain]] == 1).all()):
        raise AssertionError(f"spec mixed 7B scan: tokens per macro step "
                             f"spec {spec_rate}, plain {emit[:, plain]}")
    require_launches(launches["scan"], "spec mixed 7B scan", "fp", (
        "decode_attention", "tree_attention", "tree_attention_batched"))
    log(f"spec mixed 7B scan: SpecDecodeScan spec_mask {mask}, perfect "
        f"draft (width 1, depth 3): {len(em)} macro steps in {len(ems)} "
        f"windows {wall:.2f}s; tokens per LLM pass per row: spec "
        f"{spec_rate:.3f}, plain "
        f"{emit[:, plain].sum() / live[:, plain].sum():.3f}; streams equal "
        f"the oracle's; launches {short(launches['scan'])}")
    del llm, im, rm, perfect, sc, carry
    return launches


def spec_families(serve, att, torch, dev, n_new=16):
    """Phase 14's families part: MPT-7B, Falcon-7B, OPT-6.7B and StarCoder
    at 2 layers of full width, f32, each on ``SpecInferManager`` and
    ``SpecDecodeScan`` with a perfect draft (the LLM's modules, top-1) and
    a narrow draft of its family: streams equal the incremental ones; MPT
    launches no tree kernel, and its gather path is timed.  Returns
    {family: launches}."""
    import gc

    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
                max_spec_tokens=8, device=dev)
    gen = serve.GenerationConfig(max_new_tokens=n_new)
    launches = {}
    for family, cfg in (
            ("mpt", mpt7b_config(serve, n_layers=2, torch_dtype="float32")),
            ("falcon", falcon7b_config(serve, num_hidden_layers=2,
                                       torch_dtype="float32")),
            ("opt", opt67b_config(serve, num_hidden_layers=2,
                                  torch_dtype="float32")),
            ("starcoder", starcoder_config(serve, n_layer=2,
                                           torch_dtype="float32"))):
        t0 = time.perf_counter()
        im = serve.InferenceManager(serve.build_model(cfg), **caps)
        im.init_operators_inference(seed=0)
        perfect = serve.InferenceManager(im.model, topk=1, **caps)
        perfect.init_operators_inference(dict(im.model.named_parameters()))
        narrow = serve.InferenceManager(
            serve.build_model(narrow_draft_config(serve, family)), topk=2,
            **caps)
        narrow.init_operators_inference(seed=1)
        prompts = [p[:300] for p in serve_prompts(cfg.vocab_size)]
        want = serve.RequestManager(im, gen).generate(prompts)
        n = collections.Counter()
        passes = {}
        captured = []
        attn = next(m for m in im.model.modules()
                    if isinstance(m, serve.IncMultiHeadSelfAttention))
        if cfg.use_alibi:
            inner = attn._alibi_tree_attend

            def capture(*args, _inner=inner):
                captured[:] = [args]
                return _inner(*args)

            attn._alibi_tree_attend = capture
        for draft, width, depth in ((narrow, 2, 3), (perfect, 1, 3)):
            name = "narrow" if draft is narrow else "perfect"
            im.reset()
            draft.reset()
            sm = serve.SpecInferManager(im, draft, gen, width=width,
                                        depth=depth)
            rows = []
            verify = sm._verify_phase

            def counting_verify(verifying, _verify=verify):
                rows.append(len(verifying))
                _verify(verifying)

            sm._verify_phase = counting_verify
            host, c1 = counted(att, lambda: sm.generate(prompts))
            im.reset()
            draft.reset()
            scan, c2 = counted(att, lambda: scan_streams(
                serve, im, draft, prompts, n_new, width, depth))
            if host != want or scan != want:
                raise AssertionError(f"spec {family} ({name} draft): "
                                     f"streams differ from incremental")
            n.update(c1)
            n.update(c2)
            # tokens per request per verify pass it took part in
            passes[name] = (sm.tokens_decoded - len(prompts)) / sum(rows)
            if not cfg.use_alibi:
                require_launches(c1, f"spec {family} host", "fp",
                                 ("tree_attention",))
                require_launches(c2, f"spec {family} scan", "fp",
                                 ("tree_attention_batched",))
        tree = sum(c for (k, _), c in n.items() if k.startswith("tree"))
        extra = ""
        if cfg.use_alibi:
            if tree:
                raise AssertionError(f"spec mpt: tree kernels launched {n}")
            require_launches(n, "spec mpt", "fp+alibi",
                             ("decode_attention",))
            attn._alibi_tree_attend = inner
            args = captured[0]
            ms = time_ms(lambda: attn._alibi_tree_attend(*args), 10)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            attn._alibi_tree_attend(*args)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            extra = (f"; gather path of one layer at a verify step "
                     f"({args[0].shape[0]} flat tokens, cache "
                     f"{list(args[1]['k'].shape)}): {ms:.4f} ms device, "
                     f"{ms * cfg.num_hidden_layers:.4f} ms a 2-layer step, "
                     f"transient {peak / 1e9:.3f} GB; max_memory_allocated "
                     f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        launches[family] = dict(n)
        log(f"spec {family}: 2 layers at full width f32 ({cfg.hidden_size} "
            f"hidden, {cfg.num_attention_heads} heads on {cfg.kv_heads} KV "
            f"heads), 8 prompts x {n_new} tokens: host and device spec "
            f"streams equal incremental with the narrow and the perfect "
            f"draft; tokens per LLM verify pass per request (host) narrow "
            f"{passes['narrow']:.3f}, perfect {passes['perfect']:.3f}; tree "
            f"kernel launches {tree}; wall {time.perf_counter() - t0:.1f}s"
            f"{extra}; launches {short(n)}")
        del im, perfect, narrow, sm, attn, captured
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_spec_mixed(serve, att, torch, dev):
    """Phase 14: mixed spec and plain rows at 7B, then speculative serving
    of every family.  Returns {path: launches}."""
    import gc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the earlier phases' managers sit in reference cycles (their wrapped
    # methods): collect them before the 7B f32 deployment is built
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"spec mixed: {torch.cuda.memory_allocated() / 1e9:.2f} GB held "
        f"before the build")
    t0 = time.perf_counter()
    launches = spec_mixed_7b(serve, att, torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"spec mixed 7B: part wall {time.perf_counter() - t0:.1f}s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    launches["families"] = spec_families(serve, att, torch, dev)
    log(f"spec mixed: phase wall {time.perf_counter() - t0:.1f}s")
    return launches


def control_traffic(prompts, n_new, max_tokens):
    """``api_traffic`` with the two lanes alternating: even requests
    batch, odd ones latency-critical."""
    return [(t, p, n, {"slo_class": "latency_critical" if i % 2
                       else "batch"})
            for i, (t, p, n) in enumerate(api_traffic(prompts, n_new,
                                                       max_tokens))]


def median_spread(xs):
    """(median, max - min) of a list of floats."""
    xs = sorted(xs)
    return xs[len(xs) // 2], xs[-1] - xs[0]


def phase_control_plane(serve, att, torch, dev, card):
    """Phase 15: the serving control plane on the card.  The published
    Llama-2-7B shape in bf16 (the host-bound case), compiled through
    ``LLM.compile`` with the reference's defaults and a llama-68m-shaped
    draft (``ssms``), an SLO policy (a latency-critical and a batch lane)
    and a brownout ladder that escalates on KV occupancy.  On a
    pass-counting clock, ``serve_with_arrivals`` of the 8 prompts, 32 new
    tokens, lanes alternating: with every observation hook off (no
    telemetry, profiler or plan-health monitor) and on, three times each,
    alternating; streams, outcomes and records equal (the profiler's
    ``work`` aside); the hooks' host overhead as a share of the median
    wall; the profiler's phase budget per tick and its counters; the
    spec manager with its hooks (K3); the JSONL summarised by the port's
    ``trace_report``; two hooks-on runs' counters through its
    ``bench_compare`` (exit 0).  Returns {path: launches}."""
    import gc
    import statistics

    from flexflow_tpu_torch import obs
    from flexflow_tpu_torch.obs.report import summarize_jsonl
    from flexflow_tpu_torch.tools import bench_compare, trace_report

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    cfg = serve.ServeModelConfig(dtype="bfloat16")   # Llama-2-7B defaults
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    n_new = 32
    gen = serve.GenerationConfig(max_new_tokens=n_new)
    prompts = serve_prompts(cfg.vocab_size)
    arrivals = control_traffic(prompts, n_new, caps["max_tokens_per_batch"])
    slo = serve.SLOPolicy.default(lc_reservation_frac=0.0,
                                  degraded_max_new_tokens=8)
    # the 8 prompts hold half the cache: the ladder climbs from the first
    # tick on and steps back once the batch lane has drained
    ladder = serve.BrownoutConfig(check_every=1, kv_pressure_frac=0.35,
                                  escalate_after=1, deescalate_after=2)

    def hooks(on, plan=None):
        tel = obs.Telemetry() if on else None
        kw = dict(slo=slo, brownout=serve.BrownoutController(
            slo, ladder, telemetry=tel))
        if on:
            kw.update(telemetry=tel, profiler=obs.StepProfiler(),
                      plan_health=obs.PlanHealthMonitor(tel, plan))
        return kw

    draft = serve.SSM(draft_config(serve, "bfloat16"))
    llm = serve.LLM(cfg).compile(device=dev, generation_config=gen,
                                 ssms=[draft], spec_width=2, spec_depth=3,
                                 **hooks(False), **caps)
    im = llm.im
    log(f"control plane: 7B bf16 compiled in "
        f"{time.perf_counter() - t_phase:.1f}s through LLM.compile (gating "
        f"{im.gate_lm_head}, chaining {llm.rm.chain_segments}, ssms: "
        f"{type(llm.rm).__name__})")

    run_step = im.run_step

    def serve_once(rm):
        """One run on fresh caches: (records, launches, wall s, median
        TTFT and TPOT ms from the tokens' host stamps)."""
        stamps = {}
        inner = rm._append_token

        def stamp(req, tok):
            inner(req, tok)
            stamps.setdefault(req.rid, []).append(time.perf_counter())

        rm._append_token = stamp
        im.reset()
        if hasattr(rm, "ssm"):
            rm.ssm.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            recs, n = counted(att, lambda: rm.serve_with_arrivals(
                arrivals, clock=PassClock(im)))
            torch.cuda.synchronize()
        finally:
            im.run_step = run_step
        wall = time.perf_counter() - t0
        ttft = [(s[0] - t0) * 1e3 for s in stamps.values()]
        tpot = [(s[-1] - s[0]) * 1e3 / (len(s) - 1)
                for s in stamps.values() if len(s) > 1]
        return (recs, n, wall, statistics.median(ttft),
                statistics.median(tpot))

    def strip(recs):
        return {r: {k: v for k, v in rec.items() if k != "work"}
                for r, rec in recs.items()}

    launches = {}
    walls = {False: [], True: []}
    base = plan = None
    runs = []
    for i in range(6):
        on = bool(i % 2)
        rm = serve.RequestManager(im, gen, **hooks(on, plan))
        recs, n, wall, ttft, tpot = serve_once(rm)
        walls[on].append(wall)
        if base is None:
            base = strip(recs)
            plan = {"plan_key": im.plan_key, "ttft_ms": ttft,
                    "tpot_ms": tpot}
            launches["incremental"] = n
        elif strip(recs) != base:
            raise AssertionError(f"control plane: run {i} (hooks "
                                 f"{'on' if on else 'off'}) records differ "
                                 "from the first hooks-off run's")
        if on:
            runs.append((rm, recs))
        del rm
    require_launches(launches["incremental"], "control plane", "fp",
                     ("decode_attention", "prefill_attention"))
    outcomes = collections.Counter(r["outcome"] for r in base.values())
    capped = [r for r in base.values() if r.get("slo_class") == "batch"
              and r["outcome"] == "ok" and len(r["tokens"]) < n_new]
    rm, recs = runs[-1]
    tel, prof = rm.telemetry, rm.profiler
    m = tel.metrics.snapshot()
    bo = rm.brownout
    if not bo.history or not m.get("lane_degraded_total"):
        raise AssertionError(f"control plane: the ladder {bo.history} made "
                             f"no level change or no output cap")
    if any(len(r["tokens"]) > n_new or not all(0 <= t < cfg.vocab_size
                                               for t in r["tokens"])
           for r in base.values()):
        raise AssertionError("control plane: bad streams")
    lanes = ("lane_", "brownout_")
    off, spread_off = median_spread(walls[False])
    on_, spread_on = median_spread(walls[True])
    log(f"control plane: 7B bf16, 8 arrivals x {n_new} tokens, lanes "
        f"alternating, pass clock [{card}]: records and streams equal hooks "
        f"off and on in all 6 runs; outcomes {dict(outcomes)}, batch "
        f"requests capped {len(capped)}; ladder (evaluation, level, "
        f"reason) {[(e, int(lv), why) for e, lv, why in bo.history]}; lane "
        f"counters { {k: m[k] for k in sorted(m) if k.startswith(lanes)} }")
    log(f"control plane: wall median {off * 1e3:.3f} ms hooks off (spread "
        f"{spread_off * 1e3:.3f}), {on_ * 1e3:.3f} ms on (spread "
        f"{spread_on * 1e3:.3f}): host overhead share "
        f"{(on_ - off) / off:+.4f} [{card}]")
    rep = prof.report()
    ticks = rep["ticks"]
    budget = {k: rep["phases"][k]["ms"] / ticks
              for k in ("host_admit", "host_prepare", "dispatch", "readback")
              if k in rep["phases"]}
    work = rep["work"]
    log(f"control plane: profiler, {ticks} ticks: per-tick ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in budget.items())
        + f" [{card}]; dispatches {work['dispatches']}, host_syncs "
        f"{work['host_syncs']} (read-backs {rm.readbacks}), flops "
        f"{work['flops']:.6e}, hbm_bytes_read {work['hbm_bytes_read']:.6e}, "
        f"recompiles_total {work['recompiles_total']}")
    if work["host_syncs"] != rm.readbacks:
        raise AssertionError("control plane: host_syncs != readbacks")
    report = rm.plan_health.check()
    log(f"control plane: plan health {report['reasons']} (checks "
        f"{report['checks']}, predicted TTFT {plan['ttft_ms']:.3f} ms, TPOT "
        f"{plan['tpot_ms']:.3f} ms from the first hooks-off run) [{card}]")
    # two hooks-on runs' counters: exact
    docs = [{"work": r.profiler.report()["work"],
             "requests": {str(k): v["work"] for k, v in rr.items()}}
            for r, rr in runs[:2]]
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "control_plane")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, doc in enumerate(docs):
        paths.append(os.path.join(out_dir, f"counters{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(doc, f)
    if bench_compare.main([paths[0], paths[1], "--json",
                           os.path.join(out_dir, "compare.json")]) != 0:
        raise AssertionError("control plane: bench_compare found a counter "
                             "that differs between two hooks-on runs")
    # the spec manager's hooks: K3 on the verify steps
    spec_on = llm.rm.__class__(im, llm.rm.ssm, gen, width=2, depth=3,
                               **hooks(True, plan))
    spec_off = llm.rm
    s_off = serve_once(spec_off)[0]
    s_on, launches["spec"], s_wall, _, _ = serve_once(spec_on)
    if strip(s_on) != strip(s_off):
        raise AssertionError("control plane: spec records differ with the "
                             "hooks on")
    require_launches(launches["spec"], "control plane spec", "fp",
                     ("tree_attention",))
    sm = spec_on.telemetry.metrics.snapshot()
    log(f"control plane: spec (llama-68m draft), hooks on: wall "
        f"{s_wall * 1e3:.3f} ms [{card}], verify rounds "
        f"{sm.get('spec_verify_rounds')}, spec mode changes "
        f"{sm.get('spec_mode_changes', 0)}, profiler dispatches "
        f"{spec_on.profiler.work['dispatches']}; launches "
        f"{short(launches['spec'])}")
    path = spec_on.telemetry.export(out_dir, prefix="spec")["jsonl"]
    paths = rm.telemetry.export(out_dir, prefix="incremental")
    if trace_report.main(["--check", paths["jsonl"]]) != 0 or \
            trace_report.main(["--check", path]) != 0:
        raise AssertionError("control plane: an export fails --check")
    summary = summarize_jsonl(paths["jsonl"])
    log(f"control plane: trace_report of the incremental export: "
        f"{summary['requests']} requests, outcomes {summary['outcomes']}, "
        f"events {summary['events']}, dropped {summary['dropped']}, TTFT "
        f"p50 {summary['ttft_p50_ms']} ms, TPOT p50 {summary['tpot_p50_ms']}"
        f" ms [{card}], brownout changes "
        f"{[c['level_name'] for c in summary['slo']['brownout_changes']]}")
    log(f"control plane: phase wall {time.perf_counter() - t_phase:.1f}s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    del llm, im, spec_on, spec_off, rm, runs
    gc.collect()
    torch.cuda.empty_cache()
    return launches


TC_KERNELS = ("prefill_tc_kernel", "prefill_tf32_kernel",
              "tree_split_tf32_kernel", "tree_split_kernel",
              "tree_merge_kernel", "decode_split_kernel",
              "tree_token_split_kernel", "decode_split_tf32_kernel",
              "tree_token_split_tf32_kernel")


def migration_walls(serve, torch):
    """Time each drain, rebuild and readmit of every migration controller
    (the fleet's rolling one included) with the card synchronized on both
    sides, and count the tokens each drain sends to recompute (prompt +
    generated of every request it preempts).  Returns (the list the
    timings land in, a function that restores the class)."""
    from flexflow_tpu_torch.serve import migration

    cls = migration.MigrationController
    saved = {name: getattr(cls, name)
             for name in ("_drain", "_build", "_readmit")}
    walls = []

    def timed(name, fn):
        def run(self, rm, *args):
            recompute = 0
            if name == "_drain":
                recompute = sum(len(r.prompt) + len(r.generated)
                                for r in rm._active() if r.status in (
                                    serve.RequestStatus.PREFILLING,
                                    serve.RequestStatus.DECODING))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, rm, *args)
            torch.cuda.synchronize()
            walls.append((name[1:], time.perf_counter() - t0, recompute))
            return out
        return run

    for name, fn in saved.items():
        setattr(cls, name, timed(name, fn))

    def restore():
        for name, fn in saved.items():
            setattr(cls, name, fn)

    return walls, restore


def log_migrations(label, walls):
    """One line per migration: its drain, rebuild and readmit walls and
    the drain's recompute tokens."""
    names = [w[0] for w in walls]
    for i in range(names.count("drain")):
        parts = {n: [w for w in walls if w[0] == n][i]
                 for n in ("drain", "build", "readmit")
                 if names.count(n) > i}
        log(f"{label} migration {i}: " + ", ".join(
            f"{n} {w[1] * 1e3:.3f} ms" for n, w in parts.items())
            + f"; recompute tokens {parts['drain'][2]}")


def phase_fleet_migration_replay(serve, att, torch, dev):
    """Phase 16: live plan migration, the fleet router and traffic-trace
    replay on the published Llama-2-7B shape in float32 (TF32 off), the
    serve prompts, 16 new tokens, every deployment ``max_requests=4``,
    ``max_seq_len=2048``, all serving one model's parameter tensors
    (``LLM.compile(share_weights_with=...)``), each with its own KV:

    a. one replica's greedy run, the oracle (``serve_with_arrivals`` on a
       pass-counting clock);
    b. ``LLM.fleet`` over two replicas, replica 0 killed mid-decode by
       ``schedule_kill``: streams equal (a), every outcome ``ok``, the
       victim's requests fail over under their rids, and
       ``torch.cuda.memory_allocated`` falls by the victim's KV bytes;
    c. a rolling contiguous → paged migration over a two-replica fleet:
       at every fleet tick a replica keeps admission open; streams equal
       (a);
    d. ``LLM.attach_migration`` on a speculative deployment (a
       llama-68m-shaped draft): contiguous → paged mid-decode, then a
       spec-off flip on the fast path; streams equal (a);
    e. (b) with seeded sampling and one injected ``fleet_dispatch`` fault,
       recorded by a ``TrafficTraceRecorder``, replayed by
       ``ReplayHarness`` on a freshly built fleet: ``verify`` at zero
       mismatches, and ``tools/replay_report.py --check`` exits 0 on the
       artifact (``build/fleet_replay/trace.jsonl``).

    Logs the wall, peak memory, each migration's drain, rebuild and
    readmit walls and recompute tokens, the downtime in admission-closed
    ticks, and the failed-over requests' passes from the kill to their
    next token against their TTFT in (a).  Returns {(kernel, variant):
    launches} summed over the runs."""
    import gc

    from flexflow_tpu_torch.obs.replay import (
        ReplayHarness,
        TrafficTrace,
        TrafficTraceRecorder,
        VirtualClock,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    held_before = torch.cuda.memory_allocated()
    cfg = serve.ServeModelConfig(dtype="float32")   # Llama-2-7B defaults
    n_new = 16
    caps = dict(max_requests=4, max_tokens_per_batch=512, max_seq_len=2048,
                device=dev)
    paged = f"tp1_pp1_m1_paged{PAGE}"
    prompts = serve_prompts(cfg.vocab_size)
    arrivals = [(0.0, p, n_new) for p in prompts]
    launches = collections.Counter()
    decoding = serve.RequestStatus.DECODING

    def counted_run(fn):
        out, n = counted(att, fn)
        launches.update(n)
        return out

    def streams(recs, what):
        got = [recs[r]["tokens"] for r in sorted(recs)]
        bad = [r for r in sorted(recs) if recs[r]["outcome"] != "ok"]
        if bad:
            raise AssertionError(f"{what}: requests {bad} did not end ok")
        return got

    def equal_to_oracle(got, what):
        if got != want:
            raise AssertionError(f"{what}: streams differ from the one-"
                                 f"replica run: {got} vs {want}")

    base = serve.LLM(cfg).compile(**caps)
    model = base.im.model
    gen = base.rm.gen
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"fleet: 7B f32 compiled in {time.perf_counter() - t_phase:.1f}s; "
        f"weights {weights / 1e9:.2f} GB shared by every deployment, KV "
        f"{base.im.kv.allocated_bytes() / 1e9:.2f} GB each")

    def replica(gen_cfg=gen, **kw):
        return serve.LLM(cfg).compile(generation_config=gen_cfg,
                                      share_weights_with=base, **caps, **kw)

    def free():
        """Drop an ended run's deployments; every cache must be gone (the
        shared weights stay)."""
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() - held_before
        if held > weights + (1 << 30):
            raise AssertionError(f"fleet: {held} bytes still allocated "
                                 f"after a run, weights {weights}")
        return held

    # ---- a: the one-replica oracle --------------------------------------
    clock = PassClock(base.im)
    recs = counted_run(lambda: base.rm.serve_with_arrivals(arrivals,
                                                          clock=clock))
    want = streams(recs, "one replica")
    if any(not 0 < len(o) <= n_new for o in want) or any(
            not 0 <= t < cfg.vocab_size for o in want for t in o):
        raise AssertionError(f"one replica: bad streams {want}")
    ttft_a = {r: (rec["first_token_s"] - rec["arrival_s"]) / clock.pass_s
              for r, rec in recs.items()}
    passes_a = clock.passes
    base.im.kv.teardown()   # base keeps the weights, not its cache
    free()

    def fleet_of(llms, clock=None, **kw):
        fleet = serve.LLM.fleet(llms, gen=llms[0].rm.gen, **kw)
        for rep in fleet.replicas:
            if clock is not None:
                clock.attach(rep.rm.im)
            rep.rm.scan_chunk = 4    # a kill at tick 3 lands mid-decode
        return fleet

    # ---- b: a replica killed mid-decode -----------------------------------
    def kill_run():
        clock = PassClock()
        fleet = fleet_of([replica(), replica()], clock)
        kill = fleet.kill_replica
        death = {}

        def measured_kill(name, reason="operator kill"):
            rep = fleet._by_name(name)
            torch.cuda.synchronize()
            death["victims"] = {r.rid: len(r.generated)
                                for r in rep.rm._active()
                                if r.status is decoding}
            death["kv"] = rep.rm.im.kv.allocated_bytes()
            death["passes"] = clock.passes
            before = torch.cuda.memory_allocated()
            moved = kill(name, reason)
            torch.cuda.synchronize()
            death["drop"] = before - torch.cuda.memory_allocated()
            death["moved"] = moved
            return moved

        fleet.kill_replica = measured_kill
        next_token = {}
        for rep in fleet.replicas:
            def stamped(req, tok, _append=rep.rm._append_token):
                _append(req, tok)
                if "passes" in death and req.rid in death["victims"]:
                    next_token.setdefault(req.rid, clock.passes)
            rep.rm._append_token = stamped
        fleet.schedule_kill("replica0", at_tick=3)
        t0 = time.perf_counter()
        recs = counted_run(lambda: fleet.serve_with_arrivals(arrivals,
                                                             clock=clock))
        wall_b = time.perf_counter() - t0
        equal_to_oracle(streams(recs, "fleet kill"), "fleet kill")
        victims = death.get("victims") or {}
        if not victims or any(n < 1 for n in victims.values()):
            raise AssertionError(f"fleet kill: not mid-decode: {death}")
        if sorted(death["moved"]) != sorted(victims):
            raise AssertionError(f"fleet kill: failed over {death['moved']}, "
                                 f"decoding {sorted(victims)}")
        for rid in victims:
            if (recs[rid]["failovers"] != 1
                    or recs[rid]["replica"] != "replica1"
                    or rid not in next_token):
                raise AssertionError(f"fleet kill: request {rid} {recs[rid]}")
        dead = fleet._by_name("replica0")
        if dead.leaked or death["drop"] < death["kv"] or death["kv"] <= 0:
            raise AssertionError(
                f"fleet kill: teardown freed {death['drop']} bytes of "
                f"{death['kv']} KV bytes, leaked {dead.leaked}")
        recompute = sum(len(prompts[r]) + n for r, n in victims.items())
        log(f"fleet kill: wall {wall_b:.2f}s, {clock.passes} passes (one "
            f"replica {passes_a}); killed at pass {death['passes']} with "
            f"{sorted(victims.items())} (rid, tokens) decoding; "
            f"memory_allocated fell {death['drop']} bytes, victim KV "
            f"{death['kv']} bytes; "
            f"recompute tokens {recompute}")
        log("fleet failover TTFT in passes (kill to next token; one-replica "
            "TTFT): " + ", ".join(
                f"r{r} {next_token[r] - death['passes']} ({ttft_a[r]:.0f})"
                for r in sorted(victims)))

    kill_run()
    free()

    # ---- c: a rolling contiguous -> paged migration -----------------------
    walls, restore = migration_walls(serve, torch)
    try:
        def rolling_run():
            clock = PassClock()
            fleet = fleet_of([replica(), replica()], clock)

            def build_paged(cand):
                im = serve.InferenceManager(model, kv_page_size=PAGE, **caps)
                im.allocate_kv_cache()
                return clock.attach(im)

            fleet.request_rolling_migration(
                paged, build_paged, migration_config=serve.MigrationConfig(
                    auto=False, defer_ticks=1, drain_grace_ticks=1))
            floor = []
            fleet_tick = fleet._fleet_tick

            def watched_tick():
                fleet_tick()
                floor.append(fleet.replicas_serving())

            fleet._fleet_tick = watched_tick
            t0 = time.perf_counter()
            recs = counted_run(lambda: fleet.serve_with_arrivals(arrivals,
                                                                 clock=clock))
            wall_c = time.perf_counter() - t0
            equal_to_oracle(streams(recs, "rolling migration"),
                            "rolling migration")
            done = [h for h in fleet.history
                    if h["event"] == "rolling_migration_completed"]
            if (not floor or min(floor) < 1 or len(done) != 1
                    or any(r["outcome"] != "completed"
                           for r in done[0]["replicas"])
                    or not all(rep.rm.im.kv.paged for rep in fleet.replicas)):
                raise AssertionError(f"rolling migration: serving floor "
                                     f"{floor}, records {done}")
            log(f"rolling migration: wall {wall_c:.2f}s, {clock.passes} "
                f"passes, {len(floor)} fleet ticks, replicas serving per "
                f"tick {floor}; "
                + "; ".join(f"{r['replica']} {r['outcome']}, downtime "
                            f"{r['downtime_ticks']} ticks, preempted "
                            f"{r['preempted_requests']}"
                            for r in done[0]["replicas"]))
            log_migrations("rolling", walls)

        rolling_run()
        free()

        # ---- d: attach_migration on a speculative deployment ----------
        walls.clear()

        def attach_run():
            draft = serve.SSM(draft_config(serve, "float32"))
            llm = replica(ssms=[draft], spec_width=2, spec_depth=3)
            clock = PassClock()
            clock.attach(llm.im)
            clock.attach(draft.im)
            spec = f"{paged}_spec_w2d3"

            def build_spec_pair(cand):
                kw = dict(kv_page_size=PAGE,
                          max_spec_tokens=llm.im.max_spec_tokens, **caps)
                pair = (serve.InferenceManager(model, **kw),
                        serve.InferenceManager(draft.im.model, topk=2, **kw))
                for im in pair:
                    im.allocate_kv_cache()
                    clock.attach(im)
                return pair

            ctrl = llm.attach_migration(
                build_spec_pair, plan={"plan_key": "tp1_pp1_m1_spec_w2d3"},
                config=serve.MigrationConfig(auto=False, defer_ticks=1,
                                             drain_grace_ticks=1))
            ctrl.request_migration(spec)
            # the flip once the paged spec deployment decodes again
            clock.when(lambda: len(ctrl.history) == 1 and any(
                r.status is decoding and len(r.generated) >= 8
                for r in ctrl.rm._active()),
                lambda: ctrl.request_migration(paged))
            first_rm = llm.rm
            t0 = time.perf_counter()
            recs = counted_run(lambda: first_rm.serve_with_arrivals(
                arrivals, clock=clock))
            wall_d = time.perf_counter() - t0
            equal_to_oracle(streams(recs, "attach_migration"),
                            "attach_migration")
            modes = [(h["outcome"], h.get("mode")) for h in ctrl.history]
            if (modes != [("completed", "rebuild"), ("completed", "spec_flip")]
                    or llm.rm is first_rm or not llm.im.kv.paged
                    or llm.rm.default_spec_mode):
                raise AssertionError(f"attach_migration: {ctrl.history}")
            log(f"attach_migration: wall {wall_d:.2f}s, {clock.passes} "
                "passes; " + "; ".join(
                    f"{h['incumbent']} -> {h['candidate']} ({h['mode']})"
                    f": downtime {h['downtime_ticks']} admission-closed "
                    f"ticks, preempted {h['preempted_requests']}"
                    + (f", flipped {h['flipped_requests']}"
                       if "flipped_requests" in h else "")
                    for h in ctrl.history))
            log_migrations("attach_migration", walls)

        attach_run()
        free()
    finally:
        restore()

    # ---- e: a seeded fleet run with a fault, recorded and replayed --------
    seeded = dataclasses.replace(gen, temperature=0.8, top_p=0.9, seed=5)

    def chaos_fleet(**kw):
        return fleet_of([replica(seeded), replica(seeded)], **kw)

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "fleet_replay")
    path = os.path.join(out_dir, "trace.jsonl")
    inj = serve.FaultInjector(seed=0, p_by_site={"fleet_dispatch": 1.0},
                              max_faults=1)

    def record_run():
        fleet = chaos_fleet(fault_injector=inj)
        fleet.schedule_kill("replica0", at_tick=3)
        recorder = TrafficTraceRecorder(path=path)
        t0 = time.perf_counter()
        recs = counted_run(lambda: fleet.serve_with_arrivals(
            arrivals, clock=VirtualClock(), record_trace=recorder))
        return recs, time.perf_counter() - t0

    recorded, wall_rec = record_run()
    free()
    failovers = sum(r["failovers"] for r in recorded.values())
    outcomes = [r["outcome"] for r in recorded.values()]
    if inj.injected != 1 or not failovers or set(outcomes) != {"ok"}:
        raise AssertionError(f"recorded run: {inj.injected} faults, "
                             f"{failovers} failovers, outcomes {outcomes}")
    trace = TrafficTrace.load(path)
    errors = trace.validate()
    harness = ReplayHarness(trace)

    def replay_run():
        fleet = chaos_fleet()          # fresh caches, no injector, no kill
        t0 = time.perf_counter()
        recs = counted_run(lambda: harness.replay(fleet))
        return recs, time.perf_counter() - t0

    replayed, wall_replay = replay_run()
    free()
    fidelity = harness.verify(replayed)
    check = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.tools.replay_report",
         "--check", path], capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    if errors or not fidelity["bit_identical"] or check.returncode:
        raise AssertionError(
            f"replay: validate {errors}, mismatches "
            f"{fidelity['mismatches']}, replay_report --check rc "
            f"{check.returncode} {check.stdout} {check.stderr}")
    greedy_share = equal_share(
        [recorded[r]["tokens"] for r in sorted(recorded)], want)
    log(f"replay: recorded {len(recorded)} requests (seeded T=0.8, 1 "
        f"fleet_dispatch fault, {failovers} failovers) in {wall_rec:.2f}s, "
        f"replayed in {wall_replay:.2f}s on a fresh fleet: "
        f"{len(fidelity['mismatches'])} mismatches over "
        f"{fidelity['requests']} requests; replay_report --check rc 0; "
        f"seeded tokens equal to greedy {greedy_share:.4f}")
    need = [(k, v) for k in ("decode_attention", "prefill_attention",
                             "tree_attention") for v in ("fp", "paged")]
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"fleet: a kernel never launched: "
                             f"{short(launches)}")
    log(f"fleet: phase wall {time.perf_counter() - t_phase:.1f}s, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB; launches {short(launches)}")
    return dict(launches)


def shard_probe(att, shards):
    """Book each kernel launch to the tensor-parallel shard that made it:
    every shard's forward generator is wrapped, so the launches between
    two of its collectives count for that shard.  Returns one Counter of
    {(kernel, variant): launches} per shard, cleared by the caller."""
    per = [collections.Counter() for _ in shards]

    def snap():
        return {(name, var): n for name in COUNTED
                for var, n in getattr(att, name).variant_launches.items()}

    def book(counter, before):
        counter.update({k: n - before.get(k, 0) for k, n in snap().items()
                        if n > before.get(k, 0)})

    for model, counter in zip(shards, per):
        inner = model.forward_gen

        def probed(*args, _inner=inner, _counter=counter, **kw):
            gen = _inner(*args, **kw)
            reply = None
            while True:
                before = snap()
                try:
                    msg = gen.send(reply)
                except StopIteration as stop:
                    book(_counter, before)
                    return stop.value
                book(_counter, before)
                reply = yield msg

        model.forward_gen = probed
    return per


def phase_tensor_parallel(serve, att, kv_quant, torch, dev):
    """Two tensor-parallel shards on the one card: the kernels at the
    shard-local shapes, (a) float32 parity of ``tp=2`` with ``tp=1`` on
    every serve path and (b) the bf16 7B served through
    ``LLM.compile(tp=2)``.  Returns the shard-local kernel results
    ({label: {(name, variant, dtype): result}}) and the ``tp=2`` runs'
    launches, summed over the shards: ``"f32"`` of (a)'s float32 fp paths
    and ``"bf16"`` of (b)."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.parallel import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    devices = [dev, dev]
    t_phase = time.perf_counter()
    # the kernels at the shard-local shapes: Llama-2-7B at tp=2, and a
    # 70B shape (64 query heads on 8 KV heads) at tp=4
    shard_kres = {}
    for qh, kv, label in ((16, 16, "7b-tp2-shard"),
                          (16, 2, "70b-tp4-shard")):
        res = phase_kernels(att, kv_quant, torch, dev, qh, kv, ("fp",),
                            f" {label}")
        res.update(phase_tree_kernels(att, kv_quant, torch, dev, qh, kv,
                                      ("fp",), f" {label}"))
        shard_kres[label] = res
    log(f"tensor parallel: shard-local kernels done in "
        f"{time.perf_counter() - t_phase:.1f}s")

    # (a) parity, float32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def where(tp):
        return (dict(device=dev) if tp == 1
                else dict(mesh=make_mesh({"tp": tp}, devices)))

    def shard_counts(probes, n):
        return [dict(c) for c in probes] if probes else [n]

    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=1024,
              max_spec_tokens=8)
    cfg = serve.ServeModelConfig(num_hidden_layers=4, dtype="float32")
    dcfg = draft_config(serve, "float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in (560, 200)]
    gen = serve.GenerationConfig(max_new_tokens=16)
    pbc, _ = serve.PrefillBatchConfig.build(
        [(0, prompts[0][:128], 0)], [128], 128, max_tokens=128,
        max_requests=2, device=dev)

    def deploy(tp, c, seed, topk=0, **extra):
        im = serve.InferenceManager(serve.build_model(c), topk=topk,
                                    **dict(kw, **extra), **where(tp))
        return im.init_operators_inference(seed=seed)

    def llama_paths(tp):
        llm, ssm = deploy(tp, cfg, 1), deploy(tp, dcfg, 2, topk=2)
        logits = llm.forward(pbc).cpu()
        probes = shard_probe(att, llm.shards) if tp > 1 else None
        outs, per = {}, {}
        for path, fn in (
                ("incremental", lambda: serve.RequestManager(
                    llm, gen).generate(prompts)),
                ("spec host", lambda: serve.SpecInferManager(
                    llm, ssm, gen, width=2, depth=3).generate(prompts)),
                ("spec device", lambda: scan_streams(
                    serve, llm, ssm, prompts, 16))):
            llm.reset()
            ssm.reset()
            for c in probes or ():
                c.clear()
            outs[path], n = counted(att, fn)
            per[path] = shard_counts(probes, n)
        calls = dict(llm.mesh.comm.calls) if tp > 1 else None
        del llm, ssm
        llm = deploy(tp, cfg, 1, kv_dtype="int8", kv_page_size=PAGE)
        serve.quantize_int8(llm)
        probes = shard_probe(att, llm.shards) if tp > 1 else None
        outs["int8+paged"], n = counted(att, lambda: serve.RequestManager(
            llm, gen).generate(prompts))
        per["int8+paged"] = shard_counts(probes, n)
        del llm
        gc.collect()
        torch.cuda.empty_cache()
        return logits, outs, per, calls

    t0 = time.perf_counter()
    logits1, want, _, _ = llama_paths(1)          # recorded, then freed
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    logits2, got, per, calls = llama_paths(2)
    t_two = time.perf_counter() - t0
    err = (logits2 - logits1).abs().max().item()
    torch.testing.assert_close(logits2, logits1, atol=1e-3, rtol=1e-3)
    needs = {"incremental": ("fp", ("decode_attention", "prefill_attention")),
             "spec host": ("fp", ("tree_attention",)),
             "spec device": ("fp", ("tree_attention_batched",)),
             "int8+paged": ("int8+paged", ("decode_attention",
                                           "prefill_attention"))}
    for path, toks in got.items():
        if toks != want[path]:
            raise AssertionError(f"tp=2 {path}: {toks} != tp=1 "
                                 f"{want[path]}")
        variant, names = needs[path]
        if len(per[path]) != 2:
            raise AssertionError(f"tp=2 {path}: launches of "
                                 f"{len(per[path])} shards")
        for rank, n in enumerate(per[path]):
            require_launches(collections.Counter(n),
                             f"tp=2 {path} shard {rank}", variant, names)
    log(f"tensor parallel (a): 4-layer 7B-width f32, tp=2 on one card == "
        f"tp=1 on incremental, spec host, spec device and int8 weights + "
        f"int8 paged KV ({got['incremental'][0][:4]}...); prefill logits "
        f"max |diff| {err:.3e}; serve tp=1 {t_one:.1f}s, tp=2 "
        f"{t_two:.1f}s; collective calls {calls}")
    for path, shards in per.items():
        log(f"tensor parallel (a) {path}: launches per shard " + " | ".join(
            str(short(n)) for n in shards))

    fam_gen = serve.GenerationConfig(max_new_tokens=16)
    fkw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=512)
    for family, fcfg in (
            ("starcoder", starcoder_config(serve, n_layer=2,
                                           torch_dtype="float32")),
            ("mpt", mpt7b_config(serve, n_layers=2, torch_dtype="float32"))):
        rng = np.random.default_rng(8)
        fprompts = [rng.integers(3, fcfg.vocab_size, size=n).tolist()
                    for n in (64, 200)]
        variant = "fp+alibi" if fcfg.use_alibi else "fp"
        names = (("decode_attention",) if fcfg.use_alibi
                 else ("decode_attention", "prefill_attention"))
        streams = {}
        for tp in (1, 2):
            im = serve.InferenceManager(serve.build_model(fcfg), **fkw,
                                        **where(tp))
            im.init_operators_inference(seed=5)
            probes = shard_probe(att, im.shards) if tp > 1 else None
            streams[tp], n = counted(att, lambda: serve.RequestManager(
                im, fam_gen).generate(fprompts))
            for rank, c in enumerate(shard_counts(probes, n)):
                require_launches(collections.Counter(c),
                                 f"{family} tp={tp} shard {rank}", variant,
                                 names)
            sharded = sum(m.head_sharded for m in im.model.modules()
                          if isinstance(m, serve.ops.IncMultiHeadSelfAttention))
            del im
            gc.collect()
            torch.cuda.empty_cache()
        if streams[2] != streams[1]:
            raise AssertionError(f"{family}: tp=2 {streams[2]} != tp=1 "
                                 f"{streams[1]}")
        log(f"tensor parallel (a) {family}: 2-layer full-width f32 "
            f"({fcfg.num_attention_heads} heads on {fcfg.kv_heads} KV heads, "
            f"{sharded} of {fcfg.num_hidden_layers} attention layers "
            f"head-sharded), tp=2 == tp=1 {streams[2][0][:4]}...; "
            f"launches per shard " + " | ".join(
                str(short(c)) for c in shard_counts(probes, n)))

    # (b) the bf16 7B through LLM.compile(tp=2), two shards on one card;
    # no stop token, so every request runs its 64 tokens
    cfg = serve.ServeModelConfig(dtype="bfloat16", eos_token_id=None)
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
                generation_config=serve.GenerationConfig(max_new_tokens=64))
    prompts = serve_prompts(cfg.vocab_size)
    def serve_once(tp):
        """One deployment's run (its names die with the call, so the
        ``tp=1`` deployment is freed before ``tp=2`` is built)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        llm = serve.LLM(cfg).compile(
            **caps, **(dict(device=dev) if tp == 1
                       else dict(tp=2, devices=devices)))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        stamps = {}
        inner = llm.rm._append_token

        def stamped(req, tok):
            inner(req, tok)
            stamps.setdefault(req.rid, []).append(time.perf_counter())

        llm.rm._append_token = stamped
        calls0 = dict(llm.im.mesh.comm.calls) if tp > 1 else {}
        t0 = time.perf_counter()
        outs, n = counted(att, lambda: llm.generate(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_streams(outs, 64, cfg.vocab_size, f"serve tp={tp}")
        require_launches(n, f"serve tp={tp}", "fp",
                         ("decode_attention", "prefill_attention"))
        ttft, tpot = stream_times(stamps, t0)
        w = [sum(p.numel() * p.element_size() for p in m.parameters())
             for m in llm.im.shards]
        calls = {k: v - calls0.get(k, 0)
                 for k, v in (llm.im.mesh.comm.calls.items() if tp > 1
                              else ())}
        where_ = ("two shards on one card" if tp > 1 else "one device")
        log(f"tensor parallel (b) bf16 7B tp={tp} ({where_}) through "
            f"LLM.compile: init {t_init:.1f}s, wall {wall:.2f}s, "
            f"{sum(map(len, outs)) / wall:.1f} tok/s, mean TTFT "
            f"{sum(ttft) / len(ttft):.3f}s, mean TPOT "
            f"{sum(tpot) / len(tpot):.2f} ms; weights per shard GB "
            f"{[round(x / 1e9, 3) for x in w]}, KV per shard "
            f"{llm.im.kv.allocated_bytes(per_device=True) / 1e9:.3f} GB; "
            f"collective calls {calls}; launches {short(n)}; "
            f"max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"tensor parallel (b) tp={tp}: TTFT s " + " ".join(
            f"{x:.3f}" for x in ttft) + " | TPOT ms " + " ".join(
            f"{x:.2f}" for x in tpot))
        llm.rm._append_token = inner     # no cycle keeps the deployment
        return outs, n

    streams, launches = {}, {}
    for tp in (1, 2):
        streams[tp], launches[tp] = serve_once(tp)
    log(f"tensor parallel (b): tp=2 tokens equal to tp=1 "
        f"{equal_share(streams[2], streams[1]):.4f} (bf16: printed, not "
        f"required)")
    gc.collect()
    torch.cuda.empty_cache()
    f32 = collections.Counter()
    for path in ("incremental", "spec host", "spec device"):
        for n in per[path]:
            f32.update(n)
    return {"kernels": shard_kres, "f32": f32, "bf16": launches[2]}


def phase_pipeline_parallel(serve, att, torch, dev):
    """Phase 18: pipeline-parallel serving, every stage on the one card.
    (a) Llama-2-7B at full width, 4 layers, float32, ``pp=2`` with two
    micro-batches against ``pp=1`` on incremental, host speculation with
    a pipelined target, int8 weights + int8 KV + 512-position pages and
    ``pp=2 x tp=2``; each stage's own K1 and K2 once per micro-batch; a
    ``tp1 -> pp2`` live migration mid-stream.  (b) the bf16 7B at full
    depth through ``RequestManager.generate`` at ``pp=2``, ``n_micro`` 2
    and 1, beside ``pp=1``.  Returns the ``pp=2`` runs' launches, summed
    over stages and shards: ``"f32"`` of (a)'s fp paths at the 7B's heads,
    ``"f32 shard"`` of (a)'s ``pp=2 x tp=2`` run at a shard's heads,
    ``"bf16"`` of (b)'s two runs."""
    import gc

    import numpy as np

    from flexflow_tpu_torch.obs import Telemetry
    from flexflow_tpu_torch.parallel import make_mesh

    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=1024,
              max_spec_tokens=8)
    cfg = serve.ServeModelConfig(num_hidden_layers=4, dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in (560, 200)]
    gen = serve.GenerationConfig(max_new_tokens=16)
    pbc, _ = serve.PrefillBatchConfig.build(
        [(0, prompts[0][:128], 0)], [128], 128, max_tokens=128,
        max_requests=2, device=dev)

    def deploy(pp, tp=1, seed=1, **extra):
        if pp == 1:
            im = serve.InferenceManager(serve.build_model(cfg), device=dev,
                                        **dict(kw, **extra))
        else:
            im = serve.PipelinedInferenceManager(
                serve.build_model(cfg), mesh=make_mesh(
                    {"pp": pp, "tp": tp}, [dev] * (pp * tp)), n_micro=2,
                **dict(kw, **extra))
        return im.init_operators_inference(seed=seed)

    ssm = serve.InferenceManager(serve.build_model(draft_config(
        serve, "float32")), device=dev, topk=2, **kw)
    ssm.init_operators_inference(seed=2)

    def paths(pp, tp=1):
        """{path: streams}, {path: per-(stage, shard) launches}, the
        prefill logits."""
        outs, per = {}, {}
        llm = deploy(pp, tp)
        logits = (llm.forward(pbc) if pp == 1 else llm.step(pbc).logits)
        logits = logits.cpu()
        todo = [("incremental", lambda: serve.RequestManager(
            llm, gen).generate(prompts))]
        if tp == 1:
            todo.append(("spec host", lambda: serve.SpecInferManager(
                llm, ssm, gen, width=2, depth=3).generate(prompts)))
        for path, fn in todo:
            llm.reset()
            ssm.reset()
            probes = shard_probe(att, llm.shards) if pp > 1 else None
            outs[path], n = counted(att, fn)
            per[path] = [dict(c) for c in probes] if probes else [n]
        if pp > 1:
            # one decode macro step: each stage's own K1, once per
            # micro-batch (two layers a stage, two micro-batches)
            llm.reset()
            probes = shard_probe(att, llm.shards)
            bc = serve.BatchConfig.build(
                [5, 7], [0, 1], [3, 3], [4, 4], max_tokens=128,
                max_requests=2, device=dev)
            counted(att, lambda: llm.step(bc))
            k1 = [c[("decode_attention", "fp")] for c in probes]
            want_k1 = cfg.num_hidden_layers // pp * llm.n_micro
            if k1 != [want_k1] * len(probes):
                raise AssertionError(f"pp={pp} tp={tp}: K1 per stage and "
                                     f"shard {k1} on one decode step, not "
                                     f"{want_k1} each")
        del llm
        if tp == 1:
            llm = deploy(pp, kv_dtype="int8", kv_page_size=PAGE,
                         max_spec_tokens=0)
            serve.quantize_int8(llm)
            probes = shard_probe(att, llm.shards) if pp > 1 else None
            outs["int8+paged"], n = counted(
                att, lambda: serve.RequestManager(llm, gen).generate(
                    prompts))
            per["int8+paged"] = [dict(c) for c in probes] if probes else [n]
            del llm
        gc.collect()
        torch.cuda.empty_cache()
        return outs, per, logits

    t_phase = time.perf_counter()
    want, _, logits1 = paths(1)
    got, per, logits2 = paths(2)
    got_tp, per_tp, logits4 = paths(2, tp=2)
    err = (logits2 - logits1).abs().max().item()
    err_tp = (logits4 - logits1).abs().max().item()
    torch.testing.assert_close(logits2, logits1, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(logits4, logits1, atol=1e-3, rtol=1e-3)
    needs = {"incremental": ("fp", ("decode_attention",
                                    "prefill_attention")),
             "spec host": ("fp", ("tree_attention",)),
             "int8+paged": ("int8+paged", ("decode_attention",
                                           "prefill_attention"))}
    for label, outs, counts, models in (("pp=2", got, per, 2),
                                        ("pp=2 x tp=2", got_tp, per_tp, 4)):
        for path, toks in outs.items():
            if toks != want[path]:
                raise AssertionError(f"{label} {path}: {toks} != pp=1 "
                                     f"{want[path]}")
            if len(counts[path]) != models:
                raise AssertionError(f"{label} {path}: launches of "
                                     f"{len(counts[path])} stage models")
            variant, names = needs[path]
            for i, n in enumerate(counts[path]):
                require_launches(collections.Counter(n),
                                 f"{label} {path} stage {i // (models // 2)}"
                                 f" shard {i % (models // 2)}", variant,
                                 names)
    log(f"pipeline parallel (a): 4-layer 7B-width f32, pp=2 (n_micro=2) on "
        f"one card == pp=1 on incremental, spec host (a pipelined target) "
        f"and int8 weights + int8 paged KV ({got['incremental'][0][:4]}...),"
        f" pp=2 x tp=2 == pp=1 on incremental; prefill logits max |diff| "
        f"pp=2 {err:.3e}, pp=2 x tp=2 {err_tp:.3e}; one decode step: each "
        f"stage's K1 once a layer and micro-batch")
    for label, counts in (("pp=2", per), ("pp=2 x tp=2", per_tp)):
        for path, models in counts.items():
            log(f"pipeline parallel (a) {label} {path}: launches per stage"
                f" model " + " | ".join(str(short(collections.Counter(n)))
                                        for n in models))

    # tp1 -> pp2 live migration mid-stream: the unmigrated streams
    incumbent = deploy(1, max_spec_tokens=0)
    rm = serve.RequestManager(incumbent, gen)
    rm._sleep = lambda s: None
    rm.scan_chunk = 2
    ctrl = serve.MigrationController(
        rm, lambda cand: deploy(2, max_spec_tokens=0),
        plan={"plan_key": "tp1_pp1_m1"},
        config=serve.MigrationConfig(defer_ticks=2, drain_grace_ticks=1))
    ctrl.request_migration("tp1_pp2_m2")
    migrated = rm.generate(prompts)
    rec = ctrl.history[-1]
    if (migrated != want["incremental"] or rec["outcome"] != "completed"
            or rec["preempted_requests"] == 0 or ctrl.rm.im.pp != 2
            or incumbent.state is not None):
        raise AssertionError(f"tp1 -> pp2 migration: {rec}, streams "
                             f"{migrated} != {want['incremental']}")
    log(f"pipeline parallel (a): tp1 -> pp2 live migration mid-decode "
        f"({rec['preempted_requests']} requests preempted) == the "
        f"unmigrated streams")
    del incumbent, rm, ctrl, ssm
    gc.collect()
    torch.cuda.empty_cache()
    log(f"pipeline parallel (a) done in {time.perf_counter() - t_phase:.1f}s")

    # (b) the bf16 7B at full depth; no stop token, so every request runs
    # its 64 tokens
    cfg = serve.ServeModelConfig(dtype="bfloat16", eos_token_id=None)
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    prompts = serve_prompts(cfg.vocab_size)
    gen = serve.GenerationConfig(max_new_tokens=64)

    def serve_once(pp, n_micro=None):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if pp == 1:
            im = serve.InferenceManager(serve.build_model(cfg), device=dev,
                                        **caps)
        else:
            im = serve.PipelinedInferenceManager(
                serve.build_model(cfg), mesh=make_mesh({"pp": pp},
                                                       [dev] * pp),
                n_micro=n_micro, **caps)
        im.init_operators_inference(seed=0)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        stamps = {}
        tel = Telemetry()
        rm = serve.RequestManager(im, gen, telemetry=tel)
        inner = rm._append_token

        def stamped(req, tok):
            inner(req, tok)
            stamps.setdefault(req.rid, []).append(time.perf_counter())

        rm._append_token = stamped
        t0 = time.perf_counter()
        outs, n = counted(att, lambda: rm.generate(prompts))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check_streams(outs, 64, cfg.vocab_size, f"serve pp={pp}")
        require_launches(n, f"serve pp={pp}", "fp",
                         ("decode_attention", "prefill_attention"))
        ttft, tpot = stream_times(stamps, t0)
        groups = getattr(im, "shard_groups", [[im.model]])
        w = [sum(p.numel() * p.element_size() for p in g[0].parameters())
             for g in groups]
        kv = (im.kv.stage_bytes(per_device=True))
        hops = tel.metrics.snapshot().get("pp_hops", 0)
        label = f"pp={pp}" + (f" n_micro={im.n_micro}" if pp > 1 else "")
        log(f"pipeline parallel (b) bf16 7B {label} (one card): init "
            f"{t_init:.1f}s, wall {wall:.2f}s, "
            f"{sum(map(len, outs)) / wall:.1f} tok/s, mean TTFT "
            f"{sum(ttft) / len(ttft):.3f}s, mean TPOT "
            f"{sum(tpot) / len(tpot):.2f} ms; weights per stage GB "
            f"{[round(x / 1e9, 3) for x in w]}, KV per stage GB "
            f"{[round(x / 1e9, 3) for x in kv]}; pp_hops {hops}; launches "
            f"{short(n)}; max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"pipeline parallel (b) {label}: TTFT s " + " ".join(
            f"{x:.3f}" for x in ttft) + " | TPOT ms " + " ".join(
            f"{x:.2f}" for x in tpot))
        rm._append_token = inner
        return outs, n

    t0 = time.perf_counter()
    streams, launches = {}, {}
    for key, pp, m in (("pp1", 1, None), ("pp2_m2", 2, 2), ("pp2_m1", 2, 1)):
        streams[key], launches[key] = serve_once(pp, m)
    log(f"pipeline parallel (b): tokens equal to pp=1: n_micro=2 "
        f"{equal_share(streams['pp2_m2'], streams['pp1']):.4f}, n_micro=1 "
        f"{equal_share(streams['pp2_m1'], streams['pp1']):.4f} (bf16: "
        f"printed, not required); (b) done in "
        f"{time.perf_counter() - t0:.1f}s")
    gc.collect()
    torch.cuda.empty_cache()
    f32, f32_shard = collections.Counter(), collections.Counter()
    for path in ("incremental", "spec host"):
        for n in per[path]:
            f32.update(n)
        for n in per_tp.get(path, []):
            f32_shard.update(n)
    bf16 = collections.Counter(launches["pp2_m2"])
    bf16.update(launches["pp2_m1"])
    return {"f32": f32, "f32 shard": f32_shard, "bf16": bf16}


def llama70b_config(serve):
    """Llama-2-70B's published shape (``meta-llama/Llama-2-70b-hf``), bf16:
    80 layers, hidden 8192, 64 query heads on 8 KV heads, ffn 28672,
    vocabulary 32000 (priced on ``meta``, never allocated)."""
    return serve.ServeModelConfig(
        dtype="bfloat16", num_hidden_layers=80, hidden_size=8192,
        num_attention_heads=64, num_key_value_heads=8,
        intermediate_size=28672, vocab_size=32000)


def phase_planner(serve, torch, dev, ttft, tpot, card):
    """Phase 19: the serve planner.  (a) The card's machine model:
    ``MachineModel.for_mesh`` of a CUDA mesh is ``h100``, with the
    constants ``artifacts/h100_calib.json`` measured; ``mxu_efficiency``
    and the host link measured again here, beside the artifact's.  (b)
    ``search_serve_plan`` of bf16 Llama-2-7B on ``meta`` at phase 7's
    capacities on ``["cuda:0"]`` must choose ``tp1_pp1_m1``; its predicted
    TPOT, TTFT and per-stage GB beside phase 7's measured TPOT and TTFT
    (the same deployment, no second serve), and both into a
    ``CalibrationLedger``.  (c) Llama-2-70B bf16 on ``meta``: one card
    must refuse ("nothing fits": 138 GB of weights), four cards (priced
    over ``["cuda:0"] * 4``, nothing allocated) must give a plan whose
    stages fit 80 GB; the candidate table printed."""
    from flexflow_tpu_torch import search
    from flexflow_tpu_torch.obs import CalibrationLedger
    from flexflow_tpu_torch.parallel import make_mesh
    from flexflow_tpu_torch.search import measure

    t0 = time.perf_counter()
    calib = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "artifacts", "h100_calib.json")
    with open(calib) as f:
        doc = json.load(f)
    mm = search.MachineModel.for_mesh(make_mesh({"tp": 1}, ["cuda:0"]))
    if mm.spec.name != "h100":
        raise AssertionError(f"a CUDA mesh priced as {mm.spec.name}")
    mm = mm.with_calibration(calib)
    eff, gemm_ms = measure.probe_mxu_efficiency(dev, mm.spec.peak_flops_bf16)
    bw, lat, _ = measure.probe_host_link(dev)
    log(f"planner (a): {card}: mxu_efficiency {eff:.4f} (GEMM "
        f"{gemm_ms:.4f} ms; artifact {doc['mxu_efficiency']:.4f}), host "
        f"link {bw / 1e9:.2f} GB/s + {lat * 1e6:.1f} us (artifact "
        f"{doc['host_bandwidth'] / 1e9:.2f} GB/s + "
        f"{doc['host_latency'] * 1e6:.1f} us), step_overhead (artifact) "
        f"{doc['step_overhead'] * 1e6:.2f} us; artifact card {doc['card']}")

    def priced(cfg, max_spec):
        model = serve.build_model(cfg)
        serve.register_serve_capacities(model, 8, 2048, max_spec,
                                        max_tokens_per_batch=512)
        serve.mark_gated_lm_head(model, 8)
        return model

    cfg = serve.ServeModelConfig(dtype="bfloat16")
    model = priced(cfg, 8)
    lens = [len(p) for p in serve_prompts(cfg.vocab_size)]
    wl = {"mean_prompt_len": sum(lens) / len(lens), "mean_output_len": 64.0,
          "arrival_rate_per_s": 0.0, "mean_occupancy": 1.0}
    bare = search.search_serve_plan(model, 1, machine=mm,
                                    devices=["cuda:0"], calibration=None)
    best = search.search_serve_plan(model, 1, machine=mm,
                                    devices=["cuda:0"], calibration=None,
                                    workload=wl)
    for plan in (bare, best):
        if plan["plan_key"] != "tp1_pp1_m1":
            raise AssertionError(f"7B on one card: {plan['plan_key']}")
    for label, plan in (("full KV", bare), ("the 8 prompts", best)):
        comps = " ".join(f"{k[:-3]} {v:.4f}"
                         for k, v in plan["components_ms"].items())
        log(f"planner (b): 7B bf16 tp1_pp1_m1, {label}: predicted TPOT "
            f"{plan['tpot_ms']:.4f} ms ({comps}), per-stage "
            f"{plan['per_stage_gb']} GB, parts "
            f"{plan['memory_parts_gb']} GB")
    log(f"planner (b): predicted TPOT {best['tpot_ms']:.4f} ms, TTFT "
        f"{best['ttft_ms']:.4f} ms (mean prompt {wl['mean_prompt_len']:.1f}"
        f" tokens) | measured (phase 7) TPOT {tpot:.4f} ms, TTFT "
        f"{ttft * 1e3:.4f} ms: measured/predicted TPOT "
        f"{tpot / best['tpot_ms']:.3f}, TTFT "
        f"{ttft * 1e3 / best['ttft_ms']:.3f}")
    led = CalibrationLedger()
    led.predict(best["plan_key"], tpot_ms=best["tpot_ms"],
                ttft_ms=best["ttft_ms"])
    led.measure(best["plan_key"], tpot_ms=tpot, ttft_ms=ttft * 1e3)
    comps = led.report()["components"]
    log("planner (b): suggested scales " + ", ".join(
        f"{k} {v['suggested_scale']:.4f}" for k, v in sorted(comps.items())))

    m70 = priced(llama70b_config(serve), 0)
    try:
        search.search_serve_plan(m70, 1, machine=mm, devices=["cuda:0"],
                                 calibration=None)
    except ValueError as e:
        if "fits" not in str(e):
            raise
        log(f"planner (c): 70B bf16 on one card refused: {str(e)[:160]}")
    else:
        raise AssertionError("70B bf16 priced as fitting one card")
    best70 = search.search_serve_plan(m70, 4, machine=mm,
                                      devices=["cuda:0"] * 4,
                                      calibration=None)
    if max(best70["per_stage_gb"]) > mm.spec.hbm_capacity / 1e9:
        raise AssertionError(f"70B plan over 80 GB: {best70}")
    for key, c in best70["candidates"].items():
        tpots = " ".join(f"m{m} {v['tpot_ms']:.3f}"
                         for m, v in c.get("by_micro", {}).items())
        log(f"planner (c): 70B {key}: fits {c.get('fits')}, per-stage "
            f"{c.get('per_stage_gb')} GB, TPOT ms {tpots}")
    log(f"planner (c): 70B on 4 cards: {best70['plan_key']}, TPOT "
        f"{best70['tpot_ms']:.4f} ms, per-stage {best70['per_stage_gb']} "
        f"GB; phase 19 done in {time.perf_counter() - t0:.1f}s")
    return best, best70


def sample_strategy(layers):
    """The dict the search chooses for a TINY Llama at ``tp=2``:
    ``sample`` (rows of the flat batch) on the attention, the MLP and the
    LM head of every layer."""
    tp = ("tp",)
    out = {"lm_head": {"sample": tp}}
    for i in range(layers):
        for n in ("self_attn", "post_attention_layernorm", "mlp.gate_proj",
                  "mlp.up_proj", "mlp.act", "mlp.down_proj"):
            out[f"model.layers.{i}.{n}"] = {"sample": tp}
    return out


def mixed_strategy(layers):
    """A hand dict: even layers Megatron's (``head``, ``channel_out``,
    ``channel_in``), odd layers ``sample`` beside a ``channel_out`` up
    projection (an all-to-all moves its split), the embedding split on
    its vocabulary (``entry``), the LM head on its rows."""
    tp = ("tp",)
    out = {"model.embed_tokens": {"entry": tp}, "lm_head": {"sample": tp}}
    for i in range(layers):
        p = f"model.layers.{i}"
        if i % 2 == 0:
            out.update({f"{p}.self_attn": {"head": tp},
                        f"{p}.mlp.gate_proj": {"channel_out": tp},
                        f"{p}.mlp.up_proj": {"channel_out": tp},
                        f"{p}.mlp.down_proj": {"channel_in": tp}})
        else:
            out.update({f"{p}.self_attn": {"sample": tp},
                        f"{p}.mlp.gate_proj": {"sample": tp},
                        f"{p}.mlp.up_proj": {"channel_out": tp},
                        f"{p}.mlp.down_proj": {"sample": tp}})
    return out


def strategy_summary(im):
    """The configs a plan's dict uses and its parallel steps, counted."""
    cfgs = collections.Counter(k for v in im.strategy.values() for k in v)
    steps = collections.Counter(s.node.op.type_name for s in im.plan.steps
                                if s.is_parallel)
    return dict(cfgs), dict(steps)


def phase_searched_strategy(serve, att, torch, dev, card):
    """Phase 20: serving under a searched strategy and under hand dicts,
    two shards on the one card.  (a) float32 parity with ``tp=1``; (b)
    the bf16 7B under ``strategy="search"``, its priced and its measured
    costs.  Returns the launches summed over the shards: ``"f32"`` of
    (a), ``"bf16"`` of (b)."""
    import gc

    import numpy as np

    from flexflow_tpu_torch import search
    from flexflow_tpu_torch.core.pcg import PCG, serve_graph
    from flexflow_tpu_torch.parallel import make_mesh
    from flexflow_tpu_torch.parallel.tp import tensor_parallel_strategy

    gc.collect()
    torch.cuda.empty_cache()
    mesh2 = make_mesh({"tp": 2}, [dev, dev])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(max_requests=2, max_tokens_per_batch=128, max_seq_len=1024,
              max_spec_tokens=8)
    cfg = serve.ServeModelConfig(num_hidden_layers=4, dtype="float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in (560, 200)]
    gen = serve.GenerationConfig(max_new_tokens=16)

    def deploy(strategy, c=cfg, seed=1, topk=0, one=False):
        im = serve.InferenceManager(
            serve.build_model(c), topk=topk, **kw,
            **(dict(device=dev) if one else dict(mesh=mesh2,
                                                 strategy=strategy)))
        return im.init_operators_inference(seed=seed)

    t0 = time.perf_counter()
    one = deploy(None, one=True)
    want = serve.RequestManager(one, gen).generate(prompts)
    ssm = deploy(None, draft_config(serve, "float32"), 2, topk=2, one=True)
    want_spec = serve.SpecInferManager(one, ssm, gen, width=2,
                                       depth=3).generate(prompts)
    del one
    gc.collect()
    f32 = collections.Counter()
    for label, strategy in (("search", "search"),
                            ("sample", sample_strategy(4)),
                            ("mixed", mixed_strategy(4))):
        t1 = time.perf_counter()
        im = deploy(strategy)
        t_build = time.perf_counter() - t1
        probes = shard_probe(att, im.shards)
        calls0 = im.mesh.comm.calls["local"]
        paths = [("incremental", lambda: serve.RequestManager(
            im, gen).generate(prompts), want,
            ("decode_attention", "prefill_attention"))]
        if label == "search":
            paths.append(("spec host", lambda: serve.SpecInferManager(
                im, ssm, gen, width=2, depth=3).generate(prompts),
                want_spec, ("prefill_attention", "tree_attention")))
        for path, fn, ref, names in paths:
            im.reset()
            ssm.reset()
            for c in probes:
                c.clear()
            got, _ = counted(att, fn)
            if got != ref:
                raise AssertionError(f"searched strategy (a) {label} "
                                     f"{path}: {got} != tp=1 {ref}")
            for rank, c in enumerate(probes):
                require_launches(collections.Counter(c), f"strategy "
                                 f"{label} {path} shard {rank}", "fp",
                                 names)
                f32.update(c)
            log(f"searched strategy (a) {label} {path}: tp=2 == tp=1 "
                f"({got[0][:4]}...); launches per shard " + " | ".join(
                    str(short(c)) for c in probes))
        cfgs, steps = strategy_summary(im)
        log(f"searched strategy (a) {label}: built in {t_build:.1f}s, "
            f"configs {cfgs}, parallel steps {steps}, collective calls "
            f"{im.mesh.comm.calls['local'] - calls0}")
        if label == "search":
            log(f"searched strategy (a) search dict: {im.strategy}")
        del im
        gc.collect()
        torch.cuda.empty_cache()
    del ssm
    log(f"searched strategy (a) done in {time.perf_counter() - t0:.1f}s")

    # (b) the bf16 7B at full depth, searched on the card's machine model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = serve.ServeModelConfig(dtype="bfloat16", eos_token_id=None)
    caps = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048)
    t0 = time.perf_counter()
    im = serve.InferenceManager(serve.build_model(cfg), mesh=mesh2,
                                strategy="search", **caps)
    t_search = time.perf_counter() - t0
    im.init_operators_inference(seed=3)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    mm = serve.inference_manager.default_machine(mesh2)
    priced = serve.build_model(cfg)
    serve.register_serve_capacities(priced, 8, 2048, 0,
                                    max_tokens_per_batch=512)
    serve.mark_gated_lm_head(priced, 8)
    graph = serve_graph(priced, 512)
    costs = {}
    for label, strategy in (("searched", im.strategy),
                            ("megatron", tensor_parallel_strategy(priced, 2)),
                            ("none", {})):
        plan = PCG(graph, mesh2, strategy).plan()
        costs[label] = (search.simulate(plan, mm, training=False).total
                        * 1e3, search.plan_memory_bytes(
                            plan, training=False) / 1e9)
    cfgs, steps = strategy_summary(im)
    log(f"searched strategy (b): bf16 7B (32 layers, 4096 hidden, 32 "
        f"heads) searched on {mm.spec.name} (mxu_efficiency "
        f"{mm.spec.mxu_efficiency:.4f}) in {t_search:.1f}s, built in "
        f"{t_init:.1f}s; configs {cfgs}, parallel steps {steps}")
    log(f"searched strategy (b) dict: {im.strategy}")
    for label, (ms, gb) in costs.items():
        log(f"searched strategy (b) {label}: simulate total {ms:.4f} ms a "
            f"step of 512 rows, plan_memory_bytes {gb:.3f} GB a device")
    prompts = serve_prompts(cfg.vocab_size)
    rm = serve.RequestManager(im, serve.GenerationConfig(max_new_tokens=64))
    stamps = {}
    inner = rm._append_token

    def stamped(req, tok):
        inner(req, tok)
        stamps.setdefault(req.rid, []).append(time.perf_counter())

    rm._append_token = stamped
    calls0 = im.mesh.comm.calls["local"]
    t0 = time.perf_counter()
    outs, n = counted(att, lambda: rm.generate(prompts))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check_streams(outs, 64, cfg.vocab_size, "searched 7B")
    require_launches(n, "searched 7B", "fp",
                     ("decode_attention", "prefill_attention"))
    ttft, tpot = stream_times(stamps, t0)
    mean_tpot = sum(tpot) / len(tpot)
    w = [sum(p.numel() * p.element_size() for p in m.parameters())
         for m in im.shards]
    log(f"searched strategy (b) on {card}: 8 requests x 64 tokens, wall "
        f"{wall:.2f}s, mean TTFT {sum(ttft) / len(ttft):.4f}s, mean TPOT "
        f"{mean_tpot:.3f} ms; measured TPOT / simulated step "
        f"{mean_tpot / costs['searched'][0]:.2f}; weights per shard GB "
        f"{[round(x / 1e9, 3) for x in w]}, KV per shard "
        f"{im.kv.allocated_bytes(per_device=True) / 1e9:.3f} GB; collective "
        f"calls {im.mesh.comm.calls['local'] - calls0}; launches {short(n)}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}"
        f" GB")
    log("searched strategy (b): TTFT s " + " ".join(
        f"{x:.4f}" for x in ttft) + " | TPOT ms " + " ".join(
        f"{x:.3f}" for x in tpot))
    rm._append_token = inner
    del rm, im
    gc.collect()
    torch.cuda.empty_cache()
    return {"f32": f32, "bf16": collections.Counter(n)}


TRAIN_STEPS = 3          # phase 21(a): steps of each optimizer
# phase 21's classifier at BERT-base width
BERT_BASE = dict(hidden_dim=768, num_heads=12, ff_dim=3072, num_classes=16,
                 batch=8)


def step_timer(model, torch, losses=None):
    """Wrap ``model``'s train step so each step runs between two
    ``torch.cuda.synchronize``; returns the list its seconds go to (and
    appends each step's loss to ``losses``, read after the second
    synchronize)."""
    times = []
    inner = model._train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if losses is not None:
            losses.append(float(out[0]))
        return out

    model._train_step = timed_step
    return times


def count_collectives(comm):
    """Count ``comm``'s calls by kind (all_reduce, all_gather, gather,
    shift):
    each method wrapped on this instance; returns the counter."""
    counts = collections.Counter()
    for kind in ("all_reduce", "all_gather", "gather", "shift"):
        fn = getattr(comm, kind)

        def counted_call(*args, _fn=fn, _kind=kind, **kw):
            counts[_kind] += 1
            return _fn(*args, **kw)

        setattr(comm, kind, counted_call)
    return counts


def forward_flops(model):
    """The forward flops of ``model``'s op steps (each op's ``flops``)."""
    return sum(st.node.op.flops(st.in_specs) for st in model.plan.steps
               if not st.is_parallel)


def train_parity(ff, build, kw, opt_cls, opt_kw, x, y, dev):
    """Phase 21(a), one optimizer: the classifier on the CPU and on the
    card from the same seeded weights (the CPU model's, through
    ``load_params``), ``TRAIN_STEPS`` steps through ``fit`` (one full
    batch an epoch, unshuffled).  Returns (losses on the CPU, on the card,
    max |param difference|, the parameters' names by that difference)."""
    import numpy as np

    runs = []
    for device in ("cpu", dev):
        m = build(ff.FFConfig(batch_size=kw["batch"], seed=0),
                  device=device, **kw)
        m.compile(optimizer=getattr(ff, opt_cls)(**opt_kw))
        if runs:
            m.load_params(runs[0][2])
        init = {n: {p: v.detach().cpu().clone() for p, v in g.items()}
                for n, g in m.params.items()}
        hist = m.fit(x, y, epochs=TRAIN_STEPS, shuffle=False,
                     verbose=False)
        runs.append(([h["loss"] for h in hist], m, init))
    (lc, cpu, _), (lg, card, _) = runs
    diffs = {}
    for n, g in cpu.params.items():
        for p, v in g.items():
            diffs[f"{n}.{p}"] = float(
                (card.params[n][p].detach().cpu() - v.detach()).abs().max())
    worst = sorted(diffs, key=diffs.get, reverse=True)[:3]
    return lc, lg, max(diffs.values()), [(k, diffs[k]) for k in worst]


def phase_training(torch, dev, card):
    """Phase 21: training on the card through ``FFModel`` (f32, TF32
    off).  (a) the BERT-base-width Transformer classifier (hidden 768, 12
    heads, ff 3072), 2 layers, batch 8, sequence 128, 16 classes: 3 steps
    of SGD (momentum 0.9) and 3 of Adam on the card against the CPU from
    the same weights and batches; (b) the same classifier at 12 layers and
    sequence 512 trained by ``fit`` with Adam (lr 1e-4) on a learnable
    synthetic set, 4 epochs: step time, throughput, the flops' share of
    the f32 rate, peak memory, the loss falling; (c) the MNIST MLP
    example, one epoch on the card, then ``evaluate``."""
    import contextlib
    import gc
    import io
    import re
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.examples import mnist_mlp
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    width, classes = BERT_BASE["hidden_dim"], BERT_BASE["num_classes"]

    # (a) card vs CPU
    kw = dict(BERT_BASE, seq=128, num_layers=2)
    rng = np.random.RandomState(0)
    x = rng.randn(kw["batch"], kw["seq"], width).astype(np.float32)
    y = rng.randint(0, classes, kw["batch"]).astype(np.int32)
    loss_rtol, sgd_atol = 1e-4, 1e-5
    for opt_cls, opt_kw in (("SGDOptimizer", dict(lr=0.01, momentum=0.9)),
                            ("AdamOptimizer", dict(alpha=1e-4))):
        lc, lg, err, worst = train_parity(ff, build, kw, opt_cls, opt_kw,
                                          x, y, dev)
        rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
        # Adam's step is about alpha whatever the gradient's size, so a
        # near-zero gradient's rounding (a key bias's, which the softmax
        # cancels) moves a parameter by up to alpha a step on each side
        atol = (2 * opt_kw["alpha"] * TRAIN_STEPS
                if opt_cls == "AdamOptimizer" else sgd_atol)
        log(f"training (a) {opt_cls} on {card}: losses cpu "
            f"{[round(v, 6) for v in lc]} card {[round(v, 6) for v in lg]},"
            f" max rel loss diff {rel:.3e} (tol {loss_rtol}), max abs "
            f"param diff {err:.3e} (tol {atol:.1e}); largest {worst}")
        if not all(np.isfinite(lg)) or rel > loss_rtol or err > atol:
            raise RuntimeError(f"training (a) {opt_cls}: card and CPU "
                               "differ beyond the tolerance")

    # (b) full depth
    kw = dict(BERT_BASE, seq=512, num_layers=12)
    n_samples, epochs, warm = 64, 4, 2
    rng = np.random.RandomState(1)
    x = rng.randn(n_samples, kw["seq"], width).astype(np.float32)
    proj = rng.randn(width, classes).astype(np.float32)
    y = np.argmax(x.mean(axis=1) @ proj, axis=-1).astype(np.int32)
    base = torch.cuda.memory_allocated()     # what earlier phases hold
    model = build(ff.FFConfig(batch_size=kw["batch"], seed=0), device=dev,
                  **kw)
    model.compile(optimizer=ff.AdamOptimizer(alpha=1e-4),
                  metrics=["accuracy"])
    fwd_flops = forward_flops(model)
    times = step_timer(model, torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = model.fit(x, y, epochs=epochs, verbose=False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    step = statistics.median(times[warm:])
    tokens = kw["batch"] * kw["seq"]
    peak_rate = PEAK_FLOPS["float32"]
    share = 3 * fwd_flops / step / peak_rate
    losses = [h["loss"] for h in hist]
    log(f"training (b) on {card}: 12 layers, hidden {width}, seq 512, "
        f"batch {kw['batch']}, Adam 1e-4, {n_samples} samples x {epochs} epochs "
        f"({len(times)} steps, fit wall {wall:.2f}s): median step "
        f"{step * 1e3:.3f} ms after {warm} warm-up (min "
        f"{min(times[warm:]) * 1e3:.3f}, max {max(times[warm:]) * 1e3:.3f});"
        f" {kw['batch'] / step:.2f} samples/s, {tokens / step:.0f} tokens/s;"
        f" 3 x forward flops {3 * fwd_flops / 1e12:.4f} TFLOP a step, "
        f"{3 * fwd_flops / step / 1e12:.2f} TFLOP/s = {share:.4f} of "
        f"{peak_rate / 1e12:.0f} TFLOP/s f32; peak memory "
        f"{peak / 1e9:.2f} GB (above the {base / 1e9:.2f} GB held before "
        "the model); epoch losses "
        f"{[round(v, 4) for v in losses]}, accuracy "
        f"{[round(h['accuracy'], 4) for h in hist]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training (b): the loss did not fall: {losses}")
    del model
    torch.cuda.empty_cache()

    # (c) the MNIST MLP example's defaults
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        final = mnist_mlp.main([])
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    log(text.rstrip())
    rate = re.search(r"([0-9.]+) samples/s", text)
    log(f"training (c) on {card}: mnist_mlp defaults (batch 64, 1 epoch, "
        f"8192 synthetic samples): {rate.group(1) if rate else '?'} "
        f"samples/s in the epoch, main() wall {wall:.2f}s, final accuracy "
        f"{final['accuracy']:.4f}")
    if final["accuracy"] < 0.99:
        raise RuntimeError(f"training (c): accuracy {final['accuracy']} "
                           "< 0.99")
    return step * 1e3


def megatron_strategy(graph, dp=True):
    """The classifier's Megatron dict over ``tp``: attention ``head``,
    ``ff1`` ``channel_out``, ``ff2`` ``channel_in``; ``sample`` over
    ``dp`` on every node (where the mesh has a ``dp`` axis)."""
    out = {}
    for node in graph.nodes:
        c = {"sample": ("dp",)} if dp else {}
        if node.name.endswith("_attn"):
            c["head"] = ("tp",)
        elif node.name.endswith("_ff1"):
            c["channel_out"] = ("tp",)
        elif node.name.endswith("_ff2"):
            c["channel_in"] = ("tp",)
        out[node.name] = c
    return out


def mesh_run(ff, build, kw, shape, dev, opt, init, x, y):
    """Phase 22(a), one mesh and optimizer: the classifier on ``shape``
    with every shard on ``dev``, from the global weights ``init``,
    ``TRAIN_STEPS`` steps through ``fit`` (one full batch an epoch,
    unshuffled).  Returns (losses, model, collective calls by kind,
    gradient all-reduces a step)."""
    n = 1
    for v in shape.values():
        n *= v
    mesh = ff.make_mesh(shape, [dev] * n)
    m = build(ff.FFConfig(batch_size=kw["batch"], seed=0), mesh=mesh, **kw)
    opt_cls, opt_kw = opt
    m.compile(optimizer=getattr(ff, opt_cls)(**opt_kw),
              strategy=(megatron_strategy(m.graph) if "tp" in shape
                        else None))
    m.load_params(init)
    calls0 = dict(mesh.comm.calls)
    hist = m.fit(x, y, epochs=TRAIN_STEPS, shuffle=False, verbose=False)
    calls = {k: v - calls0[k] for k, v in mesh.comm.calls.items()}
    return ([h["loss"] for h in hist], m, calls,
            m.grad_allreduces / TRAIN_STEPS)


def phase_training_mesh(torch, dev, card, one_step_ms):
    """Phase 22: training on a mesh, every shard on the one card (module
    docstring, item 22).  ``one_step_ms`` is phase 21(b)'s median
    one-device step."""
    import contextlib
    import gc
    import io
    import shutil
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.data import DataLoader, native
    from flexflow_tpu_torch.examples import mnist_mlp
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier as build
    from flexflow_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                        save_checkpoint)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    width, classes = BERT_BASE["hidden_dim"], BERT_BASE["num_classes"]

    # (a) dp=2 and dp=2 x tp=2 against one device, all on the card
    kw = dict(BERT_BASE, seq=128, num_layers=2)
    rng = np.random.RandomState(0)
    x = rng.randn(kw["batch"], kw["seq"], width).astype(np.float32)
    y = rng.randint(0, classes, kw["batch"]).astype(np.int32)
    seed_model = build(ff.FFConfig(batch_size=kw["batch"], seed=0),
                       device=dev, **kw)
    seed_model.compile()
    init = {n: {p: v.detach().clone() for p, v in g.items()}
            for n, g in seed_model.params.items()}
    del seed_model
    loss_rtol, sgd_atol = 1e-4, 1e-5
    kept = None
    for opt in (("SGDOptimizer", dict(lr=0.01, momentum=0.9)),
                ("AdamOptimizer", dict(alpha=1e-4))):
        atol = (2 * opt[1]["alpha"] * TRAIN_STEPS
                if opt[0] == "AdamOptimizer" else sgd_atol)
        base, one, _, _ = mesh_run(ff, build, kw, {"dp": 1}, dev, opt,
                                   init, x, y)
        for shape in ({"dp": 2}, {"dp": 2, "tp": 2}):
            losses, m, calls, per_step = mesh_run(ff, build, kw, shape, dev,
                                                  opt, init, x, y)
            rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base))
            err = max(float((m.params[n][p] - v).detach().abs().max())
                      for n, g in one.params.items() for p, v in g.items())
            gather = kw["batch"] * classes * 4
            log(f"training on a mesh (a) {opt[0]} {shape} on {card}: "
                f"losses {[round(v, 6) for v in losses]} against one "
                f"device's {[round(v, 6) for v in base]}, max rel loss "
                f"diff {rel:.3e} (tol {loss_rtol}), max abs param diff "
                f"{err:.3e} (tol {atol:.1e}); collective calls {calls} in "
                f"{TRAIN_STEPS} steps, {per_step:g} gradient all-reduces a "
                f"step, exit gather {gather} bytes a step "
                f"({kw['batch']} x {classes} f32)")
            if (not all(np.isfinite(losses)) or rel > loss_rtol
                    or err > atol):
                raise RuntimeError(f"training on a mesh (a) {opt[0]} "
                                   f"{shape}: differs from one device "
                                   "beyond the tolerance")
            if "tp" in shape and opt[0] == "AdamOptimizer":
                kept = m
            else:
                del m
        del one
    gc.collect()
    torch.cuda.empty_cache()

    # (c, first half) checkpoint at dp=2 x tp=2, restore on 1 and dp=2
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "phase22_checkpoint")
    shutil.rmtree(ckpt, ignore_errors=True)
    save_checkpoint(ckpt, kept, step=TRAIN_STEPS)
    want = kept.params
    for shape in ({"dp": 1}, {"dp": 2}):
        n = shape["dp"]
        m = build(ff.FFConfig(batch_size=kw["batch"], seed=1),
                  mesh=ff.make_mesh(shape, [dev] * n), **kw)
        m.compile(optimizer=ff.AdamOptimizer(alpha=1e-4))
        step = restore_checkpoint(ckpt, m)
        same = all(torch.equal(m.params[k][p], v)
                   for k, g in want.items() for p, v in g.items())
        t = [s["t"] for s in m.shard_opt_states]
        log(f"training on a mesh (c) checkpoint from dp=2 x tp=2 restored "
            f"on {shape}: step {step}, parameters equal {same}, Adam "
            f"steps {t}")
        if not same or step != TRAIN_STEPS or t != [TRAIN_STEPS] * n:
            raise RuntimeError(f"training on a mesh (c): the checkpoint "
                               f"did not restore on {shape}")
        del m
    del kept, want
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full depth at dp=2, both shards on the card
    kw = dict(BERT_BASE, seq=512, num_layers=12)
    n_samples, epochs, warm = 64, 2, 2
    rng = np.random.RandomState(1)
    x = rng.randn(n_samples, kw["seq"], width).astype(np.float32)
    proj = rng.randn(width, classes).astype(np.float32)
    y = np.argmax(x.mean(axis=1) @ proj, axis=-1).astype(np.int32)
    base = torch.cuda.memory_allocated()
    model = build(ff.FFConfig(batch_size=kw["batch"], seed=0),
                  mesh=ff.make_mesh({"dp": 2}, [dev, dev]), **kw)
    model.compile(optimizer=ff.AdamOptimizer(alpha=1e-4),
                  metrics=["accuracy"])
    n_params = sum(v.numel() for g in model.shard_params[0].values()
                   for v in g.values())
    times = []
    inner = model._train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    model._train_step = timed_step
    sums = []
    inner_sum = model._sum_grads

    def timed_sum(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner_sum(*args)
        torch.cuda.synchronize()
        sums.append(time.perf_counter() - t0)

    model._sum_grads = timed_sum
    torch.cuda.reset_peak_memory_stats()
    calls0 = dict(model.mesh.comm.calls)
    t0 = time.perf_counter()
    hist = model.fit(x, y, epochs=epochs, verbose=False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    calls = {k: v - calls0[k] for k, v in model.mesh.comm.calls.items()}
    step = statistics.median(times[warm:])
    losses = [h["loss"] for h in hist]
    log(f"training on a mesh (b) on {card}: 12 layers, hidden {width}, "
        f"seq 512, batch {kw['batch']} as dp=2 x {kw['batch'] // 2} rows, "
        f"both shards on the one card, Adam 1e-4, {n_samples} samples x "
        f"{epochs} epochs ({len(times)} steps, fit wall {wall:.2f}s): "
        f"median step {step * 1e3:.3f} ms after {warm} warm-up (min "
        f"{min(times[warm:]) * 1e3:.3f}, max "
        f"{max(times[warm:]) * 1e3:.3f}) against phase 21(b)'s one-device "
        f"{one_step_ms:.3f} ms; {kw['batch'] / step:.2f} samples/s; "
        f"gradient all-reduce of {n_params} f32 parameters "
        f"({n_params * 4 / 1e9:.3f} GB) a step, median "
        f"{statistics.median(sums[warm:]) * 1e3:.3f} ms (between two "
        f"synchronizes), collective calls {calls}; "
        f"peak memory {peak / 1e9:.2f} GB (above the {base / 1e9:.2f} GB "
        f"held before the model); epoch losses "
        f"{[round(v, 4) for v in losses]}; two shards on one card measure "
        "the executor and the collectives, not a speed-up")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"training on a mesh (b): the loss did not "
                           f"fall: {losses}")
    del model, inner, inner_sum
    gc.collect()
    torch.cuda.empty_cache()

    # (c, second half) the MNIST MLP through the native DataLoader
    x_train, y_train, source = mnist_mlp.load_mnist()
    cfg = ff.FFConfig(batch_size=64)
    m = ff.FFModel(cfg, device=dev)
    t = m.create_tensor((cfg.batch_size, 784))
    h = m.dense(t, 512, activation="relu")
    h = m.dense(h, 512, activation="relu")
    m.softmax(m.dense(h, 10))
    m.compile(optimizer=ff.SGDOptimizer(lr=cfg.learning_rate, momentum=0.9),
              metrics=["accuracy"])
    loader = DataLoader(x_train, y_train, batch_size=cfg.batch_size,
                        seed=0, plan=m.plan, native="auto")
    t0 = time.perf_counter()
    native.load()   # the engine's first use builds it: not in the epoch
    build_s = time.perf_counter() - t0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        hist = m.fit(loader, epochs=1)
    wall = time.perf_counter() - t0
    final = m.evaluate(x_train, y_train)
    log(buf.getvalue().rstrip())
    log(f"training on a mesh (c) on {card}: mnist_mlp ({source}, "
        f"{len(x_train)} samples) one epoch through DataLoader(native="
        f"'auto'): engine {loader.engine} (g++ build and load "
        f"{build_s:.2f}s before the epoch), fit wall {wall:.2f}s, loss "
        f"{hist[0]['loss']:.4f}, evaluate accuracy {final['accuracy']:.4f}")
    if loader.engine != "native" or final["accuracy"] < 0.99:
        raise RuntimeError(f"training on a mesh (c): engine "
                           f"{loader.engine}, accuracy {final['accuracy']}")


PLANNER_BUDGET = 200      # phase 23(b)'s search budget
# phase 23(b)'s Metropolis temperature: at the default 0.05 the walk's
# accepted uphill moves outweigh the rewrites' gains and its best stays
# the start (``graph_optimize`` on a CPU mesh priced as ``h100`` shows
# it), so the adopted model walks greedily
PLANNER_ALPHA = 0.001
# the op types the substitution rules emit
FUSED_OPS = ("residual_layer_norm", "residual_rms_norm", "sigmoid_silu_multi")


def phase_training_planner(torch, dev, card):
    """Phase 23: the training planner on the card (module docstring, item
    23)."""
    import collections
    import gc
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.core.pcg import PCG
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier as build
    from flexflow_tpu_torch.search import MachineModel, measure, simulate
    from flexflow_tpu_torch.search.simulator import _measure_key
    from flexflow_tpu_torch.search.substitution import (RewriteResult,
                                                        remap_params)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    root = os.path.dirname(os.path.abspath(__file__))

    # (a) the standard probes and the train-step factor
    path = os.path.join(root, "build", "phase23_costs.json")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    costs = measure.calibrate_standard_probes(path, device=dev)
    factor, times = measure.probe_train_step_factor(dev)
    log(f"training planner (a) on {card}: {len(costs.data)} probes in "
        f"{time.perf_counter() - t0:.1f}s; train_step_factor {factor:.4f} "
        f"(train step {times['train_step_s'] * 1e6:.1f}us over forward "
        f"{times['forward_s'] * 1e6:.1f}us, the 784-512-512-10 MLP at batch "
        "64, f32, device time)")
    if len(costs.data) != len(measure.standard_probes()) or not all(
            0 < v < 1 for v in costs.data.values()):
        raise RuntimeError(f"training planner (a): probe times {costs.data}")

    # (b) the joint search at BERT-base width, 12 layers, on dp=2 x tp=2
    kw = dict(BERT_BASE, seq=512, num_layers=12)
    width, classes = kw["hidden_dim"], kw["num_classes"]
    rng = np.random.RandomState(2)
    x = rng.randn(kw["batch"], kw["seq"], width).astype(np.float32)
    y = rng.randint(0, classes, kw["batch"]).astype(np.int32)
    shape = {"dp": 2, "tp": 2}

    def model(budget):
        return build(ff.FFConfig(batch_size=kw["batch"], seed=0,
                                 search_budget=budget,
                                 search_alpha=PLANNER_ALPHA),
                     mesh=ff.make_mesh(shape, [dev] * 4), **kw)

    plain = model(0)
    plain.compile(optimizer=ff.AdamOptimizer(alpha=1e-4))
    fused = model(PLANNER_BUDGET)
    n0 = len(fused.graph.nodes)
    t0 = time.perf_counter()
    fused.compile(optimizer=ff.AdamOptimizer(alpha=1e-4))
    t_search = time.perf_counter() - t0
    kinds = collections.Counter(n.op.type_name for n in fused.graph.nodes
                                if n.op.type_name in FUSED_OPS)
    log(f"training planner (b) on {card}: 12 layers, hidden {width}, seq "
        f"512, batch {kw['batch']}, {shape} with every shard on the card: "
        f"compile(search_budget={PLANNER_BUDGET}, search_alpha="
        f"{PLANNER_ALPHA}) in {t_search:.1f}s, "
        f"{n0} nodes -> {len(fused.graph.nodes)}; fused nodes "
        f"{dict(kinds)}; layers {len(fused.layers)}")
    log(f"training planner (b) searched dict: {fused.strategy}")
    if set(fused.layers) != {n.name for n in fused.graph.nodes}:
        raise RuntimeError("training planner (b): layers are not the "
                           "adopted graph's modules")
    # every rule keeps the weighted node's name and its parameters', so
    # the rewrites' composed parameter map is the identity on names
    carried = remap_params(plain.params, RewriteResult(fused.graph, {}, {},
                                                      {}), fused.graph)
    fused.load_params(carried)
    runs = {}
    for label, m in (("unfused, data-parallel", plain),
                     ("fused, searched", fused)):
        hist = m.fit(x, y, epochs=TRAIN_STEPS, shuffle=False,
                     verbose=False)
        steps = []
        inner = m._train_step

        def timed_step(*args, inner=inner, steps=steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(*args)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            return out

        m._train_step = timed_step
        m.fit(x, y, epochs=4, shuffle=False, verbose=False)
        m._train_step = inner
        runs[label] = ([h["loss"] for h in hist],
                       statistics.median(steps) * 1e3, steps)
    (lp, step_p, _), (lf, step_f, _) = runs.values()
    loss_rtol = 1e-4     # phase 22(a)'s
    rel = max(abs(a - b) / abs(a) for a, b in zip(lp, lf))
    log(f"training planner (b) Adam 1e-4, {TRAIN_STEPS} steps from the "
        f"same weights: losses unfused {[round(v, 6) for v in lp]} fused "
        f"{[round(v, 6) for v in lf]}, max rel diff {rel:.3e} (tol "
        f"{loss_rtol}); then 4 steps each: median step unfused "
        f"{step_p:.3f} ms, fused and searched {step_f:.3f} ms")
    if not all(np.isfinite(lf)) or rel > loss_rtol:
        raise RuntimeError("training planner (b): the fused, searched "
                           "graph trains differently from the unfused one")

    # (c) the training price beside the measured step
    mm = MachineModel.for_mesh(plain.mesh).with_calibration(
        os.path.join(root, "artifacts", "h100_calib.json"))
    for label, m, step in (("searched", fused, step_f),
                           ("data_parallel_strategy", plain, step_p)):
        plan = PCG(m.graph, m.mesh, m.strategy).plan()
        hits = sum(1 for st in plan.steps if not st.is_parallel
                   and _measure_key(st, m.mesh) in costs)
        price = simulate(plan, mm, training=True, measured=costs)
        roof = simulate(plan, mm, training=True).total
        if not hits and price.total != roof:
            raise RuntimeError(f"training planner (c): {label} priced "
                               f"{price.total} with no cache hit, "
                               f"{roof} without the cache")
        log(f"training planner (c) {label}: simulate(training=True) on "
            f"{mm.spec.name} (train_step_factor "
            f"{mm.spec.train_step_factor:.4f}, {hits} cache hits; the "
            f"roofline price without the cache {roof * 1e3:.4f} ms) "
            f"{price.total * 1e3:.4f} ms (compute "
            f"{price.compute * 1e3:.4f}, comm {price.comm * 1e3:.4f}, "
            f"grad_comm {price.grad_comm * 1e3:.4f}) beside a measured "
            f"median step of {step:.3f} ms on {card}, measured / priced "
            f"{step / (price.total * 1e3):.2f}; not comparable: the four "
            "shards share one card, and the f32 steps run on the CUDA cores "
            "while the spec prices heavy ops at the bf16 tensor-core peak")
    del plain, fused
    gc.collect()
    torch.cuda.empty_cache()



def phase_vision_dlrm(torch, dev, card):
    """Phase 24: the conv nets and DLRM on the card (module docstring,
    item 24), float32, TF32 off."""
    import gc
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models import vision
    from flexflow_tpu_torch.models.dlrm import build_dlrm
    from flexflow_tpu_torch.tools import op_parity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()

    # (a) every op of the slice on the card against the CPU
    t0 = time.perf_counter()
    worst = op_parity.check_all(dev, op_parity.SLICE_11C_I)
    log(f"vision and dlrm (a) on {card}: {len(worst)} op cases on the card "
        f"== the CPU (forward and gradients, rtol {op_parity.RTOL}, atol "
        f"{op_parity.ATOL}) in {time.perf_counter() - t0:.1f}s; max abs "
        "diffs " + ", ".join(f"{n} {e:.2e}" for n, e in worst))

    # (b) ResNet-18 at ImageNet width on one device
    batch, classes, image = 32, 1000, (3, 224, 224)
    n_images, epochs, warm = 256, 2, 2
    rng = np.random.RandomState(24)
    x = rng.randn(n_images, *image).astype(np.float32)
    proj = rng.randn(image[0], classes).astype(np.float32)
    y = np.argmax(x.mean(axis=(2, 3)) @ proj, axis=-1).astype(np.int32)
    sgd = dict(lr=0.01, momentum=0.9)
    base = torch.cuda.memory_allocated()
    model, _, out = vision.build_resnet18(
        ff.FFConfig(batch_size=batch, seed=0), batch=batch,
        num_classes=classes, image=image, device=dev)
    model.compile(optimizer=ff.SGDOptimizer(**sgd), outputs=[out],
                  metrics=["accuracy"])
    init = {n: {p: v.detach().clone() for p, v in g.items()}
            for n, g in model.params.items()}
    fwd = forward_flops(model)
    times = step_timer(model, torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = model.fit(x, y, epochs=epochs, verbose=False)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    step = statistics.median(times[warm:])
    share = 3 * fwd / step / PEAK_FLOPS["float32"]
    losses = [h["loss"] for h in hist]
    log(f"vision and dlrm (b) on {card}: ResNet-18 at {image}, "
        f"{classes} classes, batch {batch}, SGD {sgd}, {n_images} images x "
        f"{epochs} epochs ({len(times)} steps, fit wall {wall:.2f}s): "
        f"median step {step * 1e3:.3f} ms after {warm} warm-up (min "
        f"{min(times[warm:]) * 1e3:.3f}, max {max(times[warm:]) * 1e3:.3f});"
        f" {batch / step:.1f} images/s; 3 x forward flops "
        f"{3 * fwd / 1e12:.4f} TFLOP a step, {3 * fwd / step / 1e12:.2f} "
        f"TFLOP/s = {share:.4f} of {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s f32; peak memory {peak / 1e9:.2f} GB (above the "
        f"{base / 1e9:.2f} GB held before the model); epoch losses "
        f"{[round(v, 4) for v in losses]}, accuracy "
        f"{[round(h['accuracy'], 4) for h in hist]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"vision (b): the loss did not fall: {losses}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the same ResNet-18 at dp=2, both shards on the card, against one
    # device from (b)'s weights and first batches
    steps = 3
    xs, ys = x[:steps * batch], y[:steps * batch]
    runs = {}
    for shape in ({"dp": 1}, {"dp": 2}):
        mesh = ff.make_mesh(shape, [dev] * shape["dp"])
        m, _, out = vision.build_resnet18(
            ff.FFConfig(batch_size=batch, seed=0), mesh=mesh, batch=batch,
            num_classes=classes, image=image)
        m.compile(optimizer=ff.SGDOptimizer(**sgd), outputs=[out])
        m.load_params(init)
        kinds = count_collectives(mesh.comm)
        step_losses = []
        mtimes = step_timer(m, torch, step_losses)
        m.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
        n_bn = sum(1 for st in m.plan.steps
                   if st.node.op.type_name == "batch_norm")
        runs[shape["dp"]] = (step_losses, dict(kinds),
                             m.grad_allreduces / steps,
                             statistics.median(mtimes))
        del m
        gc.collect()
        torch.cuda.empty_cache()
    (l1, _, _, s1), (l2, kinds, grads, s2) = runs[1], runs[2]
    rel = max(abs(a - c) / abs(c) for a, c in zip(l2, l1))
    log(f"vision and dlrm (c) on {card}: ResNet-18 dp=2 (both shards on "
        f"the card), {steps} SGD steps from (b)'s weights and batches: "
        f"losses {[round(v, 6) for v in l2]} against one device's "
        f"{[round(v, 6) for v in l1]}, max rel diff {rel:.3e} (tol 1e-4); "
        f"collectives a step by kind "
        f"{ {k: v / steps for k, v in sorted(kinds.items())} } ({n_bn} "
        f"batch norms x 2 sums, forward and backward; {grads:g} gradient "
        f"all-reduce; the exit gather); median step {s2 * 1e3:.3f} ms "
        f"against one device's {s1 * 1e3:.3f} ms (two shards on one card)")
    if not all(np.isfinite(l2)) or rel > 1e-4:
        raise RuntimeError("vision (c): dp=2 differs from one device "
                           "beyond the tolerance")
    del x, xs, init
    gc.collect()

    # (d) AlexNet and Inception at the builders' default image
    image, n_images = (3, 64, 64), 128
    rng = np.random.RandomState(25)
    x = rng.randn(n_images, *image).astype(np.float32)
    y = rng.randint(0, 10, n_images).astype(np.int32)
    for build in (vision.build_alexnet, vision.build_inception):
        m, _, out = build(ff.FFConfig(batch_size=batch, seed=0),
                          batch=batch, image=image, device=dev)
        m.compile(optimizer=ff.SGDOptimizer(lr=0.01), outputs=[out],
                  metrics=["accuracy"])
        mtimes = step_timer(m, torch)
        h = m.fit(x, y, epochs=1, verbose=False)
        ev = m.evaluate(x, y)
        probs = m.forward(x[:batch])
        rows = float((probs.sum(-1) - 1).abs().max())
        log(f"vision and dlrm (d) on {card}: {build.__name__} at {image}, "
            f"batch {batch}: one epoch ({len(mtimes)} steps, median "
            f"{statistics.median(mtimes) * 1e3:.3f} ms) loss "
            f"{h[0]['loss']:.4f}, evaluate {ev}, softmax rows sum to 1 "
            f"within {rows:.2e}")
        if not (np.isfinite(h[0]["loss"]) and np.isfinite(ev["loss"])
                and rows <= 1e-5):
            raise RuntimeError(f"vision (d) {build.__name__}: loss "
                               f"{h[0]['loss']}, {ev}, rows {rows}")
        del m
    gc.collect()
    torch.cuda.empty_cache()

    # (e) DLRM at the Criteo Kaggle widths on dp=2 x mp=2, four shards on
    # the card, against one device
    kw = dict(batch=128, dense_dim=13, table_sizes=(10 ** 6,) * 26,
              embed_dim=16, bottom_mlp=(512, 256, 64, 16),
              top_mlp=(512, 256, 1))
    steps, b = 3, kw["batch"]
    rng = np.random.RandomState(26)
    dense = rng.randn(steps * b, kw["dense_dim"]).astype(np.float32)
    sparse = [rng.randint(0, n, size=(steps * b, 1)).astype(np.int32)
              for n in kw["table_sizes"]]
    w = rng.randn(kw["dense_dim"]).astype(np.float32)
    labels = (dense @ w > 0).astype(np.float32)[:, None]
    runs, init = {}, None
    for shape in ({"dp": 1}, {"dp": 2, "mp": 2}):
        n = shape.get("dp", 1) * shape.get("mp", 1)
        mesh = ff.make_mesh(shape, [dev] * n)
        base = torch.cuda.memory_allocated()
        m, d_in, s_in, out, strategy = build_dlrm(
            ff.FFConfig(batch_size=b, seed=0), mesh=mesh,
            mp_axes=("mp",) if "mp" in shape else (),
            dp_axes=("dp",) if shape.get("dp", 1) > 1 else (), **kw)
        t0 = time.perf_counter()
        m.compile(optimizer=ff.SGDOptimizer(lr=0.05), outputs=[out],
                  strategy=strategy or None,
                  loss_type="binary_crossentropy")
        if init is None:
            init = {n_: {p: v.detach().clone() for p, v in g.items()}
                    for n_, g in m.params.items()}
        else:
            m.load_params(init)
        setup = time.perf_counter() - t0
        step_losses = []
        mtimes = step_timer(m, torch, step_losses)
        torch.cuda.reset_peak_memory_stats()
        m.fit({d_in: dense, **dict(zip(s_in, sparse))}, labels, epochs=1,
              shuffle=False, verbose=False)
        peak = torch.cuda.max_memory_allocated() - base
        runs[n] = (step_losses, mtimes, peak, setup,
                   sum(1 for st in m.plan.steps if st.is_parallel))
        if n == 1:
            del m
        else:
            del m, init
        gc.collect()
        torch.cuda.empty_cache()
    (l1, t1, p1, u1, _), (l4, t4, p4, u4, par) = runs[1], runs[4]
    rel = max(abs(a - c) / abs(c) for a, c in zip(l4, l1))
    log(f"vision and dlrm (e) on {card}: DLRM (dense {kw['dense_dim']}, "
        f"bottom {kw['bottom_mlp']}, {len(kw['table_sizes'])} tables of "
        f"{kw['table_sizes'][0]} x {kw['embed_dim']}, top {kw['top_mlp']}), "
        f"batch {b}, binary_crossentropy, SGD 0.05, {steps} steps: dp=2 x "
        f"mp=2 (four shards on the card, {par} parallel steps) losses "
        f"{[round(v, 6) for v in l4]} against one device's "
        f"{[round(v, 6) for v in l1]}, max rel diff {rel:.3e} (tol 1e-4); "
        f"steps {[round(t * 1e3, 3) for t in t4]} ms (median "
        f"{statistics.median(t4) * 1e3:.3f}) against one device's "
        f"{[round(t * 1e3, 3) for t in t1]} (median "
        f"{statistics.median(t1) * 1e3:.3f}); peak memory {p4 / 1e9:.2f} GB "
        f"against {p1 / 1e9:.2f} GB; compile and weights {u4:.1f}s and "
        f"{u1:.1f}s")
    if not all(np.isfinite(l4)) or rel > 1e-4:
        raise RuntimeError("dlrm (e): the mesh differs from one device "
                           "beyond the tolerance")
    torch.cuda.empty_cache()


# phase 25(b): one MoE layer at mistralai/Mixtral-8x7B-v0.1's expert widths
# (config.json: hidden_size 4096, intermediate_size 14336,
# num_local_experts 8, num_experts_per_tok 2); the experts are the
# reference's ReLU MLP with biases, not Mixtral's SwiGLU
MIXTRAL_MOE = dict(batch=1024, in_dim=4096, num_experts=8,
                   expert_hidden=14336, num_classes=16, k=2,
                   capacity_factor=2.0)
# phase 25(c): expert parallelism at a smaller width
EP_MOE = dict(batch=256, in_dim=1024, num_experts=8, expert_hidden=4096,
              num_classes=16, k=2, capacity_factor=2.0)
# phase 25(d): the decode heads at Llama-7B's vocabulary and width
LLAMA_VOCAB, HEAD_IN = 32000, 4096


def moe_data(kw, n_batches, seed):
    """``n_batches`` batches of the classifier's input and learnable
    labels (the class of a fixed random projection)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    x = rng.randn(n_batches * kw["batch"], kw["in_dim"]).astype(np.float32)
    proj = rng.randn(kw["in_dim"], kw["num_classes"]).astype(np.float32)
    return x, np.argmax(x @ proj, axis=-1).astype(np.int32)


def head_net(ff, device_or_mesh, x_dim, vocab, rows):
    """``dense(x_dim -> vocab)`` into each decode head and a cache, on one
    device or a ``{"tp": 2}`` mesh (the vocabulary split, gathered before
    the heads); returns the model."""
    mesh = device_or_mesh if hasattr(device_or_mesh, "shape") else None
    m = ff.FFModel(ff.FFConfig(batch_size=rows, seed=0), mesh=mesh,
                   device=None if mesh else device_or_mesh)
    x = m.create_tensor((rows, x_dim))
    logits = m.dense(m.cache(x, name="feat_cache"), vocab, name="lm_head")
    outs = [m.argmax(logits), *m.top_k(logits, 8),
            *m.arg_top_k(logits, 8, speculative_decoding=True),
            *m.beam_top_k(m.reshape(logits, (rows // 4, 4, vocab)), 8),
            m.sampling(logits, top_p=0.9, temperature=0.8)]
    strategy = ({"lm_head": {"channel_out": ("tp",)}} if mesh is not None
                else {})
    m.compile(outputs=outs, strategy=strategy, loss_type="identity")
    return m


def phase_moe_heads(torch, dev, card):
    """Phase 25: MoE, the decode heads and the cache on the card (module
    docstring, item 25), float32, TF32 off."""
    import gc
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.core.interpreter import (build_forward,
                                                     place_inputs)
    from flexflow_tpu_torch.models.moe import build_moe_classifier
    from flexflow_tpu_torch.ops.reduction import nucleus_keep
    from flexflow_tpu_torch.tools import op_parity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()

    # (a) every op of the slice on the card against the CPU
    t0 = time.perf_counter()
    worst = op_parity.check_all(dev, op_parity.SLICE_11C_II)
    log(f"moe and heads (a) on {card}: {len(worst)} op cases on the card "
        f"== the CPU (forward and gradients, rtol {op_parity.RTOL}, atol "
        f"{op_parity.ATOL}; indices equal, planted ties included; "
        f"sampling inside the CPU's nucleus mask, one seed twice the same "
        f"tokens) in {time.perf_counter() - t0:.1f}s; max abs diffs "
        + ", ".join(f"{n} {e:.2e}" for n, e in worst))

    # (b) one MoE layer at Mixtral-8x7B's expert widths, one device
    kw = MIXTRAL_MOE
    warm, timed = 2, 6
    x, y = moe_data(kw, 2, 25)
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    m, _, out, _ = build_moe_classifier(
        ff.FFConfig(batch_size=kw["batch"], seed=0), device=dev, **kw)
    m.compile(optimizer=ff.SGDOptimizer(lr=0.01), outputs=[out])
    setup = time.perf_counter() - t0
    n_params = sum(v.numel() for g in m.params.values() for v in g.values())
    fwd = forward_flops(m)
    expert_fwd = sum(st.node.op.flops(st.in_specs) for st in m.plan.steps
                     if st.node.op.type_name == "experts")
    before = m.evaluate(x, y)["loss"]
    losses = []
    times = step_timer(m, torch, losses)
    torch.cuda.reset_peak_memory_stats()
    m.fit(x, y, epochs=(warm + timed) // 2, shuffle=False, verbose=False)
    peak = torch.cuda.max_memory_allocated() - base
    after = m.evaluate(x, y)["loss"]
    step = statistics.median(times[warm:])
    share = 3 * fwd / step / PEAK_FLOPS["float32"]
    log(f"moe and heads (b) on {card}: one MoE layer at "
        f"mistralai/Mixtral-8x7B-v0.1's expert widths (hidden "
        f"{kw['in_dim']}, expert hidden {kw['expert_hidden']}, "
        f"{kw['num_experts']} experts, top-{kw['k']}; the reference's ReLU "
        f"MLP with biases, not Mixtral's SwiGLU), batch {kw['batch']} "
        f"tokens, capacity factor {kw['capacity_factor']} (C = "
        f"{m.graph.spec(m.graph.nodes[3].outputs[0]).shape[1]}), "
        f"{n_params / 1e9:.3f} G parameters, SGD 0.01, setup {setup:.1f}s: "
        f"median step {step * 1e3:.3f} ms over {timed} steps after {warm} "
        f"warm-up (min {min(times[warm:]) * 1e3:.3f}, max "
        f"{max(times[warm:]) * 1e3:.3f}); {kw['batch'] / step:.0f} tokens/s;"
        f" 3 x forward flops {3 * fwd / 1e12:.4f} TFLOP a step (experts' "
        f"forward {expert_fwd / 1e12:.4f}), {3 * fwd / step / 1e12:.2f} "
        f"TFLOP/s = {share:.4f} of {PEAK_FLOPS['float32'] / 1e12:.0f} "
        f"TFLOP/s f32; peak memory {peak / 1e9:.2f} GB (above the "
        f"{base / 1e9:.2f} GB held before); loss on its 2 batches "
        f"{before:.4f} before, {after:.4f} after {len(times)} steps; step "
        f"losses {[round(v, 4) for v in losses]}")
    if not (np.isfinite(losses).all() and after < before):
        raise RuntimeError(f"moe (b): the loss did not fall: {before} -> "
                           f"{after}, steps {losses}")
    del m
    gc.collect()
    torch.cuda.empty_cache()

    # (c) expert parallelism, every shard on the card, against one device
    kw = EP_MOE
    x, y = moe_data(kw, 2, 26)
    runs, init = {}, None
    for shape in ({"dp": 1}, {"ep": 2}, {"dp": 2, "ep": 2}):
        n = 1
        for v in shape.values():
            n *= v
        mesh = ff.make_mesh(shape, [dev] * n)
        axes = dict(ep_axes=("ep",) if "ep" in shape else (),
                    dp_axes=("dp",) if shape.get("dp", 1) > 1 else ())
        mm, _, out, strategy = build_moe_classifier(
            ff.FFConfig(batch_size=kw["batch"], seed=0), mesh=mesh, **axes,
            **kw)
        mm.compile(optimizer=ff.SGDOptimizer(lr=0.01), outputs=[out],
                   strategy=strategy or None)
        if init is None:
            init = {k: {p: v.detach().clone() for p, v in g.items()}
                    for k, g in mm.params.items()}
        else:
            mm.load_params(init)
        first = mm.forward(x[:kw["batch"]]).cpu()
        kinds = count_collectives(mesh.comm)
        step_losses = []
        mtimes = step_timer(mm, torch, step_losses)
        mm.fit(x, y, epochs=1, shuffle=False, verbose=False)
        params = {f"{k}.{p}": v.detach().cpu() for k, g in mm.params.items()
                  for p, v in g.items()}
        runs[tuple(shape.items())] = (first, step_losses, params,
                                      dict(kinds), mm.grad_allreduces,
                                      statistics.median(mtimes))
        del mm
        gc.collect()
        torch.cuda.empty_cache()
    one = runs[(("dp", 1),)]
    for key, (first, ls, params, kinds, grads, st) in runs.items():
        if key == (("dp", 1),):
            continue
        fdiff = float((first - one[0]).abs().max())
        rel = max(abs(a - b) / abs(b) for a, b in zip(ls, one[1]))
        perr = max(float((params[k] - v).abs().max())
                   for k, v in one[2].items())
        log(f"moe and heads (c) on {card}: {dict(key)} (every shard on the "
            f"card) against one device, hidden {kw['in_dim']}, expert "
            f"hidden {kw['expert_hidden']}, {kw['num_experts']} experts, "
            f"top-{kw['k']}, batch {kw['batch']}: forward max abs diff "
            f"{fdiff:.3e} (tol 1e-5), 2 SGD steps' losses "
            f"{[round(v, 6) for v in ls]} against "
            f"{[round(v, 6) for v in one[1]]} (max rel {rel:.3e}, tol 1e-4), "
            f"parameters after max abs diff "
            f"{perr:.3e} (tol 1e-5); collectives a step by kind "
            f"{ {k: v / 2 for k, v in sorted(kinds.items())} } ({grads / 2:g} "
            f"gradient all-reduces a step); median step {st * 1e3:.3f} ms "
            f"against one device's {one[5] * 1e3:.3f} ms")
        if fdiff > 1e-5 or rel > 1e-4 or perr > 1e-5:
            raise RuntimeError(f"moe (c): {dict(key)} differs from one "
                               "device beyond the tolerance")

    # (d) the decode heads at Llama-7B's vocabulary, and the cache
    rows, x_dim = 64, HEAD_IN
    xh = np.random.RandomState(27).randn(rows, x_dim).astype(np.float32)
    cpu = head_net(ff, "cpu", x_dim, LLAMA_VOCAB, rows)
    w = {k: {p: v.detach().clone() for p, v in g.items()}
         for k, g in cpu.params.items()}
    want = cpu.forward(xh)
    logits = torch.tensor(xh) @ w["lm_head"]["kernel"] + w["lm_head"]["bias"]
    keep = nucleus_keep(logits / 0.8, 0.9)
    worst = 0.0
    for label, where in (("one device", dev),
                         ("tp=2", ff.make_mesh({"tp": 2}, [dev, dev]))):
        m = head_net(ff, where, x_dim, LLAMA_VOCAB, rows).load_params(w)
        got = [t.cpu() for t in m.forward(xh)]
        again = [t.cpu() for t in m.forward(xh)]
        for i, (a, b) in enumerate(zip(got[:-1], want[:-1])):
            if a.is_floating_point():
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
                worst = max(worst, float((a - b).abs().max()))
            elif not torch.equal(a, b):
                raise RuntimeError(f"heads (d) {label}: output {i} differs "
                                   "from the CPU's")
        tok = got[-1]
        if not (torch.equal(tok, again[-1])
                and keep[torch.arange(rows), tok.long()].all()):
            raise RuntimeError(f"heads (d) {label}: sampling left the "
                               "nucleus or one seed gave two token sets")
        # the cache: refresh with xh, use with another input
        fwd = build_forward(m.plan)
        tid = m.graph.input_tids[0]
        with torch.no_grad():
            o1, st = fwd(place_inputs(m.plan, {tid: xh}), state={},
                         extras={})
            o2, _ = fwd(place_inputs(m.plan, {tid: -xh}), state=st,
                        extras={"cache_use": True})
        if not all(torch.equal(a, b) for a, b in zip(o1[:-1], o2[:-1])):
            raise RuntimeError(f"heads (d) {label}: the cache did not "
                               "replay its stored value")
        del m
    log(f"moe and heads (d) on {card}: dense({x_dim} -> {LLAMA_VOCAB}) "
        f"over {rows} rows into argmax, top_k(8), arg_top_k(8, with "
        f"probabilities), beam_top_k(8) over [16, 4, {LLAMA_VOCAB}] and "
        f"sampling (top_p 0.9, temperature 0.8), on one device and on "
        f"tp=2 (two shards on the card): indices equal to the CPU's, "
        f"values max abs diff {worst:.3e} (rtol 1e-4, atol 1e-5), every "
        f"sampled token inside the CPU's nucleus, one seed twice the same "
        f"tokens; the cache replayed its stored value in use mode")
    torch.cuda.empty_cache()


# phase 26(c): a BERT-base-width encoder block for the torch.fx import, and
# the Keras CNN's MNIST-sized data
FX_BLOCK = dict(hidden=768, heads=12, ffn=3072, batch=8, seq=128)
FX_LR = 4.0                 # SGD's rate on the block's MSE loss
KERAS_CNN = dict(samples=4096, batch=64)
TREE = "tree_inc_multihead_self_attention"
SPEC = "spec_inc_multihead_self_attention"


def encoder_block(torch, hidden, heads, ffn):
    """A pre-norm transformer encoder block (``nn.MultiheadAttention``,
    ``batch_first``), the module the torch.fx import traces."""
    from torch import nn

    class EncoderBlock(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(hidden)
            self.attn = nn.MultiheadAttention(hidden, heads,
                                              batch_first=True)
            self.ln2 = nn.LayerNorm(hidden)
            self.fc1 = nn.Linear(hidden, ffn)
            self.fc2 = nn.Linear(ffn, hidden)

        def forward(self, x):
            a = self.ln1(x)
            att, _ = self.attn(a, a, a)
            x = x + att
            return x + self.fc2(torch.relu(self.fc1(self.ln2(x))))

    return EncoderBlock()


def cnn_data(n, seed=0):
    """28x28 single-channel images and the class a fixed random linear
    map of each image scores highest: a task one epoch learns."""
    import numpy as np

    rng = np.random.RandomState(seed)
    xs = rng.randn(n, 1, 28, 28).astype(np.float32)
    ys = np.argmax(xs.reshape(n, -1) @ rng.randn(28 * 28, 10), axis=1)
    return xs, ys.astype(np.int32)


def builder_manager(serve, ff, cfg, dev, attention, weights, **kw):
    """``InferenceManager(ff)`` over ``cfg``'s family recorded as builder
    calls (each attention through ``attention``), its parameters copied
    on the card from ``weights`` (a family model's, by node name)."""
    model = ff.FFModel(ff.FFConfig(), device=dev)
    serve.build_model(model, cfg, kw["max_tokens_per_batch"],
                      attention=attention)
    im = serve.InferenceManager(model, device=dev, **kw)
    return im.init_operators_inference(weights)


def phase_builder_frontends(serve, att, torch, dev, card):
    """Phase 26: the builder's serve path and the frontends (module
    docstring, item 26).  Returns the builder path's launches by run."""
    import gc

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.frontends import from_torch, keras

    gc.collect()
    torch.cuda.empty_cache()
    # (a) the builder-served Llama-2-7B beside the family model
    cfg = serve.ServeModelConfig(dtype="bfloat16")   # Llama-2-7B defaults
    dcfg = draft_config(serve, "bfloat16")
    kw = dict(max_requests=8, max_tokens_per_batch=512, max_seq_len=2048,
              max_spec_tokens=8)
    t0 = time.perf_counter()
    fam = serve.InferenceManager(serve.build_model(cfg), device=dev, **kw)
    fam.init_operators_inference(seed=0)
    fam_draft = serve.InferenceManager(serve.build_model(dcfg), topk=2,
                                       device=dev, **kw)
    fam_draft.init_operators_inference(seed=1)
    torch.cuda.synchronize()
    t_fam = time.perf_counter() - t0
    t0 = time.perf_counter()
    target = builder_manager(serve, ff, cfg, dev, TREE,
                             dict(fam.model.named_parameters()), **kw)
    draft = builder_manager(serve, ff, dcfg, dev, SPEC,
                            dict(fam_draft.model.named_parameters()),
                            topk=2, **kw)
    torch.cuda.synchronize()
    t_builder = time.perf_counter() - t0
    def attention_kinds(im):
        return dict(collections.Counter(
            type(m).type_name for m in im.model.modules()
            if isinstance(m, serve.IncMultiHeadSelfAttention)))

    kinds = attention_kinds(target)
    log(f"builder (a): Llama-2-7B bf16 as {len(target.model.graph.nodes)} "
        f"builder nodes ({kinds}), its weights copied on the card from the "
        f"family model's by node name in {t_builder:.2f}s (the family's "
        f"drawn in {t_fam:.2f}s); the draft's {attention_kinds(draft)}")
    if kinds != {TREE: cfg.num_hidden_layers}:
        raise AssertionError(f"builder (a): attention kinds {kinds}")
    run = Serving(serve, att, torch, cfg.vocab_size)
    prompts = serve_prompts(cfg.vocab_size)
    n_new = 16
    gen = serve.GenerationConfig(max_new_tokens=n_new)
    # in turns (family, builder, builder, family): host times move
    # between runs, and the first run pays the warm-up
    runs = {"family": [], "builder": []}
    for label, im in (("family", fam), ("builder", target),
                      ("builder", target), ("family", fam)):
        im.reset()
        runs[label].append(run.generate(
            f"{label} incremental (phase 26)", run.TimedRM(im, gen),
            prompts, n_new=n_new))
    want = runs["family"][0][0]
    launches = {"incremental": runs["builder"][0][1]}
    require_launches(launches["incremental"], "builder incremental", "fp",
                     ("decode_attention", "prefill_attention"))
    counts = {k: sorted({r[1][(k, "fp")] for rs in runs.values()
                         for r in rs})
              for k in ("decode_attention", "prefill_attention")}
    same = all(r[0] == want for rs in runs.values() for r in rs)

    def times(label, i):
        return " ".join(f"{r[i]:.{3 if i == 2 else 2}f}"
                        for r in runs[label])

    log(f"builder (a) on {card}: greedy streams of 8 prompts x {n_new} "
        f"tokens equal to the family model's: {same}; K1 and K2 launches "
        f"of the four runs {counts}; mean TTFT s builder {times('builder', 2)}"
        f" (family {times('family', 2)}), mean TPOT ms builder "
        f"{times('builder', 3)} (family {times('family', 3)}), in the "
        "order family, builder, builder, family")
    if not same or any(len(c) != 1 for c in counts.values()):
        raise AssertionError("builder (a): the builder-served 7B differs "
                             "from the family model")

    # (b) speculation on the builder path: host loop and device loop
    fam.reset()
    spec = {}
    for label, llm, ssm in (("family", fam, fam_draft),
                            ("builder", target, draft)):
        llm.reset()
        ssm.reset()
        host, n_host, _, _ = run.generate(
            f"{label} spec host (phase 26)",
            run.TimedSpec(llm, ssm, gen, width=2, depth=3), prompts, want,
            n_new=n_new)
        device, n_dev = run.scan(f"{label} spec device (phase 26)", llm,
                                 ssm, prompts, 2, 3, n_new - 1, want,
                                 n_new=n_new)
        spec[label] = (host, device, n_host, n_dev)
    launches["spec host"], launches["spec device"] = spec["builder"][2:]
    require_launches(launches["spec host"], "builder spec host", "fp",
                     ("tree_attention",))
    require_launches(launches["spec device"], "builder spec device", "fp",
                     ("tree_attention_batched",))
    same = [spec["builder"][i] == spec["family"][i] for i in range(4)]
    log(f"builder (b) on {card}: llama-68m-shaped builder draft "
        f"({SPEC}) and the {TREE} target, width 2, depth 3: streams equal "
        f"to the family path's on the host loop {same[0]} and the device "
        f"loop {same[1]}; launches equal {same[2:]}")
    if not all(same):
        raise AssertionError("builder (b): the builder path's speculation "
                             "differs from the family path's")
    del fam, fam_draft, target, draft, run
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the frontends: the torch.fx import of an encoder block, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fx = FX_BLOCK
    shape = (fx["batch"], fx["seq"], fx["hidden"])
    torch.manual_seed(0)
    mod = encoder_block(torch, fx["hidden"], fx["heads"], fx["ffn"]).to(dev)
    rng = np.random.RandomState(26)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randn(*shape).astype(np.float32)
    xt, yt = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    model, outs, weights = from_torch(mod, [shape], device=dev)
    model.compile(optimizer=ff.SGDOptimizer(lr=FX_LR),
                  loss_type="mean_squared_error", outputs=outs)
    model.load_params(weights)
    with torch.no_grad():
        want = mod(xt)
        got = model.forward(x)
    fwd_err = float((got - want).abs().max())
    ms_import = time_ms(lambda: model.forward(x), 20)
    with torch.no_grad():
        ms_module = time_ms(lambda: mod(xt), 20)
    opt = torch.optim.SGD(mod.parameters(), lr=FX_LR)
    torch_losses = []
    for _ in range(2):
        loss = torch.nn.functional.mse_loss(mod(xt), yt)
        opt.zero_grad()
        loss.backward()
        opt.step()
        torch_losses.append(loss.item())
    hist = model.fit(x, y, epochs=2, batch_size=fx["batch"], shuffle=False,
                     verbose=False)
    losses = [h["loss"] for h in hist]
    _, _, stepped = from_torch(mod, [shape], device=dev)
    p_err = moved = 0.0
    for n, g in stepped.items():
        for p, v in g.items():
            a = model.params[n][p].detach().cpu().numpy()
            p_err = max(p_err, float(np.abs(a - v).max()))
            moved = max(moved, float(np.abs(v - weights[n][p]).max()))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, torch_losses))
    log(f"frontends (c) on {card}: from_torch of a {fx['hidden']}-wide, "
        f"{fx['heads']}-head, ffn {fx['ffn']} encoder block "
        f"({len(model.graph.nodes)} nodes), batch {fx['batch']} x seq "
        f"{fx['seq']}, f32, TF32 off: forward max abs diff {fwd_err:.3e} "
        f"against the module's on the card (tol 1e-4), device ms of the "
        f"import's forward from host arrays {ms_import:.3f}, of the "
        f"module's {ms_module:.3f}; 2 SGD steps (lr "
        f"{FX_LR}, MSE) losses {[round(v, 6) for v in losses]} vs "
        f"torch.optim.SGD {[round(v, 6) for v in torch_losses]} (max rel "
        f"{rel:.3e}, tol 1e-4), parameters after max abs diff {p_err:.3e} "
        f"(tol 1e-5; the steps moved them by up to {moved:.3e}, at least "
        "5e-4 required)")
    if fwd_err > 1e-4 or rel > 1e-4 or p_err > 1e-5 or not moved > 5e-4:
        raise RuntimeError("frontends (c): the imported block differs "
                           "from the module beyond the tolerance")
    del model, mod, opt
    # the Keras CNN: one epoch of Adam on the card, the loss falls
    xs, ys = cnn_data(KERAS_CNN["samples"])
    bs = KERAS_CNN["batch"]
    m = keras.Sequential([
        keras.Conv2D(16, 3, padding="same", activation="relu",
                     input_shape=(1, 28, 28)),
        keras.MaxPooling2D(2),
        keras.Conv2D(32, 3, padding="same", activation="relu"),
        keras.MaxPooling2D(2), keras.Flatten(),
        keras.Dense(10, activation="softmax")], device=dev)
    m.compile(optimizer="adam", metrics=["accuracy"], batch_size=bs)
    before = m.evaluate(xs, ys, batch_size=bs)
    t0 = time.perf_counter()
    m.fit(xs, ys, epochs=1, batch_size=bs, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = m.evaluate(xs, ys, batch_size=bs)
    log(f"frontends (c) on {card}: Keras Sequential CNN (2 convs, 2 pools, "
        f"dense) on {KERAS_CNN['samples']} 28x28 images, batch {bs}, one "
        f"epoch of Adam in {wall:.2f}s ({KERAS_CNN['samples'] / wall:.0f} "
        f"samples/s, first epoch, compile and warm-up included): loss "
        f"{before['loss']:.4f} -> {after['loss']:.4f}, accuracy "
        f"{before['accuracy']:.4f} -> {after['accuracy']:.4f}")
    if not after["loss"] < before["loss"] or m.model.device.type != "cuda":
        raise RuntimeError("frontends (c): the Keras CNN's loss did not "
                           "fall on the card")
    del m
    torch.cuda.empty_cache()
    return launches


PP_MICRO = 4              # phase 27(a): GPipe microbatches a step
PP_STEPS = 8              # phase 27(a): 3 parity steps, then 5 more
RING = dict(hidden_dim=768, num_heads=12, ff_dim=3072, num_classes=16,
            batch=2, seq=4096, num_layers=2)   # phase 27(c)


def canonical_params(m):
    """A model's ``{node: {param: value}}``, a pipelined model's core
    unstacked to its nodes' own names."""
    if m._pipeline is None:
        return m.params
    params = m.params
    out = {n: g for n, g in params.items() if n != "_pp_core"}
    for n, (s, j) in m._pipeline.core_pos.items():
        for p in m._pp_meta["pnames"][j]:
            out.setdefault(n, {})[p] = params["_pp_core"][f"{j}.{p}"][s]
    return out


def param_diffs(a, b, rtol, atol):
    """The largest ``|a - b|`` over ``b``'s parameters, and the largest
    excess of ``|a - b|`` over ``atol + rtol * |b|`` (at most 0: every
    parameter within ``allclose``)."""
    pa, pb = canonical_params(a), canonical_params(b)
    worst, excess = 0.0, -float("inf")
    for n, g in pb.items():
        for p, v in g.items():
            d = (pa[n][p].detach().to(v.device) - v.detach()).abs()
            worst = max(worst, float(d.max()))
            excess = max(excess, float(
                (d - atol - rtol * v.detach().abs()).max()))
    return worst, excess


def shard_bytes(tree):
    return sum(v.numel() * v.element_size() for g in tree.values()
               for v in (g.values() if isinstance(g, dict) else []))


def phase_pipeline_ring(torch, dev, card):
    """Phase 27: pipeline and ring-attention training on the card (module
    docstring, item 27), float32, TF32 off, every shard on the one
    card."""
    import gc
    import statistics

    import numpy as np

    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.models.transformer import \
        build_transformer_classifier as build
    from flexflow_tpu_torch.parallel.mesh import data_parallel_strategy
    from flexflow_tpu_torch.search import MachineModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    width, classes = BERT_BASE["hidden_dim"], BERT_BASE["num_classes"]

    # (a) GPipe at BERT-base width against one device
    kw = dict(BERT_BASE, seq=512, num_layers=12)
    rng = np.random.RandomState(0)
    x = rng.randn(kw["batch"], kw["seq"], width).astype(np.float32)
    y = rng.randint(0, classes, kw["batch"]).astype(np.int32)
    # at lr 1e-3 the parameters part by ~1.6e-6 in 3 steps; the limit
    # sits 6x above that and fails the 1e-4 that lr 0.01 gave
    loss_rtol, param_rtol, param_atol = 1e-4, 0.0, 1e-5

    def train(m, steps):
        """``steps`` SGD steps (one full batch an epoch, unshuffled):
        losses, step seconds, shift calls and stage applications a
        step."""
        comm = m.mesh.comm
        shifts = count_collectives(comm)
        pl = m._pipeline
        apps0 = pl.steps[True].stage_applications if pl else 0
        times = step_timer(m, torch)
        try:
            hist = m.fit(x, y, epochs=steps, shuffle=False, verbose=False)
        finally:   # unwrap: the next call counts and times afresh
            m.__dict__.pop("_train_step", None)
            for kind in shifts_kinds:
                comm.__dict__.pop(kind, None)
        apps = (pl.steps[True].stage_applications - apps0) if pl else 0
        return ([h["loss"] for h in hist], times, shifts, apps / steps)

    shifts_kinds = ("all_reduce", "all_gather", "gather", "shift")
    sgd = dict(lr=1e-3, momentum=0.9)
    one = build(ff.FFConfig(batch_size=kw["batch"], seed=0), device=dev,
                **kw)
    one.compile(optimizer=ff.SGDOptimizer(**sgd))
    encoder = sum(v.numel() * 4 for n, g in one.params.items()
                  if n.startswith("enc") for v in g.values())
    base_losses, one_times, _, _ = train(one, 3)
    one_ms = statistics.median(one_times[1:]) * 1e3
    log(f"pipeline and ring (a) one device on {card}: 12 layers, hidden "
        f"{width}, seq 512, batch {kw['batch']}, SGD {sgd}: losses "
        f"{[round(v, 6) for v in base_losses]}, steps "
        f"{[round(t * 1e3, 3) for t in one_times]} ms; encoder parameters "
        f"{encoder / 1e6:.1f} MB")
    for shape in ({"pp": 2}, {"pp": 4}, {"pp": 2, "dp": 2}):
        n = 1
        for v in shape.values():
            n *= v
        k, dp = shape["pp"], shape.get("dp", 1)
        base = torch.cuda.memory_allocated()
        m = build(ff.FFConfig(batch_size=kw["batch"], seed=0,
                              pipeline="force",
                              pipeline_microbatches=PP_MICRO),
                  mesh=ff.make_mesh(shape, [dev] * n), **kw)
        m.compile(optimizer=ff.SGDOptimizer(**sgd))
        if m._pipeline is None:
            raise RuntimeError(f"pipeline and ring (a) {shape}: the "
                               "pipeline was not carved")
        meta = m._pp_meta
        carve = (len(meta["prefix"]), len(meta["core_names"][0]),
                 len(meta["suffix"]))
        torch.cuda.reset_peak_memory_stats()
        losses, times, shifts, apps = train(m, 3)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, base_losses))
        err, excess = param_diffs(m, one, param_rtol, param_atol)
        more, times2, shifts2, apps2 = train(m, PP_STEPS - 3)
        peak = torch.cuda.max_memory_allocated() - base
        steps_s = (times + times2)[2:]
        step = statistics.median(steps_s)
        core = [shard_bytes({"c": m.shard_params[r]["_pp_core"]})
                for r in range(n)]
        total = [shard_bytes(m.shard_params[r]) for r in range(n)]
        slots = [shard_bytes(st) if isinstance(st, dict) else 0
                 for st in m.shard_opt_states]
        want_shifts = 2 * (PP_MICRO + k - 2) * dp
        want_apps = PP_MICRO * n
        got_shifts = (shifts["shift"] + shifts2["shift"]) / PP_STEPS
        log(f"pipeline and ring (a) GPipe {shape} on {card}: carve prefix "
            f"{carve[0]}, unit {carve[1]} nodes, suffix {carve[2]} "
            f"({[sum(nm.endswith('_attn') for nm in c) for c in meta['core_names']]}"
            f" layers a stage); losses {[round(v, 6) for v in losses]} against one "
            f"device's, max rel diff {rel:.3e} (tol {loss_rtol}); after 3 "
            f"steps max abs param diff {err:.3e}, every parameter within "
            f"rtol {param_rtol}, atol {param_atol}: {excess <= 0}; "
            f"median step {step * 1e3:.3f} ms (min {min(steps_s) * 1e3:.3f},"
            f" max {max(steps_s) * 1e3:.3f}, {len(steps_s)} steps after 2 "
            f"warm-up; one device {one_ms:.3f} ms), "
            f"{kw['batch'] / step:.2f} samples/s; each shard's bytes: core "
            f"{[c / 1e6 for c in core]} MB = "
            f"{[round(c / encoder, 4) for c in core]} of the encoder (1/K "
            f"{1 / k:.4f}), all parameters {[t / 1e6 for t in total]} MB, "
            f"optimizer slots {[t / 1e6 for t in slots]} MB; peak memory "
            f"{peak / 1e9:.2f} GB above the {base / 1e9:.2f} GB held before;"
            f" a step: {apps:g} stage applications (schedule {want_apps}), "
            f"{got_shifts:g} shift calls (schedule {want_shifts}: "
            f"{PP_MICRO + k - 2} forward and as many backward in each of "
            f"{dp} rings), {(shifts['all_reduce'] + shifts2['all_reduce']) / PP_STEPS:g}"
            f" gradient all-reduces")
        if (not all(np.isfinite(losses + more)) or rel > loss_rtol
                or excess > 0 or apps != want_apps or apps2 != apps
                or got_shifts != want_shifts):
            raise RuntimeError(f"pipeline and ring (a) {shape}: differs "
                               "from one device or from its schedule")
        del m
        gc.collect()
        torch.cuda.empty_cache()
    del one
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the consult on {"pp": 4} priced by the h100 machine
    m = build(ff.FFConfig(batch_size=kw["batch"], seed=0, pipeline="auto",
                          pipeline_microbatches=PP_MICRO),
              mesh=ff.make_mesh({"pp": 4}, [dev] * 4), **kw)
    t0 = time.perf_counter()
    m.compile(optimizer=ff.SGDOptimizer(**sgd))
    consult_s = time.perf_counter() - t0
    choice = m.pipeline_choice
    machine = MachineModel.for_mesh(m.mesh).spec.name
    losses, times, _, _ = train(m, 5)
    step = statistics.median(times[2:])
    costs = choice["costs"]
    log(f"pipeline and ring (b) consult on {{'pp': 4}} on {card}: kind "
        f"{choice['kind']}, prices pipeline {costs['pipeline'] * 1e3:.3f} "
        f"ms, GSPMD {costs['gspmd'] * 1e3:.3f} ms ({machine} machine "
        "model); "
        f"the {'pipelined' if m._pipeline else 'GSPMD'} plan ran, median "
        f"step {step * 1e3:.3f} ms (min {min(times[2:]) * 1e3:.3f}, max "
        f"{max(times[2:]) * 1e3:.3f}, 3 steps after 2 warm-up); compile "
        f"with both searches {consult_s:.1f}s; losses "
        f"{[round(v, 4) for v in losses]}")
    if (choice["kind"] != min(costs, key=costs.get)
            or (choice["kind"] == "pipeline") != (m._pipeline is not None)
            or not all(np.isfinite(losses))):
        raise RuntimeError(f"pipeline and ring (b): kind {choice} and the "
                           "plan that ran disagree")
    del m
    gc.collect()
    torch.cuda.empty_cache()

    # (c) ring attention on the sp axis against one device
    rng = np.random.RandomState(2)
    xr = rng.randn(RING["batch"], RING["seq"],
                   RING["hidden_dim"]).astype(np.float32)
    yr = rng.randint(0, classes, RING["batch"]).astype(np.int32)
    logit_atol, ring_rtol = 1e-5, 1e-4
    runs = {}
    for shape in ({"dp": 1}, {"sp": 4}, {"dp": 2, "sp": 2}):
        n = 1
        for v in shape.values():
            n *= v
        base = torch.cuda.memory_allocated()
        mesh = ff.make_mesh(shape, [dev] * n)
        m = build(ff.FFConfig(batch_size=RING["batch"], seed=0), mesh=mesh,
                  **RING)
        strategy = data_parallel_strategy(m.graph, mesh)
        if "sp" in shape:
            for node in m.graph.nodes:
                if node.name.endswith("_attn"):
                    strategy.setdefault(node.name, {})["sequence"] = ("sp",)
        m.compile(optimizer=ff.SGDOptimizer(**sgd), strategy=strategy)
        torch.cuda.reset_peak_memory_stats()
        logits = m.forward(xr).detach()
        shifts = count_collectives(mesh.comm)
        times = step_timer(m, torch)
        hist = m.fit(xr, yr, epochs=5, shuffle=False, verbose=False)
        peak = torch.cuda.max_memory_allocated() - base
        runs[str(shape)] = (logits, [h["loss"] for h in hist],
                            statistics.median(times[2:]), peak,
                            shifts["shift"] / 5, times)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    ref_logits, ref_losses = runs["{'dp': 1}"][:2]
    for key, (logits, losses, step, peak, shifts, times) in runs.items():
        if key == "{'dp': 1}":
            diff, rel, want = 0.0, 0.0, 0
        else:
            diff = float((logits - ref_logits).abs().max())
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(losses[:2], ref_losses[:2]))
            sp = 4 if "'sp': 4" in key else 2
            want = 2 * 2 * (sp - 1) * 2 * (4 // sp)
        log(f"pipeline and ring (c) {key} on {card}: "
            f"{RING['num_layers']} layers, hidden {RING['hidden_dim']}, "
            f"{RING['num_heads']} heads, seq {RING['seq']}, batch "
            f"{RING['batch']}, "
            f"sequence over sp on every attention: logits max abs diff "
            f"from one device {diff:.3e} (tol {logit_atol}), 2 SGD steps' "
            f"losses {[round(v, 6) for v in losses[:2]]}, max rel diff "
            f"{rel:.3e} (tol {ring_rtol}); median step {step * 1e3:.3f} ms "
            f"(min {min(times[2:]) * 1e3:.3f}, max {max(times[2:]) * 1e3:.3f}"
            f", 3 steps after 2 warm-up); peak memory {peak / 1e9:.2f} GB; "
            f"{shifts:g} shift calls a step (schedule {want}: 2 (sp - 1) a "
            f"layer and ring forward, as many backward)")
        if (not all(np.isfinite(losses)) or diff > logit_atol
                or rel > ring_rtol or shifts != want):
            raise RuntimeError(f"pipeline and ring (c) {key}: differs from "
                               "one device or from its schedule")


def tc_reports(text):
    """(kernel, "registers, shared memory, spills") of each tensor-core
    kernel instantiation in an ``nvcc -Xptxas=-v`` log; the shared memory
    ptxas reports is the static part (the ring is dynamic)."""
    lines = text.splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" not in ln:
            continue
        mangled = ln.split("'")[1]
        name = next((k for k in TC_KERNELS if k in mangled), None)
        if name is None:
            continue
        # the template arguments, as they appear in the mangled name
        args = mangled.split(name, 1)[1]
        info = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 5]
                if "Used" in x or "spill" in x]
        out.append((f"{name}{args[:40]}", "; ".join(info)))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "drives the port on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flexflow_tpu_torch import serve
    from flexflow_tpu_torch.ops.cuda import attention as att
    from flexflow_tpu_torch.ops.cuda import build
    from flexflow_tpu_torch.serve.ops import kv_quant

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _, logs = build.build()
    log(f"build: {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, text in logs.items():
        regs = [ln.split("info    :")[-1].strip() for ln in text.splitlines()
                if "Used" in ln]
        spills = [ln.strip() for ln in text.splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes")]
        log(f"build {name}: {len(regs)} kernels, registers "
            f"{sorted({r.split()[1] for r in regs})}, spills {spills}")
        for kernel, report in tc_reports(text):
            log(f"ptxas {kernel}: {report}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    count_plain_versions(att)

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"phase {label} done in {time.perf_counter() - t0:.1f}s")
        return out

    kres = timed("kernels", lambda: phase_kernels(att, kv_quant, torch, dev))
    kres.update(timed("tree kernels", lambda: phase_tree_kernels(
        att, kv_quant, torch, dev)))
    timed("edge kernels", lambda: phase_edge_kernels(att, kv_quant, torch,
                                                     dev))
    timed("row edge kernels", lambda: phase_row_edge_kernels(
        att, kv_quant, torch, dev))
    fam_kres, _ = timed("k1 families", lambda: phase_k1_families(
        att, kv_quant, torch, dev))
    kres.update(fam_kres)
    timed("parity", lambda: phase_parity(serve, torch, dev))
    timed("spec parity", lambda: phase_spec_parity(serve, torch, dev))
    parity = timed("variant parity", lambda: phase_variant_parity(
        serve, att, torch, dev))
    fam_parity = timed("family parity", lambda: phase_family_parity(
        serve, att, torch, dev))
    launches, ttft, tpot = timed("serve", lambda: phase_serve(
        serve, att, torch, dev))
    torch.cuda.empty_cache()
    int8 = timed("int8 serve", lambda: phase_serve_int8(
        serve, att, torch, dev, ttft, tpot))
    mpt = timed("mpt serve", lambda: phase_serve_mpt(serve, att, torch, dev))
    fams = timed("family serve", lambda: phase_serve_families(
        serve, att, torch, dev))
    f32 = timed("f32 serve", lambda: phase_serve_f32(serve, att, torch,
                                                      dev))
    life = timed("serve lifecycle", lambda: phase_serve_lifecycle(
        serve, att, torch, dev))
    api = timed("api default path", lambda: phase_api_default(
        serve, att, torch, dev))
    mixed = timed("spec mixed", lambda: phase_spec_mixed(
        serve, att, torch, dev))
    control = timed("control plane", lambda: phase_control_plane(
        serve, att, torch, dev, card))
    fleet = timed("fleet, migration and replay", lambda:
                  phase_fleet_migration_replay(serve, att, torch, dev))
    tp = timed("tensor parallel", lambda: phase_tensor_parallel(
        serve, att, kv_quant, torch, dev))
    pp = timed("pipeline parallel", lambda: phase_pipeline_parallel(
        serve, att, torch, dev))
    timed("planner", lambda: phase_planner(serve, torch, dev, ttft, tpot,
                                           card))
    searched = timed("searched strategy", lambda: phase_searched_strategy(
        serve, att, torch, dev, card))
    one_step_ms = timed("training", lambda: phase_training(torch, dev,
                                                          card))
    timed("training on a mesh", lambda: phase_training_mesh(
        torch, dev, card, one_step_ms))
    timed("training planner", lambda: phase_training_planner(torch, dev,
                                                              card))
    timed("vision and dlrm", lambda: phase_vision_dlrm(torch, dev, card))
    timed("moe and heads", lambda: phase_moe_heads(torch, dev, card))
    builder = timed("builder and frontends", lambda: phase_builder_frontends(
        serve, att, torch, dev, card))
    timed("pipeline and ring", lambda: phase_pipeline_ring(torch, dev, card))

    def plus(*counts):
        return {k: sum(c.get(k, 0) for c in counts)
                for k in set().union(*counts)}

    # each kernel variant's launches on the path that runs it: fp on the
    # 7B bf16 serve path, int8+paged on the 7B int8 serve path, int8 and
    # paged on the 2-layer variant-parity paths; K1's ALiBi variants on the
    # MPT-7B serve paths (fp, int8+paged) and the 2-layer MPT parity paths
    # (int8, paged); K1 at 71 and 48 query heads per KV head on the
    # Falcon-7B parity path and the StarCoder serve path; float32: fp on
    # the 7B f32 serve path, the others on the (f32) variant-parity paths,
    # K1 and K2 paged on the 7B f32 lifecycle path too; f32 fp adds the
    # API's default path (K1 and K2 chained and gated, K3 per-token under
    # sampled SpecInfer) and the 7B mixed spec and plain rows (K1 on the
    # catch-up and the flush, K2 on the prefill, K3 per-token on verify
    # steps with root-only trees, K3 batched with pad nodes); f32 fp and
    # paged add phase 16's runs (the fleet, the migrations, the replay: K1
    # and K2, K3 per-token on the speculative deployment before and after
    # its move to pages); f32 fp and bf16 fp add phase 18's pipelined runs
    # at the 7B's heads (every stage's launches), which the 7b-pp2 rows
    # also show alone, and phase 20's runs under searched and hand
    # strategies (both shards' launches: a head-sharded layer's at the
    # shard's heads, the others at the 7B's)
    def path_counts_f32(var):
        if var == "fp":
            return {"decode_attention": plus(f32["incremental"],
                                             api["chained"], mixed["mixed"],
                                             fleet, pp["f32"],
                                             searched["f32"]),
                    "prefill_attention": plus(f32["incremental"],
                                              api["chained"], mixed["mixed"],
                                              fleet, pp["f32"],
                                              searched["f32"]),
                    "tree_attention": plus(f32["spec host"], api["spec"],
                                           mixed["mixed"], fleet, pp["f32"],
                                           searched["f32"]),
                    "tree_attention_batched": plus(f32["spec device"],
                                                   mixed["scan"])}
        counts = {"decode_attention": parity[var]["incremental"],
                  "prefill_attention": parity[var]["incremental"],
                  "tree_attention": parity[var]["spec host"],
                  "tree_attention_batched": parity[var]["spec device"]}
        if var == "paged":
            for name in ("decode_attention", "prefill_attention"):
                counts[name] = plus(counts[name], life, fleet)
            counts["tree_attention"] = plus(counts["tree_attention"], fleet)
        return counts

    def path_counts(var):
        if var == "fp":
            # the 7B bf16 serve path, phase 15's first run (hooks off)
            # and its speculative run, and phase 26's builder-served 7B
            return {"decode_attention": plus(launches["incremental"],
                                             control["incremental"],
                                             pp["bf16"], searched["bf16"],
                                             builder["incremental"]),
                    "prefill_attention": plus(launches["incremental"],
                                              control["incremental"],
                                              pp["bf16"], searched["bf16"],
                                              builder["incremental"]),
                    "tree_attention": plus(launches["spec host"],
                                           control["spec"],
                                           builder["spec host"]),
                    "tree_attention_batched": plus(launches["spec device"],
                                                   builder["spec device"])}
        if var == "int8+paged":
            return {"decode_attention": int8["incremental"],
                    "prefill_attention": int8["incremental"],
                    "tree_attention": int8["spec device"],
                    "tree_attention_batched": int8["spec device"]}
        return {"decode_attention": parity[var]["incremental"],
                "prefill_attention": parity[var]["incremental"],
                "tree_attention": parity[var]["spec host"],
                "tree_attention_batched": parity[var]["spec device"]}

    replaces = {
        "decode_attention": "flexflow_tpu/ops/pallas/attention.py:209",
        "prefill_attention": "flexflow_tpu/ops/pallas/attention.py:444",
        "tree_attention": "flexflow_tpu/ops/pallas/attention.py:790",
        "tree_attention_batched": "flexflow_tpu/ops/pallas/attention.py:836",
    }
    source = {"tree_attention_batched": "tree_attention"}
    kernels = []

    def entry(name, label, res, n):
        kernels.append({
            "name": name if label == "fp" else f"{name}/{label}",
            "route": "cuda",
            "source": f"flexflow_tpu_torch/csrc/{source.get(name, name)}.cu",
            "replaces": replaces[name], "launches": n, **res})

    for var in VARIANTS:
        counts = path_counts(var)
        for name in COUNTED:
            # the serve path's dtype
            entry(name, var, kres[(name, var, "bfloat16")],
                  counts[name][(name, var)])
    for var in VARIANTS:
        counts = path_counts_f32(var)
        for name in COUNTED:
            entry(name, "f32" if var == "fp" else f"{var}/f32",
                  kres[(name, var, "float32")], counts[name][(name, var)])
    k1 = "decode_attention"
    for var in att.ALIBI_VARIANTS:
        n = (mpt[var] if var in mpt else fam_parity[("mpt", var)])
        entry(k1, var, kres[(k1, var, "bfloat16")], n[(k1, var)])
    entry(k1, "fp+gq71", kres[(k1, "fp+gq71", "bfloat16")],
          fam_parity[("falcon", "fp")][(k1, "fp")])
    entry(k1, "fp+gq48", kres[(k1, "fp+gq48", "bfloat16")],
          fams["starcoder"][(k1, "fp")])
    # the shard-local shape of Llama-2-7B at tp=2 (16 query heads on 16 KV
    # heads), with phase 17's launches over both shards (f32 on (a)'s fp
    # paths, bf16 K1 and K2 on (b)'s serve path) and phase 18(a)'s pp=2 x
    # tp=2 run's over its four stage shards (f32)
    shard = tp["kernels"]["7b-tp2-shard"]
    for name in COUNTED:
        entry(name, "f32+7b-tp2-shard", shard[(name, "fp", "float32")],
              tp["f32"][(name, "fp")] + pp["f32 shard"][(name, "fp")])
    for name in ("decode_attention", "prefill_attention"):
        entry(name, "7b-tp2-shard", shard[(name, "fp", "bfloat16")],
              tp["bf16"][(name, "fp")])
    # phase 18's launches alone (in the rows above too), each beside the
    # times of its shape: every stage's kernels at the 7B shapes, f32 on
    # (a)'s pp=2 fp paths, bf16 K1 and K2 on (b)'s two pp=2 runs; and f32
    # K1 and K2 at a shard's heads, (a)'s pp=2 x tp=2 run (the times of
    # the 7b-tp2-shard rows); a decode micro-batch is half the flat rows,
    # not timed apart
    for name in COUNTED[:3]:
        entry(name, "f32+7b-pp2", kres[(name, "fp", "float32")],
              pp["f32"][(name, "fp")])
    for name in ("decode_attention", "prefill_attention"):
        entry(name, "7b-pp2", kres[(name, "fp", "bfloat16")],
              pp["bf16"][(name, "fp")])
        entry(name, "f32+7b-pp2-tp2-shard", shard[(name, "fp", "float32")],
              pp["f32 shard"][(name, "fp")])
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
