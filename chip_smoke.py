#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddlepaddle_tpu_torch``) on one NVIDIA
Hopper card and check it. Run from the repository root:

    python3 chip_smoke.py

Phases, each printing one JSON line (any failed check raises and the exit
code is non-zero):

1. ``env``     card name and power limit (nvidia-smi), torch / CUDA
               versions. TF32 is switched off for matmuls and cuDNN, so
               every f32 comparison below is full f32.
2. ``build``   builds every kernel in ``ops/kernels/csrc`` (one nvcc per
               source, all started together) and reports time and ptxas'
               resource use. Phases 4-5 (no paged kernel) run while
               ``paged_attention.cu``, the longest, builds; then phase 3.
3. ``kernel``  paged attention (the context-split kernel and its merge)
               against its plain PyTorch version on the card: small shapes
               (W=1 and W=3, f32 atol 1e-5, bf16 atol 2e-2, ragged lens with
               0 and a zeroed table row), split cases (P 32 pages of 16, W 1,
               2 and 4, lens on and across the split boundaries of the
               plan, with n_split printed) and the main-path shape (h=32,
               kvh=8, hd=128, ps=64, 8 slots, lens 64-2000);
               CUDA-event timings (median, L2 flushed between launches) of
               the kernel, the plain version and SDPA on the pre-gathered
               view, beside the memory/compute bound; then the
               speculative verify's shape (W 4, otherwise the main shape,
               lens from their own seed), checked and timed the same way.
3q. ``kernel_int8``  the int8 variant of paged attention (kernel 1q: int8
               pools, per-page, per-head f32 scales) against its plain
               version: small shapes (W 1 and 3, q f32 atol 1e-5 and bf16
               atol 2e-2, hd 64 and 128, lens with 0, a zeroed table row, a
               zero-scale page; the split cases of phase 3) and, at q f32,
               against kernel 1 run over the pools dequantized beforehand
               (expected bit-equal; the max difference is printed); the
               shared-memory mirror; the main-path shape (h 32, kvh 8,
               hd 128, ps 64, 8 slots, lens 64-2000, bf16 q) timed beside
               kernel 1 at the same lens over bf16 pools, the plain version
               and the dequantize-then-SDPA composition, with the bound;
               then the same at the speculative verify's W 4.
4. ``flash_kernel``  the flash-attention forward, dQ and dK/dV kernels
               (bf16: the TMA/wgmma kernels; f32: the FMA kernels) against
               the plain forward and its autograd backward: 40 small cases
               (d 64/128, f32 atol 1e-5 / bf16 atol 2e-2, causal and full,
               s_q == s_k, s_q < s_k, ragged s 100; bf16 also s_q 1 against
               s_k 2048, s 130, (200, 333) and s 257), the plain routes
               (d 96, causal s_q > s_k: no kernel, within 1e-5 of the CPU)
               and the train phase's shape (b 4, s 2048, h 32, d 128, bf16,
               causal), where two launches of the backward pair must give
               the same bits; timings of each kernel, the plain version and
               SDPA (forward; its backward for the two backward kernels),
               beside the bound.
4v. ``flash_varlen_kernel``  the packed varlen forward, dQ and dK/dV kernels
               (5-7; bf16: the TMA/wgmma kernels; f32: the FMA kernels) against
               their plain versions on the same inputs: 72 small cases (9
               layouts: a padding tail with empty segments first, in the middle
               and last; cu_q != cu_k; causal rows with no key and a segment
               with no keys; 64 one-token segments; a tile over five segments;
               t not a multiple of 8; a 128-row tile over three segments and a
               segment longer than 3 stages of 128 keys; len_k > len_q over
               several key tiles with t_q % 4 != 0; a 64-row consumer over
               three segments whose keys start inside a 64-key tile; d 64/128,
               f32 atol 1e-5 / bf16 atol 2e-2 + rtol 1e-2, causal and full)
               with rows without a key and keys without a row exactly 0; one
               segment over the buffer against the dense kernels (max
               difference printed, dQ's apart; bf16 within 2e-2); each kernel's
               ptxas registers and spills; then the main path at Llama-3-8B
               attention width (h 32, d 128, bf16) through the public entries,
               counters from 0: (a) ``flash_attn_unpadded`` forward and
               backward on a packed batch (8192 tokens in segments of 64-2048,
               one empty, a 64-row tail, causal; each counter exactly 1), (b)
               chunked prefill (8 chunks of 256 against contexts of 512-4096,
               causal), (c) ``variable_length_memory_efficient_attention`` at
               [8, 32, 2048, 128] with lengths 64-2048 (full); (a) and (b)
               against the plain versions in head chunks (atol 2e-2 + rtol
               1e-2), (a) again in f32 (atol 1e-5), (c) per sequence; two
               launches of dQ and two of dK/dV at (a) give the same bits;
               timings at (a) of each kernel, the plain versions and one
               PyTorch call (SDPA over nested jagged tensors if this torch
               takes them causal, else with the block-diagonal mask), beside
               the bound over the visible pairs.
5. ``gather_gemm_kernel``  the gather-GEMM expert FFN's two kernels
               (bf16: gather_gateup_sm90 and expert_down_sm90, TMA +
               wgmma; f32: the FMA pair) each against its plain half, and
               the call against its plain version: 6 small cases (f32 atol
               1e-5; bf16 one bf16 step a phase plus the slack of f32
               summation orders, sqrt(K) 2^-24 (|a| @ |b|), and, for the
               call, the bound its bf16 rounding of hmid implies;
               planted drops, an empty expert, all-sentinel 64-slot halves,
               C not a multiple of the row tile, T 1, the smallest (d, h)
               the support check admits); the shared-memory plan, Python
               against CUDA; then two full-width bf16 cases, slots from a
               routing of random x: the moe_train shape (E 64, C 320,
               T 8192, d 2048, h 1408) and Mixtral-8x7B's expert widths
               (E 8, C 640, T 2048, d 4096, h 14336); for each, timings of
               each phase, the call, the plain version and the sorted
               mode's composition (gather, two bmm, silu*mul, bmm), beside
               the bounds of each phase and of the call.
6. ``engine_parity``  a tiny fp32 Llama served greedily by the port engine
               on the card (kernel) and on the CPU (plain version): equal
               tokens.
6q. ``engine_parity_int8``  a tiny fp32 Llama with ``kv_quant="int8"``,
               prefix requests and a pool of 5 pages, so prefixes spill to
               the host tier and come back: card and CPU give equal tokens
               and equal prefix / host counters, and the int8 kernel ran
               layers x decode steps times.
7. ``train_parity``  a tiny fp32 Llama (d 64) trained 3 TrainStep steps on
               the card and on the CPU from one state and one batch: losses
               within 1e-4, parameters within 5e-4 (half a step's move),
               flash launch counters moved.
8. ``moe_parity``  a tiny fp32 MoE decoder (fused mode, d 256, h 128, 4
               experts) trained 3 TrainStep steps on the card and on the CPU
               from one state: losses within 1e-4, parameters within 5e-4,
               the gather-GEMM counter moved by layers x steps.
8c. ``capture_parity``  Llama-3-8B widths cut to 2 of 32 layers (bf16),
               8 slots, page 64, chunk 16, bf16 and int8 KV, int8 weights
               over both, and the contiguous layout: one engine's
               captured decode chunks (CUDA graph replays) against a second
               engine's chunk body called eagerly over the same admissions:
               tokens, lens, active flags, budgets, the packed payload and
               every KV pool equal to the bit after each of 4 chunks, the
               paged counter moved chunk x layers per replay; then two
               sampled slots: replay-to-replay variation and equal draws
               from equal seeds.
9. ``serve``   the serving path at full width: Llama-3-8B (bf16, seeded
               random weights) behind ``ServingEngine(max_batch_size=8,
               kv_page_size=64, max_len=2048, decode_chunk=16)`` answering
               24 requests (prompts 64-1536, budgets 32-128, two sampled);
               every decode chunk is a replay of the captured graph. Every
               future must complete with its full length and in-vocab
               tokens, and the paged-attention launch count (counted per
               replay) must equal 32 layers x decode steps; the captured
               chunk's wall, device time and idle share, and the capture's
               seconds and graph-pool bytes.
9s. ``serve_spec``  the serve phase's model behind the same engine with
               ``spec_k=3`` (the verify attends W = 4 rows a slot through
               kernel 1), greedy, 8 of the serve phase's prompts with
               budgets capped at 32 (64 before the pipeline phases), four
               runs: the target itself as the
               draft, the "quarter" draft config (hidden 1024, 8 layers),
               the quarter draft over int8 KV (kernel 1q at W = 4), and the
               target as its own draft with ``draft_quant`` (int8 draft
               weights, bf16 verify).
               Each: full-length outputs, W = 4 launches equal to layers x
               target steps, no leaked page; tokens per target step,
               acceptance, the run-length histogram, the share of tokens
               equal to the serve phase's (reported, not gated), the spec
               chunk's wall, device time and idle share, and a captured
               verify's layer-0 attention against the plain version (atol
               2e-2).
9q. ``serve_int8``  Llama-3-8B (bf16, seeded weights) behind
               ``ServingEngine(max_batch_size=8, kv_page_size=64,
               max_len=2048, decode_chunk=16, kv_quant="int8",
               kv_host_bytes=256 MiB)`` with a page pool that holds the 8
               slots' private pages and two of four shared prefixes: 32
               requests round-robin over four 1024-token system prompts,
               each with a 64-512-token tail, ``prefix_len=1024``, budgets
               32-128, two sampled. Every future completes at full length
               with in-vocab tokens, prefixes spill and restore, and the
               int8 kernel ran 32 layers x decode steps times; tok/s, TTFT,
               TPOT, prefix and host counters, restore ms, KV bytes against
               a bf16 pool of the same page count, and the captured decode
               chunk's device time by kind with the idle share.
8q. ``quant_parity``  weight-only int8 at Llama-3-8B widths, 2 of 32
               layers: ``quantize_param_tree``'s codes and scales on the
               card bit-equal to the CPU's plain path (per channel and group
               128), a quantized engine's prefill and first-step logits
               against an f32 model over the dequantized weights (atol
               0.25), and the caller's model unchanged.
9w. ``serve_wo_int8``  the serve phase's configuration and requests with
               ``quant="weight_only_int8"`` over the same model: outputs,
               kernel 1 launches = layers x steps, tok/s, the chunk's
               device time by kind and idle share, ``quant_meta``'s bytes,
               peak memory, beside serve's numbers from this run; and the
               weight-only product at [8, 4096] x [4096, 14336] against its
               f32 reference, timed beside the bf16 matmul, with its bound.
9t. ``serve_static``  ``ServingEngine(mode="static")`` over the serve
               model: 8 prompts of 512 tokens, 64 new, one
               ``generate_cached`` batch; tok/s, TTFT, the eager loop's
               device idle share; ``generate`` at full width (kernel 2 at
               every step); on a 2-layer f32 copy of the widths, static ==
               continuous and ``generate`` == ``generate_cached`` tokens.
9c. ``serve_contiguous``  ``kv_layout="contiguous"`` over the serve model
               on 8 of its requests: outputs, no paged launch, tok/s, pool
               bytes; on the 2-layer f32 model the contiguous and
               ``fused_kernels=False`` engines' tokens equal the paged
               kernel engine's.
9r. ``serve_robust``  deadline, cancel and drain on a 2-layer engine with
               captured chunks: typed errors, pages returned, the other
               requests' tokens unchanged; ``health()`` printed.
10. ``train`` the training path at full width: Llama-3-8B widths cut to 8
               of 32 layers (memory), bf16 with f32 AdamW masters and a
               global-norm clip, batch 4 x 2048 fed 7 times (1 warm-up, 5
               timed, 1 profiled); losses finite and falling, each flash
               counter exactly layers x steps, no non-finite parameter;
               step time, tokens/s, MFU, peak memory and the device time by
               kind.
11. ``moe_train``  the MoE decoder at DeepSeekMoE-16B widths (hidden 2048,
               64 experts of width 1408, 2 shared, vocab 102400, top-2,
               capacity factor 1.25, fused mode) cut to 4 of 28 layers
               (memory), bf16 with f32 AdamW masters and a global-norm clip,
               batch 4 x 2048 fed 7 times (1 warm-up, 5 timed, 1 profiled);
               losses finite and falling, the gather-GEMM counters (calls
               and each of its two kernels) and flash counters exactly
               layers x steps, no non-finite parameter; step time,
               tokens/s, MFU on the active parameters, peak memory, device
               time by kind and the share of routed entries each layer's
               capacity dropped.

4d. ``flash_d64``  kernels 2-4 in bf16 at head dim 64 (BERT-base and
               GPT-2 small: 768 / 12): the three at GPT-2 small's training
               shape (b 12, s 1024, h 12, causal) and the forward at
               BERT-base's eval shape (b 32, s 128, h 12, full), each
               against the plain version (atol 2e-2), timed beside the plain
               versions, SDPA and the bound (rows 2b-4b).
8z. ``zoo_parity``  small f32 copies, the card against the CPU path from
               one state: ResNet(BottleneckBlock, 50, width 16, 10 classes)
               at 4 x 3 x 64 x 64 (train-mode logits, one Momentum step,
               the running statistics, eval logits); 2 layers of BERT-base's
               widths at b 2, s 128 (eval logits without a mask: kernel 2
               once a layer; with a padding mask: no launch; one AdamW
               step: kernels 2-4 once a layer); 2 layers of GPT-2 small's
               widths (loss, one AdamW step, 16 greedy tokens equal to the
               CPU's). Tolerances in each helper's docstring.
12. ``resnet50_train``  BASELINE config 2 as bench.py:312-358 runs it:
               ResNet-50 (1000 classes) in bf16, Momentum(0.1, 0.9), batch
               128 x 3 x 224 x 224, NCHW; 2 warm-up and 5 timed steps, one
               profiled: step ms, images/s, mfu_approx, peak memory, the
               device time split into convolutions, layout transforms,
               batch norm, the optimizer and the rest; batch norm's forward
               + backward against cuDNN's at 128 x 256 x 56 x 56.
13. ``bert_base``  BASELINE config 1 at the BERT paper's GLUE settings: b
               32, s 128 with padding masks, dropout 0.1, AdamW 2e-5, bf16,
               2 labels; 5 timed steps; eval launches of kernel 2: 12
               without a mask, 0 with one.
14. ``gpt2_small``  GPT-2 124M at nanoGPT's settings (12 x 1024, bf16,
               AdamW 6e-4, dropout 0): 5 timed steps, tokens/s, MFU, kernels
               2 / 3 / 4 at 12 launches a step each; ``generate`` of 32
               greedy tokens from 8 prompts of 128.
9w. ``coldstart``  cold start over the serve model (each arm its own
               engine, serve's settings): a fresh engine without warmup,
               then one after ``warmup()``; each serves the serve phase's
               first 6 requests, the first alone: its TTFT and latency, the
               warmup's seconds split into build, capture and admission,
               and the CUDA-graph captures and kernel builds the watchdog
               counts in each serve window (0 after warmup).
9b. ``bundle_restart``  at 2 of 32 Llama-3-8B layers: ``save_serving_bundle``,
               then a subprocess with ``PADDLE_TORCH_KERNEL_BUILD_DIR``
               pointed at an empty directory builds the same engine with
               ``bundle=``: its nvcc runs (0), its seconds from the script's
               start to a served first token, its tokens (equal to this
               process's engine's); then a bundle of another configuration
               (chunk 8) is refused with the differing fact and the engine
               serves through the kernel all the same.
9o. ``serve_observed``  the serve workload on one engine, observability off
               and on in turns (off, on, on, off): metrics, traces, request
               journeys, the perf plane, the memory ledger and the flight
               recorder; tok/s of each run; ``/metrics`` scraped from the
               exporter over localhost and parsed; the goodput ledger
               reconciled with the delivered and decoded tokens; no leaked
               page; the decode program's counted cost and MFU; a 2-layer
               TrainStep's counted FLOPs and its step-timeline MFU against
               ``perf/device.py``'s peak.

9f. ``fleet_parity``  the serving fleet at Llama-3-8B widths, 2 of 32
               layers, f32: a ``ServingRouter`` over two in-process
               replicas sharing one model and one replica process
               (``ProcessReplicaFactory`` -> ``replica_main`` on the card,
               the same weights from seed 0). Every request's greedy tokens
               equal one engine's; ``rolling_restart()`` with about ten
               requests kept in flight: no request fails, each fresh
               engine's capture begins while another replica decodes (the
               busy slots are printed), each graph counts layers x chunk
               launches a replay and this process's counter moves by
               exactly the replays' launches; the replica process SIGKILLed
               mid-stream: each request completes with its tokens on
               another replica or fails typed, the supervisor respawns the
               child (0 nvcc runs), whose health over the wire reports its
               paged launches; no page leaked on any replica.
9g. ``serve_fleet``  the serve model (Llama-3-8B, 32 layers, bf16) behind
               a router over two in-process replicas that share its
               weights, each with its own KV pool, beside one engine alone
               in the same run: the serve workload's tok/s, TTFT p50/p99
               and TPOT for each, with the metric history and the alert
               rules on; each replica's paged launches (their sum equal to
               layers x decode steps), the rules that fired or are pending,
               and ``/query``'s answer for
               ``paddle_router_replica_inflight``.

10. Tensor and data parallelism (A10's core), after ``gpt2_small``. The
    ranks are processes started by the port's own ``spawn``; the kernel
    libraries are built by this process first, so the ranks only load them
    (their ``nvcc`` runs are printed and must be 0). One card: multi-rank
    phases share ``cuda:0`` over gloo given explicitly (the compute on the
    card, the collectives through the host; NCCL refuses two ranks on one
    device), and their times describe that rig, not TP on separate cards.
    Every spawn has a process-group timeout and a join timeout; a failed or
    hung rank fails the phase.
10a. ``tp_parity``  a tiny f32 Llama (2 layers, 8 heads, 4 KV heads, head
               dim 128: 2 KV heads a rank) from one seed: TP-2 greedy tokens equal the
               plan-less engine's on the card and agree on both ranks, each
               rank's paged launches = layers x decode steps; ``dp2`` (2
               ranks) and ``dp2mp2`` (4 ranks) ``ShardedTrainStep`` losses
               over 2 steps within the CPU tests' rtol (1e-5 / 1e-4) of a
               one-process ``TrainStep``, with each rank's flash launches.
10b. ``serve_tp``  Llama-3-8B widths at 2 layers, bf16, ``mp2``: 8
               requests; the tokens agree on both ranks; the logits of
               one paged decode step (kernel 1 on 4 KV heads a rank) after
               prefilling the 8 prompts, equal on both ranks and within
               0.25 (max abs, bf16: two rounding orders of the row-parallel
               sums over 2 layers) of the one-process engine's at the same
               input; kernel 1 on every rank (layers x
               decode steps); tok/s beside a one-process engine at the
               same depth in the same run, the chunk's wall, and the ms a
               chunk spends in all-reduce (a second run with collective
               timing on).
10c. ``train_tp``  Llama-3-8B widths at 2 layers, bf16, AdamW + global-norm
               clip, global batch 4 x 512: ``mp2`` and ``dp2`` on one
               pair of ranks, 1 step each (run beside the untimed parity
               phases 10a, 10j, 10n and 10e, as 10d's rank, 10f, 10h and
               train_parity_more are, each in processes of its own);
               losses within 0.02 of a
               one-process ``TrainStep``; flash launches and peak memory
               a rank.
10d. ``nccl_world1`` (its rank also runs beside those phases) one NCCL
               rank, Llama-3-8B widths at 2 layers, bf16,
               ``decode_plan("mp1")``: the decode chunk is captured with the
               NCCL all-reduce inside; tokens bit-equal to the plan-less
               captured engine's; ``capture_info()`` and replays; tok/s of
               both after each captured on a warm-up request.

    The single-process form (the reference's one-controller call): this
    process calls ``ServingEngine(model, mesh="mp2")`` and is rank 0; the
    engine starts rank 1 itself, on ``cuda:0`` over gloo groups it owns.
    Every such phase reads both ranks' kernel counters through the engine
    (``_rank_counters``: the worker's gathered by a led step) and checks,
    after ``stop()``, that the worker's pid is gone (and absent from
    ``nvidia-smi --query-compute-apps``).
10b'. ``serve_tp`` single-process arm, right after the SPMD arm, on its
               model, prompts and settings: tokens equal the SPMD arm's,
               to the bit; one paged decode step's logits (after
               prefilling the 8 prompts) within 0.25 of the one-process
               engine's; kernel 1 = layers x decode steps on each rank; 0
               nvcc runs in the worker; tok/s beside the SPMD arm's, the
               construction's seconds (the worker's start, imports and
               hand-over; its groups; its engine) and each process's peak
               memory.
10e. ``spec_tp``  speculative decoding under mp2 in one process:
               Llama-3-8B widths at 2 layers, bf16, ``spec_k`` 3 (W = 4),
               greedy, 4 of serve_spec's prompts (budgets capped at 16),
               the target as its own
               draft and serve_spec's "quarter" draft (a rollback on
               nearly every step), each replicated on both ranks. Every
               request at
               full length; W = 4 launches = layers x target steps on each
               rank; both ranks took the same accept lengths (their
               checksums agree); no page leaked on either rank;
               acceptance and tokens per target step.
10f. ``router_tp``  the router drill at Llama-3-8B widths, 2 layers, bf16,
               in a process of its own: two ``mesh="mp2"`` engines there
               behind
               ``ServingRouter`` (4 processes on the card), a
               ``serving.decode`` fault storm over 8 requests (none lost,
               at least 6 served), kernel 1 on every rank, a rolling
               restart (old workers gone), both replicas healthy; then a
               ``replica_main --engine-json '{"mesh": "mp2"}'`` replica
               behind ``RemoteReplicaClient``: 2 requests, its health
               shows each rank's launches; SIGKILLed, no process of the
               phase is left.
10g. ``tp_parity``'s single-process check (after 10a's spawns): the tiny
               f32 model's speculative stream under mp2 (the target as
               draft, k 3) equals the one-process non-spec engine's.
10c'. ``train_tp`` single-process arms (after 10c's one-process step):
               ``ShardedTrainStep(model, opt, loss, plan=train_plan(spec))``
               for ``mp2`` and ``dp2`` built in this process (rank 0; the
               step starts rank 1, hands it its view, the optimizer's
               settings and the loss function by value): losses bit-equal
               to the SPMD arm's; each rank's flash launches (read through
               the step) = layers x steps; 0 nvcc runs in the worker;
               construction seconds; the worker gone after ``close()``;
               device memory left behind within 0.25 GB; peak memory of
               each process; rank 0's first gradients of the LM head, the
               embedding, layer 0's wq (its mp slice) and two norms (whole:
               summed over mp) within 0.03 (relative norm) of the one
               process's; rank 0's collectives timed in the step.

    Expert parallelism (A10 slice 2): ``moe_train_rules`` puts each MoE
    layer's banks on ``ep``; the ranks of an ``ep`` group hold the same
    tokens, route the global batch and run kernel 8 over their local
    experts; the partial combine is all-reduced over ``ep``.
10h. ``ep_parity``  the smallest f32 MoE kernel 8 takes (d 128, h 256, E 8,
               top-2, 2 layers, capacity factor 0.5: entries drop, fused),
               batch 4 x 256, 2 AdamW steps with global-norm clip, in a
               process of its own: ``ep2`` and ``dp2ep2`` there against a
               one-process ``TrainStep`` on the same weights: losses
               within 1e-5 relative, every synced parameter within 1e-4,
               local banks E/ep, kernel 8 = layers x steps on every rank.
10i. ``train_ep``  DeepSeekMoE-16B widths at 2 of 28 layers (bf16, fused,
               multi-precision AdamW + clip), batch 4 x 2048: a one-process
               ``TrainStep``, freed, then ``ep2`` in this process (32 of
               64 experts a rank, C 320), 2 steps each: losses within
               0.02; the first step's drop share of layer 0 equal and of
               layer 1 within 0.002; kernels 8 and 2-4 = layers x steps on
               each rank; step ms; the last step's ``ep`` all-reduces
               (count, bytes, ms on rank 0); peak memory of each process;
               the worker gone, memory left behind within 0.25 GB; then
               kernel 8 alone at one rank's shape (T 8192, 32 local of 64
               experts, C 320, the other experts' slots not its own)
               against its plain version, timed beside its bound.

    The fsdp axis, ZeRO-3 (A10 slice 3): a parameter sharded over ``fsdp``
    is gathered where its module uses it; its gradient comes back
    reduce-scattered over a data axis, sliced over any other.
10j. ``fsdp_parity``  10a's f32 Llama on ``fsdp2`` in this process and on
               ``dp2fsdp2``, ``fsdp2mp2`` and the ``p_g_os`` arm over
               ``dp2fsdp2`` with ``data_axes=("dp",)`` on four spawned
               ranks, and 10h's MoE on ``dp2fsdp2`` (the trunk on fsdp,
               the banks whole) and on ``fsdp2ep2`` (``data_axes=
               ("fsdp",)``: the banks on ep beside fsdp, kernel 8 on each
               rank's 4 of 8 experts), 2 momentum steps (lr 0.2, no clip: each
               parameter moves with its gradient's scale) against a
               one-process ``TrainStep``: losses within 1e-5 relative,
               parameters within 1e-4, kernels 2-4 (and 8) = layers x
               steps on every rank.
10k. ``train_fsdp``  Llama-3-8B widths at 2 layers, bf16, multi-precision
               AdamW + clip, batch 4 x 512, 1 step: a one-process
               ``TrainStep``, freed, then ``fsdp2`` in this process:
               losses within 0.02; rank 0's first gradients (10c''s five,
               its fsdp slices) within 0.03 of one process's; each rank's
               resident bytes (parameter
               shards + optimizer state) at most 0.55 of one process's;
               kernels 2-4 on each rank; peak GB, step ms, the
               all-gathers' and reduce-scatters' calls, bytes and ms.
10l. ``pp_parity``  the pipeline gate: ``spmd_pipeline_train`` over the
               hybrid's Llama stages (f32, hidden 256, head dim 64, batch
               8 x 128, M 4) on 8 spawned ranks: ``dp1 fsdp2 tp2 pp2``
               under 1F1B, GPipe, ZBH1, 1F1B at 2 layers a stage,
               interleaved and ZBVPP at V 2; ``dp2 fsdp1 tp2 pp2`` under
               1F1B; the MoE stage on ``dp1 fsdp1 ep2 tp2 pp2``; the
               5-D hybrid ``dp1 fsdp1 sp2 tp2 pp2`` (one causal flash call
               a layer over the gathered K/V prefix): loss (1e-4) and
               gradients (2e-3 / 2e-4) against the unsharded
               oracle on the card; kernels 2-4 on every rank as often as
               ``pp_predicted_launches`` says. Its ranks run beside the
               untimed parity phases 7-8.
10m. ``train_pp``  Llama-3-8B widths, 2 layers a stage on ``pp2`` (two
               spawned ranks), bf16, batch 8 x 1024, M 8: 1F1B, GPipe
               and ZBH1 (one warm-up call, then 1 timed call each) beside the
               four layers and head on one rank: step ms (the schedule
               walk and the sums over pp; the final gathers apart), the
               schedule's bubble, P2P calls / bytes / ms, the head-grad
               and ``dacts`` sums, peak GB beside ``memory_estimate`` +
               the parameters, kernels 2-4 by rank; the loss (abs 1e-4)
               and the head's weight, the stages' wq and the input
               gradients (relative norm 1e-2) against the one-rank arm.
10n. ``sp_parity``  context and sequence parallelism, f32, head dim 64
               (the f32 kernels 2-4): ring attention over ``sp4`` and
               ``sp2``, causal and full, forward and gradients, against
               the plain dense attention on the card (1e-4); the
               context-parallel Llama through ``ShardedTrainStep(
               seq_axis="sp")`` on ``dp2 sp2`` (4 spawned ranks) and
               ``dp1 sp2`` (this process), and ``SequenceParallelBegin``
               / ``End`` on ``mp2`` (the norm weights' first gradients
               within 1e-4): two momentum steps against one process
               (losses 1e-5 relative, parameters 1e-4); kernels 2-4 on
               every rank as ``ring_predicted_launches`` says.
10o. ``train_cp``  Llama-3-8B widths at 2 layers, bf16, one 8192-token
               sequence, multi-precision AdamW + clip, 2 steps: one rank,
               then ``ShardedTrainStep(seq_axis="sp")`` over ``dp1 sp2``
               (ring attention, K/V point to point): losses within 1e-3
               and the first gradients of the head, layer 0's wq and the
               embedding within 0.02 (relative norm) of one rank's; step
               ms, the ring's bytes and ms, kernels 2-4 a rank against
               the prediction, peak GB a rank beside one rank's.

Then each phase's seconds, the run's total seconds, the ``{"kernels": [...]}`` line, the
nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``.
Without CUDA it exits non-zero before printing any result.
"""

from __future__ import annotations

import concurrent.futures
import gc
import itertools
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
PAGED_LIBRARY = "paged_attention"
PAGED_SOURCE = f"paddlepaddle_tpu_torch/ops/kernels/csrc/{PAGED_LIBRARY}.cu"
PAGED_REPLACES = "paddlepaddle_tpu/ops/kernels/paged_attention.py:104"
FLASH_FWD_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_fwd_sm90.cu"
FLASH_BWD_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_bwd_sm90.cu"
GATHER_GEMM_SOURCE = "paddlepaddle_tpu_torch/ops/kernels/csrc/gather_gemm_sm90.cu"
GATHER_GEMM_REPLACES = "paddlepaddle_tpu/ops/kernels/gather_gemm.py:80"
VARLEN_SOURCES = {
    "varlen_fwd": "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu",
    "varlen_bwd_dq":
        "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu",
    "varlen_bwd_dkv":
        "paddlepaddle_tpu_torch/ops/kernels/csrc/flash_varlen_sm90.cu"}
VARLEN_REPLACES = {
    "varlen_fwd": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:123",
    "varlen_bwd_dq": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:156",
    "varlen_bwd_dkv": "paddlepaddle_tpu/ops/kernels/flash_varlen.py:184"}
FLASH_REPLACES = {"flash_fwd": "paddlepaddle_tpu/ops/kernels/flash_attention.py:97",
                  "flash_bwd_dq": "paddlepaddle_tpu/ops/kernels/flash_attention.py:139",
                  "flash_bwd_dkv": "paddlepaddle_tpu/ops/kernels/flash_attention.py:172"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """A mangled kernel name as its last name component, head dim and
    element type, as ``varlen_bwd_dq_kernel_d64_f32``."""
    import re

    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name, i = mangled, 0
    while i < len(s) and s[i].isdigit():     # <length><identifier> ...
        j = i
        while s[j].isdigit():
            j += 1
        name, i = s[j:j + int(s[i:j])], j + int(s[i:j])
    args = s[i:] if s[i:i + 1] == "I" else ""
    dim = re.search(r"Li(\d+)E", args)
    kind = ("bf16" if "13__nv_bfloat16" in args
            else "fp16" if "6__half" in args
            else "f32" if args.startswith("If")
            else "")
    return "_".join(x for x in (name, f"d{dim.group(1)}" if dim else "",
                                kind) if x)


def ptxas_kernels(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, keyed by :func:`kernel_name`."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = kernel_name(m.group(1))
            out.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def median_ms(fn, reps: int = 30, warmup: int = 3, flush=None) -> float:
    """Median per-call DEVICE time from CUDA events. The GPU is first given
    ~20 ms of queued work so that the host enqueues every timed call ahead
    of the device, and the events then bracket device time only (not the
    wrapper's Python). ``flush`` (a buffer larger than L2) is rewritten
    between calls so each call finds L2 cold."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)            # ~20 ms of device spin
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in pairs)
    return times[len(times) // 2]


def host_us(fn, reps: int = 200) -> float:
    """Mean host time of one call (enqueue only, no sync), in µs."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(400_000_000)           # keep the device busy meanwhile
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens, dtype, zero_rows=()):
    import numpy as np
    import torch

    pages = 1 + S * P
    kp = torch.from_numpy(rng.standard_normal((pages, ps, kvh, hd),
                                              dtype=np.float32))
    vp = torch.from_numpy(rng.standard_normal((pages, ps, kvh, hd),
                                              dtype=np.float32))
    q = torch.from_numpy(rng.standard_normal((S, W, h, hd), dtype=np.float32))
    pt = rng.permutation(np.arange(1, pages))[: S * P].reshape(S, P)
    pt = pt.astype(np.int32)
    for r in zero_rows:
        pt[r] = 0
    dev = "cuda"
    return (q.to(dev, dtype), kp.to(dev, dtype), vp.to(dev, dtype),
            torch.from_numpy(pt).to(dev),
            torch.tensor(lens, dtype=torch.int32, device=dev))


def split_lens(pa, S, kvh, ps, P, W):
    """Slot lengths for the split checks: 0, each side of the first split
    boundary, the middle one and the last one, and the end of the table,
    under the plan the kernel takes for (S, kvh, P) on this card."""
    import torch

    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(torch.device("cuda")))
    bounds = [pps * ps * i for i in range(1, n_split)] or [ps]
    lens = [0, bounds[0] - 1, bounds[0], bounds[len(bounds) // 2] + 5,
            bounds[-1] + 1, P * ps - W]
    return lens[:S], n_split, pps


def phase_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    small = []
    for hd in (64, 128):
        for W in (1, 3):
            for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                args = paged_inputs(rng, 4, W, 8, 2, hd, 16, 3,
                                    [5, 13, 0, 40], dtype, zero_rows=(2,))
                kw = dict(rep=4, scale=hd ** -0.5)
                got = pa.paged_attention(*args, **kw)
                want = pa.paged_attention_plain(*args, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                small.append({"hd": hd, "W": W, "dtype": str(dtype)[6:],
                              "max_abs_err": err, "atol": atol})
                if not err <= atol:
                    raise AssertionError(f"paged_attention small shape "
                                         f"hd={hd} W={W} {dtype}: err {err} "
                                         f"> {atol}")

    # the context split: P 32 pages of 16 with lens on and across the split
    # boundaries, W 1, 2 and 4, a zeroed table row, under two plans (6 slots
    # x 2 KV heads: splits of one page; 8 x 8: the main shape's splits of 4
    # pages); inputs from their own seed, so the main shape draws the same
    # lens as before the split
    split_rng = np.random.default_rng(10)
    for (S_, h_, kvh_), hd, W in itertools.product(
            ((6, 8, 2), (8, 32, 8)), (64, 128), (1, 2, 4)):
        lens_s, n_split_s, pps_s = split_lens(pa, S_, kvh_, 16, 32, W)
        lens_s = (lens_s * 2)[:S_]
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            args = paged_inputs(split_rng, S_, W, h_, kvh_, hd, 16, 32,
                                lens_s, dtype, zero_rows=(1,))
            kw = dict(rep=h_ // kvh_, scale=hd ** -0.5)
            got = pa.paged_attention(*args, **kw)
            want = pa.paged_attention_plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            small.append({"S": S_, "kvh": kvh_, "hd": hd, "W": W,
                          "dtype": str(dtype)[6:], "P": 32, "lens": lens_s,
                          "n_split": n_split_s, "pages_per_split": pps_s,
                          "max_abs_err": err, "atol": atol})
            if not err <= atol:
                raise AssertionError(f"paged_attention split case S={S_} "
                                     f"hd={hd} W={W} {dtype}: err {err} > "
                                     f"{atol}")

    # main-path shape: Llama-3-8B decode step, 8 slots, max_len 2048
    S, W, h, kvh, hd, ps, P = 8, 1, 32, 8, 128, 64, 32
    lens = rng.integers(64, 2001, S).tolist()
    args = paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens, torch.bfloat16)
    q, kp, vp, ptab, lens_t = args
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(q.device))
    got = pa.paged_attention(*args, **kw)
    want = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"paged_attention main shape: err {err} > 2e-2")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = median_ms(lambda: pa.paged_attention(*args, **kw), flush=flush)
    plain_ms = median_ms(lambda: pa.paged_attention_plain(*args, **kw),
                         flush=flush)
    wrapper_us = host_us(lambda: pa.paged_attention(*args, **kw))
    library_ms = gathered_sdpa_ms(q, kp, vp, ptab, lens_t, kw["scale"], flush)
    w4 = paged_w4_case(pa, quant=False, flush=flush)
    del flush

    # least time for the same work, from this run's lens (paged_work)
    item = q.element_size()
    bytes_, flops, _ = paged_work(lens, W, h, kvh, hd, ps, P, item, item)
    bound_ms, bound_by = paged_bound(bytes_, flops, 0)
    record = {
        "name": "paged_attention", "route": "cuda",
        "source": PAGED_SOURCE, "replaces": PAGED_REPLACES,
        "launches": None, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
        "shape": f"S{S} W{W} h{h} kvh{kvh} hd{hd} ps{ps} bf16 "
                 f"lens {min(lens)}-{max(lens)}",
        "bytes": bytes_, "flops": flops, "w4": w4,
    }
    emit({"phase": "kernel", "small": small, "main_shape": record["shape"],
          "n_split": n_split, "pages_per_split": pps,
          "lens": lens, "max_abs_err": err, "kernel_ms": kernel_ms,
          "plain_ms": plain_ms, "library_ms": library_ms,
          "wrapper_host_us": wrapper_us, "bound_ms": record["bound_ms"],
          "bound_share": record["bound_ms"] / kernel_ms, "w4": w4})
    return record


def gathered_sdpa_ms(q, kp, vp, ptab, lens_t, scale, flush, scales=None):
    """Yardstick only, not a port path: SDPA over each slot's view gathered
    through the page table beforehand (the gather is not timed); with
    ``scales`` (int8 pools) the timed call is the composition that
    dequantizes the gathered pages to q's dtype, then SDPA."""
    import torch
    import torch.nn.functional as tF

    S, W, h, hd = q.shape
    ps, kvh, P = kp.shape[1], kp.shape[2], ptab.shape[1]
    T = P * ps
    idx = ptab.long()
    k_pos = torch.arange(T, device="cuda")
    q_pos = lens_t.long()[:, None] + torch.arange(W, device="cuda")[None, :]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None]  # [S,1,W,T]
    qs = q.transpose(1, 2).contiguous()                       # [S, h, W, hd]
    if scales is not None:
        ks, vs = scales

        def composition():
            views = []
            for c, sc in ((kp, ks), (vp, vs)):
                d = (c[idx].float() * sc[idx][:, :, None, :, None]).to(q.dtype)
                views.append(d.reshape(S, T, kvh, hd).transpose(1, 2))
            return tF.scaled_dot_product_attention(
                qs, views[0], views[1], attn_mask=mask, scale=scale,
                enable_gqa=True)

        return median_ms(composition, flush=flush)
    kview = kp[idx].reshape(S, T, kvh, hd).transpose(1, 2).contiguous()
    vview = vp[idx].reshape(S, T, kvh, hd).transpose(1, 2).contiguous()
    try:
        return median_ms(lambda: tF.scaled_dot_product_attention(
            qs, kview, vview, attn_mask=mask, scale=scale,
            enable_gqa=True), flush=flush)
    except (TypeError, RuntimeError):
        kr = kview.repeat_interleave(h // kvh, dim=1)
        vr = vview.repeat_interleave(h // kvh, dim=1)
        return median_ms(lambda: tF.scaled_dot_product_attention(
            qs, kr, vr, attn_mask=mask, scale=scale), flush=flush)


SPEC_K = 3                     # serve_spec's proposals per target step


def paged_w4_case(pa, quant: bool, flush) -> dict:
    """The speculative verify's attention: W = SPEC_K + 1 = 4 query rows a
    slot at the Llama-3-8B serving shape (S 8, h 32, kvh 8, hd 128, ps 64,
    bf16 q; int8 pools with ``quant``), lens 64-1996 from their own seed:
    the kernel against its plain version (atol 2e-2, as the W=1 main
    shape), timed beside the plain version, the gathered-view SDPA (the
    dequantize-then-SDPA composition under int8) and the bound."""
    import numpy as np
    import torch

    rng = np.random.default_rng(13 if quant else 12)
    S, W, h, kvh, hd, ps, P = 8, SPEC_K + 1, 32, 8, 128, 64, 32
    lens = rng.integers(64, 2001 - W, S).tolist()
    q, kp, vp, ptab, lens_t = paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens,
                                           torch.bfloat16)
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    scales = None
    if quant:
        kp, ks, vp, vs = int8_pools(kp, vp)
        scales = (ks, vs)
        kw.update(k_scale=ks, v_scale=vs)
    args = (q, kp, vp, ptab, lens_t)
    got = pa.paged_attention(*args, **kw)
    want = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"paged_attention W={W} (int8 {quant}): err "
                             f"{err} > 2e-2")
    kernel_ms = median_ms(lambda: pa.paged_attention(*args, **kw), flush=flush)
    plain_ms = median_ms(lambda: pa.paged_attention_plain(*args, **kw),
                         flush=flush)
    yard_ms = gathered_sdpa_ms(q, kp, vp, ptab, lens_t, kw["scale"], flush,
                               scales=scales)
    bound_ms, bound_by = paged_bound(*paged_work(
        lens, W, h, kvh, hd, ps, P, q.element_size(),
        1 if quant else q.element_size(), scales=quant))
    return {"W": W, "shape": f"S{S} W{W} h{h} kvh{kvh} hd{hd} ps{ps} bf16 q"
            + (", int8 pools" if quant else "")
            + f", lens {min(lens)}-{max(lens)}",
            "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if quant else yard_ms,
            "composition_ms": yard_ms if quant else None,
            "launches": None}


def paged_work(lens, W, h, kvh, hd, ps, P, q_item, kv_item, scales=False):
    """The paged kernel's bytes and operations for these lens (the formula
    lives beside the kernel's wrapper, which reports it to the perf
    plane)."""
    from paddlepaddle_tpu_torch.ops.kernels.paged_attention import \
        paged_work as work

    return work(lens, W, h, kvh, hd, ps, P, q_item, kv_item, scales)


def paged_bound(bytes_, flops, deq_flops):
    """``(bound_ms, bound_by)`` of :func:`paged_work`'s counts: the larger
    of the bytes over the memory rate and the operations over the card's
    peak for their type (the products at the bf16 tensor-core rate, the
    dequantization at the f32 rate; the two units run side by side, so the
    slower of them sets the operations' time)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / BF16_FLOP_PER_S, deq_flops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def int8_pools(kp, vp):
    """int8 codes and per-page, per-head scales of f32 pools, quantized as
    the engine's admission quantizes whole pages."""
    from paddlepaddle_tpu_torch.inference.decode_engine import _kv_quant_pages

    kq, ks = _kv_quant_pages(kp.float())
    vq, vs = _kv_quant_pages(vp.float())
    return kq, ks, vq, vs


def dequantized(codes, scale):
    return (codes.float() * scale[:, None, :, None]).contiguous()


def phase_kernel_int8():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    rng = np.random.default_rng(1)
    small = []
    bit_equal_diff = 0.0
    for hd in (64, 128):
        for W in (1, 3):
            q, kp, vp, ptab, lens = paged_inputs(
                rng, 4, W, 8, 2, hd, 16, 3, [5, 13, 0, 40], torch.float32,
                zero_rows=(2,))
            kq, ks, vq, vs = int8_pools(kp, vp)
            zero = int(ptab[0, 0])                 # a zero-scale page in use
            for c, sc in ((kq, ks), (vq, vs)):
                c[zero] = 0
                sc[zero] = 0.0
            kw = dict(rep=4, scale=hd ** -0.5)
            for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
                qd = q.to(dtype)
                got = pa.paged_attention(qd, kq, vq, ptab, lens, k_scale=ks,
                                         v_scale=vs, **kw)
                want = pa.paged_attention_plain(qd, kq, vq, ptab, lens,
                                                k_scale=ks, v_scale=vs, **kw)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                case = {"hd": hd, "W": W, "dtype": str(dtype)[6:],
                        "max_abs_err": err, "atol": atol}
                if dtype == torch.float32:
                    one = pa.paged_attention(qd, dequantized(kq, ks),
                                             dequantized(vq, vs), ptab, lens,
                                             **kw)
                    torch.cuda.synchronize()
                    diff = float((got - one).abs().max())
                    case["vs_kernel1_dequantized"] = diff
                    bit_equal_diff = max(bit_equal_diff, diff)
                    if not diff <= atol:
                        raise AssertionError(
                            f"int8 kernel vs kernel 1 over dequantized pools "
                            f"hd={hd} W={W}: {diff} > {atol}")
                small.append(case)
                if not err <= atol:
                    raise AssertionError(f"paged_attention int8 small shape "
                                         f"hd={hd} W={W} {dtype}: err {err} "
                                         f"> {atol}")
    # the context split (P 32 pages of 16, lens across split boundaries, W 1,
    # 2 and 4): against the plain version, and at q f32 against kernel 1
    # over the dequantized pools, which takes the same splits (own seed, so
    # the main shape draws the same lens as before the split)
    split_rng = np.random.default_rng(11)
    for (S_, h_, kvh_), hd, W in itertools.product(
            ((6, 8, 2), (8, 32, 8)), (64, 128), (1, 2, 4)):
        lens_s, n_split_s, pps_s = split_lens(pa, S_, kvh_, 16, 32, W)
        lens_s = (lens_s * 2)[:S_]
        q, kp, vp, ptab, lens = paged_inputs(
            split_rng, S_, W, h_, kvh_, hd, 16, 32, lens_s, torch.float32,
            zero_rows=(1,))
        kq, ks, vq, vs = int8_pools(kp, vp)
        kw = dict(rep=h_ // kvh_, scale=hd ** -0.5)
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            qd = q.to(dtype)
            got = pa.paged_attention(qd, kq, vq, ptab, lens, k_scale=ks,
                                     v_scale=vs, **kw)
            want = pa.paged_attention_plain(qd, kq, vq, ptab, lens,
                                            k_scale=ks, v_scale=vs, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            case = {"S": S_, "kvh": kvh_, "hd": hd, "W": W,
                    "dtype": str(dtype)[6:], "P": 32, "lens": lens_s,
                    "n_split": n_split_s, "pages_per_split": pps_s,
                    "max_abs_err": err, "atol": atol}
            if dtype == torch.float32:
                one = pa.paged_attention(qd, dequantized(kq, ks),
                                         dequantized(vq, vs), ptab, lens,
                                         **kw)
                torch.cuda.synchronize()
                diff = float((got - one).abs().max())
                case["vs_kernel1_dequantized"] = diff
                bit_equal_diff = max(bit_equal_diff, diff)
                if not diff <= atol:
                    raise AssertionError(
                        f"int8 kernel vs kernel 1 over dequantized pools "
                        f"(split case) S={S_} hd={hd} W={W}: {diff} > "
                        f"{atol}")
            small.append(case)
            if not err <= atol:
                raise AssertionError(f"paged_attention int8 split case "
                                     f"S={S_} hd={hd} W={W} {dtype}: err "
                                     f"{err} > {atol}")
    lib = pa._library()
    for ps_, hd_, rows, item in ((64, 128, 4, 1), (16, 64, 12, 1),
                                 (64, 128, 4, 2), (16, 64, 12, 4),
                                 (64, 128, 32, 4), (16, 64, 3, 2)):
        if lib.paged_attention_smem_bytes(item, hd_, ps_, rows) != \
                pa.smem_bytes(ps_, hd_, rows, item):
            raise AssertionError("paged attention: Python and CUDA disagree "
                                 "on shared memory")

    # main-path shape: the serve_int8 decode step (Llama-3-8B, 8 slots)
    S, W, h, kvh, hd, ps, P = 8, 1, 32, 8, 128, 64, 32
    lens = rng.integers(64, 2001, S).tolist()
    q, kp, vp, ptab, lens_t = paged_inputs(rng, S, W, h, kvh, hd, ps, P, lens,
                                           torch.bfloat16)
    kq, ks, vq, vs = int8_pools(kp, vp)
    kw = dict(rep=h // kvh, scale=hd ** -0.5)
    qargs = (q, kq, vq, ptab, lens_t)
    qkw = dict(kw, k_scale=ks, v_scale=vs)
    n_split, pps = pa.split_plan(S, kvh, P, pa._sm_count(q.device))
    got = pa.paged_attention(*qargs, **qkw)
    want = pa.paged_attention_plain(*qargs, **qkw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if not err <= 2e-2:
        raise AssertionError(f"paged_attention int8 main shape: err {err} "
                             "> 2e-2")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernel_ms = median_ms(lambda: pa.paged_attention(*qargs, **qkw),
                          flush=flush)
    kernel1_ms = median_ms(lambda: pa.paged_attention(q, kp, vp, ptab, lens_t,
                                                      **kw), flush=flush)
    plain_ms = median_ms(lambda: pa.paged_attention_plain(*qargs, **qkw),
                         flush=flush)
    wrapper_us = host_us(lambda: pa.paged_attention(*qargs, **qkw))
    # yardstick only, not one library call: dequantize the gathered pages to
    # bf16, then SDPA over the view
    composition_ms = gathered_sdpa_ms(q, kq, vq, ptab, lens_t, kw["scale"],
                                      flush, scales=(ks, vs))
    w4 = paged_w4_case(pa, quant=True, flush=flush)
    del flush
    bytes_, flops, deq_flops = paged_work(lens, W, h, kvh, hd, ps, P,
                                          q.element_size(), 1, scales=True)
    bound_ms, bound_by = paged_bound(bytes_, flops, deq_flops)
    record = {
        "name": "paged_attention_int8", "route": "cuda",
        "source": PAGED_SOURCE,
        "replaces": PAGED_REPLACES + " (quantized)",
        "launches": None, "max_abs_err": err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None,
        "shape": f"S{S} W{W} h{h} kvh{kvh} hd{hd} ps{ps} bf16 q, int8 pools, "
                 f"lens {min(lens)}-{max(lens)}",
        "bytes": bytes_, "flops": flops, "deq_flops": deq_flops, "w4": w4}
    emit({"phase": "kernel_int8", "small": small,
          "max_diff_vs_kernel1_dequantized": bit_equal_diff,
          "bit_equal_vs_kernel1_dequantized": bit_equal_diff == 0.0,
          "main_shape": record["shape"], "n_split": n_split,
          "pages_per_split": pps, "lens": lens, "max_abs_err": err,
          "kernel_ms": kernel_ms, "kernel1_bf16_pools_ms": kernel1_ms,
          "plain_ms": plain_ms, "composition_ms": composition_ms,
          "wrapper_host_us": wrapper_us, "bound_ms": record["bound_ms"],
          "bound_share": record["bound_ms"] / kernel_ms, "w4": w4})
    return record


def flash_inputs(rng, b, sq, sk, h, d, dtype):
    """q, k, v, dO on the card from numpy normals."""
    import numpy as np
    import torch

    shapes = ((b, sq, h, d), (b, sk, h, d), (b, sk, h, d), (b, sq, h, d))
    return [torch.from_numpy(rng.standard_normal(sh, dtype=np.float32))
            .to("cuda", dtype) for sh in shapes]


def flash_check(fa, q, k, v, do, causal):
    """Each kernel against the plain version's forward and its autograd
    backward on the same inputs: max abs error of out, lse, dq, dk, dv.
    The backward kernels get the forward kernel's lse and the delta of the
    kernel's out, as in training."""
    import torch

    scale = q.shape[-1] ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(out, do)
    dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale)
    qr, kr, vr = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out_p, lse_p = fa.flash_attention_plain(qr, kr, vr, causal, scale)
    grads = torch.autograd.grad(out_p, (qr, kr, vr), do)
    torch.cuda.synchronize()

    def err(a, b_):
        return float((a.detach().float() - b_.detach().float()).abs().max())

    return {"out": err(out, out_p), "lse": err(lse, lse_p),
            "dq": err(dq, grads[0]), "dk": err(dk, grads[1]),
            "dv": err(dv, grads[2])}


def flash_work(q, k, causal):
    """Bytes and operations of kernels 2-4 at these shapes (the formula
    lives beside the kernels' wrappers)."""
    from paddlepaddle_tpu_torch.ops.kernels.flash_attention import \
        flash_work as work

    return work(q, k, causal)


def flash_main_shape(fa, rng, dtype, atol, suffix="",
                     shape=(4, 2048, 32, 128), causal=True):
    """Kernels 2-4 at ``shape`` (by default the train phase's: one
    Llama-3-8B layer, b 4, s 2048, 32 heads after the GQA repeat, d 128,
    causal) in ``dtype``: each against the plain version (``atol``), two
    launches of the backward pair to the same bits (one writer per output
    row, no atomics), then CUDA-event times of each kernel, the plain
    versions and SDPA (its backward for the pair; a yardstick the port
    never calls) beside the bound. Returns the kernels-line records (names
    + ``suffix``) and the errors."""
    import torch
    import torch.nn.functional as tF

    b, s, h, d = shape
    q, k, v, do = flash_inputs(rng, b, s, s, h, d, dtype)
    errs = flash_check(fa, q, k, v, do, causal)
    if not max(errs.values()) <= atol:
        raise AssertionError(f"flash kernels main shape {dtype}: {errs} > "
                             f"{atol}")
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    delta = fa.flash_delta(out, do)
    first = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))
    again = (fa.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale),
             *fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal, scale))
    if not all(torch.equal(a, b_) for a, b_ in zip(first, again)):
        raise AssertionError(f"flash backward pair {dtype}: two launches "
                             "differ")
    del first, again
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = {
        "flash_fwd": median_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                               flush=flush),
        "flash_bwd_dq": median_ms(lambda: fa.flash_bwd_dq(
            q, k, v, do, lse, delta, causal, scale), flush=flush),
        "flash_bwd_dkv": median_ms(lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse, delta, causal, scale), flush=flush),
    }
    plain_fwd = median_ms(lambda: fa.flash_attention_plain(q, k, v, causal,
                                                           scale),
                          reps=10, flush=flush)
    # one plain pass computes dq, dk and dv together: it is the plain
    # version of both backward kernels
    plain_bwd = median_ms(lambda: fa.flash_bwd_plain(
        q, k, v, do, lse, delta, causal, scale), reps=10, flush=flush)
    qh, kh, vh, doh = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = median_ms(lambda: tF.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal), flush=flush)
    qg, kg, vg = (x.detach().clone().requires_grad_(True)
                  for x in (qh, kh, vh))
    og = tF.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
    lib_bwd = median_ms(lambda: torch.autograd.grad(
        og, (qg, kg, vg), doh, retain_graph=True), flush=flush)
    del flush
    work = flash_work(q, k, causal)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd}
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    err_of = {"flash_fwd": max(errs["out"], errs["lse"]),
              "flash_bwd_dq": errs["dq"],
              "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    tag = {torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    records = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        bytes_, flops = work[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3      # fp16: the same peak
        records.append({
            "name": name + suffix, "route": "cuda",
            "source": FLASH_FWD_SOURCE if name == "flash_fwd"
            else FLASH_BWD_SOURCE,
            "replaces": FLASH_REPLACES[name], "launches": None,
            "max_abs_err": err_of[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name],
            "shape": f"b{b} s{s} h{h} d{d} {tag} "
                     f"{'causal' if causal else 'full'}",
            "bytes": bytes_, "flops": flops})
    return records, errs


def flash_main_summary(records) -> dict:
    """The timing keys of a flash phase's line, from its records."""
    def by(key):
        return {r["name"]: r[key] for r in records}

    return {"main_shape": records[0]["shape"],
            "bwd_repeat_bit_identical": True, "ms": by("ms"),
            "plain_ms": by("plain_ms"), "library_ms": by("library_ms"),
            "bound_ms": by("bound_ms"),
            "tflops": {r["name"]: r["flops"] / r["ms"] / 1e9
                       for r in records},
            "bound_share": {r["name"]: r["bound_ms"] / r["ms"]
                            for r in records}}


def phase_flash_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(0)
    small = []
    for d in (64, 128):
        for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            for causal in (True, False):
                shapes = ((128, 128), (64, 192), (100, 100))
                if dtype == torch.bfloat16:      # the TMA/wgmma kernels
                    shapes += ((1, 2048), (130, 130), (200, 333), (257, 257))
                for sq, sk in shapes:
                    q, k, v, do = flash_inputs(rng, 2, sq, sk, 3, d, dtype)
                    errs = flash_check(fa, q, k, v, do, causal)
                    small.append({"d": d, "dtype": str(dtype)[6:],
                                  "causal": causal, "sq": sq, "sk": sk,
                                  "atol": atol, **errs})
                    if not max(errs.values()) <= atol:
                        raise AssertionError(
                            f"flash kernels small shape d={d} {dtype} causal="
                            f"{causal} sq={sq} sk={sk}: {errs} > {atol}")

    # what the JAX package computes without a TPU kernel (d outside its gate,
    # causal s_q > s_k) takes the plain version on the card too: it answers
    # (it raised before) within 1e-5 of the CPU, and launches no kernel
    from paddlepaddle_tpu_torch.nn import functional as pF

    routes = []
    before = fa.flash_fwd.launches
    for d, causal, sq, sk in ((96, True, 48, 48), (96, False, 40, 72),
                              (128, True, 64, 32)):
        q, k, v, _ = flash_inputs(rng, 2, sq, sk, 2, d, torch.float32)
        got = pF.flash_attention(q, k, v, causal=causal)[0]
        want = pF.flash_attention(q.cpu(), k.cpu(), v.cpu(),
                                  causal=causal)[0]
        err = float((got.cpu() - want).abs().max())
        routes.append({"d": d, "causal": causal, "sq": sq, "sk": sk,
                       "max_abs_err": err})
        if not err <= 1e-5:
            raise AssertionError(f"plain route on the card d={d} causal="
                                 f"{causal} sq={sq} sk={sk}: err {err}")
    if fa.flash_fwd.launches != before:
        raise AssertionError("a plain route launched the forward kernel")

    records, errs = flash_main_shape(fa, rng, torch.bfloat16, 2e-2)
    emit({"phase": "flash_kernel", "small_cases": len(small),
          "plain_routes": routes,
          "small_max_err": {dt: max(max(c[k] for k in ("out", "lse", "dq",
                                                       "dk", "dv"))
                                    for c in small if c["dtype"] == dt)
                            for dt in ("float32", "bfloat16")},
          "main_errs": errs, "main_atol": 2e-2,
          **flash_main_summary(records)})
    return records


FP16_ATOL = 1e-2    # P and dS rounded to fp16 before their products and the
#                     outputs stored in fp16: 3 mantissa bits finer than
#                     bf16's 2e-2, with the same f32 accumulation


def phase_flash_fp16():
    """Kernels 2-4 in fp16 (the fp16 instantiations of the sm90 forward
    and backward) against the plain forward and its autograd backward on
    the same fp16 inputs: small cases and the train phase's shape, atol
    ``FP16_ATOL``; a loss-scaled dO past fp16's range gives inf in the
    kernels' dV where the plain f32 dV passes 65504 (no clamp: it is what
    GradScaler reads); two launches of the backward pair give the same
    bits; timings of each kernel, the plain versions and SDPA in fp16 (its
    backward for the pair), beside the bound (the same operations as bf16
    at 989 TFLOP/s)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(1)
    small = []
    for d in (64, 128):
        for causal in (True, False):
            for sq, sk in ((128, 128), (64, 192), (100, 100), (1, 2048),
                           (130, 130), (200, 333), (257, 257)):
                q, k, v, do = flash_inputs(rng, 2, sq, sk, 3, d,
                                           torch.float16)
                errs = flash_check(fa, q, k, v, do, causal)
                small.append({"d": d, "causal": causal, "sq": sq, "sk": sk,
                              **errs})
                if not max(errs.values()) <= FP16_ATOL:
                    raise AssertionError(
                        f"fp16 flash kernels small shape d={d} causal="
                        f"{causal} sq={sq} sk={sk}: {errs} > {FP16_ATOL}")
    # loss-scaled dO: the kernel keeps fp16's inf where the value passes
    # its range, and stays finite where it does not
    q, k, v, do = flash_inputs(rng, 1, 256, 256, 2, 128, torch.float16)
    do = (do.float() * 3e4).half()
    scale = 128 ** -0.5
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.flash_delta(out, do)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale)
    p_out, p_lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                            True, scale)
    want_dv = fa.flash_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                 p_lse, fa.flash_delta(p_out, do.float()),
                                 True, scale)[2]
    torch.cuda.synchronize()
    big, tame = want_dv.abs() > 7.0e4, want_dv.abs() < 6.0e4
    overflow = {"inf_where_past_range": bool(torch.isinf(dv[big]).all()),
                "finite_elsewhere": bool(torch.isfinite(dv[tame]).all()),
                "past_range": int(big.sum())}
    if not (overflow["past_range"] > 0 and overflow["inf_where_past_range"]
            and overflow["finite_elsewhere"]):
        raise AssertionError(f"fp16 overflow not kept as inf: {overflow}")

    records, errs = flash_main_shape(fa, rng, torch.float16, FP16_ATOL,
                                     suffix="_fp16")
    emit({"phase": "flash_fp16", "small_cases": len(small),
          "small_max_err": max(max(c[k] for k in ("out", "lse", "dq", "dk",
                                                  "dv")) for c in small),
          "atol": FP16_ATOL, "overflow": overflow, "main_errs": errs,
          **flash_main_summary(records)})
    return records


# packed varlen attention (kernels 5-7): small layouts as (lens_q, lens_k or
# None for lens_q, t_q, t_k); t past a sum is a padding tail
VARLEN_SMALL = {
    "pad_empty": ([0, 5, 9, 0, 3, 20, 0], None, 48, 48),
    "prefill": ([4, 6, 8, 3], [11, 6, 20, 9], 24, 48),
    "qlong": ([0, 12, 5, 6], [0, 5, 0, 9], 24, 16),
    "ones": ([1] * 64, None, 67, 67),
    "mixed": ([3, 40, 7, 0, 5, 9, 100], [3, 40, 7, 2, 5, 9, 100], 171, 173),
    "multi": ([700, 0, 129], [900, 64, 129], 837, 1101),
    # only 128-row tiles reach these: a tile over three segments and a
    # segment longer than 3 stages of 128 keys; len_k > len_q over several
    # key tiles with t_q % 4 != 0
    "tile128": ([100, 156, 1, 300, 0, 211], None, 800, 800),
    "prefill128": ([130, 7, 260], [900, 7, 700], 397, 1607),
    # the bf16 dQ's first 64-row consumer over three segments, whose keys
    # start inside a 64-key tile
    "consumer3": ([10, 20, 40, 90], [37, 20, 70, 90], 170, 230),
}


def varlen_cu(lens):
    import numpy as np

    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def varlen_pairs(cu_q, cu_k, causal: bool) -> int:
    """Visible (query, key) pairs of one head (the formula lives beside the
    varlen kernels' wrappers)."""
    from paddlepaddle_tpu_torch.ops.kernels.flash_varlen import \
        varlen_pairs as pairs

    return pairs(cu_q, cu_k, causal)


def varlen_tiles(fv, cq, ck, tq, tk, causal, bm=128, bn=128):
    """Key tiles of ``bn`` a CTA of ``bm`` query rows must stream to cover
    its rows' visible keys (from its first visible key to its last), summed
    over the CTAs, beside the tiles a loop over all of t_k takes."""
    import torch
    import torch.nn.functional as tF

    mask = fv.varlen_mask(cq, ck, tq, tk, causal)
    cols = torch.arange(tk, device=mask.device)
    first = torch.where(mask, cols, tk).min(1).values
    last = torch.where(mask, cols + 1, 0).max(1).values
    pad = (-tq) % bm
    first = tF.pad(first, (0, pad), value=tk).view(-1, bm).min(1).values
    last = tF.pad(last, (0, pad), value=0).view(-1, bm).max(1).values
    visited = int(((last - first).clamp(min=0) + bn - 1).div(
        bn, rounding_mode="floor").sum())
    return {"visited": visited,
            "all_of_t": -(-tq // bm) * -(-tk // bn)}


def varlen_launches():
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    return {"varlen_fwd": fv.varlen_fwd.launches,
            "varlen_bwd_dq": fv.varlen_bwd_dq.launches,
            "varlen_bwd_dkv": fv.varlen_bwd_dkv.launches}


def reset_varlen_launches() -> None:
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    fv.varlen_fwd.launches = 0
    fv.varlen_bwd_dq.launches = 0
    fv.varlen_bwd_dkv.launches = 0


def varlen_reference(fv, q, k, v, do, cq, ck, causal, got):
    """The plain versions on the same inputs as the kernels: the forward on
    q, k, v; the backward on the kernels' own lse and the delta of their
    out, as the backward kernels get them. Heads go in chunks."""
    scale = q.shape[-1] ** -0.5
    out, lse = fv.varlen_attention_plain(q, k, v, cq, ck, causal, scale)
    delta = fv.varlen_delta(got["out"], do)
    dq, dk, dv = fv.varlen_bwd_plain(q, k, v, do, got["lse"], delta, cq, ck,
                                     causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def varlen_compare(fv, got, want, cq, ck, causal, atol, rtol=0.0):
    """Max abs error of each tensor (lse on rows that see a key) and the
    excess over ``atol + rtol * |want|``; raises unless rows that see no
    key have out and dq exactly 0 and lse -1e30, and keys no row sees have
    dk and dv exactly 0."""
    tq, tk = got["out"].shape[0], got["dk"].shape[0]
    mask = fv.varlen_mask(cq, ck, tq, tk, causal)
    row_ok, key_ok = mask.any(1), mask.any(0)
    errs, excess = {}, {}
    for name in ("out", "lse", "dq", "dk", "dv"):
        a, b_ = got[name].detach().float(), want[name].detach().float()
        if name == "lse":
            a, b_ = a[:, row_ok], b_[:, row_ok]
        diff = (a - b_).abs()
        errs[name] = float(diff.max()) if diff.numel() else 0.0
        excess[name] = (float((diff - atol - rtol * b_.abs()).max())
                        if diff.numel() else -atol)
    zero = (bool((got["out"][~row_ok] == 0).all())
            and bool((got["dq"][~row_ok] == 0).all())
            and bool((got["lse"][:, ~row_ok] == -1e30).all())
            and bool((got["dk"][~key_ok] == 0).all())
            and bool((got["dv"][~key_ok] == 0).all()))
    if not zero:
        raise AssertionError("varlen kernels: a row without a key or a key "
                             "without a row is not exactly 0")
    return errs, excess, int((~row_ok).sum()), int((~key_ok).sum())


def varlen_kernels(fv, q, k, v, do, cq, ck, causal):
    scale = q.shape[-1] ** -0.5
    out, lse = fv.varlen_fwd(q, k, v, cq, ck, causal, scale)
    delta = fv.varlen_delta(out, do)
    dq = fv.varlen_bwd_dq(q, k, v, do, lse, delta, cq, ck, causal, scale)
    dk, dv = fv.varlen_bwd_dkv(q, k, v, do, lse, delta, cq, ck, causal, scale)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


def packed_batch(rng, total, lo, hi):
    """Segment lengths drawn from [lo, hi] until they sum to ``total`` (the
    last one cut to fit)."""
    lens = []
    while sum(lens) < total:
        lens.append(int(min(rng.integers(lo, hi + 1), total - sum(lens))))
    return lens


def varlen_library_call(q, k, v, do, cu, causal):
    """One PyTorch call computing the same function, for timing only:
    SDPA over ``torch.nested`` jagged tensors of the non-empty segments if
    this torch takes them (causal, forward and backward), else SDPA with the
    block-diagonal (and causal) boolean mask over the valid tokens. Returns
    (name, forward giving out [valid, h, d], backward of one output)."""
    import numpy as np
    import torch
    import torch.nn.functional as tF

    n = int(cu[-1])
    leaves = [x[:n].detach().clone().requires_grad_(True) for x in (q, k, v)]
    do = do[:n]

    def backward(out):
        return torch.autograd.grad(out, leaves, do, retain_graph=True)

    offs = torch.tensor(sorted(set(cu.tolist())), dtype=torch.int64,
                        device=q.device)
    try:
        nts = [torch.nested.nested_tensor_from_jagged(x, offs).transpose(1, 2)
               for x in leaves]

        def njt():
            o = tF.scaled_dot_product_attention(*nts, is_causal=causal)
            return o.transpose(1, 2).values()

        backward(njt())
        return "sdpa_nested_jagged", njt, backward
    except (RuntimeError, NotImplementedError, ValueError, TypeError):
        pass
    seg = torch.repeat_interleave(
        torch.arange(len(cu) - 1, device=q.device),
        torch.from_numpy(np.diff(cu)).to(q.device))
    mask = seg[:, None] == seg[None, :]
    if causal:
        mask &= torch.ones(n, n, dtype=torch.bool, device=q.device).tril()
    qh, kh, vh = (x.transpose(0, 1).unsqueeze(0) for x in leaves)

    def masked():
        o = tF.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)
        return o[0].transpose(0, 1)

    return "sdpa_block_diagonal_mask", masked, backward


def phase_flash_varlen_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.incubate.nn import functional as incF
    from paddlepaddle_tpu_torch.nn import functional as F
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import flash_varlen as fv

    rng = np.random.default_rng(0)
    dev = "cuda"

    def normals(*shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(dev, dtype)

    # small cases: every layout, d 64 / 128, f32 / bf16, causal and full
    small = []
    for name, (lens_q, lens_k, tq, tk) in VARLEN_SMALL.items():
        cu_q = varlen_cu(lens_q)
        cu_k = cu_q if lens_k is None else varlen_cu(lens_k)
        cq, ck = (torch.from_numpy(c).to(dev) for c in (cu_q, cu_k))
        for d in (64, 128):
            # bf16 adds 1e-2 relative: gradients reach |x| >= 4 (a causal
            # segment's first keys sum dO over ~100 rows), where one bf16
            # ulp (2^-7 relative at the bottom of a binade) is 0.031
            for dtype, atol, rtol in ((torch.float32, 1e-5, 0.0),
                                      (torch.bfloat16, 2e-2, 1e-2)):
                for causal in (True, False):
                    q, do = (normals(tq, 3, d, dtype=dtype) for _ in range(2))
                    k, v = (normals(tk, 3, d, dtype=dtype) for _ in range(2))
                    got = varlen_kernels(fv, q, k, v, do, cq, ck, causal)
                    want = varlen_reference(fv, q, k, v, do, cq, ck, causal,
                                            got)
                    torch.cuda.synchronize()
                    errs, excess, dead_rows, dead_keys = varlen_compare(
                        fv, got, want, cq, ck, causal, atol, rtol)
                    small.append({"layout": name, "d": d,
                                  "dtype": str(dtype)[6:], "causal": causal,
                                  "atol": atol, "rtol": rtol,
                                  "rows_without_key": dead_rows,
                                  "keys_without_row": dead_keys, **errs})
                    if max(excess.values()) > 0:
                        raise AssertionError(
                            f"varlen kernels small case {name} d={d} {dtype} "
                            f"causal={causal}: {errs} beyond atol {atol} + "
                            f"rtol {rtol}")

    # one segment over the whole buffer is dense attention at [1, s, h, d]
    cross, cross_dq = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            s, h, d = 1000, 4, 128
            q, k, v, do = (normals(s, h, d, dtype=dtype) for _ in range(4))
            cu = torch.tensor([0, s], dtype=torch.int32, device=dev)
            got = varlen_kernels(fv, q, k, v, do, cu, cu, causal)
            b4 = [x.unsqueeze(0) for x in (q, k, v, do)]
            out, lse = fa.flash_fwd(*b4[:3], causal, d ** -0.5)
            delta = fa.flash_delta(out, b4[3])
            dq = fa.flash_bwd_dq(*b4, lse, delta, causal, d ** -0.5)
            dk, dv = fa.flash_bwd_dkv(*b4, lse, delta, causal, d ** -0.5)
            dense = {"out": out[0], "lse": lse, "dq": dq[0], "dk": dk[0],
                     "dv": dv[0]}
            torch.cuda.synchronize()
            key = f"{str(dtype)[6:]}_{'causal' if causal else 'full'}"
            diffs = {n: float((got[n].float() - dense[n].float()).abs()
                              .max()) for n in dense}
            cross[key], cross_dq[key] = max(diffs.values()), diffs["dq"]
            tol = 1e-5 if dtype == torch.float32 else 2e-2
            if not cross[key] <= tol:
                raise AssertionError(f"varlen vs dense kernels {key}: "
                                     f"{cross[key]} > {tol}")

    # the main path at full width: Llama-3-8B attention (h 32, d 128, bf16)
    # through the public entry points, counters from 0
    h, d = 32, 128
    bf = torch.bfloat16
    lens_a = packed_batch(np.random.default_rng(0), 8192, 64, 2048)
    lens_a.insert(len(lens_a) // 2, 0)               # one empty segment
    cu_a = varlen_cu(lens_a)
    t_a = int(cu_a[-1]) + 64                          # 64-row padding tail
    qa, ka, va = (normals(t_a, h, d, dtype=bf) for _ in range(3))
    proj_a = normals(t_a, h, d, dtype=torch.float32)
    ctx_b = [int(x) for x in rng.integers(512, 4097, 8)]
    cu_bq = varlen_cu([256] * 8)
    cu_bk = varlen_cu(ctx_b)
    qb = normals(int(cu_bq[-1]), h, d, dtype=bf)
    kb, vb = (normals(int(cu_bk[-1]), h, d, dtype=bf) for _ in range(2))
    proj_b = normals(int(cu_bq[-1]), h, d, dtype=torch.float32)
    b_c, s_c = 8, 2048
    lens_c = np.array([int(x) for x in rng.integers(64, 2049, b_c)])
    qc, kc, vc = (normals(b_c, h, s_c, d, dtype=bf) for _ in range(3))
    leaves_a = [x.clone().requires_grad_(True) for x in (qa, ka, va)]
    leaves_b = [x.clone().requires_grad_(True) for x in (qb, kb, vb)]
    torch.cuda.synchronize()

    reset_varlen_launches()
    t0 = time.perf_counter()
    out_a, _ = F.flash_attn_unpadded(*leaves_a, cu_a, cu_a, causal=True)
    (out_a.float() * proj_a).sum().backward()
    after_a = varlen_launches()
    out_b, _ = F.flash_attn_unpadded(*leaves_b, cu_bq, cu_bk, causal=True)
    (out_b.float() * proj_b).sum().backward()
    out_c = incF.variable_length_memory_efficient_attention(
        qc, kc, vc, lens_c, lens_c)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = varlen_launches()
    if after_a != {"varlen_fwd": 1, "varlen_bwd_dq": 1, "varlen_bwd_dkv": 1}:
        raise AssertionError(f"(a) moved the varlen counters by {after_a}, "
                             "expected 1 each")
    if launches != {"varlen_fwd": 3, "varlen_bwd_dq": 2, "varlen_bwd_dkv": 2}:
        raise AssertionError(f"varlen main path launched {launches}")

    full_atol, full_rtol = 2e-2, 1e-2
    checks = {}
    for key, leaves, out, proj, cq_np, ck_np in (
            ("a_packed", leaves_a, out_a, proj_a, cu_a, cu_a),
            ("b_prefill", leaves_b, out_b, proj_b, cu_bq, cu_bk)):
        cq, ck = (torch.from_numpy(c).to(dev) for c in (cq_np, ck_np))
        do = proj.to(bf)
        q, k, v = (x.detach() for x in leaves)
        # the lse the public path's backward used (the forward kernel is
        # deterministic)
        lse = fv.varlen_fwd(q, k, v, cq, ck, True, d ** -0.5)[1]
        got = {"out": out.detach(), "lse": lse, "dq": leaves[0].grad,
               "dk": leaves[1].grad, "dv": leaves[2].grad}
        want = varlen_reference(fv, q, k, v, do, cq, ck, True, got)
        errs, excess, dead_rows, dead_keys = varlen_compare(
            fv, got, want, cq, ck, True, full_atol, full_rtol)
        checks[key] = {"errs": errs, "rows_without_key": dead_rows,
                       "keys_without_row": dead_keys,
                       "max_abs_grad": max(float(want[n].float().abs().max())
                                           for n in ("dq", "dk", "dv"))}
        del want
        if max(excess.values()) > 0:
            raise AssertionError(f"varlen full width {key}: {errs} beyond "
                                 f"atol {full_atol} + rtol {full_rtol}")
    # (a) in f32: the kernels' masking and tiling at full width, free of
    # the bf16 rounding of p and ds that the bf16 check above allows for
    cq = torch.from_numpy(cu_a).to(dev)
    q32, k32, v32 = (x.detach().float() for x in leaves_a)
    do32 = proj_a
    got = varlen_kernels(fv, q32, k32, v32, do32, cq, cq, True)
    want = varlen_reference(fv, q32, k32, v32, do32, cq, cq, True, got)
    errs, excess, _, _ = varlen_compare(fv, got, want, cq, cq, True, 1e-5)
    checks["a_packed_f32"] = {"errs": errs}
    del got, want, q32, k32, v32
    if max(excess.values()) > 0:
        raise AssertionError(f"varlen full width a_packed in f32: {errs} > "
                             "1e-5")
    # (c): the padded batch against the plain forward of each sequence
    err_c = 0.0
    for i in range(b_c):
        n = int(lens_c[i])
        cu = torch.tensor([0, n], dtype=torch.int32, device=dev)
        ref, _ = fv.varlen_attention_plain(
            *(x[i, :, :n].transpose(0, 1) for x in (qc, kc, vc)), cu, cu,
            False, d ** -0.5)
        err_c = max(err_c, float((out_c[i, :, :n].transpose(0, 1).float()
                                  - ref.float()).abs().max()))
        if not bool((out_c[i, :, n:] == 0).all()):
            raise AssertionError("incubate varlen: rows past a length not 0")
    checks["c_incubate"] = {"out": err_c}
    if not err_c <= full_atol:
        raise AssertionError(f"incubate varlen at full width: {err_c}")
    del out_b, leaves_b, qc, kc, vc, out_c

    # timings at (a): the kernels on their own inputs, L2 flushed
    cq = torch.from_numpy(cu_a).to(dev)
    do_a = proj_a.to(bf)
    scale = d ** -0.5
    out, lse = fv.varlen_fwd(qa, ka, va, cq, cq, True, scale)
    delta = fv.varlen_delta(out, do_a)
    # one writer per output row, no atomics: two launches of dQ, and two of
    # dK/dV, give the same bits
    first = fv.varlen_bwd_dq(qa, ka, va, do_a, lse, delta, cq, cq, True,
                             scale)
    again = fv.varlen_bwd_dq(qa, ka, va, do_a, lse, delta, cq, cq, True,
                             scale)
    dq_repeat_equal = torch.equal(first, again)
    first = fv.varlen_bwd_dkv(qa, ka, va, do_a, lse, delta, cq, cq, True,
                              scale)
    again = fv.varlen_bwd_dkv(qa, ka, va, do_a, lse, delta, cq, cq, True,
                              scale)
    dkv_repeat_equal = all(torch.equal(a, b_) for a, b_ in zip(first, again))
    del first, again
    if not dq_repeat_equal:
        raise AssertionError("varlen dQ: two launches differ")
    if not dkv_repeat_equal:
        raise AssertionError("varlen dK/dV: two launches differ")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = {
        "varlen_fwd": median_ms(lambda: fv.varlen_fwd(
            qa, ka, va, cq, cq, True, scale), flush=flush),
        "varlen_bwd_dq": median_ms(lambda: fv.varlen_bwd_dq(
            qa, ka, va, do_a, lse, delta, cq, cq, True, scale), flush=flush),
        "varlen_bwd_dkv": median_ms(lambda: fv.varlen_bwd_dkv(
            qa, ka, va, do_a, lse, delta, cq, cq, True, scale), flush=flush),
    }
    plain_fwd = median_ms(lambda: fv.varlen_attention_plain(
        qa, ka, va, cq, cq, True, scale), reps=5, warmup=1, flush=flush)
    # one plain pass computes dq, dk and dv together: it is the plain
    # version of both backward kernels
    plain_bwd = median_ms(lambda: fv.varlen_bwd_plain(
        qa, ka, va, do_a, lse, delta, cq, cq, True, scale), reps=5, warmup=1,
        flush=flush)
    lib_name, lib_fn, lib_bwd_fn = varlen_library_call(qa, ka, va, do_a,
                                                       cu_a, True)
    n_valid = int(cu_a[-1])
    lib_out = lib_fn()
    lib_err = float((lib_out.detach().float() - out[:n_valid].float()).abs()
                    .max())
    lib_fwd = median_ms(lib_fn, flush=flush)
    lib_bwd = median_ms(lambda: lib_bwd_fn(lib_out), flush=flush)
    del flush

    pairs = varlen_pairs(cu_a, cu_a, True) * h
    tiles = varlen_tiles(fv, cq, cq, t_a, t_a, True)
    item = 2
    t_q = t_a * h * d * item
    rows = 4 * h * t_a
    work = {"varlen_fwd": (4 * t_q + rows, 4 * d * pairs),
            "varlen_bwd_dq": (5 * t_q + 2 * rows, 6 * d * pairs),
            "varlen_bwd_dkv": (6 * t_q + 2 * rows, 8 * d * pairs)}
    plain = {"varlen_fwd": plain_fwd, "varlen_bwd_dq": plain_bwd,
             "varlen_bwd_dkv": plain_bwd}
    library = {"varlen_fwd": lib_fwd, "varlen_bwd_dq": lib_bwd,
               "varlen_bwd_dkv": lib_bwd}
    errs_a = checks["a_packed"]["errs"]
    err_of = {"varlen_fwd": max(errs_a["out"], errs_a["lse"]),
              "varlen_bwd_dq": errs_a["dq"],
              "varlen_bwd_dkv": max(errs_a["dk"], errs_a["dv"])}
    shape = (f"t {t_a} ({len(lens_a)} segments, one empty, 64-row tail) "
             f"h{h} d{d} bf16 causal")
    records = []
    for name in ("varlen_fwd", "varlen_bwd_dq", "varlen_bwd_dkv"):
        bytes_, flops = work[name]
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        records.append({
            "name": name, "route": "cuda", "source": VARLEN_SOURCES[name],
            "replaces": VARLEN_REPLACES[name], "launches": launches[name],
            "max_abs_err": err_of[name], "ms": ms[name],
            "plain_ms": plain[name], "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name], "library": lib_name,
            "shape": shape, "bytes": bytes_, "flops": flops})
    emit({"phase": "flash_varlen_kernel", "small_cases": len(small),
          "small_max_err": {dt: max(max(c[k] for k in ("out", "lse", "dq",
                                                       "dk", "dv"))
                                    for c in small if c["dtype"] == dt)
                            for dt in ("float32", "bfloat16")},
          "dense_cross_check_max_diff": cross,
          "dense_cross_check_dq": cross_dq,
          "segments_a": lens_a, "contexts_b": ctx_b,
          "seq_lens_c": lens_c.tolist(), "main_path_s": main_s,
          "launches": launches, "full_width": checks,
          "full_atol": full_atol, "full_rtol": full_rtol,
          "visible_pairs_a": pairs, "fwd_tiles_a": tiles,
          "dq_repeat_bit_identical": dq_repeat_equal,
          "dkv_repeat_bit_identical": dkv_repeat_equal,
          "ptxas": {k: v for src in ("flash_varlen_sm90", "flash_varlen")
                    for k, v in ptxas_kernels(str(_build.build_log.get(
                        src, {}).get("ptxas", ""))).items()},
          "ms": ms, "plain_ms": plain, "library": lib_name,
          "library_ms": library, "library_max_diff": lib_err,
          "bound_ms": {r["name"]: r["bound_ms"] for r in records},
          "tflops": {r["name"]: r["flops"] / r["ms"] / 1e9 for r in records},
          "bound_share": {r["name"]: r["bound_ms"] / r["ms"]
                          for r in records}})
    return records


def gather_gemm_inputs(rng, T, E, d, h, dtype):
    """x, wg, wu, wd on the card from numpy normals, scaled so that every
    product is of order 1."""
    import numpy as np
    import torch

    x = rng.standard_normal((T, d), dtype=np.float32)
    banks = [rng.standard_normal(sh, dtype=np.float32) / np.sqrt(sh[1])
             for sh in ((E, d, h), (E, d, h), (E, h, d))]
    return [torch.from_numpy(a).to("cuda", dtype) for a in [x] + banks]


def planted_slots(rng, T, E, C, empty=None):
    """Token rows per slot from the port's capacity routing (top-2) of
    planted logits: expert 0 is first for half the tokens (drops when
    T > C), expert ``empty`` is never chosen (all its slots sentinels)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    lg = np.argsort(rng.random((T, E)), axis=1).astype(np.float32)
    lg += rng.uniform(0, 0.1, (T, E)).astype(np.float32)
    lg[: (T + 1) // 2, 0] = E + 1.0
    if empty is not None:
        lg[:, empty] = -10.0
    _, _, _, valid, entry = tmoe._capacity_slot_maps(
        torch.from_numpy(lg).cuda(), 2, E, C, T)
    return torch.where(valid, entry % T, T).to(torch.int32)


def gather_gemm_check(gg, x, slot, wg, wu, wd, C):
    """Each phase against its plain half on the same inputs and the call
    against gather_gemm_ffn_plain: {name: (max abs error, max error /
    allowed)}, allowed 1e-5 in f32; in bf16 each phase's bound (one bf16
    step and its f32 summation-order slack) and the call's derived bound. Every sentinel slot's rows must be zero."""
    import torch

    T = x.shape[0]
    E, _, h = wg.shape
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    hmid_want = gg.gather_gateup_plain(x, slot, wg, wu, capacity=C)
    down = gg.expert_down(hmid_want, slot, wd, n_tokens=T)
    down_want = gg.expert_down_plain(hmid_want, slot, wd, n_tokens=T)
    got = gg.gather_gemm_ffn(x, slot, wg, wu, wd, capacity=C)
    want = gg.gather_gemm_ffn_plain(x, slot, wg, wu, wd, capacity=C)
    torch.cuda.synchronize()
    out = {}
    for name, a, b in (("gather_gateup", hmid, hmid_want),
                       ("expert_down", down, down_want),
                       ("call", got, want)):
        err = (a.float() - b.float()).abs()
        if x.dtype == torch.float32:
            allowed = torch.full_like(err, 1e-5)
        elif name == "call":
            allowed = gg.bf16_error_bound(x, slot, wg, wu, wd, capacity=C,
                                          plain=b)
        elif name == "gather_gateup":
            allowed = gg.gather_gateup_bf16_bound(x, slot, wg, wu,
                                                  capacity=C, plain=b)
        else:
            allowed = gg.expert_down_bf16_bound(hmid_want, wd, plain=b)
        out[name] = (float(err.max()), float((err / allowed).max()))
        del err, allowed
    dead = (slot < 0) | (slot >= T)
    if bool(hmid.reshape(E * C, h)[dead].any()) or bool(down[dead].any()) \
            or bool(got[dead].any()):
        raise AssertionError("gather-GEMM: a sentinel slot's row is not zero")
    return out


MOE_E, MOE_C, MOE_T, MOE_D, MOE_H = 64, 320, 8192, 2048, 1408
# Mixtral-8x7B's expert widths (public config of mistralai/Mixtral-8x7B-v0.1:
# hidden 4096, intermediate 14336, 8 experts, top-2) at T 2048 and capacity
# factor 1.25: C = 2048 * 2 / 8 * 1.25 = 640
MIXTRAL_E, MIXTRAL_C, MIXTRAL_T, MIXTRAL_D, MIXTRAL_H = 8, 640, 2048, 4096, \
    14336


def gather_gemm_full_case(gg, tmoe, T, E, C, d, h, seed, plain_reps=10,
                          local=None):
    """One bf16 case at full width: slots from a routing of random x through
    a random gate (N(0, 0.02), as the model's init), both phases and the
    call checked, then CUDA-event medians (L2 flushed) of each phase, the
    call, the plain version and the sorted mode's composition, beside the
    bounds of this run's work. ``local``: the banks of one expert-parallel
    rank, experts ``0..local-1`` of the ``E`` the routing chose from (the
    slots of the other experts are not this rank's)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    E_b = local or E
    x = torch.randn(T, d, device="cuda", generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(E_b, d, h, device="cuda", generator=gen)
              .mul_(0.02).to(torch.bfloat16) for _ in range(2))
    wd = torch.randn(E_b, h, d, device="cuda", generator=gen).mul_(0.02) \
        .to(torch.bfloat16)
    gate_w = torch.randn(d, E, device="cuda", generator=gen).mul_(0.02)
    if local is None:
        _, _, _, valid, entry = tmoe._capacity_slot_maps(
            x.float() @ gate_w, 2, E, C, T)
        slot = torch.where(valid, entry % T, T).to(torch.int32)
    else:
        _, _, _, valid, entry = tmoe._local_capacity_maps(
            x.float() @ gate_w, 2, E, C, 0, T, 0, local)
        slot = entry.to(torch.int32)
    E = E_b
    checks = gather_gemm_check(gg, x, slot, wg, wu, wd, C)
    bad = {k: v for k, v in checks.items() if not v[1] <= 1.0}
    if bad:
        raise AssertionError(f"gather-GEMM T{T} E{E} C{C} d{d} h{h}: {bad}")
    hmid = gg.gather_gateup(x, slot, wg, wu, capacity=C)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = {
        "gather_gateup": median_ms(lambda: gg.gather_gateup(
            x, slot, wg, wu, capacity=C), flush=flush),
        "expert_down": median_ms(lambda: gg.expert_down(
            hmid, slot, wd, n_tokens=T), flush=flush),
        "call": median_ms(lambda: gg.gather_gemm_ffn(
            x, slot, wg, wu, wd, capacity=C), flush=flush),
        "plain": median_ms(lambda: gg.gather_gemm_ffn_plain(
            x, slot, wg, wu, wd, capacity=C), reps=plain_reps,
            warmup=1, flush=flush),
        # the sorted mode's composition (index gather, two bmm, silu*mul,
        # bmm): a yardstick, not one library call
        "composition": median_ms(lambda: tmoe._reference_expert_ffn(
            x, entry, valid, wg, wu, wd), flush=flush)}
    wrapper_us = host_us(lambda: gg.gather_gemm_ffn(
        x, slot, wg, wu, wd, capacity=C), reps=50)
    del flush
    # least time for this run's work (gg.gather_gemm_work): every weight
    # read once, each token row a filled slot reads read once, the slot
    # indices read once, each output written once; the products of the
    # filled slots only
    work = gg.gather_gemm_work(slot, T, E, C, d, h, x.element_size())
    bounds = {}
    for name, (bytes_, flops) in work.items():
        t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
        t_ops = flops / BF16_FLOP_PER_S * 1e3
        bounds[name] = {"bytes": bytes_, "flops": flops,
                        "bound_ms_bytes": t_bytes,
                        "bound_ms_operations": t_ops,
                        "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes >= t_ops
                        else "operations",
                        "bound_share": max(t_bytes, t_ops) / ms[name],
                        "tflops": flops / ms[name] / 1e9}
    return {"shape": f"T{T} E{E}{'' if local is None else ' local'} "
                     f"C{C} d{d} h{h} bf16",
            "filled_slots": int(valid.sum()),
            "rows_read": int(torch.unique(slot[valid]).numel()),
            "checks": {k: {"max_abs_err": v[0], "err_over_allowed": v[1]}
                       for k, v in checks.items()},
            "ms": ms, "bounds": bounds, "wrapper_host_us": wrapper_us,
            "call_over_composition": ms["call"] / ms["composition"]}


def phase_gather_gemm_kernel():
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    rng = np.random.default_rng(0)
    small = []
    # (T, E, C, d, h, empty): C 40 and 37 are not multiples of the row
    # tile (128 slots bf16, 32 f32) and leave a 64-slot half of sentinels,
    # expert 3 is empty (all its tiles sentinels) and expert 0 overflows;
    # (128, 128) is the smallest (d, h) admitted
    for T, E, C, d, h, empty in ((48, 4, 40, 128, 128, 3),
                                 (300, 6, 37, 256, 384, None),
                                 (1, 2, 4, 128, 256, None)):
        for dtype in (torch.float32, torch.bfloat16):
            x, wg, wu, wd = gather_gemm_inputs(rng, T, E, d, h, dtype)
            slot = planted_slots(rng, T, E, C, empty).cuda()
            checks = gather_gemm_check(gg, x, slot, wg, wu, wd, C)
            small.append({"T": T, "E": E, "C": C, "d": d, "h": h,
                          "dtype": str(dtype)[6:],
                          "max_abs_err": max(v[0] for v in checks.values()),
                          "err_over_allowed": max(v[1]
                                                  for v in checks.values())})
            if not small[-1]["err_over_allowed"] <= 1.0:
                raise AssertionError(f"gather-GEMM small case {small[-1]}: "
                                     f"{checks}")
    plan = {}
    for dtype in (torch.bfloat16, torch.float32):
        for phase in gg.PHASES:
            want = gg.smem_bytes(phase, dtype)
            got = gg.kernel_smem_bytes(phase, dtype)
            plan[f"{phase} {str(dtype)[6:]}"] = got
            if got != want:
                raise AssertionError(f"gather-GEMM: Python ({want}) and CUDA "
                                     f"({got}) disagree on the shared memory "
                                     f"of {phase} in {dtype}")

    main = gather_gemm_full_case(gg, tmoe, MOE_T, MOE_E, MOE_C, MOE_D, MOE_H,
                                 seed=0)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral = gather_gemm_full_case(gg, tmoe, MIXTRAL_T, MIXTRAL_E,
                                    MIXTRAL_C, MIXTRAL_D, MIXTRAL_H, seed=1,
                                    plain_reps=3)
    gc.collect()
    torch.cuda.empty_cache()
    call = main["bounds"]["call"]
    record = {
        "name": "gather_gemm_ffn", "route": "cuda",
        "source": GATHER_GEMM_SOURCE, "replaces": GATHER_GEMM_REPLACES,
        "launches": None,
        "max_abs_err": main["checks"]["call"]["max_abs_err"],
        "ms": main["ms"]["call"], "plain_ms": main["ms"]["plain"],
        "bound_ms": call["bound_ms"], "bound_by": call["bound_by"],
        "library_ms": None, "shape": main["shape"],
        "bytes": call["bytes"], "flops": call["flops"],
        "note": "launches counts calls; each call is two launches "
                "(gather_gateup_sm90, expert_down_sm90)",
        "phase_ms": {k: main["ms"][k]
                     for k in ("gather_gateup", "expert_down")},
        "composition_ms": main["ms"]["composition"]}
    emit({"phase": "gather_gemm_kernel", "small": small, "smem_plan": plan,
          "main": main, "mixtral": mixtral})
    return record


def phase_engine_parity(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1,
                                        init_std=0.1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    specs = [(5, 8, None), (17, 4, None), (3, 10, 7), (40, 6, None)]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n, _, _ in specs]
    outs = {}
    launches0 = pa.paged_attention.launches
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = pt_pkg.BatchDecodeEngine(model, max_slots=3, chunk=4,
                                       page_size=16, device=dev)
        reqs = [pt_pkg.GenerationRequest(p, mx, 0.0, 0, e)
                for p, (_, mx, e) in zip(prompts, specs)]
        eng.serve(reqs, timeout=300)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
    launches = pa.paged_attention.launches - launches0
    equal = outs["cuda"] == outs["cpu"]
    emit({"phase": "engine_parity", "equal": equal, "kernel_launches": launches,
          "tokens": sum(len(o) for o in outs["cuda"])})
    if not equal:
        raise AssertionError(f"card vs CPU greedy tokens differ: "
                             f"{outs['cuda']} vs {outs['cpu']}")
    if launches == 0:
        raise AssertionError("card engine never launched the kernel")


def phase_engine_parity_int8(pt_pkg):
    """A tiny fp32 Llama serving int8 KV with prefix requests on one slot
    and a pool of 5 usable pages (page 16): two 32-token prefixes take turns,
    so each admission spills the other's prefix to the host tier and the
    next one restores it. Card and CPU give equal tokens and counters."""
    import numpy as np

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1,
                                        init_std=0.1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(3)
    prefixes = [rng.integers(0, 256, (32,)) for _ in range(2)]
    order = (0, 1, 0, 1, 0)
    prompts = [np.concatenate([prefixes[i], rng.integers(0, 256, (9,))])
               for i in order]
    outs, counters = {}, {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = pt_pkg.BatchDecodeEngine(
            model, max_slots=1, chunk=4, page_size=16, num_pages=6,
            kv_quant="int8", kv_host_bytes=1 << 22, device=dev)
        reqs = [pt_pkg.GenerationRequest(p, 8, 0.0, 0, None, prefix_len=32)
                for p in prompts]
        pa.paged_attention.int8_launches = 0
        eng.serve(reqs, timeout=300)
        outs[dev] = [r.result.result(5).tolist() for r in reqs]
        st = eng.kv_stats()
        host = {k: st["host"][k] for k in ("entries", "spills", "restores",
                                           "discards")}
        counters[dev] = {"prefix": st["prefix"], "host": host,
                         "restore_failures": eng.stats["restore_failures"],
                         "decode_steps": eng.stats["decode_steps"],
                         "int8_launches": pa.paged_attention.int8_launches}
    equal = outs["cuda"] == outs["cpu"]
    same = all(counters["cuda"][k] == counters["cpu"][k]
               for k in ("prefix", "host", "restore_failures"))
    expected = cfg.num_hidden_layers * counters["cuda"]["decode_steps"]
    emit({"phase": "engine_parity_int8", "equal": equal,
          "counters_equal": same, "counters": counters,
          "expected_int8_launches": expected,
          "tokens": sum(len(o) for o in outs["cuda"])})
    if not equal:
        raise AssertionError(f"int8 engine: card vs CPU greedy tokens "
                             f"differ: {outs['cuda']} vs {outs['cpu']}")
    if not same:
        raise AssertionError(f"int8 engine: card vs CPU counters differ: "
                             f"{counters}")
    host = counters["cuda"]["host"]
    if host["spills"] < 1 or host["restores"] < 1:
        raise AssertionError(f"int8 engine: no spill/restore: {host}")
    if counters["cuda"]["int8_launches"] != expected or expected == 0:
        raise AssertionError(f"int8 kernel launched "
                             f"{counters['cuda']['int8_launches']} times, "
                             f"expected {expected}")
    if counters["cpu"]["int8_launches"] != 0:
        raise AssertionError("the CPU engine launched the int8 kernel")


def flash_launches():
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    return {"flash_fwd": fa.flash_fwd.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


def reset_flash_launches() -> None:
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    fa.flash_fwd.launches = 0
    fa.flash_bwd_dq.launches = 0
    fa.flash_bwd_dkv.launches = 0


def llm_loss(model, ids, labels):
    return model(ids, labels=labels)


def phase_train_parity(pt_pkg):
    """A tiny fp32 Llama (d 64) trained 3 TrainStep steps on the card
    (flash kernels) and on the CPU (plain versions) from the same state and
    the same batch (s 100: a ragged last tile). Losses within 1e-4: f32
    sums in other orders on the two devices. Parameters within 5e-4, half
    of one step's move (lr 1e-3): Adam's ``m / (sqrt(v) + eps)`` turns the
    f32 noise of a gradient near zero into up to ``lr * noise / eps`` of
    parameter (tests/test_torch_train.py measures the same effect against
    JAX); the share of parameters within 1e-5 is reported beside it."""
    import numpy as np
    import torch

    cfg = pt_pkg.LlamaConfig(
        vocab_size=256, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, dtype="float32")
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=1)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(0).integers(0, 256, (4, 100))
    losses = {}
    before = flash_launches()
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = pt_pkg.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        step = pt_pkg.TrainStep(model, opt, llm_loss, device=dev)
        losses[dev] = [float(step(ids, ids)) for _ in range(3)]
    moved = {k: v - before[k] for k, v in flash_launches().items()}
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_sd = cpu_model.state_dict()
    diffs = torch.cat([(p.detach().cpu() - cpu_sd[n]).abs().flatten()
                       for n, p in gpu_model.state_dict().items()])
    param_err = float(diffs.max())
    emit({"phase": "train_parity", "losses": losses, "loss_err": loss_err,
          "param_err": param_err,
          "params_within_1e-5": float((diffs <= 1e-5).float().mean()),
          "flash_launches": moved})
    if not (loss_err <= 1e-4 and param_err <= 5e-4):
        raise AssertionError(f"card vs CPU training differs: loss {loss_err}, "
                             f"params {param_err}")
    if min(moved.values()) < cfg.num_hidden_layers * 3:
        raise AssertionError(f"flash kernels not launched by the card's "
                             f"train steps: {moved}")


def moe_parity_config(pt_pkg):
    return pt_pkg.MoEConfig(
        vocab_size=256, hidden_size=256, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        num_experts=4, num_experts_per_tok=2, num_shared_experts=1,
        max_position_embeddings=128, dtype="float32", dispatch_mode="fused")


def phase_moe_parity(pt_pkg):
    """A tiny fp32 MoE decoder (fused mode) trained 3 TrainStep steps on the
    card (gather-GEMM and flash kernels) and on the CPU (plain versions)
    from one state and one batch (s 100). The gates are drawn N(0, 0.5) so
    that router logits are far apart: an argmax that f32 noise could flip
    between the two devices would reroute a token, which is no kernel
    fault. Bounds as in train_parity."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg

    cfg = moe_parity_config(pt_pkg)
    cpu_model = pt_pkg.MoEForCausalLM(cfg, device="cpu", seed=1)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(2)
        for layer in cpu_model.layers:
            layer.mlp.gate.weight.normal_(0.0, 0.5, generator=gen)
    gpu_model = pt_pkg.MoEForCausalLM(cfg, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    ids = np.random.default_rng(0).integers(0, 256, (4, 100))
    losses = {}
    gg.gather_gemm_ffn.launches = 0
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        opt = pt_pkg.AdamW(learning_rate=1e-3, weight_decay=0.01,
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        step = pt_pkg.TrainStep(model, opt, llm_loss, device=dev)
        losses[dev] = [float(step(ids, ids)) for _ in range(3)]
    moved = gg.gather_gemm_ffn.launches
    loss_err = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    cpu_sd = cpu_model.state_dict()
    diffs = torch.cat([(p.detach().cpu() - cpu_sd[n]).abs().flatten()
                       for n, p in gpu_model.state_dict().items()])
    param_err = float(diffs.max())
    emit({"phase": "moe_parity", "losses": losses, "loss_err": loss_err,
          "param_err": param_err,
          "params_within_1e-5": float((diffs <= 1e-5).float().mean()),
          "gather_gemm_launches": moved})
    if not (loss_err <= 1e-4 and param_err <= 5e-4):
        raise AssertionError(f"card vs CPU MoE training differs: loss "
                             f"{loss_err}, params {param_err}")
    if moved != cfg.num_hidden_layers * 3:
        raise AssertionError(f"gather-GEMM launched {moved} times in the "
                             f"card's 3 steps, expected "
                             f"{cfg.num_hidden_layers} x 3")


PARITY_MORE_LAYERS = 1    # Llama-3-8B widths at 1 of 32 layers, f32 (2
#                           until the pipeline phases came)
PARITY_MORE_OPTIMIZERS = {
    "SGD": dict(learning_rate=1e-3),
    "Momentum": dict(learning_rate=1e-3, momentum=0.9, use_nesterov=True,
                     weight_decay=("L2Decay", 1e-4)),
    "Adagrad": dict(learning_rate=1e-3, weight_decay=("L1Decay", 1e-4)),
    "RMSProp": dict(learning_rate=1e-3, momentum=0.5, centered=True),
    "Adadelta": dict(learning_rate=1.0),
    "Adamax": dict(learning_rate=1e-3),
    "Lamb": dict(learning_rate=1e-3),
    "Lars": dict(learning_rate=1e-3, exclude_from_weight_decay=["norm"]),
    "NAdam": dict(learning_rate=1e-3),
    "RAdam": dict(learning_rate=1e-3),
}


def phase_train_parity_more(pt_pkg):
    """The card against the CPU on a ``PARITY_MORE_LAYERS``-layer f32
    copy of the Llama-3-8B widths (hidden 4096, MLP 14336, 32 q / 8 KV
    heads, vocab 128256), batch 2 x 64, within train_parity's bounds and
    these:

    * recompute (full and ``"dots"``) on the card against no recompute on
      the CPU: loss 1e-4; every gradient within 1e-4 of its parameter's
      largest gradient (f32 sums in other orders, flash kernels against the
      plain version), kernel 2 launched twice a layer;
    * the masked forward and loss (a bool key-padding mask and an additive
      float mask): logits 1e-4, loss 1e-4, zero flash launches;
    * ``F.cross_entropy`` over the shifted labels against the model's
      ``loss_from_logits`` on the card's logits: 1e-5;
    * two steps of each new optimizer (``PARITY_MORE_OPTIMIZERS``) on the
      first decoder layer's attention and norms (42 M) from the CPU's
      gradients,
      the same on both devices: parameters within 1e-5 (elementwise f32
      rules; the norms of Lamb and Lars sum in other orders)."""
    import numpy as np
    import torch

    F = pt_pkg.nn.functional
    cfg = pt_pkg.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = PARITY_MORE_LAYERS
    cfg.dtype = "float32"
    cpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cpu", seed=4)
    gpu_model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=5)
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(6)
    ids_np = rng.integers(0, cfg.vocab_size, (2, 64))
    labels_np = ids_np.copy()
    labels_np[1, 10:20] = -100
    ids_c, labels_c = torch.from_numpy(ids_np), torch.from_numpy(labels_np)
    ids_g, labels_g = ids_c.cuda(), labels_c.cuda()
    out = {"phase": "train_parity_more", "layers": cfg.num_hidden_layers,
           "dtype": "float32"}

    # (1) recompute on the card against no recompute on the CPU
    t0 = time.perf_counter()
    loss_c = cpu_model(ids_c, labels_c)
    loss_c.backward()
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    out["cpu_step_s"] = time.perf_counter() - t0
    L = cfg.num_hidden_layers
    for policy in (None, "dots"):
        gpu_model.zero_grad()
        gpu_model.config.recompute = True
        gpu_model.config.remat_policy = policy
        reset_flash_launches()
        loss_g = gpu_model(ids_g, labels_g)
        loss_g.backward()
        torch.cuda.synchronize()
        launches = flash_launches()
        gpu_model.config.recompute = False
        rel = max(float((p.grad.cpu() - cpu_grads[n]).abs().max())
                  / max(float(cpu_grads[n].abs().max()), 1e-30)
                  for n, p in gpu_model.named_parameters())
        err = abs(float(loss_g.detach()) - float(loss_c.detach()))
        out[f"recompute_{policy}"] = {"loss_err": err, "grad_rel_err": rel,
                                      "flash_launches": launches}
        if not (err <= 1e-4 and rel <= 1e-4):
            raise AssertionError(f"recompute {policy} on the card vs the CPU "
                                 f"differs: loss {err}, grads {rel}")
        if launches != {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                        "flash_bwd_dkv": L}:
            raise AssertionError(f"recompute {policy}: flash launches "
                                 f"{launches}, expected {2 * L}/{L}/{L}")
    gpu_model.zero_grad()

    # (2) the masked forward and loss: the plain route, no flash launch
    keep = np.ones((2, 64), bool)
    keep[0, 50:] = False
    masks = {"bool_padding": torch.from_numpy(keep[:, None, None, :]),
             "float": torch.from_numpy(np.where(
                 rng.random((2, 1, 64, 64)) > 0.2, 0.0, -3.0).astype(
                     np.float32))}
    out["masked"] = {}
    reset_flash_launches()
    with torch.no_grad():
        for name, m in masks.items():
            lg_c = cpu_model(ids_c, attn_mask=m)
            lg_g = gpu_model(ids_g, attn_mask=m.cuda())
            ls_c = pt_pkg.LlamaForCausalLM.loss_from_logits(lg_c, labels_c)
            ls_g = gpu_model(ids_g, labels_g, m.cuda())
            rec = {"logits_err": float((lg_g.cpu() - lg_c).abs().max()),
                   "loss_err": abs(float(ls_g) - float(ls_c))}
            out["masked"][name] = rec
            if not (rec["logits_err"] <= 1e-4 and rec["loss_err"] <= 1e-4):
                raise AssertionError(f"masked forward {name}: {rec}")
        masked_launches = flash_launches()
    out["masked_flash_launches"] = masked_launches
    if any(masked_launches.values()):
        raise AssertionError(f"the masked path launched flash kernels: "
                             f"{masked_launches}")

    # (3) F.cross_entropy against the model's loss on the card's logits
    with torch.no_grad():
        logits = gpu_model(ids_g)
        want = pt_pkg.LlamaForCausalLM.loss_from_logits(logits, labels_g)
        got = F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                              labels_g[:, 1:].reshape(-1))
    out["cross_entropy_err"] = abs(float(got) - float(want))
    if not out["cross_entropy_err"] <= 1e-5:
        raise AssertionError(f"F.cross_entropy vs loss_from_logits: "
                             f"{out['cross_entropy_err']}")
    del logits

    # (4) two steps of each optimizer, the same gradients on both devices
    # the first layer's attention and norms (the MLP's 176 M left out:
    # the rules are elementwise or per-tensor norms, and the CPU's share of
    # this phase's time is the optimizers' steps)
    prefix = "model.layers.0."
    names = [n for n, _ in cpu_model.named_parameters()
             if n.startswith(prefix) and ".mlp." not in n]
    cpu_params = dict(cpu_model.named_parameters())
    grads = {n: cpu_grads[n].clone() for n in names}
    del cpu_grads
    cpu_model.zero_grad()
    gpu_grads = {n: g.cuda() for n, g in grads.items()}
    out["optimizers"] = {}
    for name, kw in PARITY_MORE_OPTIMIZERS.items():
        errs = []
        per_dev = {}
        for dev, gs in (("cpu", grads), ("cuda", gpu_grads)):
            params = {n: torch.nn.Parameter(cpu_params[n].detach().to(dev,
                                                                      copy=True))
                      for n in names}
            k = dict(kw)
            if "weight_decay" in k:
                k["weight_decay"] = getattr(pt_pkg.regularizer,
                                            k["weight_decay"][0])(
                    k["weight_decay"][1])
            opt = getattr(pt_pkg, name)(parameters=params, **k)
            for _ in range(2):
                opt.apply([gs[n] for n in names])
            per_dev[dev] = params
            del opt
        for n in names:
            errs.append(float((per_dev["cuda"][n].detach().cpu()
                               - per_dev["cpu"][n].detach()).abs().max()))
        moved = max(float((per_dev["cpu"][n].detach()
                           - cpu_params[n].detach()).abs().max())
                    for n in names)
        out["optimizers"][name] = {"param_err": max(errs), "moved": moved}
        del per_dev
        if not (max(errs) <= 1e-5 and moved > 0):
            raise AssertionError(f"{name}: card vs CPU params differ by "
                                 f"{max(errs)} (moved {moved})")
    emit(out)


def _phase_alone(name):
    """``phase_<name>`` in a process of its own (its kernel counters are its
    own), so that it runs beside other untimed phases; returns its value
    and its seconds."""
    import torch

    import paddlepaddle_tpu_torch as pt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    out = globals()[f"phase_{name}"](pt)
    return out, time.perf_counter() - t0


TRAIN_LAYERS = 8      # Llama-3-8B widths at 8 of 32 layers: AdamW with f32
#                       masters costs 16 bytes a parameter (45 GB here)
TRAIN_BATCH, TRAIN_SEQ = 4, 2048


def timed_steps(step, ids, n_timed, warmup=1):
    """``warmup + n_timed`` calls of ``step(ids, ids)``: the losses, each
    call's host wall in ms (ending in a sync), the median timed one."""
    import torch

    losses, wall_ms = [], []
    for _ in range(warmup + n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(float(loss))           # syncs
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    timed = sorted(wall_ms[warmup:])
    return losses, wall_ms, timed[len(timed) // 2]


def train_rates(cfg, step_ms, remat_extra: bool):
    """tokens/s, MFU by the repo's convention ((6N + 12 L h s) over 989
    TFLOP/s, bench.py:189) and, under full recompute, hw_util counting its
    extra forward (2N a token, bench.py:210-215)."""
    n = cfg.num_params()
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    model_flops = 6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size \
        * TRAIN_SEQ
    out = {"params": n, "tokens_per_s": tok_s,
           "mfu": tok_s * model_flops / BF16_FLOP_PER_S}
    if remat_extra:
        out["hw_util"] = tok_s * (model_flops + 2 * n) / BF16_FLOP_PER_S
    return out


def train_breakdown(step, ids, step_ms):
    """Device time of one profiled step by kind, and the device's idle share
    against the median unprofiled step. The profiled step counts as a
    step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(ids, ids)
        torch.cuda.synchronize()
    by_kind = {"matmul": 0.0, "flash": 0.0, "gather_gemm": 0.0, "other": 0.0}
    top = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("flash" if "flash_" in name and "kernel" in name else
                "gather_gemm" if ("gather_gateup" in name
                                  or "expert_down" in name) else
                "matmul" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                    "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + ms
    busy = sum(by_kind.values())
    return {"device_busy_ms": busy if busy > 0 else "not measured",
            "device_idle_share": 1 - busy / step_ms if busy > 0
            else "not measured",
            "device_ms_by_kind": by_kind,
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                   [:10])}


def phase_train(pt_pkg):
    """The training slice at full width: Llama-3-8B widths, 8 layers, bf16
    with f32 masters, AdamW + global-norm clip, batch 4 x 2048 repeated."""
    import numpy as np
    import torch

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = TRAIN_LAYERS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       multi_precision=True,
                       parameters=model.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(model, opt, llm_loss)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    reset_flash_launches()
    losses, wall_ms, step_ms = timed_steps(step, ids, 5)
    breakdown = train_breakdown(step, ids, step_ms)
    n_steps = len(wall_ms) + 1               # the profiled step included
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated()
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    emit({"phase": "train", "model": "llama3_8b widths", "layers":
          cfg.num_hidden_layers, "batch": TRAIN_BATCH,
          "seq": TRAIN_SEQ, "init_s": init_s, "steps": n_steps,
          "step_ms": step_ms, "step_ms_all": wall_ms,
          **train_rates(cfg, step_ms, False),
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "flash_launches": launches,
          "expected_launches": cfg.num_hidden_layers * n_steps,
          "nonfinite_params": bad, "breakdown": breakdown})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses not finite and falling: {losses}")
    if any(v != cfg.num_hidden_layers * n_steps for v in launches.values()):
        raise AssertionError(f"flash launches {launches}, expected "
                             f"{cfg.num_hidden_layers} x {n_steps}")
    if bad:
        raise AssertionError(f"non-finite parameters after training: {bad}")
    return launches


RECOMPUTE_LAYERS = 12   # Llama-3-8B widths at 12 of 32 layers under full
#                         recompute: 3.67 B parameters x 16 bytes (bf16
#                         weight and gradient, f32 master, two f32 moments)
#                         = 58.7 GB, plus 12 saved layer inputs, one layer's
#                         live activations and the logits; without recompute
#                         the same 12 layers need ~19 GB of activations more
REMAT_ARMS = (("no_recompute", False, None), ("full", True, None),
              ("dots", True, "dots"), ("dots_no_batch", True,
                                       "dots_no_batch"))


def phase_train_recompute(pt_pkg):
    """Deeper training through activation recompute, at full width.

    (a) Llama-3-8B widths cut to ``RECOMPUTE_LAYERS`` of 32, bf16,
        ``recompute=True`` (full remat), batch 4 x 2048, AdamW with f32
        masters + global-norm clip: 1 warm-up and 5 timed steps; step ms,
        tokens/s, MFU, hw_util, peak memory (must stay under the card's
        80 GB) and the flash launches a step (2 L forward, L dQ, L dK/dV).
    (b) at the train phase's 8 layers, one model and optimizer, four arms
        side by side: no recompute, full, ``"dots"``, ``"dots_no_batch"``:
        1 warm-up and 3 timed steps each, step ms and peak memory, and the
        flash launches of each arm's steps."""
    import numpy as np
    import torch

    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128256, (TRAIN_BATCH, TRAIN_SEQ))).cuda()

    def build(layers, recompute):
        cfg = pt_pkg.LlamaConfig.llama3_8b()
        cfg.num_hidden_layers = layers
        cfg.recompute = recompute
        model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                        init_std=0.02)
        opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           multi_precision=True,
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        return cfg, model, pt_pkg.TrainStep(model, opt, llm_loss)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, step = build(RECOMPUTE_LAYERS, True)
    reset_flash_launches()
    losses, wall_ms, step_ms = timed_steps(step, ids, 5)
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated()
    L, n_steps = cfg.num_hidden_layers, len(wall_ms)
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    deep = {"layers": L, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "step_ms": step_ms, "step_ms_all": wall_ms,
            **train_rates(cfg, step_ms, True), "peak_mem_gb": peak / 1e9,
            "losses": losses, "flash_launches": launches,
            "flash_launches_per_step": {k: v / n_steps
                                        for k, v in launches.items()}}
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train_recompute losses not finite and "
                             f"falling: {losses}")
    if launches != {"flash_fwd": 2 * L * n_steps,
                    "flash_bwd_dq": L * n_steps,
                    "flash_bwd_dkv": L * n_steps}:
        raise AssertionError(f"train_recompute flash launches {launches}, "
                             f"expected {2 * L}/{L}/{L} x {n_steps}")
    if bad or peak >= 80e9:
        raise AssertionError(f"train_recompute: non-finite {bad}, peak "
                             f"{peak / 1e9} GB")

    cfg, model, step = build(TRAIN_LAYERS, False)
    arms = {}
    for name, on, policy in REMAT_ARMS:
        model.config.recompute, model.config.remat_policy = on, policy
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_launches()
        arm_losses, arm_wall, arm_ms = timed_steps(step, ids, 3)
        arms[name] = {"step_ms": arm_ms, "step_ms_all": arm_wall,
                      **train_rates(cfg, arm_ms, on and policy is None),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "losses": arm_losses,
                      "flash_launches": flash_launches()}
        if not all(np.isfinite(arm_losses)):
            raise AssertionError(f"remat arm {name}: losses {arm_losses}")
    model.config.recompute = False
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "train_recompute", "model": "llama3_8b widths",
          "deep": deep, "arms_at_8_layers": arms})
    return launches, deep


AMP_LAYERS = 8          # the train phase's depth, f32 weights for O1
AMP_FP16_LAYERS = 2     # the eager GradScaler check


def phase_train_amp(pt_pkg):
    """AMP at Llama-3-8B widths, all in one run.

    (a) an f32 model at ``AMP_LAYERS`` layers with ``recompute=True`` under
        ``auto_cast(level="O1", dtype="bfloat16")``, AdamW without masters
        (the weights are f32): 1 warm-up and 3 timed steps, step ms and
        peak memory;
    (b) ``decorate(level="O2")`` of the same model (bf16 in place) with a
        fresh AdamW that keeps f32 masters, under ``auto_cast(level="O2")``;
    (c) fp16 O1 at ``AMP_FP16_LAYERS`` layers on the eager path
        (``scaler.scale(loss).backward(); scaler.step(opt);
        scaler.update()``, ``incr_every_n_steps=2``): one injected inf
        gradient halves the scale and leaves every parameter bit-unchanged,
        two good steps grow it back, and the flash kernels ran in fp16
        (their counters move; q, k, v reach them as fp16)."""
    import numpy as np
    import torch

    amp = pt_pkg.amp
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 128256, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    out = {"phase": "train_amp", "model": "llama3_8b widths"}
    cfg = pt_pkg.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = AMP_LAYERS
    cfg.dtype = "float32"
    cfg.recompute = True
    gc.collect()
    torch.cuda.empty_cache()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    for level, dtype in (("O1", "bfloat16"), ("O2", "bfloat16")):
        if level == "O2":
            amp.decorate(model, level="O2", dtype=dtype)
        opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           multi_precision=level == "O2",
                           parameters=model.named_parameters(),
                           grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
        train_step = pt_pkg.TrainStep(model, opt, llm_loss)

        def step(a, b, _s=train_step, _l=level, _d=dtype):
            with amp.auto_cast(level=_l, dtype=_d):
                return _s(a, b)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_launches()
        losses, wall_ms, step_ms = timed_steps(step, ids, 3)
        out[f"{level}_{dtype}"] = {
            "layers": AMP_LAYERS, "step_ms": step_ms, "step_ms_all": wall_ms,
            **train_rates(cfg, step_ms, True),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "param_dtype": str(next(model.parameters()).dtype),
            "losses": losses, "flash_launches": flash_launches()}
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train_amp {level}: losses {losses}")
        del opt, train_step, step
    del model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) fp16 O1 on the eager path with the loss scaler
    cfg = pt_pkg.LlamaConfig.llama3_8b()
    cfg.num_hidden_layers = AMP_FP16_LAYERS
    cfg.dtype = "float32"
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=1,
                                    init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4,
                       parameters=model.named_parameters())
    scaler = amp.GradScaler(incr_every_n_steps=2)
    reset_flash_launches()
    seq, unchanged = [], None
    for i, inject in enumerate((False, True, False, False)):
        with amp.auto_cast(level="O1", dtype="float16"):
            loss = model(ids, labels=ids)
        scaler.scale(loss).backward()
        if inject:
            w = model.model.layers[0].mlp.up_proj.weight
            w.grad[0, 0] = float("inf")
            before = {n: p.detach().clone()
                      for n, p in model.named_parameters()}
        scaler.step(opt)
        scaler.update()
        if inject:
            unchanged = all(torch.equal(p, before[n])
                            for n, p in model.named_parameters())
            del before
        opt.clear_grad()
        seq.append({"loss": float(loss), "found_inf": scaler._found_inf,
                    "scale": scaler._scale})
    fp16_launches = flash_launches()
    out["fp16_eager"] = {"layers": AMP_FP16_LAYERS, "steps": seq,
                         "skipped_step_params_unchanged": unchanged,
                         "flash_launches": fp16_launches}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    scales = [s["scale"] for s in seq]
    init = 2.0 ** 16
    if scales != [init, init / 2, init / 2, init] or not unchanged:
        raise AssertionError(f"GradScaler sequence {scales} (expected "
                             f"{[init, init / 2, init / 2, init]}), "
                             f"skipped step unchanged: {unchanged}")
    if [s["found_inf"] for s in seq] != [False, True, False, False]:
        raise AssertionError(f"found_inf sequence: {seq}")
    L = AMP_FP16_LAYERS
    if fp16_launches != {"flash_fwd": 4 * L, "flash_bwd_dq": 4 * L,
                         "flash_bwd_dkv": 4 * L}:
        raise AssertionError(f"fp16 flash launches {fp16_launches}, "
                             f"expected {4 * L} each")
    return fp16_launches


MOE_TRAIN_LAYERS = 4     # DeepSeekMoE-16B widths at 4 of 28 layers: 2.77 B
#                          parameters, 16 bytes each with f32 AdamW masters


def moe_train_config(pt_pkg):
    """DeepSeekMoE-16B's published widths (deepseek-ai/deepseek-moe-16b-base
    config.json) as far as the JAX MoEForCausalLM expresses them; top-2
    (published 6: any k > 1 is GShard top-2 there), 4 layers (published
    28), no leading dense layer, renormalised top-2 gate values."""
    return pt_pkg.MoEConfig(
        vocab_size=102400, hidden_size=MOE_D, intermediate_size=MOE_H,
        num_hidden_layers=MOE_TRAIN_LAYERS, num_attention_heads=16,
        num_key_value_heads=16, num_experts=MOE_E, num_experts_per_tok=2,
        num_shared_experts=2, capacity_factor=1.25,
        max_position_embeddings=4096, rms_norm_eps=1e-6, rope_theta=10000.0,
        aux_loss_weight=0.001, dtype="bfloat16", dispatch_mode="fused")


def moe_drop_shares(model, ids):
    """Share of routed entries each layer's capacity dropped, from one
    forward without gradients (run after the counted steps)."""
    import torch

    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    shares = []

    def hook(mlp, args):
        x = args[0].reshape(-1, mlp.d_model)
        logits = x.float() @ mlp.gate.weight.float()
        soe = tmoe._capacity_slot_maps(logits, mlp.gate.topk, mlp.num_experts,
                                       mlp.capacity(x.shape[0]),
                                       x.shape[0])[2]
        shares.append((soe < 0).float().mean())

    handles = [layer.mlp.register_forward_pre_hook(hook)
               for layer in model.layers]
    with torch.no_grad():
        model(ids)
    for hd in handles:
        hd.remove()
    return [float(s) for s in shares]


def phase_moe_train(pt_pkg):
    """The MoE training slice at full width (see moe_train_config)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg

    cfg = moe_train_config(pt_pkg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.MoEForCausalLM(cfg, device="cuda", seed=0, init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       multi_precision=True,
                       parameters=model.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(model, opt, llm_loss)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    reset_flash_launches()
    gg.gather_gemm_ffn.launches = 0
    gg.gather_gateup.launches = gg.expert_down.launches = 0
    losses, wall_ms = [], []
    for _ in range(6):                       # 1 warm-up + 5 timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(ids, ids)
        losses.append(float(loss))           # syncs
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    timed = sorted(wall_ms[1:])
    step_ms = timed[len(timed) // 2]
    breakdown = train_breakdown(step, ids, step_ms)
    n_steps = len(wall_ms) + 1               # the profiled step included
    launches = {"gather_gemm_ffn": gg.gather_gemm_ffn.launches,
                "gather_gateup": gg.gather_gateup.launches,
                "expert_down": gg.expert_down.launches, **flash_launches()}
    peak = torch.cuda.max_memory_allocated()
    drops = moe_drop_shares(model, ids)
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    total = sum(p.numel() for p in model.parameters())
    L, h = cfg.num_hidden_layers, cfg.hidden_size
    inactive = L * (cfg.num_experts - cfg.num_experts_per_tok) * 3 * h \
        * cfg.intermediate_size
    active = total - inactive
    flops_per_token = 6 * active + 12 * L * h * TRAIN_SEQ   # bench.py:291-299
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tok_s = tokens / (step_ms / 1e3)
    emit({"phase": "moe_train", "model": "deepseek-moe-16b widths",
          "layers": L, "params": total, "params_active": active,
          "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "capacity": model.layers[0].mlp.capacity(tokens),
          "init_s": init_s, "steps": n_steps, "step_ms": step_ms,
          "step_ms_all": wall_ms, "tokens_per_s": tok_s,
          "mfu_active": tok_s * flops_per_token / BF16_FLOP_PER_S,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "launches": launches, "expected_launches": L * n_steps,
          "drop_share_per_layer": drops, "nonfinite_params": bad,
          "breakdown": breakdown})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"MoE train losses not finite and falling: "
                             f"{losses}")
    if any(v != L * n_steps for v in launches.values()):
        raise AssertionError(f"MoE train launches {launches}, expected "
                             f"{L} x {n_steps}")
    if bad:
        raise AssertionError(f"non-finite parameters after MoE training: "
                             f"{bad}")
    return launches["gather_gemm_ffn"]


def leaked_pages(eng) -> int:
    """Pages in use beyond the refcount-0 cached prefixes, with no request
    in a slot: 0 unless a reservation leaked."""
    return eng.pool.used - eng.prefix.cached_pages


PROFILED_WINDOWS = 3            # decode_breakdown's profiled chunks, at most


def decode_breakdown(pt_pkg, eng, prompts, check=None):
    """Where one decode chunk's time goes, all slots busy: the host wall of
    an unprofiled chunk (replays of the captured programs and the chunk's
    one readback), then the device time by kernel from a torch.profiler
    window over the next chunk, the device's idle share of the wall, and
    each captured program's capture seconds, graph-pool bytes and replays.
    Works for the speculative chunk too. ``check(eng)`` runs after the
    first chunk, while every slot is live. The profiled chunk's paged
    kernel and merge launches are counted from the profiler's device
    events and must equal target steps x layers, as must the Python
    counters' move over that chunk (which the engine adds per replay).
    The profiler can lose a block of device records (seen on the H100 in
    1 of 8 speculative chunks: ~1,200 records, 26 paged kernels of one
    graph replay); it never adds any. So up to ``PROFILED_WINDOWS`` chunks
    are profiled, every window is reported, the device times are read from
    the first window that shows every expected launch, and the phase fails
    if none does. The counters must move by the expected count in every
    window.
    The quantize-scatter of int8 KV runs inside the graph, where a range
    cannot mark it: its device time is measured apart by
    :func:`kv_scatter_device_ms` and scaled to the chunk."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    reqs = [pt_pkg.GenerationRequest(p[:128], 64) for p in prompts[:eng.S]]
    for r in reqs:
        if not eng._admit(r):
            raise AssertionError("breakdown: admission failed")
    eng._decode_chunk()                       # first tokens + a warm chunk
    checked = check(eng) if check is not None else None
    scatter = kv_scatter_device_ms(eng) if eng.kv_quant else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_chunk()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counter = ("int8_launches" if eng.kv_quant else "launches")
    steps = eng._spec_steps_per_chunk if eng.spec is not None else eng.chunk
    expected = steps * eng.cfg.num_hidden_layers
    windows = []
    for _ in range(PROFILED_WINDOWS):
        before = getattr(pa.paged_attention, counter)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng._decode_chunk()
            torch.cuda.synchronize()
            profiled_wall_ms = (time.perf_counter() - t0) * 1e3
        counted = getattr(pa.paged_attention, counter) - before
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        events = {k: sum(e.count for e in kernels if k in e.key.lower())
                  for k in ("paged_attn_kernel", "paged_merge_kernel")}
        windows.append({"paged_device_events": events,
                        "device_events": sum(e.count for e in kernels),
                        "counter_moved": counted})
        if counted != expected:
            raise AssertionError(f"breakdown: the counter moved {counted} "
                                 f"over a chunk, expected {steps} steps x "
                                 f"{eng.cfg.num_hidden_layers} layers")
        if all(n == expected for n in events.values()):
            break
    else:
        raise AssertionError(
            f"breakdown: no profiled chunk showed {expected} paged kernel "
            f"and merge launches on the device ({steps} steps x "
            f"{eng.cfg.num_hidden_layers} layers): {windows}")
    by_kind = {"paged_attention": 0.0, "paged_attention_int8": 0.0,
               "paged_merge": 0.0, "matmul": 0.0, "other": 0.0}
    top = {}
    for e in kernels:
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        kind = ("paged_attention_int8" if "paged_attn" in name
                and ("signed char" in name or "int8" in name) else
                "paged_attention" if "paged_attn" in name else
                "paged_merge" if "paged_merge" in name else
                "matmul" if any(w in name for w in ("gemm", "gemv", "xmma",
                                                    "cutlass", "nvjet"))
                else "other")
        by_kind[kind] += ms
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + ms
    while eng.busy_slots():
        eng._decode_chunk()
    leaked = leaked_pages(eng)
    if leaked:
        raise AssertionError(f"breakdown leaked {leaked} pages")
    busy = sum(by_kind.values())
    out = {"chunk_wall_ms": wall_ms,
           "profiled_chunk_wall_ms": profiled_wall_ms, "steps": steps,
           "paged_launches_counted": counted,
           "paged_device_events": events, "expected_launches": expected,
           "profiled_windows": windows,
           "device_busy_ms": busy if busy > 0 else "not measured",
           "device_idle_share": 1 - busy / wall_ms if busy > 0
           else "not measured",
           "device_idle_share_of_profiled_chunk": 1 - busy / profiled_wall_ms
           if busy > 0 else "not measured",
           "device_ms_by_kind": by_kind,
           "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                  [:8]),
           "capture": eng.capture_info()}
    if checked is not None:
        out["check"] = checked
    if scatter is not None:
        out["kv_quant_scatter"] = {
            **scatter, "chunk_device_ms":
            scatter["device_ms_per_call"] * 2 * expected}
    return out


def kv_scatter_device_ms(eng, reps: int = 20) -> dict:
    """Device time of one ``_kv_quant_scatter`` call as the int8 engine
    makes it in a target step (one pool, one layer, every slot, W 1, or
    W = k+1 under spec), measured apart from the graph: the call runs
    ``reps`` times eagerly on copies of layer 0's codes and scales at the
    slots' current pages and offsets, under torch.profiler, and the device
    time of the window's kernels (launch gaps excluded) is divided by
    ``reps``. A chunk makes 2 x layers x steps such calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlepaddle_tpu_torch.inference import decode_engine as de

    cfg = eng.cfg
    (codes, scales), _ = eng.caches[0]
    codes, scales = codes.clone(), scales.clone()
    S, ps = eng.S, eng.page_size
    W = 1 if eng.spec is None else eng.spec.k + 1
    pos = eng.lens.long()[:, None] + torch.arange(W, device=codes.device)
    col = (pos // ps).clamp(max=eng.P - 1)
    phys = torch.gather(eng.page_table.long(), 1, col)
    off = pos % ps
    gen = torch.Generator(device=codes.device).manual_seed(0)
    rows = torch.randn((S, W, cfg.num_key_value_heads, cfg.head_dim),
                       generator=gen, device=codes.device).to(eng._kv_dtype)
    for _ in range(3):
        de._kv_quant_scatter(codes, scales, rows, phys, off)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            de._kv_quant_scatter(codes, scales, rows, phys, off)
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"device_ms_per_call": device_us / 1e3 / reps, "W": W,
            "reps": reps,
            "kernels_per_call": sum(
                e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / reps}


def phase_serve(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    n_req = 24
    plens = rng.integers(64, 1537, n_req)
    budgets = rng.integers(32, 129, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),)) for n in plens]
    sampled = {5, 17}                       # temperature 0.8, top_k 50
    failures = []
    with pt_pkg.ServingEngine(model, max_batch_size=8, kv_page_size=64,
                              max_len=2048, decode_chunk=16,
                              device="cuda") as se:
        eng = se.engine
        # one short warm-up request (cuBLAS handles, allocator) before the
        # counted run
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        pa.paged_attention.launches = 0
        steps0 = eng.stats["decode_steps"]
        chunks0 = len(eng.chunk_ms)
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b),
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = []
        for i, f in enumerate(futs):
            try:
                outs.append(f.result(900))
            except Exception as e:  # noqa: BLE001 — counted and reported
                failures.append(f"request {i}: {type(e).__name__}: {e}")
                outs.append(None)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = eng.stats["decode_steps"] - steps0
        chunk_ms = sorted(eng.chunk_ms[chunks0:])
        peak = torch.cuda.max_memory_allocated()
        # the decode path (paged kernel) against a plain causal forward on
        # the shortest greedy request: every emitted token within bf16 noise
        # of the reference argmax logit. The reference is the prefill's own
        # attention (``_cached_attention`` over a scratch cache at position
        # 0), so the prompt rows match the engine's bit for bit. The
        # cache-less flash forward is another bf16 order of the same 32
        # layers: as the reference here it read gaps of 0.25 and 0.22 on
        # these random weights (PERF.md), so it is checked by the
        # flash_kernel and train phases instead
        greedy = [i for i in range(n_req) if i not in sampled
                  and outs[i] is not None]
        i_chk = min(greedy, key=lambda i: plens[i])
        seq = torch.as_tensor(outs[i_chk][:-1].astype(np.int64),
                              device="cuda")[None]
        shape = (1, seq.shape[1], cfg.num_key_value_heads, cfg.head_dim)
        with torch.no_grad():
            scratch = [(torch.zeros(shape, dtype=model.dtype, device="cuda"),
                        torch.zeros(shape, dtype=model.dtype, device="cuda"))
                       for _ in range(cfg.num_hidden_layers)]
            hidden, _ = model.model(seq, caches=scratch, pos=0)
            del scratch
            lg = model.logits(hidden)[0, int(plens[i_chk]) - 1:].float()
        emitted = torch.as_tensor(outs[i_chk][int(plens[i_chk]):]
                                  .astype(np.int64), device="cuda")
        gap = float((lg.max(-1).values
                     - lg.gather(1, emitted[:, None])[:, 0]).max())
    breakdown = decode_breakdown(pt_pkg, eng, prompts)
    bad_len = [i for i, o in enumerate(outs) if o is not None
               and len(o) != plens[i] + budgets[i]]
    bad_tok = [i for i, o in enumerate(outs) if o is not None
               and not ((o >= 0) & (o < cfg.vocab_size)).all()]
    new_tokens = int(sum(len(o) - plens[i] for i, o in enumerate(outs)
                         if o is not None))
    slo = pt_pkg.slo_summary([f for f, o in zip(futs, outs) if o is not None])
    emit({"phase": "serve", "model": "llama3_8b", "params": cfg.num_params(),
          "init_s": init_s, "requests": n_req,
          "completed": sum(o is not None for o in outs),
          "failed": len(failures), "new_tokens": new_tokens, "wall_s": wall,
          "tok_s": new_tokens / wall, "ttft_p50_ms": slo["ttft_p50_ms"],
          "ttft_p99_ms": slo["ttft_p99_ms"], "tpot_ms": slo["tpot_ms"],
          "decode_steps": steps, "decode_chunks": len(chunk_ms),
          "decode_chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms
          else None,
          "decode_chunk_ms_max": chunk_ms[-1] if chunk_ms else None,
          "paged_attention_launches": launches,
          "expected_launches": cfg.num_hidden_layers * steps,
          "peak_mem_gb": peak / 1e9, "greedy_check_logit_gap": gap,
          "decode_breakdown": breakdown})
    if failures:
        raise AssertionError("requests failed: " + "; ".join(failures))
    if bad_len or bad_tok:
        raise AssertionError(f"wrong output length {bad_len} / out-of-vocab "
                             f"tokens {bad_tok}")
    if steps == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"paged_attention launched {launches} times, "
                             f"expected {cfg.num_hidden_layers} x {steps}")
    if not gap <= 0.25:
        raise AssertionError(f"decode path disagrees with the plain forward: "
                             f"an emitted token's logit is {gap} below the "
                             "argmax")
    greedy_outs = {i: outs[i] for i in range(n_req) if i not in sampled}
    summary = {"tok_s": new_tokens / wall, "wall_s": wall,
               "ttft_p50_ms": slo["ttft_p50_ms"], "tpot_ms": slo["tpot_ms"],
               "peak_mem_gb": peak / 1e9,
               "chunk_wall_ms": breakdown["chunk_wall_ms"],
               "device_busy_ms": breakdown["device_busy_ms"],
               "device_idle_share": breakdown["device_idle_share"],
               "device_ms_by_kind": breakdown["device_ms_by_kind"]}
    return launches, dict(model=model, prompts=prompts, budgets=budgets,
                          sampled=sampled, greedy_outs=greedy_outs,
                          summary=summary)


SERVE_INT8 = dict(max_batch_size=8, kv_page_size=64, max_len=2048,
                  decode_chunk=16, kv_quant="int8", kv_host_bytes=256 << 20)
SYSTEM_LEN, N_SYSTEMS, SERVE_INT8_REQUESTS = 1024, 4, 32


def serve_int8_workload(vocab: int):
    """Chat serving with a few system prompts whose working set exceeds the
    device pool: four 1024-token system prompts (numpy seed 0), 32 requests
    round-robin over them, each its system prompt plus a 64-512-token tail,
    budgets 32-128. Returns (prompts, budgets, the page count that holds
    the private pages of the first 8 requests, as prefix hits, beside two
    of the four 16-page prefixes: the four prefixes do not fit beside a
    full batch, so refcount-0 prefixes spill to the host tier and come
    back)."""
    import numpy as np

    rng = np.random.default_rng(0)
    systems = [rng.integers(0, vocab, (SYSTEM_LEN,)) for _ in range(N_SYSTEMS)]
    tails = rng.integers(64, 513, SERVE_INT8_REQUESTS)
    budgets = rng.integers(32, 129, SERVE_INT8_REQUESTS)
    prompts = [np.concatenate([systems[i % N_SYSTEMS],
                               rng.integers(0, vocab, (int(t),))])
               for i, t in enumerate(tails)]
    ps = SERVE_INT8["kv_page_size"]
    n_pfx = SYSTEM_LEN // ps
    private = sum(-(-(SYSTEM_LEN + int(t) + int(b)) // ps) - n_pfx
                  for t, b in list(zip(tails, budgets))[
                      :SERVE_INT8["max_batch_size"]])
    return prompts, budgets, 1 + private + 2 * n_pfx


def phase_serve_int8(pt_pkg):
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = pt_pkg.LlamaConfig.llama3_8b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts, budgets, num_pages = serve_int8_workload(cfg.vocab_size)
    plens = [len(p) for p in prompts]
    sampled = {5, 17}                       # temperature 0.8, top_k 50
    failures = []
    with pt_pkg.ServingEngine(model, kv_num_pages=num_pages, device="cuda",
                              **SERVE_INT8) as se:
        eng = se.engine
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)  # warm
        pa.paged_attention.int8_launches = 0
        steps0 = eng.stats["decode_steps"]
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b), prefix_len=SYSTEM_LEN,
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = []
        for i, f in enumerate(futs):
            try:
                outs.append(f.result(900))
            except Exception as e:  # noqa: BLE001 — counted and reported
                failures.append(f"request {i}: {type(e).__name__}: {e}")
                outs.append(None)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.int8_launches
        steps = eng.stats["decode_steps"] - steps0
        kv = eng.kv_stats()
        restore_failures = eng.stats["restore_failures"]
        peak = torch.cuda.max_memory_allocated()
    breakdown = decode_breakdown(pt_pkg, eng, prompts)
    bf16_page = (kv["page_size"] * 2 * cfg.num_key_value_heads * cfg.head_dim
                 * 2 * cfg.num_hidden_layers)
    bad_len = [i for i, o in enumerate(outs) if o is not None
               and len(o) != plens[i] + budgets[i]]
    bad_tok = [i for i, o in enumerate(outs) if o is not None
               and not ((o >= 0) & (o < cfg.vocab_size)).all()]
    new_tokens = int(sum(len(o) - plens[i] for i, o in enumerate(outs)
                         if o is not None))
    slo = pt_pkg.slo_summary([f for f, o in zip(futs, outs) if o is not None])
    host = kv["host"]
    emit({"phase": "serve_int8", "model": "llama3_8b", "init_s": init_s,
          "engine": dict(SERVE_INT8, kv_num_pages=num_pages),
          "requests": len(prompts), "completed": sum(o is not None
                                                      for o in outs),
          "failed": len(failures), "new_tokens": new_tokens, "wall_s": wall,
          "tok_s": new_tokens / wall, "ttft_p50_ms": slo["ttft_p50_ms"],
          "ttft_p99_ms": slo["ttft_p99_ms"], "tpot_ms": slo["tpot_ms"],
          "decode_steps": steps, "int8_launches": launches,
          "expected_int8_launches": cfg.num_hidden_layers * steps,
          "prefix": kv["prefix"], "host": host,
          "restore_failures": restore_failures,
          "page_bytes": kv["page_bytes"], "kv_bytes": kv["kv_bytes"],
          "bf16_page_bytes": bf16_page,
          "bf16_kv_bytes": bf16_page * (kv["pages_total"] + 1),
          "peak_mem_gb": peak / 1e9, "decode_breakdown": breakdown})
    if failures:
        raise AssertionError("requests failed: " + "; ".join(failures))
    if bad_len or bad_tok:
        raise AssertionError(f"wrong output length {bad_len} / out-of-vocab "
                             f"tokens {bad_tok}")
    if host["spills"] < 1 or host["restores"] < 1:
        raise AssertionError(f"serve_int8: no spill/restore: {host}")
    if steps == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"paged_attention int8 launched {launches} "
                             f"times, expected {cfg.num_hidden_layers} x "
                             f"{steps}")
    return launches


CAPTURE_PARITY_LAYERS = 2     # Llama-3-8B widths at 2 of 32 layers


def phase_capture_parity(pt_pkg):
    """The captured decode chunk against the same body called eagerly, at
    Llama-3-8B widths cut to 2 of 32 layers (bf16 weights), 8 slots, page
    64, max_len 2048, chunk 16. Five arms: bf16 KV, int8 KV, weight-only
    int8 weights (``quant``), ``quant`` with int8 KV, and the contiguous
    layout. In each, engine A runs its decode program (``"decode"``, or
    ``"decode_contig"``; eager warm-up and capture on the first call, then
    replays), engine B calls ``_decode_body()`` directly; both admit the
    same 8 greedy requests (prompts 64-512, budget 56, so every slot ends
    inside the fourth chunk). After each of 4 chunks the tokens, lens,
    active flags, budgets, packed payload and every KV pool (codes and
    scales under int8) must be equal to the bit, and the paged counter
    must move by chunk x layers (by 0 under the contiguous layout). Then three engines with one seed each
    decode two sampled slots (temperature 1.0) for 3 chunks, two through
    the captured program and one through the eager body: the replays'
    tokens must change from chunk to chunk, the two captured engines must
    agree, and the captured chunks' payload, tokens and lens must equal
    the eager body's to the bit (a replay draws what the body draws)."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=CAPTURE_PARITY_LAYERS)
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),))
               for n in rng.integers(64, 513, 8)]
    kw = dict(max_slots=8, chunk=16, page_size=64, max_len=2048,
              device="cuda")

    def pools(eng):
        out = []
        for kc, vc in eng.caches:
            for c in (kc, vc):
                out.extend(c if isinstance(c, tuple) else (c,))
        return out

    result, mismatches = {}, []
    wo = "weight_only_int8"
    for arm, extra in (("bf16", {}), ("int8", dict(kv_quant="int8")),
                       ("wo_int8", dict(quant=wo)),
                       ("wo_int8+kv_int8", dict(quant=wo, kv_quant="int8")),
                       ("contiguous", dict(kv_layout="contiguous"))):
        a = pt_pkg.BatchDecodeEngine(model, **kw, **extra)
        b = pt_pkg.BatchDecodeEngine(model, **kw, **extra)
        for eng in (a, b):
            for p in prompts:
                if not eng._admit(pt_pkg.GenerationRequest(p, 56)):
                    raise AssertionError("capture_parity: admission failed")
        counter = "int8_launches" if a.kv_quant else "launches"
        # the contiguous layout has no page table: no paged launch at all
        expected = (0 if a.kv_layout == "contiguous"
                    else a.chunk * cfg.num_hidden_layers)
        moved = []
        for n in range(4):
            before = getattr(pa.paged_attention, counter)
            a._program(a._decode_key)()
            moved.append(getattr(pa.paged_attention, counter) - before)
            b._decode_body()
            torch.cuda.synchronize()
            for name in ("tokens", "lens", "active", "budgets", "packed"):
                if not torch.equal(getattr(a, name), getattr(b, name)):
                    mismatches.append(f"{arm} chunk {n}: {name}")
            for i, (x, y) in enumerate(zip(pools(a), pools(b))):
                if not torch.equal(x, y):
                    mismatches.append(f"{arm} chunk {n}: pool {i}")
        still_active = int(a.active.sum())
        result[arm] = {
            "launches_per_chunk": moved, "expected_per_chunk": expected,
            "active_after_4_chunks": still_active,
            "capture": a.capture_info()[a._decode_key]}
        if a.quant:
            result[arm]["quantized_weights"] = len(a.quant_meta["quantized"])
        if any(m != expected for m in moved):
            mismatches.append(f"{arm}: launches per chunk {moved}")
        if still_active:
            mismatches.append(f"{arm}: {still_active} slots still "
                              "active after their budgets")
        del a, b
        gc.collect()
        torch.cuda.empty_cache()
    # sampled: two captured engines and one eager body, one seed each
    sampled, eager_differs = [], []
    for run in ("captured", "captured", "eager"):
        eng = pt_pkg.BatchDecodeEngine(model, seed=5,
                                       **dict(kw, max_slots=2))
        for p in prompts[:2]:
            eng._admit(pt_pkg.GenerationRequest(p, 60, temperature=1.0))
        chunks = []
        for _ in range(3):
            if run == "captured":
                eng._program("decode")()
            else:
                eng._decode_body()
            chunks.append(torch.cat([eng.packed, eng.tokens[:, None],
                                     eng.lens[:, None]], 1).clone())
        sampled.append(torch.stack(chunks).cpu())
        del eng
    varies = not torch.equal(sampled[0][1, :, :-3], sampled[0][2, :, :-3])
    reproducible = torch.equal(sampled[0], sampled[1])
    for n in range(3):
        if not torch.equal(sampled[0][n], sampled[2][n]):
            eager_differs.append(n)
    emit({"phase": "capture_parity", "model": "llama3_8b widths",
          "layers": cfg.num_hidden_layers, "slots": 8, "chunk": 16,
          "bit_equal": not mismatches, "mismatches": mismatches[:12],
          "by_kv": result, "sampled_replays_vary": varies,
          "sampled_seed_reproducible": reproducible,
          "sampled_captured_equals_eager": not eager_differs})
    if mismatches:
        raise AssertionError(f"captured and eager chunks differ: "
                             f"{mismatches[:12]}")
    if not (varies and reproducible):
        raise AssertionError(f"sampled replays: vary {varies}, "
                             f"reproducible {reproducible}")
    if eager_differs:
        raise AssertionError(f"sampled chunks {eager_differs}: captured "
                             "replays and the eager body drew differently")


SPEC_SLOTS, SPEC_BUDGET_CAP = 8, 16


def quarter_draft_config(pt_pkg, cfg):
    """The repo's "quarter" draft preset (``build_draft`` in
    tools/serving_bench.py): a quarter of the target's width and depth,
    MLP 4x hidden, head dim 64, the target's vocabulary and dtype. At
    Llama-3-8B: hidden 1024, MLP 4096, 8 layers, 16 heads, 8 KV heads."""
    hidden = max(cfg.hidden_size // 4, 64)
    return pt_pkg.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=hidden,
        intermediate_size=hidden * 4,
        num_hidden_layers=max(cfg.num_hidden_layers // 4, 2),
        num_attention_heads=max(hidden // 64, 4),
        num_key_value_heads=max(hidden // 128, 2),
        max_position_embeddings=cfg.max_position_embeddings, dtype=cfg.dtype)


def verify_tap(eng):
    """Wrap the engine's paged attention so that every W = k+1 call on
    layer 0 (eager, captured and replayed alike) copies its query rows,
    lens, page table and output into static buffers; returns a check that
    holds the last verify's output against ``paged_attention_plain`` over
    layer 0's pools, with the main shape's tolerance (2e-2)."""
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg, k = eng.cfg, eng.spec.k
    S, W = eng.S, k + 1
    h, hd = cfg.num_attention_heads, cfg.head_dim
    layer0 = eng.caches[0]
    k0 = layer0[0][0] if isinstance(layer0[0], tuple) else layer0[0]
    buf = {"q": torch.zeros((S, W, h, hd), dtype=eng._kv_dtype,
                            device="cuda"),
           "out": torch.zeros((S, W, h, hd), dtype=eng._kv_dtype,
                              device="cuda"),
           "lens": torch.zeros_like(eng.lens),
           "table": torch.zeros_like(eng.page_table)}
    attend = eng._attend

    def tapped(q, kp, vp, table, lens, **kw):
        out = attend(q, kp, vp, table, lens, **kw)
        if q.shape[1] == W and kp.data_ptr() == k0.data_ptr():
            for name, t in (("q", q), ("out", out), ("lens", lens),
                            ("table", table)):
                buf[name].copy_(t)
        return out

    eng._attend = tapped

    def check(eng):
        kc, vc = eng.caches[0]
        kw = dict(rep=h // cfg.num_key_value_heads, scale=hd ** -0.5)
        if isinstance(kc, tuple):
            (kc, ks), (vc, vs) = kc, vc
            kw.update(k_scale=ks, v_scale=vs)
        want = pa.paged_attention_plain(buf["q"], kc, vc, buf["table"],
                                        buf["lens"], **kw)
        torch.cuda.synchronize()
        err = float((buf["out"].float() - want.float()).abs().max())
        if not err <= 2e-2:
            raise AssertionError(f"captured verify attention (W={W}) vs "
                                 f"plain: err {err} > 2e-2")
        return {"W": W, "max_abs_err": err, "atol": 2e-2,
                "lens": buf["lens"].tolist()}

    return check


def phase_serve_spec(pt_pkg, ctx):
    """Speculative serving at full width: the serve phase's Llama-3-8B
    (bf16, seeded) behind ``ServingEngine(max_batch_size=8,
    kv_page_size=64, max_len=2048, decode_chunk=16, spec_k=3)`` (W = 4),
    greedy, over 8 of the serve phase's greedy prompts with budgets capped
    at ``SPEC_BUDGET_CAP``, in four runs: the target itself as draft
    (every proposal should be accepted), the "quarter" draft config
    (seeded, near-zero acceptance: a rollback on nearly every step), the
    quarter draft over
    int8 KV (kernel 1q at W = 4), and the target as draft with the draft's
    weights quantized (``draft_quant="weight_only_int8"``: an int8 view of
    the same model proposes, the bf16 target verifies). Each run: every
    future completes at full length, the W = 4 launches equal layers x
    target steps, no page leaks; tokens per target step, acceptance, the run-length histogram,
    the share of tokens equal to the serve phase's for the same prompts
    (reported, not gated: W = 4 and W = 1 round differently in bf16), the
    chunk's wall, device time and idle share, and a captured verify's
    layer-0 attention held against the plain version."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = ctx["model"]
    cfg = model.config
    chosen = sorted(ctx["greedy_outs"])[:SPEC_SLOTS]
    prompts = [ctx["prompts"][i] for i in chosen]
    budgets = [min(int(ctx["budgets"][i]), SPEC_BUDGET_CAP) for i in chosen]
    quarter = quarter_draft_config(pt_pkg, cfg)
    launches = {"launches": 0, "int8_launches": 0}
    runs = []
    launches_by_run = {}
    for name, draft, kv_quant, draft_quant in (
            ("self", model, None, None),
            ("quarter", quarter, None, None),
            ("quarter_int8", quarter, "int8", None),
            ("self_wo_int8", model, None, "weight_only_int8")):
        counter = "int8_launches" if kv_quant else "launches"
        with pt_pkg.ServingEngine(model, max_batch_size=SPEC_SLOTS,
                                  kv_page_size=64, max_len=2048,
                                  decode_chunk=16, draft=draft,
                                  spec_k=SPEC_K, draft_quant=draft_quant,
                                  kv_quant=kv_quant, device="cuda") as se:
            eng = se.engine
            check = verify_tap(eng)
            se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
            st0, run0 = dict(eng.spec.stats), list(eng.spec.runlen)
            setattr(pa.paged_attention, counter, 0)
            steps0, chunks0 = eng.stats["decode_steps"], len(eng.chunk_ms)
            t0 = time.perf_counter()
            futs = [se.submit(p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            outs = [f.result(900) for f in futs]
            wall = time.perf_counter() - t0
            n_launch = getattr(pa.paged_attention, counter)
            steps = eng.stats["decode_steps"] - steps0
            while eng.busy_slots():
                time.sleep(0.01)
            leaked = leaked_pages(eng)
            st = {key: eng.spec.stats[key] - st0[key] for key in st0}
            runlen = [x - y for x, y in zip(eng.spec.runlen, run0)]
            chunk_ms = sorted(eng.chunk_ms[chunks0:])
            slo = pt_pkg.slo_summary(futs)
        # after stop(): the engine thread no longer decodes
        breakdown = decode_breakdown(pt_pkg, eng, prompts, check=check)
        launches[counter] += n_launch
        launches_by_run[name] = n_launch
        bad = [i for i, (o, p, b) in enumerate(zip(outs, prompts, budgets))
               if len(o) != len(p) + b
               or not ((o >= 0) & (o < cfg.vocab_size)).all()]
        same = total = full = 0
        for i, o, p, b in zip(chosen, outs, prompts, budgets):
            ref = ctx["greedy_outs"][i][len(p):len(p) + b]
            got = o[len(p):]
            same += int((ref == got).sum())
            total += b
            full += int(np.array_equal(ref, got))
        new_tokens = int(sum(budgets))
        run = {"draft": name, "kv_quant": kv_quant or "off",
               "draft_quant": draft_quant or "off",
               "draft_model": eng.spec.describe_draft(),
               "wall_s": wall, "new_tokens": new_tokens,
               "tok_s": new_tokens / wall, "tpot_ms": slo["tpot_ms"],
               "target_steps": st["target_steps"],
               "tokens_per_target_step": (st["emitted"] / st["target_steps"]
                                          if st["target_steps"] else None),
               "acceptance": (st["accepted"] / st["proposed"]
                              if st["proposed"] else None),
               "rollbacks": st["rollbacks"], "runlen_histogram": runlen,
               "decode_steps": steps, "w4_launches": n_launch,
               "expected_w4_launches": cfg.num_hidden_layers * steps,
               "spec_chunk_ms_p50": chunk_ms[len(chunk_ms) // 2]
               if chunk_ms else None,
               "agree_share_vs_serve": same / total,
               "requests_equal_to_serve": full, "pages_leaked": leaked,
               "breakdown": breakdown}
        runs.append(run)
        emit({"phase": "serve_spec", **run})
        if bad:
            raise AssertionError(f"serve_spec {name}: wrong length or "
                                 f"out-of-vocab output in requests {bad}")
        if steps == 0 or n_launch != cfg.num_hidden_layers * steps:
            raise AssertionError(f"serve_spec {name}: W=4 kernel launched "
                                 f"{n_launch} times, expected "
                                 f"{cfg.num_hidden_layers} x {steps}")
        if leaked:
            raise AssertionError(f"serve_spec {name}: {leaked} pages leaked")
        del eng, se
        gc.collect()
        torch.cuda.empty_cache()
    launches["by_run"] = launches_by_run
    return launches


QUANT_LAYERS = 2      # Llama-3-8B widths at 2 of 32 layers
QUANT_LOGIT_ATOL = 0.25   # bf16 end to end against f32 (the serve gap's)
WO = "weight_only_int8"


def phase_quant_parity(pt_pkg):
    """Weight-only int8 at Llama-3-8B widths cut to 2 of 32 layers (bf16,
    seeded), per channel and ``quant_group_size=128``: the codes and scales
    ``quantize_param_tree`` makes on the card equal, bit for bit, those the
    port's plain path makes from the same weights on the CPU; then a
    quantized engine's first-step logits (the admission's prefill row and
    the first decode step, through the engine's int8 view) against an f32
    copy of the model whose projections hold the dequantized weights
    (``weight_dequantize``), within ``QUANT_LOGIT_ATOL``; the argmax agreement
    is reported. The caller's model must still give its full-precision
    logits after the engines were built on it."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.nn import quant as nq

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=QUANT_LAYERS)
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    state = dict(model.named_parameters())
    state.update(dict(model.named_buffers()))
    rng = np.random.default_rng(17)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, 300)),
                          device="cuda")
    with torch.no_grad():
        before = model.logits(model.model(ids)[:, -1])
    out, problems = {}, []
    for group in (-1, 128):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qstate, meta = nq.quantize_param_tree(state, group_size=group)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        unequal = []
        for name in meta["quantized"]:
            q_cpu, s_cpu = nq.weight_quantize(state[name].detach().cpu(),
                                              group_size=group)
            qw = qstate[name]
            if not (torch.equal(qw.q.cpu(), q_cpu)
                    and torch.equal(qw.scale.cpu(), s_cpu)):
                unequal.append(name)
        cpu_s = time.perf_counter() - t0
        reciprocal = None     # what a Python-scalar divisor would round
        if group == -1:       # differently, on the first weight
            first = meta["quantized"][0]
            amax = state[first].detach().float().abs().amax(dim=0)
            reciprocal = int((qstate[first].scale != amax / 127.0).sum())
        # the f32 reference: dequantized projections, the rest cast to f32
        ref = pt_pkg.LlamaForCausalLM(dataclasses.replace(cfg,
                                                          dtype="float32"),
                                      device="cuda")
        with torch.no_grad():
            for name, p in ref.named_parameters():
                src = qstate[name]
                p.copy_(nq.weight_dequantize(src.q, src.scale,
                                             group_size=group)
                        if isinstance(src, nq.QuantizedWeight)
                        else src.float())
        del qstate
        eng = pt_pkg.BatchDecodeEngine(model, max_slots=1, max_len=2048,
                                       page_size=64, quant=WO,
                                       quant_group_size=group, device="cuda")
        if eng.quant_meta != meta:
            problems.append(f"group {group}: engine meta != tree meta")
        kvh, hd = cfg.num_key_value_heads, cfg.head_dim
        with torch.no_grad():
            scratch = [(torch.zeros((1, ids.shape[1], kvh, hd),
                                    dtype=model.dtype, device="cuda"),
                        torch.zeros((1, ids.shape[1], kvh, hd),
                                    dtype=model.dtype, device="cuda"))
                       for _ in range(cfg.num_hidden_layers)]
            hidden, _ = eng.net.model(ids, caches=scratch, pos=0)
            prefill = eng.net.logits(hidden[:, -1]).float()
            eng._admit(pt_pkg.GenerationRequest(ids[0].cpu().numpy(), 4))
            first = int(eng._first_pending[0])
            step = eng._forward_paged(eng.tokens[:, None],
                                      eng.lens)[0, 0].float()
            ext = torch.cat([ids, torch.tensor([[first]], device="cuda")], 1)
            want = ref.logits(ref.model(ext))[0]
        errs = {"prefill": float((prefill[0] - want[-2]).abs().max()),
                "first_step": float((step - want[-1]).abs().max())}
        agree = {"prefill": int(prefill[0].argmax()) == int(want[-2].argmax()),
                 "first_step": int(step.argmax()) == int(want[-1].argmax())}
        out[str(group)] = {
            "quantized": len(meta["quantized"]),
            "bytes_fp": meta["bytes_fp"], "bytes_q": meta["bytes_q"],
            "bytes_saved": meta["bytes_saved"],
            "quantize_card_s": card_s, "check_on_cpu_s": cpu_s,
            "codes_scales_bit_equal": not unequal,
            "first_weight_scales_a_scalar_divisor_rounds_differently":
            reciprocal,
            "logit_max_abs_err": errs, "atol": QUANT_LOGIT_ATOL,
            "argmax_agrees": agree}
        if unequal:
            problems.append(f"group {group}: card codes/scales differ from "
                            f"the CPU's in {unequal[:4]}")
        for k, e in errs.items():
            if not e <= QUANT_LOGIT_ATOL:
                problems.append(f"group {group}: {k} logits err {e} > "
                                f"{QUANT_LOGIT_ATOL}")
        del ref, eng
        gc.collect()
        torch.cuda.empty_cache()
    with torch.no_grad():
        after = model.logits(model.model(ids)[:, -1])
    unchanged = torch.equal(before, after)
    kv = kv_quant_card_vs_cpu()
    emit({"phase": "quant_parity", "model": "llama3_8b widths",
          "layers": QUANT_LAYERS, "by_group_size": out,
          "model_unchanged": unchanged, "kv_int8": kv})
    if not (kv["pages_bit_equal"] and kv["scatter_bit_equal"]):
        problems.append(f"int8 KV quantization card vs CPU: {kv}")
    if not unchanged:
        problems.append("the caller's model changed under the engines")
    if problems:
        raise AssertionError("quant_parity: " + "; ".join(problems))


def kv_quant_card_vs_cpu() -> dict:
    """The int8 KV page quantization on the card against the CPU, bit for
    bit: ``_kv_quant_pages`` over 64 pages of [64, 8, 128] (f32, seeded),
    then ``_kv_quant_scatter`` of one row a slot for 8 slots, with rows
    large enough to grow the scales. Also counts the page scales that
    ``amax / 127.0`` (a Python-scalar divisor: the card multiplies by its
    reciprocal) would round differently from the division."""
    import torch

    from paddlepaddle_tpu_torch.inference import decode_engine as de

    g = torch.Generator().manual_seed(3)
    pages = torch.randn((64, 64, 8, 128), generator=g)
    rows = torch.randn((8, 1, 8, 128), generator=g) * 3.0
    phys = torch.arange(1, 9)[:, None]
    off = torch.full((8, 1), 5)
    out = {}
    for dev in ("cpu", "cuda"):
        codes, scale = de._kv_quant_pages(pages.to(dev))
        pc, ps = codes.clone(), scale.clone()
        de._kv_quant_scatter(codes, scale, rows.to(dev), phys.to(dev),
                             off.to(dev))
        out[dev] = [t.cpu() for t in (pc, ps, codes, scale)]
    amax = pages.cuda().abs().amax(dim=(1, 3))
    reciprocal = int((amax / 127.0 != out["cuda"][1].cuda()).sum())
    return {"pages_bit_equal": all(torch.equal(a, b) for a, b in
                                   zip(out["cpu"][:2], out["cuda"][:2])),
            "scatter_bit_equal": all(torch.equal(a, b) for a, b in
                                     zip(out["cpu"][2:], out["cuda"][2:])),
            "scales": int(amax.numel()),
            "scales_a_scalar_divisor_rounds_differently": reciprocal}


def wo_matmul_case() -> dict:
    """The weight-only product at the serve decode's widest shape, ``[8,
    4096] x [4096, 14336]`` (gate/up), bf16 activations over int8 codes
    with per-channel scales: ``QuantizedWeight.wo_matmul`` (int8 -> bf16
    copy, bf16 matmul, scale on the product) against the f32 product over
    the dequantized weight (max error relative to the largest output,
    within 2e-2), timed beside the bf16 matmul ``serve`` runs on the same
    widths. Bound: the int8 codes, scales, x and out once at 3.35 TB/s, or
    the product at the bf16 rate, the larger."""
    import torch

    from paddlepaddle_tpu_torch.nn import quant as nq

    gen = torch.Generator(device="cuda").manual_seed(0)
    m, k, n = 8, 4096, 14336
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.02).to(
        torch.bfloat16)
    q, sc = nq.weight_quantize(w)
    qw = nq.QuantizedWeight(q, sc, out_dtype=torch.bfloat16)
    got = qw.wo_matmul(x).float()
    want = x.float() @ nq.weight_dequantize(q, sc)
    rel = float((got - want).abs().max() / want.abs().max())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    ms = median_ms(lambda: qw.wo_matmul(x), flush=flush)
    bf16_ms = median_ms(lambda: torch.matmul(x, w), flush=flush)
    bytes_ = q.numel() + sc.numel() * 4 + (m * k + m * n) * 2
    flops = 2 * m * k * n
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    del flush
    out = {"shape": [m, k, n], "ms": ms, "bf16_matmul_ms": bf16_ms,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ / HBM_BYTES_PER_S
           >= flops / BF16_FLOP_PER_S else "operations",
           "bytes": bytes_, "bytes_moved_by_composition":
           q.numel() * (1 + 2 + 2) + sc.numel() * 4 + (m * k + m * n) * 2,
           "max_rel_err": rel, "rtol_of_max": 2e-2}
    if not rel <= 2e-2:
        raise AssertionError(f"wo_matmul vs f32 over the dequantized "
                             f"weight: {rel} > 2e-2 of the largest output")
    return out


def phase_serve_wo_int8(pt_pkg, ctx):
    """The serve phase's configuration and its 24 requests, unchanged, with
    ``quant="weight_only_int8"`` (per channel): Llama-3-8B, 32 layers, bf16
    KV, 8 slots, page 64, chunk 16, over the serve phase's model (the engine
    quantizes into its own view; the model is shared). Every future
    completes at full length with in-vocab tokens, and kernel 1 ran 32
    layers x decode steps times. Printed beside the serve phase's numbers
    from this same run: tok/s, TTFT, the chunk's wall, device time by kind
    and idle share, ``quant_meta``'s byte counts and the weight bound of a
    step, peak memory, the greedy tokens' agreement with serve's (reported,
    not gated), and :func:`wo_matmul_case`."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model, prompts, budgets = ctx["model"], ctx["prompts"], ctx["budgets"]
    sampled = ctx["sampled"]
    cfg = model.config
    n_req = len(prompts)
    plens = [len(p) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    failures = []
    t0 = time.perf_counter()
    with pt_pkg.ServingEngine(model, max_batch_size=8, kv_page_size=64,
                              max_len=2048, decode_chunk=16, quant=WO,
                              device="cuda") as se:
        eng = se.engine
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
        pa.paged_attention.launches = 0
        steps0, chunks0 = eng.stats["decode_steps"], len(eng.chunk_ms)
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b),
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = []
        for i, f in enumerate(futs):
            try:
                outs.append(f.result(900))
            except Exception as e:  # noqa: BLE001 — counted and reported
                failures.append(f"request {i}: {type(e).__name__}: {e}")
                outs.append(None)
        wall = time.perf_counter() - t0
        launches = pa.paged_attention.launches
        steps = eng.stats["decode_steps"] - steps0
        chunk_ms = sorted(eng.chunk_ms[chunks0:])
        peak = torch.cuda.max_memory_allocated()
        meta = eng.quant_meta
    breakdown = decode_breakdown(pt_pkg, eng, prompts)
    del eng, se
    gc.collect()
    torch.cuda.empty_cache()
    same = total = 0
    for i, ref in ctx["greedy_outs"].items():
        if outs[i] is not None:
            same += int((outs[i][plens[i]:] == ref[plens[i]:]).sum())
            total += int(budgets[i])
    new_tokens = int(sum(len(o) - plens[i] for i, o in enumerate(outs)
                         if o is not None))
    slo = pt_pkg.slo_summary([f for f, o in zip(futs, outs) if o is not None])
    wo = wo_matmul_case()
    summary = {"tok_s": new_tokens / wall, "wall_s": wall,
               "ttft_p50_ms": slo["ttft_p50_ms"], "tpot_ms": slo["tpot_ms"],
               "peak_mem_gb": peak / 1e9,
               "chunk_wall_ms": breakdown["chunk_wall_ms"],
               "device_busy_ms": breakdown["device_busy_ms"],
               "device_idle_share": breakdown["device_idle_share"],
               "device_ms_by_kind": breakdown["device_ms_by_kind"]}
    bad_len = [i for i, o in enumerate(outs) if o is not None
               and len(o) != plens[i] + budgets[i]]
    bad_tok = [i for i, o in enumerate(outs) if o is not None
               and not ((o >= 0) & (o < cfg.vocab_size)).all()]
    emit({"phase": "serve_wo_int8", "model": "llama3_8b",
          "quant": WO, "quantize_s": quant_s, "requests": n_req,
          "completed": sum(o is not None for o in outs),
          "failed": len(failures), "new_tokens": new_tokens,
          "decode_steps": steps, "paged_attention_launches": launches,
          "expected_launches": cfg.num_hidden_layers * steps,
          "decode_chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms
          else None,
          "quant_meta": {k: meta[k] for k in ("bytes_fp", "bytes_q",
                                              "bytes_saved", "group_size")},
          "quantized_weights": len(meta["quantized"]),
          "step_weight_bound_ms": meta["bytes_q"] / HBM_BYTES_PER_S * 1e3,
          "bf16_step_weight_bound_ms":
          meta["bytes_fp"] / HBM_BYTES_PER_S * 1e3,
          "greedy_agree_share_vs_serve": same / total if total else None,
          "wo_matmul": wo, "wo_int8": summary, "serve": ctx["summary"],
          "tok_s_ratio_vs_serve": summary["tok_s"]
          / ctx["summary"]["tok_s"], "decode_breakdown": breakdown})
    if failures:
        raise AssertionError("serve_wo_int8 requests failed: "
                             + "; ".join(failures))
    if bad_len or bad_tok:
        raise AssertionError(f"serve_wo_int8: wrong output length {bad_len} "
                             f"/ out-of-vocab tokens {bad_tok}")
    if steps == 0 or launches != cfg.num_hidden_layers * steps:
        raise AssertionError(f"serve_wo_int8: paged_attention launched "
                             f"{launches} times, expected "
                             f"{cfg.num_hidden_layers} x {steps}")
    return launches, wo


SMALL_LAYERS = 2          # the f32 token-equality checks: 2 of 32 layers


def small_f32_model(pt_pkg):
    """Llama-3-8B widths at 2 of 32 layers in f32 (seeded): the model the
    static, generate and layout checks compare greedy tokens on. Two
    decoders are two rounding orders; in bf16 a near-tie on random weights
    flips an argmax and the rest of a stream follows, in f32 they agree."""
    import dataclasses

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=SMALL_LAYERS,
                              dtype="float32")
    return pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=1, init_std=0.02)


STATIC_PROMPT, STATIC_NEW, STATIC_BATCH = 512, 64, 8
STATIC_LOOP_STEPS = 16     # single-position steps the idle share is read on


def phase_serve_static(pt_pkg, ctx, small):
    """``ServingEngine(mode="static")`` over the serve phase's Llama-3-8B
    (32 layers, bf16): 8 same-length prompts of 512 tokens, 64 new tokens
    each, greedy, one ``generate_cached`` batch (its eager per-token loop:
    a prefill, then one single-position step a token over contiguous
    caches). Every row at full length with in-vocab tokens; tok/s, TTFT
    (the batch's latency; TPOT is None without streaming), and the per-token
    loop's device idle share: 16 steps' device time (torch.profiler) over
    their unprofiled wall, each the difference of a 17-token and a 1-token
    call on the same batch. ``generate`` (kernel 2 at
    every step) on one prompt for 4 tokens at full width: the flash forward
    counter moves by 32 x 4. Then on the 2-layer f32 model: the static
    engine's greedy tokens equal the continuous engine's (paged kernel) on
    the same prompts, and ``generate``'s (counter > 0) equal
    ``generate_cached``'s."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = ctx["model"]
    cfg = model.config
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, (STATIC_PROMPT,))
               for _ in range(STATIC_BATCH)]
    with pt_pkg.ServingEngine(model, mode="static",
                              max_batch_size=STATIC_BATCH,
                              max_wait_ms=500) as se:
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)  # warm
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=STATIC_NEW) for p in prompts]
        outs = [f.result(900) for f in futs]
        wall = time.perf_counter() - t0
        batches = se.stats["batches"]
        slo = pt_pkg.slo_summary(futs)
        tpots = [f.slo()["tpot_s"] for f in futs]
    # the per-token loop alone: a prefill-only call (1 new token) and a
    # 17-token one, unprofiled walls and profiled device time; their
    # difference is 16 single-position steps
    ids = np.stack(prompts)
    walls, busy = {}, {}
    for n in (1, STATIC_LOOP_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate_cached(ids, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        walls[n] = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.generate_cached(ids, max_new_tokens=n, temperature=0.0)
            torch.cuda.synchronize()
        busy[n] = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      ) / 1e3
    n = STATIC_LOOP_STEPS + 1
    step_wall = (walls[n] - walls[1]) / STATIC_LOOP_STEPS
    step_busy = (busy[n] - busy[1]) / STATIC_LOOP_STEPS
    # kernel 2 at full width: generate's full forward a token
    fa.flash_fwd.launches = 0
    g = model.generate(prompts[0][None, :512], max_new_tokens=4,
                       temperature=0.0)
    full_launches = fa.flash_fwd.launches
    # the 2-layer f32 checks
    scfg = small.config
    sp = [rng.integers(0, scfg.vocab_size, (STATIC_PROMPT,))
          for _ in range(STATIC_BATCH)]
    with pt_pkg.ServingEngine(small, mode="static",
                              max_batch_size=STATIC_BATCH,
                              max_wait_ms=500) as se:
        static = [np.asarray(f.result(900)) for f in
                  [se.submit(p, max_new_tokens=STATIC_NEW) for p in sp]]
        small_batches = se.stats["batches"]
    eng = pt_pkg.BatchDecodeEngine(small, max_slots=STATIC_BATCH, chunk=16,
                                   page_size=64, max_len=2048, device="cuda")
    paged0 = pa.paged_attention.launches
    reqs = [pt_pkg.GenerationRequest(p, STATIC_NEW) for p in sp]
    eng.serve(reqs, timeout=900)
    cont = [r.result.result(5) for r in reqs]
    paged_launches = pa.paged_attention.launches - paged0
    del eng
    fa.flash_fwd.launches = 0
    gen = small.generate(np.stack(sp), max_new_tokens=STATIC_NEW,
                         temperature=0.0).numpy()
    small_launches = fa.flash_fwd.launches
    static_eq_cont = all(np.array_equal(a, b) for a, b in zip(static, cont))
    gen_eq_cached = all(np.array_equal(a, b) for a, b in zip(gen, static))
    new_tokens = STATIC_BATCH * STATIC_NEW
    bad = [i for i, o in enumerate(outs)
           if len(o) != STATIC_PROMPT + STATIC_NEW
           or not ((o >= 0) & (o < cfg.vocab_size)).all()]
    emit({"phase": "serve_static", "model": "llama3_8b", "batch":
          STATIC_BATCH, "prompt": STATIC_PROMPT, "new": STATIC_NEW,
          "wall_s": wall, "tok_s": new_tokens / wall,
          "ttft_p50_ms": slo["ttft_p50_ms"], "ttft_p99_ms": slo["ttft_p99_ms"],
          "tpot": tpots[0], "batches_incl_warmup": batches,
          "prefill_call_wall_ms": walls[1],
          "prefill_call_device_ms": busy[1],
          "loop_step_wall_ms": step_wall, "loop_step_device_ms": step_busy,
          "loop_device_idle_share": 1 - step_busy / step_wall,
          "generate_full_width": {"tokens": g.numpy()[0, 512:].tolist(),
                                  "flash_fwd_launches": full_launches,
                                  "expected": cfg.num_hidden_layers * 4},
          "f32_2_layers": {"static_equals_continuous": static_eq_cont,
                           "generate_equals_generate_cached": gen_eq_cached,
                           "static_batches": small_batches,
                           "continuous_paged_launches": paged_launches,
                           "generate_flash_fwd_launches": small_launches}})
    problems = []
    if bad:
        problems.append(f"wrong length or out-of-vocab rows {bad}")
    if batches != 2 or any(t is not None for t in tpots):
        problems.append(f"batches {batches} (warm-up + 1 expected), tpot "
                        f"{tpots[:2]}")
    if full_launches != cfg.num_hidden_layers * 4:
        problems.append(f"generate launched kernel 2 {full_launches} times, "
                        f"expected {cfg.num_hidden_layers} x 4")
    if not (static_eq_cont and gen_eq_cached):
        problems.append(f"f32 tokens: static == continuous {static_eq_cont}"
                        f", generate == generate_cached {gen_eq_cached}")
    if small_launches == 0 or paged_launches == 0:
        problems.append("the 2-layer checks launched no kernel")
    if problems:
        raise AssertionError("serve_static: " + "; ".join(problems))
    return full_launches + small_launches


CONTIG_REQUESTS = 8


def phase_serve_contiguous(pt_pkg, ctx, small):
    """``kv_layout="contiguous"`` over the serve phase's Llama-3-8B (32
    layers, bf16, 8 slots, max_len 2048, chunk 16) on the first 8 of its
    requests (same sampling): every future at full length with in-vocab
    tokens, the paged kernel's counters unmoved (the layout has no page
    table; decode runs the model's cached attention); tok/s, the chunk's
    wall and the pool's bytes against a paged pool of the same capacity.
    Then on the 2-layer f32 model, 8 greedy requests: the contiguous
    engine's tokens and the ``fused_kernels=False`` engine's (plain paged
    attention) equal the paged kernel engine's, and only the latter moved
    the paged counter."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = ctx["model"]
    cfg = model.config
    prompts = ctx["prompts"][:CONTIG_REQUESTS]
    budgets = ctx["budgets"][:CONTIG_REQUESTS]
    sampled = ctx["sampled"]
    plens = [len(p) for p in prompts]
    pa.paged_attention.launches = pa.paged_attention.int8_launches = 0
    with pt_pkg.ServingEngine(model, max_batch_size=8, max_len=2048,
                              decode_chunk=16, kv_layout="contiguous",
                              device="cuda") as se:
        eng = se.engine
        se.generate(prompts[0][:16], max_new_tokens=2, timeout=600)  # warm
        chunks0 = len(eng.chunk_ms)
        t0 = time.perf_counter()
        futs = [se.submit(p, max_new_tokens=int(b),
                          temperature=0.8 if i in sampled else 0.0,
                          top_k=50 if i in sampled else 0)
                for i, (p, b) in enumerate(zip(prompts, budgets))]
        outs = [f.result(900) for f in futs]
        wall = time.perf_counter() - t0
        chunk_ms = sorted(eng.chunk_ms[chunks0:])
        kv = eng.kv_stats()
        capture = eng.capture_info()
        slo = pt_pkg.slo_summary(futs)
    del eng, se
    gc.collect()
    torch.cuda.empty_cache()
    full_launches = (pa.paged_attention.launches,
                     pa.paged_attention.int8_launches)
    per_tok = 2 * cfg.num_key_value_heads * cfg.head_dim * 2 \
        * cfg.num_hidden_layers
    paged_pool_bytes = (8 * -(-2048 // 64) + 1) * 64 * per_tok
    # 2-layer f32: three attention routes, one stream of tokens
    rng = np.random.default_rng(12)
    sp = [rng.integers(0, small.config.vocab_size, (int(n),))
          for n in rng.integers(64, 513, 8)]
    tokens, moved = {}, {}
    for name, kw in (("paged_kernel", {}),
                     ("contiguous", dict(kv_layout="contiguous")),
                     ("fused_kernels_false", dict(fused_kernels=False))):
        n0 = pa.paged_attention.launches
        e = pt_pkg.BatchDecodeEngine(small, max_slots=8, chunk=16,
                                     page_size=64, max_len=2048,
                                     device="cuda", **kw)
        reqs = [pt_pkg.GenerationRequest(p, 48) for p in sp]
        e.serve(reqs, timeout=900)
        tokens[name] = [r.result.result(5) for r in reqs]
        moved[name] = pa.paged_attention.launches - n0
        del e
    equal = {n: all(np.array_equal(a, b) for a, b in
                    zip(tokens[n], tokens["paged_kernel"]))
             for n in ("contiguous", "fused_kernels_false")}
    new_tokens = int(sum(budgets))
    bad = [i for i, o in enumerate(outs) if len(o) != plens[i] + budgets[i]
           or not ((o >= 0) & (o < cfg.vocab_size)).all()]
    emit({"phase": "serve_contiguous", "model": "llama3_8b",
          "requests": CONTIG_REQUESTS, "new_tokens": new_tokens,
          "wall_s": wall, "tok_s": new_tokens / wall,
          "ttft_p50_ms": slo["ttft_p50_ms"], "tpot_ms": slo["tpot_ms"],
          "decode_chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms
          else None, "kv": kv, "paged_pool_bytes_same_capacity":
          paged_pool_bytes, "capture": capture,
          "paged_launches": full_launches,
          "f32_2_layers": {"equal_to_paged_kernel": equal,
                           "paged_launches": moved}})
    problems = []
    if bad:
        problems.append(f"wrong length or out-of-vocab rows {bad}")
    if any(full_launches):
        problems.append(f"paged counters moved {full_launches}")
    if not all(equal.values()):
        problems.append(f"f32 tokens differ from the paged kernel's: {equal}")
    if moved["paged_kernel"] == 0 or moved["contiguous"] \
            or moved["fused_kernels_false"]:
        problems.append(f"paged launches by route {moved}")
    if problems:
        raise AssertionError("serve_contiguous: " + "; ".join(problems))


ROBUST_LAYERS = 2


def phase_serve_robust(pt_pkg):
    """The protection layer on the card: Llama-3-8B widths at 2 of 32
    layers (bf16, seeded), ``ServingEngine(max_batch_size=8,
    kv_page_size=64, max_len=2048, decode_chunk=16)``, captured chunks.
    Three greedy requests (prompts 200-400, 96 new) run undisturbed first;
    then, each in a fresh engine whose chunks are held 20 ms on the host
    (so each event lands mid-decode), beside the same three: a fourth
    request with a 1 s deadline and 1200 new tokens (DeadlineExceededError
    after admission); a fourth request cancelled once decoding
    (RequestCancelledError); and ``drain()`` with the three in flight (they
    finish; a submit after it raises EngineDrainingError). After each, the
    pool's free count is back at ``usable`` and the three requests' tokens
    equal the undisturbed run's. The checks are structural: no timing
    threshold decides them. ``health()`` is printed while serving and
    after the drain."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.inference import robustness as rob

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=ROBUST_LAYERS)
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    rng = np.random.default_rng(13)
    three = [rng.integers(0, cfg.vocab_size, (n,)) for n in (200, 300, 400)]
    doomed_prompt = rng.integers(0, cfg.vocab_size, (300,))
    kw = dict(max_batch_size=8, kv_page_size=64, max_len=2048,
              decode_chunk=16, device="cuda")

    def slowed(se, hold_s):
        chunk = se.engine._decode_chunk

        def held():
            time.sleep(hold_s)
            chunk()

        se.engine._decode_chunk = held

    def wait(pred, timeout=120.0):
        end = time.time() + timeout
        while time.time() < end and not pred():
            time.sleep(0.005)
        return pred()

    with pt_pkg.ServingEngine(model, **kw) as se:
        want = [f.result(900) for f in
                [se.submit(p, max_new_tokens=96) for p in three]]
    events, problems = {}, []
    for event in ("deadline", "cancel", "drain"):
        se = pt_pkg.ServingEngine(model, **kw)
        eng = se.engine
        try:
            slowed(se, 0.02)
            futs = [se.submit(p, max_new_tokens=96) for p in three]
            info = {}
            if event == "deadline":
                doomed = se.submit(doomed_prompt, max_new_tokens=1200,
                                   deadline_s=1.0)
            elif event == "cancel":
                doomed = se.submit(doomed_prompt, max_new_tokens=1200)
                wait(lambda: eng.busy_slots() == 4
                     and eng.stats["decode_calls"] > 1)
                info["cancel_returned"] = doomed.cancel()
            if event == "drain":
                wait(lambda: eng.busy_slots() == 3)
                info["health_serving"] = se.health()
                info["drain"] = se.drain(timeout=300)
                try:
                    se.submit(three[0], max_new_tokens=4)
                    info["submit_after_drain"] = "accepted"
                except rob.EngineDrainingError:
                    info["submit_after_drain"] = "EngineDrainingError"
                info["health_after"] = se.health()
            else:
                try:
                    doomed.result(120)
                    info["doomed"] = "completed"
                except rob.ServingError as e:
                    info["doomed"] = type(e).__name__
                    info["message"] = str(e)
                info["doomed_admitted"] = doomed.slo()["ttft_s"] is not None
            outs = [f.result(900) for f in futs]
            wait(lambda: eng.busy_slots() == 0)
            info["others_equal_undisturbed"] = all(
                np.array_equal(a, b) for a, b in zip(outs, want))
            info["pages_free"] = eng.pool.free_count
            info["pages_usable"] = eng.pool.usable
            info["stats"] = dict(se.stats)
        finally:
            se.stop()
        events[event] = info
        if not info["others_equal_undisturbed"]:
            problems.append(f"{event}: the other requests' tokens changed")
        held = info["pages_usable"] - info["pages_free"]
        if held:
            problems.append(f"{event}: {held} pages not returned")
    expect = {"deadline": "DeadlineExceededError",
              "cancel": "RequestCancelledError"}
    for event, err in expect.items():
        if events[event].get("doomed") != err \
                or not events[event]["doomed_admitted"]:
            problems.append(f"{event}: {events[event].get('doomed')}, "
                            f"admitted {events[event]['doomed_admitted']}")
    d = events["drain"]
    if not d["drain"]["clean"] \
            or d["submit_after_drain"] != "EngineDrainingError":
        problems.append(f"drain: {d['drain']}, {d['submit_after_drain']}")
    emit({"phase": "serve_robust", "model": "llama3_8b widths",
          "layers": ROBUST_LAYERS, "events": events})
    del model
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError("serve_robust: " + "; ".join(problems))


# ---------------------------------------------------------------------------
# the serving fleet: a router over in-process replicas and a replica process
# ---------------------------------------------------------------------------

FLEET_LAYERS = 2
FLEET_ENGINE = dict(max_batch_size=4, kv_page_size=64, max_len=1024,
                    decode_chunk=8)


def _fleet_wait(pred, timeout):
    end = time.monotonic() + timeout
    while time.monotonic() < end and not pred():
        time.sleep(0.01)
    return pred()


def _fleet_settle(futs, wants):
    """(requests equal to their expected tokens, typed failure names, other
    failures) over ``futs``."""
    import numpy as np

    from paddlepaddle_tpu_torch.inference import robustness as rob

    equal, typed, other = 0, [], []
    for f, w in zip(futs, wants):
        try:
            equal += bool(np.array_equal(f.result(900), w))
        except rob.ServingError as e:
            typed.append(type(e).__name__)
        except Exception as e:  # noqa: BLE001 — reported
            other.append(f"{type(e).__name__}: {e}"[:200])
    return equal, typed, other


def phase_fleet_parity(pt_pkg):
    """The fleet on the card at Llama-3-8B widths, 2 of 32 layers, f32 (see
    the phase list). Returns the paged launches this process made."""
    import dataclasses
    import os
    import signal
    import threading

    from paddlepaddle_tpu_torch.inference import (ProcessReplicaFactory,
                                                  ReplicaClient,
                                                  ServingRouter)
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    import numpy as np

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=FLEET_LAYERS,
                              dtype="float32")
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    per_replay = {"launches": FLEET_LAYERS * FLEET_ENGINE["decode_chunk"]}
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, (int(n),))
               for n in rng.integers(32, 400, 12)]
    budget, long_budget = 48, 320

    def local():
        return pt_pkg.ServingEngine(model, device="cuda", **FLEET_ENGINE)

    ref = local()
    ref.warmup()
    want = [ref.generate(p, max_new_tokens=budget, timeout=600)
            for p in prompts]
    want_long = [ref.generate(p, max_new_tokens=long_budget, timeout=600)
                 for p in prompts[:6]]
    ref.stop()
    del ref

    overlap, engines = [], []

    class Observed(ReplicaClient):
        """An in-process replica whose warmup (the capture) records the
        decode slots busy on the other in-process replicas when it began
        and the graph replays they ran while it lasted."""

        def warmup(self):
            others = [rep.client.engine.engine for rep in router._replicas
                      if isinstance(rep.client, Observed)
                      and rep.client is not self]

            def replays():
                return sum(e.capture_info().get("decode", {}).get(
                    "replays", 0) for e in others)

            busy, r0 = sum(e.busy_slots() for e in others), replays()
            info = super().warmup()
            overlap.append({"replica": self.name,
                            "busy_slots_elsewhere": busy,
                            "replays_elsewhere_meanwhile": replays() - r0})
            engines.append(self.engine.engine)
            return info

    factory = ProcessReplicaFactory(
        preset="tiny", model_json=json.dumps(dataclasses.asdict(cfg)),
        engine_json=json.dumps(FLEET_ENGINE), warmup="off",
        supervisor_kw=dict(ready_timeout_s=600.0, term_grace_s=60.0),
        client_kw=dict(read_timeout_s=600.0, heartbeat_timeout_s=30.0))
    remote = factory(name="proc")
    sup = remote.supervisor
    router = ServingRouter([Observed(local, name="r0"),
                            Observed(local, name="r1"), remote],
                           probe_interval_s=0.05, hedge_after_s=None,
                           breaker_reset_s=0.5)
    problems, info = [], {}
    t0 = time.perf_counter()
    try:
        router.start()
        info["start_s"] = time.perf_counter() - t0
        for rep in router._replicas[:2]:
            rep.client.warmup()
        overlap.clear()
        launches0 = pa.paged_attention.launches

        # 1. token parity through the router
        futs = [router.submit(p, max_new_tokens=budget) for p in prompts]
        equal, typed, other = _fleet_settle(futs, want)
        info["parity"] = {"equal": equal, "requests": len(prompts),
                          "typed": typed, "other": other,
                          "served_by": {rep.name: rep.client.generation
                                        for rep in router._replicas}}
        if equal != len(prompts):
            problems.append(f"parity: {info['parity']}")
        direct = remote.submit(prompts[1], max_new_tokens=budget)
        info["proc_direct_equal"] = bool(np.array_equal(direct.result(900),
                                                        want[1]))
        info["proc_paged_launches"] = \
            remote.health()["kernels"]["paged_attention"]
        if not info["proc_direct_equal"]:
            problems.append("the replica process served other tokens")

        # 2. rolling restart with traffic flowing (about 10 in flight)
        stop, flow, refused = threading.Event(), [], []

        def traffic():
            i = 0
            while not stop.is_set():
                if sum(rep.inflight for rep in router._replicas) >= 10:
                    time.sleep(0.005)
                    continue
                try:
                    flow.append((router.submit(prompts[i % len(prompts)],
                                               max_new_tokens=budget),
                                 want[i % len(prompts)]))
                except Exception as e:  # noqa: BLE001 — reported
                    refused.append(f"{type(e).__name__}: {e}"[:200])
                i += 1

        th = threading.Thread(target=traffic, daemon=True)
        th.start()
        _fleet_wait(lambda: len(flow) >= 10, 60)
        t1 = time.perf_counter()
        rr = router.rolling_restart(drain_timeout=600, health_timeout=600)
        info["rolling_restart_s"] = time.perf_counter() - t1
        stop.set()
        th.join(60)
        equal, typed, other = _fleet_settle([f for f, _ in flow],
                                            [w for _, w in flow])
        info["rolling"] = {
            "ok": rr["ok"], "requests": len(flow), "equal": equal,
            "typed": typed, "other": other, "refused_at_submit": refused,
            "replicas": [{k: x[k] for k in ("replica", "ok", "generation",
                                           "wall_s")} for x in rr["replicas"]],
            "captures_began_with": list(overlap)}
        if not rr["ok"] or equal != len(flow) or refused:
            problems.append(f"rolling restart: {info['rolling']}")
        graphs = {f"{rep.name}.gen{rep.client.generation}":
                  rep.client.engine.engine.capture_info()["decode"]
                  ["launches_per_replay"] for rep in router._replicas[:2]}
        info["launches_per_replay"] = graphs
        info["expected_launches_per_replay"] = per_replay
        if any(g != per_replay for g in graphs.values()):
            problems.append(f"launches a replay {graphs}, expected "
                            f"{per_replay}")
        if not any(o["replays_elsewhere_meanwhile"] for o in overlap):
            problems.append(f"no capture overlapped another in-process "
                            f"replica's decode: {overlap}")

        # 3. SIGKILL the replica process while it streams
        pid = sup.pid()
        futs = [router.submit(p, max_new_tokens=long_budget)
                for p in prompts[:6]]
        _fleet_wait(lambda: router._replica("proc").inflight > 0, 120)
        info["proc_inflight_at_kill"] = router._replica("proc").inflight
        os.kill(pid, signal.SIGKILL)
        equal, typed, other = _fleet_settle(futs, want_long)
        info["kill"] = {"requests": len(futs), "completed_equal": equal,
                        "typed": typed, "other": other,
                        "failovers": router.stats["failovers"]}
        if other or equal + len(typed) != len(futs):
            problems.append(f"kill: {info['kill']}")
        respawned = _fleet_wait(lambda: sup.pid() not in (None, pid)
                                and sup.state == "serving", 600)
        out = remote.submit(prompts[0], max_new_tokens=budget).result(900)
        child = remote.health()
        info["respawn"] = {"ok": respawned, "supervisor": sup.info(),
                           "kernels": child["kernels"],
                           "tokens_equal": bool(np.array_equal(out,
                                                               want[0]))}
        if not respawned or child["kernels"]["nvcc_runs"] != 0 \
                or child["kernels"]["paged_attention"] <= 0 \
                or not info["respawn"]["tokens_equal"] \
                or not info["proc_paged_launches"]:
            problems.append(f"respawn: {info['respawn']}")

        # 4. no page leaked, and the counter is the replays' launches
        _fleet_wait(lambda: all(e.busy_slots() == 0 for e in engines), 120)
        leaked = {f"{i}": e.pool.used - e.prefix.cached_pages
                  for i, e in enumerate(engines)}
        kv = child["kv"]
        leaked["proc"] = kv["pages_used"] - kv["prefix"]["cached_pages"]
        info["leaked_pages"] = leaked
        if any(leaked.values()):
            problems.append(f"leaked pages: {leaked}")
        launches = pa.paged_attention.launches - launches0
        replays = sum(e.capture_info()["decode"]["replays"] for e in engines)
        info["launches"] = launches
        info["launches_from_replays"] = replays * per_replay["launches"]
        if launches != replays * per_replay["launches"]:
            problems.append(f"paged launches {launches} != replays x "
                            f"{per_replay['launches']}")
    finally:
        router.stop()
    info["wall_s"] = time.perf_counter() - t0
    emit({"phase": "fleet_parity", "model": "llama3_8b widths",
          "layers": FLEET_LAYERS, "dtype": "float32", **info})
    del model
    gc.collect()
    if problems:
        raise AssertionError("fleet_parity: " + "; ".join(problems))
    return info["launches"]


def _fleet_run(submit, ctx):
    """The serve workload through ``submit``: tok/s and the SLO block."""
    prompts, budgets, sampled = ctx["prompts"], ctx["budgets"], ctx["sampled"]
    t0 = time.perf_counter()
    futs = [submit(p, max_new_tokens=int(b),
                   temperature=0.8 if i in sampled else 0.0,
                   top_k=50 if i in sampled else 0)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    outs = [f.result(900) for f in futs]
    wall = time.perf_counter() - t0
    new = int(sum(len(o) - len(p) for o, p in zip(outs, prompts)))
    import paddlepaddle_tpu_torch as pt_pkg

    slo = pt_pkg.slo_summary(futs)
    greedy_equal = all(
        outs[i].tolist() == ctx["greedy_outs"][i].tolist()
        for i in ctx["greedy_outs"])
    return {"tok_s": new / wall, "wall_s": wall, "new_tokens": new,
            "ttft_p50_ms": slo["ttft_p50_ms"], "ttft_p99_ms":
            slo["ttft_p99_ms"], "tpot_ms": slo["tpot_ms"],
            "greedy_equal_serve": greedy_equal}


def phase_serve_fleet(pt_pkg, ctx):
    """Llama-3-8B (the serve model) behind a router over two in-process
    replicas sharing its weights, each with its own KV pool, beside one
    engine alone, in this run (see the phase list). Returns the router
    run's paged launches."""
    import json as _json

    import torch

    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.inference import ServingRouter
    from paddlepaddle_tpu_torch.observability import alerts, tsdb
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    model = ctx["model"]
    layers = model.config.num_hidden_layers
    kw = dict(max_batch_size=8, kv_page_size=64, max_len=2048,
              decode_chunk=16, device="cuda")
    obs.reset()
    obs.enable(trace=False, metrics=True, watchdog_=False)
    obs.enable_history(interval_s=1.0)
    runs, problems = {}, []
    try:
        single = pt_pkg.ServingEngine(model, **kw)
        single.warmup()
        runs["single"] = _fleet_run(single.submit, ctx)
        single.stop()
        del single
        gc.collect()
        router = ServingRouter([lambda: pt_pkg.ServingEngine(model, **kw)
                                for _ in range(2)],
                               probe_interval_s=0.25, hedge_after_s="auto")
        try:
            router.start()
            for rep in router._replicas:
                rep.client.warmup()
            pa.paged_attention.launches = 0
            steps0 = {rep.name: rep.client.engine.engine.stats[
                "decode_steps"] for rep in router._replicas}
            runs["router"] = _fleet_run(router.submit, ctx)
            launches = pa.paged_attention.launches
            per = {}
            for rep in router._replicas:
                eng = rep.client.engine.engine
                d = eng.capture_info()["decode"]
                per[rep.name] = {
                    "requests": rep.client.engine.stats["requests"],
                    "decode_steps": eng.stats["decode_steps"]
                    - steps0[rep.name],
                    "paged_launches": d["replays"]
                    * d["launches_per_replay"].get("launches", 0),
                    "pool_gb": eng.kv_stats()["kv_bytes"] / 1e9}
            time.sleep(2.5)             # two history samples after the run
            hist = tsdb.get()
            hist.observe()
            q = _json.loads(tsdb.query_body(
                "paddle_router_replica_inflight", 60.0)[2])
            fired = [s for s in alerts.get().snapshot()["rules"]
                     if s.get("fired_total") or s.get("state") != "ok"]
            router_health = router.health()["router"]
        finally:
            router.stop()
    finally:
        obs.disable_history()
        obs.disable()
        obs.reset()
    expected = layers * sum(p["decode_steps"] for p in per.values())
    emit({"phase": "serve_fleet", "model": "llama3_8b", "layers": layers,
          "nvidia_smi": nvidia_smi_line(), "single": runs["single"],
          "router": runs["router"],
          "router_over_single_tok_s": runs["router"]["tok_s"]
          / runs["single"]["tok_s"],
          "replicas": per, "paged_launches": launches,
          "expected_launches": expected, "router_stats": router_health,
          "alerts_fired_or_pending": fired,
          "query_paddle_router_replica_inflight": q,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    if launches != expected or sum(p["paged_launches"]
                                   for p in per.values()) != launches:
        problems.append(f"paged launches {launches}, replicas "
                        f"{per}, expected {expected}")
    if router_health["failed"] or not q.get("series"):
        problems.append(f"router {router_health}, /query {q}")
    if problems:
        raise AssertionError("serve_fleet: " + "; ".join(problems))
    return launches


# ---------------------------------------------------------------------------
# the rest of the model zoo: ResNet-50, BERT-base, GPT-2 small
# ---------------------------------------------------------------------------

GPT2_SHAPE = (12, 1024, 12, 64)     # nanoGPT's micro-batch x block, 12 heads
BERT_SHAPE = (32, 128, 12, 64)      # the GLUE fine-tuning batch, 12 heads


def phase_flash_d64():
    """Kernels 2-4 at head dim 64, the width of BERT-base and GPT-2 small
    (768 / 12), in bf16: the three kernels at GPT-2 small's training shape
    (b 12, s 1024, h 12, causal) and the forward at BERT-base's eval shape
    (b 32, s 128, h 12, full), each against the plain version (atol 2e-2),
    timed beside the plain versions, SDPA and the bound (rows 2b-4b)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa

    rng = np.random.default_rng(2)
    gpt, gerrs = flash_main_shape(fa, rng, torch.bfloat16, 2e-2,
                                  suffix="_d64", shape=GPT2_SHAPE)
    bert, berrs = flash_main_shape(fa, rng, torch.bfloat16, 2e-2,
                                   suffix="_d64_bert", shape=BERT_SHAPE,
                                   causal=False)
    records = gpt + bert[:1]
    emit({"phase": "flash_d64", "errs": {"gpt2": gerrs, "bert": berrs},
          "atol": 2e-2, "gpt2": flash_main_summary(gpt),
          "bert_fwd": flash_main_summary(bert[:1])})
    return records


def _rel(card, cpu) -> float:
    return float((card.detach().cpu().float() - cpu.detach().float())
                 .abs().max() / cpu.detach().float().abs().max())


def zoo_resnet_parity(pt_pkg):
    """ResNet(BottleneckBlock, 50, width 16, 10 classes), f32, 4 x 3 x 64 x
    64, the card against the CPU from one state: train-mode logits, one
    Momentum ``TrainStep`` (lr 0.01), the running statistics it updates,
    eval logits over the stepped state. Tolerances as in
    tests/test_torch_zoo.py, where the JAX package's own f32 gradients on
    this model sit 4-5% (of the largest gradient) from an f64 evaluation:
    train-mode logits 1e-3 and the loss 5e-4 of their size, each update
    within 15% of its norm, running statistics 5e-4 of each buffer's
    largest; eval logits 1e-4 (cuDNN may pick Winograd or FFT convolutions,
    which round otherwise than the CPU's direct ones)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import resnet as tr
    from paddlepaddle_tpu_torch.nn import functional as pF

    prandom.seed(0)
    cpu = tr.ResNet(tr.BottleneckBlock, 50, width=16, num_classes=10,
                    device="cpu")
    card = tr.ResNet(tr.BottleneckBlock, 50, width=16, num_classes=10,
                     device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 3, 64, 64),
                                             dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 10, (4,)))
    with torch.no_grad():
        logit_err = _rel(card(x.cuda()), cpu(x))
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    start = {k: v.clone() for k, v in cpu.state_dict().items()}

    def loss_fn(m, a, b):
        return pF.cross_entropy(m(a), b).mean()

    losses, steps = {}, {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        steps[dev] = pt_pkg.TrainStep(
            m, pt_pkg.Momentum(learning_rate=0.01, momentum=0.9,
                               parameters=m.named_parameters()), loss_fn,
            device=dev)
        losses[dev] = float(steps[dev](x, y))
    csd, psd = card.state_dict(), cpu.state_dict()
    params = dict(cpu.named_parameters())
    update = max(float((csd[n].cpu() - psd[n]).norm()
                       / (psd[n] - start[n]).norm()) for n in params)
    stats = max(_rel(csd[k], psd[k]) for k in psd
                if k.endswith(("._mean", "._variance")))
    cpu.load_state_dict({k: v.cpu() for k, v in csd.items()})
    card.eval()
    cpu.eval()
    with torch.no_grad():
        eval_err = _rel(card(x.cuda()), cpu(x))
    out = {"train_logits_rel": logit_err, "losses": losses,
           "loss_rel": abs(losses["cuda"] - losses["cpu"]) / abs(
               losses["cpu"]),
           "update_rel_max": update, "stats_rel": stats,
           "eval_logits_rel": eval_err}
    if not (logit_err <= 1e-3 and out["loss_rel"] <= 5e-4 and update <= 0.15
            and stats <= 5e-4 and eval_err <= 1e-4):
        raise AssertionError(f"ResNet card vs CPU: {out}")
    return out


def _adam_step_close(card, cpu, lr, kbias):
    """One AdamW step of ``card`` against ``cpu`` from one state. Adam's
    first update is ``lr g / (|g| + eps)``, so an element whose gradient is
    near zero moves by up to ``lr`` either way on a rounding difference:
    the gradients (``TrainStep`` leaves them on the parameters) are held
    within 1e-4 of each tensor's largest, the parameters within 2 lr, and
    the share of parameters within 1e-6 is reported. ``kbias(name)`` names
    the slice of a tensor that is a key bias: its gradient is zero up to
    rounding, so it is held against 1% of the largest gradient."""
    import torch

    cpu_p = dict(cpu.named_parameters())
    top = max(float(p.grad.abs().max()) for p in cpu_p.values())
    grad_err, param_err, near, total = 0.0, 0.0, 0, 0
    for n, p in card.named_parameters():
        want = cpu_p[n]
        g = (p.grad.detach().cpu().float() - want.grad.float()).abs()
        scale = float(want.grad.abs().max())
        ks = kbias(n)
        if ks is not None:
            grad_err = max(grad_err, float(g[ks].max()) / (1e-2 * top))
            g[ks] = 0
        grad_err = max(grad_err, float(g.max()) / max(scale, 1e-30))
        d = (p.detach().cpu().float() - want.detach().float()).abs()
        param_err = max(param_err, float(d.max()))
        near += int((d <= 1e-6).sum())
        total += d.numel()
    return {"grad_rel": grad_err, "param_err": param_err,
            "params_within_1e-6": near / total,
            "ok": grad_err <= 1e-4 and param_err <= 2 * lr}


def zoo_bert_parity(pt_pkg):
    """Two layers of BERT-base's widths (hidden 768, 12 heads, d 64,
    intermediate 3072, vocab 30522), f32, dropout 0, b 2, s 128: the
    card's eval logits without a mask (kernel 2, one launch a layer) and
    with a padding mask (plain, no launch) against the CPU's within 1e-4 of
    the largest logit; then one AdamW step (lr 1e-3), loss within 1e-5 of
    its value, gradients and parameters as ``_adam_step_close``; the step
    launches kernels 2-4 once a layer each."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import bert as tb

    cfg = tb.BertConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                        attention_probs_dropout_prob=0.0)
    prandom.seed(1)
    cpu = tb.BertForSequenceClassification(cfg, device="cpu")
    card = tb.BertForSequenceClassification(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128)))
    mask = torch.ones(2, 128, dtype=torch.long)
    mask[1, 90:] = 0
    labels = torch.tensor([0, 1])
    out = {}
    for tag, m_ in (("eval", None), ("eval_masked", mask)):
        card.eval()
        cpu.eval()
        reset_flash_launches()
        with torch.no_grad():
            got = card(ids.cuda(), None, None if m_ is None else m_.cuda())
            torch.cuda.synchronize()
            launches = flash_launches()
            out[tag] = {"logits_rel": _rel(got, cpu(ids, None, m_)),
                        "launches": launches}
    card.train()
    cpu.train()
    lr = 1e-3
    losses = {}
    reset_flash_launches()
    for dev, m in (("cuda", card), ("cpu", cpu)):
        step = pt_pkg.TrainStep(m, pt_pkg.AdamW(
            learning_rate=lr, weight_decay=0.01,
            parameters=m.named_parameters()),
            lambda mm, a, b: mm(a, labels=b), device=dev)
        losses[dev] = float(step(ids, labels))
        if dev == "cuda":
            out["step_launches"] = flash_launches()
    close = _adam_step_close(
        card, cpu, lr,
        lambda n: slice(None) if n.endswith("k_proj.bias") else None)
    out.update({"losses": losses, "step": close})
    L = cfg.num_hidden_layers
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not (close["ok"] and loss_rel <= 1e-5
            and out["eval"]["logits_rel"] <= 1e-4
            and out["eval_masked"]["logits_rel"] <= 1e-4):
        raise AssertionError(f"BERT card vs CPU: {out}")
    if (out["eval"]["launches"]["flash_fwd"] != L
            or any(out["eval_masked"]["launches"].values())
            or any(v != L for v in out["step_launches"].values())):
        raise AssertionError(f"BERT kernel launches: {out}")
    return out


def zoo_gpt_parity(pt_pkg):
    """Two layers of GPT-2 small's widths (hidden 768, 12 heads, d 64,
    vocab 50304, 1024 positions), f32, dropout 0, b 2, s 128: the loss on
    the card (kernels 2-4) against the CPU's within 1e-5 of its value (the
    seeded N(0, 1) tied embedding makes it ~490), one AdamW step
    (lr 1e-3) as ``_adam_step_close``, then 16 greedy tokens from 2
    prompts of 32 equal to the CPU's (kernel 2 once a layer a token)."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import gpt as tg

    cfg = tg.GPTConfig(num_hidden_layers=2, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    prandom.seed(2)
    cpu = tg.GPTForCausalLM(cfg, device="cpu")
    card = tg.GPTForCausalLM(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 128)))
    lr = 1e-3
    losses = {}
    reset_flash_launches()
    for dev, m in (("cuda", card), ("cpu", cpu)):
        step = pt_pkg.TrainStep(m, pt_pkg.AdamW(
            learning_rate=lr, weight_decay=0.01,
            parameters=m.named_parameters()), llm_loss, device=dev)
        losses[dev] = float(step(ids, ids))
        if dev == "cuda":
            step_launches = flash_launches()
    h = cfg.hidden_size
    close = _adam_step_close(
        card, cpu, lr,
        lambda n: slice(h, 2 * h) if n.endswith("qkv_proj.bias") else None)
    prompts = ids[:, :32].numpy()
    reset_flash_launches()
    got = card.generate(prompts, max_new_tokens=16, temperature=0.0)
    gen_launches = flash_launches()
    want = cpu.generate(prompts, max_new_tokens=16, temperature=0.0)
    out = {"losses": losses, "step": close,
           "step_launches": step_launches, "tokens_equal":
               bool(torch.equal(got, want)),
           "generate_launches": gen_launches}
    L = cfg.num_hidden_layers
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    if not (close["ok"] and loss_rel <= 1e-5
            and out["tokens_equal"]):
        raise AssertionError(f"GPT card vs CPU: {out}")
    if (any(v != L for v in step_launches.values())
            or gen_launches != {"flash_fwd": 16 * L, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}):
        raise AssertionError(f"GPT kernel launches: {out}")
    return out


def phase_zoo_parity(pt_pkg):
    """Small f32 copies of the three zoo models, the card against the CPU
    path (see each helper for what is held and the tolerances)."""
    emit({"phase": "zoo_parity", "resnet": zoo_resnet_parity(pt_pkg),
          "bert": zoo_bert_parity(pt_pkg), "gpt": zoo_gpt_parity(pt_pkg)})


def device_ms_of(prof, labels) -> dict:
    """Device time (ms) under each ``record_function`` label of a profile:
    the kernels launched inside the range, as the profiler attributes
    them."""
    import torch

    out = {}
    for e in prof.key_averages():
        if e.key in labels and e.device_type == torch.autograd.DeviceType.CPU:
            out[e.key] = out.get(e.key, 0.0) + e.device_time_total / 1e3
    return {k: out.get(k, 0.0) for k in labels}


def resnet_breakdown(step, x, y, step_ms):
    """One profiled ResNet step's device time split into convolutions (the
    kernels under ``aten::cudnn_convolution`` and
    ``aten::convolution_backward``, cuDNN's NCHW <-> NHWC layout transforms
    among them, counted apart too), batch norm (the ``_BatchNormTrain``
    forward and backward, under ``record_function`` labels put around them
    for this step), the optimizer (``Optimizer.apply``, labelled the same
    way) and the rest of the kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddlepaddle_tpu_torch.nn import functional as pF

    fn = pF._BatchNormTrain
    fwd, bwd, apply = fn.forward, fn.backward, step.optimizer.apply

    def labelled(label, f):
        def g(*a, **k):
            with record_function(label):
                return f(*a, **k)
        return g

    labels = ("bn_forward", "bn_backward", "optimizer")
    fn.forward = staticmethod(labelled("bn_forward", fwd))
    fn.backward = staticmethod(labelled("bn_backward", bwd))
    step.optimizer.apply = labelled("optimizer", apply)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(x, y)
            torch.cuda.synchronize()
    finally:
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
        del step.optimizer.apply
    layout = busy = 0.0
    top = {}
    for e in prof.key_averages():
        # the labels also appear as device-side annotation spans: not kernels
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key in labels):
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        if "nchwtonhwc" in e.key.lower() or "nhwctonchw" in e.key.lower():
            layout += ms
        top[e.key[:80]] = top.get(e.key[:80], 0.0) + ms
    ranges = device_ms_of(prof, labels + ("aten::cudnn_convolution",
                                          "aten::convolution_backward"))
    conv = (ranges["aten::cudnn_convolution"]
            + ranges["aten::convolution_backward"])
    bn = ranges["bn_forward"] + ranges["bn_backward"]
    if busy <= 0 or bn <= 0 or conv <= 0:
        return {"device_ms_by_kind": "not measured"}
    return {"device_busy_ms": busy, "device_idle_share": 1 - busy / step_ms,
            "device_ms_by_kind": {
                "conv": conv, "batch_norm": bn,
                "optimizer": ranges["optimizer"],
                "other": busy - conv - bn - ranges["optimizer"]},
            "conv_layout_transforms_ms": layout,
            "bn_forward_ms": ranges["bn_forward"],
            "bn_backward_ms": ranges["bn_backward"],
            "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])
                                   [:10])}


def bn_vs_cudnn():
    """Batch norm's forward + backward in training at ResNet-50's largest
    BN shape (128 x 256 x 56 x 56, bf16, f32 weight and statistics): the
    port's ``_BatchNormTrain`` (the reference's one-pass formula and its
    fused backward, in PyTorch ops) against
    ``torch.nn.functional.batch_norm`` (cuDNN), a library figure the port
    never calls; CUDA-event medians, L2 flushed, beside the byte bound of
    the pair (x read twice and dy once, y and dx written: 5 passes of
    bf16)."""
    import torch
    import torch.nn.functional as tF

    from paddlepaddle_tpu_torch.nn import functional as pF

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(128, 256, 56, 56, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_(True)
    dy = torch.randn(x.shape, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.ones(256, device="cuda", requires_grad=True)
    b = torch.zeros(256, device="cuda", requires_grad=True)
    rm, rv = torch.zeros(256, device="cuda"), torch.ones(256, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def port():
        y, _, _ = pF._BatchNormTrain.apply(x, w, b, 1e-5, 1)
        torch.autograd.grad(y, (x, w, b), dy)

    def library():
        y = tF.batch_norm(x, rm, rv, w, b, training=True, eps=1e-5)
        torch.autograd.grad(y, (x, w, b), dy)

    y_p, _, _ = pF._BatchNormTrain.apply(x, w, b, 1e-5, 1)
    y_l = tF.batch_norm(x, rm, rv, w, b, training=True, eps=1e-5)
    err = float((y_p.detach().float() - y_l.detach().float()).abs().max())
    out = {"shape": "128x256x56x56 bf16", "max_abs_err_vs_cudnn": err,
           "ms": median_ms(port, reps=10, flush=flush),
           "library_ms": median_ms(library, reps=10, flush=flush),
           "bound_ms": 5 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3}
    if not err <= 0.0625:            # two bf16 ulps at |y| in [4, 8)
        raise AssertionError(f"batch norm vs cuDNN: {out}")
    return out


RESNET_BATCH = 128


def phase_resnet50_train(pt_pkg):
    """BASELINE config 2 as ``bench.py:312-358`` runs it: ``resnet50(
    num_classes=1000)`` cast to bf16 (its running statistics too),
    ``Momentum(0.1, 0.9)``, ``cross_entropy(...).mean()``, a batch of 128 x
    3 x 224 x 224 from ``np.random.default_rng(0)``, NCHW; 2 warm-up and 5
    timed ``TrainStep`` calls, then one profiled. Losses finite, no
    non-finite parameter, the first batch norm's running statistics moved;
    step ms, images/s, ``mfu_approx`` by bench.py:351's formula (images/s
    x 3 x 4.1e9 over 989 TFLOP/s), peak memory, the profiled step's device
    time by kind, and batch norm against cuDNN at its largest shape. No
    port kernel is on this path: the convolutions are cuDNN's, as the
    reference's are XLA's."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import resnet as tr
    from paddlepaddle_tpu_torch.nn import functional as pF

    torch.cuda.reset_peak_memory_stats()
    prandom.seed(0)
    model = tr.resnet50(num_classes=1000, device="cuda").to(torch.bfloat16)
    if model.bn1._mean.dtype != torch.bfloat16:
        raise AssertionError("Module.to(bfloat16) left the BN buffers f32")
    opt = pt_pkg.Momentum(learning_rate=0.1, momentum=0.9,
                          parameters=model.named_parameters())
    step = pt_pkg.TrainStep(
        model, opt, lambda m, a, b: pF.cross_entropy(m(a), b).mean())
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224), dtype=np.float32)).to("cuda",
                                                           torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, (RESNET_BATCH,))).cuda()
    reset_flash_launches()
    losses, wall = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(x, y)))
        wall.append((time.perf_counter() - t0) * 1e3)
    timed = sorted(wall[2:])
    step_ms = timed[len(timed) // 2]
    breakdown = resnet_breakdown(step, x, y, step_ms)
    peak = torch.cuda.max_memory_allocated()
    imgs = RESNET_BATCH / (step_ms / 1e3)
    bad = [n for n, p in model.named_parameters()
           if not bool(torch.isfinite(p).all())]
    moved = float(model.bn1._mean.float().abs().max())
    del model, opt, step, x
    gc.collect()
    torch.cuda.empty_cache()
    bn = bn_vs_cudnn()
    emit({"phase": "resnet50_train", "batch": RESNET_BATCH,
          "dtype": "bfloat16", "layout": "NCHW", "step_ms": step_ms,
          "step_ms_all": wall, "images_per_s": imgs,
          "mfu_approx": imgs * 3 * 4.1e9 / BF16_FLOP_PER_S,
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "final_loss": losses[-1], "bn1_running_mean_max": moved,
          "flash_launches": flash_launches(), "nonfinite_params": bad,
          "breakdown": breakdown, "bn_vs_cudnn": bn})
    if not all(np.isfinite(losses)) or bad or moved == 0:
        raise AssertionError(f"resnet50 training: losses {losses}, "
                             f"non-finite {bad}, bn1 mean {moved}")


BERT_BATCH, BERT_SEQ = 32, 128


def phase_bert_base(pt_pkg):
    """BASELINE config 1 at the BERT paper's GLUE fine-tuning settings
    (Devlin et al. 2019, sec. 4.1 and A.3; ``run_classifier.py``'s
    max_seq_length 128): ``BertConfig.base()`` (dropout 0.1), bf16 weights
    (``model.to(bfloat16)``), 2 labels, batch 32 x 128 with padding masks
    (lengths 64-128), AdamW lr 2e-5 with f32 masters; 1 warm-up and 5 timed
    steps (the training attention is plain: a mask and the dropout route
    there, as in the reference). Then eval forwards: without a mask kernel
    2 launches once a layer (12), with the padding mask never."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import bert as tb

    cfg = tb.BertConfig.base()
    torch.cuda.reset_peak_memory_stats()
    prandom.seed(0)
    model = tb.BertForSequenceClassification(cfg, device="cuda").to(
        torch.bfloat16)
    opt = pt_pkg.AdamW(learning_rate=2e-5, weight_decay=0.01,
                       multi_precision=True,
                       parameters=model.named_parameters())
    step = pt_pkg.TrainStep(model, opt,
                            lambda m, a, t, k, b: m(a, t, k, b))
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (BERT_BATCH, BERT_SEQ))).cuda()
    types = torch.zeros_like(ids)
    lens = rng.integers(BERT_SEQ // 2, BERT_SEQ + 1, BERT_BATCH)
    mask = torch.from_numpy((np.arange(BERT_SEQ)[None, :]
                             < lens[:, None]).astype(np.int64)).cuda()
    labels = torch.from_numpy(rng.integers(0, 2, BERT_BATCH)).cuda()
    reset_flash_launches()
    losses, wall = [], []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, types, mask, labels)))
        wall.append((time.perf_counter() - t0) * 1e3)
    train_launches = flash_launches()
    timed = sorted(wall[1:])
    step_ms = timed[len(timed) // 2]
    peak = torch.cuda.max_memory_allocated()
    model.eval()
    evals = {}
    for tag, m_ in (("no_mask", None), ("padding_mask", mask)):
        reset_flash_launches()
        with torch.no_grad():
            logits = model(ids, types, m_)
            torch.cuda.synchronize()
        evals[tag] = {"launches": flash_launches(),
                      "finite": bool(torch.isfinite(logits).all()),
                      "shape": list(logits.shape)}
    emit({"phase": "bert_base", "batch": BERT_BATCH, "seq": BERT_SEQ,
          "dtype": "bfloat16", "step_ms": step_ms, "step_ms_all": wall,
          "sequences_per_s": BERT_BATCH / (step_ms / 1e3),
          "peak_mem_gb": peak / 1e9, "losses": losses,
          "train_launches": train_launches, "eval": evals})
    L = cfg.num_hidden_layers
    if not all(np.isfinite(losses)):
        raise AssertionError(f"bert losses {losses}")
    if (evals["no_mask"]["launches"]["flash_fwd"] != L
            or any(evals["padding_mask"]["launches"].values())
            or not all(e["finite"] for e in evals.values())
            or any(train_launches.values())):
        raise AssertionError(f"bert eval routes: {evals}, train "
                             f"{train_launches}")
    return evals["no_mask"]["launches"]["flash_fwd"]


GPT2_BATCH, GPT2_SEQ = 12, 1024


def phase_gpt2_small(pt_pkg):
    """GPT-2 124M at nanoGPT's pretraining settings (``config/
    train_gpt2.py``: 12 layers, 12 heads, 768 wide, block 1024, vocab 50304
    as ``GPTConfig`` has it, dropout 0.0; AdamW lr 6e-4, weight decay 0.1,
    clip 1.0), micro-batch 12 x 1024, bf16 weights with f32 masters; 1
    warm-up and 5 timed steps: step ms, tokens/s, MFU by bench.py:189's
    (6N + 12 L h s) rule over 989 TFLOP/s, peak memory; kernels 2, 3 and 4
    launch once a layer a step each (12 / 12 / 12). Then ``generate`` of 32
    greedy tokens from 8 prompts of 128: kernel 2 once a layer a token."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.core import random as prandom
    from paddlepaddle_tpu_torch.models import gpt as tg

    cfg = tg.GPTConfig(hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    torch.cuda.reset_peak_memory_stats()
    prandom.seed(0)
    model = tg.GPTForCausalLM(cfg, device="cuda").to(torch.bfloat16)
    opt = pt_pkg.AdamW(learning_rate=6e-4, beta2=0.95, weight_decay=0.1,
                       multi_precision=True,
                       parameters=model.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(model, opt, llm_loss)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (GPT2_BATCH, GPT2_SEQ))).cuda()
    reset_flash_launches()
    losses, wall, step_ms = timed_steps(step, ids, 5)
    launches = flash_launches()
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in model.parameters())
    tok_s = GPT2_BATCH * GPT2_SEQ / (step_ms / 1e3)
    flops = 6 * n + 12 * cfg.num_hidden_layers * cfg.hidden_size * GPT2_SEQ
    n_steps = len(wall)
    prompts = ids[:8, :128].cpu().numpy()
    reset_flash_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(prompts, max_new_tokens=32, temperature=0.0)
    gen_s = time.perf_counter() - t0
    gen_launches = flash_launches()
    emit({"phase": "gpt2_small", "batch": GPT2_BATCH, "seq": GPT2_SEQ,
          "dtype": "bfloat16", "params": n, "step_ms": step_ms,
          "step_ms_all": wall, "tokens_per_s": tok_s,
          "mfu": tok_s * flops / BF16_FLOP_PER_S, "peak_mem_gb": peak / 1e9,
          "losses": losses, "flash_launches": launches,
          "expected_launches": cfg.num_hidden_layers * n_steps,
          "generate": {"prompts": 8, "prompt_len": 128, "new": 32,
                       "seconds": gen_s, "shape": list(out.shape),
                       "launches": gen_launches}})
    L = cfg.num_hidden_layers
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"gpt2 losses not finite and falling: {losses}")
    if any(v != L * n_steps for v in launches.values()):
        raise AssertionError(f"gpt2 launches {launches}, expected {L} x "
                             f"{n_steps}")
    if (tuple(out.shape) != (8, 160)
            or gen_launches != {"flash_fwd": 32 * L, "flash_bwd_dq": 0,
                                "flash_bwd_dkv": 0}):
        raise AssertionError(f"gpt2 generate: {list(out.shape)}, "
                             f"{gen_launches}")
    return launches, gen_launches


# -- cold start, bundles and observability ------------------------------------

SERVE_ENGINE = dict(max_batch_size=8, kv_page_size=64, max_len=2048,
                    decode_chunk=16, device="cuda")
COLDSTART_REQUESTS = 6


def phase_coldstart(pt_pkg, ctx):
    """Cold against warm start over the serve model (see the phase list)."""
    import torch

    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.observability import watchdog
    from paddlepaddle_tpu_torch.ops.kernels import _build

    model, prompts, budgets = ctx["model"], ctx["prompts"], ctx["budgets"]
    obs.reset()
    obs.enable(trace=False, metrics=False, watchdog_=True)
    arms = {}
    try:
        for arm in ("cold", "warm"):
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            se = pt_pkg.ServingEngine(model, **SERVE_ENGINE)
            build_s = time.perf_counter() - t0
            eng = se.engine
            warm = se.warmup() if arm == "warm" else None
            programs0, nvcc0 = len(eng._programs), _build.nvcc_runs
            log0 = len(watchdog.compile_log())
            try:
                t0 = time.perf_counter()
                first = se.submit(prompts[0], max_new_tokens=int(budgets[0]))
                first.result(900)
                first_s = time.perf_counter() - t0
                rest = [se.submit(p, max_new_tokens=int(b)) for p, b in
                        zip(prompts[1:COLDSTART_REQUESTS],
                            budgets[1:COLDSTART_REQUESTS])]
                for f in rest:
                    f.result(900)
                window = watchdog.compile_log()[log0:]
                arms[arm] = {
                    "engine_s": build_s, "warmup": warm,
                    "first_ttft_ms": first.slo()["ttft_s"] * 1e3,
                    "first_latency_ms": first_s * 1e3,
                    "first_tpot_ms": (first.slo()["tpot_s"] or 0) * 1e3,
                    "captures_in_window": sum(e["site"].startswith(
                        "capture:") for e in window),
                    "builds_in_window": sum(e["site"].startswith("build:")
                                            for e in window),
                    "nvcc_in_window": _build.nvcc_runs - nvcc0,
                    "programs_built_in_window":
                        len(eng._programs) - programs0,
                    "capture_s": {k: v["capture_s"] for k, v in
                                  eng.capture_info().items()}}
            finally:
                se.stop()
            del se, eng
    finally:
        obs.disable()
    emit({"phase": "coldstart", "requests": COLDSTART_REQUESTS,
          "nvidia_smi": nvidia_smi_line(), **arms})
    warm = arms["warm"]
    if warm["captures_in_window"] or warm["builds_in_window"] \
            or warm["nvcc_in_window"] or warm["programs_built_in_window"]:
        raise AssertionError(f"the serve window after warmup built or "
                             f"captured: {warm}")
    if arms["cold"]["captures_in_window"] != 1:
        raise AssertionError("a cold engine's serve window should capture "
                             f"its decode program once: {arms['cold']}")


_RESTART_SCRIPT = r"""
import dataclasses, json, os, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
import paddlepaddle_tpu_torch as pt
from paddlepaddle_tpu_torch.ops.kernels import _build
from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa
t_import = time.perf_counter()
cfg = dataclasses.replace(pt.LlamaConfig.llama3_8b(), num_hidden_layers=2)
model = pt.LlamaForCausalLM(cfg, device="cuda", seed=0, init_std=0.02)
torch.cuda.synchronize()
t_model = time.perf_counter()
eng = pt.BatchDecodeEngine(model, max_slots=8, chunk=16, page_size=64,
                           max_len=2048, device="cuda", bundle=sys.argv[1])
t_engine = time.perf_counter()
warm = eng.warmup()
req = pt.GenerationRequest(np.asarray(json.loads(sys.argv[2])), 16)
t_serve = time.perf_counter()
eng.serve([req], timeout=300)
out = req.result.result(5)
print(json.dumps({
    "nvcc_runs": _build.nvcc_runs, "bundle": eng.compile_info()["bundle"],
    "build_dir": sorted(os.listdir(_build.build_dir())),
    "import_s": t_import - t0, "model_s": t_model - t_import,
    "engine_s": t_engine - t_model, "warmup": warm,
    "first_token_s": req.result._t_first - t0,
    "first_token_after_serve_s": req.result._t_first - t_serve,
    "launches": pa.paged_attention.launches, "tokens": out.tolist()}))
"""


def phase_bundle_restart(pt_pkg, build_s: float):
    """A bundle restart at 2 layers (see the phase list). ``build_s`` is the
    build phase's seconds for ``paged_attention.cu``, the nvcc time the
    bundle saves a fresh host."""
    import dataclasses
    import os
    import tempfile

    import numpy as np

    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=CAPTURE_PARITY_LAYERS)
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    kw = dict(max_slots=8, chunk=16, page_size=64, max_len=2048,
              device="cuda")
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size, 300)
    with tempfile.TemporaryDirectory() as tmp:
        bundle, empty = os.path.join(tmp, "bundle"), os.path.join(tmp, "b")
        os.makedirs(empty)
        eng = pt_pkg.BatchDecodeEngine(model, **kw)
        manifest = eng.save_serving_bundle(bundle)
        req = pt_pkg.GenerationRequest(prompt, 16)
        eng.serve([req], timeout=300)
        want = req.result.result(5).tolist()
        del eng
        env = dict(os.environ, PADDLE_TORCH_KERNEL_BUILD_DIR=empty)
        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-c", _RESTART_SCRIPT, bundle,
             json.dumps(prompt.tolist())],
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"bundle restart failed:\n{run.stderr}")
        child = json.loads(run.stdout.strip().splitlines()[-1])
        # a bundle of another configuration: refused with the differing
        # fact; the engine builds (here: loads) its library and serves
        launches0 = pa.paged_attention.launches
        other = pt_pkg.BatchDecodeEngine(model, **dict(kw, chunk=8),
                                         bundle=bundle)
        req = pt_pkg.GenerationRequest(prompt, 16)
        other.serve([req], timeout=300)
        refused = other.compile_info()["bundle"]
        other_launches = pa.paged_attention.launches - launches0
        other_tokens = req.result.result(5).tolist()
    emit({"phase": "bundle_restart", "layers": cfg.num_hidden_layers,
          "nvidia_smi": nvidia_smi_line(),
          "bundle_files": [x["file"] for x in manifest["libraries"]],
          "bundle_bytes": sum(x["bytes"] for x in manifest["libraries"]),
          "save_s": manifest["save_wall_s"], "subprocess_wall_s": wall,
          "child": {k: v for k, v in child.items() if k != "tokens"},
          "nvcc_s_saved": build_s, "tokens_equal": child["tokens"] == want,
          "mismatch": refused, "mismatch_launches": other_launches,
          "mismatch_tokens_equal": other_tokens == want})
    if child["nvcc_runs"] != 0 or not child["bundle"]["loaded"]:
        raise AssertionError(f"the bundle did not replace the build: {child}")
    if child["tokens"] != want or other_tokens != want:
        raise AssertionError("a bundle-loaded engine served other tokens")
    if refused["loaded"] or "chunk" not in refused.get("error", ""):
        raise AssertionError(f"a foreign bundle was not refused: {refused}")
    if not other_launches or not child["launches"]:
        raise AssertionError("the paged kernel did not run")


def _scrape(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read().decode()


def phase_serve_observed(pt_pkg, ctx):
    """The serve workload with observability off and on (see the phase
    list)."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch import observability as obs
    from paddlepaddle_tpu_torch.observability import (flight, goodput,
                                                      memledger, metrics,
                                                      perf, reqtrace)

    model, prompts, budgets = ctx["model"], ctx["prompts"], ctx["budgets"]
    sampled = ctx["sampled"]
    gc.collect()
    torch.cuda.empty_cache()
    obs.reset()
    flight_dir = tempfile.mkdtemp(prefix="paddle_flight_")   # in TMPDIR
    se = pt_pkg.ServingEngine(model, **SERVE_ENGINE)
    eng = se.engine
    perf.enable()          # warmup counts the decode program and admissions
    warm = se.warmup()
    perf.disable()

    def set_planes(on: bool) -> None:
        if on:
            obs.enable(trace=True, metrics=True, watchdog_=True)
            reqtrace.enable()
            perf.enable()
            flight.enable(directory=flight_dir, install_hooks=False)
            memledger.enable(interval_s=1.0)
        else:
            obs.disable()
            reqtrace.disable()
            perf.disable()
            flight.disable()
            memledger.disable()

    runs = []
    exporter = None
    try:
        for on in (False, True, True, False):
            set_planes(on)
            g0, tok0 = goodput.snapshot()["kinds"], eng.stats["tokens_out"]
            t0 = time.perf_counter()
            futs = [se.submit(p, max_new_tokens=int(b),
                              temperature=0.8 if i in sampled else 0.0,
                              top_k=50 if i in sampled else 0)
                    for i, (p, b) in enumerate(zip(prompts, budgets))]
            outs = [f.result(900) for f in futs]
            wall = time.perf_counter() - t0
            delivered = int(sum(len(o) - len(p)
                                for o, p in zip(outs, prompts)))
            g1 = goodput.snapshot()["kinds"]
            kinds = {k: g1[k] - g0[k] for k in g1}
            decoded = sum(kinds[k] for k in goodput.DECODED_KINDS)
            run = {"observability": on, "tok_s": delivered / wall,
                   "wall_s": wall, "new_tokens": delivered,
                   "goodput": kinds,
                   "tokens_out": eng.stats["tokens_out"] - tok0}
            if kinds["useful"] != delivered or decoded != run["tokens_out"]:
                raise AssertionError(f"goodput does not reconcile: {run}")
            if on and exporter is None:
                exporter = obs.start_exporter(port=0)
                fams = metrics.parse_prometheus_text(
                    _scrape(exporter.url("/metrics")))
                health = json.loads(_scrape(exporter.url("/healthz")))
                reqs = {tuple(sorted(lb.items())): v for _, lb, v in
                        fams["paddle_serving_requests_total"]["samples"]}
                run["scrape"] = {
                    "families": len(fams),
                    "requests_ok": reqs.get((("outcome", "ok"),)),
                    "ttft_count": [v for n, lb, v in
                                   fams["paddle_serving_ttft_seconds"][
                                       "samples"]
                                   if n.endswith("_count")][0],
                    "healthz_ok": health["ok"],
                    "journeys": len(reqtrace.journeys())}
                if run["scrape"]["requests_ok"] != len(prompts):
                    raise AssertionError(f"/metrics: {run['scrape']}")
                mem = memledger.sample_now()
                run["memledger"] = {k: mem[k] for k in (
                    "buckets", "leaked_pages", "device_bytes_in_use",
                    "device_bytes_limit", "headroom_ratio")}
                with open(flight.dump("serve_observed")) as f:
                    run["flight_dump_lines"] = sum(1 for _ in f)
            runs.append(run)
        leak = memledger.leak_check(eng)
        programs = perf.registry().table()
    finally:
        set_planes(False)
        obs.stop_exporter()
        se.stop()
    del se, eng
    gc.collect()
    torch.cuda.empty_cache()

    # a 2-layer TrainStep at Llama-3-8B widths: counted FLOPs and the
    # step-timeline MFU against perf/device.py's peak for this card
    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=CAPTURE_PARITY_LAYERS)
    tmodel = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                     init_std=0.02)
    opt = pt_pkg.AdamW(learning_rate=1e-4, weight_decay=0.01,
                       multi_precision=True,
                       parameters=tmodel.named_parameters(),
                       grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))
    step = pt_pkg.TrainStep(tmodel, opt, llm_loss)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()
    perf.reset()
    perf.enable()
    try:
        step(ids, ids)                          # counted, and the warm-up
        tl_ = perf.timeline()
        for _ in range(4):
            with tl_.step("train"):
                loss = step(ids, ids)
            perf.observe("train.step", tl_.steps[-1].wall_s,
                         bucket="accum1")
        row = {r["program"]: r for r in perf.registry().table()}["train.step"]
        specs = perf.device.specs()
    finally:
        perf.disable()
    walls = sorted(s.wall_s for s in tl_.steps)
    off = [r["tok_s"] for r in runs if not r["observability"]]
    on = [r["tok_s"] for r in runs if r["observability"]]
    decode_rows = [r for r in programs if r["program"] == "serving.decode"]
    emit({"phase": "serve_observed", "nvidia_smi": nvidia_smi_line(),
          "warmup": warm, "runs": runs, "tok_s_off": off, "tok_s_on": on,
          "on_over_off": sum(on) / sum(off), "leak_check": leak,
          "decode_program": decode_rows,
          "train_step": {"layers": cfg.num_hidden_layers,
                         "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
                         "counted_flops": row["flops"],
                         "counted_bytes": row["hbm_bytes"],
                         "wall_ms_min": walls[0] * 1e3,
                         "wall_ms_median": walls[len(walls) // 2] * 1e3,
                         "mfu": row.get("mfu"), "bound": row.get("bound"),
                         "device": specs,
                         "repo_convention": train_rates(cfg, walls[len(
                             walls) // 2] * 1e3, False),
                         "loss": float(loss)}})
    if leak["leaked_pages"]:
        raise AssertionError(f"pages leaked: {leak}")
    if not decode_rows or decode_rows[0].get("mfu") is None:
        raise AssertionError(f"no counted decode program: {programs}")
    if row.get("mfu") is None or specs["peak_flops"] != BF16_FLOP_PER_S:
        raise AssertionError(f"no train-step MFU from the H100 peaks: "
                             f"{row} {specs}")


# -- 10: tensor and data parallelism (A10's core) ------------------------------

# 8 query / 4 KV heads: 2 KV heads of 2 query heads each on a rank at mp2
TP_TINY = dict(vocab_size=1024, hidden_size=1024, intermediate_size=1024,
               num_hidden_layers=2, num_attention_heads=8,
               num_key_value_heads=4, max_position_embeddings=512,
               dtype="float32")
TP_SPAWN = dict(timeout=900, pg_timeout=300)   # join / process-group seconds
# serve_tp and train_tp are cut below their first depths (8 and 4 layers)
# so that the whole script, with the single-process and fsdp phases, stays
# inside its time limit; a TP decode step over gloo crosses the host once a
# layer, so serve_tp's time goes with its depth
SERVE_TP_LAYERS = 2        # Llama-3-8B widths at 2 of 32 layers
SERVE_TP_LOGIT_TOL = 0.25  # max abs, bf16 paged decode-step logits, TP vs one
TRAIN_TP_LAYERS = 2        # Llama-3-8B widths at 2 of 32 layers
TRAIN_TP_BATCH, TRAIN_TP_SEQ, TRAIN_TP_STEPS = 4, 512, 1
TRAIN_TP_SPECS = ("mp2", "dp2")
TRAIN_TP_LOSS_TOL = 0.02   # abs, bf16 losses, sharded vs one process
# the first gradients train_tp's single-process arms and train_fsdp hold
# against one process's: the LM head, the embedding and layer 0's wq
# (rank 0's slice where mp or fsdp shards them) and two norms (whole under
# mp: they take its sum)
TRAIN_TP_GRADS = ("lm_head.weight", "model.embed_tokens.weight",
                  "model.layers.0.self_attn.q_proj.weight",
                  "model.layers.0.input_layernorm.weight",
                  "model.norm.weight")
# relative Frobenius norm, bf16 first gradients: train_cp's read 0.008-0.011
# at 8192 tokens; a sum over 2 ranks left out reads 0.5 or more
TRAIN_TP_GRAD_RTOL = 0.03
NCCL1_LAYERS = 2


def _rank_init(backend):
    import torch

    from paddlepaddle_tpu_torch.distributed import get_rank, init_parallel_env

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_parallel_env(backend=backend)
    return get_rank()


def _rank_counts():
    from paddlepaddle_tpu_torch.ops.kernels import _build
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    return {"paged": pa.paged_attention.launches,
            "flash": {"flash_fwd": fa.flash_fwd.launches,
                      "flash_bwd_dq": fa.flash_bwd_dq.launches,
                      "flash_bwd_dkv": fa.flash_bwd_dkv.launches},
            "nvcc": _build.nvcc_runs}


def _reset_counts():
    from paddlepaddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddlepaddle_tpu_torch.ops.kernels import paged_attention as pa

    pa.paged_attention.launches = 0
    for w in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        w.launches = 0


def _tp_requests(prompts, budgets):
    from paddlepaddle_tpu_torch.inference.serving import GenerationRequest

    return [GenerationRequest(p, int(b)) for p, b in zip(prompts, budgets)]


def _llm_loss(model, ids, labels):
    return model(ids, labels=labels)


def _tp_parity_decode_rank(prompts, n_new, ids):
    """2 ranks: TP-2 decode of the tiny f32 model, then a dp2 step pair."""
    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _rank_init("gloo")
    model = pt.LlamaForCausalLM(pt.LlamaConfig(**TP_TINY), seed=0)
    eng = pt.BatchDecodeEngine(model, max_slots=4, chunk=8, page_size=64,
                               max_len=512, plan=decode_plan("mp2"))
    _reset_counts()
    out = {"rank": rank}
    if eng.is_driver:
        reqs = _tp_requests(prompts, [n_new] * len(prompts))
        eng.serve(reqs, timeout=600)
        eng.stop()
        out["tokens"] = [r.result.result(5).tolist() for r in reqs]
    else:
        eng.follow()
        out["tokens"] = None
    c = _rank_counts()
    out.update(paged=c["paged"], steps=eng.stats["decode_steps"],
               capture=eng.capture_info())
    if rank == 0:
        one = pt.BatchDecodeEngine(model, max_slots=4, chunk=8,
                                   page_size=64, max_len=512)
        reqs = _tp_requests(prompts, [n_new] * len(prompts))
        one.serve(reqs, timeout=600)
        out["one_tokens"] = [r.result.result(5).tolist() for r in reqs]
    out.update(_tp_parity_train(rank, "dp2", ids))
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def _tp_parity_train(rank, spec, ids, steps=2):
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    ids_t = torch.from_numpy(ids).cuda()
    m = pt.LlamaForCausalLM(pt.LlamaConfig(**TP_TINY), seed=1)
    step = ShardedTrainStep(m, pt.AdamW(learning_rate=1e-3,
                                        parameters=m.parameters()),
                            _llm_loss,
                            plan=train_plan(spec, data_axes=("dp",)))
    _reset_counts()
    losses = [float(step(ids_t, ids_t)) for _ in range(steps)]
    return {f"{spec}_losses": losses,
            f"{spec}_flash": _rank_counts()["flash"]}


def _tp_parity_train_rank(spec, ids):
    rank = _rank_init("gloo")
    out = {"rank": rank}
    out.update(_tp_parity_train(rank, spec, ids))
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def _tp_spec_single(pt_pkg, prompts, n_new):
    """10g: the tiny f32 model's speculative decoding under mp2 in this
    process (the target as its own draft, k = SPEC_K), on 10a's engine
    settings: tokens, both ranks' counters, and whether the worker is gone
    after ``stop()``. Counters start at 0 here: the phases before leave
    the paged counters as they were, so they are reset first."""
    model = pt_pkg.LlamaForCausalLM(pt_pkg.LlamaConfig(**TP_TINY), seed=0)
    eng = pt_pkg.BatchDecodeEngine(model, max_slots=4, chunk=8,
                                   page_size=64, max_len=512, mesh="mp2",
                                   draft=model, spec_k=SPEC_K)
    pids = eng._tp.pids
    eng._rank_counters(reset=True)
    reqs = _tp_requests(prompts, [n_new] * len(prompts))
    eng.serve(reqs, timeout=600)
    counters = eng._rank_counters()
    st = eng.spec.stats
    eng.stop()
    return {"tokens": [r.result.result(5).tolist() for r in reqs],
            "counters": counters, "gone": _procs_gone(pids),
            "acceptance": (st["accepted"] / st["proposed"]
                           if st["proposed"] else None)}


def phase_tp_parity(pt_pkg):
    """10a: TP-2 decode and dp2 / dp2mp2 training of a tiny f32 Llama on
    ranks that share the card over gloo, against one process."""
    import numpy as np
    import torch

    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, TP_TINY["vocab_size"], (int(n),))
               .astype(np.int32) for n in (40, 129, 77, 200)]
    ids = rng.integers(0, TP_TINY["vocab_size"], (4, 128)).astype(np.int64)
    t0 = time.perf_counter()
    # both jobs' ranks start and run beside this process's single-process
    # check and one-process reference (none of them is timed)
    dec_job = _spawn_beside(_tp_parity_decode_rank, (prompts, 24, ids), 2)
    grid_job = _spawn_beside(_tp_parity_train_rank, ("dp2mp2", ids), 4)
    spec = _tp_spec_single(pt_pkg, prompts, 24)
    model = pt_pkg.LlamaForCausalLM(pt_pkg.LlamaConfig(**TP_TINY), seed=1)
    ref = pt_pkg.TrainStep(model, pt_pkg.AdamW(
        learning_rate=1e-3, parameters=model.parameters()), _llm_loss)
    ids_t = torch.from_numpy(ids).cuda()
    one_losses = [float(ref(ids_t, ids_t)) for _ in range(2)]
    del model, ref
    dec, grid = dec_job.result(), grid_job.result()
    wall = time.perf_counter() - t0
    L = TP_TINY["num_hidden_layers"]
    r0 = dec[0]
    checks = {
        "tokens_equal_one_process": r0["tokens"] == r0["one_tokens"],
        "paged_equals_layers_x_steps": all(
            r["paged"] == L * r["steps"] and r["steps"] > 0 for r in dec),
        "eager_under_gloo": all(
            r["capture"]["decode"]["captured"] is False for r in dec),
        "dp2_rel_err": max(abs(a - b) / abs(b) for r in dec for a, b in
                           zip(r["dp2_losses"], one_losses)),
        "dp2mp2_rel_err": max(abs(a - b) / abs(b) for r in grid for a, b in
                              zip(r["dp2mp2_losses"], one_losses)),
        "nvcc_in_ranks": sum(r["nvcc"] for r in dec + grid),
        "spec_mp2_single_process_equals_one_process":
            spec["tokens"] == r0["one_tokens"],
        "spec_mp2_w4_equals_layers_x_steps_each_rank": all(
            c["paged_attention"] == L * c["decode_steps"] > 0
            for c in spec["counters"]),
        "spec_mp2_same_accept_lengths":
            spec["counters"][0]["spec"] == spec["counters"][1]["spec"],
        "spec_mp2_worker_gone": spec["gone"],
    }
    emit({"phase": "tp_parity", "nvidia_smi": nvidia_smi_line(),
          "backend": "gloo (ranks share cuda:0)", "wall_s": wall,
          "paged_launches_by_rank": [r["paged"] for r in dec],
          "decode_steps_by_rank": [r["steps"] for r in dec],
          "flash_launches_by_rank": {
              "dp2": [r["dp2_flash"] for r in dec],
              "dp2mp2": [r["dp2mp2_flash"] for r in grid]},
          "losses": {"one_process": one_losses,
                     "dp2": [r["dp2_losses"] for r in dec],
                     "dp2mp2": [r["dp2mp2_losses"] for r in grid]},
          "capture": r0["capture"],
          "spec_mp2_single_process": {
              "acceptance": spec["acceptance"],
              "w4_launches": [c["paged_attention"]
                              for c in spec["counters"]]}, **checks})
    bad = [k for k in ("tokens_equal_one_process",
                       "paged_equals_layers_x_steps", "eager_under_gloo",
                       "spec_mp2_single_process_equals_one_process",
                       "spec_mp2_w4_equals_layers_x_steps_each_rank",
                       "spec_mp2_same_accept_lengths", "spec_mp2_worker_gone")
           if not checks[k]]
    if bad or checks["dp2_rel_err"] > 1e-5 or checks["dp2mp2_rel_err"] > 1e-4 \
            or checks["nvcc_in_ranks"]:
        raise AssertionError(f"tp_parity failed: {bad} {checks}")
    return {"tp_parity paged rank0": dec[0]["paged"],
            "tp_parity paged rank1": dec[1]["paged"],
            "tp_parity dp2 flash rank0": dec[0]["dp2_flash"],
            "tp_parity dp2mp2 flash rank0": grid[0]["dp2mp2_flash"]}


def _serve_tp_prompts():
    import numpy as np

    rng = np.random.default_rng(5)
    plens = rng.integers(128, 513, 8)
    budgets = rng.integers(48, 97, 8)
    prompts = [rng.integers(0, 128256, (int(n),)).astype(np.int32)
               for n in plens]
    return prompts, [int(b) for b in budgets]


def _serve_run(eng, prompts, budgets):
    import torch

    reqs = _tp_requests(prompts, budgets)
    steps0, chunks0 = eng.stats["decode_steps"], len(eng.chunk_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(reqs, timeout=900)
    wall = time.perf_counter() - t0
    toks = [r.result.result(5) for r in reqs]
    new = sum(len(t) - len(p) for t, p in zip(toks, prompts))
    chunk_ms = sorted(eng.chunk_ms[chunks0:])
    return {"tokens": [t.tolist() for t in toks], "wall_s": wall,
            "new_tokens": new, "tok_s": new / wall,
            "steps": eng.stats["decode_steps"] - steps0,
            "chunks": len(chunk_ms),
            "chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms
            else None}


def _admit_all(eng, prompts, budgets):
    """Prefill every prompt into its own slot (slot i <- prompt i)."""
    for r in _tp_requests(prompts, budgets):
        if not eng._admit(r):
            raise AssertionError("no free slot or pages for the logit probe")


def _paged_step_logits(eng, prompts):
    """The logits of one decode step through the paged path (kernel 1 on
    the card) for every admitted slot, each fed its prompt's last token so
    that two engines are held on the same input whatever their first
    tokens. Under a plan every rank calls it in step (after the driver's
    ``stop()``, so outside the control protocol: the ranks' slot state is
    the same). f32 numpy ``[slots, vocab]``."""
    import torch

    last = torch.tensor([int(p[-1]) for p in prompts],
                        dtype=eng.tokens.dtype, device=eng.tokens.device)
    eng.tokens[:len(prompts)].copy_(last)
    with torch.no_grad():
        rows = eng._forward_paged(eng.tokens[:, None], eng.lens)[:, 0]
    return rows[:len(prompts)].float().cpu().numpy()


def _serve_tp_rank():
    import dataclasses

    import numpy as np
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import collective as C
    from paddlepaddle_tpu_torch.distributed import decode_plan

    rank = _rank_init("gloo")
    cfg = dataclasses.replace(pt.LlamaConfig.llama3_8b(),
                              num_hidden_layers=SERVE_TP_LAYERS)
    model = pt.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    eng = pt.BatchDecodeEngine(model, max_slots=8, chunk=16, page_size=64,
                               max_len=1024, plan=decode_plan("mp2"))
    prompts, budgets = _serve_tp_prompts()
    out = {"rank": rank}
    if eng.is_driver:
        _serve_run(eng, prompts[:1], [2])            # warm-up
        _reset_counts()
        run = _serve_run(eng, prompts, budgets)
        launches = _rank_counts()["paged"]
        C.reset_collective_stats()
        with C.timing():
            timed = _serve_run(eng, prompts, budgets)
        stats = C.collective_stats()
        _admit_all(eng, prompts, budgets)      # led: the follower prefills
        eng.stop()
        out.update(run=run, launches=launches, steps=run["steps"],
                   timed={"chunks": timed["chunks"],
                          "tokens_equal": timed["tokens"] == run["tokens"],
                          "collectives": stats})
    else:
        steps0 = eng.stats["decode_steps"]
        _reset_counts()
        # the warm-up's launches are counted here too; subtracted below
        eng.follow()
        out.update(launches=_rank_counts()["paged"],
                   steps=eng.stats["decode_steps"] - steps0)
    # after the counts: one paged decode step on both ranks in step
    tp_logits = _paged_step_logits(eng, prompts)
    out["tp_logits"] = tp_logits
    if rank == 0:
        one = pt.BatchDecodeEngine(model, max_slots=8, chunk=16,
                                   page_size=64, max_len=1024)
        _serve_run(one, prompts[:1], [2])
        out["one"] = _serve_run(one, prompts, budgets)
        out["one_capture"] = one.capture_info().get("decode", {})
        _admit_all(one, prompts, budgets)
        one_logits = _paged_step_logits(one, prompts)
        out["logit_diff"] = float(np.abs(tp_logits - one_logits).max())
        out["logit_scale"] = float(np.abs(one_logits).max())
        out["one_logits"] = one_logits
    out["capture"] = eng.capture_info()
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def phase_serve_tp(pt_pkg):
    """10b: Llama-3-8B widths at ``SERVE_TP_LAYERS`` layers, bf16, TP-2 on
    two ranks that share the card over gloo, beside one engine alone."""
    from paddlepaddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    r0, r1 = spawn(_serve_tp_rank, nprocs=2, **TP_SPAWN)
    wall = time.perf_counter() - t0
    L = SERVE_TP_LAYERS
    run, one = r0["run"], r0["one"]
    coll = r0["timed"]["collectives"]
    chunks = max(r0["timed"]["chunks"], 1)
    ranks_agree = bool((r0["tp_logits"] == r1["tp_logits"]).all())
    # the follower counted the warm-up's 1 decode chunk too (2 new tokens:
    # the first from prefill, one decode chunk of 16 steps), and the timed
    # second run; rank 0 counts the first measured run alone
    follower_ok = r1["launches"] == L * r1["steps"]
    checks = {
        "tokens_agree_timed_rerun": r0["timed"]["tokens_equal"],
        "logits_agree_on_ranks": ranks_agree,
        "logit_diff_within_tol": r0["logit_diff"] <= SERVE_TP_LOGIT_TOL,
        "paged_rank0_equals_layers_x_steps":
            r0["launches"] == L * r0["steps"] and r0["steps"] > 0,
        "paged_rank1_equals_layers_x_steps": follower_ok,
        "nvcc_in_ranks": r0["nvcc"] + r1["nvcc"],
    }
    emit({"phase": "serve_tp", "nvidia_smi": nvidia_smi_line(),
          "model": f"llama3_8b widths, {L} layers, bf16, mp2",
          "backend": "gloo (2 ranks share cuda:0; collectives via host)",
          "requests": len(run["tokens"]), "new_tokens": run["new_tokens"],
          "tp_tok_s": run["tok_s"], "one_tok_s": one["tok_s"],
          "tp_over_one": run["tok_s"] / one["tok_s"],
          "tp_chunk_ms_p50": run["chunk_ms_p50"],
          "one_chunk_ms_p50": one["chunk_ms_p50"],
          "allreduce_ms_per_chunk":
              coll.get("all_reduce", {}).get("seconds", 0.0) * 1e3 / chunks,
          "allgather_ms_per_chunk":
              coll.get("all_gather", {}).get("seconds", 0.0) * 1e3 / chunks,
          "collectives_timed_run": coll,
          "tokens_equal_one_process": run["tokens"] == one["tokens"],
          "logit_diff": r0["logit_diff"], "logit_scale": r0["logit_scale"],
          "logit_tol": SERVE_TP_LOGIT_TOL,
          "paged_launches": [r0["launches"], r1["launches"]],
          "decode_steps": [r0["steps"], r1["steps"]],
          "capture_tp": r0["capture"].get("decode"),
          "capture_one": r0["one_capture"],
          "peak_gb_by_rank": [r0["peak_gb"], r1["peak_gb"]],
          "wall_s": wall, **checks})
    bad = [k for k, v in checks.items() if k != "nvcc_in_ranks" and not v]
    if bad or checks["nvcc_in_ranks"]:
        raise AssertionError(f"serve_tp failed: {bad} {checks}")
    out = {"serve_tp paged rank0": r0["launches"],
           "serve_tp paged rank1": r1["launches"]}
    out.update(_serve_tp_single(pt_pkg, r0))
    return out


def _train_tp_rank(specs):
    """train_tp's SPMD arms on one pair of ranks: each spec of ``specs``
    in turn (one spawn for all: a worker's start is 8-9 s)."""
    import torch

    rank = _rank_init("gloo")
    out = {}
    for spec in specs:
        out[spec] = _train_tp_spec(rank, spec)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _train_tp_spec(rank, spec):
    import dataclasses

    import numpy as np
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    cfg = dataclasses.replace(pt.LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_TP_LAYERS)
    model = pt.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    step = ShardedTrainStep(
        model, pt.AdamW(learning_rate=1e-4, parameters=model.parameters(),
                        grad_clip=pt.ClipGradByGlobalNorm(1.0)),
        _llm_loss, plan=train_plan(spec, data_axes=("dp",)))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_TP_BATCH, TRAIN_TP_SEQ))).cuda()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    losses, ms = [], []
    for _ in range(TRAIN_TP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    flash = _rank_counts()["flash"]
    return {"rank": rank, "losses": losses, "step_ms": ms, "flash": flash,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "nvcc": _rank_counts()["nvcc"]}


def phase_train_tp(pt_pkg, job):
    """10c: Llama-3-8B widths at ``TRAIN_TP_LAYERS`` layers, bf16, mp2 and dp2
    against a one-process TrainStep. ``job``: the SPMD arms' spawn (two
    ranks that share the card over gloo, :func:`_train_tp_rank`), started
    beside the untimed parity phases and read here: losses and launches.
    Then each spec's single-process arm in this process: losses (bit-equal
    to the SPMD arm's), rank 0's first gradients of ``TRAIN_TP_GRADS``
    against one process's, launches, and rank 0's collectives timed."""
    import dataclasses

    import numpy as np
    import torch

    ranks = job.result()
    runs = {spec: [r[spec] for r in ranks] for spec in TRAIN_TP_SPECS}
    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_TP_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, device="cuda", seed=0,
                                    init_std=0.02)
    ref = pt_pkg.TrainStep(model, pt_pkg.AdamW(
        learning_rate=1e-4, parameters=model.named_parameters(),
        grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0)), _llm_loss)
    want = _first_grads(ref.optimizer, TRAIN_TP_GRADS)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_TP_BATCH, TRAIN_TP_SEQ))).cuda()
    one, one_ms = [], []
    for _ in range(TRAIN_TP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one.append(float(ref(ids, ids)))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t1) * 1e3)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del model, ref
    gc.collect()
    torch.cuda.empty_cache()
    single = {spec: _train_tp_single(pt_pkg, spec, cfg, ids, want)
              for spec in runs}
    L = TRAIN_TP_LAYERS
    out, bad = {}, []
    summary = {}
    for spec, ranks in runs.items():
        err = max(abs(a - b) for r in ranks for a, b in zip(r["losses"], one))
        summary[spec] = {
            "losses": [r["losses"] for r in ranks],
            "max_abs_loss_err": err,
            "step_ms_by_rank_beside_parity": [r["step_ms"] for r in ranks],
            "flash_launches_by_rank": [r["flash"] for r in ranks],
            "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
            "nvcc_in_ranks": sum(r["nvcc"] for r in ranks)}
        want_launches = {"flash_fwd": L * TRAIN_TP_STEPS,
                         "flash_bwd_dq": L * TRAIN_TP_STEPS,
                         "flash_bwd_dkv": L * TRAIN_TP_STEPS}
        one_arm = single[spec]
        one_arm["bit_equal_to_spmd"] = one_arm["losses"] == ranks[0]["losses"]
        coll = one_arm["collectives_rank0"]
        one_arm["allreduce_ms_per_step"] = \
            coll.get("all_reduce", {}).get("seconds", 0.0) * 1e3
        one_arm["allgather_ms_per_step"] = \
            coll.get("all_gather", {}).get("seconds", 0.0) * 1e3
        summary[f"{spec} single-process"] = one_arm
        if err > TRAIN_TP_LOSS_TOL or summary[spec]["nvcc_in_ranks"] \
                or any(r["flash"] != want_launches for r in ranks):
            bad.append(spec)
        if not one_arm["bit_equal_to_spmd"] or not one_arm["workers_gone"] \
                or one_arm["held_gb"] > HELD_GB_TOL \
                or one_arm["nvcc_in_worker"] \
                or max(one_arm["grad_rel_err"].values()) > TRAIN_TP_GRAD_RTOL \
                or any(r["launches"][k] != v for r in one_arm["ranks"]
                       for k, v in want_launches.items()):
            bad.append(f"{spec} single-process")
        out[f"train_tp {spec} flash rank0"] = ranks[0]["flash"]
        out[f"train_tp {spec} single-process flash by rank"] = [
            {k: r["launches"][k] for k in want_launches}
            for r in one_arm["ranks"]]
    emit({"phase": "train_tp", "nvidia_smi": nvidia_smi_line(),
          "model": f"llama3_8b widths, {L} layers, bf16",
          "backend": "gloo (2 ranks share cuda:0; collectives via host)",
          "batch": [TRAIN_TP_BATCH, TRAIN_TP_SEQ],
          "one_process": {"losses": one, "step_ms": one_ms,
                          "peak_gb": one_peak},
          "loss_tol": TRAIN_TP_LOSS_TOL, "grad_rtol": TRAIN_TP_GRAD_RTOL,
          **summary})
    if bad:
        raise AssertionError(f"train_tp failed for {bad}: {summary}")
    return out


def _slice_err(got, want, rank=0) -> float:
    """Rank ``rank``'s gradient ``got`` (whole, or its equal slice along the
    dim whose size differs) against the same slice of the whole gradient
    ``want``: the relative Frobenius norm of the difference."""
    for dim, (a, b) in enumerate(zip(got.shape, want.shape)):
        if a != b:
            want = want.narrow(dim, rank * a, a)
    return float((got - want).norm() / want.norm())


def _train_tp_single(pt_pkg, spec, cfg, ids, want):
    """10c': ``spec``'s single-process arm: ``ShardedTrainStep`` over
    ``train_plan(spec)`` built in this process (rank 0; the step starts rank
    1 on ``cuda:0`` over gloo groups it owns) on the SPMD arm's seed,
    optimizer and batch. Losses, rank 0's first gradients against ``want``
    (one process's), each rank's launches and peak memory (read through
    the step), rank 0's collectives in the last step (timed), construction
    seconds, whether the worker is gone after ``close()`` and the memory
    this process still holds then."""
    import torch

    from paddlepaddle_tpu_torch.distributed import collective as C
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    t0 = time.perf_counter()
    step = ShardedTrainStep(
        model, pt_pkg.AdamW(learning_rate=1e-4,
                            parameters=model.named_parameters(),
                            grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0)),
        _llm_loss, plan=train_plan(spec, data_axes=("dp",)))
    ctor_s = time.perf_counter() - t0
    got = _first_grads(step.optimizer, TRAIN_TP_GRADS)
    pids, startup = step.workers.pids, dict(step.workers.startup)
    try:
        step._rank_stats(reset=True)
        losses, ms = [], []
        for i in range(TRAIN_TP_STEPS):
            C.reset_collective_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with C.timing(i == TRAIN_TP_STEPS - 1):
                losses.append(float(step(ids, ids)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
        coll = C.collective_stats()
        ranks = step._rank_stats()
    finally:
        step.close()
    gone = _procs_gone(pids)
    del step, model
    held = _held_gb(before)
    return {"losses": losses, "step_ms": ms, "construction_s": ctor_s,
            "grad_rel_err": {n: _slice_err(got[n], want[n])
                             for n in sorted(want)},
            "collectives_rank0": coll,
            "worker_startup_s": startup, "workers_gone": gone,
            "held_gb": held, "nvcc_in_worker": sum(r["nvcc"]
                                                   for r in ranks[1:]),
            "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
            "ranks": [{"launches": r["launches"]} for r in ranks]}


# -- 10h-10i: expert parallelism (A10 slice 2) --------------------------------

# the smallest f32 MoE kernel 8 takes (d and h multiples of 128), capacity
# factor 0.5 so that routed entries drop
EP_PARITY = dict(vocab_size=1024, hidden_size=128, intermediate_size=256,
                 num_hidden_layers=2, num_attention_heads=2,
                 num_key_value_heads=2, num_experts=8, num_experts_per_tok=2,
                 num_shared_experts=0, capacity_factor=0.5,
                 max_position_embeddings=512, dtype="float32",
                 dispatch_mode="fused")
EP_PARITY_BATCH, EP_PARITY_STEPS = (4, 256), 2
EP_PARITY_LOSS_RTOL = 1e-5   # f32: the partial combine's sum over ep and
#                              the logits' gather over dp reorder sums only
EP_PARITY_PARAM_ATOL = 1e-4  # a tenth of one AdamW step's move at lr 1e-3
TRAIN_EP_LAYERS = 2          # DeepSeekMoE-16B widths at 2 of 28 layers
TRAIN_EP_STEPS = 2
TRAIN_EP_LOSS_TOL = 0.02     # abs, bf16 losses, ep2 vs one process
# drop shares of a layer after the first: its input went through a bf16
# combine summed over ep, which rounds apart from one process's
TRAIN_EP_DROP_TOL = 0.002


def _ep_opt(pt_pkg, model, lr, multi_precision=False):
    return pt_pkg.AdamW(learning_rate=lr, weight_decay=0.01,
                        multi_precision=multi_precision,
                        parameters=model.named_parameters(),
                        grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))


def _first_drop_shares(layers):
    """Pre-hooks on each MoE layer of ``layers`` that record, once, the
    share of routed entries its capacity drops on its first input (the
    global batch: under ``ep`` alone every rank holds it). Returns the list
    they fill and their handles."""
    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    shares, handles = [], []

    def hook(mlp, args):
        if len(shares) < len(layers):
            x = args[0].reshape(-1, mlp.d_model)
            soe = tmoe._capacity_slot_maps(
                x.float() @ mlp.gate.weight.float(), mlp.gate.topk,
                mlp.num_experts, mlp.capacity(x.shape[0]), x.shape[0])[2]
            shares.append(float((soe < 0).float().mean()))

    for layer in layers:
        handles.append(layer.mlp.register_forward_pre_hook(hook))
    return shares, handles


def phase_ep_parity(pt_pkg):
    """10h: the f32 MoE of ``EP_PARITY`` (fused) trained 2 steps by
    ``ShardedTrainStep`` over ``ep2`` and ``dp2ep2`` in this process
    (``moe_train_rules``; the step starts the other ranks on ``cuda:0``)
    against a one-process ``TrainStep`` on the same weights and batch:
    losses, synced parameters, kernel 8 on every rank."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.distributed import moe_train_rules, train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    cfg = pt_pkg.MoEConfig(**EP_PARITY)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, EP_PARITY_BATCH)).cuda()
    m1 = pt_pkg.MoEForCausalLM(cfg, seed=0)
    one = pt_pkg.TrainStep(m1, _ep_opt(pt_pkg, m1, 1e-3), _llm_loss)
    shares, hs = _first_drop_shares(m1.layers)
    want = [float(one(ids, ids)) for _ in range(EP_PARITY_STEPS)]
    for hd in hs:
        hd.remove()
    ref = {n: p.detach().clone() for n, p in m1.named_parameters()}
    out, bad = {"one_process": {"losses": want, "drop_share": shares}}, []
    for spec in ("ep2", "dp2ep2"):
        model = pt_pkg.MoEForCausalLM(cfg, seed=0)
        t0 = time.perf_counter()
        step = ShardedTrainStep(model, _ep_opt(pt_pkg, model, 1e-3),
                                _llm_loss, plan=train_plan(
                                    spec, rules=moe_train_rules(),
                                    data_axes=("dp",)))
        ctor_s = time.perf_counter() - t0
        pids = step.workers.pids
        ep = step.plan.axes["ep"]
        try:
            step._rank_stats(reset=True)
            got = [float(step(ids, ids)) for _ in range(EP_PARITY_STEPS)]
            ranks = step._rank_stats()
            step.sync_to_model()
            bank = tuple(step.params["layers.0.mlp.w_gate_proj"].shape)
        finally:
            step.close()
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        param_err = max(float((p.detach() - ref[n]).abs().max())
                        for n, p in model.named_parameters())
        launches = [r["launches"]["gather_gemm_ffn"] for r in ranks]
        rec = {"losses": got, "max_rel_loss_err": rel,
               "max_abs_param_err": param_err, "local_bank": bank,
               "kernel8_launches_by_rank": launches,
               "expected_launches": L * EP_PARITY_STEPS,
               "flash_fwd_by_rank": [r["launches"]["flash_fwd"]
                                     for r in ranks],
               "construction_s": ctor_s, "workers_gone": _procs_gone(pids),
               "nvcc_in_workers": sum(r["nvcc"] for r in ranks[1:])}
        out[spec] = rec
        if rel > EP_PARITY_LOSS_RTOL or param_err > EP_PARITY_PARAM_ATOL \
                or bank[0] != cfg.num_experts // ep \
                or any(n != L * EP_PARITY_STEPS for n in launches) \
                or not rec["workers_gone"] or rec["nvcc_in_workers"]:
            bad.append(spec)
        del step, model
        gc.collect()
    emit({"phase": "ep_parity", "model": "f32 MoE d 128, h 256, E 8, top-2, "
          "2 layers, capacity factor 0.5, fused", "batch": EP_PARITY_BATCH,
          "loss_rtol": EP_PARITY_LOSS_RTOL,
          "param_atol": EP_PARITY_PARAM_ATOL, **out})
    if bad or not min(shares) > 0:
        raise AssertionError(f"ep_parity failed for {bad} (drop shares "
                             f"{shares}): {out}")
    return {f"ep_parity {spec} by rank": out[spec]["kernel8_launches_by_rank"]
            for spec in ("ep2", "dp2ep2")}


def phase_train_ep(pt_pkg):
    """10i: DeepSeekMoE-16B widths at ``TRAIN_EP_LAYERS`` layers (bf16,
    fused, multi-precision AdamW + clip), batch 4 x 2048: a one-process
    ``TrainStep`` first (then freed), then ``ShardedTrainStep`` over
    ``ep2`` in this process (each rank 32 of the 64 experts). Losses, drop
    shares, kernel 8 and 2-4 launches on each rank, step ms, the ``ep``
    all-reduces of the last step (count, bytes, ms), peak memory of each
    process; then kernel 8 alone at one rank's shape (32 local experts of
    64, C 320, T 8192) against its plain version, timed."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.distributed import collective as C
    from paddlepaddle_tpu_torch.distributed import moe_train_rules, train_plan
    from paddlepaddle_tpu_torch.ops.kernels import gather_gemm as gg
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep
    from paddlepaddle_tpu_torch.parallel import moe as tmoe

    cfg = dataclasses.replace(moe_train_config(pt_pkg),
                              num_hidden_layers=TRAIN_EP_LAYERS)
    L = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))).cuda()

    def run(step, layers):
        shares, hs = _first_drop_shares(layers)
        losses, ms = [], []
        for i in range(TRAIN_EP_STEPS):
            last = i == TRAIN_EP_STEPS - 1
            C.reset_collective_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with C.timing(last):
                losses.append(float(step(ids, ids)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        for hd in hs:
            hd.remove()
        return losses, ms, shares, C.collective_stats()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.MoEForCausalLM(cfg, device="cuda", seed=0, init_std=0.02)
    one = pt_pkg.TrainStep(model, _ep_opt(pt_pkg, model, 1e-4, True),
                           llm_loss)
    one_losses, one_ms, one_shares, _ = run(one, model.layers)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del one, model
    gc.collect()
    torch.cuda.empty_cache()

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.MoEForCausalLM(cfg, device="cuda", seed=0, init_std=0.02)
    t0 = time.perf_counter()
    step = ShardedTrainStep(model, _ep_opt(pt_pkg, model, 1e-4, True),
                            llm_loss, plan=train_plan(
                                "ep2", rules=moe_train_rules(),
                                data_axes=("dp",)))
    ctor_s = time.perf_counter() - t0
    pids, startup = step.workers.pids, dict(step.workers.startup)
    try:
        step._rank_stats(reset=True)
        losses, ms, shares, coll = run(step, step.net.layers)
        ranks = step._rank_stats()
        bank = tuple(step.params["layers.0.mlp.w_gate_proj"].shape)
    finally:
        step.close()
    gone = _procs_gone(pids)
    del step, model
    held = _held_gb(before)
    gc.collect()
    torch.cuda.empty_cache()
    local = gather_gemm_full_case(gg, tmoe, MOE_T, MOE_E, MOE_C, MOE_D,
                                  MOE_H, seed=2, local=MOE_E // 2)
    gc.collect()
    torch.cuda.empty_cache()

    err = max(abs(a - b) for a, b in zip(losses, one_losses))
    drop_err = [abs(a - b) for a, b in zip(shares, one_shares)]
    n = L * TRAIN_EP_STEPS
    want = {"gather_gemm_ffn": n, "gather_gateup": n, "expert_down": n,
            "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    ar = coll.get("all_reduce", {})
    rec = {"phase": "train_ep", "nvidia_smi": nvidia_smi_line(),
           "model": f"deepseek-moe-16b widths, {L} layers, bf16, fused",
           "backend": "gloo (2 ranks share cuda:0; collectives via host)",
           "batch": [TRAIN_BATCH, TRAIN_SEQ], "local_bank": bank,
           "capacity": MOE_C,
           "one_process": {"losses": one_losses, "step_ms": one_ms,
                           "peak_gb": one_peak, "drop_share": one_shares},
           "ep2": {"losses": losses, "step_ms": ms, "drop_share": shares,
                   "max_abs_loss_err": err, "drop_share_diff": drop_err,
                   "construction_s": ctor_s, "worker_startup_s": startup,
                   "launches_by_rank": [r["launches"] for r in ranks],
                   "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
                   "nvcc_in_worker": sum(r["nvcc"] for r in ranks[1:]),
                   "last_step_collectives_rank0": coll,
                   "ep_allreduce_ms_last_step": ar.get("seconds", 0.0) * 1e3,
                   "workers_gone": gone, "held_gb": held},
           "kernel8_local": local, "loss_tol": TRAIN_EP_LOSS_TOL,
           "drop_tol_after_layer0": TRAIN_EP_DROP_TOL}
    emit(rec)
    checks = local["checks"]
    if err > TRAIN_EP_LOSS_TOL or drop_err[0] != 0.0 \
            or max(drop_err[1:] or [0.0]) > TRAIN_EP_DROP_TOL \
            or not np.isfinite(losses).all() or bank[0] != MOE_E // 2 \
            or any(r["launches"][k] != v for r in ranks
                   for k, v in want.items()) \
            or rec["ep2"]["nvcc_in_worker"] or not gone \
            or held > HELD_GB_TOL \
            or any(not v["err_over_allowed"] <= 1.0
                   for v in checks.values()):
        raise AssertionError(f"train_ep failed: {rec}")
    return {"launches_by_rank": [r["launches"] for r in ranks],
            "kernel8_local": local}


def _nccl_world1_rank():
    import dataclasses

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import decode_plan
    from paddlepaddle_tpu_torch.distributed.env import backend

    rank = _rank_init(None)
    cfg = dataclasses.replace(pt.LlamaConfig.llama3_8b(),
                              num_hidden_layers=NCCL1_LAYERS)
    model = pt.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    prompts, budgets = _serve_tp_prompts()
    out = {"rank": rank, "backend": backend()}
    engines = {name: pt.BatchDecodeEngine(model, max_slots=8, chunk=16,
                                          page_size=64, max_len=1024, **kw)
               for name, kw in (("plan", {"plan": decode_plan("mp1")}),
                                ("one", {}))}
    for eng in engines.values():      # each captures on its warm-up request
        _serve_run(eng, prompts[:1], [17])
    for name, eng in engines.items():
        _reset_counts()
        run = _serve_run(eng, prompts, budgets)
        out[name] = {"tokens": run["tokens"], "tok_s": run["tok_s"],
                     "paged": _rank_counts()["paged"], "steps": run["steps"],
                     "capture": eng.capture_info().get("decode")}
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def phase_nccl_world1(pt_pkg, job):
    """10d: one NCCL rank (``job``: its spawn of :func:`_nccl_world1_rank`,
    started beside the untimed parity phases): the plan's decode chunk
    captured with the NCCL all-reduce inside, tokens bit-equal to the
    plan-less engine's."""
    (r,) = job.result()
    cap = r["plan"]["capture"] or {}
    checks = {
        "backend_nccl": r["backend"] == "nccl",
        "captured": bool(cap.get("captured")) and cap.get("replays", 0) > 0,
        "tokens_bit_equal": r["plan"]["tokens"] == r["one"]["tokens"],
        "paged_equals_layers_x_steps":
            r["plan"]["paged"] == NCCL1_LAYERS * r["plan"]["steps"],
        "nvcc_in_rank": r["nvcc"],
    }
    emit({"phase": "nccl_world1", "nvidia_smi": nvidia_smi_line(),
          "model": f"llama3_8b widths, {NCCL1_LAYERS} layers, bf16, mp1",
          "capture_info": cap, "capture_plan_less": r["one"]["capture"],
          "tok_s": {"plan": r["plan"]["tok_s"], "one": r["one"]["tok_s"]},
          "paged_launches": r["plan"]["paged"], **checks})
    bad = [k for k, v in checks.items() if k != "nvcc_in_rank" and not v]
    if bad or checks["nvcc_in_rank"]:
        raise AssertionError(f"nccl_world1 failed: {bad} {checks}")
    return {"nccl_world1 paged": r["plan"]["paged"]}


# -- 10: the single-process form (ServingEngine(model, mesh="mp2") here) ------

SPEC_TP_LAYERS = 2         # Llama-3-8B widths at 2 of 32 layers (8 until
#                            the fsdp phases came, 4 until the pipeline
#                            phases: host-bound, as serve_tp)
SPEC_TP_PROMPTS = 4        # serve_spec's first 4 greedy prompts
ROUTER_TP_LAYERS = 2       # Llama-3-8B widths at 2 of 32 layers
ROUTER_TP_ENGINE = dict(max_batch_size=2, decode_chunk=8, kv_page_size=64,
                        max_len=1024)


def _smi_pids() -> set:
    """Pids of the processes ``nvidia-smi`` lists on the card (empty where
    the container hides them)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout
    return {int(x) for x in out.split() if x.strip().isdigit()}


def _procs_gone(pids, timeout=15.0) -> bool:
    """Every pid of ``pids`` has exited (a zombie counts as exited) within
    ``timeout`` seconds, and none is on ``nvidia-smi``'s list."""
    import os

    def alive(pid):
        try:
            os.kill(pid, 0)
            with open(f"/proc/{pid}/stat") as f:
                return f.read().split(")")[-1].split()[0] != "Z"
        except (ProcessLookupError, OSError):
            return False

    deadline = time.monotonic() + timeout
    while any(alive(p) for p in pids):
        if time.monotonic() > deadline:
            return False
        time.sleep(0.1)
    return not (set(pids) & _smi_pids())


HELD_GB_TOL = 0.25         # device memory an engine may leave behind, GB


def _held_gb(before: int) -> float:
    """GB of device memory this process still holds over ``before`` once
    an engine's worker has gone and the engine is dropped (what the worker
    mapped is freed when it released it)."""
    import torch

    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.synchronize()
    return (torch.cuda.memory_allocated() - before) / 1e9


def _launches_ok(before, after, layers, key="paged_attention") -> bool:
    """Each rank's launches since ``before`` (its counters were reset
    there) equal layers x its decode steps since then, and are > 0."""
    return all(a[key] == layers * (a["decode_steps"] - b["decode_steps"])
               and a[key] > 0 for b, a in zip(before, after))


def _serve_tp_single(pt_pkg, r0):
    """10b's single-process arm: ``ServingEngine(model, mesh="mp2")`` in
    this process on the SPMD arm's model (the same seed), prompts and
    engine settings."""
    import dataclasses

    import numpy as np
    import torch

    L = SERVE_TP_LAYERS
    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=L)
    prompts, budgets = _serve_tp_prompts()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    alloc0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    srv = pt_pkg.ServingEngine(model, max_batch_size=8, decode_chunk=16,
                               kv_page_size=64, max_len=1024, mesh="mp2")
    ctor_s = time.perf_counter() - t0
    eng = srv.engine
    pids = eng._tp.pids
    startup = eng._tp.startup
    # the logit probe before the serve thread runs: every prompt prefilled
    # into its own slot, one paged decode step on both ranks (led)
    _admit_all(eng, prompts, budgets)
    logits = eng._paged_step_logits(np.array([int(p[-1]) for p in prompts]))
    for i in range(len(prompts)):
        eng.release_slot(i)
    try:
        srv.start()
        srv.generate(prompts[0], max_new_tokens=2, timeout=600)   # warm-up
        before = eng._rank_counters(reset=True)
        chunks0 = len(eng.chunk_ms)
        t1 = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=int(b))
                for p, b in zip(prompts, budgets)]
        outs = [f.result(900) for f in futs]
        wall = time.perf_counter() - t1
        while eng.busy_slots():
            time.sleep(0.01)
        after = eng._rank_counters()
        chunk_ms = sorted(eng.chunk_ms[chunks0:])
        info = srv.health()["mesh"]
        capture = eng.capture_info().get("decode")
    finally:
        srv.stop()
    gone = _procs_gone(pids)
    peak0 = torch.cuda.max_memory_allocated() / 1e9
    del srv, eng
    held = _held_gb(alloc0)
    new = sum(len(o) - len(p) for o, p in zip(outs, prompts))
    tok_s = new / wall
    checks = {
        "tokens_equal_spmd": [o.tolist() for o in outs] == r0["run"]["tokens"],
        "logit_diff_within_tol":
            float(np.abs(logits - r0["one_logits"]).max())
            <= SERVE_TP_LOGIT_TOL,
        "paged_equals_layers_x_steps_each_rank":
            _launches_ok(before, after, L),
        "worker_gone_after_stop": gone,
        "memory_released": held < HELD_GB_TOL,
    }
    record = {
        "phase": "serve_tp", "arm": "single_process",
        "nvidia_smi": nvidia_smi_line(),
        "model": f"llama3_8b widths, {L} layers, bf16, mesh='mp2'",
        "backend": info.get("backend"), "requests": len(outs),
        "new_tokens": new, "tok_s": tok_s, "spmd_tok_s": r0["run"]["tok_s"],
        "over_spmd": tok_s / r0["run"]["tok_s"],
        "chunk_ms_p50": chunk_ms[len(chunk_ms) // 2] if chunk_ms else None,
        "spmd_chunk_ms_p50": r0["run"]["chunk_ms_p50"],
        "logit_diff": float(np.abs(logits - r0["one_logits"]).max()),
        "logits_bit_equal_spmd": bool((logits == r0["tp_logits"]).all()),
        "construction_s": ctor_s, "worker_startup_s": startup,
        "held_gb_after_stop": held,
        "paged_launches": [a["paged_attention"] for a in after],
        "decode_steps": [a["decode_steps"] - b["decode_steps"]
                         for b, a in zip(before, after)],
        "nvcc_in_worker": after[1]["nvcc_runs"],
        "peak_gb_by_process": [peak0, after[1].get("peak_bytes", 0) / 1e9],
        "capture": capture, "worker_pids": pids, **checks}
    emit(record)
    bad = [k for k, v in checks.items() if not v]
    if bad or after[1]["nvcc_runs"]:
        raise AssertionError(f"serve_tp single-process arm failed: {bad} "
                             f"{record}")
    return {"serve_tp single paged rank0": after[0]["paged_attention"],
            "serve_tp single paged rank1": after[1]["paged_attention"]}


def serve_spec_prompts(cfg, n):
    """The first ``n`` greedy prompts of the serve phase's workload (its
    rng and draws, budgets capped as serve_spec caps them)."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(64, 1537, 24)
    budgets = rng.integers(32, 129, 24)
    prompts = [rng.integers(0, cfg.vocab_size, (int(k),)) for k in plens]
    greedy = [i for i in range(24) if i not in (5, 17)][:n]
    return ([prompts[i] for i in greedy],
            [min(int(budgets[i]), SPEC_BUDGET_CAP) for i in greedy])


def phase_spec_tp(pt_pkg):
    """10e: speculative decoding under mp2 in this process, the draft
    replicated on both ranks."""
    import dataclasses

    import torch

    L = SPEC_TP_LAYERS
    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=L)
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    prompts, budgets = serve_spec_prompts(cfg, SPEC_TP_PROMPTS)
    runs, bad, out = [], [], {}
    for name, draft in (("self", model),
                        ("quarter", quarter_draft_config(pt_pkg, cfg))):
        alloc0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        srv = pt_pkg.ServingEngine(model, max_batch_size=SPEC_TP_PROMPTS,
                                   kv_page_size=64, max_len=2048,
                                   decode_chunk=16, draft=draft,
                                   spec_k=SPEC_K, mesh="mp2")
        ctor_s = time.perf_counter() - t0
        eng = srv.engine
        pids = eng._tp.pids
        try:
            srv.start()
            srv.generate(prompts[0][:16], max_new_tokens=2, timeout=600)
            before = eng._rank_counters(reset=True)
            st0 = dict(eng.spec.stats)
            t1 = time.perf_counter()
            futs = [srv.submit(p, max_new_tokens=b)
                    for p, b in zip(prompts, budgets)]
            outs = [f.result(900) for f in futs]
            wall = time.perf_counter() - t1
            while eng.busy_slots():
                time.sleep(0.01)
            after = eng._rank_counters()
            st = {k: eng.spec.stats[k] - st0[k] for k in st0}
            draft_model = eng.spec.describe_draft()
        finally:
            srv.stop()
        gone = _procs_gone(pids)
        del srv, eng
        held = _held_gb(alloc0)
        full = all(len(o) == len(p) + b and ((o >= 0)
                                             & (o < cfg.vocab_size)).all()
                   for o, p, b in zip(outs, prompts, budgets))
        checks = {
            "full_length": full,
            "w4_equals_layers_x_steps_each_rank":
                _launches_ok(before, after, L),
            "same_accept_lengths_on_ranks":
                after[0]["spec"] == after[1]["spec"],
            "no_page_leaked": all(a["pages_used"] == a["prefix_cached_pages"]
                                  for a in after),
            "worker_gone_after_stop": gone,
            "nvcc_in_worker": after[1]["nvcc_runs"] == 0,
            "memory_released": held < HELD_GB_TOL,
        }
        run = {"phase": "spec_tp", "nvidia_smi": nvidia_smi_line(),
               "model": f"llama3_8b widths, {L} layers, bf16, mesh='mp2'",
               "draft": name, "draft_model": draft_model,
               "held_gb_after_stop": held,
               "k": SPEC_K, "requests": len(outs),
               "new_tokens": int(sum(budgets)), "wall_s": wall,
               "tok_s": sum(budgets) / wall, "construction_s": ctor_s,
               "acceptance": (st["accepted"] / st["proposed"]
                              if st["proposed"] else None),
               "tokens_per_target_step": (st["emitted"] / st["target_steps"]
                                          if st["target_steps"] else None),
               "w4_launches": [a["paged_attention"] for a in after],
               "decode_steps": [a["decode_steps"] - b["decode_steps"]
                                for b, a in zip(before, after)],
               "accept_crc": [a["spec"]["accept_crc"] for a in after],
               "peak_gb_worker": after[1].get("peak_bytes", 0) / 1e9, **checks}
        emit(run)
        runs.append(run)
        if not all(checks.values()):
            bad.append(name)
        out[f"spec_tp {name} w4 rank0"] = after[0]["paged_attention"]
        out[f"spec_tp {name} w4 rank1"] = after[1]["paged_attention"]
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"spec_tp failed for {bad}: {runs}")
    return out


def _router_launches_ok(base, drill, layers) -> bool:
    """Kernel 1 on every rank of two engines that share this process as
    rank 0: each worker launched layers x its decode steps (> 0); this
    process's counter, shared by both engines' rank 0, layers x their
    decode steps together."""
    steps = [d[0]["decode_steps"] - b[0]["decode_steps"]
             for b, d in zip(base, drill)]
    workers = all(_launches_ok([b[1]], [d[1]], layers)
                  for b, d in zip(base, drill))
    return (workers and all(n > 0 for n in steps)
            and drill[-1][0]["paged_attention"] == layers * sum(steps))


def phase_router_tp(pt_pkg):
    """10f: the router drill over two single-process mp2 engines, then an
    mp2 replica process."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.inference.remote_replica import (
        RemoteReplicaClient, ReplicaSupervisor)
    from paddlepaddle_tpu_torch.inference.router import ServingRouter
    from paddlepaddle_tpu_torch.resilience import chaos

    L = ROUTER_TP_LAYERS
    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=L)
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    alloc0 = torch.cuda.memory_allocated()
    V = cfg.vocab_size
    made = []

    def factory():
        srv = pt_pkg.ServingEngine(model, mesh="mp2", **ROUTER_TP_ENGINE)
        made.append(srv)
        return srv

    t0 = time.perf_counter()
    r = ServingRouter([factory, factory], probe_interval_s=0.1,
                      breaker_threshold=3, breaker_reset_s=0.3)
    r.start()
    rng = np.random.default_rng(11)
    try:
        # the counters from here: rank 0's (this process, shared by both
        # engines) and each worker's; then one request straight to each
        # engine, so every rank decodes whatever the router picks
        base = [s.engine._rank_counters(reset=True) for s in made]
        for i in range(len(made)):     # no loop name left holding one
            made[i].generate(rng.integers(0, V, (64,)), max_new_tokens=2,
                             timeout=600)
        r.submit(rng.integers(0, V, (64,)), max_new_tokens=2).result(600)
        chaos.configure("serving.decode:exc:x2", seed=1234)
        futs = [r.submit(rng.integers(0, V, (int(rng.integers(32, 256)),)),
                         max_new_tokens=8) for _ in range(8)]
        oks, errs = 0, []
        for f in futs:
            try:
                f.result(600)
                oks += 1
            except Exception as e:  # noqa: BLE001 — counted, reported
                errs.append(f"{type(e).__name__}: {e}")
        chaos.disable()
        drill = [s.engine._rank_counters() for s in made]
        old = [p for s in made for p in s.engine._tp.pids]
        t1 = time.perf_counter()
        rr = r.rolling_restart()
        restart_s = time.perf_counter() - t1
        old_gone = _procs_gone(old)
        after = r.submit(rng.integers(0, V, (64,)), max_new_tokens=2
                         ).result(600)
        healthy = r.health()["router"]["healthy"]
    finally:
        chaos.disable()
        r.stop()
    drill_s = time.perf_counter() - t0
    all_gone = _procs_gone([p for s in made for p in s.engine._tp.pids])
    n_made = len(made)
    del made[:], r
    held = _held_gb(alloc0)
    checks = {
        "no_future_lost": oks + len(errs) == 8,
        "at_least_6_served": oks >= 6,
        "kernel1_on_every_rank": _router_launches_ok(base, drill, L),
        "rolling_restart_ok": rr["ok"] is True and n_made == 4,
        "old_workers_gone": old_gone,
        "served_after_restart": after.shape[0] == 66,
        "both_healthy": healthy == 2,
        "all_workers_gone_after_stop": all_gone,
        "memory_released": held < HELD_GB_TOL,
    }
    torch.cuda.empty_cache()
    # one replica process serving mp2 through replica_main
    sup = ReplicaSupervisor(
        preset="tiny", model_json=json.dumps(dataclasses.asdict(cfg)),
        engine_json=json.dumps(dict(ROUTER_TP_ENGINE, mesh="mp2")),
        warmup="off", name="router_tp", ready_timeout_s=600.0,
        term_grace_s=60.0)
    t2 = time.perf_counter()
    sup.start()
    replica_start_s = time.perf_counter() - t2
    try:
        cli = RemoteReplicaClient(address=sup.address(), name="router_tp",
                                  read_timeout_s=600.0)
        cli.start()
        prompts = [rng.integers(0, V, (n,)) for n in (48, 200)]
        outs = [cli.submit(p, max_new_tokens=8).result(600)
                for p in prompts]
        h = cli.health()
        ranks = h["kernels"]["ranks"]
        pids = [sup.pid()] + list(h["mesh"]["worker_pids"])
        sup.kill()
        replica_gone = _procs_gone(pids)
    finally:
        sup.stop(drain_timeout=5.0)
    checks.update({
        "replica_served": all(len(o) == len(p) + 8
                              for o, p in zip(outs, prompts)),
        "replica_tp2": h["mesh"]["tp"] == 2 and len(ranks) == 2,
        "replica_kernel1_each_rank": all(
            x["paged_attention"] == L * x["decode_steps"] > 0
            and x["nvcc_runs"] == 0 for x in ranks),
        "replica_processes_gone_after_sigkill": replica_gone,
    })
    emit({"phase": "router_tp", "nvidia_smi": nvidia_smi_line(),
          "model": f"llama3_8b widths, {L} layers, bf16, mesh='mp2'",
          "served": oks, "errors": errs, "drill_s": drill_s,
          "rolling_restart_s": restart_s, "held_gb_after_stop": held,
          "paged_launches_rank0_both_engines": drill[-1][0][
              "paged_attention"],
          "paged_launches_worker_by_engine": [d[1]["paged_attention"]
                                              for d in drill],
          "decode_steps_by_engine": [[x["decode_steps"] - y["decode_steps"]
                                      for y, x in zip(b, d)]
                                     for b, d in zip(base, drill)],
          "replica_start_s": replica_start_s,
          "replica_ranks": ranks, **checks})
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"router_tp failed: {bad}")
    return {"router_tp paged rank0": drill[-1][0]["paged_attention"],
            "router_tp paged workers": [d[1]["paged_attention"]
                                        for d in drill],
            "router_tp replica paged": [x["paged_attention"]
                                        for x in ranks]}


# -- 10j-10k: the fsdp axis, ZeRO-3 (A10's fsdp slice) ------------------------

FSDP_PARITY_STEPS = 2
FSDP_PARITY_BATCH = (4, 256)
FSDP_LOSS_RTOL = 1e-5      # f32: the gathers are exact, the data-group sums
#                            reorder the gradients' sums only
FSDP_PARAM_ATOL = 1e-4     # under the smallest matrix's move (2.7e-4)
# (arm, mesh spec, data axes, group_sharded_parallel p_g_os)
FSDP_LLAMA_ARMS = (("fsdp2", "fsdp2", ("dp", "fsdp"), False),
                   ("dp2fsdp2", "dp2fsdp2", ("dp", "fsdp"), False),
                   ("fsdp2mp2", "fsdp2mp2", ("dp", "fsdp"), False),
                   ("p_g_os dp2fsdp2", "dp2fsdp2", ("dp",), True))
FSDP_PARITY_LR = 0.2
TRAIN_FSDP_RESIDENT = 0.55  # a rank's shards + optimizer state over one's
_FSDP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "gather_gemm_ffn")


def _fsdp_opt(pt_pkg, model, lr=1e-3, multi_precision=False):
    return pt_pkg.AdamW(learning_rate=lr, multi_precision=multi_precision,
                        parameters=model.named_parameters(),
                        grad_clip=pt_pkg.ClipGradByGlobalNorm(1.0))


def _fsdp_parity_opt(pt_pkg, model):
    """Momentum, no clip: each parameter moves with its gradient's scale
    (the smallest matrix's largest move, 2.7e-4, is past the parameter
    gate), so a gradient summed where it should be sliced shows. Adam
    turns f32 rounding of near-cancelling gradients into moves of 1e-4 at
    these widths, and a clip that binds would hide a uniform scale."""
    return pt_pkg.Momentum(learning_rate=FSDP_PARITY_LR, momentum=0.9,
                           parameters=model.named_parameters())


def _fsdp_models(pt_pkg):
    """fsdp_parity's two models: (label, config, a function that makes
    the model from the config, rules)."""
    from paddlepaddle_tpu_torch.distributed import moe_train_rules

    return (("llama", pt_pkg.LlamaConfig(**TP_TINY),
             lambda c: pt_pkg.LlamaForCausalLM(c, seed=1), None),
            ("moe", pt_pkg.MoEConfig(**EP_PARITY),
             lambda c: pt_pkg.MoEForCausalLM(c, seed=0), moe_train_rules()))


def _fsdp_reference(pt_pkg, cfg, make, ids) -> dict:
    """A one-process ``TrainStep``'s losses and parameters after
    ``FSDP_PARITY_STEPS`` steps of :func:`_fsdp_parity_opt`."""
    m1 = make(cfg)
    one = pt_pkg.TrainStep(m1, _fsdp_parity_opt(pt_pkg, m1), _llm_loss)
    losses = [float(one(ids, ids)) for _ in range(FSDP_PARITY_STEPS)]
    return {"losses": losses,
            "params": {n: p.detach().clone()
                       for n, p in m1.named_parameters()}}


def _fsdp_arm(model, step, ids, ref, sharded="fsdp"):
    """Train one arm of fsdp_parity (``step`` over ``model``, on every
    rank) and, on the rank that holds ``ref``, hold it against the one
    process: this rank's launches of ``_FSDP_KERNELS`` and, there, the
    losses, the parameter error and whether every gate held (a parameter
    sharded over ``sharded`` among them, unless it is None)."""
    step._rank_stats(reset=True)
    got = [float(step(ids, ids)) for _ in range(FSDP_PARITY_STEPS)]
    ranks = step._rank_stats()
    step.sync_to_model()
    rec = {"launches_by_rank": [{k: r["launches"][k] for k in _FSDP_KERNELS}
                                for r in ranks],
           "sharded_over": sorted({a for spec in step.specs.values()
                                   for e in spec for a in (
                                       (e,) if isinstance(e, str)
                                       else (e or ()))})}
    if ref is None:
        return rec
    want = FSDP_PARITY_STEPS * ref["layers"]
    rec.update(losses=got, max_rel_loss_err=max(
        abs(a - b) / abs(b) for a, b in zip(got, ref["losses"])),
        max_abs_param_err=max(
            float((p.detach() - ref["params"][n]).abs().max())
            for n, p in model.named_parameters()),
        expected_launches=want)
    rec["ok"] = (rec["max_rel_loss_err"] <= FSDP_LOSS_RTOL
                 and rec["max_abs_param_err"] <= FSDP_PARAM_ATOL
                 and (sharded is None or sharded in rec["sharded_over"]))
    return rec


def _fsdp_parity_rank(ids_np):
    """fsdp_parity's four-rank arms in the SPMD form (every rank builds
    the step; rank 0 also runs the one-process references): each arm's
    record from rank 0, every rank's launches and ``nvcc`` runs."""
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.distributed.sharding import \
        group_sharded_parallel
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    rank = _rank_init("gloo")
    ids = torch.from_numpy(ids_np).cuda()
    out = {"rank": rank}
    for label, cfg, make, rules in _fsdp_models(pt):
        ref = None
        if rank == 0:
            ref = _fsdp_reference(pt, cfg, make, ids)
            ref["layers"] = cfg.num_hidden_layers
        arms = FSDP_LLAMA_ARMS[1:] if label == "llama" else (
            ("dp2fsdp2", "dp2fsdp2", ("dp", "fsdp"), False),
            # ep beside fsdp: the trunk on fsdp, each rank's E/2 banks
            ("fsdp2ep2", "fsdp2ep2", ("fsdp",), False))
        for arm, spec, data_axes, p_g_os in arms:
            model = make(cfg)
            opt = _fsdp_parity_opt(pt, model)
            if p_g_os:
                model, opt, _ = group_sharded_parallel(model, opt, "p_g_os")
            step = ShardedTrainStep(model, opt, _llm_loss, plan=train_plan(
                spec, rules=rules, data_axes=data_axes))
            out[f"{label} {arm}"] = _fsdp_arm(model, step, ids, ref)
            del step, model
            gc.collect()
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def phase_fsdp_parity(pt_pkg):
    """10j: ``ShardedTrainStep`` under an ``fsdp`` axis on ranks that share
    ``cuda:0`` over gloo: the f32 Llama of ``TP_TINY`` on ``fsdp2`` (in
    this process: the step starts rank 1), and on ``dp2fsdp2``,
    ``fsdp2mp2`` (the Llama table: every matrix on fsdp, and on mp) and
    the ``p_g_os`` arm over ``dp2fsdp2`` with ``data_axes=("dp",)`` (every
    parameter's largest dim on fsdp, the batch on dp alone), and the f32
    MoE of ``EP_PARITY`` (fused) on ``dp2fsdp2`` (``moe_train_rules``: the
    trunk on fsdp, the banks whole) and on ``fsdp2ep2`` with
    ``data_axes=("fsdp",)`` (the trunk on fsdp, each rank's E/2 banks on
    ep: kernel 8 on the local banks), these five on four ranks the script
    spawns (SPMD). Each against a one-process ``TrainStep`` on the card,
    two momentum steps (:func:`_fsdp_parity_opt`) on the same weights and
    batch: losses, synced parameters, kernels 2-4 on every rank, and
    kernel 8 on every rank of the MoE."""
    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    ids_np = np.random.default_rng(0).integers(0, 1024, FSDP_PARITY_BATCH)
    t0 = time.perf_counter()
    # the four SPMD ranks start and run while this process runs the fsdp2
    # arm (the phase's time is the longer of the two)
    job = _spawn_beside(_fsdp_parity_rank, (ids_np,), 4)
    out = {}

    # fsdp2 in this process: the single-process form
    _, cfg, make, rules = _fsdp_models(pt_pkg)[0]
    ids = torch.from_numpy(ids_np).cuda()
    ref = _fsdp_reference(pt_pkg, cfg, make, ids)
    ref["layers"] = cfg.num_hidden_layers
    out["llama one_process"] = ref["losses"]
    model = make(cfg)
    t0 = time.perf_counter()
    step = ShardedTrainStep(model, _fsdp_parity_opt(pt_pkg, model),
                            _llm_loss, plan=train_plan("fsdp2"))
    ctor_s = time.perf_counter() - t0
    pids = step.workers.pids
    try:
        rec = _fsdp_arm(model, step, ids, ref)
    finally:
        step.close()
    rec.update(construction_s=ctor_s, workers_gone=_procs_gone(pids))
    out["llama fsdp2"] = rec
    del step, model, ref
    gc.collect()
    torch.cuda.empty_cache()
    ranks = job.result()
    out["spmd_wall_s"] = time.perf_counter() - t0
    for key, rec in ranks[0].items():
        if key not in ("rank", "nvcc"):
            rec["launches_by_rank"] = [r[key]["launches_by_rank"][0]
                                       for r in ranks]
            out[key] = rec

    bad = []
    for key, rec in out.items():
        if not isinstance(rec, dict) or "ok" not in rec:
            continue
        kernels = _FSDP_KERNELS if key.startswith("moe") else \
            _FSDP_KERNELS[:3]
        if not rec["ok"] or any(r[k] != rec["expected_launches"]
                                for r in rec["launches_by_rank"]
                                for k in kernels) \
                or rec.get("workers_gone") is False:
            bad.append(key)
    nvcc = sum(r["nvcc"] for r in ranks)
    emit({"phase": "fsdp_parity", "nvidia_smi": nvidia_smi_line(),
          "llama": "f32, hidden 1024, 8 heads / 4 KV, 2 layers",
          "moe": "f32 MoE d 128, h 256, E 8, top-2, 2 layers, fused",
          "batch": FSDP_PARITY_BATCH, "loss_rtol": FSDP_LOSS_RTOL,
          "param_atol": FSDP_PARAM_ATOL, "nvcc_in_ranks": nvcc, **out})
    if bad or nvcc:
        raise AssertionError(f"fsdp_parity failed for {bad} (nvcc in the "
                             f"ranks: {nvcc}): {out}")
    return {f"fsdp_parity {k}": v["launches_by_rank"]
            for k, v in out.items() if isinstance(v, dict)}


def phase_train_fsdp(pt_pkg):
    """10k: Llama-3-8B widths at ``TRAIN_TP_LAYERS`` layers, bf16,
    multi-precision AdamW + global-norm clip, batch 4 x 512,
    ``TRAIN_TP_STEPS`` steps: a one-process ``TrainStep`` (then freed), then
    ``ShardedTrainStep`` over ``fsdp2`` in this process (rank 1 started on
    ``cuda:0``, gloo). Losses within ``TRAIN_TP_LOSS_TOL``; rank 0's first
    gradients of ``TRAIN_TP_GRADS`` (its fsdp slices) within
    ``TRAIN_TP_GRAD_RTOL`` of one process's; each rank's resident bytes
    (parameter shards + optimizer state, counted from the tensors) at most
    ``TRAIN_FSDP_RESIDENT`` of one process's; kernels 2-4 on each rank;
    each rank's peak GB, ms a step, and the all-gathers' and
    reduce-scatters' counts, bytes and (rank 0, last step) ms."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.distributed import collective as C
    from paddlepaddle_tpu_torch.distributed import train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep
    from paddlepaddle_tpu_torch.parallel.sharded import resident_bytes

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_TP_LAYERS)
    L = TRAIN_TP_LAYERS
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_TP_BATCH, TRAIN_TP_SEQ))).cuda()

    def run(step):
        # every rank counts its collectives over the steps; rank 0 times
        # its own in the last step (a device sync around each)
        losses, ms = [], []
        for i in range(TRAIN_TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with C.timing(i == TRAIN_TP_STEPS - 1):
                losses.append(float(step(ids, ids)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    one = pt_pkg.TrainStep(model, _fsdp_opt(pt_pkg, model, 1e-4, True),
                           _llm_loss)
    want = _first_grads(one.optimizer, TRAIN_TP_GRADS)
    one_losses, one_ms = run(one)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    one_bytes = resident_bytes(one.params.values(), one.optimizer)
    del one, model
    gc.collect()
    torch.cuda.empty_cache()

    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0, init_std=0.02)
    t0 = time.perf_counter()
    step = ShardedTrainStep(model, _fsdp_opt(pt_pkg, model, 1e-4, True),
                            _llm_loss, plan=train_plan("fsdp2"))
    ctor_s = time.perf_counter() - t0
    got = _first_grads(step.optimizer, TRAIN_TP_GRADS)
    pids, startup = step.workers.pids, dict(step.workers.startup)
    try:
        step._rank_stats(reset=True)
        losses, ms = run(step)
        ranks = step._rank_stats()
    finally:
        step.close()
    gone = _procs_gone(pids)
    del step, model
    held = _held_gb(before)
    gc.collect()
    torch.cuda.empty_cache()

    err = max(abs(a - b) for a, b in zip(losses, one_losses))
    grad_err = {n: _slice_err(got[n], want[n]) for n in sorted(want)}
    share = [r["resident_bytes"] / one_bytes for r in ranks]
    n = L * TRAIN_TP_STEPS
    want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    steps = TRAIN_TP_STEPS
    per_step = {op: {"calls_by_rank": [r["collectives"].get(op, {}).get(
                         "calls", 0) / steps for r in ranks],
                     "bytes_by_rank": [r["collectives"].get(op, {}).get(
                         "bytes", 0) / steps for r in ranks],
                     "ms_rank0_last_step": ranks[0]["collectives"].get(
                         op, {}).get("seconds", 0.0) * 1e3}
                for op in ("all_gather", "reduce_scatter", "all_reduce")}
    rec = {"phase": "train_fsdp", "nvidia_smi": nvidia_smi_line(),
           "model": f"llama3_8b widths, {L} layers, bf16, multi-precision "
                    "AdamW + clip",
           "backend": "gloo (2 ranks share cuda:0; collectives via host)",
           "batch": [TRAIN_TP_BATCH, TRAIN_TP_SEQ],
           "one_process": {"losses": one_losses, "step_ms": one_ms,
                           "peak_gb": one_peak,
                           "resident_gb": one_bytes / 1e9},
           "fsdp2": {"losses": losses, "step_ms": ms,
                     "max_abs_loss_err": err, "grad_rel_err": grad_err,
                     "construction_s": ctor_s,
                     "worker_startup_s": startup,
                     "resident_gb_by_rank": [r["resident_bytes"] / 1e9
                                             for r in ranks],
                     "resident_share_by_rank": share,
                     "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
                     "launches_by_rank": [{k: r["launches"][k] for k in want}
                                          for r in ranks],
                     "collectives_per_step": per_step,
                     "nvcc_in_worker": sum(r["nvcc"] for r in ranks[1:]),
                     "workers_gone": gone, "held_gb": held},
           "loss_tol": TRAIN_TP_LOSS_TOL, "grad_rtol": TRAIN_TP_GRAD_RTOL,
           "resident_share_max": TRAIN_FSDP_RESIDENT}
    emit(rec)
    if err > TRAIN_TP_LOSS_TOL or not np.isfinite(losses).all() \
            or max(grad_err.values()) > TRAIN_TP_GRAD_RTOL \
            or max(share) > TRAIN_FSDP_RESIDENT \
            or any(r["launches"][k] != v for r in ranks
                   for k, v in want.items()) \
            or rec["fsdp2"]["nvcc_in_worker"] or not gone \
            or held > HELD_GB_TOL:
        raise AssertionError(f"train_fsdp failed: {rec}")
    return {"launches_by_rank": rec["fsdp2"]["launches_by_rank"]}


# -- 10l-10m: the pipeline executor and the 4D hybrid (A10 slice 4) ----------

PP_PARITY_CFG = dict(hidden_size=256, intermediate_size=512, num_heads=4,
                     num_kv_heads=2, layers_per_stage=1, vocab_size=512,
                     max_seq_len=128)          # head dim 64: kernels 2-4
PP_PARITY_BATCH, PP_PARITY_M = (8, 128), 4
PP_LOSS_RTOL = 1e-4                            # tests/test_hybrid_4d.py's
PP_GRAD_RTOL, PP_GRAD_ATOL = 2e-3, 2e-4
PP_MOE = dict(E=4, topk=2, cf=8.0, eh=128, ep_size=2)
_PP_D4 = ("dp", "fsdp", "tp", "pp")
_PP_D5 = ("dp", "fsdp", "ep", "tp", "pp")
# (arm, mesh shape, axis names, schedule, V, layers a stage, MoE stage)
PP_PARITY_ARMS = (
    ("dp1fsdp2tp2pp2 1f1b", (1, 2, 2, 2), _PP_D4, "1f1b", 1, 1, False),
    ("dp1fsdp2tp2pp2 gpipe", (1, 2, 2, 2), _PP_D4, "gpipe", 1, 1, False),
    ("dp1fsdp2tp2pp2 zbh1", (1, 2, 2, 2), _PP_D4, "zbh1", 1, 1, False),
    ("dp1fsdp2tp2pp2 1f1b L2", (1, 2, 2, 2), _PP_D4, "1f1b", 1, 2, False),
    ("dp1fsdp2tp2pp2 interleaved V2", (1, 2, 2, 2), _PP_D4, "interleaved",
     2, 1, False),
    ("dp1fsdp2tp2pp2 zbvpp V2", (1, 2, 2, 2), _PP_D4, "zbvpp", 2, 1, False),
    ("dp2fsdp1tp2pp2 1f1b", (2, 1, 2, 2), _PP_D4, "1f1b", 1, 1, False),
    ("moe dp1fsdp1ep2tp2pp2 1f1b", (1, 1, 2, 2, 2), _PP_D5, "1f1b", 1, 1,
     True),
    # the 5-D hybrid (tests/test_hybrid_4d.py:196): context parallelism in
    # the stages (one causal flash call over the gathered K/V prefix)
    ("5d dp1fsdp1sp2tp2pp2 1f1b", (1, 1, 2, 2, 2),
     ("dp", "fsdp", "sp", "tp", "pp"), "1f1b", 1, 1, "sp"),
)
# Llama-3-8B widths, 2 layers a stage on pp2: 4 of 32 layers
TRAIN_PP_LAYERS = 2
TRAIN_PP_CFG = dict(hidden_size=4096, intermediate_size=14336, num_heads=32,
                    num_kv_heads=8, layers_per_stage=TRAIN_PP_LAYERS,
                    vocab_size=128256, max_seq_len=1024, rope_theta=500000.0,
                    rms_norm_eps=1e-5)
TRAIN_PP_BATCH, TRAIN_PP_M = (8, 1024), 8
TRAIN_PP_SCHEDULES = ("1f1b", "gpipe", "zbh1")
# timed calls a schedule, after one warm-up call before the first schedule
TRAIN_PP_TIMED = 1
# abs, bf16 losses, pipeline vs one rank (read: 1.2e-7 to 1.1e-6)
TRAIN_PP_LOSS_TOL = 1e-4
# relative Frobenius norm of the difference, bf16: the head's weight grad,
# the stages' wq grads and dacts, pipeline vs the one-rank arm's .grad.
# Read: 0 for 1F1B and ZBH1 (the same bf16 sums in the same order); GPipe
# runs its backwards last microbatch first, so its bf16 sums over the
# microbatches differ (head 2.5e-3, wq 5.1e-3; dacts 0, a sum of none)
TRAIN_PP_GRAD_RTOL = 1e-2


def pp_predicted_launches(schedule: str, L: int, M: int, V: int, S: int,
                          s: int) -> dict:
    """Kernels 2-4 launched on pp rank ``s`` by one ``spmd_pipeline_train``
    call of a remat stage block: per layer and microbatch, ``F`` runs the
    forward once (not at the last virtual stage: its backward recomputes
    it); a fused ``B`` runs it twice (its recompute and the checkpoint's)
    and the backward pair once; a split ``BX`` + ``BW`` each of those."""
    split = schedule in ("zbh1", "zbvpp")
    fwd = sum((0 if (c == V - 1 and s == S - 1) else 1) + (4 if split else 2)
              for c in range(V))
    bwd = V * (2 if split else 1)
    return {"flash_fwd": L * M * fwd, "flash_bwd_dq": L * M * bwd,
            "flash_bwd_dkv": L * M * bwd}


def _pp_problem(cfg, n_stages, seed, moe):
    """Stage and head params (numpy f32, the reference's init scales), the
    embedded batch and its ids, from ``seed``: what the JAX package's
    pytrees look like before ``convert.convert_pytree``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, f, hd, L = (cfg.hidden_size, cfg.intermediate_size, cfg.head_dim,
                   cfg.layers_per_stage)

    def w(shape, fan_in):
        return (rng.standard_normal((L,) + shape) / np.sqrt(fan_in)).astype(
            np.float32)

    stages = []
    for _ in range(n_stages):
        st = {"ln1": np.ones((L, h), np.float32),
              "ln2": np.ones((L, h), np.float32),
              "wq": w((h, cfg.num_heads * hd), h),
              "wk": w((h, cfg.num_kv_heads * hd), h),
              "wv": w((h, cfg.num_kv_heads * hd), h),
              "wo": w((cfg.num_heads * hd, h), cfg.num_heads * hd)}
        if moe is True:
            E, eh = PP_MOE["E"], PP_MOE["eh"]
            st.update(gate=w((h, E), h), eg=w((E, h, eh), h),
                      eu=w((E, h, eh), h), ed=w((E, eh, h), eh))
        else:
            st.update(wg=w((h, f), h), wu=w((h, f), h), wd=w((f, h), f))
        stages.append(st)
    head = {"ln": np.ones((h,), np.float32),
            "w": (rng.standard_normal((h, cfg.vocab_size)) / np.sqrt(h)
                  ).astype(np.float32)}
    b, s = PP_PARITY_BATCH
    acts = rng.standard_normal((b, s, h)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (b, s))
    return stages, head, acts, ids


def _pp_oracle(H, cfg, stages, head, acts, ids, moe):
    """The unsharded one-rank forward with plain attention (the parity
    oracle: ``reference_forward``, or the MoE stages chained) and its
    gradients."""
    import torch

    st = [{k: v.clone().requires_grad_() for k, v in s.items()}
          for s in stages]
    hp = {k: v.clone().requires_grad_() for k, v in head.items()}
    a = acts.clone().requires_grad_()
    if moe is True:
        block = H.make_moe_block(cfg, PP_MOE["E"], topk=PP_MOE["topk"],
                                 capacity_factor=PP_MOE["cf"], tp_axis=None,
                                 fsdp_axis=None, ep_axis=None, ep_size=1,
                                 remat=False, use_flash=False)
        x = a
        for sp in st:
            x = block(sp, x)
        loss = H.make_vocab_parallel_head(cfg, tp_axis=None)(hp, x, ids)
    else:
        loss = H.reference_forward(cfg, st, hp, a, ids)
    loss.backward()
    with torch.no_grad():
        return (float(loss), [{k: v.grad for k, v in s.items()} for s in st],
                {k: v.grad for k, v in hp.items()}, a.grad)


def _pp_err(got, want) -> dict:
    """The largest absolute error, and whether every element is within
    ``PP_GRAD_ATOL + PP_GRAD_RTOL * |want|``."""
    import torch

    d = (got.float() - want.float()).abs()
    ok = bool((d <= PP_GRAD_ATOL + PP_GRAD_RTOL * want.float().abs()).all())
    return {"max_abs_err": float(d.max()), "ok": ok}


def _pp_parity_rank():
    """Every arm of ``PP_PARITY_ARMS`` on this rank: the executor's whole
    outputs against the unsharded oracle on the card, and this rank's
    kernel 2-4 launches against :func:`pp_predicted_launches`."""
    import torch

    from paddlepaddle_tpu_torch.convert import convert_pytree
    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import hybrid as H
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps

    rank = _rank_init("gloo")
    dev = torch.device("cuda")
    out = {"rank": rank}
    meshes = {}              # one mesh (and its groups) for the arms it serves
    M = PP_PARITY_M
    for i, (arm, shape, names, sched, V, L, moe) in enumerate(
            PP_PARITY_ARMS):
        cfg = H.HybridStageConfig(**dict(PP_PARITY_CFG, layers_per_stage=L))
        st_np, hd_np, a_np, ids_np = _pp_problem(cfg, 2 * V, i, moe)
        stages = [convert_pytree(s_, device=dev) for s_ in st_np]
        head = convert_pytree(hd_np, device=dev)
        acts = convert_pytree(a_np, device=dev)
        ids = torch.from_numpy(ids_np).to(dev)
        sp = "sp" if moe == "sp" else None
        if moe is True:
            block = H.make_moe_block(
                cfg, PP_MOE["E"], topk=PP_MOE["topk"],
                capacity_factor=PP_MOE["cf"], ep_size=PP_MOE["ep_size"])
            specs = H.moe_stage_specs()
        else:
            block = H.make_llama_block(cfg, sp_axis=sp,
                                       sp_size=2 if sp else 1)
            specs = H.llama_stage_specs()
        stacked = (ps.stack_stage_params(stages) if V == 1
                   else ps.stack_virtual_stage_params(stages, 2))
        if (shape, names) not in meshes:
            meshes[(shape, names)] = ProcessMesh(shape=list(shape),
                                                 dim_names=list(names))
        mesh = meshes[(shape, names)]
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g_st, g_h, g_a = ps.spmd_pipeline_train(
            stacked, head, acts, ids, block,
            H.make_vocab_parallel_head(cfg, sp_axis=sp), mesh,
            schedule=sched, n_microbatches=M, num_virtual=V,
            data_axis=("dp", "fsdp"), param_specs=specs,
            head_specs=H.llama_head_specs(), seq_axis=sp)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = _rank_counts()["flash"]
        want = pp_predicted_launches(sched, L, M, V, 2,
                                     mesh.coords(rank)["pp"])
        r_loss, r_st, r_h, r_a = _pp_oracle(H, cfg, stages, head, acts, ids,
                                            moe)
        r_st = (ps.stack_stage_params(r_st) if V == 1
                else ps.stack_virtual_stage_params(r_st, 2))
        errs = {f"stage.{k}": _pp_err(g_st[k], r_st[k]) for k in r_st}
        errs.update({f"head.{k}": _pp_err(g_h[k], r_h[k]) for k in r_h})
        errs["dacts"] = _pp_err(g_a, r_a)
        loss_rel = abs(float(loss) - r_loss) / abs(r_loss)
        out[arm] = {"loss": float(loss), "oracle_loss": r_loss,
                    "loss_rel_err": loss_rel, "call_s": call_s,
                    "max_abs_grad_err": max(e["max_abs_err"]
                                            for e in errs.values()),
                    "bad_trees": sorted(k for k, e in errs.items()
                                        if not e["ok"]),
                    "launches": launches, "predicted": want,
                    "walk_s": ps.last_stats()["walk_s"]}
        out[arm]["ok"] = (loss_rel <= PP_LOSS_RTOL
                          and not out[arm]["bad_trees"]
                          and launches == want)
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def phase_pp_parity(pt_pkg, job=None):
    """10l: the pipeline gate. ``spmd_pipeline_train`` over the hybrid's
    Llama stages (f32, hidden 256, head dim 64, ``PP_PARITY_CFG``) on 8
    ranks the script spawns once (SPMD, gloo, all on ``cuda:0``):
    ``dp1 fsdp2 tp2 pp2`` under 1F1B, GPipe and ZBH1, 1F1B at two layers
    a stage, the interleaved and ZBVPP schedules at V 2; ``dp2 fsdp1 tp2
    pp2`` under 1F1B; the MoE stage on ``dp1 fsdp1 ep2 tp2 pp2``; the
    5-D hybrid ``dp1 fsdp1 sp2 tp2 pp2`` (context-parallel stages and
    head, ``seq_axis="sp"``: one causal flash call a layer over the
    gathered K/V prefix). Each rank holds the whole loss (rtol
    ``PP_LOSS_RTOL``) and the stage, head and input-cotangent gradients
    (``PP_GRAD_RTOL`` / ``PP_GRAD_ATOL``) against the unsharded oracle
    with plain attention on the card, and its kernel 2-4 launches against
    :func:`pp_predicted_launches`.
    ``job``: the ranks already started (:func:`_spawn_beside`: ``main``
    runs them beside the untimed parity phases), else they start here."""
    t0 = time.perf_counter()
    if job is None:
        job = _spawn_beside(_pp_parity_rank, (), 8)
    ranks = job.result()
    wall = time.perf_counter() - t0
    arms, bad = {}, []
    for arm, *_ in PP_PARITY_ARMS:
        recs = [r[arm] for r in ranks]
        arms[arm] = {
            "loss": recs[0]["loss"], "oracle_loss": recs[0]["oracle_loss"],
            "max_loss_rel_err": max(r["loss_rel_err"] for r in recs),
            "max_abs_grad_err": max(r["max_abs_grad_err"] for r in recs),
            "bad_trees_by_rank": [r["bad_trees"] for r in recs],
            "launches_by_rank": [r["launches"] for r in recs],
            "predicted_by_rank": [r["predicted"] for r in recs],
            "call_s_rank0": recs[0]["call_s"],
            "walk_s_rank0": recs[0]["walk_s"]}
        if not all(r["ok"] for r in recs):
            bad.append(arm)
    nvcc = sum(r["nvcc"] for r in ranks)
    emit({"phase": "pp_parity", "nvidia_smi": nvidia_smi_line(),
          "config": dict(PP_PARITY_CFG, dtype="float32"),
          "batch": PP_PARITY_BATCH, "microbatches": PP_PARITY_M,
          "moe": PP_MOE, "loss_rtol": PP_LOSS_RTOL,
          "grad_rtol": PP_GRAD_RTOL, "grad_atol": PP_GRAD_ATOL,
          "spawn_wall_s": wall, "nvcc_in_ranks": nvcc, "arms": arms})
    if bad or nvcc:
        raise AssertionError(f"pp_parity failed for {bad} (nvcc in the "
                             f"ranks: {nvcc}): {arms}")
    return {f"pp_parity {k}": v["launches_by_rank"] for k, v in arms.items()}


def _train_pp_rank():
    """train_pp on one of two ranks: every schedule of
    ``TRAIN_PP_SCHEDULES`` (``TRAIN_PP_TIMED`` timed calls, a warm-up
    call before the first), then, on rank 0, the one-rank arm."""
    import torch

    from paddlepaddle_tpu_torch.distributed import ProcessMesh
    from paddlepaddle_tpu_torch.parallel import hybrid as H
    from paddlepaddle_tpu_torch.parallel import pipeline_spmd as ps
    from paddlepaddle_tpu_torch.parallel.schedules import build_schedule

    rank = _rank_init("gloo")
    dev = torch.device("cuda")
    cfg = H.HybridStageConfig(**TRAIN_PP_CFG)
    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(0)
    stacked = ps.stack_stage_params(
        [H.init_llama_stage(cfg, g, bf16) for _ in range(2)])
    head = H.init_llama_head(cfg, g, bf16)
    b, s = TRAIN_PP_BATCH
    acts = torch.randn((b, s, cfg.hidden_size), generator=g, device=dev,
                       dtype=torch.float32).to(bf16)
    ids = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size()
                      for t in list(stacked.values()) + list(head.values()))
    block = H.make_llama_block(cfg, tp_axis=None, fsdp_axis=None,
                               remat=True)
    head_fn = H.make_vocab_parallel_head(cfg, tp_axis=None)
    mesh = ProcessMesh(shape=[2], dim_names=["pp"])
    M = TRAIN_PP_M
    out = {"rank": rank, "init_s": init_s, "param_gb": param_bytes / 1e9}
    kept = {}                # rank 0: each schedule's last gradients
    for name in TRAIN_PP_SCHEDULES:
        sched = build_schedule(name, 2, M)
        calls = []
        # one warm-up call, before the first schedule's timed calls
        n_calls = TRAIN_PP_TIMED + (name == TRAIN_PP_SCHEDULES[0])
        for i in range(n_calls):
            _reset_counts()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss, g_st, g_h, g_a = ps.spmd_pipeline_train(
                stacked, head, acts, ids, block, head_fn, mesh,
                schedule=sched)
            torch.cuda.synchronize()
            total = time.perf_counter() - t1
            st = ps.last_stats()
            calls.append({
                "loss": float(loss), "call_ms": total * 1e3,
                "step_ms": (st["walk_s"] + st["reduce_s"]) * 1e3,
                "walk_ms": st["walk_s"] * 1e3,
                "gather_ms": st["gather_s"] * 1e3,
                "head_sum": {"bytes": st["head_sum"]["bytes"],
                             "ms": st["head_sum"]["s"] * 1e3},
                "dacts_sum": {"bytes": st["dacts_sum"]["bytes"],
                              "ms": st["dacts_sum"]["s"] * 1e3},
                "p2p": {"calls": st["p2p"]["calls"],
                        "bytes": st["p2p"]["bytes"],
                        "post_ms": st["p2p"]["post_s"] * 1e3,
                        "wait_ms": st["p2p"]["wait_s"] * 1e3},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "finite": bool(torch.isfinite(g_st["wq"]).all()
                               and torch.isfinite(g_h["w"]).all()
                               and torch.isfinite(g_a).all()),
                "launches": _rank_counts()["flash"]})
            if rank == 0 and i == n_calls - 1:
                # held on the host, so the next calls' peaks leave them out
                kept[name] = {"head.w": g_h["w"].cpu(),
                              "stage.wq": g_st["wq"].cpu(), "dacts": g_a.cpu()}
            del loss, g_st, g_h, g_a
        est = sched.memory_estimate((b // M, s, cfg.hidden_size), 2)
        out[name] = {
            "bubble_fraction": sched.stats["bubble_fraction"],
            "T": sched.T, "memory_estimate_gb": est["total"] / 1e9,
            "estimate_plus_params_gb": (est["total"] + param_bytes) / 1e9,
            "predicted": pp_predicted_launches(name, TRAIN_PP_LAYERS, M, 1,
                                               2, rank),
            "calls": calls}
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["one_rank"], want = _train_pp_one_rank(H, cfg, block, head_fn,
                                                   stacked, head, acts, ids)
        for name, got in kept.items():
            out[name]["grad_rel_err"] = {
                k: float((g.to(dev).float() - want[k].float()).norm()
                         / want[k].float().norm()) for k, g in got.items()}
        del kept, want
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def _train_pp_one_rank(H, cfg, block, head_fn, stacked, head, acts, ids):
    """The four layers and the head chained on one rank under autograd,
    with flash and the same remat, microbatch by microbatch (each loss
    over M): its loss and step ms (a warm-up, then ``TRAIN_PP_TIMED``),
    and the last step's ``.grad`` of what train_pp holds the pipeline's
    gradients against (the head's weight, the stages' wq, the input)."""
    import torch

    M = TRAIN_PP_M
    stages = [{k: v[i].detach().requires_grad_() for k, v in stacked.items()}
              for i in range(2)]
    hp = {k: v.detach().requires_grad_() for k, v in head.items()}
    a = acts.detach().requires_grad_()
    leaves = [t for st in stages for t in st.values()] + list(hp.values()) \
        + [a]
    ys = ids.chunk(M)
    losses, ms = [], []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(1 + TRAIN_PP_TIMED):
        for t in leaves:
            t.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs = a.chunk(M)
        total = 0.0
        for m in range(M):
            x = xs[m]
            for st in stages:
                x = block(st, x)
            loss = head_fn(hp, x, ys[m]) / M
            loss.backward()
            total += float(loss.detach())
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(total)
    peak = torch.cuda.max_memory_allocated() / 1e9
    grads = {"head.w": hp["w"].grad,
             "stage.wq": torch.stack([st["wq"].grad for st in stages]),
             "dacts": a.grad}
    return {"losses": losses, "step_ms": ms, "peak_gb": peak}, grads


def phase_train_pp(pt_pkg):
    """10m: Llama-3-8B widths (hidden 4096, MLP 14336, 32 q / 8 KV heads,
    vocab 128256), ``TRAIN_PP_LAYERS`` layers a stage on ``pp2`` (two
    ranks the script spawns, sharing ``cuda:0`` over gloo), bf16, batch
    ``TRAIN_PP_BATCH``, ``TRAIN_PP_M`` microbatches: 1F1B, GPipe and ZBH1,
    ``TRAIN_PP_TIMED`` timed calls each (one warm-up call before the
    first), beside the one-rank arm. Per schedule and rank: step ms (the
    schedule walk and the sums over ``pp``; the final gathers apart), the
    schedule's bubble, P2P calls, bytes and ms, the head-grad and
    ``dacts`` sums over ``pp``, peak GB beside ``memory_estimate`` + the
    parameters each rank holds, kernels 2-4 against
    :func:`pp_predicted_launches`, the loss against the one-rank arm's
    (``TRAIN_PP_LOSS_TOL``), and the head's weight grad, the stages' wq
    grads and ``dacts`` against its ``.grad`` (relative norm,
    ``TRAIN_PP_GRAD_RTOL``)."""
    import numpy as np

    from paddlepaddle_tpu_torch.distributed import spawn

    t0 = time.perf_counter()
    ranks = spawn(_train_pp_rank, nprocs=2, **TP_SPAWN)
    wall = time.perf_counter() - t0
    one = ranks[0]["one_rank"]
    rec = {"phase": "train_pp", "nvidia_smi": nvidia_smi_line(),
           "model": f"llama3_8b widths, {TRAIN_PP_LAYERS} layers a stage x "
                    "pp2, bf16, remat", "config": TRAIN_PP_CFG,
           "backend": "gloo (2 ranks share cuda:0; P2P and sums via host)",
           "batch": TRAIN_PP_BATCH, "microbatches": TRAIN_PP_M,
           "spawn_wall_s": wall, "init_s_by_rank":
               [r["init_s"] for r in ranks],
           "param_gb_per_rank": ranks[0]["param_gb"], "one_rank": one,
           "loss_tol": TRAIN_PP_LOSS_TOL, "grad_rtol": TRAIN_PP_GRAD_RTOL,
           "schedules": {}}
    bad, launches = [], {}
    for name in TRAIN_PP_SCHEDULES:
        per = [r[name] for r in ranks]
        timed = [p["calls"][-TRAIN_PP_TIMED:] for p in per]
        loss = per[0]["calls"][-1]["loss"]
        err = abs(loss - one["losses"][-1])
        s_rec = {
            "bubble_fraction": per[0]["bubble_fraction"], "T": per[0]["T"],
            "loss": loss, "abs_loss_err_vs_one_rank": err,
            "grad_rel_err_vs_one_rank": per[0]["grad_rel_err"],
            "step_ms_by_rank": [[c["step_ms"] for c in t] for t in timed],
            "call_ms_by_rank": [[c["call_ms"] for c in t] for t in timed],
            "walk_ms_by_rank": [[c["walk_ms"] for c in t] for t in timed],
            "gather_ms_by_rank": [[c["gather_ms"] for c in t]
                                  for t in timed],
            "p2p_by_rank": [t[-1]["p2p"] for t in timed],
            "head_sum_by_rank": [t[-1]["head_sum"] for t in timed],
            "dacts_sum_by_rank": [t[-1]["dacts_sum"] for t in timed],
            "peak_gb_by_rank": [max(c["peak_gb"] for c in t) for t in timed],
            "memory_estimate_gb": per[0]["memory_estimate_gb"],
            "estimate_plus_params_gb": per[0]["estimate_plus_params_gb"],
            "launches_by_rank": [t[-1]["launches"] for t in timed],
            "predicted_by_rank": [p["predicted"] for p in per]}
        rec["schedules"][name] = s_rec
        launches[name] = s_rec["launches_by_rank"]
        if err > TRAIN_PP_LOSS_TOL or not np.isfinite(loss) \
                or not max(per[0]["grad_rel_err"].values()) \
                <= TRAIN_PP_GRAD_RTOL \
                or not all(c["finite"] for p in per for c in p["calls"]) \
                or s_rec["launches_by_rank"] != s_rec["predicted_by_rank"]:
            bad.append(name)
    nvcc = sum(r["nvcc"] for r in ranks)
    rec["nvcc_in_ranks"] = nvcc
    emit(rec)
    if bad or nvcc or not np.isfinite(one["losses"]).all():
        raise AssertionError(f"train_pp failed for {bad} (nvcc {nvcc}): "
                             f"{rec}")
    return {"launches_by_rank": launches}


# -- context and sequence parallelism (A10 slice 5) ----------------------------

# sp_parity: f32, head dim 64, so the f32 kernels 2-4 run (not the plain route)
SP_TINY = dict(TP_TINY, num_attention_heads=16, num_key_value_heads=8)
SP_RING = dict(b=2, s=1024, h=8, kvh=4, d=64)   # the ring cases' q [b, s, h, d]
SP_RING_ATOL = 1e-4        # f32 kernels vs the plain dense attention, abs
SP_PARITY_STEPS = 2
SP_GRAD_RTOL = 1e-4        # a norm weight's first gradient, at its scale
# (arm, mesh spec, data axes): the context-parallel step's SPMD arm
SP_CP_ARMS = (("dp2sp2", "dp2sp2", ("dp",)),)
# train_cp: Llama-3-8B widths at 2 of 32 layers, one 8192-token sequence
TRAIN_CP_LAYERS = 2
TRAIN_CP_SEQ = 8192        # Llama-3-8B's max_position_embeddings
TRAIN_CP_STEPS = 2
# abs, bf16 losses, sp2 vs one rank: read 1.6e-4 on every sound run
TRAIN_CP_LOSS_TOL = 1e-3
# relative Frobenius norm, bf16 first gradients: read 0.0081 (head), 0.0108
# (wq), 0.0113 (embedding) on every sound run
TRAIN_CP_GRAD_RTOL = 0.02


def _spawn_beside(fn, args, nprocs, pool=None):
    """Start ``spawn(fn, args)`` in a thread (the ranks' start and their
    work overlap what this process does next); ``result()`` joins it and
    returns the ranks' values, or raises what the spawn raised. Spawns
    given the same one-thread ``pool`` run one after the other."""
    from paddlepaddle_tpu_torch.distributed import spawn

    own = pool is None
    pool = pool or concurrent.futures.ThreadPoolExecutor(1)
    fut = pool.submit(spawn, fn, args=args, nprocs=nprocs, **TP_SPAWN)
    if own:
        pool.shutdown(wait=False)
    return fut


def ring_predicted_launches(n: int, r: int, causal: bool, calls: int = 1,
                            layers: int = 1) -> dict:
    """Kernels 2-4 launched on rank ``r`` of an ``n``-rank ring by
    ``calls`` forward+backward passes over ``layers`` attention layers:
    under ``causal`` the blocks ``j <= r`` (``r + 1`` of them), else all
    ``n``; one forward, one dQ and one dK/dV launch a block."""
    k = calls * layers * ((r + 1) if causal else n)
    return {"flash_fwd": k, "flash_bwd_dq": k, "flash_bwd_dkv": k}


def _first_grads(opt, names):
    """Patch this rank's optimizer to keep the first gradients it is given
    for ``names`` (on the host): ``{}`` filled at the first ``apply``."""
    kept = {}
    orig = opt.apply

    def apply(grads=None, lr=None):
        if not kept:
            for n, g in zip(opt._names, grads):
                if n in names:
                    kept[n] = g.detach().float().cpu()
        return orig(grads, lr)

    opt.apply = apply
    return kept


def _grad_err(got, want) -> float:
    """The largest absolute difference over the reference's largest entry."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _sp_ring_case(mesh, causal, q, k, v, cot):
    """One ring case on this rank: its blocks through ``ring_attention``
    (the kernel path), forward and backward, against the plain dense
    attention on the whole tensors on the card; its launches."""
    import torch

    from paddlepaddle_tpu_torch.ops.kernels.flash_attention import \
        flash_attention_plain
    from paddlepaddle_tpu_torch.ops.kernels.ring_attention import (
        ring_attention, ring_of)

    ring = ring_of(mesh, "sp")
    n, r = ring.n, ring.r
    blocks = [t.chunk(n, 1)[r].contiguous().requires_grad_() for t in
              (q, k, v)]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ring_attention(*blocks, mesh, causal=causal)
    (out * cot.chunk(n, 1)[r]).sum().backward()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = _rank_counts()["flash"]
    whole = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    rep = q.shape[2] // k.shape[2]
    dense = flash_attention_plain(
        whole[0], whole[1].repeat_interleave(rep, 2),
        whole[2].repeat_interleave(rep, 2), causal,
        1.0 / float(q.shape[-1]) ** 0.5)[0]
    (dense * cot).sum().backward()
    errs = {"out": float((out.detach() - dense.detach().chunk(n, 1)[r])
                         .abs().max())}
    for name, b, w in zip(("dq", "dk", "dv"), blocks, whole):
        errs[name] = float((b.grad - w.grad.chunk(n, 1)[r]).abs().max())
    want = ring_predicted_launches(n, r, causal)
    return {"max_abs_err": max(errs.values()), "errs": errs, "ms": ms,
            "launches": launches, "predicted": want,
            "ok": max(errs.values()) <= SP_RING_ATOL and launches == want}


def _sp_models(pt_pkg):
    """sp_parity's f32 Llama (``SP_TINY``) with and without the
    context-parallel axis: the same weights (seed 1)."""
    import dataclasses

    cfg = pt_pkg.LlamaConfig(**SP_TINY)
    return (dataclasses.replace(cfg, context_parallel_axis="sp"), cfg,
            lambda c: pt_pkg.LlamaForCausalLM(c, seed=1))


def _sp_parity_rank(ids_np):
    """sp_parity's four SPMD ranks: the ring cases over ``sp4`` and over
    ``sp2`` (mesh ``dp2 sp2``: two rings), then the context-parallel step
    on ``dp2 sp2`` (rank 0 also runs the one-process reference)."""
    import torch

    import paddlepaddle_tpu_torch as pt
    from paddlepaddle_tpu_torch.distributed import ProcessMesh, train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    rank = _rank_init("gloo")
    dev = torch.device("cuda")
    out = {"rank": rank}
    g = torch.Generator(device=dev).manual_seed(5)
    c = SP_RING
    q = torch.randn((c["b"], c["s"], c["h"], c["d"]), generator=g,
                    device=dev)
    k = torch.randn((c["b"], c["s"], c["kvh"], c["d"]), generator=g,
                    device=dev)
    v = torch.randn((c["b"], c["s"], c["kvh"], c["d"]), generator=g,
                    device=dev)
    cot = torch.randn(q.shape, generator=g, device=dev)
    for mesh_name, mesh in (("sp4", ProcessMesh(shape=[4],
                                                dim_names=["sp"])),
                            ("dp2sp2", ProcessMesh(shape=[2, 2],
                                                   dim_names=["dp", "sp"]))):
        for causal in (True, False):
            out[f"ring {mesh_name} causal={causal}"] = _sp_ring_case(
                mesh, causal, q, k, v, cot)
    cp_cfg, cfg, make = _sp_models(pt)
    ids = torch.from_numpy(ids_np).cuda()
    ref = None
    if rank == 0:
        ref = _fsdp_reference(pt, cfg, make, ids)
        ref["layers"] = cfg.num_hidden_layers
    for arm, spec, data_axes in SP_CP_ARMS:
        model = make(cp_cfg)
        step = ShardedTrainStep(model, _fsdp_parity_opt(pt, model),
                                _llm_loss, plan=train_plan(
                                    spec, data_axes=data_axes),
                                seq_axis="sp")
        sp_r = step.plan.coords()["sp"]
        rec = _fsdp_arm(model, step, ids, ref, sharded=None)
        rec["predicted"] = ring_predicted_launches(
            2, sp_r, True, SP_PARITY_STEPS, cfg.num_hidden_layers)
        mine = rec.pop("launches_by_rank")[0]
        rec["launches"] = {k: mine[k] for k in _FSDP_KERNELS[:3]}
        out[f"cp {arm}"] = rec
        del step, model
        gc.collect()
    out["nvcc"] = _rank_counts()["nvcc"]
    return out


def _sp_single_arms(pt_pkg, ids):
    """sp_parity's single-process arms in this process (rank 0; the step
    starts rank 1): the context-parallel step on ``dp1 sp2``, and Megatron
    sequence parallelism on ``mp2`` through ``parallelize`` with
    ``SequenceParallelBegin`` / ``End`` (the norm weights' first gradients
    against one process's)."""
    import torch

    import paddlepaddle_tpu_torch.distributed as D
    from paddlepaddle_tpu_torch.distributed import ShardingPlan, train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    cp_cfg, cfg, make = _sp_models(pt_pkg)
    ref = _fsdp_reference(pt_pkg, cfg, make, ids)
    ref["layers"] = cfg.num_hidden_layers
    m1 = make(cfg)
    _llm_loss(m1, ids, ids).backward()
    norms = {n for n, _ in m1.named_parameters() if n.endswith("norm.weight")}
    ref_grads = {n: p.grad.detach().float().cpu()
                 for n, p in m1.named_parameters() if n in norms}
    del m1
    out = {}
    model = make(cp_cfg)
    step = ShardedTrainStep(model, _fsdp_parity_opt(pt_pkg, model),
                            _llm_loss, plan=train_plan("dp1sp2"),
                            seq_axis="sp")
    pids = step.workers.pids
    try:
        rec = _fsdp_arm(model, step, ids, ref, sharded=None)
    finally:
        step.close()
    rec["predicted_by_rank"] = [ring_predicted_launches(
        2, r, True, SP_PARITY_STEPS, cfg.num_hidden_layers) for r in (0, 1)]
    rec["workers_gone"] = _procs_gone(pids)
    out["cp dp1sp2"] = rec
    del step, model
    gc.collect()

    ap = D.auto_parallel
    plan = {"mp_config": {"parallelize_plan": {
        "embed_tokens": ap.SequenceParallelBegin(),
        r"model\.layers\.\d+\.self_attn\.(q|k|v)_proj": D.ColWiseParallel(),
        r"model\.layers\.\d+\.self_attn\.o_proj": D.RowWiseParallel(),
        r"model\.layers\.\d+\.mlp\.(gate|up)_proj": D.ColWiseParallel(),
        r"model\.layers\.\d+\.mlp\.down_proj": D.RowWiseParallel(),
        "lm_head": [D.ColWiseParallel(gather_output=True),
                    ap.SequenceParallelEnd()]}}}
    model = make(cfg)
    D.parallelize(model, config=plan)
    marked = sorted(n for n, p in model.named_parameters()
                    if getattr(p, "sequence_parallel", False))
    opt = _fsdp_parity_opt(pt_pkg, model)
    step = ShardedTrainStep(model, opt, _llm_loss,
                            plan=ShardingPlan("mp2", rules=[(r".*", ())],
                                              data_axes=()))
    kept = _first_grads(step.optimizer, norms)
    pids = step.workers.pids
    try:
        rec = _fsdp_arm(model, step, ids, ref, sharded="mp")
    finally:
        step.close()
    L = cfg.num_hidden_layers * SP_PARITY_STEPS
    rec.update(
        marked=marked, workers_gone=_procs_gone(pids),
        predicted_by_rank=[{"flash_fwd": L, "flash_bwd_dq": L,
                            "flash_bwd_dkv": L}] * 2,
        norm_grad_rel_err={n: _grad_err(kept[n], ref_grads[n])
                           for n in sorted(norms)})
    rec["ok"] = (rec["max_rel_loss_err"] <= FSDP_LOSS_RTOL
                 and rec["max_abs_param_err"] <= FSDP_PARAM_ATOL
                 and set(marked) == norms
                 and max(rec["norm_grad_rel_err"].values()) <= SP_GRAD_RTOL)
    out["sequence_parallel mp2"] = rec
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_sp_parity(pt_pkg):
    """10n: context and sequence parallelism on ranks that share
    ``cuda:0`` over gloo, f32, head dim 64 (the f32 kernels 2-4). Four
    SPMD ranks the script spawns: ring attention (``SP_RING``, 8 query /
    4 KV heads) over ``sp4`` and over ``sp2`` (``dp2 sp2``: two rings),
    causal and full, forward and gradients against the plain dense
    attention on the card (``SP_RING_ATOL``), kernels 2-4 against
    :func:`ring_predicted_launches` on every rank; the context-parallel
    Llama (``SP_TINY``) through ``ShardedTrainStep(seq_axis="sp")`` on
    ``dp2 sp2``. In this process (single-process form): the same on
    ``dp1 sp2``, and ``SequenceParallelBegin`` / ``End`` on ``mp2``. Each
    step arm: two momentum steps against a one-process ``TrainStep`` on the
    same weights and batch (losses, synced parameters: fsdp_parity's
    gates), launches against the prediction; the ``mp2`` arm also holds
    every norm weight's first gradient (summed over ``mp``) against the
    one process's (``SP_GRAD_RTOL``)."""
    import numpy as np
    import torch

    ids_np = np.random.default_rng(0).integers(0, 1024, FSDP_PARITY_BATCH)
    t0 = time.perf_counter()
    # the four SPMD ranks start and run while this process runs the
    # single-process arms (the phase's time is the longer of the two)
    job = _spawn_beside(_sp_parity_rank, (ids_np,), 4)
    single = _sp_single_arms(pt_pkg, torch.from_numpy(ids_np).cuda())
    single_s = time.perf_counter() - t0
    ranks = job.result()
    out, bad = {"spmd_wall_s": time.perf_counter() - t0,
                "single_wall_s": single_s}, []
    for key in ranks[0]:
        if key in ("rank", "nvcc"):
            continue
        recs = [r[key] for r in ranks]
        if key.startswith("ring"):
            out[key] = {
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms_by_rank": [r["ms"] for r in recs],
                "launches_by_rank": [r["launches"] for r in recs],
                "predicted_by_rank": [r["predicted"] for r in recs]}
            ok = all(r["ok"] for r in recs)
        else:
            rec = dict(recs[0])
            rec["launches_by_rank"] = [r["launches"] for r in recs]
            rec["predicted_by_rank"] = [r["predicted"] for r in recs]
            rec.pop("launches")
            rec.pop("predicted")
            out[key] = rec
            ok = rec["ok"] and rec["launches_by_rank"] == \
                rec["predicted_by_rank"]
        if not ok:
            bad.append(key)
    for key, rec in single.items():
        launches = [{k: r[k] for k in _FSDP_KERNELS[:3]}
                    for r in rec["launches_by_rank"]]
        rec["launches_by_rank"] = launches
        out[key] = rec
        if not rec["ok"] or launches != rec["predicted_by_rank"] \
                or not rec["workers_gone"]:
            bad.append(key)
    nvcc = sum(r["nvcc"] for r in ranks)
    emit({"phase": "sp_parity", "nvidia_smi": nvidia_smi_line(),
          "ring": dict(SP_RING, dtype="float32"), "ring_atol": SP_RING_ATOL,
          "llama": "f32, hidden 1024, 16 heads / 8 KV (head dim 64), 2 "
                   "layers", "batch": FSDP_PARITY_BATCH,
          "loss_rtol": FSDP_LOSS_RTOL, "param_atol": FSDP_PARAM_ATOL,
          "norm_grad_rtol": SP_GRAD_RTOL, "nvcc_in_ranks": nvcc, **out})
    if bad or nvcc:
        raise AssertionError(f"sp_parity failed for {bad} (nvcc in the "
                             f"ranks: {nvcc}): {out}")
    return {f"sp_parity {k}": v["launches_by_rank"] for k, v in out.items()
            if isinstance(v, dict)}


def phase_train_cp(pt_pkg):
    """10o: context parallelism at full width. Llama-3-8B widths (hidden
    4096, 32 q / 8 KV heads, MLP 14336, vocab 128256) at
    ``TRAIN_CP_LAYERS`` layers, bf16, one ``TRAIN_CP_SEQ``-token sequence,
    multi-precision AdamW + global-norm clip, ``TRAIN_CP_STEPS`` steps:
    first a one-rank ``TrainStep`` (then freed), then
    ``ShardedTrainStep(seq_axis="sp")`` over ``dp1 sp2`` (this process is
    rank 0 and starts rank 1; both share ``cuda:0`` over gloo, the ring's
    K/V crossing the host). Losses against the one rank
    (``TRAIN_CP_LOSS_TOL``), the first gradients of the LM head, layer 0's
    ``wq`` and the embedding (relative norm, ``TRAIN_CP_GRAD_RTOL``), step
    ms, each rank's peak GB beside the one rank's, kernels 2-4 a rank
    against :func:`ring_predicted_launches`, and rank 0's ring bytes a
    step and, from the last step (run under collective timing), seconds."""
    import dataclasses

    import numpy as np
    import torch

    from paddlepaddle_tpu_torch.distributed import collective, train_plan
    from paddlepaddle_tpu_torch.parallel import ShardedTrainStep

    cfg = dataclasses.replace(pt_pkg.LlamaConfig.llama3_8b(),
                              num_hidden_layers=TRAIN_CP_LAYERS)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, TRAIN_CP_SEQ))).cuda()
    names = {"lm_head.weight", "model.embed_tokens.weight",
             "model.layers.0.self_attn.q_proj.weight"}

    def opt(model):
        return _fsdp_opt(pt_pkg, model, lr=1e-4, multi_precision=True)

    torch.cuda.reset_peak_memory_stats()
    model = pt_pkg.LlamaForCausalLM(cfg, seed=0)
    one = pt_pkg.TrainStep(model, opt(model), _llm_loss)
    want = _first_grads(one.optimizer, names)
    one_losses, one_ms = [], []
    for _ in range(TRAIN_CP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one_losses.append(float(one(ids, ids)))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t1) * 1e3)
    one_peak = torch.cuda.max_memory_allocated() / 1e9
    del model, one
    gc.collect()
    torch.cuda.empty_cache()

    model = pt_pkg.LlamaForCausalLM(
        dataclasses.replace(cfg, context_parallel_axis="sp"), seed=0)
    t0 = time.perf_counter()
    step = ShardedTrainStep(model, opt(model), _llm_loss,
                            plan=train_plan("dp1sp2"), seq_axis="sp")
    ctor_s = time.perf_counter() - t0
    got = _first_grads(step.optimizer, names)
    pids = step.workers.pids
    try:
        step._rank_stats(reset=True)
        losses, ms = [], []
        for i in range(TRAIN_CP_STEPS):
            # the last step with rank 0's collectives timed (a device sync
            # around each): the ring's point-to-point seconds on rank 0
            with collective.timing(i == TRAIN_CP_STEPS - 1):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses.append(float(step(ids, ids)))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
        ranks = step._rank_stats(reset=True)
    finally:
        step.close()
    gone = _procs_gone(pids)
    del step, model
    gc.collect()
    torch.cuda.empty_cache()
    L = TRAIN_CP_LAYERS
    predicted = [ring_predicted_launches(2, r, True, TRAIN_CP_STEPS, L)
                 for r in (0, 1)]
    launches = [{k: r["launches"][k] for k in _FSDP_KERNELS[:3]}
                for r in ranks]
    err = max(abs(a - b) for a, b in zip(losses, one_losses))
    grad_err = {n: float((got[n] - want[n]).norm() / want[n].norm())
                for n in sorted(names)}
    coll = ranks[0]["collectives"]
    # calls and bytes over the steps; seconds of the last (timed) step
    p2p = {k: coll.get(k, {}) for k in ("p2p_send", "p2p_recv",
                                        "all_reduce", "all_gather")}
    rec = {"phase": "train_cp", "nvidia_smi": nvidia_smi_line(),
           "model": f"llama3_8b widths, {L} layers, bf16, dp1 sp2 (ring "
                    "attention)", "tokens": [1, TRAIN_CP_SEQ],
           "backend": "gloo (2 ranks share cuda:0; ring P2P and gradient "
                      "sums via host)",
           "one_rank": {"losses": one_losses, "step_ms": one_ms,
                        "peak_gb": one_peak},
           "losses": losses, "step_ms": ms, "construction_s": ctor_s,
           "max_abs_loss_err": err, "loss_tol": TRAIN_CP_LOSS_TOL,
           "grad_rel_err": grad_err, "grad_rtol": TRAIN_CP_GRAD_RTOL,
           "peak_gb_by_rank": [r["peak_gb"] for r in ranks],
           "launches_by_rank": launches, "predicted_by_rank": predicted,
           "rank0_collectives": p2p,
           "ring_bytes_per_step_rank0": {
               k: coll.get(k, {}).get("bytes", 0) // TRAIN_CP_STEPS
               for k in ("p2p_send", "p2p_recv")},
           "nvcc_in_worker": ranks[1]["nvcc"], "workers_gone": gone}
    emit(rec)
    if err > TRAIN_CP_LOSS_TOL or not np.isfinite(losses).all() \
            or max(grad_err.values()) > TRAIN_CP_GRAD_RTOL \
            or launches != predicted or not gone or ranks[1]["nvcc"]:
        raise AssertionError(f"train_cp failed: {rec}")
    return {"launches_by_rank": launches}


def _time_phases() -> dict:
    """Wrap every ``phase_*`` function of this module so that its seconds
    add up, by phase name, in the dict returned (printed before the
    ``total`` line: where the script's time goes)."""
    import functools

    seconds: dict = {}
    g = globals()
    for name, fn in list(g.items()):
        if name.startswith("phase_") and callable(fn):
            def timed(*args, _fn=fn, _name=name[len("phase_"):], **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    seconds[_name] = seconds.get(_name, 0.0) \
                        + time.perf_counter() - t0

            g[name] = functools.wraps(fn)(timed)
    return seconds


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script checks the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    phase_seconds = _time_phases()
    import paddlepaddle_tpu_torch as pt_pkg
    from paddlepaddle_tpu_torch.ops.kernels import _build

    try:
        smi = nvidia_smi_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "python": sys.version.split()[0],
              "device": torch.cuda.get_device_name(0),
              "capability": list(torch.cuda.get_device_capability(0)),
              "tf32": False})

        # Every nvcc starts now. paged_attention.cu takes most of the build
        # (~45 s, the others < 10 s), so the kernel phases that need no paged
        # library run while it builds.
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            paged = pool.submit(_build.build_all, [PAGED_LIBRARY])
            built = _build.build_all([n for n in _build.sources()
                                      if n != PAGED_LIBRARY])
            flash_records = phase_flash_kernel()
            fp16_records = phase_flash_fp16()
            d64_records = phase_flash_d64()
            varlen_records = phase_flash_varlen_kernel()
            gc.collect()                # free the full-width varlen buffers
            torch.cuda.empty_cache()
            gg_record = phase_gather_gemm_kernel()
            built.update(paged.result())
        emit({"phase": "build",
              "seconds": max(b["seconds"] for b in built.values()),
              "sources": {n: {"seconds": b["seconds"], "cached": b["cached"],
                              "ptxas": [ln.strip() for ln in
                                        str(b["ptxas"]).splitlines()
                                        if "Used" in ln or "spill" in ln][:48]}
                          for n, b in built.items()}})

        record = phase_kernel()
        int8_record = phase_kernel_int8()
        phase_engine_parity(pt_pkg)
        phase_engine_parity_int8(pt_pkg)
        phase_train_parity(pt_pkg)
        phase_moe_parity(pt_pkg)
        # pp_parity's eight f32 ranks start and run beside the untimed
        # parity phases that follow on the card; they are joined before
        # the first timed phase (serve), and read at pp_parity's place
        pp_job = _spawn_beside(_pp_parity_rank, (), 8)
        phase_zoo_parity(pt_pkg)
        gc.collect()                    # free the 2-layer f32 models
        torch.cuda.empty_cache()
        phase_capture_parity(pt_pkg)
        gc.collect()                    # free the 2-layer model
        torch.cuda.empty_cache()
        phase_quant_parity(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        pp_job.result()
        record["launches"], serve_ctx = phase_serve(pt_pkg)
        wo_launches, wo_case = phase_serve_wo_int8(pt_pkg, serve_ctx)
        record["launches_by_phase"] = {"serve": record["launches"],
                                       "serve_wo_int8": wo_launches}
        spec_launches = phase_serve_spec(pt_pkg, serve_ctx)
        record["w4"]["launches"] = spec_launches["launches"]
        record["w4"]["launches_by_run"] = spec_launches["by_run"]
        int8_record["w4"]["launches"] = spec_launches["int8_launches"]
        small = small_f32_model(pt_pkg)
        generate_launches = phase_serve_static(pt_pkg, serve_ctx, small)
        phase_serve_contiguous(pt_pkg, serve_ctx, small)
        phase_coldstart(pt_pkg, serve_ctx)
        phase_serve_observed(pt_pkg, serve_ctx)
        del small
        gc.collect()                    # free the small serving model
        torch.cuda.empty_cache()
        phase_serve_robust(pt_pkg)
        record["launches_by_phase"]["fleet_parity"] = \
            phase_fleet_parity(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        record["launches_by_phase"]["serve_fleet"] = \
            phase_serve_fleet(pt_pkg, serve_ctx)
        del serve_ctx
        gc.collect()                    # free the serving model
        torch.cuda.empty_cache()
        phase_bundle_restart(pt_pkg, built["paged_attention"]["seconds"])
        gc.collect()
        torch.cuda.empty_cache()
        int8_record["launches"] = phase_serve_int8(pt_pkg)
        gc.collect()                    # free the int8 serving model
        torch.cuda.empty_cache()
        launches = phase_train(pt_pkg)
        gc.collect()                    # free the Llama training model
        torch.cuda.empty_cache()
        remat_launches, _ = phase_train_recompute(pt_pkg)
        fp16_launches = phase_train_amp(pt_pkg)
        for r in flash_records:
            r["launches"] = launches[r["name"]]
            r["launches_by_phase"] = {"train": launches[r["name"]],
                                      "train_recompute":
                                          remat_launches[r["name"]]}
        flash_records[0]["launches_by_phase"]["generate"] = generate_launches
        for r in fp16_records:
            r["launches"] = fp16_launches[r["name"][:-len("_fp16")]]
            r["launches_by_phase"] = {"train_amp fp16": r["launches"]}
        gg_record["launches"] = phase_moe_train(pt_pkg)
        gc.collect()                    # free the MoE training model
        torch.cuda.empty_cache()
        phase_resnet50_train(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        bert_launches = phase_bert_base(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        gpt_launches, gpt_gen_launches = phase_gpt2_small(pt_pkg)
        for r in d64_records:
            base = r["name"].split("_d64")[0]
            if r["name"].endswith("_bert"):
                r["launches"] = bert_launches
                r["launches_by_phase"] = {"bert_base eval": bert_launches}
            else:
                r["launches"] = gpt_launches[base]
                r["launches_by_phase"] = {"gpt2_small train":
                                          gpt_launches[base],
                                          "gpt2_small generate":
                                          gpt_gen_launches[base]}
        gc.collect()
        torch.cuda.empty_cache()
        # untimed: the parity phases here, and beside them, in processes
        # of their own, two lanes of work one after the other: train_tp's
        # SPMD arms, nccl_world1's rank, train_parity_more; ep_parity,
        # router_tp. Joined before serve_tp
        lanes = [concurrent.futures.ThreadPoolExecutor(1) for _ in range(2)]
        lane_t0 = time.perf_counter()
        jobs = {"train_tp spmd": _spawn_beside(
                    _train_tp_rank, (TRAIN_TP_SPECS,), 2, lanes[0]),
                "nccl_world1": _spawn_beside(_nccl_world1_rank, (), 1,
                                             lanes[0])}
        for lane, name in ((0, "train_parity_more"), (1, "ep_parity"),
                           (1, "router_tp")):
            jobs[name] = _spawn_beside(_phase_alone, (name,), 1, lanes[lane])
        for lane in lanes:
            lane.shutdown(wait=False)
        for name, job in jobs.items():
            job.add_done_callback(
                lambda _, name=name: phase_seconds.__setitem__(
                    f"beside: {name} done at", time.perf_counter() - lane_t0))
        tp = phase_tp_parity(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_launches = phase_fsdp_parity(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        sp_launches = phase_sp_parity(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        spec_tp = phase_spec_tp(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        beside = {}
        for name in ("train_parity_more", "ep_parity", "router_tp"):
            ((beside[name], phase_seconds[f"{name} (beside)"]),) = \
                jobs[name].result()
        ep_launches = beside["ep_parity"]
        tp.update(beside["router_tp"])
        phase_seconds["parity phases with the lanes"] = \
            time.perf_counter() - lane_t0
        tp.update(phase_serve_tp(pt_pkg))
        gc.collect()
        torch.cuda.empty_cache()
        tp.update(phase_train_tp(pt_pkg, jobs["train_tp spmd"]))
        tp.update(phase_nccl_world1(pt_pkg, jobs["nccl_world1"]))
        gc.collect()
        torch.cuda.empty_cache()
        train_ep = phase_train_ep(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        train_fsdp = phase_train_fsdp(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        pp_launches = phase_pp_parity(pt_pkg, pp_job)
        gc.collect()
        torch.cuda.empty_cache()
        train_pp = phase_train_pp(pt_pkg)
        gc.collect()
        torch.cuda.empty_cache()
        train_cp = phase_train_cp(pt_pkg)
        gg_record["launches_by_phase"] = {
            "moe_train": gg_record["launches"], **ep_launches,
            "train_ep by rank": [r["gather_gemm_ffn"]
                                 for r in train_ep["launches_by_rank"]],
            **{f"{k} by rank": [r["gather_gemm_ffn"] for r in v]
               for k, v in fsdp_launches.items() if k.startswith(
                   "fsdp_parity moe")}}
        local = train_ep["kernel8_local"]
        gg_record["local_experts"] = {
            "shape": local["shape"], "ms": local["ms"]["call"],
            "plain_ms": local["ms"]["plain"],
            "bound_ms": local["bounds"]["call"]["bound_ms"],
            "bound_by": local["bounds"]["call"]["bound_by"],
            "max_abs_err": local["checks"]["call"]["max_abs_err"]}
        record["launches_by_phase"].update(
            {k: v for k, v in tp.items() if k.startswith(("tp_parity",
                                                          "serve_tp",
                                                          "router_tp",
                                                          "nccl_world1"))
             and "paged" in k})
        record["w4"]["launches_by_phase"] = spec_tp
        for r in flash_records:
            r["launches_by_phase"].update(
                {k: (v[r["name"]] if isinstance(v, dict)
                     else [x[r["name"]] for x in v])
                 for k, v in tp.items() if k.startswith("train_tp")})
            r["launches_by_phase"]["train_ep by rank"] = [
                x[r["name"]] for x in train_ep["launches_by_rank"]]
            r["launches_by_phase"].update(
                {f"{k} by rank": [x[r["name"]] for x in v]
                 for k, v in fsdp_launches.items()})
            r["launches_by_phase"]["train_fsdp by rank"] = [
                x[r["name"]] for x in train_fsdp["launches_by_rank"]]
            r["launches_by_phase"].update(
                {f"{k} by rank (f32)": [x[r["name"]] for x in v]
                 for k, v in pp_launches.items()})
            r["launches_by_phase"].update(
                {f"train_pp {k} by rank": [x[r["name"]] for x in v]
                 for k, v in train_pp["launches_by_rank"].items()})
            r["launches_by_phase"].update(
                {f"{k} by rank (f32)": [x[r["name"]] for x in v]
                 for k, v in sp_launches.items()})
            r["launches_by_phase"]["train_cp by rank"] = [
                x[r["name"]] for x in train_cp["launches_by_rank"]]
    except BaseException:
        # where the time went up to the failure
        emit({"phase": "phase_seconds", "seconds": phase_seconds,
              "failed": True})
        raise
    emit({"phase": "phase_seconds", "seconds": phase_seconds})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [record, int8_record] + flash_records + fp16_records
          + d64_records + varlen_records + [gg_record]})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
