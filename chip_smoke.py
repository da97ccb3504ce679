"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout, on a host with one CUDA card and the CUDA
toolkit (``nvcc``).  TF32 is off for matmuls and cuDNN throughout, so every
f32 product on the card is a full f32 product.  Phases, each fatal on
failure:

1. build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print the build time, ``nvcc``'s register,
   shared-memory and spill report (K4's three kernels, K5 and K3's
   backward among them,
   every instance of K1 and K2), the tile, ring, occupancy and i chunk of
   the K1 and K2 instances the wrappers launch and the host cost of one
   tensor-map encode, K4's time chunk and K5's stage, and the card's name
   and power limit;
2. hold each kernel against its plain PyTorch version on the card:
   K1 and K2 at the shapes of the JAX package's kernel tests, at c = 0.25,
   and at the paper's 2400x600x600 f32 lattice (limits: 1e-6 for one
   sweep, 1e-5 for two, and 0 unequal elements); then bit for bit (0
   unequal elements) at j and k extents one below, at and one above a tile
   (and 4 either side in k) over one and two tiles, on lattices smaller
   than a tile and with nk not a multiple of 4 (the 4-byte-copy instance),
   at i extents either side of each kernel's i chunk, and at the runtime
   sweep's first and last slab of the paper lattice; K3 (flash attention) against ``mha_ref`` at the
   shapes of ``tests/test_kernels.py`` (MQA, bidirectional, windowed,
   Tk > Tq offset) in f32 and its bf16 case, and at qwen2-0.5b's shapes in
   bf16, as the strided views the model passes: prefill 14 over 2 heads
   at T = 128 and 1024 and at each of the serving drain's 12 prompt
   lengths (ragged in the 64-key tile and the 9-position query block), and
   decode of one query against a 2048-slot cache at q_offset 0, 517, 2047
   and each prompt length.  Limits, per element against ``mha_ref``'s
   value ``r``: 3e-5 in f32, 3e-5 + 2^-7 |r| in bf16.  K4 (the WKV6
   recurrence) against ``wkv6_ref``, output and final state, at the shapes
   of ``tests/test_kernels.py`` in f32 (with the state carried across two
   calls) and at rwkv6-3b's 40 heads of 64 with bf16 r, k, v: prefill
   128 and 1024 and each of the rwkv6-3b drain's 12 prompt lengths, at
   C - 1, C and C + 1 (C its time chunk) and at 2 C + 5 and 3 C + 5, from
   zero and from a carried state, and decode (T = 1) from a carried
   state.  Limit, per element: 1e-5 of the shape's largest |ref| (both sum
   the same f32 products in other orders).
   K5 (the RG-LRU scan) against ``rglru_scan_ref`` bit for bit (limit: 0
   unequal elements; each step is one rounded multiply and one rounded
   add in both), at the shapes of ``tests/test_kernels.py``, at
   recurrentgemma-9b's width 4096 at prefill 128 and 1024 and at each of
   its drain's 12 prompt lengths, at decode (T = 1) from a carried state,
   and at widths 4096 and 4097 on either side of its shared-memory stage
   and past its ring's wrap.  K3 at recurrentgemma-9b's shapes in bf16, 16 query heads over
   one kv head of 256, as the model's strided views: prefill with window
   2048 at 128, 1024 and the drain's lengths, decode over a 2048-slot ring
   at positions 0, 517 and 2047, and over a wrapped ring at 2100 and 4095
   (``window=0``, ``q_offset=pos``) against ``decode_attention(ring=True)``
   on the same values in f32, rounded once to bf16; K3's bf16 design at
   both head shapes: decode on either side of a split boundary and with a
   window, prefill one past the row and key tiles, a split prefill in
   which some rows see none of a chunk's keys; the bf16 limit above.  Then
   the same K3 call, repeated, must give the same bits (decode 2047 and
   prefill 1024, both split).  Last, K3 at the new architectures' shapes
   (``K3_NEW_SHAPES``), in bf16 as the model's views and in f32, under the
   same limits: qwen3-moe-30b-a3b's 32 q / 4 kv heads of 128 at prefill
   128 and 1024 and decode 517 and 2047, whisper-base's 8/8 heads of 64
   without a causal mask at 1536 x 1536 (its encoder) and at Tq 128 and 1
   over 1536 frames (its cross-attention), llama-3.2-vision-90b's 64/8
   heads of 128 at Tq 128 and 1 over 1600 image tokens;
3. the Jacobi main path, ``run_runtime_sweep`` on the full lattice
   (di = 10, 4 domains x 2 workers = 240 slab tasks), against the plain
   sweep, with the launch counts zeroed before and read after;
3b. the same sweep built from ``spec.named("paper_cyclic")`` (4 domains)
   and recorded by the port's ``TraceRecorder``: 240 K1 launches and a
   lattice equal to the kwargs path's bit for bit; the trace is written as
   JSONL, read back, replayed from its header alone (the recorded stats
   and event stream) and passed by the port's ``check_trace``;
3c. the SPMD sweeps, ``make_contiguous_sweep`` and ``make_scattered_sweep``
   (4 slabs), as the one rank of an NCCL group on ``tcp://localhost``:
   each equal to the whole-lattice K1 sweep with 0 unequal elements, at 1
   and 4 K1 launches, with the bytes the rank hands to
   ``torch.distributed`` counted; each sweep timed beside the whole-lattice
   K1, its byte bound and the padded copy; the group is destroyed after;
   then ``jacobi_iterate`` (K2 for pairs of sweeps, K1 for the odd one)
   as in phase 3;
4. the serving path on full-width qwen2-0.5b in bf16: ``ServingEngine``
   (random weights from ``torch.Generator`` seed 0), 12 requests of
   128-1024 prompt tokens and 32 new tokens each (numpy seed 0, about 2/3
   with a home replica), 3 replicas, ``max_seq`` 2048: a ``locality``
   drain at full depth, then the ``locality``, ``round_robin`` and
   ``single_queue`` policies at ``POLICY_DEPTH`` (4) of its 24 layers (a
   cut, printed).  Each drain
   runs with the launch counts zeroed just before it and read just after:
   K3 must launch 12 x 24 layers x (1 prefill + 32 decode steps) = 9504
   times at full depth (12 x 4 x 33 at 4 layers) and no other kernel, the
   tokens must be identical across
   policies, and each policy's ``ServeStats``, wall time, tokens per
   second, prefill ms per request and decode ms per token are printed; the
   ``locality`` drain's decode calls 16-31 (``PROFILE_WINDOW``) run under
   ``torch.profiler`` (behind 64 one-element fills, since a session can
   lose its first 32 device records), which gives the card's idle share
   over the window, its top device functions and K3's device time a
   decode call, its calls in the window exact (a window whose trace lost
   K3 records is retaken on the next request's same decode steps, up to
   ``PROFILE_ATTEMPTS`` windows, each loss printed).  No separate profiled drain
   runs and no prefill is traced (a cut, printed: every profile of phases
   4-5f is a window of the timed drain itself).
   Two more drains (4b): with ``control=ControlLoop.full(batch_cap=4)``,
   and built from ``spec.named("controlled_serving")`` with 3 domains, 3
   replicas and ``max_seq`` 2048; each at ``POLICY_DEPTH`` (4) of the 24
   layers (a cut, printed) must launch K3 12 x 4 x 33
   times and give the tokens of the ``locality`` drain at that depth.  Then the kernel path against the plain path: one
   request, teacher-forced with the tokens the plain path
   (``use_kernel=False``) chose, through both; the prefill's and every
   decode step's logits must agree within the bf16 limit printed beside
   them;
5. the same drains on full-width rwkv6-3b in bf16 (32 layers, d 2560, 40
   heads of 64, 3.09 B parameters), with token ids under its 65536 vocab:
   K4 must launch 12 x 32 x 33 = 12672 times per drain and the plain WKV
   version never (the ``locality`` drain, profiled, at full depth,
   the three policies' drains with identical tokens at 4 layers: a cut,
   printed, as in 5b and 5c); K4 is also held against ``wkv6_ref`` on a decode step
   from the state a real prefill left in the cache (first and last layer).
   Its teacher-forced comparison runs on an f32 build of the same model
   (12.4 GB), whose logits carry no bf16 rounding of the residual stream;
   two planted faults in the plain path (u dropped, the state not carried
   across decode steps) must each exceed the limit;
5b. the same drains on full-width recurrentgemma-9b in bf16 (38 layers:
   26 rglru and 12 local attention with a 2048-token window, d 4096, 16
   q / 1 kv heads of 256, 8.58 B parameters): K5 must launch
   12 x 26 x 33 = 10296 times and K3 12 x 12 x 33 = 4752 times per drain,
   and the plain RG-LRU scan never; K5 is also held against
   ``rglru_scan_ref`` on a decode step from the state a real prefill left
   in the cache (first and last rglru layer).  Its teacher-forced
   comparison runs on an f32 build (34.3 GB, after every earlier model is
   freed; the peak device memory is printed), with two planted faults in
   the plain path (the RG-LRU state not carried across decode steps; the
   conv history not carried) that must each exceed the limit;
5c. the ``locality`` drain on full-width qwen3-moe-30b-a3b in bf16 (48
   layers, d 2048, 32 q / 4 kv heads of 128, 128 experts top-8 of width
   768, 30.53 B parameters, 61.09 GB), timed (not profiled: a cut,
   printed), once every
   earlier model is freed: K3 must launch 12 x 48 x 33 = 19008 times per
   drain and the plain attention never; the three policies' drains, with
   identical tokens, at 4 of its 48 layers (a cut, printed, that makes
   room for phases 5f and 7); the peak device memory is printed, and the MoE
   block's device time is split into router and top-k, dispatch, expert
   products and combine (one layer's experts, at a decode step and at
   each prompt length, times the drain's calls).  Its teacher-forced
   comparison runs on an f32 build of its first 8 layers (122 GB whole in
   f32), with two planted faults in the MoE block of the plain path (the
   top-k weights not renormalised; the decode's gather reading the next
   expert's weights) that must each exceed the limit, and prints how many
   (token, layer) routing choices differ between the two paths;
5d. the other four new configurations at full width: minicpm3-4b (MLA,
   which runs its plain path on every device) and whisper-base whole,
   phi3.5-moe-42b-a6.6b at 8 of 32 layers and llama-3.2-vision-90b at 5 of
   100 (neither fits on one card whole); each a prefill of 128 tokens
   (whisper with 1536 frames, the VLM with 1600 image tokens and its
   cross-attention gates set to 0.5 and -0.7, from seed 0), then 8
   teacher-forced decode steps, whose logits must equal the full
   forward's (phi3.5-moe at a capacity factor of E / k, where nothing
   drops) and the plain path's at the published capacity factor (with the
   plain path's expert choices forced, for phi3.5-moe) within a bf16
   limit, with K3 launched once per attention call and the plain path
   none; each model then serves 5f's drain before it is freed;
5f. the six configurations no earlier phase drains, through
   ``ServingEngine`` on phase 4's traffic (one ``locality`` drain each,
   on the model 5d built where 5d runs it): gemma3-1b (26 layers, 4/1
   heads of 256, 512-slot rings that wrap in prompts past 512 tokens),
   qwen2-1.5b (28 layers, 12/2 heads of 128), minicpm3-4b (62 layers, MLA)
   and whisper-base (its decoder, on the engine's zeroed cross caches;
   prompts of 64-416 tokens and ``max_seq`` 448, its decoder's positions)
   whole, phi3.5-moe-42b-a6.6b at 8 and llama-3.2-vision-90b at 5 layers
   (cuts, printed; the VLM with 5d's gates): every request served with 32
   tokens, K3 launched exactly 12 x ``attention_calls`` x 33 times (10296,
   11088, 0 for MLA, 4752, 3168, 2376) and the plain attention never;
   wall time, tokens per second, prefill and decode ms, peak device memory
   beside the card's name and power limit, and for the four whole ones
   the idle share and top device functions of a profile window of the
   same drain under ``torch.profiler`` (decode calls 16-31,
   ``PROFILE_WINDOW``, with K3's calls in it exact, retaken as in 4 when
   the trace lost records: a whole drain's
   profile costs 30-57 us of host a device record).  gemma3-1b
   and qwen2-1.5b are also teacher-forced,
   kernel path against plain path, on one request of 1000 prompt tokens
   (gemma3-1b's rings wrap in prefill and decode) and 32 decode steps,
   within the bf16 limit, with two planted faults each in the plain path
   that must exceed it (gemma3-1b: the local layers' window dropped at
   prefill, the ring decode reading its slots as positions in the window;
   qwen2-1.5b: query head h reading kv head h % Hkv, rope left off k).
   Then each of the six at ``POLICY_DEPTH`` (4) layers (a cut, printed)
   under the three policies, with identical tokens, while 5g's subprocess
   and 7i's two commands run in the background;
5g. the serving driver on the card: ``python -m repro_torch.launch.serve
   --arch qwen2-0.5b`` as a subprocess on its default device, and
   ``launch.serve.main(["--arch", A])`` in this process for the other
   nine architectures (the reduced f32 configs), each against the same
   call with ``--device cpu`` (run in a process of its own while 5d-5f
   serve): equal stats lines, and equal printed tokens unless the CPU
   step's top two logits lie within 1e-4 (a tie, printed);
5e. the plain long prefill on CUDA tensors: ``chunked_attention`` at 4096
   tokens with qwen2-0.5b's heads and ``banded_attention`` at 4096 with
   gemma3-1b's heads and window 512, each on f32 copies of bf16 values and
   rounded once, against K3 per element within the bf16 limit;
6. time each kernel, its plain version and the library's yardstick with
   CUDA events, beside its bound: K1 and K2 at the full lattice (yardstick
   ``conv3d`` with the six-point cross), one K1 slab launch of the runtime
   sweep (10 rows, each call the next of 99 slabs so that none finds its
   rows in L2; device time of 50 launches queued behind a device sleep,
   and back to back as PR 16 timed it), and the
   runtime sweep's wall time beside its device time and idle share under
   ``torch.profiler``, each beside PR 16's number, and the same for the
   spec-built sweep of phase 3b; K3 at the
   serving path's prefill and decode shapes (yardstick
   ``scaled_dot_product_attention``, which the port never calls); K4 at
   rwkv6-3b's prefill 1024 and 128 and decode (no PyTorch call computes
   the WKV recurrence, so it has no yardstick); K5 at recurrentgemma-9b's
   prefill 1024 and 128 and decode (no yardstick either), K4 and K5 beside
   their previous designs' times; K3 at
   recurrentgemma-9b's hd-256 prefill and decode shapes beside SDPA, and
   at the new architectures' shapes beside SDPA (without a mask where K3
   runs without one);
7. training (``train_phase``).  7a: K3's backward kernel
   (``flash_attention_backward``: in bf16 on tensor cores, reading the
   log-sum-exp and f32 output K3's forward writes under grad; in f32 the
   SIMT kernels) against autograd of ``mha_ref`` on f32 copies, per
   element (f32: 1e-4 of the largest |ref|; bf16: 2^-7 |ref| + 2^-8 max
   |ref|) at qwen2-0.5b's training shape (batch 8 x 1024), qwen3-moe's
   32/4 heads of 128, gemma3-1b's window (hd 256), whisper's encoder
   without a mask, a cross shape and recurrentgemma-9b's local layers
   (16/1 heads of 256, window 2048, T 3072), in bf16 and f32; two planted
   faults (dK from one head of the group, the mask dropped in dQ) must
   exceed the limit and a repeated call must give the same bits; times
   beside the previous (SIMT) design, the plain autograd, SDPA's backward and
   the bound.  7b: one full-width qwen2-0.5b bf16 train step, kernel path
   against the plain path from the same params and batch (loss and every
   leaf's gradient); 7c: the same on an f32 build of 4 of its 24 layers,
   with two planted faults in K3's backward.  7d:
   ``launch.train.make_trainer`` on full-width qwen2-0.5b, 20 steps of 8 x
   1024 from the synthetic corpus (seed 0): ms a step, tokens per second,
   the share of the 6 N tokens bound, K3's forward and backward launches a
   step (counts zeroed before the run), peak memory, one profiled step's
   idle share; the loss must fall (``train_run``: finite, the mean of the
   last five below the first, and the loss on a held-out batch, the
   corpus's next one, lower by ``TRAIN_HELD_OUT_FALL`` after the last step
   than from the initial params, which a trainer whose updates do nothing
   fails).  7e,
   as a user runs the trainer (no
   ``CUBLAS_WORKSPACE_CONFIG``, no ``torch.use_deterministic_algorithms``;
   ROADMAP F2): 12 steps with a checkpoint every 6, and a second trainer
   resumed from step 6 must give the same losses, params and optimizer
   state bit for bit (unequal elements counted); the checkpoint's bytes
   and save and restore times.  7f (``recurrent_backward_phase``): K5's backward
   against ``rglru_scan_bwd_ref`` and the CUDA autograd of
   ``rglru_scan_ref``, bit for bit, at recurrentgemma-9b's width 4096 (T
   1, 31, 33, 1024; W 4097 at T 65), decays near 0, mid and near 1, from
   h0 and from zero; K4's backward against the CUDA autograd of
   ``wkv6_ref`` and ``wkv6_bwd_ref`` at rwkv6-3b's 40 heads of 64 in bf16
   (T 1, 15, 17, 63, 65, 127, 129 crossed with decays near 1, mid and near
   0 and s0 given or not; T 1024), per element within ``WKV_BWD_REL`` of
   the largest |ref| plus one bf16 ulp; two planted faults in K5's, three
   in K4's (u dropped, s0 not carried in, dsT dropped), a repeat bit for
   bit, times beside the bounds and the plain versions, and each of K4's
   backward kernels' device us at T 1024.  7g
   (``arch_phase``): one full-width train step of rwkv6-3b (8 of 32 layers)
   and recurrentgemma-9b (9 of 38), 2 x 512 tokens, bf16, kernel path
   against plain path, and an f32 step at 2 and 3 layers with two planted
   faults in K4's or K5's backward; 7h: ``Trainer`` (whose step is
   donated: params and optimizer state updated in place) at full width,
   rwkv6-3b whole, 32 of 32 layers (8 x 1024, 8 microbatches; its peak
   must stay under ``ARCH_TRAIN_PEAK``) and recurrentgemma-9b at 4 of 38
   (4 x 1024; whole it needs 172 GB, see ``ARCH_TRAIN``): ms a step,
   tokens per second, the 6 N tokens bound, launches of every kernel, peak
   memory, one profiled step's idle share and each kernel's device ms; the
   loss must fall; 7i: ``python -m repro_torch.launch.train --arch A
   --smoke --steps 20`` for both on the card (started in the background
   at 5f's policy drains, checked here).  7j (``donation_check``):
   one full-width qwen2-0.5b bf16 train step at 7b's shape, donated
   against functional from the same state and batch: params, f32 master,
   m, v, step and metrics bit for bit, the donated step's leaves in its
   arguments' storages.  7k (``archs_train_phase``): the seven
   configurations no earlier phase trains.  (a) one train step at full
   width, kernel path against plain path from the same params (seed 0)
   and batch, in bf16 at a depth that holds every layer kind
   (``ARCHS_STEP_DEPTH``: gemma3-1b 6 layers at 2 x 1024, five local and
   one global; llama-vision 5, four full and one cross, over its 1600
   image tokens with its gates non-zero; whisper-base whole, 6 + 6
   layers at 2 x 448 with its 1536 frames; qwen2-1.5b whole, minicpm3-4b
   8, the MoE configurations 2; 2 x 512 tokens) and in f32 at fewer
   layers (``ARCHS_F32``; the VLM at one full and one cross layer): K3's
   forward and backward launches exact (every self, local, cross and
   encoder site; none for MLA, whose every leaf must get a gradient), the
   loss gap, the bf16 step's whole-gradient L2 gap and the f32 step's
   worst leaf within their limits, the MoE configurations on the plain
   path's expert choices (``RoutingLog(force=...)``) with the unforced
   count of choices that differ printed; two planted faults in K3's
   backward on the f32 steps must exceed the limit (the window dropped,
   gemma3-1b; causal=True in the cross attention, whisper-base).  (b)
   ``Trainer`` (donated AdamW, lr 3e-3 reached over 3 warmup steps, each
   configuration's own microbatches) for 6 steps of 8 x 1024 (whisper 8
   x 448): gemma3-1b,
   qwen2-1.5b and whisper-base whole, minicpm3-4b, qwen3-moe and
   phi3.5-moe at the deepest depth whose 20 B a parameter fit 60 GB
   (``trainer_depth``: 44, 3 and 2 layers; minicpm3-4b cut to 22 for the
   run's time, ``ARCHS_TRAIN_TIME_DEPTH``); ms a step, tokens per second,
   the 6 N tokens bound, K3 launches exact, a peak under 72 GB, finite
   losses with the held-out loss falling 5 % (7d's and 7h's gate without
   the mean of the last steps, which the swings of lr 3e-3 fail)
   and one profiled step's idle share; llama-vision gets none (5
   layers need 130 GB), as printed.  (c) ``launch.train.main(["--arch",
   A, "--smoke", "--steps", "20"])`` in this process for all ten
   configurations: the two loss lines.  Every cut is printed;
8. distribution and the example twins (about 40-90 s): 8a runs the twins
   that touch the device in this process at their reference's reduced
   sizes, each also on the CPU: ``torch_trace_stencil`` (K1 once per slab,
   16 launches, bit for bit against the plain sweep, its trace replayed),
   ``torch_serve_router`` and ``torch_control_serving`` (K3 drains of the
   reduced qwen2-0.5b; their printed schedule lines must equal the CPU
   run's, and their own asserts hold tokens identical across policies and
   under control), and ``torch_stencil_locality`` at one NCCL rank (K1 per
   slab, 0 elements unequal to the whole-lattice K1, the bytes handed to
   ``torch.distributed``); then, on one NCCL rank: 8b one full-width
   qwen2-0.5b bf16 train step at phase 7b's shape with DTensor parameters
   on a (1, 1) ``make_debug_mesh`` (placed by ``param_shardings``, the
   optimizer state by ``opt_state_shardings``), donated, against the
   same step without rules, functional: loss and every leaf bit for bit
   (else held to the reference check's limits, loss rtol 2e-5 and leaves atol 2e-4, and the
   gap printed), K3's forward and backward launches equal, no plain
   attention call, and ms a step of both; 8c ``seq_parallel_attention``'s
   per-shard piece at qwen2-0.5b's heads (14/2 x 64, bf16), T 4096 as four
   K3 launches at q_offset 0/1024/2048/3072, windows 0 and 300, against the
   plain ``chunked_attention``/``banded_attention`` on f32 copies of the
   bf16 values under K3's bf16 limit, shard 1 at q_offset 0 as a planted
   fault above it, timed beside one whole-T launch; 8d
   ``compressed_psum`` in its three modes (against numpy, bit for bit),
   ``lse_combine``, ``pipelined_apply`` at one stage and
   ``ring_halo_exchange`` (zeros at both ends);
9. the dry run and the roofline counter (``dryrun_phase``, at most about
   120 s; its time and cuts printed): 9a runs ``python -m
   repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k,decode_32k
   --mesh single`` in a process of its own, started in the background at
   5f's policy drains (a mesh of device type ``cuda``
   over PyTorch's fake process group of 256 ranks, so the NCCL rank of
   phases 3c and 8 is not disturbed; 2 of the 40 single-pod cells): both
   cells ``ok``, their roofline rows printed; 9b holds the counter
   (``roofline.op_cost``) to the card on full-width qwen2-0.5b bf16 at
   phase 7d's 8 x 1024 with remat, one rank, no mesh: the counted per-card
   peak of the plain step (``use_kernel=False``, counted on ``meta``
   tensors) against ``torch.cuda.max_memory_allocated`` of the same plain
   step on the card (the bytes allocated before it that are not its
   arguments taken out), ratio within 0.98-1.02; the kernel step (K3
   forward and backward, 7d's path) counted as it runs on the card, K3's
   launches reported by its wrapper with their own reads and writes
   (``op_cost.kernel_launch``), its FLOPs within 0.85-1.0 of the plain
   step's; each step's ms beside its own counted ``t_bound`` on the H100's
   datasheet constants (the plain step's bytes are eager ones at every
   op, the score-sized intermediates included), both shares and
   ``useful_flops_ratio`` printed, no gate on the shares; the same kernel
   step counted on ``meta`` tensors in this process, as the dry run counts
   it (F14: K3 allocates and reports, launches nothing), against the
   card's count: its kernel records equal record for record (name, flops,
   bytes), its FLOPs within 1e-9 and bytes within 1 % of the card's
   totals, its counted peak within 0.98-1.02 of the kernel step's
   ``max_memory_allocated``; and K3's meta table of blocks per SM
   (``kernel.H100_BLOCKS_PER_SM``) equal to the library's answer for every
   compiled variant; 9c
   (``kernel_report_phase``) holds the other kernels' reports: the paper's
   ``run_runtime_sweep`` (2400x600x600, ``di = 10``) counted on the card
   gives exactly 240 ``kernel.K1`` records whose bytes are the slabs'
   rows and halo planes, 7.60032e9 B (the slab tasks' aten ops, on the
   runtime's worker threads, are not seen; their reports are), and the
   whole-lattice K1 and K2 one record each of 6.912e9 B; one train step
   of rwkv6-3b (1 of 32 layers) and of recurrentgemma-9b (3 of 38) at
   phase 7h's batch and length, counted as it runs on the card: each
   kernel's forward and backward records equal its launch counters; the
   counted FLOPs and bytes beside the plain step's count on ``meta``
   tensors (counted in a process of its own from 5f on), and the
   kernel step's share of its own bound, no gate; both kernel steps
   counted on ``meta`` tensors held to the card's count and peak under
   9b's gates, and K4's backward workspace as the meta path sizes it
   (``kernel.bwd_workspace_floats``) equal to the library's;
10. print the ``serving``, ``training``, ``distribution``, ``roofline`` and
   ``kernels`` JSON lines, the card's name and power limit, and last the
   ``{"ok": true, ...}`` line.

Exits non-zero, with no result line, when there is no CUDA device or when
the port's sources are not beside this script.
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import dataclasses
import datetime
import gc
import io
import itertools
import json
import multiprocessing
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
LATTICE = (2400, 600, 600)    # the paper's lattice (repro/core/tasks.py PAPER_GRID)
SWEEP_CASES = [((20, 20, 60), (10, 10)), ((8, 16, 128), (4, 8)),
               ((10, 10, 600), (10, 10)), ((30, 20, 32), (10, 5)),
               ((4, 4, 16), (2, 2))]
TWO_STEP_CASES = [((20, 20, 32), (5, 5)), ((12, 8, 16), (4, 4)),
                  ((10, 10, 600), (10, 10)), ((8, 8, 8), (2, 2))]
K1_ATOL, K2_ATOL = 1e-6, 1e-5
# K1 and K2 on either side of a tile: offsets of (nj, nk) from (tiles x TJ,
# TK) at 1 and 2 tiles in j; nk 119 and 121 take the 4-byte-copy instance
TILE_J_OFFSETS, TILE_K_OFFSETS = (-1, 0, 1), (-4, -1, 0, 1, 4)
# lattices smaller than one tile, and nk not a multiple of 4
SMALL_LATTICES = [(3, 2, 8), (2, 2, 4), (2, 3, 5), (6, 10, 30), (5, 9, 13), (3, 7, 1)]
SLAB_ROWS = 10                # the runtime sweep's slab (di) at the paper lattice
SPEC_SWEEP = "paper_cyclic"   # the spec-built runtime sweep's policy: 4 domains
SPMD_BLOCKS_PER_DEV = 4       # the scattered SPMD sweep's slabs per rank
PROFILER_WARMUP = 64          # device records queued ahead of a profiled session
# K1 and K2 before this design (PR 16 run 2, PERF.md §6, H100 80GB HBM3 at
# 700 W): printed beside this run's numbers, kept out of the result lines
JACOBI_BEFORE = {"jacobi_sweep_ms": 5.0611, "slab_us": 29.3,
                 "jacobi_two_step_ms": 6.8504, "runtime_sweep_ms": (8.1639, 11.3333)}
# tests/test_kernels.py's flash cases: b, hq, hkv, tq, tk, hd, causal, window
FLASH_CASES = [(2, 4, 2, 128, 128, 32, True, 0), (1, 8, 1, 256, 256, 64, True, 0),
               (2, 4, 4, 128, 128, 16, False, 0), (1, 4, 2, 256, 256, 32, True, 96),
               (1, 2, 2, 64, 192, 32, True, 0)]
# K3 against mha_ref, per element |got - r| <= atol + rtol * |r|.  f32: the
# online softmax reassociates the sums.  bf16: both compute in f32 from the
# same bf16 values and round the result to bf16 once, so they may land one
# bf16 ulp apart (at most 2^-7 |r|) on top of the f32 difference.  Relative
# to each value, the limit stays below the small outputs of late rows over
# long key ranges, where a lost key tile would show.
K3_F32_TOL = dict(atol=3e-5, rtol=0.0)
K3_BF16_TOL = dict(atol=3e-5, rtol=2.0 ** -7)
# tests/test_kernels.py's WKV6 cases: b, t, h, hd
WKV_CASES = [(2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 8)]
# K4 against wkv6_ref, per element |got - r| <= K4_REL * max |r| over the
# shape: both compute in f32 from the same (bf16-rounded) r, k, v, and sum
# the same products in other orders, so they differ by a few f32 ulps of
# the largest terms; 1e-5 of the largest value is far below the typical
# one (the median |r| is printed beside it), where a lost step or column
# would show
K4_REL = 1e-5
# the serving workloads: 12 requests of 128-1024 prompt tokens, 32 new tokens
N_REQUESTS, REPLICAS, MAX_NEW, MAX_SEQ = 12, 3, 32, 2048
PROMPT_LEN = (128, 1024)
POLICIES = ("locality", "round_robin", "single_queue")
QWEN, RWKV, GRIFFIN = "qwen2-0.5b", "rwkv6-3b", "recurrentgemma-9b"
GEMMA, QWEN15 = "gemma3-1b", "qwen2-1.5b"
QWEN3, PHI, MINICPM, WHISPER, VLM = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b",
                                    "minicpm3-4b", "whisper-base", "llama-3.2-vision-90b")
# K3 at qwen2-0.5b's shapes: (name, Tq, Tk, q_offset)
K3_SHAPES = [("prefill_128", 128, 128, 0), ("prefill_1024", 1024, 1024, 0),
             ("decode_0", 1, 2048, 0), ("decode_517", 1, 2048, 517),
             ("decode_2047", 1, 2048, 2047)]
K3_HEADLINE = "decode_517"    # 97 % of the path's launches are decode steps
# K4 at rwkv6-3b's shapes (name, T), each from a carried state written in
# place, as the model calls it
K4_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K4_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# K4's time-chunk boundaries (offsets from TIME_CHUNK: one launch up to C,
# three past it) and lengths of several chunks with a ragged last one
K4_CHUNK_OFFSETS = (-1, 0, 1)
K4_MULTI_CHUNK = (2, 3)       # T = m C + 5
# tests/test_kernels.py's RG-LRU cases: b, t, w, chunk
RGLRU_CASES = [(2, 128, 64, 32), (1, 256, 128, 128), (3, 64, 32, 64)]
# K5 at recurrentgemma-9b's width (name, T), each from a carried state as the
# model calls it (a prefill's state is its zero cache)
K5_SHAPES = [("prefill_128", 128), ("prefill_1024", 1024), ("decode", 1)]
K5_HEADLINE = "decode"        # 97 % of the path's launches are decode steps
# K4 and K5 of the previous designs (one thread per state column walking all
# of time; one thread per channel, 16 steps of loads in flight): phase 6's
# ms on an H100 80GB HBM3 at 700 W (PERF.md §6), printed beside this run's
# and kept out of the result lines, which carry only this run's measurements
BEFORE_MS = {"wkv6": {"prefill_128": 0.0673, "prefill_1024": 0.7072, "decode": 0.0073},
             "rglru": {"prefill_128": 0.0104, "prefill_1024": 0.0715, "decode": 0.0060}}
# K3 at recurrentgemma-9b's shapes: (name, Tq, Tk, q_offset, window).  Prefill
# passes the local layers' window; decode reads the 2048-slot ring with no
# window (its slots are not in position order); the drain never wraps the
# ring (1024 + 32 < 2048), so the wrapped positions are checked apart
K3_GRIFFIN_SHAPES = [("prefill_128", 128, 128, 0, 2048),
                     ("prefill_1024", 1024, 1024, 0, 2048),
                     ("decode_0", 1, 2048, 0, 0), ("decode_517", 1, 2048, 517, 0),
                     ("decode_2047", 1, 2048, 2047, 0)]
K3_RING_WRAPPED = (2100, 4095)
# K3's bf16 design: decode (q_offset, window) on either side of a split
# boundary (64-key tiles: 63 fills one tile, 64 starts the second) and a
# windowed decode whose range starts mid-tile; prefill one past the row tile
# and the key tile (577 = 9 * 64 + 1 at qwen2's 9 positions per block, 129 =
# 4 * 32 + 1 at hd 256); a split prefill in which some rows see none of a
# chunk's keys (qwen2 T 513: two chunks, the second from key 320; the row
# tile of positions 315-323 sees keys 320-323 only from it)
K3_SPLIT_DECODE = [(63, 0), (64, 0), (127, 0), (128, 0), (1023, 0), (1024, 0),
                   (2047, 100)]
K3_ONE_PAST = {QWEN: (577, 0), GRIFFIN: (129, 2048)}
K3_MISSED_CHUNK = 513
# kernel path vs plain path, teacher-forced.  qwen2-0.5b, bf16 logits: logits
# of magnitude ~3 have an ulp of 2^-6; attention rounded at other points
# (f32 softmax in K3, bf16 scores and weights in the plain path) moves them
# by a few ulps after 24 layers.  rwkv6-3b, on an f32 build (the bf16 build
# rounds its residual stream and gave gaps of 0.43 at |logits| 5): the two
# paths differ only in the order of K4's f32 sums, and the gap measured on
# the H100 was 0.0458 at |logits| 4.9, against 1.96 with u dropped and 7.50
# with the state not carried across decode steps.  The limit sits 2.7x above
# the sound reading and 15x below the nearer fault; both faults run in every
# call and must exceed it.  recurrentgemma-9b, on an f32 build: K5 equals
# the plain scan bit for bit, so the paths differ only in K3's f32 sums
# (12 local layers).  Measured on the H100: 2.5e-5 at |logits| 26, against
# 5.25 with the RG-LRU state not carried across decode steps and 4.96 with
# the conv history not carried.  The limit sits 40x above the sound reading
# and 5000x below the nearer fault; both faults run in every call.
# qwen3-moe-30b-a3b, on an f32 build of 8 layers: the paths differ in K3's
# f32 sums only, unless a top-8 routing choice flips on them (the script
# counts the choices that differ).  Measured on the H100: 4.6e-6 at |logits|
# 4.5 with no choice differing, against 1.63 with the top-k weights not
# renormalised and 1.84 with the decode's gather reading the next expert's
# weights; the limit sits 200x above the sound reading and 1600x below the
# nearer fault; both faults run in every call
LOGITS_ATOL = {QWEN: 0.25, RWKV: 0.125, GRIFFIN: 1e-3, QWEN3: 1e-3,
               GEMMA: 0.25, QWEN15: 0.25}
# the other four new configurations in bf16: decoded logits against the full
# forward, and the kernel path against the plain path, within qwen2-0.5b's
# bf16 limit (4 bf16 ulps at |logits| 8-16).  Measured on the H100 (PERF.md
# §6): against the forward 0.1016 (minicpm3-4b, 62
# layers), 0.0176 (whisper-base), 0.0703 (phi3.5-moe, 8 layers), 0.0859
# (llama-vision, 5 layers); against the plain path 0 (minicpm3-4b: MLA runs
# plain on both), 0.0195, 0.1484 (llama-vision), and 2.15 for phi3.5-moe
# with 26 top-2 routing choices flipped, hence its forced routing
OTHER_ATOL = {MINICPM: 0.25, WHISPER: 0.25, PHI: 0.25, VLM: 0.25}
# the other architectures (ROADMAP D).  qwen3-moe-30b-a3b is served whole
# (30.53 B parameters, 61.09 GB in bf16); its teacher-forced comparison runs
# on an f32 build of its first QWEN3_F32_LAYERS layers (122 GB whole in
# f32).  The other four run a prefill of OTHER_PREFILL tokens and
# OTHER_DECODE decode steps at full width, phi3.5-moe (83.7 GB whole) and
# llama-3.2-vision-90b (181 GB whole) at the depth given here
QWEN3_F32_LAYERS = 8
OTHER_DEPTH = {MINICPM: None, WHISPER: None, PHI: 8, VLM: 5}
# The round_robin and single_queue drains of every served configuration run
# at this depth (with a locality drain beside them, for token identity
# across policies); the locality drain stays at full depth.  Cuts that buy
# phases 5f-7 their time: on an H100 80GB HBM3 the full-depth drains took
# 15 s each (qwen2-0.5b), 40-42 s (qwen3-moe) and 25-32 s (rwkv6-3b,
# recurrentgemma-9b), and at 8, 9 and 8 layers 5-9 s
POLICY_DEPTH = 4
OTHER_PREFILL, OTHER_DECODE = 128, 8
# 5f: the six configurations no earlier phase drains, each served by
# ServingEngine on phase 4's traffic (one locality drain), at the depth
# given here (None: whole; phi3.5-moe and llama-vision as OTHER_DEPTH cuts
# them, since neither fits one card whole).  The whole ones' drain runs
# under torch.profiler.  whisper-base's decoder has 448 learned positions,
# so its prompts are cut to 64-416 tokens (the same seed): 416 + 32 new
# tokens fill exactly those 448, its max_seq
SERVE_DEPTH = {GEMMA: None, QWEN15: None, **OTHER_DEPTH}
WHISPER_CONTEXT = 448
SERVE_PROMPT_LEN = {WHISPER: (64, WHISPER_CONTEXT - MAX_NEW)}
# 5f profiles a window of each whole drain, not the drain: decode calls
# 16-31, the first request's last 16 steps (a whole drain's profile costs
# 30-57 us of host a device record: minicpm3-4b's 2.39 M records took
# 110-125 s); the idle share is the window's
PROFILE_WINDOW = (16, 16)
# windows taken at most in a drain, when the profiler lost K3 records
PROFILE_ATTEMPTS = 3
# gemma3-1b's and qwen2-1.5b's teacher-forced request: 1000 prompt tokens,
# so that gemma3-1b's 512-slot rings wrap in prefill and in every decode step
TF_PROMPT = 1000
# 5g: the serving driver on the card against its CPU run.  A token that
# differs is allowed only where the CPU run's top two logits at that step
# lie within CLI_TIE of each other (a tie; the reduced configs are f32, K3
# within 3e-5); the CPU runs take this many threads in their own process
CLI_TIE = 1e-4
CLI_CPU_THREADS = 2
CLI_SUBPROCESS_ARCH = QWEN
# the most this script waits, from when it asks, for a command it started
# in the background (5g's, 7i's, 9a's) to end
COMMAND_TIMEOUT_S = 300
VLM_GATES = (0.5, -0.7)       # gate_x, gate_m: non-zero, so the cross path counts
# K3 at the new architectures' shapes: (name, Hq, Hkv, hd, Tq, Tk, q_offset,
# causal).  qwen3-moe: 32 q / 4 kv heads of 128 (group 8); whisper-base: 8/8
# heads of 64, its encoder's self-attention and its decoder's
# cross-attention without a causal mask over 1536 frames; the VLM: 64/8
# heads of 128, cross-attention over 1600 image tokens
K3_NEW_SHAPES = {
    QWEN3: [("prefill_128", 32, 4, 128, 128, 128, 0, True),
            ("prefill_1024", 32, 4, 128, 1024, 1024, 0, True),
            ("decode_517", 32, 4, 128, 1, 2048, 517, True),
            ("decode_2047", 32, 4, 128, 1, 2048, 2047, True)],
    WHISPER: [("encoder_1536", 8, 8, 64, 1536, 1536, 0, False),
              ("cross_128", 8, 8, 64, 128, 1536, 0, False),
              ("cross_1", 8, 8, 64, 1, 1536, 0, False)],
    VLM: [("cross_128", 64, 8, 128, 128, 1600, 0, False),
          ("cross_1", 64, 8, 128, 1, 1600, 0, False)]}
# the plain long prefill on the card, against K3: (config, T, window)
LONG_PREFILL = [(QWEN, 4096, 0), ("gemma3-1b", 4096, 512)]


def fail(msg: str) -> None:
    """Say why the run failed, on both streams (a caller that keeps only
    the end of standard error still sees it), and exit with code 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def free_device_memory() -> None:
    """Return freed tensors to the card.  A serving engine and its executor
    form a reference cycle (the executor's handler is a bound method of the
    engine) that keeps the model's parameters alive until the cycle
    collector runs, so collect first."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def max_err(a, b) -> float:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if not bool(a.isfinite().all()):
        fail("non-finite values in a kernel's output")
    return float((a.float() - b.float()).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call.  Each timed call is queued behind a 2 ms
    device sleep, so the events measure the device alone even where the
    kernel is far below launch latency (back-to-back calls would time the
    host)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def queued_us(fn, n: int = 50) -> float:
    """Device us of one call of ``fn`` where calls follow each other, as the
    runtime sweep's slab launches do: ``n`` calls queued behind a device
    sleep long enough for the host to enqueue them all, timed by events on
    the device (back-to-back calls with the device idle would time the
    host's enqueue)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / n


def ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel: registers, shared memory, spills."""
    out, name = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.split(",", 1)[1].strip()
        elif "Used" in line and "registers" in line:
            out.append(f"  {name}: {line.split(':', 1)[1].strip()}; {spills}")
    return out


def bound(nbytes: float, flops: float, flops_per_s: float):
    """(least ms, what bounds it): the bytes over HBM or the flops over the
    given peak, whichever takes longer."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def k3_bound(b, hq, hkv, tq, tk, hd, q_offset, elem_bytes=2, causal=True):
    """Least time for one K3 call on these inputs: the larger of the bytes
    it must move (q, k, v rows it reads once, o written once: the visible
    keys only, all Tk without a causal mask) over HBM, and its flops (4*hd
    per visible (head, query, key) pair, ``FWD_FLOPS_PER_PAIR``, the count
    K3's wrapper reports) over the bf16 tensor-core peak."""
    from repro_torch.kernels.flash_attention.kernel import FWD_FLOPS_PER_PAIR

    if causal:
        pairs = sum(min(tk, q_offset + t + 1) for t in range(tq))
        visible = min(tk, q_offset + tq)
    else:
        pairs, visible = tq * tk, tk
    nbytes = elem_bytes * hd * (2 * b * hq * tq + 2 * b * hkv * visible)
    return bound(nbytes, FWD_FLOPS_PER_PAIR * b * hq * hd * pairs, BF16_FLOPS_PER_S)


def k4_bound(b, t, h, hd, elem_bytes=2, state_in=True):
    """Least time for one K4 call: the larger of the bytes it must move (r,
    k, v in their dtype, w and u in f32 read once, o and the final state in
    f32 written once, the carried state read once) over HBM, and its f32
    flops (5 per (b, t, h, i, j): a multiply-add for o, a multiply and a
    multiply-add for S; ``FWD_FLOPS``, the count K4's wrapper reports) over
    the f32 peak."""
    from repro_torch.kernels.rwkv6.kernel import FWD_FLOPS

    n = b * t * h * hd
    nbytes = 3 * elem_bytes * n + 4 * n + 4 * n + 4 * h * hd \
        + 4 * b * h * hd * hd * (2 if state_in else 1)
    return bound(nbytes, FWD_FLOPS * n * hd, F32_FLOPS_PER_S)


def time_k3(label, q, k, v, *, q_offset=0, causal=True, window=0) -> dict:
    """K3's device time on these inputs beside its plain version's, its
    bound and its yardstick: SDPA (which the port never calls) over the
    filled slots at decode, else with a causal mask or none as K3 runs.
    The causal mask is K3's window too wherever the window binds nothing
    (a window of 2048 over at most 2048 keys)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    sdpa = torch.nn.functional.scaled_dot_product_attention
    tq, tk = q.shape[2], k.shape[2]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if causal and tq == 1:
        visible = min(tk, q_offset + 1)
        lib_call = lambda: sdpa(q, k[:, :, :visible], v[:, :, :visible],  # noqa: E731
                                enable_gqa=True)
    else:
        lib_call = lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True)  # noqa: E731
    e_lib = max_err(lib_call(), mha_ref(q, k, v, **kw))
    bnd, by = k3_bound(q.shape[0], q.shape[1], k.shape[1], tq, tk, q.shape[3], q_offset,
                       causal=causal)
    r = {"ms": device_ms(lambda: flash_attention(q, k, v, bq=tq, bk=tk, **kw)),
         "plain_ms": device_ms(lambda: mha_ref(q, k, v, **kw), 5),
         "bound_ms": bnd, "bound_by": by, "library_ms": device_ms(lib_call)}
    print(f"flash_attention {label}: {r['ms']:.4f} ms, bound {bnd:.6f} ms by {by} "
          f"({bnd / r['ms']:.2%} of bound), plain {r['plain_ms']:.4f} ms, library sdpa "
          f"{r['library_ms']:.4f} ms ({r['ms'] / r['library_ms']:.2f}x; max_abs_err vs "
          f"plain {e_lib:.3e})")
    return r


class Timed:
    """Wraps a replica's prefill or decode step: synchronised host time of
    each call, in ms (the engine syncs on every token anyway)."""

    def __init__(self, fn):
        self.fn, self.ms = fn, []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out


class windowed:
    """Wraps a drain's (Timed) decode step: ``torch.profiler`` traces only
    decode calls ``PROFILE_WINDOW[0]`` to ``sum(PROFILE_WINDOW) - 1``.  A
    profiled session costs 30-57 us of host a device record past the traced
    work (110-125 s for minicpm3-4b's whole drain), so the window
    keeps the cost small; ``wall_ms`` is the window's synchronised host
    time, ``own_s`` the profiler's start and stop and the reading of its
    records, outside the decode calls' own times.  A session can lose
    device records (1 to 5 of a window's 192-448 K3 calls, in about one
    window in ten on the H100): a window whose K3 calls are not exactly
    ``want_k3`` is retaken, up to ``PROFILE_ATTEMPTS`` times in all, on the
    same decode steps of the next request (each drain's request decodes
    ``MAX_NEW`` calls), as phase 6 retakes its profiled sweep."""

    def __init__(self, decode, want_k3):
        from torch.profiler import ProfilerActivity, profile
        self.decode, self.want_k3, self.calls, self.own_s = decode, want_k3, 0, 0.0
        self.first, self.attempts, self.lost = PROFILE_WINDOW[0], 0, []
        self.prof = self.wall_ms = self.t0 = self.spans = None
        self._new = lambda: profile(activities=[ProfilerActivity.CUDA])

    def __call__(self, *args):
        n = PROFILE_WINDOW[1]
        if self.calls == self.first and self.spans is None:
            t = time.perf_counter()
            self.prof = self._new()
            self.prof.start()
            warm_profiler()
            self.attempts += 1
            self.t0 = time.perf_counter()
            self.own_s += self.t0 - t
        out = self.decode(*args)
        self.calls += 1
        if self.calls == self.first + n and self.spans is None:
            torch.cuda.synchronize()
            t = time.perf_counter()
            wall_ms = (t - self.t0) * 1e3
            self.prof.stop()
            spans = drop_warmup(device_spans(self.prof))
            got = len(kernel_calls(spans, "flash_attention"))
            if got == self.want_k3:
                self.spans, self.wall_ms = spans, wall_ms
            else:
                self.lost.append({"decode_calls": [self.first, self.first + n - 1],
                                  "k3_calls": got, "records": len(spans)})
                print(f"profile window, attempt {self.attempts}: decode calls "
                      f"{self.first}-{self.first + n - 1} recorded {got} of "
                      f"{self.want_k3} K3 calls ({len(spans)} device records)")
                if self.attempts < PROFILE_ATTEMPTS:
                    self.first += MAX_NEW
            self.prof = None
            self.own_s += time.perf_counter() - t
        return out


def leaves(tree) -> list:
    """The tensors of a nested dict/list of parameters."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for sub in items for leaf in leaves(sub)]


def device_spans(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every kernel, copy and set the profiler
    saw on the card.  Read from the raw records: building the profiler's
    event tree for a whole drain's half a million records takes minutes."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA]


def warm_profiler() -> None:
    """Queue one-element fills ahead of the work a profiler session is to
    trace, and wait for them.  On the H100 host a session could lose its
    first 32 device records (the first 32 of a runtime sweep's 240 K1
    launches; a drain's first prefill marker), so the traced work's own
    records come after these; ``drop_warmup`` removes what is left of them."""
    x = torch.zeros(1, device="cuda")
    for _ in range(PROFILER_WARMUP):
        x.fill_(1.0)
    torch.cuda.synchronize()


def drop_warmup(spans) -> list[tuple[str, int, int]]:
    """The spans in start order, less the leading fills of ``warm_profiler``
    (they all end before the traced work starts, which begins with another
    kernel)."""
    spans = sorted(spans, key=lambda sp: sp[1])
    i = 0
    while i < len(spans) and "FillFunctor" in spans[i][0]:
        i += 1
    return spans[i:]


def busy_ms(spans) -> float:
    """Union of the spans' device intervals, in ms."""
    total, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(spans, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def top_kernels(spans, n: int = 8) -> list[str]:
    """The ``n`` device functions with the most total time."""
    by_name: dict[str, list[float]] = {}
    for name, s, e in spans:
        by_name.setdefault(name, []).append((e - s) / 1e6)
    rows = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:n]
    return [f"  {sum(t):10.3f} ms {len(t):7d} calls {sum(t) / len(t) * 1e3:8.3f} us  "
            f"{name[:90]}" for name, t in rows]


def kernel_calls(spans, name) -> list[float]:
    """The device us of each call of the wrapper ``name``: a call starts at
    its first kernel (``<name>_kernel``) and takes in the family's later
    kernels (``<name>_...``, launched after it) up to the next call; its
    time is first start to last end."""
    calls = []
    for fn, st, e in sorted(spans, key=lambda sp: sp[1]):
        if f"{name}_kernel" in fn:
            calls.append([st, e])
        elif f"{name}_" in fn and calls:
            calls[-1][1] = max(calls[-1][1], e)
    return [(e - st) / 1e3 for st, e in calls]


def call_summary(us: list[float]) -> dict:
    return {"calls": len(us), "total_ms": sum(us) / 1e3, "mean_us": sum(us) / max(len(us), 1)}


def requests(cfg, request_cls, prompt_len=PROMPT_LEN) -> list:
    """The serving workload (numpy seed 0), with token ids under the
    config's vocabulary and prompts of ``prompt_len`` tokens (inclusive)."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(N_REQUESTS):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        toks = rng.integers(0, cfg.vocab_size, size=plen)
        home = int(rng.integers(0, REPLICAS)) if rng.random() < 0.67 else -1
        reqs.append(request_cls(uid=i, tokens=toks, max_new=MAX_NEW, home_replica=home))
    return reqs


def free_port() -> int:
    """A free TCP port on this host, for the process group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def events_of(events) -> list[tuple]:
    return [(e.step, e.kind, e.worker, e.domain, e.task_uid) for e in events]


def spec_sweep(f, out_kwargs, di, counts, zero_counts) -> dict:
    """The spec-built runtime sweep (``spec.named(SPEC_SWEEP)``) recorded by
    the port's ``TraceRecorder``: one K1 launch per slab, a lattice equal to
    the kwargs path's ``out_kwargs`` bit for bit; the trace written as JSONL,
    read back, replayed from its header's spec alone with the recorded
    stats and event stream, and passed by the port's model checker."""
    from repro_torch import check, spec, trace
    from repro_torch.stencil.jacobi import run_runtime_sweep

    nslabs = f.shape[0] // di
    rec = trace.TraceRecorder()
    torch.cuda.synchronize()
    zero_counts()
    out, stats = run_runtime_sweep(f, di=di, spec=spec.named(SPEC_SWEEP), trace=rec,
                                   device="cuda")
    torch.cuda.synchronize()
    launched = counts()
    unequal = int((out != out_kwargs).sum())
    del out
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "spec_sweep.trace.jsonl"
        trace.TraceWriter(path).write(rec.finish())
        lines = path.read_text().count("\n")
        back = trace.TraceReader(path).read()
    replayed = trace.replay(back)
    same_events = events_of(replayed.executor.events) == events_of(back.events)
    verdict = check.check_trace(back, path="spec_sweep.trace.jsonl")
    print(f"run_runtime_sweep(spec={SPEC_SWEEP!r}, trace=TraceRecorder()): launches "
          f"{launched}, {unequal} elements unequal to the kwargs path; {stats}")
    print(f"spec-built sweep trace: {lines} JSONL lines, {len(back.events)} events; "
          f"replayed from its header: stats match {replayed.matches_recorded}, event "
          f"stream equal {same_events}; check_trace ok {verdict.ok} "
          f"({len(verdict.violations)} violations)")
    if unequal or stats.executed != nslabs or any(
            n != (nslabs if name == "jacobi_sweep" else 0) for name, n in launched.items()):
        fail(f"spec-built sweep: {unequal} unequal elements, executed {stats.executed}, "
             f"launches {launched}, want {nslabs} K1 launches and nothing else")
    if not (replayed.matches_recorded and same_events and verdict.ok):
        fail(f"spec-built sweep trace: replay mismatches {replayed.mismatches()}, "
             f"events equal {same_events}, violations {verdict.violations}")
    return {"spec": SPEC_SWEEP, "launches": launched["jacobi_sweep"],
            "unequal_elements": unequal, "trace_lines": lines,
            "replay_matches": replayed.matches_recorded, "check_ok": verdict.ok}


def spmd_sweeps(f, counts, zero_counts, backend: str = "nccl") -> dict:
    """Both SPMD sweeps as the one rank of a ``backend`` group (NCCL takes
    one rank per card) at the lattice ``f``: each equal to the whole-lattice
    K1 sweep with 0 unequal elements, K1 launched once (contiguous) and once
    per slab (scattered), and the bytes the rank hands to
    ``torch.distributed``, counted by wrapping its calls.  Then each sweep's
    time (CUDA events around back-to-back calls) beside the whole-lattice
    K1's and the padded copy's.  The group is destroyed on the way out."""
    import torch.distributed as dist
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.stencil import jacobi as stencil

    dist.init_process_group(backend, init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    handed: dict[str, int] = {}
    batch, gather = dist.batch_isend_irecv, dist.all_gather

    def counted_batch(ops):
        for op in ops:
            key = "p2p_sent" if op.op is dist.isend else "p2p_received"
            handed[key] = handed.get(key, 0) + op.tensor.numel() * op.tensor.element_size()
        return batch(ops)

    def counted_gather(tensor_list, tensor, *args, **kw):
        handed["all_gather_in"] = tensor.numel() * tensor.element_size()
        handed["all_gather_out"] = sum(t.numel() * t.element_size() for t in tensor_list)
        return gather(tensor_list, tensor, *args, **kw)

    dist.batch_isend_irecv, dist.all_gather = counted_batch, counted_gather
    try:
        if dist.get_backend() != backend:
            fail(f"the SPMD sweeps ran on {dist.get_backend()}, not {backend}")
        ni, nj, nk = f.shape
        cfg = stencil.JacobiGridConfig(ni=ni, nj=nj, nk=nk)
        bpd = SPMD_BLOCKS_PER_DEV
        whole = jacobi_sweep_cuda(f, di=ni, dj=nj)
        runs = {"contiguous": (stencil.make_contiguous_sweep(cfg), f, 1),
                "scattered": (stencil.make_scattered_sweep(cfg, bpd),
                              stencil.scatter_lattice(f, 1, bpd).contiguous(), bpd)}
        res = {}
        for name, (sweep, local, want) in runs.items():
            handed.clear()
            torch.cuda.synchronize()
            zero_counts()
            out = sweep(local, 1 / 6)
            torch.cuda.synchronize()
            launched = counts()
            if name == "scattered":
                out = stencil.reassemble_scattered(out, 1, bpd)
            unequal = int((out != whole).sum())
            del out
            res[name] = {"launches": launched["jacobi_sweep"], "unequal_elements": unequal,
                         "bytes_handed": dict(handed)}
            print(f"SPMD {name} sweep, 1 {dist.get_backend()} rank"
                  + (f", {bpd} slabs" if name == "scattered" else "")
                  + f": launches {launched}, {unequal} elements unequal to the "
                  f"whole-lattice K1, bytes handed to torch.distributed {dict(handed)}")
            if unequal or any(n != (want if k == "jacobi_sweep" else 0)
                              for k, n in launched.items()):
                fail(f"SPMD {name} sweep: {unequal} unequal elements, launches "
                     f"{launched}, want {want} K1 launches and nothing else")
        buf = torch.empty_like(f)
        zero = torch.zeros_like(f[0])
        whole_ms = time_ms(lambda: jacobi_sweep_cuda(f, di=ni, dj=nj, out=buf), 10)
        copy_ms = time_ms(lambda: torch.cat([zero[None], f, zero[None]]), 10)
        for name, (sweep, local, _) in runs.items():
            res[name]["ms"] = time_ms(lambda: sweep(local, 1 / 6), 10)
        del whole, buf
        bnd = 8 * f.numel() / HBM_BYTES_PER_S * 1e3
        print(f"SPMD sweeps at {tuple(f.shape)}: contiguous {res['contiguous']['ms']:.4f} "
              f"ms, scattered {res['scattered']['ms']:.4f} ms a sweep; whole-lattice K1 "
              f"{whole_ms:.4f} ms, byte bound {bnd:.4f} ms, padded copy "
              f"(torch.cat of the lattice and two planes) {copy_ms:.4f} ms")
        return res | {"backend": dist.get_backend(), "ranks": dist.get_world_size(),
                      "blocks_per_dev": bpd, "whole_lattice_k1_ms": whole_ms,
                      "padded_copy_ms": copy_ms, "bound_ms": bnd}
    finally:
        dist.batch_isend_irecv, dist.all_gather = batch, gather
        dist.destroy_process_group()


def controlled_drains(model, params, cfg, base_tokens, want, counts, zero_counts) -> dict:
    """Two more drains of the serving workload: one with the control plane
    (``control=ControlLoop.full(batch_cap=4)``) and one built from
    ``spec.named("controlled_serving")`` widened to ``REPLICAS`` domains and
    replicas and ``MAX_SEQ``.  Each must launch ``want`` and generate exactly
    ``base_tokens``, the uncontrolled ``locality`` drain's tokens."""
    from repro_torch import spec
    from repro_torch.control import ControlLoop
    from repro_torch.serving.engine import Request, ServingEngine

    s = spec.named("controlled_serving")
    s = dataclasses.replace(s, num_domains=REPLICAS, serving=dataclasses.replace(
        s.serving, num_replicas=REPLICAS, max_seq=MAX_SEQ))
    engines = {
        "control": lambda: ServingEngine(model, params, num_replicas=REPLICAS,
                                         max_seq=MAX_SEQ, policy="locality",
                                         control=ControlLoop.full(batch_cap=4)),
        "spec": lambda: ServingEngine(model, params, spec=s)}
    res = {}
    for label, make in engines.items():
        engine = make()
        for req in requests(cfg, Request):
            engine.submit(req)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        done = engine.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        tokens = {r.uid: tuple(r.out_tokens) for r in done}
        generated = sum(len(t) for t in tokens.values())
        res[label] = {"wall_s": wall, "tokens_per_s": generated / wall,
                      "launches": launched, "stats": vars(engine.stats),
                      "steps": engine.runtime.step_count,
                      "tokens_identical": tokens == base_tokens}
        print(f"{QWEN} {label}-built drain: {engine.stats}, wall {wall:.4f} s, "
              f"{generated / wall:.2f} tokens/s, {engine.runtime.step_count} scheduling "
              f"rounds, launches {launched}; tokens identical to the locality drain "
              f"{tokens == base_tokens}")
        if any(n != want.get(name, 0) for name, n in launched.items()):
            fail(f"{QWEN} {label}-built drain: launches {launched}, want {want}")
        if tokens != base_tokens:
            fail(f"{QWEN} {label}-built drain generated other tokens than the "
                 f"uncontrolled locality drain")
        del engine
    return res


class RoutingLog:
    """Within ``with``: every MoE block's expert choices, one (tokens, k)
    tensor of sorted expert indices per call, in call order (the port's
    ``moe.route`` wrapped; restored on the way out).  With ``force`` (the
    calls of another log), each call's choices are replaced by the forced
    call's and weighted by this run's own gates: teacher-forced routing."""

    def __init__(self, force: list | None = None):
        self.force = force

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.sound, self.calls = moe, moe.route, []

        def recording(p, xg, cfg):
            gates, topv, topi = self.sound(p, xg, cfg)
            if self.force is not None:
                topi = self.force[len(self.calls)].reshape(topi.shape)
                topv = torch.gather(gates, -1, topi)
                topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
            self.calls.append(topi.reshape(-1, topi.shape[-1]).sort(-1).values)
            return gates, topv, topi

        moe.route = recording
        return self

    def __exit__(self, *exc):
        self.moe.route = self.sound


def routes_differ(a: list, b: list) -> int:
    """(token, layer) pairs whose chosen experts differ between two runs'
    calls, matched call for call."""
    if [x.shape for x in a] != [y.shape for y in b]:
        fail(f"routing logs of different shapes: {len(a)} and {len(b)} calls")
    return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))


def k3_new_shapes(gen, dev, k3_check) -> tuple[dict, float, float]:
    """K3 against ``mha_ref`` per element at ``K3_NEW_SHAPES``, in bf16 (as
    the model passes them: (B, T, H, hd) projections as (B, H, T, hd)
    views) and in f32.  Returns the bf16 inputs by (arch, name) for phase 6
    and the largest bf16 and f32 errors."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import mha_ref

    inputs, worst = {}, {torch.bfloat16: 0.0, torch.float32: 0.0}
    for arch, shapes in K3_NEW_SHAPES.items():
        for name, hq, hkv, hd, tq, tk, qo, causal in shapes:
            for dtype, tol in ((torch.bfloat16, K3_BF16_TOL), (torch.float32, K3_F32_TOL)):
                q = torch.randn((1, tq, hq, hd), generator=gen, device=dev).to(dtype)
                k, v = (torch.randn((1, tk, hkv, hd), generator=gen, device=dev).to(dtype)
                        for _ in range(2))
                q, k, v = (x.transpose(1, 2) for x in (q, k, v))
                kw = dict(causal=causal, q_offset=qo)
                e = k3_check(f"{str(dtype).split('.')[-1]} {arch} {name} q {tuple(q.shape)} "
                             f"kv {tuple(k.shape)} q_offset={qo} causal={causal}",
                             flash_attention(q, k, v, bq=tq, bk=tk, **kw),
                             mha_ref(q, k, v, **kw), tol)
                worst[dtype] = max(worst[dtype], e)
                if dtype is torch.bfloat16:
                    inputs[arch, name] = (q, k, v, qo, causal)
    return inputs, worst[torch.bfloat16], worst[torch.float32]


def long_prefill(gen, dev, k3_check) -> dict:
    """B8's rest on the card: the plain ``chunked_attention`` (qwen2-0.5b's
    heads) and ``banded_attention`` (gemma3-1b's heads and window) at 4096
    tokens on CUDA tensors, against K3 per element.  The plain forms run on
    f32 copies of the same bf16 values and are rounded once to bf16, as
    ``mha_ref``'s result is; run in bf16 they round the softmax weights to
    bf16 before P.V (as the reference does, and K3 does not), and that
    error is printed beside."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.models import attention

    res = {}
    for arch, t, win in LONG_PREFILL:
        cfg = get_config(arch)
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        q = torch.randn((1, t, h, hd), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((1, t, kvh, hd), generator=gen, device=dev).bfloat16()
                for _ in range(2))
        got = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              window=win, bq=t, bk=t)
        if win:
            name, plain = "banded_attention", lambda *x: attention.banded_attention(*x, 0, win)
        else:
            name, plain = "chunked_attention", lambda *x: attention.chunked_attention(*x, 0)
        want = plain(q.float(), k.float(), v.float()).bfloat16()
        in_bf16 = plain(q, k, v)
        want, in_bf16 = (x.reshape(1, t, h, hd).transpose(1, 2) for x in (want, in_bf16))
        e = k3_check(f"bf16 {name} (plain, on f32 copies) at {arch}'s heads {(h, kvh, hd)}, "
                     f"T {t}, window {win}, vs K3", got, want, K3_BF16_TOL)
        e_bf16 = max_err(got, in_bf16)
        print(f"{name} run in bf16 (softmax weights rounded to bf16 before P.V) vs K3: "
              f"max_abs_err {e_bf16:.3e}")
        res[name] = {"arch": arch, "t": t, "window": win, "max_abs_err": e,
                     "max_abs_err_run_in_bf16": e_bf16}
    return res


def moe_split(params, cfg, dev, prompt_lens, gen) -> dict:
    """Device time of the MoE block's phases (router and top-k, dispatch,
    expert products, combine; the whole block beside them, whose rest is
    the load-balance loss) on layer 0's experts, CUDA events behind a
    device sleep: at a decode step (one token: the gather) and at each of
    the drain's prompt lengths (the batched product).  Per drain: the
    decode time x layers x decode steps, plus the prefills x layers."""
    from repro_torch.models import moe

    p = params["stack"][0]["moe"]
    dtype = p["w_gate"].dtype

    def phases(t, iters):
        x = torch.randn((1, t, cfg.d_model), generator=gen, device=dev).to(dtype)
        xg = moe.group(x, moe.num_groups_for(1, t))
        _, topv, topi = moe.route(p, xg, cfg)
        plan = moe.dispatch(xg, topv, topi, cfg)
        y = moe.expert_products(p, plan)
        return {"route": device_ms(lambda: moe.route(p, xg, cfg), iters),
                "dispatch": device_ms(lambda: moe.dispatch(xg, topv, topi, cfg), iters),
                "expert_products": device_ms(lambda: moe.expert_products(p, plan), iters),
                "combine": device_ms(lambda: moe.combine(plan, y), iters),
                "block": device_ms(lambda: moe.moe_block(p, x, cfg), iters)}

    m = cfg.moe
    decode = phases(1, 20)
    prefill = [phases(t, 5) for t in prompt_lens]
    steps = len(prompt_lens) * MAX_NEW
    per_drain = {name: cfg.num_layers * (decode[name] * steps + sum(pf[name] for pf in prefill))
                 for name in decode}
    chosen = 3 * m.top_k * cfg.d_model * m.d_ff_expert * torch.finfo(dtype).bits // 8
    bnd = bound(chosen, 6 * m.top_k * cfg.d_model * m.d_ff_expert, BF16_FLOPS_PER_S)
    print(f"{cfg.name} MoE block, layer 0, decode (1 token, gather): " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in decode.items())
        + f"; expert products bound {bnd[0] * 1e3:.2f} us by {bnd[1]} (the {m.top_k} "
        f"chosen experts' weights, {chosen / 1e6:.1f} MB)")
    print(f"{cfg.name} MoE block per drain ({len(prompt_lens)} prefills, {steps} decode "
          f"steps, {cfg.num_layers} layers): " + ", ".join(
              f"{k} {v:.1f} ms" for k, v in per_drain.items()))
    return {"decode_ms": decode, "prefill_ms_by_length": dict(zip(prompt_lens, prefill)),
            "per_drain_ms": per_drain, "decode_expert_products_bound_ms": bnd[0]}


def attention_calls(cfg, frames: bool) -> int:
    """K3 launches of one forward, prefill or decode call of ``cfg``: one
    per attention layer (none for MLA, which runs its plain path), one
    more per "cross" layer, and one per encoder layer when frames are
    encoded."""
    per = sum((cfg.mla is None) + (kind == "cross") for kind in cfg.layer_kinds()
              if kind in ("full", "local", "cross"))
    return per + (cfg.encoder.num_layers if frames and cfg.encoder is not None else 0)


def serve_config(arch, depth=None):
    """``arch``'s config as phase 5f serves it: cut to ``depth`` layers,
    else to ``SERVE_DEPTH[arch]`` (None: whole)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    depth = SERVE_DEPTH[arch] if depth is None else depth
    return cfg if depth is None else dataclasses.replace(cfg, num_layers=depth)


def serve_prompt_len(arch) -> tuple[int, int]:
    return SERVE_PROMPT_LEN.get(arch, PROMPT_LEN)


def serve_max_seq(arch) -> int:
    return WHISPER_CONTEXT if arch == WHISPER else MAX_SEQ


def drain_k3_launches(cfg) -> int:
    """K3 launches of one drain of the workload on ``cfg``: every request's
    prefill and decode steps, ``attention_calls`` each."""
    return N_REQUESTS * (1 + MAX_NEW) * attention_calls(cfg, frames=False)


def other_archs(dev, build, counts, zero_counts, limits, then=None) -> dict:
    """The four other new configurations at full width (depth cut as
    ``OTHER_DEPTH`` says): a prefill of ``OTHER_PREFILL`` tokens (whisper
    with its frames, the VLM with its image tokens and gates set non-zero,
    all from seed 0), then ``OTHER_DECODE`` teacher-forced decode steps.
    Their logits must equal the full forward's within ``limits[arch]`` (the
    MoE config at a capacity factor of E / k, where nothing can drop) and
    the plain path's (``use_kernel=False``) at the published capacity
    factor; K3 must carry every attention call but MLA's.  For an MoE
    config the kernel path takes the plain path's expert choices
    (``RoutingLog(force=...)``), as the teacher-forced comparisons take its
    tokens: the plain path rounds attention's softmax weights to bf16 and K3
    does not, and a top-k choice flips on such differences.  How many
    choices differ unforced, and that run's gap, are printed.  ``then(arch,
    cfg, model, params)``, when given, runs on each model before it is
    freed (phase 5f's drain)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    res = {}
    n = OTHER_PREFILL + OTHER_DECODE
    for arch, depth in OTHER_DEPTH.items():
        cfg = get_config(arch)
        if depth:
            print(f"{arch}: cut to {depth} of {cfg.num_layers} layers (the whole model "
                  f"does not fit on one card)")
            cfg = dataclasses.replace(cfg, num_layers=depth)
        model, params = build(arch, cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, n),
                               device=dev)[None]
        extras = {}
        if cfg.encoder is not None:
            extras["frames"] = (0.1 * torch.randn(
                (1, cfg.encoder.num_frames, cfg.encoder.d_model), generator=gen,
                device=dev)).to(model.dtype)
        if cfg.vision is not None:
            extras["vision"] = (0.1 * torch.randn(
                (1, cfg.vision.num_image_tokens, cfg.d_model), generator=gen,
                device=dev)).to(model.dtype)
            for layer in params["stack"]:
                if "gate_x" in layer:
                    layer["gate_x"].fill_(VLM_GATES[0])
                    layer["gate_m"].fill_(VLM_GATES[1])
        no_drop = cfg
        if cfg.moe is not None:
            no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
            print(f"{arch}: forward against decode at capacity factor "
                  f"{no_drop.moe.capacity_factor} (E / k: an expert takes every token; "
                  f"published {cfg.moe.capacity_factor})")
        want_k3 = attention_calls(cfg, True) + OTHER_DECODE * attention_calls(cfg, False)

        def stepwise(m, want):
            """Prefill, then the teacher-forced decode steps: the logits of
            positions OTHER_PREFILL - 1 .. n - 1, f32."""
            torch.cuda.synchronize()
            zero_counts()
            caches = m.init_cache(1, n)
            logits, caches = m.prefill(params, {"tokens": toks[:, :OTHER_PREFILL], **extras},
                                       caches)
            rows = [logits[:, -1]]
            for pos in range(OTHER_PREFILL, n):
                logits, caches = m.decode_step(params, toks[:, pos:pos + 1], pos, caches)
                rows.append(logits[:, -1])
            torch.cuda.synchronize()
            if counts()["flash_attention"] != want:
                fail(f"{arch}: prefill and decode launched {counts()}, want {want} K3")
            return torch.cat(rows).float(), counts()

        kernel_nd = build_model(no_drop, device=dev)
        with RoutingLog() as log:
            zero_counts()
            full = kernel_nd.forward(params, toks, extras=extras)[0][0, OTHER_PREFILL - 1:]
            torch.cuda.synchronize()
            fwd_launches = counts()
            steps_nd, launched_nd = stepwise(kernel_nd, want_k3)
        if fwd_launches["flash_attention"] != attention_calls(cfg, True) or \
                fwd_launches["attention_plain_calls"]:
            fail(f"{arch}: the full forward launched {fwd_launches}")
        gap_forward = float((steps_nd - full.float()).abs().max())
        flips_forward = None
        if cfg.moe is not None:
            layers = cfg.num_layers
            fwd, rest = log.calls[:layers], log.calls[layers:]
            stepped = [torch.cat([rest[i]] + [rest[layers * (1 + s) + i]
                                              for s in range(OTHER_DECODE)])
                       for i in range(layers)]
            flips_forward = routes_differ([x[OTHER_PREFILL - 1:] for x in fwd],
                                          [x[OTHER_PREFILL - 1:] for x in stepped])
        steps_k, launched_k = steps_nd, launched_nd
        with RoutingLog() as log_k:
            if no_drop is not cfg:
                steps_k, launched_k = stepwise(build_model(cfg, device=dev), want_k3)
        with RoutingLog() as log_p:
            steps_p, launched_p = stepwise(build_model(cfg, device=dev, use_kernel=False), 0)
        gap_unforced = float((steps_k - steps_p).abs().max())
        flips_plain, steps_kf = None, steps_k
        if cfg.moe is not None:
            flips_plain = routes_differ(log_k.calls, log_p.calls)
            with RoutingLog(force=log_p.calls):
                steps_kf, _ = stepwise(build_model(cfg, device=dev), want_k3)
        gap_plain = float((steps_kf - steps_p).abs().max())
        limit = limits[arch]
        print(f"{arch}: prefill {OTHER_PREFILL} + {OTHER_DECODE} decode steps "
              f"(|logits| up to {float(full.float().abs().max()):.3f}): max_abs_err vs the "
              f"full forward {gap_forward:.6f}, vs the plain path {gap_plain:.6f}"
              + ("" if cfg.moe is None else " with its expert choices") + f"; limit "
              f"{limit}; K3 launches {launched_k['flash_attention']} (want {want_k3}), plain "
              f"path: {launched_p['attention_plain_calls']} plain attention calls, "
              f"{launched_p['flash_attention']} K3"
              + ("" if cfg.moe is None else f"; (token, layer) routing choices that differ: "
                 f"{flips_forward} forward vs decode, {flips_plain} kernel vs plain path, "
                 f"whose logits differ by {gap_unforced:.6f} unforced"))
        if launched_p["flash_attention"] or not all(
                bool(x.isfinite().all()) for x in (full, steps_nd, steps_k, steps_kf, steps_p)):
            fail(f"{arch}: the plain path launched K3 or logits are not finite")
        if gap_forward > limit or gap_plain > limit:
            fail(f"{arch}: decoded logits differ from the full forward by {gap_forward} "
                 f"and from the plain path by {gap_plain}, limit {limit}")
        res[arch] = {"layers": cfg.num_layers, "cut_from": get_config(arch).num_layers,
                     "params": sum(x.numel() for x in leaves(params)),
                     "max_abs_err_vs_forward": gap_forward, "max_abs_err_vs_plain": gap_plain,
                     "max_abs_err_vs_plain_unforced": gap_unforced, "limit": limit,
                     "k3_launches": launched_k["flash_attention"],
                     "routes_differ_forward": flips_forward, "routes_differ_plain": flips_plain}
        del kernel_nd, full, steps_nd, steps_k, steps_kf, steps_p
        if then is not None:
            then(arch, cfg, model, params)
        del model, params
        free_device_memory()
    return res


def cpu_serve_runs(path: str) -> None:
    """Phase 5g's CPU side, in a process of its own (it runs while the
    card serves): ``repro_torch.launch.serve.main(["--arch", A, "--device",
    "cpu"])`` for every architecture, its printed lines and, for each
    request, the gap between the top two logits of each step whose argmax
    is a generated token (the tie rule), written to ``path`` as JSON."""
    torch.set_num_threads(CLI_CPU_THREADS)
    from repro_torch.configs import list_archs
    from repro_torch.launch import serve as serve_cli
    from repro_torch.models.model import Model
    from repro_torch.serving import engine

    gaps: dict[int, list[float]] = {}
    current: list[int] = []
    run, prefill, decode = engine.Replica.run, Model.prefill, Model.decode_step

    def tracked_run(self, req):
        current[:] = [req.uid]
        gaps[req.uid] = []
        return run(self, req)

    def gap_of(out):
        top2 = torch.topk(out[0][0, -1].float(), 2).values
        gaps[current[0]].append(float(top2[0] - top2[1]))
        return out

    engine.Replica.run = tracked_run
    Model.prefill = lambda self, *args: gap_of(prefill(self, *args))
    Model.decode_step = lambda self, *args: gap_of(decode(self, *args))
    res = {}
    for arch in list_archs():
        gaps.clear()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(["--arch", arch, "--device", "cpu"])
        res[arch] = {"lines": buf.getvalue().splitlines(), "seconds": time.perf_counter() - t0,
                     "gaps": {str(uid): g for uid, g in gaps.items()}}
    pathlib.Path(path).write_text(json.dumps(res))


def printed_requests(lines: list[str]) -> dict[int, list[int]]:
    """The serving driver's ``req N -> [tokens]`` lines as {N: tokens}."""
    return {int(line.split()[1]): json.loads(line.split("->", 1)[1])
            for line in lines if line.startswith("req ")}


def start_command(args: list[str]) -> tuple:
    """``python args`` from the checkout's root with the port on its path,
    started in the background: (command line, process, start time)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return " ".join(args), proc, time.perf_counter()


def finish_command(started) -> tuple:
    """Wait for a ``start_command`` process, at most COMMAND_TIMEOUT_S more
    seconds: (command line, exit code, stdout, stderr, seconds since its
    start)."""
    cmd, proc, t0 = started
    try:
        out, err = proc.communicate(timeout=COMMAND_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{cmd} ran past {COMMAND_TIMEOUT_S} s more")
    return cmd, proc.returncode, out, err, time.perf_counter() - t0


def serve_cli_phase(card, cpu_proc, cpu_path, subprocess_run) -> dict:
    """Phase 5g: the serving driver on the card, as a user runs it:
    ``python -m repro_torch.launch.serve --arch qwen2-0.5b`` in a
    subprocess on its default device (cuda; ``subprocess_run``, started by
    ``start_command``), and ``main(["--arch", A])`` in this process for
    the other nine, each against the same call with
    ``--device cpu`` (``cpu_serve_runs``, in ``cpu_proc``): the stats line
    must be equal, and so must the printed tokens, except past a token
    whose CPU step had its top two logits within CLI_TIE (a tie, printed)."""
    from repro_torch.configs import list_archs
    from repro_torch.launch import serve as serve_cli

    card_runs = {}
    for arch in list_archs():
        t0 = time.perf_counter()
        if arch == CLI_SUBPROCESS_ARCH:
            cmd, rc, stdout, stderr, secs = finish_command(subprocess_run)
            if rc:
                fail(f"{cmd} failed on the card:\n{stdout[-2000:]}\n{stderr[-4000:]}")
            lines, how = stdout.splitlines(), f"$ {cmd} (in the background since 5f)"
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                serve_cli.main(["--arch", arch])
            lines, how = buf.getvalue().splitlines(), f"main(['--arch', '{arch}'])"
            secs = time.perf_counter() - t0
        card_runs[arch] = {"how": how, "lines": lines, "seconds": secs}
    t0 = time.perf_counter()
    cpu_proc.join(COMMAND_TIMEOUT_S)
    if cpu_proc.is_alive():
        cpu_proc.kill()
        cpu_proc.join()
        fail(f"5g: the CPU runs of the serving driver ran past {COMMAND_TIMEOUT_S} s")
    if cpu_proc.exitcode != 0:
        fail(f"5g: the CPU runs of the serving driver exited {cpu_proc.exitcode}")
    cpu = json.loads(pathlib.Path(cpu_path).read_text())
    shutil.rmtree(pathlib.Path(cpu_path).parent)
    print(f"5g: the CPU runs (their own process, {CLI_CPU_THREADS} threads, since 5f) "
          f"waited for {time.perf_counter() - t0:.1f} s more")
    out = {}
    for arch, run in card_runs.items():
        want = cpu[arch]
        got_req, want_req = printed_requests(run["lines"]), printed_requests(want["lines"])
        ties, unequal = [], []
        for uid, toks in want_req.items():
            mine = got_req.get(uid, [])
            first = next((i for i, (a, b) in enumerate(zip(mine, toks)) if a != b),
                         None if len(mine) == len(toks) else min(len(mine), len(toks)))
            if first is None:
                continue
            gap = want["gaps"][str(uid)][first] if first < len(toks) else None
            (ties if gap is not None and gap <= CLI_TIE else unequal).append(
                (uid, first, gap))
        print(f"{run['how']} on the card ({run['seconds']:.1f} s; CPU {want['seconds']:.1f} "
              f"s): {run['lines'][-1]}; {len(got_req)} printed requests, tokens equal to "
              f"the CPU run's in {len(want_req) - len(ties) - len(unequal)}")
        for uid, i, gap in ties:
            print(f"  {arch} req {uid}: token {i} differs from the CPU run's on a tie (the "
                  f"CPU step's top two logits {gap:.3e} apart, limit {CLI_TIE}): card "
                  f"{got_req[uid]}, CPU {want_req[uid]}")
        if run["lines"][-1] != want["lines"][-1] or len(run["lines"]) != len(want["lines"]):
            fail(f"5g {arch}: the stats line on the card {run['lines'][-1]!r} against "
                 f"{want['lines'][-1]!r} on the CPU")
        if unequal or set(got_req) != set(want_req):
            fail(f"5g {arch}: tokens differ from the CPU run's off a tie (request, "
                 f"token, top-two gap): {unequal}\ncard {run['lines']}\ncpu {want['lines']}")
        out[arch] = {"how": run["how"], "stats_line": run["lines"][-1],
                     "seconds": run["seconds"], "cpu_seconds": want["seconds"],
                     "ties": ties}
    return out


# -- 7. training ------------------------------------------------------------
# K3's backward against autograd of mha_ref on f32 copies of the same
# inputs, in bf16 and f32: (B, Hq, Hkv, Tq, Tk, hd, causal, window).  The
# training shape (qwen2-0.5b, batch 8 x 1024), qwen3-moe's 32/4 heads of 128,
# gemma3-1b's local layers (4/1 heads of 256, window 512), whisper's encoder
# (no mask) and a cross shape (Tq 128 over 1536 frames).
BWD_SHAPES = {"qwen2_train": (8, 14, 2, 1024, 1024, 64, True, 0),
              "qwen3": (1, 32, 4, 1024, 1024, 128, True, 0),
              "gemma3_window": (1, 4, 1, 1024, 1024, 256, True, 512),
              "whisper_encoder": (1, 8, 8, 1536, 1536, 64, False, 0),
              "cross": (1, 8, 8, 128, 1536, 64, False, 0),
              "griffin_local": (1, 16, 1, 3072, 3072, 256, True, 2048)}
BWD_HEADLINE = "qwen2_train"
# K3's backward at the training shape before this design (the SIMT kernels
# the f32 path keeps; PERF.md §6, H100 80GB HBM3 at 700 W): printed beside
# this run's time and kept out of the result lines
BWD_BEFORE_MS = 6.6028
# Per element, |got - ref| <= limit.  f32: 1e-4 of the largest |ref| (the
# same f32 math as the plain autograd, sums in other orders).  bf16: 2^-7
# |ref| + 2^-8 max |ref| (the gradient is rounded once to bf16, at most
# 2^-8 |ref| off).  Fixed before the first run on the card.
BWD_F32_REL = 1e-4
# one training step, kernel path against the plain path (use_kernel=False)
# from the same params and batch: each leaf's max |g_kernel - g_plain| over
# the leaf's max |g_plain|, and the loss's difference.  bf16 at full width:
# the plain attention rounds its softmax weights to bf16 and K3 does not (as
# in serving), so the gradients differ by a few bf16 ulps through 24 layers.
# f32 at TRAIN_F32_LAYERS layers: only the order of f32 sums differs; two
# planted faults in K3's backward must each exceed the f32 limit.
# Measured on an H100 80GB HBM3 at 700 W: bf16 worst leaf 0.0184 (layer 1's
# bk; median leaf 0.0062), loss 5.5e-5 apart; f32 at 4 layers worst leaf
# 2.5e-6, loss 9.5e-7 apart.  The limits sit 2.7x (bf16 leaf), 18x (bf16
# loss), 40x and 10x above those readings.
GRAD_LIMITS = {"bfloat16": 0.05, "float32": 1e-4}
LOSS_LIMITS = {"bfloat16": 1e-3, "float32": 1e-5}
TRAIN_F32_LAYERS = 4
# the trainer at full width, through repro_torch.launch.train's API: the
# synthetic corpus from seed 0, global batch 8 x 1024, 20 steps; then the
# resume check: 12 steps with a checkpoint every 6, resumed from step 6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 20
RESUME_STEPS, RESUME_EVERY = 12, 6


def bwd_bound(b, hq, hkv, tq, tk, hd, causal, window, elem_bytes):
    """Least time of one backward call: five products of the visible (query
    head, query, key) triples by hd (10 hd flops each, ``BWD_FLOPS_PER_PAIR``)
    over the bf16 or f32 peak, or q, k, v, dO read once and dq, dk, dv
    written once over HBM."""
    from repro_torch.kernels.flash_attention.kernel import BWD_FLOPS_PER_PAIR

    if causal:
        qpos = np.arange(tq)[:, None]
        key = np.arange(tk)[None, :]
        ok = key <= qpos
        if window > 0:
            ok &= key > qpos - window
        pairs = int(ok.sum())
    else:
        pairs = tq * tk
    flops = BWD_FLOPS_PER_PAIR * b * hq * hd * pairs
    nbytes = elem_bytes * hd * b * 2 * (hq * tq + 2 * hkv * tk)
    peak = BF16_FLOPS_PER_S if elem_bytes == 2 else F32_FLOPS_PER_S
    return bound(nbytes, flops, peak)


def bwd_limit_share(got, want, dtype) -> float:
    """The largest |got - want| over its limit (see BWD_F32_REL)."""
    if not bool(got.isfinite().all()):
        fail("non-finite values in K3's backward")
    mx = float(want.abs().max())
    lim = (BWD_F32_REL * mx if dtype == torch.float32
           else 2 ** -7 * want.abs() + 2 ** -8 * mx)
    return float(((got.float() - want).abs() / lim).max())


def resume_check() -> dict:
    """Phase 7e: the trainer as a user runs it, with no
    ``CUBLAS_WORKSPACE_CONFIG`` and no ``torch.use_deterministic_algorithms``
    (ROADMAP F2): RESUME_STEPS steps with a checkpoint every RESUME_EVERY,
    and a second trainer resumed from step RESUME_EVERY must give the same
    losses, params and optimizer state bit for bit."""
    import shutil

    from repro_torch import _tree
    from repro_torch.launch.train import make_trainer

    print(f"resume: CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r}, "
          f"deterministic algorithms {torch.are_deterministic_algorithms_enabled()}")

    def unequal_leaves(a, b):
        pairs = list(zip(_tree.flatten_with_path({"p": a["params"], "o": a["opt_state"]}),
                         _tree.leaves({"p": b["params"], "o": b["opt_state"]})))
        return {path: int((x != y).sum()) for (path, x), y in pairs if not torch.equal(x, y)}, \
            len(pairs)

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        print(f"resume: checkpoints in {ckpt} ({shutil.disk_usage(ckpt).free / 1e9:.1f} GB "
              f"free)")

        def trainer_for():
            t = make_trainer(QWEN, steps=RESUME_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                             seed=0, device="cuda", ckpt=ckpt, ckpt_every=RESUME_EVERY,
                             log_fn=lambda line: None)
            saves, restores = [], []
            save, restore = t.ckpt.save, t._restore_latest

            def timed_save(step, state, blocking=False):
                t0 = time.perf_counter()
                save(step, state, blocking=blocking)
                saves.append((step, blocking, time.perf_counter() - t0))

            def timed_restore(*args):
                t0 = time.perf_counter()
                out = restore(*args)
                restores.append(time.perf_counter() - t0)
                return out

            t.ckpt.save, t._restore_latest = timed_save, timed_restore
            return t, saves, restores

        t1, saves1, _ = trainer_for()
        straight = t1.run(seed=0)
        step_dir = pathlib.Path(ckpt) / f"step_{RESUME_EVERY:08d}"
        nbytes = sum(f.stat().st_size for f in step_dir.iterdir())
        shutil.rmtree(pathlib.Path(ckpt) / f"step_{RESUME_STEPS:08d}")   # the "crash"
        t2, saves2, restores2 = trainer_for()
        resumed = t2.run(seed=0)
        same_losses = resumed["losses"] == straight["losses"][RESUME_EVERY:]
        differ, n = unequal_leaves(straight, resumed)
        unequal = sum(differ.values())
        print(f"resume: {RESUME_STEPS} steps straight vs resumed from step {RESUME_EVERY}: "
              f"losses {'identical' if same_losses else 'DIFFERENT'} "
              f"({[round(x, 6) for x in resumed['losses']]}), {unequal} unequal elements "
              f"in {n} params and optimizer tensors")
        print(f"resume: a checkpoint of step {RESUME_EVERY} is {nbytes} B on disk "
              f"({len(list(step_dir.iterdir())) - 1} .npy files); saves "
              + ", ".join(f"step {s} {'blocking' if b else 'staged'} {x:.2f} s"
                          for s, b, x in saves1 + saves2)
              + f"; restore {restores2[0]:.2f} s")
        if not same_losses or unequal:
            fail(f"resume: the resumed run differs from the uninterrupted one: {differ}")
        return {"identical": True, "checkpoint_bytes": nbytes, "saves_s": saves1 + saves2,
                "restore_s": restores2[0], "losses": resumed["losses"],
                "unequal_elements": unequal, "tensors": n}
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def loss_and_grads(model, params, batch):
    """(loss, the gradient of every leaf, zeros where none reached it) of
    one ``model.loss_fn`` from ``params`` on ``batch``."""
    from repro_torch import _tree

    flat = [p.detach().requires_grad_(True) for p in _tree.leaves(params)]
    loss, _ = model.loss_fn(_tree.unflatten(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(p) if g is None else g
                                  for p, g in zip(flat, grads)]


def time_steps(trainer):
    """Times each of ``trainer``'s steps from here on (synchronised host
    ms): (its own step function, the list the times go to)."""
    step_fn, times = trainer.step_fn, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    trainer.step_fn = timed
    return step_fn, times


def profile_step(step_fn, *args):
    """One more step under ``torch.profiler``: (its synchronised host ms,
    its device spans)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm_profiler()
        t0 = time.perf_counter()
        step_fn(*args)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, drop_warmup(device_spans(prof))


# -- phase 7's train step check and trainer run, shared by every configuration
# the trainers' AdamW peak learning rate, and the share of its first value by
# which the loss on one held-out batch (the corpus's next batch after the
# trained ones, never trained on) must fall from the initial params to the
# last step's: a trainer whose updates do nothing reads it unchanged, bit
# for bit
TRAIN_LR = 3e-3
TRAIN_HELD_OUT_FALL = 0.05
# device functions of a profiled train step, summed by family
TRAIN_FAMILIES = {"flash_attention_kernel": "K3 forward", "attn_bwd": "K3 backward",
                  "wkv6_kernel": "K4 forward (phase 1)", "wkv6_carry": "K4 forward (carry)",
                  "wkv6_fix": "K4 forward (fix)", "wkv6_bwd": "K4 backward",
                  "rglru_kernel": "K5 forward", "rglru_bwd": "K5 backward"}


def train_wrappers() -> dict:
    """The kernel wrappers of the train path by name: K3, K4 and K5 forward
    and backward, each counting its launches in ``launches``."""
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rwkv6 import kernel as k4
    return {"flash_attention": k3.flash_attention,
            "flash_attention_backward": k3.flash_attention_backward,
            "wkv6": k4.wkv6_cuda, "wkv6_backward": k4.wkv6_backward,
            "rglru": k5.rglru_scan_cuda, "rglru_scan_backward": k5.rglru_scan_backward}


def zero_train_launches() -> None:
    for fn in train_wrappers().values():
        fn.launches = 0


def train_launched() -> dict:
    return {name: fn.launches for name, fn in train_wrappers().items()}


def train_launches(cfg, steps: int = 1, microbatches: int = 1) -> dict:
    """Each kernel's launches in ``steps`` train steps of ``cfg`` of
    ``microbatches`` each: every attention site (``attention_calls``: full,
    local, self and cross of a "cross" layer, the encoder's layers) launches
    K3 forward once, twice with remat (the recomputation), and its backward
    once a microbatch; the RWKV and RG-LRU layers likewise K4 and K5."""
    kinds = cfg.layer_kinds()
    fwd = (2 if cfg.remat else 1) * steps * microbatches
    bwd = steps * microbatches
    att = attention_calls(cfg, frames=True)
    return {"flash_attention": att * fwd, "flash_attention_backward": att * bwd,
            "wkv6": kinds.count("rwkv") * fwd, "wkv6_backward": kinds.count("rwkv") * bwd,
            "rglru": kinds.count("rglru") * fwd,
            "rglru_scan_backward": kinds.count("rglru") * bwd}


def step_batch(dev, cfg, batch: int, seq: int) -> dict:
    """One train batch of ``cfg`` on the card: the corpus (seed 0) and, for
    whisper and the VLM, frames and image tokens of 0.1 N(0, 1) (seed 0) in
    f32, the dtype ``launch.train`` gives them (F13)."""
    from repro_torch.data.pipeline import make_batch_iterator

    it = make_batch_iterator(cfg.vocab_size, seq, batch, seed=0)
    out = {name: torch.as_tensor(x, device=dev) for name, x in next(it).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    if cfg.encoder is not None:
        out["frames"] = 0.1 * torch.randn(
            (batch, cfg.encoder.num_frames, cfg.encoder.d_model), generator=gen, device=dev)
    if cfg.vision is not None:
        out["vision"] = 0.1 * torch.randn(
            (batch, cfg.vision.num_image_tokens, cfg.d_model), generator=gen, device=dev)
    return out


def grad_gaps(paths, got, want) -> tuple[dict, float]:
    """Each leaf's max |got - want| over its max |want|, and the whole
    gradient's gap in the L2 norm; one leaf-sized f32 temporary at a time."""
    per, num, den = {}, 0.0, 0.0
    for path, x, y in zip(paths, got, want):
        d = x.to(torch.float32, copy=True).sub_(y)
        per[path] = float(torch.linalg.vector_norm(d, ord=float("inf"))) / max(
            float(torch.linalg.vector_norm(y, ord=float("inf"), dtype=torch.float32)), 1e-30)
        num += float(torch.linalg.vector_norm(d)) ** 2
        den += float(torch.linalg.vector_norm(y, dtype=torch.float32)) ** 2
        del d
    return per, (num / max(den, 1e-30)) ** 0.5


def step_check(dev, label, tcfg, batch, *, loss_limit, leaf_limit=None, l2_limit=None,
               faults=None) -> dict:
    """One train step of ``tcfg`` (``loss_fn`` and ``torch.autograd.grad``),
    kernel path against plain path (``use_kernel=False``) from the same
    params (seed 0; the VLM's gates at ``VLM_GATES``) and ``batch``.  An MoE
    kernel path takes the plain path's expert choices (``RoutingLog(force=
    ...)``); the choices that differ unforced are printed.  Fails unless
    each kernel launched as ``train_launches`` says and none on the plain
    path, the loss gap is within ``loss_limit``, each leaf's gap (of its
    max |plain|) within ``leaf_limit`` and the whole gradient's L2 gap
    within ``l2_limit``, where given, and a gradient reached every
    leaf that the plain path's reached (every leaf, for MLA).  Each of
    ``faults`` (name -> (module, attribute, a stand-in with a planted
    error)) must take a leaf past ``leaf_limit``."""
    from repro_torch import _tree
    from repro_torch.models.model import build_model

    kmodel, pmodel = (build_model(tcfg, max_pos=batch["tokens"].shape[1], device=dev,
                                  use_kernel=u) for u in (True, False))
    params = kmodel.init_params(torch.Generator(device=dev).manual_seed(0))
    for layer in params["stack"]:
        if "gate_x" in layer:
            layer["gate_x"].fill_(VLM_GATES[0])
            layer["gate_m"].fill_(VLM_GATES[1])
    paths = [p for p, _ in _tree.flatten_with_path(params)]
    t0 = time.perf_counter()
    zero_train_launches()
    with RoutingLog() as log_p:
        lp, gp = loss_and_grads(pmodel, params, batch)
    plain_counts = train_launched()
    res = {"layers": tcfg.num_layers, "layer_kinds": sorted(set(tcfg.layer_kinds())),
           "tokens": list(batch["tokens"].shape), "loss_plain": lp,
           "limits": {"loss": loss_limit, "leaf": leaf_limit, "l2": l2_limit}}
    forced = contextlib.nullcontext
    if tcfg.moe is not None:
        with RoutingLog() as log_k:
            lu, gu = loss_and_grads(kmodel, params, batch)
        per_u, l2_u = grad_gaps(paths, gu, gp)
        del gu
        res["unforced"] = {"routes_differ": routes_differ(log_k.calls, log_p.calls),
                           "loss_gap": abs(lu - lp), "l2_gap": l2_u,
                           "worst_leaf_gap": max(per_u.values())}
        forced = lambda: RoutingLog(force=log_p.calls)  # noqa: E731
    zero_train_launches()
    with forced():
        lk, gk = loss_and_grads(kmodel, params, batch)
    counts = train_launched()
    torch.cuda.synchronize()
    per, l2 = grad_gaps(paths, gk, gp)
    worst = max(per, key=per.get)
    want = train_launches(tcfg)
    silent = [p for p, x, y in zip(paths, gk, gp)
              if float(y.abs().max()) > 0 and not float(x.abs().max()) > 0]
    zeros = [p for p, x in zip(paths, gk) if not float(x.abs().max()) > 0]
    over = {p: g for p, g in per.items() if leaf_limit is not None and g > leaf_limit}
    res.update(loss_kernel=lk, loss_gap=abs(lk - lp), worst_leaf=worst,
               worst_leaf_gap=per[worst], median_leaf_gap=float(np.median(list(per.values()))),
               l2_gap=l2, launches=counts, want_launches=want, plain_launches=plain_counts,
               seconds=time.perf_counter() - t0)
    print(f"{label}: loss kernel {lk:.6f} plain {lp:.6f} (gap {abs(lk - lp):.3e}, limit "
          f"{loss_limit}); launches {counts} (want {want}; plain path "
          f"{sum(plain_counts.values())}); worst leaf gradient gap {per[worst]:.3e} of its "
          f"max ({worst}" + (f"; limit {leaf_limit}" if leaf_limit is not None else "")
          + f"); median leaf {res['median_leaf_gap']:.3e}; the whole gradient's L2 gap "
          f"{l2:.3e}" + (f" (limit {l2_limit})" if l2_limit is not None else "")
          + (f"; expert choices forced to the plain path's, unforced "
             f"{res['unforced']['routes_differ']} (token, layer) choices differ and the L2 "
             f"gap is {res['unforced']['l2_gap']:.3e}, the loss gap "
             f"{res['unforced']['loss_gap']:.3e}" if "unforced" in res else "")
          + f" ({res['seconds']:.1f} s)", flush=True)
    if counts != want or any(plain_counts.values()):
        fail(f"{label}: launches {counts} (plain path {plain_counts}), want {want} and none "
             f"on the plain path")
    if abs(lk - lp) > loss_limit or over or (l2_limit is not None and l2 > l2_limit) or \
            not np.isfinite(lk):
        fail(f"{label}: the kernel path's loss or gradient is off the plain path's (leaves "
             f"over their limit: {over})")
    if silent or (tcfg.mla is not None and zeros):
        fail(f"{label}: no gradient reached {(silent or zeros)[:5]} on the kernel path")
    if faults:
        res["planted_faults"] = {}
        for fname, (module, attr, fn) in faults.items():
            real = getattr(module, attr)
            fn.launches = 0          # the wrapper counts on the name the fault takes over
            setattr(module, attr, fn)
            try:
                with forced():
                    fg, _ = grad_gaps(paths, loss_and_grads(kmodel, params, batch)[1], gp)
            finally:
                setattr(module, attr, real)
            fworst = max(fg, key=fg.get)
            share = fg[fworst] / leaf_limit
            print(f"{label}, planted fault '{fname}': worst leaf gradient gap "
                  f"{fg[fworst]:.3e} ({fworst}; {share:.1f}x the limit)", flush=True)
            if share <= 1.0:
                fail(f"{label}: planted fault '{fname}' stays within the limit")
            res["planted_faults"][fname] = fg[fworst]
    del kmodel, pmodel, params, gk, gp
    free_device_memory()
    return res


def held_out_loss(model, params, batch, microbatches: int) -> float:
    """The mean loss of ``model`` from ``params`` on ``batch``, taken in the
    trainer's microbatches, without gradients."""
    from repro_torch.train.train_step import _split_microbatches

    with torch.no_grad():
        return float(np.mean([float(model.loss_fn(params, mb)[0])
                              for mb in _split_microbatches(batch, microbatches)]))


def train_run(dev, card, label, trainer, tcfg, *, batch: int, seq: int,
              peak_limit: float = float("inf"), steps_fall: bool = True) -> dict:
    """``trainer`` (donated, over ``launch.train``'s batches of ``batch`` x
    ``seq``) from seed 0 with each step timed, then one more step under
    ``torch.profiler``.  Prints ms a step, tokens/s, the share of the 6 N
    tokens bound, the peak, the losses and the profiled step's idle share
    and device time by kernel family.  Fails unless each kernel launched as
    ``train_launches`` says, the losses are finite (with ``steps_fall``,
    the mean of the last quarter of the steps, 7d's five of 20 and 7h's
    three of 10, below the first), the held-out loss
    (``held_out_loss`` on the
    batch after the trained ones, seed 0, from the initial params and from
    the last step's) falls by ``TRAIN_HELD_OUT_FALL`` of its first value,
    and the peak is within ``peak_limit``.  The profiled step takes the
    held-out batch."""
    from repro_torch import _tree
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch import train as launch_train

    steps = trainer.cfg.total_steps
    it = launch_train._with_extras(
        make_batch_iterator(tcfg.vocab_size, seq, batch, seed=0), tcfg, batch)
    for _ in range(steps):
        next(it)
    held = {name: torch.as_tensor(x, device=dev) for name, x in next(it).items()}
    held_losses, init_state = [], trainer.init_state

    def init_and_read(seed=0):
        params, opt = init_state(seed)
        held_losses.append(held_out_loss(trainer.model, params, held, tcfg.microbatches))
        zero_train_launches()           # the trainer's own launches from here
        return params, opt

    trainer.init_state = init_and_read
    step_fn, times = time_steps(trainer)
    free_device_memory()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run = trainer.run(seed=0)
    wall = time.perf_counter() - t0
    counts, peak = train_launched(), torch.cuda.max_memory_allocated()
    held_losses.append(held_out_loss(trainer.model, run["params"], held, tcfg.microbatches))
    losses = run["losses"]
    n_params = sum(x.numel() for x in _tree.leaves(run["params"]))
    tokens = batch * seq
    steady = float(np.mean(times[2:]))
    bound_ms = 6 * n_params * tokens / BF16_FLOPS_PER_S * 1e3
    want = train_launches(tcfg, steps, tcfg.microbatches)
    fall = 1 - held_losses[1] / held_losses[0]
    print(f"{label}: {n_params} params, {steps} steps of {batch} x {seq} tokens in "
          f"{wall:.2f} s (init included); ms a step (synchronised host clock) first "
          f"{times[0]:.1f}, steady mean {steady:.2f} (steps 3-{steps}), "
          f"{tokens / steady * 1e3:.0f} tokens/s; 6 N tokens bound {bound_ms:.2f} ms, "
          f"{bound_ms / steady:.1%} of it; launches {counts} (want {want}); peak device "
          f"memory {peak} B ({peak / 1e9:.2f} GB, limit {peak_limit / 1e9:.0f} GB) [{card}]")
    print(f"{label} losses: {[round(x, 4) for x in losses]}; held-out loss "
          f"{held_losses[0]:.4f} -> {held_losses[1]:.4f} ({fall:.1%} fall, at least "
          f"{TRAIN_HELD_OUT_FALL:.0%} wanted)", flush=True)
    if counts != want:
        fail(f"{label}: launches {counts}, want {want}")
    if not all(np.isfinite(losses)) or not fall >= TRAIN_HELD_OUT_FALL or (
            steps_fall and not np.mean(losses[-(-steps // 4):]) < losses[0]):
        fail(f"{label}: the loss did not fall: {losses}, held-out {held_losses}")
    if peak > peak_limit:
        fail(f"{label}: peak device memory {peak / 1e9:.2f} GB, above "
             f"{peak_limit / 1e9:.0f} GB")
    params, opt = run["params"], run["opt_state"]
    del run
    prof_ms, spans = profile_step(step_fn, params, opt, held)
    busy = busy_ms(spans)
    by_family = {name: sum(e - s for n, s, e in spans if fam in n) / 1e6
                 for fam, name in TRAIN_FAMILIES.items()}
    by_family = {name: x for name, x in by_family.items() if x > 0}
    records = len(spans)
    print(f"{label} profiled train step: wall {prof_ms:.2f} ms, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / prof_ms:.4f}, {records} device records; kernel "
          f"device ms: " + ", ".join(f"{f} {x:.2f}" for f, x in by_family.items()))
    print("device time by function over the profiled step:")
    print("\n".join(top_kernels(spans, 10)))
    del params, opt, spans, step_fn
    free_device_memory()
    return {"layers": tcfg.num_layers, "params": n_params, "steps": steps, "batch": batch,
            "seq": seq, "microbatches": tcfg.microbatches, "losses": losses,
            "held_out_losses": held_losses, "held_out_fall": fall, "ms_per_step": times,
            "steady_ms_per_step": steady, "tokens_per_s": tokens / steady * 1e3,
            "bound_ms_6NT": bound_ms, "bound_share": bound_ms / steady, "launches": counts,
            "peak_bytes": peak, "profiled_step": {
                "wall_ms": prof_ms, "busy_ms": busy, "idle_share": 1 - busy / prof_ms,
                "records": records, "kernel_device_ms": by_family}}


def train_phase(dev, card) -> tuple[dict, dict]:
    """Phase 7 (a-e): K3's backward, the train step at full width, the
    trainer and its resume.  Returns (the training results, K3's backward
    entry of the kernels line)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.launch.train import make_trainer

    def views(gen, b, h, t, hd, dtype):
        """(B, H, T, hd) views of (B, T, H, hd) tensors, as the model passes."""
        return torch.randn((b, t, h, hd), generator=gen, device=dev).to(dtype).transpose(1, 2)

    def plain(q, k, v, do, **mask):
        leaves = [x.float().detach().requires_grad_(True) for x in (q, k, v)]
        return torch.autograd.grad(mha_ref(*leaves, **mask), leaves, do.float())

    # -- 7a. K3's backward against the plain autograd ----------------------
    stamp("7a")
    torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(7)
    shapes, worst, errs, head_inputs = {}, 0.0, 0.0, None
    for name, (b, hq, hkv, tq, tk, hd, causal, window) in BWD_SHAPES.items():
        shapes[name] = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (views(gen, b, h, t, hd, dtype)
                           for h, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq)))
            mask = dict(causal=causal, window=window)
            got = k3.flash_attention_backward(q, k, v, do, **mask)
            want = plain(q, k, v, do, **mask)
            share = {g: bwd_limit_share(x, w, dtype) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
            err = max(max_err(x, w) for x, w in zip(got, want))
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            print(f"K3 backward {name} {tag} q {tuple(q.shape)} kv {tuple(k.shape)} "
                  f"causal={causal} window={window}: max_abs_err {err:.3e}, limit share "
                  + ", ".join(f"{g} {x:.4f}" for g, x in share.items()))
            shapes[name][tag] = {"max_abs_err": err, "limit_share": share}
            worst = max(worst, *share.values())
            if dtype == torch.bfloat16:
                errs = max(errs, err)
            if name == BWD_HEADLINE:
                if dtype == torch.float32:
                    # the planted faults: dK and dV from one head of each
                    # group, and the causal mask dropped in dQ
                    grp = hq // hkv
                    leaves = [x.detach().requires_grad_(True) for x in
                              (q, k.repeat_interleave(grp, 1), v.repeat_interleave(grp, 1))]
                    gk = torch.autograd.grad(mha_ref(*leaves, **mask), leaves[1], do)[0]
                    faults = {"dK from one head of the group":
                              bwd_limit_share(got[1], gk[:, ::grp], dtype),
                              "mask dropped in dQ":
                              bwd_limit_share(got[0], plain(q, k, v, do, causal=False)[0], dtype)}
                    print("K3 backward planted faults (share of the f32 limit, must exceed 1): "
                          + ", ".join(f"{f} {x:.1f}" for f, x in faults.items()))
                    if min(faults.values()) <= 1.0:
                        fail(f"a planted fault in K3's backward stays within the limit: {faults}")
                    shapes[name]["planted_faults"] = faults
                else:
                    head_inputs = (q, k, v, do, mask)
            del got, want
    torch.cuda.synchronize()
    if worst > 1.0:
        fail(f"K3's backward disagrees with the plain autograd: {worst:.3f} of its limit")
    q, k, v, do, mask = head_inputs
    a = k3.flash_attention_backward(q, k, v, do, **mask)
    again = k3.flash_attention_backward(q, k, v, do, **mask)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(a, again)):
        fail("K3's backward gave other bits when repeated")
    print(f"K3 backward {BWD_HEADLINE} bf16 repeated: identical bits")
    del a, again
    # times at every shape in bf16: the kernel, the plain autograd's
    # backward alone, SDPA's forward + backward less its forward
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    for name, (b, hq, hkv, tq, tk, hd, causal, window) in BWD_SHAPES.items():
        q, k, v, do = (views(gen, b, h, t, hd, torch.bfloat16)
                       for h, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq)))
        mask = dict(causal=causal, window=window)
        stats = k3.forward_with_stats(q, k, v, **mask)[1:]   # the forward's, under grad
        ms = time_ms(lambda: k3.flash_attention_backward(q, k, v, do, stats=stats, **mask), 5)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = mha_ref(*leaves, **mask)
        plain_ms = time_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True), 3)
        del out
        lib_ms = None
        if window == 0:      # SDPA's causal mask is K3's where no window binds
            def fwd():
                return sdpa(*leaves, is_causal=causal, enable_gqa=hq != hkv)

            def fwd_bwd():
                torch.autograd.grad(fwd(), leaves, do)
            with torch.no_grad():
                f_ms = time_ms(fwd, 5)
            lib_ms = time_ms(fwd_bwd, 5) - f_ms
        bnd = bwd_bound(b, hq, hkv, tq, tk, hd, causal, window, 2)
        shapes[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            bound_ms=bnd[0], bound_by=bnd[1])
        before = (f"; the previous SIMT design {BWD_BEFORE_MS:.4f} ms, "
                  f"{BWD_BEFORE_MS / ms:.2f}x this" if name == BWD_HEADLINE else "")
        print(f"K3 backward {name} bf16: {ms:.4f} ms (plain autograd {plain_ms:.4f} ms, "
              f"SDPA backward {'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}; bound "
              f"{bnd[0]:.4f} ms by {bnd[1]}, {bnd[0] / ms:.1%} of it{before}) [{card}]")
        del q, k, v, do, leaves, stats
    free_device_memory()

    # -- 7b, 7c. one train step: the kernel path against the plain path ----
    cfg = get_config(QWEN)
    batch = step_batch(dev, cfg, TRAIN_BATCH, TRAIN_SEQ)
    stamp("7b")
    results = {"backward_shapes": shapes}
    results["step_bf16"] = step_check(
        dev, f"{QWEN} bf16 train step, full width", cfg, batch,
        loss_limit=LOSS_LIMITS["bfloat16"], leaf_limit=GRAD_LIMITS["bfloat16"])

    stamp("7c")
    real_bwd = k3.flash_attention_backward

    def one_head(q, k, v, dout, **mask):
        grp = q.shape[1] // k.shape[1]
        dq = real_bwd(q, k, v, dout, **mask)[0]
        _, dk, dv = real_bwd(q[:, ::grp], k, v, dout[:, ::grp], **mask)
        return dq, dk, dv

    def no_mask(q, k, v, dout, **mask):
        return real_bwd(q, k, v, dout, causal=False)

    f32cfg = dataclasses.replace(cfg, dtype="float32", num_layers=TRAIN_F32_LAYERS)
    print(f"{QWEN} f32 train step: cut to {TRAIN_F32_LAYERS} of {cfg.num_layers} layers "
          f"at full width")
    results["step_f32"] = step_check(
        dev, f"{QWEN} f32 train step, {TRAIN_F32_LAYERS} layers", f32cfg, batch,
        loss_limit=LOSS_LIMITS["float32"], leaf_limit=GRAD_LIMITS["float32"],
        faults={"dK and dV from one head of each group": (
                    k3, "flash_attention_backward", one_head),
                "causal mask dropped in the backward": (
                    k3, "flash_attention_backward", no_mask)})
    del batch

    # -- 7d. the trainer at full width --------------------------------------
    stamp("7d")
    trainer = make_trainer(QWEN, steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           seed=0, device="cuda", log_fn=print)
    results["trainer"] = train_run(dev, card, f"{QWEN} trainer", trainer, cfg,
                                   batch=TRAIN_BATCH, seq=TRAIN_SEQ)
    del trainer
    launched = results["trainer"]["launches"]["flash_attention_backward"]

    # -- 7e. resume, bit for bit, with the port's own settings ---------------
    stamp("7e")
    results["resume"] = resume_check()
    free_device_memory()

    head = shapes[BWD_HEADLINE]
    kernel = {
        "name": "flash_attention_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
        "path": f"Trainer.run ({QWEN}, {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ})",
        "launches": launched, "max_abs_err": errs, "limit_share": worst,
        "shape": BWD_HEADLINE, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shapes": shapes}
    return results, kernel


# -- 7f-7i. the recurrent families' gradients and their training -----------
# K5's backward at recurrentgemma-9b's width, B 1: (T, W) at one step, either
# side of its 32-step stage, a width off 4 (the 4-byte copies) and the
# training length; decays a in (lo, hi): near 0, mid, near 1; from h0 and
# from zero.  Limit: 0 unequal elements (each step rounds its product and
# its sum once, as autograd of the plain loop does)
RGLRU_BWD_SHAPES = [(1, 4096), (31, 4096), (33, 4096), (65, 4097), (1024, 4096)]
RGLRU_BWD_DECAYS = {"near 0": (1e-6, 1e-3), "mid": (0.0, 1.0), "near 1": (0.999, 1.0)}
RGLRU_BWD_HEADLINE = (1024, 4096)
# K4's backward at rwkv6-3b's 40 heads of 64, B 1, bf16 r, k, v: T 1, either
# side of two of its 8-step sub-chunks, of its 64-step time chunk
# (BWD_CHUNK) and of the forward's 128-step chunk, and the training length;
# w = exp(-exp(d + noise)) at d -8 (near 1), 0 and 4 (near 1e-24); from s0
# and from zero, with a final-state gradient.  The plain autograd through
# wkv6_ref at T 1024 takes about a second, so the decays and s0's absence
# are crossed at the short lengths and T 1024 runs once.
WKV_BWD_T = [1, 15, 17, 63, 65, 127, 129]
WKV_BWD_DECAYS = {"near 1": -8.0, "mid": 0.0, "near 0": 4.0}
WKV_BWD_HEADLINE_T = 1024
# Per element, |got - ref| <= WKV_BWD_REL * max |ref| of each gradient, plus
# one bf16 ulp (2^-7 |ref|) for the gradients of the bf16 r, k, v (both round
# once from f32 sums in other orders).  Fixed from the first reading on the
# card (H100 80GB HBM3, 700 W): at 1e-5 the worst case read 0.994 of it
# (T 127, w near 1), the planted faults 27,778x and 71,968x; the limit sits
# 3x above the reading (tests/test_torch_train.py uses the same limit).
WKV_BWD_REL = 3e-5
# K4's backward kernels, in launch order (the first two only past one chunk)
WKV_BWD_KERNELS = ("wkv6_bwd_local_kernel", "wkv6_bwd_carry_kernel", "wkv6_bwd_kernel",
                   "wkv6_bwd_finish_kernel")
# 7g: one train step of each at full width, kernel path against plain path,
# at a cut depth and batch (the plain WKV loop's autograd is seconds a layer
# at T 1024): bf16 at ARCH_STEP_DEPTH layers, f32 at ARCH_F32_LAYERS layers
# with two planted faults in the backward kernel
ARCH_STEP_BATCH, ARCH_STEP_SEQ = 2, 512
ARCH_STEP_DEPTH = {RWKV: 8, GRIFFIN: 9}
ARCH_F32_LAYERS = {RWKV: 2, GRIFFIN: 3}
# Limits, fixed from the first reading on the card (H100 80GB HBM3, 700 W;
# PERF.md §6): the worst leaf's gradient gap (share of the leaf's
# max) and the loss gap.  rwkv6-3b in f32: the model rounds r, k, v to bf16
# even in f32, so their gradients round to bf16 too, from f32 sums that K4
# and the plain loop take in other orders: one bf16 ulp here and there,
# worst leaf 9.6e-4 (w_k), loss 9.5e-7 (the faults 0.18 and 1.09).
# rwkv6-3b in bf16: random weights turn those ulps into large per-leaf gaps
# (worst 0.98 at a layer's u, median 0.18 over 8 layers, as its serving
# logits moved 0.43 in serving), so the bf16 step is held by its loss gap (5.4e-4)
# and the whole gradient's gap in the L2 norm (0.26; limit 0.5), the
# per-leaf gaps printed.  recurrentgemma-9b, as qwen2-0.5b in 7b-7c: bf16
# worst leaf 0.014, loss 1.6e-4; f32 worst leaf 1.0e-6, loss 3.8e-6 (the
# faults 0.041 and 1.00).
ARCH_STEP_LIMITS = {(RWKV, "bfloat16"): dict(loss_limit=2e-3, l2_limit=0.5),
                    (RWKV, "float32"): dict(loss_limit=1e-5, leaf_limit=3e-3),
                    (GRIFFIN, "bfloat16"): dict(loss_limit=1e-3, leaf_limit=0.05),
                    (GRIFFIN, "float32"): dict(loss_limit=1e-5, leaf_limit=1e-4)}
# 7h: the trainer at full width, each config's own microbatches.  The
# trainer's step is donated (as the reference's jitted step): params (2 B a
# param), f32 master, m and v (12 B) and the f32 accumulated gradient (4 B),
# with the last microbatch's bf16 gradient (2 B) beside them, 20 B a param
# at the peak.  With the functional step the old and the new state stood
# side by side, 32 B a param: rwkv6-3b whole (3.09e9 params, 99 GB) ran out
# of the 80 GB card in its first update (H100 80GB HBM3) and ran cut to 8
# of 32 layers.  Donated it needs about 62 GB, so it runs whole;
# ARCH_TRAIN_PEAK is its gate.  recurrentgemma-9b whole is 8.58e9 params,
# 172 GB at 20 B: it stays at 4 of 38 layers (1.84e9).
ARCH_TRAIN = {RWKV: dict(layers=None, batch=8, steps=10),
              GRIFFIN: dict(layers=4, batch=4, steps=10)}
ARCH_TRAIN_PEAK = {RWKV: 72e9}
ARCH_TRAIN_SEQ = 1024
# K4's backward device ms in one profiled rwkv6-3b step of 7h with its
# first design, one block per 32 rows of a head walking all of time, when
# 7h ran 16 layers (PERF.md §5-§6; H100 80GB HBM3, 700 W)
K4_BWD_MS_A_STEP_FIRST, K4_BWD_FIRST_LAYERS = 98.65, 16
# 7i: F1's own command on the reduced configs
CLI_STEPS = 20


def rglru_bwd_fault(a, h, dh, h0, kind):
    """K5's backward with a planted fault, in plain PyTorch: the decay of the
    step itself (a_t) in place of the next one's, or h_t in place of h_{t-1}."""
    t = a.shape[1]
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = None
    for i in range(t - 1, -1, -1):
        nxt = a[:, i] if kind == "a_t for a_{t+1}" else (a[:, i + 1] if i + 1 < t else None)
        g = dh[:, i] if g is None else dh[:, i] + nxt * g
        db[:, i] = g
        prev = h[:, i] if kind == "h_t for h_{t-1}" else (
            h[:, i - 1] if i > 0 else (h0 if h0 is not None else torch.zeros_like(g)))
        da[:, i] = g * prev
    return da, db


def wkv_limit_share(got, want) -> float:
    """The largest |got - want| over its limit (see WKV_BWD_REL)."""
    worst = 0.0
    for g, x in zip(got, want):
        if not bool(g.isfinite().all()):
            fail("non-finite values in K4's backward")
        x32 = x.float()
        lim = WKV_BWD_REL * max(float(x32.abs().max()), 1e-30) + \
            (2 ** -7 * x32.abs() if x.dtype == torch.bfloat16 else 0.0)
        worst = max(worst, float(((g.float() - x32).abs() / lim).max()))
    return worst


def recurrent_backward_phase(dev, card) -> dict:
    """Phase 7f: K5's and K4's backward kernels against their plain versions
    (``rglru_scan_bwd_ref`` / ``wkv6_bwd_ref``) and the CUDA autograd of
    ``rglru_scan_ref`` / ``wkv6_ref``; planted faults; repeats; times beside
    the bounds.  Returns each kernel's measured entry for the kernels line
    (launches come from 7h)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rglru.ref import rglru_scan_bwd_ref, rglru_scan_ref
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.kernels.rwkv6.ref import wkv6_bwd_ref, wkv6_ref

    stamp("7f")
    gen = torch.Generator(device=dev).manual_seed(11)

    def k5_inputs(t, w, lo, hi, with_h0):
        a = lo + (hi - lo) * torch.rand((1, t, w), generator=gen, device=dev)
        bx, dh = (torch.randn((1, t, w), generator=gen, device=dev) for _ in range(2))
        h0 = torch.randn((1, w), generator=gen, device=dev) if with_h0 else None
        with torch.no_grad():
            h = k5.rglru_scan_cuda(a, bx, chunk=t, h0=h0)
        return a, bx, dh, h0, h

    def k5_autograd(a, bx, dh, h0):
        leaves = [x.clone().requires_grad_(True) for x in (a, bx)] + \
            ([h0.clone().requires_grad_(True)] if h0 is not None else [])
        out = rglru_scan_ref(leaves[0], leaves[1], leaves[2] if h0 is not None else None)
        return torch.autograd.grad(out, leaves, dh)

    # -- K5 -----------------------------------------------------------------
    k5_res, k5_unequal, k5_cases = {}, 0, 0
    for t, w in RGLRU_BWD_SHAPES:
        for dname, (lo, hi) in RGLRU_BWD_DECAYS.items():
            for with_h0 in (False, True):
                a, bx, dh, h0, h = k5_inputs(t, w, lo, hi, with_h0)
                got = k5.rglru_scan_backward(a, h, dh, h0)
                want = rglru_scan_bwd_ref(a, h, dh, h0)
                auto = k5_autograd(a, bx, dh, h0)
                n = sum(int((x != y).sum()) for x, y in zip(got, want) if x is not None) + \
                    sum(int((x != y).sum()) for x, y in zip(got, auto))
                k5_unequal += n
                k5_cases += 1
                k5_res[f"T {t} W {w} a {dname}{' h0' if with_h0 else ''}"] = n
    torch.cuda.synchronize()
    print(f"rglru backward (K5) against rglru_scan_bwd_ref and the CUDA autograd of "
          f"rglru_scan_ref at (T, W) {RGLRU_BWD_SHAPES}, a near 0 / mid / near 1, from h0 "
          f"and from zero ({k5_cases} cases): {k5_unequal} unequal elements (limit 0)")
    if k5_unequal:
        fail(f"K5's backward differs from its plain versions: "
             f"{ {k: n for k, n in k5_res.items() if n} }")
    t, w = RGLRU_BWD_HEADLINE
    a, bx, dh, h0, h = k5_inputs(t, w, 0.0, 1.0, True)
    got = k5.rglru_scan_backward(a, h, dh, h0)
    faults = {}
    for kind in ("a_t for a_{t+1}", "h_t for h_{t-1}"):
        fda, fdb = rglru_bwd_fault(a, h, dh, h0, kind)
        faults[kind] = int((got[0] != fda).sum()) + int((got[1] != fdb).sum())
    print("rglru backward planted faults (unequal elements, must exceed the limit 0): "
          + ", ".join(f"{k} {n}" for k, n in faults.items()))
    if min(faults.values()) == 0:
        fail(f"a planted fault in K5's backward stays within its limit: {faults}")
    again = k5.rglru_scan_backward(a, h, dh, h0)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        fail("K5's backward gave other bits when repeated")
    print("rglru backward repeated: identical bits")
    ms = device_ms(lambda: k5.rglru_scan_backward(a, h, dh, h0))
    plain_ms = time_ms(lambda: rglru_scan_bwd_ref(a, h, dh, h0), 3)
    leaves = [x.clone().requires_grad_(True) for x in (a, bx, h0)]
    out = rglru_scan_ref(*leaves)
    auto_ms = time_ms(lambda: torch.autograd.grad(out, leaves, dh, retain_graph=True), 3)
    del out, leaves
    bnd = bound(20 * t * w + 8 * w, k5.BWD_FLOPS * t * w, F32_FLOPS_PER_S)
    print(f"rglru backward (1, {t}, {w}): {ms:.4f} ms, bound {bnd[0]:.6f} ms by {bnd[1]} "
          f"({bnd[0] / ms:.2%} of bound), plain rglru_scan_bwd_ref {plain_ms:.4f} ms, plain "
          f"autograd {auto_ms:.4f} ms, library: none (no PyTorch call computes the reverse "
          f"scan) [{card}]")
    k5_entry = {
        "name": "rglru_scan_backward", "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_bwd.cu",
        "replaces": "src/repro/kernels/rglru/kernel.py:23",
        "max_abs_err": 0.0, "unequal_elements": k5_unequal, "planted_faults": faults,
        "shape": [1, t, w], "ms": ms, "plain_ms": plain_ms, "plain_autograd_ms": auto_ms,
        "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}
    del a, bx, dh, h0, h, got, again
    free_device_memory()

    # -- K4 -----------------------------------------------------------------
    rcfg = get_config(RWKV)
    nh, hd = rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim

    def k4_inputs(t, decay, with_s0):
        def f(*shape, scale=1.0):
            return torch.randn(shape, generator=gen, device=dev) * scale
        r, k, v = (f(1, t, nh, hd, scale=sc).to(torch.bfloat16) for sc in (1.0, 0.3, 0.3))
        w = torch.exp(-torch.exp(decay + f(1, t, nh, hd, scale=0.5)))
        s0 = f(1, nh, hd, hd, scale=0.3) if with_s0 else None
        return r, k, v, w, f(nh, hd, scale=0.3), s0, f(1, t, nh, hd), f(1, nh, hd, hd)

    def k4_autograd(r, k, v, w, u, s0, do, dst):
        leaves = [x.detach().requires_grad_(True) for x in (r, k, v, w, u)] + \
            ([s0.detach().requires_grad_(True)] if s0 is not None else [])
        o, st = wkv6_ref(*leaves[:5], s0=leaves[5] if s0 is not None else None)
        return torch.autograd.grad((o, st), leaves, (do, dst))

    k4_res, k4_worst, k4_err = {}, 0.0, 0.0
    cases = [(t, d, s) for t in WKV_BWD_T for d in WKV_BWD_DECAYS for s in (False, True)]
    cases.append((WKV_BWD_HEADLINE_T, "mid", True))
    for t, dname, with_s0 in cases:
        x = k4_inputs(t, WKV_BWD_DECAYS[dname], with_s0)
        got = k4.wkv6_backward(*x)
        auto = k4_autograd(*x)
        ref = wkv6_bwd_ref(*x)
        n = len(auto)
        share = max(wkv_limit_share(got[:n], auto), wkv_limit_share(got[:n], ref[:n]))
        err = max(float((g.float() - y.float()).abs().max()) for g, y in zip(got, auto))
        k4_res[f"T {t} w {dname}{' s0' if with_s0 else ''}"] = {"limit_share": share,
                                                               "max_abs_err": err}
        k4_worst, k4_err = max(k4_worst, share), max(k4_err, err)
        del x, got, auto, ref
    torch.cuda.synchronize()
    print(f"wkv6 backward (K4) against the CUDA autograd of wkv6_ref and wkv6_bwd_ref at "
          f"(1, T, {nh}, {hd}), bf16 r, k, v, T {WKV_BWD_T} x w near 1 / mid / near 0 x "
          f"s0 given or not, and T {WKV_BWD_HEADLINE_T}: worst share of the limit "
          f"{k4_worst:.4f} (limit {WKV_BWD_REL} of max |ref| + one bf16 ulp), max_abs_err "
          f"{k4_err:.3e}; by case: " + ", ".join(
              f"{c} {v['limit_share']:.3f}" for c, v in k4_res.items()))
    if k4_worst > 1.0:
        fail(f"K4's backward disagrees with its plain versions: {k4_worst:.3f} of its limit")
    x = k4_inputs(WKV_BWD_HEADLINE_T, 0.0, True)
    r, k, v, w, u, s0, do, dst = x
    got = k4.wkv6_backward(*x)
    faults = {"u dropped": wkv_limit_share(got, k4_autograd(r, k, v, w, u * 0, s0, do, dst)),
              "s0 not carried in": wkv_limit_share(
                  got, k4_autograd(r, k, v, w, u, torch.zeros_like(s0), do, dst)),
              "dsT dropped": wkv_limit_share(
                  got, k4_autograd(r, k, v, w, u, s0, do, torch.zeros_like(dst)))}
    print("wkv6 backward planted faults (share of the limit, must exceed 1): "
          + ", ".join(f"{f} {s:.1f}" for f, s in faults.items()))
    if min(faults.values()) <= 1.0:
        fail(f"a planted fault in K4's backward stays within its limit: {faults}")
    again = k4.wkv6_backward(*x)
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for p, q in zip(got, again)):
        fail("K4's backward gave other bits when repeated")
    print("wkv6 backward repeated: identical bits")
    ms = device_ms(lambda: k4.wkv6_backward(*x), 10)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        warm_profiler()
        for _ in range(5):
            torch.cuda._sleep(1_000_000)
            k4.wkv6_backward(*x)
        torch.cuda.synchronize()
    spans = drop_warmup(device_spans(prof))
    per_launch = {}
    for name in WKV_BWD_KERNELS:
        us = [(e - st) / 1e3 for n, st, e in spans if name in n]
        if not us:
            fail(f"the profile of K4's backward has no {name}")
        per_launch[name] = sum(us) / len(us)
    geo = k4.bwd_geometry()
    print(f"wkv6 backward device us a launch at T {WKV_BWD_HEADLINE_T} ({geo['chunk']}-step "
          f"chunks, torch.profiler): " + ", ".join(
              f"{name} {us:.2f}" for name, us in per_launch.items()) + f" [{card}]")
    plain_ms = time_ms(lambda: wkv6_bwd_ref(*x), 1, warmup=1)
    leaves = [y.detach().requires_grad_(True) for y in (r, k, v, w, u, s0)]
    o, st = wkv6_ref(*leaves)
    auto_ms = time_ms(lambda: torch.autograd.grad((o, st), leaves, (do, dst),
                                                  retain_graph=True), 1, warmup=1)
    del o, st, leaves
    t = WKV_BWD_HEADLINE_T
    elems = t * nh * hd
    nbytes = elems * (3 * 2 + 4 + 4 + 3 * 2 + 4) + 3 * nh * hd * hd * 4 + 2 * nh * hd * 4
    bnd = bound(nbytes, k4.BWD_FLOPS * elems * hd, F32_FLOPS_PER_S)
    print(f"wkv6 backward (1, {t}, {nh}, {hd}) bf16: {ms:.4f} ms, bound {bnd[0]:.6f} ms by "
          f"{bnd[1]} ({bnd[0] / ms:.2%} of bound; 14 flops a (t, h, i, j), {nbytes} B), "
          f"plain wkv6_bwd_ref {plain_ms:.4f} ms, plain autograd {auto_ms:.4f} ms, "
          f"library: none (no PyTorch call computes the WKV recurrence) [{card}]")
    k4_entry = {
        "name": "wkv6_backward", "route": "cuda", "source": "src/repro_torch/csrc/wkv6_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6/kernel.py:27", "max_abs_err": k4_err,
        "limit_share": k4_worst, "planted_faults": faults, "shape": [1, t, nh, hd],
        "ms": ms, "plain_ms": plain_ms, "plain_autograd_ms": auto_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "library_ms": None, "cases": k4_res, "chunk": geo["chunk"],
        "sub_steps": geo["sub_steps"], "per_launch_us": per_launch}
    del x, got, again
    free_device_memory()
    return {"rglru_scan_backward": k5_entry, "wkv6_backward": k4_entry,
            "k5_cases": k5_res}


def arch_phase(dev, card, commands) -> dict:
    """Phases 7g-7i for rwkv6-3b and recurrentgemma-9b: a full-width train
    step, kernel path against plain path (bf16 at a cut depth; f32 at fewer
    layers with two planted faults in the backward kernel); the trainer at
    full width; ``python -m repro_torch.launch.train --smoke`` on the card,
    started in the background (``commands[arch]``, ``start_command``)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optimizer import AdamWConfig

    results = {}
    for arch in (RWKV, GRIFFIN):
        base = get_config(arch)
        out = results[arch] = {}
        batch = step_batch(dev, base, ARCH_STEP_BATCH, ARCH_STEP_SEQ)

        # -- 7g ----------------------------------------------------------------
        stamp(f"7g {arch}")
        depth = ARCH_STEP_DEPTH[arch]
        print(f"{arch} train step: cut to {depth} of {base.num_layers} layers and "
              f"{ARCH_STEP_BATCH} x {ARCH_STEP_SEQ} tokens, full width")
        out["step_bf16"] = step_check(dev, f"{arch} bf16 train step, {depth} layers",
                                      dataclasses.replace(base, num_layers=depth), batch,
                                      **ARCH_STEP_LIMITS[arch, "bfloat16"])
        if arch == RWKV:
            real = k4.wkv6_backward
            faults = {
                "bonus u dropped in the backward": (k4, "wkv6_backward", lambda r, k, v, w, u, s0, do, dst=None: real(r, k, v, w, u * 0, s0, do, dst)),
                "decay left out of the state's gradient": (k4, "wkv6_backward", lambda r, k, v, w, u, s0, do, dst=None: real(r, k, v, torch.ones_like(w), u, s0, do, dst))}
        else:
            real = k5.rglru_scan_backward
            faults = {
                "gradient not carried back a step": (k5, "rglru_scan_backward", lambda a, h, dh, h0=None: real(a * 0, h, dh, h0)),
                "h_t in place of h_{t-1}": (k5, "rglru_scan_backward", lambda a, h, dh, h0=None: real(a, torch.cat([h[:, 1:], h[:, -1:]], 1).contiguous(), dh, h0))}
        nl = ARCH_F32_LAYERS[arch]
        print(f"{arch} f32 train step: cut to {nl} of {base.num_layers} layers at full width")
        out["step_f32"] = step_check(dev, f"{arch} f32 train step, {nl} layers",
                                     dataclasses.replace(base, dtype="float32", num_layers=nl),
                                     batch, **ARCH_STEP_LIMITS[arch, "float32"], faults=faults)
        del batch

        # -- 7h ----------------------------------------------------------------
        stamp(f"7h {arch}")
        spec = ARCH_TRAIN[arch]
        tcfg = base if spec["layers"] is None else dataclasses.replace(
            base, num_layers=spec["layers"])
        steps, bsz = spec["steps"], spec["batch"]
        warmup = max(steps // 10, 1)
        print(f"{arch} trainer: {tcfg.num_layers} of {base.num_layers} layers at full width"
              + (" (whole)" if spec["layers"] is None else " (a cut: whole, its params, f32 "
                 "master, moments and accumulated gradient do not fit one 80 GB card)")
              + f", {steps} steps of {bsz} x {ARCH_TRAIN_SEQ}, {tcfg.microbatches} "
              f"microbatches, AdamW lr {TRAIN_LR} with {warmup} warmup step")
        free_device_memory()
        model = build_model(tcfg, max_pos=ARCH_TRAIN_SEQ, device=dev)
        trainer = Trainer(model, launch_train._with_extras(make_batch_iterator(
                              tcfg.vocab_size, ARCH_TRAIN_SEQ, bsz, seed=0), tcfg, bsz),
                          LoopConfig(total_steps=steps, checkpoint_every=10 ** 9,
                                     log_every=max(steps // 5, 1)),
                          AdamWConfig(lr=TRAIN_LR, warmup_steps=warmup, total_steps=steps),
                          log_fn=print)
        out["trainer"] = trained = train_run(
            dev, card, f"{arch} trainer", trainer, tcfg, batch=bsz, seq=ARCH_TRAIN_SEQ,
            peak_limit=ARCH_TRAIN_PEAK.get(arch, float("inf")))
        del model, trainer
        if arch == RWKV:
            k4_ms = trained["profiled_step"]["kernel_device_ms"].get("K4 backward", 0.0)
            print(f"{arch} K4 backward device ms a step: {k4_ms:.2f}, "
                  f"{k4_ms / tcfg.num_layers:.3f} a layer (the first design: "
                  f"{K4_BWD_MS_A_STEP_FIRST} at {K4_BWD_FIRST_LAYERS} layers, "
                  f"{K4_BWD_MS_A_STEP_FIRST / K4_BWD_FIRST_LAYERS:.3f} a layer) [{card}]")

        # -- 7i ----------------------------------------------------------------
        stamp(f"7i {arch}")
        cmd, rc, stdout, stderr, secs = finish_command(commands[arch])
        lines = stdout.strip().splitlines()
        print(f"$ {cmd}  (exit {rc}, started {secs:.1f} s before; in the background "
              f"since 5f): " + " | ".join(lines[-2:]))
        if rc or len(lines) < 2 or not lines[-1].startswith("last-10"):
            fail(f"{cmd} failed on the card:\n{stdout[-2000:]}\n{stderr[-4000:]}")
        out["cli"] = {"command": cmd, "lines": lines[-2:]}
    return results


def bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bits as integers of its width (so -0.0 and 0.0 differ)."""
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def donation_check(dev, card) -> dict:
    """Phase 7j: one full-width qwen2-0.5b bf16 train step at phase 7b's
    shape, donated (``make_train_step(donate=True)``, as ``Trainer`` runs
    it) against the functional step from the same state and batch: params,
    f32 master, m, v, step and every metric bit for bit, and the donated
    step's leaves in its arguments' storages."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    stamp("7j")
    cfg = get_config(QWEN)
    model = build_model(cfg, max_pos=TRAIN_SEQ, device=dev)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    batch = {name: torch.as_tensor(x, device=dev) for name, x in next(
        make_batch_iterator(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).items()}
    # the trainers' learning rate at its first step, so every leaf moves
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    copy = _tree.tree_map(torch.clone, params)
    donated_args = (copy, init_opt_state(copy))
    storages = [x.untyped_storage().data_ptr() for x in _tree.leaves(donated_args)]
    out, read = {}, {}
    for name, donate, args in (("functional", False, (params, init_opt_state(params))),
                               ("donated", True, donated_args)):
        step = make_train_step(model, opt_cfg, donate=donate)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out[name] = step(*args, batch)
        torch.cuda.synchronize()
        read[name] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "peak_bytes": torch.cuda.max_memory_allocated() - base}
    (fp, fo, fm), (dp, do, dm) = out["functional"], out["donated"]
    same_storages = [x.untyped_storage().data_ptr() for x in _tree.leaves((dp, do))] == storages
    pairs = list(zip(_tree.flatten_with_path({"params": dp, "opt": do}),
                     _tree.leaves({"params": fp, "opt": fo})))
    unequal = {path: int((bits(a) != bits(b)).sum()) for (path, a), b in pairs}
    n_unequal = sum(unequal.values())
    metrics_equal = sorted(fm) == sorted(dm) and all(
        torch.equal(bits(torch.as_tensor(fm[k], device=dev)),
                    bits(torch.as_tensor(dm[k], device=dev))) for k in fm)
    moved = sum(int((bits(a) != bits(b)).sum()) for a, b in zip(_tree.leaves(dp),
                                                                _tree.leaves(params)))
    n_params = sum(x.numel() for x in _tree.leaves(params))
    print(f"7j: {QWEN} bf16 train step, full width, {TRAIN_BATCH} x {TRAIN_SEQ}: donated "
          f"against functional from the same state: {n_unequal} unequal elements in "
          f"{len(pairs)} params and optimizer tensors, metrics "
          f"{'equal' if metrics_equal else 'DIFFERENT'} (loss {float(dm['loss']):.6f}), "
          f"the donated leaves {'in' if same_storages else 'NOT in'} their arguments' "
          f"storages, {moved} of {n_params} params moved by the step; ms and peak bytes "
          f"beyond the arguments: functional {read['functional']['ms']:.1f} ms "
          f"{read['functional']['peak_bytes']} B, donated {read['donated']['ms']:.1f} ms "
          f"{read['donated']['peak_bytes']} B [{card}]")
    if n_unequal or not metrics_equal or not same_storages or not moved:
        fail(f"7j: the donated step differs from the functional one "
             f"({ {k: v for k, v in unequal.items() if v} }, metrics equal {metrics_equal}, "
             f"storages kept {same_storages}, params moved {moved})")
    del out, fp, fo, dp, do, params, copy, donated_args
    free_device_memory()
    return {"unequal_elements": n_unequal, "tensors": len(pairs),
            "metrics_equal": metrics_equal, "same_storages": same_storages,
            "params_moved": moved, **read}


# -- 7k. the seven configurations no earlier phase trains ------------------
TRAIN_ARCHS = (GEMMA, QWEN15, MINICPM, WHISPER, QWEN3, PHI, VLM)
# (a) one train step at full width, kernel path against plain path (model
# loss_fn and torch.autograd.grad from the same params and batch, as 7g), in
# bf16 at a depth that holds every layer kind of the configuration (None:
# whole): gemma3-1b 6 (five local, one global), llama-vision 5 (four full,
# one cross), whisper-base whole (6 encoder and 6 decoder layers, each with
# self and cross attention), qwen2-1.5b whole; minicpm3-4b (MLA, no K3) and
# the MoE configurations, whose layers are all of one kind, at 8 and 2.  In
# f32 at (depth, pattern): fewer layers where the bf16 step is deep or
# large, and the VLM at one full and one cross layer (its 5 layers in f32
# with two gradient sets need 78 GB).  2 x 512 tokens (whisper 2 x 448, its
# decoder's positions, with its 1536 frames; gemma3-1b 2 x 1024, since its
# 512-token window binds only past 512 tokens; the VLM with its 1600 image
# tokens and its gates at VLM_GATES); the extras come in f32, as
# launch.train makes them (F13)
ARCHS_STEP_BATCH, ARCHS_STEP_SEQ = 2, {WHISPER: WHISPER_CONTEXT, GEMMA: 1024}
ARCHS_STEP_DEPTH = {GEMMA: 6, QWEN15: None, MINICPM: 8, WHISPER: None, QWEN3: 2, PHI: 2,
                    VLM: 5}
ARCHS_F32 = {GEMMA: (6, None), QWEN15: (4, None), MINICPM: (2, None),
             WHISPER: (None, None), QWEN3: (1, None), PHI: (1, None),
             VLM: (2, ("full", "cross"))}
# Limits, written before the first run on the card.  bf16: the plain
# attention rounds its softmax weights to bf16 and K3 does not, so leaves
# differ by a few bf16 ulps (7b: qwen2-0.5b's worst leaf 0.0184, median
# 0.0062); the bf16 step is held by its loss gap and the whole gradient's
# gap in the L2 norm, 0.1 (5x 7b's worst leaf).  The loss limit was 7b's
# 1e-3 until the first run on the card read 1.43e-3 on qwen2-1.5b (28
# layers, |loss| 12.2: 1.2e-4 of it; L2 gap 0.015, its f32 step sound):
# 5e-3.  f32: only the order of f32 sums differs (7c: worst leaf 2.5e-6 at
# 4 layers; 7g: 1.0e-6), so the worst leaf is held to 7c's 1e-4 and the
# loss to 1e-5, the VLM's scalar gates too (their f32 gaps on the card:
# gate_m 1.3e-6, gate_x 2.1e-7; PERF.md §6).  The MoE configurations'
# kernel path takes the plain path's expert choices (RoutingLog(force=...)),
# in both dtypes; the choices that differ unforced are printed.  Two planted
# faults in K3's backward, each on its f32 step, must exceed the f32 limit:
# the window dropped (gemma3-1b's local layers) and causal=True in the cross
# attention (whisper-base)
ARCHS_BF16_L2, ARCHS_BF16_LOSS = 0.1, 5e-3
ARCHS_F32_LEAF, ARCHS_F32_LOSS = 1e-4, 1e-5
# (b) the trainer (Trainer over launch.train's batches: the synthetic corpus,
# whisper's frames and the VLM's image tokens as zeros), donated AdamW, lr
# 3e-3 reached over ARCHS_TRAIN_WARMUP steps, each configuration's own
# microbatches: 6 steps of 8 x 1024 (whisper 8 x 448).  Whole where one
# card holds it at the donated
# step's 20 B a parameter (bf16 params 2, f32 master, m, v 12, f32
# accumulated gradient 4, the last microbatch's bf16 gradient 2); the others
# at the deepest depth whose state fits ARCHS_TRAIN_STATE of the card
# (``trainer_depth``), leaving the rest for activations, the logits and the
# optimizer's per-leaf temporaries; the peak is gated at ARCHS_TRAIN_PEAK.
# llama-vision gets no trainer: its 5 layers are 6.5e9 params, 130 GB.  The
# losses must be finite and the held-out loss must fall (``train_run``).
# On the card (H100 80GB HBM3, 700 W; PERF.md §6), with 1 warmup step
# minicpm3-4b did not train (held-out loss 11.58 -> 11.41, 1.5 %), with 3
# every trainer fell 15-31 %; at lr 3e-3 the step losses swing (qwen2-1.5b
# with period two, on the plain path as on K3, from its tied embedding;
# the MoE cuts peak at 23.47), so 7h's mean of the last three below the
# first, which those swings fail, is not asked here
ARCHS_TRAIN_STEPS, ARCHS_TRAIN_BATCH, ARCHS_TRAIN_WARMUP = 6, 8, 3
ARCHS_TRAIN_SEQ = {WHISPER: WHISPER_CONTEXT}
ARCHS_TRAIN_WHOLE = (GEMMA, QWEN15, WHISPER)
TRAIN_BYTES_PER_PARAM = 20
ARCHS_TRAIN_STATE, ARCHS_TRAIN_PEAK = 60e9, 72e9
# trainers cut below trainer_depth for the run's time: minicpm3-4b's plain
# MLA steps are host-bound (at 44 layers its trainer took 66 s of 7k on a
# slow host, H100 80GB HBM3), and half of them pays for phase 9's meta counts
ARCHS_TRAIN_TIME_DEPTH = {MINICPM: 22}
# (c) launch.train.main for every configuration, reduced, on the card
ARCHS_CLI_STEPS = 20


def param_count(cfg) -> int:
    """``cfg``'s parameters, counted on ``meta`` tensors."""
    from repro_torch.models.model import build_model
    return sum(x.numel() for x in leaves(build_model(cfg, device="cpu").abstract_params()))


def trainer_depth(cfg) -> tuple[int, int, int]:
    """(depth, its params, the next depth's params): the deepest depth of
    ``cfg`` whose donated train state (TRAIN_BYTES_PER_PARAM a parameter)
    fits ARCHS_TRAIN_STATE, whole if it fits; the layers of the cut
    configurations are all of one kind, so any depth holds every kind."""
    one, two = (param_count(dataclasses.replace(cfg, num_layers=n)) for n in (1, 2))
    per, fixed = two - one, 2 * one - two
    depth = max(1, min(cfg.num_layers,
                       int((ARCHS_TRAIN_STATE / TRAIN_BYTES_PER_PARAM - fixed) // per)))
    return depth, fixed + depth * per, fixed + (depth + 1) * per


def archs_train_phase(dev, card) -> dict:
    """Phase 7k: the seven configurations that no earlier phase trains.  (a)
    a full-width train step, kernel path against plain path, in bf16 and in
    f32, with two planted faults in K3's backward; (b) the donated
    ``Trainer`` for six of them; (c) ``launch.train.main`` for all ten
    configurations, reduced, on the card."""
    import io
    import re

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import build_model
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optimizer import AdamWConfig

    t_phase = time.perf_counter()
    real_bwd = k3.flash_attention_backward

    def no_window(q, k, v, dout, *, causal=True, window=0, q_offset=0, stats=None):
        return real_bwd(q, k, v, dout, causal=causal, window=0, q_offset=q_offset,
                        stats=stats)

    def causal_cross(q, k, v, dout, *, causal=True, window=0, q_offset=0, stats=None):
        cross = q.shape[2] != k.shape[2]        # 448 queries over 1536 frames
        return real_bwd(q, k, v, dout, causal=causal or cross, window=window,
                        q_offset=q_offset, stats=stats)

    faults = {GEMMA: {"the window dropped in K3's backward": (
                  k3, "flash_attention_backward", no_window)},
              WHISPER: {"causal=True in the cross attention's backward": (
                  k3, "flash_attention_backward", causal_cross)}}

    results = {"steps": {}, "trainers": {}, "cli": {}}
    # -- 7k (a) ----------------------------------------------------------------
    for arch in TRAIN_ARCHS:
        stamp(f"7k {arch} step")
        base = get_config(arch)
        depth = ARCHS_STEP_DEPTH[arch]
        bcfg = base if depth is None else dataclasses.replace(base, num_layers=depth)
        f32_depth, f32_pattern = ARCHS_F32[arch]
        fcfg = dataclasses.replace(
            base, dtype="float32", num_layers=f32_depth or base.num_layers,
            pattern=f32_pattern or base.pattern)
        seq = ARCHS_STEP_SEQ.get(arch, 512)
        print(f"cut: {arch} train step at {bcfg.num_layers} of {base.num_layers} layers "
              f"(kinds {bcfg.layer_kinds()}) in bf16 and {fcfg.num_layers} (kinds "
              f"{fcfg.layer_kinds()}) in f32, {ARCHS_STEP_BATCH} x {seq} tokens, full width")
        batch = step_batch(dev, base, ARCHS_STEP_BATCH, seq)
        results["steps"][arch] = {
            "bf16": step_check(dev, f"{arch} bf16 train step, {bcfg.num_layers} layers",
                               bcfg, batch, loss_limit=ARCHS_BF16_LOSS,
                               l2_limit=ARCHS_BF16_L2),
            "f32": step_check(dev, f"{arch} f32 train step, {fcfg.num_layers} layers",
                              fcfg, batch, loss_limit=ARCHS_F32_LOSS,
                              leaf_limit=ARCHS_F32_LEAF,
                              faults=faults.get(arch))}
        del batch

    # -- 7k (b) ----------------------------------------------------------------
    vlm = dataclasses.replace(get_config(VLM), num_layers=5)
    n_vlm = param_count(vlm)
    print(f"{VLM}: no trainer: 5 layers, the least that holds its cross layer, are "
          f"{n_vlm} params, {TRAIN_BYTES_PER_PARAM * n_vlm / 1e9:.0f} GB of donated train "
          f"state at {TRAIN_BYTES_PER_PARAM} B a param (one card holds 80 GB); its training "
          f"on the card is (a)'s step alone")
    results["trainers"][VLM] = {"skipped": "5 layers need "
                                f"{TRAIN_BYTES_PER_PARAM * n_vlm / 1e9:.0f} GB of train state"}
    for arch in TRAIN_ARCHS:
        if arch == VLM:
            continue
        stamp(f"7k {arch} trainer")
        base = get_config(arch)
        depth, n_est, n_next = trainer_depth(base)
        if arch in ARCHS_TRAIN_WHOLE and depth != base.num_layers:
            fail(f"{arch}: whole it needs {TRAIN_BYTES_PER_PARAM * n_est / 1e9:.1f} GB of "
                 f"train state, above {ARCHS_TRAIN_STATE / 1e9:.0f} GB")
        budget = (f" (a cut: {n_est} params need {TRAIN_BYTES_PER_PARAM * n_est / 1e9:.1f} GB "
                  f"of donated train state at {TRAIN_BYTES_PER_PARAM} B a param, one more "
                  f"layer {TRAIN_BYTES_PER_PARAM * n_next / 1e9:.1f} GB, above the "
                  f"{ARCHS_TRAIN_STATE / 1e9:.0f} GB budget)")
        if ARCHS_TRAIN_TIME_DEPTH.get(arch, depth) < depth:
            print(f"cut: {arch} trainer at {ARCHS_TRAIN_TIME_DEPTH[arch]} of "
                  f"{base.num_layers} layers, where {depth} fit the "
                  f"{ARCHS_TRAIN_STATE / 1e9:.0f} GB budget: its plain MLA steps are "
                  f"host-bound, and the other layers' time pays for phase 9's meta counts")
            depth, budget = ARCHS_TRAIN_TIME_DEPTH[arch], " (a cut for time, printed above)"
        tcfg = base if depth == base.num_layers else dataclasses.replace(base, num_layers=depth)
        seq = ARCHS_TRAIN_SEQ.get(arch, 1024)
        steps, bsz = ARCHS_TRAIN_STEPS, ARCHS_TRAIN_BATCH
        print(f"{arch} trainer: {tcfg.num_layers} of {base.num_layers} layers at full width"
              + (" (whole)" if depth == base.num_layers else budget)
              + f", {steps} steps of {bsz} x {seq}, {tcfg.microbatches} microbatches, AdamW "
              f"lr {TRAIN_LR} with {ARCHS_TRAIN_WARMUP} warmup steps", flush=True)
        free_device_memory()
        model = build_model(tcfg, max_pos=seq, device=dev)
        trainer = Trainer(model, launch_train._with_extras(
                              make_batch_iterator(tcfg.vocab_size, seq, bsz, seed=0), tcfg, bsz),
                          LoopConfig(total_steps=steps, checkpoint_every=10 ** 9, log_every=1),
                          AdamWConfig(lr=TRAIN_LR, warmup_steps=ARCHS_TRAIN_WARMUP,
                                      total_steps=steps), log_fn=print)
        results["trainers"][arch] = train_run(
            dev, card, f"{arch} trainer", trainer, tcfg, batch=bsz, seq=seq,
            peak_limit=ARCHS_TRAIN_PEAK, steps_fall=False) | {"whole": depth == base.num_layers}
        del model, trainer

    # -- 7k (c) ----------------------------------------------------------------
    stamp("7k launch.train")
    for arch in list_archs():
        args = ["--arch", arch, "--smoke", "--steps", str(ARCHS_CLI_STEPS)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launch_train.main(args)
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        secs = time.perf_counter() - t0
        print(f"launch.train.main({args}) on the card ({secs:.1f} s): " + " | ".join(lines[-2:]))
        ok = len(lines) >= 2 and re.fullmatch(r"first-10 mean loss: \d+\.\d{4}", lines[-2]) \
            and re.fullmatch(r"last-10  mean loss: \d+\.\d{4}", lines[-1])
        if not ok:
            fail(f"launch.train.main({args}) printed {lines[-5:]}")
        results["cli"][arch] = {"lines": lines[-2:], "seconds": secs}
        free_device_memory()
    results["seconds"] = time.perf_counter() - t_phase
    print(f"7k took {results['seconds']:.1f} s")
    return results


# the reduced sizes of the example twins (their reference's own) and phase
# 8's shapes: seq-parallel attention at qwen2-0.5b's heads, 4 shards
SEQ_PAR = {"b": 1, "t": 4096, "hq": 14, "hkv": 2, "hd": 64, "shards": 4,
           "windows": (0, 300)}
DIST_TIMED_STEPS = 3          # timed train steps of each kind in 8b


def _run_twin(name: str, **kw):
    """An example twin's ``main`` in this process: (its printed lines, its
    return value).  The lines are printed here too."""
    import contextlib
    import io
    import runpy

    mod = runpy.run_path(str(ROOT / "examples" / f"torch_{name}.py"), run_name="twin")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = mod["main"](**kw)
    text = buf.getvalue()
    print(text, end="")
    return text, result


def _schedule_lines(text: str) -> list[str]:
    """A twin's printed lines without temporary paths (the schedule)."""
    import re
    return [re.sub(r"/\S*?/([\w.-]+\.trace\.jsonl)", r"<tmp>/\1", line)
            for line in text.splitlines()]


def distribution_phase(dev, card, counts, zero_counts) -> dict:
    """Phase 8: the example twins that touch the device (8a), the sharded
    train step on a (1, 1) mesh of one NCCL rank against the plain step
    (8b), sequence-parallel attention's per-shard K3 pieces (8c) and the
    collectives at one rank (8d)."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives, pipeline
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.models import attention as attn_model

    t_phase = time.perf_counter()
    out: dict = {"twins": {}}

    # -- 8a. the twins that touch the device --------------------------------
    stamp("8a")
    for name in ("trace_stencil", "serve_router", "control_serving"):
        t0 = time.perf_counter()
        cpu_text, _ = _run_twin(name, device="cpu")
        torch.cuda.synchronize()
        zero_counts()
        text, _ = _run_twin(name, device="cuda")
        torch.cuda.synchronize()
        launched = counts()
        same = _schedule_lines(text) == _schedule_lines(cpu_text)
        print(f"twin {name} on the card: launches {launched}; schedule lines equal the "
              f"CPU run's: {same} ({time.perf_counter() - t0:.1f} s with the CPU run)")
        want_k1 = 16 if name == "trace_stencil" else 0       # 80 rows, slabs of 5
        if not same or launched["jacobi_sweep"] != want_k1 or \
                launched["attention_plain_calls"] or \
                (name != "trace_stencil") != (launched["flash_attention"] > 0):
            fail(f"twin {name}: launches {launched}, schedule equal {same}")
        out["twins"][name] = {"launches": launched, "schedule_equal_to_cpu": same}
        free_device_memory()
    _, sl = _run_twin("stencil_locality", ranks=1, device="cuda")
    torch.cuda.synchronize()
    print(f"twin stencil_locality, 1 NCCL rank: the rank's K1 launches {sl['k1_launches']}; "
          f"elements unequal to the whole-lattice K1 {sl['unequal_to_whole_sweep']}; "
          f"bytes handed {sl['bytes']}")
    if sl["unequal_to_whole_sweep"] != [0, 0] or \
            sl["k1_launches"] != [{"contiguous": 1, "scattered": 2}]:
        fail(f"twin stencil_locality on the card: {sl}")
    out["twins"]["stencil_locality"] = sl

    # -- 8b-8d on one NCCL rank ---------------------------------------------
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))
    try:
        stamp("8b")
        out["sharded_train_step"] = _sharded_step(dev, card, counts, zero_counts)
        free_device_memory()
        stamp("8c")
        out["seq_parallel_shards"] = _seq_parallel_shards(dev, card, attn_model, k3,
                                                          counts, zero_counts)
        stamp("8d")
        out["collectives"] = _one_rank_collectives(dev, collectives, pipeline)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8 took {out['seconds']:.1f} s (budget 90 s)")
    return out


def _sharded_step(dev, card, counts, zero_counts) -> dict:
    """One full-width qwen2-0.5b bf16 train step at phase 7b's shape, with
    DTensor parameters on a (1, 1) mesh, donated, against the same step
    without rules, functional: the loss and every leaf bit for bit, K3's
    launches equal."""
    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.distributed.sharding import make_rules, use_rules
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import build_model, param_shardings, place
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state,
                                             opt_state_shardings)
    from repro_torch.train.train_step import make_train_step

    cfg = get_config(QWEN)
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    batch = {name: torch.as_tensor(x, device=dev) for name, x in next(
        make_batch_iterator(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).items()}
    step = make_train_step(model, AdamWConfig())
    donated = make_train_step(model, AdamWConfig(), donate=True)
    mesh = make_debug_mesh(1, 1)
    rules = make_rules(mesh, fsdp=False, shard_heads=False)

    def plain_step():
        return step(params, init_opt_state(params), batch)

    with use_rules(rules):
        p_sh = param_shardings(cfg, params, rules)
        # a copy: the donated step writes it (and the timed steps go on
        # training it)
        params_s = place(_tree.tree_map(torch.clone, params), p_sh, rules)
        opt_s = place(init_opt_state(params_s), opt_state_shardings(p_sh, rules, params), rules)
        batch_s = {k: place(v, rules.sharding("batch", None), rules) for k, v in batch.items()}

    def sharded_step():
        with use_rules(rules):
            return donated(params_s, opt_s, batch_s)

    res = {}
    got = {}
    for name, fn in (("plain", plain_step), ("sharded", sharded_step)):
        torch.cuda.synchronize()
        zero_counts()
        k3.flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        p_new, _, metrics = fn()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launched = counts()
        res[name] = {"first_ms": first_ms, "k3_forward": launched["flash_attention"],
                     "k3_backward": k3.flash_attention_backward.launches,
                     "attention_plain_calls": launched["attention_plain_calls"]}
        leaves = [x.full_tensor() if hasattr(x, "full_tensor") else x
                  for x in _tree.leaves(p_new)]
        loss = metrics["loss"]
        got[name] = (loss.full_tensor() if hasattr(loss, "full_tensor") else loss, leaves)
        del p_new, metrics
    (lp, gp), (ls, gs) = got["plain"], got["sharded"]
    unequal = [int((a != b).sum()) for a, b in zip(gs, gp)]
    paths = [p for p, _ in _tree.flatten_with_path(params)]
    worst = max(range(len(gp)), key=lambda i: float((gs[i].float() - gp[i].float()).abs().max()))
    gap = float((gs[worst].float() - gp[worst].float()).abs().max())
    res.update(loss_plain=float(lp), loss_sharded=float(ls), unequal_leaves=sum(
        u > 0 for u in unequal), unequal_elements=sum(unequal), worst_leaf=paths[worst],
        worst_leaf_gap=gap)
    del got, gp, gs
    free_device_memory()
    for name, fn in (("plain", plain_step), ("sharded", sharded_step)):
        times = []
        for _ in range(DIST_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[name]["ms_per_step"] = times
        res[name]["mean_ms"] = float(np.mean(times))
        free_device_memory()
    print(f"{QWEN} bf16 train step, full width, {TRAIN_BATCH} x {TRAIN_SEQ}, DTensor "
          f"parameters on a (1, 1) mesh of 1 NCCL rank against the same step without "
          f"rules: loss {res['loss_sharded']:.6f} vs {res['loss_plain']:.6f}; "
          f"donated, against functional: "
          f"{res['unequal_leaves']} leaves ({res['unequal_elements']} elements) unequal, "
          f"worst {res['worst_leaf']} {gap:.3e}; K3 launches sharded "
          f"{res['sharded']['k3_forward']}/{res['sharded']['k3_backward']}, plain "
          f"{res['plain']['k3_forward']}/{res['plain']['k3_backward']} (forward/backward); "
          f"ms a step (synchronised host clock, mean of {DIST_TIMED_STEPS}): sharded "
          f"{res['sharded']['mean_ms']:.1f}, plain {res['plain']['mean_ms']:.1f} [{card}]")
    k3_equal = all(res["sharded"][k] == res["plain"][k] for k in ("k3_forward", "k3_backward"))
    if not k3_equal or res["sharded"]["k3_forward"] == 0 or \
            res["sharded"]["attention_plain_calls"]:
        fail(f"sharded train step: K3 launches {res['sharded']} vs plain {res['plain']}")
    if res["unequal_elements"]:
        # not bit for bit: hold the step to the reference check's limits
        print(f"sharded train step not bit for bit: {res['unequal_leaves']} leaves differ; "
              f"held to the reference check's limits (loss rtol 2e-5, leaves atol 2e-4)")
        if abs(res["loss_sharded"] - res["loss_plain"]) > 2e-5 * abs(res["loss_plain"]) \
                or gap > 2e-4:
            fail(f"sharded train step off the plain step: {res}")
    if not np.isfinite(res["loss_sharded"]):
        fail(f"sharded train step: loss {res['loss_sharded']}")
    return res


def _seq_parallel_shards(dev, card, attn_model, k3, counts, zero_counts) -> dict:
    """The per-shard piece of ``seq_parallel_attention`` at qwen2-0.5b's
    heads: T cut into shards, one K3 launch each at ``q_offset`` = the
    shard's start, joined and held against the plain ``chunked_attention``
    (window 0) or ``banded_attention`` on f32 copies of the same bf16
    values, per element within K3's bf16 limit; a wrong offset must break
    the limit.  Times the shards' launches beside one whole-T launch."""
    sp = SEQ_PAR
    b, t, n = sp["b"], sp["t"], sp["shards"]
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((b, t, h, sp["hd"]), generator=gen, device=dev).to(torch.bfloat16)
               for h in (sp["hq"], sp["hkv"], sp["hkv"]))
    tl = t // n
    res = {}
    tol = K3_BF16_TOL
    for window in sp["windows"]:
        def shards(offsets=None):
            offs = offsets or [i * tl for i in range(n)]
            return torch.cat([attn_model.seq_shard_attention(q[:, i * tl:(i + 1) * tl], k, v,
                                                             offs[i], window)
                              for i in range(n)], dim=1)
        zero_counts()
        got = shards()
        torch.cuda.synchronize()
        launched = counts()
        qf, kf, vf = q.float(), k.float(), v.float()
        ref = attn_model.banded_attention(qf, kf, vf, 0, window) if window else \
            attn_model.chunked_attention(qf, kf, vf, 0)
        share = float(((got.float() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max())
        # planted fault: shard 1 at q_offset 0 instead of its start
        bad = shards([0, 0] + [i * tl for i in range(2, n)])
        fault = float(((bad.float() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())).max())
        shard_ms = time_ms(shards, 10)
        whole_ms = time_ms(lambda: attn_model._kernel_attention(q, k, v, causal=True,
                                                                q_offset=0, window=window), 10)
        print(f"seq-parallel K3 pieces, window {window}: {n} shards of {tl} at q_offset "
              f"{[i * tl for i in range(n)]}, K3 launches {launched['flash_attention']}; "
              f"worst element {share:.3f} of the bf16 limit (shard 1 at q_offset 0: "
              f"{fault:.1f}x); "
              f"{shard_ms:.4f} ms for the {n} launches, one whole-T launch {whole_ms:.4f} ms "
              f"[{card}]")
        if launched["flash_attention"] != n or launched["attention_plain_calls"] or \
                share > 1.0 or fault <= 1.0:
            fail(f"seq-parallel shards, window {window}: launches {launched}, share "
                 f"{share}, planted fault {fault}")
        res[str(window)] = {"launches": launched["flash_attention"], "limit_share": share,
                            "planted_fault_share": fault, "shards_ms": shard_ms,
                            "whole_ms": whole_ms}
    return res


def _one_rank_collectives(dev, collectives, pipeline) -> dict:
    """The collectives at one NCCL rank: each against numpy or the plain
    computation."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 4)).astype(np.float32)
    xt = torch.from_numpy(x).to(dev)
    res = {}
    r, _ = collectives.compressed_psum(xt, compression="none")
    res["none"] = bool(np.array_equal(r.cpu().numpy(), x))
    r, _ = collectives.compressed_psum(xt, compression="bf16")
    res["bf16"] = bool(np.array_equal(r.cpu().numpy(),
                                      xt.to(torch.bfloat16).float().cpu().numpy()))
    r, err = collectives.compressed_psum(xt, compression="int8")
    scale = np.float32(max(np.abs(x).max(), np.float32(1e-12))) / np.float32(127.0)
    qn = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    want_err = (x.astype(np.float64) - qn.astype(np.float64) * np.float64(scale)).astype(np.float32)
    res["int8"] = bool(np.array_equal(r.cpu().numpy(), qn.astype(np.float32) * scale)
                       and np.array_equal(err.cpu().numpy(), want_err))
    logits = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((2, 16, 4)).astype(np.float32)).to(dev)
    m = logits.amax(-1)
    e = torch.exp(logits - m[..., None])
    got = collectives.lse_combine(torch.einsum("bs,bsd->bd", e, vals), m, e.sum(-1))
    want = torch.einsum("bs,bsd->bd", torch.softmax(logits, -1), vals)
    res["lse_combine"] = float((got - want).abs().max()) <= 1e-5
    w = torch.from_numpy((rng.standard_normal((1, 16, 16)) * 0.2).astype(np.float32)).to(dev)
    xm = torch.from_numpy(rng.standard_normal((8, 4, 16)).astype(np.float32)).to(dev)
    piped = pipeline.pipelined_apply(lambda wi, xi: torch.tanh(xi @ wi[0]), w, xm)
    res["pipelined_apply"] = float((piped - torch.tanh(xm @ w[0])).abs().max()) <= 1e-5
    up, down = collectives.ring_halo_exchange(xt)
    res["ring_halo_exchange"] = bool((up == 0).all() and (down == 0).all())
    print(f"collectives at 1 NCCL rank, each against numpy or the plain computation: {res}")
    if not all(res.values()):
        fail(f"collectives at one rank: {res}")
    return res


T_START = time.perf_counter()


# phase 9: the dry run's cells on the card's host (2 of the 40 single-pod
# cells), 9b's memory gate (counted peak of the plain step against the
# card's: 1.0000-1.0001 in two runs, the margin the allocator's rounding
# and workspaces), the kernel step's counted FLOPs against the plain
# step's (K3 counts the visible pairs only; far below, the count missed
# ops)
DRYRUN_CELLS = ("qwen2-0.5b", "train_4k,decode_32k")
MEMORY_RATIO = (0.98, 1.02)
KERNEL_FLOPS_RATIO = (0.85, 1.0)
# 9b-9c: the kernel step counted on meta tensors (F14: the dry run's path)
# against the same step counted as it runs on the card: the kernel records
# equal, record for record; the totals' FLOPs to META_FLOPS_RTOL and bytes
# to META_BYTES_RTOL; its counted peak within MEMORY_RATIO of the card's
META_FLOPS_RTOL, META_BYTES_RTOL = 1e-9, 0.01
# 9c: every kernel's wrapper reports its launches (op_cost.kernel_launch).
# The paper's runtime sweep: 240 slab launches of K1, each reading its 10
# rows and its halo planes (2878 planes in all) and writing its rows (2400),
# 600 x 600 f32 a plane; the whole-lattice K1 and K2 read and write the
# lattice once.  The cut recurrent train steps (phase 7h's batch and
# length, full width): the plain step's count on meta tensors runs the
# plain loops' every step and takes 10-14 s a microbatch and rwkv layer
# on the host, so it runs two microbatches and counts the second for the
# rest (as the dry run does, exact), at these depths, in a process of its
# own that runs from 5f on, beside the card's phases (the host has the cores)
K1_SWEEP_BYTES = (2878 + 2400) * 600 * 600 * 4
LATTICE_BYTES = 2 * 2400 * 600 * 600 * 4
COUNT_DEPTH = {RWKV: 1, GRIFFIN: 3}
PLAIN_COUNT_TIMEOUT_S = 240


def start_dryrun() -> dict:
    """Start phase 9's two processes of their own in the background: 9a's
    dry run (``python -m repro_torch.launch.dryrun``) and 9c's count of the
    plain train steps on meta tensors (``count_plain_steps``).  Both run on
    the host while earlier phases run; ``dryrun_phase`` collects them."""
    arch, shapes = DRYRUN_CELLS
    tmp = pathlib.Path(tempfile.mkdtemp())
    plain_counts = tmp / "plain_counts.json"
    counting = multiprocessing.get_context("spawn").Process(
        target=count_plain_steps, args=(str(plain_counts),), daemon=True)
    counting.start()
    table = tmp / "torch_dryrun.json"
    dryrun = start_command(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
                            shapes, "--mesh", "single", "--out", str(table), "--force"])
    return {"counting": counting, "plain_counts": plain_counts, "dryrun": dryrun,
            "table": table}


def dryrun_phase(dev, card, started) -> dict:
    """Phase 9: the dry run over the fake process group (9a) and the op
    counter held to the card (9b); 9a's process and 9c's count, started
    by ``start_dryrun``, are collected here."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.models.model import build_model
    from repro_torch.roofline.analysis import analyze, model_flops_train
    from repro_torch.roofline.op_cost import measure
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    out: dict = {}
    counting, plain_counts = started["counting"], started["plain_counts"]

    # -- 9a. the dry run's cells, in a process of its own --------------------
    stamp("9a")
    arch, shapes = DRYRUN_CELLS
    print(f"9a: cut to {arch} x {shapes}, single pod (2 of 40 cells); the mesh's "
          f"device type cuda over a fake process group of 256 ranks")
    t0 = time.perf_counter()
    cmd, rc, stdout, stderr, secs = finish_command(started["dryrun"])
    for line in stdout.splitlines():
        if line.startswith(("[done]", "total:")):
            print(f"9a: {line}")
    if rc != 0:
        fail(f"9a: the dry run exited {rc}: {stderr[-2000:]}")
    cells = json.loads(started["table"].read_text())
    print(f"9a: {cmd}, in the background since 5f, waited for "
          f"{time.perf_counter() - t0:.1f} s more")
    for key, cell in sorted(cells.items()):
        if cell.get("status") == "error":
            print(f"9a: {key}: {cell['trace']}")
    want = {f"{arch}|{s}|single" for s in shapes.split(",")}
    if set(cells) != want or any(c.get("status") != "ok" for c in cells.values()):
        fail(f"9a: cells {sorted(cells)}, statuses "
             f"{[c.get('status') for c in cells.values()]}; want {sorted(want)} ok")
    rows = {}
    for key, cell in sorted(cells.items()):
        r = cell["roofline"]
        rows[key] = {"t_compute_s": r["t_compute_s"], "t_memory_s": r["t_memory_s"],
                     "t_collective_s": r["t_collective_s"], "bottleneck": r["bottleneck"],
                     "peak_gib_per_card": cell["memory"]["peak_estimate_per_chip"] / 2 ** 30,
                     "useful_flops_ratio": cell["useful_flops_ratio"],
                     "lower_s": cell["lower_s"], "compile_s": cell["compile_s"]}
        print(f"9a: {key}: t_compute {r['t_compute_s']:.4e} s, t_memory "
              f"{r['t_memory_s']:.4e} s, t_collective {r['t_collective_s']:.4e} s, "
              f"bottleneck {r['bottleneck']}, peak {rows[key]['peak_gib_per_card']:.2f} GiB "
              f"a card, useful FLOPs ratio {cell['useful_flops_ratio']:.4f} (datasheet "
              f"constants, not readings)")
    out["dryrun"] = {"seconds": secs, "cells": rows}
    print(f"9a: {secs:.1f} s for the dry run's process")

    # -- 9b. the counter against the card ------------------------------------
    stamp("9b")
    # the meta path's split plan reads K3's occupancy from a table (F14):
    # every compiled bf16 variant's blocks per SM as the library answers
    lib = k3._lib()
    blocks = {f"{rows},{hd}": lib.flash_attention_blocks_per_sm(rows, hd)
              for rows, hd in k3.H100_BLOCKS_PER_SM}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"9b: K3's blocks per SM by (rows, hd), the library's: {blocks} on {sms} SMs; "
          f"the meta table's: {k3.H100_BLOCKS_PER_SM} on {k3.H100_SMS}")
    if blocks != {f"{r},{hd}": n for (r, hd), n in k3.H100_BLOCKS_PER_SM.items()} or \
            sms != k3.H100_SMS:
        fail("9b: K3's meta table of blocks per SM is not the library's answer")
    cfg = get_config(arch)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"9b: {arch} {cfg.dtype}, full width, remat {cfg.remat}, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} (phase 7d's shape), one rank, no mesh")
    it = make_batch_iterator(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batch = {name: torch.as_tensor(x, device=dev) for name, x in next(it).items()}

    meta_model = build_model(cfg, max_pos=TRAIN_SEQ, device="cpu", use_kernel=False)
    p_abs = meta_model.abstract_params()
    b_abs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    t0 = time.perf_counter()
    _, counter = measure(make_train_step(meta_model), p_abs, init_opt_state(p_abs), b_abs)
    count_s = time.perf_counter() - t0
    roof = analyze(counter.cost)
    useful = model_flops_train(cfg.active_params(), tokens) / roof.flops
    print(f"9b: plain step counted in {count_s:.1f} s: {roof.flops:.6e} FLOPs, "
          f"{roof.hbm_bytes:.6e} bytes (eager, at every op), t_bound "
          f"{roof.t_bound * 1e3:.3f} ms ({roof.bottleneck}), peak {counter.peak / 1e9:.3f} "
          f"GB, useful FLOPs ratio {useful:.4f}")

    pmodel = build_model(cfg, max_pos=TRAIN_SEQ, use_kernel=False)
    params = pmodel.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = init_opt_state(params)
    pstep = make_train_step(pmodel)
    warm = pstep(params, opt, batch)          # cuBLAS workspace, the allocator's pools
    torch.cuda.synchronize()
    del warm
    card_peak, other = card_step_peak(pstep, params, opt, batch)
    ratio = card_peak / counter.peak
    print(f"9b: peak of the plain step: card {card_peak / 1e9:.3f} GB "
          f"(max_memory_allocated less {other / 1e9:.3f} GB allocated before it that "
          f"are not its arguments), counted {counter.peak / 1e9:.3f} GB, ratio "
          f"{ratio:.4f} (limits {MEMORY_RATIO})")
    if not MEMORY_RATIO[0] <= ratio <= MEMORY_RATIO[1]:
        fail(f"9b: the card's peak is {ratio:.4f} of the counted peak")

    def step_ms(step, n=3):
        r = step(params, opt, batch)          # warm
        torch.cuda.synchronize()
        del r
        t0 = time.perf_counter()
        for _ in range(n):
            r = step(params, opt, batch)
            del r
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    plain_ms = step_ms(pstep)
    kstep = make_train_step(build_model(cfg, max_pos=TRAIN_SEQ))
    # the kernel step counted as it runs on the card: its aten ops, and K3's
    # launches with their own reads and writes (op_cost.kernel_launch), in
    # place of the plain attention's score-sized intermediates
    t0 = time.perf_counter()
    res, kcounter = measure(kstep, params, opt, batch, record=True)
    torch.cuda.synchronize()
    kcount_s = time.perf_counter() - t0
    del res
    kroof = analyze(kcounter.cost)
    reported = (sum(r.op == "kernel.K3" for r in kcounter.records),
                sum(r.op == "kernel.K3 backward" for r in kcounter.records))
    want = (2 * cfg.num_layers, cfg.num_layers)
    if reported != want:
        fail(f"9b: the counted kernel step saw K3 {reported} times, want {want}")
    flops_ratio = kroof.flops / roof.flops
    print(f"9b: kernel step counted on the card in {kcount_s:.1f} s: {kroof.flops:.6e} "
          f"FLOPs ({flops_ratio:.4f} of the plain step's; limits {KERNEL_FLOPS_RATIO}), "
          f"{kroof.hbm_bytes:.6e} bytes, t_bound {kroof.t_bound * 1e3:.3f} ms "
          f"({kroof.bottleneck}; compute {kroof.t_compute * 1e3:.3f} ms), K3 {reported[0]} "
          f"forward, {reported[1]} backward")
    if not KERNEL_FLOPS_RATIO[0] <= flops_ratio <= KERNEL_FLOPS_RATIO[1]:
        fail(f"9b: the kernel step's count is {flops_ratio:.4f} of the plain step's FLOPs")
    # F14: the same kernel step counted on meta tensors, as the dry run
    # counts it, held to the card's count and peak
    kmeta, kmeta_s = count_kernel_step_on_meta(cfg, batch, TRAIN_SEQ)
    kpeak, _ = card_step_peak(kstep, params, opt, batch)
    meta_gates = hold_meta_to_card(f"9b: {arch}", kcounter, kmeta, kmeta_s, kpeak, card)
    k3.flash_attention.launches = k3.flash_attention_backward.launches = 0
    kernel_ms = step_ms(kstep)
    launched = (k3.flash_attention.launches // 4, k3.flash_attention_backward.launches // 4)
    if launched != want:
        fail(f"9b: the kernel step launched K3 {launched} times a step, want {want}")
    bound_ms, kbound_ms = roof.t_bound * 1e3, kroof.t_bound * 1e3
    print(f"9b: plain step {plain_ms:.2f} ms against its own bound {bound_ms:.3f} ms "
          f"(eager bytes at every op): share {bound_ms / plain_ms:.4f}; kernel step "
          f"{kernel_ms:.2f} ms (K3 {launched[0]} forward, {launched[1]} backward a step) "
          f"against its own bound {kbound_ms:.3f} ms: share {kbound_ms / kernel_ms:.4f}")
    out["counter"] = {
        "shape": [TRAIN_BATCH, TRAIN_SEQ], "flops": roof.flops, "bytes": roof.hbm_bytes,
        "t_bound_ms": bound_ms, "bottleneck": roof.bottleneck, "useful_flops_ratio": useful,
        "counted_peak_bytes": counter.peak, "card_peak_bytes": card_peak,
        "peak_ratio": ratio, "count_s": count_s, "plain_ms": plain_ms,
        "kernel_ms": kernel_ms, "k3_launches_a_step": launched,
        "kernel_step_flops": kroof.flops, "kernel_step_bytes": kroof.hbm_bytes,
        "kernel_step_t_bound_ms": kbound_ms, "kernel_step_bottleneck": kroof.bottleneck,
        "kernel_count_s": kcount_s,
        "share_plain_own_bound": bound_ms / plain_ms,
        "share_kernel_own_bound": kbound_ms / kernel_ms, "meta_kernel_step": meta_gates,
        "k3_blocks_per_sm": blocks}
    del params, opt, pmodel, kstep
    free_device_memory()
    out["kernel_reports"] = kernel_report_phase(dev, card, counting, plain_counts)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: {out['seconds']:.1f} s ({card})")
    return out


def count_kernel_step_on_meta(cfg, batch: dict, seq: int):
    """The kernel path of ``cfg``'s train step (``use_kernel=True``, not
    donated, as 9b and 9c run it on the card) counted on ``meta`` tensors
    in this process, every microbatch run: K3, K4 and K5 walk their CUDA
    paths without launching (F14).  Returns (counter, seconds)."""
    from repro_torch.models.model import build_model
    from repro_torch.roofline.op_cost import measure
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    model = build_model(cfg, max_pos=seq, device="cpu")
    p_abs = model.abstract_params()
    b_abs = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in batch.items()}
    t0 = time.perf_counter()
    _, counter = measure(make_train_step(model), p_abs, init_opt_state(p_abs), b_abs,
                         record=True)
    return counter, time.perf_counter() - t0


def card_step_peak(step, params, opt, batch) -> tuple[int, int]:
    """(peak, other): ``torch.cuda.max_memory_allocated`` of one ``step``
    on the card less ``other``, the bytes allocated before it that are not
    its arguments (the allocator's pools warmed by an earlier call)."""
    from repro_torch.roofline.op_cost import OpCounter

    gc.collect()
    arg_bytes = OpCounter().track((params, opt, batch))
    other = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    res = step(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - other
    del res
    gc.collect()
    return peak, other


def hold_meta_to_card(what: str, on_card, on_meta, meta_s: float, card_peak: int,
                      card: str) -> dict:
    """9b-9c's gates on one kernel step: its count on ``meta`` tensors
    (``on_meta``) against its count as it ran on the card (``on_card``),
    both ``OpCounter``s with records: the kernel records equal record for
    record (name, flops, bytes), the totals within ``META_FLOPS_RTOL`` and
    ``META_BYTES_RTOL``, the meta peak within ``MEMORY_RATIO`` of
    ``card_peak``."""
    def kernel_records(counter):
        return sorted((r.op, r.flops, r.bytes) for r in counter.records
                      if r.op.startswith("kernel."))
    on, off = kernel_records(on_card), kernel_records(on_meta)
    flops_gap = abs(on_meta.cost.flops - on_card.cost.flops) / on_card.cost.flops
    bytes_gap = abs(on_meta.cost.bytes - on_card.cost.bytes) / on_card.cost.bytes
    ratio = card_peak / on_meta.peak
    names = sorted({r[0] for r in on})
    print(f"{what}: the kernel step counted on meta tensors in {meta_s:.1f} s: "
          f"{on_meta.cost.flops:.6e} FLOPs (card {on_card.cost.flops:.6e}, gap {flops_gap:.3e}; "
          f"limit {META_FLOPS_RTOL}), {on_meta.cost.bytes:.6e} B (card "
          f"{on_card.cost.bytes:.6e}, gap {bytes_gap:.3e}; limit {META_BYTES_RTOL}); "
          f"{len(off)} kernel records ({', '.join(f'{n} {sum(r[0] == n for r in off)}' for n in names)}), "
          f"{'equal' if on == off else 'NOT equal'} to the card's {len(on)}; counted peak "
          f"{on_meta.peak / 1e9:.3f} GB against the card's {card_peak / 1e9:.3f} GB: ratio "
          f"{ratio:.4f} (limits {MEMORY_RATIO}) [{card}]")
    if on != off:
        diff = [(a, b) for a, b in itertools.zip_longest(on, off) if a != b][:4]
        fail(f"{what}: the meta kernel records differ from the card's: {diff}")
    if not on:
        fail(f"{what}: no kernel record in the kernel step")
    if flops_gap > META_FLOPS_RTOL or bytes_gap > META_BYTES_RTOL:
        fail(f"{what}: the meta count's FLOPs gap {flops_gap:.3e}, bytes gap {bytes_gap:.3e}")
    if not MEMORY_RATIO[0] <= ratio <= MEMORY_RATIO[1]:
        fail(f"{what}: the card's kernel-step peak is {ratio:.4f} of the meta count's")
    return {"meta_flops": on_meta.cost.flops, "meta_bytes": on_meta.cost.bytes,
            "card_flops": on_card.cost.flops, "card_bytes": on_card.cost.bytes,
            "flops_gap": flops_gap, "bytes_gap": bytes_gap, "kernel_records": len(off),
            "meta_peak_bytes": on_meta.peak, "card_peak_bytes": card_peak,
            "peak_ratio": ratio, "meta_count_s": meta_s}


def count_plain_steps(path: str) -> None:
    """9c's plain train steps (``use_kernel=False``) counted on ``meta``
    tensors, in a process of its own: ``{arch: {flops, bytes, t_bound_ms,
    bottleneck, seconds}}`` written as JSON to ``path``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.launch.dryrun import _two_microbatches_only
    from repro_torch.models.model import build_model
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    res = {}
    for arch in (RWKV, GRIFFIN):
        cfg = dataclasses.replace(get_config(arch), num_layers=COUNT_DEPTH[arch])
        batch = next(make_batch_iterator(cfg.vocab_size, ARCH_TRAIN_SEQ,
                                         ARCH_TRAIN[arch]["batch"], seed=0))
        b_abs = {k: torch.empty(x.shape, dtype=torch.as_tensor(x).dtype, device="meta")
                 for k, x in batch.items()}
        model = build_model(cfg, max_pos=ARCH_TRAIN_SEQ, device="cpu", use_kernel=False)
        p_abs = model.abstract_params()
        o_abs = init_opt_state(p_abs)
        counter = OpCounter()
        counter.track((p_abs, o_abs, b_abs))
        t0 = time.perf_counter()
        with counter, (_two_microbatches_only(counter, cfg.microbatches)
                       if cfg.microbatches > 2 else contextlib.nullcontext()):
            make_train_step(model)(p_abs, o_abs, b_abs)
        roof = analyze(counter.cost)
        res[arch] = {"flops": roof.flops, "bytes": roof.hbm_bytes,
                     "t_bound_ms": roof.t_bound * 1e3, "bottleneck": roof.bottleneck,
                     "seconds": time.perf_counter() - t0}
    pathlib.Path(path).write_text(json.dumps(res))


def kernel_report_phase(dev, card, counting, plain_counts) -> dict:
    """Phase 9c: K1, K2, K4 and K5 report their launches to the op counter
    as K3 does.  (i) The paper's sweep counted on the card: 240 K1 records
    of the hand-counted bytes, the whole-lattice K1 and K2 one record each;
    (ii) rwkv6-3b and recurrentgemma-9b train steps counted as they run on
    the card: each kernel's records equal its launch counters, the counted
    FLOPs and bytes beside the plain step's count on meta tensors, which
    the process ``counting`` writes to ``plain_counts``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_batch_iterator
    from repro_torch.kernels.flash_attention import kernel as k3
    from repro_torch.kernels.jacobi.kernel import halo_rows, jacobi_sweep_cuda
    from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
    from repro_torch.kernels.rglru import kernel as k5
    from repro_torch.kernels.rwkv6 import kernel as k4
    from repro_torch.models.model import build_model
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.op_cost import measure
    from repro_torch.stencil.jacobi import run_runtime_sweep
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_step import make_train_step

    t_phase = time.perf_counter()
    out: dict = {}

    # -- (i) the paper's stencil --------------------------------------------
    stamp("9c stencil")
    f = torch.randn(LATTICE, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev)
    plane = LATTICE[1] * LATTICE[2] * 4
    want_bytes = sum((hi - lo + SLAB_ROWS) * plane for lo, hi in (
        halo_rows(LATTICE[0], (r, r + SLAB_ROWS)) for r in range(0, LATTICE[0], SLAB_ROWS)))
    if want_bytes != K1_SWEEP_BYTES:
        fail(f"9c: the slabs' planes give {want_bytes} B, the hand count {K1_SWEEP_BYTES}")
    t0 = time.perf_counter()
    (res, stats), counter = measure(run_runtime_sweep, f, di=SLAB_ROWS, num_domains=4,
                                    workers_per_domain=2, device=dev, record=True)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    k1 = [r for r in counter.records if r.op == "kernel.K1"]
    aten = [r for r in counter.records if not r.op.startswith("kernel.")]
    k1_bytes = sum(r.bytes for r in k1)
    print(f"9c: run_runtime_sweep {LATTICE} di={SLAB_ROWS}, 4 domains x 2 workers, counted "
          f"on the card in {sweep_s:.2f} s: {len(k1)} kernel.K1 records, {k1_bytes:.6e} B, "
          f"{sum(r.flops for r in k1):.6e} FLOPs (hand count {K1_SWEEP_BYTES:.6e} B: 2878 "
          f"planes read, 2400 written); {len(aten)} aten ops on the calling thread "
          f"({sum(r.bytes for r in aten):.6e} B).  The slab tasks run on the runtime's "
          f"worker threads: their aten ops are invisible to the dispatch mode, which is "
          f"the entering thread's, but their K1 reports reach the process's counters")
    if len(k1) != LATTICE[0] // SLAB_ROWS or k1_bytes != K1_SWEEP_BYTES \
            or stats.executed != len(k1):
        fail(f"9c: {len(k1)} K1 records of {k1_bytes} B for {stats.executed} slabs, want "
             f"{LATTICE[0] // SLAB_ROWS} of {K1_SWEEP_BYTES} B")
    del res
    whole = {}
    for name, fn in (("K1", jacobi_sweep_cuda), ("K2", jacobi_two_step_cuda)):
        res, counter = measure(fn, f, record=True)
        torch.cuda.synchronize()
        recs = [r for r in counter.records if r.op.startswith("kernel.")]
        whole[name] = [(r.op, r.bytes, r.flops) for r in recs]
        print(f"9c: whole-lattice {fn.__name__}: records {whole[name]} (want one "
              f"kernel.{name} of {LATTICE_BYTES:.6e} B)")
        if [(r.op, r.bytes) for r in recs] != [(f"kernel.{name}", LATTICE_BYTES)]:
            fail(f"9c: whole-lattice {name} reported {whole[name]}")
        del res
    del f
    free_device_memory()
    out["stencil"] = {"k1_records": len(k1), "k1_bytes": k1_bytes,
                      "k1_flops": sum(r.flops for r in k1), "aten_ops_calling_thread": len(aten),
                      "whole_lattice": whole, "seconds": sweep_s}

    # -- (ii) the recurrent configurations' train steps ----------------------
    t0 = time.perf_counter()
    counting.join(PLAIN_COUNT_TIMEOUT_S)
    if counting.is_alive():
        counting.kill()
        counting.join()
        fail(f"9c: the plain steps' count ran past {PLAIN_COUNT_TIMEOUT_S} s")
    if counting.exitcode != 0:
        fail(f"9c: the plain steps' count exited {counting.exitcode}")
    plain = json.loads(plain_counts.read_text())
    shutil.rmtree(plain_counts.parent)
    print(f"9c: the plain steps' count, in a process of its own since 5f, waited for "
          f"{time.perf_counter() - t0:.1f} s more")
    counters = {"K3": k3.flash_attention, "K3 backward": k3.flash_attention_backward,
                "K4": k4.wkv6_cuda, "K4 backward": k4.wkv6_backward,
                "K5": k5.rglru_scan_cuda, "K5 backward": k5.rglru_scan_backward}
    for arch in (RWKV, GRIFFIN):
        stamp(f"9c {arch}")
        base = get_config(arch)
        cfg = dataclasses.replace(base, num_layers=COUNT_DEPTH[arch])
        bsz = ARCH_TRAIN[arch]["batch"]
        print(f"9c: {arch} train step cut to {cfg.num_layers} of {base.num_layers} layers "
              f"({cfg.layer_kinds()}), full width, {bsz} x {ARCH_TRAIN_SEQ} in "
              f"{cfg.microbatches} microbatches (phase 7h's shape), remat {cfg.remat}")
        batch = {name: torch.as_tensor(x, device=dev) for name, x in next(
            make_batch_iterator(cfg.vocab_size, ARCH_TRAIN_SEQ, bsz, seed=0)).items()}
        model = build_model(cfg, max_pos=ARCH_TRAIN_SEQ, device=dev)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        opt = init_opt_state(params)
        step = make_train_step(model)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        res, counter = measure(step, params, opt, batch, record=True)
        torch.cuda.synchronize()
        count_s = time.perf_counter() - t0
        del res
        launched = {name: fn.launches for name, fn in counters.items()}
        reported = {name: sum(r.op == f"kernel.{name}" for r in counter.records)
                    for name in counters}
        kroof = analyze(counter.cost)
        print(f"9c: {arch} kernel step counted on the card in {count_s:.1f} s: records "
              f"{reported}, launch counters {launched}")
        kind = "K4" if arch == RWKV else "K5"
        if reported != launched or not reported[kind] or not reported[f"{kind} backward"]:
            fail(f"9c: {arch}: kernel records {reported}, launch counters {launched}")
        if arch == RWKV:
            # the meta path sizes K4's backward workspace in Python (F14)
            lib = k4._bwd_lib()
            h, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
            sizes = {(b, t, chunk): (lib.wkv6_bwd_workspace_floats(b, t, h, hd, chunk),
                                     k4.bwd_workspace_floats(b, t, h, hd, chunk))
                     for b, t in ((bsz // cfg.microbatches, ARCH_TRAIN_SEQ), (2, 65), (1, 1))
                     for chunk in k4.BWD_CHUNKS}
            print(f"9c: K4's backward workspace floats (library, Python) at H {h}, hd {hd} "
                  f"by (B, T, chunk): {sizes}")
            if any(a != b for a, b in sizes.values()):
                fail(f"9c: K4's backward workspace in Python differs from the library's: {sizes}")
        kmeta, kmeta_s = count_kernel_step_on_meta(cfg, batch, ARCH_TRAIN_SEQ)
        kpeak, _ = card_step_peak(step, params, opt, batch)
        meta_gates = hold_meta_to_card(f"9c: {arch}", counter, kmeta, kmeta_s, kpeak, card)

        proof = plain[arch]
        r = step(params, opt, batch)          # warm
        torch.cuda.synchronize()
        del r
        t0 = time.perf_counter()
        for _ in range(3):
            r = step(params, opt, batch)
            del r
        torch.cuda.synchronize()
        kernel_ms = (time.perf_counter() - t0) / 3 * 1e3
        kbound_ms = kroof.t_bound * 1e3
        print(f"9c: {arch} kernel step {kernel_ms:.2f} ms against its own counted bound "
              f"{kbound_ms:.3f} ms ({kroof.bottleneck}): share {kbound_ms / kernel_ms:.4f}; "
              f"counted {kroof.flops:.6e} FLOPs, {kroof.hbm_bytes:.6e} bytes; the plain step "
              f"counted on meta tensors in {proof['seconds']:.1f} s: {proof['flops']:.6e} "
              f"FLOPs ({kroof.flops / proof['flops']:.4f} of them counted on the kernel "
              f"step), {proof['bytes']:.6e} bytes ({kroof.hbm_bytes / proof['bytes']:.4f}), "
              f"t_bound {proof['t_bound_ms']:.3f} ms ({proof['bottleneck']}) [{card}]")
        out[arch] = {
            "layers": cfg.num_layers, "batch": bsz, "seq": ARCH_TRAIN_SEQ,
            "microbatches": cfg.microbatches, "records": reported, "launches": launched,
            "kernel_step_flops": kroof.flops, "kernel_step_bytes": kroof.hbm_bytes,
            "kernel_step_t_bound_ms": kbound_ms, "kernel_step_bottleneck": kroof.bottleneck,
            "kernel_ms": kernel_ms, "share_kernel_own_bound": kbound_ms / kernel_ms,
            "plain_step_flops": proof["flops"], "plain_step_bytes": proof["bytes"],
            "plain_step_t_bound_ms": proof["t_bound_ms"], "count_s": count_s,
            "plain_count_s": proof["seconds"], "meta_kernel_step": meta_gates}
        del model, params, opt, step, counter
        free_device_memory()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"9c: {out['seconds']:.1f} s ({card})")
    return out


def stamp(phase) -> None:
    print(f"[{time.perf_counter() - T_START:.1f} s] phase {phase}", flush=True)


def main() -> None:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside {__file__}")
    sys.path.insert(0, str(ROOT / "src"))
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as k3_kernel
    from repro_torch.kernels.flash_attention.kernel import flash_attention, split_plan
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.jacobi import kernel as k12_kernel
    from repro_torch.kernels.jacobi import ops, ref
    from repro_torch.kernels.jacobi.kernel import jacobi_sweep_cuda
    from repro_torch.kernels.jacobi.temporal import jacobi_two_step_cuda
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru import ops as rglru_ops
    from repro_torch.kernels.rglru.kernel import rglru_scan_cuda
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.rwkv6 import kernel as wkv_kernel
    from repro_torch.kernels.rwkv6 import ops as wkv_ops
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models import attention as attn_model
    from repro_torch.models import moe as moe_model
    from repro_torch.models import rglru as rglru_model
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Replica, Request, ServingEngine
    from repro_torch.stencil.jacobi import run_runtime_sweep

    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"card: {card}")
    try:
        from torch.distributed.tensor import DTensor  # noqa: F401
        from torch.distributed.tensor.experimental import (  # noqa: F401
            implicit_replication, local_map)
        from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: F401
    except ImportError as exc:
        fail(f"torch {torch.__version__} lacks what the distribution layer needs: {exc}")
    print(f"torch {torch.__version__} imports DTensor, local_map, implicit_replication "
          f"and the fake process group (FakeStore)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False")

    # the plain WKV version, counted where the port reaches it (the wrapper's
    # CPU branch and ops' use_kernel=False branch); this script's own
    # comparisons call wkv6_ref directly and are not counted
    plain_wkv = {"calls": 0}

    def counted_ref(*args, **kw):
        plain_wkv["calls"] += 1
        return wkv6_ref(*args, **kw)

    wkv_kernel.wkv6_ref = wkv_ops.wkv6_ref = counted_ref
    # the plain RG-LRU scan likewise
    plain_rglru = {"calls": 0}

    def counted_rglru_ref(*args, **kw):
        plain_rglru["calls"] += 1
        return rglru_scan_ref(*args, **kw)

    rglru_kernel.rglru_scan_ref = rglru_ops.rglru_scan_ref = counted_rglru_ref
    # and the plain attention forms, where the model's attention block
    # reaches them (this script's own comparisons hold their own references)
    plain_attn = {"calls": 0}

    def counted_attention(fn):
        def counted(*args, **kw):
            plain_attn["calls"] += 1
            return fn(*args, **kw)
        return counted

    for fname in ("direct_attention", "decode_attention", "chunked_attention",
                  "banded_attention"):
        setattr(attn_model, fname, counted_attention(getattr(attn_model, fname)))

    def zero_counts():
        jacobi_sweep_cuda.launches = jacobi_two_step_cuda.launches = 0
        flash_attention.launches = wkv6_cuda.launches = plain_wkv["calls"] = 0
        rglru_scan_cuda.launches = plain_rglru["calls"] = plain_attn["calls"] = 0

    def counts():
        return {"jacobi_sweep": jacobi_sweep_cuda.launches,
                "jacobi_two_step": jacobi_two_step_cuda.launches,
                "flash_attention": flash_attention.launches,
                "wkv6": wkv6_cuda.launches, "wkv6_plain_calls": plain_wkv["calls"],
                "rglru": rglru_scan_cuda.launches,
                "rglru_plain_calls": plain_rglru["calls"],
                "attention_plain_calls": plain_attn["calls"]}

    def path_launches(cfg, n_requests):
        """The launches of each kernel that serving ``n_requests`` requests
        of ``cfg`` must make, per prefill and per decode step: K3 once per
        attention call (``attention_calls``: a "cross" layer's self- and
        cross-attention, none for MLA), K4 once per rwkv layer and K5 once
        per rglru layer."""
        kinds = cfg.layer_kinds()
        per_step = {"flash_attention": attention_calls(cfg, frames=False),
                    "wkv6": kinds.count("rwkv"), "rglru": kinds.count("rglru")}
        return {name: n_requests * (1 + MAX_NEW) * n for name, n in per_step.items() if n}

    def path_ok(launched, want):
        """Every kernel launched exactly as often as ``want`` says (zero for
        the rest) and no plain version called."""
        return all(n == want.get(name, 0) for name, n in launched.items())

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {_build.sources()}")
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu: registers, shared memory, spills ---")
        print("\n".join(ptxas_summary(log)))
    k3_lib = k3_kernel._lib()
    for label, dtype, rows in (("f32", 0, 0), ("bf16 decode, 16 rows", 1, 16),
                               ("bf16 prefill, 64 rows", 1, 64)):
        print(f"flash_attention {label}: dynamic shared memory per block: " + ", ".join(
            f"hd {hd}: {k3_lib.flash_attention_smem_bytes(dtype, rows, hd)} B"
            + (f" ({k3_lib.flash_attention_blocks_per_sm(rows, hd)} blocks per SM)"
               if dtype else "") for hd in k3_kernel.HEAD_DIMS))

    bwd_smem = []
    for hd in k3_kernel.HEAD_DIMS:
        smem = (ctypes.c_int * 5)()
        if k3_kernel._bwd_lib().flash_attention_bwd_smem_bytes(hd, smem) == 0:
            bwd_smem.append(f"hd {hd}: f32 {smem[0]}/{smem[1]}/{smem[2]} B, bf16 "
                            f"{smem[3]}/{smem[4]} B")
    print("flash_attention backward: dynamic shared memory per block (f32 prep/dq/dkdv, "
          "bf16 tensor-core dq/dkdv): " + ", ".join(bwd_smem))
    geo = wkv_kernel.bwd_geometry()
    print(f"wkv6 backward: {geo['chunk']}-step time chunks of {geo['sub_steps']}-step "
          f"sub-chunks; walk kernel blocks per SM at hd 64, bf16, by chunk: "
          f"{geo['blocks_per_sm']}; rglru backward: "
          f"{rglru_kernel._bwd_lib().rglru_bwd_stage_steps()}-step stages")
    for two_step, name in ((False, "jacobi_sweep (K1)"), (True, "jacobi_two_step (K2)")):
        g = k12_kernel.geometry(two_step)
        print(f"{name}: instance {g['variant']} of {k12_kernel.variants(two_step)}, tile "
              f"{g['tj']} x {g['tk']}, {g['stages']} ring stages, {g['threads']} threads, "
              f"{g['smem_bytes']} B dynamic shared memory, {g['blocks_per_sm']} blocks per "
              f"SM ({g['blocks_per_sm_copy']} for the 4-byte-copy instance), i chunks of "
              f"{g['chunk']} rows")
    probe = torch.empty((SLAB_ROWS, *LATTICE[1:]), device=dev)
    print(f"jacobi: one tensor-map encode takes {k12_kernel.encode_ns(probe) / 1e3:.3f} us "
          f"of host time")
    del probe

    print(f"wkv6: time chunks of {wkv_kernel.TIME_CHUNK} steps (a call up to one chunk "
          f"is one launch, a longer one three); rglru: {rglru_kernel.stage_steps()} "
          f"steps a shared-memory stage")

    def k3_plan(heads, tq, tk, qo=0, win=0):
        """K3's split plan on this card for (Hq, Hkv, hd) ``heads``."""
        h, kvh, d = heads
        slots = k3_kernel._slots(0, k3_kernel.variant(h, kvh, tq, d)[0], d)
        return split_plan(1, h, kvh, tq, tk, d, q_offset=qo, window=win, slots=slots)

    # -- 2. kernels against their plain versions --------------------------
    stamp(2)
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {"jacobi_sweep": 0.0, "jacobi_two_step": 0.0, "flash_attention": 0.0,
            "wkv6": 0.0, "rglru": 0.0}
    for shape, (di, dj) in SWEEP_CASES:
        for c in (1 / 6, 0.25):
            f = torch.randn(shape, generator=gen, device=dev)
            e = max_err(jacobi_sweep_cuda(f, c, di, dj), ref.jacobi_sweep_ref(f, c))
            errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e)
            print(f"K1 {shape} c={c:.4f}: max_abs_err {e:.3e}")
    for shape, (di, dj) in TWO_STEP_CASES:
        for c in (1 / 6, 0.25):
            f = torch.randn(shape, generator=gen, device=dev)
            e = max_err(jacobi_two_step_cuda(f, c, di, dj),
                        ref.jacobi_two_step_ref(f, c))
            errs["jacobi_two_step"] = max(errs["jacobi_two_step"], e)
            print(f"K2 {shape} c={c:.4f}: max_abs_err {e:.3e}")

    # K1 and K2 bit for bit: unequal elements (limit 0) at every shape below
    unequal = {"jacobi_sweep": 0, "jacobi_two_step": 0}

    def k12_exact(name, got, want, label):
        n = int((got != want).sum())
        unequal[name] += n
        if n:
            print(f"{name} {label}: {n} unequal elements")

    f = torch.randn(LATTICE, generator=gen, device=dev)
    plain = ref.jacobi_sweep_ref(f)
    got = jacobi_sweep_cuda(f)
    e = max_err(got, plain)
    k12_exact("jacobi_sweep", got, plain, LATTICE)
    errs["jacobi_sweep"] = max(errs["jacobi_sweep"], e)
    print(f"K1 {LATTICE}: max_abs_err {e:.3e}, {unequal['jacobi_sweep']} unequal elements")
    want = ref.jacobi_sweep_ref(plain)
    got = jacobi_two_step_cuda(f)
    e = max_err(got, want)
    k12_exact("jacobi_two_step", got, want, LATTICE)
    errs["jacobi_two_step"] = max(errs["jacobi_two_step"], e)
    print(f"K2 {LATTICE}: max_abs_err {e:.3e}, {unequal['jacobi_two_step']} unequal elements")
    del got, want
    # the runtime sweep's first and last slab: the tensor map's zero fill is
    # the missing halo plane
    for rows in ((0, SLAB_ROWS), (LATTICE[0] - SLAB_ROWS, LATTICE[0])):
        k12_exact("jacobi_sweep",
                  jacobi_sweep_cuda(f, di=SLAB_ROWS, dj=LATTICE[1], rows=rows),
                  plain[rows[0]:rows[1]], f"rows {rows}")
    print(f"K1 slabs at both lattice edges: {unequal['jacobi_sweep']} unequal elements so far")
    for two_step, name, kern, plain_fn in (
            (False, "jacobi_sweep", jacobi_sweep_cuda, ref.jacobi_sweep_ref),
            (True, "jacobi_two_step", jacobi_two_step_cuda, ref.jacobi_two_step_ref)):
        g = k12_kernel.geometry(two_step)
        shapes = [(7, tiles * g["tj"] + dj, g["tk"] + dk) for tiles in (1, 2)
                  for dj in TILE_J_OFFSETS for dk in TILE_K_OFFSETS]
        shapes += SMALL_LATTICES
        shapes += [(ni, 9, 124) for ni in (g["chunk"] - 1, g["chunk"], g["chunk"] + 1,
                                           2 * g["chunk"] + 1)]
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device=dev)
            # di, dj: the whole lattice (the wrappers check divisibility only)
            k12_exact(name, kern(x, 0.25, shape[0], shape[1]), plain_fn(x, 0.25), shape)
        print(f"{name}: {len(shapes)} shapes around its {g['tj']} x {g['tk']} tile "
              f"and {g['chunk']}-row i chunk ({sum(1 for sh in shapes if sh[2] % 4)} "
              f"with nk not a multiple of 4, through the 4-byte copies): "
              f"{unequal[name]} unequal elements in all")
    torch.cuda.synchronize()
    if errs["jacobi_sweep"] > K1_ATOL or errs["jacobi_two_step"] > K2_ATOL \
            or any(unequal.values()):
        fail(f"kernel disagrees with its plain version: {errs}, unequal {unequal}")

    print(f"K3 limits, per element against mha_ref's value r: |err| <= "
          f"{K3_F32_TOL['atol']} in f32 (the online softmax reassociates the "
          f"sums), {K3_BF16_TOL['atol']} + 2^-7 |r| in bf16 (both round an f32 "
          f"result to bf16 once, so may land one bf16 ulp apart)")
    k3_worst = 0.0      # the largest share of its limit any element used

    def k3_check(label, got, want, tol):
        nonlocal k3_worst
        e = max_err(got, want)
        want = want.float()
        share = float(((got.float() - want).abs()
                       / (tol["atol"] + tol["rtol"] * want.abs())).max())
        k3_worst = max(k3_worst, share)
        print(f"K3 {label}: max_abs_err {e:.3e}, |ref| max {float(want.abs().max()):.4f} "
              f"median {float(want.abs().median()):.4f}, worst share of limit {share:.3f}")
        return e

    k3_f32, k3_bf16 = 0.0, 0.0
    for b, hq, hkv, tq, tk, hd, causal, win in FLASH_CASES:
        q = torch.randn((b, hq, tq, hd), generator=gen, device=dev)
        k, v = (torch.randn((b, hkv, tk, hd), generator=gen, device=dev)
                for _ in range(2))
        kw = dict(causal=causal, window=win, q_offset=tk - tq)
        k3_f32 = max(k3_f32, k3_check(
            f"f32 {(b, hq, hkv, tq, tk, hd)} causal={causal} window={win}",
            flash_attention(q, k, v, bq=tq, bk=tk, **kw), mha_ref(q, k, v, **kw),
            K3_F32_TOL))
    q, k, v = (torch.randn((1, 2, 128, 32), generator=gen, device=dev).bfloat16()
               for _ in range(3))
    k3_bf16 = max(k3_bf16, k3_check("bf16 (1, 2, 128, 32)", flash_attention(
        q, k, v, bq=64, bk=64), mha_ref(q, k, v), K3_BF16_TOL))

    cfg, gcfg = get_config(QWEN), get_config(GRIFFIN)
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # recurrentgemma-9b's local layers: 16 q / 1 kv head of 256
    ghq, ghkv, ghd = gcfg.num_heads, gcfg.num_kv_heads, gcfg.head_dim

    def model_qkv(tq, tk, heads):
        """(B, T, H, hd) tensors for ``heads`` = (Hq, Hkv, hd), passed as
        (B, H, T, hd) views, as the model does."""
        h, kvh, d = heads
        q = torch.randn((1, tq, h, d), generator=gen, device=dev).bfloat16().transpose(1, 2)
        k, v = (torch.randn((1, tk, kvh, d), generator=gen, device=dev).bfloat16()
                .transpose(1, 2) for _ in range(2))
        return q, k, v

    def k3_model(label, tq, tk, qo, heads, win=0):
        """K3 against mha_ref on fresh model-shaped bf16 inputs: (the
        inputs, the error)."""
        q, k, v = model_qkv(tq, tk, heads)
        e = k3_check(f"bf16 {label} q {tuple(q.shape)} kv {tuple(k.shape)} "
                     f"q_offset={qo} window={win}",
                     flash_attention(q, k, v, q_offset=qo, window=win, bq=tq, bk=tk),
                     mha_ref(q, k, v, q_offset=qo, window=win), K3_BF16_TOL)
        return (q, k, v), e

    k3_inputs, k3g_inputs = {}, {}
    for name, tq, tk, qo in K3_SHAPES:
        qkv, e = k3_model(name, tq, tk, qo, (hq, hkv, hd))
        k3_inputs[name], k3_bf16 = (*qkv, qo), max(k3_bf16, e)
    for name, tq, tk, qo, win in K3_GRIFFIN_SHAPES:
        qkv, e = k3_model(f"hd {ghd} {name}", tq, tk, qo, (ghq, ghkv, ghd), win)
        k3g_inputs[name], k3_bf16 = (*qkv, qo, win), max(k3_bf16, e)
    # the drains' own prompts: each prefill (with the local layers' window
    # for recurrentgemma-9b), and the first decode step after it
    for arch_cfg, heads, win in ((cfg, (hq, hkv, hd), 0),
                                 (gcfg, (ghq, ghkv, ghd), gcfg.attn_window)):
        for plen in sorted(len(r.tokens) for r in requests(arch_cfg, Request)):
            for tq, tk, qo, w in ((plen, plen, 0, win), (1, MAX_SEQ, plen, 0)):
                _, e = k3_model(f"{arch_cfg.name} drain "
                                f"{'prefill' if tq > 1 else 'decode'} {plen}",
                                tq, tk, qo, heads, w)
                k3_bf16 = max(k3_bf16, e)
    # a wrapped ring: every slot holds a position, slot p % 2048.  The model's
    # call (window 0, q_offset pos) against the plain ring mask on the same
    # bf16 values in f32, rounded once to bf16 as mha_ref's result is
    for pos in K3_RING_WRAPPED:
        q, k, v = model_qkv(1, MAX_SEQ, (ghq, ghkv, ghd))
        want = decode_attention(*(x.transpose(1, 2).float() for x in (q, k, v)),
                                pos + 1, ring=True)
        want = want.reshape(1, 1, ghq, ghd).transpose(1, 2).bfloat16()
        k3_bf16 = max(k3_bf16, k3_check(
            f"bf16 hd {ghd} wrapped ring decode at pos {pos} (window 0, "
            f"q_offset {pos}) vs decode_attention(ring=True)",
            flash_attention(q, k, v, q_offset=pos, bq=1, bk=MAX_SEQ), want,
            K3_BF16_TOL))
    for heads in ((hq, hkv, hd), (ghq, ghkv, ghd)):
        for qo, win in K3_SPLIT_DECODE:
            plan = k3_plan(heads, 1, MAX_SEQ, qo, win)
            _, e = k3_model(f"hd {heads[2]} split decode ({plan.splits} chunks of "
                            f"{plan.tiles_per_chunk} x {plan.bk} keys)", 1, MAX_SEQ, qo,
                            heads, win)
            k3_bf16 = max(k3_bf16, e)
    for arch_cfg, heads in ((cfg, (hq, hkv, hd)), (gcfg, (ghq, ghkv, ghd))):
        t, win = K3_ONE_PAST[arch_cfg.name]
        _, e = k3_model(f"hd {heads[2]} prefill one past the row and key tiles", t, t, 0,
                        heads, win)
        k3_bf16 = max(k3_bf16, e)
    t = K3_MISSED_CHUNK
    plan = k3_plan((hq, hkv, hd), t, t)
    _, e = k3_model(f"hd {hd} split prefill, rows that miss a chunk ({plan.splits} "
                    f"chunks of {plan.tiles_per_chunk} x {plan.bk} keys)", t, t, 0,
                    (hq, hkv, hd))
    k3_bf16 = max(k3_bf16, e)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"K3 disagrees with mha_ref: an element used {k3_worst:.3f} of its limit")
    # the same call gives the same bits (the split's merge order is fixed)
    for label, (q, k, v, qo, *win) in (("qwen2 decode_2047", k3_inputs["decode_2047"]),
                                       ("qwen2 prefill_1024", k3_inputs["prefill_1024"]),
                                       ("hd 256 decode_2047", k3g_inputs["decode_2047"]),
                                       ("hd 256 prefill_1024", k3g_inputs["prefill_1024"])):
        kw = dict(q_offset=qo, window=win[0] if win else 0, bq=q.shape[2], bk=k.shape[2])
        first = flash_attention(q, k, v, **kw)
        if not all(torch.equal(flash_attention(q, k, v, **kw), first) for _ in range(3)):
            fail(f"K3 {label}: repeated calls differ")
    print("K3 repeat calls bit-identical at qwen2 and hd 256 decode_2047 and prefill_1024")
    # the new architectures' shapes: head dim 128 at group 8, attention
    # without a causal mask, cross-attention with Tk != Tq
    k3n_inputs, e_bf16, e_f32 = k3_new_shapes(gen, dev, k3_check)
    k3_bf16, k3_f32 = max(k3_bf16, e_bf16), max(k3_f32, e_f32)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"K3 disagrees with mha_ref: an element used {k3_worst:.3f} of its limit")
    errs["flash_attention"] = max(k3_f32, k3_bf16)

    print(f"K4 limit, per element of o and of the final state: |err| <= {K4_REL} "
          f"x the shape's max |ref| (both sum the same f32 products in other orders)")
    k4_worst = 0.0

    def k4_check(label, got, want):
        nonlocal k4_worst
        for part, g, r in zip(("o", "sT"), got, want):
            e = max_err(g, r)
            top = float(r.abs().max())
            share = e / (K4_REL * top)
            k4_worst = max(k4_worst, share)
            errs["wkv6"] = max(errs["wkv6"], e)
            print(f"K4 {label} {part}: max_abs_err {e:.3e}, |ref| max {top:.4f} "
                  f"median {float(r.abs().median()):.4f}, worst share of limit {share:.3f}")

    for b, t, h, hdw in WKV_CASES:
        r, k, v = (torch.randn((b, t, h, hdw), generator=gen, device=dev) * s
                   for s in (1.0, 0.3, 0.3))
        w = 0.8 + 0.199 * torch.rand((b, t, h, hdw), generator=gen, device=dev)
        u = 0.3 * torch.randn((h, hdw), generator=gen, device=dev)
        k4_check(f"f32 {(b, t, h, hdw)}", wkv6_cuda(r, k, v, w, u, chunk=32),
                 wkv6_ref(r, k, v, w, u))
        if (b, t, h, hdw) == (1, 128, 4, 32):     # the state carried across calls
            half = [x[:, :64].contiguous() for x in (r, k, v, w)]
            rest = [x[:, 64:].contiguous() for x in (r, k, v, w)]
            o1, s1 = wkv6_cuda(*half, u, chunk=32)
            o2, s2 = wkv6_cuda(*rest, u, chunk=32, s0=s1)
            k4_check(f"f32 {(b, t, h, hdw)} in two calls",
                     (torch.cat([o1, o2], 1), s2), wkv6_ref(r, k, v, w, u))

    rcfg = get_config(RWKV)
    rh, rhd = rcfg.d_model // rcfg.rwkv_head_dim, rcfg.rwkv_head_dim

    def wkv_model_inputs(t):
        """rwkv6-3b's WKV inputs: bf16 r, k, v; f32 decays exp(-exp(d)) with
        d around the model's -6; f32 u in [0, 0.5) as initialised."""
        r, k, v = (torch.randn((1, t, rh, rhd), generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        decay = -6.0 + torch.randn((1, t, rh, rhd), generator=gen, device=dev)
        u = 0.5 * torch.rand((rh, rhd), generator=gen, device=dev)
        return r, k, v, torch.exp(-torch.exp(decay)), u

    k4_inputs = {}
    for name, t in K4_SHAPES:
        k4_inputs[name] = wkv_model_inputs(t)
    prefill_state = wkv6_ref(*k4_inputs["prefill_1024"])[1]
    for name, t in K4_SHAPES:
        s0 = prefill_state if t == 1 else torch.zeros_like(prefill_state)
        want = wkv6_ref(*k4_inputs[name], s0)
        k4_check(f"bf16 {name} {(1, t, rh, rhd)}" + (" from a prefill's state"
                                                     if t == 1 else ""),
                 wkv6_cuda(*k4_inputs[name], chunk=t, s0=s0.clone()), want)
    for plen in sorted(len(r.tokens) for r in requests(rcfg, Request)):
        x = wkv_model_inputs(plen)
        k4_check(f"bf16 drain prefill {plen}", wkv6_cuda(*x, chunk=plen), wkv6_ref(*x))
    # either side of the time chunk's boundary (one launch, then three) and
    # several chunks with a ragged last one, from zero and from a carried state
    c4 = wkv_kernel.TIME_CHUNK
    for t in [c4 + d for d in K4_CHUNK_OFFSETS] + [m * c4 + 5 for m in K4_MULTI_CHUNK]:
        x = wkv_model_inputs(t)
        k4_check(f"bf16 T {t} (time chunk {c4}) from zero", wkv6_cuda(*x, chunk=t),
                 wkv6_ref(*x))
        k4_check(f"bf16 T {t} (time chunk {c4}) from a prefill's state",
                 wkv6_cuda(*x, chunk=t, s0=prefill_state.clone()),
                 wkv6_ref(*x, prefill_state))
    # the three-kernel path at the narrower compiled head widths (the model
    # runs hd 64 only), bf16 from a carried state
    t = K4_MULTI_CHUNK[-1] * c4 + 5
    for hdw in wkv_kernel.HEAD_DIMS[:-1]:
        shape = (2, t, 3, hdw)
        r, k, v = (torch.randn(shape, generator=gen, device=dev).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(-6.0 + torch.randn(shape, generator=gen, device=dev)))
        u = 0.5 * torch.rand((3, hdw), generator=gen, device=dev)
        s0 = 0.5 * torch.randn((2, 3, hdw, hdw), generator=gen, device=dev)
        k4_check(f"bf16 {shape} (time chunk {c4}) from a state",
                 wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0.clone()),
                 wkv6_ref(r, k, v, w, u, s0))
    torch.cuda.synchronize()
    if k4_worst > 1.0:
        fail(f"K4 disagrees with wkv6_ref: an error used {k4_worst:.3f} of its limit")

    print("K5 limit: bit for bit, 0 unequal elements (each step is one rounded "
          "multiply and one rounded add in both)")
    k5_unequal = 0

    def k5_check(label, got, want):
        nonlocal k5_unequal
        e = max_err(got, want)
        n = int((got != want).sum())
        k5_unequal += n
        errs["rglru"] = max(errs["rglru"], e)
        print(f"K5 {label}: {n} unequal of {want.numel()}, max_abs_err {e:.3e}, "
              f"|ref| max {float(want.abs().max()):.4f}")

    for b, t, w, chunk in RGLRU_CASES:
        a = 0.5 + 0.499 * torch.rand((b, t, w), generator=gen, device=dev)
        bb = 0.1 * torch.randn((b, t, w), generator=gen, device=dev)
        k5_check(f"f32 {(b, t, w)} chunk={chunk}", rglru_scan_cuda(a, bb, chunk=chunk),
                 rglru_scan_ref(a, bb))
    gw = gcfg.d_model
    softplus_lam = rglru_model._softplus(torch.log(torch.expm1(-torch.log(
        torch.linspace(0.9, 0.999, gw, device=dev)) / rglru_model._C)))

    def rglru_model_inputs(t):
        """recurrentgemma-9b's scan inputs: a = exp(-8 softplus(lam) r) with
        lam as initialised and r a sigmoid gate; bx = sqrt(1 - a^2) i u."""
        r, i = (torch.sigmoid(torch.randn((1, t, gw), generator=gen, device=dev))
                for _ in range(2))
        log_a = -rglru_model._C * softplus_lam * r
        a = torch.exp(log_a)
        bx = torch.sqrt(1 - torch.exp(2 * log_a)) * i * \
            torch.randn((1, t, gw), generator=gen, device=dev)
        return a, bx

    k5_inputs = {name: rglru_model_inputs(t) for name, t in K5_SHAPES}
    zero_h = torch.zeros((1, gw), device=dev)
    carried_h = rglru_scan_ref(*k5_inputs["prefill_1024"])[:, -1].contiguous()
    for name, t in K5_SHAPES:
        h0 = carried_h if t == 1 else zero_h
        k5_check(f"f32 {name} {(1, t, gw)}" + (" from a prefill's state" if t == 1 else ""),
                 rglru_scan_cuda(*k5_inputs[name], chunk=t, h0=h0),
                 rglru_scan_ref(*k5_inputs[name], h0))
        k5_inputs[name] += (h0,)
    for plen in sorted(len(r.tokens) for r in requests(gcfg, Request)):
        a, bx = rglru_model_inputs(plen)
        k5_check(f"f32 drain prefill {plen}", rglru_scan_cuda(a, bx, chunk=plen, h0=zero_h),
                 rglru_scan_ref(a, bx, zero_h))
    # either side of a stage and past the ring's wrap, at the model's width
    # (16-byte copies) and one past it (4-byte copies, a partial strip)
    st5 = rglru_kernel.stage_steps()
    for width in (gw, gw + 1):
        for t in (st5 - 1, st5, st5 + 1, 6 * st5 + 1):
            a = 0.5 + 0.499 * torch.rand((1, t, width), generator=gen, device=dev)
            bb = 0.1 * torch.randn((1, t, width), generator=gen, device=dev)
            h0 = torch.randn((1, width), generator=gen, device=dev)
            k5_check(f"f32 {(1, t, width)} across stages", rglru_scan_cuda(a, bb, chunk=t, h0=h0),
                     rglru_scan_ref(a, bb, h0))
    torch.cuda.synchronize()
    if k5_unequal:
        fail(f"K5 differs from rglru_scan_ref in {k5_unequal} elements")

    # -- 3. the Jacobi main path, then jacobi_iterate ----------------------
    stamp(3)
    di, domains, wpd = 10, 4, 2
    zero_counts()
    out, stats = run_runtime_sweep(f, di=di, num_domains=domains,
                                   workers_per_domain=wpd)
    torch.cuda.synchronize()
    main_launches = counts()
    e_main = max_err(out, plain)
    print(f"run_runtime_sweep {LATTICE} di={di} domains={domains}x{wpd}: "
          f"max_abs_err {e_main:.3e}, launches {main_launches}")
    print(f"RuntimeStats: {stats}")
    nslabs = LATTICE[0] // di
    if e_main > K1_ATOL or main_launches["jacobi_sweep"] != nslabs \
            or stats.executed != nslabs:
        fail(f"runtime sweep: err {e_main}, launches {main_launches}, "
             f"executed {stats.executed}, want {nslabs} slabs")
    stamp("3b")
    spec_main = spec_sweep(f, out, di, counts, zero_counts)
    del out
    stamp("3c")
    spmd = spmd_sweeps(f, counts, zero_counts)
    stamp("3d")

    steps = 3
    zero_counts()
    it = ops.jacobi_iterate(f, steps)
    torch.cuda.synchronize()
    iter_launches = counts()
    want = ref.jacobi_sweep_ref(ref.jacobi_sweep_ref(plain))
    e_iter = max_err(it, want)
    print(f"jacobi_iterate steps={steps}: max_abs_err {e_iter:.3e}, "
          f"launches {iter_launches}")
    if e_iter > K2_ATOL or iter_launches["jacobi_sweep"] != 1 \
            or iter_launches["jacobi_two_step"] != 1:
        fail(f"jacobi_iterate: err {e_iter}, launches {iter_launches}")
    del it, want, plain

    # -- 4-5. the serving paths at full width ------------------------------
    def build(arch, cfg):
        """``arch`` at full width, random weights from seed 0: (model, params)."""
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        n_params = sum(leaf.numel() for leaf in leaves(params))
        heads = (f"{cfg.d_model // cfg.rwkv_head_dim} heads of {cfg.rwkv_head_dim}"
                 if "rwkv" in cfg.pattern else
                 f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
        print(f"{arch}: {cfg.num_layers} layers, d {cfg.d_model}, {heads}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab_padded()}, {n_params} params counted "
              f"(ModelConfig.num_params() says {cfg.num_params()}) in {model.dtype}, "
              f"built in {time.perf_counter() - t0:.2f} s")
        return model, params

    def serve(arch, cfg, policies=POLICIES, profiled=True, built=None,
              prompt_len=PROMPT_LEN, max_seq=MAX_SEQ):
        """Drain the workload (``requests(cfg, Request, prompt_len)``) on
        ``arch`` at full width under each of ``policies``, checking that each
        drain launches each kernel of the path once per attention or
        recurrent call of each prefill and decode step, and no other kernel
        or plain version, and that the policies' tokens are identical.  With
        ``profiled``, ``torch.profiler`` traces ``PROFILE_WINDOW``'s decode
        calls of the first policy's drain (``windowed``): the idle share,
        device functions and K3's device time a call are the window's, and
        the drain's wall leaves out the profiler's own start and stop.  The
        model is built from seed 0 unless ``built`` gives (model, params).
        Returns (model, params, metrics, the first policy's tokens)."""
        model, params = build(arch, cfg) if built is None else built
        reqs = lambda: requests(cfg, Request, prompt_len)  # noqa: E731

        def new_engine(policy):
            engine = ServingEngine(model, params, num_replicas=REPLICAS,
                                   max_seq=max_seq, policy=policy)
            for req in reqs():
                engine.submit(req)
            return engine

        want = path_launches(cfg, N_REQUESTS)
        want_k3 = PROFILE_WINDOW[1] * want.get("flash_attention", 0) // (
            N_REQUESTS * (1 + MAX_NEW))
        prompt_tokens = sum(len(r.tokens) for r in reqs())
        print(f"{arch} serving: {N_REQUESTS} requests, {prompt_tokens} prompt tokens "
              f"({prompt_len[0]}-{prompt_len[1]} a request), {MAX_NEW} new tokens each, "
              f"{REPLICAS} replicas, max_seq {max_seq}; want launches {want} per drain")
        # warm-up (cuBLAS handles, the caching allocator): one short request,
        # so the first policy's times are not the process's first calls
        warm = reqs()[0]
        warm.max_new = 2
        Replica(model, params, max_seq).run(warm)
        torch.cuda.synchronize()

        def drain(policy, traced):
            """One drain: (engine, requests served, wall s, launches, Timed
            prefill, Timed decode, the profile window or None)."""
            engine = new_engine(policy)
            prefill_t, decode_t = Timed(model.prefill), Timed(model.decode_step)
            win = windowed(decode_t, want_k3) if traced else None
            for rep in engine.replicas:
                rep._prefill, rep._decode = prefill_t, win or decode_t
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            done = engine.run_until_drained()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if win is not None:
                if win.spans is None and not win.lost:
                    fail(f"{arch}: the drain made {len(decode_t.ms)} decode calls, too few "
                         f"for the profile window {PROFILE_WINDOW}")
                if win.spans is None:
                    fail(f"{arch} profile window: every attempt lost K3 records: "
                         f"{win.lost}, want {want_k3} K3 calls")
                wall -= win.own_s
            return engine, done, wall, counts(), prefill_t, decode_t, win

        def read_window(win):
            """The idle share, device functions and K3 calls of a windowed
            drain's traced decode calls."""
            spans = win.spans
            busy = busy_ms(spans)
            if busy <= 0:
                fail(f"{arch} profile window: device busy {busy} ms")
            idle_share = 1 - busy / win.wall_ms
            k3_calls = kernel_calls(spans, "flash_attention")
            calls = [win.first, win.first + PROFILE_WINDOW[1] - 1]
            print(f"{arch} profile window (decode calls {calls[0]}-{calls[1]} of the "
                  f"{policies[0]} drain, attempt {win.attempts}): wall "
                  f"{win.wall_ms:.4f} ms, device busy {busy:.4f} ms, idle share "
                  f"{idle_share:.4f}; {len(spans)} device records, the profiler's start "
                  f"and stop {win.own_s:.2f} s (left out of the drain's wall); K3 "
                  f"{len(k3_calls)} calls (want {want_k3}), "
                  f"{call_summary(k3_calls)['mean_us']:.3f} us a call")
            if len(k3_calls) != want_k3:
                fail(f"{arch} profile window: {len(k3_calls)} K3 calls, want {want_k3}")
            print("device time by function over the profile window:")
            top = top_kernels(spans)
            print("\n".join(top))
            return {"idle_share": idle_share, "idle_share_over": "profile window",
                    "profile_window": {"decode_calls": calls, "attempts": win.attempts,
                                       "lost": win.lost,
                                       "wall_ms": win.wall_ms, "device_busy_ms": busy,
                                       "records": len(spans), "profiler_s": win.own_s,
                                       "k3": call_summary(k3_calls)},
                    "device_busy_ms": busy, "top_device_functions": top}

        outs, metrics, traced_result = {}, {}, {}
        for policy in policies:
            traced = profiled and policy == policies[0]
            engine, done, wall, launched, prefill_t, decode_t, win = drain(policy, traced)
            outs[policy] = {r.uid: tuple(r.out_tokens) for r in done}
            generated = sum(len(r.out_tokens) for r in done)
            m = {"wall_s": wall, "tokens_per_s": generated / wall,
                 "prefill_ms_per_request": float(np.mean(prefill_t.ms)),
                 "decode_ms_per_token": float(np.mean(decode_t.ms)),
                 "launches": launched, "stats": engine.stats, "profiled": traced}
            metrics[policy] = m
            print(f"{arch} {policy}: {engine.stats}, locality "
                  f"{engine.stats.locality_fraction:.3f}")
            print(f"{arch} {policy}{' (profiled)' if traced else ''}: wall {wall:.4f} s, "
                  f"{generated} tokens, {m['tokens_per_s']:.2f} tokens/s, prefill "
                  f"{m['prefill_ms_per_request']:.4f} ms per request, decode "
                  f"{m['decode_ms_per_token']:.4f} ms per token, launches {launched}")
            if not path_ok(launched, want):
                fail(f"{arch} {policy}: launches {launched}, want {want} and no "
                     f"other kernel or plain call")
            if len(done) != N_REQUESTS or generated != N_REQUESTS * MAX_NEW or \
                    not all(0 <= t < cfg.vocab_padded() for o in outs[policy].values()
                            for t in o):
                fail(f"{arch} {policy}: served {len(done)} requests, {generated} tokens")
            if traced:
                traced_result = read_window(win)
            del engine, win
        first = outs[policies[0]]
        if any(outs[p] != first for p in policies):
            fail(f"{arch}: the policies generated different tokens")
        print(f"{arch}: tokens identical across {policies}; request 0: "
              f"{list(first[0])}")
        result = {p: {k: v for k, v in m.items() if k != "stats"}
                  | {"stats": vars(m["stats"])} for p, m in metrics.items()}
        result.update(traced_result)
        return model, params, result, first

    def policies_cut(arch, cfg):
        """The three policies' drains of ``arch`` at POLICY_DEPTH layers,
        whose tokens must be identical (a cut, printed)."""
        cut = dataclasses.replace(cfg, num_layers=POLICY_DEPTH)
        model, params, metrics, _ = serve(arch, cut, profiled=False,
                                          prompt_len=serve_prompt_len(arch),
                                          max_seq=serve_max_seq(arch))
        del model, params
        free_device_memory()
        return metrics | {"layers": POLICY_DEPTH}

    def cut_line(arch, cfg):
        print(f"cut: {arch} round_robin and single_queue drains at "
              f"{POLICY_DEPTH} of {cfg.num_layers} layers (token identity across "
              f"{POLICIES} checked there); the locality drain at full depth")

    def teacher_forced(arch, cfg, model, params, faults=None, prompt_tokens=None):
        """The kernel path against the plain path (``use_kernel=False``) on
        request 0 (or a prompt of ``prompt_tokens`` tokens from numpy seed
        0), teacher-forced with the plain path's greedy tokens: the
        prefill's and every decode step's logits must agree within
        ``LOGITS_ATOL[arch]``.  Each of ``faults`` (name -> (module,
        attribute, a stand-in with a planted error), or a list of such)
        runs the plain path the same way with the stand-ins in place and
        must differ from it by more than the limit."""
        prompt = (requests(cfg, Request)[0].tokens if prompt_tokens is None else
                  np.random.default_rng(0).integers(0, cfg.vocab_size, prompt_tokens))
        toks = torch.as_tensor(prompt, dtype=torch.int64, device=dev)[None]
        plain_model = build_model(cfg, use_kernel=False)

        def run(m, forced=None):
            caches = m.init_cache(1, MAX_SEQ)
            logits, caches = m.prefill(params, {"tokens": toks}, caches)
            steps, chosen, pos = [logits[:, -1].float()], [], toks.shape[1]
            for i in range(MAX_NEW):
                cur = torch.argmax(logits[:, -1], dim=-1)[:, None]
                chosen.append(int(cur[0, 0]))
                if forced is not None:
                    cur = torch.full_like(cur, forced[i])
                logits, caches = m.decode_step(params, cur, pos, caches)
                steps.append(logits[:, -1].float())
                pos += 1
            return torch.cat(steps), chosen

        zero_counts()
        plain_logits, plain_chosen = run(plain_model)
        if any(n for name, n in counts().items() if not name.endswith("_plain_calls")):
            fail(f"the plain path launched a kernel: {counts()}")
        zero_counts()
        kern_logits, kern_chosen = run(model, forced=plain_chosen)
        if not path_ok(counts(), path_launches(cfg, 1)):
            fail(f"the teacher-forced kernel path launched {counts()}")
        diff = (kern_logits - plain_logits).abs().amax(dim=-1)
        agree = sum(a == b for a, b in zip(kern_chosen, plain_chosen))
        limit = LOGITS_ATOL[arch]
        print(f"{arch} teacher-forced logits in {model.dtype}, kernel vs plain path "
              f"({toks.shape[1]} prompt tokens, {1 + MAX_NEW} steps, |logits| up "
              f"to {float(plain_logits.abs().max()):.3f}): max_abs_err "
              f"{float(diff.max()):.6f} (prefill {float(diff[0]):.6f}), limit "
              f"{limit}; greedy choices agree {agree}/{MAX_NEW}")
        fault_gaps = {}
        for name, patches in (faults or {}).items():
            patches = patches if isinstance(patches, list) else [patches]
            sound = [(module, attr, getattr(module, attr)) for module, attr, _ in patches]
            for module, attr, fn in patches:
                setattr(module, attr, fn)
            try:
                fault_logits, _ = run(plain_model, forced=plain_chosen)
            finally:
                for module, attr, fn in reversed(sound):
                    setattr(module, attr, fn)
            fault_gaps[name] = float((fault_logits - plain_logits).abs().max())
            print(f"{arch} planted fault ({name}) vs plain path: max_abs_err "
                  f"{fault_gaps[name]:.6f}, {fault_gaps[name] / limit:.1f}x the limit")
        if not bool(kern_logits.isfinite().all()) or float(diff.max()) > limit:
            fail(f"{arch}: kernel path logits disagree with the plain path: "
                 f"{diff.tolist()}")
        if any(gap <= limit for gap in fault_gaps.values()):
            fail(f"{arch}: the limit {limit} would not see a planted fault: {fault_gaps}")
        del plain_model
        return {"teacher_forced_dtype": str(model.dtype).split(".")[-1],
                "teacher_forced_max_abs_err": float(diff.max()),
                "teacher_forced_limit": limit, "greedy_agree": agree,
                "planted_faults": fault_gaps}

    stamp(4)
    serving = {}
    print("cut: phases 4 and 5f profile the locality drain itself (no separate profiled "
          f"drain), and only its decode calls {PROFILE_WINDOW[0]}-"
          f"{sum(PROFILE_WINDOW) - 1} (a profile window, not the whole drain): their idle "
          "shares and K3's device time a call are the window's, and no prefill is traced")
    cut_line(QWEN, cfg)
    model, params, serving[QWEN], _ = serve(QWEN, cfg, policies=("locality",))
    serving[QWEN].update(teacher_forced(QWEN, cfg, model, params))
    del model, params
    free_device_memory()
    stamp("4b")
    # the three policies and the controlled drains at POLICY_DEPTH layers,
    # each against the locality drain at that depth
    print(f"cut: {QWEN}'s control-built and spec-built drains at {POLICY_DEPTH} of "
          f"{cfg.num_layers} layers, against the locality drain at "
          f"that depth")
    cut = dataclasses.replace(cfg, num_layers=POLICY_DEPTH)
    model, params, metrics, cut_tokens = serve(QWEN, cut, profiled=False)
    serving[QWEN]["policies_cut_depth"] = metrics | {"layers": POLICY_DEPTH}
    serving[QWEN]["controlled"] = controlled_drains(
        model, params, cut, cut_tokens, path_launches(cut, N_REQUESTS), counts, zero_counts)
    del model, params
    free_device_memory()

    stamp(5)
    cut_line(RWKV, rcfg)
    print(f"cut: {RWKV}'s locality drain runs without torch.profiler (its idle share and "
          f"K4's device time in the drain are not measured; phase 6 times K4 at its "
          f"prefill and decode shapes)")
    model, params, serving[RWKV], _ = serve(RWKV, rcfg, policies=("locality",),
                                            profiled=False)
    # K4 on a decode step from the state a real prefill left in the cache
    caches = model.init_cache(1, MAX_SEQ)
    toks = torch.as_tensor(requests(rcfg, Request)[0].tokens, device=dev)[None]
    model.prefill(params, {"tokens": toks}, caches)
    for layer in (0, rcfg.num_layers - 1):
        s0 = caches[layer]["s"]
        r, k, v, w, u = wkv_model_inputs(1)
        k4_check(f"bf16 decode from layer {layer}'s prefill state (|s| max "
                 f"{float(s0.abs().max()):.3f})",
                 wkv6_cuda(r, k, v, w, u, chunk=1, s0=s0.clone()),
                 wkv6_ref(r, k, v, w, u, s0))
    torch.cuda.synchronize()
    if k4_worst > 1.0:
        fail(f"K4 disagrees with wkv6_ref: an error used {k4_worst:.3f} of its limit")
    del model, params, caches
    free_device_memory()
    serving[RWKV]["policies_cut_depth"] = policies_cut(RWKV, rcfg)
    # the teacher-forced comparison on an f32 build, with two planted faults
    f32cfg = dataclasses.replace(rcfg, dtype="float32")
    model, params = build(RWKV, f32cfg)
    faults = {
        "u dropped": (wkv_ops, "wkv6_ref", lambda r, k, v, w, u, s0=None: wkv6_ref(
            r, k, v, w, torch.zeros_like(u), s0)),
        "state not carried": (wkv_ops, "wkv6_ref",
                              lambda r, k, v, w, u, s0=None: wkv6_ref(r, k, v, w, u))}
    serving[RWKV].update(teacher_forced(RWKV, f32cfg, model, params, faults))
    del model, params
    free_device_memory()

    stamp("5b")
    cut_line(GRIFFIN, gcfg)
    print(f"cut: {GRIFFIN}'s locality drain runs without torch.profiler (its idle share "
          f"and K5's and K3's device time in the drain are not measured; phase 6 times "
          f"them at its prefill and decode shapes)")
    model, params, serving[GRIFFIN], _ = serve(GRIFFIN, gcfg, policies=("locality",),
                                               profiled=False)
    # K5 on a decode step from the state a real prefill left in the cache
    toks = torch.as_tensor(requests(gcfg, Request)[0].tokens, device=dev)[None]
    _, caches = model.prefill(params, {"tokens": toks}, model.init_cache(1, MAX_SEQ))
    kinds = gcfg.layer_kinds()
    rglru_layers = [i for i, kind in enumerate(kinds) if kind == "rglru"]
    for layer in (rglru_layers[0], rglru_layers[-1]):
        h0 = caches[layer]["h"].float()
        a, bx = rglru_model_inputs(1)
        k5_check(f"f32 decode from layer {layer}'s prefill state (|h| max "
                 f"{float(h0.abs().max()):.3f})",
                 rglru_scan_cuda(a, bx, chunk=1, h0=h0), rglru_scan_ref(a, bx, h0))
    torch.cuda.synchronize()
    if k5_unequal:
        fail(f"K5 differs from rglru_scan_ref in {k5_unequal} elements")
    del model, params, caches
    free_device_memory()
    serving[GRIFFIN]["policies_cut_depth"] = policies_cut(GRIFFIN, gcfg)
    # the teacher-forced comparison on an f32 build, with two planted faults,
    # once every earlier model is freed
    torch.cuda.reset_peak_memory_stats()
    f32cfg = dataclasses.replace(gcfg, dtype="float32")
    model, params = build(GRIFFIN, f32cfg)
    conv = rglru_model._causal_conv
    faults = {
        "RG-LRU state not carried": (rglru_ops, "rglru_scan_ref",
                                     lambda a, b, h0=None: rglru_scan_ref(a, b)),
        "conv history not carried": (rglru_model, "_causal_conv",
                                     lambda x, w, b, state=None: conv(x, w, b))}
    serving[GRIFFIN].update(teacher_forced(GRIFFIN, f32cfg, model, params, faults))
    peak = torch.cuda.max_memory_allocated()
    print(f"{GRIFFIN} f32 build: peak device memory {peak} B ({peak / 1e9:.2f} GB)")
    serving[GRIFFIN]["f32_peak_bytes"] = peak
    del model, params
    free_device_memory()

    stamp("5c")
    # qwen3-moe-30b-a3b whole in bf16, once every earlier model is freed
    qcfg = get_config(QWEN3)
    cut_line(QWEN3, qcfg)
    print(f"cut: {QWEN3}'s locality drain runs without torch.profiler (its idle share is "
          f"not measured; the MoE block's device time is split below by CUDA events, and "
          f"phase 6 times K3 at its shapes)")
    torch.cuda.reset_peak_memory_stats()
    model, params, serving[QWEN3], _ = serve(QWEN3, qcfg, policies=("locality",),
                                             profiled=False)
    peak = torch.cuda.max_memory_allocated()
    print(f"{QWEN3} bf16, served whole: peak device memory {peak} B ({peak / 1e9:.2f} GB)")
    serving[QWEN3]["peak_bytes"] = peak
    serving[QWEN3]["moe_split"] = moe_split(
        params, qcfg, dev, sorted(len(r.tokens) for r in requests(qcfg, Request)), gen)
    del model, params
    free_device_memory()
    serving[QWEN3]["policies_cut_depth"] = policies_cut(QWEN3, qcfg)
    # the teacher-forced comparison on an f32 build of its first layers, with
    # two planted faults in the MoE block of the plain path
    f32cfg = dataclasses.replace(qcfg, dtype="float32", num_layers=QWEN3_F32_LAYERS)
    print(f"{QWEN3} f32 build: cut to {QWEN3_F32_LAYERS} of {qcfg.num_layers} layers "
          f"(122 GB whole in f32)")
    model, params = build(QWEN3, f32cfg)
    route, products = moe_model.route, moe_model.expert_products

    def unnormalised(p, xg, c):
        gates, _, topi = route(p, xg, c)
        return gates, torch.gather(gates, -1, topi), topi

    def next_expert(p, plan):
        if "idx" in plan:
            plan = dict(plan, idx=(plan["idx"] + 1) % f32cfg.moe.num_experts)
        return products(p, plan)

    faults = {"top-k weights not renormalised": (moe_model, "route", unnormalised),
              "decode gathers the next expert's weights": (moe_model, "expert_products",
                                                           next_expert)}
    with RoutingLog() as log:
        serving[QWEN3].update(teacher_forced(QWEN3, f32cfg, model, params, faults))
    calls = QWEN3_F32_LAYERS * (1 + MAX_NEW)
    flips = routes_differ(log.calls[:calls], log.calls[calls:2 * calls])
    print(f"{QWEN3} teacher-forced: (token, layer) routing choices that differ between "
          f"the kernel and the plain path: {flips} of "
          f"{sum(x.shape[0] for x in log.calls[:calls])}")
    serving[QWEN3]["teacher_forced_routes_differ"] = flips
    del model, params
    free_device_memory()

    # -- 5d, 5f, 5g: the other configurations ----------------------------------
    # 5g's CPU runs of the serving driver go on in a process of their own
    # from here, while the card serves
    cli_cpu_path = pathlib.Path(tempfile.mkdtemp()) / "serve_cpu.json"
    cli_cpu = multiprocessing.get_context("spawn").Process(
        target=cpu_serve_runs, args=(str(cli_cpu_path),), daemon=True)
    cli_cpu.start()

    def serve_arch(arch, acfg, model, params):
        """Phase 5f's ``locality`` drain of ``arch`` on the model built for
        it (``acfg``, cut to SERVE_DEPTH[arch]): 12 requests of 32 new
        tokens, K3 exactly ``drain_k3_launches(acfg)`` times and no plain
        attention, profiled when the model is whole, with its peak device
        memory."""
        stamp(f"5f {arch}")
        whole = get_config(arch).num_layers
        if acfg.num_layers != whole:
            print(f"cut: {arch} served at {acfg.num_layers} of {whole} layers (the whole "
                  f"model does not fit on one card)")
        if arch in SERVE_PROMPT_LEN:
            print(f"cut: {arch} prompts of {serve_prompt_len(arch)[0]}-"
                  f"{serve_prompt_len(arch)[1]} tokens (seed 0, as phase 4's 128-1024), "
                  f"max_seq {serve_max_seq(arch)}: its decoder's {WHISPER_CONTEXT} "
                  f"positions hold the prompt and {MAX_NEW} new tokens")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, m, _ = serve(arch, acfg, policies=("locality",),
                           profiled=acfg.num_layers == whole, built=(model, params),
                           prompt_len=serve_prompt_len(arch), max_seq=serve_max_seq(arch))
        peak = torch.cuda.max_memory_allocated()
        own = peak - held_before
        loc = m["locality"]
        want = drain_k3_launches(acfg)
        print(f"{arch} 5f drain ({acfg.num_layers} of {whole} layers): wall "
              f"{loc['wall_s']:.4f} s, {loc['tokens_per_s']:.2f} tokens/s, prefill "
              f"{loc['prefill_ms_per_request']:.4f} ms per request, decode "
              f"{loc['decode_ms_per_token']:.4f} ms per token, peak device memory {own} B "
              f"({own / 1e9:.2f} GB; {peak / 1e9:.2f} GB with the {held_before / 1e9:.2f} GB "
              f"this script holds from earlier phases)"
              + (f", idle share {m['idle_share']:.4f} over the profile window"
                 if "idle_share" in m else "")
              + f", K3 {loc['launches']['flash_attention']} launches (want {want}), plain "
              f"attention {loc['launches']['attention_plain_calls']} [{card}]")
        if loc["launches"]["flash_attention"] != want or \
                loc["launches"]["attention_plain_calls"]:
            fail(f"{arch} 5f drain: launches {loc['launches']}, want {want} K3 and no "
                 f"plain attention")
        drains[arch] = m | {"layers": acfg.num_layers, "cut_from": whole,
                            "peak_bytes": own, "peak_bytes_with_script": peak,
                            "k3_launches_want": want,
                            "prompt_len": serve_prompt_len(arch),
                            "max_seq": serve_max_seq(arch)}

    drains: dict = {}
    # what the script itself holds on the card from here (the paper's
    # lattice among it), taken out of each drain's peak
    held_before = torch.cuda.memory_allocated()
    stamp("5d")
    serving["other_architectures"] = other_archs(dev, build, counts, zero_counts, OTHER_ATOL,
                                                 then=serve_arch)

    # gemma3-1b and qwen2-1.5b whole: the drain, then the teacher-forced
    # comparison on a 1000-token prompt, with two planted faults each in the
    # plain path
    causal_mask, decode_attn = attn_model._causal_mask, attn_model.decode_attention
    direct_attn, rope = attn_model.direct_attention, attn_model.apply_rope

    def ring_slots_as_positions(q, k_cache, v_cache, cache_len, ring=False, window=0):
        """``decode_attention`` with a ring's slots read as positions in the
        window (slot > pos - window), the mistake P10 avoids for K3."""
        if not ring:
            return decode_attn(q, k_cache, v_cache, cache_len, ring, window)
        slot = torch.arange(k_cache.shape[1], device=q.device)
        keep = (slot < cache_len) & (slot > cache_len - 1 - window)
        return decode_attn(q, k_cache[:, keep], v_cache[:, keep], int(keep.sum()))

    def kv_head_mod(fn):
        """``fn`` (direct or decode attention) with query head h reading kv
        head h % Hkv instead of h // group."""
        def wrong(q, k, *rest, **kw):
            b, t, h, _ = q.shape
            kvh = k.shape[2]
            g = h // kvh
            perm = torch.tensor([i * kvh + j for j in range(kvh) for i in range(g)],
                                device=q.device)
            out = fn(q[:, :, perm], k, *rest, **kw)
            return out.reshape(b, t, h, -1)[:, :, torch.argsort(perm)].reshape(b, t, -1)
        return wrong

    def rope_off_k():
        """``apply_rope`` that leaves every second call's input (the
        attention block's k, after its q) unrotated."""
        calls = itertools.count()
        return lambda x, positions, theta: (rope(x, positions, theta)
                                            if next(calls) % 2 == 0 else x)

    def tf_faults(arch):
        """Two planted faults in the plain path of ``arch``, as fresh
        stand-ins (the rope fault counts its calls)."""
        if arch == GEMMA:
            return {"local layers' window dropped at prefill": (
                        attn_model, "_causal_mask",
                        lambda tq, tk, q_offset, window=0, device=None:
                        causal_mask(tq, tk, q_offset, 0, device=device)),
                    "ring decode reads its slots as positions in the window": (
                        attn_model, "decode_attention", ring_slots_as_positions)}
        return {"kv head h % Hkv instead of h // group": [
                    (attn_model, "direct_attention", kv_head_mod(direct_attn)),
                    (attn_model, "decode_attention", kv_head_mod(decode_attn))],
                "rope left off k": (attn_model, "apply_rope", rope_off_k())}

    stamp("5f")
    for arch in (GEMMA, QWEN15):
        acfg = serve_config(arch)
        model, params = build(arch, acfg)
        serve_arch(arch, acfg, model, params)
        drains[arch].update(teacher_forced(arch, acfg, model, params, tf_faults(arch),
                                           prompt_tokens=TF_PROMPT))
        del model, params
        free_device_memory()

    # the three policies of each, at POLICY_DEPTH layers: identical tokens.
    # The commands of 5g, 7i and 9a and 9c's count run in the background
    # from here (on the host's other cores; none of them is timed)
    stamp("5f policies")
    commands = {"serve": start_command(
        ["-m", "repro_torch.launch.serve", "--arch", CLI_SUBPROCESS_ARCH])}
    for arch in (RWKV, GRIFFIN):
        commands[arch] = start_command(["-m", "repro_torch.launch.train", "--arch", arch,
                                        "--smoke", "--steps", str(CLI_STEPS)])
    dryrun_started = start_dryrun()
    print(f"5g's, 7i's and 9a's commands and 9c's count of the plain steps started in the "
          f"background: {[c[0] for c in (*commands.values(), dryrun_started['dryrun'])]}")
    for arch in SERVE_DEPTH:
        print(f"cut: {arch} locality, round_robin and single_queue drains at "
              f"{POLICY_DEPTH} of {get_config(arch).num_layers} layers (kinds "
              f"{serve_config(arch, POLICY_DEPTH).layer_kinds()}), for token identity "
              f"across {POLICIES}")
        drains[arch]["policies_cut_depth"] = policies_cut(arch, get_config(arch))
    serving.update(drains)

    stamp("5g")
    serving["serve_cli"] = serve_cli_phase(card, cli_cpu, cli_cpu_path, commands["serve"])

    stamp("5e")
    long_plain = long_prefill(gen, dev, k3_check)
    torch.cuda.synchronize()
    if k3_worst > 1.0:
        fail(f"the plain long prefill disagrees with K3: an element used {k3_worst:.3f} "
             f"of its limit")

    # -- 6. timing ---------------------------------------------------------
    stamp(6)
    sites = f.numel()
    io_bytes = 2 * 4 * sites                     # read f once, write once
    jb = {"jacobi_sweep": bound(io_bytes, k12_kernel.flops_per_site() * sites,
                                F32_FLOPS_PER_S),
          "jacobi_two_step": bound(io_bytes, k12_kernel.flops_per_site(True) * sites,
                                   F32_FLOPS_PER_S)}
    buf = torch.empty_like(f)
    ms = {"jacobi_sweep": time_ms(lambda: jacobi_sweep_cuda(f, out=buf), 20),
          "jacobi_two_step": time_ms(lambda: jacobi_two_step_cuda(f, out=buf), 20)}
    plain_ms = {"jacobi_sweep": time_ms(lambda: ref.jacobi_sweep_ref(f), 5),
                "jacobi_two_step": time_ms(lambda: ref.jacobi_two_step_ref(f), 3)}

    # library yardstick: one cuDNN conv3d with the six-point cross (two for
    # the two-step), TF32 off
    w = torch.zeros((1, 1, 3, 3, 3), device=dev)
    for i, j, k in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0), (1, 1, 2)):
        w[0, 0, i, j, k] = 1 / 6
    x = f.view(1, 1, *LATTICE)
    conv = torch.nn.functional.conv3d
    e_conv = max_err(conv(x, w, padding=1)[0, 0], ref.jacobi_sweep_ref(f))
    library_ms = {"jacobi_sweep": time_ms(lambda: conv(x, w, padding=1), 5),
                  "jacobi_two_step": time_ms(
                      lambda: conv(conv(x, w, padding=1), w, padding=1), 3)}
    print(f"library conv3d (cudnn.allow_tf32=False): max_abs_err vs plain {e_conv:.3e}")

    # one slab launch of the runtime sweep: 10 rows straight from the
    # lattice into their place.  Each timed call takes the next of slabs 1-
    # 99 (rows 10-1000), so its 17 MB of input do not sit in the 50 MB L2
    # from the call before, as they do not in the runtime sweep.  Bound: the
    # rows read once and written once (8 B a site); yardstick: conv3d over
    # the rows and their halo planes
    slab_sites = SLAB_ROWS * LATTICE[1] * LATTICE[2]
    slab_bound = bound(8 * slab_sites, k12_kernel.flops_per_site() * slab_sites,
                       F32_FLOPS_PER_S)
    starts = itertools.cycle(range(SLAB_ROWS, 100 * SLAB_ROWS, SLAB_ROWS))

    def halo_of(r):
        return f[r - 1:r + SLAB_ROWS + 1]

    def slab_call():
        r = next(starts)
        jacobi_sweep_cuda(f, di=SLAB_ROWS, dj=LATTICE[1], out=buf[r:r + SLAB_ROWS],
                          rows=(r, r + SLAB_ROWS))

    def slab_conv(r=None):
        h = halo_of(next(starts) if r is None else r)
        return conv(h.view(1, 1, *h.shape), w, padding=(0, 1, 1))

    e_slab = max_err(slab_conv(SLAB_ROWS)[0, 0],
                     ref.jacobi_sweep_ref(halo_of(SLAB_ROWS))[1:-1])
    slab = {"rows": SLAB_ROWS, "ms": queued_us(slab_call) / 1e3,
            "ms_back_to_back": time_ms(slab_call, 50),
            "plain_ms": queued_us(
                lambda: ref.jacobi_sweep_ref(halo_of(next(starts)))[1:-1], 20) / 1e3,
            "bound_ms": slab_bound[0], "bound_by": slab_bound[1],
            "library_ms": queued_us(slab_conv) / 1e3}

    # the runtime sweep (host-driven, 240 launches), from the kwargs and from
    # the spec: CUDA events around the whole drain, then one drain under the
    # profiler for K1's device time and the card's idle share
    from repro_torch import spec as port_spec
    from torch.profiler import ProfilerActivity, profile

    def timed_sweep(label, **kw):
        sweep_ms = time_ms(lambda: run_runtime_sweep(f, di=di, **kw), 3, warmup=1)
        for attempt in range(3):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                warm_profiler()
                t0 = time.perf_counter()
                run_runtime_sweep(f, di=di, **kw)
                torch.cuda.synchronize()
                prof_wall_ms = (time.perf_counter() - t0) * 1e3
            spans = drop_warmup(device_spans(prof))
            k1_spans = [(e - st) / 1e6 for name, st, e in spans
                        if "jacobi_sweep_kernel" in name]
            print(f"profiled {label}, attempt {attempt + 1}: {len(k1_spans)} of "
                  f"{nslabs} K1 launches recorded")
            if len(k1_spans) == nslabs:
                break
        else:
            fail(f"profiled {label}: {len(k1_spans)} K1 records, want {nslabs}")
        busy = busy_ms(spans)
        return {"wall_ms": sweep_ms, "profiled_wall_ms": prof_wall_ms,
                "device_ms": sum(k1_spans), "device_busy_ms": busy,
                "idle_share": 1 - busy / prof_wall_ms, "k1_records": len(k1_spans)}

    runtime = timed_sweep("runtime sweep", num_domains=domains, workers_per_domain=wpd)
    spec_runtime = timed_sweep(f"spec-built runtime sweep ({SPEC_SWEEP})",
                               spec=port_spec.named(SPEC_SWEEP))
    sweep_ms, prof_wall_ms, busy = (runtime["wall_ms"], runtime["profiled_wall_ms"],
                                    runtime["device_busy_ms"])

    before = JACOBI_BEFORE
    for name in ("jacobi_sweep", "jacobi_two_step"):
        gbs = io_bytes / (ms[name] * 1e-3) / 1e9
        print(f"{name} {LATTICE}: {ms[name]:.4f} ms (PR 16: {before[name + '_ms']} ms, "
              f"{before[name + '_ms'] / ms[name]:.2f}x), {gbs:.1f} GB/s, bound "
              f"{jb[name][0]:.4f} ms ({jb[name][0] / ms[name]:.1%} of bound), "
              f"plain {plain_ms[name]:.4f} ms, library {library_ms[name]:.4f} ms")
    print(f"jacobi_sweep slab of {SLAB_ROWS} rows of {LATTICE}: {slab['ms'] * 1e3:.2f} us of "
          f"device time a launch (queued), {slab['ms_back_to_back'] * 1e3:.2f} us back to "
          f"back (PR 16: {before['slab_us']} us, timed back to back), bound "
          f"{slab['bound_ms'] * 1e3:.2f} us ({slab['bound_ms'] / slab['ms']:.1%} of bound), "
          f"plain {slab['plain_ms'] * 1e3:.2f} us, library conv3d "
          f"{slab['library_ms'] * 1e3:.2f} us (max_abs_err vs plain {e_slab:.3e})")
    print(f"run_runtime_sweep: wall {sweep_ms:.4f} ms (PR 16: {before['runtime_sweep_ms'][0]}"
          f"; {before['runtime_sweep_ms'][1]} ms), bound {jb['jacobi_sweep'][0]:.4f} ms "
          f"({jb['jacobi_sweep'][0] / sweep_ms:.1%} of bound); profiled: wall "
          f"{prof_wall_ms:.4f} ms, K1 device time {runtime['device_ms']:.4f} ms in "
          f"{nslabs} launches ({runtime['device_ms'] / nslabs * 1e3:.2f} us each; "
          f"PR 16: 7.03 ms), device busy {busy:.4f} ms, idle share "
          f"{runtime['idle_share']:.4f}")
    print(f"run_runtime_sweep(spec={SPEC_SWEEP!r}): wall {spec_runtime['wall_ms']:.4f} ms "
          f"(kwargs path {sweep_ms:.4f} ms); profiled: wall "
          f"{spec_runtime['profiled_wall_ms']:.4f} ms, K1 device time "
          f"{spec_runtime['device_ms']:.4f} ms in {nslabs} launches, device busy "
          f"{spec_runtime['device_busy_ms']:.4f} ms, idle share "
          f"{spec_runtime['idle_share']:.4f} (kwargs path {runtime['idle_share']:.4f})")
    del f, buf, x

    # K3 at the serving path's shapes
    k3 = {}
    for name, tq, tk, qo in K3_SHAPES:
        plan = dataclasses.asdict(k3_plan((hq, hkv, hd), tq, tk, qo))
        k3[name] = time_k3(f"{name} (plan {plan})", *k3_inputs[name][:3], q_offset=qo)

    # K4 at rwkv6-3b's shapes, from a carried state written in place as the
    # model does (no PyTorch call computes the WKV recurrence: no yardstick)
    k4 = {}
    for name, t in K4_SHAPES:
        r, k, v, w, u = k4_inputs[name]
        s0 = prefill_state.clone()
        bnd, by = k4_bound(1, t, rh, rhd)
        k4[name] = {
            "ms": device_ms(lambda: wkv6_cuda(r, k, v, w, u, chunk=t, s0=s0)),
            "plain_ms": device_ms(lambda: wkv6_ref(r, k, v, w, u, s0), 3),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}
        m, before = k4[name], BEFORE_MS["wkv6"][name]
        print(f"wkv6 {name} {(1, t, rh, rhd)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms "
              f"by {by} ({bnd / m['ms']:.2%} of bound), previous design "
              f"{before:.4f} ms ({before / m['ms']:.2f}x), plain "
              f"{m['plain_ms']:.4f} ms, library: none (no PyTorch call computes the "
              f"WKV recurrence)")

    # K5 at recurrentgemma-9b's width, from a carried state as the model calls
    # it (no single PyTorch call computes a linear recurrence: no yardstick).
    # Bound: a and b read once and h written once, 12 B per element, plus the
    # state read, over HBM; 2 f32 flops per element
    k5 = {}
    for name, t in K5_SHAPES:
        a, bx, h0 = k5_inputs[name]
        bnd, by = bound(12 * t * gw + 4 * gw, rglru_kernel.FWD_FLOPS * t * gw,
                        F32_FLOPS_PER_S)
        k5[name] = {
            "ms": device_ms(lambda: rglru_scan_cuda(a, bx, chunk=t, h0=h0)),
            "plain_ms": device_ms(lambda: rglru_scan_ref(a, bx, h0), 3),
            "bound_ms": bnd, "bound_by": by, "library_ms": None}
        m, before = k5[name], BEFORE_MS["rglru"][name]
        print(f"rglru {name} {(1, t, gw)}: {m['ms']:.4f} ms, bound {bnd:.6f} ms by {by} "
              f"({bnd / m['ms']:.2%} of bound), previous design {before:.4f} ms "
              f"({before / m['ms']:.2f}x), plain {m['plain_ms']:.4f} ms, "
              f"library: none (no PyTorch call computes the recurrence)")

    # K3 at recurrentgemma-9b's hd-256 shapes (prefill with window 2048), and
    # at the new architectures' shapes (without a mask where K3 runs without)
    k3g = {}
    for name, tq, tk, qo, win in K3_GRIFFIN_SHAPES:
        plan = dataclasses.asdict(k3_plan((ghq, ghkv, ghd), tq, tk, qo, win))
        k3g[name] = time_k3(f"hd {ghd} {name} (plan {plan})", *k3g_inputs[name][:3],
                            q_offset=qo, window=win)
    k3n = {}
    for (arch, name), (q, k, v, qo, causal) in k3n_inputs.items():
        k3n[f"{arch} {name}"] = time_k3(
            f"{arch} {name} q {tuple(q.shape)} kv {tuple(k.shape)} causal={causal}",
            q, k, v, q_offset=qo, causal=causal)

    # -- 7. training: K3's backward, the train step, the trainer, resume --
    training, k3_backward = train_phase(dev, card)
    recurrent = recurrent_backward_phase(dev, card)
    training["archs"] = arch_phase(dev, card, commands)
    training["donation"] = donation_check(dev, card)
    stamp("7k")
    training["archs_7k"] = archs_train_phase(dev, card)
    training["recurrent_backward"] = {k: recurrent[k] for k in (
        "wkv6_backward", "rglru_scan_backward")}

    # -- 8. distribution and the example twins ----------------------------
    stamp(8)
    distribution = distribution_phase(dev, card, counts, zero_counts)

    # -- 9. the dry run and the roofline counter ---------------------------
    stamp(9)
    roofline = dryrun_phase(dev, card, dryrun_started)

    # -- 10. result lines -------------------------------------------------
    stamp(10)
    kernels = []
    for name, replaces, path, path_launches in (
            ("jacobi_sweep", "src/repro/kernels/jacobi/kernel.py:32",
             "run_runtime_sweep", main_launches),
            ("jacobi_two_step", "src/repro/kernels/jacobi/temporal.py:45",
             "jacobi_iterate", iter_launches)):
        kernels.append({
            "name": name, "route": "cuda", "source": "src/repro_torch/csrc/jacobi.cu",
            "replaces": replaces, "path": path,
            "launches": path_launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": jb[name][0],
            "bound_by": jb[name][1], "library_ms": library_ms[name],
            "unequal_elements": unequal[name]})
    # K1's main path launches it on slabs: the slab shape and the whole drain;
    # the spec-built sweep and the SPMD sweeps launch it too
    kernels[0].update(slab=slab, runtime_sweep=runtime,
                      spec_runtime_sweep=spec_main | spec_runtime, spmd=spmd,
                      launches_by_path={
                          "run_runtime_sweep": main_launches["jacobi_sweep"],
                          f"run_runtime_sweep(spec={SPEC_SWEEP})": spec_main["launches"],
                          "make_contiguous_sweep": spmd["contiguous"]["launches"],
                          "make_scattered_sweep": spmd["scattered"]["launches"],
                          "examples/torch_trace_stencil.py": distribution["twins"][
                              "trace_stencil"]["launches"]["jacobi_sweep"],
                          "examples/torch_stencil_locality.py (1 NCCL rank)": sum(
                              distribution["twins"]["stencil_locality"]["k1_launches"][0]
                              .values())})
    for name, source, replaces, arch, worst, shapes, headline in (
            ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:26", QWEN, k3_worst, k3,
             K3_HEADLINE),
            ("wkv6", "src/repro_torch/csrc/wkv6.cu",
             "src/repro/kernels/rwkv6/kernel.py:27", RWKV, k4_worst, k4, K4_HEADLINE),
            ("rglru", "src/repro_torch/csrc/rglru.cu",
             "src/repro/kernels/rglru/kernel.py:23", GRIFFIN, float(k5_unequal), k5,
             K5_HEADLINE)):
        head = shapes[headline]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "path": f"ServingEngine.run_until_drained ({arch}, locality)",
            "launches": serving[arch]["locality"]["launches"][name],
            "max_abs_err": errs[name], "limit_share": worst, "shape": headline,
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": shapes})
    # K3 also carries recurrentgemma-9b's local layers, at head dim 256
    kernels[2].update(launches_by_path={
        **{arch: serving[arch]["locality"]["launches"]["flash_attention"]
           for arch in (QWEN, GRIFFIN, QWEN3, *SERVE_DEPTH)},
        **{f"examples/torch_{name}.py": distribution["twins"][name]["launches"][
            "flash_attention"] for name in ("serve_router", "control_serving")},
        "sharded train step (1, 1) mesh": distribution["sharded_train_step"]["sharded"][
            "k3_forward"],
        "seq_parallel_attention shards": sum(
            r["launches"] for r in distribution["seq_parallel_shards"].values()),
        **{f"Trainer.run (7k, {arch}, {t['layers']} layers)": t["launches"]["flash_attention"]
           for arch, t in training["archs_7k"]["trainers"].items() if "launches" in t}},
        shapes_hd256=k3g, shapes_new=k3n, plain_long_prefill_vs_k3=long_plain)
    kernels.append(k3_backward | {"launches_by_path": {
        "Trainer.run (phase 7d)": k3_backward["launches"],
        "sharded train step (1, 1) mesh": distribution["sharded_train_step"]["sharded"][
            "k3_backward"],
        **{f"Trainer.run (7k, {arch}, {t['layers']} layers)":
           t["launches"]["flash_attention_backward"]
           for arch, t in training["archs_7k"]["trainers"].items() if "launches" in t}}})
    for name, arch in (("wkv6_backward", RWKV), ("rglru_scan_backward", GRIFFIN)):
        trained = training["archs"][arch]["trainer"]
        kernels.append({**recurrent[name], "launches": trained["launches"][name],
                        "path": f"Trainer.run ({arch}, {trained['layers']} layers, "
                                f"{trained['steps']} steps of {trained['batch']} x "
                                f"{trained['seq']})"})
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"distribution": distribution}))
    print(json.dumps({"roofline": roofline}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
