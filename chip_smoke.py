#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing one JSON line:

1. device   nvidia-smi name and power limit, torch and nvcc versions;
2. build    nvcc build of every kernel source (sm_90a), one nvcc per source
            all started together, with ptxas's register / shared-memory /
            spill lines and the build seconds;
3. kernel   each kernel against its plain PyTorch version, with the times
            of the kernel, the plain version and one library call beside
            the bound: ``*_ms`` CUDA events around back-to-back calls from
            Python (the host's launch overhead included), ``*_device_ms``
            the device time per call (CUDA events around calls queued
            behind a spin kernel, so no host gap falls between them),
            L2-warm (B5 / B6 also at the decode gate's widths 5120 and
            7168):
            - fused_gate at B=8, C=128 (merge off) and C=64 (merge on),
              D=1152, bf16, blend on and off, half the samples gating, on
              the wgmma route (bf16 X against the bf16 copy of W): gate
              bits exact, diff/prevsq within rtol 1e-4, out within 2e-2,
              repeated calls bitwise; the same inputs on the SIMT route
              (``gemm="simt"``, bf16 X against the f32 W) within 2e-2,
              gate bits exact, timed (``simt_bf16_*``); and on the
              wgmma_split route (bf16 X against W split into three bf16
              terms, as fitted maps are served): gate bits, diff and prevsq
              exactly the SIMT route's, out within 2e-2 and 1e-3 rel-L2,
              repeated calls bitwise, and on a planted copy whose three
              terms are independent (``planted_split``: dropping a term
              would read ~0.5 rel-L2) within 2e-2 and 1e-3 rel-L2 of the
              plain version on their sum, timed (``split_*``) in a row of
              its own; library: torch.addmm of (B*C, D)x(D, D) in f32, the
              same in bf16 (X and the bf16 W: the kernel's operand
              precision), and in bf16 over the gated samples' rows only
              (the rows the kernel multiplies);
            - knn_density, merge_assign and unmerge_scatter at the merged
              slice's shapes (W=128 windows of w=16, D=1152, K=5, M=8, f32
              scores): knn_density and merge_assign in bf16 on the mma route
              (the Gram on the tensor cores) and on the same values in f32
              on the SIMT route, each row naming its ``window_route`` with
              that kernel's ptxas lines (no spills); knn_density within
              rtol/atol 1e-4, centers and assign exact, merged within 5e-2
              in bf16 and 1e-4 in f32, unmerge bitwise (bf16); library:
              torch.gather for unmerge_scatter, and torch.bmm of the
              (W,w,D)x(W,D,w) Gram in f32 (``library_ms``) and in bf16
              (``library_bf16_ms``, the mma route's operands) as yardsticks
              for the other two;
            - saliency_delta at (8, 256, 1152) in bf16 and f32, at
              (8, 128, 1152) in bf16, and at the observability slice's
              call sites in bf16: the decode gate's (4, 1, 1024), the
              audit's (232, 256, 1152) and the calibration recorder's
              (112, 256, 1152), each on the onepass route (one launch,
              the tickets read back at zero) and the SIMT route (two):
              per-token output and totals within rtol 1e-5, the two routes
              bitwise equal, repeated calls bitwise; both routes also
              timed L2-cold
              (``*_cold_device_ms``: a 64 MiB write before each call); the
              onepass kernel's ptxas lines (no spills) and whether its
              blocks fit on the card at once; library: torch.sum(d*d, -1)
              on the f32 difference, a yardstick;
            - linear_blend at M=2048, D=F=1152, bf16 X/prev, f32 W/b, gamma
              1 and 0.5, and at M=1024 (these three on the wgmma route), at
              the decode gates' M=4 (and 1 at D=1024) and D=F=1024, 5120,
              7168, 4096, 2560, 1536, gamma 1, on the gemv route (split K
              over every SM) with the wgmma route timed beside it
              (``wgmma_device_ms``), and ragged at M=D=F=1000 in f32 (the
              SIMT route): within 2e-2 in bf16 and 1e-4 in f32, repeated
              calls bitwise; gemv_crossover: the gemv and wgmma routes at
              the six decode widths and M = 1 ... 64, the gemv route
              faster at every M <= route.GEMV_MAX_ROWS, else the run
              fails; on the
              wgmma_split route at SPLIT_BLEND_SHAPES (the bypass, K = 1000
              and the decode gate's M = 4) with a cancelling W that one
              bf16 copy misses by more than 2e-2 (its rel-L2 printed):
              within 2e-2 and 1e-3 rel-L2, and so on planted terms;
              library: torch.addmm in f32
              with alpha=gamma, bias and blend folded into its input, and
              the same in bf16 with the bf16 W;
            each fused_gate / linear_blend row names its GEMM route
            (``gemm_route``) and that kernel's ptxas lines, and its bound
            is the function's on the route's operands: bf16 W bytes and
            the bf16 tensor-core rate for wgmma and gemv; for wgmma_split
            the f32
            W's bytes and one GEMM at the bf16 tensor-core rate, with the
            split's own work (every term read, a pass per term) bounded
            apart (``passes_bound_ms``);
4. syncs    an untimed warm-up serve (Workload.warm_up: two short requests
            on a fresh engine, whose first warm steps run eagerly), then
            the same serve under torch.cuda's sync-debug mode: its warm
            steps are step graphs (the first captured, the rest replayed,
            core/step_graph.py), so the policy reads nothing on the host
            (0 a model step, every policy) and the port's code syncs only
            at the engine's completion fetches; the synchronizations it
            flags beside the code's own host_syncs count;
5. serve    the main path, launch.serve_diffusion.Workload's defaults:
            DiT-XL/2 at full width, bf16, random un-zeroed weights
            (torch.Generator seed 0), fastcache with the default
            FastCacheConfig, 4 slots, 8 Poisson requests (rate 0.5, seed 0),
            50 DDIM steps, guidance 4.0, through DiffusionServingEngine.run
            (every warm step a replay of the step graph, its skipped blocks
            IF nodes of csrc/cond_node.cu, one per layer a replay, whose
            conditions fused_gate's GEMM sets: no condition kernel),
            timed with sync debug off; the kernels' launch counts are zeroed
            just before and read just after: fused_gate must have
            launched 28 times, saliency_delta and linear_blend once, per
            model step with a warm slot, and no other kernel; every
            fused_gate and linear_blend launch on the wgmma route (the
            per-route counts); the block cache ratio exactly
            PARENT_BLOCK_CACHE_RATIO, the SIMT route's (identity
            approximators are exact in bf16, so the routes agree bitwise);
            every saliency_delta launch on the onepass route;
6. syncs_merge / serve_merge   the same Workload with token merging on
            (merge_ratio 0.5, window 16), warmed up under sync debug and
            then timed with it off: the syncs per model step must equal the
            merge-off warm-up's; knn_density and merge_assign must have
            launched once per model step, unmerge_scatter once more per
            mixed step, fused_gate 28 times and saliency_delta and
            linear_blend once per warm or mixed step, and the kept-token
            share must be exactly 0.5; every knn_density and merge_assign
            launch on the mma route (the per-route counts);
7. static   the same input for 6 steps through CachedDiT.step: cache ratio
            must exceed 0.4 (the gated branch firing at full width);
8. policies the same Workload under each of fora, teacache, adacache,
            fbcache, l2c and smoothcache (l2c's mask: the 14 layers of least
            relative change in one nocache forward, by _rel_change; the
            default smoothcache schedule): a warm-up under sync debug whose
            flagged syncs in the port must equal the counted ones, none per
            model step for every policy (the host mirror decides cold and
            mixed steps, warm steps are graph replays); then a
            timed serve, launches exact: saliency_delta once per model step
            for teacache, adacache and fbcache (all on the onepass route),
            linear_blend 14 times per model step for l2c (all on the
            wgmma route), no other kernel; teacache's, adacache's and
            fbcache's block cache ratio and steps reused, and l2c's
            layers, exactly the parent's (PARENT_POLICY_STATS,
            PARENT_L2C_SKIPPED);
            nocache's serve first, as
            the yardstick of the engine steps/s (no kernel, no policy sync);
8b. step_graph  the serve's workload with fastcache, with fastcache and
            merging at 0.5, and with teacache, each served on the eager
            path (``step_graph=False``) and on the graph path: latents
            bitwise and every request's counters equal between the two,
            the merge-off cache ratio PARENT_BLOCK_CACHE_RATIO on both;
            per path the syncs flagged in the port's code per warm step (a
            short serve under sync debug "warn" after the graph's warm-up;
            the graph path's warm steps also under "error"), the host's
            kernel and graph launches per warm step (torch.profiler's CUDA
            runtime calls over three warm steps), the device kernels per
            warm step, and the wall ms per warm step (each step ended by a
            synchronize); the kernel wrappers' launch counts (on the graph
            path the capture's record, added at each replay) held to the
            wrappers' kernels the profiler saw by name in the profiled
            steps (CountedStep, hold_counts: never fewer, and equal in at
            least one step), and the two paths' device kernels diffed by
            name; the eager serves' first PARITY_CALLS
            saliency_delta inputs (fastcache, teacache) and knn_density /
            merge_assign windows (merged) re-run on both routes
            (saliency_parity: bitwise; window_parity: rho within 1e-4,
            centers and assign exact, merged bitwise); later, after the LLM
            serves, in a process of its own (run_step_graph_llm),
            qwen3-0.6b whole under the decode gate (LLMWorkload's
            defaults), eager and graph: tokens equal, syncs flagged per
            decode step (L + 1 and 1), host launches and device kernels
            per decode step (their counts held to the wrappers' as above),
            decode steps/s; on the graph path the profiler's set_if_all
            kernels and the IF nodes a step: fastcache 0 and L, teacache 1
            and 1, the decode step L and 2L (one condition kernel a
            two-sided branch);
9. quality  relative L2 of fastcache eps, of fastcache + merge eps, and of
            each baseline policy's eps against nocache eps (merge off) on
            the same inputs for 6 DDIM steps;
9a. audit   syncs_audit: a warm-up with the audit plane at 1.0 (metrics
            on, no collector) flags and counts the merge-off warm-up's
            syncs per model step; the fastcache serve with a collector at
            audit_fraction 1/32 and at 1.0: latents bitwise the main
            serve's, ratio PARENT_BLOCK_CACHE_RATIO, saliency_delta once
            more per audited step (all onepass); prints the eps error's
            p50 / p95 (histogram and exact) and max, Eq. 9's bound, bound
            violations, the per-layer mean error and the audited steps'
            extra wall time; audit_nocache: nocache audited at 1.0 sums
            exactly zero error;
9b. metrics the same serve with a collector (windows every 25 engine
            steps) and with the metrics plane off: ratio the parent's,
            latents bitwise; the Prometheus text's lines, the JSONL
            windows, the on / off wall times and the kernels and copies of
            the per-step update (torch.profiler around it alone);
9c. calibrate  record_calibration over 50 steps at batch 2 (50
            saliency_delta launches, all onepass, no other kernel);
            calibrate_dit on 4 batches of 8 latents (seed 0); the
            fastcache serve with the fitted maps, maps handed in, eager,
            every fused_gate and linear_blend launch on the wgmma_split
            route (ratio printed); calibrated_parity: its first 4 calls of
            each held against the plain version in f32 with the fitted W
            (gate bits exact, totals at 1e-4, outputs within 2e-2
            elementwise and SPLIT_REL_L2 in rel-L2), re-run on the SIMT
            route and on the wgmma route with a bf16 copy of the map
            (their rel-L2 printed: the yardstick, and why fitted maps are
            split); the same maps served eager on the named SIMT route
            (every launch there; ratio and latents against the split
            serve's); on the graph path (latents bitwise the eager split
            serve's; 0 policy syncs a warm step, dit_path_syncs); then the
            identity maps' serve on the graph path, for the pair's wall
            times (calibrated_cost);
9d. serve_g1 / serve_nocfg  guidance 1.0 served with CFG rows and by the
            cfg_rows=False engine: latents bitwise equal, fused_gate
            launches exact;
9e. trace   a traced 2-request serve whose document passes
            validate_trace;
9f. preempt_resume / preempt_resume_merge   the reference test's preempt
            script at full width (merge off, then at 0.5) with a third
            request: a and b admitted, b preempted after 3 steps, c
            admitted into b's slot 2 steps later, b resumed into another
            slot a step after that; beside the same requests served
            without a preemption: every request's latents bitwise (the
            victim's at least within 5e-2 of its scale) and req.cache
            exact, the snapshot unchanged after c's admission and step,
            preempt and the resuming add_request under sync debug "error"
            (their CUDA-event spans printed), launches exact and on the
            fast routes; then the snapshot, the donor reset and the restore
            alone, device time behind a spin and kernels per call
            (torch.profiler), beside the bound (the snapshot's bytes read
            and written once);
9g. slo_serve  SLOScheduler over 16 requests, 0.5 per engine step with a
            burst of 2.0 from step 5 for 20 steps, priority mix 0,1,1,2,
            deadline slacks 80,120,200, EDF, on_miss="reject", preemption
            and the shed ladder on, counts zeroed just before and read
            just after: at least one preemption, resumes == preemptions,
            launches exact and on the fast routes, no policy sync per warm
            model step (graph replays) in both serves; the per-class summary, the shed walk and the collector's
            SLO counts; then the same trace served plainly, and per engine
            step both serves' wall time and CUDA-event span;
9h. sharded_serve  the serve phase's workload through
            ShardedDiffusionEngine (launch.serve_diffusion.Workload.
            build_engine(mesh=...)), on the graph path wherever the mesh's
            collectives can be captured (model = 1).  (1, 1) on nccl with
            world size 1 in this process, through timed_run in the order
            plain engine, sharded, sharded, plain, sharded with sync
            admission, sharded eager (step_graph=False, the yardstick):
            every sharded serve's latents and request counters bitwise the
            serve phase's, the block cache ratio PARENT_BLOCK_CACHE_RATIO,
            0 policy syncs per warm model step on the graph path (every
            warm step a replay) and L eager, one completion fetch per
            async run, launches exact on every serve, wall time and
            CUDA-event span per engine step of each; then one more graph
            serve with GRAPH_PROFILED_STEPS warm steps under torch.profiler
            (path_serve): each wrapper's replayed launch count held to the
            kernels the card ran, by name (CountedStep, hold_counts).  The
            launcher's own --mesh path
            (serve_diffusion.serve_mesh, LAUNCHER_MESH_RUNS: 2,1 with a
            steps and guidance mix on gloo ranks sharing the card, 1,1
            lockstep on nccl), its rank-0 summary equal on LAUNCHER_EXACT
            to the single-device launcher's on the same flags, its
            topology the mesh's with the backend the card count calls
            for.  Then two ranks sharing the card over gloo
            (launch.mesh.RankGroup, SHARDED_SCENARIOS), each rank's
            launches exactly expected_launches for its slots and per rank
            the wall time and CUDA-event span per engine step, whether it
            ran the graph path (and why not), its policy syncs per warm
            step and _batch_sum's host round trips per engine step: data
            = 2 on the graph path (the trace served once before, so every
            timed warm step is a replay: 0 syncs; gloo's all-reduce of the
            skip-fraction partial goes through the host once an engine
            step): the same (admit, finish) schedule and latents within
            LATENT_REL (1e-4 of their scale) of the serve phase's; model =
            2 eager (gloo cannot be captured: L syncs a warm step), 18
            heads and 4,608 ffn columns halved: one block on its
            shards within BLOCK_TP_BOUND of the unsharded block (f32, bf16)
            and off by more than BLOCK_TP_FAULT without its all-reduce;
            the numerics self-check (TP_SELF_CHECK: f32, one layer, atol
            SELF_CHECK_ATOL) passes, and raises with blocks that skip
            their all-reduce; a 3-step serve of a two-layer cut
            (TP_SERVED_CUT) lies within TP_LATENT_REL of a single-device
            serve of the same model, and farther without the all-reduce;
            at full depth the served schedule and launches are exact and
            the latents' distance is recorded beside chaos_probe's (the
            model in f32 with no sharding, its input moved by one part
            in 2^23, block by block); beside each served distance, how
            far the single-device serve's latents move when its initial
            noise moves by one part in 2^23 (noise_spread); a rank's
            failure fails the phase;
9i. model_group_probe  the block skip under a model group inside a
            capture, on what one card allows (model_group_probe): a
            one-rank nccl world in this process stands in as a
            ShardingCtx's model group; a toy stack of PROBE_LAYERS
            integer-valued (PROBE_ROWS, 256, 1152) f32 blocks, each an
            all-reduced product behind step_graph.branch (the agreement
            all-reduce on the capturing stream, the IF node, the body's
            all-reduce), captured with and without the bodies'
            all-reduce: the bodies' node counts by type, every PROBE_MASKS
            replay bitwise the eager step under sync debug "error", the
            kernels a replay ran by name (nccl's among them); a capture
            that fails is recorded with its error, and the construction
            rule (step_graph.capture_refusal) must refuse an nccl model
            group exactly when it does;
10. kernel  flash_attention against its plain version at four shapes: (a)
            the LLM serve's prefill, B=1, H=16, KVH=8, S=512, dh=128,
            causal, window 1024, bf16; (b) S=2048, window 512 (tiles
            skipped on both sides); (c) Sq=64, Skv=576, causal (end
            alignment); (d) (a) in f32; within 2e-2 (bf16) and 2e-5 (f32);
            library: F.scaled_dot_product_attention (is_causal at (a) and
            (d), an explicit boolean mask at (b) and (c)), a yardstick only;
            each row adds ``vs_library`` (kernel device ms over the
            library's) and the ptxas lines of the instance that ran it
            (``ptxas``: bf16 the wgmma kernel, f32 the SIMT one);
11. llm_model  qwen3-0.6b at full width (launch.serve.LLMWorkload: 28
            layers, d 1024, 16/8 heads of 128, vocab 151,936, bf16, random
            weights from torch.Generator seed 0): parameters, init seconds;
12. llm_syncs  a warm-up fastcache serve (LLMWorkload.warm_up), then the
            same serve under sync debug: the syncs it flags in the port's
            code must be the ones the code counts, 1 per decode step (the
            greedy tokens; the gated decode step is a graph replay whose
            per-layer skips are IF nodes) and one per admission;
13. llm_serve  the LLM main path, LLMWorkload's defaults (8 requests of
            512 random tokens, 64 new tokens, max_batch 4, window 1024)
            through ServingEngine.run, exact and with the FastCache decode
            gate, each on a fresh engine after a warm-up, timed with sync
            debug off; every count zeroed just before each serve and read
            just after; flash_attention must have launched 28 times per
            prefill, exact decoding no other kernel, the decode gate
            exactly 28 saliency_delta (onepass) and 28 linear_blend
            (gemv) launches per decode step, and per replay of its graph
            28 condition kernels and 56 IF nodes; greedy-token agreement of
            fastcache against exact;
14. llm_prefill_parity  the last-position logits of one full-width
            512-token prefill through the kernel against the same prefill
            with the plain version patched in: relative L2 below 2e-2,
            the same argmax, each layer's kernel output within 2e-2 of
            the plain version on that layer's own q, k, v, and the two
            plain prefills (p in f32, p in bf16) within 2e-2 of each
            other, except for the configs of PREFILL_CHAOTIC (yi-9b,
            stablelm-3b, qwen2-vl-2b), whose plain prefills are chaotic at
            random init
            and which are held layer by layer;
15. llm_sampled  the fastcache LLM serve with greedy=False: every request
            finishes with in-vocabulary tokens;
15a. the other LLM configs at full width, each model freed before the
            next (``llm_model`` prints its parameter bytes and the peak
            memory of building it): flash_attention at the head dims the
            128 instance runs below its own (NEW_FLASH_SHAPES: stablelm-
            3b's prefill, 32 heads of 80, and kimi's, 64 of 112 on 8 KV
            heads; bf16 and f32 within the tolerances above, no spills;
            and arctic's, 56 of 128 on 8 KV heads, in bf16);
            qwen3-14b (40 layers, 29.5 GB) served exact and gated with
            LLMWorkload's defaults (launches as in 13, 40 per prefill or
            decode step), agreement and prefill parity; arctic-480b at full
            width with 2 layers (every expert, 55.4 GB): llm_syncs (1 per
            decode step: a graph replay, the MoE inside its IF nodes), exact and gated
            serves, prefill parity, the copies each prefill drops at the experts' capacity
            (moe_drops), moe_routes (the first layer's MoE at a decode batch
            on the capacity and the gather path: same experts, within 2e-2,
            each timed beside its bytes), and per decode step exact against
            gated the wall, the CUDA-event span and the profiled kernels
            (decode_profile); yi-9b (17.7 GB), stablelm-3b (5.6 GB, dh 80)
            and kimi-k2-1t-a32b at full width with 1 layer (38.8 GB, dh
            112): prefill parity and a gated serve of 2 requests of 16 new
            tokens (launches exact, on the fast routes);
15b. ssm_llms  the hybrid and SSM families at full width, each model
            freed before the next: flash_attention at Jamba's prefill
            (NEW_FLASH_SHAPES (j): 32 heads of 128 on 8 KV heads, bf16);
            jamba-v0.1-52b at full width with one period of 8 layers (7
            Mamba, 1 attention, 4 MoE of 16 experts, 26.6 GB) and
            xlstm-1.3b at full width cut to two periods (16 of 48
            layers; XLSTM), each on
            LLMWorkload's defaults (xLSTM with 2 requests), exact: a fastcache workload comes back
            exact with the reference launcher's line (the decode gate takes
            only period-1 attention stacks), llm_syncs (1 per decode step,
            one per admission, flagged = counted), the exact serve
            (flash_attention = attention layers x prefills: 8 on Jamba, 0
            on xLSTM; no other kernel), Jamba's prefill parity (its one
            attention layer held to the plain version) and moe_drops,
            prefill_profile (one admission under torch.profiler: launches,
            kernel ms, busy share, peak memory; xLSTM's sLSTM layer alone)
            and decode_profile (on the same engine, the other slots
            filled: per exact decode step, beside the step's
            bytes bound: weights and cache read once, mixer states written
            once); ssm_consistency: one Mamba (d 4096), mLSTM and sLSTM (d
            2048) layer in f32 with random weights, 508 positions prefilled
            and 4 decoded from the state left in a stacked cache leaf,
            against the full forward of all 512 (rel-L2 of the layer's
            output delta below 1e-3);
15c. vlm_audio  the VLM and audio families at full size, nothing cut,
            each model freed before the next: flash_attention at
            VLM_AUDIO_FLASH_SHAPES (HuBERT's 16 heads of 80, MHA,
            bidirectional, at S 500 (k, l), where the last query and key
            tiles hold 52 of their 64 rows, and S 512 (n, o), bf16 and f32;
            Qwen2-VL's prefill, 12 heads of 128 on 2 KV heads (m), bf16;
            library: SDPA with is_causal=False at k, l, n, o); qwen2-vl-2b
            (M-RoPE, 28 layers, 3.09 GB) on LLMWorkload's defaults:
            llm_syncs exact (1) and gated (1), the exact and gated serves
            (launches as in 13: 28 flash_attention per prefill, 28
            saliency_delta and linear_blend per gated decode step, at d
            1536), agreement, the text prefill's parity and the vision
            prefill's (256 embeddings at positions 1-256 with 3-axis
            positions on a 16 x 16 grid; vlm_vision_prefill_parity; both
            chaotic at random init, PREFILL_CHAOTIC, held per layer),
            decode_profile exact and gated and the exact step's
            decode_bound; hubert-xlarge (48 layers, 1.89 GB): hubert_encode
            of 4 x 500 frames (counts zeroed just before and read just
            after: 48 flash_attention launches, all bidirectional, no other
            kernel; each layer held to the plain version on its own q, k, v
            within 2e-2; the hidden states against the plain route's
            printed; moving the last 100 frames moves the first 100: not
            causal; time, frames/s, MFU) and train_hubert (launch/train.py's
            init_model and data_for: 5 AdamW steps of 8 x 500 frames, as
            train_llm below: losses finite, a step under sync debug "error",
            no kernel launched; ms per step and its split, frames/s,
            train_mfu, busy share, peak memory);
15d. vlm_positions  attention masked by explicit positions: B7's position
            mode against its plain version at Qwen2-VL-2B's image prompt
            (POSITION_FLASH_SHAPES: 1 x 12 / 2 heads of 128, S 512, causal,
            window 1,024; p bf16 on the layout's t positions, q bf16 on
            arange (bit for bit the implicit mode), r = p in f32 on the SIMT
            route; bf16 5e-2, f32 1e-4; timed as the other B7 rows, beside
            SDPA with the equivalent boolean mask; the bound from this
            input's live pairs); then Qwen2-VL-2B at full size (nothing
            cut) on an image prompt in the reference's M-RoPE layout (128
            text tokens at t = h = w = 0-127, 256 vision embeddings on a 16
            x 16 grid at t = 128, h = 128 + row, w = 128 + column, 128 text
            tokens from 144): one prefill and 8 greedy decode steps under
            sync debug "error" (no host sync), counts zeroed just before
            and read just after (28 flash_attention launches, all in
            position mode, no other kernel), the cache's positions the t
            axis exactly and the decode steps at 512, 513, ...; the
            prefill's parity per layer (vlm_positions_prefill_parity;
            chaotic at random init, PREFILL_CHAOTIC);
16. train_dit  DiT-XL/2 at full width (bf16, the reference's initializers,
            adaLN-zero) trained through training.loop.make_train_step for
            30 steps on latent_stream batches of 32 (seed 0), AdamW on
            cosine_schedule(3e-4, 5, 30), remat on; every count zeroed just
            before and read just after (no kernel lies on the path, so all
            stay 0, flash_attention included); every loss finite, the last
            logged one below the first, every parameter with a nonzero
            gradient at the last step, one step under sync debug "error";
            ms per step and its forward / backward / clip + update split
            (CUDA events at the step's phase boundaries, 25 steps after 3 of
            warm-up), samples/s, tokens/s, launches per step
            (torch.profiler, one step), peak memory and train_mfu (model
            FLOPs, remat's recompute left out, over 989 TFLOP/s);
17. checkpoint  the trained parameters and AdamW state saved in the
            reference's format under build/, loaded into a fresh model and
            state: bitwise, metadata round-tripped; bytes and seconds;
18. trained_serve  the trained model served under fastcache (Workload, 4
            requests, 50 steps): launches exact, latents finite, the block
            cache ratio printed;
19. train_llm  Qwen3-0.6B at full width, 5 steps of batch 8 x 256 tokens
            drawn from token_stream (seed 0) before the phase: losses
            finite, the first within 10% of ln(vocab), one step under sync
            debug "error", no kernel launched; ms per step (2 timed steps),
            tokens/s, launches per step, peak memory, train_mfu;
19b. sharded_train  LLM training on a mesh (training/sharded.py,
            SHARDED_TRAIN): Qwen3-0.6B whole (28 layers, bf16, AdamW,
            TRAIN_LLM's 8 x 256 stream and seed, 2 steps) on (1, 1) over
            nccl in this process, bitwise make_train_step on init_model's
            weights (losses, step-0 gradients, final parameters), then on
            two ranks sharing card 0 over gloo as (2, 1) (FSDP) and (1, 2)
            (tensor parallel); Arctic-480B at full width with one layer
            (Adafactor, 1 x 256 tokens, 2 steps) on (1, 1) over nccl, then,
            freed, on (1, 2) with 64 experts a rank.  Every count zeroed
            just before each leg and read just after (no kernel lies on the
            path); each mesh's step-0 loss within 1e-3 (relative) of the
            (1, 1) loss and of rank 0's recomputed (1, 1) reference, its
            step-0 gradients, gathered block by block from the ranks'
            hosts, within 5e-2 relative L2 of the reference's on every
            leaf (Arctic, no qk-norm: within the fixed 1e-1 of
            SHARDED_CHAOTIC_GRAD_REL_L2, about the (1, 1) step's own
            spread when its q, k, v are rounded once from f32, which is
            printed beside it); every rank's collective bytes per step
            equal to the dry run's count (launch/dryrun.collective_bytes)
            for the arch, batch and mesh; per rank ms per step (CUDA
            events), bytes by kind and peak memory (Arctic's beside the
            66-68 GB reckoning).  The two-rank legs share one pair of rank
            processes.  Then the launcher's ``--mesh 2,1 --steps 2`` prints
            the reference's lines, its step-0 loss within 1e-3 of (1, 1)'s;
19c. sharded_ssm  the SSM and hybrid families on a mesh (SHARDED_SSM,
            legs of 19b's rank pair, after its own): xLSTM-1.3b's period of
            8 layers at full width (AdamW, 2 x 256, 2 steps) on (1, 1),
            (1, 2) and (2, 1), and Jamba-v0.1-52b's first four layers at
            full width (Adafactor, 1 x 512, 2 steps) on (1, 1) and (1, 2),
            both in f32 (in bf16 their gradients are chaotic at random
            init); held as 19b's legs, each leaf's step-0 gradient within
            SHARDED_F32_GRAD_REL_L2 of (1, 1)'s, the (1, 1) step's spread
            with its products rounded once from f64 beside it;
19d. sharded_infer  prefill and decode on a mesh (distributed/inference.py,
            SHARDED_INFER): Qwen3-0.6B whole (bf16, a prefill of 4 x 512
            into a 1,024-slot cache, 8 teacher-forced decode steps) on
            (1, 2) and (2, 1), Jamba's and xLSTM's periods (1 x 256, 4
            steps) on (1, 2), two ranks sharing card 0 over gloo, against
            the same run on one device in this process: every step's
            gathered logits within 2e-2 relative L2, or, for the legs of
            SHARDED_INFER_CHAOTIC (whose one-device logits move past that
            when its products are rounded once from f32: the floor
            printed), every layer's update on the one-device run's own
            inputs and caches within 2e-2; B7 launched once a prefill per
            attention layer on every rank, on its local heads (8 q / 4 kv
            for Qwen3-0.6B on (1, 2)), and in no decode step; every call's
            collective bytes equal to the dry run's count;
20. train_ssm  the SSM and hybrid families' training (TRAIN_SSM):
            xLSTM-1.3b at full width, 16 of 48 layers (AdamW, 4 x 256
            tokens) and
            Jamba-v0.1-52b at full width with one period of 8 layers
            (Adafactor over its 16 x 4,096 x 14,336 expert banks in row
            blocks, 1 x 512 tokens), 3 steps each through launch/train.py's
            model and stream: losses finite, step 0 under sync debug
            "error", no kernel launched, every parameter with a gradient;
            ms per step and its split, tokens/s, train_mfu (6 x active
            parameters), launches, busy share, peak memory;
21. dryrun  the dry run (launch/dryrun.py) of every assigned arch x shape
            on the one-pod production mesh (16 x 16) on the meta device,
            in a process of its own with no card, started before the
            build so that it runs beside the card's phases
            (dryrun_sweep_child): its own lines (one per record, with the
            roofline's), a JSON row per record and the sweep's ok / skip /
            fail and seconds; no kernel launched, no record failed.  Its
            card tie (dryrun_tie): Qwen3-0.6B's train step at TRAIN_LLM's
            shape on a (1, 1) mesh, the dry run's argument bytes within 1%
            of the growth of memory_allocated() once the parameters, the
            AdamW state and the batch are on the card, its FLOPs equal to
            FlopCounterMode's count of the same step on the card, the
            card's step ms beside the roofline's compute_s.  Arctic's
            one-layer train_4k argument bytes on (1, 1), a prediction.
            Every ok record carries its sharded step's collective bytes
            by kind (counting comms on meta; the train, prefill or decode
            step), or the run fails; the sweep's seconds beside 300;
22. examples  each of the port's examples (examples/torch_*.py) at its
            defaults on the card, in process, its printed lines kept,
            counts zeroed just before and read just after: the
            quickstart's FastCache sample launches B1, B5 and B6, the LLM
            serve B7.

Then the total seconds, the kernels line (the seven kernels' rows, and
flash_attention's at dh 80 and 112, at Jamba's prefill, bidirectional at
HuBERT's heads, at Qwen2-VL's prefill in bf16 and in position mode at its
image prompt, saliency_delta and linear_blend at Qwen2-VL's d 1536,
linear_blend's gemv route at the decode gate's (4, 1024, 1024), and the IF
node three ways: with its condition kernel, fed by fused_gate, and a
two-sided pair on one kernel),
the card's name and
power limit, and as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero, with no result,
when no CUDA card is present or any phase fails.
"""
import collections
import concurrent.futures
import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
F32_FLOPS_PER_S = 67e12            # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12       # H100 SXM, dense bf16 tensor cores
KERNEL_SOURCES = ("fused_gate", "knn_density", "token_merge",
                  "flash_attention", "saliency_delta",
                  "linear_blend", "cond_node")              # csrc/*.cu
MERGE_RATIO = 0.5                  # the merged serve's kept-token share
# the merged slice's window shapes: DiT-XL/2 with 4 slots has 8 CFG rows of
# 256 tokens of width 1152, in windows of 16 with K=5 and M=8 kept
MERGE_W, MERGE_WIN, MERGE_D, MERGE_K, MERGE_M = 128, 16, 1152, 5, 8
# flash_attention shapes (B, H, KVH, Sq, Skv, dh, causal, window, dtype);
# the first is the LLM serve's prefill (qwen3-0.6b, 512-token prompts)
FLASH_SHAPES = {"a": (1, 16, 8, 512, 512, 128, True, 1024, "bfloat16"),
                "b": (1, 16, 8, 2048, 2048, 128, True, 512, "bfloat16"),
                "c": (1, 16, 8, 64, 576, 128, True, 0, "bfloat16"),
                "d": (1, 16, 8, 512, 512, 128, True, 1024, "float32")}
FLASH_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# the head dims the 128 instance runs below its own: the prefills of
# stablelm-3b (32 heads of 80, MHA) and kimi-k2-1t-a32b (64 of 112, 8 KV);
# and arctic-480b's prefill (56 heads of 128 on 8 KV heads, GQA 7:1)
NEW_FLASH_SHAPES = {"e": (1, 32, 32, 512, 512, 80, True, 1024, "bfloat16"),
                    "f": (1, 32, 32, 512, 512, 80, True, 1024, "float32"),
                    "g": (1, 64, 8, 512, 512, 112, True, 1024, "bfloat16"),
                    "h": (1, 64, 8, 512, 512, 112, True, 1024, "float32"),
                    "i": (1, 56, 8, 512, 512, 128, True, 1024, "bfloat16"),
                    # jamba-v0.1-52b's prefill: 32 heads of 128 on 8 KV
                    "j": (1, 32, 8, 512, 512, 128, True, 1024, "bfloat16")}
# the full-width configs beyond qwen3-0.6b, each at LLMWorkload's defaults
# unless cut: the MoE configs at full width with their depth cut to fit one
# card (arctic-480b: every expert of 2 layers, 55.4 GB; kimi: 1 layer,
# 38.8 GB); the parity configs also serve 2 requests of 16 new tokens
ARCTIC = dict(arch="arctic-480b", num_layers=2)
PARITY_LLMS = (dict(arch="yi-9b"), dict(arch="stablelm-3b"),
               dict(arch="kimi-k2-1t-a32b", num_layers=1))
SHORT_SERVE = dict(requests=2, new_tokens=16, fastcache=True)
# the hybrid and SSM families: Jamba at full width with one period of its
# block pattern (8 of 32 layers, 26.6 GB), xLSTM at full width serving 2
# requests, not 8: its token-by-token sLSTM prefill is ~85,000 launches at
# 48 layers (1.1-1.3 s a request on the card), and 4 requests already took
# the phase to 90.8 s, past its 90 s.  Since the mesh phases joined the
# script (sharded_ssm, sharded_infer) xLSTM runs two of its six periods
# (16 layers): with 48 here, 48 in train_ssm and 3 steps in sharded_train
# the script took 1,097.9 s of its 1,200 (xLSTM's serve 82.0 s; an NVIDIA
# H100 80GB HBM3 at 700 W)
JAMBA = dict(arch="jamba-v0.1-52b", num_layers=8)
XLSTM = dict(arch="xlstm-1.3b", requests=2, num_layers=16)
# ssm_consistency: one layer of each mixer at its config's full width in
# f32, (batch, prefilled, decoded) positions, and the rel-L2 bound
SSM_MIXERS = (("mamba", "jamba-v0.1-52b"), ("mlstm", "xlstm-1.3b"),
              ("slstm", "xlstm-1.3b"))
SSM_CONSISTENCY = (2, 508, 4)
SSM_CONSISTENCY_REL_L2 = 1e-3
# the VLM and audio families at full size, nothing cut: Qwen2-VL-2B on
# LLMWorkload's defaults (exact and gated), one prefill of its first prompt
# with VISION_TOKENS embeddings at positions 1.. on a VISION_GRID x
# VISION_GRID grid; HuBERT-XLarge encoding HUBERT_ENCODE (batch, frames: 10
# s of audio at 50 Hz) and training TRAIN_HUBERT through launch/train.py's
# path.  B7 at HuBERT's attention (16 heads of 80, MHA, bidirectional; at
# its 500 frames, where the last query and key tiles hold 52 of their 64
# rows, and at 512) and at Qwen2-VL's prefill (12 heads of 128 on 2 KV)
VLM = dict(arch="qwen2-vl-2b")
VISION_TOKENS, VISION_GRID = 256, 16
HUBERT = "hubert-xlarge"
HUBERT_ENCODE = (4, 500)
BIDIRECTIONAL_FRAMES = 100  # the late frames moved, the early ones read
VLM_AUDIO_FLASH_SHAPES = {
    "k": (1, 16, 16, 500, 500, 80, False, 0, "bfloat16"),
    "l": (1, 16, 16, 500, 500, 80, False, 0, "float32"),
    "m": (1, 12, 2, 512, 512, 128, True, 1024, "bfloat16"),
    "n": (1, 16, 16, 512, 512, 80, False, 0, "bfloat16"),
    "o": (1, 16, 16, 512, 512, 80, False, 0, "float32")}
DECODE_PROFILE_STEPS = 8   # decode steps timed by CUDA events, then profiled
PREFILL_REL_L2 = 2e-2      # kernel vs plain full-width prefill logits
# the configs whose two plain prefills (p in f32, and p rounded to bf16)
# differ by more than PREFILL_REL_L2 at random init, with that distance as
# this script measured it (NVIDIA H100 80GB HBM3, 700 W; qwen2-vl-2b's on
# its text prompt, its vision prefill's 1.2524): no qk-norm, so
# attention logits reach ~100 and a 1-ulp change flips a near-one-hot
# softmax row.  Only these hold the kernel to the plain version layer by
# layer alone; any other config whose floor reaches the bound fails.
PREFILL_CHAOTIC = {"yi-9b": 1.2992669343948364,
                   "stablelm-3b": 1.2654507160186768,
                   "qwen2-vl-2b": 1.246437430381775}
# saliency_delta shapes (B, N, D, dtype): fastcache/teacache at 4 slots (the
# CFG batch of 8 rows of 256 tokens), in bf16 and f32, and merged (128
# kept); the decode gate's (batch 4 of one 1024-wide token), the audit's
# per-layer stacks ((L+1) x 8 rows) and the calibration recorder's (L x 4);
# the decode gate's of the other LLMs (qwen3-14b, the MoE configs, yi-9b,
# stablelm-3b)
SAL_SHAPES = ((8, 256, 1152, "bfloat16"), (8, 256, 1152, "float32"),
              (8, 128, 1152, "bfloat16"), (4, 1, 1024, "bfloat16"),
              (232, 256, 1152, "bfloat16"), (112, 256, 1152, "bfloat16"),
              (4, 1, 5120, "bfloat16"), (4, 1, 7168, "bfloat16"),
              (4, 1, 4096, "bfloat16"), (4, 1, 2560, "bfloat16"),
              (4, 1, 1536, "bfloat16"))                # qwen2-vl-2b's gate
# linear_blend shapes (M, D, F, dtype, gamma): 4 slots x CFG x 256 tokens at
# the callers' gamma 1 and the reference's default 0.5, merged, and ragged
BLEND_SHAPES = ((2048, 1152, 1152, "bfloat16", 1.0),
                (2048, 1152, 1152, "bfloat16", 0.5),
                (1024, 1152, 1152, "bfloat16", 1.0),
                (1000, 1000, 1000, "float32", 0.5),
                (4, 1024, 1024, "bfloat16", 1.0),     # the decode gate's
                (1, 1024, 1024, "bfloat16", 1.0),
                (4, 5120, 5120, "bfloat16", 1.0),     # qwen3-14b's gate
                (4, 7168, 7168, "bfloat16", 1.0),     # the MoE configs'
                (4, 4096, 4096, "bfloat16", 1.0),     # yi-9b's
                (4, 2560, 2560, "bfloat16", 1.0),     # stablelm-3b's
                (4, 1536, 1536, "bfloat16", 1.0))     # qwen2-vl-2b's
BLEND_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# the merge-off fastcache serve's block cache ratio with fused_gate and
# linear_blend on the SIMT route (parent commit, NVIDIA H100 80GB HBM3): the
# wgmma route must give it exactly
PARENT_BLOCK_CACHE_RATIO = 0.8427678571428572
# the step-level baselines' (block cache ratio, steps reused) and l2c's
# calibrated layers with saliency_delta on the SIMT route (parent commit,
# NVIDIA H100 80GB HBM3): the onepass route gives the same bits, so the
# same numbers exactly
PARENT_POLICY_STATS = {"teacache": (0.38, 304.0), "adacache": (0.3, 240.0),
                       "fbcache": (0.03616071428571429, 30.0)}
PARENT_L2C_SKIPPED = list(range(14, 28))
WINDOW_KERNELS = ("knn_density", "merge_assign")   # the window Gram's
ROUTE_OF_SERVE = {"fused_gate": "wgmma", "linear_blend": "wgmma",
                  "knn_density": "mma", "merge_assign": "mma",
                  "saliency_delta": "onepass"}     # every served launch's
PARITY_CALLS = 4           # served calls whose inputs both routes re-run
COND_MASK_ROWS = 8         # the served skip mask: 4 slots x the CFG pair
COND_NODES = 64            # IF nodes in the graph that times one
COND_FED_SHAPE = (8, 128, 1152)   # fused_gate feeding an IF node: the serve's
COND_FED_NODES = 32        # fused_gate calls in the graph that times one
# linear_blend's gemv route against the wgmma route: the decode gates'
# widths (D = F) by rows
GEMV_WIDTHS = (1024, 5120, 7168, 4096, 2560, 1536)
GEMV_CROSSOVER_M = (1, 2, 4, 8, 16, 32, 64)
GRAPH_PROFILED_STEPS = 5   # warm steps profiled on each path (step_graph)
GRAPH_PROFILE_FROM = 12    # engine step from which they are taken
# the fitted serve's outputs against the plain version in f32, rel-L2: bf16
# outputs' tolerance (a bf16 copy of the fitted maps missed it by up to 4x);
# and the bound on the wgmma_split route that serves them (W split into
# three bf16 terms, 2^-24 of |W| from W): no more than the bf16 output
# rounding of values the f32 sums moved
CALIBRATED_REL_L2 = 2e-2
SPLIT_REL_L2 = 1e-3
ROUTE_OF_FITTED = {"fused_gate": "wgmma_split",
                   "linear_blend": "wgmma_split"}   # every fitted launch's
# linear_blend on the wgmma_split route (M, D, F): the fitted bypass, K not a
# multiple of 64 (the padded terms), the decode gate's M = 4; gamma 1, bf16;
# square, so that the cancelling W's diagonal meets every column
SPLIT_BLEND_SHAPES = ((2048, 1152, 1152), (2048, 1000, 1000),
                      (4, 1024, 1024))
FLUSH_BYTES = 64 << 20     # the buffer written to push inputs out of L2
# the six baseline policies served at full width, and l2c's layer count
BASELINES = ("fora", "teacache", "adacache", "fbcache", "l2c", "smoothcache")
L2C_SKIP = 14
SPIN_CYCLES = 4_000_000    # ~2 ms spin opening each device_ms window
LATENT_REL = 1e-4          # the port's latent tolerance, of their scale
# the sharded serve's two-rank runs, both ranks sharing card 0 over gloo
# (see 9h), on the Workload's model at full width in the scenario's
# ``dtype`` (absent: bf16), cut to ``num_layers`` (absent: all 28), its
# requests' plans ``steps`` long (absent: 50).  "block" holds one block on
# local shards to the unsharded block (BLOCK_TP_BOUND by dtype); a
# "self_check" scenario builds the engine with the numerics self-check on
# at ``atol``, which must pass (``expect`` "pass") or, with blocks that
# skip their all-reduce (``bad_reduce``), raise; a "served" one serves
# with the self-check off, its schedule exact and its latents within
# ``bound`` of a single-device serve of the same model (None: measured,
# not bounded), or, with ``bad_reduce``, farther than ``bound``.
#
# Why model = 2 is checked cut down (PERF.md, §6): the random-init
# DiT's hidden states reach ~960, where an f32 sum in another order moves
# an element by 0.02 in one block ("block"), so the self-check's absolute
# 1e-2 (the reference's default, kept by the engine) fails on a correct
# engine; it runs here at SELF_CHECK_ATOL, ~1e-3 of that scale, in f32 at
# one layer.  And the served trajectory is chaotic: one part in 2^23 of
# the initial noise moves the single-device latents by 0.85 of their
# scale at full depth, but by 1.7e-4 over a 3-step plan at two layers,
# where model = 2 lies 0.033 away and a skipped all-reduce 1.67
# (noise_spread, beside each served distance)
SELF_CHECK_ATOL = 1.0
TP_LATENT_REL = 0.1
TP_SELF_CHECK = dict(kind="self_check", dtype="float32", num_layers=1,
                     atol=SELF_CHECK_ATOL)
TP_SERVED_CUT = dict(num_layers=2, steps=3, bound=TP_LATENT_REL)
SHARDED_SCENARIOS = {
    (2, 1): [dict(name="served", bound=LATENT_REL)],
    (1, 2): [dict(name="block"),
             dict(name="self_check", expect="pass", **TP_SELF_CHECK),
             dict(name="bad_reduce", expect="raise", bad_reduce=True,
                  **TP_SELF_CHECK),
             dict(name="served_cut", **TP_SERVED_CUT),
             dict(name="served_cut_bad_reduce", bad_reduce=True,
                  **TP_SERVED_CUT),
             dict(name="served", bound=None)],
}
# the launcher's own --mesh runs (serve_diffusion.serve_mesh), each
# against the single-device launcher on the same flags: name -> (the mesh
# flags, the other flags); LAUNCHER_EXACT: the summary keys that must agree
LAUNCHER_MESH_RUNS = {
    "mesh_2x1_mix": (["--mesh", "2,1"],
                     ["--steps-mix", "20,50", "--guidance-mix", "1.0,4.0"]),
    "mesh_1x1_lockstep": (["--mesh", "1,1"], ["--lockstep"]),
}
LAUNCHER_EXACT = ("finished", "engine_steps", "model_steps",
                  "latency_steps_p50", "latency_steps_p95",
                  "latency_by_steps", "block_cache_ratio", "steps_reused",
                  "blocks_skipped", "blocks_computed", "mode", "steps_mix",
                  "guidance_mix")
# one DiT block at full width on two heads / ffn shards against the
# unsharded block, relative L2 over a (8, 256, 1152) input: f32 sums its
# partials in another order (~1e-6), bf16 rounds the block's products once
# (its ulp, 2^-8); a block whose products are not all-reduced is off by
# ~0.5, which BLOCK_TP_FAULT must see
BLOCK_TP_BOUND = {"float32": 1e-4, "bfloat16": 1e-2}
BLOCK_TP_FAULT = 0.1
SHARDED_TIMEOUT_S = 300    # both ranks of one mesh, start to result
# the dry run (launch/dryrun.py): its card tie holds the dry run of Qwen3-0.6B's
# train step at TRAIN_LLM's shape on a (1, 1) mesh to the card: the argument
# bytes within DRYRUN_TIE_REL of the growth of memory_allocated() once the
# parameters, the AdamW state and the batch are on the card, the FLOPs
# equal to FlopCounterMode's count of the step on the card; Arctic's
# one-layer train_4k step on (1, 1) is printed as a prediction
DRYRUN_TIE_REL = 0.01
ARCTIC_ONE_LAYER = dict(arch="arctic-480b", shape="train_4k", num_layers=1)
# the port's examples, run at their defaults on the card, and the kernels
# each must launch
EXAMPLES = ("torch_quickstart", "torch_generate_images",
            "torch_serve_images", "torch_serve_llm", "torch_train_dit")
EXAMPLE_KERNELS = {"torch_quickstart": ("fused_gate", "saliency_delta",
                                        "linear_blend"),
                   "torch_serve_llm": ("flash_attention",)}
EXAMPLE_CKPT = "build/torch_dit_ckpt"   # torch_train_dit's default --save


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def latent_shape(model):
    dit = model.cfg.dit
    return (dit.image_size, dit.image_size, dit.in_channels)


def cuda_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int = 20, attempts: int = 4) -> float:
    """Device time per call, the host's launch overhead left out: a spin
    kernel (``torch.cuda._sleep``) holds the stream while the host enqueues
    ``iters`` calls between two CUDA events, so the card then runs them back
    to back.  A window counts only if its start event was still pending once
    the last call was enqueued, that is, the host stayed ahead of the card
    all the way; else the spin is made four times longer, half as many calls
    are taken, and the window is measured again.  A function that waits for
    the card inside never passes, and fails the run."""
    fn()
    torch.cuda.synchronize()
    cycles = SPIN_CYCLES
    for _ in range(attempts):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
        iters = max(1, iters // 2)
    raise AssertionError(f"the host fell behind the card in {attempts} "
                         f"windows; the timed function waits for the card")


def timed(torch, prefix: str, fn) -> dict:
    """``{prefix}_ms``: CUDA events around back-to-back calls from Python,
    host overhead included; ``{prefix}_device_ms``: device time per call."""
    return {f"{prefix}_ms": cuda_ms(torch, fn),
            f"{prefix}_device_ms": device_ms(torch, fn)}


def bound(nbytes: float, t_ops_s: float):
    """(bound_ms, bound_by) from the bytes moved and the operations' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_bytes, t_ops_s) * 1e3,
            "operations" if t_ops_s >= t_bytes else "bytes")


def phase_build(build):
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = dict(zip(KERNEL_SOURCES,
                        pool.map(build.load_library, KERNEL_SOURCES)))
    wall = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        emit({"phase": "build", "source": f"src/repro_torch/csrc/{name}.cu",
              "seconds": round(libs[name].seconds, 3),
              "ptxas": build.ptxas_lines(libs[name].log)})
    emit({"phase": "build_all", "sources": len(KERNEL_SOURCES),
          "wall_s": round(wall, 3)})


def planted_split(torch, gen, d, f, dev):
    """A split copy of a (D, F) map whose SPLIT_TERMS terms are independent
    N(0, 1) bf16 matrices, each followed by its zero padding rows: (copy,
    the f32 sum of the terms, the last term in f32).  A kernel that drops a
    term, or reads one a row off (the padding), misses X times the sum by
    that term's whole share of the product."""
    from repro_torch.cuda_kernels.route import SPLIT_TERMS, split_rows
    kp = split_rows(d)
    copy = torch.zeros((SPLIT_TERMS * kp, f), dtype=torch.bfloat16,
                       device=dev)
    for t in range(SPLIT_TERMS):
        copy[t * kp:t * kp + d] = torch.randn((d, f), generator=gen,
                                              device=dev)
    terms = copy.float().reshape(SPLIT_TERMS, kp, f)[:, :d]
    return copy, terms.sum(0), terms[-1].contiguous()


def check_planted(torch, what, got, want, without_last):
    """The split route's output ``got`` on planted terms against the plain
    version on their sum (``want``): within BLEND_TOL elementwise and
    SPLIT_REL_L2 in rel-L2.  ``without_last``, the plain version without
    the last term, shows what a kernel that dropped it would read."""
    tol = BLEND_TOL["bfloat16"]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    rel = rel_l2(torch, got, want)
    drop = rel_l2(torch, without_last, want)
    if rel > SPLIT_REL_L2 or drop <= SPLIT_REL_L2:
        raise AssertionError(f"{what}, planted terms: rel-L2 {rel}, "
                             f"without the last term {drop}")
    return {"rel_l2": rel, "drop_term_rel_l2": drop}


def phase_fused_gate(torch, dev, fused_gate, ref, statcache, c, build):
    """fused_gate against its plain version at (8, c, 1152) (see 3. in the
    module docstring).  Returns the wgmma route's row and the wgmma_split
    route's."""
    from repro_torch.core.linear_approx import split_copies
    from repro_torch.cuda_kernels.route import SPLIT_TERMS
    gen = torch.Generator(dev).manual_seed(0)
    b, d = 8, 1152
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, c, d).to(bf16)
    prev = (x.float() + randn(b, c, d, scale=0.01)).to(bf16)
    po = randn(b, c, d).to(bf16)
    w = torch.eye(d, device=dev) + randn(d, d, scale=0.01)
    w_bf16 = w.to(bf16)                  # the copies a policy makes once
    (w_split,) = split_copies(w, bf16, dev)
    bias = randn(d, scale=0.1)
    nd = c * d
    thr = statcache.make_threshold(0.05, nd)
    diff64 = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * (b // 2), device=dev,
                          dtype=torch.float64)     # even samples gate
    sigma2 = (diff64 / (nd * thr) * factor).to(f32)
    eligible = torch.ones(b, dtype=torch.bool, device=dev)
    args = (x, prev, po, w, bias, sigma2, eligible)
    planted, planted_w, planted_last = planted_split(torch, gen, d, d, dev)

    worst, out, gates, split_worst, split_rel = 0.0, {}, {}, 0.0, []
    planted_rel = []
    for use_blend in (True, False):
        kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
        wgmma_before = fused_gate.launches_by_route["wgmma"]
        got = fused_gate(*args, **kw, w_bf16=w_bf16)
        torch.cuda.synchronize()
        if fused_gate.launches_by_route["wgmma"] != wgmma_before + 1:
            raise AssertionError("fused_gate at the serve's shape did not "
                                 "take the wgmma route")
        want = ref.fused_gate(*args, **kw)
        if not torch.equal(got[1], want[1]):
            raise AssertionError(f"gate bits differ: {got[1]} vs {want[1]}")
        if int(got[1].sum()) != b // 2:
            raise AssertionError(f"expected {b // 2} gated samples, got "
                                 f"{int(got[1].sum())}")
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
        torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=2e-2, atol=2e-2)
        if not all(torch.equal(g, a) for g, a in
                   zip(got, fused_gate(*args, **kw, w_bf16=w_bf16))):
            raise AssertionError("fused_gate does not repeat bitwise")
        err = float((got[0].float() - want[0].float()).abs().max())
        worst = max(worst, err)
        gates[use_blend] = got[1]
        # the SIMT route on the same bf16 inputs with the f32 W, named as
        # the runners name it for fitted maps
        simt_before = fused_gate.launches_by_route["simt"]
        simt = fused_gate(*args, **kw, gemm="simt")
        torch.cuda.synchronize()
        if fused_gate.launches_by_route["simt"] != simt_before + 1:
            raise AssertionError("gemm='simt' did not take the SIMT route")
        if not torch.equal(simt[1], want[1]):
            raise AssertionError("SIMT route, bf16 X: gate bits differ")
        torch.testing.assert_close(simt[0].float(), want[0].float(),
                                   rtol=2e-2, atol=2e-2)
        # the wgmma_split route (fitted maps) on the same inputs: the gate
        # and its totals are the SIMT route's bits (one gate_partials)
        split_before = fused_gate.launches_by_route["wgmma_split"]
        split = fused_gate(*args, **kw, w_bf16=w_split)
        torch.cuda.synchronize()
        if fused_gate.launches_by_route["wgmma_split"] != split_before + 1:
            raise AssertionError("a split copy did not take the wgmma_split "
                                 "route")
        if not all(torch.equal(a, b) for a, b in zip(split[1:], simt[1:])):
            raise AssertionError("wgmma_split route: gate bits or totals "
                                 "differ from the SIMT route's")
        torch.testing.assert_close(split[0].float(), want[0].float(),
                                   rtol=2e-2, atol=2e-2)
        split_rel.append(rel_l2(torch, split[0], want[0]))
        if split_rel[-1] > SPLIT_REL_L2:
            raise AssertionError(f"wgmma_split route: rel-L2 "
                                 f"{split_rel[-1]} > {SPLIT_REL_L2}")
        if not all(torch.equal(g, a) for g, a in
                   zip(split, fused_gate(*args, **kw, w_bf16=w_split))):
            raise AssertionError("wgmma_split route does not repeat "
                                 "bitwise")
        split_worst = max(split_worst, float(
            (split[0].float() - want[0].float()).abs().max()))
        # every term read and summed: a copy whose terms are independent
        pargs = (x, prev, po, planted_w, bias, sigma2, eligible)
        pwant = ref.fused_gate(*pargs, **kw)
        pgot = fused_gate(*pargs, **kw, w_bf16=planted)
        torch.cuda.synchronize()
        if not torch.equal(pgot[1], pwant[1]):
            raise AssertionError("wgmma_split route, planted terms: gate "
                                 "bits differ")
        planted_rel.append(check_planted(torch, "fused_gate", pgot[0],
                                          pwant[0], ref.fused_gate(
            x, prev, po, planted_w - planted_last, bias, sigma2, eligible,
            **kw)[0]))
        out[use_blend] = {
            **timed(torch, "kernel",
                    lambda: fused_gate(*args, **kw, w_bf16=w_bf16)),
            **timed(torch, "plain", lambda: ref.fused_gate(*args, **kw)),
            **timed(torch, "simt_bf16",
                    lambda: fused_gate(*args, **kw, gemm="simt")),
            **timed(torch, "split",
                    lambda: fused_gate(*args, **kw, w_bf16=w_split)),
            "split_rel_l2": split_rel[-1],
            "simt_bf16_max_abs_err": float(
                (simt[0].float() - want[0].float()).abs().max())}
        emit({"phase": "kernel", "name": "fused_gate", "shape": [b, c, d],
              "dtype": "bfloat16", "use_blend": use_blend,
              "gemm_route": "wgmma", "gated": int(got[1].sum()),
              "max_abs_err": err, **out[use_blend]})

    # the library calls: the GEMM alone in f32 over every row, in bf16 (X
    # and the bf16 W) over every row, and in bf16 over the gated rows only
    xm = x.reshape(b * c, d)
    xmf = xm.float()
    bias_bf16 = bias.to(bf16)
    xg = x[want[1]].reshape(-1, d)
    lib = {**timed(torch, "library", lambda: torch.addmm(bias, xmf, w)),
           **timed(torch, "library_bf16",
                   lambda: torch.addmm(bias_bf16, xm, w_bf16)),
           **timed(torch, "library_gated",
                   lambda: torch.addmm(bias_bf16, xg, w_bf16))}
    # the row is the use_blend run's.  bytes: x and prev_in read and out
    # written once each in bf16 for every sample, prev_out read in bf16 for
    # the samples this run gated only (a sample that does not gate returns
    # x, and its prev_out is never read), the bf16 W and the f32 bias, the
    # (B,) vectors; operations: the two norms over x/prev (5 per element)
    # and the bias + blend epilogue (4 per element) on the f32 units, and
    # the GEMM (2*C*D*D) of the gated samples on the bf16 tensor cores
    n_gated = int(gates[True].sum())
    nbytes = (3 * b * c * d * 2 + n_gated * c * d * 2 + d * d * 2 + d * 4
              + b * (4 + 1 + 1 + 4 + 4))
    gemm = n_gated * 2 * c * d * d
    simd = 5 * b * c * d + n_gated * 4 * c * d
    bound_ms, bound_by = bound(nbytes, gemm / BF16_TC_FLOPS_PER_S
                               + simd / F32_FLOPS_PER_S)
    ptxas = build.ptxas_lines(build.load_library("fused_gate").log)
    row = {"name": "fused_gate", "route": "cuda", "gemm_route": "wgmma",
           "source": "src/repro_torch/csrc/fused_gate.cu",
           "replaces": "src/repro/kernels/fused_gate.py:80",
           "shape": [b, c, d], "dtype": "bfloat16", "max_abs_err": worst,
           "ms": out[True]["kernel_ms"], **out[True], **lib,
           "library_call": "torch.addmm (B*C,D)x(D,D) f32: the GEMM alone",
           "library_bf16_call": ("torch.addmm (B*C,D)x(D,D) bf16 X and the "
                                 "bf16 W: the GEMM alone"),
           "library_gated_call": ("torch.addmm bf16 over the gated "
                                  "samples' rows only"),
           "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
           "operations": gemm + simd,
           "ptxas": (instance_ptxas(ptxas, "15gate_gemm_wgmmaE")
                     + instance_ptxas(ptxas,
                                      "13gate_partialsI13__nv_bfloat16E"))}
    emit({"phase": "kernel_summary", **row})
    # the wgmma_split route's row.  Its bound is the function's: the bytes
    # above with the f32 W in place of the bf16 copy, the same operations
    # (one GEMM at the bf16 tensor-core rate).  The split's own work, every
    # term of W read and the GEMM's passes over the gated samples once per
    # term, is bounded apart (``passes_*``)
    split_bytes = nbytes + d * d * 2
    split_bound, split_by = bound(split_bytes, gemm / BF16_TC_FLOPS_PER_S
                                  + simd / F32_FLOPS_PER_S)
    passes_bytes = nbytes + (w_split.numel() - d * d) * 2
    passes_gemm = gemm * SPLIT_TERMS
    passes_bound, passes_by = bound(passes_bytes, passes_gemm
                                    / BF16_TC_FLOPS_PER_S
                                    + simd / F32_FLOPS_PER_S)
    split_row = {"name": "fused_gate", "route": "cuda",
                 "gemm_route": "wgmma_split", "source": row["source"],
                 "replaces": row["replaces"], "shape": [b, c, d],
                 "dtype": "bfloat16", "max_abs_err": split_worst,
                 "rel_l2": split_rel, "ms": out[True]["split_ms"],
                 "kernel_ms": out[True]["split_ms"],
                 "kernel_device_ms": out[True]["split_device_ms"],
                 **{k: out[True][k] for k in ("plain_ms", "plain_device_ms",
                                              "simt_bf16_ms",
                                              "simt_bf16_device_ms")},
                 **{k: lib[k] for k in ("library_ms", "library_device_ms")},
                 "library_call": ("torch.addmm (B*C,D)x(D,D) f32: the GEMM "
                                  "alone, with the f32 W the split stands "
                                  "for"),
                 "bound_ms": split_bound, "bound_by": split_by,
                 "bytes": split_bytes, "operations": gemm + simd,
                 "passes_bound_ms": passes_bound,
                 "passes_bound_by": passes_by, "passes_bytes": passes_bytes,
                 "passes_operations": passes_gemm + simd,
                 "planted_rel_l2": [r["rel_l2"] for r in planted_rel],
                 "planted_drop_term_rel_l2": [r["drop_term_rel_l2"]
                                              for r in planted_rel],
                 "ptxas": row["ptxas"]}
    emit({"phase": "kernel_summary", **split_row})
    return row, split_row


def assign_gaps(hf, centers, assign, want):
    """The two smallest d2 (in f64, to the window's centers) of each token
    whose assignment differs from ``want``'s."""
    h64 = hf.double()
    ch = h64.gather(1, centers.long()[..., None].expand(-1, -1,
                                                        h64.shape[-1]))
    d2 = (h64[..., :, None, :] - ch[..., None, :, :]).square().sum(-1)
    top = d2.topk(min(2, d2.shape[-1]), dim=-1, largest=False).values
    return top[assign != want].tolist()


def check_merge(tag, hf, got, want, tol) -> None:
    """merge_assign's outputs ``got`` against ``want``: centers and assign
    exact (else the differing tokens' two smallest d2 are printed), merged
    bitwise when ``tol`` is None, else within rtol/atol ``tol``."""
    import torch
    merged, assign, centers = got
    if not centers.equal(want[2]):
        raise AssertionError(f"{tag}: centers differ in "
                             f"{int((centers != want[2]).sum())} places")
    if not assign.equal(want[1]):
        raise AssertionError(
            f"{tag}: assign differs at {int((assign != want[1]).sum())} "
            f"tokens; their two smallest d2: "
            f"{assign_gaps(hf, want[2], assign, want[1])}")
    if tol is None:
        if not merged.equal(want[0]):
            raise AssertionError(f"{tag}: merged tokens are not bitwise")
    else:
        torch.testing.assert_close(merged.float(), want[0].float(),
                                   rtol=tol, atol=tol)


def no_spills(lines, what: str) -> None:
    if not lines:
        raise AssertionError(f"{what}: no ptxas lines")
    for ln in lines:
        if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" \
                not in ln:
            raise AssertionError(f"{what} spills: {ln}")


def phase_token_merge(torch, dev, k, build):
    """knn_density, merge_assign and unmerge_scatter against their plain
    versions at the merged slice's shapes: knn_density and merge_assign in
    bf16 (the mma route) and in f32 (the SIMT route), each row with its
    route's ptxas lines; returns the kernels-line rows (bf16, the serve's)."""
    nw, w, d, kk, m = MERGE_W, MERGE_WIN, MERGE_D, MERGE_K, MERGE_M
    gen = torch.Generator(dev).manual_seed(3)
    h16 = torch.randn((nw, w, d), generator=gen, device=dev).to(torch.bfloat16)
    s = torch.rand((nw, w), generator=gen, device=dev)
    s = s / s.amax(dim=-1, keepdim=True)
    hf = h16.float()                       # the same values in f32
    hft, h16t = (t.transpose(1, 2).contiguous() for t in (hf, h16))
    lib = {**timed(torch, "library", lambda: torch.bmm(hf, hft)),
           **timed(torch, "library_bf16", lambda: torch.bmm(h16, h16t)),
           "library_call": ("torch.bmm (W,w,D)x(W,D,w) f32: the Gram alone, "
                            "a yardstick"),
           "library_bf16_call": ("torch.bmm (W,w,D)x(W,D,w) bf16, the mma "
                                 "route's operands: the Gram alone, a "
                                 "yardstick")}
    ptxas = {name: build.ptxas_lines(build.load_library(name).log)
             for name in ("knn_density", "token_merge")}
    # the kernel instance of each (wrapper, route) at w = 16
    fragment = {("knn_density", "mma"): "22knn_density_kernel_mmaILi1E",
                ("knn_density", "simt"): "18knn_density_kernelIfE",
                ("merge_assign", "mma"): "23merge_assign_kernel_mmaILi1E",
                ("merge_assign", "simt"): "19merge_assign_kernelIfE"}
    rows, kernel_rows = [], []
    for dt, which, h in (("bfloat16", "mma", h16), ("float32", "simt", hf)):
        common = {"route": "cuda", "window_route": which,
                  "shape": [nw, w, d], "dtype": dt}
        esize = h.element_size()
        gram_peak = BF16_TC_FLOPS_PER_S if which == "mma" else F32_FLOPS_PER_S

        # ---- B2 knn_density
        before = k.knn_density.launches_by_route[which]
        got = k.knn_density(h, k=kk)
        torch.cuda.synchronize()
        if k.knn_density.launches_by_route[which] != before + 1:
            raise AssertionError(f"knn_density {dt} did not take the "
                                 f"{which} route")
        want = k.ref.knn_density(h, kk)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        gram_ops = 2 * nw * w * w * d
        row_ops = nw * w * w * (4 + 2 * kk)
        nbytes = nw * w * d * esize + nw * w * 4
        ops_s = gram_ops / gram_peak + row_ops / F32_FLOPS_PER_S
        lines = instance_ptxas(ptxas["knn_density"],
                               fragment[("knn_density", which)])
        no_spills(lines, f"knn_density {which}")
        row = dict(
            common, name="knn_density",
            source="src/repro_torch/csrc/knn_density.cu",
            replaces="src/repro/kernels/knn_density.py:41", k=kk,
            max_abs_err=float((got - want).abs().max()),
            **timed(torch, "kernel", lambda: k.knn_density(h, k=kk)),
            **timed(torch, "plain", lambda: k.ref.knn_density(h, kk)),
            **lib, bytes=nbytes, operations=gram_ops + row_ops, ptxas=lines)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops_s)
        rows.append(row)

        # ---- B3 merge_assign
        before = k.merge_assign.launches_by_route[which]
        got = k.merge_assign(h, s, m=m)
        torch.cuda.synchronize()
        if k.merge_assign.launches_by_route[which] != before + 1:
            raise AssertionError(f"merge_assign {dt} did not take the "
                                 f"{which} route")
        want = k.ref.merge_assign(h, s, m)
        check_merge(f"merge_assign {which}", hf, got, want,
                    5e-2 if dt == "bfloat16" else 1e-4)
        dist_ops = 2 * nw * w * m * d + 2 * nw * w * d   # h.c and |h|^2
        mean_ops = 2 * nw * w * d + nw * m * d           # sums and division
        pick_ops = nw * (m * w + w * m * 4)
        nbytes = (nw * w * d * esize + nw * w * 4 + nw * m * d * esize
                  + nw * w * 4 + nw * m * 4)
        ops_s = (dist_ops / gram_peak
                 + (mean_ops + pick_ops) / F32_FLOPS_PER_S)
        lines = instance_ptxas(ptxas["token_merge"],
                               fragment[("merge_assign", which)])
        no_spills(lines, f"merge_assign {which}")
        row = dict(
            common, name="merge_assign",
            source="src/repro_torch/csrc/token_merge.cu",
            replaces="src/repro/kernels/token_merge.py:80", m=m,
            max_abs_err=float((got[0].float() - want[0].float()).abs().max()),
            **timed(torch, "kernel", lambda: k.merge_assign(h, s, m=m)),
            **timed(torch, "plain", lambda: k.ref.merge_assign(h, s, m)),
            **lib, bytes=nbytes, operations=dist_ops + mean_ops + pick_ops,
            ptxas=lines)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops_s)
        rows.append(row)
        if dt == "bfloat16":
            kernel_rows += rows[-2:]
            merged, assign = got[0], got[1]

    # ---- B4 unmerge_scatter, on the bf16 merge_assign's own outputs
    got = k.unmerge_scatter(merged, assign)
    torch.cuda.synchronize()
    want = k.ref.unmerge_scatter(merged, assign)
    if not torch.equal(got, want):
        raise AssertionError("unmerge_scatter is not bitwise")
    idx = assign.long()[..., None].expand(-1, -1, d)
    esize = merged.element_size()
    nbytes = nw * m * d * esize + nw * w * 4 + nw * w * d * esize
    row = dict(
        route="cuda", shape=[nw, w, d], dtype="bfloat16",
        name="unmerge_scatter",
        source="src/repro_torch/csrc/token_merge.cu",
        replaces="src/repro/kernels/token_merge.py:116", m=m,
        max_abs_err=0.0,
        **timed(torch, "kernel", lambda: k.unmerge_scatter(merged, assign)),
        **timed(torch, "plain", lambda: k.ref.unmerge_scatter(merged,
                                                             assign)),
        **timed(torch, "library", lambda: torch.gather(merged, 1, idx)),
        library_call="torch.gather along the window axis", bytes=nbytes,
        operations=0)
    row["bound_ms"], row["bound_by"] = bound(nbytes, 0.0)
    rows.append(row)
    kernel_rows.append(row)
    for row in rows:
        row["ms"] = row["kernel_ms"]
        emit({"phase": "kernel", **row})
    return kernel_rows


@contextlib.contextmanager
def capture_windows(core_tm, sink):
    """Record the inputs of the first PARITY_CALLS calls that reach the
    knn_density and merge_assign wrappers from core/token_merge.py (copies
    on the card), into ``sink[name]`` as (args, kwargs)."""
    orig = {"knn_density": core_tm._knn_kernel,
            "merge_assign": core_tm.merge_assign}

    def recorder(name):
        def rec(*args, **kw):
            if len(sink[name]) < PARITY_CALLS:
                sink[name].append(([a.clone() for a in args], dict(kw)))
            return orig[name](*args, **kw)
        return rec

    core_tm._knn_kernel = recorder("knn_density")
    core_tm.merge_assign = recorder("merge_assign")
    try:
        yield
    finally:
        core_tm._knn_kernel = orig["knn_density"]
        core_tm.merge_assign = orig["merge_assign"]


def phase_window_parity(torch, captured, knn_mod, tm_mod):
    """Both routes of knn_density and merge_assign on the windows the merged
    serve handed the wrappers: rho within 1e-4, centers and assign exact,
    merged bitwise (the routes share the means' arithmetic)."""
    if any(len(v) != PARITY_CALLS for v in captured.values()):
        raise AssertionError(f"captured {[len(v) for v in captured.values()]}"
                             f" calls, expected {PARITY_CALLS} of each")
    worst, rho_bitwise, windows = 0.0, 0, 0
    for (h,), kw in captured["knn_density"]:
        mma = knn_mod._launch("mma", h, kw["k"])
        simt = knn_mod._launch("simt", h, kw["k"])
        torch.testing.assert_close(mma, simt, rtol=1e-4, atol=1e-4)
        worst = max(worst, float((mma - simt).abs().max()))
        rho_bitwise += int((mma == simt).all(dim=-1).sum())
        windows += h.shape[0]
    for (h, s), kw in captured["merge_assign"]:
        mma = tm_mod._launch("mma", h, s, kw["m"])
        simt = tm_mod._launch("simt", h, s, kw["m"])
        check_merge("served windows, mma against simt", h.float(), mma,
                    simt, None)
    torch.cuda.synchronize()
    emit({"phase": "window_parity", "calls": PARITY_CALLS,
          "windows": windows, "dtype": str(captured["knn_density"][0][0][0]
                                           .dtype),
          "shape": list(captured["merge_assign"][0][0][0].shape),
          "max_abs_rho_diff": worst,
          "windows_with_bitwise_rho": rho_bitwise,
          "centers_assign_equal": True, "merged_bitwise": True})


def cold_device_ms(torch, fn, flush, iters: int = 20,
                   attempts: int = 4) -> float:
    """Device time per call with the L2 cold: ``iters`` calls, each after a
    write of ``flush`` (at least 64 MB, more than the 50 MB L2) that evicts
    its inputs, queued behind a spin kernel as in ``device_ms``; less the
    same window of flushes alone.  The median of three such pairs."""
    fn()
    torch.cuda.synchronize()

    def window(with_fn: bool, cycles: int, n: int):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            flush.fill_(1.0)
            if with_fn:
                fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        return start.elapsed_time(end) if ahead else None

    cycles = SPIN_CYCLES
    for _ in range(attempts):
        per_call = []
        for _ in range(3):
            both, alone = window(True, cycles, iters), window(False, cycles,
                                                             iters)
            if both is None or alone is None:
                break
            per_call.append((both - alone) / iters)
        if len(per_call) == 3:
            return sorted(per_call)[1]
        cycles *= 4
        iters = max(1, iters // 2)
    raise AssertionError(f"the host fell behind the card in {attempts} "
                         f"windows; the timed function waits for the card")


def phase_saliency_delta(torch, dev, ref, sal_mod, build):
    """saliency_delta at SAL_SHAPES: the wrapper on the onepass route
    against the plain version and against the SIMT route (bitwise), both
    routes timed warm and L2-cold, the onepass kernel's ptxas lines and
    whether its blocks fit on the card in one wave.  Returns the rows by
    shape (the first shape's: the merge-off serve's)."""
    saliency_delta = sal_mod.saliency_delta
    ptxas = build.ptxas_lines(build.load_library("saliency_delta").log)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    rows = []
    for i, (b, n, d, dt) in enumerate(SAL_SHAPES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(dev).manual_seed(6 + i)
        x = torch.randn((b, n, d), generator=gen, device=dev)
        prev = (x + 0.1 * torch.randn((b, n, d), generator=gen,
                                      device=dev)).to(dtype)
        x = x.to(dtype)
        before = dict(saliency_delta.launches_by_route)
        got = saliency_delta(x, prev)
        torch.cuda.synchronize()
        if saliency_delta.launches_by_route["onepass"] != before["onepass"] + 1:
            raise AssertionError(f"saliency_delta {dt} {(b, n, d)} did not "
                                 f"take the onepass route")
        if sal_mod.tickets(b) != [0] * b:
            raise AssertionError(f"saliency_delta {(b, n, d)}: tickets not "
                                 f"left at zero")
        want = ref.saliency_delta(x, prev)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=0)
        simt = sal_mod._launch("simt", x, prev)
        if not all(torch.equal(g, c) for g, c in zip(got, simt)):
            raise AssertionError(f"saliency_delta {dt} {(b, n, d)}: the "
                                 f"onepass and SIMT routes differ")
        for _ in range(2):
            if not all(torch.equal(a, c) for a, c in
                       zip(got, saliency_delta(x, prev))):
                raise AssertionError("saliency_delta does not repeat bitwise")
        dd = x.float() - prev.float()
        esize = x.element_size()
        nbytes = 2 * b * n * d * esize + b * n * 4 + 2 * b * 4
        ops = 5 * b * n * d + 2 * b * n           # sub, 2 FMAs; the sums
        bound_ms, bound_by = bound(nbytes, ops / F32_FLOPS_PER_S)
        lines = instance_ptxas(ptxas, "22saliency_delta_onepassI"
                               + ("13__nv_bfloat16E" if dt == "bfloat16"
                                  else "fE"))
        no_spills(lines, f"saliency_delta onepass {dt}")
        plan = sal_mod.route.saliency_plan(n)
        row = {"name": "saliency_delta", "route": "cuda",
               "sal_route": "onepass",
               "source": "src/repro_torch/csrc/saliency_delta.cu",
               "replaces": "src/repro/kernels/saliency_delta.py:47",
               "shape": [b, n, d], "dtype": dt,
               "max_abs_err": max(float((g - w).abs().max())
                                  for g, w in zip(got, want)),
               "routes_bitwise_equal": True,
               **timed(torch, "kernel", lambda: saliency_delta(x, prev)),
               "kernel_cold_device_ms": cold_device_ms(
                   torch, lambda: saliency_delta(x, prev), flush),
               **timed(torch, "simt",
                       lambda: sal_mod._launch("simt", x, prev)),
               "simt_cold_device_ms": cold_device_ms(
                   torch, lambda: sal_mod._launch("simt", x, prev), flush),
               **timed(torch, "plain",
                       lambda: ref.saliency_delta(x, prev)),
               **timed(torch, "library", lambda: torch.sum(dd * dd, -1)),
               "library_call": ("torch.sum(d*d, -1) on the f32 difference: "
                                "the per-token output alone, a yardstick"),
               "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
               "bound_by": bound_by, "plan": plan._asdict(),
               "blocks_per_sm": sal_mod.onepass_blocks_per_sm(dtype),
               "sms": torch.cuda.get_device_properties(dev)
               .multi_processor_count, "ptxas": lines}
        row["one_wave"] = (row["blocks_per_sm"] * row["sms"]
                           >= plan.groups * b)
        row["bound_share_warm"] = bound_ms / row["kernel_device_ms"]
        row["bound_share_cold"] = bound_ms / row["kernel_cold_device_ms"]
        row["ms"] = row["kernel_ms"]
        emit({"phase": "kernel", **row})
        rows.append(row)
    return rows


@contextlib.contextmanager
def capture_saliency(modules, sink):
    """Record the inputs of the first PARITY_CALLS calls that reach the
    saliency_delta wrapper from each module in ``modules`` (core/saliency.py
    and core/policies/base.py; copies on the card), into ``sink``."""
    orig = [m.saliency_delta for m in modules]

    def recorder(fn):
        def rec(x, x_prev):
            if len(sink) < PARITY_CALLS:
                sink.append(tuple(t.clone() if t.dim() == 3 else t[None].clone()
                                  for t in (x, x_prev)))
            return fn(x, x_prev)
        return rec

    for m, fn in zip(modules, orig):
        m.saliency_delta = recorder(fn)
    try:
        yield
    finally:
        for m, fn in zip(modules, orig):
            m.saliency_delta = fn


def phase_saliency_parity(torch, policy, captured, sal_mod):
    """Both routes of saliency_delta on the inputs the ``policy`` serve
    handed the wrapper: sal, diff and prevsq bitwise equal."""
    if len(captured) != PARITY_CALLS:
        raise AssertionError(f"captured {len(captured)} saliency_delta "
                             f"calls of {policy}, expected {PARITY_CALLS}")
    for x, prev in captured:
        onepass = sal_mod._launch("onepass", x, prev)
        simt = sal_mod._launch("simt", x, prev)
        if not all(torch.equal(a, c) for a, c in zip(onepass, simt)):
            raise AssertionError(f"{policy}: the saliency_delta routes "
                                 f"differ on a served input")
    torch.cuda.synchronize()
    emit({"phase": "saliency_parity", "policy": policy,
          "calls": PARITY_CALLS, "shape": list(captured[0][0].shape),
          "dtype": str(captured[0][0].dtype), "bitwise": True})


def phase_linear_blend(torch, dev, ref, linear_blend, build):
    """linear_blend against its plain version at BLEND_SHAPES; returns the
    rows by shape (the first shape's: the callers', gamma 1 at 4 slots).
    The rows on the gemv route (the decode gates') also time the wgmma
    route on the same inputs and read the tickets back at zero."""
    from repro_torch.cuda_kernels import route
    lb_mod = importlib.import_module("repro_torch.cuda_kernels.linear_blend")
    ptxas = build.ptxas_lines(build.load_library("linear_blend").log)
    fragment = {"wgmma": "25linear_blend_kernel_wgmmaE",
                "gemv": "24linear_blend_kernel_gemvE",
                "simt": "19linear_blend_kernelIfE"}
    rows = []
    for i, (m, d, f, dt, gamma) in enumerate(BLEND_SHAPES):
        dtype = getattr(torch, dt)
        gen = torch.Generator(dev).manual_seed(10 + i)
        x = torch.randn((m, d), generator=gen, device=dev).to(dtype)
        w = torch.eye(d, f, device=dev) + 0.01 * torch.randn(
            (d, f), generator=gen, device=dev)
        w_bf16 = w.to(torch.bfloat16)     # the copy a policy makes once
        b = 0.1 * torch.randn((f,), generator=gen, device=dev)
        prev = torch.randn((m, f), generator=gen, device=dev).to(dtype)
        before = dict(linear_blend.launches_by_route)
        got = linear_blend(x, w, b, prev, gamma=gamma, w_bf16=w_bf16)
        torch.cuda.synchronize()
        which = ("simt" if dt != "bfloat16" else "gemv"
                 if m <= route.GEMV_MAX_ROWS else "wgmma")
        if linear_blend.launches_by_route[which] != before[which] + 1:
            raise AssertionError(f"linear_blend {dt} ({m}, {d}, {f}) did not "
                                 f"take the {which} route")
        want = ref.linear_blend(x, w, b, prev, gamma)
        tol = BLEND_TOL[dt]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if not torch.equal(got, linear_blend(x, w, b, prev, gamma=gamma,
                                             w_bf16=w_bf16)):
            raise AssertionError("linear_blend does not repeat bitwise")
        # the library calls: x @ w with alpha = gamma, the bias and the
        # blend folded into addmm's input outside the timed call, in f32
        # and in bf16 with the bf16 W (the wgmma route's operands)
        xf = x.float()
        folded = gamma * b + (1.0 - gamma) * prev.float()
        folded_bf16 = folded.to(torch.bfloat16)
        x_bf16 = x.to(torch.bfloat16)
        esize = x.element_size()
        wsize = 4 if which == "simt" else 2
        nbytes = (m * d * esize + d * f * wsize + f * 4 + m * f * esize
                  + (m * f * esize if gamma != 1.0 else 0))
        gemm = 2 * m * d * f
        simd = m * f * (1 if gamma == 1.0 else 4)
        peak = F32_FLOPS_PER_S if which == "simt" else BF16_TC_FLOPS_PER_S
        bound_ms, bound_by = bound(nbytes, gemm / peak
                                   + simd / F32_FLOPS_PER_S)
        row = {"name": "linear_blend", "route": "cuda", "gemm_route": which,
               "source": "src/repro_torch/csrc/linear_blend.cu",
               "replaces": "src/repro/kernels/linear_blend.py:41",
               "shape": [m, d, f], "dtype": dt, "gamma": gamma,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               **timed(torch, "kernel",
                       lambda: linear_blend(x, w, b, prev, gamma=gamma,
                                            w_bf16=w_bf16)),
               **timed(torch, "plain",
                       lambda: ref.linear_blend(x, w, b, prev, gamma)),
               **timed(torch, "library",
                       lambda: torch.addmm(folded, xf, w, alpha=gamma)),
               **timed(torch, "library_bf16",
                       lambda: torch.addmm(folded_bf16, x_bf16, w_bf16,
                                           alpha=gamma)),
               "library_call": ("torch.addmm f32, alpha=gamma, bias and "
                                "blend folded into its input"),
               "library_bf16_call": ("torch.addmm bf16 X and the bf16 W, "
                                     "alpha=gamma, bias and blend folded"),
               "bytes": nbytes, "operations": gemm + simd,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ptxas": instance_ptxas(ptxas, fragment[which])}
        if which == "gemv":
            plan = route.gemv_plan(m, d, f)
            tickets = lb_mod.gemv_tickets(plan.tiles * plan.groups)
            if any(tickets):
                raise AssertionError(f"gemv tickets left at {tickets}")
            row.update(
                plan=plan._asdict(), blocks=plan.tiles * plan.splits,
                **timed(torch, "wgmma", lambda: lb_mod._launch(
                    "wgmma", x, w, b, prev, gamma, w_bf16)),
                wgmma_is="the wgmma route (the decode gate's route until "
                         "the gemv route) on the same inputs")
        row["ms"] = row["kernel_ms"]
        emit({"phase": "kernel", **row})
        rows.append(row)
    return rows


def phase_linear_blend_split(torch, dev, ref, linear_blend, lb_mod, build):
    """linear_blend on the wgmma_split route at SPLIT_BLEND_SHAPES, gamma
    1, bf16, with a cancelling W (a fitted map's: 600 (I - 1 1^T / D) plus
    noise, met by inputs with a large common part) that one bf16 copy
    misses by more than CALIBRATED_REL_L2: within BLEND_TOL elementwise and
    SPLIT_REL_L2 in rel-L2, repeated calls bitwise.  Returns the rows by
    shape (the first: the fitted bypass)."""
    from repro_torch.core.linear_approx import split_copies
    from repro_torch.cuda_kernels.route import SPLIT_TERMS
    ptxas = build.ptxas_lines(build.load_library("linear_blend").log)
    bf16, rows = torch.bfloat16, []
    for i, (m, d, f) in enumerate(SPLIT_BLEND_SHAPES):
        gen = torch.Generator(dev).manual_seed(40 + i)
        x = (3.0 + 0.05 * torch.randn((m, d), generator=gen,
                                      device=dev)).to(bf16)
        w = (600.0 * (torch.eye(d, f, device=dev) - 1.0 / d)
             + torch.randn((d, f), generator=gen, device=dev))
        (w_split,) = split_copies(w, bf16, dev)
        b = 0.1 * torch.randn((f,), generator=gen, device=dev)
        prev = torch.randn((m, f), generator=gen, device=dev).to(bf16)
        before = linear_blend.launches_by_route["wgmma_split"]
        got = linear_blend(x, w, b, prev, gamma=1.0, w_bf16=w_split)
        torch.cuda.synchronize()
        if linear_blend.launches_by_route["wgmma_split"] != before + 1:
            raise AssertionError(f"linear_blend ({m}, {d}, {f}) with a "
                                 "split copy did not take wgmma_split")
        want = ref.linear_blend(x, w, b, prev, 1.0)
        tol = BLEND_TOL["bfloat16"]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        rel = rel_l2(torch, got, want)
        single = rel_l2(torch, lb_mod._launch("wgmma", x, w, b, prev, 1.0,
                                              w.to(bf16)), want)
        if rel > SPLIT_REL_L2 or single <= CALIBRATED_REL_L2:
            raise AssertionError(f"linear_blend ({m}, {d}, {f}): split "
                                 f"rel-L2 {rel}, one bf16 copy {single}")
        if not torch.equal(got, linear_blend(x, w, b, prev, gamma=1.0,
                                             w_bf16=w_split)):
            raise AssertionError("wgmma_split route does not repeat "
                                 "bitwise")
        # every term read and summed: a copy whose terms are independent
        planted, planted_w, planted_last = planted_split(torch, gen, d, f,
                                                         dev)
        planted_rel = check_planted(
            torch, f"linear_blend ({m}, {d}, {f})",
            linear_blend(x, planted_w, b, prev, gamma=1.0, w_bf16=planted),
            ref.linear_blend(x, planted_w, b, prev, 1.0),
            ref.linear_blend(x, planted_w - planted_last, b, prev, 1.0))
        xf, folded = x.float(), b.expand(m, f).contiguous()
        # the function's bound: X and out in bf16, the f32 W and bias read
        # once; one GEMM on the bf16 tensor cores.  The split's own work
        # (``passes_*``): the split copy read (every term, padding rows
        # included: the kernel reads them), one pass of the GEMM per term
        nbytes = m * d * 2 + d * f * 4 + f * 4 + m * f * 2
        gemm = 2 * m * d * f
        bound_ms, bound_by = bound(nbytes, gemm / BF16_TC_FLOPS_PER_S
                                   + m * f / F32_FLOPS_PER_S)
        passes_bytes = m * d * 2 + w_split.numel() * 2 + f * 4 + m * f * 2
        passes_bound, passes_by = bound(passes_bytes,
                                        gemm * SPLIT_TERMS
                                        / BF16_TC_FLOPS_PER_S
                                        + m * f / F32_FLOPS_PER_S)
        row = {"name": "linear_blend", "route": "cuda",
               "gemm_route": "wgmma_split",
               "source": "src/repro_torch/csrc/linear_blend.cu",
               "replaces": "src/repro/kernels/linear_blend.py:41",
               "shape": [m, d, f], "dtype": "bfloat16", "gamma": 1.0,
               "w": "600 (I - 1 1^T / D) + N(0, 1), X = 3 + 0.05 N(0, 1)",
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "rel_l2": rel, "bf16_copy_rel_l2": single,
               **timed(torch, "kernel",
                       lambda: linear_blend(x, w, b, prev, gamma=1.0,
                                            w_bf16=w_split)),
               **timed(torch, "plain",
                       lambda: ref.linear_blend(x, w, b, prev, 1.0)),
               **timed(torch, "library",
                       lambda: torch.addmm(folded, xf, w)),
               "library_call": "torch.addmm f32, the bias folded",
               "bytes": nbytes, "operations": gemm + m * f,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "passes_bytes": passes_bytes,
               "passes_operations": gemm * SPLIT_TERMS + m * f,
               "passes_bound_ms": passes_bound, "passes_bound_by": passes_by,
               "planted_rel_l2": planted_rel["rel_l2"],
               "planted_drop_term_rel_l2": planted_rel["drop_term_rel_l2"],
               "ptxas": instance_ptxas(ptxas, "25linear_blend_kernel_wgmmaE")}
        row["ms"] = row["kernel_ms"]
        emit({"phase": "kernel", **row})
        rows.append(row)
    return rows


def sync_flags(torch, fn):
    """Run ``fn`` under torch.cuda's sync-debug mode.  Returns its result,
    every synchronization flagged, by source line, and those flagged in the
    port's own code (torch's lazy first-use initialisation can flag one
    more in the process's first serve)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    flags = [w for w in caught if "synchroniz" in str(w.message)]
    sources = collections.Counter(
        f"{Path(w.filename).name}:{w.lineno}" for w in flags)
    in_port = sum(1 for w in flags
                  if Path(w.filename).resolve().is_relative_to(ROOT / "src"))
    return out, len(flags), dict(sources.most_common()), in_port


def phase_syncs(torch, wl, model, label="syncs"):
    """Warm-up serve (its first warm steps eager), then the same serve
    under sync debug: its warm steps are graph replays (the first one
    captured), so the policy reads nothing; every synchronization flagged,
    by source line, beside the syncs the code counts.  Returns both per
    model step."""
    wl.warm_up(model)
    (runner, eng), flagged, sources, in_port = sync_flags(
        torch, lambda: wl.warm_up(model))
    counted = runner.impl.host_syncs + eng.host_syncs
    steps = eng.model_steps
    kinds = dict(runner.impl.step_kinds)
    emit({"phase": label, "policy": wl.policy, "model_steps": steps,
          "step_kinds": kinds, "graph_captures": runner.graphs.captures,
          "graph_replays": runner.graphs.replays,
          "counted": counted, "flagged": flagged,
          "flagged_in_port": in_port,
          "policy_host_syncs_per_model_step": runner.impl.host_syncs / steps,
          "counted_per_model_step": counted / steps,
          "flagged_in_port_per_model_step": in_port / steps,
          "sources": sources})
    if runner.graphs.replays != kinds["warm"] or kinds["warm"] == 0:
        raise AssertionError(f"{wl.policy}: {runner.graphs.replays} graph "
                             f"replays, {kinds} steps: every warm step of a "
                             "warmed-up serve replays the step graph")
    if runner.impl.host_syncs != 0:
        raise AssertionError(f"{wl.policy}: {runner.impl.host_syncs} policy "
                             f"syncs in {steps} model steps, expected none")
    if in_port != counted:
        raise AssertionError(f"{wl.policy}: sync debug flagged {in_port} "
                             f"syncs in the port's code, the code counts "
                             f"{counted}: {sources}")
    return counted / steps, in_port / steps


def ifs_per_step(policy: str, layers: int):
    """(IF nodes, condition kernels) in one replayed warm step: a node per
    layer for the per-layer skips, fastcache's conditions set by
    fused_gate's GEMM (no kernel; the serves here have no model group) and
    smoothcache's by a kernel each; one node and one kernel for the
    step-level policies' whole stack; none for l2c (a static mask) and
    nocache."""
    if policy == "fastcache":
        return layers, 0
    if policy == "smoothcache":
        return layers, layers
    return (0, 0) if policy in ("l2c", "nocache") else (1, 1)


def check_if_nodes(label, wl, runner, m) -> None:
    """The IF nodes a serve's replays added (``if_all.nodes``, read just
    after the serve, zeroed just before it) against ifs_per_step."""
    want = ifs_per_step(wl.policy, runner.L)[0] * runner.graphs.replays
    if m.kernels["if_all"].nodes != want:
        raise AssertionError(f"{label}: {m.kernels['if_all'].nodes} IF "
                             f"nodes, expected {want}")


def expected_launches(wl, runner, eng, names):
    """Each kernel's launch count on a serve of ``wl``, from what the serve
    did: fastcache runs fused_gate in every layer and saliency_delta and
    linear_blend once per gated (warm or mixed) model step, the merge
    kernels once per model step (unmerge_scatter once more per mixed step);
    teacache, adacache and fbcache run saliency_delta once per model step,
    l2c linear_blend once per masked layer and model step; fora and
    smoothcache, and nocache, run none.  Every replayed warm step also
    runs if_all's condition kernels (ifs_per_step)."""
    want = dict.fromkeys(names, 0)
    steps = eng.model_steps
    # the condition kernels of the IF nodes, each replay
    want["if_all"] = (ifs_per_step(wl.policy, runner.L)[1]
                      * runner.graphs.replays)
    if wl.policy == "fastcache":
        kinds = runner.impl.step_kinds
        gated = kinds["warm"] + kinds["mixed"]
        want.update(fused_gate=runner.L * gated,
                    saliency_delta=gated + audited_layer_steps(wl, runner,
                                                              eng),
                    linear_blend=gated)
        if runner.reducer is not None:
            want.update(knn_density=steps, merge_assign=steps,
                        unmerge_scatter=steps + kinds["mixed"])
    elif wl.policy in ("teacache", "adacache", "fbcache"):
        want["saliency_delta"] = steps
    elif wl.policy == "l2c":
        want["linear_blend"] = sum(runner.impl.mask) * steps
    return want


def audited_layer_steps(wl, runner, eng) -> int:
    """Model steps on which the audit plane measured per-layer error (one
    saliency_delta launch each): the audited steps of a policy that keeps
    its hidden stack (fastcache without token merging)."""
    if wl.policy != "fastcache" or runner.reducer is not None:
        return 0
    return eng.audited_steps


def zero_counts() -> None:
    """Every wrapper's launch count, and the per-route and per-mode ones,
    to 0."""
    from repro_torch import cuda_kernels
    cuda_kernels.zero_counts()


def phase_serve(torch, dev, wl, model, m, label="serve", engine_kwargs=None,
                parent_ratio=True, extra=None, routes=None):
    """Serve ``wl`` on a fresh engine (built with ``engine_kwargs``: a
    collector, a tracer, ``fc_params``, the metrics plane off), timed;
    every kernel's launch count is zeroed just before and read just after.
    ``parent_ratio``: hold a merge-off fastcache serve's ratio to
    PARENT_BLOCK_CACHE_RATIO; ``routes`` overrides ROUTE_OF_SERVE's routes
    by name.  Returns the counts by name, the finished requests, the wall
    seconds, the runner and the engine."""
    runner, eng = wl.build_engine(model, **(engine_kwargs or {}))
    trace = wl.build_trace(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                         # the path starts here
    t0 = time.perf_counter()
    done = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    by_route = {name: dict(m.kernels[name].launches_by_route)
                for name in ROUTE_OF_SERVE}
    kinds = dict(getattr(runner.impl, "step_kinds", {}))
    if len(done) != len(trace):
        raise AssertionError(f"{len(done)} of {len(trace)} requests finished")
    for r in done:
        if r.latents.shape != latent_shape(model) or not np.isfinite(r.latents).all():
            raise AssertionError(f"rid={r.rid}: latents {r.latents.shape} "
                                 "not finite")
    want = expected_launches(wl, runner, eng, launches)
    if launches != want:
        raise AssertionError(f"{wl.policy}: launches {launches} != "
                             f"{want} ({kinds}, {eng.model_steps} model "
                             "steps)")
    check_if_nodes(label, wl, runner, m)
    if wl.policy == "fastcache" and launches["fused_gate"] <= 0:
        raise AssertionError("fused_gate never launched: no gated step")
    for name, which in {**ROUTE_OF_SERVE, **(routes or {})}.items():
        # bf16 at D=1152: one route per kernel
        if by_route[name] != {**dict.fromkeys(by_route[name], 0),
                              which: launches[name]}:
            raise AssertionError(f"{wl.policy}: {name} launches by route "
                                 f"{by_route[name]}, expected all "
                                 f"{launches[name]} on {which}")
    stats = eng.cache_stats()
    if (parent_ratio and wl.policy == "fastcache" and runner.reducer is None
            and stats["block_cache_ratio"] != PARENT_BLOCK_CACHE_RATIO):
        raise AssertionError(f"block cache ratio {stats['block_cache_ratio']}"
                             f" != {PARENT_BLOCK_CACHE_RATIO}, the SIMT "
                             "route's")
    if (wl.policy in PARENT_POLICY_STATS and
            (stats["block_cache_ratio"], stats["steps_reused"])
            != PARENT_POLICY_STATS[wl.policy]):
        raise AssertionError(f"{wl.policy}: block cache ratio and steps "
                             f"reused {stats['block_cache_ratio']}, "
                             f"{stats['steps_reused']} != the parent's "
                             f"{PARENT_POLICY_STATS[wl.policy]}")
    merge = {}
    if runner.reducer is not None:
        kept = stats["tokens_kept"] / (stats["tokens_kept"]
                                       + stats["tokens_merged"])
        if kept != wl.merge_ratio:
            raise AssertionError(f"kept-token share {kept} != "
                                 f"{wl.merge_ratio}")
        merge = {"kept_token_share": kept,
                 "reduced_tokens": runner.reducer.reduced_tokens}
    lats = [r.latency_steps for r in done]
    emit({"phase": label, "policy": wl.policy, "arch": model.cfg.name,
          "slots": wl.slots, "steps": wl.steps,
          "merge_ratio": wl.merge_ratio, "merge_window": wl.merge_window,
          "requests": len(done), "engine_steps": eng.clock,
          "model_steps": eng.model_steps, "step_kinds": kinds,
          "wall_s": wall, "engine_steps_per_s": eng.clock / wall,
          "latency_steps_p50": m.percentile(lats, 50),
          "latency_steps_p95": m.percentile(lats, 95),
          "block_cache_ratio": stats["block_cache_ratio"],
          "steps_reused": stats["steps_reused"],
          "launches": launches, "launches_by_route": by_route, **merge,
          "policy_host_syncs": runner.impl.host_syncs,
          "engine_host_syncs": eng.host_syncs,
          "host_syncs_per_model_step": (runner.impl.host_syncs
                                        + eng.host_syncs) / eng.model_steps,
          "audit_fraction": wl.audit_fraction, "cfg_rows": wl.cfg_rows,
          "metrics_plane": bool(eng.metrics), **(extra or {}),
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    return SimpleNamespace(launches=launches, done=done, wall=wall,
                           if_nodes=m.kernels["if_all"].nodes,
                           runner=runner, eng=eng, stats=stats)


def phase_static(torch, dev, model, m):
    runner = m.CachedDiT(model, m.FastCacheConfig(), policy="fastcache")
    gen = torch.Generator(dev).manual_seed(1)
    b = 8
    x = torch.randn((b,) + latent_shape(model), generator=gen, device=dev)
    labels = torch.arange(b, device=dev)
    t = torch.full((b,), 500, device=dev)
    state = runner.init_state(b)
    for _ in range(6):
        eps, state = runner.step(state, x, t, labels)
    s = m.summarize_stats(state)
    if not torch.isfinite(eps).all():
        raise AssertionError("static drive: eps not finite")
    emit({"phase": "static", "steps": 6, "batch": b,
          "block_cache_ratio": s["block_cache_ratio"],
          "mean_motion_fraction": s["mean_motion_fraction"]})
    if not s["block_cache_ratio"] > 0.4:
        raise AssertionError(f"static drive cache ratio {s}")


def phase_quality(torch, dev, model, m, policy_kwargs):
    """Relative L2 of each policy's eps against nocache's on the same
    inputs for 6 DDIM steps (fastcache also with merging on)."""
    fc_merge = m.FastCacheConfig(merge_enabled=True, merge_ratio=MERGE_RATIO)
    nc = m.CachedDiT(model, m.FastCacheConfig(), policy="nocache")
    runners = {"fastcache": m.CachedDiT(model, m.FastCacheConfig(),
                                        policy="fastcache"),
               "fastcache_merge": m.CachedDiT(model, fc_merge,
                                              policy="fastcache")}
    for p in BASELINES:
        runners[p] = m.CachedDiT(model, m.FastCacheConfig(), policy=p,
                                 **policy_kwargs.get(p, {}))
    b = 8
    gen = torch.Generator(dev).manual_seed(2)
    x = torch.randn((b,) + latent_shape(model), generator=gen, device=dev)
    labels = torch.arange(b, device=dev) * 7
    sched = m.linear_schedule(1000, device=dev)
    ts = m.ddim_timesteps(1000, 50, device=dev)
    s_nc = nc.init_state(b)
    states = {k: r.init_state(b) for k, r in runners.items()}
    rel = {k: [] for k in runners}

    def rel_l2(a, ref_eps):
        return float((a.float() - ref_eps.float()).norm()
                     / ref_eps.float().norm())

    for i in range(6):
        t = ts[i].expand(b)
        eps_nc, s_nc = nc.step(s_nc, x, t, labels)
        for k, r in runners.items():
            eps, states[k] = r.step(states[k], x, t, labels)
            rel[k].append(rel_l2(eps, eps_nc))
        x = m.ddim_step(sched, x, eps_nc, t, ts[i + 1].expand(b))
    if not all(v == v for vals in rel.values() for v in vals):
        raise AssertionError(f"quality: NaN relative error {rel}")
    emit({"phase": "quality", "steps": 6,
          "rel_l2_eps_fastcache_vs_nocache": rel["fastcache"],
          "block_cache_ratio":
          m.summarize_stats(states["fastcache"])["block_cache_ratio"],
          "rel_l2_eps_fastcache_merge_vs_nocache": rel["fastcache_merge"],
          "block_cache_ratio_merge":
          m.summarize_stats(states["fastcache_merge"])["block_cache_ratio"],
          "rel_l2_eps_vs_nocache": {p: rel[p] for p in BASELINES},
          "block_cache_ratio_by_policy": {
              p: m.summarize_stats(states[p])["block_cache_ratio"]
              for p in BASELINES}})


def l2c_calibration(torch, dev, model, m):
    """l2c's mask: the L2C_SKIP layers whose block moves the residual stream
    least, by the per-layer relative change of one nocache full forward,
    taken by ``_rel_change`` (so through saliency_delta).  Returned on the
    host, so building a runner from it syncs nothing."""
    runner = m.CachedDiT(model, m.FastCacheConfig(), policy="nocache")
    b = 8
    gen = torch.Generator(dev).manual_seed(5)
    x = torch.randn((b,) + latent_shape(model), generator=gen, device=dev)
    x_in = model.tokens_in(x)
    c = model.conditioning(torch.full((b,), 500, device=dev),
                           torch.arange(b, device=dev))
    with torch.no_grad():
        x_out, inputs = runner.impl._full_forward(x_in, c)
        hidden = torch.cat([inputs, x_out[None]])
        deltas = torch.stack([runner.impl._rel_change(hidden[i + 1],
                                                      hidden[i]).mean()
                              for i in range(runner.L)])
    mask = m.l2c_mask_from_deltas(deltas, L2C_SKIP).cpu()
    skipped = mask.nonzero().flatten().tolist()
    emit({"phase": "l2c_calibration", "deltas": deltas.tolist(),
          "skipped_layers": skipped})
    if skipped != PARENT_L2C_SKIPPED:
        raise AssertionError(f"l2c skips layers {skipped}, the parent "
                             f"{PARENT_L2C_SKIPPED}")
    return mask


def flash_live_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks keep: the work this input needs."""
    qpos = np.arange(sq)[:, None] + (skv - sq)
    kpos = np.arange(skv)[None, :]
    live = np.ones((sq, skv), bool)
    if causal:
        live &= kpos <= qpos
    if window > 0:
        live &= kpos > qpos - window
    return int(live.sum())


def instance_ptxas(lines, fragment: str):
    """The ptxas lines of one kernel in a ``build.ptxas_lines`` list, the
    one whose mangled name holds ``fragment`` (e.g. ``15gate_gemm_wgmmaE``
    or ``flash_attention_kernel_simtILi64E``): its entry line and the lines
    up to the next entry."""
    out, mine = [], False
    for ln in lines:
        if "Compiling entry" in ln:
            mine = fragment in ln
        if mine:
            out.append(ln)
    return out


def phase_flash_attention(torch, dev, ref, flash_attention, build,
                          shapes=FLASH_SHAPES):
    """flash_attention against its plain version at ``shapes``; returns
    the rows by key (FLASH_SHAPES' (a): the serve's prefill)."""
    import torch.nn.functional as F
    from repro_torch.cuda_kernels.flash_attention import instance_dh
    ptxas = build.ptxas_lines(build.load_library("flash_attention").log)
    rows = {}
    for key, (b, h, kvh, sq, skv, dh, causal, window, dt) in shapes.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(dev).manual_seed(4)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, h, sq, dh), (b, kvh, skv, dh),
                                 (b, kvh, skv, dh)))
        kw = dict(causal=causal, window=window)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, **kw)
        tol = FLASH_TOL[dt]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        if causal and sq == skv and not 0 < window < skv:   # plain causal
            sdpa = dict(is_causal=True)
            call = "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)"
        elif not causal and window == 0:                    # no mask
            sdpa = dict(is_causal=False)
            call = ("F.scaled_dot_product_attention(is_causal=False, "
                    "enable_gqa=True)")
        else:
            qpos = torch.arange(sq, device=dev)[:, None] + (skv - sq)
            kpos = torch.arange(skv, device=dev)[None, :]
            mask = (kpos <= qpos) if causal else torch.ones_like(kpos > qpos)
            if window > 0:
                mask = mask & (kpos > qpos - window)
            sdpa = dict(attn_mask=mask)
            call = ("F.scaled_dot_product_attention(attn_mask=bool mask, "
                    "enable_gqa=True)")
        lib_out = F.scaled_dot_product_attention(q, k, v, enable_gqa=True,
                                                 **sdpa)
        torch.testing.assert_close(lib_out.float(), want.float(), rtol=tol,
                                   atol=tol)
        esize = q.element_size()
        pairs = flash_live_pairs(sq, skv, causal, window)
        nbytes = esize * dh * (2 * b * h * sq + 2 * b * kvh * skv)
        ops = 4 * dh * b * h * pairs                 # QK^T and PV, live only
        peak = BF16_TC_FLOPS_PER_S if dt == "bfloat16" else F32_FLOPS_PER_S
        bound_ms, bound_by = bound(nbytes, ops / peak)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:74",
               "case": key, "shape": [b, h, kvh, sq, skv, dh],
               "causal": causal, "window": window, "dtype": dt,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               **timed(torch, "kernel", lambda: flash_attention(q, k, v, **kw)),
               **timed(torch, "plain",
                       lambda: ref.flash_attention(q, k, v, **kw)),
               **timed(torch, "library", lambda: F.scaled_dot_product_attention(
                   q, k, v, enable_gqa=True, **sdpa)),
               "library_call": call, "live_pairs": pairs, "bytes": nbytes,
               "operations": ops, "bound_ms": bound_ms, "bound_by": bound_by}
        row["ms"] = row["kernel_ms"]
        row["vs_library"] = (row["kernel_device_ms"]
                             / row["library_device_ms"])
        row["instance_dh"] = instance_dh(dh)
        row["ptxas"] = instance_ptxas(
            ptxas, "flash_attention_kernel_"
            + ("wgmma" if dt == "bfloat16" else "simt")
            + f"ILi{row['instance_dh']}ELb0E")
        no_spills(row["ptxas"], f"flash_attention {dt} dh {dh}")
        emit({"phase": "kernel", **row})
        rows[key] = row
    return rows


def phase_llm_syncs(torch, wl, model):
    """Warm-up serve, then the same serve under sync debug: the
    synchronizations it flags in the port's code must be the ones the code
    counts, and those 1 per decode step (the tokens), the gated decode step
    a graph replay (admissions' syncs left out)."""
    wl.warm_up(model)
    eng, flagged, sources, in_port = sync_flags(
        torch, lambda: wl.warm_up(model))
    if eng.graphs is not None and eng.graphs.replays != eng.decode_steps:
        raise AssertionError(f"{eng.graphs.replays} graph replays in "
                             f"{eng.decode_steps} gated decode steps")
    counted = eng.host_syncs + (eng.decoder.host_syncs if eng.decoder
                                else 0)
    per_step = (counted - eng.prefills) / eng.decode_steps
    emit({"phase": "llm_syncs", "arch": model.cfg.name,
          "fastcache": wl.fastcache, "decode_steps": eng.decode_steps,
          "prefills": eng.prefills, "counted": counted,
          "flagged": flagged, "flagged_in_port": in_port,
          "counted_per_decode_step": per_step,
          "flagged_in_port_per_decode_step":
              (in_port - eng.prefills) / eng.decode_steps,
          "sources": sources})
    want = 1
    if per_step != want:
        raise AssertionError(f"{per_step} counted syncs per decode step, "
                             f"expected {want} (the tokens)")
    if in_port != counted:
        raise AssertionError(f"sync debug flagged {in_port} syncs in the "
                             f"port's code, the code counts {counted}: "
                             f"{sources}")
    return per_step


def phase_llm_serve(torch, dev, wl, model, m, serve, label="llm_serve"):
    """Serve ``wl`` on a fresh engine, timed; every kernel's launch count is
    zeroed just before and read just after.  Returns (launches, done)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                         # the path starts here
    summary, eng, done = serve(wl, model)
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    if len(done) != wl.requests or any(
            len(r.generated) != wl.new_tokens for r in done):
        raise AssertionError(f"{len(done)} of {wl.requests} requests, "
                             f"lengths {[len(r.generated) for r in done]}")
    vocab = model.cfg.vocab_size
    if any(not 0 <= t < vocab for r in done for t in r.generated):
        raise AssertionError("a generated token lies outside the vocab")
    n_layers = model.cfg.num_layers
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = model.kind_counts.get("attn", 0) * eng.prefills
    by_route = {}
    nodes = 0
    if wl.fastcache and eng.graphs is not None:
        # two IF nodes a layer (the skip side's K/V write, the block) on
        # one condition kernel, each replay of the gated decode step
        want["if_all"] = n_layers * eng.graphs.replays
        nodes = 2 * n_layers * eng.graphs.replays
    if m.kernels["if_all"].nodes != nodes:
        raise AssertionError(f"{label}: {m.kernels['if_all'].nodes} IF "
                             f"nodes, expected {nodes}")
    if wl.fastcache:
        # the decode gate: saliency_delta on the (B, 1, D) rows and
        # linear_blend at gamma 1, once per layer per decode step
        want["saliency_delta"] = want["linear_blend"] = (
            n_layers * eng.decode_steps)
        by_route = {name: dict(m.kernels[name].launches_by_route)
                    for name in ("saliency_delta", "linear_blend")}
        if by_route != {
                "saliency_delta": {"onepass": want["saliency_delta"],
                                   "simt": 0},
                "linear_blend": {"gemv": want["linear_blend"], "wgmma": 0,
                                 "wgmma_split": 0, "simt": 0}}:
            raise AssertionError(f"decode gate launches by route {by_route}")
    if eng.prefills != wl.requests or launches != want:
        raise AssertionError(f"LLM launches {launches} != {want} "
                             f"({eng.prefills} prefills, "
                             f"{eng.decode_steps} decode steps)")
    emit({"phase": label, **summary, "launches": launches,
          "launches_by_route": by_route,
          "launches_per_decode_step": {
              k: v / eng.decode_steps for k, v in launches.items()
              if k != "flash_attention"},
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev)})
    return launches, done


def three_routes(torch, attention, ref, run):
    """``run()`` (a prefill or an encode) three times: with full-sequence
    attention on the kernel, each call's output captured and held against
    the plain version on that call's own q, k, v; on the plain version (p
    in f32); and on the reference's model attention (p rounded to bf16,
    ``attend_direct``).  Returns the three results, the kernel calls'
    rel-L2 against the plain version and their ``causal`` flags."""
    kernel_fn = attention.flash_attention
    captured = []

    def capturing(q, k, v, *, causal, window=0, **pos):
        out = kernel_fn(q, k, v, causal=causal, window=window, **pos)
        captured.append((q, k, v, out, causal, window, pos))
        return out

    def rounded_p(q, k, v, *, causal, window=0, q_pos=None, kv_pos=None):
        if q_pos is None:
            q_pos = kv_pos = torch.arange(q.shape[2], device=q.device)
        return attention.attend_direct(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), q_pos,
            kv_pos, causal=causal, window=window).transpose(1, 2)

    def run_with(fn):
        attention.flash_attention = fn
        try:
            return run()
        finally:
            attention.flash_attention = kernel_fn

    got = run_with(capturing)
    layer_rel = [rel_l2(torch, out, ref.flash_attention(
        q, k, v, causal=causal, window=window, **pos))
        for q, k, v, out, causal, window, pos in captured]
    causal = [c[4] for c in captured]
    del captured
    return (got, run_with(ref.flash_attention), run_with(rounded_p),
            layer_rel, causal)


def phase_llm_prefill_parity(torch, dev, wl, model, attention, ref,
                             batch=None, label="llm_prefill_parity"):
    """One full-width prefill (of ``wl``'s first prompt, or of ``batch``)
    through the kernel and through the plain version: relative L2 of the
    last-position logits, positions exact;
    and each layer's kernel output against the plain version run on that
    layer's own captured q, k, v (rel-L2 within PREFILL_REL_L2 in every
    layer).  The two plain prefills (p kept in f32, and p rounded to bf16
    as the reference's model attention rounds it, ``attend_direct``) must
    agree within the logits' bound, and the kernel's logits must then meet
    it too.  Only a config of PREFILL_CHAOTIC may have plain prefills
    farther apart: the random-weight model is chaotic at this init (a
    1-ulp change of one attention logit flips a near-one-hot softmax row,
    and the flip grows through the layers), and the per-layer check is the
    kernel's."""
    if batch is None:
        batch = {"tokens": torch.from_numpy(
            wl.build_requests(model)[0].prompt).long()[None].to(dev)}
    ((logits, cache), (plain_logits, plain_cache), (rounded_logits, _),
     layer_rel, _) = three_routes(torch, attention, ref,
                                  lambda: model.prefill(batch, wl.window))
    a, b = logits.float(), plain_logits.float()
    rel = float((a - b).norm() / b.norm())
    floor = rel_l2(torch, rounded_logits, plain_logits)
    same_argmax = bool(torch.equal(a.argmax(-1), b.argmax(-1)))
    held = floor < PREFILL_REL_L2
    emit({"phase": label, "arch": model.cfg.name,
          "num_layers": model.cfg.num_layers,
          "prompt_len": batch["tokens"].shape[1],
          "inputs": sorted(batch),
          "rel_l2_logits": rel, "bound": PREFILL_REL_L2,
          "same_argmax": same_argmax,
          "rel_l2_logits_plain_p_f32_vs_p_bf16": floor,
          "logits_bound_held": held,
          "chaotic_floor_recorded": PREFILL_CHAOTIC.get(model.cfg.name),
          "rel_l2_per_layer_max": max(layer_rel),
          "rel_l2_per_layer_mean": float(np.mean(layer_rel)),
          "rel_l2_k_cache": float((cache["k"].float() - plain_cache["k"].float()
                                   ).norm() / plain_cache["k"].float().norm())})
    if not torch.isfinite(a).all() or len(layer_rel) != \
            model.kind_counts["attn"] or not max(layer_rel) < PREFILL_REL_L2:
        raise AssertionError(f"prefill per layer: rel L2 up to "
                             f"{max(layer_rel)} (bound {PREFILL_REL_L2})")
    if not held and model.cfg.name not in PREFILL_CHAOTIC:
        raise AssertionError(f"the plain prefills differ by {floor} (bound "
                             f"{PREFILL_REL_L2}), and {model.cfg.name} is "
                             f"not one of PREFILL_CHAOTIC")
    if held and not (rel < PREFILL_REL_L2 and same_argmax):
        raise AssertionError(f"prefill logits: rel L2 {rel} (bound "
                             f"{PREFILL_REL_L2}), same argmax "
                             f"{same_argmax}")
    if not torch.equal(cache["pos"], plain_cache["pos"]):
        raise AssertionError("prefill cache positions differ")


def agreement(label, done_exact, done_fc) -> dict:
    """Greedy-token agreement of the gated serve with the exact one."""
    pairs = list(zip(sorted(done_exact, key=lambda r: r.rid),
                     sorted(done_fc, key=lambda r: r.rid)))
    out = {"phase": label,
           "greedy_token_agreement_fastcache_vs_exact": float(np.mean(
               [np.mean(np.array(a.generated) == np.array(b.generated))
                for a, b in pairs])),
           "first_token_agreement": float(np.mean(
               [a.generated[0] == b.generated[0] for a, b in pairs]))}
    emit(out)
    return out


# --------------------------------------------------------------------------
# The other LLM configs at full width: qwen3-14b, yi-9b, stablelm-3b and the
# MoE family (arctic-480b, kimi-k2-1t-a32b) with its depth cut
# --------------------------------------------------------------------------

def build_llm(torch, dev, wl):
    """``wl``'s model on the card: its parameters' bytes, the init seconds
    and the peak memory of building it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    model = wl.build_model(dev)
    torch.cuda.synchronize()
    emit({"phase": "llm_model", "arch": model.cfg.name,
          "num_layers": model.cfg.num_layers, "d_model": model.cfg.d_model,
          "params": sum(p.numel() for p in model.parameters()),
          "param_bytes": sum(p.numel() * p.element_size()
                             for p in model.parameters()),
          "dtype": str(model.dtype), "init_s": time.perf_counter() - t0,
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
    return model


def free_memory(torch) -> None:
    """Return the card memory of what the caller has just deleted."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def moe_drops(torch, dev, wl, model, layers_mod) -> dict:
    """Copies (token, choice) each prefill drops at the experts' capacity,
    per layer: the workload's prompts prefilled one by one outside any
    timed serve, each MoE call's routing recomputed and counted."""
    m = model.cfg.moe
    counts = []
    real = layers_mod.moe_apply

    def counting(p, x, cfg):
        t = x.shape[0] * x.shape[1]
        h = layers_mod.common.rms_norm(x, p.norm, cfg.norm_eps)
        top_i = layers_mod._route(p, h.reshape(t, -1), m.top_k)[2]
        per_e = torch.bincount(top_i.reshape(-1), minlength=m.num_experts)
        cap = layers_mod.moe_capacity(m, t)
        counts.append((t, cap, int((per_e - cap).clamp(min=0).sum())))
        return real(p, x, cfg)

    layers_mod.moe_apply = counting
    try:
        reqs = wl.build_requests(model)
        for req in reqs:
            model.prefill(
                {"tokens": torch.from_numpy(req.prompt).long()[None].to(dev)},
                wl.window)
    finally:
        layers_mod.moe_apply = real
    dropped = sum(c[2] for c in counts)
    moe_layers = len(counts) // len(reqs)
    out = {"phase": "moe_drops", "arch": model.cfg.name,
           "prefills": len(reqs), "tokens": counts[0][0],
           "capacity": counts[0][1], "moe_layers": moe_layers,
           "copies_per_prefill": counts[0][0] * m.top_k * moe_layers,
           "dropped_per_prefill": dropped / len(reqs),
           "dropped_share": dropped / sum(c[0] * m.top_k for c in counts)}
    emit(out)
    return out


def phase_moe_routes(torch, dev, model, layers_mod, batch: int):
    """The first layer's MoE at a decode batch on both paths: the capacity
    dispatch (every expert's GEMM on a min_capacity buffer) and the gather
    path (``MOE_GATHER_DECODE``: the chosen experts' weights only).  With
    T * k <= E and capacity min_capacity no copy is dropped, so the two
    take the same experts (``_route``, shared) and agree within bf16's
    2e-2; each timed on the card beside its bytes."""
    p, cfg = model.blocks[0].moe, model.cfg
    m = cfg.moe
    if batch * m.top_k > m.num_experts or \
            layers_mod.moe_capacity(m, batch) < batch:
        raise AssertionError("moe_routes needs a drop-free decode batch")
    gen = torch.Generator(dev).manual_seed(5)
    x = torch.randn((batch, 1, cfg.d_model), generator=gen,
                    device=dev).to(model.dtype)
    y_cap, a_cap = layers_mod.moe_apply(p, x, cfg)
    y_gat, a_gat = layers_mod.moe_gather_apply(p, x, cfg)
    torch.cuda.synchronize()
    scale = max(1.0, float(y_gat.float().abs().max()))
    torch.testing.assert_close(y_cap.float(), y_gat.float(), rtol=2e-2,
                               atol=2e-2 * scale)
    torch.testing.assert_close(a_cap, a_gat, rtol=1e-6, atol=0)
    esize = 2
    d, f, e, k = cfg.d_model, m.d_ff_expert, m.num_experts, m.top_k
    expert_bytes = 3 * d * f * esize
    row = {"phase": "moe_routes", "arch": cfg.name, "batch": batch,
           "rel_l2": rel_l2(torch, y_cap, y_gat),
           "max_abs_err": float((y_cap.float() - y_gat.float()).abs().max()),
           "scale": scale, "aux_capacity": float(a_cap),
           "aux_gather": float(a_gat),
           "capacity_device_ms": device_ms(
               torch, lambda: layers_mod.moe_apply(p, x, cfg), iters=10),
           "gather_device_ms": device_ms(
               torch, lambda: layers_mod.moe_gather_apply(p, x, cfg),
               iters=10),
           "capacity_bound_ms": bound(e * expert_bytes, 0.0)[0],
           "gather_bound_ms": bound(batch * k * expert_bytes, 0.0)[0]}
    emit(row)
    return row


def phase_decode_profile(torch, dev, wl, model, label: str,
                         eng=None) -> dict:
    """Per decode step of ``wl``'s engine (``eng``, or a fresh one) with
    every slot busy (the free ones filled from ``wl``'s requests): the wall
    and CUDA-event span of DECODE_PROFILE_STEPS steps, then the kernels of
    4 steps under torch.profiler (launches, kernel ms, busy share, top
    kernels), as ``launch/profile_llm.py`` reports them."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_llm import _window
    if eng is None:
        eng = wl.build_engine(model)
    busy = sum(r is not None for r in eng.slots)
    full = dataclasses.replace(wl, requests=max(wl.requests, wl.max_batch))
    for req in full.build_requests(model)[busy:wl.max_batch]:
        eng.add_request(req)
    for _ in range(4):
        eng.step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(DECODE_PROFILE_STEPS):
        eng.step()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    win = _window(prof, pwall, 4)
    out = {"phase": "decode_profile", "label": label, "arch": model.cfg.name,
           "fastcache": wl.fastcache, "active": wl.max_batch,
           "ms_per_step_wall": wall / DECODE_PROFILE_STEPS * 1e3,
           "ms_per_step_events": start.elapsed_time(end)
           / DECODE_PROFILE_STEPS,
           "profiled": win}
    emit(out)
    return out


def phase_more_llms(torch, dev, m, k, serve, layers_mod, attention, ref):
    """The twelfth slice's serves, each model freed before the next.
    Returns {label: launches} of every serve."""
    launches = {}

    def serve_pair(wl, model, tag):
        wl.warm_up(model)
        launches[f"llm_serve_{tag}_exact"], done_e = phase_llm_serve(
            torch, dev, wl, model, m, serve, label=f"llm_serve_{tag}_exact")
        wl_fc = dataclasses.replace(wl, fastcache=True)
        launches[f"llm_serve_{tag}_fastcache"], done_f = phase_llm_serve(
            torch, dev, wl_fc, model, m, serve,
            label=f"llm_serve_{tag}_fastcache")
        agreement(f"llm_agreement_{tag}", done_e, done_f)

    # qwen3-14b at full size: exact and gated
    wl = k.LLMWorkload(arch="qwen3-14b")
    model = build_llm(torch, dev, wl)
    serve_pair(wl, model, "qwen3_14b")
    phase_llm_prefill_parity(torch, dev, wl, model, attention, ref)
    del model
    free_memory(torch)

    # arctic-480b at full width, 2 layers: syncs, serves, drops, the two
    # MoE paths, the decode step's time exact against gated
    wl = k.LLMWorkload(**ARCTIC)
    model = build_llm(torch, dev, wl)
    wl_fc = dataclasses.replace(wl, fastcache=True)
    phase_llm_syncs(torch, wl_fc, model)
    serve_pair(wl, model, "arctic")
    phase_llm_prefill_parity(torch, dev, wl, model, attention, ref)
    moe_drops(torch, dev, wl, model, layers_mod)
    moe = model.cfg.moe
    phase_moe_routes(torch, dev, model, layers_mod,
                     min(wl.max_batch, moe.num_experts // moe.top_k))
    phase_decode_profile(torch, dev, wl, model, "arctic_exact")
    phase_decode_profile(torch, dev, wl_fc, model, "arctic_fastcache")
    del model
    free_memory(torch)

    # yi-9b, stablelm-3b (dh 80), kimi-k2 (dh 112, 1 layer): prefill
    # parity and a short gated serve
    for kw in PARITY_LLMS:
        wl = k.LLMWorkload(**kw)
        model = build_llm(torch, dev, wl)
        phase_llm_prefill_parity(torch, dev, wl, model, attention, ref)
        short = dataclasses.replace(wl, **SHORT_SERVE)
        short.warm_up(model)
        tag = kw["arch"].split("-")[0]
        launches[f"llm_serve_{tag}_fastcache"] = phase_llm_serve(
            torch, dev, short, model, m, serve,
            label=f"llm_serve_{tag}_fastcache")[0]
        del model
        free_memory(torch)
    return launches


# --------------------------------------------------------------------------
# The hybrid and SSM families: jamba-v0.1-52b (one period at full width)
# and xlstm-1.3b (full size), exact (the decode gate refuses both)
# --------------------------------------------------------------------------

def step_bytes(model, cache) -> dict:
    """The least bytes an exact decode step of ``model`` moves: every
    parameter read once (the embedding table's rows aside: a step gathers
    B of them), every cache leaf read once, and the mixers' states written
    once (the step's one K/V slot per attention layer left out).  An MoE
    layer's experts count only as many as the batch can reach, min(E,
    B * top_k); the capacity path reads all E of them, and
    ``capacity_path_bytes`` counts those."""
    def nbytes(t):
        return t.numel() * t.element_size()

    embed = model.top.embed
    weights = sum(nbytes(p) for p in model.parameters()) - nbytes(embed)
    batch = cache["step"].shape[0]
    unreached = 0
    for blk in model.blocks:
        if "moe" in blk.subs:
            e, k = model.cfg.moe.num_experts, model.cfg.moe.top_k
            experts = sum(nbytes(getattr(blk.moe, n))
                          for n in ("we_gate", "we_up", "we_down"))
            unreached += experts // e * max(0, e - batch * k)
    leaves = {k: nbytes(t) for k, t in cache.items()}
    states = sum(n for k, n in leaves.items()
                 if k not in ("k", "v", "pos", "step"))
    moved = sum(leaves.values()) + states
    return {"weight_bytes": weights - unreached,
            "unreached_expert_bytes": unreached,
            "cache_bytes": sum(leaves.values()),
            "state_bytes_written": states,
            "bytes": weights - unreached + moved,
            "capacity_path_bytes": weights + moved}


def phase_prefill_profile(torch, dev, wl, model, label: str):
    """One admission (a prefill of ``wl.prompt_len`` tokens, batch 1, and
    its splice) of ``wl``'s engine: its wall time and CUDA-event span, then
    the same admission of the next request under torch.profiler (kernel
    launches, kernel ms, busy share), and the peak memory it adds.
    Returns (the row, the engine with those two requests admitted)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_llm import _window
    eng = wl.build_engine(model)
    reqs = dataclasses.replace(wl, requests=max(wl.requests, 2)
                               ).build_requests(model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    eng.add_request(reqs[0])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        eng.add_request(reqs[1])
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t1
    win = _window(prof, pwall, 1)
    out = {"phase": "prefill_profile", "label": label,
           "arch": model.cfg.name, "num_layers": model.cfg.num_layers,
           "prompt_len": wl.prompt_len, "ms_wall": wall * 1e3,
           "ms_events": start.elapsed_time(end),
           "peak_memory_added_bytes": peak,
           "launches": win["kernel_launches_per_step"],
           "kernel_ms": win["kernel_ms_per_step"],
           "device_busy_share": win["device_busy_share"],
           "flash_attention_ms": win["flash_attention_ms_per_step"],
           "profiled": win}
    emit(out)
    return out, eng


def phase_slstm_prefill(torch, dev, wl, model) -> dict:
    """The first sLSTM layer alone over a prompt of ``wl.prompt_len``
    positions (batch 1): its kernel launches under torch.profiler and its
    CUDA-event span; the token-by-token scan is the xLSTM prefill's
    sequential part."""
    from torch.profiler import ProfilerActivity, profile
    l = model.layer_kinds.index("slstm")
    gen = torch.Generator(dev).manual_seed(6)
    x = torch.randn((1, wl.prompt_len, model.cfg.d_model), generator=gen,
                    device=dev).to(model.dtype)

    def run():
        return model.block_apply(model.blocks[l], x)[0]

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    n = model.kind_counts["slstm"]
    out = {"phase": "slstm_prefill", "arch": model.cfg.name, "layer": l,
           "prompt_len": wl.prompt_len, "launches_per_layer": launches,
           "launches_per_token": launches / wl.prompt_len,
           "slstm_layers": n, "launches_per_prefill": launches * n,
           "ms_per_layer_events": start.elapsed_time(end)}
    emit(out)
    return out


def phase_ssm_consistency(torch, dev, get_config, mixers) -> list:
    """One layer of each mixer at its config's full width, f32, random
    weights (the reference's initializers, seed 7): ``SSM_CONSISTENCY``'s
    positions prefilled, the state copied into row 1 of a stacked (2, ...)
    leaf as the model's cache holds it, the rest decoded one by one in
    place from there; against the full forward of all positions.  rel-L2
    of the layer's output delta (output minus its residual input) over the
    decoded positions and over the prefilled ones."""
    from repro_torch.models.layers import ParamGroup
    b, s_pre, n_dec = SSM_CONSISTENCY
    rows = []
    for kind, arch in SSM_MIXERS:
        cfg = get_config(arch).replace(dtype="float32")
        defs, state_defs, apply = mixers[kind]
        gen = torch.Generator(dev).manual_seed(7)
        p = ParamGroup(defs(cfg), torch.float32, dev)
        p.init(gen)
        x = torch.randn((b, s_pre + n_dec, cfg.d_model), generator=gen,
                        device=dev)
        full = apply(p, x, cfg=cfg)[0] - x
        pre, st = apply(p, x[:, :s_pre], cfg=cfg)
        leaves = {k: torch.zeros((2,) + d.shape, device=dev)
                  for k, d in state_defs(cfg, b).items()}
        views = {k: t[1] for k, t in leaves.items()}
        for k, t in st.items():
            views[k].copy_(t)
        outs = []
        for t in range(s_pre, s_pre + n_dec):
            outs.append(apply(p, x[:, t:t + 1], cfg=cfg, state=views,
                              decode=True)[0] - x[:, t:t + 1])
        torch.cuda.synchronize()
        dec = torch.cat(outs, 1)
        row = {"phase": "ssm_consistency", "mixer": kind, "arch": arch,
               "d_model": cfg.d_model, "batch": b, "prefilled": s_pre,
               "decoded": n_dec,
               "rel_l2_decode": rel_l2(torch, dec, full[:, s_pre:]),
               "rel_l2_prefill": rel_l2(torch, pre[:, :s_pre] - x[:, :s_pre],
                                        full[:, :s_pre]),
               "unused_row_zero": all(bool((t[0] == 0).all())
                                      for t in leaves.values()),
               "bound": SSM_CONSISTENCY_REL_L2}
        emit(row)
        if not (row["rel_l2_decode"] < SSM_CONSISTENCY_REL_L2
                and row["rel_l2_prefill"] < SSM_CONSISTENCY_REL_L2
                and row["unused_row_zero"]):
            raise AssertionError(f"ssm_consistency {kind}: {row}")
        rows.append(row)
        del p, x, full, pre, st, leaves, views, outs, dec
        free_memory(torch)
    return rows


def phase_ssm_llms(torch, dev, m, k, serve, layers_mod, attention, ref,
                   get_config, mixers):
    """The thirteenth slice's serves, each model freed before the next.
    Returns {label: launches} of every serve."""
    launches = {}
    for kw in (JAMBA, XLSTM):
        t0 = time.perf_counter()
        wl = k.LLMWorkload(**kw)
        model = build_llm(torch, dev, wl)
        tag = kw["arch"].split("-")[0]
        got, line = k.exact_fallback(dataclasses.replace(wl, fastcache=True),
                                     model)
        emit({"phase": "llm_gate_refused", "arch": model.cfg.name,
              "line": line, "fastcache": got.fastcache})
        if got != wl or line != k.GATE_NEEDS_ATTENTION:
            raise AssertionError(f"{model.cfg.name}: fastcache came back "
                                 f"{got} with {line!r}")
        phase_llm_syncs(torch, wl, model)
        wl.warm_up(model)
        label = f"llm_serve_{tag}_exact"
        launches[label] = phase_llm_serve(torch, dev, wl, model, m, serve,
                                          label=label)[0]
        if "attn" in model.kind_counts:
            phase_llm_prefill_parity(torch, dev, wl, model, attention, ref)
        if model.cfg.moe is not None:
            moe_drops(torch, dev, wl, model, layers_mod)
        eng = phase_prefill_profile(torch, dev, wl, model, f"{tag}_exact")[1]
        if "slstm" in model.kind_counts:
            phase_slstm_prefill(torch, dev, wl, model)
        prof = phase_decode_profile(torch, dev, wl, model, f"{tag}_exact",
                                    eng)
        del eng
        nbytes = step_bytes(model, model.init_cache(wl.max_batch, wl.window))
        bound_ms = bound(nbytes["bytes"], 0.0)[0]
        device_ms = prof["profiled"]["kernel_ms_per_step"]
        emit({"phase": "decode_bound", "arch": model.cfg.name, **nbytes,
              "bound_ms": bound_ms, "bound_by": "bytes",
              "capacity_path_ms": bound(nbytes["capacity_path_bytes"],
                                        0.0)[0],
              "device_ms": device_ms,
              "device_over_bound": device_ms / bound_ms})
        del model
        free_memory(torch)
        emit({"phase": "ssm_model_seconds", "arch": kw["arch"],
              "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    phase_ssm_consistency(torch, dev, get_config, mixers)
    emit({"phase": "ssm_consistency_seconds",
          "seconds": time.perf_counter() - t0})
    return launches


# --------------------------------------------------------------------------
# The VLM (Qwen2-VL-2B: M-RoPE, the vision stub) and audio (HuBERT-XLarge:
# the bidirectional encoder, the feature stub) families at full size
# --------------------------------------------------------------------------

def vision_batch(torch, dev, wl, model) -> dict:
    """``wl``'s first prompt with VISION_TOKENS embeddings (0.02 x a normal
    draw, the token embeddings' scale; seed 9) at positions 1.. and their
    3-axis M-RoPE positions: t = arange(S) (B7's position mode on arange
    positions, bitwise its implicit mode), h and w the image tokens' grid
    row and column (offset by 1), the text's own position elsewhere (the
    reference's layout is vlm_positions')."""
    tokens = torch.from_numpy(
        wl.build_requests(model)[0].prompt).long()[None].to(dev)
    s, d = tokens.shape[1], model.cfg.d_model
    gen = torch.Generator(dev).manual_seed(9)
    embeds = 0.02 * torch.randn((1, VISION_TOKENS, d), generator=gen,
                                device=dev)
    mask = torch.zeros((1, s), dtype=torch.bool, device=dev)
    mask[:, 1:1 + VISION_TOKENS] = True
    t = torch.arange(s, device=dev)
    img = torch.arange(VISION_TOKENS, device=dev)
    h, w = t.clone(), t.clone()
    h[1:1 + VISION_TOKENS] = 1 + img // VISION_GRID
    w[1:1 + VISION_TOKENS] = 1 + img % VISION_GRID
    return {"tokens": tokens, "vision_embeds": embeds.to(model.dtype),
            "vision_mask": mask,
            "positions": torch.stack([t, h, w], -1)[None]}


def phase_vlm(torch, dev, m, k, serve, attention, ref) -> dict:
    """Qwen2-VL-2B at full size: llm_syncs exact (1 a decode step) and
    gated (L + 1), the exact and gated serves on LLMWorkload's defaults
    (launches exact and on the fast routes) and their agreement, the text
    prefill's parity, the vision prefill's (vision_batch) parity, and per
    decode step exact and gated the wall, events and profiled kernels,
    beside the exact step's bytes bound.  Returns {label: launches}."""
    launches = {}
    wl = k.LLMWorkload(**VLM)
    wl_fc = dataclasses.replace(wl, fastcache=True)
    model = build_llm(torch, dev, wl)
    phase_llm_syncs(torch, wl, model)
    phase_llm_syncs(torch, wl_fc, model)
    wl.warm_up(model)
    done = {}
    for w, mode in ((wl, "exact"), (wl_fc, "fastcache")):
        label = f"llm_serve_qwen2_vl_{mode}"
        launches[label], done[mode] = phase_llm_serve(
            torch, dev, w, model, m, serve, label=label)
    agreement("llm_agreement_qwen2_vl", done["exact"], done["fastcache"])
    phase_llm_prefill_parity(torch, dev, wl, model, attention, ref)
    phase_llm_prefill_parity(torch, dev, wl, model, attention, ref,
                             batch=vision_batch(torch, dev, wl, model),
                             label="vlm_vision_prefill_parity")
    prof = phase_decode_profile(torch, dev, wl, model, "qwen2_vl_exact")
    phase_decode_profile(torch, dev, wl_fc, model, "qwen2_vl_fastcache")
    nbytes = step_bytes(model, model.init_cache(wl.max_batch, wl.window))
    bound_ms = bound(nbytes["bytes"], 0.0)[0]
    device_ms = prof["profiled"]["kernel_ms_per_step"]
    emit({"phase": "decode_bound", "arch": model.cfg.name, **nbytes,
          "bound_ms": bound_ms, "bound_by": "bytes", "device_ms": device_ms,
          "device_over_bound": device_ms / bound_ms})
    del model
    free_memory(torch)
    return launches


def encoder_flops(cfg, batch: int, seq: int) -> float:
    """Forward FLOPs of the audio encoder over (batch, seq) frames, as
    llm_train_flops counts them: the feature projection and positional
    conv, per layer q/k/v/o and the GELU MLP's two products, attention's
    two products over all S x S pairs, the head."""
    d, L, f, v = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    q = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    per_token = (2 * cfg.frontend_dim * d + 2 * 15 * d + 2 * d * v
                 + L * (2 * d * q + 4 * d * kv + 2 * q * d + 4 * d * f))
    return batch * (seq * per_token + L * 4 * seq * seq * q)


def phase_encode(torch, dev, model, m, attention, ref) -> dict:
    """hubert_encode: HUBERT_ENCODE frames of normal features (seed 8)
    through ``TransformerModel.apply`` after an untimed encode; every count
    zeroed just before the timed encode and read just after:
    flash_attention once a layer (bidirectional), no other kernel.  Then,
    outside the counted run: each layer's kernel output against the plain
    version on that layer's own q, k, v (rel-L2 within PREFILL_REL_L2),
    the hidden states against the plain route's (printed beside the floor
    of the two plain routes, p in f32 and p in bf16: the encoder has no
    qk-norm), and bidirectionality: moving the last BIDIRECTIONAL_FRAMES
    frames moves the first ones' hidden states."""
    b, s = HUBERT_ENCODE
    cfg = model.cfg
    gen = torch.Generator(dev).manual_seed(8)
    feats = torch.randn((b, s, cfg.frontend_dim), generator=gen, device=dev)
    batch = {"features": feats}
    model.apply(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counts()                         # the path starts here
    t0 = time.perf_counter()
    start.record()
    hidden = model.apply(batch)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = cfg.num_layers
    if launches != want:
        raise AssertionError(f"hubert encode launches {launches} != {want}")
    hidden_k, plain, rounded, layer_rel, causal = three_routes(
        torch, attention, ref, lambda: model.apply(batch))
    causal_calls = sum(causal)
    moved = feats.clone()
    moved[:, -BIDIRECTIONAL_FRAMES:] += 1.0
    hidden2 = model.apply({"features": moved})
    n = BIDIRECTIONAL_FRAMES
    early = rel_l2(torch, hidden2[:, :n], hidden[:, :n])
    flops = encoder_flops(cfg, b, s)
    ms = start.elapsed_time(end)
    row = {"phase": "hubert_encode", "arch": cfg.name,
           "num_layers": cfg.num_layers, "batch": b, "frames": s,
           "dtype": str(model.dtype), "ms_events": ms, "ms_wall": wall * 1e3,
           "frames_per_s": b * s / (ms / 1e3), "model_flops": flops,
           "mfu": flops / (ms / 1e3) / BF16_TC_FLOPS_PER_S,
           "launches": launches, "finite": bool(torch.isfinite(
               hidden.float()).all()),
           "repeat_bitwise": bool(torch.equal(hidden, hidden_k)),
           "causal_calls": causal_calls,
           "rel_l2_per_layer_max": max(layer_rel),
           "rel_l2_per_layer_mean": float(np.mean(layer_rel)),
           "bound": PREFILL_REL_L2,
           "rel_l2_hidden_vs_plain": rel_l2(torch, hidden, plain),
           "rel_l2_hidden_plain_p_f32_vs_p_bf16": rel_l2(torch, rounded,
                                                         plain),
           "rel_l2_early_frames_moved": early,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(
               dev), "card": smi()}
    emit(row)
    if not (row["finite"] and row["repeat_bitwise"]
            and len(layer_rel) == cfg.num_layers and causal_calls == 0
            and row["rel_l2_per_layer_max"] < PREFILL_REL_L2):
        raise AssertionError(f"hubert encode: {row}")
    if not early > 1e-3:
        raise AssertionError(f"hubert encode: moving the last {n} frames "
                             f"moved the first {n} by rel-L2 {early}: not "
                             f"bidirectional")
    return launches


# HuBERT-XLarge at full size: launch/train.py's batch 8 of 500 frames of
# audio_stream (seed 0), 5 steps as TRAIN_LLM's (0 warms up, 1 under sync
# debug "error", 2-3 timed, 4 profiled), the config's AdamW
TRAIN_HUBERT = dict(arch=HUBERT, batch=8, seq=500, steps=5, lr=3e-4,
                    warmup=20, seed=0)


def phase_train_hubert(torch, dev, tr, m):
    """train_hubert: the audio encoder through launch/train.py's model and
    stream (``init_model``, ``data_for``) and make_train_step.  Checks:
    every loss finite; the sync-debug step clean; no kernel launched."""
    c = TRAIN_HUBERT
    cfg = tr.get_config(c["arch"])
    t0 = time.perf_counter()
    it = tr.data_for(cfg, c["batch"], c["seq"], c["seed"], dev)
    batches = [next(it) for _ in range(c["steps"])]
    draw_s = time.perf_counter() - t0
    model = tr.init_model(cfg, dev, c["seed"])
    lr_fn = tr.optimizer.cosine_schedule(c["lr"], c["warmup"], c["steps"])
    _, _, losses, timing, launches = run_training(
        torch, dev, model, tr, batches, lr_fn, warm=1, sync_step=1,
        profile_step=c["steps"] - 1, label="train_hubert", m=m)
    step_s = timing["step_ms"] / 1e3
    flops = 3.0 * encoder_flops(cfg, c["batch"], c["seq"])
    emit({"phase": "train_hubert", **c, "arch": cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "dtype": cfg.dtype, "optimizer": cfg.optimizer, "remat": cfg.remat,
          "batch_draw_s": draw_s, "losses": losses.tolist(),
          "ln_vocab": float(np.log(cfg.vocab_size)),
          "frames_per_s": c["batch"] * c["seq"] / step_s,
          "model_flops_per_step": flops,
          "train_mfu": flops / step_s / BF16_TC_FLOPS_PER_S, **timing,
          "launches": launches, "card": smi()})
    del model
    free_memory(torch)
    return launches


def phase_vlm_audio(torch, dev, m, k, serve, attention, ref, tr) -> dict:
    """The fourteenth slice: phase_vlm, then HuBERT-XLarge built, encoded
    and freed, then trained.  Returns {label: launches} of every run."""
    launches = phase_vlm(torch, dev, m, k, serve, attention, ref)
    wl = k.LLMWorkload(arch=HUBERT)
    model = build_llm(torch, dev, wl)
    launches["hubert_encode"] = phase_encode(torch, dev, model, m,
                                             attention, ref)
    del model
    free_memory(torch)
    launches["train_hubert"] = phase_train_hubert(torch, dev, tr, m)
    return launches


# --------------------------------------------------------------------------
# Attention masked by explicit positions: B7's position mode at Qwen2-VL-2B's
# image prompt in the reference's M-RoPE layout
# --------------------------------------------------------------------------

# the image prompt: IMAGE_TEXT text tokens at t = h = w = 0 .. 127, the
# VISION_GRID x VISION_GRID image at t = 128, h = 128 + row, w = 128 +
# column, then IMAGE_TEXT text tokens from 128 + VISION_GRID (512 tokens)
IMAGE_TEXT = 128
IMAGE_DECODE_STEPS = 8
# B7 rows at that prefill (B, H, KVH, S, dh, causal, window, dtype,
# positions): p the layout's t axis, q arange (bitwise the implicit mode),
# r = p in f32 (SIMT route)
POSITION_FLASH_SHAPES = {
    "p": (1, 12, 2, 512, 128, True, 1024, "bfloat16", "layout"),
    "q": (1, 12, 2, 512, 128, True, 1024, "bfloat16", "arange"),
    "r": (1, 12, 2, 512, 128, True, 1024, "float32", "layout")}
POSITION_FLASH_TOL = {"bfloat16": 5e-2, "float32": 1e-4}


def image_layout(torch, dev):
    """(S, 3) int32 M-RoPE positions of the image prompt (IMAGE_TEXT text,
    the image, IMAGE_TEXT text), in the reference's layout."""
    n, g = IMAGE_TEXT, VISION_GRID
    t = torch.cat([torch.arange(n), torch.full((g * g,), n),
                   torch.arange(n + g, n + g + n)])
    h, w = t.clone(), t.clone()
    h[n:n + g * g] = n + torch.arange(g).repeat_interleave(g)
    w[n:n + g * g] = n + torch.arange(g).repeat(g)
    return torch.stack([t, h, w], -1).to(torch.int32).to(dev)


def position_mask(torch, q_pos, kv_pos, causal: bool, window: int):
    """The reference's ``_mask`` of (Sq,) / (Skv,) positions: (Sq, Skv)."""
    qp, kp = q_pos[:, None], kv_pos[None, :]
    live = (kp >= 0).expand(qp.shape[0], kp.shape[1])
    if causal:
        live = live & (kp <= qp)
    if window > 0:
        live = live & (kp > qp - window)
    return live


def phase_flash_positions(torch, dev, ref, flash_attention, build):
    """B7's position mode at POSITION_FLASH_SHAPES against its plain
    version on the same positions (bf16 5e-2, f32 1e-4), row q also bit for
    bit against the implicit mode; timed as the other B7 rows, beside
    F.scaled_dot_product_attention with the equivalent boolean mask.  The
    bound counts this input's live pairs and the positions' bytes.
    Returns the rows by key."""
    import torch.nn.functional as F
    ptxas = build.ptxas_lines(build.load_library("flash_attention").log)
    layout = image_layout(torch, dev)[:, 0]
    rows = {}
    for key, (b, h, kvh, s, dh, causal, window, dt,
              which) in POSITION_FLASH_SHAPES.items():
        dtype = getattr(torch, dt)
        gen = torch.Generator(dev).manual_seed(4)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((b, h, s, dh), (b, kvh, s, dh),
                                 (b, kvh, s, dh)))
        pos = (layout if which == "layout"
               else torch.arange(s, device=dev, dtype=torch.int32))[None]
        kw = dict(causal=causal, window=window, q_pos=pos, kv_pos=pos)
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention(q, k, v, **kw)
        tol = POSITION_FLASH_TOL[dt]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        bitwise = None
        if which == "arange":
            bitwise = bool(torch.equal(got, flash_attention(
                q, k, v, causal=causal, window=window)))
            if not bitwise:
                raise AssertionError(f"B7 row {key}: position mode on "
                                     "arange differs from the implicit mode")
        mask = position_mask(torch, pos[0], pos[0], causal, window)
        lib_out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
        torch.testing.assert_close(lib_out.float(), want.float(), rtol=tol,
                                   atol=tol)
        pairs = int(mask.sum())
        esize = q.element_size()
        nbytes = (esize * dh * (2 * b * h * s + 2 * b * kvh * s)
                  + 4 * 2 * s)                       # + the positions
        ops = 4 * dh * b * h * pairs
        peak = BF16_TC_FLOPS_PER_S if dt == "bfloat16" else F32_FLOPS_PER_S
        bound_ms, bound_by = bound(nbytes, ops / peak)
        row = {"name": "flash_attention", "route": "cuda",
               "source": "src/repro_torch/csrc/flash_attention.cu",
               "replaces": "src/repro/kernels/flash_attention.py:74",
               "case": key, "mode": "positions", "positions": which,
               "shape": [b, h, kvh, s, s, dh], "causal": causal,
               "window": window, "dtype": dt,
               "max_abs_err": float((got.float() - want.float()).abs().max()),
               "tol": tol, "bitwise_implicit": bitwise,
               **timed(torch, "kernel", lambda: flash_attention(q, k, v, **kw)),
               **timed(torch, "plain", lambda: ref.flash_attention(q, k, v,
                                                                   **kw)),
               **timed(torch, "library", lambda: F.scaled_dot_product_attention(
                   q, k, v, attn_mask=mask, enable_gqa=True)),
               "library_call": ("F.scaled_dot_product_attention(attn_mask="
                                "bool mask of the positions, enable_gqa=True)"),
               "live_pairs": pairs, "bytes": nbytes, "operations": ops,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "instance_dh": 128}
        row["ms"] = row["kernel_ms"]
        row["vs_library"] = (row["kernel_device_ms"]
                             / row["library_device_ms"])
        row["ptxas"] = instance_ptxas(
            ptxas, "flash_attention_kernel_"
            + ("wgmma" if dt == "bfloat16" else "simt") + "ILi128ELb1E")
        no_spills(row["ptxas"], f"flash_attention position mode {dt}")
        emit({"phase": "kernel", **row})
        rows[key] = row
    return rows


def image_prompt(torch, dev, wl, model) -> dict:
    """``wl``'s first prompt (512 tokens) as an image prompt in the
    reference's layout: VISION_TOKENS embeddings (0.02 x a normal draw, the
    token embeddings' scale; seed 9) at the image's positions, the 3-axis
    positions of ``image_layout``."""
    tokens = torch.from_numpy(
        wl.build_requests(model)[0].prompt).long()[None].to(dev)
    s, d = tokens.shape[1], model.cfg.d_model
    if s != 2 * IMAGE_TEXT + VISION_TOKENS:
        raise AssertionError(f"prompt of {s} tokens, the layout needs "
                             f"{2 * IMAGE_TEXT + VISION_TOKENS}")
    gen = torch.Generator(dev).manual_seed(9)
    embeds = 0.02 * torch.randn((1, VISION_TOKENS, d), generator=gen,
                                device=dev)
    mask = torch.zeros((1, s), dtype=torch.bool, device=dev)
    mask[:, IMAGE_TEXT:IMAGE_TEXT + VISION_TOKENS] = True
    return {"tokens": tokens, "vision_embeds": embeds.to(model.dtype),
            "vision_mask": mask,
            "positions": image_layout(torch, dev)[None]}


def phase_vlm_positions(torch, dev, m, k, attention, ref, flash_attention):
    """vlm_positions: Qwen2-VL-2B at full size (LLMWorkload's defaults,
    nothing cut), one prefill of the image prompt and IMAGE_DECODE_STEPS
    greedy decode steps under sync debug "error" after a warm-up, every
    count zeroed just before and read just after: flash_attention once a
    layer, all in position mode, no other kernel; the cache's positions
    the layout's t axis exactly after the prefill, the decode steps at S,
    S + 1, ... (the reference's step); logits finite.  Then the prefill's
    parity (phase_llm_prefill_parity: each layer's kernel output against
    the plain version on its own q, k, v and positions; chaotic at random
    init, PREFILL_CHAOTIC) and the prefill's CUDA-event time.  Returns
    the counted run's launches."""
    wl = k.LLMWorkload(**VLM)
    model = build_llm(torch, dev, wl)
    batch = image_prompt(torch, dev, wl, model)
    s = batch["tokens"].shape[1]
    logits, cache = model.prefill(batch, wl.window)      # warm-up
    model.decode_step(logits.argmax(-1), cache)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    mid = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counts()                         # the path starts here
    torch.cuda.set_sync_debug_mode("error")
    try:
        start.record()
        logits, cache = model.prefill(batch, wl.window)
        mid.record()
        pos_after_prefill = cache["pos"].clone()
        finite = [torch.isfinite(logits).all()]
        for _ in range(IMAGE_DECODE_STEPS):
            logits, cache = model.decode_step(logits.argmax(-1), cache)
            finite.append(torch.isfinite(logits).all())
        end.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    by_mode = dict(flash_attention.launches_by_mode)
    n_attn = model.kind_counts["attn"]
    want = dict.fromkeys(launches, 0)
    want["flash_attention"] = n_attn
    t_axis = batch["positions"][0, :, 0]
    pos_exact = bool(torch.equal(pos_after_prefill[:, 0, :s],
                                 t_axis.expand(n_attn, s))
                     and bool((pos_after_prefill[:, 0, s:] == -1).all()))
    steps = torch.arange(s, s + IMAGE_DECODE_STEPS, device=dev,
                         dtype=torch.int32)
    decoded_exact = bool(torch.equal(
        cache["pos"][:, 0, s:s + IMAGE_DECODE_STEPS],
        steps.expand(n_attn, IMAGE_DECODE_STEPS)))
    row = {"phase": "vlm_positions", "arch": model.cfg.name,
           "num_layers": model.cfg.num_layers, "prompt_len": s,
           "t_positions": [int(t_axis.min()), int(t_axis.max())],
           "distinct_t": int(torch.unique(t_axis).numel()),
           "window": wl.window, "decode_steps": IMAGE_DECODE_STEPS,
           "host_syncs": 0, "sync_debug": "error",
           "launches": launches, "flash_attention_by_mode": by_mode,
           "cache_pos_is_t_axis": pos_exact,
           "decode_pos_from_step_s": decoded_exact,
           "step": cache["step"].tolist(),
           "logits_finite": bool(torch.stack(finite).all()),
           "prefill_ms_events": start.elapsed_time(mid),
           "decode_ms_per_step_events": mid.elapsed_time(end)
           / IMAGE_DECODE_STEPS, "card": smi()}
    emit(row)
    if launches != want or by_mode != {"implicit": 0, "positions": n_attn}:
        raise AssertionError(f"vlm_positions launches {launches}, by mode "
                             f"{by_mode}; expected {n_attn} in position mode")
    if not (pos_exact and decoded_exact and row["logits_finite"]
            and row["step"] == [s + IMAGE_DECODE_STEPS]):
        raise AssertionError(f"vlm_positions: {row}")
    phase_llm_prefill_parity(torch, dev, wl, model, attention, ref,
                             batch=batch,
                             label="vlm_positions_prefill_parity")
    del model, cache
    free_memory(torch)
    return launches


@contextlib.contextmanager
def capture_audit(obs_audit, sink):
    """Record, on the card, each audited step's end-to-end error rows and
    its active mask as the audit plane computes them (``rel_err_rows`` is
    called once per audited step), into ``sink`` as (err, active) pairs."""
    orig_apply, orig_rel = obs_audit.apply_audit, obs_audit.rel_err_rows
    signature = inspect.signature(orig_apply)
    active_box = []

    def apply(*args, **kw):
        bound = signature.bind(*args, **kw).arguments
        if bound["audit_flag"]:
            active_box.append(bound["active"].clone())
        return orig_apply(*args, **kw)

    def rel(a, b, *args, **kw):
        out = orig_rel(a, b, *args, **kw)
        sink.append((out.clone(), active_box[-1]))
        return out

    obs_audit.apply_audit, obs_audit.rel_err_rows = apply, rel
    try:
        yield
    finally:
        obs_audit.apply_audit, obs_audit.rel_err_rows = orig_apply, orig_rel


def same_latents(done, base) -> bool:
    by_rid = {r.rid: r.latents for r in base}
    return all(np.array_equal(r.latents, by_rid[r.rid]) for r in done)


def phase_audit(torch, dev, wl, model, m, base, syncs_off):
    """The fastcache serve with a collector and the audit plane at 1/32
    (the reference's default) and at 1.0: latents bitwise the audit-off
    serve's (``base``), one saliency_delta launch more per audited step
    (all on onepass, checked by phase_serve), the served ratio the
    parent's; syncs per model step of an audited warm-up (audit 1.0, no
    collector: nothing harvested) those of the audit-off warm-up; nocache
    audited exactly zero.  Prints the error's p50 / p95 (histogram) and
    max (exact), Eq. 9's bound, the per-layer mean error and the audited
    steps' extra wall time.  Returns the audited serves' launches."""
    wl_full = dataclasses.replace(wl, audit_fraction=1.0)
    syncs = phase_syncs(torch, wl_full, model, label="syncs_audit")
    if syncs != syncs_off:
        raise AssertionError(f"syncs per model step (counted, flagged in "
                             f"the port) {syncs} with the audit plane on, "
                             f"{syncs_off} off")
    out = {}
    for frac in (m.DEFAULT_AUDIT_FRACTION, 1.0):
        wl_a = dataclasses.replace(wl, audit_fraction=frac)
        col = m.MetricsCollector(labels={"policy": wl.policy})
        errs = []
        with capture_audit(m.obs_audit, errs):
            res = phase_serve(torch, dev, wl_a, model, m,
                              label=f"serve_audit_{frac:g}",
                              engine_kwargs={"collector": col})
        eng, runner = res.eng, res.runner
        w = col.windows[-1]
        c = w["counters"]
        if not same_latents(res.done, base.done):
            raise AssertionError(f"audit {frac}: latents differ from the "
                                 "audit-off serve's")
        if c[m.obs_metrics.AUDIT_STEPS] != eng.audited_steps or not (
                eng.audited_steps > 0):
            raise AssertionError(f"audit {frac}: {c} against "
                                 f"{eng.audited_steps} audited steps")
        rows = torch.cat([e[a] for e, a in errs]).float().cpu().numpy()
        if len(rows) != c[m.obs_metrics.AUDIT_SLOT_STEPS] or not \
                np.isfinite(rows).all():
            raise AssertionError(f"audit {frac}: {len(rows)} error rows, "
                                 f"counter {c}")
        bound = runner.audit_bound()
        extra_s = res.wall - base.wall
        emit({"phase": "audit", "audit_fraction": frac,
              "model_steps": eng.model_steps,
              "audited_steps": eng.audited_steps,
              "audited_slot_steps": c[m.obs_metrics.AUDIT_SLOT_STEPS],
              "bound_violations": c[m.obs_metrics.BOUND_VIOLATIONS],
              "eq9_bound": bound,
              "audit_rel_err_p50_hist": col.quantile(
                  m.obs_metrics.AUDIT_REL_ERR, 0.5),
              "audit_rel_err_p95_hist": col.quantile(
                  m.obs_metrics.AUDIT_REL_ERR, 0.95),
              "audit_rel_err_p50": float(np.percentile(rows, 50)),
              "audit_rel_err_p95": float(np.percentile(rows, 95)),
              "audit_rel_err_max": float(rows.max()),
              "layer_err_mean": w["audit"]["layer_err_mean"],
              "burn_rate_window": w["audit"].get("burn_rate_window"),
              "wall_s": res.wall, "audit_off_wall_s": base.wall,
              "extra_wall_s_per_audited_step":
                  extra_s / eng.audited_steps,
              "latents_bitwise_audit_off": True})
        out[frac] = res.launches
    # nocache computes the true forward: its audit measures exactly zero
    wl_nc = dataclasses.replace(wl, policy="nocache", audit_fraction=1.0,
                                requests=2, steps=10)
    col = m.MetricsCollector()
    res = phase_serve(torch, dev, wl_nc, model, m, label="serve_audit_nocache",
                      engine_kwargs={"collector": col})
    h = col.windows[-1]["histograms"][m.obs_metrics.AUDIT_REL_ERR]
    emit({"phase": "audit_nocache", "audited_slot_steps": h["count"],
          "audit_rel_err_sum": h["sum"]})
    if not (h["count"] > 0 and h["sum"] == 0.0):
        raise AssertionError(f"nocache audit: {h}")
    return out


def phase_metrics(torch, dev, wl, model, m, base):
    """The merge-off fastcache serve with a collector (windows every 25
    engine steps) and with the metrics plane off: both ratios the
    parent's, latents bitwise the plane-on serve's; the Prometheus text's
    lines, the JSONL windows, one on / off pair of wall times, and the
    launches of the per-step update alone (torch.profiler around it)."""
    col = m.MetricsCollector(labels={"policy": wl.policy}, window_steps=25)
    res = phase_serve(torch, dev, wl, model, m, label="serve_metrics",
                      engine_kwargs={"collector": col})
    off = phase_serve(torch, dev, wl, model, m, label="serve_metrics_off",
                      engine_kwargs={"enable_metrics": False})
    if not (same_latents(res.done, base.done)
            and same_latents(off.done, base.done)):
        raise AssertionError("metrics plane on / off: latents differ")
    text = col.to_prometheus()
    parsed = m.parse_prometheus(text)
    totals = col.totals()
    if totals[m.obs_metrics.SERVE_STEPS] != res.eng.model_steps:
        raise AssertionError(f"serve_steps_total {totals} against "
                             f"{res.eng.model_steps} model steps")
    # the per-step update alone, with a step's real inputs
    eng = res.eng
    active = np.ones((eng.S,), bool)
    k = len(eng._acc_keys)
    dsum = torch.ones((k,), device=dev)
    dfold = torch.ones((k, eng.S), device=dev)
    eng._update_metrics(active, dsum, dfold)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    calls = 10
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            eng._update_metrics(active, dsum, dfold)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(1 for e in events if "emcpy" not in e.name)
    copies = len(events) - kernels
    emit({"phase": "metrics", "block_cache_ratio_plane_on":
              res.stats["block_cache_ratio"],
          "block_cache_ratio_plane_off": off.stats["block_cache_ratio"],
          "prometheus_lines": len(text.splitlines()),
          "prometheus_metrics": len(parsed),
          "jsonl_windows": len(col.to_jsonl().splitlines()),
          "serve_steps_total": totals[m.obs_metrics.SERVE_STEPS],
          "wall_s_plane_on": res.wall, "wall_s_plane_off": off.wall,
          "update_kernels_per_step": kernels / calls,
          "update_copies_per_step": copies / calls,
          "update_kernel_names": sorted({e.name[:60] for e in events})})
    return res.launches


@contextlib.contextmanager
def capture_gemms(fc_mod, sink, skip: int):
    """Record the inputs and outputs of the fused_gate and linear_blend
    calls fastcache makes, after the first ``skip`` fused_gate calls (the
    first gated step's, where no tracker is initialized yet), the first
    PARITY_CALLS of each (copies on the card), into ``sink``."""
    orig = {"fused_gate": fc_mod.fused_gate,
            "linear_blend": fc_mod.linear_blend}
    seen = {"fused_gate": 0, "linear_blend": 0}

    def recorder(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            seen[name] += 1
            first = skip if name == "fused_gate" else 1
            if first <= seen[name] < first + PARITY_CALLS:
                outs = out if isinstance(out, tuple) else (out,)
                sink[name].append((
                    [a.clone() if hasattr(a, "clone") else a for a in args],
                    dict(kw), [o.clone() for o in outs]))
            return out
        return rec

    for name, fn in orig.items():
        setattr(fc_mod, name, recorder(name, fn))
    try:
        yield
    finally:
        for name, fn in orig.items():
            setattr(fc_mod, name, fn)


def rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def phase_calibrated_parity(torch, captured, fg_mod, lb_mod, ref):
    """The fitted serve's first fused_gate and linear_blend calls (bf16 X,
    the fitted f32 maps, served on the wgmma_split route with the split
    copies the runner makes for maps handed in) held against the plain
    version computed in f32 with the same maps: gate bits exact, the
    totals at 1e-4, the outputs at the kernel phase's bf16 tolerance
    elementwise (BLEND_TOL) and within SPLIT_REL_L2 rel-L2.  Beside it, the
    same inputs on the SIMT route (the f32 W: the yardstick) and on the
    wgmma route with a single bf16 copy of each map (rel-L2 against the
    plain version; for fused_gate also with every sample forced to gate:
    the approximation alone), the reason fitted maps are split."""
    tol = BLEND_TOL["bfloat16"]
    served, worst = [], 0.0
    simt_gate, simt_blend = [], []
    bf16_gate, bf16_forced, bf16_blend = [], [], []

    def hold(got, want):
        nonlocal worst
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        served.append(rel_l2(torch, got, want))

    def split_call(kw, d):
        if (not route.is_split(kw.get("w_bf16"), d)
                or kw.get("gemm") is not None):
            raise AssertionError("a fitted map was not served with its "
                                 "split copy on the wrappers' rule")

    from repro_torch.cuda_kernels import route
    for args, kw, outs in captured["fused_gate"]:
        split_call(kw, args[0].shape[-1])
        x, prev_in, prev_out, w, b, sigma2, eligible = args
        gkw = dict(threshold=kw["threshold"], gamma=kw["gamma"],
                   use_blend=kw["use_blend"])
        want = ref.fused_gate(*args, **gkw)
        if not torch.equal(outs[1], want[1]):
            raise AssertionError("calibrated fused_gate: gate bits differ "
                                 "from the plain version's")
        torch.testing.assert_close(outs[2], want[2], rtol=1e-4, atol=0)
        torch.testing.assert_close(outs[3], want[3], rtol=1e-4, atol=0)
        hold(outs[0], want[0])
        simt = fg_mod._launch("simt", *args, gkw["threshold"], gkw["gamma"],
                              gkw["use_blend"], None)
        simt_gate.append(rel_l2(torch, simt[0], want[0]))
        copy = w.to(torch.bfloat16)
        tc = fg_mod._launch("wgmma", *args, gkw["threshold"], gkw["gamma"],
                            gkw["use_blend"], copy)
        bf16_gate.append(rel_l2(torch, tc[0], want[0]))
        forced = (x, prev_in, prev_out, w, b, sigma2,
                  torch.ones_like(eligible))
        fkw = dict(gkw, threshold=float("inf"))
        tc = fg_mod._launch("wgmma", *forced, fkw["threshold"], fkw["gamma"],
                            fkw["use_blend"], copy)
        if not bool(tc[1].all()):
            raise AssertionError("forced gate did not gate every sample")
        bf16_forced.append(rel_l2(torch, tc[0],
                                  ref.fused_gate(*forced, **fkw)[0]))
    for args, kw, outs in captured["linear_blend"]:
        split_call(kw, args[0].shape[-1])
        x, w, b, prev = args
        want = ref.linear_blend(x, w, b, prev, kw["gamma"])
        hold(outs[0], want)
        simt_blend.append(rel_l2(torch, lb_mod._launch(
            "simt", x, w, b, prev, kw["gamma"], None), want))
        tc = lb_mod._launch("wgmma", x, w, b, prev, kw["gamma"],
                            w.to(torch.bfloat16))
        bf16_blend.append(rel_l2(torch, tc, want))
    emit({"phase": "calibrated_parity", "calls": PARITY_CALLS,
          "route": "wgmma_split",
          "against": "ref.fused_gate / ref.linear_blend in f32, fitted W",
          "served_rel_l2": served, "served_max_abs_err": worst,
          "tol": tol, "bound": SPLIT_REL_L2, "gate_bits_exact": True,
          "simt_fused_gate_rel_l2": simt_gate,
          "simt_linear_blend_rel_l2": simt_blend,
          "bf16_copy_fused_gate_rel_l2": bf16_gate,
          "bf16_copy_fused_gate_rel_l2_forced_gating": bf16_forced,
          "bf16_copy_linear_blend_rel_l2": bf16_blend})
    if not max(served) <= SPLIT_REL_L2:
        raise AssertionError(f"calibrated serve: rel-L2 {max(served)} > "
                             f"{SPLIT_REL_L2}")


def phase_calibrate(torch, dev, wl, model, m, fg_mod, lb_mod, ref):
    """record_calibration over 50 steps at batch 2 (one saliency_delta
    launch per step, all on onepass, no other kernel); calibrate_dit on 4
    batches of 8 latents (seed 0); fastcache serves with the fitted maps
    (their cache ratio printed, not held to the parent's): eager on the
    wgmma_split route, whose first served fused_gate / linear_blend calls
    phase_calibrated_parity re-runs; eager on the named SIMT route, the
    yardstick; on the graph path (latents bitwise the eager split serve's,
    every warm step a replay, 0 policy syncs); then the identity maps'
    serve on the graph path.  Returns (recorder launches, every serve's launches by
    label)."""
    runner = m.CachedDiT(model, m.FastCacheConfig(), policy="nocache")
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    rec = m.record_calibration(runner, batch=2, num_steps=50,
                               guidance_scale=wl.guidance, seed=0)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0
    rec_launches = {name: fn.launches for name, fn in m.kernels.items()}
    by_route = dict(m.kernels["saliency_delta"].launches_by_route)
    want = dict.fromkeys(rec_launches, 0)
    want["saliency_delta"] = 50
    if rec_launches != want or by_route != {"onepass": 50, "simt": 0}:
        raise AssertionError(f"recorder launches {rec_launches}, "
                             f"{by_route}")
    em = rec["errors_mean"]
    if em.shape != (runner.L, 50) or not np.isfinite(em).all():
        raise AssertionError(f"errors_mean {em.shape}")
    emit({"phase": "calibrate_record", "steps": 50, "batch": 2,
          "rows": int(rec["batch"]), "seconds": rec_s,
          "launches": rec_launches, "launches_by_route": by_route,
          "errors_mean_per_step": [float(v) for v in em.mean(axis=0)]})
    batches = m.fit_batches(model, n=4, batch=8, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fitted = m.calibrate_dit(model, batches)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v).all()) for v in fitted.values()):
        raise AssertionError("calibrate_dit: non-finite maps")
    rows = 4 * 8 * model.num_tokens
    d = model.cfg.d_model
    eye = torch.eye(d, device=dev)
    emit({"phase": "calibrate_fit", "batches": 4, "batch": 8,
          "pair_rows_per_map": rows,
          "pair_bytes_f32": 2 * (model.cfg.num_layers + 1) * rows * d * 4,
          "seconds": fit_s,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(dev),
          "w_l_rel_dist_from_identity": [
              float((w - eye).norm() / eye.norm()) for w in fitted["W_l"]],
          "w_c_rel_dist_from_identity":
              float((fitted["W_c"] - eye).norm() / eye.norm())})
    captured = {"fused_gate": [], "linear_blend": []}
    fitted_kw = {"fc_params": fitted}
    # maps handed in: split copies, every call on the wgmma_split route.
    # The parity serve is eager: the recorder copies the calls as they run
    eager = dataclasses.replace(wl, step_graph=False)
    with capture_gemms(m.fastcache_mod, captured, skip=model.cfg.num_layers):
        res = phase_serve(torch, dev, eager, model, m,
                          label="serve_calibrated", engine_kwargs=fitted_kw,
                          parent_ratio=False, routes=ROUTE_OF_FITTED)
    phase_calibrated_parity(torch, captured, fg_mod, lb_mod, ref)
    # the yardstick: the same maps on the named SIMT route (the f32 W)
    simt = phase_serve(torch, dev, eager, model, m,
                       label="serve_calibrated_simt",
                       engine_kwargs={**fitted_kw, "simt_maps": True},
                       parent_ratio=False,
                       routes={"fused_gate": "simt", "linear_blend": "simt"})
    # the graph path (the engine's default on the card): two short serves
    # under sync debug first; the first takes the fitted maps' step key
    # past its eager warm-up calls (step_graph.WARMUP_CALLS), so that the
    # second's warm steps, and every warm step of the timed serve, run in
    # a graph (each engine's first captures it), as the identity serve's do
    graph_wl = dataclasses.replace(wl, step_graph=None)
    first_use = dit_path_syncs(torch, graph_wl, model, m, None, **fitted_kw)
    syncs = dit_path_syncs(torch, graph_wl, model, m, None, **fitted_kw)
    graph = phase_serve(torch, dev, graph_wl, model, m,
                        label="serve_calibrated_graph",
                        engine_kwargs=fitted_kw, parent_ratio=False,
                        routes=ROUTE_OF_FITTED)
    bitwise = same_latents(graph.done, res.done)
    simt_by_rid = {r.rid: r.latents for r in simt.done}
    split_by_rid = {r.rid: r for r in res.done}
    # the identity maps' serve right after, on the graph path, for the
    # pair's wall times
    ident = phase_serve(torch, dev, graph_wl, model, m,
                        label="serve_identity")
    warm = graph.runner.impl.step_kinds["warm"]
    emit({"phase": "calibrated_cost",
          "block_cache_ratio": {"split": res.stats["block_cache_ratio"],
                                "simt": simt.stats["block_cache_ratio"],
                                "split_graph":
                                    graph.stats["block_cache_ratio"]},
          "simt_latent_distance_of_scale": latent_distance(simt_by_rid,
                                                           split_by_rid),
          "graph_latents_bitwise_eager": bitwise,
          "graph_replays": graph.runner.graphs.replays,
          "graph_warm_steps": warm,
          "graph_policy_host_syncs": graph.runner.impl.host_syncs,
          "graph_syncs": syncs, "graph_syncs_first_use": first_use,
          "wall_s": {"split_eager": res.wall, "simt_eager": simt.wall,
                     "split_graph": graph.wall, "identity_graph": ident.wall},
          "engine_steps_per_s": {
              "split_eager": res.eng.clock / res.wall,
              "simt_eager": simt.eng.clock / simt.wall,
              "split_graph": graph.eng.clock / graph.wall,
              "identity_graph": ident.eng.clock / ident.wall},
          "calibrated_fused_gate_route": "wgmma_split",
          "identity_fused_gate_route": "wgmma", "card": smi()})
    if not bitwise:
        raise AssertionError("the fitted serve's latents on the graph path "
                             "differ from the eager path's")
    if (syncs["flagged_in_port_per_warm_step"],
            syncs["counted_per_warm_step"]) != (0.0, 0.0) \
            or graph.runner.impl.host_syncs != 0 \
            or graph.runner.graphs.replays != warm:
        raise AssertionError(f"fitted graph path: syncs {syncs}, "
                             f"{graph.runner.impl.host_syncs} in the serve, "
                             f"{graph.runner.graphs.replays} replays of "
                             f"{warm} warm steps")
    return rec_launches, {"serve_calibrated": res.launches,
                          "serve_calibrated_simt": simt.launches,
                          "serve_calibrated_graph": graph.launches,
                          "serve_identity": ident.launches}


def phase_serve_nocfg(torch, dev, wl, model, m):
    """guidance 1.0 served by the default engine (CFG rows, per-sample
    1.0) and by the cfg_rows=False engine (half the model batch): latents
    bitwise equal, fused_gate launches exact on both (phase_serve).
    Returns the fast path's launches."""
    wl_g1 = dataclasses.replace(wl, guidance=1.0)
    full = phase_serve(torch, dev, wl_g1, model, m, label="serve_g1",
                       parent_ratio=False)
    fast = phase_serve(torch, dev, dataclasses.replace(wl_g1, cfg_rows=False),
                       model, m, label="serve_nocfg", parent_ratio=False)
    bitwise = same_latents(fast.done, full.done)
    emit({"phase": "nocfg_parity", "latents_bitwise": bitwise,
          "max_abs_diff": max(float(np.abs(a.latents - b.latents).max())
                              for a, b in zip(
                                  sorted(fast.done, key=lambda r: r.rid),
                                  sorted(full.done, key=lambda r: r.rid))),
          "fused_gate_launches": [fast.launches["fused_gate"],
                                  full.launches["fused_gate"]],
          "wall_s": [fast.wall, full.wall]})
    if not bitwise:
        raise AssertionError("cfg_rows=False latents differ from the "
                             "default engine's at guidance 1.0")
    return fast.launches


def phase_trace(torch, dev, wl, model, m):
    """A short traced serve (2 requests, 10 steps): the Chrome trace
    document passes validate_trace and carries every request's spans."""
    wl_t = dataclasses.replace(wl, requests=2, steps=10)
    tracer = m.TraceRecorder()
    runner, eng = wl_t.build_engine(model, tracer=tracer)
    done = eng.run(wl_t.build_trace(model))
    doc = tracer.to_json()
    m.validate_trace(doc)
    names = [e["name"] for e in doc["traceEvents"]]
    emit({"phase": "trace", "events": len(names),
          "requests": len(done), "serve_steps": names.count("serve_step"),
          "denoise_slices": sum(n.startswith("denoise") for n in names),
          "counter_events": sum(e["ph"] == "C" for e in doc["traceEvents"])})
    if names.count("admit") != len(done) or names.count("finish") != len(done):
        raise AssertionError("trace: admit / finish events missing")


PREEMPT_AFTER = 3          # the victim's steps before it is preempted
PARKED_STEPS = 2           # steps it waits before the donor slot refills
SLO_TRACE = dict(requests=16, rate=0.5, burst_rate=2.0, burst_start=5,
                 burst_len=20, priority_mix=(0, 1, 1, 2),
                 deadline_slack_mix=(80, 120, 200), sched="edf", slo=True,
                 on_miss="reject", preempt=True, shed=True)
# req.cache's control-plane keys: a preemption changes them, not the counters
CONTROL_KEYS = ("queue_wait_steps", "preemptions")


def counters(cache):
    return {k: v for k, v in cache.items() if k not in CONTROL_KEYS}


def path_kernels(runner):
    """The kernels a fastcache serve launches: B1, B5, B6, and the merge
    kernels when token merging is on."""
    names = ["fused_gate", "saliency_delta", "linear_blend"]
    if runner.reducer is not None:
        names += list(WINDOW_KERNELS) + ["unmerge_scatter"]
    return names


def check_path(label, wl, runner, eng, m, launches):
    """A path's launches: exactly expected_launches, each of its kernels
    at least once, every B1 / B5 / B6 launch (and B2 / B3 when merged) on
    its tensor-core or onepass route (ROUTE_OF_SERVE)."""
    want = expected_launches(wl, runner, eng, launches)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches} != {want}")
    check_if_nodes(label, wl, runner, m)
    if wl.policy != "fastcache":
        return
    for name in path_kernels(runner):
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} never launched")
    for name, which in ROUTE_OF_SERVE.items():
        got = dict(m.kernels[name].launches_by_route)
        if got != {**dict.fromkeys(got, 0), which: launches[name]}:
            raise AssertionError(f"{label}: {name} launches by route {got}, "
                                 f"expected all {launches[name]} on {which}")


def snapshot_tensors(snap):
    """Every tensor of a preemption snapshot, by path."""
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}{k}/")
        elif isinstance(tree, tuple):
            for i, v in enumerate(tree):
                walk(v, f"{prefix}{i}/")
        else:
            out[prefix[:-1]] = tree
    walk(snap, "")
    return out


def profiled_launches(torch, fn, calls: int = 10):
    """Kernels and copies per call of ``fn`` on the card (torch.profiler
    around ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(1 for e in events if "emcpy" not in e.name)
    return kernels / calls, (len(events) - kernels) / calls


def event_ms(torch, fn):
    """``fn()`` between two CUDA events: the stream's span from the call's
    first enqueued work to its last (host enqueue gaps included)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    return out, (start, end)


def run_preempt_script(torch, wl, model, m, preempt):
    """The reference test's preempt script at full width with a third
    request: a and b admitted, PREEMPT_AFTER steps, b preempted, then
    PARKED_STEPS steps, c admitted (into b's slot), one step, b resumed
    (into another slot), drained.  Without ``preempt`` the same requests
    on the same clock, straight through (b keeps its slot, c the next).
    ``preempt`` and the resuming ``add_request`` run under sync debug
    "error" between CUDA events; every count is zeroed just before the
    first admission and read after the drain."""
    runner, eng = wl.build_engine(model)
    reqs = [m.DiffusionRequest(rid=i, label=i + 1, seed=10 + i,
                               num_steps=wl.steps, guidance_scale=wl.guidance)
            for i in range(3)]
    a, b, c = reqs
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    eng.add_request(a)
    eng.add_request(b)
    done, info = [], {}
    for _ in range(PREEMPT_AFTER):
        done += eng.step()
    if preempt:
        donor = eng.slots.index(b)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, info["preempt_events"] = event_ms(torch,
                                                 lambda: eng.preempt(donor))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        kept = {k: v.clone() for k, v in snapshot_tensors(b.snapshot).items()}
    for _ in range(PARKED_STEPS):
        done += eng.step()
    eng.add_request(c)
    done += eng.step()
    if preempt:
        if eng.slots.index(c) != donor:
            raise AssertionError("c did not take the donor slot")
        now = snapshot_tensors(b.snapshot)
        info["snapshot_survived"] = all(torch.equal(v, kept[k])
                                        for k, v in now.items())
        info["snapshot_bytes"] = sum(v.numel() * v.element_size()
                                     for v in now.values())
        info["snapshot_leaves"] = len(now)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, info["resume_events"] = event_ms(torch,
                                                lambda: eng.add_request(b))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        info["slots"] = {"donor": donor, "resumed": eng.slots.index(b)}
        if info["slots"]["resumed"] == donor:
            raise AssertionError("b resumed in its donor slot")
    while len(done) < 3:
        done += eng.step()
    torch.cuda.synchronize()
    info["wall_s"] = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in m.kernels.items()}
    for key in ("preempt_events", "resume_events"):
        if key in info:
            start, end = info.pop(key)
            info[key.replace("events", "span_ms")] = start.elapsed_time(end)
    return runner, eng, sorted(done, key=lambda r: r.rid), launches, info


def phase_preempt_resume(torch, dev, wl, model, m, label):
    """The preempt script against the same requests served without a
    preemption: the victim's latents bitwise and its req.cache exact (the
    other two as well); the snapshot unchanged after c's admission into
    its slot and a step; preempt and resume free of host syncs (sync debug
    "error"); the path's launches exact and on the fast routes.  Then the
    pair's device time alone, on the drained engine: ``_snapshot`` (the
    copy out), the preempt's donor reset, and ``_restore``, each timed
    behind a spin (device_ms) with its kernels and copies per call
    (torch.profiler), beside the bound: the snapshot's bytes read and
    written once at 3.35 TB/s.  Returns the launches of the preempted
    run."""
    _, _, want, _, _ = run_preempt_script(torch, wl, model, m, False)
    runner, eng, got, launches, info = run_preempt_script(torch, wl, model,
                                                          m, True)
    check_path(label, wl, runner, eng, m, launches)
    victim = got[1]
    if (victim.preemptions, victim.steps_done) != (1, PREEMPT_AFTER):
        raise AssertionError(f"victim: {victim.preemptions} preemptions, "
                             f"{victim.steps_done} steps done")
    if not info["snapshot_survived"]:
        raise AssertionError("the snapshot changed after the donor slot "
                             "was refilled")
    diffs = {}
    for r, w in zip(got, want):
        if r.latents.shape != latent_shape(model) \
                or not np.isfinite(r.latents).all():
            raise AssertionError(f"rid={r.rid}: latents not finite")
        diffs[r.rid] = float(np.abs(r.latents - w.latents).max())
        if counters(r.cache) != counters(w.cache):
            raise AssertionError(f"rid={r.rid}: req.cache {r.cache} != "
                                 f"the un-preempted serve's {w.cache}")
        control = (r.cache["queue_wait_steps"], r.cache["preemptions"])
        if control != (float(r.queue_wait_steps), float(r.preemptions)):
            raise AssertionError(f"rid={r.rid}: req.cache's queue wait and "
                                 f"preemptions {control} != the request's")
    bitwise = {rid: d == 0.0 for rid, d in diffs.items()}
    # the pair alone, on the drained engine (slot 0 -> slot 1)
    snap = eng._snapshot(0)
    rows = eng._slot_rows(0)
    timings = {
        "snapshot": lambda: eng._snapshot(0),
        "reset": lambda: eng.runner.reset_slot(eng.state, rows),
        "restore": lambda: eng._restore(snap, 1),
    }
    nbytes = sum(v.numel() * v.element_size()
                 for v in snapshot_tensors(snap).values())
    bound_ms, _ = bound(2.0 * nbytes, 0.0)
    pair = {}
    for name, fn in timings.items():
        kernels, copies = profiled_launches(torch, fn)
        pair[name] = {"device_ms": device_ms(torch, fn),
                      "kernels": kernels, "copies": copies}
    emit({"phase": label, "merge_ratio": wl.merge_ratio, **info,
          "latents_bitwise": bitwise, "max_abs_diff": diffs,
          "victim_cache": victim.cache, "launches": launches,
          "pair": pair, "snapshot_bytes_timed": nbytes,
          "bound_ms_each": bound_ms, "card": smi()})
    if not all(bitwise.values()):
        # bf16 tolerance where the card does not give the bits back
        scale = float(np.abs(want[1].latents).max())
        if diffs[1] > 5e-2 * scale:
            raise AssertionError(f"victim latents off by {diffs[1]} "
                                 f"(scale {scale})")
    return launches


def phase_slo_serve(torch, dev, wl, model, m):
    """SLOScheduler over the calm -> burst -> calm trace (SLO_TRACE on
    the Workload's model and engine), counts zeroed just before and read
    just after; then the same trace served plainly (engine.run, FIFO) for
    the per-step times.  Checks: every request finished or rejected, at
    least one preemption, resumes == preemptions, the launches exact and on
    the fast routes, fastcache's syncs per warm model step 29 in both
    serves.  Prints the per-class summary, the shed walk, the collector's
    SLO counts, and per engine step the wall time and the CUDA-event span
    (the step timer's) of both serves."""
    wl_slo = dataclasses.replace(wl, **SLO_TRACE)
    col = m.MetricsCollector(labels={"policy": wl.policy})
    runner, eng = wl_slo.build_engine(model, collector=col)
    slo = wl_slo.build_slo(eng, col)
    walk = []
    observe = slo.controller.observe

    def observe_and_log(depth):
        lvl = observe(depth)
        walk.append(slo.controller.level_idx)
        return lvl

    slo.controller.observe = observe_and_log
    trace = wl_slo.build_trace(model)
    torch.cuda.synchronize()
    zero_counts()                         # the path starts here
    t0 = time.perf_counter()
    done = slo.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in m.kernels.items()}
    check_path("slo_serve", wl_slo, runner, eng, m, launches)
    slo.timer.poll()
    totals = col.totals()
    rejected = slo.rejected
    if len(done) + len(rejected) != len(trace):
        raise AssertionError(f"{len(done)} finished + {len(rejected)} "
                             f"rejected of {len(trace)}")
    for r in done:
        if r.latents.shape != latent_shape(model) \
                or not np.isfinite(r.latents).all():
            raise AssertionError(f"rid={r.rid}: latents not finite")
    preemptions = sum(r.preemptions for r in done)
    if preemptions < 1 or totals.get(m.obs_metrics.RESUMES, 0.0) \
            != preemptions or totals[m.obs_metrics.PREEMPTIONS] != preemptions:
        raise AssertionError(f"preemptions {preemptions}, collector "
                             f"{totals}")

    # the same trace, plainly served, each step between CUDA events
    runner_p, eng_p = wl_slo.build_engine(model)
    timer = m.StepTimer(dev)
    step = eng_p.step

    def timed_step():
        timer.start()
        out = step()
        timer.stop()
        return out

    eng_p.step = timed_step
    trace_p = wl_slo.build_trace(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done_p = eng_p.run(trace_p)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    timer.poll()

    # fastcache on a warm step: a graph replay, no policy read
    syncs = {"slo": syncs_per_warm_step(runner),
             "plain": syncs_per_warm_step(runner_p)}
    if set(syncs.values()) != {0.0}:
        raise AssertionError(f"syncs per warm model step {syncs}")
    emit({"phase": "slo_serve", "requests": len(trace),
          "finished": len(done), "rejected": len(rejected),
          "reject_reasons": collections.Counter(
              r.reject_reason for r in rejected),
          "preemptions": preemptions,
          "collector": {k: totals.get(k, 0.0) for k in (
              m.obs_metrics.ADMISSIONS, m.obs_metrics.PREEMPTIONS,
              m.obs_metrics.RESUMES, m.obs_metrics.REJECTIONS,
              m.obs_metrics.DEADLINE_MISSES,
              m.obs_metrics.REQUESTS_FINISHED)},
          "gauges": dict(col._gauges),
          "shed_level_final": slo.controller.level.name,
          "shed_level_max": max(walk), "shed_walk_changes": sum(
              1 for x, y in zip(walk, walk[1:]) if x != y),
          "by_class": m.summarize_by_class(done + rejected),
          "num_steps_served": collections.Counter(r.num_steps for r in done),
          "engine_steps": eng.clock, "model_steps": eng.model_steps,
          "step_kinds": dict(runner.impl.step_kinds),
          "launches": launches,
          "syncs_per_warm_model_step": syncs,
          "host_syncs_per_model_step": {
              "slo": (runner.impl.host_syncs + eng.host_syncs)
              / eng.model_steps,
              "plain": (runner_p.impl.host_syncs + eng_p.host_syncs)
              / eng_p.model_steps},
          "wall_ms_per_engine_step": {"slo": wall / eng.clock * 1e3,
                                      "plain": wall_p / eng_p.clock * 1e3},
          "event_ms_per_engine_step": {
              "slo": slo.timer.total_ms / slo.timer.count,
              "plain": timer.total_ms / timer.count},
          "model_step_ms_ema": slo.admission.predictor.model_step_ms,
          "plain": {"finished": len(done_p), "engine_steps": eng_p.clock,
                    "model_steps": eng_p.model_steps},
          "card": smi()})
    return launches


def timed_run(torch, m, eng, trace):
    """``eng.run(trace)`` with each engine step between CUDA events (the
    SLO plane's StepTimer).  Returns the finished requests, the wall
    seconds and the mean event span per engine step in ms."""
    timer = m.StepTimer(torch.device("cuda"))
    step = eng.step

    def timed_step():
        timer.start()
        out = step()
        timer.stop()
        return out

    eng.step = timed_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timer.poll()
    return done, wall, timer.total_ms / max(timer.count, 1)


def syncs_per_warm_step(runner) -> float:
    """Policy syncs per warm model step (cold and mixed steps read the host
    mirror, nothing on the device)."""
    return runner.impl.host_syncs / runner.impl.step_kinds["warm"]


def sharded_model(torch, wl, dtype=None, num_layers=None):
    """The Workload's DiT on the current card (its seed), optionally in
    another dtype or cut to ``num_layers`` at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models.dit import DiTModel
    cfg = get_config(wl.arch)
    if dtype is not None:
        cfg = cfg.replace(dtype=dtype)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    dev = torch.device("cuda")
    return DiTModel(cfg, device=dev).init(
        torch.Generator(dev).manual_seed(wl.seed))


def sharded_rank(rank, world, port, topo, scenarios):
    """One rank of a two-rank sharded serve on card 0 over gloo (a
    ``launch.mesh.RankGroup`` target).  For each scenario
    (SHARDED_SCENARIOS) it builds the Workload's model (in the scenario's
    dtype, depth and plan length) and the engine through
    ``Workload.build_engine`` on the (data, model) mesh, with blocks that
    skip their all-reduce when ``bad_reduce``: ``rank_self_check`` or
    ``rank_serve``.  Returns the results, latents included."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import init_ranks, make_serving_mesh
    from repro_torch.launch.serve_diffusion import Workload
    from repro_torch.models import dit as dit_mod
    from repro_torch.serving.slo import StepTimer
    m = SimpleNamespace(StepTimer=StepTimer, kernels=kernel_wrappers())
    init_ranks(rank, world, port=port, backend="gloo")
    mesh = make_serving_mesh(*topo)
    wl = Workload()
    results = {}
    for sc in scenarios:
        name = sc["name"]
        if name == "block":
            results[name] = block_tp_check(torch, wl, mesh, dit_mod)
            continue
        wl_sc = dataclasses.replace(wl, steps=sc.get("steps", wl.steps))
        model = sharded_model(torch, wl_sc, sc.get("dtype"),
                              sc.get("num_layers"))
        real = dit_mod.tp_all_reduce
        if sc.get("bad_reduce"):
            dit_mod.tp_all_reduce = lambda partial: partial
        try:
            results[name] = (
                rank_self_check(wl_sc, model, mesh, sc.get("atol"))
                if sc.get("kind") == "self_check" else
                rank_serve(torch, wl_sc, model, mesh, m,
                           f"sharded_serve_{topo[0]}x{topo[1]}_{name}"
                           f"_rank{rank}"))
        finally:
            dit_mod.tp_all_reduce = real
        del model
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    return results


def rank_self_check(wl, model, mesh, atol=None) -> dict:
    """Build the engine with the numerics self-check on (at ``atol``, or
    the engine's own 1e-2 when None) and record what it said."""
    import functools
    from repro_torch.serving.sharded_engine import ShardedDiffusionEngine
    cls = ShardedDiffusionEngine
    check = cls._verify_step_numerics
    if atol is not None:
        cls._verify_step_numerics = functools.partialmethod(check, atol=atol)
    try:
        wl.build_engine(model, mesh=mesh, numerics_check=True)
        return {"raised": None}
    except RuntimeError as e:
        return {"raised": str(e)}
    finally:
        cls._verify_step_numerics = check


def rank_serve(torch, wl, model, mesh, m, label) -> dict:
    """Serve ``wl`` on this rank through the sharded engine with the
    self-check off, every kernel's count zeroed just before and read just
    after; the launches held to expected_launches (and the routes to
    ROUTE_OF_SERVE in bf16).  On the graph path (the engine's default
    where it can capture: model = 1) the trace is served once before, so
    that every warm step of the timed serve is a replay (a key's first
    warm steps in a process run eagerly); there a warm step makes no
    policy sync, eagerly L.  Returns its record, latents included."""
    wl.warm_up(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner, eng = wl.build_engine(model, mesh=mesh, numerics_check=False)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if runner.step_graph:
        eng.run(wl.build_trace(model))
        runner, eng = wl.build_engine(model, mesh=mesh, numerics_check=False)
    trace = wl.build_trace(model)
    zero_counts()                         # the path starts here
    done, wall, span_ms = timed_run(torch, m, eng, trace)
    launches = {k: fn.launches                     # ... and ends here
                for k, fn in m.kernels.items()}
    if model.dtype == torch.bfloat16:
        check_path(label, wl, runner, eng, m, launches)
    elif launches != expected_launches(wl, runner, eng, launches):
        raise AssertionError(f"{label}: launches {launches}")
    warm = runner.impl.step_kinds["warm"]
    syncs = runner.impl.host_syncs / warm if warm else None
    if warm and syncs != (0.0 if runner.step_graph else float(runner.L)):
        raise AssertionError(f"{label}: {syncs} policy syncs per warm step "
                             f"(step_graph {runner.step_graph})")
    return {
        "step_graph": runner.step_graph,
        "step_graph_refusal": eng.graph_refusal,
        "graph_replays": runner.graphs.replays,
        "policy_syncs_per_warm_step": syncs,
        "batch_sum_round_trips_per_engine_step":
            eng.batch_sum_round_trips / eng.clock,
        "rank": torch.distributed.get_rank(), "topology": eng.topology(),
        "dtype": str(model.dtype), "layers": model.cfg.num_layers,
        "steps": wl.steps, "window": [eng._lo, eng.S_dev],
        "engine_build_s": build_s, "engine_steps": eng.clock,
        "model_steps": eng.model_steps,
        "step_kinds": dict(runner.impl.step_kinds), "launches": launches,
        "block_cache_ratio": eng.cache_stats()["block_cache_ratio"],
        "wall_s": wall, "engine_steps_per_s": eng.clock / wall,
        "wall_ms_per_engine_step": wall / eng.clock * 1e3,
        "event_ms_per_engine_step": span_ms,
        "engine_host_syncs": eng.host_syncs,
        "schedule": {r.rid: (r.admit_step, r.finish_step) for r in done},
        "latents": {r.rid: r.latents for r in done},
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}


def block_tp_check(torch, wl, mesh, dit_mod) -> dict:
    """One block of the Workload's DiT (full width, its seed) on this
    rank's shards, cut by the sharding rules as the engine cuts them,
    against the unsharded block on the same (8, 256, 1152) input, in f32
    and bf16; and with the all-reduce skipped.  Relative L2 of each."""
    from repro_torch.distributed import sharding as sh
    ctx = sh.ShardingCtx(mesh, sh.make_rules("serve"))
    coords = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    dev = torch.device("cuda")
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = sharded_model(torch, wl, dtype, num_layers=1)
        bp = model.blocks[0]
        g = torch.Generator(dev).manual_seed(1)
        d = model.cfg.d_model
        x = torch.randn((8, model.num_tokens, d), generator=g,
                        device=dev).to(model.dtype)
        c = torch.randn((8, d), generator=g, device=dev).to(model.dtype)
        with torch.no_grad():
            want = model.block_apply(bp, x, c).float()
            specs = sh.param_specs(model.param_defs(), ctx)["blocks"]
            for name, spec in specs.items():
                if any(a is not None for a in spec[1:]):
                    bp._parameters[name] = torch.nn.Parameter(
                        sh.local_slice(getattr(bp, name).data, spec[1:],
                                       coords, ctx.extents),
                        requires_grad=False)
            real = dit_mod.tp_all_reduce
            with sh.use_sharding(ctx=ctx):
                got = model.block_apply(bp, x, c).float()
                dit_mod.tp_all_reduce = lambda partial: partial
                try:
                    bad = model.block_apply(bp, x, c).float()
                finally:
                    dit_mod.tp_all_reduce = real
        rel = float((got - want).norm() / want.norm())
        rel_bad = float((bad - want).norm() / want.norm())
        if rel > BLOCK_TP_BOUND[dtype] or rel_bad < BLOCK_TP_FAULT:
            raise AssertionError(f"block on shards, {dtype}: rel L2 {rel} "
                                 f"(bound {BLOCK_TP_BOUND[dtype]}), "
                                 f"without the all-reduce {rel_bad}")
        out[dtype] = {"rel_l2": rel, "max_abs": float((got - want).abs().max()),
                      "scale": float(want.abs().max()),
                      "rel_l2_without_all_reduce": rel_bad,
                      "shard_shapes": {k: list(getattr(bp, k).shape)
                                       for k in ("wq", "wo", "w_in",
                                                 "w_out")}}
        del model
        torch.cuda.empty_cache()
    return out


def latent_distance(done_by_rid, want) -> dict:
    """Each request's max |latent difference| over the scale of the
    reference's latents, by rid."""
    return {rid: float(np.abs(lat - want[rid].latents).max()
                       / np.abs(want[rid].latents).max())
            for rid, lat in done_by_rid.items()}


def chaos_probe(torch, wl) -> list:
    """The served DiT's sensitivity, with no sharding: the Workload's
    model in f32 at full depth fed latents moved by one part in 2^23, each
    block's output's relative L2 change."""
    model = sharded_model(torch, wl, "float32")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(1)
    lat = torch.randn((8,) + latent_shape(model), generator=g, device=dev)
    t = torch.full((8,), 999, device=dev)
    labels = torch.zeros((8,), dtype=torch.int64, device=dev)
    out = []
    with torch.no_grad():
        c = model.conditioning(t, labels)
        x = model.tokens_in(lat)
        y = model.tokens_in(lat * (1.0 + 2.0 ** -23))
        for bp in model.blocks:
            x, y = model.block_apply(bp, x, c), model.block_apply(bp, y, c)
            out.append(float((x - y).norm() / x.norm()))
    del model
    torch.cuda.empty_cache()
    return out


def sharded_one_by_one(torch, wl, model, m, base) -> dict:
    """(1, 1) on nccl in this process, each serve through timed_run in one
    order, plain / sharded / sharded / plain / sharded with sync admission
    / sharded eager (``step_graph=False``, the yardstick): every sharded
    serve's latents and request counters bitwise the serve phase's (the
    graph path), ratio PARENT_BLOCK_CACHE_RATIO, 0 policy syncs per warm
    model step on the graph path (every warm step a replay) and L eager,
    one completion fetch a run (async); launches exact on every serve.
    Then a sharded graph serve with GRAPH_PROFILED_STEPS warm steps
    profiled (path_serve): each wrapper's replayed count held to the
    kernels the card ran by name.  Returns the launches by label."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (free_port, init_ranks,
                                         make_serving_mesh)
    want = {r.rid: r for r in base.done}
    order = ("plain", "sharded", "sharded", "plain", "sharded_sync",
             "sharded_eager")
    runs, out = [], {}
    init_ranks(0, 1, port=free_port(), backend="nccl")
    try:
        mesh = make_serving_mesh(1, 1)
        for kind in order:
            w = dataclasses.replace(wl, step_graph=(
                False if kind == "sharded_eager" else None))
            runner, eng = (w.build_engine(model) if kind == "plain" else
                           w.build_engine(
                               model, mesh=mesh,
                               async_admission=kind != "sharded_sync"))
            trace = w.build_trace(model)
            zero_counts()                 # the path starts here
            done, wall, span_ms = timed_run(torch, m, eng, trace)
            launches = {name: fn.launches          # ... and ends here
                        for name, fn in m.kernels.items()}
            label = f"sharded_serve_1x1_{kind}"
            check_path(label, w, runner, eng, m, launches)
            syncs = syncs_per_warm_step(runner)
            if kind != "plain":
                out["sharded_serve_1x1" + kind[len("sharded"):]] = launches
                topo = eng.topology()
                same_served(label, done, want)
                ratio = eng.cache_stats()["block_cache_ratio"]
                if ratio != PARENT_BLOCK_CACHE_RATIO:
                    raise AssertionError(f"{label}: block cache ratio {ratio}")
                graph = kind != "sharded_eager"
                if (runner.step_graph != graph
                        or syncs != (0.0 if graph else float(runner.L))
                        or graph and runner.graphs.replays
                        != runner.impl.step_kinds["warm"]):
                    raise AssertionError(
                        f"{label}: step_graph {runner.step_graph}, {syncs} "
                        f"syncs per warm model step, {runner.graphs.replays}"
                        f" replays of {runner.impl.step_kinds['warm']} warm "
                        "steps")
                if kind != "sharded_sync" and eng.host_syncs != 1:
                    raise AssertionError(f"{label}: {eng.host_syncs} "
                                         "completion fetches in one run")
            runs.append({"kind": kind, "engine_steps": eng.clock,
                         "step_graph": runner.step_graph,
                         "graph_replays": runner.graphs.replays,
                         "policy_syncs_per_warm_model_step": syncs,
                         "wall_ms_per_engine_step": wall / eng.clock * 1e3,
                         "event_ms_per_engine_step": span_ms,
                         "completion_fetches": eng.host_syncs})
            del runner, eng
        prof = path_serve(torch, wl, model, m, None,
                          "sharded_serve_1x1_profiled", mesh=mesh)
        same_served("sharded_serve_1x1_profiled", prof.done, want)
        out["sharded_serve_1x1_profiled"] = prof.launches
    finally:
        dist.destroy_process_group()
    mean = {kind: {k: float(np.mean([r[k] for r in runs
                                     if r["kind"] == kind]))
                   for k in ("wall_ms_per_engine_step",
                             "event_ms_per_engine_step")}
            for kind in ("plain", "sharded", "sharded_eager")}
    emit({"phase": "sharded_serve", "mesh": [1, 1], "topology": topo,
          "requests": len(want), "bitwise_serve": True,
          "async_bitwise_sync": True,
          "block_cache_ratio": PARENT_BLOCK_CACHE_RATIO,
          "policy_syncs_per_warm_model_step": {"graph": 0.0,
                                               "eager": float(base.runner.L)},
          "launches": out["sharded_serve_1x1"], "runs_in_order": runs,
          "mean": mean,
          "sharded_over_plain_wall": (mean["sharded"]["wall_ms_per_engine_step"]
                                      / mean["plain"]
                                      ["wall_ms_per_engine_step"]),
          "eager_over_graph_wall": (
              mean["sharded_eager"]["wall_ms_per_engine_step"]
              / mean["sharded"]["wall_ms_per_engine_step"]),
          "profiled_graph_serve": {
              "wrapper_counts_held": prof.held,
              "launches_per_warm_step": mean_counts(prof.prof),
              "wall_ms_per_warm_step": 1e3 * float(np.mean(prof.walls)),
              "wall_ms_per_warm_step_p50": 1e3 * float(np.median(prof.walls)),
              "graph_replays": prof.runner.graphs.replays},
          "serve_phase_wall_ms_per_engine_step":
              base.wall / base.eng.clock * 1e3, "card": smi()})
    torch.cuda.empty_cache()
    return out


def same_served(label, done, want) -> None:
    """Each finished request's latents and counters bitwise ``want``'s (by
    rid)."""
    for r in done:
        if not np.array_equal(r.latents, want[r.rid].latents):
            raise AssertionError(f"{label} rid={r.rid}: latents differ from "
                                 "the serve phase's")
        if r.cache != want[r.rid].cache:
            raise AssertionError(f"{label} rid={r.rid}: request counters "
                                 f"{r.cache}")


def sharded_launcher(torch) -> None:
    """The launcher's own ``--mesh`` path at full width
    (``serve_diffusion.serve_mesh``: the backend chosen by card count,
    each rank's card, the kernel prebuild, rank 0's summary) for each of
    LAUNCHER_MESH_RUNS, against the single-device launcher
    (``serve_diffusion.serve``) on the same flags in this process: the
    LAUNCHER_EXACT keys equal, the topology the mesh's with the backend
    that the card count calls for, async admission on."""
    from repro_torch.launch import serve_diffusion as launcher
    for label, (mesh_flags, flags) in LAUNCHER_MESH_RUNS.items():
        t0 = time.perf_counter()
        got = launcher.serve_mesh(launcher.parse_args(mesh_flags + flags),
                                  timeout=SHARDED_TIMEOUT_S)
        mesh_s = time.perf_counter() - t0
        want = launcher.serve(launcher.parse_args(flags))
        data, model = (int(v) for v in mesh_flags[1].split(","))
        world = data * model
        topo = {"data": data, "model": model, "devices": world,
                "backend": ("nccl" if torch.cuda.device_count() >= world
                            else "gloo")}
        bad = {k: (got[k], want[k]) for k in LAUNCHER_EXACT
               if got[k] != want[k]}
        if got["topology"] != topo or not got["async_admission"]:
            bad["topology"] = (got["topology"], topo)
        if bad:
            raise AssertionError(f"launcher {label}: mesh != single-device "
                                 f"summary on {bad}")
        emit({"phase": "sharded_serve_launcher", "run": label,
              "flags": mesh_flags + flags, "topology": got["topology"],
              **{k: got[k] for k in LAUNCHER_EXACT},
              "engine_steps_per_s": {"mesh": got["engine_steps_per_s"],
                                     "single": want["engine_steps_per_s"]},
              "mesh_run_s": mesh_s, "card": smi()})


def noise_spread(wl, model, done) -> float:
    """How far a single-device serve's latents move when every request's
    initial noise moves by one part in 2^23: the largest latent_distance
    from ``done``, a serve of ``wl`` on ``model``."""
    eng = wl.build_engine(model)[1]
    noise = eng.noise_fn
    eng.noise_fn = lambda r: noise(r) * (1.0 + 2.0 ** -23)
    moved = eng.run(wl.build_trace(model))
    return max(latent_distance({r.rid: r.latents for r in moved},
                               {r.rid: r for r in done}).values())


def ref_key(wl, sc) -> tuple:
    """(dtype, layers, steps) of the single-device serve that a "served"
    scenario is held to (None: the Workload's)."""
    return sc.get("dtype"), sc.get("num_layers"), sc.get("steps", wl.steps)


def phase_sharded_serve(torch, dev, wl, model, m, base):
    """The serve phase's workload through ShardedDiffusionEngine: (1, 1)
    on nccl in this process, the launcher's --mesh runs, then two ranks
    sharing the card over gloo for each of SHARDED_SCENARIOS (see the
    module docstring, 9h).  Returns each path's launches by label (rank
    0's for two ranks)."""
    from repro_torch.launch.mesh import run_ranks
    out = sharded_one_by_one(torch, wl, model, m, base)
    sharded_launcher(torch)
    chaos = chaos_probe(torch, wl)
    # the single-device serve each "served" scenario is held to, by model,
    # and how far its latents move when its initial noise moves by one
    # part in 2^23
    refs = {(None, None, wl.steps): base.done}
    spread = {(None, None, wl.steps): noise_spread(wl, model, base.done)}
    for sc in (sc for scs in SHARDED_SCENARIOS.values() for sc in scs):
        key = ref_key(wl, sc)
        if sc["name"].startswith("served") and key not in refs:
            wl_sc = dataclasses.replace(wl, steps=key[2])
            cut = sharded_model(torch, wl_sc, *key[:2])
            wl_sc.warm_up(cut)
            refs[key] = wl_sc.build_engine(cut)[1].run(
                wl_sc.build_trace(cut))
            spread[key] = noise_spread(wl_sc, cut, refs[key])
            del cut
            torch.cuda.empty_cache()
    for topo, scenarios in SHARDED_SCENARIOS.items():
        ranks = run_ranks(sharded_rank, 2, (topo, scenarios),
                          timeout=SHARDED_TIMEOUT_S, label=f"mesh {topo}")
        row = {"phase": "sharded_serve", "mesh": list(topo)}
        for sc in scenarios:
            name = sc["name"]
            if name == "block":
                row[name] = [res[name] for res in ranks]
                continue
            if sc.get("kind") == "self_check":
                msgs = [res[name]["raised"] for res in ranks]
                passed = [msg is None for msg in msgs]
                if sc["expect"] == "pass" and not all(passed):
                    raise AssertionError(f"mesh {topo} {name}: the "
                                         f"self-check raised: {msgs}")
                if sc["expect"] == "raise" and not all(
                        msg and "numerics self-check failed" in msg
                        for msg in msgs):
                    raise AssertionError(f"mesh {topo} {name}: the "
                                         f"self-check did not raise: {msgs}")
                row[name] = {"layers": sc.get("num_layers"),
                             "dtype": sc.get("dtype") or str(model.dtype),
                             "atol": sc.get("atol"), "passed": passed,
                             "message": msgs[0]}
                continue
            want = {r.rid: r for r in refs[ref_key(wl, sc)]}
            sched = {rid: (r.admit_step, r.finish_step)
                     for rid, r in want.items()}
            dist_rel = {}
            for res in ranks:
                got = res[name]
                if got["schedule"] != sched:
                    raise AssertionError(f"mesh {topo} {name} rank "
                                         f"{got['rank']}: schedule "
                                         f"{got['schedule']}")
                for lat in got["latents"].values():
                    if not np.isfinite(lat).all():
                        raise AssertionError(f"mesh {topo} {name}: "
                                             "latents not finite")
                for rid, d in latent_distance(got["latents"], want).items():
                    dist_rel[rid] = max(dist_rel.get(rid, 0.0), d)
            worst = max(dist_rel.values())
            bound, bad = sc.get("bound"), bool(sc.get("bad_reduce"))
            if bound is not None and (worst > bound) != bad:
                rule = "must exceed" if bad else "within"
                raise AssertionError(
                    f"mesh {topo} {name}: latents {worst:.3e} of their "
                    f"scale from the single-device serve's ({rule} "
                    f"{bound})")
            out[f"sharded_serve_{topo[0]}x{topo[1]}_{name}"] = \
                ranks[0][name]["launches"]
            row[name] = {
                "layers": sc.get("num_layers") or model.cfg.num_layers,
                "dtype": sc.get("dtype") or str(model.dtype),
                "max_latent_rel": worst, "latent_bound": sc.get("bound"),
                "single_device_noise_spread": spread[ref_key(wl, sc)],
                "ranks": [{k: v for k, v in res[name].items()
                           if k not in ("latents", "schedule")}
                          for res in ranks]}
            # the graph path where the mesh's collectives can be captured:
            # model = 1; model = 2 over gloo stays eager
            paths = {(res[name]["step_graph"], res[name]["step_graph_refusal"])
                     for res in ranks}
            graph, why = paths.pop()
            if paths or graph != (topo[1] == 1) or (
                    not graph and "gloo" not in why):
                raise AssertionError(f"mesh {topo} {name}: step_graph "
                                     f"{graph} ({why}) on some rank")
            row["step_graph"], row["step_graph_refusal"] = graph, why
        if topo[1] > 1:
            row["chaos_f32_per_layer"] = chaos
        row["serve_phase_wall_ms_per_engine_step"] = \
            base.wall / base.eng.clock * 1e3
        row["card"] = smi()
        emit(row)
    return out


# the (b) probe: a toy stack of PROBE_LAYERS blocks, each a (PROBE_ROWS,
# 256, 1152) f32 product all-reduced over the model group, skipped when
# every row caches; integer-valued inputs keep every sum exact, so a
# replay must equal the eager step bitwise whatever kernels the capture
# chooses.  The masks: every row caching in every layer, one layer
# computed (its mask mixed), every layer computed
PROBE_LAYERS = 2
PROBE_ROWS = 8
PROBE_MASKS = {"all_cache": [[True] * PROBE_ROWS] * PROBE_LAYERS,
               "mixed": [[True] * PROBE_ROWS,
                         [True] * (PROBE_ROWS - 1) + [False]],
               "none_cache": [[False] * PROBE_ROWS] * PROBE_LAYERS}


def model_group_probe(torch) -> dict:
    """A one-rank nccl world on the card in this process: it stands in,
    here only, as a ``ShardingCtx``'s model group, so that
    ``step_graph.branch`` takes its model-group path: the
    agreement all-reduce on the capturing stream feeding the IF nodes,
    whose bodies all-reduce (``models.dit.tp_all_reduce``).  The toy stack
    (PROBE_*) is stepped eagerly and captured (``StepGraph``), twice: with
    the bodies' all-reduce and without, whose bodies' node counts by type
    differ by what NCCL put in a body.  Each mask is replayed under sync
    debug "error" and held to the eager step bitwise.  A capture that
    fails is this probe's finding: its error text is returned."""
    import torch.distributed as dist
    from repro_torch.core import step_graph
    from repro_torch.cuda_kernels.cond_node import if_all
    from repro_torch.distributed.sharding import (ShardingCtx, make_rules,
                                                  use_sharding)
    from repro_torch.launch.mesh import (free_port, init_ranks,
                                         make_serving_mesh)
    from repro_torch.models.dit import tp_all_reduce
    init_ranks(0, 1, port=free_port(), backend="nccl")

    class OneRankModelGroup(ShardingCtx):
        def group(self, axis):
            return dist.group.WORLD if axis == "model" else super().group(axis)

    ctx = OneRankModelGroup(make_serving_mesh(1, 1), make_rules("serve"))
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    x = torch.randint(-4, 5, (PROBE_ROWS, 256, 1152), generator=gen,
                      device=dev).float()
    ws = [torch.randint(-1, 2, (1152, 1152), generator=gen,
                        device=dev).float() for _ in range(PROBE_LAYERS)]
    masks = {k: torch.tensor(v, device=dev) for k, v in PROBE_MASKS.items()}
    reads = []

    def stack(reduce):
        def step(xin, every):
            y = xin.clone()
            for i, w in enumerate(ws):
                def compute(w=w, m=every[i]):
                    h = torch.matmul(y, w)
                    if reduce:
                        h = tp_all_reduce(h)
                    y.copy_(torch.where(m[:, None, None], y, y + h))
                reads.append(step_graph.branch(every[i], compute))
            return y
        return step

    out = {"refusal": step_graph.capture_refusal(ctx, dev),
           "backend": dist.get_backend(), "body_nodes": {},
           "capture_reads": 0}
    with use_sharding(ctx=ctx):
        eager = {k: stack(True)(x, m).clone() for k, m in masks.items()}
        out["eager_reads_per_step"] = sum(reads) / len(masks)
        for reduce in (False, True):
            del reads[:]
            try:
                g = step_graph.StepGraph(stack(reduce), (x, masks["mixed"]),
                                         ())
            except RuntimeError as e:
                # the communicator is left as the failed capture left it:
                # no teardown that could wait on it
                out.update(captured=False, error=str(e),
                           with_all_reduce=reduce)
                return out
            out["body_nodes"][f"all_reduce_{reduce}"] = dict(
                if_all.body_nodes)
            out["capture_reads"] += sum(reads)
        same, worst = {}, {}
        for k, m in masks.items():
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = g.replay((x, m))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            same[k] = bool(torch.equal(got, eager[k]))
            worst[k] = float((got - eager[k]).abs().max())
        _, names, counts = host_launches(torch, lambda: g.replay(
            (x, masks["none_cache"])))
    out.update(captured=True, replays_bitwise=same,
               replay_max_abs_diff=worst, replay_kernels=dict(names),
               nccl_kernels_in_replay=sum(n for k, n in names.items()
                                          if "nccl" in k),
               replay_host_launches=counts)
    dist.destroy_process_group()
    return out


def phase_model_group_probe(torch) -> dict:
    """C2(b) on the one card (model_group_probe).  The capture either
    holds (every mask's replay bitwise the eager step, no host read) and
    the construction rule admits an nccl model group, or it fails and the
    rule refuses it; anything else fails."""
    t0 = time.perf_counter()
    res = model_group_probe(torch)
    res["seconds"] = time.perf_counter() - t0
    emit({"phase": "model_group_probe", "layers": PROBE_LAYERS,
          "rows": PROBE_ROWS, **res, "card": smi()})
    if res["captured"]:
        if (not all(res["replays_bitwise"].values())
                or res["capture_reads"] != 0
                or res["eager_reads_per_step"] != PROBE_LAYERS):
            raise AssertionError(f"model group probe: {res}")
        if res["refusal"] is not None:
            raise AssertionError("model group probe: the capture holds but "
                                 f"the rule refuses nccl: {res['refusal']}")
    elif res["refusal"] is None:
        raise AssertionError("model group probe: the capture failed "
                             f"({res['error']}) but the rule admits nccl")
    return res


def phase_llm_sampled(torch, dev, wl, model, serve):
    """greedy=False: each request's first token drawn from its prefill's
    logits (torch.Generator seeded by rid); every request finishes."""
    summary, eng, done = serve(dataclasses.replace(wl, greedy=False), model)
    vocab = model.cfg.vocab_size
    if len(done) != wl.requests or any(
            len(r.generated) != wl.new_tokens
            or not all(0 <= t < vocab for t in r.generated) for r in done):
        raise AssertionError("sampled serve: unfinished or bad tokens")
    emit({"phase": "llm_sampled", **summary})
    return done


# --------------------------------------------------------------------------
# Training and checkpoints
# --------------------------------------------------------------------------

# DiT-XL/2 at full width: batch 32 of latent_stream (seed 0), the config's
# optimizer (AdamW, the reference's defaults) on cosine_schedule(3e-4, 5,
# 30), remat on; steps 0-2 warm up, step 3 runs under sync debug "error",
# steps 4-28 are timed, step 29 is profiled
TRAIN_DIT = dict(arch="dit-xl2", batch=32, steps=30, lr=3e-4, warmup=5,
                 seed=0, warm=3)
# Qwen3-0.6B at full width: the launcher's batch 8 and seq 256, 5 steps on
# token_stream batches drawn before the phase (seed 0): step 0 warms up,
# step 1 runs under sync debug "error", steps 2-3 are timed, 4 profiled
TRAIN_LLM = dict(arch="qwen3-0.6b", batch=8, seq=256, steps=5, lr=3e-4,
                 warmup=20, seed=0)
TRAIN_LOG_EVERY = 10        # train()'s log steps: 0, 10, 20 and the last
TRAINED_SERVE_REQUESTS = 4  # the trained DiT served under fastcache


def dit_train_flops(cfg, batch: int) -> float:
    """Model FLOPs of one DiT train step: 2*m*n*k per product (attention's
    two included, the conditioning's per sample), times 3 for forward and
    backward; remat's recompute left out."""
    d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
    hd = cfg.num_heads * cfg.resolved_head_dim
    dit = cfg.dit
    n = (dit.image_size // dit.patch_size) ** 2
    pd = dit.patch_size ** 2 * dit.in_channels
    out = pd * (2 if dit.learn_sigma else 1)
    block = (2 * d * 6 * d + 2 * n * d * 3 * hd + 4 * n * n * hd
             + 2 * n * hd * d + 4 * n * d * f)
    per_sample = (2 * n * pd * d + 2 * 256 * d + 2 * d * d + L * block
                  + 2 * d * 2 * d + 2 * n * d * out)
    return 3.0 * batch * per_sample


def llm_train_flops(cfg, batch: int, seq: int) -> float:
    """Model FLOPs of one LM train step, as dit_train_flops counts them;
    attention's products over all S x S pairs (the direct attention
    computes the masked half too), the vocabulary head included."""
    d, L, f, v = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    q = cfg.num_heads * cfg.resolved_head_dim
    kv = cfg.num_kv_heads * cfg.resolved_head_dim
    per_token = L * (2 * d * q + 4 * d * kv + 2 * q * d + 6 * d * f) \
        + 2 * d * v
    attn = L * 4 * seq * seq * q
    return 3.0 * batch * (seq * per_token + attn)


def all_grads_nonzero(torch, model) -> list:
    """Names of the parameters whose gradient is all zero (one read)."""
    named = list(model.named_parameters())
    peaks = torch.stack([p.grad.detach().abs().amax().float()
                         for _, p in named]).cpu()
    return [n for (n, _), v in zip(named, peaks.tolist()) if v == 0.0]


def run_training(torch, dev, model, tr, batches, lr_fn, *, warm: int,
                 sync_step: int, profile_step: int, label: str, m):
    """Train ``model`` on ``batches`` through make_train_step, every
    kernel's launch count zeroed just before and read just after (no kernel
    lies on the training path).  Step ``sync_step`` runs under sync debug
    "error", ``profile_step`` under torch.profiler (its kernels and
    copies); the other steps from ``warm`` on are timed with CUDA events
    at the step's phase boundaries.  Returns (params, state, losses,
    timing, launches)."""
    params = tr.loop.param_tree(model)
    opt = tr.optimizer.make_optimizer(model.cfg.optimizer)
    state = opt.init(params)
    step_fn = tr.loop.make_train_step(model, opt, lr_fn)
    steps = len(batches)
    events = {i: [torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for i in range(warm, steps) if i not in (sync_step,
                                                       profile_step)}
    losses, per_step = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                         # the path starts here
    for i, batch in enumerate(batches):
        if i == sync_step:
            torch.cuda.set_sync_debug_mode("error")
            try:
                params, state, met = step_fn(params, state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        elif i == profile_step:
            def one():
                return step_fn(params, state, batch)
            (params, state, met), prof = profiled_step(torch, one)
            per_step["launches"] = prof
        else:
            params, state, met = step_fn(params, state, batch,
                                         events=events.get(i))
        losses.append(met["loss"])
    torch.cuda.synchronize()
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    if any(launches.values()):
        raise AssertionError(f"{label}: kernels launched in training "
                             f"{launches}: none lies on its path")
    split = {k: [] for k in ("step", "forward", "backward", "update")}
    for ev in events.values():
        split["step"].append(ev[0].elapsed_time(ev[3]))
        split["forward"].append(ev[0].elapsed_time(ev[1]))
        split["backward"].append(ev[1].elapsed_time(ev[2]))
        split["update"].append(ev[2].elapsed_time(ev[3]))
    timing = {f"{k}_ms": float(np.mean(v)) for k, v in split.items()}
    kernels, copies, busy_ms, wall_ms = per_step["launches"]
    timing.update(timed_steps=len(events), launches_per_step=kernels,
                  copies_per_step=copies, profiled_device_ms=busy_ms,
                  profiled_wall_ms=wall_ms,
                  profiled_busy_share=busy_ms / wall_ms,
                  max_memory_allocated_bytes=peak)
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses not finite {losses}")
    return params, state, losses, timing, launches


def profiled_step(torch, fn):
    """``fn()`` once under torch.profiler: (its result, (kernels, copies,
    the device ms they took, the step's wall ms))."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = sum(1 for e in events if "emcpy" not in e.name)
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    return out, (kernels, len(events) - kernels, busy, wall)


def phase_train_dit(torch, dev, tr, m):
    """train_dit: DiT-XL/2 at full width from the reference's initializers
    (adaLN-zero, as the launcher's model.init), TRAIN_DIT.  Checks: every
    loss finite and the last logged one below the first; every parameter
    with a nonzero gradient at the last step; the sync-debug step clean;
    no kernel (flash_attention included) launched."""
    c = TRAIN_DIT
    cfg = tr.get_config(c["arch"])
    t0 = time.perf_counter()
    model = tr.init_model(cfg, dev, c["seed"])
    it = tr.latent_stream(c["batch"], cfg.dit.image_size,
                          cfg.dit.in_channels,
                          num_classes=cfg.dit.num_classes, seed=c["seed"],
                          device=dev)
    batches = [next(it) for _ in range(c["steps"])]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lr_fn = tr.optimizer.cosine_schedule(c["lr"], c["warmup"], c["steps"])
    params, state, losses, timing, launches = run_training(
        torch, dev, model, tr, batches, lr_fn, warm=c["warm"],
        sync_step=c["warm"], profile_step=c["steps"] - 1, label="train_dit",
        m=m)
    logged = [i for i in range(c["steps"])
              if i % TRAIN_LOG_EVERY == 0 or i == c["steps"] - 1]
    if not losses[logged[-1]] < losses[logged[0]]:
        raise AssertionError(f"train_dit: last logged loss "
                             f"{losses[logged[-1]]} not below the first "
                             f"{losses[logged[0]]}")
    zero = all_grads_nonzero(torch, model)
    if zero:
        raise AssertionError(f"train_dit: no gradient at step "
                             f"{c['steps']} for {zero}")
    step_s = timing["step_ms"] / 1e3
    flops = dit_train_flops(cfg, c["batch"])
    emit({"phase": "train_dit", **c, "arch": cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "dtype": cfg.dtype, "optimizer": cfg.optimizer, "remat": cfg.remat,
          "setup_s": setup_s, "losses": losses.tolist(),
          "logged_losses": {i: float(losses[i]) for i in logged},
          "samples_per_s": c["batch"] / step_s,
          "tokens_per_s": c["batch"] * model.num_tokens / step_s,
          "model_flops_per_step": flops,
          "train_mfu": flops / step_s / BF16_TC_FLOPS_PER_S, **timing,
          "sync_debug_step": c["warm"], "launches": launches,
          "card": smi()})
    return model, params, state, launches


def phase_train_llm(torch, dev, tr, m):
    """train_llm: Qwen3-0.6B at full width, TRAIN_LLM.  Checks: the losses
    finite, the first within 10% of ln(vocab); the sync-debug step clean;
    no kernel (flash_attention included) launched."""
    c = TRAIN_LLM
    cfg = tr.get_config(c["arch"])
    t0 = time.perf_counter()
    it = tr.token_stream(cfg.vocab_size, c["batch"], c["seq"],
                         seed=c["seed"], device=dev)
    batches = [next(it) for _ in range(c["steps"])]
    draw_s = time.perf_counter() - t0
    model = tr.init_model(cfg, dev, c["seed"])
    lr_fn = tr.optimizer.cosine_schedule(c["lr"], c["warmup"], c["steps"])
    _, _, losses, timing, launches = run_training(
        torch, dev, model, tr, batches, lr_fn, warm=1, sync_step=1,
        profile_step=c["steps"] - 1, label="train_llm", m=m)
    ln_v = float(np.log(cfg.vocab_size))
    if abs(losses[0] - ln_v) > 0.1 * ln_v:
        raise AssertionError(f"train_llm: first loss {losses[0]} not within "
                             f"10% of ln(vocab) {ln_v}")
    step_s = timing["step_ms"] / 1e3
    flops = llm_train_flops(cfg, c["batch"], c["seq"])
    emit({"phase": "train_llm", **c, "arch": cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "dtype": cfg.dtype, "optimizer": cfg.optimizer, "remat": cfg.remat,
          "batch_draw_s": draw_s, "losses": losses.tolist(),
          "ln_vocab": ln_v, "tokens_per_s": c["batch"] * c["seq"] / step_s,
          "model_flops_per_step": flops,
          "train_mfu": flops / step_s / BF16_TC_FLOPS_PER_S, **timing,
          "launches": launches, "card": smi()})
    return launches


# the SSM and hybrid families' training at full width: xLSTM-1.3b cut to
# two of its six periods (16 layers; at 48 the phase's xLSTM part took 65.8
# s, see XLSTM) with its config's AdamW, 4 x 256 tokens; Jamba at full
# width cut to one period of 8 layers (13.30 B parameters) with its
# config's Adafactor, 1 x 512 tokens; 3 steps each on token_stream batches
# drawn before the phase (seed 0): step 0 under sync debug "error", step 1
# timed, step 2 profiled
TRAIN_SSM = (dict(arch="xlstm-1.3b", num_layers=16, batch=4, seq=256,
                  steps=3, lr=3e-4, warmup=20, seed=0),
             dict(arch="jamba-v0.1-52b", num_layers=8, batch=1, seq=512,
                  steps=3, lr=3e-4, warmup=20, seed=0))


def active_params(model) -> int:
    """Parameters a token passes through: all but the embedding table
    (a lookup) and, in an MoE layer, the experts it is not routed to
    (top_k of num_experts of each expert bank)."""
    cfg, n = model.cfg, 0
    for name, p in model.named_parameters():
        if name == "top.embed" and not cfg.tie_embeddings:
            continue
        share = 1.0
        if ".moe.we_" in name:
            share = cfg.moe.top_k / cfg.moe.num_experts
        n += int(p.numel() * share)
    return n


def phase_train_ssm(torch, dev, tr, m) -> dict:
    """train_ssm: each of TRAIN_SSM through launch/train.py's model and
    stream (``init_model``, ``data_for``) and make_train_step, built,
    trained and freed in turn.  Checks: every loss finite; the sync-debug
    step clean; no kernel launched (the path is plain PyTorch, as the
    reference's is plain jnp); every parameter with a nonzero gradient.
    Prints ms per step and its split, tokens/s, model FLOPs (6 x active
    parameters x tokens: the scans', attention's and the gates' sequence
    work left out) and train_mfu, launches, busy share, peak memory.
    Returns {label: launches}."""
    free_memory(torch)
    out = {}
    for c in TRAIN_SSM:
        t0 = time.perf_counter()
        cfg = tr.get_config(c["arch"])
        if "num_layers" in c:
            cfg = cfg.replace(num_layers=c["num_layers"])
        it = tr.data_for(cfg, c["batch"], c["seq"], c["seed"], dev)
        batches = [next(it) for _ in range(c["steps"])]
        model = tr.init_model(cfg, dev, c["seed"])
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        lr_fn = tr.optimizer.cosine_schedule(c["lr"], c["warmup"],
                                             c["steps"])
        tag = c["arch"].split("-")[0]
        # the trained parameters and the optimizer state are dropped here,
        # so that the next model has the card
        losses, timing, launches = run_training(
            torch, dev, model, tr, batches, lr_fn, warm=1, sync_step=0,
            profile_step=c["steps"] - 1, label=f"train_{tag}", m=m)[2:]
        zero = all_grads_nonzero(torch, model)
        if zero:
            raise AssertionError(f"train_{tag}: no gradient for {zero}")
        step_s = timing["step_ms"] / 1e3
        tokens = c["batch"] * c["seq"]
        flops = 6.0 * active_params(model) * tokens
        emit({"phase": "train_ssm", **c, "arch": cfg.name,
              "num_layers": cfg.num_layers,
              "params": sum(p.numel() for p in model.parameters()),
              "param_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
              "dtype": cfg.dtype, "optimizer": cfg.optimizer,
              "remat": cfg.remat, "setup_s": setup_s,
              "losses": losses.tolist(),
              "ln_vocab": float(np.log(cfg.vocab_size)),
              "tokens_per_s": tokens / step_s,
              "model_flops_per_step": flops,
              "train_mfu": flops / step_s / BF16_TC_FLOPS_PER_S, **timing,
              "sync_debug_step": 0, "launches": launches,
              "seconds": time.perf_counter() - t0, "card": smi()})
        out[f"train_{tag}"] = launches
        del model
        free_memory(torch)
    return out


# LLM training on a mesh (training/sharded.py): Qwen3-0.6B whole with
# TRAIN_LLM's batch, seed and schedule for 2 steps on (1, 1) over nccl in
# this process, then on two ranks sharing card 0 over gloo as (2, 1) (FSDP)
# and (1, 2) (tensor parallel); Arctic-480B at full width with one layer
# (Adafactor, 1 x 256 tokens) for 2 steps on (1, 1), then on (1, 2) with
# 64 experts a rank.  The three two-rank legs run in one pair of processes
# (one spawn and one warm-up of each rank)
SHARDED_TRAIN = (
    dict(label="qwen", arch="qwen3-0.6b", batch=8, seq=256, steps=2,
         lr=3e-4, warmup=20, seed=0, meshes=((2, 1), (1, 2))),
    dict(label="arctic", arch="arctic-480b", num_layers=1, batch=1, seq=256,
         steps=2, lr=3e-4, warmup=20, seed=0, meshes=((1, 2),)))
SHARDED_LOSS_RTOL = 1e-3      # a mesh's step-0 loss against (1, 1)'s
SHARDED_GRAD_REL_L2 = 5e-2    # its gathered step-0 gradients, bf16
# a config without qk-norm, at the reference's random init, carries
# activations of ~60-100 into saturated softmaxes (attention's and the
# router's): one-ulp changes of q and k (a rank's GEMM on its heads rounds
# otherwise) move its bf16 gradients by percents.  Arctic's (1, 2) step-0
# gradients read 5.44% rel L2, 6.25% on the worst leaf (the expert banks),
# where its (1, 1) step moves 4.58%, and 7.86% on the worst leaf (the
# router), when only q, k, v are rounded once from f32 (qkv_in_f32), all
# on an H100 80GB HBM3 at 700 W: its bound is fixed at about that worst
# leaf's spread, which each run prints beside it (floor_f32_qkv)
SHARDED_CHAOTIC_GRAD_REL_L2 = {"arctic": 0.1}
# the SSM and hybrid families on a mesh (sharded_ssm): xLSTM's period of 8
# layers (7 mLSTM, 1 sLSTM) at full width, 2 x 256 so that data = 2 splits
# it, and Jamba at full width, 1 x 512, two steps each; held as
# SHARDED_TRAIN's legs, in f32.  In bf16 their step-0 gradients are
# chaotic at random init: xLSTM's period on (1, 2) read 40.7% rel L2 off
# (1, 1)'s (203% on the first mLSTM's b_igate) where its own (1, 1) step
# moves 57.1% (172% on its worst leaf) when its products are rounded once
# from f32 (an NVIDIA H100 80GB HBM3 at 700 W; gradient norm 520 before
# clipping).  In f32 each leaf is held to SHARDED_F32_GRAD_REL_L2, the
# (1, 1) step's spread with its products rounded once from f64 printed
# beside it.  Jamba in f32 holds the first four layers of its period
# (three Mamba mixers, the attention layer, two MoE layers of 16
# experts): the eight at f32 are 53 GB of parameters before their
# gradients
SHARDED_F32_GRAD_REL_L2 = 1e-2
SHARDED_SSM = (
    dict(label="xlstm", arch="xlstm-1.3b", num_layers=8, batch=2, seq=256,
         steps=2, lr=3e-4, warmup=20, seed=0, meshes=((1, 2), (2, 1)),
         phase="sharded_ssm", dtype="float32"),
    dict(label="jamba", arch="jamba-v0.1-52b", num_layers=4, batch=1,
         seq=512, steps=2, lr=3e-4, warmup=20, seed=0, meshes=((1, 2),),
         phase="sharded_ssm", dtype="float32"))
# sharded prefill / decode (sharded_infer): Qwen3-0.6B whole, a prefill of
# 4 x 512 then 8 teacher-forced decode steps on (1, 2) and (2, 1); Jamba's
# and xLSTM's periods at full width, 1 x 256 then 4 steps on (1, 2); every
# step's logits within SHARDED_INFER_REL_L2 (the bf16 prefill bound) of
# the same run on one device (none of the three is in PREFILL_CHAOTIC)
SHARDED_INFER = (
    dict(label="qwen", arch="qwen3-0.6b", batch=4, seq=512, steps=8,
         window=1024, seed=0, meshes=((1, 2), (2, 1))),
    dict(label="jamba", arch="jamba-v0.1-52b", num_layers=8, batch=1,
         seq=256, steps=4, window=1024, seed=0, meshes=((1, 2),)),
    dict(label="xlstm", arch="xlstm-1.3b", num_layers=8, batch=1, seq=256,
         steps=4, window=1024, seed=0, meshes=((1, 2),)))
SHARDED_INFER_REL_L2 = 2e-2
SHARDED_INFER_TIMEOUT_S = 600
# the legs whose one-device run is chaotic at random init: its logits move
# past SHARDED_INFER_REL_L2 when its products are summed in another order
# (qkv_in_f32(products=True), the floor each run prints).  On an NVIDIA
# H100 80GB HBM3 at 700 W Jamba's period (no qk-norm, four routers of 16
# experts, the Mamba states) read a floor of 23.8% on the prefill and 33-50%
# on the decode steps, xLSTM's (the exponential gates' running maxima)
# 24.0% and 21-23%, where Qwen3-0.6B reads 0.79%.  These legs are held
# layer by layer: each layer of the sharded model on the one-device run's
# own input to that layer (and, in a decode step, its cache before the
# step), the layer's update (output minus input) within
# SHARDED_INFER_REL_L2 of the one-device layer's.  Any other leg whose
# floor reaches the bound fails the run.
SHARDED_INFER_CHAOTIC = ("jamba", "xlstm")
SHARDED_TRAIN_TIMEOUT_S = 900  # both ranks, every leg, start to result
# the reckoning of Arctic's one-layer step on (1, 1) before any card run:
# parameters, Adafactor's state and the batch (the dry run's 28.18 GB),
# their bf16 gradients again, one 8.93 GB expert-bank gradient in flight
ARCTIC_PEAK_RECKONING_GB = (66.0, 68.0)
LAUNCHER_LINE = (r"\[train\] step +\d+ loss=[\d.]+ lr=[\d.e+-]+ "
                 r"\|g\|=[\d.]+ \([\d.]+s\)")


def sharded_cfg(tr, c):
    cfg = tr.get_config(c["arch"])
    if "num_layers" in c:
        # fewer layers than a period: the period's first ones
        pattern = cfg.block_pattern[:c["num_layers"]]
        cfg = cfg.replace(num_layers=c["num_layers"], block_pattern=pattern)
    if "dtype" in c:
        cfg = cfg.replace(dtype=c["dtype"])
    return cfg


def sharded_batches(tr, cfg, c) -> list:
    """The leg's global batches as host arrays (token_stream, seed 0)."""
    it = tr.token_stream(cfg.vocab_size, c["batch"], c["seq"],
                         seed=c["seed"], device="cpu")
    return [next(it)["tokens"].numpy() for _ in range(c["steps"])]


def train_leg(torch, dev, c, step_fn, params, state, batches, m, counter):
    """Run ``step_fn`` on ``batches`` (on the card), every kernel count
    zeroed just before and read just after; each step timed with CUDA
    events, its collective bytes read from ``counter`` (its mesh's).
    Returns (params, state, per step [loss, ms, bytes], step-0 metrics,
    launches, peak bytes)."""
    from repro_torch.training.loop import host_metrics
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()                         # the path starts here
    steps, met0 = [], None
    for i, b in enumerate(batches):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        counter.reset()
        ev[0].record()
        params, state, met = step_fn(params, state, b)
        ev[1].record()
        torch.cuda.synchronize()
        steps.append({"loss": float(met["loss"]),
                      "ms": ev[0].elapsed_time(ev[1]),
                      "collective_bytes": counter.read()})
        if i == 0:
            met0 = host_metrics(met)
    launches = {name: fn.launches                  # ... and ends here
                for name, fn in m.kernels.items()}
    if any(launches.values()):
        raise AssertionError(f"sharded_train {c['label']}: kernels launched "
                             f"{launches}: none lies on its path")
    return (params, state, steps, met0, launches,
            torch.cuda.max_memory_allocated(dev))


def chunks(shape, budget: int = 1 << 26):
    """Index tuples cutting a tensor of ``shape`` along its first dims into
    pieces of at most ``budget`` elements (one row of the last dims
    whole), so that a comparison holds little more than its operands."""
    import math
    for d in range(len(shape)):
        if math.prod(shape[d + 1:]) <= budget:
            step = max(1, budget // max(1, math.prod(shape[d + 1:])))
            break
    else:
        d, step = len(shape) - 1, 1
    for lead in np.ndindex(*shape[:d]):
        for i in range(0, shape[d] if shape else 1, step):
            yield tuple(lead) + (slice(i, i + step),) if shape else ()


def rel_l2_sums(torch, dev, got, want, sl_iter) -> tuple:
    """(||got - want||^2, ||want||^2) over the chunks ``sl_iter`` (each on
    the host or the card)."""
    d2 = r2 = 0.0
    for sl in sl_iter:
        w = want[sl].to(dev).float()
        diff = got[sl].to(dev).float() - w
        d2 += float(diff.square().sum())
        r2 += float(w.square().sum())
        del w, diff
    return d2, r2


@contextlib.contextmanager
def qkv_in_f32(torch, common, products: bool = False):
    """The attention's q, k, v projections computed on f32 operands (f64
    for an f32 model) and rounded once: the same products summed in
    another order, as a GEMM of another shape (a tensor-parallel rank's,
    on its heads) sums them.  With ``products`` every ``common.fdot`` too
    (the mixers' projections, which a rank sums as row-parallel partial
    products)."""
    real, real_dot = common.feinsum, common.fdot

    def wide(x):
        return x.to(torch.float64 if x.dtype == torch.float32
                    else torch.float32)

    def feinsum(eq, *xs):
        if eq == "bsd,dhk->bshk":
            return torch.einsum(eq, *map(wide, xs)).to(xs[0].dtype)
        return real(eq, *xs)

    def fdot(a, b):
        return torch.matmul(wide(a), wide(b.to(a.dtype))).to(a.dtype)

    common.feinsum = feinsum
    if products:
        common.fdot = fdot
    try:
        yield
    finally:
        common.feinsum, common.fdot = real, real_dot


def sharded_leg(torch, dist, rank, world, c, topo, want, m):
    """One leg on this rank's (data, model) mesh of the two ranks: its
    blocks of the weights ``init_model`` draws (``init_sharded``), its rows
    of the leg's global batches, ``c["steps"]`` sharded steps (train_leg),
    every step's collective bytes equal to ``want`` (the dry run's).  Then
    the (1, 1) references: rank 0 receives every rank's distinct step-0
    blocks on its host (over gloo), the others' card memory freed, and
    holds them against ``sharded_reference``'s."""
    import gc
    from repro_torch import tree as tree_mod
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import rows_of
    from repro_torch.distributed.sharding import _as_tuple, block_view
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import def_leaves
    from repro_torch.training import loop, optimizer, sharded
    dev = torch.device("cuda", 0)
    cfg = sharded_cfg(SimpleNamespace(get_config=get_config), c)
    mesh = sharded.train_mesh(make_mesh(*topo), "gloo", c["batch"])
    t0 = time.perf_counter()
    model = sharded.init_sharded(cfg, dev, c["seed"], mesh)
    params = loop.param_tree(model)
    opt = optimizer.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    lr_fn = optimizer.cosine_schedule(c["lr"], c["warmup"], c["steps"])
    step = sharded.make_sharded_train_step(model, opt, lr_fn, mesh)
    rows = rows_of(c["batch"], sharded.data_shard(mesh))
    batches = [{"tokens": torch.from_numpy(b[rows].copy()).to(dev)}
               for b in c["global_batches"]]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    held = {}

    def step_and_keep(p, s, b):
        out = step(p, s, b)
        if not held:                    # step 0's blocks, to the host
            held["grads"] = [g.detach().to("cpu", copy=True)
                             for g in tree_mod.leaves(step.grads)]
        return out

    params, state, steps, met0, launches, peak = train_leg(
        torch, dev, c, step_and_keep, params, state, batches, m,
        mesh.counter)
    for i, s in enumerate(steps):
        if s["collective_bytes"] != want:
            raise AssertionError(
                f"sharded_train {c['label']} {topo} rank {rank} step {i}: "
                f"collective bytes {s['collective_bytes']} != the dry "
                f"run's {want}")
    specs = sharded.spec_leaves(sharded.leaf_specs(model, mesh))
    c_shapes = [tuple(d.shape) for d in def_leaves(model.param_defs())]
    coords = mesh.coords
    del model, params, state, step, opt
    gc.collect()
    torch.cuda.empty_cache()
    out = {"rank": rank, "coords": coords, "setup_s": setup_s,
           "steps": steps, "metrics_step0": met0, "launches": launches,
           "max_memory_allocated_bytes": peak}
    every = [None] * world
    dist.all_gather_object(every, coords)
    if rank == 0:
        # every rank's distinct blocks on this host, then the references
        blocks = [[] for _ in specs]
        for li, spec in enumerate(specs):
            cut = {a for e in spec for a in _as_tuple(e)}
            for r in range(world):
                got = held["grads"][li]
                if r:
                    got = torch.empty(block_view(
                        torch.empty(c_shapes[li], device="meta"), spec,
                        every[r], mesh.extents).shape,
                        dtype=got.dtype)
                    dist.recv(got, src=r)
                if not any(every[r][a] for a in every[r] if a not in cut):
                    blocks[li].append((r, got))
        del held
        out.update(sharded_reference(torch, dev, cfg, c, specs, every,
                                     mesh.extents, blocks))
    else:
        for g in held["grads"]:
            dist.send(g, dst=0)
        del held
    dist.barrier()
    return out


def sharded_reference(torch, dev, cfg, c, specs, every, extents,
                      blocks) -> dict:
    """Rank 0's (1, 1) reference of a leg's step-0 gradients: the whole
    model on one device from ``init_model``'s weights and the whole batch,
    clipped (``make_train_step``'s code); the ranks' ``blocks`` against it
    in relative L2 by leaf.  Then its own spread under rounding: the same
    step with q, k, v rounded once from f32 (``qkv_in_f32``) against it,
    on whole leaves (the ranks' blocks dropped first, the reference's
    gradients held on the host meanwhile)."""
    import gc
    from repro_torch import tree as tree_mod
    from repro_torch.distributed.sharding import block_view
    from repro_torch.launch.train import init_model
    from repro_torch.models import common
    from repro_torch.training import loop, optimizer
    t0 = time.perf_counter()
    ref = init_model(cfg, dev, c["seed"])
    loop.param_tree(ref)
    grads = loop.grad_tree(ref)
    full = {"tokens": torch.from_numpy(c["global_batches"][0]).to(dev)}
    paths = [tree_mod.keystr(p) for p, _ in
             tree_mod.flatten_with_path(grads)]

    def grads_of():
        torch._foreach_zero_(tree_mod.leaves(grads))
        loss, _ = ref.loss(full)
        loss.backward()
        optimizer.clip_by_global_norm(grads, 1.0)
        return float(loss.detach())

    out = {"reference_loss": grads_of()}
    by_leaf, num, den = {}, 0.0, 0.0
    for li, (g, spec) in enumerate(zip(tree_mod.leaves(grads), specs)):
        d2 = r2 = 0.0
        for r, got in blocks[li]:
            blk = block_view(g, spec, every[r], extents)
            a, b = rel_l2_sums(torch, dev, got, blk, chunks(blk.shape))
            d2, r2 = d2 + a, r2 + b
        by_leaf[paths[li]] = (d2 / r2) ** 0.5 if r2 else 0.0
        num, den = num + d2, den + r2
    out["grad_rel_l2_by_leaf"] = by_leaf
    out["grad_rel_l2"] = (num / den) ** 0.5
    blocks.clear()
    kept = [g.to("cpu", copy=True) for g in tree_mod.leaves(grads)]
    with qkv_in_f32(torch, common, products=cfg.family in ("ssm",
                                                           "hybrid")):
        out["f32_qkv_loss"] = grads_of()
    floor, num, den = {}, 0.0, 0.0
    for path, k, g in zip(paths, kept, tree_mod.leaves(grads)):
        a, b = rel_l2_sums(torch, dev, g, k, chunks(tuple(k.shape)))
        floor[path] = (a / b) ** 0.5 if b else 0.0
        num, den = num + a, den + b
    floor["all"] = (num / den) ** 0.5 if den else 0.0
    out["floor_f32_qkv"] = floor
    out["reference_s"] = time.perf_counter() - t0
    del ref, grads, kept
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_train_ranks(rank, world, port, legs):
    """Two ranks sharing card 0 over gloo (a ``launch.mesh.RankGroup``
    target), running each of ``legs`` ((c, topo, want) of SHARDED_TRAIN's
    two-rank meshes) in turn (sharded_leg).  Returns this rank's results
    by leg."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)
    from repro_torch.launch.mesh import init_ranks
    m = SimpleNamespace(kernels=kernel_wrappers())
    init_ranks(rank, world, port=port, backend="gloo")
    try:
        return [sharded_leg(torch, dist, rank, world, c, topo, want, m)
                for c, topo, want in legs]
    finally:
        dist.destroy_process_group()


def one_by_one_leg(torch, dev, tr, m, c, cfg, plain: bool):
    """(1, 1) in this process: ``init_sharded`` + ``make_sharded_train_step``
    on a one-rank nccl mesh, or (``plain``) ``init_model`` +
    ``make_train_step``.  Returns (train_leg's steps, step-0 metrics,
    launches, peak, step-0 gradients and final parameters (Qwen's))."""
    from repro_torch.distributed.collectives import Counter
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import sharded
    free_memory(torch)
    lr_fn = tr.optimizer.cosine_schedule(c["lr"], c["warmup"], c["steps"])
    opt = tr.optimizer.make_optimizer(cfg.optimizer)
    if plain:
        model = tr.init_model(cfg, dev, c["seed"])
        counter = Counter()
    else:
        mesh = sharded.train_mesh(make_mesh(1, 1), "nccl", c["batch"])
        model = sharded.init_sharded(cfg, dev, c["seed"], mesh)
        counter = mesh.counter
    params = tr.loop.param_tree(model)
    state = opt.init(params)
    step = (tr.loop.make_train_step(model, opt, lr_fn) if plain else
            sharded.make_sharded_train_step(model, opt, lr_fn, mesh))
    batches = [{"tokens": torch.from_numpy(b).to(dev)}
               for b in c["global_batches"]]
    keep = c["label"] == "qwen"
    held = {}

    def step_and_keep(p, s, b):
        out = step(p, s, b)
        if not held and keep:
            held["grads"] = [g.detach().clone()
                             for g in tr.tree.leaves(step.grads)]
        return out

    params, state, steps, met0, launches, peak = train_leg(
        torch, dev, c, step_and_keep, params, state, batches, m, counter)
    final = ([p.detach().clone() for p in tr.tree.leaves(params)]
             if keep else None)
    del model, params, state, step, opt
    free_memory(torch)
    return steps, met0, launches, peak, held.get("grads"), final


def phase_sharded_train(torch, dev, tr, m, dryrun_mod) -> dict:
    """sharded_train, then sharded_ssm: each of SHARDED_TRAIN and
    SHARDED_SSM on (1, 1) over nccl in this process, then its two-rank
    meshes over gloo on card 0 (one pair of rank processes for every leg:
    sharded_train_ranks), then the launcher's --mesh 2,1.  Checks: no kernel launched; Qwen3-0.6B's (1,
    1) losses, step-0 gradients and final parameters bitwise
    make_train_step's on init_model's weights; every mesh's step-0 loss
    within SHARDED_LOSS_RTOL of (1, 1)'s and of rank 0's recomputed (1, 1)
    reference; its gathered step-0 gradients within SHARDED_GRAD_REL_L2 in
    relative L2 on every leaf of rank 0's (1, 1) reference (Arctic's
    within SHARDED_CHAOTIC_GRAD_REL_L2; that reference's own spread when
    q, k, v are rounded from f32 printed beside it); every
    step's collective bytes on every rank equal to the dry run's count for
    the arch, batch and mesh; the launcher prints the reference's lines,
    its step-0 loss within SHARDED_LOSS_RTOL of (1, 1)'s.  Prints ms per
    step (CUDA events), collective bytes by kind and peak memory per rank.
    Returns the launches by label."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import free_port, init_ranks, run_ranks
    out, legs, base = {}, [], {}
    free_memory(torch)
    init_ranks(0, 1, port=free_port(), backend="nccl")
    try:
        for c in SHARDED_TRAIN + SHARDED_SSM:
            t0 = time.perf_counter()
            cfg = sharded_cfg(tr, c)
            c = dict(c, global_batches=sharded_batches(tr, cfg, c))
            one = one_by_one_leg(torch, dev, tr, m, c, cfg, plain=False)
            steps, met0, launches, peak, grads, final = one
            row = {"phase": c.get("phase", "sharded_train"),
                   "label": c["label"],
                   "arch": cfg.name, "num_layers": cfg.num_layers,
                   "mesh": [1, 1], "backend": "nccl", "batch": c["batch"],
                   "seq": c["seq"], "optimizer": cfg.optimizer,
                   "steps": steps, "metrics_step0": met0,
                   "max_memory_allocated_bytes": peak,
                   "max_memory_allocated_gb": peak / 1e9, "card": smi()}
            if grads is not None:
                plain = one_by_one_leg(torch, dev, tr, m, c, cfg, plain=True)
                same = ([s["loss"] for s in steps]
                        == [s["loss"] for s in plain[0]]
                        and all(torch.equal(a, b) for a, b in
                                zip(grads, plain[4]))
                        and all(torch.equal(a, b) for a, b in
                                zip(final, plain[5])))
                row["bitwise_make_train_step"] = same
                del grads, final, plain
                if not same:
                    raise AssertionError(f"sharded_train {c['label']} "
                                         "(1, 1): not bitwise "
                                         "make_train_step")
            elif c["label"] == "arctic":
                row["peak_reckoning_gb"] = list(ARCTIC_PEAK_RECKONING_GB)
            row["seconds"] = time.perf_counter() - t0
            emit(row)
            out[f"{c.get('phase', 'sharded_train')}_{c['label']}_1x1"] = \
                launches
            base[c["label"]] = steps[0]["loss"]
            legs += [(c, topo, dryrun_mod.collective_bytes(
                cfg, c["batch"], c["seq"], topo)) for topo in c["meshes"]]
            free_memory(torch)
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_train_ranks, 2, (legs,),
                      timeout=SHARDED_TRAIN_TIMEOUT_S, label="sharded_train")
    emit({"phase": "sharded_train_ranks_seconds",
          "seconds": time.perf_counter() - t0})
    for li, (c, topo, want) in enumerate(legs):
        label = c["label"]
        lead = ranks[0][li]
        phase = c.get("phase", "sharded_train")
        for r in (rk[li] for rk in ranks):
            emit({"phase": f"{phase}_rank", "label": label,
                  "mesh": list(topo), "backend": "gloo (one card)",
                  "rank": r["rank"], "coords": r["coords"],
                  "setup_s": r["setup_s"], "steps": r["steps"],
                  "max_memory_allocated_bytes":
                      r["max_memory_allocated_bytes"],
                  "max_memory_allocated_gb":
                      r["max_memory_allocated_bytes"] / 1e9})
        loss0 = lead["steps"][0]["loss"]
        floor = lead["floor_f32_qkv"]
        bound = (SHARDED_F32_GRAD_REL_L2 if c.get("dtype") == "float32"
                 else SHARDED_CHAOTIC_GRAD_REL_L2.get(label,
                                                      SHARDED_GRAD_REL_L2))
        emit({"phase": phase, "label": label, "arch": c["arch"],
              "mesh": list(topo), "loss_step0": loss0,
              "loss_step0_1x1": base[label],
              "reference_loss": lead["reference_loss"],
              "f32_qkv_loss": lead["f32_qkv_loss"],
              "loss_rel": abs(loss0 - base[label]) / abs(base[label]),
              "grad_rel_l2": lead["grad_rel_l2"],
              "grad_rel_l2_by_leaf": lead["grad_rel_l2_by_leaf"],
              "floor_f32_qkv": floor, "grad_bound": bound,
              "reference_s": lead["reference_s"],
              "dryrun_collective_bytes": want, "card": smi()})
        for loss in (base[label], lead["reference_loss"]):
            if abs(loss0 - loss) > SHARDED_LOSS_RTOL * abs(loss):
                raise AssertionError(f"{phase} {label} {topo}: "
                                     f"step-0 loss {loss0} vs (1, 1) {loss}")
        bad = {k: v for k, v in lead["grad_rel_l2_by_leaf"].items()
               if not v <= bound}
        if bad:
            raise AssertionError(f"{phase} {label} {topo}: gradients "
                                 f"off (1, 1)'s past {bound}: {bad}")
        out[f"{phase}_{label}_{topo[0]}x{topo[1]}"] = lead["launches"]
    if "qwen" in base:
        sharded_train_launcher(base["qwen"])
    return out


def infer_tokens(tr, cfg, c):
    """The leg's (B, S + steps) tokens: the prompt, then the teacher-forced
    decode tokens (token_stream, the leg's seed)."""
    it = tr.token_stream(cfg.vocab_size, c["batch"], c["seq"] + c["steps"],
                         seed=c["seed"], device="cpu")
    return next(it)["tokens"].numpy()


def infer_run(torch, dev, model, tokens, c, m, mesh=None, layers=None):
    """A prefill of the leg's prompt then its teacher-forced decode steps
    on ``model`` (whole, or cut onto ``mesh``: this rank's rows, under the
    prefill and the decode rules), every kernel count zeroed just before
    the prefill and read after it and after the steps.  Returns (logits
    per step as host f32 arrays, the global ones on a mesh's rank 0 (None
    on the others), prefill launches, decode launches, prefill ms, ms per
    decode step, the collective bytes of the prefill and of each step).
    ``layers`` (a list, one device): each call's per-layer inputs and
    outputs and, before a decode step, its cache, appended on the host
    (layer_io)."""
    from repro_torch.distributed import collectives, inference
    from repro_torch.training.sharded import gather_tree, shard_tree
    b, s, w = c["batch"], c["seq"], c["window"]
    toks = torch.from_numpy(tokens).to(dev)
    pre = dec = None
    ctx = contextlib.nullcontext
    if mesh is not None:
        pre = inference.infer_mesh(mesh, "prefill", b)
        dec = inference.infer_mesh(mesh, "decode", b, w)
        rows = (inference.logits_spec(model, b, pre, "prefill")[0], None)
        toks = shard_tree(toks, rows, pre)

    def host(logits, sub):
        if sub is None:
            return logits.float().cpu().numpy()
        spec = inference.logits_spec(model, b, sub, "decode" if sub is dec
                                     else "prefill")
        got = gather_tree(logits.float(), spec, sub)
        return None if got is None else got.numpy()

    logits_out, counts = [], []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    if pre is not None:
        pre.counter.reset()
    with (collectives.active(pre) if pre is not None else
          layer_io(model, layers) if layers is not None else ctx()):
        logits, cache = model.prefill({"tokens": toks[:, :s]}, w)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches_pre = {n: fn.launches for n, fn in m.kernels.items()}
    if pre is not None:
        counts.append(pre.counter.read())
        cache = inference.decode_layout(cache, model, b, w, dec)
    logits_out.append(host(logits, pre))
    zero_counts()
    step_ms = []
    for i in range(c["steps"]):
        t0 = time.perf_counter()
        if dec is not None:
            dec.counter.reset()
        if layers is not None:
            layers.append({k: t.cpu() for k, t in cache.items()})
        with (collectives.active(dec) if dec is not None else
              layer_io(model, layers) if layers is not None else ctx()):
            logits, cache = model.decode_step(toks[:, s + i], cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if dec is not None:
            counts.append(dec.counter.read())
        logits_out.append(host(logits, dec))
    launches_dec = {n: fn.launches for n, fn in m.kernels.items()}
    del cache
    return (logits_out, launches_pre, launches_dec, prefill_ms, step_ms,
            counts)


@contextlib.contextmanager
def layer_io(model, out: list):
    """Append each layer's (input, output) hidden states of the calls
    inside (one list a call) to ``out``, on the host."""
    real = model.block_apply
    io = []

    def block_apply(bp, x, **kw):
        res = real(bp, x, **kw)
        io.append((x.cpu(), res[0].cpu()))
        return res

    model.block_apply = block_apply
    try:
        yield
    finally:
        del model.block_apply
        out.append(io)


def layer_updates(torch, model, mesh, io, cache, rows: int, window: int):
    """Each layer of a cut ``model`` on the one-device run's inputs ``io``
    (a call's layer_io list) under ``mesh``: a prefill when ``cache`` is
    None (a fresh cache for each layer), else a decode step from
    ``cache`` (the one-device cache before the step, whole, cut here by
    the decode rules).  Returns each layer's update (output minus input),
    gathered on rank 0 (None on the others)."""
    from repro_torch.distributed import collectives, inference
    from repro_torch.distributed.sharding import ShardingCtx, spec_for
    from repro_torch.training.sharded import gather_tree, shard_tree
    dev = next(model.parameters()).device
    ctx = ShardingCtx(mesh, inference.rules_of("prefill" if cache is None
                                               else "decode"))
    spec = spec_for(tuple(io[0][0].shape),
                    ("act_batch", "act_seq", "act_embed"), ctx)
    local_cache = None
    if cache is not None:
        specs = inference.cache_specs(model, rows, window, mesh, "decode")
        local_cache = shard_tree({k: t.to(dev) for k, t in cache.items()},
                                 specs, mesh)
    out = []
    with torch.no_grad(), collectives.active(mesh):
        for l, (x, _) in enumerate(io):
            bp = model.blocks[l]
            x = shard_tree(x.to(dev), spec, mesh)
            if local_cache is None:
                lc = model.layer_cache(
                    model.local_cache(x.shape[0], window, mesh), l)
                y = model.block_apply(bp, x, cache=lc, window=window)[0]
            else:
                step = local_cache["step"]
                y = model.block_apply(
                    bp, x, positions=step[:, None],
                    cache=model.layer_cache(local_cache, l),
                    decode_pos=step if bp.kind == "attn" else None,
                    decode=True)[0]
            got = gather_tree((y - x).float(), spec, mesh)
            out.append(None if got is None else got.numpy())
    return out


def sharded_infer_ranks(rank, world, port, legs):
    """Two ranks sharing card 0 over gloo (a ``launch.mesh.RankGroup``
    target), running each of ``legs`` ((c, topo, want, tokens, io) of
    SHARDED_INFER's meshes; ``want`` the dry run's bytes of the prefill
    and of a decode step) in turn: this rank's blocks of ``init_model``'s
    weights (``init_sharded``), its rows of the prompt, the prefill and
    the decode steps (infer_run), every call's collective bytes equal to
    ``want``; B7's calls recorded by their (q heads, kv heads); with
    ``io`` (a chaotic leg: the one-device run's layer_io and caches) each
    call's layers again on the one-device inputs (layer_updates).
    Returns this rank's results by leg (rank 0's with the gathered
    logits)."""
    import gc
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives, inference
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.models import attention as attn_mod
    from repro_torch.training import sharded
    m = SimpleNamespace(kernels=kernel_wrappers())
    tr = SimpleNamespace(get_config=get_config)
    dev = torch.device("cuda", 0)
    real = attn_mod.flash_attention
    heads = []

    def recording(q, k, v, **kw):
        heads.append((q.shape[1], k.shape[1]))
        return real(q, k, v, **kw)

    attn_mod.flash_attention = recording
    init_ranks(rank, world, port=port, backend="gloo")
    out = []
    try:
        for c, topo, want, tokens, io in legs:
            cfg = sharded_cfg(tr, c)
            mesh = collectives.device_mesh_comms(make_mesh(*topo), "staged")
            t0 = time.perf_counter()
            model = sharded.init_sharded(cfg, dev, c["seed"], mesh)
            setup_s = time.perf_counter() - t0
            heads.clear()
            logits, l_pre, l_dec, pre_ms, step_ms, counts = infer_run(
                torch, dev, model, tokens, c, m, mesh)
            flash = list(heads)
            for i, got in enumerate(counts):
                kind = "prefill" if i == 0 else "decode"
                if got != want[kind]:
                    raise AssertionError(
                        f"sharded_infer {c['label']} {topo} rank {rank} "
                        f"call {i}: collective bytes {got} != the dry "
                        f"run's {want[kind]}")
            updates = None
            if io is not None:              # layer by layer (chaotic legs)
                b, w = c["batch"], c["window"]
                pre = inference.infer_mesh(mesh, "prefill", b)
                dec = inference.infer_mesh(mesh, "decode", b, w)
                updates = [layer_updates(torch, model, pre, io[0], None, b,
                                         w)]
                for cache, step_io in zip(io[1::2], io[2::2]):
                    updates.append(layer_updates(torch, model, dec, step_io,
                                                 cache, b, w))
            out.append({"rank": rank, "coords": mesh.coords,
                        "setup_s": setup_s, "logits": logits,
                        "layer_updates": updates,
                        "launches_prefill": l_pre, "launches_decode": l_dec,
                        "flash_heads": sorted(set(flash)),
                        "flash_calls": len(flash), "prefill_ms": pre_ms,
                        "step_ms": step_ms, "collective_bytes": counts[:2],
                        "max_memory_allocated_bytes":
                            torch.cuda.max_memory_allocated(dev)})
            del model
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            dist.barrier()
        return out
    finally:
        attn_mod.flash_attention = real
        dist.destroy_process_group()


def phase_sharded_infer(torch, dev, tr, m, dryrun_mod) -> dict:
    """sharded_infer: each of SHARDED_INFER on one device in this process
    (init_model's weights, the whole batch), then on its two-rank meshes
    over gloo on card 0 (sharded_infer_ranks, one pair of processes for
    every leg).  Checks: every step's gathered logits (the prefill's last
    position, then each decode step's) within SHARDED_INFER_REL_L2 of the
    one-device run's in relative L2; B7 launched once a prefill per
    attention layer on every rank (28 for Qwen3-0.6B) on the rank's local
    heads (8 q / 4 kv on (1, 2)) and on the one-device prefill alike, no
    other kernel and no B7 launch in a decode step; every call's
    collective bytes equal to the dry run's count
    (launch/dryrun.collective_bytes).  Prints ms per prefill and decode
    step per rank and on one device, bytes by kind and peak memory per
    rank.  Returns the launches by label."""
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import common
    out, legs, base, floors, ios = {}, [], {}, {}, {}
    for c in SHARDED_INFER:
        t0 = time.perf_counter()
        cfg = sharded_cfg(tr, c)
        tokens = infer_tokens(tr, cfg, c)
        free_memory(torch)
        model = tr.init_model(cfg, dev, c["seed"])
        torch.cuda.reset_peak_memory_stats(dev)
        chaotic = c["label"] in SHARDED_INFER_CHAOTIC
        io = [] if chaotic else None
        logits, l_pre, l_dec, pre_ms, step_ms, _ = infer_run(
            torch, dev, model, tokens, c, m, layers=io)
        with qkv_in_f32(torch, common, products=True):
            other = infer_run(torch, dev, model, tokens, c, m)[0]
        floor = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                 for a, b in zip(other, logits)]
        n_attn = cfg.layer_kinds.count("attn")
        emit({"phase": "sharded_infer", "label": c["label"],
              "chaotic": chaotic, "floor_products_f32": floor,
              "arch": cfg.name, "num_layers": cfg.num_layers,
              "mesh": [1, 1], "batch": c["batch"], "seq": c["seq"],
              "steps": c["steps"], "window": c["window"],
              "prefill_ms": pre_ms, "step_ms": step_ms,
              "launches_prefill": l_pre, "launches_decode": l_dec,
              "max_memory_allocated_gb":
                  torch.cuda.max_memory_allocated(dev) / 1e9,
              "seconds": time.perf_counter() - t0, "card": smi()})
        if l_pre["flash_attention"] != n_attn:
            raise AssertionError(f"sharded_infer {c['label']} (1, 1): "
                                 f"{l_pre['flash_attention']} B7 launches, "
                                 f"{n_attn} attention layers")
        if max(floor) >= SHARDED_INFER_REL_L2 and not chaotic:
            raise AssertionError(
                f"sharded_infer {c['label']}: one device moves {floor} "
                f"when its products are summed in another order (bound "
                f"{SHARDED_INFER_REL_L2}), and it is not one of "
                "SHARDED_INFER_CHAOTIC")
        out[f"sharded_infer_{c['label']}_1x1"] = l_pre
        base[c["label"]], floors[c["label"]] = logits, floor
        ios[c["label"]] = io
        del model
        free_memory(torch)
        for topo in c["meshes"]:
            want = {kind: dryrun_mod.collective_bytes(
                        cfg, c["batch"], c["seq"] if kind == "prefill"
                        else c["window"], topo, kind)
                    for kind in ("prefill", "decode")}
            legs.append((c, topo, want, tokens, io))
    t0 = time.perf_counter()
    ranks = run_ranks(sharded_infer_ranks, 2, (legs,),
                      timeout=SHARDED_INFER_TIMEOUT_S, label="sharded_infer")
    emit({"phase": "sharded_infer_ranks_seconds",
          "seconds": time.perf_counter() - t0})
    for li, (c, topo, want, _, io) in enumerate(legs):
        cfg = sharded_cfg(tr, c)
        n_attn = cfg.layer_kinds.count("attn")
        h = cfg.num_heads // topo[1] if cfg.num_heads % topo[1] == 0 \
            else cfg.num_heads
        kvh = (cfg.num_kv_heads // topo[1]
               if cfg.num_kv_heads % topo[1] == 0 and h != cfg.num_heads
               else None)
        lead = ranks[0][li]
        rel = []
        for g, w in zip(lead["logits"], base[c["label"]]):
            rel.append(float(np.linalg.norm(g - w) / np.linalg.norm(w)))
        for r in (rk[li] for rk in ranks):
            emit({"phase": "sharded_infer_rank", "label": c["label"],
                  "mesh": list(topo), "backend": "gloo (one card)",
                  "rank": r["rank"], "coords": r["coords"],
                  "setup_s": r["setup_s"], "prefill_ms": r["prefill_ms"],
                  "step_ms": r["step_ms"],
                  "launches_prefill": r["launches_prefill"],
                  "launches_decode": r["launches_decode"],
                  "flash_heads": r["flash_heads"],
                  "flash_calls": r["flash_calls"],
                  "collective_bytes": r["collective_bytes"],
                  "max_memory_allocated_gb":
                      r["max_memory_allocated_bytes"] / 1e9})
            launched = dict(r["launches_prefill"])
            if launched.pop("flash_attention") != n_attn or any(
                    launched.values()) or any(r["launches_decode"].values()):
                raise AssertionError(
                    f"sharded_infer {c['label']} {topo} rank {r['rank']}: "
                    f"launches {r['launches_prefill']} / "
                    f"{r['launches_decode']}; {n_attn} B7 a prefill only")
            if n_attn and (r["flash_calls"] != n_attn or (
                    kvh is not None
                    and r["flash_heads"] != [(h, kvh)])):
                raise AssertionError(
                    f"sharded_infer {c['label']} {topo}: B7 on "
                    f"{r['flash_heads']} x {r['flash_calls']}, not on "
                    f"({h}, {kvh}) local heads x {n_attn}")
        per_layer = None
        if io is not None:        # each call's layers: updates' rel L2
            wants = [[(y - x).float().numpy() for x, y in call]
                     for call in [io[0]] + io[2::2]]
            per_layer = [[float(np.linalg.norm(g - w) / np.linalg.norm(w))
                          for g, w in zip(gots, ws)]
                         for gots, ws in zip(lead["layer_updates"], wants)]
        emit({"phase": "sharded_infer", "label": c["label"],
              "arch": cfg.name, "mesh": list(topo),
              "logits_rel_l2": rel, "bound": SHARDED_INFER_REL_L2,
              "floor_products_f32": floors[c["label"]],
              "layer_update_rel_l2": per_layer,
              "dryrun_collective_bytes": want, "card": smi()})
        if io is not None:
            worst = max(max(call) for call in per_layer)
            if not worst <= SHARDED_INFER_REL_L2:
                raise AssertionError(
                    f"sharded_infer {c['label']} {topo}: a layer's update "
                    f"off the one-device layer's: {per_layer}")
        elif not max(rel) <= SHARDED_INFER_REL_L2:
            raise AssertionError(f"sharded_infer {c['label']} {topo}: "
                                 f"logits off the one-device run's: {rel}")
        out[f"sharded_infer_{c['label']}_{topo[0]}x{topo[1]}"] = \
            lead["launches_prefill"]
    return out


def sharded_train_launcher(base_loss: float) -> None:
    """``python -m repro_torch.launch.train --arch qwen3-0.6b --mesh 2,1
    --steps 2``: two gloo ranks on the card, rank 0 printing the
    reference's lines; its step-0 loss against (1, 1)'s."""
    import os
    import re
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-0.6b", "--mesh", "2,1", "--steps", "2"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=SHARDED_TRAIN_TIMEOUT_S)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("[train]")]
    emit({"phase": "sharded_train_launcher", "returncode": proc.returncode,
          "lines": lines, "seconds": time.perf_counter() - t0,
          "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""})
    if proc.returncode or len(lines) != 3 or not re.fullmatch(
            r"\[train\] .+: [\d.]+M params, opt=adamw", lines[0]) \
            or not all(re.fullmatch(LAUNCHER_LINE, l) for l in lines[1:]):
        raise AssertionError(f"sharded_train_launcher: {lines}")
    loss0 = float(re.search(r"loss=([\d.]+)", lines[1]).group(1))
    if abs(loss0 - base_loss) > SHARDED_LOSS_RTOL * abs(base_loss):
        raise AssertionError(f"sharded_train_launcher: step-0 loss {loss0} "
                             f"vs (1, 1) {base_loss}")


def _bits(torch, t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def phase_checkpoint(torch, dev, tr, model, params, state):
    """checkpoint: save the trained DiT's parameters and AdamW state in the
    reference's format (bytes, seconds), load them into a fresh model and
    state (seconds): every leaf bitwise, the fresh model's per-layer
    parameters the trained ones; metadata round-trips.  The files go under
    build/ and are removed."""
    path = ROOT / "build" / "chip_smoke_ckpt" / "dit.npz"
    meta = {"arch": model.cfg.name, "steps": TRAIN_DIT["steps"],
            "seed": TRAIN_DIT["seed"]}
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.ckpt.save(str(path), {"params": params, "opt_state": state}, meta)
        save_s = time.perf_counter() - t0
        nbytes = path.stat().st_size
        fresh = tr.DiTModel(model.cfg, device=dev)
        fparams = tr.loop.param_tree(fresh)
        fstate = tr.optimizer.make_optimizer(model.cfg.optimizer).init(
            fparams)
        t0 = time.perf_counter()
        got = tr.ckpt.load(str(path), {"params": fparams,
                                       "opt_state": fstate})
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        pairs = list(zip(tr.tree.leaves(got),
                         tr.tree.leaves({"params": params,
                                         "opt_state": state})))
        for i, (g, w) in enumerate(pairs):
            same = (g == w) if isinstance(w, int) else torch.equal(
                _bits(torch, g), _bits(torch, w))
            if not same:
                raise AssertionError(f"checkpoint: leaf {i} differs")
        for dst, src in zip(tr.tree.leaves(fparams),
                            tr.tree.leaves(got["params"])):
            dst.copy_(src)
        for (name, p), (_, q) in zip(model.named_parameters(),
                                     fresh.named_parameters()):
            if not torch.equal(_bits(torch, p.detach()), _bits(torch, q)):
                raise AssertionError(f"checkpoint: {name} differs in the "
                                     f"fresh model")
        if tr.ckpt.load_metadata(str(path))["metadata"] != meta:
            raise AssertionError("checkpoint: metadata did not round-trip")
    finally:
        for f in path.parent.glob("dit*"):
            f.unlink()
    emit({"phase": "checkpoint", "leaves": len(pairs), "bytes": nbytes,
          "save_s": save_s, "load_s": load_s,
          "save_gb_per_s": nbytes / save_s / 1e9,
          "load_gb_per_s": nbytes / load_s / 1e9, "bitwise": True,
          "metadata": meta})


DRYRUN_SWEEP_DIR = ROOT / "build" / "dryrun_sweep"
DRYRUN_SWEEP_TIMEOUT_S = 900     # from its start to its result


def kernel_wrappers() -> dict:
    """The eight kernels' wrappers by name, each with its launch count."""
    from repro_torch import cuda_kernels
    return cuda_kernels.wrappers()


def dryrun_sweep_child(path: str) -> None:
    """The dry run's sweep (every assigned arch x shape on the one-pod
    mesh, on meta) in a process of its own: every count zeroed just before
    and read just after; the records, the sweep's seconds and the counts
    written to ``path`` as JSON."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    kernels = kernel_wrappers()
    zero_counts()                            # the path starts here
    t0 = time.perf_counter()
    recs = dryrun.sweep(dryrun.ASSIGNED_ARCHS, list(SHAPES), [False], "")
    out = {"seconds": time.perf_counter() - t0,
           "launches": {n: fn.launches for n, fn in kernels.items()},
           "records": recs}                         # ... and ends here
    Path(path).write_text(json.dumps(out, default=str))


def start_dryrun_sweep() -> SimpleNamespace:
    """Start ``dryrun_sweep_child`` with no card visible (it runs on meta
    and needs none), its printed lines to a file; stopped at exit if it
    still runs."""
    import atexit
    import os
    DRYRUN_SWEEP_DIR.mkdir(parents=True, exist_ok=True)
    out = DRYRUN_SWEEP_DIR / "records.json"
    log = DRYRUN_SWEEP_DIR / "lines.txt"
    out.unlink(missing_ok=True)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.dryrun_sweep_child(sys.argv[1])", str(out)],
            cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return SimpleNamespace(proc=proc, out=out, log=log,
                           t0=time.perf_counter())


def phase_dryrun(torch, dev, tr, m, dr, sweep) -> dict:
    """dryrun: the sweep of every assigned arch x shape on the one-pod mesh
    (launch/dryrun.py, on meta), ``sweep``'s process (start_dryrun_sweep)
    awaited and its own lines printed, no kernel launched there, no record
    failed; then its card tie and Arctic's one-layer bytes."""
    try:
        code = sweep.proc.wait(
            timeout=max(1.0, DRYRUN_SWEEP_TIMEOUT_S
                        - (time.perf_counter() - sweep.t0)))
    except subprocess.TimeoutExpired:
        sweep.proc.kill()
        sweep.proc.wait()
        raise AssertionError("dryrun: the sweep gave no result within "
                             f"{DRYRUN_SWEEP_TIMEOUT_S} s")
    lines = sweep.log.read_text()
    print(lines, end="", flush=True)
    if code != 0:
        raise AssertionError(f"dryrun: the sweep's process exited {code}: "
                             f"{lines[-3000:]}")
    got = json.loads(sweep.out.read_text())
    recs, sweep_s, launches = got["records"], got["seconds"], got["launches"]
    if any(launches.values()):
        raise AssertionError(f"dryrun: kernels launched on meta {launches}")
    status = collections.Counter(r["status"] for r in recs)
    for r in recs:
        if r["status"] != "ok":
            emit({"phase": "dryrun_record", "arch": r["arch"],
                  "shape": r["shape"], "status": r["status"],
                  "reason": r.get("skip_reason") or r.get("error")})
            continue
        emit({"phase": "dryrun_record", "arch": r["arch"],
              "shape": r["shape"], "mesh": r["mesh"], "status": "ok",
              "per_device_flops": r["per_device_flops"],
              "per_device_bytes_accessed": r["per_device_bytes_accessed"],
              "argument_size_in_bytes":
                  r["memory_analysis"]["argument_size_in_bytes"],
              "output_size_in_bytes":
                  r["memory_analysis"]["output_size_in_bytes"],
              "useful_flops_ratio": r["useful_flops_ratio"],
              "roofline": r["roofline"], "proof_seq_len": r["proof_seq_len"],
              "compile_s": r["compile_s"],
              "cost_measure_s": r["cost_measure_s"],
              "collective_bytes": r["collective_bytes"]})
    emit({"phase": "dryrun", "records": len(recs), "ok": status["ok"],
          "skip": status["skip"], "fail": status["fail"],
          "seconds": sweep_s, "under_300_s": sweep_s < 300})
    if status["fail"]:
        raise AssertionError("dryrun: failed records " + str(
            [(r["arch"], r["shape"], r["error"]) for r in recs
             if r["status"] == "fail"]))
    uncounted = [(r["arch"], r["shape"]) for r in recs if r["status"] == "ok"
                 and not (r["collective_bytes"] or {}).get("total")]
    if uncounted:
        raise AssertionError(f"dryrun: records without collective bytes "
                             f"{uncounted}")
    dryrun_tie(torch, dev, tr, m, dr)
    one = ARCTIC_ONE_LAYER
    mesh = dr.abstract_mesh((1, 1))
    b = dr.specs.build_bundle(one["arch"], one["shape"], mesh,
                              num_layers=one["num_layers"])
    args_b = dr.specs.shard_bytes(b.args, b.in_specs,
                                  dr.mesh_extents(mesh))
    emit({"phase": "dryrun_arctic_one_layer", **one, "mesh": [1, 1],
          "params": b.meta["params"], "argument_size_in_bytes": args_b,
          "argument_gib": args_b / 2**30, "card_hbm_gib": torch.cuda.
          get_device_properties(dev).total_memory / 2**30,
          "note": "a prediction: no card run", "card": smi()})
    return launches


def dryrun_tie(torch, dev, tr, m, dr) -> None:
    """The dry run of Qwen3-0.6B's train step at TRAIN_LLM's shape on a
    (1, 1) mesh against the same step on the card: argument bytes within
    DRYRUN_TIE_REL of memory_allocated()'s growth, FLOPs equal to
    FlopCounterMode's count on the card (the training forward runs
    attend_direct and no kernel, so both see the same aten ops); the
    card's step time beside the roofline's compute_s."""
    from torch.utils.flop_counter import FlopCounterMode
    c = TRAIN_LLM
    mesh = dr.abstract_mesh((1, 1))
    b = dr.specs.build_bundle(c["arch"], "train_4k", mesh,
                              seq_override=c["seq"],
                              batch_override=c["batch"])
    args_b = dr.specs.shard_bytes(b.args, b.in_specs, dr.mesh_extents(mesh))
    meta = dr.dryrun.counted(b.step_fn, *b.args)[1]
    del b
    cfg = tr.get_config(c["arch"])
    free_memory(torch)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated(dev)
    model = tr.init_model(cfg, dev, c["seed"])
    params = tr.loop.param_tree(model)
    opt = tr.optimizer.make_optimizer(cfg.optimizer)
    state = opt.init(params)
    batch = next(tr.token_stream(cfg.vocab_size, c["batch"], c["seq"],
                                 seed=c["seed"], device=dev))
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(dev) - m0
    bytes_rel = abs(grown - args_b) / args_b
    step_fn = tr.loop.make_train_step(
        model, opt, tr.optimizer.cosine_schedule(3e-4, 100, 10_000))
    zero_counts()
    params, state, _ = step_fn(params, state, batch)          # warm-up
    with FlopCounterMode(display=False) as fc:
        params, state, _ = step_fn(params, state, batch)
    card_flops = float(fc.get_total_flops())
    ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, state, met = step_fn(params, state, batch)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    launches = {name: fn.launches for name, fn in m.kernels.items()}
    row = {"phase": "dryrun_tie", **c, "mesh": [1, 1],
           "argument_size_in_bytes": args_b, "allocated_growth": grown,
           "bytes_rel": bytes_rel, "meta_flops": meta["flops"],
           "card_flops": card_flops, "meta_bytes_accessed": meta["bytes"],
           "step_ms": ms, "compute_s": meta["flops"] / dr.dryrun.PEAK_FLOPS,
           "memory_s": meta["bytes"] / dr.dryrun.HBM_BW,
           "loss": float(met["loss"]), "launches": launches, "card": smi()}
    emit(row)
    del model, params, state, step_fn, batch
    free_memory(torch)
    if bytes_rel > DRYRUN_TIE_REL:
        raise AssertionError(f"dryrun_tie: argument bytes {args_b} vs "
                             f"{grown} grown on the card ({bytes_rel:.4f})")
    if card_flops != meta["flops"]:
        raise AssertionError(f"dryrun_tie: FLOPs {meta['flops']} on meta, "
                             f"{card_flops} on the card")
    if any(launches.values()):
        raise AssertionError(f"dryrun_tie: kernels launched {launches}")


def phase_examples(torch, m) -> dict:
    """examples: each of EXAMPLES at its defaults on the card, in process
    (its main()), its printed lines kept; every count zeroed just before
    and read just after; EXAMPLE_KERNELS must have launched."""
    import io
    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zero_counts()                      # the path starts here
        with contextlib.redirect_stdout(buf):
            mod.main([])
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in m.kernels.items()}
        seconds = time.perf_counter() - t0
        emit({"phase": f"example_{name}", "seconds": seconds,
              "lines": buf.getvalue().splitlines(), "launches": launches})
        missing = [k for k in EXAMPLE_KERNELS.get(name, ())
                   if not launches[k]]
        if missing:
            raise AssertionError(f"example {name}: {missing} not launched")
        out[f"example_{name}"] = launches
        del mod
        free_memory(torch)
    for suffix in (".npz", ".meta.json"):
        (ROOT / (EXAMPLE_CKPT + suffix)).unlink(missing_ok=True)
    return out


def cond_gate_args(torch, dev, statcache, pattern):
    """fused_gate's inputs at COND_FED_SHAPE, bf16, every sample eligible,
    the gating samples chosen: "all", "one" (sample 3) or "none"; and its
    threshold."""
    gen = torch.Generator(dev).manual_seed(5)
    b, c, d = COND_FED_SHAPE
    x = torch.randn((b, c, d), generator=gen, device=dev).to(torch.bfloat16)
    prev = (x.float() + 0.01 * torch.randn(
        (b, c, d), generator=gen, device=dev)).to(torch.bfloat16)
    po = torch.randn((b, c, d), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.eye(d, device=dev) + 0.01 * torch.randn(
        (d, d), generator=gen, device=dev)
    bias = 0.1 * torch.randn((d,), generator=gen, device=dev)
    thr = statcache.make_threshold(0.05, c * d)
    diff = (x.double() - prev.double()).square().sum(dim=(1, 2))
    gates = {"all": [True] * b, "none": [False] * b,
             "one": [i == 3 for i in range(b)]}[pattern]
    factor = torch.tensor([2.0 if g else 0.5 for g in gates], device=dev,
                          dtype=torch.float64)
    sigma2 = (diff / (c * d * thr) * factor).float()
    eligible = torch.ones(b, dtype=torch.bool, device=dev)
    return (x, prev, po, w, bias, sigma2, eligible), thr


def phase_cond_node(torch, dev, ref, cond_mod, fg_mod, statcache, build):
    """The IF nodes (csrc/cond_node.cu) against the plain condition on the
    served skip mask (COND_MASK_ROWS rows), for a mask of all, one and no
    rows caching, in graphs replayed: one node with its own condition
    kernel on either side (when_all), a two-sided pair on one condition
    kernel (exactly the side the plain condition picks runs), and a node
    on the condition fused_gate's GEMM sets at COND_FED_SHAPE on the wgmma
    route (the body runs exactly when the plain !all(gate) says).  Timed,
    per node in a graph of COND_NODES: a node with its condition kernel,
    its body taken and not (the row "if_all"); fed by B1, the graph of B1
    calls with a node each less the graph of B1 calls alone, beside the
    same with a condition kernel reading B1's gate (the row
    "if_all_fed"); a pair on one kernel beside two nodes on a kernel each
    (the row "if_all_pair").  Returns the three rows."""
    ptxas = build.ptxas_lines(build.load_library("cond_node").log)
    cond_mod.prepare(dev)
    b = COND_MASK_ROWS
    masks = {"all": torch.ones(b, dtype=torch.bool, device=dev),
             "one_not": torch.arange(b, device=dev) != 3,
             "none": torch.zeros(b, dtype=torch.bool, device=dev)}

    def replayed(capture, flags):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            capture()
        flags.zero_()
        g.replay()
        torch.cuda.synchronize()
        return flags.clone()

    worst = {"own": 0.0, "pair": 0.0, "fed": 0.0}
    for mask in masks.values():
        every = float(ref.if_all(mask, True))
        for when_all in (True, False):
            flag = torch.zeros((), device=dev)
            got = replayed(lambda: cond_mod.if_all(
                mask, lambda: flag.add_(1.0), when_all=when_all), flag)
            want = ref.if_all(mask, when_all).float()
            worst["own"] = max(worst["own"], float((got - want).abs()))
        flags = torch.zeros(2, device=dev)
        got = replayed(lambda: cond_mod.if_all_sides(
            mask, [(lambda: flags[0].add_(1.0), True),
                   (lambda: flags[1].add_(1.0), False)]), flags)
        want = torch.tensor([every, 1.0 - every], device=dev)
        worst["pair"] = max(worst["pair"], float((got - want).abs().max()))
    fed_args = {}
    for pattern in ("all", "one", "none"):
        args, thr = cond_gate_args(torch, dev, statcache, pattern)
        copy = args[3].to(torch.bfloat16)
        fed_args[pattern] = (args, thr, copy)
        plain = ref.fused_gate(*args, threshold=thr, gamma=0.5)[1]
        flag = torch.zeros((), device=dev)

        def fed(args=args, thr=thr, copy=copy, flag=flag):
            handle = cond_mod.condition(dev)
            fg_mod._launch("wgmma", *args, thr, 0.5, True, copy, handle)
            cond_mod.if_set(handle, lambda: flag.add_(1.0), dev)

        got = replayed(fed, flag)
        worst["fed"] = max(worst["fed"],
                           abs(float(got) - float(not bool(plain.all()))))
    if any(worst.values()):
        raise AssertionError(f"the IF nodes disagree with the plain "
                             f"condition: {worst}")

    def per_node(capture, n=COND_NODES):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                capture()
        return device_ms(torch, g.replay) / n

    flag = torch.zeros((), device=dev)
    one_not = masks["one_not"]
    times = {}
    for taken, when_all in (("taken", False), ("not_taken", True)):
        times[taken] = per_node(lambda: cond_mod.if_all(
            one_not, lambda: flag.add_(1.0), when_all=when_all))
    # two-sided: one side taken, on one kernel and on a kernel each
    pair = per_node(lambda: cond_mod.if_all_sides(
        one_not, [(lambda: flag.add_(1.0), True),
                  (lambda: flag.add_(1.0), False)]))
    pair_two = per_node(lambda: (
        cond_mod.if_all(one_not, lambda: flag.add_(1.0), when_all=True),
        cond_mod.if_all(one_not, lambda: flag.add_(1.0), when_all=False)))
    # fed by B1 (one sample gating: the body runs), against B1 alone and
    # B1 with a condition kernel reading its gate
    args, thr, copy = fed_args["one"]

    def b1(handle=None):
        return fg_mod._launch("wgmma", *args, thr, 0.5, True, copy, handle)

    def b1_fed():
        handle = cond_mod.condition(dev)
        b1(handle)
        cond_mod.if_set(handle, lambda: flag.add_(1.0), dev)

    def b1_own():
        gate = b1()[1]
        cond_mod.if_all(gate, lambda: flag.add_(1.0), when_all=False)

    n_fed = COND_FED_NODES
    b1_alone = per_node(b1, n_fed)
    b1_with_fed = per_node(b1_fed, n_fed)
    b1_with_own = per_node(b1_own, n_fed)
    plain = timed(torch, "plain", lambda: ref.if_all(one_not, False))
    library = timed(torch, "library", lambda: torch.all(one_not))
    common = {"route": "cuda", "source": "src/repro_torch/csrc/cond_node.cu",
              "replaces": "src/repro/core/policies/fastcache.py:176",
              "replaces_what": "jax.lax.cond(jnp.all(do_cache), ...): a "
                               "branch on the device, not a Pallas kernel",
              "shape": [b], **plain, **library,
              "library_call": "torch.all of the mask (a 0-dim bool; "
                              "branching on it on the host needs a sync)",
              "ptxas": ptxas}
    own_bytes = b + 4                   # the mask read, the condition set
    rows = [{"name": "if_all", **common, "max_abs_err": worst["own"],
             "ms": times["taken"], "node_not_taken_ms": times["not_taken"],
             "ms_is": "per IF node inside a graph of COND_NODES, its own "
                      "condition kernel (set_if_all) and a one-add body, "
                      "taken",
             "bytes": own_bytes, "operations": b,
             **dict(zip(("bound_ms", "bound_by"), bound(own_bytes, 0.0)))}]
    # fed: the condition warp's reads (each sample's partials, sigma2,
    # eligible) and the condition set
    fed_bytes = b * (fg_mod.REDUCTION_PARTS * 4 + 4 + 1) + 4
    rows.append({"name": "if_all_fed", "wrapper": "if_all", **common,
                 "source": "src/repro_torch/csrc/fused_gate.cu",
                 "shape": list(COND_FED_SHAPE),
                 "max_abs_err": worst["fed"],
                 "ms": b1_with_fed - b1_alone,
                 "ms_is": "per IF node on the condition fused_gate's GEMM "
                          "sets (wgmma route, one sample of 8 gating, the "
                          "body taken): a graph of COND_FED_NODES B1 calls "
                          "with a node each less the graph of B1 calls "
                          "alone",
                 "own_kernel_node_ms": b1_with_own - b1_alone,
                 "own_kernel_node_is": "the same with a condition kernel "
                                       "reading B1's gate (the parent's "
                                       "IF node)",
                 "b1_graph_ms": b1_alone, "b1_fed_graph_ms": b1_with_fed,
                 "b1_own_kernel_graph_ms": b1_with_own,
                 "bytes": fed_bytes, "operations": b * fg_mod.REDUCTION_PARTS,
                 **dict(zip(("bound_ms", "bound_by"),
                            bound(fed_bytes, 0.0)))})
    pair_bytes = b + 8
    rows.append({"name": "if_all_pair", "wrapper": "if_all", **common,
                 "max_abs_err": worst["pair"], "ms": pair,
                 "ms_is": "per two-sided branch (two IF nodes, one side "
                          "taken) on one condition kernel, in a graph of "
                          "COND_NODES",
                 "two_kernels_ms": pair_two,
                 "two_kernels_is": "the same branch on a condition kernel "
                                   "a side (the parent's)",
                 "bytes": pair_bytes, "operations": b,
                 **dict(zip(("bound_ms", "bound_by"),
                            bound(pair_bytes, 0.0)))})
    for row in rows:
        emit({"phase": "kernel", **row})
    return rows


def phase_gemv_crossover(torch, dev, lb_mod, route):
    """linear_blend's gemv and wgmma routes, named, at the decode gates'
    widths (GEMV_WIDTHS, D = F) and M in GEMV_CROSSOVER_M, bf16, gamma 1,
    device ms each (L2-warm): the gemv route must be the faster at every M
    <= route.GEMV_MAX_ROWS, the rows the rule gives it, or the run
    fails.  Prints, per width, the largest M at which it was faster, and
    at M = 4 the plan's split of K beside the splits aiming at one block
    an SM and at two."""
    rows, split_rows = [], []
    for d in GEMV_WIDTHS:
        gen = torch.Generator(dev).manual_seed(d)
        w = torch.eye(d, device=dev) + 0.01 * torch.randn(
            (d, d), generator=gen, device=dev)
        copy = w.to(torch.bfloat16)
        b = 0.1 * torch.randn((d,), generator=gen, device=dev)
        for m in GEMV_CROSSOVER_M:
            x = torch.randn((m, d), generator=gen, device=dev).to(
                torch.bfloat16)
            prev = torch.randn((m, d), generator=gen, device=dev).to(
                torch.bfloat16)
            rows.append({"d": d, "m": m, **{
                f"{which}_device_ms": device_ms(
                    torch, lambda which=which: lb_mod._launch(
                        which, x, w, b, prev, 1.0, copy))
                for which in ("gemv", "wgmma")}})
        # the plan's split of K beside one block an SM and two, at M = 4
        x = torch.randn((4, d), generator=gen, device=dev).to(torch.bfloat16)
        prev = torch.randn((4, d), generator=gen, device=dev).to(
            torch.bfloat16)
        plans = {"plan": route.gemv_plan(4, d, d), **{
            f"target_{blocks}_blocks": route.gemv_plan(4, d, d, blocks)
            for blocks in (route.GEMV_SMS, route.GEMV_BLOCKS)}}
        split_rows.append({"d": d, **{
            name: {"blocks": p.tiles * p.splits, "splits": p.splits,
                   "device_ms": device_ms(torch, lambda p=p: lb_mod._gemv(
                       x, copy, b, prev, 1.0, p))}
            for name, p in plans.items()}})
        del w, copy
    faster = {d: max([r["m"] for r in rows if r["d"] == d
                      and r["gemv_device_ms"] < r["wgmma_device_ms"]],
                     default=0) for d in GEMV_WIDTHS}
    emit({"phase": "gemv_crossover", "rows": rows,
          "gemv_max_rows": route.GEMV_MAX_ROWS,
          "largest_m_gemv_faster": faster, "splits_of_k": split_rows,
          "card": smi()})
    losing = [r for r in rows if r["m"] <= route.GEMV_MAX_ROWS
              and r["gemv_device_ms"] >= r["wgmma_device_ms"]]
    if losing:
        raise AssertionError(f"the gemv route lost to the wgmma route at "
                             f"rows the rule gives it: {losing}")
    return rows


LAUNCH_APIS = ("cudaLaunchKernel", "cuLaunchKernel")
# a pause at each end of a profiled step: with none the profiler now and
# then dropped the records of a step's first kernels on the H100 (a
# teacache replay's saliency_delta and set_if_all), and with 5 ms late in
# the script an eager decode step lost one saliency_delta and one
# linear_blend record at every profiled step.  The profiler places the
# device's records in its window by their timestamps mapped to the host's
# clock; first_kernel_after_launch_ms shows that mapping's lag
PROFILE_PAUSE_S = 0.2
GRAPH_APIS = ("cudaGraphLaunch", "cuGraphLaunch")
COPY_APIS = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


# a name each kernel wrapper's call runs exactly one kernel under (a call
# may run two: fused_gate's partials, saliency_delta's row sums)
WRAPPER_KERNEL_NAMES = {
    "fused_gate": ("gate_gemm",), "linear_blend": ("linear_blend_kernel",),
    "saliency_delta": ("saliency_delta_onepass", "sample_totals"),
    "knn_density": ("knn_density_kernel",),
    "merge_assign": ("merge_assign_kernel",),
    "unmerge_scatter": ("unmerge_scatter_kernel",),
    "flash_attention": ("flash_attention_kernel",),
    "if_all": ("set_if_all",)}


def wrapper_kernels_ran(names) -> dict:
    """The kernel wrappers' calls that the card ran, by wrapper, from the
    profiled device kernels' names."""
    return {w: sum(n for k, n in names.items()
                   if any(m in k for m in marks))
            for w, marks in WRAPPER_KERNEL_NAMES.items()}


class CountedStep:
    """A profiled step's wrapper launch counts beside what the card ran:
    ``read(names)`` after the step gives the counters' gain since the step
    began (on the graph path: the capture's record, added at each replay)
    and ``wrapper_kernels_ran`` of the profiled kernels."""

    def __init__(self):
        from repro_torch import cuda_kernels
        self.kernels = cuda_kernels
        self.before = cuda_kernels.read_counts()

    def read(self, names) -> dict:
        added = dict.fromkeys(WRAPPER_KERNEL_NAMES, 0)
        nodes = 0
        for (w, attr, _), n in self.kernels.counts_since(
                self.before).items():
            if attr == "launches":
                added[w] += n
            elif attr == "nodes":
                nodes += n
        return {"added": added, "ran": wrapper_kernels_ran(names),
                "if_nodes": nodes}


def hold_counts(label, rows) -> dict:
    """The profiled steps' ``CountedStep.read``s: in no step did the card
    run more of a wrapper's kernels than its counter gained, and in at
    least one the two agree for every wrapper.  The profiler can lose a
    kernel's record (seen on the H100: a saliency_delta of an eager decode
    step's 28), never make one up, so a step short of its count is
    reported (``records_short``), not taken for a miscount."""
    over = [r for r in rows
            if any(r["ran"][w] > r["added"][w] for w in r["added"])]
    whole = [r for r in rows if r["ran"] == r["added"]]
    nodes = {r["if_nodes"] for r in rows}
    if over or not whole:
        raise AssertionError(f"{label}: the launch counters' gain against "
                             f"the kernels the card ran, by profiled step: "
                             f"{rows}")
    if len(nodes) != 1:
        raise AssertionError(f"{label}: IF nodes by profiled step {nodes}")
    return {"profiled_steps": len(rows), "steps_counted_whole": len(whole),
            "added_per_step": mean_counts([r["added"] for r in rows]),
            "if_nodes_per_step": nodes.pop(),
            # the profiler's set_if_all kernels in the steps it saw whole
            "set_if_all_ran_per_step": float(np.mean(
                [r["ran"]["if_all"] for r in whole])),
            "records_short": {w: sum(r["added"][w] - r["ran"][w]
                                     for r in rows) for w in rows[0]["added"]
                              if any(r["added"][w] != r["ran"][w]
                                     for r in rows)}}


def name_gap(rows_a, rows_b, top: int = 12) -> dict:
    """Mean device kernels per step by name, path a minus path b, the names
    whose counts differ (at most ``top``, the largest first)."""
    def mean(rows):
        tot = collections.Counter()
        for r in rows:
            tot.update(r)
        return {k: n / len(rows) for k, n in tot.items()}
    a, b = mean(rows_a), mean(rows_b)
    gap = {k[:100]: a.get(k, 0.0) - b.get(k, 0.0) for k in set(a) | set(b)
           if a.get(k, 0.0) != b.get(k, 0.0)}
    return dict(sorted(gap.items(), key=lambda kv: -abs(kv[1]))[:top])


def host_launches(torch, fn):
    """``fn()`` under torch.profiler: the CUDA runtime / driver calls the
    host made (kernel launches, graph launches, copies and memsets) and the
    kernels that ran on the card, and those kernels by name."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAUSE_S)
    events = prof.events()
    names = collections.Counter(e.name for e in events
                                if e.device_type
                                != torch.autograd.DeviceType.CUDA)
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "emcpy" not in e.name and "emset" not in e.name]
    launched = [e.time_range.start for e in events
                if e.device_type != torch.autograd.DeviceType.CUDA
                and e.name.startswith(LAUNCH_APIS + GRAPH_APIS)]
    lag = (min(e.time_range.start for e in device) - min(launched)) / 1e3 \
        if device and launched else 0.0
    return out, collections.Counter(e.name for e in device), {
        # the first kernel's start less the first launch's, ms (below 0:
        # the device's clock, as the profiler maps it, runs early)
        "first_kernel_after_launch_ms": lag,
        "host_kernel_launches": sum(n for k, n in names.items()
                                    if k.startswith(LAUNCH_APIS)),
        "host_graph_launches": sum(n for k, n in names.items()
                                   if k.startswith(GRAPH_APIS)),
        "host_copies": sum(n for k, n in names.items()
                           if k.startswith(COPY_APIS)),
        "device_kernels": len(device)}


def mean_counts(rows) -> dict:
    return {k: float(np.mean([r[k] for r in rows])) for k in rows[0]} \
        if rows else {}


def path_serve(torch, wl, model, m, step_graph, label, mesh=None):
    """A serve of ``wl`` on the graph path or the eager one (``step_graph``
    None / False), through the sharded engine on ``mesh`` when one is
    given, its counts zeroed just before and checked just after
    (check_path).  Each engine step that runs the model ends in a
    synchronize, its wall kept when the step was warm;
    GRAPH_PROFILED_STEPS warm steps from engine step GRAPH_PROFILE_FROM on
    run under torch.profiler instead (host_launches; their walls left
    out), their wrappers' launch counts held to the kernels the card ran
    (CountedStep, hold_counts)."""
    wl = dataclasses.replace(wl, step_graph=step_graph)
    runner, eng = wl.build_engine(model, mesh=mesh)
    trace = wl.build_trace(model)
    step = eng.step
    walls, prof, names, ran = [], [], [], []

    def timed_step():
        warm0 = runner.impl.step_kinds["warm"]
        profiled = (eng.clock + 1 >= GRAPH_PROFILE_FROM
                    and len(prof) < GRAPH_PROFILED_STEPS)
        if profiled:
            counted = CountedStep()
            out, by_name, counts = host_launches(torch, step)
            ran_now = counted.read(by_name)
        else:
            t0 = time.perf_counter()
            out = step()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if runner.impl.step_kinds["warm"] > warm0:
            if profiled:
                prof.append(counts)
                names.append(by_name)
                ran.append(ran_now)
            else:
                walls.append(dt)
        return out

    eng.step = timed_step
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    done = eng.run(trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in m.kernels.items()}
    check_path(label, wl, runner, eng, m, launches)
    if len(prof) != GRAPH_PROFILED_STEPS:
        raise AssertionError(f"{label}: {len(prof)} warm steps profiled")
    held = hold_counts(label, ran)
    return SimpleNamespace(done=sorted(done, key=lambda r: r.rid),
                           walls=walls, prof=prof, names=names, held=held,
                           wall=wall,
                           runner=runner, eng=eng, launches=launches,
                           stats=eng.cache_stats())


def dit_path_syncs(torch, wl, model, m, step_graph, **engine_kwargs):
    """Two requests of 8 steps on a fresh engine (built with
    ``engine_kwargs``, e.g. ``fc_params``): the cold step, then five warm
    steps under sync debug "warn" (the graph path's first one captures),
    then on the graph path one more warm step under "error"; drained.
    Returns the flagged syncs by where they were made."""
    short = dataclasses.replace(wl, requests=2, steps=8, steps_mix=(),
                                guidance_mix=(), step_graph=step_graph)
    runner, eng = short.build_engine(model, **engine_kwargs)
    for i in range(2):
        eng.add_request(m.DiffusionRequest(rid=i, label=i + 1, seed=40 + i,
                                           num_steps=8,
                                           guidance_scale=wl.guidance))
    eng.step()                                           # cold
    counted0 = runner.impl.host_syncs
    warm0 = runner.impl.step_kinds["warm"]

    def warm_steps():
        for _ in range(5):
            eng.step()

    _, flagged, sources, in_port = sync_flags(torch, warm_steps)
    warm = runner.impl.step_kinds["warm"] - warm0
    counted = runner.impl.host_syncs - counted0
    if warm != 5 or eng.host_syncs != 0:
        raise AssertionError(f"{warm} warm steps, {eng.host_syncs} "
                             "completion fetches in the window")
    error_mode = None
    if step_graph is None:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        error_mode = "0 syncs (sync debug error)"
    while any(r is not None for r in eng.slots):
        eng.step()
    return {"flagged_in_port_per_warm_step": in_port / warm,
            "counted_per_warm_step": counted / warm,
            "flagged_per_warm_step": flagged / warm, "sources": sources,
            "error_mode_warm_step": error_mode,
            "replays": runner.graphs.replays}


def phase_step_graph_dit(torch, dev, wl, model, m, sal_mod, knn_mod, tm_mod,
                         sal_modules, core_token_merge):
    """The warm DiT step eager and as a graph (see 8b in the docstring).
    The eager serves carry the route-parity recorders."""
    cases = (("fastcache", wl),
             ("fastcache_merge", dataclasses.replace(
                 wl, merge_ratio=MERGE_RATIO)),
             ("teacache", dataclasses.replace(wl, policy="teacache")))
    t0 = time.perf_counter()
    for label, w in cases:
        sal_captured = []
        windows = {name: [] for name in WINDOW_KERNELS}
        hooks = contextlib.ExitStack()
        if label != "fastcache_merge":
            hooks.enter_context(capture_saliency(sal_modules, sal_captured))
        else:
            hooks.enter_context(capture_windows(core_token_merge, windows))
        with hooks:
            eager = path_serve(torch, w, model, m, False,
                               f"step_graph_{label}_eager")
        graph = path_serve(torch, w, model, m, None,
                           f"step_graph_{label}_graph")
        if label == "fastcache_merge":
            phase_window_parity(torch, windows, knn_mod, tm_mod)
        else:
            phase_saliency_parity(torch, w.policy, sal_captured, sal_mod)
        if eager.runner.graphs.replays != 0 or graph.runner.graphs.replays \
                != graph.runner.impl.step_kinds["warm"]:
            raise AssertionError(f"{label}: replays eager "
                                 f"{eager.runner.graphs.replays}, graph "
                                 f"{graph.runner.graphs.replays} of "
                                 f"{graph.runner.impl.step_kinds}")
        bitwise = all(np.array_equal(a.latents, b.latents)
                      for a, b in zip(eager.done, graph.done))
        caches = all(a.cache == b.cache for a, b in zip(eager.done,
                                                         graph.done))
        rows = all(eager.stats[k] == graph.stats[k]
                   for k in ("per_slot_blocks_skipped",
                             "per_slot_blocks_computed"))
        ratio = {"eager": eager.stats["block_cache_ratio"],
                 "graph": graph.stats["block_cache_ratio"]}
        syncs = {"eager": dit_path_syncs(torch, w, model, m, False),
                 "graph": dit_path_syncs(torch, w, model, m, None)}
        reads = (0 if w.policy not in ("fastcache", "teacache")
                 else model.cfg.num_layers if w.policy == "fastcache" else 1)
        emit({"phase": "step_graph", "case": label, "policy": w.policy,
              "merge_ratio": w.merge_ratio, "requests": len(graph.done),
              "latents_bitwise": bitwise, "request_counters_equal": caches,
              "row_counters_equal": rows, "block_cache_ratio": ratio,
              "step_kinds": {"eager": eager.runner.impl.step_kinds,
                             "graph": graph.runner.impl.step_kinds},
              "graph_replays": graph.runner.graphs.replays,
              "graph_captures": graph.runner.graphs.captures,
              "syncs": syncs,
              "launches_per_warm_step": {"eager": mean_counts(eager.prof),
                                         "graph": mean_counts(graph.prof)},
              "wrapper_counts_held": {"eager": eager.held,
                                      "graph": graph.held},
              "device_kernels_eager_minus_graph": name_gap(eager.names,
                                                           graph.names),
              "wall_ms_per_warm_step": {
                  "eager": 1e3 * float(np.mean(eager.walls)),
                  "graph": 1e3 * float(np.mean(graph.walls))},
              "wall_ms_per_warm_step_p50": {
                  "eager": 1e3 * float(np.median(eager.walls)),
                  "graph": 1e3 * float(np.median(graph.walls))},
              "warm_steps_timed": {"eager": len(eager.walls),
                                   "graph": len(graph.walls)},
              "serve_wall_s": {"eager": eager.wall, "graph": graph.wall},
              "launches": {"eager": eager.launches,
                           "graph": graph.launches}, "card": smi()})
        if not (bitwise and caches and rows):
            raise AssertionError(f"{label}: the graph path departs from the "
                                 f"eager one (latents bitwise {bitwise}, "
                                 f"counters {caches}, rows {rows})")
        if label == "fastcache" and set(ratio.values()) != {
                PARENT_BLOCK_CACHE_RATIO}:
            raise AssertionError(f"cache ratio {ratio}")
        # IF nodes and the profiler's condition kernels a replayed step
        # (fastcache's set by fused_gate: none), none eagerly
        conds = {"eager": (eager.held["if_nodes_per_step"],
                           eager.held["set_if_all_ran_per_step"]),
                 "graph": (graph.held["if_nodes_per_step"],
                           graph.held["set_if_all_ran_per_step"])}
        emit({"phase": "step_graph_if_nodes", "case": label,
              "if_nodes_and_set_if_all_per_warm_step": conds})
        if conds != {"eager": (0, 0.0), "graph": tuple(
                float(n) for n in ifs_per_step(w.policy, model.cfg.num_layers))}:
            raise AssertionError(f"{label}: IF nodes and set_if_all kernels "
                                 f"a warm step {conds}")
        g, e = syncs["graph"], syncs["eager"]
        if (g["flagged_in_port_per_warm_step"], g["counted_per_warm_step"]) \
                != (0.0, 0.0):
            raise AssertionError(f"{label}: graph path syncs {g}")
        if (e["flagged_in_port_per_warm_step"] != float(reads)
                or e["counted_per_warm_step"] != float(reads)):
            raise AssertionError(f"{label}: eager path syncs {e}")
    emit({"phase": "step_graph_dit_seconds",
          "seconds": time.perf_counter() - t0})


def llm_path(torch, wl, model, step_graph):
    """``wl`` served on a fresh engine on the graph path or the eager one:
    each decode step ends in a synchronize (its wall kept),
    GRAPH_PROFILED_STEPS decode steps from the GRAPH_PROFILE_FROM-th run
    under torch.profiler (host_launches; the wrappers' launch counts held
    to the kernels the card ran: CountedStep, hold_counts) and three from
    the 20th under sync debug "warn" (their syncs by where they were
    made)."""
    wl = dataclasses.replace(wl, step_graph=step_graph)
    eng = wl.build_engine(model)
    reqs = wl.build_requests(model)
    step = eng.step
    walls, prof, names, ran, syncs = [], [], [], [], []
    label = f"step_graph_llm_{'eager' if step_graph is False else 'graph'}"

    def timed_step():
        i = eng.decode_steps
        if GRAPH_PROFILE_FROM <= i < GRAPH_PROFILE_FROM \
                + GRAPH_PROFILED_STEPS:
            counted = CountedStep()
            out, by_name, counts = host_launches(torch, step)
            ran.append(counted.read(by_name))
            prof.append(counts)
            names.append(by_name)
            return out
        if 20 <= i < 23:
            before = eng.host_syncs + eng.decoder.host_syncs
            out, flagged, sources, in_port = sync_flags(torch, step)
            syncs.append({"flagged_in_port": in_port, "flagged": flagged,
                          "counted": eng.host_syncs + eng.decoder.host_syncs
                          - before, "sources": sources})
            return out
        t0 = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        return out

    eng.step = timed_step
    done = eng.run(reqs)
    if len(done) != wl.requests or len(syncs) != 3 \
            or len(prof) != GRAPH_PROFILED_STEPS:
        raise AssertionError(f"{len(done)} requests, {len(syncs)} sync "
                             f"windows, {len(prof)} profiles")
    return SimpleNamespace(tokens=[list(r.generated) for r in reqs],
                           walls=walls, prof=prof, names=names,
                           held=hold_counts(label, ran), syncs=syncs,
                           eng=eng)


def phase_step_graph_llm(torch, wl, model):
    """qwen3-0.6b whole under the decode gate, LLMWorkload's defaults,
    eager and as a graph (8b in the docstring): tokens equal, syncs flagged
    in the port per decode step L + 1 and 1, launches and wall."""
    t0 = time.perf_counter()
    eager = llm_path(torch, wl, model, False)
    graph = llm_path(torch, wl, model, None)
    per = {k: [s["flagged_in_port"] for s in p.syncs]
           for k, p in (("eager", eager), ("graph", graph))}
    counted = {k: [s["counted"] for s in p.syncs]
               for k, p in (("eager", eager), ("graph", graph))}
    same = eager.tokens == graph.tokens
    emit({"phase": "step_graph_llm", "arch": model.cfg.name,
          "requests": wl.requests, "tokens_equal": same,
          "syncs_flagged_in_port_per_decode_step": per,
          "syncs_counted_per_decode_step": counted,
          "sources": {"eager": eager.syncs[0]["sources"],
                      "graph": graph.syncs[0]["sources"]},
          "launches_per_decode_step": {"eager": mean_counts(eager.prof),
                                       "graph": mean_counts(graph.prof)},
          "wrapper_counts_held": {"eager": eager.held,
                                  "graph": graph.held},
          "device_kernels_eager_minus_graph": name_gap(eager.names,
                                                       graph.names),
          "wall_ms_per_decode_step": {
              "eager": 1e3 * float(np.mean(eager.walls)),
              "graph": 1e3 * float(np.mean(graph.walls))},
          "decode_steps_per_s": {"eager": 1.0 / float(np.mean(eager.walls)),
                                 "graph": 1.0 / float(np.mean(graph.walls))},
          "graph_replays": graph.eng.graphs.replays,
          "decode_steps": graph.eng.decode_steps,
          "seconds": time.perf_counter() - t0, "card": smi()})
    layers = model.cfg.num_layers
    conds = {"eager": (eager.held["if_nodes_per_step"],
                       eager.held["set_if_all_ran_per_step"]),
             "graph": (graph.held["if_nodes_per_step"],
                       graph.held["set_if_all_ran_per_step"])}
    emit({"phase": "step_graph_llm_if_nodes",
          "if_nodes_and_set_if_all_per_decode_step": conds})
    if conds != {"eager": (0, 0.0), "graph": (2 * layers, float(layers))}:
        raise AssertionError(f"decode step IF nodes and set_if_all kernels "
                             f"{conds}")
    want = {"eager": [layers + 1] * 3, "graph": [1] * 3}
    if per != want or counted != want:
        raise AssertionError(f"decode step syncs flagged {per}, counted "
                             f"{counted}, expected {want}")
    if not same:
        raise AssertionError("the graph path's tokens differ from the eager "
                             "path's")


STEP_GRAPH_LLM_TIMEOUT_S = 600


def step_graph_llm_child() -> None:
    """phase_step_graph_llm on a fresh qwen3-0.6b under the decode gate
    (LLMWorkload's defaults, warmed up), the settings of main."""
    import torch
    from repro_torch.launch.serve import LLMWorkload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    wl = LLMWorkload(fastcache=True)
    model = wl.build_model(torch.device("cuda"))
    wl.warm_up(model)
    phase_step_graph_llm(torch, wl, model)


def run_step_graph_llm() -> None:
    """step_graph_llm_child in a process of its own, its lines printed.
    Late in this process torch.profiler lost the records of some of an
    eager decode step's kernels at every profiled step (one saliency_delta
    and one linear_blend of 28, with the step's wrappers counted whole);
    a fresh process kept them all, so the launch counts are held there."""
    import os
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    try:
        proc = subprocess.run(
            [sys.executable, "-c",
             "import chip_smoke; chip_smoke.step_graph_llm_child()"],
            cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=STEP_GRAPH_LLM_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise AssertionError("step_graph_llm: no result within "
                             f"{STEP_GRAPH_LLM_TIMEOUT_S} s") from e
    print(proc.stdout, end="", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"step_graph_llm: its process exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # every module of the port is imported before anything is printed
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.core import statcache
    from repro_torch.core.policies.base import summarize_stats
    from repro_torch.core.runner import CachedDiT
    from repro_torch.diffusion.schedule import (ddim_step, ddim_timesteps,
                                                linear_schedule)
    from repro_torch.cuda_kernels import build, ref, route
    from repro_torch.cuda_kernels.fused_gate import fused_gate
    from repro_torch.cuda_kernels.knn_density import knn_density
    from repro_torch.cuda_kernels.token_merge import (merge_assign,
                                                      unmerge_scatter)
    from repro_torch.cuda_kernels.flash_attention import flash_attention
    from repro_torch.cuda_kernels.linear_blend import linear_blend
    from repro_torch.cuda_kernels.saliency_delta import saliency_delta
    from repro_torch.cuda_kernels.cond_node import if_all
    from repro_torch.core.runner import l2c_mask_from_deltas
    from repro_torch.core import saliency as core_saliency
    from repro_torch.core import token_merge as core_token_merge
    from repro_torch.core.policies import base as core_policy_base
    from repro_torch.core.linear_approx import calibrate_dit
    from repro_torch.launch.calibrate import fit_batches
    from repro_torch.obs import (DEFAULT_AUDIT_FRACTION, MetricsCollector,
                                 TraceRecorder, parse_prometheus,
                                 record_calibration, validate_trace)
    from repro_torch.obs import audit as obs_audit
    from repro_torch.obs import metrics as obs_metrics
    sal_mod = importlib.import_module("repro_torch.cuda_kernels.saliency_delta")
    fg_mod = importlib.import_module("repro_torch.cuda_kernels.fused_gate")
    lb_mod = importlib.import_module("repro_torch.cuda_kernels.linear_blend")
    cond_mod = importlib.import_module("repro_torch.cuda_kernels.cond_node")
    fastcache_mod = importlib.import_module(
        "repro_torch.core.policies.fastcache")
    knn_mod = importlib.import_module("repro_torch.cuda_kernels.knn_density")
    tm_mod = importlib.import_module("repro_torch.cuda_kernels.token_merge")
    from repro_torch.launch.serve import LLMWorkload, serve as llm_serve
    from repro_torch.launch.serve import GATE_NEEDS_ATTENTION, exact_fallback
    from repro_torch.models.transformer import MIXERS as SSM_MIXER_FNS
    from repro_torch.launch.serve_diffusion import Workload
    from repro_torch.models import attention
    from repro_torch.models import layers as moe_layers
    from repro_torch.serving.scheduler import (DiffusionRequest, percentile,
                                               summarize_by_class)
    from repro_torch.serving.slo import StepTimer
    from repro_torch import checkpoint as ckpt_io
    from repro_torch import tree as port_tree
    from repro_torch.configs import get_config
    from repro_torch.data import latent_stream, token_stream
    from repro_torch.launch.train import data_for, init_model
    from repro_torch.models.dit import DiTModel
    from repro_torch.training import loop as train_loop
    from repro_torch.training import optimizer as train_optimizer
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.distributed.sharding import mesh_extents
    from repro_torch.launch import dryrun as dryrun_mod
    from repro_torch.launch import specs as specs_mod
    from repro_torch.launch.mesh import abstract_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    emit({"phase": "settings",
          "matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction})

    card = smi()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    emit({"phase": "device", "nvidia_smi": card, "torch": torch.__version__,
          "torch_cuda": torch.version.cuda, "nvcc": nvcc,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t_start = time.perf_counter()
    sweep = start_dryrun_sweep()
    phase_build(build)
    dev = torch.device("cuda")
    gate_row, gate_split_row = phase_fused_gate(torch, dev, fused_gate, ref,
                                                statcache, 128, build)
    phase_fused_gate(torch, dev, fused_gate, ref, statcache, 64, build)
    k = SimpleNamespace(ref=ref, knn_density=knn_density,
                        merge_assign=merge_assign,
                        unmerge_scatter=unmerge_scatter)
    merge_rows = phase_token_merge(torch, dev, k, build)
    sal_rows = phase_saliency_delta(torch, dev, ref, sal_mod, build)
    blend_rows = phase_linear_blend(torch, dev, ref, linear_blend, build)
    phase_gemv_crossover(torch, dev, lb_mod, route)
    blend_split_row = phase_linear_blend_split(torch, dev, ref, linear_blend,
                                               lb_mod, build)[0]
    cond_rows = phase_cond_node(torch, dev, ref, cond_mod, fg_mod, statcache,
                                build)
    sal_row, blend_row = sal_rows[0], blend_rows[0]
    (gemv_row,) = [r for r in blend_rows if r["shape"] == [4, 1024, 1024]]

    m = SimpleNamespace(
        CachedDiT=CachedDiT, FastCacheConfig=FastCacheConfig,
        percentile=percentile, summarize_stats=summarize_stats,
        linear_schedule=linear_schedule, ddim_timesteps=ddim_timesteps,
        ddim_step=ddim_step, l2c_mask_from_deltas=l2c_mask_from_deltas,
        DEFAULT_AUDIT_FRACTION=DEFAULT_AUDIT_FRACTION,
        MetricsCollector=MetricsCollector, TraceRecorder=TraceRecorder,
        parse_prometheus=parse_prometheus, validate_trace=validate_trace,
        record_calibration=record_calibration, calibrate_dit=calibrate_dit,
        fit_batches=fit_batches,
        obs_audit=obs_audit, obs_metrics=obs_metrics,
        DiffusionRequest=DiffusionRequest, StepTimer=StepTimer,
        summarize_by_class=summarize_by_class,
        fastcache_mod=fastcache_mod,
        kernels=kernel_wrappers())
    wl = Workload()
    wl_merge = dataclasses.replace(wl, merge_ratio=MERGE_RATIO)
    t0 = time.perf_counter()
    model = wl.build_model(dev)
    torch.cuda.synchronize()
    emit({"phase": "model", "arch": model.cfg.name,
          "params": sum(p.numel() for p in model.parameters()),
          "dtype": str(model.dtype), "init_s": time.perf_counter() - t0})

    sal_modules = (core_saliency, core_policy_base)
    syncs_off = phase_syncs(torch, wl, model)
    base = phase_serve(torch, dev, wl, model, m)
    launches = base.launches
    syncs_on = phase_syncs(torch, wl_merge, model, label="syncs_merge")
    if syncs_on != syncs_off:
        raise AssertionError(f"syncs per model step (counted, flagged in "
                             f"the port): "
                             f"{syncs_on} with merge on, {syncs_off} off")
    launches_merge = phase_serve(torch, dev, wl_merge, model, m,
                                 label="serve_merge").launches
    phase_static(torch, dev, model, m)

    # ---- the six baseline policies on the same serve
    t0 = time.perf_counter()
    policy_kwargs = {"l2c": {"l2c_mask": l2c_calibration(torch, dev, model,
                                                         m)}}
    launches_policy = {}
    for p in ("nocache",) + BASELINES:           # nocache: the yardstick
        wl_p = dataclasses.replace(wl, policy=p,
                                   policy_kwargs=policy_kwargs.get(p, {}))
        phase_syncs(torch, wl_p, model, label=f"syncs_{p}")
        launches_policy[p] = phase_serve(torch, dev, wl_p, model, m,
                                         label=f"serve_{p}").launches
    emit({"phase": "policies", "seconds": time.perf_counter() - t0})
    # the warm step eager and as a graph; the route-parity recorders ride
    # the eager serves
    phase_step_graph_dit(torch, dev, wl, model, m, sal_mod, knn_mod, tm_mod,
                         sal_modules, core_token_merge)
    phase_quality(torch, dev, model, m, policy_kwargs)

    # ---- the observability plane and the calibration on the DiT path
    t0 = time.perf_counter()
    launches_audit = phase_audit(torch, dev, wl, model, m, base, syncs_off)
    launches_metrics = phase_metrics(torch, dev, wl, model, m, base)
    launches_record, launches_fitted = phase_calibrate(
        torch, dev, wl, model, m, fg_mod, lb_mod, ref)
    launches_nocfg = phase_serve_nocfg(torch, dev, wl, model, m)
    phase_trace(torch, dev, wl, model, m)
    emit({"phase": "observability", "seconds": time.perf_counter() - t0})

    # ---- the SLO plane: preempt / resume and the prioritised serve
    t0 = time.perf_counter()
    launches_preempt = phase_preempt_resume(torch, dev, wl, model, m,
                                            "preempt_resume")
    launches_preempt_merge = phase_preempt_resume(
        torch, dev, wl_merge, model, m, "preempt_resume_merge")
    launches_slo = phase_slo_serve(torch, dev, wl, model, m)
    emit({"phase": "slo", "seconds": time.perf_counter() - t0})

    # ---- serving past one device: the sharded engine on (1, 1) and on two
    # ranks sharing the card
    t0 = time.perf_counter()
    launches_sharded = phase_sharded_serve(torch, dev, wl, model, m, base)
    phase_model_group_probe(torch)
    emit({"phase": "sharded", "seconds": time.perf_counter() - t0})

    # ---- the LLM path: qwen3-0.6b served with the FastCache decode gate
    flash_row = phase_flash_attention(torch, dev, ref, flash_attention,
                                      build)["a"]
    llm = LLMWorkload()
    t0 = time.perf_counter()
    llm_model = llm.build_model(dev)
    torch.cuda.synchronize()
    emit({"phase": "llm_model", "arch": llm_model.cfg.name,
          "params": sum(p.numel() for p in llm_model.parameters()),
          "dtype": str(llm_model.dtype), "init_s": time.perf_counter() - t0})
    llm_fc = dataclasses.replace(llm, fastcache=True)
    phase_llm_syncs(torch, llm_fc, llm_model)
    llm.warm_up(llm_model)
    launches_exact, done_exact = phase_llm_serve(torch, dev, llm, llm_model,
                                                 m, llm_serve)
    launches_llm, done_fc = phase_llm_serve(torch, dev, llm_fc, llm_model, m,
                                            llm_serve)
    agreement("llm_agreement", done_exact, done_fc)
    phase_llm_prefill_parity(torch, dev, llm, llm_model, attention, ref)
    phase_llm_sampled(torch, dev, llm_fc, llm_model, llm_serve)
    run_step_graph_llm()
    del model, llm_model
    torch.cuda.empty_cache()

    # ---- B7 at head dims 80 / 112, the other dense configs and the MoE
    # family at full width, each model freed before the next
    t0 = time.perf_counter()
    new_flash = phase_flash_attention(torch, dev, ref, flash_attention,
                                      build, NEW_FLASH_SHAPES)
    launches_more = phase_more_llms(
        torch, dev, m, SimpleNamespace(LLMWorkload=LLMWorkload), llm_serve,
        moe_layers, attention, ref)
    emit({"phase": "more_llms", "seconds": time.perf_counter() - t0})

    # ---- the hybrid (Jamba) and SSM (xLSTM) families at full width
    t0 = time.perf_counter()
    launches_ssm = phase_ssm_llms(
        torch, dev, m, SimpleNamespace(
            LLMWorkload=LLMWorkload, exact_fallback=exact_fallback,
            GATE_NEEDS_ATTENTION=GATE_NEEDS_ATTENTION),
        llm_serve, moe_layers, attention, ref, get_config, SSM_MIXER_FNS)
    launches_more.update(launches_ssm)
    emit({"phase": "ssm_llms", "seconds": time.perf_counter() - t0})

    # ---- the VLM (Qwen2-VL-2B) and audio (HuBERT-XLarge) families at
    # full size: B7 bidirectional and at Qwen2-VL's prefill, the serves,
    # the encode, the encoder's training
    tr = SimpleNamespace(loop=train_loop, optimizer=train_optimizer,
                         ckpt=ckpt_io, tree=port_tree, DiTModel=DiTModel,
                         get_config=get_config, init_model=init_model,
                         data_for=data_for, latent_stream=latent_stream,
                         token_stream=token_stream)
    t0 = time.perf_counter()
    va_flash = phase_flash_attention(torch, dev, ref, flash_attention,
                                     build, VLM_AUDIO_FLASH_SHAPES)
    launches_more.update(phase_vlm_audio(
        torch, dev, m, SimpleNamespace(LLMWorkload=LLMWorkload), llm_serve,
        attention, ref, tr))
    emit({"phase": "vlm_audio", "seconds": time.perf_counter() - t0})

    # ---- attention masked by explicit positions: B7's position mode at
    # Qwen2-VL-2B's image prompt in the reference's M-RoPE layout
    t0 = time.perf_counter()
    pos_flash = phase_flash_positions(torch, dev, ref, flash_attention,
                                      build)
    launches_more["vlm_positions"] = phase_vlm_positions(
        torch, dev, m, SimpleNamespace(LLMWorkload=LLMWorkload), attention,
        ref, flash_attention)
    emit({"phase": "vlm_positions_seconds",
          "seconds": time.perf_counter() - t0})

    # ---- training and checkpoints: DiT-XL/2 and Qwen3-0.6B at full width
    t0 = time.perf_counter()
    trained, params, state, launches_train_dit = phase_train_dit(
        torch, dev, tr, m)
    phase_checkpoint(torch, dev, tr, trained, params, state)
    del params, state
    for p in trained.parameters():
        p.requires_grad_(False)
        p.grad = None
    torch.cuda.empty_cache()
    launches_trained = phase_serve(
        torch, dev, dataclasses.replace(wl, requests=TRAINED_SERVE_REQUESTS),
        trained, m, label="trained_serve", parent_ratio=False).launches
    del trained
    torch.cuda.empty_cache()
    launches_train_llm = phase_train_llm(torch, dev, tr, m)
    emit({"phase": "training", "seconds": time.perf_counter() - t0})

    # ---- LLM training on a mesh: (1, 1) on nccl, two gloo ranks a mesh
    t0 = time.perf_counter()
    launches_more.update(phase_sharded_train(torch, dev, tr, m, dryrun_mod))
    emit({"phase": "sharded_train_total", "seconds":
          time.perf_counter() - t0})

    # ---- prefill and decode of the LLMs on a mesh
    t0 = time.perf_counter()
    launches_more.update(phase_sharded_infer(torch, dev, tr, m, dryrun_mod))
    emit({"phase": "sharded_infer_total", "seconds":
          time.perf_counter() - t0})

    # ---- the SSM and hybrid families' training at full width
    t0 = time.perf_counter()
    launches_more.update(phase_train_ssm(torch, dev, tr, m))
    emit({"phase": "train_ssm_seconds", "seconds": time.perf_counter() - t0})

    # ---- the dry run on the production mesh (meta) and its card tie
    t0 = time.perf_counter()
    launches_more["dryrun"] = phase_dryrun(
        torch, dev, tr, m, SimpleNamespace(
            dryrun=dryrun_mod, specs=specs_mod, SHAPES=SHAPES,
            abstract_mesh=abstract_mesh, mesh_extents=mesh_extents), sweep)
    emit({"phase": "dryrun_seconds", "seconds": time.perf_counter() - t0})

    # ---- the port's examples at their defaults
    t0 = time.perf_counter()
    launches_more.update(phase_examples(torch, m))
    emit({"phase": "examples", "seconds": time.perf_counter() - t0})

    # launches: each kernel on its own main path (fused_gate, saliency_delta
    # and linear_blend: the merge-off fastcache serve; the merge kernels:
    # the merged serve; flash_attention: the LLM serve with the decode
    # gate); every serve's counts too
    gate_row["launches"] = launches["fused_gate"]
    for row in merge_rows:
        row["launches"] = launches_merge[row["name"]]
    flash_row["launches"] = launches_llm["flash_attention"]
    sal_row["launches"] = launches["saliency_delta"]
    blend_row["launches"] = launches["linear_blend"]
    # the split route's rows: the fitted serve on the graph path
    gate_split_row["launches"] = launches_fitted[
        "serve_calibrated_graph"]["fused_gate"]
    blend_split_row["launches"] = launches_fitted[
        "serve_calibrated_graph"]["linear_blend"]
    # the IF nodes: with a condition kernel of their own, on the teacache
    # serve's replays (its whole-stack skip); fed by fused_gate, the main
    # serve's replays' nodes (no kernel); two-sided pairs, the gated LLM
    # serve's condition kernels (one a pair)
    cond_rows[0]["launches"] = launches_policy["teacache"]["if_all"]
    cond_rows[0]["launches_are"] = "serve_teacache's condition kernels"
    cond_rows[1]["launches"] = base.if_nodes
    cond_rows[1]["launches_are"] = ("the main serve's IF nodes, each set by "
                                    "fused_gate: no kernel of their own")
    cond_rows[2]["launches"] = launches_llm["if_all"]
    cond_rows[2]["launches_are"] = ("llm_serve_fastcache's condition "
                                    "kernels, two IF nodes each")
    # the decode gate's linear_blend, on the gemv route
    gemv_row["launches"] = launches_llm["linear_blend"]
    # the new head dims' bf16 rows: flash_attention on the serve of the
    # config that has the head dim (stablelm-3b: 80, kimi: 112)
    new_flash["e"]["launches"] = launches_more[
        "llm_serve_stablelm_fastcache"]["flash_attention"]
    new_flash["g"]["launches"] = launches_more[
        "llm_serve_kimi_fastcache"]["flash_attention"]
    # Jamba's prefill shape: its exact serve (1 attention layer x 8)
    new_flash["j"]["launches"] = launches_more[
        "llm_serve_jamba_exact"]["flash_attention"]
    # the fourteenth slice's: B7 bidirectional at HuBERT's heads (its
    # encode) and at Qwen2-VL's prefill, B5 / B6 at d 1536 (its gated
    # serve)
    va_flash["k"]["launches"] = launches_more["hubert_encode"][
        "flash_attention"]
    va_fc = launches_more["llm_serve_qwen2_vl_fastcache"]
    va_flash["m"]["launches"] = va_fc["flash_attention"]
    vlm_rows = [va_flash["k"], va_flash["m"]]
    for row in sal_rows + blend_rows:
        if row["shape"] in ([4, 1, 1536], [4, 1536, 1536]):
            row["launches"] = va_fc[row["name"]]
            vlm_rows.append(row)
    if len(vlm_rows) != 4:
        raise AssertionError(f"{len(vlm_rows)} of the 4 rows at Qwen2-VL's "
                             "and HuBERT's shapes")
    # the fifteenth slice's: B7's position mode at Qwen2-VL's image prompt
    # (vlm_positions: every attention layer's launch)
    pos_flash["p"]["launches"] = launches_more["vlm_positions"][
        "flash_attention"]
    rows = ([gate_row, gate_split_row] + merge_rows
            + [sal_row, blend_row, blend_split_row, flash_row,
               new_flash["e"], new_flash["g"], new_flash["j"]]
            + vlm_rows + [pos_flash["p"], gemv_row] + cond_rows)
    for row in rows:
        key = row.get("wrapper", row["name"])
        row["serve_launches"] = {
            "serve": launches[key],
            "serve_merge": launches_merge[key],
            **{f"serve_{p}": n[key]
               for p, n in launches_policy.items()},
            "serve_audit_1_32": launches_audit[DEFAULT_AUDIT_FRACTION][
                key],
            "serve_audit_1": launches_audit[1.0][key],
            "serve_metrics": launches_metrics[key],
            "calibrate_record": launches_record[key],
            **{label: n[key]
               for label, n in launches_fitted.items()},
            "serve_nocfg": launches_nocfg[key],
            "preempt_resume": launches_preempt[key],
            "preempt_resume_merge": launches_preempt_merge[key],
            "slo_serve": launches_slo[key],
            **{label: n[key]
               for label, n in launches_sharded.items()},
            "llm_serve_exact": launches_exact[key],
            "llm_serve_fastcache": launches_llm[key],
            "train_dit": launches_train_dit[key],
            "trained_serve": launches_trained[key],
            "train_llm": launches_train_llm[key],
            **{label: n.get(key, 0)
               for label, n in launches_more.items()}}
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
