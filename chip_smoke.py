#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero (nothing is caught):

  1. build    — compile the port's CUDA kernels from the sources in this
                checkout (one nvcc per source, all started together,
                sm_90a) and print the card's name and power limit; K4's,
                the paged sweep's, the ring sweep's, the latent sweep's
                and K8's bf16 kernels must hold HMMA (tensor-core)
                instructions and their fp32 ones (K8's fp32 state pass
                too) none (``cuobjdump -sass``; no bf16 instantiation of
                a CUDA-core kernel may remain); K4's backward holds HGMMA
                (``wgmma``) in its bf16 dk / dv and dq kernels at (64,
                64), (120, 120) and (128, 128), HMMA in the ``mma.sync``
                ones kept at (192, 128), neither in fp32; K8's backward
                kernels (``csrc/ssd_scan_bwd.cu``): the fp32 ones on the
                CUDA cores (no HMMA), the bf16 d h_in and chunk kernels
                on the tensor cores (HMMA), no bf16 instantiation of a
                CUDA-core kernel; the paged and ring sweeps', K8's
                (forward and backward), K9's and K4's backward kernels
                must not spill
                (``-Xptxas -v``), and each form of the first four and of
                K4's backward prints its blocks per SM, shared memory and
                registers;
  2. kernels  — hold every kernel against its plain PyTorch version on the
                same inputs, tolerance atol = rtol = 2e-2 for bf16 (1e-4
                for fp32).  The paged K-sweep (decode / split decode /
                verify with candidates) and the K-merge at the engine's
                shapes (Hq 9, Hkv 3, head_dim 64, page 16, 4 slots), plus
                deep 4k-position cases, a window / logit-cap case, fp32
                and head_dim-128 cases; table ids past a request's length
                must never be read, and a bad id inside it must stop the
                kernel.  The ring sweep (decode, and verify with Q = 4) at
                the batch path's shapes (ring of 545 slots, n_splits 1, 3,
                5, the engine's count and one past the blocks), wrapped,
                at pos 0, window / logit-cap, ragged per-row positions,
                head_dim 128 and deep 4096-slot cases, and the tensor-core
                kernel's edges: the zoo's heads wrapped (G 7, G 1),
                gemma2's global ring of 4369 slots (blocks of 17, cap
                50), a prime ring of 557 (blocks of 1), wrapped verify
                rows that differ inside one running block, the engine's
                private rings of 48 slots with per-row positions, bf16
                and fp32, and the ring sweep's largest bf16 error over
                every case; a custom ring ``k_pos`` on the card must
                raise.  The
                prefill flash attention (K4) at smollm's 8 x 512, gemma2's
                shape over 8192 keys with and without its 4096 window (cap
                50, scale 144^-0.5), a q_offset case and ragged Sq 37 and
                1000, in bf16 and fp32 (rows that see no key: finite); the
                fused RMSNorm (K9) at ``RMS_WIDTHS`` (every width the zoo
                normalizes, and widths reaching each launch shape the
                wrapper picks: rows of a few lanes, a warp, several warps,
                several rows a block, ragged rows, the two-pass kernel
                past 8192), both forms, 1 to 8192 rows (65536 at 576); the
                chunked SSD scan (K8) at mamba2-370m's heads (H 32, P 64,
                N 128) at ``SSD_CASES``: G 1, 2 and 4, S of 512, 4000
                (ragged), 300, 200, 128, 37, 32 and 1, chunks of 128, 100,
                37, 16 and 1 (padded inside to a multiple of 16; chunks of
                one step in groups), with and without D, with and without
                an initial state, y with and without the final state
                returned, and at zamba2-1.2b's heads (H 64, P 64, N 64:
                8 x 512, a ragged 37 with an initial state, G 2 with
                chunks of 100), at atol = rtol = 2e-2 in bf16 and 1e-3 in
                fp32
                (the order of the JAX tests' chunked-vs-sequential 2e-3:
                the sums run in another order); deepseek-v2's latent
                sweep (Hq 128, latent rows of 576, values of 512, pages
                of 16): decode with 1,
                the engine's and 5 splits, deep 4096-position tables,
                verify with Q 4 and 16 and pending rows, ragged
                positions, and the tensor-core kernel's edges (Hq 20,
                pages of 8 and 32, page-edge positions, splits past the
                request, cap 50, verify at pos 0 with Q 40 and Q 17),
                bf16 and fp32, its partials merged at Dv 512,
                ids past a request never read and a bad id inside it
                stopping the kernel; K4 at (D, Dv) = (192, 128) (4 x 512,
                ragged Sq 37, a q_offset case) and K9 at widths 512 and
                1536; the int8 templates of the paged and ring sweeps
                (int8 caches with per-row fp32 scales) against their twins
                on the same int8 caches: paged decode (1 and 5 splits) and
                verify Q 16 (1 and 5) at the engine's shapes, ring decode
                and verify Q 4 (1, 3, the engine's count, one past the
                blocks) on a wrapped ring of 545, head_dim 64, 120 (3 kv
                heads: odd rows 8 bytes off 16) and 128, and at h2o's
                per-row positions under its 4096 window, llava's G 7,
                stablelm's G 1 and gemma2's 4369-slot ring with cap 50, q
                bf16 and fp32, each run proved to have launched the int8
                template; the bad-id probe again on the int8 template.  head_dim 120 (h2o-danube-3: Hq 32, Hkv
                8): K4 over 8192 keys with and without the 4096 window,
                with a q_offset, ragged Sq 37 and 1000; the ring sweep
                (decode 1 and 3 splits, verify Q 4) on a wrapped 4096-slot
                ring with per-row positions; the paged sweep (decode 1, the
                auto count and 5 splits, verify Q 16) and the bad-id probe
                at 120; K4 at llava-next's G 7 (Hq 56, Hkv 8), 4 x 512 and
                ragged; K4 at the tensor-core kernel's tile edges (Sk 65
                and 127, Sq 1 at G 2 and G 1, D 120 with Sk 17, G 7 with
                Sq 19, B 3 with ragged Sk 100, non-causal Sq 16 over Sk
                65, stablelm's G 1, and (192, 128) ragged at Sq = Sk =
                1000), each case's error printed and K4's largest bf16
                error over all of them; G 1 at D 64 as musicgen-medium
                (24 / 24 heads: 8 x 512 and ragged Sq 37) and zamba2's
                shared block (32 / 32: 8 x 512) run it; musicgen's heads
                on the paged sweep (decode and verify Q 16) and on the
                ring sweep at its batch path's 8 x 545 (mid-run and
                wrapped), and zamba2's shared buffers on the ring sweep
                (4 slots of 48 rows, one position per row, no window, a
                row past its buffer); K9 at widths 2048, 3840, 4096 and
                7168; the paged sweep at its tensor-core kernel's edges
                (G 4 with Q 17 and Q 128, pages of 8, positions at page
                edges, splits wholly past a request, a window of 8 under
                a verify block of 16, gemma2's 32 / 16 of 128 with cap 50),
                in bf16 and fp32, and its largest bf16 error over every
                case printed; head_dim
                96 raises ValueError in both sweeps, launching nothing.
                The merge folded into the split sweeps (``merge=True``):
                at every split case above, and at ``fused_forms`` (the
                paged and ring sweeps at D 64, 120 and 128, q bf16 and
                fp32, kv rows in q's dtype and int8, decode and verify;
                the latent sweep at Dv 512, bf16 and fp32, decode and
                verify) at S 2, 3, 5 and 16 with an empty split, the
                fused output must equal ``lse_merge`` of the unfused
                launch's partials bit for bit and lie within the
                tolerance of the plain version, 3 launches in a row and
                2 x 20 launches
                captured in a CUDA graph must give the same bits, and the
                counter workspace must read all zero after each case;
  3. reference — full-width smollm-135m at fp32, twice on the kernels and
                twice on the plain torch path (chunked prefill twin,
                RMSNorm oracle, torch decode backends, the same split
                counts): the engine (Poisson trace with prefix hits) and
                the static batch (8 requests x 512 prompt tokens + 32
                decode steps) must give equal greedy streams and every
                logits call within 1e-3; on the kernels, the batch's
                n-gram speculative loop (K 3) must emit the plain kernel
                loop's stream past the ring's end, and a replay drafter of
                that stream must be accepted in full.  Then gemma2-27b at
                full width and fp32, cut to 2 local/global units (4
                layers), the same way: the batch of 2 x 4352 prompt tokens
                + 16 new (the window masks prefill, the local rings wrap)
                and the engine on a trace whose requests pass 4096
                positions (the private rings wrap at inject and in
                decode).  Then mamba2-370m at full width and depth in
                fp32: the static batch (8 x 512 prompt tokens + 32 decode
                steps) and the engine on a Poisson trace of 8 requests
                over 4 slots with two preemptions forced (its state slots
                have no page pool to run dry, so the run refuses the pages
                itself, identically on both paths).  Then deepseek-v2 at
                full width in fp32, cut to 3 layers (1 dense + 2 MoE):
                the batch of 2 x 256 prompt tokens (the MoE drops pairs
                past its capacity) + 15 decode steps, and the engine on 6
                Poisson requests over 4 slots with prefix hits (the
                latent verify form) and two forced preemptions.  Then
                smollm-135m's int8 KV pages at fp32 compute: the int8
                engine on the kernels against the int8 engine on the
                plain twins (streams equal, logits within 1e-3), and a
                tight pool of 10 pages with the host tier on against it
                off, for int8 and for bf16 pools (streams equal, pages
                paged out and back).  Then the zoo at full width and
                fp32, cut to 2 layers: h2o-danube-3's batch of 2 x 4352 +
                16 new (the 4096 window masks prefill, the rings wrap) and
                its engine on requests past 4096 positions; stablelm,
                phi3.5-moe and llava-next on 2 x 512 + 16 new and on 6
                Poisson requests with prefix hits; musicgen-medium (4
                codebooks) and zamba2-1.2b (one unit: 2 Mamba2 layers and
                its shared block) on 2 x 512 + 16 new and on 6 Poisson
                requests without prefix hits (the prefix cache serves
                neither);
  4. main paths — ``repro_torch.launch.serve`` at full width (bf16,
                random weights from a seed drawn on the card, FROST plane
                on): smollm-135m's engine on a Poisson trace of 8 requests
                over 4 slots with 2 shared 32-token prompt heads, its
                static batch of 8 requests (512 prompt tokens, 33 new),
                the same with ``--spec-k 3``, the Poisson run with
                ``--spec-k 3``, and three int8 Poisson runs (``--kv-dtype
                int8``; with ``--spec-k 3``; with ``--host-tier --n-pages
                10``, which must page out and back, every page moved
                being 195,840 bytes); then gemma2-27b (46 layers, 54.5 GB of
                weights): the batch of 4 x 512 prompt tokens + 33 new, the
                engine on 8 Poisson requests over 4 slots, and the long
                batch of 2 x 4352 + 17 new; then mamba2-370m (48 layers):
                the batch of 8 x 512 + 33 new, the engine on 8 Poisson
                requests over 4 slots, and the long batch of 2 x 4000 + 17
                new (32 chunks, the last ragged); then deepseek-v2 at full
                width cut to 8 layers (1 dense + 7 MoE, 54.1 GiB of
                weights), through ``serve(args, cfg)``: the batch of 4 x
                512 + 33 new and the engine on 8 Poisson requests over 4
                slots with 2 shared 32-token prompt heads; then
                h2o-danube-3-4b (24 layers, head dim 120): the batch of 4
                x 512 + 33 new, the same with ``--spec-k 3``, and the
                engine on 8 Poisson requests over 4 slots; stablelm-1.6b
                (the batch of 8 x 512 + 33 new), phi3.5-moe cut to 24 of
                its 32 layers through ``serve(args, cfg)`` and
                llava-next-34b at its 60 layers (batches of 4 x 512 + 33
                new), each also on the engine with 2 shared 32-token
                prompt heads; musicgen-medium (48 layers, 4 codebooks) and
                zamba2-1.2b (38 Mamba2 layers, 19 applications of its
                shared block) at full width and depth, each on the batch
                of 8 x 512 + 33 new and on 8 Poisson requests over 4
                slots, pages of 16, no shared heads.  The launch counts
                are zeroed just before
                each run and read just after it.  Every request must
                finish its token budget with finite logits, no peak may
                pass the card's 79.1 GiB, and every kernel of a path must
                have been launched on it: K4 and K9 on the twenty-five
                attention paths, K8 and K9 on the three mamba2 paths and
                the two zamba2 paths (the ring sweep on both: its shared
                block's rings, and on the engine its buffers with per-row
                positions), the
                latent sweep's decode and verify forms and the fused merge
                (``merge_fused``) on deepseek's engine, the int8 templates
                (and never the bf16 sweep) on the int8 paths, the ring
                sweep on h2o's (its verify form with ``--spec-k 3``), the
                paged sweep and the fused merge on the zoo's engines; no
                path may launch the standalone merge (``merge``);
  5. timing   — CUDA-event times of each kernel, its plain version and a
                library yardstick at the main paths' shapes, beside the
                least time the card could take (the paged sweep at
                ``PAGED_FORMS``: decode and verify Q 16 at the engine's
                split count and at 1 split, bf16 and int8 pools at D 64
                and 120, gemma2's, llava's G 7, stablelm's G 1 and deep
                4096-position tables; the latent sweep at ``MLA_TIMED``
                (decode at the engine's split count and at 1 split,
                verify Q 16) beside SDPA over the gathered latent as one
                kv head; K4 on a row
                of its own at each of ``K4_SHAPES`` beside SDPA; the int8
                sweeps at the
                bf16 rows' shapes, bound at D + 4 bytes a kv row, beside
                SDPA over the cache dequantized to bf16 beforehand); both
                sweeps at head_dim 120 in bf16 and int8 (paged at the
                engine's shapes, ring at h2o's batch shape), the ring
                sweep's rows at the engine's split count and at 1 split
                (``ring_rows``) and at the engine's private rings (4 x 48
                slots, per-row positions), the merge at Dv 120, K9 at
                ``RMS_TIMED`` (the zoo's prefill widths, decode steps of 4
                and 8 rows beside F.rms_norm; musicgen's 1536 at
                ``RMS_TIMED_NEW``), K8 at ``SSD_TIMED`` (8 x 512, 2 x
                4000 and one engine prompt of 1 x 32) and at zamba2's
                heads (``SSD_ZAMBA_TIMED``), the ring sweep at zamba2's
                shared buffers (``ZAMBA_SHARED``); each split
                form at the main paths' shapes (``merge_forms``): stage 1
                alone, the unfused pair (stage 1, ``lse_merge`` and, for Q
                > 1, the copy of its transposed view) and the one fused
                launch.  A row at the engine's split count times the
                launch the main paths make, the fused one, and its bound
                adds the tail's bytes (partials and log-sum-exps read
                back, the output written); stage 1 alone is said beside
                it.  The ``lse_merge`` rows (Dv 64, and Dv 120 on h2o's
                ring) time the fused tail (the fused launch less stage 1)
                and count the fused launches (``merge_fused``); the
                standalone kernel, which no main path launches, is said
                beside them;
  6. chaos    — crash-restore drills on the engine at smollm-135m's
                published width and depth (random weights from a seed):
                8 requests of 40 to 128 prompt tokens over 2 shared
                32-token heads, 24 to 32 new, 4 slots, pages of 16, a
                snapshot every 2 chunks, under ``CHAOS_SCHEDULE`` (a slot
                crash, a page corruption, a stall, an emergency cap at
                half power, an engine crash after a snapshot).  At fp32
                the restored greedy streams must equal the fault-free
                run's token for token, with one restore, every request's
                budget served, a clean pool audit, degraded steps, a
                silenced heartbeat, paged verify and decode sweeps
                launched after the restore and every requeued request
                restored through the prefix trie.  With bf16 weights,
                int8 pages and the host tier on a pool of 20 pages, the
                restored engine must hold host pages and lose no token
                (how many streams equal the fault-free run's is printed).
                Then the launcher's poisson path with ``--chaos
                CHAOS_SPEC``: one restore and both ``[chaos]`` summary
                lines.  Each drill prints its ``save_snapshot`` walls,
                the snapshot's bytes on disk, the ``restore`` wall and
                its decode rate beside the fault-free run's;
  7. training — (a) the backward kernels of K4 (``flash_attention_bwd``:
                delta, dk / dv by key tile, dq by q tile) and K9
                (``rmsnorm_bwd``) against ``torch.autograd.grad`` of their
                plain versions on the same inputs, max |kernel - plain| /
                max |plain| of each gradient within 2e-2 in bf16 and 1e-4
                in fp32: K4 at ``FA_BWD_CASES`` (smollm's 8 x 512 at G 3,
                gemma2's heads of 128 with window 4096 and cap 50 over
                8192 keys, (120, 120) at G 4, G 7, (192, 128) at G 1,
                ragged Sq 37 and 1000, a q_offset, G 1 at D 64 with
                musicgen's and zamba2's heads at 8 x 512), K9 at every
                width of ``RMS_WIDTHS`` up to 8192, both forms, 4 and
                1000 rows and ``RMS_BWD_LONG`` (musicgen's 4096 x 1536
                among them); the forward with lse bit for bit the
                forward without, two backward runs bit for bit, and the
                forms without a backward (G 128, width 16384) refused.
                (b) smollm-135m's train step at full width and depth,
                batch 8 x 512, three steps on the kernels against the
                plain path (``KernelPolicy(attention="ref",
                rmsnorm="ref")``): fp32 losses within 1e-5 and every
                gradient within 1e-4 of its scale, bf16 losses and
                gradient norms within 2e-2, the backward kernels launched
                once per layer (K4) and per norm (K9) each step.  K8's
                backward (``ssd_scan_bwd``) against its plain twin
                ``ssd_scan_bwd_torch`` at ``SSD_BWD_CASES`` (mamba2's heads
                at 8 x 512 and 2 x 4000, ragged over 32 chunks, S 1 and
                31, G 2, no D, an initial state, dh_T), every gradient
                within 2e-2 (bf16) and 1e-4 (fp32) of its scale, two runs
                bit for bit, chunk 256, N 256 and fp16 refused; through
                ``ssd_scan`` with a gradient, the forward bit for bit the
                forward without.  Then mamba2-370m's train step at full
                width, cut to ``MAMBA_TRAIN_LAYERS`` layers, and
                musicgen-medium's and zamba2-1.2b's, cut to
                ``ZOO_TRAIN_LAYERS``, the same three steps on the kernels
                against the plain path (``KernelPolicy(attention="ref",
                rmsnorm="ref", ssd="chunked")``; K8's backward cases
                include zamba2's heads), each kernel launched
                ``lm_train_launches`` times a step (K8 forward and
                backward once a Mamba2 layer).  (c) The
                main paths ``repro_torch.launch.train`` (``TRAIN_ARGV``:
                smollm-135m, 24 steps of 8 x 512, bf16, FROST on; and
                ``MAMBA_TRAIN_ARGV``: mamba2-370m at full width and depth,
                12 steps of 8 x 512; musicgen-medium and zamba2-1.2b at
                full width and depth, ``ZOO_TRAIN_STEPS`` steps of 8 x
                512): the ``[frost]`` and ``[frost-ctrl]``
                lines, a loss below its first step's, steps/s, tokens/s
                and peak memory, K4, K8 and K9 forward and backward on
                every layer of every step, exactly (``lm_train_launches``).
                (d) The
                backward kernels' times at smollm's training shapes beside
                their plain twins, the library's backward through autograd
                (SDPA's, ``F.rms_norm``'s) and the bound (K4's backward:
                2.5 times its forward's products); each launch of a call
                timed apart (K4: delta, dk / dv, dq; K9: rows, reduce;
                ``torch.profiler``) beside their times before the
                Hopper redesign (``EARLIER_LAUNCHES``); K8's backward at
                ``SSD_BWD_TIMED`` (8 x 512 and 2 x 4000) beside its plain
                twin and its bound (twice the forward's products), each
                of its launches apart beside the CUDA-core design's
                (``EARLIER_SSD_LAUNCHES``), no library call; its bf16
                tensor-core kernels' registers, shared memory and blocks
                an SM; K9's backward at musicgen's 4096 x 1536 and K8's
                at zamba2's heads at 8 x 512 (``zoo_backward_timings``);
  8. CNN zoo  — the paper's 16 CIFAR models (``repro_torch.models.cnn``)
                at their published widths on 32x32x3 ``CifarBatches``
                images in fp32, random weights from ``bridge.init_cnn``
                and a seed, the step ``cnn.loss_and_grads`` then
                ``optim.adamw_update`` with the JAX package's CNN
                optimizer (``cnn.OPTIMIZER``).  No hand-written kernel
                is on this path: the convolutions, batch norms and pools
                are cuDNN's and PyTorch's, as XLA's are in JAX.  (a) For
                each model, cuDNN's TF32 off, one step at batch 8 on the card
                against the same step on the CPU from the same weights:
                in fp64 the loss within 1e-5, every gradient leaf within
                1e-3 of its own scale (a leaf below 1e-10 of the model's
                largest gradient, zero but for rounding, below it on
                both), the params after AdamW within the Adam-eps bound;
                in fp32 the loss within 1e-5 and the logits within 1e-4
                of their largest magnitude, or twice the CPU's own fp32
                error from its fp64 logits where that is larger
                (``CNN_TOL``; fp32 gradients of these nets are too
                ill-conditioned at a batch of 8 to hold leaf by leaf).
                (b) For each model, the library's defaults (cuDNN's TF32
                on, matmuls' off), 12 steps at batch 128: the median
                synchronised step wall of the last 8 with their least and
                most, the mean step split where the host spends it
                (issuing forward and backward, issuing AdamW, waiting for
                the card), images/s, FLOPs a step (``FlopCounterMode``
                over one forward and backward), TFLOP/s, peak memory, the
                loss first to last (it must fall) and accuracy on 2 eval
                batches from index 100, one ``[cnn]`` line a model;
  9. examples — (``examples_phase``) (a) the dry-run
                (``repro_torch.launch.dryrun.run_cells``) over all 33
                cells on the host mesh (one rank, NCCL): every cell
                ``ok``, ``torch.cuda.memory_allocated()`` the same before
                and after (meta tensors), each cell's ``fits`` printed;
                (b) ``repro_torch.examples.serve_batched`` at
                stablelm-1.6b's published width (``SERVE_BATCHED_ARGV``:
                8 x 32 + 24): its ``[frost]`` FLOPs equal
                ``stepcost.serve_step_cost``, K4, K9 and the ring sweep
                launched; (c) the paged sweep at pages of 4 (decode and
                verify Q 16, smollm's and musicgen's heads, bf16 and
                fp32, 1, 2 and the engine's splits) against its plain
                version, then ``serve_model_zoo --full`` on each of
                ``ZOO_EXAMPLE`` (its engine: 2 slots, pages of 4): every
                request served, each arch's kernels
                (``ZOO_EXAMPLE_KERNELS``) launched; (d) ``train_lm_frost
                --full --steps 40 --inject-failure 20`` (smollm-135m, 8 x
                128, ``n_micro`` 2): one restart, a falling loss, K4's
                and K9's backwards launched, steps/s and peak memory; (e)
                over a one-rank NCCL group, ``compressed_psum`` (out
                equal to the plain dequantized value, out + error within
                1e-6 of the input) and ``moe_forward_a2a`` at phi3.5's
                MoE widths, 4 x 64 tokens, bf16, against the local
                ``moe_forward`` within ``TOL``.  Each path's launch
                counts are zeroed just before it, read just after and
                added to the ``kernels`` line (``example <name>``
                families);
 10. sharded  — (``sharded_phase``) (a) the one-rank references: 3 bf16
                train steps of 8 x 128 of ``SHARD_TRAIN_ARCHS``
                (smollm-135m, mamba2-370m, zamba2-1.2b at full width and
                depth) and 4 x
                64 + 16 greedy decodes of ``SHARD_DECODES``
                (smollm-135m and h2o-danube-3-4b in bf16, mamba2-370m and
                zamba2-1.2b in fp32 and in bf16; each also with the
                batch's rows in two halves, no sharding);
                (b) four ranks on this card over gloo as a (2, 2)
                ("data", "model") mesh (``chip_smoke.py --sharded-rank
                DIR``) run the same sharded, held against JAX's bf16
                bounds (``SHARD_TOL``), the decodes fed the one-rank
                tokens (mamba2's bf16 decode printed beside the one-rank
                halves' spread, not held); each rank's train launches
                exactly
                ``lm_train_launches`` a step; the port's collectives on
                the ranks' CUDA tensors; (c) the capacity-shard ring sweep
                + merge row, and K8 forward and backward at the sharded
                train step's local shapes (``SHARD_SSD``) against their
                plain versions and timed, their launches a rank's.

The last two lines are a JSON object of per-kernel numbers and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BPS = 3.35e12          # H100 SXM HBM3, bytes/s (data sheet)
CARD_GIB = 79.1            # device memory PyTorch can allocate on an H100
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor peak, FLOP/s
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
RING_SRC = "src/repro_torch/kernels/csrc/ring_attention.cu"
FA_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
FA_BWD_SRC = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
RMS_SRC = "src/repro_torch/kernels/csrc/rmsnorm.cu"
SSD_SRC = "src/repro_torch/kernels/csrc/ssd_scan.cu"
SSD_BWD_SRC = "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu"
MLA_SRC = "src/repro_torch/kernels/csrc/mla_attention.cu"
LSE_SRC = "src/repro_torch/kernels/csrc/lse_merge.cuh"
# kernel entry -> (source, the Pallas function it replaces, launch key)
KERNELS = {
    "paged_attention_sweep (decode)": (
        PAGED_SRC, "src/repro/kernels/decode_attention.py:1232",
        "sweep_decode"),
    "paged_attention_sweep (verify)": (
        PAGED_SRC, "src/repro/kernels/decode_attention.py:970",
        "sweep_verify"),
    # the merge's device code; its launches on the main paths are the
    # split sweeps' fused tails (the standalone kernel must not run there)
    "lse_merge": (
        LSE_SRC, "src/repro/kernels/decode_attention.py:172",
        "merge_fused"),
    "ring_attention_sweep (decode)": (
        RING_SRC, "src/repro/kernels/decode_attention.py:384", "ring_decode"),
    "ring_attention_sweep (verify)": (
        RING_SRC, "src/repro/kernels/decode_attention.py:682", "ring_verify"),
    "flash_attention": (
        FA_SRC, "src/repro/kernels/flash_attention.py:94", "flash_attention"),
    "rmsnorm": (RMS_SRC, "src/repro/kernels/rmsnorm.py:27", "rmsnorm"),
    # the backward kernels of the training path (phase 7): their launches
    # are the launcher's (phase 7 c)
    "flash_attention_bwd": (
        FA_BWD_SRC, "src/repro/kernels/flash_attention.py:94",
        "flash_attention_bwd"),
    "rmsnorm_bwd": (RMS_SRC, "src/repro/kernels/rmsnorm.py:27",
                    "rmsnorm_bwd"),
    "ssd_scan_bwd": (SSD_BWD_SRC, "src/repro/kernels/ssd_scan.py:76",
                     "ssd_bwd"),
    "ssd_scan": (SSD_SRC, "src/repro/kernels/ssd_scan.py:76", "ssd"),
    "mla_latent_sweep (decode)": (
        MLA_SRC, "src/repro/kernels/decode_attention.py:1483", "mla_decode"),
    "mla_latent_sweep (verify)": (
        MLA_SRC, "src/repro/kernels/decode_attention.py:970", "mla_verify"),
    "paged_attention_sweep int8 (decode)": (
        PAGED_SRC, "src/repro/kernels/decode_attention.py:1232",
        "sweep_decode_int8"),
    "paged_attention_sweep int8 (verify)": (
        PAGED_SRC, "src/repro/kernels/decode_attention.py:970",
        "sweep_verify_int8"),
    "ring_attention_sweep int8 (decode)": (
        RING_SRC, "src/repro/kernels/decode_attention.py:384",
        "ring_decode_int8"),
    "ring_attention_sweep int8 (verify)": (
        RING_SRC, "src/repro/kernels/decode_attention.py:682",
        "ring_verify_int8"),
    # phase 10: one rank's capacity shard swept into partials, then the
    # standalone merge of every rank's (K5b's split form and K2b)
    "ring_attention_sweep shard + lse_merge (decode)": (
        RING_SRC, "src/repro/kernels/decode_attention.py:298",
        "ring_shard_decode"),
}
# the int8 host-tier main path's page pool: small enough that cold prefix
# pages are paged out and back (8 requests over 4 slots, 2 shared heads)
TIER_PAGES = 10
# bytes of one smollm-135m page of 16 rows with int8 k/v and their fp32
# scales: 30 layers x 16 rows x 3 kv heads x (64 + 4) bytes x (k, v)
TIER_PAGE_BYTES = 30 * 16 * 3 * (64 + 4) * 2
# K8's tolerance: fp32 at the order of the JAX tests' chunked-vs-sequential
# 2e-3 (tests/test_kernels.py), since the kernel sums in another order
SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}
# the static batch path of phases 3 to 5: 8 requests, 512 prompt tokens,
# 33 new, so a ring of 545 slots (5 blocks of 109)
BATCH, PLEN, GEN = 8, 512, 33
# gemma2's long prompt: past the local layers' window of 4096, so that the
# window masks prefill and the local rings wrap; its global layers' rings
# hold 4352 + 17 = 4369 = 257 x 17 slots (blocks of 17)
G_LONG = 4352
G_RING = G_LONG + 17
# mamba2's long prompt: 32 chunks of 128, the last one ragged
M_LONG = 4000
# deepseek-v2's latent shapes: 128 heads, latent row 512 + 64, MLA's scale
# of the decompressed head dim 128 + 64
MLA = dict(Hq=128, R=576, r_kv=512, scale=192 ** -0.5)
# h2o-danube-3-4b's attention: 32 q / 8 kv heads of 120, every layer
# windowed at 4096 (its batch rings hold min(max_len, 4096) slots); ring
# positions of four requests at and past the window, per row, as the
# engine's private rings hold them
H2O_HEADS = dict(Hq=32, Hkv=8, D=120)
H2O_WINDOW = 4096
H2O_RING_POS = [4100, 5000, 4095, 3 * 4096 + 17]
# h2o-danube-3's poisson path serves its windowed layers from the engine's
# private rings: 4 slots, rings of max_len 32 + 16 = 48 slots (whole pages
# of 16), one position per row, 1 split (one block of 48)
PRIVATE_RING = dict(B=4, C=48, **H2O_HEADS)
PRIVATE_POS = [20, 31, 40, 47]
# llava-next-34b's attention: 56 q / 8 kv heads of 128 (G 7, which does not
# divide K4's 128 rows: 18 positions a tile)
LLAVA_HEADS = dict(Hq=56, Hkv=8, D=128)
# phi3.5-moe's attention (32 q / 8 kv heads of 128) and stablelm-1.6b's (32
# / 32 of 64, G 1)
PHI_HEADS = dict(Hq=32, Hkv=8, D=128)
STABLELM_HEADS = dict(Hq=32, Hkv=32, D=64)
# musicgen-medium's attention (24 / 24 heads of 64, G 1) and zamba2-1.2b's
# shared block's (32 / 32 of 64, stablelm's heads) and Mamba2 layers' (H
# 64, P 64, N 64: mamba2-370m runs H 32, N 128)
MUSICGEN_HEADS = dict(Hq=24, Hkv=24, D=64)
ZAMBA_HEADS = STABLELM_HEADS
ZAMBA_SSM = dict(H=64, P=64, N=64)
# zamba2's poisson path decodes its shared block against the slots' own
# linear buffers, as rings of max_len 32 + 16 = 48 rows that never wrap
# (the ring sweep, one position per row, no window, 1 split); a row past
# its buffer is a chunk's overrun after its budget
ZAMBA_SHARED = dict(B=4, C=48, **ZAMBA_HEADS)
ZAMBA_SHARED_POS = [20, 31, 40, 47]
# phi3.5-moe at full width cut in depth to fit one card: 24 of its 32
# layers (58.6 GiB of bf16 weights; 32 are 78.0 GiB)
PHI_LAYERS = 24
# the fp32 references of phase 3 cut stablelm, h2o-danube-3, phi3.5-moe,
# llava-next and musicgen to 2 layers at full width, and zamba2 to one
# unit of 2 Mamba2 layers and its shared block
ZOO_REF_LAYERS = 2
# deepseek-v2 at full width cut in depth: 8 layers (1 dense + 7 MoE,
# 54.1 GiB of bf16 weights) on the main paths, 3 (1 dense + 2 MoE, about
# 36 GB of fp32) for the fp32 reference
DS_LAYERS, DS_REF_LAYERS = 8, 3


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# phase 1 helper
# --------------------------------------------------------------------------
def hmma_counts(build, op="HMMA"):
    """Tensor-core instructions per kernel of the built library, by
    mangled name (``cuobjdump -sass``): ``HMMA`` (``mma.sync``) or
    ``HGMMA`` (``wgmma``)."""
    sass = subprocess.run(
        [build.cuda_tool("cuobjdump"), "-sass", str(build.build())],
        capture_output=True, text=True, check=True).stdout
    return {part.split(None, 1)[0]:
            sum(op in line for line in part.splitlines())
            for part in sass.split("Function : ")[1:]}


# kernels that must not spill: the paged and ring sweeps' template, K8's
# and K9's kernels, K4's backward kernels (the Hopper ones too)
NO_SPILL = ("gqa_sweep_kernel", "ssd_", "rmsnorm_", "fa_bwd_")


def sweep_spills(log, markers=NO_SPILL):
    """The kernels named by ``markers`` (the paged and ring sweeps'
    ``gqa_sweep_kernel``, K8's and K9's kernels) whose ptxas report
    (``nvcc -Xptxas -v``) shows spill stores or loads."""
    import re
    name, out = None, []
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name and any(k in name for k in markers) and (
                int(m.group(1)) or int(m.group(2))):
            out.append(name)
    return out


def ssd_forms(counts):
    """Phase 1, K8: its bf16 kernels (scores, chunk states and outputs at
    every P tile) hold HMMA instructions; its fp32 kernel, the CUDA-core
    ``ssd_scan_kernel``, and the fp32 state pass none (``hmma_counts``)."""
    import re
    seen = {}
    for name, n in counts.items():
        if "ssd_scan_cu" not in name:
            continue
        m = re.search(r"(ssd_scores_kernel|ssd_states_kernel|ssd_out_kernel|"
                      r"ssd_pass_kernel|ssd_scan_kernel)(?:ILi(\d+)E)?", name)
        if m is None:
            fail(f"K8: unexpected kernel {name} in the library")
        form = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        seen[form] = n
    want = (["ssd_scores_kernel"]
            + [f"ssd_{k}_kernel<{pt}>" for k in ("states", "out")
               for pt in (16, 32, 64)])
    for form in want + ["ssd_pass_kernel", "ssd_scan_kernel"]:
        n = seen.get(form)
        if n is None:
            fail(f"K8 {form}: no kernel in the library")
        if (n > 0) != (form in want):
            fail(f"K8 {form}: {n} HMMA instructions")
        say(f"K8 {form}: {n} HMMA instructions")
    # the backward's kernels: fp32 the CUDA-core ones (no HMMA), bf16 the
    # tensor-core ones (d h_in and the chunk kernel hold HMMA; the group
    # sum and the two shared kernels have no product); no bf16
    # instantiation of a CUDA-core kernel
    bwd = {}
    for name, n in counts.items():
        if "ssd_scan_bwd_cu" not in name:
            continue
        m = re.search(r"(ssd_bwd_\w+?_kernel)(?:I(f|13__nv_bfloat16)E)?",
                      name)
        if m is None or m.group(2) == "13__nv_bfloat16":
            fail(f"K8 backward: unexpected kernel {name} in the library")
        bwd[m.group(1) + ("<float>" if m.group(2) else "")] = n
    cores = [f"ssd_bwd_{k}_kernel<float>" for k in ("scores", "dhin",
                                                     "chunk", "bc")]
    tensor = ["ssd_bwd_dhin_mma_kernel", "ssd_bwd_chunk_mma_kernel"]
    plain = ["ssd_bwd_bc_sum_kernel", "ssd_bwd_pass_kernel",
             "ssd_bwd_reduce_kernel"]
    for form in cores + tensor + plain:
        n = bwd.get(form)
        if n is None:
            fail(f"K8 backward {form}: no kernel in the library")
        if (n > 0) != (form in tensor):
            fail(f"K8 backward {form}: {n} HMMA instructions")
    if len(bwd) != len(cores + tensor + plain):
        fail(f"K8 backward: kernels {sorted(bwd)}")
    say("K8 backward kernels (HMMA instructions): " + ", ".join(
        f"{form} {bwd[form]}" for form in cores + tensor + plain))


def k4_forms(torch, fa, counts):
    """Phase 1, K4: the tensor cores in the bf16 kernel's code and none in
    the fp32 one (``hmma_counts``; no bf16 instantiation of the CUDA-core
    kernel may remain), and each form's blocks per SM, shared memory and
    registers as the card runs it."""
    import re
    hmma = {}
    for name, n in counts.items():
        dims = re.search(r"Li(\d+)ELi(\d+)E", name)
        if "flash_attention" not in name or dims is None or "fa_bwd" in name:
            continue
        if "flash_attention_kernelI13__nv_bfloat16" in name:
            fail(f"K4: a bf16 instantiation of the CUDA-core kernel is "
                 f"built ({name})")
        kind = ("bfloat16" if "flash_attention_mma_kernelI" in name
                else "float32" if "flash_attention_kernelIf" in name
                else None)
        if kind is None:
            fail(f"K4: unexpected kernel {name} in the library")
        form = (int(dims.group(1)), int(dims.group(2)))
        hmma[kind, form] = n
    for D, Dv in fa.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            kind = str(dtype).split(".")[1]
            n = hmma.get((kind, (D, Dv)))
            if n is None:
                fail(f"K4 ({D}, {Dv}) {kind}: no kernel in the library")
            if (n > 0) != (kind == "bfloat16"):
                fail(f"K4 ({D}, {Dv}) {kind}: {n} HMMA instructions")
            occ = fa.occupancy(D, Dv, dtype)
            if occ["blocks_per_sm"] < 1:
                fail(f"K4 ({D}, {Dv}) {kind}: no block fits an SM")
            say(f"K4 ({D}, {Dv}) {kind}: {n} HMMA instructions, "
                f"{occ['smem_bytes']} B of shared memory, "
                f"{occ['registers']} registers a thread, "
                f"{occ['blocks_per_sm']} blocks an SM")


def k4_bwd_forms(torch, fa, counts, hgmma):
    """Phase 1, K4's backward: at the bf16 forms of ``BWD_WGMMA_ROWS`` its
    dk / dv and dq kernels are the Hopper ones (``fa_bwd_*_wgmma_kernel``)
    and hold HGMMA (``wgmma``) instructions; bf16 (192, 128) keeps the
    ``mma.sync`` kernels (HMMA); the fp32 kernels hold neither; no other
    instantiation is built.  Each kernel's blocks per SM, shared memory
    and registers as the card runs it."""
    import re
    found = {}
    for name in counts:
        m = re.search(r"fa_bwd_(dkdv|dq)_(wgmma_|mma_)?kernelI(f|)Li(\d+)"
                      r"ELi(\d+)E", name)
        if "fa_bwd_d" in name and "delta" not in name and m is None:
            fail(f"K4 backward: unexpected kernel {name} in the library")
        if m is None:
            continue
        kind = {"wgmma_": "wgmma", "mma_": "mma.sync", None: "fp32"}[
            m.group(2)]
        form = (int(m.group(4)), int(m.group(5)))
        if (m.group(1), form, kind) in found:
            fail(f"K4 backward: two {kind} {m.group(1)} kernels at {form}")
        found[m.group(1), form, kind] = (counts[name], hgmma.get(name, 0))
    if len(found) != 4 * len(fa.HEAD_DIMS):
        fail(f"K4 backward: {len(found)} kernels, expected "
             f"{4 * len(fa.HEAD_DIMS)}: {sorted(found)}")
    for D, Dv in fa.HEAD_DIMS:
        bf = "wgmma" if (D, Dv) in fa.BWD_WGMMA_ROWS else "mma.sync"
        for part in ("dkdv", "dq"):
            for kind, dtype in ((bf, torch.bfloat16), ("fp32", torch.float32)):
                n = found.get((part, (D, Dv), kind))
                want = {"wgmma": (False, True), "mma.sync": (True, False),
                        "fp32": (False, False)}[kind]
                if n is None or (n[0] > 0, n[1] > 0) != want:
                    fail(f"K4 backward {part} ({D}, {Dv}) {kind}: (HMMA, "
                         f"HGMMA) {n}")
                occ = fa.bwd_occupancy(D, Dv, dtype, part)
                if occ["blocks_per_sm"] < 1:
                    fail(f"K4 backward {part} ({D}, {Dv}) {kind}: no block "
                         "fits an SM")
                say(f"K4 backward {part} ({D}, {Dv}) {kind}: HMMA {n[0]}, "
                    f"HGMMA {n[1]}, {occ['smem_bytes']} B of shared memory, "
                    f"{occ['registers']} registers a thread, "
                    f"{occ['blocks_per_sm']} blocks an SM")


def sweep_forms(torch, da, counts, sweep="paged"):
    """Phase 1, the paged or ring sweep (one kernel template over two key
    layouts): every (q dtype, cached rows, head dim) form is built, its
    bf16 instantiations hold HMMA instructions and its fp32 ones none
    (``hmma_counts``), and each form's blocks per SM, shared memory and
    registers (at its widest block) as the card runs it."""
    import re
    keys = {"paged": "PagedKeys", "ring": "RingKeys"}[sweep]
    hmma = {}
    for name, n in counts.items():
        if "gqa_sweep_kernel" not in name or keys not in name:
            continue
        m = re.search(r"gqa_sweep_kernelI(13__nv_bfloat16|f)(a|f|S\d*_)"
                      r"Li(\d+)E", name)
        if m is None:
            fail(f"{sweep} sweep: unexpected kernel {name} in the library")
        kind = "bfloat16" if m.group(1) != "f" else "float32"
        hmma[kind, m.group(2) == "a", int(m.group(3))] = n
    rows = "rings" if sweep == "ring" else "pools"
    for D in da.SWEEP_HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            for int8 in (False, True):
                kind = str(dtype).split(".")[1]
                form = f"D {D} q {kind}, {'int8' if int8 else kind} {rows}"
                n = hmma.get((kind, int8, D))
                if n is None:
                    fail(f"{sweep} sweep {form}: no kernel in the library")
                if (n > 0) != (kind == "bfloat16"):
                    fail(f"{sweep} sweep {form}: {n} HMMA instructions")
                occ = da.sweep_occupancy(D, dtype, int8, sweep)
                if occ["blocks_per_sm"] < 1:
                    fail(f"{sweep} sweep {form}: no block fits an SM")
                say(f"{sweep} sweep {form}: {n} HMMA instructions, "
                    f"{occ['smem_bytes']} B of shared memory, "
                    f"{occ['registers']} registers a thread, "
                    f"{occ['blocks_per_sm']} blocks an SM")


def mla_forms(torch, da, counts):
    """Phase 1, the latent sweep: its bf16 forms (every block width of
    ``MLA_ROWS``) are the tensor-core kernel, with HMMA instructions, and
    its fp32 form the CUDA-core kernel, with none; no bf16 instantiation
    of the CUDA-core kernel may remain (``hmma_counts``).  Each form's
    blocks per SM, shared memory and registers as the card runs it."""
    import re
    hmma = {}
    for name, n in counts.items():
        if "mla_latent" not in name:
            continue
        mma = re.search(r"mla_latent_mma_kernelILi(\d+)E", name)
        cores = re.search(r"mla_latent_sweep_kernelI(13__nv_bfloat16|f)"
                          r"Li576ELi512E", name)
        if cores and cores.group(1) != "f":
            fail(f"latent sweep: a bf16 instantiation of the CUDA-core "
                 f"kernel is built ({name})")
        if mma:
            hmma["bfloat16", 16 * int(mma.group(1))] = n
        elif cores:
            hmma["float32", 16] = n
        else:
            fail(f"latent sweep: unexpected kernel {name} in the library")
    for dtype, widths in da.MLA_ROWS.items():
        kind = str(dtype).split(".")[1]
        for rows in widths:
            form = f"latent sweep {kind}, {rows} rows a block"
            n = hmma.get((kind, rows))
            if n is None:
                fail(f"{form}: no kernel in the library")
            if (n > 0) != (kind == "bfloat16"):
                fail(f"{form}: {n} HMMA instructions")
            occ = da.mla_occupancy(dtype, rows)
            if occ["blocks_per_sm"] < 1:
                fail(f"{form}: no block fits an SM")
            say(f"{form}: {n} HMMA instructions, {occ['smem_bytes']} B of "
                f"shared memory, {occ['registers']} registers a thread, "
                f"{occ['blocks_per_sm']} blocks an SM")


# --------------------------------------------------------------------------
# phase 2 helpers
# --------------------------------------------------------------------------
def make_case(torch, np, dev, *, B, Hq, Hkv, D, ps, nb, pos, Q, dtype, seed):
    """Seeded inputs on the card: pools of B * nb shuffled private pages
    plus one scratch page per slot (page ids 0..B-1), ragged ``pos``."""
    rng = np.random.default_rng(seed)
    P = B * nb + B
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)

    bt = (B + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    return {
        "q": r(B, Q, Hq, D), "k_pages": r(P, ps, Hkv, D),
        "v_pages": r(P, ps, Hkv, D), "k_new": r(B, Q, Hkv, D),
        "v_new": r(B, Q, Hkv, D),
        "block_tables": torch.tensor(bt, device=dev),
        "pos": torch.tensor(np.asarray(pos, np.int32), device=dev),
    }


def sweep_args(c, verify):
    args = (c["q"], c["k_pages"], c["v_pages"], c["block_tables"], c["pos"])
    kw = {"k_new": c["k_new"], "v_new": c["v_new"]} if verify else {}
    kw.update({key: c[key] for key in ("k_scale", "v_scale") if key in c})
    return args, kw


def quantize_case(quant, c, keys):
    """The case with its kv ``keys`` (pools or rings) replaced by their int8
    rows, the per-row fp32 scales beside them (``k_scale``, ``v_scale``)."""
    out = dict(c)
    for key, name in zip(keys, ("k_scale", "v_scale")):
        out[key], out[name] = quant.quantize_int8_rows(c[key])
    return out


def note(errs, e, entry, form=None):
    """Keep the largest |kernel - plain| of ``entry`` and, for a form that
    phase 5 times on a row of its own, of ``entry form`` too."""
    for name in (entry,) + ((f"{entry} {form}",) if form else ()):
        errs[name] = max(errs.get(name, 0.0), e)


def max_err(torch, a, b, tol, what):
    """max |a - b|, failing unless allclose at atol = rtol = tol."""
    a, b = a.float(), b.float()
    if not bool(torch.isfinite(a).all()):
        fail(f"{what}: non-finite kernel output")
    err = float((a - b).abs().max())
    if not torch.allclose(a, b, atol=tol, rtol=tol):
        fail(f"{what}: max |kernel - plain| = {err:.3e} > tol {tol}")
    return err


def counters_zero(torch, da, dev, what):
    """The fused merge's counter workspace must read all zero after a
    launch: its last blocks reset every counter they used."""
    n = int(da.merge_counters(dev, 0).count_nonzero())
    if n:
        fail(f"{what}: {n} merge counters left non-zero")


def check_fused(torch, da, call, got, want, tol, what):
    """A split case's fused merge: ``call(merge=True)`` launches the sweep
    that merges its own splits.  Its output (B, Q, Hq, Dv) must be
    contiguous and, bit for bit, the standalone ``lse_merge`` of the
    unfused launch's partials ``got`` (stage 1 writes the same bits
    either way: each split's block computes alone), and lie within
    ``tol`` of the plain merge of the plain partials ``want``; the
    counters read zero after.  Returns |fused - plain|."""
    out = call(merge=True)
    if not out.is_contiguous() or not torch.equal(
            out, da.lse_merge(*got, out.dtype).transpose(1, 2)):
        fail(f"{what} fused: not lse_merge of the unfused launch's "
             "partials, bit for bit")
    counters_zero(torch, da, out.device, what)
    return max_err(torch, out,
                   da.lse_merge_torch(*want, out.dtype).transpose(1, 2), tol,
                   what + " fused")


def check_kernels(torch, np, dev, da, ops):
    """Phase 2.  Returns max abs error per kernel entry."""
    errs = {k: 0.0 for k in KERNELS}
    main = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=5)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=256)
    cases = [
        ("main decode", main, [17, 40, 63, 79], 1, "bfloat16", {}),
        ("deep decode", deep, [4095, 3001, 2048, 777], 1, "bfloat16", {}),
        ("main verify Q=16", main, [32, 48, 0, 20], 16, "bfloat16", {}),
        ("deep verify Q=16", deep, [4000, 2900, 16, 1031], 16, "bfloat16",
         {}),
        ("window/cap decode", main, [17, 40, 63, 79], 1, "bfloat16",
         {"window": 24, "logit_cap": 30.0}),
        ("window/cap verify", main, [32, 48, 0, 20], 16, "bfloat16",
         {"window": 24, "logit_cap": 30.0}),
        ("fp32 decode", main, [17, 40, 63, 79], 1, "float32", {}),
        ("fp32 verify", main, [32, 48, 0, 20], 16, "float32", {}),
        # deep in fp32, where the tolerance is far below a typical output
        # value over ~4k keys: a dropped or misplaced page shows
        ("deep fp32 decode", deep, [4095, 3001, 2048, 777], 1, "float32",
         {}),
        ("deep fp32 verify Q=16", deep, [4000, 2900, 16, 1031], 16,
         "float32", {}),
        ("head_dim 128 decode", dict(main, D=128, Hq=8, Hkv=2),
         [17, 40, 63, 79], 1, "bfloat16", {}),
        # h2o-danube-3's head dim and G 4: no serving path reaches the
        # paged sweep at 120 (its layers are all windowed), so op level
        ("head_dim 120 decode", dict(main, **H2O_HEADS), [17, 40, 63, 79],
         1, "bfloat16", {}),
        ("head_dim 120 verify Q=16", dict(main, **H2O_HEADS),
         [32, 48, 0, 20], 16, "bfloat16", {}),
        ("head_dim 120 fp32 decode", dict(main, **H2O_HEADS),
         [17, 40, 63, 79], 1, "float32", {}),
        ("head_dim 120 fp32 verify Q=16", dict(main, **H2O_HEADS),
         [32, 48, 0, 20], 16, "float32", {}),
    ]
    # the heads of the poisson paths whose prefix hits reach the paged
    # sweeps: phi3.5-moe 32 / 8 and llava-next 56 / 8 of 128, stablelm 32
    # / 32 of 64 (G 1); musicgen's 24 / 24 of 64 (G 1), decode only on its
    # path (no prefix cache)
    for heads in (PHI_HEADS, LLAVA_HEADS, STABLELM_HEADS, MUSICGEN_HEADS):
        form = f"{heads['Hq']}/{heads['Hkv']} D {heads['D']}"
        for dtype in ("bfloat16", "float32"):
            cases += [(f"{form} {dtype} decode", dict(main, **heads),
                       [17, 40, 63, 79], 1, dtype, {}),
                      (f"{form} {dtype} verify Q=16", dict(main, **heads),
                       [32, 48, 0, 20], 16, dtype, {})]
    # the tensor-core sweep's edges: row tiles (Q 17, and Q 128 at G 4 is
    # 512 rows, 16 tiles), pages of 8 keys (two a key tile), positions at
    # page edges, splits wholly past a request (pos 0 and 5 hold one page
    # of five), a window shorter than the verify block (each row its own
    # key range); gemma2's global layers (32 / 16 of 128, cap 50)
    g4 = dict(main, Hq=8, Hkv=2)
    for dtype in ("bfloat16", "float32"):
        cases += [
            (f"G 4 Q=17 {dtype} verify", g4, [32, 48, 0, 20], 17, dtype, {}),
            (f"G 4 Q=128 {dtype} verify", g4, [32, 48, 0, 20], 128, dtype,
             {}),
            (f"page 8 {dtype} decode", dict(main, ps=8, nb=10),
             [17, 40, 63, 79], 1, dtype, {}),
            (f"page 8 {dtype} verify Q=16", dict(main, ps=8, nb=10),
             [32, 48, 0, 20], 16, dtype, {}),
            (f"page edges {dtype} decode", main, [15, 16, 17, 31], 1, dtype,
             {}),
            (f"page edges {dtype} verify Q=16", main, [16, 17, 15, 32], 16,
             dtype, {}),
            (f"splits past the request {dtype} decode", main, [0, 5, 16, 2],
             1, dtype, {}),
            (f"splits past the request {dtype} verify Q=16", main,
             [0, 5, 16, 2], 16, dtype, {}),
            (f"window 8 {dtype} verify Q=16", main, [32, 48, 0, 20], 16,
             dtype, {"window": 8}),
            (f"gemma2 {dtype} decode", dict(main, Hq=32, Hkv=16, D=128),
             [17, 40, 63, 79], 1, dtype, GEMMA_ATTN),
            (f"gemma2 {dtype} verify Q=16", dict(main, Hq=32, Hkv=16, D=128),
             [32, 48, 0, 20], 16, dtype, GEMMA_ATTN)]
    for i, (label, shp, pos, Q, dtype, kw) in enumerate(cases):
        c = make_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype, seed=i,
                      **shp)
        verify = "verify" in label
        entry = ("paged_attention_sweep (verify)" if verify
                 else "paged_attention_sweep (decode)")
        form = paged_form(label, shp)
        auto = ops.choose_kv_splits(shp["B"], shp["nb"] * shp["ps"],
                                    shp["Hq"], block=shp["ps"], device=dev)
        tol = TOL[dtype]
        case_err = 0.0
        for n_splits in sorted({1, auto, 5}):
            args, vkw = sweep_args(c, verify)
            got = da.paged_attention_sweep(*args, **vkw, n_splits=n_splits,
                                           **kw)
            want = da.paged_attention_sweep_torch(*args, **vkw,
                                                  n_splits=n_splits, **kw)
            what = f"{label} n_splits={n_splits}"
            if n_splits == 1:
                e = max_err(torch, got, want, tol, what)
                note(errs, e, entry, form)
                note(errs, e, f"paged_attention_sweep {dtype}")
                case_err = max(case_err, e)
                continue
            e = max(max_err(torch, got[0], want[0], tol, what + " partial"),
                    max_err(torch, got[1], want[1], tol, what + " lse"))
            note(errs, e, entry, form)
            note(errs, e, f"paged_attention_sweep {dtype}")
            merged = da.lse_merge(*got, c["q"].dtype)
            plain = da.lse_merge_torch(*got, c["q"].dtype)
            em = max_err(torch, merged, plain, tol, what + " merge")
            em = max(em, check_fused(
                torch, da, lambda **x: da.paged_attention_sweep(
                    *args, **vkw, n_splits=n_splits, **kw, **x),
                got, want, tol, what))
            note(errs, em, "lse_merge", form and "Dv 120")
            case_err = max(case_err, e, em)
        torch.cuda.synchronize()
        say(f"kernels ok: {label} (n_splits 1, {auto}, 5; fused merges), "
            f"max |kernel - plain| {case_err:.3e} (tol {tol})")
    check_table_tail(torch, np, dev, da, main)
    check_bad_page_id()
    check_bad_page_id(kernel="paged sweep at head_dim 120", head_dim=120)
    return errs


def paged_form(label, shp):
    """The phase-5 form a phase-2 case of the paged sweep belongs to (its
    rows' errors), or None for the main path's (Hq 9 / Hkv 3 of 64)."""
    if shp["D"] == 120:
        return "D 120"
    for form in ("deep", "gemma2"):
        if label.startswith(form):
            return form
    return {(56, 8): "G 7", (32, 32): "G 1", (24, 24): "G 1"}.get(
        (shp["Hq"], shp["Hkv"]))


def check_table_tail(torch, np, dev, da, shp):
    """Table columns past a request's last key hold arbitrary ids.  Put ids
    past the pool and negative ones there: the sweep must not read them,
    so its output is bit-identical to the run with real page ids."""
    for verify, pos, Q in ((False, [17, 40, 3, 79], 1),
                           (True, [32, 48, 0, 20], 16)):
        c = make_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                      seed=50 + Q, **shp)
        P, ps = c["k_pages"].shape[0], shp["ps"]
        junk = dict(c)
        junk["block_tables"] = c["block_tables"].clone()
        for b, p in enumerate(pos):
            last = (p - 1 if verify else p) // ps
            junk["block_tables"][b, last + 1:] = (P + 1000 if b % 2 else -7)
        for n_splits in (1, 5):
            args, kw = sweep_args(c, verify)
            jargs, _ = sweep_args(junk, verify)
            a = da.paged_attention_sweep(*args, **kw, n_splits=n_splits)
            b = da.paged_attention_sweep(*jargs, **kw, n_splits=n_splits)
            same = (torch.equal(a, b) if n_splits == 1 else
                    torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            if not same:
                fail(f"{'verify' if verify else 'decode'} n_splits="
                     f"{n_splits}: output depends on table ids past pos")
    torch.cuda.synchronize()
    say("kernels ok: table ids past each request's length are never read")


BAD_ID_PROBE = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import decode_attention as da
dev = torch.device("cuda", 0)
D = int(sys.argv[2])
q = torch.ones(1, 1, 3, D, dtype=torch.bfloat16, device=dev)
pages = torch.ones(2, 16, 1, D, dtype=torch.bfloat16, device=dev)
bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)  # 2: past the pool
# pos 15: column 1 lies past the request, so its id is never read
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [15], dtype=torch.int32, device=dev))
torch.cuda.synchronize()
print("past-length id skipped", flush=True)
# pos 20: key 20 lies in column 1, whose id names no page of the pool
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [20], dtype=torch.int32, device=dev))
torch.cuda.synchronize()
print("bad id accepted", flush=True)
"""


def check_bad_page_id(probe=BAD_ID_PROBE, kernel="paged sweep",
                      head_dim=64):
    """A table id outside the pool inside a request's length must stop the
    kernel, not drop the page's keys.  The probe runs in a process of its
    own, since the failed launch leaves that process's CUDA context
    unusable."""
    proc = subprocess.run([sys.executable, "-c", probe,
                           str(ROOT / "src"), str(head_dim)],
                          capture_output=True, text=True, timeout=120)
    if "past-length id skipped" not in proc.stdout:
        fail(f"bad-id probe did not run its control call:\n{proc.stderr}")
    if proc.returncode == 0 or "bad id accepted" in proc.stdout:
        fail("a page id outside the pool inside a request's length was "
             "accepted")
    if "CUDA error" not in proc.stderr:
        fail(f"bad-id probe failed for another reason:\n{proc.stderr}")
    why = next(x for x in proc.stderr.splitlines() if "CUDA error" in x)
    say(f"kernels ok: a page id outside the pool inside a request's length "
        f"stops the {kernel} ({why.strip()})")


def make_ring_case(torch, np, dev, *, B, Hq, Hkv, D, C, pos, Q, dtype,
                   seed):
    """Seeded ring-cache inputs on the card; ``pos`` holds one position or
    one per request."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)

    return {"q": r(B, Q, Hq, D), "k": r(B, C, Hkv, D), "v": r(B, C, Hkv, D),
            "k_new": r(B, Q, Hkv, D), "v_new": r(B, Q, Hkv, D),
            "pos": torch.tensor(np.asarray(pos, np.int32).reshape(-1),
                                device=dev)}


def ring_args(c, verify):
    args = (c["q"], c["k"], c["v"], c["pos"])
    kw = {"k_new": c["k_new"], "v_new": c["v_new"]} if verify else {}
    kw.update({key: c[key] for key in ("k_scale", "v_scale") if key in c})
    return args, kw


def past_blocks(n_k):
    """The least split count whose last split lies wholly past the ring's
    n_k blocks (ceil(n_k / S) blocks a split), or None where none does."""
    for S in range(2, n_k + 1):
        if -(-n_k // S) * (S - 1) >= n_k:
            return S
    return None


def ring_splits(da, ops, dev, shp):
    """The split counts a ring case runs at: 1, the engine's (block 256),
    and one past the blocks."""
    n_k = shp["C"] // da.ring_block_k(shp["C"], 256)
    auto = ops.choose_kv_splits(shp["B"], shp["C"], shp["Hq"], block=256,
                                device=dev)
    return {1, auto, past_blocks(n_k) or 1}


def check_ring_kernels(torch, np, dev, da, ops, errs):
    """Phase 2, ring sweep: at the batch path's shapes (8 requests, a ring
    of 545 slots = 5 blocks of 109 under the requested 256) and around
    them, every case at 1 split, the engine's count, a count whose last
    split lies past the blocks, 3 and 5.  The tensor-core kernel's edges:
    blocks of 109 and of 17 (gemma2's global ring on its 2 x 4352 + 17
    batch: 4352 + 17 = 4369 slots) and of 1 (a prime ring of 557)
    that straddle 16-slot tiles, wrapped verify rows that differ inside one
    running block, G 7 with Q 4 (two row tiles), G 1, per-row positions
    with the window (h2o's 4096, and the engine's private rings of 48
    slots), cap 50; zamba2's shared buffers (48 rows a slot, per-row
    positions, no window, a row past its buffer)."""
    main = dict(B=BATCH, Hq=9, Hkv=3, D=64, C=PLEN + GEN)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, C=4096)
    h2o = dict(B=4, C=H2O_WINDOW, **H2O_HEADS)
    wrap = 3 * main["C"] + 17
    gemma = dict(B=2, Hq=32, Hkv=16, D=128, C=G_RING)
    cases = [
        ("main decode", main, 530, 1, "bfloat16", {}),
        ("main verify Q=4", main, 520, 4, "bfloat16", {}),
        ("wrapped decode", main, wrap, 1, "bfloat16", {}),
        ("wrapped verify Q=4", main, wrap, 4, "bfloat16", {}),
        ("verify Q=4 at pos 0", main, 0, 4, "bfloat16", {}),
        ("window/cap decode", main, wrap, 1, "bfloat16",
         {"window": 100, "logit_cap": 30.0}),
        ("window/cap verify Q=4", main, wrap, 4, "bfloat16",
         {"window": 100, "logit_cap": 30.0}),
        ("ragged decode", main, [3, 109, 218, 530, 544, 545, wrap, 77], 1,
         "bfloat16", {}),
        ("fp32 decode", main, 530, 1, "float32", {}),
        ("fp32 verify Q=4", main, 520, 4, "float32", {}),
        ("fp32 wrapped verify Q=4", main, wrap, 4, "float32", {}),
        ("fp32 verify Q=4 at pos 0", main, 0, 4, "float32", {}),
        ("fp32 window/cap decode", main, wrap, 1, "float32",
         {"window": 100, "logit_cap": 30.0}),
        ("fp32 window/cap verify Q=4", main, wrap, 4, "float32",
         {"window": 100, "logit_cap": 30.0}),
        ("fp32 ragged decode", main, [3, 109, 218, 530, 544, 545, wrap, 77],
         1, "float32", {}),
        ("deep fp32 decode", deep, 4000, 1, "float32", {}),
        ("deep fp32 wrapped verify Q=4", deep, 3 * 4096 + 5, 4, "float32",
         {}),
        ("head_dim 128 verify Q=4", dict(main, D=128, Hq=8, Hkv=2), wrap, 4,
         "bfloat16", {}),
        # h2o-danube-3: head dim 120, G 4, window 4096 over a 4096-slot
        # ring that has wrapped, per-row positions as the engine's private
        # rings have them
        ("head_dim 120 wrapped 4096 decode", h2o, H2O_RING_POS, 1,
         "bfloat16", {"window": H2O_WINDOW}),
        ("head_dim 120 wrapped 4096 verify Q=4", h2o, H2O_RING_POS, 4,
         "bfloat16", {"window": H2O_WINDOW}),
        ("head_dim 120 fp32 wrapped 4096 decode", h2o, H2O_RING_POS, 1,
         "float32", {"window": H2O_WINDOW}),
        ("head_dim 120 fp32 wrapped 4096 verify Q=4", h2o, H2O_RING_POS, 4,
         "float32", {"window": H2O_WINDOW}),
    ]
    # the zoo's batch paths at their own shapes, mid-run (pos 528) and
    # wrapped: h2o 4 x 545 (32 / 8 of 120), stablelm 8 x 545 (32 / 32 of
    # 64, G 1; zamba2's shared block's rings too), phi3.5 and llava 4 x
    # 545 (32 / 8 and 56 / 8 of 128, G 7), musicgen 8 x 545 (24 / 24 of
    # 64, G 1)
    for B, heads in ((4, H2O_HEADS), (BATCH, STABLELM_HEADS), (4, PHI_HEADS),
                     (4, LLAVA_HEADS), (BATCH, MUSICGEN_HEADS)):
        shp = dict(B=B, C=PLEN + GEN, **heads)
        form = (f"batch {B} x {PLEN + GEN} {heads['Hq']}/{heads['Hkv']} "
                f"D {heads['D']}")
        for dtype in ("bfloat16", "float32"):
            cases += [(f"{form} {dtype} decode", shp, 528, 1, dtype, {}),
                      (f"{form} {dtype} verify Q=4", shp, 528, 4, dtype, {}),
                      (f"{form} {dtype} wrapped decode", shp, wrap, 1, dtype,
                       {}),
                      (f"{form} {dtype} wrapped verify Q=4", shp, wrap, 4,
                       dtype, {})]
    for dtype in ("bfloat16", "float32"):
        cases += [
            # gemma2's global ring (blocks of 17, cap 50): at the long
            # batch's last position and wrapped
            (f"gemma2 4369 {dtype} decode", gemma, G_RING - 1, 1, dtype,
             GEMMA_ATTN),
            (f"gemma2 4369 {dtype} wrapped verify Q=4", gemma,
             2 * G_RING + 100, 4, dtype, GEMMA_ATTN),
            # a prime ring: blocks of one slot
            (f"prime 557 {dtype} decode", dict(main, C=557), 3 * 557 + 9, 1,
             dtype, {}),
            (f"prime 557 {dtype} verify Q=4", dict(main, C=557), 300, 4,
             dtype, {}),
            # wrapped verify at pos 3 C + 1 and + 108: rows 0..3 differ in
            # which of a running block's slots they see
            (f"rows differ {dtype} verify Q=4", main, 3 * main["C"] + 1, 4,
             dtype, {}),
            (f"rows differ {dtype} verify Q=4 block end", main,
             3 * main["C"] + 108, 4, dtype, {}),
            # the engine's private rings of h2o's poisson path: 48 slots,
            # one position per row, window 4096
            (f"head_dim 120 private rings {dtype} decode", PRIVATE_RING,
             PRIVATE_POS, 1, dtype, {"window": H2O_WINDOW}),
            (f"head_dim 120 private rings wrapped {dtype} decode",
             PRIVATE_RING, [60, 95, 47, 200], 1, dtype, {"window": 40}),
            # zamba2's shared buffers on its poisson path: 48 rows a slot,
            # one position per row, no window; row 2 past its buffer
            (f"zamba2 shared buffers {dtype} decode", ZAMBA_SHARED,
             ZAMBA_SHARED_POS, 1, dtype, {}),
            (f"zamba2 shared buffers overrun {dtype} decode", ZAMBA_SHARED,
             [0, 47, 50, 13], 1, dtype, {})]
    for i, (label, shp, pos, Q, dtype, kw) in enumerate(cases):
        c = make_ring_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype,
                           seed=200 + i, **shp)
        verify = "verify" in label
        entry = ("ring_attention_sweep (verify)" if verify
                 else "ring_attention_sweep (decode)")
        form = "D 120" if shp["D"] == 120 else None
        splits = sorted(ring_splits(da, ops, dev, shp) | {3, 5})
        tol = TOL[dtype]
        case_err = 0.0
        for n_splits in splits:
            args, vkw = ring_args(c, verify)
            got = da.ring_attention_sweep(*args, **vkw, n_splits=n_splits,
                                          block_k=256, **kw)
            want = da.ring_attention_sweep_torch(*args, **vkw,
                                                 n_splits=n_splits,
                                                 block_k=256, **kw)
            what = f"ring {label} n_splits={n_splits}"
            if isinstance(want, torch.Tensor):
                e = max_err(torch, got, want, tol, what)
                note(errs, e, entry, form)
                note(errs, e, f"ring_attention_sweep {dtype}")
                case_err = max(case_err, e)
                continue
            e = max(max_err(torch, got[0], want[0], tol, what + " partial"),
                    max_err(torch, got[1], want[1], tol, what + " lse"))
            note(errs, e, entry, form)
            note(errs, e, f"ring_attention_sweep {dtype}")
            merged = da.lse_merge(*got, c["q"].dtype)
            plain = da.lse_merge_torch(*got, c["q"].dtype)
            em = max_err(torch, merged, plain, tol, what + " merge")
            em = max(em, check_fused(
                torch, da, lambda **x: da.ring_attention_sweep(
                    *args, **vkw, n_splits=n_splits, block_k=256, **kw, **x),
                got, want, tol, what))
            note(errs, em, "lse_merge", form and "Dv 120")
            case_err = max(case_err, e, em)
        torch.cuda.synchronize()
        say(f"kernels ok: ring {label} (n_splits {splits}; fused merges), "
            f"max |kernel - plain| {case_err:.3e} (tol {tol})")
    # the kernel derives slot positions from pos: a custom slot layout on
    # the card raises instead of taking a plain version
    c = make_ring_case(torch, np, dev, pos=20, Q=1, dtype="float32",
                       seed=299, **main)
    k_pos = torch.arange(main["C"], device=dev, dtype=torch.int32).flip(0)
    before = dict(da.LAUNCHES)
    for fn, args in ((ops.decode_attention, (c["q"], c["k"], c["v"])),
                     (ops.verify_attention, (c["q"], c["k"], c["v"],
                                             c["k_new"], c["v_new"]))):
        try:
            fn(*args, c["pos"][0], k_pos=k_pos)
        except NotImplementedError:
            continue
        fail(f"ring {fn.__name__}: a custom k_pos on the card did not raise")
    if da.LAUNCHES != before:
        fail("ring: a refused custom k_pos launched a kernel")
    say("kernels ok: a custom ring k_pos on the card raises "
        "NotImplementedError, no plain fallback")
    # a head dim neither sweep is built for raises before any launch
    c = make_ring_case(torch, np, dev, pos=20, Q=1, dtype="bfloat16",
                       seed=298, **dict(main, D=96))
    p = make_case(torch, np, dev, pos=[17, 40, 63, 79], Q=1,
                  dtype="bfloat16", seed=298, B=4, Hq=9, Hkv=3, D=96, ps=16,
                  nb=5)
    for what, call in (
            ("ring sweep", lambda: da.ring_attention_sweep(*ring_args(
                c, False)[0])),
            ("paged sweep", lambda: da.paged_attention_sweep(*sweep_args(
                p, False)[0]))):
        try:
            call()
        except ValueError:
            continue
        fail(f"{what} at head_dim 96 on the card did not raise ValueError")
    if da.LAUNCHES != before:
        fail("a refused head_dim 96 sweep launched a kernel")
    say("kernels ok: head_dim 96 raises ValueError in both sweeps, no "
        "launch")


def check_int8_kernels(torch, np, dev, da, ops, quant, errs):
    """Phase 2, the int8 templates of both sweeps against their plain twins
    on the same int8 caches and scales: paged decode (1 split and S = 5)
    and verify at Q 16 (1 and 5) at the main path's shapes, ring decode and
    verify at Q 4 on a wrapped ring of 545 slots (1 split, 3, the engine's
    count and one past the blocks); head_dim 64, 120 (3 kv heads, odd ones
    included) and 128, q in bf16 (tolerance 2e-2) and fp32 (1e-4).  Then
    the ring's edges in int8: h2o's per-row positions under its 4096
    window, llava's G 7 verify, stablelm's G 1 and gemma2's global ring of
    4369 slots (blocks of 17) with cap 50."""
    paged = dict(B=4, Hq=9, Hkv=3, ps=16, nb=5)
    ring = dict(B=BATCH, Hq=9, Hkv=3, C=PLEN + GEN)
    wrap = 3 * ring["C"] + 17
    # head dim 120 at 3 kv heads: rows of 120 bytes put every odd row 8
    # bytes off a 16-byte boundary, so the 8-byte loads are exercised
    for D in (64, 120, 128):
        heads = {64: {}, 120: dict(Hq=12, Hkv=3), 128: dict(Hq=8, Hkv=2)}[D]
        for dtype in ("bfloat16", "float32"):
            tol = TOL[dtype]
            for verify, pos, Q in ((False, [17, 40, 63, 79], 1),
                                   (True, [32, 48, 0, 20], 16)):
                c = make_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype,
                              D=D, seed=400 + D + Q, **dict(paged, **heads))
                c = quantize_case(quant, c, ("k_pages", "v_pages"))
                entry = ("paged_attention_sweep int8 (verify)" if verify
                         else "paged_attention_sweep int8 (decode)")
                case_err = int8_case(torch, da, errs, entry, c, verify, tol,
                                     da.paged_attention_sweep,
                                     da.paged_attention_sweep_torch, {},
                                     (1, 5), f"int8 paged D {D} {dtype}")
                say(f"kernels ok: int8 paged {'verify Q=16' if verify else 'decode'}"
                    f" D {D} q {dtype} (n_splits 1, 5), max |kernel - "
                    f"plain| {case_err:.3e} (tol {tol})")
            for verify, Q in ((False, 1), (True, 4)):
                shp = dict(ring, D=D, **heads)
                int8_ring_case(torch, np, dev, da, ops, quant, errs,
                               f"wrapped D {D}", shp, wrap, Q, dtype, {},
                               seed=500 + D + Q)
    edges = [("h2o 4096 window", dict(B=4, C=H2O_WINDOW, **H2O_HEADS),
              H2O_RING_POS, {"window": H2O_WINDOW}),
             ("G 7", dict(B=4, C=PLEN + GEN, **LLAVA_HEADS), wrap, {}),
             ("G 1", dict(B=BATCH, C=PLEN + GEN, **STABLELM_HEADS), wrap, {}),
             ("gemma2 4369", dict(B=2, Hq=32, Hkv=16, D=128, C=G_RING),
              2 * G_RING + 100, GEMMA_ATTN)]
    for i, (label, shp, pos, kw) in enumerate(edges):
        for dtype in ("bfloat16", "float32"):
            for verify, Q in ((False, 1), (True, 4)):
                int8_ring_case(torch, np, dev, da, ops, quant, errs, label,
                               shp, pos, Q, dtype, kw, seed=600 + i + Q)
    check_bad_page_id(BAD_ID_PROBE_INT8, "int8 paged sweep")


def int8_ring_case(torch, np, dev, da, ops, quant, errs, label, shp, pos, Q,
                   dtype, kw, seed):
    """One int8 ring case at 1 split, 3, the engine's count and one past the
    blocks."""
    verify = Q > 1
    c = make_ring_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype, seed=seed,
                       **shp)
    c = quantize_case(quant, c, ("k", "v"))
    entry = ("ring_attention_sweep int8 (verify)" if verify
             else "ring_attention_sweep int8 (decode)")
    splits = tuple(sorted(ring_splits(da, ops, dev, shp) | {3}))
    tol = TOL[dtype]
    case_err = int8_case(torch, da, errs, entry, c, verify, tol,
                         da.ring_attention_sweep,
                         da.ring_attention_sweep_torch,
                         dict(kw, block_k=256), splits,
                         f"int8 ring {label} {dtype}", ring=True)
    say(f"kernels ok: int8 ring {label} "
        f"{'verify Q=4' if verify else 'decode'} q {dtype} (n_splits "
        f"{', '.join(map(str, splits))}), max |kernel - plain| "
        f"{case_err:.3e} (tol {tol})")


def int8_case(torch, da, errs, entry, c, verify, tol, kernel, plain, extra,
              splits, label, ring=False):
    """One int8 case at each split count: the kernel against its twin (and,
    split, both merges and the fused one); returns the case's max
    error."""
    case_err = 0.0
    form = "D 120" if c["q"].shape[-1] == 120 else None
    before = dict(da.LAUNCHES)
    n_fused = 0
    for n_splits in splits:
        args, kw = (ring_args if ring else sweep_args)(c, verify)
        got = kernel(*args, **kw, n_splits=n_splits, **extra)
        want = plain(*args, **kw, n_splits=n_splits, **extra)
        what = f"{label} {'verify' if verify else 'decode'} n_splits={n_splits}"
        if isinstance(want, torch.Tensor):
            e = max_err(torch, got, want, tol, what)
        else:
            e = max(max_err(torch, got[0], want[0], tol, what + " partial"),
                    max_err(torch, got[1], want[1], tol, what + " lse"))
        note(errs, e, ("ring_attention_sweep " if ring
                       else "paged_attention_sweep ")
             + str(c["q"].dtype).split(".")[1])
        if not isinstance(want, torch.Tensor):
            em = max_err(torch, da.lse_merge(*got, c["q"].dtype),
                         da.lse_merge_torch(*got, c["q"].dtype), tol,
                         what + " merge")
            em = max(em, check_fused(
                torch, da, lambda **x: kernel(*args, **kw, n_splits=n_splits,
                                              **extra, **x),
                got, want, tol, what))
            n_fused += 1
            note(errs, em, "lse_merge", form and "Dv 120")
            e = max(e, em)
        note(errs, e, entry, form)
        case_err = max(case_err, e)
    torch.cuda.synchronize()
    key = KERNELS[entry][2]
    if da.LAUNCHES[key] - before[key] != len(splits) + n_fused:
        fail(f"{label}: the int8 template {key} was not the one launched")
    return case_err


BAD_ID_PROBE_INT8 = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import decode_attention as da
dev = torch.device("cuda", 0)
D = int(sys.argv[2])
q = torch.ones(1, 1, 3, D, dtype=torch.bfloat16, device=dev)
pages = torch.ones(2, 16, 1, D, dtype=torch.int8, device=dev)
scale = torch.ones(2, 16, 1, 1, dtype=torch.float32, device=dev)
bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)  # 2: past the pool
# pos 15: column 1 lies past the request, so its id is never read
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [15], dtype=torch.int32, device=dev), k_scale=scale, v_scale=scale)
torch.cuda.synchronize()
print("past-length id skipped", flush=True)
# pos 20: key 20 lies in column 1, whose id names no page of the pool
da.paged_attention_sweep(q, pages, pages, bt, torch.tensor(
    [20], dtype=torch.int32, device=dev), k_scale=scale, v_scale=scale)
torch.cuda.synchronize()
print("bad id accepted", flush=True)
"""


GEMMA_ATTN = {"logit_cap": 50.0, "scale": 144.0 ** -0.5}


def fa_case(torch, np, dev, *, B, Sq, Sk, Hq, Hkv, D, dtype, seed, Dv=None):
    """Seeded q (B, Sq, Hq, D), k (B, Sk, Hkv, D) and v (B, Sk, Hkv, Dv)
    on the card (Dv defaults to D)."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)

    return r(B, Sq, Hq, D), r(B, Sk, Hkv, D), r(B, Sk, Hkv, Dv or D)


def note_k4(errs, e, dtype, form):
    """K4's error under its entry, its form's row and, for bf16 (where p
    enters the p.v product as two bf16 terms), the largest bf16 error."""
    note(errs, e, "flash_attention", form)
    if dtype == "bfloat16":
        note(errs, e, "flash_attention bf16")


# K9's phase-2 widths: every width the zoo normalizes (512, 576, 1024,
# 1536, 2048, 3840, 4096, 4608, 5120, 7168), 8 and 8192, and widths that
# reach every launch shape rmsnorm.py's launch_shape picks: a
# row a thread (8, 24), rows of a few lanes (256, 576), a warp a row (512;
# 136 ragged), several rows a block of several warps each (1024, 1536,
# 2048; 296 and 1000 ragged), one row a block (3840 ... 8192; 5000
# ragged), and the two-pass kernel past 8192 (8200, 16384)
RMS_WIDTHS = (8, 24, 136, 256, 296, 512, 576, 1000, 1024, 1536, 2048, 3840,
              4096, 4608, 5000, 5120, 7168, 8192, 8200, 16384)
RMS_SHAPE_KINDS = ("lanes", "rows a block", "row a block", "ragged",
                   "two-pass")


def rms_shape_kind(d, shape):
    """Which of ``RMS_SHAPE_KINDS`` K9's launch shape for width d is."""
    tpr, nvec, rpb = shape
    if tpr == 0:
        return "two-pass"
    if tpr * nvec != d // 8:
        return "ragged"
    if tpr < 32:
        return "lanes"
    return "rows a block" if rpb > 1 else "row a block"


def check_prefill_kernels(torch, np, dev, fa, rms, ops, common, errs):
    """Phase 2, K4 and K9.  K4 against ``flash_attention_torch`` at
    smollm's prefill shape, at stablelm's G 1, at gemma2's and
    h2o-danube-3's (D 120) over 8192 keys with and without their 4096
    window, with a q_offset, ragged (Sq 37 and 1000), at llava-next's G 7
    (4 x 512 and ragged), and at the tensor-core kernel's tile edges (Sk
    65 and 127 about the 64-key tile, Sq 1, D 120 with Sk 17, G 7 with Sq
    19 about a block's 18 positions, B 3 with ragged Sk); rows that see no
    key only finite.  K9 against ``common.rmsnorm`` at ``RMS_WIDTHS``
    (every launch shape it picks), plain and gemma forms, 1 to 8192 rows,
    fp32 and bf16 scales."""
    smol = dict(B=8, Sq=512, Sk=512, Hq=9, Hkv=3, D=64)
    gem = dict(Hq=32, Hkv=16, D=128)
    # (label, shape, keyword arguments, the phase-5 row of its form)
    d64, g_long, d120, g7 = ("(64, 64)", "gemma2 2 x 4352", "(120, 120)",
                             "G 7")
    cases = [
        ("smollm 8 x 512 causal", smol, {}, d64),
        ("gemma2 8192 keys, window 4096, cap 50",
         dict(gem, B=1, Sq=8192, Sk=8192), dict(GEMMA_ATTN, window=4096),
         g_long),
        ("gemma2 8192 keys, no window, cap 50",
         dict(gem, B=1, Sq=8192, Sk=8192), GEMMA_ATTN, g_long),
        ("gemma2 q_offset 1536 over 2048 keys, window 1000",
         dict(gem, B=2, Sq=512, Sk=2048),
         dict(GEMMA_ATTN, q_offset=1536, window=1000), g_long),
        ("ragged Sq 37", dict(smol, B=3, Sq=37, Sk=37), {"window": 16}, d64),
        ("ragged Sq 1000", dict(gem, B=1, Sq=1000, Sk=1000),
         dict(GEMMA_ATTN, window=300), None),
        # h2o-danube-3: (D, Dv) = (120, 120), G 4, window 4096
        ("h2o 8192 keys, window 4096", dict(H2O_HEADS, B=1, Sq=8192,
                                            Sk=8192), {"window": H2O_WINDOW},
         d120),
        ("h2o 8192 keys, no window", dict(H2O_HEADS, B=1, Sq=8192, Sk=8192),
         {}, d120),
        ("h2o q_offset 1536 over 2048 keys, window 1000",
         dict(H2O_HEADS, B=2, Sq=512, Sk=2048),
         {"q_offset": 1536, "window": 1000}, d120),
        ("h2o ragged Sq 37", dict(H2O_HEADS, B=3, Sq=37, Sk=37),
         {"window": 16}, d120),
        ("h2o ragged Sq 1000", dict(H2O_HEADS, B=1, Sq=1000, Sk=1000),
         {"window": 300}, d120),
        # llava-next: G 7, 18 positions (126 rows) a block
        ("llava G 7 4 x 512", dict(LLAVA_HEADS, B=4, Sq=512, Sk=512), {},
         g7),
        ("llava G 7 ragged Sq 37", dict(LLAVA_HEADS, B=3, Sq=37, Sk=37), {},
         g7),
        # stablelm's G 1: 128 positions a block (zamba2's shared block's
        # heads too, at its train batch), musicgen's 24 / 24 of 64
        ("stablelm G 1 2 x 512", dict(STABLELM_HEADS, B=2, Sq=512, Sk=512),
         {}, d64),
        ("zamba2 G 1 8 x 512", dict(ZAMBA_HEADS, B=BATCH, Sq=PLEN, Sk=PLEN),
         {}, d64),
        ("musicgen G 1 8 x 512", dict(MUSICGEN_HEADS, B=BATCH, Sq=PLEN,
                                      Sk=PLEN), {}, d64),
        ("musicgen G 1 ragged Sq 37", dict(MUSICGEN_HEADS, B=3, Sq=37,
                                           Sk=37), {}, d64),
        # the tensor-core kernel's tile edges: 64-key tiles, 128 rows
        ("Sk 65, one key past a tile", dict(gem, B=2, Sq=65, Sk=65),
         GEMMA_ATTN, g_long),
        ("Sk 127, one key short of two tiles", dict(gem, B=2, Sq=127,
                                                    Sk=127),
         GEMMA_ATTN, g_long),
        ("non-causal Sq 16 over Sk 65", dict(gem, B=2, Sq=16, Sk=65),
         {"causal": False}, None),
        ("Sq 1, a one-token cold join", dict(gem, B=2, Sq=1, Sk=1),
         GEMMA_ATTN, g_long),
        ("stablelm G 1 Sq 1", dict(STABLELM_HEADS, B=2, Sq=1, Sk=1), {},
         d64),
        ("h2o D 120, Sk 17", dict(H2O_HEADS, B=2, Sq=17, Sk=17),
         {"window": H2O_WINDOW}, d120),
        ("llava G 7, Sq 19", dict(LLAVA_HEADS, B=2, Sq=19, Sk=19), {}, g7),
        ("B 3, ragged Sk 100", dict(gem, B=3, Sq=100, Sk=100), GEMMA_ATTN,
         g_long),
    ]
    for dtype in ("bfloat16", "float32"):
        tol = TOL[dtype]
        for i, (label, shp, kw, form) in enumerate(cases):
            q, k, v = fa_case(torch, np, dev, dtype=dtype, seed=400 + i,
                              **shp)
            got = fa.flash_attention(q, k, v, **kw)
            want = ops.flash_attention_torch(q, k, v, **kw)
            e = max_err(torch, got, want, tol, f"K4 {label} {dtype}")
            note_k4(errs, e, dtype, form)
            torch.cuda.synchronize()
            say(f"kernels ok: K4 {label} ({dtype}), max |kernel - plain| "
                f"{e:.3e} (tol {tol})")
        # rows 40.. with a window of 8 over 32 keys see none: finite only
        q, k, v = fa_case(torch, np, dev, B=1, Sq=16, Sk=32, Hq=4, Hkv=2,
                          D=64, dtype=dtype, seed=499)
        if not bool(torch.isfinite(fa.flash_attention(
                q, k, v, q_offset=40, window=8)).all()):
            fail(f"K4 rows without keys ({dtype}): non-finite output")
    say("kernels ok: K4 rows that see no key are finite")
    rng = np.random.default_rng(500)
    shapes = {}
    for dtype in ("bfloat16", "float32"):
        tol = TOL[dtype]
        worst = 0.0
        for d in RMS_WIDTHS:
            shapes[d] = (rms.launch_shape(d, 1), rms.launch_shape(d, 8192))
            for rows in (1, 7, 1000, 8192) + ((65536,) if d == 576 else ()):
                x = torch.tensor(3.0 * rng.standard_normal((rows, d)),
                                 dtype=torch.float32, device=dev).to(
                                     getattr(torch, dtype))
                for w_dtype in (torch.float32, torch.bfloat16):
                    w = torch.tensor(0.5 * rng.standard_normal(d),
                                     dtype=torch.float32,
                                     device=dev).to(w_dtype)
                    for gemma in (False, True):
                        got = rms.rmsnorm(x, w, eps=1e-6, gemma_style=gemma)
                        want = common.rmsnorm(x, w, 1e-6, gemma_style=gemma)
                        e = max_err(torch, got, want, tol,
                                    f"K9 d {d} rows {rows} {dtype} w "
                                    f"{w_dtype} gemma {gemma}")
                        note(errs, e, "rmsnorm", f"d {d}")
                        worst = max(worst, e)
        torch.cuda.synchronize()
        say(f"kernels ok: K9 d {' / '.join(map(str, RMS_WIDTHS))}, 1 to "
            f"8192 rows (65536 at 576), both forms ({dtype}), max |kernel - "
            f"plain| {worst:.3e} (tol {tol})")
    kinds = {rms_shape_kind(d, shp) for d, pair in shapes.items()
             for shp in pair}
    if kinds != set(RMS_SHAPE_KINDS):
        fail(f"K9: phase 2's widths reach the launch shapes {sorted(kinds)}, "
             f"not all of {RMS_SHAPE_KINDS}")
    say("kernels ok: K9's launch shapes (threads a row, vectors a thread, "
        "rows a block) for 1 and 8192 rows " + ", ".join(
            f"d {d} {few} {many}" for d, (few, many) in shapes.items()))
    # the dispatch: auto launches the kernels on CUDA tensors, and shapes
    # the kernels do not take raise instead of taking a plain version
    q, k, v = fa_case(torch, np, dev, B=1, Sq=64, Sk=64, Hq=4, Hkv=2, D=64,
                      dtype="bfloat16", seed=501)
    x = q.reshape(-1, 64)
    before = dict(fa.LAUNCHES)
    ops.attention(q, k, v)
    ops.rmsnorm(x, torch.zeros(64, device=dev), gemma_style=True)
    if (fa.LAUNCHES["flash_attention"] - before["flash_attention"],
            fa.LAUNCHES["rmsnorm"] - before["rmsnorm"]) != (1, 1):
        fail("ops.attention / ops.rmsnorm under auto did not launch the "
             "kernels on CUDA tensors")
    q96 = torch.zeros((1, 8, 4, 96), dtype=torch.bfloat16, device=dev)
    k96 = torch.zeros((1, 8, 2, 96), dtype=torch.bfloat16, device=dev)
    for what, call in (
            ("K4 head_dim 96", lambda: fa.flash_attention(q96, k96, k96)),
            ("K4 Dv != D", lambda: fa.flash_attention(q, k, v[..., :32])),
            ("K9 width 12", lambda: rms.rmsnorm(
                x[:, :12].contiguous(), torch.zeros(12, device=dev)))):
        try:
            call()
        except ValueError:
            continue
        fail(f"{what} on the card did not raise ValueError")
    if fa.LAUNCHES["flash_attention"] - before["flash_attention"] != 1 \
            or fa.LAUNCHES["rmsnorm"] - before["rmsnorm"] != 1:
        fail("a refused K4 / K9 call launched a kernel")
    say("kernels ok: auto launches K4 and K9 on CUDA tensors; head_dim 96, "
        "Dv != D and width 12 raise ValueError, no plain fallback")


def ssd_case(torch, np, dev, *, B, S, dtype, seed, G=1, D=True, init=False,
             H=32, P=64, N=128):
    """Seeded K8 inputs on the card, mamba2-370m's heads by default: x, B,
    C unit normals, dt = softplus(n - 1), A = -exp(u) with u uniform in
    [0, log 16] (the range of the model's A_log), D, initial state."""
    rng = np.random.default_rng(seed)
    dt_ = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev)

    inp = {"x": r(B, S, H, P).to(dt_),
           "dt": torch.nn.functional.softplus(r(B, S, H) - 1.0),
           "A": -torch.exp(torch.tensor(rng.uniform(0.0, np.log(16.0), H),
                                        dtype=torch.float32, device=dev)),
           "B_mat": r(B, S, G, N).to(dt_), "C_mat": r(B, S, G, N).to(dt_),
           "D": r(H) if D else None}
    return inp, (r(B, H, P, N) if init else None)


# K8's phase-2 cases beside mamba2-370m's heads (zamba2-1.2b's last):
# (label, shape, chunk).
# The first five came with the CUDA-core kernel; the rest reach the
# tensor-core kernels' edges: chunks padded inside to a multiple of 16 (16
# is the smoke config's, 37 and 100 are not multiples), G 4, one step with
# and without an initial state, the state pass over 1, 2 and 32 chunks,
# and chunks of one step, which the workspace takes in groups (the state
# carried between groups).
SSD_CASES = [
    ("2 x 512", dict(B=2, S=512), 128),
    ("2 x 512, G 2, no D, initial state",
     dict(B=2, S=512, G=2, D=False, init=True), 128),
    ("1 x 4000 (ragged), initial state", dict(B=1, S=M_LONG, init=True),
     128),
    ("3 x 37, G 2, initial state", dict(B=3, S=37, G=2, init=True), 128),
    ("4 x 1, no D, initial state", dict(B=4, S=1, D=False, init=True), 128),
    ("2 x 512, chunk 16 (32 chunks)", dict(B=2, S=512, init=True), 16),
    ("2 x 300, chunk 37, initial state", dict(B=2, S=300, init=True), 37),
    ("2 x 300, chunk 100, G 4", dict(B=2, S=300, G=4), 100),
    ("1 x 1", dict(B=1, S=1), 128),
    ("2 x 128, one chunk, initial state", dict(B=2, S=128, init=True), 128),
    ("2 x 200, two chunks", dict(B=2, S=200), 128),
    ("1 x 32, G 4, initial state", dict(B=1, S=32, G=4, init=True), 128),
    ("2 x 600, chunk 1 (groups of chunks), initial state",
     dict(B=2, S=600, init=True), 1),
    # zamba2-1.2b's heads (H 64, P 64, N 64): its train batch and prefill,
    # a ragged prompt with an initial state, G 2
    ("zamba2 8 x 512 (H 64, N 64)", dict(B=BATCH, S=PLEN, **ZAMBA_SSM),
     128),
    ("zamba2 1 x 37 (H 64, N 64), initial state",
     dict(B=1, S=37, init=True, **ZAMBA_SSM), 128),
    ("zamba2 2 x 300 (H 64, N 64), G 2, chunk 100",
     dict(B=2, S=300, G=2, **ZAMBA_SSM), 100),
]


def check_ssd_kernels(torch, np, dev, ss, ops, errs):
    """Phase 2, K8 against its twin ``ssd_scan_torch`` (the chunked plain
    version over the padded sequence) at ``SSD_CASES``, y (with and
    without the final state asked) and the final state."""
    errs["ssd_scan"] = 0.0
    for dtype in ("bfloat16", "float32"):
        tol = SSD_TOL[dtype]
        for i, (label, shp, chunk) in enumerate(SSD_CASES):
            inp, h0 = ssd_case(torch, np, dev, dtype=dtype, seed=800 + i,
                               **shp)
            y, h = ss.ssd_scan(**inp, chunk=chunk, initial_state=h0,
                               return_state=True)
            y_only = ss.ssd_scan(**inp, chunk=chunk, initial_state=h0)
            wy, wh = ss.ssd_scan_torch(**inp, chunk=chunk, initial_state=h0,
                                       return_state=True)
            what = f"K8 {label} {dtype}"
            e = max(max_err(torch, y, wy, tol, what + " y"),
                    max_err(torch, y_only, wy, tol, what + " y (no state)"),
                    max_err(torch, h, wh, tol, what + " final state"))
            errs["ssd_scan"] = max(errs["ssd_scan"], e)
            torch.cuda.synchronize()
            say(f"kernels ok: K8 {label} ({dtype}), max |kernel - plain| "
                f"{e:.3e} (tol {tol}; |y| up to "
                f"{float(wy.float().abs().max()):.1f})")
    # the dispatch: auto launches K8 on CUDA tensors; what it does not take
    # raises instead of taking a plain version
    inp, _ = ssd_case(torch, np, dev, B=1, S=64, dtype="bfloat16", seed=899)
    before = ss.LAUNCHES["ssd"]
    ops.ssd(**inp)
    if ss.LAUNCHES["ssd"] - before != 1:
        fail("ops.ssd under auto did not launch K8 on CUDA tensors")
    wide, _ = ssd_case(torch, np, dev, B=1, S=8, N=256, dtype="bfloat16",
                       seed=898)
    for what, call in (
            ("K8 chunk 256", lambda: ss.ssd_scan(**inp, chunk=256)),
            ("K8 N 256", lambda: ss.ssd_scan(**wide)),
            ("K8 fp16", lambda: ss.ssd_scan(**{
                k: (v.half() if k in ("x", "B_mat", "C_mat") else v)
                for k, v in inp.items()}))):
        try:
            call()
        except ValueError:
            continue
        fail(f"{what} on the card did not raise ValueError")
    if ss.LAUNCHES["ssd"] - before != 1:
        fail("a refused K8 call launched a kernel")
    say("kernels ok: auto launches K8 on CUDA tensors; chunk 256, N 256 "
        "and fp16 raise ValueError, no plain fallback")


def mla_case(torch, np, dev, *, B, nb, pos, Q, dtype, seed, ps=16,
             Hq=MLA["Hq"], logit_cap=0.0):
    """Seeded latent-sweep inputs on the card at deepseek-v2's latent
    widths (128 heads unless ``Hq`` says otherwise): a pool of B * nb
    shuffled private pages plus one scratch page per slot, ragged ``pos``,
    pending rows for verify."""
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)

    def r(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                            device=dev).to(dt)

    bt = (B + rng.permutation(B * nb)).reshape(B, nb).astype(np.int32)
    return {"q": r(B, Q, Hq, MLA["R"]),
            "pool": r(B * nb + B, ps, MLA["R"]),
            "block_tables": torch.tensor(bt, device=dev),
            "pos": torch.tensor(np.asarray(pos, np.int32), device=dev),
            "pending": r(B, Q, MLA["R"]) if Q > 1 else None,
            "logit_cap": logit_cap}


def mla_args(c):
    return ((c["q"], c["pool"], c["block_tables"], c["pos"]),
            dict(r_kv=MLA["r_kv"], scale=MLA["scale"], pending=c["pending"],
                 logit_cap=c["logit_cap"]))


def check_mla_kernels(torch, np, dev, da, fa, rms, ops, common, errs):
    """Phase 2, deepseek-v2's kernels: the latent sweep against its twin
    (decode with 1, the engine's and 5 splits, deep 4096-position tables,
    verify with Q 4 and 16 and pending rows, ragged positions, bf16 and
    fp32; and the tensor-core kernel's edges: 20 heads, whose rows do not
    fill a block, pages of 8 and 32, positions at page edges, verify at
    pos 0 and at Q 40 (pending rows over three 16-key tiles), splits
    wholly past the request, a logit cap of 50), the merge of its split
    partials at Dv 512, table ids past a request never read and a bad id
    inside it stopping the kernel; K4 at (D, Dv) = (192, 128); K9 at
    widths 512 and 1536."""
    errs.update({"mla_latent_sweep (decode)": 0.0,
                 "mla_latent_sweep (verify)": 0.0})
    main, deep = dict(B=4, nb=5), dict(B=4, nb=256)
    h20 = dict(B=4, nb=10, ps=8, Hq=20)
    cases = [("main decode", main, [17, 40, 63, 79], 1),
             ("deep decode", deep, [4095, 3001, 2048, 777], 1),
             ("main verify Q=4", main, [32, 48, 0, 20], 4),
             ("main verify Q=16", main, [32, 48, 0, 20], 16),
             ("deep verify Q=16", deep, [4000, 2900, 16, 1031], 16),
             ("Hq 20, pages of 8, page-edge decode", h20, [7, 8, 15, 79], 1),
             ("pages of 32, page-edge decode", dict(B=4, nb=3, ps=32),
              [31, 32, 63, 95], 1),
             ("splits past the request decode", dict(B=4, nb=8),
              [3, 15, 16, 0], 1),
             ("cap 50 decode", dict(main, logit_cap=50.0), [17, 40, 63, 79],
              1),
             ("verify Q=40 at pos 0", main, [0, 40, 17, 0], 40),
             ("Hq 20, pages of 8, verify Q=17", h20, [0, 8, 23, 63], 17),
             ("pages of 32, verify Q=16", dict(B=4, nb=3, ps=32),
              [32, 0, 64, 48], 16),
             ("cap 50 verify Q=16", dict(main, logit_cap=50.0),
              [32, 48, 0, 20], 16)]
    bf16_err = 0.0
    for dtype in ("bfloat16", "float32"):
        tol = TOL[dtype]
        for i, (label, shp, pos, Q) in enumerate(cases):
            c = mla_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype,
                         seed=1000 + i, **shp)
            verify = Q > 1
            entry = "mla_latent_sweep (verify)" if verify \
                else "mla_latent_sweep (decode)"
            q_heads = c["q"].shape[2] if verify else 1
            ps = c["pool"].shape[1]
            auto = ops.choose_kv_splits(shp["B"], shp["nb"] * ps, q_heads,
                                        block=ps, device=dev)
            case_err = 0.0
            for n_splits in sorted({1, auto, 5}):
                args, kw = mla_args(c)
                got = da.mla_latent_sweep(*args, **kw, n_splits=n_splits)
                want = da.mla_latent_sweep_torch(*args, **kw,
                                                 n_splits=n_splits)
                what = f"latent sweep {label} {dtype} n_splits={n_splits}"
                if n_splits == 1:
                    e = max_err(torch, got, want, tol, what)
                else:
                    e = max(max_err(torch, got[0], want[0], tol,
                                    what + " partial"),
                            max_err(torch, got[1], want[1], tol,
                                    what + " lse"))
                    em = max_err(torch, da.lse_merge(*got, c["q"].dtype),
                                 da.lse_merge_torch(*got, c["q"].dtype), tol,
                                 what + " merge at Dv 512")
                    em = max(em, check_fused(
                        torch, da, lambda **x: da.mla_latent_sweep(
                            *args, **kw, n_splits=n_splits, **x),
                        got, want, tol, what))
                    errs["lse_merge"] = max(errs["lse_merge"], em)
                    e = max(e, em)
                errs[entry] = max(errs[entry], e)
                case_err = max(case_err, e)
            torch.cuda.synchronize()
            if dtype == "bfloat16":
                bf16_err = max(bf16_err, case_err)
            say(f"kernels ok: latent sweep {label} ({dtype}; n_splits 1, "
                f"{auto}, 5), max |kernel - plain| {case_err:.3e} (tol "
                f"{tol})")
    say(f"kernels ok: the latent sweep's largest bf16 |kernel - plain| over "
        f"every case {bf16_err:.3e} (tol {TOL['bfloat16']})")
    for Q, pos in ((1, [17, 40, 3, 79]), (16, [32, 48, 0, 20])):
        c = mla_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                     seed=1100 + Q, **main)
        junk = dict(c)
        junk["block_tables"] = c["block_tables"].clone()
        P = c["pool"].shape[0]
        for b, p in enumerate(pos):
            last = (p - 1 if Q > 1 else p) // 16
            junk["block_tables"][b, last + 1:] = P + 1000 if b % 2 else -7
        for n_splits in (1, 5):
            args, kw = mla_args(c)
            jargs, _ = mla_args(junk)
            a = da.mla_latent_sweep(*args, **kw, n_splits=n_splits)
            b = da.mla_latent_sweep(*jargs, **kw, n_splits=n_splits)
            same = (torch.equal(a, b) if n_splits == 1 else
                    torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            if not same:
                fail(f"latent sweep Q={Q} n_splits={n_splits}: output "
                     "depends on table ids past pos")
    torch.cuda.synchronize()
    say("kernels ok: the latent sweep never reads table ids past a "
        "request's length")
    check_bad_page_id(MLA_BAD_ID_PROBE, "latent sweep")

    for i, (label, Sq, Sk, kw) in enumerate((
            ("4 x 512", 512, 512, {}), ("ragged Sq 37", 37, 37, {}),
            ("q_offset 64", 64, 128, {"q_offset": 64}),
            ("ragged Sq 1000 (128 positions a block)", 1000, 1000, {}))):
        for dtype in ("bfloat16", "float32"):
            rng = np.random.default_rng(1200 + i)
            B = {512: 4, 1000: 1}.get(Sq, 2)
            dt = getattr(torch, dtype)

            def r(*shape):
                return torch.tensor(rng.standard_normal(shape),
                                    dtype=torch.float32, device=dev).to(dt)

            q, k, v = r(B, Sq, 128, 192), r(B, Sk, 128, 192), \
                r(B, Sk, 128, 128)
            got = fa.flash_attention(q, k, v, scale=MLA["scale"], **kw)
            want = ops.flash_attention_torch(q, k, v, scale=MLA["scale"],
                                             q_chunk=256, k_chunk=256, **kw)
            e = max_err(torch, got, want, TOL[dtype],
                        f"K4 (192, 128) {label} {dtype}")
            note_k4(errs, e, dtype, "(192, 128)")
            torch.cuda.synchronize()
            say(f"kernels ok: K4 at (D, Dv) = (192, 128), {label} "
                f"({dtype}), max |kernel - plain| {e:.3e}")
    rng = np.random.default_rng(1300)
    for d in (512, 1536):
        for rows in (4, 2048):
            for dtype in ("bfloat16", "float32"):
                x = torch.tensor(rng.standard_normal((rows, d)),
                                 dtype=torch.float32,
                                 device=dev).to(getattr(torch, dtype))
                w = torch.tensor(1.0 + 0.1 * rng.standard_normal(d),
                                 dtype=torch.float32, device=dev)
                e = max_err(torch, rms.rmsnorm(x, w), common.rmsnorm(x, w),
                            TOL[dtype], f"K9 d {d} x {rows} {dtype}")
                errs["rmsnorm"] = max(errs["rmsnorm"], e)
    torch.cuda.synchronize()
    say("kernels ok: K9 at deepseek's norm widths 512 and 1536 (4 and "
        "2048 rows, bf16 and fp32)")


MLA_BAD_ID_PROBE = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from repro_torch.kernels import decode_attention as da
dev = torch.device("cuda", 0)
q = torch.ones(1, 1, 128, 576, dtype=torch.bfloat16, device=dev)
pool = torch.ones(2, 16, 576, dtype=torch.bfloat16, device=dev)
bt = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)  # 2: past the pool
# pos 15: column 1 lies past the request, so its id is never read
da.mla_latent_sweep(q, pool, bt, torch.tensor([15], dtype=torch.int32,
                    device=dev), r_kv=512, scale=0.07)
torch.cuda.synchronize()
print("past-length id skipped", flush=True)
# pos 20: key 20 lies in column 1, whose id names no page of the pool
da.mla_latent_sweep(q, pool, bt, torch.tensor([20], dtype=torch.int32,
                    device=dev), r_kv=512, scale=0.07)
torch.cuda.synchronize()
print("bad id accepted", flush=True)
"""


# The fused merge's phase-2 split counts: up to choose_kv_splits' 16
FUSED_SPLITS = (2, 3, 5, 16)


def fused_forms(torch, np, dev, da, quant):
    """Every split form of the three sweeps at 16 blocks of keys, so that
    each of ``FUSED_SPLITS`` is a real split count: the paged sweep (4
    slots, 16 pages of 16) and the ring sweep (4 rows, 4096 slots in
    blocks of 256) at D 64 (9 / 3 heads), 120 (32 / 8) and 128 (32 / 8), q
    bf16 and fp32, kv rows in q's dtype and int8; decode and verify (paged
    Q 16, ring Q 4); the latent sweep at deepseek's widths (Hq 128, Dv
    512, 16 pages of 16), bf16 and fp32, decode and verify Q 16.  Request
    0 holds one or two blocks of keys (or, verifying at pos 0, only its
    candidates, in the last split): its other splits are empty.  Yields (label, call, plain)
    where ``call(**kw)`` launches the sweep and ``plain(n_splits)`` runs
    its plain version."""
    heads = {64: dict(Hq=9, Hkv=3), 120: dict(Hq=32, Hkv=8),
             128: dict(Hq=32, Hkv=8)}
    for dtype in ("bfloat16", "float32"):
        for D in (64, 120, 128):
            for int8 in (False, True):
                for verify in (False, True):
                    pos, Q = (([0, 90, 180, 240], 16) if verify
                              else ([17, 100, 200, 255], 1))
                    c = make_case(torch, np, dev, B=4, D=D, ps=16, nb=16,
                                  pos=pos, Q=Q, dtype=dtype,
                                  seed=2000 + D + Q, **heads[D])
                    if int8:
                        c = quantize_case(quant, c, ("k_pages", "v_pages"))
                    args, kw = sweep_args(c, verify)
                    yield (f"paged D {D} {dtype}{' int8' if int8 else ''} "
                           f"{'verify Q=16' if verify else 'decode'}",
                           lambda a=args, k=kw, **x: da.paged_attention_sweep(
                               *a, **k, **x),
                           lambda n, a=args, k=kw:
                           da.paged_attention_sweep_torch(*a, **k,
                                                          n_splits=n))
                    pos, Q = (([0, 1000, 4090, 9000], 4) if verify
                              else ([100, 1000, 4095, 3 * 4096 + 17], 1))
                    c = make_ring_case(torch, np, dev, B=4, D=D, C=4096,
                                       pos=pos, Q=Q, dtype=dtype,
                                       seed=2100 + D + Q, **heads[D])
                    if int8:
                        c = quantize_case(quant, c, ("k", "v"))
                    args, kw = ring_args(c, verify)
                    yield (f"ring D {D} {dtype}{' int8' if int8 else ''} "
                           f"{'verify Q=4' if verify else 'decode'}",
                           lambda a=args, k=kw, **x: da.ring_attention_sweep(
                               *a, **k, block_k=256, **x),
                           lambda n, a=args, k=kw:
                           da.ring_attention_sweep_torch(
                               *a, **k, block_k=256, n_splits=n))
        for verify in (False, True):
            pos, Q = (([0, 90, 180, 240], 16) if verify
                      else ([17, 100, 200, 255], 1))
            c = mla_case(torch, np, dev, B=4, nb=16, pos=pos, Q=Q,
                         dtype=dtype, seed=2200 + Q)
            args, kw = mla_args(c)
            yield (f"latent Dv 512 {dtype} "
                   f"{'verify Q=16' if verify else 'decode'}",
                   lambda a=args, k=kw, **x: da.mla_latent_sweep(*a, **k,
                                                                 **x),
                   lambda n, a=args, k=kw: da.mla_latent_sweep_torch(
                       *a, **k, n_splits=n))


def check_fused_merge(torch, np, dev, da, quant, errs):
    """Phase 2, the merge folded into the split sweeps, at every form of
    ``fused_forms`` and split count of ``FUSED_SPLITS``, an empty split in
    each: the fused output equals ``lse_merge`` of the unfused launch's
    partials bit for bit and lies within ``TOL`` of the plain version
    (``check_fused``); the same launch run 3 times in a row, and 20 times
    captured in one CUDA graph (replayed twice), gives those bits each
    time; the counter workspace reads all zero after each case."""
    n_cases = 0
    for label, call, plain in fused_forms(torch, np, dev, da, quant):
        tol = TOL["float32" if "float32" in label else "bfloat16"]
        worst = 0.0
        for S in FUSED_SPLITS:
            what = f"fused {label} S {S}"
            got = call(n_splits=S)
            want = plain(S)
            if float(got[1].min()) != float(np.float32(da.NEG_INF)):
                fail(f"{what}: no empty split")
            worst = max(worst, check_fused(torch, da, lambda **x: call(
                n_splits=S, **x), got, want, tol, what))
            first = call(n_splits=S, merge=True)
            for k in range(3):
                again = call(n_splits=S, merge=True)
                if not torch.equal(again, first):
                    fail(f"{what}: launch {k + 2} in a row differs")
            counters_zero(torch, da, dev, what)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                outs = [call(n_splits=S, merge=True) for _ in range(20)]
            for rep in range(2):
                graph.replay()
                torch.cuda.synchronize()
                for k, o in enumerate(outs):
                    if not torch.equal(o, first):
                        fail(f"{what}: graph replay {rep + 1}, launch "
                             f"{k + 1} of 20 differs")
                counters_zero(torch, da, dev, f"{what} graph replay")
            del graph, outs
            n_cases += 1
        errs["lse_merge"] = max(errs["lse_merge"], worst)
        say(f"kernels ok: {label}, fused merge at S {FUSED_SPLITS}: bit "
            f"for bit lse_merge of the partials, 3 launches in a row and 2 "
            f"x 20 graph replays equal, counters zero; max |fused - plain| "
            f"{worst:.3e} (tol {tol})")
    say(f"kernels ok: the fused merge in {n_cases} split cases")


# --------------------------------------------------------------------------
# phase 3 / 4 helpers
# --------------------------------------------------------------------------
class LogitsTap:
    """Wraps ``transformer.lm_logits``: keeps an on-device all-finite flag
    (no sync per call) and, when ``record`` is set, a host copy of every
    logits tensor (of its last position only, with ``last_only``)."""

    def __init__(self, torch, tfm, record=False, last_only=False):
        self.torch, self.tfm, self.record = torch, tfm, record
        self.last_only = last_only
        self.inner = tfm.lm_logits
        self.finite = None
        self.calls = []

    def __call__(self, *a, **kw):
        out = self.inner(*a, **kw)
        ok = self.torch.isfinite(out).all()
        self.finite = ok if self.finite is None else self.finite & ok
        if self.record:
            kept = out[:, -1] if self.last_only else out
            self.calls.append(kept.float().cpu())
        return out

    def __enter__(self):
        self.tfm.lm_logits = self
        return self

    def __exit__(self, *exc):
        self.tfm.lm_logits = self.inner


def step_configs(steps):
    """Phase 3's two paths: every op on the kernels, and every op on its
    plain torch version (the chunked prefill twin, the RMSNorm oracle, the
    torch decode backends) with the same split counts."""
    base = steps.StepConfig().kernel_policy
    return {"cuda": steps.StepConfig(kernel_policy=dataclasses.replace(
                base, attention="cuda", rmsnorm="cuda", decode="cuda",
                ssd="cuda")),
            "torch": steps.StepConfig(kernel_policy=dataclasses.replace(
                base, attention="chunked", rmsnorm="ref", decode="torch",
                ssd="chunked", q_chunk=256, k_chunk=256))}


def reference_check(torch, dev, cfg, tfm, serving, steps, bridge):
    """Phase 3: kernels vs plain torch path, full width, fp32."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = bridge.init_lm(cfg32, torch.Generator().manual_seed(1), dev)
    reqs = serving.poisson_trace(4, rate_per_step=0.5, seed=3,
                                 vocab_size=cfg.vocab_size,
                                 prompt_len=(8, 24), max_new_tokens=(6, 12),
                                 shared_prefix_len=21, prompt_pools=2)
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                decode_chunk=4, cache_dtype="float32")
    runs = {}
    for backend, scfg in step_configs(steps).items():
        with LogitsTap(torch, tfm, record=True) as tap:
            rep = serving.ServeEngine(cfg32, ecfg, params, step_cfg=scfg,
                                      device=dev).run(reqs)
        runs[backend] = (rep, tap.calls)
    (rep_k, calls_k), (rep_t, calls_t) = runs["cuda"], runs["torch"]
    if rep_t.prefill_tokens_saved <= 0:
        fail("reference trace had no prefix-cache hit")
    for a, b in zip(rep_k.results, rep_t.results):
        if a.tokens != b.tokens:
            fail(f"reference: rid {a.rid} kernel stream {a.tokens} != "
                 f"plain {b.tokens}")
    if len(calls_k) != len(calls_t):
        fail("reference: different numbers of logits calls")
    err = max(float((a - b).abs().max()) for a, b in zip(calls_k, calls_t))
    if err > 1e-3:
        fail(f"reference: logits differ by {err:.3e} > 1e-3")
    say(f"reference ok: fp32 full-width streams equal on kernels and plain "
        f"path ({sum(len(r.tokens) for r in rep_k.results)} tokens, "
        f"{len(calls_k)} logits calls, max |dlogits| {err:.3e})")


def int8_reference(torch, np, dev, cfg, tfm, serving, steps, bridge):
    """Phase 3, int8 KV pages and the host tier on smollm at full width:
    the int8 engine (fp32 compute) on the kernels against the int8 engine
    on the plain twins (streams equal, logits within 1e-3); then a tight
    page pool with the host tier, every page-in checked bit for bit
    against its page-out: with bf16 pools (bf16 compute) the tier on and
    off give equal streams; with int8 pools (fp32 compute) the tier-on
    streams on the kernels equal the twins', and how far the tier-off run
    parts from them is printed."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = bridge.init_lm(cfg32, torch.Generator().manual_seed(5), dev)
    reqs = serving.poisson_trace(4, rate_per_step=0.5, seed=3,
                                 vocab_size=cfg.vocab_size,
                                 prompt_len=(8, 24), max_new_tokens=(6, 12),
                                 shared_prefix_len=21, prompt_pools=2)
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                decode_chunk=4, kv_dtype="int8")
    runs = {}
    for backend, scfg in step_configs(steps).items():
        with LogitsTap(torch, tfm, record=True) as tap:
            eng = serving.ServeEngine(cfg32, ecfg, params, step_cfg=scfg,
                                      device=dev)
            rep = eng.run(reqs)
        if eng.cache["units"]["sub0"]["k"].dtype != torch.int8:
            fail("int8 reference: the engine's pools are not int8")
        runs[backend] = (rep, tap.calls)
    (rep_k, calls_k), (rep_t, calls_t) = runs["cuda"], runs["torch"]
    if rep_t.prefill_tokens_saved <= 0:
        fail("int8 reference trace had no prefix-cache hit")
    for a, b in zip(rep_k.results, rep_t.results):
        if a.tokens != b.tokens:
            fail(f"int8 reference: rid {a.rid} kernel stream {a.tokens} != "
                 f"plain {b.tokens}")
    if len(calls_k) != len(calls_t):
        fail("int8 reference: different numbers of logits calls")
    err = max(float((a - b).abs().max()) for a, b in zip(calls_k, calls_t))
    if err > 1e-3:
        fail(f"int8 reference: logits differ by {err:.3e} > 1e-3")
    say(f"reference ok: fp32 full-width int8 engine streams equal on "
        f"kernels and plain twins "
        f"({sum(len(r.tokens) for r in rep_k.results)} tokens, "
        f"{len(calls_k)} logits calls, max |dlogits| {err:.3e})")
    # the launcher's poisson trace on a pool tight enough to page out
    treqs = serving.poisson_trace(8, rate_per_step=0.25, seed=0,
                                  vocab_size=cfg.vocab_size,
                                  prompt_len=(16, 32), max_new_tokens=(8, 16),
                                  shared_prefix_len=32, prompt_pools=2)
    # the sweeps take pools in q's dtype, so bf16 pools run a bf16 model
    params16 = bridge.init_lm(cfg, torch.Generator().manual_seed(5), dev)
    models = {"int8": (cfg32, params), "bfloat16": (cfg, params16)}
    scfgs = step_configs(steps)

    def tier_run(kv_dtype, tier, backend="cuda"):
        model, weights = models[kv_dtype]
        tcfg = serving.EngineConfig(
            n_slots=4, page_size=16, max_len=80, decode_chunk=8,
            n_pages=TIER_PAGES, kv_dtype=kv_dtype, host_tier=tier)
        eng = serving.ServeEngine(model, tcfg, weights,
                                  step_cfg=scfgs[backend], device=dev)
        inexact = []
        if tier:
            restore = eng.kv._restore_page

            def checked(page, blob):
                # every page-in must give back the paged-out bytes exactly
                restore(page, blob)
                back = eng._fetch_page(page)
                inexact.extend(key for key in blob if not np.array_equal(
                    back[key].view(np.uint8), blob[key].view(np.uint8)))
            eng.kv._restore_page = checked
        rep = eng.run(treqs)
        if inexact:
            fail(f"host tier ({kv_dtype} pools): a page-in did not restore "
                 f"the paged-out bytes ({sorted(set(inexact))})")
        return [r.tokens for r in rep.results], rep

    for kv_dtype in ("int8", "bfloat16"):
        on, rep = tier_run(kv_dtype, True)
        off, rep_off = tier_run(kv_dtype, False)
        if rep.n_demotions <= 0 or rep.n_promotions <= 0:
            fail(f"host tier ({kv_dtype} pools): {rep.n_demotions} "
                 f"page-outs, {rep.n_promotions} page-ins")
        differ = [i for i, (a, b) in enumerate(zip(on, off)) if a != b]
        if kv_dtype == "int8":
            # with the tier off, evicted prefixes are recomputed (other
            # matmul shapes, so other last bits of fp32) where the tier
            # restores them; int8 rows turn such bits into whole steps, so
            # the two runs may part: what must hold is the tier's own
            # exactness (checked above) and the kernels against the twins
            twin, _ = tier_run(kv_dtype, True, backend="torch")
            if twin != on:
                fail("host tier (int8 pools): kernel streams differ from "
                     "the plain twins' with the tier on")
            note = (f"kernels equal the twins with the tier on; tier off "
                    f"recomputes {rep_off.prompt_tokens - rep_off.prefill_tokens_saved}"
                    f" prompt tokens against {rep.prompt_tokens - rep.prefill_tokens_saved}"
                    f" and its streams differ at requests {differ}")
        else:
            if differ:
                fail(f"host tier ({kv_dtype} pools): streams differ with "
                     f"the tier on and off at requests {differ}")
            note = "streams equal with the tier on and off"
        say(f"reference ok: host tier, {kv_dtype} pools, {TIER_PAGES} pages: "
            f"{rep.n_demotions} paged out, {rep.n_promotions} paged in, every "
            f"page-in bit-exact, {rep.transfer_j:.4g} J modelled; {note}")


def batch_prompts(torch, np, dev, vocab):
    """The static batch's prompts: a 64-token pattern per request, repeated
    to PLEN tokens, so that the n-gram drafter finds its matches."""
    pat = np.random.default_rng(4).integers(0, vocab, (BATCH, 64))
    return torch.tensor(np.tile(pat, (1, PLEN // 64)), dtype=torch.int32,
                        device=dev)


def reference_batch_check(torch, np, dev, cfg, tfm, steps, speculate,
                          bridge):
    """Phase 3, static batch: ring decode on the kernels vs the plain torch
    backends (same split counts), full width, fp32; then the speculative
    loop on the kernels against the plain kernel loop's stream, both run
    past the ring's end so that the comparison covers the wrap."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tfm.prepare_params(
        bridge.init_lm(cfg32, torch.Generator().manual_seed(2), dev), cfg32)
    prompts = batch_prompts(torch, np, dev, cfg.vocab_size)

    def step_cfg(backend):
        return step_configs(steps)[backend]

    def prefill(scfg):
        pre = steps.make_prefill_step(cfg32, scfg, max_len=PLEN + GEN)
        last, cache = pre(params, {"inputs": prompts})
        return torch.argmax(last, dim=-1).to(torch.int32)[:, None], cache

    streams, calls = {}, {}
    with torch.no_grad():
        for backend in ("cuda", "torch"):
            scfg = step_cfg(backend)
            with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
                tok0, cache = prefill(scfg)
                toks, _ = steps.make_decode_loop(cfg32, scfg, GEN - 1)(
                    params, cache, tok0)
            streams[backend] = toks.cpu().numpy()
            calls[backend] = tap.calls
        if not np.array_equal(streams["cuda"], streams["torch"]):
            fail("batch reference: kernel stream differs from the plain "
                 "torch backends'")
        err = max(float((a - b).abs().max())
                  for a, b in zip(calls["cuda"], calls["torch"]))
        if err > 1e-3:
            fail(f"batch reference: logits differ by {err:.3e} > 1e-3")
        scfg = step_cfg("cuda")
        spec_steps, spec_k = GEN - 1, 3
        # the plain kernel loop, as far as the spec loop can reach: past
        # the ring's PLEN + GEN slots, so both wrap it
        tok0, cache = prefill(scfg)
        plain, _ = steps.make_decode_loop(
            cfg32, scfg, spec_steps * (spec_k + 1))(params, cache, tok0)
        plain = plain.cpu().numpy()
        if not np.array_equal(plain[:, :GEN - 1], streams["cuda"]):
            fail("batch reference: the long plain loop's stream differs "
                 "from the short one's")
        results = {}
        for name, k, n_steps in (("ngram", spec_k, spec_steps),
                                 ("replay", spec_k, 8)):
            drafter = (speculate.ReplayDrafter(k, plain) if name == "replay"
                       else speculate.get_drafter(name, k))
            tok0, cache = prefill(scfg)
            ds = drafter.init_state(BATCH)
            drafter.seed_batch(ds, prompts.cpu().numpy(),
                               tok0.cpu().numpy())
            loop = steps.make_speculative_decode_loop(cfg32, scfg, n_steps,
                                                      drafter=drafter)
            toks, counts, cache, _ = loop(params, cache, tok0,
                                          speculate.state_to(ds, dev))
            toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
            flat = np.concatenate([toks[:, s, :counts[0, s]]
                                   for s in range(n_steps)], axis=1)
            if not np.array_equal(flat, plain[:, :flat.shape[1]]):
                fail(f"batch reference: {name} speculative stream differs "
                     "from the plain loop's")
            if int(cache["pos"]) != PLEN + flat.shape[1]:
                fail(f"batch reference: {name} ring at {int(cache['pos'])}"
                     f" after {flat.shape[1]} tokens from {PLEN}")
            acc = (counts.sum() / counts.size - 1) / k
            results[name] = (acc, int(cache["pos"]), flat.shape[1])
    if results["ngram"][1] <= PLEN + GEN:
        fail(f"batch reference: the n-gram spec loop reached position "
             f"{results['ngram'][1]}, so it never wrapped the ring of "
             f"{PLEN + GEN} slots")
    if results["replay"][0] != 1.0:
        fail(f"batch reference: replay acceptance {results['replay'][0]} "
             "!= 1.0")
    say(f"reference ok: fp32 full-width batch of {BATCH} x {PLEN} tokens, "
        f"{GEN - 1} ring decode steps: streams equal on kernels and plain "
        f"path, max |dlogits| {err:.3e}; n-gram K 3 speculative stream "
        f"equals the plain kernel loop's over all its "
        f"{results['ngram'][2]} tokens (acceptance "
        f"{results['ngram'][0]:.0%}, ring of {PLEN + GEN} slots wrapped to "
        f"position {results['ngram'][1]}), replay acceptance "
        f"{results['replay'][0]:.0%}")


def gemma_reference(torch, np, dev, gcfg, tfm, serving, steps, bridge):
    """Phase 3, gemma2 at full width in fp32, cut to 2 local/global units
    (4 layers), its norm weights perturbed so that the (1 + w) form is
    read: :func:`zoo_reference` on the static batch of 2 x 4352 prompt
    tokens + 16 new and on the engine trace of :func:`long_trace`."""
    def perturb(params):
        g = torch.Generator(device=dev).manual_seed(4)
        for blk in params["layers"].values():
            for key, t in blk.items():
                if "norm" in key:
                    t.add_(0.1 * torch.randn(t.shape, generator=g,
                                             device=dev))

    reqs, ecfg = long_trace(serving, np.random.default_rng(6),
                            gcfg.vocab_size)
    zoo_reference(torch, np, dev, gcfg, tfm, serving, steps, bridge,
                  "gemma2", seed=3, batch=2, plen=G_LONG, gen=16, reqs=reqs,
                  ecfg=ecfg, ring=gcfg.local_window, n_layers=4,
                  perturb=perturb)


def long_trace(serving, rng, vocab):
    """The engine trace of a model whose layers are windowed at 4096: a
    prompt of 4200 (inject wraps the private ring), 4080 + 40 new (decode
    wraps it) and a late 64, over 2 slots."""
    prompt = lambda n: rng.integers(0, vocab, n).astype("int32")
    reqs = [serving.Request(0, prompt(4200), 8),
            serving.Request(1, prompt(4080), 40),
            serving.Request(2, prompt(64), 16, arrival_step=2)]
    return reqs, serving.EngineConfig(n_slots=2, page_size=16,
                                      max_len=G_LONG, decode_chunk=8,
                                      cache_dtype="float32")


def zoo_reference(torch, np, dev, full, tfm, serving, steps, bridge, label,
                  *, seed, batch, plen, gen, reqs, ecfg, ring=0,
                  n_layers=ZOO_REF_LAYERS, perturb=None):
    """Phase 3, a model at full width in fp32, cut to ``n_layers`` layers,
    on the kernels and on the plain path: the static batch of ``batch`` x
    ``plen`` prompt tokens (of ``n_codebooks`` codes each for a codebook
    model) + ``gen`` new, then the engine on ``reqs`` (prefix hits
    required of a model the prefix cache serves).  Greedy streams equal,
    every logits call (its last position) within 1e-3, every request
    finishing its budget.  ``ring``: the window's ring
    size, which the batch's rings must hold and wrap; ``perturb``: called
    on the drawn parameters before they are prepared."""
    cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
    params = bridge.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if perturb is not None:
        perturb(params)
    params = tfm.prepare_params(params, cfg)
    prompts = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, plen) + ((cfg.n_codebooks,)
                                            if cfg.n_codebooks else ())),
        dtype=torch.int32, device=dev)

    def compare(what, streams, calls):
        if not all(np.array_equal(a, b)
                   for a, b in zip(streams["cuda"], streams["torch"])):
            fail(f"{label} reference {what}: kernel stream differs from the "
                 "plain path's")
        if len(calls["cuda"]) != len(calls["torch"]):
            fail(f"{label} reference {what}: different logits calls")
        err = max(float((a - b).abs().max())
                  for a, b in zip(calls["cuda"], calls["torch"]))
        if err > 1e-3:
            fail(f"{label} reference {what}: logits differ by {err:.3e} > "
                 "1e-3")
        return err

    streams, calls = {}, {}
    with torch.no_grad():
        for backend, scfg in step_configs(steps).items():
            with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
                pre = steps.make_prefill_step(cfg, scfg, max_len=plen + gen)
                last, cache = pre(params, {"inputs": prompts})
                tok0 = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
                toks, cache = steps.make_decode_loop(cfg, scfg, gen - 1)(
                    params, cache, tok0)
            if ring and (cache["units"]["sub0"]["k"].shape[2] != ring
                         or int(cache["pos"]) <= ring):
                fail(f"{label} reference batch: the rings are not {ring} "
                     "slots past their wrap")
            streams[backend] = torch.cat([tok0, toks], 1).cpu().numpy()
            calls[backend] = tap.calls
            del cache
    err = compare("batch", streams, calls)
    say(f"reference ok: {label} fp32 full width, {n_layers} layers, "
        f"batch of {batch} x {plen} tokens + {gen} new"
        + (f" (window {ring} masks prefill, rings wrapped)" if ring else "")
        + f": streams equal on kernels and plain path, "
        f"{len(calls['cuda'])} logits calls within {err:.3e}")

    streams, calls, reps = {}, {}, {}
    for backend, scfg in step_configs(steps).items():
        with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
            rep = serving.ServeEngine(cfg, ecfg, params, step_cfg=scfg,
                                      device=dev).run(reqs)
        for r in rep.results:
            if r.n_tokens != r.max_new_tokens:
                fail(f"{label} reference engine: rid {r.rid} finished "
                     f"{r.n_tokens}/{r.max_new_tokens}")
        streams[backend] = [r.tokens for r in rep.results]
        calls[backend] = tap.calls
        reps[backend] = rep
    if not tfm.chunked_prefill_blockers(cfg) \
            and reps["cuda"].prefill_tokens_saved <= 0:
        fail(f"{label} reference engine: no prefix-cache hit")
    err = compare("engine", streams, calls)
    longest = max(r.prompt_len + r.n_tokens for r in reps["cuda"].results)
    say(f"reference ok: {label} fp32 full width, {n_layers} layers, "
        f"engine: {len(reqs)} requests over {ecfg.n_slots} slots, "
        f"{reps['cuda'].prefill_tokens_saved} prompt tokens restored, "
        f"longest {longest} positions: streams equal on kernels and plain "
        f"path, {len(calls['cuda'])} logits calls within {err:.3e}")
    del params


def zoo_references(torch, np, dev, get_arch, tfm, serving, steps, bridge):
    """Phase 3 for the four zoo families: h2o-danube-3 on the batch of 2 x
    G_LONG prompt tokens + 16 new (the 4096 window masks prefill, the
    rings wrap) and an engine trace whose requests pass 4096 positions
    (the private rings wrap at inject and in decode); stablelm, phi3.5
    and llava on 2 x 512 + 16 new and 6 Poisson requests over 4 slots with
    2 shared 21-token prompt heads (prefix hits run the paged verify
    sweep); musicgen (G 1 on the paged and ring sweeps, four codebooks)
    and zamba2 (one unit: 2 Mamba2 layers at N 64 and its shared block,
    whose engine buffers decode on the ring sweep with per-row positions)
    on the same batch and 6 Poisson requests without shared heads (the
    prefix cache does not serve them)."""
    h2o = get_arch("h2o-danube-3-4b").config
    reqs, ecfg = long_trace(serving, np.random.default_rng(12),
                            h2o.vocab_size)
    zoo_reference(torch, np, dev, h2o, tfm, serving, steps, bridge,
                  "h2o-danube-3", seed=13, batch=2, plen=G_LONG, gen=16,
                  reqs=reqs, ecfg=ecfg, ring=H2O_WINDOW)
    torch.cuda.empty_cache()
    for i, arch in enumerate(("stablelm-1.6b", "phi3.5-moe-42b-a6.6b",
                              "llava-next-34b")):
        full = get_arch(arch).config
        reqs = serving.poisson_trace(6, rate_per_step=0.5, seed=11,
                                     vocab_size=full.vocab_size,
                                     prompt_len=(8, 24),
                                     max_new_tokens=(6, 12),
                                     shared_prefix_len=21, prompt_pools=2)
        zoo_reference(
            torch, np, dev, full, tfm, serving, steps, bridge, arch,
            seed=14 + i, batch=2, plen=PLEN, gen=16, reqs=reqs,
            ecfg=serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                      decode_chunk=4,
                                      cache_dtype="float32"))
        torch.cuda.empty_cache()
    for i, arch in enumerate(("musicgen-medium", "zamba2-1.2b")):
        full = get_arch(arch).config
        reqs = serving.poisson_trace(6, rate_per_step=0.5, seed=15,
                                     vocab_size=full.vocab_size,
                                     prompt_len=(8, 24),
                                     max_new_tokens=(6, 12),
                                     n_codebooks=full.n_codebooks)
        zoo_reference(
            torch, np, dev, full, tfm, serving, steps, bridge, arch,
            seed=17 + i, batch=2, plen=PLEN, gen=16, reqs=reqs,
            ecfg=serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                      decode_chunk=4,
                                      cache_dtype="float32"))
        torch.cuda.empty_cache()


def refuse_pages(engine, n_refusals: int, first: int):
    """Make the engine's page pool say no ``n_refusals`` times, from its
    ``first``-th ``kv.ensure`` call on, whenever two slots or more are
    active (so that the asking slot or another can be preempted).  A state-
    slot model has no pool to run dry: this is how its run forces
    preemption, the same way on both paths."""
    inner, state = engine.kv.ensure, {"calls": 0, "left": n_refusals}

    def ensure(slot, n_tokens):
        state["calls"] += 1
        if state["left"] and state["calls"] >= first \
                and engine.scheduler.n_active > 1:
            state["left"] -= 1
            return False
        return inner(slot, n_tokens)

    engine.kv.ensure = ensure
    return engine


def mamba_reference(torch, np, dev, mcfg, tfm, serving, steps, bridge):
    """Phase 3, mamba2-370m at full width and depth in fp32, on the kernels
    and on the plain path: the static batch (8 x 512 prompt tokens + 32
    decode steps) and the engine on 8 Poisson requests over 4 slots with
    two forced preemptions.  Greedy streams equal, every logits call (its
    last position) within 1e-3."""
    cfg = dataclasses.replace(mcfg, dtype="float32")
    params = tfm.prepare_params(bridge.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(5), dev), cfg)
    prompts = batch_prompts(torch, np, dev, cfg.vocab_size)

    def compare(label, streams, calls):
        if not all(np.array_equal(a, b)
                   for a, b in zip(streams["cuda"], streams["torch"])):
            fail(f"mamba2 reference {label}: kernel stream differs from the "
                 "plain path's")
        if len(calls["cuda"]) != len(calls["torch"]):
            fail(f"mamba2 reference {label}: different logits calls")
        err = max(float((a - b).abs().max())
                  for a, b in zip(calls["cuda"], calls["torch"]))
        if err > 1e-3:
            fail(f"mamba2 reference {label}: logits differ by {err:.3e} > "
                 "1e-3")
        return err

    streams, calls = {}, {}
    with torch.no_grad():
        for backend, scfg in step_configs(steps).items():
            with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
                pre = steps.make_prefill_step(cfg, scfg, max_len=PLEN + GEN)
                last, cache = pre(params, {"inputs": prompts})
                tok0 = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
                toks, cache = steps.make_decode_loop(cfg, scfg, GEN - 1)(
                    params, cache, tok0)
            streams[backend] = torch.cat([tok0, toks], 1).cpu().numpy()
            calls[backend] = tap.calls
            del cache
    err = compare("batch", streams, calls)
    say(f"reference ok: mamba2 fp32 full width, 48 layers, batch of {BATCH} "
        f"x {PLEN} tokens + {GEN - 1} decode steps: streams equal on kernels"
        f" and plain path, {len(calls['cuda'])} logits calls within "
        f"{err:.3e}")

    reqs = serving.poisson_trace(8, rate_per_step=0.5, seed=8,
                                 vocab_size=cfg.vocab_size,
                                 prompt_len=(16, 64),
                                 max_new_tokens=(8, 24))
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=96,
                                decode_chunk=4, cache_dtype="float32")
    streams, calls = {}, {}
    for backend, scfg in step_configs(steps).items():
        eng = refuse_pages(serving.ServeEngine(cfg, ecfg, params,
                                               step_cfg=scfg, device=dev),
                           2, first=6)
        with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
            rep = eng.run(reqs)
        for r in rep.results:
            if r.n_tokens != r.max_new_tokens:
                fail(f"mamba2 reference engine: rid {r.rid} finished "
                     f"{r.n_tokens}/{r.max_new_tokens}")
        if rep.n_preemptions != 2:
            fail(f"mamba2 reference engine: {rep.n_preemptions} "
                 "preemptions, 2 forced")
        streams[backend] = [r.tokens for r in rep.results]
        calls[backend] = tap.calls
    err = compare("engine", streams, calls)
    say(f"reference ok: mamba2 fp32 full width, 48 layers, engine: 8 "
        f"Poisson requests over 4 slots, 2 preemptions (folded prompts "
        f"prefilled again): streams equal on kernels and plain path, "
        f"{len(calls['cuda'])} logits calls within {err:.3e}")


def deepseek_reference(torch, np, dev, dcfg, tfm, serving, steps, bridge):
    """Phase 3, deepseek-v2 at full width in fp32, cut to 3 layers (1 dense
    + 2 MoE), on the kernels and on the plain path: the static batch (2 x
    256 prompt tokens, so the MoE's capacity drops pairs, + 16 new) and the
    engine on 6 Poisson requests over 4 slots with 2 shared 21-token
    prompt heads (prefix hits run the latent verify form) and two forced
    preemptions.  Greedy streams equal, every logits call (its last
    position) within 1e-3."""
    cfg = dataclasses.replace(dcfg, n_layers=DS_REF_LAYERS, dtype="float32")
    params = tfm.prepare_params(bridge.init_lm(
        cfg, torch.Generator(device=dev).manual_seed(7), dev), cfg)
    rng = np.random.default_rng(9)
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                           dtype=torch.int32, device=dev)

    def compare(label, streams, calls):
        if not all(np.array_equal(a, b)
                   for a, b in zip(streams["cuda"], streams["torch"])):
            fail(f"deepseek reference {label}: kernel stream differs from "
                 "the plain path's")
        if len(calls["cuda"]) != len(calls["torch"]):
            fail(f"deepseek reference {label}: different logits calls")
        err = max(float((a - b).abs().max())
                  for a, b in zip(calls["cuda"], calls["torch"]))
        if err > 1e-3:
            fail(f"deepseek reference {label}: logits differ by {err:.3e} > "
                 "1e-3")
        return err

    streams, calls = {}, {}
    with torch.no_grad():
        for backend, scfg in step_configs(steps).items():
            with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
                pre = steps.make_prefill_step(cfg, scfg, max_len=256 + 16)
                last, cache = pre(params, {"inputs": prompts})
                tok0 = torch.argmax(last, dim=-1).to(torch.int32)[:, None]
                toks, cache = steps.make_decode_loop(cfg, scfg, 15)(
                    params, cache, tok0)
            streams[backend] = torch.cat([tok0, toks], 1).cpu().numpy()
            calls[backend] = tap.calls
            del cache
    err = compare("batch", streams, calls)
    say(f"reference ok: deepseek fp32 full width, {DS_REF_LAYERS} layers, "
        f"batch of 2 x 256 tokens + 15 decode steps (MoE capacity drops at "
        f"prefill, ring latent decode): streams equal on kernels and plain "
        f"path, {len(calls['cuda'])} logits calls within {err:.3e}")

    reqs = serving.poisson_trace(6, rate_per_step=0.5, seed=11,
                                 vocab_size=cfg.vocab_size,
                                 prompt_len=(8, 24), max_new_tokens=(6, 12),
                                 shared_prefix_len=21, prompt_pools=2)
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=64,
                                decode_chunk=4, cache_dtype="float32")
    streams, calls, reps = {}, {}, {}
    for backend, scfg in step_configs(steps).items():
        eng = refuse_pages(serving.ServeEngine(cfg, ecfg, params,
                                               step_cfg=scfg, device=dev),
                           2, first=6)
        with LogitsTap(torch, tfm, record=True, last_only=True) as tap:
            rep = eng.run(reqs)
        for r in rep.results:
            if r.n_tokens != r.max_new_tokens:
                fail(f"deepseek reference engine: rid {r.rid} finished "
                     f"{r.n_tokens}/{r.max_new_tokens}")
        if rep.n_preemptions != 2 or rep.prefill_tokens_saved <= 0:
            fail(f"deepseek reference engine: {rep.n_preemptions} "
                 f"preemptions (2 forced), {rep.prefill_tokens_saved} "
                 "prompt tokens restored from the prefix cache")
        streams[backend] = [r.tokens for r in rep.results]
        calls[backend] = tap.calls
        reps[backend] = rep
    err = compare("engine", streams, calls)
    say(f"reference ok: deepseek fp32 full width, {DS_REF_LAYERS} layers, "
        f"engine: 6 Poisson requests over 4 slots, "
        f"{reps['cuda'].prefill_tokens_saved} prompt tokens restored "
        f"(latent verify form), 2 preemptions: streams equal on kernels and "
        f"plain path, {len(calls['cuda'])} logits calls within {err:.3e}")
    del params


# --------------------------------------------------------------------------
# phase 5 helpers
# --------------------------------------------------------------------------
def _events_ms(torch, run, iters):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        run()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_ms(torch, fn, iters=20, reps=50, warmup=3):
    """Device time of one call of ``fn``: ``reps`` calls captured into one
    CUDA graph, replayed ``iters`` times between CUDA events.  The host's
    launch cost (Python, ctypes, allocator) stays out of the number, and
    one replay holds enough work that the replay's own launch is hidden
    too."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _events_ms(torch, graph.replay, iters) / reps


def sweep_work(c, n_splits, verify):
    """(bytes, flops) the sweep needs on these inputs: q, the k/v rows of
    every page holding a valid key, their table entries and pos read once,
    candidates (verify), outputs written once."""
    q = c["q"]
    B, Q, Hq, D = q.shape
    ps, Hkv = c["k_pages"].shape[1], c["k_pages"].shape[2]
    nb = c["block_tables"].shape[1]
    es = q.element_size()
    pos = c["pos"].tolist()
    keys = [p if verify else p + 1 for p in pos]          # valid keys / req
    pages = sum(min(nb, -(-k // ps)) for k in keys)
    nbytes = (q.numel() * es + 2 * pages * ps * Hkv * kv_row_bytes(c, "k_pages")
              + pages * 4 + B * 4)
    if verify:
        nbytes += 2 * B * Q * Hkv * D * es
    S = max(1, min(n_splits, nb))
    nbytes += (B * Q * Hq * D * es if S == 1
               else B * Hq * S * Q * (D + 1) * 4)
    k_tot = sum(keys) + (Q if verify else 0) * B
    flops = 4.0 * Q * Hq * D * k_tot
    return nbytes, flops


def kv_row_bytes(c, key):
    """Bytes of one cached kv row: D values in the cache's dtype, plus the
    fp32 scale of an int8 row."""
    t = c[key]
    return t.shape[-1] * t.element_size() + (4 if "k_scale" in c else 0)


def dequantized(torch, c, keys):
    """An int8 case's caches dequantized to q's dtype and its scales
    dropped: the library yardstick's inputs, made outside the timed call."""
    out = {k: v for k, v in c.items() if k not in ("k_scale", "v_scale")}
    for key, name in zip(keys, ("k_scale", "v_scale")):
        out[key] = (c[key].float() * c[name]).to(c["q"].dtype)
    return out


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def form_row(torch, da, sweep, plain_sweep, n, work, *, plain=True,
             iters=5, reps=10):
    """A kernels-line row of one sweep form at ``n`` splits, timed in the
    form the main paths launch: at one split the one launch; at several
    the fused launch (``sweep(n_splits=n, merge=True)``: stage 1, then
    the merge in the last block of each row tile), its bound ``work``
    (stage 1's bytes and FLOPs) plus the tail's bytes (the partials and
    log-sum-exps read back, the output written), its plain version the
    plain sweep then ``lse_merge_torch``, and stage 1 alone (``merge=
    False``) kept as ``stage1_ms``, a diagnostic."""
    nbytes, flops = work
    if n == 1:
        ms = time_ms(torch, lambda: sweep(n_splits=1))
        pl = (time_ms(torch, lambda: plain_sweep(1), iters=iters, reps=reps)
              if plain else None)
        extra = {}
    else:
        partial, lse = sweep(n_splits=n)
        out = sweep(n_splits=n, merge=True)
        nbytes += ((partial.numel() + lse.numel()) * 4
                   + out.numel() * out.element_size())
        ms = time_ms(torch, lambda: sweep(n_splits=n, merge=True))
        pl = (time_ms(torch, lambda: da.lse_merge_torch(
            *plain_sweep(n), out.dtype).transpose(1, 2).contiguous(),
            iters=iters, reps=reps) if plain else None)
        extra = dict(stage1_ms=time_ms(torch, lambda: sweep(n_splits=n)))
    b_ms, b_by = bound(nbytes, flops)
    return dict(ms=ms, plain_ms=pl, bound_ms=b_ms, bound_by=b_by,
                n_splits=n, **extra)


def tail_row(torch, da, row, partial, lse, **kw):
    """The ``lse_merge`` row of the kernels line from a split form's
    ``form_row`` and its partials: the fused tail's own cost (the fused
    launch less stage 1, both timed in this run), its bound (the partials
    and log-sum-exps read, the bf16 output written), the plain merge;
    the standalone kernel's time (no main path launches it) is said."""
    S = partial.shape[-3]
    m_ms = time_ms(torch, lambda: da.lse_merge(partial, lse, torch.bfloat16))
    m_pl = time_ms(torch, lambda: da.lse_merge_torch(
        partial, lse, torch.bfloat16), iters=5, reps=10)
    mb, mby = bound((partial.numel() + lse.numel()) * 4
                    + partial.numel() // S * 2, 3.0 * partial.numel())
    tail = row["ms"] - row["stage1_ms"]
    say(f"lse_merge, {kw.get('what', 'paged decode')} (n_splits {S}): "
        f"fused tail {tail * 1e3:.2f} us (fused launch "
        f"{row['ms'] * 1e3:.2f} less stage 1 {row['stage1_ms'] * 1e3:.2f}),"
        f" standalone kernel {m_ms * 1e3:.2f} us, plain {m_pl * 1e3:.1f} "
        f"us, bound {mb * 1e3:.3f} us ({mby})")
    return dict(ms=tail, plain_ms=m_pl, library_ms=None, bound_ms=mb,
                bound_by=mby, n_splits=S, standalone_ms=m_ms,
                **{k: v for k, v in kw.items() if k != "what"})


def sdpa_yardstick(torch, c, verify, scale=None):
    """One F.scaled_dot_product_attention call over the pages gathered in
    logical order (GQA heads expanded), with the same masks and scale (no
    soft-cap: no single call has one)."""
    F = torch.nn.functional
    q = c["q"]
    B, Q, Hq, D = q.shape
    ps, Hkv = c["k_pages"].shape[1], c["k_pages"].shape[2]
    nb = c["block_tables"].shape[1]
    G = Hq // Hkv
    bt = c["block_tables"].long()

    def gather(pages, new):
        g = pages[bt].reshape(B, nb * ps, Hkv, D)
        if verify:
            g = torch.cat([g, new], dim=1)
        return g.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    k, v = gather(c["k_pages"], c["k_new"]), gather(c["v_pages"], c["v_new"])
    pos = c["pos"].long()[:, None, None]
    qi = torch.arange(Q, device=q.device)[None, :, None]
    kp = torch.arange(nb * ps, device=q.device)[None, None, :]
    if verify:
        nj = torch.arange(Q, device=q.device)[None, None, :]
        mask = torch.cat([(kp < pos).expand(B, Q, nb * ps),
                          (nj <= qi).expand(B, Q, Q)], dim=-1)
    else:
        mask = kp <= pos
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, k, v, attn_mask=mask,
                                                  scale=scale)


# The paged sweep's phase-5 forms (q bf16): (form, heads, int8 pools, the
# sweep's keyword arguments, the main paths whose launches its rows count:
# a label's first word, or None for all).  A form gives four rows of the
# kernels line, named "paged_attention_sweep[ int8] (decode|verify)[
# form]", at the engine's split count (K2a, K3b) and ", 1 split" (K1,
# K3a), at the engine's shapes (4 slots, 5 pages of 16, decode pos 64..79,
# verify Q 16 at pos 16..48); "deep" at 256-page tables (4096 positions,
# which no main path reaches on pages: no launches).
PAGED_FORMS = [
    ("", dict(Hq=9, Hkv=3, D=64), False, {}, None),
    ("", dict(Hq=9, Hkv=3, D=64), True, {}, None),
    ("D 120", H2O_HEADS, False, {}, ("h2o",)),
    ("D 120", H2O_HEADS, True, {}, ("h2o",)),
    ("gemma2", dict(Hq=32, Hkv=16, D=128), False, GEMMA_ATTN, ("gemma2",)),
    ("G 7", LLAVA_HEADS, False, {}, ("llava",)),
    ("G 1", STABLELM_HEADS, False, {}, ("stablelm",)),
    ("deep", dict(Hq=9, Hkv=3, D=64, nb=256), False, {}, ("deep",)),
]
DEEP_POS = {False: [4095, 3001, 2048, 777], True: [4000, 2900, 16, 1031]}


def paged_timings(torch, np, dev, da, ops, quant, plain=True):
    """Phase 5, the paged sweep at ``PAGED_FORMS``: CUDA-event times of the
    kernel beside its bound (an int8 kv row D + 4 bytes) and, with
    ``plain``, its plain version and SDPA over the gathered cache (int8
    dequantized to bf16 beforehand, outside the timed call; gemma2's scale
    without its cap).  Returns the rows by name."""
    out = {}
    for form, heads, int8, kw, family in PAGED_FORMS:
        shp = dict(dict(B=4, ps=16, nb=5), **heads)
        tag = " int8" if int8 else ""
        for verify, Q in ((False, 1), (True, 16)):
            entry = (f"paged_attention_sweep{tag} "
                     f"({'verify' if verify else 'decode'})")
            name = f"{entry} {form}" if form else entry
            if form == "deep":
                pos = DEEP_POS[verify]
            else:
                pos = [32, 48, 16, 32] if verify else [64, 71, 75, 79]
            c = make_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                          seed=100 + Q, **shp)
            if int8:
                c = quantize_case(quant, c, ("k_pages", "v_pages"))
            args, vkw = sweep_args(c, verify)
            S = ops.choose_kv_splits(4, shp["nb"] * 16, heads["Hq"],
                                     block=16, device=dev)
            lib = (time_ms(torch, sdpa_yardstick(
                torch, dequantized(torch, c, ("k_pages", "v_pages"))
                if int8 else c, verify, kw.get("scale"))) if plain else None)
            for n in sorted({S, 1}, reverse=True):
                slow = form == "deep" and n == 1
                r = form_row(
                    torch, da,
                    lambda **x: da.paged_attention_sweep(*args, **vkw, **kw,
                                                         **x),
                    lambda m: da.paged_attention_sweep_torch(
                        *args, **vkw, n_splits=m, **kw),
                    n, sweep_work(c, n, verify), plain=plain,
                    iters=3 if slow else 5, reps=3 if slow else 10)
                row = name if n == S else f"{name}, 1 split"
                out[row] = dict(r, library_ms=lib, entry=entry,
                                family=family, err=name)
                if plain:
                    say(f"{row} (n_splits {n}): kernel {r['ms'] * 1e3:.1f} "
                        f"us{stage1_note(r)}, plain "
                        f"{r['plain_ms'] * 1e3:.1f} us, bound "
                        f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}), "
                        f"sdpa {lib * 1e3:.1f} us")
    return out


def stage1_note(r):
    """A split row's stage 1 alone, for its line."""
    return (f" (fused; stage 1 alone {r['stage1_ms'] * 1e3:.2f} us)"
            if "stage1_ms" in r else "")


def timings(torch, np, dev, da, ops):
    """Phase 5, the merge at the main path's shapes (the paged decode's, 4
    slots, 5 pages of 16, the engine's split count): the fused tail's own
    cost (``tail_row``), and the deep decode's fused sweep beside SDPA."""
    out = {}
    main = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=5)
    c = make_case(torch, np, dev, pos=[64, 71, 75, 79], Q=1,
                  dtype="bfloat16", seed=101, **main)
    S = ops.choose_kv_splits(4, 80, 9, block=16, device=dev)
    args, _ = sweep_args(c, False)
    row = form_row(torch, da, lambda **x: da.paged_attention_sweep(*args,
                                                                   **x),
                   None, S, sweep_work(c, S, False), plain=False)
    out["lse_merge"] = tail_row(torch, da, row,
                                *da.paged_attention_sweep(*args, n_splits=S))
    # the deep case, for the record (not the main path's shape)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, ps=16, nb=256)
    c = make_case(torch, np, dev, pos=[4095, 3001, 2048, 777], Q=1,
                  dtype="bfloat16", seed=7, **deep)
    S = ops.choose_kv_splits(4, 4096, 9, block=16, device=dev)
    args, _ = sweep_args(c, False)
    d_ms = time_ms(torch, lambda: da.paged_attention(*args, n_splits=S))
    d_plain = time_ms(torch, lambda: da.lse_merge_torch(
        *da.paged_attention_sweep_torch(*args, n_splits=S), torch.bfloat16),
        iters=3, reps=5)
    d_lib = time_ms(torch, sdpa_yardstick(torch, c, False))
    nbytes, flops = sweep_work(c, S, False)
    say(f"deep decode (4 slots, 4096-position tables, n_splits {S}): "
        f"fused sweep {d_ms * 1e3:.1f} us, plain {d_plain * 1e3:.1f} us, "
        f"sdpa {d_lib * 1e3:.1f} us, bound {bound(nbytes, flops)[0] * 1e3:.2f}"
        f" us ({nbytes / 1e6:.2f} MB)")
    return out


def ring_valid(torch, c, verify):
    """(B, Q, C) validity of every ring slot for every query row, as the
    sweep masks it (no window)."""
    q = c["q"]
    B, Q = q.shape[:2]
    C = c["k"].shape[1]
    pos = c["pos"].long().reshape(-1, 1, 1)
    ref = pos - 1 if verify else pos
    kp = ref - torch.remainder(ref - torch.arange(C, device=q.device), C)
    valid = kp >= 0
    if verify:
        qi = torch.arange(Q, device=q.device)[None, :, None]
        valid = valid & (kp > pos + qi - C)
    return valid.expand(B, Q, C)


def ring_work(torch, c, n_splits, verify):
    """(bytes, flops) the ring sweep needs on these inputs: q, the k/v rows
    of every slot some row may see, pos, candidates (verify) read once,
    outputs written once; 4 flops per (row, key, dim, head) kept."""
    q = c["q"]
    B, Q, Hq, D = q.shape
    Hkv = c["k"].shape[2]
    es = q.element_size()
    valid = ring_valid(torch, c, verify)                   # (B, Q, C)
    slots = int(valid.any(dim=1).sum())
    nbytes = (q.numel() * es + 2 * slots * Hkv * kv_row_bytes(c, "k")
              + c["pos"].numel() * 4)
    k_tot = int(valid.sum())
    if verify:
        nbytes += 2 * B * Q * Hkv * D * es
        k_tot += B * Q * (Q + 1) // 2
    S = max(1, n_splits)
    nbytes += (B * Q * Hq * D * es if S == 1
               else B * Hq * S * Q * (D + 1) * 4)
    return nbytes, 4.0 * Hq * D * k_tot


def ring_sdpa_yardstick(torch, c, verify):
    """One F.scaled_dot_product_attention call over the ring (and the
    candidates, for verify), expanded to all q heads beforehand, with the
    sweep's validity as its mask."""
    F = torch.nn.functional
    q = c["q"]
    B, Q, Hq, D = q.shape
    G = Hq // c["k"].shape[2]
    mask = ring_valid(torch, c, verify)
    k, v = c["k"], c["v"]
    if verify:
        k = torch.cat([k, c["k_new"]], dim=1)
        v = torch.cat([v, c["v_new"]], dim=1)
        qi = torch.arange(Q, device=q.device)
        mask = torch.cat([mask, (qi[None, :] <= qi[:, None]).expand(
            B, Q, Q)], dim=-1)

    def expand(t):
        return t.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()

    ke, ve = expand(k), expand(v)
    qt = q.transpose(1, 2).contiguous()
    m = mask[:, None].contiguous()
    return lambda: F.scaled_dot_product_attention(qt, ke, ve, attn_mask=m)


def ring_timings(torch, np, dev, da, ops, plain=True):
    """Phase 5, ring sweep, at the batch path's shapes (8 requests, ring
    of 545 slots, bf16), mid-run (pos 528): each entry at the engine's
    split count and at 1 split (``<entry>, 1 split``), beside its bound
    and, with ``plain``, its plain version and SDPA."""
    out = {}
    shp = dict(B=BATCH, Hq=9, Hkv=3, D=64, C=PLEN + GEN)
    S = ops.choose_kv_splits(BATCH, PLEN + GEN, 9, block=256, device=dev)
    for verify, Q in ((False, 1), (True, 4)):
        name = ("ring_attention_sweep (verify)" if verify
                else "ring_attention_sweep (decode)")
        c = make_ring_case(torch, np, dev, pos=528, Q=Q, dtype="bfloat16",
                           seed=300 + Q, **shp)
        args, kw = ring_args(c, verify)
        lib = (time_ms(torch, ring_sdpa_yardstick(torch, c, verify))
               if plain else None)
        for n in (S, 1):
            r = form_row(
                torch, da,
                lambda **x: da.ring_attention_sweep(*args, **kw, block_k=256,
                                                    **x),
                lambda m: da.ring_attention_sweep_torch(
                    *args, **kw, n_splits=m, block_k=256),
                n, ring_work(torch, c, n, verify), plain=plain)
            row = name if n == S else f"{name}, 1 split"
            out[row] = dict(r, library_ms=lib, entry=name, err=name)
    if not plain:
        return out
    # the deep case, for the record (not the main path's shape)
    deep = dict(B=4, Hq=9, Hkv=3, D=64, C=4096)
    c = make_ring_case(torch, np, dev, pos=4000, Q=1, dtype="bfloat16",
                       seed=307, **deep)
    S = ops.choose_kv_splits(4, 4096, 9, block=256, device=dev)
    args, _ = ring_args(c, False)
    d_ms = time_ms(torch, lambda: da.ring_attention(*args, n_splits=S,
                                                    block_k=256))
    d_lib = time_ms(torch, ring_sdpa_yardstick(torch, c, False))
    nbytes, flops = ring_work(torch, c, S, False)
    say(f"deep ring decode (4 requests, 4096 slots, n_splits {S}): "
        f"fused sweep {d_ms * 1e3:.1f} us, sdpa {d_lib * 1e3:.1f} us, bound "
        f"{bound(nbytes, flops)[0] * 1e3:.2f} us ({nbytes / 1e6:.2f} MB)")
    return out


def ring_form_timings(torch, np, dev, da, ops, quant, *, heads, batch,
                      int8, family=None, plain=True):
    """Phase 5, the ring sweep in one form, bf16 q, at a batch path's
    shapes (``batch`` requests, a ring of 545 slots, pos 528, verify Q 4),
    rings in bf16 or int8, at ``heads`` (Hq, Hkv, D).  Each entry at its
    split count and at 1 split (``<row>, 1 split``), beside its bound (an
    int8 kv row D + 4 bytes) and, with ``plain``, its plain version, SDPA
    over the cache (dequantized to bf16 before the timed call, for int8)
    and the merge on the ring decode's partials.  With ``family`` (the
    main paths that run this head dim) the rows are named ``entry D <D>``
    and count that family's launches, and the bf16 form's merge is a row
    too.  (The paged sweep's rows: ``paged_timings``.)"""
    out = {}
    tag = " int8" if int8 else ""
    form = f"D {heads['D']}{tag or ' bf16'}"
    S = ops.choose_kv_splits(batch, PLEN + GEN, heads["Hq"], block=256,
                             device=dev)
    for verify, Q in ((False, 1), (True, 4)):
        entry = (f"ring_attention_sweep{tag} "
                 f"({'verify' if verify else 'decode'})")
        name = f"{entry} D {heads['D']}" if family else entry
        c = make_ring_case(torch, np, dev, pos=528, Q=Q, dtype="bfloat16",
                           seed=300 + Q, B=batch, C=PLEN + GEN, **heads)
        if int8:
            c = quantize_case(quant, c, ("k", "v"))
        args, kw = ring_args(c, verify)
        lib = (time_ms(torch, ring_sdpa_yardstick(
            torch, dequantized(torch, c, ("k", "v")) if int8 else c, verify))
            if plain else None)
        for n in (S, 1):
            r = form_row(
                torch, da,
                lambda **x: da.ring_attention_sweep(*args, **kw, block_k=256,
                                                    **x),
                lambda m: da.ring_attention_sweep_torch(
                    *args, **kw, n_splits=m, block_k=256),
                n, ring_work(torch, c, n, verify), plain=plain)
            row = name if n == S else f"{name}, 1 split"
            out[row] = dict(r, library_ms=lib, entry=entry, family=family,
                            err=name)
        if plain and not verify and S > 1:
            tail = tail_row(torch, da, out[name], *da.ring_attention_sweep(
                *args, **kw, n_splits=S, block_k=256),
                what=f"the {form} ring decode", entry="lse_merge",
                family=family)
            if family and not int8:
                out[f"lse_merge Dv {heads['D']}"] = tail
    return out


def ring_rows(torch, np, dev, da, ops, quant, plain=True):
    """Phase 5, every row of the ring sweep: ``ring_timings`` (D 64, bf16
    rings), ``ring_form_timings`` at D 64 with int8 rings and at h2o's D
    120 with bf16 and int8 rings, and ``private_ring_timings``."""
    rows = ring_timings(torch, np, dev, da, ops, plain)
    rows.update(ring_form_timings(torch, np, dev, da, ops, quant,
                                  heads=dict(Hq=9, Hkv=3, D=64),
                                  batch=BATCH, int8=True, plain=plain))
    for int8 in (False, True):
        rows.update(ring_form_timings(torch, np, dev, da, ops, quant,
                                      heads=H2O_HEADS, batch=4, int8=int8,
                                      family="h2o", plain=plain))
    rows.update(private_ring_timings(torch, np, dev, da, plain))
    return rows


def private_ring_timings(torch, np, dev, da, plain=True):
    """Phase 5, K5a at the shape the engine's private rings launch it on
    h2o's poisson path (``PRIVATE_RING``, window 4096), beside its bound
    and, with ``plain``, its plain version and SDPA."""
    return {"ring_attention_sweep (decode) D 120 private rings": private_row(
        torch, np, dev, da, PRIVATE_RING, PRIVATE_POS, H2O_WINDOW, "h2o",
        "ring_attention_sweep (decode) D 120", plain)}


def shared_buffer_timings(torch, np, dev, da):
    """Phase 5, K5a at the shape zamba2's poisson path launches it on its
    shared block's buffers (``ZAMBA_SHARED``, no window), as
    ``private_ring_timings``; apart from ``ring_rows``, whose rows
    tools/ring_ab.py compares between checkouts."""
    return {"ring_attention_sweep (decode) D 64 zamba2 shared buffers":
            private_row(torch, np, dev, da, ZAMBA_SHARED, ZAMBA_SHARED_POS,
                        0, "zamba2", "ring_attention_sweep (decode)", True)}


def private_row(torch, np, dev, da, shp, pos, window, family, err, plain):
    """A kernels-line row of K5a over per-slot rings with one position per
    row, 1 split: the kernel, its bound and, with ``plain``, its plain
    version and SDPA."""
    c = make_ring_case(torch, np, dev, pos=pos, Q=1, dtype="bfloat16",
                       seed=310, **shp)
    args, _ = ring_args(c, False)
    kw = dict(window=window, n_splits=1, block_k=256)
    ms = time_ms(torch, lambda: da.ring_attention_sweep(*args, **kw))
    pl = (time_ms(torch, lambda: da.ring_attention_sweep_torch(*args, **kw),
                  iters=5, reps=10) if plain else None)
    lib = (time_ms(torch, ring_sdpa_yardstick(torch, c, False))
           if plain else None)
    b_ms, b_by = bound(*ring_work(torch, c, 1, False))
    return dict(ms=ms, plain_ms=pl, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, n_splits=1,
                entry="ring_attention_sweep (decode)", family=family,
                err=err)


def int8_step_cost(torch, np, dev, cfg, tfm, steps, bridge):
    """Phase 5, what the int8 write costs a paged decode step: smollm at
    full width (bf16), 4 active slots from positions 64 to 79 over 6-page
    tables, chunks of 8 steps on bf16 pools and on int8 pools in turns
    (bf16, int8, int8, bf16, twice), each chunk timed on the host clock
    and ended by a synchronize.  Returns the median ms a step of each."""
    params = tfm.prepare_params(
        bridge.init_lm(cfg, torch.Generator(device=dev).manual_seed(7), dev),
        cfg)
    loop = steps.make_paged_decode_loop(cfg, steps.StepConfig(), 8)
    rng = np.random.default_rng(8)
    bt = torch.tensor((4 + rng.permutation(24)).reshape(4, 6),
                      dtype=torch.int32, device=dev)
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (4, 1)),
                       dtype=torch.int32, device=dev)
    active = torch.ones(4, dtype=torch.int32, device=dev)
    times = {"bfloat16": [], "int8": []}
    with torch.no_grad():
        for kv_dtype in ("bfloat16", "int8", "int8", "bfloat16") * 2:
            cache = tfm.init_paged_cache(cfg, 4, 28, 16, 6, dtype=kv_dtype,
                                         device=dev)
            for _ in range(3):                  # two timed, one warm-up
                cache = {**cache, "block_tables": bt,
                         "pos": torch.tensor([64, 69, 74, 79],
                                             dtype=torch.int32, device=dev)}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loop(params, cache, tok, active)
                torch.cuda.synchronize()
                times[kv_dtype].append((time.perf_counter() - t0) / 8 * 1e3)
    return {k: float(np.median(v[1:])) for k, v in times.items()}


def fa_work(np, B, Sq, Sk, Hq, Hkv, D, es, *, Dv=None, window=0,
            q_offset=0, **_):
    """(bytes, flops) of K4: q, k (D wide) and v (Dv) read once, out (Dv)
    written once; 2 flops per (q row, visible key, q head) and dim of q.k
    (D) and of p.v (Dv), over the causal / window band these shapes
    need."""
    Dv = Dv or D
    qp = q_offset + np.arange(Sq)
    hi = np.minimum(qp + 1, Sk)
    lo = np.maximum(qp - window + 1, 0) if window > 0 else 0
    pairs = int(np.maximum(hi - lo, 0).sum())
    nbytes = es * (B * Sq * Hq * (D + Dv) + B * Sk * Hkv * (D + Dv))
    return nbytes, 2.0 * B * Hq * (D + Dv) * pairs


def sdpa_prefill_yardstick(torch, q, k, v, *, window=0, scale=None, **_):
    """One F.scaled_dot_product_attention call with the same scale and the
    causal / window mask, kv heads expanded beforehand; no soft-cap, since
    no single call has one."""
    F = torch.nn.functional
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).contiguous()
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
    if window <= 0:
        return lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale)
    i = torch.arange(q.shape[1], device=q.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask, scale=scale)


# K4's phase-5 shapes (bf16), each a row of the kernels line: (row, label,
# shape, keyword arguments, the main paths whose launches it counts: a
# label's first word, or None for all)
K4_SHAPES = [
    ("flash_attention", "gemma2 4 x 512",
     dict(B=4, Sq=512, Sk=512, Hq=32, Hkv=16, D=128), GEMMA_ATTN, None),
    ("flash_attention (64, 64)", "smollm 8 x 512",
     dict(B=8, Sq=512, Sk=512, Hq=9, Hkv=3, D=64), {},
     ("poisson", "batch", "stablelm")),
    ("flash_attention gemma2 2 x 4352", "gemma2 2 x 4352 local",
     dict(B=2, Sq=G_LONG, Sk=G_LONG, Hq=32, Hkv=16, D=128),
     dict(GEMMA_ATTN, window=4096), ("gemma2",)),
    ("flash_attention (120, 120)", "h2o 4 x 512 (D 120)",
     dict(B=4, Sq=512, Sk=512, **H2O_HEADS), {"window": H2O_WINDOW},
     ("h2o",)),
    ("flash_attention G 7", "llava 4 x 512 (G 7)",
     dict(B=4, Sq=512, Sk=512, **LLAVA_HEADS), {}, ("llava",)),
    ("flash_attention (192, 128)", "deepseek 4 x 512 (D 192, Dv 128)",
     dict(B=4, Sq=512, Sk=512, Hq=128, Hkv=128, D=192, Dv=128),
     {"scale": MLA["scale"]}, ("deepseek",)),
]


def k4_timings(torch, np, dev, fa, ops):
    """Phase 5, K4 at ``K4_SHAPES`` (bf16): kernel, plain version and SDPA
    (without the soft-cap) beside the bound; one row each."""
    out = {}
    for i, (name, label, shp, kw, family) in enumerate(K4_SHAPES):
        q, k, v = fa_case(torch, np, dev, dtype="bfloat16", seed=600 + i,
                          **shp)
        reps = 5 if shp["Sq"] > 1024 else 20
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                     iters=5, reps=reps)
        plain = time_ms(torch, lambda: ops.flash_attention_torch(
            q, k, v, **kw), iters=3, reps=3)
        lib = time_ms(torch, sdpa_prefill_yardstick(torch, q, k, v, **kw),
                      iters=5, reps=reps)
        b_ms, b_by = bound(*fa_work(np, **shp, es=2, **kw))
        say(f"K4 {label}: kernel {ms * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, sdpa (no cap) {lib * 1e3:.1f} us, "
            f"bound {b_ms * 1e3:.2f} us ({b_by})")
        out[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, shape=label)
        if family:
            out[name].update(entry="flash_attention", family=family)
        del q, k, v
    return out


# K9's phase-5 rows (bf16): (label, rows, width, gemma form); the first
# is the kernels line's "rmsnorm" row, the zoo's prefill rows are rows
# "rmsnorm d <width>", the decode rows (4 and 8 rows, a step of the batch
# paths) are printed beside F.rms_norm and the bound
RMS_TIMED = (("gemma2 2048 x 4608", 2048, 4608, True),
             ("smollm 4096 x 576", 4096, 576, False),
             ("gemma2 decode 4 x 4608", 4, 4608, True),
             ("stablelm 4096 x 2048", 4096, 2048, False),
             ("h2o 2048 x 3840", 2048, 3840, False),
             ("phi3.5 2048 x 4096", 2048, 4096, False),
             ("llava 2048 x 7168", 2048, 7168, False),
             *((f"{fam} decode {n} x {d}", n, d, False)
               for fam, d in (("stablelm", 2048), ("h2o", 3840),
                              ("phi3.5", 4096), ("llava", 7168))
               for n in (4, 8)))
# K9's rows at musicgen-medium's width (1536): its prefill of 8 x 512
# rows (the row "rmsnorm d 1536") and its decode steps;
# apart from ``RMS_TIMED``, whose rows tools/rmsnorm_ab.py compares
# between checkouts
RMS_TIMED_NEW = (("musicgen 4096 x 1536", 4096, 1536, False),
                 ("musicgen decode 4 x 1536", 4, 1536, False),
                 ("musicgen decode 8 x 1536", 8, 1536, False))


def rms_rows(torch, np, dev, rms, common, plain=True, library=None,
             table=RMS_TIMED):
    """K9 at ``table`` (``RMS_TIMED`` by default; bf16 x, fp32 scale): the
    kernel's time, with ``plain`` its plain version's, with ``library``
    (default: ``plain``) F.rms_norm's (the library yardstick, never called
    by the port), beside the bound, by label."""
    library = plain if library is None else library
    F = torch.nn.functional
    rng = np.random.default_rng(700)
    out = {}
    for label, rows, d, gemma in table:
        x = torch.tensor(rng.standard_normal((rows, d)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
        w = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                         device=dev)
        ms = time_ms(torch, lambda: rms.rmsnorm(x, w, gemma_style=gemma))
        plain_ms = lib = None
        if plain:
            plain_ms = time_ms(torch, lambda: common.rmsnorm(
                x, w, 1e-6, gemma_style=gemma))
        if library:
            w_lib = ((1.0 + w) if gemma else w).to(x.dtype)
            lib = (time_ms(torch, lambda: F.rms_norm(x, (d,), weight=w_lib,
                                                     eps=1e-6))
                   if hasattr(F, "rms_norm") else None)
        b_ms, b_by = bound(2 * x.numel() * 2 + 4 * d, 4.0 * x.numel())
        out[label] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                          bound_ms=b_ms, bound_by=b_by, rows=rows, d=d)
    return out


def prefill_timings(torch, np, dev, fa, rms, ops, common):
    """Phase 5, K4 (``k4_timings``) and K9 at ``RMS_TIMED`` and
    ``RMS_TIMED_NEW``: gemma2's 2048 prefill rows of 4608 (gemma form, the
    JSON row), smollm's 4096 rows of 576, the prefill rows of stablelm (8
    x 512 of 2048, zamba2's width too, whose launches its row counts), h2o
    (3840), phi3.5 (4096), llava (7168) and musicgen (1536) (rows of their
    own), and decode steps of 4 and 8 rows (gemma2's at 4608, the
    zoo's)."""
    out = k4_timings(torch, np, dev, fa, ops)
    rows = rms_rows(torch, np, dev, rms, common)
    rows.update(rms_rows(torch, np, dev, rms, common, table=RMS_TIMED_NEW))
    for label, t in rows.items():
        family, d = label.split()[0], t["d"]
        lib = t["library_ms"]
        lib_s = "n/a" if lib is None else f"{lib * 1e3:.1f} us"
        say(f"K9 {label}: kernel {t['ms'] * 1e3:.1f} us, plain "
            f"{t['plain_ms'] * 1e3:.1f} us, F.rms_norm {lib_s}, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']})")
        row = dict(ms=t["ms"], plain_ms=t["plain_ms"], library_ms=lib,
                   bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                   shape=label)
        if label == RMS_TIMED[0][0]:
            out["rmsnorm"] = row
        elif t["rows"] > 8 and family != "smollm":
            fams = (family, "zamba2") if family == "stablelm" else family
            out[f"rmsnorm d {d}"] = dict(row, entry="rmsnorm", family=fams)
    return out


def ssd_work(B, S, H, P, G, N, es, chunk=128, init=False):
    """(bytes, flops) of K8: x, dt, B, C (and an initial state) read once,
    y and the final state written once; per chunk, C.B^T over the causal
    band once per group, and per head the band times x, C h^T and the
    state update x^T (w B), 2 flops a multiply-add."""
    nbytes = (2 * B * S * H * P * es + B * S * H * 4 + 2 * B * S * G * N * es
              + B * H * P * N * 4 * (2 if init else 1))
    flops = 0.0
    for c0 in range(0, S, chunk):
        q = min(chunk, S - c0)
        band = q * (q + 1) / 2
        flops += B * (2 * band * N * G + H * (2 * band * P + 4 * q * N * P))
    return nbytes, flops


# K8's phase-5 rows (bf16, H 32, P 64, N 128, G 1, chunk 128, D, final
# state returned): (label, B, S): the batch path's prefill (the JSON row
# "ssd_scan"), the long batch's, and one engine prompt (the poisson
# paths' prompts are 16 to 32 tokens, prefilled one request at a time)
SSD_TIMED = (("8 x 512", BATCH, PLEN), ("2 x 4000", 2, M_LONG),
             ("1 x 32", 1, 32))
# K8 at zamba2-1.2b's heads (H 64, P 64, N 64): its batch path's prefill
# and its train step's batch
SSD_ZAMBA_TIMED = (("8 x 512", BATCH, PLEN),)
MAMBA_SSM = dict(H=32, P=64, N=128)


def ssd_rows(torch, np, dev, ss, plain=True, table=SSD_TIMED,
             heads=MAMBA_SSM):
    """K8 at ``table`` (``SSD_TIMED`` by default) and ``heads`` (mamba2's
    by default): the kernel's time and, with ``plain``, its plain
    version's, beside the bound, by label."""
    out = {}
    for i, (label, B, S) in enumerate(table):
        inp, _ = ssd_case(torch, np, dev, B=B, S=S, dtype="bfloat16",
                          seed=900 + i, **heads)
        reps = 20 if S <= 1024 else 4
        ms = time_ms(torch, lambda: ss.ssd_scan(**inp, return_state=True),
                     iters=5, reps=reps)
        plain_ms = (time_ms(torch, lambda: ss.ssd_scan_torch(
            **inp, return_state=True), iters=3, reps=3) if plain else None)
        b_ms, b_by = bound(*ssd_work(B, S, heads["H"], heads["P"], 1,
                                     heads["N"], 2))
        out[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        del inp
    return out


def ssd_timings(torch, np, dev, ss):
    """Phase 5, K8 at ``SSD_TIMED`` (mamba2's heads): 8 x 512 is the JSON
    row "ssd_scan", the others rows of their own; and at
    ``SSD_ZAMBA_TIMED`` (zamba2's heads, rows "ssd_scan zamba2 ...").  No
    single PyTorch call computes the scan: no library yardstick."""
    out = {}
    for family, rows in (
            ("mamba2", ssd_rows(torch, np, dev, ss)),
            ("zamba2", ssd_rows(torch, np, dev, ss, table=SSD_ZAMBA_TIMED,
                                heads=ZAMBA_SSM))):
        for label, t in rows.items():
            say(f"K8 {family} {label}: kernel {t['ms'] * 1e3:.1f} us, plain "
                f"{t['plain_ms'] * 1e3:.1f} us, library n/a, bound "
                f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']})")
            row = dict(t, library_ms=None, shape=f"{family} {label}")
            if family == "mamba2" and label == SSD_TIMED[0][0]:
                out["ssd_scan"] = row
            else:
                name = (f"ssd_scan {label}" if family == "mamba2"
                        else f"ssd_scan {family} {label}")
                out[name] = dict(row, entry="ssd_scan", family=family,
                                 err="ssd_scan")
    return out


def mla_work(c, n_splits):
    """(bytes, flops) of the latent sweep on these inputs: q, the latent
    rows of every page holding a valid key, their table entries and pos,
    the pending rows (verify) read once, the output (or partials + lse)
    written once; 2 flops a multiply-add over R for the score and r_kv
    for the value, per (query row, head, valid key)."""
    q = c["q"]
    B, Q, Hq, R = q.shape
    ps, nb = c["pool"].shape[1], c["block_tables"].shape[1]
    r_kv, es = MLA["r_kv"], q.element_size()
    verify = c["pending"] is not None
    keys = [p if verify else p + 1 for p in c["pos"].tolist()]
    pages = sum(min(nb, -(-k // ps)) for k in keys)
    nbytes = q.numel() * es + pages * ps * R * es + pages * 4 + B * 4
    if verify:
        nbytes += B * Q * R * es
    S = max(1, min(n_splits, nb))
    nbytes += (B * Q * Hq * r_kv * es if S == 1
               else B * Hq * S * Q * (r_kv + 1) * 4)
    k_tot = Q * sum(keys) + (B * Q * (Q + 1) // 2 if verify else 0)
    return nbytes, 2.0 * Hq * (R + r_kv) * k_tot


def mla_sdpa_yardstick(torch, c):
    """One F.scaled_dot_product_attention call over the latent rows
    gathered in logical order as one kv head (k the whole row, v its first
    512 lanes, expanded over the heads without a copy), with the same
    masks and scale."""
    F = torch.nn.functional
    q = c["q"]
    B, Q, Hq, R = q.shape
    ps, nb = c["pool"].shape[1], c["block_tables"].shape[1]
    lat = c["pool"][c["block_tables"].long()].reshape(B, nb * ps, R)
    pos = c["pos"].long()[:, None, None]
    kp = torch.arange(nb * ps, device=q.device)[None, None, :]
    if c["pending"] is not None:
        lat = torch.cat([lat, c["pending"]], dim=1)
        qi = torch.arange(Q, device=q.device)[None, :, None]
        nj = torch.arange(Q, device=q.device)[None, None, :]
        mask = torch.cat([(kp < pos).expand(B, Q, nb * ps),
                          (nj <= qi).expand(B, Q, Q)], dim=-1)
    else:
        mask = kp <= pos
    K = lat.shape[1]
    k = lat[:, None].expand(B, Hq, K, R)
    v = lat[:, None, :, :MLA["r_kv"]].expand(B, Hq, K, MLA["r_kv"])
    qt = q.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask[:, None], scale=MLA["scale"])


# The latent sweep's phase-5 shapes: (verify, pos, Q) at 4 slots, Hq 128,
# pages of 16, 5 table columns
MLA_TIMED = ((False, [64, 71, 75, 79], 1), (True, [32, 48, 16, 32], 16))


def mla_timings(torch, np, dev, da, ops, plain=True):
    """Phase 5, deepseek-v2's kernels at the engine's shapes (bf16, 4
    slots, Hq 128, pages of 16, 5 table columns): the latent sweep's
    decode at the engine's split count (K7b) and at 1 split (K7a), and its
    verify form at Q 16 (the prefix hit's suffix chunk, K3's MLA form),
    CUDA-event times of the kernel beside its bound and, with ``plain``,
    its plain version and SDPA over the gathered latent as one kv head;
    the merge at Dv 512.  Returns the rows by name: "mla_latent_sweep
    (decode|verify)", and ", 1 split" where the engine splits.  (K4 at
    deepseek's (D, Dv) = (192, 128) is a row of ``k4_timings``.)"""
    out = {}
    main = dict(B=4, nb=5)
    for verify, pos, Q in MLA_TIMED:
        name = ("mla_latent_sweep (verify)" if verify
                else "mla_latent_sweep (decode)")
        c = mla_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                     seed=1400 + Q, **main)
        S = ops.choose_kv_splits(4, 80, MLA["Hq"] if verify else 1,
                                 block=16, device=dev)
        args, kw = mla_args(c)
        lib = time_ms(torch, mla_sdpa_yardstick(torch, c)) if plain else None
        for n in sorted({S, 1}, reverse=True):
            r = form_row(
                torch, da,
                lambda **x: da.mla_latent_sweep(*args, **kw, **x),
                lambda m: da.mla_latent_sweep_torch(*args, **kw, n_splits=m),
                n, mla_work(c, n), plain=plain, iters=3, reps=5)
            row = name if n == S else f"{name}, 1 split"
            out[row] = dict(r, library_ms=lib, entry=name, err=name)
            if plain:
                say(f"{row} (n_splits {n}): kernel {r['ms'] * 1e3:.1f} "
                    f"us{stage1_note(r)}, plain {r['plain_ms'] * 1e3:.1f} "
                    f"us, sdpa over the latent {lib * 1e3:.1f} us, bound "
                    f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']})")
        if plain and not verify and S > 1:
            tail_row(torch, da, out[name], *da.mla_latent_sweep(
                *args, **kw, n_splits=S), what="Dv 512 (4 x 128 rows)")
    return out


def merge_forms(torch, np, dev, da, ops, quant):
    """Phase 5, the split forms at the main paths' shapes (q bf16): the
    paged sweep at ``PAGED_FORMS`` but the deep one (decode, verify Q 16;
    4 slots, 5 pages of 16), the ring sweep at ``ring_rows``' batch shapes
    (D 64 at 8 x 545 slots, D 120 at 4 x 545; bf16 and int8 rings; decode,
    verify Q 4; pos 528) and the latent decode at ``MLA_TIMED``, each at
    the engine's split count where it is above 1.  Yields (name, split
    count, the sweep's call, the attention function's call, out rows):
    ``sweep(**kw)`` launches the sweep, ``attend()`` the attention function
    a model calls, its output then reshaped to (rows, Hq Dv) as
    ``attention._out_proj`` reshapes it."""
    for form, heads, int8, kw, _ in PAGED_FORMS:
        if form == "deep":
            continue
        S = ops.choose_kv_splits(4, 80, heads["Hq"], block=16, device=dev)
        if S == 1:
            continue
        for verify, Q in ((False, 1), (True, 16)):
            pos = [32, 48, 16, 32] if verify else [64, 71, 75, 79]
            c = make_case(torch, np, dev, B=4, ps=16, nb=5, pos=pos, Q=Q,
                          dtype="bfloat16", seed=100 + Q, **heads)
            if int8:
                c = quantize_case(quant, c, ("k_pages", "v_pages"))
            args, vkw = sweep_args(c, verify)
            name = (f"paged_attention_sweep{' int8' if int8 else ''} "
                    f"({'verify' if verify else 'decode'})"
                    + (f" {form}" if form else ""))
            yield (name, S,
                   lambda a=args, v=vkw, k=kw, n=S, **x:
                   da.paged_attention_sweep(*a, **v, n_splits=n, **k, **x),
                   lambda a=args, v=vkw, k=kw, n=S:
                   da.paged_attention(*a, **v, n_splits=n, **k),
                   4 * Q)
    for D, batch, heads in ((64, BATCH, dict(Hq=9, Hkv=3)),
                            (120, 4, H2O_HEADS)):
        heads = dict(heads, D=D)
        S = ops.choose_kv_splits(batch, PLEN + GEN, heads["Hq"], block=256,
                                 device=dev)
        if S == 1:
            continue
        for int8 in (False, True):
            for verify, Q in ((False, 1), (True, 4)):
                c = make_ring_case(torch, np, dev, pos=528, Q=Q,
                                   dtype="bfloat16", seed=300 + Q, B=batch,
                                   C=PLEN + GEN, **heads)
                if int8:
                    c = quantize_case(quant, c, ("k", "v"))
                args, vkw = ring_args(c, verify)
                name = (f"ring_attention_sweep{' int8' if int8 else ''} "
                        f"({'verify' if verify else 'decode'}) D {D}")
                yield (name, S,
                       lambda a=args, v=vkw, n=S, **x:
                       da.ring_attention_sweep(*a, **v, n_splits=n,
                                               block_k=256, **x),
                       lambda a=args, v=vkw, n=S:
                       da.ring_attention(*a, **v, n_splits=n, block_k=256),
                       batch * Q)
    for verify, pos, Q in MLA_TIMED:
        S = ops.choose_kv_splits(4, 80, MLA["Hq"] if verify else 1,
                                 block=16, device=dev)
        if S == 1:
            continue
        c = mla_case(torch, np, dev, pos=pos, Q=Q, dtype="bfloat16",
                     seed=1400 + Q, B=4, nb=5)
        args, kw = mla_args(c)
        yield (f"mla_latent_sweep ({'verify' if verify else 'decode'})", S,
               lambda a=args, k=kw, n=S, **x:
               da.mla_latent_sweep(*a, **k, n_splits=n, **x),
               lambda a=args, k=kw, n=S: da.mla_attention(*a, **k,
                                                          n_splits=n),
               4 * Q)


def merge_pairs(torch, np, dev, da, ops, quant, pair=True):
    """Phase 5, what the fold saves at ``merge_forms``: CUDA-event times
    over CUDA-graph replays of the sweep alone (stage 1, partials out) and
    of the attention function followed by ``_out_proj``'s reshape (the
    fused launch in this tree, the sweep, ``lse_merge`` and, for Q > 1, the
    reshape's copy of the transposed view before the fold), and with
    ``pair`` the unfused pair spelled out: the sweep, ``lse_merge``, the
    transpose and the reshape.  Returns {name: dict(n_splits, stage1_ms,
    call_ms[, pair_ms])}."""
    out = {}
    for name, S, sweep, attend, rows in merge_forms(torch, np, dev, da, ops,
                                                    quant):
        row = dict(n_splits=S, stage1_ms=time_ms(torch, sweep),
                   call_ms=time_ms(torch, lambda: attend().reshape(rows, -1)))
        if pair:
            def unfused():
                p, l = sweep()
                return da.lse_merge(p, l, torch.bfloat16).transpose(
                    1, 2).reshape(rows, -1)
            row["pair_ms"] = time_ms(torch, unfused)
        out[name] = row
    return out


def serve_run(torch, da, tfm, serve, label, argv, cfg=None):
    """One main-path run through the launcher (``serve.serve(args, cfg)``
    with a config cut in depth where ``cfg`` is given): launch counts
    zeroed just before, read just after; finite logits required."""
    args = serve.build_parser().parse_args(argv) if cfg is not None else None
    da.reset_launches()
    with LogitsTap(torch, tfm) as tap:
        out = serve.run(argv) if cfg is None else serve.serve(args, cfg)
    torch.cuda.synchronize()
    launches = dict(da.LAUNCHES)
    if tap.finite is None or not bool(tap.finite):
        fail(f"{label}: non-finite logits")
    return out, launches


# --------------------------------------------------------------------------
# phase 6 helpers
# --------------------------------------------------------------------------
# The chaos drills' trace (8 requests, 40 to 128 prompt tokens over 2
# shared 32-token heads, 24 to 32 new) and schedule (kind, step, duration,
# arg) on the engine clock: a slot crash, a page corruption, a stall, an
# emergency cap of half the power for 12 steps, and an engine crash that
# lands after the snapshot at step 42 (4 slots, pages of 16, chunks of 8).
CHAOS_TRACE = dict(rate_per_step=0.25, seed=0, prompt_len=(8, 96),
                   max_new_tokens=(24, 32), shared_prefix_len=32,
                   prompt_pools=2)
CHAOS_SCHEDULE = (("slot_crash", 12, 0, 0), ("page_corrupt", 20, 0, 0.0),
                  ("stall", 20, 16, 0.0), ("emergency_cap", 28, 12, 0.5),
                  ("engine_crash", 44, 0, 0.0))
# the bf16 drill's page pool: tight enough that prefix pages go to the
# host tier before the crash, and are held in it at the last snapshot
CHAOS_TIER_PAGES = 20
# the launcher's drill over phase 4's poisson path
CHAOS_SPEC = "engine_crash@24,emergency_cap@8:8:0.5,bus_drop@4:2"


def snapshot_bytes(snap):
    """Bytes on disk of the newest committed snapshot in ``snap``."""
    steps = sorted(d for d in pathlib.Path(snap).iterdir()
                   if d.name.startswith("step_")
                   and (d / "_COMMITTED").exists())
    return sum(f.stat().st_size for f in steps[-1].iterdir())


def chaos_drill(torch, dev, da, serving, chaos, cfg, params, label,
                **ecfg_kw):
    """One crash-restore drill on the engine: the fault-free run, then the
    same trace under ``CHAOS_SCHEDULE`` with a snapshot every 2 chunks,
    the engine crash caught, the engine restored and resumed.  Returns the
    fault-free and restored reports, the restored engine, and what was
    measured: every ``save_snapshot`` wall (synchronised), the last
    snapshot's bytes on disk, the ``restore`` wall, the launch counts
    before the crash and after the restore, and the requeued requests'
    prompt tokens restored from the trie before and after the resume."""
    import tempfile
    ecfg = serving.EngineConfig(n_slots=4, page_size=16, max_len=160,
                                decode_chunk=8, **ecfg_kw)
    trace = serving.poisson_trace(8, vocab_size=cfg.vocab_size,
                                  **CHAOS_TRACE)
    base = serving.ServeEngine(cfg, ecfg, params, device=dev).run(trace)
    inj = chaos.FaultInjector(seed=1)
    for kind, step, duration, arg in CHAOS_SCHEDULE:
        inj.schedule(kind, step, duration=duration, arg=arg)
    with tempfile.TemporaryDirectory(prefix="chaos_drill_") as snap:
        beats = []
        kw = dict(device=dev, injector=inj, snapshot_every=2,
                  on_heartbeat=lambda step, wall: beats.append(step))
        eng = serving.ServeEngine(cfg, ecfg, params, snapshot_dir=snap, **kw)
        saves = []
        save = eng.save_snapshot

        def timed_save():
            torch.cuda.synchronize()
            t = time.perf_counter()
            save()
            torch.cuda.synchronize()
            saves.append((time.perf_counter() - t) * 1e3)
        eng.save_snapshot = timed_save
        da.reset_launches()
        try:
            eng.run(trace)
            fail(f"{label}: the engine crash never fired")
        except serving.EngineCrash as crash:
            crashed_at = crash.step
        torch.cuda.synchronize()
        before = dict(da.LAUNCHES)
        nbytes = snapshot_bytes(snap)
        t = time.perf_counter()
        eng = serving.ServeEngine.restore(cfg, ecfg, params, snap, **kw)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t) * 1e3
        host_pages = eng.kv.n_host_used()
        folded = {r.rid: eng._results[r.rid].prefill_tokens_saved
                  for r in eng._queue.pending()
                  if eng._results[r.rid].tokens}
        da.reset_launches()
        rep = eng.resume()
        torch.cuda.synchronize()
        after = dict(da.LAUNCHES)
    if rep.n_restores != 1:
        fail(f"{label}: {rep.n_restores} restores, expected 1")
    for r in rep.results:
        if r.n_tokens != r.max_new_tokens:
            fail(f"{label}: rid {r.rid} finished {r.n_tokens}/"
                 f"{r.max_new_tokens} tokens ({r.finish_reason})")
    bad = eng.kv.verify_invariants()
    if bad:
        fail(f"{label}: the pool breaks its invariants after the run: {bad}")
    if rep.degraded_steps <= 0:
        fail(f"{label}: the emergency cap degraded no step")
    if len(beats) >= rep.n_chunks:
        fail(f"{label}: the stall suppressed no heartbeat")
    saved = {r.rid: r.prefill_tokens_saved for r in rep.results}
    stats = dict(crashed_at=crashed_at, saves=saves, nbytes=nbytes,
                 restore_ms=restore_ms, host_pages=host_pages,
                 before=before, after=after,
                 folded={rid: (n, saved[rid]) for rid, n in folded.items()})
    return base, rep, eng, stats


def chaos_line(label, base, rep, st, card):
    equal = sum(a.tokens == b.tokens for a, b in zip(rep.results,
                                                     base.results))
    saves = sorted(st["saves"])
    say(f"chaos {label}: crash at step {st['crashed_at']}, "
        f"{rep.n_faults_injected} faults, {rep.requeued_requests} requeued, "
        f"{rep.degraded_steps} degraded steps, {rep.n_pages_quarantined} "
        f"pages quarantined, {rep.n_demotions} pages out / "
        f"{rep.n_promotions} in; {equal}/{len(rep.results)} streams equal "
        f"the fault-free run's; save_snapshot {len(saves)} calls, median "
        f"{saves[len(saves) // 2]:.1f} ms, max {saves[-1]:.1f} ms; snapshot "
        f"{st['nbytes']} bytes on disk; ServeEngine.restore "
        f"{st['restore_ms']:.1f} ms; decode {rep.tok_per_s:.1f} tok/s "
        f"against {base.tok_per_s:.1f} fault-free; on {card}")
    say(f"chaos {label}: launches before the crash {st['before']}, after "
        f"the restore {st['after']}; requeued requests' prompt tokens from "
        f"the trie (before resume, after) {st['folded']}")


def chaos_drills(torch, dev, da, serving, chaos, serve, tfm, bridge, cfg,
                 card):
    """Phase 6: the chaos drills at smollm-135m's published width and
    depth, on the card."""
    import contextlib
    import io
    # (a) exact drill, fp32: the restored streams equal the fault-free ones
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = bridge.init_lm(cfg32, torch.Generator().manual_seed(6), dev)
    base, rep, _, st = chaos_drill(torch, dev, da, serving, chaos, cfg32,
                                   params, "fp32", cache_dtype="float32")
    for a, b in zip(rep.results, base.results):
        if a.tokens != b.tokens:
            fail(f"chaos fp32: rid {a.rid} restored stream {a.tokens} != "
                 f"fault-free {b.tokens}")
    if st["after"]["sweep_verify"] <= 0 or st["after"]["sweep_decode"] <= 0:
        fail(f"chaos fp32: no paged verify / decode sweep after the restore "
             f"({st['after']})")
    if not st["folded"] or any(n1 <= n0 for n0, n1 in st["folded"].values()):
        fail(f"chaos fp32: a requeued request did not come back through the "
             f"prefix trie ({st['folded']})")
    chaos_line("fp32 exact", base, rep, st, card)
    del params
    torch.cuda.empty_cache()
    # (b) bf16 weights, int8 pages and the host tier on a tight pool
    params16 = bridge.init_lm(cfg, torch.Generator().manual_seed(6), dev)
    base, rep, eng, st = chaos_drill(
        torch, dev, da, serving, chaos, cfg, params16, "int8 host tier",
        kv_dtype="int8", host_tier=True, n_pages=CHAOS_TIER_PAGES)
    if eng.cache["units"]["sub0"]["k"].dtype != torch.int8:
        fail("chaos int8 host tier: the engine's pools are not int8")
    if st["host_pages"] <= 0 or rep.n_demotions <= 0:
        fail(f"chaos int8 host tier: {st['host_pages']} host pages held at "
             f"the restore, {rep.n_demotions} page-outs")
    if st["after"]["sweep_verify_int8"] <= 0:
        fail(f"chaos int8 host tier: no int8 verify sweep after the restore "
             f"({st['after']})")
    chaos_line("bf16 int8 host tier", base, rep, st, card)
    del params16
    torch.cuda.empty_cache()
    # (c) the launcher, bf16, over phase 4's poisson path
    argv = ["--arch", "smollm-135m", "--traffic", "poisson", "--requests",
            "8", "--shared-prefix-len", "32", "--prompt-pools", "2",
            "--n-slots", "4", "--page-size", "16", "--snapshot-every", "2",
            "--chaos", CHAOS_SPEC]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        out, counts = serve_run(torch, da, tfm, serve, "chaos launcher", argv)
    print(text.getvalue(), end="")
    lines = text.getvalue().splitlines()
    summary = [ln for ln in lines if ln.startswith("[chaos]")
               and ("faults injected" in ln or "telemetry" in ln)]
    if out.n_restores != 1 or len(summary) != 2:
        fail(f"chaos launcher: {out.n_restores} restores, summary lines "
             f"{summary}")
    for r in out.results:
        if r.n_tokens != r.max_new_tokens:
            fail(f"chaos launcher: rid {r.rid} finished {r.n_tokens}/"
                 f"{r.max_new_tokens} tokens")
    for key in ("sweep_decode", "sweep_verify", "flash_attention",
                "rmsnorm"):
        if counts[key] <= 0:
            fail(f"chaos launcher: kernel {key} was never launched")
    say(f"chaos launcher ({CHAOS_SPEC}): {out.n_restores} restore, "
        f"{out.tok_per_s:.1f} tok/s measured on {card}, launches {counts}")


# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# phase 7 helpers
# --------------------------------------------------------------------------
# K4's backward cases (label, shape, keyword arguments): smollm's heads at
# its 8 x 512 training batch, gemma2's heads of 128 (G 2) with its window
# and cap over 8192 keys (fewer heads, so that the plain version's
# autograd graph fits), h2o-danube's 120 at G 4, llava's G 7, deepseek's
# MLA prefill (192, 128) at G 1, ragged Sq 37 and 1000, and a q_offset
FA_BWD_CASES = [
    ("smollm 8 x 512 (64, 64) G 3",
     dict(B=8, Sq=PLEN, Sk=PLEN, Hq=9, Hkv=3, D=64), {}),
    ("gemma2 1 x 8192 (128, 128) window 4096 cap 50",
     dict(B=1, Sq=8192, Sk=8192, Hq=4, Hkv=2, D=128),
     dict(GEMMA_ATTN, window=4096)),
    ("h2o 2 x 512 (120, 120) G 4",
     dict(B=2, Sq=PLEN, Sk=PLEN, **H2O_HEADS), {"window": 100}),
    ("llava 2 x 512 (128, 128) G 7",
     dict(B=2, Sq=PLEN, Sk=PLEN, **LLAVA_HEADS), {}),
    ("deepseek 2 x 512 (192, 128) G 1",
     dict(B=2, Sq=PLEN, Sk=PLEN, Hq=16, Hkv=16, D=192, Dv=128),
     {"scale": MLA["scale"]}),
    ("ragged Sq 37", dict(B=3, Sq=37, Sk=37, Hq=9, Hkv=3, D=64), {}),
    ("ragged Sq 1000", dict(B=1, Sq=1000, Sk=1000, Hq=8, Hkv=2, D=128),
     {"logit_cap": 30.0}),
    ("q_offset 63, Sq 37 over 100 keys",
     dict(B=2, Sq=37, Sk=100, Hq=9, Hkv=3, D=64), {"q_offset": 63}),
    # G 1 at D 64: musicgen's 24 / 24 and zamba2's shared block's 32 / 32
    # at their 8 x 512 training batch
    ("musicgen 8 x 512 (64, 64) G 1",
     dict(B=BATCH, Sq=PLEN, Sk=PLEN, **MUSICGEN_HEADS), {}),
    ("zamba2 8 x 512 (64, 64) G 1",
     dict(B=BATCH, Sq=PLEN, Sk=PLEN, **ZAMBA_HEADS), {}),
]
# K9's backward rows: every width the zoo normalizes and the widths of
# each forward launch shape up to 8192, at a few rows and at many
RMS_BWD_ROWS = (4, 1000)
RMS_BWD_LONG = ((65536, 576), (4096, 4608), (BATCH * PLEN, 1536))


def rel_err(a, b):
    """max |a - b| / max |b|, in fp32."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def check_fa_backward(torch, np, dev, fa, ops, errs):
    """Phase 7 (a), K4: the kernels' gradients against torch.autograd of
    the plain version on the same inputs, the forward with lse bit for bit
    the forward without, two backward runs bit for bit.  Returns the
    largest relative error by dtype; the largest |kernel - plain| goes to
    ``errs["flash_attention_bwd"]``."""
    worst = {"bfloat16": 0.0, "float32": 0.0}
    for i, (label, shp, kw) in enumerate(FA_BWD_CASES):
        for dtype in ("bfloat16", "float32"):
            q, k, v = fa_case(torch, np, dev, dtype=dtype, seed=900 + i,
                              **shp)
            for t in (q, k, v):
                t.requires_grad_(True)
            n0 = (fa.LAUNCHES["flash_attention"],
                  fa.LAUNCHES["flash_attention_bwd"])
            out = fa.flash_attention(q, k, v, **kw)
            dout = torch.randn_like(out)
            got = torch.autograd.grad(out, (q, k, v), dout,
                                      retain_graph=True)
            again = torch.autograd.grad(out, (q, k, v), dout)
            if (fa.LAUNCHES["flash_attention"] - n0[0],
                    fa.LAUNCHES["flash_attention_bwd"] - n0[1]) != (1, 2):
                fail(f"K4 backward {label} {dtype}: launches "
                     f"{fa.LAUNCHES['flash_attention'] - n0[0]} forward, "
                     f"{fa.LAUNCHES['flash_attention_bwd'] - n0[1]} "
                     "backward, expected 1 and 2")
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail(f"K4 backward {label} {dtype}: two runs differ")
            with torch.no_grad():
                plain_fwd = fa.flash_attention(q, k, v, **kw)
            if not torch.equal(plain_fwd, out.detach()):
                fail(f"K4 {label} {dtype}: the forward with lse differs "
                     "from the forward without")
            out_p = ops.flash_attention_torch(q, k, v, **kw)
            want = torch.autograd.grad(out_p, (q, k, v), dout)
            rel = [rel_err(a, b) for a, b in zip(got, want)]
            if not all(np.isfinite(e) for e in rel) \
                    or max(rel) > TOL[dtype]:
                fail(f"K4 backward {label} {dtype}: dq, dk, dv relative "
                     f"errors {rel} (tol {TOL[dtype]})")
            worst[dtype] = max(worst[dtype], max(rel))
            note(errs, max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, want)),
                 "flash_attention_bwd")
            say(f"K4 backward {label} {dtype}: dq, dk, dv relative errors "
                + ", ".join(f"{e:.2e}" for e in rel))
            del q, k, v, out, got, again, want, out_p
        torch.cuda.empty_cache()
    # a form the backward does not take raises when asked for a gradient
    q, k, v = fa_case(torch, np, dev, dtype="bfloat16", seed=950, B=1, Sq=8,
                      Sk=8, Hq=128, Hkv=1, D=64)
    q.requires_grad_(True)
    try:
        fa.flash_attention(q, k, v)
    except ValueError as e:
        say(f"K4 backward refuses G 128: {e}")
    else:
        fail("K4 at G 128 with a gradient did not raise")
    return worst


def check_rms_backward(torch, np, dev, rms, common, errs):
    """Phase 7 (a), K9: dx and d scale against torch.autograd of the plain
    version, both forms, bf16 and fp32 x with fp32 scale, at every width of
    ``RMS_WIDTHS`` up to 8192, 4 and 1000 rows and the long rows of
    ``RMS_BWD_LONG``; two runs bit for bit.  Widths past 8192 raise.
    Returns the largest relative error by dtype; the largest |kernel -
    plain| goes to ``errs["rmsnorm_bwd"]``."""
    worst = {"bfloat16": 0.0, "float32": 0.0}
    rng = np.random.default_rng(960)
    shapes = [(n, d) for d in RMS_WIDTHS if d <= rms.MAX_WIDTH
              for n in RMS_BWD_ROWS] + list(RMS_BWD_LONG)
    for rows, d in shapes:
        for dtype in ("bfloat16", "float32"):
            for gemma in (False, True):
                x = torch.tensor(rng.standard_normal((rows, d)),
                                 dtype=torch.float32, device=dev).to(
                    getattr(torch, dtype)).requires_grad_(True)
                w = torch.tensor(0.1 * rng.standard_normal(d),
                                 dtype=torch.float32,
                                 device=dev).requires_grad_(True)
                n0 = rms.LAUNCHES["rmsnorm_bwd"]
                y = rms.rmsnorm(x, w, gemma_style=gemma)
                dy = torch.randn_like(y)
                got = torch.autograd.grad(y, (x, w), dy, retain_graph=True)
                again = torch.autograd.grad(y, (x, w), dy)
                if rms.LAUNCHES["rmsnorm_bwd"] - n0 != 2:
                    fail(f"K9 backward {rows} x {d}: "
                         f"{rms.LAUNCHES['rmsnorm_bwd'] - n0} launches")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"K9 backward {rows} x {d} {dtype}: two runs differ")
                y_p = common.rmsnorm(x, w, 1e-6, gemma_style=gemma)
                want = torch.autograd.grad(y_p, (x, w), dy)
                rel = [rel_err(a, b) for a, b in zip(got, want)]
                if not all(np.isfinite(e) for e in rel) \
                        or max(rel) > TOL[dtype]:
                    fail(f"K9 backward {rows} x {d} {dtype} gemma {gemma}: "
                         f"dx, d scale relative errors {rel}")
                worst[dtype] = max(worst[dtype], max(rel))
                note(errs, max(float((a.float() - b.float()).abs().max())
                               for a, b in zip(got, want)), "rmsnorm_bwd",
                     f"d {d}")
    say(f"K9 backward: {len(shapes) * 4} cases, largest relative errors "
        f"bf16 {worst['bfloat16']:.2e}, fp32 {worst['float32']:.2e}")
    x = torch.ones((4, 16384), device=dev, requires_grad=True)
    try:
        rms.rmsnorm(x, torch.ones(16384, device=dev))
    except ValueError as e:
        say(f"K9 backward refuses width 16384: {e}")
    else:
        fail("K9 at width 16384 with a gradient did not raise")
    return worst


def autograd_ms(torch, forward, inputs, grad_out):
    """Device time of the library's backward through autograd: the
    forward and ``torch.autograd.grad`` of it captured together into CUDA
    graphs by ``time_ms`` (the autograd engine runs the backward on the
    forward's stream, the capture's), less the forward captured alone, so
    that the host's launch cost stays out as it does for the kernels."""
    both = time_ms(torch, lambda: torch.autograd.grad(forward(), inputs,
                                                      grad_out),
                   iters=5, reps=10)
    return both - time_ms(torch, forward, iters=5, reps=10)


# each launch of a backward call at phase 7 (d)'s shapes, by a substring of
# its kernel's name: K4's delta (the pack kernel on the Hopper path), dk /
# dv and dq, K9's rows and reduce
BWD_LAUNCHES = {"flash_attention_bwd": (("delta", ("fa_bwd_pack", "fa_bwd_delta")),
                                        ("dk / dv", ("fa_bwd_dkdv",)),
                                        ("dq", ("fa_bwd_dq",))),
                "rmsnorm_bwd": (("rows", ("rmsnorm_bwd_kernel",)),
                                ("reduce", ("rmsnorm_dw_reduce",)))}
# the times of those launches before the Hopper redesign (the mma.sync
# kernels, K9's row-at-a-time backward; us, the mean of the old
# checkout's two runs in tools/bwd_ab.py's OLD NEW NEW OLD call on an
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6)
EARLIER_LAUNCHES = {"flash_attention_bwd": {"delta": 8.85, "dk / dv": 184.9,
                                         "dq": 73.65},
                 "rmsnorm_bwd": {"rows": 37.5, "reduce": 6.2}}


def launch_split(torch, fn, parts, iters=20):
    """Device time of each launch of ``fn`` (us a launch, by the labels of
    ``parts``: (label, name substrings)), the mean over ``iters`` calls
    under ``torch.profiler`` after a warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = {label: 0.0 for label, _ in parts}
    seen = {label: 0 for label, _ in parts}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for label, keys in parts:
            if any(k in e.name for k in keys):
                total[label] += e.time_range.end - e.time_range.start
                seen[label] += 1
    # the profiler's buffer may drop a record; most must be there
    if any(n < iters // 2 or n > iters for n in seen.values()):
        fail(f"launch_split: {seen} launches in {iters} calls")
    return {label: total[label] / seen[label] for label in total}


def backward_timings(torch, np, dev, fa, rms, plain=True):
    """Phase 7 (d): K4's and K9's backward kernels at smollm-135m's training
    shapes (bf16, 8 x 512 tokens; K4 at 9 / 3 heads of 64, K9 at width
    576), beside their plain twins (``plain``), the library's backward
    through autograd (SDPA's, F.rms_norm's; never called by the port;
    ``autograd_ms``) and the bound: K4's backward reads q, k, v, out, dout
    and lse and writes dq, dk and dv once each, and does 2.5 times its
    forward's products.  Each launch of a call is also timed on its own
    (``launch_split``, us), beside ``EARLIER_LAUNCHES``."""
    F = torch.nn.functional
    shp = dict(B=BATCH, Sq=PLEN, Sk=PLEN, Hq=9, Hkv=3, D=64)
    q, k, v = fa_case(torch, np, dev, dtype="bfloat16", seed=990, **shp)
    out, lse = fa._forward(q, k, v, causal=True, window=0, logit_cap=0.0,
                           scale=None, q_offset=0, with_lse=True)
    dout = torch.randn_like(out)

    def call():
        return fa.flash_attention_bwd(q, k, v, out, lse, dout)
    ms = time_ms(torch, call, iters=5, reps=10)
    split = launch_split(torch, call, BWD_LAUNCHES["flash_attention_bwd"])
    plain_ms = (time_ms(torch, lambda: fa.flash_attention_bwd_torch(
        q, k, v, out, lse, dout), iters=3, reps=3) if plain else None)
    G = shp["Hq"] // shp["Hkv"]
    qt = q.transpose(1, 2).contiguous().requires_grad_(True)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous() \
        .requires_grad_(True)
    dot = dout.transpose(1, 2).contiguous()
    lib = autograd_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), (qt, kt, vt), dot)
    # the forward's bytes (q, k, v read, out written) twice: q, k, v read
    # and dq, dk, dv written; out read and dout read
    nbytes, flops = fa_work(np, **shp, es=2)
    nbytes = 2 * nbytes + 4 * lse.numel()
    b_ms, b_by = bound(nbytes, 2.5 * flops)
    label = "smollm 8 x 512 (64, 64) G 3"
    plain_s = "n/a" if plain_ms is None else f"{plain_ms * 1e3:.1f} us"
    say(f"K4 backward {label}: kernel {ms * 1e3:.1f} us, plain twin "
        f"{plain_s}, SDPA backward (autograd) {lib * 1e3:.1f} "
        f"us, bound {b_ms * 1e3:.2f} us ({b_by})")
    rows = {"flash_attention_bwd": dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
        bound_by=b_by, shape=label, split=split)}
    del q, k, v, out, lse, dout, qt, kt, vt, dot
    rows["rmsnorm_bwd"] = rms_bwd_row(torch, np, dev, rms, "smollm",
                                      BATCH * PLEN, 576, plain)
    for name, row in rows.items():
        earlier = EARLIER_LAUNCHES[name]
        say(f"{name} launches, us a launch: " + ", ".join(
            f"{label} {t:.1f} (before: {earlier[label]:.1f})"
            for label, t in row["split"].items()))
    return rows


def rms_bwd_row(torch, np, dev, rms, family, n, d, plain=True):
    """K9's backward at ``n`` rows of width ``d`` (bf16 x, fp32 scale):
    one call and each of its launches apart, beside its plain twin
    (``plain``), F.rms_norm's backward through autograd and the bound (x
    and dy read, dx written in bf16, rstd read, the scale read and its
    gradient written in fp32; 10 flops an element)."""
    F = torch.nn.functional
    rng = np.random.default_rng(991)
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16)
    w = torch.tensor(0.1 * rng.standard_normal(d), dtype=torch.float32,
                     device=dev)
    _, rstd = rms._forward(x, w, 1e-6, False, with_rstd=True)
    dy = torch.randn_like(x)

    def call():
        return rms.rmsnorm_bwd(x, w, dy, rstd)
    ms = time_ms(torch, call)
    split = launch_split(torch, call, BWD_LAUNCHES["rmsnorm_bwd"])
    plain_ms = (time_ms(torch, lambda: rms.rmsnorm_bwd_torch(x, w, dy, rstd))
                if plain else None)
    lib = None
    if hasattr(F, "rms_norm"):
        xl = x.detach().clone().requires_grad_(True)
        wl = w.to(x.dtype).requires_grad_(True)
        lib = autograd_ms(torch, lambda: F.rms_norm(xl, (d,), weight=wl,
                                                    eps=1e-6), (xl, wl), dy)
    b_ms, b_by = bound(3 * x.numel() * 2 + 4 * n + 2 * 4 * d,
                       10.0 * x.numel())
    label = f"{family} {n} x {d}"
    lib_s = "n/a" if lib is None else f"{lib * 1e3:.1f} us"
    plain_s = "n/a" if plain_ms is None else f"{plain_ms * 1e3:.1f} us"
    say(f"K9 backward {label}: kernel {ms * 1e3:.1f} us, plain twin "
        f"{plain_s}, F.rms_norm backward (autograd) {lib_s}, "
        f"bound {b_ms * 1e3:.3f} us ({b_by}); launches, us each: "
        + ", ".join(f"{k} {t:.1f}" for k, t in split.items()))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, shape=label, split=split)


# K8's backward cases at mamba2-370m's heads (H 32, P 64, N 128): (label,
# ``ssd_case`` shape, chunk, with dh_T): the train step's 8 x 512, the
# long batch's 2 x 4000 (ragged, 32 chunks), one step, 31 steps at G 2, a
# chunk of 37 over 300 steps; then at zamba2-1.2b's (H 64, N 64)
SSD_BWD_CASES = [
    ("8 x 512", dict(B=BATCH, S=PLEN), 128, False),
    ("2 x 4000 (ragged, 32 chunks), initial state, dh_T",
     dict(B=2, S=M_LONG, init=True), 128, True),
    ("2 x 1, no D, initial state, dh_T", dict(B=2, S=1, D=False, init=True),
     128, True),
    ("2 x 31, G 2, dh_T", dict(B=2, S=31, G=2), 128, True),
    ("2 x 300, chunk 37, G 2, no D, initial state",
     dict(B=2, S=300, G=2, D=False, init=True), 37, False),
    # zamba2-1.2b's heads (H 64, P 64, N 64)
    ("zamba2 8 x 512 (H 64, N 64)", dict(B=BATCH, S=PLEN, **ZAMBA_SSM), 128,
     False),
    ("zamba2 1 x 37 (H 64, N 64), initial state, dh_T",
     dict(B=1, S=37, init=True, **ZAMBA_SSM), 128, True),
]
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")


def ssd_bwd_inputs(torch, dev, inp, seed, with_dh):
    """dy (x's shape and dtype) and, ``with_dh``, dh_T: unit normals."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = inp["x"]
    dy = torch.randn(x.shape, generator=gen, device=dev).to(x.dtype)
    B, _, H, P = x.shape
    N = inp["B_mat"].shape[3]
    dh_T = (torch.randn((B, H, P, N), generator=gen, device=dev)
            if with_dh else None)
    return dy, dh_T


def check_ssd_backward(torch, np, dev, ss, errs):
    """Phase 7 (a), K8: ``ssd_scan_bwd`` against its plain twin
    ``ssd_scan_bwd_torch`` on the same inputs at ``SSD_BWD_CASES``, bf16
    and fp32, every gradient within ``TOL`` of its scale, two runs bit for
    bit; through ``ssd_scan`` with a gradient (``SSDScanFn``) the forward
    bit for bit the forward without and the gradients those of a direct
    call; the forms the kernels do not take refused.  Returns the largest
    relative error by dtype; the largest |kernel - plain| goes to
    ``errs["ssd_scan_bwd"]``."""
    worst = {"bfloat16": 0.0, "float32": 0.0}
    errs["ssd_scan_bwd"] = 0.0
    for i, (label, shp, chunk, with_dh) in enumerate(SSD_BWD_CASES):
        for dtype in ("bfloat16", "float32"):
            inp, h0 = ssd_case(torch, np, dev, dtype=dtype, seed=1100 + i,
                               **shp)
            dy, dh_T = ssd_bwd_inputs(torch, dev, inp, 1200 + i, with_dh)
            kw = dict(chunk=chunk, initial_state=h0, dh_T=dh_T)
            n0 = ss.LAUNCHES["ssd_bwd"]
            got = ss.ssd_scan_bwd(**inp, dy=dy, **kw)
            again = ss.ssd_scan_bwd(**inp, dy=dy, **kw)
            torch.cuda.synchronize()
            if ss.LAUNCHES["ssd_bwd"] - n0 != 2:
                fail(f"K8 backward {label} {dtype}: "
                     f"{ss.LAUNCHES['ssd_bwd'] - n0} launches, expected 2")
            if not all((a is None and b is None) or torch.equal(a, b)
                       for a, b in zip(got, again)):
                fail(f"K8 backward {label} {dtype}: two runs differ")
            want = ss.ssd_scan_bwd_torch(**inp, dy=dy, **kw)
            if [a is None for a in got] != [b is None for b in want]:
                fail(f"K8 backward {label} {dtype}: gradients given "
                     f"{[a is not None for a in got]}, expected "
                     f"{[b is not None for b in want]}")
            rel = {n: rel_err(a, b) for n, a, b in zip(SSD_GRADS, got, want)
                   if b is not None}
            if not all(np.isfinite(e) for e in rel.values()) \
                    or max(rel.values()) > TOL[dtype]:
                fail(f"K8 backward {label} {dtype}: relative errors {rel} "
                     f"(tol {TOL[dtype]})")
            worst[dtype] = max(worst[dtype], max(rel.values()))
            note(errs, max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, want) if b is not None),
                 "ssd_scan_bwd")
            say(f"K8 backward {label} {dtype}: relative errors "
                + ", ".join(f"{n} {e:.2e}" for n, e in rel.items()))
            del inp, h0, dy, dh_T, got, again, want
        torch.cuda.empty_cache()
    # through autograd: the forward's bits, the launches, the gradients
    inp, h0 = ssd_case(torch, np, dev, dtype="bfloat16", seed=1190, B=2,
                       S=300, G=2, init=True)
    dy, dh_T = ssd_bwd_inputs(torch, dev, inp, 1191, True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in inp.items()}
    h0g = h0.clone().requires_grad_(True)
    n0 = (ss.LAUNCHES["ssd"], ss.LAUNCHES["ssd_bwd"])
    y, h_T = ss.ssd_scan(**leaves, initial_state=h0g, return_state=True)
    with torch.no_grad():
        y0, h0_T = ss.ssd_scan(**inp, initial_state=h0, return_state=True)
    if not (torch.equal(y.detach(), y0) and torch.equal(h_T.detach(), h0_T)):
        fail("K8 forward with a gradient differs from the forward without")
    got = torch.autograd.grad((y, h_T), [*leaves.values(), h0g], (dy, dh_T))
    direct = ss.ssd_scan_bwd(**inp, dy=dy, initial_state=h0, dh_T=dh_T)
    if (ss.LAUNCHES["ssd"] - n0[0], ss.LAUNCHES["ssd_bwd"] - n0[1]) != (2, 2):
        fail(f"K8 through autograd: launches "
             f"{ss.LAUNCHES['ssd'] - n0[0]} forward, "
             f"{ss.LAUNCHES['ssd_bwd'] - n0[1]} backward, expected 2 and 2")
    order = [SSD_GRADS[("x", "dt", "A", "B_mat", "C_mat", "D").index(k)]
             for k in leaves] + ["dh0"]
    ref = dict(zip(SSD_GRADS, direct))
    if not all(torch.equal(a, ref[n]) for a, n in zip(got, order)):
        fail("K8 through autograd: gradients differ from a direct call's")
    say("K8 through autograd (bf16, 2 x 300, G 2, initial state, dh_T): "
        "the forward bit for bit the forward without, the gradients a "
        "direct call's")
    # the forms the kernels do not take raise
    small, _ = ssd_case(torch, np, dev, B=1, S=64, dtype="bfloat16",
                        seed=1195)
    wide, _ = ssd_case(torch, np, dev, B=1, S=8, N=256, dtype="bfloat16",
                       seed=1196)
    tall, _ = ssd_case(torch, np, dev, B=1, S=8, P=128, dtype="bfloat16",
                       seed=1197)
    n0 = ss.LAUNCHES["ssd_bwd"]
    for what, call in (
            ("chunk 256", lambda: ss.ssd_scan_bwd(
                **small, dy=small["x"], chunk=256)),
            ("N 256", lambda: ss.ssd_scan_bwd(**wide, dy=wide["x"])),
            ("fp16", lambda: ss.ssd_scan_bwd(**{
                k: (v.half() if k in ("x", "B_mat", "C_mat") else v)
                for k, v in small.items()}, dy=small["x"].half())),
            ("P 128 with a gradient", lambda: ss.ssd_scan(**{
                k: v.requires_grad_(True) if k == "x" else v
                for k, v in tall.items()}))):
        try:
            call()
        except ValueError as e:
            say(f"K8 backward refuses {what}: {e}")
            continue
        fail(f"K8 backward {what} on the card did not raise ValueError")
    if ss.LAUNCHES["ssd_bwd"] != n0:
        fail("a refused K8 backward launched a kernel")
    return worst


# K8's backward timed (bf16, mamba2's heads, D, no initial state): the
# train step's 8 x 512 (the JSON row "ssd_scan_bwd") and the long batch's
# 2 x 4000
SSD_BWD_TIMED = (("8 x 512", BATCH, PLEN), ("2 x 4000", 2, M_LONG))
# each launch of a bf16 backward call (more than one chunk), by a substring
# of its kernel's name: the forward's states, pass and scores, then the
# backward's
SSD_BWD_LAUNCHES = (("states", ("ssd_states_kernel",)),
                    ("state pass", ("ssd_pass_kernel",)),
                    ("scores", ("ssd_scores_kernel",)),
                    ("d h_in", ("ssd_bwd_dhin",)),
                    ("reverse pass", ("ssd_bwd_pass",)),
                    ("chunk", ("ssd_bwd_chunk",)),
                    ("dB / dC", ("ssd_bwd_bc",)),
                    ("dA / dD", ("ssd_bwd_reduce",)))
# the times of those launches at 8 x 512 before the tensor cores, us (the
# CUDA-core kernels and their own scores kernel, chip_smoke.py on an NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md §6)
EARLIER_SSD_LAUNCHES = {
    "8 x 512": {"states": 37.8, "state pass": 15.1, "scores": 20.6,
                "d h_in": 109.3, "reverse pass": 20.3, "chunk": 1095.4,
                "dB / dC": 137.2, "dA / dD": 5.8}}


def ssd_bwd_bound(B, S, H=32, P=64, G=1, N=128):
    """K8's backward's bound at these heads (mamba2's by default), bf16:
    x, B, C and dy read and dx, dB and dC written in 2 bytes, dt read and
    ddt written in 4, and twice the forward's products (``ssd_work``).
    (ms, "bytes" or "operations")."""
    nbytes = 2 * (3 * B * S * H * P + 4 * B * S * G * N) + 4 * 2 * B * S * H
    return bound(nbytes, 2 * ssd_work(B, S, H, P, G, N, 2)[1])


def ssd_backward_timings(torch, np, dev, ss, plain=True):
    """Phase 7 (d), K8's backward at ``SSD_BWD_TIMED``: one call (CUDA
    graph replays), each of its launches apart (``launch_split``) and, with
    ``plain``, its plain twin on the card, beside the bound: x, B, C and dy
    read and dx, dB and dC written in x's dtype, dt read and ddt written in
    fp32, and twice the forward's products (``ssd_work``).  No single
    PyTorch call computes the scan's gradient: no library yardstick.
    First, with ``plain``, each bf16 tensor-core kernel's registers,
    shared memory and blocks an SM (``ssd_scan.bwd_occupancy``)."""
    for part in ss.BWD_PARTS if plain else ():
        occ = ss.bwd_occupancy(part)
        if occ["blocks_per_sm"] < 1:
            fail(f"K8 backward {part}: no block fits an SM")
        say(f"K8 backward bf16 {part} kernel: {occ['registers']} registers "
            f"a thread, {occ['smem_bytes']} B of shared memory, "
            f"{occ['blocks_per_sm']} blocks an SM")
    out = {}
    for i, (label, B, S) in enumerate(SSD_BWD_TIMED):
        row = ssd_bwd_row(torch, np, dev, ss, "mamba2", label, B, S,
                          MAMBA_SSM, 1300 + i, plain)
        if i == 0:
            out["ssd_scan_bwd"] = row
        else:
            out[f"ssd_scan_bwd {label}"] = dict(row, entry="ssd_scan_bwd",
                                                err="ssd_scan_bwd")
    return out


def ssd_bwd_row(torch, np, dev, ss, family, label, B, S, heads, seed,
                plain=True, parts=SSD_BWD_LAUNCHES):
    """K8's backward at B x S and ``heads`` (bf16, D, no initial state):
    one call (CUDA graph replays), each of its launches (``parts``) apart
    and, with ``plain``, its plain twin on the card, beside
    ``ssd_bwd_bound``."""
    inp, _ = ssd_case(torch, np, dev, B=B, S=S, dtype="bfloat16", seed=seed,
                      **heads)
    dy, _ = ssd_bwd_inputs(torch, dev, inp, seed + 10, False)

    def call():
        return ss.ssd_scan_bwd(**inp, dy=dy)
    reps = 10 if S <= 1024 else 3
    ms = time_ms(torch, call, iters=5, reps=reps)
    split = launch_split(torch, call, parts, iters=10)
    plain_ms = (time_ms(torch, lambda: ss.ssd_scan_bwd_torch(**inp, dy=dy),
                        iters=2, reps=2) if plain else None)
    b_ms, b_by = ssd_bwd_bound(B, S, heads["H"], heads["P"], 1, heads["N"])
    plain_s = "n/a" if plain_ms is None else f"{plain_ms * 1e3:.1f} us"
    earlier = EARLIER_SSD_LAUNCHES.get(label, {}) if family == "mamba2" \
        else {}
    say(f"K8 backward {family} {label}: kernels {ms * 1e3:.1f} us, plain "
        f"twin {plain_s}, library n/a, bound {b_ms * 1e3:.2f} us "
        f"({b_by}); launches, us each (CUDA cores before): " + ", ".join(
            f"{k} {t:.1f} ({earlier.get(k, 'n/a')})"
            for k, t in split.items()))
    del inp, dy
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, shape=f"{family} {label}", split=split)


def zoo_backward_timings(torch, np, dev, rms, ss):
    """Phase 7 (d), the backward rows of musicgen's and zamba2's shapes:
    K9's at musicgen's 8 x 512 rows of 1536 and K8's at zamba2's
    heads (H 64, P 64, N 64) at 8 x 512; their launches are those
    launchers' (phase 7 c).  Apart from ``backward_timings`` and
    ``ssd_backward_timings``, whose rows tools/bwd_ab.py and
    tools/ssd_ab.py compare between checkouts."""
    return {"rmsnorm_bwd d 1536": dict(
                rms_bwd_row(torch, np, dev, rms, "musicgen", BATCH * PLEN,
                            1536), entry="rmsnorm_bwd",
                family="train musicgen"),
            "ssd_scan_bwd zamba2 8 x 512": dict(
                ssd_bwd_row(torch, np, dev, ss, "zamba2", "8 x 512", BATCH,
                            PLEN, ZAMBA_SSM, 1320),
                entry="ssd_scan_bwd", family="train zamba2",
                err="ssd_scan_bwd")}


# the train steps of phase 7 (b): smollm-135m at full width and depth,
# batch 8 x 512, three steps from one seed
TRAIN_STEPS = 3
# the launcher's main path (c): 24 steps of 8 x 512 with the FROST plane
TRAIN_ARGV = ["--arch", "smollm-135m", "--steps", "24", "--frost",
              "--batch", str(BATCH), "--seq", str(PLEN)]
# mamba2-370m's train step of phase 7 (b): full width, 8 of its 48 layers
# (the plain path's autograd graph of the chunked scan stays small)
MAMBA_TRAIN_LAYERS = 8
# and its launcher run (c): full width and depth, 12 steps of 8 x 512
MAMBA_TRAIN_ARGV = ["--arch", "mamba2-370m", "--steps", "12", "--frost",
                    "--batch", str(BATCH), "--seq", str(PLEN)]
# musicgen-medium's and zamba2-1.2b's train steps of phase 7 (b): full
# width, 4 layers (zamba2: 2 units, each with its shared block); their
# launcher runs (c): full width and depth, 8 steps of 8 x 512
ZOO_TRAIN_LAYERS = 4
ZOO_TRAIN_STEPS = 8


def zoo_train_argv(arch):
    return ["--arch", arch, "--steps", str(ZOO_TRAIN_STEPS), "--frost",
            "--batch", str(BATCH), "--seq", str(PLEN)]


def lm_train_launches(cfg):
    """Launches of K4, K9 and K8, forward and backward, a train step of
    ``cfg``: K4 once an attention layer (zamba2: once a shared block's
    application), K9 once a norm (a Mamba2 layer's pre-norm, an attention
    block's two, the final one; the Mamba2 gated norm is plain torch), K8
    once a Mamba2 layer."""
    L = cfg.n_layers
    if cfg.uses_ssm:
        n_ssm = L
        n_attn = L // cfg.hybrid_attn_every if cfg.family == "hybrid" else 0
        n_norm = L + 2 * n_attn + 1
    else:
        n_attn, n_ssm, n_norm = L, 0, 2 * L + 1
    return {"flash_attention": n_attn, "flash_attention_bwd": n_attn,
            "rmsnorm": n_norm, "rmsnorm_bwd": n_norm, "ssd": n_ssm,
            "ssd_bwd": n_ssm}


def train_reference(torch, np, dev, cfg, da, steps, common, optim, data,
                    plain_policy=None):
    """Phase 7 (b): a train step at full width (smollm-135m's by default),
    on the kernels (K4, or K8 for mamba2, and K9 forward and backward)
    against the same step on the plain path (``plain_policy``, by default
    ``KernelPolicy(attention="ref", rmsnorm="ref")``), from the same seed,
    for ``TRAIN_STEPS`` steps.  fp32: every gradient of the first step
    within 1e-4 of its leaf's scale, each step's loss within 1e-5
    relative; bf16: each step's loss and gradient norm within 2e-2.  The
    kernels' run must launch each kernel ``lm_train_launches`` times a
    step."""
    from repro_torch.kernels.ops import KernelPolicy
    per_step = lm_train_launches(cfg)
    batches = data.TokenBatches(data.DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=PLEN,
        global_batch=BATCH, n_codebooks=cfg.n_codebooks))
    if plain_policy is None:
        plain_policy = KernelPolicy(attention="ref", rmsnorm="ref")
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        runs = {}
        for name, policy in (("kernels", KernelPolicy()),
                             ("plain", plain_policy)):
            sc = steps.StepConfig(
                remat="none", kernel_policy=policy,
                optimizer=optim.OptimizerConfig(warmup_steps=2,
                                                total_steps=24))
            gen = torch.Generator(device=dev).manual_seed(0)
            state = steps.init_train_state(c, sc, gen, dev)
            b0 = batches.batch(0)
            first = steps.make_loss_and_grads(c, sc)(
                state["params"], torch.tensor(b0["inputs"], device=dev),
                torch.tensor(b0["targets"], device=dev))
            step = steps.make_train_step(c, sc)
            da.reset_launches()
            metrics = []
            for i in range(TRAIN_STEPS):
                state, m = step(state, batches.batch(i))
                metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            runs[name] = (first, metrics, dict(da.LAUNCHES))
            del state
            torch.cuda.empty_cache()
        (g_k, m_k, n_k), (g_p, m_p, _) = runs["kernels"], runs["plain"]
        want = {key: n * TRAIN_STEPS for key, n in per_step.items()}
        got = {key: n_k[key] for key in want}
        if got != want:
            fail(f"train step {dtype}: launches {got}, expected {want}")
        tol = 1e-5 if dtype == "float32" else 2e-2
        for i, (a, b) in enumerate(zip(m_k, m_p)):
            e_loss = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            e_norm = abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
            if not np.isfinite(a["loss"]) or e_loss > tol \
                    or (dtype == "bfloat16" and e_norm > tol):
                fail(f"train step {dtype} step {i}: loss {a['loss']} vs "
                     f"{b['loss']}, grad norm {a['grad_norm']} vs "
                     f"{b['grad_norm']}")
        worst = 0.0
        if dtype == "float32":
            if rel_err(g_k[0], g_p[0]) > 1e-5:
                fail(f"train step fp32: first loss {float(g_k[0])} vs "
                     f"{float(g_p[0])}")
            errs = [rel_err(a, b) for a, b in zip(
                common.tree_leaves(g_k[1]), common.tree_leaves(g_p[1]))]
            if not all(np.isfinite(e) for e in errs):
                fail(f"train step fp32: a gradient's error is not finite "
                     f"({errs})")
            worst = max(errs)
            if worst > 1e-4:
                fail(f"train step fp32: a gradient {worst:.2e} of its "
                     "scale from the plain path's")
        say(f"train step {cfg.name} ({cfg.n_layers} layers) {BATCH} x "
            f"{PLEN} {dtype}, kernels vs plain: losses "
            + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}"
                        for a, b in zip(m_k, m_p))
            + ", grad norms "
            + ", ".join(f"{a['grad_norm']:.5f}/{b['grad_norm']:.5f}"
                        for a, b in zip(m_k, m_p))
            + (f", largest gradient error {worst:.2e} of its scale"
               if dtype == "float32" else "")
            + f"; launches {got}")


def zoo_train_references(torch, np, dev, da, steps, common, optim, data,
                         get_arch):
    """Phase 7 (b): the train steps of mamba2-370m, musicgen-medium and
    zamba2-1.2b at full width, cut to ``MAMBA_TRAIN_LAYERS`` (the plain
    path's autograd graph of the chunked scan stays small) and
    ``ZOO_TRAIN_LAYERS`` layers, on the kernels against the plain path
    (``KernelPolicy(attention="ref", rmsnorm="ref", ssd="chunked")``), as
    ``train_reference`` holds smollm's."""
    from repro_torch.kernels.ops import KernelPolicy
    for arch, n_layers in (("mamba2-370m", MAMBA_TRAIN_LAYERS),
                           ("musicgen-medium", ZOO_TRAIN_LAYERS),
                           ("zamba2-1.2b", ZOO_TRAIN_LAYERS)):
        cfg = dataclasses.replace(get_arch(arch).config, n_layers=n_layers)
        train_reference(torch, np, dev, cfg, da, steps, common, optim, data,
                        plain_policy=KernelPolicy(attention="ref",
                                                  rmsnorm="ref",
                                                  ssd="chunked"))
        gc.collect()
        torch.cuda.empty_cache()


def train_main_path(torch, da, train, cfg, card, argv=TRAIN_ARGV):
    """Phase 7 (c): ``repro_torch.launch.train`` at a model's full width
    and depth, ``argv`` (smollm-135m's ``TRAIN_ARGV`` by default, ``cfg``
    its config); launch counts zeroed just before and read just after.
    The [frost] and [frost-ctrl] lines, a loss that falls from its first
    step, each kernel launched exactly ``lm_train_launches`` times a
    step."""
    import contextlib
    import io
    import math
    import tempfile
    with tempfile.TemporaryDirectory() as ckpt:
        args = train.build_parser().parse_args(argv + ["--ckpt-dir", ckpt])
        buf = io.StringIO()
        da.reset_launches()
        with contextlib.redirect_stdout(buf):
            rep = train.train(args)
        torch.cuda.synchronize()
        counts = dict(da.LAUNCHES)
    out = buf.getvalue()
    for line in out.splitlines():
        say(f"  {line}")
    for tag in ("[frost] selected cap", "[frost-ctrl]", "steps/s",
                "tokens/s", "peak memory"):
        if tag not in out:
            fail(f"train main path: no {tag!r} line")
    losses = rep["losses"]
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        fail(f"train main path: loss {losses[0]} -> {losses[-1]}")
    n = rep["steps"]
    want = {key: k * n for key, k in lm_train_launches(cfg).items()}
    got = {key: counts[key] for key in want}
    if got != want:
        fail(f"train main path: launches {got}, expected {want}")
    say(f"main path train {cfg.name} {BATCH} x {PLEN} x {n} steps on "
        f"{card}: {rep['steps_per_s']:.2f} steps/s, "
        f"{rep['tokens_per_s']:.0f} tokens/s, peak {rep['peak_gib']:.2f} "
        f"GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {got}")
    return counts


# --------------------------------------------------------------------------
# phase 8 helpers
# --------------------------------------------------------------------------
# the CNN zoo (``repro_torch.models.cnn``, all 16 models at their published
# widths) on 32x32x3 ``CifarBatches`` images in fp32: (a) one train step at
# batch 8 on the card against the same step on the CPU, (b) 12 steps at
# batch 128, the batch benchmarks/common.epoch_quantities scales every
# profile to, the step wall the median of the last 8
CNN_PARITY_BATCH = 8
CNN_BATCH, CNN_STEPS, CNN_TIMED = 128, 12, 8
# the eval batches profile_cnn reads: 2 from index 100
CNN_EVAL = (100, 101)
# (a)'s tolerances.  In fp32 these nets are ill-conditioned at a batch of
# 8 (rounding flips ReLUs near zero and cancels in batch norms over 2x2
# maps: JAX's own fp32 gradients lie up to 0.3 of a leaf's scale from its
# fp64 ones, tests/test_torch_cnn_zoo.py), so the gradients and the
# updated params are held in fp64, each gradient leaf within 1e-3 of its
# own largest magnitude, a leaf below 1e-10 of the model's largest
# gradient (a batch-norm shift feeding a 1x1 conv and another batch norm:
# zero but for rounding) below it on both; the params within 1e-5 of
# their scale plus lr / eps times the gradients' difference (Adam's first
# step, whose slope is 1 / eps at a zero gradient: the zero leaves' params
# meet that bound to the update's fp32 rounding, so it carries a relative
# 1e-5 of slack).  The losses within 1e-5 in fp64 and, cuDNN's TF32 off,
# in fp32; the fp32 logits within 1e-4 of their largest magnitude, or
# within twice the CPU's own fp32 error from its fp64 logits where that is
# larger: DPN92's fp32 rounding alone moves its logits about 1e-4
# (tests/test_torch_cnn_zoo.py).
CNN_TOL = dict(loss=1e-5, logit=1e-4, grad=1e-3, zero=1e-10, param=1e-5)


def cnn_images(torch, data, dev, batch, step):
    """``CifarBatches(seed=0)``'s batch ``step``: NCHW images and labels
    on ``dev``."""
    x, y = data.CifarBatches(seed=0, batch=batch).batch_at(step)
    return (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(dev),
            torch.from_numpy(y).to(dev))


def cnn_step(torch, cnn, common, optim, name, params, dev, dtype, x, y):
    """One train step of ``name`` from a copy of ``params`` on ``dev`` in
    ``dtype``: (loss, grads, params after AdamW, first moments, learning
    rate, logits)."""
    p = common.tree_map(
        lambda t: t.detach().to(dev, dtype).requires_grad_(True), params)
    cfg = optim.OptimizerConfig(**cnn.OPTIMIZER)
    opt = optim.adamw_init(p, cfg)
    (loss, logits), grads = cnn.loss_and_grads(
        cnn.CNN_ZOO[name][1], p, x.to(dev, dtype), y.to(dev))
    p, opt, m = optim.adamw_update(grads, opt, p, cfg)
    return float(loss), grads, p, opt["mu"], float(m["lr"]), logits.cpu()


def cnn_parity(torch, np, dev, name, bridge, cnn, common, optim, data):
    """Phase 8 (a): ``name``'s train step at batch 8 on the card against
    the same step on the CPU, from the same ``init_cnn`` weights, at
    ``CNN_TOL`` (cuDNN's TF32 off); a model outside them fails.  Returns
    the largest errors found."""
    params = bridge.init_cnn(name, torch.Generator(device=dev).manual_seed(0),
                             dev)
    x, y = cnn_images(torch, data, "cpu", CNN_PARITY_BATCH, 0)
    f64 = torch.float64
    card = cnn_step(torch, cnn, common, optim, name, params, dev, f64, x, y)
    host = cnn_step(torch, cnn, common, optim, name, params, "cpu", f64, x,
                    y)
    out = {"loss": abs(card[0] - host[0]) / abs(host[0])}
    if out["loss"] > CNN_TOL["loss"]:
        fail(f"cnn {name} fp64: loss {card[0]} on the card, {host[0]} on "
             "the CPU")
    flat = lambda t: [g.detach().cpu().double() for g in
                      common.tree_leaves(t)]
    g_card, g_host = flat(card[1]), flat(host[1])
    scale = max(float(g.abs().max()) for g in g_host)
    worst, zeros = 0.0, 0
    for i, (a, b) in enumerate(zip(g_card, g_host)):
        top = float(b.abs().max())
        if top <= CNN_TOL["zero"] * scale:
            zeros += 1
            if float(a.abs().max()) > CNN_TOL["zero"] * scale:
                fail(f"cnn {name} fp64: gradient leaf {i} is zero on the "
                     f"CPU ({top:.3e}), {float(a.abs().max()):.3e} on the "
                     "card")
            continue
        e = float((a - b).abs().max()) / top
        worst = max(worst, e)
        if not e <= CNN_TOL["grad"]:
            fail(f"cnn {name} fp64: gradient leaf {i} {e:.3e} of its scale "
                 f"from the CPU's (tol {CNN_TOL['grad']})")
    cfg = optim.OptimizerConfig(**cnn.OPTIMIZER)
    lr, eps, b1 = host[4], cfg.eps, cfg.b1
    worst_p = 0.0
    for i, (a, b, ma, mb) in enumerate(zip(flat(card[2]), flat(host[2]),
                                           flat(card[3]), flat(host[3]))):
        allowed = (CNN_TOL["param"] * b.abs().max()
                   + lr / eps * (ma - mb).abs() / (1 - b1)) \
            * (1 + CNN_TOL["param"])
        share = float(((a - b).abs() / allowed.clamp_min(1e-300)).max())
        worst_p = max(worst_p, share)
        if share > 1:
            fail(f"cnn {name} fp64: param leaf {i} after AdamW {share:.3e} "
                 "times the Adam-eps bound from the CPU's")
    with torch.no_grad():
        z32 = [cnn.CNN_ZOO[name][1](common.tree_map(
            lambda t: t.detach().to(d), params), x.to(d)).cpu()
            for d in (dev, "cpu")]
    l32 = [float(cnn.cnn_loss(lambda _p, _x: z, None, None, y))
           for z in z32]
    rel = lambda a, b: float((a.double() - b).abs().max() / b.abs().max())
    out["loss32"] = abs(l32[0] - l32[1]) / abs(l32[1])
    out["logit32"] = rel(z32[0], z32[1].double())
    out["logit_tol"] = max(CNN_TOL["logit"], 2 * rel(z32[1], host[5]))
    if not out["loss32"] <= CNN_TOL["loss"]:
        fail(f"cnn {name} fp32: loss {l32[0]} on the card (TF32 off), "
             f"{l32[1]} on the CPU")
    if not out["logit32"] <= out["logit_tol"]:
        fail(f"cnn {name} fp32: logits {out['logit32']:.3e} of their scale "
             f"from the CPU's (tol {out['logit_tol']:.3e})")
    out.update(grad=worst, zeros=zeros, leaves=len(g_host), params=worst_p)
    return out


def cnn_train(torch, np, dev, name, bridge, cnn, common, optim, data):
    """Phase 8 (b): ``name`` trains ``CNN_STEPS`` steps at batch
    ``CNN_BATCH`` on the card with the library's defaults; the loss must
    fall from the first step to the last.  Returns the model's row: step
    ms (median synchronised wall of the last ``CNN_TIMED``, their least
    and most, and their mean split into the host's time issuing
    ``loss_and_grads``, issuing ``adamw_update`` and waiting for the card
    after that), images/s, FLOPs a step (``FlopCounterMode`` over one
    forward and backward), TFLOP/s, peak GiB (above what the card held
    before the model), the losses, accuracy on ``CNN_EVAL``."""
    from torch.utils.flop_counter import FlopCounterMode
    apply = cnn.CNN_ZOO[name][1]
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()        # by the phases before
    params = bridge.init_cnn(name, torch.Generator(device=dev).manual_seed(0),
                             dev)
    cfg = optim.OptimizerConfig(**cnn.OPTIMIZER)
    opt = optim.adamw_init(params, cfg)
    batches = [cnn_images(torch, data, dev, CNN_BATCH, i)
               for i in range(CNN_STEPS)]
    with FlopCounterMode(display=False) as counter:
        cnn.loss_and_grads(apply, params, *batches[0])
    flops = counter.get_total_flops()
    walls, losses = [], []
    for x, y in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (loss, _), grads = cnn.loss_and_grads(apply, params, x, y)
        t1 = time.perf_counter()
        params, opt, _ = optim.adamw_update(grads, opt, params, cfg)
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        walls.append((t3 - t0, t1 - t0, t2 - t1, t3 - t2))
        losses.append(float(loss))
    correct = total = 0
    with torch.no_grad():
        for i in CNN_EVAL:
            x, y = cnn_images(torch, data, dev, CNN_BATCH, i)
            correct += int((apply(params, x).argmax(-1) == y).sum())
            total += y.numel()
    peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    timed = np.array(walls[-CNN_TIMED:]) * 1e3
    step = float(np.median(timed[:, 0])) / 1e3
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"cnn {name}: loss {losses[0]} -> {losses[-1]} over "
             f"{CNN_STEPS} steps")
    row = {"name": name, "step_ms": step * 1e3,
           "step_min": timed[:, 0].min(), "step_max": timed[:, 0].max(),
           "split": timed.mean(axis=0),
           "img_per_s": CNN_BATCH / step, "tflop_step": flops / 1e12,
           "tflops": flops / step / 1e12, "peak_gib": peak,
           "loss0": losses[0], "loss": losses[-1],
           "acc": correct / total,
           "params": common.tree_count(params)}
    del params, opt, grads, batches
    torch.cuda.empty_cache()
    return row


def cnn_zoo(torch, np, dev, bridge, cnn, common, optim, data, card):
    """Phase 8: the CNN zoo.  (a) parity with TF32 off in cuDNN (and in
    matmuls); (b) training with the library's defaults (cuDNN's TF32 on,
    matmuls' off); one line a model each."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for name in cnn.CNN_ZOO:
            e = cnn_parity(torch, np, dev, name, bridge, cnn, common, optim,
                           data)
            say(f"[cnn parity] {name} b{CNN_PARITY_BATCH}, card vs CPU, "
                f"TF32 off: fp64 loss {e['loss']:.2e}, largest gradient "
                f"{e['grad']:.2e} of its scale over {e['leaves']} leaves "
                f"({e['zeros']} zero leaves zero on both), params after "
                f"AdamW at most {e['params']:.2e} of their bound; fp32 "
                f"loss {e['loss32']:.2e}, logits {e['logit32']:.2e} of "
                f"their scale (tol {e['logit_tol']:.2e}) "
                f"(tol loss {CNN_TOL['loss']}, gradients {CNN_TOL['grad']}, "
                f"zero {CNN_TOL['zero']} of the largest, params "
                f"({CNN_TOL['param']} of scale + lr / eps x dg) x (1 + "
                f"{CNN_TOL['param']}))")
    rows = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        onoff = lambda flag: "on" if flag else "off"
        tf32 = (f"cuDNN TF32 {onoff(torch.backends.cudnn.allow_tf32)}, "
                f"matmul TF32 {onoff(torch.backends.cuda.matmul.allow_tf32)}")
        for name in cnn.CNN_ZOO:
            r = cnn_train(torch, np, dev, name, bridge, cnn, common, optim,
                          data)
            rows.append(r)
            mean, fb, adam, wait = r["split"]
            say(f"[cnn] {name} b{CNN_BATCH} fp32 ({r['params'] / 1e6:.2f} M "
                f"params): step {r['step_ms']:.2f} ms (least "
                f"{r['step_min']:.2f}, most {r['step_max']:.2f} of "
                f"{CNN_TIMED}; mean {mean:.2f} = host issuing forward and "
                f"backward {fb:.2f} + AdamW {adam:.2f} + waiting for the "
                f"card {wait:.2f}), "
                f"{r['img_per_s']:.0f} img/s, {r['tflop_step']:.4f} "
                f"TFLOP/step, {r['tflops']:.1f} TFLOP/s, peak "
                f"{r['peak_gib']:.2f} GiB, loss {r['loss0']:.4f} -> "
                f"{r['loss']:.4f} over {CNN_STEPS} steps, acc "
                f"{r['acc']:.3f} ({tf32}) on {card}")
    return rows


# --------------------------------------------------------------------------
# phase 9 helpers
# --------------------------------------------------------------------------
# (b) JAX's serve_batched defaults at stablelm-1.6b's published width
SERVE_BATCHED_ARGV = ["--full", "--arch", "stablelm-1.6b", "--requests", "8",
                      "--prompt-len", "32", "--gen", "24"]
# (c) the families that fit the card whole (deepseek and gemma2 at full
# width are phase 4's, cut in depth)
ZOO_EXAMPLE = ("smollm-135m", "h2o-danube-3-4b", "mamba2-370m",
               "zamba2-1.2b", "musicgen-medium")
# the kernels each arch's engine must launch (pages of 4, 2 slots, no
# shared heads): the paged sweep where its pools are pages, the ring
# sweep on h2o's private windowed rings and zamba2's shared buffers
ZOO_EXAMPLE_KERNELS = {
    "smollm-135m": ("flash_attention", "rmsnorm", "sweep_decode"),
    "h2o-danube-3-4b": ("flash_attention", "rmsnorm", "ring_decode"),
    "mamba2-370m": ("ssd", "rmsnorm"),
    "zamba2-1.2b": ("ssd", "flash_attention", "rmsnorm", "ring_decode"),
    "musicgen-medium": ("flash_attention", "rmsnorm", "sweep_decode")}
# (d) smollm-135m at full width and depth, n_micro 2, the supervisor's
# injected-failure drill
FROST_TRAIN_ARGV = ["--full", "--steps", "40", "--inject-failure", "20"]
# (e) the MoE layer of a2a's check: phi3.5-moe's published widths (d 4096,
# 16 experts of 6400, top 2), 4 x 64 tokens (<= 256: no capacity drop)
A2A_ARCH, A2A_TOKENS = "phi3.5-moe-42b-a6.6b", (4, 64)


def quiet(fn, *args, **kw):
    """``fn`` with its stdout captured, each line said after; -> (result,
    the text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    for line in buf.getvalue().splitlines():
        say(f"  {line}")
    return out, buf.getvalue()


def example_run(torch, da, label, fn, *args, **kw):
    """One phase-9 path: launch counts zeroed just before, read just
    after; -> (result, text, counts)."""
    da.reset_launches()
    out, text = quiet(fn, *args, **kw)
    torch.cuda.synchronize()
    return out, text, dict(da.LAUNCHES)


def check_pages_of_4(torch, np, dev, da, ops, errs):
    """The paged sweep at serve_model_zoo's pages of 4 (four pages a key
    tile of 16) and its 2 slots of 12 pages, smollm's and musicgen's
    heads, decode and verify Q 16, bf16 and fp32, 1 split and the
    engine's count: against the plain version at ``TOL``."""
    shp = dict(B=2, ps=4, nb=12)
    for heads in (dict(Hq=9, Hkv=3, D=64), MUSICGEN_HEADS):
        for dtype in ("bfloat16", "float32"):
            for Q, pos in ((1, [17, 47]), (16, [20, 3])):
                c = make_case(torch, np, dev, pos=pos, Q=Q, dtype=dtype,
                              seed=900 + Q, **shp, **heads)
                auto = ops.choose_kv_splits(2, 48, heads["Hq"], block=4,
                                            device=dev)
                label = (f"pages of 4 {heads['Hq']}/{heads['Hkv']} {dtype} "
                         f"{'verify Q=16' if Q > 1 else 'decode'}")
                worst = 0.0
                for n_splits in sorted({1, 2, auto}):
                    args, vkw = sweep_args(c, Q > 1)
                    got = da.paged_attention_sweep(*args, **vkw,
                                                   n_splits=n_splits,
                                                   merge=True)
                    want = da.paged_attention_sweep_torch(
                        *args, **vkw, n_splits=n_splits)
                    if n_splits > 1:
                        want = da.lse_merge_torch(*want, got.dtype) \
                            .transpose(1, 2)
                    worst = max(worst, max_err(torch, got, want, TOL[dtype],
                                               f"{label} n_splits "
                                               f"{n_splits}"))
                note(errs, worst, f"paged_attention_sweep {dtype}")
                say(f"kernels ok: {label} (n_splits 1, 2, {auto}), max |kernel "
                    f"- plain| {worst:.3e} (tol {TOL[dtype]})")


def check_collectives(torch, dev, layers, compress, mesh, card):
    """(e) ``compressed_psum`` and ``moe_forward_a2a`` over the NCCL group
    of one rank the host mesh runs on, against their plain single-process
    results."""
    host = mesh.make_host_mesh(dev)
    group = host.group("data")
    gen = torch.Generator(device=dev).manual_seed(31)
    grads = {"w": torch.randn((1536, 576), generator=gen, device=dev),
             "b": torch.randn((576,), generator=gen, device=dev) * 3}
    red, err = compress.compressed_psum(grads, group,
                                        compress.init_error_state(grads))
    worst = 0.0
    for key, g in grads.items():
        q, scale, _ = compress.compress_residual(g)
        if not torch.equal(red[key], compress.dequantize_int8(q, scale)):
            fail(f"compressed_psum {key}: the one-rank mean is not the "
                 "plain dequantized value")
        worst = max(worst, float((red[key] + err[key] - g).abs().max()))
    if worst > 1e-6:
        fail(f"compressed_psum: |out + error - input| = {worst:.3e} > 1e-6")
    say(f"compressed_psum over NCCL (1 rank) on {card}: out == "
        f"dequant(quant(g)), max |out + error - input| {worst:.3e} "
        f"(bound 1e-6)")
    import dataclasses as dc
    from repro_torch import bridge
    from repro_torch.configs import get_arch
    cfg = dc.replace(get_arch(A2A_ARCH).config, dtype="bfloat16")
    shapes = bridge._moe_shapes(cfg, ())
    ffn = {key: (torch.randn(shape, generator=gen, device=dev)
                 / shape[-2] ** 0.5).to(torch.bfloat16)
           for key, shape in shapes.items() if key != "shared"}
    x = torch.randn(*A2A_TOKENS, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    ctx = layers.ParallelCtx(mesh=host, batch_axes=("data",),
                             moe_strategy="a2a")
    with torch.no_grad():
        a2a, aux_a = layers.moe_forward(ffn, x, cfg, ctx)
        loc, aux_l = layers.moe_forward(ffn, x, cfg)
    torch.cuda.synchronize()
    e = max_err(torch, a2a, loc, TOL["bfloat16"],
                "moe_forward_a2a against moe_forward")
    if float(aux_a) != float(aux_l):
        fail(f"moe_forward_a2a: aux {float(aux_a)} != {float(aux_l)}")
    say(f"moe_forward_a2a over NCCL (1 rank), {A2A_ARCH} widths, "
        f"{A2A_TOKENS[0]} x {A2A_TOKENS[1]} tokens, bf16 on {card}: max "
        f"|a2a - local| {e:.3e} (tol {TOL['bfloat16']})")


def examples_phase(torch, np, dev, da, ops, errs, card, launches,
                   by_family):
    """Phase 9: the dry-run on the host mesh and the four FROST examples
    that run models, through their ``main``; each path's launch counts
    zeroed just before it and read just after, added to ``launches`` and
    ``by_family`` (``example <name>``)."""
    import math
    import tempfile
    from repro_torch.configs import ARCH_SPECS, SHAPES, get_arch
    from repro_torch.examples import (serve_batched, serve_model_zoo,
                                      train_lm_frost)
    from repro_torch.launch import dryrun, mesh, stepcost
    from repro_torch.models import layers
    from repro_torch.runtime import compress

    def count(label, counts):
        by_family[f"example {label}"] = counts
        for key, n in counts.items():
            launches[key] += n

    # (a) the dry-run: every cell on the host mesh, nothing allocated
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as out:
        recs, _ = quiet(dryrun.run_cells, list(ARCH_SPECS), list(SHAPES),
                        ["host"], pathlib.Path(out), device="cuda")
    if torch.cuda.memory_allocated() != held:
        fail(f"dry-run: {torch.cuda.memory_allocated() - held} bytes of "
             "device memory allocated (meta tensors allocate none)")
    bad = [r for r in recs if r["status"] != "ok"]
    if bad or not recs:
        fail(f"dry-run: {len(bad)} of {len(recs)} cells failed: "
             f"{[(r['arch'], r['shape'], r['error']) for r in bad]}")
    fits = [f"{r['arch']} x {r['shape']}" for r in recs if r["fits"]]
    gib = recs[0]["device_memory_bytes"] / 2 ** 30
    say(f"dry-run --mesh host on {card}: {len(recs)} cells ok in "
        f"{time.perf_counter() - t0:.1f} s, no device memory allocated; "
        f"{len(fits)} fit in {gib:.1f} GiB (arguments + outputs, "
        f"activations not counted): {', '.join(fits)}")

    # (b) serve_batched at stablelm-1.6b's published width
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, text, counts = example_run(torch, da, "serve_batched",
                                    serve_batched.main, SERVE_BATCHED_ARGV)
    cfg = get_arch("stablelm-1.6b").config
    want = stepcost.serve_step_cost(cfg, 8, 32 + 24)[0]
    if out["flops"] != want or f"{want / 1e6:.1f} MFLOP" not in text:
        fail(f"serve_batched: [frost] FLOPs {out['flops']} != "
             f"serve_step_cost {want}")
    for key in ("flash_attention", "rmsnorm", "ring_decode"):
        if counts[key] <= 0:
            fail(f"serve_batched: kernel {key} was never launched")
    if out["tokens"].shape != (8, 24):
        fail(f"serve_batched: tokens {out['tokens'].shape}, expected (8, 24)")
    count("serve_batched", counts)
    say(f"example serve_batched stablelm-1.6b 8 x 32 + 24 on {card}: "
        f"{out['tok_per_s']:.1f} tok/s measured (decode steps, "
        f"synchronised), decode step {want:.6g} FLOP = serve_step_cost, cap "
        f"{out['decision'].cap:.0%}, peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, launches "
        f"{counts}")

    # (c) serve_model_zoo at published widths, pages of 4
    check_pages_of_4(torch, np, dev, da, ops, errs)
    for arch in ZOO_EXAMPLE:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        reps, _, counts = example_run(
            torch, da, arch, serve_model_zoo.main,
            ["--full", "--arches", arch])
        rep = reps[arch]
        if len(rep.results) != 3:
            fail(f"serve_model_zoo {arch}: {len(rep.results)} results of 3")
        for r in rep.results:
            if r.n_tokens != r.max_new_tokens:
                fail(f"serve_model_zoo {arch}: rid {r.rid} finished "
                     f"{r.n_tokens}/{r.max_new_tokens} ({r.finish_reason})")
        for key in ZOO_EXAMPLE_KERNELS[arch]:
            if counts[key] <= 0:
                fail(f"serve_model_zoo {arch}: kernel {key} was never "
                     "launched")
        count(f"serve_model_zoo {arch}", counts)
        say(f"example serve_model_zoo {arch} (published width, pages of 4) "
            f"on {card}: {rep.tokens_kept} tokens, {rep.tok_per_s:.1f} "
            f"tok/s measured, {time.perf_counter() - t0:.1f} s with the "
            f"weights' draw, peak "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {counts}")

    # (d) train_lm_frost: n_micro 2, one injected failure, one restart
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt:
        rep, text, counts = example_run(
            torch, da, "train_lm_frost", train_lm_frost.main,
            FROST_TRAIN_ARGV + ["--ckpt", ckpt])
    losses = rep["losses"]
    if rep["restarts"] != 1:
        fail(f"train_lm_frost: {rep['restarts']} restarts, expected 1")
    if not all(math.isfinite(v) for v in losses) or losses[-1] >= losses[0]:
        fail(f"train_lm_frost: loss {losses[0]} -> {losses[-1]}")
    for key in ("flash_attention", "rmsnorm", "flash_attention_bwd",
                "rmsnorm_bwd"):
        if counts[key] <= 0:
            fail(f"train_lm_frost: kernel {key} was never launched")
    count("train_lm_frost", counts)
    say(f"example train_lm_frost smollm-135m 8 x 128, n_micro 2, 40 steps, "
        f"failure at 20 on {card}: {rep['restarts']} restart, "
        f"{len(losses)} steps kept in {rep['seconds']:.1f} s "
        f"({rep['steps_per_s']:.2f} steps/s), peak {rep['peak_gib']:.2f} "
        f"GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}, launches {counts}")

    # (e) the collectives over NCCL
    gc.collect()
    torch.cuda.empty_cache()
    check_collectives(torch, dev, layers, compress, mesh, card)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()



# --------------------------------------------------------------------------
# phase 10 helpers: sharded execution, four ranks on the card over gloo
# --------------------------------------------------------------------------
SHARD_MESH = (2, 2)                       # ("data", "model")
SHARD_TRAIN = dict(batch=8, seq=128, steps=3, seed=7)
SHARD_DECODE = dict(batch=4, prompt=64, gen=16, seed=11)
# the bounds JAX's sharded test holds a bf16 step to
# (tests/test_distributed.py): |dloss|, relative |d grad norm|, max
# |dparam|; and its decode's max |dlogit|
SHARD_TOL = dict(loss=2e-2, grad_norm=5e-2, params=2e-2, logits=0.1)
SHARD_TIMEOUT = 600
# the archs phase 10 trains and decodes sharded, at full width; mamba2's
# SSM heads, inner dims and conv channels, and zamba2's with its shared
# block's heads and MLP, go over "model"
SHARD_TRAIN_ARCHS = ("smollm-135m", "mamba2-370m", "zamba2-1.2b")
# the decodes, (arch, dtype), each held at SHARD_TOL["logits"], and
# beside it the one-rank run's own spread when it decodes its rows in the
# ranks' two halves (no sharding: none for smollm; in bf16 for mamba2 at
# full depth, of the order of the bound); mamba2 and zamba2 in fp32 too,
# and mamba2's bf16 decode printed, not held (PERF.md §6)
SHARD_DECODES = (("smollm-135m", "bfloat16"), ("h2o-danube-3-4b", "bfloat16"),
                 ("mamba2-370m", "float32"), ("zamba2-1.2b", "float32"),
                 ("mamba2-370m", "bfloat16"), ("zamba2-1.2b", "bfloat16"))
SHARD_DECODE_UNGATED = (("mamba2-370m", "bfloat16"),)
# the kernels each sharded run must launch: train steps (a rank's
# launches, exact: ``lm_train_launches`` a step) and decodes
SHARD_TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                       "rmsnorm_bwd", "ssd", "ssd_bwd")
SHARD_DECODE_KERNELS = {"smollm-135m": ("ring_shard_decode", "merge",
                                        "rmsnorm"),
                        "h2o-danube-3-4b": ("ring_decode", "rmsnorm"),
                        "mamba2-370m": ("rmsnorm",),
                        "zamba2-1.2b": ("ring_decode", "rmsnorm")}
# K8 forward and backward at the sharded train step's local shapes: a
# rank's 4 of the 8 rows, 128 steps, half the heads
SHARD_SSD = (("mamba2", dict(H=16, P=64, N=128)),
             ("zamba2", dict(H=32, P=64, N=64)))
SHARD_SSD_ROWS = (SHARD_TRAIN["batch"] // SHARD_MESH[0], SHARD_TRAIN["seq"])


def in_turns(torch, rules, fn):
    """``fn()`` on every rank, one rank after another (all at once off a
    mesh): each rank draws the whole seeded state before it keeps its
    shards, and four whole zamba2 train states at once would not fit
    beside each other on one card."""
    if rules is None:
        return fn()
    import torch.distributed as dist
    out = None
    for r in range(dist.get_world_size()):
        if r == dist.get_rank():
            out = fn()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def shard_step_cfg(steps):
    from repro_torch.optim import OptimizerConfig
    return steps.StepConfig(n_micro=1, remat="none", optimizer=OptimizerConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=10))


def shard_train(torch, cfg, dev, rules=None):
    """``cfg``'s train steps from a seeded init, on one rank (``rules``
    None) or this rank's shards: (losses, grad norms, the final params'
    leaves whole on the CPU, the steps' launches)."""
    from repro_torch import bridge
    from repro_torch.kernels import binding
    from repro_torch.models import common
    from repro_torch.runtime import sharding, steps
    sc = shard_step_cfg(steps)
    def init():
        gen = torch.Generator(device=dev).manual_seed(SHARD_TRAIN["seed"])
        state = steps.init_train_state(cfg, sc, gen, dev)
        if rules is not None:
            state = steps.shard_train_state(state, rules, cfg)
        return state

    state = in_turns(torch, rules, init)
    step = steps.make_train_step(cfg, sc, rules)
    g = torch.Generator().manual_seed(SHARD_TRAIN["seed"])
    B, S = SHARD_TRAIN["batch"], SHARD_TRAIN["seq"]
    losses, norms = [], []
    binding.reset_launches()
    for _ in range(SHARD_TRAIN["steps"]):
        toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=g)
        state, m = step(state, {"inputs": toks[:, :-1], "targets": toks[:, 1:]})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    launches = dict(binding.LAUNCHES)
    params = state["params"]
    if rules is not None:
        params = sharding.gather_params(
            params, rules.param_sharding(bridge.param_axes(cfg)), rules.mesh)
    return losses, norms, [p.detach().cpu() for p in
                           common.tree_leaves(params)], launches


def shard_decode(torch, cfg, dev, rules=None, feed=None, halves=False):
    """Prefill of SHARD_DECODE's prompt, then its greedy serve steps, in
    ``cfg.dtype`` at full width from a seeded init: (the logits of every
    step, whole batch and vocab, on the CPU in fp32; the greedy tokens;
    the serve steps' launches; the ring's shard record).  With ``feed``
    (another run's greedy tokens, (B, gen + 1)) each step takes that
    run's token, so that the logits of the two runs answer the same
    inputs: a bf16 near tie that flips one greedy token would otherwise
    compare logits of different streams from there on.  ``halves`` (one
    rank): the batch's two halves decoded one after the other, as the
    two "data" ranks of the mesh hold them."""
    from repro_torch import bridge
    from repro_torch.kernels import binding
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime import sharding, steps
    B, P, G = (SHARD_DECODE[k] for k in ("batch", "prompt", "gen"))

    def init():
        gen = torch.Generator(device=dev).manual_seed(SHARD_DECODE["seed"])
        params = bridge.init_lm(cfg, gen, dev)
        if rules is not None:
            params = sharding.shard_params(
                params, rules.param_sharding(bridge.param_axes(cfg)),
                rules.mesh)
        return params

    params = in_turns(torch, rules, init)
    sc = shard_step_cfg(steps)
    prefill = steps.make_prefill_step(cfg, sc, max_len=P + G, rules=rules)
    serve = steps.make_serve_step(cfg, sc, rules, greedy=False)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch.Generator(
        ).manual_seed(SHARD_DECODE["seed"]), dtype=torch.int32).to(dev)
    rows = None if rules is None else rules.mesh.group("data")

    def whole(x):
        x = x if len(x) == n else col._all_gather(x, 0, rows)
        return x.float().cpu()

    def next_token(t):
        own = logits[-1].argmax(-1).to(torch.int32)[:, None]
        toks.append(own)
        return (own if feed is None else feed[sl, t:t + 1]).to(dev)

    parts, launches = [], {k: 0 for k in binding.LAUNCHES}
    binding.reset_launches()
    for sl in ((slice(0, B // 2), slice(B // 2, B)) if halves
               else (slice(0, B),)):
        n = sl.stop - sl.start
        with torch.no_grad():
            last, cache = prefill(params, {"inputs": prompt[sl]})
            logits, toks = [whole(last)], []
            tok = next_token(0)
            n0 = dict(binding.LAUNCHES)
            for t in range(G):
                lg, cache = serve(params, cache, tok)
                logits.append(whole(lg[:, -1]))
                tok = next_token(t + 1)
            torch.cuda.synchronize()
        for k, v in binding.LAUNCHES.items():
            launches[k] += v - n0[k]
        parts.append((torch.stack(logits), torch.cat(toks, dim=1)))
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=0), launches,
            cache.get("shard"))


def card_collectives(torch, col, dev) -> dict:
    """Each collective the port calls, on this rank's CUDA tensors over
    the whole group, checked against its expected result (the checks of
    ``tools/gloo_cuda_probe.py``): {name: right on every rank}."""
    import torch.distributed as dist
    n, r = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * n, dtype=torch.float32, device=dev) + 100 * r
    total = torch.arange(2 * n, dtype=torch.float32) * n \
        + 100 * n * (n - 1) / 2
    got = {"all_reduce": bool(torch.equal(
               col._all_reduce(x, dist.group.WORLD).cpu(), total)),
           "all_gather": bool(torch.equal(
               col._all_gather(x, 0, dist.group.WORLD).cpu(),
               torch.cat([torch.arange(2 * n, dtype=torch.float32) + 100 * i
                          for i in range(n)]))),
           "reduce_scatter": bool(torch.equal(
               col._reduce_scatter(x, 0, dist.group.WORLD).cpu(),
               total[2 * r:2 * r + 2]))}
    every = [None] * n
    dist.all_gather_object(every, got)
    return {k: all(e[k] for e in every) for k in got}


def sharded_rank(out_dir: str) -> int:
    """One rank of phase 10 (``chip_smoke.py --sharded-rank DIR``, under
    RANK / LOCAL_RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT): the
    sharded train steps and decodes, each held by rank 0 against the
    one-rank results the parent saved in DIR."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_arch
    from repro_torch.launch import mesh as tmesh
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime import sharding
    out = pathlib.Path(out_dir)
    t0 = time.perf_counter()
    host = tmesh.make_host_mesh(None, axes=("data", "model"),
                                shape=SHARD_MESH)
    dev = tmesh.local_device(None)
    rank = dist.get_rank()
    res = {"backend": dist.get_backend(), "world": dist.get_world_size(),
           "mesh": host.shape, "device": str(dev)}
    res["train"], res["decode"] = {}, {}
    for arch in SHARD_TRAIN_ARCHS:
        cfg = get_arch(arch).config
        rules = sharding.build_rules(cfg, host)
        t1 = time.perf_counter()
        losses, norms, params, launches = shard_train(torch, cfg, dev, rules)
        if rank == 0:
            ref = torch.load(out / f"train-{arch}.pt")
            res["train"][arch] = {
                "losses": losses, "norms": norms, "launches": launches,
                "seconds": time.perf_counter() - t1,
                "dloss": max(abs(a - b)
                             for a, b in zip(losses, ref["losses"])),
                "dgrad": max(abs(a - b) / max(b, 1e-9)
                             for a, b in zip(norms, ref["norms"])),
                "dparam": max(float((p.float() - q.float()).abs().max())
                              for p, q in zip(params, ref["params"]))}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    for arch, dtype in SHARD_DECODES:
        cfg = dataclasses.replace(get_arch(arch).config, dtype=dtype)
        # serving keeps the weights whole over "data" (gathered once, at
        # load) and cut over "model": no FSDP gather every token
        rules = sharding.build_rules(cfg, host, fsdp=False)
        ref = torch.load(out / f"decode-{arch}-{dtype}.pt")
        logits, toks, launches, ring = shard_decode(
            torch, cfg, dev, rules, feed=ref["tokens"])
        if rank == 0:
            diff = (logits - ref["logits"]).abs()
            res["decode"][f"{arch} {dtype}"] = {
                "dlogit": float(diff.max()),
                "dlogit_steps": [float(d.max()) for d in diff],
                "logit_max": float(ref["logits"][ref["logits"] > -1e29]
                                   .abs().max()),
                "tokens": toks.tolist(), "ref_tokens": ref["tokens"].tolist(),
                "launches": launches, "ring": ring}
        gc.collect()
        torch.cuda.empty_cache()
    res["collectives"] = card_collectives(torch, col, dev)
    res["seconds"] = time.perf_counter() - t0
    if rank == 0:
        (out / "result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()
    return 0


# capacity-shard sweep cases beyond the timed one (the last decode
# position): a wrapped ring whose window crosses slot 0 into shard 0, a
# window that leaves shard 0 empty (its lse NEG_INF), and three splits a
# shard over blocks of 8 slots
SHARD_SWEEP_CASES = {"wrapped window": dict(pos=37, wrap=1, window=50),
                     "empty shard": dict(pos=-1, window=30, empty=0),
                     "3 splits a shard": dict(pos=-1, n_splits=3, block_k=8)}


def shard_sweep_case(torch, np, da, q, k, v, R, tp, pos, *, n_splits,
                     block_k, window=0, empty=None, what=""):
    """The ring (B, R, Hkv, D) cut into ``tp`` capacity shards: each swept
    by the kernel into unmerged partials at its slot offset, the shards'
    partials merged by ``lse_merge``; held against the plain versions of
    both with the same offsets and ring length, and against the whole
    ring's plain sweep.  ``empty`` names a shard that must see no slot.
    Returns (kernel partials and lse, plain ones, merged, max error)."""
    C = R // tp
    kw = dict(n_splits=n_splits, block_k=block_k, ring_len=R, partials=True,
              window=window)

    def sweep(fn):
        return [fn(q, k[:, r * C:(r + 1) * C].contiguous(),
                   v[:, r * C:(r + 1) * C].contiguous(), pos,
                   slot_offset=r * C, **kw) for r in range(tp)]

    parts = sweep(da.ring_attention_sweep)
    plain = sweep(da.ring_attention_sweep_torch)
    cat = [torch.cat([p[j] for p in parts], dim=2) for j in (0, 1)]
    pcat = [torch.cat([p[j] for p in plain], dim=2) for j in (0, 1)]
    got = da.lse_merge(*cat, q.dtype)
    want = da.lse_merge_torch(*pcat, q.dtype)
    whole = da.ring_attention_sweep_torch(q, k, v, pos, n_splits=1,
                                          block_k=block_k, window=window)
    torch.cuda.synchronize()
    e = max_err(torch, got.float(), want.float(), TOL["bfloat16"],
                f"capacity-shard sweep + merge ({what}) against its plain "
                "version")
    e_p = max_err(torch, cat[0], pcat[0], TOL["bfloat16"],
                  f"capacity-shard partials ({what}) against the plain "
                  "partials")
    max_err(torch, got.transpose(1, 2).float(), whole.float(),
            TOL["bfloat16"], f"the shards merged ({what}) against the whole "
            "ring")
    if empty is not None:
        lse = parts[empty][1]
        if float(lse.max()) != float(np.float32(da.NEG_INF)):
            fail(f"capacity-shard sweep ({what}): shard {empty} sees no "
                 f"slot but its lse is {float(lse.max())}, not NEG_INF")
    return cat, pcat, max(e, e_p)


def shard_sweep_row(torch, np, dev, da, ops, errs, card):
    """The capacity-shard ring sweep (one rank's shard, unmerged partials)
    and the merge of the ranks' partials (K2b, standalone) at smollm's
    sharded decode: batch rows 2 of 4, 9 q and 3 kv heads, head dim 64,
    a ring of 80 slots cut in 2, bf16: at the last decode position (the
    timed case) and at ``SHARD_SWEEP_CASES``; against their plain
    versions, and the row of the kernel line."""
    B, Hq, Hkv, D, tp = 2, 9, 3, 64, SHARD_MESH[1]
    R = SHARD_DECODE["prompt"] + SHARD_DECODE["gen"]
    C = R // tp
    g = torch.Generator(device=dev).manual_seed(41)
    q = torch.randn((B, 1, Hq, D), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, R, Hkv, D), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    pol = ops.DEFAULT_POLICY
    pos = torch.tensor([R - 1], dtype=torch.int32, device=dev)
    n_splits = ops._ring_splits(pol, q, k[:, :C], 0)
    cat, pcat, err = shard_sweep_case(torch, np, da, q, k, v, R, tp, pos,
                                      n_splits=n_splits,
                                      block_k=pol.decode_k_chunk,
                                      what="last position")
    for what, c in SHARD_SWEEP_CASES.items():
        p = c["pos"] % R + c.get("wrap", 0) * R
        _, _, e = shard_sweep_case(
            torch, np, da, q, k, v, R, tp,
            torch.tensor([p], dtype=torch.int32, device=dev),
            n_splits=c.get("n_splits", 1),
            block_k=c.get("block_k", pol.decode_k_chunk),
            window=c.get("window", 0), empty=c.get("empty"),
            what=f"{what}, pos {p}")
        err = max(err, e)
    name = "ring_attention_sweep shard + lse_merge (decode)"
    errs[name] = err
    kw = dict(n_splits=n_splits, block_k=pol.decode_k_chunk, ring_len=R,
              partials=True)
    k0, v0 = k[:, :C].contiguous(), v[:, :C].contiguous()
    ms_sweep = time_ms(torch, lambda: da.ring_attention_sweep(
        q, k0, v0, pos, slot_offset=0, **kw))
    ms_merge = time_ms(torch, lambda: da.lse_merge(*cat, torch.bfloat16))
    plain_ms = time_ms(torch, lambda: da.lse_merge_torch(
        *pcat, torch.bfloat16)) + time_ms(
            torch, lambda: da.ring_attention_sweep_torch(
                q, k0, v0, pos, slot_offset=0, **kw))
    S = cat[0].shape[2] // tp
    # one rank's work: q, its shard's k / v rows, its partials and lse
    # written, then the merge reading all ranks' partials and writing out
    part_b = B * Hq * S * D * 4 + B * Hq * S * 4
    nbytes = (q.numel() * 2 + 2 * B * C * Hkv * D * 2 + part_b
              + tp * part_b + B * Hq * D * 2)
    flops = 4 * B * Hq * C * D
    b_ms, b_by = bound(nbytes, flops)
    say(f"{name}: smollm-135m decode shapes (2 rows, 9 / 3 heads, D 64, "
        f"ring {R} in {tp} shards of {C}, {n_splits} splits a shard, bf16; "
        f"also {', '.join(SHARD_SWEEP_CASES)}): "
        f"sweep {ms_sweep * 1e3:.2f} us + merge {ms_merge * 1e3:.2f} us, "
        f"plain {plain_ms * 1e3:.1f} us, |kernel - plain| {errs[name]:.3e} "
        f"on {card}")
    return {name: {"ms": ms_sweep + ms_merge, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "shape": f"2 x 9 / 3 heads, D 64, ring {R} / {tp}",
                   "merge_ms": ms_merge}}


def shard_ssd_rows(torch, np, dev, ss, errs, card):
    """Phase 10 (c), K8 forward and backward at the sharded train step's
    local shapes (``SHARD_SSD``, ``SHARD_SSD_ROWS``): held against their
    plain versions in bf16 and fp32 (the forward at ``SSD_TOL``, each
    gradient within ``TOL`` of its scale), the model's local views read in
    place, and timed (bf16).  Rows "ssd_scan sharded <family> ..." and
    "ssd_scan_bwd sharded <family> ...", their launches a rank's in the
    sharded train steps."""
    Bl, S = SHARD_SSD_ROWS
    errs["ssd_scan sharded"] = errs["ssd_scan_bwd sharded"] = 0.0
    out = {}
    for i, (family, heads) in enumerate(SHARD_SSD):
        H, P, N = heads["H"], heads["P"], heads["N"]
        # the model's layout: views of one rank's conv output, its x
        # channels then B and C, which the kernel reads in place
        conv = torch.zeros((Bl, S, H * P + 2 * N), dtype=torch.bfloat16,
                           device=dev)
        for t, width in ((conv[..., :H * P].reshape(Bl, S, H, P), P),
                         (conv[..., H * P:H * P + N].reshape(Bl, S, 1, N),
                          N)):
            if ss._rows(t, S, width)[0].data_ptr() != t.data_ptr():
                fail(f"K8 sharded {family}: a local view of the conv "
                     "output is copied, not read in place")
        label = f"{Bl} x {S} (H {H}, N {N})"
        for dtype in ("bfloat16", "float32"):
            inp, _ = ssd_case(torch, np, dev, B=Bl, S=S, dtype=dtype,
                              seed=1400 + i, **heads)
            y, h = ss.ssd_scan(**inp, return_state=True)
            wy, wh = ss.ssd_scan_torch(**inp, return_state=True)
            what = f"K8 sharded {family} {label} {dtype}"
            e = max(max_err(torch, y, wy, SSD_TOL[dtype], what + " y"),
                    max_err(torch, h, wh, SSD_TOL[dtype], what + " state"))
            note(errs, e, "ssd_scan sharded")
            dy, _ = ssd_bwd_inputs(torch, dev, inp, 1410 + i, False)
            got = ss.ssd_scan_bwd(**inp, dy=dy)
            want = ss.ssd_scan_bwd_torch(**inp, dy=dy)
            rel = {n: rel_err(a, b) for n, a, b in zip(SSD_GRADS, got, want)
                   if b is not None}
            if not all(np.isfinite(v) for v in rel.values()) \
                    or max(rel.values()) > TOL[dtype]:
                fail(f"{what} backward: relative errors {rel} (tol "
                     f"{TOL[dtype]})")
            note(errs, max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(got, want) if b is not None),
                 "ssd_scan_bwd sharded")
            say(f"{what}: forward max |kernel - plain| {e:.3e} (tol "
                f"{SSD_TOL[dtype]}; |y| up to "
                f"{float(wy.float().abs().max()):.1f}), backward relative "
                f"errors "
                + ", ".join(f"{n} {v:.2e}" for n, v in rel.items()))
            del inp, dy, got, want
        fwd = ssd_rows(torch, np, dev, ss, table=((label, Bl, S),),
                       heads=heads)[label]
        # one chunk: the backward launches no forward states kernel
        bwd = ssd_bwd_row(torch, np, dev, ss, f"sharded {family}", label,
                          Bl, S, heads, 1420 + i, parts=tuple(
                              p for p in SSD_BWD_LAUNCHES
                              if p[0] != "states"))
        fam = f"sharded {family}"
        say(f"K8 sharded {family} {label} bf16: forward kernel "
            f"{fwd['ms'] * 1e3:.1f} us, plain {fwd['plain_ms'] * 1e3:.1f} "
            f"us, bound {fwd['bound_ms'] * 1e3:.2f} us ({fwd['bound_by']}) "
            f"on {card}")
        out[f"ssd_scan sharded {family} {label}"] = dict(
            fwd, library_ms=None, shape=f"{fam} {label}", entry="ssd_scan",
            family=fam, err="ssd_scan sharded")
        out[f"ssd_scan_bwd sharded {family} {label}"] = dict(
            bwd, entry="ssd_scan_bwd", family=fam,
            err="ssd_scan_bwd sharded")
        torch.cuda.empty_cache()
    return out


def sharded_phase(torch, np, dev, da, ops, errs, card, launches,
                  by_family):
    """(a) the one-rank references: the train steps of
    ``SHARD_TRAIN_ARCHS`` and the decodes of ``SHARD_DECODES``,
    saved; (b) four ranks on this card over gloo as a (2, 2) mesh, each
    running the same sharded (chip_smoke.py --sharded-rank); (c) the
    capacity-shard sweep's row and K8's rows at the local shapes of the
    sharded train steps."""
    import shutil
    import socket
    import tempfile
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as ss
    t0 = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    t_ref, spread = {}, {}
    try:
        for arch in SHARD_TRAIN_ARCHS:
            t1 = time.perf_counter()
            losses, norms, params, _ = shard_train(
                torch, get_arch(arch).config, dev)
            torch.save({"losses": losses, "norms": norms, "params": params},
                       tmp / f"train-{arch}.pt")
            del params
            gc.collect()
            torch.cuda.empty_cache()
            t_ref[f"train {arch}"] = time.perf_counter() - t1
        for arch, dtype in SHARD_DECODES:
            t1 = time.perf_counter()
            cfg = dataclasses.replace(get_arch(arch).config, dtype=dtype)
            logits, toks, _, _ = shard_decode(torch, cfg, dev)
            torch.save({"logits": logits, "tokens": toks},
                       tmp / f"decode-{arch}-{dtype}.pt")
            halves = shard_decode(torch, cfg, dev, feed=toks,
                                  halves=True)[0]
            spread[f"{arch} {dtype}"] = float((halves - logits).abs().max())
            gc.collect()
            torch.cuda.empty_cache()
            t_ref[f"decode {arch} {dtype}"] = time.perf_counter() - t1
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        n = SHARD_MESH[0] * SHARD_MESH[1]
        env = {**os.environ, "WORLD_SIZE": str(n), "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port), "LOCAL_WORLD_SIZE": str(n),
               "OMP_NUM_THREADS": "1"}
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--sharded-rank",
             str(tmp)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            for r in bad:
                print(logs[r][-4000:] if r < len(logs) else "", flush=True)
            fail(f"sharded phase: ranks {bad} failed")
        res = json.loads((tmp / "result.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"sharded phase: backend {res['backend']}, world size "
        f"{res['world']}, mesh {res['mesh']} on one card ({res['device']}"
        f"); the port's collectives on this card's tensors over "
        f"{res['backend']} ({{name: right}}, as tools/gloo_cuda_probe.py "
        f"checks them): {res['collectives']}")
    if not all(res["collectives"].values()):
        fail(f"sharded phase: a collective gave a wrong result over "
             f"{res['backend']}: {res['collectives']}")
    for arch, tr in res["train"].items():
        cfg = get_arch(arch).config
        say(f"sharded train {arch} full width, {cfg.n_layers} layers, "
            f"{SHARD_TRAIN['steps']} steps of {SHARD_TRAIN['batch']} x "
            f"{SHARD_TRAIN['seq']} bf16 in {tr['seconds']:.1f} s (one rank "
            f"{t_ref[f'train {arch}']:.1f} s): losses {tr['losses']}, grad "
            f"norms {tr['norms']}; against one rank |dloss| "
            f"{tr['dloss']:.3e} (tol {SHARD_TOL['loss']}), |d grad norm| / "
            f"grad norm {tr['dgrad']:.3e} (tol {SHARD_TOL['grad_norm']}), "
            f"max |dparam| {tr['dparam']:.3e} (tol {SHARD_TOL['params']}); "
            f"launches a rank {tr['launches']}")
        if not (tr["dloss"] <= SHARD_TOL["loss"]
                and tr["dgrad"] <= SHARD_TOL["grad_norm"]
                and tr["dparam"] <= SHARD_TOL["params"]):
            fail(f"sharded train step of {arch} outside JAX's bf16 bounds")
        want = lm_train_launches(cfg)
        for key in SHARD_TRAIN_KERNELS:
            n_want = want[key] * SHARD_TRAIN["steps"]
            if tr["launches"][key] != n_want:
                fail(f"sharded train {arch}: kernel {key} launched "
                     f"{tr['launches'][key]} times, expected {n_want}")
        by_family[f"sharded {arch.split('-')[0]}"] = tr["launches"]
    for run, d in res["decode"].items():
        arch, dtype = run.split()
        n_tok = sum(len(r) for r in d["tokens"])
        n_diff = sum(a != b for r, q in zip(d["tokens"], d["ref_tokens"])
                     for a, b in zip(r, q))
        gated = (arch, dtype) not in SHARD_DECODE_UNGATED
        beside = (f"; the one-rank run's own spread with its rows decoded "
                  f"in the ranks' two halves {spread[run]:.3e}"
                  + ("" if gated else "; not held"))
        say(f"sharded decode {arch} full width, {SHARD_DECODE['batch']} x "
            f"{SHARD_DECODE['prompt']} + {SHARD_DECODE['gen']} {dtype} "
            f"(one rank {t_ref[f'decode {run}']:.1f} s), ring shard "
            f"{d['ring']}, fed the one-rank run's tokens: max "
            f"|dlogit| {d['dlogit']:.3e} (tol {SHARD_TOL['logits']}; by "
            f"step, the prefill's first: "
            f"{', '.join(f'{x:.3g}' for x in d['dlogit_steps'])}; |logit| "
            f"up to {d['logit_max']:.3g}{beside}); "
            f"greedy tokens sharded {d['tokens']} / one rank "
            f"{d['ref_tokens']} ({n_diff} of {n_tok} differ); launches "
            f"{d['launches']}")
        if gated and not d["dlogit"] <= SHARD_TOL["logits"]:
            fail(f"sharded decode {run}: logits off by {d['dlogit']}")
        for key in SHARD_DECODE_KERNELS[arch]:
            if d["launches"][key] <= 0:
                fail(f"sharded decode {run}: kernel {key} never launched")
    smollm = res["decode"]["smollm-135m bfloat16"]
    if smollm["ring"] is None:
        fail("sharded decode smollm-135m: its ring's capacity was not cut")
    launches["ring_shard_decode"] = smollm["launches"]["ring_shard_decode"]
    times = shard_sweep_row(torch, np, dev, da, ops, errs, card)
    times.update(shard_ssd_rows(torch, np, dev, ss, errs, card))
    say(f"sharded phase in {time.perf_counter() - t0:.1f} s (one-rank "
        f"references {sum(t_ref.values()):.1f} s, the ranks "
        f"{res['seconds']:.1f} s)")
    return times


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs "
             "the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch next to {pathlib.Path(__file__).name}: "
             "run it from a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import bridge
    from repro_torch import quant
    from repro_torch import serving
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import cnn, common
    from repro_torch.models import transformer as tfm
    from repro_torch import data, optim
    from repro_torch.launch import train
    from repro_torch.runtime import chaos, speculate, steps

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # 1. build -------------------------------------------------------------
    build.build(force=True)
    build.library()
    say(f"built {', '.join(p.name for p in build.sources())} in "
        f"{build.build_seconds:.1f} s")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"  ptxas: {line.strip()}")
    spilled = sweep_spills(build.build_log)
    if spilled:
        fail(f"the sweeps', K8's or K9's kernels spill: {spilled}")
    counts = hmma_counts(build)
    k4_forms(torch, fa, counts)
    k4_bwd_forms(torch, fa, counts, hmma_counts(build, "HGMMA"))
    ssd_forms(counts)
    sweep_forms(torch, da, counts)
    sweep_forms(torch, da, counts, "ring")
    mla_forms(torch, da, counts)

    # 2. kernels against their plain versions ---------------------------------
    errs = check_kernels(torch, np, dev, da, ops)
    check_ring_kernels(torch, np, dev, da, ops, errs)
    errs.update({name: 0.0 for name in KERNELS if "int8" in name})
    check_int8_kernels(torch, np, dev, da, ops, quant, errs)
    errs.update(flash_attention=0.0, rmsnorm=0.0)
    check_prefill_kernels(torch, np, dev, fa, rms, ops, common, errs)
    check_ssd_kernels(torch, np, dev, ss, ops, errs)
    check_mla_kernels(torch, np, dev, da, fa, rms, ops, common, errs)
    check_fused_merge(torch, np, dev, da, quant, errs)
    say(f"kernels ok: K4's largest bf16 |kernel - plain| over every case "
        f"{errs['flash_attention bf16']:.3e} (tol {TOL['bfloat16']})")
    for sweep in ("paged", "ring"):
        say(f"kernels ok: the {sweep} sweep's largest bf16 |kernel - plain| "
            f"over every case {errs[f'{sweep}_attention_sweep bfloat16']:.3e}"
            f" (tol {TOL['bfloat16']})")

    # 3. reference: kernels vs plain torch, full width, fp32 ------------------
    cfg = get_arch("smollm-135m").config
    reference_check(torch, dev, cfg, tfm, serving, steps, bridge)
    reference_batch_check(torch, np, dev, cfg, tfm, steps, speculate,
                          bridge)
    int8_reference(torch, np, dev, cfg, tfm, serving, steps, bridge)
    gcfg = get_arch("gemma2-27b").config
    gemma_reference(torch, np, dev, gcfg, tfm, serving, steps, bridge)
    torch.cuda.empty_cache()
    mcfg = get_arch("mamba2-370m").config
    mamba_reference(torch, np, dev, mcfg, tfm, serving, steps, bridge)
    torch.cuda.empty_cache()
    dcfg = get_arch("deepseek-v2-236b").config
    deepseek_reference(torch, np, dev, dcfg, tfm, serving, steps, bridge)
    # refuse_pages ties each engine to its page pool in a reference cycle:
    # collect it, or its 36 GB of fp32 weights outlive the phase
    gc.collect()
    torch.cuda.empty_cache()
    zoo_references(torch, np, dev, get_arch, tfm, serving, steps, bridge)

    # 4. the main paths -------------------------------------------------------
    poisson = ["--arch", "smollm-135m", "--traffic", "poisson",
               "--requests", "8", "--shared-prefix-len", "32",
               "--prompt-pools", "2", "--n-slots", "4", "--page-size", "16"]
    batch = ["--arch", "smollm-135m", "--traffic", "batch", "--requests",
             str(BATCH), "--prompt-len", str(PLEN), "--gen", str(GEN)]
    gemma = ["--arch", "gemma2-27b"]
    g_poisson = gemma + ["--traffic", "poisson", "--requests", "8",
                         "--n-slots", "4", "--page-size", "16"]
    g_batch = gemma + ["--traffic", "batch", "--requests", "4",
                       "--prompt-len", str(PLEN), "--gen", str(GEN)]
    g_long = gemma + ["--traffic", "batch", "--requests", "2",
                      "--prompt-len", str(G_LONG), "--gen", "17"]
    mamba = ["--arch", "mamba2-370m"]
    m_batch = mamba + ["--traffic", "batch", "--requests", str(BATCH),
                       "--prompt-len", str(PLEN), "--gen", str(GEN)]
    m_poisson = mamba + ["--traffic", "poisson", "--requests", "8",
                         "--n-slots", "4", "--page-size", "16"]
    m_long = mamba + ["--traffic", "batch", "--requests", "2",
                      "--prompt-len", str(M_LONG), "--gen", "17"]
    # deepseek-v2 at full width, cut to 8 layers (the published 60 do not
    # fit one card), served through serve(args, cfg)
    ds_cfg = dataclasses.replace(dcfg, n_layers=DS_LAYERS)
    ds = ["--arch", "deepseek-v2-236b"]
    d_batch = ds + ["--traffic", "batch", "--requests", "4",
                    "--prompt-len", str(PLEN), "--gen", str(GEN)]
    d_poisson = ds + ["--traffic", "poisson", "--requests", "8",
                      "--shared-prefix-len", "32", "--prompt-pools", "2",
                      "--n-slots", "4", "--page-size", "16"]
    # the zoo: h2o-danube-3 (head dim 120, every layer windowed, so its
    # engine runs private rings and no prefix cache), stablelm (G 1),
    # phi3.5-moe cut to 24 of its 32 layers, llava-next (G 7) at full depth
    h2o = ["--arch", "h2o-danube-3-4b"]
    h_batch = h2o + ["--traffic", "batch", "--requests", "4",
                     "--prompt-len", str(PLEN), "--gen", str(GEN)]
    h_poisson = h2o + ["--traffic", "poisson", "--requests", "8",
                       "--n-slots", "4", "--page-size", "16"]

    def zoo(arch, n_batch):
        return (["--arch", arch, "--traffic", "batch", "--requests",
                 str(n_batch), "--prompt-len", str(PLEN), "--gen", str(GEN)],
                ["--arch", arch, "--traffic", "poisson", "--requests", "8",
                 "--shared-prefix-len", "32", "--prompt-pools", "2",
                 "--n-slots", "4", "--page-size", "16"])

    s_batch, s_poisson = zoo("stablelm-1.6b", BATCH)
    # musicgen-medium (48 layers, 4 codebooks) and zamba2-1.2b (38 Mamba2
    # layers, 19 applications of its shared block) at full width and
    # depth; the prefix cache serves neither, so no shared heads
    mg, zb = ["--arch", "musicgen-medium"], ["--arch", "zamba2-1.2b"]
    batch_of = ["--traffic", "batch", "--requests", str(BATCH),
                "--prompt-len", str(PLEN), "--gen", str(GEN)]
    poisson_of = ["--traffic", "poisson", "--requests", "8", "--n-slots",
                  "4", "--page-size", "16"]
    p_batch, p_poisson = zoo("phi3.5-moe-42b-a6.6b", 4)
    l_batch, l_poisson = zoo("llava-next-34b", 4)
    phi_cfg = dataclasses.replace(get_arch("phi3.5-moe-42b-a6.6b").config,
                                  n_layers=PHI_LAYERS)
    cuts = {"deepseek": ds_cfg, "phi3.5": phi_cfg}
    int8 = ["--kv-dtype", "int8"]
    attn = ("flash_attention", "rmsnorm")
    ssm = ("ssd", "rmsnorm")
    paged = ("sweep_decode", "sweep_verify", "merge_fused") + attn
    # (label, argv, kernels the path must launch, requests, new tokens,
    # config cut in depth or None for the registry's)
    paths = [("poisson", poisson, paged, 8, None),
             ("batch", batch, ("ring_decode", "merge_fused") + attn, BATCH,
              GEN),
             ("batch --spec-k 3", batch + ["--spec-k", "3"],
              ("ring_verify", "merge_fused") + attn, BATCH, GEN),
             ("poisson --spec-k 3", poisson + ["--spec-k", "3"],
              ("sweep_verify", "merge_fused") + attn, 8, None),
             ("poisson int8", poisson + int8,
              ("sweep_decode_int8", "sweep_verify_int8", "merge_fused")
              + attn, 8, None),
             ("poisson int8 --spec-k 3", poisson + int8 + ["--spec-k", "3"],
              ("sweep_verify_int8", "merge_fused") + attn, 8, None),
             ("poisson int8 host tier", poisson + int8 + [
                 "--host-tier", "--n-pages", str(TIER_PAGES)],
              ("sweep_decode_int8", "sweep_verify_int8") + attn, 8, None),
             ("gemma2 batch", g_batch, ("ring_decode", "merge_fused") + attn,
              4, GEN),
             ("gemma2 poisson", g_poisson,
              ("sweep_decode", "ring_decode") + attn, 8, None),
             ("gemma2 long batch", g_long,
              ("ring_decode", "merge_fused") + attn, 2, 17),
             ("mamba2 batch", m_batch, ssm, BATCH, GEN),
             ("mamba2 poisson", m_poisson, ssm, 8, None),
             ("mamba2 long batch", m_long, ssm, 2, 17),
             ("deepseek batch", d_batch, attn, 4, GEN),
             ("deepseek poisson", d_poisson,
              ("mla_decode", "mla_verify", "merge_fused") + attn, 8, None),
             ("h2o batch", h_batch, ("ring_decode",) + attn, 4, GEN),
             ("h2o batch --spec-k 3", h_batch + ["--spec-k", "3"],
              ("ring_verify",) + attn, 4, GEN),
             ("h2o poisson", h_poisson, ("ring_decode",) + attn, 8, None),
             ("stablelm batch", s_batch, ("ring_decode",) + attn, BATCH,
              GEN),
             ("stablelm poisson", s_poisson, paged, 8, None),
             ("phi3.5 batch", p_batch, ("ring_decode",) + attn, 4, GEN),
             ("phi3.5 poisson", p_poisson, paged, 8, None),
             ("llava batch", l_batch, ("ring_decode",) + attn, 4, GEN),
             ("llava poisson", l_poisson, paged, 8, None),
             ("musicgen batch", mg + batch_of, ("ring_decode",) + attn,
              BATCH, GEN),
             ("musicgen poisson", mg + poisson_of, ("sweep_decode",) + attn,
              8, None),
             ("zamba2 batch", zb + batch_of, ("ssd", "ring_decode") + attn,
              BATCH, GEN),
             ("zamba2 poisson", zb + poisson_of, ("ssd", "ring_decode")
              + attn, 8, None)]
    paths = [p + (cuts.get(p[0].split()[0]),) for p in paths]
    launches = {key: 0 for key in da.LAUNCHES}
    # launches by model family (a label's first word), for the rows of a
    # form only some families run (head dim 120: h2o-danube-3; G 7: llava;
    # K4's (64, 64): smollm's paths and stablelm's)
    by_family = {}
    for label, argv, keys, n_req, gen, cut in paths:
        torch.cuda.reset_peak_memory_stats()
        out, counts = serve_run(torch, da, tfm, serve, label, argv, cut)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.empty_cache()
        if peak > CARD_GIB:
            fail(f"{label}: peak {peak:.1f} GiB exceeds the card's "
                 f"{CARD_GIB} GiB")
        for key in keys:
            if counts[key] <= 0:
                fail(f"{label}: kernel {key} was never launched")
        if counts["merge"]:
            fail(f"{label}: the standalone merge was launched "
                 f"{counts['merge']} times (the split sweeps merge their "
                 "own splits)")
        fam = by_family.setdefault(label.split()[0],
                                   {key: 0 for key in da.LAUNCHES})
        for key, n in counts.items():
            launches[key] += n
            fam[key] += n
        if "poisson" in label:
            rep = out
            if len(rep.results) != n_req:
                fail(f"{label}: {len(rep.results)} results, expected "
                     f"{n_req}")
            for r in rep.results:
                if r.n_tokens != r.max_new_tokens:
                    fail(f"{label}: rid {r.rid} finished {r.n_tokens}/"
                         f"{r.max_new_tokens} tokens ({r.finish_reason})")
            if not label.startswith(("gemma2", "mamba2", "h2o",
                                     "musicgen", "zamba2")) \
                    and rep.prefill_tokens_saved <= 0:
                fail(f"{label}: no prefix-cache hit, the suffix prefill "
                     "never ran")
            if "spec" in label and rep.drafts_proposed <= 0:
                fail(f"{label}: no draft was proposed")
            extra = (f", acceptance {rep.acceptance_rate:.0%}"
                     if "spec" in label else "")
            if "int8" in label and (counts["sweep_decode"]
                                    or counts["sweep_verify"]):
                fail(f"{label}: an int8 path launched the bf16 sweep")
            if "host tier" in label:
                moved = rep.n_demotions + rep.n_promotions
                if rep.n_demotions <= 0 or rep.n_promotions <= 0 \
                        or rep.transfer_j <= 0.0:
                    fail(f"{label}: {rep.n_demotions} page-outs, "
                         f"{rep.n_promotions} page-ins, transfer_j "
                         f"{rep.transfer_j}")
                page_bytes = rep.transfer_j / 1e-9 / moved
                if abs(page_bytes - TIER_PAGE_BYTES) > 1e-6 * TIER_PAGE_BYTES:
                    fail(f"{label}: {page_bytes:.1f} bytes a page moved, "
                         f"expected {TIER_PAGE_BYTES}")
                extra += (f", {rep.n_demotions} pages out / "
                          f"{rep.n_promotions} in of {page_bytes:.0f} B, "
                          f"transfer {rep.transfer_j:.4g} J, "
                          f"{rep.n_preemptions} preemptions")
            say(f"main path {label} on {card}: {rep.tok_per_s:.1f} tok/s "
                f"measured, {rep.j_per_token:.4g} J/token (analytic H100 "
                f"SXM model){extra}, peak {peak:.1f} GiB, launches {counts}")
        else:
            want = (n_req, gen) + ((4,) if label.startswith("musicgen")
                                   else ())
            if out["tokens"].shape != want:
                fail(f"{label}: generated {out['tokens'].shape}, expected "
                     f"{want}")
            if "spec" in label and out["spec_steps"] <= 0:
                fail(f"{label}: no speculative step ran")
            extra = (f", acceptance {out['acceptance']:.0%}"
                     if "spec" in label else "")
            say(f"main path {label} on {card}: {out['tok_per_s']:.1f} tok/s "
                f"measured, {out['j_per_token']:.4g} J/token (analytic H100 "
                f"SXM model){extra}, prefill {out['prefill_s'] * 1e3:.0f} "
                f"ms, peak {peak:.1f} GiB, launches {counts}")

    # 5. timing ---------------------------------------------------------------
    times = paged_timings(torch, np, dev, da, ops, quant)
    times.update(timings(torch, np, dev, da, ops))
    times.update(ring_rows(torch, np, dev, da, ops, quant))
    times.update(shared_buffer_timings(torch, np, dev, da))
    times.update(prefill_timings(torch, np, dev, fa, rms, ops, common))
    times.update(ssd_timings(torch, np, dev, ss))
    times.update(mla_timings(torch, np, dev, da, ops))
    for name, r in merge_pairs(torch, np, dev, da, ops, quant).items():
        say(f"{name} (n_splits {r['n_splits']}): stage 1 "
            f"{r['stage1_ms'] * 1e3:.2f} us; unfused pair (+ lse_merge, + "
            f"the reshape's copy where Q > 1) {r['pair_ms'] * 1e3:.2f} us; "
            f"one fused launch {r['call_ms'] * 1e3:.2f} us on {card}")
    step = int8_step_cost(torch, np, dev, cfg, tfm, steps, bridge)
    say(f"paged decode step, smollm-135m full width, 4 slots, host clock "
        f"(median of chunks of 8 in turns): bf16 pools "
        f"{step['bfloat16']:.2f} ms, int8 pools {step['int8']:.2f} ms "
        f"(+{step['int8'] - step['bfloat16']:.2f} ms) on {card}")

    # 6. chaos drills ---------------------------------------------------------
    t_chaos = time.perf_counter()
    chaos_drills(torch, dev, da, serving, chaos, serve, tfm, bridge, cfg, card)
    say(f"chaos drills in {time.perf_counter() - t_chaos:.1f} s")

    # 7. training -------------------------------------------------------------
    t_train = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    bwd = check_rms_backward(torch, np, dev, rms, common, errs)
    say(f"K9 backward ok: largest relative errors {bwd}")
    bwd = check_fa_backward(torch, np, dev, fa, ops, errs)
    say(f"K4 backward ok: largest relative errors {bwd}")
    bwd = check_ssd_backward(torch, np, dev, ss, errs)
    say(f"K8 backward ok: largest relative errors {bwd}")
    train_reference(torch, np, dev, cfg, da, steps, common, optim, data)
    zoo_train_references(torch, np, dev, da, steps, common, optim, data,
                         get_arch)
    counts = train_main_path(torch, da, train, cfg, card)
    for key in ("flash_attention_bwd", "rmsnorm_bwd"):
        launches[key] = counts[key]
    gc.collect()
    torch.cuda.empty_cache()
    counts = train_main_path(torch, da, train, mcfg, card, MAMBA_TRAIN_ARGV)
    launches["ssd_bwd"] = counts["ssd_bwd"]
    for arch in ("musicgen-medium", "zamba2-1.2b"):
        gc.collect()
        torch.cuda.empty_cache()
        by_family[f"train {arch.split('-')[0]}"] = train_main_path(
            torch, da, train, get_arch(arch).config, card,
            zoo_train_argv(arch))
    times.update(backward_timings(torch, np, dev, fa, rms))
    times.update(ssd_backward_timings(torch, np, dev, ss))
    times.update(zoo_backward_timings(torch, np, dev, rms, ss))
    say(f"training phase in {time.perf_counter() - t_train:.1f} s")

    # 8. the CNN zoo ----------------------------------------------------------
    t_cnn = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cnn_zoo(torch, np, dev, bridge, cnn, common, optim, data, card)
    say(f"CNN zoo phase in {time.perf_counter() - t_cnn:.1f} s")

    # 9. examples and dry-run ------------------------------------------------
    t_ex = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    examples_phase(torch, np, dev, da, ops, errs, card, launches, by_family)
    say(f"examples and dry-run phase in {time.perf_counter() - t_ex:.1f} s")

    # 10. sharded execution --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    times.update(sharded_phase(torch, np, dev, da, ops, errs, card,
                               launches, by_family))
    kernels = []
    for name, t in times.items():
        source, replaces, key = KERNELS[t.get("entry") or name]
        fams = t.get("family") or ()
        fams = (fams,) if isinstance(fams, str) else fams
        n_launch = (sum(by_family.get(f, {}).get(key, 0) for f in fams)
                    if fams else launches[key])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": errs[t.get("err", name)],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
        lib = "n/a" if t["library_ms"] is None else \
            f"{t['library_ms'] * 1e3:.1f} us"
        say(f"{name} ({t.get('shape') or 'n_splits %d' % t['n_splits']}): "
            f"kernel "
            f"{t['ms'] * 1e3:.1f} us{stage1_note(t)}, plain "
            f"{t['plain_ms'] * 1e3:.1f} us, "
            f"library {lib}, bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}) on {card}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(sys.argv[2]))
    sys.exit(main())
