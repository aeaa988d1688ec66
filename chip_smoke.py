#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (valle2_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

Phases, each printing JSON lines:

1. device    -- the card, and ``nvidia-smi``'s name and power limit.
2. build     -- compile every kernel from ``valle2_tpu_torch/csrc`` (one nvcc
                per build, all started together; the persistent #6 is built
                once per weight format).
3. kernels   -- the serving kernels (flash forward #1, fused decode step #6)
                against their plain PyTorch versions at the TTS slice's
                shapes (#6 at 12 rows with the cache the prefill gives them:
                ``serving_len``, which chunks a bf16 cache at 640 slots), in
                float32 with TF32 off and in bfloat16, with CUDA-event times
                of both (median of 30) and, for #1 in bf16, of its CUDA-core
                route.
4. greedy    -- the full-width AR model, float32 and TF32 off: greedy token
                IDs of 32 steps through both kernels equal the IDs through the
                plain versions.
5. main      -- the serving path: a seeded ValleTTS at the benchmarked config
                (bench.py: bfloat16, max_audio_len=512, ignore_eos, 4 beams)
                answers batch_synthesize for 3 requests, then one
                synthesize_fused.  Launch counts are zeroed just before and read
                just after; every waveform must be finite and gen_len*320 long.
6. kernels   -- the training kernels: flash forward #1 (causal and
   (train)      bidirectional) and backward #3 at the AR/NAR bench shape
                (b=32, h=4, s=640), #4 + #5 at b=8, s=1280, against their
                plain versions in float32 (TF32 off) and bfloat16, with
                CUDA-event times, the time of PyTorch's
                scaled_dot_product_attention on the same inputs and mask as a
                yardstick (the port never calls it), and each kernel's bound
                and its share of it (f32: of the FFMA bound, 67 TFLOP/s).
7. grads     -- full width, float32, TF32 off, a synthetic batch of 4: AR and
                NAR (stage 3) loss and every parameter's grad through the
                kernels equal those through the plain bias route.
8. train     -- the training path: the bench configs (bench.py:248-332, AR
                then NAR, b=32 x 512 frames, bfloat16, dropout 0.1) through
                make_train_step, 2 warm-up steps then 10 timed ones, then 3 AR
                steps at b=8 x 1024 frames (s=1280).  Counts zeroed before,
                read after: #1, #3, #4 and #5 must all have launched.
9. fit       -- Trainer.fit on the synthetic loader at full width (AR, 20
                steps, checkpoints every 10), then a resumed fit to 25.
10. profile  -- torch.profiler over 3 bench train steps (AR, then NAR):
                device time by kernel group and the top kernels.
11. kernels  -- RVQ encode #8 against its plain version (float32, TF32 off)
   (codec)      at a 2 s prompt (B=1, T=150), a dataset batch of 4 s (B=16,
                T=300) and a ragged case (B=3, T=77, n_q=4): codes equal but
                for ties within f32 rounding (the plain stages replayed on the
                kernel's codes: every kernel code scores within 1e-5 *
                max(1, |best|) of the plain best), with the count of such ties
                and the worst gap, CUDA-event times and the bound.
12. codec    -- a seeded full-geometry Encodec: batch_encode of 3 waveforms
                of 3 s through the kernel against the plain RVQ on the same
                latents under the tie rule; get_embedding finite.
13. clone    -- the slice's main path at the serving config of phase 5: 3
                requests through ValleTTS.__call__(text, 3 s prompt at 16 kHz,
                its transcript) (resample, encode, staged synthesize), then
                batch_synthesize on the three prepared prompts.  Counts zeroed
                before, read after: #1, #6 and #8 must have launched; every
                waveform finite and len(codes)*320 long.
14. asr      -- ValleASRPipeline at the same widths (direction 'asr',
                max_audio_len=256, float32, greedy): batch_transcribe of 3
                utterances of 3 s at 24 kHz equals each solo transcription;
                #1, #6 and #8 must have launched.
15. data     -- ValleDataset over 32 seeded in-memory items (1-4 s at 16 /
                22.05 / 24 kHz): precompute_codes(batch_size=16) into a disk
                cache launches #8; a second dataset on the same items loads
                the cache with 0 launches and identical codes; then 3 AR train
                steps on a DataLoader over it.
16. kernels  -- every quantized variant of the fused decode step (#6a: int8
   (quant)      W8A8, int4 W4A16, int8 KV cache, and both weight formats with
                the int8 cache) against its plain version on the same codes
                at the serving shape (L=8, rows=12, S=897, index ttm+pm+100),
                in f32 with TF32 off and in bf16: y within the variant's
                tolerance (TOL_QUANT), the W8A8 flip candidates, the int8
                cache codes as integers, CUDA-event times (median of 30), the
                plain version's time and the bound.
17. quant    -- quantized serving: batch_synthesize of phase 5's 3 requests
                under each #6a configuration (weight_dtype int8 / int4 and
                kv_cache_dtype int8, alone and combined) and the dense one, at
                the serving config of phase 5.  Counts zeroed before, read
                after each: #1 and that configuration's #6a variant (and no
                other) must have launched; waveforms finite and gen_len*320
                long; stage times, decode ms/step, RTF and peak memory.

18. kernels  -- the speculative verify step (#7) in all six variants (dense,
   (spec)       and the five of phase 16) against its plain version at the
                serving cell (L=8, 3 rows x K=4 tokens, S=901, per-row start
                slots ttm+pm+{100, 137, 203}), f32 with TF32 off and bf16:
                y within the variant's tolerance, the cache as in phase 16,
                CUDA-event times (median of 30) of #7 (one persistent launch)
                and of its phased twin (fused_verify_step_phased, one kernel
                per phase), the plain version's time and the bound; no one
                PyTorch call computes the step.
19. spec     -- n-gram speculative decode: phase 5's 3 requests through
                batch_synthesize with one beam (bf16, max_audio_len=512,
                ignore_eos), the plain loop (#6) and speculative_k=4,
                speculative_ngram=3 (#7) on the same weights (plain, then
                spec), then spec under each quantized configuration of
                phase 17 (PROFILE_STEPS = 64 frames), and each loop's decode
                profile (PROFILE_STEPS).  Counts zeroed
                before, read after
                each: #1 and the run's step kernel must have launched, no
                other step kernel.  Turns, mean accepted tokens per turn, ms
                per turn, decode ms per token, RTF and peak memory.  Then the
                full-width greedy check in f32, TF32 off: spec IDs through #7
                == plain-loop IDs through #6 == spec IDs through the plain
                route (use_fused_decode=False).
20. large    -- the 204M geometry (GRAMMAR_V3_TPU_204M.json: d 1024, 16
                heads, dff 4096, 16 layers), dense and weight_dtype='int8':
                one utterance of 128 steps in bf16 through the plain loop and
                the speculative loop (#6 / #7 must launch; the 4096-wide FFN2
                input takes the 8-row projection tile), then greedy IDs in
                f32, TF32 off: kernels == the plain route, plain loop and
                speculative loop (W8A8: equal, or parted only at a near-tie,
                GREEDY_W8A8_GAP).

21. kernels  -- the chunked branch of #6 and #7 (the split over the cache and
   (chunked)    its merge) against its plain version (the online softmax over
                the chunks) and the whole-S kernel on the same inputs, f32
                (TF32 off) and bf16: #6 at one row, S=1536 (the stream's),
                chunk 512, mid-stream; #7 at 3 rows x K=4, S=1024, chunk 512,
                one block straddling slot 512.  Times of all three, the bound.
22. stream   -- streaming at the serving model's default max_audio_len (1024,
                bf16): one request through synthesize_streaming (chunk_frames
                75, lookahead 38, ignore_eos); the streaming model forces
                chunk 512; counts zeroed before, read after: #6 and its
                chunked branch on every step, no plain version.  Time to
                first audio, chunk walls, decode ms per step beside one-beam
                decodes whole-S and chunked (their profiles at 256 steps),
                RTF.  Then in f32 (TF32 off,
                greedy): streamed tokens == one advance == the plain route;
                full lookahead == synthesize_fused; at max_audio_len 256,
                synthesize_longform over three sentences, carry 'prompt' ==
                each sentence streamed, carry 'chain' == prompt mode in its
                first sentence.
23. kernels  -- #6 (at 4 rows, chunked 512 of 1024, and at one row, whole)
   (large)      and #7 (1 row x K=4) at the 204M widths in bf16 against their
                plain versions, with times and the bound.
24. kernels  -- #6 with a per-row index (continuous batching) against its plain
   (per-row)    version, every weight x cache variant, whole-S and chunked
                (chunk 128), f32 (TF32 off) and bf16: 8 rows at their own
                depths (the first generated slot, both sides of a chunk
                boundary, S - 1, and one row frozen at S, whose cache row must
                not change), S=512.  CUDA-event times beside the scalar-index
                #6 on the same inputs, the plain version and the bound.
25. cb       -- continuous batching at the serving model with one beam (bf16,
                max_audio_len 512, ignore_eos; hub geometry ttm = pm = 128,
                advance chunk 25): N = 4 and 8 sessions as round-robin solo
                DecodeStreams against one ContinuousDecoder (solo, joint),
                aggregate tokens/s and ms per joint step; greedy ids joint ==
                solo or parted only at a near-tie (GREEDY_BF16_GAP); sampled at
                N = 4; one W8A8 + int8-cache run.  Counts per arm: every joint
                step launched the per-row #6, no plain call.  Then in f32
                (TF32 off, 256 steps): 6 sessions on 4 rows with staggered
                joins and reused rows == their solo decodes, greedy and
                sampled (per-row CUDA generators) bit for bit; the
                speculative joint loop (K = 4, #7) == the plain joint loop.
26. hub      -- StreamHub(n_slots=4, chunk_frames=25) at the serving model
                (bf16, one beam, max_audio_len 512, decode_chunk 256): 4
                sessions from 4 threads at once, then 2 of them through solo
                synthesize_streaming in turn; time to first audio, chunk
                walls, aggregate RTF; counts: the per-row #6's chunked branch
                on every joint step, no plain call, no driver failure.  Then
                in f32 (max_audio_len 256, decode_chunk 128): hub tokens ==
                solo streams', waveforms within f32 tolerance, open_longform
                == synthesize_longform(carry='prompt'), stop(drain=True).
27. kernels  -- the head-folded flash forward #2 (a persistent grid over
   (fold)       (batch row, q-tile, group of heads) items; bf16 on wgmma fed by
                TMA) against its plain version, bit for bit against #1 on the
                same inputs and against itself on a second call, f32 (TF32
                off) and bf16, with its design and item schedule
                (FOLD_DESIGN, fold_plan), at the serving prefill (b=3, h=4, s=385), the
                serving-width train shapes (b=32, h=4, s=640, causal and
                bidirectional) and the 204M train shape (b=16, h=16, s=640),
                ragged meta with one row of tokens_valid 0: times of #2, #1,
                SDPA on the same inputs and mask, the plain version; the bound
                and #2's share of it.
28. fold     -- the fold's path, VALLE2_FLASH_FOLD=1 against =0 in one call
                (the variable restored after): phase main's batch_synthesize
                greedy (temperature 0), in bf16 and in f32 with TF32 off, AR
                ids equal with the fold on and off (#2 is bit-equal to #1);
                the 204M AR and NAR train steps (bench.py:441/457: b=16 x 512
                frames, NAR falling back to b=8 only if 16 does not fit) in arm
                runs off, then fold (step ms, frames/s, MFU against 989
                TFLOP/s, peak GB, finite losses, the AR's descending) and the
                serving-width AR at b=8 x 1024 (s=1280: #4 + #5); then f32
                grads with and without the fold at the 204M widths cut to
                FOLD_GRAD_LAYERS layers.  Counts zeroed before each arm: the
                fold arm launched #2 and no #1 forward, the off arm the
                reverse; the fold arms' launches are the path 'fold'.
29. gemm     -- the GEMM roofline probe (valle2_tpu_torch.probes.gemm_roofline,
                kernels #9 and #10 beside torch.matmul) at its three shapes
                (4096^3 and the 204M step's 10240 x 1024 x 4096 and x 1024),
                counts zeroed before and read after (the path 'gemm'); then #9
                and #10 held against matmul_plain (one bf16 ulp of the result
                plus the f32 summation-order error), with the plain version's
                time, the bound, each arm's share of the bf16 peak, and its
                back-to-back time (20 calls in a row, the device's pace).
30. kernels  -- tensor parallelism with virtual ranks on one card (mp 2 and 4):
   (tp)         the TP all-reduce 5c alone (beside torch.add of two partials,
                its library call at mp 2), and the persistent TP fused decode
                step (#6, one cooperative launch holding every rank, 5c's
                element in its two reduce phases a layer) and verify step (#7)
                bit for bit against their phased twin
                (fused_step_tp_phased: a kernel per phase on each rank's own
                stream, 5c between the layers) and within tolerance of their
                plain versions on the same inputs (each rank's local heads,
                the rank-ordered f32 sum), f32 (TF32 off) and bf16: the
                serving shape (12 rows, S 1280, index 485), its chunked cache
                (chunk 256), the per-row index with the int8 cache (8 rows, S
                512), int4 W4A16 (the ranked packing) and #7 at 3 rows x K=4
                (S 1024).  Every rank's y and cache bit-equal to the twin's;
                times (median of 30) of both and of the plain version, their
                host enqueue, the bound (bytes: every rank's weights and
                cache, and 5c's reads of mp partials and its writes), the
                launcher's grid against tp_persistent_plan, and the phase
                trace (step_phases) of the serving, verify and chunked cases.
31. tp       -- phase_tp(devices): the serving batch_synthesize of phase 5's
                requests (f32, TF32 off, 128 steps) on a ('model',) mesh of
                the devices (here ['cuda:0'] * 2) and on the solo model: codes
                equal; then a speculative ValleAR (K=4) on the mesh against
                solo.  Counts zeroed before the mesh runs, read after: the TP
                steps and 5c launched, one TP step launch per token step of
                the decode loops and no 5c launch inside them
                (decode_loop_counts), no plain fused call, no phased TP step,
                no one-rank step.  Wall, decode ms per step and RTF of mesh
                and solo.  ``phase_tp_large(devices)`` (the four-card call
                only): the 204M stack at mp 4, one generate_batch at 4
                beams, greedy ids mesh == solo; ``phase_tp_cards(devices)``
                (the four-card call only): the persistent TP step over the
                cards bit for bit against its twin and the virtual ranks,
                timed, with each card's phase trace.
32. kernels  -- the persistent #6 and #7 (one cooperative launch a step each)
   (persistent) against the phased twin on the same inputs
                (fused_verify_step_phased; for #6 a block of one token at the
                same start slots): y and the whole cache bit for bit in every
                case of PERSISTENT_CASES (#6: every weight x cache variant at
                the serving shape, 4 rows whole-S, the per-row index whole
                and chunked; one row at the stream's S; the 204M widths at
                one row and at 4 rows chunked) and PERSISTENT_VERIFY (#7: the
                spec cell, 3 rows x K=4, S 901, in every variant; its chunked
                run, S 1024, chunk 512; the 204M block, 1 x 4, S 900, dense
                and W8A8), f32 (TF32 off) and bf16; times of both (median of
                30), their host enqueue, the bound, the launcher's grid
                against the host plan (persistent_plan, with K and the int8
                cache's extra phase), and the phase trace (step_phases: each
                phase's slowest block and barrier, from %globaltimer).
33. kernels  -- #1's tensor-core route (bf16) at head dims 32, 64 and 128
   (flash tc)   (FLASH_TC_CASES: s=385, causal and bidirectional, a row with
                tokens_valid 0) against its plain version and #2 bit for
                bit; times of the tensor-core route, the CUDA-core route
                (flash_attention_cuda_cores: the f32 route's body with bf16
                operands), SDPA and the plain version.  Phases 3 and 6 time
                the CUDA-core route beside #1 at the serving prefill and the
                training shapes too.
34. step     -- phase_step_profile: torch.profiler over the token loop of
   profile      each single-card path (PROFILE_STEPS and PROFILE_PATHS'
                steps; main, quant W8A8 + int8 cache and
                W4A16, stream, cb, clone, hub, large) and the speculative
                loops through #7 (spec, large_spec, cb_spec), and the TP
                step on one card (tp: two virtual ranks, one launch of both a
                step, no 5c kernel past the prefill's): device kernels of the
                fused step per launch of #6, #7 or the TP step (1), its device
                ms, span and gaps a step, the device's busy share.  A phased step
                kernel, or more step kernels than launches, fails at once;
                fewer means lost profiler records, and the path is profiled
                again (up to PROFILE_REPEATS times) until one profile shows
                one a launch.
35. server   -- phase_server: the serving layer (valle2_tpu_torch/serve.py)
                through ``serve_http(block=False)`` on 127.0.0.1, port 0, at
                the serving width (SERVER): (a) f32, TF32 off, 4 beams,
                greedy: 8 requests from 8 client threads over HTTP and the
                same 8 through ``submit``, every response's PCM16 (within one
                step) and every result's codes against its solo
                synthesize_fused, or parted at a near-tie (GREEDY_F32_GAP);
                (b) bf16, 16 requests from 16 threads, max_batch 8,
                max_wait_ms 10: requests/s, audio s/s, RTF, p50 / p95 latency
                and mean batch size from /stats, busy seconds and the worker
                thread's CPU seconds a batch; /metrics parses; (c) /stream
                through the hub (cb_streams 4, one beam) from 4 threads: time
                to first audio, per-row #6 launches; (d) one /transcribe of 3
                s (#8, #6); (e) a LoRA voice (rank 8, seeded nonzero B)
                through save_adapters and load_voice, in a mixed f32 batch:
                each row against its own weights' solo run; (f) 3 LoRA
                fine-tune steps (rank 8, b=8 x 640, bf16) through the flash
                forward and backward kernels, the base bit-equal after and
                every adapter B moved.  Counts zeroed before each served run
                and read after it (no plain call): (a)-(e) are the path
                'server', (f) the path 'lora'.
36. checkpoint -- phase_checkpoint, weights in and cold start at the serving
                width of phase 5 (CKPT): (a) seeded AR and NAR params through
                models.convert.save_torch_checkpoint (the Lightning layout
                with the 'model.' prefix) and load_torch_checkpoint into a
                fresh ValleTTS on the card, params bit-equal, 3 greedy
                requests (f32, TF32 off, 128 frames) with the in-memory
                model's codes through #1 and #6, no plain call; (b) a 3 s 48
                kHz stereo WAV and its left channel (native.audio.wav_write)
                read by native.audio.load_audio at 24 kHz against
                utils.load_audio within AUDIO_ATOL away from the edges, then
                prepare_prompt through #8; (c) profiling.trace around one
                synthesize (bf16, one beam, 64 frames): trace.json's device
                records name #1 and #6, the stages' annotate ranges are in it,
                its records of the port's kernels beside the launches
                counted, memory_stats 0 < peak <= limit; (d) the train CLI
                (train.main) for 2 synthetic AR steps at batch 8 with
                --profile and --debug-nans: the trace written, #1 and #3
                launched; (e) coldstart_bench compile and warmup, each a
                fresh process over the build directory phase 2 filled: 0
                builds, >= 1 library loaded from disk, seconds to the first
                request.  (a)-(d) are the path 'checkpoint'.
37. grammar  -- phase_grammar, the rest of training and the grammar tools
                (GRAMMAR): (a) remat at the 204M grammar widths (d 1024, 16
                heads, dff 4096, 16 layers; bf16, dropout 0.1): one AR loss
                and its grads with remat off, on, and off again at b=16 x
                (128 + 512) and b=8 x (256 + 1024), after a warm-up: the
                loss bit-equal, the grads bit-equal where the plain step
                repeats bit for bit (else within REMAT_GRAD_RTOL), #1 (or
                #2) launched twice a layer with remat and once without, #3
                (or #4 and #5) once a layer either way; step ms and peak
                memory of each; at s=640 a negative control, the recompute
                replaying dropout from the caller's generator (its state
                after the whole forward) in place of the layer's start
                state: its grads must part by more than REMAT_GRAD_RTOL;
                (b) the reference-width grammar
                (grammar://speakers=4,pairs=64, d 256, 8 layers, bf16): AR,
                NAR and ASR trained one epoch (37 steps) each through
                train_grammar_model, their run dir written, then
                grammar_production.evaluate's v1 and v3 suites on 4 held-out
                sentences (best-of-N at 1 and 4 beams among them), every
                ValleAR.generate_batch through #1 and a fused step with no
                plain call (checked_decodes), and the greedy evaluations
                equal on a second run; (c) tools.quant_quality over (b)'s
                run dir (a bf16 model; its float32-cache cells over an f32
                cache), --limit 4: all 18 cells score, each fused cell
                launched its own #6 / #6a variant and each unfused cell
                none, and the reference cell's (compute, f32 cache) greedy
                codes == the in-memory model's.  (a)-(c) are the path
                'grammar'.
38. mesh     -- phase_mesh, the data axis on one card (virtual ranks
                ['cuda:0'] * n, the serving width, f32 with TF32 off): (a)
                the AR and the NAR loss, every leaf's grad and the params
                after one AdamW step at data=2 and at 2 x 2 with zero1 and
                sequence_parallel (b=4 x (64 + 256), dropout 0.1) against the
                solo step (MESH_GRAD_RTOL, MESH_PARAM_LR); (b) greedy
                batch_synthesize of 4 requests (64 frames) at data=2 and 2 x
                2, codes equal to solo row for row; (c) a 2-step
                Trainer.fit from a config with mesh_data=2.  Counts zeroed
                after the solo references, read after (c): #1 or #2, #3 or
                #4 + #5, 5c, #6 and the TP step launched, no plain fused
                call (the path 'mesh').  Then the negative control (a
                ZeRO-1 gather that skips a data block must leave the params
                beyond MESH_PARAM_LR), the flash kernels at (a)'s 2 x 2
                shard shape and 5c under autograd against their plain
                versions, and the bf16 step ms and the
                card's peak memory of data=2 (zero1 off and on) against
                solo at b=16 x (128 + 512).  ``phase_mesh_cards`` (the
                four-card call only): the 204M AR step (b=16 x 640, bf16)
                solo, at data=4 (zero1 off and on), 2 x 2 and model=4 over
                the cards: ms a step and each card's peak memory.
39. pipe     -- phase_pipe, pipeline parallelism on one card (virtual
                ranks ['cuda:0'] * n): (a) at the serving width, f32 with
                TF32 off, b=8 x (64 + 256), the AR and the NAR loss, every
                leaf's grad and the params after one AdamW step at pipe 4
                GPipe M=4, pipe 4 1F1B M=8 and data 2 x pipe 2 x model 2
                with zero1 against the solo step at dropout 0
                (MESH_GRAD_RTOL, MESH_PARAM_LR), and at dropout 0.1 (the
                pipeline's draw rule) 1F1B against GPipe; (b) a 2-step
                Trainer.fit at examples/train_ar_pp.json's mesh (data 2 x
                pipe 4) at batch 8.  Counts zeroed after the solo
                references, read after (b): 5c launched, no plain fused
                call (the path 'pipe').  Then the negative control (a grad
                completion that drops stage 0's embedding grads must fail
                MESH_GRAD_RTOL), 5c under autograd at a stage's shape
                against its plain version, and (c) the 204M AR step (bf16,
                b=16 x (128 + 512), pipe 4) with GPipe and 1F1B at M=8 and
                16: ms a step and the card's peak memory, 1F1B's peak at
                M=16 below GPipe's.  ``phase_pipe_cards`` (the four-card
                call only): the same 204M step solo and at pipe 4 and pipe
                2 x model 2 over the cards, GPipe and 1F1B at M=8: ms a
                step, each card's peak memory and busy share.
Phase 19 adds a speculative run with decode_chunk 512 (every verify pass
chunked); phase 20 adds the 204M stack at its default 4 beams through
batch_synthesize, where chunk_for picks 512 of S=1024 on its own (every
step chunked), and its greedy IDs in f32 (64 steps) kernels == plain route.

``python3 chip_smoke.py --mesh-cards 4`` on a four-card host runs phases 1,
2, ``phase_tp_cards`` and 31 over the four cards, ``phase_tp_large``,
``phase_mesh_cards`` and ``phase_pipe_cards`` (after checking peer access
between every pair of cards); with no argument it needs one card.
``main`` runs them in this order: 1-3, 16, 18, 21, 24, 32, 33, 30, 11, 4, 5,
36, 34, 17, 19, 22, 25, 26, 31, 12-14, 35, 6-8, 15, 9, 37, 10, 23, 20, 27-29,
38, 39.
Then one ``kernels`` JSON line, the raw ``nvidia-smi`` line, and last the
``{"ok": true, "device": ...}`` line.  Any failed check exits non-zero; there
is no CPU fallback.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLICE = dict(b=3, h=4, hd=64, ttm=128, pm=257, max_new=512, L=8, d=256, dff=1024)
TOL = {  # max-abs tolerances of kernel against plain version, with their reason
    # f32 sums in another order (and, in the fused backward, dq summed through
    # atomics in an order that changes from run to run)
    'float32': {'atol': 1e-4, 'rtol': 0.0},
    # bf16: the plain versions round every intermediate to bf16 (2^-8 relative)
    # where the kernels keep f32; p's rounding differs by tile order
    'bfloat16': {'atol': 5e-2, 'rtol': 2e-2},
}
# The training shapes: (b, tokens, frames, causal) per case; s = tokens + frames.
TRAIN_CASES = {
    'ar': (32, 128, 512, True),        # bench.py:248 bench_train
    'nar': (32, 128, 512, False),      # bench.py:291 bench_train_nar
    'ar_long': (8, 256, 1024, True),   # the 1024-frame bucket: s=1280 > 768
}
# The training path: (model, batch, frames, timed steps); tokens = frames // 4.
TRAIN_RUNS = (('ValleAR', 32, 512, 10), ('ValleNAR', 32, 512, 10), ('ValleAR', 8, 1024, 3))
# Kernel against plain route in the grads phase: the largest |grad difference|
# of a leaf over that leaf's largest |grad| (f32, TF32 off; sums in another
# order through 8 layers).
GRAD_RTOL = 1e-4
# The same in bf16, on the same f32 master weights: kernels and plain route
# each part from the f32 plain grads by their own bf16 roundings (the flash
# forward's online softmax against the whole-row one; ds rounded before ds K
# where autograd of the plain route rounds dP).  Per leaf, the kernels may part
# from the plain route by k times the plain route's own distance from f32 --
# two independent errors of that size, and one more for the other rounding
# points -- plus one bf16 ulp (2^-8) of the leaf's largest f32 grad.
GRAD_BF16 = {'k': 3.0, 'ulp': 2.0 ** -8}
DTYPE_LABEL = {'bfloat16': 'bf16', 'float32': 'f32'}
# RVQ encode #8 cases: (B, T, n_q) -- a 2 s prompt, a dataset batch of 4 s,
# a ragged frame count with fewer stages.
RVQ_CASES = {'prompt_1x150': (1, 150, 8), 'batch_16x300': (16, 300, 8),
             'ragged_3x77': (3, 77, 4)}
# One H100 SXM (NVIDIA's data sheet): HBM bytes/s and dense peaks by input type
# (f32 inputs with TF32 off run on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
# bf16: profiling.H100_PEAK_BF16_FLOPS, set by main once the package imports
PEAK_FLOPS = {'float32': 67e12, 'int8': 1979e12}
# The quantized fused step (#6a), against its plain version on the same codes.
# W8A8 in f32: the kernel and the plain version compute the LayerNorm in other
# orders, so an activation x / sx within rounding of a .5 boundary rounds to
# the neighbouring int8 code ("a flip").  One flip moves that row's outputs by
# one activation step, sx * max|w| ~ (4 / 127) * (1 / 16) ~ 2e-3 at the serving
# widths (LN outputs reach ~4, weights 1 / sqrt(256)); every later projection
# of the row then re-rounds about |shift| / sx of its activations, so the row's
# error walks on to ~10 steps over 8 layers (measured: 8 steps).  25 steps
# (5e-2) bound the row that flipped; rows are independent, so no more than
# W8A8_ROWS_OFF of them may leave the dense f32 tolerance.  An int8 cache with
# dense weights: a k/v code of the new slot that flips moves y by up to
# ~5e-3, the JAX package's own tolerance for its int8-cache kernel
# (tests/test_kernels.py).  In bf16 the dense tolerance holds every variant.
TOL_QUANT = {'w8a8': {'atol': 5e-2, 'rtol': 0.0}, 'kv8': {'atol': 5e-3, 'rtol': 5e-3}}
W8A8_ROWS_OFF = 3
# A W8A8 activation within this many activation steps of a .5 boundary counts
# as a flip candidate: the f32 LayerNorm in another order moves x / sx by ~1e-5.
FLIP_MARGIN = 1e-4
# The #6a variants: (weight_dtype, kv_cache_dtype) of the serving config that
# launches each, and the JAX code each one ports.
QUANT_VARIANTS = {
    'w8a8': ('int8', 'bfloat16', 'fused_decode.py:176 _q8_dot'),
    'w4a16': ('int4', 'bfloat16', 'fused_decode.py:191 _q4_dot'),
    'kv8': ('compute', 'int8', 'fused_decode.py:135 quantize_kv_rowmajor, :223 '
            '_fake_quant_row, :539-557 dequant'),
    'w8a8_kv8': ('int8', 'int8', 'fused_decode.py:176 _q8_dot with the int8 cache'),
    'w4a16_kv8': ('int4', 'int8', 'fused_decode.py:191 _q4_dot with the int8 cache'),
}


# The chunked branch of the two fused steps: what it ports (#6a-rest).
CHUNK_PORTS = {
    'fused_decode_step_chunked': (
        'valle2_tpu/kernels/fused_decode.py:74-115 pick_chunk/chunk_for, :470-474 the chunk '
        'clamp, :523-584 the online softmax over chunks, :644-651 the seq % chunk refusal, '
        ':672-676 the clamped index map'),
    'fused_verify_step_chunked': (
        'valle2_tpu/kernels/fused_decode.py:777-779 the chunk clamp, :839-909 the online '
        'softmax over chunks of _verify_kernel, :960-965 the refusal')}

# The speculative verify step (#7) at the serving cell: 3 requests x 1 beam,
# a K-token block, rows at three depths of the 512-step budget.
SPEC = dict(rows=3, K=4, ngram=3, offsets=(100, 137, 203))
VERIFY_VARIANTS = ('dense', *QUANT_VARIANTS)
# The 204M geometry (GRAMMAR_V3_TPU_204M.json, examples/train_ar_dp_pp_tp.json:3).
LARGE = dict(d_model=1024, n_heads=16, dim_feedforward=4096, num_layers=16)
GREEDY_STEPS = 64     # greedy-ID checks of the spec and large phases
LARGE_STEPS = 128     # phase large's plain and speculative loops at 204M
# The stream phase: the serving model at the default max_audio_len, whose
# streaming model forces the 512-slot chunk; the prompt buckets of phase
# main's requests (48 phonemes + text in 128, 150 frames + BOS in 256); the
# JAX package's default chunk and lookahead frames.
STREAM = dict(max_new=1024, chunk=512, ttm=128, pm=256, chunk_frames=75, lookahead=38,
              requests=1, longform_max_new=256, profile_steps=256)
# #6 with a per-row index (continuous batching): 8 rows of the serving widths
# at their own depths past ttm + pm -- the first generated slot, the last slot
# of a chunk and the first of the next (chunk 128), S - 1 and one row frozen
# at S -- in a cache of 512 slots (128 + 128 + 256 frames), the largest
# whole-S f32 cache of 8 rows under the 8 MB block cap, so that both branches
# run in both dtypes.
PER_ROW = dict(ttm=128, pm=128, S=512, chunk=128, depths=(0, 44, 127, 128, 200, 255, 256, 1),
               tokens_lens=(112, 97, 81, 120, 64, 128, 100, 90),
               codes_lens=(101, 101, 64, 128, 101, 80, 101, 50))
PER_ROW_PORTS = {
    'fused_decode_step_per_row': (
        'valle2_tpu/kernels/fused_decode.py:636 per_row, :658 the per-row meta, :530 the '
        "row's own slot, :452-460 and :731-734 _write_rows_per_slot"),
    'fused_decode_step_per_row_chunked': (
        'the same per-row index with the chunked cache (:470-474 the clamp at the deepest '
        'row, :523-584 the online softmax over chunks)')}
# Continuous batching and the hub: the serving model with one beam on the
# JAX package's hub geometry (ttm = pm = 128: ContinuousDecoder's default,
# min(bucket_sizes)), advance chunk 25, N sessions (BENCHMARKS.md:484-491);
# prompts of 100 frames (101 code slots with BOS) fit pm.
# Tensor parallelism (phases 30-31): the virtual-rank cases of the TP steps
# (rows, S, index or per-row depths, chunk, weights, cache) at the serving
# widths; phase tp's mesh runs (max_audio_len, of phase main's requests).
TP_CASES = {
    'serve': dict(rows=12, S=1280, index=485, chunk=None, weights='compute', cache=None),
    'chunked': dict(rows=12, S=1280, index=485, chunk=256, weights='compute', cache=None),
    'per_row_kv8': dict(rows=8, S=512, index=None, chunk=None, weights='compute',
                        cache='int8'),
    'w4a16': dict(rows=12, S=1280, index=485, chunk=None, weights='int4', cache=None),
}
TP_MPS = (2, 4)
TP_STEPS = 128
# 5c alone at the partials the TP prefill and NAR of phase tp sum (b, ttm +
# pm, d) and (b, ttm + pm + TP_STEPS, d), f32: the serving batch's buckets.
TP_SUM_SHAPES = {'prefill': (SLICE['b'], SLICE['ttm'] + SLICE['pm'], SLICE['d']),
                 'nar': (SLICE['b'], SLICE['ttm'] + SLICE['pm'] - 1 + TP_STEPS, SLICE['d'])}
TP_PROFILE_MP = 2      # the virtual ranks of phase step profile's tp path
TP_PORTS = {
    'tp_allreduce': 'valle2_tpu/kernels/fused_decode.py:252-295 _ring_allreduce',
    'fused_decode_step_tp': ('valle2_tpu/kernels/fused_decode.py:706 with tp: :480-490 the '
                             'reduces of _kernel, :642 W8A8 refused, :660-662 the rank ids, '
                             ':688-702 the comm scratch'),
    'fused_verify_step_tp': 'valle2_tpu/kernels/fused_decode.py:1017 with tp: :786-792',
}
CB = dict(ttm=128, pm=128, chunk_frames=25, sessions=(4, 8), prompt_frames=100)
# Phase hub: 4 sessions of 512 frames with a forced chunk of 256 slots (the
# per-row step's chunked branch on every joint step), and 2 of them again as
# solo streams.
HUB = dict(max_new=512, chunk=256, sessions=4, solo=2)
# A bf16 greedy pick of the joint loop may part from the solo loop's only at
# a near-tie: the logits head runs at another row count (another cuBLAS
# kernel, f32 sums in another order) over bf16 hidden states, whose rounding
# (2^-8 relative) moves logits of |x| <= 8 by up to ~3e-2.
GREEDY_BF16_GAP = 5e-2
# Phase server (the serving layer over HTTP, valle2_tpu_torch/serve.py) at the
# serving width: (a) exactness in f32 (TF32 off, 4 beams, greedy, 128 frames)
# of 8 requests from 8 client threads; (b) load in bf16 at the serving config
# (512 frames, ignore_eos) of 16 requests from 16 threads, max_batch 8,
# max_wait_ms 10; (c) 4 streams through the hub (cb_streams 4, one beam, 256
# frames); (d) one /transcribe of 3 s; (e) a LoRA voice of rank 8 in a mixed
# f32 batch; (f) 3 LoRA fine-tune steps, b=8 x (128 + 512), bf16.
SERVER = dict(exact_max_new=128, exact_requests=8, max_batch=8, max_wait_ms=10.0,
              load_requests=16, load_max_new=512, streams=4, stream_max_new=256,
              lora_rank=8, lora_seed=35, ft_batch=8, ft_frames=512, ft_steps=3)
# An f32 (TF32 off) served row may part from its solo run only at a near-tie:
# the prefill's and the NAR's cuBLAS GEMMs run at another row count, whose
# f32 sums in another order move logits of |x| <= 8 by ~1e-5.
GREEDY_F32_GAP = 1e-3
# The persistent #6 and #7 (one cooperative launch a step) against the
# phased twin on the same inputs: fused_verify_step_phased (for #6 with a
# block of one token and the same start slots) runs the phased kernels,
# whose device code each item of the persistent step runs, so the two agree
# bit for bit.  Per case: rows, S (None: the main path's, serving_len), the
# forced chunk, the per-row index (PER_ROW's depths and lengths) or a scalar
# one, the widths (None: the serving model's; 'large': LARGE) and the
# variants and dtypes it runs; #7's cases (PERSISTENT_VERIFY) add K, the
# geometry's (ttm, pm) and the rows' start offsets past ttm + pm: the spec
# phase's cell (phase spec kernels), its chunked run (phase chunked: row
# 1's block straddles slot 512) and the 204M spec block (phase large
# kernels).
ALL_STEP_VARIANTS = ('dense', *QUANT_VARIANTS)
PERSISTENT_CASES = {
    'serve': dict(rows=12, S=None, chunk=None, per_row=False, large=False,
                  variants=ALL_STEP_VARIANTS, dtypes=('bfloat16', 'float32')),
    'beam4_whole': dict(rows=4, S=640, chunk=None, per_row=False, large=False,
                        variants=ALL_STEP_VARIANTS, dtypes=('bfloat16', 'float32')),
    'per_row': dict(rows=8, S=512, chunk=None, per_row=True, large=False,
                    variants=ALL_STEP_VARIANTS, dtypes=('bfloat16', 'float32')),
    'per_row_chunked': dict(rows=8, S=512, chunk=128, per_row=True, large=False,
                            variants=ALL_STEP_VARIANTS, dtypes=('bfloat16', 'float32')),
    'stream': dict(rows=1, S=1536, chunk=512, per_row=False, large=False,
                   variants=('dense',), dtypes=('bfloat16', 'float32')),
    '204m': dict(rows=1, S=896, chunk=None, per_row=False, large=True,
                 variants=('dense', 'w8a8'), dtypes=('bfloat16',)),
    '204m_beams': dict(rows=4, S=1024, chunk=512, per_row=False, large=True,
                       variants=('dense',), dtypes=('bfloat16',)),
}
PERSISTENT_VERIFY = {
    'spec': dict(rows=SPEC['rows'], K=SPEC['K'], S=901, chunk=None, large=False,
                 geometry=(SLICE['ttm'], SLICE['pm']), offsets=SPEC['offsets'],
                 variants=ALL_STEP_VARIANTS, dtypes=('bfloat16', 'float32')),
    'spec_chunked': dict(rows=SPEC['rows'], K=SPEC['K'], S=1024, chunk=STREAM['chunk'],
                         large=False, geometry=(SLICE['ttm'], SLICE['pm']),
                         offsets=(100, STREAM['chunk'] - 2 - SLICE['ttm'] - SLICE['pm'], 203),
                         variants=('dense',), dtypes=('bfloat16', 'float32')),
    '204m_spec': dict(rows=1, K=SPEC['K'], S=900, chunk=None, large=True,
                      geometry=(STREAM['ttm'], STREAM['pm']), offsets=(256,),
                      variants=('dense', 'w8a8'), dtypes=('bfloat16',)),
}
ALL_PERSISTENT = {**PERSISTENT_CASES, **PERSISTENT_VERIFY}
# The kernels-line entries whose rows show the persistent step beside the
# phased one: entry name -> (case, variant) pairs.
PERSISTENT_ROWS = {
    'fused_decode_step': (('serve', 'dense'), ('beam4_whole', 'dense'), ('204m', 'dense')),
    **{f'fused_decode_step_{v}': (('serve', v), ('beam4_whole', v))
       for v in QUANT_VARIANTS},
    'fused_decode_step_chunked': (('stream', 'dense'), ('204m_beams', 'dense')),
    'fused_decode_step_per_row': (('per_row', 'dense'),),
    'fused_decode_step_per_row_chunked': (('per_row_chunked', 'dense'),),
    'fused_verify_step': (('spec', 'dense'), ('204m_spec', 'dense')),
    **{f'fused_verify_step_{v}': (('spec', v),) for v in QUANT_VARIANTS},
    'fused_verify_step_chunked': (('spec_chunked', 'dense'),),
}
# The flash forward's tensor-core route (bf16) across the head dims: (b, h,
# s, tokens_total) at a ragged s (not a multiple of the 64-row tile), causal
# and bidirectional, the last row with tokens_valid == 0.
FLASH_TC_CASES = {f'hd{hd}': (3, 4, 385, 128, hd) for hd in (32, 64, 128)}
# The device kernels of the fused steps (#6, #7, and both under TP): the
# persistent ones, then the phased route's.
STEP_KERNELS = ('step_persistent_kernel', 'step_tp_persistent_kernel', 'proj_kernel',
                'attend_kernel', 'merge_kernel', 'kv_quant_kernel')
PHASED_KERNELS = STEP_KERNELS[2:]
# Profiles of a path taken again where torch.profiler saw fewer step kernels
# than #6 launched (lost records: once 981 for 1024 launches, while every
# repeat of that profile matched).
PROFILE_REPEATS = 3
# Decode steps of a profiled token loop (phase step profile, the decode
# profiles of phases spec and stream) and of the speculative runs under the
# quantized configs: enough for a step's kernels and busy share, few enough
# that the profiler's records of every path fit the script's time budget.
PROFILE_STEPS = 64
# Phase step profile's other paths: the stream path's one row (a forced
# chunk of 128 slots, 64 steps), the 204M stack's steps, and the joint
# advances of the cb paths (CB['chunk_frames'] steps each).
PROFILE_PATHS = dict(stream_steps=64, stream_chunk=128, large_steps=16, cb_advances=2)
# The head-folded flash forward (#2): (b, h, s, tokens_total, causal) per
# case -- the serving prefill of phase main, the serving-width train shapes
# (AR causal, NAR bidirectional) and the 204M train shape (bench.py:441);
# ragged meta, and the last batch row with tokens_valid == 0.
FOLD_CASES = {'serve': (3, 4, 385, 128, True), 'train_ar': (32, 4, 640, 128, True),
              'train_nar': (32, 4, 640, 128, False), '204m': (16, 16, 640, 128, True)}
FOLD_ENV = 'VALLE2_FLASH_FOLD'
FOLD_ARMS = (('off', '0'), ('fold', '1'))
# The 204M training step (bench.py:441 AR, :457 NAR): (model, batch, frames,
# timed steps per arm run); the NAR falls back to b=8 only if b=16 does not
# fit (bench.py:455-466).  Then the serving-width AR at s=1280 (#4 + #5).
FOLD_TRAIN = (('ValleAR', 16, 512, 5), ('ValleNAR', 16, 512, 5))
FOLD_LONG = ('ValleAR', 8, 1024, 2)
# The f32 grads check of the fold: the 204M widths cut to this depth.
FOLD_GRAD_LAYERS = 2
# W8A8 greedy picks may part between the kernels and the plain route where an
# activation code flipped (TOL_QUANT's reason) at a near-tie of two logits.
# One flipped code moves that activation by one step sx (<= ~4 / 127), so a
# projection's output by sx * |w| ~ 3e-2 * 1/32 ~ 1e-3 per flip at d = 1024;
# through 16 layers and the logits head that stays well under 5e-2.
GREEDY_W8A8_GAP = 5e-2


def step_name(kernel: str, variant: str) -> str:
    """The counter name of a fused step kernel's variant ('fused_decode_step'
    or 'fused_verify_step'; the dense variant carries the bare name)."""
    return kernel if variant == 'dense' else f'{kernel}_{variant}'


def tol_str(dtype_name: str, tol: dict | None = None) -> str:
    """A tolerance as text: the kernels line carries only measured numbers."""
    t = tol or TOL[dtype_name]
    return f"|err| <= {t['atol']:g} + {t['rtol']:g}*|plain|"


def variant_tol(variant: str, dtype_name: str) -> dict:
    """A fused step variant's tolerance against its plain version (the reason
    is at TOL_QUANT)."""
    if dtype_name == 'bfloat16':
        return TOL['bfloat16']
    if variant.startswith('w8a8'):
        return TOL_QUANT['w8a8']
    return TOL_QUANT['kv8'] if variant.endswith('kv8') else TOL['float32']


def emit(**obj) -> None:
    print(json.dumps(obj), flush=True)


PHASE_SECONDS: dict = {}   # wall seconds of each phase function main ran


def timed(fn, *args):
    """fn(*args), its wall time added to PHASE_SECONDS[fn.__name__]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[fn.__name__] = PHASE_SECONDS.get(fn.__name__, 0.0) + (
            time.perf_counter() - t0)


def fail(msg: str) -> None:
    print(f'chip_smoke: FAILED: {msg}', file=sys.stderr, flush=True)
    raise SystemExit(1)


def check_close(name: str, got, want, dtype_name: str, tol: dict | None = None) -> float:
    import torch
    tol = tol or TOL[dtype_name]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    bound = tol['atol'] + tol['rtol'] * want.abs()
    if not torch.isfinite(got).all():
        fail(f'{name} ({dtype_name}): non-finite output')
    if bool((err > bound).any()):
        fail(f'{name} ({dtype_name}): max |err| {err.max().item():.3e} over tolerance {tol}')
    return err.max().item()


def cuda_ms(fn, warmup: int = 5, reps: int = 30) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# The plain versions of the fused steps take 5-35 ms a call: their medians
# come from 10 calls after 2 (the kernels' from 30 after 5).
PLAIN_TIMING = dict(warmup=2, reps=10)


def enqueue_ms(fn, reps: int = 8) -> float:
    """Host time of one call of ``fn`` with the device idle before it: the
    launches' enqueue, without waiting for them (8 calls stay inside the
    launch queue)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return 1e3 * t


def bound(nbytes: float, flops: float, dtype_name: str) -> tuple[float, str]:
    """(ms, 'bytes' | 'operations'): the least time the card could take to
    move ``nbytes`` and do ``flops`` of ``dtype_name`` work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def attend_mask(meta, s: int, tokens_total: int, causal: bool):
    """(b, 1, s, s) bool, True = attend: the kernels' mask, for the SDPA yardstick."""
    from valle2_tpu_torch.ops.masks import prefix_lm_attend
    attend = prefix_lm_attend(s, tokens_total, meta[:, 0], meta[:, 1], causal)
    return attend.expand(-1, s, s)[:, None]


def sdpa_ms(q, k, v, mask, do=None) -> float:
    """CUDA-event time of torch's scaled_dot_product_attention on the same
    inputs and mask: its forward, or with ``do`` its backward alone."""
    import torch
    import torch.nn.functional as F
    if do is None:
        return cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    with torch.inference_mode(False), torch.enable_grad():
        qq, kk, vv = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask, do = mask.clone(), do.clone()
        out = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
        return cuda_ms(lambda: torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True))


def counters() -> dict:
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.kernels import gemm
    from valle2_tpu_torch.kernels import rvq as krvq
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    return {'tp_allreduce': ta.COUNTER, **fd.TP_COUNTERS,
            'flash_attention_fwd': fa.COUNTER, 'flash_attention_fwd_folded': fa.FOLD_COUNTER,
            'matmul_fullk': gemm.FULLK_COUNTER, 'matmul_ksplit': gemm.KSPLIT_COUNTER,
            'flash_bwd_fused': fa.BWD_FUSED_COUNTER,
            'flash_bwd_dq': fa.BWD_DQ_COUNTER, 'flash_bwd_dkv': fa.BWD_DKV_COUNTER,
            'fused_decode_step': fd.COUNTER, 'rvq_encode': krvq.COUNTER,
            **{f'fused_decode_step_{v}': fd.COUNTERS[v] for v in QUANT_VARIANTS},
            **{step_name('fused_verify_step', v): fd.VERIFY_COUNTERS[v]
               for v in VERIFY_VARIANTS},
            **{f'{k}_chunked': c for k, c in fd.CHUNKED_COUNTERS.items()},
            **fd.PER_ROW_COUNTERS}


def reset_counters() -> None:
    from valle2_tpu_torch.kernels import fused_decode as fd
    for c in (*counters().values(), fd.PLAIN_CALLS):
        c.reset()


def plain_calls() -> int:
    """Calls of the fused steps' plain versions since the last reset."""
    from valle2_tpu_torch.kernels import fused_decode as fd
    return fd.PLAIN_CALLS.count


def read_counters() -> dict:
    return {name: c.count for name, c in counters().items()}


def require_launches(path: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] <= 0:
            fail(f'the {path} path never launched {name}')


def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a CUDA card')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    emit(phase='device', kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    from valle2_tpu_torch.kernels import _build
    t0 = time.perf_counter()
    per_build = _build.build_all()
    emit(phase='build', seconds=time.perf_counter() - t0, per_build_s=per_build,
         builds=list(_build.BUILDS),
         sources=sorted({f'valle2_tpu_torch/csrc/{stem}.cu'
                         for stem, _ in _build.BUILDS.values()}))


def slice_lengths(device):
    """Per-item lengths like the main path's: tokens_lens and codes_lens
    (prompt frames + BOS) of 3 requests."""
    import torch
    tl = torch.tensor([112, 97, 81], dtype=torch.int32, device=device)
    cl = torch.tensor([151, 151, 151], dtype=torch.int32, device=device)
    return tl, cl


def phase_kernels(results: dict):
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa

    dev = torch.device('cuda')
    s = SLICE
    gen = torch.Generator().manual_seed(0)
    tl, cl = slice_lengths(dev)
    beams = 4
    rows = s['b'] * beams
    index = s['ttm'] + s['pm'] + 100
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            # Flash prefill: (b, h, s, hd) with s = ttm + pm.
            s_pre = s['ttm'] + s['pm']
            q, k, v = (torch.randn(s['b'], s['h'], s_pre, s['hd'], generator=gen)
                       .to(dev, dt) for _ in range(3))
            meta = torch.stack([tl, s['ttm'] + cl], dim=1).contiguous()
            o, lse = fa.flash_attention(q, k, v, meta, s['ttm'], True)
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, s['ttm'], True)
            torch.cuda.synchronize()
            err_o = check_close('flash o', o, o_ref, dtype_name)
            err_l = check_close('flash lse', lse, lse_ref, 'float32')
            ms = cuda_ms(lambda: fa.flash_attention(q, k, v, meta, s['ttm'], True))
            cc_ms = (cuda_ms(lambda: fa.flash_attention_cuda_cores(q, k, v, meta, s['ttm'],
                                                                   True))
                     if dtype_name == 'bfloat16' else None)
            plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, meta, s['ttm'],
                                                                True))
            mask = attend_mask(meta, s_pre, s['ttm'], True)
            library_ms = sdpa_ms(q, k, v, mask)
            pairs = int(mask.sum()) * s['h']
            bound_ms, bound_by = bound(4 * q.numel() * q.element_size() + lse.numel() * 4,
                                       2 * 2 * s['hd'] * pairs, dtype_name)
            results[('flash_attention_fwd', dtype_name)] = dict(
                max_abs_err=max(err_o, err_l), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                tol=tol_str(dtype_name), cuda_cores_ms=cc_ms)
            emit(phase='kernels', kernel='flash_attention_fwd', dtype=dtype_name,
                 shape=[s['b'], s['h'], s_pre, s['hd']], err_o=err_o, err_lse=err_l,
                 ms=ms, cuda_cores_ms=cc_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms, tol=tol_str(dtype_name))

            # Fused decode step: cache (L, rows, S, d), 8 layers; under a
            # bf16 model also over an f32 cache (the pair grammar_production's
            # bf16 runs serve in quant_quality's float32-cache cells).
            for cache_dt in (dt,) if dt == torch.float32 else (dt, torch.float32):
                fused_step_case(results, gen, dev, dtype_name, dt, cache_dt, rows, index,
                                tl.repeat_interleave(beams), cl.repeat_interleave(beams))


def fused_step_case(results: dict, gen, dev, dtype_name: str, dt, cache_dt, rows: int,
                    index: int, tl_f, pl_f):
    """#6 against its plain version at the serving cell's shapes, a model of
    ``dt`` over a cache of ``cache_dt``: y and the written cache within the
    model dtype's tolerance, times and bound into ``results``."""
    import torch
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init
    from valle2_tpu_torch.train import tree_leaves

    s = SLICE
    S = serving_len(rows, cache_dt)
    p = transformer_init(gen, s['L'], s['d'], s['h'], s['dff'], adaptive_norm=False)
    p = map_tree(lambda a: a.to(dev, dt).contiguous(), p)
    ck = torch.randn(s['L'], rows, S, s['d'], generator=gen).to(dev, cache_dt)
    cv = torch.randn(s['L'], rows, S, s['d'], generator=gen).to(dev, cache_dt)
    x = torch.randn(rows, 1, s['d'], generator=gen).to(dev, dt)
    args = (tl_f, pl_f, s['ttm'], s['pm'])
    c_k, c_p = KVCache(ck.clone(), cv.clone()), KVCache(ck.clone(), cv.clone())
    y, _ = fd.fused_decode_step(p, x, s['h'], c_k, index, *args)
    y_ref, _ = fd.fused_decode_step_plain(p, x, s['h'], c_p, index, *args)
    torch.cuda.synchronize()
    mixed = cache_dt != dt
    label = ' (f32 cache)' if mixed else ''
    if y.dtype != dt or y_ref.dtype != dt or c_k.k.dtype != cache_dt:
        fail(f'fused step{label}: y {y.dtype}, plain y {y_ref.dtype}, cache {c_k.k.dtype}')
    err_y = check_close(f'fused y{label}', y, y_ref, dtype_name)
    err_k = check_close(f'fused cache k{label}', c_k.k, c_p.k, dtype_name)
    err_v = check_close(f'fused cache v{label}', c_k.v, c_p.v, dtype_name)
    ms = cuda_ms(lambda: fd.fused_decode_step(p, x, s['h'], c_k, index, *args))
    plain_ms = cuda_ms(lambda: fd.fused_decode_step_plain(p, x, s['h'], c_p, index,
                                                          *args), **PLAIN_TIMING)
    # Bound: every weight, the valid cache slots of every row (source,
    # prompt, the steps so far and this one) read once; the new slot's
    # k, v and y written; the projections and attention as products.
    elt = x.element_size()
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(p))
    slots = int((tl_f + pl_f).sum()) + rows * (index - s['ttm'] - s['pm'] + 1)
    c_elt = ck.element_size()
    nbytes = (w_bytes + 2 * s['L'] * (slots + rows) * s['d'] * c_elt
              + 2 * rows * s['d'] * elt)
    flops = (rows * s['L'] * 2 * (4 * s['d'] ** 2 + 2 * s['d'] * s['dff'])
             + s['L'] * 2 * 2 * slots * s['d'])
    bound_ms, bound_by = bound(nbytes, flops, dtype_name)
    key = ('fused_decode_step', 'f32_cache', dtype_name) if mixed \
        else ('fused_decode_step', dtype_name)
    results[key] = dict(
        max_abs_err=max(err_y, err_k, err_v), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        tol=tol_str(dtype_name))
    emit(phase='kernels', kernel='fused_decode_step', dtype=dtype_name,
         cache_dtype=str(cache_dt).removeprefix('torch.'),
         shape=dict(L=s['L'], rows=rows, S=S, d=s['d'], h=s['h'], dff=s['dff'],
                    index=index, chunk=fd.cache_chunk(c_k, s['h'], None)),
         err_y=err_y, err_k=err_k, err_v=err_v, ms=ms, plain_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by, tol=tol_str(dtype_name))


def serving_len(rows: int, cache_dtype, total: int | None = None) -> int:
    """The cache length the prefill gives ``rows`` rows of the serving cell
    (ttm + pm + max_new slots, padded to a multiple of the chunk that
    ``chunk_for`` picks for that cache: at 12 rows a bf16 cache of 897 slots
    passes the TPU kernel's 8 MB block cap, so 640 slots, padded to 1280)."""
    from valle2_tpu_torch.kernels import fused_decode as fd
    s = SLICE
    total = total or s['ttm'] + s['pm'] + s['max_new']
    return fd.padded_cache_len(total, rows, s['d'], s['h'], cache_dtype)


def card_randn(shape, gen, dev):
    """A standard normal tensor drawn on the card from a generator seeded by
    ``gen`` (the CPU generator of the caller's case): the caches of the
    kernel cases are tens of millions of values, slow to draw on the host."""
    import torch
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.randn(shape, generator=torch.Generator(device=dev).manual_seed(seed),
                       device=dev)


def quant_step_inputs(variant: str, dt, gen, dev, rows: int = SLICE['b'] * 4,
                      S: int | None = None, widths: dict | None = None):
    """The serving step's stack and cache in ``variant``'s formats ('dense' or
    one of QUANT_VARIANTS): weights quantized by the port's quantize.py from a
    seeded f32 stack (scales then in the compute dtype), a random (L, rows, S,
    d) cache (int8 through quantize_kv_rowmajor; S by default the main
    path's, ``serving_len``).  ``widths``: L, d, h, dff in place of the
    serving model's."""
    import torch
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init
    from valle2_tpu_torch.quantize import quantize_transformer
    s = {**SLICE, **(widths or {})}
    weight_dtype, cache_dtype = (('compute', 'bfloat16') if variant == 'dense'
                                 else QUANT_VARIANTS[variant][:2])
    if S is None:
        S = serving_len(rows, torch.int8 if cache_dtype == 'int8' else dt)
    p = transformer_init(gen, s['L'], s['d'], s['h'], s['dff'], adaptive_norm=False)
    if weight_dtype != 'compute':
        p = quantize_transformer(p, bits=8 if weight_dtype == 'int8' else 4)
    p = map_tree(lambda a: (a.to(dt) if a.is_floating_point() else a).to(dev).contiguous(),
                 p)
    ck, cv = (card_randn((s['L'], rows, S, s['d']), gen, dev) for _ in range(2))
    if cache_dtype == 'int8':
        (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, s['h']) for c in (ck, cv))
        return p, KVCache(kq, vq, ks, vs)
    return p, KVCache(ck.to(dt), cv.to(dt))


@contextlib.contextmanager
def w8a8_flip_candidates():
    """Count, over the plain step's int8 matmuls, the activations whose x / sx
    lies within FLIP_MARGIN of a .5 rounding boundary (where the kernel's
    LayerNorm, summed in another order, can round to the neighbouring code),
    and the largest activation step sx * max|w| of any projection."""
    from valle2_tpu_torch.ops import nn as nn_mod
    inner = nn_mod.int8_matmul
    stats = {'activations': 0, 'flip_candidates': 0, 'max_activation_step': 0.0}

    def recording(x, q, scale):
        x32 = x.float()
        sx = x32.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
        u = x32 / sx
        stats['activations'] += u.numel()
        stats['flip_candidates'] += int(((u - u.floor() - 0.5).abs() < FLIP_MARGIN).sum())
        w_max = float((q.float().abs().amax(dim=0) * scale.float()).max())
        stats['max_activation_step'] = max(stats['max_activation_step'],
                                           float(sx.max()) * w_max)
        return inner(x, q, scale)
    nn_mod.int8_matmul = recording
    try:
        yield stats
    finally:
        nn_mod.int8_matmul = inner


def dequantized(cache, h: int):
    """The (L, rows, S, d) f32 values of a fused cache, int8 or float."""
    from valle2_tpu_torch.kernels import fused_decode as fd
    if cache.k_scale is None:
        return cache.k.float(), cache.v.float()
    view = fd.per_head_view(cache, h)
    return tuple((c.float() * sc.float()).permute(0, 1, 3, 2, 4).flatten(-2)
                 for c, sc in ((view.k, view.k_scale), (view.v, view.v_scale)))


def hold_variant(name: str, variant: str, dtype_name: str, y, y_ref, c_k, c_p
                 ) -> tuple[float, float, dict]:
    """Hold a fused step variant's y and written cache against its plain
    version's: (max |err| of y, of the cache, details).  y within the
    variant's tolerance, W8A8 in f32 with at most W8A8_ROWS_OFF rows beyond
    the dense tolerance; an int8 cache in f32 as integers (codes within one
    step, bf16 scales within one bf16 step), other caches as values."""
    tol = variant_tol(variant, dtype_name)
    L, rows, _, d = c_k.k.shape
    err_y = check_close(f'{name} y', y, y_ref, dtype_name, tol)
    extra = {}
    if variant.startswith('w8a8') and dtype_name == 'float32':
        off = int(((y - y_ref).abs().amax(dim=(1, 2)) > TOL['float32']['atol']).sum())
        if off > W8A8_ROWS_OFF:
            fail(f'{name} (float32): {off} of {rows} rows off the dense '
                 f'tolerance, more than flips explain ({W8A8_ROWS_OFF})')
        extra['rows_off_dense_tol'] = off
    if c_k.k_scale is not None and dtype_name == 'float32':
        # codes as integers: within one int8 step of the plain ones (a W8A8
        # row that flipped is held to TOL_QUANT below)
        diffs = [(a.int() - b.int()).abs() for a, b in zip(c_k[:2], c_p[:2])]
        worst = max(int(d_.max()) for d_ in diffs)
        if worst > 1 and not variant.startswith('w8a8'):
            fail(f'{name} (float32): a cache code {worst} steps off the plain one')
        extra.update(cache_codes_differ=sum(int((d_ > 0).sum()) for d_ in diffs),
                     cache_codes_written=2 * L * rows * d, cache_code_max_diff=worst)
    if c_k.k_scale is not None and dtype_name == 'float32' \
            and not variant.startswith('w8a8'):
        for a, b in zip(c_k[2:], c_p[2:]):
            check_close(f'{name} cache scales', a, b, dtype_name,
                        {'atol': 0.0, 'rtol': 2 ** -7})   # one bf16 step
        err_c = 0.0
    else:     # values: bf16, a float cache, or a W8A8 row that flipped
        h = SLICE['h']
        err_c = max(check_close(f'{name} cache', a, b, dtype_name, tol)
                    for a, b in zip(dequantized(c_k, h), dequantized(c_p, h)))
    return err_y, err_c, extra


def variant_bound(p, variant: str, dtype_name: str, cache, rows: int, read_slots: int,
                  x_elt: int) -> tuple[int, float, str]:
    """(bytes, ms, 'bytes' | 'operations') of one fused step of ``variant``:
    every weight byte (codes, scales, norms, biases), the valid slots' k/v
    (and int8 scales) read once, the new slots, x and y written; products
    at the int8 (W8A8) or compute peak."""
    from valle2_tpu_torch.train import tree_leaves
    L, _, _, d = cache.k.shape
    h, dff = SLICE['h'], p['ffn']['lin1'][next(k for k in ('w', 'q', 'q4')
                                               if k in p['ffn']['lin1'])].shape[-1]
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(p))
    slot_bytes = 2 * d * cache.k.element_size() + (2 * h * 2 if cache.k_scale is not None
                                                   else 0)
    nbytes = w_bytes + L * (read_slots + rows) * slot_bytes + 2 * rows * d * x_elt
    proj_ops = rows * L * 2 * (4 * d ** 2 + 2 * d * dff)
    attn_ops = L * 2 * 2 * read_slots * d
    t_ops = (proj_ops / PEAK_FLOPS['int8' if variant.startswith('w8a8') else dtype_name]
             + attn_ops / PEAK_FLOPS[dtype_name])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return nbytes, 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def phase_quant_kernels(results: dict):
    """Every #6a variant of the fused step against its plain version at the
    serving shape, on the same codes, in f32 (TF32 off) and bf16."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache

    dev = torch.device('cuda')
    s = SLICE
    gen = torch.Generator().manual_seed(6)
    tl, cl = slice_lengths(dev)
    rows = s['b'] * 4
    index = s['ttm'] + s['pm'] + 100
    tl_f, pl_f = tl.repeat_interleave(4), cl.repeat_interleave(4)
    args = (tl_f, pl_f, s['ttm'], s['pm'])
    slots = int((tl_f + pl_f).sum()) + rows * (index - s['ttm'] - s['pm'] + 1)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            for variant in QUANT_VARIANTS:
                name = f'fused_decode_step_{variant}'
                p, cache = quant_step_inputs(variant, dt, gen, dev)
                x = torch.randn(rows, 1, s['d'], generator=gen).to(dev, dt)
                c_k, c_p = KVCache(*(c.clone() for c in cache if c is not None)), \
                    KVCache(*(c.clone() for c in cache if c is not None))
                y, _ = fd.fused_decode_step(p, x, s['h'], c_k, index, *args)
                with w8a8_flip_candidates() as flips:
                    y_ref, _ = fd.fused_decode_step_plain(p, x, s['h'], c_p, index, *args)
                torch.cuda.synchronize()
                tol = variant_tol(variant, dtype_name)
                err_y, err_c, extra = hold_variant(name, variant, dtype_name, y, y_ref, c_k,
                                                   c_p)
                if variant.startswith('w8a8') and dtype_name == 'float32':
                    extra.update(flips, err_in_activation_steps=err_y
                                 / max(flips['max_activation_step'], 1e-30))
                ms = cuda_ms(lambda: fd.fused_decode_step(p, x, s['h'], c_k, index, *args))
                plain_ms = cuda_ms(lambda: fd.fused_decode_step_plain(p, x, s['h'], c_p,
                                                                      index, *args),
                                   **PLAIN_TIMING)
                nbytes, bound_ms, bound_by = variant_bound(p, variant, dtype_name, cache, rows,
                                                           slots, x.element_size())
                results[(name, dtype_name)] = dict(
                    max_abs_err=max(err_y, err_c), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    tol=tol_str(dtype_name, tol))
                emit(phase='kernels', path='quant', kernel=name, variant=variant,
                     dtype=dtype_name, cache=str(cache.k.dtype).replace('torch.', ''),
                     shape=dict(L=s['L'], rows=rows, S=cache.k.shape[2], d=s['d'],
                                h=s['h'], dff=s['dff'], index=index),
                     err_y=err_y, err_cache=err_c, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                     tol=tol_str(dtype_name, tol), **extra)
                del p, cache, c_k, c_p


def phase_quant(smi: str) -> dict:
    """Quantized serving: batch_synthesize of phase main's 3 requests under
    each #6a configuration (and the dense one beside them), weights shared.
    Counts zeroed before, read after each: the config's variant of the fused
    step and the flash prefill must have launched."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    base_kw = dict(max_audio_len=max_new, ignore_eos=True, dropout=0.0, dtype='bfloat16')
    base = ValleTTS(ConfigValle(**base_kw), device='cuda')
    texts, pts, pcs = make_requests()
    total = dict.fromkeys(read_counters(), 0)
    configs = {'dense': ('compute', 'bfloat16')}
    configs.update({v: wk[:2] for v, wk in QUANT_VARIANTS.items()})
    for variant, (weight_dtype, cache_dtype) in configs.items():
        cfg = ConfigValle(**base_kw, weight_dtype=weight_dtype, kv_cache_dtype=cache_dtype)
        tts = ValleTTS(cfg, ar=ValleAR(cfg, params=base.ar.params, device='cuda'),
                       nar=base.nar, codec=base.codec, device='cuda')
        tts.batch_synthesize(texts, pts, pcs)           # warm-up: quantizes, allocator
        torch.cuda.synchronize()
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        batch = tts.batch_synthesize(texts, pts, pcs)
        launches = read_counters()
        for r in batch:
            n = len(r.codes)
            if n != max_new or r.waveform.shape != (n * 320,) \
                    or not np.isfinite(r.waveform).all():
                fail(f'quant ({variant}): waveform of {r.waveform.shape} for gen_len {n}')
        kernel = 'fused_decode_step' + ('' if variant == 'dense' else f'_{variant}')
        require_launches(f'quant ({variant})', launches, ('flash_attention_fwd', kernel))
        others = {k: n for k, n in step_launches(launches).items() if k != kernel}
        if others:
            fail(f'quant ({variant}): launched other fused-step variants {others}')
        for k, n in launches.items():
            total[k] += n
        t = batch[0].timings
        emit(phase='quant', variant=variant, weight_dtype=weight_dtype,
             kv_cache_dtype=cache_dtype, requests=len(texts), max_audio_len=max_new,
             stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
             batch_wall_s=t['batched'], decode_ms_per_step=1e3 * t['decode'] / max_new,
             ar_tokens_per_s=len(texts) * max_new / t['decode'], rtf=batch[0].rtf,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches={k: n for k, n in launches.items() if n}, card=smi)
    return total


def phase_spec_kernels(results: dict):
    """Every variant of the verify step (#7) against its plain version at the
    serving cell's block, on the same codes, in f32 (TF32 off) and bf16,
    timed beside its phased twin."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache

    dev = torch.device('cuda')
    s = SLICE
    rows, K = SPEC['rows'], SPEC['K']
    S = s['ttm'] + s['pm'] + s['max_new'] + K
    gen = torch.Generator().manual_seed(7)
    tl, cl = slice_lengths(dev)
    index = torch.tensor([s['ttm'] + s['pm'] + o for o in SPEC['offsets']], dtype=torch.int32,
                         device=dev)
    args = (tl, cl, s['ttm'], s['pm'])
    # Query i of row r attends tl + pl + (index - ttm - pm + 1 + i) slots; a
    # row's slots are read once (the last query's range, the block's own
    # slots included: written, then read).
    gen_slots = [o + 1 for o in SPEC['offsets']]
    prompt_slots = int((tl + cl).sum())
    read_slots = prompt_slots + sum(g + K - 1 for g in gen_slots)
    pairs = K * prompt_slots + sum(K * g + K * (K - 1) // 2 for g in gen_slots)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            for variant in VERIFY_VARIANTS:
                name = step_name('fused_verify_step', variant)
                p, cache = quant_step_inputs(variant, dt, gen, dev, rows=rows, S=S)
                x = torch.randn(rows, K, s['d'], generator=gen).to(dev, dt)
                c_k, c_p = KVCache(*(c.clone() for c in cache if c is not None)), \
                    KVCache(*(c.clone() for c in cache if c is not None))
                y, _ = fd.fused_verify_step(p, x, s['h'], c_k, index, *args)
                with w8a8_flip_candidates() as flips:
                    y_ref, _ = fd.fused_verify_step_plain(p, x, s['h'], c_p, index, *args)
                torch.cuda.synchronize()
                tol = variant_tol(variant, dtype_name)
                err_y = check_close(f'{name} y', y, y_ref, dtype_name, tol)
                extra = {}
                if variant.startswith('w8a8') and dtype_name == 'float32':
                    off = int(((y - y_ref).abs().amax(dim=2) > TOL['float32']['atol']).sum())
                    if off > W8A8_ROWS_OFF:
                        fail(f'{name} (float32): {off} of {rows * K} query rows off the dense '
                             f'tolerance, more than flips explain ({W8A8_ROWS_OFF})')
                    extra.update(flips, query_rows_off_dense_tol=off,
                                 err_in_activation_steps=err_y
                                 / max(flips['max_activation_step'], 1e-30))
                if cache.k_scale is not None and dtype_name == 'float32':
                    diffs = [(a.int() - b.int()).abs() for a, b in zip(c_k[:2], c_p[:2])]
                    worst = max(int(d_.max()) for d_ in diffs)
                    if worst > 1 and not variant.startswith('w8a8'):
                        fail(f'{name} (float32): a cache code {worst} steps off the plain one')
                    extra.update(cache_codes_differ=sum(int((d_ > 0).sum()) for d_ in diffs),
                                 cache_codes_written=2 * s['L'] * rows * K * s['d'],
                                 cache_code_max_diff=worst)
                if (cache.k_scale is not None and dtype_name == 'float32'
                        and not variant.startswith('w8a8')):
                    for a, b in zip(c_k[2:], c_p[2:]):
                        check_close(f'{name} cache scales', a, b, dtype_name,
                                    {'atol': 0.0, 'rtol': 2 ** -7})   # one bf16 step
                    err_c = 0.0
                else:
                    err_c = max(check_close(f'{name} cache', a, b, dtype_name, tol)
                                for a, b in zip(dequantized(c_k, s['h']),
                                                dequantized(c_p, s['h'])))
                ms = cuda_ms(lambda: fd.fused_verify_step(p, x, s['h'], c_k, index, *args))
                # the phased twin (the route #7 took before it was one launch)
                phased_ms = cuda_ms(lambda: fd.fused_verify_step_phased(p, x, s['h'], c_k,
                                                                        index, *args))
                plain_ms = cuda_ms(lambda: fd.fused_verify_step_plain(p, x, s['h'], c_p, index,
                                                                      *args),
                                   **PLAIN_TIMING)
                nbytes, bound_ms, bound_by = verify_bound(p, variant, dtype_name, cache, s['h'],
                                                          rows * K, read_slots, pairs,
                                                          x.element_size())
                results[(name, dtype_name)] = dict(
                    max_abs_err=max(err_y, err_c), ms=ms, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                    tol=tol_str(dtype_name, tol))
                emit(phase='kernels', path='spec', kernel=name, variant=variant,
                     dtype=dtype_name, cache=str(cache.k.dtype).replace('torch.', ''),
                     shape=dict(L=s['L'], rows=rows, K=K, S=S, d=s['d'], h=s['h'],
                                dff=s['dff'], index=index.tolist()),
                     err_y=err_y, err_cache=err_c, ms=ms, phased_ms=phased_ms,
                     plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                     tol=tol_str(dtype_name, tol), **extra)
                del p, cache, c_k, c_p


def step_launches(launches: dict) -> dict:
    """The nonzero counts of the fused step kernels (#6, #6a-q, #7), without
    the chunked counters (a chunked launch counts in its variant too)."""
    return {k: n for k, n in launches.items()
            if k.startswith(('fused_decode_step', 'fused_verify_step'))
            and not k.endswith('_chunked') and n}


def phase_spec(smi: str) -> dict:
    """Speculative decode at the serving config with one beam, beside the
    plain loop on the same weights, then under each quantized config
    (PROFILE_STEPS frames); the decode profiles of both loops (PROFILE_STEPS
    steps); then the full-width greedy check.  Returns the launch counts of
    the spec runs."""
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    base_kw = dict(max_audio_len=max_new, ignore_eos=True, dropout=0.0, dtype='bfloat16',
                   num_beams=1)
    spec_kw = dict(speculative_k=SPEC['K'], speculative_ngram=SPEC['ngram'])
    base = ValleTTS(ConfigValle(**base_kw), device='cuda')
    texts, pts, pcs = make_requests()
    total = dict.fromkeys(read_counters(), 0)
    plain_ms = []

    def run(label: str, cfg, kernel: str, counted: bool):
        max_new = cfg.max_audio_len
        tts = ValleTTS(cfg, ar=ValleAR(cfg, params=base.ar.params, device='cuda'),
                       nar=base.nar, codec=base.codec, device='cuda')
        tts.batch_synthesize(texts, pts, pcs)           # warm-up: quantizes, allocator
        torch.cuda.synchronize()
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        batch = tts.batch_synthesize(texts, pts, pcs)
        launches = read_counters()
        for r in batch:
            n = len(r.codes)
            if n != max_new or r.waveform.shape != (n * 320,) \
                    or not np.isfinite(r.waveform).all():
                fail(f'spec ({label}): waveform of {r.waveform.shape} for gen_len {n}')
        require_launches(f'spec ({label})', launches, ('flash_attention_fwd', kernel))
        others = {k: n for k, n in step_launches(launches).items() if k != kernel}
        if others:
            fail(f'spec ({label}): launched other fused-step kernels {others}')
        if counted:
            for k, n in launches.items():
                total[k] += n
        t, counts = batch[0].timings, batch[0].counts
        out = dict(phase='spec', run=label, kernel=kernel, weight_dtype=cfg.weight_dtype,
                   kv_cache_dtype=cfg.kv_cache_dtype, speculative_k=cfg.speculative_k,
                   requests=len(texts), max_audio_len=max_new,
                   stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
                   batch_wall_s=t['batched'], decode_ms_per_token=1e3 * t['decode'] / max_new,
                   ar_tokens_per_s=len(texts) * max_new / t['decode'], rtf=batch[0].rtf,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=step_launches(launches), card=smi)
        chunked = launches[('fused_verify_step' if 'verify' in kernel
                            else 'fused_decode_step') + '_chunked']
        if cfg.decode_chunk and chunked != launches[kernel]:
            fail(f'spec ({label}): {chunked} of {launches[kernel]} steps took the chunked '
                 'branch')
        out['chunked_launches'] = chunked
        if counts:
            turns = counts['ar_turns']
            out.update(turns=turns, tokens=counts['ar_tokens'],
                       mean_accepted_per_turn=counts['ar_tokens'] / (len(texts) * turns),
                       ms_per_turn=1e3 * t['decode'] / turns,
                       verify_launches_per_turn=launches[kernel] / turns)
        else:
            plain_ms.append(out['decode_ms_per_token'])
        emit(**out)

    plain_cfg, spec_cfg = ConfigValle(**base_kw), ConfigValle(**base_kw, **spec_kw)
    for label, cfg in (('plain', plain_cfg), ('spec', spec_cfg)):
        run(label, cfg, 'fused_decode_step' if label == 'plain' else 'fused_verify_step',
            label == 'spec')
    for variant, (weight_dtype, cache_dtype, _) in QUANT_VARIANTS.items():
        run(f'spec_{variant}', ConfigValle(**{**base_kw, 'max_audio_len': PROFILE_STEPS},
                                           **spec_kw, weight_dtype=weight_dtype,
                                           kv_cache_dtype=cache_dtype),
            step_name('fused_verify_step', variant), True)
    # decode_chunk 512: the cache padded from 901 to 1024 slots, every verify
    # pass through the split attention.
    run('spec_chunked', ConfigValle(**base_kw, **spec_kw, decode_chunk=STREAM['chunk']),
        'fused_verify_step', True)
    for label, cfg in (('plain', plain_cfg), ('spec', spec_cfg)):
        cfg = dataclasses.replace(cfg, max_audio_len=PROFILE_STEPS)
        emit(phase='spec', run=label, max_audio_len=PROFILE_STEPS,
             decode_profile=profile_decode(ValleAR(cfg, params=base.ar.params, device='cuda'),
                                           texts, pts, pcs), card=smi)
    greedy_spec_check('serving', {}, smi)
    return total


def profile_decode(model, texts, pts, pcs) -> dict:
    """Where one AR decode of the 3 requests (generate_batch: prefill and
    token loop) spends its time: torch.profiler's device time by kernel
    group against the wall time (the profiler's own host cost included),
    the device's busy share and the launches."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer

    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]
    model.generate_batch(tokens, pcs)                     # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.generate_batch(tokens, pcs)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = {'fused step (#6, #7)': ('step_persistent_kernel', 'proj_kernel',
                                      'attend_kernel', 'merge_kernel', 'kv_quant'),
              'flash prefill (#1)': ('flash_fwd',),
              'gemm (cuBLAS, logits)': ('gemm', 'gemv', 'nvjet', 'cutlass'),
              'sampling, drafts and bookkeeping': ('elementwise', 'reduce', 'topk', 'sort',
                                                   'scatter', 'gather', 'index', 'softmax',
                                                   'cumsum', 'scan', 'fill', 'copy')}
    by_group = dict.fromkeys([*groups, 'other'], 0.0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        name = e.key.lower()
        key = next((g for g, pats in groups.items() if any(x in name for x in pats)), 'other')
        by_group[key] += e.self_device_time_total / 1e3
    device_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                kernel_launches=sum(e.count for e in kernels), device_ms_by_group=by_group,
                top_kernels=[{'name': e.key[:80], 'calls': e.count,
                              'ms': e.self_device_time_total / 1e3} for e in top])


def greedy_spec_check(label: str, widths: dict, smi: str, weight_dtype: str = 'compute'):
    """Greedy IDs in f32 with TF32 off, GREEDY_STEPS steps of phase 5's first
    request (all three at the serving widths), four ways: speculative decode
    through #7, the plain loop through #6, and both through the plain route
    (use_fused_decode=False).  Dense weights: all four equal.  W8A8: the
    kernels' and PyTorch's LayerNorms sum in other orders, so an activation
    code can flip (TOL_QUANT) and a greedy pick can follow it at a near-tie:
    where two runs part, the plain route's teacher-forced logits of the two
    tokens at that step must lie within GREEDY_W8A8_GAP of each other."""
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.tts import StageClock

    cfg = ConfigValle(**widths, max_audio_len=GREEDY_STEPS, ignore_eos=True, dropout=0.0,
                      temperature=0.0, num_beams=1, kv_cache_dtype='float32',
                      matmul_precision='highest', weight_dtype=weight_dtype)
    texts, pts, pcs = make_requests()
    n = 1 if widths else len(texts)
    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts[:n], pts[:n])]
    ref = ValleAR(cfg, device='cuda')
    variant = {'compute': 'dense', 'int8': 'w8a8', 'int4': 'w4a16'}[weight_dtype]
    runs = {}
    for name, kw, kernel in (
            ('spec_kernel', dict(speculative_k=SPEC['K']), 'fused_verify_step'),
            ('plain_kernel', {}, 'fused_decode_step'),
            ('spec_plain_route', dict(speculative_k=SPEC['K'], use_fused_decode=False), None),
            ('plain_route', dict(use_fused_decode=False), None)):
        model = ValleAR(dataclasses.replace(cfg, **kw), params=ref.params, device='cuda')
        reset_counters()
        clock = StageClock('cuda')
        ids = model.generate_batch(tokens, pcs[:n], clock=clock)
        launched = step_launches(read_counters())
        want = {step_name(kernel, variant)} if kernel else set()
        if set(launched) != want:
            fail(f'greedy ({label}, {name}): step kernels launched {launched}')
        runs[name] = (ids, clock.counts)
    ids0 = runs['spec_kernel'][0]
    parted = {}
    for name, (ids, _) in runs.items():
        for i, (a, b) in enumerate(zip(ids, ids0)):
            if not torch.equal(a, b):
                j = int((a[:len(b)] != b[:len(a)]).int().argmax()) \
                    if not torch.equal(a[:len(b)], b[:len(a)]) else min(len(a), len(b))
                parted[f'{name}/{i}'] = dict(step=j, tokens=[int(b[j]), int(a[j])]
                                             if j < min(len(a), len(b)) else None)
    for key, where in parted.items():
        if variant != 'w8a8' or where['tokens'] is None:
            fail(f'greedy ({label}): {key} IDs differ from the speculative kernel run '
                 f'from step {where["step"]}')
        gap = teacher_forced_gap(ref, cfg, tokens[int(key.split('/')[1])],
                                 pcs[int(key.split('/')[1])],
                                 runs['spec_kernel'][0][int(key.split('/')[1])][:where['step']],
                                 where['tokens'])
        where.update(logit_gap=gap, allowed=GREEDY_W8A8_GAP)
        if gap > GREEDY_W8A8_GAP:
            fail(f'greedy ({label}): {key} parts from the speculative kernel run at step '
                 f'{where["step"]} where the plain logits of its tokens {where["tokens"]} '
                 f'are {gap:.3e} apart, over {GREEDY_W8A8_GAP:g}')
    counts = runs['spec_kernel'][1]
    emit(phase='greedy', path=label, dtype='float32', weight_dtype=weight_dtype,
         steps=GREEDY_STEPS, rows=n, equal=not parted, parted_at_near_ties=parted,
         runs=sorted(runs), spec_turns=counts['ar_turns'],
         mean_accepted_per_turn=counts['ar_tokens'] / (n * counts['ar_turns']),
         first_tokens=[g[:8].tolist() for g in ids0], card=smi)


def teacher_forced_gap(model, cfg, tokens, prompt_codes, prefix, pair) -> float:
    """|logit(a) - logit(b)| of the plain route (bias attention, PyTorch
    products) at the step after ``prefix``, teacher-forced on the prompt and
    the prefix: how near a tie the two greedy picks ``pair`` were."""
    import dataclasses

    import torch
    from valle2_tpu_torch.models import ar as ar_mod
    plain = dataclasses.replace(cfg, use_flash_attention=False)
    dev = torch.device('cuda')
    toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)[None]
    codes = torch.cat([torch.tensor([model.bos_token]),
                       torch.as_tensor(prompt_codes, dtype=torch.long)[:, 0],
                       prefix.long()])[None].to(dev)
    with torch.inference_mode():
        logits = ar_mod.forward(model.decode_params, plain, toks, codes, None, None)[0, -1]
    return float((logits[pair[0]] - logits[pair[1]]).abs())


def phase_large(smi: str) -> dict:
    """The 204M geometry, dense and int8 W8A8: one utterance of LARGE_STEPS
    steps in bf16 through the plain loop and the speculative loop, then the
    greedy check and ``large_beams``.  Returns the launch counts of the timed
    runs."""
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.tts import StageClock

    max_new = LARGE_STEPS
    texts, pts, pcs = make_requests()
    tokens = [np.concatenate([pts[0], PhonemeTokenizer()(texts[0])])]
    total = dict.fromkeys(read_counters(), 0)
    ref = None
    for weight_dtype, variant in (('compute', 'dense'), ('int8', 'w8a8')):
        for label, kw, kernel in (('plain', {}, 'fused_decode_step'),
                                  ('spec', dict(speculative_k=SPEC['K'],
                                                speculative_ngram=SPEC['ngram']),
                                   'fused_verify_step')):
            cfg = ConfigValle(**LARGE, max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                              dtype='bfloat16', num_beams=1, weight_dtype=weight_dtype, **kw)
            if not cfg.fused_decode_enabled('cuda'):
                fail(f'large: the fused kernels refuse the {weight_dtype} 204M stack')
            model = ValleAR(cfg, params=None if ref is None else ref.params, device='cuda')
            ref = ref or model
            model.generate_batch(tokens, pcs[:1])           # warm-up: quantizes, allocator
            torch.cuda.synchronize()
            reset_counters()
            torch.cuda.reset_peak_memory_stats()
            clock = StageClock('cuda')
            t0 = time.perf_counter()
            ids = model.generate_batch(tokens, pcs[:1], clock=clock)
            wall = time.perf_counter() - t0
            launches = read_counters()
            name = step_name(kernel, variant)
            require_launches(f'large ({weight_dtype}, {label})', launches,
                             ('flash_attention_fwd', name))
            # max_new steps (the output strips the EOS ids a random model
            # samples): one launch a step, or max_new committed tokens.
            steps = clock.counts['ar_tokens'] if clock.counts else launches[name]
            if steps != max_new or step_launches(launches) != {name: launches[name]}:
                fail(f'large ({weight_dtype}, {label}): {steps} steps, step kernels '
                     f'{step_launches(launches)}')
            for k, n in launches.items():
                total[k] += n
            out = dict(phase='large', run=label, weight_dtype=weight_dtype, kernel=name,
                       **LARGE, max_audio_len=max_new, wall_s=wall,
                       stage_s=dict(clock.times),
                       decode_ms_per_token=1e3 * clock.times['decode'] / max_new,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches=step_launches(launches), card=smi)
            if clock.counts:
                turns = clock.counts['ar_turns']
                out.update(turns=turns, mean_accepted_per_turn=clock.counts['ar_tokens'] / turns,
                           ms_per_turn=1e3 * clock.times['decode'] / turns)
            emit(**out)
            del model
        greedy_spec_check(f'large_{variant}', LARGE, smi, weight_dtype)
    for k, n in large_beams(ref.params, smi).items():
        total[k] += n
    return total


def large_beams(ar_params, smi: str) -> dict:
    """The 204M stack at its default 4 beams through batch_synthesize (one
    request, bf16, 512 steps): 4 rows of a bf16 cache of 896 slots pass the
    TPU kernel's block cap, so chunk_for picks 512 on its own and the
    prefill pads the cache to 1024; every step must take the chunked
    branch.  Then greedy IDs in f32 (TF32 off, 64 steps) through the kernels
    == through the plain route.  Returns the launch counts of the timed run."""
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    texts, pts, pcs, tokens = stream_requests()
    cfg = ConfigValle(**LARGE, max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                      dtype='bfloat16', num_beams=4)
    S = fd.padded_cache_len(STREAM['ttm'] + STREAM['pm'] + max_new, 4, cfg.d_model,
                            cfg.n_heads, torch.bfloat16)
    chunk = fd.chunk_for(S, 4, cfg.d_model, cfg.n_heads, torch.bfloat16)
    if (S, chunk) != (1024, 512):
        fail(f'large (4 beams): chunk_for picks {chunk} of {S} slots, not 512 of 1024')
    tts = ValleTTS(cfg, ar=ValleAR(cfg, params=ar_params, device='cuda'), device='cuda')
    tts.batch_synthesize(texts[:1], pts[:1], pcs[:1])          # warm-up
    torch.cuda.synchronize()
    reset_counters()
    result = tts.batch_synthesize(texts[:1], pts[:1], pcs[:1])[0]
    launches, plain = read_counters(), plain_calls()
    if len(result.codes) != max_new or not np.isfinite(result.waveform).all():
        fail(f'large (4 beams): {len(result.codes)} frames')
    if plain or step_launches(launches) != {'fused_decode_step': max_new} \
            or launches['fused_decode_step_chunked'] != max_new:
        fail(f'large (4 beams): {plain} plain calls, step launches '
             f'{step_launches(launches)}, {launches["fused_decode_step_chunked"]} chunked')
    t = result.timings
    emit(phase='large', run='beams4', **LARGE, num_beams=4, rows=4, S=S, chunk=chunk,
         max_audio_len=max_new, stage_s={k: t[k] for k in ('prefill', 'decode', 'nar',
                                                           'codec')},
         decode_ms_per_step=1e3 * t['decode'] / max_new, rtf=result.rtf,
         launches={k: v for k, v in launches.items() if v}, card=smi)
    greedy = ConfigValle(**LARGE, max_audio_len=GREEDY_STEPS, ignore_eos=True, dropout=0.0,
                         temperature=0.0, num_beams=4, kv_cache_dtype='float32',
                         matmul_precision='highest')
    ids = {}
    for route in ('kernels', 'plain_route'):
        c = greedy if route == 'kernels' else dataclasses.replace(greedy, use_fused_decode=False)
        reset_counters()
        ids[route] = ValleAR(c, params=ar_params, device='cuda').generate_batch(tokens[:1],
                                                                               pcs[:1])[0]
        counts = read_counters()
        if (route == 'kernels') != (counts['fused_decode_step_chunked'] > 0):
            fail(f'large (4 beams, {route}): {counts["fused_decode_step_chunked"]} '
                 'chunked launches')
    if not torch.equal(ids['kernels'], ids['plain_route']):
        fail('large (4 beams): greedy IDs through the chunked kernels differ from the plain '
             'route')
    emit(phase='greedy', path='large_beams4', dtype='float32', steps=GREEDY_STEPS, rows=4,
         equal=True, first_tokens=ids['kernels'][:8].tolist(), card=smi)
    return launches


def phase_large_kernels(results: dict):
    """#6 and #7 at the 204M widths (d 1024, 16 heads, dff 4096, 16 layers)
    against their plain versions, the shapes the large phase gives them: #6
    at 4 rows (4 beams), S 1024 in chunks of 512, and at one row, S 896
    whole; #7 at one row x K=4, S 900.  Index mid-utterance (ttm + pm +
    256).  Held in f32 with TF32 off (through 16 layers bf16 rounding alone
    walks past the bf16 tolerance), timed in bf16, the large phase's type."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init

    dev = torch.device('cuda')
    L, d, h, dff = (LARGE[k] for k in ('num_layers', 'd_model', 'n_heads',
                                      'dim_feedforward'))
    ttm, pm, max_new, K = STREAM['ttm'], STREAM['pm'], SLICE['max_new'], SPEC['K']
    gen = torch.Generator().manual_seed(13)
    tl, cl = slice_lengths(dev)
    p32 = map_tree(lambda a: a.to(dev).contiguous(),
                   transformer_init(gen, L, d, h, dff, adaptive_norm=False))
    p = map_tree(lambda a: a.to(torch.bfloat16).contiguous(), p32)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for name, rows, q, total in (('fused_decode_step_chunked', 4, 1, ttm + pm + max_new),
                                     ('fused_decode_step', 1, 1, ttm + pm + max_new),
                                     ('fused_verify_step', 1, K, ttm + pm + max_new + K)):
            S = fd.padded_cache_len(total, rows, d, h, torch.bfloat16)
            chunked = fd.chunk_for(S, rows, d, h, torch.bfloat16) < S
            if chunked != name.endswith('_chunked'):
                fail(f'large kernels: {name} at {rows} rows, S {S}: chunked={chunked}')
            cache = [torch.randn(L, rows, S, d, generator=gen).to(dev) for _ in range(2)]
            x = torch.randn(rows, q, d, generator=gen).to(dev)
            start = ttm + pm + 256
            if q > 1:
                index = torch.full((rows,), start, dtype=torch.int32, device=dev)
                kernel, plain = fd.fused_verify_step, fd.fused_verify_step_plain
            else:
                index = start
                kernel, plain = fd.fused_decode_step, fd.fused_decode_step_plain
            lens = (tl[:1].repeat(rows), cl[:1].repeat(rows), ttm, pm)
            # f32 with the bf16 run's chunk: the f32 cache's own would be smaller
            chunk = fd.chunk_for(S, rows, d, h, torch.bfloat16)
            c_k, c_p = (KVCache(*(a.clone() for a in cache)) for _ in range(2))
            y, _ = kernel(p32, x, h, c_k, index, *lens, chunk_override=chunk)
            y_ref, _ = plain(p32, x, h, c_p, index, *lens, chunk_override=chunk)
            torch.cuda.synchronize()
            err = check_close(f'large {name} y', y, y_ref, 'float32')
            del c_p
            x = x.bfloat16()
            c_k = KVCache(*(a.bfloat16() for a in cache))
            ms = cuda_ms(lambda: kernel(p, x, h, c_k, index, *lens))
            plain_ms = cuda_ms(lambda: plain(p, x, h, c_k, index, *lens), **PLAIN_TIMING)
            prompt_slots = rows * int(tl[0] + cl[0])
            g = start - ttm - pm + 1
            nbytes, bound_ms, bound_by = step_bound(
                p, L, d, dff, rows * q, prompt_slots + rows * (g + q - 1),
                rows * (q * int(tl[0] + cl[0]) + q * g + q * (q - 1) // 2), 2 * d * 2, 2,
                'bfloat16')
            results[(name, 'large', 'bfloat16')] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, tol=tol_str('float32') + ' (f32)')
            emit(phase='kernels', path='large', kernel=name, dtype='bfloat16',
                 shape=dict(L=L, rows=rows, K=q, S=S, chunk=chunk, d=d, h=h, dff=dff,
                            index=start),
                 err_y_f32=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, bytes=nbytes, tol=tol_str('float32'))
            del c_k, cache


def step_bound(p, L: int, d: int, dff: int, query_rows: int, read_slots: int, pairs: int,
               slot_bytes: int, x_elt: int, dtype_name: str) -> tuple[int, float, str]:
    """(bytes, ms, 'bytes' | 'operations') of a dense fused step: every weight
    byte, the slots the step reads (each row's valid ones, the new ones
    written then read) once, x and y; the projections and the (query, slot)
    pairs' two products per dim at the compute peak."""
    from valle2_tpu_torch.train import tree_leaves
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(p))
    nbytes = w_bytes + L * read_slots * slot_bytes + 2 * query_rows * d * x_elt
    flops = (query_rows * L * 2 * (4 * d ** 2 + 2 * d * dff) + L * 2 * 2 * pairs * d)
    return (nbytes, *bound(nbytes, flops, dtype_name))


def phase_chunk_kernels(results: dict):
    """The chunked branch (the split over the cache and its merge) against its
    plain version (the online softmax over the chunks) and against the
    whole-S kernel on the same inputs, in f32 (TF32 off) and bf16: #6 at one
    row and the stream phase's S (ttm 128 + pm 256 + 1024 frames, padded to
    1536, chunk 512) at the middle of the stream, and #7 at the serving
    cell's verify block (3 rows x K=4, chunk 512, S padded from 901 to 1024,
    row 1's block straddling slot 512).  CUDA-event times of all three, the
    bound; no one PyTorch call computes the step."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree, transformer_init

    dev = torch.device('cuda')
    s, st = SLICE, STREAM
    gen = torch.Generator().manual_seed(11)
    tl, cl = slice_lengths(dev)
    chunk = st['chunk']
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            p = transformer_init(gen, s['L'], s['d'], s['h'], s['dff'], adaptive_norm=False)
            p = map_tree(lambda a: a.to(dev, dt).contiguous(), p)
            cases = {
                'fused_decode_step_chunked': dict(
                    rows=1, K=1, total=st['ttm'] + st['pm'] + st['max_new'], ttm=st['ttm'],
                    pm=st['pm'], index=st['ttm'] + st['pm'] + st['max_new'] // 2),
                'fused_verify_step_chunked': dict(
                    rows=SPEC['rows'], K=SPEC['K'],
                    total=s['ttm'] + s['pm'] + s['max_new'] + SPEC['K'], ttm=s['ttm'],
                    pm=s['pm'], offsets=(100, chunk - 2 - s['ttm'] - s['pm'], 203))}
            for name, c in cases.items():
                rows, K, ttm, pm = c['rows'], c['K'], c['ttm'], c['pm']
                S = fd.padded_cache_len(c['total'], rows, s['d'], s['h'], dt, chunk)
                verify = K > 1
                if verify:
                    index = torch.tensor([ttm + pm + o for o in c['offsets']],
                                         dtype=torch.int32, device=dev)
                    starts = index.tolist()
                    kernel, plain = fd.fused_verify_step, fd.fused_verify_step_plain
                else:
                    index = c['index']
                    starts = [index]
                    kernel, plain = fd.fused_decode_step, fd.fused_decode_step_plain
                if fd.chunk_for(S, rows, s['d'], s['h'], dt) != S:
                    fail(f'{name}: the whole-S kernel does not take S={S}')
                cache = [torch.randn(s['L'], rows, S, s['d'], generator=gen).to(dev, dt)
                         for _ in range(2)]
                x = torch.randn(rows, K, s['d'], generator=gen).to(dev, dt)
                args = (tl[:rows], cl[:rows], ttm, pm)
                c_k, c_p, c_w = (KVCache(*(a.clone() for a in cache)) for _ in range(3))
                y, _ = kernel(p, x, s['h'], c_k, index, *args, chunk_override=chunk)
                y_ref, _ = plain(p, x, s['h'], c_p, index, *args, chunk_override=chunk)
                y_w, _ = kernel(p, x, s['h'], c_w, index, *args)
                torch.cuda.synchronize()
                errs = [check_close(f'{name} y', y, y_ref, dtype_name),
                        check_close(f'{name} whole-S y', y_w, y_ref, dtype_name),
                        *(check_close(f'{name} cache', a, b, dtype_name)
                          for a, b in zip(c_k[:2], c_p[:2]))]
                ms = cuda_ms(lambda: kernel(p, x, s['h'], c_k, index, *args,
                                            chunk_override=chunk))
                whole_ms = cuda_ms(lambda: kernel(p, x, s['h'], c_w, index, *args))
                host_ms = {label: enqueue_ms(lambda: kernel(p, x, s['h'], cc, index, *args,
                                                            chunk_override=co))
                           for label, cc, co in (('chunked', c_k, chunk), ('whole', c_w, None))}
                plain_ms = cuda_ms(lambda: plain(p, x, s['h'], c_p, index, *args,
                                                 chunk_override=chunk), **PLAIN_TIMING)
                prompt_slots = int((tl[:rows] + cl[:rows]).sum())
                gen_slots = [i - ttm - pm + 1 for i in starts]
                read = prompt_slots + sum(g + K - 1 for g in gen_slots)
                pairs = K * prompt_slots + sum(K * g + K * (K - 1) // 2 for g in gen_slots)
                nbytes, bound_ms, bound_by = step_bound(
                    p, s['L'], s['d'], s['dff'], rows * K, read, pairs,
                    2 * s['d'] * cache[0].element_size(), x.element_size(), dtype_name)
                results[(name, dtype_name)] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, library_ms=None, tol=tol_str(dtype_name),
                    whole_s_ms=whole_ms)
                emit(phase='kernels', path='chunked', kernel=name, dtype=dtype_name,
                     shape=dict(L=s['L'], rows=rows, K=K, S=S, chunk=chunk, d=s['d'],
                                h=s['h'], dff=s['dff'], index=starts),
                     blocks_per_layer=dict(chunked=rows * K * s['h'] * (S // chunk),
                                           whole=rows * K * s['h']),
                     err=max(errs), ms=ms, whole_s_ms=whole_ms, host_enqueue_ms=host_ms,
                     plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                     tol=tol_str(dtype_name))


def stream_requests():
    """The stream phase's requests: phase main's, as (tokens, prompt codes)."""
    import numpy as np
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    texts, pts, pcs = make_requests()
    tok = PhonemeTokenizer()
    return texts, pts, pcs, [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]


def phase_stream(smi: str) -> dict:
    """Streaming synthesis at the serving model's default max_audio_len
    (1024, bf16): STREAM['requests'] requests through synthesize_streaming
    (chunk_frames 75, lookahead 38, ignore_eos).  The streaming model forces
    the 512-slot chunk; counts zeroed before, read after: the fused step and
    its chunked branch on every step, no plain version.  Time to first
    audio, the chunks' walls, decode ms per step beside one-beam decodes
    unchunked and chunked in the same call, RTF.  Then ``stream_parity``.
    Returns the launch counts of the streams."""
    import dataclasses
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.tts import StageClock, ValleTTS

    n = STREAM['max_new']
    cfg = ConfigValle(max_audio_len=n, ignore_eos=True, dropout=0.0, dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs, tokens = stream_requests()
    texts, pts, pcs = (x[:STREAM['requests']] for x in (texts, pts, pcs))
    kw = dict(chunk_frames=STREAM['chunk_frames'], lookahead_frames=STREAM['lookahead'])
    next(tts.synthesize_streaming(texts[0], pts[0], pcs[0], **kw))     # warm-up: a chunk
    if tts._stream_ar.config.decode_chunk != STREAM['chunk']:
        fail(f'stream: the streaming model took decode_chunk '
             f'{tts._stream_ar.config.decode_chunk}, not {STREAM["chunk"]}')
    torch.cuda.synchronize()
    reset_counters()
    runs = []
    for text, pt, pc in zip(texts, pts, pcs):
        t0 = time.perf_counter()
        stream = tts.synthesize_streaming(text, pt, pc, **kw)
        chunks = list(stream)
        wall = time.perf_counter() - t0
        total = np.concatenate(chunks)
        if total.shape != (n * 320,) or not np.isfinite(total).all():
            fail(f'stream: {total.shape} samples for {n} frames')
        runs.append((wall, stream, len(chunks)))
    launches, plain = read_counters(), plain_calls()
    require_launches('stream', launches, ('flash_attention_fwd', 'fused_decode_step',
                                          'fused_decode_step_chunked'))
    steps = len(texts) * n
    if plain or step_launches(launches) != {'fused_decode_step': steps} \
            or launches['fused_decode_step_chunked'] != steps:
        fail(f'stream: {plain} plain calls, step launches {step_launches(launches)}, '
             f'{launches["fused_decode_step_chunked"]} chunked, for {steps} steps')
    # One-beam decodes of request 0, whole-S and chunked.
    decode_ms = {}
    for c in (0, STREAM['chunk']):
        model = ValleAR(dataclasses.replace(cfg, num_beams=1, decode_chunk=c),
                        params=tts.ar.params, device='cuda')
        model.generate_batch(tokens[:1], pcs[:1])
        clock = StageClock('cuda')
        model.generate_batch(tokens[:1], pcs[:1], clock=clock)
        decode_ms.setdefault('chunked' if c else 'whole_s', []).append(
            1e3 * clock.times['decode'] / n)
    # the profiles at 256 steps: a cache of 640 slots whole, or 1024 in chunks
    profiles = {label: profile_decode(
        ValleAR(dataclasses.replace(cfg, num_beams=1, decode_chunk=c,
                                    max_audio_len=STREAM['profile_steps']),
                params=tts.ar.params, device='cuda'), texts, pts, pcs)
        for label, c in (('whole_s', 0), ('chunked', STREAM['chunk']))}
    audio_s = n * 320 / 24000
    emit(phase='stream', requests=len(texts), max_audio_len=n, forced_chunk=STREAM['chunk'],
         chunk_frames=kw['chunk_frames'], lookahead_frames=kw['lookahead_frames'],
         first_audio_s=[st.first_audio_s for _, st, _ in runs],
         chunks=[k for _, _, k in runs],
         chunk_wall_s=dict(median=float(np.median([w for _, st, _ in runs
                                                   for w in st.chunk_s])),
                           max=max(w for _, st, _ in runs for w in st.chunk_s),
                           first_request=runs[0][1].chunk_s),
         stage_s=[dict(st.clock.times) for _, st, _ in runs],
         stream_decode_ms_per_step=[1e3 * st.clock.times['decode'] / n for _, st, _ in runs],
         one_beam_decode_ms_per_step=decode_ms, one_beam_decode_profile=profiles,
         wall_s=[w for w, _, _ in runs], rtf=[w / audio_s for w, _, _ in runs],
         launches={k: v for k, v in launches.items() if v}, plain_calls=plain, card=smi)
    stream_parity(smi)
    return launches


def stream_parity(smi: str):
    """f32, TF32 off, temperature 0, at max_audio_len 1024 (the forced chunk
    512, the cache 1536 slots): (1) the streamed tokens of 300 steps in
    segments of 75 == one advance of 300 == the plain route
    (use_fused_decode=False); (2) lookahead >= max_audio_len gives one
    emission, synthesize_fused's waveform within TOL's f32 tolerance, and
    the fused codes' first codebook starts with (1)'s tokens; (3) at
    max_audio_len STREAM['longform_max_new'] (the chained prompt then stays
    under max_chain_frames, so carry 'chain' conditions on the sentence
    before): synthesize_longform over three sentences with carry 'prompt' ==
    each sentence streamed alone, and with carry 'chain' its first
    sentence's chunks == prompt mode's, every chunk finite."""
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import split_sentences
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.models.ar import DecodeStream
    from valle2_tpu_torch.tts import ValleTTS

    n, steps = STREAM['max_new'], 300
    cfg = ConfigValle(max_audio_len=n, ignore_eos=True, dropout=0.0, temperature=0.0,
                      num_beams=1, kv_cache_dtype='float32', matmul_precision='highest')
    tts = ValleTTS(cfg, device='cuda')
    model = tts._ensure_stream_models()
    texts, pts, pcs, tokens = stream_requests()
    reset_counters()
    seg = DecodeStream(model, tokens[0], pcs[0])
    ids_seg = []
    while seg.steps_done < steps:
        ids_seg.extend(seg.advance(75))
    one = DecodeStream(model, tokens[0], pcs[0]).advance(steps)
    launches = read_counters()
    cache = seg._state.cache
    chunk = fd.cache_chunk(cache, cfg.n_heads, model.config.decode_chunk)
    if (cache.k.shape[2], chunk) != (1536, STREAM['chunk']) \
            or launches['fused_decode_step_chunked'] != 2 * steps:
        fail(f'stream parity: S {cache.k.shape[2]}, chunk {chunk}, '
             f'{launches["fused_decode_step_chunked"]} chunked launches for {2 * steps} steps')
    plain_model = ValleAR(dataclasses.replace(model.config, use_fused_decode=False),
                          params=model.params, device='cuda')
    plain = DecodeStream(plain_model, tokens[0], pcs[0]).advance(steps)
    if not (np.array_equal(ids_seg, one) and np.array_equal(one, plain)):
        fail('stream parity: segmented, one-advance and plain-route tokens differ')
    fused = tts.synthesize_fused(texts[0], pts[0], pcs[0])
    full = list(tts.synthesize_streaming(texts[0], pts[0], pcs[0], chunk_frames=75,
                                         lookahead_frames=n))
    if len(full) != 1 or not np.array_equal(fused.codes[:steps, 0], one):
        fail(f'stream parity: {len(full)} emissions with full lookahead, or the fused '
             'codes differ from the stream')
    err_full = check_close('full-lookahead stream', torch.from_numpy(full[0]),
                           torch.from_numpy(fused.waveform), 'float32')
    text3 = ' '.join(texts)
    sentences = split_sentences(text3)
    kw = dict(chunk_frames=64, lookahead_frames=STREAM['lookahead'])
    tts = ValleTTS(dataclasses.replace(cfg, max_audio_len=STREAM['longform_max_new']),
                   ar=tts.ar, nar=tts.nar, codec=tts.codec, device='cuda')
    streamed = [list(tts.synthesize_streaming(sent, pts[0], pcs[0], **kw))
                for sent in sentences]
    per_sentence = [c for chunks in streamed for c in chunks]
    prompt_mode = list(tts.synthesize_longform(text3, pts[0], pcs[0], carry='prompt', **kw))
    chain_mode = list(tts.synthesize_longform(text3, pts[0], pcs[0], carry='chain', **kw))
    if len(sentences) != 3 or len(prompt_mode) != len(per_sentence):
        fail(f'stream parity: {len(sentences)} sentences, {len(prompt_mode)} long-form '
             f'chunks against {len(per_sentence)} streamed')
    err_long = max(check_close('long-form prompt mode', torch.from_numpy(a),
                               torch.from_numpy(b), 'float32')
                   for a, b in zip(prompt_mode, per_sentence))
    first = len(streamed[0])
    if not all(np.array_equal(a, b) for a, b in zip(chain_mode[:first], prompt_mode[:first])) \
            or not all(np.isfinite(c).all() for c in chain_mode):
        fail('stream parity: chain mode parts from prompt mode in its first sentence')
    emit(phase='stream', check='parity', dtype='float32', steps=steps,
         tokens_equal=True, full_lookahead_err=err_full, longform_prompt_err=err_long,
         longform_chunks=len(prompt_mode), chain_chunks=len(chain_mode),
         chain_samples=sum(len(c) for c in chain_mode),
         prompt_samples=sum(len(c) for c in prompt_mode), card=smi)


def phase_per_row_kernels(results: dict):
    """#6 with a (rows,) per-row index (continuous batching) against its plain
    version on the same inputs, every weight x cache variant, whole-S and
    chunked (chunk 128), f32 (TF32 off) and bf16: 8 rows at the depths of
    PER_ROW, one frozen at slot S (it writes nothing; its cache row must not
    change).  CUDA-event times of the per-row kernel, of the scalar-index #6
    on the same inputs (every row at the middle depth) and of the plain
    version; the bound.  No one PyTorch call computes the step."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache

    dev = torch.device('cuda')
    s, pr = SLICE, PER_ROW
    rows, S, ttm, pm = len(pr['depths']), pr['S'], pr['ttm'], pr['pm']
    gen = torch.Generator().manual_seed(21)
    tl = torch.tensor(pr['tokens_lens'], dtype=torch.int32, device=dev)
    cl = torch.tensor(pr['codes_lens'], dtype=torch.int32, device=dev)
    index = torch.tensor([ttm + pm + g for g in pr['depths']], dtype=torch.int32, device=dev)
    frozen = pr['depths'].index(S - ttm - pm)
    scalar = ttm + pm + pr['depths'][4]
    args = (tl, cl, ttm, pm)
    read = int((tl + cl).sum()) + sum(min(int(i), S - 1) - ttm - pm + 1 for i in index)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            for variant in VERIFY_VARIANTS:
                p, cache = quant_step_inputs(variant, dt, gen, dev, rows=rows, S=S)
                x = torch.randn(rows, 1, s['d'], generator=gen).to(dev, dt)
                for chunk in (None, pr['chunk']):
                    base = 'fused_decode_step_per_row' + ('_chunked' if chunk else '')
                    name = step_name(base, variant)
                    if fd.cache_chunk(cache, s['h'], chunk) != (chunk or S):
                        fail(f'{name}: S={S} does not take chunk {chunk or S}')
                    c_k, c_p, c_s = (KVCache(*(c.clone() for c in cache if c is not None))
                                     for _ in range(3))
                    y, _ = fd.fused_decode_step(p, x, s['h'], c_k, index, *args,
                                                chunk_override=chunk)
                    y_ref, _ = fd.fused_decode_step_plain(p, x, s['h'], c_p, index, *args,
                                                          chunk_override=chunk)
                    torch.cuda.synchronize()
                    err_y, err_c, extra = hold_variant(name, variant, dtype_name, y, y_ref,
                                                       c_k, c_p)
                    if not all(torch.equal(a[:, frozen], b[:, frozen])
                               for a, b in zip(c_k, cache) if a is not None):
                        fail(f'{name} ({dtype_name}): the row frozen at S wrote its cache')
                    ms = cuda_ms(lambda: fd.fused_decode_step(p, x, s['h'], c_k, index, *args,
                                                              chunk_override=chunk))
                    scalar_ms = cuda_ms(lambda: fd.fused_decode_step(
                        p, x, s['h'], c_s, scalar, *args, chunk_override=chunk))
                    plain_ms = cuda_ms(lambda: fd.fused_decode_step_plain(
                        p, x, s['h'], c_p, index, *args, chunk_override=chunk),
                                       **PLAIN_TIMING)
                    nbytes, bound_ms, bound_by = variant_bound(p, variant, dtype_name, cache,
                                                               rows, read, x.element_size())
                    tol = variant_tol(variant, dtype_name)
                    results[(name, dtype_name)] = dict(
                        max_abs_err=max(err_y, err_c), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                        tol=tol_str(dtype_name, tol), scalar_index_ms=scalar_ms)
                    emit(phase='kernels', path='per_row', kernel=name, variant=variant,
                         dtype=dtype_name, cache=str(cache.k.dtype).replace('torch.', ''),
                         shape=dict(L=s['L'], rows=rows, S=S, chunk=chunk or S, d=s['d'],
                                    h=s['h'], dff=s['dff'], index=index.tolist()),
                         err_y=err_y, err_cache=err_c, ms=ms, scalar_index_ms=scalar_ms,
                         plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         bytes=nbytes, tol=tol_str(dtype_name, tol), **extra)
                del p, cache


def persistent_case_inputs(case: str, variant: str, dt, gen, dev):
    """(p, cache, x, index, (tokens_lens, codes_lens, ttm, pm), heads, read
    slots) of a PERSISTENT_CASES case in ``variant``'s formats; index a
    (rows,) int32 tensor (per-row cases) or one int."""
    import torch
    c = PERSISTENT_CASES[case]
    widths = (dict(L=LARGE['num_layers'], d=LARGE['d_model'], h=LARGE['n_heads'],
                   dff=LARGE['dim_feedforward']) if c['large'] else {})
    w = {**SLICE, **widths}
    rows = c['rows']
    if c['per_row']:
        pr = PER_ROW
        ttm, pm = pr['ttm'], pr['pm']
        tl = torch.tensor(pr['tokens_lens'], dtype=torch.int32, device=dev)
        cl = torch.tensor(pr['codes_lens'], dtype=torch.int32, device=dev)
        index = torch.tensor([ttm + pm + g for g in pr['depths']], dtype=torch.int32,
                             device=dev)
        depths = [int(i) for i in index]
    else:
        ttm, pm = (STREAM['ttm'], STREAM['pm']) if case == 'stream' else (SLICE['ttm'],
                                                                          SLICE['pm'])
        tl0, cl0 = slice_lengths(dev)
        tl = tl0.repeat_interleave(4)[:rows].contiguous()
        cl = cl0.repeat_interleave(4)[:rows].contiguous()
        index = ttm + pm + {'stream': 700, '204m': 300, '204m_beams': 300}.get(case, 100)
        depths = [index] * rows
    p, cache = quant_step_inputs(variant, dt, gen, dev, rows=rows, S=c['S'], widths=widths)
    S = cache.k.shape[2]
    x = torch.randn(rows, 1, w['d'], generator=gen).to(dev, dt)
    read = int((tl + cl).sum()) + sum(min(i, S - 1) - ttm - pm + 1 for i in depths)
    return p, cache, x, index, (tl, cl, ttm, pm), w['h'], read


def verify_case_inputs(case: str, variant: str, dt, gen, dev):
    """(p, cache, x, index, (tokens_lens, codes_lens, ttm, pm), heads, read
    slots, (query, slot) pairs) of a PERSISTENT_VERIFY case in ``variant``'s
    formats: a (rows, K, d) block at per-row start slots ttm + pm + offset
    (a (rows,) int32 tensor), the lengths of phase main's requests."""
    import torch
    c = PERSISTENT_VERIFY[case]
    widths = (dict(L=LARGE['num_layers'], d=LARGE['d_model'], h=LARGE['n_heads'],
                   dff=LARGE['dim_feedforward']) if c['large'] else {})
    w = {**SLICE, **widths}
    rows, K = c['rows'], c['K']
    ttm, pm = c['geometry']
    tl, cl = (t[:rows].contiguous() for t in slice_lengths(dev))
    index = torch.tensor([ttm + pm + o for o in c['offsets']], dtype=torch.int32, device=dev)
    p, cache = quant_step_inputs(variant, dt, gen, dev, rows=rows, S=c['S'], widths=widths)
    x = torch.randn(rows, K, w['d'], generator=gen).to(dev, dt)
    # Query i of row r attends tl + pl + (index - ttm - pm + 1 + i) slots; a
    # row's slots are read once (the last query's range, the block's own
    # slots included: written, then read).
    prompt = int((tl + cl).sum())
    gen_slots = [o + 1 for o in c['offsets']]
    read = prompt + sum(g + K - 1 for g in gen_slots)
    pairs = K * prompt + sum(K * g + K * (K - 1) // 2 for g in gen_slots)
    return p, cache, x, index, (tl, cl, ttm, pm), w['h'], read, pairs


def verify_bound(p, variant: str, dtype_name: str, cache, h: int, query_rows: int,
                 read_slots: int, pairs: int, x_elt: int) -> tuple[int, float, str]:
    """(bytes, ms, 'bytes' | 'operations') of one verify pass (#7) of
    ``variant``: every weight byte, each row's valid slots (k/v and int8
    scales; the block's own, written then read) once, x and y; products at
    the int8 (W8A8) or compute peak, the (query, slot) pairs' attention at
    the compute peak."""
    from valle2_tpu_torch.train import tree_leaves
    L, _, _, d = cache.k.shape
    dff = p['ffn']['lin1'][next(k for k in ('w', 'q', 'q4') if k in p['ffn']['lin1'])].shape[-1]
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(p))
    slot_bytes = 2 * d * cache.k.element_size() + (2 * h * 2 if cache.k_scale is not None
                                                   else 0)
    nbytes = w_bytes + L * read_slots * slot_bytes + 2 * query_rows * d * x_elt
    proj_ops = query_rows * L * 2 * (4 * d ** 2 + 2 * d * dff)
    attn_ops = L * 2 * 2 * pairs * d
    t_ops = (proj_ops / PEAK_FLOPS['int8' if variant.startswith('w8a8') else dtype_name]
             + attn_ops / PEAK_FLOPS[dtype_name])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return nbytes, 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def step_phases(fn, L: int, blocks: int, phases=None, tp_devices=None):
    """One persistent launch (#6 or #7: fn) with its phase trace on
    (fd.set_step_trace), ``phases`` its phases a layer (the plan's: five,
    or six for #7 over an int8 cache; seven or eight for the TP step): per
    phase, summed over the L layers, in ms: work, the slowest block's time
    from its own exit of the previous barrier to the end of its share of the
    phase; mean_block, the mean block's; wake, the spread of the blocks'
    exits from the previous barrier; barrier, from the last block's end of
    the phase to the first block's exit; and the whole launch.  With
    ``tp_devices`` (one device per card group) fn is a TP step: a list of
    one such breakdown per card, each from that card's own %globaltimer."""
    import torch
    from valle2_tpu_torch.kernels import fused_decode as fd
    phases = phases or fd.STEP_PHASES
    n = len(phases) * L
    devs = tp_devices or ['cuda']
    bufs = [torch.zeros(1 + 2 * n * blocks, dtype=torch.int64, device=d) for d in devs]
    torch.cuda.synchronize()
    fd.set_step_trace(bufs if tp_devices else bufs[0], tp=bool(tp_devices))
    try:
        fn()
        for d in devs:
            torch.cuda.synchronize(d)
    finally:
        fd.set_step_trace(None, tp=bool(tp_devices))
    out = [phase_breakdown(b, phases, L, blocks) for b in bufs]
    return out if tp_devices else out[0]


def phase_breakdown(buf, phases, L: int, blocks: int) -> dict:
    """step_phases' breakdown of one launch's trace buffer."""
    import torch
    npl = len(phases)
    n = npl * L
    t = buf.cpu().double()
    start = t[0]
    ends = t[1:1 + n * blocks].view(n, blocks)
    exits = t[1 + n * blocks:].view(n, blocks)
    if not (start > 0 and bool((exits > 0).all()) and bool((ends > 0).all())):
        fail('the persistent step recorded no phase trace')
    prev = torch.cat([torch.full((1, blocks), float(start), dtype=t.dtype), exits[:-1]])
    own = ends - prev
    out = {}
    for i, name in enumerate(phases):
        k = slice(i, n, npl)
        out[name] = dict(
            work_ms=float(own[k].max(dim=1).values.sum()) / 1e6,
            mean_block_ms=float(own[k].mean(dim=1).sum()) / 1e6,
            wake_ms=float((prev[k].max(dim=1).values - prev[k].min(dim=1).values).sum()) / 1e6,
            barrier_ms=float((exits[k].min(dim=1).values - ends[k].max(dim=1).values).sum())
            / 1e6)
    out['launch_ms'] = float(exits[-1].max() - start) / 1e6
    out['barriers'] = n
    out['barrier_ms_each'] = float((exits.min(dim=1).values
                                    - ends.max(dim=1).values).mean()) / 1e6
    return out


def phase_persistent_kernels(results: dict):
    """The persistent #6 and #7 (one cooperative launch a step each) against
    the phased twin on the same inputs (fused_verify_step_phased; for #6 a
    block of one token at the same start slots): y and the whole cache bit
    for bit, in every case of PERSISTENT_CASES (#6: every weight x cache
    variant, whole-S and chunked, the scalar and the per-row index, the
    serving, stream and 204M widths) and PERSISTENT_VERIFY (#7: the spec
    cell in every variant, its chunked run, the 204M spec block), f32 with
    TF32 off and bf16.  CUDA-event times of both (median of 30), their host
    enqueue and the wrapper's host checks, the bound, the launcher's grid
    against the host plan, and the phase trace (#6 dense and W8A8 + int8
    cache; #7 dense, int8 cache and W8A8 + int8 cache).  phase_step_profile
    shows one device kernel a step on every path."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(31)
    cases = [(case, c, 1) for case, c in PERSISTENT_CASES.items()]
    cases += [(case, c, c['K']) for case, c in PERSISTENT_VERIFY.items()]
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for case, c, K in cases:
            for dtype_name in c['dtypes']:
                dt = getattr(torch, dtype_name)
                for variant in c['variants']:
                    if K > 1:
                        p, cache, x, index, args, h, read, pairs = verify_case_inputs(
                            case, variant, dt, gen, dev)
                        slots, step, name = index, fd.fused_verify_step, 'fused_verify_step'
                    else:
                        p, cache, x, index, args, h, read = persistent_case_inputs(
                            case, variant, dt, gen, dev)
                        slots = (index if torch.is_tensor(index) else
                                 torch.full((x.shape[0],), index, dtype=torch.int32,
                                            device=dev))
                        step, name = fd.fused_decode_step, 'fused_decode_step'
                    rows = x.shape[0]
                    kw = dict(chunk_override=c['chunk'])
                    c_a, c_b = (KVCache(*(t.clone() for t in cache if t is not None))
                                for _ in range(2))

                    def persistent(c_a=c_a, p=p, x=x, h=h, index=index, args=args, kw=kw,
                                   step=step):
                        return step(p, x, h, c_a, index, *args, **kw)

                    def phased(c_b=c_b, p=p, x=x, h=h, slots=slots, args=args, kw=kw):
                        return fd.fused_verify_step_phased(p, x, h, c_b, slots, *args, **kw)

                    chunk = fd.cache_chunk(cache, h, c['chunk'])
                    fmt = fd.weight_format(p)
                    L, d, dff = cache.k.shape[0], x.shape[-1], p['ffn']['lin1'][fmt].shape[-1]
                    plan = fd.persistent_plan(L, rows, d, dff, h, cache.k.shape[2], chunk, fmt,
                                              q_len=K, kv8=cache.k_scale is not None)
                    grid = fd.step_grid(dt, cache.k.dtype, fmt, d // h, d, dff)
                    label = f"persistent #{7 if K > 1 else 6} ({case}, {variant}"
                    if grid[0] < 1 or grid[1] != plan['smem_bytes']:
                        fail(f'{label}): the launcher sizes {grid} (blocks, shared bytes), '
                             f"the plan {plan['smem_bytes']} bytes")
                    y_a, _ = persistent()
                    y_b, _ = phased()
                    torch.cuda.synchronize()
                    same = torch.equal(y_a, y_b) and all(
                        torch.equal(a, b) for a, b in zip(c_a, c_b) if a is not None)
                    if not same:
                        fail(f'{label}, {dtype_name}): differs from the phased twin by '
                             f'{(y_a.float() - y_b.float()).abs().max().item():.3e} in y')
                    ms, phased_ms = cuda_ms(persistent), cuda_ms(phased)
                    traced = ('dense', 'w8a8_kv8') + (('kv8',) if K > 1 else ())
                    phases = (step_phases(persistent, L, grid[0], plan['phases'])
                              if variant in traced else None)
                    enq, enq_phased = enqueue_ms(persistent), enqueue_ms(phased)
                    # the wrapper's host checks and allocations alone, no launch
                    checks_ms = enqueue_ms(lambda: fd._checked_launch_args(
                        name, p, x, h, c_a, K, args[0], args[1], c['chunk']))
                    if K > 1:
                        nbytes, bound_ms, bound_by = verify_bound(
                            p, variant, dtype_name, cache, h, rows * K, read, pairs,
                            x.element_size())
                    else:
                        nbytes, bound_ms, bound_by = variant_bound(
                            p, variant, dtype_name, cache, rows, read, x.element_size())
                    r = dict(ms=ms, phased_ms=phased_ms, enqueue_ms=enq,
                             phased_enqueue_ms=enq_phased, host_checks_ms=checks_ms,
                             bound_ms=bound_ms,
                             bound_by=bound_by, bit_equal=True, phases=phases)
                    results[('persistent', case, variant, dtype_name)] = r
                    emit(phase='kernels', path='persistent', kernel=name, case=case,
                         variant=variant, dtype=dtype_name,
                         cache=str(cache.k.dtype).replace('torch.', ''),
                         shape=dict(L=L, rows=rows, K=K, S=cache.k.shape[2], chunk=chunk, d=d,
                                    h=h, dff=dff, index=index.tolist() if torch.is_tensor(index)
                                    else index),
                         grid=dict(blocks=grid[0], smem_bytes=grid[1]),
                         plan=plan, bytes=nbytes, **r)
                    del p, cache, c_a, c_b


def kernel_label(name: str) -> str:
    """A device kernel's name without its namespace and parameter list, the
    template arguments kept (a projection's MODE: 0 QKV, 1 OUT, 2 FFN1, 3 FFN2)."""
    import re
    m = re.search(r'(\w+)(<[^()]*>)?\(', name)
    return (m.group(1) + (m.group(2) or '')) if m else name[:80]


def step_profile(label: str, fn, tp: bool = False) -> dict:
    """torch.profiler over fn() (a decode through the fused step, warmed up
    first): per launch of #6 or #7 (their counters; ``tp``: the TP steps'),
    the device kernels of the step (STEP_KERNELS: 1 for the persistent
    step), its device time, its span on
    the device (first start to last end of each run of step kernels, one run
    a step) and the gaps inside the span; the device's busy share of the
    wall (the union of every kernel's interval), the step's kernels by
    name, and the all-reduce 5c's kernels in the whole profile."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch.kernels import fused_decode as fd

    def launches():
        if tp:
            return sum(c.count for c in fd.TP_COUNTERS.values())
        return sum(c.count for c in (*fd.COUNTERS.values(), *fd.VERIFY_COUNTERS.values()))
    fn()
    torch.cuda.synchronize()
    n0 = launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    n = launches() - n0
    ev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    runs, cur = [], []
    for e in ev:
        if any(k in e.name for k in STEP_KERNELS):
            cur.append(e)
        elif cur:
            runs.append(cur)
            cur = []
    if cur:
        runs.append(cur)
    step_kernels = sum(len(r) for r in runs)
    phased = sum(1 for r in runs for e in r
                 if any(k in e.name for k in PHASED_KERNELS))
    allreduce = sum(1 for e in ev if 'tp_row_reduce_kernel' in e.name)
    step_dev = sum(e.time_range.elapsed_us() for r in runs for e in r) / 1e3
    spans = [(r[-1].time_range.end - r[0].time_range.start) / 1e3 for r in runs]
    busy, end = 0.0, None
    for e in ev:
        a, b = e.time_range.start, e.time_range.end
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name: dict = {}
    for r in runs:
        for e in r:
            k = kernel_label(e.name)
            cnt, ms = by_name.get(k, (0, 0.0))
            by_name[k] = (cnt + 1, ms + e.time_range.elapsed_us() / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(label=label, launches=n, step_runs=len(runs), step_kernels=step_kernels,
                phased_kernels=phased, device_kernels_per_step=step_kernels / max(n, 1),
                step_device_ms=step_dev / max(n, 1),
                step_span_ms=sum(spans) / max(len(spans), 1),
                step_gap_ms=(sum(spans) - step_dev) / max(len(spans), 1),
                wall_ms=wall_ms, device_busy_ms=busy / 1e3,
                device_busy_share=busy / 1e3 / wall_ms, allreduce_kernels=allreduce,
                step_kernels_by_name={k: {'calls': cnt, 'ms': ms} for k, (cnt, ms) in top})


def phase_step_profile(smi: str, require_one: bool = True) -> dict:
    """The token-loop profile of every single-card path's step (step_profile):
    main (the serving config: bf16, 4 beams, PROFILE_STEPS steps, 3
    requests), quant (W8A8 with the int8 cache, and W4A16; PROFILE_STEPS),
    stream (one row through the chunked branch: PROFILE_PATHS' steps and
    forced chunk), cb (a ContinuousDecoder of 4 sessions: the per-row index,
    PROFILE_PATHS' joint advances), clone (ValleTTS.__call__ on a 3 s prompt
    recording, one beam, PROFILE_STEPS), hub (a StreamHub of two sessions
    from their own threads), large (the 204M stack, one row, PROFILE_PATHS'
    steps); and the speculative loops through #7: spec (the serving config
    at one beam, K = 4, ngram 3, PROFILE_STEPS steps), large_spec (the 204M
    stack, one row, K = 4), cb_spec (the ContinuousDecoder's speculative
    joint loop, 4 sessions); and tp (the main config on a mesh of two virtual
    ranks: one TP step launch a step, no 5c kernel past the prefill's 2 a
    layer).  ``require_one``: fail unless every path ran one device kernel
    a step (or verify pass)
    (``record``: a phased step kernel, or more step kernels than launches,
    fails at once; fewer means the profiler lost records, and the profile
    is taken again, up to ``PROFILE_REPEATS`` times, until one shows exactly
    one a launch).  Every attempt prints its own line."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.models.continuous import ContinuousDecoder
    from valle2_tpu_torch.parallel import make_model_mesh
    from valle2_tpu_torch.stream_hub import StreamHub
    from valle2_tpu_torch.tts import ValleTTS

    texts, pts, pcs = make_requests()
    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]
    base = dict(ignore_eos=True, dropout=0.0, dtype='bfloat16')
    main = ValleAR(ConfigValle(max_audio_len=PROFILE_STEPS, **base), device='cuda')
    out = {}

    def record(label, fn, tp=False):
        for attempt in range(1 + PROFILE_REPEATS):
            t0 = time.perf_counter()
            r = out[label] = step_profile(label, fn, tp)
            emit(phase='step_profile', card=smi, attempt=attempt,
                 seconds=time.perf_counter() - t0, **r)
            if not require_one:
                return
            seen = (f'{r["step_kernels"]} step kernels ({r["phased_kernels"]} phased) '
                    f'for {r["launches"]} launches of #6 / #7'
                    + (f' (TP), {r["allreduce_kernels"]} 5c kernels' if tp else ''))
            # TP: 5c runs in the prefill alone (2 sums a layer, one kernel a
            # card a sum: the virtual ranks share one), none in the token loop
            if (r['launches'] < 1 or r['phased_kernels']
                    or r['step_kernels'] > r['launches']
                    or (tp and r['allreduce_kernels'] > 2 * SLICE['L'])):
                fail(f'step profile ({label}): {seen}')
            if r['step_kernels'] == r['launches']:
                return
        fail(f'step profile ({label}): {seen} in each of {1 + PROFILE_REPEATS} profiles')

    record('main', lambda: main.generate_batch(tokens, pcs))
    spec_kw = dict(num_beams=1, speculative_k=SPEC['K'], speculative_ngram=SPEC['ngram'])
    spec = ValleAR(ConfigValle(max_audio_len=PROFILE_STEPS, **spec_kw, **base),
                   params=main.params, device='cuda')
    record('spec', lambda: spec.generate_batch(tokens, pcs))
    for label, wd, kd in (('quant_w8a8_kv8', 'int8', 'int8'), ('quant_w4a16', 'int4',
                                                                  'bfloat16')):
        m = ValleAR(ConfigValle(max_audio_len=PROFILE_STEPS, weight_dtype=wd,
                                kv_cache_dtype=kd, **base),
                    params=main.params, device='cuda')
        record(label, lambda m=m: m.generate_batch(tokens, pcs))
    stream = ValleAR(ConfigValle(max_audio_len=PROFILE_PATHS['stream_steps'], num_beams=1,
                                 decode_chunk=PROFILE_PATHS['stream_chunk'], **base),
                     params=main.params, device='cuda')
    record('stream', lambda: stream.generate_batch(tokens[:1], pcs[:1]))
    one = ValleAR(ConfigValle(max_audio_len=SLICE['max_new'], num_beams=1, **base),
                  params=main.params, device='cuda')
    cb_texts, cb_pts, cb_pcs, cb_tokens = cb_requests(4)

    def cb_run():
        cb = ContinuousDecoder(one, n_slots=4, ttm=CB['ttm'], pm=CB['pm'])
        for t, pc in zip(cb_tokens, cb_pcs):
            cb.join(t, pc)
        for _ in range(PROFILE_PATHS['cb_advances']):
            cb.advance(CB['chunk_frames'])
    record('cb', cb_run)
    one_spec = ValleAR(ConfigValle(max_audio_len=SLICE['max_new'], **spec_kw, **base),
                       params=main.params, device='cuda')

    def cb_spec_run():
        cb = ContinuousDecoder(one_spec, n_slots=4, ttm=CB['ttm'], pm=CB['pm'],
                               speculative=True)
        for t, pc in zip(cb_tokens, cb_pcs):
            cb.join(t, pc)
        for _ in range(PROFILE_PATHS['cb_advances']):
            cb.advance(CB['chunk_frames'])
    record('cb_spec', cb_spec_run)
    # Cloning (ValleTTS.__call__: a prompt recording through the codec, then
    # the decode) and the stream hub (two sessions from their own threads).
    tts = ValleTTS(ConfigValle(max_audio_len=PROFILE_STEPS, num_beams=1, **base),
                   ar=ValleAR(ConfigValle(max_audio_len=PROFILE_STEPS, num_beams=1, **base),
                              params=main.params, device='cuda'), device='cuda')
    req = clone_requests()[0]
    record('clone', lambda: tts(*req))

    def hub_run():
        hub = StreamHub(tts, n_slots=2, chunk_frames=CB['chunk_frames'])
        try:
            hub_sessions(hub, cb_texts[:2], cb_pts[:2], cb_pcs[:2])
        finally:
            hub.stop(drain=True)
    record('hub', hub_run)
    large = ValleAR(ConfigValle(max_audio_len=PROFILE_PATHS['large_steps'], num_beams=1,
                                **LARGE, **base), device='cuda')
    record('large', lambda: large.generate_batch(tokens[:1], pcs[:1]))
    large_spec = ValleAR(ConfigValle(max_audio_len=PROFILE_PATHS['large_steps'], **LARGE,
                                     **spec_kw, **base),
                         params=large.params, device='cuda')
    record('large_spec', lambda: large_spec.generate_batch(tokens[:1], pcs[:1]))
    # The TP step on one card: two virtual ranks, one launch of both a step.
    tp = ValleAR(ConfigValle(max_audio_len=PROFILE_STEPS, **base), params=main.params,
                 mesh=make_model_mesh(TP_PROFILE_MP, ['cuda:0'] * TP_PROFILE_MP))
    record('tp', lambda: tp.generate_batch(tokens, pcs), tp=True)
    del main, spec, stream, one, one_spec, large, large_spec, tts, tp
    torch.cuda.empty_cache()
    return out


def cb_requests(n: int, seed: int = 9):
    """n requests inside the hub geometry: 48 prompt phonemes + a text (under
    128 tokens) and CB['prompt_frames'] prompt frames; (texts, prompt
    tokens, prompt codes, tokens)."""
    import numpy as np
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    rs = np.random.RandomState(seed)
    base, _, _ = make_requests()
    texts = [base[i % len(base)] for i in range(n)]
    pts = [rs.randint(0, 256, (48,)).astype(np.int64) for _ in texts]
    pcs = [rs.randint(0, 1024, (CB['prompt_frames'], 8)).astype(np.int64) for _ in texts]
    tok = PhonemeTokenizer()
    return texts, pts, pcs, [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]


def cb_arm(model, tokens, pcs, gens=None, **cb_kw) -> dict:
    """Every request joins one ContinuousDecoder (n_slots = requests), then
    advances of CB['chunk_frames'] until all finish: wall (joins included),
    the joins' prefill share, ids per session, and the per-row #6 launches
    of the arm against its fused-step launches and plain calls."""
    import numpy as np
    import torch
    from valle2_tpu_torch.models.continuous import ContinuousDecoder
    before, plain0 = read_counters(), plain_calls()
    cb = ContinuousDecoder(model, n_slots=len(tokens), ttm=CB['ttm'], pm=CB['pm'], **cb_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slots = [cb.join(t, pc, generator=None if gens is None else gens[i])
             for i, (t, pc) in enumerate(zip(tokens, pcs))]
    t1 = time.perf_counter()
    got = {sl: [] for sl in slots}
    advances = 0
    while not all(cb.finished(sl) for sl in slots):
        for sl, new in cb.advance(CB['chunk_frames']).items():
            got[sl].extend(new)
        advances += 1
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after = read_counters()
    delta = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    return dict(wall=t2 - t0, prefill=t1 - t0, decode=t2 - t1, advances=advances,
                ids=[np.asarray(got[sl]) for sl in slots], launches=delta,
                plain=plain_calls() - plain0, cache_len=cb._state.cache.k.shape[2])


def solo_arm(model, tokens, pcs, gens=None) -> dict:
    """The same requests as one-row DecodeStreams advanced round-robin by
    CB['chunk_frames'] (the path without the hub)."""
    import numpy as np
    import torch
    from valle2_tpu_torch.models.ar import DecodeStream
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = [DecodeStream(model, t, pc, None if gens is None else gens[i])
               for i, (t, pc) in enumerate(zip(tokens, pcs))]
    t1 = time.perf_counter()
    got = [[] for _ in streams]
    while not all(st.finished for st in streams):
        for i, st in enumerate(streams):
            if not st.finished:
                got[i].extend(st.advance(CB['chunk_frames']))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(wall=t2 - t0, prefill=t1 - t0, decode=t2 - t1,
                ids=[np.asarray(g) for g in got])


def first_divergence(model, cfg, tokens, pcs, got, want) -> dict | None:
    """None when every session's ids equal; else the first session and step
    where they part, with the plain route's logit gap of the two picks
    there (teacher-forced on the common prefix)."""
    import numpy as np
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if np.array_equal(g, w):
            continue
        n = min(len(g), len(w))
        k = int(np.argmax(g[:n] != w[:n])) if (g[:n] != w[:n]).any() else n
        if k == n:
            fail(f'cb: session {i} ids differ in length ({len(g)} vs {len(w)})')
        gap = teacher_forced_gap(model, cfg, tokens[i], pcs[i], torch.as_tensor(w[:k]),
                                 (int(g[k]), int(w[k])))
        return dict(session=i, step=k, pair=[int(g[k]), int(w[k])], logit_gap=gap)
    return None


def require_per_row(label: str, arm: dict, steps: int, variant: str = 'dense',
                    chunked: bool = False) -> None:
    """The arm's joint steps all launched the per-row #6 (its variant, and its
    chunked branch where the cache is chunked), never the plain version."""
    got = arm['launches']
    n = got.get('fused_decode_step_per_row', 0)
    if arm['plain'] or n < steps or got.get(step_name('fused_decode_step', variant), 0) != n \
            or got.get('fused_decode_step_per_row_chunked', 0) != (n if chunked else 0):
        fail(f'{label}: {arm["plain"]} plain calls and launches {got} for {steps} joint steps')


def phase_cb(smi: str) -> dict:
    """Continuous batching at the serving model with one beam (bf16,
    max_audio_len 512, ignore_eos) on the hub geometry: for N = 4 and 8
    sessions, round-robin solo DecodeStreams against one ContinuousDecoder
    (solo, then joint), aggregate tokens/s and ms per
    joint step; greedy ids joint == solo (or parted at a near-tie); sampled
    at N = 4 (per-row generators); one W8A8 + int8-cache joint run.  Counts
    zeroed before, read after: every joint step launched the per-row #6, no
    plain call.  Then ``cb_parity``.  Returns the launch counts."""
    import dataclasses

    import numpy as np
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR

    max_new = SLICE['max_new']
    cfg = ConfigValle(max_audio_len=max_new, ignore_eos=True, dropout=0.0, dtype='bfloat16',
                      num_beams=1)
    model = ValleAR(cfg, device='cuda')
    texts, pts, pcs, tokens = cb_requests(max(CB['sessions']))
    cb_arm(model, tokens[:2], pcs[:2])                      # warm-up
    reset_counters()
    arms, divergence = {}, {}
    for n in CB['sessions']:
        runs = {'solo': [], 'joint': []}
        for label in ('solo', 'joint'):
            arm = (solo_arm if label == 'solo' else cb_arm)(model, tokens[:n], pcs[:n])
            if label == 'joint':
                require_per_row(f'cb N={n}', arm, max_new)
            runs[label].append(arm)
        divergence[n] = first_divergence(model, cfg, tokens, pcs, runs['joint'][0]['ids'],
                                         runs['solo'][0]['ids'])
        if divergence[n] and divergence[n]['logit_gap'] > GREEDY_BF16_GAP:
            fail(f'cb N={n}: joint and solo greedy ids part away from a near-tie: '
                 f'{divergence[n]}')
        arms[f'greedy_{n}'] = runs
    sampled = ValleAR(dataclasses.replace(cfg, temperature=1.0, top_k=50), params=model.params,
                      device='cuda')

    def gens():
        import torch
        return [torch.Generator(device='cuda').manual_seed(500 + i) for i in range(4)]
    arms['sampled_4'] = {'joint': [cb_arm(sampled, tokens[:4], pcs[:4], gens())],
                         'solo': [solo_arm(sampled, tokens[:4], pcs[:4], gens())]}
    require_per_row('cb sampled', arms['sampled_4']['joint'][0], max_new)
    quant = ValleAR(dataclasses.replace(cfg, weight_dtype='int8', kv_cache_dtype='int8'),
                    params=model.params, device='cuda')
    arms['w8a8_kv8_4'] = {'joint': [cb_arm(quant, tokens[:4], pcs[:4])]}
    require_per_row('cb w8a8_kv8', arms['w8a8_kv8_4']['joint'][0], max_new, 'w8a8_kv8')
    launches = read_counters()
    for ids in [a['ids'] for runs in arms.values() for rs in runs.values() for a in rs]:
        if any(len(i) != max_new for i in ids):
            fail(f'cb: sessions of {[len(i) for i in ids]} tokens for {max_new} steps')

    def summary(a: dict, n: int) -> dict:
        return dict(tok_per_s=n * max_new / a['wall'], wall_s=a['wall'], prefill_s=a['prefill'],
                    decode_s=a['decode'], ms_per_step=1e3 * a['decode'] / max_new,
                    advances=a.get('advances'), cache_len=a.get('cache_len'))
    for key, runs in arms.items():
        n = int(key.rsplit('_', 1)[1])
        out = {label: [summary(a, n) for a in rs] for label, rs in runs.items()}
        if 'solo' in runs:
            out['joint_over_solo'] = (min(a['wall'] for a in runs['solo'])
                                      / min(a['wall'] for a in runs['joint']))
        emit(phase='cb', arm=key, sessions=n, max_audio_len=max_new,
             chunk_frames=CB['chunk_frames'], geometry=dict(ttm=CB['ttm'], pm=CB['pm']),
             greedy_divergence=divergence.get(n) if key.startswith('greedy') else None,
             card=smi, **out)
    cb_parity(smi)
    return launches


def cb_parity(smi: str):
    """f32, TF32 off, max_audio_len 256, ignore_eos, 4 rows, 6 sessions:
    two join, decode 50 steps, two more join, the first two finish and are
    released, two more reuse their rows.  Greedy ids of every session ==
    its solo DecodeStream; the speculative joint loop (K = 4) == the plain
    joint loop; sampled sessions == their solo DecodeStreams on CUDA
    generators of the same seeds, bit for bit."""
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR
    from valle2_tpu_torch.models.ar import DecodeStream
    from valle2_tpu_torch.models.continuous import ContinuousDecoder

    cfg = ConfigValle(max_audio_len=256, ignore_eos=True, dropout=0.0, temperature=0.0,
                      num_beams=1, kv_cache_dtype='float32', matmul_precision='highest')
    plain = ValleAR(cfg, device='cuda')
    _, _, pcs, tokens = cb_requests(6, seed=17)

    def gen(i):
        return torch.Generator(device='cuda').manual_seed(700 + i)

    def staggered(model, spec=False, sampled=False):
        cb = ContinuousDecoder(model, n_slots=4, ttm=CB['ttm'], pm=CB['pm'], speculative=spec)
        slot_of, ids = {}, [[] for _ in tokens]

        def join(i):
            slot_of[i] = cb.join(tokens[i], pcs[i], generator=gen(i) if sampled else None)

        def step(k, live):
            out = cb.advance(k)
            for i in live:
                ids[i].extend(out.get(slot_of[i], []))
        join(0)
        join(1)
        step(50, (0, 1))
        join(2)
        join(3)
        while not (cb.finished(slot_of[0]) and cb.finished(slot_of[1])):
            step(25, (0, 1, 2, 3))
        cb.release(slot_of[0])
        cb.release(slot_of[1])
        join(4)                    # into the released rows
        join(5)
        live = (2, 3, 4, 5)
        while not all(cb.finished(slot_of[i]) for i in live):
            step(25, live)
        return [np.asarray(x) for x in ids], cb

    reset_counters()
    joint, cb = staggered(plain)
    launches = read_counters()
    solo = [DecodeStream(plain, t, pc).advance(10 ** 4) for t, pc in zip(tokens, pcs)]
    for i, (g, w) in enumerate(zip(joint, solo)):
        if not np.array_equal(g, w):
            fail(f'cb parity: session {i} greedy ids joint != solo (f32)')
    if plain_calls() or launches['fused_decode_step_per_row'] <= 0:
        fail(f'cb parity: launches {launches}, {plain_calls()} plain calls')
    spec_model = ValleAR(dataclasses.replace(cfg, speculative_k=4, speculative_ngram=3),
                         params=plain.params, device='cuda')
    before = read_counters()['fused_verify_step']
    spec, _ = staggered(spec_model, spec=True)
    if read_counters()['fused_verify_step'] <= before:
        fail('cb parity: the speculative joint loop never launched #7')
    for i, (g, w) in enumerate(zip(spec, joint)):
        if not np.array_equal(g, w):
            fail(f'cb parity: session {i} speculative joint ids != plain joint ids')
    sampled = ValleAR(dataclasses.replace(cfg, temperature=1.0, top_k=50),
                      params=plain.params, device='cuda')
    got, _ = staggered(sampled, sampled=True)
    want = [DecodeStream(sampled, t, pc, gen(i)).advance(10 ** 4)
            for i, (t, pc) in enumerate(zip(tokens, pcs))]
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            fail(f'cb parity: sampled session {i} joint != its solo DecodeStream')
    emit(phase='cb', check='parity', dtype='float32', sessions=6, rows=4,
         max_audio_len=cfg.max_audio_len, cache_len=cb._state.cache.k.shape[2],
         greedy_equal=True, speculative_equal=True, sampled_equal=True,
         per_row_launches=launches['fused_decode_step_per_row'], card=smi)


def hub_sessions(hub, texts, pts, pcs) -> list[dict]:
    """Every request opened on the hub from its own thread, all started
    together: per session its wall, time to first audio, chunk walls and
    samples (waveform)."""
    import threading

    import numpy as np
    res, errs = [None] * len(texts), []

    def run(i):
        try:
            # The first chunk's wall runs from the open call, the prefill
            # included: the session's time to first audio.
            t0 = t = time.perf_counter()
            chunks = hub.open(texts[i], pts[i], pcs[i])
            walls, out = [], []
            for c in chunks:
                now = time.perf_counter()
                walls.append(now - t)
                out.append(c)
                t = now
            res[i] = dict(wall=time.perf_counter() - t0, first_audio=walls[0], chunk_s=walls,
                          wav=np.concatenate(out))
        except Exception as e:      # noqa: BLE001 -- reported below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(texts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    if errs or any(th.is_alive() for th in threads):
        fail(f'hub: sessions failed or hung: {errs!r}')
    if hub.errors:
        fail(f'hub: the driver thread failed: {hub.errors!r}')
    return res


def phase_hub(smi: str) -> dict:
    """StreamHub(n_slots=4, chunk_frames=25) at the serving model (bf16, one
    beam, ignore_eos, HUB: max_audio_len 512, decode_chunk 256): 4 sessions
    opened from 4 threads at once, then the first 2 requests through solo
    synthesize_streaming in turn.  Counts zeroed before, read after the hub
    run: every joint step launched the per-row #6 through its chunked
    branch, no plain call; every waveform finite and 512 * 320 long.  Each
    session's time to first audio and chunk walls, the aggregate RTF of
    both.  Then ``hub_parity``.  Returns the hub run's launch counts."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.stream_hub import StreamHub
    from valle2_tpu_torch.tts import ValleTTS

    n = HUB['max_new']
    cfg = ConfigValle(max_audio_len=n, ignore_eos=True, dropout=0.0, dtype='bfloat16',
                      num_beams=1, decode_chunk=HUB['chunk'])
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs, _ = cb_requests(HUB['sessions'], seed=13)
    hub = StreamHub(tts, n_slots=4, chunk_frames=CB['chunk_frames'])
    try:
        warm = hub.open(texts[0], pts[0], pcs[0])                   # warm-up: 3 chunks
        for _ in range(3):
            next(warm)
        warm.close()
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        runs = hub_sessions(hub, texts, pts, pcs)
        wall = time.perf_counter() - t0
        launches, plain = read_counters(), plain_calls()
    finally:
        hub.stop()
    for r in runs:
        if r['wav'].shape != (n * 320,) or not np.isfinite(r['wav']).all():
            fail(f'hub: {r["wav"].shape} samples for {n} frames')
    steps = launches['fused_decode_step_per_row']
    if plain or steps < n or launches['fused_decode_step_per_row_chunked'] != steps \
            or launches['fused_decode_step'] != steps:
        fail(f"hub: {plain} plain calls and launches {launches} for {n} steps")
    solo = []
    for text, pt, pc in list(zip(texts, pts, pcs))[:HUB['solo']]:
        t1 = time.perf_counter()
        stream = tts.synthesize_streaming(text, pt, pc, chunk_frames=CB['chunk_frames'])
        total = np.concatenate(list(stream))
        solo.append(dict(wall=time.perf_counter() - t1, first_audio=stream.first_audio_s,
                         chunk_s=stream.chunk_s, samples=total.shape[0]))
    audio_s = n * 320 / 24000
    emit(phase='hub', sessions=len(texts), n_slots=4, chunk_frames=CB['chunk_frames'],
         max_audio_len=n, cache_len=hub.cb._state.cache.k.shape[2],
         forced_chunk=tts._stream_ar.config.decode_chunk,
         first_audio_s=[r['first_audio'] for r in runs],
         chunk_wall_s=dict(median=float(np.median([w for r in runs for w in r['chunk_s']])),
                           max=max(w for r in runs for w in r['chunk_s']),
                           chunks=[len(r['chunk_s']) for r in runs]),
         session_wall_s=[r['wall'] for r in runs], wall_s=wall,
         rtf=wall / (len(runs) * audio_s),
         solo=dict(first_audio_s=[r['first_audio'] for r in solo],
                   wall_s=[r['wall'] for r in solo],
                   chunk_wall_median_s=float(np.median([w for r in solo
                                                        for w in r['chunk_s']])),
                   rtf=sum(r['wall'] for r in solo) / (len(solo) * audio_s)),
         launches={k: v for k, v in launches.items() if v}, plain_calls=plain, card=smi)
    hub_parity(smi)
    return launches


def hub_parity(smi: str):
    """f32, TF32 off, greedy, ignore_eos, max_audio_len 256 with
    decode_chunk 128 (the per-row step's chunked branch, S 512): (1) two
    concurrent hub sessions (chunk_frames 64) == their solo streams: tokens
    (codes_sink against one DecodeStream advance) exactly, waveforms within
    TOL's f32 tolerance (the joint codec batch sums in another order); (2)
    open_longform over three sentences == synthesize_longform(carry='prompt')
    on the same generator seed, chunk by chunk; (3) stop(drain=True) while a
    session streams returns its whole waveform."""
    import threading

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models.ar import DecodeStream
    from valle2_tpu_torch.stream_hub import StreamHub
    from valle2_tpu_torch.tts import ValleTTS

    cfg = ConfigValle(max_audio_len=256, decode_chunk=128, ignore_eos=True, dropout=0.0,
                      temperature=0.0, num_beams=1, kv_cache_dtype='float32',
                      matmul_precision='highest')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs, tokens = cb_requests(2, seed=19)
    kw = dict(chunk_frames=64)
    hub = StreamHub(tts, n_slots=2, **kw)
    sinks = [[], []]
    try:
        reset_counters()
        runs = [None, None]

        def run(i):
            runs[i] = np.concatenate(list(hub.open(texts[i], pts[i], pcs[i],
                                                   codes_sink=sinks[i])))
        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        launches = read_counters()
        if hub.errors or any(r is None for r in runs):
            fail(f'hub parity: sessions failed: {hub.errors!r}')
        model = tts._ensure_stream_models()
        err = 0.0
        for i in range(2):
            want_ids = DecodeStream(model, tokens[i], pcs[i]).advance(10 ** 4)
            if not np.array_equal(np.concatenate(sinks[i]), want_ids):
                fail(f'hub parity: session {i} tokens != its solo stream')
            want = np.concatenate(list(tts.synthesize_streaming(texts[i], pts[i], pcs[i],
                                                                **kw)))
            if runs[i].shape != want.shape:
                fail(f'hub parity: {runs[i].shape} samples against {want.shape}')
            err = max(err, check_close('hub waveform', torch.from_numpy(runs[i]),
                                       torch.from_numpy(want), 'float32'))
        if launches['fused_decode_step_per_row_chunked'] <= 0 or plain_calls():
            fail(f'hub parity: launches {launches}, {plain_calls()} plain calls')
        text3 = ' '.join(make_requests()[0])
        got = list(hub.open_longform(text3, pts[0], pcs[0],
                                     generator=torch.Generator(device='cuda').manual_seed(3)))
        want = list(tts.synthesize_longform(text3, pts[0], pcs[0], chunk_frames=64,
                                            generator=torch.Generator(device='cuda')
                                            .manual_seed(3)))
        if len(got) != len(want) or any(a.shape != b.shape for a, b in zip(got, want)):
            fail(f'hub parity: long-form {len(got)} chunks against {len(want)}')
        err_long = max(check_close('hub long-form', torch.from_numpy(a), torch.from_numpy(b),
                                   'float32') for a, b in zip(got, want))
        prefetched = hub.longform_prefetched
        drained = {}
        chunks = hub.open(texts[1], pts[1], pcs[1])
        consumer = threading.Thread(
            target=lambda: drained.setdefault('wav', np.concatenate(list(chunks))))
        consumer.start()
        hub.stop(drain=True)
        consumer.join(timeout=600)
        if drained.get('wav') is None or drained['wav'].shape != runs[1].shape:
            fail('hub parity: stop(drain=True) cut the live session')
    finally:
        hub.stop()
    emit(phase='hub', check='parity', dtype='float32', sessions=2,
         max_audio_len=cfg.max_audio_len, decode_chunk=cfg.decode_chunk,
         cache_len=hub.cb._state.cache.k.shape[2], tokens_equal=True, waveform_err=err,
         longform_chunks=len(got), longform_err=err_long, longform_prefetched=prefetched,
         drained_samples=int(drained['wav'].shape[0]), card=smi)


def make_requests(seed: int = 2):
    """3 requests as bench.py builds them: random prompt phonemes (48) and
    prompt codes (150 frames), different texts."""
    import numpy as np
    rs = np.random.RandomState(seed)
    texts = ['the quick brown fox jumps over the lazy dog.',
             'she sells sea shells by the sea shore.',
             'a port of the serving path to a new machine.']
    pts = [rs.randint(0, 256, (48,)).astype(np.int64) for _ in texts]
    pcs = [rs.randint(0, 1024, (150, 8)).astype(np.int64) for _ in texts]
    return texts, pts, pcs


def phase_greedy():
    import dataclasses

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    from valle2_tpu_torch.models.ar import ValleAR

    cfg = ConfigValle(max_audio_len=32, ignore_eos=True, dropout=0.0, temperature=0.0,
                      kv_cache_dtype='float32', matmul_precision='highest')
    texts, pts, pcs = make_requests()
    tok = PhonemeTokenizer()
    tokens = [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]
    kern = ValleAR(cfg, device='cuda')
    plain_cfg = dataclasses.replace(cfg, use_flash_attention=False, use_fused_decode=False)
    plain = ValleAR(plain_cfg, params=kern.params, device='cuda')
    got = kern.generate_batch(tokens, pcs)
    want = plain.generate_batch(tokens, pcs)
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            fail(f'greedy tokens through the kernels differ from the plain versions: '
                 f'{g.tolist()} vs {w.tolist()}')
    emit(phase='greedy', dtype='float32', steps=32, rows=len(texts) * cfg.num_beams,
         equal=True, first_tokens=[g[:8].tolist() for g in got])


def phase_main():
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    cfg = ConfigValle(max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                      dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs = make_requests()
    tts.batch_synthesize(texts, pts, pcs)               # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()

    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    batch = tts.batch_synthesize(texts, pts, pcs)
    single = tts.synthesize_fused(texts[0], pts[0], pcs[0])
    launches = read_counters()

    for r in batch + [single]:
        n = len(r.codes)
        if n != max_new or r.waveform.shape != (n * 320,):
            fail(f'waveform of {r.waveform.shape} for gen_len {n}')
        if not np.isfinite(r.waveform).all():
            fail('non-finite waveform samples')
    require_launches('main', launches, ('flash_attention_fwd', 'fused_decode_step'))
    t = batch[0].timings
    rows = len(texts) * cfg.num_beams
    emit(phase='main', requests=len(texts), max_audio_len=max_new, rows=rows,
         stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
         batch_wall_s=t['batched'], single_wall_s=single.timings['batched'],
         ar_tokens_per_s=len(texts) * max_new / t['decode'],
         ar_row_tokens_per_s=rows * max_new / t['decode'],
         decode_ms_per_step=1e3 * t['decode'] / max_new,
         rtf=batch[0].rtf, rtf_single=single.rtf,
         audio_s=sum(len(r.waveform) for r in batch) / 24000,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launches)
    return launches


def train_meta(b: int, tokens: int, frames: int, device, seed: int = 0):
    """Per-row lengths like a training batch's: tokens_lens in [3/4, 1] of the
    token bucket and codes_lens (frames + BOS, capped at the bucket) in
    [3/4, 1] of the frame bucket; meta = [tokens_lens, tokens + codes_lens]."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    tl = rs.randint(tokens * 3 // 4, tokens + 1, b)
    cl = rs.randint(frames * 3 // 4, frames + 1, b)
    return torch.tensor(np.stack([tl, tokens + cl], axis=1), dtype=torch.int32,
                        device=device)


def phase_train_kernels(results: dict):
    """Flash forward (#1, causal and bidirectional) and backward (#3; #4 + #5
    past FUSED_BWD_MAX_SEQ) at the training shapes against the plain versions;
    in bf16 each also timed on its CUDA-core route; each kernel with its
    share of its bound (in f32, of the FFMA bound)."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa

    dev = torch.device('cuda')
    h, hd = SLICE['h'], SLICE['hd']
    gen = torch.Generator().manual_seed(1)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.no_grad():
        for case, (b, tt, frames, causal) in TRAIN_CASES.items():
            s = tt + frames
            meta = train_meta(b, tt, frames, dev)
            mask = attend_mask(meta, s, tt, causal)
            pairs = int(mask.sum()) * h
            for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
                q, k, v, do = (torch.randn(b, h, s, hd, generator=gen).to(dev, dt)
                               for _ in range(4))
                o, lse = fa.flash_attention(q, k, v, meta, tt, causal)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, meta, tt, causal)
                torch.cuda.synchronize()
                err_fwd = max(check_close(f'flash o ({case})', o, o_ref, dtype_name),
                              check_close(f'flash lse ({case})', lse, lse_ref, 'float32'))
                elt, n = q.element_size(), q.numel()
                fwd = dict(
                    max_abs_err=err_fwd,
                    ms=cuda_ms(lambda: fa.flash_attention(q, k, v, meta, tt, causal)),
                    plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, meta, tt,
                                                                      causal)),
                    library_ms=sdpa_ms(q, k, v, mask), tol=tol_str(dtype_name),
                    cuda_cores_ms=(cuda_ms(lambda: fa.flash_attention_cuda_cores(
                        q, k, v, meta, tt, causal)) if dtype_name == 'bfloat16' else None))
                fwd['bound_ms'], fwd['bound_by'] = bound(4 * n * elt + lse.numel() * 4,
                                                         2 * 2 * hd * pairs, dtype_name)
                # f32: the share of the FFMA bound (67 TFLOP/s) the kernel reaches
                fwd['bound_share'] = fwd['bound_ms'] / fwd['ms']
                results[('flash_attention_fwd', case, dtype_name)] = fwd

                args = (q, k, v, meta, o, lse, do, tt, causal)

                def cc_ms(wrapper):
                    # bf16: the CUDA-core route (the f32 kernels), in the same call
                    if dtype_name != 'bfloat16':
                        return None
                    return cuda_ms(lambda: wrapper(*args, cuda_cores=True))
                want = fa.flash_attention_bwd_plain(*args)
                plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(*args))
                library_ms = sdpa_ms(q, k, v, mask, do)
                in_bytes = 5 * n * elt + lse.numel() * 4     # q, k, v, o, dO, lse
                if fa.uses_fused_bwd(s):
                    got = fa.flash_bwd_fused(*args)
                    torch.cuda.synchronize()
                    errs = [check_close(f'{g} ({case}, fused)', x, w, dtype_name)
                            for g, x, w in zip(('dq', 'dk', 'dv'), got, want)]
                    kern = {'flash_bwd_fused': dict(
                        max_abs_err=max(errs), ms=cuda_ms(lambda: fa.flash_bwd_fused(*args)),
                        cuda_cores_ms=cc_ms(fa.flash_bwd_fused),
                        bound=bound(in_bytes + 3 * n * elt, 5 * 2 * hd * pairs, dtype_name))}
                else:
                    dq = fa.flash_bwd_dq(*args)
                    dk, dv = fa.flash_bwd_dkv(*args)
                    torch.cuda.synchronize()
                    kern = {
                        'flash_bwd_dq': dict(
                            max_abs_err=check_close(f'dq ({case})', dq, want[0], dtype_name),
                            ms=cuda_ms(lambda: fa.flash_bwd_dq(*args)),
                            cuda_cores_ms=cc_ms(fa.flash_bwd_dq),
                            bound=bound(in_bytes + n * elt, 3 * 2 * hd * pairs, dtype_name)),
                        'flash_bwd_dkv': dict(
                            max_abs_err=max(
                                check_close(f'dk ({case})', dk, want[1], dtype_name),
                                check_close(f'dv ({case})', dv, want[2], dtype_name)),
                            ms=cuda_ms(lambda: fa.flash_bwd_dkv(*args)),
                            cuda_cores_ms=cc_ms(fa.flash_bwd_dkv),
                            bound=bound(in_bytes + 2 * n * elt, 4 * 2 * hd * pairs,
                                        dtype_name))}
                for name, r in kern.items():
                    r['bound_ms'], r['bound_by'] = r.pop('bound')
                    # f32: the share of the FFMA bound (67 TFLOP/s) the kernel reaches
                    r['bound_share'] = r['bound_ms'] / r['ms']
                    r.update(plain_ms=plain_ms, library_ms=library_ms, tol=tol_str(dtype_name))
                    results[(name, case, dtype_name)] = r
                emit(phase='kernels', path='train', case=case, dtype=dtype_name,
                     shape=[b, h, s, hd], causal=causal, attended_pairs=pairs,
                     flash_attention_fwd=fwd, **kern)
                del q, k, v, do, o, lse, o_ref, lse_ref, want, args


def synthetic_batch(model: str, cfg, n: int, device):
    """A collated batch of the first ``n`` synthetic items, on ``device``."""
    from valle2_tpu_torch.data import SyntheticValleDataset, get_collate
    from valle2_tpu_torch.data.prefetch import to_device
    ds = SyntheticValleDataset(cfg, size=n)
    return to_device(get_collate(model)(cfg)([ds[i] for i in range(n)]), device)


def grads_arm(loss, params, leaves, cfg, batch, label: str, kernels: bool):
    """(loss, grads) of one route under ``cfg``; fails unless the backward
    kernels launched exactly when ``kernels``."""
    import torch
    from valle2_tpu_torch.config import precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa
    before = fa.BWD_FUSED_COUNTER.count + fa.BWD_DQ_COUNTER.count
    with precision_scope(cfg):
        value, _ = loss(params, cfg, batch)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    launched = fa.BWD_FUSED_COUNTER.count + fa.BWD_DQ_COUNTER.count - before
    if (launched > 0) != kernels:
        fail(f'grads ({label}): {launched} backward kernel launches')
    return float(value.detach()), [torch.zeros_like(p) if g is None else g
                                   for p, g in zip(leaves, grads)]


def phase_grads():
    """Loss and every grad through the kernels == through the plain bias
    route, full width: f32 with TF32 off (GRAD_RTOL), and bf16 on the same f32
    master weights (GRAD_BF16, against the plain route's own distance from
    the f32 grads); AR, and NAR at stage 3."""
    import dataclasses

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.models import nar as nar_mod
    from valle2_tpu_torch.train import init_state, tree_leaves

    dev = torch.device('cuda')
    kern_cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True)
    plain_cfg = dataclasses.replace(kern_cfg, use_flash_attention=False)
    for model, loss in (('ValleAR', lambda p, c, bt: ar_mod.loss_fn(p, c, bt)),
                        ('ValleNAR', lambda p, c, bt: nar_mod.loss_at_stage(p, c, bt, 3))):
        params = init_state(kern_cfg, model, device=dev).params
        leaves = tree_leaves(params)
        batch = synthetic_batch(model, kern_cfg, 4, dev)
        out = {(name, dt): grads_arm(loss, params, leaves,
                                     dataclasses.replace(cfg, dtype=dt), batch,
                                     f'{model}, {name}, {dt}', name == 'kernels')
               for dt in ('float32', 'bfloat16')
               for name, cfg in (('kernels', kern_cfg), ('plain', plain_cfg))}
        (lk, gk), (lp, gp) = out[('kernels', 'float32')], out[('plain', 'float32')]
        if not abs(lk - lp) <= 1e-5 * abs(lp):
            fail(f'grads ({model}): loss {lk} through the kernels, {lp} plain')
        worst = 0.0
        for i, (a, w) in enumerate(zip(gk, gp)):
            scale = float(w.abs().max())
            diff = float((a - w).abs().max())
            if not torch.isfinite(a).all() or diff > GRAD_RTOL * scale:
                fail(f'grads ({model}): leaf {i} {tuple(w.shape)} differs by {diff:.3e}, '
                     f'its max |grad| is {scale:.3e}')
            worst = max(worst, diff / scale if scale > 0 else 0.0)
        emit(phase='grads', model=model, dtype='float32', batch=list(batch['codes'].shape),
             loss_kernels=lk, loss_plain=lp, leaves=len(leaves),
             worst_leaf_rel_err=worst, tol=f'max|dg| <= {GRAD_RTOL:g}*max|g| per leaf, '
                                             'loss within 1e-5 relative')

        # bf16: each route parts from the f32 plain grads (gp) by its own
        # rounding; the kernels may part from the plain route by at most
        # GRAD_BF16['k'] times the plain route's distance plus GRAD_BF16['ulp']
        # of the leaf's largest f32 grad.
        (lk16, gk16), (lp16, gp16) = out[('kernels', 'bfloat16')], out[('plain', 'bfloat16')]
        k, ulp = GRAD_BF16['k'], GRAD_BF16['ulp']
        if not abs(lk16 - lp16) <= k * abs(lp16 - lp) + ulp * abs(lp):
            fail(f'grads ({model}, bf16): loss {lk16} through the kernels, {lp16} plain, '
                 f'{lp} plain in f32')
        used = dist_k = dist_p = 0.0
        for i, (a, w, ref) in enumerate(zip(gk16, gp16, gp)):
            scale = float(ref.abs().max())
            diff = float((a - w).abs().max())
            own = float((w - ref).abs().max())
            allowed = k * own + ulp * scale
            if not torch.isfinite(a).all() or diff > allowed:
                fail(f'grads ({model}, bf16): leaf {i} {tuple(w.shape)} differs from the plain '
                     f'route by {diff:.3e}; the plain route from f32 by {own:.3e}; its max '
                     f'|f32 grad| is {scale:.3e}')
            if scale > 0:
                used = max(used, diff / allowed)
                dist_k = max(dist_k, float((a - ref).abs().max()) / scale)
                dist_p = max(dist_p, own / scale)
        emit(phase='grads', model=model, dtype='bfloat16', batch=list(batch['codes'].shape),
             loss_kernels=lk16, loss_plain=lp16, loss_plain_f32=lp, leaves=len(leaves),
             worst_share_of_tol=used, worst_leaf_rel_dist_from_f32={'kernels': dist_k,
                                                                    'plain': dist_p},
             tol=f'per leaf max|g_kernels - g_plain| <= {k:g}*max|g_plain - g_f32| + '
                 f'{ulp:g}*max|g_f32|; the loss alike')
        del params, leaves, batch, out


def bench_data(model: str, b: int, frames: int, device):
    """bench.py's training batch: tokens frames//4 long, every row full."""
    import numpy as np
    import torch
    rs = np.random.RandomState(0)
    tt = frames // 4
    data = {'tokens': rs.randint(0, 256, (b, tt)), 'tokens_lens': np.full(b, tt),
            'codes_lens': np.full(b, frames)}
    if model == 'ValleNAR':
        data['codes'] = rs.randint(0, 1024, (b, frames, 8))
    else:
        data['codes'] = rs.randint(0, 1024, (b, frames))
        data['target'] = rs.randint(0, 1024, (b, frames))
    return {k: torch.tensor(v, dtype=torch.int32, device=device) for k, v in data.items()}


def phase_train(smi: str) -> dict:
    """The training path: the bench configs through make_train_step, then
    AR steps at s=1280.  Returns the launch counts of the path."""
    import math
    import time

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.profiling import nar_train_step_flops, train_step_flops
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    for model, b, frames, _ in TRAIN_RUNS:   # warm-up: the allocator, cuBLAS, the kernels
        cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
        state = init_state(cfg, model, device=dev)
        step = make_train_step(cfg, model)
        data = bench_data(model, b, frames, dev)
        for _ in range(2):
            state, _m = step(state, data, 1)
    torch.cuda.synchronize()
    del state

    reset_counters()
    for model, b, frames, n in TRAIN_RUNS:
        cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
        state = init_state(cfg, model, device=dev)
        step = make_train_step(cfg, model)
        data = bench_data(model, b, frames, dev)
        losses = []
        for _ in range(2):
            state, m = step(state, data, 1)
            losses.append(m['loss'])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(n):
            state, m = step(state, data, 1)
            losses.append(m['loss'])
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n
        losses = [float(x) for x in losses]
        if not all(math.isfinite(x) for x in losses):
            fail(f'train ({model}, b={b}x{frames}): non-finite loss {losses}')
        flops_fn = nar_train_step_flops if model == 'ValleNAR' else train_step_flops
        flops = flops_fn(cfg, b, frames // 4, frames)
        emit(phase='train', model=model, batch=b, frames=frames, s=frames // 4 + frames,
             dtype='bfloat16', steps=n, step_ms=1e3 * step_s, frames_per_s=b * frames / step_s,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
             model_tflops=flops / step_s / 1e12,
             mfu_vs_bf16_dense_peak=flops / step_s / PEAK_FLOPS['bfloat16'],
             first_loss=losses[0], last_loss=losses[-1], card=smi)
        del state, data
    launches = read_counters()
    require_launches('training', launches, ('flash_attention_fwd', 'flash_bwd_fused',
                                            'flash_bwd_dq', 'flash_bwd_dkv'))
    emit(phase='train', launches=launches)
    return launches


def phase_fit():
    """Trainer.fit at full width through the synthetic loader, checkpoints
    every 10 steps, then a resumed fit."""
    import dataclasses
    import tempfile
    from pathlib import Path

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import get_dataloaders
    from valle2_tpu_torch.train import Trainer, init_state

    dev = torch.device('cuda')
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = ConfigValle(lr=1e-3, schedule='constant', max_steps=20, ckpt_every_n_steps=10,
                          batch_size=8, log_every_n_steps=10, dtype='bfloat16',
                          ckpt_path=tmp / 'ckpt', log_path=tmp / 'logs')

        def run(cfg, seed, resume):
            trainer = Trainer(cfg, 'ValleAR', device=dev)
            inner, seen = trainer.train_step, []

            def recording(state, batch, s):
                state_out, m = inner(state, batch, s)
                seen.append((state.step, m['loss']))
                return state_out, m
            trainer.train_step = recording
            train_loader, valid_loader = get_dataloaders('ValleAR', cfg, synthetic=True)
            state = trainer.fit(init_state(cfg, 'ValleAR', seed=seed, device=dev),
                                train_loader, valid_loader, resume=resume)
            return state, [(st, float(x)) for st, x in seen]

        state, seen = run(cfg, 0, False)
        losses = [x for _, x in seen]
        first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
        if len(losses) != 20 or state.step != 20 or not last < first:
            fail(f'fit: {len(losses)} steps, mean loss of the first 5 {first}, of the last 5 '
                 f'{last}')
        ckpt = tmp / 'ckpt' / 'ValleAR'
        for d in ('step_10', 'step_20'):
            if not (ckpt / d / 'state.pt').exists():
                fail(f'fit: no checkpoint {d}')
        resumed, seen2 = run(dataclasses.replace(cfg, max_steps=25), 5, True)
        if resumed.step != 25 or seen2[0][0] != 20 or len(seen2) != 5:
            fail(f'fit: resume took steps {[st for st, _ in seen2]}, ended at {resumed.step}')
        emit(phase='fit', model='ValleAR', batch=cfg.batch_size, steps=len(losses),
             mean_loss_first5=first, mean_loss_last5=last,
             checkpoints=sorted(p.name for p in ckpt.glob('step_*')),
             resumed_from=seen2[0][0], resumed_to=resumed.step)


def phase_profile(smi: str, model: str = 'ValleAR', b: int = 32, frames: int = 512):
    """Where one bench train step's device time goes: torch.profiler over 3
    steps, kernel time by name, and the device's busy share of the wall time."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16')
    state = init_state(cfg, model, device=dev)
    step = make_train_step(cfg, model)
    data = bench_data(model, b, frames, dev)
    for _ in range(3):
        state, _m = step(state, data, 1)
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _m = step(state, data, 1)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    groups = {'flash_fwd (#1)': ('flash_fwd',), 'flash_bwd (#3-#5)': ('flash_bwd',),
              'gemm (cuBLAS)': ('gemm', 'xmma', 'cutlass', 'nvjet'), 'adamw': ('adam',),
              'elementwise and reductions': ('elementwise', 'reduce_kernel')}
    by_group = dict.fromkeys([*groups, 'other'], 0.0)
    for e in kernels:
        ms = e.self_device_time_total / 1e3 / n
        name = e.key.lower()
        for g, pats in groups.items():
            if any(p in name for p in pats):
                by_group[g] += ms
                break
        else:
            by_group['other'] += ms
    device_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    emit(phase='profile', model=model, batch=b, frames=frames, dtype='bfloat16',
         profiled_wall_ms_per_step=1e3 * wall, device_ms_per_step=device_ms,
         device_busy_share=device_ms / (1e3 * wall), ms_per_step_by_group=by_group,
         top_kernels=[{'name': e.key[:90], 'calls_per_step': e.count / n,
                       'ms_per_step': e.self_device_time_total / 1e3 / n} for e in top],
         card=smi)


def check_ties(name: str, codebooks, latents, got, want) -> dict:
    """Hold kernel codes to the plain ones under the tie rule; returns the
    tie statistics (codes that differ, ties with a positive gap, the worst
    gap, and the worst gap over its allowance)."""
    from valle2_tpu_torch.kernels import rvq as krvq
    gaps, tops = krvq.code_gaps(codebooks, latents, got)
    allowed = krvq.TIE_RTOL * tops.clamp(min=1.0)
    worst = float(gaps.max())
    if not bool((gaps <= allowed).all()):
        fail(f'{name}: a kernel code scores {worst:.3e} below the plain best, over the '
             f'tie allowance {krvq.TIE_RTOL:g} * max(1, |best|)')
    return {'codes_differ': int((got != want).sum()), 'ties': int((gaps > 0).sum()),
            'worst_gap': worst, 'worst_gap_over_allowed': float((gaps / allowed).max())}


def phase_rvq_kernel(results: dict):
    """RVQ encode #8 against its plain version at the codec path's shapes
    (tie rule), with its plan (tile, cluster, CTAs against the SM count),
    device time and share of the FFMA bound; and exactly equal on codebooks
    with each stage's codeword duplicated into another slice (an exact tie
    across CTAs goes to the lower index), under the plan and under clusters
    of 4 CTAs of 256 codewords."""
    import torch
    from valle2_tpu_torch.config import tf32_scope
    from valle2_tpu_torch.kernels import rvq as krvq

    dev = torch.device('cuda')
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator().manual_seed(8)
    cb = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1).to(dev)
    with tf32_scope(False), torch.inference_mode():
        for case, (b, t, n_q) in RVQ_CASES.items():
            lat = torch.randn(b, t, 128, generator=gen).to(dev)
            got = krvq.rvq_encode_fused(cb, lat, n_q)
            want = krvq.rvq_encode_plain(cb, lat, n_q)
            torch.cuda.synchronize()
            ties = check_ties(f'rvq_encode ({case})', cb, lat, got, want)
            rows, v, d = b * t, cb.shape[1], cb.shape[2]
            plan = krvq.rvq_plan(rows, v, n_q, sms)
            r = dict(max_abs_err=ties['worst_gap'],
                     ms=cuda_ms(lambda: krvq.rvq_encode_fused(cb, lat, n_q)),
                     plain_ms=cuda_ms(lambda: krvq.rvq_encode_plain(cb, lat, n_q)),
                     library_ms=None,
                     tol=f'codes equal but for ties: gap <= {krvq.TIE_RTOL:g}*max(1,|best|)')
            r['bound_ms'], r['bound_by'] = bound(4 * (rows * d + n_q * v * d + rows * n_q),
                                                 2 * rows * n_q * v * d, 'float32')
            r['device_ms'] = device_ms(lambda: krvq.rvq_encode_fused(cb, lat, n_q),
                                       'rvq_cluster_kernel')
            results[('rvq_encode', case, 'float32')] = r
            emit(phase='kernels', path='codec', kernel='rvq_encode', case=case,
                 shape=dict(B=b, T=t, n_q=n_q, V=v, D=d), **ties,
                 **{k: r[k] for k in ('ms', 'device_ms', 'plain_ms', 'bound_ms', 'bound_by')},
                 plan=plan, sms=sms, ctas_per_sm=plan['ctas'] / sms,
                 bound_share=r['bound_ms'] / r['device_ms'],
                 achieved_tflops=2 * rows * n_q * v * d / r['device_ms'] / 1e9)
        # the constructed cross-slice ties: every stage's codeword a[q] copied
        # to b[q] in another slice, frames near the duplicated sum
        a = torch.tensor([5 + 3 * q for q in range(8)])
        b_ = torch.tensor([600 + 41 * q for q in range(8)])
        tied = (torch.rand(8, 1024, 128, generator=gen) * 2 - 1) \
            * 0.5 ** torch.arange(8.0)[:, None, None]
        tied[torch.arange(8), b_] = tied[torch.arange(8), a]
        lat = tied[torch.arange(8), a].sum(0) + 1e-4 * torch.randn(1, 150, 128, generator=gen)
        tied, lat = tied.to(dev), lat.to(dev)
        want = krvq.rvq_encode_plain(tied, lat)
        for plan in (None, dict(tile=krvq.TILES.index((32, 256, 8, 4, 1)), cluster=4)):
            got = krvq.rvq_encode_fused(tied, lat, plan=plan)
            torch.cuda.synchronize()
            at_a = bool((want.cpu() == a.int()[None, :, None]).all())
            if not torch.equal(got, want) or not at_a:
                fail(f'rvq_encode: the exact ties across CTAs (plan {plan}) did not go to the '
                     'lower index as the plain version\'s')
        emit(phase='kernels', path='codec', kernel='rvq_encode', case='cross_slice_ties',
             codes_equal=True)


def speech_like(rs, seconds: float, sr: int):
    """A seeded waveform: a few drifting harmonics under noise, peak 0.5."""
    import numpy as np
    t = np.arange(int(seconds * sr)) / sr
    f0 = rs.uniform(90, 220) * (1 + 0.1 * np.sin(2 * np.pi * rs.uniform(1, 4) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(np.sin(k * phase) / k for k in range(1, 6)) + 0.2 * rs.randn(len(t))
    return (0.5 * wav / np.abs(wav).max()).astype(np.float32)


def phase_codec():
    """A seeded full-geometry Encodec on the card: the kernel route against
    the plain RVQ on the same latents."""
    import numpy as np
    import torch
    from valle2_tpu_torch.codec import Encodec
    from valle2_tpu_torch.config import tf32_scope
    from valle2_tpu_torch.kernels import rvq as krvq

    codec = Encodec(seed=0, device='cuda')
    rs = np.random.RandomState(12)
    wavs = np.stack([speech_like(rs, 3.0, 24000) for _ in range(3)])
    codes = codec.batch_encode(wavs)
    emb = codec.batch_get_embedding(wavs)
    latents = emb.transpose(1, 2).contiguous()
    codebooks = codec.params['rvq']['codebooks']
    with tf32_scope(False), torch.inference_mode():
        plain = krvq.rvq_encode_plain(codebooks, latents)
        torch.cuda.synchronize()
        if codes.shape != (3, 8, 225) or not torch.isfinite(emb).all():
            fail(f'codec: codes of {tuple(codes.shape)}, finite embedding '
                 f'{bool(torch.isfinite(emb).all())}')
        ties = check_ties('codec encode', codebooks, latents, codes, plain)
    solo = codec.get_embedding(wavs[0])
    if solo.shape != (128, 225) or not torch.isfinite(solo).all():
        fail(f'codec: get_embedding of {tuple(solo.shape)}')
    emit(phase='codec', batch=list(wavs.shape), codes=list(codes.shape), **ties,
         embedding_absmax=float(emb.abs().max()))


def clone_requests(seed: int = 5):
    """3 cloning requests: a text, a 3 s prompt at 16 kHz and its transcript."""
    import numpy as np
    rs = np.random.RandomState(seed)
    texts, _, _ = make_requests()
    prompt_texts = ['we heard the bells ring out at noon.',
                    'he read the letter twice before he spoke.',
                    'the river was cold and very still.']
    return [(text, speech_like(rs, 3.0, 16000), 16000, pt)
            for text, pt in zip(texts, prompt_texts)]


def phase_clone():
    """Voice cloning from audio at the serving config: ValleTTS.__call__ for
    3 requests, then batch_synthesize on the three prepared prompts."""
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.tts import ValleTTS

    max_new = SLICE['max_new']
    cfg = ConfigValle(max_audio_len=max_new, ignore_eos=True, dropout=0.0,
                      dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    reqs = clone_requests()
    tts(*reqs[0])                                        # warm-up
    torch.cuda.synchronize()

    reset_counters()
    calls, prepare_s, prompts = [], [], []
    for req in reqs:
        t0 = time.perf_counter()
        result = tts(*req)
        calls.append((time.perf_counter() - t0, result))
    for _, audio, sr, prompt_text in reqs:
        t0 = time.perf_counter()
        prompts.append(tts.prepare_prompt(audio, sr, prompt_text))
        prepare_s.append(time.perf_counter() - t0)
    batch = tts.batch_synthesize([r[0] for r in reqs], [p[0] for p in prompts],
                                 [p[1] for p in prompts])
    launches = read_counters()
    encode_profile = profile_prepare_prompt(tts, reqs[0])

    for r in [c[1] for c in calls] + batch:
        if r.waveform.shape != (len(r.codes) * 320,) or not np.isfinite(r.waveform).all():
            fail(f'clone: waveform of {r.waveform.shape} for {len(r.codes)} frames')
    for _, codes in prompts:
        if codes.shape != (225, 8):                      # 3 s at 24 kHz / 320
            fail(f'clone: prompt codes of {codes.shape}')
    require_launches('clone', launches, ('flash_attention_fwd', 'fused_decode_step',
                                         'rvq_encode'))
    stages = ('frontend', 'ar_decode', 'nar_refine', 'codec_decode')
    per_call = [dict(wall_s=wall, prompt_s=wall - sum(r.timings.values()),
                     **{k: r.timings[k] for k in stages}, frames=len(r.codes), rtf=r.rtf)
                for wall, r in calls]
    t = batch[0].timings
    audio_s = sum(len(r.waveform) for _, r in calls) / 24000
    emit(phase='clone', requests=len(reqs), prompt_frames=[len(p[1]) for p in prompts],
         max_audio_len=max_new, calls=per_call,
         prepare_prompt_s=prepare_s,
         calls_rtf=sum(w for w, _ in calls) / audio_s,
         batch_stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
         batch_wall_s=t['batched'], batch_rtf=batch[0].rtf, launches=launches,
         prepare_prompt_profile=encode_profile)
    return launches


def profile_prepare_prompt(tts, req) -> dict:
    """Where one prepare_prompt (resample + encode of a 3 s prompt) spends
    its time: torch.profiler's device time by kernel group against the wall
    time, and the device's busy share."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _, audio, sr, prompt_text = req
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tts.prepare_prompt(audio, sr, prompt_text)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    groups = {'rvq_encode (#8)': ('rvq_cluster_kernel',),
              'convolutions (cuDNN)': ('conv', 'cudnn', 'implicit', 'xmma', 'winograd', 'fft'),
              'gemm and gemv (cuBLAS, LSTM)': ('gemm', 'gemv', 'nvjet', 'cutlass'),
              'elementwise and reductions': ('elementwise', 'reduce_kernel')}
    by_group = dict.fromkeys([*groups, 'other'], 0.0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        name = e.key.lower()
        key = next((g for g, pats in groups.items() if any(x in name for x in pats)), 'other')
        by_group[key] += e.self_device_time_total / 1e3
    device_ms = sum(by_group.values())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms, device_busy_share=device_ms / wall_ms,
                kernel_launches=sum(e.count for e in kernels), device_ms_by_group=by_group,
                top_kernels=[{'name': e.key[:80], 'calls': e.count,
                              'ms': e.self_device_time_total / 1e3} for e in top])


def phase_asr():
    """Batched ASR from audio: batch == each solo transcription (greedy)."""
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.tts import ValleASRPipeline

    cfg = ConfigValle(direction='asr', max_audio_len=256, dropout=0.0, temperature=0.0,
                      matmul_precision='highest', kv_cache_dtype='float32')
    asr = ValleASRPipeline(cfg, device='cuda')
    rs = np.random.RandomState(14)
    audios = [speech_like(rs, 3.0, 24000) for _ in range(3)]
    srs = [24000] * 3
    asr.transcribe(audios[0], srs[0], output='phonemes')  # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    batch = asr.batch_transcribe(audios, srs, output='phonemes')
    batch_s = time.perf_counter() - t0
    launches = read_counters()
    solo = [asr.transcribe(a, sr, output='phonemes') for a, sr in zip(audios, srs)]
    if batch != solo:
        fail(f'asr: batched transcriptions differ from solo ones: {batch} vs {solo}')
    require_launches('asr', launches, ('flash_attention_fwd', 'fused_decode_step',
                                       'rvq_encode'))
    emit(phase='asr', utterances=len(audios), seconds_each=3.0, batch_wall_s=batch_s,
         rtf=batch_s / 9.0, phonemes=[len(p) for p in batch], first=batch[0][:8],
         batched_equals_solo=True, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# Phase server: the serving layer (valle2_tpu_torch.serve) over HTTP
# ---------------------------------------------------------------------------

def http_post(base: str, path: str, payload, timeout: float = 600.0):
    import urllib.request
    data = payload if isinstance(payload, bytes) else json.dumps(payload).encode()
    return urllib.request.urlopen(urllib.request.Request(f'{base}{path}', data=data),
                                  timeout=timeout)


def http_get(base: str, path: str) -> bytes:
    import urllib.request
    return urllib.request.urlopen(f'{base}{path}', timeout=60).read()


def request_body(text, pt, pc, **kw) -> dict:
    return dict(text=text, prompt_tokens=[int(x) for x in pt],
                prompt_codes=[[int(x) for x in row] for row in pc], **kw)


def wav_pcm(data: bytes):
    import io
    import wave

    import numpy as np
    with wave.open(io.BytesIO(data), 'rb') as w:
        if w.getframerate() != 24000 or w.getsampwidth() != 2:   # on a client thread
            raise ValueError(f'a WAV of {w.getframerate()} Hz, {w.getsampwidth()} bytes a '
                             'sample')
        return np.frombuffer(w.readframes(w.getnframes()), '<i2').astype(np.int32)


def on_threads(fns, label: str, timeout: float = 600.0) -> list:
    """Run each fn on its own thread, all started together; their results."""
    import threading
    res, errs = [None] * len(fns), []
    start = threading.Barrier(len(fns))

    def run(i):
        try:
            start.wait()
            res[i] = fns[i]()
        except Exception as e:      # noqa: BLE001 -- reported below
            errs.append(e)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(fns))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=timeout)
    if errs or any(th.is_alive() for th in threads):
        fail(f'server ({label}): client threads failed or hung: {errs!r}')
    return res


def server_divergence(model, cfg, tokens, pcodes, got, want) -> dict | None:
    """None when the codes equal; else where a row's codes part from its
    solo run's: the first frame whose AR token differs, with the plain
    route's logit gap of the two picks there (teacher-forced on the solo
    run's prefix; ``GREEDY_F32_GAP`` bounds it); a NAR-only difference fails."""
    import numpy as np
    import torch
    if got.shape == want.shape and np.array_equal(got, want):
        return None
    g, w = got[:, 0], want[:, 0]
    n = min(len(g), len(w))
    diff = np.nonzero(g[:n] != w[:n])[0]
    if not len(diff) and len(g) == len(w):
        frame, q = (int(x[0]) for x in np.nonzero(got != want))
        fail(f'server: the AR tokens equal but the NAR codes part at frame {frame}, '
             f'codebook {q}')
    k = int(diff[0]) if len(diff) else n
    eos = cfg.eos_token
    pair = (int(g[k]) if k < len(g) else eos, int(w[k]) if k < len(w) else eos)
    gap = teacher_forced_gap(model, cfg, tokens, pcodes, torch.as_tensor(w[:k]), pair)
    return dict(frame=k, pair=list(pair), logit_gap=gap)


def hold_to_solo(label: str, model, cfg, tokens, pcodes, got, want, pcm=None) -> dict:
    """A served row against its solo run: codes equal or parted at a
    near-tie; the response's PCM16 within one step of the solo waveform's
    (the codec decodes at another batch size) where the codes equal."""
    import numpy as np
    from valle2_tpu_torch.utils import pcm16
    div = server_divergence(model, cfg, tokens, pcodes, got.codes, want.codes)
    if div is not None and div['logit_gap'] > GREEDY_F32_GAP:
        fail(f'server ({label}): served codes part from solo away from a near-tie: {div}')
    out = dict(codes_equal=div is None, divergence=div)
    if pcm is not None and div is None:
        ref = pcm16(want.waveform).astype(np.int32)
        if pcm.shape != ref.shape or int(np.abs(pcm - ref).max(initial=0)) > 1:
            fail(f'server ({label}): PCM16 of {pcm.shape} differs from solo {ref.shape} by '
                 f'{int(np.abs(pcm - ref).max(initial=0)) if pcm.shape == ref.shape else "-"}')
        out['pcm_max_steps'] = int(np.abs(pcm - ref).max(initial=0))
    return out


@contextlib.contextmanager
def http_front(server):
    """serve_http(server, 127.0.0.1, port 0, block=False) for a with-block."""
    from valle2_tpu_torch.serve import serve_http
    httpd = serve_http(server, host='127.0.0.1', port=0, block=False)
    try:
        yield f'http://127.0.0.1:{httpd.server_address[1]}'
    finally:
        httpd.shutdown()
        httpd.server_close()


def server_exact(smi: str) -> dict:
    """(a) f32, TF32 off, 4 beams, greedy: 8 requests from 8 client threads
    over HTTP, then the same 8 through submit; every response's PCM16 and
    every result's codes against the request's solo synthesize_fused.
    (e) on the same server: a LoRA voice from an adapter file in a mixed
    batch, each row against its own weights' solo run.  Returns the served
    runs' launch counts."""
    import tempfile

    import numpy as np
    import torch
    from valle2_tpu_torch import lora
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.serve import TTSServer
    from valle2_tpu_torch.tts import ValleTTS

    cfg = ConfigValle(max_audio_len=SERVER['exact_max_new'], dropout=0.0, temperature=0.0,
                      kv_cache_dtype='float32', matmul_precision='highest')
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs, tokens = cb_requests(SERVER['exact_requests'], seed=31)
    server = TTSServer(tts, max_batch=SERVER['max_batch'], max_wait_ms=50.0)
    warm_s = server.warmup()
    total = {}
    with server, http_front(server) as base:
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        pcms = on_threads([lambda i=i: wav_pcm(http_post(base, '/synthesize', request_body(
            texts[i], pts[i], pcs[i])).read()) for i in range(len(texts))], 'exact')
        http_s = time.perf_counter() - t0
        futs = [server.submit(t, pt, pc) for t, pt, pc in zip(texts, pts, pcs)]
        results = [f.result(timeout=600) for f in futs]
        torch.cuda.synchronize()
        launches, plain = read_counters(), plain_calls()
        stats = server.stats()
    add_counts(total, launches)
    if plain:
        fail(f'server (exact): {plain} plain calls of the fused steps')
    held = [hold_to_solo(f'exact {i}', tts.ar, cfg, tokens[i], pcs[i], results[i],
                         tts.synthesize_fused(texts[i], pts[i], pcs[i]), pcms[i])
            for i in range(len(texts))]
    emit(phase='server', part='exact', dtype='float32', tf32=False, beams=cfg.num_beams,
         max_audio_len=cfg.max_audio_len, requests=len(texts), http_threads=len(texts),
         http_wall_s=http_s, warmup_s=warm_s, batches=stats['batches'],
         mean_batch_size=stats['mean_batch_size'], rows=held,
         codes_equal=sum(h['codes_equal'] for h in held),
         launches={k: v for k, v in launches.items() if v}, plain_calls=plain, card=smi)

    # (e) a LoRA voice: seeded adapters with a nonzero B, through a file.
    gen = torch.Generator().manual_seed(SERVER['lora_seed'])
    adapters = lora.lora_init(gen, tts.ar.params, SERVER['lora_rank'])
    for tree in _lora_pairs(adapters):
        tree['lora_b'] = (0.02 * torch.randn(tree['lora_b'].shape, generator=gen)).to(
            tree['lora_b'])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / 'voice.npz'
        lora.save_adapters(path, {'ar': adapters}, scale=2.0)
        server = TTSServer(tts, max_batch=SERVER['max_batch'], max_wait_ms=50.0)
        server.load_voice('v', path)
    voice_model = server._voices['v'][2]
    voices = [None, 'v', None, 'v']
    torch.cuda.synchronize()
    reset_counters()
    futs = [server.submit(texts[i], pts[i], pcs[i], voice=v) for i, v in enumerate(voices)]
    with server:
        results = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    launches, plain = read_counters(), plain_calls()
    add_counts(total, launches)
    if plain or server.stats()['batches'] != 2:
        fail(f'server (voice): {plain} plain calls, {server.stats()["batches"]} batches')
    held, differs = [], 0
    for i, v in enumerate(voices):
        if v is None:
            held.append(hold_to_solo(f'voice row {i}', tts.ar, cfg, tokens[i], pcs[i],
                                     results[i], tts.synthesize_fused(texts[i], pts[i],
                                                                      pcs[i])))
            continue
        solo = tts.batch_synthesize([texts[i]], [pts[i]], [pcs[i]],
                                    override_params=(voice_model.decode_params, None))[0]
        held.append(hold_to_solo(f'voice row {i}', voice_model, cfg, tokens[i], pcs[i],
                                 results[i], solo))
        differs += not np.array_equal(results[i].codes,
                                      tts.synthesize_fused(texts[i], pts[i], pcs[i]).codes)
    if not differs:
        fail('server (voice): the voice rows equal the base weights\' codes')
    emit(phase='server', part='lora_voice', dtype='float32', rank=SERVER['lora_rank'],
         adapters=lora.adapter_count(adapters), rows=held, voice_rows_unlike_base=differs,
         launches={k: v for k, v in launches.items() if v}, card=smi)
    return total


def _lora_pairs(tree):
    """The {'lora_a', 'lora_b'} nodes of an adapter tree."""
    if 'lora_a' in tree:
        yield tree
        return
    for sub in tree.values():
        yield from _lora_pairs(sub)


def add_counts(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def worker_cpu_s(server) -> float:
    """CPU seconds the server's batching worker thread has used."""
    return time.clock_gettime(time.pthread_getcpuclockid(server._thread.ident))


def server_load(smi: str) -> dict:
    """(b) bf16 at the serving config: 16 requests from 16 client threads over
    HTTP, max_batch 8, max_wait_ms 10; then (d) one /transcribe of a 3 s WAV
    on the same server.  Returns the launch counts."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.serve import TTSServer
    from valle2_tpu_torch.tts import ValleASRPipeline, ValleTTS
    from valle2_tpu_torch.utils import wav_pcm16_bytes

    n = SERVER['load_max_new']
    cfg = ConfigValle(max_audio_len=n, ignore_eos=True, dropout=0.0, dtype='bfloat16')
    tts = ValleTTS(cfg, device='cuda')
    asr_cfg = ConfigValle(direction='asr', max_audio_len=256, dropout=0.0, temperature=0.0,
                          dtype='bfloat16')
    asr = ValleASRPipeline(asr_cfg, device='cuda')
    texts, pts, pcs, _ = cb_requests(SERVER['load_requests'], seed=32)
    server = TTSServer(tts, max_batch=SERVER['max_batch'], max_wait_ms=SERVER['max_wait_ms'],
                       asr=asr)
    warm_s = server.warmup()
    rs = np.random.RandomState(33)
    wav = speech_like(rs, 3.0, 24000)
    asr.transcribe(wav, 24000)                           # warm-up
    total = {}
    with server, http_front(server) as base:
        torch.cuda.synchronize()
        cpu0 = worker_cpu_s(server)
        reset_counters()
        t0 = time.perf_counter()
        pcms = on_threads([lambda i=i: wav_pcm(http_post(base, '/synthesize', request_body(
            texts[i], pts[i], pcs[i])).read()) for i in range(len(texts))], 'load')
        wall = time.perf_counter() - t0
        launches, plain = read_counters(), plain_calls()
        cpu = worker_cpu_s(server) - cpu0
        stats = server.stats()
        metrics = http_get(base, '/metrics').decode()
        add_counts(total, launches)
        if plain:
            fail(f'server (load): {plain} plain calls')
        require_launches('server (load)', launches, ('flash_attention_fwd', 'fused_decode_step'))
        # Sampled decode (temperature 1): under ignore_eos a random model can
        # still sample EOS, and the pipeline ends the waveform there, as the
        # JAX package's does (tts.py _fused_tts_fn); which rows sample it
        # depends on how the burst fell into batches.  Each response is whole
        # codec frames, and the clients got every sample the server counted.
        got = sum(len(pcm) for pcm in pcms)
        for pcm in pcms:
            if len(pcm) % 320 or not 0 < len(pcm) <= n * 320:
                fail(f'server (load): {pcm.shape} samples for at most {n} frames')
        if abs(got - stats['audio_seconds'] * 24000) > 0.5:
            fail(f'server (load): the clients got {got} samples, the server counted '
                 f"{stats['audio_seconds'] * 24000}")
        for line in metrics.splitlines():
            if not line.startswith('#'):
                name, value = line.split(' ')
                float(value)
        if 'valle2_requests_total 16' not in metrics.splitlines():
            fail('server (load): /metrics does not count the 16 requests')
        audio_s = got / 24000
        emit(phase='server', part='load', dtype='bfloat16', beams=cfg.num_beams,
             full_length_responses=sum(len(pcm) == n * 320 for pcm in pcms),
             max_audio_len=n, requests=len(texts), client_threads=len(texts),
             max_batch=server.max_batch, max_wait_ms=server.max_wait_ms, warmup_s=warm_s,
             wall_s=wall, requests_per_s=len(texts) / wall, audio_s_per_s=audio_s / wall,
             rtf=wall / audio_s, latency_ms_p50=stats['latency_ms_p50'],
             latency_ms_p95=stats['latency_ms_p95'], batches=stats['batches'],
             mean_batch_size=stats['mean_batch_size'],
             busy_s_per_batch=stats['busy_seconds'] / stats['batches'],
             worker_cpu_s_per_batch=cpu / stats['batches'], metric_lines=len(
                 metrics.splitlines()), launches={k: v for k, v in launches.items() if v},
             plain_calls=plain, card=smi)

        # (d) ASR over HTTP.
        reset_counters()
        t0 = time.perf_counter()
        out = json.loads(http_post(base, '/transcribe', wav_pcm16_bytes(wav, 24000)).read())
        asr_s = time.perf_counter() - t0
        launches = read_counters()
        add_counts(total, launches)
        require_launches('server (asr)', launches, ('rvq_encode', 'fused_decode_step'))
        if not isinstance(out.get('text'), str) or server.stats()['asr_requests'] != 1:
            fail(f'server (asr): {out!r}, stats {server.stats()}')
        emit(phase='server', part='asr', seconds=3.0, wall_s=asr_s, rtf=asr_s / 3.0,
             chars=len(out['text']), launches={k: v for k, v in launches.items() if v},
             card=smi)
    return total


def server_streams(smi: str) -> dict:
    """(c) /stream with cb_streams=4 at one beam (bf16, ignore_eos): 4
    streams from 4 client threads over HTTP through the hub; time to first
    audio (to the response's headers, which follow the first chunk, and to
    its first bytes).  Returns the launch counts."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.serve import TTSServer
    from valle2_tpu_torch.tts import ValleTTS

    n = SERVER['stream_max_new']
    cfg = ConfigValle(max_audio_len=n, ignore_eos=True, dropout=0.0, dtype='bfloat16',
                      num_beams=1)
    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs, _ = cb_requests(SERVER['streams'], seed=34)
    server = TTSServer(tts, max_batch=2, cb_streams=SERVER['streams'])
    warm_s = server.warmup(streams=True)

    def stream(i, base):
        t0 = time.perf_counter()
        resp = http_post(base, '/stream', request_body(texts[i], pts[i], pcs[i]))
        t_head = time.perf_counter() - t0
        first = resp.read(2)
        t_first = time.perf_counter() - t0
        data = first + resp.read()
        return dict(headers_s=t_head, first_audio_s=t_first, wall_s=time.perf_counter() - t0,
                    samples=len(data) // 2, pcm=np.frombuffer(data, '>i2'))
    with server, http_front(server) as base:
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        runs = on_threads([lambda i=i: stream(i, base) for i in range(len(texts))], 'streams')
        wall = time.perf_counter() - t0
        launches, plain = read_counters(), plain_calls()
        stats = server.stats()
    for r in runs:
        if r['samples'] != n * 320:
            fail(f'server (streams): {r["samples"]} samples for {n} frames')
    if plain or launches['fused_decode_step_per_row'] <= 0:
        fail(f'server (streams): {plain} plain calls, launches {launches}')
    audio_s = len(runs) * n * 320 / 24000
    emit(phase='server', part='streams', dtype='bfloat16', cb_streams=SERVER['streams'],
         chunk_frames=server._hub.chunk_frames, max_audio_len=n, warmup_s=warm_s,
         headers_s=[r['headers_s'] for r in runs],
         first_audio_s=[r['first_audio_s'] for r in runs],
         session_wall_s=[r['wall_s'] for r in runs], wall_s=wall, rtf=wall / audio_s,
         stream_requests=stats['stream_requests'],
         launches={k: v for k, v in launches.items() if v}, plain_calls=plain, card=smi)
    return launches


def server_finetune(smi: str) -> dict:
    """(f) LoRA fine-tuning at the serving width: rank SERVER['lora_rank'],
    3 AR steps of b=8 x (128 + 512) in bf16 through the flash forward and
    backward kernels; the base bit-equal after, the adapters moved.
    Returns the steps' launch counts."""
    import math

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.train import init_state, make_train_step, tree_leaves

    dev = torch.device('cuda')
    b, frames = SERVER['ft_batch'], SERVER['ft_frames']
    cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16', lr=1e-3,
                      lora_rank=SERVER['lora_rank'])
    state = init_state(cfg, 'ValleAR', device=dev)
    step = make_train_step(cfg, 'ValleAR')
    data = bench_data('ValleAR', b, frames, dev)
    base0 = [p.clone() for p in tree_leaves(state.params['base'])]
    b0 = [t['lora_b'].detach().clone() for t in _lora_pairs(state.params['lora'])]
    state, _ = step(state, data, 1)                     # warm-up
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    losses = []
    for _ in range(SERVER['ft_steps']):
        state, m = step(state, data, 1)
        losses.append(m['loss'])
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / SERVER['ft_steps']
    launches = read_counters()
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f'server (lora fine-tune): non-finite loss {losses}')
    if launches['flash_attention_fwd'] <= 0 or (
            launches['flash_bwd_fused'] <= 0 and launches['flash_bwd_dq'] <= 0):
        fail(f'server (lora fine-tune): the flash kernels did not launch: {launches}')
    if not all(torch.equal(p, q) for p, q in zip(tree_leaves(state.params['base']), base0)):
        fail('server (lora fine-tune): the base weights moved')
    moved = sum(not torch.equal(t['lora_b'], q)
                for t, q in zip(_lora_pairs(state.params['lora']), b0))
    if moved != len(b0):
        fail(f'server (lora fine-tune): {moved} of {len(b0)} adapter B matrices moved')
    emit(phase='server', part='lora_finetune', dtype='bfloat16', rank=cfg.lora_rank,
         batch=b, frames=frames, steps=SERVER['ft_steps'], step_ms=step_ms,
         trained=len(state.opt_state.leaves), losses=losses, base_equal=True,
         adapters_moved=moved, launches={k: v for k, v in launches.items() if v}, card=smi)
    return launches


def phase_server(smi: str) -> tuple[dict, dict]:
    """The serving layer over HTTP at the serving width (parts a-e), then a
    LoRA fine-tune (f).  Returns (the served runs' launch counts, the
    fine-tune's)."""
    total = server_exact(smi)
    add_counts(total, server_load(smi))
    add_counts(total, server_streams(smi))
    require_launches('server', total, ('flash_attention_fwd', 'fused_decode_step',
                                       'fused_decode_step_per_row', 'rvq_encode'))
    return total, server_finetune(smi)


# Phase checkpoint: weights in and cold start at the serving width of phase
# main (the default ConfigValle: d 256, 4 heads, 8 layers, FFN 1024).
# (a) 3 greedy requests of 128 frames in f32 with TF32 off; (b) a 3 s 48 kHz
# stereo recording into a prompt, the native reader's samples against
# utils.load_audio's away from the resamplers' edges (both Hann-sinc
# designs of one width: their outputs differ by the filters' tails and
# f32 sums, AUDIO_ATOL of a peak-1 signal); (c) one traced synthesize of
# 64 frames; (d) two synthetic AR train steps of the train CLI at batch 8;
# (e) two fresh coldstart_bench processes over the build directory.
CKPT = dict(max_new=128, trace_max_new=64, train_steps=2, train_batch=8, audio_s=3.0,
            audio_sr=48000, audio_edge=256, cold_modes=('compile', 'warmup'))
AUDIO_ATOL = 5e-3


def ckpt_roundtrip(tmp, texts, pts, pcs) -> dict:
    """(a): seeded AR and NAR params through save_torch_checkpoint (the
    Lightning layout, 'model.' key prefix) and load_torch_checkpoint into a
    fresh ValleTTS on the card; params bit-equal, and 3 greedy requests
    (f32, TF32 off) give the in-memory model's codes through #1 and #6 with
    no plain call."""
    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models import ValleAR, ValleNAR
    from valle2_tpu_torch.models.convert import load_torch_checkpoint, save_torch_checkpoint
    from valle2_tpu_torch.ops.transformer import map_tree
    from valle2_tpu_torch.tts import ValleTTS

    cfg = ConfigValle(max_audio_len=CKPT['max_new'], ignore_eos=True, dropout=0.0,
                      temperature=0.0, kv_cache_dtype='float32', matmul_precision='highest')
    mem = ValleTTS(cfg, ar=ValleAR(cfg, seed=11, device='cuda'),
                   nar=ValleNAR(cfg, seed=12, device='cuda'), device='cuda')
    files = {}
    for model, params in (('ValleAR', mem.ar.params), ('ValleNAR', mem.nar.params)):
        path = tmp / f'{model}.ckpt'
        save_torch_checkpoint(path, params, model)
        sd = torch.load(path, weights_only=True)['state_dict']
        torch.save({'state_dict': {f'model.{k}': v for k, v in sd.items()}}, path)
        files[model] = path
    t0 = time.perf_counter()
    loaded = {m: load_torch_checkpoint(f, m, num_layers=cfg.num_layers, device='cuda')
              for m, f in files.items()}
    load_s = time.perf_counter() - t0
    for m, own in (('ValleAR', mem.ar.params), ('ValleNAR', mem.nar.params)):
        same = []
        map_tree(lambda a: same.append(a), own)
        got = []
        map_tree(lambda a: got.append(a), loaded[m])
        if len(got) != len(same) or not all(torch.equal(a, b) for a, b in zip(got, same)):
            fail(f'checkpoint: {m} params differ after the round trip')
    disk = ValleTTS(cfg, ar=ValleAR(cfg, params=loaded['ValleAR'], device='cuda'),
                    nar=ValleNAR(cfg, params=loaded['ValleNAR'], device='cuda'),
                    codec=mem.codec, device='cuda')
    want = mem.batch_synthesize(texts, pts, pcs)
    torch.cuda.synchronize()
    reset_counters()
    got = disk.batch_synthesize(texts, pts, pcs)
    launches, plain = read_counters(), plain_calls()
    require_launches('checkpoint', launches, ('flash_attention_fwd', 'fused_decode_step'))
    if plain:
        fail(f'checkpoint: {plain} plain calls of the fused step')
    for i, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g.codes, w.codes):
            fail(f'checkpoint: request {i} codes differ between the loaded and the '
                 'in-memory model')
    return dict(files_mb={m: f.stat().st_size / 1e6 for m, f in files.items()},
                load_s=load_s, requests=len(texts), frames=CKPT['max_new'],
                codes_equal=True, launches={k: v for k, v in launches.items() if v})


def ckpt_native_audio(tmp, tts) -> dict:
    """(b): a 3 s 48 kHz stereo WAV (stdlib writer: the native one writes
    mono) and its left channel through native.audio.wav_write; both read by
    native.audio.load_audio at 24 kHz against utils.load_audio, then
    prepare_prompt through #8."""
    import wave

    import numpy as np
    import torch
    from valle2_tpu_torch import utils
    from valle2_tpu_torch.native import audio as native

    if not native.available():
        fail('checkpoint: native/libvalle_audio.so did not build')
    rs = np.random.RandomState(21)
    sr, n = CKPT['audio_sr'], int(CKPT['audio_s'] * CKPT['audio_sr'])
    stereo = np.stack([speech_like(rs, CKPT['audio_s'], sr),
                       speech_like(rs, CKPT['audio_s'], sr)], axis=1)
    with wave.open(str(tmp / 'stereo.wav'), 'wb') as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(np.round(stereo * 32767).astype('<i2').tobytes())
    native.wav_write(tmp / 'mono.wav', stereo[:, 0], sr)
    edge, errs, dev = CKPT['audio_edge'], {}, torch.device('cuda')
    for name in ('stereo', 'mono'):
        got = native.load_audio(tmp / f'{name}.wav', 24000, device=dev)
        want = utils.load_audio(tmp / f'{name}.wav', 24000, device=dev)
        if got.device.type != 'cuda' or abs(len(got) - len(want)) > 2 \
                or not torch.isfinite(got).all():
            fail(f'checkpoint: native {name} audio of {tuple(got.shape)} on {got.device}')
        m = min(len(got), len(want))
        errs[name] = check_close(f'native load_audio ({name})', got[edge:m - edge],
                                 want[edge:m - edge], 'float32',
                                 dict(atol=AUDIO_ATOL, rtol=0.0))
    reset_counters()
    tokens, codes = tts.prepare_prompt(native.load_audio(tmp / 'stereo.wav', 24000,
                                                         device=dev), 24000,
                                       'we heard the bells ring out at noon.')
    launches = read_counters()
    require_launches('checkpoint', launches, ('rvq_encode',))
    if codes.shape != (int(CKPT['audio_s'] * 75), 8):
        fail(f'checkpoint: prompt codes of {codes.shape}')
    return dict(samples=n, max_abs_err=errs, tolerance=AUDIO_ATOL, edge_samples=edge,
                prompt_frames=len(codes), prompt_tokens=len(tokens),
                launches={k: v for k, v in launches.items() if v})


def ckpt_trace(tmp, tts, texts, pts, pcs) -> tuple[dict, dict]:
    """(c): profiling.trace around one synthesize: trace.json's device kernel
    records name #1 and #6, the stages' annotate ranges are in it, its
    records of the port's kernels beside the launches counted, and
    memory_stats 0 < peak <= limit."""
    import torch
    from valle2_tpu_torch import profiling

    tts.synthesize(texts[0], pts[0], pcs[0])               # warm-up
    torch.cuda.synchronize()
    reset_counters()
    with profiling.trace(tmp / 'trace') as stats:
        tts.synthesize(texts[0], pts[0], pcs[0])
    launches = read_counters()
    with open(stats.path) as f:
        events = json.load(f)['traceEvents']
    names = {e.get('name', '') for e in events}
    kernels = {profiling._kernel_of(e.get('name', '')) for e in events
               if e.get('cat') == 'kernel'}
    for k in ('flash_fwd_kernel', 'step_persistent_kernel'):
        if k not in kernels:
            fail(f'checkpoint: trace.json holds no record of {k} ({sorted(filter(None, kernels))})')
    stages = ('frontend', 'ar_decode', 'nar_refine', 'codec_decode')
    if not set(stages) <= names:
        fail(f'checkpoint: the annotate ranges {set(stages) - names} are not in trace.json')
    mem = profiling.memory_stats()
    if not 0 < mem['peak_bytes_in_use'] <= mem['bytes_limit']:
        fail(f'checkpoint: memory_stats {mem}')
    return dict(trace_mb=stats.path.stat().st_size / 1e6, launches_counted=stats.launches,
                kernel_records=stats.kernel_records, device_records=stats.device_records,
                records_by_kernel=stats.by_kernel, annotate_ranges=list(stages),
                memory_stats=mem), launches


def ckpt_train_cli(tmp) -> tuple[dict, dict]:
    """(d): ``python -m valle2_tpu_torch.train`` (its main, in this process)
    for two synthetic AR steps with --profile and --debug-nans: the trace is
    written and #1 and #3 launched."""
    from valle2_tpu_torch import profiling
    from valle2_tpu_torch import train as ttrain

    cfg = dict(max_steps=CKPT['train_steps'], batch_size=CKPT['train_batch'],
               valid_batch_size=CKPT['train_batch'], log_every_n_steps=1,
               ckpt_every_n_steps=0, dtype='bfloat16', ckpt_path=str(tmp / 'ckpt'),
               log_path=str(tmp / 'logs'))
    (tmp / 'train.json').write_text(json.dumps(cfg))
    reset_counters()
    t0 = time.perf_counter()
    try:
        ttrain.main(['-c', str(tmp / 'train.json'), '-m', 'ValleAR', '--synthetic',
                     '--profile', str(tmp / 'train_trace'), '--debug-nans'])
    finally:
        profiling.enable_nan_checks(False)
    wall = time.perf_counter() - t0
    launches = read_counters()
    require_launches('checkpoint (train CLI)', launches,
                     ('flash_attention_fwd', 'flash_bwd_fused'))
    trace = tmp / 'train_trace' / 'trace.json'
    if not trace.exists() or not (tmp / 'ckpt' / 'ValleAR' / f'step_{CKPT["train_steps"]}'
                                  / 'state.pt').exists():
        fail('checkpoint: the train CLI wrote no trace or no checkpoint')
    return dict(steps=CKPT['train_steps'], batch=CKPT['train_batch'], wall_s=wall,
                trace_mb=trace.stat().st_size / 1e6,
                launches={k: v for k, v in launches.items() if v}), launches


def ckpt_cold_start() -> dict:
    """(e): coldstart_bench in fresh processes over the build directory that
    phase build filled: every library loads from disk, none is built."""
    import os
    out = {}
    for mode in CKPT['cold_modes']:
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, '-m', 'valle2_tpu_torch.tools.coldstart_bench',
                            mode], cwd=ROOT, capture_output=True, text=True, timeout=300,
                           env={**os.environ, 'PYTHONPATH': str(ROOT)})
        if r.returncode != 0:
            fail(f'checkpoint: coldstart_bench {mode} exited {r.returncode}:\n'
                 f'{r.stderr[-3000:]}')
        line = json.loads(r.stdout.strip().splitlines()[-1])
        if line['aot_compiles'] != 0 or line['aot_disk_loads'] < 1 or line['aot_fallbacks']:
            fail(f'checkpoint: coldstart_bench {mode} built or failed to load: {line}')
        out[mode] = dict(line, process_s=time.perf_counter() - t0)
    return out


def phase_checkpoint(smi: str) -> dict:
    """Weights in and cold start (parts a-e above).  Returns the launches of
    (a), (b), (c) and (d): the kernels line's path 'checkpoint'."""
    import tempfile
    from pathlib import Path

    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.tts import ValleTTS

    texts, pts, pcs = make_requests()
    total = dict.fromkeys(read_counters(), 0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        a = ckpt_roundtrip(tmp, texts, pts, pcs)
        add_counts(total, a['launches'])
        tts = ValleTTS(ConfigValle(max_audio_len=CKPT['trace_max_new'], ignore_eos=True,
                                   dropout=0.0, num_beams=1, dtype='bfloat16'),
                       device='cuda')
        b = ckpt_native_audio(tmp, tts)
        add_counts(total, b['launches'])
        c, launches = ckpt_trace(tmp, tts, texts, pts, pcs)
        add_counts(total, launches)
        d, launches = ckpt_train_cli(tmp)
        add_counts(total, launches)
    e = ckpt_cold_start()
    emit(phase='checkpoint', card=smi, roundtrip=a, native_audio=b, trace=c, train_cli=d,
         cold_start=e, first_request_s={m: e[m]['first_request_s'] for m in e})
    return total


# Phase grammar: (a) remat at the 204M grammar widths (tools.grammar_production
# --scale 204m), one bf16 AR step of dropout 0.1 at (batch, frames) with s =
# frames * 5 / 4: s=640 (#3) and s=1280 (#4 + #5); (b) the reference-width
# grammar (--scale ref) on `dataset` (fewer sentence pairs than the tool's
# 540: 37 steps an epoch): AR, NAR and ASR trained train_epochs epochs on the
# card, then both evaluation suites on `held` held-out sentences; (c)
# quant_quality's grid over (b)'s weights, --limit held.
GRAMMAR = dict(remat_runs=((16, 512), (8, 1024)), remat_seed=5, train_epochs=1, held=4,
               dataset='grammar://speakers=4,pairs=64')
# Remat against the plain stack: the forward is the same launches on the same
# inputs, so the loss is bit-equal, and so are the grads wherever the plain
# step repeats bit for bit (the split backward #4 + #5).  #3 sums dq through
# atomics in an order that changes from run to run (TOL's reason): where a
# second plain step already differs from the first, a leaf may part by at
# most 16 bf16 ulps (2^-8 each) of its largest |grad| -- flipped roundings of
# dq carried through the bf16 backward of the layers below; two plain steps
# at the 204M shape parted by 1.7e-2 (4.4 ulps).  The negative control
# (wrong_replay) measures what a wrong dropout mask in the recompute gives
# and fails the run unless it lies beyond this limit.
REMAT_GRAD_RTOL = 16 * 2.0 ** -8


@contextlib.contextmanager
def wrong_replay():
    """The remat recompute drawing its dropout masks from the caller's
    generator as it stands at the backward (after the whole forward's
    draws) instead of a copy set to the layer's start state: the fault the
    replay guards against, for grammar_remat's negative control."""
    import importlib

    from torch.utils.checkpoint import checkpoint
    # the module (the package re-exports a function of the same name)
    tr = importlib.import_module('valle2_tpu_torch.ops.transformer')
    inner = tr._remat_layer

    def faulty(p, x, n_heads, bias, cond, flash=None, dropout_rate=0.0, generator=None):
        def run(x):
            return tr.encoder_layer(p, x, n_heads, bias, cond, flash=flash,
                                    dropout_rate=dropout_rate, generator=generator)
        return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
    tr._remat_layer = faulty
    try:
        yield
    finally:
        tr._remat_layer = inner


def grammar_batch(b: int, frames: int, device, vocab: int, audio: int):
    """An AR batch of the grammar's vocabularies: tokens frames // 4 long,
    every row full."""
    import numpy as np
    import torch
    rs = np.random.RandomState(GRAMMAR['remat_seed'])
    tt = frames // 4
    data = {'tokens': rs.randint(0, vocab, (b, tt)), 'tokens_lens': np.full(b, tt),
            'codes': rs.randint(0, audio + 2, (b, frames)),
            'target': rs.randint(0, audio + 1, (b, frames)), 'codes_lens': np.full(b, frames)}
    return {k: torch.tensor(v, dtype=torch.int32, device=device) for k, v in data.items()}


def remat_arm(params, leaves, cfg, batch, remat: bool) -> dict:
    """One AR loss and its grads with ``remat`` (the generator of step 0 of
    seed 1): loss, grads, ms, the step's peak memory above what was allocated
    before it, and the launches."""
    import dataclasses

    import torch
    from valle2_tpu_torch.config import precision_scope
    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.train import step_generator

    c = dataclasses.replace(cfg, remat=remat)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with precision_scope(c):
        loss, _ = ar_mod.loss_fn(params, c, batch, step_generator(1, 0, batch['codes'].device))
        grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return dict(loss=loss.detach(), grads=grads, ms=1e3 * (time.perf_counter() - t0),
                step_peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=read_counters())


def grads_apart(a, b) -> tuple[bool, float]:
    """(bit-equal, the largest per-leaf max |a - b| over the leaf's max |b|)."""
    worst, equal = 0.0, True
    for x, y in zip(a, b):
        equal = equal and bool((x == y).all())
        scale = float(y.abs().max())
        if scale > 0:
            worst = max(worst, float((x - y).abs().max()) / scale)
    return equal, worst


def grammar_remat(smi: str) -> tuple[dict, dict]:
    """(a): remat off, on, and off again at each of GRAMMAR['remat_runs'], a
    warm-up step first: the loss bit-equal, the grads bit-equal (or within
    REMAT_GRAD_RTOL where the plain step does not repeat bit for bit), #1 (or
    #2) launched twice a layer with remat and once without, the backward
    kernels once a layer either way; step ms and peak memory of each; at
    s=640 the negative control (wrong_replay) beyond REMAT_GRAD_RTOL."""
    from pathlib import Path

    import torch
    from valle2_tpu_torch.config import ConfigValle, resolve_device
    from valle2_tpu_torch.tools.grammar_production import base_config
    from valle2_tpu_torch.train import init_state, tree_leaves

    dev = resolve_device()
    cfg = ConfigValle.from_dict(dict(base_config(Path('.'), scale='204m'), dropout=0.1))
    params = init_state(cfg, 'ValleAR', device=dev).params
    leaves = tree_leaves(params)
    total = dict.fromkeys(read_counters(), 0)
    out = {}
    for b, frames in GRAMMAR['remat_runs']:
        batch = grammar_batch(b, frames, dev, cfg.vocab_size, cfg.num_audio_tokens)
        s = frames // 4 + frames
        remat_arm(params, leaves, cfg, batch, False)          # warm-up
        plain = remat_arm(params, leaves, cfg, batch, False)
        remat = remat_arm(params, leaves, cfg, batch, True)
        again = remat_arm(params, leaves, cfg, batch, False)
        control = None
        if s == 640:
            with wrong_replay():
                control = grads_apart(remat_arm(params, leaves, cfg, batch, True)['grads'],
                                      plain['grads'])[1]
            if not control > REMAT_GRAD_RTOL:
                fail(f'grammar (remat, b={b}, s={s}): a recompute from the wrong generator '
                     f'state parts the grads by only {control:.3e}, within the limit '
                     f'{REMAT_GRAD_RTOL:g}')
        add_counts(total, remat['launches'])
        add_counts(total, plain['launches'])
        label = f'grammar (remat, b={b}, s={s})'
        if not torch.equal(plain['loss'], remat['loss']) or not torch.isfinite(plain['loss']):
            fail(f'{label}: loss {float(remat["loss"])} with remat, {float(plain["loss"])} '
                 'without')
        bits, worst = grads_apart(remat['grads'], plain['grads'])
        repeat_bits, repeat_worst = grads_apart(again['grads'], plain['grads'])
        if not all(bool(torch.isfinite(g).all()) for g in remat['grads']):
            fail(f'{label}: a non-finite grad with remat')
        if (repeat_bits and not bits) or worst > REMAT_GRAD_RTOL:
            fail(f'{label}: grads part by {worst:.3e} of a leaf\'s max |grad| (bit-equal '
                 f'{bits}); the plain step repeats bit-equal {repeat_bits}, '
                 f'{repeat_worst:.3e} apart')
        fwd = {k: a['launches']['flash_attention_fwd'] + a['launches']['flash_attention_fwd_folded']
               for k, a in (('plain', plain), ('remat', remat))}
        bwd_names = ('flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv')
        bwd = {k: {n: a['launches'][n] for n in bwd_names} for k, a in (('plain', plain),
                                                                         ('remat', remat))}
        if fwd['plain'] != cfg.num_layers or fwd['remat'] != 2 * cfg.num_layers \
                or bwd['plain'] != bwd['remat'] or max(bwd['plain'].values()) != cfg.num_layers:
            fail(f'{label}: forward launches {fwd}, backward {bwd} over {cfg.num_layers} layers')
        out[f's{s}'] = dict(
            batch=b, frames=frames, s=s, loss=float(plain['loss']), grads_bit_equal=bits,
            worst_leaf_rel_diff=worst, plain_repeat_bit_equal=repeat_bits,
            plain_repeat_worst=repeat_worst, wrong_replay_worst=control,
            flash_fwd_launches=fwd, bwd_launches=bwd,
            step_ms={'plain': plain['ms'], 'remat': remat['ms']},
            step_peak_gb={'plain': plain['step_peak_gb'], 'remat': remat['step_peak_gb']},
            peak_gb={'plain': plain['peak_gb'], 'remat': remat['peak_gb']},
            tol=f'loss bit-equal; grads bit-equal where the plain step repeats bit for bit, '
                f'else per leaf max|dg| <= {REMAT_GRAD_RTOL:g}*max|g|', card=smi)
        del plain, remat, again, batch
    del params, leaves
    torch.cuda.empty_cache()
    return out, total


@contextlib.contextmanager
def checked_decodes(label: str, seen: dict):
    """Every ValleAR.generate_batch inside must launch #1 (or #2) and a
    fused decode step and no plain fused call; each call's launches are
    added to ``seen``, and under the key (weight_dtype, kv_cache_dtype,
    use_fused_decode) of its config."""
    from valle2_tpu_torch.models.ar import ValleAR
    inner = ValleAR.generate_batch

    def wrapped(self, *args, **kw):
        before, plain0 = read_counters(), plain_calls()
        result = inner(self, *args, **kw)
        delta = {k: v - before[k] for k, v in read_counters().items()}
        fused = sum(v for k, v in delta.items() if k.startswith('fused_decode_step'))
        flash = delta['flash_attention_fwd'] + delta['flash_attention_fwd_folded']
        c = self.config
        if flash <= 0 or plain_calls() != plain0 \
                or (fused <= 0) == (c.use_fused_decode is not False):
            fail(f'{label}: a decode launched #1 {flash} times, the fused steps {fused} '
                 f'times, {plain_calls() - plain0} plain fused calls '
                 f'(use_fused_decode={c.use_fused_decode})')
        add_counts(seen.setdefault('all', {}), delta)
        add_counts(seen.setdefault((c.weight_dtype, c.kv_cache_dtype, c.use_fused_decode), {}),
                   delta)
        return result
    ValleAR.generate_batch = wrapped
    try:
        yield seen
    finally:
        ValleAR.generate_batch = inner


def grammar_train_eval(tmp, smi: str) -> tuple[dict, dict, dict]:
    """(b): the reference-width grammar trained on the card through
    train_grammar_model, its run dir written (params files and report.json in
    grammar_production's layout), then grammar_production.evaluate's v1 and
    v3 suites (smoke: 4 held-out sentences) under checked_decodes, and the
    greedy evaluations run again to equal the first run.  Returns (record,
    launches, (cfg, report, trained AR params))."""
    import dataclasses

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import grammar as gm
    from valle2_tpu_torch.models.checkpoint import save_params
    from valle2_tpu_torch.tools import grammar_production as gp

    cfg = dict(gp.base_config(tmp, scale='ref'), dataset=GRAMMAR['dataset'])
    conf = ConfigValle.from_dict(cfg)
    train_ds, valid_ds, _ = gm.build_grammar_datasets(conf)
    reset_counters()
    runs, curves, trained = {}, {}, {}
    t0 = time.perf_counter()
    for name, over in (('ValleAR', {}), ('ValleNAR', {'norm': 'AdaptiveLayerNorm'}),
                       ('ValleASR', {'direction': 'asr'})):
        params, curve = gm.train_grammar_model(
            name, dataclasses.replace(conf, **over), train_ds, valid_ds,
            max_epochs=GRAMMAR['train_epochs'], loss_target=0.0, device='cuda')
        save_params(tmp / f'{name}.pt', params)
        runs[name] = {'final_ckpt': str(tmp / f'{name}.pt')}
        runs[f'{name}_config'] = over
        curves[name] = curve
        trained[name] = params
        if not all(torch.isfinite(torch.tensor(curve['train_loss'] + curve['valid_loss']))):
            fail(f'grammar (train): {name} losses {curve}')
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_counters()
    require_launches('grammar (train)', launches, ('flash_attention_fwd', 'flash_bwd_fused'))
    steps = len(train_ds) // conf.batch_size * GRAMMAR['train_epochs']
    report = {'config': cfg, 'runs': runs}
    (tmp / 'report.json').write_text(json.dumps(report))

    seen: dict = {}
    t0 = time.perf_counter()
    v3_cfg = dict(cfg, dataset=GRAMMAR['dataset'] + ',variants=3,real=0')
    with checked_decodes('grammar (eval)', seen):
        evals = {'v1': gp.evaluate(cfg, report, tmp, smoke=True, device='cuda'),
                 'v3': gp.evaluate(v3_cfg, report, tmp, smoke=True, v3=True, device='cuda')}
        eval_s = time.perf_counter() - t0
        ar, nar, asr = gp.load_models(cfg, report, 'cuda')
        tok = gm.PhonemeTokenizer(use_g2p=False)
        train_sents, held = gm.split_sentences()
        held = held[:GRAMMAR['held']]
        v2_spec = gm.build_grammar_datasets(conf)[2]
        v3_spec = gm.build_grammar_datasets(ConfigValle.from_dict(v3_cfg))[2]
        again = {
            'closed_loop': {k: v for k, v in gm.evaluate_closed_loop(
                ar, nar, asr, held, v2_spec, tok, prompt_text=train_sents[0],
                speaker=0).items() if k != 'texts'},
            'prompt_conditioning': gm.evaluate_prompt_conditioning(
                ar, held, v2_spec, tok, prompt_text=train_sents[0]),
            'prompt_conditioning_v3': gm.evaluate_prompt_conditioning_v3(
                ar, held, v3_spec, tok, prompt_text=train_sents[0])}
    again['nar_refinement'] = gm.evaluate_nar_refinement(
        nar, held, v3_spec, tok, prompt_text=train_sents[0], corrupt=(0.0, 0.2))
    first = {'closed_loop': evals['v1']['closed_loop'][0],
             'prompt_conditioning': evals['v1']['prompt_conditioning'],
             'prompt_conditioning_v3': evals['v3']['prompt_conditioning_v3'],
             'nar_refinement': evals['v3']['nar_refinement']}
    for k, v in first.items():
        if again[k] != v:
            fail(f'grammar (eval): the greedy {k} differs on a second run: {v} then {again[k]}')
    add_counts(launches, seen.get('all', {}))
    record = dict(
        steps_per_model=steps, batch=conf.batch_size, train_s=train_s,
        train_loss={k: c['train_loss'] for k, c in curves.items()},
        valid_loss={k: c['valid_loss'] for k, c in curves.items()},
        eval_s=eval_s, greedy_repeat_equal=True, decodes_checked=True,
        v1={'closed_loop_speaker0': evals['v1']['closed_loop'][0],
            'prompt_match_exact': evals['v1']['prompt_conditioning']['match_exact'],
            'best_of_n': evals['v1']['best_of_n']},
        v3={'tts_validity_speaker0': evals['v3']['closed_loop_v3'][0]['tts_validity'],
            'nll': evals['v3']['nll'],
            'temperature_curve': [{k: r[k] for k in ('temperature', 'validity', 'tv_distance')}
                                  for r in evals['v3']['temperature_curve']],
            'best_of_n_validity': evals['v3']['best_of_n_validity'],
            'nar_refinement': evals['v3']['nar_refinement']['by_eps']},
        card=smi)
    return record, launches, (cfg, report, trained['ValleAR'])


def quant_variant(weight_dtype: str, kv_cache_dtype: str) -> str:
    """The fused step counter a (weight, cache) serving config launches."""
    v = {'compute': '', 'int8': 'w8a8', 'int4': 'w4a16'}[weight_dtype]
    if kv_cache_dtype == 'int8':
        v = f'{v}_kv8' if v else 'kv8'
    return step_name('fused_decode_step', v or 'dense')


def grammar_quant(tmp, trained, smi: str) -> tuple[dict, dict]:
    """(c): tools.quant_quality over (b)'s run dir as grammar_production
    writes it (a bf16 model: the float32-cache cells serve it over an f32
    cache), --limit GRAMMAR['held'], under checked_decodes: every cell
    scores; each fused cell launched its #6 / #6a variant, whole or chunked,
    and no other step; an unfused cell launched none; the reference cell's
    (compute weights, f32 cache, per-layer step) greedy codes == the
    in-memory trained model's under the same config."""
    import dataclasses

    import numpy as np
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import grammar as gm
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.tools import quant_quality as qq

    cfg, report, ar_params = trained
    qdir = tmp / 'quant'
    qdir.mkdir()
    qcfg = cfg
    if qcfg['dtype'] != 'bfloat16':
        fail(f"grammar (quant): the run dir's model is {qcfg['dtype']}, not bfloat16")
    (qdir / 'report.json').write_text(json.dumps(dict(report, config=qcfg)))
    seen: dict = {}
    t0 = time.perf_counter()
    with checked_decodes('grammar (quant)', seen):
        qq.main(['--run-dir', str(qdir), '--limit', str(GRAMMAR['held']), '--device', 'cuda',
                 '--out', str(qdir / 'quant_quality.json')])
    wall = time.perf_counter() - t0
    rep = json.loads((qdir / 'quant_quality.json').read_text())
    errors = {n: c['error'] for n, c in rep['grid'].items() if 'error' in c}
    if errors or len(rep['grid']) != 18:
        fail(f'grammar (quant): cells failed: {errors}')
    steps = {}
    for w, k, fused in qq.cells():
        d = seen.get((w, k, fused), {})
        launched = {n: v for n, v in d.items() if n.startswith('fused_decode_step') and v}
        want = quant_variant(w, k)
        if fused and (not launched or set(launched) - {want, f'{want}_chunked'}):
            fail(f'grammar (quant): cell {qq.cell_name(w, k, fused)} launched {launched}, '
                 f'not {want}')
        if not fused and launched:
            fail(f'grammar (quant): unfused cell {qq.cell_name(w, k, fused)} launched '
                 f'{launched}')
        steps[qq.cell_name(w, k, fused)] = sum(launched.values())

    conf = ConfigValle.from_dict(qcfg)
    ref_cfg = dataclasses.replace(conf, temperature=0.0, num_beams=1, weight_dtype='compute',
                                  kv_cache_dtype='float32', use_fused_decode=False)
    ref = ValleAR(ref_cfg, device='cuda')
    ref.load(report['runs']['ValleAR']['final_ckpt'])
    mem = ValleAR(ref_cfg, params=ar_params, device='cuda')
    tok = gm.PhonemeTokenizer(use_g2p=False)
    train_sents, held = gm.split_sentences()
    spec = gm.build_grammar_datasets(conf)[2]
    with checked_decodes('grammar (quant reference)', seen):
        got, _ = qq.decode_cell(ref, held[:GRAMMAR['held']], spec, tok, train_sents[0], 0,
                                False)
        p_toks = tok(train_sents[0] + ' ')
        want = mem.generate_batch([np.concatenate([p_toks, tok(s)])
                                   for s in held[:GRAMMAR['held']]],
                                  [gm.synthesize_codes(p_toks, spec, 0).T] * len(got))
    if not all(np.array_equal(g, w.numpy()) for g, w in zip(got, want)):
        fail('grammar (quant): the reference cell\'s greedy codes differ from the in-memory '
             'model\'s')
    return dict(wall_s=wall, cells=len(rep['grid']), recommended=rep['recommended'],
                reference_quality=rep['reference_quality'], step_launches=steps,
                grid={n: {k: c[k] for k in ('quality', 'token_acc', 'nll_per_token',
                                            'decode_wall_s', 'tokens_per_s')}
                      for n, c in rep['grid'].items()},
                reference_codes_equal=True, frames=[len(g) for g in got],
                card=smi), seen.get('all', {})


def phase_grammar(smi: str) -> dict:
    """Phase grammar (a)-(c) above; returns the launches of all three: the
    kernels line's path 'grammar'."""
    import tempfile
    from pathlib import Path

    total = dict.fromkeys(read_counters(), 0)
    t0 = time.perf_counter()
    remat, launches = grammar_remat(smi)
    add_counts(total, launches)
    remat_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        train, launches, trained = grammar_train_eval(tmp, smi)
        add_counts(total, launches)
        quant, launches = grammar_quant(tmp, trained, smi)
        add_counts(total, launches)
    require_launches('grammar', total, (
        'flash_attention_fwd', 'flash_bwd_fused', 'flash_bwd_dq', 'flash_bwd_dkv',
        'fused_decode_step', *(f'fused_decode_step_{v}' for v in QUANT_VARIANTS)))
    emit(phase='grammar', card=smi, remat=remat, remat_s=remat_s, train_eval=train,
         quant=quant, launches={k: v for k, v in total.items() if v})
    return total


def dataset_items(n: int = 32, seed: int = 15):
    """n in-memory HF-style items, 1-4 s at 16 / 22.05 / 24 kHz."""
    import numpy as np
    rs = np.random.RandomState(seed)
    words = 'the a dog cat ran sat home fast slow red blue green one two'.split()
    items = []
    for i in range(n):
        sr = (16000, 22050, 24000)[i % 3]
        text = ' '.join(rs.choice(words, rs.randint(3, 9))) + '.'
        items.append({'audio': {'array': speech_like(rs, rs.uniform(1.0, 4.0), sr),
                                'sampling_rate': sr}, 'text': text})
    return items


def phase_data():
    """Tokenize an in-memory audio dataset through the codec (disk cache),
    reload it with no encode, and train 3 AR steps on it."""
    import tempfile
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.codec import Encodec
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import DataLoader, ValleDataset, get_collate
    from valle2_tpu_torch.data.prefetch import to_device
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    cfg = ConfigValle(dropout=0.1, batch_size=8, dtype='bfloat16')
    items = dataset_items()
    audio_s = sum(len(it['audio']['array']) / it['audio']['sampling_rate'] for it in items)
    codec = Encodec(seed=0, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        ValleDataset(items[:2], cfg, codec).precompute_codes(batch_size=16)   # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        first = ValleDataset(items, cfg, codec)
        first.precompute_codes(batch_size=16, cache_dir=tmp)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        launches = read_counters()
        require_launches('data', launches, ('rvq_encode',))
        reset_counters()
        second = ValleDataset(items, cfg, Encodec(seed=0, device=dev))
        second.precompute_codes(batch_size=16, cache_dir=tmp)
        reloaded = read_counters()['rvq_encode']
        if reloaded != 0:
            fail(f'data: loading the disk cache launched rvq_encode {reloaded} times')
        for i in range(len(items)):
            a, b = first[i], second[i]
            sr = items[i]['audio']['sampling_rate']
            samples = -(-len(items[i]['audio']['array']) * 24000 // sr)   # resampled
            frames = -(-samples // 320)
            if not (np.array_equal(a['codes'], b['codes'])
                    and np.array_equal(a['tokens'], b['tokens'])) \
                    or a['codes'].shape != (8, frames):
                fail(f'data: item {i} codes {a["codes"].shape} (want (8, {frames})) or the '
                     'reloaded cache differs')
    state = init_state(cfg, 'ValleAR', device=dev)
    step = make_train_step(cfg, 'ValleAR')
    loader = DataLoader(second, cfg.batch_size, get_collate('ValleAR')(cfg), shuffle=True)
    losses = []
    for i, batch in zip(range(3), loader):
        state, m = step(state, to_device(batch, dev), i)
        losses.append(float(m['loss']))
    if len(losses) != 3 or not all(np.isfinite(losses)):
        fail(f'data: train losses {losses}')
    emit(phase='data', items=len(items), audio_s=audio_s, encode_s=encode_s,
         audio_s_per_s=audio_s / encode_s, launches=launches, cache_reload_launches=reloaded,
         train_losses=losses)
    return launches


@contextlib.contextmanager
def fold_env(value: str):
    """``VALLE2_FLASH_FOLD`` set to ``value`` inside, as it was outside."""
    import os
    old = os.environ.get(FOLD_ENV)
    os.environ[FOLD_ENV] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(FOLD_ENV, None)
        else:
            os.environ[FOLD_ENV] = old


def require_fold_arm(label: str, arm: str, launches: dict, names=()) -> None:
    """The fold arm launched #2 and no #1 forward, the off arm the reverse,
    and each launched ``names``."""
    on, off = 'flash_attention_fwd_folded', 'flash_attention_fwd'
    if arm == 'off':
        on, off = off, on
    if launches[on] <= 0 or launches[off] != 0:
        fail(f'fold ({label}, {arm} arm): {launches[on]} launches of {on}, '
             f'{launches[off]} of {off}')
    require_launches(f'fold ({label}, {arm} arm)', launches, names)


def phase_flash_tc_kernels(results: dict):
    """#1's tensor-core route (bf16) against its plain version at every head
    dim it takes (FLASH_TC_CASES: a ragged s, causal and bidirectional, the
    last batch row with tokens_valid == 0), #2 bit for bit against it; times
    of the tensor-core route, the CUDA-core route (the f32 body with bf16
    operands), SDPA and the plain version, and the bound."""
    import torch
    from valle2_tpu_torch.kernels import flash_attention as fa

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(41)
    with torch.no_grad():
        for case, (b, h, s, tt, hd) in FLASH_TC_CASES.items():
            meta = train_meta(b, tt, s - tt, dev, seed=5)
            meta[-1, 0] = 0
            for causal in (True, False):
                args = (meta, tt, causal)
                q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, torch.bfloat16)
                           for _ in range(3))
                o, lse = fa.flash_attention(q, k, v, *args, fold_heads=False)
                o2, lse2 = fa.flash_attention_folded(q, k, v, *args)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, *args)
                torch.cuda.synchronize()
                label = f'{case} ({"causal" if causal else "bidirectional"})'
                err = max(check_close(f'flash o {label}', o, o_ref, 'bfloat16'),
                          check_close(f'flash lse {label}', lse, lse_ref, 'float32'))
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    fail(f'#2 {label}: differs from #1 on the same inputs')
                mask = attend_mask(meta, s, tt, causal)
                r = dict(max_abs_err=err,
                         ms=cuda_ms(lambda: fa.flash_attention(q, k, v, *args,
                                                               fold_heads=False)),
                         cuda_cores_ms=cuda_ms(lambda: fa.flash_attention_cuda_cores(q, k, v,
                                                                                     *args)),
                         plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, *args)),
                         library_ms=sdpa_ms(q, k, v, mask), tol=tol_str('bfloat16'))
                r['bound_ms'], r['bound_by'] = bound(
                    4 * q.numel() * 2 + lse.numel() * 4, 2 * 2 * hd * int(mask.sum()) * h,
                    'bfloat16')
                results[('flash_attention_fwd', f'{case}_{int(causal)}', 'bfloat16')] = r
                emit(phase='kernels', path='flash_tc', case=case, causal=causal,
                     shape=[b, h, s, hd], tokens_valid_zero_row=b - 1, equal_to_fold=True,
                     **r)


FOLD_DESIGN = {   # how csrc/flash_attention.cu computes #2 in each dtype
    'bfloat16': 'wgmma+tma, persistent, warp-specialised: one producer, two consumer '
                'warpgroups taking a group\'s heads in turns',
    'float32': 'cuda cores: #1\'s register-tiled FFMA body fed by cp.async, persistent '
               'over the same item schedule'}


def phase_fold_kernels(results: dict):
    """#2 against its plain version and against #1 on the same inputs
    (bit-equal: the same 64-key tiles, element ownership and per-row order,
    see csrc/flash_attention.cu) at FOLD_CASES, f32 with TF32 off and bf16,
    and bit for bit against itself on a second call; its design and item
    schedule (fold_plan); times of #2, #1, SDPA and the plain version, and
    the bound."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import flash_attention as fa

    dev = torch.device('cuda')
    hd = SLICE['hd']
    gen = torch.Generator().manual_seed(3)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.no_grad():
        for case, (b, h, s, tt, causal) in FOLD_CASES.items():
            meta = train_meta(b, tt, s - tt, dev, seed=4)
            meta[-1, 0] = 0
            mask = attend_mask(meta, s, tt, causal)
            pairs = int(mask.sum()) * h
            args = (meta, tt, causal)
            for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
                q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, dt)
                           for _ in range(3))
                o, lse = fa.flash_attention_folded(q, k, v, *args)
                o1, lse1 = fa.flash_attention(q, k, v, *args, fold_heads=False)
                o_ref, lse_ref = fa.flash_attention_plain(q, k, v, *args)
                o2, lse2 = fa.flash_attention_folded(q, k, v, *args)
                torch.cuda.synchronize()
                err = max(check_close(f'folded o ({case})', o, o_ref, dtype_name),
                          check_close(f'folded lse ({case})', lse, lse_ref, 'float32'))
                if not (torch.equal(o, o1) and torch.equal(lse, lse1)):
                    fail(f'folded ({case}, {dtype_name}): o or lse differs from #1 on the same '
                         f'inputs by {(o.float() - o1.float()).abs().max().item():.3e}')
                if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
                    fail(f'folded ({case}, {dtype_name}): a second call differs from the '
                         'first')
                plan = fa.fold_plan_for(q, tt, causal)
                r = dict(max_abs_err=err,
                         ms=cuda_ms(lambda: fa.flash_attention_folded(q, k, v, *args)),
                         per_head_ms=cuda_ms(lambda: fa.flash_attention(q, k, v, *args,
                                                                        fold_heads=False)),
                         plain_ms=cuda_ms(lambda: fa.flash_attention_plain(q, k, v, *args)),
                         library_ms=sdpa_ms(q, k, v, mask),
                         tol=tol_str(dtype_name) + '; == #1 bit for bit',
                         design=FOLD_DESIGN[dtype_name],
                         schedule=dict(plan._asdict(), slots=fa.fold_slots(dev, dt, hd)))
                r['bound_ms'], r['bound_by'] = bound(4 * q.numel() * q.element_size()
                                                     + lse.numel() * 4, 2 * 2 * hd * pairs,
                                                     dtype_name)
                r['bound_share'] = r['bound_ms'] / r['ms']
                results[('flash_attention_fwd_folded', case, dtype_name)] = r
                emit(phase='kernels', path='fold', case=case, dtype=dtype_name,
                     shape=[b, h, s, hd], causal=causal,
                     per_head_blocks=-(-s // 64) * b * h,
                     tokens_valid_zero_row=b - 1, attended_pairs=pairs,
                     equal_to_per_head=True, repeats_bit_for_bit=True, **r)
                del q, k, v, o, lse, o1, lse1, o_ref, lse_ref, o2, lse2


def fold_train_arms(model: str, b: int, frames: int, n: int, width: dict,
                    total: dict) -> dict:
    """One training configuration through make_train_step in arm runs off,
    then fold (``n`` timed steps each after one untimed); adds the fold
    runs' launches to ``total``.  Raises torch.cuda.OutOfMemoryError where
    the card cannot hold the batch."""
    import math

    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.profiling import nar_train_step_flops, train_step_flops
    from valle2_tpu_torch.train import init_state, make_train_step

    dev = torch.device('cuda')
    cfg = ConfigValle(dropout=0.1, batch_size=b, dtype='bfloat16', **width)
    state = init_state(cfg, model, device=dev)
    step = make_train_step(cfg, model)
    data = bench_data(model, b, frames, dev)
    flops_fn = nar_train_step_flops if model == 'ValleNAR' else train_step_flops
    flops = flops_fn(cfg, b, frames // 4, frames)
    losses, runs = [], []
    with fold_env('0'):
        state, m = step(state, data, 1)                  # warm-up: allocator, cuBLAS
        losses.append(m['loss'])
    for arm in ('off', 'fold'):
        with fold_env(dict(FOLD_ARMS)[arm]):
            reset_counters()
            state, m = step(state, data, 1)
            losses.append(m['loss'])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(n):
                state, m = step(state, data, 1)
                losses.append(m['loss'])
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / n
            launches = read_counters()
        bwd = ('flash_bwd_fused',) if frames // 4 + frames <= 768 else ('flash_bwd_dq',
                                                                        'flash_bwd_dkv')
        require_fold_arm(f'{model}, b={b}x{frames}', arm, launches, bwd)
        if arm == 'fold':
            for k, c in launches.items():
                total[k] += c
        runs.append(dict(arm=arm, step_ms=1e3 * step_s, frames_per_s=b * frames / step_s,
                         model_tflops=flops / step_s / 1e12,
                         mfu_vs_bf16_dense_peak=flops / step_s / PEAK_FLOPS['bfloat16'],
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9))
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        fail(f'fold ({model}, b={b}x{frames}): non-finite loss {losses}')
    # The AR loss on the repeated batch descends; the NAR's is drawn at a
    # random stage each step, so only its finiteness is held.
    if model == 'ValleAR' and not losses[-1] < losses[0]:
        fail(f'fold ({model}, b={b}x{frames}): the loss did not descend: {losses}')
    return dict(model=model, batch=b, frames=frames, s=frames // 4 + frames,
                steps_per_run=n, runs=runs, losses=losses)


def fold_grads() -> list[dict]:
    """f32 with TF32 off, the 204M widths cut to FOLD_GRAD_LAYERS layers: AR,
    and NAR at stage 3, loss and every grad with the fold == without it."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.models import ar as ar_mod
    from valle2_tpu_torch.models import nar as nar_mod
    from valle2_tpu_torch.train import init_state, tree_leaves

    dev = torch.device('cuda')
    cfg = ConfigValle(dropout=0.0, matmul_precision='highest', use_flash_attention=True,
                      **dict(LARGE, num_layers=FOLD_GRAD_LAYERS))
    out = []
    for model, loss in (('ValleAR', lambda p, bt: ar_mod.loss_fn(p, cfg, bt)),
                        ('ValleNAR', lambda p, bt: nar_mod.loss_at_stage(p, cfg, bt, 3))):
        params = init_state(cfg, model, device=dev).params
        leaves = tree_leaves(params)
        batch = synthetic_batch(model, cfg, 4, dev)
        got = {}
        for arm, value in FOLD_ARMS:
            with fold_env(value), precision_scope(cfg):
                reset_counters()
                val, _ = loss(params, batch)
                grads = torch.autograd.grad(val, leaves, allow_unused=True)
                launches = read_counters()
            require_fold_arm(f'grads {model}', arm, launches, ('flash_bwd_fused',))
            got[arm] = (float(val.detach()), [torch.zeros_like(p) if g is None else g
                                              for p, g in zip(leaves, grads)])
        (lf, gf), (lo, go) = got['fold'], got['off']
        if not abs(lf - lo) <= 1e-5 * abs(lo):
            fail(f'fold grads ({model}): loss {lf} with the fold, {lo} without')
        worst = 0.0
        for i, (a, w) in enumerate(zip(gf, go)):
            scale, diff = float(w.abs().max()), float((a - w).abs().max())
            if not torch.isfinite(a).all() or diff > GRAD_RTOL * scale:
                fail(f'fold grads ({model}): leaf {i} {tuple(w.shape)} differs by {diff:.3e}, '
                     f'its max |grad| is {scale:.3e}')
            worst = max(worst, diff / scale if scale > 0 else 0.0)
        out.append(dict(model=model, dtype='float32', layers=FOLD_GRAD_LAYERS,
                        batch=list(batch['codes'].shape), loss_fold=lf, loss_off=lo,
                        leaves=len(leaves), worst_leaf_rel_err=worst,
                        tol=f'max|dg| <= {GRAD_RTOL:g}*max|g| per leaf, loss within 1e-5 '
                            'relative'))
        del params, leaves, batch, got
    return out


def fold_serve_arms(cfg, label: str, smi: str, total: dict) -> None:
    """The serving batch_synthesize of phase main's requests at ``cfg``
    (greedy), VALLE2_FLASH_FOLD=0 then 1 after a warm-up: every waveform
    whole and finite, the fold arm launching #2 and no #1, greedy AR ids
    equal with the fold on and off (#2 is bit-equal to #1 in both dtypes);
    adds the fold arm's launches to ``total``."""
    import numpy as np
    import torch
    from valle2_tpu_torch.tts import ValleTTS

    tts = ValleTTS(cfg, device='cuda')
    texts, pts, pcs = make_requests()
    with fold_env('0'):
        tts.batch_synthesize(texts, pts, pcs)            # warm-up
    torch.cuda.synchronize()
    codes = {}
    for arm, value in FOLD_ARMS:
        with fold_env(value):
            reset_counters()
            batch = tts.batch_synthesize(texts, pts, pcs)
            launches = read_counters()
        for r in batch:
            n = len(r.codes)
            if n != cfg.max_audio_len or r.waveform.shape != (n * 320,) \
                    or not np.isfinite(r.waveform).all():
                fail(f'fold ({label}, {arm}): waveform of {r.waveform.shape} for gen_len '
                     f'{n}')
        require_fold_arm(label, arm, launches, ('fused_decode_step',))
        if arm == 'fold':
            for k, c in launches.items():
                total[k] += c
        codes[arm] = [np.asarray(r.codes) for r in batch]
        t = batch[0].timings
        emit(phase='fold', run=label, dtype=cfg.dtype, arm=arm, requests=len(texts),
             max_audio_len=cfg.max_audio_len,
             stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
             batch_wall_s=t['batched'], rtf=batch[0].rtf,
             launches={k: c for k, c in launches.items() if c}, card=smi)
    for i, (f, o) in enumerate(zip(codes['fold'], codes['off'])):
        if not np.array_equal(f[:, 0], o[:, 0]):
            fail(f'fold ({label}): request {i} greedy AR ids differ with the fold on and '
                 'off')
    emit(phase='fold', run=label, dtype=cfg.dtype, greedy_ar_ids_equal=True,
         all_codes_equal=all(np.array_equal(f, o) for f, o in zip(codes['fold'], codes['off'])))


def phase_fold(smi: str) -> dict:
    """The fold's path: VALLE2_FLASH_FOLD=1 against =0 in turns, (a) the
    serving batch_synthesize (greedy) of phase main's requests, in bf16 and
    in f32 with TF32 off, (b) the 204M AR and NAR train steps and the
    serving-width AR at s=1280, (c) the f32 grads.  Returns the fold arms'
    launches of (a) and (b)."""
    import torch
    from valle2_tpu_torch.config import ConfigValle

    total = dict.fromkeys(counters(), 0)
    base = dict(max_audio_len=SLICE['max_new'], ignore_eos=True, dropout=0.0,
                temperature=0.0)
    fold_serve_arms(ConfigValle(dtype='bfloat16', **base), 'serve', smi, total)
    f32 = ConfigValle(kv_cache_dtype='float32', matmul_precision='highest', **base)
    fold_serve_arms(f32, 'serve_f32', smi, total)
    torch.cuda.empty_cache()

    for model, b, frames, n in FOLD_TRAIN:
        res = None
        try:
            res = fold_train_arms(model, b, frames, n, LARGE, total)
        except torch.cuda.OutOfMemoryError:
            if model != 'ValleNAR' or b != 16:
                raise
        if res is None:          # out of the except block: its frames are freed
            torch.cuda.empty_cache()
            emit(phase='fold', run='train', model=model, batch=b, note='out of memory, b=8')
            res = fold_train_arms(model, 8, frames, n, LARGE, total)
        emit(phase='fold', run='train', width='204M', **LARGE, dtype='bfloat16', card=smi,
             **res)
        torch.cuda.empty_cache()
    model, b, frames, n = FOLD_LONG
    emit(phase='fold', run='train', width='serving', dtype='bfloat16', card=smi,
         **fold_train_arms(model, b, frames, n, {}, total))

    for r in fold_grads():
        emit(phase='fold', run='grads', card=smi, **r)
    emit(phase='fold', launches={k: c for k, c in total.items() if c})
    return total


GEMM_DESIGN = {   # how csrc/gemm.cu computes each kernel
    'matmul_fullk': 'wgmma+tma, persistent, warp-specialised',
    'matmul_ksplit': 'wgmma+tma, warp-specialised, cluster split-K (DSMEM reduction)'}


def phase_gemm(results: dict, smi: str) -> dict:
    """The GEMM roofline probe (valle2_tpu_torch.probes.gemm_roofline) at its
    three shapes, counts zeroed before and read after; then #9 and #10 (the
    128 x 128 tile; #10 in 2 K slices) held against matmul_plain on the same
    inputs, with the plain version's time.  Each record carries the probe's
    share of the bf16 peak and its back-to-back time, per arm."""
    import torch
    from valle2_tpu_torch.kernels import gemm
    from valle2_tpu_torch.probes import gemm_roofline as probe

    reset_counters()
    records = probe.run(reps=30)
    launches = read_counters()
    require_launches('gemm', launches, ('matmul_fullk', 'matmul_ksplit'))
    by = {(r['shape'], r['arm']): r for r in records}
    tol = 'per element |err| <= 2^-7*|plain| + K*2^-24*max|a|*max|b|'
    for sname, m, k, n in probe.SHAPES:
        a, b = probe.operands(m, k, n, 'cuda')
        want = gemm.matmul_plain(a, b)
        allowed = probe.tolerance(a, b, want)
        plain_ms = cuda_ms(lambda: gemm.matmul_plain(a, b))
        for name, fn, arm in (('matmul_fullk', gemm.matmul_fullk, 'cuda_fullk_128x128'),
                              ('matmul_ksplit', gemm.matmul_ksplit, 'cuda_ksplit_128x128_k2')):
            got = fn(a, b)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            if not torch.isfinite(got).all() or bool((err > allowed).any()):
                fail(f'{name} ({sname}): max |err| {err.max().item():.3e} over {tol}')
            kind = 'fullk' if name == 'matmul_fullk' else 'ksplit'
            rec, lib = by[(sname, arm)], by[(sname, 'torch_matmul')]
            arms = {a_: r for (s_, a_), r in by.items() if s_ == sname and kind in a_}
            results[(name, sname, 'bfloat16')] = dict(
                max_abs_err=err.max().item(), ms=rec['ms'], plain_ms=plain_ms,
                library_ms=lib['ms'], bound_ms=rec['bound_ms'], bound_by=rec['bound_by'],
                tol=tol, design=GEMM_DESIGN[name], peak_share=rec['peak_share'],
                back_to_back_ms=rec['back_to_back_ms'],
                back_to_back_peak_share=rec['back_to_back_peak_share'],
                library_back_to_back_ms=lib['back_to_back_ms'],
                arms_ms={a_: r['ms'] for a_, r in arms.items()},
                arms_peak_share={a_: r['peak_share'] for a_, r in arms.items()},
                arms_back_to_back_ms={a_: r['back_to_back_ms'] for a_, r in arms.items()})
        emit(phase='gemm', shape=sname, m=m, k=k, n=n, plain_ms=plain_ms,
             torch_matmul_ms=by[(sname, 'torch_matmul')]['ms'],
             **{name: results[(name, sname, 'bfloat16')]
                for name in ('matmul_fullk', 'matmul_ksplit')}, card=smi)
        del a, b, want, allowed
    emit(phase='gemm', launches={k: c for k, c in launches.items() if c})
    return launches


def tp_inputs(case: dict, mp: int, dt, gen, dev):
    """A TP case's inputs on ``dev``: a seeded f32 stack (int4: the ranked
    packing) split over mp ranks, each rank's random (L, rows, S, d / mp)
    cache of its local heads (int8 through quantize_kv_rowmajor), x, the
    lengths and the index (per-row: PER_ROW's depths)."""
    import torch
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, transformer_init
    from valle2_tpu_torch.parallel import make_model_mesh, shard_stack
    s = SLICE
    rows, S, h_loc, da = case['rows'], case['S'], s['h'] // mp, s['d'] // mp
    p = transformer_init(gen, s['L'], s['d'], s['h'], s['dff'], adaptive_norm=False)
    mesh = make_model_mesh(mp, [dev] * mp)
    trees = shard_stack(p, mesh, dt, case['weights'] == 'int4')
    caches = []
    for _ in range(mp):
        ck, cv = (card_randn((s['L'], rows, S, da), gen, dev) for _ in range(2))
        if case['cache'] == 'int8':
            (kq, ks), (vq, vs) = (fd.quantize_kv_rowmajor(c, h_loc) for c in (ck, cv))
            caches.append(KVCache(kq, vq, ks, vs))
        else:
            caches.append(KVCache(ck.to(dt), cv.to(dt)))
    if case['index'] is None and 'K' not in case:
        pr = PER_ROW
        lens = (pr['tokens_lens'], pr['codes_lens'])
        index = torch.tensor([pr['ttm'] + pr['pm'] + g for g in pr['depths']],
                             dtype=torch.int32, device=dev)
        ttm, pm = pr['ttm'], pr['pm']
    else:
        lens = ([112, 97, 81] * (rows // 3), [151] * rows)
        index, ttm, pm = case['index'], SLICE['ttm'], SLICE['pm']
    tl, cl = (torch.tensor(v, dtype=torch.int32, device=dev) for v in lens)
    q_len = case.get('K', 1)
    x = torch.randn(rows, q_len, s['d'], generator=gen).to(dev, dt)
    return mesh, trees, caches, x, index, tl, cl, ttm, pm


def tp_step_bound(trees, caches, rows: int, q_len: int, read_slots: int, mp: int,
                  dtype_name: str, x_elt: int) -> tuple[int, float, str]:
    """(bytes, ms, 'bytes' | 'operations') of one TP step on one card: every
    rank's weights and norms, its cache's valid slots read once and its new
    slots written, x and y, and per layer 5c's two reduces (each rank reads
    mp partials and writes one, f32); the products at the compute peak."""
    from valle2_tpu_torch.train import tree_leaves
    s = SLICE
    L, d, dff, h = s['L'], s['d'], s['dff'], s['h']
    w_bytes = sum(a.numel() * a.element_size() for t in trees for a in tree_leaves(t))
    c = caches[0]
    slot_bytes = 2 * (d // mp) * c.k.element_size() + (2 * (h // mp) * 2 if c.k_scale
                                                       is not None else 0)
    rq = rows * q_len
    nbytes = (w_bytes + mp * L * (read_slots + rq) * slot_bytes + 2 * mp * rq * d * x_elt
              + 2 * L * mp * (mp + 1) * rq * d * 4)
    ops = rq * L * 2 * (4 * d ** 2 + 2 * d * dff) + L * 2 * 2 * read_slots * d * q_len
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_FLOPS[dtype_name]
    return nbytes, 1e3 * max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def tp_twin(label: str, ys, ys_t, c_k, c_t) -> None:
    """Fail unless the persistent TP step's ys and caches equal its phased
    twin's bit for bit, every rank."""
    import torch
    for r, (y, y_t) in enumerate(zip(ys, ys_t)):
        if not torch.equal(y, y_t):
            fail(f'{label}: rank {r}\'s y differs from the phased twin by '
                 f'{(y.float() - y_t.float()).abs().max().item():.3e}')
    for r, (a, b) in enumerate(zip(c_k, c_t)):
        if not all(torch.equal(u, v) for u, v in zip(a, b) if u is not None):
            fail(f'{label}: rank {r}\'s cache differs from the phased twin\'s')


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one ``fn()`` in ms: torch.profiler's time of the
    kernels whose name holds ``kernel`` over ``reps`` calls, per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    return sum(us) / 1e3 / max(len(us), 1)


def tp_sum_case(mp: int, shape, gen, dev) -> dict:
    """5c alone on mp virtual ranks of one card at one partial shape: the
    bare sum (the kernels-line numbers, beside torch.add at mp 2) and the
    path's epilogue (bias and residual, f32), each bit-equal to its plain
    version, one launch and no ordering call a sum; times by CUDA events
    and the device's own (torch.profiler), bounds from the bytes."""
    import torch
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    parts = [torch.randn(*shape, generator=gen).to(dev) for _ in range(mp)]
    bias = [torch.randn(shape[-1], generator=gen).to(dev)] * mp
    x = torch.randn(*shape, generator=gen).to(dev)
    res = [x.clone() for _ in range(mp)]
    n0, calls = ta.COUNTER.count, ta.ordering_calls()
    got, got_e = ta.tp_allreduce(parts), ta.tp_row_reduce(parts, bias, res)
    want, want_e = ta.tp_allreduce_plain(parts), ta.tp_row_reduce_plain(parts, bias, res)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got + got_e, want + want_e)):
        fail(f'tp_allreduce (mp {mp}, {shape}): not the rank-ordered f32 sum and its '
             'epilogue bit for bit')
    if ta.COUNTER.count - n0 != 2 or ta.ordering_calls() != calls:
        fail(f'tp_allreduce (mp {mp}): {ta.COUNTER.count - n0} launches for 2 sums, '
             f'{ta.ordering_calls() - calls} ordering calls on one card')
    n = parts[0].numel() * 4
    nbytes = (2 * mp) * n                       # mp partials read, mp outputs written
    nbytes_e = (3 * mp) * n + mp * shape[-1] * 4   # and mp residuals, mp biases read
    res_d = dict(max_abs_err=0.0, ms=cuda_ms(lambda: ta.tp_allreduce(parts)),
                 plain_ms=cuda_ms(lambda: ta.tp_allreduce_plain(parts)),
                 bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_by='bytes',
                 library_ms=(cuda_ms(lambda: torch.add(parts[0], parts[1]))
                             if mp == 2 else None), tol='bit-equal',
                 device_ms=device_ms(lambda: ta.tp_allreduce(parts), 'tp_row_reduce_kernel'),
                 library_device_ms=(device_ms(lambda: torch.add(parts[0], parts[1]), 'add')
                                    if mp == 2 else None),
                 epilogue_ms=cuda_ms(lambda: ta.tp_row_reduce(parts, bias, res)),
                 epilogue_device_ms=device_ms(lambda: ta.tp_row_reduce(parts, bias, res),
                                              'tp_row_reduce_kernel'),
                 epilogue_plain_ms=cuda_ms(lambda: ta.tp_row_reduce_plain(parts, bias, res)),
                 epilogue_bound_ms=1e3 * nbytes_e / HBM_BYTES_PER_S,
                 enqueue_ms=enqueue_ms(lambda: ta.tp_allreduce(parts)))
    emit(phase='kernels', path='tp', kernel='tp_allreduce', mp=mp, shape=list(shape),
         bytes=nbytes, library='torch.add (mp 2)', **res_d)
    return res_d


def phase_tp_kernels(results: dict):
    """Phase 30: 5c alone, and the persistent TP fused steps (one
    cooperative launch holding the virtual ranks, 5c's element in its reduce
    phases) bit for bit against their phased twin (fd.fused_step_tp_phased:
    a kernel per phase on each rank's stream, 5c between) and within
    tolerance of their plain versions, with virtual ranks on cuda:0; times of
    the persistent step, its twin and the plain version, their host
    enqueue, the launcher's grid against the plan, and the phase trace."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    from valle2_tpu_torch.ops.transformer import KVCache

    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(31)
    cases = {**TP_CASES, 'verify': dict(rows=SPEC['rows'], S=1024, index=None, chunk=None,
                                        weights='compute', cache=None, K=SPEC['K'])}
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for mp in TP_MPS:
            # 5c alone at the serving step's partial, (12 rows, d) f32 per rank,
            # and (mp 2) at the shapes the TP prefill and NAR launch it; its
            # library call: torch.add of the two partials (mp 2).
            shapes = {None: (12, SLICE['d']), **(TP_SUM_SHAPES if mp == 2 else {})}
            for label, shape in shapes.items():
                label = label or (f'mp{mp}' if mp != 2 else None)
                key = ('tp_allreduce', 'float32') if label is None else \
                    ('tp_allreduce', label, 'float32')
                results[key] = tp_sum_case(mp, shape, gen, dev)
            for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
                for label, case in cases.items():
                    verify = 'K' in case
                    name = 'fused_verify_step_tp' if verify else 'fused_decode_step_tp'
                    mesh, trees, caches, x, index, tl, cl, ttm, pm = tp_inputs(
                        case, mp, dt, gen, dev)
                    if verify:
                        index = torch.tensor([ttm + pm + o for o in SPEC['offsets']],
                                             dtype=torch.int32, device=dev)
                    h_loc = SLICE['h'] // mp
                    step = fd.fused_verify_step if verify else fd.fused_decode_step
                    args = (index, tl, cl, ttm, pm)
                    c_k, c_t, c_p = ([KVCache(*(t.clone() for t in c if t is not None))
                                      for c in caches] for _ in range(3))

                    def persistent(c_k=c_k, x=x, h_loc=h_loc, args=args, step=step,
                                   mesh=mesh, trees=trees, case=case):
                        return step(None, x, h_loc, None, *args, chunk_override=case['chunk'],
                                    tp=(mesh, trees, c_k))

                    def phased(c_t=c_t, x=x, h_loc=h_loc, args=args, name=name, mesh=mesh,
                               trees=trees, case=case):
                        return fd.fused_step_tp_phased(name, mesh, trees, c_t, x, h_loc, *args,
                                                       chunk_override=case['chunk'])
                    ys, _ = persistent()
                    ys_t, _ = phased()
                    ys_ref, _ = fd._step_plain_tp(name, trees, [x] * mp, h_loc, c_p, *args,
                                                  case['chunk'])
                    torch.cuda.synchronize()
                    tp_twin(f'{name} ({label}, mp {mp}, {dtype_name})', ys, ys_t, c_k, c_t)
                    if not all(torch.equal(ys[0], y) for y in ys[1:]):
                        fail(f'{name} ({label}, mp {mp}, {dtype_name}): y differs across ranks')
                    variant = 'kv8' if case['cache'] == 'int8' else 'dense'
                    tol = variant_tol(variant, dtype_name)
                    err_y = check_close(f'{name} {label} y', ys[0], ys_ref[0], dtype_name, tol)
                    err_c = 0.0
                    for a, b in zip(c_k, c_p):     # as hold_variant: f32 int8 codes
                        if a.k_scale is not None and dtype_name == 'float32':
                            if max(int((u.int() - v.int()).abs().max())
                                   for u, v in zip(a[:2], b[:2])) > 1:
                                fail(f'{name} ({label}): an int8 cache code off by more '
                                     'than one step')
                        else:
                            err_c = max(err_c, *(check_close(f'{name} {label} cache', u, v,
                                                             dtype_name, tol)
                                                 for u, v in zip(dequantized(a, h_loc),
                                                                 dequantized(b, h_loc))))
                    ms, phased_ms = cuda_ms(persistent), cuda_ms(phased)
                    enq, enq_phased = enqueue_ms(persistent), enqueue_ms(phased)
                    plain_ms = cuda_ms(lambda: fd._step_plain_tp(
                        name, trees, [x] * mp, h_loc, c_p, *args, case['chunk']),
                                       **PLAIN_TIMING)
                    q_len = case.get('K', 1)
                    fmt = fd.weight_format(trees[0])
                    S, d, dff = case['S'], SLICE['d'], SLICE['dff']
                    chunk = fd.cache_chunk(caches[0], h_loc, case['chunk'])
                    plan = fd.tp_persistent_plan(SLICE['L'], case['rows'], d, dff, SLICE['h'],
                                                 S, chunk, fmt, q_len=q_len,
                                                 kv8=case['cache'] == 'int8',
                                                 devices=mesh.devices)
                    grid = fd.step_grid(dt, caches[0].k.dtype, fmt, d // SLICE['h'], d,
                                        dff // mp, da=d // mp)
                    if grid[0] < 1 or grid[1] != plan['smem_bytes'] or plan['launches'] != 1:
                        fail(f'{name} ({label}, mp {mp}): the launcher sizes {grid} (blocks, '
                             f"shared bytes), the plan {plan['smem_bytes']} bytes, "
                             f"{plan['launches']} launches")
                    phases = (step_phases(persistent, SLICE['L'], grid[0], plan['phases'],
                                          tp_devices=[dev])[0]
                              if label in ('serve', 'verify', 'chunked') else None)
                    if torch.is_tensor(index):
                        read = int((tl + cl).sum()) + sum(
                            min(int(i) + q_len - 1, case['S'] - 1) - ttm - pm + 1
                            for i in index)
                    else:
                        read = int((tl + cl).sum()) + case['rows'] * (index - ttm - pm + 1)
                    nbytes, bound_ms, bound_by = tp_step_bound(
                        trees, caches, case['rows'], q_len, read, mp, dtype_name,
                        x.element_size())
                    key = (name, dtype_name) if label in ('serve', 'verify') and mp == 2 \
                        else (name, f'mp{mp}' if label in ('serve', 'verify')
                              else f'{label}_mp{mp}', dtype_name)
                    res = dict(max_abs_err=max(err_y, err_c), ms=ms, plain_ms=plain_ms,
                               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                               tol=tol_str(dtype_name, tol), phased_ms=phased_ms,
                               enqueue_ms=enq, phased_enqueue_ms=enq_phased,
                               bit_equal_to_phased=True)
                    results[key] = res
                    emit(phase='kernels', path='tp', kernel=name, case=label, mp=mp,
                         dtype=dtype_name, shape=dict(L=SLICE['L'], rows=case['rows'],
                                                      S=case['S'], K=q_len,
                                                      chunk=case['chunk'], d=SLICE['d'],
                                                      h=SLICE['h'], dff=SLICE['dff']),
                         err_y=err_y, err_cache=err_c, bytes=nbytes,
                         grid=dict(blocks=grid[0], smem_bytes=grid[1]), plan=plan,
                         phases=phases, **res)
                    del trees, caches, c_k, c_t, c_p


def tp_requests():
    """Phase main's 3 requests, tokenized."""
    import numpy as np
    from valle2_tpu_torch.data.frontend import PhonemeTokenizer
    texts, pts, pcs = make_requests()
    tok = PhonemeTokenizer()
    return texts, pts, pcs, [np.concatenate([pt, tok(t)]) for t, pt in zip(texts, pts)]


@contextlib.contextmanager
def decode_loop_counts():
    """Counts, while open, the token steps of the AR decode loops
    (models.ar._stack_step calls) and the 5c launches made inside those
    loops (_decode_advance, _decode_advance_spec), the module functions
    wrapped and restored."""
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    from valle2_tpu_torch.models import ar as ar_mod
    names = ('_decode_advance', '_decode_advance_spec', '_stack_step')
    orig = {n: getattr(ar_mod, n) for n in names}
    loop = dict(steps=0, allreduce=0)

    def in_loop(fn):
        def run(*args, **kw):
            before = ta.COUNTER.count
            try:
                return fn(*args, **kw)
            finally:
                loop['allreduce'] += ta.COUNTER.count - before
        return run

    def stepping(*args, **kw):
        loop['steps'] += 1
        return orig['_stack_step'](*args, **kw)
    ar_mod._decode_advance = in_loop(orig['_decode_advance'])
    ar_mod._decode_advance_spec = in_loop(orig['_decode_advance_spec'])
    ar_mod._stack_step = stepping
    try:
        yield loop
    finally:
        for n, fn in orig.items():
            setattr(ar_mod, n, fn)


@contextlib.contextmanager
def row_reduce_sums():
    """Counts, while open, the row-parallel sums handed to 5c
    (kernels.tp_allreduce.tp_row_reduce calls), the partials' shapes, and
    5c's ordering calls (kernels.tp_allreduce.ordering_calls), the module
    function wrapped and restored."""
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    orig = ta.tp_row_reduce
    seen = dict(sums=0, shapes={}, ordering_calls=ta.ordering_calls())

    def counting(partials, *args, **kw):
        seen['sums'] += 1
        key = 'x'.join(map(str, partials[0].shape))
        seen['shapes'][key] = seen['shapes'].get(key, 0) + 1
        return orig(partials, *args, **kw)
    ta.tp_row_reduce = counting
    try:
        yield seen
    finally:
        ta.tp_row_reduce = orig
        seen['ordering_calls'] = ta.ordering_calls() - seen['ordering_calls']


def phase_tp(devices, smi: str = '') -> dict:
    """Phase 31: tensor-parallel serving over a ('model',) mesh of
    ``devices`` (['cuda:0'] * 2 in the one-card run: virtual ranks; the four
    cards of a four-card host) against the solo model on the same weights:
    batch_synthesize of phase main's requests and a speculative
    generate_batch, f32 with TF32 off, greedy.  Returns the mesh runs'
    launch counts."""
    import dataclasses
    import time

    import numpy as np
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.parallel import make_model_mesh
    from valle2_tpu_torch.tts import StageClock, ValleTTS

    mp = len(devices)
    mesh = make_model_mesh(mp, devices)
    cfg = ConfigValle(max_audio_len=TP_STEPS, ignore_eos=True, dropout=0.0, temperature=0.0,
                      kv_cache_dtype='float32', matmul_precision='highest')
    if not cfg.fused_decode_enabled('cuda', mp):
        fail(f'tp: the fused TP steps refuse the serving stack at mp {mp}')
    texts, pts, pcs, tokens = tp_requests()
    solo = ValleTTS(cfg, device=devices[0])
    tp = ValleTTS(cfg, ar=ValleAR(cfg, params=solo.ar.params, mesh=mesh), nar=solo.nar,
                  codec=solo.codec, mesh=mesh)
    spec_cfg = dataclasses.replace(cfg, num_beams=1, speculative_k=SPEC['K'],
                                   speculative_ngram=SPEC['ngram'])
    spec_solo = ValleAR(spec_cfg, params=solo.ar.params, device=devices[0])
    spec_tp = ValleAR(spec_cfg, params=solo.ar.params, mesh=mesh)
    runs = {}
    for label, model in (('solo', solo), ('mesh', tp), ('mesh', tp), ('solo', solo)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = model.batch_synthesize(texts, pts, pcs)
        runs.setdefault(label, []).append((time.perf_counter() - t0, out))
    want_spec = spec_solo.generate_batch(tokens, pcs)
    spec_tp.generate_batch(tokens, pcs)                 # warm-up
    torch.cuda.synchronize()
    reset_counters()
    fd.TP_PHASED_COUNTER.reset()
    with decode_loop_counts() as loop, row_reduce_sums() as sums:
        got = tp.batch_synthesize(texts, pts, pcs)
        clock = StageClock(devices[0])
        got_spec = spec_tp.generate_batch(tokens, pcs, clock=clock)
    launches = read_counters()
    cards = len({torch.device(d) for d in mesh.devices})
    if launches['tp_allreduce'] != sums['sums'] * cards or not sums['sums']:
        fail(f"tp (mp {mp}): {launches['tp_allreduce']} 5c launches for {sums['sums']} "
             f'row-parallel sums on {cards} cards (one a card a sum)')
    if cards == 1 and sums['ordering_calls']:
        fail(f"tp (mp {mp}): 5c made {sums['ordering_calls']} ordering calls on one card")
    plain = plain_calls()
    want = runs['solo'][-1][1]
    for g, w in zip(got, want):
        if not np.array_equal(g.codes, w.codes):
            fail(f'tp (mp {mp}): mesh codes differ from the solo model\'s')
        if not np.isfinite(g.waveform).all() or g.waveform.shape != w.waveform.shape:
            fail(f'tp (mp {mp}): bad waveform {g.waveform.shape}')
    for g, w in zip(got_spec, want_spec):
        if not torch.equal(g, w):
            fail(f'tp (mp {mp}): speculative mesh ids differ from solo')
    require_launches(f'tp (mp {mp})', launches, ('fused_decode_step_tp',
                                                 'fused_verify_step_tp', 'tp_allreduce'))
    solo_steps = step_launches({k: v for k, v in launches.items() if not k.endswith('_tp')})
    if plain or solo_steps or fd.TP_PHASED_COUNTER.count:
        fail(f'tp (mp {mp}): plain fused calls {plain}, one-rank step kernels {solo_steps}, '
             f'phased TP steps {fd.TP_PHASED_COUNTER.count}')
    tp_steps = launches['fused_decode_step_tp'] + launches['fused_verify_step_tp']
    if loop['allreduce'] or tp_steps != loop['steps']:
        fail(f"tp (mp {mp}): {loop['allreduce']} 5c launches inside the decode loops, "
             f"{tp_steps} TP step launches for {loop['steps']} token steps")
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    parts = [torch.randn(12, SLICE['d'], device=d) for d in mesh.devices]
    allreduce_ms = cuda_ms(lambda: ta.tp_allreduce(parts))

    def summary(label):
        walls = [w for w, _ in runs[label]]
        t = runs[label][-1][1][0].timings
        return dict(wall_s=walls, decode_ms_per_step=1e3 * t['decode'] / TP_STEPS,
                    stage_s={k: t[k] for k in ('prefill', 'decode', 'nar', 'codec')},
                    rtf=runs[label][-1][1][0].rtf)
    emit(phase='tp', mp=mp, devices=[str(d) for d in mesh.devices], steps=TP_STEPS,
         requests=len(texts), dtype='float32', codes_equal=True, spec_ids_equal=True,
         decode_loop=dict(token_steps=loop['steps'], tp_step_launches=tp_steps,
                          allreduce_launches=loop['allreduce']),
         row_parallel_sums=sums,
         plan=fd.tp_persistent_plan(SLICE['L'], 12, SLICE['d'], SLICE['dff'], SLICE['h'],
                                    1280, 1280, devices=mesh.devices),
         mesh=summary('mesh'), solo=summary('solo'),
         spec_turns=clock.counts.get('ar_turns'), tp_allreduce_ms=allreduce_ms,
         launches={k: v for k, v in launches.items() if v}, card=smi)
    return launches


def phase_tp_cards(devices, smi: str = '') -> None:
    """``--mesh-cards N``: the persistent TP step over N cards (one
    cooperative launch a card, barriers across cards through flags in peer
    memory) at the serving step (12 rows, S 1280) and the spec cell's verify
    block (3 rows x K = 4), f32 with TF32 off and bf16: every rank's y and
    cache bit for bit against the phased twin on the same cards, and y
    against the persistent step of N virtual ranks on cuda:0; CUDA-event
    times of the three (the cards' launches end on cuda:0's stream, which
    waits for every card), their host enqueue, and each card's phase trace
    (step_phases: the barriers across cards are in the OUT and FFN2
    phases' barrier time)."""
    import torch
    from valle2_tpu_torch.config import ConfigValle, precision_scope
    from valle2_tpu_torch.kernels import fused_decode as fd
    from valle2_tpu_torch.ops.transformer import KVCache, map_tree
    from valle2_tpu_torch.parallel import make_model_mesh

    mp = len(devices)
    gen = torch.Generator().manual_seed(37)
    home = torch.device('cuda', 0)
    cases = {'serve': TP_CASES['serve'],
             'verify': dict(rows=SPEC['rows'], S=1024, index=None, chunk=None,
                            weights='compute', cache=None, K=SPEC['K'])}

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)
    with precision_scope(ConfigValle(matmul_precision='highest')), torch.inference_mode():
        for dtype_name, dt in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
            for label, case in cases.items():
                verify = 'K' in case
                name = 'fused_verify_step_tp' if verify else 'fused_decode_step_tp'
                v_mesh, v_trees, v_caches, x, index, tl, cl, ttm, pm = tp_inputs(
                    case, mp, dt, gen, home)
                if verify:
                    index = torch.tensor([ttm + pm + o for o in SPEC['offsets']],
                                         dtype=torch.int32, device=home)
                mesh = make_model_mesh(mp, devices)
                trees = [map_tree(lambda a, c=c: a.to(c), t)
                         for t, c in zip(v_trees, mesh.devices)]
                caches = [KVCache(*(t.to(c) for t in cc if t is not None))
                          for cc, c in zip(v_caches, mesh.devices)]
                c_k, c_t = ([KVCache(*(t.clone() for t in c if t is not None)) for c in caches]
                            for _ in range(2))
                c_v = [KVCache(*(t.clone() for t in c if t is not None)) for c in v_caches]
                h_loc = SLICE['h'] // mp
                args = (index, tl, cl, ttm, pm)

                def persistent(c_k=c_k, trees=trees, mesh=mesh, args=args, name=name):
                    return fd.fused_step_tp(name, mesh, trees, c_k, x, h_loc, *args)

                def phased(c_t=c_t, trees=trees, mesh=mesh, args=args, name=name):
                    return fd.fused_step_tp_phased(name, mesh, trees, c_t, x, h_loc, *args)

                def virtual(c_v=c_v, trees=v_trees, mesh=v_mesh, args=args, name=name):
                    return fd.fused_step_tp(name, mesh, trees, c_v, x, h_loc, *args)
                ys, _ = persistent()
                ys_t, _ = phased()
                ys_v, _ = virtual()
                sync()
                label_ = f'{name} ({label}, {mp} cards, {dtype_name})'
                tp_twin(label_, ys, ys_t, c_k, c_t)
                if not all(torch.equal(y.to(home), ys_v[0]) for y in ys):
                    fail(f'{label_}: differs from {mp} virtual ranks on one card')
                ms, phased_ms, virtual_ms = (cuda_ms(f) for f in (persistent, phased, virtual))
                enq, enq_phased = enqueue_ms(persistent), enqueue_ms(phased)
                sync()
                q_len = case.get('K', 1)
                d, dff = SLICE['d'], SLICE['dff']
                plan = fd.tp_persistent_plan(SLICE['L'], case['rows'], d, dff, SLICE['h'],
                                             case['S'], case['S'], q_len=q_len,
                                             devices=mesh.devices)
                grid = fd.step_grid(dt, caches[0].k.dtype, 'w', d // SLICE['h'], d, dff // mp,
                                    da=d // mp)
                if plan['launches'] != mp or grid[1] != plan['smem_bytes']:
                    fail(f'{label_}: the plan {plan["launches"]} launches, '
                         f'{plan["smem_bytes"]} bytes; the launcher {grid}')
                phases = step_phases(persistent, SLICE['L'], grid[0], plan['phases'],
                                     tp_devices=list(mesh.devices))
                sync()
                emit(phase='tp_cards', kernel=name, case=label, mp=mp, dtype=dtype_name,
                     devices=[str(c) for c in mesh.devices], bit_equal_to_phased=True,
                     equal_to_virtual_ranks=True, ms=ms, phased_ms=phased_ms,
                     virtual_ranks_ms=virtual_ms, enqueue_ms=enq, phased_enqueue_ms=enq_phased,
                     grid=dict(blocks=grid[0], smem_bytes=grid[1]), plan=plan,
                     phases_by_card=phases, card=smi)
                del trees, caches, c_k, c_t, c_v, v_trees, v_caches


def phase_tp_large(devices, smi: str = '') -> dict:
    """The 204M stack (LARGE) at mp = len(devices): one generate_batch of
    phase main's first request at 4 beams, f32 with TF32 off, greedy, on the
    mesh and solo: ids equal; decode ms per step of both."""
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.parallel import make_model_mesh
    from valle2_tpu_torch.tts import StageClock

    mp = len(devices)
    mesh = make_model_mesh(mp, devices)
    cfg = ConfigValle(**LARGE, max_audio_len=GREEDY_STEPS, ignore_eos=True, dropout=0.0,
                      temperature=0.0, num_beams=4, kv_cache_dtype='float32',
                      matmul_precision='highest')
    _, _, pcs, tokens = tp_requests()
    solo = ValleAR(cfg, device=devices[0])
    tp = ValleAR(cfg, params=solo.params, mesh=mesh)
    out = {}
    for label, model in (('solo', solo), ('mesh', tp), ('mesh', tp), ('solo', solo)):
        reset_counters()
        clock = StageClock(devices[0])
        ids = model.generate_batch(tokens[:1], pcs[:1], clock=clock)
        out.setdefault(label, []).append((1e3 * clock.times['decode'] / GREEDY_STEPS, ids,
                                          read_counters()))
    for (_, a, _), (_, b, _) in zip(out['mesh'], out['solo']):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f'tp large (mp {mp}): mesh ids differ from solo')
    launches = out['mesh'][-1][2]
    require_launches(f'tp large (mp {mp})', launches, ('fused_decode_step_tp', 'tp_allreduce'))
    emit(phase='tp_large', mp=mp, **LARGE, beams=4, steps=GREEDY_STEPS, ids_equal=True,
         decode_ms_per_step={k: [m for m, _, _ in v] for k, v in out.items()},
         launches={k: v for k, v in launches.items() if v}, card=smi)
    return launches


# Phase mesh: the training batch of (a) (2 rows a data rank, s = 64 + 256:
# #1 and #3), the grids it runs on, the serving requests of (b), the timed
# steps of data=2 against solo (bf16, bench_data at b=16 x 512, steps per arm).
MESH_TRAIN = dict(b=4, frames=256)
MESH_GRIDS = {'data2': (2, 1), '2x2_zero1_sp': (2, 2)}
MESH_SERVE_STEPS = 64
MESH_TIMED = ('ValleAR', 16, 512, 5)
# Mesh step against the solo step, f32 with TF32 off: each leaf's grad within
# this share of the leaf's largest (sums over the ranks and rows in another
# order); the params after one AdamW step (fused on the card, ZeRO-1's block
# update and gather at 2 x 2) within MESH_PARAM_LR of the learning rate.
# AdamW's first step moves an element by lr * g / (|g| + eps), about lr: an
# element left unchanged reads about 1 lr, a flipped update 2 lr; the sound
# runs read 0.024-0.035 lr (the grads' last bits where |g| is near eps).  The
# negative control (skipped_zero1_block) must read beyond the limit.
MESH_GRAD_RTOL = 1e-5
MESH_PARAM_LR = 0.25
# The four-card arm (--mesh-cards 4): the 204M geometry, bench_data at
# b=16 x 512 (s = 640), bf16, dropout 0.1, steps timed per arm.
MESH_CARDS_STEPS = (2, 4)     # warm-up, timed


@contextlib.contextmanager
def skipped_zero1_block():
    """ZeRO-1's gather leaving the last data block of every cut leaf out of
    data rank 0's ranks (they keep their old values there): the fault phase
    mesh's negative control must see in the params after a step."""
    from valle2_tpu_torch import train as tt
    inner = tt.MeshOptimizer._gather_blocks

    def faulty(self):
        last = self.mesh.data - 1
        kept = [(leaf, z) for r in range(self.mesh.model)
                for leaf, z in zip(self.ranks[r], self.zspecs) if 'data' in z]
        old = [self._block(leaf, z, last).clone() for leaf, z in kept]
        inner(self)
        for (leaf, z), o in zip(kept, old):
            self._block(leaf, z, last).copy_(o)
    tt.MeshOptimizer._gather_blocks = faulty
    try:
        yield
    finally:
        tt.MeshOptimizer._gather_blocks = inner


def mesh_batch(model: str, dev):
    return bench_data(model, MESH_TRAIN['b'], MESH_TRAIN['frames'], dev)


def mesh_grads(model: str, cfg, batch, on, dev):
    """(loss, the step's grads as whole CPU tensors, the params after one
    AdamW step as whole CPU tensors) from fresh seeded params, solo
    (``on`` None) or on the mesh ``on``; the step generator's seed 1."""
    import torch
    from valle2_tpu_torch import train as tt
    state = tt.init_state(cfg, model, device=dev)
    if on is not None:
        state = tt.shard_state(on, state, cfg)
    kw = {} if on is None else {'mesh': on}
    loss, _m = tt.LOSS_FNS[model](state.params, cfg, batch, tt.step_generator(1, 0, dev),
                                  **kw)
    leaves = state.opt_state.leaves
    grads = [torch.zeros_like(p) if g is None else g for p, g in
             zip(leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    whole = ([g.cpu() for g in grads] if on is None
             else state.opt_state.whole_grads(grads))
    state.opt_state.update(grads)
    return float(loss.detach()), whole, [p.detach().cpu() for p in
                                tt.tree_leaves(tt.gather_state(state))]


def mesh_step_ms(cfg, model: str, b: int, frames: int, n: int, on, dev,
                 warmup: int = 2) -> dict:
    """Wall ms a train step (after ``warmup`` steps) and each card's peak
    memory, solo (``on`` None) or on ``on``."""
    import time

    import torch
    from valle2_tpu_torch import train as tt
    cards = sorted({torch.device(d) for d in (on.devices if on else [dev])},
                   key=lambda d: d.index or 0)
    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(d)
    state = tt.init_state(cfg, model, device=dev)
    if on is not None:
        state = tt.shard_state(on, state, cfg)
    step = tt.make_train_step(cfg, model, on)
    data = bench_data(model, b, frames, dev)
    losses = []
    for _ in range(warmup):
        state, m = step(state, data, 1)
        losses.append(m['loss'])
    for d in cards:
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    for _ in range(n):
        state, m = step(state, data, 1)
        losses.append(m['loss'])
    for d in cards:
        torch.cuda.synchronize(d)
    ms = 1e3 * (time.perf_counter() - t0) / n
    losses = [float(x) for x in losses]
    if not all(abs(x) < 1e9 for x in losses):
        fail(f'mesh: non-finite loss {losses} on {on}')
    out = dict(step_ms=ms, first_loss=losses[0], last_loss=losses[-1],
               peak_mem_gb={str(d): torch.cuda.max_memory_allocated(d) / 1e9 for d in cards})
    del state, data
    return out


def mesh_step_split(cfg, model: str, b: int, frames: int, on, dev) -> dict:
    """One train step (after two warm-up steps), solo (``on`` None) or on
    ``on``, split on the host clock into enqueuing the forward (the loss
    returned), the backward (``torch.autograd.grad`` returned), the
    optimizer's update and the wait for the cards; with each card's busy
    share of the step from torch.profiler (the union of its kernels'
    intervals over the step's wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch import train as tt
    cards = sorted({torch.device(d) for d in (on.devices if on else [dev])},
                   key=lambda d: d.index or 0)
    state = tt.init_state(cfg, model, device=dev)
    if on is not None:
        state = tt.shard_state(on, state, cfg)
    data = bench_data(model, b, frames, dev)
    step = tt.make_train_step(cfg, model, on)
    for _ in range(2):
        state, _m = step(state, data, 1)
    kw = {} if on is None else {'mesh': on}
    opt = state.opt_state
    for d in cards:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss, _m = tt.LOSS_FNS[model](state.params, cfg, data,
                                      tt.step_generator(1, state.step, dev), **kw)
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, opt.leaves, allow_unused=True)
        t2 = time.perf_counter()
        opt.update([torch.zeros_like(p) if g is None else g for p, g in zip(opt.leaves, grads)])
        t3 = time.perf_counter()
        for d in cards:
            torch.cuda.synchronize(d)
        t4 = time.perf_counter()
    wall = t4 - t0
    return dict(wall_ms=1e3 * wall, forward_enqueue_ms=1e3 * (t1 - t0),
                backward_ms=1e3 * (t2 - t1), update_enqueue_ms=1e3 * (t3 - t2),
                wait_ms=1e3 * (t4 - t3), busy_share=card_busy(prof, cards, wall))


def phase_mesh(smi: str) -> dict:
    """Phase 38: the data axis on one card, virtual ranks ['cuda:0'] * n,
    the full default width, f32 with TF32 off: (a) the AR and the NAR loss,
    every leaf's grad and the params after one AdamW step at data=2 and at
    2 x 2 with zero1 and sequence_parallel (dropout 0.1) against the solo
    step (MESH_GRAD_RTOL, MESH_PARAM_LR); (b) greedy batch_synthesize of 4
    requests (MESH_SERVE_STEPS frames) at data=2 and 2 x 2 against solo, row
    for row; (c) a 2-step Trainer.fit from a config with mesh_data=2.
    Counts zeroed after the solo references, read after (c): #1 or #2, #3 or
    #4 + #5, 5c, #6 and the TP step launched, no plain fused call.  Then the
    negative control (skipped_zero1_block beyond MESH_PARAM_LR), the flash
    kernels at (a)'s 2 x 2 shard shape and 5c under autograd against their
    plain versions, and the bf16 step time of data=2 against solo (MESH_TIMED)
    with the card's peak memory, zero1 off and on.  Returns the launches."""
    import tempfile
    from pathlib import Path

    import numpy as np
    import torch
    from valle2_tpu_torch import train as tt
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import get_dataloaders
    from valle2_tpu_torch.kernels import flash_attention as fa
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    from valle2_tpu_torch.models.ar import ValleAR
    from valle2_tpu_torch.ops import nn as tnn
    from valle2_tpu_torch.parallel import make_mesh, training_mesh
    from valle2_tpu_torch.tts import ValleTTS

    dev = torch.device('cuda:0')

    def grid(args):
        return make_mesh(*args, ['cuda:0'] * (args[0] * args[1]))

    def train_cfg(label: str):
        on = label != 'data2'
        return ConfigValle(dropout=0.1, batch_size=MESH_TRAIN['b'], matmul_precision='highest',
                           zero1=on, sequence_parallel=on)
    # the solo references (not counted)
    refs = {m: mesh_grads(m, train_cfg('data2'), mesh_batch(m, dev), None, dev)
            for m in ('ValleAR', 'ValleNAR')}
    cfg = ConfigValle(max_audio_len=MESH_SERVE_STEPS, ignore_eos=True, dropout=0.0,
                      temperature=0.0, kv_cache_dtype='float32', matmul_precision='highest')
    texts, pts, pcs = make_requests()
    texts, pts, pcs = texts + texts[:1], pts + pts[:1], pcs + pcs[::-1][:1]
    solo = ValleTTS(cfg, device=dev)
    want = solo.batch_synthesize(texts, pts, pcs)
    ttss = {}
    for label, args in MESH_GRIDS.items():
        on = grid(args)
        ttss[label] = ValleTTS(cfg, ar=ValleAR(cfg, params=solo.ar.params, mesh=on),
                               nar=solo.nar, codec=solo.codec, mesh=on)
    torch.cuda.synchronize()

    reset_counters()
    t0 = time.perf_counter()
    train = {}
    for model in ('ValleAR', 'ValleNAR'):
        r_loss, r_grads, r_params = refs[model]
        for label, args in MESH_GRIDS.items():
            c = train_cfg(label)
            loss, grads, params = mesh_grads(model, c, mesh_batch(model, dev), grid(args), dev)
            worst = max(float((g - w).abs().max()) / max(1e-30, float(w.abs().max()))
                        for g, w in zip(grads, r_grads))
            moved = max(float((p - w).abs().max()) for p, w in zip(params, r_params))
            if abs(loss - r_loss) > 1e-5 * max(1.0, abs(r_loss)) or worst > MESH_GRAD_RTOL \
                    or moved > MESH_PARAM_LR * c.lr:
                fail(f'mesh ({model}, {label}): loss {loss} against solo {r_loss}, worst '
                     f'grad share {worst:.3e}, params apart {moved:.3e}')
            train[f'{model}_{label}'] = dict(loss=loss, solo_loss=r_loss,
                                             worst_grad_share=worst, params_apart=moved)
    train_s = time.perf_counter() - t0
    serve = {}
    for label, tts in ttss.items():
        t1 = time.perf_counter()
        got = tts.batch_synthesize(texts, pts, pcs)
        torch.cuda.synchronize()
        serve[label] = time.perf_counter() - t1
        for i, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g.codes, w.codes) or not np.isfinite(g.waveform).all():
                fail(f'mesh ({label}): request {i}\'s codes differ from solo')
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = ConfigValle(mesh_data=2, max_steps=2, batch_size=8, log_every_n_steps=1,
                           ckpt_every_n_steps=0, prefetch_batches=0, dtype='bfloat16',
                           ckpt_path=Path(tmp) / 'ckpt', log_path=Path(tmp) / 'logs')
        on = training_mesh(fcfg, ['cuda:0'] * 2)
        loader, _valid = get_dataloaders('ValleAR', fcfg, synthetic=True)
        fitted = tt.Trainer(fcfg, 'ValleAR', mesh=on, use_tensorboard=False).fit(
            tt.init_state(fcfg, 'ValleAR', device=dev), loader)
        if fitted.step != 2 or not (Path(tmp) / 'ckpt' / 'ValleAR' / 'step_2').exists():
            fail(f'mesh: Trainer.fit at mesh_data=2 ended at step {fitted.step}')
    torch.cuda.synchronize()
    launches = read_counters()
    plain = plain_calls()
    if not launches['flash_attention_fwd'] + launches['flash_attention_fwd_folded']:
        fail('mesh: no flash forward (#1 or #2) launched')
    if not (launches['flash_bwd_fused']
            or (launches['flash_bwd_dq'] and launches['flash_bwd_dkv'])):
        fail('mesh: no flash backward (#3, or #4 and #5) launched')
    require_launches('mesh', launches, ('tp_allreduce', 'fused_decode_step_tp'))
    if not launches['fused_decode_step'] + launches['fused_decode_step_chunked']:
        fail('mesh: the data ranks\' decode never launched #6')
    if plain:
        fail(f'mesh: {plain} plain fused-step calls')

    # the negative control: ZeRO-1's gather missing a data block must fail (a)
    c = train_cfg('2x2_zero1_sp')
    with skipped_zero1_block():
        _l, _g, faulty = mesh_grads('ValleAR', c, mesh_batch('ValleAR', dev),
                                    grid(MESH_GRIDS['2x2_zero1_sp']), dev)
    control = max(float((p - w).abs().max()) for p, w in zip(faulty, refs['ValleAR'][2]))
    if control <= MESH_PARAM_LR * c.lr:
        fail(f'mesh: a skipped ZeRO-1 block left the params {control:.3e} apart, within '
             f'the limit {MESH_PARAM_LR * c.lr:.3e}')
    train['control_skipped_zero1_block'] = dict(params_apart=control,
                                                limit=MESH_PARAM_LR * c.lr)

    # the per-shard kernels at (a)'s 2 x 2 shard shape (a data rank's rows,
    # a model rank's heads, as mha_tp hands them) against their plain versions
    gen = torch.Generator(device=dev).manual_seed(3)
    b, h, s, tt_ = MESH_TRAIN['b'] // 2, 2, MESH_TRAIN['frames'] + MESH_TRAIN['frames'] // 4, 64
    q, k, v = (torch.randn(b, h, s, 64, generator=gen, device=dev).requires_grad_()
               for _ in range(3))
    meta = torch.tensor([[tt_, s]] * b, dtype=torch.int32, device=dev)
    do = torch.randn(b, h, s, 64, generator=gen, device=dev)
    o = fa.FlashAttention.apply(q, k, v, meta, tt_, True)
    dq, dk, dv = torch.autograd.grad(o, [q, k, v], do)
    with torch.no_grad():
        po, plse = fa.flash_attention_plain(q, k, v, meta, tt_, True)
        pdq, pdk, pdv = fa.flash_attention_bwd_plain(q, k, v, meta, po, plse, do, tt_, True)
    errs = {'flash_fwd_per_shard': check_close('mesh flash per shard', o, po, 'float32'),
            'flash_bwd_per_shard': max(check_close('mesh flash dq', dq, pdq, 'float32'),
                                       check_close('mesh flash dk', dk, pdk, 'float32'),
                                       check_close('mesh flash dv', dv, pdv, 'float32'))}
    parts = [torch.randn(2, s, 256, generator=gen, device=dev).requires_grad_()
             for _ in range(2)]
    bias = [torch.randn(256, generator=gen, device=dev) for _ in range(2)]
    res = [torch.randn(2, s, 256, generator=gen, device=dev) for _ in range(2)]
    outs = tnn.psum_replicated_grad(parts, bias, res, torch.float32)
    plain_outs = ta.tp_row_reduce_plain([p.detach() for p in parts], bias, res)
    if not all(torch.equal(x, y) for x, y in zip(outs, plain_outs)):
        fail('mesh: 5c under autograd differs from its plain version')
    ct = [torch.randn_like(x) for x in outs]
    if not all(torch.equal(g, c) for g, c in zip(torch.autograd.grad(outs, parts, ct), ct)):
        fail('mesh: 5c\'s backward is not the identity')
    errs['tp_row_reduce_autograd'] = 0.0

    # data=2 against solo: bf16 step time, the card's peak memory, zero1 off / on
    model, b_t, frames, n = MESH_TIMED
    tcfg = ConfigValle(dropout=0.1, batch_size=b_t, dtype='bfloat16')
    timed_arms = {'solo': mesh_step_ms(tcfg, model, b_t, frames, n, None, dev),
                  'data2': mesh_step_ms(tcfg, model, b_t, frames, n, grid((2, 1)), dev),
                  'data2_zero1': mesh_step_ms(ConfigValle(dropout=0.1, batch_size=b_t,
                                                          dtype='bfloat16', zero1=True),
                                              model, b_t, frames, n, grid((2, 1)), dev),
                  'solo_again': mesh_step_ms(tcfg, model, b_t, frames, n, None, dev)}
    emit(phase='mesh', grids={k: list(v) for k, v in MESH_GRIDS.items()}, dtype='float32',
         train=train, train_s=train_s, serve_s=serve, requests=len(texts),
         serve_frames=MESH_SERVE_STEPS, codes_equal=True, fit_steps=2, kernel_err=errs,
         timed=dict(model=model, batch=b_t, frames=frames, s=frames // 4 + frames,
                    dtype='bfloat16', arms=timed_arms),
         launches={k: v for k, v in launches.items() if v}, card=smi)
    return launches


def phase_mesh_cards(devices, smi: str = '') -> None:
    """``--mesh-cards N``: training over the N cards at the 204M geometry
    (LARGE), bench_data at b=16 x 512 (s = 640), bf16, dropout 0.1: the
    wall ms a step and each card's peak memory of solo (cuda:0), data=N,
    2 x (N/2), model=N, and data=N with zero1; the first step's loss of
    each mesh against solo's (the same seed and batch; bf16 sums in
    another order); and a step of solo and of data=N split into its host
    parts, with each card's busy share (``mesh_step_split``)."""
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.parallel import make_mesh

    n = len(devices)
    warm, steps = MESH_CARDS_STEPS
    dev = torch.device(devices[0])
    base = dict(LARGE, dropout=0.1, batch_size=16, dtype='bfloat16')
    arms = {'solo': (None, {}), f'data{n}': ((n, 1), {}), f'data{n}_zero1': ((n, 1),
                                                                          {'zero1': True}),
            f'2x{n // 2}': ((2, n // 2), {}), f'model{n}': ((1, n), {})}
    out = {}
    for label, (args, extra) in arms.items():
        on = None if args is None else make_mesh(*args, devices)
        out[label] = mesh_step_ms(ConfigValle(**base, **extra), 'ValleAR', 16, 512, steps, on,
                                  dev)
    solo = out['solo']['first_loss']
    for label, r in out.items():
        if abs(r['first_loss'] - solo) > 2e-2 * max(1.0, abs(solo)):
            fail(f'mesh cards: {label}\'s first loss {r["first_loss"]} against solo {solo}')
    split = {label: mesh_step_split(ConfigValle(**base), 'ValleAR', 16, 512,
                                    None if args is None else make_mesh(*args, devices), dev)
             for label, args in (('solo', None), (f'data{n}', (n, 1)))}
    emit(phase='mesh_cards', cards=n, geometry=LARGE, batch=16, frames=512, s=640,
         dtype='bfloat16', warmup=warm, steps=steps, arms=out, split=split, card=smi)


# Phase pipe: the training batch of (a) (b=8 x (64 + 256), 4 rows a data rank
# at data 2), its arms (grid data x pipe x model, schedule, microbatches,
# zero1), (b)'s fit (examples/train_ar_pp.json's mesh at batch 8), and (c)'s
# timed arms at the 204M widths (schedule, microbatches) at b=16 x 512, pipe 4
# on one card.  The limits are phase mesh's (MESH_GRAD_RTOL, MESH_PARAM_LR).
PIPE_TRAIN = dict(b=8, frames=256)
PIPE_ARMS = {'pipe4_gpipe_m4': ((1, 4, 1), 'gpipe', 4, False),
             'pipe4_1f1b_m8': ((1, 4, 1), '1f1b', 8, False),
             '2x2x2_zero1_1f1b_m2': ((2, 2, 2), '1f1b', 2, True)}
PIPE_FIT = dict(example='train_ar_pp.json', batch=8, steps=2)
PIPE_TIMED = (('gpipe', 8), ('1f1b', 8), ('gpipe', 16), ('1f1b', 16))
PIPE_TIMED_STEPS = 2           # timed steps of each, after one warm-up step
# The four-card arms (--mesh-cards 4): (data, pipe, model), schedule, M at the
# 204M geometry, b=16 x 512.
PIPE_CARDS_ARMS = {'pipe4_gpipe_m8': ((1, 4, 1), 'gpipe', 8),
                   'pipe4_1f1b_m8': ((1, 4, 1), '1f1b', 8),
                   'pipe2_model2_gpipe_m8': ((1, 2, 2), 'gpipe', 8),
                   'pipe2_model2_1f1b_m8': ((1, 2, 2), '1f1b', 8)}


@contextlib.contextmanager
def dropped_stage0_embedding():
    """The pipe axis's grad completion leaving stage 0's contribution to the
    embeddings out (the stages' sum starts at stage 1): the fault phase
    pipe's negative control must see in the grads."""
    import torch
    from valle2_tpu_torch import train as tt
    inner = tt.MeshOptimizer._pipe_complete

    def faulty(self, grads):
        m, g = self.mesh.model, self.mesh.group_size
        for base in range(0, len(grads), g):
            for j in range(m):
                for k, path in enumerate(self.paths):
                    if not self.staged[k] and '_emb' in path:
                        grads[base + j][k] = torch.zeros_like(grads[base + j][k])
        return inner(self, grads)
    tt.MeshOptimizer._pipe_complete = faulty
    try:
        yield
    finally:
        tt.MeshOptimizer._pipe_complete = inner


def pipe_grads(model: str, cfg, batch, on, dev):
    """``mesh_grads`` on a pipe mesh ``on``: (loss, the step's grads as whole
    CPU tensors, the params after one AdamW step as whole CPU tensors) from
    fresh seeded params through ``cfg.pp_schedule`` at ``cfg.pp_microbatches``,
    the step generator's seed 1 (the NAR's stage is its first draw, as solo)."""
    from valle2_tpu_torch import train as tt
    from valle2_tpu_torch.parallel.pipeline import PipelineRun, pp_parts
    from valle2_tpu_torch.parallel.pipeline_1f1b import one_f_one_b
    state = tt.shard_state(on, tt.init_state(cfg, model, device=dev), cfg)
    opt = state.opt_state
    gen = tt.step_generator(1, 0, dev)
    run = PipelineRun(cfg, on, state.params, pp_parts(model)(cfg, batch, gen), batch, gen,
                      cfg.pp_microbatches, leaves=opt.ranks)
    (one_f_one_b if cfg.pp_schedule == '1f1b' else PipelineRun.gpipe)(run)
    grads = run.grads()
    whole = opt.whole_grads(grads)
    opt.update(grads)
    return float(run.metrics()['loss']), whole, [p.detach().cpu() for p in
                                                 tt.tree_leaves(tt.gather_state(state))]


def apart(got, want) -> tuple[float, float]:
    """(the worst leaf's largest |grad difference| over its largest |grad|,
    the largest |param difference|) of two (loss, grads, params)."""
    worst = max(float((g - w).abs().max()) / max(1e-30, float(w.abs().max()))
                for g, w in zip(got[1], want[1]))
    moved = max(float((p - w).abs().max()) for p, w in zip(got[2], want[2]))
    return worst, moved


def phase_pipe(smi: str) -> dict:
    """Phase 39: pipeline parallelism on one card, virtual ranks
    ['cuda:0'] * n.  (a) At the serving width, f32 with TF32 off, b=8 x (64 +
    256): the AR and the NAR loss, every leaf's grad and the params after
    one AdamW step on each of PIPE_ARMS (pipe 4 GPipe at M=4, pipe 4 1F1B at
    M=8, data 2 x pipe 2 x model 2 with zero1) against the solo step
    (MESH_GRAD_RTOL, MESH_PARAM_LR), at dropout 0 (the pipeline draws its
    masks by its own rule, not the solo step's); at dropout 0.1 the GPipe and
    the 1F1B step on one grid and seed within the same limits of each other
    (the rule's masks, replayed by 1F1B's recompute).  (b) A 2-step
    Trainer.fit from examples/train_ar_pp.json's mesh (data 2 x pipe 4) at
    batch 8.  Counts zeroed after the solo references, read after (b): 5c
    launched (the 2 x 2 x 2 arm's row-parallel sums), no plain fused call
    (the path 'pipe').  Then the negative control (dropped_stage0_embedding
    beyond MESH_GRAD_RTOL), 5c under autograd at a stage's shape against its
    plain version, and (c) at the 204M widths in bf16, b=16 x (128 + 512),
    pipe 4: ms a step and the card's peak memory of GPipe and 1F1B at M=8
    and 16; 1F1B's peak at M=16 must be below GPipe's.  Returns the
    launches."""
    import dataclasses
    import tempfile

    import torch
    from valle2_tpu_torch import train as tt
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.data import get_dataloaders
    from valle2_tpu_torch.kernels import tp_allreduce as ta
    from valle2_tpu_torch.ops import nn as tnn
    from valle2_tpu_torch.parallel import make_pp_mesh, training_mesh

    dev = torch.device('cuda:0')

    def grid(args):
        return make_pp_mesh(*args, ['cuda:0'] * (args[0] * args[1] * args[2]))

    def cfg_for(arm=None):
        base = dict(dropout=0.0, batch_size=PIPE_TRAIN['b'], matmul_precision='highest')
        if arm is None:
            return ConfigValle(**base)
        args, sched, m, zero1 = PIPE_ARMS[arm]
        return ConfigValle(**dict(base, mesh_data=args[0], mesh_pipe=args[1],
                                  mesh_model=args[2], pp_schedule=sched,
                                  pp_microbatches=m, zero1=zero1))

    def batch(model):
        return bench_data(model, PIPE_TRAIN['b'], PIPE_TRAIN['frames'], dev)
    # the solo references (not counted)
    refs = {m: mesh_grads(m, cfg_for(), batch(m), None, dev)
            for m in ('ValleAR', 'ValleNAR')}
    torch.cuda.synchronize()

    reset_counters()
    t0 = time.perf_counter()
    train = {}
    for model in ('ValleAR', 'ValleNAR'):
        for arm, (args, _s, _m, _z) in PIPE_ARMS.items():
            c = cfg_for(arm)
            got = pipe_grads(model, c, batch(model), grid(args), dev)
            worst, moved = apart(got, refs[model])
            r_loss = refs[model][0]
            if (abs(got[0] - r_loss) > 1e-5 * max(1.0, abs(r_loss))
                    or worst > MESH_GRAD_RTOL or moved > MESH_PARAM_LR * c.lr):
                fail(f'pipe ({model}, {arm}): loss {got[0]} against solo {r_loss}, worst '
                     f'grad share {worst:.3e}, params apart {moved:.3e}')
            train[f'{model}_{arm}'] = dict(loss=got[0], solo_loss=r_loss,
                                           worst_grad_share=worst, params_apart=moved)
    dropout = {}
    for model in ('ValleAR', 'ValleNAR'):
        runs = {}
        for sched in ('gpipe', '1f1b'):
            c = ConfigValle(dropout=0.1, batch_size=PIPE_TRAIN['b'],
                            matmul_precision='highest', mesh_data=2, mesh_pipe=2,
                            mesh_model=2, pp_schedule=sched, pp_microbatches=4)
            runs[sched] = pipe_grads(model, c, batch(model), grid((2, 2, 2)), dev)
        worst, moved = apart(runs['1f1b'], runs['gpipe'])
        loss_1f1b, loss_gpipe = runs['1f1b'][0], runs['gpipe'][0]
        if (abs(loss_1f1b - loss_gpipe) > 1e-6 * max(1.0, abs(loss_gpipe))
                or worst > MESH_GRAD_RTOL or moved > MESH_PARAM_LR * c.lr):
            fail(f'pipe ({model}, dropout 0.1): 1F1B against GPipe: loss {loss_1f1b} '
                 f'against {loss_gpipe}, worst grad share {worst:.3e}, params '
                 f'apart {moved:.3e}')
        dropout[model] = dict(loss=runs['gpipe'][0], solo_loss_dropout0=refs[model][0],
                              worst_grad_share=worst, params_apart=moved)
    train_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = dataclasses.replace(
            ConfigValle.from_json(ROOT / 'examples' / PIPE_FIT['example']),
            max_steps=PIPE_FIT['steps'], batch_size=PIPE_FIT['batch'],
            log_every_n_steps=1, ckpt_every_n_steps=0, prefetch_batches=0,
            ckpt_path=Path(tmp) / 'ckpt', log_path=Path(tmp) / 'logs')
        on = training_mesh(fcfg, ['cuda:0'] * (fcfg.mesh_data * fcfg.mesh_pipe))
        loader, _valid = get_dataloaders('ValleAR', fcfg, synthetic=True)
        t1 = time.perf_counter()
        fitted = tt.Trainer(fcfg, 'ValleAR', mesh=on, use_tensorboard=False).fit(
            tt.init_state(fcfg, 'ValleAR', device=dev), loader)
        fit_s = time.perf_counter() - t1
        if fitted.step != PIPE_FIT['steps'] or not (Path(tmp) / 'ckpt' / 'ValleAR' /
                                                    f'step_{PIPE_FIT["steps"]}').exists():
            fail(f'pipe: Trainer.fit on {on.shape} ended at step {fitted.step}')
    torch.cuda.synchronize()
    launches = read_counters()
    require_launches('pipe', launches, ('tp_allreduce',))
    if plain_calls():
        fail(f'pipe: {plain_calls()} plain fused-step calls')

    # the negative control: stage 0's embedding grads left out of the sum
    arm = 'pipe4_gpipe_m4'
    with dropped_stage0_embedding():
        faulty = pipe_grads('ValleAR', cfg_for(arm), batch('ValleAR'),
                            grid(PIPE_ARMS[arm][0]), dev)
    control, _moved = apart(faulty, refs['ValleAR'])
    if control <= MESH_GRAD_RTOL:
        fail(f'pipe: a dropped stage-0 embedding grad left the grads {control:.3e} '
             f'apart, within the limit {MESH_GRAD_RTOL:.1e}')
    train['control_dropped_stage0_embedding'] = dict(worst_grad_share=control,
                                                     limit=MESH_GRAD_RTOL)

    # 5c under autograd at the 2 x 2 x 2 arm's stage shape (a microbatch of
    # 2 rows, s = 64 + 256, d 256) against its plain version
    gen = torch.Generator(device=dev).manual_seed(5)
    s = PIPE_TRAIN['frames'] + PIPE_TRAIN['frames'] // 4
    parts = [torch.randn(2, s, 256, generator=gen, device=dev).requires_grad_()
             for _ in range(2)]
    bias = [torch.randn(256, generator=gen, device=dev) for _ in range(2)]
    res = [torch.randn(2, s, 256, generator=gen, device=dev) for _ in range(2)]
    outs = tnn.psum_replicated_grad(parts, bias, res, torch.float32)
    if not all(torch.equal(x, y) for x, y in
               zip(outs, ta.tp_row_reduce_plain([p.detach() for p in parts], bias, res))):
        fail('pipe: 5c under autograd differs from its plain version')
    ct = [torch.randn_like(x) for x in outs]
    grads = torch.autograd.grad(outs, parts, ct)
    if not all(torch.equal(g, c) for g, c in zip(grads, ct)):
        fail('pipe: 5c\'s backward is not the identity')

    # (c) the 204M widths, bf16, pipe 4 on one card: GPipe against 1F1B
    timed_arms = {}
    for sched, m in PIPE_TIMED:
        c = ConfigValle(**LARGE, dropout=0.1, batch_size=16, dtype='bfloat16',
                        mesh_pipe=4, pp_schedule=sched, pp_microbatches=m)
        timed_arms[f'{sched}_m{m}'] = mesh_step_ms(
            c, 'ValleAR', 16, 512, PIPE_TIMED_STEPS, grid((1, 4, 1)), dev, warmup=1)
    peak = {k: v['peak_mem_gb'][str(dev)] for k, v in timed_arms.items()}
    if not peak['1f1b_m16'] < peak['gpipe_m16']:
        fail(f'pipe: 1F1B\'s peak at M=16 ({peak["1f1b_m16"]:.3f} GB) is not below '
             f'GPipe\'s ({peak["gpipe_m16"]:.3f} GB)')
    emit(phase='pipe', arms={k: dict(grid=list(v[0]), schedule=v[1], microbatches=v[2],
                                     zero1=v[3]) for k, v in PIPE_ARMS.items()},
         dtype='float32', batch=PIPE_TRAIN['b'], s=s, train=train, dropout_0p1=dropout,
         train_s=train_s, fit=dict(PIPE_FIT, mesh=on.shape, seconds=fit_s),
         kernel_err={'tp_row_reduce_autograd': 0.0},
         timed=dict(geometry=LARGE, batch=16, frames=512, s=640, dtype='bfloat16', pipe=4,
                    steps=PIPE_TIMED_STEPS, arms=timed_arms),
         launches={k: v for k, v in launches.items() if v}, card=smi)
    return launches


def card_busy(prof, cards, wall: float) -> dict:
    """Each card's busy share of ``wall`` seconds: the union of its kernels'
    intervals in the torch.profiler trace ``prof`` (a range of
    ``profiling.annotate``, which the trace also shows on the card, is no
    kernel)."""
    from torch.autograd import DeviceType
    busy = {}
    for d in cards:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA and e.device_index == d.index
                       and not getattr(e, 'is_user_annotation', False))
        total, end = 0.0, None
        for a, z in spans:
            if end is None or a > end:
                total += z - a
                end = z
            elif z > end:
                total += z - end
                end = z
        busy[str(d)] = total / 1e6 / wall          # profiler times are in microseconds
    return busy


def pipe_step_busy(cfg, model: str, b: int, frames: int, on, dev) -> dict:
    """One train step (after one warm-up step), solo (``on`` None) or on
    ``on``, under torch.profiler: its wall ms and each card's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from valle2_tpu_torch import train as tt
    cards = sorted({torch.device(d) for d in (on.devices if on else [dev])},
                   key=lambda d: d.index or 0)
    state = tt.init_state(cfg, model, device=dev)
    if on is not None:
        state = tt.shard_state(on, state, cfg)
    data = bench_data(model, b, frames, dev)
    step = tt.make_train_step(cfg, model, on)
    state, _m = step(state, data, 1)
    for d in cards:
        torch.cuda.synchronize(d)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _m = step(state, data, 1)
        for d in cards:
            torch.cuda.synchronize(d)
        wall = time.perf_counter() - t0
    del state, data
    return dict(wall_ms=1e3 * wall, busy_share=card_busy(prof, cards, wall))


def phase_pipe_cards(devices, smi: str = '') -> None:
    """``--mesh-cards N``: pipeline training over the cards at the 204M
    geometry (LARGE), bench_data at b=16 x 512 (s = 640), bf16, dropout 0.1:
    solo (cuda:0) beside each of PIPE_CARDS_ARMS (pipe 4, 4 layers a card,
    and pipe 2 x model 2, each with GPipe and 1F1B at M=8): the wall ms a
    step, each card's peak memory (``mesh_step_ms``), and each card's busy
    share of one profiled step (``pipe_step_busy``).  No speed gate; each
    arm's first loss within bf16's reach of solo's."""
    import torch
    from valle2_tpu_torch.config import ConfigValle
    from valle2_tpu_torch.parallel import make_pp_mesh

    n = len(devices)
    _warm, steps = MESH_CARDS_STEPS
    dev = torch.device(devices[0])
    base = dict(LARGE, dropout=0.1, batch_size=16, dtype='bfloat16')
    out, busy = {}, {}
    for label, spec in {'solo': None, **PIPE_CARDS_ARMS}.items():
        if spec is None:
            cfg, on = ConfigValle(**base), None
        else:
            args, sched, m = spec
            if args[0] * args[1] * args[2] > n:
                continue
            cfg = ConfigValle(**base, mesh_pipe=args[1], mesh_model=args[2],
                              pp_schedule=sched, pp_microbatches=m)
            on = make_pp_mesh(*args, devices[:args[0] * args[1] * args[2]])
        out[label] = mesh_step_ms(cfg, 'ValleAR', 16, 512, steps, on, dev)
        busy[label] = pipe_step_busy(cfg, 'ValleAR', 16, 512, on, dev)
    solo = out['solo']['first_loss']
    for label, r in out.items():
        if abs(r['first_loss'] - solo) > 5e-2 * max(1.0, abs(solo)):
            fail(f'pipe cards: {label}\'s first loss {r["first_loss"]} against solo '
                 f'{solo}')
    emit(phase='pipe_cards', cards=n, geometry=LARGE, batch=16, frames=512, s=640,
         dtype='bfloat16', steps=steps, arms=out, busy=busy, card=smi)


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    import valle2_tpu_torch  # fails at once outside a checkout
    if Path(valle2_tpu_torch.__file__).resolve().parent != ROOT / 'valle2_tpu_torch':
        fail(f'valle2_tpu_torch was imported from {valle2_tpu_torch.__file__}, not from '
             f'the checkout that holds this script')

    from valle2_tpu_torch.profiling import H100_PEAK_BF16_FLOPS
    PEAK_FLOPS['bfloat16'] = H100_PEAK_BF16_FLOPS
    smi = phase_device()
    timed(phase_build)
    results: dict = {}
    timed(phase_kernels, results)
    timed(phase_quant_kernels, results)
    timed(phase_spec_kernels, results)
    timed(phase_chunk_kernels, results)
    timed(phase_per_row_kernels, results)
    timed(phase_persistent_kernels, results)
    timed(phase_flash_tc_kernels, results)
    timed(phase_tp_kernels, results)
    timed(phase_rvq_kernel, results)
    timed(phase_greedy)
    paths = {'serve': timed(phase_main)}
    paths['checkpoint'] = timed(phase_checkpoint, smi)
    timed(phase_step_profile, smi)
    paths['quant'] = timed(phase_quant, smi)
    paths['spec'] = timed(phase_spec, smi)
    paths['stream'] = timed(phase_stream, smi)
    paths['cb'] = timed(phase_cb, smi)
    paths['hub'] = timed(phase_hub, smi)
    paths['tp'] = timed(phase_tp, ['cuda:0'] * 2, smi)
    timed(phase_codec)
    paths['clone'] = timed(phase_clone)
    paths['asr'] = timed(phase_asr)
    paths['server'], paths['lora'] = timed(phase_server, smi)
    timed(phase_train_kernels, results)
    timed(phase_grads)
    paths['train'] = timed(phase_train, smi)
    paths['data'] = timed(phase_data)
    timed(phase_fit)
    paths['grammar'] = timed(phase_grammar, smi)
    timed(phase_profile, smi)
    timed(phase_profile, smi, 'ValleNAR')
    timed(phase_large_kernels, results)
    paths['large'] = timed(phase_large, smi)
    timed(phase_fold_kernels, results)
    paths['fold'] = timed(phase_fold, smi)
    paths['gemm'] = timed(phase_gemm, results, smi)
    paths['mesh'] = timed(phase_mesh, smi)
    paths['pipe'] = timed(phase_pipe, smi)
    emit(phase_seconds=PHASE_SECONDS)
    keys = ('max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms', 'tol')
    kernels = []
    for name, src, replaces, shape_key, extra, dtypes, on_paths in (
            ('flash_attention_fwd', 'flash_attention.cu', 'flash_attention.py:290', 'ar',
             {'serve': None, 'nar': 'nar', 'ar_long': 'ar_long'}, ('bfloat16', 'float32'),
             ('serve', 'clone', 'asr', 'train', 'spec', 'large', 'server', 'checkpoint')),
            ('flash_attention_fwd_folded', 'flash_attention.cu', 'flash_attention.py:243',
             '204m', {c: c for c in FOLD_CASES if c != '204m'}, ('bfloat16', 'float32'),
             ('fold',)),
            ('flash_bwd_fused', 'flash_attention_bwd.cu', 'flash_attention.py:560', 'ar',
             {'nar': 'nar'}, ('bfloat16', 'float32'), ('train', 'fold', 'checkpoint')),
            ('flash_bwd_dq', 'flash_attention_bwd.cu', 'flash_attention.py:582', 'ar_long', {},
             ('bfloat16', 'float32'), ('train', 'fold')),
            ('flash_bwd_dkv', 'flash_attention_bwd.cu', 'flash_attention.py:602', 'ar_long',
             {}, ('bfloat16', 'float32'), ('train', 'fold')),
            *((name, 'gemm.cu', f'probes/_gemm_pallas_roofline.py:{line}', 'ffn1_204m',
               {'square4096': 'square4096', 'out_204m': 'out_204m'}, ('bfloat16',), ('gemm',))
              for name, line in (('matmul_fullk', 46), ('matmul_ksplit', 84))),
            ('fused_decode_step', 'fused_step.cu', 'fused_decode.py:706', None, {},
             ('bfloat16', 'float32'), ('serve', 'clone', 'asr', 'large', 'server',
                                       'checkpoint')),
            ('fused_decode_step_chunked', 'fused_step.cu', 'fused_decode.py:706', None, {},
             ('bfloat16', 'float32'), ('serve', 'clone', 'asr', 'quant', 'stream', 'large')),
            ('fused_verify_step_chunked', 'fused_step.cu', 'fused_decode.py:1017', None, {},
             ('bfloat16', 'float32'), ('spec',)),
            ('rvq_encode', 'rvq.cu', 'rvq.py:77', 'batch_16x300',
             {'prompt': 'prompt_1x150', 'ragged': 'ragged_3x77'}, ('float32',),
             ('clone', 'asr', 'data', 'server', 'checkpoint')),
            *((f'fused_decode_step_{v}', 'fused_step.cu', 'fused_decode.py:706', None, {},
               ('bfloat16', 'float32'), ('quant', 'large') if v == 'w8a8' else ('quant',))
              for v in QUANT_VARIANTS),
            *((step_name('fused_verify_step', v), 'fused_step.cu', 'fused_decode.py:1017',
               None, {}, ('bfloat16', 'float32'), ('spec', 'large') if v in ('dense', 'w8a8')
               else ('spec',)) for v in VERIFY_VARIANTS),
            ('fused_decode_step_per_row', 'fused_step.cu', 'fused_decode.py:706', None, {},
             ('bfloat16', 'float32'), ('cb', 'hub', 'server')),
            ('fused_decode_step_per_row_chunked', 'fused_step.cu', 'fused_decode.py:706',
             None, {}, ('bfloat16', 'float32'), ('hub',)),
            ('tp_allreduce', 'fused_decode.cu', 'fused_decode.py:252', 'prefill',
             {'nar': 'nar', 'step_rows12': None, 'mp4': 'mp4'}, ('float32',), ('tp',)),
            ('fused_decode_step_tp', 'fused_step.cu', 'fused_decode.py:706', None,
             {'mp4': 'mp4', **{f'{c}_mp{m}': f'{c}_mp{m}' for c in TP_CASES if c != 'serve'
                               for m in TP_MPS}}, ('bfloat16', 'float32'), ('tp',)),
            ('fused_verify_step_tp', 'fused_step.cu', 'fused_decode.py:1017', None,
             {'mp4': 'mp4'}, ('bfloat16', 'float32'), ('tp',))):
        def pick(key, dtype_name):
            r = results[(name, dtype_name) if key is None else (name, key, dtype_name)]
            return {k: r[k] for k in keys}
        by_path = {p: paths[p][name] for p in on_paths}
        # the chunked steps, a fine-tune's kernels, the data axis
        for p in ('server', 'lora', 'checkpoint', 'grammar', 'mesh', 'pipe'):
            if p not in by_path and paths[p][name] > 0:
                by_path[p] = paths[p][name]
        entry = dict(name=name, route='cuda', source=f'valle2_tpu_torch/csrc/{src}',
                     replaces=replaces if replaces.startswith('probes/')
                     else f'valle2_tpu/kernels/{replaces}',
                     launches=sum(by_path.values()), launches_by_path=by_path,
                     dtype=dtypes[0], case=shape_key or 'serve', **pick(shape_key, dtypes[0]))
        if len(dtypes) > 1:
            entry['f32'] = pick(shape_key, 'float32')
        for label, key in extra.items():
            entry[label] = {DTYPE_LABEL[d]: pick(key, d) for d in dtypes}
        if (name, 'large', 'bfloat16') in results:
            entry['large'] = {'bf16': pick('large', 'bfloat16')}
        if (name, 'f32_cache', 'bfloat16') in results:   # a bf16 model over an f32 cache
            entry['bf16_f32_cache'] = pick('f32_cache', 'bfloat16')
        if name == 'flash_attention_fwd_folded':
            for key in ('per_head_ms', 'schedule'):
                entry[key] = {DTYPE_LABEL[d]: {c: results[(name, c, d)][key]
                                               for c in FOLD_CASES} for d in dtypes}
            entry['design'] = {DTYPE_LABEL[d]: FOLD_DESIGN[d] for d in dtypes}
        elif name.startswith('matmul_'):
            entry['design'] = GEMM_DESIGN[name]
            for key in ('peak_share', 'back_to_back_ms', 'back_to_back_peak_share',
                        'library_back_to_back_ms', 'arms_ms', 'arms_peak_share',
                        'arms_back_to_back_ms'):
                entry[key] = {sname: results[(name, sname, 'bfloat16')][key]
                              for sname in ('square4096', 'ffn1_204m', 'out_204m')}
        if name in TP_PORTS:
            entry['ports'] = TP_PORTS[name]
            entry['case'] = 'tp_virtual_ranks_mp2'
            if name != 'tp_allreduce':
                # the persistent TP step beside its phased twin, every case
                entry['persistent_vs_phased'] = {
                    key or 'mp2': {DTYPE_LABEL[d]: {k: results[(name, key, d) if key else (name, d)][k]
                                           for k in ('ms', 'phased_ms', 'enqueue_ms',
                                                     'phased_enqueue_ms')}
                          for d in dtypes}
                    for key in (None, *extra.values())}
        elif name in PER_ROW_PORTS:
            entry['scalar_index_ms'] = {DTYPE_LABEL[d]: results[(name, d)]['scalar_index_ms']
                                        for d in dtypes}
            entry['ports'] = PER_ROW_PORTS[name]
            entry['case'] = 'per_row'
        elif name.endswith('_chunked'):
            entry['whole_s_ms'] = {DTYPE_LABEL[d]: results[(name, d)]['whole_s_ms']
                                   for d in dtypes}
            entry['ports'] = CHUNK_PORTS[name]
            entry['case'] = 'stream' if 'decode' in name else 'spec'
        elif name.startswith('fused_decode_step_'):
            entry['ports'] = 'valle2_tpu/kernels/' + QUANT_VARIANTS[name.removeprefix('fused_decode_step_')][2]
        elif name.startswith('fused_verify_step_'):
            entry['ports'] = ('valle2_tpu/kernels/fused_decode.py:752 _verify_kernel with '
                              + QUANT_VARIANTS[name.removeprefix('fused_verify_step_')][2])
        if name in PERSISTENT_ROWS:
            entry['persistent_vs_phased'] = {
                f'{case}_{v}': {DTYPE_LABEL[d]: {k: results[('persistent', case, v, d)][k]
                                                 for k in ('ms', 'phased_ms', 'enqueue_ms',
                                                           'phased_enqueue_ms')}
                                for d in ALL_PERSISTENT[case]['dtypes']}
                for case, v in PERSISTENT_ROWS[name]}
        if name == 'flash_attention_fwd':
            entry['cuda_cores_ms'] = {
                'serve': results[('flash_attention_fwd', 'bfloat16')]['cuda_cores_ms'],
                **{c: results[('flash_attention_fwd', c, 'bfloat16')]['cuda_cores_ms']
                   for c in TRAIN_CASES},
                **{f'{c}_{ca}': results[('flash_attention_fwd', f'{c}_{ca}',
                                         'bfloat16')]['cuda_cores_ms']
                   for c in FLASH_TC_CASES for ca in (1, 0)}}
        elif name.startswith('flash_bwd_'):
            entry['cuda_cores_ms'] = {c: results[(name, c, 'bfloat16')]['cuda_cores_ms']
                                      for c in TRAIN_CASES if (name, c, 'bfloat16') in results}
        if name.startswith('flash_'):
            # each case's share of its bound (f32: of the FFMA bound)
            cases = FOLD_CASES if name == 'flash_attention_fwd_folded' else TRAIN_CASES
            entry['bound_share'] = {DTYPE_LABEL[d]: {c: results[(name, c, d)]['bound_share']
                                                     for c in cases
                                                     if (name, c, d) in results}
                                    for d in dtypes}
        if entry['launches'] <= 0:
            fail(f'{name} was never launched on the paths that run it')
        kernels.append(entry)
    emit(kernels=kernels)
    print(smi, flush=True)
    emit(ok=True, device={'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                          'count': torch.cuda.device_count()})
    return 0


def main_mesh(n: int) -> int:
    """``python3 chip_smoke.py --mesh-cards N``, on a host of N cards: the
    cards' peer access (every pair must have it), the build, the persistent
    TP step over the N cards against its phased twin (``phase_tp_cards``),
    phase tp over cuda:0..N-1, the 204M stack at mp N
    (``phase_tp_large``), training over the cards (``phase_mesh_cards``)
    and pipeline training over them (``phase_pipe_cards``)."""
    sys.path.insert(0, str(ROOT))
    import torch
    from valle2_tpu_torch.profiling import H100_PEAK_BF16_FLOPS
    PEAK_FLOPS['bfloat16'] = H100_PEAK_BF16_FLOPS
    smi = phase_device()
    if torch.cuda.device_count() < n:
        fail(f'--mesh-cards {n} needs {n} cards, found {torch.cuda.device_count()}')
    peers = {f'{a}->{b}': torch.cuda.can_device_access_peer(a, b)
             for a in range(n) for b in range(n) if a != b}
    emit(phase='peers', cards=n, peer_access=peers)
    if not all(peers.values()):
        fail(f'tensor parallelism needs peer access between every pair of cards: {peers}')
    timed(phase_build)
    devices = [f'cuda:{i}' for i in range(n)]
    timed(phase_tp_cards, devices, smi)
    timed(phase_tp, devices, smi)
    timed(phase_tp_large, devices, smi)
    timed(phase_mesh_cards, devices, smi)
    timed(phase_pipe_cards, devices, smi)
    emit(phase_seconds=PHASE_SECONDS)
    print(smi, flush=True)
    emit(ok=True, device={'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                          'count': torch.cuda.device_count()})
    return 0


def run() -> int:
    """``main`` (or ``main_mesh`` under ``--mesh-cards N``); on a failure,
    the phase it came from and its traceback end the standard error, and the
    process exits 1 at once: a device-side assert's messages, which the CUDA
    runtime may still hold, would otherwise print after them at the context's
    teardown and bury them."""
    import os
    import traceback
    try:
        if sys.argv[1:2] == ['--mesh-cards']:
            return main_mesh(int(sys.argv[2]))
        return main()
    except BaseException as exc:            # noqa: BLE001 -- reported, then exit 1
        if isinstance(exc, SystemExit) and exc.code in (0, None):
            raise
        frames = traceback.extract_tb(exc.__traceback__)
        phase = next((f.name for f in frames if f.name.startswith('phase_')), 'main')
        if not isinstance(exc, SystemExit):
            traceback.print_exception(exc, file=sys.stderr)
        print(f'chip_smoke: FAILED in {phase}: {type(exc).__name__}: {exc}',
              file=sys.stderr, flush=True)
        sys.stdout.flush()
        os._exit(1)


if __name__ == '__main__':
    sys.exit(run())
