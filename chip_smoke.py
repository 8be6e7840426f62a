#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. The card (nvidia-smi name and power limit, torch/CUDA versions) and the
     build of every kernel from `oryx_tpu_torch/csrc` (one nvcc per source,
     in parallel: flash attention, its backward, paged attention, the int8
     product), with each kernel's registers and spills from ptxas.
  2. The main path's host side at full width (`config.oryx_7b()`, a
     four-request image/multi-image/video/text mix), then each kernel call
     shape of that path (ViT segments, compressor regions, decoder prefill:
     K1's wgmma/TMA body over the cell map; decode: its split-KV route) run
     through the kernel and through its plain PyTorch twin on the same bf16
     inputs, held to atol = rtol = 1e-2 on the rows callers keep, and
     against an fp32 witness (the twin on the same inputs upcast): the
     kernel's relative L2 error at most NOISE_RATIO times the bf16 twin's.
     Median wrapper time from CUDA events ("ms") beside the kernels'
     device time per call from torch.profiler ("device_ms": the summed
     kernel durations, the cell map's or the decode merge's launches
     included, copies left out: `measure.device_ms`, the median of up to
     three passes that kept a record of every kernel they launched, with
     their spread; null when fewer than two did), the twin's time, SDPA
     with a boolean mask as a yardstick, and the least time the card could
     take (bytes / 3.35 TB/s vs flops / 989 TFLOP/s).
     The decode call is also timed replayed inside a CUDA graph
     ("graph_ms"), the route the decode loop takes.
  3. `Pipeline.chat_batch` on the mix, greedy, 32 new tokens, random bf16
     weights from torch.Generator("cuda") seeded 0, three times: the tokens
     must be identical, the kernel must have launched for every call
     shape in the first run (replays of the decode graphs count their
     launches), and every decode call must have taken K1's split-KV decode
     route. The decode runs as replays of CUDA graphs of 8 steps (captured
     in run 0); in the same call the eager loop (`_decode_while` with no
     graph, on the same prefill) is the witness: its tokens must be
     byte-equal. Both decode walls and the capture time are printed.
  4. The same mix with attn_impl="xla" (plain attention); greedy token
     agreement with the kernel path is printed, not asserted. Prefill
     last-token logits of both bf16 paths are held against an fp32 witness
     (plain attention, the same bf16 weights upcast in every product): per
     row, the kernel path's relative L2 error may be at most NOISE_RATIO
     times the plain path's, so the kernel adds no error beyond bf16
     rounding noise.
  5. One more chat_batch under torch.profiler (CUDA activity only, so the
     host is barely slowed): device time by kernel family, the top
     kernels, K1's share of the device time, and the device's idle share
     inside the trace (1 - union of kernel intervals / the call's wall).
     Then `generate` on the mix's embeds (prefill + 32 steps) traced on
     the graph route and on the eager witness: idle share and the
     runtime's launch calls a step for each.
 14. (Runs after 5.) The rest of the dense path at full width and depth:
     `chat_stream` of the 448x448 image request joins to `chat()`'s reply;
     seeded sampling at temperature 0.7 (seed 3) through the graphs gives
     the same tokens twice, the eager witness's tokens, and
     `generate_stream`'s blocks, which differ from one another (a
     generator not registered with the graphs would repeat one stream);
     three turns of a `ChatSession` over the image, cached and uncached,
     in bf16 (equality printed) and with fp32 compute (equality asserted;
     bf16 rounds prefill-computed and decode-computed K/V differently),
     the cached turns 2-3 prefilling only their 256-row text suffix (no
     ViT call), TTFTs (the ask's wall less its decode and any graph
     capture) printed; three sessions over a 1,536-byte shared context
     through one `SessionPrefixCache`, the second and third seeding from
     the first (each prefill one 256-row bucket; prefill walls beside a
     cold chat of the same prompt);
     `score_options` over four options against a teacher-forced full
     forward: the same argmax, each score within 0.1 a token. Then K1 at
     the two new call shapes (the suffix prefill from a start that is not
     a multiple of 64, and an option's rows after the prompt) against its
     plain twin, timed as in phase 2.
  7. The serving engine, `ContinuousScheduler`, at full width on the
     phase-1 weights: 4 slots, 64-token pages, 8-step chunks, max_ctx
     4096, the default 256-page pool, greedy, the prefix cache on (the
     engine's default; each request's cached tokens are printed); the
     four requests above at
     32 new tokens plus four text requests at 8/16/24/48 (8 requests on
     4 slots). The split engine (paged prefill through the flash kernel,
     decode through the paged-decode kernel K3) and the ragged engine
     (prefill_chunk 512: every step one packed dispatch through the
     ragged-paged kernel K4), twice each: every request finishes with its
     usage, the two runs of an engine give identical tokens, and K3 (split)
     or K4 (ragged) launched. The ragged engine's run 0 is the eager
     witness, its run 1 the graph route (every pure-decode dispatch a replay
     of the captured engine step): their replies are byte-equal, and both
     walls, the tails after the last admission and the capture time are
     printed. Walls, TTFTs, tokens/s, dispatches by kind,
     peak memory. The first run of each engine records the paged kernels'
     call operands (one call per forward, on layer 0's pool). A fifth,
     split-engine run under torch.profiler, as in phase 5.
  6. (Runs after 7.) Each paged kernel at the largest call phase 7
     recorded - K3 on a split decode step, K4 on a ragged step with
     prefill lanes and on a pure decode step - and the flash kernel at the
     split engine's largest paged prefill, with random bf16 q and pages,
     against its plain twin (atol = rtol = 1e-2, every row sees a key).
     The paged kernels are called through the public wrappers the model
     calls (`ragged_decode_attention`, `ragged_paged_attention`), on q in
     the recorded layout and the int operands as recorded. Each call's
     split plan and row tile are printed (more than one split; where
     prefill lanes ride behind the decode rows, row tiles of 64 / G rows
     behind one-row tiles of the decode rows), and two calls must give
     the same bits. Wrapper and
     twin times, gather_pages + SDPA with an explicit mask as a two-call
     yardstick, and the least time the card could take.
 15. (Runs after 6.) Speculation and megasteps in the ragged engine at
     full width and depth, on phase 7's mix and weights: fuse_steps=4 and
     "auto" give phase 7's replies byte for byte; one solo request of 128
     new tokens under "auto" reaches rung 16, traced (host launch calls a
     logical step and the kernels' idle share after its eager dispatch);
     speculate=4 with an oracle drafter proposing phase 7's replies (run
     twice: equal) and with NgramDrafter (graph route and eager witness:
     equal), tokens per verify step and accept rates printed, agreement
     with phase 7 printed (bf16 rounds a 20-row verify GEMM otherwise than
     a 4-row decode one); a NeuralDrafter fit on phase 7's replies,
     speculate=4 on the graph route equal to its eager witness and to
     fuse_steps=4, over a bf16 and an int8 pool; the tiny fp32 engines
     speculating, fused and both, card == CPU == the plain engine, over
     bf16 and int8 pools; then K4 and K4q at the speculative call shapes
     (R = 4 x 5 verify rows, alone and with 512 prefill lanes behind
     them), each recorded on its pool's eager witness, against their plain
     twins, timed as in phase 6.
 16. (Runs after 15.) Checkpoints and int8 weights. (a) `save_pretrained`
     and `export_hf` of phase 2's full oryx_7b into a temporary directory
     (cut to 2 LLM and 2 ViT layers of full width, random bf16, seed 5,
     when the disk cannot hold both checkpoints or they would write more
     than DISK_WRITE_CAP, as the full oryx_7b's 48.3 GB do), loaded back by
     `load_pretrained_model` and `load_from_hf(projector_path=)`: every
     tensor byte-equal; `load_pretrained_model(quantize="int8")` byte-equal
     to `quantize_params` of the same floats, its peak card memory printed
     beside `quantized_bytes`; depth, bytes written and walls printed.
     (b) Phase 2's weights through `quantize_params` (bytes and peak
     memory printed), `chat_batch` on the mix three times: identical
     tokens, the graph route byte-equal to the eager witness, decode ms a
     step beside phase 3's bf16, the q8 kernel launched for every decoder
     launch (q/k/v and gate/up grouped, one launch each) on every decode
     step, agreement with bf16 printed. (c) The ragged engine on the int8
     model over phase 7's mix: the eager witness and the graph route
     byte-equal; one more run with speculate=4 (NgramDrafter) for the
     20-row verify shape. Through (b) and (c) no int8 product may reach the
     plain twin on the card (`q8_twin_guard`). (d) The q8 kernel
     (`csrc/q8_linear.cu`, every route) against its plain twin at the
     main path's launch shapes (`q8_row_shapes`: per launch class M = 4
     and 20, and past 64 rows the ragged mix's, the prefill lanes' and the
     largest, which covers the chat prefill, the ViT with its fp32 patch
     embedding, the compressor and the projector): bf16 atol = rtol =
     1e-2 (fp32 2e-4 / 2e-3), the relative L2 error against an fp32
     witness at most NOISE_RATIO times the twin's, the same bits twice, a
     row's bits the same at other row counts of its route, a grouped
     launch giving each member the bits of its own launch; whether the
     first 64 rows of a wgmma-route call get the small route's bits is
     printed, not required; event and device ms, the twin's, F.linear on
     the dequantized weights (what the bf16 model pays) and the bound;
     the same check, with event ms, for a tied head's per-column scales at
     lm_head's shape, M = 4, 20 and 516. The int8 model is freed before
     phase 8.
  8. The tiny fp32 config through both engines on the card (kernel path)
     and on the CPU (plain twins), over a bf16 and an int8 pool with the
     prefix cache on: replies, finish reasons and usage equal.
  9. The training kernels at three call shapes of phase 10's steps (the
     ViT's segments over the packed patches and the decoder's B x T with
     slot positions on the image batch, the compressor's 4 x 4-patch
     regions on the video batch): K1 with its logsumexp, K5a (dq) and K5b
     (dk/dv) on random bf16 q/k/v and a cotangent zero on fully masked
     rows, against their plain twins. K1: atol = rtol = 1e-2 on the
     output, the lse to 1e-3; K5: the relative L2 error of each of dq,
     dk, dv against an fp32 witness (the twins on the same inputs upcast)
     at most NOISE_RATIO times the bf16 twin's. Times (event and device)
     as phase 2; the yardstick is SDPA forward (K1) and forward + backward
     (K5) with an explicit boolean mask.
 10. `Trainer.fit` under scripts/configs/oryx_7b_pretrain.json (stage-1
     projector pretraining, remat "attn", bf16) at full oryx_7b width and
     depth on phase 2's bf16 weights (frozen; the compressor gets fp32
     masters): `grouped_batch_iterator` over 8 synthetic records (4 images
     of 616x616, 4 videos of 8 frames of 224x224, 8,192-patch ViT
     buffers), the byte tokenizer, the plain template, batch 4, 4 steps
     (global batch 256 -> 4, steps 2000 -> 4). Losses finite, frozen leaves
     bitwise unchanged, compressor changed, K1-lse/K5a/K5b launched at
     every phase-9 shape, and a second fit from the same init, through
     the training CLI (phase 22 (b)), gives the same losses. Per step:
     wall, tokens/s, fwd+bwd vs optimizer device time, peak memory; then
     one step under torch.profiler and K5a + K5b's share of it.
 11. The tiny fp32 config, tune full, 3 steps of Trainer.fit on the card
     (kernels) and on the CPU (plain twins): losses and params agree.

 12. (Runs after 8.) The serving engine over an int8 pool (kv_dtype="int8") with a 256 MiB
     host tier, split and ragged, twice each (the ragged engine's run 0
     the eager witness), on the phase-2 weights:
     phase 7's eight requests; round A, five text requests sharing a
     1,536-byte context (24 pages), the last page-aligned; round B, the
     same five again (each splices its own cached prompt pages; the
     page-aligned one copies its last page on write); then every cached
     page is evicted, spilling to host RAM; round C, the first four again
     (reloaded from host). Every request finishes with its usage, the two
     runs give identical tokens, K3q (split) or K4q (ragged) launched, the
     cache hit, copied on write, spilled and reloaded, round C's replies
     equal round B's (the same cached bytes, the same suffix prefill) and
     the pool invariant holds. Cold-vs-cached and int8-vs-bf16 agreement
     are printed. Then generate_paged(kv_dtype="fp8_e4m3") on round A's
     prompts, split and ragged (the engine takes no fp8 pool).
 19. (Runs after 13.) The OpenAI-compatible HTTP server
     (`serve/api_server.build_server`, port 0, on a thread) over phase 2's
     weights, the client stdlib urllib, images as PNG data: URIs written by
     `png_data_uri`. (a) The continuous ragged engine at phase 7's geometry
     (prefix cache on): phase 7's mix without its video (the HTTP API
     carries image parts only), one request at a time, every other one
     streamed; replies, finish reasons and usage byte-equal to an
     in-process `ContinuousScheduler` of the same geometry given the same
     requests in the same order; K1 and K4 launched, K3 not. Then the seven
     as a concurrent burst: all 200, admitted == completed, the
     dispatches_total kinds sum to chunks, server TTFT p50/p99 from
     /metrics through `histogram_quantile`; every finished request in
     /debug/requests carries the full cost ledger, every /debug/trace the
     six spans. (c) Drain: `begin_drain()` while a stream is resident:
     /readyz and POSTs 503, the resident finishes, drain() returns. (b)
     The window engine: a burst of five image and text requests; each
     group the Batcher formed (read from the traces' decode spans) equals
     a direct `chat_batch` of the group in its row order; a stream's
     deltas join to a direct `chat_stream`. (d) Supervised restart: the
     engine thread is killed mid-decode by a raise from the watchdog's
     `set_active`, outside the loop's containment; the EngineSupervisor
     restarts it and the reply equals the unbroken one. Walls, client
     first-delta times, server TTFT quantiles, tokens/s and the HTTP
     layer's wall beside the in-process one are printed.
 13. (Runs after 12.) K3q at phase 12's largest split decode step, K4q at
     its largest ragged step with prefill lanes and its largest pure decode
     step, each on random int8 and fp8 pools through the public wrappers,
     against the plain twins (dequantizing gather, atol = rtol = 1e-2), timed
     as in phase 6 (the yardstick: dequantizing gather_pages + SDPA).

 17. (Runs after 10, on phase 2's weights.) LoRA SFT under
     scripts/configs/oryx_7b_sft_lora.json as written (r = 128, alpha 256,
     the seven decoder projections, remat "attn", bf16) at full oryx_7b
     width and depth: the adapters the Trainer draws (seed + 1), phase
     10's records as conversations through the plain template (phase 10's
     batch shapes), batch 128 -> 4, steps 5000 -> 4. Two fits from the
     same start give identical losses; every base leaf is bitwise phase
     10's; only lora_a, lora_b and compressor leaves move. Per step: wall,
     tokens/s, model FLOPs and MFU (utils/flops.py), device fwd+bwd and
     optimizer time, peak memory. Then one 4-step fit under each remat
     policy (none, block, dots, attn, attn_qkv, attn_o) from one start, on
     a model of full width cut to REMAT_LAYERS = 2 decoder layers (random,
     seed 0, its own adapters): peak memory and step walls, losses
     identical to "attn"'s (a policy that runs out of card memory is
     reported as not fitting, and its losses are held against "attn"'s at
     UNFIT_BATCH records). After phase 18:
     merge_lora on the card against the adapted forward (the merged
     weights within bf16 rounding of the exact sum; the prefill logits'
     rel L2 printed), the PEFT round trip (export_hf +
     export_lora_dir -> load_from_hf(lora_path=)) of a 2 + 2-layer model
     of full width against merge_lora in memory, byte-equal, and the tiny
     fp32 LoRA fit, card vs CPU, as phase 11.
 18. Packed-text training at full width: seeded text conversations of
     64-1,500 tokens through collate_packed_text into 4 rows of 4,096,
     four batches through Trainer.fit under the LoRA config. K1 with lse,
     K5a and K5b at the packed call shape (causal in slot order, the
     samples' segment ids, kv mask segs > 0) against their twins by
     phase 9's rules, timed beside SDPA with the boolean block-diagonal
     causal mask, the bound counting only the visible (q, k) pairs; the
     fit must launch each. The packed batch's loss equals the padded
     collation's of the same samples within 1e-2 (both printed).
 21. (Runs after 20, on phase 2's weights at phase 19's ragged geometry,
     over phase 20's four requests at 16 tokens.) (a) A server with the
     decision journal armed and faults_spec "engine_crash:after=3": the
     supervisor restarts the dead engine thread, the replies equal phase
     20's unarmed ones, the journal holds one `fault` and one `restart`
     entry, and serve/replay.run_replay replays it cold on the same
     weights (the image request from a payload sidecar) with no
     divergence, equal reply fingerprints and equal deterministic cost
     ledgers; the replay's wall is printed. (b) profile_sample_every=2:
     replies equal unarmed, every sampled timeline record within its
     window (one clock), device <= sampled wall per kind and positive for
     `ragged`, no capture error; device / wall and the idle share per kind
     printed. GET /debug/profile?steps=4 around the image request's
     admission: a Chrome trace naming K1 (flash_fwd_bf16) and K4
     (paged_split), whose K4 kernel count equals the K4 wrapper's launches
     over the captured steps (`scripts/torch_capture_check.py` repeats
     (b) alone). (c) The degraded ladder (ttft_slo 1 ms,
     queue_depth_slo 1, cooldown 1.5 s): a burst climbs it, short bursts
     once its queue drained take it to 3, where a request gets 429 with
     Retry-After; one
     degraded_escalation forensic an escalation, journaled `degraded`
     entries, back to 0 after quiet cooldowns, the pool invariant intact.
 22. The offline entry points. (a) (Runs after 21, on phase 2's bf16
     Pipeline.) The eval harness, `eval/harness.evaluate` through the
     native adapter over the committed smoke benchmark
     (assets/smoke_eval/task.jsonl: 4 PNG images, 4 videos as directories
     of 4 frames), EVAL_FRAMES frames, EVAL_NEW new tokens, batches of
     EVAL_BATCH, in generate and in loglikelihood mode, each twice: the two
     calls' records identical, every record with a reply (a letter in
     loglikelihood mode), the generate replies byte-equal to `chat_batch`
     of the same requests in the harness's own grouping. Accuracy (random
     weights: no meaning), seconds, pad_waste, the parsed letters and K1's
     launches by call shape printed. (b) (Inside phase 10.) Phase 10's
     second fit is `train/cli.main`: phase 10's records written as JSON
     with lossless PNGs (a video a directory of its 8 frames), the
     pretraining config at batch 4, 4 steps, a checkpoint and a log record
     every step and a fresh checkpoint dir (removed after), the plain
     template, --video-frames 8, --metrics-path, --metrics-port 0,
     --events-path, --numerics-every 2; the tokenizer and the start
     weights through the seams `builder.load_tokenizer` (ByteTokenizer)
     and `cli.load_params` (phase 10's start state). /metrics, /healthz
     and /readyz scraped from a thread during the loop and again after:
     the JSONL losses and grad norms bit-identical to fit 1's;
     oryx_train_steps_total 4, oryx_numerics_samples_total 2, 28 finite
     oryx_numerics_grad_layer_absmax{layer=} series; oryx_train_mfu in
     (0, 1) and equal to model_flops_per_sec over the card's peak; /readyz
     200 during the loop and 503 after; 4 train_step traces in the flight
     recorder, each with the spans data, h2d, step_dispatch, device_sync,
     checkpoint_save; K1-lse, K5a and K5b launched as often as in fit 1.
     The JSONL records and any anomaly events printed.
 23. (Runs after 22 (a), on phase 2's weights.) The concurrency plane and
     the fleet's front door. (a) Two ragged replicas at phase 19's
     geometry over the one set of weights behind `serve/router.
     build_router`, the lock-order sanitizer and race detector armed
     (record mode) and the capture watchdog counting: both replicas
     warmed at once (each captures its engine-step graph while the other
     launches); phase 19's mix one request at a time, twice, through the
     router and straight to the other replica, byte-equal (which side runs
     first alternates by round; the router's added wall a request, with
     its quartiles and range, and the TTFT through it printed); one merged
     `/debug/trace` with router and engine spans; a shared-prefix burst
     landing on one replica with cached tokens there only and admitted ==
     completed; a stopped listener retried invisibly, then restored by
     the prober; r0 drained at the first delta of a stream on it, the
     requests beside it all 200 and the new ones on r1; zero lock, race
     and hot-dispatch violations; one capture a graph key and replica.
     (b) `serve/cli.main` one-shot and interactive (a `:reset`, a blank
     line, `:q`) through the `builder.load_pipeline` seam, byte-equal to
     `Pipeline.chat` and `ChatSession(shared=True).ask_stream`. (c) The
     native loader built from `native/loader.cpp` on this machine,
     byte-equal to its numpy twin on phase 2's images at the pipeline's
     caps; `pack_raw_images`, which takes the library whenever it builds,
     within 1e-4 of the numpy path.
 24. (Runs after 23, before 9.) Tensor-parallel serving, `--shard tp=2`
     as the entry points run it: this process rank 0, rank 1 started by
     `parallel/mesh.parse_shard_arg`, both on the one card over gloo
     (printed: backend, devices), the activations summed on the card;
     each rank draws its shard of phase 2's seed-0 init tensor by tensor.
     (a) `Pipeline.chat_batch` over phase 3's mix, twice: byte-equal
     runs, both ranks' dispatch digests equal, prefill logits within
     NOISE_RATIO of the one-process bf16 error against phase 4's fp32
     witness; the leading tokens equal to phase 3's stream printed (bf16
     rounds a row-parallel sum differently). (b) the `sharded` engine over
     the 8 serving requests: the split route over a bf16 pool, then the
     ragged route with the prefix cache over an int8 pool twice,
     byte-equal; each rank's peak memory; then rank 1 killed: the engine
     reports dead within the collective timeout. (c) K1 at 14/2 decoder
     heads and 8 ViT heads, K3 and K4q at Hk = 2, each vs its twin at
     rank 0's recorded call shapes, with both ranks' launch counts (they
     must be equal). (e) The output auditor on the tp pipe: phase 3's mix
     at 16 tokens through the sharded ragged engine over a bf16 pool,
     unarmed and with audit_sample_every=1 (each replay step a dispatch
     both ranks run, over a private pool of the rank's KV heads): replies
     byte-equal, the
     bf16 verdicts printed (not gated, as in phase 20), then the
     auditor's K1 prefill (`flash_fwd[tp_audit_prefill]`) and one-row K3
     (`paged_decode[tp_audit]`) at rank 0's call shapes vs their twins.
     (f) The same pipe with LoRA adapters of oryx_7b_sft_lora.json's r
     and alpha on its seven targets (A and B drawn from a seed, whole on
     both ranks): phase 3's mix through chat_batch, both ranks' digests
     equal, replies other than (a)'s, prefill logits within NOISE_RATIO
     of the one-process bf16 error against an fp32 witness of phase 2's
     weights with the same adapters.
 25. (Runs after 1, before 2, on the empty card: ddp holds two whole
     copies of (a)'s state.) Data/sequence-parallel training and fsdp
     serving, two ranks on the one card (this process rank 0), their
     collectives through its exchange buffers, the K1/K5 plain twins made
     to raise on a card tensor on both ranks. (a) `oryx_7b_sft.json` (tune full) at
     2 decoder + 4 ViT layers, full width (ddp's 16 bytes a parameter,
     twice on one card), 2 steps on phase 10's records at fsdp=2 in each
     of fsdp, zero2 and ddp, twice each, and once on one process: each
     mode's runs bit-identical, the modes within rel 1e-3, fsdp within
     rel 1e-2 of one process, fsdp's resident param + grad + moment bytes
     at most 0.55x ddp's, both ranks' K1-lse/K5 launches equal. (b)
     `oryx_7b_longvideo.json` widths at 1 + 1 layers under ring_flash on
     sp=2, one row of 16,384 tokens, 2 steps, each rank's K1-lse launches
     following JAX's liveness rule; one decoder layer's ring attention
     (forward, q/k/v gradients) vs the one-process K1/K5 on the whole
     sequence, against the fp32 kernels' witness (NOISE_RATIO), and the
     xla ring once at 2,048 tokens. (d) `--shard fsdp=2` chat_batch over
     phase 3's mix at (a)'s depth, byte-equal to one process. (c) The
     training CLI as two processes (`--coordinator`, this one process 0):
     losses bit-equal to (a)'s fsdp fit. Every rank encodes its 1/W of
     the packed visual buffer (W = dp x fsdp x sp): (a) prints each
     rank's ViT rows and its peak beside the whole-buffer run's, and
     (b) counts the decoder's ring launches apart from the ViT's K2. (e)
     (a)'s config at fsdp=2 x tp=2 on four ranks of the card, 2 rows a
     batch, twice: bit-identical fits, losses and grad norms within rel
     1e-3 of an fsdp=2 fit on the same rows (run in (a)'s world), the four
     ranks' launches equal, each rank's bytes and peak (each fit in four
     fresh ranks). (f) In the second fit's world, `oryx_7b_sft_lora.json`
     (r = 128, seven targets) at 2 + 4 layers, 2 rows a batch, twice:
     bit-identical fits, losses and grad norms within rel 1e-3 of an
     fsdp=2 LoRA fit on the same rows and weights (run in (a)'s world),
     on every rank every frozen leaf bit-unchanged and every lora_b moved
     and finite, every rank's adapters bit-equal and each one's change
     (norm of after minus before) within rel 1e-2 of the reference's, the
     four ranks' launches equal, each rank's peak. Then
     K1-lse/K5 vs their twins at
     the fsdp decoder's, the ring block's, (a)'s ViT shard's (4,096 query
     patches against 8,192, 16 heads) and (e)'s decoder (14 q / 2 kv
     heads) and ViT shard (8 heads) call shapes.

`python3 chip_smoke.py --help` prints this text.
Every phase ends with a `phase N wall X s` line. The line before the last
is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

TOL = 1e-2  # kernel vs plain twin, bf16 outputs (atol = rtol)
NOISE_RATIO = 1.5  # kernel path vs plain path, error against the fp32 witness
MAX_NEW = 32
EOS = 151645


class ByteTokenizer:
    """Stand-in byte-level tokenizer: encodes text as its UTF-8 bytes, and
    decodes losslessly (ASCII as itself, any other id - random weights emit
    them - as "<id>"), so equal replies mean equal tokens. Keeps the ids of
    every decode call, so a run's tokens can be compared."""

    def __init__(self) -> None:
        self.decoded: list[list[int]] = []

    def encode(self, text, add_special_tokens=False):
        return list(text.encode("utf-8"))

    def decode(self, ids, skip_special_tokens=True):
        ids = [int(i) for i in ids]
        self.decoded.append(ids)
        return self.text(ids, skip_special_tokens)

    @staticmethod
    def text(ids, skip_special_tokens=True) -> str:
        """decode() without keeping the ids."""
        return "".join(
            chr(i) if i < 128 else f"<{i}>" for i in ids
            if not (skip_special_tokens and i == EOS)
        )

    def reply_ids(self, reply: str) -> list[int]:
        """The ids of a finished reply: the longest kept decode call whose
        text, stripped as the engine strips a finished reply, is `reply`."""
        best = None
        for ids in self.decoded:
            if (best is None or len(ids) > len(best)) and \
                    self.text(ids).strip() == reply:
                best = ids
        if best is None:
            raise SystemExit(f"no decode call gives the reply {reply[:40]!r}")
        return best


def requests():
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    return [
        {"question": "Describe this image.", "images": [img(448, 448)]},
        {"question": "What differs between the two images?",
         "images": [img(448, 448), img(448, 448)]},
        {"question": "What happens in this video?",
         "images": [img(448, 448) for _ in range(8)], "is_video": True},
        {"question": "Write a short poem about the sea."},
    ]


def print_ptxas(log: str) -> None:
    """Each kernel's registers and spills from nvcc's -Xptxas -v lines (the
    entry's name, then its usage), and any wgmma serialization warning."""
    entry = None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "wgmma" in line:
            print(f"  ptxas: {line.strip()}")
        elif "spill" in line and entry:
            print(f"  ptxas: {entry}: {line.split(':', 1)[-1].strip()}")
        elif "registers" in line and entry:
            print(f"  ptxas: {entry}: {line.split(':', 1)[-1].strip()}")


def attention_cases(pipe, reqs, gen):
    """The four flash-attention call shapes of the main path, with the
    packing metadata and lengths of the real request mix and random bf16
    q/k/v. Each case: (name, kwargs for flash_attention, [B, Tq] bool of
    the rows callers keep)."""
    from oryx_tpu_torch.ops.packing import round_up_bucket

    cfg = pipe.cfg
    _, packed, batch = pipe.pack_requests(reqs)
    dev = pipe.device
    B, T = batch.token_ids.shape
    S = round_up_bucket(T + MAX_NEW)
    lengths = torch.from_numpy(batch.lengths).to(dev).long()
    P, Q = packed.segment_ids.shape[0], packed.q_region_ids.shape[0]
    hv, dv = cfg.vision.num_heads, cfg.vision.head_dim
    hq, hk, d = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    print(f"  main-path shapes: {packed.num_patches} patches in a {P} "
          f"bucket, {packed.num_queries} queries in a {Q} bucket, rows "
          f"{batch.lengths.tolist()} in a {T} bucket, cache {S} slots")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    seg = torch.from_numpy(packed.segment_ids).to(dev)[None]
    reg = torch.from_numpy(packed.region_ids).to(dev)[None]
    qreg = torch.from_numpy(packed.q_region_ids).to(dev)[None]
    slots = torch.arange(S, device=dev)[None]
    dec_pos = lengths[:, None] + MAX_NEW // 2
    return [
        ("vit", dict(q=rnd(1, P, hv, dv), k=rnd(1, P, hv, dv),
                     v=rnd(1, P, hv, dv), causal=False,
                     q_segment_ids=seg, kv_segment_ids=seg), seg > 0),
        ("compressor", dict(q=rnd(1, Q, hv, dv), k=rnd(1, P, hv, dv),
                            v=rnd(1, P, hv, dv), causal=False,
                            q_segment_ids=qreg, kv_segment_ids=reg),
         qreg > 0),
        ("prefill", dict(q=rnd(B, T, hq, d), k=rnd(B, S, hk, d),
                         v=rnd(B, S, hk, d), causal=True,
                         q_positions=torch.arange(T, device=dev).expand(B, T),
                         kv_mask=(slots < lengths[:, None]).int()),
         torch.arange(T, device=dev)[None] < lengths[:, None]),
        ("decode", dict(q=rnd(B, 1, hq, d), k=rnd(B, S, hk, d),
                        v=rnd(B, S, hk, d), causal=True,
                        q_positions=dec_pos,
                        kv_mask=(slots <= dec_pos).int()),
         torch.ones((B, 1), dtype=torch.bool, device=dev)),
    ]


def check_kernel_case(name, kw, keep):
    """Kernel vs plain twin on one call shape; returns the table row."""
    from oryx_tpu_torch.ops.cuda.measure import (
        PEAK_BYTES, PEAK_FLOPS, cuda_time_ms, device_ms,
    )
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    args, flags = fa._prepare(
        q, k, v, rest.get("q_positions"), None, rest.get("q_segment_ids"),
        rest.get("kv_segment_ids"), rest.get("kv_mask"), rest["causal"],
        None,
    )
    decode = sum(fa.LAUNCHES_DECODE.values())
    got = fa.flash_attention(q, k, v, **rest)
    route = ("split-KV decode" if sum(fa.LAUNCHES_DECODE.values()) > decode
             else "wgmma/TMA body over the cell map")
    ref = fa._mha_forward_reference(*args, **flags).transpose(1, 2)
    wit = fa._mha_forward_reference(*(x.float() for x in args[:3]),
                                    *args[3:], **flags).transpose(1, 2)
    torch.cuda.synchronize()
    g, r, w = got[keep].float(), ref[keep].float(), wit[keep]
    err = (g - r).abs()
    max_err = float(err.max())
    ek, ep = _rel(g, w), _rel(r, w)
    ok = bool((err <= TOL + TOL * r.abs()).all()) and bool(
        torch.isfinite(g).all()
    )
    print(f"  {name} [{route}]: q {tuple(q.shape)} k {tuple(k.shape)} "
          f"max_abs_err={max_err:.3e} ok={ok}; rel L2 vs fp32 witness "
          f"kernel {ek:.3e} plain {ep:.3e} (ratio {ek / ep:.3f}, limit "
          f"{NOISE_RATIO})")
    if not ok:
        raise SystemExit(f"kernel disagrees with its plain twin on {name}")
    if ek > NOISE_RATIO * ep:
        raise SystemExit(f"K1 on {name} is further from the fp32 witness "
                         "than bf16 noise allows")

    ms = cuda_time_ms(lambda: fa._mha_forward(*args, **flags), iters=20)
    dev_t = device_ms(lambda: fa._mha_forward(*args, **flags))
    plain_ms = cuda_time_ms(
        lambda: fa._mha_forward_reference(*args, **flags), iters=3, warmup=1
    )
    # SDPA yardstick: the same masked function with an explicit boolean
    # mask, k/v repeated to the q heads outside the timed call.
    qp, kp, vp, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    B, Hq, Tq, D = qp.shape
    G = Hq // kp.shape[1]
    mask = kv_valid[:, None, :] > 0
    if flags["causal"]:
        mask = mask & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        mask = mask & (q_seg[:, :, None] == kv_seg[:, None, :])
    kr = kp.repeat_interleave(G, dim=1)
    vr = vp.repeat_interleave(G, dim=1)
    m4 = mask[:, None]
    library_ms = cuda_time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qp, kr, vr, attn_mask=m4, scale=flags["scale"]
        ),
        iters=10,
    )
    # Least time: what this run's data needs - q, o and the int arrays once,
    # k and v only at kv rows some query can see - vs 4 * D flops per
    # unmasked (q, kv) pair per q head.
    pairs = int(mask.sum())
    flops = 4.0 * D * Hq * pairs
    kv_rows = int(mask.any(dim=1).sum())  # over batch rows
    nbytes = (
        2 * qp.numel() * qp.element_size()
        + 2 * kv_rows * kp.shape[1] * D * kp.element_size()
        + sum(x.numel() * 4 for x in (q_pos, kv_pos, q_seg, kv_seg, kv_valid))
    )
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    print(f"    kernel {ms:.4f} ms (device {dev_t}) | plain "
          f"{plain_ms:.4f} ms | sdpa {library_ms:.4f} ms | bound "
          f"{max(t_ops, t_bytes):.4f} ms (unmasked pairs {pairs}, "
          f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB)")
    key = (flags["causal"], flags["has_segments"], B, Hq, kp.shape[1], Tq,
           kp.shape[2], D)
    return key, {
        "name": f"flash_fwd[{name}]",
        "route": "cuda",
        "source": "oryx_tpu_torch/csrc/flash_attention.cu",
        "replaces": "oryx_tpu/ops/pallas/flash_attention.py:206",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev_t.ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": library_ms,
    }


def run_main_path(pipe, reqs, tok):
    """One chat_batch on the mix; returns (replies, counts, timings,
    tokens, launches, seconds, peak bytes, decode-route launches)."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timings: dict = {}
    tok.decoded.clear()
    fa.LAUNCHES.clear()
    fa.LAUNCHES_DECODE.clear()
    t0 = time.perf_counter()
    replies, counts = pipe.chat_batch(
        reqs, max_new_tokens=MAX_NEW, return_token_counts=True,
        timings=timings,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    return (replies, counts, timings, [list(t) for t in tok.decoded],
            launches, wall, torch.cuda.max_memory_allocated(),
            dict(fa.LAUNCHES_DECODE))


def prefill_logits(pipe, reqs):
    """Last-token logits [B, V] of the mix's prefill, through the same
    encode, splice and prefill functions chat_batch runs."""
    from oryx_tpu_torch.models import generate, oryx
    from oryx_tpu_torch.ops.packing import round_up_bucket

    _, packed, batch = pipe.pack_requests(reqs)
    cfg = pipe.cfg
    T = batch.token_ids.shape[1]
    with torch.inference_mode():
        arrays = oryx.stage_mm_arrays(packed, batch, pipe.device)
        embeds = oryx.mm_embeds(pipe.params, cfg, arrays)
        logits, _ = generate.prefill(
            pipe.params.llm, cfg.llm, embeds, arrays["lengths"],
            cache_len=round_up_bucket(T + MAX_NEW), attn_impl=cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(cfg),
        )
    return logits.float()


# ---- the decode graphs, streaming and sessions (phases 3, 5, 14) -----------

SESSION_QS = ("Describe this image.", "What colour dominates it?",
              "Is anything in it moving?")
SCORE_OPTIONS = (" a cat", " a dog", " an owl", " a fox")
LL_TOL = 0.1  # score vs full forward, bf16: absolute, per option token


def eager_generate(pipe, embeds, lengths, cache_len, gen_cfg=None,
                   generator=None):
    """The eager witness of the graph route: generate's prefill, then
    `_decode_while` with no graph (every step's kernels launched one by
    one), MAX_NEW steps with the pipe's stop sequences. Returns (tokens
    [B, MAX_NEW], finished flags [B, MAX_NEW], decode seconds, steps, K1
    decode launches)."""
    from oryx_tpu_torch.models import generate, oryx, qwen2
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    cfg = pipe.cfg
    gen_cfg = gen_cfg or cfg.generation
    dt = oryx.compute_dtype(cfg)
    llm = pipe.params.llm
    stop = pipe.stop_sequences.to(pipe.device)
    with torch.inference_mode():
        cache = qwen2.init_kv_cache(cfg.llm, embeds.shape[0], cache_len,
                                    dtype=dt, device=pipe.device)
        carry = generate._prefill_carry(
            llm, cfg.llm, gen_cfg, embeds, lengths, generator, cache=cache,
            start=None, attn_impl=cfg.attn_impl, compute_dtype=dt,
            stop_L=stop.shape[1])
        step = generate._make_decode_step(
            llm, cfg.llm, gen_cfg, stop, cache_len=cache_len,
            attn_impl=cfg.attn_impl, compute_dtype=dt, generator=generator)
        torch.cuda.synchronize()
        fa.LAUNCHES_DECODE.clear()
        t0 = time.perf_counter()
        _, toks, fin, steps = generate._decode_while(
            step, carry, MAX_NEW, gen_cfg.eos_token_id)
        torch.cuda.synchronize()
    return (toks, fin, time.perf_counter() - t0, steps,
            sum(fa.LAUNCHES_DECODE.values()))


def mix_embeds(pipe, reqs):
    """The mix's decoder inputs as chat_batch builds them: (embeds, lengths,
    cache_len)."""
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.packing import round_up_bucket

    _, packed, batch = pipe.pack_requests(reqs)
    arrays = oryx.stage_mm_arrays(packed, batch, pipe.device)
    embeds = oryx.mm_embeds(pipe.params, pipe.cfg, arrays)
    return (embeds, arrays["lengths"],
            round_up_bucket(batch.token_ids.shape[1] + MAX_NEW))


def row_tokens(toks, fin):
    """Per row: the tokens up to and including the finishing one, trailing
    EOS dropped (what chat_batch decodes)."""
    out = []
    for t, f in zip(toks.tolist(), fin.tolist()):
        n = f.index(True) + 1 if True in f else len(t)
        t = t[:n]
        while t and t[-1] == EOS:
            t.pop()
        out.append(t)
    return out


def graph_decode_ms(kw) -> float:
    """Event ms of one K1 decode call replayed inside a CUDA graph of 20
    calls (the route the decode loop takes), per call."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import graphs
    from oryx_tpu_torch.ops.cuda.measure import cuda_time_ms

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    fa.flash_attention(q, k, v, **rest)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = graphs.CountedGraph()
    launches = [collections.Counter(c) for c in graphs.counters()]
    with graph.capture(stream):
        for _ in range(20):
            fa.flash_attention(q, k, v, **rest)
    ms = cuda_time_ms(graph.graph.replay, iters=10) / 20
    for c, before in zip(graphs.counters(), launches):  # timing, not a path
        c.clear()
        c.update(before)
    return ms


def k1_window():
    """Zero K1's counters; returns a function giving the launches since."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    fa.LAUNCHES.clear()
    return lambda: dict(fa.LAUNCHES)


def prefix_case(name, start, total, tq, cache_len, keep_rows, gen):
    """Random bf16 q/k/v at one of K1's prefix-reuse call shapes: a
    `tq`-row bucket with q positions from `start` over a `cache_len`-slot
    cache whose first `total` slots are valid. Returns (name, kwargs,
    [1, tq] rows kept)."""
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    slots = torch.arange(cache_len, device=dev)[None]
    return (name, dict(
        q=rnd(1, tq, 28, 128), k=rnd(1, cache_len, 4, 128),
        v=rnd(1, cache_len, 4, 128), causal=True,
        q_positions=(start + torch.arange(tq, device=dev))[None],
        kv_mask=(slots < total).int()),
        torch.arange(tq, device=dev)[None] < keep_rows)


def shared_prefix(ids, flat) -> int:
    """The prefix of a prompt's flat stream a cached state's ids serve, as
    `Pipeline._prefix_plan` finds it (at least one token left over)."""
    m = min(len(ids), len(flat) - 1)
    neq = flat[:m] != ids[:m]
    return int(np.argmax(neq)) if neq.any() else m


def session_turns(pipe, img, cache: bool):
    """SESSION_QS through one ChatSession over the image, MAX_NEW tokens a
    turn. Returns (replies, TTFTs in s: the ask's wall less its decode and
    any graph capture, K1 launches of turns 2-3, the state after each
    turn)."""
    from oryx_tpu_torch.serve.pipeline import ChatSession

    s = ChatSession(pipe, images=[img], cache=cache)
    replies, ttft, later, states = [], [], {}, []
    for i, q in enumerate(SESSION_QS):
        window = k1_window()
        t: dict = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replies.append(s.ask(q, max_new_tokens=MAX_NEW, timings=t))
        ttft.append(time.perf_counter() - t0 - t["decode_s"]
                    - t["capture_s"])
        if i:
            for key, n in window().items():
                later[key] = later.get(key, 0) + n
        states.append(s._cache_state)
    return replies, ttft, later, states


def stream_and_sessions(pipe, pipe_f32, card) -> list[dict]:
    """Phase 14 (see the module docstring). Returns the kernel rows of K1's
    two prefix-reuse call shapes."""
    from oryx_tpu_torch.models import generate, oryx, qwen2
    from oryx_tpu_torch.ops.packing import round_up_bucket
    from oryx_tpu_torch.serve.pipeline import ChatSession
    from oryx_tpu_torch.serve.prefix_cache import SessionPrefixCache

    req = requests()[0]
    q0, img = req["question"], req["images"][0]
    cfg = pipe.cfg

    # a. chat_stream == chat.
    ref = pipe.chat(q0, images=[img], max_new_tokens=MAX_NEW)
    t0 = time.perf_counter()
    deltas, first = [], None
    for d in pipe.chat_stream(q0, images=[img], max_new_tokens=MAX_NEW,
                              chunk=8):
        first = first or time.perf_counter() - t0
        deltas.append(d)
    print(f"  chat_stream: {len(deltas)} deltas, first after {first:.3f} s, "
          f"all after {time.perf_counter() - t0:.3f} s; joined == chat(): "
          f"{''.join(deltas) == ref} ({ref[:40]!r})")
    if "".join(deltas) != ref:
        raise SystemExit("chat_stream's deltas do not join to chat()")

    # b. Seeded sampling through the graphs.
    ids, imgs, fac, caps = pipe._prepare_request(req)
    embeds, L = pipe._prompt_embeds(cfg, ids, imgs, fac, caps)
    cache_len = round_up_bucket(embeds.shape[1] + MAX_NEW)
    hot = dataclasses.replace(cfg.generation, temperature=0.7)
    kw = dict(inputs_embeds=embeds,
              lengths=torch.tensor([L], dtype=torch.int32, device="cuda"),
              max_new_tokens=MAX_NEW, cache_len=cache_len,
              attn_impl=cfg.attn_impl, compute_dtype=oryx.compute_dtype(cfg),
              stop_sequences=pipe.stop_sequences)

    def gen():
        return torch.Generator("cuda").manual_seed(3)

    llm = pipe.params.llm
    runs = [generate.generate(llm, cfg.llm, hot, generator=gen(), **kw)[0]
            for _ in range(2)]
    blocks = list(generate.generate_stream(llm, cfg.llm, hot,
                                           generator=gen(), chunk=8, **kw))
    streamed = np.concatenate(blocks, axis=1)
    eager, *_ = eager_generate(pipe, embeds, kw["lengths"], cache_len, hot,
                               gen())
    sampled = runs[0].cpu().numpy()
    ok = (torch.equal(runs[0], runs[1]) and torch.equal(runs[0], eager)
          and np.array_equal(streamed, sampled[:, :streamed.shape[1]])
          and len({b.tobytes() for b in blocks}) == len(blocks))
    print(f"  sampled (temperature 0.7, seed 3): two generate runs equal "
          f"{torch.equal(runs[0], runs[1])}, == eager witness "
          f"{torch.equal(runs[0], eager)}, generate_stream "
          f"{len(blocks)} blocks == generate "
          f"{np.array_equal(streamed, sampled[:, :streamed.shape[1]])}, "
          f"blocks all differ {len({b.tobytes() for b in blocks}) == len(blocks)}"
          f"; first tokens {sampled[0, :8].tolist()}")
    if not ok:
        raise SystemExit("seeded sampling through the decode graphs is off")

    # c. Three turns of a ChatSession over the image, cached and not.
    rows = []
    for label, p in (("bf16", pipe), ("fp32 compute", pipe_f32)):
        cached, tc, later, states = session_turns(p, img, True)
        state = states[-1]
        plain, tp, _, _ = session_turns(p, img, False)
        same = [a == b for a, b in zip(cached, plain)]
        print(f"  ChatSession {label}: replies cached == uncached {same}; "
              f"TTFT cached {[f'{x:.4f}' for x in tc]} s vs uncached "
              f"{[f'{x:.4f}' for x in tp]} s; cache {state.cache_len} "
              f"slots, {len(state.ids)} ids")
        # Turns 2-3 prefilled their text suffix only: no ViT call
        # (D = 72), and every multi-row K1 call is the bucket of a turn's
        # suffix (the earlier reply re-tokenized and the new question).
        plans = [(shared_prefix(a.ids, b.prompt_flat), len(b.prompt_flat))
                 for a, b in zip(states, states[1:])]
        buckets = {round_up_bucket(n - c) for c, n in plans}
        full = [k for k in later
                if k[7] == 72 or (k[5] > 1 and k[5] not in buckets)]
        print(f"    turns 2-3 prefilled rows {plans} (suffix buckets "
              f"{sorted(buckets)}); K1 calls {later}")
        if full or not later:
            raise SystemExit(f"a cached turn re-ran a full prefill: {full}")
        if label == "bf16":
            common, L3 = plans[-1]
            suffix = max((k for k in later
                          if k[5] == round_up_bucket(L3 - common)),
                         key=lambda k: later[k])
            suffix_launches = later[suffix]
        elif not all(same):
            raise SystemExit("cached and uncached sessions disagree (fp32)")

    # d. Sessions over one shared context through one SessionPrefixCache:
    # the first cold, the next two seeded from it.
    shared = SessionPrefixCache()
    ctx = shared_context()
    ChatSession(pipe, shared=shared).ask(ctx + "How strong was the wind?",
                                         max_new_tokens=MAX_NEW)
    for q in ("How many boats went out?", "What colour was the water?"):
        ids = pipe._prepare_request({"question": ctx + q})[0]
        hit = shared.lookup(np.asarray(ids, np.int64))
        window = k1_window()
        warm: dict = {}
        ChatSession(pipe, shared=shared).ask(
            ctx + q, max_new_tokens=MAX_NEW, timings=warm)
        tq = sorted({k[5] for k in window() if k[5] > 1})
        cold: dict = {}
        pipe.chat(ctx + q, max_new_tokens=MAX_NEW, timings=cold)
        print(f"  SessionPrefixCache: a new session over the shared context "
              f"hit {hit is not None} ({shared.entries} entries); its "
              f"prefill Tq {tq} over a {len(ids)}-token prompt; prefill "
              f"{warm['prefill_s']:.4f} s vs cold {cold['prefill_s']:.4f} s")
        if hit is None or tq != [256]:
            raise SystemExit("a session did not reuse the shared context")

    # e. score_options vs a teacher-forced full forward.
    window = k1_window()
    scores = pipe.score_options(q0, list(SCORE_OPTIONS), images=[img])
    score_launches = window()
    full = []
    with torch.inference_mode():
        for o in SCORE_OPTIONS:
            o_ids = torch.tensor(pipe.tokenizer.encode(o), device="cuda")
            x = torch.cat([embeds[:, :L], llm.embed.weight[o_ids][None]], 1)
            T = x.shape[1]
            logits, _ = qwen2.forward(
                llm, cfg.llm, inputs_embeds=x,
                kv_mask=torch.ones((1, T), dtype=torch.int32, device="cuda"),
                attn_impl=cfg.attn_impl,
                compute_dtype=oryx.compute_dtype(cfg))
            lp = torch.log_softmax(logits[0, L - 1:T - 1], -1)
            full.append(float(lp[torch.arange(len(o_ids)), o_ids].sum()))
    diff = [abs(a - b) for a, b in zip(scores, full)]
    ok = (int(np.argmax(scores)) == int(np.argmax(full))
          and all(d <= LL_TOL * len(o) for d, o in zip(diff, SCORE_OPTIONS)))
    print(f"  score_options {list(SCORE_OPTIONS)}: {np.round(scores, 4)} vs "
          f"full forward {np.round(full, 4)}; |diff| "
          f"{[f'{d:.4f}' for d in diff]} (limit {LL_TOL} a token), argmax "
          f"{int(np.argmax(scores))} vs {int(np.argmax(full))}")
    if not ok:
        raise SystemExit("score_options disagrees with the full forward")

    # f. K1 at the two new call shapes, against its plain twin.
    gen_k = torch.Generator("cuda").manual_seed(5)
    score_key = max((k for k in score_launches if k[5] == 256),
                    key=lambda k: score_launches[k])
    k0 = len(pipe.tokenizer.encode(SCORE_OPTIONS[0]))
    print(f"  K1 call shapes: suffix prefill rows [{common}, {L3}) in a "
          f"{suffix[5]}-row bucket over a {suffix[6]}-slot cache; score "
          f"rows [{L}, {L + k0}) in a 256-row bucket over a "
          f"{score_key[6]}-slot cache")
    out = []
    for (name, kwk, keep), n in (
        (prefix_case("suffix_prefill", common, L3, suffix[5], suffix[6],
                     L3 - common, gen_k), suffix_launches),
        (prefix_case("score", L, L + k0, 256, score_key[6], k0, gen_k),
         score_launches[score_key]),
    ):
        key, row = check_kernel_case(name, kwk, keep)
        row["launches"] = n
        print(f"  launches {row['name']}: {n}")
        if n == 0:
            raise SystemExit(f"{row['name']} was never launched")
        out.append(row)
    return out


def kernel_family(name: str) -> str:
    n = name.lower()
    if "flash_fwd" in n or "flash_decode" in n:
        return "flash_fwd K1 (hand-written attention forward)"
    if "tile_map" in n:
        return "tile_map (K1/K5 cell map)"
    if "flash_bwd" in n:
        return "flash_bwd K5a/K5b (hand-written attention backward)"
    if any(s in n for s in ("paged_split", "paged_merge", "paged_f32")):
        return "paged attention K3/K4 (hand-written)"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                            "sm90_", "sm80_")):
        return "GEMM/GEMV (cuBLAS: F.linear, torch.matmul)"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    if "reduce" in n:
        return "reductions"
    if "index" in n or "gather" in n or "scatter" in n:
        return "indexing"
    return "other"


HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")


def profile_call(fn):
    """fn() under torch.profiler, CUDA activity only: device time by kernel
    family, the top kernels, and the device's idle share inside the trace.
    Raises when the trace holds no device time. Returns (device us by
    family, the call's wall us, the runtime's launch calls by name)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    if not kernels:
        raise SystemExit("the profiler recorded no device time")
    by_family: collections.Counter = collections.Counter()
    by_name: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    spans = []
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_family[kernel_family(e.name)] += us
        by_name[e.name] += us
        count[e.name] += 1
        spans.append((e.time_range.start, e.time_range.end))
    # Busy time: the union of the kernel intervals (streams may overlap).
    busy, end = 0.0, None
    for s, t in sorted(spans):
        if end is None or s > end:
            busy += t - s
            end = t
        elif t > end:
            busy += t - end
            end = t
    dev_us = sum(by_family.values())
    # The runtime's launch calls (CUPTI records them beside the kernels): a
    # CUDA graph's replay is one call for all its kernels.
    calls = collections.Counter(
        e.name for e in prof.events() if e.name in HOST_LAUNCHES)
    print(f"  host launch calls: {dict(calls) or 'not recorded'}")
    print(f"  profiled wall {wall_us / 1e3:.1f} ms; {len(kernels)} kernel "
          f"launches, kernel time {dev_us / 1e3:.1f} ms, busy (union) "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.1%} of the wall: idle "
          f"share {1 - busy / wall_us:.1%}")
    print("  device time by family:")
    for fam, us in by_family.most_common():
        print(f"    {fam:44s} {us / 1e3:10.2f} ms  {us / dev_us:6.1%}")
    print("  top kernels by device time:")
    for name, us in by_name.most_common(12):
        print(f"    {us / 1e3:10.2f} ms  x{count[name]:<6d} {name[:90]}")
    return by_family, wall_us, calls


# ---- serving engine (phases 6-8) -------------------------------------------

SERVE = dict(num_slots=4, page_size=64, chunk=8, max_ctx=4096)
PREFILL_CHUNK = 512  # ragged engine: pf_width = 512 / 8 = 64 lanes


def serve_requests():
    """(request, max_new) x 8: the chat_batch mix at MAX_NEW tokens plus
    four text requests of other lengths, so slots free and admit at chunk
    boundaries."""
    texts = [("Name three colours.", 8), ("Count to ten.", 16),
             ("What is a paged KV cache?", 24),
             ("Tell me a long story about a lighthouse keeper.", 48)]
    return [(r, MAX_NEW) for r in requests()] + [
        ({"question": q}, n) for q, n in texts
    ]


def _plane_ptr(plane) -> int:
    """Address of a pool plane's values or codes (dense or QuantPages)."""
    return getattr(plane, "q", plane).data_ptr()


class PagedCallRecorder:
    """While active, keeps q's layout (shape and strides) and the int
    operands, as given, of every paged-kernel call made on layer 0 of
    `sched`'s pool (one call per forward), cloned on the device without a
    sync, for phase 6 to replay through the same wrappers."""

    def __init__(self, sched):
        self.layer0 = _plane_ptr(sched.kv_pages["k"][0])
        self.calls: dict[str, list] = {"paged_decode": [], "ragged_paged": []}

    def __enter__(self):
        from oryx_tpu_torch.ops.cuda import paged_attention as pa

        self._orig = (pa.ragged_decode_attention, pa.ragged_paged_attention)
        dec, rag = self._orig

        def rec_dec(q, k, v, bt, lens, **kw):
            if _plane_ptr(k) == self.layer0:
                self.calls["paged_decode"].append(
                    ((tuple(q.shape), q.stride()), bt.clone(), lens.clone())
                )
            return dec(q, k, v, bt, lens, **kw)

        def rec_rag(q, k, v, bt, seg, pos, **kw):
            if _plane_ptr(k) == self.layer0:
                self.calls["ragged_paged"].append(
                    ((tuple(q.shape), q.stride()), bt.clone(), seg.clone(),
                     pos.clone())
                )
            return rag(q, k, v, bt, seg, pos, **kw)

        pa.ragged_decode_attention = rec_dec
        pa.ragged_paged_attention = rec_rag
        return self

    def __exit__(self, *exc):
        from oryx_tpu_torch.ops.cuda import paged_attention as pa

        pa.ragged_decode_attention, pa.ragged_paged_attention = self._orig
        return False


def engine_counts(sched) -> dict:
    """An engine's counters as one dict, read after its run: its
    ServingMetrics (unlabeled families by name, `dispatches_total` by kind,
    the accepted-tokens histogram's sum and count, the raw-named host-tier
    counters) and its port-only `engine_stats`."""
    m = sched.metrics
    out = {name: m.get(name) for name in (
        "admitted", "completed", "evicted", "cancelled", "chunks",
        "prefill_tokens_total", "prefix_cache_hit_tokens_total",
        "prefix_cache_miss_tokens_total", "prefix_cache_evicted_pages_total",
        "harvest_total", "draft_proposed_total", "draft_accepted_total",
        "decode_steps_total", "decode_steps_useful", "decode_steps_wasted")}
    for name in ("oryx_cache_reload_hit_total",
                 "oryx_cache_reload_upload_total"):
        out[name] = m.registry.get(name, raw_name=True)
    out["dispatches_total"] = m.by_label("dispatches_total")
    (out["accepted_tokens_per_step_count"],
     out["accepted_tokens_per_step_sum"]) = m.histogram_totals(
        "accepted_tokens_per_step")
    out.update(sched.engine_stats)
    return out


def run_scheduler(pipe, ragged: bool, record: bool, *, eager: bool = False,
                  reqs=None, **kw):
    """One scheduler run over `reqs` (serve_requests() by default), `kw`
    passed to the engine; eager: the eager witness (graphs.routes(False):
    a ragged engine's pure-decode dispatches launched one by one instead of
    replayed as graphs). Returns a dict of what it served, what it cost and
    which kernels it launched (counts zeroed just before the run and read just
    after), with the tail wall after the last admission."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import graphs
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(
        pipe, autostart=False, ragged=ragged,
        prefill_chunk=PREFILL_CHUNK if ragged else None, **SERVE, **kw,
    )
    reqs = reqs or serve_requests()
    recorder = PagedCallRecorder(sched) if record else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext(), graphs.routes(not eager):
        handles = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        results = [h.result(timeout=600) for h in handles]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sched.close()
    sched.check_pool_invariant()
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    return {
        "results": results, "caps": [n for _, n in reqs], "wall": wall,
        "ttft": [h.debug["ttft_s"] for h in handles],
        "cached": [h.debug["cached_tokens"] for h in handles],
        "metrics": engine_counts(sched), "peak": torch.cuda.max_memory_allocated(),
        "flash": dict(fa.LAUNCHES), "paged": dict(paged),
        "paged_keys": dict(pa.LAUNCHES), "recorder": recorder,
        # After the last activation every dispatch is pure decode.
        "tail": max(h.debug["e2e_s"] for h in handles)
        - max(h.debug["ttft_s"] for h in handles),
        "tail_steps": max(h.debug["finish_chunk"] for h in handles)
        - max(h.debug["admit_chunk"] for h in handles),
    }


def check_serving_run(mode: str, i: int, run: dict, code: str = "") -> None:
    """Print one phase-7 (or phase-12) run and fail on a request without its
    usage or a missing kernel launch; `code` is the kernel name suffix of a
    quantized pool ("_int8")."""
    m = run["metrics"]
    gen = sum(u[1] for _, _, u in run["results"])
    print(f"  {mode} run {i}: wall {run['wall']:.3f} s | {gen} tokens, "
          f"{gen / run['wall']:.1f} tok/s | dispatches "
          f"{dict(m['dispatches_total'])} | evicted {m['evicted']} | peak "
          f"{run['peak'] / 1e9:.2f} GB | paged launches {run['paged']} | "
          f"flash launches {sum(run['flash'].values())} | engine-step "
          f"graphs captured {m['graph_captures_total']} in "
          f"{m['graph_capture_s']:.3f} s")
    print(f"    TTFT s: {[round(t, 4) for t in run['ttft']]}")
    print(f"    cached tokens: {run['cached']} (prefix cache hits "
          f"{m['prefix_cache_hit_tokens_total']}, misses "
          f"{m['prefix_cache_miss_tokens_total']})")
    for r, ((reply, reason, (pt, gt)), cap) in enumerate(
        zip(run["results"], run["caps"])
    ):
        print(f"    request {r}: prompt {pt}, generated {gt}/{cap} "
              f"({reason}), reply {reply[:32]!r}")
        if pt < 1 or not (
            gt == cap if reason == "length" else 1 <= gt <= cap
        ):
            raise SystemExit(f"{mode}: request {r} has usage {(pt, gt)}")
    want = ("ragged_paged" if mode == "ragged" else "paged_decode") + code
    other = ("paged_decode" if mode == "ragged" else "ragged_paged") + code
    if not run["paged"].get(want) or run["paged"].get(other):
        raise SystemExit(f"{mode}: paged kernel launches {run['paged']}")
    if not run["flash"]:
        raise SystemExit(f"{mode}: the flash kernel never launched")


def _pick(calls, work):
    """The recorded call with the most work (host reads after the run)."""
    if not calls:
        raise SystemExit("the recorded run made no call of this kind")
    return max(calls, key=work)


def paged_kernel_case(name, kind, call, pool_shape, gen, fmt=None):
    """Kernel vs plain twin at one recorded call, both through the public
    functions the model calls, on q in the recorded layout and the int
    operands as the model passed them, over a bf16 pool or (fmt) an int8 /
    fp8 one; returns the table row."""
    from oryx_tpu_torch.ops.cuda.measure import (
        cuda_time_ms, device_ms, paged_bound, paged_pool_layer,
    )
    from oryx_tpu_torch.ops import paged_kv
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    P, ps, Hk, D = pool_shape
    (q_shape, q_stride), bt = call[0], call[1]
    R, Hq = q_shape[0], q_shape[-2]
    dev = bt.device
    kp = paged_pool_layer(pool_shape, gen, fmt)
    vp = paged_pool_layer(pool_shape, gen, fmt)
    q = torch.empty_strided(q_shape, q_stride, dtype=torch.bfloat16,
                            device=dev)
    q.copy_(torch.randn(q_shape, generator=gen, device=dev))
    S, maxp = bt.shape
    if kind == "paged_decode":
        lens = call[2]
        seg = torch.arange(R, device=dev)
        visible = lens.long()
        kernel = lambda: pa.ragged_decode_attention(  # noqa: E731
            q, kp, vp, bt, lens)
        plain = lambda: paged_kv.ragged_decode_attention(  # noqa: E731
            q, kp, vp, bt, lens)
    else:
        seg, pos = call[2], call[3]
        visible = pos.long() + 1
        kernel = lambda: pa.ragged_paged_attention(  # noqa: E731
            q, kp, vp, bt, seg, pos)
        plain = lambda: paged_kv.ragged_paged_attention(  # noqa: E731
            q, kp, vp, bt, seg, pos)
    before = sum(pa.LAUNCHES.values())
    got, ref = kernel(), plain()
    again = kernel()
    torch.cuda.synchronize()
    if sum(pa.LAUNCHES.values()) != before + 2:
        raise SystemExit(f"{name}: the wrapper did not launch the kernel")
    if not torch.equal(got, again):
        raise SystemExit(f"{name}: two calls gave different bits")
    # The split plan: more than one split, and row tiles of 64 / G rows
    # where prefill lanes are packed behind the decode rows.
    G = Hq // Hk
    plan = pa.plan_of(kind, R, S, Hk, G, maxp, ps,
                      torch.cuda.get_device_properties(0).multi_processor_count)
    want_rt = 1 if kind == "paged_decode" or R <= S else pa.A_ROWS // G
    if plan["row_tile"] != want_rt or plan["splits"] < 2:
        raise SystemExit(f"{name}: plan {plan}, want row tile {want_rt} "
                         "and more than one split")
    if got.shape != q.shape or got.dtype != q.dtype:
        raise SystemExit(f"{name}: output {tuple(got.shape)} {got.dtype}")
    got, ref = got.reshape(R, Hq, D), ref.reshape(R, Hq, D)
    keep = visible > 0
    g, r = got[keep].float(), ref[keep].float()
    err = (g - r).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL + TOL * r.abs()).all()) and bool(
        torch.isfinite(g).all()
    )
    print(f"  {name}: q {tuple(q.shape)} stride {q_stride} pool "
          f"{tuple(kp.shape)} {fmt or 'bf16'} table {tuple(bt.shape)} "
          f"{bt.dtype}, ints "
          f"{(call[2].dtype)}, visible slots per row "
          f"{visible.min().item()}..{visible.max().item()} "
          f"max_abs_err={max_err:.3e} ok={ok}; plan: {plan['splits']} "
          f"splits of {plan['tps']} 64-slot tiles, row tile "
          f"{plan['row_tile']} rows after {plan['lead']} one-row tiles; two "
          "calls bitwise equal")
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain twin")
    ms = cuda_time_ms(kernel, iters=50)
    dev_t = device_ms(kernel)
    plain_ms = cuda_time_ms(plain, iters=5, warmup=1)
    # Yardstick, two PyTorch calls: gather the rows' pages, then SDPA with
    # an explicit boolean mask (GQA without repeating k/v).
    K = maxp * ps
    mask = (
        torch.arange(K, device=dev)[None, :] < visible[:, None]
    )[:, None, None, :]
    segl = seg.long().clamp(0, S - 1)

    def library():
        k = paged_kv.gather_pages(kp, bt)[segl].transpose(1, 2)
        v = paged_kv.gather_pages(vp, bt)[segl].transpose(1, 2)
        return torch.nn.functional.scaled_dot_product_attention(
            q.reshape(R, Hq, 1, D), k, v, attn_mask=mask, enable_gqa=True,
        )

    library_ms = cuda_time_ms(library, iters=10)
    bound, bound_by, kv_rows, flops, nbytes = paged_bound(
        q.numel(), Hq, D, Hk, bt.numel(), segl.tolist(), visible.tolist(),
        1 if kind == "paged_decode" else 2, fmt)
    print(f"    kernel {ms:.4f} ms (device {dev_t}) | plain "
          f"{plain_ms:.4f} ms | gather+sdpa "
          f"{library_ms:.4f} ms | bound {bound:.4f} ms "
          f"({kv_rows} kv rows read, {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)")
    if fmt is None:
        line = 144 if kind == "paged_decode" else 528
    else:  # the dequantizing branch of the page walk
        line = 106 if kind == "paged_decode" else 480
    return {
        "name": name,
        "route": "cuda",
        "source": "oryx_tpu_torch/csrc/paged_attention.cu",
        "replaces": f"oryx_tpu/ops/pallas/paged_attention.py:{line}",
        "launches": 0,
        "max_abs_err": max_err,
        "ms": ms,
        "device_ms": dev_t.ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def paged_prefill_case(pipe, prompt_len: int, gen, width=None):
    """The split engine's flash-kernel call for its longest prompt: the
    bucketed prompt (or `width` rows) against the gathered max_ctx-wide
    stream, kv-masked at the prompt length (the gather itself is random
    bf16)."""
    from oryx_tpu_torch.ops.packing import round_up_bucket

    cfg = pipe.cfg.llm
    dev = pipe.device
    T, K = width or round_up_bucket(prompt_len), SERVE["max_ctx"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    slots = torch.arange(K, device=dev)[None]
    return ("paged_prefill", dict(
        q=rnd(1, T, cfg.num_heads, cfg.head_dim),
        k=rnd(1, K, cfg.num_kv_heads, cfg.head_dim),
        v=rnd(1, K, cfg.num_kv_heads, cfg.head_dim), causal=True,
        q_positions=torch.arange(T, device=dev)[None],
        kv_mask=(slots < prompt_len).int(),
    ), torch.arange(T, device=dev)[None] < prompt_len)


# ---- the HTTP server (phase 19) --------------------------------------------

HTTP_SERVE = dict(num_slots=4, page_size=64, decode_chunk=8, max_ctx=4096,
                  ragged=True, prefill_chunk=PREFILL_CHUNK)


def http_get(url: str) -> tuple[int, str]:
    """(status, body) of a GET; an HTTP error status is a result."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.read().decode()


def encode_png(img: np.ndarray, filter_type: int | None = None) -> bytes:
    """HW or HWC uint8 (gray, gray + alpha, RGB or RGBA) -> 8-bit PNG bytes.
    `filter_type` 0-4 puts that filter on every scanline; None picks each
    scanline's filter by the least sum of its bytes read as signed, the
    heuristic of libpng and PIL. Written with zlib and numpy: the card's
    client needs no PIL."""
    import struct
    import zlib

    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    height, width, ch = img.shape
    cur = img.reshape(height, width * ch).astype(np.int16)
    up = np.concatenate([np.zeros_like(cur[:1]), cur[:-1]])
    left = np.pad(cur, ((0, 0), (ch, 0)))[:, :-ch]
    upleft = np.pad(up, ((0, 0), (ch, 0)))[:, :-ch]
    pa, pb, pc = abs(up - upleft), abs(left - upleft), abs(left + up
                                                           - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    cands = (np.stack([cur, cur - left, cur - up, cur - ((left + up) >> 1),
                       cur - paeth]) & 0xFF).astype(np.uint8)
    if filter_type is None:
        cost = abs(cands.view(np.int8).astype(np.int32)).sum(-1)
        choice = cost.argmin(0)
    else:
        choice = np.full(height, filter_type)
    rows = cands[choice, np.arange(height)]
    raw = np.concatenate([choice.astype(np.uint8)[:, None], rows], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))


def png_data_uri(img) -> str:
    """An 8-bit RGB PNG from `encode_png` as a data: URI."""
    import base64

    return "data:image/png;base64," + base64.b64encode(
        encode_png(img)).decode()


def http_requests():
    """Phase 7's mix without its video (the HTTP API carries image parts
    only): (OpenAI body, the engine's request dict, max_tokens)."""
    out = []
    for req, n in serve_requests():
        if req.get("is_video"):
            continue
        imgs = list(req.get("images", []))
        content = req["question"] if not imgs else (
            [{"type": "text", "text": req["question"]}]
            + [{"type": "image_url", "image_url": {"url": png_data_uri(i)}}
               for i in imgs])
        out.append((
            {"messages": [{"role": "user", "content": content}],
             "max_tokens": n},
            {"question": req["question"], "images": imgs,
             "is_video": False, "history": []}, n))
    return out


class HttpServer:
    """`build_server` on an ephemeral port, served from a thread, with a
    stdlib client."""

    def __init__(self, pipe, **kw):
        import threading

        from oryx_tpu_torch.serve import api_server

        self.srv = api_server.build_server(pipe, port=0, **kw)
        self.base = f"http://127.0.0.1:{self.srv.server_address[1]}"
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()

    def post(self, body, rid=None):
        """(status, headers, reply dict) with the wall and, when streamed,
        the first delta's time; a reply dict holds text, finish reason and
        usage (for a stream joined from its deltas and final chunks)."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base + "/v1/chat/completions",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **({"X-Request-Id": rid} if rid else {})})
        t0 = time.perf_counter()
        try:
            r = urllib.request.urlopen(req, timeout=600)
        except urllib.error.HTTPError as e:
            with e:
                return e.code, dict(e.headers), json.loads(e.read())
        with r:
            out = {"first_s": None}
            if not body.get("stream"):
                d = json.loads(r.read())
                out.update(text=d["choices"][0]["message"]["content"],
                           finish=d["choices"][0]["finish_reason"],
                           usage=(d["usage"]["prompt_tokens"],
                                  d["usage"]["completion_tokens"]),
                           cost=d.get("oryx", {}).get("cost"))
            else:
                deltas = []
                for line in r:
                    line = line.decode().strip()
                    if not line.startswith("data: {"):
                        continue
                    d = json.loads(line[6:])
                    if out["first_s"] is None:
                        out["first_s"] = time.perf_counter() - t0
                    if d.get("usage"):
                        out["usage"] = (d["usage"]["prompt_tokens"],
                                        d["usage"]["completion_tokens"])
                    for c in d["choices"]:
                        if c["finish_reason"]:
                            out["finish"] = c["finish_reason"]
                        deltas.append(c["delta"].get("content", ""))
                out["text"] = "".join(deltas)
            out["wall"] = time.perf_counter() - t0
            return r.status, dict(r.headers), out

    def get(self, path):
        return http_get(self.base + path)

    def close(self):
        if self.srv.scheduler is not None:
            self.srv.scheduler.close()
        if self.srv.supervisor is not None:
            self.srv.supervisor.stop()
        self.srv.shutdown()
        self.srv.server_close()


def _burst(server, bodies):
    """Every body posted at once, one thread each; the responses in order
    and the burst's wall."""
    import threading

    out = [None] * len(bodies)

    def one(i):
        out[i] = server.post(bodies[i], rid=f"burst-{i}-{time.monotonic_ns()}")

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out, time.perf_counter() - t0


def _launch_counts():
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    return sum(fa.LAUNCHES.values()), dict(paged)


def _zero_launches():
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    fa.LAUNCHES.clear()
    pa.LAUNCHES.clear()


def _quantiles(metrics_text, family, before):
    """(n, p50, p99) of the observations a histogram family gained since
    the scrape `before`."""
    from oryx_tpu_torch.utils.metrics import (
        histogram_quantile,
        parse_prom_histogram,
    )

    bounds, counts, total, _ = parse_prom_histogram(metrics_text, family)
    _, counts0, total0, _ = parse_prom_histogram(before, family)
    counts = [c - c0 for c, c0 in zip(counts, counts0)]
    total -= total0
    return (total, histogram_quantile(0.5, bounds, counts, total),
            histogram_quantile(0.99, bounds, counts, total))


def png_decode_times(reqs) -> float:
    """Median ms to decode one of the requests' PNG images as the server
    does (`media.decode_image`: PIL where installed) and through the
    port's own reader (`media.decode_png`, what a host without PIL runs),
    printed with the filters the PNGs' rows use; returns the first."""
    import base64
    import importlib.util
    import struct
    import zlib

    from oryx_tpu_torch.data import media

    filters = collections.Counter()
    times = {media.decode_image: [], media.decode_png: []}
    for body, req, _ in reqs:
        for part in body["messages"][0]["content"]:
            if not isinstance(part, dict) or part["type"] != "image_url":
                continue
            data = base64.b64decode(part["image_url"]["url"].split(",")[1])
            n = struct.unpack(">I", data[33:37])[0]  # the one IDAT
            h = req["images"][0].shape[0]
            raw = zlib.decompress(data[41:41 + n])
            filters.update(np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0]
                           .tolist())
            for fn, ts in times.items():
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn(data)
                    ts.append((time.perf_counter() - t0) * 1e3)
    med = {}
    for fn, ts in times.items():
        ts.sort()
        med[fn] = ts[len(ts) // 2]
        print(f"  PNG decode through {fn.__name__} of the requests' "
              f"{len(ts) // 3} images (448x448 RGB; rows by filter "
              f"None/Sub/Up/Average/Paeth {[filters[f] for f in range(5)]})"
              f": median {med[fn]:.1f} ms, from {ts[0]:.1f} to "
              f"{ts[-1]:.1f} ms an image")
    print(f"  PIL on this host: "
          f"{'yes' if importlib.util.find_spec('PIL') else 'no'}")
    return med[media.decode_image]


def _metric(text, name):
    import re

    m = re.search(rf"^oryx_serving_{name} (\S+)$", text, re.M)
    return float(m.group(1)) if m else 0.0


def http_serving(pipe, card) -> None:
    """Phase 19: the port's HTTP server over full-width oryx_7b."""
    import re

    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    reqs = http_requests()
    SPANS = {"queue_wait", "admission", "prompt_prep", "prefill",
             "decode_chunk", "emission"}

    # (a) the continuous ragged engine: sequential, in-process, burst.
    decode_ms = png_decode_times(reqs)
    server = HttpServer(pipe, engine="continuous", **HTTP_SERVE)
    sched = ContinuousScheduler(
        pipe, num_slots=HTTP_SERVE["num_slots"],
        page_size=HTTP_SERVE["page_size"], chunk=HTTP_SERVE["decode_chunk"],
        max_ctx=HTTP_SERVE["max_ctx"], ragged=True,
        prefill_chunk=PREFILL_CHUNK)
    # One request through each engine before timing, so neither side's
    # walls hold its engine's first use.
    warm_img = np.random.default_rng(1).integers(0, 256, (448, 448, 3),
                                                 dtype=np.uint8)
    server.post({"messages": [{"role": "user", "content": [
        {"type": "text", "text": "Warm up."},
        {"type": "image_url", "image_url": {"url": png_data_uri(warm_img)}}
    ]}], "max_tokens": 8})
    sched.submit({"question": "Warm up.", "images": [warm_img],
                  "is_video": False, "history": []}, 8).result(timeout=600)

    def in_process(req, n):
        t0 = time.perf_counter()
        h = sched.submit(req, n)
        reply, why, usage = h.result(timeout=600)
        return dict(text=reply, finish=why, usage=tuple(usage),
                    wall=time.perf_counter() - t0, ttft=h.debug["ttft_s"])

    got, want = [], []
    flash_n, paged_n = 0, collections.Counter()
    for i, (body, req, n) in enumerate(reqs):
        body = dict(body)
        if i % 2:  # every other request streamed
            body.update(stream=True, stream_options={"include_usage": True})
        if i % 2:  # the sides alternate which runs first
            want.append(in_process(req, n))
        _zero_launches()
        code, hdr, out = server.post(body, rid=f"seq-{i}")
        f, p = _launch_counts()
        flash_n += f
        paged_n.update(p)
        if code != 200 or hdr["X-Request-Id"] != f"seq-{i}":
            raise SystemExit(f"phase 19: sequential request {i}: {code}")
        got.append(out)
        if not i % 2:
            want.append(in_process(req, n))
    sched.close()
    print(f"  (a) continuous ragged engine {HTTP_SERVE}, {len(reqs)} "
          f"requests one at a time over HTTP, each beside the same request "
          f"to an in-process ContinuousScheduler, the side that runs first "
          f"alternating, after one warm-up request each ({card}): "
          f"K1 launches {flash_n}, paged launches {dict(paged_n)}")
    if not flash_n or not paged_n.get("ragged_paged") or \
            paged_n.get("paged_decode"):
        raise SystemExit(f"phase 19: launches K1 {flash_n}, paged {paged_n}")
    for i, (g, w) in enumerate(zip(got, want)):
        print(f"    request {i} ({'stream' if i % 2 else 'plain'}, "
              f"{'in-process' if i % 2 else 'HTTP'} first): HTTP "
              f"{g['wall']:.3f} s vs in-process {w['wall']:.3f} s"
              + (f", client first delta {g['first_s']:.3f} s (server TTFT "
                 f"in-process {w['ttft']:.3f} s)" if i % 2 else "")
              + f", usage {g['usage']}, {g['finish']}, {g['text'][:24]!r}")
        if (g["text"], g["finish"], tuple(g["usage"])) != \
                (w["text"], w["finish"], w["usage"]):
            raise SystemExit(f"phase 19: request {i} over HTTP differs from "
                             f"the in-process engine: {g} vs {w}")
    http_wall = sum(g["wall"] for g in got)
    proc_wall = sum(w["wall"] for w in want)
    toks = sum(w["usage"][1] for w in want)
    extra = [(g["wall"] - w["wall"]) * 1e3 for g, w in zip(got, want)]
    n_img = [len(r["images"]) for _, r, _ in reqs]
    print(f"  sequential replies, finish reasons and usage byte-equal to the "
          f"in-process ContinuousScheduler; walls HTTP {http_wall:.3f} s vs "
          f"in-process {proc_wall:.3f} s ({toks / http_wall:.1f} vs "
          f"{toks / proc_wall:.1f} tok/s); HTTP wall less in-process wall a "
          f"request (ms, images a request {n_img}): "
          f"{[round(x, 1) for x in extra]}, median "
          f"{sorted(extra)[len(extra) // 2]:+.1f} ms; PNG decode "
          f"{decode_ms:.1f} ms an image of these")
    _, before = server.get("/metrics")
    _zero_launches()
    outs, burst_wall = _burst(server, [b for b, _, _ in reqs])
    flash_b, paged_b = _launch_counts()
    codes = [o[0] for o in outs]
    if codes != [200] * len(reqs):
        raise SystemExit(f"phase 19: burst status codes {codes}")
    btoks = sum(o[2]["usage"][1] for o in outs)
    status, text = server.get("/metrics")
    admitted, completed = _metric(text, "admitted"), _metric(text,
                                                               "completed")
    kinds = {m.group(1): float(m.group(2)) for m in re.finditer(
        r'^oryx_serving_dispatches_total\{kind="(\w+)"\} (\S+)$', text,
        re.M)}
    chunks = _metric(text, "chunks")
    total, p50, p99 = _quantiles(text, "oryx_serving_ttft_seconds", before)
    print(f"  burst of {len(reqs)} concurrent requests: wall "
          f"{burst_wall:.3f} s, {btoks} tokens, {btoks / burst_wall:.1f} "
          f"tok/s; K1 launches {flash_b}, paged {paged_b}; admitted "
          f"{admitted:g} completed {completed:g}, dispatches {kinds} sum "
          f"{sum(kinds.values()):g} == chunks {chunks:g}; server TTFT of "
          f"the burst's n={total} requests (the histogram's counts after "
          f"the burst less those before it, histogram_quantile) p50 "
          f"{p50:.4f} s p99 {p99:.4f} s")
    n_all = 2 * len(reqs) + 1  # the sequential run, the burst, the warm-up
    if not (admitted == completed == n_all) or \
            sum(kinds.values()) != chunks or total != len(reqs):
        raise SystemExit("phase 19: the burst's metrics do not reconcile")
    done = json.loads(server.get("/debug/requests?state=done")[1])
    from oryx_tpu_torch.utils.metrics import REQUEST_COST_KEYS

    for rec in done["requests"]:
        if list((rec["meta"].get("cost") or {})) != list(REQUEST_COST_KEYS):
            raise SystemExit(f"phase 19: {rec['id']} has no full ledger")
    for i in range(len(reqs)):
        tr = json.loads(server.get(f"/debug/trace?id=seq-{i}")[1])
        names = {e["name"] for e in tr["traceEvents"] if e["ph"] == "X"}
        if not SPANS <= names:
            raise SystemExit(f"phase 19: trace seq-{i} spans {names}")
    print(f"  /debug/requests: {len(done['requests'])} finished, each with "
          f"the full cost ledger; /debug/trace has the six spans "
          f"(the oldest's ledger {done['requests'][-1]['meta']['cost']})")

    # (c) drain: residents finish, /readyz and POSTs answer 503.
    import threading

    long_body = dict(reqs[-1][0], stream=True,
                     stream_options={"include_usage": True})
    res = []
    t = threading.Thread(target=lambda: res.append(server.post(long_body)))
    t.start()
    sch = server.srv.scheduler
    end = time.monotonic() + 120
    while all(r is None for r in sch.slots) and time.monotonic() < end:
        time.sleep(0.002)
    server.srv.begin_drain()
    ready = server.get("/readyz")
    post = server.post(reqs[3][0])
    t.join()
    drained = sch.drain(timeout=120)
    print(f"  (c) drain: /readyz {ready[0]} {json.loads(ready[1])}, POST "
          f"{post[0]}, the resident stream {res[0][0]} with usage "
          f"{res[0][2].get('usage')}, drained {drained}")
    if ready[0] != 503 or post[0] != 503 or res[0][0] != 200 or \
            res[0][2].get("usage", (0,))[0] != want[-1]["usage"][0] or \
            res[0][2].get("finish") not in ("stop", "length") or not drained:
        raise SystemExit("phase 19: drain")
    server.close()

    # (b) the window engine: chat_batch groups and a chat_stream.
    server = HttpServer(pipe, engine="window", batch_window=0.5,
                        max_batch=8)
    _zero_launches()
    wreqs = reqs[:5]
    outs, wwall = _burst(server, [b for b, _, _ in wreqs])
    flash_w, paged_w = _launch_counts()
    groups = collections.defaultdict(list)
    for i, (code, hdr, out) in enumerate(outs):
        if code != 200:
            raise SystemExit(f"phase 19: window burst request {i}: {code}")
        tr = json.loads(server.get(
            f"/debug/trace?id={hdr['X-Request-Id']}")[1])
        dec = next(e for e in tr["traceEvents"] if e["name"] == "decode")
        groups[dec["args"]["group"]].append((dec["args"]["row"], i,
                                             dec["args"]["bucket"]))
    print(f"  (b) window engine, {len(wreqs)} concurrent requests: wall "
          f"{wwall:.3f} s, K1 launches {flash_w}, paged {paged_w}; "
          f"chat_batch groups {[sorted(g) for g in groups.values()]}")
    if not flash_w or paged_w:
        raise SystemExit("phase 19: the window engine's launches")
    for gid, rows in sorted(groups.items()):
        rows.sort()
        idx = [i for _, i, _ in rows]
        replies, reasons, counts = pipe.chat_batch(
            [wreqs[i][1] for i in idx], max_new_tokens=rows[0][2],
            per_row_max=[wreqs[i][2] for i in idx],
            return_finish_reasons=True, return_token_counts=True)
        for i, r, why, use in zip(idx, replies, reasons, counts):
            o = outs[i][2]
            if (o["text"], o["finish"], tuple(o["usage"])) != \
                    (r, why, tuple(use)):
                raise SystemExit(f"phase 19: window request {i} differs "
                                 "from a direct chat_batch of its group")
    print("  window replies == direct Pipeline.chat_batch of the Batcher's "
          "groups, in its row order")
    body, req, n = reqs[0]
    code, _, out = server.post(dict(body, stream=True))
    direct = "".join(pipe.chat_stream(req["question"], images=req["images"],
                                      history=[], max_new_tokens=n))
    print(f"  window stream: {code}, first delta {out['first_s']:.3f} s, "
          f"wall {out['wall']:.3f} s; joined deltas == direct chat_stream: "
          f"{out['text'] == direct}")
    if code != 200 or out["text"] != direct:
        raise SystemExit("phase 19: the window stream differs from "
                         "chat_stream")
    server.close()

    # (d) supervised restart: the engine thread dies mid-decode.
    server = HttpServer(pipe, engine="continuous", prefix_cache=False,
                        stall_timeout=600, **HTTP_SERVE)
    body = reqs[-1][0]
    _, _, first = server.post(body)
    sch = server.srv.scheduler
    orig = sch.watchdog.set_active
    turns = [0]

    def crash_on_the_fourth_turn(active):
        # Raised outside the loop's containment: the thread dies.
        if active:
            turns[0] += 1
            if turns[0] == 4:
                raise RuntimeError("phase 19: injected engine crash")
        orig(active)

    sch.watchdog.set_active = crash_on_the_fourth_turn
    code, _, again = server.post(body)
    print(f"  (d) restart: engine restarts {sch.restarts}, "
          f"engine_restarts_total "
          f"{_metric(server.get('/metrics')[1], 'engine_restarts_total'):g};"
          f" reply after the crash == unbroken reply: "
          f"{again.get('text') == first['text']} (walls {first['wall']:.3f}"
          f" / {again.get('wall', 0):.3f} s)")
    if code != 200 or again["text"] != first["text"] or sch.restarts != 1:
        raise SystemExit("phase 19: supervised restart")
    server.close()


def tiny_engines_on_card() -> None:
    """Phase 8: the tiny fp32 config (input-sensitive weights) through the
    split and ragged engines on the card and on the CPU: equal replies."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    rng = np.random.default_rng(0)

    def img(h, w):
        return rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)

    reqs = [
        ({"question": "hi there"}, 9),
        ({"question": "what is this?", "images": [img(40, 56)]}, 6),
        ({"question": "compare", "images": [img(60, 30), img(28, 28)]}, 7),
        ({"question": "what happens?", "images": [img(42, 42)] * 4,
          "is_video": True}, 5),
    ]
    # Two look-alike text prompts: the second splices the first's pages.
    reqs += [({"question": "hi there, and what else?"}, 6)]
    geom = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512)
    for kv_dtype, ragged in itertools.product(("bf16", "int8"), (False, True)):
        out = []
        pa.LAUNCHES.clear()
        for device in ("cpu", "cuda"):
            sched = ContinuousScheduler(
                Pipeline(ByteTokenizer(), params, cfg, device=device),
                autostart=False, ragged=ragged,
                prefill_chunk=32 if ragged else None, kv_dtype=kv_dtype,
                **geom,
            )
            hs = [sched.submit(r, n) for r, n in reqs]
            sched.start()
            out.append([h.result(timeout=600) for h in hs])
            cached = [h.debug["cached_tokens"] for h in hs]
            sched.close()
            sched.check_pool_invariant()
        mode = f"{'ragged' if ragged else 'split'} {kv_dtype}"
        print(f"  {mode}: card == cpu: {out[0] == out[1]}; paged launches "
              f"on the card {dict(collections.Counter(k[0] for k in pa.LAUNCHES.elements()))}; "
              f"cached tokens {cached}; replies {[r[0][:12] for r in out[1]]}")
        if out[0] != out[1] or not pa.LAUNCHES:
            raise SystemExit(f"tiny {mode} engine on the card differs from "
                             f"the CPU: {out[1]} vs {out[0]}")


# ---- the serving observatories (phase 20) ---------------------------------

OBS_TOKENS = 16  # max_tokens of phase 20's requests
OBS_ARMED = dict(audit_sample_every=1, numerics_every=4)


def observatory_requests():
    """Phase 19's first image request and its first three text requests,
    at OBS_TOKENS tokens: (OpenAI body, the engine's request dict)."""
    reqs = http_requests()
    pick = ([r for r in reqs if r[1]["images"]][:1]
            + [r for r in reqs if not r[1]["images"]][:3])
    return [({**body, "max_tokens": OBS_TOKENS}, req) for body, req, _ in pick]


def _families(text: str, family: str) -> dict[str, float]:
    """{label value: value} of a one-label family, or {"": value} of an
    unlabeled one, from a /metrics scrape."""
    import re

    return {
        m.group(1) or "": float(m.group(2))
        for m in re.finditer(
            rf'^{family}(?:\{{\w+="([^"]*)"\}})? (\S+)$', text, re.M)
    }


def serve_observed(pipe, armed: bool) -> dict:
    """One server of phase 20 (phase 19's ragged geometry; armed: audits of
    every finished request and the numerics probe every 4 steps) over the
    four requests one at a time; the kernel counts zeroed just before and
    read after the audit backlog drained. Returns replies, scrapes, debug
    bodies, counts and the K3 calls the auditor's twin made."""
    import types

    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    server = HttpServer(pipe, engine="continuous", **HTTP_SERVE,
                        **(OBS_ARMED if armed else {}))
    sched = server.srv.scheduler
    recorder = None
    if armed:
        # The twin's decode reads the auditor's private pool.
        sched.auditor._ensure_pool()
        recorder = PagedCallRecorder(
            types.SimpleNamespace(kv_pages=sched.auditor._kv))
    out = {"replies": [], "usage": []}
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.perf_counter()
    try:
        with recorder or contextlib.nullcontext():
            for i, (body, _) in enumerate(observatory_requests()):
                code, _, reply = server.post(body, rid=f"obs-{i}")
                if code != 200:
                    raise SystemExit(f"phase 20: request {i}: {code}")
                out["replies"].append((reply["text"], reply["finish"]))
                out["usage"].append(reply["usage"])
            end = time.monotonic() + 120
            while True:
                au = json.loads(server.get("/debug/audit?n=64")[1])
                want = len(out["usage"]) if armed else 0
                if au["pending"] == 0 and au["total"] >= want:
                    break
                if time.monotonic() > end:
                    raise SystemExit(f"phase 20: audits never drained: {au}")
                time.sleep(0.05)
            torch.cuda.synchronize()
        out["wall"] = time.perf_counter() - t0
        out["flash"] = dict(fa.LAUNCHES)
        out["paged"] = dict(pa.LAUNCHES)
        out["audit"] = au
        out["metrics"] = server.get("/metrics")[1]
        for path in ("/debug/timeline?n=0", "/debug/pages", "/debug/oom"):
            code, body = server.get(path)
            if code != 200:
                raise SystemExit(f"phase 20: {path} answered {code}")
            out[path] = json.loads(body)
        out["events"] = [json.loads(ln) for ln in server.get(
            "/debug/requests?format=jsonl")[1].splitlines() if ln]
        out["calls"] = recorder.calls["paged_decode"] if armed else []
        out["pool_shape"] = (
            sched.auditor.max_pages, sched.page_size,
            pipe.cfg.llm.num_kv_heads, pipe.cfg.llm.head_dim)
    finally:
        server.close()
    return out


def check_observed(run: dict) -> None:
    """The gate's reconciliations on one phase-20 server: timeline kinds ==
    dispatches_total, the page map == the oryx_pool_* gauges with freed
    pages in the lifetime histogram, /debug/audit == oryx_audit_total with
    each record joined to its wide event."""
    text = run["metrics"]
    disp = _families(text, "oryx_serving_dispatches_total")
    tl = run["/debug/timeline?n=0"]
    if tl["counts_by_kind"] != {k: int(v) for k, v in disp.items()} or \
            tl["total_steps"] != sum(disp.values()) or not tl["records"]:
        raise SystemExit(f"phase 20: timeline {tl['counts_by_kind']} vs "
                         f"dispatches_total {disp}")
    pm = run["/debug/pages"]
    s = pm["summary"]
    parts = s["free"] + s["slot"] + s["cache"] + s["shared"]
    if not s["reconciled"] or parts != pm["num_pages"] or \
            len(pm["pages"]) != pm["num_pages"]:
        raise SystemExit(f"phase 20: the page map does not reconcile: {s}")
    for key in ("free", "slot", "cache", "shared"):
        if _families(text, f"oryx_pool_{key}_pages") != {"": s[key]}:
            raise SystemExit(f"phase 20: oryx_pool_{key}_pages vs {s}")
    if _families(text, "oryx_page_lifetime_seconds_count").get("", 0) < 1:
        raise SystemExit("phase 20: no page reached the lifetime histogram")
    au = run["audit"]
    got = _families(text, "oryx_audit_total")
    if au["total"] != sum(au["verdicts"].values()) or \
            got != {k: float(v) for k, v in au["verdicts"].items()}:
        raise SystemExit(f"phase 20: /debug/audit {au['verdicts']} vs "
                         f"oryx_audit_total {got}")
    events = {e["audit_index"]: e for e in run["events"]
              if e.get("kind") == "audit"}
    if sorted(events) != sorted(r["index"] for r in au["records"]) or any(
        events[r["index"]]["request_id"] != r["request_id"]
        for r in au["records"]
    ):
        raise SystemExit("phase 20: audit records and wide events differ")


def probe_step_ms(pipe) -> tuple[float, float]:
    """CUDA-event ms of one replay of the ragged engine's pure-decode step
    graph at phase 20's geometry (4 slots, 8 decode iterations), unarmed
    and with the numerics probe armed (its own graph), on one pool."""
    from oryx_tpu_torch.models import generate, qwen2
    from oryx_tpu_torch.models.oryx import compute_dtype
    from oryx_tpu_torch.ops.cuda.measure import cuda_time_ms

    cfg, dev = pipe.cfg, pipe.device
    S, ps, ctx = (HTTP_SERVE[k] for k in ("num_slots", "page_size",
                                          "max_ctx"))
    dtype = compute_dtype(cfg)
    pool = qwen2.init_paged_kv_cache(cfg.llm, S * ctx // ps, ps, dtype=dtype,
                                     device=dev)
    out = []
    for numerics in (False, True):
        graph = generate._EngineStepGraph(
            pipe.params.llm, cfg.llm, pool, None, num_slots=S,
            max_pages=ctx // ps, chunk=HTTP_SERVE["decode_chunk"], k=0,
            stop=None if pipe.stop_sequences is None
            else pipe.stop_sequences.to(dev), eos=cfg.generation.eos_token_id,
            attn_impl=cfg.attn_impl, compute_dtype=dtype, sampling=False,
            draft=None, max_steps=1, device=dev, numerics=numerics)
        # A replay writes its tokens at column block `step`: rewind it.
        out.append(cuda_time_ms(
            lambda: (graph.step.zero_(), graph.graph.replay()), iters=20))
        graph.graph.release()
    del pool
    return out[0], out[1]


def pressure_forensics(pipe) -> None:
    """A ragged scheduler whose pool holds the longer of two text prompts
    and nothing else: the second's admission falls short once, while the
    first decodes its 8 tokens inside its pages; exactly one pool_pressure
    record, naming both, and the pool invariant after it."""
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    texts = sorted(
        (r for r in observatory_requests() if not r[1]["images"]),
        key=lambda r: -len(pipe._prepare_request(r[1])[0]))[:2]
    ps, chunk = SERVE["page_size"], SERVE["chunk"]
    lens = [len(pipe._prepare_request(r[1])[0]) for r in texts]
    pages = -(-(lens[0] + chunk) // ps)
    sched = ContinuousScheduler(
        pipe, autostart=False, ragged=True, prefill_chunk=PREFILL_CHUNK,
        prefix_cache=False, **{**SERVE, "num_pages": pages})
    hs = [sched.submit(r[1], chunk) for r in texts]
    sched.start()
    res = [h.result(timeout=600) for h in hs]
    sched.close()
    sched.check_pool_invariant()
    recs = sched.forensics.snapshot()
    ooms = [e for e in sched.request_log.snapshot()
            if e.get("kind") == "oom_pressure"]
    print(f"  pool pressure: prompts {lens} tokens on a pool of {pages} "
          f"page(s) of {ps}: {len(recs)} forensic record(s) "
          f"{[(r['trigger'], r['detail']) for r in recs]}; top requests "
          f"{[(t['request_id'], t['pages'], t.get('asking_pages')) for r in recs for t in r['top_requests']]}; "
          f"usage {[u for _, _, u in res]}; pool invariant holds")
    if len(recs) != 1 or recs[0]["trigger"] != "pool_pressure" or \
            len(recs[0]["top_requests"]) != 2 or \
            not recs[0]["pool"]["reconciled"] or len(ooms) != 1 or \
            ooms[0]["forensic_index"] != recs[0]["index"]:
        raise SystemExit(f"phase 20: pool-pressure forensics {recs}")


def tiny_audited_engines_on_card() -> None:
    """The tiny fp32 config (its init as drawn) on the card through the
    split and ragged engines with every request audited and the probe
    every 2 steps: only pass verdicts (the twin: K1 prefill and K3 decode;
    the reference: plain attention), replies equal to an unarmed engine's."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    pipe = Pipeline(ByteTokenizer(), params, cfg, device="cuda")
    img = np.random.default_rng(0).integers(0, 255, (40, 56, 3), np.uint8)
    reqs = [({"question": "hi there"}, 9),
            ({"question": "what is this?", "images": [img]}, 6),
            ({"question": "tell me more"}, 7)]
    for ragged in (False, True):
        out = []
        for kw in ({}, dict(audit_sample_every=1, numerics_every=2)):
            sched = ContinuousScheduler(
                pipe, autostart=False, ragged=ragged,
                prefill_chunk=32 if ragged else None, num_slots=2,
                page_size=16, chunk=4, max_ctx=512, **kw)
            hs = [sched.submit(r, n) for r, n in reqs]
            sched.start()
            out.append([h.result(timeout=600) for h in hs])
            end = time.monotonic() + 120
            while kw and (sched.auditor.pending() or sched.auditor.to_dict()[
                    "total"] < len(reqs)) and time.monotonic() < end:
                time.sleep(0.02)
            d = sched.auditor.to_dict()
            samples = sched.metrics.registry.get(
                "oryx_numerics_samples_total", raw_name=True)
            sched.close()
        mode = "ragged" if ragged else "split"
        diffs = [r["logit_max_abs_diff"] for r in d["records"]]
        print(f"  tiny fp32 {mode}, audited: verdicts {d['verdicts']}, max "
              f"abs diffs {diffs}, numerics samples {samples}; replies == "
              f"unarmed: {out[0] == out[1]}")
        if d["verdicts"] != {"pass": len(reqs), "drift": 0, "fail": 0} or \
                out[0] != out[1] or not samples:
            raise SystemExit(f"phase 20: tiny {mode} audited engine {d}")


def observatories(pipe, card) -> tuple[list[dict], list]:
    """Phase 20: the observatories at full width (see the docstring).
    Returns the kernel rows and the unarmed server's replies."""
    runs = {armed: serve_observed(pipe, armed) for armed in (False, True)}
    plain, armed = runs[False], runs[True]
    print(f"  unarmed server {plain['wall']:.2f} s, armed (audits of every "
          f"request, the probe every {OBS_ARMED['numerics_every']} steps) "
          f"{armed['wall']:.2f} s, the audit backlog drained ({card})")
    if armed["replies"] != plain["replies"] or \
            armed["usage"] != plain["usage"]:
        raise SystemExit(f"phase 20: armed replies {armed['replies']} vs "
                         f"{plain['replies']}")
    disp = [_families(r["metrics"], "oryx_serving_dispatches_total")
            for r in (armed, plain)]
    if disp[0] != disp[1]:
        raise SystemExit(f"phase 20: dispatches {disp[0]} vs {disp[1]}")
    print(f"  replies, usage and dispatches_total {disp[0]} byte-equal to "
          f"the unarmed server's")
    for run in (plain, armed):
        check_observed(run)
    au = armed["audit"]
    print(f"  timeline == dispatches_total, page map == oryx_pool_* gauges "
          f"(lifetime count {_families(armed['metrics'], 'oryx_page_lifetime_seconds_count')['']:.0f}), "
          f"/debug/audit == oryx_audit_total, records joined to wide events;"
          f" /debug/oom total {armed['/debug/oom']['total']}")
    print(f"  bf16 full-width audit verdicts {au['verdicts']} (a finding, "
          "not gated: the live rows came from 4-row K4 dispatches, the "
          "twin's from 1-row K3 and the reference's from plain attention)")
    replayed = sum(r["replayed_tokens"] for r in au["records"])
    audit_s = sum(r["audit_s"] for r in au["records"])
    for r in reversed(au["records"]):
        print(f"    {r['request_id']}: {r['verdict']} first_divergence "
              f"{r['first_divergence']} max_abs_diff "
              f"{r['logit_max_abs_diff']} kl {r['kl']} replayed "
              f"{r['replayed_tokens']} tokens in {r['audit_s']:.3f} s")
    print(f"  auditor {1e3 * audit_s / max(1, replayed):.2f} ms a replayed "
          f"token ({replayed} tokens, {audit_s:.3f} s, two replays a "
          f"request)")
    samples = _families(armed["metrics"], "oryx_numerics_samples_total")
    p_ms, a_ms = probe_step_ms(pipe)
    print(f"  numerics: {samples.get('', 0):.0f} samples, entropy "
          f"{_families(armed['metrics'], 'oryx_numerics_logits_entropy')}; "
          f"a pure-decode engine step (graph replay, "
          f"{HTTP_SERVE['num_slots']} rows x {HTTP_SERVE['decode_chunk']} "
          f"iterations): armed {a_ms:.4f} ms vs unarmed {p_ms:.4f} ms "
          f"({card})")
    if not samples.get(""):
        raise SystemExit("phase 20: the numerics probe never sampled")
    flash_n = sum(armed["flash"].values())
    paged_n = collections.Counter()
    for key, n_ in armed["paged"].items():
        paged_n[key[0]] += n_
    print(f"  armed run launches: K1 {flash_n}, paged {dict(paged_n)}")
    if not paged_n.get("paged_decode"):
        raise SystemExit("phase 20: the twin never launched K3")
    if plain["paged"] and any(k[0] == "paged_decode" for k in plain["paged"]):
        raise SystemExit("phase 20: K3 launched without the auditor")

    print(f"phase 20 kernels: the auditor's twin at its call shapes, vs "
          f"plain twins, bf16, atol=rtol={TOL} ({card})", flush=True)
    gen = torch.Generator("cuda").manual_seed(20)
    rows = []
    row = paged_kernel_case(
        "paged_decode[audit]", "paged_decode",
        _pick(armed["calls"], lambda c: int(c[2].sum())),
        armed["pool_shape"], gen)
    row["launches"] = paged_n["paged_decode"]
    print(f"  launches {row['name']}: {row['launches']}")
    rows.append(row)
    # The twin's prefill: one row, the bucketed prompt against the gathered
    # max_ctx-wide stream; the widest of its K1 launch keys (causal,
    # segments, B, Hq, Hk, Tq, K, D).
    llm = pipe.cfg.llm
    widths = [k[5] for k in armed["flash"] if k[2:5] == (
        1, llm.num_heads, llm.num_kv_heads) and k[6:] == (
        HTTP_SERVE["max_ctx"], llm.head_dim)]
    if not widths:
        raise SystemExit("phase 20: the twin's prefill never launched K1")
    _, kw, keep = paged_prefill_case(
        pipe, max(u[0] for u in armed["usage"]), gen, width=max(widths))
    key, row = check_kernel_case("audit_prefill", kw, keep)
    row["launches"] = armed["flash"].get(key, 0)
    print(f"  launches {row['name']}: {row['launches']}")
    if row["launches"] == 0:
        raise SystemExit("phase 20: the twin's prefill never launched K1 "
                         "at its call shape")
    rows.append(row)

    pressure_forensics(pipe)
    tiny_audited_engines_on_card()
    return rows, plain["replies"]


# ---- faults, the journal and its replay, device time, the ladder (21) -------

FAULT_SPEC = "engine_crash:after=3"  # phase 21 (a): the 4th loop turn dies
PROFILE_EVERY = 2  # phase 21 (b): a capture every second dispatch
LADDER = dict(ttft_slo=1e-3, queue_depth_slo=1, degraded_cooldown=1.5)


def _sync(pipe) -> None:
    if pipe.device.type == "cuda":
        torch.cuda.synchronize()


def _sequential(server, tag: str) -> list:
    """Phase 20's four requests one at a time (its order, so each dispatch
    carries the rows it carried there): the (text, finish) replies."""
    out = []
    for i, (body, _) in enumerate(observatory_requests()):
        code, _, reply = server.post(body, rid=f"{tag}-{i}")
        if code != 200:
            raise SystemExit(f"phase 21: {tag} request {i}: {code}")
        out.append((reply["text"], reply["finish"]))
    return out


def journaled_crash(pipe, unarmed, tmp: str) -> None:
    """Phase 21 (a): a journaled server whose engine thread dies at the 4th
    loop turn with work; the supervisor restarts it and the replies equal
    phase 20's unarmed ones. The journal replays cold through
    serve/replay.run_replay on the same weights (the image request from its
    payload sidecar) with no divergence."""
    from oryx_tpu_torch.serve import journal as journal_lib
    from oryx_tpu_torch.serve import replay
    from oryx_tpu_torch.utils import faults

    path = os.path.join(tmp, "journal.jsonl")
    t0 = time.perf_counter()
    server = HttpServer(pipe, engine="continuous", **HTTP_SERVE,
                        journal_path=path, faults_spec=FAULT_SPEC)
    try:
        replies = _sequential(server, "p21a")
        body = json.loads(server.get("/debug/journal?n=0")[1])
        fired = _families(server.get("/metrics")[1],
                          "oryx_faults_injected_total")
    finally:
        server.close()
        server.srv.journal.close()
        faults.reset()
    live_wall = time.perf_counter() - t0
    counts = body["counts_by_kind"]
    print(f"  (a) {FAULT_SPEC}, journal armed: {live_wall:.2f} s, journal "
          f"{body['total']} entries {counts}, oryx_faults_injected_total "
          f"{fired}")
    if replies != unarmed:
        raise SystemExit(f"phase 21: crashed server's replies {replies} vs "
                         f"phase 20's {unarmed}")
    if counts.get("fault") != 1 or counts.get("restart") != 1 or \
            fired != {"engine_crash": 1.0}:
        raise SystemExit(f"phase 21: journal {counts}, faults {fired}")
    header, entries = journal_lib.read_journal(path)
    sidecar = {f"p21a-{i}": req
               for i, (_, req) in enumerate(observatory_requests())}
    t0 = time.perf_counter()
    res = replay.run_replay(header, entries, pipe=pipe, timeout_s=120,
                            payloads=sidecar)
    replay_wall = time.perf_counter() - t0
    div = replay.first_divergence(entries, res["entries"])
    matched, total, bad = replay.reply_match(entries, res["entries"])
    cost = [{rid: {k: e["cost"][k]
                   for k in journal_lib.DETERMINISTIC_COST_KEYS}
             for rid, e in replay._finishes(run).items()}
            for run in (entries, res["entries"])]
    print(f"  (a) cold replay (serve/replay.run_replay, same weights): wall "
          f"{replay_wall:.2f} s, {len(replay.replayed_stream(entries))} "
          f"replayed decisions, divergence {div}, replies {matched}/{total}, "
          f"DETERMINISTIC_COST_KEYS equal {cost[0] == cost[1]}")
    if div is not None or matched != total or total != len(unarmed) or \
            cost[0] != cost[1] or res["feed_errors"] or res["timed_out"] \
            or res["gave_up"]:
        raise SystemExit(f"phase 21: replay {div}, {bad}, {res['feed_errors']}"
                         f", timed out {res['timed_out']}")


def _kernel_events(body: dict, symbol: str) -> int:
    return sum(1 for e in body["traceEvents"]
               if e["ph"] == "X" and symbol in e["name"])


def _plane_kernels(planes, symbol: str) -> int:
    """Kernel records of the device planes whose name holds `symbol`."""
    return sum(1 for p in planes if p.name.startswith("/device:GPU")
               for ln in p.lines for e in ln.events if symbol in e.name)


def sampled_device_time(pipe, unarmed, card) -> dict:
    """Phase 21 (b): profile_sample_every=2 over the four requests (replies
    byte-equal to unarmed; every sampled timeline record within its window;
    device <= wall per kind), then GET /debug/profile?steps=4 around the
    image request's admission: K1 and K4 kernels in the Chrome trace, K4's
    kernel count == the K4 wrapper's launches over the captured steps.
    Returns the per-kind device and wall seconds."""
    import threading

    from oryx_tpu_torch.ops.cuda import graphs
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.utils import xplane

    server = HttpServer(pipe, engine="continuous", **HTTP_SERVE,
                        profile_sample_every=PROFILE_EVERY)
    sched = server.srv.scheduler
    marks, counted, on_demand, periodic = [], [], [], []
    begin, finish = sched.profiler.begin, sched.profiler.finish_capture
    end_sample = sched.profiler.end
    planes_of = xplane.planes_from_kineto
    replay = graphs.CountedGraph.replay
    replays = [0]

    def counting(events):
        # Every kernel record of the capture (the Chrome trace stops at
        # its event cap).
        planes = planes_of(events)
        counted.append((_plane_kernels(planes, "paged_split"),
                        _plane_kernels(planes, "flash_fwd_bf16")))
        return planes

    def k4() -> int:
        return sum(n for key, n in pa.LAUNCHES.items()
                   if key[0] == "ragged_paged")

    # Every mark is taken on the engine thread between two dispatches (the
    # capture begins before a loop turn's dispatch and closes after one,
    # once its kernels are done), so a mark cannot fall inside a dispatch.
    def begin_marked():
        marks.append(("begin", k4(), replays[0]))
        return begin()

    def end_marked(kind, t0_ns, t1_ns):
        # A periodic sample: its dispatch's K4 launches, whether it
        # replayed graphs, and its capture's K4 records (measured, not
        # held: such a capture stops at once).
        _, k4_0, replays_0 = marks[-1]
        launched, graph = k4() - k4_0, replays[0] > replays_0
        n = len(counted)
        out = end_sample(kind, t0_ns, t1_ns)
        if len(counted) > n:
            periodic.append((graph, launched, counted[n][0]))
        return out

    def replay_counted(graph):
        replays[0] += 1
        return replay(graph)

    def finish_marked(windows):
        marks.append(("finish", k4(), replays[0]))
        n = len(counted)
        out = finish(windows)
        # The planes this capture parsed (periodic samples parse later).
        on_demand.append(counted[n] if len(counted) > n else (0, 0))
        return out

    sched.profiler.begin = begin_marked
    sched.profiler.end = end_marked
    sched.profiler.finish_capture = finish_marked
    xplane.planes_from_kineto = counting
    graphs.CountedGraph.replay = replay_counted
    try:
        t0 = time.perf_counter()
        replies = _sequential(server, "p21b")
        wall = time.perf_counter() - t0
        metrics = server.get("/metrics")[1]
        timeline = json.loads(server.get("/debug/timeline?n=0")[1])
        got = {}

        def capture():
            got["resp"] = server.get("/debug/profile?steps=4&timeout=60")

        th = threading.Thread(target=capture)
        th.start()
        # The capture is parked before the requests arrive, so its steps
        # begin at the image request's admission (the ViT's K1 launches);
        # the image and a text request at once give it more than four
        # dispatches.
        time.sleep(0.2)
        outs, _ = _burst(server, [b for b, _ in observatory_requests()[:2]])
        code = max(o[0] for o in outs)
        th.join(timeout=90)
        _sync(pipe)
        metrics_after = server.get("/metrics")[1]
    finally:
        xplane.planes_from_kineto = planes_of
        graphs.CountedGraph.replay = replay
        server.close()
    print(f"  (b) profile_sample_every={PROFILE_EVERY}: {wall:.2f} s for the "
          f"four requests ({card})")
    for graph in (True, False):
        got_ = [(n, r) for g, n, r in periodic if g == graph and n]
        print(f"    periodic samples of {'graph-replay' if graph else 'eager'}"
              f" dispatches with K4: {len(got_)}, K4 records "
              f"{sum(r for _, r in got_)} of {sum(n for n, _ in got_)} "
              f"launched (short in {sum(1 for n, r in got_ if r < n)})")
    if replies != unarmed:
        raise SystemExit(f"phase 21: sampled replies {replies} vs {unarmed}")
    sampled = [r for r in timeline["records"] if r["device_us"] is not None]
    over = [r for r in sampled
            if not 0 <= r["device_us"] <= round(r["dur_s"] * 1e6)]
    dev = _families(metrics, "oryx_device_time_seconds_total")
    walls = _families(metrics, "oryx_profile_sampled_wall_seconds_total")
    errs = _families(metrics_after, "oryx_profile_capture_errors_total")
    print(f"  (b) {len(sampled)} of {len(timeline['records'])} timeline "
          f"records sampled, all within their windows: {not over}; capture "
          f"errors {errs or 0}")
    ratios = {}
    for kind in sorted(walls):
        d, w = dev.get(kind, 0.0), walls[kind]
        ratios[kind] = (d, w)
        print(f"    {kind}: device {d * 1e3:.3f} ms / sampled wall "
              f"{w * 1e3:.3f} ms = {d / w:.4f}, idle share "
              f"{1 - d / w:.4f}")
    print(f"    other (capture time outside every window): device "
          f"{dev.get('other', 0.0) * 1e3:.3f} ms")
    if not sampled or over or any(d > w for d, w in ratios.values()) or \
            not dev.get("ragged") or any(errs.values()):
        raise SystemExit(f"phase 21: sampling {over}, {dev}, {walls}, "
                         f"{errs}")
    status, text = got.get("resp", (None, ""))
    if code != 200 or status != 200:
        raise SystemExit(f"phase 21: /debug/profile {status}, request "
                         f"{code}: {text[:300]}")
    prof = json.loads(text)
    end = max(i for i, (kind, *_) in enumerate(marks) if kind == "finish")
    start = max(i for i in range(end) if marks[i][0] == "begin")
    launched = marks[end][1] - marks[start][1]
    k4_events, k1_events = on_demand[-1]
    named = [_kernel_events(prof, sym) > 0
             for sym in ("flash_fwd_bf16", "paged_split")]
    print(f"  (b) /debug/profile?steps=4: {prof['steps']} steps, source "
          f"{prof['source']}, device_time_us {prof['device_time_us']}, "
          f"{len(prof['traceEvents'])} trace events (truncated "
          f"{prof['truncated']}) naming K1 flash_fwd_bf16 and K4 "
          f"paged_split: {named}; the capture's kernel records: K1 "
          f"{k1_events}, K4 {k4_events} vs the K4 wrapper's launches over "
          f"the captured steps {launched}")
    if prof["steps"] != 4 or prof["source"] != "gpu_kernels" or \
            not all(named) or not k1_events or k4_events != launched \
            or not launched:
        raise SystemExit("phase 21: the on-demand capture")
    return ratios


def _wait_for(pred, timeout: float) -> bool:
    end = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > end:
            return False
        time.sleep(0.005)
    return True


def ladder(pipe, tmp: str) -> None:
    """Phase 21 (c): ttft_slo 1 ms, queue_depth_slo 1 and a 1.5 s cooldown.
    The burst of the four requests and four more fires the queue SLO and
    the first TTFT (one level each when an engine turn lies between them);
    each time its queue has drained (the queue detector re-armed), a short
    burst of three fires the queue SLO again, until mode 3, where a
    request gets the shed reply (429, Retry-After). Each escalation leaves one degraded_escalation forensic
    and a journaled `degraded` entry; quiet cooldowns walk the mode back to
    0, and the pool invariant holds."""
    import threading

    from oryx_tpu_torch.utils import faults

    path = os.path.join(tmp, "ladder.jsonl")
    server = HttpServer(pipe, engine="continuous", **HTTP_SERVE, **LADDER,
                        journal_path=path)
    sched = server.srv.scheduler
    outs = []

    def post_all(bodies, tag):
        def one(i, body):
            outs.append(server.post(body, rid=f"p21c-{tag}-{i}")[0])

        threads = [threading.Thread(target=one, args=(i, b))
                   for i, b in enumerate(bodies)]
        for t in threads:
            t.start()
        return threads

    try:
        bodies = [b for b, _ in observatory_requests()]
        extra = [{"messages": [{"role": "user",
                                "content": f"Count to {i + 3}."}],
                  "max_tokens": OBS_TOKENS} for i in range(4)]
        t0 = time.perf_counter()
        threads = post_all(bodies + extra, "burst")
        _wait_for(lambda: sched.degraded_mode >= 1, 20)
        waves = 0
        while sched.degraded_mode < 3 and waves < 6:
            # The queue detector re-arms once the queue drains; three
            # requests at once then queue past the SLO again.
            _wait_for(lambda: sched.queue_len() == 0, 20)
            before = sched.degraded_mode
            threads += post_all(extra[:3], f"wave{waves}")
            waves += 1
            _wait_for(lambda: sched.degraded_mode > before, 1.0)
        peak = sched.degraded_mode
        code, headers, body = server.post(extra[0], rid="p21c-shed")
        t_top = time.perf_counter() - t0
        for t in threads:
            t.join()
        back = _wait_for(lambda: sched.degraded_mode == 0,
                         4 * LADDER["degraded_cooldown"] + 5)
        t_down = time.perf_counter() - t0 - t_top
        oom = json.loads(server.get("/debug/oom?n=0")[1])
        journal = json.loads(server.get("/debug/journal?n=0")[1])
        sched.check_pool_invariant()
    finally:
        server.close()
        server.srv.journal.close()
        faults.reset()
    esc = [r for r in oom["records"] if r["trigger"] == "degraded_escalation"]
    modes = [e["mode"] for e in reversed(journal["entries"])
             if e["kind"] == "degraded"]
    ups = sum(1 for a, b in zip([0] + modes, modes) if b > a)
    err = body.get("error", {}) if isinstance(body, dict) else {}
    print(f"  (c) ladder: a burst of {len(bodies + extra)} and {waves} "
          f"short burst(s) of 3, statuses "
          f"{dict(collections.Counter(outs))}; mode {peak} after "
          f"{t_top:.2f} s; the request at mode 3 -> {code} Retry-After "
          f"{headers.get('Retry-After')} ({err.get('type')}: "
          f"{err.get('message')}); journaled mode walk {modes}; back to 0: "
          f"{back}, {t_down:.2f} s later; degraded_escalation records "
          f"{len(esc)} == escalations {ups}; pool invariant holds")
    if peak != 3 or code != 429 or headers.get("Retry-After") is None or \
            not back or len(esc) != ups or ups < 3 or modes[-1] != 0:
        raise SystemExit("phase 21: the degraded ladder")


def resilience(pipe, unarmed, card) -> None:
    """Phase 21: (a), (b), (c) above; kernel launches counted over the
    phase."""
    import tempfile

    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    _zero_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for part, run in (
            ("a", lambda: journaled_crash(pipe, unarmed, tmp)),
            ("b", lambda: sampled_device_time(pipe, unarmed, card)),
            ("c", lambda: ladder(pipe, tmp)),
        ):
            t0 = time.perf_counter()
            run()
            print(f"  ({part}) wall {time.perf_counter() - t0:.1f} s")
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    print(f"  phase 21 launches: K1 {sum(fa.LAUNCHES.values())}, paged "
          f"{dict(paged)}")
    if not sum(fa.LAUNCHES.values()) or not paged.get("ragged_paged"):
        raise SystemExit("phase 21: K1 or K4 never launched")


# ---- speculation and megasteps (phase 15) ----------------------------------

SPEC_K = 4  # drafts a slot verifies per step


class OracleDrafter:
    """Proposes the continuation of whichever recorded stream the context
    is a prefix of: a text request's prompt ids + its reply, or (the
    engine drafts a multimodal request from its reply alone) a reply. On a
    stream the engine reproduces, every draft is accepted."""

    window = None
    device_apply = None

    def __init__(self, streams: list[list[int]]):
        self.streams = [np.asarray(x, np.int64) for x in streams]

    def propose(self, context, k):
        ctx = np.asarray(context, np.int64)
        for seq in self.streams:
            n = len(ctx)
            if len(seq) > n and np.array_equal(seq[:n], ctx):
                return [int(t) for t in seq[n:n + k]]
        return []

    def device_params(self, device=None):
        return None


def spec_streams(pipe, reqs, results) -> list[list[int]]:
    """The drafting streams of served requests: prompt ids + reply ids of a
    text request, the reply ids of a multimodal one."""
    out = []
    for (req, _), (reply, _, _) in zip(reqs, results):
        ids = pipe.tokenizer.reply_ids(reply)
        if not req.get("images"):
            ids = list(pipe._prepare_request(req)[0]) + ids
        out.append(ids)
    return out


def tail_profile(fn):
    """fn() (an engine serving one request) traced; returns (host launch
    calls from the first graph launch on, the kernels' idle share over that
    window): the graph route's share of the run after its one eager
    dispatch with prefill lanes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    graph = [e.time_range.start for e in events
             if e.name in ("cudaGraphLaunch", "cuGraphLaunch")]
    if not graph:
        raise SystemExit("the traced run launched no graph")
    t0 = min(graph)
    calls = sum(1 for e in events
                if e.name in HOST_LAUNCHES and e.time_range.start >= t0)
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.time_range.start >= t0)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = max(b for _, b in spans) - t0
    return calls, 1 - busy / window


def spec_line(label, run) -> str:
    m = run["metrics"]
    per = (m["accepted_tokens_per_step_sum"]
           / max(1, m["accepted_tokens_per_step_count"]))
    rate = m["draft_accepted_total"] / max(1, m["draft_proposed_total"])
    return (f"  {label}: wall {run['wall']:.3f} s, tail {run['tail']:.3f} s"
            f" ({run['tail_steps']} logical steps) | tokens per verify step "
            f"{per:.3f}, accept rate {rate:.3f} ({m['draft_accepted_total']}"
            f"/{m['draft_proposed_total']}) | dispatches "
            f"{dict(m['dispatches_total'])} | megasteps "
            f"{dict(m['megasteps_total'])} | graphs "
            f"{m['graph_captures_total']} in {m['graph_capture_s']:.3f} s")


def replies(run) -> list[str]:
    return [r[0] for r in run["results"]]


def speculation_and_megasteps(spipe, step1, pool_shape, card) -> list[dict]:
    """Phase 15 (see the module docstring); returns the kernel table's rows
    of K4 and K4q at the speculative call shapes."""
    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    S = SERVE["num_slots"]
    reqs = serve_requests()
    want = replies(step1)
    ragged = dict(ragged=True)

    def same(label, run, ref=want, must=True) -> None:
        n = sum(a == b for a, b in zip(replies(run), ref))
        print(f"    {label}: {n}/{len(ref)} replies equal"
              + ("" if must else " (bf16, not asserted)"))
        if must and n != len(ref):
            raise SystemExit(f"phase 15: {label}: {replies(run)} vs {ref}")

    # Megasteps over the mix, after its last admission.
    for fuse in (4, "auto"):
        run = run_scheduler(spipe, **ragged, record=False, fuse_steps=fuse)
        print(spec_line(f"fuse_steps={fuse!r}", run))
        same(f"fuse_steps={fuse!r} vs phase 7's ragged engine", run)
        if not run["metrics"]["megasteps_total"]:
            raise SystemExit(f"fuse_steps={fuse!r}: no megastep ran")
    solo = [({"question": "Tell me a long story about a lighthouse."}, 128)]
    holder = {}

    def solo_run():
        holder["run"] = run_scheduler(spipe, **ragged, record=False,
                                      fuse_steps="auto", reqs=solo)

    calls, idle = tail_profile(solo_run)
    run = holder["run"]
    print(spec_line("solo request, 128 new tokens, fuse_steps='auto', "
                    "traced", run))
    steps = run["tail_steps"]
    # The tail holds the engine-step graph's capture (its first pure-decode
    # dispatch comes after the admission).
    tail = run["tail"] - run["metrics"]["graph_capture_s"]
    print(f"    after its one eager dispatch: {calls} host launch calls for "
          f"{steps} logical steps ({calls / max(1, steps):.2f} a logical "
          f"step), kernels' idle share {idle:.1%}; tail less the capture "
          f"{tail:.3f} s, {tail / max(1, steps * SERVE['chunk']) * 1e3:.2f} "
          "ms a decode iteration")
    if 16 not in run["metrics"]["megasteps_total"]:
        raise SystemExit("the solo request never reached rung 16")

    # Speculation, k = SPEC_K. The solo request without drafts (every
    # dispatch after its admission a 20-row verify forward), then with an
    # oracle of that reply: the same forwards, so every draft is accepted.
    solo = [({"question": "Tell me a long story about a lighthouse."}, 96)]
    bare = run_scheduler(spipe, **ragged, record=False, speculate=SPEC_K,
                         reqs=solo, drafter=OracleDrafter([]))
    full = run_scheduler(spipe, **ragged, record=False, speculate=SPEC_K,
                         reqs=solo, drafter=OracleDrafter(
                             spec_streams(spipe, solo, bare["results"])))
    print(spec_line(f"solo request, 96 new tokens, speculate={SPEC_K}, no "
                    "drafts", bare))
    print(spec_line("    the same, with an oracle of that reply", full))
    same("oracle self-replay (solo)", full, replies(bare))
    # An oracle of phase 7's replies on the mix, then n-grams.
    streams = spec_streams(spipe, reqs, step1["results"])
    oracle = [run_scheduler(spipe, **ragged, record=False, speculate=SPEC_K,
                            drafter=OracleDrafter(streams))
              for _ in range(2)]
    print(spec_line(f"speculate={SPEC_K}, oracle drafter", oracle[0]))
    same("oracle vs phase 7's ragged engine", oracle[0], must=False)
    same("oracle self-replay", oracle[1], replies(oracle[0]))
    ngram = [run_scheduler(spipe, **ragged, record=False, eager=eager,
                           speculate=SPEC_K) for eager in (False, True)]
    print(spec_line(f"speculate={SPEC_K}, NgramDrafter", ngram[0]))
    print(spec_line("  the same on the eager witness", ngram[1]))
    same("NgramDrafter vs phase 7's ragged engine", ngram[0], must=False)
    same("NgramDrafter graph route vs eager witness (run to run)", ngram[1],
         replies(ngram[0]))

    # A drafter fit on phase 7's replies, in the fused loop and without.
    t = time.perf_counter()
    drafter, losses = generate_lib.fit_neural_drafter(
        [spipe.tokenizer.reply_ids(r) for r in want],
        spipe.cfg.llm.vocab_size, dim=16, window=16, epochs=20, lr=40.0,
        seed=0)
    print(f"  fit_neural_drafter on phase 7's replies: {len(losses)} epochs "
          f"in {time.perf_counter() - t:.1f} s, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}")
    spec_runs = {}
    for kv in ("bf16", "int8"):
        kw = dict(speculate=SPEC_K, drafter=drafter, kv_dtype=kv)
        k1 = run_scheduler(spipe, **ragged, record=False, **kw)
        witness = run_scheduler(spipe, **ragged, record=True, eager=True,
                                **kw)
        fused = run_scheduler(spipe, **ragged, record=False, fuse_steps=4,
                              **kw)
        print(spec_line(f"{kv} pool, NeuralDrafter, fuse_steps=1", k1))
        print(spec_line("  the same on the eager witness", witness))
        print(spec_line(f"{kv} pool, NeuralDrafter, fuse_steps=4", fused))
        same(f"{kv} graph route vs eager witness", witness, replies(k1))
        same(f"{kv} fused speculative vs speculative", fused, replies(k1))
        if not fused["metrics"]["megasteps_total"]:
            raise SystemExit(f"{kv}: no fused speculative megastep ran")
        spec_runs[kv] = (k1, witness)

    print("  tiny fp32 engines, card vs CPU:")
    tiny_spec_engines_on_card()

    # K4 and K4q at the speculative call shapes: R = S * (1 + k) verify
    # lanes (slot-major), alone and with the admitting slot's
    # prefill_chunk prefill lanes behind them. Each call is recorded on its
    # pool's eager witness; its launches are those of the graph-route run
    # of the same engine (counts zeroed just before it).
    R = S * (1 + SPEC_K)
    gen = torch.Generator("cuda").manual_seed(5)
    rows = []
    for kv, (graph, witness) in spec_runs.items():
        fmt = None if kv == "bf16" else kv
        kernel = "ragged_paged" + (f"_{fmt}" if fmt else "")
        for shape, width in (("spec_verify", R),
                             ("spec_verify_prefill", R + PREFILL_CHUNK)):
            calls = [c for c in witness["recorder"].calls["ragged_paged"]
                     if c[0][0][0] == width]
            row = paged_kernel_case(
                f"{kernel}[{shape}]", "ragged_paged",
                _pick(calls, lambda c: int((c[3] + 1).sum())), pool_shape,
                gen, fmt)
            row["launches"] = sum(
                n for key, n in graph["paged_keys"].items()
                if key[0] == kernel and key[1] == width)
            print(f"  launches {row['name']}: {row['launches']} (the {kv} "
                  "NeuralDrafter run on the graph route)")
            if row["launches"] == 0:
                raise SystemExit(f"{kernel} never ran at R = {width}")
            rows.append(row)
    return rows


def tiny_spec_engines_on_card() -> None:
    """Phase 15's tiny engines: the tiny fp32 config speculating (n-grams),
    fused (K = 4) and both (a random neural drafter), over a bf16 and an
    int8 pool, on the card and on the CPU: equal replies, equal to the
    CPU's plain ragged engine."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    cfg = dataclasses.replace(config.oryx_tiny(), attn_impl="pallas")
    params = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    with torch.no_grad():
        for p in params.parameters():
            if p.dim() >= 2:
                p.mul_(20)
    rng = np.random.default_rng(0)
    reqs = [
        ({"question": "hi there"}, 24),
        ({"question": "what is this?",
          "images": [rng.integers(0, 255, size=(40, 56, 3), dtype=np.uint8)]},
         20),
        ({"question": "what is going on with all of this"}, 28),
    ]
    geom = dict(num_slots=2, page_size=16, chunk=4, max_ctx=512,
                ragged=True, prefill_chunk=16)
    V = cfg.llm.vocab_size
    modes = {
        "speculate=3": dict(speculate=3),
        "fuse_steps=4": dict(fuse_steps=4),
        "speculate=3, fuse_steps=4": dict(
            speculate=3, fuse_steps=4,
            drafter=generate_lib.NeuralDrafter.init(V, 8, window=8)),
    }

    def serve(device, **kw):
        sched = ContinuousScheduler(
            Pipeline(ByteTokenizer(), params, cfg, device=device),
            autostart=False, **geom, **kw)
        hs = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        out = [h.result(timeout=600) for h in hs]
        sched.close()
        sched.check_pool_invariant()
        return out, engine_counts(sched)

    for kv in ("bf16", "int8"):
        plain, _ = serve("cpu", kv_dtype=kv)
        for name, kw in modes.items():
            cpu, _ = serve("cpu", kv_dtype=kv, **kw)
            gpu, m = serve("cuda", kv_dtype=kv, **kw)
            print(f"    {kv} pool, {name}: card == cpu {gpu == cpu}, == the "
                  f"plain engine {gpu == plain}; dispatches "
                  f"{dict(m['dispatches_total'])}, graphs "
                  f"{m['graph_captures_total']}")
            if not gpu == cpu == plain or not m["graph_captures_total"]:
                raise SystemExit(f"tiny {kv} {name}: card {gpu} vs cpu {cpu}"
                                 f" vs plain {plain}")


# ---- the int8 engine and the prefix cache (phases 12-13) -------------------

HOST_CACHE = 256 << 20  # host tier of phase 12's engines


def shared_context() -> str:
    """1,536 bytes of a harbour log: the context phase 12's text requests
    share (24 pages of 64 byte-tokens with the template's head)."""
    lines, i = [], 0
    while sum(map(len, lines)) < 1536:
        lines.append(f"Harbour log {i:03d}: wind west at {i % 7 + 3} "
                     f"knots, {i % 5 + 1} boats out, calm grey water. ")
        i += 1
    return "".join(lines)[:1536]


def shared_requests(pipe) -> list[str]:
    """Five questions over the shared context. The first four are padded
    until their prompt ends 1..31 tokens into a page, so a reply of up to
    32 tokens donates no page past the prompt's last partial one: served
    again from the device cache or reloaded from host, each prefills the
    same suffix over the same cached bytes. The fifth ends on a page
    boundary: served again, its whole prompt is cached and the splice
    copies its last page on write."""
    ctx = shared_context()
    asks = ["How strong was the wind?", "How many boats went out?",
            "What colour was the water?", "Summarise the log.",
            "Which entry is the last?"]
    out = []
    for i, ask in enumerate(asks):
        q = ctx + ask
        while True:
            n = len(pipe._prepare_request({"question": q})[0]) % 64
            if (n == 0) if i == 4 else (1 <= n <= 31):
                break
            q += "?"
        out.append(q)
    return out


def quiesce(sched, timeout=60.0) -> None:
    """Wait until the engine holds no slot and no queued request."""
    deadline = time.monotonic() + timeout
    while any(r is not None for r in sched.slots) or sched.queue_len():
        if time.monotonic() > deadline:
            raise SystemExit("the engine did not go idle")
        time.sleep(0.01)


def run_int8_engine(pipe, ragged: bool, record: bool, shared: list[str],
                    eager: bool = False):
    """One phase-12 run (see the module docstring); counts zeroed just
    before, read just after; eager as in run_scheduler. Returns a dict of
    what it served and cost."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import graphs
    from oryx_tpu_torch.ops.cuda import paged_attention as pa
    from oryx_tpu_torch.serve.scheduler import ContinuousScheduler

    sched = ContinuousScheduler(
        pipe, autostart=False, ragged=ragged,
        prefill_chunk=PREFILL_CHUNK if ragged else None, kv_dtype="int8",
        host_cache_bytes=HOST_CACHE, **SERVE,
    )
    recorder = PagedCallRecorder(sched) if record else None
    rounds: dict[str, list] = {}
    walls: dict[str, float] = {}

    def serve(label, reqs):
        t = time.perf_counter()
        hs = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        res = [h.result(timeout=600) for h in hs]
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
        quiesce(sched)
        rounds[label] = list(zip(hs, res, [n for _, n in reqs]))

    texts = [({"question": q}, MAX_NEW) for q in shared]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext(), graphs.routes(not eager):
        serve("phase 7 mix", serve_requests())
        serve("round A", texts)
        serve("round B", texts)
        cache = sched.prefix_cache
        t = time.perf_counter()
        spilled = cache.evict(cache.evictable_pages())
        spill_s = time.perf_counter() - t
        host_bytes = cache.host_bytes
        serve("round C", texts[:4])
    wall = time.perf_counter() - t0
    sched.close()
    sched.check_pool_invariant()
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    flat = [x for label in rounds for x in rounds[label]]
    return {
        "rounds": rounds, "walls": walls, "wall": wall,
        "results": [res for _, res, _ in flat],
        "caps": [n for _, _, n in flat],
        "ttft": [h.debug["ttft_s"] for h, _, _ in flat],
        "cached": [h.debug["cached_tokens"] for h, _, _ in flat],
        "metrics": engine_counts(sched), "peak": torch.cuda.max_memory_allocated(),
        "flash": dict(fa.LAUNCHES), "paged": dict(paged),
        "paged_keys": dict(pa.LAUNCHES), "recorder": recorder,
        "spilled": spilled, "spill_s": spill_s, "host_bytes": host_bytes,
        "pool_bytes": sum(
            t.numel() * t.element_size() for plane in sched.kv_pages.values()
            for t in (plane.q, plane.scale)
        ),
    }


def check_int8_run(mode: str, i: int, run: dict) -> None:
    """Print one phase-12 run; fail unless the cache hit, copied on write,
    spilled and reloaded, and round C's replies equal round B's."""
    check_serving_run(mode, i, run, code="_int8")
    m = run["metrics"]
    replies = {k: [res[0] for _, res, _ in v]
               for k, v in run["rounds"].items()}
    print(f"    walls s: { {k: round(v, 3) for k, v in run['walls'].items()} }"
          f"; evict of {run['spilled']} pages to host "
          f"{run['spill_s'] * 1e3:.1f} ms ({run['host_bytes'] / 1e6:.1f} MB)")
    print(f"    cache: hits {m['prefix_cache_hit_tokens_total']} tokens, "
          f"copy-on-write {m['prefix_cache_cow_pages_total']}, evicted "
          f"{m['prefix_cache_evicted_pages_total']} pages, reloads "
          f"{m['oryx_cache_reload_hit_total']} ({m['oryx_cache_reload_upload_total']}"
          f" pages uploaded); int8 pool {run['pool_bytes'] / 1e9:.3f} GB")
    same = sum(a == b for a, b in zip(replies["round A"], replies["round B"]))
    print(f"    cold/first-splice (round A) vs cached (round B) replies "
          f"equal (not asserted): {same}/5")
    if not (m["prefix_cache_hit_tokens_total"] > 0
            and m["prefix_cache_cow_pages_total"] >= 1 and run["spilled"] > 0
            and m["oryx_cache_reload_upload_total"] > 0):
        raise SystemExit(f"{mode}: the prefix cache did not hit, copy on "
                         f"write, spill and reload: {m}")
    if replies["round C"] != replies["round B"][:4]:
        raise SystemExit(f"{mode}: reloaded replies differ from the "
                         f"device-cached ones: {replies['round C']} vs "
                         f"{replies['round B'][:4]}")
    print("    reloaded (round C) replies equal the device-cached ones "
          "(round B)")


def generate_fp8(pipe, shared: list[str], ragged: bool):
    """generate_paged(kv_dtype="fp8_e4m3") over the first four shared
    prompts at full width; launch counts zeroed just before, read just
    after. Returns (tokens, launches by kernel name, wall)."""
    from oryx_tpu_torch.models import generate
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    ids = [pipe._prepare_request({"question": q})[0] for q in shared[:4]]
    T = max(map(len, ids))
    emb = pipe.params.llm.embed.weight
    dev = pipe.device
    x = torch.zeros((len(ids), T, emb.shape[1]), dtype=emb.dtype, device=dev)
    for b, row in enumerate(ids):
        x[b, :len(row)] = emb[torch.tensor(row, device=dev)]
    cfg = pipe.cfg
    torch.cuda.synchronize()
    pa.LAUNCHES.clear()
    t0 = time.perf_counter()
    toks, num, _ = generate.generate_paged(
        pipe.params.llm, cfg.llm, cfg.generation, inputs_embeds=x,
        lengths=[len(r) for r in ids], max_new_tokens=MAX_NEW,
        page_size=SERVE["page_size"], chunk=SERVE["chunk"],
        attn_impl="pallas", compute_dtype=emb.dtype,
        kv_dtype="fp8_e4m3", ragged=ragged, device=dev,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        launches[key[0]] += n
    return toks, dict(launches), wall


# ---- int8 weights and the checkpoint round trip (phase 16) -----------------

Q8_ROWS = (4, 20)  # decode (B = 4) and verify (S(1 + k) = 20) rows
DISK_LAYERS = 2  # LLM and ViT depth of the round trip when the disk is short
DISK_MARGIN = 1.25  # free disk over what the full-depth round trip writes
# The most the round trip writes: a run's disk writes stay bounded (the
# full oryx_7b writes 48.3 GB, so it takes the cut depth).
DISK_WRITE_CAP = 24e9


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _states_equal(a, b) -> bool:
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(
        sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)


def disk_round_trip(cfg, params) -> None:
    """Phase 16a: save_pretrained and export_hf of phase 2's model (full
    oryx_7b), loaded back with load_pretrained_model and
    load_from_hf(projector_path=), each reload compared (every tensor
    byte-equal) and freed before the next; then
    load_pretrained_model(quantize="int8"), its peak card memory beside
    quantized_bytes, byte-equal to quantize_params of the same floats. When
    the disk cannot hold both checkpoints with DISK_MARGIN to spare, or
    they would write more than DISK_WRITE_CAP, a model cut to DISK_LAYERS
    LLM and ViT layers of full width (random bf16, seed 5) takes its
    place, and the line says so."""
    import shutil
    import tempfile

    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.utils.quant import quantize_params, quantized_bytes

    tok = ByteTokenizer()
    with tempfile.TemporaryDirectory() as d:
        # save_pretrained writes the bf16 tensors, export_hf them in fp32.
        need = 3 * quantized_bytes(params)
        free = shutil.disk_usage(d).free
        if free >= DISK_MARGIN * need and need <= DISK_WRITE_CAP:
            run_cfg, model = cfg, params
            print(f"  full depth ({cfg.llm.num_layers} LLM + "
                  f"{cfg.vision.num_layers} ViT layers), phase 2's weights, "
                  f"in {d} ({free / 1e9:.1f} GB free, {need / 1e9:.1f} GB "
                  "to write)")
        else:
            run_cfg = dataclasses.replace(
                cfg,
                llm=dataclasses.replace(cfg.llm, num_layers=DISK_LAYERS),
                vision=dataclasses.replace(cfg.vision,
                                           num_layers=DISK_LAYERS))
            model = oryx.init_params(
                run_cfg, torch.Generator("cuda").manual_seed(5),
                device="cuda", dtype=torch.bfloat16)
            print(f"  depth cut to {DISK_LAYERS} LLM + {DISK_LAYERS} ViT "
                  f"layers at full width: the full depth writes "
                  f"{need / 1e9:.1f} GB (cap {DISK_WRITE_CAP / 1e9:.0f} GB; "
                  f"{free / 1e9:.1f} GB free in {d}, {DISK_MARGIN} x needed)")
        native, hf = os.path.join(d, "native"), os.path.join(d, "hf")
        walls, checks = {}, {}

        def timed(label, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls[label] = time.perf_counter() - t0
            return out

        timed("save_pretrained", lambda: builder.save_pretrained(
            native, run_cfg, model))
        timed("export_hf", lambda: builder.export_hf(hf, run_cfg, model))
        print(f"  written: save_pretrained {_dir_bytes(native) / 1e9:.3f} GB"
              f", export_hf {_dir_bytes(hf) / 1e9:.3f} GB", flush=True)
        _, back, _ = timed("load_pretrained_model", lambda: (
            builder.load_pretrained_model(native, tokenizer=tok,
                                          dtype=torch.bfloat16)))
        checks["load_pretrained_model"] = _states_equal(back, model)
        del back
        _, back, _ = timed("load_from_hf", lambda: builder.load_from_hf(
            hf, hf, run_cfg, projector_path=os.path.join(hf, "mm_projector"),
            dtype=torch.bfloat16, tokenizer=tok))
        checks["load_from_hf"] = _states_equal(back, model)
        del back
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _, q8, _ = timed("load_pretrained_model(int8)", lambda: (
            builder.load_pretrained_model(native, tokenizer=tok,
                                          dtype=torch.bfloat16,
                                          quantize="int8")))
        peak = torch.cuda.max_memory_allocated() - base
        print(f"  int8 load: peak {peak / 1e9:.3f} GB of card memory above "
              f"what was there, quantized_bytes {quantized_bytes(q8) / 1e9:.3f}"
              f" GB (the bf16 model {quantized_bytes(model) / 1e9:.3f} GB)")
        want = quantize_params(model)
        checks["int8 on load == quantize_params"] = _states_equal(q8, want)
        del q8, want
        print(f"  walls s: { {k: round(v, 3) for k, v in walls.items()} }")
        print(f"  byte-equal: {checks}")
        if not all(checks.values()):
            raise SystemExit("phase 16: the checkpoint round trip changed "
                             "bytes")
    del model
    torch.cuda.empty_cache()


def q8_window():
    """Zero the q8 kernel's counter; returns a function giving the launches
    since."""
    from oryx_tpu_torch.ops.cuda import q8_linear

    q8_linear.LAUNCHES.clear()
    return lambda: dict(q8_linear.LAUNCHES)


@contextlib.contextmanager
def q8_twin_guard(calls: list):
    """While inside, every call of the q8 plain twin on a card tensor is
    appended to `calls` (and raises): on the card every int8 product must
    run a kernel."""
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    real = q8.q8_linear_reference

    def guarded(x, q, *args, **kw):
        if x.device.type == "cuda":
            calls.append((tuple(x.shape), tuple(q.shape)))
            raise RuntimeError("q8_linear_reference reached on the card")
        return real(x, q, *args, **kw)

    q8.q8_linear_reference = guarded
    try:
        yield
    finally:
        q8.q8_linear_reference = real


def q8_classes(cfg) -> dict:
    """{(N, K, dtype name): (name, K, output widths, bias, JAX site)} of
    every int8 launch the model makes (N summed over a grouped launch)."""
    from oryx_tpu_torch.ops.cuda import measure

    out = {}
    for proj, (K, Ns, bias) in measure.q8_shapes(cfg.llm).items():
        site = ("oryx_tpu/models/qwen2.py:543" if proj == "lm_head"
                else "oryx_tpu/models/qwen2.py:147")
        out[(sum(Ns), K, "bf16")] = (proj, K, Ns, bias, site)
    H = cfg.llm.hidden_size
    vision = dict(measure.q8_vision_shapes(cfg),
                  projector_fc2=(H, (H,), "bf16"))
    for name, (K, Ns, dt) in vision.items():
        site = ("oryx_tpu/models/oryx_vit.py:126" if name == "patch_embed"
                else "oryx_tpu/models/compressor.py:68"
                if name.startswith("projector")
                else "oryx_tpu/models/oryx_vit.py:105")
        key = (sum(Ns), K, dt)
        if key in out:  # one launch shape, two products
            old = out[key]
            out[key] = (f"{old[0]}/{name}",) + old[1:]
        else:
            out[key] = (name, K, Ns, True, site)
    return out


def q8_row_shapes(launches) -> dict:
    """{(N, K, dtype): [M, ...]}: the row counts of the table for each
    launch class of the main path's runs: M = 4 and 20 (decode, verify)
    where launched, and past SMALL_ROWS the most launched M up to 256 (the
    ragged mix), the most launched M up to 1024 (prefill lanes) and the
    largest M beyond (a whole prefill, the ViT)."""
    by = collections.defaultdict(collections.Counter)
    for (M, N, K, dt), n in launches.items():
        by[(N, K, dt)][M] += n
    rows = {}
    for key, ms in sorted(by.items()):
        pick = [M for M in Q8_ROWS if M in ms]
        for lo, hi in ((64, 256), (256, 1024)):
            band = [(n, -M) for M, n in ms.items() if lo < M <= hi]
            if band:
                pick.append(-max(band)[1])
        big = [M for M in ms if M > 1024]
        if big:
            pick.append(max(big))
        rows[key] = pick
    return rows


def q8_kernel_rows(cfg, launches, gen) -> tuple[list[dict], dict]:
    """Phase 16d: the q8 kernel against its plain twin at the row counts
    `q8_row_shapes` picks from the main path's launches (see the module
    docstring); returns the kernel table's rows, with the launches of
    those (M, N, K, dtype) keys, and {row name: whether its first
    SMALL_ROWS rows get the small route's bits} past SMALL_ROWS rows."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.ops.cuda import q8_linear as q8

    classes = q8_classes(cfg)
    rows, cross = [], {}
    for key, ms in q8_row_shapes(launches).items():
        N, K, dt = key
        if key not in classes:
            raise SystemExit(f"phase 16: an int8 launch of no known product:"
                             f" {key} at M = {ms}")
        proj, _, Ns, bias, site = classes[key]
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        tol = (2e-4, 2e-3) if dt == "f32" else (TOL, TOL)
        for M in ms:
            kw = measure.q8_case(K, Ns, M, bias, gen, dtype)
            r = measure.q8_compare(kw, *tol)
            kern, plain, lib = measure.q8_calls(kw)
            name = f"q8_linear[{proj},{M}]"
            ms_ = measure.cuda_time_ms(kern, 20)
            dev_t = measure.device_ms(kern)
            plain_ms = measure.cuda_time_ms(plain, 10)
            lib_ms = measure.cuda_time_ms(lib, 20)
            bound, by = measure.q8_bound(M, Ns, K, 4 if dt == "f32" else 2)
            n = launches.get((M, N, K, dt), 0)
            p = q8.plan(K, M, dt == "bf16")
            print(f"  {name}: K={K} N={Ns} {dt} {p}: max_abs_err="
                  f"{r['max_abs_err']:.3e} ok={r['within']}; rel L2 vs fp32 "
                  f"witness kernel {r['rel_kernel']:.3e} twin "
                  f"{r['rel_twin']:.3e}; same bits twice {r['same_bits']}, "
                  f"a row's bits independent of M in the route "
                  f"{r['rows_independent']}, grouped == alone "
                  f"{r['grouped_equal']}, first {q8.SMALL_ROWS} rows == "
                  f"small route {r['cross_route']}")
            print(f"    kernel {ms_:.4f} ms (device {dev_t}) | plain "
                  f"{plain_ms:.4f} ms | F.linear {lib_ms:.4f} ms | bound "
                  f"{bound:.4f} ms ({by}) | launches {n}")
            if not (r["within"] and r["finite"]):
                raise SystemExit(f"{name} disagrees with its plain twin")
            if dt == "bf16" and r["rel_kernel"] > NOISE_RATIO * r["rel_twin"]:
                raise SystemExit(f"{name} is further from the fp32 witness "
                                 "than bf16 noise allows")
            if not (r["same_bits"] and r["rows_independent"]
                    and r["grouped_equal"]):
                raise SystemExit(f"{name}: a row's bits changed between "
                                 "launches, with M or in a group")
            if n == 0:
                raise SystemExit(f"{name} was never launched on the int8 "
                                 "path")
            if r["cross_route"] is not None:
                cross[name] = r["cross_route"]
            rows.append({
                "name": name, "route": "cuda",
                "source": "oryx_tpu_torch/csrc/q8_linear.cu",
                # No Pallas kernel: XLA fuses Q8Weight.astype into the dot.
                "replaces": site,
                "launches": n, "max_abs_err": r["max_abs_err"], "ms": ms_,
                "device_ms": dev_t.ms, "plain_ms": plain_ms,
                "bound_ms": bound, "bound_by": by, "library_ms": lib_ms,
            })
    # The tied head (no oryx_7b preset ties it, so not on this path): the
    # int8 table's codes with one scale per column, at lm_head's shape, on
    # both bf16 routes.
    K, Ns, _ = measure.q8_shapes(cfg.llm)["lm_head"]
    for M in Q8_ROWS + (516,):
        kw = measure.q8_case(K, Ns, M, False, gen, column_scale=True)
        r = measure.q8_compare(kw, TOL, TOL)
        kern, plain, _ = measure.q8_calls(kw)
        ms_ = measure.cuda_time_ms(kern, 20)
        plain_ms = measure.cuda_time_ms(plain, 10)
        print(f"  q8_linear[tied_head,{M}] (scales per column): "
              f"max_abs_err={r['max_abs_err']:.3e} ok={r['within']}; rel L2 "
              f"kernel {r['rel_kernel']:.3e} twin {r['rel_twin']:.3e}; same "
              f"bits {r['same_bits']}, rows independent "
              f"{r['rows_independent']} | kernel {ms_:.4f} ms | plain "
              f"{plain_ms:.4f} ms")
        if not (r["within"] and r["finite"] and r["same_bits"]
                and r["rows_independent"]
                and r["rel_kernel"] <= NOISE_RATIO * r["rel_twin"]):
            raise SystemExit(f"q8_linear[tied_head,{M}] disagrees with its "
                             "plain twin")
    return rows, cross


def int8_weights(params, cfg, reqs, bf16_runs, card) -> list[dict]:
    """Phase 16b-d (see the module docstring): phase 2's weights quantized
    with quantize_params through chat_batch and the ragged engine; returns
    the q8 kernel's table rows."""
    from oryx_tpu_torch.ops.cuda import measure
    from oryx_tpu_torch.serve.pipeline import Pipeline
    from oryx_tpu_torch.utils.quant import quantize_params, quantized_bytes

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qparams = quantize_params(params)
    torch.cuda.synchronize()
    print(f"  quantize_params: {time.perf_counter() - t0:.3f} s, "
          f"quantized_bytes {quantized_bytes(qparams)} (bf16 "
          f"{quantized_bytes(params)}), peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB beside the bf16 model ({card})")
    tok = ByteTokenizer()
    qpipe = Pipeline(tok, qparams, cfg, device="cuda")
    # The table's launches: chat_batch run 0 (decode M = 4, the prefill,
    # the ViT and the compressor), the ragged engine's graph route run and
    # the speculative run (the verify rows).
    launches = collections.Counter()
    twin_calls: list = []
    runs = []
    with q8_twin_guard(twin_calls):
        for _ in range(3):
            since = q8_window()
            runs.append(run_main_path(qpipe, reqs, tok))
            runs[-1] = runs[-1] + (since(),)
    for i, (replies, counts, tim, _, _, wall, peak, _, q8n) in enumerate(runs):
        steps = tim["decode_steps"]
        print(f"  int8 run {i}: wall {wall:.3f} s | decode "
              f"{tim['decode_s']:.4f} s ({steps} steps, "
              f"{1e3 * tim['decode_s'] / steps:.3f} ms a step; bf16 phase 3 "
              f"run {i}: {1e3 * bf16_runs[i][2]['decode_s'] / bf16_runs[i][2]['decode_steps']:.3f}"
              f" ms) | capture {tim['capture_s']:.3f} s | peak "
              f"{peak / 1e9:.2f} GB | q8 launches {sum(q8n.values())}")
        if any(gt < 1 for _, gt in counts):
            raise SystemExit("phase 16: an int8 request produced no tokens")
    toks0 = runs[0][3]
    if any(r[3] != toks0 for r in runs[1:]):
        raise SystemExit("phase 16: the int8 runs produced different tokens")
    print("  int8 tokens identical across the 3 runs")
    embeds, lengths, cache_len = mix_embeds(qpipe, reqs)
    etoks, efin, edec, esteps, _ = eager_generate(qpipe, embeds, lengths,
                                                  cache_len)
    if row_tokens(etoks, efin) != toks0:
        raise SystemExit("phase 16: the int8 decode graphs' tokens differ "
                         "from the eager loop's")
    print(f"  int8 graph route == eager witness (byte-equal); eager decode "
          f"{edec:.4f} s ({esteps} steps)")
    agree = total = 0
    for a, b in zip(toks0, bf16_runs[0][3]):
        agree += sum(int(x == y) for x, y in zip(a, b))
        total += max(len(a), len(b))
    print(f"  greedy token agreement int8 vs bf16 (not asserted): "
          f"{agree}/{total}")
    # Every decode step ran each decoder launch through the kernel: q/k/v
    # and gate/up as one grouped launch each.
    steps = runs[0][2]["decode_steps"]
    per_step = collections.Counter()
    for proj, (K, Ns, _) in measure.q8_shapes(cfg.llm).items():
        per_step[(len(reqs), sum(Ns), K)] += (
            1 if proj == "lm_head" else cfg.llm.num_layers)
    q8n = runs[0][8]
    got = collections.Counter()
    for key, n in q8n.items():
        got[key[:3]] += n
    short = {k: (got[k], n * steps) for k, n in per_step.items()
             if got[k] < n * steps}
    if short:
        raise SystemExit(f"phase 16: q8 launches short of one a launch a "
                         f"decode step (got, want): {short}")
    print(f"  q8 launches on run 0 by (M, N, K, dtype): {q8n} (each decoder "
          f"launch at M = {len(reqs)} on all {steps} decode steps)")
    launches.update(q8n)

    # ---- 16c: the ragged engine on the int8 model -------------------------
    spipe = Pipeline(ByteTokenizer(), qparams, cfg, device="cuda")
    eng = []
    with q8_twin_guard(twin_calls):
        for eager in (True, False):
            since = q8_window()
            eng.append(run_scheduler(spipe, True, record=False, eager=eager))
            eng[-1]["q8"] = since()
            check_serving_run("ragged", len(eng) - 1, eng[-1])
        # The verify shape: speculate=k (NgramDrafter), S(1 + k) rows.
        since = q8_window()
        spec = run_scheduler(spipe, True, record=False, speculate=SPEC_K)
        spec["q8"] = since()
    if eng[1]["results"] != eng[0]["results"]:
        raise SystemExit("phase 16: the int8 ragged engine's graph route "
                         "differs from its eager witness")
    big = {k: n for k, n in eng[1]["q8"].items() if k[0] > 128}
    print(f"  int8 ragged graph route == eager witness (byte-equal): walls "
          f"{eng[1]['wall']:.3f} vs {eng[0]['wall']:.3f} s, tails "
          f"{eng[1]['tail']:.3f} vs {eng[0]['tail']:.3f} s; q8 launches "
          f"{sum(eng[1]['q8'].values())}, of more than 128 rows "
          f"{sum(big.values())}")
    print(spec_line(f"int8 ragged engine, speculate={SPEC_K}, NgramDrafter",
                    spec))
    if twin_calls:
        raise SystemExit(f"phase 16: {len(twin_calls)} int8 products went "
                         f"to the plain twin on the card: {twin_calls[:4]}")
    print("  no int8 product of phase 16's runs took the plain twin on the "
          "card")
    launches.update(eng[1]["q8"])
    launches.update(spec["q8"])
    if not any(k[0] == Q8_ROWS[1] for k in spec["q8"]):
        raise SystemExit(f"phase 16: no q8 launch at the {Q8_ROWS[1]}-row "
                         f"verify shape: {spec['q8']}")
    del qpipe, spipe, qparams
    torch.cuda.empty_cache()

    # ---- 16d: the q8 kernel at the main path's launch shapes --------------
    print(f"  q8_linear vs plain twin (bf16 atol=rtol={TOL}, fp32 atol 2e-4 "
          f"rtol 2e-3) at the main path's launch shapes ({card})")
    rows, cross = q8_kernel_rows(cfg, launches,
                                 torch.Generator("cuda").manual_seed(6))
    print(f"  a row's bits on the wgmma route == on the small route (first "
          f"64 rows; reported, not required): {cross}")
    return rows


# ---- training (phases 9-11) ------------------------------------------------

TRAIN_STEPS = 4
TRAIN_BATCH = 4
TRAIN_CONFIG = "scripts/configs/oryx_7b_pretrain.json"
TRAIN_CKPT = "checkpoints/chip_smoke"


def train_records():
    """8 pretraining records: 4 single images of 616x616 (44 x 44 = 1,936
    patches, 1x compression) and 4 videos of 8 frames of 224x224 (256
    patches a frame, 16x compression); each caption is supervised."""
    recs = []
    for i in range(4):
        recs.append({"id": f"img{i}", "image": f"img{i}.jpg", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"A photo of {i + 2} boats on a calm "
                                     "grey sea under a low sky."},
        ]})
        recs.append({"id": f"vid{i}", "video": f"vid{i}.mp4", "conversations": [
            {"from": "human", "value": "<image>"},
            {"from": "gpt", "value": f"A clip of {i + 2} gulls circling a "
                                     "harbour at dusk."},
        ]})
    return recs


def train_media(rec):
    """Random uint8 pixels seeded by the record id."""
    rng = np.random.default_rng(sum(map(ord, rec["id"])))
    if rec.get("video"):
        return [rng.integers(0, 256, (224, 224, 3), np.uint8)
                for _ in range(8)]
    return [rng.integers(0, 256, (616, 616, 3), np.uint8)]


def train_config():
    """oryx_7b_pretrain.json at TRAIN_BATCH records a batch and TRAIN_STEPS
    steps (its LR schedule over those steps, as the training CLI reads the
    same file in phase 22 (b)), with its checkpoints inside the checkout
    (listed in .gitignore, removed after the phase)."""
    from oryx_tpu_torch import config

    with open(TRAIN_CONFIG) as f:
        cfg = config.OryxConfig.from_json(f.read())
    # One card: the file's fsdp=16 mesh would need sixteen ranks.
    return dataclasses.replace(cfg, mesh=config.MeshConfig(),
                               train=dataclasses.replace(
        cfg.train, global_batch_size=TRAIN_BATCH,
        num_train_steps=TRAIN_STEPS, checkpoint_dir=TRAIN_CKPT,
    ))


def train_batches(cfg, records=None, media=train_media, batch=TRAIN_BATCH,
                  template="plain", **collate):
    """grouped_batch_iterator over the records (endless epochs)."""
    from oryx_tpu_torch.train import data

    ds = data.SupervisedDataset(
        records or train_records(), ByteTokenizer(), template=template,
        max_patches_per_image=cfg.vision.max_patches_per_image,
        media_loader=media,
    )
    kw = dict(patch_size=cfg.vision.patch_size,
              base_grid=cfg.vision.base_grid, max_len=cfg.train.max_seq_len)
    kw.update(collate)
    return data.grouped_batch_iterator(ds, batch, seed=cfg.train.seed, **kw)


def training_attention_cases(cfg, host, host_vid, gen):
    """Three flash-attention call shapes of the training steps, with the
    packing metadata of the collated batches and random bf16 q/k/v: the
    ViT and the decoder of the image batch `host`, the compressor of the
    video batch `host_vid` (4 x 4-patch regions; on the image batch each
    region is one patch and the call has the ViT's launch key). Returns
    (name, flash_attention kwargs with q, k, v)."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    seg = t(host["segment_ids"])[None]
    reg, qreg = (t(host_vid[k])[None] for k in ("region_ids", "q_region_ids"))
    P, Q, Pc = seg.shape[1], qreg.shape[1], reg.shape[1]
    B, T = host["token_ids"].shape
    pos, amask = t(host["positions"]), t(host["attn_mask"])
    hv, dv = cfg.vision.num_heads, cfg.vision.head_dim
    hc = cfg.compressor.num_heads
    dc = cfg.vision.hidden_size // hc
    hq, hk, d = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    print(f"  training shapes: ViT {P} patches ({int((seg > 0).sum())} "
          f"real), compressor {Q} queries ({int((qreg > 0).sum())} real) "
          f"vs {Pc} patches, decoder {B} x {T} (rows "
          f"{amask.sum(1).tolist()})")
    return [
        ("vit", dict(q=rnd(1, P, hv, dv), k=rnd(1, P, hv, dv),
                     v=rnd(1, P, hv, dv), causal=False, q_segment_ids=seg,
                     kv_segment_ids=seg)),
        ("compressor", dict(q=rnd(1, Q, hc, dc), k=rnd(1, Pc, hc, dc),
                            v=rnd(1, Pc, hc, dc), causal=False,
                            q_segment_ids=qreg, kv_segment_ids=reg)),
        ("decoder", dict(q=rnd(B, T, hq, d), k=rnd(B, T, hk, d),
                         v=rnd(B, T, hk, d), causal=True, q_positions=pos,
                         kv_positions=pos, kv_mask=amask,
                         slot_positions=True)),
    ]


def _visibility(args, flags):
    """[B, Tq, Tk] bool: which keys each query sees."""
    _, _, _, q_pos, kv_pos, q_seg, kv_seg, kv_valid = args
    vis = (kv_valid[:, None, :] > 0).expand(-1, q_pos.shape[1], -1)
    if flags["causal"]:
        vis = vis & (q_pos[:, :, None] >= kv_pos[:, None, :])
    if flags["has_segments"]:
        vis = vis & (q_seg[:, :, None] == kv_seg[:, None, :])
    return vis


def _rel(a, w):
    return float((a.float() - w).norm() / w.norm())


def check_backward_case(name, kw, gen):
    """K1 with lse, K5a and K5b vs their plain twins at one call shape;
    returns (launch key, [three table rows])."""
    from oryx_tpu_torch.ops.cuda.measure import (
        PEAK_BYTES, PEAK_FLOPS, cuda_time_ms, device_ms,
    )
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    q, k, v = kw["q"], kw["k"], kw["v"]
    rest = {x: y for x, y in kw.items() if x not in ("q", "k", "v")}
    args, flags = fa._prepare(
        q, k, v, rest.get("q_positions"), rest.get("kv_positions"),
        rest.get("q_segment_ids"), rest.get("kv_segment_ids"),
        rest.get("kv_mask"), rest["causal"], None,
        rest.get("slot_positions", False),
    )
    mask = _visibility(args, flags)
    keep = mask.any(-1)  # [B, Tq]
    do = (torch.randn(q.shape, generator=gen, device=q.device)
          * keep[:, :, None, None]).to(torch.bfloat16)
    dot = do.transpose(1, 2)
    qkv, ints = args[:3], args[3:]

    def delta_of(o, g):
        return torch.einsum("bhqd,bhqd->bhq", g.float(), o.float()).contiguous()

    # The kernels, the bf16 twins, and the fp32 witness on the same inputs.
    o, lse = fa._mha_forward(*args, **flags, with_lse=True)
    delta = delta_of(o, dot)
    dq = fa._mha_backward_dq(*qkv, dot, lse, delta, *ints, **flags)
    dk, dv = fa._mha_backward_dkv(*qkv, dot, lse, delta, *ints, **flags)
    ro, rlse = fa._mha_forward_reference(*args, **flags, with_lse=True)
    plain = fa._mha_backward_reference(*qkv, dot, rlse, delta_of(ro, dot),
                                       *ints, **flags)
    f32 = [x.float() for x in qkv]
    fo, flse = fa._mha_forward_reference(*f32, *ints, **flags, with_lse=True)
    witness = fa._mha_backward_reference(*f32, dot.float(), flse,
                                         delta_of(fo, dot), *ints, **flags)
    torch.cuda.synchronize()
    g, r = o.transpose(1, 2)[keep].float(), ro.transpose(1, 2)[keep].float()
    err = (g - r).abs()
    kl = keep[:, None, :].expand(lse.shape)
    lse_err = float((lse[kl] - rlse[kl]).abs().max())
    ok = (bool((err <= TOL + TOL * r.abs()).all())
          and bool(torch.isfinite(g).all()) and lse_err <= 1e-3)
    print(f"  {name}: q {tuple(q.shape)} k {tuple(k.shape)}, rows with a "
          f"visible key {int(keep.sum())}/{keep.numel()}")
    print(f"    K1+lse: out max_abs_err={float(err.max()):.3e}, lse "
          f"max_abs_err={lse_err:.3e} ok={ok}")
    if not ok:
        raise SystemExit(f"K1 with lse disagrees with its twin on {name}")
    errs, ulps = {}, {}
    for gname, a, p_, w in zip(("dq", "dk", "dv"), (dq, dk, dv), plain,
                               witness):
        ek, ep = _rel(a, w), _rel(p_, w)
        mabs = float((a.float() - p_.float()).abs().max())
        # In bf16 ulps of the reference's largest magnitude (8 mantissa
        # bits: one ulp at magnitude m is 2^(floor(log2 m) - 7)).
        mag = float(p_.float().abs().max())
        ulp = 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 1.0
        errs[gname], ulps[gname] = mabs, mabs / ulp
        good = (ek <= NOISE_RATIO * ep and bool(torch.isfinite(a).all())
                and a.dtype == q.dtype)
        print(f"    {gname}: rel L2 vs fp32 witness kernel {ek:.3e}, plain "
              f"{ep:.3e} (limit {NOISE_RATIO}x); max abs err vs plain "
              f"{mabs:.3e} = {mabs / ulp:.2f} bf16 ulps of max |plain| "
              f"{mag:.3e}; ok={good}")
        if not good:
            raise SystemExit(f"K5 {gname} on {name} is further from the fp32 "
                             "witness than bf16 noise allows")

    def k1():
        return fa._mha_forward(*args, **flags, with_lse=True)

    def k5a():
        return fa._mha_backward_dq(*qkv, dot, lse, delta, *ints, **flags)

    def k5b():
        return fa._mha_backward_dkv(*qkv, dot, lse, delta, *ints, **flags)

    ms_fwd, ms_dq, ms_dkv = (cuda_time_ms(f, iters=10) for f in (k1, k5a, k5b))
    dev = {kind: device_ms(f) for kind, f in
           (("fwd", k1), ("dq", k5a), ("dkv", k5b))}
    plain_fwd = cuda_time_ms(lambda: fa._mha_forward_reference(
        *args, **flags, with_lse=True), iters=3, warmup=1)
    plain_bwd = cuda_time_ms(lambda: fa._mha_backward_reference(
        *qkv, dot, rlse, delta, *ints, **flags), iters=3, warmup=1)
    # Yardsticks: SDPA with an explicit boolean mask, k/v repeated to the q
    # heads outside the timed calls; forward, and forward + backward.
    qp, kp, vp = qkv
    B, Hq, Tq, D = qp.shape
    Hk, Tk = kp.shape[1], kp.shape[2]
    G = Hq // Hk
    m4 = mask[:, None]
    kr = kp.repeat_interleave(G, dim=1)
    vr = vp.repeat_interleave(G, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_fwd = cuda_time_ms(lambda: sdpa(qp, kr, vr, attn_mask=m4,
                                        scale=flags["scale"]), iters=10)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qp, kr, vr))

    def sdpa_fwd_bwd():
        out = sdpa(qg, kg, vg, attn_mask=m4, scale=flags["scale"])
        return torch.autograd.grad(out, (qg, kg, vg), dot)

    lib_bwd = cuda_time_ms(sdpa_fwd_bwd, iters=5)
    # Least time, from this run's data: per visible (q head, kv) pair 4 D
    # flops forward, 6 D for dq (s, dp, dq), 8 D for dk/dv (s, dp, dv, dk);
    # bytes: the q-side tensors once, k/v rows some query sees once, the
    # int operands once, dk/dv written whole.
    pairs = int(mask.sum())
    kv_rows = int(mask.any(1).sum())
    ints_b = sum(x.numel() * 4 for x in ints)
    qside = qp.numel() * 2
    rows_b = B * Hq * Tq * 4  # one fp32 per q row and head (lse or delta)
    kv_b = kv_rows * Hk * D * 2
    work = {
        "fwd": (4.0 * D * Hq * pairs, 2 * qside + 2 * kv_b + rows_b + ints_b),
        "dq": (6.0 * D * Hq * pairs,
               3 * qside + 2 * rows_b + 2 * kv_b + ints_b),
        "dkv": (8.0 * D * Hq * pairs,
                2 * qside + 2 * rows_b + 2 * kv_b + 2 * B * Tk * Hk * D * 2
                + ints_b),
    }
    key = (flags["causal"], flags["has_segments"], B, Hq, Hk, Tq, Tk, D)
    rows = []
    for kind, label, ms, plain_ms, lib_ms, mabs, replaces, src in (
        ("fwd", "flash_fwd_lse", ms_fwd, plain_fwd, lib_fwd,
         float(err.max()), "oryx_tpu/ops/pallas/flash_attention.py:206",
         "flash_attention.cu"),
        ("dq", "flash_bwd_dq", ms_dq, plain_bwd, lib_bwd, errs["dq"],
         "oryx_tpu/ops/pallas/flash_attention.py:508",
         "flash_attention_bwd.cu"),
        ("dkv", "flash_bwd_dkv", ms_dkv, plain_bwd, lib_bwd,
         max(errs["dk"], errs["dv"]),
         "oryx_tpu/ops/pallas/flash_attention.py:553",
         "flash_attention_bwd.cu"),
    ):
        flops, nbytes = work[kind]
        t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        print(f"    {label}: kernel {ms:.4f} ms (device {dev[kind]}) "
              f"| plain {plain_ms:.4f} ms | "
              f"sdpa {'fwd' if kind == 'fwd' else 'fwd+bwd'} {lib_ms:.4f} ms"
              f" | bound {bound:.4f} ms ({flops / 1e9:.2f} "
              f"GFLOP, {nbytes / 1e6:.2f} MB)")
        if kind != "fwd":
            worst = max(("dk", "dv") if kind == "dkv" else ("dq",),
                        key=lambda x: errs[x])
            print(f"      {flops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.1%} of "
                  f"its bound; sdpa backward alone (fwd+bwd - fwd) "
                  f"{lib_bwd - lib_fwd:.4f} ms; max abs err "
                  f"{ulps[worst]:.2f} bf16 ulps ({worst})")
        rows.append({
            "name": f"{label}[{name}]",
            "route": "cuda",
            "source": f"oryx_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": 0,
            "max_abs_err": mabs,
            "ms": ms,
            "device_ms": dev[kind].ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib_ms,
        })
    print(f"    K5a + K5b {ms_dq + ms_dkv:.4f} ms vs sdpa backward alone "
          f"{lib_bwd - lib_fwd:.4f} ms")
    return key, rows


def _flash_counters():
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    return {"fwd": fa.LAUNCHES, "flash_fwd_lse": fa.LAUNCHES_LSE,
            "flash_bwd_dq": fa.LAUNCHES_DQ, "flash_bwd_dkv": fa.LAUNCHES_DKV}


def fit_once(cfg_t, params):
    """One Trainer.fit of TRAIN_STEPS steps; launch counts zeroed just
    before and read just after. Returns (trainer, launches, wall)."""
    from oryx_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg_t, params=params, device="cuda")
    counters = _flash_counters()
    for c in counters.values():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(train_batches(cfg_t), num_steps=TRAIN_STEPS, resume=False,
                prefetch=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(c) for k, c in counters.items()}
    for i, h in enumerate(trainer.history):
        print(f"    step {i + 1}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} | wall {h['wall_s']:.3f} s, "
              f"{h['tokens'] / h['wall_s']:.0f} tokens/s "
              f"({h['tokens']} tokens), {h['num_tokens'] / h['wall_s']:.0f} "
              f"supervised/s ({int(h['num_tokens'])}) | device fwd+bwd "
              f"{h['fwd_bwd_ms']:.1f} ms, optimizer {h['optimizer_ms']:.2f}"
              f" ms | data {h['data_s']:.3f} s, h2d {h['h2d_s']:.3f} s | "
              f"peak {h['peak_bytes'] / 1e9:.2f} GB")
    return trainer, launches, wall


def train_full_size(cfg_t, params, host_img, train_rows, card) -> None:
    """Phase 10 (see the module docstring); fills the launches of
    train_rows from the first fit."""
    import shutil

    from oryx_tpu_torch.train import step as step_lib

    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    names = [n for n, _ in params.named_parameters()]
    comp = [n for n in names if n.startswith("compressor.")]
    frozen = [n for n in names if not n.startswith("compressor.")]
    t0 = time.perf_counter()
    snap = {n: p.detach().cpu() for n, p in params.named_parameters()
            if n in frozen}
    init = {n: p.detach().float().clone() for n, p in
            params.named_parameters() if n in comp}
    print(f"  host snapshot of {len(frozen)} frozen leaves "
          f"({sum(x.numel() for x in snap.values()) / 1e9:.2f} B params) in "
          f"{time.perf_counter() - t0:.1f} s; {len(comp)} compressor leaves "
          f"train ({sum(x.numel() for x in init.values()) / 1e6:.1f} M)")
    print("  fit 1:")
    trainer, launches, wall = fit_once(cfg_t, params)
    losses = [h["loss"] for h in trainer.history]
    print(f"  fit 1: wall {wall:.2f} s, losses {losses}, grad norms "
          f"{[h['grad_norm'] for h in trainer.history]}")
    if not all(np.isfinite(losses)):
        raise SystemExit("non-finite training loss")
    # Fit 2 from the same init is the training CLI (phase 22 (b)): the same
    # records through its JSON and PNG files, with the telemetry, the flight
    # recorder and the numerics probes armed; it must give fit 1's bits.
    with torch.no_grad():
        for n, p in params.named_parameters():
            if n in init:
                p.copy_(init[n])
    phase_begin("22 (b)")
    print(f"phase 22 (b): fit 2 of phase 10 through the training CLI "
          f"(train/cli.main), --metrics-port 0, --events-path, "
          f"--numerics-every 2, a checkpoint every step ({card})",
          flush=True)
    t2 = cli_fit(params, trainer.history, launches, card)
    phase_begin("10 (continued)")
    cur = dict(params.named_parameters())
    changed = [n for n in comp if not torch.equal(cur[n].float(), init[n])]
    if not changed:
        raise SystemExit("the compressor did not change")
    for n in frozen:
        if not torch.equal(cur[n].detach().cpu(), snap[n]):
            raise SystemExit(f"frozen leaf {n} changed")
    print(f"  frozen leaves bitwise unchanged; {len(changed)}/{len(comp)} "
          f"compressor leaves changed (lr(0) = 0: step 1 moves nothing)")
    for key, case_rows in train_rows:
        for row in case_rows:
            kind = row["name"].split("[")[0]
            row["launches"] = launches[kind].get(key, 0)
            print(f"  launches {row['name']}: {row['launches']}")
            if row["launches"] == 0:
                raise SystemExit(f"{row['name']} was never launched by the "
                                 "training step")
    print("  launches in the fit, all shapes: " + ", ".join(
        f"{k} {sum(v.values())}" for k, v in launches.items()))
    print("  one more step (the image batch) under torch.profiler:")
    batch = t2._device_batch(host_img)
    fams, wall_us, _ = profile_call(
        lambda: step_lib.train_step(t2.state, batch, cfg_t, t2.tx))
    k5 = fams[kernel_family("flash_bwd")]
    k1 = fams[kernel_family("flash_fwd")]
    print(f"  K5a + K5b in the traced image step: {k5 / 1e3:.1f} ms, "
          f"{k5 / sum(fams.values()):.1%} of its device time, "
          f"{k5 / wall_us:.1%} of its wall; K1 {k1 / 1e3:.1f} ms, "
          f"{k1 / sum(fams.values()):.1%}; the cell maps "
          f"{fams[kernel_family('tile_map')] / 1e3:.1f} ms")
    del trainer, t2, batch
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    return snap


def tiny_training_on_card(tune: str = "full") -> None:
    """Phase 11 (and 17 with tune "lora"): the tiny fp32 config, 3 steps
    of Trainer.fit on the card and on the CPU from the same init and
    batches: losses within rtol 1e-4, params within atol 2e-4 / rtol 2e-3
    (lr 1e-5, so Adam's 1/sqrt(v) on near-zero gradient entries moves no
    param by more than 2e-5). Under "lora" the Trainer attaches r = 4
    adapters to all seven projections on each device from the same seed
    (drawn on the CPU and moved)."""
    import shutil

    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train.trainer import Trainer

    base = config.oryx_tiny()
    cfg = dataclasses.replace(base, attn_impl="pallas", train=dataclasses.replace(
        base.train, tune=tune, learning_rate=1e-5, num_train_steps=10,
        warmup_ratio=0.1, remat_policy="attn",
        checkpoint_dir=TRAIN_CKPT + "_tiny",
        lora=config.LoraConfig(enable=tune == "lora", r=4, alpha=8.0,
                               targets=LORA_TARGETS),
    ))
    recs = [dict(r, conversations=[
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": f"caption {i}"},
    ]) for i, r in enumerate(train_records())]

    def small(rec):
        return [x[:42, :56] for x in train_media(rec)][:4]

    out = {}
    counters = _flash_counters()
    for dev in ("cpu", "cuda"):
        shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
        for c in counters.values():
            c.clear()
        model = oryx.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        if tune == "lora":
            oryx.enable_lora(model, cfg, torch.Generator().manual_seed(1))
            g = torch.Generator().manual_seed(2)
            with torch.no_grad():  # B = 0 would leave A's gradient zero
                for n, p in model.named_parameters():
                    if n.endswith("lora_b"):
                        p.normal_(0.0, 0.05, generator=g)
        model = model.to(dev)
        t = Trainer(cfg, params=model, device=dev)
        t.fit(train_batches(cfg, recs, small, batch=2,
                            buckets=(64, 128, 256)),
              num_steps=3, resume=False, prefetch=0)
        out[dev] = ([h["loss"] for h in t.history],
                    {n: p.detach().cpu() for n, p in
                     model.named_parameters()})
        if dev == "cuda":
            bwd = {k: sum(c.values()) for k, c in counters.items()}
    shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
    print(f"  losses card {out['cuda'][0]} cpu {out['cpu'][0]}; kernel "
          f"launches on the card {bwd}")
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    worst = 0.0
    for n, p in out["cpu"][1].items():
        q = out["cuda"][1][n]
        torch.testing.assert_close(q, p, atol=2e-4, rtol=2e-3)
        worst = max(worst, float((q - p).abs().max()))
    if not (bwd["flash_bwd_dq"] and bwd["flash_bwd_dkv"]
            and bwd["flash_fwd_lse"]):
        raise SystemExit("the tiny training run launched no K5")
    print(f"  card == cpu within tolerance; params max abs diff {worst:.3e}")

# ---- LoRA SFT and packed text at full width (phases 17-18) ----------------

LORA_CONFIG = "scripts/configs/oryx_7b_sft_lora.json"
LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                "up_proj", "down_proj")
REMAT_POLICIES = ("none", "block", "dots", "attn", "attn_qkv", "attn_o")
UNFIT_BATCH = 1  # records a batch for a policy that does not fit at 4
# Decoder layers of phase 17's remat-policy fits (full width; the run's
# time limit: 28 layers cost ~120 s over the eight fits and their saves,
# and phases 24 (f) and 25 (f) share what is left).
REMAT_LAYERS = 2
PACK_BUCKET = 4096
PACK_ROWS = 4
PACK_LENGTHS = (64, 1500)  # tokens of a packed text sample, drawn uniformly


def lora_config():
    """oryx_7b_sft_lora.json as written (r = 128, alpha 256, seven targets,
    remat "attn"), checkpoints inside the checkout; the batch (128 -> 4)
    and the steps (5000 -> 4) are cut by the callers; one card's mesh."""
    from oryx_tpu_torch import config

    with open(LORA_CONFIG) as f:
        cfg = config.OryxConfig.from_json(f.read())
    return dataclasses.replace(cfg, mesh=config.MeshConfig(),
                               train=dataclasses.replace(
        cfg.train, checkpoint_dir=TRAIN_CKPT + "_lora"))


def sft_records():
    """train_records() as conversations: a question about each image or
    video, a supervised answer. Through the plain template, as phase 10,
    the batches keep phase 10's shapes (the image batch 4 x 2048)."""
    return [dict(r, conversations=[
        {"from": "human", "value": "<image>\nWhat does this show?"},
        r["conversations"][1],
    ]) for r in train_records()]


def _peak_gb(history) -> float:
    return max(h["peak_bytes"] for h in history) / 1e9


def _print_steps(history, card) -> None:
    for i, h in enumerate(history):
        mfu = h.get("mfu")
        print(f"    step {i + 1}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} | wall {h['wall_s']:.3f} s, "
              f"{h['tokens'] / h['wall_s']:.0f} tokens/s ({h['tokens']} "
              f"tokens) | model {h['model_flops'] / 1e12:.2f} TFLOP, MFU "
              f"{'not known' if mfu is None else f'{mfu:.1%}'} | device "
              f"fwd+bwd {h['fwd_bwd_ms']:.1f} ms, optimizer "
              f"{h['optimizer_ms']:.2f} ms | peak "
              f"{h['peak_bytes'] / 1e9:.2f} GB ({card})")


class LoraFits:
    """Fits of one full-width model with adapters, each from the same
    start: the adapters and the compressor are put back before each."""

    def __init__(self, cfg, params) -> None:
        from oryx_tpu_torch.models import oryx

        self.cfg, self.params = cfg, params
        # The adapters the Trainer would attach (seed + 1, on the card).
        oryx.enable_lora(params, cfg, torch.Generator("cuda").manual_seed(
            cfg.train.seed + 1))
        self.init = {n: p.detach().float().clone()
                     for n, p in params.named_parameters()
                     if "lora_" in n or n.startswith("compressor.")}

    def fit(self, batches, cfg=None, steps=TRAIN_STEPS):
        """One Trainer.fit from the start; flash launch counts zeroed just
        before and read just after. (history, launches)."""
        import shutil

        from oryx_tpu_torch.train.trainer import Trainer

        cfg = cfg or self.cfg
        with torch.no_grad():
            for n, p in self.params.named_parameters():
                if n in self.init:
                    p.copy_(self.init[n])
        shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
        trainer = Trainer(cfg, params=self.params, device="cuda")
        counters = _flash_counters()
        for c in counters.values():
            c.clear()
        try:
            trainer.fit(batches, num_steps=steps, resume=False, prefetch=2)
        finally:
            trainer.close()
            shutil.rmtree(cfg.train.checkpoint_dir, ignore_errors=True)
        return trainer.history, {k: dict(c) for k, c in counters.items()}


def lora_sft(cfg_l, params, snap, card):
    """Phase 17 (a, b): two LoRA fits, then one fit under each remat
    policy. Returns the LoraFits."""
    fits = LoraFits(cfg_l, params)
    lora = cfg_l.train.lora
    n_ad = sum(v.numel() for n, v in fits.init.items() if "lora_" in n)
    print(f"  adapters r = {lora.r} (alpha {lora.alpha}, scale "
          f"{lora.scaling}) on {list(lora.targets)}: {n_ad / 1e6:.1f} M "
          f"parameters; batch {TRAIN_BATCH} (config "
          f"{cfg_l.train.global_batch_size}), {TRAIN_STEPS} steps (config "
          f"{cfg_l.train.num_train_steps}), remat {cfg_l.train.remat_policy}")
    runs = []
    for run in range(2):
        t0 = time.perf_counter()
        hist, launches = fits.fit(
            train_batches(cfg_l, sft_records()))
        losses = [h["loss"] for h in hist]
        print(f"  fit {run + 1}: wall {time.perf_counter() - t0:.2f} s, "
              f"losses {losses}, peak {_peak_gb(hist):.2f} GB")
        _print_steps(hist, card)
        if not all(np.isfinite(losses)):
            raise SystemExit("non-finite LoRA loss")
        if not (launches["flash_fwd_lse"] and launches["flash_bwd_dq"]
                and launches["flash_bwd_dkv"]):
            raise SystemExit(f"the LoRA fit launched no K1/K5: {launches}")
        runs.append(losses)
    if runs[1] != runs[0]:
        raise SystemExit(f"a second LoRA fit gave other losses: {runs}")
    print("  the second fit from the same start gave identical losses")
    cur = dict(params.named_parameters())
    for n, want in snap.items():
        if not torch.equal(cur[n].detach().cpu(), want):
            raise SystemExit(f"base leaf {n} changed")
    moved = {n for n, v in fits.init.items()
             if not torch.equal(cur[n].detach().float(), v)}
    bad = [n for n in moved if n.endswith("lora_scale")]
    if bad or not any(n.endswith("lora_b") for n in moved) or not any(
            n.endswith("lora_a") for n in moved):
        raise SystemExit(f"moved leaves: lora_scale {bad[:3]}, "
                         f"{len(moved)} moved")
    print(f"  every base leaf bitwise unchanged ({len(snap)} leaves); "
          f"moved: {sum(n.endswith('lora_a') for n in moved)} lora_a, "
          f"{sum(n.endswith('lora_b') for n in moved)} lora_b, "
          f"{sum(n.startswith('compressor.') for n in moved)} compressor "
          "leaves; lora_scale unchanged")
    # The policies at a cut depth: a random full-width model (seed 0) of
    # REMAT_LAYERS decoder layers with its own adapters, every policy from
    # the same start, held to the config's policy ("attn").
    from oryx_tpu_torch.models import oryx

    cfg_r = dataclasses.replace(cfg_l, llm=dataclasses.replace(
        cfg_l.llm, num_layers=REMAT_LAYERS))
    shallow = LoraFits(cfg_r, oryx.init_params(
        cfg_r, torch.Generator("cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16))
    print(f"  one fit under each remat policy (same start, same batches), "
          f"the decoder cut to {REMAT_LAYERS} of {cfg_l.llm.num_layers} "
          f"layers at full width:")
    losses, unfit = {}, []
    for policy in REMAT_POLICIES:
        cfg_p = dataclasses.replace(cfg_r, train=dataclasses.replace(
            cfg_r.train, remat=policy != "none",
            remat_policy="block" if policy == "none" else policy))
        try:
            hist, _ = shallow.fit(train_batches(cfg_p, sft_records()),
                                  cfg_p)
        except torch.cuda.OutOfMemoryError:
            hist = None
        if hist is None:  # the failed fit's tensors are free from here
            gc.collect()
            torch.cuda.empty_cache()
            print(f"    {policy}: does not fit in "
                  f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}"
                  f" GB at batch {TRAIN_BATCH} ({card})")
            unfit.append(cfg_p)
            continue
        losses[policy] = [h["loss"] for h in hist]
        walls = [round(h["wall_s"], 3) for h in hist]
        print(f"    {policy}: peak {_peak_gb(hist):.2f} GB, step walls "
              f"{walls} s, device fwd+bwd "
              f"{[round(h['fwd_bwd_ms'], 1) for h in hist]} ms, losses "
              f"{losses[policy]} ({card})")
    if "attn" not in losses or any(
            v != losses["attn"] for v in losses.values()):
        raise SystemExit(f"remat policies gave other losses: {losses}")
    print(f"  losses identical across the {len(losses)} policies that fit "
          f"({sorted(losses)})")
    # A policy that does not fit at TRAIN_BATCH is held against "attn" at
    # UNFIT_BATCH records a batch.
    for cfg_p in unfit:
        small = {}
        for c in (cfg_p, cfg_r):
            hist, _ = shallow.fit(train_batches(c, sft_records(),
                                                batch=UNFIT_BATCH), c)
            small[c.train.remat_policy if c.train.remat else "none"] = (
                [h["loss"] for h in hist], _peak_gb(hist))
        print(f"    at batch {UNFIT_BATCH}: {small}")
        (a, _), (b, _) = small.values()
        if a != b:
            raise SystemExit(f"remat policies gave other losses at batch "
                             f"{UNFIT_BATCH}: {small}")
    del shallow
    gc.collect()
    torch.cuda.empty_cache()
    return fits


def packed_records(n_rows, seed):
    """Seeded text conversations whose token counts (ByteTokenizer, qwen
    template) fall in PACK_LENGTHS, as many as pack into n_rows rows of
    PACK_BUCKET (first fit decreasing)."""
    rng = np.random.default_rng(seed)
    words = ("harbour", "gull", "boat", "tide", "rope", "sail", "pier",
             "wave", "net", "mast", "fog", "dock")
    recs, total = [], 0
    while total < 0.85 * n_rows * PACK_BUCKET:
        n = int(rng.integers(*PACK_LENGTHS))
        text = " ".join(rng.choice(words, size=n // 5 + 1))[: max(1, n - 60)]
        cut = len(text) // 3
        recs.append({"id": f"t{seed}_{len(recs)}", "conversations": [
            {"from": "human", "value": text[:cut]},
            {"from": "gpt", "value": text[cut:]},
        ]})
        total += n
    return recs


def packed_batches(cfg, steps):
    """`steps` packed batches ([PACK_ROWS, PACK_BUCKET]) of seeded text,
    and the examples of the first."""
    from oryx_tpu_torch.train import data

    out, first = [], None
    for i in range(steps):
        ds = data.SupervisedDataset(packed_records(PACK_ROWS, 100 + i),
                                    ByteTokenizer(), template="qwen")
        exs = [ds[j] for j in range(len(ds))]
        while True:
            try:
                host = data.collate_packed_text(
                    exs, bucket=PACK_BUCKET, num_rows=PACK_ROWS,
                    patch_size=cfg.vision.patch_size,
                    base_grid=cfg.vision.base_grid)
                break
            except ValueError:
                exs = exs[:-1]
        out.append(host)
        first = first or exs
    return out, first


def packed_kernel_case(cfg, host, gen):
    """K1/K5's call shape in the packed decoder: slot positions, the
    samples' segment ids, the kv mask segs > 0, random bf16 q/k/v."""
    dev = torch.device("cuda")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    segs = torch.from_numpy(host["text_segment_ids"]).to(dev)
    B, T = segs.shape
    pos = torch.arange(T, device=dev).expand(B, T)
    hq, hk, d = cfg.llm.num_heads, cfg.llm.num_kv_heads, cfg.llm.head_dim
    return dict(q=rnd(B, T, hq, d), k=rnd(B, T, hk, d), v=rnd(B, T, hk, d),
                causal=True, q_positions=pos, kv_positions=pos,
                q_segment_ids=segs, kv_segment_ids=segs,
                kv_mask=(segs > 0).to(torch.int32), slot_positions=True)


def packed_training(fits, cfg_l, card, gen):
    """Phase 18 (see the module docstring). Returns the three kernel
    rows."""
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.train import data
    from oryx_tpu_torch.train import step as step_lib

    hosts, exs = packed_batches(cfg_l, TRAIN_STEPS)
    h0 = hosts[0]
    segs = h0["text_segment_ids"]
    lens = [int((segs[r] == s).sum()) for r in range(segs.shape[0])
            for s in range(1, int(segs[r].max()) + 1)]
    print(f"  {len(lens)} samples of {min(lens)}-{max(lens)} tokens in "
          f"{segs.shape[0]} x {segs.shape[1]} ({int((segs > 0).sum())} real "
          f"tokens, {sum(int(h['attn_mask'].sum()) for h in hosts)} over the "
          f"{len(hosts)} batches); per row {[int(x) for x in segs.max(1)]} "
          "samples")
    key, rows = check_backward_case(
        "decoder_packed", packed_kernel_case(cfg_l, h0, gen), gen)
    hist, launches = fits.fit(iter(hosts))
    losses = [h["loss"] for h in hist]
    print(f"  Trainer.fit on the packed batches: losses {losses}, peak "
          f"{_peak_gb(hist):.2f} GB")
    _print_steps(hist, card)
    if not all(np.isfinite(losses)):
        raise SystemExit("non-finite packed loss")
    for row in rows:
        kind = row["name"].split("[")[0]
        row["launches"] = launches[kind].get(key, 0)
        print(f"  launches {row['name']}: {row['launches']}")
        if row["launches"] == 0:
            raise SystemExit(f"{row['name']} was never launched by the "
                             "packed fit")
    # The same samples padded one a row: the same supervised tokens, the
    # same mean loss within bf16 rounding (the packed fit moved the
    # adapters: both losses are taken at the start).
    with torch.no_grad():
        for n, p in fits.params.named_parameters():
            if n in fits.init:
                p.copy_(fits.init[n].to(p.dtype))
    padded = data.collate(exs, patch_size=cfg_l.vision.patch_size,
                          base_grid=cfg_l.vision.base_grid)
    out = {}
    for name, host in (("packed", h0), ("padded", padded)):
        mb = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
              for k, v in host.items()}
        with torch.no_grad(), step_lib.compute_params(
                fits.params, oryx.compute_dtype(cfg_l)):
            loss, m = step_lib.microbatch_loss(fits.params, cfg_l, mb)
        out[name] = (float(loss), int(m["num_tokens"]),
                     tuple(host["token_ids"].shape))
    (lp, np_, sp), (ld, nd, sd) = out["packed"], out["padded"]
    print(f"  loss at the start: packed {lp:.6f} ({np_} supervised tokens, "
          f"{sp}) vs padded {ld:.6f} ({nd}, {sd}); rel diff "
          f"{abs(lp - ld) / abs(ld):.2e} (limit {TOL})")
    if np_ != nd or abs(lp - ld) > TOL * abs(ld):
        raise SystemExit("the packed loss differs from the padded one")
    return rows


def merge_on_card(fits, cfg_l):
    """Phase 17c: merge_lora against the adapted forward on a 256-token
    prompt: every merged weight of layer 0 is within bf16 rounding (2^-8
    relative) of the exact fp32 sum; prefill logits' rel L2, merged vs
    adapted, printed in bf16 and with fp32 compute (there only the merged
    weights' rounding differs)."""
    from oryx_tpu_torch.models import oryx, qwen2

    params = fits.params
    ids = torch.randint(3, 256, (1, 256), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(6))

    def logits(dt):
        with torch.inference_mode():
            return qwen2.forward(params.llm, cfg_l.llm, input_ids=ids,
                                 attn_impl=cfg_l.attn_impl,
                                 compute_dtype=dt)[0].float()

    with torch.no_grad():  # a trained adapter: B away from 0
        g = torch.Generator("cuda").manual_seed(7)
        for n, p in params.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=g)
    layer = params.llm.layers[0]
    exact = {}
    with torch.no_grad():
        for name in LORA_TARGETS:
            mod = getattr(layer, name)
            exact[name] = mod.weight.float() + (
                mod.lora_b.float().T @ mod.lora_a.float().T
            ) * mod.lora_scale.float()
    adapted = {dt: logits(dt) for dt in (torch.bfloat16, torch.float32)}
    oryx.merge_lora(params)
    merged = {dt: logits(dt) for dt in (torch.bfloat16, torch.float32)}
    rel = {str(dt).split(".")[1]: float(
        (merged[dt] - adapted[dt]).norm() / adapted[dt].norm())
        for dt in adapted}
    left = [n for n, _ in params.named_parameters() if "lora_" in n]
    with torch.no_grad():
        worst = max(float(((getattr(layer, n).weight.float() - w).abs()
                           / w.abs().clamp_min(1e-30)).max())
                    for n, w in exact.items())
    shape = tuple(merged[torch.bfloat16].shape)
    print(f"  merge_lora on the card: prefill logits {shape}, rel L2 "
          f"merged vs adapted {rel} (compute dtype); layer 0's "
          f"merged weights vs the exact fp32 sum: max rel err {worst:.3e} "
          f"(bf16 rounding <= 2^-8 = {2.0 ** -8:.3e}); adapters left "
          f"{len(left)}")
    # bf16 keeps 8 significant bits: rounding to nearest errs by at most
    # 2^-8 relative; 1% over it, as `exact` sums in another order.
    if left or worst > 1.01 * 2.0 ** -8 or not all(
            np.isfinite(list(rel.values()))):
        raise SystemExit("merge_lora does not fold the adapters")


def peft_round_trip(cfg_l):
    """Phase 17d: export_lora_dir + export_hf of a 2 + 2-layer model of
    full width (phase 16a's disk cap), load_from_hf(lora_path=) against
    merge_lora of the same model in memory: every tensor byte-equal."""
    import tempfile

    from oryx_tpu_torch.models import import_hf, oryx
    from oryx_tpu_torch.serve import builder

    run_cfg = dataclasses.replace(
        cfg_l, llm=dataclasses.replace(cfg_l.llm, num_layers=DISK_LAYERS),
        vision=dataclasses.replace(cfg_l.vision, num_layers=DISK_LAYERS))
    model = oryx.init_params(run_cfg, torch.Generator("cuda").manual_seed(5),
                             device="cuda", dtype=torch.bfloat16)
    oryx.enable_lora(model, run_cfg, torch.Generator("cuda").manual_seed(8))
    with torch.no_grad():
        g = torch.Generator("cuda").manual_seed(9)
        for n, p in model.named_parameters():
            if n.endswith("lora_b"):
                p.normal_(0.0, 0.02, generator=g)
    with tempfile.TemporaryDirectory() as d:
        hf, ad = os.path.join(d, "hf"), os.path.join(d, "adapter")
        t0 = time.perf_counter()
        builder.export_hf(hf, run_cfg, model)
        import_hf.export_lora_dir(model.llm, run_cfg.train.lora, ad)
        t1 = time.perf_counter()
        _, back, _ = builder.load_from_hf(
            hf, hf, run_cfg, projector_path=os.path.join(hf, "mm_projector"),
            lora_path=ad, dtype=torch.bfloat16, tokenizer=ByteTokenizer())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        oryx.merge_lora(model)
        same = _states_equal(back, model)
        print(f"  PEFT round trip, {DISK_LAYERS} + {DISK_LAYERS} layers of "
              f"full width: adapter {_dir_bytes(ad) / 1e6:.1f} MB, export "
              f"{t1 - t0:.2f} s, load_from_hf(lora_path=) {t2 - t1:.2f} s; "
              f"== merge_lora in memory, byte-equal: {same}")
    del model, back
    torch.cuda.empty_cache()
    if not same:
        raise SystemExit("the PEFT round trip changed bytes")


_PHASE = {"name": None, "t": 0.0}


# ---- the offline entry points (phase 22) -----------------------------------

EVAL_TASK = "assets/smoke_eval/task.jsonl"
EVAL_ROOT = "assets/smoke_eval"
EVAL_FRAMES = 4  # every frame of the committed 4-frame videos
EVAL_NEW = 8  # max_new_tokens of the generate mode
EVAL_BATCH = 4  # the harness's batches: the 4 images, then the 4 videos
CLI_ROOT = "checkpoints/chip_smoke_cli"  # gitignored, removed after
FLEET_SYS = shared_context()  # phase 23's shared system prompt (24 pages)


def _eval_run(pipe, records, scoring):
    """One harness.evaluate over the smoke task, K1 launches zeroed just
    before and read just after; its `[eval]` lines printed indented.
    Returns (result, K1 launches by call shape, pad_waste)."""
    import io

    from oryx_tpu_torch.eval import harness
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    fa.LAUNCHES.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = harness.evaluate(
            pipe, records, media_root=EVAL_ROOT, num_frames=EVAL_FRAMES,
            max_new_tokens=EVAL_NEW, batch_size=EVAL_BATCH,
            log_every=len(records), scoring=scoring)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"    {line}")
    waste = [int(x.split("pad_waste=")[1].split()[0]) for x in lines
             if "pad_waste=" in x]
    return res, dict(fa.LAUNCHES), waste[0]


def eval_harness(pipe, card) -> None:
    """Phase 22 (a) (see the module docstring)."""
    from oryx_tpu_torch.data import media
    from oryx_tpu_torch.eval import harness
    from oryx_tpu_torch.eval.adapters import adapt

    records = adapt("native", harness.load_task(EVAL_TASK))
    kinds = collections.Counter(r["meta"]["kind"] for r in records)
    print(f"  {len(records)} records ({dict(kinds)}), num_frames "
          f"{EVAL_FRAMES}, max_new_tokens {EVAL_NEW}, batch_size "
          f"{EVAL_BATCH} ({card})")
    for scoring in ("generate", "loglikelihood"):
        t0 = time.perf_counter()
        res, launches, waste = _eval_run(pipe, records, scoring)
        again, _, _ = _eval_run(pipe, records, scoring)
        if again.records != res.records:
            raise SystemExit(f"phase 22 (a): a second {scoring} evaluate "
                             "gave other records")
        letters = {}
        for rec, row in zip(sorted(records, key=lambda r: r["id"]),
                            sorted(res.records, key=lambda r: r["id"])):
            if not row["reply"]:
                raise SystemExit(f"phase 22 (a): {row['id']} has no reply")
            letters[row["id"]] = harness.parse_choice(
                row["reply"], len(rec["options"]), rec["options"])
        if scoring == "loglikelihood" and not all(
                row["reply"] in "ABCD" and len(row["reply"]) == 1
                for row in res.records):
            raise SystemExit(f"phase 22 (a): loglikelihood replies "
                             f"{[r['reply'] for r in res.records]}")
        print(f"  {scoring}: accuracy {res.accuracy:.3f} ({res.num_correct}/"
              f"{res.num_total}; random weights: no meaning), "
              f"{res.seconds:.3f} s and {again.seconds:.3f} s, pad_waste "
              f"{waste}, both calls' records identical; wall of the pair "
              f"{time.perf_counter() - t0:.2f} s ({card})")
        print(f"    letters {letters}")
        print(f"    replies {[r['reply'] for r in res.records]}")
        print(f"    K1 launches by call shape: "
              f"{ {str(k): n for k, n in sorted(launches.items())} }")
        if not launches:
            raise SystemExit(f"phase 22 (a): {scoring} never launched K1")
        if scoring != "generate":
            continue
        # The harness adds nothing to a reply: chat_batch of the same
        # requests in the harness's own grouping gives the same text.
        mine = sorted(((r, harness.eval_length_proxy(r)) for r in records),
                      key=lambda t: (harness._modality_key(t[0]), t[1]))
        direct = {}
        for b0 in range(0, len(mine), EVAL_BATCH):
            group = [r for r, _ in mine[b0:b0 + EVAL_BATCH]]
            reqs = []
            for rec in group:
                frames, is_video = media.load_record_media(
                    rec, media_root=EVAL_ROOT, num_frames=EVAL_FRAMES)
                reqs.append({"question": harness.format_question(rec),
                             "images": frames, "is_video": is_video})
            replies = pipe.chat_batch(reqs, max_new_tokens=EVAL_NEW)
            direct.update({r["id"]: t for r, t in zip(group, replies)})
        got = {r["id"]: r["reply"] for r in res.records}
        if got != direct:
            raise SystemExit(f"phase 22 (a): harness replies {got} vs "
                             f"chat_batch {direct}")
        print("  generate replies == chat_batch of the harness's groups "
              "(byte-equal)")


def _write_cli_inputs(cfg_path: str, root: str = CLI_ROOT
                      ) -> tuple[str, float]:
    """Phase 10's records as a JSON file under `root`, their pixels as
    lossless PNGs (a video as a directory of its 8 frames), and
    oryx_7b_pretrain.json at batch 4, 4 steps, a checkpoint and a log
    record every step and a fresh checkpoint dir. Returns (data path,
    seconds)."""
    t0 = time.perf_counter()
    recs = []
    for rec in train_records():
        frames = train_media(rec)
        rec = dict(rec)
        if rec.get("video"):
            os.makedirs(os.path.join(root, rec["id"]))
            for i, f in enumerate(frames):
                with open(os.path.join(root, rec["id"],
                                       f"frame_{i}.png"), "wb") as fh:
                    fh.write(encode_png(f))
            rec["video"] = rec["id"]
        else:
            rec["image"] = f"{rec['id']}.png"
            with open(os.path.join(root, rec["image"]), "wb") as fh:
                fh.write(encode_png(frames[0]))
        recs.append(rec)
    data = os.path.join(root, "data.json")
    with open(data, "w") as f:
        json.dump(recs, f)
    with open(TRAIN_CONFIG) as f:
        cfg = json.load(f)
    # One card (the file's mesh is fsdp=16).
    cfg["mesh"] = {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1}
    cfg["train"].update(global_batch_size=TRAIN_BATCH,
                        num_train_steps=TRAIN_STEPS, checkpoint_every=1,
                        log_every=1,
                        checkpoint_dir=os.path.join(root, "ckpt"))
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    return data, time.perf_counter() - t0


def cli_fit(params, fit1_hist, fit1_launches, card):
    """Phase 22 (b): phase 10's second fit through `train/cli.main`, with
    the telemetry, the flight recorder and the numerics probes armed.
    Returns the CLI's Trainer (closed)."""
    import shutil
    import threading

    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.train import cli
    from oryx_tpu_torch.utils import flops as flops_lib

    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    os.makedirs(CLI_ROOT)
    cfg_path = os.path.join(CLI_ROOT, "config.json")
    data, write_s = _write_cli_inputs(cfg_path)
    metrics_path = os.path.join(CLI_ROOT, "metrics.jsonl")
    events_path = os.path.join(CLI_ROOT, "events.jsonl")
    argv = ["--config", cfg_path, "--data", data, "--media-root", CLI_ROOT,
            "--tokenizer-path", "unused", "--template", "plain",
            "--video-frames", "8", "--metrics-path", metrics_path,
            "--metrics-port", "0", "--events-path", events_path,
            "--numerics-every", "2"]
    print(f"  wrote {len(train_records())} records as lossless PNGs and the "
          f"config in {write_s:.2f} s ({card}); cli.main({' '.join(argv)})")
    during = {}

    def scrape_during(trainer, done):
        # Once the first step is published, while the loop runs.
        tel = trainer.telemetry
        while not tel.registry.get("steps_total") and not done.wait(0.01):
            pass
        if tel.ready:
            during.update({
                p: http_get(f"http://127.0.0.1:{tel.port}{p}")
                for p in ("/readyz", "/healthz", "/metrics")})

    class ScrapedTrainer(cli.Trainer):
        def fit(self, batches, **kw):
            done = threading.Event()
            thread = threading.Thread(target=scrape_during,
                                      args=(self, done), daemon=True)
            thread.start()
            try:
                return super().fit(batches, **kw)
            finally:
                done.set()
                thread.join(timeout=60)

    loaded = []

    def hand_over(args, cfg):
        loaded.append(args.init_from or args.hf_llm)
        return params

    seams = ((builder, "load_tokenizer", lambda path: ByteTokenizer()),
             (cli, "load_params", hand_over), (cli, "Trainer", ScrapedTrainer))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in seams]
    for c in _flash_counters().values():
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for mod, name, value in seams:
            setattr(mod, name, value)
        trainer = cli.main(argv)
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: dict(c) for k, c in _flash_counters().items()}
    try:
        if loaded != [None]:
            raise SystemExit(f"phase 22 (b): load_params calls {loaded}")
        print("  load path: the load_params seam handed over phase 10's "
              "start state (no --init-from or --hf-llm given: the CLI's own "
              "path is the Trainer's seeded random init); tokenizer: the "
              "builder.load_tokenizer seam, ByteTokenizer")
        return _check_cli_fit(trainer, during, fit1_hist, fit1_launches,
                              launches, metrics_path, events_path, wall,
                              flops_lib, card)
    finally:
        trainer.close()
        shutil.rmtree(CLI_ROOT, ignore_errors=True)


def _check_cli_fit(trainer, during, fit1_hist, fit1_launches, launches,
                   metrics_path, events_path, wall, flops_lib, card):
    recs = [json.loads(x) for x in open(metrics_path).read().splitlines()]
    print(f"  the CLI's JSONL records (seconds and rates on {card}):")
    for r in recs:
        print(f"    {json.dumps(r)}")
    events = open(events_path).read().splitlines() if os.path.exists(
        events_path) else []
    print(f"  anomaly events: {events or 'none'}")
    losses = [r["loss"] for r in recs]
    norms = [r["grad_norm"] for r in recs]
    print(f"  cli fit: wall {wall:.2f} s ({card}), losses {losses}, grad "
          f"norms {norms}")
    if (losses != [h["loss"] for h in fit1_hist]
            or norms != [h["grad_norm"] for h in fit1_hist]
            or [h["loss"] for h in trainer.history] != losses):
        raise SystemExit("phase 22 (b): the CLI's losses or grad norms are "
                         "not fit 1's bits")
    print("  losses and grad norms bit-identical to fit 1, with telemetry, "
          "tracer and numerics armed")
    if launches != fit1_launches:
        raise SystemExit(f"phase 22 (b): launches {launches} vs fit 1's "
                         f"{fit1_launches}")
    print("  K1-lse / K5a / K5b launches equal fit 1's: " + ", ".join(
        f"{k} {sum(v.values())}" for k, v in launches.items()))
    if not during or during["/readyz"][0] != 200 or \
            during["/healthz"][0] != 200:
        raise SystemExit(f"phase 22 (b): the scrape during the loop: "
                         f"{ {k: v[0] for k, v in during.items()} }")
    base = f"http://127.0.0.1:{trainer.telemetry.port}"
    ready_after = http_get(base + "/readyz")
    text = http_get(base + "/metrics")[1]
    final = {name: _families(text, name).get("", float("nan")) for name in (
        "oryx_train_steps_total", "oryx_numerics_samples_total",
        "oryx_numerics_grad_absmax", "oryx_numerics_act_absmax",
        "oryx_numerics_param_absmax", "oryx_train_mfu",
        "oryx_train_model_flops_per_sec", "oryx_train_goodput_ratio",
        "oryx_train_checkpoints_total",
        "oryx_train_checkpoint_seconds_total", "oryx_train_hbm_live_bytes")}
    mid = _families(during["/metrics"][1], "oryx_train_steps_total")[""]
    print(f"  during the loop: /readyz {during['/readyz'][0]}, /healthz "
          f"{during['/healthz'][0]}, oryx_train_steps_total {mid:g}; after: "
          f"/readyz {ready_after[0]} {ready_after[1].strip()}")
    if ready_after[0] != 503:
        raise SystemExit("phase 22 (b): /readyz after the loop")
    layers = _families(text, "oryx_numerics_grad_layer_absmax")
    peak = flops_lib.chip_peak_flops(torch.cuda.get_device_name(0))
    mfu = final["oryx_train_mfu"]
    rate = final["oryx_train_model_flops_per_sec"]
    print(f"  /metrics after: steps {final['oryx_train_steps_total']:g}, "
          f"numerics samples {final['oryx_numerics_samples_total']:g}, "
          f"{len(layers)} layer series (max "
          f"{max(layers.values(), default=float('nan')):.4g}), grad_absmax "
          f"{final['oryx_numerics_grad_absmax']:.4g}, act_absmax "
          f"{final['oryx_numerics_act_absmax']:.4g}, param_absmax "
          f"{final['oryx_numerics_param_absmax']:.4g}; MFU {mfu:.4f} = "
          f"{rate / 1e12:.2f} TFLOP/s / {peak / 1e12:.0f} TFLOP/s (last "
          f"step), goodput {final['oryx_train_goodput_ratio']:.3f}, "
          f"checkpoints {final['oryx_train_checkpoints_total']:g} "
          f"({final['oryx_train_checkpoint_seconds_total']:.2f} s), card "
          f"memory live {final['oryx_train_hbm_live_bytes'] / 1e9:.2f} GB "
          f"({card})")
    if (final["oryx_train_steps_total"] != TRAIN_STEPS
            or final["oryx_numerics_samples_total"] != TRAIN_STEPS // 2
            or len(layers) != trainer.cfg.llm.num_layers
            or not all(np.isfinite(list(layers.values())))):
        raise SystemExit("phase 22 (b): steps, numerics samples or layer "
                         "series")
    if not (0 < mfu < 1 and abs(mfu - rate / peak) <= 1e-9 * mfu):
        raise SystemExit(f"phase 22 (b): MFU {mfu} vs {rate} / {peak}")
    traces = trainer.tracer.traces()
    spans = [[s.name for s in t.spans] for t in traces]
    want = ["data", "h2d", "step_dispatch", "device_sync", "checkpoint_save"]
    if [t.kind for t in traces] != ["train_step"] * TRAIN_STEPS or any(
            names != want for names in spans):
        raise SystemExit(f"phase 22 (b): flight recorder {spans}")
    print(f"  flight recorder: {len(traces)} train_step traces, each "
          f"{want}; span seconds of the last: "
          f"{ {k: round(v, 4) for k, v in traces[-1].span_seconds().items()} }"
          f" ({card})")
    return trainer


# ---- the fleet front door and the concurrency plane (phase 23) -------------

FLEET_NEW = 48  # the drain's in-flight stream: long enough to drain under


class Endpoint(HttpServer):
    """The stdlib client of `HttpServer` against any base URL (the router,
    a replica)."""

    def __init__(self, base: str):
        self.base = base


def _stream_until(base, body, on_first_delta):
    """One SSE stream through `base`; `on_first_delta` runs (in a thread)
    at its first content delta. Returns (status, text, finish reason)."""
    import threading
    import urllib.request

    req = urllib.request.Request(
        base + "/v1/chat/completions",
        data=json.dumps(dict(body, stream=True)).encode(),
        headers={"Content-Type": "application/json"})
    text, finish = "", None
    with urllib.request.urlopen(req, timeout=600) as r:
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: {"):
                continue
            d = json.loads(line[6:])
            if "error" in d:
                raise SystemExit(f"phase 23: stream error {d}")
            for c in d["choices"]:
                delta = c["delta"].get("content")
                if delta:
                    if not text:
                        threading.Thread(target=on_first_delta,
                                         daemon=True).start()
                    text += delta
                finish = c["finish_reason"] or finish
        return r.status, text, finish


def _fleet_metric(server, name) -> float:
    return _metric(server.get("/metrics")[1], name)


def _restart_listener(rep):
    """A stopped replica's HTTP listener again, on its port and over its
    engine (the handler reaches the engine through its closure)."""
    import threading
    from http.server import ThreadingHTTPServer

    port = rep.srv.server_address[1]
    rep.listener = ThreadingHTTPServer(("127.0.0.1", port),
                                       rep.srv.RequestHandlerClass)
    threading.Thread(target=rep.listener.serve_forever, daemon=True).start()


def fleet_front_door(params, cfg, card) -> None:
    """Phase 23 (a): two full-width replicas over one `params` behind the
    prefix-affinity router, the lock-order sanitizer and race detector
    armed, the capture watchdog counting."""
    import threading

    from oryx_tpu_torch.analysis import sanitizers
    from oryx_tpu_torch.serve import router as router_lib
    from oryx_tpu_torch.serve.pipeline import Pipeline

    sanitizers.arm_lock_sanitizer(action="record")
    reps = rsrv = None
    try:
        with sanitizers.recompile_watchdog(budget=1,
                                           action="record") as caps:
            reps = [HttpServer(Pipeline(ByteTokenizer(), params, cfg,
                                        device="cuda"),
                               engine="continuous", replica_id=f"r{i}",
                               **HTTP_SERVE) for i in range(2)]
            rsrv = router_lib.build_router(
                [(f"r{i}", r.base) for i, r in enumerate(reps)], port=0,
                probe=False)
            threading.Thread(target=rsrv.serve_forever, daemon=True).start()
            door = Endpoint(f"http://127.0.0.1:{rsrv.server_address[1]}")
            _fleet_checks(reps, rsrv, door, card)
        scheds = [r.srv.scheduler for r in reps]
        owners = {s.graph_owner: s for s in scheds}
        print(f"  capture watchdog (budget 1 a graph key): {caps.counts}")
        for owner, s in owners.items():
            mine = [k for k in caps.counts if k.startswith(owner + "/")]
            if not mine or len(mine) != s.engine_stats[
                    "graph_captures_total"]:
                raise SystemExit(f"phase 23: {owner} captured {mine}, engine "
                                 f"counts {s.engine_stats}")
        if caps.over_budget() or set(k.split("/")[0] for k in caps.counts) \
                != set(owners):
            raise SystemExit(f"phase 23: captures {caps.counts}")
        per = {o: s.engine_stats["graph_captures_total"]
               for o, s in owners.items()}
        print(f"  one capture a graph key and replica (graphs by engine "
              f"{per}); no key captured twice")
        stats = sanitizers.lock_stats()
        print(f"  lock-order sanitizer and race detector armed: acquires "
              f"{dict(sorted(stats.acquires.items()))}, re-entrant "
              f"{stats.reentrant}; violations {stats.violations}, race "
              f"{sanitizers.race_violations()}")
        if stats.violations or sanitizers.race_violations():
            raise SystemExit("phase 23: lock, race or hot-dispatch "
                             "violations")
        if not stats.acquires.get("router._lock") or not stats.acquires.get(
                "scheduler._cond"):
            raise SystemExit("phase 23: the armed locks were not taken")
    finally:
        if rsrv is not None:
            rsrv.stop_prober()
            rsrv.shutdown()
            rsrv.server_close()
        for r in reps or ():
            listener = getattr(r, "listener", None)
            if listener is not None:
                listener.shutdown()
                listener.server_close()
            r.close()
        sanitizers.disarm_lock_sanitizer()


def _fleet_checks(reps, rsrv, door, card) -> None:
    import statistics
    import threading

    router = rsrv.router
    scheds = [r.srv.scheduler for r in reps]
    # Both engines at once: each captures its engine-step graph while the
    # other's thread launches. An image in the prompt, so neither side of
    # the timed comparison below holds the ViT shapes' first use.
    warm_img = np.random.default_rng(1).integers(0, 256, (448, 448, 3),
                                                 dtype=np.uint8)
    warm = [None, None]

    def one(i):
        warm[i] = reps[i].post({"messages": [{"role": "user", "content": [
            {"type": "text", "text": "Warm up with a long line."},
            {"type": "image_url", "image_url": {
                "url": png_data_uri(warm_img)}}]}], "max_tokens": 24})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if [w[0] for w in warm] != [200, 200] or warm[0][2]["text"] != \
            warm[1][2]["text"]:
        raise SystemExit(f"phase 23: warm-up {warm}")
    graphs = [s.engine_stats["graph_captures_total"] for s in scheds]
    print(f"  warm-up: both replicas at once, each capturing its engine-step "
          f"graph beside the other's launches: graphs {graphs}, replies "
          f"equal")
    if graphs != [1, 1]:
        raise SystemExit(f"phase 23: engine-step graphs {graphs}")

    # (i) phase 19's mix one request at a time, twice: each request through
    # the router and the same body straight to the other replica (both
    # replicas see every prompt once a round, so their caches stay alike).
    # Round 0 sends the routed request first, round 1 the direct one, so
    # neither side of the timed comparison always runs first.
    reqs = http_requests()
    _zero_launches()
    added, ttft_router, ttft_direct, routed = [], [], [], []

    def through(body, tag):
        code, hdr, via = door.post(body, rid=tag)
        if code != 200 or hdr.get("X-Oryx-Router-Retries") != "0" or \
                hdr.get("X-Request-Id") != tag:
            raise SystemExit(f"phase 23: mix request {tag}: {code} {hdr}")
        return hdr.get("X-Oryx-Router-Replica"), via

    for rnd in range(2):
        for i, (body, _, n) in enumerate(reqs):
            body = dict(body)
            if i % 2:
                body.update(stream=True,
                            stream_options={"include_usage": True})
            tag = f"fleet-{i}" if rnd == 0 else f"fleet-{i}-again"
            if rnd == 0:
                rid, via = through(body, tag)
                code, _, direct = reps[1 - int(rid[1])].post(body)
            else:
                code, _, direct = reps[1 - int(routed[i][1])].post(body)
                rid, via = through(body, tag)
            if code != 200 or (via["text"], via["finish"],
                               tuple(via["usage"])) != (
                    direct["text"], direct["finish"],
                    tuple(direct["usage"])):
                raise SystemExit(f"phase 23: request {tag} through the "
                                 f"router {via} differs from direct "
                                 f"{direct}")
            routed.append(rid)
            added.append((via["wall"] - direct["wall"]) * 1e3)
            if i % 2:
                ttft_router.append(via["first_s"])
                ttft_direct.append(direct["first_s"])
    flash_n, paged_n = _launch_counts()
    print(f"  (i) phase 19's mix ({len(reqs)} requests, every other "
          f"streamed) one at a time, twice, through the router and straight "
          f"to the other replica (round 0 routed first, round 1 direct "
          f"first): replies, finish reasons and usage byte-equal; routed to "
          f"{routed}; K1 launches {flash_n}, paged {paged_n}")
    if not flash_n or not paged_n.get("ragged_paged"):
        raise SystemExit(f"phase 23: launches K1 {flash_n}, paged {paged_n}")
    half = len(reqs)
    quart = statistics.quantiles(added, n=4)
    print(f"  router's added wall over direct a request (ms): round 0 "
          f"{[round(x, 1) for x in added[:half]]}, round 1 "
          f"{[round(x, 1) for x in added[half:]]}; median "
          f"{statistics.median(added):+.1f} ms (round 0 "
          f"{statistics.median(added[:half]):+.1f}, round 1 "
          f"{statistics.median(added[half:]):+.1f}), quartiles "
          f"{quart[0]:+.1f} / {quart[2]:+.1f}, range {min(added):+.1f} / "
          f"{max(added):+.1f}, {sum(x > 0 for x in added)} of {len(added)} "
          f"above 0; TTFT through the router (client first delta) "
          f"{[round(x * 1e3, 1) for x in ttft_router]} ms vs direct "
          f"{[round(x * 1e3, 1) for x in ttft_direct]} ms, median "
          f"{statistics.median(ttft_router) * 1e3:.1f} vs "
          f"{statistics.median(ttft_direct) * 1e3:.1f} ms ({card})")

    # (v) one merged trace: router spans on track 0, the replica's on 1.
    code, text = door.get("/debug/trace?id=fleet-0")
    tr = json.loads(text) if code == 200 else {}
    tracks = {t: {e["name"] for e in tr.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("tid") == t}
              for t in (0, 1)}
    print(f"  (v) /debug/trace?id=fleet-0 through the router: merged "
          f"{tr.get('merged')}, replica {tr.get('replica')}, router spans "
          f"{sorted(tracks[0])}, engine spans {sorted(tracks[1])}")
    if not tr.get("merged") or not {"route_decide", "upstream_ttfb",
                                    "proxy_stream"} <= tracks[0] or \
            not {"prefill", "decode_chunk"} <= tracks[1]:
        raise SystemExit("phase 23: the merged trace lacks spans")

    # (ii) a shared-prefix burst lands on one replica and hits its cache.
    def shared(q, tag=""):
        return {"messages": [{"role": "system", "content": tag + FLEET_SYS},
                             {"role": "user", "content": q}],
                "max_tokens": 8}

    code, hdr, _ = door.post(shared("Question 0: how many boats?"))
    hot = hdr["X-Oryx-Router-Replica"]
    before = [_fleet_metric(r, "prefix_cache_hit_tokens_total")
              for r in reps]
    outs, wall = _burst(door, [shared(f"Question {i}: how many boats?")
                               for i in range(1, 5)])
    landed = [o[1].get("X-Oryx-Router-Replica") for o in outs]
    for s in scheds:
        quiesce(s)
    hits = [_fleet_metric(r, "prefix_cache_hit_tokens_total") - b
            for r, b in zip(reps, before)]
    ledger = [(_fleet_metric(r, "admitted"), _fleet_metric(r, "completed"))
              for r in reps]
    print(f"  (ii) shared-prefix burst ({len(FLEET_SYS)}-byte system prompt, "
          f"4 at once after one seeding request on {hot}): landed {landed}, "
          f"codes {[o[0] for o in outs]}, wall {wall:.3f} s; cached tokens "
          f"gained by replica {hits}; admitted/completed {ledger}")
    hot_i = int(hot[1])
    if [o[0] for o in outs] != [200] * 4 or set(landed) != {hot} or \
            hits[hot_i] <= 0 or hits[1 - hot_i] != 0 or \
            any(a != c for a, c in ledger):
        raise SystemExit("phase 23: the shared-prefix burst")

    # (iv) a stopped replica: its listener closed, a request pinned to its
    # prefix retries onto the other replica invisibly; then it listens
    # again and the prober restores it.
    victim = reps[hot_i]
    victim.srv.shutdown()
    victim.srv.server_close()
    code, hdr, out = door.post(shared("Question 5: how many boats?"))
    print(f"  (iv) {hot}'s listener stopped: a request pinned to its prefix "
          f"answered {code} by {hdr.get('X-Oryx-Router-Replica')} after "
          f"{hdr.get('X-Oryx-Router-Retries')} retry, {out.get('finish')}; "
          f"replicas {router.snapshot()}")
    if code != 200 or hdr.get("X-Oryx-Router-Replica") == hot or \
            int(hdr.get("X-Oryx-Router-Retries", 0)) < 1 or \
            router.snapshot()[hot]["healthy"]:
        raise SystemExit("phase 23: the retry off a stopped replica")
    _restart_listener(victim)
    router.probe_all(timeout=5.0)
    if router.healthy_ids() != ["r0", "r1"]:
        raise SystemExit(f"phase 23: after restart {router.snapshot()}")
    print(f"  {hot} listening again: restored by the prober, healthy "
          f"{router.healthy_ids()}")

    # (iii) a drain of r0 mid-burst: a fresh prefix (its first request a
    # miss: the least-loaded replica, r0) carries a long stream and three
    # more requests; r0 drains at the stream's first delta.
    for s in scheds:
        quiesce(s)
    tag = "Drain log. "
    drained = threading.Event()

    def drain_r0():
        reps[0].srv.begin_drain()
        router.probe_all(timeout=5.0)
        drained.set()

    res = {}

    def stream():
        res["stream"] = _stream_until(door.base, dict(
            shared("Tell the whole log slowly.", tag),
            max_tokens=FLEET_NEW), drain_r0)

    bodies = [shared(f"Drain question {i}?", tag) for i in range(3)]
    st = threading.Thread(target=stream)
    st.start()
    time.sleep(0.05)
    outs, _ = _burst(door, bodies)
    st.join()
    if not drained.wait(60):
        raise SystemExit("phase 23: the drain never started")
    code, text, finish = res["stream"]
    quiesce(scheds[0])
    after = [door.post(shared(f"After drain {i}?", tag)) for i in range(3)]
    ready = [door.get("/readyz")[0], reps[0].get("/readyz")[0]]
    r0_ledger = (_fleet_metric(reps[0], "admitted"),
                 _fleet_metric(reps[0], "completed"))
    print(f"  (iii) r0 drained at the first delta of a {FLEET_NEW}-token "
          f"stream on it: the stream {code} {finish} ({len(text)} bytes); "
          f"the burst beside it {[o[0] for o in outs]} by "
          f"{[o[1].get('X-Oryx-Router-Replica') for o in outs]} with retries "
          f"{[o[1].get('X-Oryx-Router-Retries') for o in outs]}; after the "
          f"drain {[(c, h.get('X-Oryx-Router-Replica')) for c, h, _ in after]}"
          f"; router /readyz {ready[0]}, r0 /readyz {ready[1]}; r0 admitted/"
          f"completed {r0_ledger}; healthy {router.healthy_ids()}")
    if code != 200 or finish not in ("length", "stop") or not text or \
            [o[0] for o in outs] != [200] * 3 or \
            [(c, h.get("X-Oryx-Router-Replica")) for c, h, _ in after] != \
            [(200, "r1")] * 3 or ready != [200, 503] or \
            r0_ledger[0] != r0_ledger[1] or router.healthy_ids() != ["r1"]:
        raise SystemExit("phase 23: the drain mid-burst")
    # The armed lock families reach the router's scrape (the newest bound
    # registry owns the samples).
    text = door.get("/metrics")[1]
    if 'oryx_lock_hold_seconds_count{lock="router._lock"}' not in text:
        raise SystemExit("phase 23: no lock histograms on the router")


def serve_cli_on_card(params, cfg, reqs, card) -> None:
    """Phase 23 (b): serve/cli.main one-shot and interactive on the card,
    the pipeline through the `builder.load_pipeline` seam."""
    import io
    import shutil

    from oryx_tpu_torch.data import media
    from oryx_tpu_torch.serve import builder, cli
    from oryx_tpu_torch.serve.pipeline import ChatSession, Pipeline

    shutil.rmtree(CLI_ROOT, ignore_errors=True)
    os.makedirs(CLI_ROOT)
    path = os.path.join(CLI_ROOT, "image.png")
    with open(path, "wb") as f:
        f.write(encode_png(reqs[0]["images"][0]))
    img = media.load_image(path)
    if not np.array_equal(img, reqs[0]["images"][0]):
        raise SystemExit("phase 23 (b): the PNG round trip changed the image")
    n = 24
    handed = []

    def hand_over(model_path, **kw):
        handed.append((model_path, kw))
        return Pipeline(ByteTokenizer(), params, cfg, device="cuda")

    def run(argv, stdin=""):
        saved = builder.load_pipeline, sys.stdin
        builder.load_pipeline, sys.stdin = hand_over, io.StringIO(stdin)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                cli.main(argv)
        finally:
            builder.load_pipeline, sys.stdin = saved
        return out.getvalue(), time.perf_counter() - t0

    try:
        q = "Describe this image."
        base = ["--model-path", "unused", "--image", path,
                "--max-new-tokens", str(n)]
        got, wall1 = run(base + ["--question", q])
        want = Pipeline(ByteTokenizer(), params, cfg, device="cuda").chat(
            q, images=[img], max_new_tokens=n)
        if got != want + "\n":
            raise SystemExit(f"phase 23 (b): one-shot {got!r} vs chat "
                             f"{want!r}")
        lines = ["What colours are there?", ":reset", "", "Any shapes?",
                 ":q", "never read"]
        got, wall2 = run(base + ["--interactive", "--question", q],
                         "\n".join(lines) + "\n")
        session = ChatSession(Pipeline(ByteTokenizer(), params, cfg,
                                       device="cuda"), images=[img],
                              shared=True)

        def ask(text):
            return "".join(session.ask_stream(text, max_new_tokens=n))

        want = f"user: {q}\nassistant: {ask(q)}\n"
        for line in lines:
            want += "user: "
            if line == ":q":
                break
            if line == ":reset":
                session.reset()
                continue
            if line:
                want += f"assistant: {ask(line)}\n"
        if got != want:
            raise SystemExit(f"phase 23 (b): interactive {got!r} vs "
                             f"ChatSession {want!r}")
        if [m for m, _ in handed] != ["unused", "unused"] or \
                handed[0][1].get("device") != "cuda":
            raise SystemExit(f"phase 23 (b): load_pipeline calls {handed}")
        print(f"  (b) serve/cli.main, the pipeline through the "
              f"builder.load_pipeline seam (device {handed[0][1]['device']}):"
              f" one-shot == Pipeline.chat ({wall1:.2f} s), interactive "
              f"(3 questions, :reset, a blank line, :q) == "
              f"ChatSession(shared=True).ask_stream ({wall2:.2f} s), byte-"
              f"equal; transcript {got[:160]!r}... ({card})")
    finally:
        shutil.rmtree(CLI_ROOT, ignore_errors=True)


def native_loader_on_card(pipe, reqs, card) -> None:
    """Phase 23 (c): data/native_loader built on this machine, against its
    numpy twin on phase 2's images at the pipeline's caps."""
    from oryx_tpu_torch.data import mm_utils, native_loader
    from oryx_tpu_torch.ops import packing

    prebuilt = native_loader.library_path().exists()
    t0 = time.perf_counter()
    if not native_loader.is_available():
        raise SystemExit("phase 23 (c): native/loader.cpp did not build")
    build_s = time.perf_counter() - t0
    vis = pipe.cfg.vision
    n_img, n_bytes, worst = 0, 0, 0.0
    t_native = t_twin = 0.0
    for req in reqs:
        if not req.get("images"):
            continue
        _, images, factors, caps = pipe._prepare_request(req)
        for img, cap in zip(images, caps):
            hw = mm_utils.resize_to_patch_grid(img.shape[:2],
                                               vis.patch_size, cap)
            t = time.perf_counter()
            got = native_loader.preprocess_image(
                img, hw, vis.patch_size, mm_utils.IMAGE_MEAN,
                mm_utils.IMAGE_STD)
            t_native += time.perf_counter() - t
            t = time.perf_counter()
            twin = native_loader.preprocess_reference(
                img, hw, vis.patch_size, mm_utils.IMAGE_MEAN,
                mm_utils.IMAGE_STD)
            t_twin += time.perf_counter() - t
            if got.tobytes() != twin.tobytes():
                raise SystemExit(f"phase 23 (c): image {n_img} differs from "
                                 "the numpy twin")
            n_img += 1
            n_bytes += got.nbytes
        kw = dict(patch_size=vis.patch_size, base_grid=vis.base_grid,
                  side_factors=factors, max_patches=caps)
        # pack_raw_images takes the library whenever it builds; each
        # image's slice against the mm_utils path it falls back to.
        native = packing.pack_raw_images(images, **kw)
        off = 0
        for img, cap, (h, w) in zip(images, caps, native.grids):
            plain = packing.patchify(
                mm_utils.preprocess_image(img, vis.patch_size, cap),
                vis.patch_size)[0]
            worst = max(worst, float(np.abs(
                native.patches[off : off + h * w] - plain).max()))
            off += h * w
        if np.any(native.patches[off:]):
            raise SystemExit("phase 23 (c): rows past the images written")
    if worst > 1e-4:
        raise SystemExit(f"phase 23 (c): native vs mm_utils {worst}")
    print(f"  (c) native loader "
          f"{'found built' if prebuilt else 'built from native/loader.cpp'}"
          f" under {native_loader.BUILD_DIR.name}/, loaded in "
          f"{build_s:.2f} s; {n_img} images of phase 2 at the pipeline's caps "
          f"byte-equal to the numpy twin ({n_bytes / 1e6:.1f} MB of patch "
          f"rows; one image at a time: native {t_native * 1e3:.1f} ms, twin "
          f"{t_twin * 1e3:.1f} ms, host CPU); pack_raw_images (native) "
          f"within {worst:.2e} of the mm_utils path ({card})")


# ---- tensor-parallel serving on two ranks of the card (phase 24) ----------


def tp_zero_launches() -> None:
    """Zero this rank's kernel launch counters (a dispatch every rank
    runs)."""
    _zero_launches()
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    fa.LAUNCHES_DECODE.clear()


def tp_launch_table(world, keys) -> list[list[int]]:
    """Every rank's launch count of each (counter, key) of `keys`: a
    [ranks][keys] table, each rank filling its row (a dispatch every rank
    runs)."""
    import torch.distributed as dist

    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    counters = {"fa": fa.LAUNCHES, "pa": pa.LAUNCHES}
    table = torch.zeros((world.size, len(keys)), dtype=torch.int64)
    for i, (which, key) in enumerate(keys):
        table[world.rank, i] = counters[which].get(key, 0)
    dist.all_reduce(table, group=world.ctl_timed)
    return table.tolist()


def _rank_launches(smoke, world) -> tuple[list, list[list[int]]]:
    """This run's launch keys on rank 0 and every rank's counts of them;
    fails unless the ranks launched the same kernels the same number of
    times."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    keys = [("fa", k) for k in fa.LAUNCHES] + [("pa", k) for k in pa.LAUNCHES]
    table = world.call(smoke.tp_launch_table, world, keys)
    if any(row != table[0] for row in table[1:]):
        raise SystemExit(f"the ranks launched different kernels: {table}")
    return keys, table


def tp_engine_run(smoke, world, tpipe, ragged: bool, record: bool,
                  reqs=None, **kw):
    """One run of the `sharded` engine over `reqs` (serve_requests() by
    default), every rank's launch counters zeroed just before it and read
    just after. With `audit_sample_every` in kw the run waits for the
    audit backlog to drain, and `record` records the auditor's K3 calls
    on its private pool (else the engine's paged calls)."""
    import types

    from oryx_tpu_torch.serve.engine import create_engine

    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.ops.cuda import paged_attention as pa

    world.call(smoke.tp_zero_launches)
    sched = create_engine(
        "sharded", tpipe, autostart=False, ragged=ragged,
        prefill_chunk=PREFILL_CHUNK if ragged else None, **SERVE, **kw)
    audited = kw.get("audit_sample_every")
    recorder = None
    if record and audited:
        sched.auditor._ensure_pool()  # a dispatch: every rank's own pool
        recorder = PagedCallRecorder(
            types.SimpleNamespace(kv_pages=sched.auditor._kv))
    elif record:
        recorder = PagedCallRecorder(sched)
    reqs = serve_requests() if reqs is None else reqs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recorder or contextlib.nullcontext():
        handles = [sched.submit(r, n) for r, n in reqs]
        sched.start()
        results = [h.result(timeout=600) for h in handles]
        end = time.monotonic() + 600
        while audited and (sched.auditor.pending() or sched.auditor.to_dict(
                )["total"] < len(reqs) // audited):
            if time.monotonic() > end:
                raise SystemExit(f"tp audits never drained: "
                                 f"{sched.auditor.to_dict()}")
            time.sleep(0.05)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    audit = sched.auditor.to_dict() if audited else None
    sched.close()
    sched.check_pool_invariant()
    paged = collections.Counter()
    for key, n in pa.LAUNCHES.items():
        paged[key[0]] += n
    run = {"results": results, "caps": [n for _, n in reqs], "wall": wall,
           "ttft": [h.debug["ttft_s"] for h in handles],
           "cached": [h.debug["cached_tokens"] for h in handles],
           "metrics": engine_counts(sched),
           "peak": torch.cuda.max_memory_allocated(),
           "flash": dict(fa.LAUNCHES), "paged": dict(paged),
           "recorder": recorder, "audit": audit,
           "heads": int(sched.kv_pages["k"].shape[3])}
    run["keys"], run["table"] = _rank_launches(smoke, world)
    return run


def _key_launches(run, which, match) -> tuple[int, int]:
    """(rank 0, rank 1) launches of the keys `match` accepts."""
    cols = [i for i, (w, k) in enumerate(run["keys"])
            if w == which and match(k)]
    return tuple(sum(row[i] for i in cols) for row in run["table"][:2])


# Phase 24 (f)'s adapters: oryx_7b_sft_lora.json's r and alpha on its seven
# targets, A and B both drawn N(0, 0.02) from this seed (B nonzero, so the
# adapters change the function).
TP_LORA_SEED = 24


def tp_lora(pipe, cfg_llm, on: bool) -> None:
    """Phase 24 (f): attach (on) or remove the seeded whole adapters of
    oryx_7b_sft_lora.json to every decoder projection of `pipe`'s model,
    in its compute dtype: on a tp rank (a dispatch every rank runs) its
    shard holds them whole; in one process the whole model does. Each
    rank draws the same tensors, in one order, on its own card."""
    from oryx_tpu_torch.models import oryx, qwen2
    from oryx_tpu_torch.utils.quant import LORA_LEAVES

    lora = lora_config().train.lora
    whole = qwen2.Qwen2(cfg_llm, device="meta")
    dev = pipe.device
    g = torch.Generator(dev).manual_seed(TP_LORA_SEED)
    dtype = oryx.compute_dtype(pipe.cfg)
    for name in lora.targets:
        for i, layer in enumerate(pipe.params.llm.layers):
            mod = getattr(layer, name)
            if not on:
                for leaf in LORA_LEAVES:
                    del mod._parameters[leaf]
                continue
            shape = getattr(whole.layers[i], name)
            a = torch.randn((shape.in_features, lora.r), generator=g,
                            device=dev) * 0.02
            b = torch.randn((lora.r, shape.out_features), generator=g,
                            device=dev) * 0.02
            s = torch.full((1, 1), lora.scaling, device=dev)
            for leaf, t in zip(LORA_LEAVES, (a, b, s)):
                mod.register_parameter(leaf, torch.nn.Parameter(
                    t.to(dtype), requires_grad=False))


def tp_adapted(smoke, world, tpipe, cfg, reqs, plain, witness,
               card) -> None:
    """Phase 24 (f): the same tp pipe with nonzero adapters (`tp_lora`):
    phase 3's mix through chat_batch, both ranks' sampled tokens equal,
    the replies other than `plain` ((a)'s), and the prefill logits within
    NOISE_RATIO of the one-process bf16 error against the fp32 witness of
    the same adapted weights (`witness`: their (bf16, fp32) logits)."""
    la, lf = witness
    world.call(smoke.tp_lora, tpipe, cfg.llm, True)
    try:
        world.call(smoke.tp_zero_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replies, counts = tpipe.chat_batch(
            reqs, max_new_tokens=MAX_NEW, return_token_counts=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _rank_launches(smoke, world)
        digests = world.digests()
        lt = world.call(smoke.prefill_logits, tpipe, reqs)
    finally:
        world.call(smoke.tp_lora, tpipe, cfg.llm, False)
    if len(set(digests)) != 1:
        raise SystemExit(f"phase 24 (f): the ranks sampled different "
                         f"tokens: {digests}")
    if not bool(torch.isfinite(lt).all()):
        raise SystemExit("phase 24 (f): adapted tp logits are not finite")

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    rt, r1 = rel(lt, lf), rel(la, lf)
    changed = sum(a != b for a, b in zip(replies, plain))
    print(f"  (f) adapters r = 128 on the seven targets: chat_batch wall "
          f"{wall:.3f} s, tokens {[gt for _, gt in counts]}, both ranks' "
          f"digests equal ({digests[0][:16]}); {changed} of {len(reqs)} "
          f"replies differ from the unadapted pipe's; prefill logits rel L2 "
          f"vs the adapted fp32 witness: tp {[f'{x:.3e}' for x in rt]}, one "
          f"process {[f'{x:.3e}' for x in r1]} (limit {NOISE_RATIO}x) "
          f"({card})")
    if any(a > NOISE_RATIO * b for a, b in zip(rt, r1)):
        raise SystemExit("phase 24 (f): adapted tp prefill logits are "
                         "further from the fp32 witness than bf16 noise "
                         "allows")
    if not changed:
        raise SystemExit("phase 24 (f): the adapters changed no reply")


def adapted_witness(params, cfg, reqs) -> tuple:
    """Phase 24 (f)'s witness: phase 3's mix's prefill logits of phase 2's
    weights with `tp_lora`'s adapters in one process, bf16 and fp32 (the
    fp32 witness of phase 4: weights upcast in every product, plain
    attention)."""
    from oryx_tpu_torch.serve.pipeline import Pipeline

    tok = ByteTokenizer()
    pipes = [Pipeline(tok, params, cfg, device="cuda"),
             Pipeline(tok, params, dataclasses.replace(
                 cfg, attn_impl="xla", dtype="float32"), device="cuda")]
    tp_lora(pipes[0], cfg.llm, True)
    try:
        return tuple(prefill_logits(p, reqs) for p in pipes)
    finally:
        tp_lora(pipes[0], cfg.llm, False)


# Phase 24 (e)'s reply cap: every replayed token is a one-row dispatch of
# both ranks (145 ms at 32 tokens; NVIDIA H100 80GB HBM3, 700 W).
TP_AUDIT_NEW = 16


def tp_audit(smoke, world, tpipe, rcfg, reqs, gen, card) -> list[dict]:
    """Phase 24 (e): phase 3's mix at TP_AUDIT_NEW tokens through the
    sharded ragged engine over a bf16 pool, unarmed and then with every
    request audited (each replay's
    prefill and steps dispatches every rank runs, over a private pool of
    its KV heads a rank): replies byte-equal, the bf16 verdicts printed;
    the auditor's K1 prefill and one-row K3 decode at rank 0's call shapes
    vs their plain twins. Returns the two kernel rows."""
    import types

    mix = [(r, TP_AUDIT_NEW) for r in reqs]
    plain = tp_engine_run(smoke, world, tpipe, True, False, reqs=mix)
    armed = tp_engine_run(smoke, world, tpipe, True, True, reqs=mix,
                          audit_sample_every=1)
    if armed["results"] != plain["results"]:
        raise SystemExit(f"phase 24 (e): armed replies {armed['results']} "
                         f"vs unarmed {plain['results']}")
    au = armed["audit"]
    replayed = sum(r["replayed_tokens"] for r in au["records"])
    audit_s = sum(r["audit_s"] for r in au["records"])
    print(f"  (e) audit_sample_every=1 on the tp=2 ragged engine: replies "
          f"byte-equal to unarmed ({plain['wall']:.2f} s unarmed, "
          f"{armed['wall']:.2f} s armed with the backlog drained); bf16 "
          f"verdicts {au['verdicts']} (printed, not gated); "
          f"{1e3 * audit_s / max(1, replayed):.2f} ms a replayed token "
          f"({replayed} tokens, two replays a request) ({card})")
    for r in au["records"]:
        print(f"    {r['request_id']}: {r['verdict']} first_divergence "
              f"{r['first_divergence']} max_abs_diff "
              f"{r['logit_max_abs_diff']} kl {r['kl']}")
    if au["total"] != len(mix) or au["pending"]:
        raise SystemExit(f"phase 24 (e): audits {au['total']} of {len(mix)}")
    rows = []
    llm = rcfg.llm
    pool_shape = (SERVE["max_ctx"] // SERVE["page_size"], SERVE["page_size"],
                  llm.num_kv_heads, llm.head_dim)
    row = paged_kernel_case(
        "paged_decode[tp_audit]", "paged_decode",
        _pick(armed["recorder"].calls["paged_decode"],
              lambda c: int(c[2].sum())), pool_shape, gen)
    row["launches"], r1 = _key_launches(
        armed, "pa", lambda k: k[0] == "paged_decode")
    print(f"  launches {row['name']}: rank 0 {row['launches']}, rank 1 {r1}")
    if not row["launches"] or _key_launches(
            plain, "pa", lambda k: k[0] == "paged_decode")[0]:
        raise SystemExit("phase 24 (e): K3 launched without the auditor, "
                         "or not with it")
    rows.append(row)
    # The twin's prefill: one row, the bucketed prompt against the gathered
    # max_ctx-wide stream at the rank's heads; the widest of its K1 keys
    # (causal, segments, B, Hq, Hk, Tq, Tk, D).
    widths = [k[5] for w, k in armed["keys"] if w == "fa" and k[2:5] == (
        1, llm.num_heads, llm.num_kv_heads) and k[6:] == (
        SERVE["max_ctx"], llm.head_dim)]
    if not widths:
        raise SystemExit("phase 24 (e): the twin's prefill never launched "
                         "K1")
    stand_in = types.SimpleNamespace(cfg=rcfg, device=tpipe.device)
    longest = max(u[2][0] for u in armed["results"])
    _, kw, keep = paged_prefill_case(stand_in, longest, gen,
                                     width=max(widths))
    key, row = check_kernel_case("tp_audit_prefill", kw, keep)
    row["launches"], r1 = _key_launches(armed, "fa", lambda k: k == key)
    print(f"  launches {row['name']}: rank 0 {row['launches']}, rank 1 {r1}")
    if row["launches"] == 0:
        raise SystemExit("phase 24 (e): the twin's prefill never launched "
                         "K1 at its call shape")
    rows.append(row)
    return rows


def tensor_parallel(params, cfg, reqs, toks0, la, lf, card) -> list[dict]:
    """Phase 24: `--shard tp=2` as the entry points run it (this process
    rank 0, rank 1 started by parse_shard_arg), both ranks on the one
    card over gloo, each drawing its shard of phase 2's seeded weights;
    (a) chat_batch, (b) the sharded engine, (c) K1/K3/K4 at the per-rank
    shapes, (e) the auditor, (f) chat_batch with LoRA adapters. Returns
    the kernel rows."""
    import importlib
    from types import SimpleNamespace

    from oryx_tpu_torch.models import qwen2
    from oryx_tpu_torch.ops.cuda import flash_attention as fa
    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.parallel import sharding
    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.serve.engine import create_engine
    from oryx_tpu_torch.serve.pipeline import Pipeline

    # Functions a dispatch names must import on every rank: this script as
    # the module `chip_smoke`, not as __main__.
    smoke = importlib.import_module("chip_smoke")
    witness = adapted_witness(params, cfg, reqs)
    t0 = time.perf_counter()
    mesh, _ = mesh_lib.parse_shard_arg("tp=2")
    world = tp_lib.current()
    print(f"  ranks up in {time.perf_counter() - t0:.1f} s: backend "
          f"{world.backend}, devices {[str(d) for d in world.devices]} "
          f"(ranks that share a card take gloo; NCCL only with a card a "
          f"rank)")
    rows = []
    try:
        t0 = time.perf_counter()
        tok = smoke.ByteTokenizer()
        tpipe = Pipeline(tok, sharding.SeededParams(0, torch.bfloat16), cfg,
                         device="cuda", mesh=mesh)
        torch.cuda.synchronize()
        print(f"  each rank drew its shard of the seed-0 init in "
              f"{time.perf_counter() - t0:.1f} s; rank 0 holds q_proj "
              f"{tuple(tpipe.params.llm.layers[0].q_proj.weight.shape)}, "
              f"o_proj {tuple(tpipe.params.llm.layers[0].o_proj.weight.shape)}"
              f", ViT fc1 "
              f"{tuple(tpipe.params.vit.layers[0].fc1.weight.shape)}")

        # (a) chat_batch over phase 3's mix, twice.
        streams = []
        for i in range(2):
            world.call(smoke.tp_zero_launches)
            tok.decoded.clear()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            replies, counts = tpipe.chat_batch(
                reqs, max_new_tokens=MAX_NEW, return_token_counts=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            streams.append([list(t) for t in tok.decoded])
            if i == 0:
                keys, table = _rank_launches(smoke, world)
                main_run = {"keys": keys, "table": table}
            print(f"  (a) chat_batch run {i}: wall {wall:.3f} s, tokens "
                  f"{[gt for _, gt in counts]}")
        if streams[1] != streams[0]:
            raise SystemExit("tp chat_batch: the two runs differ")
        digests = world.digests()
        if len(set(digests)) != 1:
            raise SystemExit(f"the ranks sampled different tokens: {digests}")
        print(f"  (a) two runs byte-equal; both ranks' dispatch digests "
              f"equal ({digests[0][:16]})")
        lead = []
        for a, b in zip(streams[0], toks0):
            n = 0
            while n < min(len(a), len(b)) and a[n] == b[n]:
                n += 1
            lead.append(f"{n}/{len(b)}")
        print(f"  (a) leading tokens equal to the one-process stream (bf16 "
              f"rounds a row-parallel sum differently; not gated): {lead}")
        lt = world.call(smoke.prefill_logits, tpipe, reqs)
        if not bool(torch.isfinite(lt).all()):
            raise SystemExit("tp prefill logits are not finite")

        def rel(a, b):
            return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

        rt, r1 = rel(lt, lf), rel(la, lf)
        print(f"  (a) prefill logits rel L2 vs the fp32 witness: tp "
              f"{[f'{x:.3e}' for x in rt]}, one process "
              f"{[f'{x:.3e}' for x in r1]} (limit {NOISE_RATIO}x)")
        if any(a > NOISE_RATIO * b for a, b in zip(rt, r1)):
            raise SystemExit("tp prefill logits are further from the fp32 "
                             "witness than bf16 noise allows")

        # (b) the sharded engine: the split route over a bf16 pool (K3),
        # then the ragged route with the prefix cache over an int8 pool
        # (K4q), twice.
        split = tp_engine_run(smoke, world, tpipe, False, True)
        print("  (b) the sharded engine, split route, bf16 pool:")
        check_serving_run("split", 0, split)
        int8_runs = [tp_engine_run(smoke, world, tpipe, True, i == 0,
                                   kv_dtype="int8") for i in range(2)]
        print("  (b) the sharded engine, ragged route, int8 pool, prefix "
              "cache on:")
        for i, run in enumerate(int8_runs):
            check_serving_run("ragged", i, run, "_int8")
        if int8_runs[1]["results"] != int8_runs[0]["results"]:
            raise SystemExit("tp int8 ragged: the two runs differ")
        print(f"  (b) sharded engine, KV heads a rank {split['heads']}: split "
              f"wall {split['wall']:.3f} s; int8 ragged walls "
              f"{[round(r['wall'], 3) for r in int8_runs]} s, replies "
              f"byte-equal across the two runs; prefix hits "
              f"{int8_runs[1]['metrics']['prefix_cache_hit_tokens_total']}")
        c = tp_lib.SHARED_CARD
        print(f"  rank 0's all-reduces summed on the shared card so far: "
              f"{c['calls']}, {c['bytes'] / 1e9:.3f} GB contributed, "
              f"{c['seconds']:.3f} s from entry to return")
        peaks = world.peak_memory()
        print(f"  peak card memory by rank: "
              f"{[f'{p / 1e9:.2f} GB' for p in peaks]} (rank 0's includes "
              f"phase 2's whole model)")

        # (c) the kernels at the per-rank call shapes.
        rcfg = dataclasses.replace(
            cfg, llm=qwen2.rank_cfg(tpipe.params.llm, cfg.llm),
            vision=dataclasses.replace(
                cfg.vision, num_heads=cfg.vision.num_heads // 2))
        stand_in = SimpleNamespace(cfg=rcfg, device=tpipe.device,
                                   pack_requests=tpipe.pack_requests)
        gen = torch.Generator("cuda").manual_seed(24)
        print(f"  (c) kernels vs plain twins at rank 0's shapes: K1 at "
              f"{rcfg.llm.num_heads}/{rcfg.llm.num_kv_heads} decoder heads "
              f"and {rcfg.vision.num_heads} ViT heads, K3/K4 at Hk = "
              f"{rcfg.llm.num_kv_heads}")
        for name, kw, keep in attention_cases(stand_in, reqs, gen):
            if name == "compressor":  # whole on every rank: phase 2's row
                continue
            key, row = check_kernel_case(f"tp_{name}", kw, keep)
            r0, r1 = _key_launches(main_run, "fa", lambda k: k == key)
            row["launches"] = r0
            print(f"  launches {row['name']}: rank 0 {r0}, rank 1 {r1}")
            if r0 == 0:
                raise SystemExit(f"{row['name']} was never launched on the "
                                 "tp path")
            rows.append(row)
        S = SERVE["num_slots"]
        pool_shape = (S * SERVE["max_ctx"] // SERVE["page_size"],
                      SERVE["page_size"], rcfg.llm.num_kv_heads,
                      rcfg.llm.head_dim)
        dec = split["recorder"].calls["paged_decode"]
        rag = int8_runs[0]["recorder"].calls["ragged_paged"]
        cases = [
            ("paged_decode[tp_decode]", "paged_decode", None, split,
             _pick(dec, lambda c: int(c[2].sum())), lambda k: True),
            ("ragged_paged_int8[tp_prefill]", "ragged_paged", "int8",
             int8_runs[0], _pick([c for c in rag if c[0][0][0] > S],
                                 lambda c: int((c[3] + 1).sum())),
             lambda k: k[1] > S),
            ("ragged_paged_int8[tp_decode]", "ragged_paged", "int8",
             int8_runs[0], _pick([c for c in rag if c[0][0][0] == S],
                                 lambda c: int((c[3] + 1).sum())),
             lambda k: k[1] == S),
        ]
        for name, kind, fmt, run, call, which in cases:
            row = paged_kernel_case(name, kind, call, pool_shape, gen, fmt)
            kernel = kind + (f"_{fmt}" if fmt else "")
            r0, r1 = _key_launches(
                run, "pa", lambda k: k[0] == kernel and which(k))
            row["launches"] = r0
            print(f"  launches {name}: rank 0 {r0}, rank 1 {r1}")
            if r0 == 0:
                raise SystemExit(f"{name} was never launched on the tp path")
            rows.append(row)

        rows.extend(tp_audit(smoke, world, tpipe, rcfg, reqs, gen, card))
        tp_adapted(smoke, world, tpipe, cfg, reqs, replies, witness, card)

        # (b, continued) a follower that dies: the engine reports dead
        # within the collective timeout, nothing hangs.
        sched = create_engine("sharded", tpipe, autostart=False, ragged=True,
                              prefill_chunk=PREFILL_CHUNK, kv_dtype="int8",
                              **SERVE)
        world.kill_follower(1)
        t1 = time.perf_counter()
        h = sched.submit({"question": "Name three colours."}, 8)
        sched.start()
        try:
            h.result(timeout=world.timeout_s + 30)
            raise SystemExit("a request was served with a dead follower")
        except RuntimeError as e:
            err = str(e)
        while sched.alive() and time.perf_counter() - t1 < world.timeout_s:
            time.sleep(0.01)
        dead_s = time.perf_counter() - t1
        alive = sched.alive()
        sched.close()
        print(f"  (b) rank 1 killed: the engine reported dead after "
              f"{dead_s:.3f} s (collective timeout {world.timeout_s:g} s); "
              f"the request failed with {err[:90]!r}")
        if alive:
            raise SystemExit("the sharded engine outlived its dead follower")
    finally:
        world.shutdown()
    return rows


# ---- data/sequence-parallel training on two ranks of the card (phase 25) --

ZERO_CONFIG = "scripts/configs/oryx_7b_sft.json"
RING_CONFIG = "scripts/configs/oryx_7b_longvideo.json"
# (a)'s depth (decoder, ViT layers). ddp holds 16 bytes a parameter on each
# rank: embed + head are 1.09 B parameters, a decoder layer 233 M, a ViT
# layer 15.2 M, so 2 + 4 layers are ~26 GB a copy, two copies on the card.
ZERO_LAYERS = (2, 4)
RING_LAYERS = (1, 1)
RING_T = 16384  # (b)'s sequence: 8,192 tokens a rank
RING_XLA_T = 2048  # the "ring" (xla) impl's check, [Tl, Tl] fp32 logits
PAR_STEPS = 2
PAR_CKPT = "checkpoints/chip_smoke_par"  # gitignored; no save is written
PAR_CLI = "checkpoints/chip_smoke_par_cli"  # gitignored, removed after
ZERO_RESIDENT = 0.55  # fsdp's resident bytes a rank at most this x ddp's
# (a)'s peak card memory a rank with the packed visual buffer whole on each
# rank, before each rank encoded its share (NVIDIA H100 80GB HBM3, 700 W).
WHOLE_BUFFER_PEAK_GB = {"fsdp": 20.39, "zero2": 24.73, "ddp": 31.53}
# (e): rows a batch, one a data rank: at four rows the embed and head state
# (~8.7 GB a rank at fsdp = 2) and two-row logits put four ranks near 72 GB.
TP_BATCH = 2
# Grad norms of a sharded fit against its one-process or fsdp=2 reference
# on the same rows: bf16 rounding moved them by 4-5e-5 (NVIDIA H100 80GB
# HBM3, 700 W); a tp backward without its group sum moves them by tenths.
GRAD_NORM_REL = 1e-3
# (f): each adapter's change over the fit (the norm of after minus before)
# against the fsdp=2 LoRA fit's. Adam's steps are near sign(g) times the
# rate, so the norm follows the set of moved entries, not bf16 rounding;
# a column layer's B that missed its tp sum moves ~0.71x as far.
LORA_CHANGE_REL = 1e-2


def par_config(path, layers, **top):
    """`path` at `layers` (decoder, ViT) deep, TRAIN_BATCH records a
    batch, PAR_STEPS steps, no accumulation; `top` replaces top-level
    fields (mesh, attn_impl)."""
    from oryx_tpu_torch import config

    with open(path) as f:
        cfg = config.OryxConfig.from_json(f.read())
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, num_layers=layers[0]),
        vision=dataclasses.replace(cfg.vision, num_layers=layers[1]),
        train=dataclasses.replace(
            cfg.train, global_batch_size=TRAIN_BATCH, grad_accum_steps=1,
            num_train_steps=PAR_STEPS, log_every=1,
            checkpoint_every=10 ** 9, checkpoint_dir=PAR_CKPT),
        **top)


def par_zero() -> None:
    """Zero this rank's K1/K5 launch counters and its collective counts
    (a dispatch every rank runs)."""
    from oryx_tpu_torch.parallel import tp as tp_lib

    for c in _flash_counters().values():
        c.clear()
    tp_lib.reset_collectives()


def par_free() -> None:
    """Free what a finished fit left on this rank's card (a dispatch: the
    dropped handles go first)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()



def par_guard(on: bool) -> None:
    """While on, the K1/K5 plain twins raise on a card tensor on this rank
    (a dispatch): phase 25's paths take the kernels alone."""
    from oryx_tpu_torch.ops.cuda import flash_attention as fa

    names = ("_mha_forward_reference", "_mha_backward_reference")
    if not on:
        for name in names:
            setattr(fa, name, getattr(fa, name).__wrapped__)
        return
    for name in names:
        plain = getattr(fa, name)

        def guarded(q, *a, _plain=plain, _name=name, **kw):
            if q.device.type == "cuda":
                raise RuntimeError(f"{_name} ran on the card")
            return _plain(q, *a, **kw)

        guarded.__wrapped__ = plain
        setattr(fa, name, guarded)


def _unsaved_trainer():
    from oryx_tpu_torch.train.trainer import Trainer

    class Unsaved(Trainer):
        """Phase 25 writes no checkpoint: the full-tune state of the cut
        model is ~19 GB a fit (the sharded save and resume are held bit
        for bit by the CPU tests)."""

        def _save(self, step, *, force=False):
            pass

    return Unsaved


def par_fit(smoke, cfg, mode, data, label, card) -> dict:
    """One fit of PAR_STEPS steps over the host batches `data`, every
    rank's launch counters zeroed just before and read just after. Under
    tune "lora" on ranks, each rank's leaves are held against their start
    (`lora_start`, `lora_moved`)."""
    trainer = _unsaved_trainer()(cfg, device="cuda", sharding_mode=mode)
    world = trainer.world
    lora = cfg.train.tune == "lora" and world is not None
    if lora:
        world.call(smoke.lora_start, trainer.zero)
    if world is not None:
        world.call(smoke.par_zero)
    else:
        par_zero()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.fit(iter(data), num_steps=PAR_STEPS, resume=False, prefetch=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = {"losses": [h["loss"] for h in trainer.history],
           "norms": [h["grad_norm"] for h in trainer.history], "wall": wall,
           "steps": [h["wall_s"] for h in trainer.history],
           "lse": dict(_flash_counters()["flash_fwd_lse"]),
           "dq": dict(_flash_counters()["flash_bwd_dq"]),
           "dkv": dict(_flash_counters()["flash_bwd_dkv"])}
    if world is not None:
        run["reports"] = trainer.rank_reports()
        run["peak"] = world.peak_memory()
    if lora:
        run["lora"] = world.call(smoke.lora_moved, trainer.zero)
    else:
        run["peak"] = [torch.cuda.max_memory_allocated()]
    print(f"  {label}: losses {run['losses']} grad norms {run['norms']} | "
          f"fit {wall:.2f} s, steps {[round(x, 3) for x in run['steps']]} s"
          f" | peak {[round(b / 1e9, 2) for b in run['peak']]} GB a rank "
          f"({card})")
    for rep in run.get("reports", []):
        print(f"    rank {rep['rank']}: params {rep['param_bytes'] / 1e9:.2f}"
              f" GB, grads {rep['grad_bytes'] / 1e9:.2f} GB, moments "
              f"{rep['moment_bytes'] / 1e9:.2f} GB; launches "
              f"{rep['launches']}; collectives "
              + ", ".join(f"{k} {v['calls']} calls {v['bytes'] / 1e9:.2f} GB"
                          f" {v['seconds']:.2f} s"
                          for k, v in rep["collectives"].items()))
    del trainer
    gc.collect()
    if world is not None:
        # Twice: the first call carries the handles rank 0 dropped before
        # it, the second those its own collection dropped.
        world.call(smoke.par_free)
        world.call(smoke.par_free)
    else:
        par_free()
    return run


def lora_start(rt) -> None:
    """Keep a host copy of this rank's leaves as the fit starts (a
    dispatch every rank runs on its RankTrainer; on the host, so that the
    fit's peak card memory is its own)."""
    rt.lora_start = {n: p.detach().to("cpu", copy=True)
                     for n, p in rt.state.params.named_parameters()}


def lora_moved(rt) -> list[dict]:
    """Every rank's leaves against `lora_start`'s copy: the frozen leaves
    changed (names), the lora_b leaves moved, whether every adapter is
    finite, each adapter's change (the L2 norm of its leaf after the fit
    minus before) and a digest of every adapter's bytes (a dispatch; the
    copy is dropped)."""
    import hashlib

    from oryx_tpu_torch.parallel.zero import gather_objects

    start = rt.__dict__.pop("lora_start")
    digest = hashlib.sha256()
    out = {"rank": rt.world.rank, "frozen_changed": [], "lora_b": 0,
           "lora_b_moved": 0, "finite": True, "change": {}}
    for n, p in rt.state.params.named_parameters():
        host = p.detach().cpu()
        same = torch.equal(host, start[n])
        if not rt.tx.mask[n] and not same:
            out["frozen_changed"].append(n)
        if "lora_" in n:
            out["finite"] &= bool(torch.isfinite(host).all())
            digest.update(host.reshape(-1).view(torch.uint8).numpy())
        if n.endswith(("lora_a", "lora_b")):
            out["change"][n] = float(torch.linalg.vector_norm(
                host.double() - start[n].double()))
        if n.endswith("lora_b"):
            out["lora_b"] += 1
            out["lora_b_moved"] += int(not same)
    out["digest"] = digest.hexdigest()[:16]
    return gather_objects(rt.world, out)


def _resident(rep) -> int:
    return rep["param_bytes"] + rep["grad_bytes"] + rep["moment_bytes"]


def _rel_diff(a, b) -> float:
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def zero_stages(smoke, card) -> tuple:
    """Phase 25 (a): 2 steps of oryx_7b_sft.json (tune full) at ZERO_LAYERS
    on fsdp=2 in each of fsdp, zero2 and ddp, twice each, and once on one
    process; then (e)'s and (f)'s references on fsdp=2. Returns (the fsdp
    run, the batches, the fsdp config, (e)'s and (f)'s references)."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.parallel import tp as tp_lib

    cfg = par_config(ZERO_CONFIG, ZERO_LAYERS,
                     mesh=config.MeshConfig(fsdp=2))
    data = list(itertools.islice(train_batches(cfg), PAR_STEPS))
    print(f"  {ZERO_CONFIG} at {ZERO_LAYERS[0]} decoder + {ZERO_LAYERS[1]} "
          f"ViT layers (full width), tune {cfg.train.tune}, remat "
          f"{cfg.train.remat_policy}, attn {cfg.attn_impl}; batches "
          f"{[tuple(b['token_ids'].shape) for b in data]}")
    par_guard(True)
    try:
        one = par_fit(smoke, dataclasses.replace(
            cfg, mesh=config.MeshConfig()), "fsdp", data, "one process",
            card)
    finally:
        par_guard(False)
    t0 = time.perf_counter()
    world = tp_lib.start(2, tp_lib.default_devices(2, "cuda"))
    print(f"  ranks up in {time.perf_counter() - t0:.1f} s: backend "
          f"{world.backend}, devices {[str(d) for d in world.devices]}")
    world.call(smoke.par_guard, True)
    runs = {}
    try:
        for mode in ("fsdp", "zero2", "ddp"):
            runs[mode] = [par_fit(smoke, cfg, mode, data, f"{mode} run {i}",
                                  card) for i in range(2)]
    finally:
        world.call(smoke.par_guard, False)
    for mode, (a, b) in runs.items():
        if (a["losses"], a["norms"]) != (b["losses"], b["norms"]):
            raise SystemExit(f"phase 25 (a): {mode}'s two runs differ")
        rel = _rel_diff(a["losses"], runs["fsdp"][0]["losses"])
        if rel > 1e-3:
            raise SystemExit(f"phase 25 (a): {mode} vs fsdp losses rel "
                             f"{rel:.2e} > 1e-3")
        for rep in a["reports"]:
            if not all(rep["launches"].values()):
                raise SystemExit(f"phase 25 (a): {mode} rank {rep['rank']} "
                                 f"launched no {rep['launches']}")
        if a["reports"][0]["launches"] != a["reports"][1]["launches"]:
            raise SystemExit(f"phase 25 (a): {mode}'s ranks launched "
                             "different kernels")
    P = data[0]["patches"].shape[0]
    for mode, whole in WHOLE_BUFFER_PEAK_GB.items():
        a = runs[mode][0]
        rows_ = [rep["vit_rows"] for rep in a["reports"]]
        print(f"  (a) {mode}: peak a rank "
              f"{[round(b / 1e9, 2) for b in a['peak']]} GB (the visual "
              f"buffer whole on each rank: {whole} GB); ViT rows a "
              f"rank {rows_} of {P}")
        if rows_ != [P // 2] * 2:
            raise SystemExit(f"phase 25 (a): {mode}'s ranks encoded "
                             f"{rows_} visual rows, not {P // 2} each")
    rel_one = _rel_diff(runs["fsdp"][0]["losses"], one["losses"])
    if rel_one > 1e-2:
        raise SystemExit(f"phase 25 (a): fsdp vs one process rel "
                         f"{rel_one:.2e} > 1e-2")
    # The grad norms hold the backward too (the visual shard's K/V
    # reduce-scatter and pooled-region sum): step 1 runs at lr ~0, so the
    # losses read the forward alone.
    rel_norm = _rel_diff(runs["fsdp"][0]["norms"], one["norms"])
    if rel_norm > GRAD_NORM_REL:
        raise SystemExit(f"phase 25 (a): fsdp vs one process grad norms rel "
                         f"{rel_norm:.2e} > {GRAD_NORM_REL}")
    ratios = [_resident(f) / _resident(d) for f, d in zip(
        runs["fsdp"][0]["reports"], runs["ddp"][0]["reports"])]
    if max(ratios) > ZERO_RESIDENT:
        raise SystemExit(f"phase 25 (a): fsdp resident bytes {ratios} x "
                         f"ddp's > {ZERO_RESIDENT}")
    print(f"  (a) each mode's two runs bit-identical; modes within rel "
          f"{max(_rel_diff(r[0]['losses'], runs['fsdp'][0]['losses']) for r in runs.values()):.2e}"
          f" of fsdp; fsdp vs one process rel {rel_one:.2e} (limit 1e-2), "
          f"grad norms rel {rel_norm:.2e} (limit {GRAD_NORM_REL}); "
          f"fsdp's resident param+grad+moment bytes {[round(r, 3) for r in ratios]}"
          f" x ddp's (limit {ZERO_RESIDENT}); both ranks' K1-lse/K5a/K5b "
          f"launches equal; the plain twins guarded (none ran on the card)")
    # (e)'s reference: the fsdp fit on TP_BATCH rows a batch.
    cfg2 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch_size=TP_BATCH))
    data2 = list(itertools.islice(train_batches(cfg2, batch=TP_BATCH),
                                  PAR_STEPS))
    # (f)'s reference: a LoRA fit on fsdp=2, TP_BATCH rows a batch.
    cfg3 = lora_par_config(config.MeshConfig(fsdp=2))
    data3 = list(itertools.islice(train_batches(
        cfg3, sft_records(), batch=TP_BATCH), PAR_STEPS))
    world.call(smoke.par_guard, True)
    try:
        ref2 = par_fit(smoke, cfg2, "fsdp", data2,
                       f"fsdp, {TP_BATCH} rows a batch ((e)'s reference)",
                       card)
        ref3 = par_fit(smoke, cfg3, "fsdp", data3,
                       f"fsdp, LoRA, {TP_BATCH} rows a batch ((f)'s "
                       f"reference)", card)
    finally:
        world.call(smoke.par_guard, False)
    return runs["fsdp"][0], data, cfg, (ref2, data2, cfg2), (ref3, data3)


def fsdp_tp(smoke, ref, lora_ref, card) -> dict:
    """Phase 25 (e): (a)'s config at fsdp=2 x tp=2 on four ranks sharing
    the card, TP_BATCH rows a batch (one a data rank), twice: the two fits
    bit-identical, losses within rel 1e-3 of (a)'s fsdp fit on the same
    rows and so are its grad norms, every rank's K1-lse/K5 launches equal,
    each rank's resident bytes and peak printed. Then (f) in the second
    fit's world: two LoRA fits (`lora_tp_checks` against `lora_ref`).
    Returns (e)'s first fit."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.parallel import tp as tp_lib

    ref_run, data, cfg2 = ref
    cfg = dataclasses.replace(cfg2, mesh=config.MeshConfig(fsdp=2, tp=2))
    # Four ranks' state fills the card: nothing of (a)-(d) stays cached.
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  (e) rank 0 holds {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"before the four ranks start")
    runs, lora_runs = [], []
    # Each of (e)'s fits in four fresh ranks: the card holds their state
    # with ~1 GB to spare, and a second full fit in the same processes ran
    # a follower out of memory on some machines. (f)'s fits (12.5 GB a
    # rank) follow the second in its world.
    for i in range(2):
        t0 = time.perf_counter()
        world = tp_lib.start(4, tp_lib.default_devices(4, "cuda"))
        print(f"  (e) four ranks up in {time.perf_counter() - t0:.1f} s: "
              f"backend {world.backend}, devices "
              f"{[str(d) for d in world.devices]}")
        world.call(smoke.par_guard, True)
        try:
            runs.append(par_fit(smoke, cfg, "fsdp", data,
                                f"(e) fsdp=2 x tp=2 run {i}", card))
            if i:
                lora_runs = [par_fit(
                    smoke, lora_par_config(cfg.mesh), "fsdp", lora_ref[1],
                    f"(f) LoRA fsdp=2 x tp=2 run {j}", card)
                    for j in range(2)]
        finally:
            world.call(smoke.par_guard, False)
            world.shutdown()
            gc.collect()
            torch.cuda.empty_cache()
    lora_tp_checks(lora_runs, lora_ref[0], runs[0], card)
    a, b = runs
    if (a["losses"], a["norms"]) != (b["losses"], b["norms"]):
        raise SystemExit("phase 25 (e): the two fsdp x tp fits differ")
    rel = _rel_diff(a["losses"], ref_run["losses"])
    if rel > 1e-3:
        raise SystemExit(f"phase 25 (e): losses rel {rel:.2e} > 1e-3 of the "
                         f"fsdp fit on the same rows")
    # The tp backward (the column input's group sum, the row sum's
    # identity) shows in the grad norms alone.
    rel_norm = _rel_diff(a["norms"], ref_run["norms"])
    if rel_norm > GRAD_NORM_REL:
        raise SystemExit(f"phase 25 (e): grad norms rel {rel_norm:.2e} > "
                         f"{GRAD_NORM_REL} of the fsdp fit on the same rows")
    launches = [rep["launches"] for rep in a["reports"]]
    if any(x != launches[0] for x in launches) or not all(
            launches[0].values()):
        raise SystemExit(f"phase 25 (e): the ranks' launches {launches}")
    P = data[0]["patches"].shape[0]
    vit = [rep["vit_rows"] for rep in a["reports"]]
    if vit != [P // 2] * 4:
        raise SystemExit(f"phase 25 (e): ViT rows a rank {vit}, not "
                         f"{P // 2}")
    print(f"  (e) the two fits bit-identical; losses within rel {rel:.2e} "
          f"(limit 1e-3) and grad norms within rel {rel_norm:.2e} (limit "
          f"{GRAD_NORM_REL}) of the fsdp fit on the same rows; the four ranks' "
          f"K1-lse/K5a/K5b launches equal {launches[0]}; ViT rows a rank "
          f"{vit} of {P}; peak a rank "
          f"{[round(x / 1e9, 2) for x in a['peak']]} GB ({card})")
    return a


def lora_par_config(mesh):
    """Phase 25 (f): oryx_7b_sft_lora.json (r = 128, alpha 256, the seven
    targets) at ZERO_LAYERS, TP_BATCH rows a batch, on `mesh`."""
    cfg = par_config(LORA_CONFIG, ZERO_LAYERS, mesh=mesh)
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch_size=TP_BATCH))


def lora_tp_checks(runs, ref, full, card) -> None:
    """Phase 25 (f): the two LoRA fits at fsdp=2 x tp=2 bit-identical,
    losses and grad norms within rel 1e-3 / GRAD_NORM_REL of the fsdp=2
    LoRA fit on the same rows and weights, on every rank every frozen
    leaf bit-unchanged and every lora_b moved and finite, every rank's
    adapters bit-equal, each adapter's change within LORA_CHANGE_REL of
    the reference's, the four ranks' K1-lse/K5 launches equal; rank 0's
    K1-lse/K5 call shapes printed beside (e)'s (`full`: the tune-full
    fit)."""
    a, b = runs
    if (a["losses"], a["norms"]) != (b["losses"], b["norms"]):
        raise SystemExit("phase 25 (f): the two LoRA fsdp x tp fits differ")
    rel = _rel_diff(a["losses"], ref["losses"])
    rel_norm = _rel_diff(a["norms"], ref["norms"])
    if rel > 1e-3 or rel_norm > GRAD_NORM_REL:
        raise SystemExit(f"phase 25 (f): losses rel {rel:.2e} (limit 1e-3), "
                         f"grad norms rel {rel_norm:.2e} (limit "
                         f"{GRAD_NORM_REL}) of the fsdp=2 LoRA fit")
    for run in runs:
        for r in run["lora"]:
            if r["frozen_changed"] or not r["finite"] or \
                    r["lora_b_moved"] != r["lora_b"] or not r["lora_b"]:
                raise SystemExit(f"phase 25 (f): rank {r['rank']}: frozen "
                                 f"leaves changed {r['frozen_changed'][:3]},"
                                 f" lora_b moved {r['lora_b_moved']} of "
                                 f"{r['lora_b']}, finite {r['finite']}")
    # The adapters' gradients: a rank whose partial sums missed its tp
    # group updates its own copy of each adapter from its own columns, so
    # the ranks' copies part and a column layer's B moves ~0.7x as far.
    digests = [[r["digest"] for r in run["lora"]] for run in (*runs, ref)]
    if any(len(set(d)) != 1 for d in digests) or digests[0] != digests[1]:
        raise SystemExit(f"phase 25 (f): the adapters' digests by rank "
                         f"(two fits, then the reference) {digests}")
    want = ref["lora"][0]["change"]
    worst, leaf = _worst_change(a["lora"][0]["change"], want)
    if worst > LORA_CHANGE_REL:
        raise SystemExit(f"phase 25 (f): {leaf} moved rel {worst:.2e} "
                         f"(limit {LORA_CHANGE_REL}) from the fsdp=2 LoRA "
                         f"fit's change")
    launches = [rep["launches"] for rep in a["reports"]]
    if any(x != launches[0] for x in launches) or not all(
            launches[0].values()):
        raise SystemExit(f"phase 25 (f): the ranks' launches {launches}")
    shapes = a["reports"][0]["param_shapes"]
    print(f"  (f) the two LoRA fits bit-identical; losses within rel "
          f"{rel:.2e} (limit 1e-3) and grad norms within rel {rel_norm:.2e} "
          f"(limit {GRAD_NORM_REL}) of the fsdp=2 LoRA fit on the same rows;"
          f" on each rank every frozen leaf bit-unchanged and all "
          f"{a['lora'][0]['lora_b']} lora_b moved and finite; every "
          f"rank's adapters bit-equal to the others' (digest "
          f"{digests[0][0]}; the reference's {digests[2][0]}); each "
          f"adapter's change within "
          f"rel {worst:.2e} of the reference's (limit {LORA_CHANGE_REL}, "
          f"worst {leaf}; lora_a unmoved in both: "
          f"{sum(1 for n, v in want.items() if n.endswith('lora_a') and not v)}"
          f" of {sum(1 for n in want if n.endswith('lora_a'))}); adapters held "
          f"whole (q_proj A {shapes['llm.layers.0.q_proj.lora_a']}, B "
          f"{shapes['llm.layers.0.q_proj.lora_b']} beside its weight "
          f"{shapes['llm.layers.0.q_proj.weight']}); the four ranks' "
          f"K1-lse/K5a/K5b launches equal {launches[0]}; peak a rank "
          f"{[round(x / 1e9, 2) for x in a['peak']]} GB ({card})")
    same = all(sorted(a[k]) == sorted(full[k]) for k in ("lse", "dq", "dkv"))
    print(f"  (f) rank 0's K1-lse/K5 call shapes {'==' if same else '!='} "
          f"(e)'s: {a['lse']}")


def _worst_change(got: dict, want: dict) -> tuple[float, str]:
    """The largest relative difference between two fits' adapter changes
    (leaf name -> L2 norm of after minus before), and its leaf; a leaf
    the reference left unmoved must stay unmoved."""
    worst, leaf = 0.0, ""
    for n, w in want.items():
        rel = abs(got[n] - w) / w if w else float("inf" if got[n] else 0)
        if rel >= worst:
            worst, leaf = rel, n
    return worst, leaf


def vit_shard_case(cfg, host, width: int, heads: int, gen) -> dict:
    """The ViT's attention on a rank's shard of the packed buffer: its
    first P / width patches' queries against the whole buffer's keys, at
    `heads` heads (random bf16 q/k/v, the batch's segment ids)."""
    seg = torch.from_numpy(np.ascontiguousarray(
        host["segment_ids"])).to("cuda")[None]
    P, d = seg.shape[1], cfg.vision.head_dim

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    return dict(q=rnd(1, P // width, heads, d), k=rnd(1, P, heads, d),
                v=rnd(1, P, heads, d), causal=False,
                q_segment_ids=seg[:, :P // width], kv_segment_ids=seg)


def ring_records():
    """One record for (b): a 616 x 616 image (1,936 visual tokens) and a
    caption long enough that the row pads to RING_T tokens."""
    words = " ".join(f"wave{i % 97}" for i in range(1850))
    return [{"id": "img0", "image": "img0.jpg", "conversations": [
        {"from": "human", "value": "<image>"},
        {"from": "gpt", "value": words}]}]


def ring_layer_case(T: int, impl: str, seed: int) -> dict:
    """Every rank: its block of a seeded [1, T] causal sequence at the
    oryx_7b decoder's heads through `ring_attention_shard` over the two
    ranks, forward and backward (bf16, a dispatch); the output and the
    q/k/v gradients gathered whole, and each rank's launch counts."""
    from oryx_tpu_torch.ops import ring_attention as ring_lib
    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.parallel.zero import gather_objects

    world = tp_lib.current()
    group = tuple(range(world.size))
    par_zero()
    # Outside the follower's inference mode: autograd saves these.
    with torch.inference_mode(False), torch.enable_grad():
        g = torch.Generator("cuda").manual_seed(seed)
        q, do = (torch.randn((1, T, 28, 128), generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((1, T, 4, 128), generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        pos = torch.arange(T, device="cuda", dtype=torch.int32)[None]
        tl = T // world.size
        sl = slice(world.rank * tl, (world.rank + 1) * tl)
        ring = ring_lib.Ring(world, group, ring_lib.live_table(
            pos.cpu().numpy(), world.size, world.rank))
        qb, kb, vb = (x[:, sl].detach().clone().requires_grad_()
                      for x in (q, k, v))
        out = ring_lib.ring_attention_shard(
            qb, kb, vb, pos[:, sl], pos[:, sl], torch.ones_like(pos[:, sl]),
            ring=ring, causal=True, impl=impl)
        grads = torch.autograd.grad(out, (qb, kb, vb), do[:, sl])
    torch.cuda.synchronize()
    counts = {k2: sum(c.values()) for k2, c in _flash_counters().items()}
    whole = [world.all_gather(x.detach(), list(group), dim=1)
             for x in (out, *grads)]
    return {"whole": [x.cpu() for x in whole],
            "launches": gather_objects(world, counts), "live": ring.live}


def _ring_against_one(smoke, world, T, impl, card) -> dict:
    """ring_layer_case against the one-process K1/K5 on the whole sequence
    (bf16) and the fp32 kernels' witness."""
    from oryx_tpu_torch.ops.cuda.flash_attention import flash_attention

    got = world.call(smoke.ring_layer_case, T, impl, 11)
    g = torch.Generator("cuda").manual_seed(11)
    q, do = (torch.randn((1, T, 28, 128), generator=g, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((1, T, 4, 128), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))

    def one(dtype):
        x = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        o = flash_attention(*x, causal=True)
        return [o.detach().float()] + [
            t.float() for t in torch.autograd.grad(o, x, do.to(dtype))]

    single, witness = one(torch.bfloat16), one(torch.float32)
    worst = 0.0
    for name, r, s_, w in zip(("out", "dq", "dk", "dv"), got["whole"],
                              single, witness):
        er, es = _rel(r.cuda(), w), _rel(s_, w)
        worst = max(worst, er / es)
        print(f"    {impl} T={T} {name}: rel L2 vs fp32 witness ring {er:.3e},"
              f" one process {es:.3e}")
        if not er <= NOISE_RATIO * es:
            raise SystemExit(f"phase 25 (b): ring {impl} {name} is further "
                             "from the fp32 witness than bf16 noise allows")
    print(f"    {impl} T={T}: live blocks a rank {got['live']}, launches a "
          f"rank {got['launches']} ({card})")
    return got


def ring_training(smoke, card) -> dict:
    """Phase 25 (b): oryx_7b_longvideo.json widths under ring_flash on
    sp=2, one row of RING_T tokens, 2 steps; one decoder layer's ring
    attention against the one-process kernels; the xla ring once at
    RING_XLA_T. Returns the fit."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.parallel import tp as tp_lib

    cfg = par_config(RING_CONFIG, RING_LAYERS, attn_impl="ring_flash",
                     mesh=config.MeshConfig(sp=2))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, global_batch_size=1))
    data = list(itertools.islice(
        train_batches(cfg, records=ring_records(), batch=1), PAR_STEPS))
    T = data[0]["token_ids"].shape[1]
    if T != RING_T:
        raise SystemExit(f"phase 25 (b): the row is {T} tokens, not {RING_T}")
    print(f"  {RING_CONFIG} at {RING_LAYERS[0]} decoder + {RING_LAYERS[1]} "
          f"ViT layer (full width), ring_flash on sp=2: one row of {T} "
          f"tokens ({int(data[0]['attn_mask'].sum())} real, "
          f"{int(data[0]['is_visual'].sum())} visual), {T // 2} a rank")
    run = par_fit(smoke, cfg, "fsdp", data, "ring_flash fit", card)
    if not all(np.isfinite(run["losses"] + run["norms"])):
        raise SystemExit("phase 25 (b): the ring fit is not finite")
    from oryx_tpu_torch.ops.ring_attention import live_table

    # The decoder's ring blocks (no segment ids): the ViT's K2 launches on
    # the rank's shard of the visual buffer are the same on both ranks.
    lse = [sum(n for key, n in rep["launch_keys"]["flash_fwd_lse"].items()
               if not key[1]) for rep in run["reports"]]
    live = [sum(sum(live_table(b["positions"], 2, r)) for b in data)
            for r in range(2)]
    print(f"  (b) the decoder's K1-lse launches a rank {lse}; live blocks "
          f"a rank over the "
          f"steps {live} (JAX's rule, min(kv_pos) <= max(q_pos) over the "
          f"block: the padded tail's positions count)")
    if not (lse[0] > 0 and lse[0] * live[1] == lse[1] * live[0]):
        raise SystemExit(f"phase 25 (b): launches {lse} do not follow the "
                         f"live blocks {live}")
    world = tp_lib.current()
    world.call(smoke.par_guard, True)
    try:
        got = _ring_against_one(smoke, world, RING_T, "flash", card)
        _ring_against_one(smoke, world, RING_XLA_T, "xla", card)
    finally:
        world.call(smoke.par_guard, False)
    # arange positions: the contiguous causal split, rank i sees i + 1
    # blocks, each launching K1-lse, K5a and K5b once.
    want = [{k: r + 1 for k in ("flash_fwd_lse", "flash_bwd_dq",
                                "flash_bwd_dkv")} for r in range(2)]
    counts = [{k: c[k] for k in want[0]} for c in got["launches"]]
    if counts != want:
        raise SystemExit(f"phase 25 (b): one layer's launches {counts} != "
                         f"{want}")
    return run


def fsdp_serving(smoke, cfg_a, card) -> None:
    """Phase 25 (d): `--shard fsdp=2` over phase 3's mix at (a)'s depth,
    bf16, against the one-process pipeline on the same seeded weights."""
    from oryx_tpu_torch import config
    from oryx_tpu_torch.parallel import mesh as mesh_lib
    from oryx_tpu_torch.parallel import sharding
    from oryx_tpu_torch.serve.pipeline import Pipeline

    cfg = dataclasses.replace(cfg_a, mesh=config.MeshConfig())
    mesh, mode = mesh_lib.parse_shard_arg("fsdp=2")
    reqs = requests()
    fpipe = Pipeline(smoke.ByteTokenizer(),
                     sharding.SeededParams(0, torch.bfloat16), cfg,
                     device="cuda", mesh=mesh, sharding_mode=mode)
    whole = sharding.seeded_shard(
        cfg, {n: sharding.Placement(None, 1, 0) for n, _ in
              oryx_empty(cfg).named_parameters()}, 0, device="cuda",
        dtype=torch.bfloat16)
    one = Pipeline(smoke.ByteTokenizer(), sharding.frozen_model(cfg, whole),
                   cfg, device="cuda")
    del whole
    shapes = (tuple(fpipe.params.llm.layers[0].q_proj.weight.shape),
              tuple(fpipe.params.llm.embed.weight.shape))
    t0 = time.perf_counter()
    got = fpipe.chat_batch(reqs, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = one.chat_batch(reqs, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    if got != want:
        raise SystemExit(f"phase 25 (d): fsdp=2 replies {got!r} != one "
                         f"process {want!r}")
    print(f"  (d) fsdp=2 chat_batch over phase 3's mix == the one-process "
          f"pipeline, byte for byte; rank 0 holds q_proj {shapes[0]}, embed "
          f"{shapes[1]}; wall {wall:.2f} s vs {wall1:.2f} s one process "
          f"({card})")


def oryx_empty(cfg):
    from oryx_tpu_torch.models.oryx import empty_model

    return empty_model(cfg)


def cli_two_processes(cfg, fsdp_run, card) -> None:
    """Phase 25 (c): the training CLI as two processes with --coordinator
    (this one process 0, a second started here), 2 steps at (a)'s fsdp
    config on phase 10's records as PNGs: losses == (a)'s fsdp fit's."""
    import shutil
    import socket
    import subprocess

    from oryx_tpu_torch.parallel import tp as tp_lib
    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.train import cli

    shutil.rmtree(PAR_CLI, ignore_errors=True)
    os.makedirs(PAR_CLI)
    cfg_path = os.path.join(PAR_CLI, "config.json")
    data, _ = _write_cli_inputs(cfg_path, root=PAR_CLI)
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    metrics = os.path.join(PAR_CLI, "metrics.jsonl")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    argv = ["--config", cfg_path, "--data", data, "--media-root", PAR_CLI,
            "--tokenizer-path", "unused", "--template", "plain",
            "--video-frames", "8", "--metrics-path", metrics,
            "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    t0 = time.perf_counter()
    follower = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.train.cli", *argv,
         "--process-id", "1"], env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    seams = ((builder, "load_tokenizer", lambda path: ByteTokenizer()),
             (cli, "Trainer", _unsaved_trainer()))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in seams]
    try:
        for mod, name, value in seams:
            setattr(mod, name, value)
        trainer = cli.main(argv + ["--process-id", "0"])
        hist = [(h["loss"], h["grad_norm"]) for h in trainer.history]
        trainer.close()
        del trainer
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)
        world = tp_lib.current()
        if world is not None:
            world.shutdown()
        try:
            _, err = follower.communicate(timeout=120)
        finally:
            follower.kill()
        shutil.rmtree(PAR_CLI, ignore_errors=True)
    wall = time.perf_counter() - t0
    if follower.returncode != 0:
        raise SystemExit(f"phase 25 (c): process 1 exited "
                         f"{follower.returncode}: {err.decode()[-2000:]}")
    want = list(zip(fsdp_run["losses"], fsdp_run["norms"]))
    if hist != want:
        raise SystemExit(f"phase 25 (c): the CLI's {hist} != (a)'s fsdp fit"
                         f" {want}")
    print(f"  (c) two processes (--coordinator 127.0.0.1:{port}, process 1 "
          f"a follower): losses and grad norms == (a)'s fsdp fit, bit for "
          f"bit; {wall:.1f} s with both processes' start-up ({card})")


def parallel_training(card) -> list[dict]:
    """Phase 25: (a) the ZeRO stages, (b) ring attention, (d) fsdp serving
    on two ranks of the card (this process rank 0, rank 1 started by the
    first Trainer's mesh), then (c) the CLI as two processes, (e) fsdp=2 x
    tp=2 on four ranks, (f) LoRA there, and the K1/K5 rows at the ring block's, the fsdp
    decoder's, the ViT shard's and the tp decoder's and ViT shard's
    shapes. Returns the kernel rows."""
    import importlib

    from oryx_tpu_torch.parallel import tp as tp_lib

    smoke = importlib.import_module("chip_smoke")
    fsdp_run, data, cfg_a, ref, lora_ref = zero_stages(smoke, card)
    ring_run = ring_training(smoke, card)
    fsdp_serving(smoke, cfg_a, card)
    tp_lib.current().shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    cli_two_processes(cfg_a, fsdp_run, card)
    tp_run = fsdp_tp(smoke, ref, lora_ref, card)

    # The kernel rows at the two new call shapes; launches from (a)'s first
    # fsdp fit and (b)'s fit, on rank 0.
    gen = torch.Generator("cuda").manual_seed(12)
    big = max(data, key=lambda b: b["token_ids"].shape[1])
    rank0 = {k: v[:TRAIN_BATCH // 2] for k, v in big.items()
             if k in ("positions", "attn_mask", "token_ids")}
    _, _, dec = training_attention_cases(cfg_a, {**big, **rank0}, big, gen)
    tl = RING_T // 2
    pos = torch.arange(RING_T, device="cuda", dtype=torch.int32)[None]
    ring_kw = dict(
        q=torch.randn((1, tl, 28, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16),
        k=torch.randn((1, tl, 4, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16),
        v=torch.randn((1, tl, 4, 128), generator=gen, device="cuda"
                      ).to(torch.bfloat16),
        causal=True, q_positions=pos[:, tl:], kv_positions=pos[:, :tl])
    # (e)'s rank 0: one row a data rank at the rank's heads (decoder 14 q /
    # 2 kv, ViT 8), its half of the visual buffer; (a)'s ViT at 16 heads
    # on its half.
    ref_data = ref[1]
    big2 = max(ref_data, key=lambda b: b["token_ids"].shape[1])
    rcfg = dataclasses.replace(cfg_a, llm=dataclasses.replace(
        cfg_a.llm, num_heads=cfg_a.llm.num_heads // 2,
        num_kv_heads=cfg_a.llm.num_kv_heads // 2))
    row0 = {k: v[:1] for k, v in big2.items()
            if k in ("positions", "attn_mask", "token_ids")}
    _, _, tp_dec = training_attention_cases(rcfg, {**big2, **row0}, big2,
                                            gen)
    rows = []
    for name, kw, run in (
            ("fsdp_decoder", dec[1], fsdp_run),
            ("ring_block", ring_kw, ring_run),
            ("vit_shard", vit_shard_case(cfg_a, big, 2,
                                         cfg_a.vision.num_heads, gen),
             fsdp_run),
            ("tp_decoder", tp_dec[1], tp_run),
            ("tp_vit_shard", vit_shard_case(
                cfg_a, big2, 2, cfg_a.vision.num_heads // 2, gen), tp_run)):
        key, case_rows = check_backward_case(name, kw, gen)
        for row, counter in zip(case_rows, ("lse", "dq", "dkv")):
            row["launches"] = run[counter].get(key, 0)
            print(f"  launches {row['name']} (rank 0): {row['launches']}")
            if row["launches"] == 0:
                raise SystemExit(f"{row['name']}: no launch on its path")
        rows.extend(case_rows)
    return rows


def phase_begin(name: str | None) -> None:
    """Close the running phase with its `phase N wall X s` line and start
    `name` (None: the last phase ends)."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"  phase {_PHASE['name']} wall {now - _PHASE['t']:.1f} s",
              flush=True)
    _PHASE.update(name=name, t=now)


def main() -> int:
    # Line-buffered: a pipe would otherwise hold back whole blocks of
    # output, so a run that dies (or is killed) would not show the phase it
    # died in.
    sys.stdout.reconfigure(line_buffering=True)
    if any(a in ("-h", "--help") for a in sys.argv[1:]):
        print(__doc__)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "oryx_tpu_torch", "csrc")):
        print(f"chip_smoke: no oryx_tpu_torch package (with its kernel "
              f"sources) beside this script in {here}; run it from the root "
              "of a checkout", file=sys.stderr)
        return 2
    if here not in sys.path:
        sys.path.insert(0, here)
    from oryx_tpu_torch import config
    from oryx_tpu_torch.models import generate as generate_lib
    from oryx_tpu_torch.models import oryx
    from oryx_tpu_torch.ops.cuda import build
    from oryx_tpu_torch.ops.cuda.measure import gpu_line
    from oryx_tpu_torch.serve.pipeline import Pipeline

    # ---- 1. card and build ------------------------------------------------
    phase_begin("1")
    card = gpu_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    # One nvcc per source, all started together.
    def timed_build(name):
        t = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t

    sources = ("flash_attention", "flash_attention_bwd", "paged_attention",
               "q8_linear")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as ex:
        secs = dict(zip(sources, ex.map(timed_build, sources)))
    for name in sources:
        build.load(name)
        print(f"built {name} in {secs[name]:.1f} s")
        print_ptxas(build.build_logs.get(name, ""))

    # ---- 25. data/sequence-parallel training on two ranks ------------------
    # On the empty card: ddp holds two full copies of (a)'s state.
    phase_begin("25")
    print(f"phase 25: ZeRO-3/ZeRO-2/DDP (oryx_7b_sft.json, fsdp=2), ring "
          f"attention (oryx_7b_longvideo.json, ring_flash, sp=2), fsdp "
          f"serving, the training CLI as two processes, each rank encoding "
          f"its share of the packed visual buffer; two ranks on the one "
          f"card; then fsdp=2 x tp=2 on four ({card})", flush=True)
    par_rows = parallel_training(card)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 2. kernel vs plain twin at the main path's shapes ----------------
    phase_begin("2")
    cfg = dataclasses.replace(config.oryx_7b(), attn_impl="pallas")
    t0 = time.perf_counter()
    params = oryx.init_params(
        cfg, torch.Generator("cuda").manual_seed(0), device="cuda",
        dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    print(f"oryx_7b bf16 random init: {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    tok = ByteTokenizer()
    pipe = Pipeline(tok, params, cfg, device="cuda")
    reqs = requests()
    print(f"phase 2: kernel vs plain twin, bf16, atol=rtol={TOL} "
          f"({card})", flush=True)
    rows, keys = [], []
    gen = torch.Generator("cuda").manual_seed(1)
    for name, kw, keep in attention_cases(pipe, reqs, gen):
        key, row = check_kernel_case(name, kw, keep)
        if name == "decode":
            row["graph_ms"] = graph_decode_ms(kw)
            print(f"    inside a CUDA graph: {row['graph_ms']:.4f} ms a call")
        keys.append(key)
        rows.append(row)

    # ---- 3. the main path at full width -----------------------------------
    phase_begin("3")
    print(f"phase 3: Pipeline.chat_batch, oryx_7b bf16, greedy, "
          f"max_new_tokens={MAX_NEW} ({card})", flush=True)
    results = [run_main_path(pipe, reqs, tok) for _ in range(3)]
    for i, (replies, counts, tim, toks, launches, wall, peak, _) in enumerate(
        results
    ):
        steps = tim["decode_steps"]
        print(f"  run {i}: wall {wall:.3f} s | visual {tim['visual_s']:.3f}"
              f" s | prefill {tim['prefill_s']:.3f} s | decode "
              f"{tim['decode_s']:.3f} s ({steps} steps, "
              f"{len(reqs) * steps / tim['decode_s']:.1f} tok/s) | peak "
              f"{peak / 1e9:.2f} GB")
        for r, ((pt, gt), rep) in enumerate(zip(counts, replies)):
            print(f"    request {r}: prompt {pt} tokens, generated {gt} "
                  f"tokens, reply {rep[:40]!r}")
        if any(gt < 1 or pt < 1 for pt, gt in counts):
            raise SystemExit("a request produced no tokens")
    toks0 = results[0][3]
    if any(r[3] != toks0 for r in results[1:]):
        raise SystemExit("the runs produced different tokens")
    print(f"  tokens identical across the {len(results)} runs")
    # The eager witness: the same prefill, the decode loop without graphs.
    embeds, lengths, cache_len = mix_embeds(pipe, reqs)
    etoks, efin, edec, esteps, elaunch = eager_generate(
        pipe, embeds, lengths, cache_len)
    graph_dec = [f"{r[2]['decode_s']:.4f}" for r in results]
    print(f"  decode graph route {graph_dec} s ({results[0][2]['decode_steps']}"
          f" steps; capture {results[0][2]['capture_s']:.3f} s in run 0, "
          f"{[r[2]['capture_s'] for r in results[1:]]} after) vs eager "
          f"witness {edec:.4f} s ({esteps} steps); K1 decode launches: "
          f"graph run 1 {sum(results[1][7].values())}, eager {elaunch}")
    if row_tokens(etoks, efin) != toks0:
        raise SystemExit("the decode graphs' tokens differ from the eager "
                         "loop's")
    print("  graph route tokens == eager witness tokens (byte-equal)")
    launches = results[0][4]
    for key, row in zip(keys, rows):
        row["launches"] = launches.get(key, 0)
        print(f"  launches {row['name']}: {row['launches']}")
        if row["launches"] == 0:
            raise SystemExit(f"{row['name']} was never launched on the "
                             "main path")
    if sum(launches.values()) != sum(launches.get(k, 0) for k in set(keys)):
        raise SystemExit(f"launches outside the checked shapes: {launches}")
    # Every Tq = 1 call (the decode steps) took the split-KV decode route,
    # and no other call did.
    decode_keys = {k for k in launches if k[5] == 1}
    routed = results[0][7]
    if not decode_keys or routed != {k: launches[k] for k in decode_keys}:
        raise SystemExit(f"decode calls {launches} vs decode-route launches "
                         f"{routed}")
    print(f"  decode route: {sum(routed.values())} of the "
          f"{sum(launches[k] for k in decode_keys)} Tq = 1 calls")

    # ---- 4. the plain attention path --------------------------------------
    phase_begin("4")
    cfg_x = dataclasses.replace(cfg, attn_impl="xla")
    pipe_x = Pipeline(tok, params, cfg_x, device="cuda")
    res_x = run_main_path(pipe_x, reqs, tok)
    print(f"phase 4: attn_impl='xla' run: wall {res_x[5]:.3f} s", flush=True)
    agree = total = 0
    for a, b in zip(toks0, res_x[3]):
        n = min(len(a), len(b))
        agree += sum(int(x == y) for x, y in zip(a[:n], b[:n]))
        total += max(len(a), len(b))
    print(f"  greedy token agreement kernel vs plain: {agree}/{total}")
    # The fp32 witness: the same bf16 weights, upcast in every product
    # (the models cast weights to the activations' dtype), fp32 activations,
    # plain attention, full-precision fp32 matmuls.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe_f = Pipeline(
        tok, params, dataclasses.replace(cfg_x, dtype="float32"),
        device="cuda",
    )
    la, lb, lf = (prefill_logits(p, reqs) for p in (pipe, pipe_x, pipe_f))
    if not all(bool(torch.isfinite(x).all()) for x in (la, lb, lf)):
        raise SystemExit("non-finite prefill logits")

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).tolist()

    rk, rp, rkp = rel(la, lf), rel(lb, lf), rel(la, lb)
    print(f"  prefill last-token logits {tuple(la.shape)}, per-row rel L2:")
    print(f"    kernel path vs fp32 witness {[f'{x:.3e}' for x in rk]}")
    print(f"    plain path  vs fp32 witness {[f'{x:.3e}' for x in rp]}")
    print(f"    kernel path vs plain path   {[f'{x:.3e}' for x in rkp]}")
    print(f"    ratio kernel/plain error    "
          f"{[f'{a / b:.3f}' for a, b in zip(rk, rp)]} (limit {NOISE_RATIO})")
    print(f"    argmax equal to the witness: kernel "
          f"{(la.argmax(-1) == lf.argmax(-1)).tolist()}, plain "
          f"{(lb.argmax(-1) == lf.argmax(-1)).tolist()}")
    if any(a > NOISE_RATIO * b for a, b in zip(rk, rp)):
        raise SystemExit("the kernel path is further from the fp32 witness "
                         "than bf16 noise allows")
    print("kernels launched and checked: flash_fwd "
          f"({', '.join(r['name'] for r in rows)})")

    # ---- 5. where the device time goes ------------------------------------
    phase_begin("5")
    walls = [f"{r[5]:.3f}" for r in results]
    print(f"phase 5: chat_batch under torch.profiler ({card}); unprofiled "
          f"walls of phase 3: {walls} s", flush=True)
    fams, wall_us, _ = profile_call(
        lambda: pipe.chat_batch(reqs, max_new_tokens=MAX_NEW))
    k1 = fams[kernel_family("flash_fwd")] + fams[kernel_family("tile_map")]
    print(f"  K1 (with its cell map) in the traced call: {k1 / 1e3:.1f} ms, "
          f"{k1 / sum(fams.values()):.1%} of its device time, "
          f"{k1 / wall_us:.1%} of its wall")
    # Prefill + MAX_NEW decode steps on the mix's embeds, graph route then
    # eager witness, each traced.
    gen_kw = dict(inputs_embeds=embeds, lengths=lengths,
                  max_new_tokens=MAX_NEW, cache_len=cache_len,
                  attn_impl=cfg.attn_impl,
                  compute_dtype=oryx.compute_dtype(cfg),
                  stop_sequences=pipe.stop_sequences)
    print("  the prefill alone, traced:")
    with torch.inference_mode():
        _, _, pre = profile_call(lambda: generate_lib.prefill(
            pipe.params.llm, cfg.llm, embeds, lengths, cache_len=cache_len,
            attn_impl=cfg.attn_impl,
            compute_dtype=oryx.compute_dtype(cfg)))
    for label, fn in (
        ("graph route", lambda: generate_lib.generate(
            pipe.params.llm, cfg.llm, cfg.generation, **gen_kw)),
        ("eager witness",
         lambda: eager_generate(pipe, embeds, lengths, cache_len)),
    ):
        print(f"  generate on the mix's embeds, {label}, traced:")
        _, _, calls = profile_call(fn)
        print(f"    host launch calls a decode step (the prefill's "
              f"{sum(pre.values())} taken off): "
              f"{(sum(calls.values()) - sum(pre.values())) / MAX_NEW:.1f}")

    # ---- 14. streaming, sessions and scoring at full width --------------
    phase_begin("14")
    print(f"phase 14: chat_stream, seeded sampling, ChatSession, "
          f"SessionPrefixCache, score_options; oryx_7b bf16 (sessions also "
          f"with fp32 compute) ({card})", flush=True)
    pipe_f32 = Pipeline(tok, params, dataclasses.replace(cfg, dtype="float32"),
                        device="cuda")
    rows.extend(stream_and_sessions(pipe, pipe_f32, card))
    del pipe_f32

    # ---- 7. the serving engine at full width ------------------------------
    phase_begin("7")
    print(f"phase 7: ContinuousScheduler, oryx_7b bf16, greedy, {SERVE}, "
          f"{len(serve_requests())} requests, prefix cache on ({card})",
          flush=True)
    spipe = Pipeline(ByteTokenizer(), params, cfg, device="cuda")
    serving = {}
    for mode in ("split", "ragged"):
        # The ragged engine's run 0 is the eager witness (its calls are
        # recorded for phase 6), run 1 the graph route.
        runs = [run_scheduler(spipe, mode == "ragged", record=i == 0,
                              eager=mode == "ragged" and i == 0)
                for i in range(2)]
        for i, run in enumerate(runs):
            check_serving_run(mode, i, run)
        if runs[1]["results"] != runs[0]["results"]:
            raise SystemExit(f"{mode}: the two runs produced different "
                             "tokens")
        print(f"  {mode}: tokens identical across the two runs")
        if mode == "ragged":
            m = runs[1]["metrics"]
            print(f"  ragged graph route == eager witness (byte-equal): "
                  f"walls {runs[1]['wall']:.3f} vs {runs[0]['wall']:.3f} s, "
                  f"tails after the last admission {runs[1]['tail']:.3f} vs "
                  f"{runs[0]['tail']:.3f} s ({runs[1]['tail_steps']} logical "
                  f"steps); capture {m['graph_capture_s']:.3f} s "
                  f"({m['graph_captures_total']} graph)")
            if not m["graph_captures_total"] or runs[0]["metrics"][
                    "graph_captures_total"]:
                raise SystemExit("ragged: the graph route did not replay "
                                 "graphs, or the witness did")
        serving[mode] = runs[0]
        serving[mode + "_graph"] = runs[1]
    same = sum(
        a[0] == b[0] for a, b in zip(serving["split"]["results"],
                                     serving["ragged"]["results"])
    )
    print(f"  split vs ragged replies equal (bf16, not asserted): "
          f"{same}/{len(serve_requests())}")
    print("  one more split-engine run under torch.profiler:")
    profile_call(lambda: run_scheduler(spipe, False, record=False))

    # ---- 6. paged kernels at the serving shapes ---------------------------
    phase_begin("6")
    print(f"phase 6: paged kernels vs plain twins at phase 7's call shapes, "
          f"bf16, atol=rtol={TOL} ({card})", flush=True)
    llm = cfg.llm
    # The default pool: num_slots * max_ctx / page_size pages.
    pool_shape = (SERVE["num_slots"] * SERVE["max_ctx"] // SERVE["page_size"],
                  SERVE["page_size"], llm.num_kv_heads, llm.head_dim)
    gen = torch.Generator("cuda").manual_seed(2)
    dec_calls = serving["split"]["recorder"].calls["paged_decode"]
    rag_calls = serving["ragged"]["recorder"].calls["ragged_paged"]
    S = SERVE["num_slots"]
    cases = [
        ("paged_decode[decode]", "paged_decode",
         _pick(dec_calls, lambda c: int(c[2].sum()))),
        ("ragged_paged[prefill]", "ragged_paged",
         _pick([c for c in rag_calls if c[0][0][0] > S],
               lambda c: int((c[3] + 1).sum()))),
        ("ragged_paged[decode]", "ragged_paged",
         _pick([c for c in rag_calls if c[0][0][0] == S],
               lambda c: int((c[3] + 1).sum()))),
    ]
    for name, kind, call in cases:
        row = paged_kernel_case(name, kind, call, pool_shape, gen)
        mode = "split" if kind == "paged_decode" else "ragged"
        # Launches of the engine's graph-route run (its pure-decode
        # dispatches replayed), split by whether the dispatch carried
        # prefill lanes (R > S).
        row["launches"] = sum(
            n for key, n in serving[mode + "_graph"]["paged_keys"].items()
            if key[0] == kind and (
                kind == "paged_decode"
                or (key[1] > S) == name.endswith("[prefill]")
            )
        )
        print(f"  launches {name}: {row['launches']}")
        if row["launches"] == 0:
            raise SystemExit(f"{name} was never launched on the serving "
                             "path")
        rows.append(row)
    longest = max(u[0] for _, _, u in serving["split"]["results"])
    name, kw, keep = paged_prefill_case(spipe, longest, gen)
    key, row = check_kernel_case(name, kw, keep)
    row["launches"] = serving["split"]["flash"].get(key, 0)
    print(f"  launches {row['name']}: {row['launches']}")
    if row["launches"] == 0:
        raise SystemExit(f"{row['name']} was never launched on the serving "
                         "path")
    rows.append(row)

    # ---- 15. speculation and megasteps ------------------------------------
    phase_begin("15")
    print(f"phase 15: speculation and megasteps in the ragged engine, "
          f"oryx_7b bf16, {SERVE}, prefill_chunk {PREFILL_CHUNK}, "
          f"k = {SPEC_K} ({card})", flush=True)
    rows.extend(speculation_and_megasteps(
        spipe, serving["ragged_graph"], pool_shape, card))

    # ---- 16. checkpoints on disk and int8 weights --------------------------
    phase_begin("16")
    print(f"phase 16: checkpoints on disk, then phase 2's weights as int8 "
          f"(quantize_params) through chat_batch and the ragged engine, and "
          f"the q8 kernel ({card})", flush=True)
    disk_round_trip(cfg, params)
    rows.extend(int8_weights(params, cfg, reqs, results, card))

    # ---- 8. tiny fp32 engines on the card ---------------------------------
    phase_begin("8")
    print(f"phase 8: tiny fp32 engines (bf16 and int8 pools), card vs CPU "
          f"({card})", flush=True)
    tiny_engines_on_card()

    # ---- 12. the int8 engine, prefix cache and host tier -------------------
    phase_begin("12")
    shared = shared_requests(spipe)
    print(f"phase 12: ContinuousScheduler kv_dtype='int8', oryx_7b bf16, "
          f"{SERVE}, host tier {HOST_CACHE >> 20} MiB; shared-context "
          f"prompts of {[len(spipe._prepare_request({'question': q})[0]) for q in shared]}"
          f" tokens ({card})", flush=True)
    int8_runs = {}
    for mode in ("split", "ragged"):
        runs = [run_int8_engine(spipe, mode == "ragged", i == 0, shared,
                                eager=mode == "ragged" and i == 0)
                for i in range(2)]
        for i, run in enumerate(runs):
            check_int8_run(mode, i, run)
        if runs[1]["results"] != runs[0]["results"]:
            raise SystemExit(f"int8 {mode}: the two runs produced different "
                             "tokens")
        print(f"  int8 {mode}: tokens identical across the two runs"
              + (" (graph route == eager witness)" if mode == "ragged"
                 else ""))
        int8_runs[mode] = runs[0]
        int8_runs[mode + "_graph"] = runs[1]
        n = len(serve_requests())
        same = sum(a[0] == b[0] for a, b in zip(
            runs[0]["results"][:n], serving[mode]["results"]))
        print(f"  int8 {mode} vs phase 7's bf16 pool, replies of the phase-7 "
              f"mix equal (not asserted): {same}/{n}")
    rows_bf16 = 2 * llm.num_layers * pool_shape[0] * pool_shape[1] * (
        llm.num_kv_heads * llm.head_dim * 2)
    print(f"  pool bytes at {pool_shape[0]} pages: int8 "
          f"{int8_runs['split']['pool_bytes'] / 1e9:.4f} GB, bf16 "
          f"{rows_bf16 / 1e9:.4f} GB (ratio "
          f"{int8_runs['split']['pool_bytes'] / rows_bf16:.4f})")
    fp8_launches = {}
    for ragged in (False, True):
        toks, launches, wall = generate_fp8(spipe, shared, ragged)
        print(f"  generate_paged fp8_e4m3 {'ragged' if ragged else 'split'}: "
              f"wall {wall:.3f} s, paged launches {launches}, first row "
              f"{toks[0, :8].tolist()}")
        want = "ragged_paged_fp8_e4m3" if ragged else "paged_decode_fp8_e4m3"
        if not launches.get(want) or toks.shape[1] != MAX_NEW:
            raise SystemExit(f"generate_paged fp8: {launches}")
        fp8_launches.update(launches)

    # ---- 13. the dequantizing paged kernels at phase 12's shapes ----------
    phase_begin("13")
    print(f"phase 13: K3q/K4q vs plain twins at phase 12's call shapes, int8 "
          f"and fp8 pools, bf16, atol=rtol={TOL} ({card})", flush=True)
    dec_calls = int8_runs["split"]["recorder"].calls["paged_decode"]
    rag_calls = int8_runs["ragged"]["recorder"].calls["ragged_paged"]
    qcases = [
        ("paged_decode", "decode",
         _pick(dec_calls, lambda c: int(c[2].sum()))),
        ("ragged_paged", "prefill",
         _pick([c for c in rag_calls if c[0][0][0] > S],
               lambda c: int((c[3] + 1).sum()))),
        ("ragged_paged", "decode",
         _pick([c for c in rag_calls if c[0][0][0] == S],
               lambda c: int((c[3] + 1).sum()))),
    ]
    gen = torch.Generator("cuda").manual_seed(4)
    for fmt in ("int8", "fp8_e4m3"):
        for kind, shape, call in qcases:
            kernel = f"{kind}_{fmt}"
            name = f"{kernel}[{shape}]"
            row = paged_kernel_case(name, kind, call, pool_shape, gen, fmt)
            if fmt == "int8":
                mode = "split" if kind == "paged_decode" else "ragged"
                row["launches"] = sum(
                    n for key, n in int8_runs[mode + "_graph"][
                        "paged_keys"].items()
                    if key[0] == kernel and (
                        kind == "paged_decode"
                        or (key[1] > S) == (shape == "prefill")
                    )
                )
            else:  # generate_paged's fp8 runs: decode steps only
                row["launches"] = (
                    0 if shape == "prefill" else fp8_launches.get(kernel, 0)
                )
            print(f"  launches {name}: {row['launches']}")
            if row["launches"] == 0:
                # No entry point runs fp8 prefill lanes (the engine takes
                # no fp8 pool): checked and timed above, not a path kernel.
                print(f"  {name} is on no path's run; left out of the table")
                continue
            rows.append(row)

    # ---- 19. the HTTP server -----------------------------------------------
    phase_begin("19")
    print(f"phase 19: the OpenAI-compatible server (api_server.build_server)"
          f" over oryx_7b bf16, phase 7's mix without its video as PNG data "
          f"URIs; continuous ragged engine, window engine, drain, supervised "
          f"restart ({card})", flush=True)
    http_serving(Pipeline(ByteTokenizer(), params, cfg, device="cuda"), card)
    gc.collect()

    # ---- 20. the serving observatories -------------------------------------
    phase_begin("20")
    print(f"phase 20: the observatories over HTTP (step timeline, page map, "
          f"OOM forensics, numerics probes, output auditor), oryx_7b bf16, "
          f"{HTTP_SERVE}, {OBS_ARMED} vs unarmed ({card})", flush=True)
    obs_rows, unarmed = observatories(
        Pipeline(ByteTokenizer(), params, cfg, device="cuda"), card)
    rows.extend(obs_rows)
    gc.collect()

    # ---- 21. faults, the journal and its replay, device time, the ladder --
    phase_begin("21")
    print(f"phase 21: fault injection and supervised restart under the "
          f"decision journal with its cold replay, sampled device time and "
          f"/debug/profile, the degraded-mode ladder; oryx_7b bf16 over "
          f"HTTP, {HTTP_SERVE} ({card})", flush=True)
    resilience(Pipeline(ByteTokenizer(), params, cfg, device="cuda"),
               unarmed, card)
    gc.collect()

    # ---- 22 (a). the eval harness over phase 2's pipeline -------------------
    phase_begin("22 (a)")
    print(f"phase 22 (a): the eval harness (eval/harness.evaluate, native "
          f"adapter) over {EVAL_TASK} through phase 2's bf16 Pipeline, "
          f"generate and loglikelihood ({card})", flush=True)
    eval_harness(pipe, card)

    # ---- 23. the fleet front door, the serve CLI, the native loader --------
    phase_begin("23")
    print(f"phase 23: two ragged replicas of oryx_7b bf16 over phase 2's "
          f"weights, {HTTP_SERVE} each, behind serve/router.build_router with "
          f"the lock-order sanitizer and race detector armed and the capture "
          f"watchdog counting; then serve/cli.main and the native loader "
          f"({card})", flush=True)
    fleet_front_door(params, cfg, card)
    gc.collect()
    serve_cli_on_card(params, cfg, reqs, card)
    native_loader_on_card(pipe, reqs, card)

    # ---- 24. tensor-parallel serving on two ranks of the card -------------
    phase_begin("24")
    print(f"phase 24: tensor-parallel serving (--shard tp=2), oryx_7b bf16 "
          f"at full width and depth, two ranks on the one card; chat_batch "
          f"vs the one-process pipeline, the sharded engine (split bf16, "
          f"ragged int8 with the prefix cache), K1/K3/K4 at the per-rank "
          f"shapes, a dead follower ({card})", flush=True)
    rows.extend(tensor_parallel(params, cfg, reqs, toks0, la, lf, card))
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 9. training kernels at the training step's shapes ----------------
    phase_begin("9")
    cfg_t = train_config()
    # The image batch has 4 x 1,936 visual tokens, the video batch 512.
    first_two = list(itertools.islice(train_batches(cfg_t), 2))
    host_img, host_vid = sorted(first_two, key=lambda b: -b["is_visual"].sum())
    if host_vid["is_visual"].sum() > 4096:
        raise SystemExit("the first two training batches are not one image "
                         "and one video batch")
    print(f"phase 9: K1 with lse, K5a, K5b vs plain twins at the training "
          f"step's shapes, bf16 ({card})", flush=True)
    gen = torch.Generator("cuda").manual_seed(3)
    train_rows = []
    for name, kw in training_attention_cases(cfg_t, host_img, host_vid, gen):
        key, case_rows = check_backward_case(name, kw, gen)
        train_rows.append((key, case_rows))

    # ---- 10. Trainer.fit at full width and depth --------------------------
    phase_begin("10")
    print(f"phase 10: Trainer.fit, oryx_7b_pretrain.json at full width and "
          f"depth, {TRAIN_STEPS} steps of {TRAIN_BATCH} records ({card})",
          flush=True)
    snap = train_full_size(cfg_t, params, host_img, train_rows, card)
    for _, case_rows in train_rows:
        rows.extend(case_rows)
    del pipe, pipe_x, pipe_f, spipe
    # The decode graphs phases 3-16 captured live on the model, each with
    # its cache and memory pool: training needs the room.
    for pool in params.llm.__dict__.pop("_decode_graphs", {}).values():
        for graph in pool:
            graph.graph.release()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 17. LoRA SFT at full width ----------------------------------------
    phase_begin("17")
    cfg_l = lora_config()
    print(f"phase 17: Trainer.fit, oryx_7b_sft_lora.json at full width and "
          f"depth on phase 2's weights, {TRAIN_STEPS} steps of {TRAIN_BATCH} "
          f"image/video conversations ({card})", flush=True)
    fits = lora_sft(cfg_l, params, snap, card)
    del snap

    # ---- 18. packed-text training at full width ----------------------------
    phase_begin("18")
    print(f"phase 18: collate_packed_text, {PACK_ROWS} rows of {PACK_BUCKET} "
          f"tokens, Trainer.fit under the LoRA config; K1/K5 at the packed "
          f"call shape ({card})", flush=True)
    rows.extend(packed_training(fits, cfg_l, card,
                                torch.Generator("cuda").manual_seed(10)))

    phase_begin("17 (continued)")
    print(f"phase 17 (continued): merge_lora on the card, the PEFT round "
          f"trip, tiny fp32 LoRA card vs CPU ({card})", flush=True)
    merge_on_card(fits, cfg_l)
    del fits, params
    gc.collect()
    torch.cuda.empty_cache()
    peft_round_trip(cfg_l)
    tiny_training_on_card("lora")

    # ---- 11. tiny fp32 training on the card --------------------------------
    phase_begin("11")
    print(f"phase 11: tiny fp32 Trainer.fit, tune full, card vs CPU ({card})",
          flush=True)
    tiny_training_on_card()

    rows.extend(par_rows)

    phase_begin(None)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
