#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (llmtrain_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Device: nvidia-smi name and power limit, torch/CUDA versions; TF32 off.
2. Build: the four CUDA sources (llmtrain_tpu_torch/csrc/flash_attention_fwd.cu,
   flash_attention_bwd.cu, fused_ce.cu and fused_norm_bwd.cu) with nvcc for
   sm_90a, one nvcc each, started together; register and spill report from
   ptxas, failing on a spill in any instance of fused_norm_bwd.cu; then
   cuobjdump -sass of the built libraries: the count of HMMA/HGMMA
   (tensor-core) instructions of the nine bf16 instances in
   TENSOR_CORE_KERNELS (flash_fwd_kernel, flash_bwd_dq_kernel and
   flash_bwd_dkdv_kernel at head dims 64 and 128, fused_ce_fwd_kernel,
   fused_ce_bwd_dh_kernel and fused_ce_bwd_dw_kernel)
   with their registers and spills, failing if any has no tensor-core
   instruction or spills.
3. Kernels vs their plain versions on the card, each case with a control
   broken on purpose that must land above the tolerance:
   a. flash forward at the serving and training shapes, the llama
      family's training shape (GQA_TRAIN_CASES: 12q/4kv at 64 x 512,
      causal and with phase 21's window) and around them (FLASH_CASES: f32 and bf16 GQA 12q/4kv, segment mask with padding,
      ragged T=200; bf16 T=1, T=65, sliding window, head_dim 128 alone,
      with GQA+segments and with a window; phase 15's two shapes, the
      rolling cache's windowed reference and the int8 logits' forward).
      O on live query rows within 2e-2 for bf16 inputs (one bf16
      rounding of outputs of magnitude ~1) and 1e-4 for f32 (summation
      order only); lse (always f32) within
      1e-4 on every row whose query has a live key. Control: the plain
      version non-causal (window cases: window off; T=1: the other batch
      row's K/V) above the O limit. bf16 cases run twice: bit-identical;
   b. flash backward, dq and dk/dv kernels, at the training shapes and
      the same cases (BWD_RTOL; control: delta left out, lse off by log 2;
      bf16 dq and dk/dv run twice: bit-identical);
   c. fused add+LayerNorm forward (Triton, first compile timed) and
      backward (CUDA) over NORM_CASES: the training path's 32768 x 768
      tokens, f32 and bf16, ragged counts, one row, d 384, d 100 and 2048,
      with and without the residual, the backward with and without the
      residual's gradient gs (LN_RTOL and friends; controls: bias left
      out, the mean(dxhat) term left out; bf16 backward run twice:
      bit-identical);
   d. fused lm-head CE forward, dh and dW at the CE training path's shape
      (32768, 768, 50257) bf16 with and without z-loss, f32, ragged N with
      V below one tile, d 64, a cotangent with zeros, and d 96 with N and V
      ragged against the bf16 dW kernel's tiles (CE_LOSS_RTOL, CE_DH_RTOL,
      CE_DW_RTOL; controls: the label logit read from column label + 1, the
      one-hot term left out of dlogit, the z-loss factor left out of g_lse;
      bf16 forward, dh and dW run twice: bit-identical).
4. Timing: CUDA events over back-to-back launches after warm-up, inputs
   warm in L2 as the ops that produce them leave them; each kernel, its
   plain version, and one PyTorch call as a yardstick never called by the
   port (SDPA forward/backward, F.layer_norm forward/backward; no single
   call computes the fused CE, so its yardstick is the composite F.linear
   -> F.cross_entropy forward/backward, reported as composite_ms);
   the bound from the shapes against the H100 SXM peaks; the LayerNorm
   kernels also by device time (torch.profiler). Forward at the
   serving shape (1, 512, 12, 64) and the training shape (64, 512, 12,
   64), backward at the training shape, LayerNorm at (32768, 768) bf16,
   fused CE at (32768, 768, 50257) bf16.
5. Model: the GPT of configs/presets/gpt_pycorpus_tpu.yaml at full width
   and depth (768 x 12 layers, 12 heads, block 512, byte vocab), seeded
   init, params cast to bf16 as serving does. One T=512 forward through
   the kernel against the same forward through the plain version: logits
   must be finite, (1, 512, 256), and within LOGITS_ATOL (the paths
   differ only in the bf16 rounding of each layer's attention output,
   compounded over 12 residual layers). Controls: the same comparison
   with attention broken on purpose (non-causal, output zeroed, only the
   last 64 keys) must exceed LOGITS_ATOL, or the limit could not tell a
   broken kernel from a right one and the phase fails.
6. Serve: the port's simple-mode HTTP server (make_server/ServerState, as
   `serve` builds it) on 127.0.0.1:0: greedy 32+32 and sampled 32+32
   (temperature 0.8, top_k 40, seed) on the KV-cache branch, no kernel
   launch; greedy 400+160, which exceeds block_size and gets the JAX
   server's 400; and a malformed body (400).
7. Generate: generation.generate(), which the `generate` CLI and the
   server call, greedy 400+160 (total 560 > 512): the re-forward branch,
   >= 12 x 160 kernel launches. Kernel launch counts are reset just
   before phase 6 and read just after phase 7: the serving path.
8. Profile: torch.profiler over one more greedy generate() of 400 +
   PROFILE_NEW_TOKENS (warm from phase 7): wall time, device kernel time and busy share, kernel
   launches per token, top kernels by device time, and the flash
   kernels' device time and share. Measurement only; the profiler's own
   overhead inflates the wall. Every profile of the smoke records the
   device's activity only (kernels and runtime calls, no CPU operator
   events): the readings are the kernels', and the host-side events
   cost tens of seconds to collect over this generate's ~93k launches.
9. Train: the port's `train` (in-process CLI) on gpt_pycorpus_tpu at full
   width, micro batch 64 x 512, into a temp root, with the cuts listed at
   TRAIN_STEPS: every logged loss finite and the last LOSS_DROP_MIN below
   the first; launch counts equal 12 forward, 12 dq and 12 dk/dv per step
   plus 12 forward per eval batch (counts reset just before the call and
   read just after: the training path); `train --resume` from the save
   at TRAIN_SAVE_EVERY ends within RESUME_ATOL of the uninterrupted run;
   `generate` answers a greedy request from the final checkpoint. Prints
   step ms, tokens/s, MFU and peak memory.
10. Fused-norm train: the same config with model.extra.fused_norm: true,
   same init, batches and learning rates, FUSED_STEPS steps: losses
   within FUSED_ATOL of the unfused run's at each step; LayerNorm
   launches 24 forward and 24 backward per step; median step time,
   tokens/s and peak memory.
11. Profile: torch.profiler over one warmed-up training step, of phase
   9's config and of phase 10's: wall, device kernel time and busy share,
   top kernels, the flash kernels' device time and share, and in the
   fused-norm step the LayerNorm kernels'. Measurement only.
12. CE train: the slice-3 configuration, phase 9's config with
   model.vocab_size 50257 and loss_impl unset, which must resolve to
   fused_ce, CE_STEPS steps with one eval and a save at the end: losses
   finite and falling by LOSS_DROP_MIN; launch counts (fused CE forward =
   steps + eval batches, dh = dW = steps, flash 12 per forward and per
   backward; counts reset just before the call and read just after);
   then the same run with loss_impl: dense: per-step losses within
   CE_ATOL, and peak memory at least the bf16 logits (3.07 GiB) above the
   fused run's.
13. Profile: one warmed-up CE training step, as phase 11.
14. Continuous serving of phase 9's final checkpoint at full width, the
   preset's serving defaults (8 slots, 16-token blocks, the default pool
   and buckets): (a) in-process `serve-bench --verify-parity`, greedy,
   CONT_REQUESTS requests of CONT_PROMPTS tokens + CONT_NEW_TOKENS on a
   Poisson open loop at CONT_RATE_RPS; (b) the same sampled (temperature
   0.8, top-k 40) with serving.prefix_cache, serving.prefill_chunk
   CONT_CHUNK and CONT_SHARED_PREFIX shared prefixes, at
   CONT_SLOW_FILL_REQUESTS requests (phase 15(b): SPEC_BENCH_REQUESTS). Gates: exit 0,
   parity bitwise_identical, shapes within the bucket budget, every
   request completed, mean occupancy >= CONT_MIN_OCCUPANCY, the prefix
   cache hit. Then torch.profiler over CONT_PROFILE_STEPS decode steps at
   batch 8 (launches and device time per step; measurement only); then
   (c) `python -m llmtrain_tpu_torch serve --mode continuous` child
   processes on 127.0.0.1:0: 8 concurrent greedy requests all 200 with
   the simple-mode server's tokens, /healthz with the scheduler's stats,
   /metrics, POST /reload answered 200 while CONT_RELOAD_REQUESTS requests
   are in flight (they complete; the first with generate()'s tokens), and
   a server with
   serving.overload queue_cap 1 answering a burst with 429 +
   Retry-After. Kernel launch counts are reset before and read after:
   the paged path launches none of the eight kernels. Prints output
   tokens/s, TTFT and per-token p50/p99, occupancy, the prefix hit rate
   and peak memory.
15. Speculative decoding, int8 serving and the rolling cache on phase 9's
   checkpoint: a draft (the preset at DRAFT_MODEL, DRAFT_STEPS steps)
   trained through `train`; then, launch counts reset just before and
   read just after: (a) `generate --draft-config ... --gamma SPEC_GAMMA`
   greedy on SPEC_PROMPTS x SPEC_NEW_TOKENS equal to plain greedy
   generate(), ms per token with and without the draft, acceptance rate
   and tokens per target call (not gated), and the target as its own
   draft accepting every draft (ceil(128 / (gamma + 1)) target calls a
   prompt); (c) int8 weights: quant_stats, the per-position cosine of
   int8 against bf16 logits on 4 prompts > INT8_LOGIT_COSINE, `generate
   --quantize int8` equal to generate() on the same quantized weights;
   (d) phase 9's weights with sliding_window WINDOW: WINDOW_PREFILL +
   WINDOW_DECODED tokens teacher-forced through the rolling cache (the
   ring turned over once), last-position logits within
   LOGITS_ATOL of the windowed flash forward (the kernel, one launch per
   layer), the same with kv_cache_dtype int8 at a cosine > INT8_CACHE_COSINE,
   and speculative greedy on the rolling target equal to plain greedy;
   (b) phase 14's greedy traffic through `serve-bench --verify-parity`
   with the draft (batched draft-and-verify): bitwise, none failed, verify
   shapes within the budget, the batch full, the acceptance rate printed;
   (c) the same with --quantize int8, its peak memory beside phase 14's. Then the
   windowed instance timed at (1, WINDOW_SEQ, 12, 64) beside its bound.
16. The fleet tier and request tracing on phase 9's checkpoint, launch
   counts reset just before and read just after (none of the eight
   kernels runs). Four `serve` children start together: a `--router
   --replicas 2` server, two replicas with `--trace-dir`, and a
   `--backends` router (a closed port first, then the two replicas) with
   `--trace-dir`. (a) `serve-bench --router --replicas 2 --verify-parity`
   on phase 14(b)'s traffic cut to FLEET_REQUESTS: exit 0, bitwise
   parity, every request
   completed, each replica serving and within its bucket budget, affinity
   routing and fleet prefix hits > 0, report.json, report.md and
   trace.json written, and every request's spans in the `trace merge` of
   the replicas' timelines (trace.json is the router's own track);
   throughput, TTFT and per-token p50/p99, each replica's occupancy, the
   affinity share and the hit rate beside 14(b)'s. (b) POST /reload to the
   `--router` child with CONT_RELOAD_REQUESTS requests of
   FLEET_RELOAD_NEW_TOKENS in flight:
   200, every request 200 and complete, both replicas' epochs advanced in
   /healthz; the child's device memory before and after the roll from its
   log. (c) FLEET_HTTP_REQUESTS concurrent greedy requests through the
   `--backends` child: all 200 with generate()'s tokens, failovers >= 1,
   TTFT exemplars with trace ids on a replica's /metrics; then `trace
   summary`, `trace slowest`, `trace merge` and `trace show` on the trace
   dirs, every trace rebuilt as router/request -> router/http_dispatch ->
   the replica's serve/request (through traceparent) -> serve/prefill and
   serve/decode_phase, its critical path tiling the root. (The traffic
   untraced against traced, a measurement phase 16(d) made until phase 24
   came, is tools/serve_fleet_costs.py's, in turns.)

17. The offline data path and the checkpoint tools, in the same temp root:
   (a) `train-tokenizer` over the stdlib (TOKENIZER_MAX_BYTES, vocab
   TOKENIZER_VOCAB): exit 0, the vocabulary loads and round-trips a stdlib
   file; its seconds printed. (b) `train` on gpt_pycorpus_bpe_tpu at full
   width cut to BPE_LAYERS layers (768 wide, micro batch 64 x 512, bf16, flash)
   with the tracked vocabulary runs/pytok8k.json, cut to BPE_STEPS steps:
   vocab_size null resolves to 8192 and loss_impl to dense; losses finite
   and falling by LOSS_DROP_MIN; launch counts one flash forward, dq and
   dk/dv per layer and step plus one forward per layer and eval batch, none of the others
   (reset just before the call, read just after); the corpus bytes, the
   tokenization seconds and which BPE encoder ran (native C or Python),
   the windows, step ms, tokens/s, MFU and peak memory printed. (c) `eval
   --from` the final checkpoint within EVAL_ATOL of the trainer's own eval
   at that step, and `eval --quantize int8` finite. (d) export-checkpoint
   -> import-checkpoint -> eval bit-identical to (c); average-checkpoints
   --last-k 2 over the two saves -> eval finite; 12 flash forwards per
   eval batch over (c)-(d). (e) gpt_smoke and dummy_smoke trained
   SMOKE_PRESET_STEPS steps on the card: exit 0, finite losses, no kernel.
18. The slice 2 deferrals, in the same temp root: (a) `train` on
   gpt_pycorpus_tpu at full width and depth cut to DDP_STEPS steps, as a
   one-rank NCCL job (distributed.enabled, RANK 0, WORLD_SIZE 1,
   LOCAL_RANK 0, MASTER_ADDR/PORT), with trainer.extra.ema_decay DDP_EMA
   and the step profiler over DDP_PROFILE, in-process through the CLI,
   against the same config without them through the trainer alone: exit
   0, the group's backend nccl, per-step losses within DDP_ATOL (the largest difference
   printed), 12 flash forward, dq and dk/dv per step plus 12 forward per
   eval batch and none of the others (reset just before the call, read
   just after), and the profiler's trace holding an NCCL all-reduce
   kernel and the flash kernels; step ms, tokens/s, MFU and peak memory
   beside the plain run's. (b) `eval --ema` on the final checkpoint:
   finite and not the trainer's own eval at that step; `export-checkpoint
   --ema` -> `import-checkpoint` (the plain config) -> `eval`
   bit-identical to `eval --ema`; 12 flash forwards per eval batch;
   `generate --ema` answers a greedy request. (c) optimizer adamw,
   adafactor and lion, OPT_STEPS steps each (warmup OPT_WARMUP) at
   OPT_LAYERS layers, their
   step ms medians over the same steps: adafactor and lion give finite
   losses, the last below the first; each one's state bytes, step ms and
   peak memory beside AdamW's.
19. Telemetry, in the same temp root (phases 9-13 already wrote JAX's run
   files: telemetry is on by default): (a) phase 9's run dir (`full`)
   holds report.json, report.md and telemetry/{timeline.jsonl, trace.json,
   metrics.prom}; report.json's final loss equals the summary's; the
   memory monitor's peak (mem/hbm_peak) is within 1% of the summary's
   peak_memory with source "memory_stats"; metrics.prom carries the train
   and memory families. (b) `goodput --run-dir` on it: the categories sum
   to the wall (no balance error), and productive_train plus the data
   wait, checkpoint and eval categories cover at least GOODPUT_COVERED of
   the logged step times summed (a logged step time also holds the log
   boundary's own host work, so productive_train alone sits below it).
   (c) `profile --steps 3 --serve` on phase 9's config (its warmup cut to
   the 3 steps), launch counts reset
   just before and read just after (12 flash forward, dq and dk/dv per
   step plus 12 forward per eval batch: the cost count launches nothing):
   the train step's top_ops list the three flash kernels at 12 calls each,
   the analytical MFU is <= 1 and reconciled, and the prefill and decode
   counts are there. (d) the cost count of phase 12's CE run, from its run
   dir's config.yaml: top_ops list the three fused-CE kernels once each,
   and its flops equal the attribution in that run's report.json. (e)
   TEL_STEPS steps with telemetry.enabled false and with it on plus the
   native tracker (TEL_ARMS: off, then on), launch counts reset
   before and read after: the per-run medians of the step time (steps 6
   on) with their spread, each arm's median, and each arm's wall a step by
   the log's timestamps (which, unlike the logged step time, holds the log
   boundary's flush); a measurement, not a gate. The phase's seconds on their own line.
20. Resilience, in the same temp root: (a) phase 9's config cut to
   RES_STEPS steps through `train`, with the non-finite guard, a one-step
   NaN window at RES_NAN_AT, a 100x spike of the observed loss at
   RES_SPIKE_AT, saves every RES_SAVE_EVERY and one rollback allowed,
   launch counts reset just before and read just after: one update
   skipped, exactly one rollback, to the save before the spike; 12 flash
   forward, dq and dk/dv per executed step (RES_STEPS plus the replayed
   ones) plus 12 forward per eval batch, none of the others; the timeline
   holds `rollback_restore`, `checkpoint_wait` and events tagged
   rolled_back; the losses finite but the NaN step's and falling by
   LOSS_DROP_MIN; the goodput ledger balanced; the guarded step's median
   beside phase 9's over the same steps. (b) a `python -m
   llmtrain_tpu_torch train` child (run beside (c)'s children since
   phase 23 came; PERF.md §2) hung at WD_HANG_AT with the watchdog
   at WD_STALL_SEC: exit 76 with "HANG DETECTED", a hang report holding
   the thread stacks and the device section (the allocator's bytes,
   nvidia-smi), a heartbeat younger than the timeout plus
   WD_EXIT_SLACK_SEC. (c) `chaos --cycles CHAOS_CYCLES` on phase 9's config
   cut to CHAOS_STEPS steps and CHAOS_LAYERS layers at full width, each
   segment a `train` child on the card:
   exit 0, the kills delivered (one inside a checkpoint write), the
   newest commit loadable after each cycle, and the loss trajectory and
   final params and optimizer state bitwise equal to the uninterrupted
   run's; no kernel launched in this process over (b)-(c). (d)
   measurement only: phase 9's `checkpoint_save` spans (the gather; the
   write runs on the manager's thread) and its ledger's checkpoint
   seconds. Phase 25's `tune` child runs beside (b)-(c)'s children. The
   phase's seconds on their own line.
21. The model zoo, in the same temp root, launch counts reset just before
   and read just after each training, generate and eval path: (a) `train`
   on llama_pycorpus_tpu at full width, ZOO_LLAMA_LAYERS deep (768 x 6
   of the cell's 12 layers, 12 query heads over 4 KV heads, SwiGLU d_ff
   2048, RoPE, RMSNorm, byte vocab, flash), micro batch 64 x 512,
   ZOO_STEPS steps with one eval and a save: losses finite and falling by
   LOSS_DROP_MIN, exactly one flash forward, dq and dk/dv per layer and
   step plus one forward per layer and eval batch, none of the others;
   step ms, tokens/s, MFU (6N + 12·L·T·d with the counted N) and peak
   memory. (b) From its checkpoint: generate() greedy 400+160 past
   block_size (the re-forward branch, >= layers x 160 GQA forward
   launches); in-process `serve-bench --verify-parity` of ZOO_REQUESTS
   greedy requests, bitwise equal to generate(), every one completed;
   `eval`, `export-checkpoint` to HF Llama names, then
   `import-checkpoint` and `eval`: bit-identical, within EVAL_ATOL of the
   trainer's eval (one forward per layer and eval batch each). (c) Qwen2 and Gemma
   on the same config at ZOO_SMALL_LAYERS layers, ZOO_SMALL_STEPS steps
   each (qkv biases and the 1e6 RoPE base; GeGLU, offset norms and the
   bf16 sqrt(d) embedding scale): finite losses, the counts, a greedy
   `generate` (the KV cache: no kernel). (d) The Mixtral layout,
   llama_moe with 4 experts, top 2, capacity factor 2 and sliding window
   ZOO_WINDOW, at ZOO_SMALL_LAYERS layers, ZOO_MOE_STEPS steps: losses
   finite and falling, the windowed flash launches counted, `generate`.
   (e) gpt_lora_ft at full width and ZOO_SMALL_LAYERS layers (12 until
   phase 23 came), ZOO_LORA_STEPS steps: every base leaf
   of the checkpoint bit-identical to the seed's init, every factor B
   moved; `export-checkpoint` (merged) imported into the config without
   LoRA: its `eval` within EVAL_ATOL of the LoRA run's `eval` (itself
   within EVAL_ATOL of the trainer's), and it generates the LoRA run's
   greedy tokens. Step times are the median of the logged steps past the
   warm-up and before the last, each listed. The phase's seconds on
   their own line. Phase 4 also times the flash kernels at the GQA
   training shape (64, 512, 12 over 4, 64) against SDPA with
   enable_gqa=True, the kernels line carrying them as gqa_shape_*.
22. Parallelism on one device, in the same temp root, at phase 9's width
   and depth, launch counts reset just before and read just after each
   path: (a) fp8_supported() on the card; the fp8 product
   (torch._scaled_mm, f32 accumulation) at the cell's four projection
   shapes, 32768 tokens, against its plain version within FP8_RTOL of
   the largest output, a control with one scale dropped above it, and its
   time beside bf16 F.linear; then `train` with matmul_precision int8 and
   fp8, QUANT_STEPS steps inside phase 9's warmup (so phase 9's losses are
   the f32 trajectory step for step): losses finite, falling, within
   PARITY_RTOL of phase 9's and not one of them bitwise phase 9's (the
   quantized products ran), report.json's matmul_precision the mode, the
   flash counts; a profile of the fp8 run's last step holding the e4m3
   GEMM kernel that torch._scaled_mm launched above, the step's matmul
   kernels listed; step ms, tokens/s, MFU and peak memory; `generate`
   from the fp8 checkpoint. (b) The ladders none, selective:*, full:*,
   offload:0-5,full:6-11 and, with fused_norm, none and full:*, each
   LADDER_STEPS steps of the trainer's step on the same init and batches:
   step 1's loss bitwise the ladder without remat's and its gradients
   bitwise or within GRAD_ATOL/GRAD_RTOL (which held is printed); the
   flash forward (and the LayerNorm forward) launched twice a layer and
   step under remat, once without; a profile of the full ladder's third
   step holding flash forwards after the backward's first dq kernel (the
   recompute); peak memory, and the bytes allocated when step 1's
   backward starts (what each ladder holds from its forward), strictly
   none > selective > full > offload; under offload the pinned host
   allocator's pool (torch.cuda.memory.host_memory_stats) grown by at
   least the staged block inputs' bytes. (c)
   Phase 18(a)'s one-rank NCCL job under trainer.zero, stage 1 with
   host_offload and stage 2, DDP_STEPS steps each: every loss bitwise the
   plain one-rank job's, report.json's opt_state_bytes_host AdamW's state
   bytes and 0 per device under the offload, each step time beside the
   plain job's.

23. Meshes at one rank, in the same temp root (the mesh code on the card:
   distributed/mesh.py, autotune/plan.py, parallel/mesh_params.py, the
   sequence-parallel attention): (a) phase 18(a)'s one-rank NCCL job with
   every axis of distributed.mesh spelled out at 1 (MESH_ONE), DDP_STEPS
   steps: every loss bitwise phase 18(a)'s, its checkpoint manifest's
   topology that mesh over one process, the flash counts. (b) The
   blockwise attention that ring and ulysses run with no sequence axis,
   in f32 against the dense plain version at SEQ_CHECK_SHAPE: the
   attention of ring_or_blockwise, then ulysses_or_blockwise, forward
   within SEQ_FWD_ATOL, dq, dk and dv within SEQ_GRAD_ATOL +
   SEQ_GRAD_RTOL; one attention layer of the cell's width under each
   against the same layer under dense attention (output, input gradient,
   and the projections' gradients normwise: _seq_one_layer); the ring's
   own turns (ops/ring_attention.py ring_turns_on_one_device: SEQ_SHARDS
   shards, each a rank, in lockstep) forward and gradients within the
   same bands, and its control, the same loop with every shard's
   kv_offset forced to 0, above SEQ_FWD_ATOL. Then phase 9's
   config at SEQ_LAYERS layers with block_size SEQ_BLOCK, micro batch
   SEQ_MICRO (the cell's tokens a step), SEQ_STEPS steps under ring,
   ulysses and flash: losses finite and falling, no flash launch under
   ring and ulysses (blockwise is plain torch) and the flash counts
   under flash; each step time and peak memory printed beside flash's.
   The phase's seconds on its [clock] line.

24. The pipeline, in the same temp root: (a) phase 9's initial weights,
   written as the reference torch GPT file, `import-checkpoint` into phase
   9's config as `gpt_pipeline` (the cell's width and depth, bf16 over f32
   params, flash, one rank: the whole stack on the card) and `train
   --resume` from it, PIPE_STEPS steps with an eval and a save at the end,
   launch counts reset just before and read just after: losses finite and
   falling, step 1's within FUSED_ATOL (the twin band: the pipeline's
   two-pass LayerNorm and einsum projections against the GPT's) of phase
   9's step 1, 12 flash forward, dq and dk/dv per step plus 12 forward
   per eval batch; step ms, tokens/s, MFU and peak memory beside phase
   9's. (b) The schedule of parallel/pipeline.py on the card, its stages
   in lockstep in one process (gpipe_on_one_device): GPipe as 4 stages of
   3 layers and the interleaved one as 2 stages x 2 chunks, PIPE_MICRO
   microbatches of PIPE_CHECK_BATCH rows of the cell, f32, the stages'
   flash kernels and remat_stage: the forward and the gradients of every
   stacked parameter and of the input against the sequential stack within
   PIPE_FWD_RTOL and PIPE_GRAD_RTOL (normwise), the control with every
   hop two stages on (the stages' layer rows rotated by two stages) at
   least PIPE_CONTROL_FACTOR x the forward band, the flash launches the
   schedules imply. (c) `generate` greedy from (a)'s checkpoint against
   generate() of the same weights saved as gpt (`export-checkpoint`'s
   reference torch GPT file loaded into phase 9's GPT, cast for decoding
   as `generate` casts them): bitwise the same tokens. The phase's
   seconds on its [clock] line.
25. Autotune, in the same temp root: `plan` on phase 9's config exits 0,
   its predicted memory printed beside phase 9's measured peak; `plan` at
   micro batch PLAN_OVER_LIMIT_MICRO exits 2 (over the card's memory);
   `tune` on gpt_tune_smoke on the card at its own budget (two probes of
   three steps, each a `train` child) as a child process started beside
   phase 20's children (start_tune): the baseline probed, the winner's
   measured MFU at least the baseline's, the emitted config trained one
   step.
26. Lifecycle and fleet, in the same temp root: (a) `promote` at full
   width on a copy of phase 9's run: a poisoned step 30 committed into
   its stream through the port's CheckpointManager (the model as the
   run's seed initialises it), step 40 and report.json held back and
   released once the ledger holds step 30's rollback, a heartbeat kept
   fresh meanwhile; `promote --from <step 20> --max-promotions 0` on
   phase 9's config with gpt_promote_smoke's serving (2 in-process
   replicas) and promote sections: exit 0, status training_finished, the
   ledger canary_start 30, rollback 30 (eval_regression), canary_start
   40, promote 40, no soak request failed, both replicas at step 40, the
   flash forward launched n_layers x eval_batches per evaluation the
   controller ran and no other kernel, and `goodput --json` on the copy
   with 1 promoted and 1 rolled back; (b) `fleet --storm --seed
   STORM_SEED` on gpt_fleet_smoke on the card (the byte cell's widths and
   flash attention at STORM_LAYERS layers, micro batch STORM_MICRO, both
   tenants fixed at one rank, tenant-b a LoRA fine-tune) as a child
   process started with phase 20 (start_storm): exit 0,
   every tenant completed with bitwise parity, an eviction, the
   mid-checkpoint kill, a capacity change, fleet_report.json written.

Then it prints the kernels line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

H100_HBM_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PATH_SHAPE = (1, 512, 12, 12, 64)  # B, T, H, Hkv, D at the serving path
TRAIN_SHAPE = (64, 512, 12, 12, 64)  # B, T, H, Hkv, D at the training path
GQA_TRAIN_SHAPE = (64, 512, 12, 4, 64)  # llama_pycorpus_tpu's training path (phase 21)
ZOO_WINDOW = 128  # the sliding window of phase 21's Mixtral layout
LN_TOKENS, LN_DIM = 64 * 512, 768  # tokens and width at the training path
CUDA_SOURCES = ("flash_attention_fwd.cu", "flash_attention_bwd.cu", "fused_ce.cu",
                "fused_norm_bwd.cu")
ATOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
ATOL_LSE = 1e-4
LOGITS_ATOL = 0.1


def log(*parts: object) -> None:
    print(*parts, flush=True)


_START = time.perf_counter()


def clock(done: str) -> None:
    """One line of the run's timeline: the seconds since the script
    started, at the end of each phase (the 1200 s budget's ledger)."""
    log(f"[clock] {time.perf_counter() - _START:7.1f} s  {done}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_device(torch) -> str:
    smi = nvidia_smi_line()
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# The redesigned kernels' bf16 instances, which must run on the tensor
# cores: HMMA (mma.sync) or HGMMA (wgmma) in their SASS. Per source, each
# kernel with the int template arguments of its instances (head dims for
# the flash kernels; none for the fused CE forward, dh and dW).
TENSOR_CORE_KERNELS = {
    "flash_attention_fwd.cu": [("flash_fwd_kernel", (64,)), ("flash_fwd_kernel", (128,))],
    "flash_attention_bwd.cu": [
        ("flash_bwd_dq_kernel", (64,)), ("flash_bwd_dq_kernel", (128,)),
        ("flash_bwd_dkdv_kernel", (64,)), ("flash_bwd_dkdv_kernel", (128,)),
    ],
    "fused_ce.cu": [("fused_ce_fwd_kernel", ()), ("fused_ce_bwd_dh_kernel", ()),
                    ("fused_ce_bwd_dw_kernel", ())],
}


# Sources without tensor-core instructions whose every instance must
# still fit its registers: the build fails on a spill in any of them.
NO_SPILL_SOURCES = ("fused_norm_bwd.cu",)


def tensor_core_instance(kernel: str, dims: tuple[int, ...]) -> tuple[str, str]:
    """(label, mangled-name fragment) of ``kernel<dims..., __nv_bfloat16>``."""
    args = "".join(f"Li{d}E" for d in dims)
    label = ", ".join([*(str(d) for d in dims), "bf16"])
    return f"{kernel}<{label}>", f"{len(kernel)}{kernel}I{args}13__nv_bfloat16E"


def find_cuobjdump() -> str:
    """The toolkit's cuobjdump, else the copy in Triton's package."""
    import importlib.util
    import os
    import shutil

    from llmtrain_tpu_torch.ops.kernel_build import find_nvcc

    candidates = [Path(find_nvcc()).parent / "cuobjdump"]
    if shutil.which("cuobjdump"):
        candidates.append(Path(shutil.which("cuobjdump")))
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        for loc in spec.submodule_search_locations:
            candidates.append(Path(loc) / "backends" / "nvidia" / "bin" / "cuobjdump")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(f"cuobjdump not found (looked at {[str(c) for c in candidates]})")


def sass_mma_counts(sass: str) -> dict[str, int]:
    """Mangled kernel name -> number of HMMA/HGMMA instructions in its
    SASS, from the text of ``cuobjdump -sass``."""
    import re

    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            current = m.group(1)
            counts[current] = 0
        elif current and re.search(r"\bHG?MMA\b", line):
            counts[current] += 1
    return counts


def ptxas_resources(report: str) -> dict[str, str]:
    """Mangled kernel name -> its registers and spills from -Xptxas -v."""
    import re

    res, current = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            res[current] = []
        elif current and ("registers" in line or "spill" in line):
            res[current].append(line.split(":", 1)[-1].strip())
    return {name: "; ".join(parts) for name, parts in res.items()}


def phase_build() -> None:
    """One nvcc per CUDA source, all started together; then the SASS of
    the redesigned bf16 kernels must hold tensor-core instructions, and
    ptxas must report no spills for them or for any instance of the
    NO_SPILL_SOURCES."""
    import re

    from llmtrain_tpu_torch.ops.kernel_build import CSRC_DIR, build_libraries

    t0 = time.perf_counter()
    results = build_libraries([CSRC_DIR / name for name in CUDA_SOURCES])
    for r in results:
        log(f"[build] {r.source.name}: nvcc {r.seconds:.2f}s -> {r.library.name}")
        for name, resources in ptxas_resources(r.ptxas_report).items():
            log(f"[build]   {name}: {resources}")
    log(f"[build] all CUDA sources in {time.perf_counter() - t0:.2f}s wall")
    for r in results:
        if r.source.name in NO_SPILL_SOURCES:
            resources = ptxas_resources(r.ptxas_report)
            spilled = {n: x for n, x in resources.items()
                       if re.search(r"\b[1-9]\d* bytes spill", x)}
            log(f"[build] {r.source.name}: {len(resources)} instances (bf16 and f32), "
                f"{len(spilled)} spill")
            if not resources or spilled:
                raise RuntimeError(f"{r.source.name}: no ptxas report or spills: {spilled}")
        if r.source.name not in TENSOR_CORE_KERNELS:
            continue
        sass = subprocess.run([find_cuobjdump(), "-sass", str(r.library)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        counts = sass_mma_counts(sass)
        resources = ptxas_resources(r.ptxas_report)
        for kernel, dims in TENSOR_CORE_KERNELS[r.source.name]:
            label, tag = tensor_core_instance(kernel, dims)
            names = [n for n in counts if tag in n]
            n_mma = sum(counts[n] for n in names)
            regs = "; ".join(resources.get(n, "no ptxas line") for n in names)
            log(f"[build] {label}: {n_mma} HMMA/HGMMA instructions in SASS; ptxas: {regs}")
            if not names or n_mma == 0:
                raise RuntimeError(f"{label} has no tensor-core instruction")
            if re.search(r"\b[1-9]\d* bytes spill", regs):
                raise RuntimeError(f"{label} spills registers: {regs}")


def _qkv(torch, gen, b, t, h, hkv, d, dtype):
    def rnd(heads):
        return torch.randn(b, t, heads, d, device="cuda", generator=gen).to(dtype)

    return rnd(h), rnd(hkv), rnd(hkv)


def _segments(torch, b, t):
    """Two documents per row, and the last 37 tokens of row 0 padding."""
    mask = torch.ones(b, t, dtype=torch.int32, device="cuda")
    mask[:, t // 3 :] = 2  # a second document
    mask[0, max(0, t - 37) :] = 0  # padding
    return mask


# Phase 15's shapes that launch the flash forward: the rolling cache's
# reference, the windowed forward over WINDOW_SEQ tokens, and the int8
# logits' two full forwards over INT8_LOGIT_IDS (batch, tokens).
WINDOW = 128
WINDOW_SEQ = 384
INT8_LOGIT_IDS = (4, 256)

# Cases of the flash check phases: (name, (B, T, H, Hkv, D), dtype,
# segment mask or not, window). The bf16 ones run the tensor-core
# instances of the forward and dk/dv kernels, the f32 ones the FMA
# instances; T=1 and T=65 put a ragged tail in the first and second key
# tile.
FLASH_CASES = [
    ("f32", (2, 384, 12, 12, 64), "float32", False, 0),
    ("gqa 12q/4kv", (2, 256, 12, 4, 64), "float32", False, 0),
    ("segments+padding", (2, 256, 12, 12, 64), "float32", True, 0),
    ("ragged T=200", (1, 200, 12, 12, 64), "float32", False, 0),
    ("window 128", (2, 512, 12, 12, 64), "bfloat16", False, 128),
    ("gqa 12q/4kv", (2, 256, 12, 4, 64), "bfloat16", False, 0),
    ("segments+padding", (2, 256, 12, 12, 64), "bfloat16", True, 0),
    ("ragged T=200", (1, 200, 12, 12, 64), "bfloat16", False, 0),
    ("T=1", (2, 1, 12, 12, 64), "bfloat16", False, 0),
    ("T=65", (2, 65, 12, 12, 64), "bfloat16", False, 0),
    ("head_dim 128", (2, 256, 8, 8, 128), "bfloat16", False, 0),
    ("d128 gqa+segments", (2, 200, 8, 2, 128), "bfloat16", True, 0),
    ("d128 window 100", (1, 300, 8, 8, 128), "bfloat16", False, 100),
    ("rolling reference", (1, WINDOW_SEQ, 12, 12, 64), "bfloat16", False, WINDOW),
    ("int8 logits", (*INT8_LOGIT_IDS, 12, 12, 64), "bfloat16", False, 0),
]

# The llama family's training shapes (phase 21): 12 query heads over 4 KV
# heads, causal (llama_pycorpus_tpu) and with the window of ZOO_WINDOW
# (the Mixtral layout, llama_moe).
GQA_TRAIN_CASES = [
    ("gqa train shape", GQA_TRAIN_SHAPE, "bfloat16", False, 0),
    ("gqa window train", GQA_TRAIN_SHAPE, "bfloat16", False, ZOO_WINDOW),
]


def phase_kernel_checks(torch) -> float:
    """Kernel 1 (forward) against its plain version. Control per case: the
    plain version run non-causal (in the window cases, causal with the
    window off) must land above ATOL_O; at T = 1 every mask computes the
    same O = V, so that case's control reads the other batch row's K/V
    instead. bf16 cases also launch the kernel twice: O and lse must be
    bit-identical."""
    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [
        ("path shape", PATH_SHAPE, "bfloat16", False, 0),
        ("train shape", TRAIN_SHAPE, "bfloat16", False, 0),
        *GQA_TRAIN_CASES,
        *FLASH_CASES,
    ]
    errors = {}
    for name, (b, t, h, hkv, d), dt_name, segmented, window in cases:
        dtype = getattr(torch, dt_name)
        q, k, v = _qkv(torch, gen, b, t, h, hkv, d, dtype)
        mask = _segments(torch, b, t) if segmented else None
        out, lse = flash_attention_fwd(q, k, v, mask, causal=True, window=window)
        same = True
        if dtype == torch.bfloat16:
            out2, lse2 = flash_attention_fwd(q, k, v, mask, causal=True, window=window)
            same = torch.equal(out, out2) and torch.equal(lse, lse2)
        torch.cuda.synchronize()
        ref_out, ref_lse = flash_attention_fwd_reference(q, k, v, mask, causal=True, window=window)
        if t == 1:
            control = "k/v of the other batch row"
            broken = flash_attention_fwd_reference(q, k.flip(0), v.flip(0), mask, causal=True)[0]
        elif window:
            control = "window off"
            broken = flash_attention_fwd_reference(q, k, v, mask, causal=True)[0]
        else:
            control = "non-causal"
            broken = flash_attention_fwd_reference(q, k, v, mask, causal=False)[0]
        live = torch.ones(b, t, dtype=torch.bool, device="cuda") if mask is None else mask != 0
        o_err = (out.float() - ref_out.float()).abs()[live].max().item()
        ctrl = (out.float() - broken.float()).abs()[live].max().item()
        lse_err = (lse - ref_lse).view(b, h, t).transpose(1, 2)[live].abs().max().item()
        tol = ATOL_O[dt_name]
        ok = (o_err <= tol and lse_err <= ATOL_LSE and ctrl > tol and same
              and torch.isfinite(out[live]).all().item())
        log(f"[kernel] {name:18s} B{b} T{t} H{h}/{hkv} D{d} {dt_name:8s} "
            f"window={window} O err {o_err:.3e} (atol {tol:g})  lse err {lse_err:.3e} "
            f"(atol {ATOL_LSE:g})  control ({control}) {ctrl:.3e}"
            f"{'  rerun bit-identical' if dtype == torch.bfloat16 and same else ''}"
            f"{'' if same else '  RERUN DIFFERS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash kernel disagrees with its plain version: {name}")
        errors[f"{name} {dt_name}"] = o_err
    return errors


def _time_ms(torch, fn, iters: int = 100, warmup: int = 10) -> float:
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


def flash_bound(b, t, h, hkv, d, elt_bytes, dtype_name, causal=True, window=0):
    """Least time for the work: (bytes moved, flops, bound ms, bound_by).
    A sliding window counts only the (query, key) pairs inside it."""
    moved = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt_bytes + 4 * b * h * t
    if window:
        pairs = sum(min(i + 1, window) for i in range(t))
    else:
        pairs = t * (t + 1) // 2 if causal else t * t
    flops = 4 * d * pairs * b * h
    t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
    return moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_timing(torch, smi: str, shape=PATH_SHAPE, iters: int = 100, window: int = 0) -> dict:
    """Kernel 1 against its plain version, SDPA and the bound at ``shape``,
    causal, or with a sliding ``window`` (SDPA then takes the band as a
    boolean mask); under GQA (Hkv < H) SDPA reads the narrow K/V with
    ``enable_gqa=True``."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops.flash_attention import (
        flash_attention_fwd,
        flash_attention_fwd_reference,
    )

    b, t, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _qkv(torch, gen, b, t, h, hkv, d, torch.bfloat16)
    with torch.inference_mode():
        ms = _time_ms(torch, lambda: flash_attention_fwd(q, k, v, causal=True, window=window),
                      iters=iters)
        plain_ms = _time_ms(
            torch, lambda: flash_attention_fwd_reference(q, k, v, causal=True, window=window),
            iters=max(5, iters // 10), warmup=2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        gqa = {"enable_gqa": True} if hkv != h else {}
        if window:
            pos = torch.arange(t, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < window)
            library_ms = _time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band, **gqa),
                iters=iters)
        else:
            library_ms = _time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa),
                iters=iters,
            )
    moved, flops, bound_ms, bound_by = flash_bound(b, t, h, hkv, d, 2, "bfloat16", window=window)
    mask = f"window {window}" if window else "causal"
    log(f"[timing] flash_attention_fwd at (B,T,H,Hkv,D)=({b},{t},{h},{hkv},{d}) bf16 {mask} "
        f"on {smi}:")
    log(f"[timing]   kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa (yardstick) {library_ms:.4f} ms")
    log(f"[timing]   bound {bound_ms:.6f} ms by {bound_by} ({moved} bytes at 3.35 TB/s, "
        f"{flops} flop at 989 TFLOP/s bf16); kernel at {bound_ms / ms:.2%} of the bound")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


# Backward tolerances, relative to the largest magnitude of the plain
# version's output: bf16 outputs are rounded once on each side from f32
# sums taken in another order, so they may differ by one bf16 ulp of the
# largest element (2^-8) -- the limit allows two; f32 outputs differ only
# in summation order and expf rounding.
BWD_RTOL = {"bfloat16": 2**-7, "float32": 1e-4}
# Fused LayerNorm: y, s and ds as above; mean/rstd (f32 either way) and
# dscale/dbias (f32 sums over every token, in another order) relative.
LN_RTOL = {"bfloat16": 2**-7, "float32": 1e-5}
LN_STATS_RTOL = 1e-5
LN_PARAM_GRAD_RTOL = 1e-4


def _rel_err(torch, got, ref, rows=None, denom=None) -> float:
    """max |got - ref| over the largest |ref| (or over ``denom``)."""
    got, ref = got.float(), ref.float()
    if rows is not None:
        got, ref = got[rows], ref[rows]
    scale = ref.abs().max().clamp_min(1e-30) if denom is None else denom
    return ((got - ref).abs().max() / scale).item()


def phase_bwd_checks(torch) -> dict:
    """Kernels 2 and 3 (dq, dk/dv) against their plain version, on the
    forward kernel's (out, lse); a control per case: the plain version
    broken on purpose, delta left out and lse off by log 2 (P halved),
    must land above the tolerance on dq, dk and dv. bf16 cases launch
    both kernels twice: dQ, dK and dV must be bit-identical. At T = 1 the
    exact dq and dk are 0 (a softmax over one key has no gradient in its
    logit), so both sides are rounding noise; there dq and dk are held,
    with the same tolerance, relative to the largest |dV| of the plain
    version instead of their own."""
    from llmtrain_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(10)
    cases = [("train shape", TRAIN_SHAPE, "bfloat16", False, 0), *GQA_TRAIN_CASES,
             *FLASH_CASES]
    errors = {}
    for name, (b, t, h, hkv, d), dt_name, segmented, window in cases:
        dtype = getattr(torch, dt_name)
        q, k, v = _qkv(torch, gen, b, t, h, hkv, d, dtype)
        dout = torch.randn(b, t, h, d, device="cuda", generator=gen).to(dtype)
        mask = None
        if segmented:
            mask = _segments(torch, b, t)
            # The model zeroes padded rows after out_proj, so their dO is 0.
            dout = dout * (mask != 0)[:, :, None, None].to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True, window=window)
        delta = fa.attention_delta(out, dout)
        dq = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, window=window)
        dk, dv = fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, mask, window=window)
        same = True
        if dtype == torch.bfloat16:
            dq2 = fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta, mask, window=window)
            dk2, dv2 = fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta, mask, window=window)
            same = torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)
        torch.cuda.synchronize()
        ref = fa._bwd_reference_from_delta(q, k, v, dout, lse, delta, mask, True, window)
        broken = fa._bwd_reference_from_delta(
            q, k, v, dout, lse + math.log(2.0), torch.zeros_like(delta), mask, True, window
        )
        tol = BWD_RTOL[dt_name]
        grads = dict(zip(("dq", "dk", "dv"), (dq, dk, dv)))
        refs = dict(zip(("dq", "dk", "dv"), ref))
        scale = {n: None for n in grads}
        if t == 1:
            scale["dq"] = scale["dk"] = refs["dv"].float().abs().max().item()
        errs = {n: _rel_err(torch, grads[n], refs[n], denom=scale[n]) for n in grads}
        ctrl = {n: _rel_err(torch, got, r) for n, got, r in zip(grads, grads.values(), broken)}
        finite = all(torch.isfinite(x).all().item() for x in (dq, dk, dv))
        ok = finite and same and max(errs.values()) <= tol and min(ctrl.values()) > tol
        log(f"[bwd] {name:18s} B{b} T{t} H{h}/{hkv} D{d} {dt_name:8s} window={window} "
            + " ".join(f"{n} {e:.2e}" for n, e in errs.items())
            + f" (rtol {tol:g}{', dq/dk relative to max |dV|' if t == 1 else ''}); control "
            + " ".join(f"{n} {e:.2e}" for n, e in ctrl.items())
            + f"{'  dq, dk/dv rerun bit-identical' if dtype == torch.bfloat16 and same else ''}"
            + f"{'' if same else '  RERUN DIFFERS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"flash backward kernels disagree with their plain version: {name}")
        errors[f"{name} {dt_name}"] = {n: (grads[n].float() - refs[n].float()).abs().max().item()
                                       for n in grads}
        del ref, broken
    return errors


# Cases of the LayerNorm check phase: (name, tokens, width, dtype name,
# residual or not, mean of the cotangent gy). The training path's (32768,
# 768) and around it: a ragged count, one row, the width of d_model 384,
# and widths the backward kernel takes on its general path (d = 100 in
# bf16, not whole 16-byte vectors; d = 2048, above its register path) or
# with masked lanes (d = 100 in f32: 25 vectors of four). The one row's gy
# has mean 1: with zero-mean noise one row's mean(dxhat) is ~0.04, and the
# control that leaves it out falls under 2^-7 for 40% of seeds.
NORM_CASES = [
    ("train tokens, residual", LN_TOKENS, LN_DIM, "bfloat16", True, 0.0),
    ("train tokens", LN_TOKENS, LN_DIM, "bfloat16", False, 0.0),
    ("f32, residual", LN_TOKENS, LN_DIM, "float32", True, 0.0),
    ("ragged 32731, residual", LN_TOKENS - 37, LN_DIM, "bfloat16", True, 0.0),
    ("ragged 1001 f32", 1001, LN_DIM, "float32", False, 0.0),
    ("d 384, residual", LN_TOKENS, 384, "bfloat16", True, 0.0),
    ("d 100 f32", 1001, 100, "float32", False, 0.0),
    ("d 100 (general path)", 4099, 100, "bfloat16", True, 0.0),
    ("d 2048 (general path)", 3000, 2048, "bfloat16", False, 0.0),
    ("n = 1", 1, LN_DIM, "bfloat16", True, 1.0),
]


def phase_norm_checks(torch) -> dict:
    """Kernels 4 and 5 (fused add+LayerNorm forward, Triton, and backward,
    CUDA) against their plain versions over NORM_CASES; the backward both
    without and with the residual stream's gradient gs (dx = ds + gs with
    the two roundings of ``(ds + gs).to(dtype)``). Controls: the forward
    without its bias and the backward without its mean(dxhat) term must
    land above the tolerances. bf16 cases run the backward twice: ds, dx,
    dscale and dbias must be bit-identical. The first call also compiles
    the Triton forward (timed)."""
    from llmtrain_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(11)
    gen_gs = torch.Generator(device="cuda").manual_seed(14)
    errors = {}
    for i, (name, n, d, dt_name, with_res, gy_mean) in enumerate(NORM_CASES):
        dtype = getattr(torch, dt_name)
        x = (torch.randn(n, d, device="cuda", generator=gen) * 2 + 0.5).to(dtype)
        res = torch.randn(n, d, device="cuda", generator=gen).to(dtype) if with_res else None
        scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=gen)
        bias = 0.5 * torch.randn(d, device="cuda", generator=gen)
        gy = (torch.randn(n, d, device="cuda", generator=gen) + gy_mean).to(dtype)
        gs = torch.randn(n, d, device="cuda", generator=gen_gs).to(dtype)
        t0 = time.perf_counter()
        y, s, mean, rstd = fn.fused_norm_fwd(x, res, scale, bias)
        ds, dscale, dbias = fn.fused_norm_bwd(s, scale, mean, rstd, gy)
        dx, dscale_gs, dbias_gs = fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs)
        torch.cuda.synchronize()
        if i == 0:
            log(f"[norm] first calls (Triton compile of the forward): "
                f"{time.perf_counter() - t0:.2f}s")
        same = True
        if dtype == torch.bfloat16:
            again = (*fn.fused_norm_bwd(s, scale, mean, rstd, gy),
                     *fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs))
            same = all(torch.equal(a, b) for a, b in zip(
                again, (ds, dscale, dbias, dx, dscale_gs, dbias_gs)))
        ry, rs, rmean, rrstd = fn.fused_norm_fwd_reference(x, res, scale, bias)
        rds, rdscale, rdbias = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy)
        rdx = fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy, gs)[0]
        tol = LN_RTOL[dt_name]
        errs = {
            "y": (_rel_err(torch, y, ry), tol),
            "s": (_rel_err(torch, s, rs), tol),
            "mean": ((mean - rmean).abs().max().item() / rmean.abs().max().item(), LN_STATS_RTOL),
            "rstd": (_rel_err(torch, rstd, rrstd), LN_STATS_RTOL),
            "ds": (_rel_err(torch, ds, rds), tol),
            "dx": (_rel_err(torch, dx, rdx), tol),
            "dscale": (_rel_err(torch, dscale, rdscale), LN_PARAM_GRAD_RTOL),
            "dbias": (_rel_err(torch, dbias, rdbias), LN_PARAM_GRAD_RTOL),
        }
        no_bias = fn.fused_norm_fwd_reference(x, res, scale, torch.zeros_like(bias))[0]
        sf = s.float()
        xhat = (sf - mean[:, None]) * rstd[:, None]
        dxhat = gy.float() * scale
        no_m1 = rstd[:, None] * (dxhat - xhat * (dxhat * xhat).mean(1, keepdim=True))
        ctrl = {"y": _rel_err(torch, y, no_bias), "ds": _rel_err(torch, ds, no_m1)}
        finite = all(torch.isfinite(t).all().item() for t in (y, s, ds, dx, dscale, dbias))
        # With gs the parameter gradients are the same sums.
        params_same = torch.equal(dscale, dscale_gs) and torch.equal(dbias, dbias_gs)
        ok = (finite and same and params_same and all(e <= lim for e, lim in errs.values())
              and ctrl["y"] > tol and ctrl["ds"] > tol)
        log(f"[norm] {name:24s} ({n}, {d}) {dt_name:8s} "
            + " ".join(f"{k} {e:.2e}/{lim:g}" for k, (e, lim) in errs.items())
            + f"; control y-without-bias {ctrl['y']:.2e}, ds-without-mean(dxhat) "
            f"{ctrl['ds']:.2e}"
            f"{'  reruns bit-identical' if dtype == torch.bfloat16 and same else ''}"
            f"{'' if same else '  RERUN DIFFERS'}"
            f"{'' if params_same else '  DSCALE/DBIAS DIFFER WITH GS'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fused norm kernels disagree with their plain versions: {name}")
        errors[name] = {"fwd": (y.float() - ry.float()).abs().max().item(),
                        "bwd": max((ds.float() - rds.float()).abs().max().item(),
                                   (dx.float() - rdx.float()).abs().max().item(),
                                   (dscale - rdscale).abs().max().item(),
                                   (dbias - rdbias).abs().max().item())}
    return errors


def norm_bwd_bounds(n, d, elt_bytes):
    """(bytes, ms) of the LayerNorm backward without and with the residual's
    gradient: s and dy in, dx out, scale, mean/rstd and dscale/dbias once;
    the gs flavour reads one more (n, d) tensor. Bound by bytes."""
    moved = 3 * n * d * elt_bytes + d * 4 + 2 * n * 4 + 2 * d * 4
    with_gs = moved + n * d * elt_bytes
    return tuple((b, b / H100_HBM_BYTES_PER_S * 1e3) for b in (moved, with_gs))


def bwd_bounds(b, t, h, hkv, d, elt_bytes, dtype_name):
    """(dq bound, dkdv bound) as (bytes, flop, ms, bound_by): each kernel
    reads q, k, v, dO, lse and delta once and writes its outputs once;
    dq does 3 products per live causal pair (S, dP, dQ), dk/dv 4 (S, dP,
    dV, dK), 2*D flop each."""
    pairs = b * h * (t * (t + 1) // 2)
    reads = (2 * b * t * h * d + 2 * b * t * hkv * d) * elt_bytes + 2 * 4 * b * h * t
    out = []
    for writes, products in ((b * t * h * d * elt_bytes, 3), (2 * b * t * hkv * d * elt_bytes, 4)):
        moved = reads + writes
        flops = products * 2 * d * pairs
        t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
        out.append((moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return out


def phase_bwd_timing(torch, smi: str, shape=TRAIN_SHAPE) -> dict:
    """CUDA-event ms of kernels 2 and 3 at ``shape`` (the training shape by
    default), the plain version (all three gradients in one call), and
    aten's SDPA backward as a yardstick (all three gradients, the narrow
    K/V under GQA with ``enable_gqa=True``; never called by the port)."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import flash_attention as fa

    b, t, h, hkv, d = shape
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v = _qkv(torch, gen, b, t, h, hkv, d, torch.bfloat16)
    dout = torch.randn(b, t, h, d, device="cuda", generator=gen).to(torch.bfloat16)
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(out, dout)
    with torch.no_grad():
        dq_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dq(q, k, v, dout, lse, delta),
                         iters=20, warmup=3)
        dkdv_ms = _time_ms(torch, lambda: fa.flash_attention_bwd_dkdv(q, k, v, dout, lse, delta),
                           iters=20, warmup=3)
        plain_ms = _time_ms(
            torch, lambda: fa._bwd_reference_from_delta(q, k, v, dout, lse, delta, None, True, 0),
            iters=5, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    gqa = {"enable_gqa": True} if hkv != h else {}
    ref_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, **gqa)
    g = dout.transpose(1, 2)
    library_ms = _time_ms(torch, lambda: torch.autograd.grad(ref_out, (qt, kt, vt), g,
                                                             retain_graph=True),
                          iters=20, warmup=3)
    (dq_b, dq_f, dq_bound, dq_by), (kv_b, kv_f, kv_bound, kv_by) = bwd_bounds(
        b, t, h, hkv, d, 2, "bfloat16")
    log(f"[timing] flash backward at (B,T,H,Hkv,D)=({b},{t},{h},{hkv},{d}) bf16 causal "
        f"on {smi}:")
    log(f"[timing]   dq kernel {dq_ms:.4f} ms (bound {dq_bound:.4f} ms by {dq_by}: {dq_b} bytes, "
        f"{dq_f} flop)")
    log(f"[timing]   dk/dv kernel {dkdv_ms:.4f} ms (bound {kv_bound:.4f} ms by {kv_by}: {kv_b} "
        f"bytes, {kv_f} flop)")
    log(f"[timing]   plain version (dq, dk, dv) {plain_ms:.4f} ms  sdpa backward (yardstick) "
        f"{library_ms:.4f} ms")
    return {
        "dq": dict(ms=dq_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=dq_bound,
                   bound_by=dq_by),
        "dkdv": dict(ms=dkdv_ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=kv_bound,
                     bound_by=kv_by),
    }


def _device_ms(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Device time per call of ``fn``: torch.profiler over ``iters`` calls,
    the sum of the CUDA durations of the kernels they launched, over
    ``iters``. For kernels short enough that the host may set their event
    time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters


def phase_norm_timing(torch, smi: str) -> dict:
    """Kernels 4 and 5 at the training path's tokens (32768, 768) bf16:
    CUDA-event ms over back-to-back calls and device ms (profiler), without
    the residual (the function F.layer_norm computes, timed beside it as
    the yardstick) and with it (ln_2's variant: the forward adds the
    residual, the backward adds its gradient gs); the plain versions;
    bounds from the bytes each must move."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import fused_norm as fn

    n, d = LN_TOKENS, LN_DIM
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    res = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    scale = torch.ones(d, device="cuda")
    bias = torch.zeros(d, device="cuda")
    gy = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    gs = torch.randn(n, d, device="cuda", generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        fwd = lambda: fn.fused_norm_fwd(x, None, scale, bias)  # noqa: E731
        fwd_ms, fwd_dev = _time_ms(torch, fwd), _device_ms(torch, fwd)
        fwd_res_ms = _time_ms(torch, lambda: fn.fused_norm_fwd(x, res, scale, bias))
        _, s, mean, rstd = fn.fused_norm_fwd(x, None, scale, bias)
        bwd = lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy)  # noqa: E731
        bwd_gs = lambda: fn.fused_norm_bwd(s, scale, mean, rstd, gy, gs)  # noqa: E731
        bwd_ms, bwd_dev = _time_ms(torch, bwd), _device_ms(torch, bwd)
        gs_ms, gs_dev = _time_ms(torch, bwd_gs), _device_ms(torch, bwd_gs)
        fwd_plain = _time_ms(torch, lambda: fn.fused_norm_fwd_reference(x, None, scale, bias))
        bwd_plain = _time_ms(torch, lambda: fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy))
        gs_plain = _time_ms(torch, lambda: fn.fused_norm_bwd_reference(s, scale, mean, rstd, gy,
                                                                        gs))
        lib_fwd = _time_ms(torch, lambda: F.layer_norm(x, (d,), scale.to(x.dtype),
                                                        bias.to(x.dtype), 1e-6))
    xr = x.detach().requires_grad_(True)
    w = scale.to(x.dtype).requires_grad_(True)
    bb = bias.to(x.dtype).requires_grad_(True)
    y_lib = F.layer_norm(xr, (d,), w, bb, 1e-6)
    lib_bwd = _time_ms(torch, lambda: torch.autograd.grad(y_lib, (xr, w, bb), gy,
                                                          retain_graph=True))
    fwd_bytes = 2 * n * d * 2 + 2 * d * 4 + 2 * n * 4  # x in, y out, params, mean/rstd out
    fwd_bound = fwd_bytes / H100_HBM_BYTES_PER_S * 1e3
    (bwd_bytes, bwd_bound), (gs_bytes, gs_bound) = norm_bwd_bounds(n, d, 2)
    log(f"[timing] fused LayerNorm at ({n}, {d}) bf16 on {smi}:")
    log(f"[timing]   fwd kernel {fwd_ms:.4f} ms, device {fwd_dev:.4f} ms (with residual "
        f"{fwd_res_ms:.4f} ms)  plain {fwd_plain:.4f} ms  F.layer_norm (yardstick) {lib_fwd:.4f} ms"
        f"  bound {fwd_bound:.4f} ms by bytes ({fwd_bytes} bytes)")
    log(f"[timing]   bwd kernel {bwd_ms:.4f} ms, device {bwd_dev:.4f} ms (bound {bwd_bound:.4f} ms "
        f"by bytes, {bwd_bytes} bytes; {bwd_bound / bwd_ms:.1%} of it by event, "
        f"{bwd_bound / bwd_dev:.1%} by device)  plain {bwd_plain:.4f} ms  F.layer_norm backward "
        f"(yardstick) {lib_bwd:.4f} ms")
    log(f"[timing]   bwd kernel with gs {gs_ms:.4f} ms, device {gs_dev:.4f} ms (bound "
        f"{gs_bound:.4f} ms by bytes, {gs_bytes} bytes; {gs_bound / gs_ms:.1%} of it by event, "
        f"{gs_bound / gs_dev:.1%} by device)  plain {gs_plain:.4f} ms")
    return {
        "fwd": dict(ms=fwd_ms, device_ms=fwd_dev, plain_ms=fwd_plain, library_ms=lib_fwd,
                    bound_ms=fwd_bound, bound_by="bytes", ms_with_residual=fwd_res_ms),
        "bwd": dict(ms=bwd_ms, device_ms=bwd_dev, plain_ms=bwd_plain, library_ms=lib_bwd,
                    bound_ms=bwd_bound, bound_by="bytes", ms_with_gs=gs_ms,
                    device_ms_with_gs=gs_dev, plain_ms_with_gs=gs_plain,
                    bound_ms_with_gs=gs_bound),
    }


# ------------------------------------------------------- fused lm-head CE
CE_SHAPE = (64 * 512, 768, 50257)  # N tokens, d, V at the CE training path
# Fused CE tolerances, relative to the largest magnitude of the plain
# version's output. lse and the per-token loss are f32 sums over d in
# another order (cuBLAS f32 in the plain version; FMA chains in the f32
# kernel, tensor-core sums of 64-column chunks added in f32 in the bf16
# one): 1e-5. dh: one bf16 rounding on each side of f32 sums over V in
# another order, so two bf16 ulps of the largest element (2^-7); in f32,
# summation order over V only (1e-4). dW is always f32, summed over N in
# another order (1e-4).
CE_LOSS_RTOL = 1e-5
CE_DH_RTOL = {"bfloat16": 2**-7, "float32": 1e-4}
CE_DW_RTOL = 1e-4


def _ce_inputs(torch, gen, n, d, v, dtype, g_zero_every=0):
    """h ~ N(0, 1) (LayerNorm output scale), W ~ N(0, 49/d): logits of
    std ~7 at every d, a softmax peaked enough that the z-loss factor
    shows in the gradients (on the H100 that control lands at 2.4e-2 or
    more against the 2^-7 limit). Labels uniform over [0, V)
    and the first eight in the last tile, which is ragged; a non-uniform
    cotangent g, zero on every g_zero_every-th token (masked tokens) when
    asked."""
    h = torch.randn(n, d, device="cuda", generator=gen).to(dtype)
    w = (7.0 / math.sqrt(d) * torch.randn(v, d, device="cuda", generator=gen)).to(dtype)
    labels = torch.randint(0, v, (n,), device="cuda", generator=gen, dtype=torch.int32)
    labels[:8] = torch.arange(v - 8, v, device="cuda", dtype=torch.int32).clamp_min(0)
    g = torch.randn(n, device="cuda", generator=gen)
    if g_zero_every:
        g[::g_zero_every] = 0.0
    return h, w, labels, g


def phase_ce_checks(torch) -> dict:
    """Kernels 6-8 (fused lm-head CE forward, dh, dW) against their plain
    versions, each case with three controls broken on purpose in the plain
    version: the label logit read from column label + 1 (per-token loss),
    the one-hot term left out of dlogit (dh and dW), and, where z_loss > 0,
    the z-loss factor left out of g_lse (dh and dW). Every control must
    land above its tolerance. bf16 cases launch each kernel twice: lse, the
    label logit, dh and dW must be bit-identical."""
    from llmtrain_tpu_torch.ops import fused_ce as fc

    n, d, v = CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(20)
    cases = [
        ("slice shape", (n, d, v), torch.bfloat16, 0.0, 0),
        ("slice shape z-loss", (n, d, v), torch.bfloat16, 1e-3, 0),
        ("f32 small", (1000, 256, 3001), torch.float32, 1e-3, 0),
        ("ragged N, V < tile", (777, 768, 100), torch.bfloat16, 1e-3, 0),
        ("d 64", (4096, 64, 5000), torch.bfloat16, 1e-3, 0),
        ("g with zeros", (4096, 768, 10007), torch.bfloat16, 1e-3, 3),
        ("d 96, ragged N and V", (1500, 96, 3001), torch.bfloat16, 0.0, 0),
    ]
    errors = {}
    for name, (cn, cd, cv), dtype, z_loss, g_zero in cases:
        h, w, labels, g = _ce_inputs(torch, gen, cn, cd, cv, dtype, g_zero)
        t0 = time.perf_counter()
        lse, ll = fc.fused_ce_fwd(h, w, labels)
        g_lse = fc.g_lse_from(g, lse, z_loss)
        dh = fc.fused_ce_bwd_dh(h, w, labels, lse, g_lse, g)
        dw = fc.fused_ce_bwd_dw(h, w, labels, lse, g_lse, g)
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        same = True
        if dtype == torch.bfloat16:
            lse2, ll2 = fc.fused_ce_fwd(h, w, labels)
            same = (torch.equal(lse, lse2) and torch.equal(ll, ll2)
                    and torch.equal(dh, fc.fused_ce_bwd_dh(h, w, labels, lse, g_lse, g))
                    and torch.equal(dw, fc.fused_ce_bwd_dw(h, w, labels, lse, g_lse, g)))
            del lse2, ll2
        r_lse, r_ll = fc.fused_ce_fwd_reference(h, w, labels)
        r_dh, r_dw = fc.fused_ce_bwd_reference(h, w, labels, r_lse, fc.g_lse_from(g, r_lse, z_loss),
                                               g)
        per_token = lse - ll + z_loss * lse.square()
        r_per_token = r_lse - r_ll + z_loss * r_lse.square()
        dt_name = str(dtype).replace("torch.", "")
        errs = {
            "lse": (_rel_err(torch, lse, r_lse), CE_LOSS_RTOL),
            "loss": (_rel_err(torch, per_token, r_per_token), CE_LOSS_RTOL),
            "dh": (_rel_err(torch, dh, r_dh), CE_DH_RTOL[dt_name]),
            "dw": (_rel_err(torch, dw, r_dw), CE_DW_RTOL),
        }
        # Controls, each from the plain version broken on purpose.
        shifted = fc.fused_ce_fwd_reference(h, w, labels + 1)[1]
        ctrl = {"loss, label+1": (_rel_err(torch, per_token, r_lse - shifted
                                           + z_loss * r_lse.square()), CE_LOSS_RTOL)}
        no_hot = fc.fused_ce_bwd_reference(h, w, labels, r_lse, fc.g_lse_from(g, r_lse, z_loss),
                                           torch.zeros_like(g))
        ctrl["dh, no one-hot"] = (_rel_err(torch, dh, no_hot[0]), CE_DH_RTOL[dt_name])
        ctrl["dw, no one-hot"] = (_rel_err(torch, dw, no_hot[1]), CE_DW_RTOL)
        del no_hot
        if z_loss > 0.0:
            no_z = fc.fused_ce_bwd_reference(h, w, labels, r_lse, g, g)
            ctrl["dh, no z-loss"] = (_rel_err(torch, dh, no_z[0]), CE_DH_RTOL[dt_name])
            ctrl["dw, no z-loss"] = (_rel_err(torch, dw, no_z[1]), CE_DW_RTOL)
            del no_z
        finite = all(torch.isfinite(x).all().item() for x in (lse, ll, dh, dw))
        zero_rows_ok = True
        if g_zero:
            # A masked token adds nothing: its dh row is zero.
            zero_rows_ok = bool((dh[::g_zero] == 0).all().item())
        ok = (finite and zero_rows_ok and same and all(e <= lim for e, lim in errs.values())
              and all(e > lim for e, lim in ctrl.values()))
        log(f"[ce] {name:20s} N{cn} d{cd} V{cv} {dt_name:8s} z={z_loss:g} kernels {kernel_s:.2f}s "
            + " ".join(f"{k} {e:.2e}/{lim:g}" for k, (e, lim) in errs.items())
            + "; controls " + ", ".join(f"{k} {e:.2e}" for k, (e, _) in ctrl.items())
            + f"{'  reruns bit-identical' if dtype == torch.bfloat16 and same else ''}"
            + f"{'' if same else '  RERUN DIFFERS'}"
            + f"{'' if zero_rows_ok else ' (masked dh rows not zero)'}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"fused CE kernels disagree with their plain versions: {name}")
        errors[name] = {"fwd": max((lse - r_lse).abs().max().item(),
                                   (per_token - r_per_token).abs().max().item()),
                        "dh": (dh.float() - r_dh).abs().max().item(),
                        "dw": (dw - r_dw).abs().max().item()}
        del h, w, dh, dw, r_dh, r_dw
        torch.cuda.empty_cache()
    return errors


def ce_bounds(n, d, v, elt_bytes, dtype_name):
    """(fwd, dh, dw) bounds as (bytes, flop, ms, bound_by). Each kernel
    reads h, W and the labels once; the forward writes lse and the label
    logit (f32) and does 2*N*V*d flop; the backward kernels also read lse,
    g_lse and g, recompute the logits and contract them once more (4*N*V*d
    flop each); dh writes (N, d) in the operands' dtype, dW (V, d) f32."""
    reads = (n * d + v * d) * elt_bytes + 4 * n
    out = []
    for moved, flops in ((reads + 2 * 4 * n, 2 * n * v * d),
                         (reads + 3 * 4 * n + n * d * elt_bytes, 4 * n * v * d),
                         (reads + 3 * 4 * n + v * d * 4, 4 * n * v * d)):
        t_bytes = moved / H100_HBM_BYTES_PER_S * 1e3
        t_ops = flops / H100_PEAK_FLOPS[dtype_name] * 1e3
        out.append((moved, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"))
    return out


def phase_ce_timing(torch, smi: str) -> dict:
    """CUDA-event ms of kernels 6-8 at the CE training path's shape
    (32768, 768, 50257) bf16, the plain versions, and a composite
    yardstick the port never calls: F.linear -> .float() ->
    F.cross_entropy(reduction="none"), forward, and its backward (dh and
    dW together). No single PyTorch call computes the fused function."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import fused_ce as fc

    n, d, v = CE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(21)
    h, w, labels, g = _ce_inputs(torch, gen, n, d, v, torch.bfloat16)
    lse, _ = fc.fused_ce_fwd(h, w, labels)
    with torch.no_grad():
        fwd_ms = _time_ms(torch, lambda: fc.fused_ce_fwd(h, w, labels), iters=3, warmup=1)
        dh_ms = _time_ms(torch, lambda: fc.fused_ce_bwd_dh(h, w, labels, lse, g, g),
                         iters=3, warmup=1)
        dw_ms = _time_ms(torch, lambda: fc.fused_ce_bwd_dw(h, w, labels, lse, g, g),
                         iters=3, warmup=1)
        # One call each, unwarmed: a plain call takes seconds.
        plain_fwd = _time_ms(torch, lambda: fc.fused_ce_fwd_reference(h, w, labels),
                             iters=1, warmup=0)
        plain_bwd = _time_ms(torch, lambda: fc.fused_ce_bwd_reference(h, w, labels, lse, g, g),
                             iters=1, warmup=0)
        comp_fwd = _time_ms(torch, lambda: F.cross_entropy(F.linear(h, w).float(), labels.long(),
                                                           reduction="none"), iters=3, warmup=1)
    hr = h.detach().requires_grad_(True)
    wr = w.detach().requires_grad_(True)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = F.cross_entropy(F.linear(hr, wr).float(), labels.long(), reduction="none")
    comp_bwd = _time_ms(torch, lambda: torch.autograd.grad(loss, (hr, wr), g, retain_graph=True),
                        iters=3, warmup=1)
    comp_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    del loss, hr, wr
    torch.cuda.empty_cache()
    (fb, ff, f_bound, f_by), (hb, hf, h_bound, h_by), (wb, wf, w_bound, w_by) = ce_bounds(
        n, d, v, 2, "bfloat16")
    log(f"[timing] fused lm-head CE at (N, d, V) = ({n}, {d}, {v}) bf16 on {smi}:")
    log(f"[timing]   fwd kernel {fwd_ms:.3f} ms (bound {f_bound:.4f} ms by {f_by}: {fb} bytes, "
        f"{ff} flop; {ff / fwd_ms / 1e9:.1f} TFLOP/s)  plain {plain_fwd:.3f} ms  composite "
        f"F.linear+cross_entropy fwd (yardstick) {comp_fwd:.3f} ms")
    log(f"[timing]   dh kernel {dh_ms:.3f} ms (bound {h_bound:.4f} ms by {h_by}: {hb} bytes, {hf} "
        f"flop; {hf / dh_ms / 1e9:.1f} TFLOP/s)  dW kernel {dw_ms:.3f} ms (bound {w_bound:.4f} ms "
        f"by {w_by}: {wb} bytes; {wf / dw_ms / 1e9:.1f} TFLOP/s)")
    log(f"[timing]   plain backward (dh and dW) {plain_bwd:.3f} ms  composite backward (dh and "
        f"dW, yardstick) {comp_bwd:.3f} ms; the composite's autograd graph held "
        f"{comp_peak:.2f} GiB above its inputs")
    # library_ms stays null: no single PyTorch call computes the fused
    # function; the composite yardstick has its own keys.
    composite = "F.linear -> .float() -> F.cross_entropy(reduction='none')"
    return {
        "fwd": dict(ms=fwd_ms, plain_ms=plain_fwd, library_ms=None, bound_ms=f_bound,
                    bound_by=f_by, composite_ms=comp_fwd, composite=composite + ", forward"),
        "dh": dict(ms=dh_ms, plain_ms=plain_bwd, library_ms=None, bound_ms=h_bound,
                   bound_by=h_by, composite_ms=comp_bwd,
                   composite=composite + ", backward (dh and dW)"),
        "dw": dict(ms=dw_ms, plain_ms=plain_bwd, library_ms=None, bound_ms=w_bound,
                   bound_by=w_by, composite_ms=comp_bwd,
                   composite=composite + ", backward (dh and dW)"),
    }


def build_path_model(torch):
    from llmtrain_tpu_torch.cli import prepare_decode_model
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries
    from llmtrain_tpu_torch.utils.logging import configure_logging

    root = Path(__file__).resolve().parent
    cfg, _, _ = load_and_validate_config(root / "configs/presets/gpt_pycorpus_tpu.yaml")
    logger = configure_logging(level="WARNING", json_output=False)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
    device = resolve_device(cfg.run.device)
    model = adapter.build_model(cfg, device)
    model = prepare_decode_model(model, "compute", logger)
    return cfg, adapter, model


def phase_model(torch, model) -> None:
    from unittest import mock

    from llmtrain_tpu_torch.ops import flash_attention as flash_ops

    ref = flash_ops.flash_attention_fwd_reference

    def broken(kind):
        def attend(q, k, v, mask=None, *, causal=True, window=0):
            if kind == "non-causal":
                return ref(q, k, v, mask, causal=False)
            if kind == "last 64 keys":
                return ref(q, k, v, mask, causal=True, window=64)
            out, lse = ref(q, k, v, mask, causal=causal, window=window)
            return torch.zeros_like(out), lse

        return attend

    gen = torch.Generator(device="cuda").manual_seed(2)
    ids = torch.randint(0, model.vocab_size, (1, model.block_size), device="cuda", generator=gen)

    def forward(attend=None):
        if attend is None:
            return model(ids).float()
        with mock.patch.object(flash_ops, "flash_attention_fwd", attend):
            return model(ids).float()

    with torch.inference_mode():
        logits = forward()
        plain = forward(ref)
        controls = {kind: (forward(broken(kind)) - plain).abs().max().item()
                    for kind in ("non-causal", "output zeroed", "last 64 keys")}
    torch.cuda.synchronize()
    shape_ok = tuple(logits.shape) == (1, model.block_size, model.vocab_size)
    finite = bool(torch.isfinite(logits).all().item())
    err = (logits - plain).abs().max().item()
    log(f"[model] GPT {model.n_layers}x{model.d_model} heads {model.n_heads} block "
        f"{model.block_size} vocab {model.vocab_size} dtype {str(model.dtype)[6:]}: "
        f"logits {tuple(logits.shape)} finite={finite} |max| {logits.abs().max().item():.3f} "
        f"kernel-vs-plain max abs diff {err:.4e} (atol {LOGITS_ATOL})")
    for kind, diff in controls.items():
        log(f"[model] control, attention {kind}: max abs diff from plain {diff:.4e} "
            f"(must exceed {LOGITS_ATOL})")
    if not (shape_ok and finite and err <= LOGITS_ATOL):
        raise RuntimeError("model forward through the kernel disagrees with the plain path")
    if min(controls.values()) <= LOGITS_ATOL:
        raise RuntimeError("the logits limit does not separate a broken attention from the "
                           "kernel's rounding")


def _post_h(url: str, body: object, timeout: float = 600.0) -> tuple[int, dict, dict]:
    """POST JSON (or raw bytes); (status, payload, headers)."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}"), dict(exc.headers)


def _post(url: str, body: object, timeout: float = 600.0) -> tuple[int, dict]:
    return _post_h(url, body, timeout)[:2]


def _get(url: str) -> tuple[int, bytes]:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read()


def phase_serve(torch, cfg, model, smi: str) -> None:
    import numpy as np

    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd
    from llmtrain_tpu_torch.serving import ServerState, make_server
    from llmtrain_tpu_torch.telemetry.registry import MetricsRegistry

    state = ServerState(
        model=model,
        tokenizer=ByteTokenizer(),
        step=0,
        checkpoint=f"seeded init (run.seed={cfg.run.seed})",
        max_new_tokens_cap=cfg.serving.max_new_tokens_cap,
        default_max_new_tokens=cfg.serving.default_max_new_tokens,
        registry=MetricsRegistry(),
    )
    httpd = make_server(state, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, name="smoke-serve", daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(3)
    requests = [
        ("greedy 32+32 (kv-cache)", 32, {"max_new_tokens": 32, "temperature": 0}),
        ("sampled 32+32", 32, {"max_new_tokens": 32, "temperature": 0.8, "top_k": 40,
                                "seed": 11}),
    ]
    launches = {}
    try:
        for name, prompt_len, knobs in requests:
            body = {"prompt_ids": [int(x) for x in rng.integers(0, 256, prompt_len)], **knobs}
            before = flash_attention_fwd.launches
            t0 = time.perf_counter()
            code, resp = _post(f"{base}/v1/generate", body)
            wall = time.perf_counter() - t0
            launches[name] = flash_attention_fwd.launches - before
            comp = resp.get("completion_ids", [])
            ok = (code == 200 and len(comp) == knobs["max_new_tokens"]
                  and all(0 <= c < 256 for c in comp))
            log(f"[serve] {name}: HTTP {code}, {len(comp)} tokens, latency "
                f"{resp.get('latency_ms')} ms (wall {wall * 1e3:.1f} ms), "
                f"{len(comp) / wall:.1f} tokens/s, kernel launches {launches[name]}  on {smi}")
            if not ok:
                raise RuntimeError(f"serve request {name!r} failed: {code} {resp}")
        over = {"prompt_ids": [int(x) for x in rng.integers(0, 256, 400)],
                "max_new_tokens": 160, "temperature": 0}
        code, resp = _post(f"{base}/v1/generate", over)
        log(f"[serve] greedy 400+160 (over block_size): HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("prompt + max_new_tokens > block_size was not answered with 400")
        code, resp = _post(f"{base}/v1/generate", {"prompt_ids": "not a list"})
        log(f"[serve] malformed body: HTTP {code} {resp}")
        if code != 400:
            raise RuntimeError("a malformed request was not answered with 400")
        code_h, health = _get(f"{base}/healthz")
        code_m, metrics = _get(f"{base}/metrics")
        if code_h != 200 or code_m != 200 or b"llmtrain_serve_requests_total" not in metrics:
            raise RuntimeError("/healthz or /metrics did not answer")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    log(f"[serve] healthz: {json.loads(health)['stats']}")
    if any(launches.values()):
        raise RuntimeError(f"a KV-cache request launched the flash kernel: {launches}")


REFORWARD = (400, 160)  # prompt, new tokens: total 560 > block_size 512
# Phase 8 profiles the re-forward branch over this many new tokens (160,
# REFORWARD's, until phase 24 came; PERF.md §2): 400 + 120 passes
# block_size, so every one of them re-forwards.
PROFILE_NEW_TOKENS = 120


def phase_generate(torch, model, smi: str) -> None:
    """Greedy 400+160 through generate(): the re-forward branch."""
    import numpy as np

    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(4).integers(0, 256, (1, prompt_len)).astype(np.int32)
    before = flash_attention_fwd.launches
    t0 = time.perf_counter()
    out = generate(model, ids, max_new_tokens=max_new, temperature=0.0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = flash_attention_fwd.launches - before
    out = np.asarray(out)
    need = model.n_layers * max_new
    log(f"[generate] greedy {prompt_len}+{max_new} (re-forward): {wall * 1e3:.1f} ms, "
        f"{max_new / wall:.1f} tokens/s, kernel launches {launched} (>= {need} required)  "
        f"on {smi}")
    if out.shape != (1, prompt_len + max_new) or not (out >= 0).all() or not (out < 256).all():
        raise RuntimeError(f"generate() returned {out.shape} ids outside [0, 256)")
    if not np.array_equal(out[:, :prompt_len], ids):
        raise RuntimeError("generate() did not keep the prompt")
    if launched < need:
        raise RuntimeError("the re-forward branch did not go through the flash kernel")


def _kernel_share(events, device_ms: float,
                     names=("flash_fwd_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkdv_kernel")) -> str:
    """Device time of the named kernels (by default the three flash
    kernels) in a profile, by kernel and as a share of all device kernel
    time."""
    parts, total = [], 0.0
    for name in names:
        hits = [e for e in events if name in e.key]
        ms = sum(e.self_device_time_total for e in hits) / 1e3
        total += ms
        parts.append(f"{name} {ms:.2f} ms x{sum(e.count for e in hits)}")
    return f"{', '.join(parts)}: {total:.2f} ms, {total / device_ms:.1%} of device kernel time"


def phase_profile(torch, model, smi: str) -> None:
    """torch.profiler over one more re-forward generate()."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.generation import generate

    prompt_len, max_new = REFORWARD[0], PROFILE_NEW_TOKENS
    ids = np.random.default_rng(5).integers(0, 256, (1, prompt_len)).astype(np.int32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        generate(model, ids, max_new_tokens=max_new, temperature=0.0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    log(f"[profile] re-forward {prompt_len}+{max_new} on {smi}: wall {wall_ms:.1f} ms, "
        f"device kernel time {device_ms:.1f} ms ({device_ms / wall_ms:.1%} busy), {launches} "
        f"kernel launches ({launches / max_new:.0f} per token), "
        f"{wall_ms / max_new:.2f} ms/token")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")
    log(f"[profile] attention kernels: {_kernel_share(events, device_ms)}")



# ---------------------------------------------------------------- training
# Cuts of the preset for the smoke run (everything else is the preset's):
# max_steps, warmup_steps (the schema requires warmup <= max_steps; a
# quarter of the run, then the preset's cosine decay), the log/eval/save
# cadence (every step logged, eval and a save at TRAIN_SAVE_EVERY and at
# the end), and the corpus glob, pointed at the running interpreter's own
# standard library (the preset names /usr/local/lib/python3.12, which the
# card's machine may not have).
TRAIN_STEPS = 40
TRAIN_WARMUP = 10
TRAIN_SAVE_EVERY = 20
# The fused-norm run takes the first FUSED_STEPS steps only; inside the
# warmup the learning rate is lr * count / warmup whatever max_steps is,
# so the two runs share their schedule step for step.
FUSED_STEPS = TRAIN_WARMUP
# The last logged loss must sit this far below the first.
LOSS_DROP_MIN = 1.0
# Resume from step TRAIN_SAVE_EVERY to the end against the uninterrupted
# run: the restored params and optimizer state are bit-exact and the
# batches identical, so only nondeterministic reductions (atomics in
# aten's embedding backward) separate the two runs.
RESUME_ATOL = 2e-2
# Fused-norm run against the unfused one, per step, same init, batches
# and learning rates: the paths differ in the variance formula (two-pass
# vs flax's one-pass) and in bf16 rounding points, compounded over the
# steps (on the H100, over 40 steps the two bf16 trajectories drifted
# apart by up to 0.1 in loss; over the first 10 by 8e-4, PERF.md).
FUSED_ATOL = 5e-3


def _smoke_config(tmp: Path, name: str, **extra_model) -> Path:
    import sysconfig

    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs/presets/gpt_pycorpus_tpu.yaml").read_text())
    raw["run"]["device"] = "cuda"
    raw["data"]["cache_dir"] = str(tmp / "cache")
    raw["data"]["extra"]["globs"] = [sysconfig.get_paths()["stdlib"] + "/**/*.py"]
    raw["model"]["extra"].update(extra_model)
    raw["trainer"].update(max_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP, log_every_steps=1,
                          eval_every_steps=TRAIN_SAVE_EVERY, save_every_steps=TRAIN_SAVE_EVERY)
    raw["output"]["root_dir"] = str(tmp / "runs")
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _run_cli(argv: list[str]) -> tuple[int, str]:
    """The port's CLI in-process; (exit code, stdout)."""
    import contextlib
    import io

    from llmtrain_tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main(argv)
    return code, out.getvalue()


def _logged_steps(run_dir: Path) -> dict[int, dict]:
    """step -> {loss, step_time, tokens_per_sec, mfu} from the run's
    train.log (one JSON line per record)."""
    lines = (run_dir / "logs" / "train.log").read_text().splitlines()
    return _parse_steps(json.loads(line)["message"] for line in lines)


def _parse_steps(messages) -> dict[int, dict]:
    """step -> {loss, step_time, tokens_per_sec, mfu} from the trainer's
    interval log messages."""
    import re

    pattern = re.compile(
        r"step=(\d+)/\d+\s+loss=(\S+)\s+lr=\S+\s+tokens_per_sec=(\S+)\s+"
        r"step_time=(\S+)s\s+mfu=(\S+)"
    )
    steps = {}
    for message in messages:
        m = pattern.search(message)
        if m:
            steps[int(m.group(1))] = dict(loss=float(m.group(2)), tokens_per_sec=float(m.group(3)),
                                          step_time=float(m.group(4)), mfu=float(m.group(5)))
    return steps


def _reset_counts() -> None:
    from llmtrain_tpu_torch.ops import flash_attention as fa
    from llmtrain_tpu_torch.ops import fused_ce as fc
    from llmtrain_tpu_torch.ops import fused_norm as fn

    for fn_ in (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
                fn.fused_norm_fwd, fn.fused_norm_bwd, fc.fused_ce_fwd, fc.fused_ce_bwd_dh,
                fc.fused_ce_bwd_dw):
        fn_.launches = 0


def _read_counts() -> dict:
    from llmtrain_tpu_torch.ops import flash_attention as fa
    from llmtrain_tpu_torch.ops import fused_ce as fc
    from llmtrain_tpu_torch.ops import fused_norm as fn

    return {
        "flash_attention_fwd": fa.flash_attention_fwd.launches,
        "flash_attention_bwd_dq": fa.flash_attention_bwd_dq.launches,
        "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv.launches,
        "fused_norm_fwd": fn.fused_norm_fwd.launches,
        "fused_norm_bwd": fn.fused_norm_bwd.launches,
        "fused_ce_fwd": fc.fused_ce_fwd.launches,
        "fused_ce_bwd_dh": fc.fused_ce_bwd_dh.launches,
        "fused_ce_bwd_dw": fc.fused_ce_bwd_dw.launches,
    }


def _check_counts(name: str, got: dict, want: dict) -> None:
    """Every count not in ``want`` must be 0 (that path launches no such
    kernel)."""
    want = {**{k: 0 for k in got}, **want}
    log(f"[{name}] kernel launches {got}")
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad:
        raise RuntimeError(f"{name}: launch counts differ from what the code implies "
                           f"(got, want): {bad}")


def phase_train(torch, smi: str, tmp: Path) -> dict:
    """`train` on gpt_pycorpus_tpu at full width and micro batch 64, then
    `--resume` from the first save, then `generate` from the final
    checkpoint. Returns what later phases and the kernels line need."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer

    cfg_path = _smoke_config(tmp, "gpt_pycorpus_smoke")
    cfg, _, _ = load_and_validate_config(cfg_path)
    t0 = time.perf_counter()
    dm = LocalTextDataModule()
    dm.setup(cfg, ByteTokenizer())
    n_train, n_val = len(dm.train_dataset()), len(dm.val_dataset())
    log(f"[train] corpus {cfg.data.extra['globs'][0]}: {n_train} train / {n_val} val windows "
        f"of {cfg.model.block_size + 1} tokens, tokenized in {time.perf_counter() - t0:.2f}s")
    eval_batches = -(-n_val // cfg.trainer.micro_batch_size)
    layers = cfg.model.n_layers
    n_evals = TRAIN_STEPS // TRAIN_SAVE_EVERY

    _reset_counts()  # the training path's counts start here
    t0 = time.perf_counter()
    with _ExactLosses() as exact:  # phase 22(a) holds the quantized losses against these bits
        code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "full", "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = Path(cfg.output.root_dir) / "full"
    steps = _logged_steps(run_dir)
    losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[train] {TRAIN_STEPS} steps of {cfg.trainer.micro_batch_size}x{cfg.model.block_size} "
        f"tokens in {wall:.1f}s (command wall, data setup and compile included); "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; val {summary['final_val_loss']:.4f}; "
        f"peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    log(f"[train] losses: {' '.join(f'{x:.4f}' for x in losses)}")
    _check_counts("train", counts, {
        "flash_attention_fwd": layers * (TRAIN_STEPS + n_evals * eval_batches),
        "flash_attention_bwd_dq": layers * TRAIN_STEPS,
        "flash_attention_bwd_dkdv": layers * TRAIN_STEPS,
        "fused_norm_fwd": 0, "fused_norm_bwd": 0,
    })
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"logged losses are not {TRAIN_STEPS} finite values: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"loss did not fall by {LOSS_DROP_MIN}: {losses[0]} -> {losses[-1]}")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    mfu = float(np.median([x["mfu"] for x in steady]))
    log(f"[train] steady state (median of steps 6-{TRAIN_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s bf16 peak)")

    ckpt = run_dir / "checkpoints" / f"step_{TRAIN_SAVE_EVERY:06d}.ckpt"
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "resumed",
                          "--resume", str(ckpt), "--json"])
    if code != 0:
        raise RuntimeError(f"train --resume exited {code}")
    resumed = json.loads(out)["train_result"]
    r_steps = _logged_steps(Path(cfg.output.root_dir) / "resumed")
    diffs = [abs(r_steps[i]["loss"] - steps[i]["loss"]) for i in sorted(r_steps)]
    final_diff = abs(resumed["final_loss"] - summary["final_loss"])
    log(f"[resume] from step {resumed['resumed_from_step']}: final loss {resumed['final_loss']:.6f} "
        f"vs uninterrupted {summary['final_loss']:.6f} (diff {final_diff:.2e}, atol "
        f"{RESUME_ATOL}); max logged-loss diff over steps {min(r_steps)}-{max(r_steps)} "
        f"{max(diffs):.2e}")
    if resumed["resumed_from_step"] != TRAIN_SAVE_EVERY or final_diff > RESUME_ATOL \
            or max(diffs) > RESUME_ATOL:
        raise RuntimeError("resume does not continue the uninterrupted run")

    code, out = _run_cli(["generate", "--config", str(cfg_path), "--from", str(run_dir),
                          "--prompt", "def ", "--max-new-tokens", "48", "--temperature", "0",
                          "--json"])
    if code != 0:
        raise RuntimeError(f"generate exited {code}")
    gen = json.loads(out)
    ids = gen["completion_ids"]
    log(f"[generate] from the final checkpoint (step {gen['step']}), greedy 'def ' + 48: "
        f"{gen['text']!r}")
    if len(ids) != 48 or not all(0 <= i < 256 for i in ids):
        raise RuntimeError(f"generate from the trained checkpoint returned {ids}")
    return dict(cfg_path=cfg_path, run_dir=run_dir, steps=steps, counts=counts, layers=layers,
                eval_batches=eval_batches, step_ms=step_ms, tokens_per_sec=tok_s, mfu=mfu,
                summary=summary, exact_losses=exact.losses)


def phase_fused_train(torch, smi: str, tmp: Path, train: dict) -> dict:
    """The same config with model.extra.fused_norm: true (same init,
    batches and learning rates) through `train` for FUSED_STEPS steps:
    losses per step within FUSED_ATOL of the unfused run's; LN launches
    24 fwd + 24 bwd per step, 24 fwd per eval batch. Logs the median step
    time from step 6 on, tokens/s and peak memory."""
    import numpy as np
    import yaml

    from llmtrain_tpu_torch.config import load_and_validate_config

    cfg_path = _smoke_config(tmp, "gpt_pycorpus_smoke_fused", fused_norm=True)
    raw = yaml.safe_load(cfg_path.read_text())
    raw["trainer"].update(max_steps=FUSED_STEPS, save_every_steps=FUSED_STEPS,
                          eval_every_steps=FUSED_STEPS)
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, _ = load_and_validate_config(cfg_path)
    _reset_counts()  # the fused-norm training path's counts start here
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "fused", "--json"])
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"fused-norm train exited {code}")
    summary = json.loads(out)["train_result"]
    steps = _logged_steps(Path(cfg.output.root_dir) / "fused")
    diffs = {i: abs(steps[i]["loss"] - train["steps"][i]["loss"]) for i in sorted(steps)}
    fused_losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[fused] losses: {' '.join(f'{x:.4f}' for x in fused_losses)}")
    log(f"[fused] per-step |fused - unfused| max {max(diffs.values()):.2e} (atol {FUSED_ATOL}): "
        + " ".join(f"{d:.1e}" for d in diffs.values()))
    layers = cfg.model.n_layers
    forwards = FUSED_STEPS + train["eval_batches"]
    _check_counts("fused", counts, {
        "flash_attention_fwd": layers * forwards,
        "flash_attention_bwd_dq": layers * FUSED_STEPS,
        "flash_attention_bwd_dkdv": layers * FUSED_STEPS,
        "fused_norm_fwd": 2 * layers * forwards,
        "fused_norm_bwd": 2 * layers * FUSED_STEPS,
    })
    if len(diffs) != FUSED_STEPS or max(diffs.values()) > FUSED_ATOL:
        raise RuntimeError("the fused-norm run does not agree with the unfused one")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    unfused_ms = float(np.median([train["steps"][i]["step_time"] for i in sorted(steps)
                                  if i > 5])) * 1e3
    log(f"[fused] steady state (median of steps 6-{FUSED_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, peak memory {summary['peak_memory'] / 2**30:.2f} GiB; the "
        f"unfused run's same steps {unfused_ms:.1f} ms")
    return dict(cfg_path=cfg_path, counts=counts, step_ms=step_ms, tokens_per_sec=tok_s,
                summary=summary)


# ------------------------------------------------ CE train (GPT-2 vocabulary)
# The slice's configuration: _smoke_config (gpt_pycorpus_tpu at full width,
# micro batch 64 x 512) with model.vocab_size 50257, the GPT-2 tokenizer's
# n_vocab, and loss_impl unset, so it resolves to fused_ce as in JAX. The
# labels stay byte ids (< 256); the lm-head and the loss still run over
# all 50257 columns. Cuts: CE_STEPS steps (warmup TRAIN_WARMUP), one eval
# and one save, at the end.
CE_VOCAB = 50257
CE_STEPS = 10  # 16 until phase 21 came (PERF.md §2)
# Per-step |fused_ce - dense| over the CE_STEPS steps, same init, batches
# and learning rates: the dense path rounds the logits to bf16 before its
# f32 loss, the fused path keeps them in f32, and both sum in other orders;
# the difference compounds through the updates. On the H100 the first run
# read 0 at steps 1-3, at most 5e-4 through the warmup and 1.8e-3 at step
# 12, as the two trajectories separate at the peak learning rate
# (PERF.md); the limit leaves 2.8x of that.
CE_ATOL = 5e-3
# The fused run's peak memory must sit below the dense run's by at least
# the bf16 logits of one micro batch (N x V x 2 bytes, 3.07 GiB).
CE_LOGITS_BYTES = CE_SHAPE[0] * CE_VOCAB * 2


def _ce_config(tmp: Path, name: str, **extra_model) -> Path:
    import yaml

    path = _smoke_config(tmp, name, **extra_model)
    raw = yaml.safe_load(path.read_text())
    raw["model"]["vocab_size"] = CE_VOCAB
    raw["trainer"].update(max_steps=CE_STEPS, save_every_steps=CE_STEPS, eval_every_steps=CE_STEPS)
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def phase_ce_train(torch, smi: str, tmp: Path, eval_batches: int) -> dict:
    """`train` on the slice's configuration through the fused CE kernels,
    then the same run with loss_impl: dense: resolution, launch counts,
    finite and falling losses, per-step agreement with the dense run, and
    the peak memory the kernels save."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries

    cfg_path = _ce_config(tmp, "gpt_pycorpus_smoke_ce")
    cfg, _, _ = load_and_validate_config(cfg_path)
    initialize_registries()
    built = get_model_adapter(cfg.model.name)().build_model(cfg, resolve_device(cfg.run.device))
    resolved = built.loss_impl
    del built
    torch.cuda.empty_cache()
    log(f"[ce-train] vocab {cfg.model.vocab_size}, loss_impl unset in the config -> resolved "
        f"{resolved!r}")
    if resolved != "fused_ce":
        raise RuntimeError(f"loss_impl resolved to {resolved!r}, not fused_ce")

    _reset_counts()  # the CE training path's counts start here
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "ce", "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"CE train exited {code}")
    summary = json.loads(out)["train_result"]
    steps = _logged_steps(Path(cfg.output.root_dir) / "ce")
    losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[ce-train] {CE_STEPS} steps in {wall:.1f}s (command wall, data setup included); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; val {summary['final_val_loss']:.4f}; "
        f"peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    layers = cfg.model.n_layers
    _check_counts("ce-train", counts, {
        "flash_attention_fwd": layers * (CE_STEPS + eval_batches),
        "flash_attention_bwd_dq": layers * CE_STEPS,
        "flash_attention_bwd_dkdv": layers * CE_STEPS,
        "fused_norm_fwd": 0, "fused_norm_bwd": 0,
        "fused_ce_fwd": CE_STEPS + eval_batches,
        "fused_ce_bwd_dh": CE_STEPS,
        "fused_ce_bwd_dw": CE_STEPS,
    })
    if len(losses) != CE_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"CE losses are not {CE_STEPS} finite values: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"CE loss did not fall by {LOSS_DROP_MIN}: {losses[0]} -> {losses[-1]}")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    mfu = float(np.median([x["mfu"] for x in steady]))
    log(f"[ce-train] steady state (median of steps 6-{CE_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_s:.0f} tokens/s, MFU {mfu:.4f} (989 TFLOP/s bf16 peak)")

    dense_path = _ce_config(tmp, "gpt_pycorpus_smoke_ce_dense", loss_impl="dense")
    code, out = _run_cli(["train", "--config", str(dense_path), "--run-id", "ce_dense", "--json"])
    if code != 0:
        raise RuntimeError(f"dense CE-vocab train exited {code}")
    dense = json.loads(out)["train_result"]
    d_steps = _logged_steps(Path(cfg.output.root_dir) / "ce_dense")
    diffs = {i: abs(steps[i]["loss"] - d_steps[i]["loss"]) for i in sorted(steps)}
    saved = (dense["peak_memory"] - summary["peak_memory"]) / 2**30
    dense_losses = [d_steps[i]["loss"] for i in sorted(d_steps)]
    d_steady = [d_steps[i] for i in sorted(d_steps) if i > 5]
    log(f"[ce-train] dense run losses {' '.join(f'{x:.4f}' for x in dense_losses)}; steady "
        f"state (median of steps 6-{CE_STEPS}) step "
        f"{float(np.median([x['step_time'] for x in d_steady])) * 1e3:.1f} ms, "
        f"{float(np.median([x['tokens_per_sec'] for x in d_steady])):.0f} tokens/s")
    log(f"[ce-train] per-step |fused - dense| max {max(diffs.values()):.2e} (atol {CE_ATOL}): "
        + " ".join(f"{x:.1e}" for x in diffs.values()))
    log(f"[ce-train] peak memory fused {summary['peak_memory'] / 2**30:.2f} GiB, dense "
        f"{dense['peak_memory'] / 2**30:.2f} GiB: {saved:.2f} GiB saved (at least "
        f"{CE_LOGITS_BYTES / 2**30:.2f} GiB required, the bf16 logits)")
    if len(diffs) != CE_STEPS or max(diffs.values()) > CE_ATOL:
        raise RuntimeError("the fused-CE run does not agree with the dense run")
    if dense["peak_memory"] - summary["peak_memory"] < CE_LOGITS_BYTES:
        raise RuntimeError("the fused-CE run does not save the logits' memory")
    return dict(cfg_path=cfg_path, counts=counts, step_ms=step_ms, tokens_per_sec=tok_s, mfu=mfu,
                summary=summary, dense=dense)


def phase_train_profile(torch, smi: str, cfg_path: Path) -> None:
    """torch.profiler over one warmed-up training step (same config, the
    Trainer built directly): wall, device kernel time, busy share, top
    kernels by device time. Measurement only."""
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.sampler import DeterministicSampler
    from llmtrain_tpu_torch.training.trainer import Trainer

    cfg, _, _ = load_and_validate_config(cfg_path)
    trainer = Trainer(cfg, None)
    ds = trainer._data_module.train_dataset()
    sampler = DeterministicSampler(len(ds), cfg.trainer.micro_batch_size, cfg.run.seed)
    for s in (1, 2):
        trainer._train_step_fn(trainer.state, trainer.global_batch(sampler, ds, s))
    batch = trainer.global_batch(sampler, ds, 3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        trainer._train_step_fn(trainer.state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] one training step on {smi}: wall {wall_ms:.1f} ms, device kernel time "
        f"{device_ms:.1f} ms ({device_ms / wall_ms:.1%} busy), "
        f"{sum(e.count for e in events)} kernel launches")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:5d}  {e.key[:90]}")
    log(f"[profile] attention kernels: {_kernel_share(events, device_ms)}")
    if cfg.model.extra.get("fused_norm"):
        log(f"[profile] LayerNorm kernels: "
            f"{_kernel_share(events, device_ms, ('ln_fwd', 'fused_norm_bwd_kernel'))}")


# ------------------------------------------------------- continuous serving
# Phase 14 serves phase 9's final checkpoint at the preset's serving
# defaults (max_batch_slots 8, block_tokens 16, the default pool of
# 1 + 8 x 32 blocks and power-of-two buckets). The arrival rate is past
# what 8 slots serve at this width (each request holds a slot for 64
# decode steps of 12-27 ms on the H100, PERF.md: 5-10 requests/s), so the
# batch stays full whatever the host's speed and the queue holds the rest.
CONT_REQUESTS = 16  # 48 until phase 21 came, 24 until phase 22 (PERF.md §2)
# The sampled (prefix cache) and speculative runs keep more requests: their
# batch fills more slowly. The sampled run's mean occupancy was 6.98-7.12
# at 32 and 6.90 at 24 (32 until phase 24 came, PERF.md §2); the
# speculative run drains its batch fastest (6.88-7.09 at 32, 5.35 at 24:
# it keeps 32).
CONT_SLOW_FILL_REQUESTS = 24
SPEC_BENCH_REQUESTS = 32
CONT_PROMPTS = (16, 256)
CONT_NEW_TOKENS = 64
CONT_RATE_RPS = 16.0
CONT_MIN_OCCUPANCY = 6.0
CONT_SHARED_PREFIX = (128, 4)  # tokens, distinct prefixes
CONT_CHUNK = 64
CONT_HTTP_REQUESTS = 4  # 8 until phase 23 came (PERF.md §2)
# Requests kept in flight across POST /reload: a batch of this many, each
# as long as the context allows after a CONT_PROMPTS[0]-token prompt.
CONT_RELOAD_REQUESTS = 8
CONT_RELOAD_NEW_TOKENS = 320  # 496 until phase 21 came, 384 until phase 23 (PERF.md §2)
CONT_PROFILE_STEPS = 10  # 20 until phase 21 came
CONT_PROFILE_PROMPT = 64
CONT_SERVER_START_SEC = 300


def _serving_config(tmp: Path, name: str, **serving) -> Path:
    """Phase 9's config (same model, same output root) with serving
    overrides."""
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["serving"] = {**raw.get("serving", {}), **serving}
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _serve_bench(cfg_path: Path, ckpt: Path, smi: str, name: str, *extra: str,
                 requests: int = CONT_REQUESTS) -> dict:
    """One in-process `serve-bench --verify-parity` run at the phase's
    population; its gates: exit 0, bitwise parity with generate(), shapes
    within the bucket budget, every request completed, the batch full
    (mean occupancy >= CONT_MIN_OCCUPANCY; behind a router, the replicas'
    summed). The block gains the scheduler's own ``stats()`` under
    ``scheduler_stats`` (behind a router, the first replica's; every
    replica's under ``replica_stats``, each held to its bucket budget) and,
    under ``resident_bytes``, the device memory the serving backend holds
    once built (its weights and pools: allocated then, less allocated
    before the command)."""
    import gc
    from unittest import mock

    import torch

    from llmtrain_tpu_torch import cli

    argv = ["serve-bench", "--config", str(cfg_path), "--from", str(ckpt),
            "--requests", str(requests), "--rate-rps", str(CONT_RATE_RPS),
            "--seed", "14", "--prompt-tokens-min", str(CONT_PROMPTS[0]),
            "--prompt-tokens-max", str(CONT_PROMPTS[1]),
            "--max-new-tokens", str(CONT_NEW_TOKENS), "--verify-parity", *extra]
    built = []
    original = cli._build_serving_backend

    def keep(*args, **kwargs):
        built.append((*original(*args, **kwargs), torch.cuda.memory_allocated() - base))
        return built[-1][:2]

    gc.collect()  # what earlier runs left for the collector is not this run's
    base = torch.cuda.memory_allocated()

    t0 = time.perf_counter()
    with mock.patch.object(cli, "_build_serving_backend", keep):
        code, out = _run_cli(argv)
    wall = time.perf_counter() - t0
    summary = json.loads(out)
    block = summary["serving"]
    slo, tput, occ = block["slo"], block["throughput"], block["occupancy"]
    log(f"[continuous] {name}: exit {code}, {requests} requests at {CONT_RATE_RPS} rps "
        f"Poisson open loop on {smi}: {tput['tokens_per_sec']} output tokens/s over "
        f"{tput['wall_sec']} s (command {wall:.1f} s with parity); TTFT p50 "
        f"{slo['ttft_ms']['p50']} p99 {slo['ttft_ms']['p99']} ms; per-token p50 "
        f"{slo['per_token_ms']['p50']} p99 {slo['per_token_ms']['p99']} ms; occupancy mean "
        f"{occ['mean']} peak {occ['peak']} of {occ['max_batch_slots']}; device memory the "
        f"backend holds once built {built[0][2] / 2**30:.3f} GiB")
    replica_stats = [b[0].stats() for b in built]
    shapes = block["compile"] if "compile" in block else [s["compile"] for s in replica_stats]
    log(f"[continuous] {name}: requests {block['requests']}; parity {block['parity']}; "
        f"shapes {shapes}")
    if "prefix_cache" in block:
        log(f"[continuous] {name}: prefix cache {block['prefix_cache']}")
    within = all(s["compile"]["within_budget"] for s in replica_stats)
    ok = (code == 0 and summary["ok"] and block["parity"]["bitwise_identical"]
          and within and block["requests"]["failed"] == 0
          and block["requests"]["timed_out"] == 0
          and block["requests"]["completed"] == requests)
    if not ok:
        raise RuntimeError(f"serve-bench {name} failed its gates: {summary.get('failures')}")
    if occ["mean"] < CONT_MIN_OCCUPANCY:
        raise RuntimeError(f"serve-bench {name}: mean occupancy {occ['mean']} below "
                           f"{CONT_MIN_OCCUPANCY}; the rate does not fill the batch")
    block["scheduler_stats"] = replica_stats[0]
    block["replica_stats"] = replica_stats
    block["resident_bytes"] = built[-1][2]
    block["summary"] = summary
    return block


def _decode_profile(torch, cfg_path: Path, ckpt: Path, smi: str) -> None:
    """torch.profiler over CONT_PROFILE_STEPS scheduler steps with 8 rows
    decoding (the engine of serve-bench, built in-process): launches,
    device time and wall per decode step. Measurement only."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch import cli
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.serving import (
        ContinuousBatchingScheduler,
        PagedDecodeEngine,
        ServeRequest,
    )
    from llmtrain_tpu_torch.utils.logging import get_logger

    cfg, _, _ = load_and_validate_config(cfg_path)
    _, _, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device), get_logger())
    model, _, _ = cli._load_decode_params(cfg, model, str(ckpt), "compute", get_logger())
    scheduler = ContinuousBatchingScheduler(PagedDecodeEngine(model, max_batch_slots=8))
    rng = np.random.default_rng(15)
    for i in range(8):
        scheduler.submit(ServeRequest(prompt_ids=rng.integers(0, 256, CONT_PROFILE_PROMPT)
                                      .astype(np.int32),
                                      max_new_tokens=CONT_PROFILE_STEPS + 8, seed=i))
    for _ in range(3):  # admits all 8, then two warm decode steps
        scheduler.step()
    if scheduler.stats()["active_sequences"] != 8:
        raise RuntimeError("the profiled decode steps do not hold 8 rows")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(CONT_PROFILE_STEPS):
            scheduler.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    launches = sum(e.count for e in events)
    n = CONT_PROFILE_STEPS
    log(f"[continuous] decode step at batch 8, {n} steps profiled on {smi}: wall "
        f"{wall_ms / n:.2f} ms, device kernel time {device_ms / n:.2f} ms "
        f"({device_ms / wall_ms:.1%} busy), {launches / n:.0f} kernel launches per step")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"[continuous]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:6d}  "
            f"{e.key[:90]}")


def _start_server(cfg_path: Path, ckpt: Path, log_path: Path, *extra: str):
    """`python -m llmtrain_tpu_torch serve --mode continuous EXTRA` as a child
    process; (process, base url) once its ready line arrives."""
    root = Path(__file__).resolve().parent
    err = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "serve", "--config", str(cfg_path),
         "--from", str(ckpt), "--mode", "continuous", *extra],
        cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
    )
    err.close()
    timer = threading.Timer(CONT_SERVER_START_SEC, proc.kill)
    timer.start()
    line = proc.stdout.readline()
    timer.cancel()
    if not line:
        proc.kill()
        raise RuntimeError(f"serve --mode continuous {' '.join(extra)} did not start: "
                           f"{log_path.read_text()[-2000:]}")
    return proc, f"http://127.0.0.1:{json.loads(line)['port']}"


def _stop_server(proc) -> None:
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _reload_under_load(base: str, bodies: list[dict]) -> tuple:
    """POST /reload to the server at ``base`` once every one of ``bodies``
    is in flight (its /healthz counts them active); (reload status,
    response, ms, requests still in flight when it answered, the requests'
    answers, the deadline for the swap to show)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(bodies)) as ex:
        pending = [ex.submit(_post_h, f"{base}/v1/generate", b) for b in bodies]
        deadline = time.monotonic() + 120
        while (json.loads(_get(f"{base}/healthz")[1])["scheduler"]["active_sequences"]
               < len(bodies)):
            if time.monotonic() > deadline or any(f.done() for f in pending):
                raise RuntimeError("the long requests never went in flight together")
            time.sleep(0.01)
        t0 = time.perf_counter()
        code, resp, _ = _post_h(f"{base}/reload", {})
        reload_ms = (time.perf_counter() - t0) * 1e3
        in_flight = sum(not f.done() for f in pending)
        answers = [f.result() for f in pending]
    return code, resp, reload_ms, in_flight, answers, deadline


def _http_phase(torch, tmp: Path, cfg_path: Path, ckpt: Path, smi: str) -> None:
    """`serve --mode continuous`: 8 concurrent greedy requests equal to the
    simple-mode server's answers, /healthz and /metrics, POST /reload with
    a request in flight; a second server with overload control
    (queue_cap 1) answers a burst with at least one 429 + Retry-After."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from llmtrain_tpu_torch import cli
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.serving import ServerState, make_server
    from llmtrain_tpu_torch.utils.logging import get_logger

    over_path = _serving_config(tmp, "gpt_pycorpus_overload",
                                overload={"enabled": True, "queue_cap": 1})
    t0 = time.perf_counter()
    servers = []
    try:
        with ThreadPoolExecutor(2) as ex:
            started = [ex.submit(_start_server, path, ckpt, tmp / f"{name}.log", "--port", "0")
                       for path, name in ((cfg_path, "serve"), (over_path, "overload"))]
            for f in started:
                servers.append(f.result())
        (proc, base), (_, over_base) = servers
        log(f"[http] two `serve --mode continuous` servers ready in "
            f"{time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(16)
        bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, n)],
                   "max_new_tokens": CONT_NEW_TOKENS // 2, "temperature": 0}
                  for n in np.linspace(*CONT_PROMPTS, CONT_HTTP_REQUESTS).astype(int)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CONT_HTTP_REQUESTS) as ex:
            answers = list(ex.map(lambda b: _post_h(f"{base}/v1/generate", b), bodies))
        wall = time.perf_counter() - t0
        codes = [a[0] for a in answers]
        log(f"[http] {CONT_HTTP_REQUESTS} concurrent greedy requests: HTTP {codes} in "
            f"{wall * 1e3:.0f} ms on {smi}")
        if codes != [200] * CONT_HTTP_REQUESTS:
            raise RuntimeError(f"concurrent requests were not all answered 200: {answers}")

        # The simple-mode server's answers for the same bodies.
        cfg, _, _ = load_and_validate_config(cfg_path)
        _, tokenizer, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device),
                                                      get_logger())
        model, path, step = cli._load_decode_params(cfg, model, str(ckpt), "compute",
                                                    get_logger())
        state = ServerState(model=model, tokenizer=tokenizer, step=step, checkpoint=str(path))
        httpd = make_server(state, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            simple = [_post_h(f"http://127.0.0.1:{httpd.server_address[1]}/v1/generate", b)
                      for b in bodies]
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
        same = [a[1]["completion_ids"] == s[1]["completion_ids"]
                for a, s in zip(answers, simple)]
        log(f"[http] tokens equal to the simple-mode server's: {same}")
        if not all(same):
            raise RuntimeError("continuous answers differ from the simple-mode server's")

        code, raw = _get(f"{base}/healthz")
        sched = json.loads(raw)["scheduler"]
        log(f"[http] /healthz {code}: requests_finished {sched['requests_finished']}, "
            f"kv_pool {sched['kv_pool']}, shapes {sched['compile']}")
        code_m, metrics = _get(f"{base}/metrics")
        if (code != 200 or sched["requests_finished"] < CONT_HTTP_REQUESTS
                or code_m != 200 or b"llmtrain_serve_kv_pool_utilization" not in metrics):
            raise RuntimeError("/healthz or /metrics do not show the scheduler")

        long_bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, CONT_PROMPTS[0])],
                        "max_new_tokens": CONT_RELOAD_NEW_TOKENS, "temperature": 0}
                       for _ in range(CONT_RELOAD_REQUESTS)]
        r_code, r_resp, reload_ms, still_in_flight, answers, deadline = _reload_under_load(
            base, long_bodies)
        while True:  # the swap applies between scheduler steps
            params = json.loads(_get(f"{base}/healthz")[1])["scheduler"]["params"]
            if params["hot_swaps"] or time.monotonic() > deadline:
                break
            time.sleep(0.01)
        log(f"[http] POST /reload with {CONT_RELOAD_REQUESTS} requests in flight: HTTP {r_code} "
            f"{r_resp} in {reload_ms:.0f} ms on {smi}, {still_in_flight} requests still in "
            f"flight when it answered; params after it {params}; the requests: HTTP "
            f"{[a[0] for a in answers]}, {[len(a[1].get('completion_ids', [])) for a in answers]} "
            f"tokens")
        from llmtrain_tpu_torch.generation import generate

        first = long_bodies[0]["prompt_ids"]
        want = generate(model, np.asarray([first], np.int32), max_new_tokens=CONT_RELOAD_NEW_TOKENS,
                        temperature=0.0)[0, len(first):]
        if (r_code != 200 or still_in_flight != CONT_RELOAD_REQUESTS or params["hot_swaps"] != 1
                or any(a[0] != 200 or len(a[1]["completion_ids"]) != CONT_RELOAD_NEW_TOKENS
                       for a in answers)
                or answers[0][1]["completion_ids"] != [int(t) for t in want]):
            raise RuntimeError("the reload or the requests in flight across it failed")

        burst = [{"prompt_ids": b["prompt_ids"], "max_new_tokens": CONT_NEW_TOKENS // 4,
                  "temperature": 0}
                 for b in bodies * 2]
        with ThreadPoolExecutor(len(burst)) as ex:
            over = list(ex.map(lambda b: _post_h(f"{over_base}/v1/generate", b), burst))
        rejected = [(c, p.get("reason"), h.get("Retry-After")) for c, p, h in over if c == 429]
        log(f"[http] overload server (queue_cap 1), burst of {len(burst)}: HTTP "
            f"{[c for c, _, _ in over]}; 429s (reason, Retry-After): {rejected}")
        if not rejected or not all(ra for _, _, ra in rejected) or \
                any(c not in (200, 429) for c, _, _ in over):
            raise RuntimeError("the overload server did not answer the burst with 429 + "
                               "Retry-After")
    finally:
        for proc_, _ in servers:
            _stop_server(proc_)


def phase_continuous(torch, smi: str, tmp: Path, train: dict) -> dict:
    """Phase 14: continuous serving of phase 9's final checkpoint: (a)
    greedy serve-bench, (b) sampled serve-bench with the prefix cache and
    chunked prefill, both with --verify-parity; the decode step profiled;
    (c) serve --mode continuous over HTTP."""
    ckpt = train["run_dir"] / "checkpoints"
    greedy_path = _serving_config(tmp, "gpt_pycorpus_continuous",
                                  max_new_tokens_cap=CONT_RELOAD_NEW_TOKENS)
    sampled_path = _serving_config(tmp, "gpt_pycorpus_continuous_prefix",
                                   prefix_cache=True, prefill_chunk=CONT_CHUNK)
    import gc

    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()  # the continuous-serving path's counts start here
    t0 = time.perf_counter()
    greedy = _serve_bench(greedy_path, ckpt, smi, "greedy", "--temperature", "0")
    sampled = _serve_bench(sampled_path, ckpt, smi, "sampled, prefix cache, chunked prefill",
                           "--temperature", "0.8", "--top-k", "40",
                           "--shared-prefix-tokens", str(CONT_SHARED_PREFIX[0]),
                           "--shared-prefix-count", str(CONT_SHARED_PREFIX[1]),
                           requests=CONT_SLOW_FILL_REQUESTS)
    peak = torch.cuda.max_memory_allocated()
    _decode_profile(torch, greedy_path, ckpt, smi)
    _http_phase(torch, tmp, greedy_path, ckpt, smi)
    counts = _read_counts()  # and end here
    log(f"[continuous] phase 14 in {time.perf_counter() - t0:.1f} s; peak device memory of the "
        f"in-process runs {peak / 2**30:.2f} GiB on {smi}")
    _check_counts("continuous", counts, {})  # the paged path runs none of the kernels
    if sampled["prefix_cache"]["hit_rate"] <= 0:
        raise RuntimeError("the shared-prefix run never hit the prefix cache")
    return dict(greedy=greedy, sampled=sampled, counts=counts, peak_memory=peak,
                peak_above_base=peak - base, resident_bytes=greedy["resident_bytes"])


# Phase 15: speculative decoding, int8 serving and the rolling cache on
# phase 9's checkpoint. The draft is the preset cut to 2 layers of 256
# (same byte vocabulary and block), trained DRAFT_STEPS steps.
DRAFT_MODEL = dict(n_layers=2, d_model=256, n_heads=4, d_ff=1024)
DRAFT_STEPS = 100  # 200 until phase 21 came (PERF.md §2)
SPEC_GAMMA = 4
SPEC_PROMPTS = ("def ", "class Config:", "import numpy as np", "    for i in range(")
SPEC_NEW_TOKENS = 32  # 128 until phase 21 came, 64 until phase 23 (PERF.md §2)
INT8_LOGIT_COSINE = 0.99  # JAX's band, tests/test_quant.py::test_gpt_logits_track_full_precision
INT8_CACHE_COSINE = 0.999  # JAX's band, tests/test_quant.py::test_decode_logits_track_full_forward
WINDOW_PREFILL = 128  # the whole ring: every prefilled key kept
# Tokens decoded one a call after the prefill: the ring turns over once
# (WINDOW_SEQ - WINDOW_PREFILL, two turns, until phase 23 came; PERF.md §2).
WINDOW_DECODED = WINDOW

WINDOW_SPEC = (2, 64, 96)  # prompts, prompt tokens, new tokens: the ring wraps (128 new until phase 23)


def _draft_config(tmp: Path) -> Path:
    import yaml

    path = _smoke_config(tmp, "gpt_pycorpus_draft")
    raw = yaml.safe_load(path.read_text())
    raw["model"].update(DRAFT_MODEL)
    raw["trainer"].update(max_steps=DRAFT_STEPS, eval_every_steps=DRAFT_STEPS,
                          save_every_steps=DRAFT_STEPS)
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _decode_model(cfg_path: Path, ckpt: Path, quantize: str = "none", **extra_model):
    """The `generate` CLI's model: the checkpoint's weights, cast for
    decode, with ``quantize``; ``extra_model`` overrides model.extra."""
    from llmtrain_tpu_torch import cli
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.utils.logging import get_logger

    cfg, _, _ = load_and_validate_config(cfg_path)
    cfg.model.extra.update(extra_model)
    _, _, model = cli._build_decode_stack(cfg, resolve_device(cfg.run.device), get_logger())
    model, _, _ = cli._load_decode_params(cfg, model, str(ckpt), "compute", get_logger(),
                                          quantize=quantize)
    return model


def _cli_completions(argv: list[str]) -> list[list[int]]:
    code, out = _run_cli(argv)
    if code != 0:
        raise RuntimeError(f"{argv[0]} {' '.join(argv[5:])} exited {code}")
    return [r["output_ids"] for r in json.loads(out)["results"]]


def _cosine(a, b):
    """Per-row cosine of two (..., V) logit tensors, in f64."""
    a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
    return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))


def phase_speculative(torch, smi: str, tmp: Path, train: dict, cont: dict) -> dict:
    """Phase 15: (a) a draft trained through `train`, then `generate
    --draft-config` greedy against plain greedy, and the self-draft
    control; (c) the int8 logits' cosine and `generate --quantize int8`;
    (d) the rolling and int8 decode caches against the windowed flash
    kernel, and speculative greedy on the rolling target; (b) speculative
    `serve-bench --verify-parity`; (c) int8 `serve-bench --verify-parity`
    with its peak memory. Launch counts reset after the draft's training
    and read after the last serve-bench: the int8 logits' two forwards and
    the windowed reference launch the flash forward, one per layer each."""
    import gc
    import math

    import numpy as np

    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer
    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd
    from llmtrain_tpu_torch.ops.quant import model_tree, quant_stats
    from llmtrain_tpu_torch.speculative import speculative_generate

    t_phase = time.perf_counter()
    cfg_path, ckpt = train["cfg_path"], train["run_dir"] / "checkpoints"
    draft_cfg = _draft_config(tmp)
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(draft_cfg), "--run-id", "draft", "--json"])
    if code != 0:
        raise RuntimeError(f"train of the draft exited {code}")
    draft_result = json.loads(out)["train_result"]
    draft_ckpt = tmp / "runs" / "draft" / "checkpoints"
    log(f"[spec] draft {DRAFT_MODEL} trained {DRAFT_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s: final loss {draft_result['final_loss']:.4f}, val "
        f"{draft_result['final_val_loss']:.4f} (the target's "
        f"{train['summary']['final_val_loss']:.4f})")

    _reset_counts()  # phase 15's path counts start here
    # ---- (a) speculative generate against plain generate, greedy.
    prompts_file = tmp / "spec_prompts.txt"
    prompts_file.write_text("\n".join(SPEC_PROMPTS) + "\n")
    gen_argv = ["generate", "--config", str(cfg_path), "--from", str(ckpt), "--prompts-file",
                str(prompts_file), "--max-new-tokens", str(SPEC_NEW_TOKENS), "--temperature",
                "0", "--json"]
    draft_argv = ["--draft-config", str(draft_cfg), "--draft-from", str(draft_ckpt),
                  "--gamma", str(SPEC_GAMMA)]
    spec_ids = _cli_completions(gen_argv + draft_argv)
    model, draft = _decode_model(cfg_path, ckpt), _decode_model(draft_cfg, draft_ckpt)
    layers, dev = model.n_layers, next(model.parameters()).device
    tok = ByteTokenizer()
    prompts = [np.asarray([tok.encode(p)], np.int32) for p in SPEC_PROMPTS]
    plain_ids, plain_s, spec_s, stats = [], 0.0, 0.0, []
    speculative_generate(model, draft, prompts[0], max_new_tokens=8, gamma=SPEC_GAMMA)  # warm
    for ids in prompts:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = generate(model, ids, max_new_tokens=SPEC_NEW_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        plain_ids.append([int(t) for t in plain[0]])
        t0 = time.perf_counter()
        out, st = speculative_generate(model, draft, ids, max_new_tokens=SPEC_NEW_TOKENS,
                                       gamma=SPEC_GAMMA, return_stats=True)
        torch.cuda.synchronize()
        spec_s += time.perf_counter() - t0
        stats.append(st)
        if [int(t) for t in out[0]] != plain_ids[-1]:
            raise RuntimeError("speculative_generate() differs from greedy generate()")
    same = [a == b for a, b in zip(spec_ids, plain_ids)]
    n_tok = len(prompts) * SPEC_NEW_TOKENS
    calls = sum(st["target_forwards"] for st in stats)
    accepted = sum(st["mean_accepted"] * st["target_forwards"] for st in stats) / calls
    log(f"[spec] (a) `generate --draft-config ... --gamma {SPEC_GAMMA}` greedy, {len(prompts)} "
        f"prompts x {SPEC_NEW_TOKENS}: ids equal to plain greedy generate(): {same}")
    log(f"[spec] (a) on {smi}: plain {plain_s * 1e3 / n_tok:.2f} ms/token, speculative "
        f"{spec_s * 1e3 / n_tok:.2f} ms/token; {calls} target calls for {n_tok} tokens "
        f"({n_tok / calls:.3f} tokens per target call), acceptance rate "
        f"{accepted / SPEC_GAMMA:.4f} ({accepted:.3f} of {SPEC_GAMMA} drafts per call)")
    if not all(same):
        raise RuntimeError("speculative generate differs from plain greedy generate")
    want_calls = math.ceil(SPEC_NEW_TOKENS / (SPEC_GAMMA + 1))
    self_calls = [speculative_generate(model, model, ids, max_new_tokens=SPEC_NEW_TOKENS,
                                       gamma=SPEC_GAMMA, return_stats=True)[1]["target_forwards"]
                  for ids in prompts]
    log(f"[spec] (a) control, the target as its own draft: target calls per prompt "
        f"{self_calls} (every draft accepted: {want_calls} each)")
    if self_calls != [want_calls] * len(prompts):
        raise RuntimeError("the self-draft did not accept every draft")
    del draft

    # ---- (c) int8 weights: logits against bf16, then generate.
    q_model = _decode_model(cfg_path, ckpt, quantize="int8")
    qstats = quant_stats(model_tree(q_model))
    gen = torch.Generator(device=dev).manual_seed(15)
    ids = torch.randint(0, 256, INT8_LOGIT_IDS, device=dev, generator=gen)
    with torch.inference_mode():
        cos = _cosine(q_model(ids).float(), model(ids).float())
    log(f"[int8] quant_stats: {qstats['quantized_params']}/{qstats['total_params']} params "
        f"quantized in {qstats['quantized_leaves']} leaves, {qstats['bytes']} bytes against "
        f"{qstats['bytes_dense']} ({qstats['compression']:.3f}x compression)")
    log(f"[int8] logits of int8 against bf16 weights, {INT8_LOGIT_IDS[0]} x "
        f"{INT8_LOGIT_IDS[1]} positions: cosine min "
        f"{cos.min().item():.6f} mean {cos.mean().item():.6f} (> {INT8_LOGIT_COSINE})")
    if cos.min().item() <= INT8_LOGIT_COSINE:
        raise RuntimeError("int8 logits do not track the bf16 logits")
    q_ids = _cli_completions(gen_argv + ["--quantize", "int8"])
    q_ref = [[int(t) for t in generate(q_model, p, max_new_tokens=SPEC_NEW_TOKENS,
                                        temperature=0.0)[0]] for p in prompts]
    log(f"[int8] `generate --quantize int8` equal to generate() on the quantized weights: "
        f"{[a == b for a, b in zip(q_ids, q_ref)]}")
    if q_ids != q_ref:
        raise RuntimeError("generate --quantize int8 differs from generate() on its weights")
    del q_model

    # ---- (d) rolling and int8 decode caches against the windowed kernel.
    rolling = {}
    seq = torch.randint(0, 256, (1, WINDOW_PREFILL + WINDOW_DECODED), device=dev,
                        generator=gen)
    for kv_dtype in ("model", "int8"):
        wmodel = _decode_model(cfg_path, ckpt, sliding_window=WINDOW, kv_cache_dtype=kv_dtype)
        decoder = wmodel.for_decoding()
        cache = decoder.init_cache(1)
        with torch.inference_mode():
            if kv_dtype == "model":
                before = flash_attention_fwd.launches
                full = wmodel(seq).float()  # the windowed flash kernel in every layer
                window_launches = flash_attention_fwd.launches - before
            steps = [decoder(seq[:, :WINDOW_PREFILL], cache)[:, -1].float()]
            steps += [decoder(seq[:, i:i + 1], cache)[:, 0].float()
                      for i in range(WINDOW_PREFILL, seq.shape[1])]
        got = torch.cat(steps)  # positions WINDOW_PREFILL - 1 .. the last
        want = full[0, WINDOW_PREFILL - 1:]
        rolling[kv_dtype] = dict(
            last_err=(got[-1] - want[-1]).abs().max().item(),
            max_err=(got - want).abs().max().item(),
            last_cos=_cosine(got[-1:], want[-1:]).item(),
            min_cos=_cosine(got, want).min().item(),
            slots=decoder.slots,
        )
        del wmodel
    log(f"[rolling] window {WINDOW}, {seq.shape[1]} tokens teacher-forced ({WINDOW_PREFILL} "
        f"prefilled, then one a call) through the rolling cache of {rolling['model']['slots']} "
        f"slots, against the windowed flash forward ({window_launches} kernel launches): "
        f"last-position max abs diff {rolling['model']['last_err']:.4e} (atol {LOGITS_ATOL}), "
        f"over every decoded position {rolling['model']['max_err']:.4e}")
    log(f"[rolling] int8 cache: last-position cosine {rolling['int8']['last_cos']:.6f} "
        f"(> {INT8_CACHE_COSINE}), min over positions {rolling['int8']['min_cos']:.6f}; max abs "
        f"diff {rolling['int8']['max_err']:.4e}")
    if rolling["model"]["last_err"] > LOGITS_ATOL or window_launches != layers:
        raise RuntimeError("rolling-cache logits disagree with the windowed flash kernel")
    if rolling["int8"]["last_cos"] <= INT8_CACHE_COSINE:
        raise RuntimeError("int8-cache logits do not track the full forward")
    wmodel = _decode_model(cfg_path, ckpt, sliding_window=WINDOW)
    n_prompts, p_len, new = WINDOW_SPEC
    same = []
    for i in range(n_prompts):
        ids = seq[:, i * p_len:(i + 1) * p_len].cpu().numpy().astype(np.int32)
        plain = generate(wmodel, ids, max_new_tokens=new, temperature=0.0)
        out = speculative_generate(wmodel, model, ids, max_new_tokens=new, gamma=SPEC_GAMMA)
        same.append(bool(np.array_equal(out, plain)))
    log(f"[rolling] speculative greedy on the rolling target (ring of {WINDOW} + "
        f"{SPEC_GAMMA + 1} slots; draft: the full-attention model), {n_prompts} prompts of "
        f"{p_len} + {new}: equal to plain greedy: {same}")
    if not all(same):
        raise RuntimeError("speculative greedy on the rolling target differs from greedy")
    del wmodel, model
    torch.cuda.empty_cache()

    # ---- (b) speculative serve-bench; (c) int8 serve-bench and its peak.
    greedy_path = _serving_config(tmp, "gpt_pycorpus_speculative")
    spec_block = _serve_bench(greedy_path, ckpt, smi, "speculative", "--temperature", "0",
                              *draft_argv, requests=SPEC_BENCH_REQUESTS)
    spec = spec_block["scheduler_stats"]["speculative"]
    log(f"[spec] (b) {spec['mode']} speculative serving: {spec['rounds']} rounds, "
        f"{spec['accepted']}/{spec['drafted']} drafts accepted (acceptance rate "
        f"{spec['acceptance_rate']}); verify shapes {spec_block['compile']['verify_shapes_used']}")
    if spec["mode"] != "batched" or not spec_block["compile"]["verify_shapes_used"]:
        raise RuntimeError("speculative serve-bench did not verify in batch")
    gc.collect()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    int8_block = _serve_bench(greedy_path, ckpt, smi, "int8 weights", "--temperature", "0",
                              "--quantize", "int8")
    peak = torch.cuda.max_memory_allocated() - base
    log(f"[int8] device memory the int8 serving backend holds once built "
        f"{int8_block['resident_bytes'] / 2**30:.3f} GiB (phase 14's bf16 greedy run: "
        f"{cont['resident_bytes'] / 2**30:.3f} GiB); peak over the run "
        f"{peak / 2**30:.3f} GiB (phase 14's two bf16 runs: "
        f"{cont['peak_above_base'] / 2**30:.3f} GiB; both above what was allocated before, "
        f"the load's f32 build and cast included) on {smi}")
    counts = _read_counts()  # and end here
    _check_counts("speculative", counts, {"flash_attention_fwd": 2 * layers + window_launches})
    timing = phase_timing(torch, smi, (1, WINDOW_SEQ, 12, 12, 64), window=WINDOW)
    log(f"[spec] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, window_launches=window_launches, window_timing=timing,
                int8_peak=peak)


# Phase 16: the fleet tier and request tracing on phase 9's checkpoint.
# (a) phase 14(b)'s traffic cut to FLEET_REQUESTS behind a router over
# FLEET_REPLICAS in-process replicas; (b) a `serve --router` child reloaded
# under CONT_RELOAD_REQUESTS of FLEET_RELOAD_NEW_TOKENS in flight; (c) two
# `serve` replica children and a dead port behind a `serve --backends`
# router child, FLEET_HTTP_REQUESTS greedy requests of FLEET_HTTP_NEW_TOKENS;
# (d), phase 14(a)'s traffic with the timeline off, went with phase 24
# (tools/serve_fleet_costs.py measures it in turns). The cuts keep the whole
# run near 800 s: with 48 requests and 496-token reload requests phase 16
# took 156 s and the run 827 s on a slow host (a's parity pass is 48
# sequential generate() calls).
FLEET_REPLICAS = 2
FLEET_REQUESTS = 12  # 24 until phase 21 came, 16 until phase 23 (PERF.md §2)
FLEET_RELOAD_NEW_TOKENS = 128  # 256 until phase 23 came (PERF.md §2)
FLEET_HTTP_REQUESTS = 8  # 16 until phase 23 came (PERF.md §2)
FLEET_HTTP_NEW_TOKENS = 16  # 32 until phase 23 came (PERF.md §2)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _log_messages(log_path: Path, needle: str) -> list[str]:
    """The messages of a child's JSON log lines that contain ``needle``."""
    out = []
    for line in log_path.read_text().splitlines():
        try:
            message = json.loads(line).get("message", "")
        except json.JSONDecodeError:
            continue
        if needle in message:
            out.append(message)
    return out


def _fleet_bench(tmp: Path, ckpt: Path, smi: str, cont: dict) -> dict:
    """16(a): phase 14(b)'s traffic, FLEET_REQUESTS of it, through
    `serve-bench --router --replicas 2 --verify-parity`, its gates and the
    report, trace.json and timelines it writes."""
    out_dir = tmp / "bench_router"
    block = _serve_bench(tmp / "gpt_pycorpus_continuous_prefix.yaml", ckpt, smi, "router",
                         "--router", "--replicas", str(FLEET_REPLICAS), "--out", str(out_dir),
                         "--temperature", "0.8", "--top-k", "40",
                         "--shared-prefix-tokens", str(CONT_SHARED_PREFIX[0]),
                         "--shared-prefix-count", str(CONT_SHARED_PREFIX[1]),
                         requests=FLEET_REQUESTS)
    fleet, summary = block["router"], block.pop("summary")
    occ = [(s["mean_batch_occupancy"], s["peak_batch_occupancy"]) for s in block["replica_stats"]]
    affinity = fleet["affinity_routed"] / max(1, fleet["requests_routed"])
    slo, ref = block["slo"], cont["sampled"]
    log(f"[fleet] (a) {FLEET_REPLICAS} in-process replicas, {FLEET_REQUESTS} requests, "
        f"on {smi}: "
        f"{block['throughput']['tokens_per_sec']} output tokens/s (phase 14(b), "
        f"{CONT_SLOW_FILL_REQUESTS} requests: "
        f"{ref['throughput']['tokens_per_sec']}); TTFT p50 {slo['ttft_ms']['p50']} p99 "
        f"{slo['ttft_ms']['p99']} ms (14(b) {ref['slo']['ttft_ms']['p50']} / "
        f"{ref['slo']['ttft_ms']['p99']}); per-token p50 {slo['per_token_ms']['p50']} p99 "
        f"{slo['per_token_ms']['p99']} ms (14(b) {ref['slo']['per_token_ms']['p50']} / "
        f"{ref['slo']['per_token_ms']['p99']}); replicas' occupancy (mean, peak) {occ} of "
        f"{block['replica_stats'][0]['max_batch_slots']} each; routed "
        f"{[r['routed'] for r in fleet['replicas']]}; affinity share {affinity:.4f} "
        f"({fleet['affinity_routed']}/{fleet['requests_routed']}); fleet prefix hit rate "
        f"{fleet['fleet_prefix']['hit_rate']} (14(b) {ref['prefix_cache']['hit_rate']}); "
        f"tracing {block.get('tracing')}")
    if (any(r["requests_finished"] < 1 for r in fleet["replicas"])
            or fleet["affinity_routed"] <= 0 or fleet["fleet_prefix"]["hit_rate"] <= 0):
        raise RuntimeError(f"the router did not spread or reuse prefixes: {fleet}")
    for key in ("report_json", "report_md", "trace_json"):
        if not summary[key] or not Path(summary[key]).is_file():
            raise RuntimeError(f"serve-bench --router wrote no {key}")
    json.loads(Path(summary["trace_json"]).read_text())
    report = json.loads(Path(summary["report_json"]).read_text())
    # trace.json is the router's own track; in-process replicas record the
    # requests' spans in their own timelines, which `trace merge` joins.
    merged = out_dir / "merged_trace.json"
    code, out = _run_cli(["trace", "merge", "--run-dir", summary["trace_dir"],
                          "--out", str(merged), "--json"])
    tagged = set()
    for ev in json.loads(merged.read_text())["traceEvents"]:
        args = ev.get("args") or {}
        tagged.update([args["rid"]] if "rid" in args else args.get("rids", []))
    want = {f"lg-14-{i}" for i in range(FLEET_REQUESTS)}
    log(f"[fleet] (a) report.json serving block {sorted(report['serving'])}; trace merge exit "
        f"{code}: {out.strip()}; requests with spans {len(want & tagged)}/{len(want)}")
    if code != 0 or want - tagged:
        raise RuntimeError(f"requests without spans in the merged trace: {sorted(want - tagged)}")
    return block


def _fleet_reload(base: str, log_path: Path, smi: str) -> dict:
    """16(b): POST /reload of the same checkpoint to a `serve --router` child
    while CONT_RELOAD_REQUESTS greedy requests of FLEET_RELOAD_NEW_TOKENS are
    in flight."""
    import numpy as np

    rng = np.random.default_rng(17)
    bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, CONT_PROMPTS[0])],
               "max_new_tokens": FLEET_RELOAD_NEW_TOKENS, "temperature": 0}
              for _ in range(CONT_RELOAD_REQUESTS)]
    code, resp, reload_ms, in_flight, answers, deadline = _reload_under_load(base, bodies)
    while True:  # each replica applies its swap between its own steps
        fleet = json.loads(_get(f"{base}/healthz")[1])["scheduler"]["router"]
        epochs = [r["param_epoch"] for r in fleet["replicas"]]
        if all(e >= 1 for e in epochs) or time.monotonic() > deadline:
            break
        time.sleep(0.01)
    memory = _log_messages(log_path, "reload: device memory")
    log(f"[fleet] (b) POST /reload with {CONT_RELOAD_REQUESTS} requests in flight on {smi}: "
        f"HTTP {code} in {reload_ms:.0f} ms, {in_flight} still in flight when it answered; "
        f"replicas {resp.get('replicas')}; epochs after {epochs}; the requests: HTTP "
        f"{[a[0] for a in answers]}, {[len(a[1].get('completion_ids', [])) for a in answers]} "
        f"tokens; the child's log: {memory}")
    if (code != 200 or any(e < 1 for e in epochs) or len(epochs) != FLEET_REPLICAS
            or any(a[0] != 200 or len(a[1]["completion_ids"]) != FLEET_RELOAD_NEW_TOKENS
                   for a in answers)):
        raise RuntimeError("the rolling reload or the requests in flight across it failed")
    return dict(reload_ms=reload_ms, in_flight=in_flight, memory=memory)


def _fleet_http(cfg_path: Path, ckpt: Path, router: str, replica: str, smi: str) -> dict:
    """16(c): FLEET_HTTP_REQUESTS greedy requests through the `serve
    --backends` child, their tokens against generate(), failover past the
    dead port, exemplars on a replica's /metrics."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from llmtrain_tpu_torch.generation import generate

    rng = np.random.default_rng(18)
    bodies = [{"prompt_ids": [int(x) for x in rng.integers(0, 256, n)],
               "max_new_tokens": FLEET_HTTP_NEW_TOKENS, "temperature": 0}
              for n in np.linspace(*CONT_PROMPTS, FLEET_HTTP_REQUESTS).astype(int)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(FLEET_HTTP_REQUESTS) as ex:
        answers = list(ex.map(lambda b: _post_h(f"{router}/v1/generate", b), bodies))
    wall = time.perf_counter() - t0
    fleet = json.loads(_get(f"{router}/healthz")[1])["scheduler"]["router"]
    model = _decode_model(cfg_path, ckpt)
    same = []
    for (code, out, _), body in zip(answers, bodies):
        prompt = np.asarray([body["prompt_ids"]], np.int32)
        want = generate(model, prompt, max_new_tokens=FLEET_HTTP_NEW_TOKENS, temperature=0.0)
        same.append(code == 200 and out["completion_ids"] == want[0, prompt.shape[1]:].tolist())
    del model
    exemplars = [line for line in _get(f"{replica}/metrics")[1].decode().splitlines()
                 if line.startswith("llmtrain_serve_ttft_ms_bucket") and 'trace_id="' in line]
    log(f"[fleet] (c) {FLEET_HTTP_REQUESTS} concurrent greedy requests through `serve "
        f"--backends` (2 replicas + a dead port) on {smi}: HTTP {[a[0] for a in answers]} in "
        f"{wall * 1e3:.0f} ms; tokens equal to generate(): {same}; failovers "
        f"{fleet['failovers']}, healthy {fleet['replicas_healthy']}, routed "
        f"{[r['routed'] for r in fleet['replicas']]}; TTFT exemplars on replica0 /metrics: "
        f"{len(exemplars)}")
    if not all(same) or fleet["failovers"] < 1 or not exemplars:
        raise RuntimeError("the HTTP fleet failed its gates (tokens, failover or exemplars)")
    return dict(wall_ms=wall * 1e3, failovers=fleet["failovers"])


def _fleet_traces(fleet_dir: Path, smi: str) -> dict:
    """16(c), read back: `trace summary`, `trace slowest` and `trace merge`
    over the three processes' timelines, and every kept trace's tree and
    critical path (JAX's tests/test_trace_e2e.py checks)."""
    from llmtrain_tpu_torch.telemetry.trace_collect import (
        collect_traces,
        critical_path,
        discover_sources,
        format_tree,
    )

    outs = {}
    for action in ("summary", "slowest", "merge"):
        argv = ["trace", action, "--run-dir", str(fleet_dir), "--json"]
        code, out = _run_cli(argv + (["--k", "3"] if action == "slowest" else []))
        if code != 0:
            raise RuntimeError(f"trace {action} exited {code}")
        outs[action] = json.loads(out)
    code, shown = _run_cli(["trace", "show", outs["slowest"][0]["trace_id"], "--run-dir",
                            str(fleet_dir), "--json"])
    traces = collect_traces(discover_sources([fleet_dir]))
    bad = []
    for trace in traces.values():
        root = trace.root
        hops = [s for s in trace.children(root.span_id) if s.name == "router/http_dispatch"]
        served = [c for h in hops for c in trace.children(h.span_id)
                  if c.name == "serve/request"]
        names = {c.name for c in trace.children(served[0].span_id)} if len(served) == 1 else set()
        cp = critical_path(trace)
        if (root.name != "router/request" or "router" not in root.source or len(served) != 1
                or served[0].source == root.source
                or not {"serve/prefill", "serve/decode_phase"} <= names
                or abs(sum(cp["breakdown"].values()) - cp["total_ms"]) > 0.05):
            bad.append("\n".join(format_tree(trace)))
    summary = outs["summary"]
    log(f"[fleet] (c) trace summary on {smi}: {summary['traces']} traces, end to end "
        f"{summary['end_to_end_ms']}; spans {sorted(summary['spans'])}; slowest "
        f"{[(r['total_ms'], r['sampled']) for r in outs['slowest']]}; merge {outs['merge']}; "
        f"show exit {code}, critical path {json.loads(shown)['critical_path']['breakdown']}")
    if len(traces) != FLEET_HTTP_REQUESTS or bad or code != 0:
        raise RuntimeError(f"{len(traces)} traces, {len(bad)} without the router → replica "
                           f"tree: {bad[:2]}")
    return dict(summary=summary)


def phase_fleet(torch, smi: str, tmp: Path, train: dict, cont: dict) -> dict:
    """Phase 16: the replica router and request tracing on phase 9's
    checkpoint (see FLEET_*). Launch counts reset just before and read just
    after: the fleet runs none of the eight kernels."""
    from concurrent.futures import ThreadPoolExecutor

    ckpt = train["run_dir"] / "checkpoints"
    greedy_path = tmp / "gpt_pycorpus_continuous.yaml"
    fleet_dir = tmp / "fleet_traces"
    dead = _free_port()
    ports = [_free_port() for _ in range(FLEET_REPLICAS)]
    # The dead port first: the first placement goes to it and fails over.
    backends = ",".join([f"http://127.0.0.1:{p}" for p in [dead, *ports]])
    children = {
        "reload": (tmp / "fleet_reload.log", "--router", "--replicas", str(FLEET_REPLICAS),
                   "--port", "0"),
        **{f"replica{i}": (tmp / f"fleet_replica{i}.log", "--port", str(p), "--trace-dir",
                           str(fleet_dir / f"replica{i}")) for i, p in enumerate(ports)},
        "router": (tmp / "fleet_router.log", "--backends", backends, "--port", "0",
                   "--trace-dir", str(fleet_dir / "router")),
    }
    _reset_counts()  # the fleet's counts start here
    t0 = time.perf_counter()
    procs: dict = {}
    try:
        with ThreadPoolExecutor(len(children)) as ex:
            started = {k: ex.submit(_start_server, greedy_path, ckpt, *v)
                       for k, v in children.items()}
            for k, f in started.items():
                procs[k] = f.result()
        log(f"[fleet] {len(procs)} `serve` children ready in {time.perf_counter() - t0:.1f} s")
        bench = _fleet_bench(tmp, ckpt, smi, cont)
        reload = _fleet_reload(procs["reload"][1], children["reload"][0], smi)
        http = _fleet_http(greedy_path, ckpt, procs["router"][1], procs["replica0"][1], smi)
    finally:
        for proc, _ in procs.values():
            _stop_server(proc)
    traces = _fleet_traces(fleet_dir, smi)
    counts = _read_counts()  # and end here
    log(f"[fleet] phase 16 in {time.perf_counter() - t0:.1f} s on {smi}")
    _check_counts("fleet", counts, {})  # the fleet tier runs none of the kernels
    return dict(bench=bench, reload=reload, http=http, traces=traces)


# ------------------------------------------- offline data and checkpoint tools
# Phase 17. (a) `train-tokenizer` over the running interpreter's stdlib,
# TOKENIZER_MAX_BYTES of it at TOKENIZER_VOCAB. (b) `train` on
# configs/presets/gpt_pycorpus_bpe_tpu.yaml at full width, BPE_LAYERS deep, with the
# tracked vocabulary runs/pytok8k.json (8192 ids, so dense CE as in JAX),
# cut like TRAIN_STEPS: BPE_STEPS steps, warmup a quarter of them, every
# step logged, eval and a save at BPE_SAVE_EVERY and at the end, the corpus
# glob pointed at the stdlib. (c) `eval --from` the final checkpoint, bf16
# and --quantize int8. (d) export-checkpoint -> import-checkpoint -> eval,
# and average-checkpoints --last-k 2 -> eval. (e) the smoke presets
# gpt_smoke and dummy_smoke trained SMOKE_PRESET_STEPS steps on the card.
TOKENIZER_MAX_BYTES = 2_000_000  # 4_000_000 until phase 23 came (PERF.md §2)
TOKENIZER_VOCAB = 1024
BPE_STEPS = 20
# A depth cut for phase 23's time (PERF.md §2): 12 layers until then.
BPE_LAYERS = 4
BPE_WARMUP = BPE_STEPS // 4
BPE_SAVE_EVERY = BPE_STEPS // 2
# `eval` of the final checkpoint against the trainer's own eval at that
# step: the same params and batches through the same kernels, which are
# bit-identical across reruns; the limit leaves room for a cuBLAS
# algorithm picked differently in a freshly built model.
EVAL_ATOL = 1e-4
SMOKE_PRESET_STEPS = 5


def _bpe_config(tmp: Path) -> Path:
    import sysconfig

    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs/presets/gpt_pycorpus_bpe_tpu.yaml").read_text())
    raw["run"]["device"] = "cuda"
    raw["model"]["extra"]["tokenizer"] = f"bpe:{root / 'runs' / 'pytok8k.json'}"
    raw["data"]["cache_dir"] = str(tmp / "cache")
    raw["data"]["extra"]["globs"] = [sysconfig.get_paths()["stdlib"] + "/**/*.py"]
    raw["model"]["n_layers"] = BPE_LAYERS
    raw["trainer"].update(max_steps=BPE_STEPS, warmup_steps=BPE_WARMUP, log_every_steps=1,
                          eval_every_steps=BPE_SAVE_EVERY, save_every_steps=BPE_SAVE_EVERY)
    raw["output"]["root_dir"] = str(tmp / "runs")
    path = tmp / "gpt_pycorpus_bpe_smoke.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _eval_cli(cfg_path: Path, spec: Path, *extra: str) -> float:
    code, out = _run_cli(["eval", "--config", str(cfg_path), "--from", str(spec), "--json",
                          *extra])
    if code != 0:
        raise RuntimeError(f"eval --from {spec} {' '.join(extra)} exited {code}")
    loss = json.loads(out)["metrics"]["val/loss"]
    if not math.isfinite(loss):
        raise RuntimeError(f"eval --from {spec} gave a non-finite loss {loss}")
    return loss


def _offline_tokenizer(tmp: Path, smi: str) -> None:
    """(a) train-tokenizer over the stdlib; the vocabulary loads and
    round-trips one stdlib file exactly."""
    import sysconfig

    from llmtrain_tpu_torch.data.bpe import BPETokenizer

    stdlib = Path(sysconfig.get_paths()["stdlib"])
    out = tmp / "stdlib_tok.json"
    t0 = time.perf_counter()
    code, text = _run_cli(["train-tokenizer", "--input", str(stdlib), "--max-bytes",
                           str(TOKENIZER_MAX_BYTES), "--vocab-size", str(TOKENIZER_VOCAB),
                           "--output", str(out), "--json"])
    wall = time.perf_counter() - t0
    if code != 0:
        raise RuntimeError(f"train-tokenizer exited {code}")
    stats = json.loads(text)
    tok = BPETokenizer.load(out)
    sample = (stdlib / "argparse.py").read_text(encoding="utf-8")
    ids = tok.encode(sample)
    log(f"[offline] train-tokenizer: {stats['files']} files, {stats['corpus_bytes']} bytes, "
        f"vocab {stats['vocab_size']} in {stats['train_seconds']} s of training ({wall:.1f} s "
        f"command, the file walk included), {stats['bytes_per_token']} bytes/token; "
        f"argparse.py -> {len(ids)} ids ({tok.encoder} encoder) on {smi}")
    if tok.n_vocab != TOKENIZER_VOCAB or tok.decode(ids) != sample:
        raise RuntimeError("the trained vocabulary does not round-trip a stdlib file")


def _offline_train(torch, smi: str, cfg_path: Path) -> dict:
    """(b) train on the BPE preset; returns its summary, steps, counts and
    run dir."""
    import glob
    import os

    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries

    cfg, _, _ = load_and_validate_config(cfg_path)
    initialize_registries()
    adapter = get_model_adapter(cfg.model.name)()
    tok = adapter.build_tokenizer(cfg)
    files = {f for g in cfg.data.extra["globs"] for f in glob.glob(g, recursive=True)}
    corpus_bytes = sum(os.path.getsize(f) for f in files if os.path.isfile(f))
    t0 = time.perf_counter()
    dm = LocalTextDataModule()
    dm.setup(cfg, tok)  # writes the token cache the train call reads
    tok_s = time.perf_counter() - t0
    n_train, n_val = len(dm.train_dataset()), len(dm.val_dataset())
    log(f"[offline] corpus {cfg.data.extra['globs'][0]}: {corpus_bytes} bytes, tokenized by "
        f"the {tok.encoder} BPE encoder in {tok_s:.2f} s ({corpus_bytes / tok_s / 1e6:.2f} MB/s "
        f"on the host); {n_train} train / {n_val} val windows of {cfg.model.block_size + 1} "
        f"tokens of vocab {tok.n_vocab}")
    built = adapter.build_model(cfg, resolve_device(cfg.run.device))
    resolved, vocab = built.loss_impl, built.vocab_size
    del built
    torch.cuda.empty_cache()
    log(f"[offline] vocab_size null -> {vocab} from the tokenizer; loss_impl -> {resolved!r}")
    if resolved != "dense" or vocab != tok.n_vocab:
        raise RuntimeError(f"the BPE preset resolved loss_impl {resolved!r}, vocab {vocab}")
    eval_batches = -(-n_val // cfg.trainer.micro_batch_size)

    _reset_counts()  # the BPE training path's counts start here
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "bpe", "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"BPE train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = Path(cfg.output.root_dir) / "bpe"
    steps = _logged_steps(run_dir)
    losses = [steps[i]["loss"] for i in sorted(steps)]
    log(f"[offline] {BPE_STEPS} steps in {wall:.1f} s (command wall, model build and compile "
        f"included); losses {' '.join(f'{x:.4f}' for x in losses)}; val "
        f"{summary['final_val_loss']:.4f}")
    layers = cfg.model.n_layers
    _check_counts("bpe-train", counts, {
        "flash_attention_fwd": layers * (BPE_STEPS + (BPE_STEPS // BPE_SAVE_EVERY) * eval_batches),
        "flash_attention_bwd_dq": layers * BPE_STEPS,
        "flash_attention_bwd_dkdv": layers * BPE_STEPS,
    })
    if len(losses) != BPE_STEPS or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"BPE losses are not {BPE_STEPS} finite values: {losses}")
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"BPE loss did not fall by {LOSS_DROP_MIN}: {losses[0]} -> {losses[-1]}")
    steady = [steps[i] for i in sorted(steps) if i > 5]
    step_ms = float(np.median([x["step_time"] for x in steady])) * 1e3
    tok_per_s = float(np.median([x["tokens_per_sec"] for x in steady]))
    mfu = float(np.median([x["mfu"] for x in steady]))
    log(f"[offline] steady state (median of steps 6-{BPE_STEPS}) on {smi}: step {step_ms:.1f} ms, "
        f"{tok_per_s:.0f} tokens/s, MFU {mfu:.4f} (6N + 12 L T d with N at vocab {vocab}, "
        f"989 TFLOP/s bf16 peak), peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    return dict(summary=summary, steps=steps, counts=counts, run_dir=run_dir, step_ms=step_ms,
                tokens_per_sec=tok_per_s, mfu=mfu, eval_batches=eval_batches,
                corpus_bytes=corpus_bytes, tokenize_s=tok_s, encoder=tok.encoder, layers=layers)


def phase_offline(torch, smi: str, tmp: Path) -> dict:
    """Phase 17: the offline data path and the checkpoint tools (see
    TOKENIZER_MAX_BYTES). Launch counts of (b) are checked around the train
    call, of (c)-(d) around the evals: 12 flash forwards per eval batch."""
    import yaml

    t0 = time.perf_counter()
    _offline_tokenizer(tmp, smi)
    cfg_path = _bpe_config(tmp)
    train = _offline_train(torch, smi, cfg_path)
    run_dir, layers = train["run_dir"], train["layers"]

    _reset_counts()  # (c)-(d)'s counts start here
    bf16 = _eval_cli(cfg_path, run_dir)
    int8 = _eval_cli(cfg_path, run_dir, "--quantize", "int8")
    trainer_val = train["summary"]["final_val_loss"]
    log(f"[offline] eval --from step {BPE_STEPS}: val/loss {bf16:.6f}, the trainer's own eval "
        f"{trainer_val:.6f} (diff {abs(bf16 - trainer_val):.2e}, atol {EVAL_ATOL}); "
        f"--quantize int8 {int8:.6f} ({int8 - bf16:+.6f})")
    if abs(bf16 - trainer_val) > EVAL_ATOL:
        raise RuntimeError("eval does not reproduce the trainer's eval")

    exported, imported = tmp / "bpe_export.pt", tmp / "bpe_imported"
    code, out = _run_cli(["export-checkpoint", "--config", str(cfg_path), "--from", str(run_dir),
                          "--output", str(exported), "--json"])
    if code != 0:
        raise RuntimeError(f"export-checkpoint exited {code}")
    export = json.loads(out)
    code, _ = _run_cli(["import-checkpoint", "--config", str(cfg_path), "--input", str(exported),
                        "--output", str(imported), "--json"])
    if code != 0:
        raise RuntimeError(f"import-checkpoint exited {code}")
    round_trip = _eval_cli(cfg_path, imported)
    log(f"[offline] export-checkpoint: {export['tensors']} tensors, {export['parameters']} "
        f"parameters, {exported.stat().st_size} bytes; import -> eval {round_trip!r} against "
        f"{bf16!r}")
    if round_trip != bf16:
        raise RuntimeError("export -> import -> eval is not bit-identical to eval")
    averaged = tmp / "bpe_averaged"
    code, out = _run_cli(["average-checkpoints", "--config", str(cfg_path), "--inputs",
                          str(run_dir / "checkpoints"), "--last-k", "2", "--output",
                          str(averaged), "--json"])
    if code != 0:
        raise RuntimeError(f"average-checkpoints exited {code}")
    soup = _eval_cli(cfg_path, averaged)
    log(f"[offline] average-checkpoints --last-k 2 (steps {json.loads(out)['steps']}) -> eval "
        f"{soup:.6f}")
    counts = _read_counts()  # and end here: four evals of the val split
    _check_counts("offline-eval", counts, {
        "flash_attention_fwd": 4 * layers * train["eval_batches"]})

    _reset_counts()  # (e): the smoke presets run none of the kernels
    for name in ("gpt_smoke", "dummy_smoke"):
        root = Path(__file__).resolve().parent
        raw = yaml.safe_load((root / "configs/presets" / f"{name}.yaml").read_text())
        raw["run"]["device"] = "cuda"
        raw["trainer"].update(max_steps=SMOKE_PRESET_STEPS, log_every_steps=1)
        raw["output"]["root_dir"] = str(tmp / "runs")
        path = tmp / f"{name}.yaml"
        path.write_text(yaml.safe_dump(raw, sort_keys=False))
        code, out = _run_cli(["train", "--config", str(path), "--run-id", name, "--json"])
        if code != 0:
            raise RuntimeError(f"{name} train on the card exited {code}")
        losses = [v["loss"] for _, v in sorted(_logged_steps(tmp / "runs" / name).items())]
        log(f"[offline] {name} on the card: losses {' '.join(f'{x:.4f}' for x in losses)}")
        if len(losses) != SMOKE_PRESET_STEPS or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{name}: losses are not {SMOKE_PRESET_STEPS} finite values")
    _check_counts("smoke-presets", _read_counts(), {})
    log(f"[offline] phase 17 in {time.perf_counter() - t0:.1f} s on {smi}")
    return dict(train=train, counts={k: train["counts"][k] + counts[k] for k in counts},
                eval=bf16, int8=int8, soup=soup)


# ------------------------------------------------------- slice 2 deferrals
# Phase 18: a short run of the slice's path, long enough for the
# profiler's window, a few steady steps after it, and one eval and one
# save at the end.
DDP_STEPS = 12
DDP_EMA = 0.999
DDP_PROFILE = (3, 2)  # first step, steps
# The one-rank job against the plain run: the same data and init, and the
# one-rank sums are the identity; only nondeterministic reductions (atomics
# in aten's embedding backward) can separate the two.
DDP_ATOL = 1e-3
DDP_BACKEND = "nccl"  # run.device cuda
# (c): the first updates at these widths raise the loss before it falls
# (AdamW's run of (a): 5.54 -> 7.01 at step 4 -> 3.73 at step 6, after
# 1.5e-3 of summed lr), so each optimizer gets more steps at the preset's
# lr: the first updates of all three are sign-like steps of size lr.
OPT_STEPS = 16
OPT_WARMUP = 4
# ... at OPT_LAYERS of the cell's 12 (a depth cut for phase 22's time,
# PERF.md §2; each run's state bytes are held against the AdamW run's).
OPT_LAYERS = 4


def _ddp_config(tmp: Path, name: str, *, steps: int, distributed: bool = False,
                warmup: int | None = None, **extra) -> Path:
    """Phase 9's config cut to ``steps`` (warmup ``steps`` unless given),
    one eval and one save at the end, ``trainer.extra`` updated."""
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["trainer"].update(max_steps=steps, warmup_steps=steps if warmup is None else warmup,
                          eval_every_steps=steps,
                          save_every_steps=steps)
    raw["trainer"].setdefault("extra", {}).update(extra)
    raw["distributed"] = {"enabled": distributed, "timeout_sec": 300}
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _steady(steps: dict, skip=()) -> dict:
    """Medians of step time, tokens/s and MFU over the logged steps but
    the first (compiles, caches), the last (the save) and ``skip``."""
    import numpy as np

    last = max(steps)
    rows = [v for k, v in sorted(steps.items()) if 1 < k < last and k not in skip]
    return {key: float(np.median([r[key] for r in rows]))
            for key in ("step_time", "tokens_per_sec", "mfu")}


def _trace_kernels(trace: Path) -> tuple[dict[str, int], dict[str, int]]:
    """Device kernels of a Chrome trace -> launch counts: all of them, and
    those launched inside an ``nccl:all_reduce`` op (matched by the launch
    call's correlation id)."""
    events = json.loads(trace.read_text()).get("traceEvents", [])
    spans = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == "nccl:all_reduce" and "ts" in e]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})
              and any(t == e.get("tid") and a <= e["ts"] <= b for t, a, b in spans)}
    counts: dict[str, int] = {}
    nccl: dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
            if e.get("args", {}).get("correlation") in inside:
                nccl[e["name"]] = nccl.get(e["name"], 0) + 1
    return counts, nccl


def _opt_state_bytes(ckpt: Path) -> int:
    """Bytes of a checkpoint's optimizer state (the arrays, count aside)."""
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    def walk(tree) -> int:
        if isinstance(tree, dict):
            return sum(walk(v) for v in tree.values())
        return int(tree.nbytes) if getattr(tree, "ndim", 0) else 0

    return walk(CheckpointManager.load(ckpt)["opt_state"])


def _ddp_train(torch, smi: str, tmp: Path, layers: int, eval_batches: int) -> dict:
    """18(a)."""
    import logging
    import os

    import torch.distributed as dist

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.training.trainer import Trainer

    # The plain run: the same config without the group, the EMA and the
    # profiler, through the trainer alone (no run dir, no checkpoint).
    messages: list[str] = []

    class _Capture(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    capture, logger = _Capture(), logging.getLogger("llmtrain")
    level = logger.level
    logger.addHandler(capture)
    logger.setLevel(logging.INFO)
    try:
        cfg, _, _ = load_and_validate_config(_ddp_config(tmp, "ddp_plain", steps=DDP_STEPS))
        result = Trainer(cfg, None).fit()
    finally:
        logger.removeHandler(capture)
        logger.setLevel(level)
    plain = dict(final_val_loss=result.final_val_loss, peak_memory=result.peak_memory)
    plain_steps = _parse_steps(messages)
    torch.cuda.empty_cache()

    cfg_path = _ddp_config(tmp, "ddp", steps=DDP_STEPS, distributed=True, ema_decay=DDP_EMA,
                           profile_start_step=DDP_PROFILE[0], profile_num_steps=DDP_PROFILE[1])
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(_free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    backends: list[str] = []
    destroy = dist.destroy_process_group

    def recording_destroy(*args, **kwargs):
        backends.append(str(dist.get_backend()))
        return destroy(*args, **kwargs)

    os.environ.update(env)
    dist.destroy_process_group = recording_destroy
    _reset_counts()  # the one-rank NCCL path's counts start here
    try:
        t0 = time.perf_counter()
        with _ExactLosses() as exact:  # phase 22(c) holds ZeRO's losses to these bits
            code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "ddp",
                                  "--json"])
        wall = time.perf_counter() - t0
        counts = _read_counts()  # and end here
    finally:
        dist.destroy_process_group = destroy
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if code != 0:
        raise RuntimeError(f"the one-rank NCCL train exited {code}")
    if dist.is_initialized():
        raise RuntimeError("train left its process group behind")
    summary = json.loads(out)["train_result"]
    run_dir = tmp / "runs" / "ddp"
    steps = _logged_steps(run_dir)
    diffs = [abs(steps[i]["loss"] - plain_steps[i]["loss"]) for i in sorted(plain_steps)]
    losses = " ".join(f"{steps[i]['loss']:.4f}" for i in sorted(steps))
    log(f"[ddp] one-rank job over {backends}: {DDP_STEPS} steps in {wall:.1f} s (command wall, "
        f"rendezvous, data setup and the profiler included); losses {losses}; against the "
        f"plain run "
        f"max |diff| {max(diffs):.3e} (atol {DDP_ATOL}), final val {summary['final_val_loss']!r} "
        f"vs {plain['final_val_loss']!r}")
    if backends != [DDP_BACKEND]:
        raise RuntimeError(f"the one-rank job's process group was {backends}, not {DDP_BACKEND}")
    if len(steps) != DDP_STEPS or max(diffs) > DDP_ATOL:
        raise RuntimeError("the one-rank NCCL run does not follow the plain run")
    _check_counts("ddp-train", counts, {
        "flash_attention_fwd": layers * (DDP_STEPS + eval_batches),
        "flash_attention_bwd_dq": layers * DDP_STEPS,
        "flash_attention_bwd_dkdv": layers * DDP_STEPS,
    })
    traces = sorted((run_dir / "logs" / "profile").glob("*.json"))
    if len(traces) != 1:
        raise RuntimeError(f"the step profiler wrote {traces}, not one trace")
    kernels, nccl = _trace_kernels(traces[0])
    flash = {k: v for k, v in kernels.items() if "flash_" in k}
    named = {k: v for k, v in kernels.items() if "nccl" in k.lower() or "onerank" in k.lower()}
    log(f"[ddp] profiler trace {traces[0].name} ({traces[0].stat().st_size} bytes): kernels "
        f"launched inside nccl:all_reduce {nccl}; kernels named nccl {named}; flash kernels "
        f"{sum(flash.values())} launches over {len(flash)} names; {sum(kernels.values())} "
        f"kernel launches in all")
    if not nccl or not flash:
        raise RuntimeError("the profile window's trace lacks the NCCL all-reduce kernel or the "
                           "flash kernels")
    # The profiled steps and the one after them (the trace's export) are
    # left out of both runs' medians.
    window = range(DDP_PROFILE[0], sum(DDP_PROFILE) + 1)
    one, base = _steady(steps, skip=window), _steady(plain_steps, skip=window)
    log(f"[ddp] steady state on {smi} (median of steps 2-{DDP_STEPS - 1} but "
        f"{window.start}-{window.stop - 1}): one-rank NCCL step {one['step_time'] * 1e3:.1f} ms, "
        f"{one['tokens_per_sec']:.0f} tokens/s, MFU {one['mfu']:.4f}, peak memory "
        f"{summary['peak_memory'] / 2**30:.2f} GiB; plain step {base['step_time'] * 1e3:.1f} ms, "
        f"{base['tokens_per_sec']:.0f} tokens/s, MFU {base['mfu']:.4f}, peak memory "
        f"{plain['peak_memory'] / 2**30:.2f} GiB")
    return dict(cfg_path=cfg_path, plain_cfg=tmp / "ddp_plain.yaml", run_dir=run_dir,
                counts=counts, summary=summary, one=one, base=base, plain=plain,
                exact_losses=exact.losses, layers=layers, eval_batches=eval_batches)


def _ddp_ema(torch, smi: str, tmp: Path, ddp: dict, layers: int, eval_batches: int) -> dict:
    """18(b)."""
    cfg_path, run_dir = ddp["cfg_path"], ddp["run_dir"]
    raw = ddp["summary"]["final_val_loss"]  # the trainer's own eval of the final params
    _reset_counts()
    ema = _eval_cli(cfg_path, run_dir, "--ema")
    exported, imported = tmp / "ema_export.pt", tmp / "ema_imported"
    code, _ = _run_cli(["export-checkpoint", "--config", str(cfg_path), "--from", str(run_dir),
                        "--output", str(exported), "--ema", "--json"])
    if code != 0:
        raise RuntimeError(f"export-checkpoint --ema exited {code}")
    # Imported under the plain config: the shadow becomes the params.
    plain_cfg = ddp["plain_cfg"]
    code, _ = _run_cli(["import-checkpoint", "--config", str(plain_cfg), "--input",
                        str(exported), "--output", str(imported), "--json"])
    if code != 0:
        raise RuntimeError(f"import-checkpoint of the EMA export exited {code}")
    round_trip = _eval_cli(plain_cfg, imported)
    counts = _read_counts()
    log(f"[ema] eval at step {DDP_STEPS}: the trainer's {raw!r}, --ema {ema!r} (decay "
        f"{DDP_EMA}); export --ema -> import -> eval {round_trip!r}")
    if ema == raw or round_trip != ema:
        raise RuntimeError("eval --ema equals the raw eval, or the EMA export round trip is not "
                           "bit-identical")
    _check_counts("ema-eval", counts, {"flash_attention_fwd": 2 * layers * eval_batches})
    code, out = _run_cli(["generate", "--config", str(cfg_path), "--from", str(run_dir), "--ema",
                          "--prompt", "def ", "--max-new-tokens", "16", "--temperature", "0",
                          "--json"])
    if code != 0:
        raise RuntimeError(f"generate --ema exited {code}")
    ids = json.loads(out)["completion_ids"]
    log(f"[ema] generate --ema, greedy 'def ' + 16: {ids}")
    if len(ids) != 16 or not all(0 <= i < 256 for i in ids):
        raise RuntimeError(f"generate --ema returned {ids}")
    return dict(raw=raw, ema=ema, counts=counts)


def _ddp_optimizers(torch, smi: str, tmp: Path, ddp: dict) -> dict:
    """18(c): AdamW runs too, at the same length and schedule, so that the
    three step medians cover the same steps of runs alike."""
    import yaml

    out_rows = {}
    adamw_bytes = None
    for name in ("adamw", "adafactor", "lion"):
        cfg_path = _ddp_config(tmp, f"opt_{name}", steps=OPT_STEPS, warmup=OPT_WARMUP,
                               optimizer=name)
        raw = yaml.safe_load(cfg_path.read_text())
        raw["model"]["n_layers"] = OPT_LAYERS
        cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
        code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", f"opt_{name}",
                              "--json"])
        if code != 0:
            raise RuntimeError(f"train with optimizer {name} exited {code}")
        summary = json.loads(out)["train_result"]
        if adamw_bytes is None:
            adamw_bytes = 2 * summary["parameter_count"] * 4  # the AdamW run's mu and nu
        run_dir = tmp / "runs" / f"opt_{name}"
        steps = _logged_steps(run_dir)
        losses = [steps[i]["loss"] for i in sorted(steps)]
        state = _opt_state_bytes(run_dir / "checkpoints" / f"step_{OPT_STEPS:06d}.ckpt")
        step_ms = _steady(steps)["step_time"] * 1e3
        against = ""
        if name != "adamw":
            adamw = out_rows["adamw"]
            against = (f"; against AdamW {step_ms - adamw['step_ms']:+.1f} ms, "
                       f"{(summary['peak_memory'] - adamw['peak_memory']) / 2**30:+.2f} GiB")
        log(f"[optim] {name}: losses {' '.join(f'{x:.4f}' for x in losses)}; state {state} bytes "
            f"({state / adamw_bytes:.4f} of AdamW's {adamw_bytes}); step {step_ms:.1f} ms "
            f"(median of steps 2-{OPT_STEPS - 1}); peak memory "
            f"{summary['peak_memory'] / 2**30:.2f} GiB{against} on {smi}")
        if len(losses) != OPT_STEPS or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{name}: losses are not finite: {losses}")
        if name != "adamw" and not losses[-1] < losses[0]:
            raise RuntimeError(f"{name}: losses are not falling: {losses}")
        out_rows[name] = dict(state_bytes=state, step_ms=step_ms,
                              peak_memory=summary["peak_memory"])
    return out_rows


def phase_ddp(torch, smi: str, tmp: Path) -> dict:
    """Phase 18 (module doc): the one-rank NCCL job with the EMA and the
    step profiler, the EMA at inference, and Adafactor and Lion."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer

    t0 = time.perf_counter()
    probe = _smoke_config(tmp, "ddp_probe")
    cfg, _, _ = load_and_validate_config(probe)
    dm = LocalTextDataModule()
    dm.setup(cfg, ByteTokenizer())  # the token cache every run of the phase reads
    eval_batches = -(-len(dm.val_dataset()) // cfg.trainer.micro_batch_size)
    layers = cfg.model.n_layers
    ddp = _ddp_train(torch, smi, tmp, layers, eval_batches)
    ema = _ddp_ema(torch, smi, tmp, ddp, layers, eval_batches)
    optim = _ddp_optimizers(torch, smi, tmp, ddp)
    seconds = time.perf_counter() - t0
    log(f"[ddp] phase 18 in {seconds:.1f} s on {smi}")
    return dict(counts={k: ddp["counts"][k] + ema["counts"][k] for k in ddp["counts"]},
                ddp=ddp, ema=ema, optim=optim, seconds=seconds)


# ---------------------------------------------------------------- telemetry
# Phase 19. The train families every run's metrics.prom must carry.
TEL_FAMILIES = ("llmtrain_train_loss", "llmtrain_train_mfu", "llmtrain_train_tokens_per_sec",
                "llmtrain_train_step_time_sec", "llmtrain_mem_hbm_peak", "llmtrain_run_info")
TEL_FILES = ("report.json", "report.md", "telemetry/timeline.jsonl", "telemetry/trace.json",
             "telemetry/metrics.prom")
# The memory monitor and the summary read the same allocator counter; the
# monitor samples again at the end of the run, after the last eval.
TEL_PEAK_RTOL = 0.01
# Share of the logged step times (phase 9, every step logged) the ledger's
# productive, data-wait, checkpoint and eval seconds must cover: what is
# left is each log boundary's host work (registry flush, memory sample,
# JSONL append, textfile write), a few ms of a 150 ms step.
GOODPUT_COVERED = 0.9
PROFILE_STEPS = 3
TEL_STEPS = 12  # 20 until phase 21 came (PERF.md §2)
# Telemetry off, then on (off, on, on, off until phase 24 came; PERF.md §2).
TEL_ARMS = (False, True)


def _boundary_walls(run_dir: Path, first: int, last: int) -> float:
    """Mean wall seconds a step from the train.log stamps of the step
    lines ``first`` and ``last``: unlike the logged step time, it holds
    each log boundary's own work (the flush to the tracker, the memory
    sample, the files)."""
    from datetime import datetime

    stamps = {}
    for line in (run_dir / "logs" / "train.log").read_text().splitlines():
        record = json.loads(line)
        step = _parse_steps([record["message"]])
        if step:
            stamps[next(iter(step))] = datetime.fromisoformat(record["timestamp"])
    return (stamps[last] - stamps[first]).total_seconds() / (last - first)


def _telemetry_config(tmp: Path, name: str, *, enabled: bool) -> Path:
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["trainer"].update(max_steps=TEL_STEPS, save_every_steps=TEL_STEPS,
                          eval_every_steps=TEL_STEPS)
    raw["telemetry"] = {"enabled": enabled}
    if enabled:
        raw["mlflow"] = {"enabled": True, "backend": "native",
                         "tracking_uri": f"sqlite:///{tmp / 'tracking.db'}"}
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def phase_telemetry(torch, smi: str, tmp: Path, train: dict, ce: dict) -> dict:
    """Phase 19 (module doc): the run files of phase 9, the goodput ledger,
    the profile command, the CE run's cost count, and telemetry's cost on
    the training step."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.telemetry import profiling
    from llmtrain_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    # (a) phase 9's run files.
    run_dir, summary = train["run_dir"], train["summary"]
    missing = [f for f in TEL_FILES if not (run_dir / f).is_file()]
    if missing:
        raise RuntimeError(f"phase 9's run dir lacks {missing}")
    report = json.loads((run_dir / "report.json").read_text())
    mem = report["memory"]
    peak_gap = abs(mem["hbm_peak_bytes"] - summary["peak_memory"]) / summary["peak_memory"]
    prom = (run_dir / "telemetry" / "metrics.prom").read_text()
    absent = [f for f in TEL_FAMILIES if f not in prom]
    log(f"[telemetry] phase 9's run files {', '.join(TEL_FILES)}: report final loss "
        f"{report['train_result']['final_loss']:.6f} (summary {summary['final_loss']:.6f}, "
        f"last logged {report['loss']['final']:.6f}); memory monitor peak "
        f"{mem['hbm_peak_bytes'] / 2**30:.3f} GiB from {mem['source']} against the summary's "
        f"{summary['peak_memory'] / 2**30:.3f} GiB ({peak_gap:.2%}); host RSS peak "
        f"{mem['host_rss_peak_bytes'] / 2**30:.2f} GiB; opt state "
        f"{mem.get('opt_state_bytes', 0) / 2**30:.3f} GiB; metrics.prom families missing: "
        f"{absent or 'none'}")
    if report["train_result"]["final_loss"] != summary["final_loss"] \
            or abs(report["loss"]["final"] - summary["final_loss"]) > 1e-6:
        raise RuntimeError("report.json's final loss is not the summary's")
    if mem["source"] != "memory_stats" or peak_gap > TEL_PEAK_RTOL:
        raise RuntimeError(f"memory monitor: source {mem['source']}, peak off by {peak_gap:.2%}")
    if absent:
        raise RuntimeError(f"metrics.prom lacks {absent}")
    perf = report["perf_attribution"]
    log(f"[telemetry] phase 9's attribution: {perf['executables'][0]['flops']:.4g} flops, "
        f"{perf['executables'][0]['bytes_accessed']:.4g} bytes a step, counted in "
        f"{perf['executables'][0]['lower_time_s']:.2f} s; MFU {perf['mfu']}")

    # (b) the goodput ledger, read back by the command.
    code, out = _run_cli(["goodput", "--run-dir", str(run_dir), "--json"])
    if code != 0:
        raise RuntimeError(f"goodput exited {code}")
    ledger = json.loads(out)
    cats = ledger["categories"]
    logged = sum(x["step_time"] for x in train["steps"].values())
    covered = sum(cats[c] for c in ("productive_train", "data_wait", "checkpoint", "eval"))
    log(f"[goodput] phase 9: wall {ledger['wall_clock_sec']} s, goodput_frac "
        f"{ledger['goodput_frac']}, balance error {ledger['balance_error_sec']} s; categories "
        + ", ".join(f"{k} {v}" for k, v in cats.items())
        + f"; logged step times summed {logged:.3f} s, productive + data wait + checkpoint + "
        f"eval {covered:.3f} s ({covered / logged:.1%})")
    if ledger["balance_error_sec"] != 0.0 \
            or abs(sum(cats.values()) - ledger["wall_clock_sec"]) > 0.01:
        raise RuntimeError("the goodput categories do not sum to the wall")
    if ledger["num_segments"] != 1 or not covered >= GOODPUT_COVERED * logged \
            or cats["productive_train"] > logged:
        raise RuntimeError("the goodput ledger does not account for the logged steps")

    # (c) the profile command on phase 9's config, its warmup cut to the
    # probe's steps (a schedule's warmup may not outlast its steps).
    import yaml

    raw = yaml.safe_load(Path(train["cfg_path"]).read_text())
    raw["trainer"]["warmup_steps"] = min(raw["trainer"]["warmup_steps"], PROFILE_STEPS)
    profile_cfg = tmp / "gpt_pycorpus_profile.yaml"
    profile_cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out_path = tmp / "profile_report.json"
    _reset_counts()  # the profile command's counts start here
    t0 = time.perf_counter()
    code, _ = _run_cli(["profile", "--config", str(profile_cfg), "--steps",
                        str(PROFILE_STEPS), "--serve", "--output", str(out_path)])
    profile_s = time.perf_counter() - t0
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"profile exited {code}")
    cfg, _, _ = load_and_validate_config(train["cfg_path"])
    layers = cfg.model.n_layers
    _check_counts("profile", counts, {
        "flash_attention_fwd": layers * (PROFILE_STEPS + train["eval_batches"]),
        "flash_attention_bwd_dq": layers * PROFILE_STEPS,
        "flash_attention_bwd_dkdv": layers * PROFILE_STEPS,
    })
    prof = json.loads(out_path.read_text())
    exes = {e["name"]: e for e in prof["executables"]}
    rows = {r["op"]: r for r in exes["train_step"]["top_ops"]}
    mfu = prof["perf_attribution"]["mfu"]
    log(f"[profile] `profile --steps {PROFILE_STEPS} --serve` in {profile_s:.1f} s on {smi}: "
        f"probe step {prof['probe']['step_time_ms']} ms; executables "
        + ", ".join(f"{n} {e['flops']:.4g} flops {e['bytes_accessed']:.4g} bytes "
                    f"({e['roofline']['class']}, counted in {e['lower_time_s']:.2f} s)"
                    for n, e in exes.items())
        + f"; MFU {mfu}")
    for row in exes["train_step"]["top_ops"]:
        log(f"[profile]   {row['op']:28s} x{row['count']:5d} {row['flops']:.4g} flops "
            f"{row['bytes_accessed']:.4g} bytes ({row['flops_frac']:.1%} / "
            f"{row['bytes_frac']:.1%}, {row['class']})")
    flash = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkdv")
    if any(rows.get(k, {}).get("count") != layers for k in flash):
        raise RuntimeError(f"the train step's top_ops lack the flash kernels at {layers} each")
    if not mfu["analytical"] <= 1.0 or mfu.get("reconciled") is not True:
        raise RuntimeError(f"the profile's MFU block is off: {mfu}")
    serve = [n for n in exes if n.startswith(("prefill_T", "decode_B"))]
    if len(serve) != 2:
        raise RuntimeError(f"the serving counts are missing: {list(exes)}")

    # (d) the cost count of phase 12's CE run, from its run dir.
    ce_dir = Path(cfg.output.root_dir) / "ce"
    ce_cfg, _, _ = load_and_validate_config(ce_dir / "config.yaml")
    trainer = Trainer(ce_cfg, None)
    peaks = profiling.resolve_peaks(trainer.device_kind(), ce_cfg.telemetry.device_peaks)
    t0 = time.perf_counter()
    ce_prof = trainer.train_step_profile(peaks=peaks, full=True)
    count_s = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()
    if ce_prof is None:
        raise RuntimeError("the CE step's cost count failed")
    ce_rows = {r["op"]: r for r in ce_prof["top_ops"]}
    ce_report = json.loads((ce_dir / "report.json").read_text())
    ce_flops = ce_report["perf_attribution"]["executables"][0]["flops"]
    log(f"[profile] phase 12's CE step counted in {count_s:.2f} s: {ce_prof['flops']:.4g} flops "
        f"(the run's report {ce_flops:.4g}), {ce_prof['bytes_accessed']:.4g} bytes; "
        + ", ".join(f"{k} x{ce_rows[k]['count']} {ce_rows[k]['flops']:.4g} flops"
                    for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")
                    if k in ce_rows))
    if any(ce_rows.get(k, {}).get("count") != 1
           for k in ("fused_ce_fwd", "fused_ce_bwd_dh", "fused_ce_bwd_dw")):
        raise RuntimeError("the CE step's top_ops lack the fused-CE kernels")
    if ce_prof["flops"] != ce_flops:
        raise RuntimeError("the CE step's count differs from its run's attribution")

    # (e) telemetry's cost on the step, paired.
    runs, walls = {}, {}
    _reset_counts()  # the telemetry on/off path's counts start here
    for i, enabled in enumerate(TEL_ARMS):
        name = f"tel_{'on' if enabled else 'off'}_{i}"
        path = _telemetry_config(tmp, name, enabled=enabled)
        code, out = _run_cli(["train", "--config", str(path), "--run-id", name, "--json"])
        if code != 0:
            raise RuntimeError(f"{name} train exited {code}")
        steps = _logged_steps(Path(cfg.output.root_dir) / name)
        runs[name] = [steps[j]["step_time"] * 1e3 for j in sorted(steps) if j > 5]
        # Steps 6-19 by the log's clock: step 20 also saves the checkpoint.
        walls[name] = _boundary_walls(Path(cfg.output.root_dir) / name, 5, TEL_STEPS - 1) * 1e3
        wrote = (Path(cfg.output.root_dir) / name / "report.json").is_file()
        if wrote != enabled:
            raise RuntimeError(f"{name}: report.json written {wrote}, telemetry {enabled}")
    tel_counts = _read_counts()  # and end here
    _check_counts("telemetry on/off", tel_counts, {
        "flash_attention_fwd": len(TEL_ARMS) * layers * (TEL_STEPS + train["eval_batches"]),
        "flash_attention_bwd_dq": len(TEL_ARMS) * layers * TEL_STEPS,
        "flash_attention_bwd_dkdv": len(TEL_ARMS) * layers * TEL_STEPS,
    })
    for name, ms in runs.items():
        log(f"[telemetry] {name}: step median {np.median(ms):.2f} ms over steps 6-{TEL_STEPS} "
            f"(min {min(ms):.2f}, max {max(ms):.2f}); by the log's clock, log boundary "
            f"included, {walls[name]:.2f} ms a step over steps 6-{TEL_STEPS - 1}")
    arms = {arm: [x for n, ms in runs.items() if f"_{arm}_" in n for x in ms]
            for arm in ("off", "on")}
    med = {arm: float(np.median(v)) for arm, v in arms.items()}
    wall = {arm: float(np.mean([w for n, w in walls.items() if f"_{arm}_" in n]))
            for arm in ("off", "on")}
    log(f"[telemetry] on {smi}: telemetry off {med['off']:.2f} ms, on + native tracker "
        f"{med['on']:.2f} ms a step (medians of {len(arms['off'])} and {len(arms['on'])} "
        f"steps; on - off {med['on'] - med['off']:+.2f} ms); with the log boundary "
        f"{wall['off']:.2f} against {wall['on']:.2f} ms ({wall['on'] - wall['off']:+.2f} ms)")
    seconds = time.perf_counter() - t_phase
    log(f"[telemetry] phase 19 {seconds:.1f} s")
    return dict(counts={k: counts[k] + tel_counts[k] for k in counts}, ledger=ledger,
                medians=med, walls=wall, seconds=seconds)


# ------------------------------------------------ resilience (phase 20)
# (a) phase 9's config cut to RES_STEPS steps with the guard, a NaN window
# of one step (RES_NAN_AT) inside the first interval, a 100x spike of the
# observed loss at RES_SPIKE_AT, saves every RES_SAVE_EVERY (the spike's
# restore point is the save before it) and one rollback allowed.
RES_STEPS = 16
RES_NAN_AT = 2
RES_SPIKE_AT = 10
RES_SAVE_EVERY = 8
RES_MIN_HISTORY = 4
# (b) a `train` child hung at step WD_HANG_AT with a stall timeout no eval
# or save of its config reaches (a step takes ~0.15 s, a save's gather
# ~1 s); the exit must come within WD_STALL_SEC + WD_EXIT_SLACK_SEC.
WD_STEPS = 6
WD_HANG_AT = 3
WD_STALL_SEC = 10.0
WD_EXIT_SLACK_SEC = 30.0
# (c) the chaos drill: CHAOS_CYCLES killed `train` segments over
# CHAOS_STEPS steps saved every CHAOS_SAVE_EVERY, each segment a fresh
# process on the card; at full width, the depth cut to CHAOS_LAYERS (the
# segments' saves, loads and the final bitwise comparison scale with it:
# 12 layers took 119.5 s of the 1200 s limit, PR 14 call 25).
CHAOS_CYCLES = 2
CHAOS_LAYERS = 2  # 4 until phase 23 came (PERF.md §2)
CHAOS_STEPS = 8
CHAOS_SAVE_EVERY = 4
CHAOS_SEED = 1


def _resilience_config(tmp: Path, name: str, steps: int, **resilience) -> Path:
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["trainer"].update(max_steps=steps, warmup_steps=min(TRAIN_WARMUP, steps),
                          save_every_steps=steps, eval_every_steps=steps)
    raw["resilience"] = resilience
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _timeline(run_dir: Path) -> list[dict]:
    return [json.loads(line) for line in
            (run_dir / "telemetry" / "timeline.jsonl").read_text().splitlines()]


def _resilience_rollback(torch, smi: str, tmp: Path, train: dict) -> dict:
    """(a) the guard and the spike rollback, in-process through `train`."""
    import numpy as np
    import yaml

    from llmtrain_tpu_torch.config import load_and_validate_config

    cfg_path = _resilience_config(
        tmp, "resilience_rollback", RES_STEPS, nonfinite_guard=True, spike_detection=True,
        spike_min_history=RES_MIN_HISTORY, max_rollbacks=1,
        faults={"nan_loss_at_step": RES_NAN_AT, "nan_loss_steps": 1,
                "spike_loss_at_step": RES_SPIKE_AT, "spike_loss_scale": 100.0})
    raw = yaml.safe_load(cfg_path.read_text())
    raw["trainer"]["save_every_steps"] = RES_SAVE_EVERY
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    cfg, _, _ = load_and_validate_config(cfg_path)
    restored_at = (RES_SPIKE_AT - 1) // RES_SAVE_EVERY * RES_SAVE_EVERY
    replayed = RES_SPIKE_AT - restored_at
    _reset_counts()  # the guarded training path's counts start here
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "resilient", "--json"])
    counts = _read_counts()  # and end here
    if code != 0:
        raise RuntimeError(f"the guarded train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = Path(cfg.output.root_dir) / "resilient"
    layers = cfg.model.n_layers
    executed = RES_STEPS + replayed
    _check_counts("resilience", counts, {
        "flash_attention_fwd": layers * (executed + train["eval_batches"]),
        "flash_attention_bwd_dq": layers * executed,
        "flash_attention_bwd_dkdv": layers * executed,
    })
    events = _timeline(run_dir)
    instants = {}
    for ev in events:
        if ev.get("ph") == "i":
            instants.setdefault(ev["name"], []).append(ev)
    spans = {ev["name"] for ev in events if ev.get("ph") != "i"}
    skipped = sum(ev["args"]["skipped"] for ev in instants.get("nonfinite_skip", []))
    rollbacks = instants.get("rollback", [])
    tagged = sum(1 for ev in events if ev.get("rolled_back"))
    steps = _logged_steps(run_dir)
    losses = [steps[i]["loss"] for i in sorted(steps)]
    finite = [x for x in losses if math.isfinite(x)]
    log(f"[resilience] guarded run of {RES_STEPS} steps ({executed} executed): nonfinite "
        f"skips {skipped} (window 1 at step {RES_NAN_AT}); rollbacks "
        f"{[ev['args'] for ev in rollbacks]} at step {[ev['step'] for ev in rollbacks]}; "
        f"fault instants {sorted(k for k in instants if k.startswith('fault_'))}; "
        f"{tagged} events tagged rolled_back; losses {' '.join(f'{x:.4f}' for x in losses)}")
    if skipped != 1 or summary["rollbacks"] != 1 or len(rollbacks) != 1 \
            or rollbacks[0]["args"]["restored_step"] != restored_at:
        raise RuntimeError("the guard or the rollback did not act as configured")
    if {"rollback_restore", "checkpoint_wait"} - spans or not tagged:
        raise RuntimeError(f"the timeline lacks the rollback's spans or tags: {sorted(spans)}")
    if len(finite) != RES_STEPS - 1 or not math.isfinite(summary["final_loss"]) \
            or not finite[-1] <= finite[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"the guarded run's losses are not finite and falling: {losses}")
    code, out = _run_cli(["goodput", "--run-dir", str(run_dir), "--json"])
    ledger = json.loads(out) if code == 0 else {}
    if code != 0 or ledger["balance_error_sec"] != 0.0 \
            or abs(sum(ledger["categories"].values()) - ledger["wall_clock_sec"]) > 0.01:
        raise RuntimeError(f"the guarded run's goodput ledger does not balance ({code})")
    guarded_ms = float(np.median([steps[i]["step_time"] for i in sorted(steps) if i > 5])) * 1e3
    plain_ms = float(np.median([train["steps"][i]["step_time"] for i in sorted(steps)
                                if i > 5])) * 1e3
    log(f"[resilience] on {smi}: guarded step median {guarded_ms:.1f} ms over steps 6-"
        f"{RES_STEPS} against phase 9's {plain_ms:.1f} ms over the same steps; ledger "
        f"goodput_frac {ledger['goodput_frac']}, recomputed {ledger['categories']['recomputed']} s, "
        f"checkpoint {ledger['categories']['checkpoint']} s")
    return dict(counts=counts, guarded_ms=guarded_ms, plain_ms=plain_ms)


def _start_watchdog_child(tmp: Path) -> dict:
    """(b), started: a `train` child that hangs at WD_HANG_AT. It runs
    beside (c)'s children; a thread waits for it and reads its heartbeat's
    age the moment it exits (:func:`_resilience_watchdog` checks them)."""
    from llmtrain_tpu_torch.config import load_and_validate_config

    cfg_path = _resilience_config(
        tmp, "resilience_hang", WD_STEPS,
        watchdog={"enabled": True, "stall_timeout_sec": WD_STALL_SEC},
        faults={"hang_at_step": WD_HANG_AT})
    cfg, _, _ = load_and_validate_config(cfg_path)
    run_dir = Path(cfg.output.root_dir) / "hung"
    child = dict(run_dir=run_dir, t0=time.perf_counter())
    child["proc"] = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "train", "--config", str(cfg_path),
         "--run-id", "hung"], cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def wait() -> None:
        try:
            child["stderr"] = child["proc"].communicate(timeout=600)[1]
        except subprocess.TimeoutExpired:
            child["proc"].kill()
            child["stderr"] = child["proc"].communicate()[1]
        child["wall"] = time.perf_counter() - child["t0"]
        hb = run_dir / "heartbeat"
        child["hb_age"] = time.time() - hb.stat().st_mtime if hb.is_file() else None

    child["waiter"] = threading.Thread(target=wait, daemon=True)
    child["waiter"].start()
    return child


def _resilience_watchdog(child: dict) -> dict:
    """(b) the hung `train` child: exit 76 with a hang report and a fresh
    heartbeat."""
    child["waiter"].join()
    proc, stderr, wall, hb_age = child["proc"], child["stderr"], child["wall"], child["hb_age"]
    run_dir = child["run_dir"]
    reports = sorted(run_dir.glob("hang_report_*_p0.txt"))
    text = reports[0].read_text() if reports else ""
    armed = [json.loads(line)["timestamp"] for line in
             (run_dir / "logs" / "train.log").read_text().splitlines()
             if "hang watchdog armed" in line]
    log(f"[watchdog] `train` hung at step {WD_HANG_AT}, stall_timeout_sec {WD_STALL_SEC}: exit "
        f"{proc.returncode} after {wall:.1f} s of child wall (start-up included); report "
        f"{reports[0].name if reports else None} ({len(text)} bytes); heartbeat age "
        f"{hb_age if hb_age is None else round(hb_age, 1)} s; armed at {armed}")
    device = text[text.find("== device diagnostics =="):]
    log("[watchdog] report's device section: " + " | ".join(device.splitlines()[1:4]))
    if proc.returncode != 76 or "HANG DETECTED" not in stderr:
        raise RuntimeError(f"the hung child exited {proc.returncode}: {stderr[-2000:]}")
    if "== thread stacks ==" not in text or "allocated_bytes current=" not in device \
            or "nvidia-smi" not in device:
        raise RuntimeError("the hang report lacks the thread stacks or the device section")
    if hb_age is None or hb_age > WD_STALL_SEC + WD_EXIT_SLACK_SEC or not armed:
        raise RuntimeError(f"no fresh heartbeat (age {hb_age}) or the watchdog never armed")
    return dict(wall=wall)


def _resilience_chaos(tmp: Path) -> dict:
    """(c) `chaos` on phase 9's config cut to CHAOS_STEPS steps and
    CHAOS_LAYERS layers."""
    import yaml

    cfg_path = _resilience_config(tmp, "resilience_chaos", CHAOS_STEPS)
    raw = yaml.safe_load(cfg_path.read_text())
    raw["model"]["n_layers"] = CHAOS_LAYERS
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    t0 = time.perf_counter()
    code, out = _run_cli(["chaos", "--config", str(cfg_path), "--cycles", str(CHAOS_CYCLES),
                          "--seed", str(CHAOS_SEED), "--save-every", str(CHAOS_SAVE_EVERY),
                          "--work-dir", str(tmp / "chaos"), "--timeout-sec", "400", "--json"])
    wall = time.perf_counter() - t0
    if code != 0:
        raise RuntimeError(f"chaos exited {code}")
    result = json.loads(out.strip().splitlines()[-1])
    log(f"[chaos] {CHAOS_CYCLES} cycles, seed {CHAOS_SEED}, {CHAOS_LAYERS} layers of "
        f"{raw['model']['d_model']}, "
        f"{CHAOS_STEPS} steps saved every {CHAOS_SAVE_EVERY}, in {wall:.1f} s: cycles "
        + "; ".join(f"{c['mode']} at {c['kill_step']} (exit {c['returncode']}, newest commit "
                    f"{c.get('newest_committed_step')}, resumed from "
                    f"{c.get('resumed_from_observed')})" for c in result["cycles"])
        + f"; {result['trajectory_points_compared']} trajectory points, final loss "
        f"{result['final_loss']!r} against {result['reference_final_loss']!r}; goodput_frac "
        f"{(result.get('goodput') or {}).get('goodput_frac')}")
    if not result["bitwise_match"] or result["kills_delivered"] < CHAOS_CYCLES \
            or result["kill_during_checkpoint_cycles"] < 1 \
            or any("newest_committed_step" not in c for c in result["cycles"]):
        raise RuntimeError(f"the chaos drill did not prove its invariants: {result}")
    return dict(wall=wall, result=result)


def _resilience_saves(torch, smi: str, train: dict) -> dict:
    """(d) phase 9's checkpoint cost: its `checkpoint_save` spans (the
    gather alone since asynchronous writes) and its ledger's checkpoint
    seconds. Measurement only. (One full-width state gathered and written
    synchronously, measured here until phase 24 came, PERF.md §2.)"""
    events = _timeline(train["run_dir"])
    saves = [ev["dur_us"] / 1e6 for ev in events if ev.get("name") == "checkpoint_save"]
    code, out = _run_cli(["goodput", "--run-dir", str(train["run_dir"]), "--json"])
    ledger_ckpt = json.loads(out)["categories"]["checkpoint"] if code == 0 else None
    log(f"[saves] phase 9 on {smi}: checkpoint_save spans {[round(s, 3) for s in saves]} s "
        f"(the gather; the write runs on the writer thread); ledger checkpoint {ledger_ckpt} s")
    return dict(spans=saves, ledger=ledger_ckpt)


def phase_resilience(torch, smi: str, tmp: Path, train: dict, beside=None) -> dict:
    """Phase 20 (module doc): the guard and the spike rollback, the hang
    watchdog, the chaos drill, and the checkpoint's cost. ``beside`` starts
    another phase's child process to run beside (b)-(c)'s children; what it
    returns is the result's ``beside``."""
    t_phase = time.perf_counter()
    rollback = _resilience_rollback(torch, smi, tmp, train)
    torch.cuda.empty_cache()
    _reset_counts()  # (b)-(c) run in child processes: none here
    started = beside() if beside is not None else None
    # The hung child waits out its stall beside the chaos drill's children.
    hung = _start_watchdog_child(tmp)
    try:
        chaos = _resilience_chaos(tmp)
    finally:
        watchdog = _resilience_watchdog(hung)
    _check_counts("resilience children", _read_counts(), {})
    saves = _resilience_saves(torch, smi, train)
    seconds = time.perf_counter() - t_phase
    log(f"[resilience] phase 20 {seconds:.1f} s (watchdog child {watchdog['wall']:.1f} s, chaos "
        f"{chaos['wall']:.1f} s)")
    return dict(counts=rollback["counts"], rollback=rollback, watchdog=watchdog, chaos=chaos,
                saves=saves, seconds=seconds, beside=started)


# ------------------------------------------------------ model zoo (phase 21)
# Phase 21: the llama family on the card. (a) llama_pycorpus_tpu at full
# width, ZOO_LLAMA_LAYERS deep (768 wide, 12 query heads over 4 KV heads,
# SwiGLU d_ff 2048, byte vocab, flash), ZOO_STEPS steps with one eval and a save
# at the end; (b) from its checkpoint `generate` past block_size (the
# re-forward branch), ZOO_REQUESTS requests of `serve-bench
# --verify-parity`, export to HF names -> import -> eval; (c) Qwen2 and
# Gemma at full width and ZOO_SMALL_LAYERS layers, ZOO_SMALL_STEPS steps
# each, and a greedy `generate`; (d) the Mixtral layout (llama_moe, top-2
# of 4 experts, capacity factor 2, window ZOO_WINDOW) at ZOO_SMALL_LAYERS
# layers, ZOO_MOE_STEPS steps; (e) gpt_lora_ft at full width,
# ZOO_LORA_STEPS steps: the base bit-identical, every factor B moved, the
# merged export generating.
ZOO_STEPS = 16
ZOO_LLAMA_LAYERS = 6  # the cell's 12 until phase 26 came (PERF.md §2)
ZOO_WARMUP = 4
ZOO_SMALL_LAYERS = 4
ZOO_SMALL_STEPS = 4
ZOO_MOE_STEPS = 8
ZOO_LORA_STEPS = 6
ZOO_REQUESTS = 8  # 12 until phase 23 came (PERF.md §2)
ZOO_NEW_TOKENS = 32


def _zoo_config(tmp: Path, name: str, preset: str, *, steps: int, model: dict | None = None,
                extra: dict | None = None, warmup: int = 2) -> Path:
    """``configs/presets/{preset}.yaml`` on the card over the
    interpreter's stdlib, cut to ``steps`` steps with one eval and one save
    at the end, every step logged; ``model``/``extra`` override the
    model's fields and its ``extra``."""
    import sysconfig

    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs/presets" / f"{preset}.yaml").read_text())
    raw["run"]["device"] = "cuda"
    raw["data"]["cache_dir"] = str(tmp / "cache")
    raw["data"]["extra"]["globs"] = [sysconfig.get_paths()["stdlib"] + "/**/*.py"]
    raw["model"].update(model or {})
    raw["model"]["extra"].update(extra or {})
    raw["trainer"].update(max_steps=steps, warmup_steps=warmup, log_every_steps=1,
                          eval_every_steps=steps, save_every_steps=steps)
    raw["output"]["root_dir"] = str(tmp / "runs")
    raw.setdefault("mlflow", {})["enabled"] = False
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _zoo_train(tmp: Path, cfg_path: Path, run_id: str, *, steps: int, eval_batches: int,
               label: str) -> dict:
    """`train` in-process with the launch counts reset just before and
    read just after: every logged loss finite, and exactly one flash
    forward, dq and dk/dv per layer and step plus one forward per layer
    and eval batch, none of the other kernels."""
    from llmtrain_tpu_torch.config import load_and_validate_config

    cfg, _, _ = load_and_validate_config(cfg_path)
    layers = cfg.model.n_layers
    _reset_counts()
    t0 = time.perf_counter()
    code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", run_id, "--json"])
    wall = time.perf_counter() - t0
    counts = _read_counts()
    if code != 0:
        raise RuntimeError(f"{label}: train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = tmp / "runs" / run_id
    steps_log = _logged_steps(run_dir)
    losses = [steps_log[i]["loss"] for i in sorted(steps_log)]
    log(f"[zoo] {label}: {steps} steps in {wall:.1f} s (command); losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; val {summary['final_val_loss']:.4f}; "
        f"{summary['parameter_count']} params ({summary['trainable_parameter_count']} "
        f"trainable); peak memory {summary['peak_memory'] / 2**30:.2f} GiB")
    _check_counts(f"zoo {label}", counts, {
        "flash_attention_fwd": layers * (steps + eval_batches),
        "flash_attention_bwd_dq": layers * steps,
        "flash_attention_bwd_dkdv": layers * steps,
    })
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"{label}: logged losses are not {steps} finite values: {losses}")
    # Past the warm-up steps and before the last, whose interval holds the
    # end-of-run save; the short runs keep two steps.
    steady = [i for i in sorted(steps_log) if min(5, steps - 3) < i < steps]
    step_ms = [steps_log[i]["step_time"] * 1e3 for i in steady]
    span = f"median of steps {steady[0]}-{steady[-1]}: {' '.join(f'{x:.1f}' for x in step_ms)} ms"
    log(f"[zoo] {label}: step times ({span})")
    return dict(run_dir=run_dir, losses=losses, summary=summary, counts=counts,
                step_ms=statistics.median(step_ms), span=span,
                tokens_per_sec=statistics.median(steps_log[i]["tokens_per_sec"] for i in steady),
                mfu=statistics.median(steps_log[i]["mfu"] for i in steady), layers=layers)


def _zoo_generate(cfg_path: Path, run_dir: Path, label: str, *extra: str,
                  new_tokens: int = 48) -> list[int]:
    code, out = _run_cli(["generate", "--config", str(cfg_path), "--from", str(run_dir),
                          "--prompt", "def ", "--max-new-tokens", str(new_tokens),
                          "--temperature", "0", "--json", *extra])
    if code != 0:
        raise RuntimeError(f"{label}: generate exited {code}")
    gen = json.loads(out)
    ids = gen["completion_ids"]
    log(f"[zoo] {label}: generate greedy 'def ' + {new_tokens}: {gen['text']!r}")
    if len(ids) != new_tokens or not all(0 <= i < 256 for i in ids):
        raise RuntimeError(f"{label}: generate returned {ids}")
    return ids


def _zoo_llama(torch, smi: str, tmp: Path, eval_batches: int) -> dict:
    """(a) and (b): the llama cell and its serving and interop paths."""
    import numpy as np

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.training.checkpoint import load_inference_params

    cfg_path = _zoo_config(tmp, "llama_pycorpus_zoo", "llama_pycorpus_tpu", steps=ZOO_STEPS,
                           model=dict(n_layers=ZOO_LLAMA_LAYERS), warmup=ZOO_WARMUP)
    cfg, _, _ = load_and_validate_config(cfg_path)
    torch.cuda.empty_cache()
    run = _zoo_train(tmp, cfg_path, "llama", steps=ZOO_STEPS, eval_batches=eval_batches,
                     label="(a) llama_pycorpus_tpu")
    losses, layers = run["losses"], run["layers"]
    if not losses[-1] <= losses[0] - LOSS_DROP_MIN:
        raise RuntimeError(f"llama: loss did not fall by {LOSS_DROP_MIN}: "
                           f"{losses[0]} -> {losses[-1]}")
    log(f"[zoo] (a) llama steady state ({run['span']}) on {smi}: step "
        f"{run['step_ms']:.1f} ms, {run['tokens_per_sec']:.0f} tokens/s, MFU {run['mfu']:.4f} "
        f"(6N + 12·L·T·d with N = {run['summary']['parameter_count']}), peak memory "
        f"{run['summary']['peak_memory'] / 2**30:.2f} GiB")

    # (b) generate past block_size: the re-forward branch.
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.models.lora import build_adapter

    _reset_counts()
    model = build_adapter(cfg).build_model(cfg, resolve_device(cfg.run.device))
    load_inference_params(run["run_dir"] / "checkpoints" / f"step_{ZOO_STEPS:06d}.ckpt", model)
    model = model.to(torch.bfloat16)
    model.param_dtype = torch.bfloat16
    prompt_len, max_new = REFORWARD
    ids = np.random.default_rng(21).integers(0, 256, (1, prompt_len)).astype(np.int32)
    t0 = time.perf_counter()
    out = np.asarray(generate(model, ids, max_new_tokens=max_new, temperature=0.0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = _read_counts()
    log(f"[zoo] (b) llama generate greedy {prompt_len}+{max_new} (re-forward): "
        f"{wall * 1e3:.1f} ms, {launched['flash_attention_fwd']} flash forward launches "
        f"(>= {layers * max_new} required) on {smi}")
    if out.shape != (1, prompt_len + max_new) or not np.array_equal(out[:, :prompt_len], ids):
        raise RuntimeError(f"llama generate() returned {out.shape}")
    if launched["flash_attention_fwd"] < layers * max_new:
        raise RuntimeError("llama: the re-forward branch did not go through the flash kernel")
    gen_counts = launched
    del model
    torch.cuda.empty_cache()

    # serve-bench --verify-parity: the paged path against generate().
    t0 = time.perf_counter()
    code, out = _run_cli(["serve-bench", "--config", str(cfg_path), "--from", str(run["run_dir"]),
                          "--requests", str(ZOO_REQUESTS), "--rate-rps", str(CONT_RATE_RPS),
                          "--seed", "21", "--prompt-tokens-min", str(CONT_PROMPTS[0]),
                          "--prompt-tokens-max", str(CONT_PROMPTS[1]),
                          "--max-new-tokens", str(ZOO_NEW_TOKENS), "--temperature", "0",
                          "--verify-parity"])
    wall = time.perf_counter() - t0
    summary = json.loads(out)
    block = summary["serving"]
    log(f"[zoo] (b) llama serve-bench: exit {code}, {ZOO_REQUESTS} requests in {wall:.1f} s "
        f"(command, parity included): {block['throughput']['tokens_per_sec']} output tokens/s, "
        f"TTFT p50 {block['slo']['ttft_ms']['p50']} ms, per-token p50 "
        f"{block['slo']['per_token_ms']['p50']} ms; parity {block['parity']}")
    if not (code == 0 and summary["ok"] and block["parity"]["bitwise_identical"]
            and block["requests"]["completed"] == ZOO_REQUESTS
            and block["requests"]["failed"] == 0):
        raise RuntimeError(f"llama serve-bench failed its gates: {summary.get('failures')}")

    # export to HF names -> import -> eval, bit-identical.
    _reset_counts()
    trained = _eval_cli(cfg_path, run["run_dir"])
    exported, imported = tmp / "llama_hf.pt", tmp / "llama_imported"
    code, out = _run_cli(["export-checkpoint", "--config", str(cfg_path), "--from",
                          str(run["run_dir"]), "--output", str(exported), "--json"])
    if code != 0:
        raise RuntimeError(f"llama export-checkpoint exited {code}")
    names = sorted(torch.load(exported, weights_only=True))
    if "model.layers.0.self_attn.k_proj.weight" not in names or "lm_head.weight" not in names:
        raise RuntimeError(f"llama export is not in HF Llama names: {names[:6]}")
    code, _ = _run_cli(["import-checkpoint", "--config", str(cfg_path), "--input", str(exported),
                        "--output", str(imported), "--json"])
    if code != 0:
        raise RuntimeError(f"llama import-checkpoint exited {code}")
    round_trip = _eval_cli(cfg_path, imported)
    eval_counts = _read_counts()
    log(f"[zoo] (b) llama eval {trained!r}, the trainer's {run['summary']['final_val_loss']!r}; "
        f"export ({len(names)} HF tensors) -> import -> eval {round_trip!r}")
    if round_trip != trained or abs(trained - run["summary"]["final_val_loss"]) > EVAL_ATOL:
        raise RuntimeError("llama export -> import -> eval is not bit-identical to eval")
    _check_counts("zoo (b) evals", eval_counts,
                  {"flash_attention_fwd": 2 * layers * eval_batches})
    counts = {k: run["counts"][k] + gen_counts[k] + eval_counts[k] for k in run["counts"]}
    return dict(run=run, counts=counts)


def _zoo_families(torch, smi: str, tmp: Path, eval_batches: int) -> dict:
    """(c) Qwen2 and Gemma, (d) the Mixtral layout: full width, fewer
    layers, each with a greedy `generate` from its checkpoint."""
    counts = {}
    runs = {}
    small = dict(n_layers=ZOO_SMALL_LAYERS)
    cases = [
        ("qwen2", dict(name="qwen2", **small), {}, ZOO_SMALL_STEPS),
        ("gemma", dict(name="gemma", **small), {}, ZOO_SMALL_STEPS),
        ("llama_moe", dict(name="llama_moe", **small),
         dict(n_experts=4, router_top_k=2, capacity_factor=2.0, sliding_window=ZOO_WINDOW),
         ZOO_MOE_STEPS),
    ]
    for name, model, extra, steps in cases:
        cfg_path = _zoo_config(tmp, f"zoo_{name}", "llama_pycorpus_tpu", steps=steps,
                               model=model, extra=extra)
        torch.cuda.empty_cache()
        run = _zoo_train(tmp, cfg_path, f"zoo_{name}", steps=steps, eval_batches=eval_batches,
                         label=f"({'d' if name == 'llama_moe' else 'c'}) {name}")
        if name == "llama_moe" and not run["losses"][-1] < run["losses"][0]:
            raise RuntimeError(f"llama_moe: losses did not fall: {run['losses']}")
        _reset_counts()
        _zoo_generate(cfg_path, run["run_dir"], name)
        _check_counts(f"zoo {name} generate", _read_counts(), {})  # the KV cache: no kernel
        log(f"[zoo] {name}: step {run['step_ms']:.1f} ms ({run['span']}), "
            f"{run['tokens_per_sec']:.0f} tokens/s, "
            f"peak memory {run['summary']['peak_memory'] / 2**30:.2f} GiB on {smi}")
        runs[name] = run
        for k, v in run["counts"].items():
            counts[k] = counts.get(k, 0) + v
    return dict(runs=runs, counts=counts)


def _zoo_lora(torch, smi: str, tmp: Path, eval_batches: int) -> dict:
    """(e) gpt_lora_ft: the frozen base bit-identical, every B moved, the
    merged export imported into the plain config and generating."""
    import numpy as np
    import yaml

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.distributed import resolve_device
    from llmtrain_tpu_torch.interop import state_dict_to_flax_params
    from llmtrain_tpu_torch.models.lora import build_adapter
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    cfg_path = _zoo_config(tmp, "zoo_lora", "gpt_lora_ft", steps=ZOO_LORA_STEPS,
                           model={"n_layers": ZOO_SMALL_LAYERS})
    cfg, _, _ = load_and_validate_config(cfg_path)
    torch.cuda.empty_cache()
    run = _zoo_train(tmp, cfg_path, "zoo_lora", steps=ZOO_LORA_STEPS, eval_batches=eval_batches,
                     label="(e) gpt_lora_ft")
    fresh = build_adapter(cfg).build_model(cfg, resolve_device(cfg.run.device))
    init = state_dict_to_flax_params(fresh.state_dict(), n_heads=cfg.model.n_heads)
    del fresh
    payload = CheckpointManager.load(
        run["run_dir"] / "checkpoints" / f"step_{ZOO_LORA_STEPS:06d}.ckpt")

    def leaves(tree, path=()):
        for k, v in tree.items():
            yield from (leaves(v, (*path, k)) if isinstance(v, dict) else [((*path, k), v)])

    base = dict(leaves(payload["params"]["base"]))
    changed = [p for p, v in leaves(init["base"])
               if not torch.equal(torch.as_tensor(np.array(base[p])), v)]
    factors = dict(leaves(payload["params"]["lora"]))
    still = [p for p, v in factors.items() if p[-1] == "b" and not np.asarray(v).any()]
    n_b = sum(p[-1] == "b" for p in factors)
    log(f"[zoo] (e) lora: {len(base)} base leaves, {len(changed)} changed; {n_b} factors B, "
        f"{n_b - len(still)} moved; trainable {run['summary']['trainable_parameter_count']} of "
        f"{run['summary']['parameter_count']}; step {run['step_ms']:.1f} ms ({run['span']}), "
        f"peak memory "
        f"{run['summary']['peak_memory'] / 2**30:.2f} GiB on {smi}")
    if changed or still or not n_b:
        raise RuntimeError(f"lora: base leaves changed {changed[:4]}, factors B unmoved "
                           f"{still[:4]}")
    exported, imported = tmp / "lora_merged.pt", tmp / "lora_imported"
    code, _ = _run_cli(["export-checkpoint", "--config", str(cfg_path), "--from",
                        str(run["run_dir"]), "--output", str(exported), "--json"])
    if code != 0:
        raise RuntimeError(f"lora export-checkpoint exited {code}")
    raw = yaml.safe_load(cfg_path.read_text())
    raw["model"]["extra"].pop("lora")
    plain = tmp / "zoo_lora_plain.yaml"
    plain.write_text(yaml.safe_dump(raw, sort_keys=False))
    code, _ = _run_cli(["import-checkpoint", "--config", str(plain), "--input", str(exported),
                        "--output", str(imported), "--json"])
    if code != 0:
        raise RuntimeError(f"lora: import-checkpoint of the merged export exited {code}")
    # The merged weights evaluate as the LoRA run does: a merge with a wrong
    # scale or transpose moves the loss far past EVAL_ATOL (6 steps of the
    # factors alone took it from the base's ~5.5 to ~4).
    _reset_counts()
    lora_eval = _eval_cli(cfg_path, run["run_dir"])
    merged_eval = _eval_cli(plain, imported)
    eval_counts = _read_counts()
    trained = run["summary"]["final_val_loss"]
    log(f"[zoo] (e) lora eval {lora_eval!r} (the trainer's {trained!r}); the merged export's "
        f"{merged_eval!r}: |diff| {abs(merged_eval - lora_eval):.3e} (atol {EVAL_ATOL:g})"
        f"{', bit-identical' if merged_eval == lora_eval else ''}")
    if abs(lora_eval - trained) > EVAL_ATOL or abs(merged_eval - lora_eval) > EVAL_ATOL:
        raise RuntimeError("lora: the merged export does not evaluate as the LoRA run")
    _check_counts("zoo (e) evals", eval_counts,
                  {"flash_attention_fwd": 2 * run["layers"] * eval_batches})
    _reset_counts()
    merged = _zoo_generate(plain, imported, "(e) merged export")
    lora_ids = _zoo_generate(cfg_path, run["run_dir"], "(e) lora run")
    _check_counts("zoo lora generate", _read_counts(), {})
    if merged != lora_ids:
        raise RuntimeError("the merged export does not generate the LoRA run's tokens")
    counts = {k: run["counts"][k] + eval_counts[k] for k in run["counts"]}
    return {**run, "counts": counts}


def phase_zoo(torch, smi: str, tmp: Path) -> dict:
    """Phase 21: the model zoo, (a)-(e) above. Returns the launch counts
    of its training, generate and eval paths."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer

    t_phase = time.perf_counter()
    cfg_path = _zoo_config(tmp, "zoo_probe", "llama_pycorpus_tpu", steps=ZOO_STEPS)
    cfg, _, _ = load_and_validate_config(cfg_path)
    dm = LocalTextDataModule()
    dm.setup(cfg, ByteTokenizer())
    eval_batches = -(-len(dm.val_dataset()) // cfg.trainer.micro_batch_size)
    del dm
    llama = _zoo_llama(torch, smi, tmp, eval_batches)
    families = _zoo_families(torch, smi, tmp, eval_batches)
    lora = _zoo_lora(torch, smi, tmp, eval_batches)
    counts = {k: llama["counts"][k] + families["counts"][k] + lora["counts"][k]
              for k in llama["counts"]}
    seconds = time.perf_counter() - t_phase
    log(f"[zoo] phase 21 in {seconds:.1f} s on {smi}; launches {counts}")
    return dict(llama=llama["run"], families=families["runs"], lora=lora, counts=counts,
                seconds=seconds)


# ------------------------------------------------ parallelism on one device
# Phase 22 (module doc): quantized training matmuls, activation tiers and
# remat, ZeRO with host offload, at phase 9's width and depth.
# (a) Phase 9's config in int8 and fp8 for QUANT_STEPS steps, inside its
# warmup, so phase 9's own losses are the f32 trajectory step for step.
QUANT_STEPS = FUSED_STEPS
# JAX's documented N-step parity band against f32 (tests/test_quant_train.py).
PARITY_RTOL = {"int8": 0.05, "fp8": 0.10}
# The fp8 product on the card against its plain version (the e4m3 operands
# multiplied as f32: every product of two e4m3 values is exact), as a
# share of the output's largest magnitude. Not the f32 summation order
# alone: Hopper's fp8 MMA keeps about 14 mantissa bits in its accumulator
# between the promotions to f32 that use_fast_accum=False adds (the
# DeepSeek-V3 report measures the same on the H800); 2.69e-4 at K = 768
# (PERF.md §6), against 4.4e3 for the control.
FP8_RTOL = 2e-3
FP8_TOKENS = TRAIN_SHAPE[0] * TRAIN_SHAPE[1]
# The cell's projections, (in, out): qkv, out_proj, mlp_fc, mlp_proj.
FP8_PROJECTIONS = {"qkv": (768, 2304), "out_proj": (768, 768), "mlp_fc": (768, 3072),
                   "mlp_proj": (3072, 768)}
H100_FP8_FLOPS = 1979e12  # dense e4m3 tensor-core peak of the H100 SXM
FP8_PROFILE_ROUNDS = 10  # profiled rounds of the bare product over the four shapes
# (b) Each ladder trains LADDER_STEPS steps from the same init and batches.
LADDER_STEPS = 3
LADDERS = (("none", None, False), ("selective", "selective:*", False),
           ("full", "full:*", False), ("offload", "offload:0-5,full:6-11", False),
           ("fused-none", None, True), ("fused-full", "full:*", True))
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4  # the North star's gradient band
# (c) The one-rank NCCL job of phase 18(a), under trainer.zero.
ZERO_RUNS = (("zero-stage1-offload", {"stage": 1, "host_offload": True}),
             ("zero-stage2", {"stage": 2}))


class _ExactLosses:
    """Records every step's loss exactly (the train log rounds to 4
    digits) while active: the trainer's interval hook, wrapped."""

    def __init__(self) -> None:
        self.losses: list[float] = []

    def __enter__(self) -> "_ExactLosses":
        import numpy as np

        from llmtrain_tpu_torch.training.trainer import Trainer

        self._real = real = Trainer._log_train_interval
        sink = self.losses

        def log_interval(trainer, **kw):
            sink.extend(float(x) for x in np.asarray(kw["losses_host"]))
            return real(trainer, **kw)

        Trainer._log_train_interval = log_interval
        return self

    def __exit__(self, *exc) -> None:
        from llmtrain_tpu_torch.training.trainer import Trainer

        Trainer._log_train_interval = self._real


def _fp8_products(torch, smi: str) -> dict:
    """(a): the fp8 product at the cell's projection shapes against its
    plain version, a broken control (the second operand's scale dropped),
    and its time beside the bf16 F.linear it replaces."""
    import torch.nn.functional as F

    from llmtrain_tpu_torch.ops import quant

    if not quant.fp8_supported("cuda"):
        raise RuntimeError("fp8_supported() is False on the card")
    gen = torch.Generator(device="cuda").manual_seed(22)
    out, operands = {}, []
    for name, (k, n) in FP8_PROJECTIONS.items():
        x = torch.randn(FP8_TOKENS, k, device="cuda", generator=gen).to(torch.bfloat16)
        w = (torch.randn(n, k, device="cuda", generator=gen) * 0.02).to(torch.bfloat16)
        a, b = x[None], w.t()[None]
        got, plain = quant.fp8_bmm(a, b), quant.fp8_bmm_plain(a, b)
        scale = float(plain.abs().max())
        err = float((got - plain).abs().max()) / scale
        a8, b8, sa, _ = quant._fp8_operands(a, b)
        one = torch.ones((), device="cuda")
        broken = torch._scaled_mm(a8[0], b8[0].t().contiguous().t(), scale_a=sa, scale_b=one,
                                  out_dtype=torch.float32, use_fast_accum=False)
        broken_err = float((broken - plain[0]).abs().max()) / scale
        # The train path's product's operands, cast as it casts them, for
        # the bare products profiled beside its step (_quant_train).
        a8, b8, sa, sb = quant._fp8_operands(a, b)
        operands.append((a8[0], b8[0].t().contiguous().t(), sa, sb))
        fp8 = quant.quant_dot_general("fp8")
        fp8_ms = _time_ms(torch, lambda: fp8(x, w), iters=20, warmup=3)
        bf16_ms = _time_ms(torch, lambda: F.linear(x, w), iters=20, warmup=3)
        gemm_bound = 2 * FP8_TOKENS * k * n / H100_FP8_FLOPS * 1e3
        log(f"[fp8] {name} ({FP8_TOKENS}, {k}) x ({k}, {n}): max |_scaled_mm - plain| "
            f"{err:.3e} of the largest output (limit {FP8_RTOL}); control (scale dropped) "
            f"{broken_err:.3e}; fp8 linear (scales, casts, product) {fp8_ms:.4f} ms, bf16 "
            f"F.linear {bf16_ms:.4f} ms, fp8 GEMM bound {gemm_bound:.4f} ms on {smi}")
        if not err <= FP8_RTOL:
            raise RuntimeError(f"fp8 product {name}: {err} exceeds {FP8_RTOL}")
        if not broken_err > FP8_RTOL:
            raise RuntimeError(f"fp8 product {name}: the broken control ({broken_err}) does not "
                               "exceed the limit")
        out[name] = dict(err=err, fp8_ms=fp8_ms, bf16_ms=bf16_ms)
        del x, w, a, b, got, plain, a8, b8, broken
    torch.cuda.empty_cache()
    return dict(rows=out, operands=operands)


class _ProfiledStep:
    """Profiles the device kernels of the trainer's ``step``-th call of its
    train step function while active (``make_train_step``, wrapped), then,
    in the same profiler session, ``after()`` behind a marker kernel
    (``torch.cuda._sleep``'s spin kernel): ``names`` are the step's kernels,
    ``after_names`` those ``after()`` launched."""

    def __init__(self, torch, step: int, after) -> None:
        self.torch, self.step, self.after = torch, step, after
        self.names: list[str] = []
        self.after_names: list[str] = []

    def __enter__(self) -> "_ProfiledStep":
        from torch.profiler import ProfilerActivity, profile

        from llmtrain_tpu_torch.training import trainer as trainer_module

        self._real = real = trainer_module.make_train_step
        torch, want, after = self.torch, self.step, self.after

        def make(*args, **kwargs):
            fn, calls = real(*args, **kwargs), [0]

            def step_fn(*a, **k):
                calls[0] += 1
                if calls[0] != want:
                    return fn(*a, **k)
                with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
                    metrics = fn(*a, **k)
                    torch.cuda.synchronize()
                    torch.cuda._sleep(1000)
                    after()
                    torch.cuda.synchronize()
                kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                                 if e.device_type.name == "CUDA")
                mark = next((i for i, (_, n) in enumerate(kernels) if "spin_kernel" in n), None)
                if mark is None:
                    raise RuntimeError(f"the profile of step {want} lacks the marker kernel "
                                       f"({len(kernels)} kernels)")
                self.names.extend(n for _, n in kernels[:mark])
                self.after_names.extend(n for _, n in kernels[mark + 1:])
                return metrics

            return step_fn

        trainer_module.make_train_step = make
        return self

    def __exit__(self, *exc) -> None:
        from llmtrain_tpu_torch.training import trainer as trainer_module

        trainer_module.make_train_step = self._real


def _quant_train(torch, smi: str, tmp: Path, train: dict, operands: list) -> dict:
    """(a): phase 9's config in int8 and fp8 through `train`, against
    phase 9's exact f32 losses; the fp8 run's last step profiled, with
    bare `torch._scaled_mm` products on ``operands`` (the cell's shapes,
    cast as the train path casts them) behind it in the same session:
    their GEMM kernels must be among the step's; the fp8 run's
    checkpoint through `generate`."""
    import collections
    import contextlib

    import yaml

    from llmtrain_tpu_torch.config import load_and_validate_config

    base = train["exact_losses"][:QUANT_STEPS]
    rows, counts = {}, None
    for mode in ("int8", "fp8"):
        cfg_path = _smoke_config(tmp, f"quant_{mode}", matmul_precision=mode)
        raw = yaml.safe_load(cfg_path.read_text())
        raw["trainer"].update(max_steps=QUANT_STEPS, save_every_steps=QUANT_STEPS,
                              eval_every_steps=QUANT_STEPS)
        cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
        cfg, _, _ = load_and_validate_config(cfg_path)
        profiled = None
        if mode == "fp8":
            def bare() -> None:
                for _ in range(FP8_PROFILE_ROUNDS):
                    for a8, b8, sa, sb in operands:
                        torch._scaled_mm(a8, b8, scale_a=sa, scale_b=sb,
                                         out_dtype=torch.bfloat16, use_fast_accum=False)

            profiled = _ProfiledStep(torch, QUANT_STEPS, bare)
        _reset_counts()
        with _ExactLosses() as rec, profiled or contextlib.nullcontext():
            code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id",
                                  f"quant_{mode}", "--json"])
        got = _read_counts()
        if code != 0:
            raise RuntimeError(f"{mode} train exited {code}")
        layers = cfg.model.n_layers
        _check_counts(f"quant {mode}", got, {
            "flash_attention_fwd": layers * (QUANT_STEPS + train["eval_batches"]),
            "flash_attention_bwd_dq": layers * QUANT_STEPS,
            "flash_attention_bwd_dkdv": layers * QUANT_STEPS,
        })
        counts = got if counts is None else {k: counts[k] + got[k] for k in got}
        summary = json.loads(out)["train_result"]
        run_dir = tmp / "runs" / f"quant_{mode}"
        precision = json.loads((run_dir / "report.json").read_text())["precision"]
        steps = _logged_steps(run_dir)
        losses = rec.losses
        rel = max(abs(x - b) / abs(b) for x, b in zip(losses, base))
        same = sum(x == b for x, b in zip(losses, base))
        s = _steady(steps)
        log(f"[quant] {mode}: losses {' '.join(repr(x) for x in losses)}; against phase 9's "
            f"f32 losses max rel {rel:.3e} (PARITY_RTOL {PARITY_RTOL[mode]}), {same} of "
            f"{len(base)} bitwise equal; report.json "
            f"matmul_precision {precision['matmul_precision']!r}; step "
            f"{s['step_time'] * 1e3:.1f} ms, {s['tokens_per_sec']:.0f} tokens/s, MFU "
            f"{s['mfu']:.4f} (median of steps 2-{QUANT_STEPS - 1}), peak memory "
            f"{summary['peak_memory'] / 2**30:.2f} GiB on {smi}")
        if precision["matmul_precision"] != mode:
            raise RuntimeError(f"the {mode} run resolved to {precision['matmul_precision']}")
        if len(losses) != QUANT_STEPS or not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{mode}: losses are not {QUANT_STEPS} finite values: {losses}")
        if not losses[-1] < losses[0]:
            raise RuntimeError(f"{mode}: losses are not falling: {losses}")
        if rel > PARITY_RTOL[mode]:
            raise RuntimeError(f"{mode}: the losses left the parity band of f32 ({rel})")
        if same or not rel > 0:
            raise RuntimeError(f"{mode}: {same} of the losses are phase 9's f32 losses bit for "
                               "bit: the quantized products did not run")
        if profiled is not None:
            # torch._scaled_mm clears its output with a memset before the GEMM.
            bare_kernels = [n for n in profiled.after_names
                            if not n.startswith(("Memset", "Memcpy"))]
            gemms = set(bare_kernels)
            found = [n for n in profiled.names if n in gemms]
            matmuls = collections.Counter(
                n for n in profiled.names
                if any(w in n.lower() for w in ("nvjet", "gemm", "xmma", "cutlass")))
            log(f"[quant] fp8: profile of step {QUANT_STEPS}: {len(found)} launches of the "
                f"kernels of the bare torch._scaled_mm products behind it "
                f"({len(bare_kernels)} of {FP8_PROFILE_ROUNDS * len(operands)} launches "
                f"profiled: {sorted(gemms)}) among its {len(profiled.names)} kernels; the "
                f"step's matmul kernels {dict(matmuls)}")
            if not found:
                raise RuntimeError("the fp8 run's profiled step shows no fp8 GEMM kernel")
        rows[mode] = dict(losses=losses, rel=rel, step_ms=s["step_time"] * 1e3,
                          tokens_per_sec=s["tokens_per_sec"], mfu=s["mfu"],
                          peak_memory=summary["peak_memory"], cfg_path=cfg_path,
                          run_dir=run_dir)
    _reset_counts()
    ids = _zoo_generate(rows["fp8"]["cfg_path"], rows["fp8"]["run_dir"], "fp8 model",
                        new_tokens=16)
    got = _read_counts()
    counts = {k: counts[k] + got[k] for k in got}
    log(f"[quant] fp8 generate (decode rows of {64}, the KV cache): {ids}")
    return dict(rows=rows, counts=counts)


def _pinned_pool(torch) -> tuple[int, int]:
    """The pinned host allocator's pool, (current, peak) bytes: blocks
    rounded up to powers of two, cached ones included
    (``allocated_bytes``; the card's torch 2.11 counts ``active_bytes``
    up and never down)."""
    stats = torch.cuda.memory.host_memory_stats()
    return int(stats["allocated_bytes.current"]), int(stats["allocated_bytes.peak"])


def _ladders(torch, smi: str, tmp: Path) -> dict:
    """(b): each ladder's LADDER_STEPS steps through the trainer's step on
    the same init and batches; step 1's loss and gradients against the
    ladder without remat, peak memory, the recompute's launches, and a
    profile of the full ladder's step showing the flash forward twice a
    layer."""
    import gc

    import yaml
    from torch.profiler import ProfilerActivity, profile

    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.sampler import DeterministicSampler
    from llmtrain_tpu_torch.training import optimizer as optimizer_module
    from llmtrain_tpu_torch.training.trainer import Trainer

    captured: list = []
    real_step = optimizer_module._Optimizer.step
    held: list = []  # device bytes allocated when step 1's backward starts
    real_backward = torch.Tensor.backward

    def capturing(self, grads, apply=None):
        if not captured:
            captured.append([g.detach().to("cpu", copy=True) for g in grads])
        return real_step(self, grads, apply)

    def holding(self, *args, **kwargs):
        if not held:
            held.append(torch.cuda.memory_allocated())
        return real_backward(self, *args, **kwargs)

    rows, counts, reference = {}, None, {}
    optimizer_module._Optimizer.step = capturing
    torch.Tensor.backward = holding
    try:
        for name, spec, fused in LADDERS:
            extra = {"fused_norm": True} if fused else {}
            cfg_path = _smoke_config(tmp, f"ladder_{name}", **extra)
            if spec is not None:
                raw = yaml.safe_load(cfg_path.read_text())
                raw["model"]["extra"]["activation_tiers"] = spec
                cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
            cfg, _, _ = load_and_validate_config(cfg_path)
            trainer = Trainer(cfg, None)
            ds = trainer._data_module.train_dataset()
            sampler = DeterministicSampler(len(ds), cfg.trainer.micro_batch_size, cfg.run.seed)
            batches = [trainer.global_batch(sampler, ds, s) for s in range(1, LADDER_STEPS + 1)]
            captured.clear()
            held.clear()
            torch.cuda.synchronize()
            pool_before = _pinned_pool(torch)[0]
            torch.cuda.memory.reset_peak_host_memory_stats()
            torch.cuda.reset_peak_memory_stats()
            _reset_counts()
            walls, first, kernels = [], None, None
            for s, batch in enumerate(batches, 1):
                t0 = time.perf_counter()
                if name == "full" and s == LADDER_STEPS:
                    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
                        metrics = trainer._train_step_fn(trainer.state, batch)
                        torch.cuda.synchronize()
                    kernels = [(e.time_range.start, e.name) for e in prof.events()
                               if e.device_type.name == "CUDA" and "flash_" in e.name]
                else:
                    metrics = trainer._train_step_fn(trainer.state, batch)
                loss = float(metrics["loss"])
                walls.append((time.perf_counter() - t0) * 1e3)
                if s == 1:
                    first = loss
            got = _read_counts()
            peak = torch.cuda.max_memory_allocated()
            layers = cfg.model.n_layers
            remat = spec is not None
            want = {"flash_attention_fwd": (2 if remat else 1) * layers * LADDER_STEPS,
                    "flash_attention_bwd_dq": layers * LADDER_STEPS,
                    "flash_attention_bwd_dkdv": layers * LADDER_STEPS}
            if fused:
                want.update(fused_norm_fwd=(4 if remat else 2) * layers * LADDER_STEPS,
                            fused_norm_bwd=2 * layers * LADDER_STEPS)
            _check_counts(f"ladder {name}", got, want)
            counts = got if counts is None else {k: counts[k] + got[k] for k in got}
            grads = captured[0]
            ref = reference.get(fused)
            verdict = "reference"
            if ref is None:
                reference[fused] = dict(loss=first, grads=grads)
            else:
                if first != ref["loss"]:
                    raise RuntimeError(f"ladder {name}: step 1's loss {first!r} is not the "
                                       f"ladder without remat's {ref['loss']!r}")
                if all(torch.equal(g, r) for g, r in zip(grads, ref["grads"])):
                    verdict = "gradients bitwise"
                else:
                    worst = max(float((g - r).abs().max()) for g, r in zip(grads, ref["grads"]))
                    if not all(torch.allclose(g, r, atol=GRAD_ATOL, rtol=GRAD_RTOL)
                               for g, r in zip(grads, ref["grads"])):
                        raise RuntimeError(f"ladder {name}: step 1's gradients left the band "
                                           f"(max |diff| {worst:.3e})")
                    verdict = f"gradients within the band (max |diff| {worst:.3e})"
            pinned = _pinned_pool(torch)[1] - pool_before  # the pool's growth in this ladder
            staged = sum(t == "offload" for t in trainer._model.layer_tiers) * (
                cfg.trainer.micro_batch_size * cfg.model.block_size * cfg.model.d_model
                * torch.empty((), dtype=getattr(torch, cfg.model.dtype)).element_size())
            log(f"[ladder] {name} ({spec or 'no remat'}{', fused_norm' if fused else ''}): "
                f"step 1 loss {first!r}, {verdict}; {held[0]} bytes allocated at the backward's "
                f"start, peak memory {peak / 2**30:.3f} GiB; pinned host pool grew {pinned} "
                f"bytes for {staged} bytes of block inputs staged; "
                f"step walls {' '.join(f'{w:.1f}' for w in walls)} ms on {smi}")
            if kernels is not None:
                # The recompute: flash forwards that start after the
                # backward's first dq kernel. (The exact counts are the
                # launch counters' above; the profiler has dropped a
                # kernel of a step.)
                first_dq = min((t for t, n in kernels if "flash_bwd_dq" in n), default=None)
                fwd = [t for t, n in kernels if "flash_fwd" in n]
                in_bwd = sum(1 for t in fwd if first_dq is not None and t > first_dq)
                log(f"[ladder] full: profile of step {LADDER_STEPS}: {len(fwd)} flash forward "
                    f"kernels, {in_bwd} of them after the backward's first dq kernel; "
                    f"{len(kernels)} flash kernels in all")
                if not in_bwd:
                    raise RuntimeError("the full ladder's profile shows no flash forward in the "
                                       "backward")
            if pinned < staged:
                raise RuntimeError(f"ladder {name}: the pinned host pool grew {pinned} bytes, "
                                   f"under the {staged} bytes of block inputs it stages")
            rows[name] = dict(loss=first, peak=peak, held=held[0], pinned=pinned, staged=staged,
                              step_ms=walls[1])
            del trainer, ds, batches, metrics, grads
            captured.clear()
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        optimizer_module._Optimizer.step = real_step
        torch.Tensor.backward = real_backward
    ladder = ("none", "selective", "full", "offload")
    for what, unit in (("peak", "peak memory"), ("held", "bytes held at the backward's start")):
        order = [rows[k][what] for k in ladder]
        log(f"[ladder] {unit} none > selective > full > offload: "
            f"{' > '.join(f'{p / 2**30:.3f}' for p in order)} GiB; fused_norm none "
            f"{rows['fused-none'][what] / 2**30:.3f} > full "
            f"{rows['fused-full'][what] / 2**30:.3f}; full - offload "
            f"{rows['full'][what] - rows['offload'][what]} bytes")
        if not all(a > b for a, b in zip(order, order[1:])):
            raise RuntimeError(f"{unit} does not fall none > selective > full > offload: "
                               f"{order}")
    if rows["offload"]["staged"] <= 0:
        raise RuntimeError("the offload ladder stages no block input")
    return dict(rows=rows, counts=counts)


def _zero(torch, smi: str, tmp: Path, ddp: dict) -> dict:
    """(c): the one-rank NCCL job of phase 18(a) under trainer.zero, stage
    1 with host offload and stage 2: losses bitwise the plain job's, and
    report.json's optimizer bytes."""
    import os

    import yaml

    params = ddp["summary"]["parameter_count"]
    adamw_bytes = 2 * params * 4
    rows = {}
    counts = None
    for name, zero in ZERO_RUNS:
        cfg_path = _ddp_config(tmp, name.replace("-", "_"), steps=DDP_STEPS, distributed=True)
        raw = yaml.safe_load(cfg_path.read_text())
        raw["trainer"]["zero"] = {"enabled": True, **zero}
        cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
        env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(_free_port())}
        saved_env = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        _reset_counts()
        try:
            with _ExactLosses() as rec:
                code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", name,
                                      "--json"])
            got = _read_counts()
        finally:
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if code != 0:
            raise RuntimeError(f"{name}: train exited {code}")
        layers = ddp["layers"]
        _check_counts(name, got, {
            "flash_attention_fwd": layers * (DDP_STEPS + ddp["eval_batches"]),
            "flash_attention_bwd_dq": layers * DDP_STEPS,
            "flash_attention_bwd_dkdv": layers * DDP_STEPS,
        })
        counts = got if counts is None else {k: counts[k] + got[k] for k in got}
        summary = json.loads(out)["train_result"]
        run_dir = tmp / "runs" / name
        memory = json.loads((run_dir / "report.json").read_text())["memory"]
        s = _steady(_logged_steps(run_dir))
        same = rec.losses == ddp["exact_losses"]
        log(f"[zero] {name}: losses {' '.join(repr(x) for x in rec.losses)}; bitwise the plain "
            f"one-rank job's: {same}; report.json opt_state_bytes "
            f"{memory.get('opt_state_bytes')}, per device "
            f"{memory.get('opt_state_bytes_per_device')}, host "
            f"{memory.get('opt_state_bytes_host')} (AdamW's state {adamw_bytes}); step "
            f"{s['step_time'] * 1e3:.1f} ms against the plain one-rank job's "
            f"{ddp['one']['step_time'] * 1e3:.1f} ms (median of steps 2-{DDP_STEPS - 1}); "
            f"peak memory {summary['peak_memory'] / 2**30:.2f} GiB on {smi}")
        if not same:
            raise RuntimeError(f"{name}: the losses are not the plain one-rank job's bit for bit")
        if zero.get("host_offload") and (memory.get("opt_state_bytes_host") != adamw_bytes
                                         or memory.get("opt_state_bytes_per_device") != 0):
            raise RuntimeError(f"{name}: report.json's optimizer bytes are not AdamW's state on "
                               f"the host and none on the card: {memory}")
        rows[name] = dict(step_ms=s["step_time"] * 1e3, memory=memory,
                          peak_memory=summary["peak_memory"])
    return dict(rows=rows, counts=counts)


def phase_parallel(torch, smi: str, tmp: Path, train: dict, ddp: dict) -> dict:
    """Phase 22 (module doc): (a) quantized matmuls, (b) activation tiers,
    (c) ZeRO. Returns the launch counts of its paths."""
    t0 = time.perf_counter()
    products = _fp8_products(torch, smi)
    quant = _quant_train(torch, smi, tmp, train, products.pop("operands"))
    torch.cuda.empty_cache()
    ladders = _ladders(torch, smi, tmp)
    zero = _zero(torch, smi, tmp, ddp["ddp"])
    counts = {k: quant["counts"][k] + ladders["counts"][k] + zero["counts"][k]
              for k in quant["counts"]}
    seconds = time.perf_counter() - t0
    log(f"[parallel] phase 22 in {seconds:.1f} s on {smi}; launches {counts}")
    return dict(products=products["rows"], quant=quant["rows"], ladders=ladders["rows"],
                zero=zero["rows"], counts=counts, seconds=seconds)


# ---------------------------------------------------------------- meshes
# Phase 23. (a): every axis of distributed.mesh spelled out at one device.
MESH_ONE = {"data": 1, "fsdp": 1, "tensor": 1, "sequence": 1, "pipeline": 1, "expert": 1}
# (b): the byte cell's width at block 2048, cut to SEQ_LAYERS layers; a
# micro batch of SEQ_MICRO x SEQ_BLOCK is the cell's 64 x 512 tokens.
SEQ_BLOCK = 2048
SEQ_LAYERS = 4
SEQ_MICRO = 16
SEQ_STEPS = 8
SEQ_WARMUP = 2
SEQ_CHECK_SHAPE = (2, 2048, 12, 64)  # B, T, H, D of the f32 checks
SEQ_SHARDS = 4
SEQ_LAYER_SEED = 23
# The North star's bands (ROADMAP.md): outputs 2e-5; gradients atol 1e-5,
# rtol 1e-4.
SEQ_FWD_ATOL = 2e-5
SEQ_GRAD_ATOL, SEQ_GRAD_RTOL = 1e-5, 1e-4


def _one_rank_env() -> dict:
    return {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(_free_port())}


def _mesh_one_rank(torch, smi: str, tmp: Path, ddp: dict) -> dict:
    """23(a)."""
    import os

    import yaml

    from llmtrain_tpu_torch.training.checkpoint import read_manifest

    cfg_path = _ddp_config(tmp, "mesh_one", steps=DDP_STEPS, distributed=True)
    raw = yaml.safe_load(cfg_path.read_text())
    raw["distributed"]["mesh"] = dict(MESH_ONE)
    cfg_path.write_text(yaml.safe_dump(raw, sort_keys=False))
    env = _one_rank_env()
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    _reset_counts()  # the one-rank mesh path's counts start here
    try:
        with _ExactLosses() as rec:
            code, out = _run_cli(["train", "--config", str(cfg_path), "--run-id", "mesh_one",
                                  "--json"])
        counts = _read_counts()  # and end here
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if code != 0:
        raise RuntimeError(f"23(a): train exited {code}")
    layers = ddp["layers"]
    _check_counts("mesh one rank", counts, {
        "flash_attention_fwd": layers * (DDP_STEPS + ddp["eval_batches"]),
        "flash_attention_bwd_dq": layers * DDP_STEPS,
        "flash_attention_bwd_dkdv": layers * DDP_STEPS,
    })
    run_dir = tmp / "runs" / "mesh_one"
    topology = (read_manifest(run_dir / "checkpoints" / f"step_{DDP_STEPS:06d}.ckpt")
                or {}).get("topology", {})
    same = rec.losses == ddp["exact_losses"]
    s = _steady(_logged_steps(run_dir))
    log(f"[mesh] (a) distributed.mesh {MESH_ONE} over one NCCL rank: losses "
        f"{' '.join(repr(x) for x in rec.losses)}; bitwise phase 18(a)'s: {same}; manifest "
        f"topology mesh {topology.get('mesh')}, processes {topology.get('num_processes')}; step "
        f"{s['step_time'] * 1e3:.1f} ms against phase 18(a)'s {ddp['one']['step_time'] * 1e3:.1f} "
        f"ms on {smi}")
    if not same:
        raise RuntimeError("23(a): the mesh run's losses are not phase 18(a)'s bit for bit")
    if topology.get("mesh") != MESH_ONE or topology.get("num_processes") != 1:
        raise RuntimeError(f"23(a): the manifest records the topology {topology}")
    return dict(counts=counts, step_ms=s["step_time"] * 1e3)


def _close(torch, got, want, atol: float, rtol: float = 0.0) -> tuple[bool, float]:
    """(every |got - want| <= atol + rtol |want|, the largest |got - want|)."""
    diff = (got.double() - want.double()).abs()
    return bool((diff <= atol + rtol * want.double().abs()).all()), float(diff.max())


def _seq_layer_checks(torch, smi: str, device: str = "cuda") -> dict:
    """23(b)'s f32 checks (module doc)."""
    from llmtrain_tpu_torch.models.gpt import dense_attention
    from llmtrain_tpu_torch.ops import ring_attention
    from llmtrain_tpu_torch.ops.ring_attention import ring_or_blockwise
    from llmtrain_tpu_torch.ops.ulysses_attention import ulysses_or_blockwise

    b, t, h, d = SEQ_CHECK_SHAPE
    gen = torch.Generator(device=device).manual_seed(23)
    rows = {}

    def grads_of(attend, inputs, w):
        leaves = [x.clone().requires_grad_() for x in inputs]
        out = attend(*leaves)
        (out * w).sum().backward()
        return out.detach(), [x.grad for x in leaves]

    for scheme, fn in (("ring", ring_or_blockwise), ("ulysses", ulysses_or_blockwise)):
        q, k, v, w = (torch.randn(b, t, h, d, device=device, generator=gen) for _ in range(4))
        out, grads = grads_of(lambda a, b_, c: fn(a, b_, c, causal=True), (q, k, v), w)
        ref, ref_grads = grads_of(lambda a, b_, c: dense_attention(a, b_, c, attention_mask=None),
                                  (q, k, v), w)
        ok_f, err_f = _close(torch, out, ref, SEQ_FWD_ATOL)
        checks = [_close(torch, g, r, SEQ_GRAD_ATOL, SEQ_GRAD_RTOL)
                  for g, r in zip(grads, ref_grads)]
        ok_g, err_g = all(c[0] for c in checks), max(c[1] for c in checks)
        log(f"[mesh] (b) {scheme} attention at {SEQ_CHECK_SHAPE} f32 (blockwise: no sequence "
            f"axis) against the dense plain version: out max |diff| {err_f:.3e} (atol "
            f"{SEQ_FWD_ATOL}); dq, dk, dv max |diff| "
            + ", ".join(f"{c[1]:.3e}" for c in checks)
            + f" (atol {SEQ_GRAD_ATOL} + rtol {SEQ_GRAD_RTOL})")
        if not (ok_f and ok_g):
            raise RuntimeError(f"23(b): {scheme} attention is off the dense plain version")
        rows[scheme] = dict(fwd_err=err_f, grad_err=err_g)
        rows[f"{scheme}_layer"] = _seq_one_layer(torch, scheme, gen, device)
    # The ring's own turns (ops/ring_attention.py), SEQ_SHARDS shards each
    # a rank, run in lockstep on the card; the control is the same loop
    # with every visiting shard's kv_offset forced to 0.
    q, k, v, w = (torch.randn(b, t, h, d, device=device, generator=gen) for _ in range(4))
    ref, ref_grads = grads_of(lambda a, b_, c: dense_attention(a, b_, c, attention_mask=None),
                              (q, k, v), w)
    out, *grads = ring_attention.ring_turns_on_one_device(q, k, v, w, SEQ_SHARDS)
    ok_f, err = _close(torch, out, ref, SEQ_FWD_ATOL)
    checks = [_close(torch, g, r, SEQ_GRAD_ATOL, SEQ_GRAD_RTOL) for g, r in zip(grads, ref_grads)]
    real = ring_attention.chunk_scan
    ring_attention.chunk_scan = lambda *a, kv_offset, **kw: real(*a, kv_offset=0, **kw)
    try:
        broken = ring_attention.ring_turns_on_one_device(q, k, v, w, SEQ_SHARDS)[0]
    finally:
        ring_attention.chunk_scan = real
    bad_ok, bad_err = _close(torch, broken, ref, SEQ_FWD_ATOL)
    log(f"[mesh] (b) the ring's turns (ops/ring_attention.py) over {SEQ_SHARDS} shards of "
        f"{t // SEQ_SHARDS} in lockstep on the card against dense: out max |diff| {err:.3e} "
        f"(atol {SEQ_FWD_ATOL}); dq, dk, dv max |diff| "
        + ", ".join(f"{c[1]:.3e}" for c in checks)
        + f" (atol {SEQ_GRAD_ATOL} + rtol {SEQ_GRAD_RTOL}); control, the same loop with "
        f"kv_offset forced to 0: out max |diff| {bad_err:.3e}")
    if not (ok_f and all(c[0] for c in checks)):
        raise RuntimeError("23(b): the ring's turns are off the dense plain version")
    if bad_ok:
        raise RuntimeError("23(b): the kv_offset control passed the check")
    rows["ring_turns"] = dict(err=err, grad_err=max(c[1] for c in checks), control_err=bad_err)
    return rows


def _seq_one_layer(torch, scheme: str, gen, device: str) -> dict:
    """23(b): one attention layer of the cell's width under ``scheme``
    against the same layer (same weights) under dense attention, in f32:
    the output within SEQ_FWD_ATOL, the input's gradient within
    SEQ_GRAD_ATOL + SEQ_GRAD_RTOL elementwise, each projection parameter's
    gradient within SEQ_GRAD_ATOL + SEQ_GRAD_RTOL x its largest element
    (their f32 sums over B x T tokens near cancellation missed the
    elementwise band by 1.3-2.4e-5 on 5 of qkv_proj's 1.77M weight
    gradients, PERF.md §6; the count outside it is printed)."""
    from llmtrain_tpu_torch.models.gpt import CausalSelfAttention

    b, t, h, d = SEQ_CHECK_SHAPE
    layers = []
    for attention in (scheme, "dense"):
        torch.manual_seed(SEQ_LAYER_SEED)
        layers.append(CausalSelfAttention(h * d, h, dtype=torch.float32,
                                          param_dtype=torch.float32,
                                          attention=attention).to(device))
    layers[1].load_state_dict(layers[0].state_dict())
    x, w = (torch.randn(b, t, h * d, device=device, generator=gen) for _ in range(2))
    results = []
    for layer in layers:
        xi = x.clone().requires_grad_()
        out = layer(xi)
        (out * w).sum().backward()
        results.append((out.detach(), xi.grad, {n: p.grad for n, p in layer.named_parameters()}))
    (out, dx, pg), (ref, ref_dx, ref_pg) = results
    ok, err_f = _close(torch, out, ref, SEQ_FWD_ATOL)
    ok_x, err_x = _close(torch, dx, ref_dx, SEQ_GRAD_ATOL, SEQ_GRAD_RTOL)
    ok = ok and ok_x
    parts = [f"out {err_f:.3e}", f"dx {err_x:.3e}"]
    for name, g in pg.items():
        want = ref_pg[name]
        band = SEQ_GRAD_ATOL + SEQ_GRAD_RTOL * float(want.abs().max())
        good, err = _close(torch, g, want, band)
        elementwise = int(((g - want).abs() > SEQ_GRAD_ATOL + SEQ_GRAD_RTOL * want.abs()).sum())
        parts.append(f"{name} {err:.3e} (band {band:.3e}; {elementwise} of {g.numel()} outside "
                     f"the elementwise band)")
        ok = ok and good
    log(f"[mesh] (b) one {scheme} attention layer ({h * d} wide, {h} heads) at B={b}, T={t} f32 "
        f"against the same layer under dense attention: max |diff| " + "; ".join(parts))
    if not ok:
        raise RuntimeError(f"23(b): the {scheme} attention layer is off the dense one")
    return dict(out_err=err_f, dx_err=err_x)


def _eval_batches(cfg_path: Path) -> int:
    """The eval batches of a config's one validation pass on one rank."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.data.local_text import LocalTextDataModule
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer

    cfg, _, _ = load_and_validate_config(cfg_path)
    dm = LocalTextDataModule()
    dm.setup(cfg, ByteTokenizer())
    return -(-len(dm.val_dataset()) // cfg.trainer.micro_batch_size)


def _seq_train(torch, smi: str, tmp: Path) -> dict:
    """23(b)'s trainings."""
    import yaml

    runs = {}
    counts = None
    for attention in ("ring", "ulysses", "flash"):
        path = _smoke_config(tmp, f"seq_{attention}")
        raw = yaml.safe_load(path.read_text())
        raw["model"].update(block_size=SEQ_BLOCK, n_layers=SEQ_LAYERS, attention=attention)
        raw["trainer"].update(max_steps=SEQ_STEPS, warmup_steps=SEQ_WARMUP,
                              micro_batch_size=SEQ_MICRO, eval_every_steps=SEQ_STEPS,
                              save_every_steps=SEQ_STEPS)
        path.write_text(yaml.safe_dump(raw, sort_keys=False))
        torch.cuda.empty_cache()
        _reset_counts()
        code, out = _run_cli(["train", "--config", str(path), "--run-id", f"seq_{attention}",
                              "--json"])
        got = _read_counts()
        if code != 0:
            raise RuntimeError(f"23(b): {attention} train exited {code}")
        summary = json.loads(out)["train_result"]
        steps = _logged_steps(tmp / "runs" / f"seq_{attention}")
        losses = [steps[i]["loss"] for i in sorted(steps)]
        s = _steady(steps)
        if attention == "flash":
            _check_counts("seq flash", got, {
                "flash_attention_fwd": SEQ_LAYERS * (SEQ_STEPS + _eval_batches(path)),
                "flash_attention_bwd_dq": SEQ_LAYERS * SEQ_STEPS,
                "flash_attention_bwd_dkdv": SEQ_LAYERS * SEQ_STEPS,
            })
        else:
            _check_counts(f"seq {attention}", got, {})
        counts = got if counts is None else {k: counts[k] + got[k] for k in got}
        log(f"[mesh] (b) {attention} at block {SEQ_BLOCK}, {SEQ_LAYERS} layers of the cell, micro "
            f"batch {SEQ_MICRO}: losses {' '.join(f'{x:.4f}' for x in losses)}; step "
            f"{s['step_time'] * 1e3:.1f} ms (median of steps 2-{SEQ_STEPS - 1}), "
            f"{s['tokens_per_sec']:.0f} tokens/s, peak memory "
            f"{summary['peak_memory'] / 2**30:.2f} GiB on {smi}")
        if (len(losses) != SEQ_STEPS or not all(math.isfinite(x) for x in losses)
                or not losses[-1] < losses[0]):
            raise RuntimeError(f"23(b): {attention}'s losses are not finite and falling")
        runs[attention] = dict(step_ms=s["step_time"] * 1e3, peak=summary["peak_memory"],
                               losses=losses)
    return dict(runs=runs, counts=counts)


def phase_mesh(torch, smi: str, tmp: Path, ddp: dict) -> dict:
    """Phase 23 (module doc): (a) the one-rank mesh, (b) ring and ulysses
    at one device. Returns the launch counts of its paths."""
    t0 = time.perf_counter()
    one = _mesh_one_rank(torch, smi, tmp, ddp)
    checks = _seq_layer_checks(torch, smi)
    seq = _seq_train(torch, smi, tmp)
    runs = seq["runs"]
    counts = {k: one["counts"][k] + seq["counts"][k] for k in one["counts"]}
    seconds = time.perf_counter() - t0
    log(f"[mesh] phase 23 in {seconds:.1f} s on {smi}; blockwise against flash at block "
        f"{SEQ_BLOCK}: ring {runs['ring']['step_ms']:.1f} ms, {runs['ring']['peak'] / 2**30:.2f} "
        f"GiB; ulysses {runs['ulysses']['step_ms']:.1f} ms, "
        f"{runs['ulysses']['peak'] / 2**30:.2f} GiB; flash {runs['flash']['step_ms']:.1f} ms, "
        f"{runs['flash']['peak'] / 2**30:.2f} GiB; launches {counts}")
    return dict(one=one, checks=checks, runs=runs, counts=counts, seconds=seconds)


PIPE_STEPS = 6
PIPE_WARMUP = PIPE_STEPS
PIPE_CHECK_BATCH = 8  # rows of 24(b)'s schedule checks (4 microbatches of 2)
PIPE_SCHEDULES = (("gpipe", 4, 1), ("interleaved", 2, 2))  # name, stages, chunks a stage
PIPE_MICRO = 4
# 24(b)'s band, f32 with TF32 off, the schedule against the sequential
# stack on the card (PERF.md §6, written before the first call): the
# forward within PIPE_FWD_RTOL of the output's largest element, every
# gradient (each stacked parameter and the input) within 1e-5 +
# PIPE_GRAD_RTOL x its largest element (23(b)'s normwise rule). The two
# sides differ in the GEMMs' row counts (a microbatch against the whole
# batch) and in the order the backward sums the microbatches.
PIPE_FWD_RTOL = 1e-5
PIPE_GRAD_RTOL = 1e-4
# The broken control (every hop two stages on) must miss the forward band
# by this factor or more.
PIPE_CONTROL_FACTOR = 100.0
PIPE_PROMPT = "def "
PIPE_NEW_TOKENS = 48
PLAN_OVER_LIMIT_MICRO = 4096  # micro batch whose predicted memory is over the card's
TUNE_PRESET = "gpt_tune_smoke"


def _pipe_config(tmp: Path, name: str, *, steps: int) -> Path:
    """Phase 9's config as ``gpt_pipeline`` (one rank: the whole stack on
    the card), cut to ``steps`` steps with an eval and a save at the end."""
    import yaml

    path = _smoke_config(tmp, name)
    raw = yaml.safe_load(path.read_text())
    raw["model"]["name"] = "gpt_pipeline"
    raw["trainer"].update(max_steps=steps, warmup_steps=PIPE_WARMUP, eval_every_steps=steps,
                          save_every_steps=steps)
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _pipe_train(torch, smi: str, tmp: Path, train: dict | None) -> dict:
    """24(a) and (c)."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.interop import params_to_torch_state_dict, state_dict_to_flax_params
    from llmtrain_tpu_torch.registry import get_model_adapter, initialize_registries

    t0 = time.perf_counter()
    gpt_path = train["cfg_path"] if train else _smoke_config(tmp, "gpt_pycorpus_smoke")
    pipe_path = _pipe_config(tmp, "pipe", steps=PIPE_STEPS)
    gpt_cfg, _, _ = load_and_validate_config(gpt_path)
    initialize_registries()
    # Phase 9's initial weights, as the reference torch GPT file
    # export-checkpoint writes, imported into the pipeline config.
    gpt = get_model_adapter("gpt")().build_model(gpt_cfg, torch.device("cuda"))
    init = {k: torch.from_numpy(v) for k, v in params_to_torch_state_dict(
        state_dict_to_flax_params(gpt.state_dict(), n_heads=gpt_cfg.model.n_heads)).items()}
    del gpt
    torch.save(init, tmp / "pipe_init.pt")
    # Without phase 9 the GPT's first step runs here, from the same file.
    imports = [(pipe_path, "pipe_init")] + ([] if train else [(gpt_path, "gpt_init")])
    for cfg_path, out in imports:
        code, _ = _run_cli(["import-checkpoint", "--config", str(cfg_path), "--input",
                            str(tmp / "pipe_init.pt"), "--output", str(tmp / out)])
        if code != 0:
            raise RuntimeError(f"24(a): import-checkpoint into {cfg_path.name} exited {code}")
    if train:
        gpt_first = train["steps"][1]["loss"]
    else:
        code, _ = _run_cli(["train", "--config", str(gpt_path), "--run-id", "gpt_first",
                            "--resume", str(tmp / "gpt_init"), "--json"])
        if code != 0:
            raise RuntimeError(f"24(a): the GPT's first step exited {code}")
        gpt_first = _logged_steps(tmp / "runs" / "gpt_first")[1]["loss"]
    t_setup = time.perf_counter() - t0
    eval_batches = _eval_batches(pipe_path)
    torch.cuda.empty_cache()
    _reset_counts()  # the pipeline run's counts start here
    code, out = _run_cli(["train", "--config", str(pipe_path), "--run-id", "pipe",
                          "--resume", str(tmp / "pipe_init"), "--json"])
    counts = _read_counts()  # and end here
    t_train = time.perf_counter() - t0 - t_setup
    if code != 0:
        raise RuntimeError(f"24(a): gpt_pipeline train exited {code}")
    summary = json.loads(out)["train_result"]
    run_dir = tmp / "runs" / "pipe"
    steps = _logged_steps(run_dir)
    losses = [steps[i]["loss"] for i in sorted(steps)]
    layers = gpt_cfg.model.n_layers
    _check_counts("pipe train", counts, {
        "flash_attention_fwd": layers * (PIPE_STEPS + eval_batches),
        "flash_attention_bwd_dq": layers * PIPE_STEPS,
        "flash_attention_bwd_dkdv": layers * PIPE_STEPS,
    })
    s = _steady(steps)
    first_diff = abs(losses[0] - gpt_first)
    beside = (f"phase 9's GPT cell {train['step_ms']:.1f} ms, "
              f"{train['summary']['peak_memory'] / 2**30:.2f} GiB" if train
              else "phase 9 not run")
    log(f"[pipe] (a) gpt_pipeline at the cell's width and depth, one rank, from phase 9's "
        f"init: losses {' '.join(f'{x:.4f}' for x in losses)}; step 1 {losses[0]:.6f} against "
        f"the GPT's {gpt_first:.6f} (diff {first_diff:.2e}, band {FUSED_ATOL}); step "
        f"{s['step_time'] * 1e3:.1f} ms (median of steps 2-{PIPE_STEPS - 1}), "
        f"{s['tokens_per_sec']:.0f} tokens/s, MFU {s['mfu']:.4f}, peak memory "
        f"{summary['peak_memory'] / 2**30:.2f} GiB ({beside}) on {smi}")
    if (len(losses) != PIPE_STEPS or not all(math.isfinite(x) for x in losses)
            or not losses[-1] < losses[0]):
        raise RuntimeError(f"24(a): the losses are not finite and falling: {losses}")
    if first_diff > FUSED_ATOL:
        raise RuntimeError(f"24(a): step 1's loss misses the GPT's by {first_diff}")

    # (c) `generate` from the pipeline checkpoint against generate() of the
    # same weights saved as gpt: export-checkpoint's reference torch GPT
    # file, loaded into phase 9's GPT.
    code, _ = _run_cli(["export-checkpoint", "--config", str(pipe_path), "--from", str(run_dir),
                        "--output", str(tmp / "pipe_final.pt")])
    if code != 0:
        raise RuntimeError(f"24(c): export-checkpoint exited {code}")
    code, out = _run_cli(["generate", "--config", str(pipe_path), "--from", str(run_dir),
                          "--prompt", PIPE_PROMPT, "--max-new-tokens", str(PIPE_NEW_TOKENS),
                          "--temperature", "0", "--json"])
    if code != 0:
        raise RuntimeError(f"24(c): generate from {run_dir} exited {code}")
    completions = [json.loads(out)["completion_ids"],
                   _exported_generate(torch, gpt_cfg, tmp / "pipe_final.pt")]
    same = completions[0] == completions[1] and len(completions[0]) == PIPE_NEW_TOKENS
    log(f"[pipe] (c) generate {PIPE_PROMPT!r} + {PIPE_NEW_TOKENS} greedy from the pipeline "
        f"checkpoint and from its weights saved as gpt: bitwise {same}; seconds: the init's "
        f"import {t_setup:.1f}, train {t_train:.1f}, (c) "
        f"{time.perf_counter() - t0 - t_setup - t_train:.1f}")
    if not same:
        raise RuntimeError(f"24(c): the completions differ: {completions}")
    return dict(counts=counts, step_ms=s["step_time"] * 1e3, peak=summary["peak_memory"],
                losses=losses, first_diff=first_diff, pipe_path=pipe_path)


def _exported_generate(torch, cfg, path: Path) -> list[int]:
    """generate() greedy of PIPE_PROMPT on the GPT of ``cfg`` holding a
    reference torch GPT file's weights, cast for decoding as `generate`
    casts them."""
    import logging

    import numpy as np

    from llmtrain_tpu_torch.cli import prepare_decode_model
    from llmtrain_tpu_torch.data.tokenizers import ByteTokenizer
    from llmtrain_tpu_torch.generation import generate
    from llmtrain_tpu_torch.interop import (
        flax_params_to_state_dict,
        params_from_torch_state_dict,
        state_dict_to_flax_params,
    )
    from llmtrain_tpu_torch.registry import get_model_adapter

    model = get_model_adapter("gpt")().build_model(cfg, torch.device("cuda"))
    template = state_dict_to_flax_params(model.state_dict(), n_heads=cfg.model.n_heads)
    raw = {k: v.float().numpy() for k, v in torch.load(path, weights_only=True).items()}
    model.load_state_dict(flax_params_to_state_dict(params_from_torch_state_dict(raw, template)))
    model = prepare_decode_model(model, "compute", logging.getLogger("llmtrain"))
    tokenizer = ByteTokenizer()
    ids = np.asarray([tokenizer.encode(PIPE_PROMPT)], np.int32)
    out = generate(model, ids, max_new_tokens=PIPE_NEW_TOKENS, temperature=0.0,
                   eos_token_id=getattr(tokenizer, "eot_token", None))
    return [int(t) for t in np.asarray(out)[0, ids.shape[1]:]]


def _pipe_schedules(torch, smi: str, pipe_path: Path) -> dict:
    """24(b): the schedule's stages in lockstep on the card against the
    sequential stack, and its broken control."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.models.gpt_pipeline import make_stage_fn
    from llmtrain_tpu_torch.parallel import pipeline
    from llmtrain_tpu_torch.registry import get_model_adapter

    cfg, _, _ = load_and_validate_config(pipe_path)
    model = get_model_adapter("gpt_pipeline")().build_model(cfg, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(24)
    blocks = {n: p.detach().float().requires_grad_() for n, p in model.blocks().items()}
    ids = torch.randint(0, cfg.model.vocab_size or 256, (PIPE_CHECK_BATCH, cfg.model.block_size),
                        generator=gen, device="cuda")
    with torch.no_grad():
        x0 = (model.token_embedding.weight[ids]
              + model.position_embedding.weight[:cfg.model.block_size]).float()
    cot = torch.randn(x0.shape, generator=gen, device="cuda")
    del model
    stage_fn = make_stage_fn(attention="flash", dtype=torch.float32)
    names = list(blocks)
    layers = cfg.model.n_layers

    def run(fn):
        x = x0.clone().requires_grad_()
        y = fn(x)
        grads = torch.autograd.grad((y * cot).sum(), [x, *blocks.values()])
        return y.detach(), dict(zip(["x", *names], grads))

    _reset_counts()  # the schedules' counts start here
    ref_y, ref_g = run(lambda x: stage_fn(blocks, x))
    results, expect = {}, {"flash_attention_fwd": layers, "flash_attention_bwd_dq": layers,
                           "flash_attention_bwd_dkdv": layers}
    for name, stages, chunks in PIPE_SCHEDULES:
        y, g = run(lambda x: pipeline.gpipe_on_one_device(
            stage_fn, blocks, x, stages, n_microbatches=PIPE_MICRO, virtual_chunks=chunks))
        fwd = float((y - ref_y).abs().max())
        fwd_band = PIPE_FWD_RTOL * float(ref_y.abs().max())
        worst = {}
        for k, want in ref_g.items():
            diff = float((g[k] - want).abs().max())
            worst[k] = (diff, 1e-5 + PIPE_GRAD_RTOL * float(want.abs().max()))
        results[name] = dict(fwd=fwd, fwd_band=fwd_band, grads=worst)
        # Each layer once a microbatch forward, again in the backward's
        # recompute (remat_stage), and once a microbatch in the backward.
        expect = {k: v + layers * PIPE_MICRO * (2 if k == "flash_attention_fwd" else 1)
                  for k, v in expect.items()}
        log(f"[pipe] (b) {name} ({stages} stages x {chunks} chunk(s), {PIPE_MICRO} microbatches, "
            f"{PIPE_CHECK_BATCH}x{cfg.model.block_size} tokens, f32) against the sequential "
            f"stack: forward {fwd:.2e} (band {fwd_band:.2e}); gradients "
            + ", ".join(f"{k} {d:.2e}/{b:.2e}" for k, (d, b) in worst.items()) + f" on {smi}")
        if fwd > fwd_band or any(d > b for d, b in worst.values()):
            raise RuntimeError(f"24(b): the {name} schedule misses its band: {results[name]}")
    # The broken control: every hop two stages on. Each stage's layer rows
    # rotated by two stages do to the activations what such hops would:
    # they visit the stages in the order 2, 3, 0, 1.
    shift = 2 * layers // 4
    with torch.no_grad():
        broken = pipeline.gpipe_on_one_device(
            stage_fn, {n: p.roll(shift, 0) for n, p in blocks.items()}, x0, 4,
            n_microbatches=PIPE_MICRO)
    expect["flash_attention_fwd"] += layers * PIPE_MICRO
    control = float((broken - ref_y).abs().max())
    band = results["gpipe"]["fwd_band"]
    counts = _read_counts()  # and end here
    log(f"[pipe] (b) control, every hop two stages on: forward {control:.2e} against the "
        f"band {band:.2e} ({control / band:.1e}x)")
    if not control > PIPE_CONTROL_FACTOR * band:
        raise RuntimeError(f"24(b): the broken control lands at {control}, within "
                           f"{PIPE_CONTROL_FACTOR}x the band {band}")
    _check_counts("pipe schedules", counts, expect)
    return dict(results=results, control=control, counts=counts)


def phase_pipeline(torch, smi: str, tmp: Path, train: dict | None) -> dict:
    """Phase 24 (module doc): gpt_pipeline on the card, the schedules
    against the sequential stack, generate from its checkpoint. Returns
    its paths' launch counts."""
    t0 = time.perf_counter()
    trained = _pipe_train(torch, smi, tmp, train)
    sched = _pipe_schedules(torch, smi, trained["pipe_path"])
    counts = {k: trained["counts"][k] + sched["counts"][k] for k in trained["counts"]}
    seconds = time.perf_counter() - t0
    log(f"[pipe] phase 24 in {seconds:.1f} s on {smi}; launches {counts}")
    return dict(trained=trained, sched=sched, counts=counts, seconds=seconds)


TUNE_TIMEOUT_SEC = 600


def start_tune(tmp: Path) -> dict:
    """Phase 25's `tune` on gpt_tune_smoke as a child process in its own
    session (its probes are its children), so it can run beside other
    phases' children (PERF.md §2)."""
    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs" / "presets" / f"{TUNE_PRESET}.yaml").read_text())
    raw["run"]["device"] = "cuda"
    raw["output"]["root_dir"] = str(tmp / "runs")
    cfg = tmp / "tune.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out, err = open(tmp / "tune.out", "w"), open(tmp / "tune.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "tune", "--config", str(cfg), "--workdir",
         str(tmp / "tune"), "--output", str(tmp / "tuned.yaml"), "--json"],
        cwd=root, stdout=out, stderr=err, text=True, start_new_session=True)
    out.close()
    err.close()
    return dict(proc=proc, tmp=tmp, raw=raw, t0=time.perf_counter())


def stop_child(child: dict | None) -> None:
    """Stop a phase's child process (tune, the storm) and its own children
    if still running."""
    import os
    import signal

    if child is not None and child["proc"].poll() is None:
        os.killpg(child["proc"].pid, signal.SIGKILL)
        child["proc"].wait(timeout=30)


def _finish_tune(tune: dict, smi: str) -> dict:
    """25's gates on the tune child's report: the baseline probed, the
    winner's MFU at least the baseline's, the emitted config training one
    step."""
    import yaml

    tmp, raw = tune["tmp"], tune["raw"]
    try:
        code = tune["proc"].wait(timeout=TUNE_TIMEOUT_SEC)
    finally:
        stop_child(tune)
    if code != 0:
        raise RuntimeError(f"25: tune exited {code}: {(tmp / 'tune.err').read_text()[-2000:]}")
    report = json.loads((tmp / "tune.out").read_text())
    baseline, winner = report["baseline"], report["winner"]
    log(f"[autotune] tune {TUNE_PRESET} (max_probes {raw['tune']['max_probes']}, probe_steps "
        f"{raw['tune']['probe_steps']}): {report['enumerated']} candidates, "
        f"{len(report['pruned'])} pruned, probes "
        + ", ".join(f"{m['key']} {m['status']}" + (f" mfu {m['mfu']:.3e}" if "mfu" in m else "")
                    for m in report["measured"])
        + f"; winner {winner['key']} in {report['elapsed_sec']:.1f} s on {smi} (child wall "
        f"{time.perf_counter() - tune['t0']:.1f} s)")
    if baseline.get("status") != "ok" or winner.get("status") != "ok" \
            or winner["mfu"] < baseline["mfu"]:
        raise RuntimeError(f"25: tune's winner {winner} is not at least the baseline {baseline}")
    raw = yaml.safe_load((tmp / "tuned.yaml").read_text())
    raw["trainer"].update(max_steps=1, warmup_steps=0)
    one = tmp / "tuned_one.yaml"
    one.write_text(yaml.safe_dump(raw, sort_keys=False))
    code, out = _run_cli(["train", "--config", str(one), "--run-id", "tuned", "--json"])
    if code != 0 or not math.isfinite(json.loads(out)["train_result"]["final_loss"]):
        raise RuntimeError(f"25: the emitted config's one step exited {code}")
    log("[autotune] the emitted config trained one step")
    return report


def phase_autotune(torch, smi: str, tmp: Path, train: dict | None,
                   tune: dict | None = None) -> dict:
    """Phase 25 (module doc): plan on the byte cell, plan over the card's
    memory, and the tune (``tune``: started earlier by start_tune, else
    here) with the emitted config trained."""
    t0 = time.perf_counter()
    own = tune is None
    tune = tune or start_tune(tmp)
    try:
        predicted = _plan_checks(tmp, train)
        report = _finish_tune(tune, smi)
    finally:
        if own:
            stop_child(tune)
    seconds = time.perf_counter() - t0
    log(f"[autotune] phase 25 in {seconds:.1f} s")
    return dict(predicted=predicted, winner=report["winner"], seconds=seconds)


def _plan_checks(tmp: Path, train: dict | None) -> float:
    """25's `plan` on the byte cell (exit 0) and over the card's memory
    (exit 2); the cell's predicted bytes."""
    import yaml

    cell = train["cfg_path"] if train else _smoke_config(tmp, "gpt_pycorpus_smoke")
    code, out = _run_cli(["plan", "--config", str(cell), "--json"])
    if code != 0:
        raise RuntimeError(f"25: plan on the byte cell exited {code}")
    payload = json.loads(out)
    predicted = payload["predicted_hbm"]["total_bytes"]
    measured = (f"phase 9's measured peak {train['summary']['peak_memory'] / 2**30:.2f} GiB"
                if train else "phase 9 not run")
    log(f"[autotune] plan {payload['plan']['key']} on {payload['device_kind']}: predicted "
        f"{predicted / 2**30:.2f} GiB (activations "
        f"{payload['predicted_hbm']['activation_bytes'] / 2**30:.2f}, logits "
        f"{payload['predicted_hbm']['logits_bytes'] / 2**30:.2f}) against the limit "
        f"{payload['hbm_limit_bytes'] / 2**30:.1f} GiB, {measured}; roofline "
        f"{payload['roofline']['class']}")
    raw = yaml.safe_load(cell.read_text())
    raw["trainer"]["micro_batch_size"] = PLAN_OVER_LIMIT_MICRO
    over = tmp / "plan_over.yaml"
    over.write_text(yaml.safe_dump(raw, sort_keys=False))
    code, _ = _run_cli(["plan", "--config", str(over), "--json"])
    log(f"[autotune] plan at micro batch {PLAN_OVER_LIMIT_MICRO}: exit {code}")
    if code != 2:
        raise RuntimeError(f"25: plan over the card's memory exited {code}, not 2")
    return predicted


# -------------------------------------------- lifecycle and fleet (phase 26)
# Phase 26: (a) `promote` on a copy of phase 9's stream at full width: a
# poisoned step 30 (the model's seeded initialisation, committed through
# the port's CheckpointManager) canaried and rolled back by the eval gate,
# then step 40 (held back until the rollback lands) promoted to both
# replicas; (b) `fleet --storm` on the card over gpt_fleet_smoke at the
# byte cell's widths, a child process started with phase 20.
PROMOTE_POISON_STEP = 30
# gpt_promote_smoke polls every 2.0 s; the stream here is the smoke's own
# (0.5 s until phase 26's first whole run, PERF.md §2).
PROMOTE_POLL_SEC = 0.25
PROMOTE_TIMEOUT_SEC = 300
STORM_PRESET = "gpt_fleet_smoke"
STORM_LAYERS = 2  # the byte cell's 12
STORM_MICRO = 2  # gpt_fleet_smoke's global micro batch (the byte cell's 64)
STORM_SEED = 1
STORM_TIMEOUT_SEC = 600


def _promote_config(tmp: Path, train: dict) -> Path:
    """Phase 9's config with gpt_promote_smoke's serving and promote
    sections."""
    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load(Path(train["cfg_path"]).read_text())
    preset = yaml.safe_load((root / "configs/presets/gpt_promote_smoke.yaml").read_text())
    raw["serving"] = preset["serving"]
    raw["promote"] = {**preset["promote"], "poll_sec": PROMOTE_POLL_SEC}
    path = tmp / "promote.yaml"
    path.write_text(yaml.safe_dump(raw, sort_keys=False))
    return path


def _poison(torch, cfg_path: Path, ckpt_dir: Path) -> None:
    """Commit step PROMOTE_POISON_STEP into ``ckpt_dir``: the model as the
    run's seed initialises it (on the card, as the trainer does). Loadable
    by `eval` and the decode path, which read the params alone (its
    optimizer state is empty: the base's 0.65 GB cost a read and a write),
    finite, and far worse than the steps around it."""
    from llmtrain_tpu_torch.config import load_and_validate_config
    from llmtrain_tpu_torch.interop.flax_params import state_dict_to_flax_params
    from llmtrain_tpu_torch.models.lora import build_adapter
    from llmtrain_tpu_torch.training.checkpoint import CheckpointManager

    cfg, _, resolved = load_and_validate_config(cfg_path)
    model = build_adapter(cfg).build_model(cfg, torch.device("cuda"))
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    params = state_dict_to_flax_params(sd, n_heads=cfg.model.n_heads, n_kv_heads=0)
    CheckpointManager(ckpt_dir, keep_last_k=10).save_host(
        PROMOTE_POISON_STEP, {"params": params, "opt_state": {}}, resolved)


class _LiveStream(threading.Thread):
    """The training run that `promote` watches, played from files: a fresh
    heartbeat every PROMOTE_POLL_SEC; once the ledger holds the poisoned step's
    rollback, the held-back commit (payload first, manifest last) and then
    report.json."""

    def __init__(self, run_dir: Path, held: list[Path], report: bytes) -> None:
        super().__init__(name="promote-stream", daemon=True)
        self.run_dir, self.held, self.report = run_dir, held, report
        self.stop = threading.Event()
        self.released_at: float | None = None
        self.error: BaseException | None = None

    def _rolled_back(self) -> bool:
        try:
            lines = (self.run_dir / "promotions.jsonl").read_text().splitlines()
        except OSError:
            return False
        for line in lines:
            try:
                e = json.loads(line)
            except ValueError:
                continue
            if e.get("decision") == "rollback" and e.get("step") == PROMOTE_POISON_STEP:
                return True
        return False

    def run(self) -> None:
        import shutil

        try:
            while not self.stop.is_set():
                (self.run_dir / "heartbeat").write_text(str(time.time()))
                if self.released_at is None and self._rolled_back():
                    ckpt_dir = self.run_dir / "checkpoints"
                    for path in self.held:  # the manifest is the last of them
                        shutil.move(str(path), str(ckpt_dir / path.name))
                    (self.run_dir / "report.json").write_bytes(self.report)
                    self.released_at = time.perf_counter()
                self.stop.wait(PROMOTE_POLL_SEC)
        except BaseException as exc:  # noqa: BLE001 — reported by the phase
            self.error = exc


class _TimedEvaluate:
    """Times each `Trainer.evaluate` in this process (the promote
    controller's evaluator): (checkpoint, seconds) per call."""

    def __enter__(self):
        from llmtrain_tpu_torch.training import trainer

        self.cls, self.calls = trainer.Trainer, []
        self.orig = self.cls.evaluate

        def evaluate(trainer_self, resume_from=None, **kw):
            t0 = time.perf_counter()
            try:
                return self.orig(trainer_self, resume_from, **kw)
            finally:
                self.calls.append((Path(str(resume_from)).name, time.perf_counter() - t0))

        self.cls.evaluate = evaluate
        return self

    def __exit__(self, *exc) -> None:
        self.cls.evaluate = self.orig


def _promote_phase(torch, smi: str, tmp: Path, train: dict) -> dict:
    """26(a): `promote --from <step 20> --watch <copy of phase 9's run>`
    (a copy of hard links: nothing here writes into phase 9's files)."""
    import os
    import shutil

    t0 = time.perf_counter()
    run_dir = tmp / "promote_run"
    shutil.copytree(train["run_dir"], run_dir, copy_function=os.link)
    ckpt_dir = run_dir / "checkpoints"
    base = ckpt_dir / f"step_{TRAIN_SAVE_EVERY:06d}.ckpt"
    last = TRAIN_STEPS
    # Step 40 and report.json wait outside the stream until step 30 is judged.
    aside = tmp / "promote_held"
    aside.mkdir()
    held = []
    for suffix in (".ckpt", ".ckpt.sha256", ".manifest.json"):
        src = ckpt_dir / f"step_{last:06d}{suffix}"
        if src.exists():
            held.append(Path(shutil.move(str(src), str(aside / src.name))))
    report = (run_dir / "report.json").read_bytes()
    (run_dir / "report.json").unlink()
    for stale in run_dir.glob("heartbeat*"):
        stale.unlink()
    cfg_path = _promote_config(tmp, train)
    _poison(torch, cfg_path, ckpt_dir)
    torch.cuda.empty_cache()
    stream = _LiveStream(run_dir, held, report)
    stream.start()
    _reset_counts()  # the promote path's counts start here
    try:
        with _TimedEvaluate() as evals:
            code, out = _run_cli(["promote", "--config", str(cfg_path), "--watch", str(run_dir),
                                  "--from", str(base), "--max-promotions", "0",
                                  "--idle-timeout-sec", str(PROMOTE_TIMEOUT_SEC), "--json"])
    finally:
        stream.stop.set()
        stream.join(timeout=30)
    counts = _read_counts()  # and end here
    if stream.error is not None:
        raise RuntimeError(f"26(a): the stream's thread failed: {stream.error!r}")
    if code != 0:
        raise RuntimeError(f"26(a): promote exited {code}")
    result = json.loads(out.strip().splitlines()[-1])
    ledger = [json.loads(line) for line in
              (run_dir / "promotions.jsonl").read_text().splitlines()]
    decisions = [(e["decision"], e["step"]) for e in ledger]
    reasons = [(d, s, e["reason"]) for (d, s), e in zip(decisions, ledger)]
    log(f"[promote] {result}; ledger {reasons}")
    want = [("canary_start", PROMOTE_POISON_STEP), ("rollback", PROMOTE_POISON_STEP),
            ("canary_start", last), ("promote", last)]
    if result["status"] != "training_finished" or decisions != want \
            or not (ledger[1]["reason"] or "").startswith("eval_regression"):
        raise RuntimeError(f"26(a): the ledger reads {decisions} (status {result['status']}), "
                           f"not {want} with an eval regression")
    for e in ledger:
        for side in ("canary", "reference"):
            soak = e["scores"].get(side)
            if soak:
                log(f"[promote] step {e['step']} {e['decision']} {side} soak: "
                    f"{soak['completed']}/{soak['requests']} completed, TTFT p50 "
                    f"{soak['ttft_p50_ms']} ms p95 {soak['ttft_p95_ms']} ms, per-token p50 "
                    f"{soak['per_token_p50_ms']} ms p99 {soak['per_token_p99_ms']} ms")
                if soak["failed"] or soak["timed_out"]:
                    raise RuntimeError(f"26(a): a soak request failed: {soak}")
    swap = ledger[-1]["scores"]["fleet_swap"]
    if len(swap) != 2 or any(r.get("step") != last or "error" in r for r in swap):
        raise RuntimeError(f"26(a): the replicas did not both end at step {last}: {swap}")
    scores = {e["step"]: e["scores"].get("eval_loss") for e in ledger if e["scores"]}
    log(f"[promote] evals {[(name, round(s, 2)) for name, s in evals.calls]} s; eval losses "
        f"{scores}, baseline {ledger[1]['scores'].get('baseline_eval_loss')}")
    _check_counts("promote", counts, {
        "flash_attention_fwd": train["layers"] * train["eval_batches"] * len(evals.calls)})
    code, out = _run_cli(["goodput", "--run-dir", str(run_dir), "--json"])
    block = json.loads(out).get("promotions") if code == 0 else None
    if block is None or block["decisions"]["promote"] != 1 or block["decisions"]["rollback"] != 1:
        raise RuntimeError(f"26(a): goodput's promotions block is {block} (exit {code})")
    seconds = time.perf_counter() - t0
    log(f"[promote] on {smi}: {len(evals.calls)} evaluations, phase 26(a) {seconds:.1f} s")
    return dict(counts=counts, ledger=ledger, evals=evals.calls, seconds=seconds)


def start_storm(tmp: Path) -> dict:
    """26(b)'s `fleet --storm` as a child process in its own session (its
    tenants' ranks are its children), so it runs beside other phases'
    children: gpt_fleet_smoke on the card, the byte cell's widths at
    STORM_LAYERS layers, both tenants fixed at one rank."""
    import yaml

    root = Path(__file__).resolve().parent
    raw = yaml.safe_load((root / "configs/presets" / f"{STORM_PRESET}.yaml").read_text())
    cell = yaml.safe_load((root / "configs/presets/gpt_pycorpus_tpu.yaml").read_text())["model"]
    raw["run"]["device"] = "cuda"
    raw["model"] = {**cell, "n_layers": STORM_LAYERS}
    raw["trainer"]["micro_batch_size"] = STORM_MICRO
    for tenant in raw["fleet"]["tenants"]:
        tenant["max_devices"] = tenant["min_devices"] = 1  # one card holds one rank
    raw["output"]["root_dir"] = str(tmp / "runs")
    cfg = tmp / "storm.yaml"
    cfg.write_text(yaml.safe_dump(raw, sort_keys=False))
    out, err = open(tmp / "storm.out", "w"), open(tmp / "storm.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "llmtrain_tpu_torch", "fleet", "--config", str(cfg), "--storm",
         "--seed", str(STORM_SEED), "--work-dir", str(tmp / "storm"), "--timeout-sec",
         str(STORM_TIMEOUT_SEC), "--json"],
        cwd=root, stdout=out, stderr=err, text=True, start_new_session=True)
    out.close()
    err.close()
    return dict(proc=proc, tmp=tmp, raw=raw, t0=time.perf_counter())


def _finish_storm(storm: dict, smi: str) -> dict:
    """26(b)'s gates on the storm child's result: exit 0, every tenant
    completed with bitwise parity, an eviction, the mid-checkpoint kill, a
    capacity change, fleet_report.json written."""
    tmp = storm["tmp"]
    try:
        code = storm["proc"].wait(timeout=STORM_TIMEOUT_SEC + 60)
    finally:
        stop_child(storm)
    waited = time.perf_counter() - storm["t0"]
    if code != 0:
        raise RuntimeError(f"26(b): fleet --storm exited {code}: "
                           f"{(tmp / 'storm.err').read_text()[-3000:]}")
    result = json.loads((tmp / "storm.out").read_text().strip().splitlines()[-1])
    report = json.loads(Path(result["fleet_report_json"]).read_text())
    model = storm["raw"]["model"]
    log(f"[storm] {len(result['tenants'])} tenants at {model['d_model']} x "
        f"{model['n_layers']} layers ({model['attention']} attention) on {smi}: "
        f"{result['total_evictions']} evictions, {result['total_respawns']} respawns, "
        f"{result['capacity_changes']} capacity changes, mid-checkpoint kill on "
        f"{result['mid_checkpoint_kill_tenant']}; parity "
        f"{ {n: r['parity'] for n, r in result['tenants'].items()} }; storm "
        f"{result['wall_time_sec']} s (child {waited:.1f} s since its start)")
    states = {n: v["state"] for n, v in report["tenants"].items()}
    if not result["bitwise_match"] or result["total_evictions"] < 1 \
            or not result["mid_checkpoint_kill_tenant"] or result["capacity_changes"] < 1 \
            or any(s != "completed" for s in states.values()) \
            or any(r["parity"] != "bitwise" for r in result["tenants"].values()):
        raise RuntimeError(f"26(b): the storm did not prove its invariants: {result}, {states}")
    return dict(result=result, seconds=result["wall_time_sec"], waited=waited)


def phase_lifecycle(torch, smi: str, tmp: Path, train: dict, storm: dict | None) -> dict:
    """Phase 26 (module doc): the storm (started earlier by start_storm,
    else here) collected first, so that its children do not share the host
    with the soaks' latency gates; then `promote` on phase 9's stream."""
    t0 = time.perf_counter()
    own = storm is None
    storm = storm or start_storm(tmp)
    try:
        fleet = _finish_storm(storm, smi)
    finally:
        if own:
            stop_child(storm)
    promote = _promote_phase(torch, smi, tmp, train)
    seconds = time.perf_counter() - t0
    log(f"[lifecycle] phase 26 in {seconds:.1f} s")
    return dict(counts=promote["counts"], promote=promote, storm=fleet, seconds=seconds)


def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test needs a GPU",
              file=sys.stderr)
        return 1
    try:
        import llmtrain_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout ({exc})", file=sys.stderr)
        return 1
    smi = phase_device(torch)
    phase_build()
    clock("phases 1-2: device, build")
    fwd_errs = phase_kernel_checks(torch)
    bwd_errs = phase_bwd_checks(torch)
    clock("phase 3: flash checks")
    norm_errs = phase_norm_checks(torch)
    ce_errs = phase_ce_checks(torch)
    clock("phase 3: norm and CE checks")
    timing = phase_timing(torch, smi)
    train_timing = phase_timing(torch, smi, TRAIN_SHAPE, iters=20)
    gqa_timing = phase_timing(torch, smi, GQA_TRAIN_SHAPE, iters=20)
    bwd_timing = phase_bwd_timing(torch, smi)
    gqa_bwd_timing = phase_bwd_timing(torch, smi, GQA_TRAIN_SHAPE)
    norm_timing = phase_norm_timing(torch, smi)
    ce_timing = phase_ce_timing(torch, smi)
    clock("phase 4: timing")
    cfg, _, model = build_path_model(torch)
    phase_model(torch, model)
    from llmtrain_tpu_torch.ops.flash_attention import flash_attention_fwd

    flash_attention_fwd.launches = 0  # the serving path's count starts here
    phase_serve(torch, cfg, model, smi)
    phase_generate(torch, model, smi)
    serve_launches = flash_attention_fwd.launches  # and ends here
    log(f"[main path] serve + generate: flash_attention_fwd launches: {serve_launches}")
    if serve_launches == 0:
        raise RuntimeError("the serving path never launched the flash kernel")
    phase_profile(torch, model, smi)
    del model
    clock("phases 5-8: model, serve, generate, profile")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        train = phase_train(torch, smi, Path(tmp))
        clock("phase 9: train")
        fused = phase_fused_train(torch, smi, Path(tmp), train)
        phase_train_profile(torch, smi, train["cfg_path"])
        phase_train_profile(torch, smi, fused["cfg_path"])
        ce = phase_ce_train(torch, smi, Path(tmp), train["eval_batches"])
        phase_train_profile(torch, smi, ce["cfg_path"])
        clock("phases 10-13: fused-norm and CE trains, profiles")
        cont = phase_continuous(torch, smi, Path(tmp), train)
        clock("phase 14: continuous serving")
        spec = phase_speculative(torch, smi, Path(tmp), train, cont)
        clock("phase 15: speculative, int8, rolling")
        phase_fleet(torch, smi, Path(tmp), train, cont)
        clock("phase 16: fleet")
        offline = phase_offline(torch, smi, Path(tmp))
        clock("phase 17: offline")
        ddp = phase_ddp(torch, smi, Path(tmp))
        clock("phase 18: ddp, optimizers")
        tel = phase_telemetry(torch, smi, Path(tmp), train, ce)
        clock("phase 19: telemetry")
        children: list[dict] = []  # stopped whatever happens

        def beside() -> dict:
            # Phase 25's tune runs beside phase 20's children (PERF.md §2).
            children.append(start_tune(Path(tmp)))
            return children[-1]

        try:
            # Phase 26's storm starts with phase 20, before its guarded run:
            # the longest child gets the whole phase to hide in (PERF.md §2).
            storm = start_storm(Path(tmp))
            children.append(storm)
            res = phase_resilience(torch, smi, Path(tmp), train, beside=beside)
            tune = res["beside"]
            clock("phase 20: resilience")
            zoo = phase_zoo(torch, smi, Path(tmp))
            clock("phase 21: model zoo")
            par = phase_parallel(torch, smi, Path(tmp), train, ddp)
            clock("phase 22: parallelism on one device")
            mesh = phase_mesh(torch, smi, Path(tmp), ddp["ddp"])
            clock("phase 23: meshes at one rank")
            pipe = phase_pipeline(torch, smi, Path(tmp), train)
            clock("phase 24: the pipeline")
            tuned = phase_autotune(torch, smi, Path(tmp), train, tune)
            clock("phase 25: autotune")
            life = phase_lifecycle(torch, smi, Path(tmp), train, storm)
            clock("phase 26: lifecycle and fleet")
        finally:
            for child in children:
                stop_child(child)
    paths = (train["counts"], fused["counts"], ce["counts"], spec["counts"], offline["counts"],
             ddp["counts"], tel["counts"], res["counts"], zoo["counts"], par["counts"],
             mesh["counts"], pipe["counts"], life["counts"])
    launches = {name: sum(c[name] for c in paths) for name in paths[0]}
    launches["flash_attention_fwd"] += serve_launches
    log(f"[main path] launches over serve + generate, train, fused-norm train, CE train, "
        f"speculative/int8/rolling, BPE train and its evals, the one-rank NCCL train and its "
        f"EMA evals, phase 19's profile and telemetry runs, phase 20's guarded run, phase "
        f"21's model zoo, phase 22's quantized, tiered and ZeRO runs, phase 23's mesh "
        f"runs, phase 24's pipeline run and schedules and phase 26's promote evaluations: "
        f"{launches}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"the main path never launched {name}")
    csrc = "llmtrain_tpu_torch/csrc/"
    pallas = "llmtrain_tpu/ops/pallas_attention.py"
    kernels = [
        dict(name="flash_attention_fwd", route="cuda", source=csrc + "flash_attention_fwd.cu",
             replaces=f"{pallas}:186", max_abs_err=max(fwd_errs.values()),
             **{k: train_timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                             "library_ms")},
             serve_shape_ms=timing["ms"], serve_shape_plain_ms=timing["plain_ms"],
             serve_shape_library_ms=timing["library_ms"], serve_shape_bound_ms=timing["bound_ms"],
             window_shape_ms=spec["window_timing"]["ms"],
             window_shape_plain_ms=spec["window_timing"]["plain_ms"],
             window_shape_library_ms=spec["window_timing"]["library_ms"],
             window_shape_bound_ms=spec["window_timing"]["bound_ms"],
             window_shape_launches=spec["window_launches"],
             **{f"gqa_shape_{k}": gqa_timing[k] for k in ("ms", "plain_ms", "bound_ms",
                                                          "library_ms")}),
        dict(name="flash_attention_bwd_dq", route="cuda", source=csrc + "flash_attention_bwd.cu",
             replaces=f"{pallas}:278",
             max_abs_err=max(e["dq"] for e in bwd_errs.values()), **bwd_timing["dq"],
             **{f"gqa_shape_{k}": gqa_bwd_timing["dq"][k] for k in ("ms", "plain_ms",
                                                                    "bound_ms", "library_ms")}),
        dict(name="flash_attention_bwd_dkdv", route="cuda",
             source=csrc + "flash_attention_bwd.cu", replaces=f"{pallas}:358",
             max_abs_err=max(max(e["dk"], e["dv"]) for e in bwd_errs.values()),
             **bwd_timing["dkdv"],
             **{f"gqa_shape_{k}": gqa_bwd_timing["dkdv"][k] for k in ("ms", "plain_ms",
                                                                      "bound_ms",
                                                                      "library_ms")}),
        dict(name="fused_norm_fwd", route="triton", source="llmtrain_tpu_torch/ops/fused_norm.py",
             replaces="llmtrain_tpu/ops/fused_norm.py:110",
             max_abs_err=max(e["fwd"] for e in norm_errs.values()), **norm_timing["fwd"]),
        dict(name="fused_norm_bwd", route="cuda", source=csrc + "fused_norm_bwd.cu",
             replaces="llmtrain_tpu/ops/fused_norm.py:158",
             max_abs_err=max(e["bwd"] for e in norm_errs.values()), **norm_timing["bwd"]),
        dict(name="fused_ce_fwd", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:146",
             max_abs_err=max(e["fwd"] for e in ce_errs.values()), **ce_timing["fwd"]),
        dict(name="fused_ce_bwd_dh", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:194",
             max_abs_err=max(e["dh"] for e in ce_errs.values()), **ce_timing["dh"]),
        dict(name="fused_ce_bwd_dw", route="cuda", source=csrc + "fused_ce.cu",
             replaces="llmtrain_tpu/ops/fused_ce.py:212",
             max_abs_err=max(e["dw"] for e in ce_errs.values()), **ce_timing["dw"]),
    ]
    for k in kernels:
        k["launches"] = launches[k["name"]]
    log(f"[train] step {train['step_ms']:.1f} ms, {train['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {train['mfu']:.4f}, peak memory {train['summary']['peak_memory'] / 2**30:.2f} GiB")
    log(f"[fused] step {fused['step_ms']:.1f} ms, {fused['tokens_per_sec']:.0f} tokens/s, "
        f"peak memory {fused['summary']['peak_memory'] / 2**30:.2f} GiB")
    log(f"[ce-train] step {ce['step_ms']:.1f} ms, {ce['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {ce['mfu']:.4f}, peak memory {ce['summary']['peak_memory'] / 2**30:.2f} GiB "
        f"(dense {ce['dense']['peak_memory'] / 2**30:.2f} GiB)")
    bpe = offline["train"]
    log(f"[offline] BPE step {bpe['step_ms']:.1f} ms, {bpe['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {bpe['mfu']:.4f}, peak memory {bpe['summary']['peak_memory'] / 2**30:.2f} GiB; "
        f"{bpe['corpus_bytes']} corpus bytes tokenized in {bpe['tokenize_s']:.2f} s "
        f"({bpe['encoder']} encoder); eval {offline['eval']:.6f}, int8 {offline['int8']:.6f}, "
        f"soup {offline['soup']:.6f}")
    one, base = ddp["ddp"]["one"], ddp["ddp"]["base"]
    log(f"[ddp] one-rank NCCL step {one['step_time'] * 1e3:.1f} ms against the plain "
        f"{base['step_time'] * 1e3:.1f} ms; adafactor state "
        f"{ddp['optim']['adafactor']['state_bytes']} bytes, lion "
        f"{ddp['optim']['lion']['state_bytes']}; phase 18 {ddp['seconds']:.1f} s")
    log(f"[telemetry] step with telemetry off {tel['medians']['off']:.2f} ms, on "
        f"{tel['medians']['on']:.2f} ms; phase 9 goodput_frac {tel['ledger']['goodput_frac']}; "
        f"phase 19 {tel['seconds']:.1f} s")
    log(f"[resilience] guarded step {res['rollback']['guarded_ms']:.1f} ms against phase 9's "
        f"{res['rollback']['plain_ms']:.1f} ms; phase 20 {res['seconds']:.1f} s")
    llama = zoo["llama"]
    log(f"[zoo] llama step {llama['step_ms']:.1f} ms, {llama['tokens_per_sec']:.0f} tokens/s, "
        f"MFU {llama['mfu']:.4f}, peak memory {llama['summary']['peak_memory'] / 2**30:.2f} GiB "
        f"(GPT cell {train['step_ms']:.1f} ms); phase 21 {zoo['seconds']:.1f} s")
    quant, ladders, zero = par["quant"], par["ladders"], par["zero"]
    log(f"[parallel] int8 step {quant['int8']['step_ms']:.1f} ms, fp8 "
        f"{quant['fp8']['step_ms']:.1f} ms (phase 9 {train['step_ms']:.1f} ms); ladder peaks "
        + ", ".join(f"{k} {v['peak'] / 2**30:.3f} GiB" for k, v in ladders.items())
        + "; ZeRO steps " + ", ".join(f"{k} {v['step_ms']:.1f} ms" for k, v in zero.items())
        + f"; phase 22 {par['seconds']:.1f} s")
    runs = mesh["runs"]
    log(f"[mesh] one-rank mesh step {mesh['one']['step_ms']:.1f} ms; at block {SEQ_BLOCK} ring "
        f"{runs['ring']['step_ms']:.1f} ms, ulysses {runs['ulysses']['step_ms']:.1f} ms, flash "
        f"{runs['flash']['step_ms']:.1f} ms; phase 23 {mesh['seconds']:.1f} s")
    trained = pipe["trained"]
    log(f"[pipe] gpt_pipeline step {trained['step_ms']:.1f} ms, peak memory "
        f"{trained['peak'] / 2**30:.2f} GiB (GPT cell {train['step_ms']:.1f} ms); step 1 "
        f"{trained['first_diff']:.2e} off the GPT's; phase 24 {pipe['seconds']:.1f} s")
    log(f"[autotune] plan predicts {tuned['predicted'] / 2**30:.2f} GiB against phase 9's "
        f"{train['summary']['peak_memory'] / 2**30:.2f} GiB; tune winner {tuned['winner']['key']}"
        f"; phase 25 {tuned['seconds']:.1f} s")
    storm_result = life["storm"]["result"]
    log(f"[lifecycle] promote: step {PROMOTE_POISON_STEP} rolled back, step {TRAIN_STEPS} "
        f"promoted, {len(life['promote']['evals'])} evaluations; storm: "
        f"{storm_result['total_evictions']} evictions, {storm_result['total_respawns']} "
        f"respawns in {life['storm']['seconds']} s; phase 26 {life['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # noqa: BLE001 — any phase failure fails the smoke test
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
