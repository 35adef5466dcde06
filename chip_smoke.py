#!/usr/bin/env python3
"""Smoke run of aha_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --phases 1,2   # device + kernel checks only
    python3 chip_smoke.py --phases 1,2,6 # + JAX's weights and the 7B fixture
    python3 chip_smoke.py --phases 1,2,7 # + multi-stream serving at B 8
    python3 chip_smoke.py --phases 1,2,8 # + the serving options (adapters, --w8a8)
    python3 chip_smoke.py --phases 1,2,9 # + the highlight chain (infer tvsum .. highlight)
    python3 chip_smoke.py --phases 1,2,10 # + the live datasets, demo, the judge, the towers
    python3 chip_smoke.py --phases 1,2,11 # + parallelism: sharded serving and training

Phases, one or more lines each:
  1. device: nvidia-smi name and power limit, torch / CUDA / nvcc versions,
     the kernels' build time (built from aha_tpu_torch/csrc at first use, one
     nvcc per source in parallel), and what ptxas said of the int8 and int4
     wgmma and decode kernels (registers by operand type and token tile) and
     of the vector quantiser (a spill, a remark that their products are
     serialised or a missing int8-activation instantiation fails the phase);
  2. each CUDA kernel against its plain PyTorch version on the card, at
     every shape the 7B paths of phases 4 and 5 hand it (all five matmul
     entries at the four layer products for each row count of PATH_M, lm_head
     at 1, 4 and 8 rows, the projector at 392 and 1568; int4_matmul and its
     transpose int4_matmul_t at the training sequence's 926 rows; int8_matmul,
     int4_matmul and int4_matmul_t at row counts that straddle the token tiles
     of their wgmma kernels, at long K across its splits, at G = 64 and 256 and
     at shapes only their earlier paths take (N = 136, K = 352, x 2 bytes off
     its buffer), each matmul case with the path its wrapper's plan chose
     checked and launched twice for equal bits; int4_matmul and int8_matmul
     (both operand types) at 1 .. 16 rows (their decode kernels) also at rows
     2, 3, 7, 15 and 16 of the layer (int4 at G = 64 and 256 too), with each row
     equal bit for bit to its one-row product and beside the kernel its plan
     chose there before (replaced_ms, timed and not counted); int8_matmul with
     int8 activations also across its s8 wgmma tiles (17, 127-129, 231-233,
     1568), at the fused width of --w8a8 (392 rows) and down's long K, each
     case on a Hopper path equal bit for bit to the plain version; both int8
     entries at the int8 tower's products (q/k/v/out, fc1, fc2 at a frame's 576
     rows and a 32-frame batch's 18,432) beside the dense tower's bf16
     torch.matmul (dense_bf16_ms), with a tower layer's sum; int4_matmul
     with int8 activations also at the decode rows (2, 3, 7, 15, 16, G = 64 and
     256) and across its s8 wgmma tiles (17, 23-25, 79-81, 231-233, 1568) and
     down's long K; both a8 entries on their Hopper paths timed beside the
     kernel their plan chose before (replaced_ms), the weight-only kernel at
     the same rows and the quantiser alone; every Hopper plan's shared memory
     checked against the kernel's own number; beside torch.matmul on a weight dequantised
     beforehand (the bf16 product alone, timed and used nowhere; layer and
     lm_head at 1, 4, 8 and 13 rows too) or torch._int_mm on int8 operands
     made beforehand (with int8 activations; int4 weights unpacked to
     int8), each timed from a replayed
     CUDA graph (device time: a launch under 100 us is shorter than the host's
     work to launch it) with a loop of plain calls beside it, and the sums of a
     decoder layer's four products and of the projector's two; the flash
     attention's forward and backward at T = 926, at ragged lengths, at
     T = 63, 64, 65 and 129 across its tile edges, at T = 4096, and with a
     padding mask, each launched twice for equal bits, beside
     scaled_dot_product_attention (with a padding mask: a boolean mask, causal
     and key-valid), which is timed and used nowhere (these
     two as device time from a replayed CUDA graph: the kernels are shorter
     than the host's work to launch them); the cached attention at every S of
     a write pass on the 7B's 2049-slot cache, either side of the tensor
     cores' 16 rows, across its slot tiles' and splits' edges, with keys in
     one split only and with a query that sees nothing (zeros), each with the
     path its plan chose, launched twice for equal bits and timed with the
     cache cycled through more copies than L2 holds; phases 4
     and 5 record the shapes and fail on one that was not checked here)
     (bf16: max|y - y_ref| <= 1e-2 * max|y_ref|, int4 with int8 activations
     too, whose quantiser is bit-equal to the plain one and whose group sums
     are exact; int8_matmul with int8 activations and int4's mma.sync path for
     them 2e-2) and
     at the B = 8 shapes of phase 7 (int8_matmul and int4_matmul at the layer's
     products at 32, 64, 392 and 1568 rows, int8's lm_head at 32 and 64, the
     cached attention at B 8, S 1 and 49: timed; every other width phase 7's
     passes give int8_matmul and the cached attention at B 8, and its projector
     rows: held against the plain version without timing), and at the rows of
     phase 9's query chunks (int8_matmul at the layer's products, the cached
     attention; held, not timed),
     at small ragged shapes and at phase 6's and 8b's f32 shapes (int8_matmul
     at the layer's products at 49, 59, 171, 196 and 220 rows, the lm_head's
     row, the projector's 392; int4_matmul at the layer's products at the same
     rows, G 128; from 17 rows on the wgmma kernels' f32 path, x split into
     three bf16 planes by split_bf16x3, each such case with the CUDA-core
     kernel its plan chose before (replaced_ms, timed and not counted), the
     library's f32 torch.matmul on a weight dequantised to f32 beforehand
     (TF32 off), a bound of three bf16 products and, beside it, the f32 peak's
     (f32_peak_bound_ms), and a decoder layer's sum; split_bf16x3 alone at
     those rows and widths, bit-equal to its plain version; the cached
     attention at S = 49, 59, 171 and 220) (f32: 1e-4 *
     max|y_ref|), with kernel and plain
     times (CUDA events; weights cycled through > L2 worth of copies), the
     bound (the larger of bytes moved / 3.35 TB/s and operations / the
     published dense peak of their type: 989 TFLOP/s bf16, 1979 TOP/s int8,
     67 TFLOP/s f32) and the library call's time where there is one; the
     verify pass's attention in one launch (decode_attention_steps) at the
     7B's verify shapes, bit for bit the loop of write passes it replaced,
     each batch row bit for bit its launch alone, timed beside both routes
     it replaced; int8_matmul (bf16 x weight-only) at the layer's four
     weights: the rows of 17, 49, 196 and 392 equal bit for bit to the first
     rows of 1,568 (K split by the weight's shape alone);
  3. the tiny preset's whole slice on the card (kernels) and on the CPU
     (plain versions) from the same seeded weights: int8 at widths 1, int4 at
     the product widths (fused scoring of 4 frames, speculative generation
     4 -> 8; on the card also against width 1: texts must be identical),
     int8 with the "fused_a8" and with the "pallas" backend. Scores must agree
     to atol 1e-3 (1e-2 with int8 activations: a tie in the quantiser moves a
     hidden state by up to 1/127 of its row's maximum); whether the generated
     texts match the CPU's is printed. Then three int4 QLoRA train steps on
     the card (kernels) and on the CPU (plain versions) from the same seeded
     weights and batch at lora_dropout 0: the loss parts within 1e-3, every
     trained leaf within 1e-3 of its largest magnitude;
  4. at the 7B's full width and depth, seeded synthetic weights, sink cache
     2048 + 32, launch counters zeroed just before each path and read just
     after; inference() runs its chunked trigger loops (the default) unless
     said otherwise, and a comparison of texts across generation widths keeps
     the run's own scoring width:
       a. 7B-int4 at the product widths: score_video over 64 frames (16 fused
          passes of 196 rows), inference() over the same 64 frames at 2 fps with a
          query at t=0, past the window fill, fused scoring of 4 frames,
          speculative generation 4 -> 8, then the same inference() at
          generation width 1 (texts compared) and one verify pass of 8 tokens,
          as generation runs it (attention replayed through the kernel),
          against 8 sequential passes on the filled cache (hidden states equal
          bit for bit);
       b. 7B-int8 at the product widths as in a (its products at 1 .. 16 rows on
          the int8 decode kernel), then score_video one frame a pass, the same
          inference() at generation width 1 (texts compared), and the verify
          pass against sequential passes as in a;
       c. 7B-int8 at the --w8a8 widths (backend "fused_a8": per-token int8
          activations): score_video over 64 frames in 8 fused passes of 392
          rows, inference() over b's stream at fused 8 with generation 4 -> 8,
          then the same inference() at generation width 1 (texts compared),
          frames/s and decode tokens/s beside b's; a short score_video run (8
          frames) of 7B-int8 with "pallas" (scores against b's width-1 run);
       d. 7B-int4 with per-token int8 activations (backend "fused_a8", the W4A8
          recipe) at the product widths on a's weights and stream: score_video
          over 64 frames in 16 fused passes of 196 rows, inference() over the
          stream's first 64 frames with generation 4 -> 8, then the same
          inference() at generation width 1
          (texts compared) and the verify pass against sequential passes as in
          a; frames/s and decode tokens/s beside a's, scores against a's;
       e. the chunked trigger loops on b's and d's weights and the stream's
          first 64 frames (max_new_tokens 16): 7B-int8 at fused 1 with generation 4 -> 8, the sum rule and the z rule
          (threshold_z 1.5, first 8 frames, running list 20), chunked equal to
          stepwise bit for bit (every score, response time and text, 3
          responses at least); 7B-int4 (sum rule) and 7B-int8 (z rule) at fused
          4 and 7B-int8 "fused_a8" (prob rule) at fused 8, each with generation
          4 -> 8 and response_min_interval_frames 4: the responses fire at
          exactly the frames where the stepwise rule, applied on the host to
          the run's own scores, fires; the largest score gap to the stepwise
          run at the same widths before their first differing decision;
          frames/s of both loops beside score_video's; then the infer command:
          its session from parsed flags (--synthetic_weights --int8, then
          --int4, product defaults: JAX's synthetic weights, the prob threshold
          from their own scores), its driver's _full_pass over 32 frames,
          and cmd_infer end to end on a 4 s clip written with cv2.
     Last (after phases 5-9 too), every shape that a path handed a kernel's
     wrapper must be one that phase 2 held against the plain version;
  5. training at the 7B's full width and depth. a. The synthetic batch: int4
     QLoRA, int4 trunk, int8 embedding table, dense bf16 projector and
     lm_head, LoRA r 16 on the seven decoder projections, B 1, 16 synthetic
     384 x 384 frames in a conversation of 926 tokens, lr 1e-4, lora_dropout 0.05: one step to warm and five
     timed at remat 'full' (step ms, tokens/s, peak memory, the six losses,
     launches per step: 2 x 4 x 28 int4_matmul, 4 x 28 int4_matmul_t, 2 x 28
     flash forward, 28 flash backward), the frozen leaves' checksums, then
     one step each at remat 'half', 'none', 'dots' and 'dots_no_batch' from
     the same state (step ms and peak memory each, the same loss to 1e-2,
     each layer's slice of the adapters' gradients within GRAD_RTOL of
     'none''s, and a stale replay under 'dots' outside it).
     b. `train` at --model_preset 7b in this process (cmd_train), on two
     clips of 13 and 10 s written with cv2 at 384 x 384 under a grounding and
     a DVC entry of a mixture (frame_fps 1, max_num_frames 16; every batch
     left-padded to T 1,024): int4 QLoRA at B 2 with 2 micro-steps a update
     over 4 micro-steps (int4_matmul, int4_matmul_t and both flash kernels on
     padded B 2 batches), the same command resumed from latest_checkpoint to
     6 (the step and the optimizer count continue from 4 and 2), and the
     default int8 trunk at B 1 over 2 (int8_matmul's forward under autograd);
     each run's step ms (median, min, max), real tokens/s, the host's decode
     and collate ms a batch against the step, peak memory, losses and
     launches. The shape check of phase 4 covers this phase too;
  6. JAX's weights at 7B (models/loader.py, golden.py), in the same shape check:
       a. materialize_random_params(aha_7b(), "int8") built on the card (seconds
          printed), three leaves' slabs drawn again on the CPU (equal bit for
          bit), then tests/fixtures/golden_7b_int8_chip.npz, recorded on the TPU:
          its frames (by hash) and ids reproduced; its four traces in bf16 (score
          traces at fused 1 and 4; generation widths 1 and 4 -> 8, texts equal);
          the score traces again with the float leaves widened to f32 (the
          exact function: within the fixture's atol 2e-2, rtol 5e-2); the bf16
          traces within that tolerance of the fixture, or their largest gap per
          column within the TPU's own per-frame vs fused gap plus the card's
          bf16 vs f32 gap (both printed); the texts' first divergence from the
          fixture's with the port's top two logits there: the fixture's token
          within 2 bf16 steps of the top one;
       b. the dense bf16 tree (its score_video at fused 4 on torch.matmul
          timed), exported in the reference's key layout as safetensors shards
          of 5 GB at most in a temporary directory outside the repo (free space,
          write and read rates printed; removed at the end), served by the
          session of `infer --llm_pretrained DIR --int8 --model_preset 7b`: its
          scores at fused 1 and 4 equal bit for bit to the same tree quantised
          in memory.
  7. multi-stream serving at 7B-int8, B 8, at the product widths (fused 4,
     generation 4 -> 8), phase 4b's weights and stream, bf16 sink cache 2048 +
     32, max_new_tokens 16, launch counters zeroed just before each main path:
       b. MultiStreamScorer over 8 streams of 32 frames: each within the 7B
          fixture's tolerance (atol 2e-2 + rtol 5e-2) of its solo score_video
          (largest gap per column printed), stream 0 alone in slot 0 of an
          otherwise empty batch equal bit for bit; the tolerance's place
          measured in the same run: solo fused 1 against fused 4 (the noise of
          another product plan) must fit in it, a frame off by one and two
          rows swapped (faults) must not; the batch against solo at fused 1
          (every frame a write pass) reported beside them (the products split
          K and the cached attention its window alike at every row count and
          batch, so a stream's scores are the same bits batched or alone, fused
          or not);
       a. MultiStreamServer(batch=8) over 12 requests of 24-64 frames sliced
          from the stream at different offsets, queries at t = 0 and on some
          mid-stream, the prob rule on some and the sum rule on others through
          per-request overrides (thresholds from b's scores), so slots are
          refilled: each stream's responses where the host rule on its own
          batched scores fires, its scores within atol 2e-2 + rtol 5e-2 of a
          solo inference() on the same request up to their first differing
          decision, its texts equal to the solo texts while the responses follow
          the same frames, or parting at a tie (the batched token within 2 bf16
          steps of the top logit of the solo run at width 1); aggregate frames/s
          and decode tokens/s beside the solo runs', latency_stats(), launches;
       c. `serve --synthetic_weights --int8 --batch 8` on 4 requests whose clips
          are written with cv2: one result line each, keys complete.
  8. the serving options at 7B, in the same shape check, launch counters zeroed
     just before each main path:
       c. `infer --w8a8` from its flags: JAX's random init quantised with the
          vision tower, backend "fused_a8", fused scoring of 8 frames; the
          tower's ms a frame three ways (dense bf16, weight-only int8 and int8
          activations, a 32-frame batch); score_video over 32 frames, then
          inference() at 4 -> 8 and at generation width 1 (texts equal);
       b. `infer --synthetic_weights --int8 --lora_pretrained DIR`, then the
          same with --int4: a peft directory written on the card by
          save_adapter (r 16 adapters, f32 projector, heads and lm_head) in the
          system's temporary directory, served with JAX's promotions (f32 frame
          embeddings and frame chunks); score_video over 16 frames at fused 4
          and at fused 1 (frames/s), inference() with a response (its wall);
          launch counts by path: every quantised product of an f32 pass on the
          wgmma kernel's f32 path, each behind one split_bf16x3, none on the
          CUDA cores;
       a. r 16 adapters (B not zero) on 7B-int4, phase 4a's weights and stream:
          score_video over 32 frames (scores against the adapter-free run's:
          the adapters must move them), inference() over 64 frames at 4 -> 8 and
          at generation width 1 (texts equal); at 7B-int8, B 8 (phase 7's
          weights) the lockstep scorer (stream 0 alone in an otherwise empty
          batch equal bit for bit to the full batch) and MultiStreamServer over 8
          requests with the adapters; last, traced (profile_slice.Trace), the
          wall and device-busy ms and aten ops of a token, a frame chunk and a
          fused pass with and without the adapters.
  9. the highlight chain at 7B-int8, in the same shape check, launch counters
     zeroed just before the infer stage and read just after: three clips
     written with cv2 (32, 48 and 64 s at 30 fps, 320 x 240) beside a TVSum
     info TSV, an annotation TSV of 20 annotators a clip and their metadata;
     through aha_tpu_torch.cli.main in this process, `infer --test_dataset
     tvsum --model_preset 7b --synthetic_weights --int8 --frame_fps 1 --seed
     0` at the product defaults (fused 4, sink cache 2048 + 32), `grid-search
     --test_dataset tvsum --seed 0`, `evaluate --func tvsum` and `highlight
     --max_duration 10 --source_fps 30` on one clip: JAX's keys for every
     clip, true_frames_list as long as debug_data, finite scores (informative
     and relevance in [0, 1], uncertainty above 0), int8_matmul and
     decode_attention launched, the AP / F1 metrics in [0, 1] and the
     correlations in [-1, 1], frames_written equal to the highlight indices'
     count and the reel read back with cv2 (also with fixed positive
     parameters, ten frames selected); frames/s of the infer stage without the
     weights' build, and each stage's seconds.
  10. the rest of the command line and the other towers at 7B, in the same shape
     check, launch counters zeroed just before each part and read just after
     (the packages matplotlib, transformers, tokenizers and h5py probed first):
       a. `infer --test_dataset hubble_space --model_preset 7b --int8
          --synthetic_weights --frame_fps 1` at the product defaults on a cv2
          clip of 120 s (30 fps, 320 x 240) with the tick table, then
          `--test_dataset arl_scout` on a folder of 60 frames from --start_sec
          10: frames scored, frames/s without the build, telemetry.peak_hbm_gb
          beside max_memory_allocated, ticks (without matplotlib the command
          runs with its plot left out);
       c. the interactive API on a's session: encode_given_query and 32 calls
          of input_one_frame, every score equal bit for bit to the stepwise
          inference() over the same frames and query;
       b. `demo --model_preset 7b --int8 --render_video --motion_skip_threshold
          0.02` on a 60 s clip of moving and static stretches (JAX's seed-0
          init): frames scored (demo_kept()) against frames decoded, the
          stitched MP4 read back with cv2; without matplotlib, demo's device
          path with no plot (infer_on_live_video, then render_demo_video);
       d. LocalJudge at Qwen2-7B width on JAX's synthetic dense bf16 decoder
          (an f32 cache of 4,096 slots, the char tokenizer) over 3 questions x
          3 responses x 3 gold answers: ms a judgement, the prefix cache's
          metadata and keys / values unchanged after every call, its metadata's
          save and restore against a clone of the whole cache; with
          transformers, `evaluate --func magqa --judge_ckpt DIR` on the
          decoder written there and a BPE tokenizer trained there;
       e. SigLIP with its MAP probe and CLIP-L/14-336 (frame_token_cls, 50
          tokens a frame), JAX's synthetic 7B-int8 trees: score_video over 32
          frames at fused 4 and 1, dense tower and --vision_int8, the tower's
          ms a frame, fused against fused 1 within atol 2e-2 + rtol 5e-2.
  11. parallelism (aha_tpu_torch/parallel/), in the same shape check: a world of 2
     ranks, two processes that share cuda:0 over gloo (NCCL refuses two ranks on one
     device; the collectives gloo does not take on CUDA tensors, probed in phase 1,
     are staged through pinned host memory), or of 4 over NCCL where the host has 4
     cards; the ranks record the shapes they hand the kernels, and this process runs
     the one-rank references meanwhile:
       a. 7B-int8 at full depth and width, MultiStreamServer(batch=8) at data 1 x
          model 2 (model 4: 7 q / 1 kv head a rank) over 8 requests of 16-32 frames at
          the product widths (fused 4, generation 4 -> 8, the sum rule at 8): each
          request's scores within atol 2e-2 + rtol 5e-2 of the one-rank server's up
          to their first differing decision, texts compared (a text that parts is
          shown with the solo run's logit gap at the parting token, at most 2 bf16
          steps), kernel launches, collectives (staged ones apart) and frames/s per
          rank;
       b. training at full width and 4 of 28 layers (cut), QLoRA on synthetic int4 and
          int8 trunks: FSDP (data 2, int4), TP (model 2, int8), GPipe (pipe 2, 2
          microbatches, int4) and ring attention (data 2, one row of ring_min_seq
          2,048 tokens, int8), a step each: a finite loss within 1e-2 relative of
          the one-rank step's, its ms per rank;
       c. the native decoder: built or not (and why), and on a clip written with cv2
          its frames against the cv2 path's in count and source indices.

Prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
Exits nonzero, with no result line, when there is no CUDA device, when the
package is missing, or when any phase fails. A failed comparison of phase 7
is printed as a FAILED line and the run goes on through the later phases; it
then exits 1 at its end. `--batch_gaps` prints phase 7b's readings alone.
Imports nothing of JAX and nothing of aha_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
CSRC = "aha_tpu_torch/csrc/"
FUSED_TPU = "aha_tpu/ops/pallas/fused_matmul.py"
FLASH_TPU = "aha_tpu/ops/pallas/flash_attention.py:75"
# name -> (source, the TPU kernel it replaces)
KERNELS = {
    "int8_matmul": (CSRC + "int8_matmul.cu", FUSED_TPU + ":177"),
    "int8_matmul_a8": (CSRC + "int8_matmul.cu", FUSED_TPU + ":177"),
    "quant_matmul": (CSRC + "int8_matmul.cu", "aha_tpu/ops/pallas/quant_matmul.py:103"),
    "int4_matmul": (CSRC + "int4_matmul.cu", FUSED_TPU + ":238"),
    "int4_matmul_a8": (CSRC + "int4_matmul.cu", FUSED_TPU + ":238"),
    "int4_matmul_t": (CSRC + "int4_matmul_t.cu", FUSED_TPU + ":313"),
    "quantize_rows": (CSRC + "quantize_rows.cu", FUSED_TPU + ":160"),
    # the prologue of the f32-activation paths of int8_matmul and int4_matmul, whose f32
    # dot it serves (the TPU kernel's f32 dot_general in _kernel_int8 / _kernel_int4)
    "split_bf16x3": (CSRC + "quantize_rows.cu", FUSED_TPU + ":50"),
    "decode_attention": (CSRC + "decode_attention.cu",
                         "aha_tpu/ops/pallas/decode_attention.py:131"),
    # the verify pass's steps side by side in one launch of the same kernels: the TPU
    # kernel applied step after step, as the sequential passes the pass composes run it
    "decode_attention_steps": (CSRC + "decode_attention.cu",
                               "aha_tpu/ops/pallas/decode_attention.py:131"),
    "flash_attention_fwd": (CSRC + "flash_attention.cu", FLASH_TPU),
    "flash_attention_bwd": (CSRC + "flash_attention.cu", FLASH_TPU),
}
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
QUERY = "What is happening in this video?"
SCORE_KEYS = ("informative_score", "relevance_score", "uncertainty_score")


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int = 20, replays: int = 3) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the graph replayed between two events. For calls whose kernels are
    shorter than the host's work to launch them, where events around a loop of
    plain calls time the host. No tracer is attached to the process, whose later
    phases are timed too."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    del graph           # its memory pool goes back to the allocator
    return a.elapsed_time(b) / (iters * replays)


def rel_check(name: str, y, ref, tol: float) -> float:
    import torch

    if y.shape != ref.shape or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)} or non-finite")
    err = (y.float() - ref.float()).abs().max().item()
    bound = tol * max(ref.float().abs().max().item(), 1e-30)
    if not err <= bound:
        raise AssertionError(f"{name}: max|y-y_ref| {err:.3e} > {bound:.3e}")
    return err


def bound_ms(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the
    published peak of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Stats:
    """Per kernel: worst error over all checks; times, bound and library
    time summed over the kernel's representative shapes; launches summed
    over the main paths."""

    def __init__(self):
        self.k = {n: dict(err=0.0, ms=None, plain_ms=None, bound_ms=None, bound_by=None,
                          library_ms=None, launches=0, shape=None) for n in KERNELS}
        self.checked = set()     # (kernel, M, K, N) or (kernel, S) held against the plain version
        self.train_fwd_ms = 0.0  # int4_matmul, a layer's four products at the training rows
        self.native_ops = []     # the collectives gloo took on CUDA tensors in phase 1
        self.failures = []       # phase 7's failed comparisons: the run fails at its end

    def err(self, name, e):
        self.k[name]["err"] = max(self.k[name]["err"], e)

    def add(self, name, ms, plain_ms, bound, by, library_ms, shape):
        k = self.k[name]
        k["ms"] = (k["ms"] or 0.0) + ms
        k["plain_ms"] = (k["plain_ms"] or 0.0) + plain_ms
        k["bound_ms"] = (k["bound_ms"] or 0.0) + bound
        k["bound_by"] = by
        if library_ms is not None:
            k["library_ms"] = (k["library_ms"] or 0.0) + library_ms
        k["shape"] = shape

    def fail(self, msg: str):
        print(f"FAILED {msg}", flush=True)
        self.failures.append(msg)

    def launches(self, counts):
        for n, c in counts.items():
            self.k[n]["launches"] += c


# the kernels whose ptxas report phase 1 holds: no spill, no serialisation remark (the
# int8 and int4 forward kernels once per operand type: bf16 x weight-only, int8 x, and
# for the wgmma kernels an f32 x's three bf16 planes, the last template argument 3; the
# warp-specialised int8 and int4 kernels at each token tile; the f32-query attention
# kernel against a bf16 and an f32 cache)
PTXAS_HELD = ("int8_mm_wgmma_kernel", "int8_mm_decode_kernel", "int4_mm_wgmma_kernel",
              "int4_mm_decode_kernel", "int8_mm_ws_kernel", "int4_mm_ws_kernel",
              "quantize_rows_vec_kernel", "split_bf16x3_kernel",
              "decode_attention_wgmma_f32_kernel")
PTXAS_A8 = ("int8_mm_wgmma_kernel<true", "int8_mm_decode_kernel<true", "int4_mm_wgmma_kernel<true",
            "int4_mm_decode_kernel<true")
PTXAS_X3 = ("int8_mm_wgmma_kernel<false", "int4_mm_wgmma_kernel<false")


def check_ptxas(log: dict) -> str:
    """What ptxas said of the int8 and int4 wgmma, warp-specialised and decode
    kernels, the vector quantiser, the split of f32 x into bf16 planes and the f32-query
    attention kernel, one instantiation
    after another (registers, spill bytes), in the build this process ran;
    raises on a spill, on a remark that their products are serialised, or on a
    missing int8-activation or f32-activation instantiation. Such remarks on
    other kernels are printed."""
    import re

    if not log:
        return "ptxas: no build in this process (library reused)"
    regs, spills, remarks = {}, {}, []
    for src, text in sorted(log.items()):
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
                continue
            if "wgmma" in line and "serialized" in line:
                remarks.append(f"{src}: {line.strip()}")
            held = [k for k in PTXAS_HELD if entry is not None and k in entry]
            if not held:
                continue
            # the kernel and its template arguments: int8_mm_wgmma_kernel<true, 64>
            args = [("true" if v == "1" else "false") if k == "b" else v
                    for k, v in re.findall(r"L([bi])(\d+)E", entry.split(held[0], 1)[1])]
            key = f"{held[0]}<{','.join(args)}>"
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills[key] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs[key] = int(m.group(1))
    mine = [r for r in remarks if any(k in r for k in PTXAS_HELD)]
    missing = [k for k in PTXAS_HELD + PTXAS_A8 if not any(r.startswith(k) for r in regs)]
    missing += [k + ",*,3>" for k in PTXAS_X3
                if not any(r.startswith(k) and r.endswith(",3>") for r in regs)]
    if missing or any(spills.get(t, 0) for t in regs) or mine:
        raise AssertionError(f"ptxas: registers {regs}, spill bytes {spills}, serialisation "
                             f"remarks {mine}, no report for {missing}")
    others = f"; remarks on other kernels: {remarks}" if remarks else ""
    return (f"ptxas registers {dict(sorted(regs.items()))}, no spill, no wgmma serialisation "
            f"remark{others}")


# -- phase 2 -------------------------------------------------------------------

# the decoder layer's four products; the representative set of the JSON line
LAYER = [("qkv", 3584, 4608), ("o_proj", 3584, 3584), ("gate_up", 3584, 37888),
         ("down", 18944, 3584)]
# rows per decoder pass on the 7B paths: a token (1), a verify pass (4, 8), the
# generation prompt (13), a frame or the query (49), a response's last token +
# stream prompt + frame (59), the system prompt (171), a fused pass of 4 frames
# (196), system prompt + first frame (220)
PATH_M = (1, 4, 8, 13, 49, 59, 171, 196, 220)
# the stream of phases 4a-4e and 8a: the first 64 of 96 seeded frames at 2 fps (3,136 frame
# tokens, past the window fill); inference() ran over all 96 in phases 4a-4c before phase 10
# came, and over 64 in 4d, 4e and 8a since phase 5b came
STREAM_FRAMES = 64
# rows of the f32 passes (phase 6's exact traces; phase 8b's f32 frame chunks behind a peft
# artifact's f32 projector): a frame, a response's last token + stream prompt + frame, the
# system prompt and query, a fused pass of 4 frames, system prompt + first frame
F32_M = (49, 59, 171, 196, 220)
# rows of the training sequence of phase 5 (16 frames in one conversation)
TRAIN_T = 926
# phase 5b's batches: B 1 and 2, left-padded to the length bucket 1,024 (write_train_data),
# and so the rows of its products
TRAIN_CLI_T = 1024
TRAIN_CLI_B = (1, 2)
TRAIN_CLI_M = tuple(B * TRAIN_CLI_T for B in TRAIN_CLI_B)
# the SigLIP-large/16-384 tower of --vision_int8 / --w8a8 (phase 8c): a layer's products
# (q, k, v and out: 1024 x 1024; fc1 1024 x 4096; fc2 4096 x 1024), at a frame (576 rows)
# and at the engine's vision batch of 32 frames (18,432 rows)
TOWER = [("tower_qkvo", 1024, 1024), ("tower_fc1", 1024, 4096), ("tower_fc2", 4096, 1024)]
TOWER_M = (576, 18432)
TOWER_LAYER = {"tower_qkvo": 4, "tower_fc1": 1, "tower_fc2": 1}   # products a layer
# multi-stream serving (phase 7): slots, and the lengths of its requests (the vision
# tower's last batch of 32 frames leaves 24, 0, 8 or 16 frames: projector rows)
SERVE_B = 8
SERVE_LENGTHS = (24, 32, 40, 48, 56, 64, 24, 32, 40, 48, 56, 64)


def serve8_widths() -> dict:
    """The chunk widths (tokens a row) of phase 7's passes at B = 8, from the
    7B's templates: a frame step behind the system prompt, behind a response's
    last token + the stream prompt, or alone (padded to one id); a query at
    t = 0 and mid-stream; the mixed loop's frame, generation prompt and token;
    the speculative tail at 4 and 8; a fused pass of 4 frames. ``b1``: the
    widths phase 7's solo runs add to PATH_M (the mid-stream query)."""
    from aha_tpu_torch.config import InferConfig

    cfg, tok = _model("7b")
    F = cfg.frame_num_tokens
    t = tok.apply_chat_template
    start = len(t([{"role": "system", "content": InferConfig().system_prompt}]))
    stream = len(t([{}], add_stream_prompt=True))
    gen = len(t([{}], add_stream_generation_prompt=True))
    q0, q1 = (len(t([{"role": "user", "content": QUERY}], add_stream_query_prompt=mid,
                    add_stream_prompt=True)) for mid in (False, True))
    return {"frame_steps": (start + F, 1 + stream + F, 1 + F), "queries": (q0, q1),
            "mixed": (F, gen, 1), "spec": (4, 8), "fused": (4 * F,), "start": (start,),
            "b1": (q1,)}


# the highlight chain (phase 9): three clips at 30 fps, 320 x 240, decoded at 1 fps (their
# last vision batches leave 0, 16 and 0 frames: projector rows 1,568 and 784; 64, 80 and
# 96 s before phase 10 came), in the order of the metadata file phase 9 writes; clip ->
# (seconds, TVSum category, title)
CHAIN_CLIPS = {"clip_a": (32, "GA", "grooming an animal in a garden"),
               "clip_b": (48, "BK", "changing a bicycle tire"),
               "clip_c": (64, "VT", "a parade on the street")}
CHAIN_SEED = 0


def chain_query_rows() -> tuple:
    """The rows of the query chunks of phase 9's ``infer --test_dataset tvsum
    --seed 0``: run_tvsum draws each clip's template from
    ``random.Random(CHAIN_SEED)`` in metadata order, and score_video appends
    the query as one chunk before the system prompt."""
    import random

    from aha_tpu_torch.drivers.benchmarks import QUERY_TEMPLATES

    _, tok = _model("7b")
    rng = random.Random(CHAIN_SEED)
    return tuple(len(tok.apply_chat_template(
        [{"role": "user", "content": rng.choice(QUERY_TEMPLATES) % title}],
        add_stream_query_prompt=False, add_stream_prompt=True))
        for _, _, title in CHAIN_CLIPS.values())


def _dt(dt) -> str:
    return str(dt)[6:]


def dequantized(q4value, scale4):
    """The packed int4 weight as the bf16 matrix [K, N] a library product would
    be handed: scale * (nibble - 8), rounded once."""
    import torch

    from aha_tpu_torch.ops.kernels.int4_matmul import unpack_int4

    K, N = 2 * q4value.shape[0], q4value.shape[1]
    w = unpack_int4(q4value).reshape(scale4.shape[0], -1, N).to(torch.bfloat16)
    return (w * scale4[:, None, :]).reshape(K, N)


def dequantized8(qvalue, scale):
    """The int8 weight as the bf16 matrix [K, N] a library product would be
    handed: scale * value, rounded once."""
    import torch

    return (qvalue.float() * scale.reshape(1, -1)).to(torch.bfloat16)


def product_only_ms(a, w, short: bool, transposed: bool = False) -> float:
    """``torch.matmul`` of bf16 ``a`` with the dequantised weight ``w`` [K, N]
    (``transposed``: with its transpose): the yardstick of the int4 and int8
    products, timed and used nowhere. It reads four (int4) or two (int8) times
    the weight bytes and converts nothing. ``short``: timed as the kernel beside
    it was, from a graph."""
    import torch

    wt = w.t() if transposed else w
    timer = graph_ms if short else cuda_ms
    return timer(lambda i: torch.matmul(a, wt))


# rows at which phase 2 also times the library's product on the decode paths, and on
# phase 7's B = 8 passes (a verify pass of 4 and of 8 rows x 8, a frame step, a fused pass)
DECODE_LIB_M = (1, 4, 8, 13)
SERVE_LIB_M = (32, 64, 392, 1568)


def replaced_plan(M: int, K: int, N: int, G: int, sms: int):
    """The launch that ``int4_matmul``'s plan chose at 1 .. 16 bf16 rows before
    its decode kernel took them: the CUDA cores at a token, mma.sync at 2 .. 13
    rows, the wgmma kernel at 14 .. 16."""
    from aha_tpu_torch.ops.kernels import int4_matmul as k4

    if M >= 14:
        tile, tiles = k4.token_tile(M, k4.WGMMA_TILE_CAP)
        splits = k4.wgmma_splits(sms, tiles * -(-N // 128), K // G, K // 64)
        return k4.Plan(k4.WGMMA, splits, tile, tiles, 6, 6 * (tile * 128 + 6144) + 1024)
    if M > 1:
        return k4.Plan(k4.TENSOR_CORE, k4.splits_on(sms, -(-M // 64) * -(-N // 128), K // 256))
    return k4.Plan(k4.VEC16, k4.splits_on(sms, -(-N // 128), (K // G) // 4))


def replaced_plan8(M: int, K: int, N: int, sms: int):
    """The launch that ``int8_matmul``'s plan chose at 1 .. 16 bf16 rows before
    its decode kernel took them: the CUDA cores at a token, the wgmma kernel at
    2 .. 16 rows."""
    from aha_tpu_torch.ops.kernels import int8_matmul as k8

    if M == 1:
        return k8.Plan(k8.VEC16, k8.splits_on(sms, -(-N // 128), K // 256))
    tile, tiles = k8.token_tile(M, k8.WGMMA_TILE_CAP)
    stages, smem = k8.wgmma_ring(tile)
    splits = k8.wgmma_splits(k8.blocks_per_sm(tile) * sms, tiles * -(-N // 128), K // 64)
    return k8.Plan(k8.WGMMA, splits, tile, tiles, stages, smem)


def replaced_plan_f32(bits: int, M: int, K: int, N: int, G: int | None, sms: int):
    """The launch that the plans of ``int8_matmul`` (``bits`` 8) and
    ``int4_matmul`` (4) chose for f32 x weight-only at 17 rows and more before
    the wgmma kernel took them as three bf16 planes: the CUDA cores, 16-byte
    loads."""
    from aha_tpu_torch.ops.kernels import int8_matmul as k8

    if bits == 8:
        return k8.Plan(k8.VEC16, k8.splits_on(sms, -(-N // 128) * -(-M // 4), K // 256))
    return k8.Plan(k8.VEC16, k8.splits_on(sms, -(-N // 128) * -(-M // 2), (K // G) // 4))


def replaced_plan4_a8(M: int, K: int, N: int, G: int, sms: int):
    """The launch that ``int4_matmul``'s plan chose for int8 activations (bf16
    output) before the two Hopper kernels took them: mma.sync from 2 rows, the
    CUDA cores at a token."""
    from aha_tpu_torch.ops.kernels import int4_matmul as k4

    if M > 1:
        return k4.Plan(k4.TENSOR_CORE, k4.splits_on(sms, -(-M // 64) * -(-N // 128), K // 256))
    return k4.Plan(k4.VEC16, k4.splits_on(sms, -(-N // 128), (K // G) // 4))


def replaced_plan8_a8(M: int, K: int, N: int, sms: int):
    """The launch that ``int8_matmul``'s plan chose for int8 activations (bf16
    output) before the two Hopper kernels took them: mma.sync from 2 rows, the
    CUDA cores at a token."""
    from aha_tpu_torch.ops.kernels import int8_matmul as k8

    if M > 1:
        return k8.Plan(k8.TENSOR_CORE, k8.splits_on(sms, -(-M // 64) * -(-N // 128), K // 256))
    return k8.Plan(k8.VEC16, k8.splits_on(sms, -(-N // 128), K // 256))


def check_matmuls(gen, stats: Stats):
    import torch

    from aha_tpu_torch.ops.kernels import _build
    from aha_tpu_torch.ops.kernels import int4_matmul as k4
    from aha_tpu_torch.ops.kernels import int8_matmul as k8
    from aha_tpu_torch.ops.kernels import quantize_rows as qr

    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    layer = {name: (K, N) for name, K, N in LAYER}

    # every shape the paths of phase 4 hand a product (phase 4 records them and
    # fails on one that is not here), for each of the five entries alike
    cards = [(n, M, *layer[n]) for n in layer for M in PATH_M]
    cards += [(n, M, *layer[n]) for n in ("qkv", "down") for M in (5, 9)]
    cards += [("lm_head", M, 3584, 152064) for M in (1, 4, 8)]
    cards += [(n, M, K, N) for M in (392, 1568)
              for n, K, N in (("projector_fc1", 1024, 3584), ("projector_fc2", 3584, 3584))]
    ragged8 = [("ragged", 7, 100, 77), ("ragged", 1, 64, 33), ("ragged", 13, 300, 130),
               ("ragged", 5, 96, 48)]
    # bf16 with ragged tile edges on the tensor-core path (M, N not multiples
    # of the 64 x 128 tile, K split over blocks)
    edge = ("ragged-tc", 70, 320, 136)
    # int4 ragged: odd N, one group (G = K), M not a multiple of 4, G not a
    # multiple of 32 (the CUDA-core path at M > 1)
    ragged4 = [("ragged", 7, 128, 77, 128), ("ragged", 1, 64, 33, 64), ("ragged", 13, 384, 130, 64),
               ("ragged", 5, 96, 48, 6), ("ragged", 3, 256, 40, 128)]
    # int4, bf16, weight-only on the wgmma path: row counts that straddle its token
    # tiles (80 rows at most) and the training tile of the transposed kernel, the
    # projector's rows at a layer shape, a long K in three splits, G = 64 and 256
    wgmma4 = [("tile-edge", M, 3584, 4608, 128) for M in (14, 79, 80, 81, 161, 231, 232, 233, 257)]
    wgmma4 += [("tile-edge", 1568, 3584, 4608, 128), ("tile-edge", 1568, 18944, 3584, 128),
               ("g64", 100, 1024, 1024, 64), ("g256", 100, 1024, 1024, 256),
               ("g256", 926, 3584, 3584, 256)]
    # bf16 shapes that the wgmma kernel does not take and the earlier paths must: N
    # not a multiple of 8 (CUDA cores), G a multiple of 32 but not of 64 (mma.sync);
    # so is the edge case above (N = 136 is no multiple of 16: mma.sync)
    old4 = [("old-path-ragged-n", 70, 320, 132, 64), ("old-path-g32", 70, 320, 136, 32)]
    # int4 and int8, bf16, weight-only on their decode kernels (1 .. 16 rows): the rows
    # no path of phase 4 gives but a verify pass of another width would, at the layer's
    # shapes (down: its long K across the splits), and for int4 G = 64 and 256
    decode_rows = [(n, M, *layer[n]) for n in layer for M in (2, 3, 7, 15, 16)]
    decode4 = [(*c, 128) for c in decode_rows]
    decode4 += [("g64", 8, 1024, 1024, 64), ("g256", 8, 3584, 4608, 256)]

    # int8, bf16, weight-only on the wgmma path: its first row count and those that
    # straddle its token tiles (128 rows at most), the fused widths (196 and 392),
    # the projector's rows at a layer shape, down's long K across its splits
    cap = k8.WGMMA_TILE_CAP
    wgmma8 = [("tile-edge", M, 3584, 4608)
              for M in sorted({k8.WGMMA_MIN_M, cap - 1, cap, cap + 1, 231, 232, 233, 1568})]
    wgmma8 += [("long-k", M, 18944, 3584) for M in (k8.WGMMA_MIN_M, 1568)]
    wgmma8 += [(n, 392, *layer[n]) for n in layer]   # phase 4c's weight-only run at width 8
    # bf16 shapes the int8 wgmma kernel does not take and the earlier paths must:
    # K not a multiple of 64 (mma.sync; so is the edge case above, N = 136), and x
    # a view 2 bytes into its buffer (16-byte CUDA-core loads)
    old8 = [("old-path-k", 70, 352, 256), ("misaligned", 49, 3584, 4608)]
    old8_path = {"ragged-tc": k8.TENSOR_CORE, "old-path-k": k8.TENSOR_CORE,
                 "misaligned": k8.VEC16}
    # int8 activations on the same two kernels: the s8 wgmma kernel's first row count and
    # those that straddle its token tiles, the fused pass of 8 frames (392 rows, the
    # --w8a8 width) at the layer's shapes, down's long K across its splits
    wgmma8a8 = [("tile-edge", M, 3584, 4608) for M in (k8.WGMMA_MIN_M, 127, 128, 129, 231, 232,
                                                        233, 1568)]
    wgmma8a8 += [("long-k", M, 18944, 3584) for M in (k8.WGMMA_MIN_M, 1568)]
    wgmma8a8 += [(n, 392, *layer[n]) for n in layer]
    # int4 with int8 activations on the int4 Hopper kernels: the decode rows as for bf16
    # x (G = 64 and 256 too), the s8 wgmma kernel's first row count and those that
    # straddle its token tiles (24 .. 80 rows), 1568 rows, down's long K across its splits
    wgmma4a8 = [("tile-edge", M, 3584, 4608, 128)
                for M in (k4.WGMMA_MIN_M, 23, 24, 25, 79, 80, 81, 231, 232, 233, 1568)]
    wgmma4a8 += [("long-k", M, 18944, 3584, 128) for M in (k4.WGMMA_MIN_M, 1568)]

    # multi-stream serving at B = 8 (phase 7): the layer at the token rows of a verify
    # pass of 8 rows (32, 64), the mixed loop's frame rows (392) and a fused pass of 8
    # rows x 4 frames (1568), timed for int8 and int4; the lm_head of the speculative
    # tail (32, 64), timed; every other width phase 7 gives int8 weights, and the
    # projector rows of its requests' last vision batches, held against the plain
    # version without timing ("held")
    sw = serve8_widths()
    serve_t = [(n, M, *layer[n]) for n in layer for M in (32, 64, 392, 1568)]
    serve_t8 = [c for c in serve_t if c not in wgmma8] + [
        ("lm_head", M, 3584, 152064) for M in (32, 64)]
    timed8 = {M for _, M, _, _ in cards + serve_t8 + wgmma8}
    held8 = sorted({SERVE_B * w for k in ("frame_steps", "queries", "mixed", "spec", "fused",
                                          "start") for w in sw[k]} | set(sw["b1"]))
    serve_h8 = [("held-" + n, M, *layer[n]) for n in layer for M in held8 if M not in timed8]
    serve_h8 += [("held-" + n, M, K, N) for M in sorted({49 * (n % 32) for n in SERVE_LENGTHS}
                                                        - {0, 392, 1568})
                 for n, K, N in (("projector_fc1", 1024, 3584), ("projector_fc2", 3584, 3584))]
    # the highlight chain (phase 9): each clip's query chunk, held without timing
    chain_h8 = [("held-" + n, M, *layer[n]) for n in layer
                for M in sorted(set(chain_query_rows()) - timed8 - set(held8))]

    # phase 10: the CLS configurations' frame chunk (50 rows) and fused pass (200), timed;
    # CLIP-L/14-336's tower under --vision_int8 (577 rows a frame, a 32-frame batch), timed;
    # SigLIP's MAP probe under --vision_int8 (a row a frame: q and out, fc1, fc2), the
    # CLS configurations' projector (50 rows a frame), the live datasets' query chunks and
    # the projector rows of their last vision batches, held
    cls_t = [(n, M, *layer[n]) for n in layer for M in (50, 200)]
    clip_tower = [(n, 577 * TOWER_FRAMES, K, N) for n, K, N in TOWER]
    live_rows = (set(live_query_rows().values()) - timed8 - set(held8)
                 - set(chain_query_rows()) - set(PATH_M))
    live_h8 = [("held-" + n, M, *layer[n]) for n in layer for M in sorted(live_rows)]
    live_h8 += [("held-probe_qo", TOWER_FRAMES, 1024, 1024),
                ("held-probe_fc1", TOWER_FRAMES, 1024, 4096),
                ("held-probe_fc2", TOWER_FRAMES, 4096, 1024)]
    live_h8 += [("held-" + n, M, K, N)
                for M in sorted(live_projector_rows() | {50 * TOWER_FRAMES})
                for n, K, N in (("projector_fc1", 1024, 3584), ("projector_fc2", 3584, 3584))
                if M not in {49 * (k % 32) for k in SERVE_LENGTHS} | {392, 1568}]

    # phase 11: a rank's local products at model 2 (model 4 where the host has 4 cards):
    # the decoder layer at M = 1, 49 and 196 timed beside the whole layer; 11a's serving
    # rows (phase 7's widths at B = 8), its lm_head and projector rows, and 11b's TP step
    # (2 rows of 1,024 tokens), held
    world = p11_world()
    tp = {2: LAYER_TP2, 4: LAYER_TP4}[world]
    tp_t = [(n, M, K, N) for M in (1, 49, 196) for n, K, N in tp]
    serve_rows = p11_serve_rows()
    tp_h = [("held-" + n, M, K, N) for M in sorted(serve_rows | {2 * P11_T} - {1, 49, 196})
            for n, K, N in tp]
    lm_tp = LM_HEAD_TP[world]
    tp_h += [("held-" + lm_tp[0], M, *lm_tp[1:]) for M in (SERVE_B, 32, 64)]
    # the projector rows of 11a's requests (and at 4 ranks 11d's 8-frame clips)
    tp_h += [("held-" + n, 49 * (f % 32 or 32), K, N)
             for f in sorted(set(P11_LENGTHS) | ({8} if world == 4 else set()))
             for n, K, N in PROJECTOR_TP[world]]
    tp4_h = []
    if world == 4:
        # 11b at 4 ranks: FSDP x TP on 4 rows (2 a data rank) over the int4 trunk, TP over
        # 4 rows, ring attention 512 tokens a rank, and the one-rank steps on 4 rows
        tp_h += [("held-" + n, 4 * P11_T, K, N) for n, K, N in LAYER_TP4]
        tp_h += [("held-" + n, M, *layer[n]) for M in (P11_RING_T // 4, 4 * P11_T)
                 for n in layer]
        tp4_h = [("held-" + n, M, K, N) for M in (2 * P11_T,) for n, K, N in LAYER_TP2]
        tp4_h += [("held-" + n, 4 * P11_T, *layer[n]) for n in layer]

    # int8, f32 activations (phase 6's f32 score traces: a frame, the system prompt and
    # query, a fused pass of 4 frames; the lm_head's row; the projector's 8 frames; phase 8b's
    # f32 frame chunks: the system prompt and first frame, a response's last token + stream
    # prompt + frame)
    f32_8 = [(n, M, *layer[n]) for n in layer for M in F32_M]
    f32_8 += [("lm_head", 1, 3584, 152064), ("projector_fc1", 392, 1024, 3584),
              ("projector_fc2", 392, 3584, 3584)]
    # int4, f32 activations at G 128: phase 8b's f32 frame chunks over the int4 trunk
    # (the projector, heads and lm_head of a peft artifact are dense f32)
    f32_4 = [(n, M, *layer[n], 128) for n in layer for M in F32_M]

    # the int8 tower (phase 8c), weight-only and with int8 activations, timed beside the
    # dense tower's bf16 product (torch.matmul) that it replaces
    tower = [(n, M, K, N) for M in TOWER_M for n, K, N in TOWER]

    # (kernel name, weight bits, a8, cases, M of the representative set)
    families = [
        ("int8_matmul", 8, False,
         [(*c, None, bf, 1e-2) for c in cards + tower]
         + [(*r, None, f32, 1e-4) for r in ragged8 + f32_8] + [(*edge, None, bf, 1e-2)]
         + [(*c, None, bf, 1e-2) for c in wgmma8 + old8 + decode_rows + serve_t8 + serve_h8
            + chain_h8 + cls_t + clip_tower + live_h8 + tp_t + tp_h]
         + [(n, M, *layer[n], None, bf, 1e-2) for M in (TRAIN_T, *TRAIN_CLI_M) for n in layer],
         49),
        ("int8_matmul_a8", 8, True,
         [(*c, None, bf, 2e-2) for c in cards + tower]
         + [(*r, None, f32, 1e-4) for r in ragged8] + [(*edge, None, bf, 2e-2)]
         + [(*c, None, bf, 2e-2) for c in wgmma8a8 + decode_rows], 49),
        ("quant_matmul", 8, False,
         [(*c, None, bf, 1e-2) for c in cards] + [(*ragged8[0], None, f32, 1e-4)], 49),
        ("int4_matmul", 4, False,
         [(*c, 128, bf, 1e-2) for c in cards]
         + [(n, M, *layer[n], 128, bf, 1e-2) for M in (TRAIN_T, *TRAIN_CLI_M)
            for n in layer]                                            # the training batches
         + [(*c, 128, bf, 1e-2) for c in serve_t]                    # B = 8 serving rows
         + [(*c, 128, bf, 1e-2) for c in tp4_h]                      # phase 11 at 4 ranks
         + [(*r, f32, 1e-4) for r in ragged4 + f32_4] + [(*edge, 64, bf, 1e-2)]
         + [(*c, bf, 1e-2) for c in wgmma4 + old4 + decode4], 196),
        ("int4_matmul_a8", 4, True,
         [(*c, 128, bf, 1e-2) for c in cards]
         + [(*r, f32, 1e-4) for r in ragged4] + [(*edge, 64, bf, 2e-2)]
         + [(*c, bf, 1e-2) for c in wgmma4a8 + decode4], 196),
    ]
    tp_names = {n for n, _, _ in tp}
    sms = k8.num_sms(0)
    kernels = _build.library()
    # a decoder layer's four products (and the projector's two) summed by entry and M; a
    # tower layer's six products by entry and M, beside the dense tower's
    sums: dict = {}
    tower_sums: dict = {}
    peak_sums: dict = {}     # the f32 rows' decoder layer at the f32 peak, by entry and M
    # the warp-specialised path's layer, projector and tower sums: kernel, replaced, library
    ws_gate: dict = {}
    for name, bits, a8, cases, rep_m in families:
        for label, M, K, N, G, dt, tol in cases:
            wbytes = K * N * bits // 8
            # enough weight copies that a timing loop cannot live in the 50 MB L2 (a
            # case held without timing needs one)
            copies = 1 if label.startswith("held-") else max(1, math.ceil(160e6 / wbytes))
            if bits == 8:
                ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(copies)]
                sc = (torch.rand((1, N), generator=gen, device=dev) + 0.5) * (0.02 / 127)
                sbytes = 4 * N
                if name == "quant_matmul":
                    run = lambda x, w: k8.quant_matmul(x, w, sc)
                else:
                    run = lambda x, w: k8.int8_matmul(x, w, sc, a8=a8)
                plain = lambda x, w: k8.int8_matmul_plain(x, w, sc, a8)
            else:
                ws = [torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                                    dtype=torch.uint8) for _ in range(copies)]
                sc = ((torch.rand((K // G, N), generator=gen, device=dev) + 0.5)
                      * (0.02 / 7)).to(bf)
                sbytes = 2 * (K // G) * N
                run = lambda x, w: k4.int4_matmul(x, w, sc, a8=a8)
                plain = lambda x, w: k4.int4_matmul_plain(x, w, sc, a8)
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            if label == "misaligned":
                x = torch.cat([x.reshape(-1)[:1], x.reshape(-1)])[1:].view(M, K)
            y, ref = run(x, ws[0]), plain(x, ws[0])
            torch.cuda.synchronize()
            what = f"{name} {label} M={M} K={K} N={N}" + (f" G={G}" if G else "")
            err = rel_check(what, y, ref, tol)
            stats.err(name, err)
            stats.checked.add((name, M, K, N) if dt == bf else (name, M, K, N, "f32"))
            # which kernel the wrapper chose, and the same bits from a second launch
            # (K splits are added in a fixed order, no atomics)
            if not torch.equal(y, run(x, ws[0])):
                raise AssertionError(f"{what}: two launches on the same inputs differ")
            # f32 x weight-only from 17 rows on the wgmma kernel, as three bf16 planes
            x3 = dt == f32 and not a8 and M >= k8.WGMMA_MIN_M and label != "ragged"
            operand = k8.X_F32 if x3 else k8.X_S8 if a8 else k8.X_BF16
            # bf16 x weight-only from WS_MIN_M rows on the warp-specialised kernel
            ws_rows = dt == bf and not a8 and M >= k8.WS_MIN_M
            hopper = (k8.DECODE, k8.WGMMA, k8.WGMMA_WS)
            if bits == 4:
                pl = k4.plan(M, K, N, G, bf16=dt == bf, a8=a8, sms=sms)
                new = x3 or (dt == bf and not label.startswith("old-path")
                             and label not in ("ragged", "ragged-tc"))
                want = (k4.DECODE if M <= k4.DECODE_MAX_M else k4.WGMMA_WS if ws_rows
                        else k4.WGMMA) if new else None
                if pl.path != want and (new or pl.path in hopper):
                    raise AssertionError(f"{what}: path {pl.path}, expected "
                                         f"{want if new else 'an earlier path'}")
                kernel_smem = (kernels.aha_quant_matmul_ws_smem(4, pl.tile)
                               if pl.path == k4.WGMMA_WS
                               else kernels.aha_int4_matmul_smem(pl.path, pl.tile, operand)
                               if pl.path in (k4.WGMMA, k4.DECODE) else 0)
            else:
                pl = k8.plan(M, K, N, bf16=dt == bf, a8=a8,
                             align=(k8.align_of(x), k8.align_of(ws[0]), k8.align_of(sc)), sms=sms)
                new = x3 or (dt == bf and label not in ("ragged", *old8_path))
                want = (k8.DECODE if M <= k8.DECODE_MAX_M else k8.WGMMA_WS if ws_rows
                        else k8.WGMMA) if new else None
                if dt == bf and not a8 and label in old8_path and pl.path != old8_path[label]:
                    raise AssertionError(f"{what}: path {pl.path}, expected {old8_path[label]}")
                if pl.path != want and (new or pl.path in hopper):
                    raise AssertionError(f"{what}: path {pl.path}, expected "
                                         f"{want if new else 'an earlier path'}")
                kernel_smem = (kernels.aha_quant_matmul_ws_smem(8, pl.tile)
                               if pl.path == k8.WGMMA_WS
                               else kernels.aha_int8_matmul_wgmma_smem(pl.tile, operand)
                               if pl.path == k8.WGMMA
                               else kernels.aha_int8_matmul_decode_smem(pl.stages, int(a8))
                               if pl.path == k8.DECODE else 0)
            if kernel_smem != pl.smem_bytes:
                raise AssertionError(f"{what}: the plan's {pl.smem_bytes} bytes of shared "
                                     f"memory are not the kernel's {kernel_smem}")
            note = (f" path={pl.path} tile={pl.tile}x{pl.tiles} splits={pl.splits} "
                    f"stages={pl.stages} smem={pl.smem_bytes} equal_twice")
            if a8 and bits == 8 and pl.path in (k8.WGMMA, k8.DECODE):
                # exact int32 sums made f32 once, the scales in the plain version's order
                if not torch.equal(y, ref):
                    raise AssertionError(f"{what}: not the plain version's bits (max_abs_err "
                                         f"{err:.3e})")
                note += " equal_to_plain"
            if pl.path == k8.DECODE:   # the same path number in both sources
                # row r of the M-row product is the one-row product of row r, bit for bit
                rows = torch.cat([run(x[r:r + 1], ws[0]) for r in range(M)])
                if not torch.equal(y, rows):
                    raise AssertionError(f"{what}: a row differs from its one-row product")
                note += " rows_equal_one_row"
            if label.startswith("held-"):
                print(f"phase2 {what} {_dt(dt)} max_abs_err={err:.3e}{note} (held, not timed)",
                      flush=True)
                del ws
                continue
            # device time from a replayed graph (a launch under 100 us is shorter than
            # the host's work to launch it, and a loop of plain calls times the host)
            loop = cuda_ms(lambda i: run(x, ws[i % copies]))
            ms = graph_ms(lambda i: run(x, ws[i % copies]))
            short = ms < 0.1
            note += f" loop_ms={loop:.4f}"
            pms = cuda_ms(lambda i: plain(x, ws[i % copies]), iters=3, warmup=1)
            esize = x.element_size()
            nbytes = M * K * esize + wbytes + sbytes + M * N * esize
            if x3:
                # the design's tensor work: three bf16 products (hi, mid and lo planes);
                # beside it, labelled, the f32 product at the CUDA cores' f32 peak
                bms, by = bound_ms(nbytes, 3 * 2.0 * M * K * N, "bf16")
                f32_peak = bound_ms(nbytes, 2.0 * M * K * N, "f32")[0]
                note += f" f32_peak_bound_ms={f32_peak:.4f}"
                peak_sums[(name, M)] = peak_sums.get((name, M), 0.0) + (
                    f32_peak if label in layer else 0.0)
            else:
                bms, by = bound_ms(nbytes, 2.0 * M * K * N,
                                   "int8" if a8 else ("bf16" if dt == bf else "f32"))
            lib = replaced = w8_ms = quant_ms = None
            timer = graph_ms if short else cuda_ms
            if x3:
                # the CUDA-core kernel the plan chose before (timed, not counted), and the
                # library's f32 product on a weight dequantised to f32 beforehand (TF32 off)
                yo = torch.empty_like(y)
                old = replaced_plan_f32(bits, M, K, N, G, sms)
                launcher = k8.launch_plan if bits == 8 else k4.launch_plan
                launch_old = lambda i: launcher(x, None, ws[i % copies], sc, yo, old)
                launch_old(0)
                rel_check(f"{what} replaced kernel", yo, ref, tol)
                replaced = cuda_ms(launch_old, iters=3, warmup=1)
                note += f" replaced_path={old.path} replaced_ms={replaced:.4f}"
                wd = (ws[0].float() * sc.reshape(1, -1) if bits == 8
                      else (k4.unpack_int4(ws[0]).reshape(K // G, G, N).float()
                            * sc.float()[:, None, :]).reshape(K, N))
                tf32 = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
                lib = timer(lambda i: torch.matmul(x, wd))
                torch.backends.cuda.matmul.allow_tf32 = tf32
                del yo, wd
            if (pl.path == k8.DECODE and name != "quant_matmul" and not a8
                    and (label in layer or label == "lm_head")):
                # the kernel this one replaced at these rows, launched as its plan did
                # (int4: the CUDA-core kernel at 1, mma.sync at 2 .. 13, the wgmma
                # kernel at 14 .. 16; int8: the CUDA-core kernel at 1, the wgmma kernel
                # at 2 .. 16); timed, not counted
                if bits == 4:
                    old = replaced_plan(M, K, N, G, sms)
                    launch_old = lambda i: k4.launch_plan(x, None, ws[i % copies], sc, yo, old)
                else:
                    old = replaced_plan8(M, K, N, sms)
                    launch_old = lambda i: k8.launch_plan(x, None, ws[i % copies], sc, yo, old)
                yo = torch.empty_like(y)
                launch_old(0)
                rel_check(f"{what} replaced kernel", yo, ref, tol)
                replaced = timer(launch_old)
                note += f" replaced_path={old.path} replaced_ms={replaced:.4f}"
                del yo
            if pl.path == k8.WGMMA_WS:
                # the one-warpgroup wgmma kernel that the plan chose at these rows before,
                # launched through its explicit plan; timed from a graph as the kernel is,
                # not counted
                old = (k8.wgmma_plan(M, K, N, sms=sms) if bits == 8
                       else k4.wgmma_plan(M, K, N, G, sms=sms))
                launcher = k8.launch_plan if bits == 8 else k4.launch_plan
                yo = torch.empty_like(y)
                launch_old = lambda i: launcher(x, None, ws[i % copies], sc, yo, old)
                launch_old(0)
                rel_check(f"{what} replaced kernel", yo, ref, tol)
                replaced = graph_ms(launch_old)
                note += f" replaced_path={old.path} replaced_ms={replaced:.4f}"
                del yo
            if a8 and pl.path in (k8.WGMMA, k8.DECODE):
                # the mma.sync / CUDA-core kernel chosen before, the quantiser included as in the
                # kernel's own time; the weight-only kernel at the same rows; the
                # quantiser alone (timed, not counted)
                yo = torch.empty_like(y)
                if bits == 4:
                    old = replaced_plan4_a8(M, K, N, G, sms)
                    launch_old = lambda i: k4.launch_plan(*qr.quantize_rows(x), ws[i % copies],
                                                          sc, yo, old)
                    weight_only = lambda i: k4.int4_matmul(x, ws[i % copies], sc)
                else:
                    old = replaced_plan8_a8(M, K, N, sms)
                    launch_old = lambda i: k8.launch_plan(*qr.quantize_rows(x), ws[i % copies],
                                                          sc, yo, old)
                    weight_only = lambda i: k8.int8_matmul(x, ws[i % copies], sc)
                launch_old(0)
                rel_check(f"{what} replaced kernel", yo, ref, 2e-2)
                replaced = timer(launch_old)
                w8_ms = timer(weight_only)
                quant_ms = graph_ms(lambda i: qr.quantize_rows(x))   # short at every M
                note += (f" replaced_path={old.path} replaced_ms={replaced:.4f} weight_only_ms="
                         f"{w8_ms:.4f} quantize_rows_ms={quant_ms:.4f}")
                if bits == 4 and pl.path == k4.DECODE:
                    # the K splits that bf16 x gets at these shapes, where they differ
                    alt = dataclasses.replace(pl, splits=k4.decode_splits(sms, N, K // G))
                    if alt.splits != pl.splits:
                        launch_alt = lambda i: k4.launch_plan(*qr.quantize_rows(x),
                                                              ws[i % copies], sc, yo, alt)
                        launch_alt(0)
                        rel_check(f"{what} in {alt.splits} splits", yo, ref, tol)
                        note += (f" bf16_splits={alt.splits} bf16_splits_ms="
                                 f"{timer(launch_alt):.4f}")
                del yo
            if a8 and M > 16 and K % 8 == 0 and N % 8 == 0:
                # the int8 x int8 product alone, on activations quantised beforehand (int4:
                # the weight unpacked to int8 beforehand)
                xq = torch.randint(-127, 128, (M, K), generator=gen, device=dev,
                                   dtype=torch.int8)
                w8 = ws if bits == 8 else [k4.unpack_int4(w) for w in ws[:max(1, copies // 2)]]
                lib = timer(lambda i: torch._int_mm(xq, w8[i % len(w8)]))
                del w8
            if not a8 and dt == bf and (label in layer or label == "lm_head") and (
                    M in (rep_m, TRAIN_T) + TRAIN_CLI_M + DECODE_LIB_M + SERVE_LIB_M
                    or (bits == 8 and M == 196)) or label in TOWER_LAYER or (
                    pl.path == k8.WGMMA_WS):
                # the bf16 product alone, on a weight dequantised beforehand (the tower:
                # also what its dense bf16 form computes, timed for both entries)
                wd = dequantized(ws[0], sc) if bits == 4 else dequantized8(ws[0], sc)
                dense = product_only_ms(x, wd, short)
                lib = lib if a8 else dense
                del wd
            if pl.path == k8.WGMMA_WS and (label in layer or label in TOWER_LAYER
                                            or label.startswith("projector")):
                part = ("layer" if label in layer else "tower" if label in TOWER_LAYER
                        else "projector")
                times = TOWER_LAYER.get(label, 1)
                acc = ws_gate.setdefault((name, part, M), [0.0, 0.0, 0.0])
                for i, v in enumerate((ms, replaced, lib)):
                    acc[i] += times * v
            if label in TOWER_LAYER:
                note += f" dense_bf16_ms={dense:.4f}"
                acc = tower_sums.setdefault((name, M), [0.0, 0.0, 0.0, 0.0, 0.0])
                for i, v in enumerate((ms, bms, lib, dense, pms)):
                    acc[i] += TOWER_LAYER[label] * v
            if M == rep_m and label in layer and dt == bf:
                stats.add(name, ms, pms, bms, by, lib,
                          f"decoder layer (qkv, o_proj, gate_up, down) at M={M}, bf16")
            if M == TRAIN_T and label in layer:
                stats.train_fwd_ms += ms
            if x3 or (dt == bf and (label in layer or label.startswith("projector")
                                    or label == "lm_head" or label in tp_names)):
                part = ("layer_f32" if x3 and label in layer else
                        label.split("_fc")[0] + "_f32" if x3 else
                        "layer" if label in layer else f"local_layer_model{world}"
                        if label in tp_names else label.split("_fc")[0])
                acc = sums.setdefault((name, part, M), [0.0, 0.0, 0.0, 0, 0.0, 0.0, 0.0, 0.0])
                acc[0] += ms
                acc[1] += bms
                acc[2] += lib or 0.0
                acc[3] += lib is not None
                acc[4] += pms
                acc[5] += replaced or 0.0
                acc[6] += w8_ms or 0.0
                acc[7] += quant_ms or 0.0
            print(f"phase2 {what} {_dt(dt)} max_abs_err={err:.3e}{note} kernel_ms={ms:.4f} "
                  f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) library_ms="
                  f"{'none' if lib is None else f'{lib:.4f}'}", flush=True)
            del ws
    # the plan sends a row count to the warp-specialised kernel only where it was faster
    # than the one-warpgroup wgmma kernel it replaced, in this call
    slower = []
    for (name, part, M), (ms, old, lib) in sorted(ws_gate.items()):
        print(f"phase2 ws {name} {part} M={M}: kernel_ms={ms:.4f} replaced_ms={old:.4f} "
              f"library_ms={lib:.4f} ({ms / old:.3f}x the replaced kernel, {ms / lib:.3f}x the "
              f"library)", flush=True)
        if not ms < old:
            slower.append((name, part, M))
    if slower:
        raise AssertionError(f"the warp-specialised kernel is not faster than the kernel it "
                             f"replaced at {slower}")
    for (name, M), (ms, bms, lib, dense, pms) in sorted(tower_sums.items()):
        print(f"phase2 sum {name} tower layer (q, k, v, out, fc1, fc2) M={M}: kernel_ms="
              f"{ms:.4f} bound_ms={bms:.4f} plain_ms={pms:.4f} library_ms={lib:.4f} "
              f"dense_bf16_ms={dense:.4f}; 24 layers {24 * ms:.3f} ms against dense "
              f"{24 * dense:.3f} ms", flush=True)
    for M in (1, 49, 196):
        whole, local = sums.get(("int8_matmul", "layer", M)), sums.get(
            ("int8_matmul", f"local_layer_model{world}", M))
        if whole and local:
            print(f"phase2 int8_matmul a rank's decoder layer at model {world} M={M}: "
                  f"{local[0]:.4f} ms against the whole layer's {whole[0]:.4f} ms ({world} ranks "
                  f"would take {world * local[0]:.4f} ms of kernel time for the layer; bound "
                  f"{local[1]:.4f} against {whole[1]:.4f} ms; a byte of the local products "
                  f"costs {local[0] / local[1]:.2f}x its bound, the whole layer's "
                  f"{whole[0] / whole[1]:.2f}x)", flush=True)
    for (name, part, M), (ms, bms, lib, n_lib, pms, old, w8, quant) in sorted(sums.items()):
        peak = peak_sums.get((name, M)) if part == "layer_f32" else None
        print(f"phase2 sum {name} {part} M={M}: kernel_ms={ms:.4f} bound_ms={bms:.4f} "
              + (f"(three bf16 products; f32_peak_bound_ms={peak:.4f}) " if peak else "")
              + f"plain_ms={pms:.4f} library_ms={f'{lib:.4f}' if n_lib else 'none'}"
              + (f" replaced_ms={old:.4f}" if old else "")
              + (f" weight_only_ms={w8:.4f} quantize_rows_ms={quant:.4f}" if w8 else ""),
              flush=True)


def check_quantize_rows(gen, stats: Stats):
    import torch

    from aha_tpu_torch.ops.kernels import quantize_rows as qr

    bf, f32 = torch.bfloat16, torch.float32
    # the rows and widths the int8-activation products of the paths quantise
    cases = [(M, K, bf) for M in PATH_M + (5, 9) for K in (3584, 18944)]
    cases += [(M, K, bf) for M in (392, 1568) for K in (1024, 3584)] + [(392, 18944, bf)]
    cases += [(M, K, bf) for M in TOWER_M for K in (1024, 4096)]     # the int8 tower's
    cases += [(7, 100, f32), (3, 33, f32)]
    for M, K, dt in cases:
        x = torch.randn((M, K), generator=gen, device="cuda").to(dt)
        xq, sx = qr.quantize_rows(x)
        rq, rs = qr.quantize_rows_plain(x)
        torch.cuda.synchronize()
        # the same IEEE division and round-half-even on both sides: bit-equal
        step = (xq.int() - rq.int()).abs().max().item()
        off = int((xq != rq).sum())
        if xq.shape != rq.shape or off or not torch.equal(sx, rs):
            raise AssertionError(f"quantize_rows M={M} K={K}: {off} values differ (max step "
                                 f"{step}), scales equal {torch.equal(sx, rs)}")
        stats.err("quantize_rows", float(step))
        stats.checked.add(("quantize_rows", M, K))
        # device time from a replayed graph (the kernel is shorter than the host's
        # work to launch it); events around a loop of plain calls beside it
        loop = cuda_ms(lambda i: qr.quantize_rows(x))
        ms = graph_ms(lambda i: qr.quantize_rows(x))
        pms = cuda_ms(lambda i: qr.quantize_rows_plain(x), iters=5)
        bms, by = bound_ms(M * K * (x.element_size() + 1) + 4 * M, 3.0 * M * K, "f32")
        if (M, K) in ((196, 3584), (196, 18944)):
            stats.add("quantize_rows", ms, pms, bms, by, None,
                      "a decoder layer's two widths (K 3584, 18944) at M=196, bf16")
        print(f"phase2 quantize_rows M={M} K={K} {_dt(dt)} values_off={off} max_step={step} "
              f"loop_ms={loop:.4f} kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) "
              f"library_ms=none", flush=True)


def check_split(gen, stats: Stats):
    """split_bf16x3 at every (rows, K) of the f32 products from 17 rows (the
    layer's two widths at the f32 rows, the projector's at 392): the planes
    bit-equal to the plain version (subtractions and round-to-nearest
    conversions), hi + mid + lo == x, timed from a replayed graph."""
    import torch

    from aha_tpu_torch.ops.kernels import quantize_rows as qr

    cases = [(M, K) for M in F32_M for K in (3584, 18944)] + [(392, 1024), (392, 3584)]
    sums = [0.0, 0.0, 0.0]
    for M, K in cases:
        x = torch.randn((M, K), generator=gen, device="cuda") * torch.exp2(
            torch.randint(-20, 21, (M, K), generator=gen, device="cuda").float())
        planes = qr.split_bf16x3(x)
        ref = qr.split_bf16x3_plain(x)
        torch.cuda.synchronize()
        off = int((planes != ref).sum())
        exact = torch.equal(planes.float().sum(0), x)
        if planes.shape != (3, M, K) or off or not exact:
            raise AssertionError(f"split_bf16x3 M={M} K={K}: {off} values differ from the "
                                 f"plain version; hi + mid + lo == x: {exact}")
        stats.err("split_bf16x3", 0.0)
        stats.checked.add(("split_bf16x3", M, K))
        loop = cuda_ms(lambda i: qr.split_bf16x3(x))
        ms = graph_ms(lambda i: qr.split_bf16x3(x))
        pms = cuda_ms(lambda i: qr.split_bf16x3_plain(x), iters=5)
        bms, by = bound_ms(M * K * (4 + 3 * 2), 5.0 * M * K, "f32")
        if M == 49 and K in (3584, 18944):
            stats.add("split_bf16x3", ms, pms, bms, by, None,
                      "a decoder layer's two widths (K 3584, 18944) at M=49, f32")
        if M == 49:
            # a layer's four products split x at K 3584 three times (qkv, o, gate_up), 18944 once
            for i, v in enumerate((ms, pms, bms)):
                sums[i] += (3 if K == 3584 else 1) * v
        print(f"phase2 split_bf16x3 M={M} K={K} f32 values_off={off} sum_exact={exact} "
              f"loop_ms={loop:.4f} kernel_ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.4f} "
              f"({by}) library_ms=none", flush=True)
    print(f"phase2 sum split_bf16x3 decoder layer M=49 (four products): kernel_ms={sums[0]:.4f} "
          f"plain_ms={sums[1]:.4f} bound_ms={sums[2]:.4f}", flush=True)


def attention_inputs(gen, B, S, NH, KVH, Dh, Wp, qdt, kvdt, occupied=None, blind=False):
    """Random operands with a mixed mask: some empty slots, orders spread
    so that each query sees part of the cache. ``occupied`` (lo, hi): only
    those slots hold keys; ``blind``: query 0 sees no slot."""
    import torch

    dev = "cuda"
    q = torch.randn((B, S, NH, Dh), generator=gen, device=dev).to(qdt)
    if kvdt == torch.int8:
        k = torch.randint(-127, 128, (B, Wp, KVH, Dh), generator=gen, device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (B, Wp, KVH, Dh), generator=gen, device=dev, dtype=torch.int8)
        scales = tuple(torch.rand((B, Wp, KVH), generator=gen, device=dev) * 0.02 + 0.005
                       for _ in range(2))
    else:
        k = torch.randn((B, Wp, KVH, Dh), generator=gen, device=dev).to(kvdt)
        v = torch.randn((B, Wp, KVH, Dh), generator=gen, device=dev).to(kvdt)
        scales = None
    ang = torch.rand((B, Wp, Dh // 2), generator=gen, device=dev) * 6.283
    ang = torch.cat([ang, ang], dim=-1)
    order = torch.randperm(Wp, generator=gen, device=dev).repeat(B, 1).to(torch.int32)
    order[:, -3:] = -1                                   # empty slots
    if occupied is not None:
        order[:, :occupied[0]] = -1
        order[:, occupied[1]:] = -1
    g = (Wp - S + torch.arange(S, device=dev)).repeat(B, 1).to(torch.int32)
    if blind:
        g[:, 0] = -1
    return (q, k, v, ang.cos().contiguous(), ang.sin().contiguous(), order.contiguous(),
            g.contiguous(), scales)


def check_attention(gen, stats: Stats):
    """``decode_attention`` against its plain version: the path and split the
    wrapper's plan chose, equal bits from two launches (the splits merge in a
    fixed order, no atomics), zeros for a query that sees no slot; kernel
    times with the K / V cache (and int8 scales) cycled through more copies
    than L2 holds, from a replayed CUDA graph where a launch is under 100 us."""
    import torch

    from aha_tpu_torch.ops.kernels import decode_attention as da
    from aha_tpu_torch.ops.kernels.int8_matmul import num_sms

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (label, B, S, NH, KVH, Dh, Wp, q dtype, kv dtype, tol, extra): 7B shapes on
    # the 2049-slot sink cache (every S of PATH_M that a writing pass takes: all
    # but the verify pass's 4, 8 and 196), S = 2 and 3 (14 and 21 rows, either side
    # of the tensor cores' 16), int8 KV, two batch rows, Wp across the slot tiles'
    # and the splits' edges, keys in one split only, a query that sees nothing;
    # then small ragged f32 shapes
    seven = dict(NH=28, KVH=4, Dh=128, q=bf, kv=bf, tol=1e-2)
    cases = [dict(seven, label="7b", B=1, S=S, Wp=2049) for S in (1, 2, 3, 13, 49, 59, 171, 220)]
    cases += [dict(seven, label="7b-int8kv", B=1, S=S, Wp=2049, kv=i8) for S in (1, 49)]
    cases += [dict(seven, label="7b-b2", B=2, S=S, Wp=2049) for S in (1, 13)]
    cases += [dict(seven, label="7b-edge", B=1, S=S, Wp=Wp) for Wp in (64, 65, 129) for S in (1, 3)]
    cases += [dict(seven, label="7b-one-split", B=1, S=S, Wp=2049, occupied=(640, 670))
              for S in (1, 3)]
    cases += [dict(seven, label="7b-blind-row", B=1, S=S, Wp=2049, blind=True) for S in (2, 49)]
    # multi-stream serving at B = 8 (phase 7): a token and a frame, timed; the other
    # widths of its passes held; the mid-stream query of its solo runs at B = 1
    sw = serve8_widths()
    cases += [dict(seven, label="7b-b8", B=SERVE_B, S=S, Wp=2049) for S in (1, 49)]
    cases += [dict(seven, label="7b-b8-held", B=SERVE_B, S=S, Wp=2049)
              for S in sorted(set(sw["frame_steps"] + sw["queries"] + sw["mixed"] + sw["start"])
                              - {1, 49})]
    cases += [dict(seven, label="7b-held", B=1, S=S, Wp=2049) for S in sw["b1"]]
    # phase 11a: a rank's heads at model 2 (14 q / 2 kv; model 4: 7 / 1) at B = 8, a token
    # and a frame timed, the other widths of phase 7's passes held
    world = p11_world()
    local = dict(seven, NH=28 // world, KVH=4 // world)
    cases += [dict(local, label="7b-b8-tp", B=SERVE_B, S=S, Wp=2049) for S in (1, 49)]
    cases += [dict(local, label="7b-b8-tp-held", B=SERVE_B, S=S, Wp=2049)
              for S in sorted(set(sw["frame_steps"] + sw["queries"] + sw["mixed"] + sw["start"]
                                  + sw["spec"] + sw["fused"]) - {1, 49})]
    # the highlight chain (phase 9): each clip's query chunk
    cases += [dict(seven, label="7b-held", B=1, S=S, Wp=2049)
              for S in sorted(set(chain_query_rows()) - set(PATH_M) - set(sw["b1"]))]
    # f32 queries: phase 8b's f32 frame chunks behind a peft artifact's f32 projector (a
    # frame, a response's last token + stream prompt + frame, the system prompt, the system
    # prompt and first frame) against the bf16 cache, read as it lies; phase 6's f32 score
    # traces, one against an f32 cache. Each timed beside the route the f32 tensor-core
    # path replaced: the cache widened to f32, then the CUDA-core kernel
    cases += [dict(seven, label="7b-f32", B=1, S=S, Wp=2049, q=f32, kv=bf, tol=1e-4)
              for S in (49, 59, 171, 220)]
    cases += [dict(seven, label="7b-f32", B=1, S=49, Wp=2049, q=f32, kv=f32, tol=1e-4)]
    # f32 q against the bf16 cache, as it lies, on the CUDA cores: below 16 rows per kv head
    # (S = 2: 14 rows) and at a head size under 128
    cases += [dict(seven, label="7b-f32-held", B=1, S=2, Wp=2049, q=f32, kv=bf, tol=1e-4),
              dict(label="ragged", B=2, S=5, NH=4, KVH=2, Dh=64, Wp=129, q=f32, kv=bf, tol=1e-4)]
    # phase 10: the CLS configurations' frame chunk (50 rows), timed; the live datasets'
    # query chunks, held; the judge's f32 cache of JUDGE_WINDOW slots: a token and the
    # rubric prefix timed, each judgement's prompt held
    cases += [dict(seven, label="7b", B=1, S=50, Wp=2049)]
    cases += [dict(seven, label="7b-held", B=1, S=S, Wp=2049)
              for S in sorted(set(live_query_rows().values()) - set(PATH_M) - set(sw["b1"])
                              - set(chain_query_rows()))]
    prefix_rows, prompt_rows = judge_rows()
    judge = dict(seven, B=1, Wp=JUDGE_WINDOW + 1, q=f32, kv=f32, tol=1e-4)
    cases += [dict(judge, label="7b-f32-judge", S=S) for S in (1, prefix_rows)]
    cases += [dict(judge, label="7b-f32-judge-held", S=S) for S in sorted(set(prompt_rows))]
    if _module_ok("transformers") and _module_ok("tokenizers"):
        # 10d's command: the rows under the BPE tokenizer it trains
        import tempfile

        from aha_tpu_torch.tokenization import build_stream_tokenizer

        with tempfile.TemporaryDirectory() as d:
            write_judge_tokenizer(pathlib.Path(d))
            bpe_prefix, bpe_prompts = judge_rows(build_stream_tokenizer(d))
        cases += [dict(judge, label="7b-f32-judge-held", S=S)
                  for S in sorted({bpe_prefix, *bpe_prompts} - {1, prefix_rows, *prompt_rows})]
    cases += [dict(label="ragged", B=2, S=5, NH=4, KVH=2, Dh=16, Wp=77, q=f32, kv=f32, tol=1e-4),
              dict(label="ragged", B=2, S=3, NH=6, KVH=2, Dh=64, Wp=129, q=f32, kv=f32, tol=1e-4),
              dict(label="ragged", B=1, S=9, NH=8, KVH=2, Dh=32, Wp=45, q=f32, kv=f32, tol=1e-4),
              dict(label="ragged-int8kv", B=2, S=7, NH=4, KVH=2, Dh=128, Wp=100, q=f32, kv=i8,
                   tol=1e-4)]
    sms = num_sms(0)
    for c in cases:
        label, B, S, NH, KVH, Dh, Wp, qdt, kvdt, tol = (c[n] for n in (
            "label", "B", "S", "NH", "KVH", "Dh", "Wp", "q", "kv", "tol"))
        args = attention_inputs(gen, B, S, NH, KVH, Dh, Wp, qdt, kvdt, c.get("occupied"),
                                c.get("blind", False))
        what = f"decode_attention {label} B={B} S={S} Dh={Dh} Wp={Wp}"
        pl = da.plan(B, S, NH, KVH, Dh, Wp, qdt, kvdt, sms=sms)
        path = da.CUDA_CORES
        if Dh == 128 and (NH // KVH) * S >= da.WGMMA_MIN_ROWS:
            path = (da.WGMMA if qdt == bf and kvdt in (bf, i8) else
                    da.WGMMA_F32 if qdt == f32 and kvdt in (bf, f32) else da.CUDA_CORES)
        if pl.path != path:
            raise AssertionError(f"{what}: path {pl.path}, expected {path}")
        if label == "7b" and S == 1 and not pl.blocks > 100:
            raise AssertionError(f"{what}: {pl.blocks} blocks for a token")
        y = da.decode_attention(*args)
        ref = da.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = rel_check(what, y, ref, tol)
        if not torch.equal(y, da.decode_attention(*args)):
            raise AssertionError(f"{what}: two launches on the same inputs differ")
        if c.get("blind") and torch.count_nonzero(y[:, 0]):
            raise AssertionError(f"{what}: a query that sees no slot is not zero")
        stats.err("decode_attention", err)
        heads = (f"H{NH}",) if NH != 28 and label.startswith("7b") else ()
        stats.checked.add((("decode_attention", S, Wp) if qdt == bf else
                           ("decode_attention", S, Wp, "f32")) + heads)
        if B > 1 and qdt == bf:
            stats.checked.add(("decode_attention", S, Wp, f"B{B}") + heads)
        path_name = da.PATH_NAMES[pl.path]   # the launch counters' name; q and kv printed beside
        if label.endswith("-held"):
            print(f"phase2 {what} NH={NH} KVH={KVH} q={_dt(qdt)} kv={_dt(kvdt)} "
                  f"max_abs_err={err:.3e} path={path_name} "
                  f"splits={pl.splits}x{pl.span} blocks={pl.blocks} equal_twice (held, not "
                  f"timed)", flush=True)
            continue
        # the cache (and its scales) cycled through more copies than L2 holds: a pass
        # of 28 layers reads 28 of them; the rotation tables are the same in every
        # layer of a pass and stay as they are
        q, k, v, cos, sin, order, g, scales = args
        kv_bytes = 2 * k.numel() * k.element_size()
        copies = max(12, min(64, math.ceil(100e6 / kv_bytes)))
        kvs = [(k.clone(), v.clone(), None if scales is None else tuple(t.clone() for t in scales))
               for _ in range(copies)]
        run = lambda i: da.decode_attention(q, kvs[i % copies][0], kvs[i % copies][1], cos, sin,
                                            order, g, kvs[i % copies][2])
        ms = loop = cuda_ms(run)
        if loop < 0.1:
            # shorter than the host's work to launch it: device time from a graph
            ms = graph_ms(run)
        pms = cuda_ms(lambda i: da.decode_attention_plain(*args), iters=5)
        replaced = None
        if pl.path == da.WGMMA_F32:
            # the route this path replaced (timed, not counted): a bf16 cache widened to
            # f32, then the CUDA-core kernel at its plan, on the same cycled copies
            old = da.plan_on(da.CUDA_CORES, B, S, NH, KVH, Wp, sms=sms)

            def run_old(i):
                kc, vc = kvs[i % copies][:2]
                if kvdt == bf:
                    kc, vc = kc.float(), vc.float()
                return da.launch_plan(q, kc, vc, cos, sin, order, g, pl=old)

            rel_check(f"{what} replaced route", run_old(0), ref, tol)
            # device time against device time: from a graph (the widening, the scratch and
            # the launch captured) wherever the kernel's time is
            replaced = graph_ms(run_old) if loop < 0.1 else cuda_ms(run_old, iters=5, warmup=1)
            if not ms <= pms or (S in (49, prefix_rows) and not ms < replaced):
                raise AssertionError(f"{what}: kernel {ms:.4f} ms, plain {pms:.4f}, replaced "
                                     f"route {replaced:.4f}")
        del kvs
        note = "" if replaced is None else f" replaced_ms={replaced:.4f}"
        # q in, out, K and V (+ scales), the two rotation tables, order and g;
        # scores and weighted values over the slots a query's mask admits
        nbytes = sum(t.numel() * t.element_size() for t in args[:7])
        nbytes += y.numel() * y.element_size()
        if args[7] is not None:
            nbytes += sum(t.numel() * t.element_size() for t in args[7])
        visible = ((order[:, None, :] >= 0) & (order[:, None, :] <= g[:, :, None])).sum().item()
        if pl.path == da.WGMMA_F32:
            # the design's tensor work: bf16 plane products at the bf16 peak, five for the
            # scores and three (a bf16 V) or four (an f32 V) for p v; beside it, labelled,
            # the function's f32 products at the CUDA cores' f32 peak
            planes = 5 + (4 if kvdt == f32 else 3)
            bms, by = bound_ms(nbytes, planes * 2.0 * visible * NH * Dh, "bf16")
            note += f" f32_peak_bound_ms={bound_ms(nbytes, 4.0 * visible * NH * Dh, 'f32')[0]:.4f}"
        else:
            bms, by = bound_ms(nbytes, 4.0 * visible * NH * Dh, "bf16" if qdt == bf else "f32")
        if label == "7b" and S == 49:
            stats.add("decode_attention", ms, pms, bms, by, None,
                      "one frame chunk: S=49, 28 heads over 2049 slots, bf16")
        print(f"phase2 {what} NH={NH} KVH={KVH} q={_dt(qdt)} kv={_dt(kvdt)} "
              f"max_abs_err={err:.3e} (of max|y_ref| {ref.float().abs().max().item():.3e}) "
              f"path={path_name} "
              f"splits={pl.splits}x{pl.span} blocks={pl.blocks} equal_twice kernel_ms={ms:.4f} "
              f"loop_ms={loop:.4f} kv_copies={copies} plain_ms={pms:.4f} bound_ms={bms:.4f} "
              f"({by}){note} library_ms=none", flush=True)


def replay_loop(q_rot, k_cache, v_cache, k_infl, v_infl, slots, steps):
    """The verify pass's attention as the sequential passes compute it, one
    write pass after another: each composed step's in-flight rows written into
    their slots of the layer's cache, its rows attended through
    ``decode_attention`` with its own tables, the slots restored at the end
    (on the cache it is given)."""
    import torch

    from aha_tpu_torch.ops.kernels import decode_attention as da

    B, N = slots.shape
    step = N // len(steps)
    bidx = torch.arange(B, device=q_rot.device)[:, None]
    every = (bidx, slots.long())
    old_k, old_v = k_cache[every], v_cache[every]
    out = []
    for j, t in enumerate(steps):
        rows = slice(j * step, (j + 1) * step)
        mine = (bidx, slots[:, rows].long())
        k_cache[mine] = k_infl[:, rows]
        v_cache[mine] = v_infl[:, rows]
        out.append(da.decode_attention(q_rot[:, rows].contiguous(), k_cache, v_cache, t.d_cos,
                                       t.d_sin, t.mask_order, t.mask_g))
    k_cache[every], v_cache[every] = old_k, old_v
    return torch.cat(out, dim=1)


def steps_inputs(gen, B, n, step, NH, KVH, qdt, kvdt, prefill, valid):
    """One layer of the product's sink cache (2,048 + 32 sinks, 2,049 slots) at the 7B's
    head size, keys and values random, its metadata after ``prefill`` tokens in write
    passes of 49; the plans of a verify pass of ``n`` steps of ``step`` rows (``valid``
    rows a batch row), its tables (``step_tables``), q unrotated and rotated as
    ``replayed_attention`` rotates it, and the in-flight rows, keys pre-rotated."""
    import torch

    from aha_tpu_torch.ops import attention, kv_cache, spec_decode
    from aha_tpu_torch.ops.rope import apply_rope

    policy = kv_cache.CachePolicy("sink", window=2048, num_sink=32)
    cache = kv_cache.init_cache(policy, num_layers=1, batch=B, num_kv_heads=KVH, head_dim=128,
                                dtype=kvdt, device="cuda")
    for t in (cache.k, cache.v):
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda").to(kvdt))
    left = prefill
    while left > 0:
        c = min(49, left)
        kv_cache.advance(cache, kv_cache.plan_update(
            cache, policy, torch.full((B,), c, dtype=torch.int32, device="cuda"), c))
        left -= c
    N = n * step
    plans = spec_decode.plan_compose(cache, policy, torch.tensor(valid, dtype=torch.int32,
                                                                 device="cuda"), n, step=step)
    tables = attention.step_tables(plans, policy, 128, STEPS_THETA)
    q = torch.randn((B, N, NH, 128), generator=gen, device="cuda").to(qdt)
    k, v = (torch.randn((B, N, KVH, 128), generator=gen, device="cuda").to(qdt)
            for _ in range(2))
    k_rot = apply_rope(k.float(), tables.w_cos, tables.w_sin).to(qdt)
    q_rot = apply_rope(q.float(), tables.w_cos, tables.w_sin).to(qdt)
    if qdt == torch.bfloat16 and kvdt == torch.float32:
        q_rot = q_rot.float()
    return policy, cache, plans, tables, q, q_rot.contiguous(), k_rot, v


STEPS_THETA = 1e6    # the 7B's rope_theta


def check_attention_steps(gen, stats: Stats):
    """``decode_attention_steps`` (the verify pass's attention in one launch) at the
    shapes of the 7B's verify passes, on the product's sink cache past its fill (and in
    its fill transient): bit for bit the loop it replaced (``replay_loop``: each
    step's rows written into the cache and attended through ``decode_attention``),
    equal bits twice, the cache untouched, within 1e-2 x max (bf16) / 1e-4 (f32) of
    the plain version; timed beside the plain version and both routes it replaced,
    the loop and the composed ``speculative_attention`` (one softmax over cache and
    in-flight columns, which fused scoring ran), K / V cycled past L2, each
    from a replayed CUDA graph."""
    import torch

    from aha_tpu_torch.ops import attention
    from aha_tpu_torch.ops.kernels import decode_attention as da
    from aha_tpu_torch.ops.kernels.int8_matmul import num_sms

    bf, f32 = torch.bfloat16, torch.float32
    F = 49
    world = p11_world()
    # (label, B, steps, rows a step, q heads, kv heads, q, kv, prefill, valid rows, timed):
    # fused scoring (4 frames; 8 under --w8a8 and the chunked loop's fused 8; 50 tokens
    # with a CLS token), speculative generation (4 and 8 tokens), B 1 and 8, f32 q behind a
    # peft artifact's f32 projector over the bf16 cache and phase 6's f32 traces over an
    # f32 cache, bf16 q over an f32 cache, a rank's heads at phase 11a's model width,
    # ragged rows, the sink cache in its fill transient
    seven = dict(NH=28, KVH=4, q=bf, kv=bf, prefill=2500, valid=None, timed=False)
    cases = [dict(seven, label="7b-fused", B=1, n=4, step=F, timed=True),
             dict(seven, label="7b-b8-fused", B=SERVE_B, n=4, step=F, timed=True),
             dict(seven, label="7b-f32-fused", B=1, n=4, step=F, q=f32, timed=True),
             dict(seven, label="7b-spec", B=1, n=4, step=1, timed=True),
             dict(seven, label="7b-spec", B=1, n=8, step=1, timed=True),
             dict(seven, label="7b-b8-spec", B=SERVE_B, n=4, step=1, timed=True),
             dict(seven, label="7b-b8-spec", B=SERVE_B, n=8, step=1),
             dict(seven, label="7b-f32-f32-fused", B=1, n=4, step=F, q=f32, kv=f32),
             dict(seven, label="7b-bf16q-f32kv", B=1, n=4, step=F, kv=f32),
             dict(seven, label="7b-bf16q-f32kv", B=1, n=4, step=1, kv=f32),
             dict(seven, label="7b-fused8", B=1, n=8, step=F),
             dict(seven, label="7b-cls-fused", B=1, n=4, step=F + 1),
             dict(seven, label="7b-ragged", B=2, n=4, step=F, valid=(4 * F, 2 * F)),
             dict(seven, label="7b-ragged", B=2, n=4, step=1, valid=(4, 1)),
             dict(seven, label="7b-fill-transient", B=1, n=4, step=F, prefill=2048 + 32 - 120),
             dict(seven, label="7b-fill-transient", B=1, n=8, step=1, prefill=2048 + 32 - 5)]
    local = dict(seven, NH=28 // world, KVH=4 // world)
    cases += [dict(local, label="7b-b8-tp", B=SERVE_B, n=n, step=st)
              for n, st in ((4, F), (4, 1), (8, 1))]
    sms = num_sms(0)
    for c in cases:
        label, B, n, step, NH, KVH, qdt, kvdt = (c[k] for k in (
            "label", "B", "n", "step", "NH", "KVH", "q", "kv"))
        N = n * step
        valid = c["valid"] or (N,) * B
        policy, cache, plans, t, q, q_rot, k_rot, v = steps_inputs(
            gen, B, n, step, NH, KVH, qdt, kvdt, c["prefill"], valid)
        kc, vc = cache.k[0], cache.v[0]
        ki, vi = k_rot.to(kvdt).contiguous(), v.to(kvdt).contiguous()
        args = (q_rot, kc, vc, ki, vi, t.d_cos, t.d_sin, t.mask_order, t.mask_g, t.src)
        what = f"decode_attention_steps {label} B={B} steps={n}x{step} NH={NH} KVH={KVH}"
        tol = 1e-2 if q_rot.dtype == bf else 1e-4
        pl = da.plan_steps(n, B, N, NH, KVH, 128, 2049, q_rot.dtype, kvdt, sms=sms)
        if pl != da.plan(B, step, NH, KVH, 128, 2049, q_rot.dtype, kvdt, sms=sms):
            raise AssertionError(f"{what}: a step's plan is not its write pass's")
        before = (kc.clone(), vc.clone())
        y = da.decode_attention_steps(*args)
        steps = [attention.chunk_tables(p, policy, 128, STEPS_THETA) for p in plans.steps]
        ref_loop = replay_loop(q_rot, kc.clone(), vc.clone(), ki, vi, plans.slots, steps)
        ref = da.decode_attention_steps_plain(*args)
        torch.cuda.synchronize()
        err = rel_check(what, y, ref, tol)
        if not torch.equal(y, ref_loop):
            raise AssertionError(f"{what}: differs from the replay loop through decode_attention "
                                 f"by up to {(y.float() - ref_loop.float()).abs().max().item():.3e}")
        if not torch.equal(y, da.decode_attention_steps(*args)):
            raise AssertionError(f"{what}: two launches on the same inputs differ")
        if not (torch.equal(kc, before[0]) and torch.equal(vc, before[1])):
            raise AssertionError(f"{what}: the cache was written")
        alone = ""
        if B > 1:
            # each batch row is its launch alone, bit for bit: the splits follow no batch
            for b in range(B):
                one = [a[b:b + 1] for a in args[:5]] + [a[:, b:b + 1].contiguous()
                                                        for a in args[5:8]]
                y_b = da.decode_attention_steps(*one, args[8][b:b + 1],
                                                args[9][:, b:b + 1].contiguous())
                if not torch.equal(y[b:b + 1], y_b):
                    raise AssertionError(f"{what}: batch row {b} differs from its launch alone")
            alone = " rows_equal_alone"
        stats.err("decode_attention_steps", err)
        key = (("decode_attention_steps", n, step, 2049)
               + (("f32",) if q_rot.dtype == f32 else ()) + ((f"B{B}",) if B > 1 else ())
               + ((f"H{NH}",) if NH != 28 else ()))
        stats.checked.add(key)
        head = (f"phase2 {what} q={_dt(q_rot.dtype)} kv={_dt(kvdt)} max_abs_err={err:.3e} "
                f"(of max|y_ref| {ref.float().abs().max().item():.3e}) path="
                f"{da.PATH_NAMES[pl.path]} splits={pl.splits}x{pl.span} blocks={n}x{pl.blocks} "
                f"equal_to_loop equal_twice cache_untouched{alone}")
        if not c["timed"]:
            print(f"{head} (held, not timed)", flush=True)
            continue
        kv_bytes = 2 * kc.numel() * kc.element_size()
        copies = max(12, min(64, math.ceil(100e6 / kv_bytes)))
        kvs = [(kc.clone(), vc.clone()) for _ in range(copies)]
        run = lambda i: da.decode_attention_steps(q_rot, *kvs[i % copies], *args[3:])
        loop_run = lambda i: replay_loop(q_rot, *kvs[i % copies], ki, vi, plans.slots, steps)
        exact = bool(plans.exact)
        spec = attention.spec_tables(plans, True, 128, STEPS_THETA, exact)
        composed = lambda i: attention.speculative_attention(q, *kvs[i % copies], k_rot, v, spec,
                                                             sink_slots=policy.num_sink)
        # device time from replayed graphs, the kernel and both routes alike (the routes'
        # many small launches would time the host), events around host calls beside it
        loop = cuda_ms(run)
        ms, loop_ms, composed_ms = graph_ms(run), graph_ms(loop_run), graph_ms(composed)
        pms = cuda_ms(lambda i: da.decode_attention_steps_plain(*args), iters=3, warmup=1)
        del kvs
        # q in, out, the cache's K and V, the in-flight rows, the steps' tables (two rotation
        # tables, order and sources a step) and g; scores and weighted values over the slots
        # each step's mask admits
        nbytes = sum(x.numel() * x.element_size() for x in args) + y.numel() * y.element_size()
        visible = sum(((t.mask_order[j][:, None, :] >= 0)
                       & (t.mask_order[j][:, None, :] <= t.mask_g[:, j * step:(j + 1) * step, None]))
                      .sum().item() for j in range(n))
        if pl.path == da.WGMMA_F32:
            planes = 5 + (4 if kvdt == f32 else 3)
            bms, by = bound_ms(nbytes, planes * 2.0 * visible * NH * 128, "bf16")
        else:
            bms, by = bound_ms(nbytes, 4.0 * visible * NH * 128, "bf16" if q_rot.dtype == bf
                               else "f32")
        if label == "7b-fused":
            stats.add("decode_attention_steps", ms, pms, bms, by, None,
                      "a fused pass's layer: 4 steps of 49 rows, 28 heads over 2049 slots, bf16")
        print(f"{head} kernel_ms={ms:.4f} loop_ms={loop:.4f} kv_copies={copies} "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) replaced_loop_ms={loop_ms:.4f} "
              f"replaced_composed_ms={composed_ms:.4f} (exact branch {exact}) library_ms=none",
              flush=True)


def check_row_free_products(gen, stats: Stats):
    """bf16 x weight-only ``int8_matmul`` from 17 rows splits K by the weight's shape
    alone (``row_free_splits``), on the one-warpgroup and the warp-specialised
    kernel alike: at the decoder layer's four weights, rows 0 .. M - 1 of a product
    of 1,568 rows (B 8's fused pass) are the product of those M rows alone, bit for
    bit, at a prompt's 17 rows, a frame step's 49, a fused pass's 196 and B 8's frame
    step's 392."""
    import torch

    from aha_tpu_torch.ops.kernels import int8_matmul as k8

    sms = k8.num_sms(0)
    for name, K, N in LAYER:
        x = torch.randn((1568, K), generator=gen, device="cuda").to(torch.bfloat16)
        w = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
        sc = (torch.rand((N,), generator=gen, device="cuda") + 0.5) * 0.01
        y = k8.int8_matmul(x, w, sc)
        plans = []
        for M in (17, 49, 196, 392, 1568):
            pl = k8.plan(M, K, N, bf16=True, sms=sms)
            plans.append(f"{M}:{k8.PATH_NAMES[pl.path]}/{pl.tile}x{pl.tiles}/{pl.splits}")
            if M < 1568 and not torch.equal(k8.int8_matmul(x[:M], w, sc), y[:M]):
                raise AssertionError(f"int8_matmul {name}: the first {M} rows of 1568 differ "
                                     f"from their product alone ({plans[-1]})")
        print(f"phase2 int8_matmul {name} K={K} N={N} rows of 17, 49, 196 and 392 equal bit "
              f"for bit to the first rows of 1568 (path/tile x tiles/splits {' '.join(plans)}; "
              f"row_free_splits {k8.row_free_splits(K, N, sms)})", flush=True)
        del x, w


def check_int4_matmul_t(gen, stats: Stats):
    """``int4_matmul_t`` (g @ W^T, the backward of ``int4_qlinear``) against
    its plain version: the four layer products transposed at the training
    sequence's rows, and small ragged shapes on both of its paths."""
    import torch

    from aha_tpu_torch.ops.kernels import int4_matmul_t as kt

    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    # (label, M, K, N, G, dtype, tol)
    cases = [(n, M, K, N, 128, bf, 1e-2) for M in (TRAIN_T, 196, *TRAIN_CLI_M)
             for n, K, N in LAYER]
    if p11_world() == 4:
        # phase 11b at 4 ranks: FSDP x TP's local products over 2 rows, one rank's over 4
        cases += [(n, 2 * P11_T, K, N, 128, bf, 1e-2) for n, K, N in LAYER_TP2]
        cases += [(n, 4 * P11_T, K, N, 128, bf, 1e-2) for n, K, N in LAYER]
    # row counts that straddle the wgmma kernel's token tiles (128 rows at most),
    # the projector's rows, G = 64 and 256
    cases += [("tile-edge", M, 3584, 3584, 128, bf, 1e-2)
              for M in (1, 127, 128, 129, 231, 232, 233, 257, 1568)]
    cases += [("g64", 100, 1024, 1024, 64, bf, 1e-2), ("g256", 100, 1024, 1024, 256, bf, 1e-2),
              ("g256", 926, 3584, 3584, 256, bf, 1e-2)]
    # shapes the wgmma kernel does not take: f32, N not a multiple of 64 (mma.sync
    # from a multiple of 32, else CUDA cores), G not a multiple of 64
    cases += [("ragged", 7, 128, 77, 128, f32, 1e-4), ("ragged", 1, 64, 33, 64, f32, 1e-4),
              ("ragged", 13, 384, 130, 64, f32, 1e-4), ("ragged", 5, 96, 48, 6, f32, 1e-4),
              ("ragged", 9, 64, 50, 64, bf, 1e-2), ("old-path-g68", 70, 136, 320, 68, bf, 1e-2),
              ("old-path-n96", 70, 256, 96, 64, bf, 1e-2)]
    layer_names = {n for n, _, _ in LAYER + LAYER_TP2}
    for label, M, K, N, G, dt, tol in cases:
        wbytes = K * N // 2
        copies = max(1, math.ceil(160e6 / wbytes))
        ws = [torch.randint(0, 256, (K // 2, N), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(copies)]
        sc = ((torch.rand((K // G, N), generator=gen, device=dev) + 0.5) * (0.02 / 7)).to(bf)
        g = torch.randn((M, N), generator=gen, device=dev).to(dt)
        y, ref = kt.int4_matmul_t(g, ws[0], sc), kt.int4_matmul_t_plain(g, ws[0], sc)
        torch.cuda.synchronize()
        what = f"int4_matmul_t {label} M={M} K={K} N={N} G={G}"
        err = rel_check(what, y, ref, tol)
        stats.err("int4_matmul_t", err)
        stats.checked.add(("int4_matmul_t", M, K, N))
        pl = kt.plan(M, K, N, G, bf16=dt == bf)
        want_new = dt == bf and label in layer_names | {"tile-edge", "g64", "g256"}
        if (pl.path == kt.WGMMA) != want_new:
            raise AssertionError(f"{what}: path {pl.path}, wgmma expected: {want_new}")
        # no sum crosses blocks: the same bits from a second launch
        if not torch.equal(y, kt.int4_matmul_t(g, ws[0], sc)):
            raise AssertionError(f"{what}: two launches on the same inputs differ")
        note = f" path={pl.path} tile={pl.tile}x{pl.tiles} smem={pl.smem_bytes} equal_twice"
        ms = cuda_ms(lambda i: kt.int4_matmul_t(g, ws[i % copies], sc))
        short = ms < 0.1
        if short:
            # shorter than the host's work to launch it: device time from a graph
            note += f" loop_ms={ms:.4f}"
            ms = graph_ms(lambda i: kt.int4_matmul_t(g, ws[i % copies], sc))
        pms = cuda_ms(lambda i: kt.int4_matmul_t_plain(g, ws[i % copies], sc), iters=3, warmup=1)
        esize = g.element_size()
        bms, by = bound_ms(M * N * esize + wbytes + 2 * (K // G) * N + M * K * esize,
                           2.0 * M * K * N, "bf16" if dt == bf else "f32")
        lib = None
        if label in layer_names:
            # the bf16 product alone, on a weight dequantised beforehand
            lib = product_only_ms(g, dequantized(ws[0], sc), short, transposed=True)
        if M == TRAIN_T and lib is not None:
            stats.add("int4_matmul_t", ms, pms, bms, by, lib,
                      f"decoder layer (qkv, o_proj, gate_up, down) transposed at M={M}, bf16")
        print(f"phase2 {what} {_dt(dt)} max_abs_err={err:.3e}{note} kernel_ms={ms:.4f} "
              f"plain_ms={pms:.4f} bound_ms={bms:.4f} ({by}) library_ms="
              f"{'none' if lib is None else f'{lib:.4f}'}", flush=True)
        del ws


def check_flash_attention(gen, stats: Stats):
    """The forward and the backward kernel of ``flash_causal_attention``
    against their plain versions, with and without a left-padding mask, and
    beside ``scaled_dot_product_attention`` (timed only). The backward kernel
    and its plain version get the same o, lse and dout."""
    import torch
    import torch.nn.functional as F

    from aha_tpu_torch.ops.kernels import flash_attention as fa

    dev = "cuda"
    bf, f32 = torch.bfloat16, torch.float32
    # (label, B, T, NH, KVH, Dh, dtype, left padding per batch row or None, tol fwd, tol bwd).
    # bf16 with Dh 128 runs on the tensor cores with p and ds rounded to bf16 (about 5e-3 of
    # the maximum seen forward, up to 8e-3 backward); everything else in f32 on the CUDA cores.
    # T = 63 .. 129 cross the edges of the 64-key tiles and of the 64-row blocks;
    # T = 4096 shows the kernels where the launch cost does not hide them.
    cases = [("7b", 1, TRAIN_T, 28, 4, 128, bf, None, 1e-2, 2e-2),
             ("7b-padded", 1, TRAIN_T, 28, 4, 128, bf, (37,), 1e-2, 2e-2),
             # phase 5b's collated batches: left-padded rows at the length bucket 1,024
             ("7b-collated", 2, 1024, 28, 4, 128, bf, (90, 333), 1e-2, 2e-2),
             ("7b-collated", 1, 1024, 28, 4, 128, bf, (107,), 1e-2, 2e-2),
             ("7b-ragged", 2, 77, 28, 4, 128, bf, (0, 9), 1e-2, 2e-2),
             *[("7b-edge", 1, T, 28, 4, 128, bf, None, 1e-2, 2e-2) for T in (63, 64, 65, 129)],
             ("7b-edge-padded", 2, 129, 28, 4, 128, bf, (0, 70), 1e-2, 2e-2),
             ("7b-long", 1, 4096, 28, 4, 128, bf, None, 1e-2, 2e-2),
             # phase 11b: a rank's heads at model 2 over 2 rows of 1,024 tokens, and the
             # one-rank step of the ring batch (ring_min_seq tokens)
             ("7b-tp2", 2, P11_T, 14, 2, 128, bf, (P11_T - TRAIN_T,) * 2, 1e-2, 2e-2),
             ("7b-ring-one-rank", 1, P11_RING_T, 28, 4, 128, bf, (37,), 1e-2, 2e-2),
             *([("7b-tp", 2, P11_T, 14, 2, 128, bf, (98, 98), 1e-2, 2e-2),
                ("7b-tp4", 4, P11_T, 7, 1, 128, bf, (98,) * 4, 1e-2, 2e-2),
                ("7b-four-rows", 4, P11_T, 28, 4, 128, bf, (98,) * 4, 1e-2, 2e-2)]
               if p11_world() == 4 else []),
             ("gqa3-bf16", 3, 70, 6, 2, 128, bf, (0, 33, 69), 1e-2, 2e-2),
             ("mha-bf16", 1, 100, 2, 2, 128, bf, None, 1e-2, 2e-2),
             ("tiny", 2, 45, 4, 2, 16, f32, None, 1e-4, 1e-4),
             ("tiny-padded", 3, 70, 4, 2, 16, f32, (0, 33, 69), 1e-4, 1e-4),
             ("ragged", 1, 70, 14, 2, 128, f32, (5,), 1e-4, 1e-4),
             ("tiny-bf16", 2, 33, 6, 2, 16, bf, (0, 4), 1e-2, 2e-2)]
    for label, B, T, NH, KVH, Dh, dt, pad, tol_f, tol_b in cases:
        q, k, v, dout = (torch.randn((B, T, h, Dh), generator=gen, device=dev).to(dt)
                         for h in (NH, KVH, KVH, NH))
        valid = None
        if pad is not None:
            valid = torch.arange(T, device=dev)[None] >= torch.tensor(pad, device=dev)[:, None]
        o, lse = fa.flash_attention_fwd(q, k, v, valid)
        o_ref, lse_ref = fa.flash_attention_fwd_plain(q, k, v, valid)
        o_ref = o_ref.contiguous()      # a strided view where a kv head has one query head
        grads = fa.flash_attention_bwd(q, k, v, o_ref, dout, lse_ref, valid)
        grads_ref = fa.flash_causal_attention_bwd_plain(q, k, v, o_ref, dout, lse_ref, valid)
        torch.cuda.synchronize()
        what = f"B={B} T={T} NH={NH} KVH={KVH} Dh={Dh} {_dt(dt)} key_valid={pad}"
        err_f = rel_check(f"flash_attention_fwd {label} {what} o", o, o_ref, tol_f)
        empty = torch.isinf(lse_ref)
        if not torch.equal(torch.isinf(lse), empty):
            raise AssertionError(f"flash_attention_fwd {label} {what}: rows that see no key differ")
        if pad is not None and any(pad) and not bool(empty.any()):
            raise AssertionError(f"flash_attention_fwd {label} {what}: no padded row in the case")
        rel_check(f"flash_attention_fwd {label} {what} lse", lse.masked_fill(empty, 0.0),
                  lse_ref.masked_fill(empty, 0.0), tol_f)
        err_b = max(rel_check(f"flash_attention_bwd {label} {what} {n}", a, b, tol_b)
                    for n, a, b in zip(("dq", "dk", "dv"), grads, grads_ref))
        # no sum crosses blocks out of order and no atomic is used: the same bits twice
        again = (*fa.flash_attention_fwd(q, k, v, valid),
                 *fa.flash_attention_bwd(q, k, v, o_ref, dout, lse_ref, valid))
        for n, a, b in zip(("o", "lse", "dq", "dk", "dv"), (o, lse, *grads), again):
            if not torch.equal(a, b):
                raise AssertionError(f"flash_attention {label} {what}: {n} differs between two "
                                     f"launches on the same inputs")
        del again
        stats.err("flash_attention_fwd", err_f)
        stats.err("flash_attention_bwd", err_b)
        stats.checked.add(("flash_attention", B, T, NH, KVH, Dh))

        # the kernels at T = 926 are shorter than their wrappers' Python: device time from
        # a replayed CUDA graph for them and the library call, plain loops beside it (loop_ms)
        ms_f = graph_ms(lambda i: fa.flash_attention_fwd(q, k, v, valid))
        ms_b = graph_ms(lambda i: fa.flash_attention_bwd(q, k, v, o_ref, dout, lse_ref, valid))
        loop_f = cuda_ms(lambda i: fa.flash_attention_fwd(q, k, v, valid))
        loop_b = cuda_ms(lambda i: fa.flash_attention_bwd(q, k, v, o_ref, dout, lse_ref, valid))
        pms_f = cuda_ms(lambda i: fa.flash_attention_fwd_plain(q, k, v, valid), iters=3, warmup=1)
        pms_b = cuda_ms(lambda i: fa.flash_causal_attention_bwd_plain(
            q, k, v, o_ref, dout, lse_ref, valid), iters=3, warmup=1)
        # one PyTorch call for the same function: timed, never used. With a padding mask it
        # takes a boolean mask, causal and key-valid; a padded query row that sees no key is
        # NaN there and 0 in the kernel, so only the time is compared
        qt, kt_, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = dout.transpose(1, 2)
        mask = None
        if valid is not None:
            causal = torch.ones((T, T), dtype=torch.bool, device=dev).tril()
            mask = causal[None, None] & valid[:, None, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(qt, kt_, vt, attn_mask=mask,
                                                      is_causal=mask is None, enable_gqa=True)
        with torch.no_grad():
            lib_f = graph_ms(lambda i: sdpa())
        # a graph holds a backward only with its forward: the difference of the two
        lib_b = graph_ms(lambda i: torch.autograd.grad(sdpa(), (qt, kt_, vt), dot)) - lib_f
        # the (query, key) pairs this mask admits; 4 Dh operations a pair and head forward
        # (scores and weighted sum), 2.5 times that backward
        qpos = torch.arange(T, device=dev)
        admitted = torch.ones((B, T), dtype=torch.bool, device=dev) if valid is None else valid
        pairs = int(((qpos[None, :, None] >= qpos[None, None, :]) & admitted[:, None, :]).sum())
        ops = 4.0 * pairs * NH * Dh
        es = q.element_size()
        io = (2 * q.numel() + 2 * k.numel()) * es + lse.numel() * 4
        kind = "bf16" if dt == bf else "f32"
        b_f, by_f = bound_ms(io, ops, kind)
        b_b, by_b = bound_ms(io + (3 * q.numel() + 2 * k.numel()) * es, 2.5 * ops, kind)
        if label == "7b":
            shape = f"one layer: B={B} T={T}, {NH} / {KVH} heads, Dh {Dh}, bf16, causal"
            stats.add("flash_attention_fwd", ms_f, pms_f, b_f, by_f, lib_f, shape)
            stats.add("flash_attention_bwd", ms_b, pms_b, b_b, by_b, lib_b, shape)
        print(f"phase2 flash_attention_fwd {label} {what} max_abs_err={err_f:.3e} equal_twice "
              f"kernel_ms={ms_f:.4f} loop_ms={loop_f:.4f} plain_ms={pms_f:.4f} "
              f"bound_ms={b_f:.4f} ({by_f}) library_ms={lib_f:.4f}", flush=True)
        print(f"phase2 flash_attention_bwd {label} {what} max_abs_err={err_b:.3e} equal_twice "
              f"kernel_ms={ms_b:.4f} loop_ms={loop_b:.4f} plain_ms={pms_b:.4f} "
              f"bound_ms={b_b:.4f} ({by_b}) library_ms={lib_b:.4f}", flush=True)


# -- phases 3 and 4 --------------------------------------------------------------


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _model(preset: str):
    from aha_tpu_torch.config import aha_7b, aha_tiny
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    cfg = {"tiny": aha_tiny, "7b": aha_7b}[preset]()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    return cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id), tok


def tiny_slice(device: str, params, cfg, tok, frames, backend: str, widths: dict):
    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.session import build_session

    common = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=16,
                  **widths)
    s = build_session(params, cfg, tok, InferConfig(
        stream_end_score_sum_threshold=2.5, max_new_tokens=16, **common),
        device=device, backend=backend)
    s.input_video_stream(frames)
    s.input_query_stream([{"role": "user", "content": "What is happening?", "time": 0}])
    turns = s.inference()
    sv = build_session(params, cfg, tok, InferConfig(grounding_mode=True, **common),
                       device=device, backend=backend
                       ).score_video(frames, query="What is happening?")
    return ([[r[k] for k in SCORE_KEYS] for r in s.debug_data_list + sv],
            [t["content"] for t in turns if t["role"] == "assistant"])


def _first_divergence(a: list[str], b: list[str]) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next((k for k, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
            return f" first divergence: response {i} char {j}"
    return "" if len(a) == len(b) else f" first divergence: response {min(len(a), len(b))}"


def phase3(seed: int):
    import numpy as np
    import torch

    from aha_tpu_torch.models.aha import random_params

    cfg, tok = _model("tiny")
    frames = np.random.default_rng(seed).integers(0, 255, (24, 40, 48, 3), dtype=np.uint8)
    w1 = dict(fused_score_frames=1, spec_decode_tokens=1)
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    cases = [("int8", "fused", w1, 1e-3), ("int4", "fused", product, 1e-3),
             ("int8", "fused_a8", w1, 1e-2), ("int8", "pallas", w1, 1e-3)]
    for mode, backend, widths, atol in cases:
        cpu = random_params(cfg, mode=mode, device="cpu", seed=seed)
        gpu = _to(cpu, "cuda")
        s_gpu, t_gpu = tiny_slice("cuda", gpu, cfg, tok, frames, backend, widths)
        s_cpu, t_cpu = tiny_slice("cpu", cpu, cfg, tok, frames, backend, widths)
        a, b = np.asarray(s_gpu), np.asarray(s_cpu)
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"tiny {mode}/{backend}: scores {a.shape} vs {b.shape} "
                                 f"or non-finite")
        err = float(np.abs(a - b).max())
        if not err <= atol:
            raise AssertionError(f"tiny {mode}/{backend}: card vs CPU scores differ by "
                                 f"{err:.3e} > {atol}")
        note = ""
        if widths is product:
            # the exactness contract on the card, in f32: speculative 4 -> 8
            # and fused-4 against width 1, same kernels, same weights
            s_one, t_one = tiny_slice("cuda", gpu, cfg, tok, frames, backend, w1)
            d = float(np.abs(a - np.asarray(s_one)).max())
            if t_gpu != t_one or not d <= 1e-4:
                raise AssertionError(
                    f"tiny {mode}: widths 4 / 4->8 vs widths 1 on the card: scores differ by "
                    f"{d:.3e}, texts equal {t_gpu == t_one}{_first_divergence(t_gpu, t_one)}")
            note = f" vs-width-1-on-card: scores max_abs_diff={d:.3e} texts identical"
        print(f"phase3 tiny {mode} backend={backend} widths={widths['fused_score_frames']}/"
              f"{widths['spec_decode_tokens']}->{widths.get('spec_decode_tokens_max', 1)} "
              f"card-vs-cpu: {len(a)} frame scores max_abs_err={err:.3e} (atol {atol}) "
              f"responses={len(t_gpu)}/{len(t_cpu)} texts_match={t_gpu == t_cpu}"
              f"{_first_divergence(t_gpu, t_cpu)}{note}", flush=True)
        del gpu
    torch.cuda.empty_cache()


# -- training: phase 3 (tiny, card against CPU) and phase 5 (7B int4 QLoRA) ------------

LOSS_PARTS = ("total", "lm", "video", "info", "relevance", "tv", "uncertainty")
QLORA_DENSE = ("projector", "lm_head")


def phase3_train(seed: int):
    import numpy as np
    import torch

    from aha_tpu_torch.config import LoraConfig, TrainConfig
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.train import trainer
    from aha_tpu_torch.train.lora import init_lora

    cfg, tok = _model("tiny")
    batch, T = trainer.synthetic_batch(cfg, tok, np.random.default_rng(seed), n_frames=6, B=2)
    tc = TrainConfig(learning_rate=1e-3, warmup_ratio=0.0, grad_accum_steps=1,
                     remat_policy="full", lora=LoraConfig(dropout=0.0))
    runs = {}
    kernels.reset_launches()
    for device in ("cuda", "cpu"):
        # weights and adapters from the CPU's generator for both: a card's draws differ
        params = random_params(cfg, mode="int4", keep_dense=QLORA_DENSE, device="cpu", seed=seed)
        adapters = init_lora(cfg.llm, tc.lora, seed=seed, device="cpu")
        state, tx, labels, scale = trainer.init_train_state(
            cfg, tc, _to(params, device), total_steps=10, lora_init=_to(adapters, device),
            device=device)
        step = trainer.make_train_step(cfg, tc, tx, labels, scale, device=device)
        parts = []
        for _ in range(3):
            state, p = step(state, batch)
            parts.append([float(getattr(p, n)) for n in LOSS_PARTS])
        runs[device] = (np.asarray(parts), {n: t.detach().float().cpu().numpy() for n, t in
                                            trainer.trained_leaves(state.tree, labels).items()})
    counts = dict(kernels.LAUNCHES)
    L = cfg.llm.num_layers
    # merged qkv and gate_up: four int4 products a layer, each run again in the replay; the
    # tiny preset trains in f32, so each product (B T rows) takes the f32 wgmma path behind
    # a split of x into bf16 planes
    want = {"int4_matmul": 3 * 2 * 4 * L, "split_bf16x3": 3 * 2 * 4 * L,
            "int4_matmul_t": 3 * 4 * L, "flash_attention_fwd": 3 * 2 * L,
            "flash_attention_bwd": 3 * L}
    if counts != want:
        raise AssertionError(f"tiny train: launches {counts}, expected {want}")
    (pg, lg), (pc, lc) = runs["cuda"], runs["cpu"]
    err = float(np.abs(pg - pc).max())
    if not np.isfinite(pg).all() or not err <= 1e-3:
        raise AssertionError(f"tiny train: loss parts card vs CPU differ by {err:.3e} > 1e-3")
    worst = 0.0
    for name, a in lg.items():
        rel = float(np.abs(a - lc[name]).max() / max(np.abs(lc[name]).max(), 1e-30))
        worst = max(worst, rel)
        if not rel <= 1e-3:
            raise AssertionError(f"tiny train: trained leaf {name} card vs CPU differs by "
                                 f"{rel:.3e} of its maximum > 1e-3")
    if not np.abs(lg["lora/q_proj/b"]).max() > 0:
        raise AssertionError("tiny train: the adapters did not move")
    print(f"phase3 tiny int4 QLoRA train, 3 steps at B=2 T={T} remat=full card-vs-cpu: loss "
          f"parts max_abs_err={err:.3e} (atol 1e-3), {len(lg)} trained leaves max_rel_err="
          f"{worst:.3e} (1e-3 of each leaf's max); losses {[round(float(x), 4) for x in pg[:, 0]]}; "
          f"launches {counts}", flush=True)


# phase 5a: the adapters' gradients under each remat policy against remat 'none''s,
# as the largest ||g - g_none|| / ||g_none|| over each leaf's layer slices
GRAD_RTOL = 5e-2


def _grad_rel_diff(got: dict, ref: dict) -> float:
    worst = 0.0
    for n, r in ref.items():
        diff = (got[n] - r).flatten(1).norm(dim=1)
        worst = max(worst, float((diff / r.flatten(1).norm(dim=1).clamp_min(1e-30)).max()))
    return worst


@contextlib.contextmanager
def _stale_replay(qwen2):
    """remat 'dots' with a fault: in the backward every layer is handed back
    the products that the layer before it kept (layer 0 its own)."""
    kept = []

    class StaleStash(qwen2.ProductStash):
        def replay(self):
            super().replay()
            kept.append(self.outs)
            if len(kept) > 1:
                self.outs = kept[-2]

    real = qwen2.ProductStash
    qwen2.ProductStash = StaleStash
    try:
        yield
    finally:
        qwen2.ProductStash = real


def _checksum(t) -> int:
    import torch

    return int(t.view(torch.uint8).to(torch.int64).sum())


def phase5(gpu: str, seed: int, stats: Stats):
    import numpy as np
    import torch

    from aha_tpu_torch.config import TrainConfig
    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.train import trainer

    cfg, tok = _model("7b")
    L = cfg.llm.num_layers
    batch, T = trainer.synthetic_batch(cfg, tok, np.random.default_rng(seed), n_frames=16)
    if T != TRAIN_T:
        raise AssertionError(f"7b train: the conversation has {T} tokens, phase 2 checked "
                             f"{TRAIN_T}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = random_params(cfg, mode="int4", keep_dense=QLORA_DENSE, seed=seed)
    tc = TrainConfig(learning_rate=1e-4, warmup_ratio=0.0, grad_accum_steps=1,
                     remat_policy="full")
    state, tx, labels, scale = trainer.init_train_state(cfg, tc, params, total_steps=100,
                                                        seed=seed)
    step = trainer.make_train_step(cfg, tc, tx, labels, scale)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    layers = params["llm"]["layers"]
    frozen = {"qkv_proj q4value": layers["qkv_proj"]["kernel"]["q4value"],
              "qkv_proj scale4": layers["qkv_proj"]["kernel"]["scale4"],
              "embedding table": params["llm"]["embed"]["weight"]["qvalue"]}
    sums = {n: _checksum(t) for n, t in frozen.items()}
    n_trained = sum(t.numel() for t in trainer.trained_leaves(state.tree, labels).values())
    want = {"int4_matmul": 2 * 4 * L, "int4_matmul_t": 4 * L, "flash_attention_fwd": 2 * L,
            "flash_attention_bwd": L}

    def timed_step():
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, parts = step(state, batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, float(parts.total), parts

    losses, times = [], []
    warm_ms, loss, _ = timed_step()                       # the kernels were built in phase 1
    losses.append(loss)
    peak_first = torch.cuda.max_memory_allocated()        # building the params, first step
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                              # the training path starts here
    for _ in range(5):
        ms, loss, parts = timed_step()
        times.append(ms)
        losses.append(loss)
    counts = dict(kernels.LAUNCHES)                       # ... and ends here
    peak = torch.cuda.max_memory_allocated()
    per_step = {n: c / 5 for n, c in counts.items()}
    if per_step != want:
        raise AssertionError(f"7b train: launches per step {per_step}, expected {want}")
    stats.launches(counts)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"7b train: non-finite loss in {losses}")
    if not losses[5] < losses[0]:
        raise AssertionError(f"7b train: the loss did not fall on one batch: {losses}")
    changed = [n for n, t in frozen.items() if _checksum(t) != sums[n]]
    if changed:
        raise AssertionError(f"7b train: frozen leaves changed: {changed}")
    if not float(state.tree["lora"]["q_proj"]["b"].detach().abs().max()) > 0:
        raise AssertionError("7b train: lora q_proj b is still zero")
    med = float(np.median(times))
    print(f"phase5 7b int4 QLoRA train [{gpu}] B=1 T={T} (16 frames) remat=full lora r=16 "
          f"dropout=0.05 lr=1e-4: params + state {t_build:.2f}s, {n_trained / 1e6:.1f}M trained "
          f"values; first step {warm_ms:.1f} ms; 5 steps median {med:.1f} ms (min "
          f"{min(times):.1f}, max {max(times):.1f}) = {T / med * 1e3:.1f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB over the 5 steps ({peak_first / 2**30:.2f} "
          f"GiB while building the params and in the first step); losses "
          f"{[round(x, 4) for x in losses]}; last parts "
          f"{ {n: round(float(getattr(parts, n)), 4) for n in LOSS_PARTS} }; launches per step "
          f"{ {n: int(c) for n, c in per_step.items()} }; frozen checksums unchanged "
          f"({', '.join(frozen)})", flush=True)

    # the remat policies from the state as it stands, at learning rate 0 (the
    # whole step runs, AdamW's arithmetic included, and leaves the trained values
    # where they are) and at one step number, so that every policy draws the same
    # masks: the losses agree to bf16 rounding. One step lets the allocator meet
    # the policy's sizes, the second is timed. The loss is the forward, the same
    # code under every policy; the backward is held by the adapters' gradients,
    # each layer's slice of each against 'none''s: the largest relative
    # difference must stay under GRAD_RTOL, which a stale replay (every layer
    # handed back the kept products of the layer before it, shapes alike) must
    # exceed.
    still = trainer.AdamW(dataclasses.replace(tc, learning_rate=0.0), 100)
    update = still.update
    grads = {}

    def keep_grads(g, opt_state, trained):
        grads[policy] = {n: t.detach().float().clone() for n, t in g.items()
                         if n.startswith("lora/")}
        if policy != "stale dots":          # the fault's gradients are only read
            update(g, opt_state, trained)

    still.update = keep_grads
    at_step = state.step
    policy_loss = {}
    for policy in ("full", "half", "none", "dots", "dots_no_batch"):
        step = trainer.make_train_step(cfg, dataclasses.replace(tc, remat_policy=policy), still,
                                       labels, scale)
        timed_step()
        state.step = at_step
        torch.cuda.reset_peak_memory_stats()
        ms, policy_loss[policy], _ = timed_step()
        state.step = at_step
        print(f"phase5 remat={policy} [{gpu}] one step {ms:.1f} ms, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss "
              f"{policy_loss[policy]:.4f}", flush=True)
    spread = max(policy_loss.values()) - min(policy_loss.values())
    if not spread <= 1e-2:
        raise AssertionError(f"7b train: remat policies disagree in loss: {policy_loss}")

    policy = "stale dots"
    step = trainer.make_train_step(cfg, dataclasses.replace(tc, remat_policy="dots"), still,
                                   labels, scale)
    with _stale_replay(qwen2):
        timed_step()
    state.step = at_step
    ratio = {p: _grad_rel_diff(grads[p], grads["none"]) for p in grads if p != "none"}
    print(f"phase5 remat adapters' gradients [{gpu}]: largest relative difference of a "
          f"layer's slice from remat=none's (limit {GRAD_RTOL}) "
          f"{ {p: f'{r:.3e}' for p, r in ratio.items()} }", flush=True)
    if ratio.pop("stale dots") <= GRAD_RTOL:
        raise AssertionError("7b train: a stale replay stays within the gradients' tolerance")
    if not max(ratio.values()) <= GRAD_RTOL:
        raise AssertionError(f"7b train: remat policies disagree in gradients: {ratio}")
    del grads
    del state, params, step, still
    gc.collect()
    torch.cuda.empty_cache()
    phase5b(gpu, stats)


# -- phase 5b: the train command at 7B -----------------------------------------------

# the clips of phase 5b (seconds; 384 x 384 at 4 fps, decoded at 1 fps), two videos that a
# grounding and a DVC entry of the mixture share: every conversation is 513 .. 1,024 tokens
# long behind the training system prompt, so every batch is left-padded to the length
# bucket 1,024 and its frames to the bucket 16 or 32
TRAIN_CLI_CLIPS = {"c0.mp4": 13, "c1.mp4": 10}


def write_train_data(root: pathlib.Path) -> pathlib.Path:
    """Clips written with cv2, a grounding and a DVC annotation file over them
    and the mixture config (frame_fps 1, max_num_frames 16); -> the config."""
    import numpy as np

    from aha_tpu_torch.data.media import write_video

    vids = root / "videos"
    vids.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for name, seconds in TRAIN_CLI_CLIPS.items():
        frames = np.repeat(rng.integers(0, 255, (seconds, 384, 384, 3), dtype=np.uint8), 4, 0)
        write_video(frames, str(vids / name), 4.0)
    (root / "grounding.json").write_text(json.dumps([
        {"video_uid": "c0.mp4", "query": "the subject turns", "timestamps": [[3.0, 7.5]]},
        {"video_uid": "c1.mp4", "query": "a door opens", "timestamps": [[1.0, 4.0], [6.0, 8.0]]}]))
    (root / "dvc.json").write_text(json.dumps({
        "c0.mp4": {"a": [{"text": "someone walks in.", "time": 4.0, "timespan": [2.0, 4.0]},
                         {"text": "they sit down.", "time": 9.0, "timespan": [7.0, 9.0]},
                         {"text": "they leave.", "time": 12.0, "timespan": [11.0, 12.0]}]},
        "c1.mp4": {"a": [{"text": "a car passes.", "time": 3.0, "timespan": [1.0, 3.0]},
                         {"text": "it stops.", "time": 8.0, "timespan": [6.0, 8.0]}]}}))
    entry = dict(video_root=str(vids), metadata_path=str(root / "meta.json"), frame_fps=1.0,
                 max_num_frames=16)
    mix = root / "mixture.json"
    mix.write_text(json.dumps([
        dict(entry, dataset_cls="GroundingStreamDataset", anno_file=str(root / "grounding.json")),
        dict(entry, dataset_cls="DenseVideoCaptioningStreamDataset",
             anno_file=str(root / "dvc.json"))]))
    return mix


class HostTimer:
    """Thread time of the data pipeline's decode (``StreamDataset.__getitem__``)
    and collation (``collate``) while a run lasts, by wrapping both."""

    def __init__(self):
        import threading

        from aha_tpu_torch.data import datasets, pipeline

        self.mods = (datasets.StreamDataset, pipeline)
        self.saved = (datasets.StreamDataset.__getitem__, pipeline.collate)
        self.lock = threading.Lock()
        self.ms = {"decode": 0.0, "collate": 0.0}
        self.batches = 0

    def _timed(self, fn, key):
        def timed(*a, **k):
            t = time.perf_counter()
            out = fn(*a, **k)
            with self.lock:
                self.ms[key] += (time.perf_counter() - t) * 1e3
                self.batches += key == "collate"
            return out
        return timed

    def __enter__(self):
        cls, pipeline = self.mods
        cls.__getitem__ = self._timed(self.saved[0], "decode")
        pipeline.collate = self._timed(self.saved[1], "collate")
        return self

    def __exit__(self, *exc):
        self.mods[0].__getitem__, self.mods[1].collate = self.saved


def phase5b(gpu: str, stats: Stats):
    """``cmd_train`` in this process at --model_preset 7b on the clips of
    ``write_train_data``: int4 QLoRA on left-padded B 2 batches with
    accumulation, the same command resumed from latest_checkpoint, and the
    default int8 trunk at B 1. Outputs go to the system's temporary directory
    and are removed."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aha_tpu_torch.cli.train import cmd_train
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    root = pathlib.Path(tempfile.mkdtemp(prefix="aha_train_"))
    try:
        mix = write_train_data(root)
        base = ["--model_preset", "7b", "--dataset_config", str(mix), "--learning_rate", "1e-4"]
        int4 = base + ["--quantize_base", "--quantize_bits", "4", "--batch_size", "2",
                       "--grad_accum_steps", "2", "--remat_policy", "full",
                       "--output_dir", str(root / "int4")]
        runs = [("int4 B=2 accum 2", int4 + ["--num_steps", "4"],
                 ("int4_matmul", "int4_matmul_t", "flash_attention_fwd", "flash_attention_bwd")),
                ("int4 resumed", int4 + ["--num_steps", "6", "--resume_from_checkpoint", None],
                 ("int4_matmul", "int4_matmul_t", "flash_attention_fwd", "flash_attention_bwd")),
                ("int8 B=1", base + ["--quantize_base", "--batch_size", "1",
                                     "--grad_accum_steps", "1", "--num_steps", "2",
                                     "--output_dir", str(root / "int8")],
                 ("int8_matmul", "flash_attention_fwd", "flash_attention_bwd"))]
        train = trainer.train
        for label, argv, must in runs:
            if "--resume_from_checkpoint" in argv:
                latest = trainer.latest_checkpoint(str(root / "int4" / "checkpoints"))
                argv[argv.index("--resume_from_checkpoint") + 1] = latest
            peak = {}

            def measured(*a, **k):
                # the weights are built and quantised: the run's own peak starts here
                torch.cuda.synchronize()
                peak["build"] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                kernels.reset_launches()        # the training path starts here
                return train(*a, **k)

            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer.train = measured
            try:
                with HostTimer() as host:
                    state = cmd_train(argv)
            finally:
                trainer.train = train
            torch.cuda.synchronize()
            counts = dict(kernels.LAUNCHES)     # ... and ends here
            wall = time.perf_counter() - t0
            stats.launches(counts)
            missing = [n for n in must if counts.get(n, 0) <= 0]
            if missing:
                raise AssertionError(f"7b train command {label}: {missing} never launched "
                                     f"({counts})")
            out = pathlib.Path(argv[argv.index("--output_dir") + 1])
            rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
            first = 5 if "resumed" in label else 1
            rows = [r for r in rows if r["step"] >= first]
            n_steps = int(argv[argv.index("--num_steps") + 1])
            accum = int(argv[argv.index("--grad_accum_steps") + 1])
            if ([r["step"] for r in rows] != list(range(first, n_steps + 1))
                    or state.step != n_steps or state.opt_state.count != n_steps // accum):
                raise AssertionError(f"7b train command {label}: steps {[r['step'] for r in rows]}"
                                     f", state at {state.step}, optimizer count "
                                     f"{state.opt_state.count}")
            losses = [r["train/total_loss"] for r in rows]
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"7b train command {label}: non-finite loss {losses}")
            if not (out / "adapter.pt").exists() or trainer.latest_checkpoint(
                    str(out / "checkpoints")) is None:
                raise AssertionError(f"7b train command {label}: no checkpoint or export")
            ms = [r["perf/step_ms"] for r in rows]
            tokens = sum(r["perf/tokens"] for r in rows)
            wait = [r["perf/wait_ms"] for r in rows]
            B = int(argv[argv.index("--batch_size") + 1])
            shown = " ".join("mixture.json" if a == str(mix) else a for a in argv)
            print(f"phase5b train command {label} [{gpu}]: {shown}"
                  f" -> steps {first}..{n_steps}, optimizer count {state.opt_state.count}; step ms "
                  f"{[round(x, 1) for x in ms]} (median {float(np.median(ms)):.1f}, min "
                  f"{min(ms):.1f}, max {max(ms):.1f}); {tokens} real tokens of {B * TRAIN_CLI_T * len(rows)} "
                  f"= {tokens / sum(ms) * 1e3:.1f} real tokens/s; host decode "
                  f"{host.ms['decode'] / max(host.batches, 1):.1f} ms + collate "
                  f"{host.ms['collate'] / max(host.batches, 1):.1f} ms a batch on "
                  f"{host.batches} batches (worker threads), the step waited {float(np.mean(wait)):.1f} "
                  f"ms a batch for it; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                  f" GiB in train() ({peak['build'] / 2**30:.2f} GiB while building and "
                  f"quantising the weights); losses {[round(x, 4) for x in losses]}; launches "
                  f"{counts}; command {wall:.1f}s", flush=True)
            del state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase5b took {time.perf_counter() - t_phase:.1f}s", flush=True)


class PassCounter:
    """Counts decoder passes (write passes and read-only verify passes, and
    those whose embeddings are f32: all, and the write passes among them) by
    wrapping the two functions the engine calls."""

    def __init__(self):
        import torch

        from aha_tpu_torch.models import qwen2

        self.qwen2 = qwen2
        self.saved = (qwen2.decode_chunk, qwen2.decode_chunk_spec)
        self.chunks = self.verifies = self.f32 = self.f32_chunks = 0
        self.f32_type = torch.float32

    def __enter__(self):
        write, verify = self.saved

        def counted_write(*a, **k):
            self.chunks += 1
            f32 = a[4].dtype == self.f32_type            # the chunk's embeddings
            self.f32 += f32
            self.f32_chunks += f32
            return write(*a, **k)

        def counted_verify(*a, **k):
            self.verifies += 1
            self.f32 += a[4].dtype == self.f32_type
            return verify(*a, **k)

        self.qwen2.decode_chunk, self.qwen2.decode_chunk_spec = counted_write, counted_verify
        return self

    def __exit__(self, *exc):
        self.qwen2.decode_chunk, self.qwen2.decode_chunk_spec = self.saved


class ComposedCounter:
    """Counts the verify passes' layers that reach the composed
    ``speculative_attention`` (the plain PyTorch one softmax over cache and
    in-flight columns, left for an int8 cache) by wrapping the name
    ``decode_chunk_spec`` calls it by."""

    def __init__(self):
        from aha_tpu_torch.models import qwen2

        self.qwen2, self.saved, self.calls = qwen2, qwen2.speculative_attention, 0

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.saved(*a, **k)

        self.qwen2.speculative_attention = counted
        return self

    def __exit__(self, *exc):
        self.qwen2.speculative_attention = self.saved


class ShapeRecorder:
    """Records the shapes the model hands each kernel's wrapper (matmuls and
    the activation quantiser behind them: rows, K, N; attention: query rows,
    slots, then "f32" for f32 activations and the batch where it is over 1)
    by wrapping the names the model calls them by."""

    def __init__(self):
        import torch

        from aha_tpu_torch.models import remat
        from aha_tpu_torch.ops import attention, quant

        from aha_tpu_torch.ops.kernels import (flash_attention, int4_matmul, int4_matmul_t,
                                               int8_matmul)

        self.f32 = torch.float32

        self.seen = set()
        self.sites = [(quant, "int4_matmul"), (quant, "int8_matmul"), (quant, "quant_matmul"),
                      (attention, "decode_attention"),
                      # training: int4_qlinear's forward and backward, the flash Function's
                      (int4_matmul, "int4_matmul"), (int4_matmul_t, "int4_matmul_t"),
                      (flash_attention, "flash_attention_fwd"),
                      (flash_attention, "flash_attention_bwd"),
                      # int8_qlinear's forward; remat "dots": the kept products and attention
                      (int8_matmul, "int8_matmul"), (remat, "int4_matmul"),
                      (remat, "int8_matmul"), (remat, "flash_attention_fwd"),
                      (remat, "flash_attention_bwd")]
        self.saved = [getattr(mod, name) for mod, name in self.sites]
        # the verify pass's attention (replayed_attention's one launch)
        self.attention = attention
        self.steps_saved = attention.decode_attention_steps

    def _matmul(self, fn, name):
        def recorded(x, w, scale, a8=False):
            K, N = x.shape[-1], w.shape[-1]
            M = x.numel() // K
            if a8:
                self.seen.add((name + "_a8", M, K, N))
                self.seen.add(("quantize_rows", M, K))
            else:
                self.seen.add((name, M, K, N) + (("f32",) if x.dtype == self.f32 else ()))
                if x.dtype == self.f32 and M > 16:   # f32 x from 17 rows: split into planes
                    self.seen.add(("split_bf16x3", M, K))
            return fn(x, w, scale, a8=a8) if name != "quant_matmul" else fn(x, w, scale)
        return recorded

    def _flash(self, fn):
        def recorded(q, k, *a, **kw):
            self.seen.add(("flash_attention", *q.shape[:3], k.shape[2], q.shape[3]))
            return fn(q, k, *a, **kw)
        return recorded

    def __enter__(self):
        for (mod, name), fn in zip(self.sites[:3], self.saved):
            setattr(mod, name, self._matmul(fn, name))
        mod, name = self.sites[3]
        attend = self.saved[3]

        def recorded_attention(q, k, *a, **kw):
            f32 = ("f32",) if q.dtype == self.f32 else ()
            rows = (f"B{q.shape[0]}",) if q.shape[0] > 1 else ()
            # a rank's own heads on a mesh (the 7B has 28 query heads)
            heads = (f"H{q.shape[2]}",) if q.shape[2] != 28 else ()
            self.seen.add((name, q.shape[1], k.shape[1]) + f32 + rows + heads)
            return attend(q, k, *a, **kw)

        setattr(mod, name, recorded_attention)
        steps_attend = self.steps_saved

        def recorded_steps(q, k, *a):
            n = a[-1].shape[0]              # src [steps, B, Wp]
            f32 = ("f32",) if q.dtype == self.f32 else ()
            rows = (f"B{q.shape[0]}",) if q.shape[0] > 1 else ()
            heads = (f"H{q.shape[2]}",) if q.shape[2] != 28 else ()
            self.seen.add(("decode_attention_steps", n, q.shape[1] // n, k.shape[1]) + f32 + rows
                          + heads)
            return steps_attend(q, k, *a)

        self.attention.decode_attention_steps = recorded_steps
        setattr(*self.sites[4], self._matmul(self.saved[4], "int4_matmul"))
        transposed = self.saved[5]

        def recorded_transposed(g, w, scale):
            self.seen.add(("int4_matmul_t", g.numel() // g.shape[-1], 2 * w.shape[0], w.shape[1]))
            return transposed(g, w, scale)

        setattr(*self.sites[5], recorded_transposed)
        for site, fn in zip(self.sites[6:8], self.saved[6:8]):
            setattr(*site, self._flash(fn))
        for site, fn in zip(self.sites[8:11], self.saved[8:11]):
            setattr(*site, self._matmul(fn, site[1]))
        for site, fn in zip(self.sites[11:], self.saved[11:]):
            setattr(*site, self._flash(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.sites, self.saved):
            setattr(mod, name, fn)
        self.attention.decode_attention_steps = self.steps_saved


def run_inference(params, cfg, tok, frames, rule, widths, backend="fused", chunked=True,
                  max_new_tokens=32, **session_kw):
    """inference() over ``frames`` with a query at t=0, the trigger ``rule``
    (a float: the prob rule at that threshold; else InferConfig fields), the
    chunked loop or the stepwise one. Returns (session, turns, seconds in
    all, seconds inside generate(), seconds and tokens of the decode passes
    alone: a response's first token comes from the prompt chunk's logits).
    ``session_kw``: the adapters (``lora``, ``lora_scale``)."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.session import build_session

    if not isinstance(rule, dict):
        rule = dict(stream_end_prob_threshold=rule)
    sess = build_session(params, cfg, tok, InferConfig(
        frame_fps=2.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32,
        max_new_tokens=max_new_tokens, **rule, **widths), backend=backend, **session_kw)
    generate, append = sess.engine.generate, sess.engine._append_padded
    gen_s, dec_s, dec_tokens, prompt_end = [0.0], [0.0], [0], [0.0]

    def timed_append(*a, **k):
        out = append(*a, **k)
        torch.cuda.synchronize()
        prompt_end[0] = time.perf_counter()
        return out

    def timed_generate(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(*a, **k)           # its first pass is _append_padded (the prompt)
        torch.cuda.synchronize()
        end = time.perf_counter()
        gen_s[0] += end - t
        dec_s[0] += end - prompt_end[0]
        dec_tokens[0] += int(out[1].sum()) - 1
        return out

    sess.engine.generate, sess.engine._append_padded = timed_generate, timed_append
    t0 = time.perf_counter()
    sess.input_video_stream(frames)
    sess.input_query_stream([{"role": "user", "content": QUERY, "time": 0}])
    turns = sess.inference(chunked=chunked)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    return sess, turns, t_all, gen_s[0], dec_s[0], dec_tokens[0]


def texts(turns) -> list[str]:
    return [t["content"] for t in turns if t["role"] == "assistant"]


def check_7b_run(name, rows, sess, responses, n_frames):
    scores = [[r[k] for k in SCORE_KEYS] for r in rows + sess.debug_data_list]
    if len(rows) != 64 or len(sess.debug_data_list) != n_frames:
        raise AssertionError(f"{name}: {len(rows)} / {len(sess.debug_data_list)} frame scores")
    if not all(math.isfinite(x) for row in scores for x in row):
        raise AssertionError(f"{name}: non-finite score")
    if not responses:
        raise AssertionError(f"{name}: no response fired")
    seen = int(sess.cache.seen[0])
    if seen <= 2048 + 32:
        raise AssertionError(f"{name}: stream of {seen} tokens never filled the window")
    return seen


def score_64(params, cfg, tok, frames, widths, backend="fused", **session_kw):
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.session import build_session

    t0 = time.perf_counter()
    sess = build_session(params, cfg, tok, InferConfig(
        grounding_mode=True, frame_fps=2.0, kv_cache_policy="sink", kv_window=2048,
        num_sink_tokens=32, **widths), backend=backend, **session_kw)
    rows = sess.score_video(frames, query=QUERY)
    torch.cuda.synchronize()
    return rows, time.perf_counter() - t0


def verify_vs_sequential(sess, cfg, S: int = 8):
    """One read-only verify pass of S tokens, as ``generate_spec`` runs it
    (attention replayed through the kernel), against S sequential 1-token
    passes from the same (filled) cache: hidden states on the card, which must
    be the same bits."""
    import torch

    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.ops import spec_decode

    eng = sess.engine
    llm = eng.params["llm"]
    ids = torch.arange(100, 100 + S, device="cuda")[None]
    embeds = qwen2.embed_tokens(llm, ids, eng.dtype)
    plans = spec_decode.plan_compose(sess.cache, eng.policy,
                                     torch.full((1,), S, dtype=torch.int32, device="cuda"), S)
    h_spec, _, _ = qwen2.decode_chunk_spec(llm, cfg.llm, eng.policy, sess.cache, embeds, plans,
                                           backend=eng.backend, replay=True)
    cache = sess.cache.clone()
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    h_seq = torch.cat([qwen2.decode_chunk(llm, cfg.llm, eng.policy, cache, embeds[:, j:j + 1],
                                          one, backend=eng.backend) for j in range(S)], dim=1)
    err = rel_check(f"verify pass S={S} vs sequential", h_spec, h_seq, 5e-2)
    if not torch.equal(h_spec, h_seq):
        raise AssertionError(f"verify pass S={S}: hidden states differ from the sequential "
                             f"passes' by up to {err:.3e}")
    same = (qwen2.lm_logits(llm, cfg.llm, h_spec, eng.backend).argmax(-1)
            == qwen2.lm_logits(llm, cfg.llm, h_seq, eng.backend).argmax(-1)).sum().item()
    return err, same


def phases_4_to_10(gpu: str, seed: int, stats: Stats, phases: set):
    """The 7B paths (phases 4 to 11; phase 11's ranks record their own shapes),
    then: every shape they gave a kernel was held against the plain version in
    phase 2."""
    phase2_ran = 2 in phases
    with ShapeRecorder() as rec:
        if 4 in phases:
            with ComposedCounter() as composed:
                drive_7b_paths(gpu, seed, stats)
            # every cache of phase 4 is bf16: no verify pass may take the plain composition
            print(f"phase4 verify-pass layers through the composed speculative_attention: "
                  f"{composed.calls}", flush=True)
            if composed.calls:
                raise AssertionError(f"phase4: {composed.calls} verify-pass layers on a bf16 "
                                     f"cache took the composed speculative_attention")
        if 5 in phases:
            phase5(gpu, seed, stats)
        if 6 in phases:
            phase6(gpu, stats)
        if 7 in phases:
            phase7(gpu, seed, stats)
        if 8 in phases:
            phase8(gpu, seed, stats)
        if 9 in phases:
            phase9(gpu, stats)
        if 10 in phases:
            phase10(gpu, seed, stats)
        if 11 in phases:
            phase11(gpu, seed, stats, rec)
    missing = sorted(rec.seen - stats.checked, key=str)
    print(f"phases 4-11 shapes handed to the kernels: {len(rec.seen)} distinct, "
          f"{len(missing)} not checked in phase 2"
          + ("" if phase2_ran else " (phase 2 did not run)"), flush=True)
    if phase2_ran and missing:
        raise AssertionError(f"phase 2 checks none of these shapes of the 7B paths: {missing}")


def drive_7b_paths(gpu: str, seed: int, stats: Stats):
    import torch

    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels

    cfg, tok = _model("7b")
    L = cfg.llm.num_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randint(0, 256, (96, 384, 384, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)[:STREAM_FRAMES]
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    w1 = dict(fused_score_frames=1, spec_decode_tokens=1)

    def build(mode):
        t0 = time.perf_counter()
        params = random_params(cfg, mode=mode, seed=seed)
        torch.cuda.synchronize()
        return params, time.perf_counter() - t0

    # -- a. 7B-int4 at the product widths -------------------------------------------
    params4, t_params = build("int4")
    torch.cuda.reset_peak_memory_stats()
    with PassCounter() as pc:
        kernels.reset_launches()                       # the new main path starts here
        rows, t_sv = score_64(params4, cfg, tok, frames[:64], product)
        sv_verifies = pc.verifies
        sess, turns, t_inf, gen_s, dec_s, dec_tokens = run_inference(
            params4, cfg, tok, frames, threshold(rows), product)
        counts = dict(kernels.LAUNCHES)                # ... and ends here
        chunks, verifies = pc.chunks, pc.verifies
    peak = torch.cuda.max_memory_allocated()
    responses = texts(turns)
    seen = check_7b_run("7b-int4", rows, sess, responses, STREAM_FRAMES)
    if sv_verifies != 16:
        raise AssertionError(f"7b-int4: score_video took {sv_verifies} fused passes, not 16")
    passes = chunks + verifies
    n4, na = counts.get("int4_matmul", 0), counts.get("decode_attention", 0)
    ns = counts.get("decode_attention_steps", 0)
    if n4 < L * passes * 4 or na < L * chunks or ns < L * verifies:
        raise AssertionError(f"7b-int4: launches int4_matmul={n4} decode_attention={na} "
                             f"decode_attention_steps={ns} < {L} layers x ({chunks} chunks + "
                             f"{verifies} verify passes)")
    if counts.get("int8_matmul", 0) or counts.get("int4_matmul_a8", 0):
        raise AssertionError(f"7b-int4: a kernel of another path ran: {counts}")
    stats.launches(counts)
    acc = sess.engine.spec_acceptance()
    print(f"phase4a 7b-int4 widths 4 / 4->8 [{gpu}] params {t_params:.2f}s; score_video 64 "
          f"frames in 16 fused passes {t_sv:.3f}s = {64 / t_sv:.2f} frames/s (vision included); "
          f"inference (chunked) {STREAM_FRAMES} frames {t_inf:.3f}s, {len(responses)} responses in "
          f"{gen_s:.3f}s; decode {dec_tokens} tokens in {dec_s:.3f}s = "
          f"{dec_tokens / max(dec_s, 1e-9):.2f} decode tokens/s, {acc['tokens_per_pass']} tokens "
          f"per verify pass ({acc['passes']} passes, acceptance EMA {acc['ema']}); scoring "
          f"{STREAM_FRAMES / (t_inf - gen_s):.2f} frames/s; stream {seen} tokens; {chunks} chunks + "
          f"{verifies} verify passes; launches int4_matmul={n4} decode_attention={na} "
          f"decode_attention_steps={ns}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"phase4a first response: {responses[0][:60]!r}", flush=True)
    rows4, t_sv4, dec_tokens4, dec_s4 = rows, t_sv, dec_tokens, dec_s
    frames_s4 = STREAM_FRAMES / (t_inf - gen_s)

    # the same stream at generation width 1, scoring at the same width: the speculative
    # texts against the sequential ones
    sess1, turns1, t_inf1, gen_s1, dec_s1, dec_tokens1 = run_inference(
        params4, cfg, tok, frames, threshold(rows), dict(product, spec_decode_tokens=1))
    if texts(turns1) != responses:
        raise AssertionError("7b-int4: speculative texts differ from the width-1 texts:"
                             + _first_divergence(responses, texts(turns1)))
    dec_tokens1_4, dec_s1_4 = dec_tokens1, dec_s1
    err, same = verify_vs_sequential(sess, cfg)
    print(f"phase4a generation width 1 [{gpu}]: decode {dec_tokens1} tokens in {dec_s1:.3f}s = "
          f"{dec_tokens1 / max(dec_s1, 1e-9):.2f} decode tokens/s; texts identical to the "
          f"speculative run's ({len(responses)} responses); verify pass "
          f"S=8 (attention replayed) vs 8 sequential passes on the filled cache: hidden "
          f"states equal bit for bit (max_abs_err={err:.3e}), argmax equal at {same}/8 "
          f"positions", flush=True)
    del sess, sess1, params4
    gc.collect()      # a session and its timing wrappers form a cycle that holds the params
    torch.cuda.empty_cache()

    # -- b. 7B-int8 at the product widths, then generation at width 1 and score_video at
    # width 1 -------------------------------------------------------------------------
    params8, t_params = build("int8")
    torch.cuda.reset_peak_memory_stats()
    with PassCounter() as pc:
        kernels.reset_launches()
        rows8, t_sv8 = score_64(params8, cfg, tok, frames[:64], product)
        sv_verifies = pc.verifies
        sess, turns, t_inf, gen_s, dec_s, dec_tokens = run_inference(
            params8, cfg, tok, frames, threshold(rows8), product)
        counts = dict(kernels.LAUNCHES)
        chunks, verifies = pc.chunks, pc.verifies
    peak = torch.cuda.max_memory_allocated()
    responses = texts(turns)
    seen = check_7b_run("7b-int8", rows8, sess, responses, STREAM_FRAMES)
    if sv_verifies != 16:
        raise AssertionError(f"7b-int8: score_video took {sv_verifies} fused passes, not 16")
    passes = chunks + verifies
    n8, na = counts.get("int8_matmul", 0), counts.get("decode_attention", 0)
    ns = counts.get("decode_attention_steps", 0)
    if (n8 < L * passes * 4 or na < L * chunks or ns < L * verifies
            or not verifies > sv_verifies):
        raise AssertionError(f"7b-int8: launches int8_matmul={n8} decode_attention={na} "
                             f"decode_attention_steps={ns} < {L} layers x ({chunks} chunks + "
                             f"{verifies} verify passes), or no verify pass of generation")
    if counts.get("int4_matmul", 0) or counts.get("int8_matmul_a8", 0):
        raise AssertionError(f"7b-int8: a kernel of another path ran: {counts}")
    stats.launches(counts)
    acc = sess.engine.spec_acceptance()
    print(f"phase4b 7b-int8 widths 4 / 4->8 [{gpu}] params {t_params:.2f}s; score_video 64 "
          f"frames in 16 fused passes {t_sv8:.3f}s = {64 / t_sv8:.2f} frames/s (vision "
          f"included); inference (chunked) {STREAM_FRAMES} frames {t_inf:.3f}s, {len(responses)} responses "
          f"in {gen_s:.3f}s; decode {dec_tokens} tokens in {dec_s:.3f}s = "
          f"{dec_tokens / max(dec_s, 1e-9):.2f} decode tokens/s, {acc['tokens_per_pass']} tokens "
          f"per verify pass ({acc['passes']} passes, acceptance EMA {acc['ema']}); scoring "
          f"{STREAM_FRAMES / (t_inf - gen_s):.2f} frames/s; stream {seen} tokens; {chunks} chunks + "
          f"{verifies} verify passes; launches int8_matmul={n8} decode_attention={na} "
          f"decode_attention_steps={ns}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"phase4b first response: {responses[0][:60]!r}", flush=True)
    dec_tokens8, dec_s8 = dec_tokens, dec_s

    # score_video one frame a pass, and the same stream with S = 1 passes in generation
    # at the run's own scoring width and threshold: the texts must be equal
    with PassCounter() as pc:
        kernels.reset_launches()
        rows, t_sv1 = score_64(params8, cfg, tok, frames[:64], w1)
        sv_chunks, sv_verifies = pc.chunks, pc.verifies
        sess1, turns1, t_inf1, gen_s1, dec_s1, dec_tokens1 = run_inference(
            params8, cfg, tok, frames, threshold(rows8), dict(product, spec_decode_tokens=1))
        counts = dict(kernels.LAUNCHES)
        chunks1, verifies1 = pc.chunks, pc.verifies
    check_7b_run("7b-int8 generation width 1", rows, sess1, texts(turns1), STREAM_FRAMES)
    n8 = counts.get("int8_matmul", 0)
    if n8 < L * (chunks1 + verifies1) * 4 or sv_verifies or sv_chunks < 64:
        raise AssertionError(f"7b-int8 width 1: launches int8_matmul={n8} < {L} layers x "
                             f"({chunks1} chunks + {verifies1} verify passes), or score_video "
                             f"at width 1 took {sv_verifies} verify passes")
    stats.launches(counts)
    if texts(turns1) != responses:
        raise AssertionError("7b-int8: speculative texts differ from the width-1 texts:"
                             + _first_divergence(responses, texts(turns1)))
    dec_tokens1_8, dec_s1_8 = dec_tokens1, dec_s1
    d = max(abs(a[k] - b[k]) for a, b in zip(rows8, rows) for k in SCORE_KEYS)
    err, same = verify_vs_sequential(sess, cfg)
    print(f"phase4b width 1 [{gpu}]: score_video 64 frames {t_sv1:.3f}s = {64 / t_sv1:.2f} "
          f"frames/s, fused-4 scores vs width 1 max_abs_diff={d:.3e}; inference at fused 4 with "
          f"generation width 1 {STREAM_FRAMES} frames {t_inf1:.3f}s; decode {dec_tokens1} tokens in "
          f"{dec_s1:.3f}s = {dec_tokens1 / max(dec_s1, 1e-9):.2f} decode tokens/s; {chunks1} "
          f"chunks + {verifies1} verify passes; texts identical to the speculative run's "
          f"({len(responses)} responses); verify pass S=8 (attention replayed) vs 8 sequential "
          f"passes on the filled cache: hidden states equal bit for bit (max_abs_err={err:.3e}), "
          f"argmax equal at {same}/8 positions", flush=True)
    del sess, sess1
    gc.collect()      # a session and its timing wrappers form a cycle that holds the params

    # -- c (int8 part). --w8a8 at its widths: "fused_a8" with fused scoring of 8 frames
    # (392-row passes) and generation 4 -> 8, then generation at width 1 at the same
    # scoring width (texts must be equal); then "pallas", 8 frames --------------------------
    w8a8 = dict(fused_score_frames=8, spec_decode_tokens=4, spec_decode_tokens_max=8)
    rows_w8, _ = score_64(params8, cfg, tok, frames[:64], w8a8)   # weight-only at the same width
    with PassCounter() as pc:
        kernels.reset_launches()
        rows_a8, t_sv_a8 = score_64(params8, cfg, tok, frames[:64], w8a8, backend="fused_a8")
        sv_verifies = pc.verifies
        sess, turns, t_inf, gen_s, dec_s, dec_tokens = run_inference(
            params8, cfg, tok, frames, threshold(rows_a8), w8a8, backend="fused_a8")
        counts = dict(kernels.LAUNCHES)
        chunks, verifies = pc.chunks, pc.verifies
    responses = texts(turns)
    seen = check_7b_run("7b-int8 fused_a8", rows_a8, sess, responses, STREAM_FRAMES)
    if sv_verifies != 8:
        raise AssertionError(f"7b-int8 fused_a8: score_video took {sv_verifies} fused passes, "
                             f"not 8")
    passes = chunks + verifies
    n = counts.get("int8_matmul_a8", 0)
    if (n < L * passes * 4 or counts.get("quantize_rows", 0) < n or counts.get("int8_matmul", 0)
            or not verifies > sv_verifies):
        raise AssertionError(f"7b-int8 fused_a8: launches {counts} over {chunks} chunks + "
                             f"{verifies} verify passes, or no verify pass of generation")
    stats.launches(counts)
    acc = sess.engine.spec_acceptance()
    d = max(abs(a[k] - b[k]) for a, b in zip(rows_a8, rows) for k in SCORE_KEYS)
    d8 = max(abs(a[k] - b[k]) for a, b in zip(rows_a8, rows_w8) for k in SCORE_KEYS)
    print(f"phase4c 7b-int8 backend=fused_a8 widths 8 / 4->8 (--w8a8) [{gpu}] score_video 64 "
          f"frames in 8 fused passes of 392 rows {t_sv_a8:.3f}s = {64 / t_sv_a8:.2f} frames/s "
          f"(weight-only at 4: {64 / t_sv8:.2f}); scores vs weight-only at width 8 "
          f"max_abs_diff={d8:.3e}, vs weight-only width 1 {d:.3e}; inference (chunked) {STREAM_FRAMES} "
          f"frames {t_inf:.3f}s, {len(responses)} responses; decode {dec_tokens} tokens in "
          f"{dec_s:.3f}s = {dec_tokens / max(dec_s, 1e-9):.2f} decode tokens/s (weight-only at "
          f"4->8: {dec_tokens8 / max(dec_s8, 1e-9):.2f}), "
          f"{acc['tokens_per_pass']} tokens per verify pass; stream {seen} tokens; {chunks} "
          f"chunks + {verifies} verify passes; launches int8_matmul_a8={n} quantize_rows="
          f"{counts['quantize_rows']}", flush=True)
    with PassCounter() as pc:
        kernels.reset_launches()
        sess1, turns1, t_inf1, gen_s1, dec_s1, dec_tokens1 = run_inference(
            params8, cfg, tok, frames, threshold(rows_a8), dict(w8a8, spec_decode_tokens=1),
            backend="fused_a8")
        counts = dict(kernels.LAUNCHES)
    check_7b_run("7b-int8 fused_a8 generation width 1", rows_a8, sess1, texts(turns1), STREAM_FRAMES)
    if counts.get("int8_matmul_a8", 0) < L * (pc.chunks + pc.verifies) * 4:
        raise AssertionError(f"7b-int8 fused_a8 width 1: launches {counts} over {pc.chunks} "
                             f"chunks + {pc.verifies} verify passes")
    stats.launches(counts)
    if texts(turns1) != responses:
        raise AssertionError("7b-int8 fused_a8: speculative texts differ from the width-1 "
                             "texts:" + _first_divergence(responses, texts(turns1)))
    print(f"phase4c 7b-int8 backend=fused_a8 generation width 1 [{gpu}]: decode {dec_tokens1} "
          f"tokens in {dec_s1:.3f}s = {dec_tokens1 / max(dec_s1, 1e-9):.2f} decode tokens/s "
          f"(weight-only at width 1: {dec_tokens1_8 / max(dec_s1_8, 1e-9):.2f}); texts "
          f"identical to the speculative run's ({len(responses)} responses)", flush=True)
    del sess, sess1
    gc.collect()

    with PassCounter() as pc:
        kernels.reset_launches()
        rows_b, t_b = score_64(params8, cfg, tok, frames[:8], w1, backend="pallas")
        counts = dict(kernels.LAUNCHES)
        chunks = pc.chunks
    if len(rows_b) != 8 or not all(math.isfinite(r[k]) for r in rows_b for k in SCORE_KEYS):
        raise AssertionError("7b-int8 pallas: bad scores")
    n = counts.get("quant_matmul", 0)
    if n < L * chunks * 4 or counts.get("int8_matmul", 0):
        raise AssertionError(f"7b-int8 pallas: launches {counts} over {chunks} chunks")
    stats.launches(counts)
    d = max(abs(a[k] - b[k]) for a, b in zip(rows_b, rows[:8]) for k in SCORE_KEYS)
    print(f"phase4c 7b-int8 backend=pallas [{gpu}] score_video 8 frames {t_b:.3f}s; "
          f"launches quant_matmul={n}; scores vs backend=fused max_abs_diff={d:.3e}",
          flush=True)
    torch.cuda.empty_cache()

    # -- d. 7B-int4 with per-token int8 activations (backend "fused_a8", the W4A8
    # recipe) at the product widths: a's seeded weights and stream, fused scoring of 4
    # frames (196-row passes), generation 4 -> 8, then generation at width 1 (texts
    # must be equal) and the verify pass against sequential passes ----------------------
    params4, _ = build("int4")
    with PassCounter() as pc:
        kernels.reset_launches()
        rows_d, t_sv_d = score_64(params4, cfg, tok, frames[:64], product, backend="fused_a8")
        sv_verifies = pc.verifies
        sess, turns, t_inf, gen_s, dec_s, dec_tokens = run_inference(
            params4, cfg, tok, frames[:STREAM_FRAMES], threshold(rows_d), product,
            backend="fused_a8")
        counts = dict(kernels.LAUNCHES)
        chunks, verifies = pc.chunks, pc.verifies
    responses = texts(turns)
    seen = check_7b_run("7b-int4 fused_a8", rows_d, sess, responses, STREAM_FRAMES)
    if sv_verifies != 16:
        raise AssertionError(f"7b-int4 fused_a8: score_video took {sv_verifies} fused passes, "
                             f"not 16")
    passes = chunks + verifies
    n = counts.get("int4_matmul_a8", 0)
    if (n < L * passes * 4 or counts.get("quantize_rows", 0) < n or counts.get("int4_matmul", 0)
            or not verifies > sv_verifies):
        raise AssertionError(f"7b-int4 fused_a8: launches {counts} over {chunks} chunks + "
                             f"{verifies} verify passes, or no verify pass of generation")
    stats.launches(counts)
    acc = sess.engine.spec_acceptance()
    d = max(abs(a[k] - b[k]) for a, b in zip(rows_d, rows4) for k in SCORE_KEYS)
    print(f"phase4d 7b-int4 backend=fused_a8 widths 4 / 4->8 [{gpu}] score_video 64 frames in "
          f"16 fused passes of 196 rows {t_sv_d:.3f}s = {64 / t_sv_d:.2f} frames/s (weight-only, "
          f"4a: {64 / t_sv4:.2f}); scores vs 4a's weight-only at width 4 max_abs_diff={d:.3e}; "
          f"inference (chunked) {STREAM_FRAMES} frames {t_inf:.3f}s, {len(responses)} responses in "
          f"{gen_s:.3f}s; decode {dec_tokens} tokens in {dec_s:.3f}s = "
          f"{dec_tokens / max(dec_s, 1e-9):.2f} decode tokens/s (4a: "
          f"{dec_tokens4 / max(dec_s4, 1e-9):.2f}), {acc['tokens_per_pass']} tokens per verify "
          f"pass ({acc['passes']} passes); scoring {STREAM_FRAMES / (t_inf - gen_s):.2f} frames/s (4a: "
          f"{frames_s4:.2f}); stream {seen} tokens; {chunks} chunks + {verifies} verify passes; "
          f"launches int4_matmul_a8={n} quantize_rows={counts['quantize_rows']}", flush=True)
    print(f"phase4d first response: {responses[0][:60]!r}", flush=True)
    with PassCounter() as pc:
        kernels.reset_launches()
        sess1, turns1, t_inf1, gen_s1, dec_s1, dec_tokens1 = run_inference(
            params4, cfg, tok, frames[:STREAM_FRAMES], threshold(rows_d),
            dict(product, spec_decode_tokens=1), backend="fused_a8")
        counts = dict(kernels.LAUNCHES)
    check_7b_run("7b-int4 fused_a8 generation width 1", rows_d, sess1, texts(turns1),
                 STREAM_FRAMES)
    if counts.get("int4_matmul_a8", 0) < L * (pc.chunks + pc.verifies) * 4:
        raise AssertionError(f"7b-int4 fused_a8 width 1: launches {counts} over {pc.chunks} "
                             f"chunks + {pc.verifies} verify passes")
    stats.launches(counts)
    if texts(turns1) != responses:
        raise AssertionError("7b-int4 fused_a8: speculative texts differ from the width-1 "
                             "texts:" + _first_divergence(responses, texts(turns1)))
    err, same = verify_vs_sequential(sess, cfg)
    print(f"phase4d 7b-int4 backend=fused_a8 generation width 1 [{gpu}]: decode {dec_tokens1} "
          f"tokens in {dec_s1:.3f}s = {dec_tokens1 / max(dec_s1, 1e-9):.2f} decode tokens/s (4a "
          f"at width 1: {dec_tokens1_4 / max(dec_s1_4, 1e-9):.2f}); texts identical to the "
          f"speculative run's ({len(responses)} responses); verify pass S=8 (attention "
          f"replayed) vs 8 sequential passes on the filled cache: hidden states equal bit for "
          f"bit (max_abs_err={err:.3e}), argmax equal at {same}/8 positions", flush=True)
    del sess, sess1
    gc.collect()

    phase4e(gpu, stats, cfg, tok, frames[:STREAM_FRAMES], params4, params8,
            {"7b-int4": (rows4, 64 / t_sv4), "7b-int8": (rows8, 64 / t_sv8),
             "7b-int8 fused_a8": (rows_a8, 64 / t_sv_a8)})
    del params4, params8
    gc.collect()
    torch.cuda.empty_cache()


def threshold(rows) -> float:
    """The eighth-highest stream-end score of ``rows``, so that the first
    responses fire within the first STREAM_FRAMES frames."""
    return sorted((r["informative_score"] + r["relevance_score"] for r in rows),
                  reverse=True)[7]


def median_stream_end(rows) -> float:
    return statistics.median(r["informative_score"] + r["relevance_score"] for r in rows)


def host_rule_frames(rows, icfg) -> list[int]:
    """The frames at which the stepwise rule (the session's own
    ``_check_trigger``, run on the host) fires on the scores of ``rows`` in
    order, under the rule and gate of ``icfg``."""
    from aha_tpu_torch.streaming.session import StreamSession

    s = StreamSession.__new__(StreamSession)
    for f in ("stream_end_prob_threshold", "stream_end_score_sum_threshold", "threshold_z",
              "response_min_interval_frames", "first_n_frames_no_generate",
              "running_list_length"):
        setattr(s, f, getattr(icfg, f))
    s.score_heads = list(icfg.score_heads)
    s.stream_end_prob_list, s.stream_end_score_sum = [], 0.0
    s.frame_idx, s.last_response_frame = 0, None
    fired = []
    for f, r in enumerate(rows):
        s.frame_idx += 1
        if s._check_trigger({"informative_score": r["informative_score"],
                             "relevance_score": r["relevance_score"]}):
            fired.append(f)
    return fired


def count_syncs(fn) -> int:
    """The calls that made the host wait for the card while ``fn`` ran: the
    warnings of CUDA's sync debug mode, one a synchronising call."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def fired_frames(sess, turns) -> list[int]:
    """The frames whose scores a response followed (it is stamped with the
    frame's time)."""
    at = {r["time"]: f for f, r in enumerate(sess.debug_data_list)}
    return [at[t["time"]] for t in turns if t["role"] == "assistant"]


def phase4e(gpu, stats, cfg, tok, frames, params4, params8, scored):
    """inference()'s chunked trigger loops at 7B on the weights of phases 4a-4d:
    bit for bit the stepwise loop at fused 1 (sum and z rules), the host rule
    on each fused run's own scores at fused 4 and 8, frames/s beside
    score_video's and the stepwise loop's; then the ``infer`` command's
    session and driver, and ``cmd_infer`` on a clip written with cv2."""
    import argparse
    import tempfile

    import cv2
    import numpy as np
    import torch

    from aha_tpu_torch.cli import _session, cmd_infer
    from aha_tpu_torch.drivers import benchmarks
    from aha_tpu_torch.ops import kernels

    L = cfg.llm.num_layers
    n_frames = frames.shape[0]
    rows4, rows8, rows_a8 = (scored[m][0] for m in ("7b-int4", "7b-int8", "7b-int8 fused_a8"))
    z_rule = dict(threshold_z=1.5, first_n_frames_no_generate=8, running_list_length=20)

    def run_both(params, kernel, rule, widths, backend="fused"):
        """The chunked and the stepwise run, and each one's decoder passes."""
        kernels.reset_launches()
        runs, passes = [], []
        for chunked in (True, False):
            with PassCounter() as pc:
                runs.append(run_inference(params, cfg, tok, frames, rule, widths,
                                          backend=backend, chunked=chunked, max_new_tokens=16))
            passes.append(pc.chunks + pc.verifies)
        counts = dict(kernels.LAUNCHES)
        if counts.get(kernel, 0) < L * sum(passes) * 4 or counts.get("decode_attention", 0) < L:
            raise AssertionError(f"phase4e: launches {counts} over {passes} decoder passes")
        stats.launches(counts)
        for sess, turns, *_ in runs:
            if len(sess.debug_data_list) != n_frames or not all(
                    math.isfinite(r[k]) for r in sess.debug_data_list for k in SCORE_KEYS):
                raise AssertionError(f"phase4e: {len(sess.debug_data_list)} frame scores or a "
                                     f"non-finite one")
        return runs, passes

    def rate(run):
        return n_frames / (run[2] - run[3])          # frames over the time outside generate()

    # 1. fused 1: the chunked loop makes the stepwise loop's calls, so every bit is equal
    t0 = time.perf_counter()
    widths = dict(fused_score_frames=1, spec_decode_tokens=4, spec_decode_tokens_max=8)
    for name, rule in (("sum", dict(stream_end_score_sum_threshold=10 * median_stream_end(rows8))),
                       ("z", z_rule)):
        runs, passes = run_both(params8, "int8_matmul", rule, widths)
        (ca, ta, *_), (cb, tb, *_) = runs
        fired = fired_frames(ca, ta)
        if ca.debug_data_list != cb.debug_data_list or ta != tb:
            raise AssertionError(f"phase4e 7b-int8 fused 1 {name} rule: the chunked run differs "
                                 f"from the stepwise run")
        if len(fired) < 3:
            raise AssertionError(f"phase4e 7b-int8 fused 1 {name} rule: {len(fired)} responses")
        print(f"phase4e 7b-int8 fused 1, generation 4->8, {name} rule ({rule}) [{gpu}]: chunked "
              f"inference() equal to stepwise bit for bit over {n_frames} frames (every score, "
              f"response time and text; {len(fired)} responses at frames {fired}); chunked "
              f"{rate(runs[0]):.2f} frames/s, stepwise {rate(runs[1]):.2f}; decoder passes "
              f"{passes[0]} and {passes[1]}", flush=True)
        del runs, ca, cb

    # 2. fused 4 and 8: the responses fire where the host rule puts them on the run's own
    # scores; the stepwise run at the same widths parts at the first differing decision
    cases = [("7b-int4", params4, "int4_matmul", "fused", dict(fused_score_frames=4),
              dict(stream_end_score_sum_threshold=8 * median_stream_end(rows4))),
             ("7b-int8", params8, "int8_matmul", "fused", dict(fused_score_frames=4), z_rule),
             ("7b-int8 fused_a8", params8, "int8_matmul_a8", "fused_a8",
              dict(fused_score_frames=8), dict(stream_end_prob_threshold=threshold(rows_a8)))]
    for name, params, kernel, backend, widths, rule in cases:
        widths = dict(widths, spec_decode_tokens=4, spec_decode_tokens_max=8)
        rule = dict(rule, response_min_interval_frames=4)
        runs, passes = run_both(params, kernel, rule, widths, backend)
        (ca, ta, *_), (cb, tb, *_) = runs
        fired, host = fired_frames(ca, ta), host_rule_frames(ca.debug_data_list, ca.args)
        if fired != host or len(fired) < 3:
            raise AssertionError(f"phase4e {name}: responses at frames {fired}, the host rule "
                                 f"on the run's scores fires at {host}")
        step = fired_frames(cb, tb)
        first = min(sorted(set(fired) ^ set(step)) or [n_frames])
        gap = max((abs(a[k] - b[k]) for a, b in zip(ca.debug_data_list[:first],
                                                    cb.debug_data_list[:first])
                   for k in SCORE_KEYS), default=0.0)
        sv = scored[name][1]
        print(f"phase4e {name} fused {widths['fused_score_frames']}, generation 4->8, "
              f"min interval 4, {rule} [{gpu}]: {len(fired)} responses at frames {fired}, "
              f"where the host rule on the run's own scores fires; stepwise run at the same "
              f"widths fires at {step}, first differing decision at frame "
              f"{first if first < n_frames else 'none'}, largest score gap before it "
              f"{gap:.3e}; frames/s chunked {rate(runs[0]):.2f}, stepwise {rate(runs[1]):.2f}, "
              f"score_video {sv:.2f} (chunked / score_video {rate(runs[0]) / sv:.3f}); decoder "
              f"passes chunked {passes[0]}, stepwise {passes[1]}", flush=True)
        del runs, ca, cb

    # 3. host reads: the synchronising calls of 32 frames scored with no response (the prob
    # rule at 2: informative + relevance never exceeds it), 7B-int8 at fused 4
    for chunked in (True, False):
        with PassCounter() as pc:
            syncs = count_syncs(lambda: run_inference(
                params8, cfg, tok, frames[:32], 2.0, dict(fused_score_frames=4),
                chunked=chunked))
        passes = pc.chunks + pc.verifies
        print(f"phase4e host reads, 7b-int8 fused 4, 32 frames, no response, "
              f"{'chunked' if chunked else 'stepwise'} [{gpu}]: {syncs} synchronising calls "
              f"over {passes} decoder passes ({syncs / passes:.2f} a pass, "
              f"{syncs / 32:.2f} a frame)", flush=True)

    # 5. the infer command: its session from parsed flags at the product defaults (JAX's
    # synthetic weights, not those of phases 4a-4d: the prob threshold comes from the
    # session's own scores over the first 32 frames), its driver's pass on the seeded frames
    p = argparse.ArgumentParser()
    _session._add_infer_flags(p)
    query = [{"role": "user", "content": QUERY, "time": 0}]
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    for flag in ("--int8", "--int4"):
        # a placeholder threshold for the flags' rule; the session's own is set below
        args = p.parse_args(["--synthetic_weights", flag, "--test_dataset", "youcook2",
                             "--input_dir", ".", "--output_fname", "unused",
                             "--stream_end_prob_threshold", "1.0", "--max_new_tokens", "16"])
        kernels.reset_launches()
        t0_cli = time.perf_counter()
        sess = _session._build_session(args)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0_cli
        sess.stream_end_prob_threshold = threshold(
            score_64(sess.engine.params, cfg, tok, frames[:32], product)[0])
        stats.launches(dict(kernels.LAUNCHES))         # the build and the threshold's pass
        kernels.reset_launches()                       # the driver's run starts here
        t1_cli = time.perf_counter()
        responses, debug = benchmarks._full_pass(sess, frames[:32], 2.0, query)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)                # ... and ends here
        kernel = "int8_matmul" if flag == "--int8" else "int4_matmul"
        n_resp = sum(t["role"] == "assistant" for t in responses)
        if (len(debug) != 32 or n_resp < 1 or counts.get(kernel, 0) < L * 4
                or not all(math.isfinite(r[k]) for r in debug for k in SCORE_KEYS)):
            raise AssertionError(f"phase4e infer {flag}: {len(debug)} frame scores, {n_resp} "
                                 f"responses, launches {counts}")
        stats.launches(counts)
        e = sess.engine
        print(f"phase4e infer session from flags {args.model_preset} {flag} [{gpu}]: weights "
              f"{t_build:.2f}s; fused {e.fused_frames}, generation {e.spec_tokens}->"
              f"{e.spec_max}, backend {e.backend}; _full_pass 32 frames "
              f"{time.perf_counter() - t1_cli:.3f}s, {n_resp} responses; launches "
              f"{kernel}={counts[kernel]}", flush=True)
        del sess
        gc.collect()
    # ... and cmd_infer end to end on a clip written with cv2 (4 s at 8 fps)
    with tempfile.TemporaryDirectory() as d:
        writer = cv2.VideoWriter(f"{d}/clip.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (64, 48))
        for i in range(32):
            writer.write(np.full((48, 64, 3), (i * 10) % 255, np.uint8))
        writer.release()
        with open(f"{d}/qa.json", "w") as f:
            json.dump([{"question_id": "clip", "video": "clip.mp4", "conversation": query}], f)
        kernels.reset_launches()
        t1 = time.perf_counter()
        cmd_infer(["--synthetic_weights", "--int4", "--test_dataset", "youcook2",
                   "--input_dir", d, "--test_fname", f"{d}/qa.json",
                   "--output_fname", f"{d}/out.jsonl",
                   "--stream_end_prob_threshold", repr(threshold(rows4)),
                   "--max_new_tokens", "16"])
        torch.cuda.synchronize()
        t_cmd = time.perf_counter() - t1
        counts = dict(kernels.LAUNCHES)
        with open(f"{d}/out.jsonl") as f:
            lines = [json.loads(x) for x in f]
    debug = lines[0]["debug_data"] if len(lines) == 1 else []
    if (len(debug) != 8 or set(lines[0]) != {"question_id", "model_response_list",
                                             "video_duration", "debug_data"}
            or not all(math.isfinite(r[k]) for r in debug for k in SCORE_KEYS)
            or counts.get("int4_matmul", 0) < L * 4):
        raise AssertionError(f"phase4e cmd_infer: {lines!r:.500}, launches {counts}")
    stats.launches(counts)
    print(f"phase4e cmd_infer youcook2 --synthetic_weights --int4 on a 4 s cv2 clip [{gpu}]: "
          f"{t_cmd:.2f}s with the weights; {len(debug)} frames, "
          f"{sum(t['role'] == 'assistant' for t in lines[0]['model_response_list'])} responses; "
          f"cv2 {cv2.__version__}; phase 4e took {time.perf_counter() - t0:.1f}s", flush=True)


# -- phase 6: JAX's weights at 7B ----------------------------------------------------


def check_slabs(params, cfg) -> str:
    """Slabs of three leaves of the card-built 7B-int8 tree (an int8 product leaf,
    the int8 embedding table, a bf16 normal leaf) drawn again on the CPU with the
    same generator: equal bit for bit, to the tree's values and to the card's draw."""
    import torch

    from aha_tpu_torch.models import loader

    specs = loader.leaf_specs(cfg, "int8")
    counters = {path: i for i, (path, _, _) in enumerate(specs, 1)}
    picks = {("llm", "layers", "o_proj", "kernel", "qvalue"):
             params["llm"]["layers"]["o_proj"]["kernel"]["qvalue"],
             ("llm", "embed", "weight", "qvalue"): params["llm"]["embed"]["weight"]["qvalue"],
             ("vision", "layers", "fc1", "kernel"): params["vision"]["layers"]["fc1"]["kernel"]}
    notes = []
    for path, leaf in picks.items():
        shape, dtype = tuple(leaf.shape), leaf.dtype
        n, slab = leaf.numel(), 1 << 20
        for start in (0, n // 2 - slab // 2, n - slab):
            cpu = loader.draw_leaf(path, shape, dtype, counters[path], start, start + slab, "cpu")
            card = loader.draw_leaf(path, shape, dtype, counters[path], start, start + slab,
                                    "cuda")
            if not (torch.equal(card.cpu(), cpu)
                    and torch.equal(leaf.reshape(-1)[start:start + slab].cpu(), cpu)):
                raise AssertionError(f"phase6a: leaf {'/'.join(path)} values {start}.."
                                     f"{start + slab}: the card's draw is not the CPU's")
        notes.append(f"{'/'.join(path)} (leaf {counters[path]}, {n} values)")
    return "3 slabs of 2^20 values each of " + ", ".join(notes)


def phase6(gpu: str, stats: Stats):
    """JAX's synthetic 7B-int8 tree against golden_7b_int8_chip.npz (recorded on
    the TPU), then a 7B checkpoint written and read back through the command line."""
    import numpy as np
    import torch

    from aha_tpu_torch import golden
    from aha_tpu_torch.ops import kernels

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    ref = np.load(golden.FIXTURES["chip7b"], allow_pickle=False)
    atol, rtol = golden.ATOL["chip7b"], golden.RTOL
    keys = ("scores", "scores_fused4")
    widths = {"scores": 1, "scores_fused4": 4}
    L = 28

    t0 = time.perf_counter()
    params, cfg, tok, frames = golden.build("chip7b", "cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    print(f"phase6a materialize_random_params(aha_7b(), 'int8') on the card [{gpu}]: "
          f"{t_build:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
          f"{check_slabs(params, cfg)}: card equal to CPU", flush=True)
    if golden.frames_sha256(frames) != str(ref["frames_sha256"]) or not np.array_equal(
            golden.rendered_ids(tok), ref["ids"]):
        raise AssertionError("phase6a: the fixture's frames or ids do not reproduce")

    def traces(tree, c, what):
        kernels.reset_launches()
        t = time.perf_counter()
        out = {k: golden.score_trace(tree, c, tok, frames, widths[k]) for k in keys}
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        stats.launches(counts)
        print(f"phase6a {what} score traces (8 frames at fused 1 and 4) "
              f"{time.perf_counter() - t:.2f}s; launches {counts}", flush=True)
        return out, counts

    bf, counts = traces(params, cfg, "bf16")
    if counts.get("int8_matmul", 0) < L * 4 * 2 or counts.get("decode_attention", 0) < L:
        raise AssertionError(f"phase6a: launches {counts}")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with golden.recorded_logits() as logits:
        seq = golden.gen_trace(params, cfg, tok, frames, 1, 1)
    t_seq = time.perf_counter() - t0
    spec = golden.gen_trace(params, cfg, tok, frames, 4, 8)
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0 - t_seq
    counts = dict(kernels.LAUNCHES)
    stats.launches(counts)
    if seq != spec:
        raise AssertionError("phase6a: speculative texts differ from sequential ones:"
                             + _first_divergence(seq, spec))
    print(f"phase6a bf16 generation traces (a response after each of 8 frames, 48 tokens) "
          f"[{gpu}]: width 1 {t_seq:.2f}s, 4 -> 8 {t_spec:.2f}s; texts equal; launches "
          f"{counts}", flush=True)
    ok_texts = True
    for key, got in (("gen_texts_seq", seq), ("gen_texts_spec", spec)):
        div = golden.first_divergences(got, list(ref[key]), tok, logits)
        for d in div:
            print(f"phase6a {key} vs the fixture: "
                  + ("equal" if d is None else json.dumps(d)), flush=True)
        ok_texts = ok_texts and golden.texts_ok("chip7b", div)
    wide, cfg32 = golden.widened(params, cfg)
    f32, counts = traces(wide, cfg32, "f32")
    if counts.get("int8_matmul", 0) < L * 4 * 2 or counts.get("decode_attention", 0) < L:
        raise AssertionError(f"phase6a f32: launches {counts}")
    del wide, params
    gc.collect()
    torch.cuda.empty_cache()

    tpu_own = np.abs(ref["scores"] - ref["scores_fused4"]).max(axis=0)
    failed = [] if ok_texts else ["texts: the fixture's token is more than 2 bf16 steps "
                                  "below the port's top logit at the first divergence"]
    for key in keys:
        gap32, ok32 = golden.score_gaps(f32[key], ref[key], atol, rtol)
        gap16, ok16 = golden.score_gaps(bf[key], ref[key], atol, rtol)
        card = np.abs(bf[key] - f32[key]).max(axis=0)
        allowed = tpu_own + card
        ok_bf = ok16 or bool((gap16 <= allowed).all())
        print(f"phase6a {key} [{gpu}] (atol {atol}, rtol {rtol}), largest gap per column "
              f"(informative, relevance, uncertainty): f32 vs fixture {gap32.tolist()} "
              f"within={ok32}; bf16 vs fixture {gap16.tolist()} within={ok16}; bf16 vs f32 "
              f"{card.tolist()}; the TPU's own per-frame vs fused {tpu_own.tolist()} + bf16 vs "
              f"f32 = {allowed.tolist()}: bf16 gap within it {bool((gap16 <= allowed).all())}",
              flush=True)
        if not ok32:
            failed.append(f"{key}: the f32 trace is not within the fixture's tolerance")
        if not ok_bf:
            failed.append(f"{key}: the bf16 trace is outside the tolerance and the allowance")
    if failed:
        raise AssertionError(f"phase6a: {failed}")
    phase6b(gpu, stats, cfg, tok, frames)
    print(f"phase6 took {time.perf_counter() - t_phase:.1f}s", flush=True)


def phase6b(gpu: str, stats: Stats, cfg, tok, frames):
    """JAX's dense bf16 7B tree exported in the reference's key layout, written as
    safetensors shards of 5 GB at most outside the repo, then served by the session
    that ``infer --llm_pretrained DIR --int8 --model_preset 7b`` builds: its scores
    equal bit for bit those of the same tree quantised in memory. The dense tree's own
    scores (torch.matmul products) at fused 4 are timed."""
    import argparse
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from aha_tpu_torch import golden
    from aha_tpu_torch.cli import _session
    from aha_tpu_torch.models import loader
    from aha_tpu_torch.ops import kernels, quant

    t0 = time.perf_counter()
    dense = loader.materialize_random_params(cfg, None, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    kernels.reset_launches()
    t0 = time.perf_counter()
    dense_scores = golden.score_trace(dense, cfg, tok, frames, 4)
    torch.cuda.synchronize()
    t_dense = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    stats.launches(counts)
    if counts.get("int8_matmul", 0) or not counts.get("decode_attention", 0) or not (
            np.isfinite(dense_scores).all()):
        raise AssertionError(f"phase6b dense bf16: launches {counts}, scores {dense_scores}")
    print(f"phase6b materialize_random_params(aha_7b(), None) (dense bf16) [{gpu}]: "
          f"{t_build:.2f}s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB; score_video 8 "
          f"frames at fused 4 on torch.matmul {t_dense:.2f}s = {8 / t_dense:.2f} frames/s "
          f"(vision included); launches {counts}", flush=True)
    q = quant.quantize_params(dense)
    q = {**q, "llm": quant.merge_decoder_projections(q["llm"])}
    in_memory = {w: golden.score_trace(q, cfg, tok, frames, w) for w in (1, 4)}
    del q
    sd = loader.export_hf_state_dict(dense, cfg)
    nbytes = sum(t.numel() * t.element_size() for t in sd.values())
    d = tempfile.mkdtemp(prefix="aha_ckpt_")        # the system's temporary directory
    try:
        free = shutil.disk_usage(d).free
        print(f"phase6b checkpoint directory {d}: {free / 1e9:.1f} GB free, "
              f"{nbytes / 1e9:.2f} GB to write", flush=True)
        if free < 1.05 * nbytes:
            raise AssertionError(f"phase6b: {free} bytes free for a {nbytes}-byte checkpoint")
        t0 = time.perf_counter()
        paths = loader.save_sharded(sd, d)
        t_write = time.perf_counter() - t0
        written = sum(os.path.getsize(x) for x in paths)
        del sd, dense
        gc.collect()
        torch.cuda.empty_cache()
        p = argparse.ArgumentParser()
        _session._add_infer_flags(p)
        args = p.parse_args(["--llm_pretrained", d, "--int8", "--model_preset", "7b",
                             "--test_dataset", "youcook2", "--input_dir", ".",
                             "--output_fname", "unused", "--grounding_mode", "--frame_fps", "1",
                             "--fused_score_frames", "1", "--spec_decode_tokens", "1"])
        kernels.reset_launches()
        t0 = time.perf_counter()
        sess = _session._build_session(args)
        torch.cuda.synchronize()
        t_read = time.perf_counter() - t0
        rows = sess.score_video(frames, query=golden.QUERY)
        from_files = {1: np.asarray([[r[k] for k in SCORE_KEYS] for r in rows], np.float32),
                      4: golden.score_trace(sess.engine.params, sess.engine.cfg, sess.tokenizer,
                                            frames, 4)}
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        stats.launches(counts)
        del sess
    finally:
        shutil.rmtree(d, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    equal = all(np.array_equal(from_files[w], in_memory[w]) for w in (1, 4))
    print(f"phase6b infer --llm_pretrained DIR --int8 --model_preset 7b [{gpu}]: "
          f"{len(paths)} shards, {written / 1e9:.2f} GB written in {t_write:.2f}s "
          f"({written / 1e9 / t_write:.2f} GB/s); session from the flags (read, convert on "
          f"the card, quantise, merge) {t_read:.2f}s ({written / 1e9 / t_read:.2f} GB/s); "
          f"scores at fused 1 and 4 equal bit for bit to the tree quantised in memory: "
          f"{equal}; launches {counts}; the directory removed", flush=True)
    if not equal or counts.get("int8_matmul", 0) < 28 * 4:
        raise AssertionError(f"phase6b: scores from the files differ from the in-memory "
                             f"tree's, or launches {counts}")


# -- phase 7: multi-stream serving, 7B-int8 at B 8 ------------------------------------

P7_CACHE = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32)
P7_PRODUCT = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)


def p7_setup(seed: int):
    """Phase 7's model (7B), stream (phase 4's) and int8 weights (phase 4b's):
    (cfg, tok, frames, params, seconds to make the weights)."""
    import torch

    from aha_tpu_torch.models.aha import random_params

    cfg, tok = _model("7b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randint(0, 256, (96, 384, 384, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    t0 = time.perf_counter()
    params = random_params(cfg, mode="int8", seed=seed)
    torch.cuda.synchronize()
    return cfg, tok, frames, params, time.perf_counter() - t0


def p7_videos(frames, B: int) -> list:
    """7b's streams: B clips of 32 frames, stream b starting 8 b frames in."""
    return [frames[8 * b:8 * b + 32] for b in range(B)]


def flat(runs) -> list:
    return [r for rows in runs for r in rows]


def tolerance_share(a, b, atol: float, rtol: float) -> float:
    """The largest share of the tolerance that a gap takes, |a - b| / (atol +
    rtol |b|), over two lists of score rows (within the tolerance: <= 1)."""
    import numpy as np

    got, ref = (np.asarray([[r[k] for k in SCORE_KEYS] for r in x], np.float64).reshape(-1, 3)
                for x in (a, b))
    return round(float((np.abs(got - ref) / (atol + rtol * np.abs(ref))).max()), 4)


def p7_readings(params, cfg, tok, videos, full, solo):
    """7b's shares of the 7B fixture's tolerance, given the batch (``full``) and
    the solo runs (``solo``) at fused 4: the batch against solo; the noise of
    another product plan (solo at fused 1 against fused 4: 49 + prefix rows a
    frame step against 196 a fused pass), which must fit in the tolerance; the
    gaps of two faults, which must not: a frame off by one, and a row swapped
    with its neighbour (stream b + 1 starts 8 frames later); and, reported,
    the batch against solo at fused 1 (``batched_fused1``), where every frame
    is a write pass. Returns
    (readings, solo runs at fused 1)."""
    from aha_tpu_torch import golden
    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.multi import MultiStreamScorer
    from aha_tpu_torch.streaming.session import build_session

    use = lambda a, b: tolerance_share(a, b, golden.ATOL["chip7b"], golden.RTOL)
    g1cfg = InferConfig(grounding_mode=True, **P7_CACHE,
                        **dict(P7_PRODUCT, fused_score_frames=1))
    solo1 = [build_session(params, cfg, tok, g1cfg).score_video(v, query=QUERY) for v in videos]
    full1 = MultiStreamScorer(params, cfg, tok, g1cfg, batch=len(videos)).score_videos(
        videos, [QUERY] * len(videos), fps=2.0)
    return {"batched": use(flat(full), flat(solo)), "noise": use(flat(solo1), flat(solo)),
            "frame_off_by_one": use(flat(r[1:] for r in full), flat(r[:-1] for r in solo)),
            "rows_swapped": use(flat(full), flat(solo[1:] + solo[:1])),
            "batched_fused1": use(flat(full1), flat(solo1))}, solo1


def batch_gaps(gpu: str, seed: int) -> None:
    """``--batch_gaps``: 7b's readings (``p7_readings``) alone, with no check and
    no result line. It uses only what every checkout's package has had since
    multi-stream serving, so that a copy of this script run from another
    checkout (a parent commit) reads the same gaps of that commit's code."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.multi import MultiStreamScorer
    from aha_tpu_torch.streaming.session import build_session

    cfg, tok, frames, params, _ = p7_setup(seed)
    videos = p7_videos(frames, SERVE_B)
    gcfg = InferConfig(grounding_mode=True, **P7_CACHE, **P7_PRODUCT)
    full = MultiStreamScorer(params, cfg, tok, gcfg, batch=SERVE_B).score_videos(
        videos, [QUERY] * SERVE_B, fps=2.0)
    solo = [build_session(params, cfg, tok, gcfg).score_video(v, query=QUERY) for v in videos]
    readings, _ = p7_readings(params, cfg, tok, videos, full, solo)
    torch.cuda.synchronize()
    print(f"batch_gaps 7B-int8 B {SERVE_B} x 32 frames [{gpu}]: shares of the 7B fixture's "
          f"tolerance {json.dumps(readings)}", flush=True)


def solo_run(params, cfg, tok, video, conv, rule: dict, widths: dict):
    """A solo ``StreamSession.inference()`` over one request at the serving
    settings of phase 7. Returns (session, turns, seconds in all, seconds
    inside generate(), tokens written)."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.streaming.session import build_session

    sess = build_session(params, cfg, tok, InferConfig(
        frame_fps=2.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32,
        max_new_tokens=16, **rule, **widths))
    generate = sess.engine.generate
    gen_s, tokens = [0.0], [0]

    def timed_generate(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = generate(*a, **k)
        tokens[0] += int(out[1].sum())
        torch.cuda.synchronize()
        gen_s[0] += time.perf_counter() - t
        return out

    sess.engine.generate = timed_generate
    t0 = time.perf_counter()
    sess.input_video_stream(video)
    sess.input_query_stream(conv)
    turns = sess.inference()
    torch.cuda.synchronize()
    return sess, turns, time.perf_counter() - t0, gen_s[0], tokens[0]


def phase7(gpu: str, seed: int, stats: Stats):
    """Multi-stream serving at 7B-int8, B 8, at the product widths: (b) the
    lockstep scorer against solo ``score_video`` and a stream alone in an
    otherwise empty batch (equal bits); (a) the continuous-batching server
    over 12 requests against solo ``inference()`` runs; (c) the ``serve``
    command on clips written with cv2."""
    import numpy as np
    import torch

    from aha_tpu_torch import golden
    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.streaming.multi import MultiStreamScorer, MultiStreamServer
    from aha_tpu_torch.streaming.session import build_session

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, tok, frames, params, t_params = p7_setup(seed)
    L = cfg.llm.num_layers
    cache, product, B = P7_CACHE, P7_PRODUCT, SERVE_B

    def launched(counts, chunks, verifies, what):
        n8, na = counts.get("int8_matmul", 0), counts.get("decode_attention", 0)
        if (n8 < L * 4 * (chunks + verifies) or na < L * chunks or counts.get("int4_matmul", 0)
                or counts.get("decode_attention_steps", 0) < L * verifies):
            raise AssertionError(f"phase7 {what}: launches {counts} over {chunks} chunks + "
                                 f"{verifies} verify passes")
        stats.launches(counts)

    atol, rtol = golden.ATOL["chip7b"], golden.RTOL

    def gap(a, b):
        """The largest |a - b| per score column over two lists of score rows, and
        whether every value of ``a`` is within the 7B fixture's tolerance of
        ``b`` (atol 2e-2 + rtol 5e-2 x |b|). 7b measures below which gaps
        another product plan gives (noise) and which a fault gives."""
        got, ref = (np.asarray([[r[k] for k in SCORE_KEYS] for r in x], np.float64).reshape(-1, 3)
                    for x in (a, b))
        g, ok = golden.score_gaps(got, ref, atol, rtol)
        return g.tolist(), ok

    use = lambda a, b: tolerance_share(a, b, atol, rtol)

    # -- b. the lockstep scorer: 8 streams of 32 frames at fused 4 --------------------------
    videos = p7_videos(frames, B)
    gcfg = InferConfig(grounding_mode=True, **cache, **product)
    scorer = MultiStreamScorer(params, cfg, tok, gcfg, batch=B)
    with PassCounter() as pc:
        kernels.reset_launches()                        # the main path starts here
        t0 = time.perf_counter()
        full = scorer.score_videos(videos, [QUERY] * B, fps=2.0)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)                 # ... and ends here
    launched(counts, pc.chunks, pc.verifies, "lockstep scorer")
    alone = scorer.score_videos([videos[0]] + [frames[:0]] * (B - 1), [QUERY] + [None] * (B - 1),
                                fps=2.0)
    t0 = time.perf_counter()
    solo = [build_session(params, cfg, tok, gcfg).score_video(v, query=QUERY) for v in videos]
    torch.cuda.synchronize()
    t_solo = time.perf_counter() - t0
    gaps, within = gap(flat(full), flat(solo))
    finite = all(math.isfinite(r[k]) for rows in full for r in rows for k in SCORE_KEYS)
    del scorer
    readings, solo1 = p7_readings(params, cfg, tok, videos, full, solo)
    noise_gaps, _ = gap(flat(solo1), flat(solo))
    print(f"phase7b MultiStreamScorer B {B} x 32 frames at fused 4 [{gpu}]: params "
          f"{t_params:.2f}s; {t_full:.3f}s = {B * 32 / t_full:.2f} frames/s (vision included), "
          f"solo score_video x {B} {t_solo:.3f}s = {B * 32 / t_solo:.2f} frames/s; largest gap "
          f"to solo per column {gaps}, within atol 2e-2 + rtol 5e-2: {within}; noise (solo "
          f"fused 1 against fused 4) per column {noise_gaps}; share of the tolerance taken "
          f"{readings} (batched_fused1: the batch against solo at fused 1, reported); stream "
          f"0 alone in slot 0 of an otherwise empty batch equal bit for bit "
          f"to the full batch: {alone[0] == full[0]}; {pc.chunks} chunks + "
          f"{pc.verifies} verify passes; launches {counts}", flush=True)
    if (alone[0] != full[0] or not within or not finite or [len(r) for r in full] != [32] * B
            or readings["noise"] > 1.0 or readings["frame_off_by_one"] <= 1.0
            or readings["rows_swapped"] <= 1.0):
        stats.fail(f"phase7b: alone equal {alone[0] == full[0]}, gaps {gaps}, "
                   f"finite {finite}, tolerance taken {readings}")
    del solo, solo1, alone

    # -- a. the server: 12 requests of 24-64 frames over 8 slots ---------------------------
    se = sorted(r["informative_score"] + r["relevance_score"] for rows in full for r in rows)
    prob_thr, sum_thr = se[int(0.97 * len(se))], 20 * statistics.median(se)
    items = []
    for j, n in enumerate(SERVE_LENGTHS):
        o = (11 * j) % (96 - n + 1)
        conv = [{"role": "user", "content": QUERY, "time": 0}]
        if j % 3 == 1:                                  # and a query mid-stream
            conv.append({"role": "user", "content": QUERY, "time": (n // 2) / 2.0})
        rule = ({"stream_end_prob_threshold": prob_thr} if j % 2 == 0
                else {"stream_end_score_sum_threshold": sum_thr})
        items.append((f"r{j}", frames[o:o + n], conv, rule))
    server = MultiStreamServer(params, cfg, tok, InferConfig(
        **cache, **product, max_new_tokens=16, stream_end_prob_threshold=prob_thr),
        batch=B, max_frames=max(SERVE_LENGTHS))
    with PassCounter() as pc:
        kernels.reset_launches()
        t0 = time.perf_counter()
        res = server.run_items(items, fps=2.0)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
    launched(counts, pc.chunks, pc.verifies, "server")
    lat = server.latency_stats()
    n_frames = sum(SERVE_LENGTHS)
    solo_s = solo_gen_s = 0.0
    solo_tokens = n_resp = 0
    failed = []
    for key, video, conv, rule in items:
        got = res[key]
        rows = got["debug_data"]
        b_turns = [t for t in got["responses"] if t["role"] == "assistant"]
        fired = [round(t["time"] * 2.0) for t in b_turns]
        host = host_rule_frames(rows, InferConfig(**rule))
        sess, turns, t_s, g_s, n_tok = solo_run(params, cfg, tok, video, conv, rule, product)
        solo_s, solo_gen_s, solo_tokens = solo_s + t_s, solo_gen_s + g_s, solo_tokens + n_tok
        n_resp += len(b_turns)
        s_fired = fired_frames(sess, turns)
        first = min(sorted(set(fired) ^ set(s_fired)) or [len(video)])
        g, within = gap(rows[:first + 1], sess.debug_data_list[:first + 1])
        taken = use(rows[:first + 1], sess.debug_data_list[:first + 1])
        # texts: pairwise while the responses follow the same frames; at the first text
        # that parts, the tokens must tie in the solo run's logits (width 1: its texts)
        b_texts, s_texts = texts(got["responses"]), texts(turns)
        same = 0
        while (same < min(len(b_texts), len(s_texts)) and fired[same] == s_fired[same]
               and b_texts[same] == s_texts[same]):
            same += 1
        tie = ""
        if same < min(len(b_texts), len(s_texts)) and fired[same] == s_fired[same]:
            with golden.recorded_logits() as logits:
                _, turns1, *_ = solo_run(params, cfg, tok, video, conv, rule,
                                         dict(product, spec_decode_tokens=1))
            div = golden.first_divergences(texts(turns1)[:same + 1], b_texts[:same + 1], tok,
                                           logits)
            d = next((x for x in div if x is not None), None)
            steps = float("inf") if d is None else d.get("gap_bf16_steps", float("inf"))
            tie = f"; response {same} parts at a tie: {json.dumps(d)}"
            if not steps <= 2.0:
                failed.append(f"{key}: response {same} parts {steps} bf16 steps from the top")
        ok = (len(rows) == len(video) and fired == host and within
              and all(math.isfinite(r[k]) for r in rows for k in SCORE_KEYS))
        if not ok:
            failed.append(f"{key}: {len(rows)} frames, responses at {fired}, host rule {host}, "
                          f"gap {g}")
        print(f"phase7a {key} {len(video)} frames, {len(conv)} queries, {rule} [{gpu}]: "
              f"responses at frames {fired} (host rule on the batched scores: {host}); solo at "
              f"{s_fired}; largest score gap per column up to the first differing decision "
              f"{g} (within atol 2e-2 + rtol 5e-2: {within}, share of it taken {taken}); texts "
              f"equal to solo for {same} "
              f"of {len(b_texts)} responses{tie}",
              flush=True)
        del sess
    print(f"phase7a MultiStreamServer batch {B}, 12 requests, {n_frames} frames, fused 4, "
          f"generation 4->8, max_new_tokens 16 [{gpu}]: {t_serve:.3f}s = "
          f"{n_frames / t_serve:.2f} frames/s and {lat.get('tokens', 0) / t_serve:.2f} decode "
          f"tokens/s aggregate ({n_resp} responses, {lat.get('tokens', 0)} tokens); solo runs "
          f"summed {solo_s:.3f}s: {n_frames / (solo_s - solo_gen_s):.2f} frames/s outside "
          f"generate(), {solo_tokens / max(solo_gen_s, 1e-9):.2f} tokens/s inside it, "
          f"{n_frames / solo_s:.2f} frames/s in all; latency_stats {lat}; {pc.chunks} chunks "
          f"+ {pc.verifies} verify passes; launches {counts}", flush=True)
    if failed or n_resp < 6:
        stats.fail(f"phase7a: {n_resp} responses; {failed}")
    del server, res, params
    gc.collect()
    torch.cuda.empty_cache()
    phase7c(gpu, stats, L)
    print(f"phase7 took {time.perf_counter() - t_phase:.1f}s", flush=True)


def phase7c(gpu: str, stats: Stats, L: int):
    """``python -m aha_tpu_torch.cli serve --synthetic_weights --int8 --batch 8`` on
    four requests whose clips are written with cv2: one result line each."""
    import tempfile

    import cv2
    import numpy as np
    import torch

    from aha_tpu_torch.cli import cmd_serve
    from aha_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory() as d:
        reqs = []
        for j in range(4):
            writer = cv2.VideoWriter(f"{d}/c{j}.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 8.0,
                                     (64, 48))
            for i in range(32):                          # 4 s: 8 frames at 2 fps
                writer.write(np.full((48, 64, 3), (i * 10 + 40 * j) % 255, np.uint8))
            writer.release()
            conv = [{"role": "user", "content": QUERY, "time": 0}]
            if j == 1:
                conv.append({"role": "user", "content": QUERY, "time": 2.0})
            reqs.append({"key": f"c{j}", "video": f"{d}/c{j}.mp4", "conversation": conv})
        reqs[3]["stream_end_prob_threshold"] = 0.5       # a rule of its own
        with open(f"{d}/requests.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in reqs)
        kernels.reset_launches()
        t0 = time.perf_counter()
        cmd_serve(["--synthetic_weights", "--int8", "--batch", str(SERVE_B), "--input",
                   f"{d}/requests.jsonl", "--output", f"{d}/out.jsonl", "--emit_scores",
                   "--max_new_tokens", "16", "--stream_end_score_sum_threshold", "3.0"])
        torch.cuda.synchronize()
        t_cmd = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        with open(f"{d}/out.jsonl") as f:
            lines = [json.loads(x) for x in f]
    keys = sorted(x.get("key") for x in lines)
    good = (keys == [f"c{j}" for j in range(4)]
            and all(set(x) == {"key", "responses", "debug_data"} and len(x["debug_data"]) == 8
                    and all(math.isfinite(r[k]) for r in x["debug_data"] for k in SCORE_KEYS)
                    for x in lines))
    if not good or counts.get("int8_matmul", 0) < L * 4 or not counts.get("decode_attention"):
        raise AssertionError(f"phase7c serve: {lines!r:.600}, launches {counts}")
    stats.launches(counts)
    for x in lines:
        short = {**x, "debug_data": f"{len(x['debug_data'])} frames"}
        print(f"phase7c {json.dumps(short)}", flush=True)
    print(f"phase7c serve --synthetic_weights --int8 --batch {SERVE_B}, 4 requests on cv2 clips "
          f"[{gpu}]: {t_cmd:.2f}s with the weights; {len(lines)} result lines, keys "
          f"{sorted(lines[0])}; launches {counts}", flush=True)


# -- phase 8: the serving options at 7B ------------------------------------------------------

LORA_R = 16


def spaced(rows) -> dict:
    """The prob rule at ``threshold(rows)`` with responses at least 8 frames
    apart: a few responses a run, where the rule alone fires on most frames
    once the first response has moved the scores."""
    return dict(stream_end_prob_threshold=threshold(rows), response_min_interval_frames=8)


def seeded_lora(cfg, seed: int) -> dict:
    """r 16 adapters on the seven decoder projections, built on the card: A as
    peft initialises it (``init_lora``: kaiming-uniform), B seeded normal x 0.01
    (not zero, so that the adapters act); scale alpha / r = 2."""
    import torch

    from aha_tpu_torch.config import LoraConfig
    from aha_tpu_torch.train.lora import init_lora

    lora = init_lora(cfg.llm, LoraConfig(r=LORA_R), seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen, device="cuda") * 0.01
    return lora


def infer_args(*flags):
    """``infer``'s parsed flags at the 7B preset, max_new_tokens 16 (the dataset
    flags are placeholders)."""
    from aha_tpu_torch.cli import _session

    p = argparse.ArgumentParser()
    _session._add_infer_flags(p)
    return p.parse_args(["--test_dataset", "youcook2", "--input_dir", ".", "--output_fname",
                         "unused", "--max_new_tokens", "16", *flags])


def pass_costs(engine, tok, frames) -> dict:
    """Per write pass of one token (8 passes, each with its host read), per
    frame chunk (49 rows, 4 chunks) and per fused pass of 4 frames (196 rows, 2
    passes), each run on a copy of one cache (query, system prompt and first
    frame written): (wall ms, device busy ms, aten ops), from
    ``profile_slice.Trace`` (a plain run for the wall, a traced one for the
    union of the kernels' intervals)."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.profile_slice import Trace

    rows = engine.encode_frames(frames)[None]
    cache = engine.new_cache()
    engine.append_ids(cache, [tok.apply_chat_template([{"role": "user", "content": QUERY}],
                                                      add_stream_query_prompt=False,
                                                      add_stream_prompt=True)])
    engine.append_text_frames(cache, [tok.apply_chat_template(
        [{"role": "system", "content": InferConfig().system_prompt}])], rows[:, 0])
    one = torch.ones((1,), dtype=torch.int32, device="cuda")
    emb = qwen2.embed_tokens(engine.params["llm"], torch.tensor([[100]], device="cuda"),
                             engine.dtype)

    def tokens():
        c = cache.clone()
        for _ in range(8):
            engine._logits(engine._decode(c, emb, one)[:, 0]).argmax(-1).cpu()

    def chunks():
        c = cache.clone()
        for t in range(1, 5):
            engine.append_frames(c, rows[:, t]).cpu()

    def fused():
        c = cache.clone()
        for t in (1, 5):
            engine.append_frames_fused(c, rows[:, t:t + 4]).cpu()

    out = {}
    for name, fn, n in (("token", tokens, 8), ("frame chunk", chunks, 4),
                        ("fused pass", fused, 2)):
        tr = Trace()
        tr.run(fn)
        out[name] = (tr.wall_ms / n, tr.busy_ms() / n, sum(tr.aten_ops().values()) / n)
    return out


def phase8(gpu: str, seed: int, stats: Stats):
    """The serving options at 7B: (c) --w8a8 from flags, (b) --lora_pretrained
    from flags, (a) r 16 adapters on 7B-int4 and on multi-stream serving at
    7B-int8, B 8, then the adapters' cost a pass (traced last)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg, tok = _model("7b")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randint(0, 256, (96, 384, 384, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)                     # phase 4's stream
    phase8c(gpu, stats, cfg, tok, frames)
    phase8b(gpu, seed, stats, cfg, tok, frames)
    phase8a(gpu, seed, stats, cfg, tok, frames)
    print(f"phase8 took {time.perf_counter() - t_phase:.1f}s", flush=True)


def phase8c(gpu: str, stats: Stats, cfg, tok, frames):
    """``infer --w8a8`` at 7B from its flags: JAX's random init quantised with
    the tower, the "fused_a8" backend, fused scoring of 8 frames."""
    import torch

    from aha_tpu_torch.cli import _session
    from aha_tpu_torch.models import aha
    from aha_tpu_torch.ops import kernels, quant

    L, Lv = cfg.llm.num_layers, cfg.vision.num_layers
    t0 = time.perf_counter()
    sess = _session._build_session(infer_args("--w8a8", "--stream_end_prob_threshold", "1.0"))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    e = sess.engine
    params = e.params
    int8 = lambda p: isinstance(p["kernel"], dict) and "qvalue" in p["kernel"]
    if not (e.backend == "fused_a8" and e.fused_frames == 8 and e.spec_max == 8
            and int8(params["vision"]["layers"]["fc1"]) and int8(params["llm"]["lm_head"])
            and int8(params["projector"]["fc1"])):
        raise AssertionError(f"phase8c: --w8a8 built backend {e.backend}, fused "
                             f"{e.fused_frames}, an int8 tower "
                             f"{int8(params['vision']['layers']['fc1'])}")
    del sess

    # the tower's ms a frame three ways, one vision batch of 32 frames: dense bf16 (the
    # int8 weights dequantised), weight-only int8 (--vision_int8), int8 activations
    def dense(node):
        if isinstance(node, dict):
            if "kernel" in node and isinstance(node["kernel"], dict):
                return {**node, "kernel": quant.dequantize(node["kernel"])}
            return {k: dense(v) for k, v in node.items()}
        return node

    ways = {"dense bf16": ({**params, "vision": dense(params["vision"])}, "fused"),
            "int8 weight-only (--vision_int8)": (params, "fused"),
            "int8 activations (--w8a8)": (params, "fused_a8")}
    tower_ms = {}
    for way, (tree, backend) in ways.items():
        run = lambda: aha.encode_vision_tokens(tree, cfg, frames[:32], torch.bfloat16, backend)
        feats = run()
        tower_ms[way] = cuda_ms(lambda i: run(), iters=3, warmup=1) / 32
        if way.startswith("dense"):
            ref = feats
        else:
            err = (feats.float() - ref.float()).abs().max().item()
            tower_ms[way + " max|diff| to dense"] = err
    del ways

    w8a8 = dict(fused_score_frames=8, spec_decode_tokens=4, spec_decode_tokens_max=8)
    with PassCounter() as pc:
        kernels.reset_launches()                       # the main path starts here
        rows, t_sv = score_64(params, cfg, tok, frames[:32], w8a8, backend="fused_a8")
        sess, turns, t_inf, _, dec_s, dec_tokens = run_inference(
            params, cfg, tok, frames[:32], spaced(rows), w8a8, backend="fused_a8",
            max_new_tokens=16)
        counts = dict(kernels.LAUNCHES)                # ... and ends here
        chunks, verifies = pc.chunks, pc.verifies
    responses = texts(turns)
    n = counts.get("int8_matmul_a8", 0)
    tower = 2 * 6 * Lv                                 # two vision batches, six products a layer
    if (n < tower + L * 4 * (chunks + verifies) or counts.get("int8_matmul", 0)
            or counts.get("quantize_rows", 0) < n or counts.get("decode_attention", 0) < L * chunks
            or len(rows) != 32 or len(sess.debug_data_list) != 32 or not responses
            or not all(math.isfinite(r[k]) for r in rows for k in SCORE_KEYS)):
        raise AssertionError(f"phase8c: launches {counts} over {chunks} chunks + {verifies} "
                             f"verify passes, {len(rows)} / {len(sess.debug_data_list)} "
                             f"frames, {len(responses)} responses")
    stats.launches(counts)
    _, turns1, *_ = run_inference(params, cfg, tok, frames[:32], spaced(rows),
                                  dict(w8a8, spec_decode_tokens=1), backend="fused_a8",
                                  max_new_tokens=16)
    if texts(turns1) != responses:
        raise AssertionError("phase8c: speculative texts differ from the width-1 texts:"
                             + _first_divergence(responses, texts(turns1)))
    print(f"phase8c infer --w8a8 from flags, 7B [{gpu}]: random init quantised with the tower "
          f"{t_build:.2f}s; backend {e.backend}, fused {e.fused_frames}, generation "
          f"{e.spec_tokens}->{e.spec_max}; the tower a frame (32-frame batch, 24 layers, CUDA "
          f"events): {json.dumps({k: round(v, 4) for k, v in tower_ms.items()})}; score_video "
          f"32 frames in 4 fused passes of 392 rows {t_sv:.3f}s = {32 / t_sv:.2f} frames/s; "
          f"inference() 32 frames {t_inf:.3f}s, {len(responses)} responses, decode "
          f"{dec_tokens} tokens in {dec_s:.3f}s; texts at 4->8 equal to width 1's; "
          f"{chunks} chunks + {verifies} verify passes; launches int8_matmul_a8={n} "
          f"(the tower's {tower}), quantize_rows={counts.get('quantize_rows', 0)}",
          flush=True)
    del params, sess, rows
    gc.collect()
    torch.cuda.empty_cache()


def phase8b(gpu: str, seed: int, stats: Stats, cfg, tok, frames):
    """``infer --synthetic_weights --int8 --lora_pretrained DIR`` at 7B, then
    the same with ``--int4``: a peft directory written on the card by the
    port's ``save_adapter`` (r 16 adapters, f32 projector, heads and lm_head),
    served over JAX's synthetic int8 and int4 trees: the overrides stay dense
    f32, so the tower's output, the frame embeddings and the frame chunks run
    in f32 (JAX's promotions), their quantised products on the wgmma kernels'
    three-plane path."""
    import os
    import tempfile

    import torch

    from aha_tpu_torch.models import loader

    H, Hv, V = cfg.llm.hidden_size, cfg.vision.hidden_size, cfg.llm.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda") * 0.02
    modules = {"projector": {"fc1": {"kernel": rand(Hv, H), "bias": rand(H)},
                             "fc2": {"kernel": rand(H, H), "bias": rand(H)}},
               "heads": {n: {"kernel": rand(H, c)} for n, c in
                         (("informative", 2), ("relevance", 1), ("uncertainty", 1))},
               "llm": {"lm_head": {"kernel": rand(H, V)}}}
    with tempfile.TemporaryDirectory() as d:        # the system's temporary directory
        t0 = time.perf_counter()
        loader.save_adapter(d, seeded_lora(cfg, seed + 1), 2.0, modules)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(d, "adapter_model.safetensors"))
        del modules
        print(f"phase8b peft directory of {size / 2**30:.2f} GiB written by save_adapter in "
              f"{t_write:.2f}s (r {LORA_R}, f32 projector / heads / lm_head)", flush=True)
        for trunk in ("int8", "int4"):
            phase8b_trunk(gpu, stats, cfg, tok, frames, d, trunk)


def phase8b_trunk(gpu: str, stats: Stats, cfg, tok, frames, peft: str, trunk: str):
    """One trunk of phase 8b: the session from the flags, score_video over 16
    frames at fused 4 and at fused 1, inference() with a response; launch
    counts by kernel and by path: every quantised product of an f32 pass on
    the wgmma kernel's f32 path (``<entry>/wgmma/f32``), none on the CUDA
    cores; every f32 frame chunk's cached attention (28 a chunk) on the f32
    tensor-core path against the bf16 cache (``decode_attention/wgmma/
    f32-bf16``), and every f32 fused pass's (``decode_attention_steps/wgmma/
    f32-bf16``, 28 a pass), none on the CUDA cores."""
    import torch

    from aha_tpu_torch.cli import _session
    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.streaming.session import build_session

    L = cfg.llm.num_layers
    entry = f"{trunk}_matmul"
    t0 = time.perf_counter()
    sess = _session._build_session(infer_args(
        "--synthetic_weights", f"--{trunk}", "--lora_pretrained", peft,
        "--stream_end_prob_threshold", "1.0"))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    e = sess.engine
    p = e.params
    if not (e.lora_scale == 2.0 and sorted(e.lora) == sorted(
            ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"))
            and all(ab["a"].shape[-1] == LORA_R and ab["a"].is_cuda for ab in e.lora.values())
            and p["llm"]["lm_head"]["kernel"].dtype == torch.float32
            and p["projector"]["fc1"]["kernel"].dtype == torch.float32
            and p["vision"]["layers"]["fc1"]["kernel"].dtype == torch.bfloat16
            and ("q4value" if trunk == "int4" else "qvalue")
            in p["llm"]["layers"]["qkv_proj"]["kernel"]):
        raise AssertionError(f"phase8b {trunk}: the session does not hold the adapter's parts")
    emb_dtype = e.encode_frames(frames[:1]).dtype
    if emb_dtype != torch.float32:
        raise AssertionError(f"phase8b {trunk}: frame embeddings in {emb_dtype}, not f32")
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    adapters = dict(lora=e.lora, lora_scale=e.lora_scale)
    sess1 = build_session(p, cfg, tok, InferConfig(
        grounding_mode=True, frame_fps=2.0, kv_cache_policy="sink", kv_window=2048,
        num_sink_tokens=32, fused_score_frames=1), **adapters)
    with PassCounter() as pc:
        kernels.reset_launches()                       # the main path starts here
        t0 = time.perf_counter()
        rows = sess.score_video(frames[:16], query=QUERY)
        torch.cuda.synchronize()
        t_sv = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows1 = sess1.score_video(frames[:16], query=QUERY)
        torch.cuda.synchronize()
        t_sv1 = time.perf_counter() - t0
        se = sorted((r["informative_score"] + r["relevance_score"] for r in rows), reverse=True)
        sess2, turns, t_inf, _, dec_s, dec_tokens = run_inference(
            p, cfg, tok, frames[:16], dict(stream_end_prob_threshold=se[3],
                                           response_min_interval_frames=8),
            product, max_new_tokens=16, **adapters)
        counts = dict(kernels.LAUNCHES)                # ... and ends here
        paths = dict(kernels.PATH_LAUNCHES)
        chunks, verifies, f32_passes = pc.chunks, pc.verifies, pc.f32
        f32_chunks = pc.f32_chunks
    responses = texts(turns)
    f32_wgmma = paths.get(f"{entry}/wgmma/f32", 0)
    att_f32 = paths.get("decode_attention/wgmma/f32-bf16", 0)
    # the f32 fused passes: their attention in one launch a layer, the same path
    steps_f32 = paths.get("decode_attention_steps/wgmma/f32-bf16", 0)
    if (counts.get(entry, 0) < L * 4 * (chunks + verifies)
            or steps_f32 < L * (f32_passes - f32_chunks)
            or counts.get("decode_attention", 0) < L * chunks or not responses
            or not f32_passes or f32_wgmma != L * 4 * f32_passes
            or paths.get(f"{entry}/cuda_cores/f32", 0)
            or not f32_chunks or att_f32 < L * f32_chunks
            or any(n for k, n in paths.items() if k.startswith(("decode_attention/cuda_cores/f32",
                                                                "decode_attention_steps/cuda_cores/f32")))
            or counts.get("split_bf16x3", 0) != f32_wgmma
            or len(rows) != 16 or len(rows1) != 16 or len(sess2.debug_data_list) != 16
            or not all(math.isfinite(r[k]) for r in rows + rows1 + sess2.debug_data_list
                       for k in SCORE_KEYS)):
        raise AssertionError(f"phase8b {trunk}: launches {counts}, by path {paths}, over "
                             f"{chunks} chunks + {verifies} verify passes ({f32_passes} in "
                             f"f32, {f32_chunks} of them chunks), {len(rows)} / {len(rows1)} "
                             f"frames, {len(responses)} responses")
    stats.launches(counts)
    print(f"phase8b infer --synthetic_weights --{trunk} --lora_pretrained DIR, 7B [{gpu}]: "
          f"session from the flags {t_build:.2f}s (r {LORA_R}, scale {e.lora_scale}, f32 "
          f"projector / heads / lm_head over the {trunk} trunk, frame embeddings {emb_dtype}); "
          f"score_video 16 frames at fused 4 {t_sv:.3f}s ({16 / t_sv:.2f} frames/s), at fused 1 "
          f"{t_sv1:.3f}s ({16 / t_sv1:.2f} frames/s); inference() 16 "
          f"frames {t_inf:.3f}s, {len(responses)} responses, first {responses[0][:40]!r}; "
          f"decode {dec_tokens} tokens in {dec_s:.3f}s; {chunks} chunks + {verifies} verify "
          f"passes, {f32_passes} of them in f32 ({f32_chunks} chunks: decode_attention "
          f"{att_f32} on the f32 tensor-core path against the bf16 cache; the fused passes: "
          f"decode_attention_steps {steps_f32} on it); launches by path "
          f"{paths}; launches {counts}", flush=True)
    del sess, sess1, sess2, p, e
    gc.collect()
    torch.cuda.empty_cache()


def phase8a(gpu: str, seed: int, stats: Stats, cfg, tok, frames):
    """r 16 adapters at 7B: 7B-int4 on phase 4a's weights and stream at the
    product widths and at generation width 1 (texts equal), the scores against
    the adapter-free run's; then at 7B-int8, B 8, on phase 7's weights: the
    lockstep scorer (stream 0 alone equal bit for bit to the full batch) and a
    short MultiStreamServer run; last, traced, the adapters' cost a pass."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.streaming.multi import MultiStreamScorer, MultiStreamServer
    from aha_tpu_torch.streaming.session import build_session

    L = cfg.llm.num_layers
    cache = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32)
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    params = random_params(cfg, mode="int4", seed=seed)          # phase 4a's weights
    ad = dict(lora=seeded_lora(cfg, seed), lora_scale=2.0)
    with PassCounter() as pc:
        kernels.reset_launches()                       # the main path starts here
        rows, t_sv = score_64(params, cfg, tok, frames[:32], product, **ad)
        sess, turns, t_inf, _, dec_s, dec_tokens = run_inference(
            params, cfg, tok, frames[:STREAM_FRAMES], spaced(rows), product, max_new_tokens=16, **ad)
        counts = dict(kernels.LAUNCHES)                # ... and ends here
        chunks, verifies = pc.chunks, pc.verifies
    responses = texts(turns)
    if (counts.get("int4_matmul", 0) < L * 4 * (chunks + verifies)
            or counts.get("decode_attention", 0) < L * chunks or not responses
            or len(sess.debug_data_list) != STREAM_FRAMES
            or not all(math.isfinite(r[k]) for r in rows + sess.debug_data_list
                       for k in SCORE_KEYS)):
        raise AssertionError(f"phase8a: launches {counts} over {chunks} chunks + {verifies} "
                             f"verify passes, {len(responses)} responses")
    stats.launches(counts)
    plain, t_plain = score_64(params, cfg, tok, frames[:32], product)
    moved = max(abs(a[k] - b[k]) for a, b in zip(rows, plain) for k in SCORE_KEYS)
    _, turns1, _, _, dec_s1, dec_tokens1 = run_inference(
        params, cfg, tok, frames[:STREAM_FRAMES], spaced(rows), dict(product, spec_decode_tokens=1),
        max_new_tokens=16, **ad)
    if texts(turns1) != responses or not moved > 1e-3:
        raise AssertionError(f"phase8a: scores moved by the adapters {moved:.3e}; texts at "
                             f"4->8 against width 1:"
                             + _first_divergence(responses, texts(turns1)))
    print(f"phase8a 7b-int4 with r {LORA_R} adapters at widths 4 / 4->8 [{gpu}]: score_video 32 "
          f"frames {t_sv:.3f}s (without adapters {t_plain:.3f}s), scores moved by the adapters "
          f"up to {moved:.3e}; inference() {STREAM_FRAMES} frames {t_inf:.3f}s, {len(responses)} responses, "
          f"decode {dec_tokens} tokens in {dec_s:.3f}s; at generation width 1 {dec_tokens1} "
          f"tokens in {dec_s1:.3f}s, texts equal; {chunks} chunks + {verifies} verify passes; "
          f"launches {counts}", flush=True)
    del sess, rows, plain

    # -- multi-stream serving with the adapters at 7B-int8, B 8 ---------------------------
    B = SERVE_B
    params8 = random_params(cfg, mode="int8", seed=seed)         # phase 7's weights
    # 32 frames a stream, as in 7b: stream 0 alone then fills one vision batch of 32, as
    # each of the full batch's does (a batch of 16 would take other product plans)
    videos = [frames[8 * b:8 * b + 32] for b in range(B)]
    scorer = MultiStreamScorer(params8, cfg, tok, InferConfig(grounding_mode=True, **cache,
                                                              **product), batch=B, **ad)
    with PassCounter() as pc:
        kernels.reset_launches()                       # the main path starts here
        t0 = time.perf_counter()
        full = scorer.score_videos(videos, [QUERY] * B, fps=2.0)
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)                # ... and ends here
    if (counts.get("int8_matmul", 0) < L * 4 * (pc.chunks + pc.verifies)
            or counts.get("decode_attention", 0) < L * pc.chunks):
        raise AssertionError(f"phase8a scorer: launches {counts}")
    stats.launches(counts)
    alone = scorer.score_videos([videos[0]] + [frames[:0]] * (B - 1),
                                [QUERY] + [None] * (B - 1), fps=2.0)
    if alone[0] != full[0] or [len(r) for r in full] != [32] * B:
        raise AssertionError("phase8a scorer: stream 0 alone differs from the full batch")
    del scorer
    se = sorted(r["informative_score"] + r["relevance_score"] for rows in full for r in rows)
    lengths = (16, 24, 32, 16, 24, 32, 16, 24)
    items = [(f"r{j}", frames[5 * j:5 * j + n], [{"role": "user", "content": QUERY, "time": 0}])
             for j, n in enumerate(lengths)]
    server = MultiStreamServer(params8, cfg, tok, InferConfig(
        **cache, **product, max_new_tokens=16, stream_end_prob_threshold=se[int(0.9 * len(se))]),
        batch=B, max_frames=max(lengths), **ad)
    with PassCounter() as pc:
        kernels.reset_launches()                       # the main path starts here
        t0 = time.perf_counter()
        res = server.run_items(items, fps=2.0)
        torch.cuda.synchronize()
        t_serve = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)                # ... and ends here
    n_resp = sum(t["role"] == "assistant" for r in res.values() for t in r["responses"])
    if ([len(res[k]["debug_data"]) for k, *_ in items] != list(lengths) or n_resp < 1
            or counts.get("int8_matmul", 0) < L * 4 * (pc.chunks + pc.verifies)
            or not all(math.isfinite(d[k]) for r in res.values() for d in r["debug_data"]
                       for k in SCORE_KEYS)):
        raise AssertionError(f"phase8a server: {n_resp} responses, launches {counts}")
    stats.launches(counts)
    lat = server.latency_stats()
    print(f"phase8a 7b-int8 B {B} with r {LORA_R} adapters [{gpu}]: MultiStreamScorer {B} x 32 "
          f"frames at fused 4 {t_full:.3f}s = {B * 32 / t_full:.2f} frames/s, stream 0 alone in "
          f"an otherwise empty batch equal bit for bit to the full batch; MultiStreamServer "
          f"{len(items)} requests, {sum(lengths)} frames {t_serve:.3f}s = "
          f"{sum(lengths) / t_serve:.2f} frames/s, {n_resp} responses, {lat.get('tokens', 0)} "
          f"tokens, latency_stats {lat}; {pc.chunks} chunks + {pc.verifies} verify passes; "
          f"launches {counts}", flush=True)
    del server, res, params8
    gc.collect()
    torch.cuda.empty_cache()

    # -- the adapters' cost a pass (7B-int4, spec 1, fused 4), traced last ------------------
    icfg = InferConfig(grounding_mode=True, **cache, fused_score_frames=4, spec_decode_tokens=1)
    costs = {name: pass_costs(build_session(params, cfg, tok, icfg, **kw).engine, tok,
                              frames[:32])
             for name, kw in (("with", ad), ("without", {}))}
    for unit in ("token", "frame chunk", "fused pass"):
        (w, b, a), (w0, b0, a0) = costs["with"][unit], costs["without"][unit]
        print(f"phase8a 7b-int4 {unit} with r {LORA_R} adapters [{gpu}]: wall {w:.3f} ms, "
              f"device busy {b:.3f} ms, {a:.0f} aten ops; without: wall {w0:.3f} ms, device "
              f"busy {b0:.3f} ms, {a0:.0f} aten ops; the adapters' cost: wall {w - w0:+.3f} ms, "
              f"device {b - b0:+.3f} ms, {a - a0:+.0f} aten ops", flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 9: the highlight chain at 7B-int8 ----------------------------------------------------


def write_chain_data(root: pathlib.Path) -> dict:
    """Phase 9's benchmark on disk: the CHAIN_CLIPS written with cv2 (30 fps,
    320 x 240: a gradient that drifts, a bright square crossing the frame,
    noise in a corner), TVSum's info TSV, an annotation TSV of 20 annotators
    a clip (1-5 per source frame, higher where the square is in the middle
    third), and the video metadata in CHAIN_CLIPS' order. Returns the paths."""
    import cv2
    import numpy as np

    videos = root / "videos"
    videos.mkdir()
    rng = np.random.default_rng(9)
    W, H, FPS = 320, 240, 30
    meta, anno = {}, []
    xs = np.arange(W)[None, :, None]
    for k, (name, (sec, cat, _)) in enumerate(CHAIN_CLIPS.items()):
        n = sec * FPS
        writer = cv2.VideoWriter(str(videos / f"{name}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                                 float(FPS), (W, H))
        mid = np.zeros(n, bool)
        for i in range(n):
            frame = np.broadcast_to(((xs + i + 50 * k) % 256).astype(np.uint8), (H, W, 3)).copy()
            x = (i * 3) % (W - 40)
            frame[100:140, x:x + 40] = (255, 255 - 60 * k, 40 * k)
            frame[:16, :16] = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            mid[i] = W / 3 <= x <= 2 * W / 3
            writer.write(frame)
        writer.release()
        meta[f"{name}.mp4"] = {"path": str(videos / f"{name}.mp4"), "valid": True,
                               "fps": float(FPS), "duration": float(sec)}
        for _ in range(20):
            scores = np.clip(rng.integers(1, 4, n) + 2 * mid, 1, 5)
            anno.append(f"{name}\t{cat}\t" + ",".join(map(str, scores)))
    info = root / "info.tsv"
    info.write_text("category\tvideo_id\ttitle\turl\tlength\n" + "".join(
        f"{cat}\t{name}\t{title}\thttp://example.com/{name}\t{sec // 60}:{sec % 60:02d}\n"
        for name, (sec, cat, title) in CHAIN_CLIPS.items()))
    (root / "anno.tsv").write_text("\n".join(anno) + "\n")
    (root / "meta.json").write_text(json.dumps(meta))
    return {"videos": videos, "info": info, "anno": root / "anno.tsv",
            "meta": root / "meta.json"}


def read_reel(path) -> int:
    """Frames cv2 reads back from a reel (0 where it does not open)."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.isOpened() and cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase9(gpu: str, stats: Stats):
    """The chain a user who measures the model runs, through
    ``aha_tpu_torch.cli.main`` in this process: ``infer --test_dataset tvsum
    --model_preset 7b --synthetic_weights --int8`` at the product defaults
    (fused 4, sink cache 2048 + 32) at 1 fps over three cv2 clips, then
    ``grid-search`` (the default grid of 15,000 combinations), ``evaluate
    --func tvsum`` and ``highlight --max_duration 10 --source_fps 30`` on one
    clip; the reel of the calibrated parameters and one of fixed positive
    parameters (alpha 1, beta 1, epsilon 0: ten frames selected) read back
    with cv2."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch

    from aha_tpu_torch.cli import infer as cli_infer
    from aha_tpu_torch.cli import main as cli_main
    from aha_tpu_torch.eval import highlight
    from aha_tpu_torch.ops import kernels

    L = 28
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        paths = write_chain_data(root)
        t_write = time.perf_counter() - t0
        pred, params = root / "pred.json", root / "params.json"
        metrics, reel = root / "metrics.json", root / "reel.mp4"

        # infer: the session's build timed apart (the weights are the stage's set-up)
        built = []
        build_session = cli_infer._build_session

        def timed_build(args):
            t = time.perf_counter()
            sess = build_session(args)
            torch.cuda.synchronize()
            built.append(time.perf_counter() - t)
            return sess

        cli_infer._build_session = timed_build
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            rc = cli_main(["infer", "--test_dataset", "tvsum", "--model_preset", "7b",
                           "--synthetic_weights", "--int8", "--input_dir", str(paths["videos"]),
                           "--caption_metadata_file", str(paths["info"]),
                           "--video_metadata_file", str(paths["meta"]),
                           "--output_fname", str(pred), "--frame_fps", "1",
                           "--seed", str(CHAIN_SEED)])
            torch.cuda.synchronize()
        finally:
            cli_infer._build_session = build_session
        t_infer = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)
        gc.collect()
        torch.cuda.empty_cache()
        preds = json.loads(pred.read_text())
        n_frames = sum(len(x["debug_data"]) for x in preds)
        keys = {"video_uuid", "model_response_list", "video_duration", "true_frames_list",
                "debug_data"}
        bad = [x["video_uuid"] for x in preds
               if set(x) != keys or len(x["true_frames_list"]) != len(x["debug_data"])
               or len(x["debug_data"]) != CHAIN_CLIPS[x["video_uuid"]][0]
               or x["model_response_list"]
               or not all(math.isfinite(r[k]) for r in x["debug_data"] for k in SCORE_KEYS)
               or not all(0 <= r["informative_score"] <= 1 and 0 <= r["relevance_score"] <= 1
                          and r["uncertainty_score"] > 0 for r in x["debug_data"])]
        if (rc != 0 or sorted(x["video_uuid"] for x in preds) != sorted(CHAIN_CLIPS) or bad
                or counts.get("int8_matmul", 0) < L * 4 or counts.get("decode_attention", 0) < L
                or counts.get("decode_attention_steps", 0) < L):
            raise AssertionError(f"phase9 infer: rc {rc}, videos "
                                 f"{[x['video_uuid'] for x in preds]}, bad {bad}, launches "
                                 f"{counts}")
        stats.launches(counts)
        print(f"phase9 infer --test_dataset tvsum --model_preset 7b --synthetic_weights --int8 "
              f"--frame_fps 1 --seed {CHAIN_SEED} [{gpu}]: {len(preds)} clips, {n_frames} frames "
              f"scored in {t_infer:.2f}s, of which the weights {built[0]:.2f}s: "
              f"{n_frames / (t_infer - built[0]):.2f} frames/s without the build; launches "
              f"int8_matmul={counts['int8_matmul']} decode_attention={counts['decode_attention']} "
              f"decode_attention_steps={counts['decode_attention_steps']}; clips written with "
              f"cv2 in {t_write:.2f}s", flush=True)

        # grid-search, evaluate, highlight: numpy on the host
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli_main(["grid-search", "--test_dataset", "tvsum", "--pred_file", str(pred),
                           "--gold_file", str(paths["anno"]), "--save_path", str(params),
                           "--seed", str(CHAIN_SEED)])
        t_grid = time.perf_counter() - t0
        best = json.loads(params.read_text())["tvsum"]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc |= cli_main(["evaluate", "--func", "tvsum", "--pred_file", str(pred),
                            "--gold_file", str(paths["anno"]), "--params_file", str(params),
                            "--output_file", str(metrics)])
        t_eval = time.perf_counter() - t0
        overall = json.loads(metrics.read_text())["overall"]
        unit = [best["best_score"], best["test_top5_map"], overall["mAP50"], overall["mAP15"],
                overall["top5_mAP"], overall["f1@15"]]
        corr = [overall["spearman"], overall["kendall"]]
        if (rc != 0 or not all(math.isfinite(v) and 0 <= v <= 1 for v in unit)
                or not all(math.isfinite(v) and -1 <= v <= 1 for v in corr)):
            raise AssertionError(f"phase9 grid-search / evaluate: rc {rc}, best {best}, "
                                 f"metrics {overall}")
        print(f"phase9 grid-search --test_dataset tvsum --seed {CHAIN_SEED}: {t_grid:.2f}s, "
              f"best {json.dumps(best)}; evaluate --func tvsum: {t_eval:.2f}s, overall "
              f"{json.dumps(overall)}", flush=True)

        clip = "clip_c"
        entry = next(x for x in preds if x["video_uuid"] == clip)
        fixed = root / "fixed.json"
        fixed.write_text(json.dumps({"tvsum": {"alpha": 1.0, "beta": 1.0, "epsilon": 0.0,
                                               "uncertainty_threshold": 0.1}}))
        for label, pfile, out_reel in (("calibrated", params, reel),
                                       ("alpha 1, beta 1, epsilon 0", fixed,
                                        root / "fixed.mp4")):
            printed = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                rc = cli_main(["highlight", "--pred_file", str(pred), "--video_uuid", clip,
                               "--video_path", str(paths["videos"] / f"{clip}.mp4"),
                               "--output_filepath", str(out_reel), "--max_duration", "10",
                               "--params_file", str(pfile), "--source_fps", "30"])
            t_hl = time.perf_counter() - t0
            res = json.loads(printed.getvalue())
            a, b, e = highlight.load_calibrated_params(str(pfile))
            indices = highlight.generate_highlight(
                entry["debug_data"], entry["true_frames_list"], 10, alpha=a, beta=b, epsilon=e,
                source_fps=30.0)["highlight_indices"]
            read = read_reel(out_reel) if res["frames_written"] else 0
            if (rc != 0 or res["frames_written"] != len(indices) or read != len(indices)
                    or (pfile == fixed and len(res["selected"]) != 10)):
                raise AssertionError(f"phase9 highlight ({label}): rc {rc}, {res}, "
                                     f"{len(indices)} highlight indices, {read} frames read "
                                     f"back")
            print(f"phase9 highlight {clip} --max_duration 10 --source_fps 30 ({label}): "
                  f"{t_hl:.2f}s, {len(res['selected'])} frames selected, "
                  f"{res['frames_written']} source frames written, the reel read back with "
                  f"cv2: {read} frames", flush=True)
    print(f"phase9 the chain [{gpu}]: infer {t_infer:.2f}s (weights {built[0]:.2f}s), "
          f"grid-search {t_grid:.2f}s, evaluate {t_eval:.2f}s; phase 9 took "
          f"{time.perf_counter() - t_phase:.1f}s", flush=True)



# -- phase 10: the live-video datasets, demo, the interactive API, the judge, the towers ------

LIVE_TICKS = ROOT / "configs" / "tick_tables" / "demo_ticks.json"
LIVE_CLIP_S = 120          # 10a: hubble_space on a cv2 clip of 120 s (30 fps, 320 x 240) at 1 fps
LIVE_FOLDER_N = 60         # 10a: arl_scout on a folder of 60 frames, read from --start_sec 10
LIVE_START = 10
# 10b: demo's 60 s clip, (seconds, moving): a moving stretch shows another picture every
# second, a static one the same picture throughout
DEMO_SEGMENTS = ((10, True), (15, False), (10, True), (15, False), (10, True))
DEMO_SKIP = 0.02
INTERACTIVE_FRAMES = 32    # 10c
JUDGE_WINDOW = 4096        # 10d: LocalJudge's cache (kind "none"), f32
TOWER_FRAMES = 32          # 10e


def live_query_rows() -> dict:
    """The rows of the query chunks of phase 10's scoring passes (score_video
    appends the query as one chunk before the system prompt; 10c's
    encode_given_query after a reset gives the same ids): the live datasets'
    default queries and the demo's."""
    from aha_tpu_torch.cli.infer import DEFAULT_QUERIES

    _, tok = _model("7b")
    queries = {**{k: DEFAULT_QUERIES[k] for k in ("hubble_space", "arl_scout")}, "demo": QUERY}
    return {k: len(tok.apply_chat_template([{"role": "user", "content": q}],
                                           add_stream_query_prompt=False,
                                           add_stream_prompt=True))
            for k, q in queries.items()}


def demo_picture(second: int, W: int = 320, H: int = 240):
    """The BGR picture the demo clip shows during ``second``: in a moving stretch
    a gradient shifted 37 levels a second and a square that moves, in a static
    stretch a flat grey of its own."""
    import numpy as np

    start, static_index = 0, 0
    for sec, moving in DEMO_SEGMENTS:
        if second < start + sec:
            break
        start += sec
        static_index += not moving
    if not moving:
        return np.full((H, W, 3), 128 - 60 * static_index, np.uint8)
    xs = np.arange(W)[None, :, None]
    frame = np.broadcast_to(((xs + 37 * second) % 256).astype(np.uint8), (H, W, 3)).copy()
    x = (29 * second) % (W - 60)
    frame[90:150, x:x + 60] = (255, 255, 255)
    return frame


def demo_kept() -> int:
    """The frames demo's motion skip keeps at 1 fps: media.motion_mask over the
    clip's pictures, letterboxed as decode_video hands them over."""
    import numpy as np

    from aha_tpu_torch.data import media

    n = sum(s for s, _ in DEMO_SEGMENTS)
    frames = np.stack([media.resize_and_pad_frame(demo_picture(s), 384)[..., ::-1]
                       for s in range(n)])
    return int(media.motion_mask(frames, DEMO_SKIP).sum())


def live_projector_rows() -> set:
    """The projector rows of phase 10's last vision batches (32 frames a batch,
    49 rows a frame): the hubble clip, the arl folder from its start, the demo's
    kept frames."""
    frames = (LIVE_CLIP_S, LIVE_FOLDER_N - LIVE_START, demo_kept())
    return {49 * (n % 32) for n in frames} - {0}


def judge_examples():
    """10d's predictions and gold: three questions, three gold answers with
    their spans and three responses each."""
    answers = ["A person is cooking rice in a small pan.", "A dog runs across the garden.",
               "The chef chops onions, then fries them until golden."]
    preds, golds = [], []
    for q in range(3):
        question = f"What is happening in part {q + 1} of the video?"
        golds.append({"question_id": q, "conversation": [{"role": "user", "content": question}],
                      "answer": [{"content": answers[(q + g) % 3], "time": [4 * g, 4 * g + 3]}
                                 for g in range(3)]})
        preds.append({"question_id": q, "debug_data": [], "model_response_list": [
            {"role": "user", "content": question, "time": 0}] + [
            {"role": "assistant", "content": answers[(2 * q + i) % 3], "time": 4 * i + 1}
            for i in range(3)]})
    return preds, golds


def write_judge_tokenizer(d: pathlib.Path) -> None:
    """A byte-level BPE tokenizer trained here on the rubric (tokenizers and
    transformers), saved in ``d`` as a Hugging Face checkpoint keeps it: the
    tokenizer of 10d's judge directory."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    from aha_tpu_torch.eval import llm_judge
    from aha_tpu_torch.tokenization import BOS, EOS

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    corpus = [llm_judge.RUBRIC_SYSTEM] + [u for u, _ in llm_judge.RUBRIC_SHOTS] * 5
    tok.train_from_iterator(corpus, trainers.BpeTrainer(
        vocab_size=2000, special_tokens=[BOS, EOS, "<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    PreTrainedTokenizerFast(tokenizer_object=tok, bos_token=BOS, eos_token=EOS,
                            pad_token="<|endoftext|>").save_pretrained(str(d))


def judge_rows(tok=None) -> tuple:
    """(the rubric prefix's rows, each judgement's rows in 10d's order) under
    ``tok`` (default: the char tokenizer at Qwen2-7B's vocabulary): the judged
    pairs replayed with an evaluator that only records them."""
    from aha_tpu_torch.eval import llm_judge
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    tok = tok or build_stream_tokenizer(None, vocab_size=152064)
    judged = []

    class Record:
        def evaluate(self, question, gold, pred):
            content = f"Question: {question}\nGround Truth Answer: {gold}\nPredicted Answer: {pred}"
            judged.append(len(tok.apply_chat_template([{"role": "user", "content": content}],
                                                      add_generation_prompt=True)))
            return 1

    llm_judge.magqa_score_matrices(*judge_examples(), Record())
    return len(tok.apply_chat_template(llm_judge.rubric_conversation())), tuple(judged)


def tower_configs() -> dict:
    """10e's two towers at 7B: SigLIP with its MAP probe (frame_token_cls: 50
    tokens a frame) and CLIP-L/14-336 with its CLS token."""
    from aha_tpu_torch.config import aha_7b, clip_large_336

    return {"siglip-cls": aha_7b().replace(frame_token_cls=True),
            "clip-l-336": aha_7b().replace(vision=clip_large_336(), frame_resolution=336,
                                           frame_token_cls=True)}


def write_live_data(root: pathlib.Path) -> dict:
    """Phase 10's inputs on disk: 10a's clip (a drifting gradient, a square
    crossing it, noise in a corner) and frame folder (PNG), 10b's demo clip
    (DEMO_SEGMENTS), all 320 x 240 at 30 fps written with cv2."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(10)
    W, H, FPS = 320, 240, 30
    xs = np.arange(W)[None, :, None]

    def picture(i):
        frame = np.broadcast_to(((xs + i) % 256).astype(np.uint8), (H, W, 3)).copy()
        x = (i * 3) % (W - 40)
        frame[100:140, x:x + 40] = (255, 200, 40)
        frame[:16, :16] = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        return frame

    out = {"clip": root / "hubble.mp4", "folder": root / "arl_frames",
           "demo": root / "demo.mp4"}
    writer = cv2.VideoWriter(str(out["clip"]), cv2.VideoWriter_fourcc(*"mp4v"), float(FPS),
                             (W, H))
    for i in range(LIVE_CLIP_S * FPS):
        writer.write(picture(i))
    writer.release()
    out["folder"].mkdir()
    for i in range(LIVE_FOLDER_N):
        cv2.imwrite(str(out["folder"] / f"{i:05d}.png"), picture(97 * i))
    writer = cv2.VideoWriter(str(out["demo"]), cv2.VideoWriter_fourcc(*"mp4v"), float(FPS),
                             (W, H))
    for i in range(sum(s for s, _ in DEMO_SEGMENTS) * FPS):
        writer.write(demo_picture(i // FPS))
    writer.release()
    return out


def _module_ok(name: str) -> str | None:
    """The module's version where it imports on this host, else None."""
    import importlib

    try:
        return getattr(importlib.import_module(name), "__version__", "?")
    except ImportError:
        return None


def _captured(fn, *a):
    """fn(*a) with its standard output captured: (return value, printed lines)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ret = fn(*a)
    return ret, out.getvalue().splitlines()


def phase10(gpu: str, seed: int, stats: Stats):
    """The rest of the command line and the other towers at 7B: (a) `infer` of the
    live-video datasets, (c) the interactive API on (a)'s session, (b) `demo`,
    (d) the judge, (e) the SigLIP probe and CLIP towers."""
    import tempfile

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    mods = {m: _module_ok(m) for m in ("matplotlib", "transformers", "tokenizers", "h5py")}
    print(f"phase10 packages on this host: {json.dumps(mods)}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        paths = write_live_data(root)
        print(f"phase10 clips written with cv2 in {time.perf_counter() - t0:.2f}s", flush=True)
        sess = phase10a(gpu, stats, root, paths, have_plot=mods["matplotlib"] is not None)
        phase10c(gpu, stats, sess)
        del sess
        gc.collect()
        torch.cuda.empty_cache()
        phase10b(gpu, stats, root, paths, have_plot=mods["matplotlib"] is not None)
    phase10d(gpu, stats, have_hf=mods["transformers"] is not None and mods["tokenizers"] is not None)
    phase10e(gpu, seed, stats)
    print(f"phase10 took {time.perf_counter() - t_phase:.1f}s", flush=True)


def phase10a(gpu: str, stats: Stats, root, paths, have_plot: bool):
    """`infer --test_dataset hubble_space --model_preset 7b --int8 --synthetic_weights` at
    the product defaults (fused 4, sink cache 2048 + 32) at 1 fps on a cv2 clip with the
    tick table, then `--test_dataset arl_scout` on a frame folder from --start_sec 10.
    Returns the first run's session (for 10c). Without matplotlib on the host the
    command's plot cannot be drawn: the same session then runs the command's branch
    (cli.infer._infer_live) with the result written where matplotlib is not asked for."""
    import torch

    from aha_tpu_torch.cli import infer as cli_infer
    from aha_tpu_torch.cli import main as cli_main
    from aha_tpu_torch.drivers import live_video
    from aha_tpu_torch.ops import kernels

    L = 28
    built, sessions = [], []
    build_session = cli_infer._build_session

    def timed_build(args):
        t = time.perf_counter()
        s = build_session(args)
        torch.cuda.synchronize()
        built.append(time.perf_counter() - t)
        sessions.append(s)
        return s

    plot = live_video.plot_scores
    runs = (("hubble_space", paths["clip"], LIVE_CLIP_S, []),
            ("arl_scout", paths["folder"], LIVE_FOLDER_N - LIVE_START,
             ["--start_sec", str(LIVE_START)]))
    out = {}
    cli_infer._build_session = timed_build
    if not have_plot:
        live_video.plot_scores = lambda *a, **k: None
    try:
        for name, src, n_frames, extra in runs:
            (root / name).mkdir()
            fname = root / name / "live.json"
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launches()                  # the main path starts here
            t0 = time.perf_counter()
            rc, lines = _captured(cli_main, [
                "infer", "--test_dataset", name, "--model_preset", "7b", "--int8",
                "--synthetic_weights", "--input_dir", str(src), "--output_fname", str(fname),
                "--frame_fps", "1", "--tick_table", str(LIVE_TICKS), *extra])
            torch.cuda.synchronize()
            t_all = time.perf_counter() - t0
            counts = dict(kernels.LAUNCHES)           # ... and ends here
            peak = torch.cuda.max_memory_allocated() / 1024**3
            res = json.loads(lines[-1])
            full = json.loads(fname.read_text())
            want = {"ticks", "gt_ticks", "gt_spans", "fps", "query", "frames_scored",
                    "telemetry"}
            if (rc != 0 or set(res) != want or res["frames_scored"] != n_frames
                    or len(full["debug_data"]) != n_frames or not res["gt_ticks"]
                    or set(res["telemetry"]) != {"peak_hbm_gb", "peak_ram_gb", "samples"}
                    or not all(math.isfinite(d[k]) for d in full["debug_data"]
                               for k in SCORE_KEYS)
                    or counts.get("int8_matmul", 0) < L * 4 * (n_frames // 4)
                    or counts.get("decode_attention", 0) < 2 * L
                    or (have_plot and not (root / name / "live_scores.png").exists())):
                raise AssertionError(f"phase10a {name}: rc {rc}, {res}, "
                                     f"{len(full['debug_data'])} frames, launches {counts}")
            stats.launches(counts)
            out[name] = res
            print(f"phase10a infer --test_dataset {name} --model_preset 7b --int8 "
                  f"--synthetic_weights --frame_fps 1 {' '.join(extra)} [{gpu}]: "
                  f"{n_frames} frames in {t_all:.2f}s, of which the weights "
                  f"{built[-1]:.2f}s: {n_frames / (t_all - built[-1]):.2f} frames/s without "
                  f"the build (cv2 decode included); telemetry.peak_hbm_gb "
                  f"{res['telemetry']['peak_hbm_gb']} against torch.cuda.max_memory_allocated "
                  f"{peak:.3f} GiB ({res['telemetry']['samples']} samples); ticks "
                  f"{res['ticks']}, {len(res['gt_ticks'])} ground-truth ticks; launches "
                  f"int8_matmul={counts.get('int8_matmul', 0)} decode_attention="
                  f"{counts.get('decode_attention', 0)}"
                  + ("" if have_plot else "; no matplotlib here: the plot not drawn"),
                  flush=True)
    finally:
        cli_infer._build_session = build_session
        live_video.plot_scores = plot
    del sessions[1:]
    return sessions[0]


def phase10c(gpu: str, stats: Stats, sess):
    """The interactive API on 10a's session: encode_given_query, then
    input_one_frame a frame at a time, against the session's stepwise loop at fused
    1 over the same frames and query (the same passes and plans): the scores equal
    bit for bit."""
    import torch

    from aha_tpu_torch.cli.infer import DEFAULT_QUERIES
    from aha_tpu_torch.ops import kernels

    L = 28
    n = INTERACTIVE_FRAMES
    gen = torch.Generator(device="cuda").manual_seed(10)
    frames = torch.randint(0, 256, (n, 240, 320, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    query = DEFAULT_QUERIES["hubble_space"]
    sess.reset()
    sess.set_fps(fps=1.0)
    kernels.reset_launches()                          # the main path starts here
    t0 = time.perf_counter()
    sess.input_video_stream(frames)
    sess.encode_given_query(query)
    rows = [sess.input_one_frame() for _ in range(n)]
    torch.cuda.synchronize()
    t_api = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)                   # ... and ends here
    stats.launches(counts)
    sess.reset()
    sess.set_fps(fps=1.0)
    sess.input_video_stream(frames)
    sess.input_query_stream([{"role": "user", "content": query, "time": 0}])
    sess.inference(chunked=False)
    step = [[d[k] for k in SCORE_KEYS] for d in sess.debug_data_list]
    got = [[r[k] for k in SCORE_KEYS] for r in rows]
    if (got != step or any(r["response"] is not None for r in rows)
            or counts.get("decode_attention", 0) != L * (n + 1)
            or counts.get("int8_matmul", 0) < L * 4 * (n + 1)):
        raise AssertionError(f"phase10c: interactive scores differ from the stepwise loop's "
                             f"({sum(a != b for a, b in zip(got, step))} of {n} frames), "
                             f"launches {counts}")
    print(f"phase10c encode_given_query + {n} x input_one_frame on 10a's session [{gpu}]: "
          f"{t_api:.2f}s = {n / t_api:.2f} frames/s (a pass and a host read a frame; vision "
          f"included); every score equal bit for bit to the stepwise inference() at fused 1 "
          f"over the same frames and query; launches int8_matmul="
          f"{counts.get('int8_matmul', 0)} decode_attention={counts.get('decode_attention', 0)}",
          flush=True)


def phase10b(gpu: str, stats: Stats, root, paths, have_plot: bool):
    """`demo` at 7B-int8 through its argv (JAX's seed-0 init, --int8) with the
    tick table, --render_video and --motion_skip_threshold 0.02 on the 60 s clip of
    DEMO_SEGMENTS: frames scored against frames decoded, the stitched MP4 read back
    with cv2 (one frame a decoded frame). Without matplotlib on the host, the same
    device path without the plot: the command's session from its flags,
    infer_on_live_video with no output directory, then render_demo_video."""
    import numpy as np
    import torch

    from aha_tpu_torch.cli import infer as cli_infer
    from aha_tpu_torch.cli import main as cli_main
    from aha_tpu_torch.data import media
    from aha_tpu_torch.drivers import live_video
    from aha_tpu_torch.ops import kernels

    out_dir = root / "demo"
    argv = ["--video", str(paths["demo"]), "--query", QUERY, "--output_dir", str(out_dir),
            "--tick_table", str(LIVE_TICKS), "--tick_name", "arl_scout", "--render_video",
            "--model_preset", "7b", "--int8", "--motion_skip_threshold", str(DEMO_SKIP)]
    built = []
    build_session = cli_infer._build_session

    def timed_build(args):
        t = time.perf_counter()
        s = build_session(args)
        torch.cuda.synchronize()
        built.append((time.perf_counter() - t, torch.cuda.max_memory_allocated() / 1024**3))
        torch.cuda.reset_peak_memory_stats()
        return s

    n_decoded = sum(s for s, _ in DEMO_SEGMENTS)
    kept = demo_kept()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()                          # the main path starts here
    t0 = time.perf_counter()
    cli_infer._build_session = timed_build
    try:
        if have_plot:
            rc, lines = _captured(cli_main, ["demo", *argv])
            res = json.loads(lines[-2])
            done = lines[-1]
        else:
            print("phase10b matplotlib does not import on this host: demo's device path "
                  "without the plot (infer_on_live_video with no output directory, then "
                  "render_demo_video)", flush=True)
            args = cli_infer.demo_args(argv)
            sess = cli_infer._build_session(args)
            frames, _ = media.decode_video(args.video, output_fps=args.frame_fps,
                                           output_size=sess.args.frame_resolution)
            res = live_video.infer_on_live_video(
                sess, frames, args.query, args.frame_fps, output_dir=None,
                gt_ticks=live_video.load_tick_table(args.tick_table, args.tick_name),
                monitor=cli_infer._monitor(sess), motion_skip_threshold=DEMO_SKIP)
            out_dir.mkdir()
            scores = np.asarray([d["relevance_score"] for d in res["debug_data"]])
            live_video.render_demo_video(frames, scores, args.frame_fps,
                                         f"{out_dir}/demo_stitched.mp4", ticks=res["ticks"])
            rc, done = 0, f"stitched demo video: {out_dir}/demo_stitched.mp4"
            del sess
        torch.cuda.synchronize()
    finally:
        cli_infer._build_session = build_session
    t_all = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)                   # ... and ends here
    peak_stream = torch.cuda.max_memory_allocated() / 1024**3
    stitched = out_dir / "demo_stitched.mp4"
    read = read_reel(stitched)
    if (rc != 0 or res["frames_scored"] != kept or read != n_decoded or not res["gt_spans"]
            or done != f"stitched demo video: {stitched}"
            or counts.get("int8_matmul", 0) < 28 * 4 * (kept // 4)
            or (have_plot and not (out_dir / "live_scores.png").exists())):
        raise AssertionError(f"phase10b demo: rc {rc}, {res.get('frames_scored')} frames "
                             f"scored (expected {kept}), {read} read back of {n_decoded}, "
                             f"launches {counts}")
    stats.launches(counts)
    t_build, peak_build = built[0]
    print(f"phase10b demo --model_preset 7b --int8 --render_video --motion_skip_threshold "
          f"{DEMO_SKIP} on a {n_decoded} s clip [{gpu}]: frames_scored {res['frames_scored']} of "
          f"{n_decoded} decoded; the stitched MP4 read back with cv2: {read} frames; "
          f"{t_all:.2f}s in all, the build (JAX's seed-0 init, quantised) {t_build:.2f}s with "
          f"peak {peak_build:.2f} GiB, the stream's peak {peak_stream:.2f} GiB; ticks "
          f"{res['ticks']}; launches int8_matmul={counts.get('int8_matmul', 0)} "
          f"decode_attention={counts.get('decode_attention', 0)}", flush=True)


def phase10d(gpu: str, stats: Stats, have_hf: bool):
    """The judge at Qwen2-7B width: JAX's synthetic dense bf16 7B decoder under
    LocalJudge's bare-decoder branch and f32 config (JAX's promotions: bf16
    products over the bf16 tree, an f32 cache read by the cached attention's f32
    path), a cache of JUDGE_WINDOW slots (kind "none"), the char tokenizer;
    magqa_score_matrices and analyze_magqa over judge_examples(). Each judgement leaves the prefix cache as it was (its
    metadata and its prefix's keys and values checked after every call); the
    metadata's save and restore timed against a clone of the whole cache."""
    import torch

    from aha_tpu_torch.config import aha_7b
    from aha_tpu_torch.eval import llm_judge
    from aha_tpu_torch.models import loader
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    L = 28
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree = loader.materialize_random_params(aha_7b(), None)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    llm = tree["llm"]
    tok = build_stream_tokenizer(None, vocab_size=152064)
    prefix_rows, prompt_rows = judge_rows()
    kernels.reset_launches()                          # the main path starts here
    t0 = time.perf_counter()
    judge = llm_judge.LocalJudge(llm, aha_7b().llm, tok, window=JUDGE_WINDOW)
    torch.cuda.synchronize()
    t_prefix = time.perf_counter() - t0
    c = judge.prefix_cache
    n = int(c.length[0])
    meta = [t.clone() for t in (c.key_pos, c.order, c.seen, c.length)]
    prefix_kv = (c.k[:, :, :n].clone(), c.v[:, :, :n].clone())
    times, changed = [], 0

    class Checked:
        """The judge, with the prefix cache checked after each judgement."""

        def evaluate(self, question, gold, pred):
            nonlocal changed
            torch.cuda.synchronize()
            t = time.perf_counter()
            score = judge.evaluate(question, gold, pred)
            times.append(time.perf_counter() - t)
            same = (all(torch.equal(a, b) for a, b in zip(
                meta, (c.key_pos, c.order, c.seen, c.length)))
                and torch.equal(prefix_kv[0], c.k[:, :, :n]) and torch.equal(prefix_kv[1],
                                                                              c.v[:, :, :n]))
            changed += not same
            return score

    preds, golds = judge_examples()
    scored = llm_judge.magqa_score_matrices(preds, golds, Checked())
    result = llm_judge.analyze_magqa(scored, num_examples=len(scored))
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)                   # ... and ends here
    att_paths = {k: v for k, v in kernels.PATH_LAUNCHES.items() if k.startswith("decode_att")}
    stats.launches(counts)
    f32_launches = counts.get("decode_attention", 0)
    want = L * (1 + sum(1 + 7 for _ in prompt_rows))  # prefix, each prompt and up to 7 tokens
    # the prefix and each prompt on the f32 tensor cores, against the f32 cache
    tc_want = L * (1 + len(prompt_rows))
    if (changed or n != prefix_rows or len(times) != len(prompt_rows)
            or c.k.dtype != torch.float32 or not f32_launches or f32_launches > want
            or att_paths.get("decode_attention/wgmma/f32-f32", 0) < tc_want
            or not all(1 <= s <= 5 for ex in scored for row in ex["evaluator_output"]
                       for s in row)):
        raise AssertionError(f"phase10d: prefix {n} rows (expected {prefix_rows}), "
                             f"{len(times)} judgements of {len(prompt_rows)}, {changed} left "
                             f"the prefix cache changed, launches {counts}, attention by "
                             f"path {att_paths}")
    restore = cuda_ms(lambda i: [t.clone() for t in (c.key_pos, c.order, c.seen, c.length)],
                      iters=10)
    whole = cuda_ms(lambda i: c.clone(), iters=3, warmup=1)
    cache_gb = sum(t.numel() * t.element_size() for t in (c.k, c.v)) / 1e9
    print(f"phase10d LocalJudge at Qwen2-7B width (JAX's synthetic dense bf16 decoder, f32 "
          f"config: bf16 products, an f32 cache of {JUDGE_WINDOW} slots, kind none; char "
          f"tokenizer) [{gpu}]: the decoder "
          f"{t_build:.2f}s; the rubric prefix {n} rows in {t_prefix:.2f}s; {len(times)} "
          f"judgements of {min(prompt_rows)}-{max(prompt_rows)} rows: "
          f"{1e3 * statistics.median(times):.1f} ms a judgement (median; min "
          f"{1e3 * min(times):.1f}, max {1e3 * max(times):.1f}); the prefix cache (metadata "
          f"and its {n} slots' keys and values) unchanged after every call; its metadata "
          f"saved and restored {restore:.4f} ms against {whole:.3f} ms for a clone of the "
          f"whole {cache_gb:.2f} GB cache; analyze_magqa {json.dumps(result)}; launches "
          f"decode_attention (f32) {f32_launches}, by path {att_paths}", flush=True)
    del judge, llm, c, prefix_kv
    gc.collect()
    torch.cuda.empty_cache()
    if not have_hf:
        print("phase10d transformers / tokenizers do not import on this host: `evaluate --func "
              "magqa --judge_ckpt DIR` (a Hugging Face tokenizer in DIR) is held by the CPU "
              "test alone (tests/test_torch_judge_cli.py)", flush=True)
        return
    phase10d_command(gpu, stats, tree)


def phase10d_command(gpu: str, stats: Stats, tree: dict):
    """`evaluate --func magqa --judge_ckpt DIR` at 7B where the host has
    transformers: DIR holds ``tree``'s decoder (JAX's synthetic dense bf16 7B)
    in the reference's key layout (safetensors shards) and a byte-level BPE
    tokenizer trained here; the output lines and the analysis checked for
    form."""
    import tempfile

    import torch

    from aha_tpu_torch.cli import main as cli_main
    from aha_tpu_torch.config import aha_7b
    from aha_tpu_torch.models import loader
    from aha_tpu_torch.ops import kernels

    cfg = aha_7b()
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        write_judge_tokenizer(d)
        t0 = time.perf_counter()
        sd = {k: v for k, v in loader.export_hf_state_dict(tree, cfg).items()
              if k.startswith(("model.layers.", "model.embed_tokens.", "model.norm.",
                               "lm_head."))}
        loader.save_sharded(sd, str(d))
        (d / "config.json").write_text(json.dumps({"vocab_size": cfg.llm.vocab_size}))
        nbytes = sum(t.numel() * t.element_size() for t in sd.values())
        tree.clear()
        del sd
        gc.collect()
        torch.cuda.empty_cache()
        t_write = time.perf_counter() - t0
        preds, golds = judge_examples()
        (d / "pred.jsonl").write_text("".join(json.dumps(p) + "\n" for p in preds))
        (d / "gold.json").write_text(json.dumps(golds))
        kernels.reset_launches()                      # the main path starts here
        t0 = time.perf_counter()
        rc, lines = _captured(cli_main, [
            "evaluate", "--func", "magqa", "--pred_file", str(d / "pred.jsonl"), "--gold_file",
            str(d / "gold.json"), "--judge_ckpt", str(d), "--output_file",
            str(d / "scored.jsonl")])
        torch.cuda.synchronize()
        t_cmd = time.perf_counter() - t0
        counts = dict(kernels.LAUNCHES)               # ... and ends here
        stats.launches(counts)
        analysis = json.loads("\n".join(lines))
        scored = [json.loads(x) for x in (d / "scored.jsonl").read_text().splitlines()]
        if rc != 0 or len(scored) != 3 or set(analysis) != {"in_span_score", "max_score",
                                                            "turns", "turns_dedup", "n"}:
            raise AssertionError(f"phase10d command: rc {rc}, {analysis}, {len(scored)} lines")
    print(f"phase10d evaluate --func magqa --judge_ckpt DIR at 7B [{gpu}]: the decoder's "
          f"{nbytes / 1e9:.2f} GB and a BPE tokenizer trained here written in {t_write:.2f}s; "
          f"the command (read, convert on the card, judge) {t_cmd:.2f}s; {json.dumps(analysis)}; launches "
          f"decode_attention {counts.get('decode_attention', 0)}", flush=True)


def phase10e(gpu: str, seed: int, stats: Stats):
    """The towers at 7B-int8, each from JAX's synthetic tree (int8 decoder,
    dense tower): SigLIP with its MAP probe and CLIP-L/14-336 with its CLS token.
    score_video over TOWER_FRAMES frames at fused 4 and fused 1, with the dense
    tower and with the tower quantised as --vision_int8 quantises a loaded tree;
    the tower's ms a frame both ways; fused against fused 1 within the 7B
    fixture's atol 2e-2 + rtol 5e-2."""
    import torch

    from aha_tpu_torch.config import InferConfig
    from aha_tpu_torch.models import aha, loader
    from aha_tpu_torch.ops import kernels, quant
    from aha_tpu_torch.streaming.session import build_session
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    L = 28
    for name, cfg in tower_configs().items():
        gc.collect()
        torch.cuda.empty_cache()
        tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                     vocab_size=cfg.llm.vocab_size)
        cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
        t0 = time.perf_counter()
        params = loader.materialize_random_params(cfg, "int8")
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        q_vision = quant.quantize_params({"vision": params["vision"]},
                                         quantize_vision=True)["vision"]
        trees = {"dense tower": params, "--vision_int8": {**params, "vision": q_vision}}
        gen = torch.Generator(device="cuda").manual_seed(seed + 10)
        frames = torch.randint(0, 256, (TOWER_FRAMES, cfg.frame_resolution,
                                        cfg.frame_resolution, 3), generator=gen, device="cuda",
                               dtype=torch.uint8)
        line = {}
        for way, tree in trees.items():
            tower_ms = cuda_ms(lambda i: aha.encode_vision_tokens(
                tree, cfg, frames, torch.bfloat16), iters=3, warmup=1) / TOWER_FRAMES
            scores = {}
            kernels.reset_launches()                  # the main path starts here
            for fused in (4, 1):
                sess = build_session(tree, cfg, tok, InferConfig(
                    grounding_mode=True, frame_fps=1.0, kv_cache_policy="sink",
                    kv_window=2048, num_sink_tokens=32, fused_score_frames=fused))
                t0 = time.perf_counter()
                rows = sess.score_video(frames, query=QUERY)
                torch.cuda.synchronize()
                t_sv = time.perf_counter() - t0
                scores[fused] = (torch.tensor([[r[k] for k in SCORE_KEYS] for r in rows],
                                              dtype=torch.float64), t_sv)
                del sess
            counts = dict(kernels.LAUNCHES)           # ... and ends here
            stats.launches(counts)
            a, b = scores[4][0], scores[1][0]
            gap = (a - b).abs()
            if (a.shape != (TOWER_FRAMES, 3) or not torch.isfinite(a).all()
                    or not (gap <= 2e-2 + 5e-2 * b.abs()).all()
                    or counts.get("int8_matmul", 0) < L * 4 * 2 * (TOWER_FRAMES // 4)
                    or counts.get("decode_attention", 0) < L * TOWER_FRAMES):
                raise AssertionError(f"phase10e {name} {way}: scores {tuple(a.shape)}, fused "
                                     f"vs fused 1 gap {gap.max().item():.3e}, launches {counts}")
            line[way] = (f"the tower {tower_ms:.3f} ms a frame (a {TOWER_FRAMES}-frame batch, "
                         f"CUDA events); score_video {TOWER_FRAMES} frames at fused 4 "
                         f"{scores[4][1]:.3f}s, at fused 1 {scores[1][1]:.3f}s; scores in "
                         f"[{a.min().item():.4f}, {a.max().item():.4f}], fused vs fused 1 "
                         f"largest gap {gap.max().item():.3e} (atol 2e-2 + rtol 5e-2); "
                         f"launches int8_matmul={counts.get('int8_matmul', 0)} "
                         f"decode_attention={counts.get('decode_attention', 0)}")
        print(f"phase10e {name} at 7B-int8 ({cfg.frame_num_tokens} tokens a frame, frames "
              f"{cfg.frame_resolution} x {cfg.frame_resolution}) [{gpu}]: JAX's synthetic tree "
              f"{t_build:.2f}s; " + "; ".join(f"{way}: {v}" for way, v in line.items()),
              flush=True)
        del params, q_vision, trees, frames


# -- phase 11: parallelism ------------------------------------------------------------------

# 11a: MultiStreamServer(batch=8) over 8 requests at data 1 x model 2 (model 4 where the
# host has 4 cards: 7 q / 1 kv head a rank), the sum rule at P11_SUM on every request, a
# query at t = 0 and on every third request one mid-stream; 120 frames: the ranks' run
# is the longest wait of the script (63 s on an H100 at 184 frames)
P11_LENGTHS = (8, 16, 24, 8, 16, 24, 8, 16)
P11_STREAM = 48
P11_SUM = 8.0
# 11b: the decoder cut to 4 of its 28 layers, full width; a batch of 2 rows of 16 frames
# left-padded to 1,024 tokens, and for ring attention one row padded to ring_min_seq
P11_LAYERS = 4
P11_T = 1024
P11_RING_T = 2048
# the local products of a rank at model 2 (11a's serving, 11b's TP step): q/k/v merged
# from each rank's own blocks (1792 + 256 + 256), o and down split by rows, gate/up by columns
LAYER_TP2 = [("qkv_tp2", 3584, 2304), ("o_proj_tp2", 1792, 3584),
             ("gate_up_tp2", 3584, 18944), ("down_tp2", 9472, 3584)]
LAYER_TP4 = [("qkv_tp4", 3584, 1152), ("o_proj_tp4", 896, 3584),
             ("gate_up_tp4", 3584, 9472), ("down_tp4", 4736, 3584)]
LM_HEAD_TP = {2: ("lm_head_tp2", 3584, 76032), 4: ("lm_head_tp4", 3584, 38016)}
PROJECTOR_TP = {2: (("projector_fc1_tp2", 1024, 1792), ("projector_fc2_tp2", 1792, 3584)),
                4: (("projector_fc1_tp4", 1024, 896), ("projector_fc2_tp4", 896, 3584))}


def p11_world() -> int:
    """Ranks of phase 11: 4 over NCCL where the host has 4 cards, else 2 that
    share cuda:0 over gloo."""
    import torch

    return 4 if torch.cuda.device_count() >= 4 else 2


def p11_train_cases(world: int) -> list:
    """11b: (name, mesh, trunk, TrainConfig fields, batch)."""
    if world == 4:
        return [("fsdp_tp", (2, 2), "int4", {}, "b"), ("tp4", (1, 4), "int8", {}, "b"),
                ("gpipe", (2, 1, 2), "int4", dict(mesh_pipe=2, pipe_microbatches=2), "b"),
                ("ring", (4, 1), "int8", dict(ring_attention=True, ring_min_seq=P11_RING_T),
                 "ring")]
    return [("fsdp", (2, 1), "int4", {}, "b"), ("tp", (1, 2), "int8", {}, "b"),
            ("gpipe", (1, 1, 2), "int4", dict(mesh_pipe=2, pipe_microbatches=2), "b"),
            ("ring", (2, 1), "int8", dict(ring_attention=True, ring_min_seq=P11_RING_T), "ring")]


def p11_serve_rows() -> set:
    """Rows of 11a's products: those of phase 7's passes at B = 8 (the same
    widths and templates) and the projector rows of its requests' last vision
    batches."""
    sw = serve8_widths()
    rows = {SERVE_B * w for k in ("frame_steps", "queries", "mixed", "spec", "fused", "start")
            for w in sw[k]}
    return rows | {SERVE_B, 32, 64, 392, 1568}


def p11_items(cfg, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    frames = torch.randint(0, 256, (P11_STREAM, cfg.frame_resolution, cfg.frame_resolution, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    items = []
    for j, n in enumerate(P11_LENGTHS):
        o = (5 * j) % (P11_STREAM - n + 1)
        conv = [{"role": "user", "content": QUERY, "time": 0}]
        if j % 3 == 1:
            conv.append({"role": "user", "content": QUERY, "time": (n // 2) / 2.0})
        items.append((f"r{j}", frames[o:o + n], conv,
                      {"stream_end_score_sum_threshold": P11_SUM}))
    return items


def p11_infer_cfg():
    from aha_tpu_torch.config import InferConfig

    return InferConfig(frame_fps=2.0, kv_cache_policy="sink", kv_window=2048,
                       num_sink_tokens=32, fused_score_frames=4, spec_decode_tokens=4,
                       spec_decode_tokens_max=8, max_new_tokens=16,
                       stream_end_score_sum_threshold=P11_SUM)


def p11_batches(cfg, tok, seed: int, rows: int) -> dict:
    """11b's batches: ``rows`` rows of 16 frames at 1,024 tokens, and one row of
    frames at ring_min_seq tokens (both left-padded)."""
    import numpy as np

    from aha_tpu_torch.train import trainer
    from aha_tpu_torch.train.trainer import _left_pad

    rng = np.random.default_rng(seed)
    b, T = trainer.synthetic_batch(cfg, tok, rng, n_frames=16, B=rows)
    n = 16
    while True:                       # the most frames that fit in ring_min_seq tokens
        r, Tr = trainer.synthetic_batch(cfg, tok, np.random.default_rng(seed + 1),
                                        n_frames=n + 1, B=1)
        if Tr > P11_RING_T:
            break
        n += 1
    r, Tr = trainer.synthetic_batch(cfg, tok, np.random.default_rng(seed + 1), n_frames=n, B=1)
    return {"b": _left_pad(b, P11_T - T, tok.pad_token_id),
            "ring": _left_pad(r, P11_RING_T - Tr, tok.pad_token_id)}


def p11_state(cfg, tok, name, shape, mode, extra, seed: int, mesh):
    """A 4-layer 7B-width QLoRA state (``mode`` trunk; projector and lm_head
    dense) on ``mesh`` (None: one rank) and its step."""
    import dataclasses as dc

    from aha_tpu_torch.config import TrainConfig
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.train import trainer

    kw = dict(learning_rate=1e-4, warmup_ratio=0.0, grad_accum_steps=1, remat_policy="full")
    if mesh is not None:
        kw.update(mesh_data=shape[0], mesh_model=shape[1], **extra)
    tc = TrainConfig(**kw)
    params = random_params(cfg, mode=mode, keep_dense=QLORA_DENSE, seed=seed)
    state, tx, labels, scale = trainer.init_train_state(cfg, tc, params, total_steps=100,
                                                        seed=seed, device_mesh=mesh)
    del params
    return state, trainer.make_train_step(cfg, tc, tx, labels, scale, device_mesh=state.mesh,
                                          pad_token_id=tok.pad_token_id)


def p11_serve_cmd(d: str, model: int) -> list:
    """11d (4 cards): ``serve --synthetic_weights --int8 --batch 8`` over two
    requests on clips written with cv2 under ``d`` (a directory of this rank's
    own), at data 1 x model ``model``; returns the result lines."""
    import cv2
    import numpy as np

    from aha_tpu_torch.cli import cmd_serve

    reqs = []
    for j in range(2):
        writer = cv2.VideoWriter(f"{d}/c{j}.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (64, 48))
        for i in range(32):                               # 4 s: 8 frames at 2 fps
            writer.write(np.full((48, 64, 3), (i * 10 + 40 * j) % 255, np.uint8))
        writer.release()
        reqs.append({"key": f"c{j}", "video": f"{d}/c{j}.mp4",
                     "conversation": [{"role": "user", "content": QUERY, "time": 0}]})
    with open(f"{d}/requests.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in reqs)
    cmd_serve(["--synthetic_weights", "--int8", "--batch", str(SERVE_B), "--input",
               f"{d}/requests.jsonl", "--output", f"{d}/out.jsonl", "--max_new_tokens", "16",
               "--stream_end_score_sum_threshold", "3.0", "--emit_scores"]
              + (["--mesh_model", str(model)] if model > 1 else []))
    import os

    if not os.path.exists(f"{d}/out.jsonl"):
        return []
    with open(f"{d}/out.jsonl") as f:
        return [json.loads(x) for x in f]


def p11_cfg4(cfg):
    import dataclasses as dc

    return cfg.replace(llm=dc.replace(cfg.llm, num_layers=P11_LAYERS))


def phase11_rank(rank: int, world: int, device: str, seed: int, native_ops: list) -> dict:
    """One rank of phase 11: the collectives probed on this backend, 11a's
    sharded server, 11b's sharded train steps; returns what the parent prints
    and holds (every rank its own counts and times; rank 0 the results)."""
    import torch

    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.ops.kernels import _build
    from aha_tpu_torch.parallel import comm as C
    from aha_tpu_torch.parallel.mesh import make_mesh
    from aha_tpu_torch.streaming.multi import MultiStreamServer

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    out = {"rank": rank, "device": str(torch.cuda.current_device())}
    C.GLOO_CUDA_NATIVE = set(native_ops)        # phase 1's probe
    mesh = make_mesh(1, world)
    cfg, tok = _model("7b")
    with ShapeRecorder() as rec:
        # -- 11a: sharded serving ------------------------------------------------------
        items = p11_items(cfg, seed)
        params = random_params(cfg, mode="int8", seed=seed)
        server = MultiStreamServer(params, cfg, tok, p11_infer_cfg(), batch=SERVE_B,
                                   max_frames=max(P11_LENGTHS), mesh=mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launches()
        C.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = server.run_items(items, fps=2.0)
        torch.cuda.synchronize()
        out["11a"] = dict(seconds=time.perf_counter() - t0, launches=dict(kernels.LAUNCHES),
                          collectives=dict(C.COUNTS), staged=dict(C.STAGED),
                          latency=server.latency_stats(),
                          memory_gb=torch.cuda.max_memory_allocated() / 1e9)
        if rank == 0:
            out["11a"]["results"] = res
        del server, items
        gc.collect()
        torch.cuda.empty_cache()
        # -- 11b: sharded train steps at 4 layers --------------------------------------------
        cfg4 = p11_cfg4(cfg)
        batches = p11_batches(cfg4, tok, seed, rows=2 if world == 2 else 4)
        out["11b"] = {}
        for name, shape, mode, extra, which in p11_train_cases(world):
            m = make_mesh(*shape)
            state, step = p11_state(cfg4, tok, name, shape, mode, extra, seed, m)
            kernels.reset_launches()
            C.reset_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, parts = step(state, batches[which])
            losses = [float(parts.total)]
            torch.cuda.synchronize()
            ms = [(time.perf_counter() - t) * 1e3]
            out["11b"][name] = dict(losses=losses, ms=ms, launches=dict(kernels.LAUNCHES),
                                    collectives=dict(C.COUNTS), staged=dict(C.STAGED))
            del state, step
            gc.collect()
            torch.cuda.empty_cache()
        if world == 4:
            # 11d: the command itself at model 4 (7 q / 1 kv head a rank)
            import tempfile

            with tempfile.TemporaryDirectory() as d:
                t0 = time.perf_counter()
                out["11d"] = dict(lines=p11_serve_cmd(d, world),
                                  seconds=time.perf_counter() - t0)
    out["shapes"] = rec.seen
    return out


def probe_rank(rank: int, world: int, device: str, op: str) -> bool:
    """Phase 1's probe on one rank of a world of its own: ``op`` once on a CUDA
    tensor over this backend (gloo may end the process on one it refuses)."""
    from aha_tpu_torch.parallel import comm as C
    from aha_tpu_torch.parallel.mesh import make_mesh

    return C.probe_op(make_mesh(1, world).comm("model"), op, "cuda")


def start_probes(world: int) -> dict:
    """One throwaway world a collective, all started at once."""
    from aha_tpu_torch.parallel import comm as C
    from aha_tpu_torch.parallel.launch import start

    backend = "nccl" if world == 4 else "gloo"
    return {op: start(probe_rank, world, op, device="cuda", backend=backend, timeout=60)
            for op in C.OPS}


def probed(worlds: dict) -> dict:
    """op -> True where every rank ran it, False where one failed or ended."""
    out = {}
    for op, w in worlds.items():
        try:
            out[op] = all(w.result())
        except (RuntimeError, TimeoutError):
            out[op] = False
    return out


def phase11c(gpu: str):
    """The native decoder: built or not (and why); on a clip written here, its
    frames against the cv2 path's in count and source indices."""
    import tempfile

    import numpy as np

    from aha_tpu_torch import native
    from aha_tpu_torch.data import media

    t0 = time.perf_counter()
    ok = native.available()
    t_build = time.perf_counter() - t0
    if not ok:
        print(f"phase11c native decoder not built ({native.build_error}); media.decode_video "
              f"keeps cv2 [{gpu}]", flush=True)
        return
    import cv2

    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/clip.mp4"
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (320, 240))
        rng = np.random.default_rng(0)
        for i in range(150):
            f = np.full((240, 320, 3), (i * 7) % 255, np.uint8)
            f[40:80, 40:120] = rng.integers(0, 255, (40, 80, 3))
            out.write(f)
        out.release()
        t0 = time.perf_counter()
        nat, ni = native.decode_video_native(path, output_fps=2.0, output_size=384)
        t_nat = time.perf_counter() - t0
        import os

        os.environ["AHA_NATIVE_DECODER"] = "off"
        try:
            t0 = time.perf_counter()
            cv, ci = media.decode_video(path, output_fps=2.0, output_size=384)
            t_cv = time.perf_counter() - t0
        finally:
            del os.environ["AHA_NATIVE_DECODER"]
    gap = float(np.abs(nat.astype(np.int16) - cv.astype(np.int16)).mean())
    print(f"phase11c native decoder built (load {t_build:.2f}s): a 5 s clip at 30 fps, 320 x "
          f"240 decoded at 2 fps to 384: {len(ni)} frames natively in {t_nat * 1e3:.1f} ms, "
          f"{len(ci)} with cv2 in {t_cv * 1e3:.1f} ms; indices equal {ni == ci}; mean pixel "
          f"gap {gap:.3f} [{gpu}]", flush=True)
    if ni != ci or len(ni) != 10 or gap > 8.0:
        raise AssertionError(f"phase11c: native {ni} against cv2 {ci}, gap {gap}")


def phase11(gpu: str, seed: int, stats: Stats, rec):
    """Parallelism on the card: 11a sharded serving and 11b sharded train steps
    on a world of 2 ranks sharing cuda:0 over gloo (4 over NCCL where the host
    has 4 cards), each held against the one-rank run this process makes
    meanwhile; 11c the native decoder."""
    import numpy as np
    import torch

    from aha_tpu_torch import golden
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops import kernels
    from aha_tpu_torch.parallel.launch import start
    from aha_tpu_torch.streaming.multi import MultiStreamServer

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    world = p11_world()
    backend = "nccl" if world == 4 else "gloo"
    ranks = start(phase11_rank, world, seed, stats.native_ops, device="cuda", backend=backend,
                  timeout=600, threads=4)
    phase11c(gpu)
    cfg, tok = _model("7b")
    # 11b's one-rank first losses, then 11a's one-rank server, while the ranks run
    cfg4 = p11_cfg4(cfg)
    batches = p11_batches(cfg4, tok, seed, rows=2 if world == 2 else 4)
    one_loss = {}
    for mode, which in (("int4", "b"), ("int8", "b"), ("int8", "ring")):
        state, step = p11_state(cfg4, tok, "one", None, mode, {}, seed, None)
        _, parts = step(state, batches[which])
        one_loss[(mode, which)] = float(parts.total)
        del state, step
    gc.collect()
    torch.cuda.empty_cache()
    items = p11_items(cfg, seed)
    params = random_params(cfg, mode="int8", seed=seed)
    server = MultiStreamServer(params, cfg, tok, p11_infer_cfg(), batch=SERVE_B,
                               max_frames=max(P11_LENGTHS))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = server.run_items(items, fps=2.0)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    del server
    t_wait = time.perf_counter()
    outs = ranks.result()
    t_wait = time.perf_counter() - t_wait
    rec.seen |= outs[0]["shapes"]
    print(f"phase11 world {world} ({backend}{', one card shared' if world == 2 else ''}) "
          f"[{gpu}]: collectives taken on CUDA tensors {stats.native_ops} (phase 1); the "
          f"others staged through pinned host memory", flush=True)

    # -- 11a ------------------------------------------------------------------------------
    atol, rtol = golden.ATOL["chip7b"], golden.RTOL
    got = outs[0]["11a"]["results"]
    n_frames = sum(P11_LENGTHS)
    failed, n_resp, n_same, parted = [], 0, 0, []
    for key, video, conv, rule in items:
        g, r = got[key], one[key]
        rows, ref_rows = g["debug_data"], r["debug_data"]
        fired = [round(t["time"] * 2.0) for t in g["responses"] if t["role"] == "assistant"]
        ref_fired = [round(t["time"] * 2.0) for t in r["responses"]
                     if t["role"] == "assistant"]
        upto = min(sorted(set(fired) ^ set(ref_fired)) or [len(video)])
        a = np.asarray([[x[k] for k in SCORE_KEYS] for x in rows[:upto + 1]], np.float64)
        b = np.asarray([[x[k] for k in SCORE_KEYS] for x in ref_rows[:upto + 1]], np.float64)
        gaps, within = golden.score_gaps(a.reshape(-1, 3), b.reshape(-1, 3), atol, rtol)
        bt, st = texts(g["responses"]), texts(r["responses"])
        same = 0
        while same < min(len(bt), len(st)) and fired[same] == ref_fired[same] and \
                bt[same] == st[same]:
            same += 1
        n_resp += len(bt)
        n_same += same
        if same < min(len(bt), len(st)) and fired[same] == ref_fired[same]:
            with golden.recorded_logits() as logits:
                _, turns1, *_ = solo_run(params, cfg, tok, video, conv, rule,
                                         dict(fused_score_frames=4, spec_decode_tokens=1,
                                              spec_decode_tokens_max=1))
            div = golden.first_divergences(texts(turns1)[:same + 1], bt[:same + 1], tok, logits)
            d = next((x for x in div if x is not None), None)
            parted.append({"key": key, "response": same, "divergence": d})
        ok = (len(rows) == len(video) and within
              and all(math.isfinite(x[k]) for x in rows for k in SCORE_KEYS))
        if not ok:
            failed.append(f"{key}: {len(rows)} frames, responses {fired} / {ref_fired}, "
                          f"gaps {gaps.tolist()}")
        print(f"phase11a {key} {len(video)} frames: responses at {fired} (one rank: "
              f"{ref_fired}); largest score gap per column {gaps.tolist()} up to the first "
              f"differing decision (within atol 2e-2 + rtol 5e-2: {within}); texts equal for "
              f"{same} of {len(bt)}", flush=True)
    del params
    for o in outs:
        a = o["11a"]
        print(f"phase11a rank {o['rank']} [{gpu}]: {a['seconds']:.3f}s = "
              f"{n_frames / a['seconds']:.2f} frames/s ({n_frames} frames, "
              f"{a['latency'].get('tokens', 0)} tokens), peak {a['memory_gb']:.2f} GB; "
              f"launches {a['launches']}; collectives {a['collectives']}, staged "
              f"{a['staged']}", flush=True)
    print(f"phase11a MultiStreamServer batch {SERVE_B} at data 1 x model {world}, "
          f"{len(P11_LENGTHS)} requests, fused 4, generation 4->8, max_new_tokens 16 [{gpu}]: "
          f"one rank {t_one:.3f}s = {n_frames / t_one:.2f} frames/s (run in this process while "
          f"the ranks ran); {n_resp} responses, texts equal {n_same}; parted {parted}",
          flush=True)
    counts = outs[0]["11a"]["launches"]
    if counts.get("int8_matmul", 0) <= 0 or counts.get("decode_attention", 0) <= 0:
        failed.append(f"kernels not launched on the sharded path: {counts}")
    if n_resp < 4:
        failed.append(f"{n_resp} responses")
    for p in parted:
        # None: the sharded text is the solo width-1 text (the one-rank server parted)
        d = p["divergence"]
        steps = 0.0 if d is None else d.get("gap_bf16_steps", float("inf"))
        if not steps <= 2.0:
            failed.append(f"{p['key']} parts {steps} bf16 steps from the top")
    stats.launches(counts)

    # -- 11b ------------------------------------------------------------------------------
    for name, shape, mode, extra, which in p11_train_cases(world):
        r = outs[0]["11b"][name]
        ref = one_loss[(mode, which)]
        rel = abs(r["losses"][0] - ref) / abs(ref)
        ok = all(math.isfinite(x) for x in r["losses"]) and rel <= 1e-2
        per_rank = [o["11b"][name]["ms"][0] for o in outs]
        print(f"phase11b {name} mesh {'x'.join(map(str, shape))} {mode} trunk, {P11_LAYERS} of "
              f"28 layers at full width, batch {which} [{gpu}]: losses {r['losses']} (one rank "
              f"{ref:.6f}, relative gap {rel:.2e}); ms of the step per rank {per_rank} (the "
              f"first: every kernel and collective's first use in it); launches "
              f"{r['launches']}; collectives {r['collectives']}, staged {r['staged']}",
              flush=True)
        if not ok:
            failed.append(f"11b {name}: losses {r['losses']} against {ref}")
        stats.launches(r["launches"])
    if world == 4:
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            ref = {x["key"]: x for x in p11_serve_cmd(d, 1)}
        got = {x["key"]: x for x in outs[0]["11d"]["lines"]}
        same_keys = set(got) == set(ref) == {"c0", "c1"}
        rows = {k: (len(got[k]["debug_data"]), len(ref[k]["debug_data"])) for k in got}
        times = {k: ([t["time"] for t in got[k]["responses"] if t["role"] == "assistant"],
                     [t["time"] for t in ref[k]["responses"] if t["role"] == "assistant"])
                 for k in got}
        print(f"phase11d serve --synthetic_weights --int8 --batch 8 --mesh_model 4 under a "
              f"world of 4 [{gpu}]: {outs[0]['11d']['seconds']:.2f}s with the weights; keys "
              f"{sorted(got)}; frames scored per key (sharded, one rank) {rows}; response "
              f"times {times}", flush=True)
        if not same_keys or any(a != b for a, b in rows.values()):
            failed.append(f"11d: keys {sorted(got)}, frames {rows}")
    print(f"phase11 took {time.perf_counter() - t_phase:.1f}s (waited {t_wait:.1f}s for the "
          f"ranks)", flush=True)
    if failed:
        raise AssertionError(f"phase11: {failed}")



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="comma-separated phases (1 device, 2 kernels, 3 tiny slices, 4 7B "
                         "serving, 5 7B training, 6 JAX's weights, 7 multi-stream serving, 8 "
                         "the serving options: adapters, --w8a8, 9 the highlight chain: "
                         "infer tvsum, grid-search, evaluate, highlight, 10 the live-video "
                         "datasets, demo, the interactive API, the judge, the towers, 11 "
                         "parallelism: sharded serving and training, the native decoder); "
                         "anything short of all of them exits 1 with no result line")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch_gaps", action="store_true",
                    help="print phase 7b's shares of the 7B fixture's tolerance alone (no check, "
                         "exits 1 with no result line); runs with the package beside this script, "
                         "so a copy of it in another checkout reads that checkout's gaps")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from aha_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: aha_tpu_torch not importable next to this script: {e}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    world = p11_world()
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc {nvcc}; kernel build "
          f"{_build.build_seconds if _build.build_seconds is not None else 0.0:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s)", flush=True)
    if args.batch_gaps:
        batch_gaps(gpu, args.seed)
        return 1
    print(f"phase1 {check_ptxas(_build.ptxas_log)}", flush=True)
    # each collective probed in a throwaway world while phase 2 runs (the ranks start
    # after the build, so that their interpreters do not slow nvcc)
    probes = start_probes(world)

    def print_probes():
        from aha_tpu_torch import native

        native_ops = probed(probes)
        print(f"phase1 collectives on CUDA tensors, {world} ranks over "
          f"{'nccl' if world == 4 else 'gloo (sharing cuda:0)'}, each probed in a world of its "
          f"own: {', '.join(f'{k} ' + ('taken' if v else 'refused: staged through pinned host memory') for k, v in native_ops.items())}; "
          f"native decoder: {'built' if native.available() else f'not built ({native.build_error})'}",
          flush=True)
        return sorted(op for op, ok in native_ops.items() if ok)

    stats = Stats()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if 2 in phases:
        check_matmuls(gen, stats)
        check_quantize_rows(gen, stats)
        check_split(gen, stats)
        check_attention(gen, stats)
        check_attention_steps(gen, stats)
        check_row_free_products(gen, stats)
        check_int4_matmul_t(gen, stats)
        check_flash_attention(gen, stats)
        k = stats.k
        L = 28
        print(f"phase2 one decoder layer of a train step at T={TRAIN_T}, kernels alone: "
              f"int4_matmul {stats.train_fwd_ms:.4f} ms, int4_matmul_t "
              f"{k['int4_matmul_t']['ms']:.4f} ms, flash forward "
              f"{k['flash_attention_fwd']['ms']:.4f} ms, flash backward "
              f"{k['flash_attention_bwd']['ms']:.4f} ms; times the launches of a step at remat "
              f"'full' over {L} layers (2, 1, 2, 1): "
              f"{L * (2 * stats.train_fwd_ms + k['int4_matmul_t']['ms'] + 2 * k['flash_attention_fwd']['ms'] + k['flash_attention_bwd']['ms']):.1f} ms",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    stats.native_ops = print_probes()
    if 3 in phases:
        phase3(args.seed)
        phase3_train(args.seed)
    if phases & {4, 5, 6, 7, 8, 9, 10, 11}:
        phases_4_to_10(gpu, args.seed, stats, phases)

    print(f"{gpu}; chip_smoke took {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src, "replaces": tpu,
         "launches": stats.k[n]["launches"], "max_abs_err": stats.k[n]["err"],
         "ms": stats.k[n]["ms"], "plain_ms": stats.k[n]["plain_ms"],
         "bound_ms": stats.k[n]["bound_ms"], "bound_by": stats.k[n]["bound_by"],
         "library_ms": stats.k[n]["library_ms"], "shape": stats.k[n]["shape"]}
        for n, (src, tpu) in KERNELS.items()]}), flush=True)
    if phases != set(range(1, 12)):
        print(f"chip_smoke: ran phases {sorted(phases)} only", file=sys.stderr)
        return 1
    if stats.failures:
        print(f"chip_smoke: failed: {stats.failures}", file=sys.stderr)
        return 1
    missing = [n for n in KERNELS if stats.k[n]["launches"] <= 0]
    if missing:
        print(f"chip_smoke: kernels never launched on a main path: {missing}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
