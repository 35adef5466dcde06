#!/usr/bin/env python3
"""Smoke run of aha_tpu_torch on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --phases 1,2   # device + kernel checks only

Phases, one or more lines each:
  1. device: nvidia-smi name and power limit, torch / CUDA / nvcc versions,
     the kernels' build time (built from aha_tpu_torch/csrc at first use);
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     streaming path's 7B shapes (bf16: max|y - y_ref| <= 1e-2 * max|y_ref|)
     and at small ragged shapes (f32: 1e-4 * max|y_ref|), with kernel and
     plain times (CUDA events; weights cycled through > L2 worth of copies);
  3. the tiny preset's whole slice on the card (kernels) and on the CPU
     (plain versions) from the same seeded int8 weights: scores must agree
     to atol 1e-3; whether the generated texts match is printed;
  4. the 7B-int8 slice with seeded synthetic weights: score_video over 64
     frames, then inference() over 96 frames at 2 fps with a query at t=0,
     past the 2048-token window fill. Launch counters are zeroed just before
     and read just after; every kernel must have run layers x chunks times.

Prints the kernels' JSON line and, last, {"ok": true, "device": ...}.
Exits nonzero, with no result line, when there is no CUDA device, when the
package is missing, or when any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
INT8_SRC = "aha_tpu_torch/csrc/int8_matmul.cu"
ATTN_SRC = "aha_tpu_torch/csrc/decode_attention.cu"
INT8_TPU = "aha_tpu/ops/pallas/fused_matmul.py:177"
ATTN_TPU = "aha_tpu/ops/pallas/decode_attention.py:131"


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


def rel_check(name: str, y, ref, tol: float) -> float:
    import torch

    if y.shape != ref.shape or not torch.isfinite(y.float()).all():
        raise AssertionError(f"{name}: shape {tuple(y.shape)} vs {tuple(ref.shape)} or non-finite")
    err = (y.float() - ref.float()).abs().max().item()
    bound = tol * max(ref.float().abs().max().item(), 1e-30)
    if not err <= bound:
        raise AssertionError(f"{name}: max|y-y_ref| {err:.3e} > {bound:.3e}")
    return err


# -- phase 2 -------------------------------------------------------------------


def check_int8(gen, stats: dict):
    import torch

    from aha_tpu_torch.ops.kernels import int8_matmul as k8

    dev = "cuda"
    # (label, M, K, N, dtype): the 7B-int8 path's products. M = 1 (a
    # generated token), 13 (generation prompt), 49 (a frame), 220 (system
    # prompt + first frame), 1568 (projector over 32 frames x 49 tokens)
    shapes = [("qkv", 1, 3584, 4608), ("qkv", 49, 3584, 4608), ("qkv", 220, 3584, 4608),
              ("o_proj", 1, 3584, 3584), ("o_proj", 49, 3584, 3584),
              ("gate_up", 1, 3584, 37888), ("gate_up", 49, 3584, 37888),
              ("down", 1, 18944, 3584), ("down", 49, 18944, 3584), ("down", 13, 18944, 3584),
              ("lm_head", 1, 3584, 152064),
              ("projector_fc1", 1568, 1024, 3584), ("projector_fc2", 1568, 3584, 3584)]
    cases = [(*s, torch.bfloat16, 1e-2) for s in shapes]
    cases += [("ragged", 7, 100, 77, torch.float32, 1e-4),
              ("ragged", 1, 64, 33, torch.float32, 1e-4),
              ("ragged", 13, 300, 130, torch.float32, 1e-4),
              ("ragged", 5, 96, 48, torch.float32, 1e-4)]
    frame_ms = frame_plain_ms = 0.0
    for label, M, K, N, dt, tol in cases:
        # enough weight copies that a timing loop cannot live in the 50 MB L2
        copies = max(1, math.ceil(160e6 / (K * N)))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(copies)]
        sc = (torch.rand((1, N), generator=gen, device=dev) + 0.5) * (0.02 / 127)
        x = torch.randn((M, K), generator=gen, device=dev).to(dt)
        y = k8.int8_matmul(x, ws[0], sc)
        ref = k8.int8_matmul_plain(x, ws[0], sc)
        torch.cuda.synchronize()
        err = rel_check(f"int8_matmul {label} M={M} K={K} N={N}", y, ref, tol)
        stats["int8_err"] = max(stats["int8_err"], err)
        ms = cuda_ms(lambda i: k8.int8_matmul(x, ws[i % copies], sc))
        pms = cuda_ms(lambda i: k8.int8_matmul_plain(x, ws[i % copies], sc), iters=5)
        if M == 49 and label in ("qkv", "o_proj", "gate_up", "down"):
            frame_ms += ms
            frame_plain_ms += pms
        print(f"phase2 int8_matmul {label} M={M} K={K} N={N} {str(dt)[6:]} "
              f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f}", flush=True)
        del ws
    stats["int8_ms"], stats["int8_plain_ms"] = frame_ms, frame_plain_ms


def attention_inputs(gen, B, S, NH, KVH, Dh, Wp, qdt, kvdt):
    """Random operands with a mixed mask: some empty slots, orders spread
    so that each query sees part of the cache."""
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
    g = (Wp - S + torch.arange(S, device=dev)).repeat(B, 1).to(torch.int32)
    return (q, k, v, ang.cos().contiguous(), ang.sin().contiguous(), order.contiguous(),
            g.contiguous(), scales)


def check_attention(gen, stats: dict):
    import torch

    from aha_tpu_torch.ops.kernels import decode_attention as da

    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    # (label, B, S, NH, KVH, Dh, Wp, q dtype, kv dtype, tol): 7B shapes on
    # the 2049-slot sink cache (S = 1 generation, 13 generation prompt,
    # 49 frame, 220 system + first frame), int8 KV, then small ragged f32
    cases = [("7b", 1, 1, 28, 4, 128, 2049, bf, bf, 1e-2),
             ("7b", 1, 13, 28, 4, 128, 2049, bf, bf, 1e-2),
             ("7b", 1, 49, 28, 4, 128, 2049, bf, bf, 1e-2),
             ("7b", 1, 220, 28, 4, 128, 2049, bf, bf, 1e-2),
             ("7b-int8kv", 1, 49, 28, 4, 128, 2049, bf, i8, 1e-2),
             ("ragged", 2, 5, 4, 2, 16, 77, f32, f32, 1e-4),
             ("ragged", 2, 3, 6, 2, 64, 129, f32, f32, 1e-4),
             ("ragged", 1, 9, 8, 2, 32, 45, f32, f32, 1e-4),
             ("ragged-int8kv", 2, 7, 4, 2, 128, 100, f32, i8, 1e-4)]
    for label, B, S, NH, KVH, Dh, Wp, qdt, kvdt, tol in cases:
        args = attention_inputs(gen, B, S, NH, KVH, Dh, Wp, qdt, kvdt)
        y = da.decode_attention(*args)
        ref = da.decode_attention_plain(*args)
        torch.cuda.synchronize()
        err = rel_check(f"decode_attention {label} B={B} S={S} Dh={Dh} Wp={Wp}", y, ref, tol)
        stats["attn_err"] = max(stats["attn_err"], err)
        ms = cuda_ms(lambda i: da.decode_attention(*args))
        pms = cuda_ms(lambda i: da.decode_attention_plain(*args), iters=5)
        if label == "7b" and S == 49:
            stats["attn_ms"], stats["attn_plain_ms"] = ms, pms
        print(f"phase2 decode_attention {label} B={B} S={S} NH={NH} KVH={KVH} Dh={Dh} "
              f"Wp={Wp} q={str(qdt)[6:]} kv={str(kvdt)[6:]} max_abs_err={err:.3e} "
              f"kernel_ms={ms:.4f} plain_ms={pms:.4f}", flush=True)


# -- phases 3 and 4 --------------------------------------------------------------


def tiny_slice(device: str, params, cfg, tok, frames):
    from aha_tpu.config import InferConfig

    from aha_tpu_torch.streaming.session import build_session

    common = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=256, num_sink_tokens=16,
                  fused_score_frames=1, spec_decode_tokens=1)
    s = build_session(params, cfg, tok, InferConfig(
        stream_end_score_sum_threshold=2.5, max_new_tokens=16, **common), device=device)
    s.input_video_stream(frames)
    s.input_query_stream([{"role": "user", "content": "What is happening?", "time": 0}])
    turns = s.inference()
    sv = build_session(params, cfg, tok, InferConfig(grounding_mode=True, **common),
                       device=device).score_video(frames, query="What is happening?")
    keys = ("informative_score", "relevance_score", "uncertainty_score")
    return ([[r[k] for k in keys] for r in s.debug_data_list + sv],
            [t["content"] for t in turns if t["role"] == "assistant"])


def phase3(gen_seed: int):
    import numpy as np
    import torch

    from aha_tpu.config import aha_tiny
    from aha_tpu.tokenization import build_stream_tokenizer

    from aha_tpu_torch.models.aha import random_params

    cfg = aha_tiny()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    cpu = random_params(cfg, device="cpu", seed=gen_seed)
    gpu = _to(cpu, "cuda")
    frames = np.random.default_rng(gen_seed).integers(0, 255, (24, 40, 48, 3), dtype=np.uint8)
    s_gpu, t_gpu = tiny_slice("cuda", gpu, cfg, tok, frames)
    s_cpu, t_cpu = tiny_slice("cpu", cpu, cfg, tok, frames)
    a, b = np.asarray(s_gpu), np.asarray(s_cpu)
    if a.shape != b.shape or not np.isfinite(a).all():
        raise AssertionError(f"tiny slice: scores {a.shape} vs {b.shape} or non-finite")
    err = float(np.abs(a - b).max())
    if not err <= 1e-3:
        raise AssertionError(f"tiny slice: card vs CPU scores differ by {err:.3e} > 1e-3")
    same = t_gpu == t_cpu
    first = ""
    if not same:
        for i, (x, y) in enumerate(zip(t_gpu, t_cpu)):
            if x != y:
                j = next((k for k, (p, q) in enumerate(zip(x, y)) if p != q), min(len(x), len(y)))
                first = f" first divergence: response {i} char {j}"
                break
    print(f"phase3 tiny slice card-vs-cpu: {len(a)} frame scores max_abs_err={err:.3e} "
          f"responses={len(t_gpu)}/{len(t_cpu)} texts_match={same}{first}", flush=True)
    del gpu
    torch.cuda.empty_cache()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase4(gpu: str, seed: int, stats: dict):
    import torch

    from aha_tpu.config import InferConfig, aha_7b
    from aha_tpu.tokenization import build_stream_tokenizer

    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.models.aha import random_params
    from aha_tpu_torch.ops.kernels import decode_attention as da
    from aha_tpu_torch.ops.kernels import int8_matmul as k8
    from aha_tpu_torch.streaming.session import build_session

    cfg = aha_7b()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    t0 = time.perf_counter()
    params = random_params(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    t_params = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randint(0, 256, (96, 384, 384, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    query = "What is happening in this video?"
    common = dict(frame_fps=2.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32,
                  fused_score_frames=1, spec_decode_tokens=1, max_new_tokens=32)

    chunks = [0]
    decode_chunk = qwen2.decode_chunk

    def counted(*a, **k):
        chunks[0] += 1
        return decode_chunk(*a, **k)

    qwen2.decode_chunk = counted
    # gen_s: whole generate() calls; dec_*: only their S = 1 passes (the
    # first token of a response comes from the prompt chunk's logits)
    gen_s, dec_tokens, dec_s = [0.0], [0], [0.0]
    try:
        torch.cuda.reset_peak_memory_stats()
        k8.launches = da.launches = 0            # the main path starts here
        t0 = time.perf_counter()
        sv_sess = build_session(params, cfg, tok, InferConfig(grounding_mode=True, **common),
                                device="cuda")
        rows = sv_sess.score_video(frames[:64], query=query)
        torch.cuda.synchronize()
        t_sv = time.perf_counter() - t0
        del sv_sess
        # threshold: the eighth-highest score of the same frames, so that the
        # first responses fire within the first 64 frames
        ends = sorted((r["informative_score"] + r["relevance_score"] for r in rows), reverse=True)
        sess = build_session(params, cfg, tok, InferConfig(
            stream_end_prob_threshold=ends[7], **common), device="cuda")
        generate, append_ids = sess.engine.generate, sess.engine.append_ids
        prompt_end = [0.0]

        def timed_append_ids(*a, **k):
            out = append_ids(*a, **k)
            torch.cuda.synchronize()
            prompt_end[0] = time.perf_counter()
            return out

        def timed_generate(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = generate(*a, **k)           # its first call is append_ids (the prompt)
            torch.cuda.synchronize()
            end = time.perf_counter()
            gen_s[0] += end - t
            dec_s[0] += end - prompt_end[0]
            dec_tokens[0] += int(out[1].sum()) - 1
            return out

        sess.engine.generate, sess.engine.append_ids = timed_generate, timed_append_ids
        t0 = time.perf_counter()
        sess.input_video_stream(frames)
        sess.input_query_stream([{"role": "user", "content": query, "time": 0}])
        turns = sess.inference()
        torch.cuda.synchronize()
        t_inf = time.perf_counter() - t0
        n8, na = k8.launches, da.launches          # the main path ends here
    finally:
        qwen2.decode_chunk = decode_chunk
    peak = torch.cuda.max_memory_allocated()

    scores = [[r[k] for k in ("informative_score", "relevance_score", "uncertainty_score")]
              for r in rows + sess.debug_data_list]
    if len(rows) != 64 or len(sess.debug_data_list) != 96:
        raise AssertionError(f"7b: {len(rows)} / {len(sess.debug_data_list)} frame scores")
    if not all(math.isfinite(x) for row in scores for x in row):
        raise AssertionError("7b: non-finite score")
    responses = [t for t in turns if t["role"] == "assistant"]
    if not responses:
        raise AssertionError("7b: no response fired")
    L = cfg.llm.num_layers
    if na < L * chunks[0] or n8 < L * chunks[0]:
        raise AssertionError(f"7b: launches int8={n8} attention={na} < {L} layers x "
                             f"{chunks[0]} chunks")
    seen = int(sess.cache.seen[0])
    if seen <= 2048 + 32:
        raise AssertionError(f"7b: stream of {seen} tokens never filled the window")
    stats["int8_launches"], stats["attn_launches"] = n8, na
    inf_frames_s = 96 / (t_inf - gen_s[0])
    print(f"phase4 7b-int8 [{gpu}] params {t_params:.2f}s; score_video 64 frames "
          f"{t_sv:.3f}s = {64 / t_sv:.2f} frames/s (vision included); inference 96 frames "
          f"{t_inf:.3f}s, {len(responses)} responses in {gen_s[0]:.3f}s; S=1 passes "
          f"{dec_tokens[0]} tokens in {dec_s[0]:.3f}s = "
          f"{dec_tokens[0] / max(dec_s[0], 1e-9):.2f} decode tokens/s, "
          f"scoring {inf_frames_s:.2f} frames/s; stream {seen} tokens; {chunks[0]} chunks; "
          f"launches int8_matmul={n8} decode_attention={na}; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"phase4 first response: {responses[0]['content'][:60]!r}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4")
    ap.add_argument("--seed", type=int, default=0)
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

    gpu = gpu_line()
    print(gpu, flush=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    _build.library()
    print(f"phase1 device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; nvcc {nvcc}; kernel build "
          f"{_build.build_seconds if _build.build_seconds is not None else 0.0:.2f}s "
          f"(load {time.perf_counter() - t0:.2f}s)", flush=True)

    stats = dict(int8_err=0.0, attn_err=0.0, int8_ms=None, int8_plain_ms=None, attn_ms=None,
                 attn_plain_ms=None, int8_launches=None, attn_launches=None)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if 2 in phases:
        check_int8(gen, stats)
        check_attention(gen, stats)
    if 3 in phases:
        phase3(args.seed)
    if 4 in phases:
        phase4(gpu, args.seed, stats)

    print(json.dumps({"kernels": [
        {"name": "int8_matmul", "route": "cuda", "source": INT8_SRC, "replaces": INT8_TPU,
         "launches": stats["int8_launches"], "max_abs_err": stats["int8_err"],
         "ms": stats["int8_ms"], "plain_ms": stats["int8_plain_ms"]},
        {"name": "decode_attention", "route": "cuda", "source": ATTN_SRC, "replaces": ATTN_TPU,
         "launches": stats["attn_launches"], "max_abs_err": stats["attn_err"],
         "ms": stats["attn_ms"], "plain_ms": stats["attn_plain_ms"]}]}), flush=True)
    if phases != {1, 2, 3, 4}:
        print(f"chip_smoke: ran phases {sorted(phases)} only", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
