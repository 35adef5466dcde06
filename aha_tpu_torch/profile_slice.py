"""Where the time goes in the 7B streaming slices and in a 7B int4 QLoRA
train step on one CUDA card.

    python3 -m aha_tpu_torch.profile_slice [--seed 0] [--frames 8]
                                           [--paths int8,int4,int8a8,int4a8,int8f32,int4f32,
                                                    serve8,train,train8]
                                           [--remat full]

For each path it builds seeded synthetic 7B params on the card
(``random_params``), a sink cache (window 2048, 32 sinks, bf16) and drives
the engine the way ``StreamSession`` does, then traces sections with
``torch.profiler``.

int8 and int4 (the --int8 and --int4 configs), both at the product widths and
at width 1, after the window has filled; int8a8 (the --w8a8 config: int8 weights,
per-token int8 activations, backend ``fused_a8``, fused passes of 8 frames) and
int4a8 (packed int4 weights, per-token int8 activations, backend ``fused_a8``,
fused passes of 4 frames, as JAX runs ``--int4`` with ``AHA_QUANT_MATMUL=fused_a8``):

  vision      (int8 only) one ``encode_frames`` call of 32 frames (the
              tower's batch);
  frame       ``--frames`` frame chunks (49 tokens each), each followed by
              the host read of its scores: one frame per pass, what
              ``inference()`` runs;
  fused pass  ``--frames`` fused passes of 4 frames (196 rows; 8 frames, 392
              rows, for int8a8) through the read-only verify pass and its
              commit (``score_video``);
  verify S    8 verify passes of S = 4 and of S = 8 candidate tokens
              (plans, embedding, decoder, lm_head, no commit), the pass
              ``generate_spec`` runs (its attention the steps' write
              passes in one launch of the cached-attention kernels a layer);
  token       greedy generation: a ``generate`` with a budget of 33 tokens
              minus one with a budget of 1, each on a copy of the same
              cache, so that only the 32 S = 1 passes remain.

int8f32 and int4f32 (the --int8 and --int4 trunks behind the f32 overrides a
peft artifact brings, as ``--lora_pretrained`` serves them: a dense f32
projector, heads and lm_head, seeded, merged into the tree as JAX's
promotions take them, so the frame embeddings and every frame chunk and fused
pass run in f32; no adapters) trace the frame chunks and the fused passes
only (generation stays bf16), each with the products' share of device time
(every kernel of the quantised products: ``int8_mm`` / ``int4_mm`` kernels,
the split of f32 x into bf16 planes, the sums of K splits), the cached
attention's (its f32 tensor-core kernel, which splits q into bf16 planes as it
loads it, and the merge of its window splits; the CUDA-core kernel where a
pass runs it) and, apart, the rotation of the cached keys into bf16 planes.

serve8 (multi-stream serving: 7B-int8, B 8 rows of one batched engine, each
row's window filled) traces the passes a ``MultiStreamServer`` of 8 slots
runs, per pass (each carries 8 rows):

  token       the S = 1 passes of ``generate`` for all 8 rows (8 tokens a
              pass), as the token table above;
  frame step  ``--frames`` frame chunks of 8 rows (392 rows), each followed by
              the host read of its scores: the mixed loop's scoring pass;
  fused pass  ``--frames`` fused passes of 8 rows x 4 frames (1,568 rows);
  verify S=4  8 verify passes of 8 rows x 4 tokens (32 rows), as the
              speculative tail runs them.

The frame and fused-pass tables list the products' kernels of many rows
(``int8_mm_wgmma_kernel``, ``int8_mm_ws_kernel`` and their int4 twins) with
their calls and us per call even below the top ones. The verify-pass and token
tables list the path's decode kernel for products of
1 .. 16 rows (``int8_mm_decode_kernel``, ``int4_mm_decode_kernel``), the sum of
its K splits and, for int8a8 and int4a8, the activation quantiser by name, with their share
of device time and calls per unit.

train (int4 QLoRA: int4 trunk, dense bf16 projector and lm_head, LoRA r 16,
lora_dropout 0.05, remat ``--remat``) and train8 (the same over an int8 trunk,
the default of ``train --quantize_base``), after two steps to warm:

  step        one ``train_step`` on the synthetic batch (B 1, 16 frames in a
              conversation of 926 tokens): vision tower, forward, backward
              with its replay, AdamW; and the same step's forward + loss
              alone;
  collated    one ``train_step`` on a batch the collator builds (B 2, a
              DVC-style and a grounding-style conversation of 12 and 10
              frames behind the training system prompt, left-padded to the
              length bucket 1,024, the frames to the bucket 32), as ``train``
              feeds it.

Each section runs twice: once untimed by the profiler, for the wall time
(host clock, card synchronised), then traced, for the device's work (the
profiler's tracing slows the host, so the traced run's own wall time is
printed beside it but not used). For each section it prints one line per
unit (frame or token): wall ms, traced wall ms, device busy ms (the union
of the traced kernel and copy intervals), the device's idle share
(1 - busy / wall), device ops and aten ops issued; then each of the top kernels
with its share of busy time, calls per unit and us per call, and the most
frequent aten ops per unit. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

VISION_FRAMES = 32
GEN_TOKENS = 32
# the cached attention's kernels (csrc/decode_attention.cu), listed in the write
# passes' and the verify passes' tables with their calls per unit, launched or not
DECODE_KERNELS = ("decode_attention_kernel", "decode_attention_wgmma_kernel",
                  "decode_attention_wgmma_f32_kernel", "decode_rotate_keys_kernel",
                  "decode_merge_kernel")
# the products' kernel at 1 .. 16 rows (csrc/int8_matmul.cu, csrc/int4_matmul.cu) and
# the sum of its K splits, listed in the path's token and verify-pass tables
MATMUL_DECODE_KERNELS = {"int8": ("int8_mm_decode_kernel", "splitk_reduce"),
                         "int4": ("int4_mm_decode_kernel", "splitk_reduce"),
                         "int8a8": ("int8_mm_decode_kernel", "splitk_reduce",
                                    "quantize_rows_vec_kernel"),
                         "int4a8": ("int4_mm_decode_kernel", "splitk_reduce",
                                    "quantize_rows_vec_kernel")}
# the products' kernels of many rows (the one-warpgroup wgmma kernels, the
# warp-specialised ones), listed in the frame and fused-pass tables below the top ones
PRODUCT_KERNELS = ("_mm_wgmma_kernel", "_mm_ws_kernel")
# path -> (weights, matmul backend, fused_score_frames of the product)
SERVING = {"int8": ("int8", "fused", 4), "int4": ("int4", "fused", 4),
           "int8a8": ("int8", "fused_a8", 8), "int4a8": ("int4", "fused_a8", 4),
           "int8f32": ("int8", "fused", 4), "int4f32": ("int4", "fused", 4)}
# the shares of device time the f32 paths print: the kernels of the quantised products,
# of the cached attention, and the rotation of its keys (names that a kernel's name holds)
F32_SHARES = {"products": ("int8_mm_", "int4_mm_", "split_bf16x3", "splitk_reduce"),
              "attention": ("decode_attention_kernel", "decode_attention_wgmma_kernel",
                            "decode_attention_wgmma_f32_kernel", "decode_merge_kernel"),
              "key rotation": ("decode_rotate_keys_kernel",)}


def _short(name: str) -> str:
    """'void ns::foo_kernel<128, bf16>(...)' -> 'foo_kernel'."""
    while (s := re.sub(r"<[^<>]*>", "", name)) != name:
        name = s
    head = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    return head.removeprefix("void ").split("::")[-1] or name


def _wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


class Trace:
    """One region, run once plain for its wall time and once traced."""

    def __init__(self):
        self.wall_ms = self.traced_wall_ms = 0.0
        self.events = []

    def run(self, fn):
        self.wall_ms, _ = _wall_ms(fn)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            self.traced_wall_ms, out = _wall_ms(fn)
        self.events = list(prof.events())
        return out

    def device_events(self):
        return [e for e in self.events if e.device_type == DeviceType.CUDA]

    def busy_ms(self) -> float:
        spans = sorted((e.time_range.start, e.time_range.end) for e in self.device_events())
        if not spans:
            raise RuntimeError("the profiler saw no device activity: time with CUDA events")
        busy, (lo, hi) = 0.0, spans[0]
        for a, b in spans[1:]:
            if a > hi:
                busy, lo = busy + hi - lo, a
            hi = max(hi, b)
        return (busy + hi - lo) / 1e3

    def kernels(self) -> dict[str, list[float]]:
        """short kernel name -> [calls, total us]."""
        out: dict[str, list[float]] = collections.defaultdict(lambda: [0, 0.0])
        for e in self.device_events():
            k = out[_short(e.name)]
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
        return out

    def aten_ops(self) -> collections.Counter:
        return collections.Counter(e.name for e in self.events
                                   if e.device_type == DeviceType.CPU
                                   and e.name.startswith("aten::"))


def report(label: str, units: int, unit: str, wall_ms: float, traced_wall_ms: float,
           busy_ms: float, kernels: dict, aten: collections.Counter, top: int = 6,
           also: tuple = (), named: tuple = (), shares: dict | None = None) -> None:
    """``also``: kernels whose name holds one of these are listed below the top
    ones too; ``named``: kernels listed by these exact names, with 0 calls
    where the unit launched none; ``shares``: label -> names, the kernels whose
    name holds one of the names summed into one share of device time a label."""
    n_kernels = sum(c for c, _ in kernels.values())
    print(f"profile {label}: per {unit} wall {wall_ms / units:.3f} ms (traced "
          f"{traced_wall_ms / units:.3f} ms), device busy {busy_ms / units:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{n_kernels / units:.1f} device ops and {sum(aten.values()) / units:.1f} aten ops "
          f"per {unit} ({units} {unit}s traced)", flush=True)
    total_us = sum(t for _, t in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    listed = ranked[:top] + [kv for kv in ranked[top:]
                             if any(a in kv[0] for a in also) or kv[0] in named]
    for name, (calls, t) in listed:
        print(f"profile {label}:   {name} {100 * t / total_us:.1f}% of device time, "
              f"{calls / units:.2f} calls per {unit}, {t / max(calls, 1):.1f} us per call",
              flush=True)
    for name in named:
        if name not in kernels:
            print(f"profile {label}:   {name} 0.0% of device time, 0.00 calls per {unit}",
                  flush=True)
    for what, names in (shares or {}).items():
        part = [(c, t) for n, (c, t) in kernels.items() if any(a in n for a in names)]
        t_part = sum(t for _, t in part)
        print(f"profile {label}:   {what} {100 * t_part / total_us:.1f}% of device time, "
              f"{t_part / 1e3 / units:.3f} ms per {unit} in {sum(c for c, _ in part) / units:.1f} "
              f"launches", flush=True)
    ops = ", ".join(f"{n} {c / units:.1f}" for n, c in aten.most_common(top))
    print(f"profile {label}:   aten ops per {unit}: {ops}", flush=True)


def _setup(mode: str, seed: int, n_frames: int, backend: str = "fused", f32: bool = False,
           **widths):
    from .config import InferConfig, aha_7b
    from .models.aha import random_params
    from .models.loader import apply_overrides
    from .streaming.session import build_session
    from .tokenization import build_stream_tokenizer

    cfg = aha_7b()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = random_params(cfg, mode=mode, seed=seed)
    if f32:
        params = apply_overrides(params, _f32_overrides(cfg, seed))
    icfg = InferConfig(grounding_mode=True, frame_fps=2.0, kv_cache_policy="sink",
                       kv_window=2048, num_sink_tokens=32, **widths)
    engine = build_session(params, cfg, tok, icfg, backend=backend).engine
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    frames = torch.randint(0, 256, (n_frames, cfg.frame_resolution, cfg.frame_resolution, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)
    return cfg, tok, icfg, engine, frames


def _fill(engine, tok, icfg, rows):
    """Each of the engine's rows (``rows`` [B, T, F, H]): query, system + first
    frame, then frames until the window has filled. Returns (cache, index of
    the next frame)."""
    B = rows.shape[0]
    query = tok.apply_chat_template([{"role": "user", "content": "What is happening?"}],
                                    add_stream_query_prompt=False, add_stream_prompt=True)
    start = tok.apply_chat_template([{"role": "system", "content": icfg.system_prompt}])
    fill = engine.policy.window + engine.policy.num_sink
    cache = engine.new_cache()
    engine.append_ids(cache, [query] * B)
    engine.append_text_frames(cache, [start] * B, rows[:, 0])
    t = 1
    while int(cache.seen.min()) <= fill:
        engine.append_frames(cache, rows[:, t]).cpu()
        t += 1
    return cache, t


def _f32_overrides(cfg, seed: int) -> dict:
    """The modules a peft artifact's ``--lora_pretrained`` brings besides the
    adapters, seeded, dense f32 (``loader.load_adapter(..., torch.float32)``):
    the projector, the three heads and the lm_head."""
    H, Hv, V = cfg.llm.hidden_size, cfg.vision.hidden_size, cfg.llm.vocab_size
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    rand = lambda *shape: torch.randn(shape, generator=gen, device="cuda") * 0.02
    return {"projector": {"fc1": {"kernel": rand(Hv, H), "bias": rand(H)},
                          "fc2": {"kernel": rand(H, H), "bias": rand(H)}},
            "heads": {n: {"kernel": rand(H, c)} for n, c in
                      (("informative", 2), ("relevance", 1), ("uncertainty", 1))},
            "llm": {"lm_head": {"kernel": rand(H, V)}}}


def _trace_frames(label, engine, cache, rows, first, n, shares=None):
    """``n`` frame chunks of every row (``rows`` [B, T, F, H]), each followed
    by the host read of its scores, as ``inference()`` and the mixed serving
    loop run them."""
    B = rows.shape[0]

    def frame_chunks():
        for _ in range(n):
            engine.append_frames(cache, rows[:, next(nxt)]).cpu()   # the session reads scores

    # two runs (plain, traced) consume 2 n frames
    nxt = iter(range(first, first + 2 * n))
    tr = Trace()
    tr.run(frame_chunks)
    what, unit = ((f"frame (stream at {int(cache.seen[0])} tokens)", "frame") if B == 1 else
                  (f"frame step ({B * 49} rows)", "pass"))
    report(f"{label} {what}", n, unit, tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(),
           tr.kernels(), tr.aten_ops(), also=PRODUCT_KERNELS, named=DECODE_KERNELS,
           shares=shares)


def _trace_fused(label, engine, cache, rows, first, n, K, shares=None):
    """``n`` fused passes of ``K`` frames a row through the read-only verify
    pass and its commit (``score_video``, the mixed loop's scoring pass)."""
    B = rows.shape[0]
    nxt = iter(range(first, first + 2 * n * K, K))

    def fused_passes():
        for _ in range(n):
            i = next(nxt)
            engine.append_frames_fused(cache, rows[:, i:i + K]).cpu()

    tr = Trace()
    tr.run(fused_passes)
    what = (f"({K} frames, {K * 49} rows; stream at {int(cache.seen[0])} tokens)" if B == 1
            else f"({B} x {K} frames, {B * K * 49} rows)")
    report(f"{label} fused pass {what}", n, "pass", tr.wall_ms, tr.traced_wall_ms,
           tr.busy_ms(), tr.kernels(), tr.aten_ops(), also=PRODUCT_KERNELS, named=DECODE_KERNELS,
           shares=shares)


def _trace_verify(label, engine, cfg, cache, S, named):
    """8 verify passes of ``S`` candidate tokens a row (plans, embedding,
    decoder, lm_head, no commit), as ``generate_spec`` and the speculative
    serving tail run them (attention replayed through the cached-attention
    kernel)."""
    from .models import qwen2
    from .ops import spec_decode

    B = cache.batch
    llm = engine.params["llm"]
    ids = torch.randint(0, 1000, (B, S), device="cuda")

    def verify_passes():
        for _ in range(8):
            plans = spec_decode.plan_compose(
                cache, engine.policy, torch.full((B,), S, dtype=torch.int32, device="cuda"), S)
            hidden, _, _ = qwen2.decode_chunk_spec(
                llm, cfg.llm, engine.policy, cache, qwen2.embed_tokens(llm, ids, engine.dtype),
                plans, backend=engine.backend)
            qwen2.lm_logits(llm, cfg.llm, hidden, engine.backend).float().argmax(-1).cpu()

    tr = Trace()
    tr.run(verify_passes)
    rows = f" ({B * S} rows)" if B > 1 else ""
    report(f"{label} verify S={S}{rows}", 8, "pass", tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(),
           tr.kernels(), tr.aten_ops(), named=named)


def _trace_tokens(label, engine, tok, cache, named=DECODE_KERNELS):
    """Budget 1 + GEN_TOKENS minus budget 1, each from the same cache state
    (the clone is in both, and cancels), for every row of the cache: a pass
    writes a token a row."""
    B = cache.batch
    prompt = tok.apply_chat_template([{}], add_stream_generation_prompt=True)
    traces = []
    for budget in (1, 1 + GEN_TOKENS):
        engine.max_new_tokens = budget
        tr = Trace()
        out = tr.run(lambda: engine.generate(cache.clone(), [prompt] * B,
                                             engine.new_rep_counts()))
        traces.append(tr)
    if int(out[1].min()) != 1 + GEN_TOKENS:
        raise RuntimeError(f"generation stopped after {out[1].tolist()} tokens")
    a, b = traces
    ka, kb = a.kernels(), b.kernels()
    diff = {n: [kb[n][0] - ka.get(n, [0, 0.0])[0], kb[n][1] - ka.get(n, [0, 0.0])[1]]
            for n in kb}
    what, unit = (("token (S = 1 passes only)", "token") if B == 1 else
                  (f"token pass (S = 1, {B} tokens a pass)", "pass"))
    report(f"{label} {what}", GEN_TOKENS, unit, b.wall_ms - a.wall_ms,
           b.traced_wall_ms - a.traced_wall_ms, b.busy_ms() - a.busy_ms(),
           {n: v for n, v in diff.items() if v[0] > 0}, b.aten_ops() - a.aten_ops(),
           named=named)


def profile_serving(path: str, seed: int, n: int) -> None:
    mode, backend, K = SERVING[path]                  # K: fused_score_frames of the product
    f32 = path.endswith("f32")
    fill_frames = (2048 + 32) // 49 + 2
    cfg, tok, icfg, engine, frames = _setup(
        mode, seed, fill_frames + 2 * n + 2 * n * K, backend, f32=f32, fused_score_frames=K,
        spec_decode_tokens=1)
    if path == "int8":
        # vision: one tower batch, after a warm-up batch
        engine.encode_frames(frames[:VISION_FRAMES])
        tr = Trace()
        tr.run(lambda: engine.encode_frames(frames[:VISION_FRAMES]))
        report(f"{path} vision", VISION_FRAMES, "frame", tr.wall_ms, tr.traced_wall_ms,
               tr.busy_ms(), tr.kernels(), tr.aten_ops())
    rows = engine.encode_frames(frames)[None]
    cache, t = _fill(engine, tok, icfg, rows)
    if f32:
        if rows.dtype != torch.float32:
            raise RuntimeError(f"{path}: frame embeddings in {rows.dtype}, not f32")
        label = f"{path} (f32 overrides, f32 frame embeddings)"
        _trace_frames(label, engine, cache, rows, t, n, shares=F32_SHARES)
        _trace_fused(label, engine, cache, rows, t + 2 * n, n, K, shares=F32_SHARES)
        return
    _trace_frames(path, engine, cache, rows, t, n)
    _trace_fused(path, engine, cache, rows, t + 2 * n, n, K)
    for S in (4, 8):
        _trace_verify(path, engine, cfg, cache, S, DECODE_KERNELS + MATMUL_DECODE_KERNELS[path])
    _trace_tokens(path, engine, tok, cache, named=DECODE_KERNELS + MATMUL_DECODE_KERNELS[path])


def profile_serve8(seed: int, n: int) -> None:
    """The passes of multi-stream serving at 7B-int8, B 8 (module docstring)."""
    from .streaming.engine import StreamEngine

    B, K = 8, 4
    fill_frames = (2048 + 32) // 49 + 2
    cfg, tok, icfg, solo, frames = _setup("int8", seed, fill_frames + 2 * n + 2 * n * K,
                                          fused_score_frames=K, spec_decode_tokens=1)
    engine = StreamEngine(solo.params, cfg, solo.policy, batch=B, fused_score_frames=K)
    embeds = engine.encode_frames(frames)
    # the same stream in every row, each row at its own offset of it
    rows = torch.stack([embeds.roll(-3 * b, dims=0) for b in range(B)])     # [B, T, F, H]
    cache, t = _fill(engine, tok, icfg, rows)
    label = f"serve8 (B={B}, stream at {int(cache.seen[0])} tokens a row)"
    _trace_frames(label, engine, cache, rows, t, n)
    _trace_fused(label, engine, cache, rows, t + 2 * n, n, K)
    _trace_verify(label, engine, cfg, cache, 4, DECODE_KERNELS + MATMUL_DECODE_KERNELS["int8"])
    _trace_tokens(label, engine, tok, cache, named=DECODE_KERNELS + MATMUL_DECODE_KERNELS["int8"])


def collated_batch(cfg, tok, rng, frames_per_row=(12, 10)) -> dict:
    """A batch as ``train`` feeds it: one conversation a row (narrated frames
    with learned answers, then a grounding query over frames with relevance
    spans), random frames, collated by ``data/collator.py`` (left padding,
    length and frame buckets, labels through the offset mapping)."""
    import numpy as np

    from .config import TrainConfig
    from .data.collator import collate
    from .data.conversations import build_example

    examples = []
    for i, n in enumerate(frames_per_row):
        if i % 2 == 0:
            conv = [{"role": "user", "content": "Please concisely narrate the video in real time."}]
            for part in (n // 2, n - n // 2):
                conv += [{"role": "stream", "num_frames": part, "learn": True},
                         {"role": "assistant", "content": "the subject moves on.", "learn": True,
                          "response_frame_num": 2}]
            ex = build_example(conv, tok, system_prompt=TrainConfig().system_prompt,
                               use_relevance=False)
        else:
            conv = [{"role": "user", "content": "Which clips show the subject?", "learn": False},
                    {"role": "stream", "num_frames": n, "learn": True,
                     "related": [{"related": False, "num_frames": n // 2},
                                 {"related": True, "num_frames": n - n // 2}]}]
            ex = build_example(conv, tok, system_prompt=TrainConfig().system_prompt,
                               use_informative=False)
        r = cfg.frame_resolution
        ex.frames = rng.integers(0, 255, (n, r, r, 3)).astype(np.uint8)
        examples.append(ex)
    return collate(examples, tok, v_placeholder_id=cfg.v_placeholder_id,
                   frame_num_tokens=cfg.frame_num_tokens).asdict()


def profile_train(seed: int, remat: str, mode: str = "int4") -> None:
    import numpy as np

    from .config import TrainConfig, aha_7b
    from .models.aha import random_params
    from .tokenization import build_stream_tokenizer
    from .train import trainer

    cfg = aha_7b()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = random_params(cfg, mode=mode, keep_dense=("projector", "lm_head"), seed=seed)
    tc = TrainConfig(learning_rate=1e-4, warmup_ratio=0.0, grad_accum_steps=1,
                     remat_policy=remat)
    state, tx, labels, scale = trainer.init_train_state(cfg, tc, params, total_steps=100,
                                                        seed=seed)
    step = trainer.make_train_step(cfg, tc, tx, labels, scale)
    batch, T = trainer.synthetic_batch(cfg, tok, np.random.default_rng(seed), n_frames=16)
    for _ in range(2):
        step(state, batch)
    torch.cuda.reset_peak_memory_stats()
    tr = Trace()
    _, parts = tr.run(lambda: step(state, batch))
    report(f"train step ({mode} QLoRA, B=1 T={T}, remat={remat}, loss {float(parts.total):.4f}, "
           f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", 1, "step",
           tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(), tr.kernels(), tr.aten_ops(), top=14,
           also=("flash_",) + PRODUCT_KERNELS)

    from .models import aha
    from .train.losses import aha_loss

    dev = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}

    def forward_only():
        with torch.no_grad():
            outs = aha.forward_train(state.tree["model"], cfg, dev["input_ids"].long(),
                                     dev["frames"], attn_mask=dev["attention_mask"],
                                     lora=state.tree["lora"], lora_scale=scale, remat="none")
            return aha_loss(outs.logits, outs.informative_logits, outs.relevance,
                            outs.log_variance, input_ids=dev["input_ids"], labels=dev["labels"],
                            informative_labels=dev["informative_labels"],
                            relevance_labels=dev["relevance_labels"], weights=tc.loss_weights)

    forward_only()
    tr = Trace()
    tr.run(forward_only)
    report(f"train forward + loss alone (no graph, no dropout, B=1 T={T})", 1, "pass",
           tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(), tr.kernels(), tr.aten_ops(), top=8,
           also=("flash_",) + PRODUCT_KERNELS)

    collated = collated_batch(cfg, tok, np.random.default_rng(seed))
    B, T = collated["input_ids"].shape
    real = int(collated["attention_mask"].sum())
    for _ in range(2):
        step(state, collated)
    torch.cuda.reset_peak_memory_stats()
    tr = Trace()
    _, parts = tr.run(lambda: step(state, collated))
    report(f"train step on a collated batch ({mode} QLoRA, B={B} T={T}, {real} real tokens, "
           f"{collated['frames'].shape[0]} frames, remat={remat}, loss {float(parts.total):.4f}, "
           f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", 1, "step",
           tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(), tr.kernels(), tr.aten_ops(), top=14,
           also=("flash_",) + PRODUCT_KERNELS)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8,
                    help="frame chunks / fused passes traced after the fill")
    ap.add_argument("--paths", default="int8,int4,train")
    ap.add_argument("--remat", default="full", help="remat policy of the train path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"profile device: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    for path in args.paths.split(","):
        if path in ("train", "train8"):
            profile_train(args.seed, args.remat, "int8" if path == "train8" else "int4")
        elif path == "serve8":
            profile_serve8(args.seed, args.frames)
        else:
            profile_serving(path, args.seed, args.frames)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
