"""Where the time goes in the 7B-int8 streaming slice on one CUDA card.

    python3 -m aha_tpu_torch.profile_slice [--seed 0] [--frames 8]

Builds seeded synthetic 7B-int8 params on the card (``random_params``), a
sink cache (window 2048, 32 sinks, bf16) and drives the engine the way
``StreamSession.inference`` does, then traces three sections with
``torch.profiler``:

  vision      one ``encode_frames`` call of 32 frames (the tower's batch);
  frame       ``--frames`` frame chunks (49 tokens each) after the window
              has filled, each followed by the host read of its scores;
  token       greedy generation: a ``generate`` with a budget of 33 tokens
              minus one with a budget of 1, each on a copy of the same
              cache, so that only the 32 S = 1 passes remain.

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
           busy_ms: float, kernels: dict, aten: collections.Counter, top: int = 6) -> None:
    n_kernels = sum(c for c, _ in kernels.values())
    print(f"profile {label}: per {unit} wall {wall_ms / units:.3f} ms (traced "
          f"{traced_wall_ms / units:.3f} ms), device busy {busy_ms / units:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}; "
          f"{n_kernels / units:.1f} device ops and {sum(aten.values()) / units:.1f} aten ops "
          f"per {unit} ({units} {unit}s traced)", flush=True)
    total_us = sum(t for _, t in kernels.values())
    for name, (calls, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"profile {label}:   {name} {100 * t / total_us:.1f}% of device time, "
              f"{calls / units:.2f} calls per {unit}, {t / max(calls, 1):.1f} us per call",
              flush=True)
    ops = ", ".join(f"{n} {c / units:.1f}" for n, c in aten.most_common(top))
    print(f"profile {label}:   aten ops per {unit}: {ops}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8, help="frame chunks traced after the fill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_slice: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from aha_tpu.config import InferConfig, aha_7b
    from aha_tpu.tokenization import build_stream_tokenizer

    from .models.aha import random_params
    from .streaming.session import build_session

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"profile device: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    cfg = aha_7b()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = random_params(cfg, device="cuda", seed=args.seed)
    icfg = InferConfig(grounding_mode=True, frame_fps=2.0, kv_cache_policy="sink",
                       kv_window=2048, num_sink_tokens=32, fused_score_frames=1,
                       spec_decode_tokens=1)
    engine = build_session(params, cfg, tok, icfg, device="cuda").engine
    policy = engine.policy
    fill = policy.window + policy.num_sink
    n_frames = fill // cfg.frame_num_tokens + 2 + 2 * args.frames
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    frames = torch.randint(0, 256, (n_frames, cfg.frame_resolution, cfg.frame_resolution, 3),
                           generator=gen, device="cuda", dtype=torch.uint8)

    # vision: one tower batch, after a warm-up batch
    engine.encode_frames(frames[:VISION_FRAMES])
    tr = Trace()
    tr.run(lambda: engine.encode_frames(frames[:VISION_FRAMES]))
    report("vision", VISION_FRAMES, "frame", tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(),
           tr.kernels(), tr.aten_ops())
    embeds = engine.encode_frames(frames)

    # frame chunks: query, system + first frame, then frames until the
    # window has filled; the traced frames come after the fill
    query = tok.apply_chat_template([{"role": "user", "content": "What is happening?"}],
                                    add_stream_query_prompt=False, add_stream_prompt=True)
    start = tok.apply_chat_template([{"role": "system", "content": icfg.system_prompt}])
    cache = engine.new_cache()
    engine.append_ids(cache, [query])
    engine.append_text_frames(cache, [start], embeds[:1])
    t = 1
    while int(cache.seen[0]) <= fill:
        engine.append_frames(cache, embeds[t:t + 1]).cpu()
        t += 1

    nxt = iter(range(t, n_frames))

    def frame_chunks():
        for _ in range(args.frames):
            i = next(nxt)
            engine.append_frames(cache, embeds[i:i + 1]).cpu()   # the session reads scores

    tr = Trace()
    tr.run(frame_chunks)
    report(f"frame (stream at {int(cache.seen[0])} tokens)", args.frames, "frame",
           tr.wall_ms, tr.traced_wall_ms, tr.busy_ms(), tr.kernels(), tr.aten_ops())

    # tokens: budget 1 + GEN_TOKENS minus budget 1, each from the same cache
    # state (the clone is in both, and cancels)
    prompt = tok.apply_chat_template([{}], add_stream_generation_prompt=True)
    traces = []
    for budget in (1, 1 + GEN_TOKENS):
        engine.max_new_tokens = budget
        tr = Trace()
        out = tr.run(lambda: engine.generate(cache.clone(), [prompt], engine.new_rep_counts()))
        traces.append(tr)
    if int(out[1][0]) != 1 + GEN_TOKENS:
        raise RuntimeError(f"generation stopped after {int(out[1][0])} tokens")
    a, b = traces
    ka, kb = a.kernels(), b.kernels()
    diff = {n: [kb[n][0] - ka.get(n, [0, 0.0])[0], kb[n][1] - ka.get(n, [0, 0.0])[1]]
            for n in kb}
    report("token (S = 1 passes only)", GEN_TOKENS, "token", b.wall_ms - a.wall_ms,
           b.traced_wall_ms - a.traced_wall_ms, b.busy_ms() - a.busy_ms(),
           {n: v for n, v in diff.items() if v[0] > 0}, b.aten_ops() - a.aten_ops())
    return 0


if __name__ == "__main__":
    sys.exit(main())
