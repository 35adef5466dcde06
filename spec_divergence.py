#!/usr/bin/env python3
"""Where speculative and sequential generation part on one NVIDIA GPU.

    python3 spec_divergence.py [--mode int8|int4] [--composed] [--seed 0]

Drives the 7B stream of ``chip_smoke.py`` phase 4 (seeded synthetic weights,
96 frames past the 2048-token window, the trigger threshold from a fused
``score_video``) at the product widths (fused 4, speculative 4 -> 8) and at
width 1, and prints whether the texts are equal. Where they part it prints
the first differing token of the first response that differs, the top three
penalised logits of the verify pass and of the sequential pass there, and,
from the cache both runs had when that response began, the verify pass's
first row against the one-token pass op by op (RMSNorm, products,
attention, MLP) through the first layers: the first op whose inputs are
equal and whose output is not is the one whose sums differ.

``--composed`` makes generation take the verify pass's composed attention
(one softmax over cache and in-flight columns, as the JAX package computes
it) instead of replaying the sequential passes through the cached-attention
kernel. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys

import chip_smoke as cs

OPS = ("rms_norm", "_qkv", "linear", "_mlp", "cached_attention", "speculative_attention",
       "replayed_attention")


def first_response(params, cfg, tok, frames, threshold, widths):
    """inference() over ``frames``; the first ``generate`` call's cache, prompt
    and counts on entry and its tokens."""
    from aha_tpu_torch.streaming import engine as engine_mod

    seen = {}
    generate = engine_mod.StreamEngine.generate

    def recorded(self, cache, ids_list, counts, ctx=None):
        first = not seen
        if first:
            seen.update(cache=cache.clone(), ids=ids_list, counts=counts.clone())
        out = generate(self, cache, ids_list, counts, ctx)
        if first:
            seen["tokens"] = out[0][0, :int(out[1][0])].tolist()
        return out

    engine_mod.StreamEngine.generate = recorded
    try:
        sess, responses, *_ = cs.run_inference(params, cfg, tok, frames, threshold, widths)
    finally:
        engine_mod.StreamEngine.generate = generate
    return sess, responses, seen


def one_pass(sess, cfg, start, tokens, verify: bool, replay: bool):
    """From the recorded cache: the prompt, then one pass over ``tokens`` (a
    verify pass, or the one-token pass of tokens[0]). Returns the penalised
    logits of its first row and the ops it ran, each op's output at row 0."""
    import torch

    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.ops import spec_decode
    from aha_tpu_torch.streaming.engine import _apply_repetition_penalty

    eng = sess.engine
    llm = eng.params["llm"]
    cache, counts = start["cache"].clone(), start["counts"].clone()
    eng.append_ids(cache, start["ids"])
    counts[0, tokens[0]] += 1
    ops, saved = [], {n: getattr(qwen2, n) for n in OPS}

    def recorded(name, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            row0 = tuple(t[:, 0].float() for t in out) if isinstance(out, tuple) else out[:, 0]
            ops.append(("attention" if "attention" in name else name, row0))
            return out
        return call

    for n in OPS:
        setattr(qwen2, n, recorded(n, saved[n]))
    try:
        ids = torch.tensor([tokens if verify else tokens[:1]], device="cuda")
        embeds = qwen2.embed_tokens(llm, ids, eng.dtype)
        if verify:
            S = len(tokens)
            plans = spec_decode.plan_compose(
                cache, eng.policy, torch.full((1,), S, dtype=torch.int32, device="cuda"), S)
            hidden, _, _ = qwen2.decode_chunk_spec(llm, cfg.llm, eng.policy, cache, embeds,
                                                   plans, backend=eng.backend, replay=replay)
        else:
            hidden = qwen2.decode_chunk(llm, cfg.llm, eng.policy, cache, embeds,
                                        torch.ones((1,), dtype=torch.int32, device="cuda"),
                                        backend=eng.backend)
    finally:
        for n in OPS:
            setattr(qwen2, n, saved[n])
    logits = qwen2.lm_logits(llm, cfg.llm, hidden[:, :1], eng.backend).float()[:, 0]
    return _apply_repetition_penalty(logits, counts, eng.repetition_penalty), ops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", default="int8", choices=("int8", "int4"))
    ap.add_argument("--composed", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("spec_divergence: no CUDA device", file=sys.stderr)
        return 2
    from aha_tpu_torch.models import qwen2
    from aha_tpu_torch.models.aha import random_params

    torch.backends.cuda.matmul.allow_tf32 = False
    replay = not args.composed
    if args.composed:
        verify = qwen2.decode_chunk_spec
        qwen2.decode_chunk_spec = lambda *a, **k: verify(*a, **{**k, "replay": False})
    print(f"{cs.gpu_line()}; 7B-{args.mode}, verify pass "
          f"{'composed' if args.composed else 'replayed'}", flush=True)
    cfg, tok = cs._model("7b")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    frames = torch.randint(0, 256, (96, 384, 384, 3), generator=gen, device="cuda",
                           dtype=torch.uint8)
    product = dict(fused_score_frames=4, spec_decode_tokens=4, spec_decode_tokens_max=8)
    params = random_params(cfg, mode=args.mode, seed=args.seed)
    rows, _ = cs.score_64(params, cfg, tok, frames[:64], product)
    threshold = sorted((r["informative_score"] + r["relevance_score"] for r in rows),
                       reverse=True)[7]
    sess, texts, spec = first_response(params, cfg, tok, frames, threshold, product)
    _, texts1, seq = first_response(params, cfg, tok, frames, threshold,
                                    dict(fused_score_frames=1, spec_decode_tokens=1))
    print(f"texts equal: {texts == texts1}{cs._first_divergence(texts, texts1)}", flush=True)
    a, b = spec["tokens"], seq["tokens"]
    j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if j is None:
        return 0
    same_start = torch.equal(spec["cache"].k, seq["cache"].k)
    print(f"first response: speculative tokens {a[:j + 2]}, sequential {b[:j + 2]}; first "
          f"differing token {j}; caches equal when it began: {same_start}", flush=True)
    if j != 1 or not same_start:
        print("the op-by-op comparison covers a part at token 1 from equal caches only")
        return 1
    lv, ops_v = one_pass(sess, cfg, spec, a[:4], verify=True, replay=replay)
    ls, ops_s = one_pass(sess, cfg, spec, a[:1], verify=False, replay=replay)
    for name, lg in (("verify pass", lv), ("sequential pass", ls)):
        v, i = lg.topk(3, dim=-1)
        print(f"{name}: token {j} penalised logits, top 3: "
              f"{[(int(t), float(x)) for t, x in zip(i[0], v[0])]}", flush=True)
    per = len(ops_s) // cfg.llm.num_layers
    for n, ((name, x), (_, y)) in enumerate(zip(ops_s, ops_v)):
        if n >= 2 * per:
            break
        pairs = zip(x, y) if isinstance(x, tuple) else [(x, y)]
        diff = max(float((p.float() - q.float()).abs().max()) for p, q in pairs)
        print(f"layer {n // per} {name}: row 0 max |sequential - verify| {diff:.3e}", flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main())
