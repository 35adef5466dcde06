"""Replay of the JAX package's golden fixtures on the port.

    python -m aha_tpu_torch.golden --fixture chip7b [--f32]   # on the card
    python -m aha_tpu_torch.golden --fixture tiny --device cpu

The port's copy of what ``scripts/make_golden_fixture.py`` records
(``_record_traces``, ``fixed_frames``) and checks (``--check``):

  * the inputs: 8 frames of 384 x 384 uniform noise from numpy's seed 1234
    (``frames_sha256`` pins them), the rendered ids of the system prompt and
    an 8-frame stream;
  * ``scores`` / ``scores_fused4``: ``score_video`` with the query, at
    ``fused_score_frames`` 1 and 4 (sink cache 2048 + 32, 1 fps);
  * ``gen_texts_seq`` / ``gen_texts_spec``: ``inference()`` with a trigger on
    every frame, ``max_new_tokens`` 48, generation width 1 and 4 -> 8.

The weights are the fixture's own recipe: ``chip7b`` is
``materialize_random_params(aha_7b() in bf16, "int8")``, ``tiny`` is JAX's
``init_aha_params`` at seed 0 (``models/loader.py``). Score traces are held to
the fixture's tolerance (atol 2e-2, 1e-4 for ``tiny``; rtol 5e-2). Texts are
compared as token ids (the char tokenizer's ``encode`` inverts its
``decode``): the first token where a response parts from the fixture's is
reported with the port's top two logits there (``first_divergences``), since
a greedy argmax over logits that tie in bf16 may go either way on another
chip.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import pathlib
import sys

import numpy as np
import torch

N_FRAMES = 8
RESOLUTION = 384
SEED = 1234
QUERY = "What is happening in this video?"
SYSTEM = ("A multimodal AI assistant is helping users with some activities."
          " Below is their conversation, interleaved with the list of video"
          " frames received by the assistant.")
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = {"chip7b": ROOT / "tests" / "fixtures" / "golden_7b_int8_chip.npz",
            "tiny": ROOT / "tests" / "fixtures" / "golden_tiny_cpu.npz"}
ATOL = {"chip7b": 2e-2, "tiny": 1e-4}
RTOL = 5e-2
SCORE_KEYS = ("informative_score", "relevance_score", "uncertainty_score")


def fixed_frames(resolution: int = RESOLUTION) -> np.ndarray:
    """[8, resolution, resolution, 3] uint8 from numpy's seed 1234."""
    rng = np.random.default_rng(SEED)
    return rng.integers(0, 255, (N_FRAMES, resolution, resolution, 3), dtype=np.uint8)


def frames_sha256(frames: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(frames).tobytes()).hexdigest()


def rendered_ids(tok, n_frames: int = N_FRAMES) -> np.ndarray:
    return np.asarray(tok.apply_chat_template(
        [{"role": "system", "content": SYSTEM},
         {"role": "stream", "num_frames": n_frames}]), np.int32)


def _common():
    return dict(frame_fps=1.0, kv_cache_policy="sink", kv_window=2048, num_sink_tokens=32)


def score_trace(params, cfg, tok, frames, width: int, device="cuda",
                backend: str = "fused") -> np.ndarray:
    """[frames, 3] (informative, relevance, uncertainty) from ``score_video``
    at ``fused_score_frames=width``."""
    from .config import InferConfig
    from .streaming.session import build_session

    sess = build_session(params, cfg, tok, InferConfig(
        grounding_mode=True, fused_score_frames=width, spec_decode_tokens=1, **_common()),
        device=device, backend=backend)
    rows = sess.score_video(frames, query=QUERY)
    return np.asarray([[r[k] for k in SCORE_KEYS] for r in rows], np.float32)


@contextlib.contextmanager
def recorded_logits():
    """Within the block, every row of logits a greedy step takes its argmax of
    (after the repetition penalty), per ``generate`` call: a list of lists of
    f32 [V] tensors, one list a response."""
    from .streaming import engine

    steps: list[list[torch.Tensor]] = []
    penalty, generate = engine._apply_repetition_penalty, engine.StreamEngine.generate

    def recorded_penalty(logits, *a, **k):
        out = penalty(logits, *a, **k)
        if steps:
            steps[-1].append(out[0].detach().clone())
        return out

    def recorded_generate(self, *a, **k):
        steps.append([])
        return generate(self, *a, **k)

    engine._apply_repetition_penalty = recorded_penalty
    engine.StreamEngine.generate = recorded_generate
    try:
        yield steps
    finally:
        engine._apply_repetition_penalty, engine.StreamEngine.generate = penalty, generate


def gen_trace(params, cfg, tok, frames, S: int, S_max: int, device="cuda",
              backend: str = "fused") -> list[str]:
    """The assistant texts of ``inference()`` with a response after every frame."""
    from .config import InferConfig
    from .streaming.session import build_session

    sess = build_session(params, cfg, tok, InferConfig(
        stream_end_prob_threshold=-1e9, max_new_tokens=48, spec_decode_tokens=S,
        spec_decode_tokens_max=S_max, **_common()), device=device, backend=backend)
    sess.input_video_stream(frames)
    sess.input_query_stream([{"role": "user", "content": QUERY, "time": 0}])
    return [t["content"] for t in sess.inference() if t["role"] == "assistant"]


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7))


def first_divergences(got: list[str], ref: list[str], tok, logits=None) -> list[dict]:
    """Per response: the first token (as ids) where ``got`` parts from ``ref``,
    None where they are equal. With ``logits`` (``recorded_logits``' lists for
    the run that made ``got``), also the port's top two logits there and the
    fixture token's logit, its gap to the top in bf16 steps."""
    out = []
    for i, (a, b) in enumerate(zip(got, ref)):
        ia, ib = tok.backend.encode(a), tok.backend.encode(b)
        j = next((k for k, (x, y) in enumerate(zip(ia, ib)) if x != y), None)
        if j is None and len(ia) == len(ib):
            out.append(None)
            continue
        j = min(len(ia), len(ib)) if j is None else j
        d = {"response": i, "token": j, "port": ia[j] if j < len(ia) else None,
             "fixture": ib[j] if j < len(ib) else None}
        if logits is not None and i < len(logits) and j < len(logits[i]):
            row = logits[i][j].float()
            top = torch.topk(row, 2)
            d["top2"] = [(int(t), float(v)) for v, t in zip(top.values, top.indices)]
            if d["fixture"] is not None:
                lf = float(row[d["fixture"]])
                d["fixture_logit"] = lf
                d["gap_bf16_steps"] = (d["top2"][0][1] - lf) / bf16_step(d["top2"][0][1])
        out.append(d)
    return out


def score_gaps(got: np.ndarray, ref: np.ndarray, atol: float, rtol: float = RTOL):
    """Largest |got - ref| per column, and whether every value is within
    atol + rtol * |ref| (numpy's assert_allclose rule)."""
    diff = np.abs(got - ref)
    return diff.max(axis=0), bool((diff <= atol + rtol * np.abs(ref)).all())


def build(fixture: str, device="cuda"):
    """(params, cfg, tokenizer, frames) of a fixture's recipe on ``device``."""
    from .config import aha_7b, aha_tiny
    from .models import loader
    from .tokenization import build_stream_tokenizer

    cfg = aha_tiny() if fixture == "tiny" else aha_7b().replace(dtype="bfloat16")
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    if fixture == "tiny":
        params = loader.init_aha_params(cfg, seed=0, device=device)
    else:
        params = loader.materialize_random_params(cfg, "int8", device=device)
    return params, cfg, tok, fixed_frames(cfg.frame_resolution)


def widened(params: dict, cfg):
    """The same weights with every float leaf in f32 and ``cfg.dtype``
    "float32": the function without bf16 rounding (integer leaves shared)."""
    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        return node.float() if node.is_floating_point() else node

    return visit(params), cfg.replace(dtype="float32")


def replay(fixture: str, device="cuda", built=None, texts: bool = True) -> dict:
    """Record the fixture's traces on the port and compare: inputs equal,
    score traces within the fixture's tolerance and (``texts``) the
    generation traces' first divergences. ``built`` is ``build``'s tuple (or
    its f32 ``widened`` form), made here when not given."""
    ref = np.load(FIXTURES[fixture], allow_pickle=False)
    params, cfg, tok, frames = built or build(fixture, device)
    want_sha = (str(ref["frames_sha256"]) if "frames_sha256" in ref.files
                else frames_sha256(ref["frames"]))
    report = {"fixture": fixture, "dtype": cfg.dtype,
              "frames_sha256_equal": frames_sha256(frames) == want_sha,
              "ids_equal": bool(np.array_equal(rendered_ids(tok), ref["ids"]))}
    ok = report["frames_sha256_equal"] and report["ids_equal"]
    for width, key in ((1, "scores"), (4, "scores_fused4")):
        got = score_trace(params, cfg, tok, frames, width, device)
        gap, within = score_gaps(got, ref[key], ATOL[fixture])
        report[key] = {"values": got.tolist(), "max_abs_gap": gap.tolist(),
                       "within_tolerance": within}
        ok = ok and within
    if texts:
        with recorded_logits() as logits:
            seq = gen_trace(params, cfg, tok, frames, 1, 1, device)
        spec = gen_trace(params, cfg, tok, frames, 4, 8, device)
        report["texts_seq_equal_spec"] = seq == spec
        # the speculative texts are the sequential ones, so their logits are too
        for key, got in (("gen_texts_seq", seq), ("gen_texts_spec", spec)):
            report[key] = first_divergences(got, list(ref[key]), tok,
                                            logits if seq == spec or got is seq else None)
            report[key + "_ok"] = texts_ok(fixture, report[key])
            ok = ok and report[key + "_ok"]
        ok = ok and report["texts_seq_equal_spec"]
    report["ok"] = bool(ok)
    return report


def texts_ok(fixture: str, divergences: list) -> bool:
    """``tiny`` (f32): every response equal to the fixture's. ``chip7b``: at
    the first divergence (later responses follow other contexts), the
    fixture's token within 2 bf16 steps of the port's top logit: a tie, not a
    gap."""
    found = [d for d in divergences if d is not None]
    if fixture == "tiny" or not found:
        return not found
    return found[0].get("gap_bf16_steps", float("inf")) <= 2.0


def main(argv=None) -> int:
    import time

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixture", choices=sorted(FIXTURES), required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the plain versions)")
    ap.add_argument("--f32", action="store_true",
                    help="also replay the score traces with the weights widened to f32")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    built = build(args.fixture, args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    print(f"weights built in {time.perf_counter() - t0:.2f}s", file=sys.stderr)
    reports = [replay(args.fixture, args.device, built)]
    if args.f32:
        params, cfg, tok, frames = built
        reports.append(replay(args.fixture, args.device, (*widened(params, cfg), tok, frames),
                              texts=False))
    for r in reports:
        print(json.dumps(r))
    return 0 if all(r["ok"] for r in reports) else 1


if __name__ == "__main__":
    sys.exit(main())
