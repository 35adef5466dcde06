"""A sharded run of every parallel path on n ranks, one process a rank: the
port's counterpart of ``__graft_entry__.py::dryrun_multichip``.

    python -m aha_tpu_torch.dryrun_multichip --n 4               # on the card(s)
    python -m aha_tpu_torch.dryrun_multichip --n 4 --device cpu  # gloo on the host

What JAX's dryrun runs, on the tiny preset at random weights: an FSDP x TP
train step (data n/2 x model 2), the QLoRA step on an int8 trunk, GPipe (data
2 x pipe 2, 2 microbatches), ring attention over data n at ``ring_min_seq`` 32
(T 64), the sharded engine's ``score_stream`` (fused 2), ``generate``
(speculative 2) and ``serve_step``, ``MultiStreamServer`` with 2n ragged
streams over n slots, and the 7B-shape check: ``param_specs`` and every
rank's local shapes at 7B (int8) on the ``meta`` device, nothing
materialised, with each split held to whole heads and whole int4 groups. Each
step's losses are finite; rank 0 prints a line a path. On the card each rank
takes a card of its own where there are as many (NCCL), else the ranks share
``cuda:0`` over gloo.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def _batch(cfg, tok, B: int, n_frames: int = 2):
    from .data.collator import collate
    from .data.conversations import build_example

    examples = []
    for i in range(B):
        conv = [{"role": "user", "content": f"query {i}"},
                {"role": "stream", "num_frames": n_frames, "learn": True,
                 "related": [{"related": True, "num_frames": n_frames}]},
                {"role": "assistant", "content": "ok", "learn": True}]
        ex = build_example(conv, tok, system_prompt="sys")
        r = cfg.frame_resolution
        ex.frames = np.random.default_rng(i).integers(0, 255, (n_frames, r, r, 3)).astype(np.uint8)
        examples.append(ex)
    return collate(examples, tok, v_placeholder_id=cfg.v_placeholder_id,
                   frame_num_tokens=cfg.frame_num_tokens, len_buckets=(256,),
                   frame_buckets=(B * n_frames,)).asdict()


def _step(cfg, train_cfg, params, batch, mesh, device) -> float:
    from .train.trainer import init_train_state, make_train_step

    state, tx, labels, scale = init_train_state(cfg, train_cfg, params, total_steps=2,
                                                device=device, device_mesh=mesh)
    step = make_train_step(cfg, train_cfg, tx, labels, scale, device=device,
                           device_mesh=state.mesh)
    state, parts = step(state, batch)
    total = float(parts.total)
    if not np.isfinite(total):
        raise AssertionError(f"loss {total}")
    return total


def check_7b_shapes(mesh) -> tuple[int, int]:
    """``param_specs`` of the 7B int8 tree (and int4's) on ``mesh``, every local
    shape computed on the meta device; each split over ``model`` must keep
    heads and int4 groups whole on a rank. Returns (leaves, sharded leaves)."""
    import torch

    from .config import aha_7b
    from .models.loader import leaf_specs
    from .parallel.mesh import local_shape, param_specs

    cfg = aha_7b()
    q = cfg.llm
    n = sharded = 0
    for mode in ("int8", "int4"):
        tree: dict = {}
        for path, shape, dtype in leaf_specs(cfg, mode):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = torch.empty(shape, dtype=dtype, device="meta")
        specs = param_specs(tree, mesh)
        M = mesh.shape["model"]

        def visit(node, sp, path):
            nonlocal n, sharded
            if isinstance(node, dict):
                for k in node:
                    visit(node[k], sp[k], path + (k,))
                return
            n += 1
            loc = local_shape(tuple(node.shape), sp, mesh)
            if loc != tuple(node.shape):
                sharded += 1
            name = "/".join(path)
            if "model" in sp and M > 1:
                d = list(sp).index("model")
                if name.startswith("llm/layers/") and path[2] in ("q_proj", "k_proj", "v_proj"):
                    heads = (q.num_heads if path[2] == "q_proj" else q.num_kv_heads)
                    if heads % M:
                        raise AssertionError(f"{name}: {heads} heads cut over model={M}")
                if path[-1] in ("q4value", "scale4") and d == len(sp) - 2:
                    K = node.shape[-2] * (2 if path[-1] == "q4value" else 128)
                    if (K // M) % 128:
                        raise AssertionError(f"{name}: a rank's K {K // M} cuts int4 groups")
        visit(tree, specs, ())
    return n, sharded


def run_rank(rank: int, world: int, device: str) -> list[str]:
    """Every path of the dryrun on this rank; returns rank 0's lines."""
    import torch

    from .config import InferConfig, TrainConfig, aha_tiny
    from .models import loader
    from .ops import quant
    from .ops.kv_cache import CachePolicy
    from .parallel.mesh import Mesh, make_mesh
    from .streaming.engine import StreamEngine
    from .streaming.multi import MultiStreamServer
    from .tokenization import build_stream_tokenizer

    n = world
    lines = []
    say = lines.append
    dev = torch.device(device if device == "cpu" else "cuda")
    cfg = aha_tiny(vocab_size=512)
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = loader.init_aha_params(cfg, seed=0, device=dev)

    model_ax = 2 if n % 2 == 0 and n > 1 else 1
    m = make_mesh(n // model_ax, model_ax)
    batch = _batch(cfg, tok, n)
    tc = TrainConfig(grad_accum_steps=1, mesh_data=n // model_ax, mesh_model=model_ax)
    total = _step(cfg, tc, params, batch, m, dev)
    say(f"dryrun_multichip({n}): mesh={m.shape} loss={total:.4f}")

    qparams = quant.quantize_params(params, keep_dense=("projector", "lm_head"))
    qparams = {**qparams, "llm": quant.merge_decoder_projections(qparams["llm"])}
    total = _step(cfg, tc, qparams, batch, m, dev)
    say(f"dryrun_multichip({n}): QLoRA (int8 trunk) step ok loss={total:.4f}")

    if n == 4:
        pp_cfg = TrainConfig(grad_accum_steps=1, mesh_data=2, mesh_model=1, mesh_pipe=2,
                             pipe_microbatches=2)
        total = _step(cfg, pp_cfg, params, batch, make_mesh(2, 1, 2), dev)
        say(f"dryrun_multichip({n}): GPipe (data=2 x pipe=2) step ok loss={total:.4f}")

    if n >= 2:
        ring_cfg = TrainConfig(grad_accum_steps=1, mesh_data=n, mesh_model=1,
                               ring_attention=True, ring_min_seq=32)
        rng = np.random.default_rng(3)
        B_r, T_r, V = n, 64, cfg.llm.vocab_size
        ring_batch = {"input_ids": rng.integers(1, V, (B_r, T_r)),
                      "attention_mask": np.ones((B_r, T_r), np.int32),
                      "labels": rng.integers(1, V, (B_r, T_r)),
                      "informative_labels": np.full((B_r, T_r), -100, np.int32),
                      "relevance_labels": np.full((B_r, T_r), -100.0, np.float32)}
        ring_batch["informative_labels"][:, 10] = 1
        ring_batch["relevance_labels"][:, 10] = 0.5
        total = _step(cfg, ring_cfg, params, ring_batch, make_mesh(n, 1), dev)
        say(f"dryrun_multichip({n}): ring-attention (seq-parallel x{n}) train step ok "
            f"loss={total:.4f}")

    policy = CachePolicy("sink", window=32, num_sink=4)
    B = n
    eng = StreamEngine(params, cfg, policy, device=dev, batch=B, max_new_tokens=4, mesh=m,
                       spec_tokens=2, fused_score_frames=2)
    r = cfg.frame_resolution
    frames = np.random.default_rng(7).integers(0, 255, (3, r, r, 3), np.uint8)
    embeds = eng.encode_frames(frames)
    stacked = embeds[None].expand(B, *embeds.shape).contiguous()
    cache = eng.new_cache()
    scores = eng.score_stream(cache, stacked)
    if not torch.isfinite(scores).all():
        raise AssertionError("score_stream: non-finite scores")
    out_ids, out_len, _, _ = eng.generate(cache, [[3, 4, 5]] * B, eng.new_rep_counts())
    if int(out_len.min()) < 1:
        raise AssertionError("generate: a row wrote nothing")
    T = stacked.shape[1]
    res = eng.serve_step(
        eng.reset_cache(cache), [[] for _ in range(B)], np.ones(B, bool), stacked,
        np.zeros(B, np.int64), np.full(B, T, np.int64), np.zeros(B), eng.new_rep_counts(),
        0.0, None, ("informative_score", "relevance_score"), [3, 4], do_generate=True)
    trig, sout_len = np.asarray(res[3]), res[5].cpu().numpy()
    if not trig.any() or int(sout_len.max()) < 1:
        raise AssertionError("serve_step: no row fired and decoded")
    say(f"dryrun_multichip({n}): sharded serve_step ok (responses {sout_len.tolist()})")
    say(f"dryrun_multichip({n}): sharded inference ok (scores {tuple(scores.shape)}, "
        f"decoded {out_len.tolist()})")

    icfg = InferConfig(stream_end_prob_threshold=0.5, frame_fps=1.0, kv_cache_policy="sink",
                       kv_window=32, num_sink_tokens=4, max_new_tokens=4,
                       spec_decode_tokens=2, spec_decode_tokens_max=None, fused_score_frames=2)
    srv = MultiStreamServer(params, cfg, tok, icfg, batch=B, max_frames=4, device=dev, mesh=m)
    srv.engine.encode_frames = lambda v: v          # pre-encoded embeds
    srv_rng = np.random.default_rng(11)
    items = []
    for j in range(2 * B):                          # ragged 2..4-frame streams
        k = 2 + j % 3
        e = torch.as_tensor(0.05 * srv_rng.standard_normal(
            (k, cfg.frame_num_tokens, cfg.llm.hidden_size)), dtype=torch.float32, device=dev)
        items.append((j, e, [{"role": "user", "content": f"q{j}", "time": 0.0}]))
    out = srv.run_items(items, fps=1.0)
    if len(out) != 2 * B:
        raise AssertionError(f"{len(out)} streams served of {2 * B}")
    n_resp = sum(len([t for t in v["responses"] if t["role"] == "assistant"])
                 for v in out.values())
    n_dbg = sum(len(v["debug_data"]) for v in out.values())
    if n_dbg != sum(2 + j % 3 for j in range(2 * B)):
        raise AssertionError(f"{n_dbg} frames scored")
    say(f"dryrun_multichip({n}): sharded continuous-batching server ok ({len(out)} streams "
        f"over {B} slots, {n_resp} responses, {n_dbg} frames)")

    leaves, sharded = check_7b_shapes(Mesh(n // model_ax, model_ax, groups=False,
                                           rank=m.rank))
    say(f"dryrun_multichip({n}): 7B-shape specs ok ({leaves} leaves, {sharded} sharded on "
        f"mesh {n // model_ax}x{model_ax}, nothing materialised)")
    return lines if rank == 0 else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=4, help="ranks (processes)")
    ap.add_argument("--device", default="cuda",
                    help="the card (default) or 'cpu' (gloo on the host)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a collective may wait before the run fails")
    args = ap.parse_args(argv)
    import torch

    from .parallel.launch import spawn

    if args.device != "cpu" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    results = spawn(run_rank, args.n, device=args.device, timeout=args.timeout,
                    threads=1 if args.device == "cpu" else 4)
    for line in results[0]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
