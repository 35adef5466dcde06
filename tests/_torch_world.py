"""What each rank of a gloo world runs for tests/test_torch_parallel.py: the
port's sharded forward, GPipe, ring attention and train steps, on inputs the
test process made (numpy trees and arrays). Imports no JAX: the ranks are
fresh processes (``aha_tpu_torch.parallel.launch.spawn``). Rank 0 returns
every case's result, gathered whole; the other ranks return nothing."""

import numpy as np
import torch

from aha_tpu_torch import bridge
from aha_tpu_torch.models import qwen2
from aha_tpu_torch.parallel import mesh as mesh_lib
from aha_tpu_torch.parallel.sharded import Shard, place


def _rows(B, mesh):
    r = mesh_lib.local_rows(B, mesh)
    return (0, B) if r is None else r


def _gather_rows(h, mesh, B):
    return mesh.comm("data").all_gather(h, 0) if h.shape[0] != B else h


def forward(tree, cfg, x, mask, pos, shape, n_micro=0):
    """qwen2.forward_hidden on a (data, model[, pipe]) mesh: every row's
    hidden states."""
    mesh = mesh_lib.make_mesh(*shape)
    params = bridge.params_from_jax(tree, device="cpu")
    local, specs = place(params, mesh, q_dim=cfg.llm.q_dim, kv_dim=cfg.llm.kv_dim)
    x, mask, pos = (torch.as_tensor(a) for a in (x, mask, pos))
    B = x.shape[0]
    r0, r1 = _rows(B, mesh)
    sh = Shard(mesh, specs["llm"], rows=(r0, B) if (r0, r1) != (0, B) else None)
    pipe = (mesh, "pipe", n_micro) if n_micro else None
    h = qwen2.forward_hidden(local["llm"], cfg.llm, x[r0:r1], attn_mask=mask[r0:r1],
                             positions=pos[r0:r1], sh=sh, pipe=pipe)
    return _gather_rows(h, mesh, B).numpy()


def ring(q, k, v, pos, mask, w, n):
    """ring_causal_attention over n ranks: (out, dq, dk, dv) of sum(out * w),
    every stretch gathered."""
    from aha_tpu_torch.parallel.ring_attention import ring_causal_attention

    mesh = mesh_lib.make_mesh(n, 1)
    comm = mesh.comm("data")
    T = q.shape[1]
    t0, t1 = comm.index * T // n, (comm.index + 1) * T // n
    q, k, v = (torch.tensor(a[:, t0:t1], requires_grad=True) for a in (q, k, v))
    out = ring_causal_attention(q, k, v, comm, positions=torch.as_tensor(pos[:, t0:t1]),
                                attn_mask=torch.as_tensor(mask[:, t0:t1]))
    (out * torch.as_tensor(w[:, t0:t1])).sum().backward()
    return tuple(comm.all_gather(t.detach(), 1).numpy() for t in (out, q.grad, k.grad, v.grad))


def train(tree, lora, cfg, tc, batches, shape, merge=False, per_host=False):
    """train steps on a mesh from a bridged state: each step's loss parts and
    the trained leaves gathered whole."""
    from aha_tpu_torch.ops import quant
    from aha_tpu_torch.train.trainer import (_spec_at, _whole, init_train_state,
                                             make_train_step, trained_leaves)

    mesh = mesh_lib.make_mesh(*shape)
    params = bridge.params_from_jax(tree, device="cpu")
    if merge:
        params = {**params, "llm": quant.merge_decoder_projections(params["llm"])}
    state, tx, labels, scale = init_train_state(
        cfg, tc, params, total_steps=20, device="cpu", device_mesh=mesh,
        lora_init=bridge.params_from_jax(lora, device="cpu"))
    step = make_train_step(cfg, tc, tx, labels, scale, device="cpu", device_mesh=state.mesh)
    parts = []
    for batch in batches:
        if per_host:
            batch = mesh_lib.shard_batch(batch, mesh, placeholder=cfg.v_placeholder_id,
                                         frame_tokens=cfg.frame_num_tokens)
            state, p = step(state, batch, per_host=True)
        else:
            state, p = step(state, batch)
        parts.append({k: float(v) for k, v in vars(p).items()})
    leaves = {n: _whole(t.detach(), _spec_at(state.specs, n), mesh).numpy()
              for n, t in trained_leaves(state.tree, labels).items()}
    return parts, leaves


def collectives(n):
    """Every collective of ``parallel.comm.Comm`` over n ranks, on the dtypes
    gloo carries packed (uint8, int8, bf16 rows of a multiple of 4 bytes) or
    widened (odd rows, bool) and on f32: what rank 0 got and what it should
    have got."""
    mesh = mesh_lib.make_mesh(n, 1)
    c = mesh.comm("data")
    r = c.index
    got, want = {}, {}
    g = torch.Generator().manual_seed(0)
    base = {"u8": torch.randint(0, 256, (n, 3, 8), generator=g).to(torch.uint8),
            "i8": torch.randint(-127, 128, (n, 3, 5), generator=g).to(torch.int8),
            "bf16": torch.randn(n, 3, 6, generator=g).to(torch.bfloat16),
            "bf16_odd": torch.randn(n, 3, 1, generator=g).to(torch.bfloat16),
            "bool": torch.rand(n, 3, 7, generator=g) > 0.5,
            "f32": torch.randn(n, 3, 5, generator=g)}
    for k, t in base.items():
        got[f"gather0_{k}"] = c.all_gather(t[r], 0)
        want[f"gather0_{k}"] = torch.cat(list(t), 0)
        got[f"gather1_{k}"] = c.all_gather(t[r], 1)
        want[f"gather1_{k}"] = torch.cat(list(t), 1)
        got[f"broadcast_{k}"] = c.broadcast(t[r], n - 1)
        want[f"broadcast_{k}"] = t[n - 1]
    for k in ("bf16", "f32"):
        t = base[k]
        got[f"sum_{k}"] = c.all_reduce(t[r])
        want[f"sum_{k}"] = t.float().sum(0).to(t.dtype)
        got[f"scatter_{k}"] = c.reduce_scatter(torch.cat([t[r]] * n, 0), 0)
        want[f"scatter_{k}"] = t.float().sum(0).to(t.dtype)
    got["max_i32"] = c.all_reduce(torch.tensor([r], dtype=torch.int32), "max")
    want["max_i32"] = torch.tensor([n - 1], dtype=torch.int32)
    if r == 0:
        for i in range(1, n):
            c.send(base["bf16"][0], i)
        got["sendrecv"] = want["sendrecv"] = base["bf16"][0]
    else:
        got["sendrecv"] = c.recv(base["bf16"][0], 0)
        want["sendrecv"] = base["bf16"][0]
    return {k: (got[k].float().numpy(), want[k].float().numpy(), str(got[k].dtype),
                str(want[k].dtype)) for k in got}


def vocab(tree, cfg, ids, hidden, tie):
    """Model 2: the embedding lookup of ids on both halves of the vocabulary,
    and the lm_head's logits where two columns, one a half, tie at the top."""
    mesh = mesh_lib.make_mesh(1, 2)
    params = bridge.params_from_jax(tree, device="cpu")
    w = params["llm"]["lm_head"]["kernel"]
    # two equal columns, one on either side of the split, at the top of row 0
    w[:, tie[0]] = w[:, tie[1]] = torch.as_tensor(hidden[0])
    local, specs = place(params, mesh, q_dim=cfg.llm.q_dim, kv_dim=cfg.llm.kv_dim)
    sh = Shard(mesh, specs["llm"])
    emb = qwen2.embed_tokens(local["llm"], torch.as_tensor(ids), torch.float32, sh)
    logits = qwen2.lm_logits(local["llm"], cfg.llm, torch.as_tensor(hidden), sh=sh)
    return emb.numpy(), logits.numpy(), torch.argmax(logits, dim=-1).numpy()


def run(rank, world, device, cases):
    """Every case, in order, on every rank; rank 0 returns name -> result."""
    torch.set_num_threads(1)
    out = {}
    for name, fn, kw in cases:
        out[name] = globals()[fn](**kw)
    return out if rank == 0 else {}


# -- serving (tests/test_torch_sharded_serving.py) ----------------------------------------


def engine(tree, cfg, frames, prompts, gen, width, shape=None, policy=None):
    """StreamEngine on a mesh (None: one rank): the prompt chunk, score_stream
    over the frames, generate, then serve_step from a reset cache; every
    result as numpy."""
    from aha_tpu_torch.ops.kv_cache import CachePolicy
    from aha_tpu_torch.streaming.engine import StreamEngine

    mesh = None if shape is None else mesh_lib.make_mesh(*shape)
    params = bridge.params_from_jax(tree, device="cpu")
    B, T = len(prompts), frames.shape[0] // len(prompts)
    eng = StreamEngine(params, cfg, CachePolicy(**policy), device="cpu", batch=B,
                       fused_score_frames=width, spec_tokens=width, max_new_tokens=6, mesh=mesh)
    fe = eng.encode_frames(frames).reshape(B, T, cfg.frame_num_tokens, -1)
    cache = eng.new_cache()
    logits = eng.append_ids(cache, prompts)
    scores = eng.score_stream(cache, fe)
    ids, n, _, _ = eng.generate(cache, gen, eng.new_rep_counts())
    res = eng.serve_step(eng.reset_cache(cache), [[] for _ in range(B)], np.ones(B, bool), fe,
                         np.zeros(B, np.int64), np.full(B, T, np.int64), np.zeros(B),
                         eng.new_rep_counts(), 0.3, None,
                         ("informative_score", "relevance_score"), gen[0])
    return {"logits": logits.numpy(), "scores": scores.numpy(), "ids": ids.numpy(),
            "n": n.numpy(), "serve_scores": res[0].cpu().numpy(), "serve_next": np.asarray(res[1]),
            "serve_fired": np.asarray(res[3]), "serve_ids": res[4].cpu().numpy(),
            "serve_n": res[5].cpu().numpy()}


def server(tree, cfg, tok, icfg, items, batch, max_frames, shape=None):
    """MultiStreamServer.run_items on a mesh (None: one rank)."""
    from aha_tpu_torch.streaming.multi import MultiStreamServer

    mesh = None if shape is None else mesh_lib.make_mesh(*shape)
    params = bridge.params_from_jax(tree, device="cpu")
    return MultiStreamServer(params, cfg, tok, icfg, batch=batch, max_frames=max_frames,
                             device="cpu", mesh=mesh).run_items(items, fps=1.0)


def serve_cli(argv):
    """``python -m aha_tpu_torch.cli serve`` on this rank (rank 0 writes)."""
    from aha_tpu_torch.cli import main

    return main(argv)


# -- the train command (tests/test_torch_dist_cli.py) ---------------------------------------


def train_cli(argv):
    """``python -m aha_tpu_torch.cli train`` on this rank, the global
    ``random`` seeded first (the grounding templates are drawn from it)."""
    import random

    from aha_tpu_torch.cli.train import cmd_train

    random.seed(0)
    state = cmd_train(argv)
    return state.step
