"""The port's parallelism (aha_tpu_torch/parallel/) in gloo worlds of 2 and 4
ranks on the CPU, one world per size running every case of that size
(tests/_torch_world.py), held against the JAX package's same sharded
computation on its 8-device CPU mesh and against the port's one-rank result:

  * ``forward_hidden`` under TP (model 2; model 4 on the tiny config, whose
    kv heads a rank would cut, so q/k/v are gathered), FSDP (data 2) and
    both (2 x 2): hidden states within 2e-4;
  * GPipe over 2 stages with ragged left padding: within 2e-4;
  * ring attention over 2 and 4 ranks: outputs and the gradients of q, k
    and v within 2e-5 (the ring backward against JAX's AD of ppermute);
  * train steps under FSDP x TP, QLoRA int8 (each rank merging its own
    q/k/v), GPipe (data 2 x pipe 2) and ring (data 2): every loss part within
    5e-4 of JAX's sharded step and 1e-4 of the port's one-rank step, the
    trained leaves within 1e-4 of their largest magnitude;
  * per-host loading (each rank its rows) equal to replicated loading;
  * adapter-dropout masks independent across microbatches and data shards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import LoraConfig as JLoraConfig
from aha_tpu.config import TrainConfig as JTrainConfig
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import quant as jquant
from aha_tpu.parallel import mesh as jmesh
from aha_tpu.parallel.ring_attention import ring_causal_attention as jring
from aha_tpu.train import trainer as jtrainer
from aha_tpu.train.losses import IGNORE

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.models import qwen2
from aha_tpu_torch.parallel.launch import start
from aha_tpu_torch.parallel.ring_attention import ring_causal_attention
from aha_tpu_torch.train import trainer as ttrainer

PARTS = ("total", "lm", "video", "info", "relevance", "tv", "uncertainty")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_mesh(*shape):
    n = int(np.prod(shape))
    return jmesh.make_mesh(*shape, devices=jax.devices()[:n])


# -- inputs, made once from seeds ---------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    params, cfg, tok = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=128), seed=1)
    return params, cfg, tok, port_cfg(cfg)


def fwd_inputs(cfg):
    rng = np.random.default_rng(2)
    B, T = 8, 16
    x = (rng.standard_normal((B, T, cfg.llm.hidden_size)) * 0.1).astype(np.float32)
    mask = np.ones((B, T), bool)
    for b in range(B):                      # row-varying left padding
        mask[b, : b % 4] = False
    pos = np.maximum(np.cumsum(mask.astype(np.int32), axis=1) - 1, 0).astype(np.int32)
    return x, mask, pos


def ring_inputs(n):
    rng = np.random.default_rng(n)
    B, T, H, D = 2, 8 * n, 3, 16
    q, k, v, w = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, T), bool)
    mask[1, :5] = False                     # a left-padded row
    pos = np.maximum(np.cumsum(mask.astype(np.int32), axis=1) - 1, 0).astype(np.int32)
    return q, k, v, pos, mask, w


def numpy_lora(cfg, seed=0, b_scale=0.05):
    from aha_tpu.train import lora as jlora

    rng = np.random.default_rng(seed)
    L, r = cfg.llm.num_layers, 4
    return {name: {"a": (rng.standard_normal((L, din, r)) * 0.1).astype(np.float32),
                   "b": (rng.standard_normal((L, r, dout)) * b_scale).astype(np.float32)}
            for name, (din, dout) in jlora.proj_dims(cfg.llm).items()}


def make_batch(cfg, tok, rng, frames_per_row, even=1):
    """Left-padded rows of a stream and an answer (as the JAX train tests
    build them), right-padded to a multiple of ``even`` tokens."""
    F = cfg.frame_num_tokens
    text_ids = [tok.apply_chat_template([
        {"role": "system", "content": "sys"},
        {"role": "stream", "num_frames": n, "learn": True},
        {"role": "assistant", "content": "ok!", "learn": True}]) for n in frames_per_row]
    L = max(len(x) for x in text_ids)
    B, T = len(text_ids), -(-L // even) * even
    input_ids = np.zeros((B, T), np.int32)
    attn = np.zeros((B, T), bool)
    for i, ids in enumerate(text_ids):
        input_ids[i, L - len(ids):L] = ids
        attn[i, L - len(ids):L] = True
    labels = np.full((B, T), IGNORE, np.int64)
    labels[:, :-1] = np.where(attn[:, 1:], input_ids[:, 1:], IGNORE)
    info = np.full((B, T), IGNORE, np.int64)
    rel = np.full((B, T), float(IGNORE), np.float32)
    ph = input_ids == cfg.v_placeholder_id
    for i in range(B):
        idx = np.where(ph[i])[0][F - 1::F]
        info[i, idx] = rng.integers(0, 2, len(idx))
        rel[i, idx] = rng.random(len(idx))
    r = cfg.frame_resolution
    frames = rng.integers(0, 255, (sum(frames_per_row), r, r, 3)).astype(np.uint8)
    return {"input_ids": input_ids, "attention_mask": attn, "labels": labels,
            "informative_labels": info, "relevance_labels": rel, "frames": frames}


# the train cases: name -> (mesh, trunk, TrainConfig fields, frames a row, token multiple)
TRAIN = {
    "fsdp_tp": ((2, 2), "dense", {}, (2, 3, 2, 3), 1),
    "qlora8": ((2, 2), "int8", {}, (2, 3, 2, 3), 1),
    "gpipe": ((2, 1, 2), "dense", dict(mesh_pipe=2, pipe_microbatches=2), (2, 3, 2, 3), 1),
    "ring": ((2, 1), "dense", dict(ring_attention=True, ring_min_seq=8), (3, 3), 2),
    # 3 rows on data 2: the axis does not divide the batch, so every data rank holds
    # every row (JAX's shard_batch drops ``data`` from the batch's spec)
    "fsdp_b3": ((2, 1), "dense", {}, (2, 3, 2), 1),
}


def train_cfgs(shape, extra):
    # remat "none": JAX compiles its sharded steps in a third of the time
    kw = dict(learning_rate=1e-3, warmup_ratio=0.1, grad_accum_steps=1, weight_decay=0.01,
              remat_policy="none", mesh_data=shape[0], mesh_model=shape[1],
              **({"mesh_pipe": 1} if len(shape) == 2 else {}), **extra)
    one = dict(learning_rate=1e-3, warmup_ratio=0.1, grad_accum_steps=1, weight_decay=0.01,
               remat_policy="none")
    return (JTrainConfig(lora=JLoraConfig(dropout=0.0), **kw),
            tconfig.TrainConfig(lora=tconfig.LoraConfig(dropout=0.0), **kw),
            tconfig.TrainConfig(lora=tconfig.LoraConfig(dropout=0.0), **one))


def trunk(params, kind):
    if kind == "int8":
        return jquant.quantize_params(params, keep_dense=("projector", "lm_head"), bits=8)
    return params


@pytest.fixture(scope="module")
def train_inputs(model):
    params, cfg, tok, tcfg = model
    rng = np.random.default_rng(11)
    out = {name: [make_batch(cfg, tok, rng, rows, even) for _ in range(2)]
           for name, (_, _, _, rows, even) in TRAIN.items()}
    # the second data shard's rows carry no head label: only a decision on the global
    # batch (there are labels) keeps that rank from injecting one
    for b in out["fsdp_tp"]:
        b["informative_labels"][2:] = IGNORE
        b["relevance_labels"][2:] = IGNORE
    return out


# -- the worlds ----------------------------------------------------------------------------


FWD2 = {"tp2": (1, 2), "fsdp2": (2, 1)}
FWD4 = {"tp4": (1, 4), "fsdp_tp": (2, 2)}


def _cases(model, train_inputs, world):
    params, cfg, tok, tcfg = model
    tree = _np(params)
    x, mask, pos = fwd_inputs(cfg)
    lora = numpy_lora(cfg)
    cases = [("collectives", "collectives", dict(n=world))]
    for name, shape in (FWD2 if world == 2 else FWD4).items():
        cases.append((f"fwd_{name}", "forward", dict(tree=tree, cfg=tcfg, x=x, mask=mask,
                                                       pos=pos, shape=shape)))
    if world == 2:
        V = cfg.llm.vocab_size
        rng = np.random.default_rng(4)
        hid = rng.standard_normal((3, cfg.llm.hidden_size)).astype(np.float32)
        cases.append(("vocab", "vocab", dict(tree=tree, cfg=tcfg, ids=np.array([[1, V // 2 - 1,
                      V // 2, V - 1, 5]]), hidden=hid, tie=(7, V // 2 + 7))))
        cases.append(("gpipe_fwd", "forward", dict(tree=tree, cfg=tcfg, x=x, mask=mask, pos=pos,
                                                   shape=(1, 1, 2), n_micro=2)))
    q, k, v, rpos, rmask, w = ring_inputs(world)
    cases.append((f"ring{world}", "ring", dict(q=q, k=k, v=v, pos=rpos, mask=rmask, w=w,
                                               n=world)))
    for name, (shape, kind, extra, _, _) in TRAIN.items():
        if int(np.prod(shape)) != world:
            continue
        _, tc, _ = train_cfgs(shape, extra)
        cases.append((f"train_{name}", "train", dict(
            tree=_np(trunk(params, kind)), lora=lora, cfg=tcfg, tc=tc,
            batches=train_inputs[name], shape=shape, merge=kind == "int8")))
    if world == 4:
        _, tc, _ = train_cfgs((4, 1), {})
        for per_host in (False, True):
            cases.append((f"loading_{'per_host' if per_host else 'replicated'}", "train", dict(
                tree=tree, lora=lora, cfg=tcfg, tc=tc, batches=train_inputs["fsdp_tp"],
                shape=(4, 1), per_host=per_host)))
    return cases


@pytest.fixture(scope="module")
def worlds(model, train_inputs):
    """Both worlds started at once; the references (``refs``) are computed
    while they run."""
    import _torch_world

    return {n: start(_torch_world.run, n, _cases(model, train_inputs, n), timeout=240)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def world2(worlds, refs):
    return worlds[2].result()[0]


@pytest.fixture(scope="module")
def world4(worlds, refs):
    return worlds[4].result()[0]


# -- the references: JAX's sharded computations and the port's one rank ---------------------


def _port_forward(model):
    params, cfg, tok, tcfg = model
    x, mask, pos = fwd_inputs(cfg)
    tp = bridge.params_from_jax(_np(params), device="cpu")
    return qwen2.forward_hidden(tp["llm"], tcfg.llm, torch.as_tensor(x),
                                attn_mask=torch.as_tensor(mask),
                                positions=torch.as_tensor(pos)).numpy()


def _jax_forward(model, shape, pipe=None):
    params, cfg, _, _ = model
    x, mask, pos = fwd_inputs(cfg)
    m = jax_mesh(*shape)
    llm = jmesh.apply_named_sharding(params["llm"], m)
    kw = {} if pipe is None else {"pipe": (m, "pipe", pipe)}
    return np.asarray(jax.jit(lambda p, a, b, c: jqwen2.forward_hidden(
        p, cfg.llm, a, attn_mask=b, positions=c, **kw))(llm, x, mask, pos))


def _ring_refs(n):
    """JAX's ring on n CPU devices (its backward: AD of ppermute) and the
    port's ring at one rank: (out, dq, dk, dv) of sum(out * w) each."""
    q, k, v, pos, mask, w = ring_inputs(n)
    m = jax_mesh(n, 1)

    def f(a, b, c):
        o = jring(a, b, c, m, seq_axis="data", positions=jnp.asarray(pos),
                  attn_mask=jnp.asarray(mask))
        return (o * w).sum(), o

    (_, jo), jg = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o1 = ring_causal_attention(tq, tk, tv, None, positions=torch.as_tensor(pos),
                               attn_mask=torch.as_tensor(mask))
    (o1 * torch.as_tensor(w)).sum().backward()
    return ([np.asarray(t) for t in (jo, *jg)],
            [t.detach().numpy() for t in (o1, tq.grad, tk.grad, tv.grad)])


def _jax_steps(model, name, batches):
    params, cfg, tok, _ = model
    shape, kind, extra, _, _ = TRAIN[name]
    jc, _, _ = train_cfgs(shape, extra)
    p = jax.tree.map(jnp.array, trunk(params, kind))
    state, tx, labels, scale = jtrainer.init_train_state(
        cfg, jc, p, total_steps=20, lora_init=jax.tree.map(jnp.asarray, numpy_lora(cfg)))
    m = jax_mesh(*shape)
    state = jtrainer.TrainState(tree=jmesh.apply_named_sharding(state.tree, m),
                                opt_state=state.opt_state, step=state.step)
    step = jtrainer.make_train_step(cfg, jc, tx, labels, scale, device_mesh=m)
    parts = []
    for b in batches:
        state, jp = step(state, jmesh.shard_batch(b, m))
        parts.append({k: float(getattr(jp, k)) for k in PARTS})
    return parts


def _port_one_rank(model, name, batches):
    params, cfg, tok, tcfg = model
    shape, kind, extra, _, _ = TRAIN.get(name, ((4, 1), "dense", {}, None, None))
    _, _, tc1 = train_cfgs(shape, extra)
    state, tx, labels, scale = ttrainer.init_train_state(
        tcfg, tc1, bridge.params_from_jax(_np(trunk(params, kind)), device="cpu"),
        total_steps=20, device="cpu",
        lora_init=bridge.params_from_jax(numpy_lora(cfg), device="cpu"))
    step = ttrainer.make_train_step(tcfg, tc1, tx, labels, scale, device="cpu")
    parts = []
    for b in batches:
        state, p = step(state, b)
        parts.append({k: float(v) for k, v in vars(p).items()})
    return parts, {n: t.detach().numpy()
                   for n, t in ttrainer.trained_leaves(state.tree, labels).items()}


@pytest.fixture(scope="module")
def refs(worlds, model, train_inputs):
    """JAX's programs compile on threads of their own, side by side (XLA
    releases the interpreter lock while it compiles)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(4) as pool:
        fwd = {name: pool.submit(_jax_forward, model, shape)
               for name, shape in {**FWD2, **FWD4}.items()}
        gpipe = pool.submit(_jax_forward, model, (1, 1, 2), pipe=2)
        ring = {n: pool.submit(_ring_refs, n) for n in (2, 4)}
        jtrain = {name: pool.submit(_jax_steps, model, name, train_inputs[name])
                  for name in TRAIN}
        out = {"fwd": {k: f.result() for k, f in fwd.items()}, "gpipe": gpipe.result(),
               "ring": {k: f.result() for k, f in ring.items()}}
        jtrain = {k: f.result() for k, f in jtrain.items()}
    out.update(one_fwd=_port_forward(model),
               train={name: (jtrain[name], _port_one_rank(model, name, train_inputs[name]))
                      for name in TRAIN},
               loading=_port_one_rank(model, "loading", train_inputs["fsdp_tp"]))
    return out


# -- forward ---------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tp2", "fsdp2", "tp4", "fsdp_tp"])
def test_forward_hidden_sharded(refs, world2, world4, name):
    """TP, FSDP and both; at model 4 the tiny config's 2 kv heads (32
    columns) would give a rank half a head, so the port gathers q/k/v over
    ``model`` and attends with every head (the o and mlp products stay
    split)."""
    got = (world2 if name in FWD2 else world4)[f"fwd_{name}"]
    np.testing.assert_allclose(got, refs["fwd"][name], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, refs["one_fwd"], rtol=2e-4, atol=2e-4)


def test_gpipe_forward(refs, world2):
    """2 stages, 2 microbatches, row-varying left padding (the mask and the
    positions travel with each microbatch)."""
    got = world2["gpipe_fwd"]
    np.testing.assert_allclose(got, refs["gpipe"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, refs["one_fwd"], rtol=2e-4, atol=2e-4)


def test_sharded_vocabulary(model, world2):
    """Model 2 splits the embedding table and the lm_head by vocabulary: a
    lookup of ids on both halves equals the whole table's; logits whose top
    ties between a column of each half take the lower index, as argmax over
    the whole row does."""
    params, cfg, tok, tcfg = model
    emb, logits, top = world2["vocab"]
    V = cfg.llm.vocab_size
    tp = bridge.params_from_jax(_np(params), device="cpu")
    ids = torch.tensor([[1, V // 2 - 1, V // 2, V - 1, 5]])
    np.testing.assert_array_equal(emb, qwen2.embed_tokens(tp["llm"], ids, torch.float32).numpy())
    w = tp["llm"]["lm_head"]["kernel"]
    rng = np.random.default_rng(4)
    hid = torch.as_tensor(rng.standard_normal((3, cfg.llm.hidden_size)).astype(np.float32))
    w[:, 7] = w[:, V // 2 + 7] = hid[0]
    want = qwen2.lm_logits(tp["llm"], tcfg.llm, hid).numpy()
    np.testing.assert_allclose(logits, want, rtol=1e-6, atol=1e-6)
    assert logits[0, 7] == logits[0, V // 2 + 7] == logits[0].max()
    assert top[0] == 7 and (top == np.argmax(want, axis=-1)).all()


# -- ring attention --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_ring_attention(refs, world2, world4, n):
    """Outputs and the gradients of sum(out * w) against JAX's ring on n CPU
    devices (its backward is AD of ppermute) and against the port's ring at
    one rank (the same blockwise arithmetic, no exchange)."""
    got = (world2 if n == 2 else world4)[f"ring{n}"]
    jax_ref, one = refs["ring"][n]
    for g, want_j, want_1 in zip(got, jax_ref, one):
        np.testing.assert_allclose(g, want_j, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(g, want_1, rtol=2e-5, atol=2e-5)


# -- train steps -----------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_sharded(refs, world2, world4, name):
    """Two micro-steps (the first at rate 0 under the warmup) from a bridged
    state with adapters whose B is not zero: the loss parts against JAX's
    sharded step on the same mesh and the port's one-rank step, the trained
    leaves against the port's one-rank step."""
    shape = TRAIN[name][0]
    parts, leaves = (world2 if int(np.prod(shape)) == 2 else world4)[f"train_{name}"]
    jparts, (one_parts, one_leaves) = refs["train"][name]
    for i in range(len(jparts)):
        for k in PARTS:
            np.testing.assert_allclose(parts[i][k], jparts[i][k], atol=5e-4,
                                       err_msg=f"step {i} {k} vs JAX")
            np.testing.assert_allclose(parts[i][k], one_parts[i][k], atol=1e-4,
                                       err_msg=f"step {i} {k} vs one rank")
    assert set(leaves) == set(one_leaves)
    for n, ref in one_leaves.items():
        np.testing.assert_allclose(leaves[n], ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=n)


def test_per_host_loading_equals_replicated(refs, world4):
    """data 4: each rank passing only its rows (per-host loading) takes the
    steps that every rank passing the whole batch takes, and both the port's
    one-rank steps."""
    rep_parts, rep = world4["loading_replicated"]
    host_parts, host = world4["loading_per_host"]
    assert rep_parts == host_parts
    for n in rep:
        np.testing.assert_array_equal(rep[n], host[n], err_msg=n)
    one_parts, _ = refs["loading"]
    for i in range(2):
        for k in PARTS:
            np.testing.assert_allclose(rep_parts[i][k], one_parts[i][k], atol=1e-4)


# -- the collectives ----------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_collectives(world2, world4, n):
    """Gathers along dims 0 and 1, broadcast, all-reduce (sum, max),
    reduce-scatter and send / recv over gloo, on the types it carries
    packed as int32 words and those it carries widened: exact (a 16-bit sum:
    f32 in rank order, rounded once; an f32 sum in gloo's own order, to an
    ulp), the input's dtype back."""
    res = (world2 if n == 2 else world4)["collectives"]
    assert len(res) == 6 * 3 + 2 * 2 + 2
    for k, (got, want, gdt, wdt) in res.items():
        assert gdt == wdt, k
        if k.endswith("_f32") and k.split("_")[0] in ("sum", "scatter"):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


# -- dropout under sharding ---------------------------------------------------------------------


def test_dropout_masks_independent_across_shards_and_microbatches():
    """A mask is drawn on the global [B, T, K] shape and each data shard or
    microbatch takes its rows of it, a row-parallel product its columns: every
    part equals the one-rank mask's, so identical rows in different shards or
    microbatches get different masks (JAX folds (data shard, microbatch) into
    the key for the same end: tests/test_pipeline_parallel.py)."""
    from aha_tpu_torch.models.qwen2 import LayerAdapters
    from aha_tpu_torch.parallel.mesh import Mesh
    from aha_tpu_torch.parallel.sharded import Shard

    L, K, r = 2, 8, 2
    lora = {"q_proj": {"a": torch.zeros(L, K, r), "b": torch.zeros(L, r, K)}}
    B, T = 8, 5
    x = torch.ones(1, T, K).expand(B, T, K)            # identical rows
    whole = LayerAdapters(lora, 1, 1.0, dropout=0.5, seed=7)._mask("q_proj", x, None)
    assert not all(torch.equal(whole[0], whole[b]) for b in range(1, B))
    for d, mb in ((2, 1), (1, 2), (2, 2)):             # data shards x microbatches
        n = B // (d * mb)
        parts = []
        for rank in range(d):
            for m in range(mb):
                r0 = rank * (B // d) + m * n
                sh = Shard(Mesh(d, 1, rank=rank, groups=False), {}, rows=(r0, B))
                ad = LayerAdapters(lora, 1, 1.0, dropout=0.5, seed=7, sh=sh)
                parts.append(ad._mask("q_proj", x[:n], None))
        assert torch.equal(torch.cat(parts), whole)
        assert not torch.equal(parts[0], parts[1])
    # a row-parallel product's input columns: each model rank its slice
    cols = [LayerAdapters(lora, 1, 1.0, dropout=0.5, seed=7,
                          sh=Shard(Mesh(1, 2, rank=i, groups=False), {}))._mask(
        "q_proj", x[..., :K // 2], "row") for i in range(2)]
    assert torch.equal(torch.cat(cols, dim=-1), whole)
