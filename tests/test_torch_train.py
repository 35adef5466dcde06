"""The port's training slice against the JAX package at the tiny preset, f32,
on the CPU; every input (weights, adapters, batches) comes from numpy or from
the JAX side and is handed to both. ``forward_hidden`` with adapters over
dense, int4 and merged-int4 trunks, rematerialisation, ``forward_train`` and
every part of the loss with its quirks, the padded-batch divergence, three
steps of the train step against JAX's from a bridged state, dropout, and
checkpoints. Parity runs at ``lora_dropout=0``: the two frameworks' masks
agree in distribution only."""

import copy
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import config as jconfig
from aha_tpu.models import aha as jaha
from aha_tpu.models import qwen2 as jqwen2
from aha_tpu.ops import quant as jquant
from aha_tpu.train import lora as jlora
from aha_tpu.train import losses as jlosses
from aha_tpu.train import optimizer as joptimizer
from aha_tpu.train import trainer as jtrainer

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.models import aha as taha
from aha_tpu_torch.models import qwen2 as tqwen2
from aha_tpu_torch.train import lora as tlora
from aha_tpu_torch.train import losses as tlosses
from aha_tpu_torch.train import optimizer as toptimizer
from aha_tpu_torch.train import trainer as ttrainer

IGNORE = -100
ATOL = 1e-5
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return bridge.tensor_from_numpy(np.asarray(x))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_cfg(cfg):
    """The port's own AhaConfig from the JAX package's, field by field."""
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def both_train_cfgs(**kw):
    """The same TrainConfig for both packages (lora_dropout given as ``dropout``)."""
    dropout = kw.pop("dropout", 0.0)
    return (jconfig.TrainConfig(lora=jconfig.LoraConfig(dropout=dropout), **kw),
            tconfig.TrainConfig(lora=tconfig.LoraConfig(dropout=dropout), **kw))


@pytest.fixture(scope="module")
def tiny():
    params, cfg, tok = jaha.build_model_and_tokenizer(jconfig.aha_tiny(vocab_size=128), seed=1)
    return params, cfg, tok


@pytest.fixture(scope="module")
def qlora(tiny):
    """The tiny model as QLoRA trains it: int4 trunk, int8 table, projector
    and lm_head dense."""
    params, cfg, tok = tiny
    return jquant.quantize_params(params, keep_dense=("projector", "lm_head"), bits=4), cfg, tok


def numpy_lora(cfg, seed=0, b_scale=0.05):
    """An adapter tree with B != 0, from numpy."""
    rng = np.random.default_rng(seed)
    L, r = cfg.llm.num_layers, 4
    return {name: {"a": (rng.standard_normal((L, din, r)) * 0.1).astype(np.float32),
                   "b": (rng.standard_normal((L, r, dout)) * b_scale).astype(np.float32)}
            for name, (din, dout) in jlora.proj_dims(cfg.llm).items()}


def make_batch(cfg, tok, rng, frames_per_row=(3, 3)):
    """Builds a batch as the JAX train tests do; rows with different frame
    counts give a left-padded batch."""
    F = cfg.frame_num_tokens
    text_ids = [tok.apply_chat_template([
        {"role": "system", "content": "sys"},
        {"role": "stream", "num_frames": n, "learn": True},
        {"role": "assistant", "content": "ok!", "learn": True}]) for n in frames_per_row]
    B, T = len(text_ids), max(len(x) for x in text_ids)
    input_ids = np.zeros((B, T), np.int32)
    attn = np.zeros((B, T), bool)
    for i, ids in enumerate(text_ids):
        input_ids[i, T - len(ids):] = ids
        attn[i, T - len(ids):] = True
    labels = np.full((B, T), IGNORE, np.int64)
    labels[:, :-1] = np.where(attn[:, 1:], input_ids[:, 1:], IGNORE)
    info_labels = np.full((B, T), IGNORE, np.int64)
    rel_labels = np.full((B, T), float(IGNORE), np.float32)
    ph = input_ids == cfg.v_placeholder_id
    for i in range(B):
        idx = np.where(ph[i])[0][F - 1::F]
        info_labels[i, idx] = rng.integers(0, 2, len(idx))
        rel_labels[i, idx] = rng.random(len(idx))
    r = cfg.frame_resolution
    frames = rng.integers(0, 255, (sum(frames_per_row), r, r, 3)).astype(np.uint8)
    return {"input_ids": input_ids, "attention_mask": attn, "labels": labels,
            "informative_labels": info_labels, "relevance_labels": rel_labels, "frames": frames}


# -- adapters ------------------------------------------------------------------------


def test_init_lora_and_labels(tiny):
    params, cfg, _ = tiny
    pcfg = port_cfg(cfg)
    lc = tconfig.LoraConfig(r=4)
    tree = tlora.init_lora(pcfg.llm, lc, seed=3, device="cpu")
    assert tuple(tree) == tlora.LORA_PROJS and tlora.lora_scale(lc) == 8.0
    for name, (din, dout) in tlora.proj_dims(pcfg.llm).items():
        a, b = tree[name]["a"], tree[name]["b"]
        assert a.shape == (2, din, 4) and b.shape == (2, 4, dout) and a.dtype == torch.float32
        assert float(b.abs().max()) == 0.0
        bound = (6.0 / din) ** 0.5
        assert 0.9 * bound < float(a.abs().max()) <= bound and abs(float(a.mean())) < 0.1 * bound
    again = tlora.init_lora(pcfg.llm, lc, seed=3, device="cpu")
    assert torch.equal(again["q_proj"]["a"], tree["q_proj"]["a"])
    only = tlora.init_lora(pcfg.llm, dataclasses.replace(
        lc, target_patterns=r"layers_\d+/(q_proj|v_proj)/kernel"), device="cpu")
    assert tuple(only) == ("q_proj", "v_proj")
    # the partition, leaf by leaf, is the JAX package's
    jl = jlora.trainable_labels(params, numpy_lora(cfg), jconfig.LoraConfig().finetune_modules)
    tl = tlora.trainable_labels(params_from_jax(_np(params)), tree, lc.finetune_modules)
    flat = {"/".join(str(k.key) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(jl)}
    assert flat == {"/".join(p): v for p, v in ttrainer._flatten(tl)}
    assert flat["model/llm/lm_head/kernel"] == "train" == flat["lora/down_proj/b"]
    assert flat["model/llm/layers/q_proj/kernel"] == "freeze" == flat["model/vision/pos_embed"]


def test_merge_lora_equals_applied(tiny):
    params, cfg, _ = tiny
    pcfg = port_cfg(cfg)
    llm = params_from_jax(_np(params))["llm"]
    lora = params_from_jax(numpy_lora(cfg))
    x = _t(np.random.default_rng(2).standard_normal((1, 6, cfg.llm.hidden_size)).astype(np.float32))
    applied = tqwen2.forward_hidden(llm, pcfg.llm, x, lora=lora, lora_scale=2.0)
    merged = tqwen2.forward_hidden(tlora.merge_lora(llm, lora, 2.0), pcfg.llm, x)
    np.testing.assert_allclose(applied.numpy(), merged.numpy(), rtol=2e-4, atol=2e-4)
    assert llm["layers"]["q_proj"]["kernel"] is not tlora.merge_lora(
        llm, lora, 2.0)["layers"]["q_proj"]["kernel"]


@pytest.mark.parametrize("variant", ["dense", "int4_split", "int4_merged"])
def test_forward_hidden_with_lora(tiny, variant):
    """Adapters with B != 0 over a dense, an int4 and a merged-int4 trunk
    (JAX dequantises then multiplies off the TPU; the port scales the group
    sums): 1e-5 in f32, with positions and without."""
    params, cfg, _ = tiny
    pcfg = port_cfg(cfg)
    llm = params["llm"]
    if variant != "dense":
        llm = jquant.quantize_params(params, bits=4)["llm"]
        if variant == "int4_merged":
            llm = jquant.merge_decoder_projections(llm)
            assert "qkv_proj" in llm["layers"] and "gate_up_proj" in llm["layers"]
    lora = numpy_lora(cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 13, cfg.llm.hidden_size)).astype(np.float32)
    pos = np.stack([np.arange(13), np.arange(13) + 5]).astype(np.int32)
    tllm, tl = params_from_jax(_np(llm)), params_from_jax(lora)
    for p in (None, pos):
        ref = jqwen2.forward_hidden(llm, cfg.llm, jnp.asarray(x), lora=jax.tree.map(jnp.asarray, lora),
                                    lora_scale=2.0, positions=None if p is None else jnp.asarray(p))
        out = tqwen2.forward_hidden(tllm, pcfg.llm, _t(x), lora=tl, lora_scale=2.0,
                                    positions=None if p is None else _t(p))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def _loss_and_grads(llm, cfg, x, lora, **kw):
    leaves = [t for ab in lora.values() for t in ab.values()]
    for t in leaves:
        t.requires_grad_(True)
    h = tqwen2.forward_hidden(llm, cfg, x, lora=lora, lora_scale=2.0, **kw)
    loss = (h.float() ** 2).mean()
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("dropout", [0.0, 0.05])
def test_remat_equals_none(qlora, dropout):
    """'full' and 'half' replay layers in the backward: same loss and same
    gradients as 'none', also with dropout on (the replay must draw the masks
    it drew in the forward)."""
    params, cfg, _ = qlora
    pcfg = port_cfg(cfg)
    llm, lora = params_from_jax(_np(params["llm"])), params_from_jax(numpy_lora(cfg))
    x = _t(np.random.default_rng(3).standard_normal((2, 11, cfg.llm.hidden_size)).astype(np.float32))
    kw = dict(lora_dropout=dropout, dropout_seed=77)
    loss0, grads0 = _loss_and_grads(llm, pcfg.llm, x, lora, remat="none", **kw)
    assert all(float(g.abs().max()) > 0 for g in grads0)
    for remat in ("full", "half", True):
        loss, grads = _loss_and_grads(llm, pcfg.llm, x, lora, remat=remat, **kw)
        assert torch.equal(loss, loss0)
        for g, g0 in zip(grads, grads0):
            np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-6, atol=1e-9)
    if dropout:
        other, _ = _loss_and_grads(llm, pcfg.llm, x, lora, lora_dropout=dropout, dropout_seed=78)
        plain, _ = _loss_and_grads(llm, pcfg.llm, x, lora)
        assert float(other) != float(loss0) != float(plain)


def test_remat_policies_refused(tiny):
    """Every policy of the JAX package runs (``dots`` and ``dots_no_batch``
    since they were ported); an unknown one raises."""
    params, cfg, _ = tiny
    llm = params_from_jax(_np(params["llm"]))
    x = torch.zeros((1, 3, cfg.llm.hidden_size))
    for remat in ("none", "full", "half", "dots", "dots_no_batch"):
        assert tqwen2.forward_hidden(llm, port_cfg(cfg).llm, x, remat=remat).shape == x.shape
    with pytest.raises(ValueError, match="unknown remat"):
        tqwen2.forward_hidden(llm, port_cfg(cfg).llm, x, remat="some")


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
@pytest.mark.parametrize("trunk", ["dense", "int8", "int4_merged"])
def test_dots_policies_match_none_and_jax(tiny, policy, trunk):
    """remat 'dots' / 'dots_no_batch' keep the products' outputs and replay the
    elementwise work: over a padded batch with adapter dropout on, the loss
    and the adapters' gradients equal remat 'none''s (1e-6 relative), and at
    dropout 0 equal the JAX package's under its checkpoint policy of the same
    name (1e-5). The products are not run again: a layer's quantised products
    launch once in the forward, none in the backward's replay."""
    from aha_tpu_torch.models import remat as tremat

    params, cfg, _ = tiny
    pcfg = port_cfg(cfg)
    llm = params["llm"]
    if trunk != "dense":
        llm = jquant.quantize_params(params, bits=4 if trunk == "int4_merged" else 8)["llm"]
        if trunk == "int4_merged":
            llm = jquant.merge_decoder_projections(llm)
    lora = numpy_lora(cfg)
    tllm, tl = params_from_jax(_np(llm)), params_from_jax(lora)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, cfg.llm.hidden_size)).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, :4] = False
    kw = dict(attn_mask=_t(mask), lora_dropout=0.1, dropout_seed=5)
    loss0, grads0 = _loss_and_grads(tllm, pcfg.llm, _t(x), tl, remat="none", **kw)
    calls = []
    real = tremat.int4_matmul if trunk == "int4_merged" else tremat.int8_matmul
    name = "int4_matmul" if trunk == "int4_merged" else "int8_matmul"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tremat, name, lambda *a, **k: calls.append(1) or real(*a, **k))
        loss, grads = _loss_and_grads(tllm, pcfg.llm, _t(x), tl, remat=policy, **kw)
    np.testing.assert_allclose(float(loss), float(loss0), rtol=1e-6)
    for g, g0 in zip(grads, grads0):
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=1e-6, atol=1e-9)
    if trunk != "dense":
        per_layer = 4 if trunk == "int4_merged" else 7      # merged: qkv, o, gate_up, down
        assert len(calls) == per_layer * cfg.llm.num_layers

    def jloss(lo):
        h = jqwen2.forward_hidden(llm, cfg.llm, jnp.asarray(x), attn_mask=jnp.asarray(mask),
                                  lora=lo, lora_scale=2.0, remat=policy)
        return (h.astype(jnp.float32) ** 2).mean()

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, lora))
    loss, grads = _loss_and_grads(tllm, pcfg.llm, _t(x), tl, remat=policy, attn_mask=_t(mask))
    np.testing.assert_allclose(float(loss), float(jl), atol=ATOL)
    jflat = [np.asarray(jg[n][k]) for n in tl for k in tl[n]]
    for g, r in zip(grads, jflat):
        np.testing.assert_allclose(g.numpy(), r, atol=ATOL)


def test_dropout_masks():
    """Inverted dropout on the adapter input: the keep rate within 3 sigma,
    the same mask for the same (seed, projection, layer), another one for
    another step's seed, layer or projection."""
    n = 64
    eye = torch.eye(n)[None].repeat(2, 1, 1)
    lora = {"q_proj": {"a": eye, "b": eye}, "v_proj": {"a": eye, "b": eye}}
    x = torch.ones((8, 512, n))
    seed = tqwen2.site_seed(42 + 13, 5)

    def dropped(layer=0, name="q_proj", seed=seed, rate=0.05):
        return tqwen2.LayerAdapters(lora, layer, 1.0, rate, seed).delta(name, x)

    d = dropped()
    kept = d != 0
    np.testing.assert_allclose(d[kept].numpy(), 1 / 0.95, rtol=1e-6)
    sigma = (0.05 * 0.95 / x.numel()) ** 0.5
    assert abs(float(kept.float().mean()) - 0.95) < 3 * sigma
    assert torch.equal(dropped(), d)
    for other in (dropped(layer=1), dropped(name="v_proj"),
                  dropped(seed=tqwen2.site_seed(42 + 13, 6))):
        assert 0.05 < float((other != d).float().mean()) < 0.15   # 2 * .05 * .95 if independent
    assert torch.equal(dropped(rate=0.0), x)
    assert torch.equal(tqwen2.LayerAdapters(lora, 0, 1.0, 0.05, None).delta("q_proj", x), x)


# -- forward_train and the loss ------------------------------------------------------------


def _forward_both(params, cfg, batch, lora):
    ref = jaha.forward_train(
        params, cfg, jnp.asarray(batch["input_ids"]), jnp.asarray(batch["frames"]),
        attn_mask=jnp.asarray(batch["attention_mask"]), lora=jax.tree.map(jnp.asarray, lora),
        lora_scale=2.0, remat=False)
    out = taha.forward_train(
        params_from_jax(_np(params)), port_cfg(cfg), _t(batch["input_ids"]).long(),
        _t(batch["frames"]), attn_mask=_t(batch["attention_mask"]), lora=params_from_jax(lora),
        lora_scale=2.0, remat="none")
    return ref, out


def _losses_both(ref, out, batch, weights=None):
    jp = jlosses.aha_loss(
        ref.logits, ref.informative_logits, ref.relevance, ref.log_variance,
        input_ids=jnp.asarray(batch["input_ids"]), labels=jnp.asarray(batch["labels"]),
        informative_labels=jnp.asarray(batch["informative_labels"]),
        relevance_labels=jnp.asarray(batch["relevance_labels"]), weights=jconfig.LossWeights())
    tp = tlosses.aha_loss(
        out.logits, out.informative_logits, out.relevance, out.log_variance,
        input_ids=_t(batch["input_ids"]), labels=_t(batch["labels"]),
        informative_labels=_t(batch["informative_labels"]),
        relevance_labels=_t(batch["relevance_labels"]), weights=tconfig.LossWeights())
    return jp, tp


PARTS = ("total", "lm", "video", "info", "relevance", "tv", "uncertainty")
FIELDS = ("logits", "informative_logits", "relevance", "log_variance", "hidden")


def test_forward_train_and_loss_unpadded(qlora):
    """Every output and every part of the loss on a batch without padding, over
    the int4 trunk with adapters: 1e-5."""
    params, cfg, tok = qlora
    batch = make_batch(cfg, tok, np.random.default_rng(0))
    assert batch["attention_mask"].all()
    ref, out = _forward_both(params, cfg, batch, numpy_lora(cfg))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=ATOL, err_msg=f)
    jp, tp = _losses_both(ref, out, batch)
    for name in PARTS:
        np.testing.assert_allclose(float(getattr(tp, name)), float(getattr(jp, name)),
                                   atol=ATOL, err_msg=name)
    assert float(tp.lm) > 0 and float(tp.info) > 0 and float(tp.relevance) > 0


def test_forward_train_padded_batch(qlora):
    """A left-padded batch. A padded query sees no key: JAX's dense branch,
    which T < 1024 takes, gives it the mean of all values, and so does the
    port's ``causal_attention`` at such T. So every row's hidden states and
    every part of the loss (``tv`` and ``uncertainty`` read every position)
    are held to 1e-5."""
    params, cfg, tok = qlora
    batch = make_batch(cfg, tok, np.random.default_rng(1), frames_per_row=(4, 2))
    real = batch["attention_mask"]
    assert not real.all() and real[:, -1].all()
    # the shift in make_batch labels the LAST padded position with the first real
    # token; a label there reads a padded row's logits, so it is taken out
    assert (batch["labels"][~real] != IGNORE).sum() == 1
    batch["labels"][~real] = IGNORE
    ref, out = _forward_both(params, cfg, batch, numpy_lora(cfg))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=ATOL, err_msg=f)
    jp, tp = _losses_both(ref, out, batch)
    for name in PARTS:
        np.testing.assert_allclose(float(getattr(tp, name)), float(getattr(jp, name)),
                                   atol=ATOL, err_msg=name)
    # the same frames handed over as projected features give the same outputs
    tparams, pcfg = params_from_jax(_np(params)), port_cfg(cfg)
    fe = taha.visual_embed(tparams, pcfg, _t(batch["frames"]))
    again = taha.forward_train(tparams, pcfg, _t(batch["input_ids"]).long(), None,
                               attn_mask=_t(real), frame_embeds=fe,
                               lora=params_from_jax(numpy_lora(cfg)), lora_scale=2.0, remat="full")
    np.testing.assert_allclose(again.hidden.numpy(), out.hidden.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        taha.forward_train(tparams, pcfg, _t(batch["input_ids"]).long(), _t(batch["frames"]),
                           frame_embeds=fe)


@pytest.mark.parametrize("case", ["full", "no_valid_label", "one_relevance_label", "T1",
                                  "no_video_labels"])
def test_loss_quirks(case):
    """aha_loss on numpy inputs against the JAX function: a batch with no
    valid label of any kind (one is injected), exactly one valid relevance
    label (SmoothL1 off), T = 1 (no TV term), absent video labels."""
    rng = np.random.default_rng(7)
    B, T, V = 2, (1 if case == "T1" else 6), 11
    logits = rng.standard_normal((B, T, V)).astype(np.float32)
    info = rng.standard_normal((B, T, 2)).astype(np.float32)
    rel = rng.random((B, T)).astype(np.float32)
    lv = (rng.standard_normal((B, T)) * 3).astype(np.float32)        # beyond the clamp too
    ids = rng.integers(0, V, (B, max(T, 2))).astype(np.int32)
    labels = rng.integers(0, V, (B, T)).astype(np.int64)
    info_l = rng.integers(0, 2, (B, T)).astype(np.int64)
    rel_l = rng.random((B, T)).astype(np.float32)
    labels[0, 0] = info_l[1, 0] = IGNORE
    if case == "no_valid_label":
        labels[:], info_l[:], rel_l[:] = IGNORE, IGNORE, IGNORE
    if case == "one_relevance_label":
        rel_l[:] = IGNORE
        rel_l[1, 2] = 0.3
    none = case == "no_video_labels"
    jp = jlosses.aha_loss(
        jnp.asarray(logits), jnp.asarray(info), jnp.asarray(rel), jnp.asarray(lv),
        input_ids=jnp.asarray(ids), labels=jnp.asarray(labels),
        informative_labels=None if none else jnp.asarray(info_l),
        relevance_labels=None if none else jnp.asarray(rel_l), weights=jconfig.LossWeights())
    tp = tlosses.aha_loss(
        _t(logits), _t(info), _t(rel), _t(lv), input_ids=_t(ids), labels=_t(labels),
        informative_labels=None if none else _t(info_l),
        relevance_labels=None if none else _t(rel_l), weights=tconfig.LossWeights())
    for name in PARTS:
        np.testing.assert_allclose(float(getattr(tp, name)), float(getattr(jp, name)),
                                   rtol=1e-5, atol=ATOL, err_msg=name)
    if case == "one_relevance_label":
        assert float(tp.relevance) == 0.0 and float(tp.uncertainty) > 0.0
    if case == "T1":
        assert float(tp.tv) == 0.0
    if case == "no_valid_label":
        assert float(tp.lm) > 0.0 and float(tp.info) > 0.0
    if none:
        assert float(tp.video) == 0.0


def test_video_head_stop_grad(tiny):
    """The ablation: the video heads see detached hidden states, so their
    losses reach the head kernels and nothing of the trunk."""
    params, cfg, tok = tiny
    batch = make_batch(cfg, tok, np.random.default_rng(2), frames_per_row=(2,))
    tparams = params_from_jax(_np(params))
    lora = params_from_jax(numpy_lora(cfg))
    b, head = lora["q_proj"]["b"].requires_grad_(), tparams["heads"]["relevance"]["kernel"]
    head.requires_grad_()
    for stop, reaches_trunk in ((False, True), (True, False)):
        out = taha.forward_train(tparams, port_cfg(cfg).replace(video_head_stop_grad=stop),
                                 _t(batch["input_ids"]).long(), _t(batch["frames"]), lora=lora,
                                 lora_scale=2.0, remat="none")
        gb, gh = torch.autograd.grad(out.relevance.sum(), (b, head), allow_unused=True)
        assert float(gh.abs().max()) > 0
        assert (gb is not None and float(gb.abs().max()) > 0) == reaches_trunk


# -- optimizer and train step -------------------------------------------------------------


@pytest.mark.parametrize("total,ratio", [(20, 0.1), (100, 0.0), (7, 0.5)])
def test_cosine_schedule_is_optax(total, ratio):
    jc, tc = both_train_cfgs(learning_rate=3e-4, warmup_ratio=ratio)
    ref, sched = joptimizer.cosine_schedule(jc, total), toptimizer.cosine_schedule(tc, total)
    for count in range(total + 3):
        # optax evaluates in f32: 1e-6 of the peak rate
        np.testing.assert_allclose(sched(count), float(ref(count)), rtol=0, atol=3e-4 * 1e-6)
    assert sched(0) == 0.0


def _jax_state(params, cfg, jc, lora, total):
    # the jitted step donates its input buffers: give it copies
    params = jax.tree.map(jnp.array, params)
    return jtrainer.init_train_state(cfg, jc, params, total_steps=total,
                                     lora_init=jax.tree.map(jnp.asarray, lora))


@pytest.mark.parametrize("trunk,accum,micro_steps", [("int4", 1, 3), ("dense", 2, 6),
                                                     ("int8", 1, 3)])
def test_train_steps_match_jax(tiny, qlora, trunk, accum, micro_steps):
    """make_train_step against the JAX package's from a bridged state at
    lora_dropout=0, with a warmup (the first update has rate 0): over the int4
    trunk, over the int8 trunk (JAX's ``auto`` backend: dequantise, then the
    einsum; the port's int8_qlinear) under remat 'dots' on both sides, and
    with gradient accumulation over the dense one (optax.MultiSteps refuses
    the JAX tree's integer leaves, so JAX accumulates over a dense trunk only;
    the port's accumulation over int4 is in the checkpoint test). The loss of
    each micro-step to 1e-4, every trained leaf to 1e-4 of its largest
    magnitude, every frozen leaf untouched."""
    params, cfg, tok = qlora if trunk == "int4" else tiny
    if trunk == "int8":
        params = jquant.quantize_params(params, keep_dense=("projector", "lm_head"), bits=8)
    total = 20
    jc, tc = both_train_cfgs(learning_rate=1e-3, warmup_ratio=0.1, grad_accum_steps=accum,
                             remat_policy="dots" if trunk == "int8" else "full",
                             weight_decay=0.01)
    lora = numpy_lora(cfg, b_scale=0.0)
    rng = np.random.default_rng(11)
    batches = [make_batch(cfg, tok, rng) for _ in range(2)]

    jstate, jtx, jlabels, jscale = _jax_state(params, cfg, jc, lora, total)
    jstep = jtrainer.make_train_step(cfg, jc, jtx, jlabels, jscale)
    tparams = params_from_jax(_np(params))
    frozen_before = copy.deepcopy(tparams["llm"]["layers"])
    state, tx, labels, scale = ttrainer.init_train_state(
        port_cfg(cfg), tc, tparams, total_steps=total, lora_init=params_from_jax(lora),
        device="cpu")
    assert scale == jscale
    step = ttrainer.make_train_step(port_cfg(cfg), tc, tx, labels, scale, device="cpu")

    for i in range(micro_steps):
        batch = batches[i % 2]
        jstate, jparts = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, parts = step(state, batch)
        for name in PARTS:
            np.testing.assert_allclose(float(getattr(parts, name)), float(getattr(jparts, name)),
                                       atol=1e-4, err_msg=f"micro-step {i} {name}")
    assert state.step == micro_steps == int(jstate.step)
    assert state.opt_state.count == micro_steps // accum

    jtree = _np(jstate.tree)
    moved = 0
    for name, leaf in ttrainer.trained_leaves(state.tree, labels).items():
        ref = jtree
        for k in name.split("/"):
            ref = ref[k]
        np.testing.assert_allclose(leaf.detach().numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)
        moved += float(np.abs(ref).max()) > 0
    assert float(state.tree["lora"]["q_proj"]["b"].detach().abs().max()) > 0 and moved > 20
    for (path, a), (_, b) in zip(ttrainer._flatten(frozen_before),
                                 ttrainer._flatten(state.tree["model"]["llm"]["layers"])):
        assert torch.equal(a, b), path
    if trunk == "int4":
        q4 = state.tree["model"]["llm"]["layers"]["q_proj"]["kernel"]["q4value"]
        assert q4.dtype == torch.uint8 and not q4.requires_grad
    if trunk == "int8":
        q8 = state.tree["model"]["llm"]["layers"]["q_proj"]["kernel"]["qvalue"]
        assert q8.dtype == torch.int8 and not q8.requires_grad

    # a JAX state's trained leaves carried into a port state
    bridge.load_trained_leaves(state.tree, jtree, labels)
    np.testing.assert_array_equal(state.tree["lora"]["q_proj"]["b"].detach().numpy(),
                                  jtree["lora"]["q_proj"]["b"])
    np.testing.assert_array_equal(state.tree["model"]["llm"]["lm_head"]["kernel"].detach().numpy(),
                                  jtree["model"]["llm"]["lm_head"]["kernel"])


def _fresh_state(params, cfg, tc, total=12):
    state, tx, labels, scale = ttrainer.init_train_state(
        port_cfg(cfg), tc, params_from_jax(_np(params)), total_steps=total, seed=5, device="cpu")
    return state, labels, ttrainer.make_train_step(port_cfg(cfg), tc, tx, labels, scale,
                                                   device="cpu")


def test_checkpoint_round_trip(qlora, tmp_path):
    """A checkpoint holds the trained leaves, the optimizer state and the step,
    nothing of the frozen trunk; saving the same step again is a no-op;
    a resumed run continues the trajectory (dropout on: masks are a function
    of the seed and the step)."""
    params, cfg, tok = qlora
    _, tc = both_train_cfgs(learning_rate=1e-3, warmup_ratio=0.1, grad_accum_steps=2,
                            dropout=0.05)
    batch = make_batch(cfg, tok, np.random.default_rng(4))
    state, labels, step = _fresh_state(params, cfg, tc)
    for _ in range(3):                      # mid-accumulation: one update, one pending micro-step
        state, _ = step(state, batch)
    ckpt = str(tmp_path / "ckpt")
    assert ttrainer.latest_checkpoint(ckpt) is None
    path = ttrainer.save_checkpoint(ckpt, state, labels=labels)
    assert path == ttrainer.latest_checkpoint(ckpt) and path.endswith("step_00000003.pt")
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"trained", "opt_state", "step"} and payload["step"] == 3
    assert set(payload["trained"]) == set(ttrainer.trained_leaves(state.tree, labels))
    assert not any("layers" in k and k.startswith("model") for k in payload["trained"])
    assert payload["opt_state"]["count"] == 1 and payload["opt_state"]["mini_step"] == 1
    stamp = os.stat(path).st_mtime_ns
    state.tree["lora"]["q_proj"]["b"].data.add_(1.0)     # would show if the file were rewritten
    assert ttrainer.save_checkpoint(ckpt, state, labels=labels) == path
    assert os.stat(path).st_mtime_ns == stamp
    state.tree["lora"]["q_proj"]["b"].data.sub_(1.0)
    losses = []
    for _ in range(3):
        state, parts = step(state, batch)
        losses.append(float(parts.total))

    resumed, labels2, step2 = _fresh_state(params, cfg, tc)
    with pytest.raises(ValueError, match="labels"):
        ttrainer.restore_checkpoint(path, resumed)
    ttrainer.restore_checkpoint(path, resumed, labels2)
    assert resumed.step == 3 and resumed.opt_state.mini_step == 1
    again = []
    for _ in range(3):
        resumed, parts = step2(resumed, batch)
        again.append(float(parts.total))
    assert again == losses
    for name, leaf in ttrainer.trained_leaves(state.tree, labels).items():
        assert torch.equal(leaf, ttrainer.trained_leaves(resumed.tree, labels2)[name]), name

    # pruning keeps the newest, and a whole-tree checkpoint restores without labels
    for _ in range(2):
        ttrainer.save_checkpoint(ckpt, state, keep=2, labels=labels)
        state.step += 1
    assert sorted(os.listdir(ckpt)) == ["step_00000006.pt", "step_00000007.pt"]
    full = ttrainer.save_checkpoint(str(tmp_path / "full"), state)
    other, _, _ = _fresh_state(params, cfg, tc)
    ttrainer.restore_checkpoint(full, other)
    assert other.step == state.step
    assert torch.equal(other.tree["lora"]["q_proj"]["b"], state.tree["lora"]["q_proj"]["b"])


def test_train_loop_writes_its_artifacts(qlora, tmp_path):
    params, cfg, tok = qlora
    out = str(tmp_path / "run")
    tc = tconfig.TrainConfig(output_dir=out, learning_rate=1e-3, warmup_ratio=0.0,
                             grad_accum_steps=1, save_steps=2, remat_policy="half")
    batch = make_batch(cfg, tok, np.random.default_rng(6), frames_per_row=(2,))
    state = ttrainer.train(port_cfg(cfg), tc, params_from_jax(_np(params)), [batch] * 10,
                           total_steps=4, device="cpu")
    assert state.step == 4
    recs = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/total_loss"]) for r in recs)
    assert recs[-1]["train/total_loss"] < recs[0]["train/total_loss"]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == [
        "step_00000002.pt", "step_00000004.pt"]
    adapter = torch.load(os.path.join(out, "adapter.pt"), weights_only=True)
    assert "lora/q_proj/a" in adapter and "model/projector/fc1/kernel" in adapter
    assert not any(k.startswith("model/llm/layers") for k in adapter)
    # resume from the last checkpoint: the loop takes no further step
    tc2 = dataclasses.replace(tc, resume_from_checkpoint=ttrainer.latest_checkpoint(
        os.path.join(out, "checkpoints")))
    resumed = ttrainer.train(port_cfg(cfg), tc2, params_from_jax(_np(params)), [batch] * 3,
                             total_steps=4, device="cpu")
    assert resumed.step == 4
    assert torch.equal(resumed.tree["lora"]["q_proj"]["b"], state.tree["lora"]["q_proj"]["b"])


def test_train_step_bf16_activations():
    """The deployment dtype: bf16 activations and dense leaves with f32 adapter
    masters and f32 moments. The adapter delta is cast back to bf16, a bf16
    leaf takes its f32 update in one rounding, and the loss falls."""
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    cfg = tconfig.aha_tiny(vocab_size=128).replace(dtype="bfloat16")
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tok.v_placeholder_id, eos_token_id=tok.eos_token_id)
    params = taha.random_params(cfg, mode="int4", keep_dense=("projector", "lm_head"),
                                device="cpu", seed=2)
    head = params["llm"]["lm_head"]["kernel"]
    assert head.dtype == torch.bfloat16 and not isinstance(params["projector"]["fc1"]["kernel"], dict)
    tc = tconfig.TrainConfig(learning_rate=1e-2, warmup_ratio=0.0, grad_accum_steps=1)
    state, tx, labels, scale = ttrainer.init_train_state(cfg, tc, params, total_steps=10,
                                                         device="cpu")
    step = ttrainer.make_train_step(cfg, tc, tx, labels, scale, device="cpu")
    batch, T = ttrainer.synthetic_batch(cfg, tok, np.random.default_rng(0), n_frames=3, B=2)
    assert batch["input_ids"].shape == (2, T) and (batch["informative_labels"] != IGNORE).sum() == 6
    before = head.detach().clone()
    losses = []
    for _ in range(4):
        state, parts = step(state, batch)
        losses.append(float(parts.total))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert head.dtype == torch.bfloat16 and not torch.equal(head.detach(), before)
    assert state.tree["lora"]["q_proj"]["a"].dtype == torch.float32
    assert state.opt_state.mu["model/llm/lm_head/kernel"].dtype == torch.float32


def test_entry_points_default_to_the_card(tiny):
    """Without device='cpu' the training entry points ask for the card and,
    on a host without one, raise."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    params, cfg, _ = tiny
    pcfg, tc = port_cfg(cfg), tconfig.TrainConfig()
    tparams = params_from_jax(_np(params))
    with pytest.raises(RuntimeError, match="no GPU"):
        tlora.init_lora(pcfg.llm, tc.lora)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttrainer.init_train_state(pcfg, tc, tparams, total_steps=4)
    state, tx, labels, scale = ttrainer.init_train_state(pcfg, tc, tparams, total_steps=4,
                                                         device="cpu")
    with pytest.raises(RuntimeError, match="no GPU"):
        ttrainer.make_train_step(pcfg, tc, tx, labels, scale)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttrainer.train(pcfg, tc, tparams, [], total_steps=4)
