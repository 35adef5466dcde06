"""Qwen2 decoder: one streaming chunk at a time over the ring-buffer cache,
and the full-sequence forward that training differentiates.

Counterpart of ``aha_tpu/models/qwen2.py`` (``rms_norm``, ``linear``,
``_ab_delta``, ``_qkv``, ``_mlp``, ``embed_tokens``, ``forward_hidden``,
``decode_chunk``, ``decode_chunk_spec``, ``lm_logits``).
Weights stay layer-stacked [L, ...] as the bridge delivers them; the layer
loop is a Python loop over per-layer views. The JAX cast points are kept:
RMSNorm in f32 returning the input dtype, SiLU in f32, attention math in
f32, matmul outputs in the activation dtype. Merged ``qkv_proj`` /
``gate_up_proj`` and split projections are both accepted; ``backend`` picks
the quantized-matmul kernels (``ops/quant.py``).

``decode_chunk`` WRITES the cache in place; ``decode_chunk_spec`` only reads
it. ``forward_hidden`` has no cache: full causal attention through the flash
kernel, activation rematerialisation on ``torch.utils.checkpoint`` (the
``dots`` policies with their products kept, ``models/remat.py``). All three
take LoRA adapters, added at the matmul sites (the serving passes without
dropout).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..config import QwenConfig
from ..ops.attention import (cached_attention, causal_attention, chunk_tables,
                             replayed_attention, spec_tables, speculative_attention)
from ..ops.kv_cache import CachePolicy, KVCache, advance, plan_update, write_layer
from ..ops.quant import embed_rows, linear
from ..ops.rope import apply_rope, rope_cos_sin
from . import layer_view
from .remat import POLICIES as DOTS_POLICIES
from .remat import ProductStash


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, *,
             f64_mean: bool = False) -> torch.Tensor:
    """RMSNorm in f32. ``f64_mean`` (the decoder's serving passes) takes the mean
    of squares in f64 and rounds it to f32 once. The squares are exact there and
    the sum's rounding lies far below f32's last place (some 2^-41 of the sum over
    3584 terms), so a row's mean rarely depends on the order torch sums it in. On
    the card that order depends on how many rows the tensor holds: an f32 sum gave
    a verify pass's row other bits than its sequential pass's (``chip_smoke.py``
    phase 4 holds the two passes equal bit for bit). Training keeps JAX's f32 sum,
    which its train steps are held to."""
    xf = x.float()
    sq = xf.double().square() if f64_mean else xf * xf
    var = sq.mean(dim=-1, keepdim=True).float()
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def site_seed(*parts: int) -> int:
    """One 63-bit seed from (seed, step, projection index, layer): FNV-1a over
    the integers, so that neighbouring sites get unrelated streams."""
    h = 0xCBF29CE484222325
    for v in parts:
        h = ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h >> 1


class LayerAdapters:
    """One layer's LoRA pairs at the matmul sites: ``delta(name, x)`` is
    ``scale * (x @ A) @ B`` at low rank (W + BA is never materialised), in
    f32 against the f32 master adapters and cast back to x's dtype.

    With ``dropout > 0`` the ADAPTER INPUT gets inverted dropout (peft's
    ``lora_dropout``; the frozen base path never sees it), one independent
    mask per projection, layer and step. The mask comes from a generator
    seeded from (seed, projection index, layer) AT EACH CALL, never from one
    that is advanced: ``torch.utils.checkpoint`` replays a layer's forward in
    the backward, and only a generator rebuilt from the same seed gives the
    replay the same mask. The masks match the TPU package's in distribution,
    not bit for bit."""

    def __init__(self, lora: dict, layer: int, scale: float, dropout: float = 0.0,
                 seed: int | None = None, stash: ProductStash | None = None):
        self.pairs = layer_view(lora, layer)
        self.order = {name: i for i, name in enumerate(sorted(lora))}
        self.layer, self.scale = layer, scale
        self.dropout = dropout if seed is not None else 0.0
        self.seed = seed
        self.stash = stash      # remat "dots": the two low-rank products are kept

    def delta(self, name: str, x: torch.Tensor):
        ab = self.pairs.get(name)
        if ab is None:
            return 0.0
        if self.dropout > 0.0:
            keep = 1.0 - self.dropout
            gen = torch.Generator(device=x.device)
            gen.manual_seed(site_seed(self.seed, self.order[name], self.layer))
            mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        a, b = ab["a"].float(), ab["b"].float()
        if self.stash is None:
            low = (x.float() @ a) @ b
        else:
            low = self.stash.matmul(self.stash.matmul(x.float(), a), b)
        return (self.scale * low).to(x.dtype)


def _linear(x: torch.Tensor, p: dict, backend: str, stash: ProductStash | None):
    return linear(x, p, backend) if stash is None else stash.linear(x, p, backend)


def _qkv(x: torch.Tensor, lp: dict, cfg: QwenConfig, backend: str = "fused",
         adapters: LayerAdapters | None = None, stash: ProductStash | None = None):
    B, S, _ = x.shape
    if "qkv_proj" in lp:
        # merged layout: one product for q, k and v; a projection's adapter is
        # added on its slice of the output
        y = _linear(x, lp["qkv_proj"], backend, stash)
        QD, KD = cfg.q_dim, cfg.kv_dim
        q, k, v = y[..., :QD], y[..., QD:QD + KD], y[..., QD + KD:]
    else:
        q, k, v = (_linear(x, lp[n], backend, stash) for n in ("q_proj", "k_proj", "v_proj"))
    if adapters is not None:
        q, k, v = (t + adapters.delta(n, x)
                   for n, t in (("q_proj", q), ("k_proj", k), ("v_proj", v)))
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def _mlp(x: torch.Tensor, lp: dict, backend: str = "fused",
         adapters: LayerAdapters | None = None,
         stash: ProductStash | None = None) -> torch.Tensor:
    if "gate_up_proj" in lp:
        y = _linear(x, lp["gate_up_proj"], backend, stash)
        I = y.shape[-1] // 2
        gate, up = y[..., :I], y[..., I:]
    else:
        gate, up = (_linear(x, lp[n], backend, stash) for n in ("gate_proj", "up_proj"))
    if adapters is not None:
        gate, up = gate + adapters.delta("gate_proj", x), up + adapters.delta("up_proj", x)
    act = F.silu(gate.float()).to(x.dtype) * up
    down = _linear(act, lp["down_proj"], backend, stash)
    return down if adapters is None else down + adapters.delta("down_proj", act)


def _o_proj(attn: torch.Tensor, lp: dict, backend: str = "fused",
            adapters: LayerAdapters | None = None,
            stash: ProductStash | None = None) -> torch.Tensor:
    o = _linear(attn, lp["o_proj"], backend, stash)
    return o if adapters is None else o + adapters.delta("o_proj", attn)


def embed_tokens(params: dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return embed_rows(params["embed"]["weight"], ids, dtype)


def forward_hidden(params: dict, cfg: QwenConfig, inputs_embeds: torch.Tensor, *,
                   attn_mask: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None,
                   lora: dict | None = None, lora_scale: float = 0.0,
                   remat: bool | str = "none", lora_dropout: float = 0.0,
                   dropout_seed: int | None = None, backend: str = "fused") -> torch.Tensor:
    """Final-normed hidden states [B, T, H] of a whole sequence (training,
    prefill without a cache). ``attn_mask`` [B, T] bool marks the real tokens
    of a padded batch; ``positions`` [B, T] default to 0..T-1.

    ``remat``: ``"none"`` (or False) saves every activation, ``"full"`` (or
    True) saves each layer's input only and replays the layer in the backward,
    ``"half"`` does so for the first layer of every pair, ``"dots"`` replays
    every layer with the outputs of its products (attention included) kept
    from the forward, ``"dots_no_batch"`` with its projections' outputs kept
    (``models/remat.py``).

    ``lora_dropout`` with a ``dropout_seed`` (which the trainer derives from
    its seed and the step) drops adapter inputs; see ``LayerAdapters``."""
    if remat in (True, "full"):
        replay = lambda i: True
    elif remat == "half":
        if cfg.num_layers % 2:
            raise ValueError(f"remat='half' needs an even layer count (got {cfg.num_layers})")
        replay = lambda i: i % 2 == 0
    elif remat in (False, None, "none"):
        replay = lambda i: False
    elif remat in DOTS_POLICIES:
        replay = lambda i: True
    else:
        raise ValueError(f"unknown remat policy: {remat!r}")

    B, T = inputs_embeds.shape[:2]
    pos = positions if positions is not None else torch.arange(
        T, device=inputs_embeds.device)[None].expand(B, T)
    rope_tables = rope_cos_sin(pos, cfg.head_dim, cfg.rope_theta)   # the same for every layer
    lyr = params["layers"]

    def layer_fn(x: torch.Tensor, i: int, stash: ProductStash | None = None) -> torch.Tensor:
        lp = layer_view(lyr, i)
        ad = None if lora is None else LayerAdapters(lora, i, lora_scale, lora_dropout,
                                                     dropout_seed, stash)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, backend, ad, stash)
        attn = causal_attention(q, k, v, rope_theta=cfg.rope_theta, attn_mask=attn_mask,
                                rope_tables=rope_tables,
                                attend=stash.attend if stash and stash.attention else None)
        x = x + _o_proj(attn.reshape(B, T, cfg.q_dim), lp, backend, ad, stash)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps)
        return x + _mlp(h, lp, backend, ad, stash)

    x = inputs_embeds
    for i in range(cfg.num_layers):
        if not replay(i):
            x = layer_fn(x, i)
            continue
        # the dropout masks come from their own seeded generators, so the
        # global RNG state need not be stashed and restored
        stash = ProductStash(attention=remat == "dots") if remat in DOTS_POLICIES else None
        x = checkpoint(layer_fn, x, i, stash, use_reentrant=False, preserve_rng_state=False)
        if stash is not None:
            stash.replay()      # the checkpoint's next run of layer_fn is the backward's
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)


def decode_chunk(params: dict, cfg: QwenConfig, policy: CachePolicy, cache: KVCache,
                 inputs_embeds: torch.Tensor, valid_len: torch.Tensor, *,
                 backend: str = "fused", lora: dict | None = None,
                 lora_scale: float = 0.0) -> torch.Tensor:
    """One streaming chunk [B, S, H] with ``valid_len`` [B] real tokens.
    Writes the chunk into ``cache`` IN PLACE (K/V and metadata) and returns
    the final-normed hidden states [B, S, H]. ``lora``: adapters added at the
    seven projections of every row (``LayerAdapters``, no dropout)."""
    S = inputs_embeds.shape[1]
    plan = plan_update(cache, policy, valid_len, S)
    tables = chunk_tables(plan, policy, cfg.head_dim, cfg.rope_theta)
    lyr = params["layers"]
    x = inputs_embeds
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        ad = None if lora is None else LayerAdapters(lora, i, lora_scale)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        q, k, v = _qkv(h, lp, cfg, backend, ad)
        ks = vs = None
        if cache.quantized:
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        write_layer(cache.k[i], cache.v[i], k, v, plan, ks, vs,
                    rot=(tables.w_cos, tables.w_sin))
        attn = cached_attention(q, cache.k[i], cache.v[i], tables,
                                None if ks is None else (ks, vs))
        x = x + _o_proj(attn.reshape(*x.shape[:2], cfg.q_dim), lp, backend, ad)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        x = x + _mlp(h, lp, backend, ad)
    advance(cache, plan)
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)


def decode_chunk_spec(params: dict, cfg: QwenConfig, policy: CachePolicy, cache: KVCache,
                      inputs_embeds: torch.Tensor, plans, *, backend: str = "fused",
                      replay: bool = False, lora: dict | None = None, lora_scale: float = 0.0):
    """The VERIFY pass: like ``decode_chunk`` over the N = S * step tokens of
    ``plans`` (``spec_decode.plan_compose``), but equal to the S sequential
    passes the plans compose, and READ-ONLY on the cache: each layer's
    K/V come back as the in-flight block instead of being written.
    Acceptance-gated commit happens afterwards (``spec_decode.commit_slots``
    + ``select_meta``).

    Returns (final-normed hidden [B, N, H], infl_k [L, B, N, KVH, Dh]
    pre-rotated at ``plans.write_pos``, infl_v [L, B, N, KVH, Dh]).

    One gate for the whole pass picks the pre-rotation scoring or (sink
    policy, ``plans.exact``) the rotate-at-read branch. ``plans.exact`` lives
    on the device, so reading it is ONE host sync per pass (never per
    layer).

    ``replay``: the attention of each layer is ``replayed_attention``, the
    composed steps' write passes replayed through the cached-attention kernel
    (each step's keys written into their slots and restored after the layer),
    which gives every row the bits of its sequential pass, where the one
    softmax over cache and in-flight columns differs from the kernel's sums
    in the last bf16 place; ``generate_spec`` takes it on a bf16 or f32 cache
    so that speculative texts equal sequential ones. Needs no gate and no
    host sync. ``lora``: as in ``decode_chunk``."""
    sink_policy = policy.kind == "sink"
    sink_slots = policy.num_sink if sink_policy else 0
    if replay:
        w_cos, w_sin = rope_cos_sin(plans.write_pos, cfg.head_dim, cfg.rope_theta)
        steps = [chunk_tables(p, policy, cfg.head_dim, cfg.rope_theta) for p in plans.steps]
    else:
        exact = sink_policy and bool(plans.exact)
        tables = spec_tables(plans, sink_policy, cfg.head_dim, cfg.rope_theta, exact)
        w_cos, w_sin = tables.w_cos, tables.w_sin
    lyr = params["layers"]
    x = inputs_embeds
    infl_k, infl_v = [], []
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        ad = None if lora is None else LayerAdapters(lora, i, lora_scale)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        q, k, v = _qkv(h, lp, cfg, backend, ad)
        k_rot = apply_rope(k.float(), w_cos, w_sin).to(k.dtype)
        if replay:
            attn = replayed_attention(q, cache.k[i], cache.v[i], k_rot, v, plans.slots, w_cos,
                                      w_sin, steps)
        else:
            kv_scales = (cache.k_scale[i], cache.v_scale[i]) if cache.quantized else None
            attn = speculative_attention(
                q, cache.k[i], cache.v[i], k_rot, v, tables, sink_slots=sink_slots,
                kv_scales=kv_scales)
        x = x + _o_proj(attn.reshape(*x.shape[:2], cfg.q_dim), lp, backend, ad)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        x = x + _mlp(h, lp, backend, ad)
        infl_k.append(k_rot)
        infl_v.append(v)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
    return x, torch.stack(infl_k), torch.stack(infl_v)


def lm_logits(params: dict, cfg: QwenConfig, hidden: torch.Tensor,
              backend: str = "fused") -> torch.Tensor:
    if cfg.tie_word_embeddings:
        w = params["embed"]["weight"]
        if isinstance(w, dict):
            w = (w["qvalue"].float() * w["scale"]).to(hidden.dtype)
        return torch.matmul(hidden, w.t())
    return linear(hidden, params["lm_head"], backend)
