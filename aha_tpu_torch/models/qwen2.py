"""Qwen2 decoder over the ring-buffer cache, one streaming chunk at a time.

Counterpart of ``aha_tpu/models/qwen2.py`` (``rms_norm``, ``linear``,
``_qkv``, ``_mlp``, ``embed_tokens``, ``decode_chunk``, ``decode_chunk_spec``,
``lm_logits``).
Weights stay layer-stacked [L, ...] as the bridge delivers them; the layer
loop is a Python loop over per-layer views. The JAX cast points are kept:
RMSNorm in f32 returning the input dtype, SiLU in f32, attention math in
f32, matmul outputs in the activation dtype. Merged ``qkv_proj`` /
``gate_up_proj`` and split projections are both accepted; ``backend`` picks
the quantized-matmul kernels (``ops/quant.py``).

``decode_chunk`` WRITES the cache in place; ``decode_chunk_spec`` only reads
it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import QwenConfig
from ..ops.attention import (cached_attention, chunk_tables, spec_tables,
                             speculative_attention)
from ..ops.kv_cache import CachePolicy, KVCache, advance, plan_update, write_layer
from ..ops.quant import embed_rows, linear
from ..ops.rope import apply_rope
from . import layer_view


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _qkv(x: torch.Tensor, lp: dict, cfg: QwenConfig, backend: str = "fused"):
    B, S, _ = x.shape
    if "qkv_proj" in lp:
        y = linear(x, lp["qkv_proj"], backend)
        QD, KD = cfg.q_dim, cfg.kv_dim
        q, k, v = y[..., :QD], y[..., QD:QD + KD], y[..., QD + KD:]
    else:
        q, k, v = (linear(x, lp[n], backend) for n in ("q_proj", "k_proj", "v_proj"))
    return (q.reshape(B, S, cfg.num_heads, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads, cfg.head_dim))


def _mlp(x: torch.Tensor, lp: dict, backend: str = "fused") -> torch.Tensor:
    if "gate_up_proj" in lp:
        y = linear(x, lp["gate_up_proj"], backend)
        I = y.shape[-1] // 2
        gate, up = y[..., :I], y[..., I:]
    else:
        gate, up = linear(x, lp["gate_proj"], backend), linear(x, lp["up_proj"], backend)
    act = F.silu(gate.float()).to(x.dtype) * up
    return linear(act, lp["down_proj"], backend)


def embed_tokens(params: dict, ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return embed_rows(params["embed"]["weight"], ids, dtype)


def decode_chunk(params: dict, cfg: QwenConfig, policy: CachePolicy, cache: KVCache,
                 inputs_embeds: torch.Tensor, valid_len: torch.Tensor, *,
                 backend: str = "fused") -> torch.Tensor:
    """One streaming chunk [B, S, H] with ``valid_len`` [B] real tokens.
    Writes the chunk into ``cache`` IN PLACE (K/V and metadata) and returns
    the final-normed hidden states [B, S, H]."""
    S = inputs_embeds.shape[1]
    plan = plan_update(cache, policy, valid_len, S)
    tables = chunk_tables(plan, policy, cfg.head_dim, cfg.rope_theta)
    lyr = params["layers"]
    x = inputs_embeds
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, backend)
        ks = vs = None
        if cache.quantized:
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        write_layer(cache.k[i], cache.v[i], k, v, plan, ks, vs,
                    rot=(tables.w_cos, tables.w_sin))
        attn = cached_attention(q, cache.k[i], cache.v[i], tables,
                                None if ks is None else (ks, vs))
        x = x + linear(attn.reshape(*x.shape[:2], cfg.q_dim), lp["o_proj"], backend)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(h, lp, backend)
    advance(cache, plan)
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)


def decode_chunk_spec(params: dict, cfg: QwenConfig, policy: CachePolicy, cache: KVCache,
                      inputs_embeds: torch.Tensor, plans, *, backend: str = "fused"):
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
    layer)."""
    sink_policy = policy.kind == "sink"
    sink_slots = policy.num_sink if sink_policy else 0
    exact = sink_policy and bool(plans.exact)
    tables = spec_tables(plans, sink_policy, cfg.head_dim, cfg.rope_theta, exact)
    lyr = params["layers"]
    x = inputs_embeds
    infl_k, infl_v = [], []
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _qkv(h, lp, cfg, backend)
        k_rot = apply_rope(k.float(), tables.w_cos, tables.w_sin).to(k.dtype)
        kv_scales = (cache.k_scale[i], cache.v_scale[i]) if cache.quantized else None
        attn = speculative_attention(
            q, cache.k[i], cache.v[i], k_rot, v, tables, sink_slots=sink_slots,
            kv_scales=kv_scales)
        x = x + linear(attn.reshape(*x.shape[:2], cfg.q_dim), lp["o_proj"], backend)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _mlp(h, lp, backend)
        infl_k.append(k_rot)
        infl_v.append(v)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return x, torch.stack(infl_k), torch.stack(infl_v)


def lm_logits(params: dict, cfg: QwenConfig, hidden: torch.Tensor,
              backend: str = "fused") -> torch.Tensor:
    if cfg.tie_word_embeddings:
        w = params["embed"]["weight"]
        if isinstance(w, dict):
            w = (w["qvalue"].float() * w["scale"]).to(hidden.dtype)
        return torch.matmul(hidden, w.t())
    return linear(hidden, params["lm_head"], backend)
