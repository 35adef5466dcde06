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
                             replayed_attention, spec_tables, speculative_attention, step_tables)
from ..ops.kv_cache import CachePolicy, KVCache, advance, plan_update, write_layer
from ..ops.quant import embed_rows, linear
from ..ops.rope import apply_rope, rope_cos_sin
from ..parallel.sharded import row_slice
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
    not bit for bit.

    ``sh`` (a ``parallel.sharded.Shard`` of the layer's adapter specs): the
    pairs are this rank's blocks, gathered over ``data`` at use; ``delta``'s
    ``mode`` says how the base product is split over ``model`` ("col": its
    output columns, "row": its input, whose partial low-rank products are
    all-reduced). A dropout mask is drawn on the global shape (every row,
    token and input column of the batch) and the rank's part taken, so that
    every shard and microbatch drops what the one-rank step drops there."""

    def __init__(self, lora: dict, layer: int, scale: float, dropout: float = 0.0,
                 seed: int | None = None, stash: ProductStash | None = None, sh=None,
                 layer_id: int | None = None):
        self.pairs = layer_view(lora, layer)
        self.order = {name: i for i, name in enumerate(sorted(lora))}
        self.layer, self.scale = layer if layer_id is None else layer_id, scale
        self.dropout = dropout if seed is not None else 0.0
        self.seed = seed
        self.stash = stash      # remat "dots": the two low-rank products are kept
        self.sh = sh

    def _mask(self, name: str, x: torch.Tensor, mode) -> torch.Tensor:
        keep = 1.0 - self.dropout
        gen = torch.Generator(device=x.device)
        gen.manual_seed(site_seed(self.seed, self.order[name], self.layer))
        sh = self.sh
        if sh is None:
            return torch.rand(x.shape, generator=gen, device=x.device) < keep
        B, T, K = x.shape
        (r0, Bg), (t0, Tg) = sh.rows or (0, B), sh.seq or (0, T)
        Kg, k0 = (K * sh.M, sh.mi * K) if mode == "row" else (K, 0)
        full = torch.rand((Bg, Tg, Kg), generator=gen, device=x.device)
        return full[r0:r0 + B, t0:t0 + T, k0:k0 + K] < keep

    def delta(self, name: str, x: torch.Tensor, mode=None):
        ab = self.pairs.get(name)
        if ab is None:
            return 0.0
        if self.dropout > 0.0:
            keep = 1.0 - self.dropout
            mask = self._mask(name, x, mode)
            x = torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
        a, b = ab["a"].float(), ab["b"].float()
        mm = torch.matmul if self.stash is None else self.stash.matmul
        sh = self.sh
        if sh is None:
            return (self.scale * mm(mm(x.float(), a), b)).to(x.dtype)
        from ..parallel import comm as C

        sp = sh.specs[name]
        a, _ = sh.gather_data(a, sp["a"])
        b, _ = sh.gather_data(b, sp["b"])
        if mode == "col":
            low = C.copy_to(mm(x.float(), a), sh.model)
            out = mm(low, C.split_to(b, sh.model, -1))
        elif mode == "row":
            low = C.reduce_from(mm(x.float(), C.split_to(a, sh.model, 0)), sh.model)
            out = mm(low, b)
        else:
            out = mm(mm(x.float(), a), b)
        return (self.scale * out).to(x.dtype)


def _linear(x: torch.Tensor, p: dict, backend: str, stash: ProductStash | None):
    return linear(x, p, backend) if stash is None else stash.linear(x, p, backend)


def _qkv(x: torch.Tensor, lp: dict, cfg: QwenConfig, backend: str = "fused",
         adapters: LayerAdapters | None = None, stash: ProductStash | None = None, sh=None):
    """q [B, S, NH, Dh], k / v [B, S, KVH, Dh]; under ``sh`` the heads are the
    rank's own where ``sh.heads_local`` (NH / M and KVH / M of them), else all."""
    B, S, _ = x.shape
    if sh is not None:
        return _qkv_sharded(x, lp, cfg, backend, adapters, stash, sh)
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


def _qkv_sharded(x, lp, cfg, backend, adapters, stash, sh):
    B, S, _ = x.shape
    names = ("q_proj", "k_proj", "v_proj")
    if "qkv_proj" in lp:
        # each rank's merged kernel is its own q, k and v blocks side by side
        y, split = sh.linear(x, lp["qkv_proj"], sh.specs["qkv_proj"], backend, stash=stash)
        m = sh.M if split else 1
        QD, KD = cfg.q_dim // m, cfg.kv_dim // m
        outs = [(y[..., :QD], split), (y[..., QD:QD + KD], split), (y[..., QD + KD:], split)]
        if adapters is not None:
            outs = [(t + adapters.delta(n, x, mode="col" if sp else None), sp)
                    for n, (t, sp) in zip(names, outs)]
    else:
        outs = [sh.linear(x, lp[n], sh.specs[n], backend, stash=stash, adapters=adapters,
                          name=n) for n in names]
    local = sh.heads_local(cfg.num_heads, cfg.num_kv_heads) and all(sp for _, sp in outs)
    if not local:
        outs = [(sh.full(t, sp), False) for t, sp in outs]
    m = sh.M if local else 1
    (q, _), (k, _), (v, _) = outs
    return (q.reshape(B, S, cfg.num_heads // m, cfg.head_dim),
            k.reshape(B, S, cfg.num_kv_heads // m, cfg.head_dim),
            v.reshape(B, S, cfg.num_kv_heads // m, cfg.head_dim))


def _mlp(x: torch.Tensor, lp: dict, backend: str = "fused",
         adapters: LayerAdapters | None = None,
         stash: ProductStash | None = None, sh=None) -> torch.Tensor:
    if sh is not None:
        if "gate_up_proj" in lp:
            y, split = sh.linear(x, lp["gate_up_proj"], sh.specs["gate_up_proj"], backend,
                                 stash=stash)
            I = y.shape[-1] // 2
            (gate, gs), (up, us) = (y[..., :I], split), (y[..., I:], split)
            if adapters is not None:
                mode = "col" if split else None
                gate = gate + adapters.delta("gate_proj", x, mode=mode)
                up = up + adapters.delta("up_proj", x, mode=mode)
        else:
            gate, gs = sh.linear(x, lp["gate_proj"], sh.specs["gate_proj"], backend,
                                 stash=stash, adapters=adapters, name="gate_proj")
            up, us = sh.linear(x, lp["up_proj"], sh.specs["up_proj"], backend, stash=stash,
                               adapters=adapters, name="up_proj")
        if gs != us:
            gate, up, gs = sh.full(gate, gs), sh.full(up, us), False
        act = F.silu(gate.float()).to(x.dtype) * up
        down, split = sh.linear(act, lp["down_proj"], sh.specs["down_proj"], backend,
                                x_split=gs, stash=stash, adapters=adapters, name="down_proj")
        return sh.full(down, split)
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
            stash: ProductStash | None = None, sh=None, split: bool = False) -> torch.Tensor:
    """``split``: ``attn`` holds the rank's own heads (its rows of o_proj)."""
    if sh is not None:
        o, osplit = sh.linear(attn, lp["o_proj"], sh.specs["o_proj"], backend, x_split=split,
                              stash=stash, adapters=adapters, name="o_proj")
        return sh.full(o, osplit)
    o = _linear(attn, lp["o_proj"], backend, stash)
    return o if adapters is None else o + adapters.delta("o_proj", attn)


def embed_tokens(params: dict, ids: torch.Tensor, dtype=torch.bfloat16, sh=None) -> torch.Tensor:
    """Token embeddings. Under ``sh`` a table split over ``model`` by vocabulary
    looks up the ids in the rank's rows, zeroes the others and all-reduces."""
    w = params["embed"]["weight"]
    if sh is None:
        return embed_rows(w, ids, dtype)
    w, split = _vocab_table(w, sh)
    if not split:
        return embed_rows(w, ids, dtype)
    from ..parallel import comm as C

    Vl = (w["qvalue"] if isinstance(w, dict) else w).shape[0]
    loc = ids.long() - sh.mi * Vl
    inside = (loc >= 0) & (loc < Vl)
    rows = embed_rows(w, loc.clamp(0, Vl - 1), dtype)
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return C.reduce_from(rows, sh.model)


def _vocab_table(w, sh):
    """The embedding table gathered over ``data`` -> (table, split over
    ``model`` by vocabulary); a table whose parts cannot follow the split is
    gathered whole."""
    sp = sh.specs["embed"]["weight"]
    if isinstance(w, dict):
        parts = {n: sh.gather_data(t, sp[n]) for n, t in w.items()}
        split = all(psp[0] == "model" for _, psp in parts.values())
        if not split:
            return {n: sh.gather_model(t, psp)[0] for n, (t, psp) in parts.items()}, False
        return {n: t for n, (t, _) in parts.items()}, True
    w, wsp = sh.gather_data(w, sp)
    if wsp[0] != "model":
        return sh.gather_model(w, wsp)[0], False
    return w, True


def _pipe_layer0(lyr, sh) -> int:
    """The global index of this pipeline stage's first layer."""
    if sh is None or sh.pipe is None:
        return 0
    L_local = next(iter(_leaves(lyr))).shape[0]
    return sh.mesh.index("pipe") * L_local


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def forward_hidden(params: dict, cfg: QwenConfig, inputs_embeds: torch.Tensor, *,
                   attn_mask: torch.Tensor | None = None,
                   positions: torch.Tensor | None = None,
                   lora: dict | None = None, lora_scale: float = 0.0,
                   remat: bool | str = "none", lora_dropout: float = 0.0,
                   dropout_seed: int | None = None, backend: str = "fused",
                   sh=None, lora_sh=None, ring=None, pipe=None) -> torch.Tensor:
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
    its seed and the step) drops adapter inputs; see ``LayerAdapters``.

    Sharded (``sh``: a ``parallel.sharded.Shard`` of this tree's specs,
    ``lora_sh`` of the adapters'): the rank's blocks, gathered and reduced as
    the specs say. ``ring`` = (mesh, axis): the batch's tokens are split over
    the axis (``inputs_embeds``, ``attn_mask`` and ``positions`` hold the
    rank's stretch, ``sh.seq`` says where it lies) and the attention is
    ``parallel.ring_attention``'s. ``pipe`` = (mesh, axis, n_micro): the
    layers are this stage's (``parallel.pipeline.gpipe_scan_layers``); pipe and
    ring exclude each other and remat 'half' is refused under pipe, as in
    JAX."""
    if pipe is not None:
        if ring is not None:
            raise ValueError("pipe and ring attention are mutually exclusive")
        if remat == "half":
            raise ValueError("remat='half' pairs layers in the plain scan; "
                             "use 'full'/'dots' with pipeline stages")
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
    L_local = next(iter(_leaves(lyr))).shape[0]
    layer0 = _pipe_layer0(lyr, sh)
    lsh = None if sh is None else sh.sub("layers").layer()
    ash = None if lora_sh is None else lora_sh.layer()

    def attention(q, k, v, mask_, tables_, pos_, stash):
        if ring is None:
            return causal_attention(q, k, v, rope_theta=cfg.rope_theta, attn_mask=mask_,
                                    rope_tables=tables_,
                                    attend=stash.attend if stash and stash.attention else None)
        from ..parallel.ring_attention import ring_causal_attention

        cos, sin = tables_
        q = apply_rope(q.float(), cos, sin).to(q.dtype)
        k = apply_rope(k.float(), cos, sin).to(k.dtype)
        # GQA: the ring carries kv heads expanded to q's, as JAX's does
        rep = q.shape[2] // k.shape[2]
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        mesh, axis = ring
        return ring_causal_attention(q, k, v, mesh.comm(axis), positions=pos_,
                                     attn_mask=mask_)

    def make_layer_fn(mask_, tables_, pos_, region):
        lsh_r = None if lsh is None else lsh.region(**region)
        ash_r = None if ash is None else ash.region(**region)

        def layer_fn(x: torch.Tensor, i: int, stash: ProductStash | None = None) -> torch.Tensor:
            lp = layer_view(lyr, i)
            ad = None if lora is None else LayerAdapters(lora, i, lora_scale, lora_dropout,
                                                         dropout_seed, stash, sh=ash_r,
                                                         layer_id=layer0 + i)
            Bx, Tx = x.shape[:2]
            h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps)
            q, k, v = _qkv(h, lp, cfg, backend, ad, stash, sh=lsh_r)
            attn = attention(q, k, v, mask_, tables_, pos_, stash)
            split = q.shape[2] != cfg.num_heads
            x = x + _o_proj(attn.reshape(Bx, Tx, -1), lp, backend, ad, stash, sh=lsh_r,
                            split=split)
            h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps)
            return x + _mlp(h, lp, backend, ad, stash, sh=lsh_r)

        return layer_fn

    region = {} if sh is None else {"rows": sh.rows, "seq": sh.seq}
    x = inputs_embeds
    if pipe is not None:
        from ..parallel.pipeline import gpipe_scan_layers

        mesh_p, axis_p, n_micro = pipe
        cos_t, sin_t = rope_tables
        extras = {"mask": attn_mask, "cos": cos_t, "sin": sin_t, "pos": pos}
        r0, Bg = (sh.rows if sh is not None and sh.rows else (0, B))
        mb = B // n_micro

        def stage_fn(x_mb, ex, m):
            fn = make_layer_fn(ex["mask"], (ex["cos"], ex["sin"]), ex["pos"],
                               {"rows": (r0 + m * mb, Bg), "seq": region.get("seq")})
            for i in range(L_local):
                x_mb = fn(x_mb, i)
            return x_mb

        trained = [t for t in _leaves(lora or {}) if t.requires_grad]
        x = gpipe_scan_layers(mesh_p.comm(axis_p), x, extras, stage_fn, n_micro, trained)
    else:
        layer_fn = make_layer_fn(attn_mask, rope_tables, pos, region)
        for i in range(L_local):
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
                 lora_scale: float = 0.0, sh=None, lora_sh=None) -> torch.Tensor:
    """One streaming chunk [B, S, H] with ``valid_len`` [B] real tokens.
    Writes the chunk into ``cache`` IN PLACE (K/V and metadata) and returns
    the final-normed hidden states [B, S, H]. ``lora``: adapters added at the
    seven projections of every row (``LayerAdapters``, no dropout).

    Sharded (``sh``, ``lora_sh``): the cache's K/V hold the rank's rows
    (``cache.rows``) and heads; the metadata and the plan are every row's, the
    layers run on the rank's rows, and the hidden states are gathered over
    ``data`` so that every rank returns all of them."""
    S = inputs_embeds.shape[1]
    plan = plan_update(cache, policy, valid_len, S)
    rows = cache.rows if sh is not None else None
    lplan, x = plan, inputs_embeds
    if rows is not None:
        lplan, x = row_slice(plan, *rows), inputs_embeds[rows[0]:rows[1]]
    tables = chunk_tables(lplan, policy, cfg.head_dim, cfg.rope_theta)
    lyr = params["layers"]
    lsh = None if sh is None else sh.sub("layers").layer()
    ash = None if lora_sh is None else lora_sh.layer()
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        ad = None if lora is None else LayerAdapters(lora, i, lora_scale, sh=ash)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        q, k, v = _qkv(h, lp, cfg, backend, ad, sh=lsh)
        ks = vs = None
        if cache.quantized:
            ks, vs = cache.k_scale[i], cache.v_scale[i]
        write_layer(cache.k[i], cache.v[i], k, v, lplan, ks, vs,
                    rot=(tables.w_cos, tables.w_sin))
        attn = cached_attention(q, cache.k[i], cache.v[i], tables,
                                None if ks is None else (ks, vs))
        x = x + _o_proj(attn.reshape(*x.shape[:2], -1), lp, backend, ad, sh=lsh,
                        split=q.shape[2] != cfg.num_heads)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        x = x + _mlp(h, lp, backend, ad, sh=lsh)
    advance(cache, plan)
    out = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
    return out if rows is None else sh.data.all_gather(out, 0)


def decode_chunk_spec(params: dict, cfg: QwenConfig, policy: CachePolicy, cache: KVCache,
                      inputs_embeds: torch.Tensor, plans, *, backend: str = "fused",
                      replay: bool | None = None, lora: dict | None = None,
                      lora_scale: float = 0.0, sh=None, lora_sh=None):
    """The VERIFY pass: like ``decode_chunk`` over the N = S * step tokens of
    ``plans`` (``spec_decode.plan_compose``), but equal to the S sequential
    passes the plans compose, and READ-ONLY on the cache: each layer's
    K/V come back as the in-flight block instead of being written.
    Acceptance-gated commit happens afterwards (``spec_decode.commit_slots``
    + ``select_meta``).

    Returns (final-normed hidden [B, N, H], infl_k [L, B, N, KVH, Dh]
    pre-rotated at ``plans.write_pos``, infl_v [L, B, N, KVH, Dh]).

    ``replay`` (None: derived from the cache, True on a bf16 or f32 one and
    False on an int8 one; so every verify pass on a bf16 or f32 cache takes
    it: fused frame scoring and speculative generation): the attention of each
    layer is
    ``replayed_attention``, one launch of the cached-attention kernel in its
    steps' form, each composed step attending as its write pass would over
    the cache with the in-flight keys of the steps up to it overlaid at
    their slots; the cache is only read. Every row's attention has the bits
    of its sequential pass's (speculative texts equal sequential ones; a
    fused frame's products still sum the pass's rows). The tables
    (``step_tables``) are built once a pass; no gate and no host sync.

    Without ``replay`` (an int8 cache, whose sequential writes would be
    quantised; ``replay=False`` asks for it on any cache): the composed
    ``speculative_attention``, one softmax over cache and in-flight columns,
    as JAX computes it. One gate for the whole
    pass picks the pre-rotation scoring or (sink policy, ``plans.exact``)
    the rotate-at-read branch; ``plans.exact`` lives on the device, so
    reading it is ONE host sync per pass (never per layer). ``lora``,
    ``sh``: as in ``decode_chunk``; the in-flight K/V are the rank's rows
    and heads, the hidden states every row's."""
    sink_policy = policy.kind == "sink"
    sink_slots = policy.num_sink if sink_policy else 0
    rows = cache.rows if sh is not None else None
    x = inputs_embeds
    if rows is not None:
        plans, x = row_slice(plans, *rows), inputs_embeds[rows[0]:rows[1]]
    if replay is None:
        replay = not cache.quantized
    if replay:
        tables = step_tables(plans, policy, cfg.head_dim, cfg.rope_theta)
        w_cos, w_sin = tables.w_cos, tables.w_sin
    else:
        exact = sink_policy and bool(plans.exact)
        tables = spec_tables(plans, sink_policy, cfg.head_dim, cfg.rope_theta, exact)
        w_cos, w_sin = tables.w_cos, tables.w_sin
    lyr = params["layers"]
    lsh = None if sh is None else sh.sub("layers").layer()
    ash = None if lora_sh is None else lora_sh.layer()
    infl_k, infl_v = [], []
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        ad = None if lora is None else LayerAdapters(lora, i, lora_scale, sh=ash)
        h = rms_norm(x, lp["input_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        q, k, v = _qkv(h, lp, cfg, backend, ad, sh=lsh)
        k_rot = apply_rope(k.float(), w_cos, w_sin).to(k.dtype)
        if replay:
            attn = replayed_attention(q, cache.k[i], cache.v[i], k_rot, v, tables)
        else:
            kv_scales = (cache.k_scale[i], cache.v_scale[i]) if cache.quantized else None
            attn = speculative_attention(
                q, cache.k[i], cache.v[i], k_rot, v, tables, sink_slots=sink_slots,
                kv_scales=kv_scales)
        x = x + _o_proj(attn.reshape(*x.shape[:2], -1), lp, backend, ad, sh=lsh,
                        split=q.shape[2] != cfg.num_heads)
        h = rms_norm(x, lp["post_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
        x = x + _mlp(h, lp, backend, ad, sh=lsh)
        infl_k.append(k_rot)
        infl_v.append(v)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps, f64_mean=True)
    if rows is not None:
        x = sh.data.all_gather(x, 0)
    return x, torch.stack(infl_k), torch.stack(infl_v)


def lm_logits(params: dict, cfg: QwenConfig, hidden: torch.Tensor,
              backend: str = "fused", sh=None) -> torch.Tensor:
    """Logits over the whole vocabulary. Under ``sh`` the lm_head (or the tied
    table) is split over ``model`` by vocabulary: each rank's columns, then
    gathered, so that greedy argmax and the repetition penalty read the whole
    row (argmax keeps the lowest index among equal maxima)."""
    if sh is not None:
        if cfg.tie_word_embeddings:
            w, split = _vocab_table(params["embed"]["weight"], sh)
            if isinstance(w, dict):
                w = (w["qvalue"].float() * w["scale"]).to(hidden.dtype)
            from ..parallel import comm as C

            y = torch.matmul(C.copy_to(hidden, sh.model) if split else hidden, w.t())
            return sh.full(y, split)
        y, split = sh.linear(hidden, params["lm_head"], sh.specs["lm_head"], backend)
        return sh.full(y, split)
    if cfg.tie_word_embeddings:
        w = params["embed"]["weight"]
        if isinstance(w, dict):
            w = (w["qvalue"].float() * w["scale"]).to(hidden.dtype)
        return torch.matmul(hidden, w.t())
    return linear(hidden, params["lm_head"], backend)
