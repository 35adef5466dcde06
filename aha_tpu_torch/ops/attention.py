"""Streaming attention of one chunk against the ring-buffer cache.

Counterpart of ``aha_tpu/ops/attention.py::cached_attention``, always in
the formulation of its Pallas kernel (``attention.py:121-143``), which is
exact at every fill state:

  * q is rotated at ``plan.write_pos``, the position the chunk's keys are
    stored at;
  * each occupied slot gets the residual rotation
    ``delta_k = key_pos_k - g_k + D`` (D = the row's drift between absolute
    index and reference position): D on sink slots, 0 on steady ring slots,
    the leftover on slots written around the first eviction. So the scored
    distance is the reference's ``q_pos - key_pos`` for every slot, without
    the jnp path's fast/exact split or its chunk-level ``lax.cond``;
  * evicting policies in 'hf' mask mode pass the reference's mask operands
    ``(ref_idx, q_pos)`` in place of ``(order, g)``.

The per-chunk tables (q rotation, delta rotation, mask operands) do not
depend on the layer: ``chunk_tables`` builds them once per chunk.

``replayed_attention`` is the read-only verify pass's attention
(``aha_tpu/ops/attention.py::speculative_attention``) computed as the
sequential passes compute it, on a bf16 or f32 cache: one launch of
``decode_attention_steps``, in which each composed step's rows attend as its
write pass would, with the step's own tables, over the cache with the
in-flight keys of the steps up to it overlaid at their slots; nothing is
written, and every row gets its sequential pass's bits on any device.
``speculative_attention`` is the JAX function's own composition in plain
PyTorch (one softmax over cache and in-flight columns), as JAX computes it in
jnp outside any Pallas kernel: the verify pass takes it on an int8 cache,
whose sequential writes would be quantised.

``causal_attention`` is the full-sequence attention of training and prefill
(``aha_tpu/ops/attention.py::causal_attention``): rotate in f32, then the
flash kernel at every T (no dense and no blockwise branch).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .kernels.decode_attention import decode_attention, decode_attention_steps
from .kernels.flash_attention import flash_causal_attention
from .kv_cache import CachePolicy, UpdatePlan, reference_mask_operands
from .rope import apply_rope, rope_cos_sin


NEG_INF = -1e30   # finite: a row that sees nothing gets a uniform softmax, not NaN


@dataclass
class ChunkTables:
    w_cos: torch.Tensor    # [B, S, Dh] at plan.write_pos (keys and q)
    w_sin: torch.Tensor
    d_cos: torch.Tensor    # [B, W+1, Dh] residual per-slot rotation
    d_sin: torch.Tensor
    mask_order: torch.Tensor   # [B, W+1] int32
    mask_g: torch.Tensor       # [B, S] int32


def chunk_tables(plan: UpdatePlan, policy: CachePolicy, head_dim: int,
                 rope_theta: float) -> ChunkTables:
    sink_policy = policy.kind == "sink"
    sink_slots = policy.num_sink if sink_policy else 0
    w_cos, w_sin = rope_cos_sin(plan.write_pos, head_dim, rope_theta)
    if sink_policy:
        D = (plan.g[:, :1] - plan.q_pos[:, :1]).to(torch.int32)
        delta = torch.where(plan.new_order >= 0, plan.new_key_pos - plan.new_order + D,
                            torch.zeros_like(plan.new_key_pos))
    else:
        delta = torch.zeros_like(plan.new_key_pos)   # write_pos == key_pos
    d_cos, d_sin = rope_cos_sin(delta, head_dim, rope_theta)
    if policy.mask_mode == "hf" and policy.kind in ("sink", "sliding"):
        mask_order, mask_g = reference_mask_operands(plan, sink_slots=sink_slots)
    else:
        mask_order, mask_g = plan.new_order, plan.g
    return ChunkTables(w_cos, w_sin, d_cos.contiguous(), d_sin.contiguous(),
                       mask_order.to(torch.int32).contiguous(),
                       mask_g.to(torch.int32).contiguous())


def cached_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     tables: ChunkTables, kv_scales: tuple | None = None) -> torch.Tensor:
    """q [B, S, NH, Dh] (unrotated) against one layer's cache [B, W+1, KVH,
    Dh] (keys pre-rotated at write_pos) -> [B, S, NH, Dh] in q's dtype.
    f32 queries against a bf16 cache (the frame chunks behind a peft
    artifact's f32 projector) hand the cache to the kernel as it lies: the
    kernel widens it on load, exactly, as JAX's einsums promote it, and keeps
    the probabilities f32 into the second product, as the TPU kernel does
    (JAX's jnp path rounds them to bf16 first). bf16 queries against an f32
    cache (a bf16 decoder under an f32 config: the local judge's) are widened
    to f32, and the f32 output is rounded to bf16, as JAX's promotions
    compute it."""
    q_rot = apply_rope(q.float(), tables.w_cos, tables.w_sin).to(q.dtype)
    if q.dtype == torch.bfloat16 and k_cache.dtype == torch.float32:
        q_rot = q_rot.float()
    return decode_attention(q_rot.contiguous(), k_cache, v_cache, tables.d_cos, tables.d_sin,
                            tables.mask_order, tables.mask_g, kv_scales).to(q.dtype)


@dataclass
class SpecTables:
    """What the verify pass's attention needs that does not depend on the
    layer; built once per pass by ``spec_tables``."""

    w_cos: torch.Tensor    # [B, N, Dh] at plans.write_pos (in-flight keys; fast-branch q)
    w_sin: torch.Tensor
    q_cos: torch.Tensor    # [B, N, Dh] ring / in-flight queries: at qx (exact) or write_pos
    q_sin: torch.Tensor
    e_cos: torch.Tensor | None   # [B, N, Dh] sink-column queries at q_pos (sink policy)
    e_sin: torch.Tensor | None
    c_cos: torch.Tensor | None   # [B, W+1, Dh] cache rotation by dpos (exact branch)
    c_sin: torch.Tensor | None
    i_cos: torch.Tensor | None   # [B, N, Dh] in-flight re-rotation by qx - write_pos (exact)
    i_sin: torch.Tensor | None
    bias: torch.Tensor     # [B, 1, 1, N, W+1+N] f32: 0 where visible, NEG_INF elsewhere
    exact: bool


def spec_tables(plans, sink_policy: bool, head_dim: int, rope_theta: float,
                exact: bool) -> SpecTables:
    """Rotation tables and the additive mask over [cache columns, in-flight
    columns] for one verify pass. ``exact`` picks the rotate-at-read branch
    (meaningful under the sink policy only)."""
    exact = bool(exact and sink_policy)
    w_cos, w_sin = rope_cos_sin(plans.write_pos, head_dim, rope_theta)
    e_cos = e_sin = c_cos = c_sin = i_cos = i_sin = None
    q_cos, q_sin = w_cos, w_sin
    if sink_policy:
        e_cos, e_sin = rope_cos_sin(plans.q_pos, head_dim, rope_theta)
    if exact:
        q_cos, q_sin = rope_cos_sin(plans.qx, head_dim, rope_theta)
        c_cos, c_sin = rope_cos_sin(plans.dpos, head_dim, rope_theta)
        i_cos, i_sin = rope_cos_sin(plans.qx - plans.write_pos, head_dim, rope_theta)
    visible = torch.cat([plans.cache_mask, plans.infl_mask], dim=-1)[:, None, None]
    bias = torch.where(visible, 0.0, NEG_INF)
    return SpecTables(w_cos, w_sin, q_cos, q_sin, e_cos, e_sin, c_cos, c_sin, i_cos, i_sin,
                      bias, exact)


def speculative_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          k_infl: torch.Tensor, v_infl: torch.Tensor, tables: SpecTables, *,
                          sink_slots: int = 0,
                          kv_scales: tuple | None = None) -> torch.Tensor:
    """One pass that scores the chunk's N tokens exactly as the composed
    sequential steps would, WITHOUT writing the cache.

    q [B, N, NH, Dh] unrotated; k_cache / v_cache [B, W+1, KVH, Dh], keys
    pre-rotated, read-only; k_infl / v_infl [B, N, KVH, Dh], in-flight keys
    pre-rotated at ``plans.write_pos`` (the values a commit would store);
    ``tables``: ``spec_tables`` of the pass's ``spec_decode.SpecPlans``,
    the same for all layers. Query p sees the cache through
    ``plans.cache_mask`` (without the slots steps 0..p would have
    overwritten) and the in-flight block through ``plans.infl_mask``.
    ``sink_slots``: the sink policy's sink columns (0 under any other
    policy), scored against q at the sequential q_pos.

    ``tables.exact`` False: the pre-rotation algebra (ring and in-flight
    columns: q at write_pos against keys at write_pos; sink columns: q at the
    sequential q_pos). Valid while no composed step deviates
    (``plans.exact``).

    ``tables.exact`` True: rotate-at-read, composed so ONE cache rotation
    serves all steps: cache keys rotate to their key_pos after step 1
    (``plans.dpos``), ring and in-flight queries use ``plans.qx``, sink
    columns score against q at q_pos. Covers the sink fill transient and the
    post-fill chunk / decode position lag.

    The same function as the JAX one, arranged for fewer launches: the JAX
    code takes a softmax per part (sink, ring, in-flight columns) and merges
    the parts by their maxima; here the parts' scores sit side by side in
    one [.., N, W+1+N] tensor under one softmax, which is the same number
    up to f32 rounding. Products run on the storage dtype's values widened
    to f32 (exact), softmax in f32, probabilities rounded to the value dtype
    before the second product. In-flight V stays in the compute dtype;
    int8-KV scales apply to the cache columns only, folded into score and
    probability columns (the exact branch folds the K scales before
    rotating)."""
    B, S, NH, Dh = q.shape
    KVH, W1 = k_cache.shape[2], k_cache.shape[1]
    n_rep = NH // KVH
    t = tables
    ks = vs = None
    if kv_scales is not None:
        ks = kv_scales[0].transpose(1, 2)[:, :, None, None, :]     # [B,KVH,1,1,W+1]
        vs = kv_scales[1].transpose(1, 2)[:, :, None, None, :]

    qf = q.float()
    if t.exact:
        kc = k_cache.float()
        if kv_scales is not None:
            kc = kc * kv_scales[0][..., None]
            ks = None                                   # K scales already folded
        kc = apply_rope(kc, t.c_cos, t.c_sin).to(q.dtype)
        # in-flight keys are stored commit-canonical at write_pos: re-rotate
        # the small block to qx
        k_if = apply_rope(k_infl.float(), t.i_cos, t.i_sin).to(q.dtype)
    else:
        kc, k_if = k_cache.to(q.dtype), k_infl
    keys = torch.cat([kc, k_if], dim=1).float()                    # [B, W+1+N, KVH, Dh]

    def grouped(cos, sin):
        return apply_rope(qf, cos, sin).to(q.dtype).reshape(B, S, KVH, n_rep, Dh).float()

    s = torch.einsum("bsgrd,bwgd->bgrsw", grouped(t.q_cos, t.q_sin), keys)
    if sink_slots:
        s[..., :sink_slots] = torch.einsum("bsgrd,bwgd->bgrsw", grouped(t.e_cos, t.e_sin),
                                           keys[:, :sink_slots])
    if ks is not None:
        s[..., :W1] *= ks
    p = torch.softmax(torch.add(t.bias, s, alpha=1.0 / math.sqrt(Dh)), dim=-1)
    if vs is not None:
        p[..., :W1] *= vs
    vdt = q.dtype if v_cache.dtype == torch.int8 else v_cache.dtype
    vals = torch.cat([v_cache.to(vdt), v_infl.to(vdt)], dim=1).float()
    out = torch.einsum("bgrsw,bwgd->bsgrd", p.to(vdt).float(), vals)
    return out.reshape(B, S, NH, Dh).to(q.dtype)


@dataclass
class StepTables:
    """What the replayed verify pass's attention needs that does not depend on
    the layer; built once per pass by ``step_tables``."""

    w_cos: torch.Tensor        # [B, N, Dh] at plans.write_pos (q and the in-flight keys)
    w_sin: torch.Tensor
    d_cos: torch.Tensor        # [n, B, W+1, Dh] each step's residual per-slot rotation
    d_sin: torch.Tensor
    mask_order: torch.Tensor   # [n, B, W+1] int32
    mask_g: torch.Tensor       # [B, N] int32
    src: torch.Tensor          # [n, B, W+1] int32: in-flight row a slot holds in step j, or -1


def step_sources(slots: torch.Tensor, steps: int, num_slots: int) -> torch.Tensor:
    """[n, B, W+1] int32: the in-flight row (of N) that slot w of row b holds
    when step j attends, had steps 0..j each written its rows into their
    ``slots`` [B, N] (``SpecPlans.slots``) in order: the latest write, the
    highest row; -1 where no step up to j wrote the slot."""
    B, N = slots.shape
    S = N // steps
    rows = torch.arange(N, device=slots.device).expand(B, N)
    held = torch.full((B, num_slots), -1, dtype=torch.long, device=slots.device)
    out = []
    for j in range(steps):
        cols = slice(j * S, (j + 1) * S)
        held = held.scatter_reduce(1, slots[:, cols].long(), rows[:, cols], "amax")
        out.append(held)
    return torch.stack(out).to(torch.int32).contiguous()


def step_tables(plans, policy: CachePolicy, head_dim: int, rope_theta: float) -> StepTables:
    """The tables of ``replayed_attention`` for one verify pass of ``plans``
    (``spec_decode.SpecPlans``): each composed step's ``chunk_tables``
    stacked, and where the in-flight rows of the steps up to it lie."""
    w_cos, w_sin = rope_cos_sin(plans.write_pos, head_dim, rope_theta)
    steps = [chunk_tables(p, policy, head_dim, rope_theta) for p in plans.steps]
    stack = lambda name: torch.stack([getattr(t, name) for t in steps]).contiguous()
    return StepTables(w_cos, w_sin, stack("d_cos"), stack("d_sin"), stack("mask_order"),
                      torch.cat([t.mask_g for t in steps], dim=1).contiguous(),
                      step_sources(plans.slots, len(steps), plans.cache_mask.shape[-1]))


def replayed_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_infl: torch.Tensor, v_infl: torch.Tensor,
                       tables: StepTables) -> torch.Tensor:
    """The verify pass's attention as the S sequential passes it composes
    compute it, on a bf16 or f32 cache, READ-ONLY: one launch of
    ``decode_attention_steps``, in which step j's rows attend as its write
    pass's ``cached_attention`` would (the kernel, path, plan and order of
    sums of a write pass of that many rows, with the step's tables) over the
    cache with the in-flight rows of steps 0..j at their slots
    (``tables.src``), rounded to the cache's dtype as a write rounds them.

    q [B, N, NH, Dh] unrotated; k_cache / v_cache [B, W+1, KVH, Dh], one
    layer's cache; k_infl / v_infl [B, N, KVH, Dh], in-flight keys
    pre-rotated at the write positions (``tables.w_cos``, ``w_sin``: the
    rotation of q too); ``tables``: ``step_tables`` of the pass. Rotations
    are elementwise, so q and the keys rotated all at once are the
    sequential passes' bits; bf16 queries against an f32 cache are widened
    as ``cached_attention`` widens them. An int8 cache would need the writes
    quantised and is not taken."""
    if k_cache.dtype == torch.int8:
        raise ValueError("replayed_attention: an int8 cache is not taken")
    t = tables
    q_rot = apply_rope(q.float(), t.w_cos, t.w_sin).to(q.dtype)
    if q.dtype == torch.bfloat16 and k_cache.dtype == torch.float32:
        q_rot = q_rot.float()
    k_infl, v_infl = (x.to(k_cache.dtype).contiguous() for x in (k_infl, v_infl))
    return decode_attention_steps(q_rot.contiguous(), k_cache, v_cache, k_infl, v_infl, t.d_cos,
                                  t.d_sin, t.mask_order, t.mask_g, t.src).to(q.dtype)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, rope_theta: float,
                     positions: torch.Tensor | None = None,
                     attn_mask: torch.Tensor | None = None,
                     rope_tables: tuple | None = None, attend=None) -> torch.Tensor:
    """Full-sequence causal attention: unrotated q [B, T, NH, Dh], k / v
    [B, T, KVH, Dh] -> [B, T, NH, Dh]. ``rope_tables`` (cos, sin) [B, T, Dh]
    are layer-invariant and passed by the decoder; else they come from
    ``positions`` [B, T] (default: 0..T-1). ``attn_mask`` [B, T] bool marks the
    real tokens of a padded batch: padded keys are seen by no query. A query
    that sees no key (a padded position of a left-padded row) gives what the
    JAX function's branch at this T gives it: its blockwise branch (T >= 1024
    and a multiple of 512) 0, as the kernels do; its dense branch (any other
    T) a uniform softmax over all T keys, so the mean of every value of its kv
    head. The loss reads such rows where a batch has no label of a kind (its
    guard puts one at position 0). ``attend(q, k, v, key_valid)`` replaces
    ``flash_causal_attention`` on the rotated operands (remat "dots" keeps
    its output)."""
    B, T, _, Dh = q.shape
    if rope_tables is not None:
        cos, sin = rope_tables
    else:
        if positions is None:
            positions = torch.arange(T, device=q.device)[None].expand(B, T)
        cos, sin = rope_cos_sin(positions, Dh, rope_theta)
    q = apply_rope(q.float(), cos, sin).to(q.dtype)
    k = apply_rope(k.float(), cos, sin).to(k.dtype)
    key_valid = None if attn_mask is None else attn_mask.bool().contiguous()
    out = (attend or flash_causal_attention)(q.contiguous(), k.contiguous(), v.contiguous(),
                                             key_valid)
    if key_valid is None or (T >= 1024 and T % 512 == 0):
        return out
    blind = torch.cumsum(key_valid.int(), dim=1) == 0                      # [B, T]
    NH, KVH = q.shape[2], k.shape[2]
    v_mean = v.float().mean(dim=1).repeat_interleave(NH // KVH, dim=1)     # [B, NH, Dh]
    return torch.where(blind[:, :, None, None], v_mean[:, None].to(out.dtype), out)
