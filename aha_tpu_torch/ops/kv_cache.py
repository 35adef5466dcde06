"""Ring-buffer KV cache with the sink / sliding / static / none policies.

Counterpart of ``aha_tpu/ops/kv_cache.py`` (which imports jax, so the policy
is declared again here). The cache is a preallocated buffer of
``window + 1`` slots per layer; slot ``window`` is the junk slot that
takes the writes of padded tokens, and its ``order`` is kept at -1 so that
it is never visible. Each slot records ``order`` (the global index of the
token it holds, -1 when empty) and ``key_pos`` (the RoPE position the
reference would rotate its key by). Keys are stored pre-rotated at
``plan.write_pos``; ``ops/attention.py`` scores them with a per-slot residual
rotation.

Unlike the JAX cache, which is an immutable pytree threaded through jit,
this one is updated in place: ``write_layer`` scatters into the layer's view
of the stacked ``[L, B, W+1, KVH, Dh]`` buffers and ``advance`` overwrites
the metadata. That keeps one copy of the cache in device memory; callers
that need the old state (rollback) take ``cache.clone()`` first.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .rope import apply_rope


@dataclass(frozen=True)
class CachePolicy:
    """kind: 'none' | 'sliding' | 'sink' | 'static'; see the JAX policy's
    docstring for the 'hf' / 'strict' mask modes. There are always
    ``window + 1`` slots: the attention kernel masks the ragged tail itself,
    so the JAX policy's ``slot_pad`` (block alignment) has no counterpart."""

    kind: str = "sink"
    window: int = 2048
    num_sink: int = 32
    mask_mode: str = "hf"

    def __post_init__(self):
        if self.kind not in ("none", "sliding", "sink", "static"):
            raise ValueError(f"unknown cache kind {self.kind}")
        if self.kind == "sink" and not 0 <= self.num_sink < self.window:
            raise ValueError("need 0 <= num_sink < window")
        if self.mask_mode not in ("hf", "strict"):
            raise ValueError(f"unknown mask_mode {self.mask_mode}")

    @property
    def num_slots(self) -> int:
        return self.window + 1

    @property
    def junk(self) -> int:
        return self.window


@dataclass
class KVCache:
    k: torch.Tensor        # [L, B, W+1, KVH, Dh] keys, pre-rotated at write_pos
    v: torch.Tensor        # [L, B, W+1, KVH, Dh]
    key_pos: torch.Tensor  # [B, W+1] int32
    order: torch.Tensor    # [B, W+1] int32, -1 = empty
    seen: torch.Tensor     # [B] int32, tokens ever offered
    length: torch.Tensor   # [B] int32, logical cache length
    k_scale: torch.Tensor | None = None   # [L, B, W+1, KVH] f32 (int8 KV only)
    v_scale: torch.Tensor | None = None
    # sharded serving (parallel/mesh.py::shard_cache): the global rows [r0, r1)
    # whose K/V this rank holds; the metadata above is every row's
    rows: tuple | None = None

    @property
    def batch(self) -> int:
        return self.order.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def clone(self) -> "KVCache":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).clone() for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def init_cache(policy: CachePolicy, *, num_layers: int, batch: int,
               num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    """An empty cache on ``device`` (the card unless the caller asks for
    ``"cpu"``). dtype=torch.int8 stores K/V per (slot, head) quantized, with f32
    scales (the JAX package's int8 KV option)."""
    W1 = policy.num_slots
    shape = (num_layers, batch, W1, num_kv_heads, head_dim)
    quant = dtype == torch.int8
    i32 = dict(dtype=torch.int32, device=device)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        key_pos=torch.zeros((batch, W1), **i32),
        order=torch.full((batch, W1), -1, **i32),
        seen=torch.zeros((batch,), **i32),
        length=torch.zeros((batch,), **i32),
        k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device) if quant else None,
        v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=device) if quant else None,
    )


def reset_cache(cache: KVCache) -> KVCache:
    """Empty the metadata in place; stale K/V stay and are masked out."""
    cache.order.fill_(-1)
    cache.key_pos.zero_()
    cache.seen.zero_()
    cache.length.zero_()
    return cache


def reset_cache_rows(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """Empty the metadata of the rows where ``rows`` ([B] bool) is True, in
    place: the slot of a finished stream is recycled for the next one
    (continuous batching). As in ``reset_cache``, their stale K/V stay and
    are masked out."""
    r = torch.as_tensor(rows, dtype=torch.bool, device=cache.order.device)
    cache.order.masked_fill_(r[:, None], -1)
    cache.key_pos.masked_fill_(r[:, None], 0)
    cache.seen.masked_fill_(r, 0)
    cache.length.masked_fill_(r, 0)
    return cache


@dataclass
class UpdatePlan:
    """Where a chunk of S new tokens goes ([B, S] unless noted); computed
    once per chunk and shared by all layers."""

    slots: torch.Tensor      # destination slot per token (junk when invalid)
    g: torch.Tensor          # global token index
    q_pos: torch.Tensor      # effective RoPE position of the query
    write_pos: torch.Tensor  # position keys are rotated at before storage
    valid: torch.Tensor      # bool, token is real
    shift: torch.Tensor      # [B] sink-policy key_pos shift of retained ring slots
    new_key_pos: torch.Tensor  # [B, W+1]
    new_order: torch.Tensor    # [B, W+1]
    new_seen: torch.Tensor     # [B]
    new_length: torch.Tensor   # [B]


def plan_update(cache: KVCache, policy: CachePolicy, valid_len: torch.Tensor,
                S: int) -> UpdatePlan:
    """valid_len: [B] int32, number of real tokens in the S-sized chunk."""
    W, junk = policy.window, policy.junk
    B = cache.batch
    dev = cache.order.device
    valid_len = valid_len.to(device=dev, dtype=torch.int32)
    i = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    valid = i < valid_len[:, None]
    g = cache.seen[:, None] + i
    q_pos = cache.length[:, None] + i

    if policy.kind == "none":
        slots = g
    elif policy.kind == "sliding":
        slots = g % W
    elif policy.kind == "sink":
        s = policy.num_sink
        slots = torch.where(g < s, g, s + (g - s) % (W - s))
    else:  # static: only the first chunk is ever kept
        first_chunk = (cache.seen == 0)[:, None]
        slots = torch.where(first_chunk & (g < W), g, torch.full_like(g, junk))
    slots = torch.where(valid, slots, torch.full_like(slots, junk)).to(torch.int32)

    # sink-policy eviction event: retained ring keys shift back by the chunk
    if policy.kind == "sink":
        event = (cache.length + valid_len) >= W
        shift = torch.where(event, valid_len, torch.zeros_like(valid_len))
    else:
        shift = torch.zeros((B,), dtype=torch.int32, device=dev)

    slot_idx = torch.arange(policy.num_slots, dtype=torch.int32, device=dev)[None, :]
    if policy.kind == "sink":
        is_ring = slot_idx >= policy.num_sink
    else:
        is_ring = torch.zeros_like(slot_idx, dtype=torch.bool)
    occupied = cache.order >= 0
    key_pos = torch.where(is_ring & occupied, cache.key_pos - shift[:, None],
                          cache.key_pos)
    idx = slots.long()
    # duplicate indices only ever hit the junk slot, whose order is reset below
    key_pos = key_pos.scatter(1, idx, q_pos)
    order = cache.order.scatter(1, idx, g)
    order[:, junk] = -1

    new_seen = cache.seen + valid_len
    if policy.kind == "none":
        new_length = cache.length + valid_len
    elif policy.kind == "static":
        new_length = torch.where(cache.seen == 0, torch.clamp(valid_len, max=W),
                                 cache.length)
    else:
        new_length = torch.clamp(cache.length + valid_len, max=W)

    return UpdatePlan(
        slots=slots, g=g, q_pos=q_pos,
        write_pos=g if policy.kind == "sink" else q_pos,
        valid=valid, shift=shift, new_key_pos=key_pos, new_order=order,
        new_seen=new_seen, new_length=new_length,
    )


def quantize_kv(x: torch.Tensor):
    """[B, S, KVH, Dh] -> (int8 values, f32 scales [B, S, KVH]), symmetric
    per (token, head)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def write_layer(k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, plan: UpdatePlan,
                k_scale: torch.Tensor | None = None,
                v_scale: torch.Tensor | None = None, *, rot: tuple):
    """Scatter a chunk into one layer's slots, IN PLACE on the given views
    (k_cache/v_cache [B, W+1, KVH, Dh], scales [B, W+1, KVH]).

    rot=(cos, sin) at plan.write_pos: keys are rotated in f32 and then cast
    to the cache dtype. Returns (k_cache, v_cache, k_scale, v_scale)."""
    k_new = apply_rope(k_new.float(), *rot).to(k_new.dtype)
    bidx = torch.arange(k_cache.shape[0], device=k_cache.device)[:, None]
    idx = (bidx, plan.slots.long())
    if k_cache.dtype == torch.int8:
        k_new, ks = quantize_kv(k_new)
        v_new, vs = quantize_kv(v_new)
        k_scale[idx] = ks
        v_scale[idx] = vs
    k_cache[idx] = k_new.to(k_cache.dtype)
    v_cache[idx] = v_new.to(v_cache.dtype)
    return k_cache, v_cache, k_scale, v_scale


def advance(cache: KVCache, plan: UpdatePlan) -> KVCache:
    """Commit the chunk's metadata in place (K/V were written by
    write_layer inside the layer loop)."""
    cache.key_pos.copy_(plan.new_key_pos)
    cache.order.copy_(plan.new_order)
    cache.seen.copy_(plan.new_seen)
    cache.length.copy_(plan.new_length)
    return cache


def reference_mask_operands(plan: UpdatePlan, *, sink_slots: int = 0):
    """(ref_idx [B, W+1], q_pos [B, S]) such that ``ref_idx >= 0 & ref_idx
    <= q_pos`` is the reference's HF visibility (mask_mode='hf'): a ring
    slot's index in the reference's concatenated cache is its order minus
    the evicted count. The attention kernel takes them as (order, g)."""
    evicted = (plan.new_seen - plan.new_length)[:, None]
    order = plan.new_order
    ref_idx = order - torch.where(order >= sink_slots, evicted, torch.zeros_like(evicted))
    ref_idx = torch.where(order >= 0, ref_idx, torch.full_like(ref_idx, -1))
    return ref_idx.to(torch.int32), plan.q_pos
