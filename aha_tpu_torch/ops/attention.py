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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .kernels.decode_attention import decode_attention
from .kv_cache import CachePolicy, UpdatePlan, reference_mask_operands
from .rope import apply_rope, rope_cos_sin


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
    Dh] (keys pre-rotated at write_pos) -> [B, S, NH, Dh] in q's dtype."""
    q_rot = apply_rope(q.float(), tables.w_cos, tables.w_sin).to(q.dtype)
    return decode_attention(q_rot.contiguous(), k_cache, v_cache, tables.d_cos,
                            tables.d_sin, tables.mask_order, tables.mask_g, kv_scales)
