"""Ring attention: causal attention over a sequence split across the ranks of
one mesh axis; the port's copy of ``aha_tpu/parallel/ring_attention.py``.

Each rank holds a stretch of every sequence. Its K/V block travels around the
ring with its positions and validity (``batch_isend_irecv``), the next
block's exchange started before this block's work and waited on after it, and
every rank accumulates the flash-style online softmax (m, l, acc) of its
queries over each visiting block (``_block_attn_update``, JAX's update with
its guard for a row that no key is visible to). The backward runs the ring
again: each visiting block's dK / dV accumulators travel with it and arrive
home after a full turn, while dQ stays. As JAX's, the ring is plain PyTorch
(JAX's is jnp, no Pallas kernel); a query that sees no key gives 0.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _mask(q_pos, k_pos, k_valid):
    m = q_pos[:, :, None] >= k_pos[:, None, :]                  # [B, Tq, Tk]
    if k_valid is not None:
        m = m & k_valid[:, None, :]
    return m


def _block_attn_update(q, k_blk, v_blk, m, l, acc, q_pos, k_pos, scale, k_valid=None):
    """One flash-attention block update with causal masking on global
    positions. q [B,Tq,H,D], k/v [B,Tk,H,D], m/l [B,H,Tq], acc [B,Tq,H,D];
    q_pos/k_pos [B,Tq]/[B,Tk]; k_valid [B,Tk] bool (padding keys masked)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_blk.float()) * scale
    mask = _mask(q_pos, k_pos, k_valid)
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, NEG_INF))
    m_blk = scores.amax(dim=-1)
    m_new = torch.maximum(m, m_blk)
    # guard fully-masked rows (m_new == NEG_INF): exp(NEG_INF - NEG_INF) = 1
    # would pollute l; clamp the correction to 0 instead
    row_any = m_new > NEG_INF / 2
    alpha = torch.where(row_any, torch.exp(m - m_new), torch.zeros_like(m))
    p = torch.exp(scores - m_new[..., None])
    p = torch.where(row_any[..., None], p, torch.zeros_like(p))
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v_blk.float())
    return m_new, l_new, acc_new


def _start(comm, tensors):
    """Start sending ``tensors`` to the next rank of the ring and receiving
    the previous rank's; returns (requests, receive buffers)."""
    import torch.distributed as dist

    from .comm import COUNTS, STAGED

    nxt = comm.ranks[(comm.index + 1) % comm.size]
    prv = comm.ranks[(comm.index - 1) % comm.size]
    ops, bufs = [], []
    for t in tensors:
        x = t.contiguous()
        if comm._stage("send_recv", x):
            x = comm._host(x)
            STAGED["send_recv"] += 1
        COUNTS["send_recv"] += 1
        x, unpack = comm._pack(x)
        out = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, nxt, comm.group))
        ops.append(dist.P2POp(dist.irecv, out, prv, comm.group))
        bufs.append((out, unpack, t))
    return dist.batch_isend_irecv(ops), bufs


def _finish(reqs, bufs):
    for r in reqs:
        r.wait()
    return [unpack(out).to(device=t.device) for out, unpack, t in bufs]


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos, valid, comm, scale):
        B, Tl, H, D = q.shape
        m = torch.full((B, H, Tl), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, Tl), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Tl, H, D), dtype=torch.float32, device=q.device)
        blk = [k, v, pos, valid]
        for i in range(comm.size):
            pending = _start(comm, blk) if i + 1 < comm.size else None
            m, l, acc = _block_attn_update(q, blk[0], blk[1], m, l, acc, pos, blk[2], scale,
                                           k_valid=blk[3])
            if pending is not None:
                blk = _finish(*pending)
        l = torch.clamp(l, min=1e-30)
        out = acc / l.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, pos, valid, out, m, l)
        ctx.comm, ctx.scale = comm, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, pos, valid, out, m, l = ctx.saved_tensors
        comm, scale = ctx.comm, ctx.scale
        g = g.float()
        qf = q.float()
        delta = (g * out).sum(dim=-1).transpose(1, 2)                # [B, H, Tq]
        row_any = m > NEG_INF / 2
        dq = torch.zeros_like(qf)
        blk = [k, v, pos, valid,
               torch.zeros(k.shape, dtype=torch.float32, device=k.device),
               torch.zeros(v.shape, dtype=torch.float32, device=v.device)]
        for _ in range(comm.size):
            kb, vb, pb, vld, dk, dv = blk
            scores = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
            mask = _mask(pos, pb, vld)[:, None]
            p = torch.exp(torch.where(mask, scores, torch.full_like(scores, NEG_INF))
                          - m[..., None]) / l[..., None]
            p = torch.where(mask & row_any[..., None], p, torch.zeros_like(p))
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, g)
            dp = torch.einsum("bqhd,bkhd->bhqk", g, vb.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # a full turn: the accumulators come home with their own block
            blk = [kb, vb, pb, vld, dk, dv]
            if comm.size > 1:
                blk = _finish(*_start(comm, blk))
        dk, dv = blk[4], blk[5]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_causal_attention(q, k, v, comm, *, positions=None, attn_mask=None):
    """Causal attention with the sequence split over ``comm``'s ranks: q/k/v
    [B, T_local, H, D] (RoPE applied; kv heads expanded to q's), this rank's
    stretch; ``positions`` [B, T_local] int (default: the stretch's global
    indices), ``attn_mask`` [B, T_local] bool (False = padding). Causality is
    decided on the positions, as in JAX."""
    B, Tl, H, D = q.shape
    scale = 1.0 / (D ** 0.5)
    n = 1 if comm is None else comm.size
    i = 0 if comm is None else comm.index
    if positions is None:
        positions = (torch.arange(Tl, device=q.device) + i * Tl)[None].expand(B, Tl)
    if attn_mask is None:
        attn_mask = torch.ones((B, Tl), dtype=torch.bool, device=q.device)
    positions = positions.to(torch.int32).contiguous()
    attn_mask = attn_mask.bool().contiguous()
    if n == 1:
        from .comm import Comm

        comm = Comm(None, [0], 0, "none")
    return _Ring.apply(q, k, v, positions, attn_mask, comm, scale)
