"""Speculative-decode planning: exact emulation of S sequential cache updates
inside ONE read-only verify pass.

Counterpart of ``aha_tpu/ops/spec_decode.py``. A chunked ``decode_chunk(S)``
is not equivalent to S sequential 1-token passes once a window-evicting
policy is active: sequential queries attend to old keys that a chunked
write has already overwritten, and the eviction / shift bookkeeping
interleaves differently. The greedy loop being reproduced is strictly
sequential, so verifying several tokens in one weight stream must reproduce
the sequential semantics exactly:

  * ``plan_compose`` composes S metadata-only ``plan_update`` steps (each
    exactly what a pass of ``step`` tokens would do), keeping every
    intermediate. Integer ops on [B, W+1] tensors; S is small.
  * the verify pass (``qwen2.decode_chunk_spec``) is READ-ONLY: the chunk's
    K/V stay in an in-flight block, never written to the cache, and query p
    masks the cache exactly as the p-th sequential step would see it,
    including the slots that steps 0..p would have overwritten (their
    replacement keys are scored from the in-flight block).
  * ``select_meta`` / ``commit_slots`` then move the cache to the state after
    the accepted steps. Both MUTATE the cache in place (the JAX functions
    return a new pytree): metadata jumps to the m-th intermediate and only
    the accepted tokens' K/V are scattered in; rejected rows go to the junk
    slot.

Nothing here reads a tensor back to the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .kv_cache import (CachePolicy, KVCache, UpdatePlan, plan_update, quantize_kv,
                       reference_mask_operands)


def transient_deviation(plan: UpdatePlan, sink_slots: int) -> torch.Tensor:
    """[B, W+1] bool: occupied ring slots whose residual ``order - key_pos``
    deviates from the row drift ``seen - length``, i.e. slots for which
    scoring keys at their pre-rotation (write) position gives the wrong RoPE
    distance (``aha_tpu/ops/attention.py::transient_deviation``)."""
    D = (plan.g[:, :1] - plan.q_pos[:, :1]).to(torch.int32)
    slot_ids = torch.arange(plan.new_order.shape[1], dtype=torch.int32,
                            device=plan.new_order.device)[None, :]
    rho = plan.new_order - plan.new_key_pos
    return (slot_ids >= sink_slots) & (plan.new_order >= 0) & (rho != D)


@dataclass
class SpecPlans:
    """Composition of S sequential STEP-token update plans (step=1:
    speculative decode; step=F: fused frame scoring).

    Per-token operands are stacked along axis 1 ([B, N] with N = S*step
    chunk tokens); intermediate metadata along axis 0 ([S+1, ...], entry
    j = state after j steps).
    """

    slots: torch.Tensor       # [B, N] destination slot of token p (junk if invalid)
    g: torch.Tensor           # [B, N] global token index
    q_pos: torch.Tensor       # [B, N] SEQUENTIAL query position (length-capped)
    write_pos: torch.Tensor   # [B, N] key pre-rotation position (commit-canonical)
    valid: torch.Tensor       # [B, N] bool
    cache_mask: torch.Tensor  # [B, N, W+1] bool: cache columns visible to query p
    infl_mask: torch.Tensor   # [B, N, N] bool: in-flight column i visible to query p
    meta_key_pos: torch.Tensor  # [S+1, B, W+1]
    meta_order: torch.Tensor    # [S+1, B, W+1]
    meta_seen: torch.Tensor     # [S+1, B]
    meta_length: torch.Tensor   # [S+1, B]
    # exact-mode operands (rotate-at-read semantics, composed so ONE cache
    # rotation serves all S steps): step p's distance to ring slot c is
    #   q_pos_p - key_pos_c(after step p) = qx_p - key_pos_c(after step 1)
    # because the per-step sink shift is a per-row scalar: qx folds the
    # shifts accumulated at steps 2..p into the query position instead of
    # re-rotating the cache per step.
    qx: torch.Tensor          # [B, N] ring AND in-flight positions
    dpos: torch.Tensor        # [B, W+1] cache rotation: key_pos(step 1) - order
    exact: torch.Tensor       # [] bool: some step deviates from the fast
    # pre-rotation algebra (sink fill transient or the post-fill chunk /
    # decode position lag); the verify pass then takes the exact branch.
    steps: tuple = ()         # the S composed plan_update plans, in order
    # (the replayed verify pass attends through each step's own tables)


def plan_compose(cache: KVCache, policy: CachePolicy, valid_len: torch.Tensor,
                 S: int, step: int = 1) -> SpecPlans:
    """valid_len: [B] int32 in [0, S*step], the number of real tokens of this
    chunk. Composes S sequential STEP-token ``plan_update`` steps:

      * step=1: the greedy loop (position 0 is the carried token, 1.. are
        drafts); steps >= valid_len are exact no-ops, matching a 1-token
        pass with valid_len 0.
      * step=F: F-token frame appends (fused frame scoring). Valid tokens
        must be a per-row prefix in whole frames (valid_len = frames * F).

    Per-token operands come back with chunk axis S*step; metadata
    intermediates stay per STEP ([S+1, ...]: ``select_meta`` jumps in steps,
    ``commit_slots`` keeps in tokens).

    Mask semantics are exactly the write-then-attend pass, per step: a
    step's queries see (a) cache columns as the step's own ``plan_update``
    masks them (per QUERY token under mask_mode='hf', whose within-chunk
    visibility is non-causal post-fill) minus columns any step <= p already
    overwrote (their replacement keys live in-flight), and (b) in-flight
    columns of steps <= p that still own their slot, gated by the same
    per-mode visibility formula (strict: g_i <= g_q; hf: ref_idx_i(after
    step p) <= q_pos_q). Reads the cache's metadata only; mutates nothing."""
    junk = policy.junk
    T = S * step
    B = cache.batch
    dev = cache.order.device
    W1 = cache.order.shape[1]
    meta = cache
    slots, gs, q_poss, write_poss, valids, qxs = [], [], [], [], [], []
    cache_masks, infl_masks, steps = [], [], []
    metas = [(cache.key_pos, cache.order, cache.seen, cache.length)]
    written = torch.zeros((B, W1), dtype=torch.bool, device=dev)
    exact = torch.zeros((), dtype=torch.bool, device=dev)
    shift_acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    dpos = None
    sink = policy.num_sink if policy.kind == "sink" else 0
    use_hf = policy.mask_mode == "hf" and policy.kind in ("sink", "sliding")
    valid_len = valid_len.to(device=dev, dtype=torch.int32)

    # fixed-size per-token state for the in-flight masks (junk / zero padding
    # for steps not yet composed; stored_all gates them off)
    tok_idx = torch.arange(T, dtype=torch.int32, device=dev)[None, :]
    slots_all = torch.full((B, T), junk, dtype=torch.int32, device=dev)
    g_all = torch.zeros((B, T), dtype=torch.int32, device=dev)
    stored_all = torch.zeros((B, T), dtype=torch.bool, device=dev)
    # chunk index of the latest chunk token claiming each slot: an in-flight
    # column is attendable only while it still OWNS its slot (a later step
    # reusing the slot replaces it, as the sequential overwrite would; only
    # reachable when S*step nears the window)
    last_claim = torch.full((B, W1), -1, dtype=torch.int32, device=dev)

    for p in range(S):
        v_p = torch.clamp(valid_len - p * step, 0, step)
        plan = plan_update(meta, policy, v_p, step)
        steps.append(plan)
        if policy.kind == "sink":
            exact = exact | (transient_deviation(plan, sink) & plan.valid[:, :1]).any()
        if p == 0:
            # rotation taking stored keys (pre-rotated at their write_pos =
            # order under sink) to their key_pos after step 1
            dpos = torch.where(plan.new_order >= 0, plan.new_key_pos - plan.new_order,
                               torch.zeros_like(plan.new_order))
        else:
            shift_acc = shift_acc + plan.shift
        qxs.append(plan.q_pos + shift_acc[:, None])
        slots.append(plan.slots)
        gs.append(plan.g)
        q_poss.append(plan.q_pos)
        write_poss.append(plan.write_pos)
        valids.append(plan.valid)

        stored_p = plan.valid & (plan.slots != junk)           # [B, step]
        lo = p * step
        slots_all[:, lo:lo + step] = plan.slots
        g_all[:, lo:lo + step] = plan.g
        stored_all[:, lo:lo + step] = stored_p
        # tokens that are not stored go to the junk column, which is reset
        claim_idx = torch.where(stored_p, plan.slots, torch.full_like(plan.slots, junk)).long()
        last_claim = last_claim.scatter(1, claim_idx, tok_idx[:, lo:lo + step].expand(B, step))
        last_claim[:, junk] = -1

        # visibility of CACHE columns for this step's queries: what the
        # step's write-then-attend pass computes (per query token), minus
        # columns already overwritten by chunk steps 0..p, this step's own
        # included (the verify pass scores those from the in-flight block)
        if use_hf:
            ref_idx, q_cap = reference_mask_operands(plan, sink_slots=sink)
            vis = (ref_idx[:, None, :] >= 0) & (ref_idx[:, None, :] <= q_cap[:, :, None])
        else:
            vis = ((plan.new_order[:, None, :] >= 0)
                   & (plan.new_order[:, None, :] <= plan.g[:, :, None]))
        # (junk writes excluded: invisible anyway, and under the static
        # policy the old junk content must stay invisible)
        written = written | torch.zeros_like(written).scatter(1, claim_idx, stored_p)
        written[:, junk] = False
        cache_masks.append(vis & ~written[:, None, :])         # [B, step, W+1]

        # in-flight columns: sequential step p sees chunk token i of steps
        # <= p iff token i was actually stored (slot != junk), still owns
        # its slot, and passes the step's visibility formula. A valid token
        # on a non-junk slot sees itself, like the write-then-attend pass;
        # static-policy and invalid tokens go to junk and stay invisible
        # even to themselves.
        owns = torch.gather(last_claim, 1, slots_all.long()) == tok_idx   # [B, T]
        base = stored_all & owns
        if use_hf:
            evicted = (plan.new_seen - plan.new_length)[:, None]
            ref_i = g_all - torch.where(slots_all >= sink, evicted, torch.zeros_like(evicted))
            form = ref_i[:, None, :] <= q_cap[:, :, None]
        else:
            form = g_all[:, None, :] <= plan.g[:, :, None]
        infl_masks.append(base[:, None, :] & form)             # [B, step, T]

        meta = dataclasses.replace(meta, key_pos=plan.new_key_pos, order=plan.new_order,
                                   seen=plan.new_seen, length=plan.new_length)
        metas.append((plan.new_key_pos, plan.new_order, plan.new_seen, plan.new_length))

    def cat1(xs):
        return torch.cat(xs, dim=1)

    return SpecPlans(
        slots=cat1(slots), g=cat1(gs), q_pos=cat1(q_poss), write_pos=cat1(write_poss),
        valid=cat1(valids), cache_mask=cat1(cache_masks), infl_mask=cat1(infl_masks),
        meta_key_pos=torch.stack([m[0] for m in metas]),
        meta_order=torch.stack([m[1] for m in metas]),
        meta_seen=torch.stack([m[2] for m in metas]),
        meta_length=torch.stack([m[3] for m in metas]),
        qx=cat1(qxs), dpos=dpos, exact=exact, steps=tuple(steps),
    )


def build_draft_hist(ctx_ids: torch.Tensor | None, ctx_len: torch.Tensor | None,
                     ids: torch.Tensor, lens: torch.Tensor,
                     extra: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Contiguous n-gram draft history for ``ngram_draft``: [context]
    [prompt] [room for ``extra`` generated tokens], ragged rows packed left,
    -1 in unused columns (never matches a real token id). ctx_ids [B, C] or
    None, ctx_len [B], ids [B, P], lens [B]. Returns ``(hist [B, C+P+extra]
    int32, hist_len [B] int32)``."""
    B, P = ids.shape
    dev = ids.device
    C = 0 if ctx_ids is None else ctx_ids.shape[1]
    M = C + P + extra
    # one spare column takes the writes of masked-off positions
    hist = torch.full((B, M + 1), -1, dtype=torch.int32, device=dev)
    if C:
        ccols = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        ctx_len = ctx_len.to(torch.int32)
        hist[:, :C] = torch.where(ccols < ctx_len[:, None], ctx_ids.to(torch.int32),
                                  torch.full_like(ccols, -1))
        off = ctx_len
    else:
        off = torch.zeros((B,), dtype=torch.int32, device=dev)
    lens = lens.to(torch.int32)
    cols = torch.arange(P, dtype=torch.int32, device=dev)[None, :]
    real = cols < lens[:, None]
    dest = torch.where(real, off[:, None] + cols, torch.full_like(cols, M)).long()
    hist.scatter_(1, dest, torch.where(real, ids.to(torch.int32), torch.full_like(cols, -1)))
    return hist[:, :M].contiguous(), off + lens


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, carry: torch.Tensor,
                n_draft: int) -> torch.Tensor:
    """Self-drafting by n-gram lookup (prompt-lookup decoding): propose the
    continuation that followed the most recent earlier occurrence of the
    LONGEST matching suffix: trigram (prev, last, carry) first, then bigram
    (last, carry), then unigram (carry); no match -> zeros. "Most recent" is
    the largest matching column index (a maximum over indices, so there is
    no tie to break). Drafts are proposals only: the verify pass accepts
    exactly the prefix that matches sequential greedy argmax, so draft
    quality affects speed, never output.

    hist [B, M] (contiguous: prompt then generated tokens, -1 in unused
    columns), hist_len [B], carry [B] (the next token to be written).
    Returns drafts [B, n_draft] int32."""
    B, M = hist.shape
    dev = hist.device
    bidx = torch.arange(B, device=dev)
    hist_len = hist_len.to(torch.int32)
    carry = carry.to(torch.int32)
    # place carry at hist[hist_len]: the sequence suffix ends ...last, carry
    h = hist.clone()
    h[bidx, torch.clamp(hist_len, max=M - 1).long()] = carry
    L = hist_len + 1                                      # [B] length incl. carry
    idx = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    key_c = h[bidx, torch.clamp(L - 3, min=0).long()]     # token before last
    key_a = h[bidx, torch.clamp(L - 2, min=0).long()]     # last written token
    key_b = carry

    def latest(match):                                    # [B, M] -> [B], -1 none
        return torch.where(match, idx, torch.full_like(idx, -1)).amax(dim=1)

    fill = torch.full((B, 2), -1, dtype=h.dtype, device=dev)
    nxt = torch.cat([h[:, 1:], fill[:, :1]], dim=1)
    nxt2 = torch.cat([h[:, 2:], fill], dim=1)
    Lc = L[:, None]
    # trigram: h[j], h[j+1], h[j+2] == key_c, key_a, key_b; the continuation
    # starts at j+3 (j+2 < L-1 excludes the suffix itself)
    m3 = ((h == key_c[:, None]) & (nxt == key_a[:, None]) & (nxt2 == key_b[:, None])
          & (idx + 3 < Lc) & (Lc >= 3))
    j3 = latest(m3)
    m2 = ((h == key_a[:, None]) & (nxt == key_b[:, None]) & (idx + 2 < Lc) & (Lc >= 2))
    j2 = latest(m2)
    m1 = (h == key_b[:, None]) & (idx + 1 < Lc)
    j1 = latest(m1)
    none = torch.full_like(j1, M)
    start = torch.where(j3 >= 0, j3 + 3,
                        torch.where(j2 >= 0, j2 + 2, torch.where(j1 >= 0, j1 + 1, none)))
    pos = start[:, None] + torch.arange(n_draft, dtype=torch.int32, device=dev)[None, :]
    ok = pos < Lc
    drafts = torch.gather(h, 1, torch.clamp(pos, 0, M - 1).long())
    return torch.where(ok & (drafts >= 0), drafts, torch.zeros_like(drafts)).to(torch.int32)


def select_meta(cache: KVCache, plans: SpecPlans, m_cache: torch.Tensor) -> KVCache:
    """Jump each row's metadata to the state after its accepted m_cache
    (in [0, S]) sequential steps. MUTATES ``cache`` (metadata only)."""
    m = m_cache.long()

    def pick(stack):  # [S+1, B, ...] -> [B, ...]
        idx = m.reshape(1, -1, *([1] * (stack.dim() - 2))).expand(1, *stack.shape[1:])
        return torch.gather(stack, 0, idx)[0]

    cache.key_pos.copy_(pick(plans.meta_key_pos))
    cache.order.copy_(pick(plans.meta_order))
    cache.seen.copy_(pick(plans.meta_seen))
    cache.length.copy_(pick(plans.meta_length))
    return cache


def commit_slots(cache: KVCache, plans: SpecPlans, infl_k: torch.Tensor,
                 infl_v: torch.Tensor, m_cache: torch.Tensor, junk: int) -> KVCache:
    """Scatter the accepted tokens' K/V into their planned slots, IN PLACE on
    ``cache.k`` / ``cache.v`` (and the scales of an int8 cache).

    infl_k / infl_v: [L, B, N, KVH, Dh], keys pre-rotated at
    ``plans.write_pos``; m_cache [B]: accepted chunk tokens (0..N). Rejected
    and invalid columns go to the junk slot. An int8 cache quantizes the
    in-flight block here (per (token, head) scales, like ``write_layer``)."""
    if cache.rows is not None:
        # sharded serving: the in-flight block holds this rank's rows only
        from ..parallel.sharded import row_slice

        plans, m_cache = row_slice(plans, *cache.rows), m_cache[cache.rows[0]:cache.rows[1]]
    N = infl_k.shape[2]
    dev = infl_k.device
    keep = torch.arange(N, dtype=torch.int32, device=dev)[None, :] < m_cache[:, None]
    slots = torch.where(keep & plans.valid, plans.slots,
                        torch.full_like(plans.slots, junk)).long()       # [B, N]
    bidx = torch.arange(slots.shape[0], device=dev)[:, None]
    if cache.quantized:
        infl_k, k_sc = quantize_kv(infl_k)
        infl_v, v_sc = quantize_kv(infl_v)
        cache.k_scale[:, bidx, slots] = k_sc
        cache.v_scale[:, bidx, slots] = v_sc
    cache.k[:, bidx, slots] = infl_k.to(cache.k.dtype)
    cache.v[:, bidx, slots] = infl_v.to(cache.v.dtype)
    return cache
