"""StreamEngine: the compute primitives behind streaming inference, for one
stream or ``batch`` of them.

Counterpart of ``aha_tpu/streaming/engine.py``, ``engine_core.py`` and
``engine_generate.py``: cache creation and reset (whole or by rows), frame
pre-encoding, text / frame / text+frame chunk appends, per-frame and fused
frame scoring (``fused_frames`` frames per weight stream through the
read-only verify pass), the trigger loops that score until a stopping rule
fires (``engine_trigger.py``), the serving iteration of multi-stream serving
(``engine_serve.py``), greedy generation with repetition penalty, and its
speculative form (``spec_tokens`` candidates per weight stream, widening to
``spec_max`` while drafts are being accepted), which writes the same tokens.

LoRA adapters (``lora``, ``lora_scale``) apply at every decoder pass of every
row, write passes and verify passes alike, as in JAX's engine; the vision
tower and the projector take none.

Every row is an independent stream: ``active`` [B] flags (or per-row valid
lengths) keep a row out of a pass, and an inactive row appends zero valid
tokens, whose writes go to the cache's junk slot, so its cache slice never
moves.

The cache is updated IN PLACE by every append, by ``commit_frames``, by
the trigger loops and by both generation loops (the JAX engine donates it
instead); the verify pass itself only reads it. Each method returns what the caller reads
(scores, logits, ids).
Id chunks are not padded to buckets: JAX pads only for static shapes, and a
padded token goes to the junk slot, so padding carries no meaning.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AhaConfig
from ..models import aha, qwen2
from ..ops import spec_decode
from ..ops.kv_cache import CachePolicy, KVCache, init_cache, reset_cache, reset_cache_rows
from ..ops.quant import BACKENDS
from .engine_serve import ServeLoop
from .engine_trigger import TriggerLoops


def _apply_repetition_penalty(logits: torch.Tensor, counts: torch.Tensor,
                              penalty: float | None) -> torch.Tensor:
    """Tokens generated before (counts > 0): positive logits divided by the
    penalty, negative ones multiplied (RepetitionPenaltyLogitsProcessor)."""
    if penalty is None:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(counts > 0, penalized, logits)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


VISION_BATCH = 32   # frames per tower call (the reference's batch)

# Acceptance-adaptive speculation: a verify pass at width S commits 1..S
# tokens per decoding row; the committed fraction (of the pass's ACHIEVABLE
# tokens) feeds an EMA, and while the EMA exceeds SPEC_EMA_HI the next pass
# widens to spec_max; the width drops back as soon as acceptance fades.
# Speed-only state: outputs do not depend on the width.
SPEC_EMA_ALPHA = 0.35
SPEC_EMA_HI = 0.7


class StreamEngine(TriggerLoops, ServeLoop):
    """Params and compute primitives for one (config, cache policy) pair on
    one device, for ``batch`` streams (the rows of its caches)."""

    def __init__(self, params: dict, cfg: AhaConfig, policy: CachePolicy, *,
                 device="cuda", batch: int = 1, max_new_tokens: int = 200,
                 repetition_penalty: float | None = None,
                 kv_dtype: torch.dtype | None = None, backend: str = "fused",
                 spec_tokens: int = 1, spec_tokens_max: int | None = None,
                 fused_score_frames: int = 1, lora: dict | None = None,
                 lora_scale: float = 0.0, mesh=None):
        """Runs on the card unless ``device`` says otherwise, and raises when
        there is none. ``backend``: the quantized-matmul kernels
        (``ops.quant.BACKENDS``). ``spec_tokens``: candidates verified per
        generation pass (1 = the sequential loop); ``spec_tokens_max``: the
        adaptive ceiling (None or <= spec_tokens = fixed width).
        ``fused_score_frames``: frames per pass in ``score_stream`` and in
        the trigger loops. ``lora``: adapters ``{proj: {"a": [L, in, r], "b":
        [L, r, out]}}`` on the engine's device, added at ``lora_scale`` in
        every decoder pass.

        ``mesh`` (``parallel.mesh.Mesh``, one process a rank): every rank
        passes the whole tree and keeps its blocks (``param_specs``; a merged
        decoder merges each rank's own q/k/v and gate/up blocks), the cache's
        K/V by ``cache_specs`` (kv heads over ``model``, rows over ``data``)
        with every row's metadata, and every method returns every row's
        results on every rank, so that the ranks take the same host decisions
        (``qwen2.decode_chunk``)."""
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("StreamEngine: device cuda requested but no GPU is "
                                   "available (pass device='cpu' to run on the host)")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
        if backend not in BACKENDS:
            raise ValueError(f"unknown matmul backend {backend!r}; one of {BACKENDS}")
        self.backend = backend
        self.spec_tokens = max(int(spec_tokens), 1)
        self.spec_max = max(int(spec_tokens_max or 0), self.spec_tokens)
        if self.spec_tokens <= 1:
            self.spec_max = 1            # speculation off: no widening
        self.fused_frames = max(int(fused_score_frames), 1)
        self.batch = int(batch)
        self._spec_ema = np.float32(0.0)   # acceptance EMA, kept across responses
        self.last_spec_info = None         # (passes, committed, EMA) of the last call
        self.spec_totals = [0, 0]        # run-level [verify passes, committed tokens]
        for t in _leaves({"params": params, "lora": lora or {}}):
            if t.device != self.device:
                raise ValueError(f"param on {t.device}, engine on {self.device}")
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.sh = self.lora_sh = None
        if self.mesh is not None:
            from ..parallel.mesh import apply_named_sharding, param_specs
            from ..parallel.sharded import Shard, place

            merged = "qkv_proj" in params["llm"]["layers"]
            params, specs = place(params, self.mesh, q_dim=cfg.llm.q_dim,
                                  kv_dim=cfg.llm.kv_dim, merge=merged)
            self.sh = Shard(self.mesh, specs)
            if lora is not None:
                lspecs = param_specs(lora, self.mesh, prefix=("lora",))
                lora = apply_named_sharding(lora, self.mesh, lspecs)
                self.lora_sh = Shard(self.mesh, lspecs)
        self.params = params
        self.lora, self.lora_scale = lora, lora_scale
        self.cfg = cfg
        self.policy = policy
        self.max_new_tokens = max_new_tokens
        self.repetition_penalty = repetition_penalty
        self.dtype = aha.torch_dtype(cfg.dtype)
        self.kv_dtype = kv_dtype or self.dtype

    # -- cache --------------------------------------------------------------

    def new_cache(self) -> KVCache:
        llm = self.cfg.llm
        kw = dict(num_layers=llm.num_layers, head_dim=llm.head_dim, dtype=self.kv_dtype)
        if self.mesh is None:
            return init_cache(self.policy, batch=self.batch, num_kv_heads=llm.num_kv_heads,
                              device=self.device, **kw)
        from ..parallel.mesh import cache_specs, local_shape, shard_cache

        # K/V made at their local shape, the metadata whole
        whole = init_cache(self.policy, batch=self.batch, num_kv_heads=llm.num_kv_heads,
                           device="meta", **kw)
        B, KVH = (local_shape(whole.k.shape, cache_specs(whole, self.mesh)["k"],
                              self.mesh)[i] for i in (1, 3))
        local = init_cache(self.policy, batch=B, num_kv_heads=KVH, device=self.device, **kw)
        meta = init_cache(self.policy, batch=self.batch, num_kv_heads=1, num_layers=1,
                          head_dim=1, dtype=self.kv_dtype, device=self.device)
        for f in ("key_pos", "order", "seen", "length"):
            setattr(local, f, getattr(meta, f))
        return shard_cache(local, self.mesh, local=True)

    def reset_cache(self, cache: KVCache) -> KVCache:
        return reset_cache(cache)

    def reset_cache_rows(self, cache: KVCache, rows) -> KVCache:
        """Recycle finished slots: empty the metadata of the rows where
        ``rows`` ([B] bool) is True, in place."""
        return reset_cache_rows(cache, rows)

    def new_rep_counts(self) -> torch.Tensor:
        return torch.zeros((self.batch, self.cfg.llm.vocab_size), dtype=torch.int32,
                           device=self.device)

    def _active(self, active, B: int) -> torch.Tensor | None:
        return None if active is None else torch.as_tensor(active, dtype=torch.bool,
                                                           device=self.device).reshape(B)

    # -- chunks ---------------------------------------------------------------

    def pad_ids(self, ids_list: list[list[int]]) -> tuple[torch.Tensor, torch.Tensor]:
        """Right-pad id lists to their longest (at least 1 column)."""
        P = max([len(x) for x in ids_list] + [1])
        arr = np.zeros((len(ids_list), P), np.int64)
        for i, x in enumerate(ids_list):
            arr[i, :len(x)] = x
        lens = np.asarray([len(x) for x in ids_list], np.int32)
        return (torch.as_tensor(arr, device=self.device),
                torch.as_tensor(lens, device=self.device))

    @property
    def _llm_sh(self):
        return None if self.sh is None else self.sh.sub("llm")

    def _embed(self, ids: torch.Tensor) -> torch.Tensor:
        return qwen2.embed_tokens(self.params["llm"], ids, self.dtype, self._llm_sh)

    def _decode(self, cache: KVCache, embeds: torch.Tensor, valid_len: torch.Tensor):
        return qwen2.decode_chunk(self.params["llm"], self.cfg.llm, self.policy, cache,
                                  embeds, valid_len, backend=self.backend, lora=self.lora,
                                  lora_scale=self.lora_scale, sh=self._llm_sh,
                                  lora_sh=self.lora_sh)

    def _verify(self, cache: KVCache, embeds: torch.Tensor, plans):
        """The read-only verify pass, its attention replayed on a bf16 or f32
        cache (each row the bits of its sequential pass) and composed on an
        int8 one, as JAX composes it."""
        return qwen2.decode_chunk_spec(self.params["llm"], self.cfg.llm, self.policy, cache,
                                       embeds, plans, backend=self.backend,
                                       lora=self.lora, lora_scale=self.lora_scale,
                                       sh=self._llm_sh, lora_sh=self.lora_sh)

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return qwen2.lm_logits(self.params["llm"], self.cfg.llm, hidden, self.backend,
                               self._llm_sh).float()

    @staticmethod
    def _last_valid(x: torch.Tensor, valid_len: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(valid_len.long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def append_ids(self, cache: KVCache, ids_list: list[list[int]]) -> torch.Tensor:
        """Feed id chunks (an empty list: the row appends nothing); returns
        f32 logits [B, V] at each row's last real token."""
        return self._append_padded(cache, *self.pad_ids(ids_list))

    def _append_padded(self, cache: KVCache, ids: torch.Tensor, lens: torch.Tensor):
        embeds = self._embed(ids)
        hidden = self._decode(cache, embeds, lens)
        return self._logits(self._last_valid(hidden, lens))

    def append_frames(self, cache: KVCache, frame_embeds: torch.Tensor,
                      active=None) -> torch.Tensor:
        """frame_embeds [B, F, H]; returns scores [B, 3] at the last token.
        ``active`` [B] bool: the other rows append nothing (their scores are
        garbage)."""
        B, F = frame_embeds.shape[:2]
        valid = torch.full((B,), F, dtype=torch.int32, device=self.device)
        act = self._active(active, B)
        if act is not None:
            valid = torch.where(act, valid, 0)
        hidden = self._decode(cache, frame_embeds, valid)
        return aha.scores_from_hidden(self.params, hidden[:, -1])

    def append_text_frames(self, cache: KVCache, ids_list: list[list[int]],
                           frame_embeds: torch.Tensor, active=None) -> torch.Tensor:
        """One chunk per row: its text prefix immediately followed by one
        frame (the reference's forward boundary, semantic under the 'hf'
        mask once the window is full). Returns scores [B, 3] at the frame's
        last token. ``active`` [B] bool: the other rows append nothing."""
        ids, lens = self.pad_ids(ids_list)
        B, P = ids.shape
        F = frame_embeds.shape[1]
        text = self._embed(ids)
        j = torch.arange(P + F, device=self.device)[None, :]
        n = lens.long()[:, None]
        bidx = torch.arange(B, device=self.device)[:, None]
        emb = torch.where((j < n)[..., None], text[bidx, j.clamp(max=P - 1)],
                          frame_embeds[bidx, (j - n).clamp(0, F - 1)])
        valid = lens + F
        act = self._active(active, B)
        if act is not None:
            valid = torch.where(act, valid, 0)
        hidden = self._decode(cache, emb, valid)
        return aha.scores_from_hidden(self.params, self._last_valid(hidden, valid))

    def verify_frames(self, cache: KVCache, frame_embeds: torch.Tensor,
                      n_active: torch.Tensor | None = None):
        """k frame appends verified in ONE weight stream, READ-ONLY:
        frame_embeds [B, k, F, H] -> (scores [B, k, 3], pending), where
        ``commit_frames(cache, pending, m)`` then moves the cache to where m
        sequential ``append_frames`` calls would leave it.

        The verify pass over plans composed with ``step=F`` reproduces k
        sequential ``decode_chunk(F)`` steps exactly, for every policy and
        fill state, while streaming the weights once; on a bf16 or f32 cache
        its attention is the steps' write passes replayed in one launch of
        the cached-attention kernel (``replayed_attention``), each frame's
        rows with the bits of its own pass. ``n_active`` [B]:
        frames of each row that are real, a per-row prefix (the padded tail
        of a stream); their scores are garbage."""
        B, k, F, H = frame_embeds.shape
        if n_active is None:
            n_active = torch.full((B,), k, dtype=torch.int32, device=self.device)
        plans = spec_decode.plan_compose(cache, self.policy, n_active * F, k, step=F)
        hidden, infl_k, infl_v = self._verify(cache, frame_embeds.reshape(B, k * F, H), plans)
        scores = aha.scores_from_hidden(self.params, hidden[:, F - 1::F])
        return scores, (plans, infl_k, infl_v, F)

    def commit_frames(self, cache: KVCache, pending, m: torch.Tensor) -> None:
        """Commit the first m [B] frames of a ``verify_frames`` pass (at most
        its active ones): the metadata of the m-th composed step and those
        frames' K/V. Both writes read only the plans, so their order does
        not matter. MUTATES ``cache``."""
        plans, infl_k, infl_v, F = pending
        spec_decode.select_meta(cache, plans, m)
        spec_decode.commit_slots(cache, plans, infl_k, infl_v, m * F, self.policy.junk)

    def append_frames_fused(self, cache: KVCache, frame_embeds: torch.Tensor,
                            n_active: torch.Tensor | None = None) -> torch.Tensor:
        """``verify_frames`` and the commit of every active frame: nothing can
        be rejected (the inputs are known in advance). Returns scores
        [B, k, 3]. MUTATES ``cache``."""
        B, k = frame_embeds.shape[:2]
        if n_active is None:
            n_active = torch.full((B,), k, dtype=torch.int32, device=self.device)
        scores, pending = self.verify_frames(cache, frame_embeds, n_active)
        self.commit_frames(cache, pending, n_active)
        return scores

    def score_stream(self, cache: KVCache, frames: torch.Tensor, active=None) -> torch.Tensor:
        """frames [B, T, F, H] -> scores [B, T, 3]: one frame chunk at a
        time, or, with ``fused_frames`` > 1, groups of that many frames per
        weight stream (the tail padded with inactive frames). ``active``
        [B, T] bool, a per-row prefix: the frames of a ragged batch that are
        real (the others are appended by nobody; their scores are garbage).
        Neither form has a host sync inside the loop on a bf16 or f32 cache
        (on an int8 one the fused form reads one scalar a pass: the composed
        verify pass's gate)."""
        B, T = frames.shape[:2]
        if T == 0:
            return torch.zeros((B, 0, 3), device=self.device)
        act = (torch.ones((B, T), dtype=torch.bool, device=self.device) if active is None
               else torch.as_tensor(active, dtype=torch.bool, device=self.device))
        k = self.fused_frames
        if k == 1:
            return torch.stack([self.append_frames(cache, frames[:, t],
                                                   None if active is None else act[:, t])
                                for t in range(T)], dim=1)
        n_act = act.to(torch.int32)
        scores = []
        for t in range(0, T, k):
            chunk = frames[:, t:t + k]
            n = chunk.shape[1]
            if n < k:
                chunk = torch.cat([chunk, chunk.new_zeros((B, k - n, *chunk.shape[2:]))], dim=1)
            scores.append(self.append_frames_fused(cache, chunk,
                                                   n_act[:, t:t + k].sum(dim=1))[:, :n])
        return torch.cat(scores, dim=1)

    def encode_frames(self, frames) -> torch.Tensor:
        """[N, H, W, 3] pixels -> [N, F, H_llm], VISION_BATCH frames at a time."""
        frames = torch.as_tensor(frames, device=self.device)
        outs = [aha.visual_embed(self.params, self.cfg, frames[i:i + VISION_BATCH],
                                 self.backend, self.sh)
                for i in range(0, frames.shape[0], VISION_BATCH)]
        if not outs:
            return torch.zeros((0, self.cfg.frame_num_tokens, self.cfg.llm.hidden_size),
                               dtype=self.dtype, device=self.device)
        return torch.cat(outs, dim=0)

    # -- generation -----------------------------------------------------------

    def _prompt(self, ids_list, active):
        """The prompt chunk (ids [B, P], valid lengths [B]); an inactive row's
        prompt is skipped (0 valid tokens)."""
        ids, lens = self.pad_ids(ids_list)
        act = self._active(active, ids.shape[0])
        if act is not None:
            lens = torch.where(act, lens, 0)
        return ids, lens, act

    def generate(self, cache: KVCache, ids_list: list[list[int]], counts: torch.Tensor,
                 active=None, ctx=None):
        """Greedy decode after the prompt chunk. Returns (out_ids [B, N],
        out_len [B], counts, last_tok [B]); ``counts`` and ``cache`` are
        updated in place. ``active`` [B] bool: the other rows are no-ops
        (their prompt is skipped, they write and penalise nothing), which is
        how multi-stream serving generates for the rows that fired. With
        ``spec_tokens`` > 1 this is ``generate_spec`` (same tokens, fewer
        passes); ``ctx`` = (ctx_ids [B, C], ctx_len [B]) is its draft
        context and is ignored by the sequential loop.

        Every produced token is written, an eos included; eos is never
        penalised; the final written token is never fed back through the
        decoder (it leads the next chunk instead), and a pass in which no
        row has a token to feed is skipped."""
        if self.spec_tokens > 1:
            return self.generate_spec(cache, ids_list, counts, ctx, active=active)
        eos = self.cfg.eos_token_id
        N = self.max_new_tokens
        pen = self.repetition_penalty
        ids, lens, act = self._prompt(ids_list, active)
        logits = self._append_padded(cache, ids, lens)
        B = logits.shape[0]
        rows = torch.arange(B, device=self.device)
        tok = torch.argmax(_apply_repetition_penalty(logits, counts, pen), dim=-1)
        out_ids = torch.zeros((B, N), dtype=torch.int32, device=self.device)
        out_len = torch.zeros((B,), dtype=torch.int32, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device) if act is None else ~act
        for i in range(N):
            write = ~done
            out_ids[:, i] = torch.where(write, tok, torch.zeros_like(tok)).to(torch.int32)
            out_len += write.to(torch.int32)
            is_eos = tok == eos
            counts[rows, tok] += (write & ~is_eos).to(torch.int32)
            done = done | is_eos
            step = ~done & (i + 1 < N)
            if not bool(step.any()):
                break
            embeds = self._embed(tok)[:, None, :]
            hidden = self._decode(cache, embeds, step.to(torch.int32))
            logits = self._logits(hidden[:, 0])
            tok = torch.argmax(_apply_repetition_penalty(logits, counts, pen), dim=-1)
        last_tok = out_ids[rows, torch.clamp(out_len.long() - 1, min=0)]
        return out_ids, out_len, counts, last_tok

    def generate_spec(self, cache: KVCache, ids_list: list[list[int]], counts: torch.Tensor,
                      ctx=None, active=None):
        """Speculative greedy decode: the tokens of ``generate`` (the strictly
        sequential loop), but each weight stream verifies S candidates: the
        carried token plus S-1 n-gram-lookup drafts
        (``spec_decode.ngram_draft``) through the read-only verify pass,
        committing only the prefix that matches sequential greedy argmax.
        Rows accept drafts and finish at their own pace; an inactive row
        (``active`` [B] bool) is done from the start.

        Position p's hidden state equals the p-th sequential 1-token pass
        for every cache policy and fill state; acceptance replays the
        sequential loop's bookkeeping per position, in its order: write, eos,
        budget, repetition-penalty counts, then the next argmax. A rejected
        draft costs nothing but the pass and a perfect drafter changes no
        output.

        ``ctx`` = (ctx_ids [B, C] int, ctx_len [B]): each row's recent
        conversation text prepended to its lookup history; a draft source
        only, never fed to the model. The width is ``spec_tokens``, or
        ``spec_max`` while the acceptance EMA (kept across calls, one for
        the whole batch) is above ``SPEC_EMA_HI``. One host read per pass
        (rows still decoding, tokens committed), plus the composed verify
        pass's gate on an int8 cache.
        MUTATES ``cache`` and ``counts``. Returns what ``generate`` returns;
        ``self.last_spec_info`` = (passes, committed tokens, EMA) of this
        call."""
        eos = self.cfg.eos_token_id
        N = self.max_new_tokens
        pen = self.repetition_penalty
        dev = self.device
        ids, lens, act = self._prompt(ids_list, active)
        B, P = ids.shape
        ctx_ids, ctx_len = ctx if ctx is not None else (None, None)
        if ctx_ids is not None:
            ctx_ids = torch.as_tensor(ctx_ids, device=dev)
            ctx_len = torch.as_tensor(ctx_len, device=dev)
        M = (0 if ctx_ids is None else ctx_ids.shape[1]) + P + N + 1
        logits = self._append_padded(cache, ids, lens)
        tok = torch.argmax(_apply_repetition_penalty(logits, counts, pen), dim=-1).to(torch.int32)

        bidx = torch.arange(B, device=dev)
        # one spare column each takes the writes of rows that do not write
        out_buf = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
        out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev) if act is None else ~act
        hist, hist_len = spec_decode.build_draft_hist(ctx_ids, ctx_len, ids, lens, N + 1)
        hist = torch.cat([hist, hist.new_full((B, 1), -1)], dim=1)
        # the EMA in f32, as the JAX engine carries it
        ema, passes, committed_total = np.float32(self._spec_ema), 0, 0

        rows = ~done & (out_len < N)
        # no row is done before the first pass unless it is inactive
        more = N > 0 and (act is None or bool(act.any()))
        while more:
            S = self.spec_max if ema > SPEC_EMA_HI else self.spec_tokens
            out_len0 = out_len
            drafts = spec_decode.ngram_draft(hist[:, :M], hist_len, tok, S - 1)
            chunk = torch.cat([tok[:, None], drafts], dim=1)                   # [B, S]
            plan_valid = torch.where(rows, S, 0).to(torch.int32)
            plans = spec_decode.plan_compose(cache, self.policy, plan_valid, S)
            embeds = self._embed(chunk)
            # every position's bits are its sequential pass's (``_verify``)
            hidden, infl_k, infl_v = self._verify(cache, embeds, plans)
            logits = self._logits(hidden)                                      # [B, S, V]

            reach = rows                      # position p reached and writable
            m_cache = torch.zeros((B,), dtype=torch.int32, device=dev)
            carry = tok
            for p in range(S):
                tok_p = chunk[:, p]
                write = reach
                out_buf[bidx, torch.where(write, out_len, N).long()] = tok_p
                hist[bidx, torch.where(write, hist_len, M).long()] = tok_p
                out_len = out_len + write.to(torch.int32)
                hist_len = hist_len + write.to(torch.int32)
                is_eos = tok_p == eos
                counts[bidx, tok_p.long()] += (write & ~is_eos).to(torch.int32)
                done = done | (write & is_eos)
                # the decoder step for tok_p ran speculatively; it COUNTS iff
                # the sequential loop would have run it
                processed = write & ~is_eos & (out_len < N)
                m_cache = m_cache + processed.to(torch.int32)
                t_next = torch.argmax(_apply_repetition_penalty(logits[:, p], counts, pen),
                                      dim=-1).to(torch.int32)
                carry = torch.where(processed, t_next, carry)
                if p + 1 < S:
                    # draft p+1 is accepted iff it IS the sequential token
                    reach = processed & (chunk[:, p + 1] == t_next)

            spec_decode.commit_slots(cache, plans, infl_k, infl_v, m_cache, self.policy.junk)
            spec_decode.select_meta(cache, plans, m_cache)
            tok = carry
            # normalise by ACHIEVABLE tokens: a row whose budget ends
            # mid-chunk cannot commit the full width, and that is no rejection
            achievable = torch.where(rows, torch.clamp(N - out_len0, max=S), 0).sum()
            rows = ~done & (out_len < N)
            committed, achievable, more = (int(v) for v in torch.stack(
                [(out_len - out_len0).sum(), achievable, rows.any().to(torch.int32)]).tolist())
            frac = np.float32(committed) / np.float32(max(achievable, 1))
            ema = np.float32(1.0 - SPEC_EMA_ALPHA) * ema + np.float32(SPEC_EMA_ALPHA) * frac
            passes += 1
            committed_total += committed

        self._spec_ema = ema
        self.last_spec_info = (passes, committed_total, float(ema))
        self.spec_totals[0] += passes
        self.spec_totals[1] += committed_total
        out_ids = out_buf[:, :N]
        last_tok = out_ids[bidx, torch.clamp(out_len.long() - 1, min=0)]
        return out_ids, out_len, counts, last_tok

    def spec_acceptance(self) -> dict:
        """Run-level speculation counters: verify passes, committed tokens,
        tokens per pass, and the current acceptance EMA."""
        passes, committed = self.spec_totals
        return {"passes": passes, "committed": committed,
                "tokens_per_pass": round(committed / max(passes, 1), 3),
                "ema": round(float(self._spec_ema), 4)}

    def reset_spec_totals(self):
        self.spec_totals = [0, 0]
