"""The serving iteration of multi-stream serving: a fused [role prefix + frame]
step with its trigger rule, then either the mixed scoring + generation loop
or, where generation runs on the host, the batched trigger loop.

Counterpart of ``aha_tpu/streaming/engine_serve.py`` (``_mixed_loop``,
``serve_step``) and of its host wrapper ``StreamEngine.serve_step``
(``aha_tpu/streaming/engine.py:471-523``). JAX traces the loop into one
``lax.while_loop``; here it is a Python loop over decoder passes whose per-row
state machine lives on the device, as JAX's does, and every pass ends with ONE
host read of a small packed tensor (each row's mode, frame cursor, tokens
written, its flags and running sum): the host needs the modes to pick the
next pass and to know when to return.

Rows are independent streams, so the mixed loop is a schedule, not another
function: a row that fires decodes its response inline, pass by pass, while
the other rows keep scoring frames in the same passes, and every row's
tokens, scores and cache writes are those of a solo session. A pass is as
wide as its widest row needs (a frame, the generation prompt, or one token);
the rows that score nothing append nothing. JAX's ``AHA_SERVE_OVERLAP=0``
(freeze, then generate) is not ported: the overlapped loop is the only path.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import aha
from ..ops import spec_decode

# per-row modes of the mixed loop
SCORING, PROMPT, DECODING, WAITING = 0, 1, 2, 3


class ServeLoop:
    """``serve_step`` of :class:`~aha_tpu_torch.streaming.engine.StreamEngine`
    (a mixin over the engine's chunk appends, trigger loops and generation
    settings)."""

    def serve_step(self, cache, prefix_rows: list[list[int]], can_step, frames: torch.Tensor,
                   start, limit, score_sum, counts: torch.Tensor, prob_threshold,
                   sum_threshold, score_heads: tuple[str, ...], gen_prompt: list[int], *,
                   do_generate: bool = True, z_threshold=None, z_state=None,
                   first_n_frames: int = 0, resume_at=None, ctx=None, retire_defer: int = 1):
        """One serving iteration over the B rows of ``cache``.

        1. Each row in ``can_step`` ([B] bool) takes its next frame,
           frames[b, start_b] ([B, T, F, H]), in one chunk behind its
           role-transition prefix ``prefix_rows[b]`` ([] for a plain frame),
           with its trigger rule applied.
        2. ``do_generate``: the mixed loop (``_mixed_loop``): rows score on
           until their own rule fires, then decode ``gen_prompt``'s response
           inline while the others keep scoring. Else the batched trigger
           loop alone, and the caller generates (the ``remove_assistant_turns``
           rollback keeps the cache from before generation).

        Thresholds are scalars or [B] (inf: off for that row); ``start`` /
        ``limit`` / ``resume_at`` / ``score_sum`` are [B]; ``ctx`` =
        (ctx_ids [B, C], ctx_len [B]) is each row's speculative draft
        context. Returns (scores [B, T, 3] f32 on the device, next frame [B],
        running sum [B] f32, triggered [B], out_ids [B, N], out_len [B],
        counts, last_tok [B], z_hist, z_cnt): the [B] cursors, sums and flags
        as numpy arrays, the tokens on the device. MUTATES ``cache`` and
        ``counts``."""
        B, T = frames.shape[:2]
        dev = self.device
        can = self._host_rows(can_step, B).astype(bool)
        start = self._host_rows(start, B)
        limit = self._host_rows(limit, B)
        resume = self._host_rows(resume_at, B)
        rule = self._rule(prob_threshold, sum_threshold, score_heads, B)
        z = self._z(z_threshold, z_state, first_n_frames, B)
        run = self._row_value(score_sum, torch.float32, 0.0, B)

        # 1. the fused [prefix + frame] step and its rule
        idx = np.clip(start, 0, T - 1)
        fe = frames[torch.arange(B, device=dev), torch.as_tensor(idx, device=dev)]
        s0 = self.append_text_frames(cache, prefix_rows, fe, active=can).float()
        hm = rule[2]
        masks = torch.as_tensor(np.stack([can, can & (start >= resume)]), device=dev)
        fire, run, z = self._rule_frame(s0[:, 0] * hm[0] + s0[:, 1] * hm[1], masks[0],
                                        masks[1], run, rule, z)
        k = self.fused_frames
        scores = torch.zeros((B, T + k + 1, 3), dtype=torch.float32, device=dev)
        scores[torch.arange(B, device=dev), torch.as_tensor(
            np.where(can, idx, T + k), device=dev)] = s0
        i1 = start + can
        fired = np.asarray(fire.tolist(), bool)
        gen_ids, gen_len = self.pad_ids([list(gen_prompt)] * B)
        if do_generate:
            return self._mixed_loop(cache, frames, i1, limit, run, fired, scores, rule, resume,
                                    z, gen_ids, gen_len, counts, ctx, max(int(retire_defer), 1))
        scores, i2, _, run_host, fired, z = self._trigger_loop(
            cache, frames, i1, limit, run, fired, scores, rule, resume, z)
        N = self.max_new_tokens
        none = torch.zeros((B,), dtype=torch.int32, device=dev)
        return (scores[:, :T], i2, run_host, fired,
                torch.zeros((B, N), dtype=torch.int32, device=dev), none, counts, none,
                z[0], z[1])

    def _mixed_loop(self, cache, frames, i, limit, run, triggered, scores, rule, resume, z,
                    gen_ids, gen_len, counts, ctx, retire_defer: int):
        """Scoring and greedy generation in one loop of passes (JAX's
        ``_mixed_loop``). Per-row modes: SCORING frames, PROMPT (the next
        pass appends the generation prompt), DECODING, WAITING for the loop
        to return. It returns once no response is in flight and some row
        needs the host: a finished response, or ``retire_defer`` rows that
        reached their frame limit; while a response is in flight the other
        rows keep scoring through it.

        Passes: with a row prompting or decoding, one chunk as wide as its
        widest row (a frame, the prompt, or the token a decoding row feeds),
        or, once every live row decodes and ``spec_tokens`` > 1, the
        speculative tail (the carried token and n-gram drafts verified in
        one weight stream, the sequential passes' attention replayed on a
        bf16 / f32 cache, at ``spec_max`` while the acceptance EMA is high);
        with none, a scoring pass (``fused_frames`` frames a row). Each
        replays ``generate``'s write / eos / budget / penalty order, and the
        final token of a response is never fed back. Returns what
        ``serve_step`` returns."""
        from . import engine as eng_mod     # the penalty and the EMA's constants

        dev = self.device
        B, T, F = frames.shape[:3]
        N = self.max_new_tokens
        S = self.spec_tokens
        eos = self.cfg.eos_token_id
        pen = self.repetition_penalty
        Pg = gen_ids.shape[1]
        bidx = torch.arange(B, device=dev)
        gen_emb = self._embed(gen_ids)               # [B, Pg, H]
        junk = scores.shape[1] - 1

        mode_h = np.where(triggered, PROMPT, np.where(i < limit, SCORING, WAITING))
        i_h = i.copy()
        resp_h = np.zeros(B, bool)
        wait_h = np.zeros(B, bool)
        up = lambda a, dt=torch.int32: torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        mode, i_d, lim_d, res_d = up(mode_h), up(i_h), up(limit), up(resume)
        trig = up(triggered, torch.bool)
        resp_done = torch.zeros((B,), dtype=torch.bool, device=dev)
        new_wait = torch.zeros((B,), dtype=torch.bool, device=dev)
        tok = torch.zeros((B,), dtype=torch.int32, device=dev)
        # a spare column takes the writes of rows that do not write
        out_ids = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
        out_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        if S > 1:
            # the drafts' history: [context] [generation prompt] [generated tokens]
            ctx_ids, ctx_len = (None, None) if ctx is None else (up(ctx[0]), up(ctx[1]))
            hist, hist_len = spec_decode.build_draft_hist(ctx_ids, ctx_len, gen_ids, gen_len,
                                                          N + 1)
            Mh = hist.shape[1]
            hist = torch.cat([hist, hist.new_full((B, 1), -1)], dim=1)
        ema, passes, committed_total = np.float32(self._spec_ema), 0, 0
        out_len_h = np.zeros(B, np.int64)

        def tail_write(t_new, write):
            """Write t_new where ``write``, in generate()'s order; returns stop."""
            nonlocal out_len, resp_done, mode, tok
            out_ids[bidx, torch.where(write, out_len, N).long()] = t_new
            if S > 1:
                nonlocal hist_len
                hist[bidx, torch.where(write, hist_len, Mh).long()] = t_new
                hist_len = hist_len + write.to(torch.int32)
            out_len = out_len + write.to(torch.int32)
            is_eos = t_new == eos
            counts[bidx, t_new.long()] += (write & ~is_eos).to(torch.int32)
            stop = write & (is_eos | (out_len >= N))
            resp_done = resp_done | stop
            mode = torch.where(stop, WAITING, mode)
            tok = torch.where(write, t_new, tok)
            return stop

        def next_token(logits):
            return torch.argmax(eng_mod._apply_repetition_penalty(logits, counts, pen),
                                dim=-1).to(torch.int32)

        def scored(fire):
            """After a scoring pass: a row that fired appends the prompt next,
            a scoring row at its frame limit waits (and asks for the host)."""
            nonlocal trig, mode, new_wait
            trig = trig | fire
            mode = torch.where(fire, PROMPT, mode)
            lim_hit = (mode == SCORING) & (i_d >= lim_d)
            new_wait = new_wait | lim_hit
            mode = torch.where(lim_hit, WAITING, mode)

        while True:
            live = mode_h != WAITING
            gen_live = (mode_h == PROMPT) | (mode_h == DECODING)
            need_host = resp_h.any() or int(wait_h.sum()) >= retire_defer
            if not live.any() or (need_host and not gen_live.any()):
                break
            achievable = None
            if gen_live.any() and S > 1 and not ((mode_h == SCORING) | (mode_h == PROMPT)).any():
                # the speculative tail: every live row decodes
                Sw = self.spec_max if ema > eng_mod.SPEC_EMA_HI else S
                decoding = mode == DECODING
                # the carry is already written: the lookup anchors one position back
                drafts = spec_decode.ngram_draft(hist[:, :Mh], torch.clamp(hist_len - 1, min=0),
                                                 tok, Sw - 1)
                chunk = torch.cat([tok[:, None], drafts], dim=1)
                plans = spec_decode.plan_compose(cache, self.policy,
                                                 torch.where(decoding, Sw, 0).to(torch.int32), Sw)
                hidden, infl_k, infl_v = self._verify(cache, self._embed(chunk), plans)
                logits = self._logits(hidden)                                 # [B, Sw, V]
                reach = decoding            # chunk[:, p] is fed as the sequential loop would
                m_cache = torch.zeros((B,), dtype=torch.int32, device=dev)
                for p in range(Sw):
                    m_cache = m_cache + reach.to(torch.int32)
                    t_next = next_token(logits[:, p])
                    write = reach
                    stop = tail_write(t_next, write)
                    if p + 1 < Sw:
                        reach = write & ~stop & (chunk[:, p + 1] == t_next)
                spec_decode.commit_slots(cache, plans, infl_k, infl_v, m_cache, self.policy.junk)
                spec_decode.select_meta(cache, plans, m_cache)
                # the EMA counts against the ACHIEVABLE tokens: a row whose budget
                # ends inside the pass cannot commit its whole width
                achievable = int(np.where(mode_h == DECODING,
                                          np.minimum(Sw, N - out_len_h), 0).sum())
                passes += 1
            elif gen_live.any() or self.fused_frames == 1:
                # one mixed chunk: a frame, the prompt or one token a row
                width = max(F if (mode_h == SCORING).any() else 0,
                            Pg if (mode_h == PROMPT).any() else 0,
                            1 if (mode_h == DECODING).any() else 0)
                emb = self._embed(tok[:, None])
                emb = torch.cat([emb, emb.new_zeros((B, width - 1, emb.shape[2]))], dim=1)
                m = mode[:, None, None]
                if (mode_h == PROMPT).any():
                    ge = gen_emb[:, :width]
                    if Pg < width:
                        ge = torch.cat([ge, ge.new_zeros((B, width - Pg, ge.shape[2]))], dim=1)
                    emb = torch.where(m == PROMPT, ge, emb)
                if (mode_h == SCORING).any():
                    fe = frames[bidx, torch.clamp(i_d, 0, T - 1)]                   # [B, F, H]
                    if F < width:
                        fe = torch.cat([fe, fe.new_zeros((B, width - F, fe.shape[2]))], dim=1)
                    emb = torch.where(m == SCORING, fe, emb)
                valid = torch.where(mode == SCORING, F, torch.where(
                    mode == PROMPT, gen_len, torch.where(mode == DECODING, 1, 0))).to(torch.int32)
                hidden = self._decode(cache, emb, valid)
                last_h = self._last_valid(hidden, valid)
                if (mode_h == SCORING).any():
                    scoring = mode == SCORING
                    s = aha.scores_from_hidden(self.params, last_h).float()
                    scores[bidx, torch.where(scoring, torch.clamp(i_d, 0, T - 1), junk).long()] = s
                    hm = rule[2]
                    fire, run, z = self._rule_frame(s[:, 0] * hm[0] + s[:, 1] * hm[1], scoring,
                                                    scoring & (i_d >= res_d), run, rule, z)
                    i_d = i_d + scoring.to(torch.int32)
                if gen_live.any():
                    # the lm head only when some row decodes
                    decoding = (mode == PROMPT) | (mode == DECODING)
                    t_new = torch.where(decoding, next_token(self._logits(last_h)), tok)
                    tail_write(t_new, decoding)
                    mode = torch.where(mode == PROMPT, DECODING, mode)
                if (mode_h == SCORING).any():
                    scored(fire)
            else:
                # a scoring pass: fused_frames frames a row, no row generating
                s, A, fire, run, z = self._score_pass(cache, frames, i_h, mode_h == SCORING,
                                                      limit, run, rule, resume, z)
                jk = torch.arange(self.fused_frames, device=dev)[None, :]
                scores[bidx[:, None], torch.where(jk < A[:, None], i_d[:, None] + jk,
                                                  junk).long()] = s
                i_d = i_d + A
                scored(fire)
            packed = torch.stack([mode.float(), i_d.float(), out_len.float(),
                                  resp_done.float(), new_wait.float()]).tolist()
            mode_h = np.asarray(packed[0], np.int64)
            i_h = np.asarray(packed[1], np.int64)
            new_len = np.asarray(packed[2], np.int64)
            resp_h = np.asarray(packed[3], bool)
            wait_h = np.asarray(packed[4], bool)
            if achievable is not None:
                committed = int(new_len.sum() - out_len_h.sum())
                frac = np.float32(committed) / np.float32(max(achievable, 1))
                ema = (np.float32(1.0 - eng_mod.SPEC_EMA_ALPHA) * ema
                       + np.float32(eng_mod.SPEC_EMA_ALPHA) * frac)
                committed_total += committed
            out_len_h = new_len
        self._spec_ema = ema
        self.last_spec_info = (passes, committed_total, float(ema))
        self.spec_totals[0] += passes
        self.spec_totals[1] += committed_total
        last_tok = out_ids[bidx, torch.clamp(out_len.long() - 1, min=0)]
        tail = torch.stack([trig.float(), run]).tolist()
        return (scores[:, :T], i_h, np.asarray(tail[1], np.float32),
                np.asarray(tail[0], bool), out_ids[:, :N], out_len, counts, last_tok,
                None if z is None else z[0], None if z is None else z[1])

