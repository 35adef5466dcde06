"""Trigger loops of the single-stream engine: score frames until a stopping
rule fires, one frame a decoder pass or ``fused_frames`` frames a weight
stream.

Counterpart of ``aha_tpu/streaming/engine_trigger.py`` (``make_trigger``)
and of the z rule of ``aha_tpu/streaming/engine_core.py`` (``z_step``,
``z_step_host``). JAX runs each loop on the device inside
``lax.while_loop``; here each is a Python loop over decoder passes, and every
pass ends with ONE host read of a small packed tensor (frames accepted,
fired, running sum): the host needs it to know where the next pass starts.
The scores stay on the device until the call returns.

A pass's decision is the sequential loop's, frame by frame and in f32:
running sum, sum and prob hits, z push and hit, sum reset, then the row
stops at its first trigger. A fused pass is the engine's read-only verify
pass; only the frames up to and including the first trigger are committed,
so scores, cache, running sum and trigger point are the per-frame loop's.

The engine's cache is batch 1, so every loop takes batch 1; the arguments
keep JAX's [B] shapes (``start``, ``limit``, thresholds, z state).
"""

from __future__ import annotations

import numpy as np
import torch


def z_step(z_hist: torch.Tensor, z_cnt: torch.Tensor, score: torch.Tensor,
           active: torch.Tensor, z_thr: torch.Tensor, first_n: int):
    """Push ``score`` [B] into the running window of the active rows and
    evaluate the z rule (the session's ``_z_trigger``): fire when the score
    is more than ``z_thr`` standard deviations above the window's mean, once
    max(first_n, 2) frames have been pushed and the window holds >= 2. The
    window ``z_hist`` [B, L] holds the last min(z_cnt, L) scores, newest in
    the last column; f32 mean and variance over them, std floored at 1e-6.
    ``z_thr`` = inf disables firing, never the push. Returns (z_hist, z_cnt,
    fire)."""
    L = z_hist.shape[1]
    pushed = torch.cat([z_hist[:, 1:], score[:, None]], dim=1)
    z_hist = torch.where(active[:, None], pushed, z_hist)
    z_cnt = z_cnt + active.to(torch.int32)
    n = torch.clamp(z_cnt, max=L)
    m = torch.arange(L, device=z_hist.device)[None, :] >= (L - n[:, None])
    nf = torch.clamp(n, min=1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=z_hist.device)
    mean = torch.where(m, z_hist, zero).sum(dim=1) / nf
    var = torch.where(m, (z_hist - mean[:, None]) ** 2, zero).sum(dim=1) / nf
    z = (score - mean) / torch.clamp(torch.sqrt(var), min=1e-6)
    fire = active & (z_cnt >= max(int(first_n), 2)) & (n >= 2) & (z > z_thr)
    return z_hist, z_cnt, fire


def z_step_host(zh: np.ndarray, zc: np.ndarray, b: int, score, z_thr, first_n) -> bool:
    """Numpy mirror of ``z_step`` for a host-checked frame (the chunked
    session's prefix frames): push ``score`` into row ``b``'s window IN PLACE
    and return whether the z rule fires. The push is unconditional; callers
    AND the result with their own eligibility gate."""
    se32 = np.float32(score)
    zh[b, :-1] = zh[b, 1:]
    zh[b, -1] = se32
    zc[b] += 1
    L = zh.shape[1]
    n = min(int(zc[b]), L)
    w = zh[b, L - n:]
    nf = np.float32(max(n, 1))
    mean = np.float32(w.sum(dtype=np.float32) / nf)
    var = np.float32(((w - mean) ** 2).sum(dtype=np.float32) / nf)
    z = (se32 - mean) / max(np.float32(np.sqrt(var)), np.float32(1e-6))
    return int(zc[b]) >= max(int(first_n), 2) and n >= 2 and float(z) > float(z_thr)


class TriggerLoops:
    """The trigger loops of :class:`~aha_tpu_torch.streaming.engine.StreamEngine`
    (a mixin: it reads the engine's ``device``, ``fused_frames`` and its
    ``append_frames`` / ``verify_frames`` / ``commit_frames``)."""

    def new_z_state(self, window: int = 20):
        """(z_hist [1, window] f32, z_cnt [1] int32) for the z rule: pass it
        through ``score_until_trigger_multi`` calls."""
        return (torch.zeros((1, window), dtype=torch.float32, device=self.device),
                torch.zeros((1,), dtype=torch.int32, device=self.device))

    def _row_value(self, x, dtype, fill) -> torch.Tensor:
        """A scalar or [B]-like (B = 1) on the device as a [1] tensor; None
        becomes ``fill``."""
        t = torch.as_tensor(fill if x is None else x, dtype=dtype, device=self.device)
        if t.numel() != 1:
            raise ValueError(f"trigger loops take batch 1, got a value of {t.numel()} rows "
                             "(multi-stream serving: ROADMAP.md, Queue 1 item 10)")
        return t.reshape(1)

    def _rule(self, prob_threshold, sum_threshold, score_heads):
        """(prob threshold [1], sum threshold [1], head mask [2]) in f32;
        a threshold of None never fires."""
        inf = float("inf")
        head_mask = torch.tensor([1.0 if "informative_score" in score_heads else 0.0,
                                  1.0 if "relevance_score" in score_heads else 0.0],
                                 dtype=torch.float32, device=self.device)
        return (self._row_value(prob_threshold, torch.float32, inf),
                self._row_value(sum_threshold, torch.float32, inf), head_mask)

    def _sweep(self, s, i: int, n_valid: int, run, rule, resume_at: int, z):
        """The decision over a pass's scores s [1, k, 3] (f32) at stream
        positions i .. i + n_valid - 1, frame by frame in the sequential
        loop's order; a row stops at its first trigger. ``z`` = (z_hist,
        z_cnt, z_thr, first_n) or None. Returns (A [1] frames accepted, up to
        and including the first trigger; fire [1]; running sum [1]; z)."""
        prob_thr, sum_thr, hm = rule
        se = s[..., 0] * hm[0] + s[..., 1] * hm[1]                       # [1, k]
        fire = torch.zeros((1,), dtype=torch.bool, device=self.device)
        A = torch.zeros((1,), dtype=torch.int32, device=self.device)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        for p in range(n_valid):
            alive = ~fire
            run = run + torch.where(alive, se[:, p], zero)
            # response_min_interval_frames: a suppressed frame fires nothing
            # and does not reset the running sum
            ok = alive if i + p >= resume_at else torch.zeros_like(alive)
            hit = ok & (se[:, p] > prob_thr)
            sum_hit = ok & (run > sum_thr)
            if z is not None:
                zh, zc, z_thr, first_n = z
                zh, zc, z_hit = z_step(zh, zc, se[:, p], alive, z_thr, first_n)
                z = (zh, zc, z_thr, first_n)
                hit = hit | (z_hit & ok)
            run = torch.where(sum_hit, zero, run)
            A = A + alive.to(torch.int32)
            fire = fire | hit | sum_hit
        return A, fire, run, z

    def _trigger_loop(self, cache, frames: torch.Tensor, start: int, limit: int, run,
                      rule, resume_at: int, z):
        """Score frames[start:limit] ([T, F, H]) until the rule fires: one
        ``append_frames`` a frame, or at ``fused_frames`` = k > 1 one verify
        pass over k frames (the tail padded with inactive frames) that
        commits only the accepted ones. Returns (scores [T, 3] f32 on the
        device, zero where not scored; next index; running sum; fired; z).
        MUTATES ``cache``."""
        T, F, H = frames.shape
        k = self.fused_frames
        dev = self.device
        scores = torch.zeros((T + k, 3), dtype=torch.float32, device=dev)
        j = torch.arange(k, device=dev)
        i, fired, run_host = start, False, None
        while i < limit and not fired:
            n_valid = min(k, limit - i)
            if k == 1:
                s = self.append_frames(cache, frames[i:i + 1]).float()[:, None]   # [1, 1, 3]
            else:
                chunk = frames[i:i + n_valid]
                if n_valid < k:
                    chunk = torch.cat([chunk, chunk.new_zeros((k - n_valid, F, H))])
                s, pending = self.verify_frames(
                    cache, chunk[None],
                    torch.full((1,), n_valid, dtype=torch.int32, device=dev))
                s = s.float()
            A, fire, run, z = self._sweep(s, i, n_valid, run, rule, resume_at, z)
            if k > 1:
                self.commit_frames(cache, pending, A)
            scores[i:i + k] = torch.where((j < A)[:, None], s[0], 0.0)
            a, f, run_host = torch.cat([A.to(torch.float32), fire.to(torch.float32),
                                        run]).tolist()
            i, fired = i + int(a), bool(f)
        if run_host is None:                  # no pass ran
            run_host = float(run[0])
        return scores[:T], i, run_host, fired, z

    def score_until_trigger(self, cache, frames: torch.Tensor, n_frames: int,
                            score_sum: float, prob_threshold: float | None,
                            sum_threshold: float | None, score_heads: tuple[str, ...],
                            resume_at: int = 0):
        """frames [T, F, H] (batch 1): score frames[0:n_frames] until the
        prob rule (stream-end score > ``prob_threshold``) or the sum rule
        (running sum > ``sum_threshold``, which then resets to 0) fires; a
        threshold of None never fires. The stream-end score is the sum of
        the ``score_heads`` among informative and relevance. ``resume_at``:
        the first frame (index into ``frames``) that may fire
        (response_min_interval_frames). One frame a pass, or at
        ``fused_frames`` > 1 JAX's ``score_until_trigger_fused``: each pass
        verifies that many frames in one weight stream and commits those up
        to and including the first trigger. Returns (scores [T, 3] f32 on the device, frames scored, running
        sum, fired). MUTATES ``cache``."""
        scores, n, run, fired, _ = self._trigger_loop(
            cache, frames, 0, int(n_frames), self._row_value(score_sum, torch.float32, 0.0),
            self._rule(prob_threshold, sum_threshold, score_heads), max(int(resume_at), 0),
            None)
        return scores, n, run, fired

    def score_until_trigger_multi(self, cache, frames: torch.Tensor, start, limit, score_sum,
                                  prob_threshold, sum_threshold, score_heads: tuple[str, ...],
                                  z_threshold=None, z_state=None, first_n_frames: int = 0,
                                  resume_at=None):
        """The row trigger loop of multi-stream serving, here at B = 1 (the
        session's z-rule runs): frames [B, T, F, H]; start / limit /
        score_sum / resume_at [B]; thresholds scalars or [B]; the row scores
        frames start .. limit - 1 against the prob, sum and z rules
        (``z_threshold`` with the window ``z_state`` from ``new_z_state``,
        firing after ``first_n_frames``) and stops at its first trigger.
        ``resume_at`` is an index into the stream's T frames. Returns
        (scores [B, T, 3] f32 on the device, next index [B], running sum
        [B], fired [B], z_hist, z_cnt); the [B] values as numpy arrays.
        MUTATES ``cache``."""
        if frames.shape[0] != 1:
            raise ValueError(f"trigger loops take batch 1, got {frames.shape[0]} rows "
                             "(multi-stream serving: ROADMAP.md, Queue 1 item 10)")
        z_hist, z_cnt = z_state if z_state is not None else self.new_z_state()
        z = (torch.as_tensor(z_hist, dtype=torch.float32, device=self.device),
             torch.as_tensor(z_cnt, dtype=torch.int32, device=self.device),
             self._row_value(z_threshold, torch.float32, float("inf")), int(first_n_frames))
        resume = 0 if resume_at is None else int(np.asarray(resume_at).reshape(-1)[0])
        scores, i, run, fired, z = self._trigger_loop(
            cache, frames[0], int(np.asarray(start).reshape(-1)[0]),
            int(np.asarray(limit).reshape(-1)[0]),
            self._row_value(score_sum, torch.float32, 0.0),
            self._rule(prob_threshold, sum_threshold, score_heads), resume, z)
        return (scores[None], np.asarray([i], np.int32),
                np.asarray([run], np.float32), np.asarray([fired]), z[0], z[1])
