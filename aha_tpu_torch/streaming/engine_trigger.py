"""Trigger loops of the engine: score frames until a stopping rule fires,
one frame a decoder pass or ``fused_frames`` frames a weight stream, for one
row or for B rows that each stop at their own trigger.

Counterpart of ``aha_tpu/streaming/engine_trigger.py`` (``make_trigger``)
and of the z rule and the fused pass of ``aha_tpu/streaming/engine_core.py``
(``z_step``, ``z_step_host``, ``_fused_frames_pass``). JAX runs each loop on
the device inside ``lax.while_loop``; here each is a Python loop over decoder
passes, and every pass ends with ONE host read of a small packed tensor
(frames accepted, fired, running sum per row): the host needs it to know
where the next pass starts. The scores stay on the device until the call
returns.

A pass's decision is the sequential loop's, frame by frame and in f32:
running sum, sum and prob hits, z push and hit, sum reset, then the row
stops at its first trigger while the other rows go on. A fused pass is the
engine's read-only verify pass; only each row's frames up to and including
its first trigger are committed, so scores, cache, running sums and trigger
points are the per-frame loop's. Thresholds are scalars or [B] (inf: the
rule is off for that row), and so are the z state, ``start``, ``limit`` and
``resume_at``.
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
    (a mixin: it reads the engine's ``device``, ``batch``, ``fused_frames``
    and its ``append_frames`` / ``verify_frames`` / ``commit_frames``)."""

    def new_z_state(self, window: int = 20):
        """(z_hist [B, window] f32, z_cnt [B] int32) for the z rule, B the
        engine's batch: pass it through ``score_until_trigger_multi`` and
        ``serve_step`` calls; multi-stream serving resets a row on admission."""
        return (torch.zeros((self.batch, window), dtype=torch.float32, device=self.device),
                torch.zeros((self.batch,), dtype=torch.int32, device=self.device))

    def _row_value(self, x, dtype, fill, B: int) -> torch.Tensor:
        """A scalar or [B]-like on the device as a [B] tensor; None becomes
        ``fill``."""
        t = torch.as_tensor(fill if x is None else x, dtype=dtype, device=self.device)
        if t.numel() not in (1, B):
            raise ValueError(f"a per-row value of {t.numel()} rows for a batch of {B}")
        return t.reshape(-1).expand(B).clone() if t.numel() == 1 else t.reshape(B)

    @staticmethod
    def _host_rows(x, B: int, fill: int = 0) -> np.ndarray:
        """A scalar or [B]-like as a host int64 [B] array; None becomes ``fill``."""
        a = np.asarray(fill if x is None else x, np.int64).reshape(-1)
        return np.broadcast_to(a, (B,)).copy() if a.size == 1 else a.reshape(B).copy()

    def _rule(self, prob_threshold, sum_threshold, score_heads, B: int):
        """(prob threshold [B], sum threshold [B], head mask [2]) in f32; a
        threshold of None (or inf) never fires."""
        inf = float("inf")
        head_mask = torch.tensor([1.0 if "informative_score" in score_heads else 0.0,
                                  1.0 if "relevance_score" in score_heads else 0.0],
                                 dtype=torch.float32, device=self.device)
        return (self._row_value(prob_threshold, torch.float32, inf, B),
                self._row_value(sum_threshold, torch.float32, inf, B), head_mask)

    def _z(self, z_threshold, z_state, first_n: int, B: int):
        """(z_hist, z_cnt, z_thr [B], first_n) on the device; a window of 20
        where ``z_state`` is None."""
        if z_state is None:
            z_state = (torch.zeros((B, 20), dtype=torch.float32, device=self.device),
                       torch.zeros((B,), dtype=torch.int32, device=self.device))
        return (torch.as_tensor(z_state[0], dtype=torch.float32, device=self.device),
                torch.as_tensor(z_state[1], dtype=torch.int32, device=self.device),
                self._row_value(z_threshold, torch.float32, float("inf"), B), int(first_n))

    def _rule_frame(self, se, alive, ok, run, rule, z):
        """One frame of the stopping rule over B rows, in f32 and in the
        sequential loop's order: running sum over the ``alive`` rows, sum
        and prob hits on the ``ok`` rows (a suppressed frame fires nothing
        and does not reset the sum), z push (alive rows) and hit, sum reset.
        Returns (fire [B], run [B], z)."""
        prob_thr, sum_thr, _ = rule
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        run = run + torch.where(alive, se, zero)
        sum_hit = ok & (run > sum_thr)
        hit = ok & (se > prob_thr)
        if z is not None:
            zh, zc, z_thr, first_n = z
            zh, zc, z_hit = z_step(zh, zc, se, alive, z_thr, first_n)
            z = (zh, zc, z_thr, first_n)
            hit = hit | (z_hit & ok)
        run = torch.where(sum_hit, zero, run)
        return hit | sum_hit, run, z

    def _sweep(self, s, valid, elig, run, rule, z):
        """The decision over a pass's scores s [B, k, 3] (f32), frame by
        frame in the sequential loop's order; a row stops at its first
        trigger. ``valid`` / ``elig`` [B, k] bool: the frames the pass scores
        for real, and those of them that may fire (response_min_interval_frames).
        Returns (A [B] frames accepted, up to and including the first
        trigger; fire [B]; running sum [B]; z)."""
        hm = rule[2]
        se = s[..., 0] * hm[0] + s[..., 1] * hm[1]                       # [B, k]
        B, k = se.shape
        fire = torch.zeros((B,), dtype=torch.bool, device=self.device)
        A = torch.zeros((B,), dtype=torch.int32, device=self.device)
        for p in range(k):
            alive = valid[:, p] & ~fire
            f, run, z = self._rule_frame(se[:, p], alive, elig[:, p] & alive, run, rule, z)
            A = A + alive.to(torch.int32)
            fire = fire | f
        return A, fire, run, z

    def _pass_rows(self, i, act, limit, resume_at, k: int):
        """Host masks of one pass at cursors ``i``: (valid [B, k], elig
        [B, k]) on the device, and the frames each row scores."""
        n_valid = np.where(act, np.clip(limit - i, 0, k), 0)
        p = np.arange(k)[None, :]
        valid = p < n_valid[:, None]
        elig = valid & (i[:, None] + p >= resume_at[:, None])
        both = torch.as_tensor(np.stack([valid, elig]), device=self.device)
        return both[0], both[1], n_valid

    def _gather(self, frames, i, k: int):
        """frames [B, T, F, H] at each row's frames i .. i + k - 1 (clamped
        into the stream) -> [B, k, F, H]."""
        B, T = frames.shape[:2]
        if B == 1:
            c = frames[0, int(min(i[0], T - 1)):int(min(i[0], T - 1)) + k]
            return (c if c.shape[0] == k else
                    torch.cat([c, c.new_zeros((k - c.shape[0], *c.shape[1:]))]))[None]
        idx = torch.as_tensor(np.clip(i[:, None] + np.arange(k)[None, :], 0, T - 1),
                              device=self.device)
        return frames[torch.arange(B, device=self.device)[:, None], idx]

    def _score_pass(self, cache, frames, i, act, limit, run, rule, resume_at, z):
        """One scoring pass over the rows ``act`` (host [B] bool) at cursors
        ``i``: one ``append_frames`` at ``fused_frames`` = 1, else a verify
        pass over k frames a row (a row's tail padded with inactive frames)
        that commits only the frames each row accepts. Returns (s [B, k, 3]
        f32, A [B], fire [B], run [B], z) on the device. MUTATES ``cache``."""
        k = self.fused_frames
        valid, elig, n_valid = self._pass_rows(i, act, limit, resume_at, k)
        chunk = self._gather(frames, i, k)
        if k == 1:
            s = self.append_frames(cache, chunk[:, 0], valid[:, 0]).float()[:, None]
        else:
            s, pending = self.verify_frames(
                cache, chunk, torch.as_tensor(n_valid.astype(np.int32), device=self.device))
            s = s.float()
        A, fire, run, z = self._sweep(s, valid, elig, run, rule, z)
        if k > 1:
            self.commit_frames(cache, pending, A)
        return s, A, fire, run, z

    def _trigger_loop(self, cache, frames: torch.Tensor, start, limit, run, triggered0,
                      scores, rule, resume_at, z):
        """Rows score frames[b, start_b:limit_b] ([B, T, F, H]) until their
        own rule fires (``_score_pass``), rows in ``triggered0`` frozen from
        the start. As JAX's loop does, it returns as soon as the active set
        shrinks (a row fires or reaches its limit): each stop needs the host.
        ``scores`` [B, T + k + 1, 3] f32 on the device takes the accepted
        frames' scores (its last column the others'). Returns (scores, next
        index [B], running sum [B] on the device, running sum [B] f32 host,
        fired [B] host, z). MUTATES ``cache``."""
        B = frames.shape[0]
        k = self.fused_frames
        dev = self.device
        i = start.copy()
        fired = np.asarray(triggered0, bool).copy()
        entry = (i < limit) & ~fired
        j = np.arange(k)[None, :]
        bidx = torch.arange(B, device=dev)[:, None]
        run_host = None
        act = entry
        while act.any() and not (entry & ~act).any():
            s, A, fire, run, z = self._score_pass(cache, frames, i, act, limit, run, rule,
                                                  resume_at, z)
            packed = torch.stack([A.to(torch.float32), fire.to(torch.float32), run]).tolist()
            a = np.asarray(packed[0], np.int64)
            pos = np.where(j < a[:, None], i[:, None] + j, scores.shape[1] - 1)
            scores[bidx, torch.as_tensor(pos, device=dev)] = s
            i = i + a
            fired = fired | np.asarray(packed[1], bool)
            run_host = np.asarray(packed[2], np.float32)
            act = (i < limit) & ~fired
        if run_host is None:                  # no pass ran
            run_host = run.cpu().numpy().astype(np.float32)
        return scores, i, run, run_host, fired, z

    def score_until_trigger(self, cache, frames: torch.Tensor, n_frames: int,
                            score_sum: float, prob_threshold: float | None,
                            sum_threshold: float | None, score_heads: tuple[str, ...],
                            resume_at: int = 0):
        """frames [T, F, H] (one row): score frames[0:n_frames] until the
        prob rule (stream-end score > ``prob_threshold``) or the sum rule
        (running sum > ``sum_threshold``, which then resets to 0) fires; a
        threshold of None never fires. The stream-end score is the sum of
        the ``score_heads`` among informative and relevance. ``resume_at``:
        the first frame (index into ``frames``) that may fire
        (response_min_interval_frames). One frame a pass, or at
        ``fused_frames`` > 1 JAX's ``score_until_trigger_fused``: each pass
        verifies that many frames in one weight stream and commits those up
        to and including the first trigger. Returns (scores [T, 3] f32 on the
        device, frames scored, running sum, fired). MUTATES ``cache``."""
        T = frames.shape[0]
        one = lambda x: np.asarray([x], np.int64)
        scores, i, _, run, fired, _ = self._trigger_loop(
            cache, frames[None], one(0), one(int(n_frames)),
            self._row_value(score_sum, torch.float32, 0.0, 1), np.zeros(1, bool),
            torch.zeros((1, T + self.fused_frames + 1, 3), device=self.device),
            self._rule(prob_threshold, sum_threshold, score_heads, 1),
            one(max(int(resume_at), 0)), None)
        return scores[0, :T], int(i[0]), float(run[0]), bool(fired[0])

    def score_until_trigger_multi(self, cache, frames: torch.Tensor, start, limit, score_sum,
                                  prob_threshold, sum_threshold, score_heads: tuple[str, ...],
                                  z_threshold=None, z_state=None, first_n_frames: int = 0,
                                  resume_at=None):
        """The row trigger loop of multi-stream serving: frames [B, T, F, H];
        start / limit / score_sum / resume_at [B]; thresholds scalars or [B]
        (inf: off for that row). Row b scores frames start_b .. limit_b - 1
        against the prob, sum and z rules (``z_threshold`` with the window
        ``z_state`` from ``new_z_state``, firing after ``first_n_frames``)
        and freezes at its first trigger, appending nothing more while the
        others go on; the call returns when the active set shrinks.
        ``resume_at`` is an index into the stream's T frames. Returns
        (scores [B, T, 3] f32 on the device, next index [B], running sum
        [B], fired [B], z_hist, z_cnt); the [B] values as numpy arrays.
        MUTATES ``cache``."""
        B, T = frames.shape[:2]
        z = self._z(z_threshold, z_state, first_n_frames, B)
        scores, i, _, run, fired, z = self._trigger_loop(
            cache, frames, self._host_rows(start, B), self._host_rows(limit, B),
            self._row_value(score_sum, torch.float32, 0.0, B), np.zeros(B, bool),
            torch.zeros((B, T + self.fused_frames + 1, 3), device=self.device),
            self._rule(prob_threshold, sum_threshold, score_heads, B),
            self._host_rows(resume_at, B), z)
        return (scores[:, :T], i.astype(np.int32), run, fired, z[0], z[1])
