"""Multi-stream serving: B concurrent video streams in one batched engine.

Counterpart of ``aha_tpu/streaming/multi.py``. The batch runs over streams,
so one pass of the weights scores a frame (or decodes a token) for every
stream at once. Three classes:

* :class:`MultiStreamScorer`: lockstep scoring of B streams, no
  generation (grounding); shorter videos are padded with inactive frames.
* :class:`MultiStreamSession`: B streaming-QA sessions (queries at their own
  times, each row's own trigger rule, generation for the rows that fire),
  served by ``StreamEngine.serve_step``: a row freezes the moment its rule
  fires, decodes its response while the others keep scoring, and an
  inactive row appends nothing, so every row reproduces an independent
  :class:`~aha_tpu_torch.streaming.session.StreamSession`.
* :class:`MultiStreamServer`: continuous batching over B slots; the next
  waiting stream is admitted the moment a slot frees (its cache rows reset,
  ``ops.kv_cache.reset_cache_rows``).

``lora=`` / ``lora_scale=`` adapters apply to every row of every pass, as in
JAX. ``mesh=`` (a ``parallel.mesh.Mesh``, one process a rank) serves sharded:
the engine keeps each rank's blocks of the tree and of the cache, and returns
every row's results on every rank, so each rank runs the same host loop over
the same requests (``StreamEngine``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import AhaConfig, InferConfig
from ..ops.kv_cache import CachePolicy
from ..tokenization import StreamTokenizer
from .engine import StreamEngine

_THR_KEYS = ("stream_end_prob_threshold", "stream_end_score_sum_threshold", "threshold_z")


def _engine(params, cfg, infer_cfg: InferConfig, batch: int, device, backend, **kw):
    policy = CachePolicy(kind=infer_cfg.kv_cache_policy, window=infer_cfg.kv_window,
                         num_sink=infer_cfg.num_sink_tokens, mask_mode=infer_cfg.kv_mask_mode)
    return StreamEngine(params, cfg, policy, device=device, batch=batch, backend=backend,
                        kv_dtype=torch.int8 if infer_cfg.kv_cache_dtype == "int8" else None,
                        fused_score_frames=infer_cfg.fused_score_frames, **kw)


class MultiStreamScorer:
    """Scores B streams in lockstep, no generation (the grounding path)."""

    def __init__(self, params: dict, cfg: AhaConfig, tokenizer: StreamTokenizer,
                 infer_cfg: InferConfig, *, batch: int, device="cuda", backend: str = "fused",
                 lora=None, lora_scale: float = 0.0, mesh=None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.args = infer_cfg
        self.batch = batch
        self.engine = _engine(params, cfg, infer_cfg, batch, device, backend, lora=lora,
                              lora_scale=lora_scale, mesh=mesh)

    def score_videos(self, videos: list, queries: list, *, fps: float) -> list[list[dict]]:
        """B videos ([T_b, S, S, 3] pixels, arrays or tensors) and B queries (None: no query
        chunk) -> per stream its per-frame scores, as ``score_video`` gives
        them: the query chunk, the system prompt, then the frames
        (``fused_score_frames`` a pass)."""
        B = len(videos)
        if B != self.batch:
            raise ValueError(f"{B} videos for a batch of {self.batch}")
        eng = self.engine
        cache = eng.new_cache()
        id_rows = [[] if q is None else self.tokenizer.apply_chat_template(
            [{"role": "user", "content": q}], add_stream_query_prompt=False,
            add_stream_prompt=True) for q in queries]
        if any(id_rows):
            eng.append_ids(cache, id_rows)
        start_ids = self.tokenizer.apply_chat_template(
            [{"role": "system", "content": self.args.system_prompt}])
        eng.append_ids(cache, [start_ids] * B)

        lengths = [int(v.shape[0]) for v in videos]
        T = max(lengths)
        embeds = eng.encode_frames(torch.cat([torch.as_tensor(v, device=eng.device)
                                              for v in videos]))
        packed = embeds.new_zeros((B, T, *embeds.shape[1:]))
        active = np.zeros((B, T), bool)
        off = 0
        for b, n in enumerate(lengths):
            packed[b, :n] = embeds[off:off + n]
            active[b, :n] = True
            off += n
        scores = eng.score_stream(cache, packed, active).double().cpu().numpy()
        return [[dict(time=t / fps, informative_score=float(scores[b, t, 0]),
                      relevance_score=float(scores[b, t, 1]),
                      uncertainty_score=float(scores[b, t, 2])) for t in range(n)]
                for b, n in enumerate(lengths)]


class MultiStreamSession:
    """B concurrent streaming-QA sessions in one batched engine.

    ``run(videos, conversations, fps)`` -> per stream {"responses",
    "debug_data"}, with the trigger, template and rollback semantics of
    ``StreamSession.inference``."""

    _DRAFT_CTX_TOKENS = 128

    def __init__(self, params: dict, cfg: AhaConfig, tokenizer: StreamTokenizer,
                 infer_cfg: InferConfig, *, batch: int, engine: StreamEngine | None = None,
                 device="cuda", backend: str = "fused", lora=None, lora_scale: float = 0.0,
                 mesh=None):
        infer_cfg.validate()
        if infer_cfg.threshold_z is not None and not (
                isinstance(infer_cfg.running_list_length, int)
                and infer_cfg.running_list_length >= 2):
            raise ValueError("batched threshold_z needs a bounded running_list_length >= 2 "
                             f"(the z window is per-row device state); got "
                             f"{infer_cfg.running_list_length!r}")
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.args = infer_cfg
        self.batch = batch
        self.engine = engine or _engine(
            params, cfg, infer_cfg, batch, device, backend,
            max_new_tokens=infer_cfg.max_new_tokens,
            repetition_penalty=infer_cfg.repetition_penalty,
            spec_tokens=infer_cfg.spec_decode_tokens,
            spec_tokens_max=infer_cfg.spec_decode_tokens_max, lora=lora, lora_scale=lora_scale,
            mesh=mesh)
        # each row's rule: a request may override it (inf: off for that row)
        inf = lambda x: np.inf if x is None else float(x)
        self._default_prob = inf(infer_cfg.stream_end_prob_threshold)
        self._default_sum = inf(infer_cfg.stream_end_score_sum_threshold)
        self._default_z = inf(infer_cfg.threshold_z)
        # batched retirement: return to the host once this many rows wait
        self.retire_defer = min(max(int(infer_cfg.retire_defer or 1), 1), batch)
        self._start_ids = tokenizer.apply_chat_template(
            [{"role": "system", "content": infer_cfg.system_prompt}])
        self._stream_prompt_ids = tokenizer.apply_chat_template([{}], add_stream_prompt=True)
        self._gen_prompt_ids = tokenizer.apply_chat_template(
            [{}], add_stream_generation_prompt=True)
        self.last_response_latency_s: list[float] = []
        self.last_response_tokens: list[int] = []

    def run(self, videos: list, conversations: list[list[dict]], *, fps: float) -> list[dict]:
        """Lockstep serving of exactly ``batch`` streams: ``run_items`` with
        every slot admitted at the start and none refilled."""
        B = self.batch
        if len(videos) != B or len(conversations) != B:
            raise ValueError(f"{len(videos)} videos, {len(conversations)} conversations for a "
                             f"batch of {B}")
        T = max((int(v.shape[0]) for v in videos), default=1)
        res = self.run_items(list(zip(range(B), videos, conversations)), fps=fps,
                             max_frames=max(T, 1))
        return [res[b] for b in range(B)]

    def run_items(self, items, *, fps: float, on_result=None, max_frames: int | None = None,
                  stats: dict | None = None) -> dict:
        """The serving loop over ``batch`` slots: admit, queries, the serving
        step (prefix + frame, trigger scoring, generation), retire.

        ``items``: (key, video [T, S, S, 3], conversation[, options]) in
        admission order; options may override the trigger rule
        (``stream_end_prob_threshold``, ``stream_end_score_sum_threshold``,
        ``threshold_z``: a request with any of them has exactly those
        rules). The iterator may yield None ("nothing ready yet"): the
        occupied slots go on serving and admission is tried again on the
        next iteration; it ends the session by stopping. ``on_result(key,
        result)`` is called the moment a stream retires. ``stats``: a dict
        to accumulate a wall-clock phase split, each phase ending with a
        device sync (admit_s: encode and slot reset; text_s: the query chunk;
        score_s: ``serve_step``'s prefix step and trigger loop; gen_s:
        generation; host_s: the traces' bookkeeping) and counters
        (iterations, score_dispatches, gen_dispatches, frames_scored,
        tokens_generated). With it, ``serve_step`` leaves generation to the
        host, as under ``remove_assistant_turns``, so that generation is
        timed apart; every row's results are the same. Returns {key:
        {"responses", "debug_data"}}."""
        max_frames = max_frames or getattr(self, "max_frames", None)
        if not max_frames:
            raise ValueError("max_frames is required (constructor or call)")
        a = self.args
        B = self.batch
        eng = self.engine
        cfg = self.cfg
        dev = eng.device
        it = iter(items)
        exhausted = False

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def tick(name, t0, synced=True):
            if stats is None:
                return
            if synced:
                sync()
            stats[name] = stats.get(name, 0.0) + (time.perf_counter() - t0)

        def count(name, n=1):
            if stats is not None:
                stats[name] = stats.get(name, 0) + n

        frames_buf = torch.zeros((B, max_frames, cfg.frame_num_tokens, cfg.llm.hidden_size),
                                 dtype=eng.dtype, device=dev)
        cache = eng.new_cache()
        counts = eng.new_rep_counts()
        occupied = [False] * B
        key = [None] * B
        z_hist, z_cnt = eng.new_z_state(window=max(int(a.running_list_length or 20), 2))
        first_n = int(a.first_n_frames_no_generate or 0)
        min_int = a.response_min_interval_frames
        resume_at = np.zeros(B, np.int64)
        prob_thr = np.full(B, self._default_prob)
        sum_thr = np.full(B, self._default_sum)
        z_thr = np.full(B, self._default_z)
        T = np.zeros(B, np.int64)
        i = np.zeros(B, np.int64)
        score_sum = np.zeros(B, np.float64)
        last_role = ["system"] * B
        # each row's draft context for speculative decoding: recent conversation
        # text, newest last; a draft source only, never fed to the model
        CTX = self._DRAFT_CTX_TOKENS
        ctx_ids = np.zeros((B, CTX), np.int32)
        ctx_len = np.zeros(B, np.int32)

        def push_ctx(b, ids):
            ids = np.asarray(ids, np.int32).ravel()
            if ids.size >= CTX:
                ctx_ids[b] = ids[-CTX:]
                ctx_len[b] = CTX
                return
            n = int(ctx_len[b])
            keep = min(n, CTX - ids.size)
            if keep < n:
                ctx_ids[b, :keep] = ctx_ids[b, n - keep:n]
            ctx_ids[b, keep:keep + ids.size] = ids
            ctx_len[b] = keep + ids.size

        init_vision = [False] * B
        pending_last: list[list[int]] = [[] for _ in range(B)]
        queries: list[list[dict]] = [[] for _ in range(B)]
        q_ptr = [0] * B
        responses: list[list[dict]] = [[] for _ in range(B)]
        debug: list[list[dict]] = [[] for _ in range(B)]
        results: dict = {}

        def query_due(b):
            return q_ptr[b] < len(queries[b]) and i[b] / fps >= queries[b][q_ptr[b]]["time"]

        def absorb_scores(i_new, s_host):
            """Per-frame scores into the debug traces; advance the cursors."""
            for b in range(B):
                if not occupied[b]:
                    continue
                if i_new[b] > i[b]:
                    last_role[b] = "stream"
                for t in range(int(i[b]), int(i_new[b])):
                    debug[b].append(dict(time=t / fps, informative_score=float(s_host[b, t, 0]),
                                         relevance_score=float(s_host[b, t, 1]),
                                         uncertainty_score=float(s_host[b, t, 2])))
                i[b] = i_new[b]

        def absorb_responses(triggered, out_ids, out_len, last_tok):
            for b in range(B):
                if not triggered[b]:
                    continue
                n = int(out_len[b])
                resp_tokens.append(n)
                push_ctx(b, out_ids[b, :n])          # answers seed later drafts
                text = self.tokenizer.decode(out_ids[b, :n], skip_special_tokens=True)
                responses[b].append({"time": (int(i[b]) - 1) / fps, "content": text,
                                     "role": "assistant"})
                # flipped whatever remove_assistant_turns says, as the reference
                # does: it decides the next query's stream query prompt
                last_role[b] = "assistant"
                if min_int is not None:
                    resume_at[b] = int(i[b]) - 1 + int(min_int)
                if not a.remove_assistant_turns:
                    pending_last[b] = [int(last_tok[b])]

        def retire():
            for b in range(B):
                if occupied[b] and i[b] >= T[b]:
                    results[key[b]] = {"responses": sorted(responses[b], key=lambda x: x["time"]),
                                       "debug_data": debug[b]}
                    occupied[b] = False
                    if on_result is not None:
                        on_result(key[b], results[key[b]])

        # per response: the serving iteration's start (after admission) to the
        # response's text on the host; it includes the frames the same
        # iteration scored before the trigger
        resp_lat: list[float] = []
        resp_tokens: list[int] = []
        self.last_response_latency_s = resp_lat
        self.last_response_tokens = resp_tokens

        while True:
            count("iterations")
            t0 = time.perf_counter()
            # 0. admit waiting streams into free slots
            admit = np.zeros(B, bool)
            starved = False
            for b in range(B):
                if occupied[b] or starved:
                    continue
                while not exhausted:
                    try:
                        item = next(it)
                    except StopIteration:
                        exhausted = True
                        break
                    if item is None:             # the feeder has nothing ready
                        starved = True
                        break
                    k, video, conv, *rest = item
                    opts = rest[0] if rest else None
                    user_turns = sorted([t for t in conv if t.get("role") == "user"],
                                        key=lambda t: t["time"])
                    if video is None or video.shape[0] == 0:
                        results[k] = {"responses": [{"time": t["time"], "content": t["content"],
                                                     "role": "user"} for t in user_turns],
                                      "debug_data": []}
                        if on_result is not None:
                            on_result(k, results[k])
                        continue
                    n = int(video.shape[0])
                    if n > max_frames:
                        raise ValueError(f"stream {k!r} has {n} frames, more than max_frames "
                                         f"{max_frames}")
                    frames_buf[b, :n] = eng.encode_frames(video).to(frames_buf.dtype)
                    frames_buf[b, n:] = 0
                    occupied[b], key[b] = True, k
                    T[b], i[b], score_sum[b] = n, 0, 0.0
                    prob_thr[b], sum_thr[b], z_thr[b] = (self._default_prob, self._default_sum,
                                                         self._default_z)
                    z_hist[b], z_cnt[b] = 0.0, 0
                    resume_at[b] = 0
                    if opts and any(kk in opts for kk in _THR_KEYS):
                        # a request with any trigger key has exactly the rules it names
                        # (a reference process has exactly the rules it was started with)
                        prob_thr[b] = sum_thr[b] = z_thr[b] = np.inf
                        for kk, arr in zip(_THR_KEYS, (prob_thr, sum_thr, z_thr)):
                            if opts.get(kk) is not None:
                                arr[b] = float(opts[kk])
                    last_role[b], init_vision[b] = "system", False
                    pending_last[b] = []
                    ctx_ids[b], ctx_len[b] = 0, 0
                    queries[b], q_ptr[b] = user_turns, 0
                    responses[b] = [{"time": t["time"], "content": t["content"], "role": "user"}
                                    for t in user_turns]
                    debug[b] = []
                    admit[b] = True
                    break
            if admit.any():
                eng.reset_cache_rows(cache, admit)
                counts[torch.as_tensor(admit, device=dev)] = 0
            tick("admit_s", t0)
            if not any(occupied):
                if exhausted:
                    break
                time.sleep(0.005)                # the feeder is momentarily empty
                continue
            iter_t0 = time.perf_counter()

            t0 = time.perf_counter()
            # 1. the queries due now (one chunk; rows without one append nothing)
            q_rows = [[] for _ in range(B)]
            for b in range(B):
                if occupied[b] and i[b] < T[b] and query_due(b):
                    q_rows[b] = self.tokenizer.apply_chat_template(
                        [{"role": "user", "content": queries[b][q_ptr[b]]["content"]}],
                        add_stream_query_prompt=last_role[b] == "stream",
                        add_stream_prompt=True)
                    q_ptr[b] += 1
                    last_role[b] = "user"
                    push_ctx(b, q_rows[b])
            if any(q_rows):
                eng.append_ids(cache, q_rows)

            # 2. each row's frame limit: its length or its next query's frame. A row
            # that just took a query whose successor is due at the same time still
            # takes one frame first: one query per frame step, as the reference
            limit = np.where(occupied, T, 0)
            for b in range(B):
                if occupied[b] and q_ptr[b] < len(queries[b]):
                    boundary = int(np.ceil(queries[b][q_ptr[b]]["time"] * fps))
                    limit[b] = min(limit[b], max(boundary, i[b] + (1 if q_rows[b] else 0)))

            # 3. rows owing a role-transition prefix take their next frame behind
            # it in one chunk (the reference's forward boundary)
            p_rows = [[] for _ in range(B)]
            for b in range(B):
                if not occupied[b] or i[b] >= T[b]:
                    continue
                if not init_vision[b]:
                    p_rows[b] = list(self._start_ids)
                    init_vision[b] = True
                elif last_role[b] == "assistant" and not a.remove_assistant_turns:
                    p_rows[b] = pending_last[b] + list(self._stream_prompt_ids)
            can_step = np.asarray(occupied) & (i < limit)
            tick("text_s", t0)

            # the serving step: prefix + frame, the trigger loop and, for the rows
            # that fire, generation inline. remove_assistant_turns generates below
            # instead, so that the cache before generation survives as the
            # rollback point; so does the instrumented run, to time generation
            t0 = time.perf_counter()
            host_gen = a.remove_assistant_turns or stats is not None
            (scores_dev, i_new, new_sum, triggered, out_ids, out_len, counts, last_tok,
             z_hist, z_cnt) = eng.serve_step(
                cache, p_rows, can_step, frames_buf, i, limit, score_sum, counts,
                prob_thr, sum_thr, tuple(a.score_heads), self._gen_prompt_ids,
                do_generate=not host_gen, z_threshold=z_thr, z_state=(z_hist, z_cnt),
                first_n_frames=first_n, resume_at=resume_at, ctx=(ctx_ids, ctx_len),
                retire_defer=self.retire_defer)
            s_host = scores_dev.double().cpu().numpy()
            i_new = np.asarray(i_new, np.int64)
            triggered = np.asarray(triggered, bool) & np.asarray(occupied)
            score_sum = np.where(occupied, np.asarray(new_sum, np.float64), score_sum)
            count("score_dispatches")
            count("frames_scored", int((i_new - i).sum()))
            tick("score_s", t0, synced=False)
            t0 = time.perf_counter()
            absorb_scores(i_new, s_host)
            tick("host_s", t0, synced=False)

            # 4. generation for the rows that fired, where serve_step left it
            if triggered.any():
                t0 = time.perf_counter()
                if host_gen:
                    g_rows = [list(self._gen_prompt_ids) if f else [] for f in triggered]
                    # remove_assistant_turns: generate on a copy of the whole cache,
                    # so that ``cache`` stays as it was before generation (the
                    # repetition counts keep the response, as the solo session's do)
                    out_ids, out_len, counts, last_tok = eng.generate(
                        cache.clone() if a.remove_assistant_turns else cache, g_rows, counts,
                        active=triggered, ctx=(ctx_ids, ctx_len))
                    count("gen_dispatches")
                out_len = out_len.cpu().numpy()
                count("tokens_generated", int(out_len[triggered].sum()))
                tick("gen_s", t0)
                absorb_responses(triggered, out_ids.cpu().numpy(), out_len,
                                 last_tok.cpu().numpy())
                resp_lat.extend([time.perf_counter() - iter_t0] * int(triggered.sum()))

            # 5. retire finished streams (their slots free for the next admission)
            retire()

        if stats is not None and resp_lat:
            ls = self.latency_stats()
            stats["response_lat_p50_ms"] = ls["p50_ms"]
            stats["response_lat_p99_ms"] = ls["p99_ms"]
            stats["n_responses"] = ls["n_responses"]
        return results

    def latency_stats(self) -> dict:
        """Per-response latency of the last ``run`` / ``run_items`` (the
        serving iteration's start to the response's text on the host): p50,
        p99 and mean in ms, and the tokens the responses wrote;
        {"n_responses": 0} when there was none."""
        lat = np.asarray(self.last_response_latency_s or (), np.float64)
        if lat.size == 0:
            return {"n_responses": 0}
        return {"n_responses": int(lat.size), "tokens": int(sum(self.last_response_tokens)),
                "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 2),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 2),
                "mean_ms": round(float(lat.mean()) * 1e3, 2)}


class MultiStreamServer(MultiStreamSession):
    """Continuous batching over ``batch`` slots: ``run_items(items, fps=)``
    with ``items`` an iterable of (key, video, conversation[, options]);
    streams are admitted in order as slots free, each slot recycled with a
    reset of its cache rows, so each stream's outputs equal an independent
    ``StreamSession``'s. ``max_frames`` sizes the frames buffer."""

    def __init__(self, params, cfg, tokenizer, infer_cfg, *, batch: int, max_frames: int,
                 engine=None, device="cuda", backend: str = "fused", lora=None,
                 lora_scale: float = 0.0, mesh=None):
        super().__init__(params, cfg, tokenizer, infer_cfg, batch=batch, engine=engine,
                         device=device, backend=backend, lora=lora, lora_scale=lora_scale,
                         mesh=mesh)
        self.max_frames = max_frames
