"""StreamSession: the single-stream streaming-inference session.

Counterpart of ``aha_tpu/streaming/session.py``: the benchmark loop
``inference()``, the prob / sum / z trigger rules, ``score_video``, the offline
baseline ``offline_generate``, and the demo's interactive API
(``input_frame_embeds``, ``encode_given_query``, ``input_one_frame``: a frame
a call, the rule checked on the host, as the stepwise loop) and
``find_ticks``.
``inference()`` runs the chunked loop by default, as JAX's does: the runs of
frames between queries and responses go through the engine's trigger loops
(``engine_trigger.py``), which score ``fused_score_frames`` frames a decoder
pass and read one small tensor back per pass; ``inference(chunked=False)``
is the stepwise loop, one frame a pass with the rule applied on the host.
Both make the same decisions on the same scores. ``score_video`` scores
``fused_score_frames`` frames per pass and a response is generated
``spec_decode_tokens`` candidates per pass (both through the engine's
read-only verify pass). The session only sequences chunks and applies the
trigger policy; tensor work is in
:class:`~aha_tpu_torch.streaming.engine.StreamEngine`.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import AhaConfig, InferConfig
from ..ops.kv_cache import CachePolicy
from ..tokenization import StreamTokenizer
from .engine import StreamEngine
from .engine_trigger import z_step_host


class StreamSession:
    def __init__(self, engine: StreamEngine, tokenizer: StreamTokenizer,
                 infer_cfg: InferConfig):
        infer_cfg.validate()
        self.engine = engine
        self.tokenizer = tokenizer
        self.args = infer_cfg
        self.score_heads = list(infer_cfg.score_heads)
        self.stream_end_prob_threshold = infer_cfg.stream_end_prob_threshold
        self.stream_end_score_sum_threshold = infer_cfg.stream_end_score_sum_threshold
        self.threshold_z = infer_cfg.threshold_z
        self.response_min_interval_frames = infer_cfg.response_min_interval_frames
        self.first_n_frames_no_generate = infer_cfg.first_n_frames_no_generate
        self.running_list_length = infer_cfg.running_list_length
        self.remove_assistant_turns = infer_cfg.remove_assistant_turns

        self._start_ids = tokenizer.apply_chat_template(
            [{"role": "system", "content": infer_cfg.system_prompt}])
        self._added_stream_prompt_ids = tokenizer.apply_chat_template(
            [{}], add_stream_prompt=True)
        self._added_stream_generation_ids = tokenizer.apply_chat_template(
            [{}], add_stream_generation_prompt=True)
        self.cache = None
        # unset unless positive; set_fps() may set it later (the demo path)
        self.frame_fps: float | None = None
        self.frame_interval: float | None = None
        if infer_cfg.frame_fps and infer_cfg.frame_fps > 0:
            self.set_fps(infer_cfg.frame_fps)
        self.reset()

    def set_fps(self, fps: float | None = None, frame_interval: float | None = None):
        """The stream's frame rate, given as frames per second or as seconds
        between frames (exactly one of the two)."""
        if (fps is None) == (frame_interval is None):
            raise ValueError("set_fps: give fps or frame_interval, not both and not neither")
        if fps is not None:
            self.frame_fps = fps
            self.frame_interval = 1.0 / fps
        else:
            self.frame_interval = frame_interval
            self.frame_fps = 1.0 / frame_interval

    def reset(self):
        self.query_queue: collections.deque = collections.deque()
        self.frame_embeds_queue: collections.deque = collections.deque()
        self.video_time = 0.0
        self.frame_idx = 0
        self.last_role = "system"
        self.init_vision_time = False
        self.stream_end_prob_list: list[float] = []
        # the chunked loop's z window on the device (made at first use)
        self._z_state = None
        self.stream_end_score_sum = 0.0
        self.last_response_frame: int | None = None
        self.debug_data_list: list[dict] = []
        self._pending_last_ids: list[int] = []
        # draft context for speculative decoding: recent conversation text
        # (query ids, earlier response ids), most recent last, capped at
        # _DRAFT_CTX_TOKENS. An n-gram draft source only, never fed to the
        # model.
        self._draft_ctx: list[int] = []
        # reuse the allocated ring buffer across videos (metadata-only reset)
        if self.cache is not None:
            self.engine.reset_cache(self.cache)
        else:
            self.cache = self.engine.new_cache()
        self.rep_counts = self.engine.new_rep_counts()

    # -- inputs ---------------------------------------------------------------

    def input_video_stream(self, video_frames):
        """Pre-encode all frames ([T, H, W, 3] pixels) into the frame queue;
        the embeddings stay on the device."""
        embeds = self.engine.encode_frames(video_frames)
        for r in range(embeds.shape[0]):
            self.frame_embeds_queue.append((r / self.frame_fps, embeds[r]))

    def input_frame_embeds(self, frame_embeds: torch.Tensor, time: float):
        """Push one pre-encoded frame ([F, H], on the engine's device): the
        interactive path."""
        self.frame_embeds_queue.append((time, frame_embeds))

    def input_query_stream(self, conversation: list[dict]):
        for turn in conversation:
            if turn["role"] == "user":
                self.query_queue.append((turn["time"], turn["content"]))

    def encode_given_query(self, query: str):
        """Encode ``query`` now, at the stream's current time (interactive
        path)."""
        self.query_queue.append((self.video_time, query))
        self._encode_query()

    def input_one_frame(self) -> dict:
        """Score the next queued frame and apply the trigger rule to it, as
        one step of the stepwise loop: {frame_idx, time (rounded to 0.1 s),
        uncertainty_score, informative_score, relevance_score, response (the
        generated text, or None)}."""
        video_scores, uncertainty_score = self._encode_frame()
        ret = dict(frame_idx=self.frame_idx, time=round(self.video_time, 1),
                   uncertainty_score=uncertainty_score, **video_scores)
        ret["response"] = (self._generate_response() if self._check_trigger(video_scores)
                           else None)
        self.video_time += 1.0 / self.frame_fps
        return ret

    # -- chunk encoders -------------------------------------------------------

    def _encode_frame(self):
        if not self.frame_embeds_queue:
            return None, None
        _, frame_embeds = self.frame_embeds_queue.popleft()
        prefix_ids = self._frame_prefix_ids()
        if prefix_ids:
            scores = self.engine.append_text_frames(self.cache, [prefix_ids],
                                                    frame_embeds[None])
        else:
            scores = self.engine.append_frames(self.cache, frame_embeds[None])
        self.frame_idx += 1
        self.last_role = "stream"
        info, rel, unc = (float(x) for x in scores[0].cpu())
        return {"informative_score": info, "relevance_score": rel}, unc

    def _frame_prefix_ids(self) -> list[int]:
        """Role-transition ids owed before the next frame, which carries them
        in its own chunk: the system prompt before the first frame, and after
        a response its final token (usually eos, produced but never fed
        through the decoder) with the stream prompt, as the reference's
        cat([last_ids, _added_stream_prompt_ids])."""
        if not self.init_vision_time:
            self.init_vision_time = True
            return list(self._start_ids)
        if self.last_role == "assistant" and not self.remove_assistant_turns:
            return self._pending_last_ids + self._added_stream_prompt_ids
        return []

    def _encode_query(self):
        _, query = self.query_queue.popleft()
        query_ids = self.tokenizer.apply_chat_template(
            [{"role": "user", "content": query}],
            add_stream_query_prompt=self.last_role == "stream",
            add_stream_prompt=True,
        )
        self.engine.append_ids(self.cache, [query_ids])
        self._push_draft_ctx(query_ids)
        self.last_role = "user"

    _DRAFT_CTX_TOKENS = 128

    def _push_draft_ctx(self, ids):
        self._draft_ctx.extend(int(t) for t in ids)
        self._draft_ctx = self._draft_ctx[-self._DRAFT_CTX_TOKENS:]

    def _draft_ctx_arrays(self):
        """(ctx_ids [1, 128], ctx_len [1]) for ``engine.generate``: the
        speculative drafter's lookup context, at a fixed width."""
        ids = np.zeros((1, self._DRAFT_CTX_TOKENS), np.int32)
        n = len(self._draft_ctx)
        ids[0, :n] = self._draft_ctx
        return ids, np.asarray([n], np.int32)

    def _generate_response(self) -> str:
        # generation writes the cache in place: keep a copy to roll back to
        pre_cache = self.cache.clone() if self.remove_assistant_turns else None
        out_ids, out_len, self.rep_counts, last_tok = self.engine.generate(
            self.cache, [self._added_stream_generation_ids], self.rep_counts,
            ctx=self._draft_ctx_arrays())
        if self.remove_assistant_turns:
            self.cache = pre_cache
        else:
            self._pending_last_ids = [int(last_tok[0])]
        n = int(out_len[0])
        ids = out_ids[0, :n].cpu().numpy()
        response = self.tokenizer.decode(ids, skip_special_tokens=True)
        self._push_draft_ctx(ids)   # earlier answers seed later drafts
        self.last_role = "assistant"
        return response

    # -- decision policy --------------------------------------------------------

    def _stream_end(self, info: float, rel: float) -> float:
        """The stream-end score: the sum of the ``score_heads`` among
        informative and relevance."""
        return sum(v for key, v in (("informative_score", info), ("relevance_score", rel))
                   if key in self.score_heads)

    def _sum_prob_trigger(self, stream_end_score: float, eligible: bool) -> bool:
        """The sum rule (the running sum, reset to 0 on a hit) and the prob
        rule for one frame."""
        need_response = False
        self.stream_end_score_sum += stream_end_score
        if (self.stream_end_score_sum_threshold is not None
                and self.stream_end_score_sum > self.stream_end_score_sum_threshold
                and eligible):
            need_response = True
            self.stream_end_score_sum = 0.0
        if (self.stream_end_prob_threshold is not None
                and stream_end_score > self.stream_end_prob_threshold and eligible):
            need_response = True
        return need_response

    def _check_trigger(self, video_scores: dict) -> bool:
        stream_end_score = self._stream_end(video_scores["informative_score"],
                                            video_scores["relevance_score"])
        self.stream_end_prob_list.append(stream_end_score)
        if isinstance(self.running_list_length, int) and self.running_list_length > 0:
            self.stream_end_prob_list = self.stream_end_prob_list[-self.running_list_length:]
        eligible = self._trigger_eligible(self.frame_idx - 1)
        need_response = self._sum_prob_trigger(stream_end_score, eligible)
        if self.threshold_z is not None and eligible and self._z_trigger(stream_end_score):
            need_response = True
        if need_response:
            self.last_response_frame = self.frame_idx - 1
        return need_response

    def _trigger_eligible(self, frame: int) -> bool:
        """response_min_interval_frames: a frame may fire only N frames or
        more after the previous response's frame."""
        n = self.response_min_interval_frames
        if n is None or self.last_response_frame is None:
            return True
        return frame - self.last_response_frame >= n

    def _z_trigger(self, stream_end_score: float) -> bool:
        """Fire when the score is more than threshold_z standard deviations
        above the running-list mean, once first_n_frames_no_generate frames
        have been scored. Window statistics in float32, 1e-6 std floor, as
        the JAX session computes them."""
        hist = self.stream_end_prob_list
        if self.frame_idx < max(self.first_n_frames_no_generate, 2) or len(hist) < 2:
            return False
        w = np.asarray(hist, np.float32)
        nf = np.float32(len(w))
        mean = np.float32(w.sum(dtype=np.float32) / nf)
        var = np.float32(((w - mean) ** 2).sum(dtype=np.float32) / nf)
        z = (np.float32(stream_end_score) - mean) / max(np.float32(np.sqrt(var)),
                                                         np.float32(1e-6))
        return float(z) > float(self.threshold_z)

    # -- main loops -----------------------------------------------------------

    def inference(self, verbose: bool = False, chunked: bool = True) -> list[dict]:
        """The benchmark loop: returns the conversation with the generated
        assistant turns; per-frame scores land in ``self.debug_data_list``.
        ``chunked=True`` (the default, as in JAX) scores each run of frames
        between queries and responses through the engine's trigger loops:
        ``score_until_trigger`` for the prob and sum rules,
        ``score_until_trigger_multi`` at one row for the z rule (its window
        lives on the device), ``fused_score_frames`` frames a pass and one
        host read per pass. ``chunked=False`` is the stepwise loop: one frame
        a pass, the rule applied on the host. The two give the same
        decisions on the same scores; the frame a response follows carries
        its role prefix in its own chunk either way. ``verbose`` is accepted
        and changes nothing, as in JAX."""
        if chunked:
            return self._inference_chunked()
        return self._inference_stepwise()

    def _inference_stepwise(self) -> list[dict]:
        model_response_list = [
            {"time": q[0], "content": q[1], "role": "user"} for q in self.query_queue]
        while self.frame_embeds_queue:
            if self.query_queue and self.video_time >= self.query_queue[0][0]:
                self._encode_query()
            video_scores, uncertainty_score = self._encode_frame()
            self.debug_data_list.append(
                dict(time=self.video_time, **video_scores, uncertainty_score=uncertainty_score))
            if self._check_trigger(video_scores):
                response = self._generate_response()
                model_response_list.append(
                    {"time": self.video_time, "content": response, "role": "assistant"})
            self.video_time += 1.0 / self.frame_fps
        return sorted(model_response_list, key=lambda x: x["time"])

    def _z_dev(self):
        """The z window on the device, ([1, L] scores, [1] count), L the
        running-list length; made at first use."""
        if self._z_state is None:
            self._z_state = self.engine.new_z_state(
                window=max(int(self.running_list_length or 20), 2))
        return self._z_state

    def _prefix_frame(self, prefix: list[int], frame_embeds: torch.Tensor) -> tuple:
        """The frame after a response (or the first frame) with its
        role-transition prefix in the same chunk (the chunk boundary is
        semantic under the 'hf' mask once the window is full), its rule
        checked on the host; the z window on the device is pushed too.
        Returns (scores [1, 3] f64 on the host, fired)."""
        s = self.engine.append_text_frames(self.cache, [prefix], frame_embeds[None])
        s_host = s.double().cpu().numpy()
        stream_end = self._stream_end(float(s_host[0, 0]), float(s_host[0, 1]))
        eligible = self._trigger_eligible(self.frame_idx)
        triggered = self._sum_prob_trigger(stream_end, eligible)
        if self.threshold_z is not None:
            zh, zc = self._z_dev()
            zh, zc = zh.cpu().numpy().copy(), zc.cpu().numpy().copy()
            fire = z_step_host(zh, zc, 0, stream_end, self.threshold_z,
                               int(self.first_n_frames_no_generate or 0))
            triggered = triggered or (eligible and fire)
            dev = self.engine.device
            self._z_state = (torch.as_tensor(zh, device=dev), torch.as_tensor(zc, device=dev))
        return s_host, triggered

    def _resume_offset(self) -> int:
        """Frames from the next one to score until one may fire again
        (response_min_interval_frames; <= 0: no suppression)."""
        if self.response_min_interval_frames is None or self.last_response_frame is None:
            return 0
        return self.last_response_frame + self.response_min_interval_frames - self.frame_idx

    def _inference_chunked(self) -> list[dict]:
        model_response_list = [
            {"time": q[0], "content": q[1], "role": "user"} for q in self.query_queue]
        while self.frame_embeds_queue:
            if self.query_queue and self.video_time >= self.query_queue[0][0]:
                self._encode_query()
            # the frames until the next query is due, at least one: one query
            # is encoded per frame step, so two queries due at the same time
            # interleave as q1, frame, q2, frame
            next_q = self.query_queue[0][0] if self.query_queue else None
            chunk, times = [], []
            t = self.video_time
            for _, emb in self.frame_embeds_queue:
                if chunk and next_q is not None and t >= next_q:
                    break
                chunk.append(emb)
                times.append(t)
                t += 1.0 / self.frame_fps
            for _ in chunk:
                self.frame_embeds_queue.popleft()
            embeds = torch.stack(chunk)                      # [T, F, H]

            k = 0
            while k < len(chunk):
                prefix = self._frame_prefix_ids()
                if prefix:
                    s_host, triggered = self._prefix_frame(prefix, embeds[k])
                    n = 1
                elif self.threshold_z is None:
                    scores, n, self.stream_end_score_sum, triggered = \
                        self.engine.score_until_trigger(
                            self.cache, embeds[k:], len(chunk) - k, self.stream_end_score_sum,
                            self.stream_end_prob_threshold,
                            self.stream_end_score_sum_threshold, tuple(self.score_heads),
                            resume_at=self._resume_offset())
                    s_host = scores[:n].double().cpu().numpy()
                else:
                    # the z rule: the one-row loop of multi-stream serving, its
                    # window on the device; positions (start, resume_at) are
                    # indices into this chunk
                    scores, i_next, new_sum, trig, zh, zc = \
                        self.engine.score_until_trigger_multi(
                            self.cache, embeds[None], [k], [len(chunk)],
                            [self.stream_end_score_sum], self.stream_end_prob_threshold,
                            self.stream_end_score_sum_threshold, tuple(self.score_heads),
                            z_threshold=[self.threshold_z], z_state=self._z_dev(),
                            first_n_frames=max(int(self.first_n_frames_no_generate or 0), 0),
                            resume_at=[max(k + self._resume_offset(), 0)])
                    self._z_state = (zh, zc)
                    n = int(i_next[0]) - k
                    triggered = bool(trig[0])
                    s_host = scores[0, k:k + n].double().cpu().numpy()
                    self.stream_end_score_sum = float(new_sum[0])
                self.last_role = "stream"
                self.frame_idx += n
                for j in range(n):
                    info, rel, unc = (float(x) for x in s_host[j])
                    self.debug_data_list.append(dict(
                        time=times[k + j], informative_score=info, relevance_score=rel,
                        uncertainty_score=unc))
                    self.stream_end_prob_list.append(self._stream_end(info, rel))
                if isinstance(self.running_list_length, int) and self.running_list_length > 0:
                    self.stream_end_prob_list = self.stream_end_prob_list[-self.running_list_length:]
                k += n
                self.video_time = times[k - 1] + 1.0 / self.frame_fps
                if triggered:
                    self.last_response_frame = self.frame_idx - 1
                    self.video_time = times[k - 1]       # stamped at the triggering frame
                    response = self._generate_response()
                    model_response_list.append(
                        {"time": self.video_time, "content": response, "role": "assistant"})
                    self.video_time = times[k - 1] + 1.0 / self.frame_fps
        return sorted(model_response_list, key=lambda x: x["time"])

    def score_video(self, video_frames, query: str | None = None) -> list[dict]:
        """Score a whole video with no generation (the grounding path). Token
        order matches ``inference()`` with a time-0 query: query chunk,
        then the system chunk, then one chunk per frame."""
        if query is not None:
            # the reference loop encodes a time-0 query before the system
            # prompt's vision init
            query_ids = self.tokenizer.apply_chat_template(
                [{"role": "user", "content": query}],
                add_stream_query_prompt=False, add_stream_prompt=True)
            self.engine.append_ids(self.cache, [query_ids])
            self.last_role = "user"
        self.engine.append_ids(self.cache, [self._start_ids])
        self.init_vision_time = True
        embeds = self.engine.encode_frames(video_frames)
        scores = self.engine.score_stream(self.cache, embeds[None])
        scores = scores[0].double().cpu().numpy()
        self.last_role = "stream"
        self.frame_idx += scores.shape[0]
        out = []
        for t in range(scores.shape[0]):
            out.append(dict(time=self.video_time, informative_score=float(scores[t, 0]),
                            relevance_score=float(scores[t, 1]),
                            uncertainty_score=float(scores[t, 2])))
            self.video_time += 1.0 / self.frame_fps
        self.debug_data_list.extend(out)
        return out

    def find_ticks(self, scores, fps: float | None = None, **kw) -> list[float]:
        """Highlight tick times in seconds from a score trace
        (``ops.signal.find_ticks``), at ``fps`` or the session's rate."""
        from ..ops.signal import find_ticks

        return find_ticks(np.asarray(scores), fps or self.frame_fps, **kw)

    def offline_generate(self, video_frames, question: str, fps: float | None = None) -> str:
        """The offline baseline: the system prompt, the whole video, then the
        question, and one greedy answer (speculative at the engine's width,
        with no draft context)."""
        self.reset()
        if fps is not None:
            self.set_fps(fps=fps)
        self.engine.append_ids(self.cache, [self._start_ids])
        embeds = self.engine.encode_frames(video_frames)
        self.engine.score_stream(self.cache, embeds[None])
        q_ids = self.tokenizer.apply_chat_template(
            [{"role": "user", "content": question}],
            add_stream_query_prompt=True, add_generation_prompt=True)
        out_ids, out_len, self.rep_counts, _ = self.engine.generate(
            self.cache, [q_ids], self.rep_counts)
        n = int(out_len[0])
        return self.tokenizer.decode(out_ids[0, :n].cpu().numpy(), skip_special_tokens=True)


def build_session(params: dict, cfg: AhaConfig, tokenizer: StreamTokenizer,
                  infer_cfg: InferConfig, *, device="cuda", backend: str = "fused",
                  lora: dict | None = None, lora_scale: float = 0.0) -> StreamSession:
    """InferConfig -> CachePolicy -> engine -> session, on ``device`` (where
    ``params`` and ``lora`` must already live): the card unless the caller
    asks for the CPU; raises when there is no card. ``backend`` picks the
    quantized-matmul kernels (``ops.quant.BACKENDS``); ``lora`` adapters apply
    at ``lora_scale`` in every decoder pass. The widths of ``infer_cfg``
    (``fused_score_frames``, ``spec_decode_tokens``,
    ``spec_decode_tokens_max``) go to the engine as they are."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_session: device cuda requested but no GPU is available "
                           "(pass device='cpu' to run on the host)")
    policy = CachePolicy(kind=infer_cfg.kv_cache_policy, window=infer_cfg.kv_window,
                         num_sink=infer_cfg.num_sink_tokens, mask_mode=infer_cfg.kv_mask_mode)
    engine = StreamEngine(
        params, cfg, policy, device=device, max_new_tokens=infer_cfg.max_new_tokens,
        repetition_penalty=infer_cfg.repetition_penalty,
        kv_dtype=torch.int8 if infer_cfg.kv_cache_dtype == "int8" else None,
        backend=backend, spec_tokens=infer_cfg.spec_decode_tokens,
        spec_tokens_max=infer_cfg.spec_decode_tokens_max,
        fused_score_frames=infer_cfg.fused_score_frames, lora=lora, lora_scale=lora_scale)
    return StreamSession(engine, tokenizer, infer_cfg)
