"""StreamSession: the single-stream streaming-inference session.

Counterpart of ``aha_tpu/streaming/session.py`` at widths 1 (one frame per
decoder pass, one token per generation pass): the benchmark loop
``inference()`` (the stepwise loop; the JAX chunked loop gives the same
outputs, tests/test_streaming.py::test_chunked_inference_matches_stepwise),
the prob / sum / z trigger rules, and ``score_video``. The session only
sequences chunks and applies the trigger policy; tensor work is in
:class:`~aha_tpu_torch.streaming.engine.StreamEngine`.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from aha_tpu.config import AhaConfig, InferConfig
from aha_tpu.tokenization import StreamTokenizer

from ..ops.kv_cache import CachePolicy
from .engine import StreamEngine


class StreamSession:
    def __init__(self, engine: StreamEngine, tokenizer: StreamTokenizer,
                 infer_cfg: InferConfig):
        infer_cfg.validate()
        self.engine = engine
        self.tokenizer = tokenizer
        self.frame_fps = infer_cfg.frame_fps
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
        self.reset()

    def reset(self):
        self.query_queue: collections.deque = collections.deque()
        self.frame_embeds_queue: collections.deque = collections.deque()
        self.video_time = 0.0
        self.frame_idx = 0
        self.last_role = "system"
        self.init_vision_time = False
        self.stream_end_prob_list: list[float] = []
        self.stream_end_score_sum = 0.0
        self.last_response_frame: int | None = None
        self.debug_data_list: list[dict] = []
        self._pending_last_ids: list[int] = []
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

    def input_query_stream(self, conversation: list[dict]):
        for turn in conversation:
            if turn["role"] == "user":
                self.query_queue.append((turn["time"], turn["content"]))

    # -- chunk encoders -------------------------------------------------------

    def _encode_frame(self):
        if not self.frame_embeds_queue:
            return None, None
        _, frame_embeds = self.frame_embeds_queue.popleft()
        if not self.init_vision_time:
            prefix_ids = self._start_ids
            self.init_vision_time = True
        elif self.last_role == "assistant" and not self.remove_assistant_turns:
            # the response's final token (usually eos) was produced but never
            # fed through the decoder; it leads the next chunk, as the
            # reference's cat([last_ids, _added_stream_prompt_ids])
            prefix_ids = self._pending_last_ids + self._added_stream_prompt_ids
        else:
            prefix_ids = []
        if prefix_ids:
            scores = self.engine.append_text_frames(self.cache, [prefix_ids],
                                                    frame_embeds[None])
        else:
            scores = self.engine.append_frames(self.cache, frame_embeds[None])
        self.frame_idx += 1
        self.last_role = "stream"
        info, rel, unc = (float(x) for x in scores[0].cpu())
        return {"informative_score": info, "relevance_score": rel}, unc

    def _encode_query(self):
        _, query = self.query_queue.popleft()
        query_ids = self.tokenizer.apply_chat_template(
            [{"role": "user", "content": query}],
            add_stream_query_prompt=self.last_role == "stream",
            add_stream_prompt=True,
        )
        self.engine.append_ids(self.cache, [query_ids])
        self.last_role = "user"

    def _generate_response(self) -> str:
        # generation writes the cache in place: keep a copy to roll back to
        pre_cache = self.cache.clone() if self.remove_assistant_turns else None
        out_ids, out_len, self.rep_counts, last_tok = self.engine.generate(
            self.cache, [self._added_stream_generation_ids], self.rep_counts)
        if self.remove_assistant_turns:
            self.cache = pre_cache
        else:
            self._pending_last_ids = [int(last_tok[0])]
        n = int(out_len[0])
        response = self.tokenizer.decode(out_ids[0, :n].cpu().numpy(),
                                         skip_special_tokens=True)
        self.last_role = "assistant"
        return response

    # -- decision policy --------------------------------------------------------

    def _check_trigger(self, video_scores: dict) -> bool:
        need_response = False
        stream_end_score = sum(v for k, v in video_scores.items() if k in self.score_heads)
        self.stream_end_prob_list.append(stream_end_score)
        self.stream_end_score_sum += stream_end_score
        if isinstance(self.running_list_length, int) and self.running_list_length > 0:
            self.stream_end_prob_list = self.stream_end_prob_list[-self.running_list_length:]
        eligible = self._trigger_eligible(self.frame_idx - 1)
        if (self.stream_end_score_sum_threshold is not None
                and self.stream_end_score_sum > self.stream_end_score_sum_threshold
                and eligible):
            need_response = True
            self.stream_end_score_sum = 0
        if (self.stream_end_prob_threshold is not None
                and stream_end_score > self.stream_end_prob_threshold and eligible):
            need_response = True
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

    def inference(self) -> list[dict]:
        """The benchmark loop: returns the conversation with the generated
        assistant turns; per-frame scores land in ``self.debug_data_list``."""
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


def build_session(params: dict, cfg: AhaConfig, tokenizer: StreamTokenizer,
                  infer_cfg: InferConfig, *, device="cpu") -> StreamSession:
    """InferConfig -> CachePolicy -> engine -> session, on ``device`` (where
    ``params`` must already live).

    Only widths 1 are ported: fused frame scoring and speculative decoding
    (``fused_score_frames`` / ``spec_decode_tokens`` > 1, the InferConfig
    defaults) raise rather than being narrowed silently."""
    if infer_cfg.fused_score_frames > 1 or infer_cfg.spec_decode_tokens > 1:
        raise NotImplementedError(
            "aha_tpu_torch runs widths 1 only: set fused_score_frames=1 and "
            "spec_decode_tokens=1 (fused scoring and speculative decoding are "
            "ROADMAP.md, Queue 1 items 6-7)")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_session: device cuda requested but no GPU is available")
    policy = CachePolicy(kind=infer_cfg.kv_cache_policy, window=infer_cfg.kv_window,
                         num_sink=infer_cfg.num_sink_tokens, mask_mode=infer_cfg.kv_mask_mode)
    engine = StreamEngine(
        params, cfg, policy, device=device, max_new_tokens=infer_cfg.max_new_tokens,
        repetition_penalty=infer_cfg.repetition_penalty,
        kv_dtype=torch.int8 if infer_cfg.kv_cache_dtype == "int8" else None)
    return StreamSession(engine, tokenizer, infer_cfg)
