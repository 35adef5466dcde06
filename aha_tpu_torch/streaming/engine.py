"""StreamEngine: the compute primitives behind single-stream inference.

Counterpart of the widths-1 subset of ``aha_tpu/streaming/engine.py``,
``engine_core.py`` and ``engine_generate.py``: cache creation and reset,
frame pre-encoding, text / frame / text+frame chunk appends, the per-frame
scoring loop and greedy generation with repetition penalty.

The cache is updated IN PLACE by every append (the JAX engine donates it
instead); each method returns what the caller reads (scores, logits, ids).
Id chunks are not padded to buckets: JAX pads only for static shapes, and a
padded token goes to the junk slot, so padding carries no meaning.
"""

from __future__ import annotations

import numpy as np
import torch

from aha_tpu.config import AhaConfig

from ..models import aha, qwen2
from ..ops.kv_cache import CachePolicy, KVCache, init_cache, reset_cache


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


class StreamEngine:
    """Params and compute primitives for one (config, cache policy) pair on
    one device, for one stream (batch 1 cache)."""

    def __init__(self, params: dict, cfg: AhaConfig, policy: CachePolicy, *,
                 device="cpu", max_new_tokens: int = 200,
                 repetition_penalty: float | None = None,
                 kv_dtype: torch.dtype | None = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        for t in _leaves(params):
            if t.device != self.device:
                raise ValueError(f"param on {t.device}, engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.policy = policy
        self.max_new_tokens = max_new_tokens
        self.repetition_penalty = repetition_penalty
        self.dtype = aha.torch_dtype(cfg.dtype)
        self.kv_dtype = kv_dtype or self.dtype

    # -- cache --------------------------------------------------------------

    def new_cache(self) -> KVCache:
        llm = self.cfg.llm
        return init_cache(self.policy, num_layers=llm.num_layers, batch=1,
                          num_kv_heads=llm.num_kv_heads, head_dim=llm.head_dim,
                          dtype=self.kv_dtype, device=self.device)

    def reset_cache(self, cache: KVCache) -> KVCache:
        return reset_cache(cache)

    def new_rep_counts(self) -> torch.Tensor:
        return torch.zeros((1, self.cfg.llm.vocab_size), dtype=torch.int32,
                           device=self.device)

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

    def _decode(self, cache: KVCache, embeds: torch.Tensor, valid_len: torch.Tensor):
        return qwen2.decode_chunk(self.params["llm"], self.cfg.llm, self.policy, cache,
                                  embeds, valid_len)

    @staticmethod
    def _last_valid(x: torch.Tensor, valid_len: torch.Tensor) -> torch.Tensor:
        idx = torch.clamp(valid_len.long() - 1, min=0)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def append_ids(self, cache: KVCache, ids_list: list[list[int]]) -> torch.Tensor:
        """Feed id chunks; returns f32 logits [B, V] at each row's last real
        token."""
        ids, lens = self.pad_ids(ids_list)
        embeds = qwen2.embed_tokens(self.params["llm"], ids, self.dtype)
        hidden = self._decode(cache, embeds, lens)
        last = self._last_valid(hidden, lens)
        return qwen2.lm_logits(self.params["llm"], self.cfg.llm, last).float()

    def append_frames(self, cache: KVCache, frame_embeds: torch.Tensor) -> torch.Tensor:
        """frame_embeds [B, F, H]; returns scores [B, 3] at the last token."""
        B, F = frame_embeds.shape[:2]
        valid = torch.full((B,), F, dtype=torch.int32, device=self.device)
        hidden = self._decode(cache, frame_embeds, valid)
        return aha.scores_from_hidden(self.params, hidden[:, -1])

    def append_text_frames(self, cache: KVCache, ids_list: list[list[int]],
                           frame_embeds: torch.Tensor) -> torch.Tensor:
        """One chunk per row: its text prefix immediately followed by one
        frame (the reference's forward boundary, semantic under the 'hf'
        mask once the window is full). Returns scores [B, 3] at the frame's
        last token."""
        ids, lens = self.pad_ids(ids_list)
        B, P = ids.shape
        F = frame_embeds.shape[1]
        text = qwen2.embed_tokens(self.params["llm"], ids, self.dtype)
        j = torch.arange(P + F, device=self.device)[None, :]
        n = lens.long()[:, None]
        bidx = torch.arange(B, device=self.device)[:, None]
        emb = torch.where((j < n)[..., None], text[bidx, j.clamp(max=P - 1)],
                          frame_embeds[bidx, (j - n).clamp(0, F - 1)])
        valid = lens + F
        hidden = self._decode(cache, emb, valid)
        return aha.scores_from_hidden(self.params, self._last_valid(hidden, valid))

    def score_stream(self, cache: KVCache, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, T, F, H] -> scores [B, T, 3], one frame chunk at a
        time, with no host sync inside the loop."""
        scores = [self.append_frames(cache, frames[:, t]) for t in range(frames.shape[1])]
        if not scores:
            return torch.zeros((frames.shape[0], 0, 3), device=self.device)
        return torch.stack(scores, dim=1)

    def encode_frames(self, frames) -> torch.Tensor:
        """[N, H, W, 3] pixels -> [N, F, H_llm], VISION_BATCH frames at a time."""
        frames = torch.as_tensor(frames, device=self.device)
        outs = [aha.visual_embed(self.params, self.cfg, frames[i:i + VISION_BATCH])
                for i in range(0, frames.shape[0], VISION_BATCH)]
        if not outs:
            return torch.zeros((0, self.cfg.frame_num_tokens, self.cfg.llm.hidden_size),
                               dtype=self.dtype, device=self.device)
        return torch.cat(outs, dim=0)

    # -- generation -----------------------------------------------------------

    def generate(self, cache: KVCache, ids_list: list[list[int]], counts: torch.Tensor):
        """Greedy decode after the prompt chunk. Returns (out_ids [B, N],
        out_len [B], counts, last_tok [B]); ``counts`` is updated in place.

        Every produced token is written, an eos included; eos is never
        penalised; the final written token is never fed back through the
        decoder (it leads the next chunk instead), and a pass in which no
        row has a token to feed is skipped."""
        eos = self.cfg.eos_token_id
        N = self.max_new_tokens
        pen = self.repetition_penalty
        logits = self.append_ids(cache, ids_list)
        B = logits.shape[0]
        rows = torch.arange(B, device=self.device)
        tok = torch.argmax(_apply_repetition_penalty(logits, counts, pen), dim=-1)
        out_ids = torch.zeros((B, N), dtype=torch.int32, device=self.device)
        out_len = torch.zeros((B,), dtype=torch.int32, device=self.device)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
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
            embeds = qwen2.embed_tokens(self.params["llm"], tok, self.dtype)[:, None, :]
            hidden = self._decode(cache, embeds, step.to(torch.int32))
            logits = qwen2.lm_logits(self.params["llm"], self.cfg.llm, hidden[:, 0]).float()
            tok = torch.argmax(_apply_repetition_penalty(logits, counts, pen), dim=-1)
        last_tok = out_ids[rows, torch.clamp(out_len.long() - 1, min=0)]
        return out_ids, out_len, counts, last_tok
