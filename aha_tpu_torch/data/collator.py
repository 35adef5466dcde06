"""Batch collation: tokenize, scatter the labels through the offset mapping,
pad to bucketed shapes.

The port's own copy of ``aha_tpu/data/collator.py``, with its buckets and
defaults, so that a batch's arrays are JAX's:

  * LM labels are pre-shifted: ``labels[start-1:stop-1] = ids[start:stop]``
    for each char learn range mapped through the offset mapping;
  * per-frame informative / relevance labels land on the LAST ``<image>``
    token of each frame (``v_placeholder_indices[F-1::F]``);
  * everything else, every padded position included, is IGNORE (-100);
  * rows are left-padded to the length bucket, and the frames of a batch are
    padded with black frames to the frame bucket (the port keeps JAX's
    buckets: the arrays are equal, and the card sees a handful of shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tokenization import StreamTokenizer
from .conversations import IGNORE, Example


def bucket_length(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


DEFAULT_LEN_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384)
DEFAULT_FRAME_BUCKETS = (8, 16, 32, 64, 128, 256, 512)


def _row_labels(
    ids: np.ndarray,
    offsets: list[tuple[int, int]],
    learn_ranges: list[range],
) -> np.ndarray:
    labels = np.full(len(ids), IGNORE, np.int64)
    starts = np.asarray([o[0] for o in offsets])
    for r in learn_ranges:
        cand = np.where(starts == r.start)[0]
        if len(cand) == 0:
            continue
        start_idx = int(cand[0])
        if starts[-1] >= r.stop:
            stop_candidates = np.where(starts == r.stop)[0]
            stop_idx = int(stop_candidates[0]) if len(stop_candidates) else len(ids)
        else:  # the final eos token
            stop_idx = len(ids)
        labels[start_idx - 1 : stop_idx - 1] = ids[start_idx:stop_idx]
    return labels


@dataclass
class Batch:
    input_ids: np.ndarray          # [B, T] int32, left-padded
    attention_mask: np.ndarray     # [B, T] bool
    labels: np.ndarray             # [B, T] int64 (pre-shifted)
    informative_labels: np.ndarray # [B, T] int64
    relevance_labels: np.ndarray   # [B, T] float32
    frames: np.ndarray | None      # [N_padded, S, S, 3]
    num_frames: int                # real frame count before padding
    sample_idxs: np.ndarray

    def asdict(self) -> dict:
        d = {
            "input_ids": self.input_ids,
            "attention_mask": self.attention_mask,
            "labels": self.labels,
            "informative_labels": self.informative_labels,
            "relevance_labels": self.relevance_labels,
        }
        if self.frames is not None:
            d["frames"] = self.frames
        return d


def collate(
    examples: list[Example],
    tokenizer: StreamTokenizer,
    *,
    v_placeholder_id: int,
    frame_num_tokens: int,
    pad_token_id: int | None = None,
    len_buckets: tuple[int, ...] = DEFAULT_LEN_BUCKETS,
    frame_buckets: tuple[int, ...] = DEFAULT_FRAME_BUCKETS,
) -> Batch:
    pad_id = pad_token_id if pad_token_id is not None else tokenizer.pad_token_id
    rows = []
    for ex in examples:
        ids, offsets = tokenizer.encode_with_offsets(ex.text)
        ids = np.asarray(ids, np.int64)
        labels = _row_labels(ids, offsets, ex.learn_ranges)

        info = np.full(len(ids), IGNORE, np.int64)
        rel = np.full(len(ids), float(IGNORE), np.float32)
        ph = np.where(ids == v_placeholder_id)[0]
        learn_idx = ph[frame_num_tokens - 1 :: frame_num_tokens]
        if ex.informative_labels is not None and len(learn_idx):
            info[learn_idx[: len(ex.informative_labels)]] = ex.informative_labels[: len(learn_idx)]
        if ex.relevance_labels is not None and len(learn_idx):
            rel[learn_idx[: len(ex.relevance_labels)]] = ex.relevance_labels[: len(learn_idx)]
        rows.append((ids, labels, info, rel))

    T = bucket_length(max(len(r[0]) for r in rows), len_buckets)
    B = len(rows)
    input_ids = np.full((B, T), pad_id, np.int32)
    attn = np.zeros((B, T), bool)
    labels = np.full((B, T), IGNORE, np.int64)
    info_l = np.full((B, T), IGNORE, np.int64)
    rel_l = np.full((B, T), float(IGNORE), np.float32)
    for i, (ids, lab, info, rel) in enumerate(rows):
        n = len(ids)
        input_ids[i, T - n :] = ids          # left padding (ref tokenizer setting)
        attn[i, T - n :] = True
        labels[i, T - n :] = lab
        info_l[i, T - n :] = info
        rel_l[i, T - n :] = rel

    frames = None
    num_frames = 0
    frame_arrays = [ex.frames for ex in examples if ex.frames is not None]
    if frame_arrays:
        cat = np.concatenate(frame_arrays, axis=0)
        num_frames = cat.shape[0]
        N = bucket_length(num_frames, frame_buckets)
        if N > num_frames:
            pad = np.zeros((N - num_frames, *cat.shape[1:]), cat.dtype)
            cat = np.concatenate([cat, pad], axis=0)
        frames = cat

    return Batch(
        input_ids=input_ids,
        attention_mask=attn,
        labels=labels,
        informative_labels=info_l,
        relevance_labels=rel_l,
        frames=frames,
        num_frames=num_frames,
        sample_idxs=np.asarray([ex.sample_idx for ex in examples]),
    )
