"""Conversation-level example construction: per-frame label derivation,
frame clipping and text rendering.

The port's own copy of ``aha_tpu/data/conversations.py`` (which reaches for
no JAX): ``max_frames_clip``, ``informative_labels``, ``relevance_labels``,
``Example`` and ``build_example``, pure functions over conversation dicts.

Conversation message schema:
    {"role": "system"|"user"|"assistant"|"stream", "content": str,
     "num_frames": int, "learn": bool, "response_frame_num": int,
     "related": [{"related": bool|float, "num_frames": int}] | float}
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tokenization import StreamTokenizer

IGNORE = -100


def max_frames_clip(conversation: list[dict], load_range: range, max_num_frames: int):
    """Truncate the conversation + load range at max_num_frames."""
    conversation = [dict(m) for m in conversation]
    cum = 0
    for i, message in enumerate(conversation):
        if message["role"] == "stream":
            if cum + message["num_frames"] >= max_num_frames:
                if cum < max_num_frames:
                    conversation[i]["num_frames"] = max_num_frames - cum
                    conversation = conversation[: i + 1]
                else:
                    conversation = conversation[:i]
                load_range = range(load_range.start, load_range.start + max_num_frames)
                break
            cum += message["num_frames"]
    return conversation, load_range


def informative_labels(conversation: list[dict]) -> list[int]:
    """1 for the `response_frame_num` frames preceding an assistant turn,
    0 for earlier frames of a learned stream turn, IGNORE for unlearned."""
    labels: list[int] = []
    for i, turn in enumerate(conversation):
        if turn["role"] == "stream" and turn.get("num_frames", 0) > 0:
            if turn.get("learn"):
                if i != len(conversation) - 1:
                    nxt = conversation[i + 1]
                    response_frame_num = nxt.get("response_frame_num", 1)
                    next_role = nxt["role"]
                else:
                    response_frame_num = 1
                    next_role = None
                labels += [0] * (turn["num_frames"] - response_frame_num)
                labels += [int(next_role == "assistant")] * response_frame_num
            else:
                labels += [IGNORE] * turn["num_frames"]
    return labels


def relevance_labels(conversation: list[dict]) -> list[float]:
    """Per-frame relevance from `related` spans (grounding) or scalar scores
    (HIHD single-frame turns)."""
    labels: list[float] = []
    for turn in conversation:
        if turn["role"] == "stream" and turn.get("num_frames", 0) > 0:
            if turn.get("learn"):
                related = turn.get("related")
                if isinstance(related, list):
                    for info in related:
                        labels += [float(info["related"])] * info["num_frames"]
                elif related is None:
                    # learned stream turn without relevance annotation
                    labels += [float(IGNORE)] * turn["num_frames"]
                else:  # HIHD: one scalar per 1-frame stream turn
                    labels += [float(related)] * turn["num_frames"]
            else:
                labels += [float(IGNORE)] * turn["num_frames"]
    return labels


@dataclass
class Example:
    """One training example before tokenization/collation."""

    text: str
    learn_ranges: list[range]
    informative_labels: list[int] | None
    relevance_labels: list[float] | None
    num_frames: int
    load_range: range | None = None
    frames: np.ndarray | None = None          # [T, S, S, 3] uint8 (optional)
    sample_idx: int = -1


def build_example(
    conversation: list[dict],
    tokenizer: StreamTokenizer,
    *,
    system_prompt: str,
    max_num_frames: int | None = None,
    load_range: range | None = None,
    use_informative: bool = True,
    use_relevance: bool = True,
    add_generation_prompt: bool = False,
) -> Example:
    """The StreamMixIn.__getitem__ text path (frames load separately)."""
    if max_num_frames is not None and load_range is not None:
        conversation, load_range = max_frames_clip(conversation, load_range, max_num_frames)
    conversation = [{"role": "system", "content": system_prompt}] + conversation
    text = tokenizer.apply_chat_template(
        conversation, tokenize=False, add_generation_prompt=add_generation_prompt
    )
    learn = tokenizer.get_learn_ranges(conversation) if not add_generation_prompt else []
    n_frames = sum(t.get("num_frames", 0) for t in conversation if t["role"] == "stream")

    info = informative_labels(conversation) if use_informative else None
    rel = relevance_labels(conversation) if use_relevance else None
    if info is not None:
        assert len(info) >= n_frames, (len(info), n_frames)
        info = info[:n_frames]
    if rel is not None:
        assert len(rel) >= n_frames, (len(rel), n_frames)
        rel = rel[:n_frames]
    return Example(
        text=text,
        learn_ranges=learn,
        informative_labels=info,
        relevance_labels=rel,
        num_frames=n_frames,
        load_range=load_range,
    )
