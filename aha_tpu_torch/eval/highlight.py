"""Highlight reels: knapsack frame selection, window expansion and the mp4
writer; the port's copy of ``aha_tpu/eval/highlight.py``.

A 0/1 knapsack with unit frame cost and the frames' combined values picks
``max_duration`` model frames; each is widened to +-fps/2 source frames
around its true source index, and those source frames are copied into a
new mp4 with cv2. The DP is vectorised over the budget axis.
"""

from __future__ import annotations

import json

import numpy as np


def knapsack_selection(values: np.ndarray, max_duration: int) -> set[int]:
    """0/1 knapsack with unit costs over per-frame values [n]; the selected
    frame indices. Backtracking takes item i iff dp[i][j] != dp[i-1][j]."""
    values = np.asarray(values, np.float64)
    n = len(values)
    dp = np.zeros((n + 1, max_duration + 1))
    for i in range(1, n + 1):
        v = values[i - 1]
        dp[i, 0] = dp[i - 1, 0]
        dp[i, 1:] = np.maximum(dp[i - 1, 1:], dp[i - 1, :-1] + v)
    selected = []
    j = max_duration
    for i in range(n, 0, -1):
        if dp[i, j] != dp[i - 1, j]:
            selected.append(i - 1)
            j -= 1
    return set(selected)


def frame_values(debug_data: list[dict], alpha: float, beta: float, epsilon: float) -> np.ndarray:
    """value = alpha * informative + beta * relevance + epsilon * uncertainty
    (a positive epsilon term, unlike the evaluation's penalty)."""
    return np.asarray([alpha * f["informative_score"] + beta * f["relevance_score"]
                       + epsilon * f["uncertainty_score"] for f in debug_data], np.float64)


def expand_selection(selected: set[int], true_frame_indices: list[int], source_fps: float,
                     last_frame: int) -> list[int]:
    """Each selected model frame widened to the source frames within
    +-fps/2 of its source index, up to ``last_frame``; sorted."""
    half = int(source_fps // 2)
    out: set[int] = set()
    for idx in selected:
        center = true_frame_indices[idx]
        for i in range(max(0, center - half), min(last_frame + 1, center + half + 1)):
            out.add(i)
    return sorted(out)


def load_calibrated_params(path: str, dataset: str = "tvsum") -> tuple[float, float, float]:
    with open(path) as f:
        p = json.load(f)[dataset]
    return p["alpha"], p["beta"], p["epsilon"]


def write_reel(video_path: str, highlight_indices: list[int], output_path: str) -> int:
    """The highlighted source frames copied into a new mp4 (mp4v, the
    source's rate and size). Returns the number of frames written."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS)
    width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height))
    keep = set(highlight_indices)
    written = frame_idx = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if frame_idx in keep:
            out.write(frame)
            written += 1
        frame_idx += 1
    cap.release()
    out.release()
    return written


def generate_highlight(debug_data: list[dict], true_frame_indices: list[int], max_duration: int,
                       *, alpha: float, beta: float, epsilon: float, source_fps: float,
                       video_path: str | None = None, output_path: str | None = None) -> dict:
    """Selection, expansion and (with both paths) the reel: {selected,
    highlight_indices[, frames_written]}. max_duration must be below the
    number of frames."""
    n = len(debug_data)
    if max_duration >= n:
        raise ValueError(f"max_duration ({max_duration}) must be < num frames ({n})")
    values = frame_values(debug_data, alpha, beta, epsilon)
    selected = knapsack_selection(values, max_duration)
    highlight = expand_selection(selected, true_frame_indices, source_fps,
                                 last_frame=true_frame_indices[-1])
    result = {"selected": sorted(selected), "highlight_indices": highlight}
    if video_path and output_path:
        result["frames_written"] = write_reel(video_path, highlight, output_path)
    return result
