"""Score-trace post-processing shared by every benchmark: the port's copy of
``aha_tpu/eval/scoring.py``.

The combined score of a frame is

    s = alpha * informative + beta * relevance - epsilon * max(0, unc - thr)

All functions are vectorised numpy; several take an extra leading "combo"
axis, so that the calibration grid search scores thousands of (alpha, beta,
epsilon, thr) candidates at once.
"""

from __future__ import annotations

import numpy as np


def combined_score(informative: np.ndarray, relevance: np.ndarray, uncertainty: np.ndarray,
                   alpha, beta, epsilon, uncertainty_threshold) -> np.ndarray:
    """Broadcasting combined score. Scalars give [T]; parameter arrays of
    shape [C] (with traces [T]) give [C, T]."""
    a = np.asarray(alpha, np.float64)
    b = np.asarray(beta, np.float64)
    e = np.asarray(epsilon, np.float64)
    th = np.asarray(uncertainty_threshold, np.float64)
    if a.ndim == 1:  # combo axis
        a, b, e, th = a[:, None], b[:, None], e[:, None], th[:, None]
        informative = informative[None]
        relevance = relevance[None]
        uncertainty = uncertainty[None]
    penalty = e * np.maximum(uncertainty - th, 0.0)
    return a * informative + b * relevance - penalty


def traces_from_debug_data(debug_data: list[dict]) -> dict[str, np.ndarray]:
    """A per-frame debug_data list as aligned f64 arrays (a missing score is 0)."""
    return {
        "time": np.asarray([e["time"] for e in debug_data], np.float64),
        "informative": np.asarray([e.get("informative_score", 0.0) for e in debug_data],
                                  np.float64),
        "relevance": np.asarray([e.get("relevance_score", 0.0) for e in debug_data], np.float64),
        "uncertainty": np.asarray([e.get("uncertainty_score", 0.0) for e in debug_data],
                                  np.float64),
    }


def smooth_pred_list(pred: np.ndarray, window_size: int = 4) -> np.ndarray:
    """Centred running mean over [i - w, i + w], shrunk at the edges;
    window_size 0 is the identity."""
    pred = np.asarray(pred, np.float64)
    n = pred.shape[-1]
    if window_size <= 0 or n == 0:
        return pred.copy()
    cs = np.cumsum(np.concatenate([np.zeros(pred.shape[:-1] + (1,)), pred], axis=-1), axis=-1)
    i = np.arange(n)
    lo = np.maximum(0, i - window_size)
    hi = np.minimum(n, i + window_size + 1)
    return (cs[..., hi] - cs[..., lo]) / (hi - lo)


def normalize_pred_list(pred: np.ndarray) -> np.ndarray:
    """Min-max normalised along the last axis (a flat row stays at 0)."""
    pred = np.asarray(pred, np.float64)
    mx = pred.max(axis=-1, keepdims=True)
    mn = pred.min(axis=-1, keepdims=True)
    rng = mx - mn
    rng = np.where(rng == 0, 1.0, rng)
    return (pred - mn) / rng


def is_time_in_span(time: float, spans) -> bool:
    return any(span[0] <= time <= span[1] for span in spans)


def times_in_spans(times: np.ndarray, spans) -> np.ndarray:
    """is_time_in_span over a time axis -> bool [T]."""
    times = np.asarray(times, np.float64)
    out = np.zeros(times.shape, bool)
    for s, e in spans:
        out |= (times >= s) & (times <= e)
    return out


def keep_longest_true_span(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """All but the longest run of True set to False; (mask, its length)."""
    mask = np.asarray(mask, bool)
    best_len = best_start = 0
    cur_len = 0
    cur_start = 0
    for i, v in enumerate(mask):
        if v:
            cur_len += 1
            if cur_len > best_len:
                best_len, best_start = cur_len, cur_start
        else:
            cur_len = 0
            cur_start = i + 1
    out = np.zeros_like(mask)
    if best_len:
        out[best_start: best_start + best_len] = True
    return out, best_len


def mask_iou(pred_mask: np.ndarray, gold_mask: np.ndarray) -> float:
    """IoU of two frame masks (0 where both are empty)."""
    inter = np.logical_and(pred_mask, gold_mask).sum()
    union = np.logical_or(pred_mask, gold_mask).sum()
    return 0.0 if union == 0 else float(inter) / float(union)


def span_iou(pred_span, gold_span) -> float:
    """IoU of closed integer spans (the +1 convention)."""
    ps, pe = pred_span
    gs, ge = gold_span
    inter = max(0, min(pe, ge) - max(ps, gs) + 1)
    union = max(pe, ge) - min(ps, gs) + 1
    return 0.0 if union == 0 else inter / union


def temporal_iou(span1, span2) -> float:
    """IoU of open intervals in seconds."""
    s1, e1 = span1
    s2, e2 = span2
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = max(e1, e2) - min(s1, s2)
    return 0.0 if union <= 0 else inter / union


def qvh_to_charades_format(example: dict) -> dict:
    """QVHighlights saliency clips collapsed into charades-style timestamps
    (runs of 2 s clips whose highest saliency is 4 or more), written into
    ``example["timestamps"]``; returns the example."""
    timestamps, start_clip_id = [], None
    clip_id = None
    for scores, clip_id in zip(example["answer"]["saliency_scores"],
                               example["answer"]["relevant_clip_ids"]):
        if max(scores) < 4:
            if start_clip_id is not None:
                timestamps.append([clip_id * 2, clip_id * 2])
                start_clip_id = None
        else:
            if start_clip_id is None:
                start_clip_id = clip_id
    if start_clip_id is not None:
        timestamps.append([start_clip_id * 2, clip_id * 2 + 2])
    example["timestamps"] = timestamps
    return example


def average_precision(labels: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """sklearn's step-interpolated AP over the last axis, vectorised over the
    leading ones: sum_k P@k * rel_k / P. NaN where a row has no positive
    label (sklearn warns and returns nan there)."""
    labels = np.asarray(labels, np.float64)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, axis=-1, kind="stable")
    rel = np.take_along_axis(labels, order, axis=-1)
    tp = np.cumsum(rel, axis=-1)
    k = np.arange(1, labels.shape[-1] + 1, dtype=np.float64)
    precision = tp / k
    num_pos = labels.sum(axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        ap = (precision * rel).sum(axis=-1) / num_pos
    return np.where(num_pos > 0, ap, np.nan)
