"""Mr.HiSum summarisation metrics: the port's copy of ``aha_tpu/eval/hisum.py``.

Fixed-length shot segmentation, shot-level mAP at binarisation ratio rho,
the greedy budget-constrained F1 at 15%, and the aggregate entry. The mAP is
vectorised over an optional leading combo axis.
"""

from __future__ import annotations

import numpy as np
from scipy.stats import kendalltau, spearmanr

from .scoring import average_precision


def segment_into_shots(scores: np.ndarray, shot_length: int = 1, fps: int = 1):
    """Mean score per fixed-length shot: [..., T] -> ([..., n_seg], n_seg, seg)."""
    scores = np.asarray(scores, np.float64)
    seg = shot_length * fps
    n = scores.shape[-1]
    n_seg = -(-n // seg)
    pad = n_seg * seg - n
    if pad:
        # the mean of a ragged tail is the mean of its valid entries
        padded = np.concatenate([scores, np.full(scores.shape[:-1] + (pad,), np.nan)], axis=-1)
    else:
        padded = scores
    shaped = padded.reshape(*scores.shape[:-1], n_seg, seg)
    return np.nanmean(shaped, axis=-1), n_seg, seg


def map_at_rho(gt_scores: np.ndarray, pred_scores: np.ndarray, rho: float) -> np.ndarray:
    """Shot-level AP against the top-rho shots; pred may be [C, T]."""
    gt_seg, n_seg, _ = segment_into_shots(np.asarray(gt_scores, np.float64))
    pred_seg, _, _ = segment_into_shots(np.asarray(pred_scores, np.float64))
    k = max(1, int(rho * n_seg))
    labels = np.zeros(n_seg, np.int64)
    labels[np.argsort(gt_seg)[-k:]] = 1
    if pred_seg.ndim == 2:
        labels = np.broadcast_to(labels, pred_seg.shape)
    return average_precision(labels, pred_seg)


def mean_average_precision(gt_dict: dict, pred_dict: dict, rho: float = 0.5) -> np.ndarray:
    """The mean AP over the videos, a video whose AP is nan left out."""
    aps = np.stack([map_at_rho(gt_dict[v], pred_dict[v], rho) for v in gt_dict])
    with np.errstate(invalid="ignore"):
        return np.nanmean(aps, axis=0)


def f1_budget(gt_scores: np.ndarray, pred_scores: np.ndarray, budget: float = 0.15,
              shot_length: int = 1) -> float:
    """Greedy top-shot selection under a frame budget against the top
    percentile of the ground truth; per video, rounded to 2 decimals (the
    greedy break makes it sequential, not combo-vectorised)."""
    gt = np.asarray(gt_scores, np.float64)
    pred = np.asarray(pred_scores, np.float64)
    n = gt.shape[0]
    boundaries = [(i, min(i + shot_length, n)) for i in range(0, n, shot_length)]
    shot_scores = np.asarray([pred[s:e].mean() for s, e in boundaries])
    total_budget = int(budget * n)
    selected = np.zeros(n, bool)
    acc = 0
    for idx in np.argsort(shot_scores)[::-1]:
        s, e = boundaries[idx]
        if acc + (e - s) <= total_budget:
            selected[s:e] = True
            acc += e - s
        if acc >= total_budget:
            break
    gt_selected = gt >= np.percentile(gt, 100 * (1 - budget))
    tp = (selected & gt_selected).sum()
    denom = 2 * tp + (selected & ~gt_selected).sum() + (~selected & gt_selected).sum()
    f1 = 0.0 if denom == 0 else 2 * tp / denom
    return round(float(f1), 2)


def evaluate_scores(gt_dict: dict, pred_dict: dict, spearman_kendall: bool = False) -> dict:
    """mAP@50, mAP@15 and F1 over the videos; Spearman and Kendall too on
    request (a video whose lengths differ is left out of those)."""
    out = {
        "mAP@50": float(mean_average_precision(gt_dict, pred_dict, 0.5)),
        "mAP@15": float(mean_average_precision(gt_dict, pred_dict, 0.15)),
        "f1": float(np.mean([f1_budget(gt_dict[v], pred_dict[v]) for v in gt_dict])),
    }
    if spearman_kendall:
        sp, kd = [], []
        for v in gt_dict:
            gt, pred = np.asarray(gt_dict[v]), np.asarray(pred_dict[v])
            if len(gt) != len(pred):
                continue
            if len(gt) > 1:
                sp.append(spearmanr(gt, pred).statistic)
                kd.append(kendalltau(gt, pred).statistic)
            else:
                sp.append(0.0)
                kd.append(0.0)
        out["spearman"] = float(np.mean(sp))
        out["kendall"] = float(np.mean(kd))
    return out
