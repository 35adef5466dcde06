"""Charades-STA / QVHighlights temporal-grounding evaluation: the port's copy
of ``aha_tpu/eval/grounding.py``.

Each video's combined scores are (optionally) smoothed, min-max normalised,
thresholded over the sweep 0.30 .. 0.70 by 0.02 into frame masks and IoU'd
against the gold spans' frame mask; summarised as mean IoU and R@{0.3, 0.5,
0.7}, per threshold and best among the thresholds.
"""

from __future__ import annotations

import numpy as np

from .scoring import (combined_score, normalize_pred_list, smooth_pred_list, times_in_spans,
                      traces_from_debug_data)

THRESHOLDS = np.arange(0.30, 0.71, 0.02)


def per_video_ious(debug_data: list[dict], gold_spans, alpha: float, beta: float,
                   epsilon: float, uncertainty_threshold: float, smooth_window: int = 0,
                   thresholds: np.ndarray = THRESHOLDS) -> np.ndarray:
    """IoU per score threshold for one video -> [n_thresholds]."""
    tr = traces_from_debug_data(debug_data)
    pred = combined_score(tr["informative"], tr["relevance"], tr["uncertainty"],
                          alpha, beta, epsilon, uncertainty_threshold)
    if smooth_window:
        pred = smooth_pred_list(pred, smooth_window)
    pred = normalize_pred_list(pred)
    gold = times_in_spans(tr["time"], gold_spans)
    masks = pred[None, :] >= thresholds[:, None]           # [n_thr, T]
    inter = (masks & gold[None]).sum(axis=-1)
    union = (masks | gold[None]).sum(axis=-1)
    return np.where(union == 0, 0.0, inter / np.maximum(union, 1))


def summarize(ious: np.ndarray) -> dict:
    """ious [n_videos] -> mean IoU and recalls in percent."""
    return {
        "mIoU": float(np.mean(ious) * 100),
        "R@0.3": float(np.mean(ious >= 0.3) * 100),
        "R@0.5": float(np.mean(ious >= 0.5) * 100),
        "R@0.7": float(np.mean(ious >= 0.7) * 100),
    }


def evaluate_grounding(pred_examples: list[dict], gold_examples: dict, alpha: float, beta: float,
                       epsilon: float, uncertainty_threshold: float,
                       smooth_windows=range(0, 15),
                       thresholds: np.ndarray = THRESHOLDS) -> dict:
    """The full sweep: a row per (smoothing window, threshold), and per
    window the summary of each video's best threshold."""
    results = {"rows": [], "best_among_thresholds": {}}
    for w in smooth_windows:
        all_ious = np.stack([
            per_video_ious(p["debug_data"], gold_examples[p["question_id"]]["timestamps"],
                           alpha, beta, epsilon, uncertainty_threshold, smooth_window=w,
                           thresholds=thresholds)
            for p in pred_examples])                        # [n_videos, n_thr]
        for t_idx, t in enumerate(thresholds):
            results["rows"].append({"smooth_window_size": int(w), "threshold": float(t),
                                    **summarize(all_ious[:, t_idx])})
        results["best_among_thresholds"][int(w)] = summarize(all_ious.max(axis=1))
    return results


def grid_score_r05(pred_examples: list[dict], gold_examples: dict, alphas: np.ndarray,
                   betas: np.ndarray, epsilons: np.ndarray, thresholds_u: np.ndarray,
                   score_thresholds: np.ndarray = THRESHOLDS) -> np.ndarray:
    """The calibration objective: best-among-thresholds R@0.5 (no smoothing)
    for every combo of the flat [C] parameter arrays at once -> [C]."""
    C = alphas.shape[0]
    best_iou = np.zeros((C, len(pred_examples)))
    for vi, p in enumerate(pred_examples):
        tr = traces_from_debug_data(p["debug_data"])
        pred = combined_score(tr["informative"], tr["relevance"], tr["uncertainty"],
                              alphas, betas, epsilons, thresholds_u)        # [C, T]
        pred = normalize_pred_list(pred)
        gold = times_in_spans(tr["time"], gold_examples[p["question_id"]]["timestamps"])
        masks = pred[:, None, :] >= score_thresholds[None, :, None]   # [C, n_thr, T]
        inter = (masks & gold[None, None]).sum(axis=-1)
        union = (masks | gold[None, None]).sum(axis=-1)
        iou = np.where(union == 0, 0.0, inter / np.maximum(union, 1))  # [C, n_thr]
        best_iou[:, vi] = iou.max(axis=1)
    return (best_iou >= 0.5).mean(axis=1) * 100
