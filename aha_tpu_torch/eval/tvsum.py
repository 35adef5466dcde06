"""TVSum highlight-detection metrics: the port's copy of
``aha_tpu/eval/tvsum.py``.

The annotation TSV is averaged over its annotators (20 for TVSum), then
divided by 5; mAP at binarisation ratio rho, the trapezoid-interpolated
top-5 mAP, Spearman / Kendall (scipy) and F1 at rho. The score-level
functions take an optional leading combo axis for the calibration search.
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict

import numpy as np
from scipy.stats import kendalltau, spearmanr

from .scoring import average_precision


def load_annotations(annotation_file: str) -> dict:
    """TSV rows (video_id, category, comma-separated scores) -> per video
    {importance_scores: the annotators' mean / 5, video_uid, category_code}."""
    assert os.path.exists(annotation_file), f"{annotation_file} does not exist"
    counts: dict[str, int] = defaultdict(int)
    annos: dict[str, dict] = {}
    with open(annotation_file, newline="") as f:
        for row in csv.reader(f, delimiter="\t"):
            video_id, category, scores = row[0], row[1], row[2]
            arr = np.asarray([int(x) for x in scores.split(",")], np.float64)
            if video_id not in annos:
                annos[video_id] = {"importance_scores": arr, "video_uid": video_id,
                                   "category_code": category}
            else:
                annos[video_id]["importance_scores"] = annos[video_id]["importance_scores"] + arr
            counts[video_id] += 1
    for video_id, a in annos.items():
        a["importance_scores"] = (a["importance_scores"] / counts[video_id] / 5.0).tolist()
    return annos


def binarize_gt(gt_scores: np.ndarray, rho: float) -> np.ndarray:
    """The top-rho share of frames are positives (>= the k-th score)."""
    gt_scores = np.asarray(gt_scores, np.float64)
    n = gt_scores.shape[-1]
    k = max(1, int(rho * n))
    thresh = np.sort(gt_scores)[-k]
    return (gt_scores >= thresh).astype(np.int64)


def map_at_rho(gt_scores: np.ndarray, pred_scores: np.ndarray, rho: float) -> np.ndarray:
    """AP against the top-rho binarisation; pred_scores may be [C, T]."""
    gt_bin = binarize_gt(gt_scores, rho)
    pred = np.asarray(pred_scores, np.float64)
    if pred.ndim == 2:
        gt_bin = np.broadcast_to(gt_bin, pred.shape)
    return average_precision(gt_bin, pred)


def top_k_ap(gt_binary: np.ndarray, pred_scores: np.ndarray, k: int = 5) -> np.ndarray:
    """Trapezoid-interpolated AP over the top-k predicted frames, over the
    leading axes of pred_scores (fewer than k frames: all of them)."""
    pred = np.asarray(pred_scores, np.float64)
    gt = np.asarray(gt_binary, np.float64)
    k = min(k, pred.shape[-1])
    order = np.argsort(-pred, axis=-1, kind="stable")[..., :k]
    sel = np.take_along_axis(np.broadcast_to(gt, pred.shape), order, axis=-1)  # [..., k]
    num_gt = sel.sum(axis=-1)
    hits = np.cumsum(sel, axis=-1)
    with np.errstate(invalid="ignore", divide="ignore"):
        rec = hits / num_gt[..., None]
    prec = hits / np.arange(1, k + 1, dtype=np.float64)
    rec_prev = np.concatenate([np.zeros_like(rec[..., :1]), rec[..., :-1]], axis=-1)
    prec_prev = np.concatenate([np.ones_like(prec[..., :1]), prec[..., :-1]], axis=-1)
    ap = ((rec - rec_prev) * (prec + prec_prev) / 2.0).sum(axis=-1)
    return np.where(num_gt > 0, ap, 0.0)


def top5_map(gt_dict: dict, pred_dict: dict, rho: float = 0.5, top_k: int = 5) -> np.ndarray:
    aps = []
    for vid, gt in gt_dict.items():
        gt = np.asarray(gt, np.float64)
        pred = np.asarray(pred_dict[vid], np.float64)
        aps.append(top_k_ap(binarize_gt(gt, rho), pred, k=top_k))
    return np.mean(np.stack(aps), axis=0)


def f1_at_rho(gt_scores: np.ndarray, pred_scores: np.ndarray, rho: float) -> np.ndarray:
    """Binary F1 where both sides select their top-rho frames."""
    gt = np.asarray(gt_scores, np.float64)
    pred = np.asarray(pred_scores, np.float64)
    n = gt.shape[-1]
    k = max(1, int(rho * n))
    gt_bin = gt >= np.sort(gt)[-k]
    topk = np.argsort(pred, axis=-1)[..., -k:]
    pred_bin = np.zeros(pred.shape, bool)
    np.put_along_axis(pred_bin, topk, True, axis=-1)
    tp = (pred_bin & gt_bin).sum(axis=-1).astype(np.float64)
    fp = (pred_bin & ~gt_bin).sum(axis=-1).astype(np.float64)
    fn = (~pred_bin & gt_bin).sum(axis=-1).astype(np.float64)
    denom = 2 * tp + fp + fn
    return np.where(denom > 0, 2 * tp / np.where(denom == 0, 1, denom), 0.0)


def evaluate_f1(gt_dict: dict, pred_dict: dict, rho: float = 0.15) -> float:
    return float(np.mean([f1_at_rho(gt_dict[v], pred_dict[v], rho) for v in gt_dict]))


def evaluate_tvsum(gt_dict: dict, pred_dict: dict) -> dict:
    """mAP at 50% and 15%, top-5 mAP, Spearman, Kendall and F1 at 15%, each
    the mean over the videos (a video whose lengths differ is left out of
    all but the top-5 mAP and F1)."""
    map50s, map15s, spearmans, kendalls = [], [], [], []
    for vid, gt in gt_dict.items():
        pred = np.asarray(pred_dict[vid], np.float64)
        gt = np.asarray(gt, np.float64)
        if gt.shape[-1] != pred.shape[-1]:
            continue
        if gt.shape[-1] > 1:
            spearmans.append(spearmanr(gt, pred).statistic)
            kendalls.append(kendalltau(gt, pred).statistic)
        else:
            spearmans.append(0.0)
            kendalls.append(0.0)
        map50s.append(map_at_rho(gt, pred, 0.50))
        map15s.append(map_at_rho(gt, pred, 0.15))
    return {
        "mAP50": float(np.mean(map50s)),
        "mAP15": float(np.mean(map15s)),
        "top5_mAP": float(top5_map(gt_dict, pred_dict)),
        "spearman": float(np.mean(spearmans)),
        "kendall": float(np.mean(kendalls)),
        "f1@15": evaluate_f1(gt_dict, pred_dict),
    }


def evaluate_tvsum_per_category(gt_dict: dict, pred_dict: dict, annotations: dict) -> dict:
    """evaluate_tvsum over each category's videos, categories in sorted order."""
    by_cat: dict[str, list[str]] = defaultdict(list)
    for vid in gt_dict:
        by_cat[annotations[vid]["category_code"]].append(vid)
    return {cat: evaluate_tvsum({v: gt_dict[v] for v in vids}, {v: pred_dict[v] for v in vids})
            for cat, vids in sorted(by_cat.items())}
