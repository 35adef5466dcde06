"""Calibration of the decision parameters (alpha, beta, epsilon, uncertainty
threshold): the port's copy of ``aha_tpu/eval/grid_search.py``.

The combined score of every parameter combo is one broadcast numpy
expression, and each benchmark's objective (TVSum top-5 mAP, Mr.HiSum
mAP@50, Charades R@0.5) is scored for all combos in a few array operations,
in one process. The output file has the reference's format: {dataset:
{alpha, beta, epsilon, uncertainty_threshold, best_score[, test_top5_map]}}.
"""

from __future__ import annotations

import json
import math
import os
import random

import numpy as np

from . import grounding, hisum, tvsum
from .scoring import combined_score, traces_from_debug_data

DEFAULT_GRID = {
    "alpha": np.linspace(0.0, 1.5, 10),
    "beta": np.linspace(0.0, 1.5, 10),
    "epsilon": np.linspace(-5, 5, 15),
    "uncertainty_threshold": np.linspace(0.04, 0.15, 10),
}


def combo_arrays(grid: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The Cartesian product of the four parameter axes as flat [C] arrays."""
    a, b, e, t = np.meshgrid(grid["alpha"], grid["beta"], grid["epsilon"],
                             grid["uncertainty_threshold"], indexing="ij")
    return a.ravel(), b.ravel(), e.ravel(), t.ravel()


def _combined_per_video(prediction: dict, A, B, E, T, skip_first: bool = False):
    tr = traces_from_debug_data(prediction["debug_data"])
    s = slice(1, None) if skip_first else slice(None)
    return combined_score(tr["informative"][s], tr["relevance"][s], tr["uncertainty"][s],
                          A, B, E, T)


def tvsum_objective(predictions: list[dict], ground_truths: dict, A, B, E, T) -> np.ndarray:
    """Top-5 mAP for all combos, each video's ground truth taken at its
    true_frames_list."""
    aps = []
    for p in predictions:
        gt_all = np.asarray(ground_truths[p["video_uuid"]]["importance_scores"], np.float64)
        gt = gt_all[np.asarray(p["true_frames_list"][: len(p["debug_data"])], np.int64)]
        pred = _combined_per_video(p, A, B, E, T)          # [C, T]
        aps.append(tvsum.top_k_ap(tvsum.binarize_gt(gt, 0.5), pred, k=5))
    return np.mean(np.stack(aps), axis=0)


def hisum_objective(predictions: list[dict], gtscores: dict, A, B, E, T) -> np.ndarray:
    """mAP@50 for all combos; gtscores: video_uuid (or h5 id) -> gt array.
    debug_data[i] is scored against gtscore[i - 1], as the reference aligns
    them."""
    aps = []
    for p in predictions:
        gt_all = np.asarray(gtscores[p.get("h5_identifier", p["video_uuid"])], np.float64)
        n = min(len(p["debug_data"]), len(gt_all))
        gt = gt_all[: n - 1]
        pred = _combined_per_video(p, A, B, E, T, skip_first=True)[..., : n - 1]
        aps.append(hisum.map_at_rho(gt, pred, 0.5))
    with np.errstate(invalid="ignore"):
        return np.nanmean(np.stack(aps), axis=0)


def run_grid_search(dataset: str, predictions: list[dict], *, ground_truths: dict | None = None,
                    gtscores: dict | None = None, grid: dict | None = None,
                    save_path: str | None = None, seed: int | None = None) -> dict:
    """The best (alpha, beta, epsilon, uncertainty_threshold) for a dataset,
    the first maximum over the grid. tvsum / tvsum_degraded fit on the first
    80% of the videos shuffled by ``random.Random(seed)`` (the global
    ``random`` when seed is None) and report ``test_top5_map`` on the held-out
    set (all videos below five). ``save_path``: merged into that JSON file
    under the dataset's key."""
    grid = grid or DEFAULT_GRID
    A, B, E, T = combo_arrays(grid)

    test_set = None
    if dataset in ("tvsum", "tvsum_degraded"):
        idx = list(range(len(predictions)))
        rng = random.Random(seed) if seed is not None else random
        rng.shuffle(idx)
        shuffled = [predictions[i] for i in idx]
        n_train = math.floor(len(shuffled) * 0.8)
        train = shuffled[:n_train]
        test_set = shuffled[: -int(len(shuffled) * 0.2)] if len(shuffled) >= 5 else shuffled
        scores = tvsum_objective(train, ground_truths, A, B, E, T)
    elif dataset == "hisum":
        scores = hisum_objective(predictions, gtscores, A, B, E, T)
    elif dataset == "charades":
        scores = grounding.grid_score_r05(predictions, ground_truths, A, B, E, T)
    else:
        raise ValueError(f"no grid-search objective for dataset {dataset}")

    best = int(np.nanargmax(scores))
    best_params = {
        "alpha": float(A[best]),
        "beta": float(B[best]),
        "epsilon": float(E[best]),
        "uncertainty_threshold": float(T[best]),
        "best_score": float(scores[best]),
    }
    if test_set is not None:
        held_out = tvsum_objective(
            test_set, ground_truths, np.asarray([best_params["alpha"]]),
            np.asarray([best_params["beta"]]), np.asarray([best_params["epsilon"]]),
            np.asarray([best_params["uncertainty_threshold"]]))
        best_params["test_top5_map"] = float(held_out[0])

    if save_path:
        existing = {}
        if os.path.exists(save_path):
            with open(save_path) as f:
                existing = json.load(f)
        existing[dataset] = best_params
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(existing, f)
    return best_params
