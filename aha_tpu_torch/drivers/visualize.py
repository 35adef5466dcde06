"""Prediction-against-ground-truth figures: the port's copy of
``aha_tpu/drivers/visualize.py``.

``align_gt_to_pred`` / ``plot_pred_vs_gt`` / ``visualize_benchmark``: a
video's calibrated combined score over its gold importance curve (TVSum or
Mr.HiSum), from a driver's prediction JSON and the grid-search parameters;
``sota_comparison_plot`` / ``hisum_sota_figure`` / ``tvsum_sota_figure``:
the metrics beside the published baselines (``HISUM_PUBLISHED_BASELINES``).
Numpy on the host; matplotlib and h5py are imported where they are used.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..eval.scoring import combined_score, normalize_pred_list, traces_from_debug_data


def _calibrated_scores(prediction: dict, params: dict) -> np.ndarray:
    tr = traces_from_debug_data(prediction["debug_data"])
    return combined_score(
        tr["informative"], tr["relevance"], tr["uncertainty"],
        params["alpha"], params["beta"], params["epsilon"],
        params["uncertainty_threshold"],
    )


def align_gt_to_pred(prediction: dict, gt_scores: np.ndarray, gold_kind: str):
    """Align a gold curve to one prediction's debug_data before plotting.

    ``tvsum_tsv``: GT is per-ORIGINAL-frame while debug_data is sampled at
    ~1 fps — index GT by the prediction's ``true_frames_list`` (the
    reference tvsum visualize branch does ``vid_ground_truth[true_frame]``;
    same indexing as eval/grid_search.py).
    ``hisum_h5``: ``debug_data[i] <-> gtscore[i-1]`` starting at i=1 (the
    alignment used by hisum_sota_figure and cli.cmd_evaluate) — the first
    prediction entry has no gold partner, so pred_offset=1.
    ``json``: assumed pre-aligned.

    Returns ``(gt_aligned, pred_offset)``.
    """
    gt = np.asarray(gt_scores)
    if gold_kind == "tvsum_tsv":
        tfl = prediction.get("true_frames_list")
        if tfl:
            n = len(prediction.get("debug_data") or tfl)
            idx = np.clip(np.asarray(tfl[:n], np.int64), 0, len(gt) - 1)
            return gt[idx], 0
        return gt, 0
    if gold_kind == "hisum_h5":
        return gt, 1
    return gt, 0


def plot_pred_vs_gt(
    prediction: dict,
    gt_scores: np.ndarray,
    params: dict,
    out_path: str,
    *,
    title: str | None = None,
    extra_curves: dict[str, np.ndarray] | None = None,
    pred_offset: int = 0,
):
    """One video: normalized prediction vs GT curve (+ optional SOTA
    comparison curves, ref visualize.py SOTA overlays). ``pred_offset``
    drops leading prediction entries that have no gold partner (the HiSum
    ``debug_data[i] <-> gtscore[i-1]`` shift)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = normalize_pred_list(_calibrated_scores(prediction, params))[pred_offset:]
    gt = np.asarray(gt_scores, np.float64)
    n = min(len(pred), len(gt))
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(np.arange(n), gt[:n] / (gt[:n].max() or 1.0), label="ground truth",
            color="tab:green", lw=1)
    ax.plot(np.arange(n), pred[:n], label="prediction", color="tab:blue", lw=1)
    for name, curve in (extra_curves or {}).items():
        c = np.asarray(curve, np.float64)[:n]
        ax.plot(np.arange(n), c / (c.max() or 1.0), label=name, lw=1, alpha=0.7)
    ax.set_xlabel("frame")
    ax.set_ylabel("normalized score")
    ax.set_title(title or prediction.get("video_uuid", ""))
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def visualize_benchmark(
    pred_file: str,
    params_file: str,
    params_key: str,
    gt_lookup,              # prediction dict -> gt array | (gt, pred_offset)
    output_dir: str,
    *,
    max_videos: int | None = None,
) -> list[str]:
    """Batch plotting for a driver output JSON. ``gt_lookup`` receives the
    whole prediction dict (so it can align per-video via true_frames_list —
    see align_gt_to_pred) and returns either a gt array or a
    ``(gt, pred_offset)`` pair."""
    with open(pred_file) as f:
        preds = json.load(f)
    with open(params_file) as f:
        params = json.load(f)[params_key]
    os.makedirs(output_dir, exist_ok=True)
    out = []
    for p in preds[:max_videos]:
        gt = gt_lookup(p)
        if gt is None:
            continue
        pred_offset = 0
        if isinstance(gt, tuple):
            gt, pred_offset = gt
        path = os.path.join(output_dir, f"{p['video_uuid']}.png")
        out.append(plot_pred_vs_gt(p, gt, params, path, pred_offset=pred_offset))
    return out


# ---------------------------------------------------------------------------
# SOTA comparison panels (ref test/visualize.py "hisum_visualize_sota_scores"
# branch + per-category aggregation) — paper-figure reproduction.
# ---------------------------------------------------------------------------

# Published baseline numbers the reference compares against (these are the
# task-defining constants from its figure; visualize.py models dict).
HISUM_PUBLISHED_BASELINES = {
    "PGL-SUM": {"mAP@50": 61.6, "mAP@15": 27.45, "f1": 55.89},
    "VASNet": {"mAP@50": 58.69, "mAP@15": 25.28, "f1": 55.26},
    "SL-module": {"mAP@50": 58.63, "mAP@15": 24.95, "f1": 55.31},
    "DSNet": {"mAP@50": 57.32, "mAP@15": 24.35, "f1": 50.78},
}


def sota_comparison_plot(
    ours: dict,
    baselines: dict,
    metrics: tuple[str, ...],
    out_path: str,
    *,
    title: str = "results",
    ours_label: str = "Ours",
) -> str:
    """Grouped bar chart: our metrics next to published baselines."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = {ours_label: ours, **baselines}
    x = np.arange(len(metrics))
    width = 0.8 / max(len(models), 1)
    fig, ax = plt.subplots(layout="constrained")
    for i, (name, vals) in enumerate(models.items()):
        bar_vals = [float(vals.get(m, float("nan"))) for m in metrics]
        rects = ax.bar(x + width * i, bar_vals, width, label=name)
        ax.bar_label(rects, padding=3, fmt="%.1f", fontsize=7)
    ax.set_ylabel("metric")
    ax.set_title(title)
    ax.set_xticks(x + width * (len(models) - 1) / 2, metrics)
    ax.legend(loc="upper left", ncols=3, fontsize=8)
    ax.set_ylim(0, 100)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def hisum_sota_figure(
    pred_file: str,
    gold_h5: str,
    params: dict,
    out_path: str,
    *,
    baselines: dict | None = None,
) -> dict:
    """Compute our HiSum metrics from a driver pred file and plot them
    against the published baselines (ref visualize.py:100-133). Returns the
    computed metrics (percent)."""
    import h5py

    from ..eval import hisum

    with open(pred_file) as f:
        preds = json.load(f)
    gt_dict, pred_dict, categories = {}, {}, {}
    with h5py.File(gold_h5, "r") as hdf:
        for p in preds:
            if not p.get("debug_data"):
                continue
            tr = traces_from_debug_data(p["debug_data"])
            scores = combined_score(
                tr["informative"], tr["relevance"], tr["uncertainty"],
                params["alpha"], params["beta"], params["epsilon"],
                params["uncertainty_threshold"])
            gt = np.asarray(hdf[p["h5_identifier"]]["gtscore"])
            n = min(len(scores), len(gt))
            if n < 2:
                continue
            # ref alignment: debug_data[i] <-> gtscore[i-1]
            gt_dict[p["video_uuid"]] = gt[: n - 1]
            pred_dict[p["video_uuid"]] = scores[1:n]
            for c in p.get("categories", []):
                categories.setdefault(c, []).append(p["video_uuid"])
    res = hisum.evaluate_scores(gt_dict, pred_dict)
    ours = {k: round(float(res[k]) * 100, 2) for k in ("mAP@50", "mAP@15", "f1")}
    sota_comparison_plot(
        ours, baselines if baselines is not None else HISUM_PUBLISHED_BASELINES,
        ("mAP@50", "mAP@15", "f1"), out_path, title="Mr.HiSum results")
    # per-category breakdown alongside (ref category_scores aggregation)
    if categories:
        per_cat = {}
        for cat, vids in sorted(categories.items()):
            sub_gt = {v: gt_dict[v] for v in vids if v in gt_dict}
            sub_pred = {v: pred_dict[v] for v in vids if v in pred_dict}
            if sub_gt:
                r = hisum.evaluate_scores(sub_gt, sub_pred)
                per_cat[cat] = round(float(r["mAP@50"]) * 100, 2)
        ours["per_category_mAP@50"] = per_cat
    return ours


def tvsum_sota_figure(
    metrics_ours: dict,
    out_path: str,
    *,
    baselines: dict | None = None,
    metrics: tuple[str, ...] = ("mAP@50", "mAP@15", "top5_mAP"),
) -> str:
    """TVSum comparison panel from already-computed metrics (cli evaluate
    --func tvsum output); callers pass published baselines for the setting
    they compare against (prompt-ablation tables etc.).

    Fractions are rescaled to percent once PER DICT (evaluate emits all
    metrics in [0, 1]; a per-value heuristic would mis-scale a legitimately
    small percentage next to unscaled ones)."""
    vals = {k: float(metrics_ours[k]) for k in metrics if k in metrics_ours}
    scale = 100.0 if vals and max(vals.values()) <= 1.0 else 1.0
    ours = {k: round(v * scale, 2) for k, v in vals.items()}
    return sota_comparison_plot(ours, baselines or {}, tuple(ours.keys()),
                                out_path, title="TVSum results")
