"""QVHighlights moment-retrieval and highlight-detection metrics: the port's
copy of ``aha_tpu/eval/qvh.py`` (the Moment-DETR metrics).

Detection mAP@[.5:.95] with greedy ground-truth locking and the VOC-2011
interpolated precision-recall curve, R@1 against the best-IoU gold window,
length-range breakdowns, and saliency HL hit@1 / mAP over 3 annotators at
the Fair / Good / VeryGood thresholds; ``submission_from_debug_data`` turns
per-frame score traces into a submission.
"""

from __future__ import annotations

import copy
from collections import OrderedDict, defaultdict

import numpy as np

from .scoring import combined_score, traces_from_debug_data


def temporal_iou_paired(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """[N,2] vs [N,2] -> [N] IoU."""
    inter = np.clip(np.minimum(pred[:, 1], gt[:, 1]) - np.maximum(pred[:, 0], gt[:, 0]), 0, None)
    union = np.maximum(pred[:, 1], gt[:, 1]) - np.minimum(pred[:, 0], gt[:, 0])
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def temporal_iou_cross(spans1: np.ndarray, spans2: np.ndarray) -> np.ndarray:
    """[N,2] x [M,2] -> [N,M] IoU."""
    s1, e1 = spans1[:, 0][:, None], spans1[:, 1][:, None]
    s2, e2 = spans2[:, 0][None, :], spans2[:, 1][None, :]
    inter = np.clip(np.minimum(e1, e2) - np.maximum(s1, s2), 0, None)
    union = np.maximum(e1, e2) - np.minimum(s1, s2)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def interpolated_precision_recall(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC-2011 interpolated AP."""
    mprec = np.hstack([[0], precision, [0]])
    mrec = np.hstack([[0], recall, [1]])
    for i in range(len(mprec) - 2, -1, -1):
        mprec[i] = max(mprec[i], mprec[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx]))


def average_precision_detection(
    ground_truth: list[dict], prediction: list[dict],
    tiou_thresholds=np.linspace(0.5, 0.95, 10),
) -> np.ndarray:
    """ActivityNet-style detection AP with greedy per-threshold GT locking."""
    T, G, P = len(tiou_thresholds), len(ground_truth), len(prediction)
    ap = np.zeros(T)
    if P == 0:
        return ap
    lock = -np.ones((T, G))
    prediction = sorted(prediction, key=lambda x: -x["score"])
    tp = np.zeros((T, P))
    fp = np.zeros((T, P))

    by_vid: dict = {}
    for i, item in enumerate(ground_truth):
        item = dict(item, index=i)
        by_vid.setdefault(item["video-id"], []).append(item)

    for idx, pred in enumerate(prediction):
        gts = by_vid.get(pred["video-id"])
        if not gts:
            fp[:, idx] = 1
            continue
        pw = np.asarray([[pred["t-start"], pred["t-end"]]], float)
        gw = np.asarray([[g["t-start"], g["t-end"]] for g in gts], float)
        tiou = temporal_iou_cross(pw, gw)[0]
        order = tiou.argsort()[::-1]
        for t_idx, thr in enumerate(tiou_thresholds):
            for j in order:
                if tiou[j] < thr:
                    fp[t_idx, idx] = 1
                    break
                if lock[t_idx, gts[j]["index"]] >= 0:
                    continue
                tp[t_idx, idx] = 1
                lock[t_idx, gts[j]["index"]] = idx
                break
            if fp[t_idx, idx] == 0 and tp[t_idx, idx] == 0:
                fp[t_idx, idx] = 1

    tp_c = np.cumsum(tp, axis=1)
    fp_c = np.cumsum(fp, axis=1)
    recall = tp_c / max(float(G), 1.0)
    precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
    for t_idx in range(T):
        ap[t_idx] = interpolated_precision_recall(precision[t_idx], recall[t_idx])
    return ap


def compute_mr_ap(submission, ground_truth, iou_thds=np.linspace(0.5, 0.95, 10),
                  max_gt_windows=None, max_pred_windows=10) -> dict:
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_by_qid = defaultdict(list)
    for d in submission:
        windows = d["pred_relevant_windows"]
        if max_pred_windows is not None:
            windows = windows[:max_pred_windows]
        for w in windows:
            pred_by_qid[d["qid"]].append(
                {"video-id": d["qid"], "t-start": w[0], "t-end": w[1], "score": w[2]})
    gt_by_qid = defaultdict(list)
    for d in ground_truth:
        windows = d["relevant_windows"]
        if max_gt_windows is not None:
            windows = windows[:max_gt_windows]
        for w in windows:
            gt_by_qid[d["qid"]].append({"video-id": d["qid"], "t-start": w[0], "t-end": w[1]})

    ap_rows = [
        average_precision_detection(gt_by_qid[qid], preds, np.asarray(iou_thds))
        for qid, preds in pred_by_qid.items()
    ]
    ap_thds = np.asarray(ap_rows).mean(0)
    out = dict(zip([str(e) for e in iou_thds], ap_thds))
    out["average"] = float(np.mean(ap_thds))
    return {k: float(f"{100 * v:.2f}") for k, v in out.items()}


def compute_mr_r1(submission, ground_truth, iou_thds=np.linspace(0.5, 0.95, 10)) -> dict:
    iou_thds = [float(f"{e:.2f}") for e in iou_thds]
    pred_window = {d["qid"]: d["pred_relevant_windows"][0][:2] for d in submission}
    gt_window = {}
    for d in ground_truth:
        qid = d["qid"]
        windows = d["relevant_windows"]
        best = 0
        if windows:
            ious = temporal_iou_cross(
                np.asarray([pred_window[qid]], float), np.asarray(windows, float))[0]
            best = int(np.argmax(ious))
        gt_window[qid] = windows[best]
    qids = list(pred_window)
    ious = temporal_iou_paired(
        np.asarray([pred_window[q] for q in qids], float),
        np.asarray([gt_window[q] for q in qids], float),
    )
    return {str(t): float(f"{np.mean(ious >= t) * 100:.2f}") for t in iou_thds}


def get_data_by_range(submission, ground_truth, len_range):
    min_l, max_l = len_range
    if min_l == 0 and max_l == 150:
        return submission, ground_truth
    gt_in, qids = [], set()
    for d in ground_truth:
        windows = [w for w in d["relevant_windows"] if min_l < (w[1] - w[0]) <= max_l]
        if windows:
            d = copy.deepcopy(d)
            d["relevant_windows"] = windows
            gt_in.append(d)
            qids.add(d["qid"])
    sub_in = [copy.deepcopy(d) for d in submission if d["qid"] in qids]
    return sub_in, gt_in


def eval_moment_retrieval(submission, ground_truth) -> dict:
    ranges = {"short": [0, 10], "middle": [10, 30], "long": [30, 150], "full": [0, 150]}
    out = {}
    for name, r in ranges.items():
        sub, gt = get_data_by_range(submission, ground_truth, r)
        if not sub:
            out[name] = {"MR-mAP": {}, "MR-R1": {}}
            continue
        out[name] = {"MR-mAP": compute_mr_ap(sub, gt), "MR-R1": compute_mr_r1(sub, gt)}
    return out


# ---------------------------------------------------------------------------
# Highlight detection
# ---------------------------------------------------------------------------


def get_ap(y_true: np.ndarray, y_predict: np.ndarray, interpolate: bool = True) -> float:
    """video2gif-style AP with forward precision interpolation."""
    y_true = np.asarray(y_true)
    y_predict = np.asarray(y_predict)
    if len(set(y_true.tolist())) == 1:
        return 0.0 if y_true[0] == 0 else 1.0
    order = np.argsort(-y_predict, kind="stable")
    rel = y_true[order]
    tp = np.cumsum(rel)
    precision = tp / np.arange(1, len(rel) + 1)
    recall = tp / rel.sum()
    # sklearn's precision_recall_curve walks thresholds high->low; the
    # reference interpolates precision forward over that walk
    if interpolate:
        for i in range(1, len(precision)):
            precision[i] = max(precision[i - 1], precision[i])
    idx = np.where(np.diff(np.concatenate([[0.0], recall])))[0]
    return float(np.mean(precision[idx]))


def mk_gt_scores(gt_data: dict, clip_length: int = 2) -> np.ndarray:
    num_clips = int(gt_data["duration"] / clip_length)
    full = np.zeros((num_clips, 3))
    ids = np.asarray(gt_data["relevant_clip_ids"])
    full[ids] = np.asarray(gt_data["saliency_scores"])
    return full


def compute_hl_hit1(qid2preds, qid2gt_binary) -> float:
    hits = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        clip = int(np.argmax(pred["pred_saliency_scores"]))
        gt = qid2gt_binary[qid]
        if clip < len(gt):
            hits[idx] = gt[clip]
    return float(f"{100 * np.mean(np.max(hits, 1)):.2f}")


def compute_hl_ap(qid2preds, qid2gt_binary) -> float:
    aps = np.zeros((len(qid2preds), 3))
    for idx, (qid, pred) in enumerate(qid2preds.items()):
        scores = np.asarray(pred["pred_saliency_scores"], float)
        for w in range(3):
            y_true = qid2gt_binary[qid][:, w]
            y_pred = scores
            if len(y_true) < len(y_pred):
                y_pred = y_pred[: len(y_true)]
            elif len(y_true) > len(y_pred):
                y_pred = np.concatenate([y_pred, np.zeros(len(y_true) - len(y_pred))])
            aps[idx, w] = get_ap(y_true, y_pred)
    return float(f"{100 * np.mean(aps):.2f}")


def eval_highlight(submission, ground_truth) -> dict:
    qid2preds = {d["qid"]: d for d in submission}
    qid2gt = {d["qid"]: mk_gt_scores(d) for d in ground_truth}
    out = {}
    for min_score, name in zip((2, 3, 4), ("Fair", "Good", "VeryGood")):
        binary = {k: (v >= min_score).astype(float) for k, v in qid2gt.items()}
        out[f"HL-min-{name}"] = {
            "HL-mAP": compute_hl_ap(qid2preds, binary),
            "HL-Hit1": compute_hl_hit1(qid2preds, binary),
        }
    return out


def find_continuous_positive_segments(relevance_scores, min_relevance_frames: int):
    """Runs of positive scores at least min_relevance_frames long ->
    (start_idx, end_idx, mean_score)."""
    scores = np.asarray(relevance_scores, np.float64)
    segments = []
    start = None
    for i in range(len(scores)):
        if scores[i] > 0:
            if start is None:
                start = i
        else:
            if start is not None and i - start >= min_relevance_frames:
                segments.append((start, i - 1, float(scores[start:i].mean())))
            start = None
    if start is not None and len(scores) - start >= min_relevance_frames:
        segments.append((start, len(scores) - 1, float(scores[start:].mean())))
    return segments


def submission_from_debug_data(
    pred_examples: list[dict],
    *,
    alpha: float, beta: float, epsilon: float, uncertainty_threshold: float,
    relevance_threshold: float = 0.1,
    min_relevance_frames: int = 5,
) -> list[dict]:
    """Build a QVHighlights submission from per-frame score traces: combined
    scores above `relevance_threshold` become positive, continuous positive
    runs become pred_relevant_windows (scored by their mean), and the raw
    per-2s-clip combined score becomes pred_saliency_scores."""
    out = []
    for ex in pred_examples:
        tr = traces_from_debug_data(ex["debug_data"])
        s = combined_score(tr["informative"], tr["relevance"], tr["uncertainty"],
                           alpha, beta, epsilon, uncertainty_threshold)
        times = tr["time"]
        positive = np.where(s >= relevance_threshold, s, 0.0)
        windows = []
        for start, end, mean_score in find_continuous_positive_segments(
                positive, min_relevance_frames):
            windows.append([float(times[start]), float(times[end]), mean_score])
        windows.sort(key=lambda w: -w[2])
        if not windows:  # submission format requires at least one window
            windows = [[0.0, float(times[-1]) if len(times) else 0.0, 0.0]]
        # saliency per 2-second clip: mean combined score within each clip
        duration = float(times[-1]) + 1e-9 if len(times) else 0.0
        n_clips = max(int(duration / 2), 1)
        saliency = []
        for c in range(n_clips):
            in_clip = (times >= 2 * c) & (times < 2 * (c + 1))
            saliency.append(float(s[in_clip].mean()) if in_clip.any() else 0.0)
        out.append({
            "qid": ex["question_id"],
            "pred_relevant_windows": windows,
            "pred_saliency_scores": saliency,
        })
    return out


def eval_submission(submission, ground_truth, match_number: bool = True) -> OrderedDict:
    pred_qids = {e["qid"] for e in submission}
    gt_qids = {e["qid"] for e in ground_truth}
    if match_number:
        assert pred_qids == gt_qids, "qids in ground_truth and submission must match"
    else:
        shared = pred_qids & gt_qids
        submission = [e for e in submission if e["qid"] in shared]
        ground_truth = [e for e in ground_truth if e["qid"] in shared]

    metrics = {}
    brief = OrderedDict()
    if "pred_relevant_windows" in submission[0]:
        mr = eval_moment_retrieval(submission, ground_truth)
        metrics.update(mr)
        brief.update(sorted({
            "MR-full-mAP": mr["full"]["MR-mAP"].get("average"),
            "MR-full-mAP@0.5": mr["full"]["MR-mAP"].get("0.5"),
            "MR-full-mAP@0.75": mr["full"]["MR-mAP"].get("0.75"),
            "MR-short-mAP": mr["short"]["MR-mAP"].get("average"),
            "MR-middle-mAP": mr["middle"]["MR-mAP"].get("average"),
            "MR-long-mAP": mr["long"]["MR-mAP"].get("average"),
            "MR-full-R1@0.5": mr["full"]["MR-R1"].get("0.5"),
            "MR-full-R1@0.7": mr["full"]["MR-R1"].get("0.7"),
        }.items()))
    if "pred_saliency_scores" in submission[0]:
        hl = eval_highlight(submission, ground_truth)
        metrics.update(hl)
        brief.update({f"{k}-{sk.split('-')[1]}": v[sk] for k, v in hl.items() for sk in v})

    final = OrderedDict()
    final["brief"] = brief
    final.update(sorted(metrics.items()))
    return final
