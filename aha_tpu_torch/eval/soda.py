"""Dense-video-captioning evaluation: detection precision / recall / F1,
IoU-matched caption scores and SODA_c; the port's copy of
``aha_tpu/eval/soda.py`` (the reference's eval_dvc), with the pure-Python
CIDEr and METEOR of ``captioning``.
"""

from __future__ import annotations

import collections
import json
import os
import random
import re
import string

import numpy as np

from .captioning import Cider, PTBTokenizer, build_meteor, find_java_meteor


def random_string(n: int) -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(n))


def iou(interval_1, interval_2) -> float:
    """SODA's IoU: the union capped at the sum of the lengths."""
    s1, e1 = float(min(*interval_1)), float(max(*interval_1))
    s2, e2 = float(min(*interval_2)), float(max(*interval_2))
    inter = max(0.0, min(e1, e2) - max(s1, s2))
    union = min(max(e1, e2) - min(s1, s2), (e1 - s1) + (e2 - s2))
    return inter / (union + 1e-8)


def chased_dp_assignment(scores: np.ndarray) -> tuple[float, list[tuple[int, int]]]:
    """Monotonic one-to-one assignment DP (SODA). Iterative (the reference
    recursion overflows Python's stack on hour-long videos)."""
    m, n = scores.shape
    dp = np.full((m, n), -1.0)
    path = np.zeros((m, n), np.int64)
    for i in range(m):
        for j in range(n):
            if i == 0 and j == 0:
                state = [-1.0, -1.0, scores[i, j]]
            elif i == 0:
                state = [-1.0, dp[i, j - 1], scores[i, j]]
            elif j == 0:
                state = [dp[i - 1, j], -1.0, scores[i, j]]
            else:
                state = [dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1] + scores[i, j]]
            k = int(np.argmax(state))
            dp[i, j] = state[k]
            path[i, j] = k

    def get_pairs(i, j):
        pairs = []
        while True:
            p = np.where(path[i][: j + 1] == 2)[0]
            if i != 0 and len(p) == 0:
                i -= 1
                continue
            if i == 0 or (len(p) and p[-1] == 0):
                pairs.append((i, int(p[-1])))
                break
            pairs.append((i, int(p[-1])))
            i, j = i - 1, int(p[-1]) - 1
        return list(reversed(pairs))

    return float(dp[m - 1, n - 1]), get_pairs(m - 1, n - 1)


def evaluate_detections(predicted_segments, gt_segments, splits,
                        iou_thresholds=(0.3, 0.5, 0.7, 0.9)):
    """Best-over-splits mean P/R per IoU threshold + per-split IoU matrices."""
    best_recall, best_precision = [], []
    iou_matrices = {}
    P = predicted_segments.shape[0]
    for split in set(splits):
        covered = {t: {"pred": set(), "gt": set()} for t in iou_thresholds}
        idx = np.where(splits == split)[0]
        split_gt = np.asarray([gt_segments[i] for i in idx])
        G = split_gt.shape[0]
        iou_matrix = np.zeros((G, max(P, 1)))
        for g, gt_seg in enumerate(split_gt):
            for p, seg in enumerate(predicted_segments):
                s = iou(seg, gt_seg)
                iou_matrix[g, p] = s
                for t in iou_thresholds:
                    if s > t:
                        covered[t]["pred"].add(p)
                        covered[t]["gt"].add(g)
        precision = [len(covered[t]["pred"]) / max(float(P), 1.0) for t in iou_thresholds]
        recall = [len(covered[t]["gt"]) / float(G) for t in iou_thresholds]
        if best_precision:
            best_precision = [max(a, b) for a, b in zip(precision, best_precision)]
            best_recall = [max(a, b) for a, b in zip(recall, best_recall)]
        else:
            best_precision, best_recall = precision, recall
        iou_matrices[int(split)] = iou_matrix
    return best_precision, best_recall, iou_matrices


def match_captions(predicted_segments, gt_segments, predicted_captions, gt_captions,
                   iou_thresholds=(0.3, 0.5, 0.7, 0.9), rng=None):
    """Pair predictions with every GT they overlap at each threshold;
    unmatched predictions get a random-string GT (zero score)."""
    rng = rng or random
    gts = {str(t): {} for t in iou_thresholds}
    preds = {str(t): {} for t in iou_thresholds}
    isxes = {str(t): [] for t in iou_thresholds}
    isx = 0
    for p, seg in enumerate(predicted_segments):
        pc = predicted_captions[p]
        added = {str(t): False for t in iou_thresholds}
        for g, gt_seg in enumerate(gt_segments):
            s = iou(seg, gt_seg)
            for t in iou_thresholds:
                if s >= t:
                    key = str(isx)
                    isxes[str(t)].append(isx)
                    isx += 1
                    gts[str(t)][key] = [{"caption": gt_captions[g]}]
                    preds[str(t)][key] = [{"caption": pc}]
                    added[str(t)] = True
        for t in iou_thresholds:
            if not added[str(t)]:
                key = str(isx)
                isxes[str(t)].append(isx)
                isx += 1
                gts[str(t)][key] = [{"caption": random_string(rng.randint(10, 20))}]
                preds[str(t)][key] = [{"caption": pc}]
    return gts, preds, isxes


def evaluate_caption_scores(gts_filtered, preds_filtered,
                            iou_thresholds=(0.3, 0.5, 0.7, 0.9), scorers=None):
    scorers = scorers or {}
    metrics = collections.defaultdict(list)
    for name, scorer in scorers.items():
        for t in iou_thresholds:
            if not gts_filtered[str(t)] or not preds_filtered[str(t)]:
                metrics[name].append(0.0)
            else:
                score = scorer.compute_score(gts_filtered[str(t)], preds_filtered[str(t)])
                metrics[name].append(float(np.nan_to_num(score[0])))
    return {k: float(np.mean(v)) for k, v in metrics.items()}


def sodac(iou_matrices, scorer, predicted_captions, gt_captions, splits,
          iou_thresholds=(0.0,)):
    """SODA_c F-score via DP assignment over IoU-gated caption scores."""
    if not predicted_captions:
        return {int(s): 0 for s in splits}
    res = {str(i): [p] for i, p in enumerate(predicted_captions)}
    fs = {int(s): [0.0] * len(iou_thresholds) for s in set(splits)}
    for split in set(splits):
        idx = np.where(splits == split)[0]
        split_gt = [gt_captions[i] for i in idx]
        gts = [{k: [x] for k in res} for x in split_gt]
        iou_matrix = iou_matrices[int(split)]
        score_matrix = np.asarray(
            [np.nan_to_num(scorer.compute_score(res, gt)[1]) for gt in gts])
        for i, t in enumerate(iou_thresholds):
            cur = np.copy(iou_matrix)
            cur[cur < t] = 0.0
            max_score, _ = chased_dp_assignment(cur * score_matrix)
            n_g, n_p = cur.shape
            p = max_score / n_p
            r = max_score / n_g
            fs[int(split)][i] = 2 * p * r / (p + r) if p + r > 0 else 0
    return {int(s): float(np.mean(v)) for s, v in fs.items()}


def parse_sent(sent: str) -> list[str]:
    return re.sub("[^a-zA-Z]", " ", sent).strip().lower().split()


def evaluate_dense_captions(predicted_segments, gt_segments, predicted_captions,
                            gt_captions, splits, keys,
                            iou_thresholds=(0.3, 0.5, 0.7, 0.9), soda=True):
    """Detection and caption metrics aggregated over a corpus."""
    scorers = {"CIDER": Cider(), "METEOR": build_meteor()}
    tokenizer = PTBTokenizer()
    gts = {str(t): {} for t in iou_thresholds}
    preds = {str(t): {} for t in iou_thresholds}
    det_precisions, det_recalls = [], []
    soda_scores = []

    assert len(predicted_segments) == len(gt_segments) == len(predicted_captions) \
        == len(gt_captions) == len(splits) == len(keys)

    for pred_seg, gt_seg, pred_cap, gt_cap, split, key in zip(
            predicted_segments, gt_segments, predicted_captions, gt_captions,
            splits, keys):
        gt_f, pred_f, _ = match_captions(pred_seg, gt_seg, pred_cap, gt_cap,
                                         iou_thresholds)
        for t in iou_thresholds:
            for k, v in gt_f[str(t)].items():
                gts[str(t)][f"{key}_{k}"] = v
            for k, v in pred_f[str(t)].items():
                preds[str(t)][f"{key}_{k}"] = v
        precision, recall, iou_matrices = evaluate_detections(pred_seg, gt_seg, split,
                                                              iou_thresholds)
        det_precisions.append(precision)
        det_recalls.append(recall)
        if soda:
            s = sodac(iou_matrices, scorers["METEOR"], list(pred_cap), list(gt_cap),
                      split, (0.0,))
            soda_scores.append(float(np.mean(list(s.values()))))

    # tokenize then score captions
    gts_tok = {t: tokenizer.tokenize(v) for t, v in gts.items()}
    preds_tok = {t: tokenizer.tokenize(v) for t, v in preds.items()}
    gts_fmt = {t: {k: vv for k, vv in v.items()} for t, v in gts_tok.items()}
    preds_fmt = {t: {k: vv for k, vv in v.items()} for t, v in preds_tok.items()}
    metrics = evaluate_caption_scores(gts_fmt, preds_fmt, iou_thresholds, scorers)

    mean_p = float(np.mean([np.mean(p) for p in det_precisions]))
    mean_r = float(np.mean([np.mean(r) for r in det_recalls]))
    per_thr_p = np.mean(np.asarray(det_precisions), axis=0)
    per_thr_r = np.mean(np.asarray(det_recalls), axis=0)
    for j, t in enumerate(iou_thresholds):
        metrics[f"Precision@{t}"] = float(per_thr_p[j])
        metrics[f"Recall@{t}"] = float(per_thr_r[j])
    metrics["Precision_Mean"] = mean_p
    metrics["Recall_Mean"] = mean_r
    metrics["F1_Score"] = (2 * mean_r * mean_p / (mean_r + mean_p)
                           if (mean_r + mean_p) > 0 else 0)
    if soda:
        metrics["SODA_c"] = float(np.mean(soda_scores)) if soda_scores else 0.0
    metrics["n_preds"] = int(np.mean([len(p) for p in predicted_captions])) \
        if predicted_captions else 0
    return metrics


def evaluate_para(predicted_captions, gt_captions) -> dict:
    """Paragraph-level corpus CIDEr and METEOR."""
    scorers = {"CIDER": Cider(), "METEOR": build_meteor()}
    all_gts, all_preds = {}, {}
    for i, (pred, gts) in enumerate(zip(predicted_captions, gt_captions)):
        all_preds[str(i)] = [" ".join(parse_sent(pred))]
        all_gts[str(i)] = [" ".join(parse_sent(g)) for g in gts]
    out = {}
    for name, scorer in scorers.items():
        score = scorer.compute_score(all_gts, all_preds)
        out["Para_" + name] = float(np.nan_to_num(score[0]))
    return out


def eval_with_files(pred_file: str, gt_file: str) -> dict:
    """YouCook2-style evaluation from files.

    pred_file: {qid: [{'timestamp': [s, e], 'caption': str}, ...]}
    gt_file:   {"annotations": [{'image_id', 'segments', 'pure_cap'}]}
    """
    with open(pred_file) as f:
        pred_data = json.load(f)
    with open(gt_file) as f:
        gt_data = json.load(f)["annotations"]

    predicted_segments, predicted_captions, predicted_paras = [], [], []
    gt_segments, gt_captions, gt_paras, splits, keys = [], [], [], [], []
    for jterm in gt_data:
        key = jterm["image_id"].split("/")[-1]
        if "pure_cap" in jterm:  # youcook2
            caps = jterm["pure_cap"].split(". ")
        else:  # activitynet
            caps = [c.strip(" ") for c in jterm["caption"].split(".") if len(c) > 5]
        assert len(jterm["segments"]) == len(caps), (key, len(jterm["segments"]), len(caps))
        caps = [c + "." for c in caps]
        keys.append(key)
        gt_segments.append(np.asarray(jterm["segments"], float))
        gt_captions.append(np.asarray(caps))
        gt_paras.append(" ".join(caps))
        splits.append(np.ones(len(caps), np.int64))

        pred = pred_data.get(key, [])
        predicted_segments.append(
            np.asarray([p["timestamp"] for p in pred], float).reshape(-1, 2))
        predicted_captions.append([p["caption"] for p in pred])
        predicted_paras.append(" ".join(p["caption"] or "" for p in pred))

    metrics = evaluate_dense_captions(
        predicted_segments, gt_segments, predicted_captions, gt_captions,
        splits, keys, soda=True)
    metrics.update(evaluate_para(predicted_paras, [[g] for g in gt_paras]))
    # which METEOR backend ran: the jar's numbers are comparable to published ones,
    # METEOR-lite's (exact + stem matches, no synonyms or paraphrases) are not
    if os.environ.get("AHA_METEOR", "auto").lower() != "lite" and find_java_meteor() is not None:
        metrics["METEOR_note"] = "Java meteor-1.5.jar backend (paper-comparable)"
    else:
        metrics["METEOR_note"] = (
            "METEOR-lite (exact+stem matcher, no WordNet synonyms/"
            "paraphrases); not comparable to Java meteor-1.5.jar scores. "
            "Set AHA_METEOR_JAR + a JRE for the jar backend."
        )
    return metrics
