"""``aha grid-search``, ``aha evaluate`` and ``aha highlight`` on the port: the
calibration, metric and reel commands (``aha_tpu/cli/evaluate.py:17-220``),
on the prediction files of ``infer``. Numpy on the host: nothing here runs
on the card. ``evaluate --func magqa`` with a judge checkpoint and
``visualize`` are not ported (ROADMAP.md, Queue 1 item 11)."""

from __future__ import annotations

import argparse
import json

import numpy as np

from ._session import _resolve_params_file


def _read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _charades_golds(path: str) -> dict:
    """Gold examples by question id; QVHighlights saliency golds are turned
    into charades-style timestamps first."""
    from ..eval.scoring import qvh_to_charades_format

    with open(path) as f:
        golds = json.load(f)
    if golds and "answer" in golds[0] and "saliency_scores" in golds[0].get("answer", {}):
        golds = [qvh_to_charades_format(g) for g in golds]
    return {g["question_id"]: g for g in golds}


def _write(out, output_file: str | None):
    print(json.dumps(out, indent=2, default=float))
    if output_file:
        with open(output_file, "w") as f:
            json.dump(out, f, indent=2, default=float)


def cmd_grid_search(argv):
    from ..eval import grid_search as gs
    from ..eval.tvsum import load_annotations

    p = argparse.ArgumentParser(prog="aha grid-search")
    p.add_argument("--test_dataset", required=True,
                   choices=["tvsum", "tvsum_degraded", "hisum", "charades"])
    p.add_argument("--pred_file", required=True)
    p.add_argument("--gold_file", required=True)
    p.add_argument("--save_path", default="outputs/grid_search_params.json")
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)

    if args.test_dataset in ("tvsum", "tvsum_degraded"):
        with open(args.pred_file) as f:
            predictions = json.load(f)
        best = gs.run_grid_search(args.test_dataset, predictions,
                                  ground_truths=load_annotations(args.gold_file),
                                  save_path=args.save_path, seed=args.seed)
    elif args.test_dataset == "hisum":
        import h5py

        with open(args.pred_file) as f:
            predictions = json.load(f)
        with h5py.File(args.gold_file, "r") as hdf:
            gtscores = {p_["h5_identifier"]: np.asarray(hdf[p_["h5_identifier"]]["gtscore"])
                        for p_ in predictions}
        best = gs.run_grid_search("hisum", predictions, gtscores=gtscores,
                                  save_path=args.save_path)
    else:
        best = gs.run_grid_search("charades", _read_jsonl(args.pred_file),
                                  ground_truths=_charades_golds(args.gold_file),
                                  save_path=args.save_path)
    print("Best parameters found:")
    print(best)


def cmd_evaluate(argv):
    from ..eval import grounding, hisum, tvsum
    from ..eval.scoring import combined_score, traces_from_debug_data

    p = argparse.ArgumentParser(prog="aha evaluate")
    p.add_argument("--func", required=True,
                   choices=["tvsum", "hisum", "grounding", "magqa", "qvh", "dense_captioning"])
    p.add_argument("--pred_file", required=True)
    p.add_argument("--gold_file", required=True)
    p.add_argument("--params_file", default="outputs/grid_search_params.json")
    p.add_argument("--params_key", default=None)
    p.add_argument("--output_file", default=None)
    p.add_argument("--judge_ckpt", default=None, help="magqa: converted judge dir")
    p.add_argument("--relevance_threshold", type=float, default=0.1)
    p.add_argument("--min_relevance_frames", type=int, default=5)
    args = p.parse_args(argv)

    if args.func == "magqa":
        if not args.judge_ckpt:
            print("magqa needs --judge_ckpt (a converted Qwen2-style judge), or use "
                  "llm_judge.to_openai_batch_input for the remote-judge path")
            return
        raise NotImplementedError("evaluate --func magqa --judge_ckpt (the local LLM judge) "
                                  "is not ported to aha_tpu_torch yet (ROADMAP.md, Queue 1 "
                                  "item 11)")
    if args.func == "dense_captioning":
        from ..eval.soda import eval_with_files

        _write(eval_with_files(args.pred_file, args.gold_file), args.output_file)
        return

    key = args.params_key or {"tvsum": "tvsum", "hisum": "hisum", "grounding": "charades",
                              "qvh": "charades"}[args.func]
    with open(_resolve_params_file(args.params_file)) as f:
        bp = json.load(f)[key]
    a, b, e, t = bp["alpha"], bp["beta"], bp["epsilon"], bp["uncertainty_threshold"]

    def scores_of(pred):
        tr = traces_from_debug_data(pred["debug_data"])
        return combined_score(tr["informative"], tr["relevance"], tr["uncertainty"], a, b, e, t)

    if args.func == "qvh":
        from ..eval import qvh

        preds = _read_jsonl(args.pred_file)
        if args.gold_file.endswith("l"):
            golds = _read_jsonl(args.gold_file)
        else:
            with open(args.gold_file) as f:
                golds = json.load(f)
        submission = qvh.submission_from_debug_data(
            preds, alpha=a, beta=b, epsilon=e, uncertainty_threshold=t,
            relevance_threshold=args.relevance_threshold,
            min_relevance_frames=args.min_relevance_frames)
        out = qvh.eval_submission(submission, golds, match_number=False)
    elif args.func == "tvsum":
        with open(args.pred_file) as f:
            preds = json.load(f)
        annos = tvsum.load_annotations(args.gold_file)
        gt_dict, pred_dict = {}, {}
        for p_ in preds:
            vid = p_["video_uuid"]
            scores = scores_of(p_)
            true_frames = p_["true_frames_list"][: len(scores)]
            gt_dict[vid] = np.asarray(annos[vid]["importance_scores"])[
                np.asarray(true_frames, np.int64)]
            pred_dict[vid] = scores
        out = {"overall": tvsum.evaluate_tvsum(gt_dict, pred_dict),
               "per_category": tvsum.evaluate_tvsum_per_category(gt_dict, pred_dict, annos)}
    elif args.func == "hisum":
        import h5py

        with open(args.pred_file) as f:
            preds = json.load(f)
        gt_dict, pred_dict = {}, {}
        with h5py.File(args.gold_file, "r") as hdf:
            for p_ in preds:
                scores = scores_of(p_)
                gt = np.asarray(hdf[p_["h5_identifier"]]["gtscore"])
                n = min(len(scores), len(gt))
                # debug_data[i] is scored against gtscore[i - 1], as the reference aligns them
                gt_dict[p_["video_uuid"]] = gt[: n - 1]
                pred_dict[p_["video_uuid"]] = scores[1:n]
        out = hisum.evaluate_scores(gt_dict, pred_dict, spearman_kendall=True)
    else:  # grounding
        out = grounding.evaluate_grounding(_read_jsonl(args.pred_file),
                                           _charades_golds(args.gold_file), a, b, e, t)
    _write(out, args.output_file)


def cmd_highlight(argv):
    from ..eval import highlight

    p = argparse.ArgumentParser(prog="aha highlight")
    p.add_argument("--pred_file", required=True, help="driver output JSON (tvsum format)")
    p.add_argument("--video_uuid", required=True)
    p.add_argument("--video_path", required=True)
    p.add_argument("--output_filepath", default="highlight_video.mp4")
    p.add_argument("--max_duration", type=int, required=True)
    p.add_argument("--params_file", default="outputs/grid_search_params.json")
    p.add_argument("--source_fps", type=float, required=True)
    args = p.parse_args(argv)

    with open(args.pred_file) as f:
        preds = json.load(f)
    pred = next(p_ for p_ in preds if p_["video_uuid"] == args.video_uuid)
    a, b, e = highlight.load_calibrated_params(_resolve_params_file(args.params_file))
    result = highlight.generate_highlight(
        pred["debug_data"], pred["true_frames_list"], args.max_duration, alpha=a, beta=b,
        epsilon=e, source_fps=args.source_fps, video_path=args.video_path,
        output_path=args.output_filepath)
    print(json.dumps({k: v for k, v in result.items() if k != "highlight_indices"}))
