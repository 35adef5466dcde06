"""``aha grid-search``, ``aha evaluate``, ``aha highlight`` and ``aha
visualize`` on the port: the calibration, metric, reel and figure commands
(``aha_tpu/cli/evaluate.py``), on the prediction files of ``infer``. Numpy on
the host, except ``evaluate --func magqa --judge_ckpt DIR``: the local LLM
judge, a Qwen2 decoder read from ``DIR`` in bf16 (at ``qwen2_7b()``'s shape,
with ``config.json``'s vocabulary) and run on ``--device`` under the f32
config that ``LocalJudge`` gives a bare decoder (bf16 products, an f32 cache).

JAX's own judge command reads ``DIR`` with its full-model loader, which needs
a vision config that ``qwen2_7b()`` does not have, and stops there; the port
reads the decoder alone and judges, as JAX's code means to (ROADMAP.md,
Queue 3, known divergences)."""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ._session import _adopt_checkpoint_config, _resolve_params_file


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
    p.add_argument("--device", default="cuda",
                   help="magqa --judge_ckpt: torch device of the judge (default: the card)")
    p.add_argument("--relevance_threshold", type=float, default=0.1)
    p.add_argument("--min_relevance_frames", type=int, default=5)
    args = p.parse_args(argv)

    if args.func == "magqa":
        _evaluate_magqa(args)
        return
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


def _evaluate_magqa(args):
    """The judge's score matrices over a streaming-QA prediction file, written
    to ``--output_file`` a line an example, and their in-span analysis."""
    from ..eval import llm_judge

    preds = _read_jsonl(args.pred_file)
    with open(args.gold_file) as f:
        gold = json.load(f)
    if not args.judge_ckpt:
        print("magqa needs --judge_ckpt (a converted Qwen2-style judge), or use "
              "llm_judge.to_openai_batch_input for the remote-judge path")
        return
    import torch

    from ..config import AhaConfig, qwen2_7b
    from ..models.loader import convert_qwen2, read_state_dict
    from ..tokenization import build_stream_tokenizer

    cfg = _adopt_checkpoint_config(AhaConfig(llm=qwen2_7b()), args.judge_ckpt).llm
    sd = read_state_dict(args.judge_ckpt)
    prefix = "model." if "model.embed_tokens.weight" in sd else "language_model.model."
    params = convert_qwen2(sd, cfg, prefix, torch.bfloat16, args.device)
    del sd
    judge = llm_judge.LocalJudge(params, cfg, build_stream_tokenizer(args.judge_ckpt),
                                 device=args.device)
    scored = llm_judge.magqa_score_matrices(preds, gold, judge)
    if args.output_file:
        with open(args.output_file, "w") as f:
            for ex in scored:
                f.write(json.dumps(ex) + "\n")
    print(json.dumps(llm_judge.analyze_magqa(scored), indent=2))


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


def cmd_visualize(argv):
    """Prediction-against-gold overlays and the comparison panels beside the
    published baselines."""
    p = argparse.ArgumentParser(prog="aha visualize")
    p.add_argument("--func", required=True, choices=["hisum_sota", "tvsum_sota", "pred_vs_gt"])
    p.add_argument("--pred_file", default=None,
                   help="driver prediction json (required for hisum_sota / pred_vs_gt; "
                        "tvsum_sota reads --metrics_file)")
    p.add_argument("--gold_file", default=None,
                   help="hisum_sota: .h5; pred_vs_gt: json uuid->scores, TVSum annotation "
                        ".tsv, or HiSum .h5")
    p.add_argument("--metrics_file", default=None, help="tvsum_sota: evaluate output json")
    p.add_argument("--params_file", default="outputs/grid_search_params.json")
    p.add_argument("--params_key", default=None)
    p.add_argument("--output", default="outputs/figures")
    p.add_argument("--max_show", type=int, default=5)
    args = p.parse_args(argv)

    from ..drivers import visualize as viz

    if args.func in ("hisum_sota", "pred_vs_gt") and not args.gold_file:
        p.error(f"--gold_file is required for --func {args.func}")
    if args.func in ("hisum_sota", "pred_vs_gt") and not args.pred_file:
        p.error(f"--pred_file is required for --func {args.func}")
    if args.func == "tvsum_sota" and not (args.metrics_file or args.pred_file):
        p.error("--metrics_file is required for --func tvsum_sota")
    os.makedirs(args.output, exist_ok=True)
    args.params_file = _resolve_params_file(args.params_file)
    if args.func == "hisum_sota":
        with open(args.params_file) as f:
            params = json.load(f)[args.params_key or "hisum"]
        out = viz.hisum_sota_figure(args.pred_file, args.gold_file, params,
                                    os.path.join(args.output, "hisum_results_comparison.png"))
        print(json.dumps(out, indent=2, default=float))
    elif args.func == "tvsum_sota":
        with open(args.metrics_file or args.pred_file) as f:
            metrics = json.load(f)
        print(viz.tvsum_sota_figure(metrics,
                                    os.path.join(args.output, "tvsum_results_comparison.png")))
    else:
        gt, gold_kind = _load_gt_scores(args.gold_file, args.pred_file)

        def gt_for(pred):
            g = gt.get(pred["video_uuid"])
            # TVSum's TSV gold is per source frame (indexed by true_frames_list), HiSum's
            # gtscore[i - 1] pairs with debug_data[i]
            return None if g is None else viz.align_gt_to_pred(pred, g, gold_kind)

        paths = viz.visualize_benchmark(args.pred_file, args.params_file,
                                        args.params_key or "tvsum", gt_for, args.output,
                                        max_videos=args.max_show)
        print("\n".join(paths))


def _load_gt_scores(gold_file: str, pred_file: str) -> tuple[dict, str]:
    """(uuid -> gold scores, gold kind) from a TVSum annotation TSV (per
    source frame: "tvsum_tsv"), a HiSum h5 (by each prediction's
    h5_identifier: "hisum_h5") or a JSON map uuid -> scores ("json");
    the kind names ``align_gt_to_pred``'s rule."""
    ext = os.path.splitext(gold_file)[1].lower()
    if ext == ".tsv":
        from ..eval import tvsum

        return {uid: np.asarray(a["importance_scores"])
                for uid, a in tvsum.load_annotations(gold_file).items()}, "tvsum_tsv"
    if ext in (".h5", ".hdf5"):
        import h5py

        with open(pred_file) as f:
            preds = json.load(f)
        out = {}
        with h5py.File(gold_file, "r") as hdf:
            for pr in preds:
                h5_id = pr.get("h5_identifier")
                if h5_id is not None and h5_id in hdf:
                    out[pr["video_uuid"]] = np.asarray(hdf[h5_id]["gtscore"])
        return out, "hisum_h5"
    with open(gold_file) as f:
        return {k: np.asarray(v) for k, v in json.load(f).items()}, "json"
