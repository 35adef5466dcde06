"""Session construction and the inference flags of the command line: the
port's copy of ``aha_tpu/cli/_session.py``, with its flag names and
defaults and one flag of its own, ``--device`` (the card unless the caller
asks for the CPU), and the params file's fallback on the committed
calibration (``_resolve_params_file``).

Weights, in JAX's order (``aha_tpu/cli/_session.py:57-164``):
``--synthetic_weights`` builds JAX's seeded synthetic tree in its final form
(``--int4``, ``--int8`` / ``--w8a8`` or dense ``cfg.dtype``); else
``--llm_pretrained DIR`` loads a checkpoint (``.safetensors`` or torch shards,
``config.json``'s ``vocab_size`` adopted) in ``cfg.dtype``; with neither,
JAX's random init at seed 0. ``--lora_pretrained DIR`` then loads a peft
adapter-only checkpoint: its adapters apply at every decoder pass (at
``lora_alpha / r``) and its modules_to_save (projector, heads, lm_head, f32)
replace the tree's. Then ``--int4`` or ``--int8`` quantises the loaded tree,
overrides included (``--vision_int8``: the tower and the projector too, or
those alone without either), and a quantised decoder's q/k/v and gate/up are
merged, as JAX's engine serves them; a synthetic tree is already in its final
form, so its overrides stay dense and JAX's tower flag does nothing there.
``--w8a8`` (not with ``--int4``) is ``--int8 --vision_int8`` on the
``"fused_a8"`` backend (per-token int8 activations: JAX's ``w8a8``), and
turns fused scoring of 4 frames into 8 where the command has no ``batch``
(``infer``, even with ``--concurrent_streams``) or a batch of 1; otherwise the
session runs on ``"fused"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

# the reference's published calibration, committed in the repository: evaluate and
# highlight fall back on it before `grid-search` has written a params file
_DEFAULT_PARAMS_FILE = "configs/grid_search_params.default.json"


def _resolve_params_file(path: str) -> str:
    """``path`` where it exists, else the committed calibration (looked for
    in the working directory, then beside the package), else ``path``."""
    if os.path.exists(path):
        return path
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (_DEFAULT_PARAMS_FILE, os.path.join(repo_root, _DEFAULT_PARAMS_FILE)):
        if os.path.exists(cand):
            print(f"[aha] {path} not found; using committed calibration {cand}",
                  file=sys.stderr)
            return cand
    return path


def _adopt_checkpoint_config(cfg, weights_path):
    """The preset with ``vocab_size`` taken from a checkpoint directory's
    config.json where it has one: buffers indexed by token id (repetition
    counts, the lm_head's argmax) are sized by it."""
    if not weights_path or not os.path.isdir(weights_path):
        return cfg
    cj = os.path.join(weights_path, "config.json")
    if not os.path.exists(cj):
        return cfg
    with open(cj) as f:
        v = json.load(f).get("vocab_size")
    if v and int(v) != cfg.llm.vocab_size:
        print(f"[aha] adopting vocab_size={v} from {cj} (preset had {cfg.llm.vocab_size})",
              file=sys.stderr)
        cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, vocab_size=int(v)))
    return cfg


def _build_params(args, cfg):
    """The weights and adapters the flags ask for, on ``args.device``, in the
    layout the engine serves: (params, lora, lora_scale)."""
    import torch

    from ..models import loader
    from ..models.aha import torch_dtype
    from ..ops import quant

    synthetic = getattr(args, "synthetic_weights", False)
    mode = "int4" if getattr(args, "int4", False) else "int8" if args.int8 else None
    if synthetic:
        params = loader.materialize_random_params(cfg, mode, device=args.device)
    elif args.llm_pretrained:
        params = loader.load_params(args.llm_pretrained, cfg, torch_dtype(cfg.dtype),
                                    device=args.device)
    else:
        params = loader.init_aha_params(cfg, seed=0, device=args.device)
    lora, lora_scale = None, 0.0
    if getattr(args, "lora_pretrained", None):
        lora, overrides, lora_scale = loader.load_adapter(args.lora_pretrained, cfg,
                                                          torch.float32, args.device)
        params = loader.apply_overrides(params, overrides)
    if synthetic:
        return params, lora, lora_scale
    if mode is not None:
        params = quant.quantize_params(params, bits=4 if mode == "int4" else 8,
                                       quantize_vision=getattr(args, "vision_int8", False))
        params = {**params, "llm": quant.merge_decoder_projections(params["llm"])}
    elif getattr(args, "vision_int8", False):
        params = quant.quantize_params(params, quantize_vision=True, keep_dense=("llm",))
    return params, lora, lora_scale


def _serving_mode(args) -> str:
    """``--w8a8``, as JAX's command line reads it: ``--int8`` and
    ``--vision_int8`` set, fused scoring of 4 frames widened to 8 where the
    command has no ``batch`` or a batch of 1, and the int8-activation backend.
    Returns the session's matmul backend."""
    if not getattr(args, "w8a8", False):
        return "fused"
    if getattr(args, "int4", False):
        raise SystemExit("--w8a8 and --int4 are mutually exclusive: the w8a8 backend "
                         "bypasses the fused int4 kernel")
    args.int8 = args.vision_int8 = True
    if getattr(args, "fused_score_frames", 4) == 4 and getattr(args, "batch", 1) == 1:
        args.fused_score_frames = 8
    return "fused_a8"


def _build_session(args):
    """Parsed flags -> a StreamSession on ``args.device``. A command with a
    narrower flag set (``demo``) leaves the others at JAX's defaults."""
    from ..streaming.session import build_session

    params, cfg, tokenizer, infer_cfg, kw = _build_parts(args)
    return build_session(params, cfg, tokenizer, infer_cfg, device=args.device, **kw)


def _build_parts(args):
    """Parsed flags -> (params on ``args.device``, cfg, tokenizer, InferConfig,
    and the keywords of the engine: ``backend``, ``lora``, ``lora_scale``):
    what a session or a multi-stream server is built from."""
    from ..config import InferConfig, aha_7b, aha_tiny
    from ..tokenization import build_stream_tokenizer

    backend = _serving_mode(args)
    cfg = aha_tiny() if args.model_preset == "tiny" else aha_7b()
    cfg = _adopt_checkpoint_config(cfg, args.llm_pretrained)
    tokenizer = build_stream_tokenizer(args.tokenizer_pretrained,
                                       frame_num_tokens=cfg.frame_num_tokens,
                                       vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tokenizer.v_placeholder_id,
                      eos_token_id=tokenizer.eos_token_id)
    params, lora, lora_scale = _build_params(args, cfg)
    infer_cfg = InferConfig(
        frame_fps=args.frame_fps,
        frame_resolution=cfg.frame_resolution,
        grounding_mode=args.grounding_mode,
        stream_end_prob_threshold=args.stream_end_prob_threshold,
        threshold_z=args.threshold_z,
        first_n_frames_no_generate=getattr(args, "first_n_frames_no_generate", 0),
        running_list_length=getattr(args, "running_list_length", 20),
        response_min_interval_frames=getattr(args, "response_min_interval_frames", None),
        stream_end_score_sum_threshold=args.stream_end_score_sum_threshold,
        remove_assistant_turns=args.remove_assistant_turns,
        score_heads=tuple(args.score_heads.split(",")),
        repetition_penalty=args.repetition_penalty,
        max_new_tokens=args.max_new_tokens,
        kv_cache_policy=args.kv_cache_policy,
        kv_window=args.kv_window,
        num_sink_tokens=args.num_sink_tokens,
        kv_cache_dtype=getattr(args, "kv_cache_dtype", "auto"),
        kv_mask_mode=getattr(args, "kv_mask_mode", "hf"),
        spec_decode_tokens=getattr(args, "spec_decode_tokens", 4),
        spec_decode_tokens_max=getattr(args, "spec_decode_tokens_max", 8),
        fused_score_frames=getattr(args, "fused_score_frames", 4),
        retire_defer=getattr(args, "retire_defer", 1),
    )
    return params, cfg, tokenizer, infer_cfg, dict(backend=backend, lora=lora,
                                                   lora_scale=lora_scale)


def _add_infer_flags(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device of the session (default: the card; 'cpu' runs the "
                        "kernels' plain versions on the host)")
    p.add_argument("--model_preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--llm_pretrained", default=None,
                   help="HF checkpoint dir (.safetensors or torch .bin / .pt shards)")
    p.add_argument("--tokenizer_pretrained", default=None)
    p.add_argument("--lora_pretrained", default=None,
                   help="peft adapter-only checkpoint dir (the published artifact): its "
                        "adapters and modules_to_save on top of the base weights")
    p.add_argument("--int8", action="store_true", help="int8 weights (per output channel)")
    p.add_argument("--int4", action="store_true",
                   help="packed int4 weights (groups of 128; the smallest memory)")
    p.add_argument("--synthetic_weights", action="store_true",
                   help="JAX's seeded synthetic params built on the device in their final "
                        "form (--int8, --int4 or dense): a run of the product without a "
                        "checkpoint (scores meaningless; speed and memory real)")
    p.add_argument("--vision_int8", action="store_true",
                   help="also quantize the SigLIP tower and the projector (int8 per "
                        "channel; not with --synthetic_weights, whose tower stays dense)")
    p.add_argument("--w8a8", action="store_true",
                   help="serving mode: int8 weights, per-token int8 activations, an int8 "
                        "vision tower and fused width 8 (~1%% hidden-state error)")
    p.add_argument("--test_dataset", required=True,
                   choices=["tvsum", "tvsum_degraded", "hisum", "youcook2",
                            "magqa", "charades", "generic",
                            "arl_scout", "hubble_space", "jkim_landing"])
    p.add_argument("--query", default=None,
                   help="live-video demo datasets: the running query")
    p.add_argument("--tick_table", default="configs/tick_tables/demo_ticks.json")
    p.add_argument("--start_sec", type=float, default=0.0)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_fname", required=True)
    p.add_argument("--test_fname", default=None)
    p.add_argument("--caption_metadata_file", default=None)
    p.add_argument("--video_metadata_file", default=None)
    p.add_argument("--anno_file", default=None)
    p.add_argument("--hisum_h5_file", default=None)
    p.add_argument("--frame_fps", type=float, default=2.0)
    p.add_argument("--max_num_frames", type=int, default=400)
    p.add_argument("--grounding_mode", action="store_true")
    p.add_argument("--stream_end_prob_threshold", type=float, default=None)
    p.add_argument("--threshold_z", type=float, default=None)
    p.add_argument("--first_n_frames_no_generate", type=int, default=0)
    p.add_argument("--running_list_length", type=int, default=20)
    p.add_argument("--response_min_interval_frames", type=int, default=None)
    p.add_argument("--stream_end_score_sum_threshold", type=float, default=None)
    p.add_argument("--remove_assistant_turns", action="store_true")
    p.add_argument("--score_heads", default="relevance_score,informative_score")
    p.add_argument("--repetition_penalty", type=float, default=None)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--kv_cache_policy", default="sink",
                   choices=["sink", "sliding", "static", "none"])
    p.add_argument("--kv_window", type=int, default=2048)
    p.add_argument("--num_sink_tokens", type=int, default=32)
    p.add_argument("--kv_cache_dtype", default="auto", choices=["auto", "int8"],
                   help="int8: per-(slot, head) quantized KV cache")
    p.add_argument("--spec_decode_tokens", type=int, default=4,
                   help="speculative decoding: tokens verified per decoder pass (1 = off); "
                        "the same tokens either way")
    p.add_argument("--spec_decode_tokens_max", type=int, default=8,
                   help="acceptance-adaptive ceiling of the speculative width "
                        "(<= spec_decode_tokens = fixed width)")
    p.add_argument("--fused_score_frames", type=int, default=4,
                   help="frames verified per decoder weight stream on the scoring paths "
                        "(1 = one frame a pass); the same decisions either way")
    p.add_argument("--kv_mask_mode", default="hf", choices=["hf", "strict"],
                   help="hf: the reference's transformers-4.49 mask arithmetic; strict: "
                        "true causal masking")
    p.add_argument("--no_query", action="store_true")
    p.add_argument("--title_ablation", default=None, choices=["ambiguous", "unrelated"])
    p.add_argument("--title_table", default=None)
    p.add_argument("--time_instruction_format", default=None)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--concurrent_streams", type=int, default=1,
                   help="streaming-QA datasets: videos served at once in one batched "
                        "engine (generation mode: continuous batching); the same "
                        "per-stream output as 1")
