"""``aha train``: fine-tuning from a dataset mixture, the port's copy of
``aha_tpu/cli/train.py`` with its flags, choices and defaults and one flag of
its own, ``--device`` (the card unless the caller asks for the CPU).

In JAX's order: the preset (``vocab_size`` adopted from a checkpoint's
config.json), the tokenizer, the weights (``--llm_pretrained`` or JAX's
seed-0 init), ``--lora_pretrained`` (its adapters seed the LoRA state, its
modules_to_save replace the base's; a warning where its alpha / r is not the
training config's), ``--quantize_base`` (``--quantize_bits`` 8 or 4, the
projector and the lm_head kept dense; the decoder's q/k/v and gate/up then
merged, as the port's kernels take them), the mixture, ``--num_steps`` or
``--num_epochs``, the prefetching batch iterator and ``train()``. The export
is ``adapter.pt`` beside ``metrics.jsonl`` and ``checkpoints/`` (JAX writes an
orbax directory; orbax is not ported). The mesh flags run under a world of the
mesh's size (``torchrun --nproc_per_node N -m aha_tpu_torch.cli train
--mesh_*``; the process group comes up first, from torchrun's environment);
a mesh larger than the world, and ``--wandb``, exit 2.
"""

from __future__ import annotations

import argparse

from ._session import _adopt_checkpoint_config


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="aha train")
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (default: the card; 'cpu' runs the "
                        "kernels' plain versions on the host)")
    p.add_argument("--model_preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--llm_pretrained", default=None)
    p.add_argument("--tokenizer_pretrained", default=None)
    p.add_argument("--dataset_config", required=True)
    p.add_argument("--output_dir", default="outputs/train")
    p.add_argument("--num_steps", type=int, default=None,
                   help="total MICRO-BATCH steps (one batch each; with --grad_accum_steps G "
                        "the optimizer updates every G of them); alternatively --num_epochs")
    p.add_argument("--num_epochs", type=int, default=None,
                   help="epochs over the mixture, converted to micro-batch steps as "
                        "len(dataset) // batch_size per epoch")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=2e-5)
    p.add_argument("--grad_accum_steps", type=int, default=2)
    p.add_argument("--mesh_data", type=int, default=-1)
    p.add_argument("--mesh_model", type=int, default=1)
    p.add_argument("--mesh_pipe", type=int, default=1,
                   help="GPipe pipeline stages over the decoder layers")
    p.add_argument("--pipe_microbatches", type=int, default=2)
    p.add_argument("--resume_from_checkpoint", default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--wandb", action="store_true")
    p.add_argument("--prefetch_batches", type=int, default=2,
                   help="batches decoded+collated ahead of the train step")
    p.add_argument("--decode_workers", type=int, default=2,
                   help="thread-pool workers for host video decode")
    p.add_argument("--video_head_stop_grad", action="store_true",
                   help="ablation: detach hidden states before the score heads")
    p.add_argument("--remat_policy", default="full",
                   choices=["none", "full", "half", "dots", "dots_no_batch"],
                   help="trunk activation remat: 'full' = least memory, 'dots' keeps the "
                        "products' outputs for a faster backward when memory allows")
    p.add_argument("--quantize_base", action="store_true",
                   help="QLoRA: freeze the trunk quantised (--quantize_bits), train the "
                        "adapters and the dense finetune modules")
    p.add_argument("--quantize_bits", type=int, default=8, choices=[4, 8],
                   help="trunk quantization width for --quantize_base: 8 = per-channel "
                        "int8; 4 = group-wise packed int4")
    p.add_argument("--lora_pretrained", default=None,
                   help="continue fine-tuning from a published peft adapter dir: adapters "
                        "seed the LoRA state, modules_to_save override the base")
    return p


def _refuse_unported(args) -> None:
    if args.wandb:
        raise NotImplementedError("train --wandb: not ported (ROADMAP.md, 'Do not port': no "
                                  "network); metrics.jsonl holds every logged step")


def cmd_train(argv):
    """Parse the flags, build the weights and the mixture, run ``train()``;
    returns the final ``TrainState``."""
    import torch

    from ..parallel import mesh as mesh_lib
    from ..utils import dist as dist_utils

    from ..config import TrainConfig, aha_7b, aha_tiny
    from ..data.datasets import build_mixture_from_config
    from ..data.pipeline import batch_iterator
    from ..models import loader
    from ..models.aha import torch_dtype
    from ..ops import quant
    from ..tokenization import build_stream_tokenizer
    from ..train.lora import lora_scale
    from ..train.trainer import train

    p = _parser()
    args = p.parse_args(argv)
    # the process group first: torchrun's environment says whether there is one
    dist_utils.maybe_init_distributed(args.device)
    _refuse_unported(args)
    n_proc = dist_utils.process_count()
    mesh = None
    if n_proc > 1 or args.mesh_data not in (-1, 1) or args.mesh_model > 1 or args.mesh_pipe > 1:
        mesh = mesh_lib.make_mesh(args.mesh_data, args.mesh_model, args.mesh_pipe)
    if args.num_steps is None and args.num_epochs is None:
        p.error("one of --num_steps / --num_epochs is required")
    train_cfg = TrainConfig(
        output_dir=args.output_dir,
        dataset_config=args.dataset_config,
        llm_pretrained=args.llm_pretrained,
        lora_pretrained=args.lora_pretrained,
        learning_rate=args.learning_rate,
        batch_size=args.batch_size,
        grad_accum_steps=args.grad_accum_steps,
        num_epochs=args.num_epochs or 0,
        resume_from_checkpoint=args.resume_from_checkpoint,
        seed=args.seed,
        remat_policy=args.remat_policy,
        mesh_data=args.mesh_data,
        mesh_model=args.mesh_model,
        mesh_pipe=args.mesh_pipe,
        pipe_microbatches=args.pipe_microbatches,
    )

    cfg = aha_tiny() if args.model_preset == "tiny" else aha_7b()
    cfg = _adopt_checkpoint_config(cfg, train_cfg.llm_pretrained)
    tokenizer = build_stream_tokenizer(args.tokenizer_pretrained,
                                       frame_num_tokens=cfg.frame_num_tokens,
                                       vocab_size=cfg.llm.vocab_size)
    cfg = cfg.replace(v_placeholder_id=tokenizer.v_placeholder_id,
                      eos_token_id=tokenizer.eos_token_id)
    if train_cfg.llm_pretrained:
        params = loader.load_params(train_cfg.llm_pretrained, cfg, torch_dtype(cfg.dtype),
                                    device=args.device)
    else:
        params = loader.init_aha_params(cfg, seed=0, device=args.device)
    if args.video_head_stop_grad:
        cfg = cfg.replace(video_head_stop_grad=True)
    lora_init = None
    if train_cfg.lora_pretrained:
        lora_init, overrides, ad_scale = loader.load_adapter(train_cfg.lora_pretrained, cfg,
                                                             torch.float32, args.device)
        params = loader.apply_overrides(params, overrides)
        want = lora_scale(train_cfg.lora)
        if abs(ad_scale - want) > 1e-6:
            print(f"warning: adapter alpha/r scale {ad_scale} != training config scale {want} "
                  f"— adjust TrainConfig.lora to match the adapter")
    if args.quantize_base:
        params = quant.quantize_params(params, keep_dense=("projector", "lm_head"),
                                       bits=args.quantize_bits)
        params = {**params, "llm": quant.merge_decoder_projections(params["llm"])}
    dataset = build_mixture_from_config(train_cfg.dataset_config, tokenizer,
                                        system_prompt=train_cfg.system_prompt,
                                        frame_size=cfg.frame_resolution)
    num_steps = args.num_steps
    if num_steps is None:
        num_steps = train_cfg.num_epochs * max(len(dataset) // train_cfg.batch_size, 1)
    # one process a rank: when the data axis splits cleanly across the
    # processes each decodes only its own rows (batch_size / n local), else
    # every process decodes the whole batch and the step takes its rows
    per_host = (n_proc > 1 and train_cfg.batch_size % n_proc == 0
                and mesh_lib.data_axis_spans_processes(mesh) and not train_cfg.ring_attention)
    loader_bs = train_cfg.batch_size // n_proc if per_host else train_cfg.batch_size
    if n_proc > 1 and not per_host:
        print(f"multi-host replicated loading: batch {train_cfg.batch_size} or mesh layout "
              f"not splittable over {n_proc} processes — every host decodes the full batch")
    # host decode on a thread pool, collated batches prefetched ahead of the step
    batches = batch_iterator(dataset, tokenizer, batch_size=loader_bs,
                             v_placeholder_id=cfg.v_placeholder_id,
                             frame_num_tokens=cfg.frame_num_tokens, seed=train_cfg.seed,
                             prefetch=args.prefetch_batches, num_workers=args.decode_workers,
                             shard_across_hosts=per_host)
    return train(cfg, train_cfg, params, batches, total_steps=num_steps, lora_init=lora_init,
                 device=args.device, device_mesh=mesh, per_host_batches=per_host,
                 pad_token_id=tokenizer.pad_token_id)
