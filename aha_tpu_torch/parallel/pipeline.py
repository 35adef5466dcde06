"""Pipeline parallelism: the GPipe microbatch schedule over a ``pipe`` mesh
axis; the port's copy of ``aha_tpu/parallel/pipeline.py``.

Each stage holds L / S contiguous layers of the decoder stack (the ``pipe``
entry of the stacked leaves' specs). The schedule runs M + S - 1 ticks for M
microbatches: at tick t stage s runs microbatch t - s when it exists, stage 0
pulling it from the batch and every other stage receiving it from the stage
before; the last stage's outputs are then broadcast, so every stage holds the
replicated result (JAX's masked ``psum``). Autograd does not differentiate
``send`` / ``recv``, so the backward is explicit: stage S - 1 takes the
outputs' cotangent, each stage replays its layers on the microbatch inputs it
kept (as remat 'full' does) and hands the input cotangent to the stage before;
stage 0's input cotangent is broadcast, since every stage computed the
pipeline's input alike. Adapter dropout folds in (data shard, microbatch) by
drawing each microbatch's mask at its global rows (``LayerAdapters``).
"""

from __future__ import annotations

import torch


def _mb(extras: dict, m: int, mb: int) -> dict:
    return {k: None if v is None else v[m * mb:(m + 1) * mb] for k, v in extras.items()}


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, stage_fn, extras, n_micro, x, *params):
        S, sid = comm.size, comm.index
        B = x.shape[0]
        if B % n_micro:
            raise ValueError(f"local batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        xd = x.detach()
        inputs = [None] * n_micro
        outs = torch.zeros_like(xd)
        with torch.no_grad():
            for t in range(n_micro + S - 1):
                m = t - sid
                if not 0 <= m < n_micro:
                    continue            # a bubble tick: this stage waits
                x_in = (xd[m * mb:(m + 1) * mb] if sid == 0
                        else comm.recv(xd[:mb], sid - 1))
                inputs[m] = x_in
                y = stage_fn(x_in, _mb(extras, m, mb), m)
                if sid < S - 1:
                    comm.send(y, sid + 1)
                else:
                    outs[m * mb:(m + 1) * mb] = y
        outs = comm.broadcast(outs, S - 1)
        ctx.comm, ctx.stage_fn, ctx.extras, ctx.n_micro = comm, stage_fn, extras, n_micro
        ctx.inputs, ctx.mb = inputs, mb
        ctx.save_for_backward(*params)
        return outs

    @staticmethod
    def backward(ctx, g):
        comm, stage_fn, extras, n_micro, mb = (ctx.comm, ctx.stage_fn, ctx.extras,
                                               ctx.n_micro, ctx.mb)
        params = ctx.saved_tensors
        S, sid = comm.size, comm.index
        gp = [torch.zeros_like(p) for p in params]
        dx = torch.zeros_like(g)
        for m in range(n_micro):
            dy = (g[m * mb:(m + 1) * mb].contiguous() if sid == S - 1
                  else comm.recv(g[:mb], sid + 1))
            with torch.enable_grad():
                x_in = ctx.inputs[m].detach().requires_grad_(True)
                y = stage_fn(x_in, _mb(extras, m, mb), m)
                grads = torch.autograd.grad(y, [x_in, *params], dy, allow_unused=True)
            for acc, gr in zip(gp, grads[1:]):
                if gr is not None:
                    acc += gr
            if sid > 0:
                comm.send(grads[0], sid - 1)
            else:
                dx[m * mb:(m + 1) * mb] = grads[0]
        dx = comm.broadcast(dx, 0)
        return (None, None, None, None, dx, *gp)


def gpipe_scan_layers(comm, x: torch.Tensor, extras: dict, stage_fn, n_micro: int,
                      params: list) -> torch.Tensor:
    """Run this stage's layers as one stage of an S-stage GPipe pipeline over
    ``comm`` (the pipe axis); returns [B, T, H] on every stage.

    ``x`` [B, T, H]: this data shard's activations, the same on every stage.
    ``extras``: [B, ...] tensors the layers read (mask, positions, rope
    tables; None allowed), sliced per microbatch. ``stage_fn(x_mb, extras_mb,
    m)`` runs the stage's layers on microbatch m. ``params``: the tensors
    ``stage_fn`` reads that need a gradient (the stage's adapters)."""
    if comm is None or comm.size == 1:
        B = x.shape[0]
        mb = B // n_micro
        return torch.cat([stage_fn(x[m * mb:(m + 1) * mb], _mb(extras, m, mb), m)
                          for m in range(n_micro)], dim=0)
    return _GPipe.apply(comm, stage_fn, extras, n_micro, x, *params)
