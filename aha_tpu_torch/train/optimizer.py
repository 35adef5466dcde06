"""AdamW with a warmup-cosine schedule, global-norm clipping, gradient
accumulation and a trainable-leaf partition, written out on tensors.

Counterpart of ``aha_tpu/train/optimizer.py``, which chains optax pieces; the
arithmetic and its order are optax's, so that a run from the same state and
gradients follows the same trajectory:

  * ``cosine_schedule``: ``optax.warmup_cosine_decay_schedule(0, lr,
    warmup, total, 0)`` with ``warmup = max(1, int(warmup_ratio * total))``;
    the update at count c uses ``schedule(c)``, so the first update (c = 0)
    has rate 0;
  * accumulation as ``optax.MultiSteps``: a running mean of the k
    micro-steps' gradients, then clip, then one update; the schedule counts
    updates, not micro-steps;
  * ``clip_by_global_norm`` over the trained leaves only;
  * AdamW: b1 0.9, b2 0.999, eps 1e-8 outside the root, bias correction,
    decoupled weight decay added to the update before the rate.

Frozen leaves have no state and are never touched. Moments are f32 whatever
the leaf's dtype; a bf16 leaf and its f32 update are added in f32 and rounded
once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from ..config import TrainConfig

B1, B2, EPS = 0.9, 0.999, 1e-8


def cosine_schedule(cfg: TrainConfig, total_steps: int):
    """count -> learning rate."""
    warmup = max(1, int(cfg.warmup_ratio * total_steps))
    peak = cfg.learning_rate
    decay_steps = total_steps - warmup
    if decay_steps <= 0:
        raise ValueError(f"cosine_schedule: total_steps {total_steps} must exceed the warmup "
                         f"({warmup})")

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * (count / warmup)
        c = min(count - warmup, decay_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps))

    return schedule


@dataclass
class OptState:
    """``count``: updates applied; ``mini_step``: micro-steps gathered towards
    the next one; moments and the gradient mean by trained-leaf path."""

    count: int = 0
    mini_step: int = 0
    mu: dict = field(default_factory=dict)
    nu: dict = field(default_factory=dict)
    acc: dict = field(default_factory=dict)


class AdamW:
    def __init__(self, cfg: TrainConfig, total_steps: int):
        self.schedule = cosine_schedule(cfg, total_steps)
        self.max_grad_norm = cfg.max_grad_norm
        self.weight_decay = cfg.weight_decay
        self.every_k = max(1, cfg.grad_accum_steps)

    def init(self, trained: dict) -> OptState:
        """``trained``: path -> leaf, the trained leaves only."""
        zeros = lambda: {p: torch.zeros_like(t, dtype=torch.float32) for p, t in trained.items()}
        return OptState(mu=zeros(), nu=zeros(), acc=zeros() if self.every_k > 1 else {})

    @torch.no_grad()
    def update(self, grads: dict, state: OptState, trained: dict, sq_sum=None) -> None:
        """One micro-step: fold ``grads`` (path -> tensor) into the mean and,
        on every k-th, update ``trained`` and ``state`` IN PLACE. Works leaf by
        leaf with one f32 buffer of the leaf's size, so that the largest leaf
        (the lm_head) sets the peak, not the sum of them."""
        if self.every_k > 1:
            for p, g in grads.items():
                acc = state.acc[p]
                acc.add_((g.float() - acc).div_(state.mini_step + 1))
            state.mini_step += 1
            if state.mini_step < self.every_k:
                return
            grads = state.acc

        # on a mesh ``sq_sum`` sums the squares over every shard of each leaf
        norm = torch.sqrt(sq_sum(grads) if sq_sum is not None else
                          sum(g.float().pow(2).sum() for g in grads.values()))
        # optax: g where the norm is within the limit, else g / norm * limit
        factor = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                             self.max_grad_norm / norm)
        lr = self.schedule(state.count)
        t = state.count + 1
        for p, g in grads.items():
            g = g.to(torch.float32, copy=True).mul_(factor)
            mu, nu = state.mu[p], state.nu[p]
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            # u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps), built in g's buffer
            u = torch.div(nu, 1.0 - B2 ** t, out=g).sqrt_().add_(EPS)
            torch.div(mu, u, out=u).div_(1.0 - B1 ** t)
            leaf = trained[p]
            if self.weight_decay:
                u.add_(leaf, alpha=self.weight_decay)
            leaf.add_(u, alpha=-lr)    # summed in f32, rounded once to the leaf's dtype
        if self.every_k > 1:
            for a in state.acc.values():
                a.zero_()
            state.mini_step = 0
        state.count = t
