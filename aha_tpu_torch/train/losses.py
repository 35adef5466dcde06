"""The Aha multi-part training loss.

Counterpart of ``aha_tpu/train/losses.py``:

    loss = lm_w * CE(logits, shifted_labels)
         + video_w * ( info_w * CE(informative_logits, informative_labels)
                     + rel_w  * ( SmoothL1(relevance, rel_labels) + tv_w * TV )
                     + unc_w  * clamp(GaussianNLL - 1e-3 * std(log_var), min=0) )

with the quirks of the reference implementation that the TPU package
reproduces on purpose:

  * the TV term is a scalar mean over ALL adjacent differences, times
    sum(tv_mask) / (sum(tv_mask) + 1e-6);
  * SmoothL1 only applies with more than one valid relevance label, else 0;
  * the Gaussian NLL clamps the log-variance to [-4, 1.5] and pairs every
    variance with the MEAN squared residual (the closed form of the
    reference's [n, n] outer mean); the diversity bonus is the unbiased std
    over every position, valid or not;
  * a batch with no valid label of a kind gets one injected
    (``label[:, 0] = input_ids[:, 1]`` for the LM, 0 for the heads).

All reductions are mask-weighted sums with safe denominators: no branch on
the data, so no host read of a device value.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..config import LossWeights

IGNORE = -100


@dataclass
class LossParts:
    total: torch.Tensor
    lm: torch.Tensor
    video: torch.Tensor
    info: torch.Tensor
    relevance: torch.Tensor
    tv: torch.Tensor
    uncertainty: torch.Tensor

    def detach(self) -> "LossParts":
        return LossParts(**{k: v.detach() for k, v in vars(self).items()})


def _masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over labels != IGNORE ([.., V] logits, [..] labels)."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(valid, nll, torch.zeros_like(nll)).sum() / valid.sum().clamp(min=1)


def _smooth_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _inject_if_empty(labels: torch.Tensor, fill) -> torch.Tensor:
    """If no label in the whole batch is valid, set [:, 0] = fill."""
    injected = labels.clone()
    injected[:, 0] = fill
    return torch.where((labels != IGNORE).any(), labels, injected)


def aha_loss(logits: torch.Tensor, informative_logits: torch.Tensor, relevance: torch.Tensor,
             log_variance: torch.Tensor, *, input_ids: torch.Tensor,
             labels: torch.Tensor | None, informative_labels: torch.Tensor | None,
             relevance_labels: torch.Tensor | None, weights: LossWeights,
             comm=None, seq=None) -> LossParts:
    """logits [B, T, V], informative_logits [B, T, 2], relevance (post-sigmoid)
    and log_variance [B, T]; labels already shifted by the collator, IGNORE
    (-100) where unlearned (relevance_labels float).

    ``comm`` (the ``data`` axis' ``Comm``): the batch's rows, or with ``seq`` =
    (first token, global length) its tokens, are split over the axis; the loss
    is then the global batch's (``_aha_loss_sharded``)."""
    if comm is not None and comm.size > 1:
        return _aha_loss_sharded(logits, informative_logits, relevance, log_variance,
                                 input_ids=input_ids, labels=labels,
                                 informative_labels=informative_labels,
                                 relevance_labels=relevance_labels, weights=weights,
                                 comm=comm, seq=seq)
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    lm = info = rel = tv = unc = zero

    if labels is not None:
        labels = _inject_if_empty(labels, input_ids[:, 1].to(labels.dtype))
        lm = _masked_ce(logits, labels)

    if informative_labels is not None:
        info = _masked_ce(informative_logits, _inject_if_empty(informative_labels, 0))

    if relevance_labels is not None:
        relevance_labels = _inject_if_empty(relevance_labels, 0.0)
        valid = relevance_labels != IGNORE
        rl = torch.where(valid, relevance_labels, torch.zeros_like(relevance_labels)).float()
        rv = relevance.float()
        count = valid.sum()
        denom = count.clamp(min=1)

        if relevance.shape[1] > 1:
            n_pairs = valid[:, 1:].sum().float()
            tv = ((rv[:, 1:] - rv[:, :-1]) ** 2).mean() * n_pairs / (n_pairs + 1e-6)

        sl1 = torch.where(valid, _smooth_l1(rv, rl), zero).sum() / denom
        rel = torch.where(count > 1, sl1, zero)

        lv = log_variance.float().clamp(-4.0, 1.5)
        var = torch.exp(lv)
        mse_mean = torch.where(valid, (rl - rv) ** 2, zero).sum() / denom
        nll = mse_mean / (2 * var + 1e-6) + 0.5 * torch.log(2 * math.pi * var)
        nll_mean = torch.where(valid, nll, zero).sum() / denom
        lv_std = torch.sqrt((((lv - lv.mean()) ** 2).sum() / max(lv.numel() - 1, 1)).clamp(min=0.0))
        unc = (nll_mean - 1e-3 * lv_std).clamp(min=0.0)

    video = weights.info * info + weights.relevance * (rel + weights.tv * tv) \
        + weights.uncertainty * unc
    total = weights.lm * lm + weights.video * video
    return LossParts(total=total, lm=lm, video=video, info=info, relevance=rel, tv=tv,
                     uncertainty=unc)


def _aha_loss_sharded(logits, informative_logits, relevance, log_variance, *, input_ids,
                      labels, informative_labels, relevance_labels, weights, comm, seq):
    """``aha_loss`` of the global batch from a rank's rows or token stretch:
    every masked sum and count is all-reduced over ``comm`` (its gradient
    passed through: each rank differentiates its own part of the sum), the
    injection of a missing label kind is decided on the global batch (and made
    by the rank that holds position 0), the TV term reads its neighbours across
    token stretches (the stretches gathered, each rank's gradient its own
    slice), the log-variance's std is the global one."""
    from ..parallel.comm import gather_from, psum, reduce_from

    gs = lambda t: reduce_from(t, comm)     # a sum read by replicated work only
    first = seq is None or seq[0] == 0
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    lm = info = rel = tv = unc = zero

    def inject(lab, fill):
        any_valid = gs((lab != IGNORE).sum()) > 0
        if not first:
            return lab
        injected = lab.clone()
        injected[:, 0] = fill
        return torch.where(any_valid, lab, injected)

    def ce(lg, lab):
        valid = lab != IGNORE
        safe = torch.where(valid, lab, torch.zeros_like(lab)).long()
        logp = torch.log_softmax(lg.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return gs(torch.where(valid, nll, torch.zeros_like(nll)).sum()) / gs(
            valid.sum()).clamp(min=1)

    if labels is not None:
        lm = ce(logits, inject(labels, input_ids[:, 1].to(labels.dtype)))
    if informative_labels is not None:
        info = ce(informative_logits, inject(informative_labels, 0))
    if relevance_labels is not None:
        relevance_labels = inject(relevance_labels, 0.0)
        valid = relevance_labels != IGNORE
        rl = torch.where(valid, relevance_labels, torch.zeros_like(relevance_labels)).float()
        rv = relevance.float()
        count = gs(valid.sum())
        denom = count.clamp(min=1)
        if seq is not None:
            rv_g, valid_g = gather_from(rv, comm, 1), gather_from(valid, comm, 1)
            if rv_g.shape[1] > 1:
                n_pairs = valid_g[:, 1:].sum().float()
                tv = ((rv_g[:, 1:] - rv_g[:, :-1]) ** 2).mean() * n_pairs / (n_pairs + 1e-6)
        elif rv.shape[1] > 1:
            n_pairs = gs(valid[:, 1:].sum()).float()
            n = gs(torch.tensor(rv[:, 1:].numel(), dtype=torch.float32, device=rv.device))
            tv = gs(((rv[:, 1:] - rv[:, :-1]) ** 2).sum()) / n * n_pairs / (n_pairs + 1e-6)
        sl1 = gs(torch.where(valid, _smooth_l1(rv, rl), zero).sum()) / denom
        rel = torch.where(count > 1, sl1, zero)
        lv = log_variance.float().clamp(-4.0, 1.5)
        var = torch.exp(lv)
        # the two sums each rank reads in its own per-element terms: psum
        mse_mean = psum(torch.where(valid, (rl - rv) ** 2, zero).sum(), comm) / denom
        nll = mse_mean / (2 * var + 1e-6) + 0.5 * torch.log(2 * math.pi * var)
        nll_mean = gs(torch.where(valid, nll, zero).sum()) / denom
        n = gs(torch.tensor(lv.numel(), dtype=torch.float32, device=lv.device))
        mean = psum(lv.sum(), comm) / n
        lv_std = torch.sqrt((gs(((lv - mean) ** 2).sum()) / torch.clamp(n - 1, min=1))
                            .clamp(min=0.0))
        unc = (nll_mean - 1e-3 * lv_std).clamp(min=0.0)

    video = weights.info * info + weights.relevance * (rel + weights.tv * tv) \
        + weights.uncertainty * unc
    total = weights.lm * lm + weights.video * video
    return LossParts(total=total, lm=lm, video=video, info=info, relevance=rel, tv=tv,
                     uncertainty=unc)
