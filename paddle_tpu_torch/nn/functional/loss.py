"""Loss functionals (``paddle_tpu/nn/functional/loss.py`` analog).

``cross_entropy`` follows the JAX package's ``softmax_with_cross_entropy``
semantics: fp32 log-softmax over ``axis`` (or, with ``use_softmax=False``,
the log of the input clamped at 1e-30), hard or soft labels,
``ignore_index`` rows contributing zero, ``label_smoothing`` and class
``weight``s. ``mean`` divides hard-label losses by the number of rows that
count (by the sum of their class weights when weights are given) and
averages soft-label losses.
"""

from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    axis = axis % input.dim()
    x = input.float()
    logp = (torch.log_softmax(x, dim=axis) if use_softmax
            else torch.log(torch.clamp_min(x, 1e-30)))
    w_sum = None
    if soft_label:
        soft = label.float()
        if label_smoothing > 0:
            soft = (1 - label_smoothing) * soft \
                + label_smoothing / input.shape[axis]
        loss = -(soft * logp).sum(dim=axis)
        if weight is not None:
            loss = loss * (label.float() * weight.float()).sum(dim=axis)
    else:
        lab = label.long()
        if lab.dim() == logp.dim():
            lab = lab.squeeze(axis)
        valid = lab != ignore_index
        safe = torch.where(valid, lab, torch.zeros_like(lab))
        picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
        if label_smoothing > 0:
            picked = (1 - label_smoothing) * picked \
                + label_smoothing * logp.mean(dim=axis)
        loss = torch.where(valid, -picked, torch.zeros_like(picked))
        if weight is not None:
            pw = weight.float()[safe] * valid
            loss = loss * pw
            w_sum = pw.sum()
        else:
            w_sum = valid.float().sum()
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if w_sum is None:
        return loss.mean()
    return loss.sum() / w_sum.clamp_min(1e-12)
