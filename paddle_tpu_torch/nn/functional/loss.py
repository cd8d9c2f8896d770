"""Loss functionals (``paddle_tpu/nn/functional/loss.py`` analog).

``cross_entropy`` with hard labels: fp32 log-softmax over ``axis``, the
label's log-probability picked per row, ``ignore_index`` rows contributing
zero, and ``mean`` dividing by the number of rows that count — the JAX
package's ``softmax_with_cross_entropy`` semantics.
"""

from __future__ import annotations

import torch


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    if soft_label or label_smoothing or weight is not None or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: soft labels, label smoothing, class weights and "
            "use_softmax=False are not ported yet (ROADMAP queue A item 3e)")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    axis = axis % input.dim()
    logp = torch.log_softmax(input.float(), dim=axis)
    lab = label.long()
    if lab.dim() == logp.dim():
        lab = lab.squeeze(axis)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    picked = torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, -picked, torch.zeros_like(picked))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / valid.float().sum().clamp_min(1e-12)
