"""Gradient clipping (``paddle_tpu/nn/clip.py`` analog)."""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all of them with the squares summed in fp32.
    ``clip_(grads)`` scales a list of gradients in place, each cast back to
    its dtype, as the train step applies it (``_clip_and_update``).

    ``group_name`` names the gradient group, as in paddle (the port clips
    one group). ``auto_skip_clip=True`` leaves the gradients untouched when
    the global norm is within ``clip_norm``; the scale is then exactly 1,
    so the values are the same either way, but skipping costs one host
    read of the norm per call."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name
        self.auto_skip_clip = bool(auto_skip_clip)

    @torch.no_grad()
    def clip_(self, grads):
        grads = [g for g in grads if g is not None]
        if grads:
            gsq = sum(g.float().square().sum() for g in grads)
            norm = torch.sqrt(gsq)
            if self.auto_skip_clip and float(norm) <= self.clip_norm:
                return
            scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
            for g in grads:
                g.copy_(g.float() * scale)
