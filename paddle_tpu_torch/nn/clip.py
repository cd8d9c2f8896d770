"""Gradient clipping (``paddle_tpu/nn/clip.py`` analog)."""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``,
    the global norm taken over all of them with the squares summed in fp32.
    ``clip_(grads)`` scales a list of gradients in place, each cast back to
    its dtype, as the train step applies it (``_clip_and_update``)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def clip_(self, grads):
        grads = [g for g in grads if g is not None]
        if grads:
            gsq = sum(g.float().square().sum() for g in grads)
            scale = self.clip_norm / torch.clamp(torch.sqrt(gsq),
                                                 min=self.clip_norm)
            for g in grads:
                g.copy_(g.float() * scale)
