"""HybridParallelOptimizer (``paddle_tpu/distributed/fleet/
hybrid_parallel_optimizer.py`` analog).

At data parallelism the gradients are all-reduced over the dp group
before they are clipped (by the train step, or by ``step()`` here in a
user's own loop), so ``HybridParallelClipGrad`` is the global-norm clip
over gradients that are already the global batch's: its norm is the
global norm. The wrapper keeps the inner optimizer's API (the train step
calls ``apply_gradients`` through it) and its gradient merge over
``strategy.gradient_merge_configs["k_steps"]`` eager steps.
"""

from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm
from ..parallel import grad_buffers


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip over the dp group's reduced gradients."""

    def __init__(self, clip, hcg=None):
        clip_norm = clip.clip_norm if hasattr(clip, "clip_norm") \
            else float(clip)
        super().__init__(clip_norm)
        self._hcg = hcg


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg=None, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy
        self._merge_k = 1
        if strategy is not None and getattr(strategy, "gradient_merge",
                                            False):
            self._merge_k = int(strategy.gradient_merge_configs.get(
                "k_steps", 1))
        self._merge_i = 0
        self._grads = None  # built at the first reduction
        if optimizer._grad_clip is not None and not isinstance(
                optimizer._grad_clip, HybridParallelClipGrad):
            optimizer._grad_clip = HybridParallelClipGrad(
                optimizer._grad_clip, hcg)

    @torch.no_grad()
    def step(self):
        """The eager step: after ``k_steps`` merged backwards, average the
        gradients over the dp group, then the inner optimizer's step
        (which clips)."""
        params = self._inner_opt._params.values()
        if self._merge_k > 1:
            self._merge_i += 1
            if self._merge_i % self._merge_k:
                return None  # keep accumulating (grads live on the params)
            for p in params:
                if p.grad is not None:
                    p.grad.div_(self._merge_k)
        if self._hcg is not None and self._grads is None:
            self._grads = grad_buffers(params,
                                       self._hcg.get_data_parallel_group())
        if self._grads is not None:
            self._grads.reduce()
        return self._inner_opt.step()

    def clear_grad(self, *args, **kwargs):
        if self._merge_k > 1 and self._merge_i % self._merge_k:
            return None  # mid-accumulation: keep grads
        return self._inner_opt.clear_grad(*args, **kwargs)

    def minimize(self, loss, *args, **kwargs):
        loss.backward()
        self.step()
        self.clear_grad()
        return None, None

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)
