"""HybridParallelOptimizer (``paddle_tpu/distributed/fleet/
hybrid_parallel_optimizer.py`` analog).

At data parallelism the gradients are all-reduced over the dp group
before they are clipped (by the train step, or by ``step()`` here in a
user's own loop), so their norm is the global batch's. Under tensor
parallelism a rank holds blocks of the mp-split parameters, and under
ZeRO-2 slices of the gradients, so ``HybridParallelClipGrad`` (and
``hybrid_clip_``, which the train step calls) sums the squares of each
kind where it lives: the mp blocks' over the mp group, each replicated
gradient's once, and ZeRO-2 slices' over the sharding group first; under
expert parallelism a rank holds its ep rank's experts, whose squares are
summed over the ep group. The norm is then the one over the global arrays
that the JAX step computes.
The wrapper keeps the inner optimizer's API (the train step calls
``apply_gradients`` through it) and its gradient merge over
``strategy.gradient_merge_configs["k_steps"]`` eager steps.
"""

from __future__ import annotations

import torch

from ...nn.clip import ClipGradByGlobalNorm
from ..communication import all_reduce
from ..parallel import grad_buffers


@torch.no_grad()
def hybrid_clip_(clip, grads, *, mp_split, sliced, mp_group,
                 sharding_group, ep_split=None, ep_group=None,
                 pp_counted=None, pp_group=None):
    """``clip``'s global-norm clip over ``grads`` held across ranks:
    ``mp_split[i]`` says gradient ``i`` is this rank's block of an
    mp-split parameter (its squares are summed over ``mp_group``),
    ``sliced[i]`` that it is a ZeRO-2 slice (summed over
    ``sharding_group`` first), and ``ep_split[i]`` that it is this ep
    rank's block of an expert stack (summed over ``ep_group`` last). Under
    pipeline parallelism ``pp_counted[i]`` says this stage counts
    gradient ``i`` (its own blocks, and a parameter every stage holds on
    one stage only), and the squares are summed over ``pp_group``. A group
    of None is one rank. Every gradient is scaled in place."""
    dev = grads[0].device if grads else None
    ep_split = ep_split or [False] * len(grads)
    counted = pp_counted or [True] * len(grads)
    sums = torch.zeros(2, 2, 2, dtype=torch.float32, device=dev)
    for g, m, s, e, c in zip(grads, mp_split, sliced, ep_split, counted):
        if c:
            sums[int(e), int(s), int(m)] += g.float().square().sum()
    part = sums[:, 1].clone()
    _sum_over(part, sharding_group)
    whole = sums[:, 0] + part
    split = whole[:, 1:].clone()
    _sum_over(split, mp_group)
    total = whole[:, 0] + split[:, 0]
    if any(ep_split):
        experts = total[1:].clone()
        _sum_over(experts, ep_group)
        sq = total[0] + experts[0]
    else:
        sq = total[0]
    if pp_group is not None:
        sq = sq.clone()
        _sum_over(sq, pp_group)
    norm = torch.sqrt(sq)
    if clip.auto_skip_clip and float(norm) <= clip.clip_norm:
        return
    scale = clip.clip_norm / torch.clamp(norm, min=clip.clip_norm)
    for g in grads:
        g.copy_(g.float() * scale)


def _sum_over(t, group):
    if group is not None:
        all_reduce(t, group=group)


class HybridParallelClipGrad(ClipGradByGlobalNorm):
    """The global-norm clip over the hybrid topology's gradients: dp's
    reduced ones, mp blocks summed over the mp group."""

    def __init__(self, clip, hcg=None, *, params=None):
        clip_norm = clip.clip_norm if hasattr(clip, "clip_norm") \
            else float(clip)
        super().__init__(clip_norm, auto_skip_clip=getattr(
            clip, "auto_skip_clip", False))
        self._hcg = hcg
        self._params = list(params) if params is not None else None

    @torch.no_grad()
    def clip_(self, grads):
        """Clip ``grads`` in place. At an mp degree above 1 they must be
        the gradients of the optimizer's parameters, in order: the
        mp-split ones' squares are summed over the mp group."""
        hcg, params = self._hcg, self._params
        if hcg is None or hcg.get_model_parallel_world_size() == 1:
            return super().clip_(grads)
        if params is None or len(params) != len(grads):
            raise ValueError("HybridParallelClipGrad at mp above 1 clips "
                             "its optimizer's gradients, in order")
        pairs = [(g, p) for g, p in zip(grads, params) if g is not None]
        if pairs:
            hybrid_clip_(self, [g for g, _ in pairs],
                         mp_split=[getattr(p, "mp_dim", None) is not None
                                   and getattr(p, "is_distributed", False)
                                   for _, p in pairs],
                         sliced=[False] * len(pairs),
                         mp_group=hcg.get_model_parallel_group(),
                         sharding_group=hcg.get_sharding_parallel_group())


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
                optimizer._grad_clip, hcg,
                params=list(optimizer._params.values()))

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
