"""Pipeline layer description and partitioning (``paddle_tpu/distributed/
fleet/meta_parallel/pp_layers.py`` analog).

``LayerDesc`` defers a layer's construction, ``SegmentLayers`` cuts the
list of descs into stages (``uniform``, or ``layer:<Name>`` to spread the
layers of one class evenly), and ``PipelineLayer`` builds only this
rank's segment across processes, as the Paddle reference's does
(``pp_layers.py:240``); the JAX package, single-controller, builds every
stage. Sublayers are named by their global index, so the names match the
JAX layer's. A ``SharedLayerDesc`` layer (tied weights) is built on every
stage that uses it and registered under the index of its first use
everywhere, its name in the JAX layer; its gradient is summed over those
stages (``shared_groups``), the reference's shared-weight group, where the
JAX package ties for free.

With ``num_virtual_pipeline_stages=v`` the descs are cut into ``pp * v``
chunks and rank ``d`` builds chunks ``r * pp + d`` (the interleaved
assignment of ``PipelineParallelWithInterleave``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn


class LayerDesc:
    """Deferred layer construction (pp_layers.py:56)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError(f"LayerDesc expects a Layer subclass, got "
                            f"{layer_cls}")

    def build_layer(self) -> nn.Module:
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A weight-tied layer appearing in several stages (pp_layers.py:78),
    e.g. tied embeddings; ``forward_func(layer, x)`` replaces its forward
    where given."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Partition N layer descs into ``num_parts`` stages (pp_layers.py:92)."""

    def __init__(self, layers_desc, num_parts: int, method: str = "uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError(f"{len(layers_desc)} layers cannot fill "
                             f"{num_parts} stages")

    def do_segment(self) -> List[int]:
        n = len(self.descs)
        if self.method == "uniform":
            return self.uniform(n, self.num_parts)
        if self.method.startswith("layer:"):
            # segment so layers of the named class are evenly spread
            name = self.method.split(":", 1)[1]
            weights = [1 if type(d).__name__ == name or getattr(
                d, "layer_cls", type(None)).__name__ == name else 0
                for d in self.descs]
            total = sum(weights)
            if total == 0:
                return self.uniform(n, self.num_parts)
            per = total / self.num_parts
            bounds, acc, target = [0], 0.0, per
            for i, w in enumerate(weights):
                acc += w
                if acc >= target and len(bounds) < self.num_parts:
                    bounds.append(i + 1)
                    target += per
            bounds += [n] * (self.num_parts + 1 - len(bounds))
            bounds[-1] = n
            return bounds
        raise ValueError(f"unknown seg_method {self.method}")

    @staticmethod
    def uniform(num_items: int, num_parts: int) -> List[int]:
        return [int(round(i * num_items / num_parts))
                for i in range(num_parts + 1)]


class PipelineLayer(nn.Module):
    """A stage-partitioned sequential model (pp_layers.py:240): ``layers``
    is a list of ``LayerDesc``, modules or callables run in order; this
    rank builds and runs the descs of its segment (all of them when the
    topology has no pp axis). ``device`` (keyword-only) is where the built
    layers are moved."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn: Optional[Callable] = None,
                 seg_method: str = "uniform", recompute_interval: int = 0, *,
                 num_virtual_pipeline_stages: int = 1, device=None,
                 **kwargs):
        super().__init__()
        from ...topology import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if num_stages is None:
            num_stages = hcg.get_pipe_parallel_world_size() \
                if hcg is not None else 1
        self.num_stages = num_stages
        self.num_virtual_pipeline_stages = v = int(num_virtual_pipeline_stages)
        self.loss_fn = loss_fn
        self.recompute_interval = recompute_interval
        self._descs = list(layers)
        self.segment_bounds = SegmentLayers(self._descs, num_stages * v,
                                            seg_method).do_segment()
        stage = hcg.get_stage_id() if hcg is not None and num_stages > 1 \
            else None
        self._stage = stage
        chunks = range(num_stages * v) if stage is None \
            else [r * num_stages + stage for r in range(v)]
        self._local = [i for c in chunks for i in range(
            self.segment_bounds[c], self.segment_bounds[c + 1])]
        first = {}
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                first.setdefault(d.layer_name, i)
        self._shared_first = first
        shared = {}
        built = []
        for i in self._local:
            d = self._descs[i]
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in shared:
                    shared[d.layer_name] = d.build_layer()
                    self.add_module(str(first[d.layer_name]),
                                    shared[d.layer_name])
                built.append((shared[d.layer_name], d.forward_func))
                continue
            sub = d.build_layer() if isinstance(d, LayerDesc) else d
            if isinstance(sub, nn.Module):
                self.add_module(str(i), sub)
            built.append((sub, None))
        self.run_function = built
        self._shared_instances = shared
        if device is not None:
            self.to(device)

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return torch.device("cpu")

    def stage_of_index(self, idx: int) -> int:
        """The stage whose segment holds desc ``idx``."""
        n = self.num_stages
        for c in range(n * self.num_virtual_pipeline_stages):
            if self.segment_bounds[c] <= idx < self.segment_bounds[c + 1]:
                return c % n
        return n - 1

    def stage_layers(self, stage: int):
        """Stage ``stage``'s layers and their forward functions: this
        rank's only."""
        if self._stage is not None and stage != self._stage:
            raise ValueError(f"this rank builds stage {self._stage}'s "
                             f"layers, not stage {stage}'s")
        if self._stage is None and self.num_virtual_pipeline_stages == 1:
            lo, hi = self.segment_bounds[stage], self.segment_bounds[stage + 1]
            return [self.run_function[self._local.index(i)]
                    for i in range(lo, hi)]
        return list(self.run_function)

    def chunk_layers(self, chunk: int):
        """Global chunk ``chunk``'s layers and their forward functions (a
        chunk this rank builds)."""
        lo, hi = self.segment_bounds[chunk], self.segment_bounds[chunk + 1]
        if any(i not in self._local for i in range(lo, hi)):
            raise ValueError(f"this rank does not build chunk {chunk}")
        return [self.run_function[self._local.index(i)]
                for i in range(lo, hi)]

    def stage_params(self, stage: int):
        out = []
        for sub, _ in self.stage_layers(stage):
            if isinstance(sub, nn.Module):
                out.extend(p for _, p in sub.named_parameters())
        return out

    def forward(self, x, stage: Optional[int] = None, *,
                chunk: Optional[int] = None):
        seq = self.chunk_layers(chunk) if chunk is not None \
            else self.run_function if stage is None \
            else self.stage_layers(stage)
        for i, (sub, fwd) in enumerate(seq):
            if fwd is not None:
                x = fwd(sub, x)
            elif self.recompute_interval and isinstance(sub, nn.Module) \
                    and i % self.recompute_interval == 0:
                from ..recompute import recompute

                x = recompute(sub, x)
            else:
                x = sub(x)
        return x

    def _shared_stages(self):
        """``{key: stages}`` of each shared layer, in key order."""
        out = {}
        for i, d in enumerate(self._descs):
            if isinstance(d, SharedLayerDesc):
                out.setdefault(d.layer_name, set()).add(self.stage_of_index(i))
        return {k: sorted(v) for k, v in sorted(out.items())}

    def shared_groups(self, hcg):
        """``[(parameters, group)]``: each shared layer this rank holds and
        the group over the stages using it (collective: every rank builds
        every group, in one order; a layer on one stage needs none)."""
        from ...collective import group_of

        out = []
        if hcg is None or self.num_stages == 1:
            return out
        mesh = hcg.get_mesh()
        me = hcg.get_global_rank()
        for key, stages in self._shared_stages().items():
            if len(stages) < 2:
                continue
            for ranks in mesh.groups_along(("pp",)):
                g = group_of([ranks[s] for s in stages], mesh, None,
                             name=f"shared_{key}")
                if me in g.ranks and key in self._shared_instances:
                    out.append((list(self._shared_instances[key]
                                     .parameters()), g))
        return out

    def owned_parameters(self, hcg) -> set:
        """``id``s of the parameters whose squares this stage counts in a
        global norm: all but a shared layer's off the first stage using
        it."""
        stage = hcg.get_stage_id() if hcg is not None else 0
        first = self._shared_stages()
        skip = {id(p) for k, lay in self._shared_instances.items()
                if first[k][0] != stage for p in lay.parameters()}
        return {id(p) for p in self.parameters() if id(p) not in skip}

    def pipeline_spec(self):
        """The ``PipelineSpec`` of a homogeneous stack (same class, same
        parameter shapes, no ``SharedLayerDesc`` forward functions) for the
        train step's pp path: ``pre`` passes the input through, each block
        is a layer, ``post_loss`` is ``loss_fn``."""
        from .pipeline_parallel import PipelineSpec

        layers = [sub for sub, _ in self.run_function]
        if any(fwd is not None for _, fwd in self.run_function):
            raise NotImplementedError(
                "compiled pipeline needs plain layers (SharedLayerDesc "
                "forward_funcs are host-driven only)")
        first = layers[0]
        shapes0 = {k: tuple(v.shape) for k, v in first.state_dict().items()}
        for lay in layers[1:]:
            if type(lay) is not type(first) or {
                    k: tuple(v.shape) for k, v in lay.state_dict().items()
            } != shapes0:
                raise NotImplementedError(
                    "compiled pipeline needs a homogeneous layer stack "
                    f"({type(first).__name__} vs {type(lay).__name__})")
        if self.loss_fn is None:
            raise ValueError("PipelineLayer needs loss_fn for the compiled "
                             "pipeline's last stage")
        loss_fn = self.loss_fn

        def post_loss(h, y):
            return loss_fn(h, y).float()

        return PipelineSpec(block_prefix="", n_blocks=len(self._descs),
                            pre=lambda x: x, block=lambda layer, h: layer(h),
                            post_loss=post_loss)
