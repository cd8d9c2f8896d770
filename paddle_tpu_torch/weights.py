"""Weight conversion from ``paddle_tpu`` parameters to a PyTorch state dict.

The port keeps the JAX package's parameter names and its ``[in, out]``
linear layout, so conversion is a name-for-name copy with no transposes.
The input is the dict ``model.functional_state()[0]`` gives, converted to
numpy by the caller (this module imports no JAX).

For a model split over ``mp_degree`` ranks, ``from_paddle_tpu(params,
mp_rank=r, mp_degree=n)`` gives rank ``r``'s blocks (``mp_layout``): the
vocabulary rows of the embedding, the column-parallel weights' columns
(the qkv projection's by head: rank ``r``'s heads of each of its q, k and
v thirds, not the contiguous column chunk a ``P(None, 'mp')`` placement
gives a device in the JAX package), the row-parallel weights' rows; the
rest whole. ``to_paddle_tpu`` assembles the global arrays from every
rank's blocks.

For a GPT-MoE model split over ``ep_degree`` expert-parallel ranks,
``from_paddle_tpu(params, ep_rank=r, ep_degree=n)`` gives rank ``r``'s
block of dim 0 of each expert stack (``mlp.w1``, ``b1``, ``w2``, ``b2``:
its ``E/n`` experts) and every other parameter whole; ``to_paddle_tpu``
joins the stacks of every ep rank's dict, or gathers them over a model's
ep group (collective) when given the model. A MoE block is whole on every
rank of an mp group (the JAX package places its stacks over ``ep`` only),
so on an ep x mp mesh ``from_paddle_tpu(..., mp_rank=, mp_degree=,
ep_rank=, ep_degree=)`` gives a rank both, and ``to_paddle_tpu(blocks,
mp_degree=m)`` joins the dicts of every rank in rank order (ep major, mp
minor).

For a model split over ``pp_degree`` pipeline stages,
``from_paddle_tpu(params, pp_rank=r, pp_degree=n, virtual_pp_degree=v)``
gives stage ``r``'s blocks (those of chunks ``k * n + r``, chunk ``j``
being blocks ``[j * L/(n*v), (j+1) * L/(n*v))``) and every other
parameter, from flat names or from the JAX pp step's stacked ones
(``gpt.layers.__stacked__.<suffix>``, ``[pp, L/pp, ...]`` or
``[pp, v, L/(pp*v), ...]``); ``to_paddle_tpu(dicts, pp_degree=n)`` joins
the stages' dicts (in rank order, pp outermost) back to the flat names.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from .distributed.sharding_utils import assemble, local_block

_EMBED = ("gpt.embeddings.word_embeddings.weight",
          "gpt.embeddings.position_embeddings.weight")
_LAYER = ("ln1.weight", "ln1.bias", "attn.qkv.weight", "attn.qkv.bias",
          "attn.proj.weight", "attn.proj.bias", "ln2.weight", "ln2.bias")
_DENSE_MLP = ("mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
              "mlp.fc2.bias")
_MOE_MLP = ("mlp.gate_weight", "mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2")
#: the expert stacks, split over ep along dim 0
_EXPERT_STACKS = _MOE_MLP[1:]
_FINAL = ("gpt.final_ln.weight", "gpt.final_ln.bias")
_HEAD = "lm_head.weight"
_LAYER_RE = re.compile(r"^gpt\.layers\.(\d+)\.")
_STACKED = "gpt.layers.__stacked__."


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor copy of ``a``; an ``ml_dtypes`` bfloat16 array (as the
    JAX package makes them) is read through its 2-byte words."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from JAX
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def expected_names(num_layers: int, tied: bool = True, moe_layers=()):
    """The GPT's parameter names for ``num_layers`` blocks, those in
    ``moe_layers`` with the MoE FFN's set (``mlp.gate_weight``,
    ``mlp.w1``, ``mlp.b1``, ``mlp.w2``, ``mlp.b2``), the rest with the
    dense FFN's."""
    names = list(_EMBED)
    for i in range(num_layers):
        mlp = _MOE_MLP if i in moe_layers else _DENSE_MLP
        names += [f"gpt.layers.{i}.{n}" for n in _LAYER + mlp]
    names += list(_FINAL)
    if not tied:
        names.append(_HEAD)
    return names


#: (split dimension, column-parallel or not) of each mp-split weight
_MP_SPLIT = {"attn.qkv.weight": 1, "attn.qkv.bias": 0, "attn.proj.weight": 0,
             "mlp.fc1.weight": 1, "mlp.fc1.bias": 0, "mlp.fc2.weight": 0}


def mp_layout(name: str, shapes: Dict[str, tuple]):
    """``(dim, segments)`` of GPT parameter ``name`` split over mp, or None
    for a parameter every rank holds whole. ``shapes`` maps names to
    shapes (the qkv projection's q | k | v segments come from its and the
    attention projection's)."""
    if name == _EMBED[0]:
        return 0, None
    if name == _HEAD:
        return 1, None
    m = _LAYER_RE.match(name)
    if not m:
        return None
    suffix = name[m.end():]
    if suffix not in _MP_SPLIT:
        return None
    segments = None
    if suffix.startswith("attn.qkv"):
        q = shapes[f"{m.group(0)}attn.proj.weight"][0]
        kv = (shapes[name][-1] - q) // 2
        segments = (q, kv, kv)
    return _MP_SPLIT[suffix], segments


def expert_stack(name: str) -> bool:
    """Whether GPT parameter ``name`` is an expert stack (split over
    ep)."""
    m = _LAYER_RE.match(name)
    return bool(m) and name[m.end():] in _EXPERT_STACKS


def _gathered_state(model):
    """``model.state_dict()`` with each ep-split expert stack gathered
    over its block's ep group (collective)."""
    from .distributed.communication import gather_along

    sd = model.state_dict()
    inner = model  # fleet's and ZeRO's wrappers give the inner names
    while isinstance(getattr(inner, "_layers", None), torch.nn.Module):
        inner = inner._layers
    for name, mod in inner.named_modules():
        groups = getattr(mod, "groups", None)
        if groups is None or groups.ep.nranks == 1 \
                or not hasattr(mod, "w1"):
            continue
        for k in ("w1", "b1", "w2", "b2"):
            key = f"{name}.{k}" if name else k
            sd[key] = gather_along(sd[key].contiguous(), groups.ep, 0)
    return sd


def to_paddle_tpu(blocks, *, mp_degree: int = None, pp_degree: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """The global arrays (CPU tensors, under the JAX package's names and
    layout) from every rank's state dict, in rank order: the inverse of
    ``from_paddle_tpu(..., mp_rank=r, mp_degree=len(blocks))``, or, where
    the dicts hold expert stacks, of ``from_paddle_tpu(..., ep_rank=r,
    ep_degree=len(blocks))``; with ``mp_degree`` the dicts are an ep x mp
    mesh's in rank order (ep major, mp minor), each taking both. A model
    (or a list of them) stands for its ``state_dict()``: a ZeRO stage-3
    model's gathers its slices (collective over its sharding group), an
    ep-split GPT-MoE model's its expert stacks (collective over its ep
    group)."""
    if isinstance(blocks, torch.nn.Module):
        blocks = [blocks]
    if pp_degree > 1:  # each stage's dicts joined, then the stages
        n = len(blocks) // pp_degree
        out = {}
        for s in range(pp_degree):
            out.update(to_paddle_tpu(blocks[s * n:(s + 1) * n],
                                     mp_degree=mp_degree))
        return out
    blocks = [_gathered_state(b) if isinstance(b, torch.nn.Module) else b
              for b in blocks]
    blocks = [{k: torch.as_tensor(v).detach().cpu() for k, v in b.items()}
              for b in blocks]
    n = len(blocks)
    if n == 1:
        return {k: v.clone() for k, v in blocks[0].items()}
    if mp_degree is None:
        mp_degree = 1 if any(expert_stack(k) for k in blocks[0]) else n
    if n % mp_degree:
        raise ValueError(f"{n} rank dicts do not fill an mp degree of "
                         f"{mp_degree}")
    ep = [blocks[e * mp_degree] for e in range(n // mp_degree)]
    mp = blocks[:mp_degree]
    whole = {k: tuple(v.shape) for k, v in mp[0].items()}
    for k, layout in ((k, mp_layout(k, whole)) for k in whole):
        if layout is not None:
            d = layout[0]
            whole[k] = whole[k][:d] + (whole[k][d] * mp_degree,) \
                + whole[k][d + 1:]
    out = {}
    for k in blocks[0]:
        layout = mp_layout(k, whole)
        if expert_stack(k):
            out[k] = torch.cat([b[k] for b in ep])
        elif layout is None or mp_degree == 1:
            out[k] = blocks[0][k].clone()
        else:
            out[k] = assemble([b[k] for b in mp], *layout)
    return out


def from_paddle_tpu(params: Dict[str, np.ndarray], *, mp_rank: int = 0,
                    mp_degree: int = 1, ep_rank: int = 0,
                    ep_degree: int = 1, pp_rank: int = 0, pp_degree: int = 1,
                    virtual_pp_degree: int = 1) -> Dict[str, torch.Tensor]:
    """Convert a ``paddle_tpu`` GPT parameter dict (numpy values) into a
    state dict for ``paddle_tpu_torch.models.gpt.GPTForCausalLM``; with
    ``mp_degree`` above 1, rank ``mp_rank``'s blocks of it (``mp_layout``);
    with ``ep_degree`` above 1, ep rank ``ep_rank``'s block of dim 0 of
    each expert stack; with ``pp_degree`` above 1, stage ``pp_rank``'s
    blocks only (``pipeline_parallel.stage_chunks``). The JAX pp step's
    stacked names, saved at ``virtual_pp_degree``, are read as the flat
    ones (``pipeline_parallel.unstack_block_params``).
    dtypes are kept. The block count, and which blocks hold the MoE FFN
    (those with an ``mlp.gate_weight``), are read from the names; a name
    missing from that structure, or one outside it (a block mixing the
    dense and the MoE set among them), raises ``KeyError``."""
    from .distributed.fleet.meta_parallel.pipeline_parallel import (
        PipelineSpec, stage_chunks, unstack_block_params)

    stacked = {n[len(_STACKED):]: np.asarray(a) for n, a in params.items()
               if n.startswith(_STACKED)}
    if stacked:  # the JAX pp step's names, saved at virtual_pp_degree
        params = {n: a for n, a in params.items()
                  if not n.startswith(_STACKED)}
        params.update(unstack_block_params(
            stacked, PipelineSpec("gpt.layers", 0, None, None, None),
            virtual_stages=virtual_pp_degree))
    layers = [int(m.group(1)) for m in map(_LAYER_RE.match, params) if m]
    num_layers = max(layers) + 1 if layers else 0
    moe = {i for i in range(num_layers)
           if f"gpt.layers.{i}.mlp.gate_weight" in params}
    want = expected_names(num_layers, tied=_HEAD not in params,
                          moe_layers=moe)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise KeyError(f"from_paddle_tpu: missing {missing[:6]}, "
                       f"unexpected {extra[:6]}")
    if pp_degree > 1:
        mine = {i for ch in stage_chunks(num_layers, pp_rank, pp_degree,
                                         virtual_pp_degree) for i in ch}
        want = [n for n in want if (m := _LAYER_RE.match(n)) is None
                or int(m.group(1)) in mine]
    out = {name: to_torch(np.asarray(params[name])) for name in want}
    if ep_degree > 1:
        for name in want:
            if expert_stack(name):
                out[name] = local_block(out[name], 0, ep_rank,
                                        ep_degree).contiguous()
    if mp_degree == 1:
        return out
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    for name in want:
        layout = mp_layout(name, shapes)
        if layout is not None:
            out[name] = local_block(out[name], layout[0], mp_rank, mp_degree,
                                    layout[1]).contiguous()
    return out
