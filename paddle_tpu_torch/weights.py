"""Weight conversion from ``paddle_tpu`` parameters to a PyTorch state dict.

The port keeps the JAX package's parameter names and its ``[in, out]``
linear layout, so conversion is a name-for-name copy with no transposes.
The input is the dict ``model.functional_state()[0]`` gives, converted to
numpy by the caller (this module imports no JAX).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_EMBED = ("gpt.embeddings.word_embeddings.weight",
          "gpt.embeddings.position_embeddings.weight")
_LAYER = ("ln1.weight", "ln1.bias", "attn.qkv.weight", "attn.qkv.bias",
          "attn.proj.weight", "attn.proj.bias", "ln2.weight", "ln2.bias")
_DENSE_MLP = ("mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight",
              "mlp.fc2.bias")
_MOE_MLP = ("mlp.gate_weight", "mlp.w1", "mlp.b1", "mlp.w2", "mlp.b2")
_FINAL = ("gpt.final_ln.weight", "gpt.final_ln.bias")
_HEAD = "lm_head.weight"
_LAYER_RE = re.compile(r"^gpt\.layers\.(\d+)\.")


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


def from_paddle_tpu(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Convert a ``paddle_tpu`` GPT parameter dict (numpy values) into a
    state dict for ``paddle_tpu_torch.models.gpt.GPTForCausalLM``. dtypes
    are kept. The block count, and which blocks hold the MoE FFN (those
    with an ``mlp.gate_weight``), are read from the names; a name missing
    from that structure, or one outside it (a block mixing the dense and
    the MoE set among them), raises ``KeyError``."""
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
    return {name: to_torch(np.asarray(params[name])) for name in want}
