"""TrainState: everything a bitwise resume needs, as one tree
(``paddle_tpu/checkpoint/train_state.py`` analog, the same tag).

Params, optimizer state, buffers, the RNG position, the step counter, the
data pipeline's position and any extra leaves (the loss scaler's
automaton, ``scaler_state``; a gradient reducer's error-feedback
residuals, ``grad_reduce_ef``: one ``[world * groups, padded]`` fp32
array per bucket) are checkpointed as one tree under one COMMIT, so a
restored run continues the exact token, dropout and update sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

_TREE_TAG = "paddle_tpu.train_state.v1"


@dataclasses.dataclass
class TrainState:
    """params/opt_state are {name: tensor} / {name: {slot: tensor}} trees
    (the train step's layout); rng is the step's ``{"seed": seed}``;
    data_position is whatever the input pipeline needs to reposition
    itself."""

    params: Dict[str, Any]
    opt_state: Dict[str, Any]
    buffers: Optional[Dict[str, Any]] = None
    rng: Optional[Dict[str, int]] = None
    step: int = 0
    data_position: Any = None
    extra: Optional[Dict[str, Any]] = None

    def to_tree(self) -> Dict[str, Any]:
        """The checkpointable nested-dict form (None fields omitted)."""
        tree: Dict[str, Any] = {
            "__train_state__": _TREE_TAG,
            "step": int(self.step),
            "params": self.params,
            "opt_state": self.opt_state,
        }
        for name in ("buffers", "rng", "data_position", "extra"):
            v = getattr(self, name)
            if v is not None:
                tree[name] = v
        return tree

    @classmethod
    def from_tree(cls, tree: Dict[str, Any]) -> "TrainState":
        if tree.get("__train_state__") != _TREE_TAG:
            raise ValueError(
                "checkpoint tree is not a TrainState (missing/foreign "
                f"'__train_state__' tag: {tree.get('__train_state__')!r})")
        return cls(
            params=tree["params"],
            opt_state=tree["opt_state"],
            buffers=tree.get("buffers"),
            rng=tree.get("rng"),
            step=int(tree["step"]),
            data_position=tree.get("data_position"),
            extra=tree.get("extra"),
        )

    def shardings_like(self, param_shardings=None, state_shardings=None
                       ) -> Dict[str, Any]:
        """A shardings tree aligned with ``to_tree()``: params/opt_state
        get the supplied layouts, which ``restore`` honours (each rank's
        block of a sharded one)."""
        out: Dict[str, Any] = {}
        if param_shardings is not None:
            out["params"] = param_shardings
        if state_shardings is not None:
            out["opt_state"] = state_shardings
        return out


def is_train_state_tree(tree) -> bool:
    return isinstance(tree, dict) and tree.get("__train_state__") == _TREE_TAG
