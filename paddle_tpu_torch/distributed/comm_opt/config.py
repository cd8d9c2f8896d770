"""Gradient-reduction strategy config, the train step's ``grad_reduce=``
knob (``paddle_tpu/distributed/comm_opt/config.py`` analog).

Pure Python: the port keeps its own copy of the JAX package's module, the
same aliases, defaults and checks.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Optional, Tuple

#: Mesh axes that carry the global batch. The default reduction order goes
#: innermost axis first: `sharding`/`ep` groups are near neighbours, `dp`
#: spans the job.
DATA_AXES = ("dp", "sharding", "ep")
DEFAULT_AXIS_ORDER = ("sharding", "ep", "dp")

#: Non-data mesh axes the hybrid reducer can reduce AROUND: each model
#: shard's data-axis group runs the schedule independently while traffic
#: over these axes is the model's own. Tensor/model parallelism (`mp`) and
#: a non-batch `sharding` axis qualify; `pp`/`sep` do not.
QUANT_COMPATIBLE_AXES = ("mp", "sharding")

_MODES = ("off", "fp32", "quant")
_DTYPES = ("int8", "bf16")

#: string shorthands accepted by normalize_grad_reduce
_ALIASES = {
    "off": {"mode": "off"},
    "none": {"mode": "off"},
    "fp32": {"mode": "fp32"},
    "hierarchical": {"mode": "fp32"},
    "quant": {"mode": "quant", "dtype": "int8"},
    "int8": {"mode": "quant", "dtype": "int8"},
    "bf16": {"mode": "quant", "dtype": "bf16"},
}


@dataclass(frozen=True)
class GradReduceConfig:
    """What ShardedTrainStep does with gradients after backward.

    mode: "off" = the step's own full-precision all-reduce; "fp32" =
        explicit reduce-scatter/all-gather (hierarchical scheduling
        without compression); "quant" = block-scaled compressed reduce
        with error feedback.
    dtype: wire format for mode="quant" — "int8" (block-scaled, ~3.9x)
        or "bf16" (plain downcast, 2x, no scales).
    block_size: elements per int8 scale block.
    error_feedback: carry per-device compression residuals in the train
        state and reintroduce them next step (EF14/DGC semantics). Only
        meaningful for mode="quant"; int8 without it drifts.
    hierarchical: reduce per mesh axis (reduce-scatter over each data
        axis in axis_order, then all-gather back in reverse) instead of
        one flat replica group over all data axes.
    axis_order: reduction axis order; default sharding/ep before dp
        (innermost groups first). Axes missing from the mesh are skipped.
    bucket_bytes: gradient leaves are packed (name-sorted, greedy) into
        buckets of at most this many raw bytes; each bucket reduces as one
        fused vector.
    overlap: with accumulate_steps > 1, reduce each microbatch's grads at
        the microbatch boundary instead of once after accumulation.
    """

    mode: str = "off"
    dtype: str = "int8"
    block_size: int = 128
    error_feedback: bool = True
    hierarchical: bool = True
    axis_order: Optional[Tuple[str, ...]] = None
    bucket_bytes: int = 4 << 20
    overlap: bool = True

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"grad_reduce mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.dtype not in _DTYPES:
            raise ValueError(f"grad_reduce dtype must be one of {_DTYPES}, "
                             f"got {self.dtype!r}")
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        if self.bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1")
        if self.axis_order is not None:
            object.__setattr__(self, "axis_order", tuple(self.axis_order))

    @property
    def active(self) -> bool:
        return self.mode != "off"

    @property
    def quantized(self) -> bool:
        return self.mode == "quant"

    @property
    def wire_bytes_per_value(self) -> float:
        """Wire cost of one f32 gradient value in this format."""
        if self.mode == "quant":
            if self.dtype == "int8":
                return 1.0 + 4.0 / self.block_size
            return 2.0  # bf16
        return 4.0

    def resolved_axis_order(self, mesh_axes) -> Tuple[str, ...]:
        """Reduction order restricted to axes the mesh actually has,
        preferred order first, then any extra data axes appended."""
        present = [a for a in (self.axis_order or DEFAULT_AXIS_ORDER)
                   if a in mesh_axes]
        for a in mesh_axes:
            if a in DATA_AXES and a not in present:
                present.append(a)
        return tuple(present)


def normalize_grad_reduce(value) -> GradReduceConfig:
    """None / str shorthand / dict / GradReduceConfig -> GradReduceConfig."""
    if value is None:
        return GradReduceConfig(mode="off")
    if isinstance(value, GradReduceConfig):
        return value
    if isinstance(value, str):
        try:
            return GradReduceConfig(**_ALIASES[value.lower()])
        except KeyError:
            raise ValueError(
                f"unknown grad_reduce shorthand {value!r}; one of "
                f"{sorted(_ALIASES)} or a dict/GradReduceConfig") from None
    if isinstance(value, dict):
        known = {f.name for f in fields(GradReduceConfig)}
        bad = set(value) - known
        if bad:
            raise ValueError(f"unknown grad_reduce keys {sorted(bad)}; "
                             f"known: {sorted(known)}")
        return GradReduceConfig(**value)
    raise TypeError(f"grad_reduce must be None/str/dict/GradReduceConfig, "
                    f"got {type(value).__name__}")


def from_fleet_strategy(strategy) -> GradReduceConfig:
    """Map the legacy fleet DistributedStrategy compression knobs onto a
    grad_reduce config:

    - strategy.dgc (deep gradient compression: lossy grads + error
      accumulation) -> quantized int8 reduce WITH error feedback — the
      same compress-and-carry-the-residual contract, minus top-k sparsity.
    - strategy.fp16_allreduce (halved-wire all-reduce, no residuals) ->
      quantized bf16 reduce WITHOUT error feedback.
    """
    if getattr(strategy, "dgc", False):
        return GradReduceConfig(mode="quant", dtype="int8",
                                error_feedback=True)
    if getattr(strategy, "fp16_allreduce", False):
        return GradReduceConfig(mode="quant", dtype="bf16",
                                error_feedback=False)
    return GradReduceConfig(mode="off")
