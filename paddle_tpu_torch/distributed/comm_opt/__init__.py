"""Gradient-reduction communication optimizer
(``paddle_tpu/distributed/comm_opt`` analog): quantized (block-scaled
int8, bf16) and hierarchical (per data axis) gradient reductions with
error feedback, selected by the train step's ``grad_reduce=``. ``config``
and ``plan`` are pure Python; ``reduce`` runs the schedule over the
rank's process groups.
"""

from .config import (DATA_AXES, QUANT_COMPATIBLE_AXES,  # noqa: F401
                     GradReduceConfig, from_fleet_strategy,
                     normalize_grad_reduce)
from .plan import ReducePlan, build_plan, describe, plan_as_dict  # noqa: F401
from .reduce import (GradReducer, record_reduce_metrics,  # noqa: F401
                     reducer_for_step)
