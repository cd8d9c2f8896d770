"""DistributedStrategy (``paddle_tpu/distributed/fleet/
distributed_strategy.py`` analog): a plain config object that
``fleet.init`` reads. Setting ``hybrid_configs`` merges into the
defaults, as paddle's does."""

from __future__ import annotations


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
            "ep_degree": 1,
        }
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1, "schedule": "1F1B"}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_bf16": False, "custom_white_list": [],
                            "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.sharding = False
        self.sharding_configs = {"stage": 1, "offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001, "lars_weight_decay": 0.0005,
                             "epsilon": 1e-9, "exclude_from_weight_decay": []}
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.fp16_allreduce = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.tensor_parallel_configs = {"tensor_init_seed": -1}
        # auto_plan: the cost-model planner picks hybrid_configs at
        # fleet.init (ROADMAP queue A item A7 in the port)
        self.auto_plan = False
        self.auto_plan_configs = {}

    def __setattr__(self, key, value):
        if key == "hybrid_configs" and hasattr(self, "hybrid_configs"):
            merged = dict(self.__dict__["hybrid_configs"])
            merged.update(value)
            self.__dict__[key] = merged
        else:
            self.__dict__[key] = value

    def __repr__(self):
        return f"DistributedStrategy(hybrid={self.hybrid_configs})"
