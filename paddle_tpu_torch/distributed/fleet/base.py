"""Fleet strategy. Counterpart of
``paddle_tpu/distributed/fleet/base.py:DistributedStrategy``.

The port keeps the fields the JAX package reads, so a strategy written
for it drives the port unchanged. This slice trains on one GPU:
``unsupported()`` names each toggled field the port cannot run yet with
its ROADMAP item, and ``make_train_step`` raises ``NotImplementedError``
for them. ``gradient_merge`` (micro-batch accumulation) and ``recompute``
(a flag only: remat is ``LlamaConfig.remat``, as in the JAX package) run.
"""
from __future__ import annotations

__all__ = ["DistributedStrategy"]

_MULTI_GPU = "ROADMAP.md, port queue item 4: multi-GPU"
_AMP = "ROADMAP.md, port queue item 10: amp and attention dropout"
_LONG_TAIL = "ROADMAP.md, port queue item 9: long tail"


class DistributedStrategy:
    def __init__(self):
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sep_degree": 1,
        }
        self.sharding = False
        self.sharding_configs = {"sharding_stage": 1, "sharding_degree": 1,
                                 "segment_broadcast_MB": 32}
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0,
                            "use_pure_bf16": False}
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1}
        self.lamb = False
        self.lamb_configs = {"lamb_weight_decay": 0.01,
                             "exclude_from_weight_decay": []}
        self.lars = False
        self.lars_configs = {"lars_coeff": 0.001,
                             "lars_weight_decay": 0.0005, "epsilon": 0.0,
                             "exclude_from_weight_decay": []}
        self.asp = False
        self.dgc = False
        self.dgc_configs = {"momentum": None, "sparsity": 0.99}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4, "begin_step": 1}
        self.a_sync = False
        self.a_sync_configs = {"k_steps": 0}
        self.fp16_allreduce = False
        self.fp16_allreduce_configs = {"dtype": "bfloat16"}
        self.comm_opt = False
        self.comm_opt_configs = {"grad_compress": None, "zero1": False,
                                 "tp_overlap": True, "qblock": 1024}
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1

    @property
    def sharding_stage(self) -> int:
        if not self.sharding and \
                self.hybrid_configs.get("sharding_degree", 1) <= 1:
            return 0
        return int(self.sharding_configs.get("sharding_stage", 1))

    def unsupported(self) -> list:
        """``[(setting, ROADMAP item), ...]`` for what this slice of the
        port cannot run; empty when the strategy fits one GPU."""
        out = [(f"hybrid_configs[{k!r}]={v}", _MULTI_GPU)
               for k, v in self.hybrid_configs.items() if v > 1]
        if self.sharding_stage > 0:
            out.append((f"sharding stage {self.sharding_stage}",
                        _MULTI_GPU))
        for field, item in (("amp", _AMP), ("pipeline", _LONG_TAIL),
                            ("comm_opt", _MULTI_GPU),
                            ("localsgd", _MULTI_GPU), ("dgc", _MULTI_GPU),
                            ("fp16_allreduce", _MULTI_GPU),
                            ("a_sync", _LONG_TAIL), ("lamb", _LONG_TAIL),
                            ("lars", _LONG_TAIL), ("asp", _LONG_TAIL)):
            if getattr(self, field):
                out.append((field, item))
        return out
