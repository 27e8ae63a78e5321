"""Fleet strategy and topology. Counterpart of
``paddle_tpu/distributed/fleet/base.py`` (``DistributedStrategy``,
``HybridCommunicateGroup``).

The port keeps the fields the JAX package reads, so a strategy written
for it drives the port unchanged. ``dp_degree``, ``mp_degree``,
``sharding_degree``, sharding stages 1-3, and ``sep_degree`` and
``pp_degree`` (each alone or with dp) run (``fleet.init`` builds the
mesh and its process groups); ``unsupported()`` names each toggled field
the port cannot run yet with its ROADMAP item, and ``fleet.init`` and
``make_train_step`` raise ``NotImplementedError`` for them. ``sep_degree``
or ``pp_degree`` beside sharding or tensor parallel (or each other) is
among them: the JAX package's partial-manual ``shard_map`` guard refuses
it (``mesh.sep_guard``, ``mesh.pp_guard``). ``gradient_merge``
(micro-batch accumulation), ``pipeline`` (its ``accumulate_steps``
become the train step's, as in the JAX package; the micro-batches of the
pipeline schedule are the model's ``n_micro``) and ``recompute`` (a flag
only: remat is ``LlamaConfig.remat``, as in the JAX package) run. So do
the comm-efficient data-parallel strategies, one at a time
(``comm_modes()``): ``comm_opt``, ``a_sync`` (geo, ``k_steps`` >= 1),
``localsgd``, ``dgc`` and ``fp16_allreduce``, each with its own train
step (``fleet.distributed_optimizer(...).make_train_step``). ``amp``
runs the ordinary step under O1 (``make_train_step`` passes
``amp_level="O1"``), as in the JAX package; beside a comm-efficient
strategy it is refused, as there.
"""
from __future__ import annotations

from .. import mesh as mesh_mod

__all__ = ["DistributedStrategy", "HybridCommunicateGroup", "COMM_MODES"]

#: the comm-efficient data-parallel strategies, as the JAX package lists them
COMM_MODES = ("localsgd", "dgc", "fp16_allreduce", "a_sync", "comm_opt")

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
        """``[(setting, ROADMAP item), ...]`` for what the port cannot run
        yet; empty when the strategy is dp / sharding stages 1-3 / tp, or
        sep or pp with dp, with or without a comm-efficient strategy or
        ``amp``."""
        hc = self.hybrid_configs
        out = []
        m = mesh_mod.Mesh(pp=max(1, hc.get("pp_degree", 1)),
                          sharding=max(1, hc.get("sharding_degree", 1)),
                          sep=max(1, hc.get("sep_degree", 1)),
                          tp=max(1, hc.get("mp_degree", 1)))
        for key, guard in (("sep_degree", mesh_mod.sep_guard),
                           ("pp_degree", mesh_mod.pp_guard)):
            try:
                guard(m)
            except NotImplementedError as e:
                out.append((f"hybrid_configs[{key!r}]={hc[key]}", str(e)))
        if self.sharding_stage not in (0, 1, 2, 3):
            raise ValueError(f"sharding_stage {self.sharding_stage}; want "
                             "1, 2 or 3")
        for field, item in (("lamb", _LONG_TAIL), ("lars", _LONG_TAIL),
                            ("asp", _LONG_TAIL)):
            if getattr(self, field):
                out.append((field, item))
        return out

    def comm_modes(self) -> list:
        """The comm-efficient strategies switched on, in the JAX
        package's order; ``make_train_step`` refuses more than one."""
        return [m for m in COMM_MODES if getattr(self, m, False)]

    def check(self):
        """Raise ``NotImplementedError`` naming what ``unsupported()``
        lists."""
        bad = self.unsupported()
        if bad:
            raise NotImplementedError(
                "this strategy needs what the port does not run yet: "
                + "; ".join(f"{s} ({item})" for s, item in bad))


class HybridCommunicateGroup:
    """The strategy's mesh with this rank's coordinates and groups
    (reference ``fleet/base/topology.py``). Building it builds the
    mesh's process groups, so every rank of the world builds it."""

    def __init__(self, strategy: DistributedStrategy, mesh=None):
        hc = strategy.hybrid_configs
        if mesh is None:
            mesh = mesh_mod.build_mesh(
                dp=max(1, hc.get("dp_degree", 1)),
                tp=max(1, hc.get("mp_degree", 1)),
                pp=max(1, hc.get("pp_degree", 1)),
                sharding=max(1, hc.get("sharding_degree", 1)),
                sep=max(1, hc.get("sep_degree", 1)))
            mesh.init_groups()
        self.mesh = mesh
        mesh_mod.set_mesh(mesh)

    def _rank(self, axis):
        return self.mesh.coords[axis] if self.mesh.coords else -1

    # degrees (reference names)
    def get_data_parallel_world_size(self):
        return self.mesh.shape["dp"]

    def get_model_parallel_world_size(self):
        return self.mesh.shape["tp"]

    def get_pipe_parallel_world_size(self):
        return self.mesh.shape["pp"]

    def get_sharding_parallel_world_size(self):
        return self.mesh.shape["sharding"]

    def get_sep_parallel_world_size(self):
        return self.mesh.shape["sep"]

    # this rank's coordinates
    def get_data_parallel_rank(self):
        return self._rank("dp")

    def get_model_parallel_rank(self):
        return self._rank("tp")

    def get_sharding_parallel_rank(self):
        return self._rank("sharding")

    def get_stage_id(self):
        return self._rank("pp")

    def get_pipe_parallel_rank(self):
        return self._rank("pp")

    # groups
    def get_data_parallel_group(self):
        return self.mesh.group("dp")

    def get_model_parallel_group(self):
        return self.mesh.group("tp")

    def get_sharding_parallel_group(self):
        return self.mesh.group("sharding")

    def get_pipe_parallel_group(self):
        return self.mesh.group("pp")

    def topology(self):
        return self.mesh
