"""Comm-efficient data-parallel training with error feedback and ZeRO-1.
Counterpart of ``paddle_tpu/distributed/comm_opt.py``
(``CommOptTrainStep``, ``global_comm_stats``).

The JAX package compiles one ``shard_map`` program over the ``(dp, tp)``
mesh. Here each rank runs its part SPMD over ``torch.distributed``, the
collectives written out on the mesh's dp group:

* **Quantized gradient exchange with error feedback.** The flat gradient
  ``[n_pad]`` plus the residual ``e1`` is cut into ``dp`` chunks,
  quantized (``grad_compress="int8"``: blockwise int8, one fp32 scale per
  ``qblock`` elements; ``"bf16"``: a cast), sent by one all-to-all, and
  each rank averages its chunk from every rank's dequantized rows. What
  the quantizer dropped (``c - sent``) is the next ``e1``. Without
  ZeRO-1 the averaged chunk (plus ``e2``) is quantized again and
  all-gathered, and ``e2`` keeps what that dropped. ``grad_compress=None``
  is a reduce-scatter and an all-gather in fp32.
* **ZeRO-1.** Each rank owns chunk ``dp_index`` of the flat optimizer
  state, updates only its slice of the flat parameters with the averaged
  chunk, and the updated parameters are all-gathered (in place of the
  gradient all-gather).
* **One flat update.** With an elementwise optimizer of uniform
  hyperparameters (SGD, Momentum, Adam, AdamW without
  ``apply_decay_param_fun``) the replicated arm also updates the flat
  vector, with the same function on the same values, so ZeRO-1's
  parameters are bitwise equal to it. The flat vector is the parameters
  cast to fp32 each step and its state is built from an fp32 vector, so
  it keeps no fp32 master copy of a bf16 parameter (as in the JAX
  package). Other optimizers update parameter by parameter.

Under ``mp_degree > 1`` only the weights of ``ColumnParallelLinear`` and
``RowParallelLinear`` are tp-sharded, as in the JAX package; every other
parameter (all of Llama's) is whole on every tp rank
(``placement.place_model(..., whole=True)``). ``tp_overlap`` changes how
the JAX package computes its tp matmuls (ppermute rings), not what: the
port's ``mp_layers`` compute the dot and then the collective for either
value, and ``comm_stats()`` records the flag.

Snapshots: ``state_dict()`` is this rank's state in the JAX package's
keys; ``load_state_dict`` takes a state of this rank's layout, or every
rank's (a ``distributed.checkpoint.RankStates``, or the JAX package's
``[dp, tp, ...]`` layout that ``gathered_state`` gives) and then restores
across dp degrees as the JAX package does: the flat owner-sharded moments
and ``e2`` keep their positions (padding rebuilt), the scalar
accumulators are replicated, the per-replica ``e1`` residuals are summed
into replica 0. A step abandoned by its supervisor (``framework.attempt``)
drops its in-place writes.

Scope: ``(dp, tp)`` meshes; sharding/pp/sep degrees, gradient clipping,
AMP and gradient accumulation are refused or stay on ``TrainStep``.
"""
from __future__ import annotations

import weakref
from typing import Callable, Optional

import numpy as np
import torch

from ..framework import attempt
from ..observability.metrics import Counter
from . import collective as C
from . import mesh as mesh_mod
from .fleet.comm_efficient import (_dequant_blocks, _flatten_by,
                                   _quant_blocks, _ReplicaStep,
                                   _unflatten_by)

__all__ = ["CommOptTrainStep", "global_comm_stats"]

#: dp-exchange payload bytes by collective op and wire dtype, counted on
#: the host per step from the static byte plan (the exchange geometry is
#: fixed at construction, so no device work is added)
COLLECTIVE_BYTES = Counter(
    "paddle_collective_bytes_total",
    "gradient-exchange payload bytes by collective op and wire dtype",
    labelnames=("op", "dtype"))

#: live steps, for ``global_comm_stats``
_LIVE_STEPS: "weakref.WeakSet[CommOptTrainStep]" = weakref.WeakSet()

#: optimizers whose update is elementwise with uniform hyperparameters —
#: the precondition for the flat ZeRO-1 shard update being bitwise equal
#: to the replicated flat update
_ZERO1_OPTIMIZERS = ("SGD", "Momentum", "Adam", "AdamW")


class CommOptTrainStep(_ReplicaStep):
    """Comm-optimized DP(/TP) train step.

    ``loss_fn(model, *batch) -> scalar loss``; batch tensors split their
    leading dim over dp (it must divide). ``grad_compress`` in ``(None,
    "bf16", "int8")`` selects the gradient wire format; ``zero1`` shards
    the optimizer state; ``tp_overlap`` is recorded (see the module
    docstring)."""

    def __init__(self, model, optimizer, loss_fn: Callable,
                 grad_compress: Optional[str] = None, zero1: bool = False,
                 tp_overlap: bool = True, qblock: int = 1024,
                 strategy=None):
        if grad_compress in ("bfloat16",):
            grad_compress = "bf16"
        if grad_compress not in (None, "bf16", "int8"):
            raise ValueError(
                f"grad_compress must be None|'bf16'|'int8', got "
                f"{grad_compress!r}")
        mesh = mesh_mod.get_mesh()
        for ax in ("sharding", "pp", "sep"):
            if mesh.axis_size(ax) > 1:
                raise NotImplementedError(
                    f"CommOptTrainStep covers (dp, tp) meshes; {ax} "
                    f"degree {mesh.axis_size(ax)} stays on the GSPMD "
                    "CompiledTrainStep path")
        if getattr(optimizer, "_grad_clip", None) is not None:
            raise NotImplementedError(
                "grad_clip is not supported on the comm-opt path (the "
                "global norm would need the full gradient before the "
                "sharded exchange)")
        self._flat_ok = (
            type(optimizer).__name__ in _ZERO1_OPTIMIZERS
            and not getattr(optimizer, "_lazy", False)
            and getattr(optimizer, "_apply_decay_param_fun", None) is None)
        if zero1 and not self._flat_ok:
            raise NotImplementedError(
                f"zero1 needs an elementwise optimizer with uniform "
                f"hyperparameters ({', '.join(_ZERO1_OPTIMIZERS)}, no "
                f"lazy_mode/apply_decay_param_fun); "
                f"{type(optimizer).__name__} does not qualify")
        self._init_replica(model, loss_fn)
        self.optimizer = optimizer
        self.grad_compress = grad_compress
        self.zero1 = bool(zero1)
        self.tp_overlap = bool(tp_overlap)
        self.qblock = int(qblock)
        self.tp = mesh.axis_size("tp")
        for k, p in self._params.items():
            if tuple(p.shape) != tuple(p.full_shape) and \
                    p.placement == (None,) * p.dim():
                raise NotImplementedError(
                    f"{k}: a tp slice outside ColumnParallelLinear/"
                    "RowParallelLinear; the comm-opt step keeps every "
                    "other parameter whole on each tp rank, as the JAX "
                    "package does")
        self._buffers = dict(model.named_buffers())

        # flat layout over the rank's LOCAL shapes (tp slices)
        self._local_shapes = {k: tuple(p.shape)
                              for k, p in self._params.items()}
        self._sizes = {k: int(np.prod(s)) or 1
                       for k, s in self._local_shapes.items()}
        self._order = list(self._params)
        self.n_local = sum(self._sizes.values())
        align = self.dp * self.qblock if grad_compress == "int8" else self.dp
        self._pad = (-self.n_local) % align
        self.n_pad = self.n_local + self._pad
        self.chunk = self.n_pad // self.dp
        self.nblk = max(1, self.chunk // self.qblock) \
            if grad_compress == "int8" else 0

        dev = next(iter(self._views.values())).device

        def zeros(n):
            return torch.zeros(n, dtype=torch.float32, device=dev)

        if self.zero1:
            # this rank owns chunk dp_index of the flat moments
            self._opt_state = optimizer.init_param_state(zeros(self.chunk))
        elif self._flat_ok:
            # the replicated arm of the same flat update: the full flat
            # moments on every rank (the ZeRO-1 memory baseline)
            self._opt_state = optimizer.init_param_state(zeros(self.n_pad))
        else:
            self._opt_state = optimizer.init_state(self._views)
        # e1: what phase 1's quantizer dropped, full flat size; e2: what
        # phase 2's re-quantizer dropped, chunk size (none under zero1:
        # parameters, not re-quantized gradients, travel in phase 2)
        self._ef = {}
        if grad_compress is not None:
            self._ef["e1"] = zeros(self.n_pad)
            if not self.zero1:
                self._ef["e2"] = zeros(self.chunk)
        self._byte_plan = self._make_byte_plan()
        self.steps_run = 0
        _LIVE_STEPS.add(self)

    # -- wire accounting ---------------------------------------------------

    def _make_byte_plan(self):
        """(op, dtype, bytes) per step for the dp gradient exchange —
        logical payload through each collective (per tp rank)."""
        plan = []
        n, nblk = self.n_pad, self.nblk
        if self.grad_compress == "int8":
            plan.append(("reduce_scatter", "int8", n + 4 * nblk * self.dp))
        elif self.grad_compress == "bf16":
            plan.append(("reduce_scatter", "bf16", 2 * n))
        else:
            plan.append(("reduce_scatter", "f32", 4 * n))
        if self.zero1:
            plan.append(("all_gather", "f32", 4 * n))       # params
        elif self.grad_compress == "int8":
            plan.append(("all_gather", "int8", n + 4 * nblk * self.dp))
        elif self.grad_compress == "bf16":
            plan.append(("all_gather", "bf16", 2 * n))
        else:
            plan.append(("all_gather", "f32", 4 * n))
        return plan

    @property
    def exchange_bytes(self) -> int:
        return sum(b for _, _, b in self._byte_plan)

    @property
    def compression_ratio(self) -> float:
        """fp32-exchange bytes / actual exchange bytes (>= 1)."""
        return 8 * self.n_pad / max(1, self.exchange_bytes)

    def comm_stats(self) -> dict:
        return {"grad_compress": self.grad_compress, "zero1": self.zero1,
                "tp_overlap": self.tp_overlap,
                "tp": self.tp, "dp": self.dp, "n_params": self.n_local,
                "n_pad": self.n_pad, "chunk": self.chunk,
                "exchange_bytes_per_step": self.exchange_bytes,
                "compression_ratio": round(self.compression_ratio, 3),
                "steps": self.steps_run,
                "byte_plan": [
                    {"op": o, "dtype": d, "bytes": b}
                    for o, d, b in self._byte_plan]}

    def optimizer_state_elems_per_replica(self) -> int:
        """Elements of optimizer state this rank holds — ~1/dp of the
        replicated count under zero1."""
        leaves = (self._opt_state.values() if self.zero1 or self._flat_ok
                  else [t for st in self._opt_state.values()
                        for t in st.values()])
        return sum(t.numel() or 1 for t in leaves)

    # -- the exchange ------------------------------------------------------

    def _exchange(self, g, e1):
        """Phase 1: flat local grad ``[n_pad]`` -> (this rank's averaged
        chunk ``[chunk]``, the new e1 residual or None). The compressed
        arms build ``c = e1 + g`` in ``e1``'s storage, which then holds
        the new residual ``c - sent``."""
        dp, grp = self.dp, self._dp_group
        if self.grad_compress is None:
            return C.reduce_scatter(g, group=grp) / dp, None
        c = e1.add_(g)
        cr = c.reshape(dp, self.chunk)
        if self.grad_compress == "int8":
            q, s = _quant_blocks(cr, self.nblk)
            sent = _dequant_blocks(q, s, self.nblk).reshape(-1)
            qt = C.alltoall_single(q, group=grp)
            st = C.alltoall_single(s, group=grp)
            mine = _dequant_blocks(qt, st, self.nblk).mean(dim=0)
        else:
            q = cr.to(torch.bfloat16)
            sent = q.float().reshape(-1)
            qt = C.alltoall_single(q, group=grp)
            mine = qt.float().mean(dim=0)
        return mine, c.sub_(sent)

    def _gather_grad(self, mine, e2):
        """Phase 2 (without zero1): this rank's chunk -> the full averaged
        flat gradient ``[n_pad]`` on every rank (+ the new e2)."""
        grp = self._dp_group
        if self.grad_compress is None:
            return C.all_gather(None, mine, group=grp).reshape(-1), None
        c2 = mine + e2
        if self.grad_compress == "int8":
            q2, s2 = _quant_blocks(c2, self.nblk)
            sent = _dequant_blocks(q2, s2, self.nblk)
            qg = C.all_gather(None, q2, group=grp)
            sg = C.all_gather(None, s2, group=grp)
            g_avg = _dequant_blocks(qg, sg, self.nblk)
        else:
            q2 = c2.to(torch.bfloat16)
            sent = q2.float()
            g_avg = C.all_gather(None, q2, group=grp).float()
        return g_avg.reshape(-1), c2 - sent

    def _flat_update(self, p_vec, g_vec, st, lr):
        """The one flat elementwise update both dp arms share: coupled L2
        through the gradient, then the optimizer's ``update_param``."""
        opt = self.optimizer
        if opt._l2_coeff and not opt._decoupled:
            coeff = torch.tensor(opt._l2_coeff, dtype=p_vec.dtype,
                                 device=p_vec.device)
            g_vec = g_vec + coeff * p_vec
        return opt.update_param(p_vec, g_vec, st, lr, None)

    def _owned(self, flat):
        """The chunk of a flat vector this rank owns under zero1."""
        i, n = self._dp_index, self.chunk
        return flat[i * n:(i + 1) * n]

    def _write_flat(self, flat):
        upd = _unflatten_by(flat, self._order, self._local_shapes,
                            self._sizes)
        for k, p in self._views.items():
            p.copy_(upd[k])

    # -- stepping ----------------------------------------------------------

    def __call__(self, *batch):
        attempt.check()
        loss, grads = self._grads(batch)
        lr = self.optimizer.get_lr()
        ef = dict(self._ef)
        with torch.no_grad():
            g = _flatten_by(grads, self._order, self._pad)
            del grads
            # e1 is updated in its own storage (a failed or abandoned
            # attempt is followed by a restore, which replaces it)
            mine, e1 = self._exchange(g, ef.get("e1"))
            del g
            if e1 is not None:
                ef["e1"] = e1
            new_flat = new_state = grads = None
            if self.zero1:
                p_shard = self._owned(_flatten_by(self._views, self._order,
                                                  self._pad))
                new_shard, new_state = self._flat_update(
                    p_shard, mine, self._opt_state, lr)
                new_flat = C.all_gather(
                    None, new_shard, group=self._dp_group).reshape(-1)
            else:
                g_avg, e2 = self._gather_grad(mine, ef.get("e2"))
                if e2 is not None:
                    ef["e2"] = e2
                if self._flat_ok:
                    flat_p = _flatten_by(self._views, self._order, self._pad)
                    new_flat, new_state = self._flat_update(
                        flat_p, g_avg, self._opt_state, lr)
                    del flat_p
                else:
                    g_tree = _unflatten_by(g_avg, self._order,
                                           self._local_shapes, self._sizes)
                    grads = {k: g_tree[k].to(p.dtype)
                             for k, p in self._views.items()}
            buffers = {}
            if self._buffers and self.dp > 1:
                # running-stat buffers: the dp mean keeps them replicated;
                # integer buffers pass through
                buffers = {k: C.all_reduce(b.clone(), group=self._dp_group)
                           / self.dp for k, b in self._buffers.items()
                           if b.is_floating_point()}
            with attempt.commit():
                self._ef = ef
                if new_flat is not None:
                    self._opt_state = new_state
                    self._write_flat(new_flat)
                for k, b in buffers.items():
                    self._buffers[k].copy_(b)
                if grads is not None:
                    self.optimizer.apply_in_place(self._views, grads,
                                                  self._opt_state, lr)
                self.steps_run += 1
                for op, dtype, nbytes in self._byte_plan:
                    COLLECTIVE_BYTES.labels(op=op, dtype=dtype).inc(nbytes)
                self._sched_step(self.optimizer)
        return self._dp_mean(loss)

    # -- snapshot surface --------------------------------------------------

    def state_dict(self):
        """This rank's state in the JAX package's keys: its parameters,
        its optimizer state (its chunk of the flat moments under zero1),
        its error-feedback residuals, the buffers, and the layout
        (tensors, not copies)."""
        def i64(v):
            return torch.tensor(int(v), dtype=torch.int64)

        return {"params": dict(self._views), "opt": self._opt_state,
                "ef": dict(self._ef),
                "buffers": {k: b.detach() for k, b in self._buffers.items()},
                "meta": {"dp": i64(self.dp), "tp": i64(self.tp),
                         "n_local": i64(self.n_local),
                         "n_pad": i64(self.n_pad),
                         "zero1": i64(self.zero1),
                         "compress": i64({"int8": 1, "bf16": 2}
                                         .get(self.grad_compress, 0))}}

    def load_state_dict(self, state):
        """Copy a snapshot into this step: this rank's ``state_dict()``
        at the same dp/tp layout, or every rank's state (a
        ``RankStates``, or the JAX package's ``[dp, tp, ...]`` layout) at
        any dp degree, re-sharded as the JAX package re-shards it. A
        restore across tp degrees raises."""
        if isinstance(state, (list, tuple)):
            state = self._joined(state)
        meta = state.get("meta") or {}
        dp0 = int(meta.get("dp", self.dp))
        tp0 = int(meta.get("tp", self.tp))
        n_valid = min(int(meta.get("n_local", self.n_local)), self.n_local)
        if tp0 != self.tp:
            raise NotImplementedError(
                f"restore across tp degrees ({tp0} -> {self.tp}) is not "
                "supported — tp re-shards the parameters themselves")
        joined = self._is_joined(state)
        if not joined and (dp0 != self.dp or int(meta.get(
                "n_pad", self.n_pad)) != self.n_pad) and (
                self.zero1 or state.get("ef")):
            raise ValueError(
                f"restoring a dp{dp0} comm-opt state at dp{self.dp} needs "
                "every rank's state (a RankStates, or the [dp, tp, ...] "
                "layout of gathered_state()), not one rank's")

        def host(t):
            return torch.as_tensor(t).detach().to("cpu")

        def copied(t, like):
            return torch.as_tensor(t).detach().to(like.device, like.dtype,
                                                  copy=True)

        with torch.no_grad():
            for k, v in self._views.items():
                src = torch.as_tensor(state["params"][k])
                if tuple(src.shape) != tuple(v.shape):
                    # a full array (JAX's layout): this rank's tp block
                    src = mesh_mod.local_block(
                        src, self._params[k].placement, self.mesh)
                v.copy_(src)
            for k, b in self._buffers.items():
                b.copy_(torch.as_tensor(state["buffers"][k]))
        stored = state["opt"]
        if self.zero1 and joined:
            self._opt_state = {
                n: copied(host(t)[0, self._tp_index] if host(t).dim() == 2
                          else self._reshard_flat(host(t), n_valid),
                          self._opt_state[n])
                for n, t in stored.items()}
        elif self.zero1:
            self._opt_state = {n: copied(t, self._opt_state[n])
                               for n, t in stored.items()}
        elif self._flat_ok:
            self._opt_state = {n: copied(self._repad(host(t), n_valid),
                                         self._opt_state[n])
                               for n, t in stored.items()}
        else:
            self._opt_state = {
                k: {n: copied(t, self._opt_state[k][n])
                    for n, t in stored[k].items()}
                for k in self._opt_state}
        for k in self._ef:
            t = state.get("ef", {}).get(k)
            if t is None:
                continue
            t = host(t)
            if not joined:
                self._ef[k] = copied(t, self._ef[k])
            elif k == "e1":
                self._ef[k] = copied(self._sum_e1(t, n_valid), self._ef[k])
            else:       # e2: owner-sharded like the flat moments
                self._ef[k] = copied(self._reshard_flat(t, n_valid),
                                     self._ef[k])

    @property
    def _tp_index(self):
        return self.mesh.axis_index("tp")

    def _is_joined(self, state):
        """True for every rank's state in the ``[dp, tp, ...]`` layout
        (flat leaves with a leading dp and tp dim)."""
        leaves = list((state.get("ef") or {}).values())
        if self.zero1:
            leaves += list(state["opt"].values())
        return any(torch.as_tensor(t).dim() >= 2 for t in leaves
                   if t is not None)

    def _joined(self, states):
        """Every rank's ``state_dict()`` (rank order; rank = dp index *
        tp + tp index) -> one state in the JAX package's layout: the flat
        per-rank leaves stacked ``[dp, tp, ...]``; what every dp replica
        holds alike (parameters, buffers, replicated optimizer state)
        from the dp-0 rank of this rank's tp index."""
        meta = states[0]["meta"]
        dp0, tp0 = int(meta["dp"]), int(meta["tp"])
        if len(states) != dp0 * tp0:
            raise ValueError(f"{len(states)} rank states for a dp{dp0} x "
                             f"tp{tp0} layout")
        mine = states[min(self._tp_index, tp0 - 1)]

        def stacked(get):
            return torch.stack([torch.stack([
                torch.as_tensor(get(states[d * tp0 + t])).detach().cpu()
                for t in range(tp0)]) for d in range(dp0)])

        out = {"params": mine["params"], "buffers": mine["buffers"],
               "meta": meta,
               "ef": {k: stacked(lambda s, k=k: s["ef"][k])
                      for k in states[0].get("ef", {})}}
        if int(meta.get("zero1", 0)):
            out["opt"] = {n: stacked(lambda s, n=n: s["opt"][n])
                          for n in states[0]["opt"]}
        else:
            out["opt"] = mine["opt"]
        return out

    def _reshard_flat(self, leaf, n_valid):
        """``[dp0, tp, chunk0]`` owner-sharded flat state -> this rank's
        chunk of this layout (positions preserved; padding rebuilt)."""
        dp0 = leaf.shape[0]
        if dp0 == self.dp and leaf.shape[-1] == self.chunk:
            return leaf[self._dp_index, self._tp_index]
        flat = leaf.permute(1, 0, 2).reshape(leaf.shape[1], -1)[
            self._tp_index, :n_valid]
        out = torch.zeros(self.n_pad, dtype=leaf.dtype)
        out[:n_valid] = flat
        return self._owned(out)

    def _repad(self, t, n_valid):
        """A replicated flat leaf ``[n_pad0]`` at this layout's padding."""
        if t.dim() != 1 or t.shape[0] == self.n_pad:
            return t
        out = torch.zeros(self.n_pad, dtype=t.dtype)
        out[:n_valid] = t[:n_valid]
        return out

    def _sum_e1(self, t, n_valid):
        """This rank's e1 from every replica's ``[dp0, tp, n_pad0]``: the
        same layout keeps its own; a re-mesh sums the replicas into
        replica 0 (in replica order, as numpy's ``sum(axis=0)``), so no
        dropped error is lost."""
        if t.shape[0] == self.dp and t.shape[-1] == self.n_pad:
            return t[self._dp_index, self._tp_index]
        out = torch.zeros(self.n_pad, dtype=t.dtype)
        if self._dp_index == 0:
            total = t[0, self._tp_index].clone()
            for i in range(1, t.shape[0]):
                total += t[i, self._tp_index]
            out[:n_valid] = total[:n_valid]
        return out

    def gathered_state(self) -> dict:
        """The flat state of every rank in the JAX package's ``[dp, tp,
        ...]`` layout, as numpy: the residuals (``ef``) and, under zero1,
        the optimizer state. Every rank of the mesh calls it."""
        def blocked(t):
            g = C.all_gather(None, t.detach(), group=self._dp_group)
            g = C.all_gather(None, g, group=self.mesh.group("tp"))
            return g.transpose(0, 1).cpu().numpy()

        out = {"ef": {k: blocked(t) for k, t in self._ef.items()}}
        if self.zero1:
            out["opt"] = {n: blocked(t) for n, t in self._opt_state.items()}
        return out


def global_comm_stats() -> dict:
    """Aggregated live comm-opt step stats."""
    steps = list(_LIVE_STEPS)
    out = {"steps": len(steps), "total_steps_run": 0, "arms": []}
    for s in steps:
        out["total_steps_run"] += s.steps_run
        out["arms"].append(s.comm_stats())
    return out
