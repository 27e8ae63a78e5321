"""Pipeline parallelism over the mesh's "pp" axis. Counterpart of
``paddle_tpu/ops/pipeline.py`` (``spmd_pipeline``, ``pipeline_1f1b``).

The JAX package runs the schedule as one SPMD program over a stacked
array sharded on "pp" (``shard_map`` and ``ppermute``; in a bubble tick
a stage multiplies garbage that is masked out). The port is rank-local,
as the reference's pipeline engine
(``fleet/meta_parallel/pipeline_parallel.py``): rank p of the pp group
holds stage p's chunk of the stacked layers and runs only that stage;
activations move right and cotangents left by point-to-point
(``collective.batch_isend_irecv``, which stages a CUDA tensor through the
host on gloo). A rank launches nothing in a bubble, and a transfer is
posted only where it carries a micro-batch: both ends work it out from
the rank, the micro-batch's index, M and P alone.

Stacked parameters are a dict ``name -> tensor`` whose leaves are the
logical stacked arrays the JAX functions take: a tensor placed on "pp"
(a parameter of a model that ``fleet.distributed_model`` placed on a pp
mesh: its data is this rank's chunk, ``full_shape`` the whole) is used as
it is; any other tensor is whole, and the rank takes its contiguous chunk
of dim 0, as ``shard_map``'s ``P("pp")`` hands it.

``spmd_pipeline`` is GPipe, differentiable through autograd (one
``autograd.Function``). Its forward keeps JAX's ticks: at tick t rank p
runs micro-batch f = t - p, and at the end of the tick y goes right (one
``batch_isend_irecv`` a tick). Every micro-batch's stage graph stays
alive until the backward (GPipe holds M), which runs the ticks in
reverse and sends the cotangents left. The output, the last stage's, is
broadcast over the pp group (JAX's ``psum`` of the masked outputs); the
backward takes the last stage's own cotangent of it, not a sum over the
ranks: every rank computes the same loss from the same output, so a sum
would give P times the gradient. The input's gradient, which only stage
0 makes, is broadcast from stage 0, so an embedding computed on every
rank before the pipeline gets the same gradient on every rank.

``pipeline_1f1b`` runs forward and backward in one schedule, in the
reference's 1F1B order: rank p runs ``P - p - 1`` warm-up forwards, then
alternates one forward and one backward, then the remaining backwards.
A forward's graph is kept until its backward, as the reference keeps it
(JAX's body recomputes the stage forward instead), so rank p holds at
most ``P - p`` micro-batches. JAX's lock-step ticks (the forward of
``t - p`` and the backward of ``t - 2P + 2 + p`` at tick t) would hold
up to ``2P - 2p - 1`` there with the graphs kept (7 on rank 0 at P = 4),
so the order is the reference's; the results are JAX's. Transfers are
posted as the reference's ``send_forward_recv_backward`` and
``send_backward_recv_forward`` pairs, each pair in one
``batch_isend_irecv``. It returns ``(mean over micro-batches of
last_fn's loss, this rank's chunk gradients, last-stage parameter
gradients, dx)``, gradients in fp32; the loss and the last-stage
gradients are broadcast from the last stage and dx from the first, as
JAX's ``psum``s replicate them.

Launches: each micro-batch runs a rank's stage forward once and its
backward once, in both schedules (a stage with remat inside recomputes
its forward in the backward). ``counters["max_in_flight"]`` is the most
micro-batches whose graphs this rank held at once in the last call
(GPipe: M; 1F1B: ``min(P - p, M)``).
"""
from __future__ import annotations

from typing import Callable

import torch

from ..distributed import collective as C

__all__ = ["spmd_pipeline", "pipeline_1f1b", "counters"]

#: the most micro-batches whose stage graphs this rank held at once, in
#: the last pipeline call
counters = {"max_in_flight": 0}


def _mesh(mesh):
    if mesh is None:
        from ..distributed.mesh import get_mesh
        mesh = get_mesh()
    return mesh


def _placed_on(leaf, axis_name):
    """Whether ``leaf`` is a parameter placed on ``axis_name`` (its data
    this rank's chunk of dim 0)."""
    spec = getattr(leaf, "placement", None)
    return bool(spec) and spec[0] == axis_name


def _check_stacked(stacked, n, axis_name):
    for k, leaf in stacked.items():
        d = (leaf.full_shape if _placed_on(leaf, axis_name)
             else leaf.shape)[0]
        if d % n:
            raise ValueError(f"stacked param ['{k}'] leading dim {d} not "
                             f"divisible by {n} pp stages")


def _local_chunk(stacked, n, p, axis_name):
    """This rank's chunk of each stacked leaf (see the module
    docstring)."""
    out = {}
    for k, leaf in stacked.items():
        if _placed_on(leaf, axis_name):
            out[k] = leaf
        else:
            c = leaf.shape[0] // n
            out[k] = leaf[p * c:(p + 1) * c]
    return out


class _Ring:
    """This rank's place on the pp group and its two neighbours' global
    ranks; ``xfer`` posts one set of transfers together."""

    def __init__(self, mesh, axis_name, device):
        self.group = g = mesh.group(axis_name)
        self.n, self.p = g.nranks, g.rank
        self.prev = g.ranks[self.p - 1] if self.p > 0 else None
        self.next = g.ranks[self.p + 1] if self.p < self.n - 1 else None
        if self.n > 1 and not getattr(g, "_p2p_ready", False):
            # NCCL creates a group's communicator for batched
            # point-to-point only when every rank of the group takes part:
            # one collective over the group first
            C.all_reduce(torch.zeros(1, device=device), group=g)
            g._p2p_ready = True

    def xfer(self, like, send_right=None, recv_left=False, send_left=None,
             recv_right=False):
        """Post the given transfers in one ``batch_isend_irecv`` and wait;
        returns (tensor from the left, tensor from the right), new
        tensors shaped and typed as ``like``."""
        ops, left, right = [], None, None
        if send_right is not None:
            ops.append(C.P2POp(C.isend, send_right.contiguous(), self.next,
                               self.group))
        if recv_left:
            left = torch.empty_like(like)
            ops.append(C.P2POp(C.irecv, left, self.prev, self.group))
        if send_left is not None:
            ops.append(C.P2POp(C.isend, send_left.contiguous(), self.prev,
                               self.group))
        if recv_right:
            right = torch.empty_like(like)
            ops.append(C.P2POp(C.irecv, right, self.next, self.group))
        for w in C.batch_isend_irecv(ops):
            w.wait()
        return left, right

    def broadcast_from(self, t, stage):
        """``t`` of stage ``stage`` on every rank of the group."""
        return C.broadcast(t, src=self.group.ranks[stage], group=self.group)


class _InFlight:
    """The micro-batches whose stage graph (input leaf, output) a rank
    holds for their backward; counts the most held at once into
    ``counters["max_in_flight"]``."""

    def __init__(self):
        self._held = {}
        counters["max_in_flight"] = 0

    def put(self, i, x, out):
        self._held[i] = (x, out)
        counters["max_in_flight"] = max(counters["max_in_flight"],
                                        len(self._held))

    def take(self, i):
        """Micro-batch ``i``'s (input leaf, output), released."""
        return self._held.pop(i)


def _output_cotangent(ring, g_out):
    """The cotangent of the replicated output that reaches the last
    stage: its own (every rank's is the same; a sum over the ranks would
    be P times it)."""
    return g_out


def _same_as_input(y, x):
    if y.shape != x.shape or y.dtype != x.dtype:
        raise ValueError(f"stage_fn must keep its input's shape and dtype: "
                         f"{tuple(x.shape)} {x.dtype} -> {tuple(y.shape)} "
                         f"{y.dtype}")


def _leaves(chunk):
    """Detached leaves of the chunk's tensors that autograd differentiates
    against (they share the chunk's storage)."""
    return {k: v.detach().requires_grad_(v.is_floating_point())
            for k, v in chunk.items()}


def _grad(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` over the inputs that require a gradient
    (zeros for the others)."""
    need = [i for i, t in enumerate(inputs) if t.requires_grad]
    got = torch.autograd.grad(outputs, [inputs[i] for i in need],
                              grad_outputs, allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(need, got):
        out[i] = g
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, out)]


# -- GPipe --------------------------------------------------------------------

def _gpipe_forward(ring, stage_fn, params, micro, track):
    """The forward ticks. With ``track`` each micro-batch's stage graph is
    kept (returned, by micro-batch) for the backward."""
    n, p, M = ring.n, ring.p, micro.shape[0]
    held, outs, x_in = _InFlight(), [], None
    for t in range(M + n - 1):
        f = t - p
        y = None
        if 0 <= f < M:
            x = micro[f] if p == 0 else x_in
            if track:
                x = x.detach().requires_grad_()
                with torch.enable_grad():
                    y = stage_fn(params, x)
                held.put(f, x, y)
            else:
                y = stage_fn(params, x)
            _same_as_input(y, micro[0])
            if p == n - 1:
                outs.append(y.detach())
        send = y.detach() if ring.next is not None and y is not None \
            else None
        recv = ring.prev is not None and 0 <= t + 1 - p < M
        if send is not None or recv:
            x_in, _ = ring.xfer(micro[0], send_right=send, recv_left=recv)
    out = torch.stack(outs) if p == n - 1 else torch.empty_like(micro)
    ring.broadcast_from(out, n - 1)
    return out, held


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, micro, *chunk):
        ring, stage_fn, names = run
        params = _leaves(dict(zip(names, chunk)))
        out, held = _gpipe_forward(ring, stage_fn, params, micro, True)
        ctx.run, ctx.held, ctx.params = run, held, params
        ctx.micro_like = micro
        return out

    @staticmethod
    def backward(ctx, g_out):
        ring, _, names = ctx.run
        n, p, held = ring.n, ring.p, ctx.held
        M = ctx.micro_like.shape[0]
        params = [ctx.params[k] for k in names]
        acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
               for q in params]
        g_out = _output_cotangent(ring, g_out)
        dx, ct_in = [None] * M, None
        for t in reversed(range(M + n - 1)):
            f = t - p
            gx = None
            if 0 <= f < M:
                x, y = held.take(f)
                ct = g_out[f] if p == n - 1 else ct_in
                gs = _grad(y, [x] + params, ct)
                gx = gs[0]
                for a, g in zip(acc, gs[1:]):
                    a += g.float()
                if p == 0:
                    dx[f] = gx
            send = gx if ring.prev is not None and gx is not None else None
            recv = ring.next is not None and 0 <= t - 1 - p < M
            if send is not None or recv:
                _, ct_in = ring.xfer(ctx.micro_like[0], send_left=send,
                                     recv_right=recv)
        d_micro = (torch.stack(dx) if p == 0
                   else torch.empty_like(ctx.micro_like))
        ring.broadcast_from(d_micro, 0)
        ctx.held = ctx.params = None
        return (None, d_micro,
                *(a.to(q.dtype) for a, q in zip(acc, params)))


def spmd_pipeline(stage_fn: Callable, stacked_params, x, *, mesh=None,
                  axis_name: str = "pp", n_micro: int | None = None):
    """Run a homogeneous layer stack as a pipeline over the "pp" axis.

    ``stage_fn(chunk, x) -> y`` applies one stage (its chunk of layers,
    a dict like ``stacked_params``) and keeps x's shape and dtype.
    ``stacked_params``: dict of stacked leaves (see the module docstring).
    ``x``: ``[batch, ...]``, the same on every rank of the pp group; it is
    split into ``n_micro`` micro-batches along dim 0 (default: one per
    stage). Returns the stages applied in order, ``[batch, ...]``, on
    every rank; differentiable (GPipe)."""
    mesh = _mesh(mesh)
    n_stages = mesh.axis_size(axis_name)
    if n_stages == 1:
        return stage_fn(stacked_params, x)
    n_micro = n_micro or n_stages
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    _check_stacked(stacked_params, n_stages, axis_name)
    ring = _Ring(mesh, axis_name, x.device)
    chunk = _local_chunk(stacked_params, n_stages, ring.p, axis_name)
    names = tuple(chunk)
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    if torch.is_grad_enabled():
        out = _GPipe.apply((ring, stage_fn, names), micro,
                           *(chunk[k] for k in names))
    else:                   # nothing to differentiate: no graph is kept
        out = _gpipe_forward(ring, stage_fn, chunk, micro, False)[0]
    return out.reshape(b, *out.shape[2:])


# -- 1F1B ---------------------------------------------------------------------

def pipeline_1f1b(stage_fn: Callable, last_fn: Callable, stacked_params, x,
                  targets, *, last_params=None, mesh=None,
                  axis_name: str = "pp", n_micro: int | None = None):
    """Fused forward and backward 1F1B pipeline over the "pp" axis.

    ``stage_fn(chunk, x) -> y`` applies one stage; ``last_fn(last_params,
    y, tgt) -> scalar`` is the per-micro-batch loss after the last stage
    (final norm, head and CE), run inside the last stage so that its
    backward starts there; ``last_params`` (a dict, replicated, may be
    None) gets gradients too. ``x`` and ``targets`` are the same on every
    rank of the pp group. Returns ``(loss, grads, last_grads, dx)`` (see
    the module docstring); nothing is written into ``.grad``."""
    mesh = _mesh(mesh)
    if last_params is None:
        last_params = {}
        user_last_fn = last_fn
        last_fn = lambda lp, y, tgt: user_last_fn(y, tgt)  # noqa: E731
    n_stages = mesh.axis_size(axis_name)
    n_micro = n_micro or max(n_stages, 1)
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by n_micro {n_micro}")
    _check_stacked(stacked_params, n_stages, axis_name)
    micro_x = x.detach().reshape(n_micro, b // n_micro, *x.shape[1:])
    micro_t = targets.reshape(n_micro, b // n_micro, *targets.shape[1:])
    ring = _Ring(mesh, axis_name, x.device)
    n, p, M = ring.n, ring.p, n_micro
    first, last = p == 0, p == n - 1
    params = _leaves(_local_chunk(stacked_params, n, p, axis_name))
    lparams = _leaves(last_params) if last else {}
    keys, lkeys = list(params), list(lparams)
    inputs = [params[k] for k in keys] + [lparams[k] for k in lkeys]
    acc = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in inputs]
    loss_acc = torch.zeros((), dtype=torch.float32, device=micro_x.device)
    like = micro_x[0]
    held, dx = _InFlight(), [None] * M

    def forward(f, x_in):
        nonlocal loss_acc
        xl = x_in.detach().requires_grad_()
        with torch.enable_grad():
            y = stage_fn(params, xl)
            _same_as_input(y, like)
            out = last_fn(lparams, y, micro_t[f]) if last else y
        if last:
            loss_acc = loss_acc + out.detach().float() / M
        held.put(f, xl, out)
        return y.detach()

    def backward(i, ct):
        xl, out = held.take(i)
        if last:         # d(mean over micro-batches) / d(this loss)
            ct = torch.full_like(out, 1.0 / M)
        gs = _grad(out, [xl] + inputs, ct)
        for a, g in zip(acc, gs[1:]):
            a += g.float()
        if first:
            dx[i] = gs[0]
        return gs[0]

    warm = min(n - p - 1, M)
    steady = M - warm
    for i in range(warm):
        x_in = micro_x[i] if first else ring.xfer(like, recv_left=True)[0]
        ring.xfer(like, send_right=forward(i, x_in))
    if steady:
        x_in = micro_x[warm] if first else ring.xfer(like, recv_left=True)[0]
    for i in range(steady):
        y = forward(warm + i, x_in)
        ct = None if last else ring.xfer(like, send_right=y,
                                         recv_right=True)[1]
        gx = backward(i, ct)
        more = i < steady - 1
        if first:
            if more:
                x_in = micro_x[warm + i + 1]
        elif more:
            x_in = ring.xfer(like, send_left=gx, recv_left=True)[0]
        else:
            ring.xfer(like, send_left=gx)
    for i in range(steady, M):
        ct = ring.xfer(like, recv_right=True)[1]
        gx = backward(i, ct)
        if not first:
            ring.xfer(like, send_left=gx)

    grads = dict(zip(keys, acc[:len(keys)]))
    if last:
        last_grads = dict(zip(lkeys, acc[len(keys):]))
    else:
        last_grads = {k: torch.empty(v.shape, dtype=torch.float32,
                                     device=v.device)
                      for k, v in last_params.items()}
    d_micro = torch.stack(dx) if first else torch.empty_like(micro_x)
    ring.broadcast_from(loss_acc, n - 1)
    for k in sorted(last_grads):
        ring.broadcast_from(last_grads[k], n - 1)
    ring.broadcast_from(d_micro, 0)
    return loss_acc, grads, last_grads, d_micro.reshape(b, *x.shape[1:])
