"""Collective communication. Counterpart of
``paddle_tpu/distributed/collective.py``.

The JAX package runs one controller that owns every device, so its
collectives are identities outside ``shard_map``. The port is SPMD: one
process per GPU, each holding its own tensors, and these functions are
``torch.distributed`` collectives between those processes. A ``Group``
names its member ranks and carries the ``torch.distributed`` process
group; a group of one rank makes every collective an identity (no
communication at all), so a world of one computes exactly what the
single-process code computes.

``init_parallel_env`` reads a launcher's environment: torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``,
or the reference's ``PADDLE_TRAINERS_NUM``/``PADDLE_TRAINER_ID``
(``spawn`` sets both). The backend is NCCL on ``cuda:LOCAL_RANK``; gloo
is taken only when the caller asks for the CPU (``device="cpu"``) or for
``backend="gloo"`` (as two ranks that share one card must). Nothing
falls back from one backend to the other.

Sequence parallel adds the two collectives its bodies need, the JAX
package's ``lax.ppermute`` and tiled ``lax.all_to_all``: ``ppermute``
rotates tensors around a group (``batch_isend_irecv``), and
``all_to_all`` re-shards one dim onto another (``all_to_all_single``),
differentiably. Gloo carries ``all_to_all_single`` on CUDA tensors but
not point-to-point (its TCP transport reads the device pointer as host
memory: "Bad address"), so ``ppermute`` on gloo stages CUDA tensors
through the host, one copy each way, and counts each such call in
``host_staged``.

Pipeline parallel adds point-to-point: ``send``, ``recv``, ``isend``,
``irecv``, and ``P2POp`` with ``batch_isend_irecv``, which posts several
sends and receives together (a pipeline tick's transfers; NCCL then
cannot deadlock on their order). Peers are global ranks, as in the
reference. NCCL carries CUDA tensors directly; on gloo a CUDA tensor is
staged through the host, one copy each way, and each such call counts
in ``host_staged`` under its function's name. No other call is staged,
and nothing chooses another algorithm.
"""
from __future__ import annotations

import datetime
import hashlib
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from ..framework.device import resolve_device, set_device

__all__ = ["ReduceOp", "Group", "init_parallel_env", "is_initialized",
           "get_rank", "get_world_size", "new_group", "get_group",
           "all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "reduce", "scatter", "alltoall", "alltoall_single", "barrier",
           "destroy_process_group", "free_port", "gather_dim",
           "reduce_scatter_dim", "ppermute", "all_to_all", "host_staged",
           "send", "recv", "isend", "irecv", "P2POp", "batch_isend_irecv",
           "agree"]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communicator: its member ranks (global, ascending), this
    process's rank among them, and the ``torch.distributed`` process group
    (``pg``; None for the default world group). ``axis_names`` says which
    mesh axes it spans."""

    def __init__(self, rank=0, nranks=1, id=0, ranks=None, axis_names=("dp",),
                 pg=None):
        self.rank = rank
        self.nranks = nranks
        self.id = id
        self.ranks = list(ranks) if ranks is not None else list(range(nranks))
        self.axis_names = tuple(axis_names)
        self.pg = pg

    @property
    def world_size(self):
        return self.nranks

    def __repr__(self):
        return (f"Group(axes={self.axis_names}, ranks={self.ranks}, "
                f"rank={self.rank})")


_default_group: Optional[Group] = None


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env_int(*names, default):
    for n in names:
        if os.environ.get(n):
            return int(os.environ[n])
    return default


def launcher_world_size() -> int:
    """The world size a launcher's environment declares (1 without one)."""
    return _env_int("WORLD_SIZE", "PADDLE_TRAINERS_NUM", default=1)


def init_parallel_env(backend=None, device=None, timeout=None):
    """Join the process group the environment describes and return the
    world ``Group``. ``device`` (default ``cuda:LOCAL_RANK``, or the CPU
    under ``backend="gloo"``) becomes this process's default device;
    ``backend`` defaults to NCCL, or gloo for the CPU. ``timeout`` is in
    seconds. Calling it again returns the same group."""
    global _default_group
    if _default_group is not None:
        return _default_group
    world = launcher_world_size()
    rank = _env_int("RANK", "PADDLE_TRAINER_ID", default=0)
    local = _env_int("LOCAL_RANK", default=rank)
    if device is None:
        device = "cpu" if backend == "gloo" else f"cuda:{local}"
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}; want 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; pass "
                         "device='cpu' for gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    set_device(str(dev))
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not (addr and port) and os.environ.get("PADDLE_MASTER"):
        addr, port = os.environ["PADDLE_MASTER"].rsplit(":", 1)
    if not (addr and port):
        if world > 1:
            raise RuntimeError(
                "init_parallel_env: a world of several ranks needs "
                "MASTER_ADDR and MASTER_PORT (or PADDLE_MASTER)")
        addr, port = "127.0.0.1", str(free_port())
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world, **kw)
    _default_group = Group(rank=rank, nranks=world, ranks=range(world),
                           axis_names=("dp", "sharding"))
    return _default_group


def is_initialized() -> bool:
    return _default_group is not None


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    if _default_group is not None:
        return _default_group.rank
    return _env_int("RANK", "PADDLE_TRAINER_ID", default=0)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    if _default_group is not None:
        return _default_group.nranks
    return launcher_world_size()


def new_group(ranks=None, backend=None, axis_names=None, fresh=False):
    """A group of ``ranks`` (global ranks; all of them when None). Every
    rank of the world must call it, members or not, in the same order.
    A group of every rank is the world's own communicator, unless
    ``fresh`` asks for a new one: a communicator no earlier call can still
    be using (the serving supervisor's rebuilt tp engines and its verdict
    group)."""
    world = get_world_size()
    ranks = sorted(range(world) if ranks is None else ranks)
    axis_names = tuple(axis_names or ("dp",))
    if len(ranks) == world and not fresh:
        pg = None
    else:
        pg = dist.new_group(ranks, backend=backend) if world > 1 else None
    me = get_rank()
    return Group(rank=ranks.index(me) if me in ranks else -1,
                 nranks=len(ranks), ranks=ranks, axis_names=axis_names,
                 pg=pg)


def get_group(id=0):
    return _default_group


def _solo(group) -> bool:
    """True when ``group`` (the world when None) holds one rank: every
    collective over it is the identity."""
    return get_world_size(group) == 1


def _pg(group):
    return None if group is None else group.pg


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=True):
    """Reduce ``tensor`` in place over the group; AVG is the SUM divided
    by the group's size."""
    if _solo(group):
        return tensor
    if op == ReduceOp.AVG:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=_pg(group))
        return tensor.div_(get_world_size(group))
    dist.all_reduce(tensor, op=_TORCH_OP[op], group=_pg(group))
    return tensor


def all_gather(tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=True):
    """Append every rank's ``tensor`` to ``tensor_list`` (group rank
    order) and return them stacked ``[nranks, ...]``."""
    n = get_world_size(group)
    flat = tensor.contiguous().reshape(1, -1)
    out = torch.empty((n, flat.shape[1]), dtype=tensor.dtype,
                      device=tensor.device)
    if n == 1:
        out.copy_(flat)
    else:
        dist.all_gather_into_tensor(out, flat, group=_pg(group))
    out = out.reshape(n, *tensor.shape)
    if isinstance(tensor_list, list):
        tensor_list.extend(out.unbind(0))
    return out


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True, use_calc_stream=True):
    """Reduce over the group, then scatter along dim 0: rank i keeps
    piece i. With ``tensor_list`` (one piece per rank) the result is
    written into ``tensor``; without it ``tensor`` is the whole input and
    the piece is returned as a new tensor. SUM and AVG only."""
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError("reduce_scatter takes ReduceOp.SUM or AVG")
    n = get_world_size(group)
    src = tensor if tensor_list is None else torch.cat(
        [t.reshape(1, *t.shape) if t.dim() == 0 else t for t in tensor_list])
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({src.shape[0]}) is not a "
                         f"multiple of the group's {n} ranks")
    out = tensor if tensor_list is not None else torch.empty(
        (src.shape[0] // n, *src.shape[1:]), dtype=src.dtype,
        device=src.device)
    if n == 1:
        out.copy_(src.reshape(out.shape))
    else:
        dist.reduce_scatter_tensor(out, src.contiguous(), group=_pg(group))
    if op == ReduceOp.AVG:
        out.div_(n)
    return out


def broadcast(tensor, src=0, group=None, sync_op=True, use_calc_stream=True):
    """Overwrite ``tensor`` with the one of global rank ``src``."""
    if not _solo(group):
        dist.broadcast(tensor, src=src, group=_pg(group))
    return tensor


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=True):
    """Reduce into ``tensor`` on global rank ``dst`` (the other ranks'
    ``tensor`` is left undefined, as in torch.distributed)."""
    if _solo(group):
        return tensor
    if op == ReduceOp.AVG:
        dist.reduce(tensor, dst=dst, op=dist.ReduceOp.SUM, group=_pg(group))
        if get_rank() == dst:
            tensor.div_(get_world_size(group))
        return tensor
    dist.reduce(tensor, dst=dst, op=_TORCH_OP[op], group=_pg(group))
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True,
            use_calc_stream=True):
    """Global rank ``src`` sends ``tensor_list[i]`` to the group's rank i,
    which receives it into ``tensor``."""
    if _solo(group):
        if tensor_list:
            tensor.copy_(tensor_list[0])
        return tensor
    lst = ([t.contiguous() for t in tensor_list]
           if get_rank() == src else None)
    dist.scatter(tensor, lst, src=src, group=_pg(group))
    return tensor


def alltoall(in_tensor_list, out_tensor_list, group=None, sync_op=True,
             use_calc_stream=True):
    """Rank i's ``in_tensor_list[j]`` lands in rank j's output slot i;
    ``out_tensor_list`` is extended with the received tensors."""
    if _solo(group):
        outs = [t.clone() for t in in_tensor_list]
    else:
        outs = [torch.empty_like(t) for t in in_tensor_list]
        dist.all_to_all(outs, [t.contiguous() for t in in_tensor_list],
                        group=_pg(group))
    out_tensor_list.extend(outs)
    return outs


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """All-to-all on one tensor split along dim 0 (equal pieces unless
    split sizes are given); returns the output tensor."""
    if out_tensor is None:
        if out_split_sizes is not None:
            out_tensor = in_tensor.new_empty(
                (sum(out_split_sizes), *in_tensor.shape[1:]))
        else:
            out_tensor = torch.empty_like(in_tensor)
    if _solo(group):
        return out_tensor.copy_(in_tensor)
    dist.all_to_all_single(out_tensor, in_tensor.contiguous(),
                           output_split_sizes=out_split_sizes,
                           input_split_sizes=in_split_sizes,
                           group=_pg(group))
    return out_tensor


def barrier(group=None):
    if not _solo(group):
        dist.barrier(group=_pg(group))


def destroy_process_group(group=None):
    """Leave the default process group (and with it every group), or
    destroy one sub-group."""
    global _default_group
    if group is not None and group.pg is not None:
        dist.destroy_process_group(group.pg)
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _default_group = None


# -- lockstep decisions (the serving engine, supervisor and fleet) ---------

def agree(group, *, blob=None, what="the call", rank0=(), maximum=(),
          device="cpu"):
    """The one collective of a lockstep decision: a float64 all-reduce
    (max) over ``group``. ``blob`` (bytes) is what every rank must hold
    alike: 52 bits of its hash and their negation travel, and every rank
    raises RuntimeError naming ``what`` when they differ. ``rank0`` are
    floats of which group rank 0's come back on every rank (the others
    send -inf), ``maximum`` floats of which the group's maximum comes
    back. Returns (rank 0's values, the maxima) as lists."""
    rank0, maximum = list(rank0), list(maximum)
    hv = []
    if blob is not None:
        h = hashlib.blake2b(blob, digest_size=8).digest()
        x = float(int.from_bytes(h, "little") >> 12)   # exact in float64
        hv = [x, -x]
    if _solo(group):
        return rank0, maximum
    lead = group.rank == 0
    t = torch.tensor(hv + [v if lead else float("-inf") for v in rank0]
                     + maximum, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_pg(group))
    vals = t.tolist()
    if hv and vals[0] != -vals[1]:
        raise RuntimeError(
            f"ranks disagree on {what}: every rank must make the same "
            "calls in the same order with the same arguments (SPMD)")
    vals = vals[len(hv):]
    return vals[:len(rank0)], vals[len(rank0):]


# -- along one dim (the placement code's two collectives) ------------------

def gather_dim(t, dim, group):
    """All-gather the group's blocks of ``t`` along ``dim`` (group rank
    order): the inverse of taking block ``group.rank``."""
    n = get_world_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.all_gather_into_tensor(out, src, group=_pg(group))
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(t, dim, group):
    """Sum ``t`` over the group and keep this rank's block along ``dim``."""
    n = get_world_size(group)
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=_pg(group))
    return out.movedim(0, dim).contiguous()


# -- point-to-point ----------------------------------------------------------

#: calls staged through the host because the backend refuses their CUDA
#: tensors (gloo's point-to-point), by function
host_staged = {"ppermute": 0, "send": 0, "recv": 0, "isend": 0, "irecv": 0,
               "batch_isend_irecv": 0}


def _gloo(group) -> bool:
    return dist.get_backend(_pg(group)) == "gloo"


class P2POp:
    """One transfer for ``batch_isend_irecv``: ``op`` is ``isend`` or
    ``irecv``, ``peer`` the other end's global rank."""

    def __init__(self, op, tensor, peer, group=None, tag=0):
        if op not in (isend, irecv):
            raise ValueError("P2POp takes isend or irecv")
        self.op, self.tensor, self.peer = op, tensor, int(peer)
        self.group, self.tag = group, tag


class _Work:
    """A posted transfer: ``wait()`` blocks until it is done; a receive
    staged through the host is then copied into its CUDA tensor."""

    def __init__(self, work, posted, into=None):
        # ``posted`` (the tensor handed to the backend) lives until wait()
        self._work, self._posted, self._into = work, posted, into

    def wait(self):
        self._work.wait()
        if self._into is not None:
            self._into.copy_(self._posted)
        self._posted = self._into = None
        return True


def _post(ops, key):
    """Post ``ops`` (``P2POp``s) together; returns their ``_Work``s. On
    gloo a CUDA tensor goes through the host, and the call counts once in
    ``host_staged[key]``."""
    posted, intos, staged = [], [], False
    for o in ops:
        t, into = o.tensor, None
        if not t.is_contiguous():
            raise ValueError("point-to-point takes contiguous tensors")
        if t.is_cuda and _gloo(o.group):
            staged = True
            if o.op is isend:
                t = t.detach().cpu()
            else:
                into, t = t, torch.empty(t.shape, dtype=t.dtype)
        fn = dist.isend if o.op is isend else dist.irecv
        posted.append(dist.P2POp(fn, t, o.peer, _pg(o.group), tag=o.tag))
        intos.append(into)
    if staged:
        host_staged[key] += 1
    reqs = dist.batch_isend_irecv(posted) if posted else []
    return [_Work(w, p.tensor, into)
            for w, p, into in zip(reqs, posted, intos)]


def batch_isend_irecv(p2p_op_list):
    """Post every ``P2POp`` of the list together and return one work per
    op (``wait()`` each). Every rank named as a peer posts the matching
    op."""
    return _post(list(p2p_op_list), "batch_isend_irecv")


def isend(tensor, dst=0, group=None):
    """Start sending ``tensor`` to global rank ``dst``; returns a work."""
    return _post([P2POp(isend, tensor, dst, group)], "isend")[0]


def irecv(tensor, src=0, group=None):
    """Start receiving into ``tensor`` from global rank ``src``; returns a
    work, after whose ``wait()`` the tensor holds the data."""
    return _post([P2POp(irecv, tensor, src, group)], "irecv")[0]


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=True):
    """Send ``tensor`` to global rank ``dst`` and wait for it."""
    _post([P2POp(isend, tensor, dst, group)], "send")[0].wait()
    return tensor


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=True):
    """Receive into ``tensor`` from global rank ``src``."""
    _post([P2POp(irecv, tensor, src, group)], "recv")[0].wait()
    return tensor


# -- sequence parallel: ring rotation and tiled all-to-all ------------------

def ppermute(x, shift=1, group=None):
    """Rotate ``x`` (a tensor, or a list of tensors sent together) around
    the group: group rank i sends to rank ``(i + shift) % n`` and receives
    from rank ``(i - shift) % n`` (``lax.ppermute`` with ``perm=[(i, (i +
    shift) % n)]``). Returns new tensors in the structure given. On gloo a
    CUDA tensor goes through the host (``host_staged["ppermute"]``)."""
    single = isinstance(x, torch.Tensor)
    xs = [x] if single else list(x)
    n = get_world_size(group)
    if n == 1 or shift % n == 0:
        out = [t.clone() for t in xs]
        return out[0] if single else out
    r = get_rank(group)
    ranks = group.ranks if group is not None else list(range(n))
    dst, src = ranks[(r + shift) % n], ranks[(r - shift) % n]
    sends = [t.contiguous() for t in xs]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([P2POp(isend, t, dst, group, tag=i) for i, t in enumerate(sends)]
           + [P2POp(irecv, t, src, group, tag=i)
              for i, t in enumerate(recvs)])
    for w in _post(ops, "ppermute"):
        w.wait()
    return recvs[0] if single else recvs


def _all_to_all(x, split_axis, concat_axis, group):
    n = get_world_size(group)
    if n == 1:
        return x
    size = x.shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: dim {split_axis} ({size}) is not a "
                         f"multiple of the group's {n} ranks")
    # piece j (the j-th block of split_axis) goes to rank j, first
    pieces = x.unflatten(split_axis, (n, -1)).movedim(split_axis, 0)
    pieces = pieces.contiguous()
    out = torch.empty_like(pieces)
    dist.all_to_all_single(out, pieces, group=_pg(group))
    # out[i] came from rank i: concatenate along concat_axis in rank order
    return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_axis, concat_axis, group):
        ctx.axes, ctx.group = (split_axis, concat_axis), group
        return _all_to_all(x, split_axis, concat_axis, group)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return (_all_to_all(g, concat_axis, split_axis, ctx.group), None,
                None, None)


def all_to_all(x, split_axis, concat_axis, group=None):
    """``lax.all_to_all(x, split_axis=, concat_axis=, tiled=True)`` over
    the group, differentiable: ``x``'s ``split_axis`` is cut into n
    blocks, block j goes to rank j, and the blocks received are
    concatenated along ``concat_axis`` in rank order. The backward is the
    reverse all-to-all."""
    return _AllToAll.apply(x, split_axis, concat_axis, group)
