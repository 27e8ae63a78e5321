"""Worker functions of the port's multi-process tests (gloo, CPU).

``spawn`` starts its workers with the ``spawn`` method, so each child
imports this module by name: it imports torch, numpy and the port, and
never JAX. Each worker writes what it saw to files under ``out_dir``
(pickles that the same test run writes and reads); the tests compare them
with numpy or with the JAX package.
"""
import os
import pickle

import numpy as np
import torch

# (dp, sharding, tp) degrees, sharding stage and the step's options of
# each hybrid configuration (with the model options of MODEL_KEYS);
# "group_sharded" goes through
# distributed.sharding.group_sharded_parallel(level="p_g_os") instead of a
# strategy, which puts every rank of the world on the sharding axis
HYBRID_CONFIGS = {
    "dp4": dict(dp=4),
    "sharding4_stage1": dict(sharding=4, stage=1),
    "sharding4_stage2": dict(sharding=4, stage=2),
    "sharding4_stage3": dict(sharding=4, stage=3),
    "tp2": dict(mp=2),
    "tp2_fused_ce": dict(mp=2, fused_ce_chunk=256),
    "tp2_tied_head": dict(mp=2, tie_word_embeddings=True),
    "tp2_sharding2_stage3": dict(mp=2, sharding=2, stage=3),
    "dp2_sharding2_tp2_stage3": dict(dp=2, sharding=2, mp=2, stage=3),
    "sharding4_stage3_remat_full": dict(sharding=4, stage=3, remat="full"),
    "sharding4_stage3_remat_selective": dict(sharding=4, stage=3,
                                             remat="selective"),
    "sharding4_stage3_accumulate2": dict(sharding=4, stage=3,
                                         accumulate_steps=2),
    "group_sharded_p_g_os": dict(group_sharded="p_g_os"),
}
MODEL_KEYS = ("fused_ce_chunk", "remat", "tie_word_embeddings")
LR = 1e-3
STEPS = 3


def _dump(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def clip_grad(name, shape):
    """A stand-in full gradient for parameter ``name``: seeded by its
    name, the same on every rank."""
    seed = sum(ord(c) * (i + 1) for i, c in enumerate(name))
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _global_norm(model, step):
    """``ClipGradByGlobalNorm.global_norm`` over this rank's blocks of the
    ``clip_grad`` gradients, each placed as its optimizer state is."""
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    specs, blocks = {}, {}
    for k, p in model.named_parameters():
        specs[k] = mesh.opt_state_pspec(p.placement, p.full_shape,
                                        p.full_shape, step.stage)
        blocks[k] = torch.from_numpy(mesh.local_block(
            clip_grad(k, p.full_shape), specs[k]).copy())
    return float(ClipGradByGlobalNorm(1.0).global_norm(blocks, specs))


def _shapes(step):
    """This rank's parameter and optimizer-state blocks: name -> (shape,
    itemsize)."""
    params = {k: (tuple(t.shape), t.element_size())
              for k, t in step.state_dict()["params"].items()}
    opt = {f"{k}/{n}": (tuple(t.shape), t.element_size())
           for k, st in step.state_dict()["opt"].items()
           for n, t in st.items()}
    return params, opt


def hybrid_worker(out_dir, init_paths, batch_path, names):
    """Train LLAMA_TINY (fp32, the JAX model's initial weights from
    ``init_paths[name]``) for STEPS steps under each configuration of
    ``names``, on the first ranks of the world its degrees need; rank 0
    writes the losses and the gathered parameters, every rank of the mesh
    its block shapes."""
    import dataclasses

    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding import (
        group_sharded_parallel, save_group_sharded_model)
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    ids = np.load(batch_path)
    for name in names:
        with np.load(init_paths[name]) as z:
            init = {k: z[k] for k in z.files}
        c = dict(HYBRID_CONFIGS[name])
        kw = {k: c.pop(k) for k in MODEL_KEYS if k in c}
        accumulate = c.pop("accumulate_steps", None)
        cfg = dataclasses.replace(LLAMA_TINY, dtype="float32", **kw)

        def build():
            model = LlamaForCausalLM(cfg, device="cpu")
            return model, optimizer.AdamW(learning_rate=LR,
                                          parameters=model.parameters())

        if "group_sharded" in c:
            fleet.init(strategy=fleet.DistributedStrategy())
            model, opt, _ = group_sharded_parallel(*build(),
                                                   c["group_sharded"])
        else:
            s = fleet.DistributedStrategy()
            s.hybrid_configs.update(dp_degree=c.get("dp", 1),
                                    mp_degree=c.get("mp", 1),
                                    sharding_degree=c.get("sharding", 1))
            s.sharding = c.get("sharding", 1) > 1
            s.sharding_configs["sharding_stage"] = c.get("stage", 1)
            fleet.init(is_collective=True, strategy=s)
        mesh = fleet.get_hybrid_communicate_group().mesh
        if mesh.coords is not None:      # the ranks this mesh covers
            if "group_sharded" not in c:
                model, opt = build()
                model = fleet.distributed_model(model)
                opt = fleet.distributed_optimizer(opt)
            load_numpy_state_dict(model, init)
            step = opt.make_train_step(
                model, lambda m, x, y: m(x, labels=y),
                accumulate_steps=accumulate)
            losses = [float(step(ids, ids)) for _ in range(STEPS)]
            full = gather_state_dict(model)
            params, state = _shapes(step)
            saved = None
            if "group_sharded" in c:
                save_group_sharded_model(model, os.path.join(out_dir, name),
                                         opt)
                saved = sorted(os.listdir(os.path.join(out_dir, name)))
            # this rank's snapshot restores the trajectory
            snap = {"params": {k: v.clone() for k, v in
                               step.state_dict()["params"].items()},
                    "opt": {k: {n: t.clone() for n, t in st.items()}
                            for k, st in step.state_dict()["opt"].items()}}
            again = [float(step(ids, ids))]
            step.load_state_dict(snap)
            again.append(float(step(ids, ids)))
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"),
                  dict(shape=mesh.shape, params=params, opt=state,
                       losses=losses, global_norm=_global_norm(model, step),
                       replayed=again, saved=saved))
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=losses, params=full))
        dist.barrier()
    dist.destroy_process_group()


# -- collectives -----------------------------------------------------------

def rank_input(rank):
    """Rank r's input to every collective: float32 [4, 2]."""
    return (np.arange(8, dtype=np.float32).reshape(4, 2) * (rank + 1)
            + rank)


def collective_worker(out_dir):
    """Run each collective on the world group and on this rank's groups
    of a 2 x 2 (dp, tp) mesh; write every result to ``out_dir``."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import mesh as mesh_mod

    dist.init_parallel_env(device="cpu", timeout=300)
    rank, world = dist.get_rank(), dist.get_world_size()
    m = mesh_mod.build_mesh(dp=2, tp=2).init_groups()
    groups = {"world": None, "dp": m.group("dp"), "tp": m.group("tp")}
    out = {"rank": rank, "world_size": world,
           "is_initialized": dist.is_initialized(),
           "members": {k: (g.ranks if g is not None else list(range(world)))
                       for k, g in groups.items()}}
    x = torch.from_numpy(rank_input(rank))
    for gname, g in groups.items():
        members = out["members"][gname]
        first = members[0]
        r = {}
        for op in ("SUM", "MAX", "MIN", "PROD", "AVG"):
            r[f"all_reduce_{op}"] = dist.all_reduce(
                x.clone(), getattr(dist.ReduceOp, op), group=g).numpy()
        lst = []
        r["all_gather"] = dist.all_gather(lst, x, group=g).numpy()
        r["all_gather_list"] = np.stack([t.numpy() for t in lst])
        r["reduce_scatter"] = dist.reduce_scatter(x.clone(),
                                                  group=g).numpy()
        piece = torch.empty(4 // len(members), 2)
        dist.reduce_scatter(piece, list(x.chunk(len(members))), group=g)
        r["reduce_scatter_list"] = piece.numpy()
        r["broadcast"] = dist.broadcast(x.clone(), src=first,
                                        group=g).numpy()
        red = dist.reduce(x.clone(), dst=first, group=g)
        if rank == first:
            r["reduce"] = red.numpy()
        recv = torch.empty(4 // len(members), 2)
        dist.scatter(recv, list(x.chunk(len(members))), src=first, group=g)
        r["scatter"] = recv.numpy()
        outs = []
        dist.alltoall(list(x.chunk(len(members))), outs, group=g)
        r["alltoall"] = np.concatenate([t.numpy() for t in outs])
        r["alltoall_single"] = dist.alltoall_single(x, group=g).numpy()
        dist.barrier(group=g)
        out[gname] = r
    # DataParallel averages the gradients over the mesh's dp group
    mesh_mod.set_mesh(m)
    lin = torch.nn.Linear(2, 1, bias=False)
    with torch.no_grad():
        lin.weight.fill_(1.0)
    model = dist.DataParallel(lin)
    model(x).sum().backward()
    model.apply_collective_grads()
    out["data_parallel_grad"] = lin.weight.grad.numpy().copy()
    env = dist.ParallelEnv()
    out["parallel_env"] = (env.rank, env.world_size, env.local_rank)
    out["mp_layers"] = _mp_layers_check(m.group("tp"))
    _dump(os.path.join(out_dir, f"collective.r{rank}.pkl"), out)
    dist.destroy_process_group()
    out_after = dist.is_initialized()
    _dump(os.path.join(out_dir, f"destroyed.r{rank}.pkl"), out_after)


def _mp_layers_check(g):
    """The tensor-parallel layers on group ``g`` against the full layers
    they were cut from (the same weights on every rank): an embedding, a
    column layer gathering its output, a row layer splitting its input, a
    column head and the vocab-parallel CE. Returns {name: (got, want)}:
    the per-token losses and this rank's slice of each gradient."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)

    pt.seed(0)
    full = dict(emb=pnn.Embedding(10, 8, device="cpu"),
                col=pnn.Linear(8, 6, device="cpu"),
                row=pnn.Linear(6, 4, device="cpu"),
                head=pnn.Linear(4, 10, bias_attr=False, device="cpu"))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():          # non-zero biases, the same on every rank
        full["col"].bias.uniform_(-1, 1, generator=gen)
        full["row"].bias.uniform_(-1, 1, generator=gen)
    par = dict(emb=VocabParallelEmbedding.from_embedding(full["emb"], g),
               col=ColumnParallelLinear.from_linear(full["col"], g, True),
               row=RowParallelLinear.from_linear(full["row"], g, False),
               head=ColumnParallelLinear.from_linear(full["head"], g, False))
    ids = torch.tensor([[1, 7, 3], [9, 0, 5]])
    ce = ParallelCrossEntropy(g)
    got = ce(par["head"](par["row"](par["col"](par["emb"](ids)))), ids)
    got.sum().backward()
    logits = full["head"](full["row"](full["col"](full["emb"](ids))))
    want = pnn.functional.cross_entropy(logits, ids, reduction="none")
    want.sum().backward()
    r, n = g.rank, g.nranks

    def cut(t, dim):
        k = t.shape[dim] // n
        return t.narrow(dim, r * k, k)

    res = {"loss": (got.detach().numpy(), want.detach().numpy())}
    for name, dim in (("emb", 0), ("col", 1), ("row", 0), ("head", 1)):
        res[name] = (par[name].weight.grad.numpy(),
                     cut(full[name].weight.grad, dim).numpy())
    res["col_bias"] = (par["col"].bias.grad.numpy(),
                       cut(full["col"].bias.grad, 0).numpy())
    res["row_bias"] = (par["row"].bias.grad.numpy(),
                       full["row"].bias.grad.numpy())
    return res


def spawn_env_worker(path):
    """``tests/test_distributed.py:_spawn_worker``'s twin: record the
    environment ``spawn`` gave this rank."""
    with open(os.path.join(path, f"r{os.environ['PADDLE_TRAINER_ID']}"),
              "w") as f:
        f.write(os.environ["PADDLE_TRAINERS_NUM"] + " "
                + os.environ["RANK"] + " " + os.environ["WORLD_SIZE"])


def isolation_worker(out_dir):
    """A tp2 x sharding-free Llama step, a request through a tp2
    ``Engine``, sep2 ring and Ulysses steps, pp2 GPipe and 1F1B steps,
    expert-parallel ERNIE-MoE and GPT tp2 steps, a step pair under each
    comm-efficient strategy at dp2, a global_scatter / global_gather
    round trip and the RNG tracker's seeding on 2 ranks
    with JAX and the JAX package unimportable; writes the modules that
    got loaded anyway."""
    import sys
    for name in ("jax", "jaxlib", "paddle_tpu"):
        sys.modules[name] = None
    import dataclasses

    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import gather_state_dict
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    dist.init_parallel_env(device="cpu", timeout=120)
    s = fleet.DistributedStrategy()
    s.hybrid_configs["mp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    torch.manual_seed(0)
    model = fleet.distributed_model(LlamaForCausalLM(dataclasses.replace(
        LLAMA_TINY, dtype="float32", num_hidden_layers=1), device="cpu"))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=LR, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    losses = [float(step(ids, ids)) for _ in range(2)]
    gather_state_dict(model)
    from paddle_tpu_torch.serving import Engine
    torch.manual_seed(0)
    served = LlamaForCausalLM(dataclasses.replace(
        LLAMA_TINY, dtype="float32", num_hidden_layers=1), device="cpu")
    tokens = list(Engine(served, tp=2, n_slots=1, max_len=32, block_size=8)
                  .submit(np.arange(5), max_new_tokens=3).result())
    # a sequence-parallel step, each sep mode
    sep_losses = {}
    for mode in ("ring", "ulysses"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs["sep_degree"] = 2
        fleet.init(is_collective=True, strategy=s)
        torch.manual_seed(0)
        model = fleet.distributed_model(LlamaForCausalLM(dataclasses.replace(
            LLAMA_TINY, dtype="float32", num_hidden_layers=1,
            sequence_parallel=True, sep_mode=mode), device="cpu"))
        step = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=LR, parameters=model.parameters())
        ).make_train_step(model, lambda m, x, y: m(x, labels=y))
        sep_losses[mode] = [float(step(ids, ids)) for _ in range(2)]
    # a pipeline-parallel step, each schedule
    from paddle_tpu_torch.text.models import LlamaForCausalLMPipe
    pp_losses = {}
    for schedule in ("gpipe", "1f1b"):
        s = fleet.DistributedStrategy()
        s.hybrid_configs["pp_degree"] = 2
        fleet.init(is_collective=True, strategy=s)
        torch.manual_seed(0)
        model = fleet.distributed_model(LlamaForCausalLMPipe(
            dataclasses.replace(LLAMA_TINY, dtype="float32",
                                num_hidden_layers=2), device="cpu"))
        adam = optimizer.AdamW(learning_rate=LR,
                               parameters=model.parameters())
        step = (fleet.make_1f1b_train_step(model, adam, n_micro=2)
                if schedule == "1f1b" else
                fleet.distributed_optimizer(adam).make_train_step(
                    model, lambda m, x, y: m(x, labels=y)))
        pp_losses[schedule] = [float(step(ids, ids)) for _ in range(2)]
    # expert-parallel ERNIE-MoE and GPT under tp2, each a step pair; the
    # dispatch collectives and the RNG tracker
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)
    from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY, GPT_TINY,
                                              ErnieMoEForPretraining,
                                              GPTForCausalLM)
    s = fleet.DistributedStrategy()
    s.hybrid_configs["mp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    mp.model_parallel_random_seed(3)
    tp_losses = {}
    for name, cls, cfg in (("ernie_moe", ErnieMoEForPretraining,
                            dataclasses.replace(ERNIE_MOE_TINY,
                                                dropout=0.0)),
                           ("gpt", GPTForCausalLM,
                            dataclasses.replace(GPT_TINY, dropout=0.0))):
        torch.manual_seed(0)
        model = fleet.distributed_model(cls(cfg, device="cpu"))
        step = fleet.distributed_optimizer(optimizer.AdamW(
            learning_rate=LR, parameters=model.parameters())
        ).make_train_step(model, lambda m, x, y: m(x, labels=y))
        tp_losses[name] = [float(step(ids, ids)) for _ in range(2)]
    # each comm-efficient strategy at dp2, a step pair
    comm_losses = {}
    for field, cfg in (("comm_opt", {"grad_compress": "int8",
                                     "zero1": True}),
                       ("fp16_allreduce", {"dtype": "int8"}),
                       ("localsgd", {"k_steps": 2}),
                       ("a_sync", {"k_steps": 2}),
                       ("dgc", {"sparsity": 0.99})):
        s = fleet.DistributedStrategy()
        setattr(s, field, True)
        getattr(s, field + "_configs").update(cfg)
        fleet.init(is_collective=True, strategy=s)
        torch.manual_seed(0)
        model = fleet.distributed_model(LlamaForCausalLM(dataclasses.replace(
            LLAMA_TINY, dtype="float32", num_hidden_layers=1), device="cpu"))
        opt = (optimizer.Momentum if field == "dgc" else optimizer.AdamW)(
            learning_rate=LR, parameters=model.parameters())
        step = fleet.distributed_optimizer(opt).make_train_step(
            model, lambda m, x, y: m(x, labels=y))
        comm_losses[field] = [float(step(ids, ids)) for _ in range(2)]
    lc = np.array([1, 1])
    x = torch.ones(2, 3)
    back = global_gather(global_scatter(x, lc, lc, capacity=2), lc, lc,
                         capacity=2)
    loaded = sorted(k for k, v in sys.modules.items() if v is not None and (
        k in ("jax", "jaxlib", "paddle_tpu")
        or k.startswith(("jax.", "jaxlib.", "paddle_tpu."))))
    _dump(os.path.join(out_dir, f"isolation.r{dist.get_rank()}.pkl"),
          dict(losses=losses, tokens=tokens, sep_losses=sep_losses,
               pp_losses=pp_losses, tp_losses=tp_losses,
               comm_losses=comm_losses, dispatched=back[:2].numpy(),
               tracker_seeds=sorted(mp.get_rng_state_tracker().seeds_),
               loaded=loaded))
    dist.destroy_process_group()


# -- tensor-parallel serving ------------------------------------------------

def run_workload(eng, wl):
    """Serve workload ``wl`` on ``eng`` (the port's engine or the JAX
    package's: the same API) and return each request's tokens. ``wl``:
    ``prompts``; ``max_new``; ``kwargs`` (per-request ``submit``
    arguments) and ``common`` (arguments of every request), optional;
    ``staggered`` (two requests, two steps, then one request a step, then
    drain) or, without it, every request submitted before the drain."""
    prompts = wl["prompts"]
    kws = wl.get("kwargs") or [{}] * len(prompts)
    common = dict(wl.get("common", {}), max_new_tokens=wl["max_new"])
    hs = []
    for i, (p, kw) in enumerate(zip(prompts, kws)):
        hs.append(eng.submit(p, **common, **kw))
        if wl.get("staggered") and i >= 1:
            eng.step()
            if i == 1:
                eng.step()
    eng.drain()
    return [[int(t) for t in h.tokens] for h in hs]


def tp_model(arch, weights_path):
    """The port's fp32 tiny model of ``arch`` ("llama": LLAMA_TINY cut to
    2 layers, as ``tests/test_serving_tp.py``'s; "gpt": GPT_TINY) on the
    CPU, its weights from ``weights_path`` (the JAX model's, as .npz)."""
    import dataclasses

    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.text.models import (GPT_TINY, LLAMA_TINY,
                                              GPTForCausalLM,
                                              LlamaForCausalLM)
    if arch == "llama":
        model = LlamaForCausalLM(dataclasses.replace(
            LLAMA_TINY, dtype="float32", num_hidden_layers=2), device="cpu")
    else:
        model = GPTForCausalLM(GPT_TINY, device="cpu")
    with np.load(weights_path) as z:
        load_numpy_state_dict(model, {k: z[k] for k in z.files})
    return model.eval()


LAYER_GEO = dict(L=8, S=2, nb=6, bs=8)


def layer_inputs(h, n_kv, hd, seed=0):
    """The inputs of one layer in each body, made with numpy from ``seed``:
    a prompt x [1, 8, h] at positions 0..7; a decode batch xt [2, 1, h]
    over a full pool [6, 8, n_kv, hd] (slot 0 at position 19, slot 1 at
    9); a chunk x [1, 8, h] of slot 0 at positions 16..23."""
    g = LAYER_GEO
    rng = np.random.default_rng(seed)

    def randn(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0]], np.int32)
    write_pos = np.array([19, 9], np.int32)
    gpos = np.arange(16, 24, dtype=np.int32)
    bs = g["bs"]
    return dict(
        x=randn(1, g["L"], h), pos=np.arange(g["L"], dtype=np.int32),
        xt=randn(g["S"], 1, h), kc=randn(g["nb"], bs, n_kv, hd),
        vc=randn(g["nb"], bs, n_kv, hd), tables=tables,
        write_pos=write_pos,
        dest=(tables[np.arange(g["S"]), write_pos // bs] * bs
              + write_pos % bs).astype(np.int32),
        xc=randn(1, 8, h), gpos=gpos, table_row=tables[0],
        wdest=(tables[0][gpos // bs] * bs + gpos % bs).astype(np.int32))


def _tp_layers(model, group):
    """Layer 0's prefill, paged decode and chunk bodies on this rank's
    shards (``arch_for(model, group)``) over ``layer_inputs``: the
    hidden state each returns (replicated)."""
    from paddle_tpu_torch.text import generation as G

    arch = G.arch_for(model, group, "cpu")
    a = {k: torch.from_numpy(v) for k, v in layer_inputs(
        arch.n_heads * arch.head_dim, arch.n_kv, arch.head_dim).items()}
    kvl = arch.n_kv // group.nranks
    heads = slice(group.rank * kvl, (group.rank + 1) * kvl)

    def pool():     # this rank's kv heads of the pools, fresh each call
        return a["kc"][:, :, heads].clone(), a["vc"][:, :, heads].clone()

    lw = arch.layers[0]
    with torch.inference_mode():
        out = {"prefill": arch.prefill_layer(a["x"], lw, a["pos"])[0],
               "decode": arch.paged_decode_layer(
                   a["xt"], lw, *pool(), a["tables"], a["dest"],
                   a["write_pos"], False),
               "chunk": arch.chunk_layer(
                   a["xc"], lw, *pool(), a["table_row"], a["gpos"],
                   a["wdest"], LAYER_GEO["bs"])}
    return {k: v.numpy() for k, v in out.items()}


class _SkewedClock:
    """``time`` for the engine module with ``monotonic()`` moved by
    ``offset`` seconds."""

    def __init__(self):
        import time
        self._time = time
        self.offset = 0.0
        self.perf_counter = time.perf_counter

    def monotonic(self):
        return self._time.monotonic() + self.offset


def _skew(model, rank, skewed_rank, steps_before):
    """One request with a 600 s deadline; after ``steps_before`` steps
    rank ``skewed_rank``'s clock jumps 10^4 s ahead. Returns (finish
    reason, tokens)."""
    from paddle_tpu_torch.serving import engine as E

    clock = _SkewedClock()
    saved, E.time = E.time, clock
    try:
        eng = E.Engine(model, tp=2, n_slots=2, max_len=64,
                       min_prompt_bucket=4, block_size=8)
        h = eng.submit(np.arange(5), max_new_tokens=8, max_time_s=600.0)
        for _ in range(steps_before):
            eng.step()
        if rank == skewed_rank:
            clock.offset = 1e4
        eng.drain()
    finally:
        E.time = saved
    return h.finish_reason, list(h.tokens)


def serving_tp_worker(out_dir, spec_path):
    """One rank of a tp engine over gloo on the CPU: every job of the
    spec (an engine's arguments and a workload) on ``Engine(model,
    tp=world)``; with 2 ranks also the tp bodies of layer 0, the
    collectives of one decode step, a skewed clock on either rank, and
    the submit guard. Writes what it saw to ``out_dir``."""
    import pickle as pk
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective_matmul as cm
    from paddle_tpu_torch.distributed import mesh
    from paddle_tpu_torch.serving import Engine

    dist.init_parallel_env(device="cpu", timeout=120)
    rank, world = dist.get_rank(), dist.get_world_size()
    with open(spec_path, "rb") as f:
        spec = pk.load(f)
    models = {a: tp_model(a, p) for a, p in spec["weights"].items()}
    out = {"jobs": {}}
    for name, job in spec["jobs"].items():
        eng = Engine(models[job["arch"]], tp=world, **job["engine"])
        toks = run_workload(eng, job["workload"])
        out["jobs"][name] = dict(tokens=toks, stats=eng.stats(),
                                 refcounts=eng.cache.check_refcounts(),
                                 snapshot=eng.metrics.snapshot())
    if world == 2:
        group = mesh.build_mesh(tp=2).init_groups().group("tp")
        out["layers"] = {a: _tp_layers(m, group) for a, m in models.items()}
        # the collectives of one decode step, nothing else in the step
        eng = Engine(models["llama"], tp=2, n_slots=2, max_len=64,
                     min_prompt_bucket=4, block_size=8)
        h = eng.submit(np.arange(5), max_new_tokens=4)
        for k in cm.launches:
            cm.launches[k] = 0
        eng.step()
        out["step_collectives"] = dict(cm.launches)
        out["step_geometry"] = eng.tp_geometry()
        h.result()
        out["skew"] = {f"rank {r} ahead": _skew(models["llama"], rank, r, 2)
                       for r in (1, 0)}
        # the submit guard: the ranks submit different prompts
        try:
            eng.submit(np.arange(3 + rank), max_new_tokens=2)
            out["guard"] = "no error"
        except RuntimeError as e:
            out["guard"] = str(e)
        out["after_guard"] = list(eng.submit(np.arange(4),
                                             max_new_tokens=2).result())
    with open(os.path.join(out_dir, f"tp{world}.r{rank}.pkl"), "wb") as f:
        pk.dump(out, f)
    dist.destroy_process_group()


# -- sequence parallel ------------------------------------------------------

# (sep_mode, n, causal, (B, L, Hq, Hkv, D), dtype) of each body case: the
# ring and Ulysses bodies on n of the world's ranks, against the JAX
# bodies under jax.vmap(axis_name="sep")
SEP_OP_CASES = {
    "ring_n2_causal": ("ring", 2, True, (2, 64, 8, 4, 16), "float32"),
    "ring_n4_causal": ("ring", 4, True, (2, 64, 8, 4, 16), "float32"),
    "ring_n4_full": ("ring", 4, False, (2, 64, 8, 4, 16), "float32"),
    # 128-position chunks: the flash route (its plain version on the CPU)
    "ring_n2_causal_flash_route": ("ring", 2, True, (1, 256, 4, 2, 32),
                                   "float32"),
    "ring_n4_causal_bf16": ("ring", 4, True, (2, 64, 8, 4, 16), "bfloat16"),
    "ulysses_n2_causal": ("ulysses", 2, True, (2, 64, 8, 4, 16), "float32"),
    "ulysses_n4_causal": ("ulysses", 4, True, (2, 64, 8, 4, 16), "float32"),
    # kv heads 2 at n = 4: repeated up before the all-to-all
    "ulysses_n4_full_kv2": ("ulysses", 4, False, (2, 64, 8, 2, 16),
                            "float32"),
    "ulysses_n4_causal_bf16": ("ulysses", 4, True, (2, 64, 8, 4, 16),
                               "bfloat16"),
}


def sep_op_inputs(name):
    """(q, k, v, dout) fp32 numpy arrays of a body case, from its name."""
    _, _, _, (B, L, Hq, Hkv, D), _ = SEP_OP_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, L, Hq, D), (B, L, Hkv, D), (B, L, Hkv, D),
                           (B, L, Hq, D)))


def sep_ops_worker(out_dir, names):
    """Each body case of ``names`` on its first n ranks: this rank's
    output shard and the gradients of its q/k/v shards under the case's
    dout; also the host-staged ppermute count. Writes one pickle per
    rank."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.ops.ring_attention import (ring_attention,
                                                     ring_attention_local)
    from paddle_tpu_torch.ops.ulysses_attention import (
        ulysses_attention, ulysses_attention_local)

    dist.init_parallel_env(device="cpu", timeout=120)
    rank = dist.get_rank()
    bodies = {"ring": ring_attention_local,
              "ulysses": ulysses_attention_local}
    entries = {"ring": ring_attention, "ulysses": ulysses_attention}
    out = {}
    for name in names:
        mode, n, causal, _, dtype = SEP_OP_CASES[name]
        m = mesh_mod.build_mesh(sep=n).init_groups()
        if m.coords is None:
            continue
        g = m.group("sep")
        dt = getattr(torch, dtype)
        q, k, v, do = (torch.from_numpy(a).to(dt)
                       for a in sep_op_inputs(name))
        per = q.shape[1] // n
        blk = slice(g.rank * per, (g.rank + 1) * per)
        qs, ks, vs = (t[:, blk].clone().requires_grad_() for t in (q, k, v))
        o = bodies[mode](qs, ks, vs, g, causal=causal)
        o.backward(do[:, blk])
        # the entry point on whole arrays: the same output, gathered, and
        # the whole gradients
        qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
        ow = entries[mode](qw, kw, vw, mesh=m, causal=causal)
        ow.backward(do)
        out[name] = dict(block=(blk.start, blk.stop),
                         out=o.detach().float().numpy(),
                         grads=[t.grad.float().numpy() for t in (qs, ks, vs)],
                         whole=[t.detach().float().numpy() for t in
                                (ow, qw.grad, kw.grad, vw.grad)])
    out["host_staged"] = dict(C.host_staged)
    # chip_smoke's phase-15a judging on 2 ranks at a small bf16 shape:
    # the bodies pass the flash judges, the planted faults fail them
    import chip_smoke
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops import ulysses_attention as ua
    m = mesh_mod.build_mesh(sep=2).init_groups()
    if m.coords is not None:
        out["judged"] = chip_smoke.sep_ops(fa, fc, rm, C, ra, ua,
                                           m.group("sep"), (1, 256, 4, 32),
                                           device="cpu")
    _dump(os.path.join(out_dir, f"sepops.r{rank}.pkl"), out)
    dist.destroy_process_group()


# degrees, sep_mode and the model options (MODEL_KEYS) of each sequence-
# parallel configuration
SEP_CONFIGS = {
    "sep4_ring": dict(sep=4, sep_mode="ring"),
    "sep4_ulysses": dict(sep=4, sep_mode="ulysses"),
    "sep2_ring_fused_ce_remat": dict(sep=2, sep_mode="ring",
                                     fused_ce_chunk=256, remat="selective"),
    "dp2_sep4_ulysses": dict(dp=2, sep=4, sep_mode="ulysses"),
}


def sep_worker(out_dir, init_paths, batch_path, names):
    """Train LLAMA_TINY (fp32, ``sequence_parallel=True``, the JAX
    model's initial weights) for STEPS steps under each sequence-parallel
    configuration of ``names`` on the first ranks of the world its
    degrees need, on the batch ``batch_path`` (ids, labels and the
    full-sequence ids). Every rank of the mesh writes its losses; rank 0
    also the gathered parameters, the logits of the whole sequence called
    outside the step on the sep mesh (before training), and the error a
    sequence length that does not divide gives."""
    import dataclasses

    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    with np.load(batch_path) as z:
        batch = {k: z[k] for k in z.files}
    for name in names:
        with np.load(init_paths[name]) as z:
            init = {k: z[k] for k in z.files}
        c = dict(SEP_CONFIGS[name])
        kw = {k: c.pop(k) for k in MODEL_KEYS + ("sep_mode",) if k in c}
        cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                                  sequence_parallel=True, **kw)
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=c.get("dp", 1),
                                sep_degree=c["sep"])
        fleet.init(is_collective=True, strategy=s)
        mesh = fleet.get_hybrid_communicate_group().mesh
        if mesh.coords is not None:
            model = fleet.distributed_model(LlamaForCausalLM(cfg,
                                                             device="cpu"))
            load_numpy_state_dict(model, init)
            with torch.no_grad():          # the whole sequence, no shard
                logits = model(batch["ids"]).numpy()
            opt = fleet.distributed_optimizer(optimizer.AdamW(
                learning_rate=LR, parameters=model.parameters()))
            step = opt.make_train_step(model,
                                       lambda m, x, y: m(x, labels=y))
            labels = batch["labels_fused" if "fused_ce_chunk" in kw
                           else "labels"]
            losses = [float(step(batch["ids"], labels))
                      for _ in range(STEPS)]
            try:
                step(batch["ids"][:, :-1], labels[:, :-1])
                odd = "no error"
            except ValueError as e:
                odd = str(e)
            full = gather_state_dict(model)
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"),
                  dict(losses=losses))
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=losses, params=full, logits=logits,
                           odd_length=odd))
        dist.barrier()
    dist.destroy_process_group()


# -- pipeline parallel --------------------------------------------------------

# name -> (body, stage, pp degree, n_micro): the port's pipeline bodies
# against the JAX ones (tests/test_torch_pipeline.py)
PIPE_OP_CASES = {
    **{f"{body}_tanh_pp{P}_micro{M}": (body, "tanh", P, M)
       for body in ("gpipe", "1f1b") for P in (2, 4) for M in (2, 4, 8)},
    **{f"{body}_decoder_pp{P}_micro{M}": (body, "decoder", P, M)
       for body in ("gpipe", "1f1b") for P, M in ((2, 4), (4, 4))},
}
# name -> (case it plants into, fault: a key of chip_smoke.PP_FAULTS)
PIPE_FAULTS = {
    "gpipe_stages_in_the_wrong_order": ("gpipe_tanh_pp4_micro4",
                                        "wrong_order"),
    "1f1b_stages_in_the_wrong_order": ("1f1b_tanh_pp4_micro4",
                                       "wrong_order"),
    "gpipe_cotangent_paired_with_the_next_input": ("gpipe_tanh_pp2_micro4",
                                                   "next_input"),
    "1f1b_cotangent_paired_with_the_next_input": ("1f1b_tanh_pp2_micro4",
                                                  "next_input"),
    "gpipe_replicate_backward_sums_over_pp": ("gpipe_tanh_pp2_micro4",
                                              "sum_over_pp"),
}
PIPE_TINY = dict(hidden=256, heads=8, kv=4, ffn=688, seq=32, eps=1e-5,
                 theta=10000.0)


def pipe_op_inputs(name):
    """float32 numpy inputs of a case: the stacked stage weights (a dict),
    the last stage's parameters, the batch x, the targets and the
    cotangent of the GPipe output."""
    _, stage, P, M = PIPE_OP_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))

    def rnd(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    if stage == "tanh":            # 2 layers a stage, hidden 16
        stacked = {"w": rnd(2 * P, 16, 16, scale=0.3)}
        last = {"w": rnd(16, 16, scale=0.3)}
        x, tgt, ct = (rnd(2 * M, 16) for _ in range(3))
    else:                          # one LLAMA_TINY layer a stage
        c = PIPE_TINY
        h, ff, kvw = c["hidden"], c["ffn"], c["kv"] * c["hidden"] // c["heads"]
        stacked = {"wq": rnd(P, h, h, scale=0.05),
                   "wk": rnd(P, h, kvw, scale=0.05),
                   "wv": rnd(P, h, kvw, scale=0.05),
                   "wo": rnd(P, h, h, scale=0.05),
                   "wg": rnd(P, h, ff, scale=0.05),
                   "wu": rnd(P, h, ff, scale=0.05),
                   "wd": rnd(P, ff, h, scale=0.05),
                   "ln1": 1 + rnd(P, h, scale=0.1),
                   "ln2": 1 + rnd(P, h, scale=0.1)}
        last = {"w": rnd(h, scale=0.3)}
        x, tgt, ct = (rnd(M, c["seq"], h) for _ in range(3))
    return stacked, last, x, tgt, ct


def pipe_last_fn(lp, y, t):
    """The per-micro-batch loss after the last stage, in either package
    (``@`` and ``*`` on their arrays)."""
    y = y @ lp["w"] if lp["w"].ndim == 2 else y * lp["w"]
    return ((y - t) ** 2).mean()


def _pipe_stage(stage):
    import functools

    import torch as T
    if stage == "tanh":
        def tanh_stack(c, x):
            for i in range(c["w"].shape[0]):
                x = T.tanh(x @ c["w"][i])
            return x
        return tanh_stack
    from paddle_tpu_torch.text.models.llama_pipe import _decoder_chunk
    c = PIPE_TINY
    return functools.partial(_decoder_chunk, n_heads=c["heads"],
                             n_kv=c["kv"], eps=c["eps"], theta=c["theta"])


def pipe_ops_worker(out_dir, names):
    """Run each case (or planted fault) of ``names`` on the first P ranks
    of the world: GPipe's output and, after a backward of the case's
    cotangent, this rank's chunk gradients and x's gradient; 1F1B's loss,
    chunk gradients, last-stage gradients and dx; and max_in_flight.
    Each rank of the case's mesh writes its own."""
    import contextlib

    torch.set_num_threads(1)
    from chip_smoke import pp_fault
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import mesh as M_
    from paddle_tpu_torch.ops import pipeline as pl

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    meshes = {}
    for name in names:
        case, fault = (name, None) if name in PIPE_OP_CASES \
            else PIPE_FAULTS[name]
        body, stage, P, n_micro = PIPE_OP_CASES[case]
        if P not in meshes:
            meshes[P] = M_.build_mesh(pp=P).init_groups()
        m = meshes[P]
        if m.coords is not None:
            stacked, last, x, tgt, ct = (
                {k: torch.from_numpy(v) for k, v in a.items()}
                if isinstance(a, dict) else torch.from_numpy(a)
                for a in pipe_op_inputs(case))
            fn = _pipe_stage(stage)
            p = m.axis_index("pp")
            with (pp_fault(pl, C, fault) if fault else
                  contextlib.nullcontext()):
                if body == "gpipe":
                    w = {k: v.clone().requires_grad_()
                         for k, v in stacked.items()}
                    xg = x.clone().requires_grad_()
                    y = pl.spmd_pipeline(fn, w, xg, mesh=m, n_micro=n_micro)
                    y.backward(ct)
                    k0 = next(iter(w.values())).shape[0] // P
                    res = dict(out=y.detach().numpy(),
                               grads={k: v.grad[p * k0:(p + 1) * k0].numpy()
                                      for k, v in w.items()},
                               dx=xg.grad.numpy())
                else:
                    loss, g, lg, dx = pl.pipeline_1f1b(
                        fn, pipe_last_fn, stacked, x, tgt, last_params=last,
                        mesh=m, n_micro=n_micro)
                    res = dict(loss=float(loss),
                               grads={k: v.numpy() for k, v in g.items()},
                               last_grads={k: v.numpy()
                                           for k, v in lg.items()},
                               dx=dx.numpy())
            res["max_in_flight"] = pl.counters["max_in_flight"]
            _dump(os.path.join(out_dir, f"{name}.r{p}.pkl"), res)
        dist.barrier()
    dist.destroy_process_group()


# pipeline-parallel train steps: (dp, pp) degrees, the schedule, the
# model's n_micro and strategy.pipeline's accumulate_steps
PP_CONFIGS = {
    "gpipe_pp2": dict(pp=2),
    "gpipe_pp4": dict(pp=4),
    "1f1b_pp2_micro2": dict(pp=2, schedule="1f1b", n_micro=2),
    "1f1b_pp2_micro4": dict(pp=2, schedule="1f1b", n_micro=4),
    "1f1b_pp4": dict(pp=4, schedule="1f1b", n_micro=4),
    "gpipe_dp2_pp2": dict(dp=2, pp=2),
    "1f1b_dp2_pp2": dict(dp=2, pp=2, schedule="1f1b", n_micro=2),
    "gpipe_pp2_pipeline_accumulate2": dict(pp=2, accumulate=2),
}
PP_LAYERS = 4
REPLICATED = ("embed_tokens.weight", "norm.weight", "lm_head.weight")


def pp_worker(out_dir, init_path, batch_path, names):
    """Train fp32 ``LlamaForCausalLMPipe`` (LLAMA_TINY, PP_LAYERS layers,
    the JAX model's initial weights) for STEPS steps under each
    configuration of ``names`` on the first ranks of the world its degrees
    need. Every rank of the mesh writes its losses, a digest of its
    replicated parameters after each step, max_in_flight and the shapes
    it holds; rank 0 also the gathered parameters."""
    import dataclasses
    import hashlib

    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.ops import pipeline as pl
    from paddle_tpu_torch.text.models import LlamaForCausalLMPipe
    from paddle_tpu_torch.text.models.llama import LLAMA_TINY

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    with np.load(init_path) as z:
        init = {k: z[k] for k in z.files}
    with np.load(batch_path) as z:
        ids, labels = z["ids"], z["labels"]
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32",
                              num_hidden_layers=PP_LAYERS)
    for name in names:
        c = PP_CONFIGS[name]
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=c.get("dp", 1), pp_degree=c["pp"])
        if "accumulate" in c:
            s.pipeline = True
            s.pipeline_configs["accumulate_steps"] = c["accumulate"]
        fleet.init(is_collective=True, strategy=s)
        mesh = fleet.get_hybrid_communicate_group().mesh
        if mesh.coords is not None:
            model = fleet.distributed_model(LlamaForCausalLMPipe(
                cfg, n_micro=c.get("n_micro"), device="cpu"))
            load_numpy_state_dict(model, init)
            adam = optimizer.AdamW(learning_rate=LR,
                                   parameters=model.parameters())
            if c.get("schedule") == "1f1b":
                step = fleet.make_1f1b_train_step(
                    model, adam, n_micro=c["n_micro"],
                    strategy=fleet.get_strategy())
            else:
                step = fleet.distributed_optimizer(adam).make_train_step(
                    model, lambda m, x, y: m(x, labels=y))
            losses, digests, in_flight = [], [], []
            for _ in range(STEPS):
                losses.append(float(step(ids, labels)))
                in_flight.append(pl.counters["max_in_flight"])
                digests.append({k: hashlib.sha256(
                    p.detach().numpy().tobytes()).hexdigest()
                    for k, p in model.named_parameters() if k in REPLICATED})
            full = gather_state_dict(model)
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"), dict(
                losses=losses, digests=digests, in_flight=in_flight,
                stage=fleet.get_hybrid_communicate_group().get_stage_id(),
                shapes={k: tuple(p.shape)
                        for k, p in model.named_parameters()}))
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=losses, params=full))
        dist.barrier()
    dist.destroy_process_group()


# -- expert parallel (ERNIE-MoE under mp_degree) ------------------------------

# degrees and options of each expert-parallel configuration: "dispatch"
# the MoE layers' dispatch mode (sparse: with the ragged kernel),
# "dropout" the config's, "fault" a key of chip_smoke.EP_FAULTS, and
# "world1" a one-rank mesh on rank 0 (the port's own single-rank step)
EP_CONFIGS = {
    "mp2": dict(mp=2),
    "mp4": dict(mp=4),
    "dp2_mp2": dict(dp=2, mp=2),
    "dp4": dict(dp=4),
    "mp2_dense": dict(mp=2, dispatch="dense"),
    "mp3": dict(mp=3),
    "mp2_dropout": dict(mp=2, dropout=0.1),
    "world1_dropout": dict(world1=True, dropout=0.1),
    "mp2_dx_not_reduced": dict(mp=2, fault="dx_not_reduced"),
    "mp2_reduce_backward_sums": dict(mp=2, fault="reduce_backward_sums"),
}
EP_SEED = 7


def _fleet_mesh(fleet, mesh_mod, c):
    """The configuration's mesh: ``fleet.init`` over its degrees, or a
    one-rank mesh on rank 0 (None on the other ranks) for "world1"."""
    from paddle_tpu_torch import distributed as dist
    if c.get("world1"):
        m = mesh_mod.build_mesh(world_size=1, rank=0)
        mesh_mod.set_mesh(m if dist.get_rank() == 0 else None)
        return m if dist.get_rank() == 0 else None
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=c.get("dp", 1),
                            mp_degree=c.get("mp", 1),
                            sharding_degree=c.get("sharding", 1))
    s.sharding = c.get("sharding", 1) > 1
    s.sharding_configs["sharding_stage"] = c.get("stage", 1)
    fleet.init(is_collective=True, strategy=s)
    m = fleet.get_hybrid_communicate_group().mesh
    return m if m.coords is not None else None


def ep_worker(out_dir, init_path, batch_path, names):
    """Train ERNIE_MOE_TINY (fp32, the JAX model's initial weights) for
    STEPS steps under each configuration of ``names`` on the first ranks
    of the world its degrees need. Every rank of the mesh writes its
    losses, its expert banks' shapes, the shapes of the expert inputs
    ``ragged_dot`` was given, the MoE layers' tp groups, the warnings the
    model's construction gave and the tracker's seeds of
    ``model_parallel_random_seed``; rank 0 also the gathered
    parameters."""
    import contextlib
    import dataclasses
    import warnings
    from unittest import mock

    torch.set_num_threads(1)
    import chip_smoke
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer, seed
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mp
    from paddle_tpu_torch.framework import random_seed
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.nn import moe as moe_mod
    from paddle_tpu_torch.text.models import (ERNIE_MOE_TINY,
                                              ErnieMoEForPretraining)

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    with np.load(init_path) as z:
        init = {k: z[k] for k in z.files}
    with np.load(batch_path) as z:
        ids, labels = z["ids"], z["labels"]
    real_ragged = moe_mod.ragged_dot
    for name in names:
        c = EP_CONFIGS[name]
        m = _fleet_mesh(fleet, mesh_mod, c)
        if m is not None:
            seed(EP_SEED)
            cfg = dataclasses.replace(ERNIE_MOE_TINY,
                                      dropout=c.get("dropout", 0.0))
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                model = ErnieMoEForPretraining(cfg, device="cpu")
            for layer in model.moe_layers():
                layer.dispatch_mode = c.get("dispatch", "sparse")
                layer.expert_kernel = "ragged"
            opt = optimizer.AdamW
            if c.get("world1"):     # the one-rank mesh: no fleet
                load_numpy_state_dict(model, init)
                step = fleet.make_train_step(
                    model, opt(learning_rate=LR,
                               parameters=model.parameters()),
                    lambda mm, x, y: mm(x, labels=y))
            else:
                model = fleet.distributed_model(model)
                load_numpy_state_dict(model, init)
                step = fleet.distributed_optimizer(opt(
                    learning_rate=LR, parameters=model.parameters())
                ).make_train_step(model, lambda mm, x, y: mm(x, labels=y))
            shapes = []

            def ragged(x, w, counts):
                shapes.append(tuple(x.shape))
                return real_ragged(x, w, counts)

            fault = (chip_smoke.ep_fault(moe_mod, c["fault"])
                     if "fault" in c else contextlib.nullcontext())
            with fault, mock.patch.object(moe_mod, "ragged_dot", ragged):
                losses = [float(step(ids, labels)) for _ in range(STEPS)]
            full = gather_state_dict(model)
            if not c.get("world1"):
                mp.model_parallel_random_seed(1234)
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"), dict(
                losses=losses,
                banks={k: tuple(p.shape) for k, p in model.named_parameters()
                       if k.endswith(("w_up", "w_down"))},
                ragged_shapes=sorted(set(shapes)),
                ep_ranks=[None if layer.ep_group is None
                          else list(layer.ep_group.ranks)
                          for layer in model.moe_layers()],
                warnings=[str(w.message) for w in caught],
                tracker_seeds=sorted(mp.get_rng_state_tracker().seeds_),
                global_seed=random_seed._seed_value))
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=losses, params=full))
        dist.barrier()
    dist.destroy_process_group()


# -- GPT training (one rank and tp) -------------------------------------------

GPT_CONFIGS = {
    "world1": dict(world1=True),
    "tp2": dict(mp=2),
    "tp4": dict(mp=4),
    "dp2_tp2": dict(dp=2, mp=2),
    "sharding2_stage3": dict(sharding=2, stage=3),
    "sharding2_tp2_stage3": dict(sharding=2, mp=2, stage=3),
}


def gpt_worker(out_dir, init_path, batch_path, names):
    """Train GPT_TINY (fp32, dropout 0, the JAX model's initial weights)
    for STEPS steps under each configuration of ``names`` on the first
    ranks of the world its degrees need. Every rank of the mesh writes its
    losses, its parameter blocks (name -> array) and the stage-3 units;
    rank 0 also the gathered parameters."""
    import dataclasses

    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import mesh as mesh_mod
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.text.models import GPT_TINY, GPTForCausalLM

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    with np.load(init_path) as z:
        init = {k: z[k] for k in z.files}
    with np.load(batch_path) as z:
        ids = z["ids"]
    cfg = dataclasses.replace(GPT_TINY, dropout=0.0)
    for name in names:
        c = GPT_CONFIGS[name]
        m = _fleet_mesh(fleet, mesh_mod, c)
        if m is not None:
            model = GPTForCausalLM(cfg, device="cpu")
            adam = optimizer.AdamW
            if c.get("world1"):
                load_numpy_state_dict(model, init)
                step = fleet.make_train_step(
                    model, adam(learning_rate=LR,
                                parameters=model.parameters()),
                    lambda mm, x, y: mm(x, labels=y))
            else:
                model = fleet.distributed_model(model)
                load_numpy_state_dict(model, init)
                step = fleet.distributed_optimizer(adam(
                    learning_rate=LR, parameters=model.parameters())
                ).make_train_step(model, lambda mm, x, y: mm(x, labels=y))
            losses = [float(step(ids, ids)) for _ in range(STEPS)]
            full = gather_state_dict(model)
            s3 = getattr(model, "_stage3", None)
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"), dict(
                losses=losses,
                blocks={k: p.detach().numpy().copy()
                        for k, p in model.named_parameters()},
                units=None if s3 is None else sorted(
                    type(u).__name__ for u, _ in s3._units.values())))
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=losses, params=full))
        dist.barrier()
    dist.destroy_process_group()


# -- global_scatter / global_gather -------------------------------------------

# the reference docstring's example (tests/test_global_dispatch.py): world
# size 2, 2 experts a rank, d_model 2; both ranks send the same rows
DISPATCH_X = np.array([[1, 2], [3, 4], [5, 6], [7, 8], [9, 10]], np.float32)
DISPATCH_LC = np.array([[2, 1, 1, 1], [1, 1, 2, 1]], np.int64)
DISPATCH_GC = np.array([[2, 1, 1, 1], [1, 1, 2, 1]], np.int64)
DISPATCH_CAPACITY = 5


def dispatch_inputs():
    """(x [2, 5, 3], cotangent of a scatter, of a gather): per-rank random
    inputs for the round trip and the gradients."""
    rng = np.random.default_rng(0)
    n = 2 * 2 * DISPATCH_CAPACITY
    return (rng.standard_normal((2, 5, 3)).astype(np.float32),
            rng.standard_normal((2, n, 3)).astype(np.float32),
            rng.standard_normal((2, n, 3)).astype(np.float32))


def dispatch_worker(out_dir):
    """On 2 ranks: ``global_scatter`` and ``global_gather`` of the
    reference example, the round trip, each one's gradient under a random
    cotangent, and the error a bucket above ``capacity`` gives."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)

    dist.init_parallel_env(device="cpu", timeout=120)
    r = dist.get_rank()
    lc, gc, cap = DISPATCH_LC[r], DISPATCH_GC[r], DISPATCH_CAPACITY
    x = torch.from_numpy(DISPATCH_X)
    out = dict(scatter=global_scatter(x, lc, gc, capacity=cap).numpy(),
               gather=global_gather(x, torch.from_numpy(lc),
                                    torch.from_numpy(gc),
                                    capacity=cap).numpy())
    xs, ct_s, ct_g = (torch.from_numpy(a[r]) for a in dispatch_inputs())
    mid = global_scatter(xs, lc, gc, capacity=cap)
    out["round_trip"] = global_gather(mid, lc, gc, capacity=cap).numpy()
    for name, fn, ct in (("scatter", global_scatter, ct_s),
                         ("gather", global_gather, ct_g)):
        xg = xs.clone().requires_grad_()
        (fn(xg, lc, gc, capacity=cap) * ct).sum().backward()
        out[f"{name}_grad"] = xg.grad.numpy()
    try:
        global_scatter(x, lc, gc, capacity=1)
        out["over_capacity"] = "no error"
    except ValueError as e:
        out["over_capacity"] = str(e)
    _dump(os.path.join(out_dir, f"dispatch.r{r}.pkl"), out)
    dist.destroy_process_group()


# -- the comm-efficient data-parallel strategies ------------------------------

def _co(dp, compress=None, zero1=False, **kw):
    return dict(mode="comm_opt", dp=dp,
                cfg={"grad_compress": compress, "zero1": zero1,
                     "tp_overlap": True, "qblock": 64}, **kw)


# each configuration: the strategy field ("mode") and its configs, the dp
# and mp degrees, the model ("llama": LLAMA_TINY fp32 on the 8 x 32 batch;
# "tp_mlp": the JAX package's TP MLP on its 64 x 8 regression), the
# optimizer ("adamw" lr 1e-3; "adam" lr 1e-2, the TP MLP's; "momentum" 0.9
# lr 1e-3; "sgd" lr 5e-2; "adamw_decay_fun": AdamW with
# apply_decay_param_fun, the per-parameter arm) and a planted fault (a
# key of chip_smoke.COMM_FAULTS); "trainstep" is the port's plain dp
# TrainStep
COMM_CONFIGS = {
    **{f"co_dp{dp}_{name}": _co(dp, *args)
       for dp in (2, 4)
       for name, args in (("exact", ()), ("bf16", ("bf16",)),
                          ("int8", ("int8",)), ("zero1", (None, True)),
                          ("zero1_int8", ("int8", True)))},
    "co_dp2_tp2_llama_int8": _co(2, "int8", mp=2),
    "co_dp2_tp2_mlp": _co(2, mp=2, model="tp_mlp", opt="adam"),
    "co_dp2_tp2_mlp_int8": _co(2, "int8", mp=2, model="tp_mlp", opt="adam"),
    "co_dp2_int8_per_param": _co(2, "int8", opt="adamw_decay_fun"),
    "co_dp2_int8_e1_dropped": _co(2, "int8", fault="e1_dropped"),
    "co_dp2_zero1_slice_off": _co(2, None, True, fault="zero1_slice_off"),
    "fp_dp4_bf16": dict(mode="fp16_allreduce", dp=4,
                        cfg={"dtype": "bfloat16"}),
    "fp_dp4_int8": dict(mode="fp16_allreduce", dp=4, cfg={"dtype": "int8"}),
    "lsgd_dp2_k1": dict(mode="localsgd", dp=2, opt="sgd",
                        cfg={"k_steps": 1, "begin_step": 1}),
    "lsgd_dp4_k2": dict(mode="localsgd", dp=4,
                        cfg={"k_steps": 2, "begin_step": 1}),
    "trainstep_dp2": dict(mode="trainstep", dp=2, opt="sgd", cfg={}),
    "geo_dp4_k2": dict(mode="a_sync", dp=4, cfg={"k_steps": 2}),
    "geo_dp4_k2_mean": dict(mode="a_sync", dp=4, cfg={"k_steps": 2},
                            fault="geo_mean"),
    "dgc_dp2": dict(mode="dgc", dp=2, opt="momentum",
                    cfg={"momentum": None, "sparsity": 0.99}),
    "dgc_dp2_clip": dict(mode="dgc", dp=2, opt="momentum",
                         cfg={"momentum": None, "sparsity": 0.99,
                              "clip_norm": 0.5}),
    "dgc_dp2_not_cleared": dict(mode="dgc", dp=2, opt="momentum",
                                cfg={"momentum": None, "sparsity": 0.99},
                                fault="dgc_not_cleared"),
}
COMM_LR = {"adamw": 1e-3, "adam": 1e-2, "momentum": 1e-3, "sgd": 5e-2,
           "adamw_decay_fun": 1e-3}


def comm_decay(name):
    """The per-parameter arm's ``apply_decay_param_fun``: every name
    decays (the JAX package passes another name than the port)."""
    return True


def comm_optimizer(optimizer, kind, params):
    lr = COMM_LR[kind]
    if kind == "momentum":
        return optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                  parameters=params)
    if kind == "adam":
        return optimizer.Adam(learning_rate=lr, parameters=params)
    if kind == "sgd":
        return optimizer.SGD(learning_rate=lr, parameters=params)
    return optimizer.AdamW(
        learning_rate=lr, parameters=params,
        apply_decay_param_fun=comm_decay if kind == "adamw_decay_fun"
        else None)


def tp_mlp_data():
    """The JAX package's TP MLP regression (tests/test_comm_opt.py)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    w = rng.standard_normal((8,)).astype(np.float32)
    return x, (x @ w)[:, None].astype(np.float32)


def mse(m, x, y):
    return ((m(x) - y) ** 2).mean()


def _tp_mlp():
    """The JAX package's TP MLP: ``ColumnParallelLinear(8, 32)`` (output
    split), tanh, ``RowParallelLinear(32, 8)`` (input split), tanh, a
    head."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)

    class TPMLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.c = ColumnParallelLinear(8, 32, gather_output=False,
                                          device="cpu")
            self.r = RowParallelLinear(32, 8, input_is_parallel=True,
                                       device="cpu")
            self.head = pnn.Linear(8, 1, device="cpu")

        def forward(self, x):
            return self.head(torch.tanh(self.r(torch.tanh(self.c(x)))))

    return TPMLP()


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    return tree.clone()


def _spread(reps):
    """Max abs difference of any replica's parameter from replica 0's."""
    return max(float((v - v[:1]).abs().max()) for v in reps.values())


def comm_worker(out_dir, init_paths, batch_path, names):
    """Train under each comm-efficient configuration of ``names`` for
    STEPS steps on the first ranks of the world its degrees need, from the
    JAX model's initial weights (``init_paths[name]``), with the planted
    fault of the configuration. Every rank of the mesh writes its losses
    and what its step reports; rank 0 also the parameters (every
    replica's, ``[dp, ...]``, for LocalSGD and Geo)."""
    import contextlib
    import dataclasses
    from unittest import mock

    torch.set_num_threads(1)
    import chip_smoke
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import comm_efficient as ce
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    ids = np.load(batch_path)
    real_top_k = ce._top_k
    for name in names:
        c = COMM_CONFIGS[name]
        with np.load(init_paths[name]) as z:
            init = {k: z[k] for k in z.files}
        s = fleet.DistributedStrategy()
        s.hybrid_configs.update(dp_degree=c["dp"], mp_degree=c.get("mp", 1))
        if c["mode"] != "trainstep":
            setattr(s, c["mode"], True)
            setattr(s, c["mode"] + "_configs", dict(c["cfg"]))
        fleet.init(is_collective=True, strategy=s)
        mesh = fleet.get_hybrid_communicate_group().mesh
        if mesh.coords is not None:
            if c.get("model") == "tp_mlp":
                model = fleet.distributed_model(_tp_mlp())
                batch, loss_fn = tp_mlp_data(), mse
            else:
                model = fleet.distributed_model(LlamaForCausalLM(
                    dataclasses.replace(LLAMA_TINY, dtype="float32"),
                    device="cpu"))
                batch, loss_fn = (ids, ids), (lambda m, x, y: m(x, labels=y))
            load_numpy_state_dict(model, init)
            opt = fleet.distributed_optimizer(comm_optimizer(
                optimizer, c.get("opt", "adamw"), model.parameters()))
            step = opt.make_train_step(model, loss_fn)
            gaps = []

            def top_k(x, k):
                # the k-th largest |v| must be strictly above the next:
                # no tie decides which entries travel
                top = torch.topk(x, k + 1).values
                gaps.append(float(top[k - 1] - top[k]))
                return real_top_k(x, k)

            fault = (chip_smoke.comm_fault(c["fault"]) if "fault" in c
                     else contextlib.nullcontext())
            out = dict(kind=type(step).__name__, losses=[], spread=[])
            with fault, mock.patch.object(ce, "_top_k", top_k):
                for _ in range(STEPS):
                    out["losses"].append(float(step(*batch)))
                    if c["mode"] == "localsgd":
                        out["spread"].append(_spread(step.replicas()))
                    elif c["mode"] == "a_sync":
                        out["spread"].append(step.replica_divergence())
            out["tie_gaps"] = gaps
            out["fingerprint"] = float(sum(p.detach().double().sum()
                                           for p in model.parameters()))
            if c["mode"] in ("localsgd", "a_sync"):
                params = {k: v.numpy() for k, v in step.replicas().items()}
                out["syncs"] = getattr(step, "syncs",
                                       getattr(step, "merges", None))
            else:
                params = gather_state_dict(model)
            if c["mode"] == "comm_opt":
                out.update(stats=step.comm_stats(),
                           opt_elems=step.optimizer_state_elems_per_replica(),
                           gathered=step.gathered_state(),
                           n_local=step.n_local, n_pad=step.n_pad)
                if "fault" not in c:
                    # this rank's state_dict restores the trajectory
                    snap = _cloned(step.state_dict())
                    again = [float(step(*batch))]
                    step.load_state_dict(snap)
                    again.append(float(step(*batch)))
                    out["replayed"] = again
            _dump(os.path.join(out_dir, f"{name}.r{rank}.pkl"), out)
            if rank == 0:
                _dump(os.path.join(out_dir, f"{name}.pkl"),
                      dict(losses=out["losses"], params=params))
        dist.barrier()
    dist.destroy_process_group()



AMP_SCALE = 1024.0
AMP_LAYERS = 1


def amp_worker(out_dir, init_path, ids_path):
    """LLAMA_TINY at AMP_LAYERS layers (fp32, the JAX model's initial
    weights) at dp2 x tp2
    under ``strategy.amp`` (O1) with a ``GradScaler(AMP_SCALE)`` and SGD
    (lr 0.5): 3 steps, then a step whose loss is multiplied by inf on rank
    1 only. Each rank writes its losses, whether its own loss was
    non-finite, the step's ``found_inf``, whether its parameters and
    optimizer state stayed bit for bit, and the scale before and after;
    rank 0 also the gathered parameters after the 3 steps."""
    import dataclasses
    import math

    torch.set_num_threads(1)
    from paddle_tpu_torch import amp, optimizer
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import (gather_state_dict,
                                               load_numpy_state_dict)
    from paddle_tpu_torch.text.models.llama import (LLAMA_TINY,
                                                    LlamaForCausalLM)

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    ids = np.load(ids_path)
    with np.load(init_path) as z:
        init = {k: z[k] for k in z.files}
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=2, mp_degree=2)
    s.amp = True
    fleet.init(is_collective=True, strategy=s)
    model = fleet.distributed_model(LlamaForCausalLM(
        dataclasses.replace(LLAMA_TINY, dtype="float32",
                            num_hidden_layers=AMP_LAYERS), device="cpu"))
    load_numpy_state_dict(model, init)
    opt = fleet.distributed_optimizer(optimizer.SGD(
        learning_rate=0.5, parameters=model.parameters()))
    poison, local = [1.0], []

    def loss_fn(m, x, y):
        loss = m(x, labels=y) * poison[0]
        local.append(float(loss))
        return loss

    step = opt.make_train_step(
        model, loss_fn, scaler=amp.GradScaler(init_loss_scaling=AMP_SCALE))
    losses = [float(step(ids, ids)) for _ in range(3)]
    full = gather_state_dict(model)
    sd = step.state_dict()
    params = {k: v.clone() for k, v in sd["params"].items()}
    state = {k: {n: t.clone() for n, t in st.items()}
             for k, st in sd["opt"].items()}
    scale_before = float(sd["scaler"]["scale"])
    local.clear()
    poison[0] = math.inf if rank == 1 else 1.0
    step(ids, ids)
    sd = step.state_dict()
    unchanged = (all(torch.equal(v, params[k])
                     for k, v in sd["params"].items())
                 and all(torch.equal(t, state[k][n])
                         for k, st in sd["opt"].items()
                         for n, t in st.items()))
    _dump(os.path.join(out_dir, f"amp.r{rank}.pkl"), dict(
        rank=rank, losses=losses, params=full if rank == 0 else None,
        local_inf=not math.isfinite(local[0]),
        found_inf=bool(step.last_found_inf), unchanged=unchanged,
        scale_before=scale_before,
        scale_after=float(sd["scaler"]["scale"])))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# io: a dataset that DataLoader's spawned worker processes unpickle (this
# module imports no JAX, so a worker starts in torch's import time)
# ---------------------------------------------------------------------------

class IoRows:
    """A map-style dataset of (row, label) numpy pairs, or of dicts."""

    def __init__(self, n=13, as_dict=False):
        rng = np.random.default_rng(3)
        self.x = rng.standard_normal((n, 3)).astype(np.float32)
        self.y = np.arange(n, dtype=np.int64)
        self.as_dict = as_dict

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        if self.as_dict:
            return {"x": self.x[i], "y": int(self.y[i])}
        return self.x[i], self.y[i]


# ---------------------------------------------------------------------------
# comm-opt restore across dp degrees (test_torch_comm_opt_resilience.py)
# ---------------------------------------------------------------------------

#: the configurations of tests/test_comm_opt_resilience.py: Adam lr 1e-2
#: on the JAX package's MLP, int8 with qblock 64, with and without zero1
REMESH_CONFIGS = {"zero1_int8": dict(grad_compress="int8", zero1=True,
                                     qblock=64),
                  "int8": dict(grad_compress="int8", zero1=False,
                               qblock=64)}
REMESH_STEPS = 3


def remesh_mlp():
    """``Sequential(Linear(8, 32), Tanh, Linear(32, 1))`` on the CPU."""
    from paddle_tpu_torch import nn as pnn
    return torch.nn.Sequential(pnn.Linear(8, 32, device="cpu"), pnn.Tanh(),
                               pnn.Linear(32, 1, device="cpu"))


def _remesh_step(dp, cfg, init):
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import load_numpy_state_dict

    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(dp_degree=dp)
    s.comm_opt = True
    s.comm_opt_configs = dict(cfg)
    fleet.init(is_collective=True, strategy=s)
    if fleet.get_hybrid_communicate_group().mesh.coords is None:
        return None
    model = fleet.distributed_model(remesh_mlp())
    load_numpy_state_dict(model, init)
    opt = fleet.distributed_optimizer(optimizer.Adam(
        learning_rate=0.01, parameters=model.parameters()), strategy=s)
    return opt.make_train_step(model, mse)


def _flat_state(step):
    """The step's flat state in the JAX package's layout (numpy): the
    gathered residuals and zero1 moments, or this rank's replicated flat
    moments; its parameters and meta."""
    g = step.gathered_state()
    opt = g.get("opt") or {n: t.detach().cpu().numpy()
                           for n, t in step._opt_state.items()}
    meta = {k: np.asarray(int(v)) for k, v in step.state_dict()["meta"]
            .items()}
    params = {k: v.detach().cpu().numpy()
              for k, v in step.state_dict()["params"].items()}
    return dict(opt=opt, ef=g["ef"], params=params, buffers={}, meta=meta)


def remesh_worker(out_dir, inputs_path):
    """Four gloo ranks on the CPU, for each of ``REMESH_CONFIGS``:

    A. dp4 over all ranks from the JAX model's initial weights: 3 steps,
       a ``CheckpointManager`` save (each rank its file, rank 0 seals);
       the same-mesh round trip (``state_dict`` into a fresh step, 2 more
       steps, against the uninterrupted 2); JAX's dp2-stored arrays loaded
       at dp4; a tp change refused.
    B. dp2 on ranks 0 and 1: JAX's dp4-stored arrays loaded, and the
       port's dp4 checkpoint restored (every rank's file: a RankStates)
       through ``TrainState``; 2 steps on from it.

    Rank 0 writes ``<config>.pkl``."""
    torch.set_num_threads(1)
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ck
    from paddle_tpu_torch.resilience import TrainState

    dist.init_parallel_env(device="cpu", timeout=300)
    rank = dist.get_rank()
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    x, y = (torch.from_numpy(a) for a in tp_mlp_data())
    for name, cfg in REMESH_CONFIGS.items():
        init, jax_states = inputs["init"], inputs[name]
        out = {}
        # -- A: dp4 -------------------------------------------------------
        step = _remesh_step(4, cfg, init)
        out["losses4"] = [float(step(x, y)) for _ in range(REMESH_STEPS)]
        ck4 = os.path.join(out_dir, f"ck4_{name}")
        ck.CheckpointManager(ck4, device="cpu").save(
            REMESH_STEPS, TrainState(train_step=step).capture(),
            async_save=False)
        out["port4"] = _flat_state(step)
        snap = TrainState(train_step=step).capture()
        cont = [float(step(x, y)) for _ in range(2)]
        fresh = _remesh_step(4, cfg, init)
        TrainState(train_step=fresh).restore(snap)
        out["roundtrip"] = (cont, [float(fresh(x, y)) for _ in range(2)])
        fresh = _remesh_step(4, cfg, init)
        fresh.load_state_dict(jax_states["dp2"])
        out["jax2_at_dp4"] = _flat_state(fresh)
        bad = fresh.state_dict()
        bad["meta"] = dict(bad["meta"], tp=torch.tensor(2))
        try:
            fresh.load_state_dict(bad)
            out["tp_change"] = None
        except NotImplementedError as e:
            out["tp_change"] = str(e)
        # -- B: dp2 on ranks 0 and 1 --------------------------------------
        step2 = _remesh_step(2, cfg, init)
        if step2 is not None:
            step2.load_state_dict(jax_states["dp4"])
            jax4 = _flat_state(step2)
        dist.barrier()
        step2 = _remesh_step(2, cfg, init)
        if step2 is not None:
            # every rank's file, as a world of 4 reads them
            files = ck._shards(os.path.join(ck4, f"ckpt-{REMESH_STEPS}",
                                            "state"))
            snap = ck.RankStates(ck._convert(*ck._read_state(files[r]),
                                             None, "cpu")
                                 for r in sorted(files))
            TrainState(train_step=step2).restore(snap)
            port4 = _flat_state(step2)
            more = [float(step2(x, y)) for _ in range(2)]
            if rank == 0:
                out.update(jax4_at_dp2=jax4, port4_at_dp2=port4,
                           losses_after=more, n_files=len(snap))
        dist.barrier()
        if rank == 0:
            with open(os.path.join(out_dir, f"{name}.pkl"), "wb") as f:
                pickle.dump(out, f)
    dist.destroy_process_group()
