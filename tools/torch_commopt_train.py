"""Comm-efficient data-parallel Llama training across GPUs over NCCL.

    python tools/torch_commopt_train.py [--dp 4] [--steps 3]

``bench.py:bench_llama``'s 0.5B Llama (``chip_smoke.COMM_CELL``: vocab
32000, hidden 2048, 8 layers, 16 heads, FFN 5504, bf16, the fused head)
on its one repeated 4 x 2048 batch, AdamW(lr=1e-4, wd=0.01). First world
1 on cuda:0 (``chip_smoke.comm_world1``: phase 8's trainer, whose weights
are saved for the ranks, and the comm_opt step), then ``--dp`` NCCL
ranks, one GPU each, 1 x 2048 a rank at dp 4, from the same weights,
under each arm
(``chip_smoke._comm_worker``): the plain dp ``TrainStep``;
``comm_opt`` exact, zero1, bf16 and int8; ``fp16_allreduce`` bfloat16;
``localsgd`` k 4; ``a_sync`` (Geo) k 8 (8 steps, so that it merges
once); ``dgc`` 0.99 with Momentum(0.9, lr=1e-4). Each arm runs a warm-up
and ``--steps`` steps (LocalSGD 4, Geo 8).

Checks (``chip_smoke.check_comm``): every loss finite and equal on every
rank; the plain dp step within ``chip_smoke.PAIR_REL_TOL`` of world 1,
the exact and zero1 arms of the comm_opt step at world 1 (its flat
update keeps no fp32 master), and zero1 bitwise the replicated flat arm;
the compressed arms within 5e-2 of the exact arm; error feedback
conserved on the int8 arm (``chip_smoke.EFProbe``); rows 1-3 once per
layer and row 5 once per rank and step, all on the tensor
cores; no call staged through the host.

Needs ``--dp`` GPUs. Prints one JSON line: per arm the losses, step
times (median of the timed steps), tokens/s, peak memory per rank, the
wire bytes a step from the byte plan, the collective time a step from
CUDA events around each collective (NCCL's kernels spin while a rank
waits, so the profiler's busy sum would mislead) and the host-staged
calls; world 1's; with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

#: the arms, as ``chip_smoke.COMM_ARMS`` (field, configs, optimizer,
#: planted fault[, steps]); None: the plain dp TrainStep
ARMS = {
    "trainstep": (None, {}, "adamw", None),
    "comm_opt_exact": cs.COMM_ARMS["comm_opt_exact"],
    "comm_opt_zero1": cs.COMM_ARMS["comm_opt_zero1"],
    "comm_opt_bf16": cs.COMM_ARMS["comm_opt_bf16"],
    "comm_opt_int8": cs.COMM_ARMS["comm_opt_int8"],
    "fp16_allreduce_bf16": ("fp16_allreduce", {"dtype": "bfloat16"},
                            "adamw", None),
    "localsgd_k4": ("localsgd", {"k_steps": 4}, "adamw", None, 4),
    "a_sync_k8": ("a_sync", {"k_steps": 8}, "adamw", None, 8),
    "dgc": cs.COMM_ARMS["dgc"],
}


def _modules():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)
    return pt, optimizer, fleet, fa, fc, rm, LlamaConfig, LlamaForCausalLM


def commopt_train(dp, steps, cfg=None, batch=cs.COMM_BATCH,
                  workdir="build/commopt_train", backend=None,
                  device="cuda"):
    """World 1, then ``dp`` ranks under every arm; returns the report
    (raises on a check that fails)."""
    from paddle_tpu_torch import distributed as dist
    (pt, optimizer, fleet, fa, fc, rm, LlamaConfig,
     LlamaForCausalLM) = _modules()
    cfg = cfg or LlamaConfig(**cs.COMM_CELL)
    n = steps + 1
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        world1 = cs.comm_world1(fa, fc, rm, LlamaForCausalLM, cfg, fleet,
                                optimizer, pt.seed, batch, n, workdir,
                                device)
        flat1 = cs.comm_world1(fa, fc, rm, LlamaForCausalLM, cfg, fleet,
                               optimizer, pt.seed, batch, n, workdir,
                               device, field="comm_opt")
        dist.spawn(cs._comm_worker, args=(workdir, cfg, batch, n, ARMS,
                                          backend, None, True),
                   nprocs=dp, timeout=2400)
        ranks = []
        for r in range(dp):
            with open(os.path.join(workdir, f"comm.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = cs.want_train_launches(cfg.num_hidden_layers)
    arms = cs.check_comm(ranks, world1, flat1, want, tag=f"dp{dp}",
                         staged=False)
    B, L = batch
    w1 = float(np.median(world1["step_secs"][1:]))
    for a in arms.values():
        med = [float(np.median(t[1:])) for t in a["step_secs"]]
        a["step_ms_per_rank"] = [m * 1e3 for m in med]
        a["collective_ms_per_rank"] = [float(np.median(c[1:]))
                                       for c in a["collective_ms"]]
        a["tokens_per_s"] = B * L / max(med)
    return dict(
        smi=cs.smi_line(), gpus=torch.cuda.device_count(), dp=dp,
        steps=steps, backend=ranks[0]["backend"], batch=[B, L],
        layers=cfg.num_hidden_layers, probe=ranks[0]["probe"],
        world1=dict(losses=world1["losses"], step_ms=w1 * 1e3,
                    tokens_per_s=B * L / w1, peak_gib=world1["peak_gib"],
                    n_params=world1["n_params"]),
        world1_comm_opt=dict(
            losses=flat1["losses"],
            step_ms=float(np.median(flat1["step_secs"][1:])) * 1e3),
        launches_per_rank_step=ranks[0]["arms"]["comm_opt_int8"][
            "launches"][-1],
        arms=arms)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    if torch.cuda.device_count() < a.dp:
        print(f"needs {a.dp} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    report = commopt_train(a.dp, a.steps)
    report["wall_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
