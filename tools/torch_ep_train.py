"""Expert-parallel ERNIE-MoE training across GPUs over NCCL.

    python tools/torch_ep_train.py [--tp 4] [--steps 3]

``bench.py:bench_ernie_moe``'s configuration (``chip_smoke.ERNIE_MOE``:
vocab 32000, hidden 1024, 6 layers, 16 heads, FFN 4096, 8 experts top-2
every second layer, dropout 0.1; one repeated 8 x 1024 batch; bf16;
sparse dispatch with the ragged expert kernel; AdamW(lr=1e-4)) under
``mp_degree=--tp``: one NCCL process per GPU (cuda:rank), each holding
8/tp experts of every MoE layer and the rest of the model whole, all on
the same tokens. Two runs, each a warm-up and ``--steps`` steps from the
same weights and seeds:

1. world 1 on cuda:0 (``chip_smoke.ep_world1``; its weights are saved
   for the ranks);
2. ``--tp`` ranks (``chip_smoke._ep_worker``): every rank's gradients of
   ``chip_smoke.EP_PROBED`` from one forward and backward within 1e-2 of
   world 1's, each planted fault of ``chip_smoke.EP_FAULTS`` outside it;
   its losses finite, the last timed below the first, within
   ``chip_smoke.PAIR_REL_TOL`` of world 1's; per step 12 ragged launches
   on ``[8/tp, 2560, d]`` expert inputs and rows 1-3 6 each, all on the
   tensor cores; no call staged through the host; then one step under
   ``torch.profiler`` on every rank.

Needs ``--tp`` GPUs. Prints one JSON line: world 1's and every rank's
losses, step times (median of the timed steps), tokens/s, peak memory,
launches, the gradient checks and rank 0's profile (device busy, idle
share, top kernels), with the card's name and power limit.
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


def _modules():
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                              ErnieMoEForPretraining)
    return (pt, optimizer, fleet, fa, fc, rm, ErnieMoEConfig,
            ErnieMoEForPretraining)


def ep_train(tp, steps, cfg=None, batch=cs.ERNIE_BATCH,
             workdir="build/ep_train", backend=None, device="cuda"):
    """World 1, then ``tp`` ranks; returns the report (raises on a check
    that fails)."""
    from paddle_tpu_torch import distributed as dist
    (pt, optimizer, fleet, fa, fc, rm, ErnieMoEConfig,
     ErnieMoEForPretraining) = _modules()
    cfg = cfg or ErnieMoEConfig(**cs.ERNIE_MOE)
    n = steps + 1
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        world1 = cs.ep_world1(fa, fc, rm, cfg, batch, n,
                              ErnieMoEForPretraining, fleet, optimizer,
                              pt.seed, workdir, device=device)
        dist.spawn(cs._ep_worker, args=(workdir, cfg, batch, n, tp, backend,
                                        None, True),
                   nprocs=tp, timeout=1800)
        ranks, grads = [], []
        for r in range(tp):
            with open(os.path.join(workdir, f"ep.r{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(workdir, f"ep_grads.r{r}.npz")) as z:
                grads.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    n_moe = cfg.num_hidden_layers // cfg.moe_every
    want = cs.want_attention_launches(cfg.num_hidden_layers,
                                      ragged=4 * n_moe)
    res = cs.check_ep(f"mp{tp}", ranks, grads, world1, want, tp)
    for r, g in enumerate(ranks):
        losses = g["losses"]
        if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
            raise AssertionError(f"rank {r}: losses {losses} are not finite "
                                 "and falling")
    B, L = batch
    med = [float(np.median(g["step_secs"][1:])) for g in ranks]
    w1 = float(np.median(world1["step_secs"][1:]))
    return dict(
        smi=cs.smi_line(), gpus=torch.cuda.device_count(), tp=tp,
        steps=steps, backend=ranks[0]["backend"], batch=[B, L],
        world1=dict(losses=world1["losses"], step_ms=w1 * 1e3,
                    tokens_per_s=B * L / w1),
        losses=ranks[0]["losses"], step_ms_per_rank=[m * 1e3 for m in med],
        tokens_per_s=B * L / max(med),
        peak_gib_per_rank=[g["peak_gib"] for g in ranks],
        launches_per_rank_step=ranks[0]["launches"][-1],
        ragged_shapes=ranks[0]["ragged_shapes"],
        host_staged=[g["host_staged"] for g in ranks],
        profile_rank0=ranks[0]["profile"], **res)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args()
    if torch.cuda.device_count() < a.tp:
        print(f"needs {a.tp} CUDA devices, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    report = ep_train(a.tp, a.steps)
    report["wall_s"] = time.perf_counter() - t0
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
