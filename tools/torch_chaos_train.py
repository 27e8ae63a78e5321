#!/usr/bin/env python
"""torch_chaos_train: drive the port's training supervisor through an
injected fault and emit a JSON verdict ledger. Counterpart of
``tools/chaos_train.py``: the same flags and the same verdict fields.

A tiny MLP regression task trains under ``paddle_tpu_torch.resilience
.Supervisor`` with a ``ChaosMonkey`` firing the chosen fault at the chosen
step; the verdict says whether training recovered and finished with a
healthy loss. It runs on the card unless ``--device cpu`` is given.

    python tools/torch_chaos_train.py --fault nan --step 3
    python tools/torch_chaos_train.py --fault stall --json --device cpu
    python tools/torch_chaos_train.py --fault kill --workdir build/chaos

Faults: nan | stall | error | corrupt run in-process; kill launches a
subprocess that SIGKILLs itself mid-run, then a second subprocess that
must resume from the durable checkpoint and finish. Exit code 0 iff the
run recovered and converged. Each fired fault's trace id is in the
verdict (``trace_id``); with tracing on (``PADDLE_TPU_TRACE=1``) it
also names the fault's ``chaos.<fault>`` instant and the supervisor's
``train.step`` spans.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _train(fault, step, seed, steps, workdir, stall_s, device):
    """One supervised run; returns a result dict."""
    import numpy as np
    import torch

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.resilience import ChaosMonkey, Supervisor, TrainState

    dev = resolve_device(device)
    pt.seed(seed)
    net = torch.nn.Sequential(nn.Linear(8, 16, device=dev), nn.ReLU(),
                              nn.Linear(16, 1, device=dev))
    opt = optimizer.Adam(learning_rate=0.05, parameters=net.parameters())
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(32, 8)).astype(np.float32)
    w_true = rng.normal(size=(8, 1)).astype(np.float32)
    x = torch.from_numpy(xs).to(dev)
    y = torch.from_numpy((xs @ w_true).astype(np.float32)).to(dev)

    def train_step(xb, yb):
        loss = ((net(xb) - yb) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    mgr = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=2,
                            device=dev)
    chaos = ChaosMonkey(seed=seed, at=({int(step): fault}
                                       if fault != "none" else {}),
                        stall_s=stall_s, manager=mgr)
    sup = Supervisor(chaos.wrap(train_step),
                     TrainState(model=net, optimizer=opt), manager=mgr,
                     save_interval=2, nan_patience=3, max_retries=2,
                     retry_backoff_s=0.01)
    start = sup.resume()
    losses = []
    for _ in range(start, int(steps)):
        out = sup.step(x, y)
        losses.append(None if out is None else float(out))
    sup.close()
    stats = sup.stats()
    finite = [l for l in losses if l is not None]
    final = finite[-1] if finite else None
    # recovery verdict: the run finished every step AND the loss kept
    # descending through the fault (not merely survived it)
    improved = (len(finite) >= 2 and final < finite[0]
                and all(np.isfinite(finite)))
    return {"steps": stats["steps_completed"], "resumed_from": start,
            "skipped": stats["skipped"], "retries": stats["retries"],
            "rollbacks": stats["rollbacks"],
            "anomalies": stats["anomalies"], "fired": chaos.fired,
            "trace_id": chaos.last_trace_id,
            "first_loss": finite[0] if finite else None,
            "final_loss": final, "ledger": sup.ledger.counts(),
            "ok": bool(improved
                       and stats["steps_completed"] >= int(steps))}


def _kill_verdict(args):
    """Fault 'kill': a victim child dies by SIGKILL mid-run; a resume
    child must finish the job from the durable checkpoint."""
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_train_")
    base = [sys.executable, os.path.abspath(__file__), "--seed",
            str(args.seed), "--steps", str(args.steps), "--workdir",
            workdir, "--device", args.device, "--json"]
    victim = subprocess.run(
        base + ["--fault", "kill", "--step", str(args.step), "--_victim"],
        capture_output=True, text=True, timeout=300)
    resumed = subprocess.run(
        base + ["--fault", "none"],
        capture_output=True, text=True, timeout=300)
    try:
        rec = json.loads(resumed.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        rec = {"ok": False, "error": resumed.stderr[-2000:]}
    rec.update({"fault": "kill", "injected_step": args.step,
                "victim_sigkilled": victim.returncode == -9})
    rec["ok"] = bool(rec.get("ok")) and victim.returncode == -9 \
        and rec.get("resumed_from", 0) > 0
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_chaos_train",
        description="deterministic chaos injection vs the port's "
        "resilience supervisor (JSON verdict ledger)")
    ap.add_argument("--fault", default="nan",
                    choices=("nan", "stall", "error", "corrupt", "kill",
                             "none"))
    ap.add_argument("--step", type=int, default=3,
                    help="0-based step at which the fault fires")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--stall-s", type=float, default=0.05)
    ap.add_argument("--workdir", default=None,
                    help="checkpoint/ledger dir (default: fresh tempdir)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--json", action="store_true", help="emit a JSON line")
    ap.add_argument("--_victim", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.fault == "kill" and not args._victim:
        record = dict(_kill_verdict(args), bench="chaos_train",
                      seed=args.seed)
    else:
        workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_train_")
        from paddle_tpu_torch.resilience import SupervisorAborted

        try:
            result = _train(args.fault, args.step, args.seed, args.steps,
                            workdir, args.stall_s, args.device)
        except SupervisorAborted as e:
            result = {"aborted": str(e), "ok": False}
        record = {"bench": "chaos_train", "fault": args.fault,
                  "injected_step": args.step, "seed": args.seed,
                  "total_steps": args.steps, **result}

    if args.json:
        print(json.dumps(record, default=str))
    else:
        for k in ("fault", "injected_step", "resumed_from", "steps",
                  "skipped", "retries", "rollbacks", "final_loss",
                  "aborted", "victim_sigkilled"):
            if k in record:
                print(f"{k:16s} {record[k]}")
        print("OK (recovered)" if record.get("ok")
              else "FAIL: did not recover")
    return 0 if record.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())
