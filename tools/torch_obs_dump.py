#!/usr/bin/env python
"""torch_obs_dump: scrape the PyTorch port's observability surface (the
port's counterpart of tools/obs_dump.py; imports no JAX).

Dumps the process-wide metrics registry (every instrument plus the
serving, fleet, resilience, serving-resilience and comm collectors) as a
JSON snapshot or Prometheus text exposition, and the span-tracer ring as
Chrome trace-event JSON (load in perfetto / chrome://tracing).

    python tools/torch_obs_dump.py --json       # registry JSON
    python tools/torch_obs_dump.py --prom       # Prometheus text
    python tools/torch_obs_dump.py --demo --json
    python tools/torch_obs_dump.py --demo --trace trace.json

A bare invocation scrapes THIS process (a fresh CLI run is mostly empty:
the tool is meant to be imported or run with ``--demo``); ``--demo``
runs a tiny traced eager train loop first (on the card unless
``--device cpu`` asks for the CPU) so the span ring and the train
families have data. Exit code 0 iff the scrape is well-formed (JSON
serializable, the Prometheus text parses, the Chrome trace loads).
"""
import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_PROM_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*.*"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})? -?[0-9.eE+\-]+(?:e[+-]?\d+)?"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{[^}]*\})? (?:nan|inf|-inf))$")


def prom_parses(text):
    """Validate Prometheus 0.0.4 text exposition line by line; returns
    the list of malformed lines (empty == parses)."""
    bad = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if not _PROM_LINE.match(line):
            bad.append(line)
    return bad


def run_demo(device=None):
    """Populate the span ring: a traced 6-step eager MLP train loop on
    ``device`` (the framework's default, the card, when None); the
    default device is left as it was."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.framework import device as dmod

    before = dmod.get_device()
    paddle.set_device(device or before)
    try:
        return _demo_loop(paddle, obs, np)
    finally:
        dmod._current_device = before


def _demo_loop(paddle, obs, np):
    obs.enable_tracing()
    paddle.seed(0)
    net = paddle.nn.Sequential(paddle.nn.Linear(16, 16), paddle.nn.ReLU(),
                               paddle.nn.Linear(16, 4))
    opt = paddle.optimizer.Adam(learning_rate=1e-3,
                                parameters=net.parameters())
    rng = np.random.default_rng(0)
    x = paddle.to_tensor(rng.standard_normal((8, 16)).astype(np.float32))
    y = paddle.to_tensor(rng.integers(0, 4, (8,)).astype(np.int64))
    with obs.span("obs_dump.demo", cat="demo"):
        for _ in range(6):
            loss = paddle.nn.functional.cross_entropy(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
    return float(loss.detach().cpu())


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="torch_obs_dump",
        description="dump the observability registry / span ring")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON object (registry snapshot + "
                         "validation verdict)")
    ap.add_argument("--prom", action="store_true",
                    help="emit the Prometheus text exposition")
    ap.add_argument("--trace", metavar="FILE",
                    help="write the span ring as Chrome trace JSON")
    ap.add_argument("--demo", action="store_true",
                    help="run a tiny traced train loop first so the span "
                         "ring has data")
    ap.add_argument("--device", default=None,
                    help="the demo's device (default: the card; cpu "
                         "asks for the CPU)")
    args = ap.parse_args(argv)

    from paddle_tpu_torch import observability as obs

    if args.demo:
        run_demo(args.device)

    snap = obs.snapshot()                      # raises if not JSON-able
    prom = obs.to_prometheus()
    bad = prom_parses(prom)
    trace_events = None
    if args.trace:
        doc = obs.to_chrome_trace()
        with open(args.trace, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        with open(args.trace, encoding="utf-8") as fh:
            trace_events = len(json.load(fh)["traceEvents"])
    ok = not bad

    if args.prom:
        sys.stdout.write(prom)
    if args.json or not args.prom:
        print(json.dumps({
            "bench": "torch_obs_dump", "demo": bool(args.demo),
            "families": len(snap), "metrics": snap,
            "spans_recorded": len(obs.spans()),
            "trace_file": args.trace, "trace_events": trace_events,
            "prom_bytes": len(prom), "prom_malformed_lines": bad,
            "ok": ok,
        }, default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
