"""``paddle.summary``. Counterpart of ``paddle_tpu/hapi/model_summary.py``:
the same table (each leaf layer's own parameters) and totals. The
``input_size`` and ``dtypes`` arguments are accepted and, as in the JAX
package, not used: the counts come from the parameters alone."""
from __future__ import annotations

from torch import nn

__all__ = ["summary"]


def summary(net: nn.Module, input_size=None, dtypes=None, input=None):
    rows = []
    for name, layer in net.named_modules():
        if not name or layer._modules:          # the net itself, non-leaves
            continue
        n_params = sum(p.numel() for p in layer._parameters.values()
                       if p is not None)
        rows.append((name, type(layer).__name__, n_params))
    total_params = trainable_params = 0
    for p in net.parameters():
        total_params += p.numel()
        if p.requires_grad:
            trainable_params += p.numel()
    width = max([len(r[0]) for r in rows] + [20]) + 2
    lines = ["-" * (width + 30),
             f"{'Layer (type)':<{width}}{'Params':>12}",
             "=" * (width + 30)]
    for name, tname, n in rows:
        lines.append(f"{name + ' (' + tname + ')':<{width}}{n:>12,}")
    lines.append("=" * (width + 30))
    lines.append(f"Total params: {total_params:,}")
    lines.append(f"Trainable params: {trainable_params:,}")
    lines.append(f"Non-trainable params: {total_params - trainable_params:,}")
    lines.append("-" * (width + 30))
    print("\n".join(lines))
    return {"total_params": total_params, "trainable_params": trainable_params}
