"""Pipeline layer descriptions. Counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_layers.py``
(``LayerDesc``, ``SharedLayerDesc``, ``PipelineLayer``), with the JAX
package's API.

These are eager containers: ``PipelineLayer`` builds the whole list,
records the uniform stage partition (``_stage_bounds``, ``get_stage_of``)
and runs it whole (``forward``) or one stage of it (``stage_forward``).
The pipelined train steps take models with ``pipeline_parts()``
(``text.models.llama_pipe.LlamaForCausalLMPipe``), whose stacked weights
each pp rank holds only its chunk of.
"""
from __future__ import annotations

import math
from typing import List, Optional

from torch import nn

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer built once under ``key`` and reused wherever the key
    appears again (the reference's tied embedding and head);
    ``forward_func(layer, x)`` applies it."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class PipelineLayer(nn.Module):
    """The layers of ``layers`` (``LayerDesc``s, ``SharedLayerDesc``s,
    modules or plain callables) in order, cut into ``num_stages`` uniform
    segments of ``ceil(n / num_stages)`` items."""

    def __init__(self, layers: List, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method="uniform",
                 recompute_interval=0, recompute_ctx=None,
                 num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._shared = {}
        built = []
        for desc in layers:
            if isinstance(desc, SharedLayerDesc):
                if desc.layer_name in self._shared:
                    layer = self._shared[desc.layer_name]
                else:
                    layer = desc.build_layer()
                    self._shared[desc.layer_name] = layer
                built.append((layer, desc.forward_func))
            elif isinstance(desc, LayerDesc):
                built.append((desc.build_layer(), None))
            elif isinstance(desc, nn.Module):
                built.append((desc, None))
            elif callable(desc):
                built.append((desc, "fn"))
            else:
                raise TypeError(f"bad pipeline item {desc!r}")
        self.run_order = built
        # each module once: a shared layer's parameters are listed once,
        # under its first place, as in the JAX package's state_dict
        mods = []
        for m, tag in built:
            if tag != "fn" and not any(m is k for k in mods):
                mods.append(m)
        self.funcs = nn.ModuleList(mods)
        # uniform stage segmentation (reference: segment by layer count)
        n = len(built)
        per = math.ceil(n / self._num_stages)
        self._stage_bounds = [(i * per, min((i + 1) * per, n))
                              for i in range(self._num_stages)]

    def get_stage_of(self, idx: int) -> int:
        for s, (lo, hi) in enumerate(self._stage_bounds):
            if lo <= idx < hi:
                return s
        return self._num_stages - 1

    @staticmethod
    def _run(items, x):
        for layer, tag in items:
            if tag is not None and tag != "fn":
                x = tag(layer, x)
            else:
                x = layer(x)
        return x

    def forward(self, x):
        return self._run(self.run_order, x)

    def stage_forward(self, stage: int, x):
        lo, hi = self._stage_bounds[stage]
        return self._run(self.run_order[lo:hi], x)
