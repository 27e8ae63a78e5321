"""Vision Transformer. Counterpart of ``paddle_tpu/vision/models/vit.py``
(``PatchEmbed``, ``VisionTransformer``, ``vit_s_16`` / ``vit_b_16`` /
``vit_l_16``).

The same parameter names and layouts as the JAX package
(``patch_embed.proj`` a ``Conv2D`` with kernel and stride the patch
size, ``cls_token [1, 1, E]`` and ``pos_embed [1, N + 1, E]`` drawn from
a truncated normal of std 0.02, the pre-LN ``encoder.layers.<i>`` with
erf GELU, ``encoder.norm``, ``head``), so a JAX model's weights carry
across with ``framework.io.load_numpy_state_dict``. The classifier reads
the class token's output. At 224 with patch 16 the sequence is 197
tokens, which the flash kernels do not take (``L % 128 != 0``): attention
runs the plain composite, as in JAX. Built in float32 on ``device``
(default: the framework's, ``cuda``); ``model.to(torch.bfloat16)`` casts
it, as ``bench_vit`` casts the JAX model.
"""
from __future__ import annotations

import torch
from torch import nn

from ...framework.device import resolve_device
from ...nn import (Conv2D, Dropout, LayerNorm, Linear, TransformerEncoder,
                   TransformerEncoderLayer)
from ...nn.initializer import TruncatedNormal
from ...nn.param_attr import _param

__all__ = ["PatchEmbed", "VisionTransformer", "vit_s_16", "vit_b_16",
           "vit_l_16"]


class PatchEmbed(nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 embed_dim=768, *, device=None):
        super().__init__()
        self.num_patches = (img_size // patch_size) ** 2
        self.proj = Conv2D(in_chans, embed_dim, patch_size,
                           stride=patch_size, device=device)

    def forward(self, x):
        x = self.proj(x)                        # B, E, H/P, W/P
        return x.flatten(2).transpose(1, 2)     # B, N, E


class VisionTransformer(nn.Module):
    def __init__(self, img_size=224, patch_size=16, in_chans=3,
                 num_classes=1000, embed_dim=768, depth=12, num_heads=12,
                 mlp_ratio=4.0, dropout=0.0, attn_dropout=0.0, *,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        kw = dict(device=self.device)
        self.patch_embed = PatchEmbed(img_size, patch_size, in_chans,
                                      embed_dim, **kw)
        n = self.patch_embed.num_patches
        self.cls_token = _param((1, 1, embed_dim), TruncatedNormal(std=0.02),
                                self.device, "float32")
        self.pos_embed = _param((1, n + 1, embed_dim),
                                TruncatedNormal(std=0.02), self.device,
                                "float32")
        self.pos_drop = Dropout(dropout)
        enc_layer = TransformerEncoderLayer(
            embed_dim, num_heads, int(embed_dim * mlp_ratio), dropout,
            activation="gelu", attn_dropout=attn_dropout,
            normalize_before=True, **kw)
        self.encoder = TransformerEncoder(enc_layer, depth,
                                          norm=LayerNorm(embed_dim, **kw))
        self.head = (Linear(embed_dim, num_classes, **kw)
                     if num_classes > 0 else None)

    def forward(self, x):
        """Images ``[B, C, H, W]`` -> logits ``[B, num_classes]`` (or the
        class token's features without a head)."""
        x = self.patch_embed(torch.as_tensor(x, device=self.device))
        cls = self.cls_token.expand(x.shape[0], 1, -1)
        x = self.pos_drop(torch.cat([cls, x], dim=1) + self.pos_embed)
        cls_out = self.encoder(x)[:, 0]
        return self.head(cls_out) if self.head is not None else cls_out


def vit_s_16(**kwargs):
    return VisionTransformer(embed_dim=384, depth=12, num_heads=6, **kwargs)


def vit_b_16(**kwargs):
    return VisionTransformer(embed_dim=768, depth=12, num_heads=12, **kwargs)


def vit_l_16(**kwargs):
    return VisionTransformer(embed_dim=1024, depth=24, num_heads=16, **kwargs)
