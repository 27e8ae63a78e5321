"""Vision functionals. Counterpart of
``paddle_tpu/nn/functional/vision.py``: ``pixel_shuffle``,
``pixel_unshuffle``, ``channel_shuffle``, ``affine_grid`` and
``grid_sample``, with the JAX package's reshapes and sampling.

``affine_grid`` and ``grid_sample`` default to ``align_corners=True``,
as the JAX package does (torch's default is False). ``grid_sample``
gathers the four neighbours of each sample point: "zeros" zeroes those
outside the image, any other ``padding_mode`` clamps them to the border;
"nearest" rounds half to even.
"""
from __future__ import annotations

import torch

__all__ = ["affine_grid", "channel_shuffle", "grid_sample", "pixel_shuffle",
           "pixel_unshuffle"]


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    a = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        a = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return a.reshape(n, c * r * r, h // r, w // r)
    n, h, w, c = x.shape
    a = x.reshape(n, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return a.reshape(n, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        n, c, h, w = x.shape
        return x.reshape(n, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(n, c, h, w)
    n, h, w, c = x.shape
    return x.reshape(n, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(n, h, w, c)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The ``[N, H, W, 2]`` sampling grid (x, y) of ``theta [N, 2, 3]``
    over an ``out_shape = [N, C, H, W]`` output."""
    shp = [int(s) for s in (out_shape.tolist()
                            if isinstance(out_shape, torch.Tensor)
                            else out_shape)]
    _, _, h, w = shp
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        ys, xs = torch.linspace(-1, 1, h, **kw), torch.linspace(-1, 1, w,
                                                                **kw)
    else:
        ys = (torch.arange(h, **kw) + 0.5) / h * 2 - 1
        xs = (torch.arange(w, **kw) + 0.5) / w * 2 - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("hwk,nik->nhwi", base, theta)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x [N, C, H, W]`` at ``grid [N, gh, gw, 2]`` (x, y in
    [-1, 1]): ``[N, C, gh, gw]``."""
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    b = torch.arange(n, device=x.device)[:, None, None]
    if mode == "nearest":
        yi = torch.clamp(torch.round(fy).long(), 0, h - 1)
        xi = torch.clamp(torch.round(fx).long(), 0, w - 1)
        return torch.movedim(x[b, :, yi, xi], -1, 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = fx - x0, fy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1

    def gather(yy, xx):
        v = x[b, :, torch.clamp(yy, 0, h - 1).long(),
              torch.clamp(xx, 0, w - 1).long()]         # [n, gh, gw, c]
        if padding_mode == "zeros":
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            v = v * inside[..., None]
        return v

    out = (gather(y0, x0) * (wy0 * wx0)[..., None]
           + gather(y0, x1) * (wy0 * wx1)[..., None]
           + gather(y1, x0) * (wy1 * wx0)[..., None]
           + gather(y1, x1) * (wy1 * wx1)[..., None])
    return torch.movedim(out, -1, 1)
