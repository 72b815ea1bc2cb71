"""Bilinear point sampling and resize on NHWC tensors.

``point_sample`` is the forward of ``psalm_tpu/ops/sampling.py::point_sample``
(and of ``point_sample_mmgrad``, which differs only in its gradient):
detectron2's ``point_sample`` around ``grid_sample`` with zero padding, on
(x, y) points in [0, 1]. ``resize_bilinear`` has the semantics of
``jax.image.resize(..., method="bilinear", antialias=False)`` that
``psalm_tpu/ops/sampling.py::resize_bilinear`` uses.

Each resized axis is one weight matrix: a triangle kernel of width 1 at the
half-pixel sample positions (i + 0.5) * in / out - 0.5, each output's weights
normalised to sum to 1, and zero for a sample outside [-0.5, in - 0.5]. For
upsampling and for downsampling without antialiasing that is
``F.interpolate(mode="bilinear", align_corners=False)``.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS_F32 = float(np.finfo(np.float32).eps)


def point_sample(feat: torch.Tensor, coords: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """feat [B, H, W, C]; coords [B, N, 2] (x, y) in [0, 1] -> [B, N, C].

    Pixel coordinates are x * (W - 1) with ``align_corners``, else
    x * W - 0.5; the four corners' weights are taken in feat's dtype, as JAX
    takes them, and a corner off the map contributes zero."""
    B, H, W, C = feat.shape
    x, y = coords[..., 0], coords[..., 1]
    if align_corners:
        px, py = x * (W - 1), y * (H - 1)
    else:
        px, py = x * W - 0.5, y * H - 0.5
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = (px - x0).to(feat.dtype), (py - y0).to(feat.dtype)
    x0i, y0i = x0.long(), y0.long()
    flat = feat.reshape(B, H * W, C)
    out = torch.zeros(B, coords.shape[1], C, dtype=feat.dtype, device=feat.device)
    for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                        (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yi, xi = y0i + dy, x0i + dx
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        g = torch.gather(flat, 1, idx[..., None].expand(-1, -1, C))
        out = out + g * (wgt * valid.to(feat.dtype))[..., None]
    return out


def resize_weights(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in_size, out_size] f32 weights, computed in f32 as JAX computes them
    (``jax._src.image.scale.compute_weight_mat``)."""
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :]
            - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = torch.clamp(1.0 - dist, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS_F32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_bilinear(x: torch.Tensor, out_hw) -> torch.Tensor:
    """[..., H, W, C] -> [..., out_h, out_w, C]."""
    H, W = x.shape[-3], x.shape[-2]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if oh != H:
        wh = resize_weights(H, oh, x.device).to(x.dtype)
        x = torch.einsum("...hwc,ho->...owc", x, wh)
    if ow != W:
        ww = resize_weights(W, ow, x.device).to(x.dtype)
        x = torch.einsum("...hwc,wo->...hoc", x, ww)
    return x
