"""MSDeformAttn-FPN pixel decoder, NHWC.

Counterpart of ``psalm_tpu/models/pixel_decoder.py``: a deformable-DETR
encoder over res3/res4/res5 projected to ``conv_dim`` (static reference
points at each query's own pixel centre, sine position embeddings plus a
level embedding), then one FPN step fusing up to res2 and a 1x1 conv to the
mask features. LayerNorm and GroupNorm run in f32.

The sampler is kernel K1 (``psalm_tpu_torch/ops/msdeform.py``):
``attention_mode="deformable"`` (the default) runs it exact;
``"window"`` and ``"window_pallas3"`` run it with ``radius=window_radius``,
the JAX window modes' clamp. ``"dense"`` replaces the sampler with
``DenseSelfAttention``, full non-causal attention over all S encoder tokens
through kernel K5 (``psalm_tpu_torch/ops/flash_attention.py``). Per-point
radii are not ported.

With ``remat`` (``nn.remat`` per encoder layer in JAX), a forward that
records gradients keeps only each encoder layer's input and recomputes the
layer in the backward (``torch.utils.checkpoint``, non-reentrant), so K1 (or
K5) runs once more per layer in the backward.

Parameter names are the released checkpoint's (``pixel_decoder.*``).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from psalm_tpu_torch.config import PixelDecoderConfig
from psalm_tpu_torch.models.layers import (Conv2d, Dense, GroupNorm, LayerNorm,
                                           position_embedding_sine)
from psalm_tpu_torch.ops import msdeform
from psalm_tpu_torch.ops.flash_attention import flash_attention
from psalm_tpu_torch.ops.sampling import resize_bilinear

_CLAMPED_MODES = ("window", "window_pallas3")


def reference_points(spatial_shapes: Sequence[Tuple[int, int]]) -> np.ndarray:
    """[S, L, 2] f32 (x, y) in [0, 1]: each query's pixel centre, the same
    for every level (all-valid masks)."""
    pts = []
    for (H, W) in spatial_shapes:
        ys = (np.arange(H, dtype=np.float32) + 0.5) / H
        xs = (np.arange(W, dtype=np.float32) + 0.5) / W
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        pts.append(np.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1))
    ref = np.concatenate(pts, axis=0)
    L = len(spatial_shapes)
    return np.broadcast_to(ref[:, None, :], (ref.shape[0], L, 2)).copy()


def offset_bias_init(n_heads: int, n_levels: int, n_points: int) -> np.ndarray:
    """The deformable-DETR init of the ``sampling_offsets`` bias: a unit
    direction per head, scaled by point index + 1."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid.reshape(n_heads, 1, 1, 2), (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1)


class MSDeformAttnLayer(nn.Module):
    """Deformable self-attention (keys ``sampling_offsets``,
    ``attention_weights``, ``value_proj``, ``output_proj``)."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, radius=None, dtype=torch.float32, device=None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.radius = radius
        self.dtype = dtype
        self.sampling_offsets = Dense(d_model, n_heads * n_levels * n_points * 2,
                                      dtype=dtype, device=device)
        self.attention_weights = Dense(d_model, n_heads * n_levels * n_points,
                                       dtype=dtype, device=device)
        self.value_proj = Dense(d_model, d_model, dtype=dtype, device=device)
        self.output_proj = Dense(d_model, d_model, dtype=dtype, device=device)

    def forward(self, query, src, ref_points, shapes, ref_pixels=None):
        """query/src [B, S, D]; ref_points [S, L, 2] f32 tensor in [0, 1];
        ref_pixels [S, L, 2] f32 target-level pixel coords (clamped modes)."""
        B, S, D = src.shape
        M, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(src).reshape(B, S, M, D // M).contiguous()
        offsets = self.sampling_offsets(query).reshape(B, S, M, L, P, 2)
        attn = torch.softmax(self.attention_weights(query).reshape(
            B, S, M, L * P).float(), dim=-1).to(self.dtype).reshape(B, S, M, L, P)
        normalizer = torch.tensor([[w, h] for (h, w) in shapes],
                                  dtype=torch.float32, device=src.device)
        loc = (ref_points[None, :, None, :, None, :]
               + offsets / normalizer[None, None, None, :, None, :])
        out = msdeform.ms_deform_attn(value, shapes, msdeform.level_starts(shapes),
                                      loc.contiguous(), attn.contiguous(),
                                      radius=self.radius, ref=ref_pixels)
        return self.output_proj(out)


class DenseSelfAttention(nn.Module):
    """Full attention over the concatenated multi-scale tokens (keys
    ``q_proj``, ``k_proj``, ``value_proj``, ``output_proj``): the query
    comes from ``query`` (src + pos), keys and values from ``src``; scale
    head_dim^-0.5. Takes ``MSDeformAttnLayer``'s arguments and needs no
    reference points."""

    def __init__(self, dim: int, nheads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.nheads = nheads
        self.q_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.k_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.value_proj = Dense(dim, dim, dtype=dtype, device=device)
        self.output_proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, query, src, ref_points=None, shapes=None,
                ref_pixels=None):
        B, S, C = src.shape
        h = self.nheads
        hd = C // h

        def heads(x):  # [B, S, C] -> [B, h, S, hd]
            return x.reshape(B, S, h, hd).transpose(1, 2).contiguous()

        out = flash_attention(heads(self.q_proj(query)), heads(self.k_proj(src)),
                              heads(self.value_proj(src)), causal=False,
                              sm_scale=hd ** -0.5)
        return self.output_proj(out.transpose(1, 2).reshape(B, S, C))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, radius, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.conv_dim
        if cfg.attention_mode == "dense":
            self.self_attn = DenseSelfAttention(d, cfg.transformer_nheads,
                                                dtype=dtype, device=device)
        else:
            self.self_attn = MSDeformAttnLayer(d, cfg.num_feature_levels,
                                               cfg.transformer_nheads,
                                               cfg.enc_points, radius=radius,
                                               dtype=dtype, device=device)
        self.norm1 = LayerNorm(d, device=device)
        self.linear1 = Dense(d, cfg.transformer_dim_feedforward, dtype=dtype,
                             device=device)
        self.linear2 = Dense(cfg.transformer_dim_feedforward, d, dtype=dtype,
                             device=device)
        self.norm2 = LayerNorm(d, device=device)

    def forward(self, src, pos, ref_points, shapes, ref_pixels=None):
        src2 = self.self_attn(src + pos, src, ref_points, shapes, ref_pixels)
        src = self.norm1(src + src2)
        ffn = self.linear2(F.relu(self.linear1(src)))
        return self.norm2(src + ffn)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _Transformer(nn.Module):
    def __init__(self, cfg: PixelDecoderConfig, radius, dtype, device):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(
            cfg.num_feature_levels, cfg.conv_dim, device=device))
        self.encoder = _Encoder(EncoderLayer(cfg, radius, dtype=dtype,
                                             device=device)
                                for _ in range(cfg.transformer_enc_layers))


def _conv_norm(in_ch, out_ch, kernel, padding, dtype, device) -> nn.Sequential:
    return nn.Sequential(Conv2d(in_ch, out_ch, kernel, padding=padding,
                                dtype=dtype, device=device),
                         GroupNorm(32, out_ch, device=device))


class MSDeformAttnPixelDecoder(nn.Module):
    """features (res2, res3, res4, res5) NHWC -> (mask_features,
    transformer_encoder_feature, multi_scale_features)."""

    def __init__(self, cfg: PixelDecoderConfig, dtype=torch.float32,
                 device=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        mode = cfg.attention_mode
        if cfg.window_point_radii:
            raise NotImplementedError(
                f"pixel decoder window_point_radii={cfg.window_point_radii} "
                "is not ported (ROADMAP.md, Queue 1 item 7: K1 and K2 with "
                "one radius per point)")
        if mode not in ("deformable", "dense") + _CLAMPED_MODES:
            raise ValueError(f"unknown attention_mode {mode!r}")
        self.cfg = cfg
        self.dtype = dtype
        radius = float(cfg.window_radius) if mode in _CLAMPED_MODES else None
        self.radius = radius
        cd = cfg.conv_dim
        # top-down order res5, res4, res3
        self.input_proj = nn.ModuleList(
            _conv_norm(ch, cd, 1, 0, dtype, device)
            for ch in reversed(cfg.in_channels[1:]))
        self.transformer = _Transformer(cfg, radius, dtype, device)
        self.adapter_1 = _conv_norm(cfg.in_channels[0], cd, 1, 0, dtype, device)
        self.layer_1 = _conv_norm(cd, cd, 3, 1, dtype, device)
        self.mask_features = Conv2d(cd, cfg.mask_dim, 1, dtype=dtype,
                                    device=device)

    def forward(self, features: Sequence[torch.Tensor]):
        c = self.cfg
        res2, res3, res4, res5 = features
        level_embed = self.transformer.level_embed
        srcs, poss, shapes = [], [], []
        for i, x in enumerate([res5, res4, res3]):
            B, H, W, _ = x.shape
            y = self.input_proj[i](x)
            pos = position_embedding_sine(H, W, c.conv_dim // 2, device=x.device)
            srcs.append(y.reshape(B, H * W, c.conv_dim))
            poss.append((pos.reshape(1, H * W, c.conv_dim).expand(B, -1, -1)
                         + level_embed[i][None, None]).to(self.dtype))
            shapes.append((H, W))
        src = torch.cat(srcs, dim=1)
        pos = torch.cat(poss, dim=1)
        ref_points = torch.from_numpy(reference_points(shapes)).to(src.device)
        ref_pixels = None
        if self.radius is not None:
            ref_pixels = torch.from_numpy(
                msdeform.reference_grid(shapes)).to(src.device)

        x = src
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.transformer.encoder.layers:
            if remat:
                x = checkpoint(layer, x, pos, ref_points, shapes, ref_pixels,
                               use_reentrant=False)
            else:
                x = layer(x, pos, ref_points, shapes, ref_pixels)

        out: List[torch.Tensor] = []
        start = 0
        B = x.shape[0]
        for (H, W) in shapes:
            out.append(x[:, start:start + H * W].reshape(B, H, W, c.conv_dim))
            start += H * W

        lateral = F.relu(self.adapter_1(res2))
        up = resize_bilinear(out[-1].float(), lateral.shape[1:3]).to(lateral.dtype)
        y = F.relu(self.layer_1(lateral + up))
        out.append(y)
        mask_features = self.mask_features(out[-1])
        return mask_features, out[0], out[:3]
