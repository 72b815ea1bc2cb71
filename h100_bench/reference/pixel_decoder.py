"""MSDeformAttn pixel decoder: a frozen copy of the port's
``models/pixel_decoder.py``, with the sampler and dense attention from
``plain_ops`` (the reference runs the exact sampler).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.config import PixelDecoderConfig
from h100_bench.reference.layers import (Conv2d, Dense, GroupNorm, LayerNorm,
                                           position_embedding_sine)
from h100_bench.reference import plain_ops as msdeform
from h100_bench.reference.plain_ops import flash_attention
from h100_bench.reference.sampling import resize_bilinear

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


def sampler_radii(cfg: PixelDecoderConfig):
    """(radius K1 clamps at, or None for the exact sampler; the radius the
    offset statistics measure against): a float, or a tuple of one radius
    a point."""
    window = (tuple(float(r) for r in cfg.window_point_radii)
              or float(cfg.window_radius))
    if cfg.attention_mode == "window_pallas3" and isinstance(window, tuple):
        window = max(window)
    return (window if cfg.attention_mode in _CLAMPED_MODES else None), window


def offset_stats(offsets: torch.Tensor, radius) -> torch.Tensor:
    """[offset_max, offset_clamp_frac] (f32, on offsets' device) of offsets
    [B, S, M, L, P, 2] in target-level pixels against ``radius`` (a float,
    or one a point)."""
    absoff = offsets.float().abs()
    P = absoff.shape[-2]
    rad = torch.tensor(radius if isinstance(radius, tuple) else [radius] * P,
                       dtype=torch.float32, device=absoff.device)[:, None]
    return torch.stack([absoff.amax(),
                        (absoff > rad).any(-1).float().mean()])


class MSDeformAttnLayer(nn.Module):
    """Deformable self-attention (keys ``sampling_offsets``,
    ``attention_weights``, ``value_proj``, ``output_proj``). ``radius``:
    K1's clamp (None: exact); ``window_radius``: what ``offset_stats``
    measures against."""

    def __init__(self, d_model: int, n_levels: int, n_heads: int,
                 n_points: int, radius=None, window_radius=8.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.radius = radius
        self.window_radius = window_radius
        self.record_offsets = False
        self.offset_stats = None  # [offset_max, clamp_frac] when recorded
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
        if self.record_offsets:
            self.offset_stats = offset_stats(offsets.detach(),
                                             self.window_radius)
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
    def __init__(self, cfg: PixelDecoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        d = cfg.conv_dim
        if cfg.attention_mode == "dense":
            self.self_attn = DenseSelfAttention(d, cfg.transformer_nheads,
                                                dtype=dtype, device=device)
        else:
            radius, window = sampler_radii(cfg)
            self.self_attn = MSDeformAttnLayer(d, cfg.num_feature_levels,
                                               cfg.transformer_nheads,
                                               cfg.enc_points, radius=radius,
                                               window_radius=window,
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
    def __init__(self, cfg: PixelDecoderConfig, dtype, device):
        super().__init__()
        self.level_embed = nn.Parameter(torch.empty(
            cfg.num_feature_levels, cfg.conv_dim, device=device))
        self.encoder = _Encoder(EncoderLayer(cfg, dtype=dtype, device=device)
                                for _ in range(cfg.transformer_enc_layers))


def _conv_norm(in_ch, out_ch, kernel, padding, dtype, device) -> nn.Sequential:
    return nn.Sequential(Conv2d(in_ch, out_ch, kernel, padding=padding,
                                dtype=dtype, device=device),
                         GroupNorm(32, out_ch, device=device))


class MSDeformAttnPixelDecoder(nn.Module):
    """features (res2, res3, res4, res5) NHWC -> (mask_features,
    transformer_encoder_feature, multi_scale_features). ``radius``: None
    (exact), a float, or a tuple of one radius a point."""

    def __init__(self, cfg: PixelDecoderConfig, dtype=torch.float32,
                 device=None, remat: bool = False):
        super().__init__()
        self.remat = remat
        mode = cfg.attention_mode
        if mode not in ("deformable", "dense") + _CLAMPED_MODES:
            raise ValueError(f"unknown attention_mode {mode!r}")
        self.cfg = cfg
        self.dtype = dtype
        self.radius = sampler_radii(cfg)[0]
        cd = cfg.conv_dim
        # top-down order res5, res4, res3
        self.input_proj = nn.ModuleList(
            _conv_norm(ch, cd, 1, 0, dtype, device)
            for ch in reversed(cfg.in_channels[1:]))
        self.transformer = _Transformer(cfg, dtype, device)
        self.adapter_1 = _conv_norm(cfg.in_channels[0], cd, 1, 0, dtype, device)
        self.layer_1 = _conv_norm(cd, cd, 3, 1, dtype, device)
        self.mask_features = Conv2d(cd, cfg.mask_dim, 1, dtype=dtype,
                                    device=device)

    def configure_sampler(self, cfg: PixelDecoderConfig) -> None:
        """Take ``cfg``'s sampler (the exact or a clamped mode, its radius or
        radii) on every layer; the weights stay. The dense mode has other
        layers: it is refused both ways."""
        if "dense" in (cfg.attention_mode, self.cfg.attention_mode):
            raise ValueError("configure_sampler moves between the deformable "
                             "and window modes, not to or from dense")
        radius, window = sampler_radii(cfg)
        self.cfg, self.radius = cfg, radius
        for layer in self.transformer.encoder.layers:
            layer.self_attn.radius = radius
            layer.self_attn.window_radius = window

    def encode(self, features: Sequence[torch.Tensor]):
        """The deformable encoder over res5, res4, res3: ([B, S, conv_dim],
        the levels' (H, W))."""
        c = self.cfg
        _, res3, res4, res5 = features
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
        return x, shapes

    def forward(self, features: Sequence[torch.Tensor]):
        c = self.cfg
        res2 = features[0]
        x, shapes = self.encode(features)
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
