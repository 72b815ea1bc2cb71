"""Swin Transformer backbone (Swin-B by default), NHWC.

Counterpart of ``psalm_tpu/models/swin.py``: the same padding of each block
to a window multiple after ``norm1`` (padded tokens take part in the
attention of un-shifted blocks), the same cyclic shift and -100 shift mask,
the same LayerNorms before each stage output. The window-attention core runs
in kernel K3 (``psalm_tpu_torch/ops/swin_attention.py``); the ``qkv``/``proj``
linears and the relative-position-bias gather stay plain PyTorch.

Parameter names are the released checkpoint's (``model.vision_tower.*``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from psalm_tpu.config import SwinConfig
from psalm_tpu_torch.models.layers import Conv2d, Dense, LayerNorm
from psalm_tpu_torch.ops.swin_attention import window_attention


def relative_position_index(window_size: int) -> np.ndarray:
    """[ws*ws, ws*ws] index into the (2ws-1)^2 bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(Hp: int, Wp: int, window_size: int, shift: int) -> np.ndarray:
    """[nW, ws*ws, ws*ws] f32 additive mask of 0 / -100 for shifted windows."""
    img_mask = np.zeros((Hp, Wp))
    slices = (slice(0, -window_size), slice(-window_size, -shift),
              slice(-shift, None))
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    nH, nW = Hp // window_size, Wp // window_size
    mw = img_mask.reshape(nH, window_size, nW, window_size)
    mw = mw.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nH*nW, ws*ws, C] (H, W multiples of ws)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    """[B*nH*nW, ws*ws, C] -> [B, H, W, C]."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * window_size - 1) ** 2, num_heads, device=device))
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(relative_position_index(window_size)).to(device),
            persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [Bn, N, C]; mask [nW, N, N] f32 or None."""
        Bn, N, C = x.shape
        h = self.num_heads
        qkv = self.qkv(x).contiguous()
        bias = self.relative_position_bias_table.float()[
            self.relative_position_index.reshape(-1)]
        bias = bias.reshape(N, N, h).permute(2, 0, 1).contiguous()
        out = window_attention(qkv, bias, mask, h, (C // h) ** -0.5)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.fc2 = Dense(hidden, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int, mlp_ratio: float, qkv_bias: bool,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias,
                                    dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, H: int, W: int,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, H*W, C]; mask: the stage's shift mask (used when shifted)."""
        B, L, C = x.shape
        ws, s = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(B, H, W, C)
        pad_b = (ws - H % ws) % ws
        pad_r = (ws - W % ws) % ws
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        if s > 0:
            x = torch.roll(x, shifts=(-s, -s), dims=(1, 2))
        xw = self.attn(window_partition(x, ws), mask if s > 0 else None)
        x = window_reverse(xw, ws, Hp, Wp)
        if s > 0:
            x = torch.roll(x, shifts=(s, s), dims=(1, 2))
        x = x[:, :H, :W].reshape(B, H * W, C)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        B, L, C = x.shape
        x = x.reshape(B, H, W, C)
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(B, -1, 4 * C)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: SwinConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.proj = Conv2d(cfg.in_chans, cfg.embed_dim, cfg.patch_size,
                           stride=cfg.patch_size, dtype=dtype, device=device)
        self.norm = LayerNorm(cfg.embed_dim, device=device) if cfg.patch_norm \
            else None


class BasicLayer(nn.Module):
    def __init__(self, cfg: SwinConfig, i: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        dim = cfg.num_features[i]
        self.blocks = nn.ModuleList(
            SwinBlock(dim, cfg.num_heads[i], cfg.window_size,
                      0 if j % 2 == 0 else cfg.window_size // 2,
                      cfg.mlp_ratio, cfg.qkv_bias, dtype=dtype, device=device)
            for j in range(cfg.depths[i]))
        self.downsample = (PatchMerging(dim, dtype=dtype, device=device)
                           if i < len(cfg.depths) - 1 else None)


class SwinTransformer(nn.Module):
    """images [B, H, W, 3] normalized -> (res2, res3, res4, res5) NHWC."""

    def __init__(self, cfg: SwinConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg, dtype=dtype, device=device)
        self.layers = nn.ModuleList(
            BasicLayer(cfg, i, dtype=dtype, device=device)
            for i in range(len(cfg.depths)))
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", LayerNorm(cfg.num_features[i],
                                                  device=device))
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _shift_mask(self, Hp: int, Wp: int, device) -> torch.Tensor:
        ws = self.cfg.window_size
        key = (Hp, Wp, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_attn_mask(Hp, Wp, ws, ws // 2)).to(device)
        return self._masks[key]

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        c = self.cfg
        B, H, W, _ = images.shape
        if H % c.patch_size or W % c.patch_size:
            raise ValueError(f"image {H}x{W} is not a multiple of the patch "
                             f"size {c.patch_size}")
        x = self.patch_embed.proj(images)
        Wh, Ww = x.shape[1], x.shape[2]
        x = x.reshape(B, Wh * Ww, c.embed_dim)
        if self.patch_embed.norm is not None:
            x = self.patch_embed.norm(x)
        ws = c.window_size
        outs = []
        for i, layer in enumerate(self.layers):
            Hp, Wp = -(-Wh // ws) * ws, -(-Ww // ws) * ws
            mask = self._shift_mask(Hp, Wp, x.device) if len(layer.blocks) > 1 \
                else None
            for blk in layer.blocks:
                x = blk(x, Wh, Ww, mask)
            if i in c.out_indices:
                y = getattr(self, f"norm{i}")(x)
                outs.append(y.reshape(B, Wh, Ww, c.num_features[i]))
            if layer.downsample is not None:
                x = layer.downsample(x, Wh, Ww)
                Wh, Ww = (Wh + 1) // 2, (Ww + 1) // 2
        return tuple(outs)
