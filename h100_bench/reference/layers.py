"""Shared blocks of the reference: a frozen copy of the port's
``models/layers.py`` without the LoRA linear. ``Dense`` / ``Conv2d`` cast
input and weights to their compute dtype; the norms compute in f32.

``LOWER`` is the control's switch (``h100_bench/correct.py``): set to a
float8 type, every ``Dense``, ``Conv2d`` and ``MultiheadAttention``
projection rounds its input and weight to it (one scale a tensor, from its
largest magnitude) and multiplies the rounded values in f32, as an fp8 GEMM
with f32 accumulation does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


#: the control's lower precision (a float8 type) or None (module docstring)
LOWER = None


def lower(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to ``LOWER`` with one scale from its largest magnitude
    (the type's largest finite value at the tensor's largest element), back
    in ``t``'s type; ``t`` itself while ``LOWER`` is None."""
    if LOWER is None:
        return t
    top = torch.finfo(LOWER).max
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / top
    return ((t.float() / scale).to(LOWER).float() * scale).to(t.dtype)


def _empty(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class Dense(nn.Module):
    """Linear layer computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(out_features, in_features, device=device)
        self.bias = _empty(out_features, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(lower(x.to(dt)), lower(self.weight.to(dt)), b)


class Conv2d(nn.Module):
    """Convolution on NHWC tensors computing in ``dtype``. ``padding`` is
    symmetric (the JAX package's explicit ((p, p), (p, p)); its 'SAME'
    convolutions here all have zero padding)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dtype = dtype
        self.stride = stride
        self.padding = padding
        self.weight = _empty(out_ch, in_ch, kernel, kernel, device=device)
        self.bias = _empty(out_ch, device=device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(lower(x.to(dt)).permute(0, 3, 1, 2),
                     lower(self.weight.to(dt)), b,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 1)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis in f32 (flax ``LayerNorm(dtype=f32)``)."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty(dim, device=device)
        self.bias = _empty(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps)


class GroupNorm(nn.Module):
    """GroupNorm on NHWC tensors in f32."""

    def __init__(self, groups: int, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = _empty(dim, device=device)
        self.bias = _empty(dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.groups,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.permute(0, 2, 3, 1)


class BatchNorm2d(nn.Module):
    """Eval-mode BatchNorm on NHWC tensors from the running statistics, in
    f32."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty(dim, device=device)
        self.bias = _empty(dim, device=device)
        self.register_buffer("running_mean", torch.empty(dim, device=device))
        self.register_buffer("running_var", torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var.float() + self.eps) * self.weight.float()
        return (x.float() - self.running_mean.float()) * mul + self.bias.float()


def position_embedding_sine(H: int, W: int, num_pos_feats: int,
                            temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """[H, W, 2 * num_pos_feats] f32, channels (pos_y, pos_x), each
    interleaved sin/cos; computed in numpy exactly as
    ``psalm_tpu/models/layers.py::position_embedding_sine``."""
    scale = 2 * math.pi
    eps = 1e-6
    y = (np.arange(H, dtype=np.float32) + 1.0) / (H + eps) * scale
    x = (np.arange(W, dtype=np.float32) + 1.0) / (W + eps) * scale
    dim_t = temperature ** (2 * (np.arange(num_pos_feats) // 2) / num_pos_feats)
    pos_x = x[:, None] / dim_t
    pos_y = y[:, None] / dim_t

    def interleave(p):
        return np.stack([np.sin(p[:, 0::2]), np.cos(p[:, 1::2])],
                        axis=2).reshape(p.shape[0], -1)

    pos_x = interleave(pos_x)
    pos_y = interleave(pos_y)
    out = np.concatenate([
        np.broadcast_to(pos_y[:, None, :], (H, W, num_pos_feats)),
        np.broadcast_to(pos_x[None, :, :], (H, W, num_pos_feats)),
    ], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


class MultiheadAttention(nn.Module):
    """``torch.nn.MultiheadAttention``'s parameters (packed ``in_proj``),
    computed as the JAX package's MultiheadAttention: q scaled by hd^-0.5,
    logits and softmax in f32."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.in_proj_weight = _empty(3 * dim, dim, device=device)
        self.in_proj_bias = _empty(3 * dim, device=device)
        self.out_proj = Dense(dim, dim, dtype=dtype, device=device)

    def forward(self, query, key, value,
                attn_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query [B, Q, D]; key/value [B, S, D]; attn_bias additive f32
        broadcastable to [B, h, Q, S] or None."""
        B, Q, D = query.shape
        h = self.num_heads
        hd = D // h
        dt = self.dtype
        w = self.in_proj_weight.to(dt)
        b = self.in_proj_bias.to(dt)
        q = F.linear(lower(query.to(dt)), lower(w[:D]), b[:D])
        k = F.linear(lower(key.to(dt)), lower(w[D:2 * D]), b[D:2 * D])
        v = F.linear(lower(value.to(dt)), lower(w[2 * D:]), b[2 * D:])
        q = q.reshape(B, Q, h, hd) * (hd ** -0.5)
        k = k.reshape(B, -1, h, hd)
        v = v.reshape(B, -1, h, hd)
        logits = torch.einsum("bqhd,bshd->bhqs", q, k).float()
        if attn_bias is not None:
            logits = logits + attn_bias
        attn = torch.softmax(logits, dim=-1).to(dt)
        out = torch.einsum("bhqs,bshd->bqhd", attn, v).reshape(B, Q, D)
        return self.out_proj(out)


class MLP(nn.Module):
    """DETR-style MLP with relu between layers; keys ``layers.{i}``."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dtype=torch.float32, device=None):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Dense(dims[i], dims[i + 1], dtype=dtype, device=device)
            for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
