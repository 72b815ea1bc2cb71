"""Shared blocks: the building modules of the port and the counterparts of
``psalm_tpu/models/layers.py`` (sine position embedding, torch-compatible
multi-head attention, DETR-style MLP, the LoRA linear).

Dtype rules follow the JAX package's flax modules, so that a model stored in
bf16 computes as ``psalm_tpu`` does with ``compute_dtype="bfloat16"``:
``Dense``/``Conv2d`` cast input and weights to their compute dtype;
``LayerNorm``/``GroupNorm``/``BatchNorm2d`` compute and return f32. Parameters
are created empty on the given device; weights come from ``load_state_dict``
or from ``psalm_tpu_torch.models.psalm.init_weights_``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


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
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LoRADense(nn.Module):
    """A linear layer with an additive low-rank adapter (``psalm_tpu``'s
    ``LoRADense``): y = base(x) + (alpha / rank) (x A) B, with A
    [in, rank] and B [rank, out] in JAX's orientation and the adapter in
    x's type, as JAX computes it (so an f32 input gives an f32 output). The
    base is a ``Dense`` or, with ``quant_bits == 8``, an int8
    ``QuantDense`` (QLoRA); its keys sit under ``base.``. ``reset_adapters``
    draws A from N(0, 0.02^2) and zeroes B, so the adapter starts at zero
    and the grafted base model is unchanged. ``psalm_tpu_torch.train.lora``
    freezes the base."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float = 16.0, bias: bool = True, dtype=torch.float32,
                 quant_bits: int = 0, device=None):
        super().__init__()
        if quant_bits == 8:
            from psalm_tpu_torch.models.quant import QuantDense
            self.base = QuantDense(in_features, out_features, bias=bias,
                                   dtype=dtype, device=device)
        elif quant_bits == 0:
            self.base = Dense(in_features, out_features, bias=bias,
                              dtype=dtype, device=device)
        else:
            raise ValueError(f"LoRA over quant_bits={quant_bits}: the base "
                             "is float or int8")
        self.scaling = alpha / rank
        self.lora_A = _empty(in_features, rank, device=device)
        self.lora_B = _empty(rank, out_features, device=device)

    @torch.no_grad()
    def reset_adapters(self, generator: torch.Generator) -> None:
        self.lora_A.normal_(0.0, 0.02, generator=generator)
        self.lora_B.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        delta = (x @ self.lora_A.to(x.dtype)) @ self.lora_B.to(x.dtype)
        return self.base(x) + delta * self.scaling


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
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
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
        q = F.linear(query.to(dt), w[:D], b[:D])
        k = F.linear(key.to(dt), w[D:2 * D], b[D:2 * D])
        v = F.linear(value.to(dt), w[2 * D:], b[2 * D:])
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
