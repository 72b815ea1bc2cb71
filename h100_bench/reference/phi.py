"""Phi-1.5, the full-sequence forward only: a frozen copy of the port's
``models/phi.py`` without the KV cache, tensor parallelism, quantized
linears or the K5 branch. Attention is the einsum branch (f32 logits and
softmax, P cast to the compute type before P v), which computes the function
K5 computes on the port's ``use_flash`` path.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.config import PhiConfig
from h100_bench.reference.layers import Dense, LayerNorm

NEG = -1e9


def rotary_tables(positions: torch.Tensor, rotary_dim: int, theta: float):
    """cos/sin [*, rotary_dim] f32 for integer positions [*]."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                                             device=positions.device) / rotary_dim))
    freqs = positions[..., None].float() * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_partial_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                         rotary_dim: int) -> torch.Tensor:
    """x [B, L, h, hd]; cos/sin [B or 1, L, rotary_dim]."""
    x_rot, x_pass = x[..., :rotary_dim], x[..., rotary_dim:]
    cos = cos[:, :, None, :].to(x.dtype)
    sin = sin[:, :, None, :].to(x.dtype)
    x_rot = x_rot * cos + _rotate_half(x_rot) * sin
    return torch.cat([x_rot, x_pass], dim=-1)


class PhiAttention(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.cfg = cfg
        D = cfg.hidden_size
        self.heads = cfg.num_heads
        self.width = self.heads * cfg.head_dim
        self.q_proj = Dense(D, self.width, dtype=dtype, device=device)
        self.k_proj = Dense(D, self.width, dtype=dtype, device=device)
        self.v_proj = Dense(D, self.width, dtype=dtype, device=device)
        self.dense = Dense(self.width, D, dtype=dtype, device=device)
        self.dtype = dtype

    def forward(self, x, attn_bias, cos, sin):
        c = self.cfg
        B, L, _ = x.shape
        h, hd, D = self.heads, c.head_dim, self.width
        q = apply_partial_rotary(self.q_proj(x).reshape(B, L, h, hd), cos, sin,
                                 c.rotary_dim).transpose(1, 2)
        k = apply_partial_rotary(self.k_proj(x).reshape(B, L, h, hd), cos, sin,
                                 c.rotary_dim).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, h, hd).transpose(1, 2)  # [B, h, L, hd]
        attn = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
        attn = attn / math.sqrt(hd) + attn_bias
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.einsum("bhls,bhsd->blhd", attn, v.to(self.dtype))
        return self.dense(out.reshape(B, L, D))


class PhiMLP(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = Dense(cfg.hidden_size, cfg.intermediate_size, dtype=dtype,
                         device=device)
        self.fc2 = Dense(cfg.intermediate_size, cfg.hidden_size, dtype=dtype,
                         device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PhiDecoderLayer(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         device=device)
        self.self_attn = PhiAttention(cfg, dtype=dtype, device=device)
        self.mlp = PhiMLP(cfg, dtype=dtype, device=device)

    def forward(self, x, attn_bias, cos, sin):
        hs = self.input_layernorm(x)
        return x + self.self_attn(hs, attn_bias, cos, sin) + self.mlp(hs)


class PhiModel(nn.Module):
    """Embedding + decoder stack + final LayerNorm, on input embeddings."""

    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, _weight=torch.empty(
                                             cfg.vocab_size, cfg.hidden_size,
                                             device=device))
        self.layers = nn.ModuleList(PhiDecoderLayer(cfg, dtype=dtype,
                                                    device=device)
                                    for _ in range(cfg.num_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.dtype)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """inputs_embeds [B, L, D]; attention_mask [B, L], nonzero = valid
        (right padding). Returns the last hidden state [B, L, D] (f32)."""
        B, L, _ = inputs_embeds.shape
        steps = torch.arange(L, device=inputs_embeds.device)
        positions = steps.expand(B, L)
        causal = positions[:, :, None] >= steps[None, None, :]
        bias = torch.where(causal, 0.0, NEG).to(torch.float32)[:, None]
        if attention_mask is not None:
            valid = attention_mask[:, None, None, :].bool()
            bias = bias + torch.where(valid, 0.0, NEG).to(torch.float32)
        cos, sin = rotary_tables(positions, self.cfg.rotary_dim,
                                 self.cfg.rope_theta)
        x = inputs_embeds
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, bias, cos, sin, use_reentrant=False)
            else:
                x = layer(x, bias, cos, sin)
        return self.final_layernorm(x)
