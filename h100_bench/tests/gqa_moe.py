"""A language model of another family than Phi, in the test tree only: the
kind ``gqa_moe``, which no configuration of the benchmark names. Pre-norm
layers of RMSNorm, grouped-query attention with rotary embeddings over the
whole head, and a routed MLP: a softmax router, the top ``experts_per_token``
experts' weights renormalised, SwiGLU experts held as two 3-D parameters.
The reference computes every expert and weights the unrouted ones by 0, and
the whole L x L score matrix, masked; the program's kernels would compute
the routed experts and the causal half (``skipped_flops``).

It has what ``h100_bench/lm/`` asks of a kind's module; the tests put it
in that package's place (``sys.modules``), as a file
``h100_bench/lm/gqa_moe.py`` would be, and add nothing else.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from h100_bench.counts import ops
from h100_bench.reference.config import section
from h100_bench.reference.layers import Dense, lower
from h100_bench.reference.phi import NEG, apply_partial_rotary, rotary_tables

SECTION = "gqa_moe"

COUNTS_KEY = "gqa_moe"
COUNTS_LAYERS = "PSALM.model.layers."
COUNTS_NOTE = "its attention causal and its experts routed"


@dataclasses.dataclass(frozen=True)
class GQAMoEConfig:
    vocab_size: int = 512
    hidden_size: int = 64
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 16
    num_experts: int = 4
    experts_per_token: int = 2
    expert_size: int = 32
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6


def flash_gqa_bound(peak, q, k, v, *, causal, sm_scale) -> float:
    """The bound of one causal attention call with ``k``, ``v`` of fewer
    heads than ``q`` (each read once)."""
    B, h, L, hd = q.shape
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * h * hd * pairs + 5 * B * h * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return ops.bound_s(peak, flops, nbytes, q.element_size() < 4)


#: what a port of it would wrap in an eval run: its causal attention
SPANS = {"eval": [("psalm_tpu_torch.ops.flash_attention", "flash_attention",
                   "flash_gqa", flash_gqa_bound)]}


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
        return x * self.weight


class Attention(nn.Module):
    def __init__(self, cfg: GQAMoEConfig, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        D, hd = cfg.hidden_size, cfg.head_dim
        self.q_proj = Dense(D, cfg.num_heads * hd, bias=False, dtype=dtype,
                            device=device)
        self.k_proj = Dense(D, cfg.num_kv_heads * hd, bias=False, dtype=dtype,
                            device=device)
        self.v_proj = Dense(D, cfg.num_kv_heads * hd, bias=False, dtype=dtype,
                            device=device)
        self.o_proj = Dense(cfg.num_heads * hd, D, bias=False, dtype=dtype,
                            device=device)

    def forward(self, x, attn_bias, cos, sin):
        c = self.cfg
        B, L, _ = x.shape
        h, kv, hd = c.num_heads, c.num_kv_heads, c.head_dim
        q = apply_partial_rotary(self.q_proj(x).reshape(B, L, h, hd), cos,
                                 sin, hd).transpose(1, 2)
        k = apply_partial_rotary(self.k_proj(x).reshape(B, L, kv, hd), cos,
                                 sin, hd).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, kv, hd).transpose(1, 2)
        k = k.repeat_interleave(h // kv, dim=1)  # each group's heads
        v = v.repeat_interleave(h // kv, dim=1)
        attn = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
        attn = attn / math.sqrt(hd) + attn_bias
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.einsum("bhls,bhsd->blhd", attn, v.to(self.dtype))
        return self.o_proj(out.reshape(B, L, h * hd))


class RoutedMLP(nn.Module):
    """The experts as two 3-D parameters: ``w_in`` [E, D, 2F] (gate, up),
    ``w_out`` [E, F, D]."""

    def __init__(self, cfg: GQAMoEConfig, dtype, device=None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        E, D, F_ = cfg.num_experts, cfg.hidden_size, cfg.expert_size
        self.router = Dense(D, E, bias=False, dtype=torch.float32,
                            device=device)
        self.w_in = nn.Parameter(torch.empty(E, D, 2 * F_, device=device))
        self.w_out = nn.Parameter(torch.empty(E, F_, D, device=device))

    def gates(self, x: torch.Tensor) -> torch.Tensor:
        """[B, L, E]: the top experts' renormalised router weights, 0
        elsewhere."""
        probs = torch.softmax(self.router(x.float()), dim=-1)
        top, idx = probs.topk(self.cfg.experts_per_token, dim=-1)
        top = top / top.sum(-1, keepdim=True)
        return torch.zeros_like(probs).scatter(-1, idx, top)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # through ``lower``, as ``Dense`` does, so the control rounds them
        dt = self.dtype
        h = torch.einsum("bld,edf->blef", lower(x.to(dt)),
                         lower(self.w_in.to(dt)))
        gate, up = h.chunk(2, dim=-1)
        a = F.silu(gate) * up * self.gates(x).to(dt)[..., None]
        return torch.einsum("blef,efd->bld", lower(a),
                            lower(self.w_out.to(dt)))


class Layer(nn.Module):
    def __init__(self, cfg: GQAMoEConfig, dtype, device=None):
        super().__init__()
        self.attn_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device=device)
        self.self_attn = Attention(cfg, dtype, device=device)
        self.mlp_norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device=device)
        self.mlp = RoutedMLP(cfg, dtype, device=device)

    def forward(self, x, attn_bias, cos, sin):
        x = x + self.self_attn(self.attn_norm(x), attn_bias, cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class GQAMoEModel(nn.Module):
    def __init__(self, cfg: GQAMoEConfig, dtype=torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.hidden_size = cfg.hidden_size
        self.vocab_size = cfg.vocab_size
        self.lm_head_bias = False
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, _weight=torch.empty(
                                             cfg.vocab_size, cfg.hidden_size,
                                             device=device))
        self.layers = nn.ModuleList(Layer(cfg, dtype, device=device)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.norm_eps, device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.dtype)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, L, _ = inputs_embeds.shape
        steps = torch.arange(L, device=inputs_embeds.device)
        positions = steps.expand(B, L)
        causal = positions[:, :, None] >= steps[None, None, :]
        bias = torch.where(causal, 0.0, NEG).to(torch.float32)[:, None]
        if attention_mask is not None:
            valid = attention_mask[:, None, None, :].bool()
            bias = bias + torch.where(valid, 0.0, NEG).to(torch.float32)
        cos, sin = rotary_tables(positions, self.cfg.head_dim,
                                 self.cfg.rope_theta)
        x = inputs_embeds
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, bias, cos, sin, use_reentrant=False)
            else:
                x = layer(x, bias, cos, sin)
        return self.norm(x)


def parse(values) -> GQAMoEConfig:
    return section(GQAMoEConfig, values)


def build(cfg: GQAMoEConfig, dtype=torch.float32, device=None,
          remat: bool = False) -> GQAMoEModel:
    return GQAMoEModel(cfg, dtype=dtype, device=device, remat=remat)


def draw_rules(module):
    """Unit RMSNorm weights; each expert's matrices LeCun-normal over its
    input width."""
    if isinstance(module, RMSNorm):
        return {"weight": ("const", 1.0)}
    if isinstance(module, RoutedMLP):
        return {"w_in": ("normal", 1.0 / math.sqrt(module.w_in.shape[1])),
                "w_out": ("normal", 1.0 / math.sqrt(module.w_out.shape[1]))}
    return None


def skipped_flops(cfg: GQAMoEConfig, L: int):
    """The score matrix's upper half (q k^T and P v: 2 L^2 h hd a layer)
    and the unrouted experts' three products (6 D F a token each)."""
    n = cfg.num_layers
    return {"causal_saving": n * 2 * L * L * cfg.num_heads * cfg.head_dim,
            "unrouted_experts": n * (cfg.num_experts - cfg.experts_per_token)
            * L * 6 * cfg.hidden_size * cfg.expert_size}


def tiny() -> GQAMoEConfig:
    return GQAMoEConfig()
