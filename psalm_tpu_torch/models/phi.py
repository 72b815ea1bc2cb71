"""Phi-1.5 decoder: the full-sequence forward (what eval_seg runs) and the
KV-cache forward of chat generation.

Counterpart of ``psalm_tpu/models/phi.py``: parallel attention and MLP
branches off one input LayerNorm, partial rotary embedding over the first
``rotary_dim`` channels of each head (rotate-half convention, theta 10000),
``gelu_new`` (tanh) MLP, a final LayerNorm. Attention logits and softmax are
f32 with an additive f32 bias of -1e9 for causal and padding masking, the
einsum branch of the JAX package in plain PyTorch. The linears are
``Dense``, or the int8 / int4 layers of ``models/quant.py`` when
``cfg.quant_bits`` is 8 or 4, or with ``cfg.lora_rank`` > 0 a ``LoRADense``
over a float or int8 base (``models/layers.py``).

With ``use_flash`` (off by default, as in JAX), a full-sequence forward
without a cache and of more than one token takes JAX's flash branch instead:
kernel K5 (``ops/flash_attention.py``), causal, scale 1/sqrt(head_dim), with
q, k and v in the model's dtype and no padding mask. Sequences are
right-padded, so every valid row attends to exactly the keys it attends to
in the einsum branch and agrees with it; pad query rows differ (the einsum
branch masks the pad keys, the flash branch attends to the earlier ones),
and nothing downstream reads them.

The KV cache (``KVCache``) keeps a position per row, so right-padded
prompts decode exactly:
  * prefill writes slots 0..L-1 and sets each row's position p[b] to its
    number of valid tokens n[b];
  * each decode step writes row b's new key and value at slot p[b]
    (overwriting a pad slot), attends to the keys at slots <= p[b], takes
    rotary position p[b], then increments p[b].
``psalm_tpu``'s cache writes every row at one shared slot (the padded
length) and starts positions at n, so after a padded prefill its decoded
tokens attend to pad keys and never to their own; for an unpadded prompt the
two agree. The cache is updated in place (JAX donates it instead). With a
bf16 model and cache, q and the cached keys are cast to f32 for q k^T (JAX
takes bf16 products with f32 accumulation: the same values, since bf16
products are exact in f32), and the probabilities are cast to bf16 for the
product with the cached values, as in JAX's cache branch.

With ``remat`` (gradient checkpointing, ``nn.remat`` per decoder layer in
JAX), a full-sequence forward that records gradients keeps only each
layer's input and recomputes the layer in the backward
(``torch.utils.checkpoint``, non-reentrant).

Parameter names are the released checkpoint's (``model.embed_tokens``,
``model.layers.N.*``, ``model.final_layernorm``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from psalm_tpu_torch.config import PhiConfig
from psalm_tpu_torch.models.layers import LayerNorm
from psalm_tpu_torch.models.quant import make_dense
from psalm_tpu_torch.ops.flash_attention import flash_attention

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


class KVCache:
    """Keys and values of every layer for a batch of B sequences, updated in
    place by ``PhiModel.forward``.

    Layout [B, h, S, hd] per layer (``k[i]``, ``v[i]``): on the GPU a head's
    keys are contiguous rows of hd channels, which the decode step's
    q @ k^T reads whole. (JAX keeps [B, h, hd, S] for the TPU's lanes.)

      pos   [B] int64 on the device: the slot, and the rotary position, of
            each row's next token (the number of valid prompt tokens after
            prefill, plus one per decode step)
      span  host int: slots [0, span) may hold a written key, so attention
            reads only those (0 = empty, before prefill)
    """

    def __init__(self, cfg: PhiConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16, device=None):
        shape = (batch, cfg.num_heads, max_len, cfg.head_dim)
        self.k = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(cfg.num_layers)]
        self.pos = torch.zeros(batch, dtype=torch.long, device=device)
        self.span = 0

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2]

    def clone(self) -> "KVCache":
        other = KVCache.__new__(KVCache)
        other.k = [t.clone() for t in self.k]
        other.v = [t.clone() for t in self.v]
        other.pos = self.pos.clone()
        other.span = self.span
        return other


class PhiAttention(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None,
                 use_flash: bool = False):
        super().__init__()
        self.cfg = cfg
        self.use_flash = use_flash
        D = cfg.hidden_size
        self.q_proj = make_dense(cfg, D, D, dtype=dtype, device=device)
        self.k_proj = make_dense(cfg, D, D, dtype=dtype, device=device)
        self.v_proj = make_dense(cfg, D, D, dtype=dtype, device=device)
        self.dense = make_dense(cfg, D, D, dtype=dtype, device=device)
        self.dtype = dtype

    def forward(self, x, attn_bias, cos, sin, cache: Optional[KVCache] = None,
                layer: int = 0, slots: Optional[torch.Tensor] = None):
        """x [B, L, D]; attn_bias [B, 1, L, L or cache.span] f32; cos/sin
        [B, L, rd]. With a cache: ``slots`` None is the prefill (write
        slots 0..L-1, attend among the L tokens); else [B, L] int64, the slot
        of each new token, attending to the cache's first ``cache.span``
        slots."""
        c = self.cfg
        B, L, D = x.shape
        h, hd = c.num_heads, c.head_dim
        q = apply_partial_rotary(self.q_proj(x).reshape(B, L, h, hd), cos, sin,
                                 c.rotary_dim).transpose(1, 2)
        k = apply_partial_rotary(self.k_proj(x).reshape(B, L, h, hd), cos, sin,
                                 c.rotary_dim).transpose(1, 2)
        v = self.v_proj(x).reshape(B, L, h, hd).transpose(1, 2)  # [B, h, L, hd]
        if cache is not None:
            ck, cv = cache.k[layer], cache.v[layer]
            if slots is None:
                ck[:, :, :L] = k
                cv[:, :, :L] = v
            else:
                idx = slots[:, None, :, None].expand(B, h, L, hd)
                ck.scatter_(2, idx, k.to(ck.dtype))
                cv.scatter_(2, idx, v.to(cv.dtype))
                k, v = ck[:, :, :cache.span], cv[:, :, :cache.span]
        elif self.use_flash and L > 1:
            out = flash_attention(q.to(self.dtype).contiguous(),
                                  k.to(self.dtype).contiguous(),
                                  v.to(self.dtype).contiguous(), causal=True,
                                  sm_scale=1.0 / math.sqrt(hd))
            return self.dense(out.transpose(1, 2).reshape(B, L, D))
        attn = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
        attn = attn / math.sqrt(hd) + attn_bias
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.einsum("bhls,bhsd->blhd", attn, v.to(self.dtype))
        return self.dense(out.reshape(B, L, D))


class PhiMLP(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = make_dense(cfg, cfg.hidden_size, cfg.intermediate_size,
                              dtype=dtype, device=device)
        self.fc2 = make_dense(cfg, cfg.intermediate_size, cfg.hidden_size,
                              dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class PhiDecoderLayer(nn.Module):
    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None,
                 use_flash: bool = False):
        super().__init__()
        self.input_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         device=device)
        self.self_attn = PhiAttention(cfg, dtype=dtype, device=device,
                                      use_flash=use_flash)
        self.mlp = PhiMLP(cfg, dtype=dtype, device=device)

    def forward(self, x, attn_bias, cos, sin, cache=None, layer=0, slots=None):
        hs = self.input_layernorm(x)
        return (x + self.self_attn(hs, attn_bias, cos, sin, cache, layer, slots)
                + self.mlp(hs))


class PhiModel(nn.Module):
    """Embedding + decoder stack + final LayerNorm, on input embeddings."""

    def __init__(self, cfg: PhiConfig, dtype=torch.float32, device=None,
                 use_flash: bool = False, remat: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.remat = remat
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         device=device, _weight=torch.empty(
                                             cfg.vocab_size, cfg.hidden_size,
                                             device=device))
        self.layers = nn.ModuleList(PhiDecoderLayer(cfg, dtype=dtype,
                                                    device=device,
                                                    use_flash=use_flash)
                                    for _ in range(cfg.num_layers))
        self.final_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                         device=device)

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids).to(self.dtype)

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> KVCache:
        """An empty cache of ``max_len`` slots on the model's device."""
        return KVCache(self.cfg, batch, max_len, dtype,
                       self.embed_tokens.weight.device)

    def forward(self, inputs_embeds: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None) -> torch.Tensor:
        """inputs_embeds [B, L, D]; attention_mask [B, L], nonzero = valid
        (right padding). Returns the last hidden state [B, L, D] (f32).

        With an empty ``cache`` this is the prefill: the full-sequence
        forward, which also writes slots 0..L-1 and sets each row's position
        to its count of valid tokens. With a filled one it is a decode step
        of L new tokens per row at the rows' positions (see the module
        docstring); ``attention_mask`` is then not read."""
        B, L, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        steps = torch.arange(L, device=dev)
        slots = None
        if cache is None or cache.span == 0:
            if cache is not None and L > cache.max_len:
                raise ValueError(f"prompt of {L} tokens exceeds the KV cache "
                                 f"of {cache.max_len} slots")
            positions = steps.expand(B, L)
            keys = steps
        else:
            if cache.span + L > cache.max_len:
                raise ValueError(f"KV cache of {cache.max_len} slots is full "
                                 f"({cache.span} used, {L} more asked)")
            slots = positions = cache.pos[:, None] + steps  # [B, L]
            cache.span += L
            keys = torch.arange(cache.span, device=dev)
        causal = positions[:, :, None] >= keys[None, None, :]
        bias = torch.where(causal, 0.0, NEG).to(torch.float32)[:, None]
        if attention_mask is not None and slots is None:
            valid = attention_mask[:, None, None, :].bool()
            bias = bias + torch.where(valid, 0.0, NEG).to(torch.float32)
        cos, sin = rotary_tables(positions, self.cfg.rotary_dim,
                                 self.cfg.rope_theta)
        x = inputs_embeds
        remat = self.remat and cache is None and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x = checkpoint(layer, x, bias, cos, sin, use_reentrant=False)
            else:
                x = layer(x, bias, cos, sin, cache, i, slots)
        if cache is not None:
            if slots is None:
                cache.span = L
                cache.pos = (attention_mask.long().sum(-1)
                             if attention_mask is not None
                             else torch.full((B,), L, device=dev))
            else:
                cache.pos += L
        return self.final_layernorm(x)
