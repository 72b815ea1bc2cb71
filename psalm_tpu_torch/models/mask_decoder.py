"""PSALM mask decoder: Mask2Former-style masked-attention transformer.

Counterpart of ``psalm_tpu/models/mask_decoder.py``: ``dec_layers`` rounds of
masked cross-attention, self-attention and FFN (post-norm), round-robin over
the three multi-scale levels, with prediction heads before the first round
and after each. The attention mask of each round is the previous round's mask
logits, resized bilinearly to the level and blocked where sigmoid < 0.5
(fully blocked rows unblocked), in f32. Both the woconcat path (the released
model's) and the concat path (the [SEG] row prepended) are ported. The heads
give the [SEG] logits (referring), the class-name logits (panoptic, semantic,
instance) and the region logits [B, R, Q] (region prompts, ``REGION_proj``),
each only when its conditioning is given; invalid class names and regions
get -1e9.

Parameter names are the released checkpoint's (``predictor.*``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from psalm_tpu_torch.config import MaskDecoderConfig
from psalm_tpu_torch.models.layers import (MLP, Dense, LayerNorm,
                                           MultiheadAttention, sine_table)
from psalm_tpu_torch.ops.sampling import resize_bilinear

NEG_INF = -1e9


class Table(nn.Module):
    """A learned table stored as ``weight`` (an ``nn.Embedding``'s key)."""

    def __init__(self, n: int, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim, device=device))


class CrossAttentionLayer(nn.Module):
    def __init__(self, dim, nheads, dtype=torch.float32, device=None):
        super().__init__()
        self.multihead_attn = MultiheadAttention(dim, nheads, dtype=dtype,
                                                 device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tgt, memory, attn_bias, pos, query_pos):
        out = self.multihead_attn(tgt + query_pos, memory + pos, memory,
                                  attn_bias)
        return self.norm(tgt + out)


class SelfAttentionLayer(nn.Module):
    def __init__(self, dim, nheads, dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = MultiheadAttention(dim, nheads, dtype=dtype,
                                            device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tgt, query_pos):
        q = tgt + query_pos
        return self.norm(tgt + self.self_attn(q, q, tgt, None))


class FFNLayer(nn.Module):
    def __init__(self, dim, dim_feedforward, dtype=torch.float32, device=None):
        super().__init__()
        self.linear1 = Dense(dim, dim_feedforward, dtype=dtype, device=device)
        self.linear2 = Dense(dim_feedforward, dim, dtype=dtype, device=device)
        self.norm = LayerNorm(dim, device=device)

    def forward(self, tgt):
        return self.norm(tgt + self.linear2(F.relu(self.linear1(tgt))))


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        hd = c.hidden_dim
        self.query_embed = Table(c.num_queries, hd, device)
        self.query_feat = Table(c.num_queries, hd, device)
        self.SEG_query_embed = Table(c.num_queries + 1, hd, device)
        self.level_embed = Table(c.num_feature_levels, hd, device)
        self.transformer_cross_attention_layers = nn.ModuleList(
            CrossAttentionLayer(hd, c.nheads, dtype, device)
            for _ in range(c.dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            SelfAttentionLayer(hd, c.nheads, dtype, device)
            for _ in range(c.dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            FFNLayer(hd, c.dim_feedforward, dtype, device)
            for _ in range(c.dec_layers))
        self.decoder_norm = LayerNorm(hd, device=device)
        self.mask_embed = MLP(hd, hd, c.mask_dim, 3, dtype, device)
        self.SEG_proj = MLP(hd, hd, hd, 2, dtype, device)
        self.CLASS_proj = MLP(hd, hd, hd, 2, dtype, device)
        self.REGION_proj = MLP(hd, hd, hd, 2, dtype, device)

    def _prediction_heads(self, output, mask_features, attn_size,
                          SEG_embedding, class_name_embedding,
                          class_name_valid, region_embedding, region_valid):
        """output [B, Q, D]; mask_features [B, H, W, Dm]."""
        dec = self.decoder_norm(output.float()).to(output.dtype)

        SEG_class = None
        if SEG_embedding is not None:
            SEG_class = torch.einsum("bld,bcd->blc", self.SEG_proj(dec),
                                     SEG_embedding)
        class_name_class = None
        if class_name_embedding is not None:
            logits = torch.einsum("bld,bcd->blc", self.CLASS_proj(dec),
                                  class_name_embedding)
            if class_name_valid is not None:
                logits = torch.where(class_name_valid[:, None, :], logits,
                                     torch.full_like(logits, NEG_INF))
            class_name_class = logits
        region_class = None
        if region_embedding is not None:
            logits = torch.einsum("brd,bld->brl", region_embedding,
                                  self.REGION_proj(dec))
            if region_valid is not None:
                logits = torch.where(region_valid[:, :, None], logits,
                                     torch.full_like(logits, NEG_INF))
            region_class = logits

        mask_embed = self.mask_embed(dec)
        outputs_mask = torch.einsum("bqc,bhwc->bqhw", mask_embed,
                                    mask_features.to(mask_embed.dtype))

        # f32 island: resize to the next level, block where sigmoid < 0.5,
        # unblock fully blocked rows
        m = outputs_mask.float()
        B, Q = m.shape[:2]
        m = resize_bilinear(m.reshape(B * Q, *m.shape[2:], 1), attn_size)
        m = m.reshape(B, Q, attn_size[0] * attn_size[1])
        blocked = torch.sigmoid(m) < 0.5
        blocked = blocked & ~blocked.all(dim=-1, keepdim=True)
        # two kernels and no host scalar: torch.where on Python scalars
        # would fill a device tensor for each
        attn_bias = torch.zeros_like(m).masked_fill_(blocked, NEG_INF)[:, None]
        return SEG_class, class_name_class, outputs_mask, region_class, attn_bias

    def forward(self, x: Sequence[torch.Tensor], mask_features: torch.Tensor,
                seg_query: torch.Tensor,
                SEG_embedding: Optional[torch.Tensor] = None,
                class_name_embedding: Optional[torch.Tensor] = None,
                class_name_valid: Optional[torch.Tensor] = None,
                region_embedding: Optional[torch.Tensor] = None,
                region_valid: Optional[torch.Tensor] = None):
        """x: 3 NHWC level features (res5-, res4-, res3-scale);
        mask_features [B, H/4, W/4, Dm]; seg_query [B, Q, D];
        region_embedding [B, R, D] with region_valid [B, R] bool."""
        c = self.cfg
        if len(x) != c.num_feature_levels:
            raise ValueError(f"{len(x)} levels, expected {c.num_feature_levels}")
        B = x[0].shape[0]
        src, pos, sizes = [], [], []
        for i, xi in enumerate(x):
            _, H, W, _ = xi.shape
            pe = sine_table(H, W, c.hidden_dim // 2, xi.device)
            pos.append(pe.reshape(1, H * W, -1).expand(B, -1, -1).to(xi.dtype))
            src.append(xi.reshape(B, H * W, -1) + self.level_embed.weight[i][None, None])
            sizes.append((H, W))

        def heads(out, lvl, seg_emb):
            return self._prediction_heads(
                out, mask_features, sizes[lvl], seg_emb, class_name_embedding,
                class_name_valid, region_embedding, region_valid)

        concat = c.seg_concat
        qe = self.SEG_query_embed.weight if concat else self.query_embed.weight
        query_pos = qe[None].expand(B, -1, -1).to(seg_query.dtype)
        output = seg_query
        seg_emb = SEG_embedding
        preds = []
        *pred, attn_bias = heads(output, 0, seg_emb)
        preds.append(pred)
        for i in range(c.dec_layers):
            lvl = i % c.num_feature_levels
            cross = self.transformer_cross_attention_layers[i]
            selfa = self.transformer_self_attention_layers[i]
            ffn = self.transformer_ffn_layers[i]
            if concat:
                # the [SEG] row attends everywhere; after the layer the
                # refreshed SEG embedding is the first QUERY row of the
                # stripped output (the reference quirk the JAX package keeps)
                ext = torch.cat([seg_emb, output], dim=1)
                bias = torch.cat([torch.zeros_like(attn_bias[:, :, :1]),
                                  attn_bias], dim=2)
                ext = ffn(selfa(cross(ext, src[lvl], bias, pos[lvl], query_pos),
                                query_pos))
                output = ext[:, 1:]
                seg_emb = output[:, :1]
            else:
                output = ffn(selfa(cross(output, src[lvl], attn_bias, pos[lvl],
                                         query_pos), query_pos))
            *pred, attn_bias = heads(output, (i + 1) % c.num_feature_levels,
                                     seg_emb)
            preds.append(pred)
        keys = ("pred_SEG_logits", "pred_class_name_logits", "pred_masks",
                "pred_region_logits")
        return {**dict(zip(keys, preds[-1])),
                "aux_outputs": [dict(zip(keys, p)) for p in preds[:-1]]}
