"""PSALM top-level model: Swin tower, projector, the language model, pixel
decoder, mask decoder. A frozen copy of the port's ``models/psalm.py`` with
the mesh (the tensor-parallel ``lm_head``), ``use_flash``, ``remat_pixel``
and ``init_weights_`` taken out: ``remat`` checkpoints the language model's
layers and the pixel decoder's encoder layers, as the port's
``remat_pixel=None`` does; the benchmark draws the weights
(``h100_bench/weights.py``). The language model is the configuration's
kind's (``h100_bench/lm/``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from h100_bench import lm
from h100_bench.reference.config import PSALMConfig
from h100_bench.reference.constants import SRC_IMAGE, SRC_REGION, SRC_SEG_QUERY
from h100_bench.reference import layers
from h100_bench.reference.mask_decoder import MaskDecoder
from h100_bench.reference.pixel_decoder import MSDeformAttnPixelDecoder
from h100_bench.reference.projector import build_projector
from h100_bench.reference.sampling import point_sample
from h100_bench.reference.swin import SwinTransformer

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def positions_of_mask(mask: torch.Tensor, count: int) -> torch.Tensor:
    """First ``count`` positions where mask != 0, in order: [B, count]."""
    order = torch.argsort((mask == 0).int(), dim=-1, stable=True)
    return order[:, :count]


def segment_mean(hidden: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int):
    """Mean hidden state per segment id 1..num_segments (0 = none).
    Returns (means [B, K, D], valid [B, K])."""
    ids = torch.arange(1, num_segments + 1, device=seg_ids.device)
    onehot = (seg_ids[..., None] == ids).to(hidden.dtype)  # [B, L, K]
    sums = torch.einsum("blk,bld->bkd", onehot, hidden)
    counts = onehot.sum(dim=1)
    means = sums / torch.clamp(counts, min=1.0)[..., None]
    return means, counts > 0


def backbone(cfg: PSALMConfig, dtype=torch.float32, device=None,
             remat: bool = False) -> nn.Module:
    """The language model of the configuration's kind with the vision
    tower and projector beside it (``model.*``), registered after its own
    modules."""
    model = lm.module(cfg.language_model).build(cfg.lm, dtype=dtype,
                                                device=device, remat=remat)
    model.vision_tower = SwinTransformer(cfg.swin, dtype=dtype, device=device)
    model.mm_projector = build_projector(cfg.projector, dtype=dtype,
                                         device=device)
    return model


class PSALM(nn.Module):
    """The whole model, built on ``device`` (the card unless the caller asks
    for another; ``"cuda"`` without a card raises, as torch does).
    ``use_flash`` sends Phi's full-sequence attention through kernel K5, as
    ``use_flash=True`` does in JAX (``bench.py`` builds the eval model so).
    ``mesh``: ``lm_head`` and (float linears only) Phi's decoder layers
    tensor-parallel over its model group."""

    def __init__(self, cfg: PSALMConfig, dtype=torch.float32, device="cuda",
                 remat: bool = False, train_backbone: bool = False):
        super().__init__()
        self.cfg = cfg
        self.train_backbone = train_backbone
        self.dtype = dtype
        c = cfg
        hd = c.mask_decoder.hidden_dim
        self.model = backbone(cfg, dtype=dtype, device=device, remat=remat)
        D = self.model.hidden_size
        self.lm_head = layers.Dense(D, self.model.vocab_size,
                                    bias=self.model.lm_head_bias, dtype=dtype,
                                    device=device)
        self.seg_query = nn.Parameter(torch.empty(c.mask_decoder.num_queries, D,
                                                  device=device))
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            c.pixel_decoder, dtype=dtype, device=device, remat=remat)
        self.predictor = MaskDecoder(c.mask_decoder, dtype=dtype, device=device)
        for name in ("seg_query_projector", "SEG_token_projector",
                     "class_name_projector", "region_projector"):
            setattr(self, name, layers.Dense(D, hd, dtype=dtype, device=device))

    def encode_images(self, images: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None):
        """images [B, H, W, 3] (normalized, or raw uint8) -> (features
        res2..res5, image tokens [B, N, D_llm]). With ``train`` the frozen
        tower records no graph, so no gradient reaches it or is kept for it;
        a training tower (``train_backbone``) records it and draws its drop
        path from ``generator`` (none: deterministic)."""
        if images.dtype == torch.uint8:
            mean = torch.tensor(PIXEL_MEAN, device=images.device)
            std = torch.tensor(PIXEL_STD, device=images.device)
            images = (images.float() - mean) / std
        if train and not self.train_backbone:
            with torch.no_grad():
                feats = self.model.vision_tower(images)
        else:
            feats = self.model.vision_tower(images,
                                            generator if train else None)
        return feats, self.model.mm_projector(feats[-1])

    def sample_regions(self, image_tokens: torch.Tensor,
                       region_points: torch.Tensor) -> torch.Tensor:
        """Visual-prompt region tokens: the [n, n] token map bilinearly
        sampled (align_corners) at each region's points [B, R, P, 2] (x, y)
        in [0, 1], averaged over the P points: [B, R, D]."""
        B, N, D = image_tokens.shape
        n = int(round(N ** 0.5))
        R, P = region_points.shape[1:3]
        sampled = point_sample(image_tokens.reshape(B, n, n, D),
                               region_points.reshape(B, R * P, 2),
                               align_corners=True)
        return sampled.reshape(B, R, P, D).mean(dim=2)

    def assemble_embeddings(self, tok_ids, src_type, src_idx, image_tokens,
                            region_tokens=None):
        """The spliced input sequence [B, L, D]: text embeddings, image tokens
        at SRC_IMAGE positions, learned seg queries at SRC_SEG_QUERY, and
        region tokens [B, R, D] (when given) at SRC_REGION."""
        text = self.model.embed(tok_ids)

        def take(table):  # table [B, n, D] rows at src_idx
            idx = src_idx.clamp(0, table.shape[1] - 1).long()
            return torch.gather(table, 1, idx[..., None].expand(
                -1, -1, table.shape[2]))

        nq = self.seg_query.shape[0]
        segq = self.seg_query.to(text.dtype)[src_idx.clamp(0, nq - 1).long()]
        seq = torch.where((src_type == SRC_IMAGE)[..., None], take(image_tokens),
                          text)
        seq = torch.where((src_type == SRC_SEG_QUERY)[..., None], segq, seq)
        if region_tokens is not None:
            seq = torch.where((src_type == SRC_REGION)[..., None],
                              take(region_tokens), seq)
        return seq

    def forward(self, batch: Dict[str, torch.Tensor], *,
                use_class_names: bool = True,
                use_seg_embedding: bool = False,
                use_regions: bool = False,
                max_regions: int = 0,
                num_class_names: Optional[int] = None,
                train: bool = False,
                compute_logits: bool = False,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """batch: the splicer's arrays as tensors (tok_ids, src_type, src_idx,
        attention_mask, seg_query_mask, class_name_embedding_indices,
        refer_embedding_indices, region_embedding_mask), images [B, H, W, 3]
        and, with ``use_regions``, region_points [B, R, P, 2], optionally
        region_valid [B, R] and vp_images (the previous frame, whose tokens
        the regions are sampled from), and optionally random_idx [B, K], the
        training order of the class names. ``generator``: the training
        tower's drop-path draws. Returns the mask decoder's outputs, the
        LLM's last hidden state and, with ``compute_logits``, its
        ``lm_head`` logits."""
        c = self.cfg
        feats, image_tokens = self.encode_images(batch["images"], train=train,
                                                 generator=generator)
        region_tokens = None
        if use_regions:
            vp_tokens = (self.encode_images(batch["vp_images"], train=train,
                                            generator=generator)[1]
                         if "vp_images" in batch else image_tokens)
            region_tokens = self.sample_regions(vp_tokens,
                                                batch["region_points"])
        seq = self.assemble_embeddings(batch["tok_ids"], batch["src_type"],
                                       batch["src_idx"], image_tokens,
                                       region_tokens)
        hidden = self.model(seq, attention_mask=batch["attention_mask"])

        def rows(mask, count):  # hidden states at the first `count` marks
            pos = positions_of_mask(mask, count)
            return torch.gather(hidden, 1,
                                pos[..., None].expand(-1, -1, hidden.shape[-1]))

        seg_query = self.seg_query_projector(
            rows(batch["seg_query_mask"], c.mask_decoder.num_queries))

        class_name_embedding = valid = None
        if use_class_names:
            K = num_class_names or c.num_classes + 1
            means, valid = segment_mean(
                hidden, batch["class_name_embedding_indices"], K)
            class_name_embedding = self.class_name_projector(means)
            ridx = batch.get("random_idx")
            if ridx is not None:  # the training shuffle of the class names
                ridx = ridx.long()
                class_name_embedding = torch.gather(
                    class_name_embedding, 1, ridx[..., None].expand(
                        -1, -1, class_name_embedding.shape[-1]))
                valid = torch.gather(valid, 1, ridx)

        SEG_embedding = None
        if use_seg_embedding:
            means, _ = segment_mean(hidden, batch["refer_embedding_indices"], 1)
            SEG_embedding = self.SEG_token_projector(means)

        region_embedding = region_valid = None
        if use_regions:
            R = max_regions or batch["region_points"].shape[1]
            region_embedding = self.region_projector(
                rows(batch["region_embedding_mask"], R))
            region_valid = batch.get("region_valid")

        mask_features, _, multi_scale = self.pixel_decoder(feats)
        out = self.predictor(multi_scale, mask_features, seg_query,
                             SEG_embedding=SEG_embedding,
                             class_name_embedding=class_name_embedding,
                             class_name_valid=valid,
                             region_embedding=region_embedding,
                             region_valid=region_valid)
        if compute_logits:
            out["logits"] = self.logits(hidden)
        return {"hidden": hidden, **out}

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm_head(hidden)
