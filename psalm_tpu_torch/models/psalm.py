"""PSALM top-level model: Swin tower, projector, Phi, pixel decoder, mask
decoder.

Counterpart of ``psalm_tpu/models/psalm.py`` for two paths:
  * the segmentation forward with ``compute_logits=False``, which is what the
    eval runner runs for every task: the spliced sequence
    (``data/splicer.py``'s arrays) is assembled with gathers, run through
    Phi once, and the seg-query hidden states condition the mask decoder
    together with, as the task's keyword flags ask, the mean-pooled
    class-name hidden states (panoptic, semantic, instance), the mean-pooled
    refer-sentence hidden state through ``SEG_token_projector`` (referring),
    and the hidden states at the region tokens through ``region_projector``
    (region; the region tokens themselves are the image tokens bilinearly
    sampled at each region's points and averaged, ``sample_regions``);
  * what chat generation calls (``models/generation.py``): the image
    tokens (``encode_images``), the spliced embeddings
    (``assemble_embeddings``), Phi with a KV cache (``model``, a
    ``PhiModel``) and the ``lm_head`` logits;
  * the training forward (``forward(..., train=True)``, what
    ``train/train.py`` differentiates): the frozen vision tower runs under
    ``torch.no_grad()``, the counterpart of JAX's ``stop_gradient`` on the
    frozen tower's features (the projector after it trains, its BatchNorm
    on the running statistics as always). With ``train_backbone=True`` the
    tower records its graph instead (K3's backward on the card) and, given
    the step's ``generator``, applies its drop path (JAX's
    ``deterministic=not (train and train_backbone)``); a ``random_idx`` in
    the batch
    reorders the class-name embeddings and their validity; and
    ``compute_logits=True`` adds the ``lm_head`` logits (``"logits"``) for
    the conversation loss. ``remat`` checkpoints Phi's decoder layers and,
    unless ``remat_pixel`` says otherwise, the pixel decoder's encoder
    layers (the tower is not checkpointed, as in JAX).

With a ``mesh`` of model size m > 1 (``parallel/mesh.py``), ``lm_head`` is
tensor-parallel over the mesh's model group: its weight is column-parallel
(vocab_size / m rows here), the shards of the logits are gathered before
the bias, which stays whole, as in JAX's rules. Phi's decoder layers split
too when every linear is a float ``Dense`` (``models/phi.py``); with LoRA
or int8 / int4 linears they stay whole on every model rank, as JAX places
them. Load the slices of ``parallel.mesh.shard_state_dict``. Such a model
serves no chat: ``Generator`` refuses it (JAX serves on no mesh).

Parameter names are the released checkpoint's torch keys, so
``load_state_dict`` takes a released-format state dict directly, or the
output of ``psalm_tpu_torch.checkpoint.from_jax.jax_to_torch_state_dict``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from psalm_tpu_torch.config import PSALMConfig
from psalm_tpu_torch.data.constants import SRC_IMAGE, SRC_REGION, SRC_SEG_QUERY
from psalm_tpu_torch.models import layers
from psalm_tpu_torch.models.mask_decoder import MaskDecoder, Table
from psalm_tpu_torch.models.phi import PhiModel
from psalm_tpu_torch.models.pixel_decoder import (MSDeformAttnLayer,
                                                  MSDeformAttnPixelDecoder,
                                                  offset_bias_init)
from psalm_tpu_torch.models.projector import build_projector
from psalm_tpu_torch.models.swin import SwinTransformer, WindowAttention
from psalm_tpu_torch.ops.sampling import point_sample
from psalm_tpu_torch.parallel.tensor_parallel import copy_to_group, gather_last
from psalm_tpu_torch.spans import span, spanned

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


class PSALMBackbone(PhiModel):
    """Phi with the vision tower and projector beside it (``model.*``)."""

    def __init__(self, cfg: PSALMConfig, dtype=torch.float32, device=None,
                 use_flash: bool = False, remat: bool = False, mesh=None):
        super().__init__(cfg.phi, dtype=dtype, device=device,
                         use_flash=use_flash, remat=remat, mesh=mesh)
        self.vision_tower = SwinTransformer(cfg.swin, dtype=dtype, device=device)
        self.mm_projector = build_projector(cfg.projector, dtype=dtype,
                                            device=device)


class PSALM(nn.Module):
    """The whole model, built on ``device`` (the card unless the caller asks
    for another; ``"cuda"`` without a card raises, as torch does).
    ``use_flash`` sends Phi's full-sequence attention through kernel K5, as
    ``use_flash=True`` does in JAX (``bench.py`` builds the eval model so).
    ``mesh``: ``lm_head`` and (float linears only) Phi's decoder layers
    tensor-parallel over its model group."""

    def __init__(self, cfg: PSALMConfig, dtype=torch.float32, device="cuda",
                 use_flash: bool = False, remat: bool = False,
                 remat_pixel: Optional[bool] = None,
                 train_backbone: bool = False, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.train_backbone = train_backbone
        self.dtype = dtype
        c = cfg
        hd = c.mask_decoder.hidden_dim
        D = c.phi.hidden_size
        self.model = PSALMBackbone(cfg, dtype=dtype, device=device,
                                   use_flash=use_flash, remat=remat, mesh=mesh)
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        if self.mesh is not None and c.phi.vocab_size % mesh.model:
            raise ValueError(f"Phi's vocabulary of {c.phi.vocab_size} does "
                             f"not split into model {mesh.model}")
        if self.mesh is None:
            self.lm_head = layers.Dense(D, c.phi.vocab_size,
                                        bias=c.phi.lm_head_bias, dtype=dtype,
                                        device=device)
        else:
            self.lm_head = layers.Dense(D, c.phi.vocab_size // mesh.model,
                                        bias=False, dtype=dtype, device=device)
            if c.phi.lm_head_bias:
                self.lm_head.bias = nn.Parameter(torch.empty(
                    c.phi.vocab_size, device=device))
        self.seg_query = nn.Parameter(torch.empty(c.mask_decoder.num_queries, D,
                                                  device=device))
        self.pixel_decoder = MSDeformAttnPixelDecoder(
            c.pixel_decoder, dtype=dtype, device=device,
            remat=remat if remat_pixel is None else remat_pixel)
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
        with span("model.swin"):
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
        with span("model.projector"):
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

    @spanned("model.splice")
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

    @spanned("model")
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
        with span("model.phi"):
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

        with span("model.pixel_decoder"):
            mask_features, _, multi_scale = self.pixel_decoder(feats)
        with span("model.mask_decoder"):
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
        """``lm_head(hidden)``; under tensor parallelism the vocabulary
        shards gathered in rank order, then the bias."""
        if self.mesh is None:
            return self.lm_head(hidden)
        dt = self.dtype
        head = self.lm_head
        out = gather_last(F.linear(copy_to_group(hidden, self.mesh.model_group)
                                   .to(dt), head.weight.to(dt)), self.mesh)
        return out if head.bias is None else out + head.bias.to(dt)


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights from ``generator``, on each parameter's device, with
    the JAX package's init recipe: LeCun-normal linear and conv weights, zero
    biases (the dense pixel-decoder attention's four linears among them),
    unit norms, N(0, 1/D) token embeddings, N(0, 1) query and level tables,
    N(0, 0.02) relative position bias tables, zero seg queries, LoRA
    adapters A ~ N(0, 0.02) and B = 0, and for each deformable attention a
    zero ``sampling_offsets`` weight with the deformable-DETR bias
    (``offset_bias_init``) and a zero ``attention_weights`` layer."""

    def normal_(t, std):
        t.normal_(0.0, std, generator=generator)

    for mod in model.modules():
        if isinstance(mod, (layers.Dense, layers.Conv2d)):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight[0].numel()))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, layers.MultiheadAttention):
            normal_(mod.in_proj_weight, 1.0 / math.sqrt(mod.dim))
            mod.in_proj_bias.zero_()
        elif isinstance(mod, (layers.LayerNorm, layers.GroupNorm,
                              layers.BatchNorm2d)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, layers.BatchNorm2d):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0 / math.sqrt(mod.weight.shape[1]))
        elif isinstance(mod, Table):
            normal_(mod.weight, 1.0)
        elif isinstance(mod, WindowAttention):
            normal_(mod.relative_position_bias_table, 0.02)
        elif isinstance(mod, layers.LoRADense):
            mod.reset_adapters(generator)
    for mod in model.modules():  # after the generic pass above
        if isinstance(mod, MSDeformAttnLayer):
            mod.sampling_offsets.weight.zero_()
            bias = offset_bias_init(mod.n_heads, mod.n_levels, mod.n_points)
            mod.sampling_offsets.bias.copy_(torch.from_numpy(bias))
            mod.attention_weights.weight.zero_()
            mod.attention_weights.bias.zero_()
        elif isinstance(mod, MSDeformAttnPixelDecoder):
            normal_(mod.transformer.level_embed, 1.0)
        elif isinstance(mod, PSALM):
            mod.seg_query.zero_()
    return model
