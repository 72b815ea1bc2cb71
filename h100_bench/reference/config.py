"""A frozen copy of the port's ``config.py``, without the language model.

Typed configuration tree of psalm_tpu_torch.

The port's own copy of ``psalm_tpu/config.py``: the same frozen dataclass
tree, field for field and default for default, so that one
``psalm_tpu_config.json`` describes a model in both packages
(``tests/test_torch_copies.py`` holds the two equal). Default values
reproduce the reference's active config chain
maskformer2_swin_base_384_bs16_50ep.yaml -> Base-COCO-InstanceSegmentation.yaml
-> maskformer2_R50_bs16_50ep.yaml. Some field comments describe the
JAX package's options; the port's support for each is stated where it is
read (``models/pixel_decoder.py``, ``models/quant.py``).

The language model's section is its kind's (``h100_bench/lm/<kind>.py``;
Phi-1.5's config class is in ``phi.py``): ``PSALMConfig`` holds the kind's
name (``language_model``) and its parsed config (``lm``) in place of the
port's Phi section.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Tuple

from h100_bench import lm as lm_kinds


class SegTask(str, enum.Enum):
    """Task switch reproducing the reference's SEG_TASK semantics.

    Drives which inference heads run, exactly as the switch block at
    psalm/model/language_model/llava_phi.py:268-301.
    """

    SEMANTIC = "semantic"
    INSTANCE = "instance"
    PANOPTIC = "panoptic"
    REFERRING = "referring"
    REGION = "region"

    @property
    def semantic_on(self) -> bool:
        return self in (SegTask.SEMANTIC, SegTask.PANOPTIC)

    @property
    def instance_on(self) -> bool:
        return self in (SegTask.INSTANCE, SegTask.PANOPTIC)

    @property
    def panoptic_on(self) -> bool:
        return self is SegTask.PANOPTIC

    @property
    def referring_on(self) -> bool:
        return self is SegTask.REFERRING

    @property
    def region_on(self) -> bool:
        return self is SegTask.REGION

    @property
    def postprocess_before_inference(self) -> bool:
        # llava_phi.py:301
        return self.instance_on or self.panoptic_on or self.referring_on or self.region_on


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Swin backbone config; defaults are Swin-B per build_swin_b
    (psalm/model/multimodal_encoder/swin_trans.py:660-678)."""

    patch_size: int = 4
    in_chans: int = 3
    embed_dim: int = 128
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (4, 8, 16, 32)
    window_size: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_norm: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    # drop path applies only in training; eval parity needs none.
    drop_path_rate: float = 0.3

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dim * 2 ** i) for i in range(len(self.depths)))


def swin_b() -> SwinConfig:
    return SwinConfig()


def swin_l() -> SwinConfig:
    # build_swin_l (swin_trans.py:700-719)
    return SwinConfig(embed_dim=192, num_heads=(6, 12, 24, 48))


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    """mm_projector config. PSALM default is the ``swin_conv`` ResNetSwin conv
    stack (multimodal_projector/builder.py:326-375,421-424): one stride-2
    BasicBlock 1024->2048 followed by a linear 2048->hidden_size.
    """

    projector_type: str = "swin_conv"
    input_dim: int = 1024  # res5 channels of Swin-B
    out_dim: int = 2048  # LLM hidden size


@dataclasses.dataclass(frozen=True)
class PixelDecoderConfig:
    """MSDeformAttn-FPN pixel decoder (msdeformattn.py:166-315).

    The deformable encoder runs over res3/res4/res5 with FFN dim 1024
    (hard-coded at llava_phi.py:516), then FPN-fuses up to res2 stride 4.
    """

    conv_dim: int = 256
    mask_dim: int = 256
    transformer_enc_layers: int = 6
    transformer_nheads: int = 8
    transformer_dim_feedforward: int = 1024
    num_feature_levels: int = 3  # res3, res4, res5
    enc_points: int = 4
    common_stride: int = 4
    # input channels of (res2, res3, res4, res5) — Swin-B
    in_channels: Tuple[int, ...] = (128, 256, 512, 1024)
    # "deformable" = reference-parity MSDeformAttn (XLA patch-gather; TPU
    # gathers are loop-bound, ~300 ns/index). "window" = the same deformable
    # math re-expressed as per-tile window MXU matmuls
    # (ops/msdeform_window.py): bit-matches "deformable" whenever sampling
    # offsets stay within ±window_radius pixels of the (static) reference
    # point, and keeps checkpoint compatibility; offsets beyond the radius
    # are clamped. "dense" = TPU-first alternative for training from
    # scratch: full flash attention over the concatenated multi-scale
    # tokens — NOT checkpoint-compatible. Measured on v5e (full pipeline
    # p50): deformable 260 ms; dense w/ 8 heads (head_dim 32) 716 ms
    # (MXU-starved); dense w/ 2 heads (head_dim 128) 206 ms. Use
    # transformer_nheads=2 with dense mode.
    attention_mode: str = "deformable"
    # offset clamp radius (target-level px), window mode. The zero-kernel
    # offset head's bias init has magnitude <= enc_points = 4
    # (ms_deform_attn.py:70-80), so 4 is exact at init (clamp at the
    # boundary is the identity); for trained checkpoints EvalRunner
    # measures the clamp rate on the first batch and RAISES the radius to
    # fit (eval/runner.py), so this is a fast default, not a correctness
    # bound. Window width w = (tile-1)*f + 2R + 3; the t1 = Ay @ win HBM
    # round-trip scales with w. Training overrides to 8 (train/train.py)
    # for offset-growth headroom — there is no runtime guard inside a
    # train step.
    window_radius: float = 4.0
    # Per-POINT clamp radii (overrides window_radius when non-empty; length
    # enc_points). The offset head's init bias magnitude is exactly (p+1) px
    # for point p (ms_deform_attn.py:66-74), so (2, 4, 6, 8) gives EVERY
    # point a 2x-init margin — the same safety policy flat r=8 applies only
    # to the largest point — while window width (t-1)f + 2r_p + 3 shrinks
    # for the first three points (~25% less stage-1 matmul work at 1024^2).
    # The EvalRunner clamp telemetry + auto-raise guards trained checkpoints
    # exactly as for the flat radius (raising falls back to a flat radius).
    window_point_radii: Tuple[float, ...] = ()
    window_tile: int = 16  # query tile side, window mode
    # heads processed per lax.map step inside the op; >1 cuts the
    # sequential (head-chunk x tile) loop count at the cost of a larger
    # live working set. h2 measured fastest forward (round-4 sweeps:
    # 9.96-10.22 ms/op vs 10.54-10.73 at h1, r8 encoder shapes); training
    # overrides to 1 — head chunking regresses the einsum backward
    # (train/train.py).
    window_head_chunk: int = 2
    # tile-scan unroll factor: the scan is overhead-bound (~5 us/step);
    # unrolling amortizes sequencing and pipelines the per-step slices
    window_scan_unroll: int = 1
    # True: tile-scan t1 contraction (eval-optimal fwd); False: one einsum
    # pair (train-optimal bwd). train/train.py flips this to False.
    window_scan_tiles: bool = True
    # True: 2-D sampling-matrix formulation (fold the P-point sum and
    # attention weights into one rank-P stencil per query, K = wh*ww MXU
    # contraction — see ops/msdeform_window.py::ms_deform_attn_window).
    window_fold_points: bool = False
    # True: manual-VJP tile-scan core (ops/msdeform_window.py
    # ::_group_sample_cvjp) — saves only the op inputs and keeps the big
    # t1/d_t1 intermediates per-tile in the backward. Training-path knob
    # (train/train.py); forward-only eval is unaffected by the VJP.
    window_custom_vjp: bool = False

    def __post_init__(self):
        # Fail at config-build time with a clear message — a length mismatch
        # otherwise surfaces as an opaque broadcast error at trace time
        # (ADVICE r4). The op requires one radius per sampling point.
        if self.window_point_radii and \
                len(self.window_point_radii) != self.enc_points:
            raise ValueError(
                f"window_point_radii must have exactly enc_points="
                f"{self.enc_points} entries, got "
                f"{len(self.window_point_radii)}: {self.window_point_radii}")
        if self.window_custom_vjp and self.window_fold_points:
            raise ValueError(
                "window_custom_vjp is incompatible with window_fold_points "
                "(the manual VJP covers the separable formulation only)")


@dataclasses.dataclass(frozen=True)
class MaskDecoderConfig:
    """Mask2Former-style transformer decoder config
    (maskformer2_R50_bs16_50ep.yaml + predictor_init at llava_phi.py:453-481).

    dec_layers here is the actual number of decoder layers = YAML DEC_LAYERS -
    1 = 9 (llava_phi.py:459). seg_concat=False: PSALM runs the woconcat path
    (llava_phi.py:466 -> mask2former_transformer_decoder.py:596).
    """

    hidden_dim: int = 256
    num_queries: int = 100
    nheads: int = 8
    dim_feedforward: int = 2048
    dec_layers: int = 9
    pre_norm: bool = False
    mask_dim: int = 256
    num_feature_levels: int = 3
    seg_norm: bool = False
    seg_concat: bool = False
    seg_proj: bool = True
    seg_fuse_score: bool = False


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Criterion hyperparameters (maskformer2_R50_bs16_50ep.yaml +
    PSALM_criterion at pretrain_criterion.py:128-141)."""

    class_weight: float = 2.0
    mask_weight: float = 5.0
    dice_weight: float = 5.0
    no_object_weight: float = 0.1
    train_num_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    deep_supervision: bool = True


@dataclasses.dataclass(frozen=True)
class PSALMConfig:
    """Top-level model config."""

    swin: SwinConfig = dataclasses.field(default_factory=SwinConfig)
    projector: ProjectorConfig = dataclasses.field(default_factory=ProjectorConfig)
    pixel_decoder: PixelDecoderConfig = dataclasses.field(default_factory=PixelDecoderConfig)
    mask_decoder: MaskDecoderConfig = dataclasses.field(default_factory=MaskDecoderConfig)
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    seg_task: SegTask = SegTask.PANOPTIC
    num_classes: int = 80  # SEM_SEG_HEAD.NUM_CLASSES
    image_size: int = 1024
    size_divisibility: int = 32
    # compute dtype for the hot path; params stay f32. Thresholded
    # quantities (decoder attn masks) are computed in f32 islands.
    compute_dtype: str = "bfloat16"
    # the language model: its kind (h100_bench/lm/<kind>.py) and the
    # kind's parse of its section
    language_model: str = lm_kinds.DEFAULT
    lm: Any = None

    def replace(self, **kw) -> "PSALMConfig":
        return dataclasses.replace(self, **kw)


#: the shared sections of a configuration file's ``"model"``
SECTIONS = {"swin": SwinConfig, "projector": ProjectorConfig,
            "pixel_decoder": PixelDecoderConfig,
            "mask_decoder": MaskDecoderConfig, "loss": LossConfig}


def section(cls, values: Dict[str, Any]):
    """``cls`` of a section's values: missing keys at their defaults, keys
    ``cls`` lacks dropped (so older files keep loading after fields are
    added), lists read as tuples."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in values.items() if k in names})


def config_from_model(model: Dict[str, Any], language_model: str
                      ) -> PSALMConfig:
    """The config of a configuration file's ``"model"``: the shared
    sections and fields here, the language model's section (its kind's
    ``SECTION``) by its kind's ``parse``. A key that neither reads
    raises."""
    kind = lm_kinds.module(language_model)
    kw = {"language_model": language_model,
          "lm": kind.parse(model.get(kind.SECTION, {}))}
    fields = {f.name for f in dataclasses.fields(PSALMConfig)} - set(kw)
    for key, val in model.items():
        if key == kind.SECTION:
            continue
        if key in SECTIONS:
            kw[key] = section(SECTIONS[key], val)
        elif key == "seg_task":
            kw[key] = SegTask(val)
        elif key in fields:
            kw[key] = val
        else:
            raise ValueError(
                f"the model's {key!r}: neither a shared section or field nor "
                f"the language model's ({language_model!r} reads "
                f"{kind.SECTION!r})")
    return PSALMConfig(**kw)


def tiny_test_config() -> PSALMConfig:
    """A miniature config for unit tests: same topology, tiny dims (the
    projector's output is the tiny language models' hidden size, 64; the
    language model is its kind's ``tiny()``)."""
    return PSALMConfig(
        swin=SwinConfig(embed_dim=16, depths=(1, 1, 2, 1), num_heads=(1, 2, 4, 8),
                        window_size=4),
        projector=ProjectorConfig(input_dim=128, out_dim=64),
        pixel_decoder=PixelDecoderConfig(conv_dim=32, mask_dim=32,
                                         transformer_enc_layers=2,
                                         transformer_nheads=4,
                                         transformer_dim_feedforward=64,
                                         in_channels=(16, 32, 64, 128)),
        mask_decoder=MaskDecoderConfig(hidden_dim=32, num_queries=10, nheads=4,
                                       dim_feedforward=64, dec_layers=3,
                                       mask_dim=32),
        loss=LossConfig(train_num_points=16),
        num_classes=5,
        image_size=64,
        compute_dtype="float32",
    )
