"""Carry psalm_tpu weights across to the port.

``jax_to_torch_state_dict`` inverts
``psalm_tpu.checkpoint.convert.convert_psalm_checkpoint``: it turns the flax
variables ``{"params", "batch_stats"}`` back into the released checkpoint's
torch state dict, whose keys are the port's parameter names:

  flax Dense kernel [in, out]        -> torch Linear weight [out, in]
  flax Conv kernel [kH, kW, I, O]    -> torch Conv2d weight [O, I, kH, kW]
  split q/k/v Dense                  -> packed in_proj_weight / in_proj_bias
  batch_stats mean / var             -> running_mean / running_var

The pixel decoder's encoder layers carry whichever attention they hold: the
deformable one (``sampling_offsets``, ``attention_weights``, ``value_proj``,
``output_proj``) or, in ``attention_mode="dense"``, ``DenseSelfAttention``
(``q_proj``, ``k_proj``, ``value_proj``, ``output_proj``).

and the Phi linears quantized by ``psalm_tpu/models/quant.py``:

  kernel_q int8 [in, out] (QuantDense) -> int8 weight [out, in], transposed
                                          like a Dense kernel
  kernel_q4 int8 [in/2, out]           -> packed [in/2, out], the half-split
  (Quant4Dense, packed storage)           nibble bytes unchanged
  scale f32 ([out] or [in/g, out])     -> scale, unchanged

(``kernel_q4n``, JAX's native int4 storage, has no counterpart in the port.)

Host numpy only: the arrays may be jax arrays, read with ``np.asarray``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.asarray(x)


def _dense(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["kernel"]).T
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _conv(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _norm(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[prefix + ".weight"] = _a(p["scale"])
    sd[prefix + ".bias"] = _a(p["bias"])


def _bn(sd: StateDict, prefix: str, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    _norm(sd, prefix, p)
    sd[prefix + ".running_mean"] = _a(s["mean"])
    sd[prefix + ".running_var"] = _a(s["var"])


def _mha(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    sd[prefix + ".in_proj_weight"] = np.concatenate(
        [_a(p[n]["kernel"]).T for n in ("q_proj", "k_proj", "v_proj")], 0)
    sd[prefix + ".in_proj_bias"] = np.concatenate(
        [_a(p[n]["bias"]) for n in ("q_proj", "k_proj", "v_proj")], 0)
    _dense(sd, prefix + ".out_proj", p["out_proj"])


def _phi_linear(sd: StateDict, prefix: str, p: Dict[str, Any]) -> None:
    if "kernel_q" in p:
        sd[prefix + ".weight"] = _a(p["kernel_q"]).T
        sd[prefix + ".scale"] = _a(p["scale"])
    elif "kernel_q4" in p:
        sd[prefix + ".packed"] = _a(p["kernel_q4"])
        sd[prefix + ".scale"] = _a(p["scale"])
    elif "kernel_q4n" in p:
        raise NotImplementedError(f"{prefix}: native int4 storage is not ported")
    else:
        sd[prefix + ".weight"] = _a(p["kernel"]).T
    if "bias" in p:
        sd[prefix + ".bias"] = _a(p["bias"])


def _phi(sd: StateDict, p: Dict[str, Any], num_layers: int) -> None:
    sd["model.embed_tokens.weight"] = _a(p["embed_tokens"]["embedding"])
    _norm(sd, "model.final_layernorm", p["final_layernorm"])
    for i in range(num_layers):
        t, pre = p[f"layers_{i}"], f"model.layers.{i}"
        _norm(sd, f"{pre}.input_layernorm", t["input_layernorm"])
        for n in ("q_proj", "k_proj", "v_proj", "dense"):
            _phi_linear(sd, f"{pre}.self_attn.{n}", t["self_attn"][n])
        _phi_linear(sd, f"{pre}.mlp.fc1", t["fc1"])
        _phi_linear(sd, f"{pre}.mlp.fc2", t["fc2"])


def _swin(sd: StateDict, p: Dict[str, Any], depths) -> None:
    pre = "model.vision_tower"
    _conv(sd, f"{pre}.patch_embed.proj", p["patch_embed_proj"])
    _norm(sd, f"{pre}.patch_embed.norm", p["patch_embed_norm"])
    for i, depth in enumerate(depths):
        for j in range(depth):
            t, bp = p[f"layers_{i}_blocks_{j}"], f"{pre}.layers.{i}.blocks.{j}"
            _norm(sd, f"{bp}.norm1", t["norm1"])
            _norm(sd, f"{bp}.norm2", t["norm2"])
            _dense(sd, f"{bp}.attn.qkv", t["attn"]["qkv"])
            _dense(sd, f"{bp}.attn.proj", t["attn"]["proj"])
            sd[f"{bp}.attn.relative_position_bias_table"] = _a(
                t["attn"]["relative_position_bias_table"])
            _dense(sd, f"{bp}.mlp.fc1", t["mlp_fc1"])
            _dense(sd, f"{bp}.mlp.fc2", t["mlp_fc2"])
        if f"layers_{i}_downsample" in p:
            t = p[f"layers_{i}_downsample"]
            _norm(sd, f"{pre}.layers.{i}.downsample.norm", t["norm"])
            _dense(sd, f"{pre}.layers.{i}.downsample.reduction", t["reduction"])
        if f"norm{i}" in p:
            _norm(sd, f"{pre}.norm{i}", p[f"norm{i}"])


def _projector(sd: StateDict, p: Dict[str, Any], s: Dict[str, Any]) -> None:
    pre = "model.mm_projector.layer1.0"
    _conv(sd, f"{pre}.conv1", p["conv1"])
    _conv(sd, f"{pre}.conv2", p["conv2"])
    _conv(sd, f"{pre}.downsample.0", p["downsample_conv"])
    _bn(sd, f"{pre}.bn1", p["bn1"], s["bn1"])
    _bn(sd, f"{pre}.bn2", p["bn2"], s["bn2"])
    _bn(sd, f"{pre}.downsample.1", p["downsample_bn"], s["downsample_bn"])
    _dense(sd, "model.mm_projector.fc", p["fc"])


def _pixel_decoder(sd: StateDict, p: Dict[str, Any], enc_layers: int,
                   num_levels: int) -> None:
    pre = "pixel_decoder"
    sd[f"{pre}.transformer.level_embed"] = _a(p["level_embed"])
    _conv(sd, f"{pre}.mask_features", p["mask_features"])
    _conv(sd, f"{pre}.adapter_1.0", p["adapter_1_conv"])
    _norm(sd, f"{pre}.adapter_1.1", p["adapter_1_norm"])
    _conv(sd, f"{pre}.layer_1.0", p["layer_1_conv"])
    _norm(sd, f"{pre}.layer_1.1", p["layer_1_norm"])
    for i in range(num_levels):
        _conv(sd, f"{pre}.input_proj.{i}.0", p[f"input_proj_{i}_conv"])
        _norm(sd, f"{pre}.input_proj.{i}.1", p[f"input_proj_{i}_norm"])
    for i in range(enc_layers):
        t, lp = p[f"encoder_layer_{i}"], f"{pre}.transformer.encoder.layers.{i}"
        for n, dense in t["self_attn"].items():
            _dense(sd, f"{lp}.self_attn.{n}", dense)
        _norm(sd, f"{lp}.norm1", t["norm1"])
        _norm(sd, f"{lp}.norm2", t["norm2"])
        _dense(sd, f"{lp}.linear1", t["linear1"])
        _dense(sd, f"{lp}.linear2", t["linear2"])


def _predictor(sd: StateDict, p: Dict[str, Any], dec_layers: int) -> None:
    pre = "predictor"
    for n in ("query_embed", "query_feat", "SEG_query_embed", "level_embed"):
        sd[f"{pre}.{n}.weight"] = _a(p[n])
    _norm(sd, f"{pre}.decoder_norm", p["decoder_norm"])
    for n, depth in (("mask_embed", 3), ("SEG_proj", 2), ("CLASS_proj", 2),
                     ("REGION_proj", 2)):
        for j in range(depth):
            _dense(sd, f"{pre}.{n}.layers.{j}", p[n][f"layers_{j}"])
    for i in range(dec_layers):
        cp = f"{pre}.transformer_cross_attention_layers.{i}"
        _mha(sd, f"{cp}.multihead_attn", p[f"cross_{i}"]["multihead_attn"])
        _norm(sd, f"{cp}.norm", p[f"cross_{i}"]["norm"])
        sp = f"{pre}.transformer_self_attention_layers.{i}"
        _mha(sd, f"{sp}.self_attn", p[f"self_{i}"]["self_attn"])
        _norm(sd, f"{sp}.norm", p[f"self_{i}"]["norm"])
        fp = f"{pre}.transformer_ffn_layers.{i}"
        _dense(sd, f"{fp}.linear1", p[f"ffn_{i}"]["linear1"])
        _dense(sd, f"{fp}.linear2", p[f"ffn_{i}"]["linear2"])
        _norm(sd, f"{fp}.norm", p[f"ffn_{i}"]["norm"])


def jax_to_torch_state_dict(variables: Dict[str, Any], cfg) -> StateDict:
    """Flax variables of ``psalm_tpu.models.psalm.PSALM`` -> the released
    checkpoint's torch state dict (numpy arrays)."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    _phi(sd, p["phi"]["model"], cfg.phi.num_layers)
    _dense(sd, "lm_head", p["phi"]["lm_head"])
    _swin(sd, p["vision_tower"], cfg.swin.depths)
    _projector(sd, p["mm_projector"], s["mm_projector"])
    _pixel_decoder(sd, p["pixel_decoder"],
                   cfg.pixel_decoder.transformer_enc_layers,
                   cfg.pixel_decoder.num_feature_levels)
    _predictor(sd, p["predictor"], cfg.mask_decoder.dec_layers)
    sd["seg_query"] = _a(p["seg_query"])
    for n in ("seg_query_projector", "SEG_token_projector",
              "class_name_projector", "region_projector"):
        _dense(sd, n, p[n])
    return sd
