"""Runtime validation of the window mode's exactness radius.

Counterpart of ``psalm_tpu/eval/instrument.py``. The window modes clamp each
sampling offset to +-radius target-level pixels around its query's reference
pixel (K1 with a radius); they are exact while the offsets stay inside. How
far a checkpoint's offsets reach is unknown beforehand, so this module
measures it: every ``MSDeformAttnLayer`` records ``offset_max`` (the largest
|offset|) and ``offset_clamp_frac`` (the share of samples the radius would
clamp) on a forward that asks for them
(``models/pixel_decoder.py::offset_stats``), and ``eval/runner.py``'s
``EvalRunner`` reads them on its first batch and every
``window_check_every`` batches after.

The offsets depend only on the image features, so the check's forward stops
after the pixel decoder's encoder, where JAX's runs the whole model; the
report is the same. The report's keys are JAX's layer names
(``encoder_layer_{i}``), so the two compare as dicts.

The offset head's init (zero weight, direction bias of at most n_points px,
the reference's ms_deform_attn.py:70-80) lies within radius 8 with 2x to
spare; trained checkpoints are what the check is for.
"""

from __future__ import annotations

from typing import Dict

import torch

from psalm_tpu_torch.models.pixel_decoder import MSDeformAttnLayer


@torch.no_grad()
def offset_clamp_report(model, batch, **apply_kwargs
                        ) -> Dict[str, Dict[str, float]]:
    """One instrumented forward of ``batch`` (tensors on the model's device:
    ``images`` is all it reads; JAX's apply arguments are taken and
    ignored); returns {encoder_layer_i: {offset_max, clamp_frac}} for every
    MSDeformAttn encoder layer (none in the dense mode), with one
    device-to-host copy."""
    layers = [layer.self_attn
              for layer in model.pixel_decoder.transformer.encoder.layers
              if isinstance(layer.self_attn, MSDeformAttnLayer)]
    if not layers:
        return {}
    for layer in layers:
        layer.record_offsets = True
    try:
        feats, _ = model.encode_images(batch["images"])
        model.pixel_decoder.encode(feats)
        stats = torch.stack([layer.offset_stats for layer in layers]).cpu()
    finally:
        for layer in layers:
            layer.record_offsets = False
            layer.offset_stats = None
    return {f"encoder_layer_{i}": {"offset_max": float(m),
                                   "clamp_frac": float(f)}
            for i, (m, f) in enumerate(stats.tolist())}


def summarize(report: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Aggregate a report to {max_offset_px, max_clamp_frac}."""
    if not report:
        return {"max_offset_px": 0.0, "max_clamp_frac": 0.0}
    return {
        "max_offset_px": max(e.get("offset_max", 0.0)
                             for e in report.values()),
        "max_clamp_frac": max(e.get("clamp_frac", 0.0)
                              for e in report.values()),
    }
