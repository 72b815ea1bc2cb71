"""Eval cells: ``EvalRunner.infer`` of the port in a closed loop of one
caller, over a pool of seeded batches cycled, results on the host.

Set-up: the model from the configuration, its weights drawn on the card
from the seed (``weights.py``), the runner, the pool (``gen/batches.py``),
two calls to warm every shape. Window (``--trace 0``): calls back to back
for ``--seconds``; the rate is the images over the window, from its start
to the end of its last call. Traced (``--trace 1``): ``trace_calls`` calls
under ``torch.profiler``, with the harness's spans around the op entries.
In both, a forward hook on the model keeps the outputs of the calls that
the seed samples for the check (``check_calls`` of the pool's first pass),
and ``infer`` returns their host results. After the window the program is
freed and the reference (``reference/``, f32) runs the same batches and the
same heads; ``compare`` gives the numbers held to ``limits/<cell>.json``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from typing import Any, Dict, List

import numpy as np
import torch

from h100_bench import weights
from h100_bench.gen import batches

# the batch keys the device never reads (the port's runner's _HOST_ONLY)
HOST_ONLY = {"dataset_type", "image_id", "num_class_names", "gt_masks",
             "gt_labels", "gt_valid", "file_name", "padding_mask",
             "resized_hw", "original_hw", "labels", "length"}

OUTPUT_KEYS = ("hidden", "pred_masks", "pred_class_name_logits",
               "pred_SEG_logits")
#: the mask decoder's first prediction (level 0, before its masked
#: attention), kept under these names
LEVEL0_KEYS = {"pred_masks": "masks0", "pred_class_name_logits": "class0",
               "pred_SEG_logits": "seg0"}


def kept_outputs(out) -> Dict[str, torch.Tensor]:
    """The model outputs the check compares: ``OUTPUT_KEYS`` and the mask
    decoder's level-0 prediction (``LEVEL0_KEYS``)."""
    kept = {k: out[k] for k in OUTPUT_KEYS if out.get(k) is not None}
    level0 = out["aux_outputs"][0]
    kept.update({name: level0[k] for k, name in LEVEL0_KEYS.items()
                 if level0.get(k) is not None})
    return kept


def is_thing(mix) -> List[bool]:
    """The categories' thing flags: the first ``things`` of the
    ``class_names - 1`` categories (the last name is the background)."""
    n = mix["class_names"] - 1
    return [i < mix["things"] for i in range(n)]


def program_config(config, task: str):
    """The port's PSALMConfig of a configuration file, for ``task``."""
    from psalm_tpu_torch.config import SegTask, config_from_json
    cfg = config_from_json(json.dumps(config["model"]))
    return cfg.replace(seg_task=SegTask(task))


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


#: the semantic scores are kept at every SEM_STRIDE-th row and column
SEM_STRIDE = 4


class Capture:
    """Keeps, while ``on``, the model's outputs (a forward hook) and the
    semantic head's restored scores of each image (``wrap_semantic``)."""

    def __init__(self):
        self.on = False
        self.kept = None
        self.sem = []

    def __call__(self, module, args, out):
        if self.on:
            self.kept = {k: v.detach().clone()
                         for k, v in kept_outputs(out).items()}

    def wrap_semantic(self, spans) -> None:
        """The port's ``postprocess.semantic_inference`` (the class mix of
        the masks restored to the bucket grid, [K - 1, H, W]), its output
        kept on a grid of every ``SEM_STRIDE``-th pixel while ``on``."""
        from psalm_tpu_torch.eval import postprocess
        original = postprocess.semantic_inference

        def kept(class_logits, mask_logits):
            out = original(class_logits, mask_logits)
            if self.on:
                self.sem.append(out[:, ::SEM_STRIDE, ::SEM_STRIDE].clone())
            return out
        spans.replace(postprocess, "semantic_inference", kept)


def build_program(config, mix, seed: int, device):
    """(runner, model) of the port with the seed's weights."""
    from psalm_tpu_torch.eval.runner import EvalRunner
    from psalm_tpu_torch.models.psalm import PSALM
    cfg = program_config(config, mix["task"])
    dtype = dtype_of(config["params_dtype"])
    model = PSALM(cfg, dtype=dtype_of(cfg.compute_dtype), device=device,
                  use_flash=config["use_flash"]).to(dtype)
    spec, meta = weights.weight_spec(config)
    weights.fill(model, spec, seed, dtype, reference=meta)
    kw = {}
    if mix["task"] == "panoptic":
        kw = dict(num_class_names=mix["class_names"], is_thing=is_thing(mix))
    runner = EvalRunner(model, cfg, bucket_hw=tuple(mix["bucket_hw"]),
                        window_clamp_threshold=None, **kw)
    return runner, model


def install_spans(spans) -> None:
    """The harness's spans around the op entries the eval path calls."""
    from psalm_tpu_torch.models import phi, swin
    from psalm_tpu_torch.ops import msdeform

    from h100_bench.counts import ops
    # the pixel decoder calls msdeform.ms_deform_attn through the module;
    # Swin and Phi imported their entries by name
    spans.wrap(msdeform, "ms_deform_attn", "msdeform", ops.msdeform_fwd_bound)
    spans.wrap(swin, "window_attention", "swin_attn",
               ops.window_attention_bound)
    spans.wrap(phi, "flash_attention", "flash", ops.flash_attention_bound)


def check_calls(mix, seed: int) -> List[int]:
    """The calls whose outputs are checked: ``check_calls`` of the first
    calls of the pool's first pass (as many as a traced window makes too),
    drawn from the seed."""
    r = batches.rng(seed, "eval", 9)
    first = min(mix["pool_batches"], mix["trace_calls"])
    n = min(mix["check_calls"], first)
    return sorted(int(i) for i in r.choice(first, n, replace=False))


def run(ctx) -> Dict[str, Any]:
    from h100_bench.common import Spans, Trace, profile_window, read_metrics
    from h100_bench.counts.ops import peaks
    mix, config, seed = ctx.mix, ctx.config, ctx.seed
    device = torch.device("cuda", 0) if ctx.device is None else ctx.device
    runner, model = build_program(config, mix, seed, device)
    S = runner.cfg.image_size
    nq = runner.cfg.mask_decoder.num_queries
    pool = [batches.eval_batch(mix, S, nq, seed, i)
            for i in range(mix["pool_batches"])]
    capture = Capture()
    hook = model.register_forward_hook(capture)
    spans = Spans(peaks())
    capture.wrap_semantic(spans)
    for i in range(mix["warmup_calls"]):
        runner.infer(pool[i % len(pool)])
    ctx.sync()
    wanted = set(check_calls(mix, seed))
    kept: Dict[int, Any] = {}
    if ctx.trace:
        install_spans(spans)
        spans.recording = True
    ctx.mark_setup_done()

    def call(n: int):
        capture.on = n in wanted
        result = runner.infer(pool[n % len(pool)])
        if capture.on:
            kept[n] = (result, {**capture.kept, "sem_scores": capture.sem})
            capture.on, capture.kept, capture.sem = False, None, []

    B = mix["batch"]
    calls = 0
    if ctx.trace:
        with profile_window() as prof:
            t0 = time.perf_counter()
            for calls in range(mix["trace_calls"]):
                call(calls)
            ctx.sync()
            window = time.perf_counter() - t0
        calls = mix["trace_calls"]
    else:
        t0 = time.perf_counter()
        ends = []
        while True:
            call(calls)
            calls += 1
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= ctx.seconds:
                break
        window = ends[-1]
        steps = np.diff([0.0] + ends)
        print("call s: first %.4f median %.4f p90 %.4f max %.4f; thirds %s"
              % (steps[0], np.median(steps), np.percentile(steps, 90),
                 steps.max(), [round(float(np.mean(p)), 4) for p in
                               np.array_split(steps, 3)]), file=sys.stderr)
    ctx.window_closed()
    spans.recording = False
    spans.remove()
    hook.remove()
    images = calls * B
    out: Dict[str, Any] = {"attempted": images, "window_s": window,
                           "memory_peak_bytes": ctx.memory_peak()}
    if ctx.trace:
        trace = Trace(prof, window, {"images": images,
                                     "flops": ctx.counts["flops"] * images},
                      spans.totals)
        out["per_layer"] = read_metrics(ctx.per_layer_names, trace)
        out["busy_s"], out["breakdown"] = trace.busy_s, trace.breakdown()
        del prof, trace
    else:
        out["end_to_end"] = {"eval_img_per_s": images / window}
    del runner, model, capture
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["detail"] = {}
    out["checks"] = check(config, mix, seed, pool, kept, device, ctx.limits,
                          detail=out["detail"])
    out["check_s"] = time.perf_counter() - t0
    out["failed"] = 0
    return out


# ---------------------------------------------------------------------------
# the check against the reference


def reference_outputs(config, mix, seed: int, batch, device,
                      lower=None) -> Dict[str, torch.Tensor]:
    """The reference's model outputs on ``batch``, in blocks of
    ``check_block`` rows, in f32 with TF32 off (``lower``: the control's
    float8 type, ``reference/layers.py``)."""
    from h100_bench.counts.derive import task_flags
    from h100_bench.reference import layers
    model = _reference_model(config, seed, device)
    flags = task_flags(mix)
    staged = {k: torch.as_tensor(np.asarray(v)).to(device)
              for k, v in batch.items() if k not in HOST_ONLY}
    n = staged["tok_ids"].shape[0]
    step = mix["check_block"]
    parts = []
    layers.LOWER = lower
    try:
        with torch.no_grad():
            for r0 in range(0, n, step):
                rows = {k: v[r0:r0 + step] for k, v in staged.items()}
                parts.append(kept_outputs(model(rows, **flags)))
    finally:
        layers.LOWER = None
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


_REF = {}


def _reference_model(config, seed: int, device):
    """The reference PSALM with the seed's weights (drawn in the
    configuration's parameter type, held in f32), built once a run."""
    key = (json.dumps(config, sort_keys=True), seed, str(device))
    if key not in _REF:
        _REF.clear()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        spec, meta = weights.weight_spec(config)
        cfg = weights.reference_config(config)
        model = weights.reference_model(cfg, device)
        weights.fill(model, spec, seed, dtype_of(config["params_dtype"]),
                     reference=meta)
        _REF[key] = model.eval()
    return _REF[key]


def free_reference() -> None:
    _REF.clear()
    gc.collect()
    torch.cuda.empty_cache()


def reference_heads(config, mix, outputs, batch):
    from h100_bench.reference import heads
    cfg = weights.reference_config(config)
    content = np.asarray(batch["resized_hw"]).reshape(-1, 2)
    original = np.asarray(batch["original_hw"]).reshape(-1, 2)
    bucket = tuple(mix["bucket_hw"])
    if mix["task"] == "panoptic":
        return heads.panoptic(outputs, content, original, cfg.image_size,
                              bucket, is_thing(mix))
    return heads.referring(outputs, content, original, cfg.image_size, bucket)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| over the whole tensor (2-norms, f32)."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


def class_distance(got: torch.Tensor, want: torch.Tensor) -> float:
    """Mean over the queries of half the L1 distance between two [Q, K]
    logits' softmax over the classes."""
    got, want = torch.softmax(got.float(), -1), torch.softmax(want.float(), -1)
    return float(0.5 * (got - want).abs().sum(-1).mean())


def median(values: List[float]) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def compare(mix, prog_out, prog_result, ref_out, ref_heads, valid
            ) -> Dict[str, List[float]]:
    """The numbers of one checked call, one an image. ``hidden_err`` and
    ``mask_err``: the relative error of Phi's last hidden state at the
    sequence's ``valid`` [B, L] positions (the tower, the projector, the
    splice and Phi; a padded position's state is read by nothing) and of
    the mask logits (the pixel decoder and the mask decoder); ``mask0_err``
    that of the mask decoder's level-0 masks (the pixel decoder and the
    mask head, before the masked attention). Panoptic: ``class_prob_err``
    (``class0_prob_err`` at level 0), the mean over the queries of half the
    L1 distance between the program's and the reference's softmax over the
    class names; ``sem_err``, the relative error of the semantic head's
    scores (the class mix of the masks restored to the original grid) on
    every ``SEM_STRIDE``-th row and column. Referring: ``mask_disagree``,
    the share of the pixels of every query's restored mask that differ.
    The class (or [SEG]) logits' relative error ``class_err`` is printed,
    not compared. (The panoptic map is not compared: at the seed's random
    weights no query passes the head's 0.8 keep threshold, so both maps are
    void; the [SEG] sigmoids saturate to 0 or 1 on both sides;
    ``PERF.md``.)"""
    cls_key = ("pred_class_name_logits" if mix["task"] == "panoptic"
               else "pred_SEG_logits")
    B = ref_out["pred_masks"].shape[0]
    valid = torch.as_tensor(np.asarray(valid, bool))
    nums = {"hidden_err": [rel_err(prog_out["hidden"][b][valid[b]],
                                   ref_out["hidden"][b][valid[b]])
                           for b in range(B)]}
    nums.update({k: [rel_err(prog_out[key][b], ref_out[key][b])
                     for b in range(B)]
                 for k, key in (("mask_err", "pred_masks"),
                                ("mask0_err", "masks0"),
                                ("class_err", cls_key))})
    if mix["task"] == "panoptic":
        for k, key in (("class_prob_err", cls_key), ("class0_prob_err",
                                                     "class0")):
            nums[k] = [class_distance(prog_out[key][b], ref_out[key][b])
                       for b in range(B)]
        nums["sem_err"] = [
            rel_err(prog_out["sem_scores"][b], ref_heads[b]["sem_scores"]
                    [:, ::SEM_STRIDE, ::SEM_STRIDE]) for b in range(B)]
    else:
        nums["mask_disagree"] = []
        got = prog_result["referring"]
        for b in range(B):
            want = ref_heads[b]
            query = torch.as_tensor(np.asarray(got["query"][b])).long()
            masks = torch.as_tensor(np.asarray(got["masks"][b]))
            want_masks = want["masks"][query.to(want["masks"].device)].cpu()
            nums["mask_disagree"].append(float((masks != want_masks).float()
                                               .mean()))
    return nums


#: how each number is taken over the checked images: the worst image, or
#: the median where single images swing (``check``); the final mask and
#: class logits' relative errors (``mask_err``, ``class_err``) are printed
#: only: the final masks are judged through the semantic head's scores,
#: whose worst image the control separates from the program's (``PERF.md``)
AT = {"hidden_err": "worst", "mask0_err": "worst", "class0_prob_err": "worst",
      "sem_err": "worst", "mask_disagree": "worst",
      "class_prob_err": "median"}


def at(values: List[float], how: str) -> float:
    return max(values) if how == "worst" else median(values)


def check(config, mix, seed, pool, kept, device, limits, lower=None,
          detail=None) -> List[Any]:
    """[(name, value, limit)]: each number over the images of the checked
    calls as ``AT`` takes it (the name ends in ``_worst`` or ``_median``),
    against the cell's limit; the median and worst images are printed on
    stderr, and ``detail`` (a dict, where given) gets every image's. The
    mask decoder's masked attention blocks a pixel where a mask logit is
    under 0, so round-off that moves a logit across 0 moves that image's
    later decoder layers by far more than round-off: the final class
    softmax is held at the median image, and everything else at the worst:
    the tower, the projector, the splice and Phi (the hidden state), the
    pixel decoder and the heads before the masked attention (level 0), and
    the final masks and classes through the semantic head's scores
    (``PERF.md``). A checked call that did not happen counts in
    ``missing_calls``."""
    per_image: Dict[str, List[float]] = {}
    missing = [n for n in check_calls(mix, seed) if n not in kept]
    for n, (result, prog_out) in sorted(kept.items()):
        batch = pool[n % len(pool)]
        ref_out = reference_outputs(config, mix, seed, batch, device, lower)
        ref_heads = reference_heads(config, mix, ref_out, batch)
        for k, v in compare(mix, prog_out, result, ref_out, ref_heads,
                            batch["attention_mask"]).items():
            per_image.setdefault(k, []).extend(v)
        del ref_out, ref_heads
    free_reference()
    if detail is not None:
        detail.update(per_image)
    checks = []
    for k, values in per_image.items():
        print(f"{k}: median image {median(values)!r}, worst image "
              f"{max(values)!r}", file=sys.stderr)
        if k in AT:
            checks.append((f"{k}_{AT[k]}", at(values, AT[k]),
                           float(limits.get(f"{k}_{AT[k]}", 0.0))))
    checks.append(("missing_calls", float(len(missing)), 0.0))
    return checks
