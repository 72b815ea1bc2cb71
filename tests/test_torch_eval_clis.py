"""The seven eval CLIs, psalm_tpu's and the port's, on the same synthetic
COCO tree (``test_data_pipeline._write_synthetic_coco``) and semantic list
(as ``test_semantic_davis_clis.py`` writes it), and on a tree of 97x131
images from ``chip_smoke.write_cli_tree``, with ``limit=2``,
``output_dir`` set, the flags of ``chip_smoke.CLIS``, its deterministic
``WordTokenizer`` on both sides and one random state dict (tiny config,
f32; the JAX side through ``convert_psalm_checkpoint``, the port's through
its loader).

Each CLI's per-image predictions are read back from both sides' artifact
files (and, for the maps no artifact holds, from the runners' results), and
every pixel and ranked item is compared. The tie rules of ``ROADMAP.md``
Queue 3 hold: a pixel or an item may differ only where the JAX side's
decision has a margin at or below 1e-3 (a mask probability that close to
0.5, a top-two gap of the panoptic or semantic scores, of a query choice or
of a ranked score that small). A panoptic query whose class or 0.8
threshold ties excludes only the pixels it wins or could win, and those of
the segments whose area it could change; segments are compared by identity
(a thing's query, a stuff segment's class), so that a shifted id is not a
difference. The JAX side's margins come from its model's outputs, captured
inside its jitted runner. The CLI's metrics agree to 1e-6, except the
groups that a differing decision feeds: the test warns with those, the CLI
and the count.
"""

import argparse
import copy
import importlib
import json
import os
import pickle
import warnings
from collections import Counter

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from chip_smoke import CLIS, WordTokenizer, write_cli_tree
from test_data_pipeline import _write_synthetic_coco
from test_torch_modules import load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import SegTask as JSegTask
from psalm_tpu.config import tiny_test_config as jtiny_test_config
from psalm_tpu.eval import runner as jrunner
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.config import SegTask, tiny_test_config
from psalm_tpu_torch.data import coco_rle
from psalm_tpu_torch.eval import geometry
from psalm_tpu_torch.eval import runner as trunner
from psalm_tpu_torch.models.psalm import PSALM
from psalm_tpu_torch.ops.sampling import resize_bilinear

MARGIN = 1e-3
METRIC_TOL = 1e-6
S = 64  # the tiny config's image size

CLI_FLAGS = {module: (task, flags) for module, task, flags in CLIS}
# the panoptic CLI's metric groups that each kind of decision feeds
PANOPTIC_FEEDS = {"panoptic_seg": ("panoptic", "panoptic_official_gt"),
                  "panoptic segments": ("panoptic", "panoptic_official_gt"),
                  "sem_seg": ("semantic",)}


@pytest.fixture(scope="module")
def weights():
    """The class head scaled by 3, so that on the nonsquare tree some
    queries pass the panoptic 0.8 threshold and the PNGs hold segments."""
    cfg = jtiny_test_config()
    sd = parity_state_dict(cfg, seed=3)
    for k in [k for k in sd if "CLASS_proj.layers.1." in k]:
        sd[k] = sd[k] * 3.0
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(sd, cfg))
    return cfg, variables, jax_to_torch_state_dict(variables, cfg)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The fixture tree, whose images are the padded frame's own width (the
    restore is the identity), and chip_smoke.py's tree at 97x131 (content
    47x64 in the 64^2 frame: every restore resamples)."""
    return {"fixture": _fixture_tree(tmp_path_factory.mktemp("fixture")),
            "nonsquare": _nonsquare_tree(tmp_path_factory.mktemp("nonsquare"))}


def _nonsquare_tree(tmp):
    return write_cli_tree(np, str(tmp), 2, (97, 131), n_thing=3, n_stuff=2,
                          segments=4, anns=2, sem_classes=4, seed=13)


def _fixture_tree(tmp):
    root, inst = _write_synthetic_coco(str(tmp))
    rng = np.random.default_rng(0)
    img_dir, lab_dir = tmp / "img", tmp / "lab"
    img_dir.mkdir()
    lab_dir.mkdir()
    lines = []
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
            img_dir / f"{i}.jpg")
        lab = np.zeros((48, 64), np.uint8)
        lab[:20] = 1
        lab[30:, :20] = 2
        lab[46:, 60:] = 255  # ignore region
        Image.fromarray(lab).save(lab_dir / f"{i}.png")
        lines.append(f"{i}.jpg {i}.png")
    (tmp / "list.txt").write_text("\n".join(lines))
    (tmp / "names.txt").write_text("road\nsky\ntree\n")
    return {"root": root, "instance_json": inst,
            "images": os.path.join(root, "val2017"),
            "sem_list": str(tmp / "list.txt"), "sem_images": str(img_dir),
            "sem_labels": str(lab_dir), "sem_names": str(tmp / "names.txt")}


class _Capture:
    """Stands in for JAX's PSALM in its runner: the same apply, and the
    model outputs of every image handed to the host from inside the jit."""

    def __init__(self, model):
        self.model = model
        self.outs = []

    def apply(self, variables, batch, **kw):
        out = self.model.apply(variables, batch, **kw)
        keep = {k: out[k] for k in ("pred_masks", "pred_class_name_logits",
                                    "pred_SEG_logits", "pred_region_logits")
                if out.get(k) is not None}
        jax.debug.callback(lambda o: self.outs.append(
            {k: np.asarray(v, np.float64) for k, v in o.items()}), keep)
        return out


def _record(monkeypatch, cls, store):
    """Keep every result of ``cls.infer`` with the geometry it used."""
    infer = cls.infer

    def recording(self, batch, *a, **kw):
        out = infer(self, batch, *a, **kw)
        store.append({"out": copy.deepcopy(out),
                      "content": np.asarray(batch["resized_hw"])[0],
                      "original": np.asarray(batch["original_hw"])[0],
                      "bucket": tuple(self.bucket_hw)})
        return out

    monkeypatch.setattr(cls, "infer", recording)


def _run_both(name, weights, trees, tmp_path, monkeypatch):
    task, flags = CLI_FLAGS[name]
    jcfg, variables, sd = weights
    tok = WordTokenizer(jcfg.phi.vocab_size)
    runs = {}
    for side in ("jax", "port"):
        args = argparse.Namespace(model_path="", model_max_length=512,
                                  seq_bucket=128, limit=2, **flags(trees))
        out_dir = str(tmp_path / side)
        if name != "cityscapes_instance":  # the one CLI without the flag
            args.output_dir = out_dir
        rec = []
        if side == "jax":
            _record(monkeypatch, jrunner.EvalRunner, rec)
            cfg = jcfg.replace(seg_task=JSegTask(task))
            cap = _Capture(JPSALM(cfg))
            res = importlib.import_module(f"psalm_tpu.eval.{name}").evaluation(
                args, cfg=cfg, tokenizer=tok, model=cap, variables=variables)
            jax.effects_barrier()
            assert len(cap.outs) == len(rec) == 2
            for r, o in zip(rec, cap.outs):
                r["model"] = o
        else:
            _record(monkeypatch, trunner.EvalRunner, rec)
            cfg = tiny_test_config().replace(seg_task=SegTask(task))
            model = load_port(PSALM(cfg, device="cpu"), sd)
            res = importlib.import_module(
                f"psalm_tpu_torch.eval.{name}").evaluation(
                    args, cfg=cfg, tokenizer=tok, model=model)
        res.pop("images_per_sec")
        runs[side] = (res, rec, out_dir)
    return runs


# -- the JAX side's decisions and their margins ------------------------------


def _sig(x):
    return 1.0 / (1.0 + np.exp(-x))


def _probs(logits):
    p = np.exp(logits - logits.max(-1, keepdims=True))
    return p / p.sum(-1, keepdims=True)


def _top2(x, axis):
    s = np.sort(x, axis=axis)
    return np.take(s, -1, axis) - np.take(s, -2, axis)


def _restored(rec):
    """JAX's mask logits [Q, H, W] on the original grid (float64)."""
    H, W = rec["original"]
    pm = torch.from_numpy(rec["model"]["pred_masks"][0].astype(np.float32))
    return geometry.crop_resize_to_original(
        pm, rec["content"], rec["original"], S, rec["bucket"])[
            :, :H, :W].numpy().astype(np.float64)


class _Tally:
    """Decisions that differ between the sides, all of them ties."""

    def __init__(self):
        self.differ = Counter()

    def pixels(self, got, want, decided, what):
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, (what, got.shape, want.shape)
        diff = got != want
        bad = int((diff & decided).sum())
        assert bad == 0, f"{what}: {bad} pixels with a JAX margin above " \
                         f"{MARGIN} differ"
        self.differ[what] += int(diff.sum())

    def choice(self, got, want, margin, what):
        """One discrete choice (a query, a class): equal unless tied."""
        if got != want:
            assert margin <= MARGIN, f"{what}: {got} != {want} at margin " \
                                     f"{margin}"
            self.differ[what] += 1
        return got == want


def _panoptic_decided(cl, mo):
    """The JAX side's panoptic decisions and their margins (as
    ``test_torch_slice._decided``): (pixel_ok [H, W], sem_ok [H, W],
    tied [Q]). A query ties where its class's top two or its 0.8 threshold
    do; pixel_ok holds where the per-pixel query argmax and every mask's 0.5
    threshold are decided and no tied query wins or could win (its score
    times its mask within 1e-3 of the winner's), and not in a segment whose
    area such a pixel could change (its 0.8 overlap test would move);
    sem_ok holds where the semantic argmax is decided."""
    K = cl.shape[-1]
    probs = _probs(cl)
    scores = probs.max(-1)
    tied = (_top2(probs, -1) <= MARGIN) | (np.abs(scores - 0.8) <= MARGIN)
    sig = _sig(mo)
    keep = (probs.argmax(-1) != K - 1) & (scores > 0.8)
    pm = np.where(keep[:, None, None], scores[:, None, None] * sig, -1.0)
    win = pm.argmax(0)
    # with no query kept every pixel is void whatever the masks
    pixel_ok = ((_top2(pm, 0) > MARGIN) | ~keep.any()) & \
        (np.abs(sig - 0.5) > MARGIN).all(0)
    reach = (scores[:, None, None] * sig >= pm.max(0) - MARGIN) & \
        tied[:, None, None]
    touched = tied[win] | reach.any(0)
    for q in np.unique(win[touched]):  # segments whose area may change
        touched |= win == q
    sem_ok = _top2(np.einsum("qc,qhw->chw", probs[:, :-1], sig), 0) > MARGIN
    return pixel_ok & ~touched, sem_ok, tied


def _segment_keys(pan, segments):
    """A panoptic map's segments by identity: a thing by its query, a stuff
    segment by Q + its class (the merged stuff's id and first query move
    when an earlier query's decision does), void -1."""
    ids, cats = segments["id"][0], segments["category"][0]
    Q = len(ids)
    keys = np.full(pan.shape, -1, np.int64)
    for q in np.flatnonzero(segments["valid"][0]):
        keys[pan == ids[q]] = q if segments["isthing"][0][q] else Q + cats[q]
    return keys


def _mask_decided(mo_q):
    return np.abs(_sig(mo_q) - 0.5) > MARGIN


def _png_ids(path):
    return coco_rle.rgb2id(cv2.imread(path)[..., ::-1].astype(np.int64))


def _compare_panoptic(runs, tally):
    (_, jrec, jdir), (_, trec, tdir) = runs["jax"], runs["port"]
    preds = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "panoptic_preds", "predictions.json")) as f:
            preds.append(json.load(f)["annotations"])
    for b, (j, t, ja, ta) in enumerate(zip(jrec, trec, *preds)):
        pixel_ok, sem_ok, tied = _panoptic_decided(
            j["model"]["pred_class_name_logits"][0], _restored(j))
        jpan = _png_ids(os.path.join(jdir, "panoptic_preds", ja["file_name"]))
        tpan = _png_ids(os.path.join(tdir, "panoptic_preds", ta["file_name"]))
        np.testing.assert_array_equal(jpan, j["out"]["panoptic_seg"][0])
        np.testing.assert_array_equal(tpan, t["out"]["panoptic_seg"][0])
        if not tied.any():
            assert ta == ja
        elif ta != ja:
            tally.differ["panoptic segments"] += 1
        tally.pixels(_segment_keys(tpan, t["out"]["segments"]),
                     _segment_keys(jpan, j["out"]["segments"]),
                     pixel_ok, "panoptic_seg")
        tally.pixels(t["out"]["sem_seg"][0], j["out"]["sem_seg"][0], sem_ok,
                     "sem_seg")


def _compare_semantic(runs, tally):
    (_, jrec, jdir), (_, trec, tdir) = runs["jax"], runs["port"]
    recs = []
    for d in (jdir, tdir):
        with open(os.path.join(d, "sem_seg_predictions.json")) as f:
            recs.append(json.load(f))
    names = list(dict.fromkeys(r["file_name"] for r in recs[0]))
    for j, t, name in zip(jrec, trec, names):
        H, W = j["original"]
        pm = torch.from_numpy(j["model"]["pred_masks"][0].astype(np.float32))
        up = resize_bilinear(pm[..., None], (S, S))[..., 0]
        sig = geometry.resize_to_original(torch.sigmoid(up), j["content"],
                                          j["original"], j["bucket"])[
                                              :, :H, :W].numpy()
        probs = _probs(j["model"]["pred_class_name_logits"][0])[:, :-1]
        decided = _top2(np.einsum("qk,qhw->khw", probs, sig), 0) > MARGIN
        maps = []
        for side_recs in recs:
            m = np.full((H, W), -1)
            for r in side_recs:
                if r["file_name"] == name:
                    m[coco_rle.decode(r["segmentation"]).astype(bool)] = \
                        r["category_id"]
            maps.append(m)
        np.testing.assert_array_equal(maps[0], j["out"]["sem_seg"][0])
        tally.pixels(maps[1], maps[0], decided, "sem_seg")


def _ranked_items(j, K):
    """JAX's instance items: (order of the flat class scores, query per
    rank, gap of each rank's score to its neighbours)."""
    flat = _probs(j["model"]["pred_class_name_logits"][0])[:, :-1].reshape(-1)
    order = np.argsort(-flat, kind="stable")
    ranked = flat[order]
    gap = np.full(len(ranked), np.inf)
    d = -np.diff(ranked)
    gap[:-1] = np.minimum(gap[:-1], d)
    gap[1:] = np.minimum(gap[1:], d)
    return order, order // (K - 1), gap


def _compare_instance(runs, tally, name):
    (_, jrec, jdir), (_, trec, tdir) = runs["jax"], runs["port"]
    items = None
    if name == "instance_segmentation":
        items = []
        for d in (jdir, tdir):
            with open(os.path.join(d, "coco_instances_results.json")) as f:
                items.append(json.load(f))
    for b, (j, t) in enumerate(zip(jrec, trec)):
        ji, ti = j["out"]["instances"], t["out"]["instances"]
        Q = len(ji["scores"][0])
        K = j["model"]["pred_class_name_logits"].shape[-1]
        _, query, gap = _ranked_items(j, K)
        mo = _restored(j)
        scale = max(np.abs(ji["scores"][0]).max(), 1e-6)
        if items is not None:  # the records hold the runners' items
            assert len(items[0]) == len(items[1]) == len(jrec) * Q
            for side, out in ((0, ji), (1, ti)):
                for r, rec in enumerate(items[side][b * Q:(b + 1) * Q]):
                    np.testing.assert_array_equal(
                        coco_rle.decode(rec["segmentation"]), out["masks"][0][r])
                    assert rec["score"] == float(out["scores"][0][r])
        for r in range(Q):
            same = (ti["classes"][0][r] == ji["classes"][0][r]
                    and np.array_equal(ti["masks"][0][r], ji["masks"][0][r]))
            if gap[r] <= MARGIN:  # a ranked tie: the items may swap
                tally.differ["tied instance items"] += int(not same)
                continue
            assert ti["classes"][0][r] == ji["classes"][0][r], (b, r)
            assert abs(ti["scores"][0][r] - ji["scores"][0][r]) <= \
                MARGIN * scale, (b, r)
            if items is not None:
                assert items[1][b * Q + r]["category_id"] == \
                    items[0][b * Q + r]["category_id"]
            tally.pixels(ti["masks"][0][r], ji["masks"][0][r],
                         _mask_decided(mo[query[r]]), "instance masks")


def _pkl_masks(d):
    (pkl,) = [f for f in os.listdir(d) if f.endswith(".pkl")]
    with open(os.path.join(d, pkl), "rb") as f:
        saved = pickle.load(f)
    return pkl, [[coco_rle.decode(m) for m in s["pred"]] for s in saved]


def _compare_referring(runs, tally, name):
    (_, jrec, jdir), (_, trec, tdir) = runs["jax"], runs["port"]
    (jpkl, jpreds), (tpkl, tpreds) = _pkl_masks(jdir), _pkl_masks(tdir)
    assert jpkl == tpkl
    for j, t, jp, tp in zip(jrec, trec, jpreds, tpreds):
        jr, tr = j["out"]["referring"], t["out"]["referring"]
        js, ts = jr["scores"][0], tr["scores"][0]
        jq, tq = jr["query"][0], tr["query"][0]
        top_j, top_t = int(np.argmax(js)), int(np.argmax(ts))
        mo = _restored(j)
        if name == "eval_grefcoco":
            over = js > 0.6
            want = (np.any(jr["masks"][0][over], axis=0) if over.any()
                    else jr["masks"][0][top_j])
            np.testing.assert_array_equal(jp[0], want)
            tied = (np.abs(js - 0.6) <= MARGIN).any() or (
                not over.any() and _top2(js, 0) <= MARGIN)
            if tied:
                tally.differ["gRefCOCO tied query sets"] += int(
                    not np.array_equal(tp[0], jp[0]))
                continue
            assert set(tq[ts > 0.6]) == set(jq[over])
            qs = jq[over] if over.any() else [jq[top_j]]
        else:
            np.testing.assert_array_equal(jp[0], jr["masks"][0][top_j])
            if not tally.choice(int(tq[top_t]), int(jq[top_j]),
                                _top2(js, 0), "referring top-1 query"):
                continue
            qs = [jq[top_j]]
        decided = np.all([_mask_decided(mo[q]) for q in qs], axis=0)
        tally.pixels(tp[0], jp[0], decided, f"{name} masks")


def _compare_region(runs, tally):
    (_, jrec, jdir), (_, trec, tdir) = runs["jax"], runs["port"]
    (_, jpreds), (_, tpreds) = _pkl_masks(jdir), _pkl_masks(tdir)
    for j, t, jp, tp in zip(jrec, trec, jpreds, tpreds):
        jr, tr = j["out"]["region"], t["out"]["region"]
        mo = _restored(j)
        assert len(jp) == len(tp) >= 1
        for r in range(len(jp)):
            top_j = int(np.argmax(jr["scores"][0][:, r]))
            top_t = int(np.argmax(tr["scores"][0][:, r]))
            np.testing.assert_array_equal(jp[r], jr["masks"][0][top_j])
            if tally.choice(top_t, top_j, _top2(jr["scores"][0][:, r], 0),
                            "region top-1 query"):
                tally.pixels(tp[r], jp[r], _mask_decided(mo[top_j]),
                             "region masks")


def _assert_metrics_close(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_metrics_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert abs(got - want) <= METRIC_TOL, (path, got, want)


@pytest.mark.parametrize("tree", ["fixture", "nonsquare"])
@pytest.mark.parametrize("name", sorted(CLI_FLAGS))
def test_cli_matches_jax(name, tree, weights, trees, tmp_path, monkeypatch):
    runs = _run_both(name, weights, trees[tree], tmp_path, monkeypatch)
    tally = _Tally()
    if name == "panoptic_segmentation":
        _compare_panoptic(runs, tally)
        assert "panoptic_official_gt" in runs["port"][0]
    elif name == "semantic_segmentation":
        _compare_semantic(runs, tally)
    elif name in ("instance_segmentation", "cityscapes_instance"):
        _compare_instance(runs, tally, name)
    elif name in ("referring_segmentation", "eval_grefcoco"):
        _compare_referring(runs, tally, name)
    else:
        _compare_region(runs, tally)
    got, want = runs["port"][0], runs["jax"][0]
    if name != "cityscapes_instance":
        port_files = sorted(os.listdir(runs["port"][2]))
        assert port_files == sorted(os.listdir(runs["jax"][2]))
    differ = {k: v for k, v in tally.differ.items() if v}
    fed = {g for k in differ for g in PANOPTIC_FEEDS.get(k, want)} \
        if name == "panoptic_segmentation" else set(want) if differ else set()
    if fed:
        warnings.warn(f"{name}: decisions that differ at JAX-side ties: "
                      f"{differ}; metrics not compared: {sorted(fed)}")
    assert sorted(got) == sorted(want)
    _assert_metrics_close({k: v for k, v in got.items() if k not in fed},
                          {k: v for k, v in want.items() if k not in fed})
