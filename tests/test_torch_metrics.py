"""The port's eval metrics and artifact writers against psalm_tpu's.

The metrics take the same predictions on both sides and must agree to
1e-12 (they are copies: in practice to the bit); the hand-computed cases of
``tests/test_metrics.py`` hold the port's copies on their own. The artifact
writers must write byte-equal files (both sides write PNGs with OpenCV and
JSON and pickles with the standard library), and the port's panoptic writer
feeds the official-GT scorer a perfect PQ, as ``tests/test_artifacts.py``
checks JAX's.
"""

import json
import os

import numpy as np
import pytest

from test_data_pipeline import _write_synthetic_coco

import psalm_tpu.eval.artifacts as jart
import psalm_tpu.eval.eval_grefcoco as jgref
import psalm_tpu.eval.metrics as jmet
import psalm_tpu_torch.eval.artifacts as tart
import psalm_tpu_torch.eval.eval_grefcoco as tgref
import psalm_tpu_torch.eval.metrics as tmet
from psalm_tpu_torch.data import coco_rle

TOL = 1e-12


def _close(got, want):
    """Nested dicts of numbers equal to TOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    else:
        assert abs(got - want) <= TOL, (got, want)


def _panoptic_case(rng, H=40, W=56, n_gt=6, n_pred=7, K=5):
    """An id map per side from random rectangles over a void background,
    gt with one crowd segment, predictions shifted copies with noise."""
    gt = np.zeros((H, W), np.int64)
    gt_segs = []
    for g in range(1, n_gt + 1):
        y, x = rng.integers(0, H - 8), rng.integers(0, W - 8)
        gt[y:y + rng.integers(4, 20), x:x + rng.integers(4, 24)] = g
        gt_segs.append({"id": g, "category_id": int(rng.integers(K)),
                        "iscrowd": int(g == n_gt)})
    pred = np.roll(gt, (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))),
                   (0, 1))
    noise = rng.uniform(size=(H, W)) < 0.05
    pred[noise] = rng.integers(0, n_pred + 1, noise.sum())
    pred_segs = [{"id": p, "category_id": int(rng.integers(K)) if p > n_gt - 2
                  else gt_segs[p - 1]["category_id"]}
                 for p in range(1, n_pred + 1)]
    return pred, pred_segs, gt, gt_segs


@pytest.mark.parametrize("seed", range(4))
def test_pq_equals_original(seed):
    rng = np.random.default_rng(seed)
    stats = [tmet.PQStat(), jmet.PQStat()]
    for _ in range(3):
        case = _panoptic_case(rng)
        for s in stats:
            s.update(*case)
    got, want = stats
    assert sorted(got.per_cat) == sorted(want.per_cat)
    for c in want.per_cat:
        g, w = got.per_cat[c], want.per_cat[c]
        assert (g.tp, g.fp, g.fn) == (w.tp, w.fp, w.fn)
        assert abs(g.iou - w.iou) <= TOL
    cats = {c: {"isthing": c % 2 == 0} for c in range(5)}
    _close(got.summarize(cats), want.summarize(cats))
    _close(got.summarize(), want.summarize())


@pytest.mark.parametrize("seed", range(4))
def test_instance_ap_and_iou_equal_original(seed):
    rng = np.random.default_rng(seed)
    K = 4
    evs = [tmet.InstanceAPEvaluator(range(K)), jmet.InstanceAPEvaluator(range(K))]
    for _ in range(3):
        gt = rng.uniform(size=(5, 24, 32)) > 0.6
        crowd = np.array([0, 0, 0, 0, 1], bool)
        pred = np.concatenate([gt[:3] ^ (rng.uniform(size=(3, 24, 32)) > 0.9),
                               rng.uniform(size=(4, 24, 32)) > 0.5])
        scores = rng.uniform(size=7)
        classes = rng.integers(0, K, 7)
        gcls = rng.integers(0, K, 5)
        classes[:3] = gcls[:3]
        for ev in evs:
            ev.add_image(pred, scores, classes, gt, gcls, crowd)
        for c in (None, crowd):
            np.testing.assert_allclose(tmet.mask_iou_matrix(pred, gt, c),
                                       jmet.mask_iou_matrix(pred, gt, c),
                                       rtol=0, atol=TOL)
    _close(evs[0].summarize(), evs[1].summarize())


@pytest.mark.parametrize("seed", range(3))
def test_iou_meters_equal_original(seed):
    rng = np.random.default_rng(seed)
    meters = [(tmet.IoUMeter(), tgref.GRefCOCOMeter(),
               tmet.SemSegMeter(6, 255)),
              (jmet.IoUMeter(), jgref.GRefCOCOMeter(),
               jmet.SemSegMeter(6, 255))]
    for i in range(4):
        pred = rng.uniform(size=(20, 30)) > 0.5
        gt = rng.uniform(size=(20, 30)) > 0.5 if i else np.zeros((20, 30), bool)
        sp = rng.integers(0, 6, (20, 30))
        sg = np.where(rng.uniform(size=(20, 30)) < 0.1, 255,
                      rng.integers(0, 6, (20, 30)))
        for iou, gref, sem in meters:
            iou.update(pred, gt)
            gref.update(pred & (i > 0), gt)
            sem.update(sp, sg)
    (ti, tg, ts), (ji, jg, js) = meters
    for got, want in ((ti.ciou, ji.ciou), (ti.giou, ji.giou),
                      (tg.ciou, jg.ciou), (tg.giou, jg.giou)):
        _close(got, want)
    _close(ts.summarize(), js.summarize())
    masks = [rng.uniform(size=(5, 6)) > 0.7 for _ in range(3)]
    np.testing.assert_array_equal(tgref.fuse_masks(masks),
                                  jgref.fuse_masks(masks))
    assert tgref.fuse_masks([]) is None and jgref.fuse_masks([]) is None


# -- the hand-computed cases of tests/test_metrics.py, on the port's copies --


def test_pq_hand_cases():
    gt = np.zeros((10, 10), np.int32)
    gt[:5] = 1
    gt[5:] = 2
    segs = [{"id": 1, "category_id": 0}, {"id": 2, "category_id": 1}]
    stat = tmet.PQStat()
    stat.update(gt, segs, gt, segs)
    assert abs(stat.summarize()["All"]["pq"] - 100.0) < 1e-6
    pred = np.zeros((10, 10), np.int32)
    pred[:5, :] = 1  # IoU = 0.5, not > 0.5: no match
    stat = tmet.PQStat()
    stat.update(pred, [{"id": 1, "category_id": 0}],
                np.ones((10, 10), np.int32), [{"id": 1, "category_id": 0}])
    s = stat.per_cat[0]
    assert s.tp == 0 and s.fp == 1 and s.fn == 1
    seg = np.ones((4, 4), np.int32)
    stat = tmet.PQStat()
    stat.update(seg, [{"id": 1, "category_id": 2}],
                seg, [{"id": 1, "category_id": 0}])
    assert stat.per_cat[0].fn == 1 and stat.per_cat[2].fp == 1


def test_ap_and_meter_hand_cases():
    rng = np.random.default_rng(0)
    ev = tmet.InstanceAPEvaluator([0, 1])
    for _ in range(3):
        masks = rng.uniform(size=(2, 16, 16)) > 0.5
        ev.add_image(masks, [0.9, 0.8], [0, 1], masks, [0, 1])
    out = ev.summarize()
    assert abs(out["AP"] - 100.0) < 1e-5 and abs(out["AP50"] - 100.0) < 1e-5
    gt = rng.uniform(size=(1, 16, 16)) > 0.5
    ev = tmet.InstanceAPEvaluator([0])
    ev.add_image(np.concatenate([~gt, gt]), [0.9, 0.8], [0, 0], gt, [0])
    assert 0 < ev.summarize()["AP"] < 100.0
    a = np.zeros((1, 4, 4), bool)
    a[0, :2] = True
    assert abs(tmet.mask_iou_matrix(a, np.ones((1, 4, 4), bool),
                                    iscrowd=np.array([1]))[0, 0] - 1.0) < 1e-6
    m = tmet.IoUMeter()
    p = np.zeros((4, 4), bool)
    p[:2] = True
    g = np.zeros((4, 4), bool)
    g[:, :2] = True
    m.update(p, g)
    m.update(g, g)
    assert abs(m.giou - 100 * (4 / 12 + 1) / 2) < 1e-6
    assert abs(m.ciou - 100 * (4 + 8) / (12 + 8)) < 1e-6
    sm = tmet.SemSegMeter(3)
    sm.update(np.array([[0, 1], [2, 2]]), np.array([[0, 1], [2, 255]]))
    assert abs(sm.summarize()["mIoU"] - 100.0) < 1e-6


# -- artifacts ----------------------------------------------------------------


def _write_all(art, out, rng_seed):
    """Every writer of one side, fed the same predictions."""
    rng = np.random.default_rng(rng_seed)
    pan = art.PanopticPredictionWriter(os.path.join(out, "pan"), {0: 1, 1: 7})
    inst = art.InstanceResultsWriter(os.path.join(out, "inst"), {0: 1, 1: 7})
    reg = art.RegionPredictionWriter(os.path.join(out, "reg"), "point")
    sem = art.SemSegPredictionWriter(os.path.join(out, "sem"))
    for i in range(2):
        pan_map = rng.integers(0, 4, (48, 64)).astype(np.int32)
        pan.add(i, f"{i:012d}.jpg", pan_map,
                [{"id": s, "category_id": s % 2, "isthing": s == 1}
                 for s in range(1, 4)])
        masks = rng.uniform(size=(3, 48, 64)) > 0.5
        inst.add(i, masks, rng.uniform(size=3).tolist(), [0, 1, 1])
        reg.add(f"{i}.jpg", list(masks[:2]), list(masks[1:]))
        sem.add(f"{i}.jpg", rng.integers(0, 5, (48, 64)))
    paths = [pan.finalize(), inst.finalize(), reg.finalize(), sem.finalize(),
             art.write_metric_txt(out, "referring", "benchmark: x: giou: 0.1")]
    paths += [os.path.join(out, "pan", f"{i:012d}.png") for i in range(2)]
    return [os.path.relpath(p, out) for p in paths]


def test_artifact_files_byte_equal(tmp_path):
    got = _write_all(tart, str(tmp_path / "port"), 5)
    want = _write_all(jart, str(tmp_path / "jax"), 5)
    assert got == want
    for rel in want:
        with open(tmp_path / "port" / rel, "rb") as f, \
                open(tmp_path / "jax" / rel, "rb") as g:
            assert f.read() == g.read(), rel


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    return _write_synthetic_coco(str(tmp_path_factory.mktemp("data")))


def test_panoptic_writer_roundtrip_perfect_pq(tmp_path, synthetic):
    """The GT fed back as predictions through the port's writer scores PQ
    100 against the official GT with the port's scorer, and the same
    PQStat as JAX's scorer on the same files."""
    import cv2
    root, _ = synthetic
    gt_json = os.path.join(root, "annotations/panoptic_val2017.json")
    gt_dir = os.path.join(root, "panoptic_val2017")
    with open(gt_json) as f:
        gt = json.load(f)
    d2c = {c["id"]: i for i, c in enumerate(gt["categories"])}
    writer = tart.PanopticPredictionWriter(
        str(tmp_path / "pred"), cont_id_to_dataset_id={v: k for k, v in
                                                       d2c.items()})
    for ann in gt["annotations"]:
        png = cv2.imread(os.path.join(gt_dir, ann["file_name"]))[..., ::-1]
        pan = coco_rle.rgb2id(png.astype(np.int64))
        segs = [{"id": s["id"], "category_id": d2c[s["category_id"]],
                 "isthing": True} for s in ann["segments_info"]]
        writer.add(ann["image_id"], ann["file_name"], pan, segs)
    writer.finalize()
    got, want = tmet.PQStat(), jmet.PQStat()
    tart.score_panoptic_against_official_gt(got, writer.output_dir, gt_json,
                                            gt_dir, d2c)
    jart.score_panoptic_against_official_gt(want, writer.output_dir, gt_json,
                                            gt_dir, d2c)
    assert got.summarize()["All"]["pq"] == pytest.approx(100.0)
    _close(got.summarize(), want.summarize())


def test_official_gt_scorer_names_a_missing_image(tmp_path, synthetic):
    """A prediction whose image has no GT annotation: the port's scorer
    raises a KeyError naming the GT json (JAX's raises a NameError there:
    its message names an undefined variable)."""
    root, _ = synthetic
    gt_json = os.path.join(root, "annotations/panoptic_val2017.json")
    writer = tart.PanopticPredictionWriter(str(tmp_path / "pred"))
    writer.add(99, "x.png", np.zeros((4, 4), np.int32), [])
    writer.finalize()
    with pytest.raises(KeyError, match="panoptic_val2017.json"):
        tart.score_panoptic_against_official_gt(
            tmet.PQStat(), writer.output_dir, gt_json,
            os.path.join(root, "panoptic_val2017"), {1: 0, 7: 1})
    with pytest.raises(NameError):
        jart.score_panoptic_against_official_gt(
            jmet.PQStat(), writer.output_dir, gt_json,
            os.path.join(root, "panoptic_val2017"), {1: 0, 7: 1})
