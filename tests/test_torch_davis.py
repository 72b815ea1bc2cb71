"""The port's DAVIS video CLI against psalm_tpu's (tiny config, f32, on the
CPU), on the tree of ``test_semantic_davis_clis.py`` (3 frames of 48x64, 2
objects) and on a non-square tree from ``chip_smoke.write_davis_tree`` (2
videos of 3 frames of 97x131, 3 objects with the sparse fills 1, 3, 4), with
one random state dict (JAX's through ``convert_psalm_checkpoint``, the
port's through ``from_jax``) and ``chip_smoke.WordTokenizer``.

Frame by frame: the batches the frame builders give the runners are equal
exactly (the region points drawn from one generator in the same order, the
visual-prompt frame, the prompt), each frame takes its prompts from the
memory exactly when JAX's does, every object picks the same query and
every PNG pixel is equal, under the tie rule of ``ROADMAP.md`` Queue 3: a
pick may differ only where JAX's ranked scores are within 1e-3, and a pixel
only where a picked mask's probability is within 1e-3 of 0.5 (JAX's model
outputs are captured inside its jitted runner). After a difference the rest
of that video is not compared (its memory may part).
"""

import argparse
import json
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from PIL import Image

from chip_smoke import WordTokenizer, write_davis_tree
from test_torch_eval_clis import (MARGIN, _Capture, _mask_decided, _record,
                                  _restored)
from test_torch_modules import load_port, parity_state_dict

from psalm_tpu.checkpoint.convert import convert_psalm_checkpoint
from psalm_tpu.config import SegTask as JSegTask
from psalm_tpu.config import tiny_test_config as jtiny_test_config
from psalm_tpu.data import coco_rle as jcoco_rle
from psalm_tpu.eval import eval_davis as jdavis
from psalm_tpu.eval import runner as jrunner
from psalm_tpu.models.psalm import PSALM as JPSALM
from psalm_tpu_torch.checkpoint.from_jax import jax_to_torch_state_dict
from psalm_tpu_torch.config import SegTask, tiny_test_config
from psalm_tpu_torch.eval import eval_davis as tdavis
from psalm_tpu_torch.eval import runner as trunner
from psalm_tpu_torch.models.psalm import PSALM

MAX_LENGTH = 512


@pytest.fixture(scope="module")
def weights():
    jcfg = jtiny_test_config()
    variables = jax.tree.map(jnp.asarray, convert_psalm_checkpoint(
        parity_state_dict(jcfg, seed=4), jcfg))
    return jcfg, variables, jax_to_torch_state_dict(variables, jcfg)


def _fixture_tree(tmp):
    """test_semantic_davis_clis.py's tree: video "bear", 3 frames, objects
    with fills 1 and 2 given by their first-frame RLEs."""
    rng = np.random.default_rng(1)
    vdir = tmp / "DAVIS" / "JPEGImages" / "480p" / "bear"
    vdir.mkdir(parents=True)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
                        ).save(vdir / f"{i:05d}.jpg")
    m1 = np.zeros((48, 64), np.uint8)
    m1[5:20, 5:25] = 1
    m2 = np.zeros((48, 64), np.uint8)
    m2[25:45, 30:60] = 1
    anns = []
    for fill, m in [(1, m1), (2, m2)]:
        rle = jcoco_rle.encode(m)
        anns.append({"category_id": fill, "segmentation": {
            "size": rle["size"], "counts": rle["counts"].decode("ascii")}})
    records = [{"image": f"JPEGImages/480p/bear/{i:05d}.jpg",
                "first_frame_image": "JPEGImages/480p/bear/00000.jpg",
                "first_frame_anns": anns} for i in range(3)]
    path = tmp / "trainval_val_psalm.json"
    path.write_text(json.dumps(records))
    return str(tmp / "DAVIS"), str(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    nonsquare = tmp_path_factory.mktemp("nonsquare")
    return {"fixture": _fixture_tree(tmp_path_factory.mktemp("fixture")),
            "nonsquare": write_davis_tree(np, str(nonsquare), 2, 3, (97, 131),
                                          3, seed=9, fills=(1, 3, 4))}


def _watch_builder(monkeypatch, cls, frames):
    """Keep every frame's batch, and whether its visual prompt is a frame
    the CLI segmented before (the memory) rather than the first frame read
    anew."""
    build = cls.build
    seen = []

    def watched(self, image, vp_image, vp_masks):
        batch, proc = build(self, image, vp_image, vp_masks)
        frames.append({"batch": {k: np.array(v) for k, v in batch.items()},
                       "memory": any(vp_image is im for im in seen)})
        seen.append(image)
        return batch, proc

    monkeypatch.setattr(cls, "build", watched)


def _run_both(weights, tree, tmp_path, monkeypatch, with_memory=True):
    jcfg, variables, sd = weights
    tok = WordTokenizer(jcfg.phi.vocab_size)
    root, jpath = tree
    runs = {}
    for side in ("jax", "port"):
        args = argparse.Namespace(
            model_path="", json_path=jpath, image_folder=root,
            output_dir=str(tmp_path / side), with_memory=with_memory,
            model_max_length=MAX_LENGTH, limit=0)
        frames, recs = [], []
        if side == "jax":
            _watch_builder(monkeypatch, jdavis.DavisFrameBuilder, frames)
            _record(monkeypatch, jrunner.EvalRunner, recs)
            cfg = jcfg.replace(seg_task=JSegTask.REGION)
            cap = _Capture(JPSALM(cfg))
            res = jdavis.evaluation(args, cfg=cfg, tokenizer=tok, model=cap,
                                    variables=variables)
            jax.effects_barrier()
            assert res is None and len(cap.outs) == len(recs)
            for r, o in zip(recs, cap.outs):
                r["model"] = o
        else:
            _watch_builder(monkeypatch, tdavis.DavisFrameBuilder, frames)
            _record(monkeypatch, trunner.EvalRunner, recs)
            cfg = tiny_test_config().replace(seg_task=SegTask.REGION)
            res = tdavis.evaluation(args, cfg=cfg, tokenizer=tok,
                                    model=load_port(PSALM(cfg, device="cpu"),
                                                    sd))
            assert res["memory"] == [f["memory"] for f in frames]
        runs[side] = (res, frames, recs, args.output_dir)
    return runs


def _picks(scores_qr, n):
    """The CLI's pick per object: the best of its top 10 queries that no
    earlier object took, and the margin of that choice (the smallest gap
    between neighbours among the ranked scores it looked at)."""
    scores = scores_qr.T
    taken, margins = [], []
    for r in range(n):
        order = np.argsort(-scores[r])[:10]
        taken.append(next((int(q) for q in order if int(q) not in taken),
                          int(order[0])))
        ranked = np.sort(scores[r])[::-1][:min(len(taken) + 1, 11)]
        margins.append(np.min(-np.diff(ranked)) if len(ranked) > 1 else np.inf)
    return taken, margins


def _read_png(path):
    img = Image.open(path)
    assert img.mode == "P" and bytes(img.getpalette()) == \
        tdavis.davis_palette()[:len(img.getpalette())]
    return np.asarray(img)


def _compare(runs, records):
    (_, jframes, jrecs, jdir), (tres, tframes, trecs, tdir) = \
        runs["jax"], runs["port"]
    assert len(jframes) == len(tframes) == len(jrecs) == len(trecs) == \
        len(records) == tres["frames"]
    parted, differ = set(), []
    for i, rec in enumerate(records):
        video = rec["image"].split("/")[-2]
        name = os.path.splitext(os.path.basename(rec["image"]))[0] + ".png"
        fills = {int(a["category_id"]) for a in rec["first_frame_anns"]}
        got = _read_png(os.path.join(tdir, video, name))
        want = _read_png(os.path.join(jdir, video, name))
        assert set(np.unique(got)) <= {0} | fills
        assert set(np.unique(want)) <= {0} | fills
        if video in parted:
            continue
        jb, tb = jframes[i]["batch"], tframes[i]["batch"]
        assert tframes[i]["memory"] == jframes[i]["memory"], i
        assert sorted(tb) == sorted(jb)
        for k in jb:  # the region points exactly, and the rest
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{i} {k}")
        n = len(fills)
        jpick, margins = _picks(jrecs[i]["out"]["region"]["scores"][0], n)
        tpick, _ = _picks(trecs[i]["out"]["region"]["scores"][0], n)
        if tpick != jpick:
            bad = [m for t, j, m in zip(tpick, jpick, margins) if t != j]
            assert max(bad) <= MARGIN, (i, tpick, jpick, margins)
            differ.append((i, "pick"))
            parted.add(video)
            continue
        mo = _restored(jrecs[i])
        decided = np.all([_mask_decided(mo[q]) for q in jpick], axis=0)
        diff = got != want
        assert not (diff & decided).any(), (i, int((diff & decided).sum()))
        if diff.any():
            differ.append((i, int(diff.sum())))
            parted.add(video)
    if differ:
        warnings.warn(f"DAVIS frames that differ at JAX-side ties: {differ}")
    return [f["memory"] for f in jframes]


@pytest.mark.parametrize("tree", ["fixture", "nonsquare"])
def test_davis_cli_matches_jax(weights, trees, tree, tmp_path, monkeypatch):
    runs = _run_both(weights, trees[tree], tmp_path, monkeypatch)
    with open(trees[tree][1]) as f:
        records = json.load(f)
    memory = _compare(runs, records)
    # the first frame of a video never takes the memory
    firsts = [i for i, r in enumerate(records)
              if r["image"] == r["first_frame_image"]]
    assert not any(memory[i] for i in firsts)
    assert sorted(os.listdir(runs["port"][3])) == \
        sorted(os.listdir(runs["jax"][3]))


def test_davis_without_memory_matches_jax(weights, trees, tmp_path,
                                          monkeypatch):
    runs = _run_both(weights, trees["nonsquare"], tmp_path, monkeypatch,
                     with_memory=False)
    with open(trees["nonsquare"][1]) as f:
        records = json.load(f)
    assert _compare(runs, records) == [False] * len(records)


def test_with_memory_flag_parses_as_a_boolean():
    """``--with_memory False`` is false in the port; JAX's ``type=bool``
    reads any non-empty string, "False" too, as true (ROADMAP Queue 3)."""
    base = ["--model_path", "m", "--json_path", "j", "--image_folder", "i",
            "--output_dir", "o"]
    assert tdavis.parse_args(base).with_memory is True
    for text, want in (("False", False), ("false", False), ("0", False),
                       ("True", True), ("1", True)):
        assert tdavis.parse_args(base + ["--with_memory", text]) \
            .with_memory is want
    with pytest.raises(SystemExit):
        tdavis.parse_args(base + ["--with_memory", "maybe"])


def test_sparse_fills_keep_their_palette_index(tmp_path):
    """An explicit palette keeps index 2 where fill 1 is absent (a bare
    P-mode save remapped it to 1), in both packages, with equal palettes
    and equal fused masks."""
    assert tdavis.davis_palette() == jdavis.davis_palette()
    sparse = np.zeros((8, 8), np.uint8)
    sparse[2:5, 2:5] = 2
    sparse[6:, 6:] = 4
    for mod in (tdavis, jdavis):
        mod.save_indexed_png(str(tmp_path / "sparse.png"), sparse)
        back = np.asarray(Image.open(tmp_path / "sparse.png"))
        np.testing.assert_array_equal(back, sparse)
    masks = [sparse == 2, sparse > 0]
    np.testing.assert_array_equal(
        tdavis.fuse_davis_mask(masks, [2, 7], (8, 8)),
        jdavis.fuse_davis_mask(masks, [2, 7], (8, 8)))
