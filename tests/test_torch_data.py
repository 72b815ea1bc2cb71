"""The port's data layer against psalm_tpu's: the RLE codec and its native
library, the conversation template, the tokenization helpers, the mappers
and the six dataset classes, on the same inputs.

Every comparison is exact: the same bytes, ids, labels, masks, points and
images. Both sides call the same host libraries (PIL for images, OpenCV for
``dilate``, ``fillPoly`` and the restores), which the card's machine has as
well, so the port keeps no replacement of its own.
"""

import json
import os
import random

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays
from PIL import Image

from test_data_pipeline import StubTokenizer, _cfg, _write_synthetic_coco

import psalm_tpu.data.coco_rle as jrle
import psalm_tpu.data.conversation as jconv
import psalm_tpu.data.datasets as jdatasets
import psalm_tpu.data.mappers as jmappers
import psalm_tpu.data.tokenization as jtok
import psalm_tpu.native as jnative
import psalm_tpu_torch.data.coco_rle as trle
import psalm_tpu_torch.data.conversation as tconv
import psalm_tpu_torch.data.datasets as tdatasets
import psalm_tpu_torch.data.mappers as tmappers
import psalm_tpu_torch.data.tokenization as ttok
import psalm_tpu_torch.native as tnative


def _masks(draw_shape=st.tuples(st.integers(1, 40), st.integers(1, 40))):
    return draw_shape.flatmap(lambda s: arrays(np.uint8, s,
                                               elements=st.integers(0, 1)))


# -- RLE ----------------------------------------------------------------------


@settings(max_examples=60, deadline=None)
@given(_masks())
def test_rle_codecs_agree(mask):
    """The port's native codec, JAX's (native or numpy, whichever it ran)
    and both numpy codecs give the same bytes, and decode to the mask."""
    want = jrle.encode(mask)
    got = trle.encode(mask)
    assert got == want
    slow = trle.encode_uncompressed(mask)
    assert slow == jrle.encode_uncompressed(mask)
    assert trle._leb_encode(slow["counts"]) == got["counts"] \
        == jrle._leb_encode(slow["counts"])
    assert trle._leb_decode(got["counts"]) == jrle._leb_decode(got["counts"]) \
        == slow["counts"]
    for rle in (got, dict(got, counts=got["counts"].decode()), slow):
        np.testing.assert_array_equal(trle.decode(rle), mask)
        np.testing.assert_array_equal(trle.decode(rle), jrle.decode(rle))
    np.testing.assert_array_equal(trle.decode_uncompressed(slow), mask)
    assert trle.area(got) == jrle.area(got) == int(mask.sum())
    assert trle.iou(got, got) == jrle.iou(got, got)


def test_native_libraries_agree():
    """The port's librle against JAX's librle, both numpy codecs and the
    matrix product form of the IoU (crowd columns by IoA), on seeded masks
    (the analog of test_data_pipeline.py's native case)."""
    assert jnative.get_lib() is not None
    rng = np.random.default_rng(3)
    for shape in [(37, 23), (64, 64), (5, 1), (480, 640)]:
        mask = (rng.uniform(size=shape) > 0.5).astype(np.uint8)
        got, want = tnative.encode(mask), jnative.encode(mask)
        assert got == want
        assert got["counts"] == trle._leb_encode(
            trle.encode_uncompressed(mask)["counts"])
        np.testing.assert_array_equal(tnative.decode(got), mask)
        np.testing.assert_array_equal(tnative.decode(want), jnative.decode(got))
    a = rng.uniform(size=(3, 16, 16)) > 0.5
    b = rng.uniform(size=(2, 16, 16)) > 0.5
    crowd = np.array([0, 1], np.uint8)
    got = tnative.mask_iou_matrix(a.astype(np.uint8), b.astype(np.uint8), crowd)
    want = jnative.mask_iou_matrix(a.astype(np.uint8), b.astype(np.uint8), crowd)
    np.testing.assert_array_equal(got, want)
    pa = a.reshape(3, -1).astype(np.float64)
    ga = b.reshape(2, -1).astype(np.float64)
    inter = pa @ ga.T
    union = pa.sum(1)[:, None] + ga.sum(1)[None, :] - inter
    union[:, 1] = pa.sum(1)
    np.testing.assert_allclose(got, inter / union, rtol=1e-12)
    assert tnative.mask_iou_matrix(a[:0], b).shape == (0, 2)


def test_native_library_is_built_from_the_port_source():
    path = tnative.library_path()
    assert tnative.build() == path and path.exists()
    assert path.parent.name == "psalm_tpu_torch"
    with pytest.raises(ValueError, match="corrupt RLE"):
        trle.decode({"size": [48, 64], "counts": "!!!corrupt"})


@pytest.mark.parametrize("seed", range(4))
def test_polygons_rgb_ids_agree(seed):
    rng = np.random.default_rng(seed)
    polys = [rng.uniform(0, 60, 2 * n).tolist() for n in (3, 5, 8)]
    polys.append([1.0, 2.0, 3.0, 4.0])  # fewer than 3 points: skipped
    np.testing.assert_array_equal(trle.merge_polygons_to_mask(polys, 48, 64),
                                  jrle.merge_polygons_to_mask(polys, 48, 64))
    ids = rng.integers(0, 2 ** 24, (9, 7)).astype(np.uint32)
    np.testing.assert_array_equal(trle.id2rgb(ids), jrle.id2rgb(ids))
    np.testing.assert_array_equal(trle.rgb2id(trle.id2rgb(ids)), ids)


# -- conversation and tokenization -------------------------------------------


@pytest.mark.parametrize("style", ["SINGLE", "TWO", "PLAIN", "LLAMA_2"])
def test_conversation_copy_equals_original(style):
    prompts = []
    for mod in (jconv, tconv):
        conv = mod.Conversation(system="sys", roles=("USER", "ASSISTANT"),
                                messages=[], sep_style=mod.SeparatorStyle[style],
                                sep="###", sep2="</s>")
        conv.append_message(conv.roles[0], "hello <image>")
        conv.append_message(conv.roles[1], "hi")
        conv.append_message(conv.roles[0], "more")
        conv.append_message(conv.roles[1], "")
        prompts.append((conv.get_prompt(), conv.copy().get_prompt()))
    assert prompts[0] == prompts[1]
    got, want = vars(tconv.conv_llava_phi), vars(jconv.conv_llava_phi)
    assert got["sep_style"].name == want["sep_style"].name
    assert {k: v for k, v in got.items() if k != "sep_style"} == \
        {k: v for k, v in want.items() if k != "sep_style"}
    assert list(tconv.conv_templates) == list(jconv.conv_templates)


@pytest.mark.parametrize("K", [1, 3, 134])
def test_task_prompts_and_tokenization_equal_original(K):
    tok = StubTokenizer()
    names = [f"name {i}" if i % 3 else f"n{i}" for i in range(K)]
    for a, b in ((ttok.tokenize_class_names(names, tok),
                  jtok.tokenize_class_names(names, tok)),):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    builders = [(ttok.panoptic_prompt(K), jtok.panoptic_prompt(K)),
                (ttok.panoptic_prompt(K, "Semantic Segmentation"),
                 jtok.panoptic_prompt(K, "Semantic Segmentation")),
                (ttok.interactive_prompt(K), jtok.interactive_prompt(K)),
                (ttok.referring_prompt(), jtok.referring_prompt())]
    for got, want in builders:
        assert got == want
        prompt = ttok.build_conversation(*got)
        assert prompt == jtok.build_conversation(*want)
        for mask in (True, False):
            for x, y in zip(ttok.tokenize_conversation(prompt, tok, mask),
                            jtok.tokenize_conversation(prompt, tok, mask)):
                np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        ttok.tokenize_referring_sentence(" the cat. a dog.", tok),
        jtok.tokenize_referring_sentence(" the cat. a dog.", tok))


def test_tokenization_mismatch_masks_every_label_as_original():
    """A tokenizer whose per-round count differs from the whole prompt's:
    both sides warn and mask every label."""

    class Merging:
        def encode(self, text, add_special_tokens=False):
            return [7] * max(len(text) // 4, 1)

    prompt = ttok.build_conversation(*ttok.referring_prompt())
    with pytest.warns(UserWarning, match="tokenization mismatch"):
        got = ttok.tokenize_conversation(prompt, Merging())
    with pytest.warns(UserWarning, match="tokenization mismatch"):
        want = jtok.tokenize_conversation(prompt, Merging())
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


# -- mappers -----------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(_masks(), st.integers(0, 12))
def test_draw_circles_equals_original(mask, radius):
    np.testing.assert_array_equal(tmappers.draw_circles(mask, radius),
                                  jmappers.draw_circles(mask, radius))


@pytest.mark.parametrize("hw", [(48, 64), (97, 131), (640, 480)])
def test_mapper_transforms_equal_original(hw):
    """transform_mask, the panoptic and instance targets and the visual
    prompts (transform_image: tests/test_torch_copies.py)."""
    rng = np.random.default_rng(hw[0])
    image = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    t, j = tmappers.ImageMapper(128), jmappers.ImageMapper(128)
    label = rng.integers(0, 5, hw, dtype=np.uint8)
    for interp in (Image.NEAREST, Image.BILINEAR):
        np.testing.assert_array_equal(t.transform_mask(label, interp),
                                      j.transform_mask(label, interp))
    np.testing.assert_array_equal(t.transform_mask(image), j.transform_mask(image))

    pan = np.zeros(hw, np.uint32)
    pan[: hw[0] // 2] = 3
    pan[hw[0] // 2:, : hw[1] // 3] = 70000
    segs = [{"id": 3, "category_id": 1}, {"id": 70000, "category_id": 0},
            {"id": 9, "category_id": 2, "iscrowd": 1}]
    for got, want in ((t.panoptic_targets(trle.id2rgb(pan), segs),
                       j.panoptic_targets(jrle.id2rgb(pan), segs)),
                      (t.panoptic_targets(trle.id2rgb(pan), []),
                       j.panoptic_targets(jrle.id2rgb(pan), []))):
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    m = np.zeros(hw, np.uint8)
    m[2:hw[0] // 2, 3:hw[1] // 2] = 1
    rle = trle.encode(m)
    poly = [[2.0, 2.0, hw[1] - 3.0, 4.0, hw[1] / 2, hw[0] - 2.0]]
    anns = [{"category_id": 4, "segmentation": rle,
             "point_visual_prompt_mask": rle,
             "scribble_visual_prompt_mask": rle,
             "mask_visual_prompt_mask": rle},
            {"category_id": 2, "segmentation": poly},
            {"category_id": 3, "segmentation": rle, "iscrowd": 1}]
    for got, want in ((t.instance_targets(anns, hw), j.instance_targets(anns, hw)),
                      (t.instance_targets([], hw), j.instance_targets([], hw))):
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    for kind in ("point_visual_prompt_mask", "scribble_visual_prompt_mask",
                 "mask_visual_prompt_mask", "box_visual_prompt_mask"):
        got, want = t.visual_prompts(anns, kind), j.visual_prompts(anns, kind)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)


# -- datasets ----------------------------------------------------------------


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """JAX's synthetic COCO tree, its semantic list, and an MM-conv json."""
    tmp = tmp_path_factory.mktemp("data")
    root, inst_json = _write_synthetic_coco(str(tmp))
    rng = np.random.default_rng(0)
    for d in ("img", "lbl"):
        (tmp / d).mkdir()
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
        tmp / "img" / "a.jpg")
    lbl = np.full((48, 64), 255, np.uint8)
    lbl[:20] = 0
    lbl[20:40] = 2
    Image.fromarray(lbl).save(tmp / "lbl" / "a.png")
    with open(tmp / "list.json", "w") as f:
        json.dump([{"image": "a.jpg", "label": "a.png"}], f)
    with open(tmp / "conv.json", "w") as f:
        json.dump([{"id": 5, "image": "a.jpg", "conversations": [
            {"from": "human", "value": "<image>\nWhat is here?"},
            {"from": "gpt", "value": "A test image."},
            {"from": "human", "value": "And the colors?"},
            {"from": "gpt", "value": "Random ones."}]}], f)
    return {"root": root, "inst": inst_json,
            "images": os.path.join(root, "val2017"), "tmp": str(tmp)}


def _dataset_pair(name, trees, tok):
    t = trees
    args = {
        "panoptic": lambda m: (m.PanopticDataset, (t["root"], tok, _cfg()),
                               dict(is_train=False)),
        "panoptic_shuffled": lambda m: (m.PanopticDataset,
                                        (t["root"], tok, _cfg()),
                                        dict(is_train=False,
                                             shuffle_classes=True)),
        "instance": lambda m: (m.InstanceDataset,
                               (t["inst"], t["images"], tok, _cfg()), {}),
        "interactive": lambda m: (m.InteractiveDataset,
                                  (t["inst"], t["images"], tok, _cfg()), {}),
        "referring": lambda m: (m.ReferringDataset,
                                (t["inst"], t["images"], tok, _cfg()), {}),
        "semantic": lambda m: (m.SemanticDataset,
                               (os.path.join(t["tmp"], "list.json"),
                                os.path.join(t["tmp"], "img"),
                                os.path.join(t["tmp"], "lbl"), tok, _cfg()),
                               dict(class_names=["sky", "sea", "rock",
                                                 "background"])),
        "mm_conv": lambda m: (m.MMConvDataset,
                              (os.path.join(t["tmp"], "conv.json"),
                               os.path.join(t["tmp"], "img"), tok, _cfg()),
                              {}),
    }[name]
    out = []
    for mod in (tdatasets, jdatasets):
        cls, a, kw = args(mod)
        out.append(cls(*a, **kw))
    return out


def _assert_same_sample(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("name", ["panoptic", "panoptic_shuffled", "instance",
                                  "interactive", "referring", "semantic",
                                  "mm_conv"])
def test_dataset_samples_equal_original(trees, name):
    """Each dataset's samples against JAX's, key by key, with the same
    tokenizer instance; the shuffled panoptic set draws its permutation
    from the same ``random`` state on both sides."""
    tok = StubTokenizer()
    tds, jds = _dataset_pair(name, trees, tok)
    assert len(tds) == len(jds)
    assert getattr(tds, "image_sizes", None) == getattr(jds, "image_sizes", None)
    for i in range(len(jds)):
        random.seed(i)
        want = jds[i]
        random.seed(i)
        got = tds[i]
        _assert_same_sample(got, want)
    if name == "referring":
        for i in range(len(jds)):
            np.testing.assert_array_equal(tds.original_gt_mask(i),
                                          jds.original_gt_mask(i))
    if name in ("panoptic", "instance"):
        for seq_bucket in (0, 128):
            got = tdatasets.collate([tds[0], tds[1]], seq_bucket)
            want = jdatasets.collate([jds[0], jds[1]], seq_bucket)
            _assert_same_sample(got, want)


def test_dataset_config_equals_original():
    got, want = tdatasets.DataConfig(), jdatasets.DataConfig()
    assert vars(got) == vars(want)
    assert tdatasets.COCO_CLASS_IDS == jdatasets.COCO_CLASS_IDS
    assert tdatasets.COCO_CLASS_NAMES == jdatasets.COCO_CLASS_NAMES
