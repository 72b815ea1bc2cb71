"""The port's own copies of psalm_tpu's JAX-free modules against the
originals: the config tree field by field and through its JSON form, the
constants, the splicer's arrays, the chat prompt's sentinel splice, the
image mapper, the training batches' task sampler and collator, and the
matcher's host assignment, on the same inputs (exact equality)."""

import dataclasses

import numpy as np
import pytest

import psalm_tpu.config as jconfig
import psalm_tpu.data.constants as jconstants
import psalm_tpu.data.mappers as jmappers
import psalm_tpu.data.splicer as jsplicer
import psalm_tpu.data.tokenization as jtokenization
import psalm_tpu_torch.config as tconfig
import psalm_tpu_torch.data.constants as tconstants
import psalm_tpu_torch.data.mappers as tmappers
import psalm_tpu_torch.data.splicer as tsplicer
import psalm_tpu_torch.data.tokenization as ttokenization


def _configs(mod):
    return {"default": mod.PSALMConfig(), "tiny": mod.tiny_test_config(),
            "swin_l": mod.PSALMConfig(swin=mod.swin_l()),
            "int4_pallas": mod.PSALMConfig(phi=mod.PhiConfig(
                quant_bits=4, quant_storage="pallas"))}


@pytest.mark.parametrize("name", ["default", "tiny", "swin_l", "int4_pallas"])
def test_config_copy_equals_original(name):
    want, got = _configs(jconfig)[name], _configs(tconfig)[name]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for sub in ("phi", "swin", "projector", "pixel_decoder", "mask_decoder",
                "loss"):
        w, g = getattr(want, sub), getattr(got, sub)
        assert [f.name for f in dataclasses.fields(g)] == \
            [f.name for f in dataclasses.fields(w)], sub
    assert (got.phi.head_dim, got.phi.rotary_dim, got.swin.num_features) == \
        (want.phi.head_dim, want.phi.rotary_dim, want.swin.num_features)
    text = jconfig.config_to_json(want)
    assert tconfig.config_to_json(got) == text
    # each package reads the other's JSON back to an equal tree
    assert tconfig.config_from_json(text) == got
    assert jconfig.config_from_json(tconfig.config_to_json(got)) == want


def test_seg_task_and_constants_equal():
    assert [(t.name, t.value) for t in tconfig.SegTask] == \
        [(t.name, t.value) for t in jconfig.SegTask]
    for t in tconfig.SegTask:
        j = jconfig.SegTask(t.value)
        assert (t.semantic_on, t.instance_on, t.panoptic_on, t.referring_on,
                t.region_on, t.postprocess_before_inference) == \
            (j.semantic_on, j.instance_on, j.panoptic_on, j.referring_on,
             j.region_on, j.postprocess_before_inference)
    names = [n for n in dir(jconstants) if n.isupper()]
    assert names == [n for n in dir(tconstants) if n.isupper()]
    for n in names:
        assert getattr(tconstants, n) == getattr(jconstants, n), n


C = jconstants
SPLICE_CASES = {
    # the panoptic eval prompt: class names, seg queries, padding
    "class_names": (
        [11, 12, C.IMAGE_TOKEN_INDEX, 13, C.CLS_TOKEN_INDEX, C.CLS_TOKEN_INDEX,
         C.CLS_TOKEN_INDEX, 14, C.SEG_TOKEN_INDEX, 15],
        dict(num_image_tokens=4, num_seg_queries=10, pad_len=40,
             class_name_ids=np.array([21, 22, 23, 24, 25, 26]),
             cls_indices=np.array([0, 0, 1, 2, 2, 2])), True),
    # a referring prompt: the sentence's tokens at <refer>
    "refer": (
        [11, C.IMAGE_TOKEN_INDEX, 12, C.REFER_TOKEN_INDEX, 13,
         C.SEG_TOKEN_INDEX],
        dict(num_image_tokens=4, num_seg_queries=3, pad_len=24,
             token_refer_id=np.array([31, 32, 33])), True),
    # the chat worker's call: one seg query, padded to a multiple of 64
    "worker": (
        [5, 6, C.IMAGE_TOKEN_INDEX, 7, 8, 9],
        dict(num_image_tokens=16, num_seg_queries=1, pad_len=64), False),
    # regions, and no padding at all
    "regions_unpadded": (
        [5, C.IMAGE_TOKEN_INDEX, C.REGION_TOKEN_INDEX, C.REGION_TOKEN_INDEX,
         6, C.SEG_TOKEN_INDEX],
        dict(num_image_tokens=2, num_seg_queries=2, pad_len=9,
             num_regions=2), True),
}


@pytest.mark.parametrize("case", sorted(SPLICE_CASES))
def test_splicer_copy_equals_original(case):
    ids, kw, with_labels = SPLICE_CASES[case]
    labels = list(range(100, 100 + len(ids))) if with_labels else None
    samples = []
    for mod in (jsplicer, tsplicer):
        s = [mod.splice(ids, labels, **kw),
             mod.splice(ids[::-1] if case == "worker" else ids, labels, **kw)]
        samples.append((s, mod.stack_samples(s)))
    (js, jstack), (ts, tstack) = samples
    for a, b in zip(js, ts):
        assert a.length == b.length
        for k, v in a.as_dict().items():
            got = b.as_dict()[k]
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    assert sorted(tstack) == sorted(jstack)
    for k in jstack:
        np.testing.assert_array_equal(tstack[k], jstack[k], err_msg=k)
    with pytest.raises(ValueError, match="exceeds pad_len"):
        tsplicer.splice(ids, None, **dict(kw, pad_len=len(ids) - 1))


class _CharTokenizer:
    def encode(self, text, add_special_tokens=False):
        return [100 + ord(c) % 300 for c in text]


@pytest.mark.parametrize("prompt", [
    "<image>\nWhat is in the image?",
    "This is an image <image>, Please do Panoptic Segmentation.\n"
    "<cls>, <cls>.\n<seg>",
    "plain text only", "<refer><region><image><image>", ""])
def test_tokenize_special_equals_original(prompt):
    tok = _CharTokenizer()
    assert ttokenization.tokenize_special(prompt, tok) == \
        jtokenization.tokenize_special(prompt, tok)


@pytest.mark.parametrize("hw", [(480, 640), (640, 480), (97, 131),
                                (1024, 1024)])
def test_image_mapper_equals_original(hw):
    rng = np.random.default_rng(hw[0])
    image = rng.integers(0, 256, hw + (3,), dtype=np.uint8)
    for short, max_size in ((1024, 1024), (800, 1333)):
        assert tmappers.resize_shortest_edge_shape(*hw, short, max_size) == \
            jmappers.resize_shortest_edge_shape(*hw, short, max_size)
    want = jmappers.ImageMapper(256).transform_image(image)
    got = tmappers.ImageMapper(256).transform_image(image)
    assert got.image.dtype == want.image.dtype
    np.testing.assert_array_equal(got.image, want.image)
    np.testing.assert_array_equal(got.padding_mask, want.padding_mask)
    assert (got.resized_hw, got.original_hw, got.scale) == \
        (want.resized_hw, want.original_hw, want.scale)


@pytest.mark.parametrize("area", [0, 5, 300, 4000])
def test_sample_region_points_equals_original(area):
    """In-mask points with repeat (fewer pixels than points), a sample
    without repeat (more), and an empty mask, from the same generator."""
    mask = np.zeros((64, 80), bool)
    mask.reshape(-1)[np.random.default_rng(area).permutation(mask.size)[:area]] = True
    want = jmappers.ImageMapper.sample_region_points(
        mask, 256, np.random.default_rng(1))
    got = tmappers.ImageMapper.sample_region_points(
        mask, 256, np.random.default_rng(1))
    assert got.dtype == want.dtype == np.float32 and got.shape == (256, 2)
    np.testing.assert_array_equal(got, want)


class _Sized:
    """A stand-in dataset of ``n`` samples of one task."""

    def __init__(self, n, kind):
        self.n, self.kind = n, kind

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": i, "kind": self.kind}


@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_task_sampler_copy_equals_original(shard):
    """The same schedule of (dataset, sample) draws over three datasets with
    ratios, across epoch reshuffles, per host shard."""
    import psalm_tpu.data.datasets as jdatasets
    import psalm_tpu_torch.data.datasets as tdatasets
    sets = [_Sized(5, "a"), _Sized(2, "b"), _Sized(7, "c")]
    kw = dict(ratios=[2, 1, 1], seed=4, shard_index=shard[0],
              num_shards=shard[1])
    want = jdatasets.UnifiedTaskSampler(sets, 3, **kw)
    got = tdatasets.UnifiedTaskSampler(sets, 3, **kw)
    for _ in range(12):
        assert got.next_batch() == want.next_batch()
    assert got.next_batch_indices() == want.next_batch_indices()


@pytest.mark.parametrize("seq_bucket", [0, 128])
def test_collate_copy_equals_original(seq_bucket):
    import psalm_tpu.data.datasets as jdatasets
    import psalm_tpu_torch.data.datasets as tdatasets
    ds = tdatasets.SyntheticPanopticDataset(64, 10, 4, num_samples=2,
                                            num_masks=3, valid_masks=2)
    samples = [ds[0], ds[1]]
    samples[1]["file_name"] = samples[0]["file_name"] = "x.png"
    want = jdatasets.collate(samples, seq_bucket)
    got = tdatasets.collate(samples, seq_bucket)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


def test_lsa_host_copy_equals_original():
    from psalm_tpu.train.criterion import _lsa_host as jlsa
    from psalm_tpu_torch.train.criterion import _lsa_host as tlsa
    rng = np.random.default_rng(0)
    cost = rng.standard_normal((3, 7, 5)).astype(np.float32)
    cost[0, 2, 1] = np.nan
    cost[1, :, 3] = np.inf
    n_valid = np.array([5, 4, 0])
    for a, b in zip(tlsa(cost, n_valid), jlsa(cost, n_valid)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
