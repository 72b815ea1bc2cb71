"""The traffic generator repeats for a seed, differs across seeds, and gives
every seed the same sizes; the mixes' sizes are the issue's (L = 768 for
134 class names, 384 for a 12-token sentence)."""

import json
from pathlib import Path

import numpy as np
import pytest

from h100_bench.gen import batches

BENCH = Path(__file__).resolve().parents[1]
MIXES = sorted(p.stem for p in (BENCH / "traffic").glob("*.json"))
S, NQ = 1024, 100


def mix(name):
    with open(BENCH / "traffic" / f"{name}.json") as f:
        m = json.load(f)
    if m["kind"] == "train":
        m = dict(m, batch=1)  # one 1024^2 sample keeps the test light
    else:
        m = dict(m, batch=2)
    return m


def make(name, seed, index=1):
    m = mix(name)
    if m["kind"] == "eval":
        return batches.eval_batch(m, S, NQ, seed, index)
    return batches.train_batch(m, S, NQ, seed, index,
                               rank=m["data_ranks"] - 1,
                               ranks=m["data_ranks"])


def same(a, b):
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


@pytest.mark.parametrize("name", MIXES)
def test_repeats_per_seed_and_differs_across_seeds(name):
    a, b = make(name, 2 ** 31 + 5), make(name, 2 ** 31 + 5)
    c = make(name, 12345)
    assert a.keys() == c.keys() and same(a, b)
    assert not same(a, c)
    for k in a:  # every seed the same sizes
        assert np.shape(a[k]) == np.shape(c[k]), k


@pytest.mark.parametrize("name", MIXES)
def test_sequence_length(name):
    m = mix(name)
    L = make(name, 3)["tok_ids"].shape[1]
    assert L == (384 if m.get("task") == "referring" else 768)


def test_pool_batches_differ_and_ranks_take_their_rows():
    m = mix("coco_panoptic_train_dp4")
    r0 = batches.train_batch(m, 64, 10, 9, 0, rank=0, ranks=4)
    r1 = batches.train_batch(m, 64, 10, 9, 0, rank=1, ranks=4)
    nxt = batches.train_batch(m, 64, 10, 9, 1, rank=0, ranks=4)
    assert not np.array_equal(r0["images"], r1["images"])
    assert not np.array_equal(r0["images"], nxt["images"])
    assert r0["gt_valid"].sum() == m["valid_masks"] * m["batch"]


def test_draws_repeat():
    import torch
    a = batches.Draws(77, "cpu")(None, (2, 5, 2))
    b = batches.Draws(77, "cpu")(None, (2, 5, 2))
    c = batches.Draws(78, "cpu")(None, (2, 5, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
