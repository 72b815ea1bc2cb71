"""The frozen FLOP counts and the op entries' bytes and operations against
hand counts: Phi's exactly at the tiny config, the totals at the published
widths against the issue's reckoning, the ops at small shapes, and the
frozen files against what ``counts/derive.py`` derives now."""

import json
from pathlib import Path

import pytest

from h100_bench.counts import derive, ops
from h100_bench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
CELLS = sorted(p.stem for p in (BENCH / "counts").glob("*.json")
               if p.stem != "peaks")


def test_phi_exact_at_the_tiny_config():
    cell = tiny.tiny_cell("eval_panoptic_b8")
    counts = derive.derive(cell["config"], cell["traffic"])
    phi = cell["config"]["model"]["phi"]
    D, inner, layers = (phi["hidden_size"], phi["intermediate_size"],
                        phi["num_layers"])
    L = counts["sequence_length"]
    linears = layers * L * (8 * D * D + 4 * D * inner)
    causal = layers * 2 * L * L * D
    assert counts["modules"]["phi"] == linears + causal


@pytest.mark.parametrize("cell,want,tol", [
    ("eval_panoptic_b8", 2.95e12, 0.06),    # the issue's reckoning an image
    ("eval_referring_b8", 1.98e12, 0.06),
    ("train_panoptic_b4", 7.5e12, 0.06),    # a sample, no recompute
])
def test_totals_at_the_published_widths(cell, want, tol):
    with open(BENCH / "counts" / f"{cell}.json") as f:
        counts = json.load(f)
    assert abs(counts["flops"] - want) <= tol * want
    L = counts["sequence_length"]
    # Phi: 24 x (8 D^2 + 4 D I) a token and 24 x 2 L^2 D causal
    assert counts["modules"]["phi"] == L * 2415919104 + 24 * 2 * L * L * 2048


@pytest.mark.parametrize("cell", CELLS)
def test_frozen_files_are_derived(cell):
    c = tiny.manifest_cell(cell)
    with open(BENCH / "counts" / f"{cell}.json") as f:
        assert json.load(f) == derive.derive(c["config"], c["traffic"])


def test_ops_by_hand():
    # 1 image, 21 positions, 2 heads of 4 channels, 3 levels, 2 points, bf16
    flops, nbytes = ops.msdeform_fwd((1, 21, 2, 4), (1, 21, 2, 3, 2, 2), 2)
    assert (flops, nbytes) == (252 * (10 * 4 + 12), 336 + 2016 + 504 + 336)
    flops, nbytes = ops.msdeform_bwd((1, 21, 2, 4), (1, 21, 2, 3, 2, 2), 2)
    assert (flops, nbytes) == (252 * (20 * 4 + 24),
                               2 * (336 + 2016 + 504) + 336)
    # 2 windows of 4 tokens, C = 2, one head, an f32 bias, no mask
    assert ops.window_attention((2, 4, 6), 2, 64, 0, 1) == (416, 192)
    # causal over 3 positions, one head of 2
    assert ops.flash_attention((1, 1, 3, 2), True, 2) == (78, 48)
    peak = ops.peaks()
    assert ops.bound_s(peak, 989e12, 0, True) == pytest.approx(1.0)
    assert ops.bound_s(peak, 0, 3.35e12, False) == pytest.approx(1.0)
