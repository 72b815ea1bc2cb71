"""A language model of another family enters the harness through its kind's
module alone (``h100_bench/lm/``): the test tree's ``gqa_moe``
(``gqa_moe.py``: RMSNorm, grouped-query attention, routed experts held as
3-D parameters), put in the package's place, and a configuration dict built
here. It loads as a cell, draws every tensor, is counted, keeps its tiny
config, adds its span entry and runs the reference's eval and training
paths; a section no one claims raises."""

import json
import sys

import pytest
import torch

from h100_bench import common, lm, weights
from h100_bench.counts import derive, ops
from h100_bench.gen import batches
from h100_bench.tests import gqa_moe, tiny

KIND = "gqa_moe"
WORKLOAD = "gqa_moe_eval_b8"
#: the published widths of the rest of PSALM, with a language model of
#: Phi-1.5's hidden size in Phi's place
WIDE = {"hidden_size": 2048, "num_heads": 16, "num_kv_heads": 4,
        "head_dim": 128, "num_experts": 8, "experts_per_token": 2,
        "expert_size": 1024, "vocab_size": 4096, "num_layers": 2}


@pytest.fixture(autouse=True)
def in_the_lm_package(monkeypatch):
    """``gqa_moe`` where ``h100_bench/lm/gqa_moe.py`` would be."""
    monkeypatch.setitem(sys.modules, f"{lm.__name__}.{KIND}", gqa_moe)


def configuration():
    """The eval configuration file with ``gqa_moe`` in Phi's place."""
    config = common.cell("eval_panoptic_b8")["config"]
    config = json.loads(json.dumps(config))
    config["name"] = "psalm_b_gqa_moe_eval"
    config["language_model"] = KIND
    del config["model"]["phi"]
    config["model"][KIND] = dict(WIDE)
    return config


@pytest.fixture
def manifest(tmp_path):
    """A manifest of one cell of the configuration, on a traffic mix the
    benchmark has."""
    path = tmp_path / "psalm_b_gqa_moe_eval.json"
    path.write_text(json.dumps(configuration()))
    with open(common.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    bench["configs"] = [{"name": "psalm_b_gqa_moe_eval", "source": "test",
                         "file": str(path), "reduced": [], "why": "test"}]
    bench["workloads"] = [{"name": WORKLOAD, "config": "psalm_b_gqa_moe_eval",
                           "traffic": "coco_panoptic_eval_b8", "chips": 1,
                           "why": "test"}]
    out = tmp_path / "BENCHMARK.json"
    out.write_text(json.dumps(bench))
    return out


def test_a_cell_loads_through_common_cell(manifest):
    cell = common.cell(WORKLOAD, manifest)
    assert lm.kind_of(cell["config"]) == KIND
    cfg = weights.reference_config(cell["config"])
    assert cfg.language_model == KIND
    assert cfg.lm == gqa_moe.GQAMoEConfig(**WIDE)
    assert cfg.projector.out_dim == cfg.lm.hidden_size


def test_spec_and_fill_draw_every_tensor(manifest):
    # at the published widths, on meta: every tensor has a rule
    spec, meta = weights.weight_spec(common.cell(WORKLOAD, manifest)["config"])
    names = [n for n, _ in meta.named_parameters()]
    names += [n for n, b in meta.named_buffers() if b.is_floating_point()]
    assert [s[0] for s in spec] == names
    rules = {s[0]: s[1:3] for s in spec}
    assert rules["model.layers.1.mlp.w_in"] == ("normal", pytest.approx(2048 ** -0.5))
    assert rules["model.layers.1.mlp.w_out"] == ("normal", pytest.approx(1024 ** -0.5))
    assert rules["model.norm.weight"] == ("const", 1.0)
    # at the tiny size, on the CPU: every tensor written, as drawn
    config = tiny.tiny_cell(WORKLOAD, manifest)["config"]
    spec, meta = weights.weight_spec(config)
    model = weights.reference_model(weights.reference_config(config), "cpu")
    for t in model.parameters():
        t.data.fill_(float("nan"))
    weights.fill(model, spec, 7, torch.float32, reference=meta)
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    assert all(torch.isfinite(tensors[name]).all() for name, *_ in spec)
    w_in = tensors["model.layers.0.mlp.w_in"]
    assert w_in.shape == (4, 64, 64)
    assert float(w_in.detach().std()) == pytest.approx(64 ** -0.5, rel=0.1)
    assert bool((tensors["model.layers.0.attn_norm.weight"] == 1).all())


def test_derive_counts_it_by_hand(manifest):
    cell = tiny.tiny_cell(WORKLOAD, manifest)
    counts = derive.derive(cell["config"], cell["traffic"])
    c = gqa_moe.tiny()
    D, h, kv, hd = c.hidden_size, c.num_heads, c.num_kv_heads, c.head_dim
    E, k, F = c.num_experts, c.experts_per_token, c.expert_size
    L = counts["sequence_length"]
    a_layer = (2 * L * D * (2 * h * hd + 2 * kv * hd)  # q, k, v, o
               + 2 * L * L * h * hd                     # causal q k^T, P v
               + 2 * L * D * E                          # router
               + k * L * 6 * D * F)                     # routed experts
    assert counts["modules"][KIND] == c.num_layers * a_layer
    assert "phi" not in counts["modules"]
    assert counts["unrouted_experts"] == c.num_layers * (E - k) * L * 6 * D * F
    assert counts["causal_saving"] == c.num_layers * 2 * L * L * h * hd
    assert "experts routed" in counts["derivation"]


def test_tiny_cell_keeps_it(manifest):
    import dataclasses
    cell = tiny.tiny_cell(WORKLOAD, manifest)
    assert cell["config"]["language_model"] == KIND
    model = cell["config"]["model"]
    assert model[KIND] == dataclasses.asdict(gqa_moe.tiny())
    assert "phi" not in model
    assert weights.reference_config(cell["config"]).lm == gqa_moe.tiny()


def test_the_drivers_span_lists_include_its_entry():
    from h100_bench.drivers import eval as ev, train as tr
    config = configuration()
    assert ev.span_entries(config) == ev.SPANS + gqa_moe.SPANS["eval"]
    assert tr.span_entries(config) == tr.SPANS
    phi_entry = lm.module("phi").SPANS["eval"][0]
    assert phi_entry not in ev.span_entries(config)
    assert phi_entry in ev.span_entries(common.cell("eval_panoptic_b8")
                                        ["config"])


def test_its_bound_function_by_hand():
    # causal over 3 positions (6 pairs), 2 query heads and 1 key head of
    # 2, bf16: 4 x 2 x 2 x 6 + 5 x 2 x 6 = 156 operations; q and out 12
    # values each, k and v 6 each: 72 bytes
    q = torch.zeros(1, 2, 3, 2, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 3, 2, dtype=torch.bfloat16)
    peak = {"hbm_bytes_per_s": 72.0, "bf16_flops_per_s": 156.0,
            "f32_flops_per_s": 1.0}
    assert gqa_moe.flash_gqa_bound(peak, q, kv, kv, causal=True,
                                   sm_scale=1.0) == pytest.approx(1.0)
    assert ops.bound_s(peak, 156.0, 72.0, True) == pytest.approx(1.0)


def test_the_reference_runs_its_eval_and_training_paths(manifest):
    from h100_bench.drivers import eval as ev, train as tr
    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    cell = tiny.tiny_cell(WORKLOAD, manifest)
    mix, config = cell["traffic"], cell["config"]
    cfg = weights.reference_config(config)
    batch = batches.eval_batch(mix, cfg.image_size,
                               cfg.mask_decoder.num_queries, 7, 0)
    out = ev.reference_outputs(config, mix, 7, batch, cpu)
    heads = ev.reference_heads(config, mix, out, batch)
    ev.free_reference()
    assert out["hidden"].shape[-1] == 64
    assert all(torch.isfinite(v).all() for v in out.values())
    assert len(heads) == mix["batch"]
    train = tiny.tiny_cell("train_panoptic_b4")
    tconfig, tmix = train["config"], train["traffic"]
    tconfig["language_model"] = KIND
    tconfig["model"] = tiny.tiny_model(KIND)
    pool = [batches.train_batch(tmix, cfg.image_size,
                                cfg.mask_decoder.num_queries, 7, i, 0, 1)
            for i in range(tr.CHECK_STEPS)]
    own = tr.reference_steps(tconfig, tmix, 7, pool, cpu, 0)["own"]
    assert all(torch.isfinite(torch.tensor(own["loss"])))
    assert own["grad"]["model.layers.0.mlp.w_in"] > 0
    assert own["change"]["model.layers.1.mlp.w_out"] > 0


@pytest.mark.parametrize("kind,section", [("phi", "bogus"),
                                          (KIND, "phi")])
def test_an_unclaimed_model_section_raises(kind, section):
    config = common.cell("eval_panoptic_b8")["config"]
    config = json.loads(json.dumps(config))
    config["language_model"] = kind
    config["model"][section] = {}
    with pytest.raises(ValueError, match=section):
        weights.reference_config(config)


def test_an_unknown_kind_raises():
    with pytest.raises(ValueError, match="no language model"):
        lm.module("no_such_model")
    with pytest.raises(ValueError, match="not a module"):
        lm.module("../phi")
