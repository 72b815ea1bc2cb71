"""Today's configurations draw and compute what they did before the language
model went behind ``h100_bench/lm/``: the weight spec of both configuration
files (names, kinds, scales and shapes, in order), the tiny configuration's
drawn weights bit for bit, and the tiny reference's eval outputs and first
training steps on the CPU (f32; round-off of the CPU's threads aside).

``identity.json`` holds ``readings()`` as the tree before that change gave
them; it is written by

    python3 -m h100_bench.tests.test_h100_bench_identity \\
        > h100_bench/tests/identity.json
"""

import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from h100_bench import common, weights  # noqa: E402
from h100_bench.gen import batches  # noqa: E402
from h100_bench.tests import tiny  # noqa: E402

FROZEN = Path(__file__).resolve().parent / "identity.json"
#: the cells whose configuration files are read (one a configuration)
CELLS = ("eval_panoptic_b8", "train_panoptic_b4")
SEED = 7
#: a reading's room for the round-off of the CPU's threads, against the
#: tensor's L1 norm (outputs) or the larger of the leaf's and the median
#: leaf's gradient norm; a weight drawn in another order moves them by far
#: more
ROUND_OFF = 1e-5


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def spec_digest(config):
    """The number of tensors and the digest of the spec of a configuration
    file, at its own widths (on ``meta``)."""
    spec, _ = weights.weight_spec(config)
    rows = [[name, kind, repr(scale), list(shape)]
            for name, kind, scale, shape in spec]
    return {"tensors": len(spec), "sha256": _sha256(json.dumps(rows))}


def tiny_weights_digest(config) -> str:
    """The digest of every drawn tensor's name and bytes of the tiny
    reference, in ``spec``'s order."""
    spec, meta = weights.weight_spec(config)
    model = weights.reference_model(weights.reference_config(config), "cpu")
    weights.fill(model, spec, SEED, torch.float32, reference=meta)
    tensors = dict(model.named_parameters())
    tensors.update(dict(model.named_buffers()))
    h = hashlib.sha256()
    for name, *_ in spec:
        h.update(name.encode())
        h.update(tensors[name].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def summary(t: torch.Tensor):
    """[L2 norm, L1 norm, a sum weighted by sin(index)]: the last moves
    where the values move between places."""
    t = t.detach().double().flatten()
    w = torch.sin(torch.arange(t.numel(), dtype=torch.float64))
    return [float(t.norm()), float(t.abs().sum()), float((t * w).sum())]


def eval_readings():
    from h100_bench.drivers import eval as ev
    cell = tiny.tiny_cell("eval_panoptic_b8")
    mix, config = cell["traffic"], cell["config"]
    cfg = weights.reference_config(config)
    batch = batches.eval_batch(mix, cfg.image_size,
                               cfg.mask_decoder.num_queries, SEED, 0)
    out = ev.reference_outputs(config, mix, SEED, batch, torch.device("cpu"))
    ev.free_reference()
    return {k: summary(v) for k, v in sorted(out.items())}


def train_readings():
    from h100_bench.drivers import train as tr
    cell = tiny.tiny_cell("train_panoptic_b4")
    mix, config = cell["traffic"], cell["config"]
    cfg = weights.reference_config(config)
    pool = [batches.train_batch(mix, cfg.image_size,
                                cfg.mask_decoder.num_queries, SEED, i, 0, 1)
            for i in range(tr.CHECK_STEPS)]
    own = tr.reference_steps(config, mix, SEED, pool, torch.device("cpu"),
                             0)["own"]
    return {"loss": own["loss"], "grad": own["grad"]}


def readings():
    torch.set_num_threads(2)
    return {"spec": {c: spec_digest(common.cell(c)["config"]) for c in CELLS},
            "tiny_weights": tiny_weights_digest(
                tiny.tiny_cell(CELLS[0])["config"]),
            "eval": eval_readings(), "train": train_readings()}


@pytest.fixture(scope="module")
def frozen():
    return json.loads(FROZEN.read_text())


@pytest.mark.parametrize("workload", CELLS)
def test_weight_spec_of_each_configuration(frozen, workload):
    got = spec_digest(common.cell(workload)["config"])
    assert got == frozen["spec"][workload]


def test_tiny_weights_bit_for_bit(frozen):
    torch.set_num_threads(2)
    got = tiny_weights_digest(tiny.tiny_cell(CELLS[0])["config"])
    assert got == frozen["tiny_weights"]


def test_tiny_reference_eval_outputs(frozen):
    torch.set_num_threads(2)
    got, want = eval_readings(), frozen["eval"]
    assert sorted(got) == sorted(want)
    for key, values in want.items():
        room = ROUND_OFF * values[1]
        for g, w in zip(got[key], values):
            assert abs(g - w) <= room, (key, got[key], values)


def test_tiny_reference_training_steps(frozen):
    torch.set_num_threads(2)
    got, want = train_readings(), frozen["train"]
    for g, w in zip(got["loss"], want["loss"]):
        assert g == pytest.approx(w, rel=ROUND_OFF)
    assert list(got["grad"]) == list(want["grad"])
    norms = sorted(want["grad"].values())
    median = norms[len(norms) // 2]
    for name, w in want["grad"].items():
        assert abs(got["grad"][name] - w) <= ROUND_OFF * max(w, median), name


if __name__ == "__main__":
    print(json.dumps(readings(), indent=1))
