"""The port's bench (``psalm_tpu_torch/bench.py``) on the CPU: its mode
parsing and key names against ``bench.py``'s own code, and the whole
measurement at the tiny config, which must print one well-formed JSON line
with ``bench.py``'s keys. The rates here are CPU timings of the plain
versions: the test holds their form, not their size."""

import ast
import json
import os

import pytest

from psalm_tpu_torch import bench
from psalm_tpu_torch.config import tiny_test_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_GEOMETRY = ((48, 64), (97, 131), (128, 160))
SPECS = ("window8", "window4", "window", "window2.5", "deformable",
         "windowpp", "windowpp2.5,4,6,8", "windowpp1,2,3,4", " window8 ")


def _jax_bench_branch():
    """The body of ``bench.py::main``'s loop over the modes that picks the
    radius and the key (its first ``if``), compiled alone."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    branch = next(n for n in loop.body if isinstance(n, ast.If))
    return compile(ast.Module(body=[branch], type_ignores=[]), "bench.py",
                   "exec")


@pytest.mark.parametrize("spec", SPECS)
def test_mode_keys_are_bench_py_keys(spec):
    """bench.py's branch, run with its measure_mode recording its
    arguments: the same attention mode, radius and key."""
    env = {"m": spec.strip(),
           "measure_mode": lambda mode, radius=8.0: (mode, radius)}
    exec(_jax_bench_branch(), env)
    mode, radius = env["r"]
    got = bench.mode_spec(spec)
    assert got[2] == env["key"]
    assert got[0] == mode
    if mode == "window":
        assert got[1] == radius
    else:
        assert got[1] is None


def test_busy_time_is_the_union_of_intervals():
    class Event:
        def __init__(self, start, end):
            self.time_range = type("R", (), {"start": start, "end": end})

    events = [Event(0, 10), Event(5, 12), Event(20, 25), Event(21, 22)]
    assert bench.busy_us(events) == 17
    assert bench.busy_us([]) == 0


def test_tiny_run_prints_bench_json(capsys, monkeypatch):
    """Two modes at the tiny config on the CPU, one of them with a radius
    a point, taken from PSALM_BENCH_MODES: a line per mode on stderr and
    bench.py's JSON keys on stdout; the device rate is not measured."""
    monkeypatch.setenv("PSALM_BENCH_MODES", "windowpp,deformable")
    bench.main(cfg=tiny_test_config(), device="cpu", iters=1, warmup=1,
               batch_size=1, geometry=TINY_GEOMETRY, baseline=2.0)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    for k in ("metric", "value", "unit", "vs_baseline", "p50_ms",
              "headline_method", "note", "pipelined_corroborates_headline"):
        assert k in line, k
    assert line["metric"] == "images_per_sec_per_chip_coco_panoptic_eval"
    assert line["headline_method"] in ("blocking", "pipelined")
    assert line["pipelined_corroborates_headline"] is None
    assert line["device"] == "cpu"
    for key in ("window_pp2_4_6_8", "deformable_parity"):
        for rate in ("blocking", "pipelined"):
            assert line[f"{key}_{rate}_img_per_s"] > 0
        assert line[f"{key}_img_per_s"] == max(
            line[f"{key}_blocking_img_per_s"],
            line[f"{key}_pipelined_img_per_s"])
        assert line[f"{key}_device_img_per_s"] is None
        assert line[f"{key}_p50_ms"] > 0
        # the CPU runs the plain versions, which count no launch
        assert line[f"{key}_launches_per_image"] == {"K1": 0, "K3": 0,
                                                     "K5": 0}
        assert f"{key}: " in err
    # the first mode listed is the headline (the value to 3 decimals, the
    # mode's rate to 2)
    assert abs(line["value"] - line["window_pp2_4_6_8_img_per_s"]) <= 0.0051
    assert abs(line["vs_baseline"] - line["value"] / 2.0) <= 0.0051


def test_card_is_required_unless_the_caller_asks_for_the_cpu(monkeypatch):
    monkeypatch.setattr(bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        bench.run(modes=["window8"], baseline=1.0)
