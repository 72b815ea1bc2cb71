#!/usr/bin/env python3
"""K6 and K7 beside another checkout's K6 and K7, on the same inputs, in
turns, on one card.

    python3 tools/matcher_ab.py --against DIR   # from the root of a
                                                # checkout; one card

DIR is another checkout (for instance the parent commit, unpacked by `git
archive`). Its csrc/lap.cu and csrc/auction.cu are built by nvcc alone into
a temporary library and called through their C entry points; this
checkout's kernels through lap_assign and auction_assign. On each input
both must give the same src, valid and step counts; their device ms
(chip_smoke.device_ms, torch.profiler) are taken in turns: the other, this,
this, the other. The inputs, [B, Q, N] with every target valid:
  near-tied [10, 100, 16]  a[n] + 0.05 b[q] + 0.01 e[q, n] (standard normal
                           a, b, e): every target ranks the queries alike,
                           as an untrained model's costs do
  near-tied [4, 100, 100]  the same, square
  planted [10, 100, 16]    a permutation at cost -4 over noise of sigma 0.3,
                           as chip_smoke.py's phase 20 plants it
Prints the card's name and power limit, a line a kernel and input, and one
JSON line of the records last.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from psalm_tpu_torch.ops import _build  # noqa: E402
from psalm_tpu_torch.train import auction, lap  # noqa: E402


def inputs(rng):
    """(name, cost [B, Q, N] f32, n_valid [B] int32) on the card."""
    def near_tied(B, Q, N):
        return (rng.standard_normal((B, 1, N))
                + rng.standard_normal((B, Q, 1)) * 0.05
                + rng.standard_normal((B, Q, N)) * 0.01)

    planted = rng.standard_normal((10, 100, 16)) * 0.3
    for b in range(10):
        planted[b, rng.permutation(100)[:16], np.arange(16)] = -4.0
    cases = [("near-tied [10, 100, 16]", near_tied(10, 100, 16)),
             ("near-tied [4, 100, 100]", near_tied(4, 100, 100)),
             ("planted [10, 100, 16]", planted)]
    return [(name, torch.from_numpy(c.astype(np.float32)).cuda(),
             torch.full((c.shape[0],), c.shape[2], dtype=torch.int32,
                        device="cuda")) for name, c in cases]


def other_library(src_dir, work):
    """The other checkout's K6 and K7, built alone with this checkout's
    flags."""
    out = os.path.join(work, "libother.so")
    srcs = [os.path.join(src_dir, "psalm_tpu_torch", "csrc", f)
            for f in ("lap.cu", "auction.cu")]
    proc = subprocess.run(
        _build.nvcc_command(_build.find_nvcc(), srcs, out),
        capture_output=True, text=True)
    if proc.returncode != 0:
        smoke.fail(f"the other checkout's K6 / K7 did not build:\n"
                   f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    lib = ctypes.CDLL(out)
    lib.psalm_lap_assign.argtypes = _build.SIGNATURES["psalm_lap_assign"]
    lib.psalm_auction_assign.argtypes = _build.SIGNATURES[
        "psalm_auction_assign"]
    return lib


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", required=True,
                        help="the root of the other checkout")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        smoke.fail("torch.cuda.is_available() is False: this needs a card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    _build.library()
    records = []
    with tempfile.TemporaryDirectory() as work:
        other = other_library(os.path.abspath(args.against), work)
        for name, cost, n_valid in inputs(np.random.default_rng(16)):
            B, Q, N = cost.shape
            stream = torch.cuda.current_stream().cuda_stream
            for kernel, this_fn, other_fn, extra in (
                    ("K6", lap.lap_assign, other.psalm_lap_assign, ()),
                    ("K7", auction.auction_assign,
                     other.psalm_auction_assign, (300, 1e-3))):
                steps = torch.zeros(B, dtype=torch.int32, device="cuda")
                other_steps = torch.zeros_like(steps)
                src = torch.empty(B, N, dtype=torch.long, device="cuda")
                valid = torch.empty(B, N, dtype=torch.bool, device="cuda")

                def call_other(s=other_steps):
                    rc = other_fn(cost.data_ptr(), n_valid.data_ptr(),
                                  src.data_ptr(), valid.data_ptr(),
                                  s.data_ptr(), B, Q, N, *extra, stream)
                    if rc != 0:
                        smoke.fail(f"the other {kernel}: CUDA error {rc}")

                def call_this():
                    this_fn(cost, n_valid)

                got = this_fn(cost, n_valid, steps=steps)
                call_other()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], src) and torch.equal(got[1], valid)
                        and torch.equal(steps, other_steps)):
                    smoke.fail(f"{kernel} {name}: the two checkouts differ")
                ms = [smoke.device_ms(f) for f in (call_other, call_this,
                                                   call_this, call_other)]
                most = max(int(steps.max()), 1)
                rec = {"kernel": kernel, "input": name,
                       "steps": steps.tolist(), "other_ms": [ms[0], ms[3]],
                       "this_ms": [ms[1], ms[2]],
                       "this_us_per_step": 1e3 * min(ms[1:3]) / most,
                       "other_us_per_step": 1e3 * min(ms[0], ms[3]) / most}
                records.append(rec)
                print(f"{kernel} {name}: equal; steps {rec['steps']}; other "
                      f"{ms[0]:.4f} / this {ms[1]:.4f} / this {ms[2]:.4f} / "
                      f"other {ms[3]:.4f} ms; us a step this "
                      f"{rec['this_us_per_step']:.4f}, other "
                      f"{rec['other_us_per_step']:.4f}", flush=True)
    print(json.dumps({"matcher_ab": records}), flush=True)


if __name__ == "__main__":
    main()
