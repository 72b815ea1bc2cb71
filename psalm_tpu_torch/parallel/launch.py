"""Run a function in N processes that form one process group.

``spawn("pkg.module:function", n, args, device)`` starts n Python processes
with torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), each of which calls
``init_distributed(device)``, then ``function(*args)``, and returns every
rank's result in rank order. The arguments and results travel as pickles in
a temporary directory that this process creates and reads (only this
program writes them). ``threads`` caps each process's torch threads, so
that n CPU workers share the host's cores.

    python -m psalm_tpu_torch.parallel.launch MODULE:FUNCTION DIR DEVICE THREADS

is what each process runs.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Sequence


def spawn(target: str, nprocs: int, args: Sequence[Any] = (),
          device: str = "cuda", threads: int = 2, timeout: float = 600
          ) -> List[Any]:
    """``target(*args)`` on ``nprocs`` ranks of ``device``: a card each
    (NCCL) unless the caller asks for ``"cpu"`` (gloo); their results in
    rank order. Raises with the failing ranks' output if one exits nonzero
    or the group outlasts ``timeout`` seconds (the others are then
    killed)."""
    from psalm_tpu_torch.parallel.mesh import free_port
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(tuple(args), f)
        env = dict(os.environ, WORLD_SIZE=str(nprocs),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   OMP_NUM_THREADS=str(threads),
                   PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        procs, logs = [], []
        try:
            for rank in range(nprocs):
                log = open(os.path.join(tmp, f"log-{rank}.txt"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "psalm_tpu_torch.parallel.launch",
                     target, tmp, device, str(threads)],
                    env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
                    stdout=log, stderr=subprocess.STDOUT))
            # a rank that fails leaves the others waiting in a collective:
            # stop them all at the first failure
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outputs = []
            for log in logs:
                log.seek(0)
                outputs.append(log.read())
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"{target} failed on ranks {bad}:\n" + "\n".join(
                f"--- rank {r} (exit {procs[r].returncode}):\n"
                f"{outputs[r][-4000:]}" for r in bad))
        results = []
        for rank in range(nprocs):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _main(target: str, tmp: str, device: str, threads: str) -> None:
    import torch
    import torch.distributed as dist

    from psalm_tpu_torch.parallel.mesh import init_distributed
    torch.set_num_threads(int(threads))
    init_distributed(device)
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        with open(os.path.join(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        result = fn(*args)
        with open(os.path.join(tmp, f"result-{dist.get_rank()}.pkl"),
                  "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(*sys.argv[1:5])
