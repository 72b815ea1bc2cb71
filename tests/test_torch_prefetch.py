"""The port's data/prefetch.py: a copy of psalm_tpu's ``PrefetchLoader``
held equal to the original outside its import lines, and tests/
test_prefetch.py's four cases on the copy (the port's sampler and collate):
the synchronous order, disjoint shard streams, overlap of the mapper work,
and a mapper's error raised in the consumer."""

import ast
import inspect
import time

import numpy as np
import pytest

import psalm_tpu.data.prefetch as jprefetch
import psalm_tpu_torch.data.prefetch as tprefetch
from psalm_tpu_torch.data.datasets import UnifiedTaskSampler, collate
from psalm_tpu_torch.data.prefetch import PrefetchLoader
from test_prefetch import SlowToyDataset
from test_torch_serve_stack import _ImportsAsJax


def test_copy_equals_original_outside_imports():
    want = ast.dump(ast.parse(inspect.getsource(jprefetch)))
    tree = _ImportsAsJax().visit(ast.parse(inspect.getsource(tprefetch)))
    assert ast.dump(tree) == want
    assert "from psalm_tpu_torch.data.datasets import" in \
        inspect.getsource(tprefetch)


def _samplers(seed=3):
    dss = [SlowToyDataset(13, "panoptic"), SlowToyDataset(7, "referring")]
    return (UnifiedTaskSampler(dss, batch_size=4, seed=seed),
            UnifiedTaskSampler(dss, batch_size=4, seed=seed))


def test_prefetch_matches_synchronous_order():
    s_sync, s_async = _samplers()
    want = [collate(s_sync.next_batch()) for _ in range(10)]
    with PrefetchLoader(s_async, collate, num_workers=3,
                        num_batches=10) as loader:
        got = list(loader)
    assert len(got) == 10
    for w, g in zip(want, got):
        assert set(w) == set(g)
        for k in w:
            np.testing.assert_array_equal(np.asarray(w[k]), np.asarray(g[k]))


def test_prefetch_sharded_streams_stay_disjoint():
    dss = [SlowToyDataset(16, "panoptic")]
    loaders, seen = [], []
    for shard in range(2):
        s = UnifiedTaskSampler(dss, batch_size=2, seed=0,
                               shard_index=shard, num_shards=2)
        loaders.append(PrefetchLoader(s, collate, num_workers=2,
                                      num_batches=4))
    for ld in loaders:
        ids = np.concatenate([b["input_ids"][:, 0] for b in ld])
        seen.append(set(ids.tolist()))
        ld.close()
    assert seen[0].isdisjoint(seen[1])  # one epoch: disjoint shard streams


def test_prefetch_overlaps_mapper_work():
    """4 workers + prefetch over a 30 ms/sample mapper: wall time for 6
    batches of 4 must come in well under the serial 6*4*30 ms = 720 ms."""
    dss = [SlowToyDataset(64, "panoptic", delay=0.03)]
    s = UnifiedTaskSampler(dss, batch_size=4, seed=0)
    with PrefetchLoader(s, collate, num_workers=4, prefetch_batches=2,
                        num_batches=6) as loader:
        next(loader)          # pipeline warm
        t0 = time.perf_counter()
        rest = list(loader)
        dt = time.perf_counter() - t0
    assert len(rest) == 5
    assert dt < 0.55, f"no overlap: {dt:.3f}s for 5 batches"


def test_prefetch_propagates_mapper_errors():
    class Exploding(SlowToyDataset):
        def __getitem__(self, idx):
            if idx == 5:
                raise ValueError("boom at 5")
            return super().__getitem__(idx)

    s = UnifiedTaskSampler([Exploding(8, "panoptic")], batch_size=4, seed=0)
    loader = PrefetchLoader(s, collate, num_workers=2, num_batches=4)
    with pytest.raises(ValueError, match="boom at 5"):
        for _ in range(4):
            next(loader)
    loader.close()
