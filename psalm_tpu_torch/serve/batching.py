"""Static request batching for the serving worker.

Counterpart of ``psalm_tpu/serve/batching.py``, as it is (threads and
numpy): it drives any generator with ``generate(batch, max_new_tokens=,
temperature=, eos_id=, stream=, chunk_size=)``, here
``psalm_tpu_torch.models.generation.Generator``.

Decode throughput is HBM-bound on the weight reads, so B concurrent
sequences decode at nearly the cost of one (the weights are read once per
step regardless of B). The reference worker (model_worker.py:122-192)
serves one request at a time; this layer groups waiting requests that
share a padded-prompt bucket into one Generator.generate call and demuxes
the token stream back to per-request iterators.

Requests with different temperatures mix freely (per-sequence temperature
in models/generation.py); different max_new_tokens run to the group max
with per-request truncation; EOS is per-sequence inside generate().
"""

from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

import numpy as np


class _Request:
    __slots__ = ("batch", "max_new_tokens", "temperature", "out")

    def __init__(self, batch, max_new_tokens, temperature):
        self.batch = batch
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.out: "queue.Queue" = queue.Queue()


class BatchedGenerator:
    """Groups concurrent generate requests into batched decode calls.

    submit() returns an iterator of np scalar tokens for that request.
    max_batch=1 degenerates to pass-through (no added latency).
    """

    def __init__(self, generator, eos_id: Optional[int] = None,
                 max_batch: int = 4, window_s: float = 0.02,
                 chunk_size: int = 32):
        self.generator = generator
        self.eos_id = eos_id
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)
        self.chunk_size = chunk_size
        self._cv = threading.Condition()
        # shape-key -> FIFO of _Request (requests in one batch must share
        # padded shapes; the worker buckets pad_len so most chat traffic
        # lands in one key)
        self._pending: "OrderedDict[tuple, list]" = OrderedDict()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def _key(batch: Dict[str, np.ndarray]) -> tuple:
        return tuple(sorted((k, tuple(np.asarray(v).shape[1:]))
                            for k, v in batch.items()))

    def submit(self, batch: Dict[str, np.ndarray], max_new_tokens: int,
               temperature: float = 0.0) -> Iterator[np.ndarray]:
        """batch: single-sample arrays [1, ...]. Yields one np scalar token
        per decoded position for this request (already EOS-truncated)."""
        req = _Request(batch, max_new_tokens, temperature)
        with self._cv:
            self._pending.setdefault(self._key(batch), []).append(req)
            self._cv.notify()
        while True:
            tok = req.out.get()
            if tok is None:
                return
            yield tok

    # -- batching loop -------------------------------------------------------

    def _take_group(self):
        with self._cv:
            while not self._pending:
                self._cv.wait()
            key = next(iter(self._pending))
            group = self._pending.pop(key)
        if len(group) < self.max_batch and self.window_s > 0:
            time.sleep(self.window_s)  # let stragglers join this key
            with self._cv:
                extra = self._pending.pop(key, [])
            group.extend(extra)
        overflow = group[self.max_batch:]
        if overflow:
            with self._cv:
                self._pending.setdefault(key, [])[:0] = overflow
                self._cv.notify()
        return group[: self.max_batch]

    def _loop(self):
        while True:
            group = self._take_group()
            try:
                self._run(group)
            except Exception as e:  # noqa: BLE001 — fail the group, not the loop
                for r in group:
                    r.out.put(None)
                print(f"batched generate failed: {type(e).__name__}: {e}")

    def _run(self, group):
        keys = group[0].batch.keys()
        batch = {k: np.concatenate([np.asarray(r.batch[k]) for r in group])
                 for k in keys}
        temps = np.asarray([r.temperature for r in group], np.float32)
        budget = [r.max_new_tokens for r in group]
        emitted = [0] * len(group)
        done = [False] * len(group)

        def cb(tok_col):
            for i, r in enumerate(group):
                if done[i] or emitted[i] >= budget[i]:
                    continue
                tok = tok_col[i]
                emitted[i] += 1
                if self.eos_id is not None and int(tok) == self.eos_id:
                    done[i] = True
                    r.out.put(None)
                    continue
                r.out.put(tok)
                if emitted[i] >= budget[i]:
                    done[i] = True
                    r.out.put(None)

        self.generator.generate(
            batch, max_new_tokens=max(budget), temperature=temps,
            eos_id=self.eos_id, stream=cb, chunk_size=self.chunk_size)
        for i, r in enumerate(group):
            if not done[i]:
                r.out.put(None)
