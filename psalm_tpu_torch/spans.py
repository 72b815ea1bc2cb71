"""The program's spans: named ranges at the layer boundaries of the eval
runner, the model forward and the training step, recorded through
``torch.profiler`` so that they sit in its trace, on the clock of the
device's kernels.

``span(name)`` is ``record_function("psalm::" + name)`` while a profiler
records on this thread, and one shared null context otherwise: a closed
span costs a check of the profiler's state and no more. A span does no
tensor work, waits for nothing and allocates nothing on the device; it
leaves the process only in the profiler's own output (a Chrome trace of
``train.py --profile_steps``, or whatever the caller reads from the
profiler).

No span opens inside a function that ``torch.utils.checkpoint`` runs
again in the backward (Phi's decoder layers, the pixel decoder's encoder
layers): the recompute would open it a second time, on the autograd
engine's thread. ``PERF.md`` lists the spans and the metrics that read
them; a renamed span renames its metric.
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "psalm::"
_CLOSED = contextlib.nullcontext()


def span(name: str):
    """A context manager over the range ``psalm::<name>`` while a profiler
    records; the shared null context otherwise."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(PREFIX + name)
    return _CLOSED


def spanned(name: str):
    """Decorator: the whole call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
