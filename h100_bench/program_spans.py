"""What the per-layer metrics of the program's own spans read from a traced
window (``common.Trace``): the card's idle time given to the stage the host
was in, and the runtime calls made inside a stage.

The program opens its spans (``psalm_tpu_torch/spans.py``) through
``torch.profiler.record_function`` under the names ``psalm::<stage>``, so
they are CPU events of the trace, on the clock of the device's intervals.
The readers work on the thread that opened the cell's top span
(``runner.infer`` or ``train.step``) and inside the top spans' extent
only. Each stretch of time in which the card is idle (covered by none of
``trace.intervals``) goes to the innermost ``psalm::`` span open on that
thread at that moment; a share is that time over ``trace.window_s``, in %.
So the shares of all the spans of a cell add up to the device's idle share
less the idle that fell while the host was outside the top spans (between
calls, in the final synchronize).

A reader gives None where none of its spans is in the window, so that a
renamed or removed span fails the run (``run.py`` refuses a declared
metric that reads nothing).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from h100_bench.common import merged

PREFIX = "psalm::"


class Split:
    """The program's spans on the top span's thread inside the top spans,
    and the card's idle seconds under each span name as the innermost."""

    def __init__(self, trace, top: str):
        own = [e for e in trace.cpu_events if e.name.startswith(PREFIX)]
        tops = [e for e in own if e.name == PREFIX + top]
        self.thread = min(tops, key=lambda e: e.time_range.start).thread \
            if tops else None
        extent = merged((e.time_range.start, e.time_range.end)
                        for e in tops if e.thread == self.thread)
        starts = [a for a, _ in extent]

        def inside(t: float) -> bool:
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t < extent[i][1]

        self.spans: List[Tuple[float, float, str]] = sorted(
            ((e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
             for e in own
             if e.thread == self.thread and inside(e.time_range.start)),
            key=lambda s: (s[0], -s[1]))
        self.names = {name for _, _, name in self.spans}
        self.idle_s: Dict[str, float] = {}
        busy = _Busy(trace.intervals)
        for a, b, name in _innermost(self.spans):
            idle = (b - a) - busy.within(a, b)
            self.idle_s[name] = self.idle_s.get(name, 0.0) + idle / 1e6

    def extent(self, names) -> List[Tuple[float, float]]:
        """The time inside any span of ``names``, as disjoint intervals."""
        return merged((a, b) for a, b, n in self.spans if n in names)


def _innermost(spans):
    """[(start, end, name)] sorted by start (outer first at a tie), each
    inside the one before it or after it -> [(a, b, name)]: the stretches
    of time each with the innermost span open over it. A span that ends
    after the one around it (the clocks' rounding) is cut at its end."""
    out, stack, cursor = [], [], None
    for start, end, name in spans:
        while stack and stack[-1][1] <= start:
            _, top_end, top_name = stack.pop()
            out.append((cursor, top_end, top_name))
            cursor = top_end
        if stack:
            out.append((cursor, start, stack[-1][2]))
            end = min(end, stack[-1][1])
        cursor = start
        stack.append((start, end, name))
    while stack:
        _, top_end, top_name = stack.pop()
        out.append((cursor, top_end, top_name))
        cursor = top_end
    return [(a, b, n) for a, b, n in out if b > a]


class _Busy:
    """Time covered by disjoint sorted intervals between two instants."""

    def __init__(self, intervals):
        self.starts = [a for a, _ in intervals]
        self.ends = [b for _, b in intervals]
        self.before = [0.0]  # covered time before interval i starts
        for a, b in intervals:
            self.before.append(self.before[-1] + b - a)

    def until(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return self.before[i] - max(0.0, self.ends[i - 1] - t)

    def within(self, a: float, b: float) -> float:
        return self.until(b) - self.until(a)


def split(trace, top: str) -> Split:
    """The trace's ``Split`` for the top span ``top``, computed once."""
    cache = trace.__dict__.setdefault("_program_spans", {})
    if top not in cache:
        cache[top] = Split(trace, top)
    return cache[top]


def matches(name: str, patterns) -> bool:
    """Whether a span name is one of ``patterns``, where ``model.*`` stands
    for every name that begins with ``model.``."""
    return any(name == p or (p.endswith(".*") and name.startswith(p[:-1]))
               for p in patterns)


def idle_share(trace, top: str, *patterns: str) -> Optional[float]:
    """100 x the card's idle seconds given to the spans that ``patterns``
    name (``matches``), over the window."""
    s = split(trace, top)
    if trace.window_s <= 0 or not any(matches(n, patterns) for n in s.names):
        return None
    idle = sum(v for n, v in s.idle_s.items() if matches(n, patterns))
    return 100.0 * idle / trace.window_s


def calls_per(trace, top: str, span: str, calls, unit: str
              ) -> Optional[float]:
    """The runtime calls named in ``calls`` that the top span's thread made
    inside the span ``span`` (at any depth under it), per
    ``trace.work[unit]``."""
    s = split(trace, top)
    per = trace.work.get(unit)
    if not per or span not in s.names:
        return None
    extent = s.extent({span})
    starts = [a for a, _ in extent]
    n = 0
    for e in trace.cpu_events:
        if e.name in calls and e.thread == s.thread:
            t = e.time_range.start
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t < extent[i][1]
    return n / per


#: where ``calls_by_span`` counts a call the top span's thread made outside
#: the top spans
OUTSIDE = "(outside)"


def calls_by_span(trace, top: str, calls) -> Dict[str, int]:
    """The runtime calls named in ``calls`` that the top span's thread made,
    counted under the innermost span open at each (``OUTSIDE`` where no top
    span was open)."""
    s = split(trace, top)
    if s.thread is None:
        return {}
    atoms = _innermost(s.spans)
    starts = [a for a, _, _ in atoms]
    out: Dict[str, int] = {}
    for e in trace.cpu_events:
        if e.name in calls and e.thread == s.thread:
            t = e.time_range.start
            i = bisect.bisect_right(starts, t) - 1
            name = atoms[i][2] if i >= 0 and t < atoms[i][1] else OUTSIDE
            out[name] = out.get(name, 0) + 1
    return out
