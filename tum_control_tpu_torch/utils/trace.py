"""Host spans at the port's layer boundaries: the program's one tracer.

    from tum_control_tpu_torch.utils.trace import span
    with span("tc.step"):
        ...

A span records its name, its start and end on `time.perf_counter_ns` and
its parent (the span open around it on the same thread). A span opened
while none is open on its thread starts a record: one closed-loop step
(`tc.step`) or one served cycle (`tc.cycle`, which carries the cycle's
index), and every span inside it belongs to that record. Names start with
`tc.`.

Storage is bounded and in memory; nothing is written to disk. For each of
the last RECORDS records it keeps the outermost span's name, the record's
index and every name's total duration and calls; the raw spans of the last
RAW_RECORDS records are kept for inspection. `snapshot()` returns both,
`reset()` clears them, and `median_ms` reduces a snapshot to one number per
layer (the benchmark's per-layer readers, benchmark/metrics/).

While a torch.profiler session is active, a span also opens
`torch.profiler.record_function(name)`, so its interval sits in the Chrome
trace beside the device's kernels, on the trace's clock; with none active it
opens none. The tracer makes no CUDA call, records no event and never
synchronises, so a span may sit around a region that a CUDA graph captures
or replays (spans inside a replayed region do not fire).

On by default: a span costs two clock reads and a few list updates on the
host. `set_enabled(False)` turns every span into a no-op.
"""
from __future__ import annotations

import collections
import statistics
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "tc."
RECORDS = 4096     # records whose per-name totals are kept
RAW_RECORDS = 8    # records whose raw spans are kept

_clock = time.perf_counter_ns


class _Open(threading.local):
    """One thread's open spans (their positions) and its current record's
    index and spans, each [name, start_ns, end_ns, parent's position]."""

    def __init__(self):
        self.stack, self.spans, self.index = [], [], -1


class Tracer:
    def __init__(self):
        self.enabled = True
        self._open = _Open()
        self.reset()

    def reset(self):
        """Forget every finished record; a record open now is kept when it
        closes."""
        self.records = collections.deque(maxlen=RECORDS)  # (root, index, {name: (dur_ns, calls)})
        self.raw = collections.deque(maxlen=RAW_RECORDS)  # (index, spans)

    def open(self, name: str, index: int):
        if not name.startswith(PREFIX):
            raise ValueError(f"span names start with '{PREFIX}': {name!r}")
        th = self._open
        if th.stack:
            parent = th.stack[-1]
        else:
            parent, th.spans, th.index = -1, [], index
        th.stack.append(len(th.spans))
        sp = [name, 0, 0, parent]
        th.spans.append(sp)
        sp[1] = _clock()

    def close(self):
        t1 = _clock()
        th = self._open
        th.spans[th.stack.pop()][2] = t1
        if th.stack:
            return
        totals = {}
        for name, t0, t1, _ in th.spans:
            dur, calls = totals.get(name, (0, 0))
            totals[name] = (dur + t1 - t0, calls + 1)
        self.records.append((th.spans[0][0], th.index, totals))
        self.raw.append((th.index, [tuple(sp) for sp in th.spans]))

    def snapshot(self) -> dict:
        """The finished records, oldest first. `records`: (root, index,
        totals) with root the outermost span's name, index the one it was
        given (-1: none) and totals {name: (dur_ns, calls)}. `spans`: the
        last RAW_RECORDS records as (index, [(name, start_ns, end_ns,
        parent)]), parent the position of the parent span in that list, -1
        for the root."""
        return dict(records=list(self.records), spans=list(self.raw))


TRACER = Tracer()


class span:
    """One span named `name` (a `tc.` name) around a `with` block; `index`
    is the record's index (a served cycle's) where the span starts one."""

    __slots__ = ("name", "index", "_on", "_fn")

    def __init__(self, name: str, index: int = -1):
        self.name, self.index, self._on, self._fn = name, index, False, None

    def __enter__(self):
        if TRACER.enabled:
            TRACER.open(self.name, self.index)
            self._on = True
            if _profiler._is_profiler_enabled:
                self._fn = torch.profiler.record_function(self.name)
                self._fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            fn, self._fn = self._fn, None
            fn.__exit__(*exc)
        if self._on:
            self._on = False
            TRACER.close()
        return False


def set_enabled(on: bool):
    """Turn every span on or off (on by default)."""
    TRACER.enabled = bool(on)


def snapshot() -> dict:
    return TRACER.snapshot()


def reset():
    TRACER.reset()


def median_ms(snap: dict, root: str, names, minus=()):
    """The median, over the snapshot's records whose outermost span is
    `root` and that call one of `names`, of the summed durations of `names`
    less those of `minus`, in ms; None where no record does."""
    total = lambda tot, ns: sum(tot[n][0] for n in ns if n in tot)
    ms = [1e-6 * (total(tot, names) - total(tot, minus))
          for r, _, tot in snap["records"] if r == root and any(n in tot for n in names)]
    return statistics.median(ms) if ms else None
