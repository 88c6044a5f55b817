"""Spans and counters of one job, recorded where the work happens.

A job (``run_fast``, ``run``, ``run_sharded_fused``, ``run_sharded``)
opens its recording with ``job(stats)``; inside it

    with spans.span("index.parse", file=i):
        ...
    spans.count("fasta.parses")

record a span (its name, its start and end on ``time.perf_counter_ns``,
the index of its parent, a few integer attributes) and add to a counter
(``gauge`` sets one instead: a reading taken once a job).
At the job's end the recording is handed out as ``stats["spans"]`` (one
dict a span, in the order they opened: ``name``, ``start_ns``,
``end_ns``, ``parent``, -1 for the ``job`` span, and ``attrs``) and
``stats["counters"]``; ``seconds`` sums a span's durations in the open
job or in a finished job's ``stats``.  With no job open every call does nothing, so the
pipeline's pieces run alone as before.

Tracing is on while a torch profiler is active in the process (the
CLI's ``--profile``, or any ``torch.profiler.profile`` around the job),
checked once a span.  Then every span also enters a profiler range of
its name (``profiler_range``), which places it on the profiler's clock
beside the device's kernels and copies, and ``tracing()`` lets a caller
count what costs device work to count (``add_device``: a 0-d device
tensor summed on the device and read once, at the job's end).  With tracing off a span costs two clock reads and an
append: no range, no device operation, no read.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
# The range a span enters while a profiler runs: a function-scope
# ``record_function``.  It sits on the profiler's clock and nests as
# ``torch.profiler.record_function``'s user-scope ranges do, but the
# profiler does not mirror it onto the device's timeline as an annotation
# around the kernels it launched (a trace reader that goes by the event's
# device would take such a mirror for device work), and it costs less:
# ~2 us against ~17 us a range, timed on one x86-64 host core.
profiler_range = torch._C._profiler._RecordFunctionFast


class _Recording:
    """One job's spans (the dicts handed out as ``stats["spans"]``), the
    indices of the open ones, its counters, its device counters (0-d
    tensors) and the keys of its distinct counters."""

    def __init__(self):
        self.spans: List[dict] = []
        self.open: List[int] = []
        self.counters: Dict[str, int] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.distinct: Dict[str, set] = {}


_CURRENT: contextvars.ContextVar[Optional[_Recording]] = \
    contextvars.ContextVar("fastani_tpu_torch_spans", default=None)


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Span:
    __slots__ = ("rec", "row", "rf")

    def __init__(self, rec: _Recording, name: str, attrs: dict):
        self.rec = rec
        self.row = {"name": name, "start_ns": 0, "end_ns": 0,
                    "parent": rec.open[-1] if rec.open else -1,
                    "attrs": attrs}
        self.rf = profiler_range(name) if _profiling() else None

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        rec = self.rec
        rec.open.append(len(rec.spans))
        rec.spans.append(self.row)
        self.row["start_ns"] = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.row["end_ns"] = time.perf_counter_ns()
        self.rec.open.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager recording the block as span ``name`` of the open
    job, with integer ``attrs``; with no job open, a context that does
    nothing."""
    rec = _CURRENT.get()
    return _NULL if rec is None else _Span(rec, name, attrs)


def count(name: str, n: int = 1, by_span: bool = False) -> None:
    """Add ``n`` to counter ``name``; ``by_span`` also to
    ``name[innermost open span]``."""
    rec = _CURRENT.get()
    if rec is None:
        return
    c = rec.counters
    c[name] = c.get(name, 0) + n
    if by_span and rec.open:
        key = f"{name}[{rec.spans[rec.open[-1]]['name']}]"
        c[key] = c.get(key, 0) + n


def gauge(name: str, value: int) -> None:
    """Set counter ``name`` to ``value``: the job's last call holds."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.counters[name] = int(value)


def distinct(name: str, key) -> None:
    """Counter ``name`` counts the distinct ``key``s given in the job."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.distinct.setdefault(name, set()).add(key)


def tracing() -> bool:
    """Whether a job is open and a torch profiler active: the condition
    for counting what costs device work (``add_device``)."""
    return _CURRENT.get() is not None and _profiling()


def add_device(name: str, value: torch.Tensor) -> None:
    """Add the 0-d device tensor ``value`` to device counter ``name``,
    on the device; the job reads it once, at its end."""
    rec = _CURRENT.get()
    if rec is not None:
        prev = rec.device.get(name)
        rec.device[name] = value if prev is None else prev + value


def seconds(name: str, stats: Optional[dict] = None) -> float:
    """The summed seconds of the closed spans ``name`` of a finished job's
    ``stats``, or without ``stats`` of the open job (0.0 with none)."""
    if stats is None:
        rec = _CURRENT.get()
        sp = rec.spans if rec is not None else ()
    else:
        sp = stats.get("spans", ())
    return sum(s["end_ns"] - s["start_ns"] for s in sp
               if s["name"] == name and s["end_ns"]) / 1e9


@contextlib.contextmanager
def job(stats: dict):
    """Record the block as one job, under a ``job`` span, and hand its
    spans and counters out into ``stats`` at its end.  A job opened
    inside another records apart and restores the outer one."""
    rec = _Recording()
    token = _CURRENT.set(rec)
    try:
        with span("job"):
            yield
    finally:
        _CURRENT.reset(token)
        c = rec.counters
        if rec.device:
            names = list(rec.device)
            vals = torch.stack([rec.device[k] for k in names]).tolist()
            for k, v in zip(names, vals):
                c[k] = c.get(k, 0) + int(v)
        for k, keys in rec.distinct.items():
            c[k] = len(keys)
        stats["spans"] = rec.spans
        stats["counters"] = c
