"""The traced job: ``torch.profiler`` over one whole job, read in memory
(no Chrome export), with the port's phases wrapped from outside as
ranges, so that each idle gap of the device is named by what the host
was doing.

Copied from ``chip_smoke.trace_summary``: kernels by name, their summed
device time, the top kernels.  Changed: the device's busy time is the
union of the intervals of its operations (kernels, copies, sets), so that
operations overlapping on several streams cannot hide idle time.

``L2Work`` counts, in the traced job, the work that the L2 chunks were
given, from the map step's own buffers and configuration.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

# the port's phases wrapped as ranges in the traced job: (module path,
# attribute); a class is wrapped at its __init__
RANGES = (
    ("fastani_tpu_torch.models.pipeline", "reference_index"),
    ("fastani_tpu_torch.models.pipeline", "FragmentStream"),
    ("fastani_tpu_torch.models.pipeline", "tuned_mapper"),
    ("fastani_tpu_torch.models.pipeline", "map_queries_cgi_device"),
    ("fastani_tpu_torch.models.pipeline", "write_results"),
)
JOB_RANGE = "anibench.job"
# the map step's loop over a batch's L2 chunks under CUDA graphs: (module,
# class, method), called with the step and the batch's chunk count once
# the batch's units are located
CHUNK_LOOP = ("fastani_tpu_torch.models.jitmap", "StepGraphs",
              "replay_chunks")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def wrapped_ranges():
    """Each of RANGES runs inside a ``record_function`` range named by its
    attribute, for the duration of the block."""
    import importlib
    import functools

    from torch.profiler import record_function

    undo = []

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    try:
        for mod_name, attr in RANGES:
            mod = importlib.import_module(mod_name)
            obj = getattr(mod, attr)
            if isinstance(obj, type):
                orig = obj.__init__
                obj.__init__ = wrap(orig, attr)
                undo.append((obj, "__init__", orig))
            else:
                setattr(mod, attr, wrap(obj, attr))
                undo.append((mod, attr, obj))
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


class L2Work:
    """The L2 stage's work in the traced job, counted before each batch's
    chunks run from the step's buffers (``bufs``) and configuration
    (``cfg``): the chunk launches; on the device, the live units, their
    index entries (each unit's window ``eL - b0``, at most the entry cap)
    and their fragments' sketch hashes."""

    def __init__(self):
        self.launches = 0
        self.sums = None

    def note(self, step, n: int) -> None:
        import torch

        cfg, b = step.cfg, step.bufs
        U = cfg.unit_cap
        live = b["u_valid"][:U]
        ent = (b["eL"][:U] - b["b0"][:U]).clamp(0, cfg.l2_entry_cap)
        sk = b["s"][b["u_frag"][:U].long()]
        v = torch.stack([live.sum(), torch.where(live, ent, 0).sum(),
                         torch.where(live, sk, 0).sum()])
        self.sums = v if self.sums is None else self.sums + v
        self.launches += n

    def result(self):
        """{launches, units, entries, sketch}, or None when no chunk loop
        ran (the eager path: no graphs)."""
        if self.sums is None:
            return None
        units, entries, sketch = (int(x) for x in self.sums.tolist())
        return {"launches": self.launches, "units": units,
                "entries": entries, "sketch": sketch}


@contextlib.contextmanager
def counting_l2(work: L2Work):
    """``work`` notes every chunk loop of CHUNK_LOOP for the duration of
    the block."""
    import importlib

    mod, cls, attr = CHUNK_LOOP
    owner = getattr(importlib.import_module(mod), cls)
    orig = getattr(owner, attr)

    def counted(self, n):
        work.note(self, n)
        return orig(self, n)

    setattr(owner, attr, counted)
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(device_ops, ranges, window, top: int = 10) -> dict:
    """A traced job's numbers.  ``device_ops``: (name, start ns, end ns) of
    every device operation; ``ranges``: (name, start, end) of the host's
    wrapped ranges; ``window``: (start, end) of the job.  Returns the
    window's and the busy union's seconds, the operations' summed seconds
    and launches by name, the top operations and the longest idle gaps,
    each named by the innermost range the host was in at its middle."""
    w0, w1 = window
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device_ops
           if e > w0 and s < w1]
    busy = union([(s, e) for _, s, e in ops])
    by_name: Dict[str, List[float]] = {}
    for n, s, e in ops:
        t = by_name.setdefault(n, [0.0, 0])
        t[0] += (e - s) / 1e9
        t[1] += 1
    gaps, prev = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    inner = sorted(ranges, key=lambda r: r[2] - r[1])

    def host_at(t):
        for n, s, e in inner:
            if s <= t <= e:
                return n
        return "outside the wrapped phases"

    named: Dict[str, float] = {}
    for s, e in gaps:
        key = host_at((s + e) // 2)
        named[key] = named.get(key, 0.0) + (e - s) / 1e9
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "by_name": by_name,
        "device_ops": sorted(([n, t] for n, (t, _) in by_name.items()),
                             key=lambda x: -x[1])[:top],
        "idle_gaps": [[f"{host_at((s + e) // 2)} @"
                       f"{(s - w0) / 1e9:.3f}s", (e - s) / 1e9]
                      for s, e in longest],
        "idle_by_range": named,
    }


def read_profile(prof) -> Tuple[list, list, tuple]:
    """(device operations, host ranges, job window) of a stopped
    ``torch.profiler.profile``, from its raw events: device operations
    are the card's kernels, copies and sets (not the ranges the profiler
    mirrors onto the card's timeline)."""
    names = {attr for _, attr in RANGES}
    dev, ranges, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        t = (s, s + e.duration_ns())
        kind = str(e.activity_type()) if hasattr(e, "activity_type") else ""
        on_card = "CUDA" in str(e.device_type())
        if on_card:
            if (kind in DEVICE_ACTIVITIES if kind
                    else name not in names and name != JOB_RANGE):
                dev.append((name, *t))
        elif name == JOB_RANGE:
            window = t
        elif name in names:
            ranges.append((name, *t))
    return dev, ranges, window
