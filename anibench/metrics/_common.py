"""Shared by the per-layer metric readers: a phase's mean over the jobs,
the traced device time of kernels by name, and the L2 work counted in
the traced job."""


def mean_stat(ctx, key):
    vals = [j[key] for j in ctx.get("jobs", []) if key in j]
    return sum(vals) / len(vals) if vals else None


def kernel_time(ctx, *funcs):
    """(launches, seconds) of the traced device operations whose name
    holds one of ``funcs``."""
    tr = ctx.get("trace")
    if not tr:
        return 0, 0.0
    n, t = 0, 0.0
    for name, (sec, cnt) in tr["by_name"].items():
        if any(f in name for f in funcs):
            n += cnt
            t += sec
    return n, t


def work_per_launch(ctx, traced_launches: int):
    """The counted L2 work (``trace.L2Work.result``) over all
    ``traced_launches`` K5 launches of the trace: the launches that no
    chunk loop counted take the counted ones' mean.  None when nothing
    was counted or traced."""
    w = ctx.get("l2_work")
    if not w or not w["launches"] or not traced_launches:
        return None
    f = max(traced_launches, w["launches"]) / w["launches"]
    return {k: w[k] * f for k in ("units", "entries", "sketch")}
