"""Shared by the readers of the program's own spans and counters: the
traced jobs' ``stats["spans"]`` (name, ``start_ns``, ``end_ns``, the
index of the ``parent``) and ``stats["counters"]``, which
``fastani_tpu_torch/utils/spans.py`` hands out at a job's end.  A job
without spans (a program that records none) gives no reading."""


def recorded(ctx):
    """The jobs read that hold spans."""
    return [j for j in ctx.get("jobs", []) if j.get("spans")]


def span_seconds(job, *names):
    """The seconds of the job's spans named in ``names``, a span inside
    another of them counted once, by the outer one; a span's children
    are inside its time."""
    spans, names = job["spans"], set(names)
    ns = 0
    for s in spans:
        if s["name"] not in names:
            continue
        p = s["parent"]
        while p >= 0 and spans[p]["name"] not in names:
            p = spans[p]["parent"]
        if p < 0:
            ns += s["end_ns"] - s["start_ns"]
    return ns / 1e9


def mean_span_seconds(ctx, *names):
    """``span_seconds`` of ``names``, the mean over the jobs with spans;
    None when none has spans."""
    jobs = recorded(ctx)
    if not jobs:
        return None
    return sum(span_seconds(j, *names) for j in jobs) / len(jobs)


def counter_sums(ctx, *names):
    """Each counter of ``names`` summed over the jobs with spans; None
    when none has spans or a counter is missing from one of them."""
    jobs = recorded(ctx)
    if not jobs or any(n not in j.get("counters", {}) for j in jobs
                       for n in names):
        return None
    return [sum(j["counters"][n] for j in jobs) for n in names]
