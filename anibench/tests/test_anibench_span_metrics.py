"""The readers of the program's own spans and counters on a synthetic
``stats`` dict: the sums of spans by name, a span inside another of the
summed names counted once and its children inside its time, the counter
ratios, the mean over jobs, and no reading from a job without spans."""

import pytest

from anibench.manifest import Manifest

NEW = ("index_parse_s", "query_plan_s", "batch_make_s", "map_wait_s",
       "fasta_parses_per_genome", "l2_fill_pct")
MS = 1_000_000


def _job(scale=1):
    """A job's spans as the program hands them out (name, start and end in
    ns, parent index), ``scale`` times every duration, and counters."""
    rows = [("job", 0, 100, -1),
            ("index_build", 0, 30, 0),
            ("index.parse", 0, 10, 1),
            ("index.flush", 10, 15, 1),
            ("index.overflow_read", 12, 14, 3),
            ("index.parse", 15, 22, 1),
            ("index.rebuild", 22, 30, 1),
            ("index.parse", 22, 25, 6),         # a rebuild's parse
            ("mapper_init", 30, 50, 0),
            ("query_plan", 31, 45, 8),
            ("map_loop", 50, 90, 0),
            ("batch", 50, 70, 10),
            ("batch.make", 50, 58, 11),
            ("query.load", 51, 57, 12),         # inside batch.make's time
            ("batch.upload", 58, 61, 11),
            ("batch.upload_wait", 59, 60, 14),
            ("batch.n_live_read", 61, 64, 11),
            ("map_finish", 70, 90, 10),
            ("map_finish.read", 70, 75, 17),
            ("redo", 75, 90, 17),
            ("batch.n_live_read", 80, 82, 19),  # a redone batch's read
            ("write", 90, 100, 0)]
    spans = [{"name": n, "start_ns": s * MS * scale, "end_ns": e * MS * scale,
              "parent": p, "attrs": {}} for n, s, e, p in rows]
    counters = {"fasta.parses": 404, "fasta.files": 101,
                "l2.window_entries": 3000, "l2.event_slots": 10000}
    return {"spans": spans, "counters": counters, "t_index_build": 0.03}


def _read(name, jobs):
    return Manifest().metric_reader(name).read({"jobs": jobs, "trace": None})


def test_span_sums():
    jobs = [_job()]
    # three parses, the rebuild's included
    assert _read("index_parse_s", jobs) == pytest.approx(0.020)
    assert _read("query_plan_s", jobs) == pytest.approx(0.014)
    # the load is inside the make's time: not added again
    assert _read("batch_make_s", jobs) == pytest.approx(0.008)
    # upload wait 1, live reads 3 + 2, the finish's read 5
    assert _read("map_wait_s", jobs) == pytest.approx(0.011)


def test_a_span_inside_another_summed_one_counts_once():
    job = _job()
    # a live read inside the finish's read: its time is the outer one's
    job["spans"][20]["parent"] = 18
    job["spans"][20].update(start_ns=71 * MS, end_ns=73 * MS)
    assert _read("map_wait_s", [job]) == pytest.approx(0.009)


def test_counter_ratios_and_the_mean_over_jobs():
    jobs = [_job(), _job(scale=3)]
    assert _read("fasta_parses_per_genome", jobs) == pytest.approx(4.0)
    assert _read("l2_fill_pct", jobs) == pytest.approx(60.0)
    assert _read("query_plan_s", jobs) == pytest.approx(0.028)
    jobs[1]["counters"].update({"fasta.parses": 203, "fasta.files": 101})
    assert _read("fasta_parses_per_genome", jobs) == pytest.approx(607 / 202)


@pytest.mark.parametrize("name", NEW)
def test_no_reading_without_spans(name):
    # the parent program hands out no spans or counters
    assert _read(name, [{"t_index_build": 1.0}]) is None
    assert _read(name, []) is None
    # a job whose counters lack what a ratio reads
    job = _job()
    job["counters"] = {}
    if name in ("fasta_parses_per_genome", "l2_fill_pct"):
        assert _read(name, [job]) is None
    else:
        assert _read(name, [job]) is not None
    job["counters"] = {"l2.window_entries": 0, "l2.event_slots": 0,
                       "fasta.parses": 0, "fasta.files": 0}
    if name in ("fasta_parses_per_genome", "l2_fill_pct"):
        assert _read(name, [job]) is None


def test_manifest_entries_of_the_new_readers():
    man = Manifest()
    cells = [w["name"] for w in man.data["workloads"]]
    entries = {m["name"]: m for m in man.data["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == cells and m["moves"] == "pairs_per_s"
        reader = man.metric_reader(name)
        assert reader.LAYER == m["layer"] and reader.MOVES == m["moves"]
    assert [m["name"] for m in man.data["per_layer"]][-len(NEW):] == \
        list(NEW)
