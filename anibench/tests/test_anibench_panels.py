"""The panels: the same seed gives byte-equal FASTA, another seed
differs; the checked pairs and the warm-up queries."""

import pathlib

from anibench import panels

CFG = {"genomes": 6, "genome_bp": 20000, "clusters": 2,
       "sub_rate": [0.01, 0.05], "indel_rate": 0.0002, "frag_len": 3000}


def _bytes(panel):
    return [pathlib.Path(p).read_bytes() for p in panel.refs + panel.queries]


def test_same_seed_same_bytes_other_seed_differs(tmp_path):
    seed = 2**31 + 977
    for traffic in ({"queries": "panel"},
                    {"queries": "new_strains", "new_strains": 1}):
        a = panels.make_panel(CFG, traffic, seed, tmp_path / "a")
        b = panels.make_panel(CFG, traffic, seed, tmp_path / "b")
        c = panels.make_panel(CFG, traffic, seed + 1, tmp_path / "c")
        assert _bytes(a) == _bytes(b)
        assert all(x != y for x, y in zip(_bytes(a), _bytes(c)))
        assert a.ref_species == [0, 0, 0, 1, 1, 1]


def test_jobs_and_checked_pairs(tmp_path):
    seed = 5
    cfg = dict(CFG, genomes=12, clusters=3)
    p = panels.make_panel(cfg, {"queries": "panel"}, seed, tmp_path)
    assert p.job_argv("o.tsv")[:2] == ["--ql", p.query_list]
    traffic = {"queries": "panel", "check_reported_pairs": 20,
               "check_strains": 3}
    pairs = panels.check_sample(p, traffic, seed)
    assert pairs == panels.check_sample(p, traffic, seed)
    g = list(dict.fromkeys(q for q, _ in pairs))
    assert len(pairs) == len(g) ** 2 and set(pairs) == {
        (a, b) for a in g for b in g}
    # 3 strains of each of 3 species (27 same-species pairs >= 20), the
    # species in the panel's order
    sp = [p.ref_species[p.refs.index(x)] for x in g]
    assert sp == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    # one species of 12: strains spread over it, one in each third
    one = panels.make_panel(dict(cfg, clusters=1), {"queries": "panel"},
                            seed, tmp_path / "one")
    g1 = list(dict.fromkeys(q for q, _ in panels.check_sample(
        one, traffic, seed)))
    idx = sorted(one.refs.index(x) for x in g1)
    assert [i // 4 for i in idx] == [0, 1, 2]
    assert panels.warmup_queries(p, cfg, 2048) == p.queries
    assert panels.warmup_queries(p, cfg, 12) == p.queries[:2]
    assert panels.warmup_queries(p, dict(cfg, genome_bp=3_000_000),
                                 2048) == p.queries[:3]

    o = panels.make_panel(cfg, {"queries": "new_strains",
                                "new_strains": 1}, seed, tmp_path / "o")
    assert o.job_argv("o.tsv")[:2] == ["-q", o.queries[0]]
    pairs = panels.check_sample(o, {"queries": "new_strains",
                                    "check_other": 3}, seed)
    sp = [o.ref_species[o.refs.index(r)] for _, r in pairs]
    # every reference of the strain's species, and 3 of the others
    assert sp.count(o.query_species[0]) == 4 and len(pairs) == 7
