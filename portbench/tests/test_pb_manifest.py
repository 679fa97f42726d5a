"""BENCHMARK.json against the contract's rules on its own form, and the
files it names."""

import json

import pb_tiny
from portbench import manifest, traffic


def test_manifest_keeps_the_rules():
    assert manifest.problems(pb_tiny.MAN, pb_tiny.ROOT) == []


def test_names_and_units():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in pb_tiny.MAN[section]:
            assert manifest.NAME.fullmatch(e["name"]), e["name"]
            if "unit" in e:
                assert manifest.UNIT.fullmatch(e["unit"]), e["unit"]


def test_bad_names_refused():
    man = json.loads(json.dumps(pb_tiny.MAN))
    man["per_layer"][0]["name"] = "two words"
    man["end_to_end"][0]["unit"] = "queries per second"
    man["workloads"][0]["chips"] = 2
    p = manifest.problems(man, pb_tiny.ROOT)
    assert any("two words" in x for x in p)
    assert any("unit" in x for x in p)
    assert any("chips" in x for x in p)


def test_every_cell_finds_its_files():
    for w in pb_tiny.MAN["workloads"]:
        cfg = manifest.config(pb_tiny.MAN, w["config"], pb_tiny.ROOT)
        assert cfg["name"] == w["config"]
        for key in ("n", "d", "m", "k", "ef_search", "ef_construction",
                    "dtype", "capacity", "limits", "data"):
            assert key in cfg, (w["config"], key)
        traffic.load(w["traffic"])
    for c in pb_tiny.MAN["configs"]:
        cfg = json.loads((pb_tiny.ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert cfg["source"] == c["source"]
