"""BENCHMARK.json and the files it names keep the benchmark's rules."""
import json

import pytest

import _tiny
from portbench.lib import manifest as mf


def test_manifest_is_sound():
    assert mf.problems(mf.load()) == []


def test_each_name_resolves_to_a_file_of_its_own():
    m = mf.load()
    for c in m["configs"]:
        cfg = json.loads((_tiny.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert (mf.HERE / "deployments" / f"{cfg['deployment']}.py").is_file()
        assert cfg["check_limits"] and cfg["guarantees"]
    for w in m["workloads"]:
        mix = mf.traffic(w["traffic"])
        assert mix["name"] == w["traffic"]
        assert (mf.HERE / "loads" / f"{mix['load']}.py").is_file()
    for spec in m["per_layer"]:
        assert callable(mf.module("metrics", spec["name"]).read)


@pytest.mark.parametrize("name,ok", [("query_p95_ms", True),
                                     ("a.b-c_1", True), ("a b", False),
                                     ("a/b", False), ("", False),
                                     ("x" * 65, False)])
def test_name_rule(name, ok):
    assert bool(mf.NAME.match(name)) == ok


@pytest.mark.parametrize("unit,ok", [("ms", True), ("queries/s", True),
                                     ("%", True), ("GB", True),
                                     ("tokens per s", False),
                                     ("x" * 17, False)])
def test_unit_rule(unit, ok):
    assert bool(mf.UNIT.match(unit)) == ok


def test_problems_names_a_broken_manifest():
    m = mf.load()
    m["per_layer"] = [dict(m["per_layer"][0], moves="nope")]
    m["end_to_end"] = [dict(e, bound=0.5) for e in m["end_to_end"]]
    found = " ".join(mf.problems(m))
    assert "moves unknown" in found and "bound 0.5" in found
