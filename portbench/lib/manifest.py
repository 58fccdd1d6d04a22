"""The benchmark's manifest (``BENCHMARK.json``) and the files it names.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by name:

* ``configs/<config>.json``: the deployment; its ``deployment`` names
  ``deployments/<deployment>.py``, which makes the system under test;
* ``traffic/<traffic>.json``: the mix; its ``load`` names
  ``loads/<load>.py``, which offers the load and checks the answers;
* ``metrics/<metric>.py``: the reader of one per-layer metric.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # portbench/
ROOT = HERE.parent                                   # the checkout
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def metrics_of(manifest: dict, section: str, cell: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell ``cell`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell in m["workloads"]]


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(manifest: dict, root: Path = ROOT) -> list[str]:
    """What in ``manifest`` breaks the benchmark's rules on names, units,
    keys and cross-references (empty when it is sound)."""
    out = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(manifest) != keys:
        out.append(f"top-level keys {sorted(manifest)}")
    names = {}
    for section, allowed in (
            ("configs", {"name", "source", "file", "reduced", "why"}),
            ("workloads", {"name", "config", "traffic", "chips", "why"}),
            ("end_to_end", {"name", "unit", "better", "bound", "source",
                            "workloads"}),
            ("per_layer", {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"})):
        for e in manifest.get(section, []):
            if not set(e) <= allowed:
                out.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            n = e.get("name", "")
            if not NAME.match(n):
                out.append(f"{section}: bad name {n!r}")
            group = "metrics" if section in ("end_to_end",
                                             "per_layer") else section
            if n in names.setdefault(group, set()):
                out.append(f"{section}: duplicate name {n!r}")
            names[group].add(n)
            if "unit" in e and not UNIT.match(e["unit"]):
                out.append(f"{n}: bad unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{n}: better {e['better']!r}")
            if "source" in e and section != "configs" \
                    and e["source"] not in SOURCES:
                out.append(f"{n}: source {e['source']!r}")
            for key in ("why", "layer"):
                v = e.get(key)
                if v is not None and not (1 <= len(v) <= 200
                                          and "\n" not in v
                                          and "\t" not in v):
                    out.append(f"{n}: {key} of {len(v)} characters")
    cells = {w["name"] for w in manifest.get("workloads", [])}
    configs = {c["name"] for c in manifest.get("configs", [])}
    e2e = {m["name"]: m for m in manifest.get("end_to_end", [])}
    for c in manifest.get("configs", []):
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        if not any(w["config"] == c["name"] for w in manifest["workloads"]):
            out.append(f"config {c['name']} is used by no cell")
        for key in c.get("reduced", []):
            if not NAME.match(key):
                out.append(f"config {c['name']}: reduced key {key!r}")
    for w in manifest.get("workloads", []):
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: unknown config {w['config']}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").is_file():
            out.append(f"cell {w['name']}: no traffic {w['traffic']}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips {w['chips']}")
        reported = [m["name"] for m in metrics_of(manifest, "end_to_end",
                                                  w["name"])]
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"cell {w['name']}: end-to-end {reported}")
        if not metrics_of(manifest, "per_layer", w["name"]):
            out.append(f"cell {w['name']}: no per-layer metric")
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in manifest.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"{m['name']}: end-to-end source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']}")
    for m in manifest.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves unknown {m['moves']}")
        if not (HERE / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"{m['name']}: no reader file")
        for cell in m.get("workloads", sorted(cells)):
            if cell not in cells:
                out.append(f"{m['name']}: unknown cell {cell}")
            elif m["moves"] not in [x["name"] for x in metrics_of(
                    manifest, "end_to_end", cell)]:
                out.append(f"{m['name']}: cell {cell} does not report "
                           f"{m['moves']}")
    return out
