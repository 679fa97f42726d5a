"""``BENCHMARK.json``: loading it, finding a cell's configuration, traffic
and metrics by name, and the contract's rules on names, units and sizes."""

from __future__ import annotations

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def metrics_for(man: dict, section: str, cell_name: str) -> list[dict]:
    """The metrics of ``section`` that ``cell_name`` reports."""
    return [m for m in man[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def _runner(mix: str):
    """The runner of traffic mix ``mix``, or None where there is none."""
    from portbench import traffic
    try:
        return traffic.runner(traffic.load(mix)["kind"])
    except (OSError, ValueError, KeyError):
        return None


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def problems(man: dict, root: Path = ROOT) -> list[str]:
    """Where ``man`` breaks the contract's rules on its own form (empty
    when it keeps them)."""
    out = []
    if set(man) != TOP_KEYS:
        out.append(f"top-level keys {sorted(man)}")
    if not 1 <= len(man.get("paths", [])) <= 16 or not all(
            PATH.fullmatch(p) and ".." not in p.split("/")
            for p in man.get("paths", [])):
        out.append("paths")
    cmd = man.get("command", [])
    if not 1 <= len(cmd) <= 32 or not all(_line(w) for w in cmd) or any(
            w.startswith("/") or ".." in w.split("/") for w in cmd):
        out.append("command")
    rs = man.get("run_seconds")
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        out.append("run_seconds")
    names = {}
    for section, keys in KEYS.items():
        for e in man.get(section, []):
            extra = set(e) - keys - ({"workloads"} if section in (
                "end_to_end", "per_layer") else set())
            if extra or not keys <= set(e):
                out.append(f"{section} {e.get('name')}: keys {sorted(e)}")
            n = e.get("name", "")
            if not NAME.fullmatch(n):
                out.append(f"{section}: name {n!r}")
            kind = "metric" if section in ("end_to_end", "per_layer") \
                else section
            if (kind, n) in names:
                out.append(f"{section}: {n!r} twice")
            names[(kind, n)] = e
            if "unit" in e and not UNIT.fullmatch(e["unit"]):
                out.append(f"{n}: unit {e['unit']!r}")
            if "better" in e and e["better"] not in ("lower", "higher"):
                out.append(f"{n}: better")
            if "source" in e and section != "configs" and \
                    e["source"] not in SOURCES:
                out.append(f"{n}: source")
            for key in ("why", "layer"):
                if key in e and not _line(e[key]):
                    out.append(f"{n}: {key}")
    cfgs = {c["name"]: c for c in man.get("configs", [])}
    for c in cfgs.values():
        if not _line(c["source"]) or not all(NAME.fullmatch(k)
                                             for k in c["reduced"]) \
                or len(c["reduced"]) > 16:
            out.append(f"config {c['name']}: source or reduced")
        if not any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in man["paths"]) or not (root / c["file"]).exists():
            out.append(f"config {c['name']}: file {c['file']}")
    pairs = set()
    for w in man.get("workloads", []):
        if w["config"] not in cfgs or not NAME.fullmatch(w["traffic"]):
            out.append(f"workload {w['name']}: config or traffic")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']}: chips")
        elif w["chips"] > 1 and not hasattr(_runner(w["traffic"]), "follow"):
            out.append(f"workload {w['name']}: {w['chips']} chips, and its "
                       "kind's runner has no follow()")
    four = [w["name"] for w in man.get("workloads", []) if w["chips"] > 1]
    if len(four) > max(1, len(man.get("workloads", [])) // 4):
        out.append(f"{len(four)} four-card cells of "
                   f"{len(man['workloads'])}: at most a quarter, or one")
    e2e = {m["name"] for m in man.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man.get("end_to_end", []):
        if m["source"] not in ("host_clock", "device_trace") or not (
                0 < m["bound"] <= 0.25):
            out.append(f"{m['name']}: source or bound")
    cells = {w["name"] for w in man.get("workloads", [])}
    for m in man.get("end_to_end", []) + man.get("per_layer", []):
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"{m['name']}: workloads")
    for m in man.get("per_layer", []):
        if m["moves"] not in e2e:
            out.append(f"{m['name']}: moves")
    for w in man.get("workloads", []):
        n = w["name"]
        if not [m for m in metrics_for(man, "per_layer", n)]:
            out.append(f"{n}: no per-layer metric")
        if len(metrics_for(man, "end_to_end", n)) < 2:
            out.append(f"{n}: no end-to-end metric besides setup_s")
    if len(json.dumps(man).encode()) > 64 * 1024:
        out.append("size")
    return out
