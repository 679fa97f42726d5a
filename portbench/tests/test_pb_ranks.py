"""The launcher of four-card cells (``portbench/ranks.py``) on the CPU: four
ranks under gloo run ``fourcard/``'s test-only kind (``fanout_exact``)
through ``cells.run_cell`` at a tiny size. Every rank sees the same units
and the same end; a rank that raises, stalls or loads JAX fails the run in
time with its own lines last; no child outlives the run or rank 0; the
result line gives four cards and the fullest one's peak; and a kind with
four-card cells joins every test parametrised over the cells by new files
and entries alone."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import pb_plants
import pb_tiny
from portbench import cells, manifest, ranks, traffic

FOUR = Path(__file__).resolve().parent / "fourcard"
CELL = "sift1m-hnsw32.fanout-tiny"
E2E = manifest.metrics_for(pb_tiny.MAN, "end_to_end", "sift1m-hnsw32.batch8k")


def _alive(pid: int) -> bool:
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def _gone(pids, within: float = 5.0) -> bool:
    end = time.monotonic() + within
    while time.monotonic() < end:
        if not any(_alive(p) for p in pids):
            return True
        time.sleep(0.1)
    return False


@pytest.fixture
def fanout(monkeypatch):
    """A tiny four-rank run of the test-only kind: ``run(plants)`` gives
    (result line, stderr lines); ``pids`` the children it started."""
    monkeypatch.setattr(traffic, "DIR", FOUR / "traffic")
    groups = []
    real_start = ranks._Group.start

    def start(self, payload):
        groups.append(self)
        real_start(self, payload)
    monkeypatch.setattr(ranks._Group, "start", start)

    class Run:
        @staticmethod
        def run(plants=(), seconds=1.0):
            monkeypatch.setattr(ranks, "PLANTS", list(plants))
            torch.set_num_threads(1)
            cfg = pb_tiny.tiny_config("sift1m-hnsw32")
            spec = pb_tiny.tiny_traffic("fanout-tiny")
            return cells.run_cell(CELL, cfg, spec, pb_tiny.SEED, seconds,
                                  False, "cpu", time.time(), E2E, [],
                                  chips=4)

        @property
        def pids(self):
            return [p for g in groups for p in g.pids]
    return Run()


def test_ranks_share_the_units_and_the_end(fanout):
    out, lines = fanout.run()
    assert out["correct"], lines
    assert out["checks"]["ranks_apart"]["value"] == 0
    seen = next(x for x in lines if x.startswith("units each rank saw"))
    counts = json.loads(seen.split(": ", 1)[1])
    assert len(counts) == 4 and len(set(counts)) == 1
    assert counts[0] == out["attempted"] + 2     # the warm unit and the -1
    assert out["device"]["count"] == 4
    assert len(fanout.pids) == 3 and _gone(fanout.pids, within=0.5)
    assert not torch.distributed.is_initialized()


def test_peak_is_the_fullest_cards(fanout, monkeypatch):
    pb_plants.peak_by_rank(monkeypatch.setattr)
    out, lines = fanout.run([pb_plants.peak_by_rank])
    assert out["correct"], lines
    assert out["device"]["memory_peak_bytes"] == 1030
    assert out["device"]["count"] == 4


@pytest.mark.parametrize("plant,code,words", [
    (pb_plants.raise_on_rank_1, 1, "planted: rank 1 fails"),
    (pb_plants.jax_on_rank_3, 3, "rank 3 loaded jax"),
], ids=["raises", "loads-jax"])
def test_a_failed_rank_fails_the_run(fanout, plant, code, words):
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure) as e:
        fanout.run([plant])
    assert time.monotonic() - t < ranks.TIMEOUT_S + 10
    assert e.value.code == code
    text = str(e.value)
    assert words in text
    # the failed rank's lines come last
    failed = text.rsplit("--- rank ", 1)[1]
    assert words in failed
    assert _gone(e.value.pids, within=0.5)
    assert not torch.distributed.is_initialized()


def test_a_stalled_rank_fails_the_run_in_time(fanout, monkeypatch):
    monkeypatch.setattr(ranks, "TIMEOUT_S", 10.0)
    t = time.monotonic()
    with pytest.raises(ranks.RankFailure) as e:
        fanout.run([pb_plants.sleep_on_rank_2])
    took = time.monotonic() - t
    assert 10.0 <= took < 10.0 + 10
    assert "planted: rank 2 sleeps past the timeout" in str(e.value)
    assert _gone(e.value.pids, within=0.5)


@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM],
                         ids=["kill", "term"])
def test_no_child_outlives_rank_0(sig):
    """Rank 0 waits forever in its first batch; it is killed, and its
    children end within a few seconds."""
    code = f"""
import sys, time
sys.path[:0] = [{str(Path(__file__).parent)!r}, {str(pb_tiny.ROOT)!r}]
import pb_plants, pb_tiny
from pathlib import Path
from portbench import cells, traffic
traffic.DIR = Path({str(FOUR / 'traffic')!r})
pb_plants.serve_forever(setattr)
cells.run_cell({CELL!r}, pb_tiny.tiny_config("sift1m-hnsw32"),
               pb_tiny.tiny_traffic("fanout-tiny"), 1, 5.0, False, "cpu",
               time.time(), [], [], chips=4)
"""
    p = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True)
    try:
        line = p.stdout.readline()
        assert line.startswith("PIDS"), line
        pids = [int(x) for x in line.split()[1:]]
        assert len(pids) == 3 and all(_alive(x) for x in pids)
        os.kill(p.pid, sig)
        p.wait(timeout=30)
        assert _gone(pids, within=5.0)
    finally:
        p.kill()
        p.wait()


def test_one_card_starts_no_process_and_no_group(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a one-card run launched ranks")
    monkeypatch.setattr(ranks, "launched", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    cell = next(w["name"] for w in pb_tiny.MAN["workloads"]
                if w["chips"] == 1)
    out, lines = pb_tiny.run(cell, seconds=0.5)
    assert out["correct"], lines
    assert out["device"]["count"] == 1
    assert not torch.distributed.is_initialized()


def test_manifest_refuses_four_card_faults():
    man = json.loads(json.dumps(pb_tiny.MAN))
    man["workloads"][0]["chips"] = 4
    man["workloads"][1]["chips"] = 4
    p = manifest.problems(man, pb_tiny.ROOT)
    # closed_batches has no follow(); two of four cells take four cards
    assert any("has no follow()" in x for x in p), p
    assert any("four-card cells" in x for x in p), p
    assert manifest.problems(pb_tiny.MAN, pb_tiny.ROOT) == []


def test_a_four_card_kind_joins_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark with ``fourcard/``'s runner, mix and reader
    added as files and its cell and metric as entries: the tests
    parametrised over the cells run it and pass, unedited."""
    root = tmp_path / "checkout"
    shutil.copytree(pb_tiny.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(pb_tiny.ROOT / "BENCHMARK.json", root)
    (root / "hnsw_tpu_torch").symlink_to(pb_tiny.ROOT / "hnsw_tpu_torch")
    for sub in ("traffic", "metrics"):
        for f in (FOUR / sub).glob("*.*"):
            if f.is_file():
                shutil.copy(f, root / "portbench" / sub / f.name)
    man = json.loads((root / "BENCHMARK.json").read_text())
    add = json.loads((FOUR / "entries.json").read_text())
    man["workloads"] += add["workloads"]
    man["per_layer"] += add["per_layer"]
    for m in man["end_to_end"]:
        if m["name"] in add["end_to_end"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "portbench/tests", "-k",
         "fanout-tiny or manifest_keeps or every_cell or every_metric"],
        cwd=root, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    summary = r.stdout.strip().splitlines()[-1]
    # control, correct, traced, 4 faults, the mix, 3 manifest checks
    assert " 11 passed" in f" {summary}", summary
