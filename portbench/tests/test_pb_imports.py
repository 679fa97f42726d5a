"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program. Top-level module names are
compared whole: the program's name begins with the JAX package's."""

import ast
import json
import subprocess
import sys

import pb_tiny

PB = pb_tiny.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "hnsw_tpu"}
PROGRAM = "hnsw_tpu_torch"


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax():
    for path in (list(PB.glob("*.py")) + list(PB.glob("metrics/*.py"))
                 + list(PB.glob("traffic/*.py"))):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "data.py"):
        assert PROGRAM not in _imports(PB / name)
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference;"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))" % str(pb_tiny.ROOT))
    mods = set(json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[-1]))
    assert PROGRAM not in mods and not mods & FORBIDDEN


def test_a_whole_run_loads_no_jax():
    """A tiny traced run of every cell in a fresh process, then the
    harness's own check of ``sys.modules``."""
    code = f"""
import sys
sys.path.insert(0, {str(pb_tiny.ROOT / 'portbench' / 'tests')!r})
import pb_tiny
for cell in pb_tiny.CELLS:
    out, _ = pb_tiny.run(cell, trace=True, seconds=0.5)
    assert out["correct"], cell
sys.path.insert(0, {str(PB)!r})
import run
print("LOADED", run.loaded_forbidden())
print("PROGRAM", "{PROGRAM}" in sys.modules)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "LOADED []" in r.stdout
    assert "PROGRAM True" in r.stdout      # the run did drive the program


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    r = subprocess.run([sys.executable, str(PB / "run.py"), "--workload",
                        pb_tiny.CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       cwd=pb_tiny.ROOT, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
