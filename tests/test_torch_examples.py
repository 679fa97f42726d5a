"""The port's four examples (examples/torch_*.py) run end to end on the
CPU at a small n, each in a process of its own that never imports jax."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each example's arguments: sizes small enough for the kernels' plain
# PyTorch versions on the host
EXAMPLES = {"torch_quickstart": ["--n", "600", "--nq", "64"],
            "torch_quantized_pipeline": ["--n", "1200", "--nq", "64"],
            "torch_serving_loop": ["--n", "600"],
            "torch_sharded_mesh": ["--n", "800", "--nq", "64"]}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_cpu(name):
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hnsw_tpu'] = None\n"
            "import torch\n"
            "torch.set_num_threads(1)\n"
            f"sys.argv = {[name, '--device', 'cpu'] + EXAMPLES[name]}\n"
            f"runpy.run_path('examples/{name}.py', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert res.stdout.strip()
