"""The control: the reference computed one precision below float32 (TF32
operands), in the program's place, has to come out as not correct; the
program at the same tiny size comes out correct."""

import pytest
import torch

import pb_tiny
from portbench import manifest, traffic


def _cell(name):
    cell = manifest.cell(pb_tiny.MAN, name)
    return (pb_tiny.tiny_config(cell["config"]),
            pb_tiny.tiny_traffic(cell["traffic"]))


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_control_fails(cell):
    torch.set_num_threads(1)
    cfg, spec = _cell(cell)
    v = traffic.runner(spec["kind"]).control(cfg, spec, pb_tiny.SEED, "cpu",
                                             rows=1500, seconds=1.0)
    failed = {n for n, val, op, lim in v.items
              if not v._holds(val, op, lim)}
    assert set(traffic.runner(spec["kind"]).CONTROL_FAILS) <= failed
    assert not v.correct


@pytest.mark.parametrize("cell", pb_tiny.CELLS)
def test_program_correct(cell):
    out, lines = pb_tiny.run(cell)
    assert out["correct"], lines


@pytest.mark.cuda
def test_control_on_the_card():
    """The control of the sq8 batch cell at a small size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, spec = _cell("deep1m-hnsw32-sq8.batch8k")
    v = traffic.runner(spec["kind"]).control(cfg, spec, pb_tiny.SEED,
                                             "cuda")
    assert not v.correct
