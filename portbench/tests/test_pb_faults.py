"""A run with the timed path broken underneath comes out as not correct,
once for each fault a cell can have (its runner's ``FAULTS``, planted on
every rank): for the search cells a step that returns its state unchanged,
half of the batch left out, and an answer altered where it is produced;
for the ingest cell an ``add()`` that does nothing, adds half, or alters a
row. (The cells so far run on one card: no exchange between chips to
leave out.)"""

import pytest

import pb_tiny
from portbench import ranks

CASES = [(c, f) for c in pb_tiny.CELLS for f in pb_tiny.runner(c).FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    plant = pb_tiny.runner(cell).FAULTS[fault]
    plant(monkeypatch.setattr)
    monkeypatch.setattr(ranks, "PLANTS", [plant])
    out, lines = pb_tiny.run(cell, seconds=1.0)
    assert out["correct"] is False, lines
