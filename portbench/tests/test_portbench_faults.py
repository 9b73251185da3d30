"""The comparison that decides ``correct`` can fail: on the CPU at a tiny
size, a whole run of each tiny cell with the program sound reads correct,
and with the control (the reference in TF32 in the program's place) or a
fault planted in the timed path (portbench/faults.py) reads not correct."""

import pytest

from portbench_tiny import CELLS, make_tree, run_cell

SEED = 2**33 + 5  # more than 32 bits, as a run's seed can be


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return make_tree(tmp_path_factory.mktemp("portbench_faults"))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_program_is_correct(tree, cell):
    r = run_cell(tree, cell, SEED)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(tree, cell):
    r = run_cell(tree, cell, SEED, fault="control")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("tiny.fit", "altered"),
    ("tiny.train", "unchanged"), ("tiny.train", "half_batch"), ("tiny.train", "altered"),
    ("tiny.train", "scaled_grad"),
    ("tinybreath.train", "unchanged"), ("tinybreath.train", "half_batch"),
    ("tinybreath.train", "altered"), ("tinybreath.train", "scaled_grad"),
])
def test_fault_is_not_correct(tree, cell, fault):
    r = run_cell(tree, cell, SEED, fault=fault)
    assert not r["correct"], (fault, r["checks"])
