"""Each cell's checks on the CPU at a small size: a sound run is correct, and
a run with a fault planted under the timed path (``portbench.faults``) is
not: a step that returns its state unchanged, half of the batch left out,
an answer altered where it is produced. (One chip runs every cell, so no
cell has an exchange between chips to leave out.)"""
import pytest

from portbench.faults import FAULTS

from .cells import run_small

CELLS = ("hope_sac.eval_dlp1k",)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tmp_path, workload):
    line = run_small(tmp_path, workload)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(tmp_path, workload, fault):
    line = run_small(tmp_path, workload, fault=fault)
    assert not line["correct"], line["checks"]
