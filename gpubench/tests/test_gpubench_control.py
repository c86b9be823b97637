"""The control, at a size a test run holds: the reference put in the
program's place and computed in the precision below the configuration's
(fp8 for bfloat16) must come out not correct under each cell's limits,
and so must each fault planted in it for the training cell."""

import pytest
import torch

from conftest import cell_names, tiny_files
from gpubench import checks, harness
from gpubench.control import BELOW, TRAIN_FAULTS

CELLS = cell_names()


def _run(name, seed=3):
    _, work, cfg = tiny_files(name)
    return harness.Run(name, work, cfg, seed, 1.0, False, torch.device("cpu"),
                       ""), work


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    run, work = _run(name)
    driver = harness.load_module("drivers", work["driver"])
    values = driver.control(run, BELOW[run.cfg["torch_dtype"]])
    assert not checks.judge(values, work["limits"]), values


@pytest.mark.parametrize("fault", TRAIN_FAULTS)
def test_train_faults_in_the_reference_are_not_correct(fault):
    run, work = _run("granite-3-2b.train")
    driver = harness.load_module("drivers", work["driver"])
    values = driver.control(run, "float32", fault)
    assert not checks.judge(values, work["limits"]), values


def test_reference_in_its_own_place_is_exact():
    run, work = _run("granite-3-2b.train")
    driver = harness.load_module("drivers", work["driver"])
    values = driver.control(run, "float32")
    assert values == {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
