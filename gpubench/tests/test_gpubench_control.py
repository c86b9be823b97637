"""The control, at a size a test run holds: the reference put in the
program's place and computed in the precision below the configuration's
(fp8 for bfloat16) must come out not correct under each cell's limits,
and so must each fault its driver plants in the reference."""

import pytest
import torch

from conftest import cell_names, driver_of, tiny_files
from gpubench import checks, harness
from gpubench.control import BELOW

CELLS = cell_names()
#: {fault: the cells whose driver plants it in the reference}
REFERENCE_FAULTS = {}
for _name in CELLS:
    for _fault in getattr(driver_of(_name), "REFERENCE_FAULTS", ()):
        REFERENCE_FAULTS.setdefault(_fault, []).append(_name)


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


@pytest.mark.parametrize("fault", REFERENCE_FAULTS)
def test_train_faults_in_the_reference_are_not_correct(fault):
    for name in REFERENCE_FAULTS[fault]:
        run, work = _run(name)
        driver = harness.load_module("drivers", work["driver"])
        values = driver.control(run, "float32", fault)
        assert not checks.judge(values, work["limits"]), (name, values)


def test_reference_in_its_own_place_is_exact():
    run, work = _run("granite-3-2b.train")
    driver = harness.load_module("drivers", work["driver"])
    values = driver.control(run, "float32")
    assert values == {"loss_gap": 0.0, "grad_gap": 0.0, "update_gap": 0.0}
