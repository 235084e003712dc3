"""The check that decides `correct`, driven through a whole run on the
CPU with the chip's look skipped: a sound run passes the cell's limits,
a run with a fault planted in the program's round or in a few layers'
attention backward fails them, and the control (the reference in the
program's place at float8) fails them."""
from __future__ import annotations

import contextlib

import pytest
import torch

from bench import check, control, harness, run
from bench.conftest import cell_names


def _run(cell, fault=None):
    driver = cell.driver
    call = driver.Round.__call__
    if fault in control.FAULTS:
        driver.Round.__call__ = control.planted(fault, call)
    try:
        with (control.kernel_fault(fault) if fault in control.KERNEL_FAULTS
              else contextlib.nullcontext()):
            line, readings = run.run_cell(cell, 2 ** 36 + 11, 0.0, False,
                                          torch.device("cpu"), 0.0)
    finally:
        driver.Round.__call__ = call
    return line, readings


@pytest.mark.parametrize("name", cell_names())
def test_a_sound_float32_run_is_correct(name, tiny):
    line, _ = _run(tiny(name, "float32"))
    assert line["correct"], line["checked"]


@pytest.mark.parametrize("fault", control.FAULTS)
@pytest.mark.parametrize("name", cell_names())
def test_a_fault_in_the_round_is_not_correct(name, fault, tiny):
    line, _ = _run(tiny(name, "float32"), fault)
    assert not line["correct"], line["checked"]


@pytest.mark.parametrize("fault", control.KERNEL_FAULTS)
@pytest.mark.parametrize("name", [
    n for n in cell_names()
    if control.has_full_attention(harness.load_cell(n))])
def test_a_fault_in_a_few_layers_is_not_correct(name, fault, tiny):
    cell = tiny(name, "float32")
    line, readings = _run(cell, fault)
    assert not line["correct"], line["checked"]
    # the medians alone would pass it: the worst moved leaf catches it
    assert readings["delta_gap_median"] < \
        cell.limits["delta_gap_median"]["limit"] < readings["delta_gap_moved"]


@pytest.mark.parametrize("name", cell_names())
def test_the_control_is_not_correct(name, tiny):
    cell = tiny(name)
    ref = cell.driver.reference_rounds(cell, 7, torch.device("cpu"))
    ctl = cell.driver.reference_rounds(cell, 7, torch.device("cpu"),
                                       "float8_e4m3")
    ok, checked = check.verdict(
        check.readings(control.as_program(ctl), ref), cell.limits)
    assert not ok, checked
