'''The checks that decide ``correct`` must fail where they should.  On
the CPU at the rehearsal's size, with the program's plain versions:

* the control (the reference one precision below the configuration's,
  put in the program's place) reads over the cell's limits;
* a run driven with the timed path broken underneath comes out not
  correct, once for each fault the cell can have (its runner's
  ``FAULTS``; for training, a step that returns its state unchanged and
  half of the batch left out, the mean taken over the rest).

    python -m pytest bench_torch/tests -q
'''
import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import harness, rehearse  # noqa: E402

CELLS = {c['name']: c for c in harness.benchmark()['workloads']}


def readings(name, seed=3):
    cell = CELLS[name]
    cfg, mix = rehearse.reduced(harness.config(cell['config']),
                                harness.mix(cell['traffic']))
    drv = harness.runner(mix['kind']).Runner(cfg, mix, seed, rehearse.CPU)
    drv.setup()
    drv.window(float(mix.get('rehearse_seconds', 1.0)), False)
    drv.release()
    return drv


def correct(name, values):
    return harness.compare(values, harness.limits(name))[0]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize('name', sorted(CELLS))
def test_control_is_not_correct(name):
    drv = readings(name)
    assert not correct(name, drv.faults()['control'])


def faults(name):
    '''The faults a cell can have: its runner's ``FAULTS``.'''
    return harness.runner(harness.mix(CELLS[name]['traffic'])['kind']).FAULTS


@pytest.mark.parametrize('name,fault', [
    (n, f) for n in sorted(CELLS) for f in faults(n)],
    ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    drv = readings(name)
    assert not correct(name, drv.check())
