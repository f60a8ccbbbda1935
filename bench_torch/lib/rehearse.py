'''
The rehearsal: every cell's path on the CPU at a reduced size, with the
program's plain versions, and the yardstick's arithmetic against
hand-worked cases.  It prints each cell's check readings and no device
metric.  It also shows that the chip path refuses to run without a card.
'''
from __future__ import annotations

import copy
import subprocess
import sys
import time

import torch

from lib import harness

CPU = torch.device('cpu')


def reduced(cfg, mix):
    '''A copy of ``cfg`` and ``mix`` at the rehearsal's size.'''
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    cfg['data'].update(users=300, items=120, ratings=6000,
                       activity={'floor': 5, 'sigma': 1.35, 'cap': 100})
    p = cfg['parameters']
    p['nbr_features'] = 16
    if 'inner_steps' in p:
        p.update(inner_steps=8, batch_size=512)
    for key, small in mix.get('rehearse', {}).items():
        mix[key] = small
    return cfg, mix


def cell_readings(cell, seed=1):
    cfg, mix = reduced(harness.config(cell['config']),
                       harness.mix(cell['traffic']))
    drv = harness.runner(mix['kind']).Runner(cfg, mix, seed, CPU)
    t0 = time.perf_counter()
    drv.setup()
    out = drv.window(float(mix.get('rehearse_seconds', 1.0)), False)
    drv.release()
    readings = drv.check()
    print('rehearse %s: %d attempted, %d failed, %.1f s; readings %s'
          % (cell['name'], out['attempted'], out['failed'],
             time.perf_counter() - t0, readings), flush=True)
    return drv, readings


def no_card_refused():
    '''The chip path, run where no card is, exits non-zero and prints no
    result.'''
    bench = harness.benchmark()
    name = bench['workloads'][0]['name']
    p = subprocess.run([sys.executable, harness.os.path.join(
        harness.HERE, 'run.py'), '--workload', name, '--seed', '1',
        '--seconds', '1', '--trace', '0'], capture_output=True, text=True,
        env=dict(harness.os.environ, CUDA_VISIBLE_DEVICES=''))
    ok = p.returncode != 0 and not p.stdout.strip()
    print('rehearse: the chip path without a card exits %d, stdout %r: %s'
          % (p.returncode, p.stdout.strip()[-80:], 'ok' if ok else 'WRONG'),
          flush=True)
    return ok


def main():
    torch.set_num_threads(2)
    from tests import test_yardstick
    failed = test_yardstick.run_all()
    for cell in harness.benchmark()['workloads']:
        cell_readings(cell)
    ok = no_card_refused() and not failed
    return 0 if ok else 1
