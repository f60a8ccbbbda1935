'''
One run of one cell: find the cell's configuration, traffic mix, limits
and metric readers by name, set up, measure the window, read the traced
run, check the timed path's output against the plain reference, and
print the result.

Everything of one configuration, traffic mix or per-layer metric lives
in files of its own: ``configs/<config>.json``, ``traffic/<mix>.json``
(its ``kind`` names the general runner ``runners/<kind>.py`` that reads
it), ``limits/<cell>.json`` and ``metrics/<metric>.py``.  A runner
reports each end-to-end metric under the name ``BENCHMARK.json`` gives
it.
'''
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark():
    return load_json(ROOT, 'BENCHMARK.json')


def cell_of(bench, name):
    for w in bench['workloads']:
        if w['name'] == name:
            return w
    raise SystemExit('no workload %r in BENCHMARK.json' % name)


def config(name):
    return load_json(HERE, 'configs', name + '.json')


def mix(name):
    return load_json(HERE, 'traffic', name + '.json')


def limits(cell_name):
    return load_json(HERE, 'limits', cell_name + '.json')


def load(folder, name):
    '''The module ``<folder>/<name>.py``.'''
    path = os.path.join(HERE, folder, name + '.py')
    spec = importlib.util.spec_from_file_location(
        'bench_%s_%s' % (folder, name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    '''The reader of ``metric``: ``metrics/<metric>.py``'s ``read(ctx)``.'''
    return load('metrics', metric).read


def runner(kind):
    '''The general runner of the mixes of ``kind``: ``runners/<kind>.py``.'''
    return load('runners', kind)


def metrics_of(bench, cell, section):
    '''The cell's metrics of ``section`` ('end_to_end' or 'per_layer'):
    those that list it, or list no cells.'''
    return [m for m in bench[section]
            if cell['name'] in m.get('workloads', [cell['name']])]


def require_cards(chips):
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('bench: torch.cuda.is_available() is False: this '
                         'benchmark measures the card and runs nowhere else')
    if torch.cuda.device_count() < chips:
        raise SystemExit('bench: the cell asks for %d cards, %d present'
                         % (chips, torch.cuda.device_count()))


def compare(readings, lim):
    '''``readings`` {name: value} against ``lim`` {name: limit}: (correct,
    [(name, value, limit)]).  A reading that is missing or not finite
    fails.'''
    rows, ok = [], True
    for name, limit in lim.items():
        v = readings.get(name)
        good = v is not None and v == v and abs(v) != float('inf') \
            and v <= limit
        ok = ok and good
        rows.append((name, v, limit))
    return ok, rows


def run(args, t_start):
    bench = benchmark()
    cell = cell_of(bench, args.workload)
    require_cards(int(cell['chips']))
    import torch
    cfg = config(cell['config'])
    mx = mix(cell['traffic'])
    lim = limits(cell['name'])
    drv = runner(mx['kind']).Runner(cfg, mx, int(args.seed),
                                    torch.device('cuda'))
    drv.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    out = drv.window(float(args.seconds), bool(args.trace))
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in range(int(cell['chips'])))
    device = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
              'count': int(cell['chips']), 'memory_peak_bytes': int(peak)}
    drv.release()
    gc.collect()
    torch.cuda.empty_cache()
    metrics = {}
    breakdown = None
    if args.trace:
        tr = out['trace']
        device['busy_s'] = tr.busy_s()
        device['window_s'] = tr.window_s
        ctx = {'trace': tr, 'counters': out['counters'], 'cfg': cfg,
               'mix': mx, 'work': drv.work}
        for m in metrics_of(bench, cell, 'per_layer'):
            v = reader(m['name'])(ctx)
            if v is not None:
                metrics[m['name']] = {'value': v, 'unit': m['unit']}
        breakdown = tr.breakdown()
    else:
        for m in metrics_of(bench, cell, 'end_to_end'):
            if m['name'] == 'setup_s':
                metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
            elif m['name'] in out['metrics']:
                metrics[m['name']] = {'value': out['metrics'][m['name']],
                                      'unit': m['unit']}
            else:
                raise SystemExit('bench: the %r runner reports no %r'
                                 % (mx['kind'], m['name']))
    t_check = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    readings = drv.check()
    print('bench: set-up %.2f s, window %.2f s, check %.2f s' % (
        setup_s, t_check - setup_s - t_start, time.perf_counter() - t_check),
        file=sys.stderr, flush=True)
    correct, rows = compare(readings, lim)
    for name, v, limit in rows:
        print('check %s %s limit %s' % (name, repr(v), repr(limit)),
              file=sys.stderr, flush=True)
    res = {'correct': bool(correct), 'attempted': int(out['attempted']),
           'failed': int(out['failed']), 'metrics': metrics,
           'device': device}
    if breakdown is not None:
        res['breakdown'] = breakdown
    res['checks'] = {name: {'value': v, 'limit': limit}
                     for name, v, limit in rows}
    print(json.dumps(res), flush=True)
    return 0
