'''
The program's own spans (``mfrec_tpu_torch.utils.profiling``) beside a
traced window of one cell: each phase of set-up and of ``train()``, its
host time and how long the card sat idle inside it.

    python3 bench_torch/phases.py --workload <cell> --seed <n> --seconds <s>
    python3 bench_torch/phases.py --workload <cell> --reduced

The first sets the cell up and runs its window as ``run.py --trace 1``
does, with the program's recording on from the start.  The spans of
set-up are collected apart, on the host clock alone; the window's are
laid on the profiler's clock by the offset that placed the harness's own
spans there (its ``bench_anchor``).  Standard error gets one line a
phase,

    phase <name> calls <n> host_ms <mean> idle_ms <mean>

``calls`` the ``train()`` calls the phase ran in (set-up phases, named
``setup:<name>``, have no trace: ``idle_ms -``), the means a call; idle
is the span's time less the union of every device operation on any
stream.  The last line of standard output is a JSON object: the phases,
the quantities below, the ten longest idle gaps named by the innermost
span at their middle, and the cell's per-layer readers on the trace with
and without the program's spans.

- ``host_idle_ms.<m>``: idle inside a call's root span (``gd.train``,
  ``wrmf.train``) and outside its ``*.epochs`` child, mean a call;
- ``loop_idle_ms.<m>``: idle inside ``*.epochs``, mean a call;
- ``h2d_mb.<m>``: the ``h2d_bytes`` counter over the window's calls, MB
  a call;
- ``setup_layouts_s``: set-up seconds inside ``store.consolidate``,
  ``gd.layouts`` and ``wrmf.buckets`` (the union of their spans).

``<m>`` is the cell's rate metric's suffix (``sgd``, ``als``).  With
``--reduced`` it runs the cell at the rehearsal's size on the CPU and
prints the span tree of set-up and of one window call, with no device
number.
'''
import argparse
import json
import os
import sys
from bisect import bisect_left, bisect_right

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

LAYOUTS = ('store.consolidate', 'gd.layouts', 'wrmf.buckets')


class Busy:
    '''The union of the device's operations (us), asked for the busy time
    inside any interval.'''

    def __init__(self, ops):
        self.lo, self.hi, self.cum = [], [], [0.0]
        for a, b in sorted((a, b) for _, a, b, _ in ops if b > a):
            if self.hi and a <= self.hi[-1]:
                if b > self.hi[-1]:
                    self.cum[-1] += b - self.hi[-1]
                    self.hi[-1] = b
            else:
                self.lo.append(a)
                self.hi.append(b)
                self.cum.append(self.cum[-1] + b - a)

    def within(self, lo, hi):
        i = bisect_right(self.hi, lo)       # the first ending after lo
        j = bisect_left(self.lo, hi)        # past the last starting before hi
        if hi <= lo or i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, lo - self.lo[i])
                - max(0.0, self.hi[j - 1] - hi))

    def idle(self, lo, hi):
        return (hi - lo) - self.within(lo, hi)


def on_trace(tr, harness_items, spans):
    '''The ``DeviceTrace`` ``tr`` with the program's ``spans`` joined to
    its span list, placed on its clock by the offset that placed the
    harness's ``harness_items`` (``tr.spans`` holds them in that order);
    and the program's spans as (span, start us, end us).'''
    from lib.trace import DeviceTrace
    offset = tr.spans[0][2] - harness_items[0][2] / 1e3
    placed = [(s, s.start_ns / 1e3 + offset, s.end_ns / 1e3 + offset)
              for s in spans]
    joined = DeviceTrace(tr.ops, tr.launches, tr.spans + [
        (s.name, s.tid, a, b) for s, a, b in placed], tr.window)
    return joined, placed


def phase_table(placed, busy=None):
    '''{name: {'calls', 'host_ms', 'idle_ms'}}: per span name, the calls
    (root spans) it ran in and its time a call, summed over the call's
    spans of that name; idle None without ``busy``.'''
    per = {}
    for s, a, b in placed:
        host, idle = per.setdefault(s.name, {}).get(s.call, (0.0, 0.0))
        per[s.name][s.call] = (host + (b - a),
                               idle + (busy.idle(a, b) if busy else 0.0))
    out = {}
    for name, calls in per.items():
        n = len(calls)
        out[name] = {'calls': n,
                     'host_ms': sum(h for h, _ in calls.values()) / n / 1e3,
                     'idle_ms': (sum(i for _, i in calls.values()) / n / 1e3
                                 if busy else None)}
    return out


def program_metrics(placed, busy, counters, suffix):
    '''The window's ``host_idle_ms``, ``loop_idle_ms`` and ``h2d_mb``
    (means over its calls), the calls, and their idle in ms.'''
    roots = [p for p in placed if p[0].parent is None
             and p[0].name.endswith('.train')]
    host, loop = [], []
    for r, a, b in roots:
        inner = sum(busy.idle(x, y) for s, x, y in placed
                    if s.parent == r.id and s.name.endswith('.epochs'))
        host.append(busy.idle(a, b) - inner)
        loop.append(inner)
    n = len(roots)
    if not n:
        return {}, 0, 0.0
    return ({'host_idle_ms.' + suffix: sum(host) / n / 1e3,
             'loop_idle_ms.' + suffix: sum(loop) / n / 1e3,
             'h2d_mb.' + suffix: counters.get('h2d_bytes', 0) / n / 1e6},
            n, (sum(host) + sum(loop)) / 1e3)


def setup_layouts_s(spans):
    '''Seconds of set-up inside the layout and bucket spans (their
    union).'''
    from lib.yardstick import union_ms
    return union_ms([(s.start_ns, s.end_ns) for s in spans
                     if s.name in LAYOUTS]) / 1e9


def print_phases(table, prefix=''):
    for name, p in table.items():
        idle = '-' if p['idle_ms'] is None else repr(p['idle_ms'])
        print('phase %s%s calls %d host_ms %r idle_ms %s'
              % (prefix, name, p['calls'], p['host_ms'], idle),
              file=sys.stderr, flush=True)


def tree(spans, title):
    '''The span tree of ``spans``, indented by depth, on standard
    output.'''
    depth = {}
    print(title)
    for s in spans:
        depth[s.id] = depth.get(s.parent, -1) + 1
        print('  %s%s %.3f ms' % ('  ' * depth[s.id], s.name,
                                  (s.end_ns - s.start_ns) / 1e6))


def reduced(cell, cfg, mx, seed):
    '''The cell at the rehearsal's size on the CPU: the span trees.'''
    import torch
    from lib import harness, rehearse
    from mfrec_tpu_torch.utils import profiling
    torch.set_num_threads(2)
    cfg, mx = rehearse.reduced(cfg, mx)
    profiling.enable()
    drv = harness.runner(mx['kind']).Runner(cfg, mx, seed,
                                            torch.device('cpu'))
    drv.setup()
    tree(profiling.collect().spans, 'set-up of %s (CPU, reduced)'
         % cell['name'])
    drv.window(float(mx.get('rehearse_seconds', 1.0)), False)
    spans = profiling.collect().spans
    profiling.disable()
    first = [s for s in spans if s.call == spans[0].call]
    tree(first, 'one window call of %s (CPU, reduced)' % cell['name'])
    return 0


def measure(bench, cell, cfg, mx, seed, seconds, device):
    '''Set the cell up and run its traced window with the program's
    recording on; the phase lines on standard error, the result as a
    dict.'''
    from lib import harness, readers
    from mfrec_tpu_torch.utils import profiling
    profiling.enable()
    drv = harness.runner(mx['kind']).Runner(cfg, mx, seed, device)
    drv.setup()
    setup = profiling.collect()
    out = drv.window(seconds, True)
    window = profiling.collect()
    profiling.disable()
    drv.release()
    tr = out['trace']
    joined, placed = on_trace(tr, drv.spans.items, window.spans)
    busy = Busy(tr.ops)
    suffix = cfg['train']['rate_metric'].rsplit('.', 1)[-1]
    metrics, calls, call_idle_ms = program_metrics(
        placed, busy, window.counters, suffix)
    metrics['setup_layouts_s'] = setup_layouts_s(setup.spans)
    setup_table = phase_table([(s, s.start_ns / 1e3, s.end_ns / 1e3)
                               for s in setup.spans])
    table = phase_table(placed, busy)
    print_phases(setup_table, 'setup:')
    print_phases(table)
    window_idle_ms = busy.idle(*tr.window) / 1e3
    ctx = {'counters': out['counters'], 'cfg': cfg, 'mix': mx,
           'work': drv.work}
    read = {}
    for name, trace in (('plain', tr), ('joined', joined)):
        read[name] = {m['name']: harness.reader(m['name'])(
            dict(ctx, trace=trace))
            for m in harness.metrics_of(bench, cell, 'per_layer')}
    return {'workload': cell['name'], 'seed': seed, 'calls': calls,
            'window_s': tr.window_s,
            'idle_share': readers.idle_share({'trace': tr}),
            'metrics': metrics,
            'idle_in_calls_share': (100.0 * call_idle_ms / window_idle_ms
                                    if window_idle_ms else None),
            'window_idle_ms': window_idle_ms, 'calls_idle_ms': call_idle_ms,
            'idle_gaps': joined.breakdown()['idle_gaps'],
            'phases': table, 'setup_phases': setup_table,
            'window_counters': window.counters,
            'setup_counters': setup.counters, 'readers': read}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, default=1)
    ap.add_argument('--seconds', type=float, default=45.0)
    ap.add_argument('--reduced', action='store_true')
    args = ap.parse_args(argv)
    from lib import harness
    bench = harness.benchmark()
    cell = harness.cell_of(bench, args.workload)
    cfg = harness.config(cell['config'])
    mx = harness.mix(cell['traffic'])
    if args.reduced:
        return reduced(cell, cfg, mx, args.seed)
    harness.require_cards(int(cell['chips']))
    import torch
    res = measure(bench, cell, cfg, mx, args.seed, args.seconds,
                  torch.device('cuda'))
    res['device'] = torch.cuda.get_device_name(0)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
