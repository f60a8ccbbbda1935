'''The SVD++ cell's yardstick (``lib/svdpp_bound.py``) against hand-worked
cases, and its four readers on a hand-built trace: each reads its share
from the program's spans, and the two rooflines read nothing where the
program records no such span (a checkout without them).

    python -m pytest bench_torch/tests -q
'''
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import harness  # noqa: E402
from lib import svdpp_bound as sb  # noqa: E402
from lib import yardstick as ys  # noqa: E402
from lib.trace import reduce_events  # noqa: E402


def close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


# 1,000 user-side entries of 10 users in 12 segments over 50 items, k = 4
# factors (rows of 6 augmented), T = 2 sweeps; the item side the same n
SIDE = dict(n=1000, rows=10, segments=12, fixed_rows=50)
WORK = {'half_passes': [SIDE, dict(SIDE, rows=50, fixed_rows=10)],
        'k': 6, 'T': 2, 'k_factors': 4, 'svdpp': True}


def test_gather_and_error_work_by_hand():
    # phase 1: k adds an entry; the ids (4 n), the offsets (4 (segments +
    # 1)), the rows' triples (12 rows), the target both ways (8 k rows),
    # each Y row once (4 k fixed rows)
    ops, nbytes = sb.gather_agg_work(1000, 10, 12, 50, 4)
    assert ops == 4000
    assert nbytes == 4000 + 52 + 120 + 320 + 800
    # phase 4: 4 k + 7 an entry; ids, ratings, masks (12 n), the Peff
    # rows and the Qaug rows (k + 2 wide) once
    ops, nbytes = sb.error_agg_work(1000, 10, 12, 50, 4)
    assert ops == 23 * 1000
    assert nbytes == 12000 + 52 + 120 + 320 + 4 * 6 * 10 + 4 * 6 * 50


def test_epoch_bounds_by_hand():
    # both phases bound by bytes here: 5,292 and 13,932 bytes
    assert close(sb.agg_bound_s(WORK), (5292 + 13932) / ys.PEAK_BYTES)
    want = sum(ys.k1_bound(h['n'], h['rows'], h['segments'],
                           h['fixed_rows'], 6, 2, fix_bytes=4)[0]
               for h in WORK['half_passes']) / 1e3
    assert close(sb.half_pass_bound_s(WORK), want)
    # K1 with the fixed side in f32: 4 bytes a column of each fixed row
    t4, _ = ys.k1_bound(1e9, 10, 12, 1e6, 6, 1, fix_bytes=4)
    t2, _ = ys.k1_bound(1e9, 10, 12, 1e6, 6, 1, fix_bytes=2)
    assert t4 > t2
    # 4 k T an entry and sweep of each half-pass (k augmented), the
    # phases' 4 k + 23 k + 3 k an entry (k factors)
    assert sb.epoch_ops(WORK) == 2 * 4 * 6 * 2 * 1000 + 4000 + 23000 \
        + 12000


def _kernel(corr, launch_us, start_us, dur_us):
    return [{'name': 'cudaLaunchKernel', 'ph': 'X', 'cat': 'cuda_runtime',
             'ts': launch_us, 'dur': 1.0, 'tid': 7,
             'args': {'correlation': corr}},
            {'name': 'k%d' % corr, 'ph': 'X', 'cat': 'kernel',
             'ts': start_us, 'dur': dur_us, 'args': {'correlation': corr}}]


# host ns -> trace us: the anchor at host 1,000,000 ns is trace 500 us;
# the window 500 .. 700 us
EVENTS = ([{'name': 'bench_anchor', 'ph': 'X', 'cat': 'user_annotation',
            'ts': 500.0, 'dur': 1.0}]
          + _kernel(1, 511.0, 512.0, 4.0)      # in svdpp.aggregate
          + _kernel(2, 521.0, 522.0, 50.0)     # in svdpp.half_passes
          + _kernel(3, 581.0, 582.0, 6.0))     # in svdpp.aggregate
PROGRAM = [('svdpp.aggregate', 7, 1_010_000, 1_015_000),
           ('svdpp.half_passes', 7, 1_020_000, 1_030_000),
           ('svdpp.aggregate', 7, 1_080_000, 1_085_000)]


def _ctx(spans):
    tr = reduce_events(EVENTS, [('train', 7, 1_005_000, 1_190_000)] + spans,
                       (999_000, 1_001_000), (1_000_000, 1_200_000))
    return {'trace': tr, 'counters': {'calls': 2, 'epochs_a_call': 3},
            'work': lambda: WORK}


def test_readers_on_the_program_spans():
    ctx = _ctx(PROGRAM)
    read = {m: harness.reader(m)(ctx) for m in (
        'svdpp_agg_roofline', 'svdpp_half_pass_roofline', 'train_mfu.svdpp',
        'idle_share.svdpp')}
    # 6 epochs; the aggregate spans launched 4 + 6 us, the half-passes 50
    assert close(read['svdpp_agg_roofline'],
                 100.0 * 6 * sb.agg_bound_s(WORK) / 10e-6, 1e-9)
    assert close(read['svdpp_half_pass_roofline'],
                 100.0 * 6 * sb.half_pass_bound_s(WORK) / 50e-6, 1e-9)
    assert close(read['train_mfu.svdpp'],
                 100.0 * 6 * sb.epoch_ops(WORK) / ys.PEAK_F32_FLOPS / 200e-6,
                 1e-9)
    # busy 4 + 50 + 6 of the 200 us window
    assert close(read['idle_share.svdpp'], 70.0, 1e-9)


def test_rooflines_read_nothing_without_the_program_spans():
    ctx = _ctx([])
    assert harness.reader('svdpp_agg_roofline')(ctx) is None
    assert harness.reader('svdpp_half_pass_roofline')(ctx) is None
    # a cell of another model: nothing of SVD++ to read
    other = dict(_ctx(PROGRAM), work=lambda: {'half_passes': []})
    for m in ('svdpp_agg_roofline', 'svdpp_half_pass_roofline',
              'train_mfu.svdpp'):
        assert harness.reader(m)(other) is None


def test_recentre_moves_the_spans_onto_the_marks():
    '''Two marks (each a warm-up launch, then the timed one) whose timed
    launches the trace places 150 and 250 us after their first host
    readings as the anchor put them: each span moves by the error
    interpolated at its time, so a launch 0.5 us inside a short span,
    which the anchor's placing missed, is found in it.'''
    run = harness.runner('svdpp_calls')
    events = ([{'name': 'bench_anchor', 'ph': 'X', 'cat': 'user_annotation',
                'ts': 500.0, 'dur': 1.0}]
              + _kernel(1, 655.0, 656.0, 1.0)       # mark 1, warm-up
              + _kernel(2, 660.0, 662.0, 1.0)       # mark 1, timed
              + _kernel(3, 800.5, 810.0, 4.0)       # inside the span
              + _kernel(4, 935.0, 936.0, 1.0)       # mark 2, warm-up
              + _kernel(5, 940.0, 942.0, 1.0))      # mark 2, timed
    for e in events:
        if e.get('cat') == 'kernel' and e['name'] != 'k3':
            e['name'] = 'void at::cuda::spin_kernel(long)'
    # the span maps to 600 .. 601 us; the error there is 200 us
    items = [('train', 7, 1_005_000, 1_195_000),
             ('svdpp.aggregate', 7, 1_100_000, 1_101_000)]
    tr = reduce_events(events, items, (999_000, 1_001_000),
                       (1_000_000, 1_200_000))
    assert tr.busy_in_s('svdpp.aggregate') is None
    marks = [(1_010_000, 1_012_000), (1_190_000, 1_192_000)]
    out = run.recentre(tr, items, marks)
    assert close(out.busy_in_s('svdpp.aggregate'), 4e-6, 1e-9)
    # the window's ends lie before and after the marks: the nearest error
    assert close(out.window[0], tr.window[0] + 150.0, 1e-9)
    assert close(out.window[1], tr.window[1] + 250.0, 1e-9)
    assert [s[2] - t[2] for s, t in zip(out.spans, tr.spans)] == \
        [150.0, 200.0]
    # a trace without both launches of every mark loses its spans, so
    # that no reader reads a span the anchor may have misplaced
    bad = run.recentre(tr, items, marks + [(1_195_000, 1_196_000)])
    assert bad.spans == [] and bad.window == tr.window
    assert bad.ops == tr.ops and bad.busy_s() == tr.busy_s()
    assert bad.busy_in_s('svdpp.aggregate') is None
