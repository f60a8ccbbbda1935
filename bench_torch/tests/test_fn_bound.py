'''The FN cell's yardstick (``lib/fn_bound.py``) against hand-worked
cases, and its five readers on a hand-built trace: each reads its share
from the program's spans, and the two rooflines read nothing where the
program records no such span (a checkout without them).

    python -m pytest bench_torch/tests -q
'''
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import fn_bound as fb  # noqa: E402
from lib import harness  # noqa: E402
from lib import svdpp_bound as sb  # noqa: E402
from lib import yardstick as ys  # noqa: E402
from lib.trace import reduce_events  # noqa: E402


def close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


# 1,000 user-side entries of 10 users in 12 segments over 50 items, k = 4
# factors (rows of 6 augmented), T = 2 sweeps; the item side: the same
# 1,000 entries of 50 items in 60 segments over 10 users
USER = dict(n=1000, rows=10, segments=12, fixed_rows=50)
ITEM = dict(n=1000, rows=50, segments=60, fixed_rows=10)
WORK = {'half_passes': [USER, ITEM], 'k': 6, 'T': 2, 'k_factors': 4,
        'fn': True}


def test_profile_work_by_hand():
    # 3 + 3 k = 15 an entry; the ids and ratings (8 n), the offsets (4
    # (segments + 1)), the rows' triples (12 rows), the target both ways
    # (8 k rows) and b_u (4 rows), each item's X and Y rows and b_j once
    # ((8 k + 4) fixed rows)
    ops, nbytes = fb.profile_agg_work(1000, 10, 12, 50, 4)
    assert ops == 15 * 1000
    assert nbytes == 8000 + 52 + 120 + 320 + 40 + 36 * 50


def test_xy_step_work_by_hand():
    # 7 k + 3 = 31 an entry; the user ids, ratings and masks (12 n), the
    # offsets (4 * 61), the rows' triples (12 * 50), X and Y both ways (16
    # k rows) and b_i (4 rows), each user's G row and b_u once ((4 k + 4)
    # fixed rows)
    ops, nbytes = fb.xy_step_work(1000, 50, 60, 10, 4)
    assert ops == 31 * 1000
    assert nbytes == 12000 + 244 + 600 + 3200 + 200 + 20 * 10


def test_epoch_bounds_by_hand():
    # every phase is bound by bytes at this size: the profiles' 10,332,
    # the errors' 13,932 (the SVD++ error mode's count), the X/Y step's
    # 16,444
    assert close(fb.agg_bound_s(WORK), (10332 + 13932) / ys.PEAK_BYTES)
    assert sb.error_agg_work(1000, 10, 12, 50, 4)[1] == 13932
    assert close(fb.xy_step_bound_s(WORK), 16444 / ys.PEAK_BYTES)
    # the item half-pass 4 k T an entry (k augmented: 6), the frozen user
    # half-pass (2 k + 2) T, then 15 + 23 + 31 an entry
    assert fb.user_half_pass_ops(1000, 6, 2) == 14 * 2 * 1000
    assert fb.epoch_ops(WORK) == 4 * 6 * 2 * 1000 + 14 * 2 * 1000 + \
        15 * 1000 + 23 * 1000 + 31 * 1000


def test_half_pass_bound_by_hand():
    # each side's bytes as K1's, the fixed rows in f32 (4 k): 12 n + 12
    # rows + 8 segments + 8 k rows + 4 k fixed rows + 8 k, 15,768 on the
    # item side and 13,944 on the user side; the item side's 4 k T n =
    # 48,000 operations and the user side's (2 k + 2) T n = 28,000 against
    # those bytes at the H100's peaks
    item = 12000 + 600 + 480 + 2400 + 240 + 48
    user = 12000 + 120 + 96 + 480 + 1200 + 48
    assert (item, user) == (15768, 13944)
    want = sum(max(ops / ys.PEAK_F32_FLOPS, nbytes / ys.PEAK_BYTES)
               for ops, nbytes in ((48000, item), (28000, user)))
    assert close(fb.half_pass_bound_s(WORK), want, 1e-9)


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
          + _kernel(1, 511.0, 512.0, 4.0)      # in fn.aggregate
          + _kernel(2, 521.0, 522.0, 50.0)     # in fn.half_passes
          + _kernel(3, 581.0, 582.0, 6.0)      # in fn.aggregate
          + _kernel(4, 601.0, 602.0, 8.0))     # in fn.xy_step
PROGRAM = [('fn.aggregate', 7, 1_010_000, 1_015_000),
           ('fn.half_passes', 7, 1_020_000, 1_030_000),
           ('fn.aggregate', 7, 1_080_000, 1_085_000),
           ('fn.xy_step', 7, 1_100_000, 1_105_000)]
READERS = ('fn_agg_roofline', 'fn_xy_step_roofline', 'train_mfu.fn',
           'idle_share.fn', 'fn_half_pass_roofline')


def _ctx(spans, work=WORK):
    tr = reduce_events(EVENTS, [('train', 7, 1_005_000, 1_190_000)] + spans,
                       (999_000, 1_001_000), (1_000_000, 1_200_000))
    return {'trace': tr, 'counters': {'calls': 2, 'epochs_a_call': 3},
            'work': lambda: work}


def test_readers_on_the_program_spans():
    ctx = _ctx(PROGRAM)
    read = {m: harness.reader(m)(ctx) for m in READERS}
    # 6 epochs; the aggregate spans launched 4 + 6 us, the X/Y step 8
    assert close(read['fn_agg_roofline'],
                 100.0 * 6 * fb.agg_bound_s(WORK) / 10e-6, 1e-9)
    assert close(read['fn_xy_step_roofline'],
                 100.0 * 6 * fb.xy_step_bound_s(WORK) / 8e-6, 1e-9)
    # the half-pass span launched 50 us
    assert close(read['fn_half_pass_roofline'],
                 100.0 * 6 * fb.half_pass_bound_s(WORK) / 50e-6, 1e-9)
    assert close(read['train_mfu.fn'],
                 100.0 * 6 * fb.epoch_ops(WORK) / ys.PEAK_F32_FLOPS / 200e-6,
                 1e-9)
    # busy 4 + 50 + 6 + 8 of the 200 us window
    assert close(read['idle_share.fn'], 66.0, 1e-9)


def test_rooflines_read_nothing_without_the_program_spans():
    ctx = _ctx([])
    assert harness.reader('fn_agg_roofline')(ctx) is None
    assert harness.reader('fn_xy_step_roofline')(ctx) is None
    assert harness.reader('fn_half_pass_roofline')(ctx) is None
    # a cell of another model (SVD++'s counts): nothing of FN to read
    svdpp = {k: v for k, v in WORK.items() if k != 'fn'}
    other = _ctx(PROGRAM, dict(svdpp, svdpp=True))
    for m in ('fn_agg_roofline', 'fn_xy_step_roofline', 'train_mfu.fn',
              'fn_half_pass_roofline'):
        assert harness.reader(m)(other) is None


def test_the_cell_lists_its_readers():
    '''The cell reports each of its five metrics and the rate they move,
    and no SVD++ or GD reader lists it.'''
    bench = harness.benchmark()
    cell = harness.cell_of(bench, 'fn-netflix-r100.train')
    names = [m['name'] for m in harness.metrics_of(bench, cell, 'per_layer')]
    assert sorted(names) == sorted(READERS)
    ends = [m['name'] for m in harness.metrics_of(bench, cell, 'end_to_end')]
    assert ends == ['train_ratings_per_s.sgd', 'setup_s']
