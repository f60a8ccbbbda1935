'''The yardstick's arithmetic against hand-worked cases: the roofline
counts, the busy union, the placing of device work in spans.

    python -m pytest bench_torch/tests -q     (or ``run.py --rehearse``)
'''
import math
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

from lib import yardstick as ys  # noqa: E402
from lib.trace import reduce_events  # noqa: E402


def close(a, b, rel=1e-12):
    return abs(a - b) <= rel * max(abs(a), abs(b))


def test_roofline_picks_the_larger():
    # 67e9 operations take 1 ms at 67 TFLOP/s; 3.35e9 bytes take 1 ms
    assert ys.roofline_ms(67e9, 1.0) == (1.0, 'operations')
    t, what = ys.roofline_ms(1.0, 6.7e9)
    assert close(t, 2.0) and what == 'bytes'


def test_k1_bound_by_hand():
    # 1,000 ratings, k 66, T 128: 4 * 66 * 128 * 1000 = 33,792,000 ops
    # = 0.504358... us; bytes 12*1000 + 12*10 + 8*12 + 8*66*10 + 2*66*50
    # + 8*66 = 24,524 -> 7.32 ns: operations bound it
    t, what = ys.k1_bound(1000, 10, 12, 50, 66, 128)
    assert what == 'operations'
    assert close(t, 33_792_000 / 67e12 * 1e3)


def test_cg_bucket_bound_by_hand():
    # R 2 systems, L 8, 10 real entries over 7 fixed rows, k 4, 3 steps,
    # c_pos 1 (bf16 1.0, a power of two): symmetric Gram 4 * 5 per entry
    t_tensor, t_f32, t_bytes = ys.cg_bucket_parts(2, 8, 10, 7, 4, 3)
    assert close(t_tensor, 200 / 989e12)
    assert close(t_f32, (4 * 10 + 2 * 2 * 16 * 4) / 67e12)
    nbytes = 4 * 2 * 8 + 4 * 10 + 2 * 7 * 4 + 4 * 16 + 4 * 2 + 8 * 2 * 4
    assert close(t_bytes, nbytes / 3.35e12)
    # c_pos 3 is no power of two in bf16: 2 k^2 an entry
    t_tensor3, _, _ = ys.cg_bucket_parts(2, 8, 10, 7, 4, 3, c_pos=3.0)
    assert close(t_tensor3, 320 / 989e12)


def test_busy_union_counts_overlap_once():
    assert ys.union_ms([(0, 2), (1, 3), (5, 6)]) == 4
    assert ys.union_ms([(5, 6), (0, 10)]) == 10
    assert ys.union_ms([]) == 0


def test_bf16_rounding():
    assert ys._bf16_value(1.0) == 1.0
    assert ys._bf16_value(3.0) == 3.0
    assert ys._bf16_value(1.0 + 2 ** -9) == 1.0          # a tie, to even
    assert ys._bf16_value(1.0 + 3 * 2 ** -9) == 1.0 + 2 ** -7


def test_device_work_is_placed_in_its_span():
    # anchor at host 1,000,000 ns -> trace 500 us: offset -500 us
    ev = [{'name': 'bench_anchor', 'ph': 'X', 'cat': 'user_annotation',
           'ts': 500.0, 'dur': 1.0},
          {'name': 'cudaLaunchKernel', 'ph': 'X', 'cat': 'cuda_runtime',
           'ts': 520.0, 'dur': 2.0, 'tid': 7, 'args': {'correlation': 1}},
          {'name': 'k', 'ph': 'X', 'cat': 'kernel', 'ts': 530.0,
           'dur': 10.0, 'args': {'correlation': 1}},
          {'name': 'cudaLaunchKernel', 'ph': 'X', 'cat': 'cuda_runtime',
           'ts': 600.0, 'dur': 2.0, 'tid': 7, 'args': {'correlation': 2}},
          {'name': 'k2', 'ph': 'X', 'cat': 'kernel', 'ts': 605.0,
           'dur': 5.0, 'args': {'correlation': 2}}]
    spans = [('train', 7, 1_010_000, 1_030_000)]      # 510 .. 530 us
    tr = reduce_events(ev, spans, (1_000_000, 1_000_000),
                       (1_000_000, 1_200_000))
    ops, n = tr.ops_in('train')
    assert n == 1 and [o[0] for o in ops] == ['k']
    assert close(tr.busy_in_s('train'), 10e-6)
    assert close(tr.busy_s(), 15e-6)
    assert math.isclose(tr.window_s, 200e-6)
    gaps = tr.breakdown()['idle_gaps']
    assert gaps[0][0] == 'outside_spans' and close(gaps[0][1], 90e-6)
    # the gap 500 .. 530 lies mostly in the span (510 .. 530)
    assert gaps[2][0] == 'train' and close(gaps[2][1], 30e-6)


def run_all():
    '''Run every test here; returns the names that failed.'''
    failed = []
    for name, fn in sorted(globals().items()):
        if name.startswith('test_') and callable(fn):
            try:
                fn()
            except Exception as e:       # reported, the rest go on
                failed.append(name)
                print('yardstick %s FAILED: %r' % (name, e), flush=True)
    print('yardstick: %d hand-worked cases, %d failed'
          % (sum(1 for n in globals() if n.startswith('test_')),
             len(failed)), flush=True)
    return failed
