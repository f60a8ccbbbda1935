'''The program's spans laid on a traced window (``phases.py``) against
hand-worked cases: the idle inside a call and inside its loop, the
bytes a call, the set-up's layout seconds; the cell's readers read the
same with the program's spans joined; an idle gap takes the name of the
innermost program span.

    python -m pytest bench_torch/tests -q
'''
import os
import sys

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if HERE not in sys.path:
    sys.path[:0] = [HERE, os.path.dirname(HERE)]

import phases  # noqa: E402
from lib import harness  # noqa: E402
from lib.trace import reduce_events  # noqa: E402
from mfrec_tpu_torch.utils.profiling import Span  # noqa: E402


def _kernel(name, corr, launch_us, start_us, dur_us):
    return [{'name': 'cudaLaunchKernel', 'ph': 'X', 'cat': 'cuda_runtime',
             'ts': launch_us, 'dur': 1.0, 'tid': 7,
             'args': {'correlation': corr}},
            {'name': name, 'ph': 'X', 'cat': 'kernel', 'ts': start_us,
             'dur': dur_us, 'args': {'correlation': corr}}]


# host ns -> trace us: the anchor at host 1,000,000 ns is trace 500 us
EVENTS = ([{'name': 'bench_anchor', 'ph': 'X', 'cat': 'user_annotation',
            'ts': 500.0, 'dur': 1.0}]
          + _kernel('k1', 1, 541.0, 545.0, 30.0)     # 545 .. 575
          + _kernel('k2', 2, 542.0, 570.0, 15.0)     # 570 .. 585
          + _kernel('copy', 3, 591.0, 592.0, 2.0))   # 592 .. 594
HARNESS = [('train', 7, 1_010_000, 1_100_000)]       # 510 .. 600 us
PROGRAM = [Span('gd.train', 1, None, 1, 7, 1_012_000, 1_098_000),
           Span('gd.bias', 2, 1, 1, 7, 1_013_000, 1_040_000),
           Span('gd.epochs', 3, 1, 1, 7, 1_040_000, 1_090_000),
           Span('converge.sync', 4, 3, 1, 7, 1_080_000, 1_090_000),
           Span('gd.writeback', 5, 1, 1, 7, 1_090_000, 1_098_000)]


def _traces():
    tr = reduce_events(EVENTS, HARNESS, (1_000_000, 1_000_000),
                       (1_000_000, 1_200_000))                # 500 .. 700
    joined, placed = phases.on_trace(tr, HARNESS, PROGRAM)
    return tr, joined, placed


def test_busy_within_clips_to_the_interval():
    busy = phases.Busy([('a', 0.0, 10.0, 1), ('b', 5.0, 20.0, 2),
                        ('c', 30.0, 40.0, 3)])
    assert busy.within(-5.0, 50.0) == 30.0
    assert busy.within(15.0, 35.0) == 10.0
    assert busy.within(21.0, 29.0) == 0.0
    assert busy.within(32.0, 33.0) == 1.0
    assert busy.idle(0.0, 40.0) == 10.0


def test_idle_a_call_by_hand():
    tr, _, placed = _traces()
    assert [(s.name, a, b) for s, a, b in placed][:3] == [
        ('gd.train', 512.0, 598.0), ('gd.bias', 513.0, 540.0),
        ('gd.epochs', 540.0, 590.0)]
    busy = phases.Busy(tr.ops)
    metrics, calls, idle_ms = phases.program_metrics(
        placed, busy, {'h2d_bytes': 3_000_000}, 'sgd')
    # the call 512 .. 598 (86 us) holds 40 + 2 us of work: 44 idle; the
    # loop 540 .. 590 (50 us) holds 40: 10 idle
    assert calls == 1
    assert metrics['host_idle_ms.sgd'] == pytest.approx(0.034)
    assert metrics['loop_idle_ms.sgd'] == pytest.approx(0.010)
    assert metrics['h2d_mb.sgd'] == pytest.approx(3.0)
    assert idle_ms == pytest.approx(0.044)
    table = phases.phase_table(placed, busy)
    assert table['gd.bias'] == {'calls': 1, 'host_ms': pytest.approx(0.027),
                                'idle_ms': pytest.approx(0.027)}
    assert table['converge.sync']['idle_ms'] == pytest.approx(0.005)
    assert table['gd.writeback']['idle_ms'] == pytest.approx(0.006)


def test_setup_layouts_by_hand():
    spans = [Span('store.consolidate', 1, None, 1, 7, 0, 1_000_000_000),
             Span('gd.train', 2, None, 2, 7, 1_400_000_000, 2_100_000_000),
             Span('gd.layouts', 3, 2, 2, 7, 1_500_000_000, 2_000_000_000),
             Span('wrmf.buckets', 4, 3, 2, 7, 1_600_000_000,
                  1_700_000_000)]
    # 1 s + 0.5 s; the nested span counts once
    assert phases.setup_layouts_s(spans) == pytest.approx(1.5)


WORK = {
    'gd-ml10m-r64.train': {
        'k': 4, 'T': 8,
        'half_passes': [{'n': 100, 'rows': 10, 'segments': 12,
                         'fixed_rows': 5}]},
    'wrmf-ml10m-r64.train': {
        'k': 4, 'users': 10, 'items': 8,
        'params': {'cg_steps': 3, 'cg_warm_steps': 2, 'cg_warmup_epochs': 1,
                   'c_pos': 1.0, 'alpha': 0.0},
        'user_buckets': [{'R': 2, 'L': 8, 'nnz': 10, 'n_fix': 7}],
        'item_buckets': [{'R': 3, 'L': 8, 'nnz': 10, 'n_fix': 6}]}}


@pytest.mark.parametrize('name', sorted(WORK))
def test_readers_read_the_same_with_program_spans(name):
    tr, joined, _ = _traces()
    bench = harness.benchmark()
    cell = harness.cell_of(bench, name)
    ctx = {'counters': {'calls': 1, 'epochs_a_call': 2},
           'work': lambda: WORK[name]}
    metrics = harness.metrics_of(bench, cell, 'per_layer')
    assert metrics
    for m in metrics:
        read = harness.reader(m['name'])
        assert read(dict(ctx, trace=joined)) == read(dict(ctx, trace=tr)) \
            is not None, m['name']
    assert joined.busy_in_s('train') == tr.busy_in_s('train')
    assert joined.ops_in('train') == tr.ops_in('train')


def test_gap_named_by_innermost_program_span():
    tr, joined, _ = _traces()
    plain = dict(tr.breakdown()['idle_gaps'][:3])
    gaps = joined.breakdown()['idle_gaps']
    # 594 .. 700 lies past every span; 500 .. 545 mostly in gd.bias;
    # 585 .. 592 in converge.sync
    assert [g[0] for g in gaps] == ['outside_spans', 'gd.bias',
                                    'converge.sync']
    assert [g[1] for g in gaps] == pytest.approx([106e-6, 45e-6, 7e-6])
    assert set(plain) == {'outside_spans', 'train'}
