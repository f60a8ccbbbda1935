'''
The traced run: the benchmark's own spans around calls into the
program's layers, torch.profiler's device trace, and the reduction of
both to what the per-layer readers read.

Spans are recorded by the harness itself (name, thread, host clock), on
any thread, and placed on the profiler's clock by an anchor span that
both record.  A device operation (kernel, copy, set) belongs to a span
when the host call that launched it (the runtime event with the same
correlation id) started inside the span on the span's thread.
'''
from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import threading
import time

from lib.yardstick import union_ms

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
LAUNCH_CATS = ('cuda_runtime', 'cuda_driver')


class Spans:
    '''Host spans, recorded whether or not the profiler runs (a few
    microseconds each).'''

    def __init__(self):
        self.items = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.items.append((name, threading.get_native_id(), t0, t1))


class DeviceTrace:
    '''One profiled window: device operations (name, start, end in us on
    the profiler's clock), the launching host call of each, the spans
    mapped onto that clock, and the window's bounds.'''

    def __init__(self, ops, launches, spans, window):
        self.ops = ops            # [(name, start, end, correlation)]
        self.launches = launches  # {correlation: (tid, ts)}
        self.spans = spans        # [(name, tid, start, end)] in us
        self.window = window      # (start, end) in us

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e6

    def busy_s(self, lo=None, hi=None):
        '''Seconds in which some device operation ran, clipped to [lo, hi]
        (default: the window).'''
        lo = self.window[0] if lo is None else lo
        hi = self.window[1] if hi is None else hi
        iv = [(max(a, lo), min(b, hi)) for _, a, b, _ in self.ops
              if b > lo and a < hi]
        return union_ms(iv) / 1e6

    def ops_in(self, name):
        '''The device operations launched inside the spans called
        ``name``, and how many such spans there were.'''
        lo, hi = self.window
        spans = [s for s in self.spans if s[0] == name
                 and s[3] > lo and s[2] < hi]
        tids = {s[1] for s in spans}
        by_tid = {}
        for s in spans:
            by_tid.setdefault(s[1], []).append((s[2], s[3]))
        out = []
        for op in self.ops:
            tid_ts = self.launches.get(op[3])
            if tid_ts is None:
                continue
            tid, ts = tid_ts
            cands = by_tid.get(tid) if tid in tids else \
                [iv for v in by_tid.values() for iv in v]
            if cands and any(a <= ts <= b for a, b in cands):
                out.append(op)
        return out, len(spans)

    def busy_in_s(self, name):
        '''Seconds of device work launched inside the ``name`` spans (the
        union of their intervals), or None, with a note on standard
        error, where the profiler recorded none there.'''
        ops, n = self.ops_in(name)
        if not ops:
            note('the profiler recorded no device operation inside the %d '
                 '%r spans (it drops launches at times): not read'
                 % (n, name))
            return None
        return union_ms([(a, b) for _, a, b, _ in ops]) / 1e6

    def breakdown(self, top=10):
        '''The device operations that took most time, and the longest idle
        gaps, each named by the innermost span the host was in at its
        middle.'''
        tot = {}
        lo, hi = self.window
        for name, a, b, _ in self.ops:
            if b > lo and a < hi:
                tot[name] = tot.get(name, 0.0) + (min(b, hi) - max(a, lo))
        ops = sorted(tot.items(), key=lambda x: -x[1])[:top]
        iv = sorted((max(a, lo), min(b, hi)) for _, a, b, _ in self.ops
                    if b > lo and a < hi)
        gaps, end = [], lo
        for a, b in iv:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        named = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inside = [s for s in self.spans if s[2] <= mid < s[3]]
            name = max(inside, key=lambda s: s[2])[0] if inside \
                else 'outside_spans'
            named.append([name, (b - a) / 1e6])
        return {'device_ops': [[n, t / 1e6] for n, t in ops],
                'idle_gaps': named}


def note(msg):
    print('bench: %s' % msg, file=sys.stderr, flush=True)


@contextlib.contextmanager
def profiled(spans, holder):
    '''Profile the block on the CPU and the card; on exit put a
    ``DeviceTrace`` of it into ``holder['trace']``.'''
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)
    prof.__enter__()
    try:
        a0 = time.perf_counter_ns()
        with record_function('bench_anchor'):
            pass
        a1 = time.perf_counter_ns()
        t0 = time.perf_counter_ns()
        yield
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    finally:
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)['traceEvents']
    finally:
        os.unlink(path)
    holder['trace'] = reduce_events(events, spans.items, (a0, a1), (t0, t1))


def reduce_events(events, span_items, anchor_ns, window_ns):
    '''The ``DeviceTrace`` of a chrome trace's events: ``span_items`` and
    the window (host perf_counter ns) placed on the trace's clock by the
    ``bench_anchor`` span entered between ``anchor_ns``.'''
    anchor = [e for e in events if e.get('name') == 'bench_anchor'
              and e.get('ph') == 'X' and e.get('cat') != 'gpu_user_annotation']
    if not anchor:
        raise RuntimeError('the trace has no anchor span')
    # the anchor's start lies between the two host readings
    offset = float(anchor[0]['ts']) - (anchor_ns[0] + anchor_ns[1]) / 2e3

    def us(ns):
        return ns / 1e3 + offset

    ops, launches = [], {}
    for e in events:
        if e.get('ph') != 'X':
            continue
        cat = e.get('cat')
        corr = (e.get('args') or {}).get('correlation')
        if cat in DEVICE_CATS:
            a = float(e['ts'])
            ops.append((e.get('name', ''), a, a + float(e.get('dur', 0.0)),
                        corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = (e.get('tid'), float(e['ts']))
    spans = [(n, tid, us(a), us(b)) for n, tid, a, b in span_items]
    return DeviceTrace(ops, launches, spans, (us(window_ns[0]),
                                              us(window_ns[1])))
