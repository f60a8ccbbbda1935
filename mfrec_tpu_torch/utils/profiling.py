'''
Spans and counters inside the port's training path, kept in memory.

Off by default: ``span(name)`` then checks one module flag and returns
one shared no-op context, and ``count(name, n)`` returns at once.  After
``enable()``, each span records its name, its own id, the id of the span
open on its thread when it began (its parent; None for a root), the id
of its root span (so every span of one ``train()`` call shares it), the
thread's native id and its start and end on ``time.perf_counter_ns()``;
each count adds ``n`` to a named total.  ``enabled()`` says whether
recording is on; ``disable()`` stops it, and what was recorded stays
until ``collect()`` returns it and clears it.

The clock is the one ``torch.profiler``'s host events can be placed on
(``time.perf_counter_ns``), so a profiled run can lay these spans beside
the device's operations.
'''
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

_on = False
_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_spans = []
_counters = {}
_ids = itertools.count(1)


class _Local(threading.local):
    '''Each thread's stack of open spans.'''

    def __init__(self):
        self.stack = []


_local = _Local()


class Span(NamedTuple):
    '''One recorded span; ``call`` is its root's id, ``tid`` the
    thread's native id, times in ``perf_counter`` nanoseconds.'''
    name: str
    id: int
    parent: Optional[int]
    call: int
    tid: int
    start_ns: int
    end_ns: int


class Recording(NamedTuple):
    '''What ``collect()`` returns: the spans in the order they began, and
    the counters' totals.'''
    spans: list
    counters: dict


class _Open:
    '''A span being recorded: on its thread's stack while open.'''
    __slots__ = ('name', 'id', 'parent', 'call', 'start_ns')

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        stack = _local.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = None, self.id
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _local.stack.pop()
        rec = Span(self.name, self.id, self.parent, self.call,
                   threading.get_native_id(), self.start_ns, end)
        with _lock:
            _spans.append(rec)
        return False


def span(name):
    '''A context manager that records the block as the span ``name`` while
    recording is on; the shared no-op otherwise.'''
    if not _on:
        return _NOOP
    return _Open(name)


def count(name, n):
    '''Add ``n`` to the counter ``name`` while recording is on.'''
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable():
    '''Start recording spans and counts.'''
    global _on
    _on = True


def enabled():
    '''Whether recording is on.'''
    return _on


def disable():
    '''Stop recording; what was recorded stays until ``collect()``.'''
    global _on
    _on = False


def collect():
    '''The spans (in the order they began) and counters recorded since the
    last ``collect()``, which are then cleared.'''
    with _lock:
        spans = sorted(_spans, key=lambda s: s.id)
        counters = dict(_counters)
        _spans.clear()
        _counters.clear()
    return Recording(spans, counters)
