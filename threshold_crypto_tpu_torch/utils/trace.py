"""Spans and launch counts at the port's stage boundaries.

    from threshold_crypto_tpu_torch.utils import trace

    with trace.enabled():
        for i, batch in enumerate(batches):
            with trace.request(i):
                ops.verify_batch_pallas(*batch)
    rows = trace.records()
    trace.clear()

The program opens a span at each stage (``span(name)`` around a block,
``@traced(name)`` on a function that is one stage). Tracing is off by
default, and then ``span`` returns one shared object that does nothing:
no event, no profiler annotation, no counter read, no torch call. Only
``enabled()`` turns it on; nothing is written anywhere.

While it is on, each span records its name; an id, and the id of its
parent (the span open on this thread when it opened); the id of its
request (``request(rid)`` opens a span named "request" whose ``rid``
every span inside it carries; a span opened outside any request carries
its outermost span's id); the host clock at its open and close
(``time.perf_counter_ns``); the device time between them on the current
stream (a pair of CUDA events when a card is present, read after one
synchronisation in ``records()``; else the host clock); and ``launches``,
the hand-written kernel launches issued inside it, its children's
included (the change in the sum of every kernel's
``KernelCount.launches``). Each span also opens
``torch.profiler.record_function(name)``: under an active profiler the
stages lie on the timeline of the device's records, so a device gap can
be put down to the stage open on the host. The profiler's Chrome trace is
the export.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import itertools
import threading
import time

import torch

# The modules whose ``KERNELS`` list the hand-written kernels.
KERNEL_MODULES = ("cuda_mont", "cuda_tower", "cuda_curve", "keccak",
                  "cuda_fr")

_on = False
_card = False
_counts = ()
_spans = []
_ids = itertools.count(1)
_local = threading.local()


def kernels():
    """(module, Kernel) for every hand-written kernel, module by module."""
    out = []
    for name in KERNEL_MODULES:
        mod = importlib.import_module(
            f"threshold_crypto_tpu_torch.device.{name}")
        out.extend((mod, k) for k in mod.KERNELS)
    return out


def _launches():
    return sum(c.launches for c in _counts)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Off:
    """The span of tracing off: enters and leaves, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _HostClock:
    __slots__ = ("ns",)

    def record(self):
        self.ns = time.perf_counter_ns()

    def elapsed_time(self, stop):
        return (stop.ns - self.ns) / 1e6


def _clock():
    return torch.cuda.Event(enable_timing=True) if _card else _HostClock()


class _Span:
    __slots__ = ("name", "id", "parent", "request", "host_start_ns",
                 "host_end_ns", "launches", "_start", "_stop", "_ms",
                 "_annotation")

    def __init__(self, name, request=None):
        self.name = name
        self.request = request
        self.host_end_ns = None
        self._ms = None

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top else None
        if self.request is None:
            self.request = top.request if top else self.id
        self._annotation = torch.profiler.record_function(self.name)
        self._annotation.__enter__()
        self._start, self._stop = _clock(), _clock()
        self.launches = _launches()
        self._start.record()
        self.host_start_ns = time.perf_counter_ns()
        stack.append(self)
        _spans.append(self)
        return self

    def __exit__(self, *exc):
        self.host_end_ns = time.perf_counter_ns()
        self._stop.record()
        self.launches = _launches() - self.launches
        _stack().pop()
        self._annotation.__exit__(*exc)
        return False

    def record(self):
        if self._ms is None:
            self._ms = self._start.elapsed_time(self._stop)
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "request": self.request,
                "host_start_ns": self.host_start_ns,
                "host_end_ns": self.host_end_ns, "device_ms": self._ms,
                "launches": self.launches}


def span(name: str):
    """A context manager: the stage ``name`` while tracing is on; the shared
    do-nothing object while it is off."""
    return _Span(name) if _on else _OFF


def request(rid):
    """A span named "request" whose ``rid`` every span opened inside it
    carries: one caller's request."""
    return _Span("request", rid) if _on else _OFF


def traced(name: str):
    """Decorator: every call of the function is the stage ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def enabled():
    """Tracing on while the block runs (device times by CUDA events when a
    card is present)."""
    global _on, _card, _counts
    saved = _on, _card
    _counts = tuple({id(k.count): k.count for _, k in kernels()}.values())
    _card = torch.cuda.is_available()
    _on = True
    try:
        yield
    finally:
        _on, _card = saved


def records() -> list:
    """Every span closed since the last ``clear()``, in the order they
    opened, as plain dicts: name, id, parent, request, host_start_ns,
    host_end_ns, device_ms, launches. Waits once for the card."""
    done = [s for s in _spans if s.host_end_ns is not None]
    if any(isinstance(s._stop, torch.cuda.Event) for s in done):
        torch.cuda.synchronize()
    return [s.record() for s in done]


def clear():
    """Forget every recorded span."""
    _spans.clear()
