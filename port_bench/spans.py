"""Spans around the program's functions, patched in from outside.

A span brackets every call of a module attribute (or of an attribute of an
object the module holds, such as a curve's bound method) with CUDA events
on the card and with the host clock on the CPU, and names the call in a
profiler annotation. Nested calls under one label count once: only the
outermost call of a label is timed, so a label covers a layer's time
without counting its own recursion twice.
"""

from __future__ import annotations

import contextlib
import importlib
import time

import torch


def resolve(target: str):
    """'package.module:attr' or 'package.module:obj.attr' -> (owner, attr)."""
    mod_name, path = target.split(":")
    owner = importlib.import_module(mod_name)
    *objs, attr = path.split(".")
    for name in objs:
        owner = getattr(owner, name)
    return owner, attr


class _HostEvent:
    def __init__(self):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class SpanTimer:
    """Spans by label: ``ms()`` sums each label's spans after a sync."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.spans = []
        self.depth = {}

    def _event(self):
        if self.on_card:
            return torch.cuda.Event(enable_timing=True)
        return _HostEvent()

    def wrap(self, label, fn):
        def run(*args, **kwargs):
            if self.depth.get(label, 0):
                return fn(*args, **kwargs)
            self.depth[label] = 1
            start, stop = self._event(), self._event()
            try:
                with torch.profiler.record_function(label):
                    start.record()
                    out = fn(*args, **kwargs)
                    stop.record()
            finally:
                self.depth[label] = 0
            self.spans.append((label, start, stop))
            return out
        return run

    def ms(self):
        """{label: [ms of each span]}, after the device has finished."""
        if self.on_card:
            torch.cuda.synchronize()
        out = {}
        for label, start, stop in self.spans:
            out.setdefault(label, []).append(start.elapsed_time(stop))
        return out


@contextlib.contextmanager
def patched(timer, targets):
    """Wrap each (target, label) in ``timer`` while the block runs."""
    saved = []
    try:
        for target, label in targets:
            owner, attr = resolve(target)
            own = isinstance(owner, type) or attr in vars(owner)
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn, own))
            setattr(owner, attr, timer.wrap(label, fn))
        yield timer
    finally:
        for owner, attr, fn, own in reversed(saved):
            if own:
                setattr(owner, attr, fn)
            else:
                delattr(owner, attr)
