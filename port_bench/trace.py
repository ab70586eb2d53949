"""Readings of a traced run: the device's busy time from the profiler's
trace, the longest idle gaps by what the host was doing, and the torch ops
one operation issues.

The profiler (``torch.profiler``, CUPTI) writes a Chrome trace; its device
records (kernels, copies and fills) give each interval in which an
operation ran on the device. Their union is the busy time. Reading the
trace file is far cheaper than the profiler's own event objects.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
# The modules whose ``KERNELS`` list the program's hand-written kernels.
KERNEL_MODULES = ("cuda_mont", "cuda_tower", "cuda_curve", "keccak",
                  "cuda_fr")
TOP = 10


def kernels():
    """(module, Kernel) for every hand-written kernel of the program."""
    out = []
    for name in KERNEL_MODULES:
        mod = importlib.import_module(
            f"threshold_crypto_tpu_torch.device.{name}")
        out.extend((mod, k) for k in mod.KERNELS)
    return out


def _union(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _events(prof):
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)


def profile(run, with_host: bool):
    """Run ``run()`` under the profiler; returns (trace events, wall s)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as _profile

    acts = [ProfilerActivity.CUDA]
    if with_host:
        acts.insert(0, ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with _profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return _events(prof), wall


def device_records(events):
    return [e for e in events
            if e.get("cat") in DEVICE_CATS and e.get("dur") is not None]


def busy(events):
    """(busy seconds, [[name, seconds]] of the device ops that took most)."""
    dev = device_records(events)
    spans = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in dev)
    per_name = {}
    for e in dev:
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    return (sum(b - a for a, b in spans) * 1e-6,
            [[name[:160], us * 1e-6] for name, us in top])


def idle_gaps(events):
    """[[what the host was doing, seconds]]: the device's idle gaps between
    its first and last record, each named by the innermost layer span
    (the spans' annotations) and the innermost torch op of the host's main
    thread open at the gap's middle ("python" where no torch op was),
    summed by name, the longest first."""
    dev = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in device_records(events))
    host = [e for e in events
            if e.get("cat") in HOST_CATS and e.get("dur") is not None]
    tids = {}
    for e in host:
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    main = max(tids, key=tids.get) if tids else None
    gaps = [((a + b) / 2, b - a) for (_, a), (b, _) in zip(dev, dev[1:])]
    names = {cat: _innermost([e for e in host if e.get("tid") == main
                              and e["cat"] == cat], [g for g, _ in gaps])
             for cat in HOST_CATS}
    sums = {}
    for k, (_, width) in enumerate(gaps):
        name = (f"{names['user_annotation'][k] or 'outside the spans'}: "
                f"{names['cpu_op'][k] or 'python'}")
        sums[name] = sums.get(name, 0.0) + width * 1e-6
    return [[n[:160], s] for n, s in
            sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]


def _innermost(records, points):
    """For each of the sorted points, the name of the innermost of the
    nested records open there (None where none is)."""
    recs = sorted((float(e["ts"]), -float(e["dur"]), e["name"])
                  for e in records)
    out, stack, k = [], [], 0
    for p in points:
        while k < len(recs) and recs[k][0] <= p:
            start, neg_dur, name = recs[k]
            stack.append((start - neg_dur, name))
            k += 1
        while stack and stack[-1][0] < p:
            stack.pop()
        out.append(stack[-1][1] if stack else None)
    return out


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0
        self.paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _kernels_paused(counter):
    """Inside a kernel's wrapper (on the card) or its plain version (on the
    CPU) the counter pauses: a kernel is one launch, not torch ops."""
    saved = []

    def paused(fn):
        def run(*args):
            if counter.paused:
                return fn(*args)
            counter.paused = True
            try:
                return fn(*args)
            finally:
                counter.paused = False
        return run

    for mod, k in kernels():
        for fn in (k.launch, k.plain):
            saved.append((mod, fn.__name__, getattr(mod, fn.__name__)))
            setattr(mod, fn.__name__, paused(getattr(mod, fn.__name__)))
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


def torch_ops(run):
    """The torch ops one ``run()`` dispatches outside the kernels."""
    counter = _Counter()
    with _kernels_paused(counter), counter:
        run()
    return counter.ops
