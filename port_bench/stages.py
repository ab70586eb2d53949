#!/usr/bin/env python3
"""The program's own stages in a cell, on the device trace's clock.

    python3 port_bench/stages.py --workload <cell> --seed <n> --seconds <s>

The program's spans (``threshold_crypto_tpu_torch/utils/trace.py``) are off
in every pass of ``run.py``. This tool runs a cell as ``run.py --trace 1``
does (set-up, the untraced window, the busy pass under the profiler), then
two passes with the program's tracing on:

(a) one operation inside ``trace.request`` under the profiler (CPU and
    CUDA): the device's idle gaps named by the innermost program stage open
    on the host's main thread (``trace.idle_gaps``), and each stage's share
    of the gap time (a gap belongs to every stage open at its middle);
(b) ``trace_ops`` operations, each inside ``trace.request(i)``, without the
    profiler: each stage's device ms an operation and each request's
    kernel launches. Its ms an operation against those of as many untraced
    operations just before it (after the profiler, as it is), and against
    the window's, is the cost of tracing when on.

The per-layer quantities of ``METRICS`` are read by ``metrics/<name>.py``
from the fields this tool adds to the run's data: ``stages`` ({span name:
device ms an operation}, pass b), ``launches`` ([launches of each
operation], pass b) and ``gap_shares`` ({span name: share of the gap
time}, pass a). Prints one JSON line (the readings, the stage ms, the
breakdown, both ms an operation, the reference's verdict). Exits 2
without a card, as ``run.py`` does.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import run  # noqa: E402
from port_bench import trace as trace_mod  # noqa: E402

METRICS = ("miller_ms", "final_exp_ms", "fold_wait_ms", "pairing_wait_ms",
           "launches_per_op")


def _gaps_and_annotations(events):
    """The device's idle gaps between its first and last record, as
    (middle, width) in µs, and the annotations of the host's main
    thread."""
    dev = trace_mod._union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in trace_mod.device_records(events))
    gaps = [((a + b) / 2, b - a) for (_, a), (b, _) in zip(dev, dev[1:])]
    host = [e for e in events
            if e.get("cat") in trace_mod.HOST_CATS and e.get("dur") is not None]
    tids = {}
    for e in host:
        tids[e.get("tid")] = tids.get(e.get("tid"), 0) + 1
    main = max(tids, key=tids.get) if tids else None
    return gaps, [e for e in host if e.get("tid") == main
                  and e["cat"] == "user_annotation"]


def gap_shares(events):
    """{annotation: share of the device's idle gap time whose gaps' middles
    fall inside that annotation on the host's main thread}, from a profiler
    trace's events."""
    gaps, notes = _gaps_and_annotations(events)
    total = sum(w for _, w in gaps)
    if not total:
        return {}
    spans = {}
    for e in notes:
        ts = float(e["ts"])
        spans.setdefault(e["name"], []).append((ts, ts + float(e["dur"])))
    mids = [m for m, _ in gaps]
    width = list(itertools.accumulate((w for _, w in gaps), initial=0.0))
    return {name: sum(width[bisect.bisect_right(mids, b)]
                      - width[bisect.bisect_left(mids, a)]
                      for a, b in trace_mod._union(intervals)) / total
            for name, intervals in spans.items()}


def gaps_by_stage(events):
    """{innermost annotation open at a gap's middle: seconds of gaps}, the
    longest first: where the gap time sits, each gap counted once."""
    gaps, notes = _gaps_and_annotations(events)
    out = {}
    inner = trace_mod._innermost(notes, [m for m, _ in gaps])
    for name, (_, width) in zip(inner, gaps):
        key = name or "outside the spans"
        out[key] = out.get(key, 0.0) + width * 1e-6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profiled_stages(tr, run_op):
    """Pass (a): one ``run_op`` inside ``request(0)`` with the program's
    tracing on, under the profiler. Returns (idle gaps named by program
    stage and torch op, gap shares, gaps by innermost stage)."""
    def one():
        with tr.request(0):
            run_op()

    tr.clear()
    with tr.enabled():
        events, _ = trace_mod.profile(one, with_host=True)
    tr.clear()
    return (trace_mod.idle_gaps(events), gap_shares(events),
            gaps_by_stage(events))


def traced_pass(tr, run_op, k):
    """Pass (b): k ``run_op()``, each inside ``request(i)``, the program's
    tracing on. Returns the stage ms an op, each op's launches and the
    seconds of each op."""
    tr.clear()
    seconds = []
    with tr.enabled():
        for i in range(k):
            t0 = time.perf_counter()
            with tr.request(i):
                run_op()
            seconds.append(time.perf_counter() - t0)
    rows = tr.records()
    tr.clear()
    stage_ms = {}
    for r in rows:
        if r["name"] != "request":
            stage_ms[r["name"]] = stage_ms.get(r["name"], 0.0) + \
                r["device_ms"] / k
    return SimpleNamespace(
        stage_ms=stage_ms, seconds=seconds,
        launches=[r["launches"] for r in rows if r["name"] == "request"])


def stage_wait(data, name):
    """The untraced idle ms an operation (the window's ms an operation less
    the busy pass's device ms an operation) times the share of the gaps
    inside the stage ``name``; None where pass (a) did not run."""
    share = data.gap_shares.get(name)
    t = data.traced
    if share is None or not t.busy_s or not t.ops:
        return None
    return 1e3 * (data.window_s / data.ops - t.busy_s / t.ops) * share


def read(data):
    """{quantity: value} of each reader of ``METRICS`` that finds something
    to read."""
    out = {}
    for name in METRICS:
        value = run.reader(name).read(data)
        if value is not None:
            out[name] = value
    return out


def readings(prep, seconds):
    """The untraced window and busy pass, then passes (a) and (b), on a
    prepared run; returns the result line's dict."""
    import torch
    from threshold_crypto_tpu_torch.utils import trace as tr

    spec, mix, state, on_card = prep.spec, prep.mix, prep.state, prep.on_card
    records = []

    def sync():
        if on_card:
            torch.cuda.synchronize(prep.dev)

    def run_op():
        records.append(mix.op(state, len(records)))
        sync()

    sync()
    latencies = []
    w0 = time.perf_counter()
    while (time.perf_counter() - w0 < seconds
           or len(records) < int(spec.traffic.get("min_ops", 1))):
        t = time.perf_counter()
        run_op()
        latencies.append(time.perf_counter() - t)
    window_s, n_ops = time.perf_counter() - w0, len(records)
    k = int(spec.traffic["trace_ops"])
    traced = SimpleNamespace(busy_s=None, window_s=None, ops=0)
    gaps, shares, by_stage = None, {}, None
    if on_card:
        events, wall = trace_mod.profile(
            lambda: [run_op() for _ in range(k)], with_host=False)
        traced = SimpleNamespace(busy_s=trace_mod.busy(events)[0],
                                 window_s=wall, ops=k)
        gaps, shares, by_stage = profiled_stages(tr, run_op)
    after = []
    for _ in range(k):
        t = time.perf_counter()
        run_op()
        after.append(time.perf_counter() - t)
    passed = traced_pass(tr, run_op, k)
    data = SimpleNamespace(
        spans={}, ops=n_ops, window_s=window_s, traced=traced,
        torch_ops=None, gap_shares=shares, stages=passed.stage_ms,
        launches=passed.launches,
        work=run.counts_module(spec.traffic).work(spec.config, spec.traffic))
    verdict = mix.check(state, records)
    ms = {"untraced": [1e3 * t for t in latencies],
          "untraced_after": [1e3 * t for t in after],
          "tracing_on": [1e3 * t for t in passed.seconds]}
    print("median ms an op: " + ", ".join(
        f"{key} {statistics.median(v) if v else None} ({len(v)} ops)"
        for key, v in ms.items()), file=sys.stderr)
    return {"cell": spec.cell["name"],
            "correct": all(c["value"] <= c["limit"]
                           for c in verdict["checks"]),
            "readings": read(data),
            "frozen_launches": sum(data.work["launches"].values()),
            "ms_an_op": ms,
            "idle_pct": (100.0 * (1 - (traced.busy_s / k) / (window_s / n_ops))
                         if traced.busy_s else None),
            "stage_ms": data.stages, "gap_shares": shares, "idle_gaps": gaps,
            "gaps_by_stage": by_stage}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    prep = run.prepare(spec, args.seed, "cuda", T_START)
    result = readings(prep, args.seconds)
    result["card"] = run.card_line()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
