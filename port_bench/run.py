#!/usr/bin/env python3
"""Run one cell of the port's benchmark.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the repository's root: a
configuration (``configs/<name>.json``, named by the entry of ``configs``)
and a traffic mix (``traffic/<name>.json``), which names the operation kind
of ``mixes/`` that runs it and sets its sizes. Set-up builds the
program's kernels (cached in ``threshold_crypto_tpu_torch/_build/``), makes
the inputs from the seed on the card and runs the cell's shapes once;
then one caller runs operation after operation, each waited for, for
``--seconds``. ``--trace 0`` reports the cell's end-to-end metrics (rates
over the whole window, and ``setup_s``); ``--trace 1`` runs the same
window with spans around the program's layers, then traces a few more
operations with the profiler and counts the torch ops of one, and reports
the per-layer metrics (``metrics/<name>.py`` reads each). After the window
the reference (``reference/``) judges what the timed operations produced;
each number it compares is printed with its limit on standard error and
under ``checks`` in the result, the last line of standard output.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
if JAX or the JAX package was loaded; neither prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Top-level module names that no run may load (compared whole: the
# program's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "threshold_crypto_tpu")


def _load(path):
    with open(path) as f:
        return json.load(f)


def cell_spec(name, bench=None, traffic_dir=None):
    """The cell ``name`` of a benchmark (by default the repository's
    BENCHMARK.json) with its configuration, traffic mix (from
    ``traffic_dir``, by default ``traffic/`` here) and the metrics it
    reports."""
    bench = bench or _load(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load(os.path.join(ROOT, configs[cell["config"]]["file"]))
    traffic = _load(os.path.join(traffic_dir or os.path.join(HERE, "traffic"),
                                 cell["traffic"] + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return SimpleNamespace(cell=cell, config=config, traffic=traffic,
                           e2e=e2e, per_layer=per_layer)


def mix_module(traffic):
    return importlib.import_module(f"port_bench.mixes.{traffic['mix']}")


def reader(metric_name):
    """The reader of a per-layer metric: ``metrics/<name before the first
    dot>.py``; the part after the dot names the end-to-end metric moved."""
    return importlib.import_module(
        f"port_bench.metrics.{metric_name.split('.')[0]}")


def counts_module(traffic):
    return importlib.import_module(f"port_bench.counts.{traffic['mix']}")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def prepare(spec, seed, device, t_start):
    """Set-up: the kernels built (or found built), the inputs made from the
    seed and the cell's shapes run once. Returns the prepared run."""
    import torch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if on_card:
        from threshold_crypto_tpu_torch import _build
        _build.build()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("build", time.perf_counter()))
    mix = mix_module(spec.traffic)
    ctx = SimpleNamespace(device=dev, seed=int(seed), config=spec.config,
                          traffic=spec.traffic, cell=spec.cell)
    state = mix.setup(ctx)
    if on_card:
        torch.cuda.synchronize(dev)
    marks.append(("inputs", time.perf_counter()))
    for i in mix.warm(state):
        mix.op(state, i)
    if on_card:
        torch.cuda.synchronize(dev)
    marks.append(("warm", time.perf_counter()))
    print("setup s: " + ", ".join(
        f"{name} {t - marks[k][1]:.3f}"
        for k, (name, t) in enumerate(marks[1:])), file=sys.stderr)
    return SimpleNamespace(spec=spec, dev=dev, on_card=on_card, mix=mix,
                           state=state, setup_s=marks[-1][1] - t_start)


def run_cell(spec, seed, seconds, trace, device, t_start):
    """One run of a cell on ``device``; returns (result, forbidden modules
    loaded)."""
    return measure(prepare(spec, seed, device, t_start), seconds, trace)


def measure(prep, seconds, trace):
    """The measured window of a prepared run, the traced readings, and the
    reference's verdict."""
    import torch

    from port_bench import spans as spans_mod
    from port_bench import trace as trace_mod

    spec, dev, on_card = prep.spec, prep.dev, prep.on_card
    mix, state, setup_s = prep.mix, prep.state, prep.setup_s

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    min_ops = int(spec.traffic.get("min_ops", 1))
    targets = []
    if trace:
        for m in spec.per_layer:
            for t in reader(m["name"]).SPANS:
                if t not in targets:
                    targets.append(t)
    timer = spans_mod.SpanTimer(dev)
    records, latencies = [], []
    with spans_mod.patched(timer, targets):
        sync()
        w0 = time.perf_counter()
        while True:
            t = time.perf_counter()
            records.append(mix.op(state, len(records)))
            sync()
            latencies.append(time.perf_counter() - t)
            if (time.perf_counter() - w0 >= seconds
                    and len(records) >= min_ops):
                break
        window_s = time.perf_counter() - w0
    n_ops = len(records)
    ms = sorted(1e3 * t for t in latencies)
    print(f"window: {n_ops} ops in {window_s:.3f} s; ms an op: first "
          f"{1e3 * latencies[0]:.2f}, min {ms[0]:.2f}, median "
          f"{statistics.median(ms):.2f}, max {ms[-1]:.2f}", file=sys.stderr)
    units = mix.units(state)

    out_metrics, device_info, breakdown = {}, {}, None
    if not trace:
        for m in spec.e2e:
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] in spec.traffic.get("tails", {}):
                pct = int(spec.traffic["tails"][m["name"]])
                value = 1e3 * (statistics.quantiles(latencies, n=100)[pct - 1]
                               if len(latencies) > 1 else latencies[0])
            else:
                unit = spec.traffic["rates"][m["name"]]
                value = units[unit] * n_ops / window_s
            out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        span_ms = timer.ms()
        traced = SimpleNamespace(busy_s=None, window_s=None, ops=0)
        if on_card:
            k = int(spec.traffic["trace_ops"])

            def traced_ops():
                for _ in range(k):
                    records.append(mix.op(state, len(records)))
                    sync()

            events, wall = trace_mod.profile(traced_ops, with_host=False)
            busy_s, device_ops = trace_mod.busy(events)
            traced = SimpleNamespace(busy_s=busy_s, window_s=wall, ops=k)
            with spans_mod.patched(spans_mod.SpanTimer(dev), targets):
                events, _ = trace_mod.profile(
                    lambda: records.append(mix.op(state, len(records))),
                    with_host=True)
            sync()
            breakdown = {"device_ops": device_ops,
                         "idle_gaps": trace_mod.idle_gaps(events)}
            device_info.update(busy_s=busy_s, window_s=wall)
        torch_ops = trace_mod.torch_ops(
            lambda: records.append(mix.op(state, len(records))))
        sync()
        data = SimpleNamespace(
            spans=span_ms, ops=n_ops, window_s=window_s, traced=traced,
            torch_ops=torch_ops,
            work=counts_module(spec.traffic).work(spec.config, spec.traffic))
        for m in spec.per_layer:
            value = reader(m["name"]).read(data)
            if value is not None:
                out_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    if on_card:
        sync()
        device_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(dev))
    verdict = mix.check(state, records)
    checks = verdict["checks"]
    correct = all(c["value"] <= c["limit"] for c in checks)
    result = {"correct": correct, "attempted": len(records),
              "failed": int(verdict["failed"]), "metrics": out_metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {c["name"]: {"value": c["value"],
                                    "limit": c["limit"]} for c in checks}
    return result, forbidden_modules()


def card_line():
    """The card's name and power limit, from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)

    import torch

    chips = int(spec.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, found = run_cell(spec, args.seed, args.seconds, args.trace,
                             "cuda", T_START)
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
