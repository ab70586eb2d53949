#!/usr/bin/env python3
"""Readings that set the limits of ``correct``: the program's on sound
seeds and the control's, at the cell's own size, in one process.

    python3 port_bench/control.py --workload <cell> --seed <first> \\
        --sound <n> --control <m> --seconds <s>

Runs the cell ``n`` times as the benchmark does (seeds first, first + 1,
...) and ``m`` times more with the mix's control in place: the program
doing less of its arithmetic (``control()`` of the mix module: fewer
exponent bits in the MSM, one bit of |X| fewer in the pairing, shorter
ladders). Prints one JSON line per run (its seed, kind and compared
numbers), then, per number, the largest sound reading and the smallest
control reading. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench import run  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--sound", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch

    spec = run.cell_spec(args.workload)
    mix = run.mix_module(spec.traffic)
    readings = {"sound": {}, "control": {}}
    plan = ([("sound", args.seed + k) for k in range(args.sound)]
            + [("control", args.seed + args.sound + k)
               for k in range(args.control)])
    for kind, seed in plan:
        t0 = time.perf_counter()
        patch = mix.control() if kind == "control" else \
            contextlib.nullcontext()
        with patch:
            result, _ = run.run_cell(spec, seed, args.seconds, 0, "cuda",
                                     t0)
        checks = {k: v["value"] for k, v in result["checks"].items()}
        print(json.dumps({"kind": kind, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "checks": checks,
                          "seconds": time.perf_counter() - t0}), flush=True)
        for k, v in checks.items():
            readings[kind].setdefault(k, []).append(v)
        torch.cuda.empty_cache()
    summary = {k: {"sound_max": max(v),
                   "control_min": min(readings["control"].get(k, [None])
                                      or [None])}
               for k, v in readings["sound"].items()}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
