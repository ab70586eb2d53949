"""The cells at sizes a CPU test run can hold: the same mixes and the same
harness, with the configuration's and the traffic's sizes cut.

``rlc-1m`` is not in BENCHMARK.json (host dispatch paces it, and its runs
spread too widely for a bound); its mix, counts and traffic stay, and the
tests rehearse it as the entry below, so that a later change can add the
cell back by entries alone."""

import json
import os
import time

from port_bench import run

ASIDE = {
    "workloads": [
        {"name": "rlc-1m", "config": "validator-set-1m",
         "traffic": "rlc-one-message", "chips": 1}],
    "end_to_end": [
        {"name": "rlc_verifies_per_s", "unit": "verifies/s",
         "workloads": ["rlc-1m"]}],
}
SMALL = {
    "rlc-1m": {"config": {"signers": 16, "check_batch": 2},
               "traffic": {"tamper_every": 2, "deep": 1, "input_sample": 2,
                           "min_ops": 2}},
    "strict-65536": {"config": {},
                     "traffic": {"batch": 8, "input_sample": 2,
                                 "infinity": {"1": "pk", "3": "sig",
                                              "5": "both"},
                                 "min_ops": 1}},
    "dkg-deal-256": {"config": {"nodes": 4, "threshold": 1},
                     "traffic": {"tamper_every": 2, "deep": 1,
                                 "zero_pos": 1, "coeff_sample": 2,
                                 "node_sample": 2, "row_sample": 2,
                                 "min_ops": 2}},
    "decrypt-epoch-256": {"config": {"nodes": 3, "threshold": 1},
                          "traffic": {"bad_nodes": 1, "deep": 1,
                                      "deep_among": 1, "share_sample": 2,
                                      "input_sample": 2, "min_ops": 1}},
}
CELLS = tuple(SMALL)
SEED = 3_000_000_019


def bench():
    """BENCHMARK.json with the cells kept aside."""
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        out = json.load(f)
    for key, entries in ASIDE.items():
        out[key] = out[key] + entries
    return out


def small_spec(cell):
    spec = run.cell_spec(cell, bench())
    spec.config.update(SMALL[cell]["config"])
    spec.traffic.update(SMALL[cell]["traffic"])
    return spec


def prepared(cell, seed=SEED):
    import torch

    torch.set_num_threads(2)
    return run.prepare(small_spec(cell), seed, "cpu", time.perf_counter())
