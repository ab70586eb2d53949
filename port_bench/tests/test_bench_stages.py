"""The stage readers of ``stages.py`` rehearsed on the CPU: the traced pass
(b) of one operation of each cell at a small size, with the card's launch
forms counted, gives the stage ms of the pairing cells and exactly the
frozen launch count; the wait readers need the profiled pass (a), which
runs only on a card, and read nothing here. ``gap_shares`` is held to a
hand-made trace."""

from types import SimpleNamespace

import pytest

from port_bench import run, stages
from port_bench.tests import cells, launches
from threshold_crypto_tpu_torch.utils import trace

PAIRING_CELLS = {"strict-65536", "decrypt-epoch-256", "rlc-1m"}


@pytest.mark.parametrize("cell", cells.CELLS)
def test_traced_pass_reads_stages_and_frozen_launches(cell):
    prep = cells.prepared(cell)
    spec = prep.spec
    records = []

    def run_op():
        records.append(prep.mix.op(prep.state, len(records)))

    with launches.recorded():
        passed = stages.traced_pass(trace, run_op, 1)
    work = run.counts_module(spec.traffic).work(spec.config, spec.traffic)
    data = SimpleNamespace(
        ops=1, window_s=1.0, gap_shares={}, stages=passed.stage_ms,
        launches=passed.launches,
        traced=SimpleNamespace(busy_s=None, window_s=None, ops=0))
    got = stages.read(data)
    assert got["launches_per_op"] == sum(work["launches"].values())
    assert ("miller_ms" in got) == ("final_exp_ms" in got) == \
        (cell in PAIRING_CELLS)
    assert all(got.get(k, 1) > 0 for k in ("miller_ms", "final_exp_ms"))
    assert "fold_wait_ms" not in got and "pairing_wait_ms" not in got
    assert prep.mix.check(prep.state, records)["failed"] == 0


def _rec(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


def test_gap_shares_split_the_idle_time_by_open_stage():
    """Kernels at 0-10, 20-30, 50-60 us: gaps of 10 and 20 us with middles
    at 15 and 40. "fold" covers the first gap, "fold.level" inside it
    too, "check" the second; an annotation of another thread counts for
    nothing. By innermost stage each gap counts once."""
    events = [
        _rec("kernel", "k", 0, 10, tid=7), _rec("kernel", "k", 20, 10, tid=7),
        _rec("kernel", "k", 50, 10, tid=7),
        _rec("user_annotation", "fold", 5, 25),
        _rec("user_annotation", "fold.level", 12, 6),
        _rec("user_annotation", "check", 32, 30),
        _rec("cpu_op", "aten::add", 38, 4),
        _rec("user_annotation", "other", 0, 60, tid=2),
    ]
    assert stages.gap_shares(events) == pytest.approx(
        {"fold": 1 / 3, "fold.level": 1 / 3, "check": 2 / 3})
    assert stages.gaps_by_stage(events) == pytest.approx(
        {"check": 20e-6, "fold.level": 10e-6})
    names = dict(stages.trace_mod.idle_gaps(events))
    assert names == pytest.approx({"check: aten::add": 20e-6,
                                   "fold.level: python": 10e-6})
