"""The port's spans (``utils/trace.py``): nothing with tracing off, the
stage tree of a pairing check with it on, one level span per level of a
fold, and launches that are the kernels' own counts."""

import contextlib
import math
import random

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from port_bench.tests import launches
from threshold_crypto_tpu_torch import ops
from threshold_crypto_tpu_torch.device import curve as dcv
from threshold_crypto_tpu_torch.device import pairing as dpr
from threshold_crypto_tpu_torch.host import curve as hcv
from threshold_crypto_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _no_records():
    trace.clear()
    yield
    trace.clear()


class _Dispatched(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@trace.traced("test.stage")
def _stage():
    return 1


def _annotations(prof):
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("on", [False, True])
def test_spans_cost_nothing_off_and_annotate_on(on):
    """Off: one shared do-nothing object, no torch op dispatched, nothing
    recorded, no annotation in the profiler's trace. On: each span is
    recorded and annotated."""
    from torch.profiler import ProfilerActivity, profile

    ctx = trace.enabled() if on else contextlib.nullcontext()
    with ctx, profile(activities=[ProfilerActivity.CPU]) as prof:
        with _Dispatched() as seen:
            with trace.request(3), trace.span("test.block"):
                assert _stage() == 1
    names = [r["name"] for r in trace.records()]
    if on:
        assert names == ["request", "test.block", "test.stage"]
        assert {"request", "test.block", "test.stage"} <= _annotations(prof)
    else:
        assert trace.span("a") is trace.span("b") is trace.request(1)
        assert seen.ops == []
        assert names == []
        assert not {"request", "test.block", "test.stage"} & \
            _annotations(prof)


def test_requests_and_parents():
    """Spans inside a request carry its id; a span outside any request
    carries its outermost span's id; parents are the spans open on the
    thread."""
    with trace.enabled():
        with trace.request("r1"):
            with trace.span("a"):
                _stage()
        with trace.span("b"):
            _stage()
    req, a, s1, b, s2 = trace.records()
    assert [r["request"] for r in (req, a, s1)] == ["r1"] * 3
    assert (a["parent"], s1["parent"]) == (req["id"], a["id"])
    assert b["request"] == b["id"] == s2["request"] and b["parent"] is None
    assert s2["parent"] == b["id"]
    for r in (req, a, s1, b, s2):
        assert r["host_start_ns"] <= r["host_end_ns"]
        assert r["device_ms"] >= 0 and r["launches"] == 0


@pytest.fixture(scope="module")
def pairing_run():
    """One ``verify_batch_pallas`` at 4 lanes inside request 7, tracing on,
    with the card's launch forms counted on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    rnd = random.Random(0x7AC3)
    h = hcv.G2.mul(hcv.G2.generator, rnd.randrange(1, 1 << 20))
    sks = [rnd.randrange(1, 1 << 20) for _ in range(4)]
    args = (dpr.g1_affine_from_host(
                [hcv.G1.mul(hcv.G1.generator, s) for s in sks], device="cpu"),
            dpr.g2_affine_from_host([h] * 4, device="cpu"),
            dpr.g2_affine_from_host([hcv.G2.mul(h, s) for s in sks[:3]]
                                    + [h], device="cpu"))
    trace.clear()
    # the kernels' counts as they were, put back after (the recorder counts
    # into them, and other test files read them)
    counts = [(k.count, k.count.launches, k.count.widest)
              for _, k in trace.kernels()]
    try:
        with launches.recorded() as seen, trace.enabled():
            with trace.request(7):
                mask = ops.verify_batch_pallas(*args)
            rows = trace.records()
    finally:
        trace.clear()
        torch.set_num_threads(n)
        for count, n_launches, widest in counts:
            count.launches, count.widest = n_launches, widest
    return mask, rows, {k: v[0] for k, v in seen.items()}


def test_pairing_check_stage_tree(pairing_run):
    mask, rows, _ = pairing_run
    assert mask.tolist() == [True, True, True, False]
    by_id = {r["id"]: r for r in rows}

    def children(r):
        return [c["name"] for c in rows if c["parent"] == r["id"]]

    top, = [r for r in rows if r["parent"] is None]
    assert (top["name"], top["request"]) == ("request", 7)
    assert {r["request"] for r in rows} == {7}
    assert children(top) == ["ops.verify_batch_pallas"]
    op, = [r for r in rows if r["name"] == "ops.verify_batch_pallas"]
    assert children(op) == ["pairing.check"]
    check, = [r for r in rows if r["name"] == "pairing.check"]
    assert children(check) == ["pairing.miller", "pairing.fold_pairs",
                               "pairing.final_exp", "pairing.is_one"]
    fexp, = [r for r in rows if r["name"] == "pairing.final_exp"]
    assert children(fexp) == ["final_exp.easy", "final_exp.hard"]
    assert len(rows) == len(by_id) == 9
    for r in rows:
        parent = by_id.get(r["parent"])
        if parent is not None:
            assert parent["host_start_ns"] <= r["host_start_ns"]
            assert r["host_end_ns"] <= parent["host_end_ns"]


def test_span_launches_are_the_kernel_counts(pairing_run):
    """A span's launches are the launches counted inside it: the request
    all of them, the Miller loop its B4 and B5, the pair fold its one B8,
    the final exponentiation the rest (its halves' sum), the is-one test
    none."""
    _, rows, seen = pairing_run
    stage = {r["name"]: r["launches"] for r in rows}
    total = sum(seen.values())
    assert stage["request"] == stage["pairing.check"] == total
    assert stage["pairing.miller"] == seen["dbl_fold"] + seen["add_fold"] \
        == 68
    assert stage["pairing.fold_pairs"] == 1
    assert stage["pairing.final_exp"] == total - 69 == \
        stage["final_exp.easy"] + stage["final_exp.hard"]
    assert stage["final_exp.easy"] >= seen["mont_pow.Fq"] == 1
    assert stage["final_exp.hard"] >= seen["cyclo_sqr"] + \
        seen["cyclo_sqr_mul"]
    assert stage["pairing.is_one"] == 0


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_fold_records_one_span_per_level(n):
    curve = dcv.G1
    pts = curve.from_host_affine(
        [hcv.G1.mul(hcv.G1.generator, k + 1) for k in range(n)],
        device="cpu")
    with trace.enabled():
        out = curve.fold_axis(pts)
    rows = trace.records()
    fold, = [r for r in rows if r["name"] == "curve.fold"]
    levels = [r for r in rows if r["name"] == "curve.fold.level"]
    assert len(levels) == math.ceil(math.log2(n))
    assert all(r["parent"] == fold["id"] for r in levels)
    assert curve.to_host_affine(tuple(a[None] for a in out)) == [
        hcv.G1.mul(hcv.G1.generator, n * (n + 1) // 2)]
