"""Rehearsals of every cell on the CPU at a small size: the whole run but
the look for a card, with the program's plain kernel versions.

A sound run is correct. The mix's control (the program doing less of its
arithmetic) is not, and neither is a run with the timed path broken
underneath in each way the cell can break: half of the batch left out
(its answers copied from the other half), and an answer altered where it
is produced. The cells have no state carried between operations and run
on one chip, so a step returning its state unchanged and a missing
exchange between chips are faults none of them can have.
"""

import contextlib

import pytest
import torch

from port_bench import run
from port_bench.tests import cells


def _tree(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_tree(fn, t) for t in tree)
    return fn(tree)


def _halved(tree):
    """Each leaf's first half, repeated over the second."""
    def half(a):
        h = a.shape[0] // 2
        return torch.cat([a[:h], a[:h], a[2 * h:]])
    return _tree(half, tree)


def _lane_altered(tree):
    """Lane 0 replaced by lane 1."""
    def alter(a):
        a = a.clone()
        a[0] = a[1]
        return a
    return _tree(alter, tree)


def _wrapped(module, name, after=None, before=None):
    """Patch module.name to transform its arguments or its output."""
    mp = pytest.MonkeyPatch()
    inner = getattr(module, name)

    def run_(*args, **kwargs):
        if before is not None:
            args = before(*args)
        out = inner(*args, **kwargs)
        return out if after is None else after(out)

    mp.setattr(module, name, run_)
    return mp


def _faults(cell):
    from threshold_crypto_tpu_torch.ops import threshold as tops

    def first_half_rlc(pk, sig, r, *rest):
        h = r.shape[0] // 2
        return (_tree(lambda a: a[:h], pk), _tree(lambda a: a[:h], sig),
                r[:h], *rest)

    faults = {
        "rlc-1m": {
            "half of the batch left out": lambda: _wrapped(
                tops, "rlc_aggregate_pallas", before=first_half_rlc),
            "verdict altered": lambda: _wrapped(
                tops, "verify_sig_shares_rlc_pallas",
                after=torch.logical_not),
        },
        "strict-65536": {
            "half of the batch left out": lambda: _wrapped(
                tops, "verify_batch_pallas", after=_halved),
            "a lane's answer altered": lambda: _wrapped(
                tops, "verify_batch_pallas",
                after=lambda m: torch.cat([~m[:1], m[1:]])),
        },
        "dkg-deal-256": {
            "half of the nodes left out": lambda: _wrapped(
                tops, "bivar_commit_row_batch", after=_halved),
            "a commitment altered": lambda: _wrapped(
                tops, "bivar_commit_batch", after=_lane_altered),
        },
        "decrypt-epoch-256": {
            "half of the shares left out": lambda: _wrapped(
                tops, "verify_dec_share_batch", after=_halved),
            "a decryption share altered": lambda: _wrapped(
                tops, "decrypt_share_batch", after=_lane_altered),
        },
    }
    return faults[cell]


@pytest.fixture(scope="module", params=cells.CELLS)
def prep(request):
    return cells.prepared(request.param)


def _measure(prep, patch=None):
    with patch if patch is not None else contextlib.nullcontext():
        result, found = run.measure(prep, 0.0, 0)
    return result, found


def test_sound_run_is_correct(prep):
    result, found = _measure(prep)
    assert found == []
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in prep.spec.e2e}
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_control_is_not_correct(prep):
    result, _ = _measure(prep, prep.mix.control())
    assert not result["correct"], result["checks"]


def test_faults_are_not_correct(prep):
    for name, fault in _faults(prep.spec.cell["name"]).items():
        mp = fault()
        try:
            result, _ = run.measure(prep, 0.0, 0)
        finally:
            mp.undo()
        assert not result["correct"], (name, result["checks"])
