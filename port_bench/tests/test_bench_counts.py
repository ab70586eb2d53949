"""The frozen work counts against the program: one operation of each cell
at a small size on the CPU, with the card's launch forms, must launch
exactly the kernels, as often and over as many lanes, as ``counts/``
assumes."""

import pytest

from port_bench import run
from port_bench.tests import cells, launches


@pytest.mark.parametrize("cell", cells.CELLS)
def test_launches_are_the_counted_ones(cell):
    prep = cells.prepared(cell)
    spec = prep.spec
    with launches.recorded() as seen:
        prep.mix.op(prep.state, 1)
    want = run.counts_module(spec.traffic).work(spec.config, spec.traffic)
    got = {k: tuple(v) for k, v in seen.items()}
    assert got == {k: (want["launches"][k], want["lanes"][k])
                   for k in want["launches"]}
    for _, k in launches.trace.kernels():
        key = [g for g in got if g.split(".")[0] == k.name]
        assert k.count.launches == sum(got[g][0] for g in key)
