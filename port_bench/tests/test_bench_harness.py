"""The harness: what it refuses to run, what it must not import, and how a
later change adds a cell, a mix, a configuration or a metric by files and
entries alone."""

import ast
import json
import os
import subprocess
import sys
import time

import pytest

from port_bench import run
from port_bench.tests import cells

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    """Top-level names of every module a source file imports (relative
    imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and not node.level:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub=""):
    for base, _, files in os.walk(os.path.join(HERE, sub)):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_source_imports_jax_or_the_jax_package():
    banned = set(run.FORBIDDEN) | {"bench", "benches", "chip_smoke",
                                   "tools"}
    for path in _sources():
        assert not _imports(path) & banned, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "threshold_crypto_tpu_torch" not in _imports(path), path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from port_bench import run\n"
            "from port_bench.tests import cells\n"
            "result, found = run.measure(cells.prepared('strict-65536'), 0, 0)\n"
            "print(found, result['correct'])\n") % os.path.dirname(HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_without_a_card_it_exits_2_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would run")
    rc = run.main(["--workload", "strict-65536", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc == 2
    assert capsys.readouterr().out == ""


NEW_METRIC = '''
"""Operations in the window (a reader added as a file)."""
SPANS = []


def read(data):
    return float(data.ops)
'''
NEW_MIX = '''
"""The strict kind under another name (a mix added as a file)."""
from port_bench.mixes.strict import (setup, warm, units, op, check,
                                     control)  # noqa: F401
'''
NEW_COUNTS = '''
from port_bench.counts.strict import work  # noqa: F401
'''


def test_a_new_cell_mix_config_and_metric_are_files_and_entries(
        tmp_path, monkeypatch):
    from port_bench import counts, metrics, mixes

    for pkg, name, text in ((metrics, "ops_in_window", NEW_METRIC),
                            (mixes, "strict_alias", NEW_MIX),
                            (counts, "strict_alias", NEW_COUNTS)):
        d = tmp_path / pkg.__name__.split(".")[-1]
        d.mkdir(exist_ok=True)
        (d / f"{name}.py").write_text(text)
        monkeypatch.setattr(pkg, "__path__", [*pkg.__path__, str(d)])
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    config = dict(json.load(open(os.path.join(
        HERE, "configs", "validator-set-1m.json"))), name="small-set")
    (tmp_path / "small-set.json").write_text(json.dumps(config))
    bench["configs"].append({"name": "small-set", "source": "test",
                             "file": str(tmp_path / "small-set.json"),
                             "reduced": [], "why": "test"})
    # strict-own-messages.json: 8192 pairs a call, with a tail
    traffic = dict(json.load(open(os.path.join(
        HERE, "traffic", "strict-own-messages.json"))), mix="strict_alias",
        **cells.SMALL["strict-65536"]["traffic"])
    (tmp_path / "strict-small.json").write_text(json.dumps(traffic))
    bench["workloads"].append({"name": "strict-small", "config": "small-set",
                               "traffic": "strict-small", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "strict_verifies_per_s":
            m["workloads"].append("strict-small")
    bench["end_to_end"].insert(1, {
        "name": "batch_p95_ms", "unit": "ms", "better": "lower",
        "bound": 0.25, "source": "host_clock", "workloads": ["strict-small"]})
    bench["per_layer"].append({
        "name": "ops_in_window.strict", "unit": "ops", "better": "higher",
        "source": "host_clock", "layer": "entry points",
        "moves": "strict_verifies_per_s", "workloads": ["strict-small"]})
    for traffic_file in os.listdir(os.path.join(HERE, "traffic")):
        (tmp_path / traffic_file).write_text(open(os.path.join(
            HERE, "traffic", traffic_file)).read())
    spec = run.cell_spec("strict-small", bench, str(tmp_path))
    assert [m["name"] for m in spec.e2e] == ["strict_verifies_per_s",
                                             "batch_p95_ms", "setup_s"]
    result, _ = run.run_cell(spec, cells.SEED, 0.0, 1, "cpu",
                             time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["metrics"]["ops_in_window.strict"]["value"] == 1.0
    result, _ = run.run_cell(spec, cells.SEED, 0.0, 0, "cpu",
                             time.perf_counter())
    assert result["correct"], result["checks"]
    assert {k: v["value"] > 0 for k, v in result["metrics"].items()} == {
        "strict_verifies_per_s": True, "batch_p95_ms": True, "setup_s": True}


@pytest.mark.card
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "strict-65536", "--seed", "12345", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=run.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
