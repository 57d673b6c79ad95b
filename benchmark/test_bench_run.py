"""run.py's refusals and import check, BENCHMARK.json against the
benchmark's contract, and a cell, configuration, mix and metric added as
files elsewhere running without an edit to the harness."""

import ast
import dataclasses
import glob
import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

from benchmark import harness, inputs, readers, testing
from benchmark.reference import bergamot, check

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_import_check_compares_whole_top_level_names(monkeypatch):
    for name in ("jax", "jaxlib", "flax", "slimt_tpu"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "slimt_tpu_torch", sys.modules.get("slimt_tpu_torch", sys))
    monkeypatch.setitem(sys.modules, "slimt_tpu_torchvision_like", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "slimt_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax", "slimt_tpu"]


def imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(HERE, "reference", "*.py"))))
def test_reference_imports_neither_jax_nor_the_program(path):
    assert not set(imported_names(path)) & {"jax", "jaxlib", "flax", "slimt_tpu", "slimt_tpu_torch"}


def test_no_file_of_the_benchmark_imports_jax():
    for path in glob.glob(os.path.join(HERE, "**", "*.py"), recursive=True):
        assert not set(imported_names(path)) & {"jax", "jaxlib", "flax", "slimt_tpu"}, path


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: run.py would run")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "tiny11-bulk", "--seed", "5", "--seconds", "1"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "torch.cuda.is_available() is False" in out.stderr


def test_run_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tiny11-bulk",
                          "--seed", "5", "--seconds", "1"],
                         capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_added_files_run_without_an_edit(tmp_path):
    """A configuration, a mix with a lane of its own, a cell and a metric,
    all new files in another directory, and entries in a BENCHMARK
    object."""
    bench = testing.tiny_cells(str(tmp_path))
    testing.write(str(tmp_path), "configs", "tiny-wide",
                  dict(testing.load("configs", "bergamot-tiny11"), **dict(testing.TINY, emb_dim=48)))
    testing.write(str(tmp_path), "traffic", "short-docs",
                  dict(testing.load("traffic", "bulk-docs"), call_lines=8, pool_lines_per_s=16,
                       line_words={"median": 4, "sigma": 0.3, "min": 1, "max": 8},
                       warm={"min_rounds": 1, "max_s": 2}, lane="one-client", clients=2))
    os.makedirs(tmp_path / "lanes")
    (tmp_path / "lanes" / "one-client.py").write_text(
        "from benchmark.lanes import bulk\n\n\n"
        "class Lane(bulk.Lane):\n"
        "    def __init__(self, spec, *args):\n"
        "        super().__init__(dict(spec, clients=1), *args)\n")
    testing.write(str(tmp_path), "cells", "wide-short", testing.LIMITS)
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "lines_seen.py").write_text(
        "def read(ctx):\n    return len(ctx.window.texts)\n")
    bench["workloads"].append({"name": "wide-short", "config": "tiny-wide",
                               "traffic": "short-docs", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "lines_seen", "unit": "lines", "better": "higher",
                               "source": "program_span", "layer": "runtime",
                               "moves": "tokens_per_s", "workloads": ["wide-short"]})
    for metric in bench["end_to_end"]:
        if metric["name"] == "tokens_per_s":
            metric["workloads"].append("wide-short")
    plain = testing.run(str(tmp_path), "wide-short", bench_object=bench)
    assert plain["correct"] and "tokens_per_s" in plain["metrics"]
    assert '"calls_made_in_window"' in plain["log"][0]
    traced = testing.run(str(tmp_path), "wide-short", traced=True, bench_object=bench)
    assert traced["metrics"]["lines_seen"]["value"] == traced["attempted"]


# A copy of Bergamot's architecture file whose SSRU candidate matrices are
# drawn at half the gain and whose work counts are tripled.
HALVED = """

_bergamot_planted = planted


def planted(name, init):
    gain, mean = _bergamot_planted(name, init)
    return (gain / 2 if name.endswith("_rnn_W") else gain), mean


def _tripled(count):
    return lambda *args: {key: 3 * value for key, value in count(*args).items()}


WORK = {phase: _tripled(count) for phase, count in WORK.items()}
"""


def test_an_added_architecture_runs_without_an_edit(tmp_path, monkeypatch):
    """A configuration in another directory names an architecture file
    there (HALVED). The run is correct, and its weights, its reference and
    the numerators of mfu and the rooflines come from that file."""
    bench = testing.tiny_cells(str(tmp_path))
    os.makedirs(tmp_path / "reference")
    with open(os.path.join(HERE, "reference", "bergamot.py")) as f:
        (tmp_path / "reference" / "halved.py").write_text(f.read() + HALVED)
    with open(tmp_path / "configs" / "tiny.json") as f:
        cfg = dict(json.load(f), name="tiny-halved", reference="reference/halved.py")
    testing.write(str(tmp_path), "configs", "tiny-halved", cfg)
    testing.write(str(tmp_path), "cells", "halved-bulk", testing.LIMITS)
    bench["workloads"].append({"name": "halved-bulk", "config": "tiny-halved",
                               "traffic": "tiny-bulk", "chips": 1, "why": "test"})
    for metric in bench["end_to_end"]:
        if "workloads" in metric:
            metric["workloads"].append("halved-bulk")

    made, references, contexts = [], [], []
    make_inputs, logit_gaps = harness.make_inputs, check.logit_gaps

    def keep_inputs(*args):
        made.append(make_inputs(*args))
        return made[-1]

    def keep_reference(reference, *args):
        references.append(reference)
        return logit_gaps(reference, *args)

    monkeypatch.setattr(harness, "make_inputs", keep_inputs)
    monkeypatch.setattr(check, "logit_gaps", keep_reference)

    class Keeping(harness.Finder):
        """The cell's files, with metric readers that keep the run's context."""

        def module(self, kind, name):
            module = super().module(kind, name)
            if kind != "metrics":
                return module

            def read(ctx):
                contexts.append(ctx)
                return module.read(ctx)

            return types.SimpleNamespace(read=read)

    seed = 2**31 + 9
    result = harness.run_cell(bench, Keeping([str(tmp_path), HERE]), "halved-bulk", seed, 1.0,
                              False, "cpu", harness.process_start(), lambda line: None)
    assert result["correct"], result["checks"]
    assert [type(r).__module__ for r in references] == ["reference_halved"]

    plain = inputs.make_weights(cfg, seed, "cpu", bergamot)
    assert made[0].weights.f32.keys() == plain.f32.keys()
    for name, (q, mult) in made[0].weights.int8.items():
        assert (q == plain.int8[name][0]).all()
        gain = 0.5 if name.endswith("_rnn_W") else 1.0
        assert mult == pytest.approx(plain.int8[name][1] / gain, rel=1e-12), name

    ctx = contexts[0]
    assert ctx.forwards
    unit = {"int8_ops_per_s": 1.0, "f32_flops_per_s": 1.0, "bytes_per_s": 1.0}
    trace = types.SimpleNamespace(op_ns=lambda graph: 1e9)
    mfu = harness.Finder([HERE]).module("metrics", "mfu")

    def numerators(architecture):
        at = dataclasses.replace(ctx, peaks=unit, trace=trace, architecture=architecture)
        return [mfu.read(at), readers.roofline(at, "encoder", graph=False),
                readers.roofline(at, "decode", graph=True)]

    assert numerators(ctx.architecture) == pytest.approx([3 * v for v in numerators(bergamot)])


# -- BENCHMARK.json against the contract -------------------------------------


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]] \
        + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for name in names + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for metric in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    for metric in bench["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for metric in bench["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        if metric["name"].endswith("_roofline"):
            assert metric["unit"] == "%"
    assert len(json.dumps(bench)) < 64 * 1024


def test_cells_files_and_metrics(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    for config in configs.values():
        assert os.path.exists(os.path.join(ROOT, config["file"]))
        assert config["file"].startswith("benchmark/") and len(config["reduced"]) <= 16
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for cell in bench["workloads"]:
        assert cell["config"] in configs and cell["chips"] == 1 and len(cell["why"]) <= 200
        for kind, name in (("traffic", cell["traffic"]), ("cells", cell["name"])):
            assert os.path.exists(os.path.join(HERE, kind, name + ".json"))
        reported = {m["name"] for m in harness.cell_metrics(bench, cell["name"], False)}
        assert "setup_s" in reported and len(reported) >= 2
        layer = harness.cell_metrics(bench, cell["name"], True)
        assert layer and all(m["moves"] in reported for m in layer)
        for metric in [*harness.cell_metrics(bench, cell["name"], False), *layer]:
            assert os.path.exists(os.path.join(HERE, "metrics", metric["name"] + ".py"))
    used = {cell["config"] for cell in bench["workloads"]}
    assert used == set(configs)


def test_run_seconds_fit_the_check_with_every_cell(bench):
    seconds = bench["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    assert (2 + 14 * 24) * (seconds + 60) + 24 * 2 * 90 + 1200 <= 43200


# -- on the card -----------------------------------------------------------------


@pytest.mark.gpu
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, os.path.join(HERE, "run.py"), "--workload",
                          "tiny11-bulk", "--seed", str(2**31 + 11), "--seconds", "3"],
                         capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks" and not math.isnan(line["metrics"]["tokens_per_s"]["value"])
