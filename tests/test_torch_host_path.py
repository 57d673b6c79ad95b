"""The port's stubbed device forward and its host-path tools against the JAX
package, on the CPU: utils.stub_device_forward on every Model entry point
and both raw modes; the same corpus through each package's stubbed Async
and Blocking.translate_bulk (the JAX side through scripts/ubench_host_path.py
itself); the server's switch, SLIMT_TPU_TORCH_STUB_DEVICE, in process and in
a `python -m slimt_tpu_torch.server` subprocess answering the JAX stub's
echo; `python -m slimt_tpu_torch.host_path` and `python -m
slimt_tpu_torch.fleet budget` at small sizes with --device cpu.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
import time
import urllib.request
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.config import Config as JaxConfig  # noqa: E402
from slimt_tpu.config import preset as jax_preset  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.models.model import Package as JaxPackage  # noqa: E402
from slimt_tpu.runtime.service import Async as JaxAsync  # noqa: E402
from slimt_tpu.utils import stub_device_forward as jax_stub  # noqa: E402
from slimt_tpu_torch import Model, Package, cli, fleet, host_path, server  # noqa: E402
from slimt_tpu_torch.ops import launches  # noqa: E402
from slimt_tpu_torch.utils import stub_device_forward  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script(name):
    """One of the JAX package's scripts/ as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    return module


@pytest.fixture(scope="module")
def models():
    """A JAX Model and a port CPU Model of one package, each stubbed."""
    package = make_package()
    jax = JaxModel(TINY_TEST_CONFIG, package)
    port = Model(TINY_TEST_CONFIG, Package(package.model, package.vocabulary), device="cpu")
    jax_stub(jax)
    stub_device_forward(port)
    return jax, port


def _segments(eos):
    rng = np.random.default_rng(3)
    return [list(rng.integers(3, 60, n)) + [eos] for n in (4, 11, 1, 7)]


def _arrays(pad, eos):
    segments = _segments(eos)
    indices = np.full((8, 16), pad, np.int32)
    mask = np.zeros((8, 16), np.float32)
    for i, s in enumerate(segments):
        indices[i, : len(s)] = s
        mask[i, : len(s)] = 1.0
    return indices, mask, np.array([len(s) for s in segments]), len(segments)


def _call(model, entry, raw, segments, arrays):
    if entry == "forward":
        return model.forward(segments)
    if entry == "forward_async":
        return model.forward_async(segments, need_alignment=False, raw=raw)()
    indices, mask, lengths, batch = arrays
    return model.forward_async_arrays(indices, mask, lengths, batch, raw=raw)()


@pytest.mark.parametrize("entry,raw", [
    ("forward", False), ("forward_async", False), ("forward_async", True),
    ("forward_async_arrays", False), ("forward_async_arrays", True)])
def test_stub_matches_the_jax_stub_on_every_entry_point(models, entry, raw):
    jax, port = models
    vocab = port.vocabulary
    segments = _segments(vocab.eos_id)
    arrays = _arrays(vocab.pad_id, vocab.eos_id)
    got = _call(port, entry, raw, segments, arrays)
    want = _call(jax, entry, raw, segments, arrays)
    if raw:
        (toks, steps, align), (want_toks, want_steps, want_align) = got, want
        assert toks.dtype == np.int32 and steps.dtype == np.int32
        np.testing.assert_array_equal(toks, np.asarray(want_toks))
        np.testing.assert_array_equal(steps, np.asarray(want_steps))
        assert align is None and want_align is None
    else:
        assert [(h.target, h.alignment) for h in got] == [
            (h.target, h.alignment) for h in want]
        assert [h.target for h in got] == [list(s) for s in segments]


@pytest.fixture(scope="module")
def host_models():
    """The host-path scripts' small Model in each package, stubbed: the JAX
    one by scripts/ubench_host_path.py itself."""
    ubench = script("ubench_host_path")
    jax = ubench.build_model()
    ubench.stub_forward(jax)
    port = host_path.build_model("cpu")
    stub_device_forward(port)
    return ubench, jax, port


@pytest.mark.parametrize("lane", ["run", "run_bulk"])
def test_stubbed_service_answers_equal_the_jax_package(host_models, lane):
    ubench, jax, port = host_models
    lines = host_path.corpus(300)
    assert lines == ubench.corpus(300)
    launches.reset()
    got = getattr(host_path, lane)(port, lines, 4)
    want = getattr(ubench, lane)(jax, lines, 4)

    def summary(responses):
        return [(r.target.text, r.target.sentence_count(),
                 [r.target.word_count(s) for s in range(r.target.sentence_count())])
                for r in responses]

    assert summary(got) == summary(want)
    assert [r.target.text for r in got] == lines  # the echo
    # The stubbed Model launched nothing and never started its worker.
    assert not any(launches.snapshot().values())
    assert port._worker is None


def test_stubbed_model_never_queues_on_its_dispatch_worker():
    package = make_package()
    plain = Model(TINY_TEST_CONFIG, Package(package.model, package.vocabulary), device="cpu")
    stubbed = Model(TINY_TEST_CONFIG, Package(package.model, package.vocabulary), device="cpu")
    stub_device_forward(stubbed)
    segments = _segments(plain.vocabulary.eos_id)
    plain.forward(segments)
    assert [h.target for h in stubbed.forward(segments)] == segments
    assert plain._worker is not None and stubbed._worker is None
    with pytest.raises(RuntimeError, match="stubbed"):
        stubbed._dispatch(*_arrays(0, 0)[:3], 4, False, None)


@pytest.mark.parametrize("environ,stubbed", [
    ({"SLIMT_TPU_TORCH_STUB_DEVICE": "1"}, True),
    ({"SLIMT_TPU_STUB_DEVICE": "1"}, False),
    ({}, False),
    ({"SLIMT_TPU_TORCH_STUB_DEVICE": "0", "SLIMT_TPU_STUB_DEVICE": "1"}, False),
])
def test_server_switch_reads_the_ports_variable_alone(environ, stubbed, capsys):
    package = make_package()
    model = Model(TINY_TEST_CONFIG, Package(package.model, package.vocabulary), device="cpu")
    assert server.stub_if_asked(model, environ) is stubbed
    printed = capsys.readouterr().out
    line = "device forward STUBBED (SLIMT_TPU_TORCH_STUB_DEVICE=1)\n"
    assert printed == (line if stubbed else "")
    assert ("forward_async" in vars(model)) is stubbed
    segment = [[5, 9, 4, model.vocabulary.eos_id]]
    hyp = model.forward(segment)[0]
    assert (hyp.target == segment[0]) is stubbed
    assert (model._worker is None) is stubbed


def _post(url, payload):
    request = urllib.request.Request(url + "/translate", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(request, timeout=120) as resp:
        return json.loads(resp.read())


def test_server_subprocess_under_the_variable_answers_the_jax_echo(tmp_path):
    root = str(tmp_path / "pkg")
    with redirect_stdout(io.StringIO()):
        assert cli.main(["synth", "--out", root]) == 0
    port = fleet.free_port()
    env = dict(os.environ, PYTHONPATH=REPO, SLIMT_TPU_TORCH_STUB_DEVICE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "slimt_tpu_torch.server", "--root", root, "--device", "cpu",
         "--port", str(port)], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        first = proc.stdout.readline()
        url = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                with urllib.request.urlopen(url + "/health", timeout=5) as resp:
                    break
            except OSError:
                assert time.time() < deadline and proc.poll() is None
                time.sleep(0.2)
        texts = fleet.corpus(5, seed=4)
        single = _post(url, {"text": texts[0]})["target"]
        many = _post(url, {"texts": texts})["targets"]
        with urllib.request.urlopen(url + "/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    assert first == "device forward STUBBED (SLIMT_TPU_TORCH_STUB_DEVICE=1)\n"
    jax = JaxModel(jax_preset.tiny(), JaxPackage(model=os.path.join(root, "model.bin"),
                                                 vocabulary=os.path.join(root, "vocab.spm")))
    jax_stub(jax)
    with JaxAsync(JaxConfig(workers=1)) as service:
        want = [h.result(60).target.text for h in service.translate_many(jax, texts)]
    assert [single] + many == want[:1] + want
    assert want == texts
    assert set(stats["launches"]) == set(launches.SERVING)
    assert not any(stats["launches"].values())


def test_host_path_budget_prints_the_jax_keys_and_the_rate_source(monkeypatch):
    budget = script("ubench_host_budget")
    monkeypatch.setattr(sys, "argv", ["ubench_host_budget.py", "--lines", "200"])
    out = io.StringIO()
    with redirect_stdout(out):
        budget.main()
    want = json.loads(out.getvalue())
    out = io.StringIO()
    with redirect_stdout(out):
        assert host_path.main(["budget", "--device", "cpu", "--lines", "200",
                               "--device-rate", "1"]) == 0
    got = json.loads(out.getvalue())
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"device_rate_source", "device_rate_run",
                                    "bulk_host_launches", "device", "card"}
    assert got["device_rate_source"] == "given" and got["device_rate_run"] is None
    assert got["device_rate_budgeted"] == 1.0 and got["card"] == "cpu"
    assert set(got["bulk_host"]) == set(want["bulk_host"])
    for row in got["bulk_host"].values():
        assert {"tokens_per_sec", "host_us_per_token"} <= set(row)
    assert got["lines"] == want["lines"] == 200
    assert not any(got["bulk_host_launches"].values())


@pytest.mark.parametrize("bulk", [False, True])
def test_host_path_prints_the_ceiling(host_models, bulk, capsys):
    ubench, jax, _ = host_models
    lines = ubench.corpus(400)
    want = sum(r.target.word_count(s) for r in ubench.run(jax, lines, 4)
               for s in range(r.target.sentence_count()))
    capsys.readouterr()
    argv = ["path", "--device", "cpu", "--lines", "400"] + (["--bulk"] if bulk else [])
    assert host_path.main(argv) == 0
    line = capsys.readouterr().out.strip()
    assert line.startswith(f"host ceiling: {want} target tokens in ")
    assert line.endswith(f"(workers=4, {'bulk' if bulk else 'async'}) on cpu")


def test_fleet_budget_pushes_the_in_process_echo():
    jax_fleet = script("fleet_budget")
    out = fleet.run("budget", 200, [1], "cpu", log=lambda line: None)
    assert out["stubbed"] and out["card"] == "cpu"
    for key in ("local_bulk_tps", "direct_tps", "transport_cost_pct"):
        assert out[key] > 0 or key == "transport_cost_pct"
    assert set(out["router_tps"]) == {"1"} and out["router_tps"]["1"] > 0
    assert out["fleet_efficiency"] == {"1": 1.0}
    echo = []
    for seed in range(fleet.ITERS):
        texts = fleet.corpus(200, seed=seed)
        assert texts == jax_fleet.corpus(200, seed=seed)
        echo.append(sum(len(t.split()) for t in texts))
    assert out["tokens"] == {"local_bulk": echo, "direct": echo, "router1": echo}
    assert not any(v for row in out["launches"].values() for c in row for v in c.values())


@pytest.mark.parametrize("argv", [
    ["host_path", "path", "--lines", "8"],
    ["host_path", "budget", "--lines", "8"],
    ["fleet", "budget", "--lines", "8", "--backends", "1"],
])
def test_default_device_without_a_card_is_an_error(argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    module = host_path if argv[0] == "host_path" else fleet
    with pytest.raises(RuntimeError, match="is_available"):
        module.main(argv[1:])


def test_fleet_chunks_follow_the_router():
    from slimt_tpu_torch.runtime import router

    texts = [str(i) for i in range(11)]
    assert fleet.chunks(texts, 1) == [texts]
    assert fleet.chunks(texts[:5], 2) == [texts[:5]]  # under min_shard
    assert fleet.chunks(texts, 3) == [texts[:3], texts[3:7], texts[7:]]
    assert router.Router.__init__.__defaults__[3:5] == (True, 8)  # shard, min_shard
