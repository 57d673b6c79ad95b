"""The port's utils (slimt_tpu_torch/utils.py) against the JAX package's
(slimt_tpu/utils.py): argsort and the SLIMT_TPU_DEBUG switch alike,
debug_print's stderr the same for a torch tensor as the JAX package's
for the same numpy array; trace a no-op without a directory, and with
one a Chrome trace that names its scope, padded only where the card is
traced."""

import glob
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu import utils as jutils  # noqa: E402
from slimt_tpu_torch import utils  # noqa: E402


@pytest.mark.parametrize("values", [[3, 1, 2], [], [0.5, -1.0, 0.5, 2.0], list("bca")])
def test_argsort_equals_the_jax_package(values):
    assert utils.argsort(values) == jutils.argsort(values)


@pytest.mark.parametrize("value", [None, "", "0", "1", "yes"])
def test_debug_switch_equals_the_jax_package(monkeypatch, value):
    if value is None:
        monkeypatch.delenv("SLIMT_TPU_DEBUG", raising=False)
    else:
        monkeypatch.setenv("SLIMT_TPU_DEBUG", value)
    assert utils.debug_enabled() == jutils.debug_enabled()


@pytest.mark.parametrize("shape,dtype", [((2, 3), np.float32), ((4,), np.int32),
                                         ((2, 2, 2), np.float16)])
def test_debug_print_writes_the_jax_format(monkeypatch, capsys, shape, dtype):
    monkeypatch.setenv("SLIMT_TPU_DEBUG", "1")
    arr = (np.random.default_rng(0).standard_normal(shape) * 3).astype(dtype)
    jutils.debug_print("x", arr)
    want = capsys.readouterr()
    utils.debug_print("x", torch.from_numpy(arr))
    got = capsys.readouterr()
    assert got.err == want.err and got.err.startswith(f"x: shape={shape}")
    assert got.out == ""


def test_debug_print_is_silent_when_off(monkeypatch, capsys):
    monkeypatch.delenv("SLIMT_TPU_DEBUG", raising=False)
    utils.debug_print("x", torch.ones(3))
    assert capsys.readouterr().err == ""


def test_trace_is_a_no_op_without_a_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("SLIMT_TPU_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    with utils.trace("scope"):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("from_env", [False, True], ids=["argument", "SLIMT_TPU_PROFILE"])
def test_trace_writes_a_chrome_trace(monkeypatch, tmp_path, from_env):
    out = tmp_path / "profile"
    if from_env:
        monkeypatch.setenv("SLIMT_TPU_PROFILE", str(out))
    with utils.trace("slimt_scope", None if from_env else str(out)):
        (torch.arange(16.0).reshape(4, 4) @ torch.ones(4, 4)).sum()
    files = glob.glob(str(out / "slimt_scope.*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "slimt_scope" for e in events)


def test_trace_pads_its_window_only_where_the_card_is_traced(monkeypatch, tmp_path):
    """The idle TRACE_PAD_S at each end of the scope is for the card's
    kernels: a CPU-only trace takes none."""
    monkeypatch.setattr(utils, "TRACE_PAD_S", 60.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    start = time.perf_counter()
    with utils.trace("slimt_scope", str(tmp_path)):
        torch.ones(4).sum()
    assert time.perf_counter() - start < 30.0
    assert len(glob.glob(str(tmp_path / "slimt_scope.*.pt.trace.json"))) == 1
