"""The port's Model dispatch (slimt_tpu_torch/models/model.py): forward_async
returns once the batch is queued on the Model's dispatch worker, batches run
in submission order, a worker error surfaces from finish() and the next
batch still serves, and Model's first three positional parameters mean what
they mean in the JAX Model. Tokens against the JAX Model on the CPU.
"""

import gc
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from slimt_tpu_torch.models import model as model_module  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
WAIT_S = 60.0


@pytest.fixture(scope="module")
def pkg():
    return make_package()


@pytest.fixture(scope="module")
def jax_model(pkg):
    return JaxModel(TINY_TEST_CONFIG, pkg)


@pytest.fixture
def port(pkg):
    return Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu")


def _targets(hyps):
    return [h.target for h in hyps]


def test_forward_async_returns_while_the_decode_is_blocked(port, jax_model, monkeypatch):
    release = threading.Event()
    entered = threading.Event()
    real = model_module.translate_batch

    def blocked(*args, **kwargs):
        entered.set()
        assert release.wait(WAIT_S), "never released"
        return real(*args, **kwargs)

    monkeypatch.setattr(model_module, "translate_batch", blocked)
    finish = port.forward_async(SEGMENTS, need_alignment=False)
    # Returned with the decode still held: the worker has entered it, or
    # not yet started it.
    assert not release.is_set()
    assert entered.wait(WAIT_S)
    release.set()
    want = jax_model.forward(SEGMENTS, need_alignment=False)
    assert _targets(finish()) == _targets(want)


def test_batches_run_in_submission_order_and_finish_in_any(port, monkeypatch):
    batches = [SEGMENTS, SEGMENTS[:2], [[6, 6, 3, 0], [9, 0]]]
    want = [_targets(port.forward(b, need_alignment=False)) for b in batches]
    ran = []
    real = model_module.translate_batch

    def recording(params, indices, *args, **kwargs):
        ran.append(int(indices.shape[0]))
        return real(params, indices, *args, **kwargs)

    monkeypatch.setattr(model_module, "translate_batch", recording)
    finishes = [port.forward_async(b, need_alignment=False) for b in batches]
    got = [None] * len(batches)
    for i in reversed(range(len(batches))):
        got[i] = _targets(finishes[i]())
    assert got == want
    assert ran == [4, 2, 2]  # the B buckets, in submission order


def test_raw_and_arrays_are_queued_too(port, jax_model):
    finishes = [port.forward_async(SEGMENTS, False, raw=True) for _ in range(2)]
    w_tokens, w_steps, _ = jax_model.forward_async(SEGMENTS, False, raw=True)()
    indices = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.float32)
    for i, seg in enumerate(SEGMENTS):
        indices[i, : len(seg)] = seg
        mask[i, : len(seg)] = 1.0
    arrays = port.forward_async_arrays(indices, mask, [len(s) for s in SEGMENTS], 4, raw=True)
    indices[:] = 0  # the caller may reuse its buffers once dispatch returns
    mask[:] = 0
    for tokens, steps, align in [f() for f in finishes] + [arrays()]:
        assert align is None
        np.testing.assert_array_equal(steps, w_steps)
        np.testing.assert_array_equal(tokens, w_tokens)


def test_worker_error_surfaces_from_finish_and_the_next_batch_serves(port, monkeypatch):
    want = _targets(port.forward(SEGMENTS, need_alignment=False))
    real = model_module.translate_batch
    calls = []

    def failing_once(*args, **kwargs):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(model_module, "translate_batch", failing_once)
    failed = port.forward_async(SEGMENTS, need_alignment=False)
    served = port.forward_async(SEGMENTS, need_alignment=False)
    with pytest.raises(RuntimeError, match="device fault"):
        failed()
    with pytest.raises(RuntimeError, match="device fault"):
        failed()  # every fetch raises, as a JAX async error does
    assert _targets(served()) == want
    assert _targets(port.forward(SEGMENTS, need_alignment=False)) == want


def test_input_errors_raise_from_forward_async(port):
    with pytest.raises(ValueError):
        port.forward_async([], need_alignment=False)


def test_limit_factor_is_the_third_positional_parameter(pkg):
    """Model(cfg, pkg, 2.0) means the same in both packages, on a segment
    long enough that the random weights run to the cap."""
    port = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), 2.0, device="cpu")
    jax_model = JaxModel(TINY_TEST_CONFIG, pkg, 2.0)
    assert port.limit_factor == jax_model.limit_factor == 2.0
    segments = [[5, 9, 4, 7, 2, 0], [3, 0]]
    got = _targets(port.forward(segments, need_alignment=False))
    assert got == _targets(jax_model.forward(segments, need_alignment=False))
    caps = [int(2.0 * max(len(s) for s in segments))] * len(segments)
    assert any(len(g) == c for g, c in zip(got, caps)), (got, caps)
    short = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), 1.0, device="cpu")
    assert max(len(g) for g in _targets(short.forward(segments, need_alignment=False))) <= 6


def test_device_is_keyword_only(pkg):
    package = Package(pkg.model, pkg.vocabulary)
    with pytest.raises(TypeError, match="device='cpu'"):
        Model(TINY_TEST_CONFIG, package, "cpu")
    with pytest.raises(TypeError):
        Model(TINY_TEST_CONFIG, package, 1.5, "cpu")


def test_one_worker_per_model_ends_with_the_model(pkg):
    model = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu")
    model.forward(SEGMENTS, need_alignment=False)
    model.forward(SEGMENTS, need_alignment=False)
    name = f"slimt-dispatch-{model.id}"
    workers = [t for t in threading.enumerate() if t.name == name]
    assert len(workers) == 1 and workers[0].daemon
    del model
    gc.collect()
    workers[0].join(WAIT_S)
    assert not workers[0].is_alive()

