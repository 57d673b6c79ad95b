"""The port's Model on the `fused` provider path and the argmax methods
against the JAX Model on the CPU: ModelConfig(qmm_provider="fused",
attn_kernel="on") through forward, forward_async, forward_async_arrays
and the runtime's Blocking service on both lanes, and argmax_method
exact/packed_fp16/packed_bf16 on the declared provider. Tokens equal;
alignments within 1e-5 (max |diff|).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.config import Config  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.runtime.service import Blocking  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

ALIGN_TOL = 1e-5
SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
LINES = ["hello world", "the quick brown fox", "a b c", "dog"]


FUSED = dataclasses.replace(TINY_TEST_CONFIG, qmm_provider="fused", attn_kernel="on")


@pytest.fixture(scope="module", params=[False, True], ids=["full", "shortlist"])
def fused_models(request):
    pkg = make_package(config=FUSED, with_shortlist=request.param)
    port_pkg = Package(pkg.model, pkg.vocabulary, pkg.shortlist, pkg.ssplit)
    return JaxModel(FUSED, pkg), Model(FUSED, port_pkg, device="cpu")


def test_model_forward_fused_matches_jax(fused_models):
    jax_model, port = fused_models
    assert port._attn_kernel()
    for need_alignment in (False, True):
        want = jax_model.forward(SEGMENTS, need_alignment)
        got = port.forward(SEGMENTS, need_alignment)
        assert [h.target for h in got] == [h.target for h in want]
        for g, w in zip(got, want):
            assert len(g.alignment) == len(w.alignment)
            if w.alignment:
                np.testing.assert_allclose(
                    np.asarray(g.alignment), np.asarray(w.alignment),
                    atol=ALIGN_TOL, rtol=0)


def test_model_async_raw_and_arrays_fused_match_jax(fused_models):
    jax_model, port = fused_models
    tokens, steps, align = port.forward_async(SEGMENTS, False, raw=True)()
    w_tokens, w_steps, w_align = jax_model.forward_async(SEGMENTS, False, raw=True)()
    assert align is None and w_align is None
    np.testing.assert_array_equal(steps, w_steps)
    np.testing.assert_array_equal(tokens, w_tokens)

    indices = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.float32)
    for i, seg in enumerate(SEGMENTS):
        indices[i, : len(seg)] = seg
        mask[i, : len(seg)] = 1.0
    lengths = np.array([len(s) for s in SEGMENTS])
    words = np.concatenate([np.asarray(s) for s in SEGMENTS])
    args = (indices, mask, lengths, len(SEGMENTS))
    got = port.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    want = jax_model.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("prefer_bulk", [False, True], ids=["request", "bulk"])
def test_blocking_fused_matches_jax(fused_models, prefer_bulk):
    jax_model, port = fused_models
    with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
        want = service.translate(jax_model, LINES)
        got = service.translate(port, LINES)
    assert [r.target.text for r in got] == [r.target.text for r in want]


@pytest.mark.parametrize("method", ["exact", "packed_fp16", "packed_bf16"])
@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
def test_model_argmax_methods_match_jax(method, with_shortlist):
    """The argmax methods on the declared provider: the argmax kernel's
    plain version on the CPU, tokens equal to the JAX Model's, through
    forward and both service lanes."""
    config = dataclasses.replace(TINY_TEST_CONFIG, argmax_method=method)
    pkg = make_package(config=config, with_shortlist=with_shortlist)
    jax_model = JaxModel(config, pkg)
    port = Model(config, Package(pkg.model, pkg.vocabulary, pkg.shortlist), device="cpu")
    want = jax_model.forward(SEGMENTS, need_alignment=False)
    got = port.forward(SEGMENTS, need_alignment=False)
    assert [h.target for h in got] == [h.target for h in want]
    for prefer_bulk in (False, True):
        with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
            want_lines = service.translate(jax_model, LINES)
            got_lines = service.translate(port, LINES)
        assert [r.target.text for r in got_lines] == [r.target.text for r in want_lines]


@pytest.mark.parametrize("mode,want", [("on", True), ("auto", False), ("off", False)])
def test_attn_kernel_resolution_on_the_cpu(mode, want):
    """"auto" means on for the port's accelerator (CUDA) only."""
    config = dataclasses.replace(TINY_TEST_CONFIG, attn_kernel=mode)
    pkg = make_package()
    assert Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")._attn_kernel() is want
