"""The port's int8 affine (slimt_tpu_torch/ops/qmm.py) against the JAX
package's ops/qmm (xla_int8) and ops/qmm_pallas (interpret mode).

The plain version runs here on the CPU; the CUDA kernel is held
against it on the card by tests/test_torch_gpu.py. Inputs are made with
numpy from a seed and handed to both frameworks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.ops import qmm as jqmm  # noqa: E402
from slimt_tpu.ops import qmm_pallas  # noqa: E402
from slimt_tpu_torch.ops import qmm  # noqa: E402


def _operands(m, k, n, seed, aq=20.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 2.0).astype(np.float32)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    b = (rng.standard_normal(n) * 0.05).astype(np.float32)
    aq = np.float32(aq)
    bq = np.float32(rng.uniform(50.0, 200.0))
    inv = np.float32(1) / (aq * bq)
    return x, w, b, aq, bq, inv


SHAPES = [(37, 256, 300), (1, 32, 64), (5, 100, 33), (16, 1536, 256)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_affine_bit_equal_to_xla_int8(m, k, n):
    x, w, b, aq, bq, inv = _operands(m, k, n, seed=m + k + n)
    want = np.asarray(
        jqmm.affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                    jnp.asarray(aq), jnp.asarray(bq), provider="xla_int8")
    )
    got = qmm.affine(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), aq, inv).numpy()
    np.testing.assert_array_equal(got, want)
    relu = qmm.affine(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), aq, inv, relu=True).numpy()
    np.testing.assert_array_equal(relu, np.maximum(want, 0.0))


@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_dot_and_accumulator_bit_equal(m, k, n):
    x, w, _, aq, bq, inv = _operands(m, k, n, seed=7 * m + n)
    xj, wj = jnp.asarray(x), jnp.asarray(w)
    want_dot = np.asarray(
        jqmm.dot(xj, wj, jnp.asarray(aq), jnp.asarray(bq), provider="xla_int8")
    )
    got_dot = qmm.dot(torch.from_numpy(x), torch.from_numpy(w), aq, inv)
    np.testing.assert_array_equal(got_dot.numpy(), want_dot)
    want_acc = np.asarray(
        jqmm._int8_matmul(jqmm.quantize_activations(xj, jnp.asarray(aq)), wj)
    )
    got_acc = qmm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), aq)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), want_acc)


def test_accumulator_exact_beyond_float32():
    """FFN2-class K: |acc| beyond 2^24, where a float32 matmul of int8
    values would round; the plain accumulator stays exact."""
    k = 1536
    x = np.full((2, k), 10.0, np.float32)
    w = np.full((k, 3), 127, np.int8)
    w[0, 0] = 126
    acc = qmm.int8_matmul(torch.from_numpy(x), torch.from_numpy(w), 12.7)
    want = 127 * (127 * k) - 127
    assert want > 2**24
    assert int(acc[0, 0]) == want
    assert int(acc[0, 1]) == 127 * 127 * k


def test_affine_within_pallas_interpret():
    x, w, b, aq, bq, inv = _operands(37, 256, 300, seed=3)
    want = np.asarray(
        qmm_pallas.affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          jnp.asarray(aq), jnp.asarray(bq), interpret=True)
    )
    got = qmm.affine(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), aq, inv).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_strided_weight_matches_contiguous():
    """The tied projection passes the [V, E] embedding's transpose as a
    strided view; the result equals the contiguous copy's."""
    rng = np.random.default_rng(5)
    emb = rng.integers(-127, 128, (300, 64)).astype(np.int8)
    x = rng.standard_normal((4, 64)).astype(np.float32)
    view = torch.from_numpy(emb).T
    assert view.stride() == (1, 64)
    got = qmm.int8_matmul(torch.from_numpy(x), view, 20.0)
    want = qmm.int8_matmul(torch.from_numpy(x), view.contiguous(), 20.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_quantize_rounds_half_to_even_and_saturates():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0])
    q = qmm.quantize_activations(x, 1.0)
    assert q.dtype == torch.int8
    assert q.tolist() == [0, 2, 2, 0, -2, 127, -127]

