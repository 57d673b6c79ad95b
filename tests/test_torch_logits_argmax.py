"""The port's projection argmax (slimt_tpu_torch/ops/logits_argmax.py)
against the JAX package on the CPU, in its three methods (exact,
packed_fp16, packed_bf16): against
slimt_tpu.ops.logits_argmax.argmax_affine in interpret mode and against
slimt_tpu.models.transformer.output_argmax, over the full vocabulary
(4736 columns: the JAX kernel's last 512-column tile is partial) and a
shortlist. Indices equal, ties across tiles and an all-negative partial
tile included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.ops import logits_argmax as jla  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import logits_argmax  # noqa: E402

CONFIG = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=4)
VOCAB, EMB = 4736, 32
SHORTLIST = np.arange(0, VOCAB, 5, dtype=np.int32)
METHODS = ("exact", "packed_fp16", "packed_bf16")


@pytest.fixture(scope="module")
def weights():
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=64, seed=3,
        )),
        CONFIG,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu")


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("method", METHODS)
def test_argmax_affine_matches_jax(weights, method, with_shortlist):
    jp, tp = weights
    rng = np.random.default_rng(len(method) + with_shortlist)
    y = (rng.standard_normal((9, EMB)) * 3).astype(np.float32)
    sl = SHORTLIST if with_shortlist else None
    w_j, b_j = jtfm.prepare_output_projection(jp, None if sl is None else jnp.asarray(sl))
    w, b = tfm.prepare_output_projection(tp, None if sl is None else torch.from_numpy(sl))
    aq, bq = jp["out"]["aq"], jp["emb"]["scale"]
    want_kernel = jla.argmax_affine(
        jnp.asarray(y), w_j, b_j, aq, bq, interpret=True, method=method)
    got = logits_argmax.argmax_affine(
        torch.from_numpy(y), w, b, tp["out"]["aq"], tfm.output_inv(tp), method)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_kernel))
    for provider in ("fused", "xla_int8"):
        want = jtfm.output_argmax(jp, jnp.asarray(y), provider, (w_j, b_j), method=method)
        np.testing.assert_array_equal(
            tfm.output_argmax(tp, torch.from_numpy(y), provider, (w, b), method).numpy(),
            np.asarray(want))


def test_fused_packed_int_takes_the_exact_argmax(weights):
    """As in the JAX package, "packed_int" under the "fused" provider is
    the exact argmax, and stays packed_int under the declared ones."""
    jp, tp = weights
    rng = np.random.default_rng(11)
    y = (rng.standard_normal((16, EMB)) * 3).astype(np.float32)
    projection = tfm.prepare_output_projection(tp)
    y_t = torch.from_numpy(y)
    fused = tfm.output_argmax(tp, y_t, "fused", projection, "packed_int")
    exact = logits_argmax.argmax_affine(
        y_t, *projection, tp["out"]["aq"], tfm.output_inv(tp), "exact")
    assert torch.equal(fused, exact)
    jproj = jtfm.prepare_output_projection(jp)
    for provider in ("fused", None):
        np.testing.assert_array_equal(
            tfm.output_argmax(tp, y_t, provider, projection, "packed_int").numpy(),
            np.asarray(jtfm.output_argmax(jp, jnp.asarray(y), provider, jproj,
                                          method="packed_int")))


@pytest.mark.parametrize("method", METHODS)
def test_tie_across_tiles_prefers_first(method):
    """Identical columns 3 and 700 (JAX tiles 0 and 1; port tiles 0 and
    2): the first wins in every method."""
    k, n = 128, 1024
    w = np.zeros((k, n), np.int8)
    w[:, 3] = 5
    w[:, 700] = 5
    x = np.ones((2, k), np.float32)
    bias = np.zeros(n, np.float32)
    want = jla.argmax_affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                             jnp.float32(4.0), jnp.float32(2.0), interpret=True,
                             method=method)
    inv = np.float32(1) / (np.float32(4.0) * np.float32(2.0))
    got = logits_argmax.argmax_affine(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(bias), 4.0, inv, method)
    assert got.tolist() == [3, 3] == np.asarray(want).tolist()


@pytest.mark.parametrize("method", METHODS)
def test_partial_tile_never_wins(method):
    """All logits negative and 640 columns (a partial last tile in both
    tilings): the index is the true maximum and stays < 640."""
    b, k, n = 4, 128, 640
    rng = np.random.default_rng(0)
    x = (np.abs(rng.standard_normal((b, k))) + 0.1).astype(np.float32)
    w = rng.integers(-127, -1, (k, n)).astype(np.int8)
    bias = np.full(n, -50.0, np.float32)
    want = jla.argmax_affine(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                             jnp.float32(10.0), jnp.float32(10.0), interpret=True,
                             method=method)
    inv = np.float32(1) / (np.float32(10.0) * np.float32(10.0))
    got = logits_argmax.argmax_affine(torch.from_numpy(x), torch.from_numpy(w),
                                      torch.from_numpy(bias), 10.0, inv, method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < n).all()


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_packed_argmax_16_matches_jax(dtype):
    """Keys over rounded values: near-ties that round together, signed
    zeros, negatives and values beyond the float16 range."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((6, 3000)) * 4).astype(np.float32)
    logits[0, 10] = logits[0, 2000] = 30.0
    logits[0, 5] = 30.0 + 1e-4  # rounds to 30 in both 16-bit types
    logits[1] = -np.abs(logits[1])
    logits[2, :] = 0.0
    logits[2, 7] = -0.0
    logits[3, 100] = 1e6
    logits[3, 50] = 2e6  # both +inf in float16: the first one wins there
    want = jtfm.packed_argmax_16(jnp.asarray(logits), getattr(jnp, dtype))
    got = logits_argmax.packed_argmax_16(torch.from_numpy(logits), getattr(torch, dtype))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            tfm.packed_argmax_bf16(torch.from_numpy(logits)).numpy(),
            np.asarray(jtfm.packed_argmax_bf16(jnp.asarray(logits))))


def test_kernel_wrapper_rejects():
    y = torch.zeros((2, 256))
    w = torch.zeros((256, 70000), dtype=torch.int8)
    b = torch.zeros(70000)
    with pytest.raises(ValueError, match="CUDA"):
        logits_argmax.argmax_affine_kernel(y, w, b, 1.0, 1.0)
    with pytest.raises(ValueError, match="method"):
        logits_argmax.argmax_affine_kernel(y, w, b, 1.0, 1.0, "packed_int8")
    with pytest.raises(ValueError, match="b_i32"):  # packed_int takes the bias in accumulator units
        logits_argmax.argmax_affine_kernel(y, w, b, 1.0, 1.0, "packed_int")
