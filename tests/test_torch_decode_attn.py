"""The port's int16 decode attention (slimt_tpu_torch/ops/decode_attn.py)
against the JAX package on the CPU: against
slimt_tpu.ops.decode_attn_pallas.decode_attention_int16 in interpret
mode and against the XLA int16 branch of
slimt_tpu.models.transformer._decode_attention_joined, within 2e-5
(max |diff|; the three sum in different orders). Batches of 24 and 33
rows are not powers of two; fully masked (padding) rows stay finite.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.ops.decode_attn_pallas import decode_attention_int16 as jattn  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import decode_attn  # noqa: E402

TOL = 2e-5
EMB, HEADS = 64, 4


def _case(b, t, seed):
    """q, the int16 per-row cache quantized as precompute_cross_kv does,
    and an additive mask with ragged tails; the last row fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, EMB)).astype(np.float32)
    kf = rng.standard_normal((b, t, EMB)).astype(np.float32)
    vf = rng.standard_normal((b, t, EMB)).astype(np.float32)
    kq = np.float32(32767) / np.maximum(np.abs(kf).max(2), np.float32(1e-6))
    vq = np.float32(32767) / np.maximum(np.abs(vf).max(2), np.float32(1e-6))
    kv = {
        "k": np.rint(kf * kq[:, :, None]).astype(np.int16),
        "v": np.rint(vf * vq[:, :, None]).astype(np.int16),
        "kqi": (np.float32(1) / kq).astype(np.float32),
        "vqi": (np.float32(1) / vq).astype(np.float32),
    }
    lengths = rng.integers(1, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    mask[-1] = 0.0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0)).astype(np.float32)
    return q, kv, mask_add


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("b", [4, 24, 33])
def test_decode_attention_matches_jax(b, t):
    q, kv, mask = _case(b, t, seed=b * t)
    jkv = {k: jnp.asarray(v) for k, v in kv.items()}
    want_kernel = np.asarray(jattn(
        jnp.asarray(q), jkv["k"], jkv["v"], jkv["kqi"], jkv["vqi"],
        jnp.asarray(mask), HEADS, interpret=True))
    want_xla, _ = jtfm._decode_attention_joined(
        jnp.asarray(q)[:, None, :], jkv, jnp.asarray(mask)[:, None, None, :], HEADS)
    tkv = {k: torch.from_numpy(v) for k, v in kv.items()}
    got = decode_attn.decode_attention_int16(
        torch.from_numpy(q), tkv["k"], tkv["v"], tkv["kqi"], tkv["vqi"],
        torch.from_numpy(mask), HEADS).numpy()
    assert got.shape == (b, EMB)
    assert np.isfinite(got).all()
    assert float(np.abs(got - want_kernel).max()) <= TOL
    assert float(np.abs(got - np.asarray(want_xla)[:, 0, :]).max()) <= TOL


def test_attn_kernel_branch_of_decode_attention_joined():
    """transformer._decode_attention_joined(attn_kernel=True) returns the
    kernel's output (within 2e-5 of the formulation with weights) and
    zero weights of the usual shape."""
    b, t = 6, 16
    q, kv, mask = _case(b, t, seed=5)
    tkv = {k: torch.from_numpy(v) for k, v in kv.items()}
    yq = torch.from_numpy(q)[:, None, :]
    mask_add = torch.from_numpy(mask)[:, None, None, :]
    out, attn = tfm._decode_attention_joined(yq, tkv, mask_add, HEADS, attn_kernel=True)
    want, want_attn = tfm._decode_attention_joined(yq, tkv, mask_add, HEADS)
    assert tuple(attn.shape) == tuple(want_attn.shape) == (b, HEADS, 1, t)
    assert not attn.any()
    assert float((out - want).abs().max()) <= TOL


@pytest.mark.parametrize(
    "b,t,e,heads", [(2, 16, 64, 4), (2, 16, 512, 1), (2, 16, 256, 6), (2, 0, 256, 8)])
def test_check_shapes_rejects(b, t, e, heads):
    with pytest.raises(ValueError, match="decode attention"):
        decode_attn.check_shapes(b, t, e, heads)


def test_kernel_wrapper_rejects_cpu_tensors():
    b = 2
    with pytest.raises(ValueError, match="CUDA"):
        decode_attn.decode_attention_kernel(
            torch.zeros((b, 256)), torch.zeros((b, 16, 256), dtype=torch.int16),
            torch.zeros((b, 16, 256), dtype=torch.int16), torch.ones((b, 16)),
            torch.ones((b, 16)), torch.zeros((b, 16)), 8)
