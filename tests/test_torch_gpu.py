"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips where torch.cuda.is_available() is False; there
is no interpret mode for a CUDA kernel. This file imports no JAX, so it
runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402
from slimt_tpu_torch.ops import qmm  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "m,k,n", [(1, 256, 256), (37, 256, 300), (64, 1536, 256), (5, 100, 33)]
)
def test_affine_kernel_bit_equal_to_plain(card, m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(card)
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(card)
    aq, inv = np.float32(20.0), np.float32(1) / np.float32(20.0 * 90.0)
    for mode in (qmm.AFFINE, qmm.AFFINE_RELU, qmm.ACCUMULATOR):
        got = qmm.affine_kernel(x, w, b, aq, inv, mode)
        want = qmm.affine_plain(x, w, b, aq, inv, mode)
        assert torch.equal(got, want), mode


def test_affine_kernel_strided_projection(card):
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(rng.integers(-127, 128, (3000, 256)).astype(np.int8)).to(card)
    x = torch.from_numpy(rng.standard_normal((7, 256)).astype(np.float32)).to(card)
    ids = torch.from_numpy(np.sort(rng.choice(3000, 1024, replace=False))).to(card)
    for w in (emb.T, emb.index_select(0, ids).T):
        got = qmm.affine_kernel(x, w, None, 20.0, 1.0, qmm.ACCUMULATOR)
        assert torch.equal(got, qmm.affine_plain(x, w, None, 20.0, 1.0, qmm.ACCUMULATOR))


def test_affine_kernel_counts_and_rejects(card):
    x = torch.zeros((2, 8), device=card)
    w = torch.zeros((8, 4), dtype=torch.int8, device=card)
    before = qmm.affine_kernel.launches
    qmm.affine(x, w, None, 1.0, 1.0)
    assert qmm.affine_kernel.launches == before + 1
    with pytest.raises(ValueError, match="int8"):
        qmm.affine_kernel(x, w.float(), None, 1.0, 1.0)


@pytest.mark.parametrize("emb,ffn,t", [(256, 1536, 16), (256, 1536, 128), (512, 2048, 64)])
def test_encoder_layer_kernel_matches_plain(card, emb, ffn, t):
    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=t)),
        config,
    )
    layer = params_from_numpy(host, card)["encoder"][0]
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((2, t, emb)).astype(np.float32)).to(card)
    mask = torch.ones((2, t), device=card)
    mask[1, t // 2:] = 0
    mask_add = ((1.0 - mask) * -99999999.0)[:, None, None, :]
    before = enc.layer_kernel.launches
    got = enc.encoder_layer_fused(x, layer, mask_add, 8)
    assert enc.layer_kernel.launches == before + 1
    want = enc.layer_plain(x, layer, mask_add, 8)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5
