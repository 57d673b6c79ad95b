"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Each test skips where torch.cuda.is_available() is False; there
is no interpret mode for a CUDA kernel. This file imports no JAX and
nothing of the JAX package, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch.config import ModelConfig  # noqa: E402
from slimt_tpu_torch.device import resolve_device  # noqa: E402
from slimt_tpu_torch.io import load_items  # noqa: E402
from slimt_tpu_torch.io.loader import load_weights  # noqa: E402
from slimt_tpu_torch.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import _build, attention, decode_attn  # noqa: E402
from slimt_tpu_torch.ops import decoder_step as dstep  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402
from slimt_tpu_torch.ops import fused_blocks, logits_argmax, qmm  # noqa: E402

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


STEP_VOCAB = 5000  # 40 projection tiles of 128 columns, the last one partial


def _step_case(card, b, t, with_shortlist, seed):
    """Tiny widths (E 256, F 1536, 2 decoder layers, 8 heads): params,
    inputs and projection on the card; one row padded, one fully
    masked."""
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=STEP_VOCAB, emb_dim=256, ffn_dim=1536,
        seed=seed)), config)
    params = params_from_numpy(host, card)
    rng = np.random.default_rng(seed)
    e = 256

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(card)

    x = tensor((rng.standard_normal((b, 1, e)) * 2).astype(np.float32))
    states = tuple(tensor(rng.standard_normal((b, 1, e)).astype(np.float32))
                   for _ in range(2))
    mask = np.ones((b, t), np.float32)
    if b > 1:
        mask[0, t // 2:] = 0.0
        mask[-1] = 0.0
    mask_add = tensor(((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :])
    caches = tuple(
        {"k": tensor(rng.integers(-32767, 32768, (b, t, e)).astype(np.int16)),
         "v": tensor(rng.integers(-32767, 32768, (b, t, e)).astype(np.int16)),
         "kqi": tensor((rng.uniform(0.5, 2, (b, t)) / 32767).astype(np.float32)),
         "vqi": tensor((rng.uniform(0.5, 2, (b, t)) / 32767).astype(np.float32))}
        for _ in range(2)
    )
    shortlist = None
    if with_shortlist:
        shortlist = tensor(np.sort(rng.choice(STEP_VOCAB, 1024, replace=False)))
    projection = tfm.prepare_output_projection(params, shortlist)
    args = (params["decoder"], states, x, mask_add, caches, 8, projection,
            params["out"]["aq"], tfm.output_inv(params))
    return params, args


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("b,t", [(1, 16), (1, 128), (33, 16), (33, 128)])
def test_whole_step_kernel_matches_plain(card, b, t, with_shortlist):
    params, args = _step_case(card, b, t, with_shortlist, seed=b + t)
    before = dstep.whole_step_kernel.launches
    choice, states, attn0 = dstep.whole_decode_step(*args)
    assert dstep.whole_step_kernel.launches == before + 1
    want_choice, want_states, want_attn0 = dstep.whole_step_plain(*args)
    torch.cuda.synchronize()
    for got, want in zip(states, want_states):
        assert float((got - want).abs().max()) <= 2e-5
    assert torch.isfinite(attn0).all()
    assert float((attn0 - want_attn0).abs().max()) <= 2e-5
    # A differing choice must be a near-tie of the plain logits: the
    # chosen column within 1e-3 of the maximum.
    differ = (choice != want_choice).nonzero().flatten()
    if len(differ):
        y = dstep.layers_plain(*args[:6])[0]
        logits = qmm.affine_plain(y, *args[6], args[7], args[8])[differ]
        picked = logits.gather(1, choice[differ].long()[:, None])[:, 0]
        gap = float((logits.amax(-1) - picked).max())
        assert gap <= 1e-3, f"rows {differ.tolist()} differ, logit gap {gap}"


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
def test_argmax_affine_kernel_bit_equal_with_tie(card, with_shortlist):
    rng = np.random.default_rng(7)
    emb = rng.integers(-127, 128, (STEP_VOCAB, 256)).astype(np.int8)
    emb[4000] = emb[300]  # a tie across projection tiles: 300 must win
    emb_t = torch.from_numpy(emb).to(card)
    bias = np.zeros(STEP_VOCAB, np.float32)
    if with_shortlist:
        ids = torch.from_numpy(np.arange(0, STEP_VOCAB, 3)).to(card)
        w, b = emb_t.index_select(0, ids).T, torch.from_numpy(bias[::3].copy()).to(card)
        first, second = 100, 1333  # rows 300 and 3999 of the embedding
        w[:, second] = w[:, first]
    else:
        w, b = emb_t.T, torch.from_numpy(bias).to(card)
        first, second = 300, 4000
    y = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32)).to(card)
    # Rows 0 and 1 point along the tied column: it is their maximum.
    y[:2] = w[:, first].float() / 40.0
    before = dstep.argmax_affine_kernel.launches
    got = dstep.argmax_affine_kernel(y, w, b, 20.0, 1e-3)
    assert dstep.argmax_affine_kernel.launches == before + 1
    want = dstep.argmax_affine_plain(y, w, b, 20.0, 1e-3)
    assert torch.equal(got, want)
    assert got[:2].tolist() == [first, first]


def _decoder_layer(card, emb, ffn, seed):
    config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=seed)), config)
    return params_from_numpy(host, card)["decoder"][0]


# The blocks' int8 products and epilogues are bit-exact; only LayerNorm
# and the sigmoid sum or round in another order.
@pytest.mark.parametrize("m", [1, 33, 130])
@pytest.mark.parametrize("emb,ffn", [(256, 1536), (512, 2048)])
def test_fused_blocks_match_plain(card, emb, ffn, m):
    layer = _decoder_layer(card, emb, ffn, seed=m)
    gen = torch.Generator(device=card)
    gen.manual_seed(m)
    x = torch.randn((m, 1, emb), device=card, generator=gen) * 2.0
    c = torch.randn((m, 1, emb), device=card, generator=gen)
    before = (fused_blocks.ssru_kernel.launches, fused_blocks.ffn_kernel.launches)
    h, c_t = fused_blocks.ssru_block(x, c, layer["rnn"])
    y = fused_blocks.ffn_block(x, layer["ffn"])
    assert (fused_blocks.ssru_kernel.launches, fused_blocks.ffn_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    want_h, want_c = fused_blocks.ssru_plain(x[:, 0], c[:, 0], layer["rnn"])
    want_y = fused_blocks.ffn_plain(x[:, 0], layer["ffn"])
    torch.cuda.synchronize()
    for got, want in ((h, want_h), (c_t, want_c), (y, want_y)):
        assert tuple(got.shape) == (m, 1, emb)
        assert float((got[:, 0] - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("b,t", [(1, 16), (24, 64), (33, 128)])
@pytest.mark.parametrize("emb", [256, 512])
def test_decode_attention_kernel_matches_plain(card, emb, b, t):
    gen = torch.Generator(device=card)
    gen.manual_seed(b + t)
    q = torch.randn((b, emb), device=card, generator=gen)
    k, v = (torch.randint(-32767, 32768, (b, t, emb), device=card,
                          dtype=torch.int16, generator=gen) for _ in range(2))
    kqi, vqi = ((torch.rand((b, t), device=card, generator=gen) + 0.5) / 32767.0
                for _ in range(2))
    mask = torch.zeros((b, t), device=card)
    mask[0, t // 2:] = -99999999.0
    mask[-1] = -99999999.0  # a padding row (the only row at b = 1)
    before = decode_attn.decode_attention_kernel.launches
    got = decode_attn.decode_attention_int16(q, k, v, kqi, vqi, mask, 8)
    assert decode_attn.decode_attention_kernel.launches == before + 1
    want = decode_attn.attention_plain(q, k, v, kqi, vqi, mask, 8)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("method", logits_argmax.METHODS)
@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
def test_argmax_kernel_methods_bit_equal_with_tie(card, method, with_shortlist):
    rng = np.random.default_rng(9)
    emb = rng.integers(-127, 128, (STEP_VOCAB, 256)).astype(np.int8)
    emb[4000] = emb[300]  # a tie across projection tiles: 300 must win
    emb_t = torch.from_numpy(emb).to(card)
    bias = torch.from_numpy((rng.standard_normal(STEP_VOCAB) * 0.1).astype(np.float32)).to(card)
    bias[4000] = bias[300]
    if with_shortlist:
        ids = torch.from_numpy(np.arange(0, STEP_VOCAB, 4)).to(card)  # holds 300 and 4000
        w, b = emb_t.index_select(0, ids).T, bias.index_select(0, ids)
        first = 75
    else:
        w, b = emb_t.T, bias
        first = 300
    y = torch.from_numpy(rng.standard_normal((70, 256)).astype(np.float32)).to(card)
    y[:2] = w[:, first].float() / 40.0
    before = logits_argmax.argmax_affine_kernel.launches
    got = logits_argmax.argmax_affine(y, w, b, 20.0, 1e-3, method)
    assert logits_argmax.argmax_affine_kernel.launches == before + 1
    want = logits_argmax.argmax_affine_plain(y, w, b, 20.0, 1e-3, method)
    assert torch.equal(got, want)
    assert got[:2].tolist() == [first, first]


@pytest.mark.parametrize("b", [1, 20, 64, 100])
@pytest.mark.parametrize("width", [1000, 3000])
def test_argmax_kernel_shortlist_off_the_tile_width(card, width, b):
    """Shortlists whose width is no multiple of the projection tiles (128
    columns): every method bit-equal to plain, the last tile's
    padding columns never winning, also where every logit is negative."""
    rng = np.random.default_rng(width + b)
    emb = torch.from_numpy(rng.integers(-127, 128, (8000, 256)).astype(np.int8)).to(card)
    bias = torch.from_numpy((rng.standard_normal(8000) - 4.0).astype(np.float32)).to(card)
    ids = torch.from_numpy(np.sort(rng.choice(8000, width, replace=False))).to(card)
    w, bb = emb.index_select(0, ids).T, bias.index_select(0, ids)
    y = torch.from_numpy(rng.standard_normal((b, 256)).astype(np.float32)).to(card)
    for method in logits_argmax.METHODS:
        got = logits_argmax.argmax_affine(y, w, bb, 20.0, 1e-4, method)
        want = logits_argmax.argmax_affine_plain(y, w, bb, 20.0, 1e-4, method)
        assert torch.equal(got, want), method
        assert int(got.max()) < width


def test_resolve_device_keeps_tf32_off(card):
    """The split encoder's plain SDPA multiplies in float32 with
    torch.matmul: TF32 would round its operands to 10 mantissa bits."""
    resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


PAD_TOL = 1e-4


def _padded_mask(card, b, t):
    """(additive [b, 1, 1, t] mask, rows with a real key): row 0 padded
    over its last third, row 1 a padding row where b > 2. A padding
    row's scores are -99999999 + s, rounded to the float32 grid of 8 at
    1e8, so its softmax is the rounding of s and differs between two
    sum orders (by up to 5.2e-5 seen at T=2048); nothing reads that row.
    It is held to PAD_TOL, the real rows to the kernel's tolerance."""
    mask = torch.ones((b, t), device=card)
    mask[0, t - t // 3:] = 0
    if b > 2:
        mask[1] = 0
    return ((1.0 - mask) * -99999999.0)[:, None, None, :], mask.any(-1)


@pytest.mark.parametrize("b,t,e", [(3, 16, 256), (33, 64, 256), (33, 256, 512)])
def test_fused_sdpa_kernel_matches_plain(card, b, t, e):
    gen = torch.Generator(device=card)
    gen.manual_seed(b + t + e)
    q, k, v = (torch.randn((b, t, e), device=card, generator=gen) for _ in range(3))
    mask_add, real = _padded_mask(card, b, t)
    before = attention.fused_sdpa_kernel.launches
    got = attention.fused_sdpa_joined(q, k, v, mask_add, 8)
    assert attention.fused_sdpa_kernel.launches == before + 1
    want = enc.sdpa_plain(q, k, v, mask_add, 8)
    torch.cuda.synchronize()
    assert float((got[real] - want[real]).abs().max()) <= 2e-5
    assert float((got - want).abs().max()) <= PAD_TOL  # also catches NaN


@pytest.mark.parametrize("b,t,d", [(2, 272, 32), (3, 1024, 32), (1, 130, 64), (2, 77, 16)])
def test_blockwise_kernel_matches_plain(card, b, t, d):
    """Ragged query tiles and padded rows: within 2e-5 abs + 1e-5 rel at
    every position of the real rows, PAD_TOL on the padding row."""
    gen = torch.Generator(device=card)
    gen.manual_seed(b * t + d)
    q, k, v = (torch.randn((b, 8, t, d), device=card, generator=gen) for _ in range(3))
    mask_add, real = _padded_mask(card, b, t)
    before = attention.blockwise_kernel.launches
    got = attention.blockwise_attention(q, k, v, mask_add)
    assert attention.blockwise_kernel.launches == before + 1
    want = attention.blockwise_plain(q, k, v, mask_add)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= PAD_TOL  # also catches NaN
    got, want = got[real], want[real]
    assert bool(((got - want).abs() <= 2e-5 + 1e-5 * want.abs()).all())


def test_whole_step_rows(card):
    """The C entry picks the layers kernel's rows a block from the card's
    shared memory: on one block (cs=1) 4 rows fit up to T=1560 at tiny
    widths, 1 row up to T=7008; past that the step raises. A block of a
    cluster holds the scores of its heads only: at cs=4 (2 heads a
    block) 4 rows fit at T=2048."""
    e, f, heads = 256, 1536, 8
    assert dstep.step_rows(130, e, f, heads, 1560) == 4
    assert dstep.step_rows(130, e, f, heads, 1561) == 1
    assert dstep.step_rows(8, e, f, heads, 1024) == 1
    assert dstep.step_rows(130, e, f, heads, 7008) == 1
    assert dstep.step_rows(130, e, f, heads, 2048, cs=4) == 4
    with pytest.raises(ValueError, match="shared memory"):
        dstep.step_rows(1, e, f, heads, 7009)


@pytest.mark.parametrize("b", [1, 8, 130])
def test_whole_step_kernel_long_t(card, b):
    """T=1024 and T=2048 (B=130 takes 4 rows a tile on a cluster of 4,
    whose blocks hold 2 heads' scores each): the kernel's own bound, not
    the encoder's. As in chip_smoke.py, every row within 0.25 on states
    and head-0 attention (an int8 rounding flip in layer 1 moves a row by
    up to ~0.06) and >= 99% of the rows with a real key within 2e-5."""
    for t in (1024, 2048):
        params, args = _step_case(card, b, t, False, seed=b + t)
        plan = dstep.StepPlan(args[0], args[4], args[3], 8, *args[6:])
        assert plan.rows == dstep.step_rows(b, 256, 1536, 8, t, plan.cs)
        assert plan.rows == (4 if b > 64 else 1)
        choice, states, attn0 = dstep.whole_decode_step(*args, plan=plan)
        want_choice, want_states, want_attn0 = dstep.whole_step_plain(*args)
        torch.cuda.synchronize()
        row_err = (attn0 - want_attn0).abs().amax(-1)
        for got, want in zip(states, want_states):
            row_err = torch.maximum(row_err, (got - want).abs().amax((1, 2)))
        assert float(row_err.max()) <= 0.25  # also catches NaN
        row_err = row_err[(args[3][:, 0, 0, :] == 0).any(-1)]
        assert float((row_err <= 2e-5).float().mean()) >= 0.99


FLOAT_CACHES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "float16": torch.float16}


def _row_rule(label, row_err, attn_err, real):
    """The rule of the whole step's check (chip_smoke.py): every row within
    0.25 on states and head-0 attention (an int8 rounding flip moves a row
    by up to ~0.06), and >= 99% of the rows within 2e-5 on the states and,
    on a row with a real key, 1e-6 on the attention (PAD_TOL on a padding
    row)."""
    worst = float(torch.maximum(row_err, attn_err).max())
    assert worst <= 0.25, f"{label}: max |diff| {worst}"  # also catches NaN
    within = (row_err <= 2e-5) & torch.where(real, attn_err <= 1e-6, attn_err <= PAD_TOL)
    assert float(within.float().mean()) >= 0.99, f"{label}: {within.tolist()}"


@pytest.mark.parametrize("b,t", [(1, 16), (8, 64), (65, 64), (130, 1024)])
@pytest.mark.parametrize("dtype", list(FLOAT_CACHES))
@pytest.mark.parametrize("split", [True, False], ids=["split", "joined"])
def test_layer_step_kernels_match_plain(card, split, dtype, b, t):
    """#10 (split [B, H, T, D] cache) and #11 (joined [B, T, E]) against
    their plain versions; B=130 takes 4 rows a block, at T=1024 too."""
    layer = _decoder_layer(card, 256, 1536, seed=b + t)
    gen = torch.Generator(device=card)
    gen.manual_seed(b * t)
    x = torch.randn((b, 1, 256), device=card, generator=gen) * 2.0
    c = torch.randn((b, 1, 256), device=card, generator=gen)
    shape = (b, 8, t, 32) if split else (b, t, 256)
    kv = tuple((torch.randn(shape, device=card, generator=gen) * 0.5).to(FLOAT_CACHES[dtype])
               for _ in range(2))
    mask_add, real = _padded_mask(card, b, t)
    if split:
        kernel, entry, plain = (dstep.decoder_layer_step_kernel, dstep.decoder_layer_step,
                                dstep.decoder_layer_step_plain)
    else:
        kernel, entry, plain = (dstep.decoder_layer_step_bte_kernel,
                                dstep.decoder_layer_step_bte,
                                dstep.decoder_layer_step_bte_plain)
    before = kernel.launches
    y, c_t, attn0 = entry(layer, c, x, mask_add, kv, 8)
    assert kernel.launches == before + 1
    want_y, want_c, want_attn0 = plain(layer, c, x, mask_add, kv, 8)
    torch.cuda.synchronize()
    row_err = torch.maximum((y - want_y).abs().amax((1, 2)), (c_t - want_c).abs().amax((1, 2)))
    _row_rule(f"{'split' if split else 'joined'} {dtype} B={b} T={t}", row_err,
              (attn0 - want_attn0).abs().amax(-1), real)


@pytest.mark.parametrize("b,t", [(1, 64), (33, 128), (130, 1024)])
@pytest.mark.parametrize("dtype", list(FLOAT_CACHES))
def test_whole_step_float_cache_kernel_matches_plain(card, dtype, b, t):
    """The whole step's float-cache branch (q and p rounded through the
    cache's type, no kqi/vqi) against its plain version."""
    params, args = _step_case(card, b, t, False, seed=3 * b + t)
    gen = torch.Generator(device=card)
    gen.manual_seed(b + t)
    caches = tuple(
        {"k": (torch.randn((b, t, 256), device=card, generator=gen) * 0.5).to(FLOAT_CACHES[dtype]),
         "v": (torch.randn((b, t, 256), device=card, generator=gen) * 0.5).to(FLOAT_CACHES[dtype]),
         "kqi": torch.ones((), device=card), "vqi": torch.ones((), device=card)}
        for _ in range(2))
    args = args[:4] + (caches,) + args[5:]
    before = dstep.whole_step_kernel.launches
    choice, states, attn0 = dstep.whole_decode_step(*args)
    assert dstep.whole_step_kernel.launches == before + 1
    want_choice, want_states, want_attn0 = dstep.whole_step_plain(*args)
    torch.cuda.synchronize()
    row_err = torch.zeros((b,), device=card)
    for got, want in zip(states, want_states):
        row_err = torch.maximum(row_err, (got - want).abs().amax((1, 2)))
    real = (args[3][:, 0, 0, :] == 0).any(-1)
    _row_rule(f"whole step {dtype} B={b} T={t}", row_err,
              (attn0 - want_attn0).abs().amax(-1), real)
    assert float((choice == want_choice).float().mean()) >= 0.99


# The affine's tilings (csrc/qmm_affine.cu): split K at M <= 64, 64 x 64
# and 128 x 128 tensor-core tiles above, ragged M, N and K, and the
# gathered layouts (K, N not multiples of 16).
AFFINE_EDGE_M = (1, 15, 16, 17, 63, 64, 65, 129, 4096)
AFFINE_EDGE_KN = ((256, 256), (256, 1536), (1536, 256), (100, 72), (1000, 40))


@pytest.mark.parametrize("k,n", AFFINE_EDGE_KN)
@pytest.mark.parametrize("m", AFFINE_EDGE_M)
def test_affine_kernel_tilings_bit_equal(card, m, k, n):
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    x = torch.from_numpy((rng.standard_normal((m, k)) * 2).astype(np.float32)).to(card)
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8)).to(card)
    b = torch.from_numpy((rng.standard_normal(n) * 0.05).astype(np.float32)).to(card)
    aq, inv = np.float32(20.0), np.float32(1) / np.float32(20.0 * 93.0)
    for mode in (qmm.AFFINE, qmm.AFFINE_RELU, qmm.ACCUMULATOR):
        got = qmm.affine_kernel(x, w, b, aq, inv, mode)
        assert torch.equal(got, qmm.affine_plain(x, w, b, aq, inv, mode)), mode


@pytest.mark.parametrize("m", [1, 64, 512])
def test_affine_kernel_projection_tilings_bit_equal(card, m):
    """The tied projection at V=32000: W is the [V, E] embedding's
    transpose (K-contiguous), read without a copy."""
    rng = np.random.default_rng(m)
    emb = torch.from_numpy(rng.integers(-127, 128, (32000, 256)).astype(np.int8)).to(card)
    x = torch.from_numpy((rng.standard_normal((m, 256)) * 2).astype(np.float32)).to(card)
    got = qmm.affine_kernel(x, emb.T, None, 20.0, 1.0, qmm.ACCUMULATOR)
    assert torch.equal(got, qmm.affine_plain(x, emb.T, None, 20.0, 1.0, qmm.ACCUMULATOR))


@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [1, 17, 64, 100, 256])
def test_fused_sdpa_kernel_edges(card, t, d, b):
    """Ragged key tiles and query blocks, both head dims, a padding row
    at B=33: within 2e-5 on the real rows, PAD_TOL on all."""
    gen = torch.Generator(device=card)
    gen.manual_seed(t * 100 + d + b)
    e = 8 * d
    q, k, v = (torch.randn((b, t, e), device=card, generator=gen) for _ in range(3))
    mask_add, real = _padded_mask(card, b, t)
    got = attention.fused_sdpa_kernel(q, k, v, mask_add, 8)
    want = enc.sdpa_plain(q, k, v, mask_add, 8)
    torch.cuda.synchronize()
    assert float((got[real] - want[real]).abs().max()) <= 2e-5
    assert float((got - want).abs().max()) <= PAD_TOL  # also catches NaN


def test_forward_async_returns_before_the_batch_completes(card, monkeypatch):
    """At B=512 T=64 forward_async returns before the event the dispatch
    worker sets once the batch's decode has completed on the card, and
    the tokens equal a blocking forward's."""
    import threading

    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.models import model as model_module
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=8)
    spm = build_spm_model(DEFAULT_WORDS, target_size=512)
    model = Model(config, Package(
        synthetic_model_bytes(config=config, vocab_size=len(spm.pieces), emb_dim=256,
                              ffn_dim=1536, seed=0),
        spm_proto.serialize_model(spm)))
    segments = [[3 + (i + j) % 400 for j in range(63)] + [model.vocabulary.eos_id]
                for i in range(512)]
    want = [h.target for h in model.forward(segments, need_alignment=False)]
    done = threading.Event()
    real = model_module.translate_batch

    def marking(*args, **kwargs):
        result = real(*args, **kwargs)
        torch.cuda.current_stream().synchronize()
        done.set()
        return result

    monkeypatch.setattr(model_module, "translate_batch", marking)
    finish = model.forward_async(segments, need_alignment=False)
    assert not done.is_set()
    assert [h.target for h in finish()] == want
    assert done.is_set()


# The cluster layout of the layers kernel (#7, #10, #11) and the FFN block
# (#5): every cluster size the chooser can return, each against the plain
# version by the smoke's rules and bit for bit against one block (cs=1).
CLUSTERS = fused_blocks.CLUSTER_SIZES
STEP_CACHES = ("int16",) + tuple(FLOAT_CACHES)


def _cluster_step_case(card, emb, ffn, b, t, cache, seed):
    """Whole-step arguments at the given widths over an int16 or float
    joined cache; one row padded, one fully masked (b > 1)."""
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=STEP_VOCAB, emb_dim=emb, ffn_dim=ffn, seed=seed)), config)
    params = params_from_numpy(host, card)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    x = torch.randn((b, 1, emb), device=card, generator=gen) * 2.0
    states = tuple(torch.randn((b, 1, emb), device=card, generator=gen) for _ in range(2))
    mask_add, _ = _padded_mask(card, b, t)
    if cache == "int16":
        caches = tuple(
            {"k": torch.randint(-32767, 32768, (b, t, emb), device=card, dtype=torch.int16,
                                generator=gen),
             "v": torch.randint(-32767, 32768, (b, t, emb), device=card, dtype=torch.int16,
                                generator=gen),
             "kqi": (torch.rand((b, t), device=card, generator=gen) * 1.5 + 0.5) / 32767,
             "vqi": (torch.rand((b, t), device=card, generator=gen) * 1.5 + 0.5) / 32767}
            for _ in range(2))
    else:
        one = torch.ones((), device=card)
        caches = tuple(
            {"k": (torch.randn((b, t, emb), device=card, generator=gen) * 0.5).to(
                FLOAT_CACHES[cache]),
             "v": (torch.randn((b, t, emb), device=card, generator=gen) * 0.5).to(
                FLOAT_CACHES[cache]),
             "kqi": one, "vqi": one}
            for _ in range(2))
    projection = tfm.prepare_output_projection(params, None)
    return (params["decoder"], states, x, mask_add, caches, 8, projection,
            params["out"]["aq"], tfm.output_inv(params))


@pytest.mark.parametrize("emb,ffn", [(256, 1536), (512, 2048)], ids=["tiny", "base"])
def test_whole_step_every_cluster_size(card, emb, ffn):
    """The whole step on clusters of 1-16 blocks at B 1, 2, 8, 33, 64 and
    130 over the int16 and the three float caches at T 16, 64 and 1024:
    every output of a cluster bit-equal to one block's, the choices equal
    to the plain projection of the kernel's own rows, and one block
    against the plain layers by the smoke's rules over the test's cases,
    as chip_smoke.py counts them (every row within 0.25 on the
    projection's input rows, the states and attn0; >= 99% of the rows
    within 2e-5, and on a float cache attn0 of a real row within 1e-6,
    PAD_TOL on a padding row)."""
    rows = within = 0
    for b, t, cache in itertools.product((1, 2, 8, 33, 64, 130), (16, 64, 1024), STEP_CACHES):
        args = _cluster_step_case(card, emb, ffn, b, t, cache, seed=b + t + emb)
        want_y, want_states, want_attn0 = dstep.layers_plain(*args[:6])
        real = (args[3][:, 0, 0, :] == 0).any(-1)
        first = None
        for cs in CLUSTERS:
            plan = dstep.StepPlan(args[0], args[4], args[3], 8, *args[6:], _cluster=cs)
            assert plan.cs == cs
            choice, states, attn0 = dstep.whole_decode_step(*args, plan=plan)
            y = plan.scratch[:b * emb].view(b, emb).clone()
            torch.cuda.synchronize()
            label = f"{cache} B={b} T={t} cs={cs}"
            projected = dstep.argmax_affine_plain(y, *args[6], args[7], args[8])
            assert torch.equal(choice, projected), label
            if first is not None:
                assert torch.equal(y, first[0]) and torch.equal(choice, first[1]), label
                assert all(torch.equal(a, c) for a, c in zip(states, first[2])), label
                assert torch.equal(attn0, first[3]), label
                continue
            first = (y, choice, states, attn0)
            state_err = (y - want_y).abs().amax(-1)
            for got, want in zip(states, want_states):
                state_err = torch.maximum(state_err, (got - want).abs().amax((1, 2)))
            attn_err = (attn0 - want_attn0).abs().amax(-1)
            worst = float(torch.maximum(state_err, attn_err).max())
            assert worst <= 0.25, f"{label}: max |diff| {worst}"  # also catches NaN
            # check_step's rule on the int16 cache, RowShare's on a float one.
            real_tol, pad_tol = (2e-5, 2e-5) if cache == "int16" else (1e-6, PAD_TOL)
            ok = (state_err <= 2e-5) & torch.where(real, attn_err <= real_tol,
                                                   attn_err <= pad_tol)
            rows += b
            within += int(ok.sum())
    assert within / rows >= 0.99, f"{within}/{rows} rows within the tolerance"


@pytest.mark.parametrize("m", [1, 8, 33, 130])
@pytest.mark.parametrize("emb,ffn", [(256, 1536), (512, 2048)], ids=["tiny", "base"])
def test_ffn_block_every_cluster_size(card, emb, ffn, m):
    """The FFN block on clusters of 1-16 blocks: against ffn_plain within
    2e-5 on every row, and each cluster's output bit-equal to one
    block's."""
    layer = _decoder_layer(card, emb, ffn, seed=m + 7)
    gen = torch.Generator(device=card)
    gen.manual_seed(m)
    x = torch.randn((m, emb), device=card, generator=gen) * 2.0
    want = fused_blocks.ffn_plain(x, layer["ffn"])
    first = None
    for cs in CLUSTERS:
        before = fused_blocks.ffn_kernel.launches
        got = fused_blocks.ffn_kernel(x, layer["ffn"], _cluster=cs)
        assert fused_blocks.ffn_kernel.launches == before + 1
        torch.cuda.synchronize()
        if first is None:
            first = got
            assert float((got - want).abs().max()) <= 2e-5
        else:
            assert torch.equal(got, first), cs


@pytest.mark.parametrize("m", [1, 8, 65, 130])
@pytest.mark.parametrize("emb,ffn", [(256, 1536), (512, 2048)], ids=["tiny", "base"])
def test_ssru_block_every_cluster_size(card, emb, ffn, m):
    """The SSRU block on clusters of 1-16 blocks: against ssru_plain within
    2e-5 on every row, and each cluster's h and c' bit-equal to one
    block's."""
    layer = _decoder_layer(card, emb, ffn, seed=m + 11)
    gen = torch.Generator(device=card)
    gen.manual_seed(m + 1)
    x = torch.randn((m, emb), device=card, generator=gen) * 2.0
    c = torch.randn((m, emb), device=card, generator=gen)
    want_h, want_c = fused_blocks.ssru_plain(x, c, layer["rnn"])
    first = None
    for cs in CLUSTERS:
        before = fused_blocks.ssru_kernel.launches
        got = fused_blocks.ssru_kernel(x, c, layer["rnn"], _cluster=cs)
        assert fused_blocks.ssru_kernel.launches == before + 1
        torch.cuda.synchronize()
        if first is None:
            first = got
            for out, want in zip(got, (want_h, want_c)):
                assert float((out - want).abs().max()) <= 2e-5
        else:
            assert all(torch.equal(a, b) for a, b in zip(got, first)), cs


@pytest.mark.parametrize("b,t", [(1, 64), (8, 16), (130, 1024)])
@pytest.mark.parametrize("dtype", list(FLOAT_CACHES))
@pytest.mark.parametrize("split", [True, False], ids=["split", "joined"])
def test_layer_steps_every_cluster_size(card, split, dtype, b, t):
    """#10 and #11 through the cluster layers kernel: one block against
    the plain version, every cluster bit-equal to it."""
    layer = _decoder_layer(card, 256, 1536, seed=b + 2 * t)
    gen = torch.Generator(device=card)
    gen.manual_seed(b + t)
    x = torch.randn((b, 1, 256), device=card, generator=gen) * 2.0
    c = torch.randn((b, 1, 256), device=card, generator=gen)
    shape = (b, 8, t, 32) if split else (b, t, 256)
    kv = tuple((torch.randn(shape, device=card, generator=gen) * 0.5).to(FLOAT_CACHES[dtype])
               for _ in range(2))
    mask_add, real = _padded_mask(card, b, t)
    kernel, plain = ((dstep.decoder_layer_step_kernel, dstep.decoder_layer_step_plain) if split
                     else (dstep.decoder_layer_step_bte_kernel,
                           dstep.decoder_layer_step_bte_plain))
    first = None
    for cs in CLUSTERS:
        out = kernel(layer, c, x, mask_add, kv, 8, _cluster=cs)
        torch.cuda.synchronize()
        if first is None:
            first = out
            want_y, want_c, want_attn0 = plain(layer, c, x, mask_add, kv, 8)
            row_err = torch.maximum((out[0] - want_y).abs().amax((1, 2)),
                                    (out[1] - want_c).abs().amax((1, 2)))
            _row_rule(f"{'split' if split else 'joined'} {dtype} B={b} T={t}", row_err,
                      (out[2] - want_attn0).abs().amax(-1), real)
        else:
            assert all(torch.equal(a, w) for a, w in zip(out, first)), cs


@pytest.mark.parametrize("b", [1, 8, 64, 130, 512])
def test_step_layout_holds_every_cluster_at_once(card, b):
    """The chooser's size, halved only where the card cannot hold one
    cluster a row tile at once."""
    lib = _build.library()
    want_cs, rows = fused_blocks.cluster_layout(b, 256, 1536)
    cs, got_rows = dstep.step_layout(b, 256, 1536, 8, 64, 0, torch.cuda.current_device())
    assert cs <= want_cs and got_rows == rows
    tiles = -(-b // rows)
    assert cs == 1 or lib.slimt_step_clusters(rows, cs, 256, 1536, 8, 64, 0) >= tiles
    if cs < want_cs:
        assert lib.slimt_step_clusters(rows, 2 * cs, 256, 1536, 8, 64, 0) < tiles


@pytest.mark.parametrize("b", [1, 8, 64, 130, 512])
def test_ssru_layout_holds_every_cluster_at_once(card, b):
    """The SSRU block's size: the chooser's, halved only where the card
    cannot hold one cluster a row tile at once."""
    lib = _build.library()
    want_cs, rows = fused_blocks.cluster_layout(b, 256, 256)
    cs, got_rows = fused_blocks.ssru_layout(b, 256, torch.cuda.current_device())
    assert cs <= want_cs and got_rows == rows
    tiles = -(-b // rows)
    assert cs == 1 or lib.slimt_ssru_clusters(rows, cs, 256) >= tiles
    if cs < want_cs:
        assert lib.slimt_ssru_clusters(rows, 2 * cs, 256) < tiles


@pytest.mark.parametrize("b,s", [(1, 32000), (20, 1000), (64, 3072), (512, 32000)])
def test_argmax_scratch_holds_a_key_per_narrowest_tile(card, b, s):
    """The scratch the C entry asks for: a 64-bit key per row and 128-column
    tile, the most tiles any launch writes."""
    assert logits_argmax.argmax_scratch(b, s) == 2 * b * -(-s // 128)


def test_refused_cluster_launch_raises(card, monkeypatch):
    """A cluster the C entries refuse (here 3 blocks) raises from the
    wrapper: nothing carries on with another layout or the plain path."""
    layer = _decoder_layer(card, 256, 1536, seed=3)
    x = torch.randn((1, 256), device=card)
    lib = _build.library()
    assert lib.slimt_ffn_clusters(1, 3, 256, 1536) == 0
    assert lib.slimt_step_clusters(1, 32, 256, 1536, 8, 64, 0) == 0
    monkeypatch.setattr(fused_blocks, "ffn_layout", lambda *args: (3, 1))
    before = fused_blocks.ffn_kernel.launches
    with pytest.raises(RuntimeError, match="slimt_ffn_block"):
        fused_blocks.ffn_kernel(x, layer["ffn"])
    assert fused_blocks.ffn_kernel.launches == before


def test_refused_ssru_cluster_launch_raises(card, monkeypatch):
    """A cluster the SSRU entry refuses raises from the wrapper, with no
    launch counted."""
    layer = _decoder_layer(card, 256, 1536, seed=4)
    x = torch.randn((1, 256), device=card)
    lib = _build.library()
    assert lib.slimt_ssru_clusters(1, 3, 256) == 0
    assert lib.slimt_ssru_clusters(1, 16, 256) >= 1
    monkeypatch.setattr(fused_blocks, "ssru_layout", lambda *args: (3, 1))
    before = fused_blocks.ssru_kernel.launches
    with pytest.raises(RuntimeError, match="slimt_ssru_block"):
        fused_blocks.ssru_kernel(x, torch.zeros_like(x), layer["rnn"])
    assert fused_blocks.ssru_kernel.launches == before


def _encoder_case(card, emb, ffn, b, t, seed):
    """An encoder layer of random int8 weights and inputs on the card: row
    1 padded from T/2 and (B > 2) the last row fully masked."""
    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=seed)), config)
    layer = params_from_numpy(host, card)["encoder"][0]
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, t, emb)).astype(np.float32)).to(card)
    mask = torch.ones((b, t), device=card)
    if b > 1:
        mask[1, t // 2:] = 0
    if b > 2:
        mask[-1] = 0
    return layer, x, ((1.0 - mask) * -99999999.0)[:, None, None, :]


def _close_positions(got, want, tol=2e-5, bound=0.25):
    """>= 99% of positions within tol, every one within bound (an int8
    rounding flip moves a position by up to ~0.06)."""
    err = (got - want).abs().amax(-1).flatten()
    assert torch.isfinite(got).all()
    assert float((err <= tol).float().mean()) >= 0.99, float(err.max())
    assert float(err.max()) <= bound


@pytest.mark.parametrize("emb,ffn,b,t", [
    (256, 1536, 64, 64), (256, 1536, 3, 17), (512, 2048, 3, 17), (512, 2048, 64, 64),
    (256, 1536, 2, 256), (512, 2048, 1, 100), (128, 512, 64, 64), (128, 512, 3, 17),
    (256, 1000, 16, 64)])
def test_encoder_layer_kernel_tiles_match_plain(card, emb, ffn, b, t):
    """Every tiling of the three launches (64-, 32- and 16-row QKV tiles,
    ragged last tiles, clusters of 1-16, E=128 and a ragged last hidden
    chunk) against plain; one launch counted a call."""
    layer, x, mask_add = _encoder_case(card, emb, ffn, b, t, seed=b + t)
    before = enc.layer_kernel.launches
    got = enc.encoder_layer_fused(x, layer, mask_add, 8)
    assert enc.layer_kernel.launches == before + 1
    want = enc.layer_plain(x, layer, mask_add, 8)
    torch.cuda.synchronize()
    _close_positions(got, want)
    if b * t <= 300:
        assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("emb,ffn,b,t", [(256, 1536, 3, 17), (512, 2048, 2, 64),
                                         (256, 1536, 16, 64), (128, 512, 64, 64),
                                         (128, 512, 3, 17)])
def test_encoder_layer_every_cluster_size(card, emb, ffn, b, t):
    """The post-attention kernel on every cluster size the card schedules,
    bit-equal to one block a tile: its FFN2 partials are int32 sums."""
    layer, x, mask_add = _encoder_case(card, emb, ffn, b, t, seed=7)
    one = enc.layer_kernel(x, layer, mask_add, 8, _cluster=1)
    sizes = 0
    for cs in fused_blocks.CLUSTER_SIZES[1:]:
        try:
            got = enc.layer_kernel(x, layer, mask_add, 8, _cluster=cs)
        except RuntimeError as exc:
            assert "cannot schedule" in str(exc)
            continue
        sizes += 1
        assert torch.equal(got, one), cs
    assert sizes >= 3


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_encoder_layer_narrow_width_clusters_match_plain(card, cs):
    """E=128, where the two hidden chunks take more of a row than q8(att):
    each forced cluster size against plain at B=64 T=64."""
    layer, x, mask_add = _encoder_case(card, 128, 512, 64, 64, seed=cs)
    got = enc.layer_kernel(x, layer, mask_add, 8, _cluster=cs)
    want = enc.layer_plain(x, layer, mask_add, 8)
    torch.cuda.synchronize()
    _close_positions(got, want)


def test_encoder_layer_kernel_launches_three_kernels(card):
    """One layer is three device kernels (QKV, SDPA, post-attention) under
    torch.profiler, at most four."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    layer, x, mask_add = _encoder_case(card, 256, 1536, 64, 64, seed=5)
    enc.layer_kernel(x, layer, mask_add, 8)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        enc.layer_kernel(x, layer, mask_add, 8)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(kernels) == 3, kernels


@pytest.mark.parametrize("b", [1, 64, 512])
def test_layer_plan_holds_every_cluster_at_once(card, b):
    """The post-attention kernel's size: the largest splitting F, halved
    only where the card cannot hold one cluster a tile at once."""
    lib = _build.library()
    dev = torch.cuda.current_device()
    plan = enc.layer_plan(b, 64, 256, 1536, 8,
                          lambda rows, cs, e: lib.slimt_encoder_clusters(rows, cs, e),
                          enc.sm_count(dev))
    assert plan.cs == 1 or lib.slimt_encoder_clusters(plan.post_rows, plan.cs, 256) >= plan.tiles
    if plan.cs < 16:
        assert lib.slimt_encoder_clusters(plan.post_rows, 2 * plan.cs, 256) < plan.tiles
    assert lib.slimt_encoder_clusters(64, 1, 256) >= 1
    assert lib.slimt_encoder_clusters(64, 1, 512) == 0  # 64 rows of 512 do not fit


@pytest.mark.parametrize("e", [256, 512])
@pytest.mark.parametrize("t", [1, 16, 64, 256, 1024])
@pytest.mark.parametrize("b", [1, 3, 64, 130, 512])
def test_decode_attention_kernel_shapes(card, b, t, e):
    """#3 against plain at every batch, length and width of the records,
    row 0 padded from T/2 and (B > 1) the last row fully masked."""
    gen = torch.Generator(device=card)
    gen.manual_seed(b * t + e)
    q = torch.randn((b, e), device=card, generator=gen)
    k, v = (torch.randint(-32767, 32768, (b, t, e), device=card,
                          dtype=torch.int16, generator=gen) for _ in range(2))
    kqi, vqi = ((torch.rand((b, t), device=card, generator=gen) * 1.5 + 0.5) / 32767.0
                for _ in range(2))
    mask = torch.zeros((b, t), device=card)
    mask[0, t // 2:] = -99999999.0
    if b > 1:
        mask[-1] = -99999999.0
    got = decode_attn.decode_attention_int16(q, k, v, kqi, vqi, mask, 8)
    want = decode_attn.attention_plain(q, k, v, kqi, vqi, mask, 8)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("b", [5, 2048], ids=["block", "warp"])
@pytest.mark.parametrize("heads", [1, 2, 32])
def test_decode_attention_kernel_head_dims(card, heads, b):
    """Head dims 256, 128 and 8 at E=256 (lanes of a position 32, 16, 1),
    on a block a (row, head) and, from 1600 of them at T <= 128, a warp."""
    gen = torch.Generator(device=card)
    gen.manual_seed(heads)
    t, e = 70, 256
    q = torch.randn((b, e), device=card, generator=gen)
    k, v = (torch.randint(-32767, 32768, (b, t, e), device=card,
                          dtype=torch.int16, generator=gen) for _ in range(2))
    kqi, vqi = ((torch.rand((b, t), device=card, generator=gen) + 0.5) / 32767.0
                for _ in range(2))
    mask = torch.zeros((b, t), device=card)
    mask[2, 40:] = -99999999.0
    got = decode_attn.decode_attention_int16(q, k, v, kqi, vqi, mask, heads)
    want = decode_attn.attention_plain(q, k, v, kqi, vqi, mask, heads)[0]
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 2e-5


@pytest.mark.parametrize("kernel", ["block", "warp"])
@pytest.mark.parametrize("b,t", [(3, 1), (3, 1024), (130, 64)])
def test_decode_attention_forced_kernels_match_plain(card, kernel, b, t):
    """Each of #3's two kernels, forced, against plain off the shapes the
    wrapper would give it: padded and fully masked rows, one launch
    counted a call."""
    gen = torch.Generator(device=card)
    gen.manual_seed(b + t)
    e = 256
    q = torch.randn((b, e), device=card, generator=gen)
    k, v = (torch.randint(-32767, 32768, (b, t, e), device=card,
                          dtype=torch.int16, generator=gen) for _ in range(2))
    kqi, vqi = ((torch.rand((b, t), device=card, generator=gen) + 0.5) / 32767.0
                for _ in range(2))
    mask = torch.zeros((b, t), device=card)
    mask[0, t // 2 + 1:] = -99999999.0
    mask[-1] = -99999999.0
    before = decode_attn.decode_attention_kernel.launches
    got = decode_attn.decode_attention_kernel(q, k, v, kqi, vqi, mask, 8, _kernel=kernel)
    assert decode_attn.decode_attention_kernel.launches == before + 1
    want = decode_attn.attention_plain(q, k, v, kqi, vqi, mask, 8)[0]
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-5


# The decode loop as CUDA graphs (models/decode.py, models/loop_graph.py)
# and continuous batching on them (models/continuous.py).
LOOP_VOCAB = 700


def _loop_params(card, seed=3, dec_layers=2, dequantize=False):
    config = ModelConfig(encoder_layers=1, decoder_layers=dec_layers, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=LOOP_VOCAB, emb_dim=256, ffn_dim=1536, seed=seed)), config)
    return params_from_numpy(host, card, dequantize=dequantize)


def _loop_batch(card, b=5, t=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, LOOP_VOCAB, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.float32)
    mask[1, t // 2:] = 0
    mask[-1] = 0  # a padding row
    ids[mask == 0] = 0
    return torch.from_numpy(ids).to(card), torch.from_numpy(mask).to(card)


def _decode(params, ids, mask, **kwargs):
    from slimt_tpu_torch.models import decode

    args = dict(eos_id=2, max_steps=21, num_heads=8, steps_cap=17)
    args.update(kwargs)
    return decode.translate_batch(params, ids, mask, **args)


def _same(a, b):
    return (torch.equal(a.tokens, b.tokens) and torch.equal(a.valid, b.valid)
            and torch.equal(a.alignment, b.alignment))


# (provider, kv_dtype, with_alignment, attn_kernel) over the serving paths.
LOOP_CASES = [
    (None, "int16", True, False), (None, "float32", False, False),
    (None, "bfloat16", False, False), ("fused", "int16", False, True),
    ("fused", "float32", True, False), ("fused_step", "int16", True, False),
    ("fused_step", "float32", False, False), ("fused_step", "bfloat16", False, False),
]


@pytest.mark.parametrize("provider,kv,aligned,attn", LOOP_CASES)
def test_graph_loop_bit_equal_to_eager_loop(card, provider, kv, aligned, attn):
    """The graph loop's tokens, valid masks and alignments equal the eager
    loop's on the card, for k in {1, 3, 8} (max_steps 21, cap 17), with a
    shortlist on the declared path."""
    from slimt_tpu_torch.models.loop_graph import GraphCache

    params = _loop_params(card)
    ids, mask = _loop_batch(card)
    shortlist = None
    if provider is None and kv == "int16":
        shortlist = torch.arange(0, LOOP_VOCAB, 3, dtype=torch.int32, device=card)
    kwargs = dict(provider=provider, kv_dtype=kv, with_alignment=aligned,
                  attn_kernel=attn, shortlist=shortlist,
                  argmax_method="packed_int" if provider is None else "exact")
    graphs = GraphCache()
    eager = _decode(params, ids, mask, loop_unroll=1, _eager=True, **kwargs)
    for k in (1, 3, 8):
        got = _decode(params, ids, mask, loop_unroll=k, graphs=graphs, **kwargs)
        again = _decode(params, ids, mask, loop_unroll=k, graphs=graphs, **kwargs)
        assert _same(got, eager), k
        assert _same(again, eager), k
    assert len(graphs) == 3
    assert eager.valid.any() and not eager.valid[-1].any()


def test_one_graph_serves_two_batches_of_a_bucket(card):
    """Batches A, B, A through one bucket: each equals its eager decode,
    nothing of A stays in B's result, and the graph replays."""
    from slimt_tpu_torch.models.loop_graph import ChunkGraph, GraphCache

    params = _loop_params(card)
    graphs = GraphCache()
    batches = [_loop_batch(card, seed=s) for s in (0, 1, 0)]
    want = [_decode(params, *batch, _eager=True) for batch in batches]
    replays = ChunkGraph.replays
    got = [_decode(params, *batch, graphs=graphs, loop_unroll=4) for batch in batches]
    assert len(graphs) == 1
    assert ChunkGraph.replays > replays
    for g, w in zip(got, want):
        assert _same(g, w)
    assert not torch.equal(got[0].tokens, got[1].tokens)


def test_replays_count_the_kernels_they_launch(card):
    """A replay adds its chunk's launches to the counters: one whole step
    a decode step under fused_step."""
    from slimt_tpu_torch.models import decode
    from slimt_tpu_torch.models.loop_graph import GraphCache

    params = _loop_params(card)
    ids, mask = _loop_batch(card)
    graphs = GraphCache()
    for _ in range(2):  # the first captures, the second only replays
        chunks = decode.run_loop.chunks
        launches = dstep.whole_step_kernel.launches
        _decode(params, ids, mask, provider="fused_step", loop_unroll=4, graphs=graphs,
                eos_id=-1)
        ran = decode.run_loop.chunks - chunks
        assert ran == 5  # 17 steps in chunks of 4
        assert dstep.whole_step_kernel.launches - launches == 4 * ran


def test_a_failed_capture_raises(card):
    """A chunk that waits on the host cannot be captured: it raises, and
    nothing falls back to an eager loop."""
    from slimt_tpu_torch.models.loop_graph import ChunkGraph

    x = torch.ones(4, device=card)
    graph = ChunkGraph(lambda: x.add_(x.sum().item()), card)
    with pytest.raises(RuntimeError):
        graph.run()
    assert graph.graph is None


def test_two_models_capture_on_two_threads_at_once(card):
    """Two Models (a pivot pair's shape), each forwarding on its own thread
    while the other captures; each equals its eager loop."""
    import threading

    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=8)
    spm = spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS, target_size=512))
    models = [Model(config, Package(synthetic_model_bytes(
        config=config, vocab_size=512, emb_dim=256, ffn_dim=1536, seed=seed), spm))
        for seed in (1, 2)]
    segments = [[3 + (i * 7 + j) % 400 for j in range(20 + i)] + [models[0].vocabulary.eos_id]
                for i in range(6)]
    want = []
    for model in models:
        model._eager_loop = True
        want.append([h.target for h in model.forward(segments, need_alignment=False)])
        model._eager_loop = False
    start = threading.Barrier(2)
    got = [None, None]

    def serve(i):
        start.wait()
        for _ in range(3):
            got[i] = [h.target for h in models[i].forward(segments, need_alignment=False)]

    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert got == want
    assert all(len(model._graphs) == 1 for model in models)


def test_launch_counts_hold_while_two_models_capture(card):
    """Two fused_step Models forwarding on two threads at once, each
    capturing while the other launches or replays: the whole step's
    launches equal both Models' chunks times k (one launch a step), so no
    thread's launches are lost to, or added to, the other's capture."""
    import threading

    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.models import decode
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=8,
                         qmm_provider="fused_step")
    spm = spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS, target_size=512))
    models = [Model(config, Package(synthetic_model_bytes(
        config=config, vocab_size=512, emb_dim=256, ffn_dim=1536, seed=seed), spm))
        for seed in (1, 2)]
    eos = models[0].vocabulary.eos_id
    batches = [[[3 + (i * 7 + j) % 400 for j in range(12 + 9 * i + n)] + [eos]
                for n in range(4)] for i in (0, 1)]
    start = threading.Barrier(2)
    errors = []

    def serve(i):
        try:
            start.wait()
            for _ in range(4):
                models[i].forward(batches[i], need_alignment=False)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    chunks, launches = decode.run_loop.chunks, dstep.whole_step_kernel.launches
    threads = [threading.Thread(target=serve, args=(i,)) for i in (0, 1)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert not errors
    ran = decode.run_loop.chunks - chunks
    assert ran >= 8
    assert dstep.whole_step_kernel.launches - launches == ran * decode.resolve_unroll(None)
    assert all(model._graphs.counts == {"hits": 3, "misses": 1, "evictions": 0}
               for model in models)


def test_greedy_decode_on_the_card_needs_a_graph_cache(card):
    """On CUDA the loop replays graphs from the caller's cache: none given
    raises, and nothing falls back to the eager loop."""
    params = _loop_params(card)
    ids, mask = _loop_batch(card)
    with pytest.raises(ValueError, match="GraphCache"):
        _decode(params, ids, mask)


@pytest.mark.parametrize("provider", [None, "fused_step"], ids=["declared", "fused_step"])
def test_continuous_engine_matches_batch_at_a_time(card, provider):
    """The engine's tokens on the card equal its eager chunks' and each
    segment's batch-at-a-time decode at B=1 (T = the pool's, cap
    floor(1.5 * length))."""
    from slimt_tpu_torch.models.continuous import ContinuousEngine
    from slimt_tpu_torch.models.loop_graph import GraphCache

    params = _loop_params(card)
    graphs = GraphCache()
    rng = np.random.default_rng(4)
    segments = [rng.integers(3, LOOP_VOCAB, rng.integers(3, 30)).astype(int).tolist()
                for _ in range(24)]
    kw = dict(eos_id=5, num_heads=8, slots=8, chunk=4, t_slot=32, admit_bucket=8,
              provider=provider)
    got = ContinuousEngine(params, **kw).translate(segments)
    assert got == ContinuousEngine(params, _eager=True, **kw).translate(segments)
    want = []
    for seg in segments:
        ids = torch.zeros((1, 32), dtype=torch.int32, device=card)
        mask = torch.zeros((1, 32), device=card)
        ids[0, :len(seg)] = torch.tensor(seg, dtype=torch.int32)
        mask[0, :len(seg)] = 1.0
        out = _decode(params, ids, mask, eos_id=5, max_steps=48, provider=provider,
                      steps_cap=max(1, int(1.5 * len(seg))), with_alignment=False,
                      fused_layer=True, fused_sdpa=True, graphs=graphs)
        want.append(out.tokens[0][out.valid[0]].tolist())
    assert got == want


# -- The numerics knobs on the card ------------------------------------------
INT8_COUNTERS = (qmm.affine_kernel, enc.layer_kernel, logits_argmax.argmax_affine_kernel,
                 dstep.whole_step_kernel, fused_blocks.ssru_kernel, fused_blocks.ffn_kernel)


def _launches(counters):
    return [counter.launches for counter in counters]


@pytest.mark.parametrize("kv", ["int16", "float32"])
def test_f32_provider_launches_no_int8_kernel(card, kv):
    """qmm_provider "f32" on the card: the graph loop bit-equal to the
    eager loop, no int8 kernel launched (its products are f32 matmuls
    against the dequantized weights), and >= 99% of the tokens equal to
    the CPU's f32 path (f32 sums in another order)."""
    from slimt_tpu_torch.models.loop_graph import GraphCache

    params = _loop_params(card, dequantize=True)
    ids, mask = _loop_batch(card)
    kwargs = dict(provider="f32", kv_dtype=kv, fused_layer=True, fused_sdpa=False)
    before = _launches(INT8_COUNTERS)
    eager = _decode(params, ids, mask, _eager=True, **kwargs)
    got = _decode(params, ids, mask, graphs=GraphCache(), **kwargs)
    torch.cuda.synchronize()
    assert _launches(INT8_COUNTERS) == before
    assert _same(got, eager)
    cpu = _decode(_loop_params("cpu", dequantize=True), ids.cpu(), mask.cpu(), **kwargs)
    equal = (got.tokens.cpu() == cpu.tokens) & cpu.valid
    assert int(equal.sum()) >= 0.99 * int(cpu.valid.sum())


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_encoder_on_the_card(card, dtype):
    """encoder_dtype on the card: the encoder within one unit in the last
    place of the CPU's on >= 99% of the real positions (the card sums LN,
    softmax and the f32 epilogues in another order), qmm_affine launched
    and the whole-layer kernel not (its gate needs an f32 encoder), and
    the graph loop bit-equal to the eager loop."""
    from slimt_tpu_torch.models.loop_graph import GraphCache

    act = tfm.act_dtype(dtype)
    params, cpu_params = _loop_params(card), _loop_params("cpu")
    ids, mask = _loop_batch(card)
    outs = []
    for p, i, m in ((params, ids, mask), (cpu_params, ids.cpu(), mask.cpu())):
        x = tfm.transform_embedding(tfm.embed(p, i, act))
        outs.append(tfm.encoder_forward(p, x, tfm.make_additive_mask(m), 8,
                                        fused_layer=True, act_dtype=act).float().cpu())
    real = mask.cpu().bool()
    got, want = outs[0][real], outs[1][real]
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want)[1] - 1 - (10 if dtype == "float16"
                                                                         else 7))
    assert float(((got - want).abs() <= ulp).float().mean()) >= 0.99
    kwargs = dict(encoder_dtype=dtype, fused_layer=True)
    affine, layer = qmm.affine_kernel.launches, enc.layer_kernel.launches
    eager = _decode(params, ids, mask, _eager=True, **kwargs)
    got = _decode(params, ids, mask, graphs=GraphCache(), **kwargs)
    torch.cuda.synchronize()
    assert qmm.affine_kernel.launches > affine and enc.layer_kernel.launches == layer
    assert _same(got, eager)


@pytest.mark.parametrize("emb", [32, 40, 64])
@pytest.mark.parametrize("method", ["exact", "packed_fp16"])
def test_argmax_at_a_narrow_width_on_the_card(card, method, emb):
    """At the crosscheck cells' widths (32, 64) and one that is not a
    multiple of 16, the argmax kernel is bit-equal to its plain version
    in every method (full vocabulary and a shortlist, B in 1, 8, 33), and
    the greedy loop launches it: the graph loop bit-equal to the eager
    loop, the real rows decoding."""
    from slimt_tpu_torch.models.loop_graph import GraphCache

    config = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=512, emb_dim=emb, ffn_dim=128, seed=0)), config)
    params = params_from_numpy(host, card)
    gen = torch.Generator(device=card)
    gen.manual_seed(emb)
    ids = torch.randperm(512, device=card, generator=gen)[:200].sort().values
    aq, inv = params["out"]["aq"], tfm.output_inv(params)
    for w, b in (tfm.prepare_output_projection(params),
                 tfm.prepare_output_projection(params, ids)):
        for rows in (1, 8, 33):
            y = torch.randn((rows, emb), device=card, generator=gen) * 2.0
            for m in logits_argmax.METHODS:
                got = logits_argmax.argmax_affine_kernel(y, w, b, aq, inv, m)
                want = logits_argmax.argmax_affine_plain(y, w, b, aq, inv, m)
                assert torch.equal(got, want), (m, rows, tuple(w.shape))
    ids, mask = _loop_batch(card)
    ids = ids % 512
    kwargs = dict(num_heads=4, kv_dtype="float32", argmax_method=method, fused_layer=True)
    before = logits_argmax.argmax_affine_kernel.launches
    eager = _decode(params, ids, mask, _eager=True, **kwargs)
    got = _decode(params, ids, mask, graphs=GraphCache(), **kwargs)
    torch.cuda.synchronize()
    assert logits_argmax.argmax_affine_kernel.launches > before
    assert _same(got, eager)
    assert bool(got.valid[:-1].any(-1).all()) and not got.valid[-1].any()


# -- The front doors on the card --------------------------------------------


@pytest.fixture
def door_package(card, tmp_path):
    """A synth package wide enough for the encoder layer kernel (E=128)."""
    from slimt_tpu_torch import cli

    root = str(tmp_path / "pkg")
    assert cli.main(["synth", "--out", root, "--emb-dim", "128", "--ffn-dim", "256"]) == 0
    return root


def _door_model(root, device="cuda"):
    import os

    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.config import preset

    return Model(preset.tiny(), Package(os.path.join(root, "model.bin"),
                                        os.path.join(root, "vocab.spm")), device=device)


def _blocking_text(model, text):
    from slimt_tpu_torch import Blocking, Config

    with Blocking(Config()) as service:
        return service.translate_bulk(model, [text])[0].target.text


def test_cli_translates_on_the_card_by_default(door_package, capsys):
    from slimt_tpu_torch import cli

    capsys.readouterr()
    before = (qmm.affine_kernel.launches, enc.layer_kernel.launches)
    assert cli.main(["translate", "--root", door_package, "--text", "hello world ."]) == 0
    out = capsys.readouterr().out
    assert qmm.affine_kernel.launches > before[0] and enc.layer_kernel.launches > before[1]
    model = _door_model(door_package)
    assert model.device.type == "cuda"
    assert out == _blocking_text(model, "hello world .") + "\n"
    npz = f"{door_package}/model.npz"
    assert cli.main(["convert", f"{door_package}/model.bin", npz]) == 0
    capsys.readouterr()
    assert cli.main(["translate", "--root", door_package, "--model", "model.npz",
                     "--text", "hello world ."]) == 0
    assert capsys.readouterr().out == out


def test_server_answers_on_the_card(door_package):
    import json
    import threading
    import urllib.request

    from slimt_tpu_torch.config import Config
    from slimt_tpu_torch.server import TranslationServer, make_httpd

    model = _door_model(door_package)
    server = TranslationServer(Config(workers=1))
    server.add_model("m", model)
    httpd = make_httpd(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(url + "/health/devices", timeout=60) as resp:
            probe = json.loads(resp.read())
        assert resp.status == 200 and probe["ok"] and "cuda:0" in probe["devices"]
        assert "cpu" not in probe["devices"]
        request = urllib.request.Request(
            url + "/translate", data=json.dumps({"text": "hello world ."}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=300) as resp:
            body = json.loads(resp.read())
        assert body["target"] == _blocking_text(model, "hello world .")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        server.close()


def test_probe_devices_runs_on_every_card(card):
    from slimt_tpu_torch.runtime.health import probe_devices

    probe = probe_devices(timeout=60)
    assert probe["ok"]
    assert sorted(probe["devices"]) == sorted(
        f"cuda:{i}" for i in range(torch.cuda.device_count()))
    both = probe_devices(timeout=60, kinds=("cpu", "cuda"))
    assert both["ok"] and "cpu" in both["devices"]


def test_capi_translates_on_the_card(door_package):
    import ctypes
    import json
    import os

    from slimt_tpu_torch import capi
    from slimt_tpu_torch.bindings import Service
    from slimt_tpu_torch.ops import _capi_build

    lib = ctypes.CDLL(str(_capi_build.library_path()))
    lib.slimt_init.argtypes = [ctypes.c_char_p]
    lib.slimt_last_error.restype = ctypes.c_char_p
    lib.slimt_service_create.restype = ctypes.c_longlong
    lib.slimt_model_create.argtypes = [ctypes.c_char_p]
    lib.slimt_model_create.restype = ctypes.c_longlong
    strings = ctypes.POINTER(ctypes.c_char_p)
    lib.slimt_translate.argtypes = [ctypes.c_longlong, ctypes.c_longlong, strings,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.slimt_translate.restype = strings
    lib.slimt_free_strings.argtypes = [strings]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert lib.slimt_init(repo.encode()) == 0, lib.slimt_last_error()
    service = lib.slimt_service_create(1, 0)
    spec = {"model": f"{door_package}/model.bin", "vocabulary": f"{door_package}/vocab.spm"}
    handle = lib.slimt_model_create(json.dumps(spec).encode())  # no "device": the card
    assert service and handle, lib.slimt_last_error()
    model = capi._get(handle)
    assert model.device.type == "cuda"
    texts = ["hello world .", "the cat sat ."]
    out = lib.slimt_translate(service, handle, (ctypes.c_char_p * 2)(*[t.encode() for t in texts]),
                              2, 0, 0)
    assert out, lib.slimt_last_error()
    got = [out[i].decode() for i in range(2)]
    lib.slimt_free_strings(out)
    reference = Service(workers=1, cache_size=0)
    try:
        assert got == [r.target.text for r in reference.translate(model, texts)]
    finally:
        reference.close()
        capi.release(handle)
        capi.release(service)


# The widths of the repo's own configurations (crosscheck and parity
# cells, tiny11, base) and one padded case (E=40, F=80: rows at a pitch
# of 48, masked products): (E, F, heads).
BLOCK_WIDTHS = [(32, 64, 2), (40, 80, 1), (64, 128, 4), (64, 256, 8), (256, 1536, 8),
                (512, 2048, 8)]
# A row within the kernels' 2e-5 unless an int8 rounding flips against
# the plain version's sum order (a step of an activation quantum, well
# under FLIP_BOUND); such rows stay few.
FLIP_BOUND, WITHIN_MIN = 0.25, 0.97


def _rows_ok(err):
    assert float(err.max()) <= FLIP_BOUND, float(err.max())
    assert float((err <= 2e-5).float().mean()) >= WITHIN_MIN


@pytest.mark.parametrize("emb,ffn,heads", BLOCK_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("m", [1, 33, 130])
def test_fused_blocks_at_every_width(card, emb, ffn, heads, m):
    """#5 and #6 launch at every width the JAX kernels take, hold to their
    plain versions and, on one block a tile, bit-equal the chooser's
    cluster layout."""
    layer = _decoder_layer(card, emb, ffn, seed=m + emb)
    gen = torch.Generator(device=card)
    gen.manual_seed(m + ffn)
    x = torch.randn((m, emb), device=card, generator=gen) * 2.0
    c = torch.randn((m, emb), device=card, generator=gen)
    before = (fused_blocks.ssru_kernel.launches, fused_blocks.ffn_kernel.launches)
    h, c_t = fused_blocks.ssru_kernel(x, c, layer["rnn"])
    y = fused_blocks.ffn_kernel(x, layer["ffn"])
    assert (fused_blocks.ssru_kernel.launches, fused_blocks.ffn_kernel.launches) == (
        before[0] + 1, before[1] + 1)
    one = fused_blocks.ssru_kernel(x, c, layer["rnn"], _cluster=1)
    y_one = fused_blocks.ffn_kernel(x, layer["ffn"], _cluster=1)
    want_h, want_c = fused_blocks.ssru_plain(x, c, layer["rnn"])
    want_y = fused_blocks.ffn_plain(x, layer["ffn"])
    torch.cuda.synchronize()
    assert torch.equal(h, one[0]) and torch.equal(c_t, one[1]) and torch.equal(y, y_one)
    _rows_ok(torch.maximum((h - want_h).abs().amax(-1), (c_t - want_c).abs().amax(-1)))
    _rows_ok((y - want_y).abs().amax(-1))


def _width_step_case(card, emb, ffn, heads, b, t, seed):
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=heads)
    params = params_from_numpy(load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=STEP_VOCAB, emb_dim=emb, ffn_dim=ffn, seed=seed)), config),
        card)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    layers = params["decoder"]
    x = torch.randn((b, 1, emb), device=card, generator=gen) * 2.0
    states = tuple(torch.randn((b, 1, emb), device=card, generator=gen) for _ in layers)
    mask = torch.ones((b, t), device=card)
    mask[0, t // 2:] = 0.0
    mask_add = ((1.0 - mask) * -99999999.0)[:, None, None, :]
    caches = tuple({"k": torch.randint(-32767, 32768, (b, t, emb), device=card,
                                       dtype=torch.int16, generator=gen),
                    "v": torch.randint(-32767, 32768, (b, t, emb), device=card,
                                       dtype=torch.int16, generator=gen),
                    "kqi": torch.full((b, t), 1.0 / 32767.0, device=card),
                    "vqi": torch.full((b, t), 1.0 / 32767.0, device=card)} for _ in layers)
    return (layers, states, x, mask_add, caches, heads, tfm.prepare_output_projection(params),
            params["out"]["aq"], tfm.output_inv(params))


@pytest.mark.parametrize("emb,ffn,heads", BLOCK_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("b,t", [(1, 16), (33, 64)])
def test_whole_step_at_every_width(card, emb, ffn, heads, b, t):
    """#7 launches at every width of BLOCK_WIDTHS, holds its states and
    attn0 to the plain step, and its cluster layout bit-equals one block a
    tile; differing choices are near ties of the plain logits."""
    args = _width_step_case(card, emb, ffn, heads, b, t, seed=b + emb)
    before = dstep.whole_step_kernel.launches
    choice, states, attn0 = dstep.whole_decode_step(*args)
    assert dstep.whole_step_kernel.launches == before + 1
    one = dstep.whole_step_kernel(*args, _cluster=1)
    y, want_states, want_attn0 = dstep.layers_plain(*args[:6])
    want = dstep.argmax_affine_plain(y, *args[6], args[7], args[8])
    torch.cuda.synchronize()
    assert torch.equal(choice, one[0]) and torch.equal(attn0, one[2])
    assert all(torch.equal(a, b) for a, b in zip(states, one[1]))
    err = (attn0 - want_attn0).abs().amax(-1)
    for got, ref in zip(states, want_states):
        err = torch.maximum(err, (got - ref).abs().amax((1, 2)))
    _rows_ok(err)
    differ = (choice != want).nonzero().flatten()
    if len(differ):
        logits = qmm.affine_plain(y, *args[6], args[7], args[8])[differ]
        picked = logits.gather(1, choice[differ].long()[:, None])[:, 0]
        assert float((logits.amax(-1) - picked).max()) <= 1e-3


def test_widths_past_a_blocks_shared_memory_raise(card):
    """A row tile that no block of a cluster can hold raises ValueError
    naming its shared memory, before any launch; nothing falls to the
    plain version."""
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_blocks.ssru_layout(1, 20000, card.index or 0)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        fused_blocks.ffn_layout(1, 20000, 80000, card.index or 0)


def test_jni_translates_on_the_card(door_package):
    """The port's JNI binding through its fake-JVM host with no device
    field: the model runs on the card, and its lines equal the C ABI's
    object table on the card for the same spec."""
    import json
    import os
    import subprocess

    from slimt_tpu_torch import capi
    from slimt_tpu_torch.ops import _native_build

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    texts = ["hello world .", "the cat sat ."]
    env = dict(os.environ, SLIMT_TPU_TORCH_PYTHONPATH=repo)
    env.pop("SLIMT_JNI_DEVICE", None)
    out = subprocess.run(
        [str(_native_build.jni_host_path()), str(_native_build.jni_library_path()),
         door_package, "6", "2", "2", "8", *texts],
        capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr
    spec = {"preset": "tiny", "encoder_layers": 6, "decoder_layers": 2,
            "feed_forward_depth": 2, "num_heads": 8, "split_mode": "sentence",
            "model": f"{door_package}/model.bin", "vocabulary": f"{door_package}/vocab.spm",
            "shortlist": f"{door_package}/shortlist.bin"}
    service = capi.service_create(1, 64)
    model = capi.model_create(json.dumps(spec))
    try:
        assert capi._get(model).device.type == "cuda"
        assert out.stdout.splitlines() == capi.translate(service, model, texts)
    finally:
        capi.release(model)
        capi.release(service)
