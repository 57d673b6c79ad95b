"""The port's two numerics knobs against the JAX package on the CPU:
qmm_provider="f32" (every int8 product an f32 product against the weights
dequantized once, the argmax over f32 logits) and encoder_dtype
"float16"/"bfloat16" (the split encoder's residual stream and SDPA
operands in that dtype), at 2+2 layers, 4 heads, emb 32 (sqrt(32) is not
a half-precision number, so its rounding shows), ffn 64, vocab 96.

Tolerances:
  - encoder_dtype: the embedding and transform_embedding are bit-equal
    to the JAX functions computed op by op; one split encoder layer
    (plain SDPA and blockwise) and the whole encoder are bit-equal on at
    least 99% of the real positions and within one unit in the last place
    of the act dtype on all of them (LN, softmax and exp differ by float32
    ulps between the two libraries, which now and then cross a bfloat16
    rounding boundary: measured one position of 960 after two layers).
    XLA's fused CPU code (jit, and the encoder's lax.scan over stacked
    layers) departs from those functions: it keeps f16/bf16 chains such
    as x * sqrt(E) + signal in float32 between roundings, so after one
    layer its output differs from the op-by-op one by up to ~0.1 on most
    positions (int8 quantization then amplifies one rounding step). The
    JAX-side Model and engine here therefore run their encoders op by op
    (`op_by_op`: the jitted entry points swapped for the functions they
    wrap, and the JAX Model's stacked encoder layers unstacked; nothing
    in the JAX package changes); tokens are equal.
  - f32: one split layer within 1e-5 and the decode step's new states
    and logits within 1e-5 (torch.matmul and jnp.dot sum in different
    orders); choices and tokens equal. The f32 logits differ from the
    int8 ones by more than 1e-3, so a silent int8 route fails.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import Config, ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import continuous as jcont  # noqa: E402
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.runtime.service import Blocking  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from slimt_tpu_torch.io.params import (  # noqa: E402
    add_dequantized,
    dequantized_bytes,
    params_from_numpy,
)
from slimt_tpu_torch.models import continuous as cont  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.runtime.service import Blocking as PortBlocking  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
HEADS, VOCAB, EMB, FFN = 4, 96, 32, 64
F32_TOL = 1e-5
INT8_GAP = 1e-3
DTYPES = {"float16": (jnp.float16, torch.float16), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ACT = pytest.mark.parametrize("dtype", list(DTYPES))
KNOBS = {"f32": {"qmm_provider": "f32"}, "float16": {"encoder_dtype": "float16"},
         "bfloat16": {"encoder_dtype": "bfloat16"}}
SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
LINES = ["hello world", "the quick brown fox", "a b c", "dog"]


@pytest.fixture(scope="module")
def weights():
    host = load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=3)), CONFIG)
    return jax.device_put(host), params_from_numpy(host, "cpu", dequantize=True)


@pytest.fixture
def op_by_op(monkeypatch):
    """The JAX Model's and engine's jitted entry points replaced by the
    functions they wrap, so their encoders run op by op (the decode
    loop's body still compiles, as lax.while_loop always does)."""
    monkeypatch.setattr(jdecode, "translate_batch_jit", jdecode.translate_batch_jit.__wrapped__)
    monkeypatch.setattr(jcont, "encode_segments", jcont.encode_segments.__wrapped__)


def unstack_encoder(jax_model) -> None:
    """The JAX Model's encoder as a list of layers, which encoder_forward
    runs one by one (the stacked form runs as one compiled lax.scan)."""
    layers = jax_model.params["encoder"]
    if not isinstance(layers, list):
        count = layers["att"]["ln"]["scale"].shape[0]
        jax_model.params = dict(jax_model.params, encoder=[
            jax.tree_util.tree_map(lambda a, i=i: a[i], layers) for i in range(count)])


# Mantissa bits and least normal exponent of each act dtype.
ULP_BITS = {torch.float16: (10, -14), torch.bfloat16: (7, -126)}


def _within_an_ulp(got, want, mask):
    """Real positions: within one unit in the last place of got's dtype
    of the JAX value, and bit-equal on at least 99% of them."""
    real = mask.astype(bool)
    g = got.float().numpy()[real]
    w = np.asarray(want).astype(np.float32)[real]
    bits, emin = ULP_BITS[got.dtype]
    _, exp = np.frexp(w)
    ulp = np.ldexp(np.float32(1), np.maximum(exp - 1, emin) - bits)
    assert np.all(np.abs(g - w) <= ulp), float(np.max(np.abs(g - w) / ulp))
    assert np.mean(g == w) >= 0.99, np.mean(g == w)


def _batch(seed, b=5, t=11):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, (b, t)).astype(np.int32)
    lengths = rng.integers(2, t + 1, b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    return indices, mask


@ACT
def test_embed_and_transform_in_act_dtype(weights, dtype):
    jp, tp = weights
    jd, td = DTYPES[dtype]
    indices, _ = _batch(1)
    got = tfm.embed(tp, torch.from_numpy(indices), td)
    want = jtfm.embed(jp, jnp.asarray(indices), dtype=jd)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))
    got = tfm.transform_embedding(got)
    want = jtfm.transform_embedding(want)
    assert got.dtype == td
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want).astype(np.float32))


@ACT
@pytest.mark.parametrize("flash", [False, True], ids=["sdpa", "blockwise"])
def test_split_encoder_layer_in_act_dtype(weights, dtype, flash):
    """One layer on an act-dtype input, within an ulp on real positions
    (_within_an_ulp); the whole-layer gate refuses an act dtype, so
    `fused_layer` changes nothing."""
    jp, tp = weights
    jd, td = DTYPES[dtype]
    indices, mask = _batch(2)
    x = jtfm.transform_embedding(jtfm.embed(jp, jnp.asarray(indices), dtype=jd))
    want = jtfm.encoder_layer_forward(
        jp["encoder"][0], x, jtfm.make_additive_mask(jnp.asarray(mask)), HEADS,
        flash=flash, act_dtype=jd)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(td)
    got = tfm.encoder_layer_forward(
        tp["encoder"][0], xt, tfm.make_additive_mask(torch.from_numpy(mask)), HEADS,
        flash=flash, fused_layer=True, act_dtype=td)
    assert got.dtype == td
    _within_an_ulp(got, want, mask)


@ACT
def test_encoder_in_act_dtype(weights, dtype):
    """embed → transform → both encoder layers, within an ulp."""
    jp, tp = weights
    jd, td = DTYPES[dtype]
    indices, mask = _batch(3)
    want = jtfm.encoder_forward(
        jp, jtfm.transform_embedding(jtfm.embed(jp, jnp.asarray(indices), dtype=jd)),
        jtfm.make_additive_mask(jnp.asarray(mask)), HEADS, act_dtype=jd)
    got = tfm.encoder_forward(
        tp, tfm.transform_embedding(tfm.embed(tp, torch.from_numpy(indices), td)),
        tfm.make_additive_mask(torch.from_numpy(mask)), HEADS, act_dtype=td)
    assert got.dtype == td
    _within_an_ulp(got, want, mask)


def test_split_encoder_layer_f32(weights):
    jp, tp = weights
    indices, mask = _batch(4)
    x = jtfm.transform_embedding(jtfm.embed(jp, jnp.asarray(indices)))
    want = jtfm.encoder_layer_forward(
        jp["encoder"][1], x, jtfm.make_additive_mask(jnp.asarray(mask)), HEADS,
        provider="f32")
    got = tfm.encoder_layer_forward(
        tp["encoder"][1], torch.from_numpy(np.array(x)),
        tfm.make_additive_mask(torch.from_numpy(mask)), HEADS, provider="f32",
        fused_layer=True)
    real = mask.astype(bool)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real], atol=F32_TOL, rtol=0)


def _step_inputs(tp, jp, seed, kv_dtype):
    """x, states, mask and one cache per decoder layer of an f32
    encoder output, in both packages."""
    rng = np.random.default_rng(seed)
    b, t = 5, 9
    x = (rng.standard_normal((b, 1, EMB)) * 2).astype(np.float32)
    states = [rng.standard_normal((b, 1, EMB)).astype(np.float32) for _ in range(2)]
    enc_out = rng.standard_normal((b, t, EMB)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    jcache = jtfm.precompute_cross_kv(
        jp, jnp.asarray(enc_out), HEADS, "f32",
        dtype=jnp.dtype(kv_dtype) if kv_dtype else None)
    tcache = tfm.precompute_cross_kv(tp, torch.from_numpy(enc_out), HEADS, kv_dtype, "f32")
    return (x, states, mask), jcache, tcache


@pytest.mark.parametrize("kv_dtype,method", [(None, "packed_int"), ("int16", "packed_fp16"),
                                             ("int16", "exact")])
@pytest.mark.parametrize("shortlist", [False, True], ids=["full", "shortlist"])
def test_decode_step_f32(weights, kv_dtype, method, shortlist):
    """Under "f32" the step's choices equal the JAX step's (packed_int
    falls to the exact first maximum, packed_fp16 compares fp16 keys of
    the f32 logits), its new states and logits within F32_TOL; the f32
    logits are not the int8 ones."""
    jp, tp = weights
    (x, states, mask), jcache, tcache = _step_inputs(tp, jp, 7, kv_dtype)
    sl = np.arange(1, VOCAB, 3, dtype=np.int32) if shortlist else None
    jsl = jnp.asarray(sl) if shortlist else None
    tsl = torch.from_numpy(sl) if shortlist else None
    jmask = jtfm.make_additive_mask(jnp.asarray(mask))
    tmask = tfm.make_additive_mask(torch.from_numpy(mask))
    want, want_states, _ = jtfm.decoder_step(
        jp, [jnp.asarray(s) for s in states], jnp.asarray(x), jmask, jcache, HEADS,
        "f32", jsl, sample=True, argmax_method=method)
    got, got_states, _ = tfm.decoder_step(
        tp, [torch.from_numpy(s) for s in states], torch.from_numpy(x), tmask, tcache,
        HEADS, shortlist=tsl, provider="f32", argmax_method=method)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(got_states, want_states):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=F32_TOL, rtol=0)
    want_logits, _, _ = jtfm.decoder_step(
        jp, [jnp.asarray(s) for s in states], jnp.asarray(x), jmask, jcache, HEADS,
        "f32", jsl)
    y = torch.from_numpy(x)
    for layer, state, kv in zip(tp["decoder"], [torch.from_numpy(s) for s in states], tcache):
        y, _, _ = tfm.decoder_layer_forward(layer, state, y, tmask, kv, HEADS, "f32")
    got_logits = tfm.output_logits(tp, y[:, 0, :], tsl, provider="f32")
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=F32_TOL,
                               rtol=0)
    int8_logits = tfm.output_logits(tp, y[:, 0, :], tsl)
    assert float((int8_logits - got_logits).abs().max()) > INT8_GAP


def _translate_pair(weights, knob, shortlist, seed=5):
    jp, tp = weights
    indices, mask = _batch(seed, b=6, t=12)
    opts = dict(eos_id=2, max_steps=16, num_heads=HEADS, kv_dtype="int16",
                argmax_method="packed_int", with_alignment=True)
    if knob == "f32":
        opts["provider"] = "f32"
    else:
        opts["encoder_dtype"] = knob
    sl = np.arange(0, VOCAB, 2, dtype=np.int32) if shortlist else None
    want = jdecode.translate_batch(jp, jnp.asarray(indices), jnp.asarray(mask),
                                   shortlist=jnp.asarray(sl) if shortlist else None, **opts)
    got = decode.translate_batch(tp, torch.from_numpy(indices), torch.from_numpy(mask),
                                 shortlist=torch.from_numpy(sl) if shortlist else None, **opts)
    return got, want


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("shortlist", [False, True], ids=["full", "shortlist"])
def test_translate_batch_matches_jax(weights, knob, shortlist):
    """translate_batch with each knob, with and without a shortlist:
    tokens and valid equal to the JAX function's, the alignment within
    1e-5."""
    got, want = _translate_pair(weights, knob, shortlist)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.alignment.numpy(), np.asarray(want.alignment),
                               atol=1e-5, rtol=0)


def test_f32_tokens_part_from_int8(weights):
    """The f32 provider's tokens are its own: on this batch they part
    from the int8 path's, so an int8 route under "f32" fails the tests
    above."""
    jp, tp = weights
    indices, mask = _batch(5, b=6, t=12)
    args = (tp, torch.from_numpy(indices), torch.from_numpy(mask))
    opts = dict(eos_id=2, max_steps=16, num_heads=HEADS)
    f32 = decode.translate_batch(*args, provider="f32", **opts)
    int8 = decode.translate_batch(*args, **opts)
    assert not torch.equal(f32.tokens, int8.tokens)


def test_dequantized_weights():
    """`w` = q / bq by division beside every int8 matrix and emb.w =
    emb.q / scale; add_dequantized adds nothing twice; about four
    times the int8 bytes."""
    host = load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=3)), CONFIG)
    params = params_from_numpy(host, "cpu")
    assert dequantized_bytes(params) == 0
    add_dequantized(params)
    first = params["decoder"][0]["rnn"]["w"]["w"]
    add_dequantized(params)
    assert params["decoder"][0]["rnn"]["w"]["w"] is first
    matrices = [p for layer in params["encoder"] + params["decoder"]
                for group in layer.values() for p in group.values()
                if isinstance(p, dict) and "q" in p]
    assert len(matrices) == 2 * 6 + 2 * 8
    int8_bytes = params["emb"]["q"].numel()
    for p in matrices:
        want = p["q"].numpy().astype(np.float32) / np.float32(p["bq"])
        np.testing.assert_array_equal(p["w"].numpy(), want)
        int8_bytes += p["q"].numel()
    np.testing.assert_array_equal(
        params["emb"]["w"].numpy(),
        params["emb"]["q"].numpy().astype(np.float32) / np.float32(params["emb"]["scale"]))
    assert dequantized_bytes(params) == 4 * int8_bytes


def _models(knob, shortlist):
    config = dataclasses.replace(TINY_TEST_CONFIG, **KNOBS[knob])
    pkg = make_package(config=config, with_shortlist=shortlist)
    port = Model(config, Package(pkg.model, pkg.vocabulary, pkg.shortlist, pkg.ssplit),
                 device="cpu")
    jax_model = JaxModel(config, pkg)
    unstack_encoder(jax_model)
    return jax_model, port


@pytest.fixture(scope="module", params=list(KNOBS))
def models(request):
    return _models(request.param, shortlist=False)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_model_shortlist_forward_matches_jax(op_by_op, knob):
    jax_model, port = _models(knob, shortlist=True)
    want = jax_model.forward(SEGMENTS, need_alignment=False)
    got = port.forward(SEGMENTS, need_alignment=False)
    assert [h.target for h in got] == [h.target for h in want]


def test_model_forward_matches_jax(models, op_by_op):
    jax_model, port = models
    if port.config.qmm_provider == "f32":
        assert dequantized_bytes(port.params) > 0
    for need_alignment in (False, True):
        want = jax_model.forward(SEGMENTS, need_alignment)
        got = port.forward(SEGMENTS, need_alignment)
        assert [h.target for h in got] == [h.target for h in want]
        for g, w in zip(got, want):
            if w.alignment:
                np.testing.assert_allclose(np.asarray(g.alignment), np.asarray(w.alignment),
                                           atol=1e-5, rtol=0)


def test_model_async_raw_and_arrays_match_jax(models, op_by_op):
    jax_model, port = models
    tokens, steps, _ = port.forward_async(SEGMENTS, False, raw=True)()
    w_tokens, w_steps, _ = jax_model.forward_async(SEGMENTS, False, raw=True)()
    np.testing.assert_array_equal(steps, w_steps)
    np.testing.assert_array_equal(tokens, w_tokens)
    indices = np.zeros((4, 16), np.int32)
    mask = np.zeros((4, 16), np.float32)
    for i, seg in enumerate(SEGMENTS):
        indices[i, :len(seg)] = seg
        mask[i, :len(seg)] = 1.0
    words = np.concatenate([np.asarray(s) for s in SEGMENTS])
    args = (indices, mask, np.array([len(s) for s in SEGMENTS]), len(SEGMENTS))
    got = port.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    want = jax_model.forward_async_arrays(*args, shortlist_words=words, raw=True)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("prefer_bulk", [False, True], ids=["request", "bulk"])
def test_blocking_lanes_match_jax(models, op_by_op, prefer_bulk):
    """Both Blocking lanes of each package, the port's own runtime
    against the JAX runtime."""
    jax_model, port = models
    with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
        want = service.translate(jax_model, LINES)
    from slimt_tpu_torch.config import Config as PortConfig

    with PortBlocking(PortConfig(prefer_bulk=prefer_bulk)) as service:
        got = service.translate(port, LINES)
    assert [r.target.text for r in got] == [r.target.text for r in want]


@pytest.mark.parametrize("knob", list(KNOBS))
def test_continuous_engine_matches_jax(weights, op_by_op, knob):
    """ContinuousEngine with each knob, declared cache and argmax: the
    JAX engine's tokens and stats."""
    jp, tp = weights
    rng = np.random.default_rng(13)
    segments = [rng.integers(3, VOCAB, rng.integers(4, 18)).astype(int).tolist()
                for _ in range(7)]
    kw = dict(eos_id=1, num_heads=HEADS, slots=3, chunk=4, t_slot=24, admit_bucket=2)
    if knob == "f32":
        kw["provider"] = "f32"
    else:
        kw["encoder_dtype"] = knob
    want_engine = jcont.ContinuousEngine(jp, **kw)
    engine = cont.ContinuousEngine(tp, **kw)
    assert engine.translate(segments) == want_engine.translate(segments)
    assert engine.stats == want_engine.stats


@pytest.mark.parametrize("method", ["exact", "packed_fp16", "packed_bf16", "packed_int"])
def test_argmax_kernel_takes_the_narrow_width(weights, monkeypatch, method):
    """output_argmax at E=32 (the crosscheck cells' width) sends every
    method to the argmax kernel's wrapper, as at E=256 (packed_int with
    the bias in accumulator units), and the index is the kernel's plain
    version's; the kernel's gate takes any E up to logits_argmax.MAX_EMB
    (past the gate on E, a CPU tensor fails only the device check)."""
    from slimt_tpu_torch.ops import logits_argmax

    _, tp = weights
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((6, EMB)).astype(np.float32))
    w, b = tfm.prepare_output_projection(tp)
    calls = []
    real = logits_argmax.argmax_affine
    monkeypatch.setattr(logits_argmax, "argmax_affine",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    got = tfm.output_argmax(tp, x, None, (w, b), method)
    assert len(calls) == 1
    bias = tfm.packed_int_bias(tp, b) if method == "packed_int" else b
    want = logits_argmax.argmax_affine_plain(x, w, bias, tp["out"]["aq"], tfm.output_inv(tp),
                                             method)
    assert torch.equal(got, want)
    bias = torch.zeros(8, dtype=torch.int32 if method == "packed_int" else torch.float32)
    for emb in (EMB, 40, 64, logits_argmax.MAX_EMB):
        y = torch.zeros((2, emb))
        ww = torch.zeros((emb, 8), dtype=torch.int8)
        with pytest.raises(ValueError, match="CUDA tensor"):
            logits_argmax.argmax_affine_kernel(y, ww, bias, 1.0, 1.0, method)
    with pytest.raises(ValueError, match="range"):
        logits_argmax.argmax_affine_kernel(
            torch.zeros((2, logits_argmax.MAX_EMB + 1)),
            torch.zeros((logits_argmax.MAX_EMB + 1, 8), dtype=torch.int8),
            bias, 1.0, 1.0, method)


def test_f32_needs_the_dequantized_weights():
    """Under "f32" nothing downstream of the loader dequantizes: params
    loaded without them raise, naming the loader's switch, in
    translate_batch and in ContinuousEngine."""
    host = load_weights(load_items(synthetic_model_bytes(
        config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=3)), CONFIG)
    params = params_from_numpy(host, "cpu")
    indices = torch.tensor([[5, 9, 4, 2]], dtype=torch.int32)
    mask = torch.ones((1, 4))
    with pytest.raises(ValueError, match="dequantize=True"):
        decode.translate_batch(params, indices, mask, eos_id=2, max_steps=4,
                               num_heads=HEADS, provider="f32")
    engine = cont.ContinuousEngine(params, eos_id=1, num_heads=HEADS, slots=2, chunk=2,
                                   t_slot=8, provider="f32")
    with pytest.raises(ValueError, match="dequantize=True"):
        engine.translate([[5, 9, 4]])
    assert dequantized_bytes(params) == 0
