"""The port's fused_step path (slimt_tpu_torch/ops/decoder_step.py and
its callers) against the JAX package's on the CPU: the whole decode
step against slimt_tpu.ops.decoder_step_pallas.whole_decode_step (in
interpret mode), the decode loop against translate_batch(provider=
"fused_step", kv_dtype="int16"), and ModelConfig(qmm_provider=
"fused_step") through both Models and the runtime.

Tolerances: choices and tokens equal; new states within 1e-5 and the
head-0 attention within 1e-6 (max |diff|; the two sides sum in
different orders); alignments within 1e-5.
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import Config, ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import decode as jdecode  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.ops import decoder_step_pallas as jdsp  # noqa: E402
from slimt_tpu.runtime.service import Blocking  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from slimt_tpu_torch.io.params import add_dequantized, params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import decode  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import _build  # noqa: E402
from slimt_tpu_torch.ops import decoder_step as dstep  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
HEADS = 4
EMB = 32
VOCAB = 4736  # three 2048-column JAX tiles, the last one partial
SHORTLIST = np.arange(0, VOCAB, 5, dtype=np.int32)
STATE_TOL = 1e-5
ATTN_TOL = 1e-6
ALIGN_TOL = 1e-5
SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
LINES = ["hello world", "the quick brown fox", "a b c", "dog"]


@pytest.fixture(scope="module")
def weights():
    host = load_weights(
        load_items(synthetic_model_bytes(
            config=CONFIG, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=64, seed=3,
        )),
        CONFIG,
    )
    return jax.device_put(host), params_from_numpy(host, "cpu")


def _step_inputs(b, t=9):
    """x, per-layer states, additive mask (ragged rows; the last row
    fully masked when b > 1) and int16 per-row caches, from a seed."""
    rng = np.random.default_rng(b)
    x = (rng.standard_normal((b, 1, EMB)) * 2).astype(np.float32)
    states = [rng.standard_normal((b, 1, EMB)).astype(np.float32) for _ in range(2)]
    lengths = rng.integers(1, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    if b > 1:
        mask[-1] = 0.0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :]
    caches = [
        {
            "k": rng.integers(-32767, 32768, (b, t, EMB)).astype(np.int16),
            "v": rng.integers(-32767, 32768, (b, t, EMB)).astype(np.int16),
            "kqi": (rng.uniform(0.5, 2.0, (b, t)) / 32767).astype(np.float32),
            "vqi": (rng.uniform(0.5, 2.0, (b, t)) / 32767).astype(np.float32),
        }
        for _ in range(2)
    ]
    return x, states, mask_add.astype(np.float32), caches


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("b", [1, 3, 33])
def test_whole_step_matches_jax(weights, b, with_shortlist):
    jp, tp = weights
    x, states, mask_add, caches = _step_inputs(b)
    shortlist = SHORTLIST if with_shortlist else None
    want_choice, want_states, want_attn0 = jdsp.whole_decode_step(
        jp["decoder"], tuple(jnp.asarray(s) for s in states), jnp.asarray(x),
        jnp.asarray(mask_add),
        tuple({k: jnp.asarray(v) for k, v in kv.items()} for kv in caches),
        HEADS,
        jtfm.prepare_output_projection(
            jp, None if shortlist is None else jnp.asarray(shortlist)),
        out_aq=jp["out"]["aq"], emb_bq=jp["emb"]["scale"],
    )
    projection = tfm.prepare_output_projection(
        tp, None if shortlist is None else torch.from_numpy(shortlist))
    choice, new_states, attn0 = dstep.whole_decode_step(
        tp["decoder"], tuple(torch.from_numpy(s) for s in states),
        torch.from_numpy(x), torch.from_numpy(mask_add),
        tuple({k: torch.from_numpy(v) for k, v in kv.items()} for kv in caches),
        HEADS, projection, tp["out"]["aq"], tfm.output_inv(tp),
    )
    assert choice.dtype == torch.int32
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    for got, want in zip(new_states, want_states):
        assert tuple(got.shape) == (b, 1, EMB)
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= STATE_TOL
    assert tuple(attn0.shape) == (b, 9)
    assert float(np.abs(attn0.numpy() - np.asarray(want_attn0)).max()) <= ATTN_TOL
    assert np.isfinite(attn0.numpy()).all()


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
def test_output_logits_and_exact_argmax_match_jax(weights, with_shortlist):
    jp, tp = weights
    rng = np.random.default_rng(5)
    y = (rng.standard_normal((6, EMB)) * 3).astype(np.float32)
    sl = SHORTLIST if with_shortlist else None
    want = jtfm.output_logits(jp, jnp.asarray(y), None,
                              None if sl is None else jnp.asarray(sl))
    got = tfm.output_logits(tp, torch.from_numpy(y),
                            None if sl is None else torch.from_numpy(sl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    projection = tfm.prepare_output_projection(
        tp, None if sl is None else torch.from_numpy(sl))
    want_choice = jtfm.output_argmax(
        jp, jnp.asarray(y), None,
        jtfm.prepare_output_projection(jp, None if sl is None else jnp.asarray(sl)),
        method="exact",
    )
    np.testing.assert_array_equal(tfm.first_max(got).numpy(), np.asarray(want_choice))
    np.testing.assert_array_equal(
        dstep.argmax_affine_plain(torch.from_numpy(y), *projection,
                                  tp["out"]["aq"], tfm.output_inv(tp)).numpy(),
        np.asarray(want_choice),
    )


def test_first_max_takes_the_first_of_equal_maxima():
    logits = torch.tensor([[1.0, 3.0, 3.0, -1.0], [0.0, -0.0, 0.0, -5.0]])
    np.testing.assert_array_equal(tfm.first_max(logits).numpy(), [1, 0])
    np.testing.assert_array_equal(
        tfm.first_max(logits).numpy(), np.asarray(jnp.argmax(logits.numpy(), -1)))


def _batch(seed, b=5, t=9):
    rng = np.random.default_rng(seed)
    indices = rng.integers(3, VOCAB, size=(b, t)).astype(np.int32)
    lengths = rng.integers(3, t + 1, size=b)
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)
    indices[mask == 0] = 0
    return indices, mask


def _port_translate(tp, indices, mask, shortlist=None, **kw):
    return decode.translate_batch(
        tp, torch.from_numpy(indices), torch.from_numpy(mask), eos_id=2,
        max_steps=12, num_heads=HEADS, provider="fused_step",
        shortlist=None if shortlist is None else torch.from_numpy(shortlist),
        **kw,
    )


@pytest.mark.parametrize("with_alignment", [False, True], ids=["plain", "aligned"])
@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
def test_translate_batch_fused_step_matches_jax(weights, with_shortlist, with_alignment):
    jp, tp = weights
    indices, mask = _batch(seed=1 + 2 * with_shortlist + with_alignment)
    shortlist = SHORTLIST if with_shortlist else None
    want = jdecode.translate_batch(
        jp, jnp.asarray(indices), jnp.asarray(mask), eos_id=2, max_steps=12,
        num_heads=HEADS, provider="fused_step", kv_dtype="int16",
        shortlist=None if shortlist is None else jnp.asarray(shortlist),
        with_alignment=with_alignment,
    )
    got = _port_translate(tp, indices, mask, shortlist, with_alignment=with_alignment)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.any()
    assert tuple(got.alignment.shape) == tuple(want.alignment.shape)
    if with_alignment:
        np.testing.assert_allclose(
            got.alignment.numpy(), np.asarray(want.alignment), atol=ALIGN_TOL, rtol=0)


def test_fused_step_coerces_reduced_kv(weights):
    """As in the JAX package, int8-class caches under fused_step become
    the int16 per-row cache: tokens identical to asking for int16."""
    _, tp = weights
    indices, mask = _batch(seed=6)
    want = _port_translate(tp, indices, mask, kv_dtype="int16")
    for kv in ("int8", "k8v16", "k16v8", "float16", None):
        got = _port_translate(tp, indices, mask, kv_dtype=kv)
        np.testing.assert_array_equal(got.tokens.numpy(), want.tokens.numpy())


@pytest.mark.parametrize(
    "provider,kv_dtype",
    [("fused_step", "bfloat16"), ("fused_step", "float32"), (None, "int8"),
     ("f32", "int16")],
)
def test_once_unported_decode_options_match_jax(weights, provider, kv_dtype):
    """Provider "f32" (on params loaded with its dequantized weights),
    the float caches under fused_step and the int8 cache, which once
    raised, give the JAX package's tokens."""
    jp, tp = weights
    if provider == "f32":
        tp = add_dequantized(copy.deepcopy(tp))
    indices, mask = _batch(seed=7, b=2)
    args = dict(eos_id=2, max_steps=4, num_heads=HEADS, provider=provider,
                kv_dtype=kv_dtype)
    got = decode.translate_batch(tp, torch.from_numpy(indices), torch.from_numpy(mask), **args)
    want = jdecode.translate_batch(jp, jnp.asarray(indices), jnp.asarray(mask), **args)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


FUSED = dataclasses.replace(TINY_TEST_CONFIG, qmm_provider="fused_step")


@pytest.fixture(scope="module", params=[False, True], ids=["full", "shortlist"])
def fused_models(request):
    pkg = make_package(config=FUSED, with_shortlist=request.param)
    port_pkg = Package(pkg.model, pkg.vocabulary, pkg.shortlist, pkg.ssplit)
    return JaxModel(FUSED, pkg), Model(FUSED, port_pkg, device="cpu")


def test_model_forward_fused_step_matches_jax(fused_models):
    jax_model, port = fused_models
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


def test_model_async_raw_and_arrays_fused_step_match_jax(fused_models):
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
def test_blocking_fused_step_matches_jax(fused_models, prefer_bulk):
    jax_model, port = fused_models
    with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
        want = service.translate(jax_model, LINES)
        got = service.translate(port, LINES)
    assert [r.target.text for r in got] == [r.target.text for r in want]


@pytest.mark.parametrize(
    "change", [{"kv_cache_dtype": "int8"}, {"argmax_method": "exact"},
               {"kv_cache_dtype": "float32"}],
)
def test_model_fused_step_options_match_jax(change):
    """Under fused_step the JAX Model coerces the cache to int16 and
    ignores argmax_method; the port does the same."""
    config = dataclasses.replace(FUSED, **change)
    pkg = make_package(config=config)
    port = Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")
    want = JaxModel(config, pkg).forward(SEGMENTS, need_alignment=False)
    got = port.forward(SEGMENTS, need_alignment=False)
    assert [h.target for h in got] == [h.target for h in want]


def test_fused_step_bfloat16_cache_raises():
    """fused_step over the bfloat16 joined cache once raised; it now
    serves the whole step's float branch with the JAX Model's tokens."""
    config = dataclasses.replace(FUSED, kv_cache_dtype="bfloat16")
    pkg = make_package(config=config)
    port = Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")
    want = JaxModel(config, pkg).forward(SEGMENTS, need_alignment=True)
    got = port.forward(SEGMENTS, need_alignment=True)
    assert [h.target for h in got] == [h.target for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.alignment), np.asarray(w.alignment),
                                   atol=ALIGN_TOL, rtol=0)


@pytest.mark.parametrize(
    "shape",
    # F=0; T=0; T past the 1-row shared-memory bound is the C entry's
    # (test_torch_gpu.py::test_whole_step_rows). Any F >= 1 is taken.
    [(32, 1536, 16, 8, 2), (256, 0, 16, 8, 2), (256, 1536, 0, 8, 2),
     (256, 1536, 16, 6, 2), (256, 1536, 16, 64, 2), (512, 2048, 16, 8, 9)],
)
def test_check_shapes_rejects(shape):
    with pytest.raises(ValueError, match="whole decode step"):
        dstep.check_shapes(*shape)


def test_kernel_wrappers_reject_cpu_tensors():
    """No fallback: the kernel entries take CUDA tensors or raise."""
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=256, ffn_dim=1536, seed=0)), config)
    tp = params_from_numpy(host, "cpu")
    b, t, e = 2, 16, 256
    caches = tuple(
        {"k": torch.zeros((b, t, e), dtype=torch.int16),
         "v": torch.zeros((b, t, e), dtype=torch.int16),
         "kqi": torch.ones((b, t)), "vqi": torch.ones((b, t))}
        for _ in range(2)
    )
    projection = tfm.prepare_output_projection(tp)
    states = tuple(torch.zeros((b, 1, e)) for _ in range(2))
    with pytest.raises(ValueError, match="CUDA"):
        dstep.whole_step_kernel(
            tp["decoder"], states, torch.zeros((b, 1, e)),
            torch.zeros((b, 1, 1, t)), caches, 8, projection,
            tp["out"]["aq"], tfm.output_inv(tp))
    with pytest.raises(ValueError, match="CUDA"):
        dstep.argmax_affine_kernel(torch.zeros((b, e)), *projection, 1.0, 1.0)


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """The build starts one nvcc -c per source together, then links the
    objects into the library and removes them."""
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('built')\n"
    )
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    sources = [tmp_path / "a.cu", tmp_path / "b.cu"]
    for src in sources:
        src.write_text("// source\n")
    target = tmp_path / "build" / "libk.so"
    _build._build(sources, target)
    calls = log.read_text().splitlines()
    assert len(calls) == 3
    assert all(" -c " in c and "-shared" not in c for c in calls[:2])
    assert "-shared" in calls[2] and " -c " not in calls[2]
    assert target.read_text() == "built"
    assert sorted(os.listdir(tmp_path / "build")) == ["libk.so"]
