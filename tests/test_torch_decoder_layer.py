"""The port's per-layer decoder steps and the whole step's float-cache
branch (slimt_tpu_torch/ops/decoder_step.py) against the JAX kernels of
slimt_tpu/ops/decoder_step_pallas.py in interpret mode, on the CPU:

  decoder_layer_step      (#10) over a split [B, H, T, D] float cache;
  decoder_layer_step_bte  (#11) over a joined [B, T, E] float cache;
  whole_decode_step       (#7)  over joined float32, bfloat16 and float16
                                caches.

At B=5, T=12, E=32, H=4, as tests/test_fused_blocks.py runs #10.
Tolerances: y and c' within 1e-5, the head-0 attention within 1e-6 (max
|diff|; the two sides sum in different orders); choices equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from slimt_tpu.config import ModelConfig  # noqa: E402
from slimt_tpu.io import load_items  # noqa: E402
from slimt_tpu.io.loader import load_weights  # noqa: E402
from slimt_tpu.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu.models import transformer as jtfm  # noqa: E402
from slimt_tpu.ops import decoder_step_pallas as jdsp  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import decoder_step as dstep  # noqa: E402

B, T, E, H = 5, 12, 32, 4
VOCAB = 2500  # two 2048-column JAX projection tiles, the second partial
Y_TOL = 1e-5
ATTN_TOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


@pytest.fixture(scope="module")
def params():
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=H)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=E, ffn_dim=64, seed=11)), config)
    return host, params_from_numpy(host, "cpu")


def _to_torch(a) -> torch.Tensor:
    """A JAX array as a torch tensor of the same type and bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _inputs(host, seed, split):
    """x, c, the mask (row 1 padded over its last 4 keys, row 4 a padding
    row) and layer 0's f32 cache, split [B, H, T, D] or joined [B, T, E]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 1, E)).astype(np.float32)
    c = rng.standard_normal((B, 1, E)).astype(np.float32)
    enc = (rng.standard_normal((B, T, E)) * 0.3).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[1, -4:] = 0
    mask[4] = 0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :]
    kv = jtfm.precompute_cross_kv(
        {"decoder": host["decoder"][:1]}, jnp.asarray(enc), H, "xla_int8",
        None if split else jnp.float32)[0]
    pair = kv if split else (kv["k"], kv["v"])
    return x, c, mask_add.astype(np.float32), pair


def _check(got, want):
    for g, w, tol in zip(got, want, (Y_TOL, Y_TOL, ATTN_TOL)):
        assert tuple(g.shape) == tuple(w.shape)
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("split", [True, False], ids=["split", "joined"])
def test_layer_step_plain_matches_jax(params, split, dtype):
    host, tp = params
    x, c, mask_add, pair = _inputs(host, seed=4 + split, split=split)
    jdt, _ = DTYPES[dtype]
    kv = tuple(a.astype(jdt) for a in pair)
    run_jax = jdsp.decoder_layer_step if split else jdsp.decoder_layer_step_bte
    want = run_jax(host["decoder"][0], jnp.asarray(c),
                   jnp.asarray(x), jnp.asarray(mask_add), kv, H, interpret=True)
    run = dstep.decoder_layer_step if split else dstep.decoder_layer_step_bte
    got = run(tp["decoder"][0], torch.from_numpy(c), torch.from_numpy(x),
              torch.from_numpy(mask_add), tuple(_to_torch(a) for a in kv), H)
    _check(got, want)


def test_split_step_rounds_nothing(params):
    """#10 and #11 keep apart: over the same bfloat16 cache the split step
    leaves q unrounded and the joined one rounds it, so their head-0
    attention differs (each equals its JAX kernel)."""
    host, tp = params
    x, c, mask_add, split = _inputs(host, seed=9, split=True)
    k, v = (a.astype(jnp.bfloat16) for a in split)
    joined = tuple(a.transpose(0, 2, 1, 3).reshape(B, T, E) for a in (k, v))
    args = (tp["decoder"][0], torch.from_numpy(c), torch.from_numpy(x),
            torch.from_numpy(mask_add))
    p_split = dstep.decoder_layer_step(*args, (_to_torch(k), _to_torch(v)), H)[2]
    p_joined = dstep.decoder_layer_step_bte(*args, tuple(_to_torch(a) for a in joined), H)[2]
    assert float((p_split - p_joined).abs().max()) > 100 * ATTN_TOL


def _step_inputs(host, dtype, b, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, 1, E)) * 2).astype(np.float32)
    states = [rng.standard_normal((b, 1, E)).astype(np.float32) for _ in range(2)]
    enc = rng.standard_normal((b, T, E)).astype(np.float32)
    lengths = rng.integers(1, T + 1, size=b)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    if b > 1:
        mask[-1] = 0.0
    mask_add = ((1.0 - mask) * np.float32(-99999999.0))[:, None, None, :]
    caches = jtfm.precompute_cross_kv(host, jnp.asarray(enc), H, "xla_int8",
                                      DTYPES[dtype][0])
    return x, states, mask_add.astype(np.float32), caches


@pytest.mark.parametrize("with_shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_whole_step_float_cache_matches_jax(params, dtype, b, with_shortlist):
    host, tp = params
    x, states, mask_add, caches = _step_inputs(host, dtype, b, seed=b + len(dtype))
    jp = {k: host[k] for k in ("emb", "out", "decoder")}
    shortlist = np.arange(0, VOCAB, 3, dtype=np.int32) if with_shortlist else None
    want_choice, want_states, want_attn0 = jdsp.whole_decode_step(
        jp["decoder"], tuple(jnp.asarray(s) for s in states), jnp.asarray(x),
        jnp.asarray(mask_add), caches, H,
        jtfm.prepare_output_projection(
            jp, None if shortlist is None else jnp.asarray(shortlist)),
        out_aq=jp["out"]["aq"], emb_bq=jp["emb"]["scale"], interpret=True)
    projection = tfm.prepare_output_projection(
        tp, None if shortlist is None else torch.from_numpy(shortlist))
    port_caches = tuple({name: _to_torch(value) for name, value in kv.items()}
                        for kv in caches)
    assert port_caches[0]["k"].dtype == DTYPES[dtype][1]
    choice, new_states, attn0 = dstep.whole_decode_step(
        tp["decoder"], tuple(torch.from_numpy(s) for s in states), torch.from_numpy(x),
        torch.from_numpy(mask_add), port_caches, H, projection, tp["out"]["aq"],
        tfm.output_inv(tp))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(want_choice))
    _check(new_states + (attn0,), tuple(want_states) + (want_attn0,))


def test_layer_step_kernels_take_cuda_float_caches_only(params):
    """No fallback: the kernel entries raise on CPU tensors and on caches
    they do not read."""
    _, tp = params
    layer = tp["decoder"][0]
    x = torch.zeros((2, 1, 256))
    joined = (torch.zeros((2, 8, 256)),) * 2
    with pytest.raises(ValueError, match="F=64"):
        dstep.decoder_layer_step_bte_kernel(layer, x, x, torch.zeros((2, 1, 1, 8)),
                                            (torch.zeros((2, 8, 32)),) * 2, 8)
    big = params_from_numpy(load_weights(load_items(synthetic_model_bytes(
        config=ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=8),
        vocab_size=64, emb_dim=256, ffn_dim=1536, seed=0)),
        ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=8)), "cpu")
    layer = big["decoder"][0]
    for run, kv in ((dstep.decoder_layer_step_bte_kernel, joined),
                    (dstep.decoder_layer_step_kernel, (torch.zeros((2, 8, 8, 32)),) * 2)):
        with pytest.raises(ValueError, match="CUDA"):
            run(layer, x, x, torch.zeros((2, 1, 1, 8)), kv, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        dstep.decoder_layer_step(layer, x.to("meta"), x.to("meta"),
                                 torch.zeros((2, 1, 1, 8)), joined, 8)


def test_pointers_take_the_strided_projection_only():
    """The step's argument block takes the projection as a strided view
    (the transposed embedding) and refuses any other strided tensor."""
    emb = torch.zeros((64, 32), dtype=torch.int8)
    w = emb.T
    cpu = torch.device("cpu")
    ptrs = dstep._pointers([torch.zeros(4), None, w], cpu, strided=w)
    assert ptrs[1] is None and ptrs[2] == emb.data_ptr()
    with pytest.raises(ValueError, match="contiguous"):
        dstep._pointers([w], cpu)
