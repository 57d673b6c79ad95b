"""The launch plans of the encoder layer (#2) and the decode attention
(#3) on the CPU: rows a tile, the QKV grid, the post-attention kernel's
cluster size fitted to a card, the scratch, and the wrappers' refusals,
which come before any build or launch; and a plain model of the
post-attention kernel's F-chunked FFN, whose FFN2 int32 sum is taken as
per-chunk partials over a cluster's shares of F, bit-equal to the plain
layer's FFN. The kernels themselves run on the card only
(tests/test_torch_gpu.py)."""

import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch.config import ModelConfig  # noqa: E402
from slimt_tpu_torch.io import load_items  # noqa: E402
from slimt_tpu_torch.io.loader import load_weights  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import _build, decode_attn, qmm  # noqa: E402
from slimt_tpu_torch.ops import encoder_layer as enc  # noqa: E402

H100_SMS = 132


def one_block_an_sm(rows, cs, e):
    """Clusters a card of H100_SMS SMs holds at once, one block an SM."""
    return H100_SMS // cs


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if a wrapper reaches the build (and so a launch)."""
    def refuse():
        raise AssertionError("the wrapper reached the kernels' library")
    monkeypatch.setattr(_build, "library", refuse)


@pytest.mark.parametrize("b,t,e,f,want", [
    (64, 64, 256, 1536, (32, 128, 64, 64, 2)),
    (512, 64, 256, 1536, (64, 512, 64, 512, 1)),
    (1, 64, 256, 1536, (16, 4, 64, 1, 16)),
    (3, 17, 256, 1536, (16, 4, 64, 1, 16)),
    (128, 128, 256, 1536, (64, 256, 64, 256, 1)),
    (64, 256, 256, 1536, (64, 256, 64, 256, 1)),
    (64, 64, 512, 2048, (32, 128, 32, 128, 1)),
    (512, 64, 512, 2048, (32, 1024, 32, 1024, 1)),
    (8, 1, 1024, 4096, (16, 1, 16, 1, 16)),
    (2, 100, 384, 1008, (16, 13, 32, 7, 1)),
    (64, 64, 256, 1000, (32, 128, 64, 64, 1)),
    (64, 64, 128, 512, (32, 128, 64, 64, 2)),
])
def test_layer_plan_at_the_timed_shapes(b, t, e, f, want):
    plan = enc.layer_plan(b, t, e, f, e // 64, one_block_an_sm, H100_SMS)
    got = (plan.qkv_rows, plan.qkv_blocks, plan.post_rows, plan.tiles, plan.cs)
    assert got == want
    assert plan.scratch == 4 * b * t * e  # q, k, v, att: no [B*T, F] buffer
    assert plan.post_blocks == plan.tiles * plan.cs


@pytest.mark.parametrize("e,rows", [(128, 64), (256, 64), (384, 32), (512, 32),
                                    (640, 16), (896, 16), (1024, 16)])
def test_tile_rows_hold_64_kb_of_f32_rows(e, rows):
    assert enc.tile_rows(e) == rows
    assert rows * e <= enc.TILE_FLOATS
    assert rows == enc.TILE_ROWS[0] or 2 * rows * e > enc.TILE_FLOATS


@pytest.mark.parametrize("m", [1, 16, 100, 2048, 4096, 4224, 32768])
@pytest.mark.parametrize("e", [256, 512])
def test_qkv_rows_cover_the_card_in_one_wave(m, e):
    """The QKV tile is the widest, halved only while twice its blocks
    still fit one wave."""
    plan = enc.layer_plan(m, 1, e, 1536, 8, one_block_an_sm, H100_SMS)
    assert plan.qkv_rows in enc.TILE_ROWS and plan.qkv_rows <= enc.tile_rows(e)
    assert plan.qkv_blocks == -(-m // plan.qkv_rows)
    if plan.qkv_rows < enc.tile_rows(e):
        assert plan.qkv_blocks <= H100_SMS
    if plan.qkv_rows > enc.TILE_ROWS[-1]:
        assert -(-m // (plan.qkv_rows // 2)) > H100_SMS


@pytest.mark.parametrize("fits,want", [({16, 8, 4, 2, 1}, 16), ({4, 2, 1}, 4), ({1}, 1)])
def test_layer_plan_cluster_halves_to_what_the_card_holds(fits, want):
    asked = []

    def capacity(rows, cs, e):
        asked.append((rows, cs, e))
        return 5 if cs in fits else 0

    plan = enc.layer_plan(1, 64, 256, 1536, 8, capacity, H100_SMS)
    assert plan.cs == want
    assert asked == [(64, cs, 256) for cs in (16, 8, 4, 2, 1) if cs >= want]


def test_layer_plan_needs_every_tile_cluster_at_once():
    """A second wave of clusters would double the time: the size halves
    until all tiles' clusters fit, one block a tile needing only one."""
    plan = enc.layer_plan(64, 64, 256, 1536, 8, lambda rows, cs, e: 63 if cs == 2 else 1,
                          H100_SMS)
    assert plan.cs == 1


@pytest.mark.parametrize("cs", [1, 2, 4, 8, 16])
def test_layer_plan_takes_a_forced_cluster(cs):
    plan = enc.layer_plan(512, 64, 256, 1536, 8, one_block_an_sm, H100_SMS, _cluster=cs)
    assert plan.cs == cs


def test_layer_plan_raises_on_a_forced_cluster_the_card_cannot_hold():
    with pytest.raises(RuntimeError, match="cluster of 8 blocks"):
        enc.layer_plan(1, 64, 256, 1536, 8, lambda rows, cs, e: 0, H100_SMS, _cluster=8)


@pytest.mark.parametrize("b,t,e,f,heads,cluster,match", [
    (2, 0, 256, 1536, 8, None, "T=0"),
    (2, 257, 256, 1536, 8, None, "T=257"),
    (2, 16, 192, 1536, 4, None, "E=192"),
    (2, 16, 1152, 1536, 18, None, "E=1152"),
    (2, 16, 256, 1536, 2, None, "head dim 128"),
    (2, 16, 256, 1536, 6, None, "head dim 42"),
    (2, 16, 256, 0, 8, None, "F=0"),
    (2, 16, 256, 1000, 8, 2, "cluster of 2"),
    (2, 16, 256, 1536, 8, 3, "cluster of 3"),
    (2, 16, 256, 1552, 8, 2, "cluster of 2"),
    (2, 16, 256, 1536, 8, 32, "cluster of 32"),
])
def test_layer_plan_refuses(b, t, e, f, heads, cluster, match):
    with pytest.raises(ValueError, match=match):
        enc.layer_plan(b, t, e, f, heads, one_block_an_sm, H100_SMS, _cluster=cluster)


def _layer(emb=128, ffn=192, seed=0):
    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=seed)), config)
    return params_from_numpy(host, "cpu")["encoder"][0]


@pytest.mark.parametrize("t,e,ffn,heads,k_major,match", [
    (16, 128, 192, 4, True, "CUDA"), (300, 128, 192, 4, True, "T=300"),
    (16, 128, 192, 1, True, "head dim 128"), (16, 128, 200, 4, False, "K-major")])
def test_layer_kernel_refuses_before_any_launch(no_build, t, e, ffn, heads, k_major, match):
    layer = _layer(e, ffn)
    if k_major:
        enc.add_k_major(layer)
    x = torch.zeros((2, t, e))
    with pytest.raises(ValueError, match=match):
        enc.layer_kernel(x, layer, torch.zeros((2, 1, 1, t)), heads)


@pytest.mark.parametrize("b,t,e,heads,match", [
    (0, 16, 256, 8, "empty batch"), (2, 0, 256, 8, "empty batch"),
    (2, 16, 64, 8, "E=64"), (2, 16, 320, 8, "E=320"),
    (2, 16, 256, 3, "head dim 85"), (2, 16, 512, 1, "head dim 512"),
    (2, 16, 256, 64, "head dim 4"), (2, 16, 256, 8, "CUDA")])
@pytest.mark.parametrize("kernel", [None, "warp"])
def test_decode_attention_kernel_refuses_before_any_launch(no_build, b, t, e, heads, match,
                                                           kernel):
    q = torch.zeros((b, e))
    k = torch.zeros((b, t, e), dtype=torch.int16)
    scales = torch.ones((b, t))
    with pytest.raises(ValueError, match=match):
        decode_attn.decode_attention_kernel(q, k, k, scales, scales, scales, heads,
                                            _kernel=kernel)


def test_decode_attention_kernel_refuses_an_unknown_kernel(no_build):
    q = torch.zeros((2, 256))
    k = torch.zeros((2, 16, 256), dtype=torch.int16)
    scales = torch.ones((2, 16))
    with pytest.raises(ValueError, match="no kernel 'thread'"):
        decode_attn.decode_attention_kernel(q, k, k, scales, scales, scales, 8,
                                            _kernel="thread")


def ffn_chunked(x1, ffn, chunk, cs):
    """The post-attention kernel's FFN in plain PyTorch: cs equal shares of
    the hidden units, each walked in chunks of `chunk` (the last one
    ragged), each chunk's FFN1, relu and quantization taken alone and its
    share of FFN2 added to int32 partials; the shares' partials summed,
    then the epilogue and the LayerNorm on x1 + y."""
    w1, w2, ln = ffn["w1"], ffn["w2"], ffn["ln"]
    f = w1["q"].shape[1]
    share = f // cs
    xq = qmm.quantize_activations(x1, w1["aq"]).to(torch.int64)
    total = torch.zeros((x1.shape[0], w2["q"].shape[1]), dtype=torch.int64)
    for rank in range(cs):
        part = torch.zeros_like(total)
        for f0 in range(rank * share, (rank + 1) * share, chunk):
            f1 = min(f0 + chunk, (rank + 1) * share)
            acc1 = (xq @ w1["q"][:, f0:f1].to(torch.int64)).to(torch.int32)
            h = torch.relu(acc1.to(torch.float32) * qmm._f32(w1["inv"]) + w1["b"][f0:f1])
            hq = qmm.quantize_activations(h, w2["aq"]).to(torch.int64)
            part += hq @ w2["q"][f0:f1].to(torch.int64)
        total += part
    assert int(total.abs().max()) < 2**31  # the kernel's int32 accumulators
    y = total.to(torch.int32).to(torch.float32) * qmm._f32(w2["inv"]) + w2["b"]
    return enc.layer_norm(y + x1, ln["scale"], ln["bias"])


def _ffn_of_plain_layer(x1, ffn):
    """layer_plain's FFN half: LN(affine(relu(affine(x1, W1)), W2) + x1)."""
    h = qmm.affine_plain(x1, ffn["w1"]["q"], ffn["w1"]["b"], ffn["w1"]["aq"],
                         ffn["w1"]["inv"], qmm.AFFINE_RELU)
    y = qmm.affine_plain(h, ffn["w2"]["q"], ffn["w2"]["b"], ffn["w2"]["aq"], ffn["w2"]["inv"])
    return enc.layer_norm(y + x1, ffn["ln"]["scale"], ffn["ln"]["bias"])


@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("chunk", [16, 64, 128, None], ids=["16", "64", "128", "F"])
@pytest.mark.parametrize("emb,ffn", [(128, 192), (128, 200), (256, 1536)])
def test_ffn_chunks_and_cluster_shares_bit_equal_to_plain(emb, ffn, chunk, cs):
    layer = _layer(emb, ffn, seed=emb + cs)
    x1 = torch.randn((9, emb), generator=torch.Generator().manual_seed(emb)) * 3
    got = ffn_chunked(x1, layer["ffn"], chunk or ffn, cs)
    assert torch.equal(got, _ffn_of_plain_layer(x1, layer["ffn"]))


def test_plain_layer_is_attention_then_the_chunked_ffn():
    """layer_plain = the post-attention kernel's two halves: x1 from the
    SDPA, then the F-chunked FFN (chunks of 128, a cluster of 2)."""
    layer = _layer(128, 192, seed=3)
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, 128), generator=gen)
    mask_add = torch.zeros((2, 1, 1, 5))
    mask_add[1, ..., 3:] = -99999999.0
    att = layer["att"]

    def affine(p, a):
        return qmm.affine_plain(a, p["q"], p["b"], p["aq"], p["inv"])

    x2 = x.reshape(10, 128)
    q, k, v = (affine(att[n], x2).reshape(2, 5, 128) for n in ("q", "k", "v"))
    heads = enc.sdpa_plain(q, k, v, mask_add, 4).reshape(10, 128)
    x1 = enc.layer_norm(x2 + affine(att["o"], heads), att["ln"]["scale"], att["ln"]["bias"])
    want = enc.layer_plain(x, layer, mask_add, 4).reshape(10, 128)
    assert torch.equal(ffn_chunked(x1, layer["ffn"], 128, 2), want)


@pytest.mark.parametrize("emb,ffn,taken", [(128, 192, True), (128, 200, True),
                                            (1152, 192, False)])
def test_layer_gate_sends_what_the_kernel_cannot_tile_to_the_split_layer(
        monkeypatch, emb, ffn, taken):
    """E > MAX_E runs the split layer, never a refusal; any F is taken."""
    layer = _layer(emb, ffn)
    calls = []
    monkeypatch.setattr(enc, "encoder_layer_fused",
                        lambda *args: calls.append(1) or enc.layer_plain(*args))
    x = torch.randn((2, 8, emb), generator=torch.Generator().manual_seed(1))
    mask_add = torch.zeros((2, 1, 1, 8))
    out = tfm.encoder_layer_forward(layer, x, mask_add, 4, fused_layer=True)
    assert bool(calls) == taken
    assert torch.allclose(out, enc.layer_plain(x, layer, mask_add, 4), atol=2e-5)


@pytest.mark.parametrize("e", [128, 256, 1024, 1152, 192, 0])
def test_gate_and_kernel_share_one_width_rule(e):
    """The gate's width test is the one check_layer_shape refuses by."""
    try:
        enc.check_layer_shape(16, e, 512, max(1, e // 64))
        refused = False
    except ValueError as exc:
        refused = f"E={e}" in str(exc)
    assert enc.width_ok(e) != refused


def test_k_major_is_the_transpose_made_once():
    """The layer kernel's weights are read K-major: add_k_major gives each
    of the six matrices its transpose, K zero-padded to a multiple of 16;
    params_from_numpy makes them only on the card."""
    layer = _layer(128, 200)
    assert all("qt" not in layer[g][n] for g, n in enc.MATRICES)
    enc.add_k_major(layer)
    for group, name in enc.MATRICES:
        w, qt = layer[group][name]["q"], layer[group][name]["qt"]
        k, n = w.shape
        assert qt.is_contiguous() and qt.dtype == torch.int8
        assert qt.shape == (n, -(-k // 16) * 16)
        assert torch.equal(qt[:, :k], w.t()) and not qt[:, k:].any()
    assert layer["ffn"]["w2"]["qt"].shape == (128, 208)
