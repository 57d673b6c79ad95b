"""The projection argmax kernel's (#4) packed_int mode, on the CPU.

The declared argmax method keys the int32 sums acc = q8(y) W plus the
bias in accumulator units: (((acc + b_i32) >> shift) << width_bits) |
(mask - col), one int32 max (`logits_argmax.packed_int_argmax`). The
kernel carries that int32 key, its sign bit flipped, above the reversed
32-bit column in its unsigned 64-bit key and reduces the keys of its
128-column tiles in any order; `logits_argmax.packed_int_key` is the plain
model of that key. Its largest key, over any order of tiles, must name
packed_int_argmax's choice. `packed_int_keys` is the one Python copy of
the int32 key, which the mesh's vocab shards use too. The wrapper takes
the int32 bias in the f32 bias's place, reads the packing from
`packed_int_params` alone and refuses what the kernel cannot take before
it builds anything. The kernel itself runs on the card only
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import _build, launches, logits_argmax, qmm  # noqa: E402

TILE = 128  # columns of a projection tile (csrc/logits_argmax.cu kTileCols)


def _cap(e: int) -> int:
    return e * 127 * 127  # packed_int_bias's clamp, and |acc|'s bound


def _case(width: int, e: int, seed: int, rows: int = 6):
    """(acc, b_i32) as the declared path makes them: sums within the
    accumulator bound, biases of both signs with some at the clamp, and
    planted ties across tiles."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-_cap(e), _cap(e) + 1, (rows, width)).astype(np.int32)
    b = rng.integers(-_cap(e) // 50, _cap(e) // 50, width).astype(np.int32)
    b[rng.integers(0, width, 4)] = -_cap(e)
    b[rng.integers(0, width, 4)] = _cap(e)
    first, later = 5 % width, width - 1  # in the first and the (partial) last tile
    for r in range(min(2, rows)):  # the row's maximum at two columns: the first wins
        top = int((acc[r].astype(np.int64) + b).max())
        acc[r, first] = top - b[first]
        acc[r, later] = top - b[later]
    acc[2 % rows] = -_cap(e)  # every sum at the bottom: the bias alone decides
    return torch.from_numpy(acc), torch.from_numpy(b)


def _tiles_reduced(keys: torch.Tensor, rng) -> torch.Tensor:
    """The row's largest key, taken tile by tile (the last tile partial)
    in a shuffled order, as the kernel's blocks meet in any order."""
    tiles = list(torch.split(keys, TILE, dim=-1))
    order = rng.permutation(len(tiles))
    return torch.stack([tiles[i].amax(-1) for i in order], -1).amax(-1)


@pytest.mark.parametrize("e", [32, 256, 512])
@pytest.mark.parametrize("width", [1000, 1024, 3072, 32000])
def test_packed_int_key_over_shuffled_tiles_names_the_chain_choice(width, e):
    acc, b = _case(width, e, seed=width + e)
    width_bits, shift = logits_argmax.packed_int_params(width, e)
    keys = logits_argmax.packed_int_key(acc, b, width_bits, shift)
    best = _tiles_reduced(keys, np.random.default_rng(e))
    want = logits_argmax.packed_int_argmax(acc, b, width_bits, shift)
    assert torch.equal(logits_argmax.key_column(best, "packed_int"), want)
    assert want[:2].tolist() == [5 % width, 5 % width]


@pytest.mark.parametrize("width,e", [(1000, 32), (1024, 256), (32000, 512)])
def test_packed_int_key_is_the_kernels_unsigned_key(width, e):
    """packed_int_key + 2^63 is the kernel's unsigned key: the int32 key
    with its sign bit flipped above, 0xFFFFFFFF - col below; its int64
    order is the unsigned order."""
    acc, b = _case(width, e, seed=7)
    width_bits, shift = logits_argmax.packed_int_params(width, e)
    v = (acc.numpy().astype(np.int64) + b.numpy()) >> shift
    mask = (1 << width_bits) - 1
    key32 = ((v << width_bits) | (mask - np.arange(width))).astype(np.int32)
    hi = key32.view(np.uint32) ^ np.uint32(0x80000000)
    unsigned = hi.astype(np.uint64) << np.uint64(32) | (
        np.uint64(0xFFFFFFFF) - np.arange(width, dtype=np.uint64))
    got = logits_argmax.packed_int_key(acc, b, width_bits, shift).numpy()
    np.testing.assert_array_equal(got.view(np.uint64) ^ np.uint64(1 << 63), unsigned)
    np.testing.assert_array_equal(got.argmax(-1), unsigned.argmax(-1))


@pytest.mark.parametrize("width", [1, 2, 1000, 1024, 1025, 32000, 65536, 1 << 20])
@pytest.mark.parametrize("e", [32, 256, 512, logits_argmax.MAX_EMB])
def test_packed_int_params_extremes_fit_an_int32(width, e):
    """At the accumulator bound, both signs, the packed key neither
    overflows nor loses the order of the shifted value, and the chain's
    choice is the first maximum of floor((acc + b) / 2^shift)."""
    width_bits, shift = logits_argmax.packed_int_params(width, e)
    assert (1 << width_bits) >= width
    bound = 2 * _cap(e)
    for v in (bound >> shift, -(bound >> shift) - 1):
        key = v << width_bits
        assert -2**31 <= key and key | ((1 << width_bits) - 1) < 2**31
    n = min(width, 4096)
    rng = np.random.default_rng(width + e)
    acc = rng.choice([-_cap(e), _cap(e), 0, 1, -1], (3, n)).astype(np.int32)
    b = rng.choice([-_cap(e), _cap(e), 0], n).astype(np.int32)
    got = logits_argmax.packed_int_argmax(torch.from_numpy(acc), torch.from_numpy(b),
                                          width_bits, shift)
    value = (acc.astype(np.int64) + b) >> shift
    np.testing.assert_array_equal(got.numpy(), value.argmax(-1))


def _projection(e: int, s: int, seed: int, shortlist: bool):
    """(y, W, b_i32) as output_argmax gets them: W a transposed view of
    int8 embedding rows (or of a shortlist's rows)."""
    gen = torch.Generator().manual_seed(seed)
    emb = torch.randint(-127, 128, (2 * s, e), dtype=torch.int8, generator=gen)
    rows = emb.index_select(0, torch.arange(1, 2 * s, 2)) if shortlist else emb[:s]
    w = rows.T
    y = torch.randn((5, e), generator=gen) * 2.0
    b_i32 = torch.randint(-_cap(e), _cap(e) + 1, (s,), dtype=torch.int32, generator=gen)
    return y, w, b_i32


@pytest.mark.parametrize("shortlist", [False, True], ids=["full", "shortlist"])
@pytest.mark.parametrize("e,s", [(32, 1000), (256, 3072), (512, 1024)])
def test_argmax_affine_packed_int_on_cpu_is_the_chain(e, s, shortlist):
    y, w, b_i32 = _projection(e, s, seed=e + s, shortlist=shortlist)
    width_bits, shift = logits_argmax.packed_int_params(s, e)
    want = logits_argmax.packed_int_argmax(qmm.int8_matmul(y, w, 20.0), b_i32, width_bits,
                                           shift)
    got = logits_argmax.argmax_affine(y, w, b_i32, 20.0, None, "packed_int")
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_packed_int_is_read_from_one_place(monkeypatch):
    """The packing and the key live in ops/logits_argmax alone: the model
    keeps no copy, and the wrapper takes its packing from
    packed_int_params."""
    for name in ("packed_int_argmax", "packed_int_params", "packed_int_keys"):
        assert not hasattr(tfm, name)
    asked = []
    real = logits_argmax.packed_int_params
    monkeypatch.setattr(logits_argmax, "packed_int_params",
                        lambda width, e: asked.append((width, e)) or real(width, e))
    y, w, b_i32 = _projection(64, 700, seed=3, shortlist=False)
    logits_argmax.argmax_affine(y, w, b_i32, 20.0, None, "packed_int")
    assert asked == [(700, 64)]


@pytest.mark.parametrize("col0", [0, 5, 1000])
def test_packed_int_keys_of_a_shard_are_the_whole_width_keys(col0):
    """packed_int_keys of a vocab shard's columns col0 .. col0 + S - 1,
    at the whole width's packing, are the whole width's keys of those
    columns, and packed_int_column reads the global column back."""
    acc, b = _case(3072, 256, seed=col0)
    width_bits, shift = logits_argmax.packed_int_params(3072, 256)
    whole = logits_argmax.packed_int_keys(acc, b, width_bits, shift)[0]
    part, col = logits_argmax.packed_int_keys(acc[:, col0:col0 + 700], b[col0:col0 + 700],
                                              width_bits, shift, col0)
    assert torch.equal(part, whole[:, col0:col0 + 700])
    assert torch.equal(col, torch.arange(col0, col0 + 700, dtype=torch.int32))
    best = part.amax(-1)
    assert torch.equal(logits_argmax.packed_int_column(best, width_bits),
                       col0 + part.argmax(-1).to(torch.int32))


def test_packed_int_is_a_serving_counter():
    assert launches.SERVING["argmax_packed_int"] == ("logits_argmax", "argmax_packed_int_kernel")
    wrapper = launches.serving_wrappers()["argmax_packed_int"]
    assert wrapper is logits_argmax.argmax_packed_int_kernel
    assert "slimt_argmax_packed_int" in _build._SIGNATURES
    assert logits_argmax.METHODS.index("packed_int") == 3  # ArgmaxMode kArgmaxPackedInt
    assert "packed_int" not in logits_argmax.LOGIT_METHODS


@pytest.fixture
def no_build(monkeypatch):
    def library():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(_build, "library", library)


def _refusals():
    e, s = 64, 700
    w = torch.zeros((e, s), dtype=torch.int8)
    wide = torch.zeros((e, 1), dtype=torch.int8).expand(e, (1 << 30) + 1)
    wide_b = torch.zeros((1,), dtype=torch.int32).expand((1 << 30) + 1)
    return {
        "missing": (w, None, "b_i32"),
        "not contiguous": (w, torch.zeros(2 * s, dtype=torch.int32)[::2], "b_i32"),
        "float": (w, torch.zeros(s), "b_i32"),
        "int64": (w, torch.zeros(s, dtype=torch.int64), "b_i32"),
        "short": (w, torch.zeros(s - 1, dtype=torch.int32), "b_i32"),
        "two rows": (w, torch.zeros((1, s), dtype=torch.int32), "b_i32"),
        "past the int32 budget": (wide, wide_b, "exceed an int32"),
    }


@pytest.mark.parametrize("case", list(_refusals()))
def test_packed_int_refusals_raise_before_any_build(no_build, case):
    w, b_i32, match = _refusals()[case]
    y = torch.zeros((2, w.shape[0]))
    for call in (
        lambda: logits_argmax.argmax_packed_int_kernel(y, w, b_i32, 20.0),
        lambda: logits_argmax.argmax_affine_kernel(y, w, b_i32, 20.0, None, "packed_int"),
        lambda: logits_argmax.argmax_affine(y, w, b_i32, 20.0, None, "packed_int"),
    ):
        with pytest.raises(ValueError, match=match):
            call()


def test_the_key_variant_refuses_packed_int(no_build):
    y = torch.zeros((2, 64))
    w = torch.zeros((64, 100), dtype=torch.int8)
    with pytest.raises(ValueError, match="key variant"):
        logits_argmax.argmax_keys_kernel(y, w, torch.zeros(100), 20.0, 1.0, "packed_int")


@pytest.mark.parametrize("method", logits_argmax.LOGIT_METHODS)
@pytest.mark.parametrize("bias", ["missing", "int32", "short"])
def test_the_logit_methods_need_the_f32_bias(no_build, method, bias):
    """Every f32-logit method refuses a missing or wrong bias as a
    ValueError before any build; only packed_int takes the int32 one."""
    y = torch.zeros((2, 64))
    w = torch.zeros((64, 100), dtype=torch.int8)
    b = {"missing": None, "int32": torch.zeros(100, dtype=torch.int32),
         "short": torch.zeros(99)}[bias]
    with pytest.raises(ValueError, match="float32"):
        logits_argmax.argmax_affine_kernel(y, w, b, 20.0, 1.0, method)
