"""The order the projection argmax kernel (#4) reduces its vocab tiles by,
and its scratch, on the CPU.

The kernel combines the tiles' bests by one max over 64-bit keys, in any
order; `logits_argmax.exact_key` is the plain model of its exact key (the
order-preserving bits of the logit above, the reversed column below).
Its largest key must name jnp.argmax's first maximum (`first_max`),
whatever the ties, signs and zeros. The kernel's scratch is sized by one
C entry, which both wrappers (the argmax and the whole step's projection
stage) ask. The kernel itself runs on the card only
(tests/test_torch_gpu.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch.ops import _build  # noqa: E402
from slimt_tpu_torch.ops import decoder_step as dstep  # noqa: E402
from slimt_tpu_torch.ops import logits_argmax  # noqa: E402


def _column(logits: torch.Tensor) -> torch.Tensor:
    """The column the largest exact key names."""
    best = logits_argmax.exact_key(logits).amax(-1)
    return (0xFFFFFFFF - (best & 0xFFFFFFFF)).to(torch.int32)


ROWS = {
    "ties": [1.5, -2.0, 1.5, 1.5, 0.25],
    "negatives": [-3.0, -0.5, -7.25, -0.5, -1e-30],
    "zeros": [-0.0, 0.0, -0.0, -1.0, -2.0],
    "signed zeros last": [-5.0, -1.0, -0.0, 0.0, -0.0],
    "tiny": [-1e-38, 1e-45, -1e-45, 1e-45, 0.0],
    "infinities": [-np.inf, -np.inf, np.inf, 3.0, np.inf],
    "all minus infinity": [-np.inf] * 5,
    "extremes": [-3.4e38, 3.4e38, 1.0, 3.4e38, -0.0],
}


@pytest.mark.parametrize("row", list(ROWS), ids=list(ROWS))
def test_exact_key_names_the_first_maximum(row):
    logits = torch.tensor([ROWS[row]], dtype=torch.float32)
    assert _column(logits).tolist() == logits_argmax.first_max(logits).tolist()


@pytest.mark.parametrize("seed", range(4))
def test_exact_key_orders_like_first_max_on_random_ties(seed):
    """Logits from a few values (many ties, both signs, both zeros), the
    keys reduced in a shuffled order of tiles: the same first maximum."""
    rng = np.random.default_rng(seed)
    values = np.array([-2.5, -0.0, 0.0, 0.75, 3.0, -1e-20], np.float32)
    logits = torch.from_numpy(values[rng.integers(0, len(values), (16, 700))])
    keys = logits_argmax.exact_key(logits)
    tiles = list(torch.split(keys, 128, dim=-1))
    order = rng.permutation(len(tiles))
    best = torch.stack([tiles[i].amax(-1) for i in order], -1).amax(-1)
    got = (0xFFFFFFFF - (best & 0xFFFFFFFF)).to(torch.int32)
    assert torch.equal(got, logits_argmax.first_max(logits))


def test_exact_key_treats_the_two_zeros_alike():
    keys = logits_argmax.exact_key(torch.tensor([[-0.0, 0.0]]))
    assert int(keys[0, 0]) - int(keys[0, 1]) == 1  # the value's bits equal, columns 0 and 1


@pytest.fixture
def scratch_entry(monkeypatch):
    """A library whose slimt_argmax_scratch records what it is asked."""
    asked = []

    class Library:
        def slimt_argmax_scratch(self, b, s):
            asked.append((b, s))
            return 2 * b * -(-s // 128)

    monkeypatch.setattr(_build, "library", Library)
    return asked


@pytest.mark.parametrize("b,s", [(1, 32000), (64, 1024), (512, 3072), (3, 5000)])
def test_argmax_scratch_asks_the_c_entry(scratch_entry, b, s):
    assert logits_argmax.argmax_scratch(b, s) == 2 * b * -(-s // 128)
    assert scratch_entry == [(b, s)]


def test_the_step_sizes_its_projection_scratch_by_the_same_entry():
    assert dstep.argmax_scratch is logits_argmax.argmax_scratch
    assert "slimt_argmax_scratch" in _build._SIGNATURES
