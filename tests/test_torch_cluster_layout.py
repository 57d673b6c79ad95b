"""The cluster layout of the layers kernel (#7, #10, #11), the FFN block
(#5) and the SSRU block (#6) on the CPU: the choice of cs and the rows a
tile from the batch, the fit to what a card can schedule, and the
wrappers' refusals, which come before any build or launch. The kernels
themselves run on the card only (tests/test_torch_gpu.py)."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch.config import ModelConfig  # noqa: E402
from slimt_tpu_torch.io import load_items  # noqa: E402
from slimt_tpu_torch.io.loader import load_weights  # noqa: E402
from slimt_tpu_torch.io.params import params_from_numpy  # noqa: E402
from slimt_tpu_torch.io.synthetic import synthetic_model_bytes  # noqa: E402
from slimt_tpu_torch.models import transformer as tfm  # noqa: E402
from slimt_tpu_torch.ops import _build  # noqa: E402
from slimt_tpu_torch.ops import decoder_step as dstep  # noqa: E402
from slimt_tpu_torch.ops import fused_blocks  # noqa: E402

WIDTHS = [(256, 1536), (512, 2048)]
BATCHES = [1, 2, 7, 8, 9, 16, 33, 64, 65, 100, 130, 200, 255, 256, 512, 2048]


@pytest.mark.parametrize("e,f", WIDTHS, ids=["tiny", "base"])
@pytest.mark.parametrize("b", BATCHES)
def test_cluster_layout_splits_the_widths_and_fits_the_card(b, e, f):
    """The size the card is asked for: the largest one whose blocks split
    E and F in multiples of 16 columns, at any B (what the card holds at
    once is `fit_cluster`'s)."""
    cs, rows = fused_blocks.cluster_layout(b, e, f)
    assert cs in fused_blocks.CLUSTER_SIZES
    assert (e // 16) % cs == 0 and (f // 16) % cs == 0
    assert rows == fused_blocks.rows_per_block(b) and 1 <= rows <= 4
    assert all(e % (16 * size) or f % (16 * size)
               for size in fused_blocks.CLUSTER_SIZES if size > cs)
    fused_blocks.check_cluster(cs, e, f)  # a size the kernels take


@pytest.mark.parametrize("b,want", [(1, (16, 1)), (8, (16, 1)), (9, (16, 1)), (64, (16, 1)),
                                    (65, (16, 4)), (130, (16, 4)), (255, (16, 4)),
                                    (256, (16, 4)), (512, (16, 4))])
def test_cluster_layout_at_the_timed_batches(b, want):
    assert fused_blocks.cluster_layout(b, 256, 1536) == want


def test_the_step_and_the_blocks_share_one_chooser():
    assert dstep.cluster_layout is fused_blocks.cluster_layout


@pytest.mark.parametrize("cs,e,f", [(3, 256, 1536), (0, 256, 1536), (32, 512, 2048),
                                    (16, 128, 1536), (16, 256, 1000)])
def test_check_cluster_refuses(cs, e, f):
    with pytest.raises(ValueError, match=f"cluster of {cs} blocks"):
        fused_blocks.check_cluster(cs, e, f)


@pytest.mark.parametrize("fits,want", [({16}, 16), ({8, 4}, 8), ({2}, 2), ({1}, 1)])
def test_fit_cluster_halves_to_what_the_card_schedules(fits, want):
    asked = []

    def capacity(cs):
        asked.append(cs)
        return 3 if cs in fits else 0

    assert fused_blocks.fit_cluster(capacity, 16, 1, "test") == want
    assert asked == [c for c in (16, 8, 4, 2, 1) if c >= want]


@pytest.mark.parametrize("cs", [16, 4, 1])
def test_fit_cluster_raises_on_a_forced_size_or_nothing(cs):
    with pytest.raises(RuntimeError, match=f"cluster of {cs} blocks"):
        fused_blocks.fit_cluster(lambda size: 0, cs, 1, "test", forced=True)
    with pytest.raises(RuntimeError, match="cluster of 1 blocks"):
        fused_blocks.fit_cluster(lambda size: 0, cs, 1, "test")


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if a wrapper reaches the build (and so a launch)."""
    def refuse():
        raise AssertionError("the wrapper reached the kernels' library")
    monkeypatch.setattr(_build, "library", refuse)


def _params(emb=256, ffn=1536):
    config = ModelConfig(encoder_layers=1, decoder_layers=2, num_heads=8)
    host = load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=0)), config)
    return params_from_numpy(host, "cpu")


@pytest.mark.parametrize("m,e,cluster,match", [
    (2, 32, None, "E=32"), (2, 128, None, "E=128"), (1, 256, 3, "cluster of 3"),
    (1, 256, 32, "cluster of 32"), (1, 256, 1, "CUDA"), (1, 256, None, "CUDA")])
def test_ffn_kernel_refuses_before_any_launch(no_build, m, e, cluster, match):
    ffn = _params()["decoder"][0]["ffn"]
    with pytest.raises(ValueError, match=match):
        fused_blocks.ffn_kernel(torch.zeros((m, e)), ffn, _cluster=cluster)


def test_ffn_kernel_refuses_an_ffn_width_before_any_launch(no_build):
    ffn = dict(_params()["decoder"][0]["ffn"])
    ffn["w1"] = dict(ffn["w1"], q=torch.zeros((256, 1000), dtype=torch.int8))
    with pytest.raises(ValueError, match="F=1000"):
        fused_blocks.ffn_kernel(torch.zeros((1, 256)), ffn)


@pytest.mark.parametrize("m,e,cluster,match", [
    (2, 32, None, "E=32"), (2, 128, None, "E=128"), (1, 256, 3, "cluster of 3"),
    (1, 512, 64, "cluster of 64"), (1, 256, 1, "CUDA"), (1, 256, None, "CUDA")])
def test_ssru_kernel_refuses_before_any_launch(no_build, m, e, cluster, match):
    rnn = _params()["decoder"][0]["rnn"]
    with pytest.raises(ValueError, match=match):
        fused_blocks.ssru_kernel(torch.zeros((m, e)), torch.zeros((m, e)), rnn,
                                 _cluster=cluster)


def test_ssru_kernel_refuses_a_state_before_any_launch(no_build, monkeypatch):
    """A state of another shape raises before the layout is asked."""
    rnn = _params()["decoder"][0]["rnn"]
    monkeypatch.setattr(fused_blocks, "_check", lambda *args, **kwargs: None)
    with pytest.raises(ValueError, match="state must be float32"):
        fused_blocks.ssru_kernel(torch.zeros((2, 256)), torch.zeros((3, 256)), rnn)


def _step_args(b=2, t=16, e=256):
    tp = _params()
    caches = tuple({"k": torch.zeros((b, t, e), dtype=torch.int16),
                    "v": torch.zeros((b, t, e), dtype=torch.int16),
                    "kqi": torch.ones((b, t)), "vqi": torch.ones((b, t))} for _ in range(2))
    states = tuple(torch.zeros((b, 1, e)) for _ in range(2))
    return (tp["decoder"], states, torch.zeros((b, 1, e)), torch.zeros((b, 1, 1, t)), caches,
            8, tfm.prepare_output_projection(tp), tp["out"]["aq"], tfm.output_inv(tp))


@pytest.mark.parametrize("cluster,match", [(3, "cluster of 3"), (32, "cluster of 32"),
                                           (16, "CUDA"), (None, "CUDA")])
def test_whole_step_kernel_refuses_before_any_launch(no_build, cluster, match):
    with pytest.raises(ValueError, match=match):
        dstep.whole_step_kernel(*_step_args(), _cluster=cluster)


@pytest.mark.parametrize("heads,match", [(6, "heads=6"), (64, "head dim 4")])
def test_whole_step_kernel_refuses_heads_before_any_launch(no_build, heads, match):
    args = list(_step_args())
    args[5] = heads
    with pytest.raises(ValueError, match=match):
        dstep.whole_step_kernel(*args, _cluster=16)


@pytest.mark.parametrize("split", [True, False], ids=["split", "joined"])
@pytest.mark.parametrize("cluster,match", [(5, "cluster of 5"), (None, "CUDA")])
def test_layer_step_kernels_refuse_before_any_launch(no_build, split, cluster, match):
    layer = _params()["decoder"][0]
    b, t, e = 2, 16, 256
    shape = (b, 8, t, e // 8) if split else (b, t, e)
    kv = (torch.zeros(shape), torch.zeros(shape))
    kernel = dstep.decoder_layer_step_kernel if split else dstep.decoder_layer_step_bte_kernel
    with pytest.raises(ValueError, match=match):
        kernel(layer, torch.zeros((b, 1, e)), torch.zeros((b, 1, e)),
               torch.zeros((b, 1, 1, t)), kv, 8, _cluster=cluster)


def test_step_layout_refuses_a_cluster_before_the_card(no_build):
    with pytest.raises(ValueError, match="cluster of 3"):
        dstep.step_layout(1, 256, 1536, 8, 64, 0, 0, _cluster=3)


# A card that holds, at one block an SM, 7 clusters of 16 blocks at once,
# 15 of 8, 30 of 4, 66 of 2 and 132 single blocks.
CAPACITY = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}


@pytest.mark.parametrize("tiles,want", [(1, 16), (7, 16), (8, 8), (15, 8), (16, 4),
                                        (30, 4), (31, 2), (66, 2), (67, 1), (200, 1)])
def test_fit_cluster_holds_every_tile_at_once(tiles, want):
    """A second wave of clusters would double the step: the size shrinks
    until the card holds one cluster a row tile at once; one block a tile
    needs only to fit."""
    assert fused_blocks.fit_cluster(CAPACITY.get, 16, tiles, "test") == want


def test_fit_cluster_keeps_a_forced_size_that_runs():
    assert fused_blocks.fit_cluster(CAPACITY.get, 16, 100, "test", forced=True) == 16


def _fake_card(monkeypatch, capacity):
    """card_query answered by a card that holds capacity[cs] clusters of cs
    blocks at once and takes the rows asked for; returns the queries."""
    asked = []

    def query(device, entry, *args):
        asked.append((device, entry) + args)
        if entry == "slimt_whole_step_rows":
            return args[0]
        cs = args[1]
        return capacity.get(cs, 0)

    monkeypatch.setattr(fused_blocks, "card_query", query)
    monkeypatch.setattr(dstep, "card_query", query)
    return asked


@pytest.mark.parametrize("b,want", [(1, (16, 1)), (7, (16, 1)), (8, (8, 1)), (30, (4, 1)),
                                    (64, (2, 1)), (130, (2, 4)), (255, (2, 4)),
                                    (264, (2, 4)), (265, (1, 4)), (512, (1, 4)),
                                    (2048, (1, 4))])
def test_layouts_fit_the_card(monkeypatch, b, want):
    """The chooser's size halved to what the card holds, one cluster a
    row tile, for the layers kernel and the FFN block alike: on a card
    that holds one block an SM, one block a tile once the 4-row tiles
    outnumber the clusters of 2 it holds (B > 264). Every query names
    the tensor's card."""
    asked = _fake_card(monkeypatch, CAPACITY)
    assert dstep.step_layout(b, 256, 1536, 8, 64, 0, 1) == want
    assert fused_blocks.ffn_layout(b, 256, 1536, 1) == want
    assert {query[0] for query in asked} == {1}


@pytest.mark.parametrize("e", [256, 512], ids=["tiny", "base"])
@pytest.mark.parametrize("b,want", [(1, (16, 1)), (7, (16, 1)), (8, (8, 1)), (30, (4, 1)),
                                    (64, (2, 1)), (130, (2, 4)), (264, (2, 4)),
                                    (265, (1, 4)), (512, (1, 4))])
def test_ssru_layout_fits_the_card(monkeypatch, e, b, want):
    """The SSRU block asks the one chooser for its two [E, E] products and
    halves the size to what the card holds, one cluster a row tile, by its
    own C entry on the tensor's card."""
    asked = _fake_card(monkeypatch, CAPACITY)
    assert fused_blocks.cluster_layout(b, e, e) == (16, want[1])
    assert fused_blocks.ssru_layout(b, e, 1) == want
    assert {query[:2] for query in asked} == {(1, "slimt_ssru_clusters")}
    assert all(query[2] == want[1] and query[4] == e for query in asked)


@pytest.mark.parametrize("cluster", [16, 8, 2, 1])
def test_ssru_layout_keeps_a_forced_size_that_runs(monkeypatch, cluster):
    _fake_card(monkeypatch, CAPACITY)
    assert fused_blocks.ssru_layout(512, 256, 0, _cluster=cluster) == (cluster, 4)


def test_ssru_layout_raises_on_a_forced_size_the_card_refuses(monkeypatch):
    _fake_card(monkeypatch, {1: 132})
    with pytest.raises(RuntimeError, match="SSRU block: the card cannot schedule a cluster of 4"):
        fused_blocks.ssru_layout(1, 256, 0, _cluster=4)
    assert fused_blocks.ssru_layout(1, 256, 0) == (1, 1)


def test_card_query_asks_the_named_card_once(monkeypatch):
    """The C entries ask the current device: the query runs under the
    named card, and its answer is cached (boundedly) per card and shape."""
    entered = []

    @contextlib.contextmanager
    def device(index):
        entered.append(index)
        yield

    class Library:
        def slimt_ffn_clusters(self, *args):
            return 100 * entered[-1] + args[1]

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_build, "library", Library)
    fused_blocks.card_query.cache_clear()
    try:
        assert fused_blocks.card_query(1, "slimt_ffn_clusters", 1, 16, 256, 1536) == 116
        assert fused_blocks.card_query(1, "slimt_ffn_clusters", 1, 16, 256, 1536) == 116
        assert fused_blocks.card_query(2, "slimt_ffn_clusters", 1, 16, 256, 1536) == 216
        assert entered == [1, 2]
        assert fused_blocks.card_query.cache_info().maxsize is not None
    finally:
        fused_blocks.card_query.cache_clear()


# The widths of the repo's own configurations (crosscheck and parity
# cells, tiny11, base) and a padded one: (E, F, heads, the chooser's cs).
REPO_WIDTHS = [(32, 64, 2, 2), (40, 80, 1, 1), (64, 128, 4, 4), (64, 256, 8, 4),
               (256, 1536, 8, 16), (512, 2048, 8, 16)]


@pytest.mark.parametrize("e,f,heads,cs", REPO_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("b", [1, 64, 65, 512])
def test_cluster_layout_at_every_width(b, e, f, heads, cs):
    """The kernels split E and F rounded up to 16 (E=40 runs at 48, whose
    three 16-column groups take one block a tile)."""
    assert fused_blocks.pad16(e) % 16 == 0 and 0 <= fused_blocks.pad16(e) - e < 16
    assert fused_blocks.cluster_layout(b, e, f) == (cs, fused_blocks.rows_per_block(b))
    assert fused_blocks.cluster_layout(b, e, e)[0] == max(  # the SSRU block's
        size for size in fused_blocks.CLUSTER_SIZES if fused_blocks.pad16(e) % (16 * size) == 0)
    fused_blocks.check_cluster(cs, e, f)
    fused_blocks.check_cluster(1, e, f)
    for bigger in (s for s in fused_blocks.CLUSTER_SIZES if s > cs):
        with pytest.raises(ValueError, match=f"cluster of {bigger} blocks"):
            fused_blocks.check_cluster(bigger, e, f)


@pytest.mark.parametrize("e,f,heads,cs", REPO_WIDTHS, ids=lambda v: str(v))
def test_gates_take_every_width_before_the_card(no_build, e, f, heads, cs):
    """No width gate is left before a launch: at every width the
    wrappers pass their shape checks and stop only at the CPU tensor
    (on the card they launch: tests/test_torch_gpu.py)."""
    dstep.check_shapes(e, f, 64, heads, 2)
    ffn = _params(e, f)["decoder"][0]["ffn"]
    rnn = _params(e, f)["decoder"][0]["rnn"]
    with pytest.raises(ValueError, match="CUDA"):
        fused_blocks.ffn_kernel(torch.zeros((3, e)), ffn, _cluster=cs)
    with pytest.raises(ValueError, match="CUDA"):
        fused_blocks.ssru_kernel(torch.zeros((3, e)), torch.zeros((3, e)), rnn)


@pytest.mark.parametrize("e,heads", [(40, 2), (40, 8), (96, 8), (256, 3)])
def test_check_shapes_keeps_the_head_limits(e, heads):
    with pytest.raises(ValueError, match="whole decode step"):
        dstep.check_shapes(e, 80, 16, heads, 2)


def test_fit_cluster_raises_past_a_blocks_shared_memory():
    """A negative capacity is the bytes a block would need past what it
    may hold: a smaller cluster needs more, so the width is past the
    kernel's limit and raises ValueError at once."""
    asked = []

    def capacity(cs):
        asked.append(cs)
        return -300000

    with pytest.raises(ValueError, match="300000 bytes of shared memory"):
        fused_blocks.fit_cluster(capacity, 16, 1, "test")
    assert asked == [16]
