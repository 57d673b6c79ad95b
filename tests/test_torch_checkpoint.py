"""Native .npz checkpoints in the port (io/loader.stack_layers and
unstack_layers, io/checkpoint.py, Model on an .npz) against the JAX
package: each package reads the other's files to equal arrays, and a
checkpoint written by the JAX convert_marian serves the tokens of its
marian .bin through the port's Model on the CPU.
"""

import io

import numpy as np
import pytest

pytest.importorskip("torch")

from slimt_tpu.io import checkpoint as jcheckpoint  # noqa: E402
from slimt_tpu.io import loader as jloader  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.models.model import Package as JaxPackage  # noqa: E402
from slimt_tpu_torch import Model, ModelConfig, Package  # noqa: E402
from slimt_tpu_torch.io import checkpoint, load_items  # noqa: E402
from slimt_tpu_torch.io.loader import load_weights, stack_layers, unstack_layers  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
SEGMENTS = [[5, 9, 4, 0], [3, 8, 6, 2, 11, 12, 0], [7, 0], [4, 4, 9, 13, 21, 8, 6, 30, 2, 0]]


@pytest.fixture(scope="module")
def package():
    return make_package(with_shortlist=True)


@pytest.fixture(scope="module")
def params(package):
    return load_weights(load_items(package.model), CONFIG)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, f"{path}/{key}")
    elif isinstance(tree, list):
        for i, value in enumerate(tree):
            yield from _leaves(value, f"{path}/{i}")
    else:
        yield path, tree


def _assert_trees_equal(got, want, types=True):
    got_leaves, want_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for path, value in want_leaves.items():
        other = got_leaves[path]
        if types:
            assert type(other) is type(value), path
        assert np.asarray(other).dtype == np.asarray(value).dtype, path
        np.testing.assert_array_equal(np.asarray(other), np.asarray(value), err_msg=path)


@pytest.mark.parametrize("decoder", [True, False], ids=["both", "encoder_only"])
def test_unstack_inverts_stack_with_scale_types_kept(params, decoder):
    stacked = stack_layers(params, decoder=decoder)
    assert stacked["encoder"]["att"]["q"]["aq"].shape == (2,)
    assert isinstance(stacked["decoder"], dict) is decoder
    restored = unstack_layers(stacked)
    # Every leaf of the marian path, scales as np.float32 scalars
    # (io/params.py's `inv` needs their bits), arrays as arrays.
    _assert_trees_equal(restored, params)
    scale = restored["decoder"][1]["rnn"]["wf"]["aq"]
    assert type(scale) is np.float32
    assert scale.tobytes() == params["decoder"][1]["rnn"]["wf"]["aq"].tobytes()


def test_stack_layers_equals_the_jax_function(params):
    _assert_trees_equal(stack_layers(params), jloader.stack_layers(params), types=False)
    _assert_trees_equal(stack_layers(params, decoder=False),
                        jloader.stack_layers(params, decoder=False), types=False)


def test_save_load_native_round_trip(params):
    buffer = io.BytesIO()
    meta = {"vocab_size": 7, "emb_dim": 32}
    checkpoint.save_native(buffer, stack_layers(params), meta=meta)
    blob = buffer.getvalue()
    assert checkpoint.is_native(blob)
    loaded, got_meta = checkpoint.load_native(io.BytesIO(blob))
    assert got_meta == meta
    _assert_trees_equal(loaded, stack_layers(params), types=False)
    with pytest.raises(ValueError, match="stacked"):
        checkpoint.save_native(io.BytesIO(), params)


def test_each_package_loads_the_others_npz(package, params):
    port_blob = checkpoint.convert_marian(package.model, CONFIG)
    jax_blob = jcheckpoint.convert_marian(package.model, TINY_TEST_CONFIG)
    for blob in (port_blob, jax_blob):
        for load in (checkpoint.load_native, jcheckpoint.load_native):
            tree, meta = load(io.BytesIO(blob))
            _assert_trees_equal(tree, stack_layers(params), types=False)
            assert meta == {"vocab_size": params["emb"]["q"].shape[0], "emb_dim": 32,
                            "ffn_dim": 64, "encoder_layers": 2, "decoder_layers": 2,
                            "num_heads": 4}
    # The port's flatten and unflatten are the JAX package's.
    flat = checkpoint._flatten(stack_layers(params))
    assert flat.keys() == jcheckpoint._flatten(jloader.stack_layers(params)).keys()
    _assert_trees_equal(checkpoint._unflatten(flat), jcheckpoint._unflatten(flat))


@pytest.mark.parametrize("shortlist", [False, True], ids=["full", "shortlist"])
def test_jax_checkpoint_serves_the_tokens_of_its_bin(package, shortlist):
    npz = jcheckpoint.convert_marian(package.model, TINY_TEST_CONFIG)
    words = package.shortlist if shortlist else None
    on_bin = Model(CONFIG, Package(package.model, package.vocabulary, words), device="cpu")
    on_npz = Model(CONFIG, Package(npz, package.vocabulary, words), device="cpu")
    assert (on_npz.vocab_size, on_npz.emb_dim, on_npz.ffn_dim) == (
        on_bin.vocab_size, on_bin.emb_dim, on_bin.ffn_dim)
    jax_model = JaxModel(TINY_TEST_CONFIG, JaxPackage(npz, package.vocabulary, words))
    for aligned in (False, True):
        want = [h.target for h in on_bin.forward(SEGMENTS, need_alignment=aligned)]
        assert [h.target for h in on_npz.forward(SEGMENTS, need_alignment=aligned)] == want
        assert [h.target for h in jax_model.forward(SEGMENTS, need_alignment=aligned)] == want
    assert any(len(t) > 1 for t in want)
    # Every weight and epilogue multiplier (`inv`) of the two loads.
    _assert_trees_equal(on_npz.params, on_bin.params, types=False)
