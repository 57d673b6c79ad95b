"""The port's Model (slimt_tpu_torch/models/model.py) against the JAX
Model on tests/helpers.make_package packages: forward, forward_async
(raw), forward_async_arrays and the runtime's Blocking service give
the same tokens, for inputs past 256 tokens too. Also: the default device
is the card, and "cuda" without one raises; qmm_provider="f32", both
encoder_dtype values and every kv_cache_dtype serve; and importing the port and
serving through its own Blocking loads neither jax nor anything of the
JAX package (nor regex on import).
"""

import contextlib
import dataclasses
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu.config import Config  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.runtime.service import Blocking  # noqa: E402
from slimt_tpu_torch import Model, Package  # noqa: E402
from tests.helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

SEGMENTS = [[5, 9, 4, 0], [7, 2, 0], [3, 8, 6, 2, 11, 12, 0], [4, 0]]
LINES = ["hello world", "the quick brown fox", "a b c", "dog"]


def _pair(with_shortlist):
    config = dataclasses.replace(TINY_TEST_CONFIG)
    pkg = make_package(config=config, with_shortlist=with_shortlist)
    port_pkg = Package(pkg.model, pkg.vocabulary, pkg.shortlist, pkg.ssplit)
    return JaxModel(config, pkg), Model(config, port_pkg, device="cpu")


@pytest.fixture(scope="module", params=[False, True], ids=["full", "shortlist"])
def models(request):
    return _pair(request.param)


def test_forward_matches_jax(models):
    jax_model, port = models
    for need_alignment in (False, True):
        want = jax_model.forward(SEGMENTS, need_alignment)
        got = port.forward(SEGMENTS, need_alignment)
        assert [h.target for h in got] == [h.target for h in want]
        for g, w in zip(got, want):
            assert len(g.alignment) == len(w.alignment)
            if w.alignment:
                np.testing.assert_allclose(
                    np.asarray(g.alignment), np.asarray(w.alignment),
                    atol=1e-5, rtol=0,
                )


def test_forward_async_raw_and_arrays_match_jax(models):
    jax_model, port = models
    finishes = [port.forward_async(SEGMENTS, False, raw=True) for _ in range(2)]
    w_tokens, w_steps, w_align = jax_model.forward_async(
        SEGMENTS, False, raw=True
    )()
    for finish in finishes:
        tokens, steps, align = finish()
        assert align is None and w_align is None
        np.testing.assert_array_equal(steps, w_steps)
        np.testing.assert_array_equal(tokens, w_tokens)

    b_pad, t_pad = 4, 16
    indices = np.zeros((b_pad, t_pad), np.int32)
    mask = np.zeros((b_pad, t_pad), np.float32)
    for i, seg in enumerate(SEGMENTS):
        indices[i, : len(seg)] = seg
        mask[i, : len(seg)] = 1.0
    lengths = np.array([len(s) for s in SEGMENTS])
    words = np.concatenate([np.asarray(s) for s in SEGMENTS])
    args = (indices, mask, lengths, len(SEGMENTS))
    kwargs = dict(shortlist_words=words, raw=True)
    got = port.forward_async_arrays(*args, **kwargs)()
    want = jax_model.forward_async_arrays(*args, **kwargs)()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    snap, want_snap = (
        m.shortlist_meter.snapshot() for m in (port, jax_model)
    )
    for key in ("avg_generated_width", "avg_padded_width"):
        assert snap.get(key) == want_snap.get(key)


def test_blocking_service_matches_jax(models):
    jax_model, port = models
    with Blocking(Config()) as service:
        want = service.translate(jax_model, LINES)
        got = service.translate(port, LINES)
    assert [r.target.text for r in got] == [r.target.text for r in want]


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    pkg = make_package()
    with pytest.raises(RuntimeError, match="cuda"):
        Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cuda")


def test_default_device_is_the_card():
    """Model(config, package) runs on the card; without one it raises as
    "cuda" does, and the CPU stays an explicit choice."""
    pkg = make_package()
    package = Package(pkg.model, pkg.vocabulary)
    if torch.cuda.is_available():
        assert Model(TINY_TEST_CONFIG, package).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        Model(TINY_TEST_CONFIG, package)
    assert Model(TINY_TEST_CONFIG, package, device="cpu").device.type == "cpu"


@pytest.mark.parametrize(
    "change",
    [
        {"kv_cache_dtype": "int8"},
        {"qmm_provider": "fused", "kv_cache_dtype": "int8"},
        {"qmm_provider": "f32"},
        {"encoder_dtype": "float16"},
        {"kv_cache_dtype": "float16"},
        {"kv_cache_dtype": "bfloat16"},
        {"encoder_dtype": "bfloat16"},
        {"kv_cache_dtype": "k8v16"},
    ],
)
def test_once_unported_configs_serve_the_jax_tokens(change):
    """Every value here once raised: qmm_provider="f32", encoder_dtype and
    the kv_cache_dtypes now serve with the JAX Model's tokens. The
    encoder_dtype cases hold the port to the JAX Model run op by op
    (jax.disable_jit): XLA's fused CPU code skips half-precision roundings
    the JAX functions make (tests/test_torch_numerics_knobs.py)."""
    import jax

    config = dataclasses.replace(TINY_TEST_CONFIG, **change)
    pkg = make_package()
    port = Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")
    op_by_op = jax.disable_jit() if "encoder_dtype" in change else contextlib.nullcontext()
    with op_by_op:
        want = JaxModel(config, pkg).forward(SEGMENTS, need_alignment=False)
    assert [h.target for h in port.forward(SEGMENTS, need_alignment=False)] == [
        h.target for h in want]


@pytest.mark.parametrize(
    "change",
    [{"encoder_layer_kernel": "off"}, {"encoder_sdpa": "on"},
     {"encoder_sdpa": "auto"}, {"flash_attention": True},
     {"flash_attention": False}, {"flash_attention": "auto"}],
)
def test_encoder_config_values_pass(change):
    config = dataclasses.replace(TINY_TEST_CONFIG, **change)
    pkg = make_package()
    Model(config, Package(pkg.model, pkg.vocabulary), device="cpu")


def test_long_input_raises():
    """A 260-token segment (the T=272 bucket) once raised in the port; it
    now serves, past the wrap regime, with the JAX Model's tokens."""
    pkg = make_package()
    cap = dict(tgt_length_limit_factor=0.1)  # 27 decode steps at T=272
    port = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu", **cap)
    segments = [[5 + i % 40 for i in range(260)] + [0], [7, 3, 0]]
    want = JaxModel(TINY_TEST_CONFIG, pkg, **cap).forward(segments, need_alignment=False)
    got = port.forward(segments, need_alignment=False)
    assert [h.target for h in got] == [h.target for h in want]
    assert all(h.target for h in got)


def test_plain_transport_and_warmup_match_compact():
    pkg = make_package()
    plain = Model(
        dataclasses.replace(TINY_TEST_CONFIG, compact_transfer=False),
        Package(pkg.model, pkg.vocabulary), device="cpu",
    )
    compact = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu")
    assert [h.target for h in plain.forward(SEGMENTS)] == [
        h.target for h in compact.forward(SEGMENTS)
    ]
    assert plain.warmup(batch_buckets=(1, 2), seq_buckets=(16,)) == 2


def test_native_checkpoint_serves_the_bin_tokens():
    """A native checkpoint from the JAX package serves the tokens of the
    marian .bin it was converted from."""
    from slimt_tpu.io.checkpoint import convert_marian

    pkg = make_package()
    blob = convert_marian(pkg.model, TINY_TEST_CONFIG)
    on_npz = Model(TINY_TEST_CONFIG, Package(blob, pkg.vocabulary), device="cpu")
    on_bin = Model(TINY_TEST_CONFIG, Package(pkg.model, pkg.vocabulary), device="cpu")
    assert [h.target for h in on_npz.forward(SEGMENTS)] == [
        h.target for h in on_bin.forward(SEGMENTS)]


def test_native_checkpoint_raises():
    """A native checkpoint whose meta lacks the model dims raises."""
    import io

    from slimt_tpu.io.checkpoint import convert_marian, load_native, save_native

    pkg = make_package()
    stacked, _ = load_native(io.BytesIO(convert_marian(pkg.model, TINY_TEST_CONFIG)))
    buffer = io.BytesIO()
    save_native(buffer, stacked, meta={})
    with pytest.raises(KeyError, match="vocab_size"):
        Model(TINY_TEST_CONFIG, Package(buffer.getvalue(), pkg.vocabulary), device="cpu")


def test_import_loads_neither_jax_nor_regex():
    """Importing the port, its front doors, its parity tooling
    (crosscheck.py, parity.py) and its host-path tools (host_path.py,
    fleet.py) included, loads no jax, regex or slimt_tpu module; then a CPU
    Model built from the port's own synthetic package serves through the
    port's own Blocking, on both lanes, its native checkpoint serves the
    same tokens, and parity.py's oracle mode and host_path's two modes
    pass, still with no jax or slimt_tpu module loaded."""
    code = textwrap.dedent(
        """
        import sys

        class Block:
            names = ("jax", "jaxlib", "regex", "slimt_tpu")

            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in self.names:
                    raise ImportError("blocked: " + name)
                return None

        def loaded(names):
            return [m for m in sys.modules if m.split(".")[0] in names]

        block = Block()
        sys.meta_path.insert(0, block)
        import slimt_tpu_torch
        from slimt_tpu_torch.models import continuous, decode, loop_graph, transformer
        from slimt_tpu_torch.ops import (attention, decode_attn, decoder_step,
                                         encoder_layer, fused_blocks,
                                         logits_argmax, qmm)
        # The front doors and the native checkpoints.
        from slimt_tpu_torch import (__main__, bindings, capi, cli, crosscheck,
                                     parity, repository, server, utils)
        from slimt_tpu_torch.io import checkpoint
        from slimt_tpu_torch.ops import _capi_build
        from slimt_tpu_torch.runtime import health, router
        # Multiple devices: the mesh, its collectives, multi-process
        # serving, the pipeline and the entry points.
        from slimt_tpu_torch import entry
        from slimt_tpu_torch.parallel import (collectives, demo, multihost, pipeline,
                                              sharding)
        # The host-path tools: the stubbed device's measurements.
        from slimt_tpu_torch import fleet, host_path
        assert not loaded(block.names), loaded(block.names)

        # Serving splits sentences, and the splitter needs regex.
        block.names = ("jax", "jaxlib", "slimt_tpu")
        from slimt_tpu_torch import Blocking, Config, Model, ModelConfig, Package
        from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
        from slimt_tpu_torch.text import spm_proto
        from slimt_tpu_torch.text.synthetic_vocab import (DEFAULT_WORDS,
                                                          build_spm_model)

        config = ModelConfig(encoder_layers=1, decoder_layers=1, num_heads=4)
        spm = build_spm_model(DEFAULT_WORDS, target_size=64)
        model_bytes = synthetic_model_bytes(config=config, vocab_size=len(spm.pieces),
                                            emb_dim=32, ffn_dim=64, seed=0)
        model = Model(config, Package(model_bytes, spm_proto.serialize_model(spm)),
                      device="cpu")
        for prefer_bulk in (False, True):
            with Blocking(Config(prefer_bulk=prefer_bulk)) as service:
                responses = service.translate(model, ["hello world", "a b c"])
            assert len(responses) == 2 and all(r.target.text for r in responses)
        # A native checkpoint serves the marian model's tokens.
        npz = Model(config, Package(checkpoint.convert_marian(
            model_bytes, config), spm_proto.serialize_model(spm)), device="cpu")
        segment = [[5, 9, 4, 7, 0]]
        assert npz.forward(segment)[0].target == model.forward(segment)[0].target
        assert parity.main(["oracle", "--device", "cpu", "--lines", "2"]) == 0
        # The host path's tools run stubbed, still with neither loaded.
        assert host_path.main(["path", "--device", "cpu", "--lines", "300"]) == 0
        assert host_path.main(["budget", "--device", "cpu", "--lines", "100",
                               "--device-rate", "1"]) == 0
        assert not loaded(block.names), loaded(block.names)
        print("ok")
        """
    )
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "ok"
