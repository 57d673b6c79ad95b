"""The port's parity tooling (slimt_tpu_torch/crosscheck.py and
slimt_tpu_torch/parity.py) on the CPU.

- Its packages and corpora are byte-equal to scripts/crosscheck.py's.
- On the narrow 2/2/2 cell, 16 serving sentences at B=8, full vocabulary
  and shortlist: the port's tokens equal the JAX script's run_slimt_tpu
  with its encoder run op by op (its jit wrapper swapped for the function
  it wraps: XLA's fused CPU code skips half-precision roundings the JAX
  functions make, which moves the enc=float16 row) for
  the exact, declared and enc=float16 configs, and equal the reference
  harness's for exact and the declared stack (enc=float16 parts from the
  reference on some sentences, as the JAX package's row does).
- crosscheck/reference_tokens.json, which serves a machine where the
  harness cannot start, holds what the harness gives here: the smoke's
  cell is regenerated and compared; with the harness off, run_reference
  reads it, and a leg it lacks raises.
- The partings mode runs; parity.py's oracle and providers modes run
  and pass.

The tests that run the harness skip where it cannot start here.
"""

import importlib.util
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from slimt_tpu_torch import crosscheck as cc  # noqa: E402
from slimt_tpu_torch import parity  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEEDS_HARNESS = pytest.mark.skipif(not cc.harness_runs(),
                                   reason="the reference harness does not start here")
CONFIGS = dict(cc.SERVING_CONFIGS)


@pytest.fixture(scope="module")
def jcc():
    """scripts/crosscheck.py, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "scripts_crosscheck", os.path.join(REPO, "scripts", "crosscheck.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("cell", cc.CELLS + [cc.PEAKED_CELL], ids=lambda c: c[0])
def test_packages_byte_equal(jcc, cell):
    label, enc, dec, heads, emb, ffn, seed = cell
    scale = cc.PEAKED_BIAS_SCALE if label.startswith("STRESS") else None
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        _, port_bytes, port_spm, port_paths = cc.write_package(
            a, enc, dec, heads, emb, ffn, seed, bias_scale=scale)
        _, jax_bytes, jax_spm, jax_paths = jcc.write_package(
            b, enc, dec, heads, emb, ffn, seed, bias_scale=scale)
        assert port_bytes == jax_bytes
        for name in ("model.bin", "vocab.spm", "shortlist.bin"):
            with open(port_paths[name], "rb") as f, open(jax_paths[name], "rb") as g:
                assert f.read() == g.read(), name
        assert cc.zero_logit_bias(port_bytes) == jcc.zero_logit_bias(jax_bytes)
        assert (port_spm.eos_id, port_spm.pad_id) == (jax_spm.eos_id, jax_spm.pad_id)


def test_corpora_equal(jcc):
    assert cc.corpus(48, 0, 102) == jcc.corpus(48, 0, 102)
    assert cc.serving_corpus(256, 0, 302) == jcc.serving_corpus(256, 0, 302)
    assert cc.serving_corpus(64, 0, 302) == cc.serving_corpus(256, 0, 302)[:64]
    assert [label for label, _ in cc.SERVING_CONFIGS] == [
        label for label, _ in jcc.SERVING_CONFIGS]
    for (_, port_opts), (_, jax_opts) in zip(cc.SERVING_CONFIGS, jcc.SERVING_CONFIGS):
        assert port_opts == jax_opts


@pytest.fixture(scope="module")
def narrow_legs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("narrow"))
    return list(cc.serving_legs(tmp, 16, [cc.CELLS[2]]))


@pytest.mark.parametrize("leg", [0, 1], ids=["full-vocab", "shortlist"])
def test_port_tokens_equal_jax_script(jcc, narrow_legs, leg):
    """The exact, declared and enc=float16 configs on one leg (one test,
    so the JAX side compiles its decode loop once for two of them)."""
    from slimt_tpu.io.shortlist import ShortlistGenerator

    leg = narrow_legs[leg]
    gen = None
    if leg.shortlist:
        with open(leg.paths["shortlist.bin"], "rb") as f:
            gen = ShortlistGenerator(f.read(), cc.VOCAB)
    for label in ("exact", "enc=float16", "packedint+int16+noalign"):
        got = cc.run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch, leg.eos,
                          leg.pad, leg.generator if leg.shortlist else None, device="cpu",
                          **CONFIGS[label])
        # The script's jit wrapper swapped for the function it wraps: the
        # encoder runs op by op, the decode loop's body still compiles.
        with pytest.MonkeyPatch.context() as patch:
            patch.setattr(jax, "jit", lambda fn, **_: fn)
            want = jcc.run_slimt_tpu(leg.model_bytes, leg.config, leg.sentences, leg.batch,
                                     leg.eos, leg.pad, gen, **CONFIGS[label])
        assert got == want, label
        assert all(got)


@NEEDS_HARNESS
@pytest.mark.parametrize("label", ["exact", "packedint+int16+noalign"])
@pytest.mark.parametrize("leg", [0, 1], ids=["full-vocab", "shortlist"])
def test_port_tokens_equal_reference(narrow_legs, label, leg):
    leg = narrow_legs[leg]
    ref = cc.run_reference(leg.paths, leg.config, leg.sentences, leg.batch, leg.shortlist)
    got = cc.run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch, leg.eos,
                      leg.pad, leg.generator if leg.shortlist else None, device="cpu",
                      **CONFIGS[label])
    assert got == ref


@NEEDS_HARNESS
def test_recorded_legs_equal_the_harness(tmp_path):
    """The smoke's cell, regenerated with the harness, equals the
    recorded file's legs."""
    legs = cc.recorded_legs()
    assert len(legs) == 30
    for leg in cc.serving_legs(str(tmp_path), cc.SMOKE_LINES, [cc.SMOKE_CELL]):
        args, files, text = cc._harness_call(leg.paths, leg.config, leg.sentences,
                                             leg.batch, leg.shortlist, False)
        key = cc.leg_key(leg.paths, args, files, text)
        assert cc.run_reference(leg.paths, leg.config, leg.sentences, leg.batch,
                                leg.shortlist) == legs[key]


def test_run_reference_reads_the_record_where_the_harness_cannot_start(
        tmp_path, monkeypatch):
    monkeypatch.setattr(cc, "harness_runs", lambda: False)
    leg = next(cc.serving_legs(str(tmp_path), cc.SMOKE_LINES, [cc.SMOKE_CELL]))
    ref = cc.run_reference(leg.paths, leg.config, leg.sentences, leg.batch, leg.shortlist)
    assert len(ref) == cc.SMOKE_LINES and all(ref)
    with pytest.raises(RuntimeError, match="record"):
        cc.run_reference(leg.paths, leg.config, leg.sentences[:8], leg.batch, leg.shortlist)


@NEEDS_HARNESS
def test_partings_mode_runs(capsys):
    assert cc.main(["partings", "--device", "cpu", "--lines", "8"]) == 0
    out = capsys.readouterr().out
    assert out.count("partings") == len(cc.CELLS) + 1


def test_step_logits_and_roundf_oracle(narrow_legs):
    """The partings mode's two probes: step_logits gives each step's plain
    logits, whose first maximum is the port's token at that step, and the
    roundf oracle decodes a sentence to the reference's tokens where its
    rounding is the reference's."""
    leg = narrow_legs[0]
    group = leg.sentences[:leg.batch]
    got = cc.run_port(leg.model_bytes, leg.config, group, leg.batch, leg.eos, leg.pad, None,
                      device="cpu")
    logits = cc.step_logits(leg, group)
    for row, tokens in enumerate(got):
        for step, token in enumerate(tokens):
            assert int(logits[step][row].argmax()) == token
    cap = int(1.5 * max(len(s) for s in group))
    oracle = cc.roundf_decode(leg.model_bytes, leg.config, group[0], leg.eos, cap, None)
    assert oracle and all(0 <= t < cc.VOCAB for t in oracle)


def test_select_configs():
    assert len(cc.select_configs(None)) == 24
    picked = [label for label, _ in cc.select_configs("enc=float16,kv=bfloat16")]
    assert picked == ["exact", "kv=bfloat16", "enc=float16"]


def test_parity_oracle_and_providers_pass(capsys):
    assert parity.main(["oracle", "--device", "cpu", "--lines", "6"]) == 0
    assert parity.main(["providers", "--device", "cpu", "--lines", "6"]) == 0
    out = capsys.readouterr().out
    assert "oracle agreement: 6/6" in out
    assert "xla_int8 vs pallas): 6/6" in out and "f32 dequantized" in out
