"""The port's counterpart of tests/test_declared_config.py, on
crosscheck/serving_agreement_torch.json (`python -m
slimt_tpu_torch.crosscheck serving`, run on the card): the port's
ModelConfig declares the JAX package's serving config, the committed
card sweep holds that config's full-stack row at the stated >= 99.0%
bar of tokens and sentences, the exact row at the sweep's own 98% gate,
and the file names the card it ran on, the port's sources and where the
reference's tokens came from."""

import dataclasses
import json
import os

from slimt_tpu.config import ModelConfig as JaxModelConfig
from slimt_tpu_torch.config import ModelConfig
from slimt_tpu_torch.crosscheck import (
    CELLS,
    PEAKED_CELL,
    SERVING_CONFIGS,
    SERVING_OUT,
    source_digest,
)
from slimt_tpu_torch.models.model import FLASH_AUTO_CROSSOVER_T, resolve_flash

JAX_TABLE = os.path.join(os.path.dirname(SERVING_OUT), "serving_agreement.json")


def _table():
    with open(SERVING_OUT) as f:
        return json.load(f)


def test_declared_config_has_committed_card_parity_row():
    config = ModelConfig()
    assert config.kv_cache_dtype == "int16"
    assert config.argmax_method == "packed_int"
    table = _table()["configs"]
    assert "argmax=packed_int" in table
    stack = table["packedint+int16+noalign"]
    assert stack["token_agreement_pct"] >= 99.0
    assert stack["sentence_exact_pct"] >= 99.0
    assert table["exact"]["sentence_exact_pct"] >= 98.0


def test_card_sweep_names_its_device_and_covers_every_row():
    """The whole sweep, from the card: 24 configs x 9 legs x 256 lines
    (the peaked cell's leg outside the aggregate), in the JAX file's
    layout, with the device's name and power limit."""
    report = _table()
    device = report["device"]
    assert device["platform"] == "cuda"
    assert device["kind"] and device["nvidia_smi"].endswith("W")
    assert report["batch"] == 8 and report["lines_per_cell"] == 256
    with open(JAX_TABLE) as f:
        jax_report = json.load(f)
    assert list(report["configs"]) == [label for label, _ in SERVING_CONFIGS]
    assert list(report["configs"]) == list(jax_report["configs"])
    legs = 2 * len(CELLS) + 1
    for label, row in report["configs"].items():
        assert set(row) == set(jax_report["configs"][label]), label
        assert len(row["cells"]) == legs, label
        assert row["sentences"] == 2 * len(CELLS) * 256, label
        assert [c["cell"] for c in row["cells"]].count(PEAKED_CELL[0]) == 1


def test_card_sweep_names_its_sources_and_reference():
    """The sweep records the digest of the port's sources it ran (as
    source_digest computes it: 64 hex digits, the same on every call)
    and whether the reference's tokens came from the harness or from the
    recorded file."""
    report = _table()
    digest = report["port_source_sha256"]
    assert len(digest) == 64 and int(digest, 16) >= 0
    assert source_digest() == source_digest()
    reference = report["reference_tokens"]
    assert reference == "harness" or reference.startswith(
        "recorded: crosscheck/reference_tokens.json (sha256 ")


def test_model_config_defaults_match_the_jax_package():
    """One config object drives either package: the same fields and
    defaults."""
    assert dataclasses.asdict(ModelConfig()) == dataclasses.asdict(JaxModelConfig())


def test_resolve_flash_auto_matches_crossover():
    assert FLASH_AUTO_CROSSOVER_T == 768
    for t in (16, 64, 128, 512, 768):
        assert resolve_flash("auto", t) is False
    for t in (769, 1024, 2048, 4096):
        assert resolve_flash("auto", t) is True
    assert resolve_flash(True, 16) is True
    assert resolve_flash(False, 4096) is False
