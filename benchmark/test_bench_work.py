"""The work counts and the roofline and mfu arithmetic on hand-worked shapes."""

import types

import numpy as np
import pytest

from benchmark import readers
from benchmark.probe import Forward

CFG = {"emb_dim": 4, "ffn_dim": 8, "vocab_size": 10, "encoder_layers": 1, "decoder_layers": 1,
       "reference": "reference/bergamot.py"}
PEAKS = {"int8_ops_per_s": 100.0, "f32_flops_per_s": 10.0, "bytes_per_s": 1000.0}


def forward():
    """Two rows of 3 and 5 source tokens that served 4 and 2 tokens."""
    record = Forward(0.0, 1.0, 2, 16, np.array([3, 5]), [[1, 2, 0], [1, 2, 3, 4, 0]])
    record.raw_result = (np.zeros((2, 4), np.int64), np.array([4, 2]), None)
    return record


def test_encoder_work_by_hand():
    phases = readers.phases(readers_dir())
    work = phases["encoder"].count(CFG, [forward()])
    # per token: 4E^2 + 2EF = 64 + 64 MACs in the encoder layer, 2E^2 = 32 for cross K, V
    assert work["int8_ops"] == 2 * (128 + 32) * 8
    # attention: 4 L^2 E per row: 4 * (9 + 25) * 4
    assert work["f32_ops"] == 4 * 34 * 4
    # weights once (128 + 32), embedding rows 8 * 4, int16 K and V: 1 layer * 2 * 8 * 4 * 2
    assert work["bytes"] == 160 + 32 + 128


def test_decode_work_by_hand():
    phases = readers.phases(readers_dir())
    work = phases["decode"].count(CFG, [forward()])
    # per row-step: SSRU 2E^2 + Q, O 2E^2 + FFN 2EF = 128 MACs, projection E*V = 40
    assert work["int8_ops"] == 2 * (128 + 40) * 6
    # 4 L E per row-step: 4 * 4 * (3 * 4 + 5 * 2)
    assert work["f32_ops"] == 16 * 22
    # 4 steps of decoder weights and projection (128 + 40), K and V int16: 2 * 4 * 2 * 22
    assert work["bytes"] == 4 * 168 + 2 * 4 * 2 * 22
    narrow = phases["decode"].count(CFG, [forward()], lambda f: 5)
    assert narrow["int8_ops"] == 2 * (128 + 20) * 6


def test_least_time_names_its_bound():
    compute = readers.least_time({"int8_ops": 200, "f32_ops": 10, "bytes": 100}, PEAKS)
    assert compute == {"compute_s": 3.0, "memory_s": 0.1, "least_s": 3.0, "bound": "compute"}
    memory = readers.least_time({"int8_ops": 0, "f32_ops": 0, "bytes": 5000}, PEAKS)
    assert memory["bound"] == "memory" and memory["least_s"] == 5.0


def test_mfu_and_roofline_by_hand():
    phases = readers.phases(readers_dir())
    ctx = types.SimpleNamespace(forwards=[forward()], window_s=2.0, peaks=PEAKS, phases=phases,
                                trace=types.SimpleNamespace(op_ns=lambda graph: 4e9))
    ctx.work = lambda phase: phases[phase].count(CFG, ctx.forwards)
    mfu = readers.load_file(f"{readers_dir()}/metrics/mfu.py", "mfu").read(ctx)
    encoder, decode = ctx.work("encoder"), ctx.work("decode")
    compute = (encoder["int8_ops"] + decode["int8_ops"]) / 100 \
        + (encoder["f32_ops"] + decode["f32_ops"]) / 10
    assert mfu == pytest.approx(100 * compute / 2.0)
    roofline = readers.roofline(ctx, "decode", graph=True)
    assert roofline == pytest.approx(100 * readers.least_time(decode, PEAKS)["least_s"] / 4.0)


def test_a_share_with_nothing_to_read_is_left_out():
    empty = types.SimpleNamespace(forwards=[], trace=None, peaks=PEAKS, window_s=1.0,
                                  graph_counts=None)
    assert readers.roofline(empty, "decode", graph=True) is None
    assert readers.idle_share(empty) is None
    assert readers.graph_hit_share(empty) is None


def readers_dir():
    import os

    return os.path.dirname(os.path.abspath(readers.__file__))
