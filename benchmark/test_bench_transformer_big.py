"""transformer-big's files in the benchmark, on the CPU: a tiny
configuration of its architecture runs to `correct` through the harness
with no edit to a shared file; the comparison sees the decoder's
self-attention cache (a reference whose self-attention reads the current
position alone is judged wrong); the work counts by hand; and the
program's `self_positions` span field against the positions its
self-attention read."""

import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import inputs, testing
from benchmark.probe import Forward
from benchmark.reference import marian_transformer as mt
from benchmark.reference.check import Segment, logit_gaps
from benchmark.reference.text import Text

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 2**31 + 5
# transformer-big at test widths: its depth, decoder kind, positions and
# planted gains (at two decoder layers every row of the planted weights
# repeats one token, and its history changes nothing).
SMALL = {"emb_dim": 128, "ffn_dim": 256, "vocab_size": 512, "encoder_layers": 6,
         "decoder_layers": 6, "num_heads": 4}


def small_config() -> dict:
    cfg = dict(testing.load("configs", "transformer-big"), name="tiny-big", **SMALL)
    cfg["model_config"] = dict(cfg["model_config"], encoder_layers=6, decoder_layers=6,
                               num_heads=4)
    return cfg


def test_a_small_transformer_big_runs_to_correct(tmp_path):
    directory = str(tmp_path)
    testing.write(directory, "configs", "tiny-big", small_config())
    small = dict(testing.load("traffic", "bulk-docs"), call_lines=16, pool_lines_per_s=16,
                 clients=1, warm={"min_rounds": 1, "max_s": 5})
    testing.write(directory, "traffic", "small-docs", small)
    testing.write(directory, "cells", "tiny-big", testing.load("cells", "big-bulk"))
    bench = testing.bench()
    bench["workloads"] = [{"name": "tiny-big", "config": "tiny-big", "traffic": "small-docs",
                           "chips": 1, "why": "test"}]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            metric["workloads"] = ["tiny-big"]
    result = testing.run(directory, "tiny-big", seconds=1.0, bench_object=bench)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["readings"]["tokens_compared"] > 50


@pytest.fixture(scope="module")
def served():
    """A small transformer-big, its weights, and the tokens the port served
    for a few lines."""
    from slimt_tpu_torch import Model, ModelConfig, Package

    cfg = small_config()
    lexicon = inputs.make_lexicon(SEED, cfg["vocab_size"] - inputs.FIRST_WORD_ID
                                  - inputs.CHAR_PIECES, cfg["zipf_s"])
    pieces = inputs.vocabulary_pieces(lexicon)
    weights = inputs.make_weights(cfg, SEED, "cpu", mt)
    model = Model(ModelConfig(**cfg["model_config"]),
                  Package(inputs.marian_bytes(weights), inputs.spm_model_bytes(pieces)),
                  cfg["tgt_length_limit_factor"], device="cpu")
    text = Text(pieces, inputs.EOS_ID)
    lines = inputs.make_lines(inputs.rng(SEED, "lines"), lexicon, np.arange(10, 50, 3))
    sources = [text.encode(line) + [inputs.EOS_ID] for line in lines]
    hypotheses = model.forward(sources, need_alignment=False)
    segments = [Segment(np.array(s), np.array(h.target), None)
                for s, h in zip(sources, hypotheses)]
    return cfg, weights, model, sources, segments


class NoHistory(mt.MarianTransformer):
    """The reference with a self-attention that reads the current position
    alone: a decoder that dropped its cache."""

    def self_mask(self, s: int) -> torch.Tensor:
        alone = torch.eye(s, dtype=torch.bool, device=self.device)
        return torch.where(alone, 0.0, mt.MASKED)[None, None].to(torch.float32)


def test_a_decoder_without_its_history_is_judged_wrong(served):
    cfg, weights, _, _, segments = served
    limit = testing.load("cells", "big-bulk")["limits"]["max_logit_gap"]
    program = logit_gaps(mt.Reference(weights, cfg, "cpu"), segments)
    dropped = logit_gaps(NoHistory(weights, cfg, "cpu"), segments)
    assert program["max_logit_gap"] < limit < dropped["max_logit_gap"]


def forward(lengths, steps) -> Forward:
    """A finished forward whose rows have these source lengths and served
    these many tokens."""
    served = [np.arange(n) for n in steps]
    return Forward(start=0.0, done=1.0, rows=len(lengths), t_bucket=16,
                   lengths=np.array(lengths), raw_sources=[np.arange(n) for n in lengths],
                   raw_result=(np.zeros((len(steps), max(steps))), np.array(steps), None))


def test_work_counts_by_hand():
    cfg = {"emb_dim": 8, "ffn_dim": 32, "vocab_size": 100, "encoder_layers": 1,
           "decoder_layers": 2}
    rows = forward([5, 3], [4, 2])
    # Per row-step: 2 layers x (6 x 64 + 2 x 8 x 32) = 1,792 macs, and the
    # projection 8 x 100 = 800: 2 x 2,592 operations over 6 row-steps.
    # Self positions read: 1+2+3+4 and 1+2 = 13; cross: 5 x 4 + 3 x 2 = 26.
    # A position of a cache: 8 columns of int16 K and V and two f32 scales,
    # 40 bytes.
    assert mt.WORK["decode"](cfg, [rows]) == {
        "int8_ops": 2 * 2592 * 6,
        "f32_ops": 2 * 4 * 8 * (13 + 26),
        "bytes": 4 * 2592 + 2 * 40 * (13 + 6 + 26),
    }
    assert mt.SELF_ATTENTION(cfg, [rows]) == {
        "int8_ops": 0,
        "f32_ops": 2 * 4 * 8 * 13,
        "bytes": 2 * (40 * 13 + 8 * 8 * 6),
    }
    # The encoder's count is the Bergamot student's: 8 tokens through one
    # encoder layer and the 2 decoder layers' cross K and V.
    assert mt.WORK["encoder"](cfg, [rows]) == {
        "int8_ops": 2 * (4 * 64 + 2 * 8 * 32 + 2 * 2 * 64) * 8,
        "f32_ops": 4 * 8 * (25 + 9),
        "bytes": (4 * 64 + 2 * 8 * 32 + 2 * 2 * 64) + 8 * 8 + 2 * 2 * 8 * 8 * 2,
    }


def test_self_positions_field_counts_the_positions_read(served, monkeypatch):
    from slimt_tpu_torch import utils
    from slimt_tpu_torch.ops import decode_attn

    cfg, _, model, sources, _ = served
    read = []
    plain = decode_attn.self_attention_plain

    def counting(q, k, v, kqi, vqi, valid, num_heads):
        read.append(k.shape[0] * int(valid[0]))
        return plain(q, k, v, kqi, vqi, valid, num_heads)

    monkeypatch.setattr(decode_attn, "self_attention_plain", counting)
    t0 = time.perf_counter()
    with utils.recording():
        model.forward(sources, need_alignment=False)
    jobs = [s for s in utils.spans_between(t0, time.perf_counter()) if s.name == "model.job"]
    assert len(jobs) == 1
    fields = jobs[0].fields
    steps = fields["steps"]
    assert fields["self_positions"] == fields["rows_padded"] * steps * (steps + 1) // 2
    assert fields["self_positions"] * cfg["decoder_layers"] == sum(read)
