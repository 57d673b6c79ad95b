"""The plain reference and the benchmark's writers against the port's CPU
path on a small configuration (this test imports the port; the reference
never does)."""

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import shortlist as reference_shortlist
from benchmark.reference.bergamot import Bergamot
from benchmark.reference.check import Segment, logit_gaps
from benchmark.reference.text import Text
from benchmark.testing import TINY, load

SEED = 2**31 + 3


@pytest.fixture(scope="module")
def made():
    cfg = dict(load("configs", "bergamot-tiny11"), **TINY)
    lexicon = inputs.make_lexicon(SEED, cfg["vocab_size"] - 54, cfg["zipf_s"])
    pieces = inputs.vocabulary_pieces(lexicon)
    weights = inputs.make_weights(cfg, SEED, "cpu")
    return cfg, lexicon, pieces, weights


def port_model(made, **knobs):
    from slimt_tpu_torch import Model, ModelConfig, Package

    cfg, _, pieces, weights = made
    config = ModelConfig(**cfg["model_config"], **knobs)
    return Model(config, Package(inputs.marian_bytes(weights), inputs.spm_model_bytes(pieces)),
                 cfg["tgt_length_limit_factor"], device="cpu")


def test_marian_and_spm_bytes_read_back_through_the_port(made):
    from slimt_tpu_torch.io.marian import load_items
    from slimt_tpu_torch.text.spm_proto import parse_model

    _, _, pieces, weights = made
    items = {item.name: item for item in load_items(inputs.marian_bytes(weights))}
    for name, (q, mult) in weights.int8.items():
        assert np.array_equal(items[name].array, q)
        assert items[name].scale == pytest.approx(mult, rel=1e-7)
    for name, array in weights.f32.items():
        assert np.array_equal(np.asarray(items[name].array).reshape(array.shape), array)
    model = parse_model(inputs.spm_model_bytes(pieces))
    assert [(p.piece, p.type) for p in model.pieces] == [(p, k) for p, _, k in pieces]
    assert (model.eos_id, model.unk_id) == (0, 1)


def test_text_matches_the_port_tokenizer(made):
    from slimt_tpu_torch.text.vocabulary import Vocabulary

    _, lexicon, pieces, _ = made
    vocabulary = Vocabulary(inputs.spm_model_bytes(pieces))
    text = Text(pieces, inputs.EOS_ID)
    lines = inputs.make_lines(inputs.rng(SEED, "t"), lexicon, np.array([1, 5, 17, 40]))
    for line in lines:
        assert text.encode(line) == list(vocabulary.encode(line)[0])
        ids = text.encode(line)[::-1] + [inputs.EOS_ID]
        assert text.decode(ids) == vocabulary.decode(ids)[0]


@pytest.mark.parametrize("where", ["first", "inside", "last", "alone"])
def test_unknown_ids_detokenize_as_the_port_does(made, where):
    """A served <unk> (id 1) reads as sentencepiece's " ⁇ " on both sides."""
    from slimt_tpu_torch.text.vocabulary import Vocabulary

    _, lexicon, pieces, _ = made
    vocabulary = Vocabulary(inputs.spm_model_bytes(pieces))
    text = Text(pieces, inputs.EOS_ID)
    words = text.encode(inputs.make_lines(inputs.rng(SEED, "u"), lexicon, np.array([6]))[0])
    ids = {"first": [inputs.UNK_ID] + words, "inside": words[:3] + [inputs.UNK_ID] + words[3:],
           "last": words + [inputs.UNK_ID], "alone": [inputs.UNK_ID]}[where] + [inputs.EOS_ID]
    assert "\u2047" in text.decode(ids)
    assert text.decode(ids) == vocabulary.decode(ids)[0]


@pytest.mark.parametrize("draw", range(4))
def test_shortlist_columns_match_the_port(made, draw):
    from slimt_tpu_torch.io.shortlist import ShortlistGenerator

    cfg, lexicon, _, _ = made
    candidates = inputs.make_candidates(lexicon, cfg["vocab_size"], 8, SEED + draw, "cpu")
    generator = ShortlistGenerator(inputs.shortlist_bytes(candidates, 10, 8), cfg["vocab_size"])
    words = inputs.rng(SEED, f"w{draw}").integers(0, cfg["vocab_size"], 3 + 20 * draw)
    for bucket in (64, 1024):
        assert np.array_equal(reference_shortlist.columns(candidates, 10, words, bucket),
                              generator.generate_padded(words.tolist(), bucket))
    assert reference_shortlist.width(candidates, 10, words) == len(generator.generate(words.tolist()))


def served(made, model, n=6):
    _, lexicon, pieces, _ = made
    text = Text(pieces, inputs.EOS_ID)
    lines = inputs.make_lines(inputs.rng(SEED, "s"), lexicon, np.arange(1, n + 1) * 3)
    segments = [text.encode(line) + [inputs.EOS_ID] for line in lines]
    hypotheses = model.forward(segments, need_alignment=False)
    return [Segment(np.array(s), np.array(h.target), None) for s, h in zip(segments, hypotheses)]


def test_reference_follows_the_port_exactly_in_float32(made):
    """The port's float32 path (weights dequantized once, exact argmax,
    float32 cache) and the reference compute the same function: every
    served token is the reference's best to rounding."""
    cfg, _, _, weights = made
    model = port_model(made, qmm_provider="f32", kv_cache_dtype="float32", argmax_method="exact")
    gaps = logit_gaps(Bergamot(weights, cfg, "cpu"), served(made, model))
    assert gaps["tokens_compared"] > 30 and gaps["tokens_outside_columns"] == 0
    assert gaps["max_logit_gap"] < 1e-4


def test_declared_path_stays_near_the_reference(made):
    cfg, _, _, weights = made
    gaps = logit_gaps(Bergamot(weights, cfg, "cpu"), served(made, port_model(made)))
    assert gaps["max_logit_gap"] < 0.2


def test_int4_control_is_far_from_the_reference(made):
    cfg, _, _, weights = made
    segments = served(made, port_model(made))
    gaps = logit_gaps(Bergamot(weights, cfg, "cpu"), segments,
                      Bergamot(weights, cfg, "cpu", precision="int4"))
    assert gaps["control_max_logit_gap"] > 5 * max(gaps["max_logit_gap"], 0.05)


def test_reference_sets_no_tf32():
    Bergamot(inputs.Weights({"Wemb": (np.ones((4, 2), np.int8), 1.0)},
                            {"none_QuantMultA": np.ones((1, 1), np.float32)}),
             {"num_heads": 1, "emb_dim": 2, "decoder_position": "zero"}, "cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
