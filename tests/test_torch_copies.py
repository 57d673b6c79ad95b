"""The port's own copies of the JAX package's JAX-free modules
(slimt_tpu_torch/config.py, io/, text/, runtime/) against their
originals: on the same inputs each pair gives equal results.
"""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from slimt_tpu import config as jconfig  # noqa: E402
from slimt_tpu.io import loader as jloader  # noqa: E402
from slimt_tpu.io import marian as jmarian  # noqa: E402
from slimt_tpu.io import shortlist as jshortlist  # noqa: E402
from slimt_tpu.io import synthetic as jsynthetic  # noqa: E402
from slimt_tpu.runtime import batcher as jbatcher  # noqa: E402
from slimt_tpu.runtime import request as jrequest  # noqa: E402
from slimt_tpu.text import annotation as jannotation  # noqa: E402
from slimt_tpu.text import spm_proto as jspm  # noqa: E402
from slimt_tpu.text import synthetic_vocab as jsvocab  # noqa: E402
from slimt_tpu.text import vocabulary as jvocabulary  # noqa: E402
from slimt_tpu_torch import config  # noqa: E402
from slimt_tpu_torch.io import loader, marian, shortlist, synthetic  # noqa: E402
from slimt_tpu_torch.runtime import batcher, request  # noqa: E402
from slimt_tpu_torch.text import annotation, spm_proto, synthetic_vocab, vocabulary  # noqa: E402

JAX_SIDE = dict(config=jconfig, loader=jloader, marian=jmarian, shortlist=jshortlist,
                synthetic=jsynthetic, batcher=jbatcher, request=jrequest,
                annotation=jannotation, spm=jspm, svocab=jsvocab, vocabulary=jvocabulary)
PORT_SIDE = dict(config=config, loader=loader, marian=marian, shortlist=shortlist,
                 synthetic=synthetic, batcher=batcher, request=request,
                 annotation=annotation, spm=spm_proto, svocab=synthetic_vocab,
                 vocabulary=vocabulary)
SMALL = dict(vocab_size=200, emb_dim=32, ffn_dim=64)
LINES = ["hello world", "the quick brown fox jumps", "dog", "a b c d e f g"]


def _model_bytes(m, seed):
    cfg = m["config"].ModelConfig(encoder_layers=2, decoder_layers=1, num_heads=4)
    return m["synthetic"].synthetic_model_bytes(config=cfg, seed=seed, **SMALL), cfg


def _synthetic_bytes(m):
    return [_model_bytes(m, seed)[0] for seed in (0, 7)]


def _weights(m):
    blob, cfg = _model_bytes(m, 3)
    params = m["loader"].load_weights(m["marian"].load_items(blob), cfg)
    return params, m["loader"].model_dims(params)


def _vocab(m):
    spm = m["svocab"].build_spm_model(m["svocab"].DEFAULT_WORDS, target_size=96)
    vocab = m["vocabulary"].Vocabulary(m["spm"].serialize_model(spm))
    out = []
    for line in LINES:
        ids = vocab.encode(line, add_eos=True)[0]
        out.append((list(ids), vocab.decode(list(ids))[0]))
    return out


def _shortlist(m):
    blob = m["shortlist"].build_synthetic_shortlist(500, best=10, frequent=30, seed=2)
    gen = m["shortlist"].ShortlistGenerator(blob, vocab_size=500)
    words = np.random.default_rng(5).integers(0, 500, 40).tolist()
    return [gen.generate(words).tolist(), gen.generate_padded(words, 64).tolist()]


def _defaults(m):
    return [dataclasses.asdict(m["config"].Config()),
            dataclasses.asdict(m["config"].ModelConfig())]


def _batch_order(m):
    """Batches of a Batcher fed three requests of mixed lengths, as
    (request id, segment index) lists."""
    rng = np.random.default_rng(11)
    b = m["batcher"].Batcher(max_words=24, wrap_length=8, tgt_length_limit_factor=1.5)
    for rid in range(3):
        segments = [list(rng.integers(3, 50, int(n))) + [0]
                    for n in rng.integers(1, 8, 4)]
        source = m["annotation"].AnnotatedText()
        for seg in segments:
            source.append_sentence("", [f"t{w}" for w in seg])
        b.enqueue(m["request"].Request(
            rid, model_id=1, source=source, segments=segments, vocabulary=None,
            cache=None, continuation=lambda r: None, needs_alignment=False))
    order = []
    while True:
        batch = b.generate()
        if batch.empty():
            return order
        order.append([(ref.request.id, ref.index) for ref in batch.segment_refs])


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize(
    "probe",
    [_synthetic_bytes, _weights, _vocab, _shortlist, _defaults, _batch_order],
    ids=lambda f: f.__name__.lstrip("_"),
)
def test_copy_equals_original(probe):
    want = probe(JAX_SIDE)
    got = probe(PORT_SIDE)
    _equal(got, want)
    assert want  # the probe produced something to compare
