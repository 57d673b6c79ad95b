"""The port's own copies of the JAX package's JAX-free modules
(slimt_tpu_torch/config.py, io/, text/, runtime/, and the front doors'
bindings.py (its Service on each package's own Model of one package),
repository.py, runtime/router.py and runtime/health.py's Watchdog)
against their originals: on the same inputs each pair gives equal
results.
"""

import dataclasses
import io
import json
import os
import socket
import tarfile
import tempfile

import numpy as np
import pytest

pytest.importorskip("torch")

from slimt_tpu import bindings as jbindings  # noqa: E402
from slimt_tpu import config as jconfig  # noqa: E402
from slimt_tpu import repository as jrepository  # noqa: E402
from slimt_tpu.io import loader as jloader  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.io import marian as jmarian  # noqa: E402
from slimt_tpu.io import shortlist as jshortlist  # noqa: E402
from slimt_tpu.io import synthetic as jsynthetic  # noqa: E402
from slimt_tpu.runtime import batcher as jbatcher  # noqa: E402
from slimt_tpu.runtime import health as jhealth  # noqa: E402
from slimt_tpu.runtime import request as jrequest  # noqa: E402
from slimt_tpu.runtime import router as jrouter  # noqa: E402
from slimt_tpu.text import annotation as jannotation  # noqa: E402
from slimt_tpu.text import spm_proto as jspm  # noqa: E402
from slimt_tpu.text import synthetic_vocab as jsvocab  # noqa: E402
from slimt_tpu.text import vocabulary as jvocabulary  # noqa: E402
from slimt_tpu_torch import bindings, config, repository  # noqa: E402
from slimt_tpu_torch.io import loader, marian, shortlist, synthetic  # noqa: E402
from slimt_tpu_torch.models.model import Model, Package  # noqa: E402
from slimt_tpu_torch.runtime import batcher, health, request, router  # noqa: E402
from slimt_tpu_torch.text import annotation, spm_proto, synthetic_vocab, vocabulary  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

JAX_SIDE = dict(config=jconfig, loader=jloader, marian=jmarian, shortlist=jshortlist,
                synthetic=jsynthetic, batcher=jbatcher, request=jrequest,
                annotation=jannotation, spm=jspm, svocab=jsvocab, vocabulary=jvocabulary,
                bindings=jbindings, repository=jrepository, router=jrouter, health=jhealth,
                model=lambda package: JaxModel(TINY_TEST_CONFIG, package))
PORT_SIDE = dict(config=config, loader=loader, marian=marian, shortlist=shortlist,
                 synthetic=synthetic, batcher=batcher, request=request,
                 annotation=annotation, spm=spm_proto, svocab=synthetic_vocab,
                 vocabulary=vocabulary, bindings=bindings, repository=repository,
                 router=router, health=health,
                 model=lambda package: Model(
                     config.ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4),
                     Package(package.model, package.vocabulary, package.shortlist),
                     device="cpu"))
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


def _text_iterators(m):
    """bindings.words and sentences over a two-sentence AnnotatedText."""
    text = m["annotation"].AnnotatedText()
    text.append_sentence("", ["hello", " world", " ."])
    text.append_sentence(" ", ["the", " cat"])
    return [[(s, w, tuple(r), x) for s, w, r, x in m["bindings"].words(text)],
            [(s, w, tuple(r), x) for s, w, r, x in m["bindings"].words(text, 1)],
            [(s, tuple(r), x) for s, r, x in m["bindings"].sentences(text)]]


def _manifest(m):
    """bindings.package_from_config on a translateLocally manifest, and
    patch_marian_for_slimt on a training YAML, relative to their folder."""
    with tempfile.TemporaryDirectory() as root:
        for name in ("model.intgemm8.bin", "vocab.spm", "lex.s2t.bin", "prefixes.txt"):
            open(os.path.join(root, name), "wb").close()
        path = os.path.join(root, "config.intgemm8.yml")
        with open(path, "w") as f:
            f.write("model: model.intgemm8.bin\nvocab: 'vocab.spm'\n"
                    "shortlist: lex.s2t.bin false\n"
                    "ssplit-prefix-file: prefixes.txt\n# comment: x\n")
        package = m["bindings"].package_from_config(path)
        patched = os.path.join(root, "patched.yml")
        with open(os.path.join(root, "train.yml"), "w") as f:
            f.write("beam-size: 4\nworkspace: 9000\n")
        m["bindings"].patch_marian_for_slimt(os.path.join(root, "train.yml"), patched,
                                            quality=True)
        with open(patched) as f:
            yaml_text = f.read()
        fields = [getattr(package, k) for k in ("model", "vocabulary", "shortlist", "ssplit")]
        return [None if v is None else os.path.relpath(v, root) for v in fields] + [yaml_text]


def _repository(m):
    """TranslateLocallyLike on a seeded local root: inventory, the
    cached archive's download, the unpacked config path."""
    with tempfile.TemporaryDirectory() as root:
        base = os.path.join(root, "slimt_tpu", "browsermt")
        os.makedirs(os.path.join(base, "archives"))
        inventory = {"models": [
            {"code": "a-b", "name": "A-B", "url": "https://example.invalid/a-b.tar.gz"},
            {"code": "c-d", "name": "C-D", "url": "https://example.invalid/c-d.tar.gz"}]}
        with open(os.path.join(base, "models.json"), "w") as f:
            json.dump(inventory, f)
        with tarfile.open(os.path.join(base, "archives", "a-b.tar.gz"), "w:gz") as tar:
            for name in ("a-b/config.intgemm8.yml", "a-b/model.bin"):
                info = tarfile.TarInfo(name)
                info.size = 3
                tar.addfile(info, io.BytesIO(b"abc"))
        repo = m["repository"].TranslateLocallyLike(
            "browsermt", "https://example.invalid/models.json", root=root)
        out = [repo.name, repo.models(filter_downloaded=False), repo.models(), repo.model("c-d"),
               repo.model("zz"), {k: os.path.relpath(v, root) for k, v in repo.dirs.items()}]
        repo.download("a-b")  # cached: no fetch
        out += [repo.models(), os.path.relpath(repo.model_config_path("a-b"), root)]
        for bad in ("zz", "c-d"):
            try:
                repo.download(bad) if bad == "zz" else repo.model_config_path(bad)
            except (KeyError, FileNotFoundError) as e:
                out.append(type(e).__name__)
        return out


def _router(m):
    """Router's pure bookkeeping over backends that refuse connections:
    health, model needs, candidate order."""
    sockets = [socket.socket() for _ in range(3)]
    try:
        for sock in sockets:
            sock.bind(("127.0.0.1", 0))  # bound, not listening: refused
        urls = [f"http://127.0.0.1:{sock.getsockname()[1]}" for sock in sockets]
        r = m["router"].Router(urls, health_interval=3600.0)
        try:
            names = {url: f"b{i}" for i, url in enumerate(urls)}
            out = [r.health()["status"], r._needed_models({"model": "x", "pivot": "y"}),
                   r._needed_models({})]
            r.backends[0].mark(True, models=["x", "y"])
            r.backends[1].mark(True, models=["x"])
            r.backends[1].begin()
            health = r.health()
            out.append({names[u]: {k: v for k, v in b.items() if k != "error"}
                        for u, b in health["backends"].items()})
            out.append([health["status"], health["healthy_backends"], health["models"]])
            for needed in (["x"], ["x", "y"], []):
                out.append([names[b.url] for b in r._candidates(needed)])
            out.append([r._has_models(b, ["y"]) for b in r.backends])
            return out
        finally:
            r.close()
    finally:
        for sock in sockets:
            sock.close()


def _watchdog(m):
    """Watchdog: failures counted, refused after the limit, reset on a
    success."""
    outcomes = iter([ValueError("a"), 1, ValueError("b"), ValueError("c"), 2, 3])

    def fn():
        value = next(outcomes)
        if isinstance(value, Exception):
            raise value
        return value

    dog = m["health"].Watchdog(fn, max_failures=2)
    out = []
    for _ in range(6):
        try:
            out.append(("ok", dog(), dog.healthy))
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e), dog.healthy))
    return out


class _Close(list):
    """Soft alignments, float attention weights: equal within 1e-5 (f32
    summation order), as tests/test_torch_server.py holds them."""


SERVICE_TEXTS = ["hello world .", "the cat sat on the mat .", "<b>bold</b> move",
                 "héllo wörld ."]


def _service(m):
    """bindings.Service's translate (plain, html, alignments forced, byte
    ranges), translate_bulk (plain, html) and pivot on one package, each
    Response through to_json: texts, annotation ranges and alignments."""
    model = m["model"](make_package(with_shortlist=True))
    service = m["bindings"].Service(workers=1, cache_size=0)
    try:
        runs = [service.translate(model, SERVICE_TEXTS),
                service.translate(model, SERVICE_TEXTS, html=True),
                service.translate(model, SERVICE_TEXTS, alignment=True),
                service.translate(model, SERVICE_TEXTS, alignment=True, encoding="byte"),
                service.translate_bulk(model, SERVICE_TEXTS),
                service.translate_bulk(model, SERVICE_TEXTS, html=True),
                service.pivot(model, model, SERVICE_TEXTS[1:2])]
    finally:
        service.close()
    out = []
    for responses in runs:
        for response in responses:
            body = json.loads(m["bindings"].to_json(response))
            out.append([body["source"], body["target"], _Close(body["alignments"])])
    assert any(alignments for *_, alignments in out)
    return out


def _equal(a, b):
    if isinstance(a, _Close):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                       rtol=0, atol=1e-5)
    elif isinstance(a, dict):
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
    [_synthetic_bytes, _weights, _vocab, _shortlist, _defaults, _batch_order,
     _text_iterators, _manifest, _repository, _router, _watchdog, _service],
    ids=lambda f: f.__name__.lstrip("_"),
)
def test_copy_equals_original(probe):
    want = probe(JAX_SIDE)
    got = probe(PORT_SIDE)
    _equal(got, want)
    assert want  # the probe produced something to compare
