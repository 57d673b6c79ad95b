"""The port's C embedding ABI (slimt_tpu_torch/native/slimt_capi.cpp,
built by ops/_capi_build.py, over slimt_tpu_torch/capi.py) on the CPU:
the object table against the JAX package's (slimt_tpu/capi.py) on the
same package, in plain, html and JSON modes and through pivot; then the
library built with g++ and loaded with ctypes into this process
(slimt_init finds a live interpreter), translating through
slimt_translate and slimt_pivot to the text of bindings.Service on the
same model.
"""

import ctypes
import json
import os
import shutil
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

from slimt_tpu_torch import capi  # noqa: E402
from slimt_tpu_torch.bindings import Service  # noqa: E402
from slimt_tpu_torch.ops import _capi_build  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["hello world .", "the cat sat on the mat .", "<b>bold</b> move"]


@pytest.fixture(scope="module")
def package_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("capi_pkg")
    package = make_package(with_shortlist=True)
    for name, payload in (("model.bin", package.model), ("vocab.spm", package.vocabulary),
                          ("shortlist.bin", package.shortlist)):
        (root / name).write_bytes(payload)
    return root


def _spec(package_dir, **overrides):
    spec = {
        "preset": "tiny",
        "encoder_layers": TINY_TEST_CONFIG.encoder_layers,
        "decoder_layers": TINY_TEST_CONFIG.decoder_layers,
        "num_heads": TINY_TEST_CONFIG.num_heads,
        "model": str(package_dir / "model.bin"),
        "vocabulary": str(package_dir / "vocab.spm"),
        "shortlist": str(package_dir / "shortlist.bin"),
        "device": "cpu",
    }
    spec.update(overrides)
    return json.dumps(spec)


def _service_texts(model, texts, html=False, pivot=None):
    service = Service(workers=1, cache_size=0)
    try:
        if pivot is not None:
            return [r.target.text for r in service.pivot(model, pivot, texts, html=html)]
        return [r.target.text for r in service.translate(model, texts, html=html)]
    finally:
        service.close()


def test_capi_python_backend(package_dir):
    capi.init()
    service = capi.service_create(1, 128)
    model = capi.model_create(_spec(package_dir))
    try:
        outputs = capi.translate(service, model, TEXTS[:2])
        assert outputs == _service_texts(capi._get(model), TEXTS[:2])
        # JSON carries alignments; the batch's targets stay the same.
        decoded = [json.loads(s) for s in capi.translate(service, model, TEXTS[:2],
                                                          as_json=True)]
        assert [d["source"]["text"] for d in decoded] == TEXTS[:2]
        assert [d["target"]["text"] for d in decoded] == outputs
        assert decoded[0]["alignments"] and decoded[0]["alignments"][0]
        assert len(capi.pivot(service, model, model, ["hello world ."])) == 1
    finally:
        capi.release(model)
        capi.release(service)
    with pytest.raises(KeyError):
        capi.translate(service, model, ["x"])
    with pytest.raises(FileNotFoundError):
        capi.model_create(_spec(package_dir, model="/nonexistent/m.bin"))


@pytest.fixture(scope="module")
def both_tables(package_dir):
    """One service and one model in each package's object table, built
    from the same spec: the port's with "device": "cpu", the JAX
    package's without it (its CPU platform under the tests)."""
    from slimt_tpu import capi as jcapi

    spec = json.loads(_spec(package_dir))
    capi.init()
    port = (capi, capi.service_create(1, 0), capi.model_create(json.dumps(spec)))
    del spec["device"]
    jcapi.init()
    jax = (jcapi, jcapi.service_create(1, 0), jcapi.model_create(json.dumps(spec)))
    yield {"port": port, "jax": jax}
    for module, service, model in (port, jax):
        module.release(model)
        module.release(service)


def _same_outputs(got, want, as_json):
    """Equal strings; in JSON, equal texts and annotation ranges, and the
    soft alignments (float attention weights) within 1e-5."""
    assert len(got) == len(want)
    if not as_json:
        assert got == want
        return
    for g, w in zip(got, want):
        g, w = json.loads(g), json.loads(w)
        g_align, w_align = g.pop("alignments"), w.pop("alignments")
        assert g == w
        assert len(g_align) == len(w_align) and any(w_align)
        for x, y in zip(g_align, w_align):
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("html,as_json", [(False, False), (True, False), (False, True),
                                          (True, True)],
                         ids=["plain", "html", "json", "html_json"])
def test_capi_translate_equals_the_jax_capi(both_tables, html, as_json):
    outputs = {key: module.translate(service, model, TEXTS, html=html, as_json=as_json)
               for key, (module, service, model) in both_tables.items()}
    _same_outputs(outputs["port"], outputs["jax"], as_json)


@pytest.mark.parametrize("as_json", [False, True], ids=["plain", "json"])
def test_capi_pivot_equals_the_jax_capi(both_tables, as_json):
    # One text: Service.pivot queues each text alone, so the batches of
    # several would depend on timing.
    outputs = {key: module.pivot(service, model, model, TEXTS[1:2], as_json=as_json)
               for key, (module, service, model) in both_tables.items()}
    _same_outputs(outputs["port"], outputs["jax"], as_json)


def test_capi_model_create_runs_on_the_card_unless_told():
    """No "device" in the spec: the card; none here, so it raises and no
    CPU model takes its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_gpu.py covers it")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        capi.model_create(json.dumps({"model": "/nope", "vocabulary": "/nope"})
                          .replace("/nope", os.path.join(REPO, "data", "sample.txt")))


def _toolchain():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    config = shutil.which("python3-config")
    if config is None:
        pytest.skip("no python3-config")
    includes = subprocess.run([config, "--includes"], capture_output=True, text=True).stdout
    headers = [flag[2:] for flag in includes.split() if flag.startswith("-I")]
    if not any(os.path.exists(os.path.join(h, "Python.h")) for h in headers):
        pytest.skip("no Python headers")


@pytest.fixture(scope="module")
def lib():
    _toolchain()
    path = _capi_build.library_path()
    assert path.name.startswith("libslimt_torch_capi_") and path.parent.name == "build"
    assert _capi_build.library_path() == path  # unchanged sources: no rebuild
    handle = ctypes.CDLL(str(path))
    handle.slimt_init.argtypes = [ctypes.c_char_p]
    handle.slimt_last_error.restype = ctypes.c_char_p
    handle.slimt_service_create.argtypes = [ctypes.c_int, ctypes.c_int]
    handle.slimt_service_create.restype = ctypes.c_longlong
    handle.slimt_model_create.argtypes = [ctypes.c_char_p]
    handle.slimt_model_create.restype = ctypes.c_longlong
    strings = ctypes.POINTER(ctypes.c_char_p)
    handle.slimt_translate.argtypes = [ctypes.c_longlong, ctypes.c_longlong, strings,
                                       ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.slimt_translate.restype = strings
    handle.slimt_pivot.argtypes = [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                                   strings, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.slimt_pivot.restype = strings
    handle.slimt_free_strings.argtypes = [strings]
    handle.slimt_release.argtypes = [ctypes.c_longlong]
    assert handle.slimt_init(REPO.encode()) == 0, handle.slimt_last_error()
    return handle


def _call(lib, fn, *args, texts, html=0, as_json=0):
    array = (ctypes.c_char_p * len(texts))(*[t.encode() for t in texts])
    out = fn(*args, array, len(texts), html, as_json)
    assert out, lib.slimt_last_error().decode()
    try:
        return [out[i].decode() for i in range(len(texts))]
    finally:
        lib.slimt_free_strings(out)


def test_shared_library_translates_as_the_service(lib, package_dir):
    service = lib.slimt_service_create(1, 0)
    model = lib.slimt_model_create(_spec(package_dir).encode())
    assert service and model, lib.slimt_last_error()
    try:
        held = capi._get(model)  # the Model the library built
        for html in (0, 1):
            got = _call(lib, lib.slimt_translate, service, model, texts=TEXTS, html=html)
            assert got == _service_texts(held, TEXTS, html=bool(html))
        # One text: Service.pivot queues each text alone, so the batches
        # of several would depend on timing.
        got = _call(lib, lib.slimt_pivot, service, model, model, texts=TEXTS[1:2])
        assert got == _service_texts(held, TEXTS[1:2], pivot=held)
        decoded = [json.loads(s) for s in _call(lib, lib.slimt_translate, service, model,
                                                texts=TEXTS[:1], as_json=1)]
        assert decoded[0]["source"]["text"] == TEXTS[0] and decoded[0]["alignments"]
    finally:
        lib.slimt_release(model)
        lib.slimt_release(service)


def test_shared_library_reports_errors(lib, package_dir):
    assert lib.slimt_model_create(b'{"preset": "tiny", "model": "/nope"}') == 0
    assert "model_create" in lib.slimt_last_error().decode()
    # No "device": the card, which is absent here.
    import torch

    if not torch.cuda.is_available():
        spec = json.loads(_spec(package_dir))
        del spec["device"]
        assert lib.slimt_model_create(json.dumps(spec).encode()) == 0
        assert "torch.cuda.is_available() is False" in lib.slimt_last_error().decode()
    out = lib.slimt_translate(999999, 999999, (ctypes.c_char_p * 1)(b"x"), 1, 0, 0)
    assert not out and "unknown slimt handle" in lib.slimt_last_error().decode()
