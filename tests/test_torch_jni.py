"""The port's JNI binding (slimt_tpu_torch/native/slimt_jni.cpp over the
port's C ABI) driven by its fake-JVM host (slimt_tpu_torch/native/
jni_host.cpp), both built by ops/_native_build.py into
slimt_tpu_torch/build/: tests/test_jni.py's two cases, on the CPU
(the Config's "device" field set to "cpu" through SLIMT_JNI_DEVICE).
The host dlopens the binding with RTLD_LOCAL, as HotSpot's
System.loadLibrary does: the load mode that caught the embedded
libpython's visibility bug, kept as its regression guard. The answer
equals the port's C ABI answer (capi.py's object table) and the JAX
package's (slimt_tpu.capi) for the same package and spec.
"""

import json
import os
import shutil
import subprocess

import pytest

pytest.importorskip("torch")

from slimt_tpu_torch import capi  # noqa: E402
from slimt_tpu_torch.ops import _native_build  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(REPO, "slimt_tpu_torch", "build")
TEXTS = ["hello world .", "this is a test ."]

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("python3-config") is None,
    reason="no C++ toolchain",
)


@pytest.fixture(scope="module")
def jni_artifacts():
    library, host = _native_build.jni_library_path(), _native_build.jni_host_path()
    assert os.path.dirname(library) == BUILD and os.path.dirname(host) == BUILD
    return str(library), str(host)


@pytest.fixture(scope="module")
def package_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("jni_pkg")
    package = make_package(with_shortlist=True)
    for name, payload in (("model.bin", package.model), ("vocab.spm", package.vocabulary),
                          ("shortlist.bin", package.shortlist)):
        (root / name).write_bytes(payload)
    return root


def _env(device="cpu"):
    env = dict(os.environ)
    env["SLIMT_TPU_TORCH_PYTHONPATH"] = REPO
    env.pop("SLIMT_JNI_FAKE_FAIL_FIELD", None)
    env.pop("SLIMT_JNI_DEVICE", None)
    if device is not None:
        env["SLIMT_JNI_DEVICE"] = device
    return env


def _run(jni_artifacts, package_dir, texts, env=None, timeout=600):
    library, host = jni_artifacts
    config = TINY_TEST_CONFIG
    return subprocess.run(
        [host, library, str(package_dir), str(config.encoder_layers),
         str(config.decoder_layers), str(config.feed_forward_depth),
         str(config.num_heads), *texts],
        capture_output=True, text=True, timeout=timeout, env=env or _env())


def _jni_spec(package_dir):
    """The spec Model.ncreate builds from the host's Config and paths."""
    config = TINY_TEST_CONFIG
    return {"preset": "tiny", "encoder_layers": config.encoder_layers,
            "decoder_layers": config.decoder_layers,
            "feed_forward_depth": config.feed_forward_depth,
            "num_heads": config.num_heads, "split_mode": "sentence",
            "model": str(package_dir / "model.bin"),
            "vocabulary": str(package_dir / "vocab.spm"),
            "shortlist": str(package_dir / "shortlist.bin"), "device": "cpu"}


def _capi_answer(module, spec, texts):
    """`module`'s C ABI object table (the port's capi or the JAX
    package's) on `spec`."""
    module.init()
    service = module.service_create(1, 64)
    model = module.model_create(json.dumps(spec))
    try:
        return module.translate(service, model, texts)
    finally:
        module.release(model)
        module.release(service)


def test_jni_end_to_end(jni_artifacts, package_dir):
    from slimt_tpu import capi as jax_capi

    result = _run(jni_artifacts, package_dir, TEXTS)
    assert result.returncode == 0, result.stderr + result.stdout
    lines = result.stdout.splitlines()
    assert len(lines) == len(TEXTS)
    spec = _jni_spec(package_dir)
    assert lines == _capi_answer(capi, spec, TEXTS)
    # The JAX package's C ABI on the same spec (its CPU platform under the
    # tests; it takes no "device").
    del spec["device"]
    assert lines == _capi_answer(jax_capi, spec, TEXTS)
    # Deterministic engine: the same input twice, the same output.
    again = _run(jni_artifacts, package_dir, TEXTS)
    assert again.stdout == result.stdout


def test_jni_missing_field_throws(jni_artifacts, package_dir):
    """A real JVM returns null from GetFieldID (a NoSuchFieldError
    pending) when the Java class lacks a field; the binding clears it
    and throws one RuntimeException."""
    env = _env()
    env["SLIMT_JNI_FAKE_FAIL_FIELD"] = "vocabulary"
    result = _run(jni_artifacts, package_dir, ["hello ."], env=env)
    assert result.returncode != 0
    assert "missing Java field: vocabulary" in result.stderr


def test_jni_runs_on_the_card_unless_told(jni_artifacts, package_dir):
    """Without a device field the spec names none: the model asks for the
    card, which this machine lacks, and the binding throws; nothing runs
    on the CPU instead. A class without the field (GetFieldID fails) is
    the same: the field is optional."""
    for env in (_env(device=None), dict(_env(device=None), SLIMT_JNI_FAKE_FAIL_FIELD="device")):
        result = _run(jni_artifacts, package_dir, ["hello ."], env=env)
        if result.returncode == 0:
            pytest.skip("this machine has a CUDA card")
        assert "torch.cuda.is_available() is False" in result.stderr, result.stderr
