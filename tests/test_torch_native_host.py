"""The port's own native host library (slimt_tpu_torch/native/slimt_host.cpp,
built by ops/_native_build.py into slimt_tpu_torch/build/) against the
JAX package's pure-Python backend: tests/test_native.py's parity cases
on the port's library. Loading it reads, builds and writes nothing
under the JAX package's top-level native/ directory.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from slimt_tpu.io.shortlist import hash_words as jax_hash_words  # noqa: E402
from slimt_tpu.text.synthetic_vocab import build_vocabulary as jax_vocabulary  # noqa: E402
from slimt_tpu_torch import native  # noqa: E402
from slimt_tpu_torch.text.synthetic_vocab import build_vocabulary  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

WORDS = ["hello", "world", "test", "quick", "brown", "héllo"]

LINES = [
    "hello world",
    "a quick brown test!",
    "unknown zzz qq",
    "  spaces   collapse  ",
    "héllo wörld",
    "",
    "punctuation, works. fine?",
]


@pytest.fixture(scope="module")
def py_vocab():
    """The JAX package's pure-Python backend: the reference."""
    return jax_vocabulary(WORDS, backend="none")


@pytest.fixture(scope="module")
def native_vocab():
    return build_vocabulary(WORDS, backend="native")


def test_library_is_the_ports_own():
    path = native.library_path()
    assert native.available()
    assert path.parent == REPO / "slimt_tpu_torch" / "build"
    assert path.name.startswith("libslimt_torch_host_")


def _snapshot(directory: Path) -> dict:
    return {p.name: p.stat().st_mtime_ns for p in sorted(directory.iterdir())}


def test_loading_leaves_the_jax_native_directory_untouched(tmp_path):
    """The package, copied beside a copy of native/ (mtimes kept), loads
    its library in a fresh process: the library is built under the
    copy's slimt_tpu_torch/build/, and native/ keeps its files and
    mtimes (a make there would add libslimt_host.so)."""
    shutil.copytree(REPO / "slimt_tpu_torch", tmp_path / "slimt_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    native_copy = tmp_path / "native"
    native_copy.mkdir()
    for name in ("Makefile", "slimt_host.cpp", "slimt_capi.cpp", "slimt_capi.h"):
        shutil.copy2(REPO / "native" / name, native_copy / name)
    before = _snapshot(native_copy)
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-c",
         "from slimt_tpu_torch import native; assert native.available(); "
         "print(native.library_path())"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    path = Path(out.stdout.strip())
    assert path.parent == tmp_path / "slimt_tpu_torch" / "build"
    assert _snapshot(native_copy) == before


def test_hash_words_matches_python():
    words = [3, 1, 4, 1, 5, 9, 2, 6]
    assert native.hash_words(0, words) == jax_hash_words(words)
    assert native.hash_words(7, []) == 7


def test_encode_parity(py_vocab, native_vocab):
    for line in LINES:
        py_ids, py_ranges = py_vocab.encode(line)
        nat_ids, nat_ranges = native_vocab.encode(line)
        assert nat_ids == py_ids, line
        assert nat_ranges == py_ranges, line


def test_decode_parity(py_vocab, native_vocab):
    for line in LINES:
        ids, _ = py_vocab.encode(line, add_eos=True)
        py_text, py_ranges = py_vocab.decode(ids)
        nat_text, nat_ranges = native_vocab.decode(ids)
        assert nat_text == py_text, line
        assert nat_ranges == py_ranges, line


def test_decode_ignore_eos_parity(py_vocab, native_vocab):
    ids, _ = py_vocab.encode("hello world", add_eos=True)
    py_text, py_ranges = py_vocab.decode(ids, ignore_eos=True)
    nat_text, nat_ranges = native_vocab.decode(ids, ignore_eos=True)
    assert nat_text == py_text
    assert nat_ranges == py_ranges


def test_encode_long_line(native_vocab):
    line = "hello world test " * 200
    ids, ranges = native_vocab.encode(line)
    assert len(ids) > 500
    # The final range extends to the end of the line (trailing
    # whitespace folds into the last token's span, as in Python).
    assert ranges[-1][1] == len(line.encode("utf-8"))


def test_decode_batch_parity(py_vocab, native_vocab):
    """decode_batch == N decode calls, native == the Python backend."""
    segments = []
    for line in LINES:
        ids, _ = py_vocab.encode(line, add_eos=True)
        segments.append(ids)
    segments.append([])
    nat = native_vocab.decode_batch(segments)
    py = py_vocab.decode_batch(segments)
    assert len(nat) == len(py) == len(segments)
    for ids, (nd, ne), (pd, pe) in zip(segments, nat, py):
        assert nd == pd
        assert list(ne) == list(pe)
        text, ranges = native_vocab.decode(ids)
        assert nd == text.encode("utf-8")
        assert list(ne) == [e for _, e in ranges]


def test_decode_batch_empty():
    assert build_vocabulary(WORDS, backend="native").decode_batch([]) == []


def test_decode_leading_unk_parity(py_vocab, native_vocab):
    """A leading <unk> must not keep its space or eat the next word's."""
    ids, _ = py_vocab.encode("hello")
    seq = [1] + ids  # synthetic vocab: id 1 is <unk>
    assert py_vocab.decode(seq) == native_vocab.decode(seq)
    text, _ranges = py_vocab.decode(seq)
    assert not text.startswith(" ")


def test_batch_encode_parity(py_vocab, native_vocab):
    """The batch segmenter the bulk lane and the processor use: (ids,
    token begins, end) per line, as the JAX package's Python backend
    gives them."""
    lines = [line for line in LINES if line] * 3
    got = native_vocab.encode_batch_begins(lines)
    want = py_vocab.encode_batch_begins(lines)
    assert len(got) == len(want)
    for (ids, begins, end), (want_ids, want_begins, want_end) in zip(got, want):
        assert list(ids) == list(want_ids)
        assert list(begins) == list(want_begins)
        assert end == want_end
