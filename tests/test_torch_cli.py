"""The port's command line (`python -m slimt_tpu_torch`) against the JAX
package's (`python -m slimt_tpu`), driven in-process through each
package's `cli.main` on the CPU (the port with `--device cpu`): the same
package and arguments print the same text in every translate mode, in
synth, convert, inspect, ls and offline download, with the same exit
codes. One subprocess runs the real entry point and checks that it loads
no JAX and nothing of the JAX package; the reference check runs the
port's `--exact` CLI against the committed reference binary
`crosscheck/bin/slimt_ref_cli` on scripts/crosscheck.py's e2e documents.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import tarfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from slimt_tpu import cli as jcli  # noqa: E402
from slimt_tpu_torch import cli  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_CLI = os.path.join(REPO, "crosscheck", "bin", "slimt_ref_cli")


def _run(main, argv, stdin=""):
    """(exit code, stdout, stderr) of one in-process CLI run."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = main(argv)
    finally:
        sys.stdin = saved
    return code, out.getvalue(), err.getvalue()


def _port(*argv, stdin=""):
    return _run(cli.main, list(argv), stdin)


def _jax(*argv, stdin=""):
    return _run(jcli.main, list(argv), stdin)


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    """The port's `synth` package (tiny preset, emb 64, ffn 128) and its
    native checkpoint from the port's `convert`."""
    root = str(tmp_path_factory.mktemp("cli") / "pkg")
    assert _port("synth", "--out", root)[0] == 0
    assert _port("convert", os.path.join(root, "model.bin"),
                 os.path.join(root, "model.npz"))[0] == 0
    return root


def _modes(root):
    follow = ["--follow-root", root, "--follow-model", "model.bin",
              "--follow-vocabulary", "vocab.spm"]
    with open(os.path.join(REPO, "data", "sample.txt"), encoding="utf-8") as f:
        sample = f.read()
    return {
        "blocking": (["--shortlist", "shortlist.bin"], "hello world\nthe cat sat .\n"),
        "full_vocab": ([], "hello world . the quick brown fox .\n\nA second paragraph.\n"),
        "sample_txt": ([], sample),
        "async": (["--async", "--workers", "2", "--text", "hello world"], ""),
        "async_poll": (["--async", "--poll", "0.01", "--text", "the cat sat ."], ""),
        "pivot": (follow + ["--text", "hello world"], ""),
        "pivot_async": (follow + ["--async", "--text", "hello world"], ""),
        "html": (["--html", "--text", "<b>hello</b> world <i>again</i>"], ""),
        "alignment": (["--alignment", "--text", "hello world"], ""),
        "exact": (["--exact", "--text", "hello world"], ""),
        "numerics": (["--kv-dtype", "int8", "--argmax-method", "packed_bf16",
                      "--text", "hello world"], ""),
        "npz": (["--model", "model.npz", "--text", "hello world"], ""),
        "layers": (["--encoder-layers", "2", "--num-heads", "4", "--text", "the cat"], ""),
    }


MODES = list(_modes(""))


@pytest.mark.parametrize("mode", MODES)
def test_translate_prints_what_the_jax_cli_prints(pkg, mode):
    extra, stdin = _modes(pkg)[mode]
    argv = ["translate", "--root", pkg, *extra]
    code, out, err = _port(*argv, "--device", "cpu", stdin=stdin)
    assert code == 0, err
    want = _jax(*argv, stdin=stdin)
    assert (code, out) == want[:2]
    assert out.strip()
    if mode == "async_poll":
        assert "words" in err
    if mode == "npz":  # the converted checkpoint serves the .bin's text
        assert out == _port(*argv[:-4], "--text", "hello world", "--device", "cpu")[1]


def test_translate_on_the_card_by_default(pkg):
    """No --device: the card. Without one the CLI fails, and nothing is
    translated on the CPU in its place."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_gpu.py covers it")
    code, out, err = _port("translate", "--root", pkg, "--text", "hello")
    assert code != 0 and out == ""
    assert "torch.cuda.is_available() is False" in err
    code, out, err = _port("translate", "--root", pkg, "--device", "cuda:0", "--text", "x")
    assert code != 0 and out == ""


def test_exit_codes(pkg, tmp_path):
    # A missing file: 1 in both packages, with the same message.
    argv = ["translate", "--root", str(tmp_path), "--text", "x"]
    port = _port(*argv, "--device", "cpu")
    assert port[0] == 1 and port == _jax(*argv)
    # --exact with a numerics flag: 2.
    argv = ["translate", "--root", pkg, "--exact", "--kv-dtype", "int8", "--text", "x"]
    port = _port(*argv, "--device", "cpu")
    assert port[0] == 2 and port == _jax(*argv)
    # More layers than the checkpoint holds: 1, MissingParameter.
    argv = ["translate", "--root", pkg, "--encoder-layers", "9", "--text", "x"]
    port = _port(*argv, "--device", "cpu")
    assert port[0] == 1 and "no parameter" in port[2]
    assert port[:2] == _jax(*argv)[:2]
    # Malformed HTML: 1.
    argv = ["translate", "--root", pkg, "--html", "--text", "<b <"]
    port = _port(*argv, "--device", "cpu")
    assert port[:2] == _jax(*argv)[:2]
    # A device that is no device.
    code, out, err = _port("translate", "--root", pkg, "--device", "tpu", "--text", "x")
    assert code == 1 and out == "" and "tpu" in err


def test_synth_convert_inspect_equal_the_jax_cli(tmp_path):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _port("synth", "--out", port_dir)[1] == f"synthetic package written to {port_dir}\n"
    assert _jax("synth", "--out", jax_dir)[1] == f"synthetic package written to {jax_dir}\n"
    for name in ("model.bin", "vocab.spm", "shortlist.bin"):
        with open(os.path.join(port_dir, name), "rb") as a, \
                open(os.path.join(jax_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    model = os.path.join(port_dir, "model.bin")
    port_npz, jax_npz = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port = _port("convert", model, port_npz)
    jax = _jax("convert", model, jax_npz)
    assert port[0] == jax[0] == 0
    assert port[1].replace(port_npz, "X") == jax[1].replace(jax_npz, "X")
    with np.load(port_npz) as a, np.load(jax_npz) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for path in (model, port_npz, jax_npz):
        port = _port("inspect", path)
        assert port[0] == 0 and port == _jax("inspect", path)
    assert "intgemm8" in _port("inspect", model)[1]


def _seed_repository(root):
    """A local browsermt-style inventory and a cached archive: what
    download unpacks with no network (tests/test_cli.py's seed). Only the
    cached model is downloaded here: any other would be fetched."""
    base = os.path.join(root, "slimt_tpu", "browsermt")
    os.makedirs(os.path.join(base, "archives"))
    inventory = {"models": [
        {"code": "en-xx-tiny", "name": "English-Whatever tiny",
         "url": "https://example.invalid/en-xx-tiny.tar.gz"},
        {"code": "xx-en-tiny", "name": "Whatever-English tiny",
         "url": "https://example.invalid/xx-en-tiny.tar.gz"},
    ]}
    with open(os.path.join(base, "models.json"), "w") as f:
        json.dump(inventory, f)
    with tarfile.open(os.path.join(base, "archives", "en-xx-tiny.tar.gz"), "w:gz") as tar:
        for name, payload in (("en-xx-tiny/config.intgemm8.yml", b"models:\n  - model.bin\n"),
                              ("en-xx-tiny/model.bin", b"\x00" * 16)):
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))


def test_ls_and_offline_download_equal_the_jax_cli(tmp_path):
    roots = {"port": str(tmp_path / "p"), "jax": str(tmp_path / "j")}
    for root in roots.values():
        _seed_repository(root)
    steps = [
        ("ls", "--all"),
        ("ls",),
        ("download", "-m", "en-xx-tiny"),
        ("ls",),
        ("download", "-m", "nope"),
    ]
    for step in steps:
        results = [[s.replace(root, "R") for s in map(str, run(*step, "--repo-root", root))]
                   for run, root in ((_port, roots["port"]), (_jax, roots["jax"]))]
        assert results[0] == results[1], step
    assert _port("ls", "--root", str(tmp_path)) == _jax("ls", "--root", str(tmp_path))
    assert "en-xx-tiny" in _port("ls", "--repo-root", roots["port"])[1]
    assert os.path.exists(os.path.join(
        roots["port"], "slimt_tpu", "browsermt", "models", "en-xx-tiny", "en-xx-tiny",
        "config.intgemm8.yml"))
    from slimt_tpu_torch.repository import TranslateLocallyLike

    repo = TranslateLocallyLike("browsermt", "https://example.invalid/models.json",
                                root=roots["port"])
    assert repo.model_config_path("en-xx-tiny").endswith("config.intgemm8.yml")
    assert repo.models(filter_downloaded=True) == ["en-xx-tiny"]


def test_remote_url_equals_the_jax_client(pkg):
    """--url: the port's CLI as a fleet client of a port server on the
    CPU prints what the JAX CLI prints against the same server."""
    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.config import Config, preset
    from slimt_tpu_torch.server import TranslationServer, serve

    server = TranslationServer(Config(workers=1, cache_size=0))
    server.add_model("en-de", Model(preset.tiny(), Package(
        os.path.join(pkg, "model.bin"), os.path.join(pkg, "vocab.spm")), device="cpu"))
    httpd = serve(server, host="127.0.0.1", port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for argv in (["--remote-model", "en-de", "--text", "hello world"],
                     ["--async", "--poll", "0.01", "--text", "hello world"],
                     ["--remote-model", "nope", "--text", "x"]):
            port = _port("translate", "--url", url, *argv)
            assert port[:2] == _jax("translate", "--url", url, *argv)[:2]
        assert port[0] == 1 and "404" in port[2]
        local = _port("translate", "--root", pkg, "--device", "cpu", "--text", "hello world")
        assert _port("translate", "--url", url, "--text", "hello world")[1] == local[1]
    finally:
        httpd.shutdown()
        server.close()
    code, _, err = _port("translate", "--url", "http://127.0.0.1:1", "--text", "x")
    assert code == 1 and "cannot reach" in err


def test_entry_point_subprocess_loads_no_jax(pkg):
    """`python -m slimt_tpu_torch translate --device cpu` as a user runs
    it: rc 0, the in-process text, and no jax or slimt_tpu module among
    its imports (`-X importtime` lists every one)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "slimt_tpu_torch", "translate",
         "--root", pkg, "--device", "cpu", "--text", "hello world"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert result.returncode == 0, result.stderr[-2000:]
    assert result.stdout == _port("translate", "--root", pkg, "--device", "cpu",
                                  "--text", "hello world")[1]
    imported = [line.rsplit("|", 1)[-1].strip() for line in result.stderr.splitlines()
                if line.startswith("import time:") and "|" in line]
    assert "slimt_tpu_torch.cli" in imported and "torch" in imported
    banned = [name for name in imported
              if name.split(".")[0] in ("jax", "jaxlib", "slimt_tpu")]
    assert not banned, banned


def _crosscheck():
    spec = importlib.util.spec_from_file_location(
        "crosscheck_e2e", os.path.join(REPO, "scripts", "crosscheck.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _text_mode(text: str) -> str:
    """`text` as subprocess.run(text=True) reads a child's stdout
    (universal newlines), the way scripts/crosscheck.py reads both CLIs."""
    return io.TextIOWrapper(io.BytesIO(text.encode("utf-8")), encoding="utf-8").read()


def _skeleton(text):
    tags = re.findall(r"<[^>]+>", text)
    words = sorted(re.sub(r"<[^>]+>", " ", text).split())
    return tags, words


def test_exact_cli_matches_the_reference_binary(tmp_path, monkeypatch):
    """scripts/crosscheck.py's e2e mode on the port: the reference's
    complete slimt-cli against the port's `translate --exact` on a synth
    package, tokenizer held identical (SLIMT_TPU_BATCH_BACKEND=native).
    Plain documents must be byte-identical; an HTML document identical,
    or equal in tag skeleton and token multiset (a tag placed on an
    attention tie may move)."""
    if not os.access(REFERENCE_CLI, os.X_OK):
        pytest.skip("crosscheck/bin/slimt_ref_cli is not executable here")
    crosscheck = _crosscheck()
    monkeypatch.setenv("SLIMT_TPU_BATCH_BACKEND", "native")
    root = str(tmp_path / "pkg")
    assert _port("synth", "--out", root)[0] == 0
    with open(os.path.join(root, "prefixes.txt"), "w") as f:
        f.write(crosscheck.PREFIX_FILE)
    with open(os.path.join(REPO, "data", "corpus.txt")) as f:
        corpus = [line.rstrip("\n") for line in f][:32]
    html_documents = [
        "<b>Hello world.</b> This <i>is</i> a test of <a href='x'>"
        "markup transfer</a>. Done!",
        "<p>First paragraph here.</p><p>Second one, with "
        "<em>emphasis</em> and a <br/>void tag.</p>",
        "Text with &amp; entities &lt;escaped&gt; and trailing "
        "words after <span class='x'>spans</span> end.",
    ]
    cases = [("\n".join(crosscheck.SPLIT_DOCS), False), ("\n".join(corpus), False)]
    cases += [(doc, True) for doc in html_documents]
    identical = 0
    for doc, html in cases:
        flag = ["--html"] if html else []
        ref = subprocess.run(
            [REFERENCE_CLI, "--root", root, "--model", "model.bin",
             "--vocabulary", "vocab.spm", "--ssplit", "prefixes.txt", *flag],
            input=doc, capture_output=True, text=True, check=True, timeout=300)
        # Drop the reference's 4-line config echo (app/main.cc:73-76).
        want = "\n".join(ref.stdout.splitlines()[4:]).strip()
        code, out, err = _port("translate", "--root", root, "--ssplit", "prefixes.txt",
                               "--exact", "--device", "cpu", *flag, stdin=doc)
        assert code == 0, err
        got = _text_mode(out).strip()
        assert want
        if got == want:
            identical += 1
        else:
            assert html, "a plain document differs from the reference binary"
            assert _skeleton(got) == _skeleton(want)
    assert identical >= 3
