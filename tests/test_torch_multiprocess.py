"""Two processes of the port's data-parallel serving
(python -m slimt_tpu_torch.parallel.demo) over gloo on the CPU: each holds
four mesh ranks of one global eight-rank data axis, feeds its block of
each batch's rows and all-gathers the results, so both print the same
eight translations, equal to one process's Model on one device.
"""

import os
import socket
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from slimt_tpu_torch import Blocking, Config, Model  # noqa: E402
from slimt_tpu_torch.parallel import demo  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _translations(text):
    return [line.split("->", 1)[1] for line in text.splitlines() if "->" in line]


def test_two_gloo_processes_translate_alike():
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "slimt_tpu_torch.parallel.demo", str(i), "2",
             f"127.0.0.1:{port}", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
        for i in range(2)
    ]
    outputs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=60)
            assert proc.returncode == 0, out
            outputs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    t0, t1 = _translations(outputs[0]), _translations(outputs[1])
    assert len(t0) == len(demo.CORPUS)
    assert t0 == t1
    assert all("DONE devices=8 local=4" in out for out in outputs)

    config, package = demo.build_package()
    with Blocking(Config(cache_size=0)) as service:
        one = [repr(r.target.text) for r in service.translate(
            Model(config, package, device="cpu"), demo.CORPUS)]
    assert [t.strip() for t in t0] == one
