"""The port's HTTP server (slimt_tpu_torch.server) against the JAX
package's, in-process, with CPU models built from the same package bytes:
every endpoint of tests/test_server.py, and each body's text fields equal
to the JAX server's; the bulk lane against the streaming lane; a job
polled to its end; /health/devices probing the models' own device.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

pytest.importorskip("torch")

from slimt_tpu.config import Config as JaxConfig  # noqa: E402
from slimt_tpu.models.model import Model as JaxModel  # noqa: E402
from slimt_tpu.server import TranslationServer as JaxServer  # noqa: E402
from slimt_tpu.server import serve as jax_serve  # noqa: E402
from slimt_tpu_torch import Model, ModelConfig, Package  # noqa: E402
from slimt_tpu_torch.config import Config  # noqa: E402
from slimt_tpu_torch.server import TranslationServer, make_httpd, serve  # noqa: E402

from .helpers import TINY_TEST_CONFIG, make_package  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)


def port_model(seed):
    package = make_package(seed=seed)
    return Model(CONFIG, Package(package.model, package.vocabulary), device="cpu")


def jax_model(seed):
    return JaxModel(TINY_TEST_CONFIG, make_package(seed=seed))


def _start(server, serve_fn):
    httpd = serve_fn(server, host="127.0.0.1", port=0)
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def endpoints():
    """The port's and the JAX package's servers, each holding en-de (seed
    0) and de-en (seed 1), and a port server whose bulk lane takes 4+ texts
    beside one that never takes it."""
    servers = {
        "port": TranslationServer(Config(workers=1, cache_size=0)),
        "jax": JaxServer(JaxConfig(workers=1, cache_size=0)),
        "bulk": TranslationServer(Config(workers=1, cache_size=0), bulk_threshold=4),
        "streaming": TranslationServer(Config(workers=1, cache_size=0),
                                       bulk_threshold=10**9),
    }
    models = {seed: port_model(seed) for seed in (0, 1)}
    for key, server in servers.items():
        for name, seed in (("en-de", 0), ("de-en", 1)):
            server.add_model(name, jax_model(seed) if key == "jax" else models[seed])
    started = {key: _start(server, jax_serve if key == "jax" else serve)
               for key, server in servers.items()}
    yield {key: url for key, (_, url) in started.items()}
    for key, (httpd, _) in started.items():
        httpd.shutdown()
        servers[key].close()


def _request(url, path, payload=None, data=None, timeout=120):
    if payload is not None or data is not None:
        data = data if data is not None else json.dumps(payload).encode("utf-8")
        request = urllib.request.Request(
            url + path, data=data, headers={"Content-Type": "application/json"})
    else:
        request = url + path
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _same_body(got, want):
    """Equal (status, body) replies, but for the soft alignments of a
    detail, which are float attention weights: equal within 1e-5 (f32
    summation order)."""
    got, want = json.loads(json.dumps(got)), json.loads(json.dumps(want))
    alignments = []
    for _, body in (got, want):
        detail = body.get("detail")
        items = detail if isinstance(detail, list) else [detail] if detail else []
        alignments.append([item.pop("alignments") for item in items])
    assert got == want
    for a, b in zip(*alignments):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=1e-5)
    return True


def _both(endpoints, path, payload=None, data=None):
    port = _request(endpoints["port"], path, payload, data)
    jax = _request(endpoints["jax"], path, payload, data)
    return port, jax


def _poll_until_done(url, job, tries=600):
    import time

    for _ in range(tries):
        status, body = _request(url, f"/job/{job}")
        assert status == 200, body
        if body["done"]:
            return body
        time.sleep(0.05)
    raise AssertionError(f"job {job} never finished")


def test_health(endpoints):
    port, jax = _both(endpoints, "/health")
    assert port == jax == (200, {"status": "ok", "models": ["de-en", "en-de"]})


@pytest.mark.parametrize("payload", [
    {"text": "hello world", "model": "en-de"},
    {"text": "hello world . the cat sat .", "model": "de-en", "detail": True},
    {"text": "<b>hello</b> world", "model": "en-de", "html": True},
    {"text": "hello world", "model": "en-de", "alignment": True, "detail": True},
    {"text": "hello world", "model": "en-de", "pivot": "de-en"},
    {"texts": ["hello world", "a quick brown test", "hello world"], "model": "en-de"},
    {"texts": ["hello"], "model": "en-de", "detail": True},
    {"texts": ["hello world"], "model": "en-de", "pivot": "de-en"},
], ids=["single", "detail", "html", "alignment", "pivot", "texts", "texts_detail",
        "texts_pivot"])
def test_translate_bodies_equal_the_jax_server(endpoints, payload):
    port, jax = _both(endpoints, "/translate", payload)
    assert port[0] == 200, port
    assert _same_body(port, jax)
    if "texts" in payload:
        assert len(port[1]["targets"]) == len(payload["texts"])
    else:
        assert port[1]["source"] == payload["text"] and port[1]["target"]


@pytest.mark.parametrize("case", ["unknown_model", "not_object", "bad_json", "no_text",
                                  "unknown_path"])
def test_errors_equal_the_jax_server(endpoints, case):
    path, payload, data = {
        "unknown_model": ("/translate", {"text": "x", "model": "nope"}, None),
        "not_object": ("/translate", ["not", "an", "object"], None),
        "bad_json": ("/translate", None, b"{not json"),
        "no_text": ("/translate", {"model": "en-de"}, None),
        "unknown_path": ("/nothing", {"text": "x"}, None),
    }[case]
    port, jax = _both(endpoints, path, payload, data)
    assert port[0] in (400, 404)
    assert port[0] == jax[0]
    if case != "bad_json":  # the decoder's message names its position
        assert port == jax
    assert _both(endpoints, "/job/nope") == ((404, {"error": "unknown job 'nope'"}),) * 2


def test_bulk_lane_matches_streaming_lane(endpoints):
    for payload in (
        {"texts": [f"hello world {i}" for i in range(6)], "model": "en-de", "detail": True},
        {"texts": [f"hello world {i}" for i in range(5)], "model": "en-de", "pivot": "de-en"},
    ):
        via_bulk = _request(endpoints["bulk"], "/translate", payload)
        via_streaming = _request(endpoints["streaming"], "/translate", payload)
        assert via_bulk[0] == 200
        assert via_bulk == via_streaming
        assert _same_body(via_bulk, _request(endpoints["jax"], "/translate", payload))
    status, stats = _request(endpoints["bulk"], "/stats")
    assert stats["bulk"]["batches"] >= 1 and stats["bulk_threshold"] == 4


def test_job_submit_poll_fetch(endpoints):
    for payload in ({"text": "hello world", "model": "en-de"},
                    {"texts": [f"hello world {i}" for i in range(3)], "model": "en-de",
                     "detail": True}):
        done = {}
        for key in ("port", "jax"):
            status, body = _request(endpoints[key], "/submit", payload)
            assert status == 200
            done[key] = _poll_until_done(endpoints[key], body["job"])
            # The fetch that returned done=true consumed the job.
            assert _request(endpoints[key], f"/job/{body['job']}")[0] == 404
        assert _same_body((200, done["port"]), (200, done["jax"]))
        assert done["port"]["done"] is True


def test_job_progress_shape():
    """A zero-worker service never completes: the poll keeps reporting
    Handle::info's progress shape."""
    server = TranslationServer(Config(workers=0, cache_size=0))
    server.add_model("en-de", port_model(0))
    httpd, url = _start(server, serve)
    try:
        status, body = _request(url, "/submit", {"text": "hello world", "model": "en-de"})
        assert status == 200
        status, poll = _request(url, f"/job/{body['job']}")
        assert status == 200 and poll["done"] is False
        assert poll["progress"]["words"][1] > 0 and poll["progress"]["words"][0] == 0
        assert poll["progress"]["parts"] == [1, 1]
    finally:
        httpd.shutdown()
        server.close()


def test_stats_and_timeout(endpoints):
    url = endpoints["bulk"]
    _request(url, "/translate", {"texts": [f"hi there {i}" for i in range(6)],
                                 "model": "en-de"})
    _request(url, "/translate", {"text": "hello stats", "model": "en-de"})
    _request(url, "/translate", {"text": "x", "model": "nope"})
    status, body = _request(url, "/translate", {
        "texts": [f"hello timeout {i}" for i in range(50)], "model": "en-de",
        "timeout": 1e-6})
    assert status == 504 and "timed out" in body["error"]
    status, stats = _request(url, "/stats")
    assert status == 200
    assert stats["requests"] >= 3 and stats["lines"] >= 7 and stats["errors"] >= 2
    assert stats["models"] == ["de-en", "en-de"]
    assert stats["bulk"]["batches"] >= 1 and stats["streaming"]["batches"] >= 1
    assert stats["streaming"]["wps_avg"] > 0
    assert 0 < stats["streaming"]["occupancy_avg"] <= 1
    counters = stats["model"]["en-de"]
    assert counters["forwards"] >= 2 and counters["rows"] >= 7
    assert counters["target_tokens"] <= counters["row_steps"]


def test_job_table_ttl_eviction():
    server = TranslationServer(Config(workers=0, cache_size=0))
    server.add_model("en-de", port_model(0))
    try:
        server.max_jobs = 2
        server.job_ttl_s = 0.0  # everything is immediately expired
        for _ in range(5):  # would overflow max_jobs without eviction
            server.submit({"text": "hello", "model": "en-de"})
        server.job_ttl_s = 3600.0
        with pytest.raises(RuntimeError, match="job table full"):
            for _ in range(3):
                server.submit({"text": "hello", "model": "en-de"})
    finally:
        server.close()


def test_health_devices_probes_the_models_device(endpoints):
    """/health/devices runs the probe on the device the models hold: the
    CPU here. With no model it asks for the card, and without one answers
    503 with the reason; the CPU never answers for the card."""
    import torch

    status, body = _request(endpoints["port"], "/health/devices")
    assert (status, body) == (200, {"ok": True, "devices": {"cpu": True}})
    empty = TranslationServer(Config(workers=1, cache_size=0))
    httpd = make_httpd(empty, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        status, body = _request(f"http://127.0.0.1:{httpd.server_address[1]}",
                                "/health/devices")
    finally:
        httpd.shutdown()
        thread.join(timeout=30)
        empty.close()
    assert not thread.is_alive()
    if torch.cuda.is_available():
        assert status == 200 and body["ok"] and "cpu" not in body["devices"]
    else:
        assert status == 503 and body["ok"] is False
        assert "torch.cuda.is_available() is False" in body["error"]

