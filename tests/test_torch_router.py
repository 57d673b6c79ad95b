"""The port's router (slimt_tpu_torch.runtime.router) over two port
servers with CPU models: routing, batch sharding in order, model affinity,
the job API, failover, ejection and the all-down answers.

No test waits on the router's background sweep: each router sweeps every
hour, and a test that needs a sweep calls check_backends() itself. A dead
backend is a socket bound and never listening, held open for the test, so
its port cannot be taken by another process while the router dials it.
"""

import json
import socket
import urllib.error
import urllib.request
from contextlib import closing

import pytest

pytest.importorskip("torch")

from slimt_tpu_torch import Model, ModelConfig, Package  # noqa: E402
from slimt_tpu_torch.config import Config  # noqa: E402
from slimt_tpu_torch.runtime.router import Router  # noqa: E402
from slimt_tpu_torch.runtime.router import serve as serve_router  # noqa: E402
from slimt_tpu_torch.server import TranslationServer  # noqa: E402
from slimt_tpu_torch.server import serve as serve_backend  # noqa: E402

from .helpers import make_package  # noqa: E402

CONFIG = ModelConfig(encoder_layers=2, decoder_layers=2, num_heads=4)
NEVER = 3600.0  # the routers' sweep interval: no sweep runs during a test


def _model(seed):
    package = make_package(seed=seed)
    return Model(CONFIG, Package(package.model, package.vocabulary), device="cpu")


def _request(url, path, payload=None, timeout=120):
    request = url + path
    if payload is not None:
        request = urllib.request.Request(
            url + path, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def dead():
    """URLs of backends that refuse every connection."""
    sockets = []

    def make():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))  # bound, not listening: refused
        sockets.append(sock)
        return f"http://127.0.0.1:{sock.getsockname()[1]}"

    yield make
    for sock in sockets:
        sock.close()


@pytest.fixture(scope="module")
def models():
    return {"en-de": _model(0), "de-en": _model(1)}


@pytest.fixture(scope="module")
def backends(models):
    """Three port servers: both models, both models, en-de alone."""
    holdings = (("en-de", "de-en"), ("en-de", "de-en"), ("en-de",))
    servers, httpds = [], []
    for names in holdings:
        server = TranslationServer(Config(workers=1, cache_size=0))
        for name in names:
            server.add_model(name, models[name])
        servers.append(server)
        httpds.append(serve_backend(server, host="127.0.0.1", port=0))
    yield [f"http://127.0.0.1:{h.server_address[1]}" for h in httpds]
    for httpd, server in zip(httpds, servers):
        httpd.shutdown()
        server.close()


def _route(urls, **kwargs):
    router = Router(urls, health_interval=NEVER, **kwargs)
    httpd = serve_router(router, host="127.0.0.1", port=0)
    return router, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture
def fleet(backends):
    router, httpd, url = _route(backends[:2], min_shard=2)
    yield url, router
    httpd.shutdown()
    router.close()


def test_health_aggregates(fleet, backends):
    url, _ = fleet
    status, body = _request(url, "/health")
    assert status == 200
    assert body["status"] == "ok" and body["healthy_backends"] == 2
    assert body["models"] == ["de-en", "en-de"]
    assert set(body["backends"]) == set(backends[:2])


def test_single_text_routes_as_the_backend_answers(fleet, backends):
    url, _ = fleet
    payload = {"text": "hello world", "model": "en-de", "detail": True}
    status, body = _request(url, "/translate", payload)
    assert status == 200 and body["source"] == "hello world"
    assert (status, body) == _request(backends[0], "/translate", payload)


@pytest.mark.parametrize("detail", [False, True])
def test_batch_shards_across_backends_in_order(fleet, backends, detail):
    url, router = fleet
    texts = [f"hello world {i}" for i in range(8)]
    payload = {"texts": texts, "model": "en-de", "detail": detail}
    status, body = _request(url, "/translate", payload)
    assert status == 200 and len(body["targets"]) == len(texts)
    # The same batch unsharded through one backend: the same targets in
    # the same order.
    assert (status, body) == _request(backends[1], "/translate", payload)
    if detail:
        assert [d["source"]["text"] for d in body["detail"]] == texts


def test_application_errors_pass_through(fleet):
    url, _ = fleet
    status, body = _request(url, "/translate", {"text": "x", "model": "nope"})
    assert status == 404 and "nope" in body["error"]
    assert _request(url, "/translate", {"model": "en-de"})[0] == 400
    assert _request(url, "/nothing")[0] == 404


def test_model_affinity_heterogeneous_fleet(backends):
    """de-en lives on the first backend only: its requests and batches
    route there; en-de shards over both."""
    router, httpd, url = _route([backends[2], backends[0]], min_shard=2)
    try:
        status, health = _request(url, "/health")
        assert health["models"] == ["de-en", "en-de"]
        for model in ("de-en", "en-de", "de-en"):
            status, body = _request(url, "/translate", {"text": "hello world", "model": model})
            assert status == 200, body
        texts = [f"hello world {i}" for i in range(8)]
        for model in ("de-en", "en-de"):
            payload = {"texts": texts, "model": model}
            assert _request(url, "/translate", payload) == _request(
                backends[0], "/translate", payload)
    finally:
        httpd.shutdown()
        router.close()


def test_job_api_proxies_with_affinity(backends):
    """Jobs submitted through the router poll the backend that owns them;
    a backend with no models is not eligible."""
    import time

    with closing(TranslationServer(Config(workers=1, cache_size=0))) as empty:
        empty_httpd = serve_backend(empty, host="127.0.0.1", port=0)
        urls = [f"http://127.0.0.1:{empty_httpd.server_address[1]}", backends[2]]
        router, httpd, url = _route(urls, min_shard=2)
        try:
            status, body = _request(url, "/submit", {"text": "hello world", "model": "en-de"})
            assert status == 200, body
            for _ in range(600):
                status, poll = _request(url, f"/job/{body['job']}")
                assert status == 200, poll
                if poll["done"]:
                    break
                time.sleep(0.05)
            assert poll["done"] and poll["source"] == "hello world" and poll["target"]
            # Consumed: dropped on the router and on the backend.
            assert _request(url, f"/job/{body['job']}")[0] == 404
            assert _request(url, "/job/zzz")[0] == 404
            texts = [f"hello world {i}" for i in range(8)]
            status, body = _request(url, "/translate", {"texts": texts, "model": "en-de"})
            assert status == 200 and len(body["targets"]) == 8
        finally:
            httpd.shutdown()
            router.close()
            empty_httpd.shutdown()


def test_failover_and_ejection(backends, dead):
    """A backend that died after the last sweep: requests fail over to
    the live one, the failed call marks it, and the next sweep keeps it
    out."""
    dead_url = dead()
    router, httpd, url = _route([dead_url, backends[0]], min_shard=2)
    try:
        assert _request(url, "/health")[1]["status"] == "degraded"
        router.backends[0].mark(True)  # died since the sweep
        status, body = _request(url, "/translate", {"text": "hello world", "model": "en-de"})
        assert status == 200 and body["source"] == "hello world"
        assert router.backends[0].healthy is False
        router.backends[0].mark(True)
        texts = [f"hello world {i}" for i in range(6)]
        status, body = _request(url, "/translate", {"texts": texts, "model": "en-de"})
        assert status == 200 and len(body["targets"]) == 6
        router.check_backends()
        status, health = _request(url, "/health")
        assert status == 200 and health["status"] == "degraded"
        assert health["healthy_backends"] == 1
        assert health["backends"][dead_url]["healthy"] is False
        assert health["backends"][dead_url]["error"]
    finally:
        httpd.shutdown()
        router.close()


def test_all_backends_down_is_502_then_503(dead):
    router, httpd, url = _route([dead(), dead()])
    try:
        status, body = _request(url, "/translate", {"text": "hello", "model": "en-de"})
        assert status == 502 and "all backends failed" in body["error"]
        status, health = _request(url, "/health")
        assert status == 503 and health["status"] == "down"
        assert health["healthy_backends"] == 0
    finally:
        httpd.shutdown()
        router.close()
