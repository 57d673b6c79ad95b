"""Minimal HTTP serving frontend (the port's copy of slimt_tpu.server).

The reference embeds via pybind11/JNI (bindings/); this framework is
Python-native, so the cross-language embedding story is a JSON/HTTP
endpoint over the Async service instead — one process per host, each
serving its cards. The port's server speaks the JAX package's HTTP API;
its models run on the card unless `--device cpu` is given.

    POST /translate   {"text": "...", "model": "<name>", "html": false,
                       "pivot": "<name>"?}
                      or {"texts": ["...", ...], ...} — batched,
                      returns {"targets": [...]}; lists of
                      `bulk_threshold`+ lines ride the request-free
                      bulk lane (identical Responses, less host work),
                      smaller lists share the Async batching window.
    POST /submit      same payload; returns {"job": "<id>"} immediately
                      (always the Async streaming lane — jobs have
                      live progress).
    GET  /job/<id>    {"done": false, "progress": {wps, words: [p,q],
                      segments: [p,q], parts: [p,q]}} while running —
                      the reference CLI's Handle::info poll meter
                      (app/main.cc:119-157) over HTTP; when done, the
                      /translate response body (job is consumed by the
                      fetch that returns done=true).
    GET  /health      {"status": "ok", "models": [...]}
    GET  /health/devices  a trivial product on each device the models
                      run on (runtime.health.probe_devices): 200 with
                      {"ok": true, "devices": {...}}, else 503
    GET  /stats       live serving counters and wps/occupancy meters,
                      and the kernel launches of this process

Run: python -m slimt_tpu_torch.server --root pkg/ --port 8080
(SLIMT_TPU_TORCH_STUB_DEVICE=1 in its environment stubs the device
forward, a measurement tool: `stub_if_asked`.)
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import threading
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from slimt_tpu_torch.bindings import to_json
from slimt_tpu_torch.config import Config
from slimt_tpu_torch.runtime.response import Options
from slimt_tpu_torch.runtime.service import Async, Blocking


class TranslationServer:
    """`bulk_threshold`: batched {"texts": [...]} requests at or above
    this many lines run on the request-free bulk lane (Blocking
    translate_bulk / pivot — less host work than the streaming path,
    identical Responses) on the handler thread, serialized by a lock;
    smaller batches and single texts keep the Async streaming path so
    concurrent clients share device batches."""

    def __init__(
        self, config: Optional[Config] = None, bulk_threshold: int = 32
    ):
        config = config or Config(workers=2)
        self.service = Async(config)
        self.blocking = Blocking(config)
        self.blocking.cache = self.service.cache  # one cache, both lanes
        from concurrent.futures import ThreadPoolExecutor

        self.bulk_threshold = bulk_threshold
        # One worker = bulk requests run serialized (concurrent exhaust
        # loops would fight over the device); submitting instead of
        # calling inline lets each request honor its own timeout —
        # a wedged translation turns into a 504 for it and queued 504s
        # behind it, never a silent hang of the handler threads.
        self._bulk_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="server-bulk"
        )
        self._stats_lock = threading.Lock()
        self._counts = {"requests": 0, "lines": 0, "errors": 0}
        self._jobs: Dict[str, dict] = {}
        self._jobs_lock = threading.Lock()
        self._job_ids = itertools.count()
        self.max_jobs = 4096
        # Abandoned jobs (submitted, never polled to completion) are
        # evicted after this many seconds so the table cannot fill up
        # permanently; polling resets nothing — the clock runs from
        # submission, long past any sane poll loop.
        self.job_ttl_s = 3600.0
        self.models: Dict[str, object] = {}

    def add_model(self, name: str, model) -> None:
        self.models[name] = model

    def device_kinds(self) -> list:
        """The device types the models run on ("cuda" with no model):
        what /health/devices probes."""
        return sorted({m.device.type for m in self.models.values()}) or ["cuda"]

    def _resolve(self, payload: dict):
        name = payload.get("model")
        if name is None and len(self.models) == 1:
            name = next(iter(self.models))
        if name not in self.models:
            raise KeyError(f"unknown model {name!r}")
        model = self.models[name]
        options = Options(
            html=bool(payload.get("html", False)),
            alignment=bool(payload.get("alignment", False)),
        )
        pivot_name = payload.get("pivot")
        pivot_model = None
        if pivot_name:
            if pivot_name not in self.models:
                raise KeyError(f"unknown pivot model {pivot_name!r}")
            pivot_model = self.models[pivot_name]
        return model, pivot_model, options

    def handle(self, payload: dict) -> dict:
        model, pivot_model, options = self._resolve(payload)
        timeout = payload.get("timeout", 300)

        if "texts" in payload:
            texts = list(payload["texts"])
            if len(texts) >= self.bulk_threshold:
                if pivot_model is not None:
                    work = lambda: self.blocking.pivot(
                        model, pivot_model, texts, options
                    )
                else:
                    work = lambda: self.blocking.translate_bulk(
                        model, texts, options
                    )
                responses = self._bulk_pool.submit(work).result(
                    timeout=timeout
                )
            else:
                if pivot_model is not None:
                    handles = [
                        self.service.pivot(model, pivot_model, t, options)
                        for t in texts
                    ]
                else:
                    handles = self.service.translate_many(
                        model, texts, options
                    )
                responses = [h.result(timeout=timeout) for h in handles]
            return {
                "targets": [r.target.text for r in responses],
                "detail": [json.loads(to_json(r)) for r in responses]
                if payload.get("detail")
                else None,
            }

        if pivot_model is not None:
            handle = self.service.pivot(
                model, pivot_model, payload["text"], options
            )
        else:
            handle = self.service.translate(model, payload["text"], options)
        response = handle.result(timeout=timeout)
        return {
            "target": response.target.text,
            "source": response.source.text,
            "detail": json.loads(to_json(response))
            if payload.get("detail")
            else None,
        }

    def submit(self, payload: dict) -> str:
        """Enqueue without waiting; returns a job id for /job/<id>.
        Always the Async streaming lane — its Handles carry the live
        progress the poll endpoint reports."""
        model, pivot_model, options = self._resolve(payload)
        if "texts" in payload:
            texts = list(payload["texts"])
            single = False
            if pivot_model is not None:
                handles = [
                    self.service.pivot(model, pivot_model, t, options)
                    for t in texts
                ]
            else:
                handles = self.service.translate_many(model, texts, options)
        else:
            single = True
            if pivot_model is not None:
                handles = [
                    self.service.pivot(
                        model, pivot_model, payload["text"], options
                    )
                ]
            else:
                handles = [
                    self.service.translate(model, payload["text"], options)
                ]
        import time

        with self._jobs_lock:
            if len(self._jobs) >= self.max_jobs:
                self._evict_expired_locked()
            if len(self._jobs) >= self.max_jobs:
                raise RuntimeError(
                    f"job table full ({self.max_jobs}); fetch or drop jobs"
                )
            job_id = f"j{next(self._job_ids)}"
            self._jobs[job_id] = {
                "handles": handles,
                "single": single,
                "detail": bool(payload.get("detail")),
                "created": time.monotonic(),
                "lock": threading.Lock(),
            }
        return job_id

    def _evict_expired_locked(self) -> None:
        """Drop jobs past job_ttl_s (abandoned clients). Caller holds
        _jobs_lock."""
        import time

        now = time.monotonic()
        expired = [
            jid for jid, job in self._jobs.items()
            if now - job["created"] > self.job_ttl_s
        ]
        for jid in expired:
            del self._jobs[jid]

    def poll_job(self, job_id: str) -> tuple:
        """(status, body): progress while running, the /translate
        response body once done. The fetch that observes done=true
        consumes the job."""
        with self._jobs_lock:
            job = self._jobs.get(job_id)
        if job is None:
            return 404, {"error": f"unknown job {job_id!r}"}
        # Per-job lock: Handle.info() mutates the handle (multi-part
        # pivot advance) and the consume path must be single-shot even
        # under concurrent pollers of the same id.
        with job["lock"]:
            handles = job["handles"]
            if not all(h.future.done() for h in handles):
                infos = [h.info() for h in handles]
                return 200, {
                    "done": False,
                    "progress": {
                        "wps": round(sum(i.wps for i in infos), 1),
                        "words": [
                            sum(i.words.p for i in infos),
                            sum(i.words.q for i in infos),
                        ],
                        "segments": [
                            sum(i.segments.p for i in infos),
                            sum(i.segments.q for i in infos),
                        ],
                        "parts": [
                            sum(i.parts.p for i in infos),
                            sum(i.parts.q for i in infos),
                        ],
                    },
                }
            # Build the full response body BEFORE consuming the job:
            # a serialization error must not lose the result.
            try:
                responses = [h.result(timeout=0) for h in handles]
            except Exception as e:  # noqa: BLE001 — surfaced in body
                body = {"done": True, "error": f"{type(e).__name__}: {e}"}
            else:
                detail = (
                    [json.loads(to_json(r)) for r in responses]
                    if job["detail"]
                    else None
                )
                if job["single"]:
                    r = responses[0]
                    body = {
                        "done": True,
                        "target": r.target.text,
                        "source": r.source.text,
                        "detail": detail[0] if detail else None,
                    }
                else:
                    body = {
                        "done": True,
                        "targets": [r.target.text for r in responses],
                        "detail": detail,
                    }
        with self._jobs_lock:
            self._jobs.pop(job_id, None)
        return 200, body

    def record(self, lines: int = 0, error: bool = False) -> None:
        with self._stats_lock:
            self._counts["requests"] += 1
            self._counts["lines"] += lines
            if error:
                self._counts["errors"] += 1

    def stats(self) -> dict:
        """Live serving metrics (the reference's exhaust-loop wps and
        occupancy meters, slimt/Frontend.cc:44-59, surfaced per lane)."""

        def lane(meters):
            return {
                "batches": meters.batches,
                "wps_avg": round(meters.wps(), 1),
                "occupancy_avg": round(meters.occupancy.average(), 4),
            }

        from slimt_tpu_torch.ops import launches

        with self._stats_lock:
            counts = dict(self._counts)
        return {
            **counts,
            "streaming": lane(self.service.meters),
            "bulk": lane(self.blocking.meters),
            "workers": self.service.config.workers,
            "bulk_threshold": self.bulk_threshold,
            "models": sorted(self.models),
            # Each Model's forwards, rows, tokens and graph cache (Model.counters).
            "model": {name: model.counters() for name, model in sorted(self.models.items())},
            # This process's kernel launches (0 on the CPU, which runs
            # the plain versions, and under a stubbed device forward).
            "launches": launches.snapshot(),
        }

    def close(self):
        self._bulk_pool.shutdown(wait=False)
        self.service.close()
        self.blocking.close()


def make_handler(server: TranslationServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _reply(self, code: int, body: dict):
            data = json.dumps(body).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            try:
                if self.path == "/health":
                    self._reply(
                        200,
                        {"status": "ok", "models": sorted(server.models)},
                    )
                elif self.path == "/stats":
                    self._reply(200, server.stats())
                elif self.path.startswith("/job/"):
                    status, body = server.poll_job(
                        self.path[len("/job/"):]
                    )
                    self._reply(status, body)
                elif self.path == "/health/devices":
                    from slimt_tpu_torch.runtime.health import probe_devices

                    probe = probe_devices(kinds=server.device_kinds())
                    self._reply(200 if probe.get("ok") else 503, probe)
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def do_POST(self):
            if self.path not in ("/translate", "/submit"):
                self._reply(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(length) or b"{}"
                try:
                    payload = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._reply(400, {"error": f"invalid JSON body: {e}"})
                    return
                if not isinstance(payload, dict):
                    self._reply(
                        400, {"error": "request body must be a JSON object"}
                    )
                    return
                if "text" not in payload and "texts" not in payload:
                    self._reply(
                        400,
                        {"error": "missing required field 'text' or 'texts'"},
                    )
                    return
                lines = (
                    len(payload["texts"]) if "texts" in payload else 1
                )
                if self.path == "/submit":
                    body = {"job": server.submit(payload)}
                else:
                    body = server.handle(payload)
                server.record(lines=lines)
                self._reply(200, body)
            except KeyError as e:
                server.record(error=True)
                self._reply(404, {"error": str(e)})
            except FuturesTimeout:
                server.record(error=True)
                self._reply(
                    504, {"error": "translation timed out server-side"}
                )
            except Exception as e:  # noqa: BLE001
                server.record(error=True)
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_httpd(
    server: TranslationServer, host: str = "127.0.0.1", port: int = 8080
) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((host, port), make_handler(server))


def serve(server: TranslationServer, host: str = "127.0.0.1", port: int = 8080):
    httpd = make_httpd(server, host, port)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd


# The port's own switch: a JAX fleet's SLIMT_TPU_STUB_DEVICE stubs no
# port server.
STUB_VARIABLE = "SLIMT_TPU_TORCH_STUB_DEVICE"


def stub_if_asked(model, environ=None) -> bool:
    """Stub `model`'s device forward (utils.stub_device_forward) where
    SLIMT_TPU_TORCH_STUB_DEVICE=1, and say so; never otherwise. A
    measurement knob (`python -m slimt_tpu_torch.fleet budget`): N servers
    then measure host cores and transport, not the card they share. Never
    a serving mode."""
    environ = os.environ if environ is None else environ
    if environ.get(STUB_VARIABLE) != "1":
        return False
    from slimt_tpu_torch.utils import stub_device_forward

    stub_device_forward(model)
    print(f"device forward STUBBED ({STUB_VARIABLE}=1)", flush=True)
    return True


def main(argv=None) -> int:
    from slimt_tpu_torch.config import preset
    from slimt_tpu_torch.models.model import Model, Package

    parser = argparse.ArgumentParser()
    parser.add_argument("--root", required=True)
    parser.add_argument("--name", default="default")
    parser.add_argument("--model", default="model.bin")
    parser.add_argument("--vocabulary", default="vocab.spm")
    parser.add_argument("--shortlist", default=None)
    parser.add_argument("--preset", default="tiny")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument(
        "--device", default="cuda",
        help="the model's device: cuda (the card; no card is an error) or cpu",
    )
    parser.add_argument(
        "--warmup", action="store_true",
        help="run the serving shape buckets once before accepting traffic",
    )
    args = parser.parse_args(argv)

    join = lambda p: os.path.join(args.root, p) if p else None
    model = Model(
        getattr(preset, args.preset)(),
        Package(
            model=join(args.model),
            vocabulary=join(args.vocabulary),
            shortlist=join(args.shortlist),
        ),
        device=args.device,
    )
    stub_if_asked(model)
    if args.warmup:
        runs = model.warmup()
        print(f"warmed {runs} shape buckets")
    server = TranslationServer(Config(workers=args.workers))
    server.add_model(args.name, model)
    httpd = make_httpd(server, args.host, args.port)
    print(f"serving {args.name} on {args.host}:{args.port}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
