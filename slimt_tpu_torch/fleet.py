"""Router fleets of the port's server: stubbed (budget) and decoding (scaling).

    python -m slimt_tpu_torch.fleet budget [--lines 10000] [--backends 1 2 3]
        [--device cuda]
    python -m slimt_tpu_torch.fleet scaling [--lines 2000] [--backends 1 2]
        [--device cuda]

Both modes start `python -m slimt_tpu_torch.server` processes on --device,
all serving one `python -m slimt_tpu_torch synth` package (at --emb-dim 256
and --ffn-dim 1536, tiny11's widths, so that the encoder layer kernel runs),
and put k of them behind the port's router (`python -m
slimt_tpu_torch.runtime.router`, which shards a batch of texts over its
backends in contiguous chunks). Each row pushes a warm batch, then the
corpus (seed 0, 6-23 words a line) three times, and keeps the best tokens/s.
Each row runs on processes of its own, fresh: every row's processes start at
once, then the rows run one after another.

`budget` stubs every backend's device forward (SLIMT_TPU_TORCH_STUB_DEVICE=1,
utils.stub_device_forward): HTTP, JSON, ingest, packing, completion and
detokenization run for real, the device not at all, so the rows measure
host cores and transport:
  local_bulk_tps  in-process Blocking.translate_bulk on the same package,
                  stubbed: one process's ceiling without transport;
  direct_tps      one backend, the client posting to it;
  router_tps[k]   k backends behind the router.
direct/local is the transport's cost (transport_cost_pct), router(1)/direct
the router hop's, router(k)/(k·router(1)) the fleet's efficiency.

`scaling` runs the same fleets un-stubbed: every backend decodes on --device.
On one card the backends share it, so this measures sharing one card, not
scaling across cards; the output says so.

Every answer must equal the in-process answer for the same package: one
TranslationServer in this process for each backend, holding a Model on
--device (stubbed in budget), given the chunks the router gives that backend.
Each backend's kernel launches are read from its /stats: none in budget, the
int8 affine (#1) and the encoder layer (#2) in every backend in scaling on the
card. A backend that never becomes healthy, launches wrongly or answers
wrongly fails the run (a non-zero exit). Every process started is stopped on
the way out.

The counterparts of the JAX package's scripts/fleet_budget.py and
scripts/scaling_demo.py.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request

from slimt_tpu_torch.config import Config

# The words of the JAX scripts' corpus.
WORDS = (
    "hello world goodbye this is a test of the translation engine "
    "quick brown fox jumps over lazy dog sentence splitting works"
).split()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Each mode's warm batch and defaults, as in the JAX scripts.
WARM = {"budget": 256, "scaling": 200}
DEFAULTS = {"budget": (10000, [1, 2, 3]), "scaling": (2000, [1, 2])}
WORKERS = 2  # each backend's --workers
ITERS = 3
SHARED = {"cuda": "the backends share one card: this measures sharing one card, "
                  "not scaling across cards",
          "cpu": "the backends share this host's cores"}


def corpus(lines, seed=0):
    """`lines` lines of 6-23 words drawn from WORDS."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, rng.integers(6, 24))) for _ in range(lines)]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Process:
    """A started server or router, its URL and its log file."""

    def __init__(self, argv, env, log_path):
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.log_path = log_path
        with open(log_path, "wb") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", *argv, "--port", str(self.port)],
                env=env, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)

    def tail(self, n=3000) -> str:
        with open(self.log_path, "rb") as log:
            return log.read().decode(errors="replace")[-n:]

    def wait_health(self, timeout=300) -> None:
        """Until /health says "ok"; raises if the process ends first or
        the time runs out."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(f"{self.url} exited with {self.proc.returncode} "
                                   f"before it was healthy:\n{self.tail()}")
            try:
                with urllib.request.urlopen(self.url + "/health", timeout=5) as r:
                    if json.loads(r.read()).get("status") == "ok":
                        return
            except OSError:
                pass
            time.sleep(0.25)
        raise RuntimeError(f"{self.url} never became healthy:\n{self.tail()}")

    def launches(self) -> dict:
        with urllib.request.urlopen(self.url + "/stats", timeout=60) as r:
            return json.loads(r.read())["launches"]


def stop_all(processes) -> None:
    for p in processes:
        if p.proc.poll() is None:
            p.proc.terminate()
    for p in processes:
        try:
            p.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            p.proc.kill()
            p.proc.wait(timeout=20)


def push(url, texts):
    """(tokens/s, targets, whitespace tokens) of one {"texts": ...} POST."""
    request = urllib.request.Request(
        url + "/translate", data=json.dumps({"texts": texts}).encode("utf-8"),
        headers={"Content-Type": "application/json"})
    start = time.perf_counter()
    with urllib.request.urlopen(request, timeout=1200) as resp:
        body = json.loads(resp.read())
    elapsed = time.perf_counter() - start
    targets = body["targets"]
    if len(targets) != len(texts):
        raise RuntimeError(f"{url}: {len(targets)} targets for {len(texts)} texts")
    tokens = sum(len(t.split()) for t in targets)
    return tokens / elapsed, targets, tokens


def chunks(texts, ways, min_shard=8):
    """The router's split of a batch over `ways` healthy backends
    (runtime/router.Router._handle_sharded): contiguous chunks, chunk i to
    backend i; a batch under max(min_shard, ways) goes whole to one."""
    if ways < 2 or len(texts) < max(min_shard, ways):
        return [texts]
    n = len(texts)
    bounds = [(i * n) // ways for i in range(ways + 1)]
    return [texts[bounds[i]:bounds[i + 1]] for i in range(ways)]


class Row:
    """One measured row: k backends, behind a router or posted to
    directly, and in this process one TranslationServer for each backend
    that answers what that backend must."""

    def __init__(self, label, k, routed, model, pkg, device, env, logs, started):
        """Starts the row's processes, each appended to `started` at once."""
        from slimt_tpu_torch.server import TranslationServer

        def start(argv, name):
            started.append(Process(argv, env, os.path.join(logs, f"{label}-{name}.log")))
            return started[-1]

        self.label, self.k, self.routed = label, k, routed
        self.backends = [
            start(["slimt_tpu_torch.server", "--root", pkg, "--workers", str(WORKERS),
                   "--device", str(device)], f"backend{i}")
            for i in range(k)]
        self.router = None
        if routed:
            self.router = start(["slimt_tpu_torch.runtime.router"]
                                + [a for b in self.backends for a in ("--backend", b.url)],
                                "router")
        self.references = []
        for _ in range(k):
            server = TranslationServer(Config(workers=WORKERS))
            server.add_model("default", model)
            self.references.append(server)

    @property
    def processes(self):
        return self.backends + ([self.router] if self.router else [])

    @property
    def url(self):
        return (self.router or self.backends[0]).url

    def wait(self) -> None:
        for p in self.processes:
            p.wait_health()

    def expected(self, texts):
        return [t for server, chunk in zip(self.references, chunks(texts, self.k))
                for t in server.handle({"texts": chunk})["targets"]]

    def checked_push(self, texts):
        tps, targets, tokens = push(self.url, texts)
        if targets != self.expected(texts):
            raise RuntimeError(f"{self.label}: the fleet's answers differ from the "
                               f"in-process answers for the same package")
        return tps, tokens

    def close(self) -> None:
        for server in self.references:
            server.close()


def local_bulk_rate(model, n):
    """(best tokens/s, tokens of each pass) of the stubbed Model through
    in-process Blocking.translate_bulk: the corpus of each seed of the
    pushes, after a warm pass. Tokens are counted as `push` counts them,
    the targets' whitespace words, so that direct/local compares like with
    like (annotation tokens would add the echoed EOS of every sentence)."""
    from slimt_tpu_torch.runtime.service import Blocking

    best, tokens = 0.0, []
    with Blocking(Config(cache_size=0, max_words=8192)) as svc:
        svc.translate_bulk(model, corpus(n))  # warm
        for i in range(ITERS):
            texts = corpus(n, seed=i)
            start = time.perf_counter()
            responses = svc.translate_bulk(model, texts)
            elapsed = time.perf_counter() - start
            tokens.append(sum(len(r.target.text.split()) for r in responses))
            best = max(best, tokens[-1] / elapsed)
    return best, tokens


def synth(root) -> str:
    """A `python -m slimt_tpu_torch synth` package under `root`."""
    pkg = os.path.join(root, "pkg")
    subprocess.run([sys.executable, "-m", "slimt_tpu_torch", "synth", "--out", pkg,
                    "--emb-dim", "256", "--ffn-dim", "1536"],
                   env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, check=True,
                   capture_output=True, timeout=600)
    return pkg


def run(mode, lines, backends, device="cuda", pkg=None, log=print) -> dict:
    """One mode's rows; returns its JSON object. `pkg`: a synth package to
    serve (default: one made here)."""
    import torch

    from slimt_tpu_torch.config import preset
    from slimt_tpu_torch.host_path import card
    from slimt_tpu_torch.models.model import Model, Package
    from slimt_tpu_torch.server import STUB_VARIABLE
    from slimt_tpu_torch.utils import stub_device_forward

    stubbed = mode == "budget"
    where = card(device)
    on_card = torch.device(device).type == "cuda"
    shared = SHARED["cuda" if on_card else "cpu"]
    with tempfile.TemporaryDirectory(prefix="slimt_fleet_") as tmp:
        pkg = pkg or synth(tmp)
        model = Model(preset.tiny(), Package(os.path.join(pkg, "model.bin"),
                                             os.path.join(pkg, "vocab.spm")),
                      device=device)
        env = dict(os.environ, PYTHONPATH=REPO)
        env.pop(STUB_VARIABLE, None)
        out = {"mode": mode, "lines": lines, "cores": os.cpu_count(),
               "device": str(device), "card": where, "stubbed": stubbed, "tokens": {}}
        if stubbed:
            stub_device_forward(model)
            env[STUB_VARIABLE] = "1"
            rate, out["tokens"]["local_bulk"] = local_bulk_rate(model, lines)
            out["local_bulk_tps"] = round(rate, 1)
            log(f"local bulk: {rate:,.0f} tok/s on {where}")
        specs = ([("direct", 1, False)] if stubbed else []) + [
            (f"router{k}", k, True) for k in backends]
        rows, started = [], []
        try:
            for label, k, routed in specs:
                rows.append(Row(label, k, routed, model, pkg, device, env, tmp, started))
            for row in rows:
                row.wait()
            rates, launches = {}, {}
            for row in rows:
                row.checked_push(corpus(WARM[mode], seed=99))  # warm every backend
                best, tokens = 0.0, []
                for i in range(ITERS):
                    tps, n = row.checked_push(corpus(lines, seed=i))
                    best, tokens = max(best, tps), tokens + [n]
                rates[row.label] = round(best, 1)
                out["tokens"][row.label] = tokens
                counts = [b.launches() for b in row.backends]
                launches[row.label] = counts
                if stubbed and any(v for c in counts for v in c.values()):
                    raise RuntimeError(f"{row.label}: a stubbed backend launched {counts}")
                if (not stubbed and on_card
                        and not all(c["qmm_affine"] and c["encoder_layer"] for c in counts)):
                    raise RuntimeError(f"{row.label}: a backend on the card never "
                                       f"launched #1 and #2: {counts}")
                log(f"{row.label} ({row.k} backend{'s' * (row.k > 1)}"
                    f"{'' if row.routed else ', direct'}): {best:,.0f} tok/s on {where}, "
                    f"answers equal to in-process"
                    + ("" if stubbed else f"; {shared}"))
        finally:
            for row in rows:
                row.close()
            stop_all(started)
    fleet = {k: rates[f"router{k}"] for k in backends}
    out["router_tps"] = {str(k): v for k, v in fleet.items()}
    out["launches"] = launches
    if 1 in fleet:
        out["fleet_efficiency"] = {str(k): round(tps / (k * fleet[1]), 3)
                                   for k, tps in fleet.items()}
    if stubbed:
        out["direct_tps"] = rates["direct"]
        out["transport_cost_pct"] = round(
            100.0 * (1 - out["direct_tps"] / out["local_bulk_tps"]), 1)
    else:
        out["metric"] = "fleet_tokens_per_sec"
        out["note"] = shared
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m slimt_tpu_torch.fleet",
        description="N port servers behind the router: stubbed (budget) or "
                    "decoding on --device (scaling)")
    parser.add_argument("mode", choices=["budget", "scaling"])
    parser.add_argument("--lines", type=int, default=None,
                        help="lines a push (budget 10000, scaling 2000)")
    parser.add_argument("--backends", type=int, nargs="+", default=None,
                        help="fleet sizes (budget 1 2 3, scaling 1 2)")
    parser.add_argument("--device", default="cuda",
                        help="every Model's device: cuda (the card; none is an "
                             "error) or cpu")
    args = parser.parse_args(argv)
    lines, backends = DEFAULTS[args.mode]
    out = run(args.mode, args.lines or lines, args.backends or backends, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
