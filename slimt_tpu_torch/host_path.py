"""The host path's ceiling and budget, with the device forward stubbed.

    python -m slimt_tpu_torch.host_path path [--lines 10000] [--workers 4]
        [--bulk] [--profile] [--device cuda]
    python -m slimt_tpu_torch.host_path budget [--lines 10000]
        [--device-rate R] [--device cuda]

`path` pushes the corpus through the real Async service (or, with --bulk,
Blocking.translate_bulk) on a small synthetic Model whose device forward is
stubbed to an instant echo (utils.stub_device_forward): the splitter,
tokenizer, batcher, cache, completion and detokenizer run for real, the
device not at all. Its tokens/s is the ceiling the host puts on a served
corpus however fast decode gets; --profile adds cProfile's top entries.

`budget` prints one JSON object: ingest µs a source word
(TextProcessor.process_batch, one thread); translate_bulk's host rate on the
stubbed Model at completion_threads 1 and N (every core of the host), and
with N-1 ingest processes; the perfect-scaling bound, the
parallel efficiency and the cores needed to keep one card fed at the device
rate. That rate is the card's own: by default the same corpus runs through
translate_bulk on an un-stubbed tiny11 Model (TINY11: 32k vocabulary, emb
256, ffn 1536, 6+2 layers, 8 heads, random weights from seed 0, the
declared config), no cache, so every line reaches the card, and then
through the same Model stubbed; the walls' ratio is the host's share of
the served corpus. --device-rate R gives the rate instead.

The counterparts of the JAX package's scripts/ubench_host_path.py and
scripts/ubench_host_budget.py, with their corpus (seed 5), service configs,
warm pass and JSON keys. Every rate is printed beside the card's name and
power limit (`nvidia-smi`). The Models run on --device: the card by default,
where a missing card is an error; "cpu" only where the caller asks.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time
from typing import Optional

import numpy as np

from slimt_tpu_torch.config import Config, ModelConfig

# The words of the JAX scripts' corpus.
WORDS = (
    "hello world goodbye this is a test of the translation engine "
    "quick brown fox jumps over lazy dog sentence splitting works "
    "numbers like 123 and punctuation are handled"
).split()
# bench.py:_model's widths (the JAX bench's tiny11).
TINY11 = dict(vocab_size=32000, emb_dim=256, ffn_dim=1536)
WARM_LINES = 256


def corpus(lines: int):
    """`lines` lines of 5-29 words drawn from WORDS, seed 5."""
    rng = np.random.default_rng(5)
    return [" ".join(rng.choice(WORDS, rng.integers(5, 30))) for _ in range(lines)]


def build_model(device="cuda"):
    """The JAX scripts' small synthetic Model: emb 32, ffn 64, 1+1
    layers, the DEFAULT_WORDS vocabulary, on `device`."""
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models.model import Model, Package
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=1, decoder_layers=1)
    spm = build_spm_model(DEFAULT_WORDS)
    vocab_size = max(len(spm.pieces), 64)
    model_bytes = synthetic_model_bytes(
        config=config, vocab_size=vocab_size, emb_dim=32, ffn_dim=64, seed=0)
    return Model(config, Package(model=model_bytes,
                                 vocabulary=spm_proto.serialize_model(spm)),
                 device=device)


def tiny11_model(device="cuda"):
    """The tiny11 Model at the declared config (as chip_smoke.py builds
    its full-vocabulary package), on `device`."""
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models.model import Model, Package
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig()
    spm = build_spm_model(DEFAULT_WORDS, target_size=TINY11["vocab_size"])
    model_bytes = synthetic_model_bytes(config=config, seed=0, **TINY11)
    return Model(config, Package(model_bytes, spm_proto.serialize_model(spm)),
                 device=device)


def card(device) -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader` prints them, or "cpu"; CUDA
    without a card raises (device.resolve_device)."""
    from slimt_tpu_torch.device import resolve_device

    if resolve_device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def target_tokens(responses) -> int:
    return sum(r.target.word_count(s) for r in responses
               for s in range(r.target.sentence_count()))


def run(model, lines, workers):
    """The corpus through the Async service, every handle's Response."""
    from slimt_tpu_torch.runtime.service import Async

    with Async(Config(cache_size=2048, max_words=8192, workers=workers,
                      batch_latency=0.02)) as svc:
        handles = svc.translate_many(model, lines)
        return [h.result(600) for h in handles]


def run_bulk(model, lines, workers):
    """The corpus through Blocking.translate_bulk."""
    from slimt_tpu_torch.runtime.service import Blocking

    with Blocking(Config(cache_size=2048, max_words=8192,
                         completion_threads=workers)) as svc:
        return svc.translate_bulk(model, lines)


def ceiling(model, lines, workers, bulk=False, profile=False):
    """(target tokens, seconds, cProfile text or None) of one timed pass
    after the warm pass over the first WARM_LINES lines."""
    runner = run_bulk if bulk else run
    runner(model, lines[:WARM_LINES], workers)  # warm imports and caches
    prof = cProfile.Profile() if profile else None
    if prof:
        prof.enable()
    start = time.perf_counter()
    responses = runner(model, lines, workers)
    elapsed = time.perf_counter() - start
    text = None
    if prof:
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(35)
        text = out.getvalue()
    return target_tokens(responses), elapsed, text


def time_ingest(model, lines, wrap=128):
    """(seconds, source words, source tokens) of one process_batch."""
    model.processor.process_batch(lines[:WARM_LINES], wrap)  # warm
    start = time.perf_counter()
    processed = model.processor.process_batch(lines, wrap)
    elapsed = time.perf_counter() - start
    tokens = sum(len(seg) for _, segments in processed for seg in segments)
    words = sum(len(line.split()) for line in lines)
    return elapsed, words, tokens


def time_bulk(model, lines, completion_threads, ingest_processes):
    """(seconds, target tokens, cache hit share) of the timed
    translate_bulk, after a warm call over the whole corpus (it starts
    the ingest pool, whose interpreters must not land in the timed run)."""
    from slimt_tpu_torch.runtime.service import Blocking

    with Blocking(Config(cache_size=2048, max_words=8192,
                         completion_threads=completion_threads,
                         ingest_processes=ingest_processes)) as svc:
        svc.translate_bulk(model, lines)
        svc.cache.hits = svc.cache.misses = 0
        start = time.perf_counter()
        responses = svc.translate_bulk(model, lines)
        elapsed = time.perf_counter() - start
        looked = svc.cache.hits + svc.cache.misses
        hits = svc.cache.hits / looked if looked else 0.0
    return elapsed, target_tokens(responses), hits


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure_device_rate(lines, device="cuda") -> dict:
    """The corpus through translate_bulk on the tiny11 Model, un-stubbed
    (warm pass, then timed), then on the same Model stubbed: tokens/s of
    the real pass, both walls, the stubbed wall's share of the real one,
    and each pass's kernel launches. No cache: every line reaches the
    device. On the card the real pass must launch the int8 affine (#1)
    and the encoder layer (#2) and the stubbed pass nothing."""
    import torch

    from slimt_tpu_torch.ops import launches
    from slimt_tpu_torch.runtime.service import Blocking
    from slimt_tpu_torch.utils import stub_device_forward

    model = tiny11_model(device)

    def timed():
        with Blocking(Config(cache_size=0, max_words=8192)) as svc:
            svc.translate_bulk(model, lines)  # warm: kernels, graphs
            _sync(device)
            launches.reset()
            start = time.perf_counter()
            responses = svc.translate_bulk(model, lines)
            _sync(device)
            return responses, time.perf_counter() - start, launches.snapshot()

    real, wall, counts = timed()
    stub_device_forward(model)
    stubbed, stubbed_wall, stubbed_counts = timed()
    if [r.source.text for r in stubbed] != [r.source.text for r in real]:
        raise RuntimeError("the stubbed pass read another corpus")
    if torch.device(device).type == "cuda":
        missing = [k for k in ("qmm_affine", "encoder_layer") if not counts[k]]
        if missing:
            raise RuntimeError(f"tiny11 on the card never launched {missing}")
    if any(stubbed_counts.values()):
        raise RuntimeError(f"the stubbed pass launched kernels: {stubbed_counts}")
    tokens = target_tokens(real)
    return {
        "model": "tiny11",
        "tokens": tokens,
        "tokens_per_sec": round(tokens / wall, 1),
        "wall_s": wall,
        "stubbed_wall_s": stubbed_wall,
        "host_share_of_wall": round(stubbed_wall / wall, 4),
        "launches": counts,
        "stubbed_launches": stubbed_counts,
    }


def budget(lines: int, device="cuda", device_rate: Optional[float] = None) -> dict:
    """The host budget (the module's `budget`) as a dict."""
    from slimt_tpu_torch.ops import launches
    from slimt_tpu_torch.utils import stub_device_forward

    ncores = os.cpu_count() or 1
    model = build_model(device)
    stub_device_forward(model)
    texts = corpus(lines)
    launches.reset()

    ing_s, words, _ = time_ingest(model, texts)
    ingest_us_per_word = ing_s / words * 1e6

    results = {}
    for label, threads, processes in (
        ("1core", 1, 0),
        (f"{ncores}thread", ncores, 0),
        (f"{ncores}thread+proc", ncores, max(1, ncores - 1)),
    ):
        elapsed, tokens, hits = time_bulk(model, texts, threads, processes)
        results[label] = {
            "tokens_per_sec": round(tokens / elapsed, 1),
            "host_us_per_token": round(elapsed / tokens * 1e6, 3),
            "cache_hit_share": round(hits, 4),
        }

    stubbed_counts = launches.snapshot()
    if any(stubbed_counts.values()):
        raise RuntimeError(f"the stubbed rows launched kernels: {stubbed_counts}")
    measured = None
    if device_rate is None:
        measured = measure_device_rate(texts, device)
        device_rate = measured["tokens_per_sec"]
    base = results["1core"]["host_us_per_token"]
    best = max(r["tokens_per_sec"] for r in results.values())
    perfect = ncores / base * 1e6
    # Cores to keep one card fed, if the measured best per-core efficiency
    # holds (ingest spreads over processes, the per-request remainder and
    # assembly over threads).
    eff = best / perfect
    return {
        "host_cores": ncores,
        "ingest_us_per_source_word": round(ingest_us_per_word, 3),
        "ingest_source_words_per_sec_per_core": round(1e6 / ingest_us_per_word, 1),
        "bulk_host": results,
        "bulk_host_launches": stubbed_counts,
        "host_us_per_token_1core": base,
        "perfect_scaling_tokens_per_sec": round(perfect, 1),
        "measured_best_tokens_per_sec": round(best, 1),
        "parallel_efficiency": round(eff, 3),
        "device_rate_budgeted": device_rate,
        "device_rate_source": "given" if measured is None else "measured",
        "device_rate_run": measured,
        "cores_to_feed_one_chip": round(device_rate * base / 1e6 / max(eff, 1e-9), 1),
        "lines": lines,
        "device": str(device),
        "card": card(device),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m slimt_tpu_torch.host_path",
        description="the host path's ceiling (path) and budget (budget), "
                    "the device forward stubbed")
    parser.add_argument("mode", choices=["path", "budget"])
    parser.add_argument("--lines", type=int, default=10000)
    parser.add_argument("--device", default="cuda",
                        help="the Models' device: cuda (the card; none is an "
                             "error) or cpu")
    parser.add_argument("--workers", type=int, default=4, help="path: service workers")
    parser.add_argument("--bulk", action="store_true",
                        help="path: Blocking.translate_bulk instead of Async")
    parser.add_argument("--profile", action="store_true", help="path: cProfile")
    parser.add_argument("--device-rate", type=float, default=None,
                        help="budget: decode tokens/s to budget against "
                             "(default: measured on tiny11 on --device)")
    args = parser.parse_args(argv)

    if args.mode == "budget":
        print(json.dumps(budget(args.lines, args.device, args.device_rate), indent=1))
        return 0
    from slimt_tpu_torch.utils import stub_device_forward

    model = build_model(args.device)
    stub_device_forward(model)
    tokens, elapsed, profile = ceiling(model, corpus(args.lines), args.workers,
                                       bulk=args.bulk, profile=args.profile)
    print(f"host ceiling: {tokens} target tokens in {elapsed:.2f}s = "
          f"{tokens / elapsed:,.0f} tok/s (workers={args.workers}, "
          f"{'bulk' if args.bulk else 'async'}) on {card(args.device)}")
    if profile:
        print(profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
