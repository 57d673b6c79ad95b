#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (slimt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result:

1. probe   — a CUDA card must be present; print its name, compute
             capability and `nvidia-smi` name and power limit;
2. build   — build the kernels from ops/csrc at first use (one nvcc per
             source, in parallel);
3. kernels — each kernel against its plain PyTorch version on the card
             at the serving paths' shapes: the int8 affine bit-equal in
             every mode (and at its tilings' edges: M 1-4096 across the
             split-K, 64- and 128-row tiles, ragged and gathered K and
             N), timed at the encoder's and the decode steps' shapes
             (also replayed from a CUDA graph, which drops the host's
             launch cost) beside each bound, the encoder layer within 2e-5 (the bound the
             JAX package holds its TPU kernel to) on >= 99% of
             positions (its launches a layer and each launch's device
             ms from torch.profiler), the whole decode step within 2e-5 on states and
             head-0 attention on >= 99% of rows (every position and row
             within 0.25: an int8 rounding flip moves one by up to
             ~0.06) with >= 99% of choices equal, its
             projection stage bit-equal given the same rows (a tie
             across vocab tiles included); the SSRU and FFN blocks
             within 2e-5 on >= 99% of rows and every row within 0.25,
             the decode attention within 2e-5 (T up to 1024), the projection argmax
             bit-equal in its three methods (exact, packed_fp16,
             packed_bf16; a tie across vocab tiles at two row-tile
             heights, a partial last tile of negative logits), at tiny
             and base widths and at E in (32, 40, 64) (the crosscheck
             cells' widths, and one that is no multiple of 16); #5, #6
             and #7 at WIDTH_CASES (E 32, 40, 64, 256, 512; F 64-2048,
             and 80) as at tiny and base widths (the widths phase); the split encoder's fused SDPA within
             2e-5 at B in (1, 33, 512), T in (16, 17, 64, 100, 256), E in
             (256, 512), and its blockwise attention within 2e-5 abs + 1e-5
             rel at T in (272, 1000, 1024, 2048) (ragged pads), padding
             rows within 1e-4; the whole step also at T=1024 (B 1, 8,
             130) and T=2048 (B=130); the per-layer decoder steps over a
             split (#10) and a joined (#11) float cache, and the whole
             step's float-cache branch, over f32, bf16 and f16 caches at
             B in (1, 8, 65, 130) (1-row and 4-row tiles), T in (16, 64,
             1024), tiny and base widths: >= 99% of rows within 2e-5 on
             the states and 1e-6 on the head-0 attention of a real row
             (padding rows 1e-4), every row within 0.25, the whole step's
             choices equal on >= 99.9% of rows; the whole step, #10,
             #11, the SSRU and the FFN block on the chooser's
             thread-block cluster layout and on one block a row tile
             (cs=1), each against the
             plain version and the first bit-equal to the second; times
             beside the plain versions' (and, for the two attention
             kernels, one scaled_dot_product_attention call's), each with
             its bound and a device time from a CUDA graph replay, the
             two layouts timed in turns (new, one, one, new);
4. serve   — a tiny11-width model (32k vocab, emb 256, ffn 1536, 6+2
             layers, 8 heads; random weights from seed 0) answers
             request batches of text through Model.forward_async,
             Model.forward_async_arrays and the port's own
             Blocking(...).translate, with and without shortlist and
             alignment: on the declared path, then on the fused_step
             latency path, then on the `fused` path (qmm_provider
             "fused", attn_kernel "on"; the full-vocab model keeps
             packed_int, which falls to the exact argmax there, the
             shortlist model takes packed_fp16), then on the `split`
             path (encoder_layer_kernel "off", encoder_sdpa "on"; the
             shortlist model under "fused"), then on the `long` path
             (the default config on lines of ~900 tokens through
             Blocking with a 1024-token wrap and forward_async_arrays at
             T=1024, on the declared, fused_step and fused decode
             paths), then on the `kv` path (Model(config, package), the
             card by default: kv_cache_dtype float32, bfloat16, float16,
             int8, k8v16 and k16v8 on the declared path, float32 and
             int8 under "fused", bfloat16 under fused_step, whose whole
             step launches its bfloat16 branch); the launch counts are
             set to 0 before each path and read after it, and every
             kernel of the path must have launched (a graph replay adds
             the launches its capture recorded); after each serve and
             long pass, the same traffic once more through the eager
             loop and once more through the graph loop (serve: also
             through a one-graph cache), each pass's wall and the
             Model's graph-cache hits, captures and evictions;
5. loop    — the decode loop runs as CUDA graphs of k steps: on every
             serving path (both packages) and kv config, the graph
             loop's tokens bit-equal to the eager loop's on the card
             (on each path's full-vocabulary model with alignments too),
             and equal across k in UNROLLS at an odd max_steps (41) and
             a cap (29) no k divides; each path's graphs with their
             capture time and memory, and its Model's cache counts over
             every phase;
6. continuous — ContinuousEngine at the tiny11 width with the JAX
             engine's defaults (256 slots, chunks of 16, t_slot 64) over
             2048 length-skewed segments (1 in 16 of 48-60 tokens, the
             rest 4-20) on the declared path and under fused_step (the
             counts reset and read around the engines' runs): each
             segment's tokens against its decode alone through Model at
             B=1 (every segment equal), segments/s and occupancy beside
             Model.forward at B=256 on the same segments;
7. doors   — the front doors a user starts, on the card, with the serve
             phase's package written to a directory (and converted to
             model.npz by the CLI's `convert`): the CLI in-process
             (slimt_tpu_torch.cli.main: blocking, --shortlist, --html,
             --async --workers 2, pivot, on model.npz), one `python -m
             slimt_tpu_torch translate` subprocess (rc 0, the in-process
             text, no JAX among its imports), TranslationServer behind
             make_httpd (/health, /health/devices, /translate with a text
             and with 40 texts on the bulk lane, /submit and /job,
             /stats), the C ABI (built with g++, loaded with ctypes,
             slimt_translate) and the JNI layer (its fake-JVM host, a
             process of its own, against the C ABI's object table); every
             answer equal to the port's Blocking or Async answer for the
             same Model on the card, the launch counts reset before each
             in-process door and qmm_affine and encoder_layer launched in
             each; each door's first and warm wall beside the card's name
             and power limit;
8. knobs   — qmm_provider "f32" and encoder_dtype float16 and bfloat16
             on the declared config through Model on the card (graph
             loop): the launch counts reset before each knob and read
             after it (f32 must launch no int8 kernel: its products are
             f32 matmuls against weights dequantized at load; the half
             encoders must launch qmm_affine and no encoder_layer, whose
             gate needs an f32 encoder), one B=64 T=64 forward, the B=1
             T=32 latency line and 16 segments against the plain CPU
             path (one row may part at a near tie); then one cell of the
             crosscheck serving sweep (crosscheck.SMOKE_CELL: narrow
             2/2/2, 64 lines at B=8, full vocabulary and shortlist) on
             the card for the exact, declared, enc=float16 and
             kv=bfloat16 rows against the reference harness's tokens
             (recorded in crosscheck/reference_tokens.json where the
             harness cannot start): the exact row must keep >= 98% of
             sentences; then `parity providers` and `parity matrix` on
             the card (exit 0; providers launches #5, #6 and #7 at E=64),
             the crosscheck bleu leg at E=256 F=1536 (the tiny preset,
             128 lines of data/corpus.txt, against the reference CLI's
             lines recorded in crosscheck/reference_cli.json: the exact
             path keeps >= 98% of lines, #1, #2 and #4 launch) and one
             fused_step forward under utils.trace, whose Chrome trace
             must name #1's, #2's (#8's attention_kernel among them) and
             #7's kernels, in a process of its own (a trace lacking the
             kernel of a launch is printed and taken again in a new
             process, up to TRACE_PROCESSES times);
9. check   — outputs well formed; CUDA tokens against the plain CPU
             path (>= 99% equal and none stopping short of the other;
             on the long path's arrays and the bfloat16 and int8 kv
             configs, one row may part instead where the plain logits
             of the two choices lie within TIE_GAP) for every path and
             kv config: 16 segments (on `kv`
             the decode capped at 0.5 x T), on `long`
             2 segments of ~900 tokens and the 4 forward_async_arrays
             rows at T=1024, the CPU's decode capped at 0.1 x T;
             forward wall time and tokens/s at B=64 and B=512 (T=64)
             on each short-input path, the graph and the eager loop in
             turns; the time forward_async takes to
             return at B=512 T=64 against its batch's wall (it must
             return before half of it) and, in turns on one card, the
             forward walls through the Model's dispatch worker against
             an inline dispatch (fused_step and declared at B=1 T=32,
             declared at B=512 T=64); at B=512 the declared
             float32 (exact) cache against int16; at B=1, T=32 each
             path's forward through the graph and the eager loop in
             turns, and fused_step over bfloat16 against int16 (median
             of 5 runs, µs per step, the host's launch calls, graph
             replays, device operations and busy µs per step by
             torch.profiler, the device's idle share); the 6-layer
             encoder at 16,384 tokens a call for T in (256, 512, 768,
             1024, 2048), plain SDPA
             against blockwise (and at T=256 the whole-layer kernel and
             the fused SDPA): median of 5 by CUDA events, tokens/s;
             neither JAX nor any slimt_tpu module was imported.

The second-to-last line is the kernels' JSON record (eleven kernels;
launches from the serving paths, but for #10 and #11, which no serving
path reaches: theirs are the kernels phase's; graph_ms, the device ms a
call from a CUDA graph; cs1_ms and cs1_graph_ms, the times on one block
a row tile, for the kernels on a cluster; ssru_block, argmax_affine
and decode_attention also list graph_ms_by_b, the device ms at B = 1,
64 and 512 (encoder_layer at B = 64 and 512, T=64), argmax_affine
split_ms_by_b, its projection and pick kernels' device ms from
torch.profiler, encoder_layer launches_per_layer and split_ms, its
launches a layer and each one's device ms at B=512 T=64 from
torch.profiler; qmm_affine also lists its times at the six timed shapes
under "shapes"; every kernel lists knobs_launches, its launches under
each knob), the last line {"ok": true, "device": {...}}.

`python3 chip_smoke.py --unroll` runs no check: the B=1 T=32 latency
line and the B=64 and B=512 T=64 forward lines of the graph loop at k
in UNROLL_SWEEP on the declared, fused_step and fused paths.

`python3 chip_smoke.py --trace-sessions N` runs no check: N traced
fused_step forwards at E=256 F=1536 with utils.TRACE_PAD_S at 0, then N
as committed, and for each the sessions whose trace lacks a launched
kernel.
`python3 chip_smoke.py --trace-once ROOT` is the trace phase's child:
one traced forward of the package in ROOT, printed as one JSON line.

`python3 chip_smoke.py --layouts OUT [KERNEL ...]` runs no check: it
times #7 (the whole step, T=64, full vocabulary), #5 (the FFN block),
#10 (split float32 cache, T=64) and #6 (the SSRU block) at B in
LAYOUT_BATCHES, #4 (the argmax, exact and packed_fp16, full
vocabulary and shortlists of 1024 and 3072) at B in ARGMAX_BATCHES, #2
(the encoder layer) at LAYER_SHAPES and both widths and #3 (the decode
attention) at ATTN_SHAPES, on the `slimt_tpu_torch` package beside the
script, with the wrapper's own layout and, where the package can force
one, on every cluster size the card schedules (#3: each of its two
kernels): CUDA-event ms and the
median of three graph replays (for #4 and #2 also each kernel's device
ms and launches from torch.profiler; for #2 and #3 the SHA-256 of the
output on inputs from seeded generators), written as one JSON object to
OUT. KERNEL names limit it to some of LAYOUT_KERNELS. A copy of the
script beside another tree's package times that tree; run both in one
call, in turns (equal digests show equal outputs).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

from slimt_tpu_torch.config import Config
from slimt_tpu_torch.runtime.response import Options
from slimt_tpu_torch.runtime.service import Blocking

VOCAB, EMB, FFN, ENC, DEC, HEADS = 32000, 256, 1536, 6, 2, 8
AFFINE_SOURCE = "slimt_tpu_torch/ops/csrc/qmm_affine.cu"
LAYER_SOURCE = "slimt_tpu_torch/ops/csrc/encoder_layer.cu"
STEP_SOURCE = "slimt_tpu_torch/ops/csrc/decoder_step.cu"
BLOCKS_SOURCE = "slimt_tpu_torch/ops/csrc/fused_blocks.cu"
ATTN_SOURCE = "slimt_tpu_torch/ops/csrc/decode_attn.cu"
ARGMAX_SOURCE = "slimt_tpu_torch/ops/csrc/logits_argmax.cu"
ATTENTION_SOURCE = "slimt_tpu_torch/ops/csrc/attention.cu"
LAYER_TOL = 2e-5
SDPA_TOL = 2e-5  # the encoder layer's bound
BLOCKWISE_ATOL, BLOCKWISE_RTOL = 2e-5, 1e-5  # the JAX package's, tests/test_attention.py
STEP_TOL = 2e-5  # the encoder layer's bound, per row (steps and blocks)
ATTN_TOL = 2e-5
# Head-0 attention of a row with a real key, against the plain version:
# the per-layer steps and the whole step's float-cache branch.
ATTN0_TOL = 1e-6
# Whole-step choices equal to the plain version's, float-cache branch.
CHOICE_MIN = 0.999
FLOAT_CACHES = ("float32", "bfloat16", "float16")
# The two versions sum in different orders, so now and then an input to
# an int8 quantization that lies within a few ulps of a rounding tie
# (x.5) rounds to the neighbouring int8 value in one of them (a "flip":
# the encoder layer's attention output or FFN input, a decode step's
# layer-2 input); the position or row it touches moves by up to ~0.06.
# So >= 99% of positions or rows must be within their tolerance and
# every one within FLIP_BOUND.
FLIP_BOUND = 0.25
MASK_MIN = -99999999.0
AGREEMENT_MIN = 0.99
# A padding row (every key masked) of the split encoder's attention: its
# scores sit on the float32 grid of 8 at 1e8, so two sum orders differ
# there by more than the kernels' tolerance (up to 5.2e-5 seen at
# T=2048); no token reads that row.
PAD_TOL = 1e-4
# Two greedy decodes part for good at a step where the two best logits are
# a near tie and a rounding flip (see FLIP_BOUND) picks the other one;
# random weights repeat one token a row, so one such row is 25% of the
# tokens of the 4 long rows and 6.25% of 16 segments. Below AGREEMENT_MIN,
# one row that parts is accepted where the plain logits of the two choices
# there lie within TIE_GAP: on the long path's forward_async_arrays rows
# (seen under fused_step), and on the kv configs of TIE_CACHES, whose
# rounding of q, p or attn through bfloat16 or int8 turns a sum-order ulp
# into a larger step. Everywhere else the tokens must be >= AGREEMENT_MIN
# equal, and no hypothesis may stop short of the other without parting.
TIE_GAP = 0.05
TIE_CACHES = ("bfloat16", "int8")
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): the
# bound of a kernel is the larger of its bytes over the memory rate and
# its operations over the peak rate of their type.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # CUDA cores, no tensor cores
INT8_OPS = 1979e12


def bound(nbytes, f32_ops=0.0, int8_ops=0.0):
    """(bound ms, "bytes" or "operations") for one call: each input read
    once, each output written once."""
    memory = nbytes / HBM_BYTES_PER_S
    compute = f32_ops / F32_FLOPS + int8_ops / INT8_OPS
    return max(memory, compute) * 1e3, "bytes" if memory >= compute else "operations"


def affine_bound(m, k, n, mode=0):
    """x and W read, the bias read but in the raw s32 mode, y written."""
    bias = 0 if mode == 2 else 4 * n
    return bound(4 * m * k + k * n + bias + 4 * m * n, int8_ops=2 * m * k * n)


def layer_bound(b, t, e, f):
    m = b * t
    weights = 4 * e * e + 2 * e * f + 4 * (9 * e + f)
    return bound(8 * m * e + 4 * b * t + weights, f32_ops=4 * b * t * t * e,
                 int8_ops=2 * m * (4 * e * e + 2 * e * f))


def step_bound(b, t, e, f, layers, s, cache="int16"):
    """The whole step over the int16 cache (K, V and the per-row kqi, vqi)
    or a float cache (K and V alone)."""
    elem = 4 if cache == "float32" else 2
    per_layer = (4 * e * e + 2 * e * f + 4 * (11 * e + f)  # weights, biases, LNs
                 + 2 * elem * b * t * e                     # K, V
                 + (8 * b * t if cache == "int16" else 0))  # kqi, vqi
    nbytes = (layers * per_layer + e * s + 4 * s + 4 * b * t + 4 * b * e
              + 8 * layers * b * e + 4 * b * t + 4 * b)
    return bound(nbytes, f32_ops=layers * 4 * b * t * e,
                 int8_ops=2 * b * (layers * (4 * e * e + 2 * e * f) + e * s))


def layer_step_bound(b, t, e, f, cache="float32"):
    """One decoder layer (#10, #11): its weights, K and V, the mask, x and
    c in, y, c' and attn0 out."""
    elem = 4 if cache == "float32" else 2
    nbytes = (4 * e * e + 2 * e * f + 4 * (10 * e + f) + 2 * elem * b * t * e
              + 4 * b * t + 16 * b * e + 4 * b * t)
    return bound(nbytes, f32_ops=4 * b * t * e, int8_ops=2 * b * (4 * e * e + 2 * e * f))


def sdpa_bound(b, t, e):
    return bound(16 * b * t * e + 4 * b * t, f32_ops=4 * b * t * t * e)


def log(*parts) -> None:
    print(*parts, flush=True)


def probe(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    capability = torch.cuda.get_device_capability(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} capability={capability} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(smi)  # as `nvidia-smi --query-gpu=name,power.limit` prints it
    if capability != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a, card is {capability}")
    return name, smi


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(torch, fn, calls=20):
    """Device ms per call of `fn` (already warm): `calls` calls captured as
    one CUDA graph and replayed, so the host's launch cost drops out."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(torch, graph.replay, 5) / calls


def check_affine(torch, qmm, dev):
    """Kernel vs plain at the serving path's shapes, every mode."""
    rng = np.random.default_rng(1)
    emb = torch.from_numpy(
        rng.integers(-127, 128, (VOCAB, EMB)).astype(np.int8)).to(dev)
    ids = torch.from_numpy(
        np.sort(rng.choice(VOCAB, 3072, replace=False))).to(dev)
    shortlisted = emb.index_select(0, ids)
    cases = []  # (label, m, w)
    for m in (1, 7, 64, 512, 2048):  # decode rows: M = B
        cases.append(("decode", m, (256, 256)))
        cases.append(("decode", m, (256, 1536)))
        cases.append(("decode", m, (1536, 256)))
        cases.append(("projection", m, emb.T))
        cases.append(("shortlist", m, shortlisted.T))
    for m in (16 * 64, 64 * 64, 2048 * 128):  # encoder rows: M = B*T
        for k, n in ((256, 256), (256, 1536), (1536, 256), (512, 512),
                     (512, 2048), (2048, 512)):
            if m * max(k, n) <= 2048 * 128 * 1536:
                cases.append(("encoder", m, (k, n)))
    # The kernel's tiling edges: split K up to M=64, 64- and 128-row tensor
    # core tiles above; ragged N and K, and the byte-gathered layouts.
    for m in (1, 15, 16, 17, 63, 64, 65, 129, 4096):
        for k, n in ((256, 256), (256, 1536), (1536, 256), (100, 72), (1000, 40)):
            cases.append(("edge", m, (k, n)))
    worst = 0.0
    for label, m, w in cases:
        if isinstance(w, tuple):
            w = torch.from_numpy(
                rng.integers(-127, 128, w).astype(np.int8)).to(dev)
        k, n = w.shape
        x = torch.randn((m, k), device=dev) * 2.0
        b = torch.randn((n,), device=dev) * 0.05
        aq, inv = np.float32(20.0), np.float32(1) / np.float32(20.0 * 93.0)
        for mode in (qmm.AFFINE, qmm.AFFINE_RELU, qmm.ACCUMULATOR):
            got = qmm.affine_kernel(x, w, b, aq, inv, mode)
            want = qmm.affine_plain(x, w, b, aq, inv, mode)
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise RuntimeError(
                    f"affine {label} M={m} K={k} N={n} mode={mode}: "
                    f"not bit-equal, max |diff| {err}")
    log(f"affine: {len(cases)} shapes x 3 modes bit-equal to plain "
        f"(max |diff| {worst})")
    for bad_k in (0, qmm.MAX_K + 1):
        try:
            qmm.affine_kernel(torch.zeros((1, bad_k), device=dev),
                              torch.zeros((bad_k, 4), dtype=torch.int8,
                                          device=dev), None, 1.0, 1.0)
        except ValueError:
            continue
        raise RuntimeError(f"affine accepted K={bad_k}")

    timings = []
    for label, m, k, n, mode, w in (
        ("encoder FFN1 B=512 T=64", 512 * 64, 256, 1536, qmm.AFFINE_RELU, None),
        ("encoder FFN2 B=512 T=64", 512 * 64, 1536, 256, qmm.AFFINE, None),
        ("decode FFN1 B=512", 512, 256, 1536, qmm.AFFINE_RELU, None),
        ("projection B=512 V=32000", 512, 256, VOCAB, qmm.ACCUMULATOR, emb.T),
        ("projection B=64 V=32000", 64, 256, VOCAB, qmm.ACCUMULATOR, emb.T),
        ("projection B=1 V=32000", 1, 256, VOCAB, qmm.ACCUMULATOR, emb.T),
    ):
        if w is None:
            w = torch.from_numpy(
                rng.integers(-127, 128, (k, n)).astype(np.int8)).to(dev)
        x = torch.randn((m, k), device=dev)
        b = torch.randn((n,), device=dev)
        kernel = cuda_ms(torch, lambda: qmm.affine_kernel(x, w, b, 20.0, 1e-4, mode))
        graph = graph_ms(torch, lambda: qmm.affine_kernel(x, w, b, 20.0, 1e-4, mode))
        plain = cuda_ms(torch, lambda: qmm.affine_plain(x, w, b, 20.0, 1e-4, mode))
        tops = 2.0 * m * k * n / (graph * 1e-3) / 1e12
        bound_ms, by = affine_bound(m, k, n, mode)
        log(f"time affine {label} (M={m} K={k} N={n}): kernel {kernel:.4f} ms, "
            f"{graph:.4f} ms a call in a CUDA graph ({tops:.2f} TOP/s), plain "
            f"{plain:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        timings.append({"shape": label, "ms": kernel, "graph_ms": graph, "plain_ms": plain,
                        "bound_ms": bound_ms, "bound_by": by})
    return worst, timings


def check_layer(torch, enc, dev, load_host, params_from_numpy):
    """Layer kernel vs plain at tiny and base widths, padded rows: >= 99%
    of positions within LAYER_TOL, every position within FLIP_BOUND."""
    worst = 0.0
    positions = within = 0
    timing = None
    gen = torch.Generator(device=dev)
    for emb, ffn in ((256, 1536), (512, 2048)):
        layer = params_from_numpy(load_host(emb, ffn, 1, 1), dev)["encoder"][0]
        gen.manual_seed(emb)
        for t in (16, 64, 128):
            b = 4
            x = torch.randn((b, t, emb), device=dev, generator=gen)
            mask = torch.ones((b, t), device=dev)
            mask[1, t // 2:] = 0
            mask[3] = 0  # a padding row
            mask_add = ((1.0 - mask) * -99999999.0)[:, None, None, :]
            got = enc.layer_kernel(x, layer, mask_add, HEADS)
            want = enc.layer_plain(x, layer, mask_add, HEADS)
            torch.cuda.synchronize()
            label = f"encoder layer E={emb} F={ffn} T={t}"
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"{label}: non-finite")
            n, ok, err = rows_check(label, (got - want).abs().amax(-1).flatten(),
                                    LAYER_TOL, FLIP_BOUND)
            positions += n
            within += ok
            worst = max(worst, err)
            log(f"{label}: max |diff| {err:.3g}")
        by_b = {}
        for b, t in ((64, 64), (512, 64)):
            x = torch.randn((b, t, emb), device=dev)
            mask_add = torch.zeros((b, 1, 1, t), device=dev)
            kernel = cuda_ms(torch, lambda: enc.layer_kernel(x, layer, mask_add, HEADS), 10)
            graph = graph_ms(torch, lambda: enc.layer_kernel(x, layer, mask_add, HEADS), 5)
            plain = cuda_ms(torch, lambda: enc.layer_plain(x, layer, mask_add, HEADS), 10)
            counts = {}
            split = kernel_split(torch, lambda: enc.layer_kernel(x, layer, mask_add, HEADS),
                                 10, counts)
            by_b[b] = graph
            log(f"time encoder layer E={emb} F={ffn} B={b} T={t}: kernel "
                f"{kernel:.4f} ms ({graph:.4f} ms in a CUDA graph), plain {plain:.4f} ms; "
                f"{sum(counts.values()):g} launches a layer, device ms by kernel {split}")
            if (emb, b) == (EMB, 512):
                timing = {"ms": kernel, "plain_ms": plain, "graph_ms": graph,
                          "launches_per_layer": round(sum(counts.values()), 6),
                          "split_ms": {short_kernel(name): ms for name, ms in split.items()},
                          "graph_ms_by_b": by_b}
    log(f"encoder layer: {within}/{positions} positions within {LAYER_TOL} "
        f"({within / positions:.6f}), max |diff| {worst:.3g}")
    if within / positions < AGREEMENT_MIN:
        raise RuntimeError(f"encoder layer: positions within {LAYER_TOL} "
                           f"{within / positions} < {AGREEMENT_MIN}")
    return worst, timing


def step_case(torch, tfm, params, gen, b, t, width, heads=HEADS):
    """Whole-step arguments on the card: random x, states and int16
    per-row caches; row 0 padded from t/2, the last row (b > 1) fully
    masked; the full projection, or a shortlist of `width` columns."""
    dev = gen.device
    e = params["emb"]["q"].shape[1]
    vocab = params["emb"]["q"].shape[0]
    layers = params["decoder"]
    x = torch.randn((b, 1, e), device=dev, generator=gen) * 2.0
    states = tuple(torch.randn((b, 1, e), device=dev, generator=gen) for _ in layers)
    mask = torch.ones((b, t), device=dev)
    mask[0, t // 2:] = 0.0
    if b > 1:
        mask[-1] = 0.0
    mask_add = ((1.0 - mask) * MASK_MIN)[:, None, None, :]

    def int16():
        return torch.randint(-32767, 32768, (b, t, e), device=dev,
                             dtype=torch.int16, generator=gen)

    def inv_scale():
        return (torch.rand((b, t), device=dev, generator=gen) * 1.5 + 0.5) / 32767.0

    caches = tuple({"k": int16(), "v": int16(), "kqi": inv_scale(),
                    "vqi": inv_scale()} for _ in layers)
    shortlist = None
    if width:
        shortlist = torch.randperm(vocab, device=dev, generator=gen)[:width].sort().values
    projection = tfm.prepare_output_projection(params, shortlist)
    return (layers, states, x, mask_add, caches, heads, projection,
            params["out"]["aq"], tfm.output_inv(params))


def logit_gap(qmm, y, args, choice, want) -> float:
    """Largest plain-logit gap between the plain and the kernel's choice
    over the rows where they differ (0 where none differ)."""
    differ = (choice != want).nonzero().flatten()
    if not len(differ):
        return 0.0
    logits = qmm.affine_plain(y, *args[6], args[7], args[8])[differ]
    picked = logits.gather(1, choice[differ].long()[:, None])[:, 0]
    return float((logits.amax(-1) - picked).max())


def check_step(torch, dstep, lam, tfm, qmm, dev, load_host, params_from_numpy):
    """Whole step vs plain at tiny and base widths, on the chooser's
    cluster layout and on one block a row tile (cs=1): states and attn0
    within STEP_TOL, >= 99% of choices equal, the projection stage
    bit-equal given the same rows; the cluster layout bit-equal to cs=1;
    a tie across vocab tiles; times of both layouts."""
    worst = 0.0
    rows = same = within = 0
    worst_gap = 0.0
    cases = exact = 0
    tiny = None
    for emb, ffn in ((EMB, FFN), (512, 2048)):
        params = params_from_numpy(load_host(emb, ffn, 1, DEC, vocab=VOCAB), dev)
        if emb == EMB:
            tiny = params
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb)
        shapes = [(b, t, 0) for b in (1, 8, 33, 64, 512) for t in (16, 64, 128, 256)]
        shapes += [(b, 64, w) for b in (1, 8, 33, 64, 512) for w in (1024, 3072)]
        # Past the encoder's T bound; B=130 takes 4 rows a block at T=1024
        # and 1 at T=2048.
        shapes += [(b, 1024, 0) for b in (1, 8, 130)] + [(130, 2048, 0)]
        for b, t, width in shapes:
            args = step_case(torch, tfm, params, gen, b, t, width)
            choice, states, attn0 = dstep.whole_step_kernel(*args)
            one = dstep.whole_step_kernel(*args, _cluster=1)
            y, want_states, want_attn0 = dstep.layers_plain(*args[:6])
            want = dstep.argmax_affine_plain(y, *args[6], args[7], args[8])
            stage = dstep.argmax_affine_kernel(y, *args[6], args[7], args[8])
            torch.cuda.synchronize()
            label = f"whole step E={emb} F={ffn} B={b} T={t} S={width or VOCAB}"
            if not all(bool(torch.isfinite(s).all()) for s in states + (attn0,)):
                raise RuntimeError(f"{label}: non-finite output")
            if not bit_equal((choice, *states, attn0), (one[0], *one[1], one[2])):
                raise RuntimeError(f"{label}: the cluster layout is not bit-equal to cs=1")
            exact += 1
            errs = []
            for got_states, got_attn0 in ((states, attn0), one[1:]):
                row_err = (got_attn0 - want_attn0).abs().amax(-1)
                for got, ref in zip(got_states, want_states):
                    row_err = torch.maximum(row_err, (got - ref).abs().amax((1, 2)))
                errs.append(row_err)
            row_err = torch.maximum(*errs)
            err = float(row_err.max())
            worst = max(worst, err)
            beyond = int((row_err > STEP_TOL).sum())
            if beyond:
                log(f"{label}: {beyond} of {b} rows beyond {STEP_TOL}, max |diff| {err:.3g}")
            if err > FLIP_BOUND:
                raise RuntimeError(f"{label}: max |diff| {err} > {FLIP_BOUND}")
            if not torch.equal(stage, want):
                raise RuntimeError(f"{label}: projection stage not bit-equal")
            rows += b
            within += b - beyond
            same += int((choice == want).sum())
            worst_gap = max(worst_gap, logit_gap(qmm, y, args, choice, want))
            cases += 1
    share = same / rows
    log(f"whole step: {cases} cases; states and attn0 within {STEP_TOL} on "
        f"{within}/{rows} rows ({within / rows:.6f}), max |diff| {worst:.3g}; "
        f"choices equal on {same}/{rows} rows ({share:.6f}), largest logit gap "
        f"where they differ {worst_gap:.3g}; projection stage bit-equal; the cluster "
        f"layout bit-equal to cs=1 on {exact}/{cases} cases")
    if within / rows < AGREEMENT_MIN or share < AGREEMENT_MIN:
        raise RuntimeError(f"whole step: rows within {STEP_TOL} {within / rows}, "
                           f"choices equal {share}; both must be >= {AGREEMENT_MIN}")
    check_tie(torch, lam, tfm, tiny)
    return worst, time_step(torch, dstep, tfm, tiny)


def check_tie(torch, lam, tfm, params):
    """Two identical projection columns in different vocab tiles: the
    first must win, in the kernel and in the plain version, in every
    method of the argmax kernel."""
    dev = params["emb"]["q"].device
    emb = params["emb"]["q"].clone()
    # Tiles 2 and 156 of the kernel's 128 columns.
    first, second = 301, 20006
    emb[second] = emb[first]
    bias = params["out"]["b"].clone()
    bias[second] = bias[first]
    ids = torch.arange(0, VOCAB, 7, device=dev)  # holds both, in tiles 0 and 22 of 128
    for label, w, b, col in (
        ("full", emb.T, bias, first),
        ("shortlist", emb.index_select(0, ids).T, bias.index_select(0, ids),
         int((ids == first).nonzero())),
    ):
        for rows in (3, 20):  # one row tile of 16, then of 32
            y = (w[:, col].float() / 40.0).repeat(rows, 1).contiguous()
            for method in lam.METHODS:
                got = lam.argmax_affine_kernel(y, w, b, 20.0, 1e-3, method)
                want = lam.argmax_affine_plain(y, w, b, 20.0, 1e-3, method)
                torch.cuda.synchronize()
                if got.tolist() != [col] * rows or not torch.equal(got, want):
                    raise RuntimeError(f"tie ({label}, B={rows}, {method}): kernel "
                                       f"{got.tolist()}, plain {want.tolist()}, first column {col}")
    log("projection tie across vocab tiles: the first column wins "
        f"(full, shortlist; {', '.join(lam.METHODS)})")


def layouts_in_turns(torch, name, new, one):
    """CUDA-event and CUDA-graph ms a call of the cluster layout (`new`)
    and of one block a row tile (`one`), timed new, one, one, new on one
    card; the means of each pair."""
    times = {"new": [], "one": []}
    for key, fn in (("new", new), ("one", one), ("one", one), ("new", new)):
        times[key].append((cuda_ms(torch, fn, 50), graph_ms(torch, fn)))
    (ms, graph), (one_ms, one_graph) = (
        tuple(statistics.fmean(t[i] for t in times[key]) for i in (0, 1))
        for key in ("new", "one"))
    log(f"time {name}: cluster layout {ms:.4f} ms ({graph:.4f} ms in a CUDA graph), "
        f"one block a tile {one_ms:.4f} ms ({one_graph:.4f} ms in a CUDA graph); "
        f"in turns new/one/one/new: {[round(t[0], 4) for t in times['new']]} / "
        f"{[round(t[0], 4) for t in times['one']]}")
    return {"ms": ms, "graph_ms": graph, "cs1_ms": one_ms, "cs1_graph_ms": one_graph}


def time_step(torch, dstep, tfm, params):
    """Kernel (with its per-batch plan) on both layouts, in turns, vs
    plain, T=64, tiny widths. Returns the B=1 full-vocab times."""
    gen = torch.Generator(device=params["emb"]["q"].device)
    gen.manual_seed(1)
    timing = None
    for width in (0, 1024):
        for b in (1, 8, 64):
            args = step_case(torch, tfm, params, gen, b, 64, width)
            plans = [dstep.StepPlan(args[0], args[4], args[3], HEADS, args[6], args[7],
                                    args[8], _cluster=cluster) for cluster in (None, 1)]
            times = layouts_in_turns(
                torch, f"whole step E={EMB} F={FFN} B={b} T=64 S={width or VOCAB} "
                f"(cs={plans[0].cs}, {plans[0].rows} rows a tile)",
                lambda: dstep.whole_step_kernel(*args, plan=plans[0]),
                lambda: dstep.whole_step_kernel(*args, plan=plans[1]))
            times["plain_ms"] = cuda_ms(torch, lambda: dstep.whole_step_plain(*args), 20)
            log(f"time whole step E={EMB} F={FFN} B={b} T=64 S={width or VOCAB}: plain "
                f"{times['plain_ms']:.4f} ms")
            if (b, width) == (1, 0):
                timing = times
    return timing


def float_cache(torch, gen, shape, dtype):
    """A random float cache of `dtype` (values ~N(0, 0.25))."""
    return (torch.randn(shape, device=gen.device, generator=gen) * 0.5).to(
        getattr(torch, dtype))


class RowShare:
    """The float-cache rule: every row within FLIP_BOUND on states and
    head-0 attention; >= 99% of the rows within STEP_TOL on the states and
    ATTN0_TOL on the attention of a row with a real key (PAD_TOL on a
    padding row, whose softmax is the rounding of its scores)."""

    def __init__(self, name):
        self.name = name
        self.rows = self.within = self.attn_rows = self.attn_within = 0
        self.worst = 0.0

    def add(self, label, state_err, attn_err, real):
        err = max(float(state_err.max()), float(attn_err.max()))
        if not err <= FLIP_BOUND:  # also catches NaN
            raise RuntimeError(f"{label}: max |diff| {err} > {FLIP_BOUND}")
        attn_ok = (attn_err <= ATTN0_TOL) | (~real & (attn_err <= PAD_TOL))
        ok = (state_err <= STEP_TOL) & attn_ok
        self.rows += ok.numel()
        self.within += int(ok.sum())
        self.attn_rows += int(real.sum())
        self.attn_within += int((attn_ok & real).sum())
        self.worst = max(self.worst, err)
        if not bool(ok.all()):
            log(f"{label}: {ok.numel() - int(ok.sum())} of {ok.numel()} rows beyond "
                f"{STEP_TOL} (states) / {ATTN0_TOL} (attn0), max |diff| {err:.3g}")

    def finish(self):
        share = self.within / self.rows
        log(f"{self.name}: {self.within}/{self.rows} rows within {STEP_TOL} on the "
            f"states and {ATTN0_TOL} on attn0 ({share:.6f}); attn0 of real rows within "
            f"{ATTN0_TOL}: {self.attn_within}/{self.attn_rows} "
            f"({self.attn_within / self.attn_rows:.6f}); max |diff| {self.worst:.3g}")
        if share < AGREEMENT_MIN:
            raise RuntimeError(f"{self.name}: rows within {share} < {AGREEMENT_MIN}")


def check_layer_steps(torch, dstep, dev, load_host, params_from_numpy):
    """#10 (split [B, H, T, D] float cache, nothing rounded) and #11
    (joined [B, T, E], q and p rounded through the cache's type) against
    their plain versions: caches f32, bf16 and f16, B in (1, 8, 65, 130)
    (1-row and 4-row tiles), T in (16, 64, 1024), tiny and base widths, by
    the RowShare rule. Returns per kernel the launches of the checks, the
    worst error and the (kernel, plain) ms at B=64, T=64, f32 cache."""
    kinds = {"decoder_layer_step": (True, dstep.decoder_layer_step_kernel,
                                    dstep.decoder_layer_step_plain),
             "decoder_layer_step_bte": (False, dstep.decoder_layer_step_bte_kernel,
                                        dstep.decoder_layer_step_bte_plain)}
    for _, kernel, _ in kinds.values():
        kernel.launches = 0
    shares = {name: RowShare(name) for name in kinds}
    gen = torch.Generator(device=dev)
    gen.manual_seed(10)
    exact = 0

    def case(layer, emb, b, t, dtype, split):
        x = torch.randn((b, 1, emb), device=dev, generator=gen) * 2.0
        c = torch.randn((b, 1, emb), device=dev, generator=gen)
        shape = (b, HEADS, t, emb // HEADS) if split else (b, t, emb)
        kv = tuple(float_cache(torch, gen, shape, dtype) for _ in range(2))
        mask_add, real = padded_mask(torch, dev, b, t)
        return (layer, c, x, mask_add, kv, HEADS), real

    for emb, ffn in ((EMB, FFN), (512, 2048)):
        layer = params_from_numpy(load_host(emb, ffn, 1, 1), dev)["decoder"][0]
        for name, (split, kernel, plain) in kinds.items():
            for dtype in FLOAT_CACHES:
                for b in (1, 8, 65, 130):
                    for t in (16, 64, 1024):
                        args, real = case(layer, emb, b, t, dtype, split)
                        y, c_t, attn0 = kernel(*args)
                        one = kernel(*args, _cluster=1)
                        want_y, want_c, want_attn0 = plain(*args)
                        torch.cuda.synchronize()
                        if not bit_equal((y, c_t, attn0), one):
                            raise RuntimeError(f"{name} E={emb} {dtype} B={b} T={t}: the "
                                               "cluster layout is not bit-equal to cs=1")
                        exact += 1
                        state_err = torch.maximum((y - want_y).abs().amax((1, 2)),
                                                  (c_t - want_c).abs().amax((1, 2)))
                        shares[name].add(f"{name} E={emb} {dtype} B={b} T={t}", state_err,
                                         (attn0 - want_attn0).abs().amax(-1), real)
    launched = {name: kernel.launches for name, (_, kernel, _) in kinds.items()}
    for share in shares.values():
        share.finish()
    log(f"layer steps: the cluster layout bit-equal to cs=1 on {exact} cases")
    layer = params_from_numpy(load_host(EMB, FFN, 1, 1), dev)["decoder"][0]
    timing = {}
    for name, (split, kernel, plain) in kinds.items():
        for b in (64, 512):
            args, _ = case(layer, EMB, b, 64, "float32", split)
            times = layouts_in_turns(torch, f"{name} E={EMB} F={FFN} B={b} T=64 float32 cache",
                                     lambda: kernel(*args), lambda: kernel(*args, _cluster=1))
            times["plain_ms"] = cuda_ms(torch, lambda: plain(*args), 10)
            bound_ms, by = layer_step_bound(b, 64, EMB, FFN)
            log(f"time {name} E={EMB} F={FFN} B={b} T=64 float32 cache: plain "
                f"{times['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({by})")
            if b == 64:
                timing[name] = times
    return launched, {name: share.worst for name, share in shares.items()}, timing


def check_step_float(torch, dstep, tfm, dev, widths):
    """The whole step's float-cache branch (#7; caches f32, bf16 and f16,
    no kqi/vqi) against whole_step_plain at tiny and base widths, B in (1,
    8, 65, 130), T in (16, 64, 1024), full vocabulary and (T=64) a 1024
    shortlist: the RowShare rule, and choices equal on >= CHOICE_MIN of
    the rows. Returns the worst error and, per cache type, the (kernel,
    plain) ms at B=1, T=64, full vocabulary (tiny widths)."""
    share = RowShare("whole step, float caches")
    rows = same = exact = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    for params in widths:
        emb = params["emb"]["q"].shape[1]
        shapes = [(b, t, 0) for b in (1, 8, 65, 130) for t in (16, 64, 1024)]
        shapes += [(b, 64, 1024) for b in (1, 65)]
        for dtype in FLOAT_CACHES:
            for b, t, width in shapes:
                args = float_step_case(torch, tfm, params, gen, b, t, width, dtype)
                choice, states, attn0 = dstep.whole_step_kernel(*args)
                one = dstep.whole_step_kernel(*args, _cluster=1)
                want, want_states, want_attn0 = dstep.whole_step_plain(*args)
                torch.cuda.synchronize()
                if not bit_equal((choice, *states, attn0), (one[0], *one[1], one[2])):
                    raise RuntimeError(f"whole step E={emb} {dtype} B={b} T={t}: the "
                                       "cluster layout is not bit-equal to cs=1")
                exact += 1
                state_err = torch.zeros((b,), device=dev)
                for got, ref in zip(states, want_states):
                    state_err = torch.maximum(state_err, (got - ref).abs().amax((1, 2)))
                real = (args[3][:, 0, 0, :] == 0).any(-1)
                share.add(f"whole step E={emb} {dtype} B={b} T={t} S={width or VOCAB}",
                          state_err, (attn0 - want_attn0).abs().amax(-1), real)
                rows += b
                same += int((choice == want).sum())
    share.finish()
    log(f"whole step, float caches: choices equal on {same}/{rows} rows "
        f"({same / rows:.6f}); the cluster layout bit-equal to cs=1 on {exact} cases")
    if same / rows < CHOICE_MIN:
        raise RuntimeError(f"whole step, float caches: choices equal {same / rows} "
                           f"< {CHOICE_MIN}")
    timing = {}
    for dtype in FLOAT_CACHES:
        args = float_step_case(torch, tfm, widths[0], gen, 1, 64, 0, dtype)
        plan = dstep.StepPlan(args[0], args[4], args[3], HEADS, args[6], args[7], args[8])
        timing[dtype] = (cuda_ms(torch, lambda: dstep.whole_step_kernel(*args, plan=plan), 50),
                         cuda_ms(torch, lambda: dstep.whole_step_plain(*args), 20),
                         graph_ms(torch, lambda: dstep.whole_step_kernel(*args, plan=plan)))
        bound_ms, by = step_bound(1, 64, EMB, FFN, DEC, VOCAB, dtype)
        log(f"time whole step E={EMB} F={FFN} B=1 T=64 S={VOCAB} {dtype} cache "
            f"(cs={plan.cs}): kernel {timing[dtype][0]:.4f} ms ({timing[dtype][2]:.4f} ms "
            f"in a CUDA graph), plain {timing[dtype][1]:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    return share.worst, timing


def float_step_case(torch, tfm, params, gen, b, t, width, dtype):
    """step_case's arguments with joined float caches of `dtype` (scalar
    kqi = vqi = 1, as precompute_cross_kv builds them)."""
    args = step_case(torch, tfm, params, gen, b, t, width)
    e = params["emb"]["q"].shape[1]
    one = torch.ones((), device=gen.device)
    caches = tuple({"k": float_cache(torch, gen, (b, t, e), dtype),
                    "v": float_cache(torch, gen, (b, t, e), dtype),
                    "kqi": one, "vqi": one} for _ in args[0])
    return args[:4] + (caches,) + args[5:]


def bit_equal(got, want) -> bool:
    """Every tensor of `got` equal to its pair in `want`, bit for bit."""
    return all(a.equal(b) for a, b in zip(got, want, strict=True))


def rows_check(label, row_err, tol, bound):
    """(rows, rows within tol, max error); raises on a non-finite error
    or one beyond bound."""
    err = float(row_err.max())
    if not err <= bound:  # also catches NaN
        raise RuntimeError(f"{label}: max |diff| {err} > {bound}")
    within = int((row_err <= tol).sum())
    if within < row_err.numel():
        log(f"{label}: {row_err.numel() - within} of {row_err.numel()} rows "
            f"beyond {tol}, max |diff| {err:.3g}")
    return row_err.numel(), within, err


def check_blocks(torch, fblocks, dev, load_host, params_from_numpy):
    """SSRU and FFN blocks vs plain at tiny and base widths: >= 99% of
    rows within STEP_TOL, every row within FLIP_BOUND, each block on the
    chooser's cluster layout and on one block a row tile (cs=1), the
    first bit-equal to the second; times at T=1 rows (decode), B in {1,
    64, 512}, each block's two layouts in turns."""
    worst = {"ssru_block": 0.0, "ffn_block": 0.0}
    rows = {"ssru_block": [0, 0], "ffn_block": [0, 0]}
    timing = {"ssru_block": {}}
    exact = 0
    for emb, ffn in ((EMB, FFN), (512, 2048)):
        layers = params_from_numpy(load_host(emb, ffn, 1, DEC), dev)["decoder"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb + 1)
        for b in (1, 8, 33, 64, 512):
            for layer in layers:
                x = torch.randn((b, emb), device=dev, generator=gen) * 2.0
                c = torch.randn((b, emb), device=dev, generator=gen)
                h, c_t = fblocks.ssru_kernel(x, c, layer["rnn"])
                h_one, c_one = fblocks.ssru_kernel(x, c, layer["rnn"], _cluster=1)
                want_h, want_c = fblocks.ssru_plain(x, c, layer["rnn"])
                y = fblocks.ffn_kernel(x, layer["ffn"])
                y_one = fblocks.ffn_kernel(x, layer["ffn"], _cluster=1)
                want_y = fblocks.ffn_plain(x, layer["ffn"])
                torch.cuda.synchronize()
                label = f"E={emb} F={ffn} B={b}"
                if not bit_equal((h, c_t), (h_one, c_one)):
                    raise RuntimeError(f"ssru_block {label}: the cluster layout is not "
                                       "bit-equal to cs=1")
                if not torch.equal(y, y_one):
                    raise RuntimeError(f"ffn_block {label}: the cluster layout is not "
                                       "bit-equal to cs=1")
                exact += 1
                ssru_err = torch.maximum((h - want_h).abs().amax(-1), (c_t - want_c).abs().amax(-1))
                for name, err in (
                    ("ssru_block", torch.maximum(ssru_err, torch.maximum(
                        (h_one - want_h).abs().amax(-1), (c_one - want_c).abs().amax(-1)))),
                    ("ffn_block", torch.maximum((y - want_y).abs().amax(-1),
                                                (y_one - want_y).abs().amax(-1))),
                ):
                    n, within, e = rows_check(f"{name} {label}", err, STEP_TOL, FLIP_BOUND)
                    rows[name][0] += n
                    rows[name][1] += within
                    worst[name] = max(worst[name], e)
        layer = layers[0]
        for b in (1, 64, 512):
            x = torch.randn((b, emb), device=dev, generator=gen)
            c = torch.randn((b, emb), device=dev, generator=gen)
            cs = fblocks.ssru_layout(b, emb, dev.index)[0]
            ssru = layouts_in_turns(
                torch, f"ssru_block E={emb} B={b} (cs={cs})",
                lambda: fblocks.ssru_kernel(x, c, layer["rnn"]),
                lambda: fblocks.ssru_kernel(x, c, layer["rnn"], _cluster=1))
            ssru["plain_ms"] = cuda_ms(torch, lambda: fblocks.ssru_plain(x, c, layer["rnn"]), 20)
            log(f"time ssru_block E={emb} B={b}: plain {ssru['plain_ms']:.4f} ms")
            cs = fblocks.ffn_layout(b, emb, ffn, dev.index)[0]
            ffn_times = layouts_in_turns(
                torch, f"ffn_block E={emb} F={ffn} B={b} (cs={cs})",
                lambda: fblocks.ffn_kernel(x, layer["ffn"]),
                lambda: fblocks.ffn_kernel(x, layer["ffn"], _cluster=1))
            ffn_times["plain_ms"] = cuda_ms(torch, lambda: fblocks.ffn_plain(x, layer["ffn"]), 20)
            log(f"time ffn_block E={emb} F={ffn} B={b}: plain {ffn_times['plain_ms']:.4f} ms")
            if emb == EMB:
                timing[f"ffn_block B={b}"] = ffn_times
                timing["ssru_block"].setdefault("graph_ms_by_b", {})[b] = ssru["graph_ms"]
            if (emb, b) == (EMB, 64):
                timing["ssru_block"].update(ssru)
                timing["ffn_block"] = ffn_times
    log(f"ssru_block, ffn_block: the cluster layout bit-equal to cs=1 on {exact} cases each")
    for name, (n, within) in rows.items():
        log(f"{name}: {within}/{n} rows within {STEP_TOL} ({within / n:.6f}), "
            f"max |diff| {worst[name]:.3g}")
        if within / n < AGREEMENT_MIN:
            raise RuntimeError(f"{name}: rows within {STEP_TOL} {within / n} "
                               f"< {AGREEMENT_MIN}")
    return worst, timing


# (E, F, heads) of #5, #6 and #7 at the widths of the repo's own
# configurations: the crosscheck and parity cells (E 32 and 64; F 64, 128
# and 256), tiny11 and base; and E=40 F=80 (a head of 40), whose rows the
# kernels stage at a pitch of 48 with zeros past 40.
WIDTH_CASES = ((32, 64, 2), (40, 80, 1), (64, 128, 4), (64, 256, 8), (256, 1536, 8),
               (512, 2048, 8))
WIDTH_BATCHES = (1, 8, 64, 130)


def check_widths(torch, fblocks, dstep, tfm, dev, load_host, params_from_numpy, name, smi):
    """#5, #6 and #7 at every width of WIDTH_CASES against their plain
    versions: states, attn0 and outputs within STEP_TOL on >= 99% of rows
    and within FLIP_BOUND on all, >= 99% of the step's choices equal, the
    chooser's cluster layout bit-equal to one block a tile; each wrapper's
    `launches` counter, set to 0 at each width, must grow by the calls made
    there; device ms (CUDA-graph replays) at B = 1 and 64."""
    wrappers = {"ssru_block": fblocks.ssru_kernel, "ffn_block": fblocks.ffn_kernel,
                "whole_decode_step": dstep.whole_step_kernel}
    totals = dict.fromkeys(wrappers, 0)
    for emb, ffn, heads in WIDTH_CASES:
        for wrapper in wrappers.values():
            wrapper.launches = 0
        calls = dict.fromkeys(wrappers, 0)
        params = params_from_numpy(load_host(emb, ffn, 1, DEC, vocab=512), dev)
        layer = params["decoder"][0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb + ffn)
        rows = {"ssru_block": [0, 0], "ffn_block": [0, 0], "whole_decode_step": [0, 0]}
        worst = dict.fromkeys(rows, 0.0)
        same = total = 0
        label = f"E={emb} F={ffn}"
        for b in WIDTH_BATCHES:
            x = torch.randn((b, emb), device=dev, generator=gen) * 2.0
            c = torch.randn((b, emb), device=dev, generator=gen)
            h, c_t = fblocks.ssru_kernel(x, c, layer["rnn"])
            one = fblocks.ssru_kernel(x, c, layer["rnn"], _cluster=1)
            want_h, want_c = fblocks.ssru_plain(x, c, layer["rnn"])
            y = fblocks.ffn_kernel(x, layer["ffn"])
            y_one = fblocks.ffn_kernel(x, layer["ffn"], _cluster=1)
            want_y = fblocks.ffn_plain(x, layer["ffn"])
            calls["ssru_block"] += 2
            calls["ffn_block"] += 2
            errs = {"ssru_block": torch.maximum((h - want_h).abs().amax(-1),
                                                (c_t - want_c).abs().amax(-1)),
                    "ffn_block": (y - want_y).abs().amax(-1)}
            if not (bit_equal((h, c_t), one) and torch.equal(y, y_one)):
                raise RuntimeError(f"blocks {label} B={b}: the cluster layout is not "
                                   "bit-equal to cs=1")
            for t in (16, 64):
                args = step_case(torch, tfm, params, gen, b, t, 0, heads)
                choice, states, attn0 = dstep.whole_step_kernel(*args)
                step_one = dstep.whole_step_kernel(*args, _cluster=1)
                calls["whole_decode_step"] += 2
                y_rows, want_states, want_attn0 = dstep.layers_plain(*args[:6])
                want = dstep.argmax_affine_plain(y_rows, *args[6], args[7], args[8])
                if not bit_equal((choice, *states, attn0),
                                 (step_one[0], *step_one[1], step_one[2])):
                    raise RuntimeError(f"whole step {label} B={b} T={t}: the cluster "
                                       "layout is not bit-equal to cs=1")
                err = (attn0 - want_attn0).abs().amax(-1)
                for got, ref in zip(states, want_states):
                    err = torch.maximum(err, (got - ref).abs().amax((1, 2)))
                n, within, e = rows_check(f"whole step {label} B={b} T={t}", err,
                                          STEP_TOL, FLIP_BOUND)
                rows["whole_decode_step"][0] += n
                rows["whole_decode_step"][1] += within
                worst["whole_decode_step"] = max(worst["whole_decode_step"], e)
                same += int((choice == want).sum())
                total += b
            for key, err in errs.items():
                n, within, e = rows_check(f"{key} {label} B={b}", err, STEP_TOL, FLIP_BOUND)
                rows[key][0] += n
                rows[key][1] += within
                worst[key] = max(worst[key], e)
        torch.cuda.synchronize()
        counted = {key: wrapper.launches for key, wrapper in wrappers.items()}
        if counted != calls:
            raise RuntimeError(f"widths {label}: the wrappers counted {counted} launches "
                               f"for {calls} calls")
        for key, n in counted.items():
            totals[key] += n
        times = {}
        for b in (1, 64):
            x = torch.randn((b, emb), device=dev, generator=gen)
            c = torch.randn((b, emb), device=dev, generator=gen)
            args = step_case(torch, tfm, params, gen, b, 64, 0, heads)
            plan = dstep.StepPlan(args[0], args[4], args[3], heads, *args[6:])
            for key, fn in (("ssru_block", lambda: fblocks.ssru_kernel(x, c, layer["rnn"])),
                            ("ffn_block", lambda: fblocks.ffn_kernel(x, layer["ffn"])),
                            ("whole_decode_step",
                             lambda: dstep.whole_step_kernel(*args, plan=plan))):
                fn()
                times[f"{key} B={b}"] = round(graph_ms(torch, fn), 4)
        for key, (n, within) in rows.items():
            log(f"widths {key} {label}: {within}/{n} rows within {STEP_TOL}, max |diff| "
                f"{worst[key]:.3g}")
            if within / n < AGREEMENT_MIN:
                raise RuntimeError(f"widths {key} {label}: rows within {STEP_TOL} "
                                   f"{within / n} < {AGREEMENT_MIN}")
        cs_step = dstep.step_layout(1, emb, ffn, heads, 64, 0, dev.index)[0]
        log(f"widths {label} heads={heads}: whole step choices equal on {same}/{total} rows; "
            f"cluster layouts bit-equal to cs=1; layouts at B=1: ssru cs="
            f"{fblocks.ssru_layout(1, emb, dev.index)[0]}, ffn cs="
            f"{fblocks.ffn_layout(1, emb, ffn, dev.index)[0]}, step cs={cs_step}; "
            f"device ms (CUDA graph) {times} on {name} ({smi})")
        if same / total < AGREEMENT_MIN:
            raise RuntimeError(f"widths {label}: choices equal {same / total} "
                               f"< {AGREEMENT_MIN}")
    for wrapper in wrappers.values():
        wrapper.launches = 0
    log(f"widths: launches counted by the wrappers in the checks {totals}")


def check_attention(torch, dattn, dev):
    """Decode attention vs plain within ATTN_TOL at E 256/512 (8 heads),
    B in {1, 8, 33, 64, 512}, T in {16, 64, 128}; row 0 padded from T/2
    and the last row fully masked; times at tiny width, T=64."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = 0.0
    timing = None

    def case(b, t, e):
        return attention_case(torch, gen, dev, b, t, e)

    cases = 0
    shapes = [(b, t) for b in (1, 8, 33, 64, 512) for t in (16, 64, 128)]
    shapes += [(b, LONG_T) for b in (1, 8, 33)]
    for e in (EMB, 512):
        for b, t in shapes:
            args = case(b, t, e)
            got = dattn.decode_attention_kernel(*args, HEADS)
            want = dattn.attention_plain(*args, HEADS)[0]
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise RuntimeError(f"decode attention E={e} B={b} T={t}: non-finite")
            err = float((got - want).abs().max())
            worst = max(worst, err)
            if not err <= ATTN_TOL:
                raise RuntimeError(
                    f"decode attention E={e} B={b} T={t}: max |diff| {err} > {ATTN_TOL}")
            cases += 1
    log(f"decode attention: {cases} cases within {ATTN_TOL}, max |diff| {worst:.3g}")
    by_b = {}
    for b in (1, 64, 512):
        args = case(b, 64, EMB)
        times = {"ms": cuda_ms(torch, lambda: dattn.decode_attention_kernel(*args, HEADS), 50),
                 "graph_ms": graph_ms(torch, lambda: dattn.decode_attention_kernel(*args, HEADS)),
                 "plain_ms": cuda_ms(torch, lambda: dattn.attention_plain(*args, HEADS), 20)}
        by_b[b] = times["graph_ms"]
        log(f"time decode attention E={EMB} B={b} T=64: kernel {times['ms']:.4f} ms "
            f"({times['graph_ms']:.4f} ms in a CUDA graph), plain {times['plain_ms']:.4f} ms")
        if b == 64:
            timing = times
    timing["graph_ms_by_b"] = by_b
    return worst, timing


def check_argmax(torch, lam, tfm, widths):
    """The argmax kernel bit-equal to plain in every method, at each
    width's params (tiny first; the narrow ones take the strided path at
    32 and 40 and the tensor-core path at 64), full vocab and shortlists
    of 1024, 3072
    and 1000 (a partial last tile, also with every logit negative), B in
    {1, 8, 33, 64, 512}; times at tiny width, B in {1, 64, 512}, with the
    projection and pick kernels' device times. Returns (most differing
    indices in a case, which must be 0; the B=64 exact times, with the
    exact method's device ms and split at each B)."""
    cases = differ = 0
    for params in widths:
        dev = params["emb"]["q"].device
        emb = params["emb"]["q"].shape[1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb)
        projections = {"full": tfm.prepare_output_projection(params)}
        for width in (1024, 3072, 1000):
            ids = torch.randperm(VOCAB, device=dev, generator=gen)[:width].sort().values
            projections[f"shortlist {width}"] = tfm.prepare_output_projection(params, ids)
        # A partial last tile (1000 columns) where every logit is negative:
        # its padding columns must never win.
        w, b = projections["shortlist 1000"]
        projections["shortlist 1000, negative"] = (w, b - 100.0)
        aq, inv = params["out"]["aq"], tfm.output_inv(params)
        for label, (w, b) in projections.items():
            for rows in (1, 8, 33, 64, 512):
                y = torch.randn((rows, emb), device=dev, generator=gen) * 2.0
                for method in lam.METHODS:
                    got = lam.argmax_affine_kernel(y, w, b, aq, inv, method)
                    want = lam.argmax_affine_plain(y, w, b, aq, inv, method)
                    torch.cuda.synchronize()
                    differ = max(differ, int((got != want).sum()))
                    if not torch.equal(got, want):
                        raise RuntimeError(
                            f"argmax {method} E={emb} {label} B={rows}: not bit-equal")
                    cases += 1
    embs = tuple(params["emb"]["q"].shape[1] for params in widths)
    log(f"argmax: {cases} cases at E in {embs} bit-equal to plain "
        f"({', '.join(lam.METHODS)})")
    timing = None
    params = widths[0]
    aq, inv = params["out"]["aq"], tfm.output_inv(params)
    w, b = tfm.prepare_output_projection(params)
    gen = torch.Generator(device=w.device)
    gen.manual_seed(5)
    by_b = {}
    for rows in (1, 64, 512):
        y = torch.randn((rows, EMB), device=dev, generator=gen)
        for method in lam.METHODS:
            def kernel():
                return lam.argmax_affine_kernel(y, w, b, aq, inv, method)

            times = {"ms": cuda_ms(torch, kernel, 50), "graph_ms": graph_ms(torch, kernel),
                     "plain_ms": cuda_ms(torch, lambda: lam.argmax_affine_plain(
                         y, w, b, aq, inv, method), 20)}
            split = {("project" if "project" in name else "pick" if "pick" in name else name): ms
                     for name, ms in kernel_split(torch, kernel).items()}
            log(f"time argmax {method} B={rows} V={VOCAB}: kernel {times['ms']:.4f} ms "
                f"({times['graph_ms']:.4f} ms in a CUDA graph; by kernel "
                f"{ {k: round(v, 4) for k, v in split.items()} }), plain "
                f"{times['plain_ms']:.4f} ms")
            if method == "exact":
                by_b[rows] = {"graph_ms": times["graph_ms"], "split_ms": split}
            if (rows, method) == (64, "exact"):
                timing = times
    timing["graph_ms_by_b"] = {rows: t["graph_ms"] for rows, t in by_b.items()}
    timing["split_ms_by_b"] = {rows: t["split_ms"] for rows, t in by_b.items()}
    return float(differ), timing


def padded_mask(torch, dev, b, t):
    """(additive [b, 1, 1, t] mask, rows with a real key): row 0 padded
    over its last third, row 1 a padding row where b > 2. A padding
    row's scores are MASK_MIN + s, rounded to the float32 grid of 8 at
    1e8, so its softmax is the rounding of s and differs between two sum
    orders; no token reads that row. The checks hold it to PAD_TOL and
    the real rows to their tolerance."""
    mask = torch.ones((b, t), device=dev)
    mask[0, t - t // 3:] = 0.0
    if b > 2:
        mask[1] = 0.0
    return ((1.0 - mask) * MASK_MIN)[:, None, None, :], mask.any(-1)


def library_sdpa(torch, q, k, v, mask_add):
    """One torch.nn.functional.scaled_dot_product_attention call on [B,
    H, T, D] views with the same float mask: the yardstick, never called
    by the port."""
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask_add)


def check_fused_sdpa(torch, att, enc, dev):
    """Fused SDPA vs plain within SDPA_TOL at every position of the real
    rows (PAD_TOL on the padding rows), B in (1, 33, 512), T in (16, 17,
    64, 100, 256) (ragged key tiles), E in (256, 512), 8 heads; times at
    B=512 T=64 E=256 beside the plain version and the library call, and
    at head dim 64 (E=512, T=64 and 256) beside the library call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    worst = worst_pad = 0.0
    cases = 0
    for e in (EMB, 512):
        for b in (1, 33, 512):
            for t in (16, 17, 64, 100, 256):
                q, k, v = (torch.randn((b, t, e), device=dev, generator=gen) for _ in range(3))
                mask_add, real = padded_mask(torch, dev, b, t)
                got = att.fused_sdpa_kernel(q, k, v, mask_add, HEADS)
                want = enc.sdpa_plain(q, k, v, mask_add, HEADS)
                torch.cuda.synchronize()
                err = float((got[real] - want[real]).abs().max())
                pad = float((got - want).abs().max())
                worst = max(worst, err)
                worst_pad = max(worst_pad, pad)
                if not (err <= SDPA_TOL and pad <= PAD_TOL):  # also catches NaN
                    raise RuntimeError(f"fused SDPA B={b} T={t} E={e}: max |diff| {err} "
                                       f"on the real rows, {pad} on all")
                cases += 1
    log(f"fused SDPA: {cases} cases within {SDPA_TOL} on the real rows, max |diff| "
        f"{worst:.3g}; padding rows within {PAD_TOL}, max |diff| {worst_pad:.3g}")
    b, t, e = 512, 64, EMB
    q, k, v = (torch.randn((b, t, e), device=dev, generator=gen) for _ in range(3))
    mask_add = padded_mask(torch, dev, b, t)[0]

    def heads(a):
        return a.view(b, t, HEADS, e // HEADS).transpose(1, 2)

    times = {"ms": cuda_ms(torch, lambda: att.fused_sdpa_kernel(q, k, v, mask_add, HEADS)),
             "graph_ms": graph_ms(torch, lambda: att.fused_sdpa_kernel(q, k, v, mask_add, HEADS)),
             "plain_ms": cuda_ms(torch, lambda: enc.sdpa_plain(q, k, v, mask_add, HEADS), 10),
             "library_ms": cuda_ms(torch, lambda: library_sdpa(
                 torch, heads(q), heads(k), heads(v), mask_add))}
    bound_ms, by = sdpa_bound(b, t, e)
    log(f"time fused SDPA B={b} T={t} E={e}: kernel {times['ms']:.4f} ms "
        f"({times['graph_ms']:.4f} ms in a CUDA graph), plain {times['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {times['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({by})")
    # Base widths (head dim 64), against the library call only.
    for t64 in (64, 256):
        e64, b64 = 512, 512 * 64 // t64
        q64, k64, v64 = (torch.randn((b64, t64, e64), device=dev, generator=gen)
                         for _ in range(3))
        mask64 = padded_mask(torch, dev, b64, t64)[0]

        def heads64(a):
            return a.view(b64, t64, HEADS, e64 // HEADS).transpose(1, 2)

        kernel64 = cuda_ms(torch, lambda: att.fused_sdpa_kernel(q64, k64, v64, mask64, HEADS))
        library64 = cuda_ms(torch, lambda: library_sdpa(
            torch, heads64(q64), heads64(k64), heads64(v64), mask64))
        log(f"time fused SDPA B={b64} T={t64} E={e64}: kernel {kernel64:.4f} ms, "
            f"scaled_dot_product_attention {library64:.4f} ms, bound "
            f"{sdpa_bound(b64, t64, e64)[0]:.4f} ms")
    return worst, times


def check_blockwise(torch, att, dev):
    """Blockwise attention vs plain within BLOCKWISE_ATOL + BLOCKWISE_RTOL
    * |plain| at every position of the real rows (PAD_TOL on the padding
    row), 8 heads of D=32,
    ragged query tiles; times at B*H=128, T=1024 beside the plain version
    and the library call."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    worst = 0.0
    for b, t in ((16, 272), (3, 1000), (16, 1024), (16, 2048)):
        q, k, v = (torch.randn((b, HEADS, t, 32), device=dev, generator=gen)
                   for _ in range(3))
        mask_add, real = padded_mask(torch, dev, b, t)
        got = att.blockwise_kernel(q, k, v, mask_add)
        want = att.blockwise_plain(q, k, v, mask_add)
        torch.cuda.synchronize()
        pad = float((got - want).abs().max())
        if not pad <= PAD_TOL:  # also catches NaN
            raise RuntimeError(f"blockwise B={b} T={t}: max |diff| {pad} > {PAD_TOL}")
        diff = (got[real] - want[real]).abs()
        err = float(diff.max())
        worst = max(worst, err)
        if not bool((diff <= BLOCKWISE_ATOL + BLOCKWISE_RTOL * want[real].abs()).all()):
            raise RuntimeError(f"blockwise B={b} T={t}: beyond {BLOCKWISE_ATOL} + "
                               f"{BLOCKWISE_RTOL} x |plain|, max |diff| {err}")
        log(f"blockwise B={b} H={HEADS} T={t} D=32: max |diff| {err:.3g} on the real "
            f"rows, {pad:.3g} on all (padding row within {PAD_TOL})")
    b, t = 16, 1024
    q, k, v = (torch.randn((b, HEADS, t, 32), device=dev, generator=gen) for _ in range(3))
    mask_add = padded_mask(torch, dev, b, t)[0]
    times = {"ms": cuda_ms(torch, lambda: att.blockwise_kernel(q, k, v, mask_add), 10),
             "graph_ms": graph_ms(torch, lambda: att.blockwise_kernel(q, k, v, mask_add), 5),
             "plain_ms": cuda_ms(torch, lambda: att.blockwise_plain(q, k, v, mask_add), 10),
             "library_ms": cuda_ms(torch, lambda: library_sdpa(torch, q, k, v, mask_add), 10)}
    bh = b * HEADS
    bound_ms, by = bound(16 * bh * t * 32 + 4 * b * t, f32_ops=4 * bh * t * t * 32)
    log(f"time blockwise B*H={bh} T={t} D=32: kernel {times['ms']:.4f} ms "
        f"({times['graph_ms']:.4f} ms in a CUDA graph), plain {times['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {times['library_ms']:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({by})")
    return worst, times


# The host's CUDA calls that put work on a stream, as torch.profiler names
# them: kernel launches, graph replays, copies and fills.
HOST_CALLS = ("Launch", "Memcpy", "Memset")


@contextlib.contextmanager
def eager_loop(model, eager: bool):
    """Within the block, `model` decodes with the eager loop on the card
    (its private `_eager_loop`) where `eager` is set, else its graphs."""
    model._eager_loop = eager
    try:
        yield
    finally:
        model._eager_loop = False


def latency(torch, model, whole_step, decode, loop_graph, eager=False):
    """B=1, T=32 through the graph loop (or, with `eager`, the eager loop
    on the card): the median wall of 5 forwards, the steps a forward runs
    (chunks x k: decode.run_loop counts the chunks), the whole step's
    launches held to those steps, and from one profiled forward the
    host's launch calls, the graph replays, the device operations and
    their busy time. The device's idle share is 1 - busy / median wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eos = model.vocabulary.eos_id
    segment = [[3 + j for j in range(31)] + [eos]]
    unroll = decode.resolve_unroll(model._loop_unroll)
    with eager_loop(model, eager):
        model.forward(segment, need_alignment=False)
        chunks, launches = decode.run_loop.chunks, whole_step.launches
        model.forward(segment, need_alignment=False)
        steps = (decode.run_loop.chunks - chunks) * unroll
        launched = whole_step.launches - launches
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.forward(segment, need_alignment=False)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
        replays = loop_graph.ChunkGraph.replays
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.forward(segment, need_alignment=False)
            torch.cuda.synchronize()
        replays = loop_graph.ChunkGraph.replays - replays
    if launched and launched != steps:
        raise RuntimeError(f"whole step launched {launched} times for {steps} steps")
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")
            and any(word in e.name for word in HOST_CALLS)]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log("  device time per step by kernel: " + "; ".join(
        f"{name[:40]} {us / steps:.1f} us" for name, us in top))
    wall = statistics.median(walls)
    return {"wall": wall, "walls": walls, "steps": steps, "ops": len(device),
            "host_calls": len(host), "replays": replays, "busy_us": busy_us,
            "idle": 1.0 - busy_us * 1e-6 / wall}


def latency_line(label, got, name, smi) -> str:
    steps = got["steps"]
    return (f"latency {label} B=1 T=32 full vocab: median wall {got['wall'] * 1e3:.3f} ms "
            f"of {[round(w * 1e3, 3) for w in got['walls']]}, {steps} steps, "
            f"{got['wall'] / steps * 1e6:.1f} us/step, {got['host_calls'] / steps:.2f} host "
            f"launch calls/step, {got['replays']} graph replays "
            f"({got['replays'] / steps:.3f}/step), {got['ops'] / steps:.1f} device ops/step, "
            f"device busy {got['busy_us'] / steps:.1f} us/step, idle {got['idle']:.1%} "
            f"(profiled) on {name} ({smi})")


def make_lines(rng, words, count, low, high):
    return [" ".join(rng.choice(words, int(rng.integers(low, high))))
            for _ in range(count)]


def serve(model, lines):
    """The runtime's two entries: forward_async (several dispatched
    before the first finish) and forward_async_arrays(raw=True)."""
    vocab = model.vocabulary
    segments = [vocab.encode(line, add_eos=True)[0][:128] for line in lines]
    for seg in segments:
        seg[-1] = vocab.eos_id
    groups = [segments[:32], segments[32:48], segments[48:]]
    finishes = [model.forward_async(g, need_alignment=False) for g in groups]
    finishes.append(model.forward_async(segments[:8], need_alignment=True))
    results = [finish() for finish in finishes]
    hyps = [h for r in results[:3] for h in r]
    limit = int(1.5 * max(len(s) for s in segments))
    for seg, hyp in zip(segments, hyps):
        check_hypothesis(model, seg, hyp, limit, aligned=False)
    for seg, hyp in zip(segments[:8], results[3]):
        check_hypothesis(model, seg, hyp, limit, aligned=True)

    rows = segments[:32]
    t_pad = -(-max(len(s) for s in rows) // 16) * 16
    indices = np.zeros((32, t_pad), np.int32)
    mask = np.zeros((32, t_pad), np.float32)
    for i, seg in enumerate(rows):
        indices[i, :len(seg)] = seg
        mask[i, :len(seg)] = 1.0
    lengths = np.array([len(s) for s in rows])
    words = np.concatenate([np.asarray(s) for s in rows])
    tokens, steps, align = model.forward_async_arrays(
        indices, mask, lengths, len(rows), need_alignment=False,
        shortlist_words=words, raw=True)()
    if align is not None or tokens.shape[0] != 32:
        raise RuntimeError("forward_async_arrays: malformed raw result")
    for i, hyp in enumerate(hyps[:32]):
        if tokens[i, :steps[i]].tolist() != hyp.target:
            raise RuntimeError("forward_async_arrays disagrees with forward_async")
    sample = [vocab.decode(h.target)[0] for h in hyps[:2]]

    # The runtime's service front door (the card has `regex`, which the
    # text processor needs): split, tokenize, batch, decode, detokenize,
    # on the bulk lane (forward_async_arrays) and, with alignment, the
    # per-request lane (forward_async).
    with Blocking(Config()) as service:
        responses = service.translate(model, list(lines[:32]))
    with Blocking(Config(prefer_bulk=False)) as service:
        aligned = service.translate(model, list(lines[:8]), Options(alignment=True))
    if len(responses) != 32 or not all(r.target.text for r in responses):
        raise RuntimeError("Blocking.translate: malformed responses")
    if len(aligned) != 8 or not all(r.alignments for r in aligned):
        raise RuntimeError("Blocking.translate with alignment: no alignments")
    return segments, hyps, sample


def cache_counts(model) -> dict:
    """The Model's decode-graph cache counts (loop_graph.GraphCache)."""
    return dict(model._graphs.counts)


def counts_text(before, after, keys) -> str:
    """A pass's cache lookups between two cache_counts: each batch is one
    lookup, a hit replays a kept graph and a miss captures one."""
    hits, misses, evictions = (after[k] - before[k] for k in ("hits", "misses", "evictions"))
    share = hits / max(1, hits + misses)
    return (f"{hits + misses} batches, {hits} hits, {misses} captures, {evictions} "
            f"evictions, {share:.1%} of batches replayed a kept graph, {keys} graphs kept")


def phase_turns(torch, label, model, run, cold, name, smi, thrash=False):
    """`run(model)` once more with the eager loop and once more with the
    graph loop, after its first (cold) graph pass `cold` = (wall s, cache
    counts before it, after it): the walls, and per graph pass the
    cache's lookups. With `thrash`, once more through a cache of one graph
    (GraphCache(1)): each change of key captures anew, the cost of
    traffic whose keys outnumber the cache."""
    from slimt_tpu_torch.models.loop_graph import GraphCache

    walls = {}
    counts = {}
    kept = model._graphs
    for loop in ("eager", "graph") + (("thrash",) if thrash else ()):
        if loop == "thrash":
            model._graphs = GraphCache(1)
        before = cache_counts(model)
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            with eager_loop(model, loop == "eager"):
                run(model)
            torch.cuda.synchronize()
            walls[loop] = time.perf_counter() - start
            counts[loop] = (before, cache_counts(model), len(model._graphs))
        finally:
            model._graphs = kept
    wall, before, after = cold
    thrashed = (f"; one-graph cache {walls['thrash']:.3f} s ({counts_text(*counts['thrash'])})"
                if thrash else "")
    log(f"{label} in turns: cold graph loop {wall:.3f} s "
        f"({counts_text(before, after, len(kept))}); eager loop {walls['eager']:.3f} s; "
        f"warm graph loop {walls['graph']:.3f} s ({counts_text(*counts['graph'])})"
        f"{thrashed} on {name} ({smi})")


LONG_T = 1024
LONG_ROWS = 4


def serve_long(model, lines):
    """Lines of ~900 tokens through the port's Blocking with a 1024-token
    wrap (T bucket 912, past the blockwise crossover), then
    forward_async_arrays at T=1024. Returns the segments of the lines
    and the arrays' (indices, mask, lengths, tokens, steps)."""
    vocab = model.vocabulary
    with Blocking(Config(wrap_length=LONG_T, max_words=4 * LONG_T,
                         prefer_bulk=False)) as service:
        responses = service.translate(model, list(lines))
    if len(responses) != len(lines) or not all(r.target.text for r in responses):
        raise RuntimeError("Blocking.translate (long lines): malformed responses")
    segments = [vocab.encode(line, add_eos=True)[0] for line in lines]
    words = [w for seg in segments for w in seg[:-1]]
    rows = LONG_ROWS
    indices = np.zeros((rows, LONG_T), np.int32)
    mask = np.zeros((rows, LONG_T), np.float32)
    for i in range(rows):
        n = LONG_T - 40 * i  # ragged lengths, the first row full
        indices[i, :n - 1] = words[100 * i:100 * i + n - 1]
        indices[i, n - 1] = vocab.eos_id
        mask[i, :n] = 1.0
    lengths = mask.sum(1).astype(np.int64)
    tokens, steps, align = model.forward_async_arrays(
        indices, mask, lengths, rows, need_alignment=False, raw=True)()
    limit = int(model.limit_factor * LONG_T)
    if align is not None or tokens.shape[0] != rows or not (
            (steps >= 1) & (steps <= limit)).all():
        raise RuntimeError("forward_async_arrays at T=1024: malformed raw result")
    if not (0 <= tokens).all() or not (tokens < model.vocab_size).all():
        raise RuntimeError("forward_async_arrays at T=1024: token outside the vocabulary")
    return segments, (indices, mask, lengths, tokens, steps)


@contextlib.contextmanager
def recording_logits(tfm, dstep, qmm):
    """Within the block, the plain logits [B, V or S] of every decode step
    on the CPU are appended to the yielded list (the declared and fused
    paths through transformer.output_argmax, fused_step through the whole
    step's argmax_affine_plain)."""
    logits = []
    real_argmax, real_step = tfm.output_argmax, dstep.argmax_affine_plain

    def output_argmax(params, x, provider=None, projection=None, method="packed_int",
                      packed_bias=None):
        logits.append(tfm.output_logits(params, x, projection=projection,
                                        provider="f32" if provider == "f32" else None))
        return real_argmax(params, x, provider, projection, method, packed_bias)

    def argmax_affine_plain(y, w, b, aq, inv, *rest):
        logits.append(qmm.affine_plain(y, w, b, aq, inv))
        return real_step(y, w, b, aq, inv, *rest)

    tfm.output_argmax, dstep.argmax_affine_plain = output_argmax, argmax_affine_plain
    try:
        yield logits
    finally:
        tfm.output_argmax, dstep.argmax_affine_plain = real_argmax, real_step


def plain_rows(model, tfm, dstep, qmm, indices, mask, lengths):
    """`model`'s forward_async_arrays rows on the CPU, with the plain
    logits of every step (recording_logits)."""
    with recording_logits(tfm, dstep, qmm) as logits:
        tokens, steps, _ = model.forward_async_arrays(
            indices, mask, lengths, len(indices), need_alignment=False, raw=True)()
    return tokens, steps, logits


def parting_gaps(model, segments, got, want, logits):
    """For each segment whose CUDA hypothesis `got` parts from the plain
    one `want`: the plain logit of the plain choice less that of the CUDA
    choice at the first step where they part (the columns of a shortlist
    are the model's padded shortlist of the segments' words); inf where
    one is a strict prefix of the other."""
    from slimt_tpu_torch.models.model import SHORTLIST_BUCKET

    column = None
    if model.shortlist_generator is not None:
        ids = model.shortlist_generator.generate_padded(
            [w for s in segments for w in s], SHORTLIST_BUCKET)
        column = {}
        for j, word in enumerate(ids.tolist()):
            column.setdefault(word, j)
    gaps = []
    for i, (g, w) in enumerate(zip(got, want)):
        part = next((k for k, (x, y) in enumerate(zip(g.target, w.target)) if x != y), None)
        if part is None:
            if len(g.target) != len(w.target):
                gaps.append(float("inf"))
            continue
        a, b = w.target[part], g.target[part]
        if column is not None:
            a, b = column[a], column[b]
        row = logits[part][i]
        gaps.append(float(row[a] - row[b]))
    return gaps


def row_agreement(plain, indices, tokens, steps):
    """(share of equal tokens, gaps) between forward_async_arrays rows
    (tokens, steps) and the plain rows `plain` (plain_rows), each row cut
    to the length the plain run gave it: greedy prefixes do not depend on
    the step limit. gaps: for each row that differs, the plain logit of
    the plain choice less that of the other choice at the first step
    where they part; inf where the CUDA row stops short of the plain
    one without parting."""
    want, want_steps, logits = plain
    same = total = 0
    gaps = []
    for i in range(len(indices)):
        ref = want[i, :want_steps[i]].tolist()
        got = tokens[i, :min(steps[i], len(ref))].tolist()
        total += max(len(got), len(ref))
        same += sum(1 for x, y in zip(got, ref) if x == y)
        part = next((k for k, (x, y) in enumerate(zip(got, ref)) if x != y), None)
        if part is not None:
            row = logits[part][i]
            gaps.append(float(row[ref[part]] - row[got[part]]))
        elif len(got) < len(ref):
            gaps.append(float("inf"))
    return same / max(total, 1), gaps


def check_agreement(what, share, gaps, ties):
    """Raise unless CUDA tokens hold to the plain ones: none stops short of
    the other without parting (a gap of inf), and a share >=
    AGREEMENT_MIN is equal or, where `ties` is set, one row parts, at a
    near tie (0 <= gap <= TIE_GAP)."""
    if float("inf") in gaps:
        raise RuntimeError(f"{what}: one hypothesis stops short of the other without parting")
    if share >= AGREEMENT_MIN:
        return
    if not (ties and len(gaps) == 1 and 0 <= gaps[0] <= TIE_GAP):
        raise RuntimeError(f"{what}: token agreement {share} < {AGREEMENT_MIN}, and "
                           f"the parting rows {gaps} are not one near tie (<= {TIE_GAP}"
                           f"{'' if ties else ', which this path does not allow'})")


def check_hypothesis(model, seg, hyp, limit, aligned):
    target = hyp.target
    if not 1 <= len(target) <= max(1, limit):
        raise RuntimeError(f"hypothesis length {len(target)} outside 1..{limit}")
    if any(not 0 <= w < model.vocab_size for w in target):
        raise RuntimeError("token outside the vocabulary")
    if model.vocabulary.eos_id in target[:-1]:
        raise RuntimeError("tokens recorded after EOS")
    if aligned:
        align = np.asarray(hyp.alignment, np.float64)
        if align.shape != (len(target), len(seg)) or not np.isfinite(align).all():
            raise RuntimeError(f"alignment shape {align.shape}")
        if np.abs(align.sum(-1) - 1.0).max() > 1e-3:
            raise RuntimeError("alignment rows do not sum to 1")
    elif hyp.alignment:
        raise RuntimeError("alignment returned without being asked for")


def agreement(a, b) -> float:
    same = total = 0
    for x, y in zip(a, b):
        n = max(len(x.target), len(y.target))
        total += n
        same += sum(1 for i in range(min(len(x.target), len(y.target)))
                    if x.target[i] == y.target[i])
    return same / max(total, 1)


def forward_rate(torch, model, batch, t):
    eos = model.vocabulary.eos_id
    segments = [[3 + (i + j) % 1000 for j in range(t - 1)] + [eos]
                for i in range(batch)]
    model.forward(segments, need_alignment=False)  # warm the allocator
    torch.cuda.synchronize()
    start = time.perf_counter()
    hyps = model.forward(segments, need_alignment=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    tokens = sum(len(h.target) for h in hyps)
    return wall, tokens


def async_return(torch, model, batch, t):
    """(ms until forward_async returned, ms until its finish() did) for
    one B x T batch after a warm-up forward: the batch runs on the
    model's dispatch worker."""
    eos = model.vocabulary.eos_id
    segments = [[3 + (i + j) % 1000 for j in range(t - 1)] + [eos]
                for i in range(batch)]
    model.forward(segments, need_alignment=False)
    torch.cuda.synchronize()
    start = time.perf_counter()
    finish = model.forward_async(segments, need_alignment=False)
    returned = time.perf_counter() - start
    finish()
    torch.cuda.synchronize()
    return returned * 1e3, (time.perf_counter() - start) * 1e3


class InlineDispatch:
    """A dispatch worker stand-in that runs each batch on the caller's
    thread and stream: the yardstick for the worker's host cost."""

    def __init__(self, torch):
        self.torch = torch

    def submit(self, fn):
        from concurrent.futures import Future

        future = Future()
        with self.torch.inference_mode():
            future.set_result(fn())
        return future


def dispatch_turns(torch, model, batch, t, turns=8):
    """Forward walls (ms) through the model's dispatch worker and inline,
    in turns (worker, inline, inline, worker, ...), one warm-up each."""
    eos = model.vocabulary.eos_id
    segments = [[3 + (i + j) % 1000 for j in range(t - 1)] + [eos]
                for i in range(batch)]
    walls = {"worker": [], "inline": []}
    inline = InlineDispatch(torch)
    try:
        for turn in range(turns):
            label = ("worker", "inline", "inline", "worker")[turn % 4]
            if label == "inline":
                model._dispatch_worker = lambda: inline
            else:
                model.__dict__.pop("_dispatch_worker", None)
            model.forward(segments, need_alignment=False)
            torch.cuda.synchronize()
            start = time.perf_counter()
            model.forward(segments, need_alignment=False)
            torch.cuda.synchronize()
            walls[label].append((time.perf_counter() - start) * 1e3)
    finally:
        model.__dict__.pop("_dispatch_worker", None)
    return walls


def loop_segments(eos: int, count: int = 16):
    """`count` segments of 11 to 23 tokens (T bucket 32)."""
    return [[3 + (i * 13 + j) % 1000 for j in range(22 - i % 12)] + [eos]
            for i in range(count)]


def graph_against_eager(what, model, segments, aligned=False):
    """The graph loop's hypotheses bit-equal to the eager loop's on the
    card (tokens, and the alignments where asked for)."""
    with eager_loop(model, True):
        want = model.forward(segments, need_alignment=aligned)
    got = model.forward(segments, need_alignment=aligned)
    if [(h.target, h.alignment) for h in got] != [(h.target, h.alignment) for h in want]:
        raise RuntimeError(f"loop {what}: the graph loop's tokens differ from the eager loop's")
    return sum(len(h.target) for h in got)


UNROLLS = (1, 3, 8)
# With this limit factor, T bucket 32 and a longest segment of 23 tokens,
# max_steps is 41 (odd) and the cap 29 (a multiple of no k in UNROLLS).
ODD_LIMIT_FACTOR = 1.3


def across_unrolls(what, model, segments):
    """Tokens bit-equal across k in UNROLLS, with max_steps odd and the cap
    not a multiple of k; each k a graph of its own."""
    factor = model.limit_factor
    model.limit_factor = ODD_LIMIT_FACTOR
    got = {}
    try:
        for k in UNROLLS:
            model._loop_unroll = k
            got[k] = [h.target for h in model.forward(segments, need_alignment=False)]
    finally:
        model.limit_factor = factor
        model._loop_unroll = None
    if any(got[k] != got[UNROLLS[0]] for k in UNROLLS):
        raise RuntimeError(f"loop {what}: tokens depend on loop_unroll")
    return max(len(t) for t in got[UNROLLS[0]])


def graph_lines(label, model, name, smi):
    """Each of `model`'s decode graphs: its bucket, capture time and memory."""
    for _, bucket in model._graphs.items():
        stats, loop = bucket.stats(), bucket.state
        pool = "not captured" if stats["pool_mb"] is None else f"{stats['pool_mb']:.1f} MB"
        capture = ("not captured" if stats["capture_ms"] is None
                   else f"{stats['capture_ms']:.1f} ms")
        log(f"graph {label} B={loop.prev.shape[0]} T={loop.mask_add.shape[-1]} "
            f"S={loop.projection[0].shape[1]} k={loop.unroll} steps={loop.max_steps} "
            f"alignment={loop.with_alignment}: capture {capture}, pool {pool}, "
            f"buffers {stats['buffers_mb']:.1f} MB on {name} ({smi})")


def skewed_segments(rng, eos: int, count: int = 2048):
    """`count` segments, 1 in 16 of 48-60 tokens and the rest of 4-20
    (the last token EOS)."""
    segments = []
    for i in range(count):
        length = int(rng.integers(48, 61) if i % 16 == 0 else rng.integers(4, 21))
        segments.append(rng.integers(3, 1000, length - 1).tolist() + [eos])
    return segments


def continuous_run(torch, engine, segments):
    """(wall s, token lists) of one translate on the card."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    out = engine.translate(segments)
    torch.cuda.synchronize()
    return time.perf_counter() - start, out


def one_at_a_time(model, segments):
    """Each segment decoded alone (B=1) through Model.forward_async, all
    queued before the first finish."""
    finishes = [model.forward_async([seg], need_alignment=False) for seg in segments]
    return [finish()[0].target for finish in finishes]


def continuous_agreement(what, got, want):
    """Every segment's tokens equal: both sides run the same kernels on the
    same card, so any parted or short row (a slot not reset, cross-talk
    between admitted rows, a stale harvest) fails."""
    unequal = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    log(f"{what}: {len(got) - len(unequal)} of {len(got)} segments equal")
    if len(got) != len(want) or unequal:
        raise RuntimeError(f"{what}: {len(unequal)} of {len(want)} segments differ "
                           f"(the first at {unequal[:8]})")


def longctx(torch, tfm, params, name, smi):
    """The 6-layer tiny11 encoder at a fixed 16,384 tokens a call: B =
    16384 / T. Plain SDPA against blockwise at every T; at T=256 also
    the whole-layer kernel and the split layer with the fused SDPA.
    Median of 5 calls by CUDA events after one warm-up call."""
    dev = params["emb"]["q"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    for t in (256, 512, 768, 1024, 2048):
        b = 16384 // t
        x = torch.randn((b, t, EMB), device=dev, generator=gen)
        mask = torch.ones((b, t), device=dev)
        mask[0, t - t // 4:] = 0.0
        mask_add = tfm.make_additive_mask(mask)
        variants = {"plain SDPA": {}, "blockwise": {"flash": True}}
        if t <= 256:
            variants["whole layer"] = {"fused_layer": True}
            variants["fused SDPA"] = {"fused_sdpa": True}
        for label, gates in variants.items():
            def call():
                return tfm.encoder_forward(params, x, mask_add, HEADS, "xla_int8", **gates)
            call()
            times = []
            for _ in range(5):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                call()
                stop.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(stop))
            median = statistics.median(times)
            log(f"longctx T={t} B={b} {label}: median {median:.3f} ms of "
                f"{[round(v, 3) for v in times]}, {b * t / median * 1e3:.0f} tokens/s "
                f"on {name} ({smi})")


# The knobs phase: the two numerics knobs on the declared config, and the
# kernels each may launch (f32 launches none of the int8 kernels: its
# products are f32 matmuls, as the JAX provider's are jnp.dot).
KNOBS = {"f32": {"qmm_provider": "f32"},
         "encoder float16": {"encoder_dtype": "float16"},
         "encoder bfloat16": {"encoder_dtype": "bfloat16"}}
INT8_KERNELS = ("qmm_affine", "encoder_layer", "whole_decode_step", "ssru_block",
                "ffn_block", "argmax_affine")
# The reference cell: configs of crosscheck.SERVING_CONFIGS on its
# SMOKE_CELL, and the exact row's floor (% of sentences).
REFERENCE_ROWS = ("exact", "packedint+int16+noalign", "enc=float16", "kv=bfloat16")
REFERENCE_EXACT_MIN = 98.0


def knobs(torch, counters, reset, compare, config, package, segments, name, smi):
    """qmm_provider="f32" and encoder_dtype float16/bfloat16 on the
    declared config at the tiny11 width through Model on the card with
    the graph loop: the launch counts reset before each knob and read
    after its runs (f32: no int8 kernel; the half encoders: qmm_affine
    and no encoder_layer, whose gate needs an f32 encoder); one B=64 T=64
    forward, the B=1 T=32 latency line, the tokens of 16 segments against
    the plain CPU path (compare). Returns {knob: counts}."""
    from slimt_tpu_torch import Model
    from slimt_tpu_torch.io.params import dequantized_bytes
    from slimt_tpu_torch.models import decode, loop_graph

    counted = {}
    for label, change in KNOBS.items():
        knob_config = dataclasses.replace(config, **change)
        start = time.perf_counter()
        model = Model(knob_config, package, device="cuda")
        load = time.perf_counter() - start
        reset()
        wall, tokens = forward_rate(torch, model, 64, 64)
        got = latency(torch, model, counters["whole_decode_step"], decode, loop_graph)
        torch.cuda.synchronize()
        counts = {key: counter.launches for key, counter in counters.items()}
        counted[label] = counts
        log(f"knobs {label}: Model loaded in {load:.3f} s, f32 weights "
            f"{dequantized_bytes(model.params) / 1e6:.1f} MB; forward B=64 T=64 full vocab: "
            f"{wall * 1e3:.1f} ms, {tokens} tokens, {tokens / wall:.0f} tok/s on {name} ({smi})")
        log(latency_line(f"knobs {label} graph loop", got, name, smi))
        log(f"launches in the knobs {label} phase: {counts}")
        if label == "f32":
            launched = [key for key in INT8_KERNELS if counts[key]]
            if launched:
                raise RuntimeError(f"knobs f32 launched int8 kernels: {launched}")
        elif not counts["qmm_affine"] or counts["encoder_layer"]:
            raise RuntimeError(f"knobs {label}: qmm_affine {counts['qmm_affine']}, "
                               f"encoder_layer {counts['encoder_layer']} launches")
        compare("knobs", label, knob_config, package, segments)
        del model
    return counted


def reference_cell(torch, counters, reset, name, smi):
    """crosscheck.SMOKE_CELL (narrow 2/2/2, 64 serving lines at B=8, full
    vocabulary and shortlist) on the card against the reference harness
    (or, where it cannot start, its recorded tokens): REFERENCE_ROWS'
    sentences exact and tokens agreeing; the exact row needs
    REFERENCE_EXACT_MIN % of sentences."""
    import tempfile

    from slimt_tpu_torch import crosscheck as cc
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy

    rows = {label: [0, 0, 0, 0] for label in REFERENCE_ROWS}
    options = dict(cc.SERVING_CONFIGS)
    start = time.perf_counter()
    reset()
    log(f"reference cell: the harness {'starts' if cc.harness_runs() else 'does not start'} "
        f"here; {'it runs' if cc.harness_runs() else 'its recorded tokens are read'}")
    with tempfile.TemporaryDirectory(prefix="slimt_reference_") as tmp:
        for leg in cc.serving_legs(tmp, cc.SMOKE_LINES, [cc.SMOKE_CELL]):
            ref = cc.run_reference(leg.paths, leg.config, leg.sentences, leg.batch,
                                   leg.shortlist)
            params = params_from_numpy(load_weights(load_items(leg.model_bytes), leg.config),
                                       "cuda")
            for label in REFERENCE_ROWS:
                got = cc.run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch,
                                  leg.eos, leg.pad, leg.generator if leg.shortlist else None,
                                  device="cuda", params=params, **options[label])
                counts = cc.agreement(ref, got)
                rows[label] = [a + n for a, n in zip(rows[label], counts)]
                se, st, ta, tt = counts
                log(f"reference {leg.what} {label}: {se}/{st} sentences exact, "
                    f"{ta}/{tt} tokens ({100.0 * ta / max(1, tt):.2f}%)")
    torch.cuda.synchronize()
    counts = {key: counter.launches for key, counter in counters.items()}
    log(f"launches in the reference cell: {counts}")
    # The exact and packed rows take the argmax kernel at the cell's E=32.
    if not counts["qmm_affine"] or not counts["argmax_affine"]:
        raise RuntimeError(f"reference cell: qmm_affine {counts['qmm_affine']}, "
                           f"argmax_affine {counts['argmax_affine']} launches")
    for label, (se, st, ta, tt) in rows.items():
        log(f"reference cell {label}: {se}/{st} sentences exact ({100.0 * se / st:.2f}%), "
            f"{100.0 * ta / max(1, tt):.2f}% tokens on {name} ({smi})")
    se, st = rows["exact"][:2]
    if 100.0 * se / st < REFERENCE_EXACT_MIN:
        raise RuntimeError(f"reference cell: the exact row keeps {se}/{st} sentences, "
                           f"under {REFERENCE_EXACT_MIN}%")
    log(f"reference cell: {time.perf_counter() - start:.1f} s")
    return rows


DOOR_KERNELS = ("qmm_affine", "encoder_layer")  # the declared path's kernels


def in_process_cli(argv, stdin=""):
    """(exit code, stdout) of slimt_tpu_torch.cli.main(argv) with stdin
    replaced, in this process."""
    import io

    from slimt_tpu_torch import cli

    out = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin, newline=None)  # universal newlines, as a child's
    try:
        with contextlib.redirect_stdout(out):
            code = cli.main(list(argv))
    finally:
        sys.stdin = saved
    return code, out.getvalue()


def front_doors(torch, counted, model_bytes, spm, shortlist, lines, name, smi):
    """The doors phase: the port's front doors on the card at the tiny11
    width (the serve phase's package, written to a directory): the CLI
    in-process (blocking, --shortlist, --html, --async --workers 2, pivot
    and on model.npz from its `convert`), one `python -m slimt_tpu_torch
    translate` subprocess, TranslationServer behind make_httpd, and the C
    ABI through ctypes. Each answer must equal the port's Blocking or
    Async answer for the same Model on the card; `counted(label, fn)`
    resets the launch counts, runs fn and requires DOOR_KERNELS to have
    launched. Prints each door's first and warm wall."""
    import ctypes
    import os
    import tempfile
    import threading
    import urllib.request

    from slimt_tpu_torch import Async, Model, Package, capi
    from slimt_tpu_torch.bindings import Service
    from slimt_tpu_torch.config import preset
    from slimt_tpu_torch.ops import _capi_build
    from slimt_tpu_torch.server import TranslationServer, make_httpd

    def wall(label, first, warm):
        log(f"doors {label}: first {first:.3f} s, warm {warm:.3f} s on {name} ({smi})")

    def timed(fn):
        start = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - start

    def same(what, got, want):
        if got != want:
            raise RuntimeError(f"doors {what}: {repr(got)[:300]} != {repr(want)[:300]}")

    with tempfile.TemporaryDirectory(prefix="slimt_doors_") as root:
        for file, blob in (("model.bin", model_bytes), ("vocab.spm", spm),
                           ("shortlist.bin", shortlist)):
            with open(os.path.join(root, file), "wb") as f:
                f.write(blob)
        code, out = in_process_cli(["convert", os.path.join(root, "model.bin"),
                                    os.path.join(root, "model.npz")])
        if code != 0:
            raise RuntimeError(f"doors: convert failed ({code}): {out}")
        log(f"doors convert: {out.strip()}")
        join = lambda f: os.path.join(root, f)  # noqa: E731
        model = Model(preset.tiny(), Package(join("model.bin"), join("vocab.spm")))
        listed = Model(preset.tiny(), Package(join("model.bin"), join("vocab.spm"),
                                              join("shortlist.bin")))
        if model.device.type != "cuda":
            raise RuntimeError(f"doors: Model's default device is {model.device}")
        text = "\n".join(lines[:6]) + "\n"
        html = f"<p><b>{lines[0]}</b> {lines[1]}</p><p>{lines[2]}</p>"
        config = Config()  # the CLI's defaults

        def blocking(m, texts, options=Options(), pivot=None):
            with Blocking(config) as service:
                if pivot is not None:
                    return [r.target.text for r in service.pivot(m, pivot, texts, options)]
                return [r.target.text for r in service.translate_bulk(m, texts, options)]

        with Async(dataclasses.replace(config, workers=2)) as service:
            async_text = service.translate(model, text).result().target.text
        html_options = Options(html=True, alignment=True)
        follow = ["--follow-root", root, "--follow-model", "model.bin",
                  "--follow-vocabulary", "vocab.spm"]
        cases = {
            "blocking": ([], blocking(model, [text])[0]),
            "shortlist": (["--shortlist", "shortlist.bin"], blocking(listed, [text])[0]),
            "html": (["--html"], blocking(model, [html], html_options)[0]),
            "async": (["--async", "--workers", "2"], async_text),
            "pivot": (follow, blocking(model, [text], pivot=model)[0]),
            "npz": (["--model", "model.npz"], blocking(model, [text])[0]),
        }
        cli_walls = []
        for label, (extra, want) in cases.items():
            stdin = html if label == "html" else text
            argv = ["translate", "--root", root, *extra]
            for turn in (1, 2) if label == "blocking" else (1,):
                (code, out), seconds = timed(lambda: counted(
                    f"cli {label}", lambda: in_process_cli(argv, stdin)))
                if code != 0:
                    raise RuntimeError(f"doors cli {label}: exit code {code}")
                same(f"cli {label}", out, want + "\n")
                cli_walls.append(seconds)
            log(f"doors cli {label}: stdout equals the port's "
                f"{'Async' if label == 'async' else 'Blocking'} on the card "
                f"({len(out)} characters, {seconds:.3f} s)")
        wall("cli in-process (blocking)", cli_walls[0], cli_walls[1])

        # The real entry point alone: it builds (or finds) and runs the
        # kernels in its own process, and imports no JAX.
        repo = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=repo)
        argv = ["translate", "--root", root, "--text", lines[0]]
        _, want = in_process_cli(argv)
        seconds = []
        for _ in range(2):
            start = time.perf_counter()
            result = subprocess.run(
                [sys.executable, "-X", "importtime", "-m", "slimt_tpu_torch", *argv],
                capture_output=True, text=True, env=env, cwd=repo, timeout=300)
            seconds.append(time.perf_counter() - start)
            if result.returncode != 0:
                raise RuntimeError(f"doors subprocess: rc {result.returncode}\n"
                                   f"{result.stderr[-3000:]}")
            same("cli subprocess", result.stdout, want)
            imported = [line.rsplit("|", 1)[-1].strip() for line in result.stderr.splitlines()
                        if line.startswith("import time:") and "|" in line]
            banned = [m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "slimt_tpu")]
            if banned or "slimt_tpu_torch.cli" not in imported:
                raise RuntimeError(f"doors subprocess imported {banned[:8]}")
            # `import time: self | cumulative | name`, in µs: torch's share.
            torch_us = [int(line.split("|")[1]) for line in result.stderr.splitlines()
                        if line.startswith("import time:")
                        and line.rsplit("|", 1)[-1].strip() == "torch"]
            log(f"doors cli subprocess: {seconds[-1]:.3f} s, of which import torch "
                f"{torch_us[0] / 1e6:.3f} s")
        log("doors cli subprocess: rc 0, stdout equals the in-process CLI's, no JAX imported")
        wall("cli subprocess", *seconds)

        # The HTTP server: the Async streaming lane for single texts and
        # jobs, the bulk lane for 32+ texts.
        # No translation cache: every request reaches the card.
        server = TranslationServer(Config(workers=2, cache_size=0))
        server.add_model("tiny11", model)
        httpd = make_httpd(server, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def call(path, payload=None):
            data = None if payload is None else json.dumps(payload).encode()
            request = urllib.request.Request(url + path, data=data,
                                             headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=300) as resp:
                return resp.status, json.loads(resp.read())

        try:
            status, health = call("/health")
            if status != 200 or health["models"] != ["tiny11"]:
                raise RuntimeError(f"doors /health: {status} {health}")
            status, probe = call("/health/devices")
            if status != 200 or not probe["ok"] or "cuda:0" not in probe["devices"]:
                raise RuntimeError(f"doors /health/devices: {status} {probe}")
            with Async(Config(workers=2)) as service:
                single = service.translate(model, lines[3]).result().target.text
                job_want = service.translate(model, lines[4]).result().target.text
            bulk = lines[8:48]
            bulk_want = blocking(model, bulk)
            single_walls, bulk_walls = [], []
            for _ in range(2):
                (status, body), seconds = timed(lambda: counted(
                    "server /translate", lambda: call("/translate", {"text": lines[3]})))
                same("server /translate", body["target"], single)
                single_walls.append(seconds)
                (status, body), seconds = timed(lambda: counted(
                    "server /translate texts", lambda: call("/translate", {"texts": bulk})))
                same("server /translate texts", body["targets"], bulk_want)
                bulk_walls.append(seconds)
            status, body = call("/submit", {"text": lines[4]})
            for _ in range(6000):
                status, polled = call(f"/job/{body['job']}")
                if polled["done"]:
                    break
                time.sleep(0.01)
            same("server /job", polled.get("target"), job_want)
            status, stats = call("/stats")
            if stats["bulk"]["batches"] < 1 or stats["streaming"]["batches"] < 1:
                raise RuntimeError(f"doors /stats: {stats}")
            log(f"doors server: /health, /health/devices {probe}, /translate (a text; "
                f"{len(bulk)} texts on the bulk lane), /submit and /job, /stats "
                f"{ {k: stats[k] for k in ('requests', 'lines', 'errors')} }: answers equal "
                f"the port's Async and Blocking on the card")
        finally:
            httpd.shutdown()
            thread.join(timeout=60)
            server.close()
        wall("server single request", *single_walls)
        wall(f"server bulk request ({len(bulk)} texts)", *bulk_walls)

        # The C ABI, built here with g++ against this Python, loaded into
        # this process; its model runs on the card (no "device" in the spec).
        start = time.perf_counter()
        path = _capi_build.library_path()
        log(f"doors C ABI: built {path.name} in {time.perf_counter() - start:.2f} s")
        lib = ctypes.CDLL(str(path))
        lib.slimt_init.argtypes = [ctypes.c_char_p]
        lib.slimt_last_error.restype = ctypes.c_char_p
        lib.slimt_service_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.slimt_service_create.restype = ctypes.c_longlong
        lib.slimt_model_create.argtypes = [ctypes.c_char_p]
        lib.slimt_model_create.restype = ctypes.c_longlong
        strings = ctypes.POINTER(ctypes.c_char_p)
        lib.slimt_translate.argtypes = [ctypes.c_longlong, ctypes.c_longlong, strings,
                                        ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.slimt_translate.restype = strings
        lib.slimt_free_strings.argtypes = [strings]
        lib.slimt_release.argtypes = [ctypes.c_longlong]
        if lib.slimt_init(repo.encode()) != 0:
            raise RuntimeError(f"doors slimt_init: {lib.slimt_last_error().decode()}")
        handle = lib.slimt_model_create(json.dumps(
            {"preset": "tiny", "model": join("model.bin"), "vocabulary": join("vocab.spm")}
        ).encode())
        service = lib.slimt_service_create(1, 0)
        if not handle or not service:
            raise RuntimeError(f"doors C ABI: {lib.slimt_last_error().decode()}")
        texts = lines[48:52]
        array = (ctypes.c_char_p * len(texts))(*[t.encode() for t in texts])

        def translate():
            out = lib.slimt_translate(service, handle, array, len(texts), 0, 0)
            if not out:
                raise RuntimeError(f"doors slimt_translate: {lib.slimt_last_error().decode()}")
            try:
                return [out[i].decode() for i in range(len(texts))]
            finally:
                lib.slimt_free_strings(out)

        held = capi._get(handle)
        if held.device.type != "cuda":
            raise RuntimeError(f"doors C ABI: the model is on {held.device}")
        reference = Service(workers=1, cache_size=0)
        try:
            want = [r.target.text for r in reference.translate(held, texts)]
        finally:
            reference.close()
        capi_walls = []
        for _ in range(2):
            got, seconds = timed(lambda: counted("C ABI", translate))
            same("C ABI slimt_translate", got, want)
            capi_walls.append(seconds)
        lib.slimt_release(handle)
        lib.slimt_release(service)
        log(f"doors C ABI: slimt_translate of {len(texts)} texts equals bindings.Service on "
            f"the card")
        wall(f"C ABI slimt_translate ({len(texts)} texts)", *capi_walls)
        jni_door(repo, root, texts, name, smi)


def jni_door(repo, root, texts, name, smi):
    """The JNI door: the port's JNI binding and fake-JVM host, built with
    g++ into slimt_tpu_torch/build/, the host dlopening the binding with
    RTLD_LOCAL as a JVM does, with no device field in its Config (the
    card); its lines must equal the C ABI's object table for the same
    spec on the card. The host is its own process: its launches are not
    counted here."""
    from slimt_tpu_torch import capi
    from slimt_tpu_torch.config import preset
    from slimt_tpu_torch.ops import _native_build

    start = time.perf_counter()
    library, host = _native_build.jni_library_path(), _native_build.jni_host_path()
    log(f"doors JNI: built {library.name} and {host.name} in "
        f"{time.perf_counter() - start:.2f} s")
    config = preset.tiny()
    layers = [str(v) for v in (config.encoder_layers, config.decoder_layers,
                               config.feed_forward_depth, config.num_heads)]
    env = dict(os.environ, SLIMT_TPU_TORCH_PYTHONPATH=repo)
    env.pop("SLIMT_JNI_DEVICE", None)
    start = time.perf_counter()
    result = subprocess.run([str(host), str(library), root, *layers, *texts],
                            capture_output=True, text=True, env=env, timeout=600)
    seconds = time.perf_counter() - start
    if result.returncode != 0:
        raise RuntimeError(f"doors JNI: rc {result.returncode}\n{result.stderr[-3000:]}")
    spec = {"preset": "tiny", "encoder_layers": config.encoder_layers,
            "decoder_layers": config.decoder_layers,
            "feed_forward_depth": config.feed_forward_depth, "num_heads": config.num_heads,
            "split_mode": "sentence", "model": os.path.join(root, "model.bin"),
            "vocabulary": os.path.join(root, "vocab.spm"),
            "shortlist": os.path.join(root, "shortlist.bin")}
    service = capi.service_create(1, 64)
    model = capi.model_create(json.dumps(spec))
    try:
        if capi._get(model).device.type != "cuda":
            raise RuntimeError(f"doors JNI: the C ABI's model is on {capi._get(model).device}")
        want = capi.translate(service, model, texts)
    finally:
        capi.release(model)
        capi.release(service)
    if result.stdout.splitlines() != want:
        raise RuntimeError(f"doors JNI: {result.stdout.splitlines()!r:.300} != {want!r:.300}")
    log(f"doors JNI: Service.ntranslate of {len(texts)} texts through the fake JVM equals "
        f"the C ABI's object table on the card; process wall {seconds:.3f} s (an embedded "
        f"interpreter importing torch) on {name} ({smi})")


# The parity phase's launch requirements: `providers` runs the fused and
# fused_step providers (#5, #6, #7 at E=64); `matrix`, the exact
# numerics, runs the int8 affine at E 32 and 64.
PARITY_KERNELS = {"providers": ("qmm_affine", "ssru_block", "ffn_block", "whole_decode_step"),
                  "matrix": ("qmm_affine",)}


def parity_phase(torch, counters, reset, name, smi):
    """`python -m slimt_tpu_torch.parity providers` and `matrix` on the
    card, in this process (their default sizes), counts reset before
    each: both must exit 0 and launch PARITY_KERNELS."""
    import io

    from slimt_tpu_torch import parity

    for mode, kernels in PARITY_KERNELS.items():
        reset()
        start = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = parity.main([mode, "--device", "cuda"])
        torch.cuda.synchronize()
        counts = {key: counter.launches for key, counter in counters.items()}
        for line in out.getvalue().splitlines():
            log(f"parity {mode}: {line}")
        log(f"parity {mode}: exit {code} in {time.perf_counter() - start:.1f} s; launches "
            f"{counts} on {name} ({smi})")
        missing = [key for key in kernels if not counts[key]]
        if code != 0 or missing:
            raise RuntimeError(f"parity {mode}: exit {code}, kernels never launched {missing}")


def in_process_translate(argv, text):
    """`python -m slimt_tpu_torch translate ARGV` in this process, for the
    crosscheck modes: its launches count here."""
    code, out = in_process_cli(["translate", *argv], text)
    if code != 0:
        raise RuntimeError(f"translate {argv}: exit code {code}")
    return out


BLEU_KERNELS = ("qmm_affine", "encoder_layer", "argmax_affine")


def bleu_leg(torch, counters, reset, root, name, smi):
    """`crosscheck bleu` at full width on the card: the tiny preset (6+2
    layers, 8 heads) at E=256 F=1536 from `synth` (written to `root`), the
    first 128 lines of data/corpus.txt through the declared serving
    config and the exact path (in this process, so #2's launches count;
    #8 runs inside each, the SDPA launch of #2's C entry), against the
    reference CLI's lines recorded in crosscheck/reference_cli.json. The
    exact path must keep crosscheck.BLEU_EXACT_MIN of lines, the reference
    and both paths must give one line a source and all of them be scored;
    where a line parts, its first differing word is printed. The tokenizer
    backend is "native" inside the leg only."""
    import types

    from slimt_tpu_torch import crosscheck as cc

    cc.synth_package(root, 256, 1536, prefixes=False)
    args = types.SimpleNamespace(device="cuda", bleu_package=root, bleu_model="model.bin",
                                 bleu_vocab="vocab.spm", bleu_source=None, bleu_reference=None,
                                 bleu_lines=cc.BLEU_LINES)
    with open(cc.CORPUS) as f:
        text = "\n".join([line.rstrip("\n") for line in f if line.strip()][:cc.BLEU_LINES])
    ref = cc.run_reference_cli(root, ["--model", "model.bin", "--vocabulary", "vocab.spm"],
                               text)
    outputs = {}  # the port's lines of each path: serving, then exact

    def translate(argv, source):
        out = in_process_translate(argv, source)
        outputs["exact" if "--exact" in argv else "serving"] = out.splitlines()
        return out

    reset()
    start = time.perf_counter()
    with mock.patch.dict(os.environ, {"SLIMT_TPU_BATCH_BACKEND": "native"}):
        report = cc.bleu_report(args, translate=translate)
    torch.cuda.synchronize()
    counts = {key: counter.launches for key, counter in counters.items()}
    sizes = {"reference": len(ref), **{key: len(lines) for key, lines in outputs.items()}}
    log(f"bleu E=256 F=1536: reference CLI {cc.reference_cli_source()}")
    log(f"bleu E=256 F=1536: {json.dumps(report)} in {time.perf_counter() - start:.1f} s; "
        f"lines {sizes} of {cc.BLEU_LINES} sources; exact-path lines equal to the reference "
        f"CLI {report['line_exact_vs_reference_exact']} (gate {cc.BLEU_EXACT_MIN}); launches "
        f"{counts}, #8 inside each of #2's {counts['encoder_layer']} on {name} ({smi})")
    for i, (a, b) in enumerate(zip(ref, outputs.get("exact", []))):
        if a != b:
            k = next((j for j, (x, y) in enumerate(zip(a.split(), b.split())) if x != y),
                     min(len(a.split()), len(b.split())))
            log(f"bleu E=256 line {i} parts at word {k}: reference {a.split()[k:k + 3]} "
                f"port {b.split()[k:k + 3]}")
    if report["lines"] != cc.BLEU_LINES or set(sizes) != {"reference", "serving", "exact"} \
            or set(sizes.values()) != {cc.BLEU_LINES}:
        raise RuntimeError(f"bleu E=256: {report['lines']} lines scored, lines {sizes}, "
                           f"{cc.BLEU_LINES} sources")
    missing = [key for key in BLEU_KERNELS if not counts[key]]
    if missing or report["line_exact_vs_reference_exact"] < cc.BLEU_EXACT_MIN:
        raise RuntimeError(f"bleu E=256: kernels never launched {missing}, exact lines "
                           f"{report['line_exact_vs_reference_exact']}")
    return report


# The wrappers the traced forward (fused_step at E=256) must launch, and
# the kernel names the trace must hold for each: #1's, #2's three (its
# SDPA is #8's attention_kernel) and #7's layers and projection kernels.
TRACE_KERNELS = {"qmm_affine": ("affine",),
                 "encoder_layer": ("qkv_kernel", "attention_kernel", "post_attention_kernel"),
                 "whole_decode_step": ("layers_kernel", "project_kernel", "pick_kernel")}


def trace_model(root):
    """The bleu leg's package in `root` under the fused_step provider (few
    kernels a step, so a trace stays small), and the segments of the
    first 4 lines of data/corpus.txt."""
    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.config import preset

    config = dataclasses.replace(preset.tiny(), qmm_provider="fused_step")
    model = Model(config, Package(os.path.join(root, "model.bin"),
                                  os.path.join(root, "vocab.spm")))
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                           "corpus.txt")) as f:
        lines = [line.strip() for line in f if line.strip()][:4]
    return model, [model.vocabulary.encode(line, add_eos=True)[0] for line in lines]


def traced_forward(torch, model, segments):
    """One forward of `segments` under slimt_tpu_torch.utils.trace into a
    temporary directory: the Chrome trace's events and its size in bytes."""
    import glob

    from slimt_tpu_torch.utils import trace

    with tempfile.TemporaryDirectory(prefix="slimt_trace_") as out:
        with trace("slimt_forward", out):
            model.forward(segments, need_alignment=False)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(out, "slimt_forward.*.pt.trace.json"))
        if len(files) != 1:
            raise RuntimeError(f"trace: {len(files)} trace files in {out}")
        with open(files[0]) as f:
            return json.load(f)["traceEvents"], os.path.getsize(files[0])


def trace_gaps(events):
    """The launches (runtime events, graph launches too) of which the trace
    holds no kernel, each as (call, microseconds after the scope opened),
    and the least microseconds from a launch to the first of its kernels
    (below 0 where the profiler put the card's clock early)."""
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            key = e["args"].get("correlation")
            kernels[key] = min(kernels.get(key, e["ts"]), e["ts"])
    opened = min((e["ts"] for e in events if e.get("name") == "slimt_forward"), default=0.0)
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "")]
    dropped = [(e["name"], round(e["ts"] - opened, 1)) for e in launches
               if e["args"].get("correlation") not in kernels]
    gaps = [kernels[e["args"]["correlation"]] - e["ts"] for e in launches
            if e["args"].get("correlation") in kernels]
    return dropped, round(min(gaps), 1) if gaps else None


def trace_once(root: str) -> None:
    """The --trace-once mode, the trace phase's child process: the warm
    forward of trace_model(root), then one under utils.trace with the
    wrappers' counts set to 0 before it; prints one JSON line of the
    counts, the port's kernels the trace names, the launches it lacks a
    kernel of and where they were."""
    import collections

    import torch

    from slimt_tpu_torch.ops import _build
    from slimt_tpu_torch.ops import decoder_step, encoder_layer, qmm

    _build.library()
    counters = {"qmm_affine": qmm.affine_kernel, "encoder_layer": encoder_layer.layer_kernel,
                "whole_decode_step": decoder_step.whole_step_kernel}
    model, segments = trace_model(root)
    model.forward(segments, need_alignment=False)  # warm: the trace holds one forward
    for counter in counters.values():
        counter.launches = 0
    start = time.perf_counter()
    events, size = traced_forward(torch, model, segments)
    seconds = time.perf_counter() - start
    dropped, gap = trace_gaps(events)
    offsets = [at for _, at in dropped]
    print(json.dumps({
        "lines": len(segments), "bytes": size, "events": len(events), "seconds": seconds,
        "counts": {key: counter.launches for key, counter in counters.items()},
        "named": dict(sorted(collections.Counter(
            short_kernel(e["name"]) for e in events
            if e.get("cat") == "kernel" and "slimt::" in e["name"]).items())),
        "dropped": len(dropped), "calls": dict(collections.Counter(c for c, _ in dropped)),
        "at_us": [min(offsets), max(offsets)] if offsets else None, "least_gap_us": gap}))


# Fresh processes the trace phase may take to get a trace that holds a
# kernel for every launch: a long-running process can lose the first
# milliseconds of a trace's non-graph kernels in every session (PERF.md
# §6, PR 13), and such a trace cannot show whether the port's kernels ran.
TRACE_PROCESSES = 3


def trace_phase(root, name, smi):
    """One forward of the bleu leg's package (trace_model) under
    slimt_tpu_torch.utils.trace, in a process of its own (trace_once):
    the wrappers of TRACE_KERNELS must launch and the Chrome trace must
    name their kernels. A trace lacking the kernel of any launch (printed
    with where the launches were) is taken again in a new process, up to
    TRACE_PROCESSES times."""
    for attempt in range(1, TRACE_PROCESSES + 1):
        start = time.perf_counter()
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-once", root],
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            raise RuntimeError(f"trace: the traced process exited {run.returncode}: "
                               f"{run.stderr[-2000:]}")
        got = json.loads(run.stdout.strip().splitlines()[-1])
        log(f"trace {attempt}: one fused_step forward of {got['lines']} lines under "
            f"utils.trace in a new process ({time.perf_counter() - start:.1f} s) wrote "
            f"{got['bytes']} bytes ({got['events']} events) in {got['seconds']:.1f} s; "
            f"launches {got['counts']}; the port's kernels named {got['named']}; launches "
            f"without a kernel in the trace {got['dropped']} {got['calls']} at "
            f"{got['at_us']} us after the scope opened; least launch-to-kernel "
            f"{got['least_gap_us']} us on {name} ({smi})")
        if not got["dropped"]:
            break
    if got["dropped"]:
        raise RuntimeError(f"trace: each of {TRACE_PROCESSES} traces lacks launched kernels")
    missing = [key for key, n in got["counts"].items() if not n]
    missing += [want for wants in TRACE_KERNELS.values() for want in wants
                if not any(want in kernel for kernel in got["named"])]
    if missing:
        raise RuntimeError(f"trace: not launched or not named: {missing}")


def trace_sessions(sessions: int) -> None:
    """The --trace-sessions mode: `sessions` traced forwards (trace_model)
    with utils.TRACE_PAD_S set to 0, then as committed; for each, the
    sessions whose trace lacks a launched kernel, and each session's
    dropped launches and least launch-to-kernel microseconds."""
    import torch

    name, smi = probe(torch)
    from slimt_tpu_torch import crosscheck as cc
    from slimt_tpu_torch import utils
    from slimt_tpu_torch.ops import _build

    _build.library()
    committed = utils.TRACE_PAD_S
    with tempfile.TemporaryDirectory(prefix="slimt_trace_") as root:
        cc.synth_package(root, 256, 1536, prefixes=False)
        model, segments = trace_model(root)
        model.forward(segments, need_alignment=False)
        for pad in (0.0, committed):
            utils.TRACE_PAD_S = pad
            got = [trace_gaps(traced_forward(torch, model, segments)[0])
                   for _ in range(sessions)]
            log(f"trace sessions, pad {pad} s: {sum(1 for d, _ in got if d)} of {sessions} "
                f"lack a launched kernel; dropped {[len(d) for d, _ in got]}; least "
                f"launch-to-kernel us {[g for _, g in got]} on {name} ({smi})")
    utils.TRACE_PAD_S = committed


LAYOUT_BATCHES = (1, 8, 64, 130, 200, 512)
LAYOUT_KERNELS = ("whole_decode_step", "ffn_block", "decoder_layer_step", "ssru_block",
                  "argmax_affine", "encoder_layer", "decode_attention")
# The encoder layer (#2) at both widths: B=64 and 512 at T=64, and 16,384
# tokens a call at T=128 and T=256; the decode attention (#3) at
# LAYOUT_BATCHES, T=64, and at B=8 and 256 T=1024 (tiny width), by the
# kernel the wrapper chooses and, where it takes `_kernel`, by each of its
# two kernels.
LAYER_WIDTHS = ((256, 1536), (512, 2048))
LAYER_SHAPES = ((64, 64), (512, 64), (128, 128), (64, 256))
ATTN_SHAPES = tuple((b, 64) for b in LAYOUT_BATCHES) + ((8, 1024), (256, 1024))
DECODER_LAYOUT_KERNELS = ("whole_decode_step", "ffn_block", "decoder_layer_step", "ssru_block")
DIGESTED = ("encoder_layer", "decode_attention")  # outputs compared across trees
# The argmax (#4) at the batches the records keep, its exact and packed
# methods, the full vocabulary and the two shortlists.
ARGMAX_BATCHES = (1, 64, 512)
ARGMAX_METHODS = ("exact", "packed_fp16")
ARGMAX_WIDTHS = (0, 1024, 3072)


def kernel_split(torch, fn, calls=20, counts=None):
    """Device ms per call of `fn` by kernel name: `calls` calls (already
    warm) under torch.profiler, each kernel's time summed and divided by
    `calls`. Where `counts` is a dict, it receives each kernel's launches
    per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for event in prof.events():
        if event.device_type == DeviceType.CUDA:
            split[event.name] = split.get(event.name, 0.0) + event.time_range.elapsed_us()
            if counts is not None:
                counts[event.name] = counts.get(event.name, 0) + 1 / calls
    return {name: us / calls / 1e3 for name, us in split.items()}


def short_kernel(name: str) -> str:
    """A profiler's kernel name without its namespace and parameters."""
    return name.replace("void ", "").replace("slimt::(anonymous namespace)::", "").split("(")[0]


def digest(tensor) -> str:
    """SHA-256 of a tensor's bytes, as the host holds them."""
    return hashlib.sha256(tensor.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def attention_case(torch, gen, dev, b, t, e):
    """Inputs of the decode attention (#3): random q, an int16 cache with
    per-row scales, row 0 padded from T/2 and (B > 1) the last row fully
    masked."""
    q = torch.randn((b, e), device=dev, generator=gen)
    k, v = (torch.randint(-32767, 32768, (b, t, e), device=dev,
                          dtype=torch.int16, generator=gen) for _ in range(2))
    kqi, vqi = ((torch.rand((b, t), device=dev, generator=gen) * 1.5 + 0.5)
                / 32767.0 for _ in range(2))
    mask = torch.zeros((b, t), device=dev)
    mask[0, t // 2:] = MASK_MIN
    if b > 1:
        mask[-1] = MASK_MIN
    return q, k, v, kqi, vqi, mask


def layer_case(torch, gen, dev, b, t, e):
    """Inputs of the encoder layer (#2): random x, row 1 padded from T/2
    and (B > 3) row 3 a padding row."""
    x = torch.randn((b, t, e), device=dev, generator=gen)
    mask = torch.ones((b, t), device=dev)
    if b > 1:
        mask[1, t // 2:] = 0
    if b > 3:
        mask[3] = 0
    return x, ((1.0 - mask) * MASK_MIN)[:, None, None, :]


def layout_times(out: str, kernels=LAYOUT_KERNELS) -> None:
    """The --layouts mode (see the module's note)."""
    import inspect

    import torch

    name, smi = probe(torch)
    from slimt_tpu_torch import ModelConfig
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models import transformer as tfm
    from slimt_tpu_torch.ops import _build
    from slimt_tpu_torch.ops import decode_attn as dattn
    from slimt_tpu_torch.ops import decoder_step as dstep
    from slimt_tpu_torch.ops import encoder_layer as enc
    from slimt_tpu_torch.ops import fused_blocks as fblocks
    from slimt_tpu_torch.ops import logits_argmax as lam

    unknown = set(kernels) - set(LAYOUT_KERNELS)
    if unknown:
        raise SystemExit(f"--layouts: unknown kernels {sorted(unknown)}; "
                         f"choose from {LAYOUT_KERNELS}")
    dev = torch.device("cuda", 0)
    _build.library()
    config = ModelConfig(encoder_layers=1, decoder_layers=DEC)
    params = params_from_numpy(load_weights(load_items(synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=0)), config), dev)
    layer = params["decoder"][0]
    forced = "_cluster" in inspect.signature(fblocks.ffn_kernel).parameters
    ssru_forced = "_cluster" in inspect.signature(fblocks.ssru_kernel).parameters
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    record = {"device": name, "power": smi, "package": str(fblocks.__file__), "times": []}

    def timed(kernel, b, cs, make, split=False, **labels):
        if kernel not in kernels:
            return
        try:
            fn, used = make()
            out = fn()
        except RuntimeError as exc:  # a size the card cannot schedule
            if cs is None or "cannot schedule" not in str(exc):
                raise
            return
        torch.cuda.synchronize()
        ms = cuda_ms(torch, fn, 50)
        graph = statistics.median(graph_ms(torch, fn) for _ in range(3))
        entry = {"kernel": kernel, "b": b, "forced": cs, "cs": used, **labels,
                 "ms": ms, "graph_ms": graph}
        if split:
            counts = {}
            entry["split_ms"] = kernel_split(torch, fn, counts=counts)
            entry["launches_per_call"] = round(sum(counts.values()), 6)
        if kernel in DIGESTED:
            entry["sha256"] = digest(out)
        record["times"].append(entry)
        shown = "".join(f" {key}={value}" for key, value in labels.items())
        log(f"layouts {kernel} B={b}{shown} cs={'auto' if cs is None else cs} (runs {used}): "
            f"{ms:.4f} ms, {graph:.4f} ms in a CUDA graph"
            + (f"; {entry['launches_per_call']} launches a call, by kernel "
               f"{entry['split_ms']}" if split else "")
            + (f"; sha256 {entry['sha256']}" if "sha256" in entry else ""))

    # Fixed inputs from seeded generators, so that another tree's run
    # digests the same inputs.
    for emb, ffn in LAYER_WIDTHS if "encoder_layer" in kernels else ():
        config = ModelConfig(encoder_layers=1, decoder_layers=1)
        enc_layer = params_from_numpy(load_weights(load_items(synthetic_model_bytes(
            config=config, vocab_size=64, emb_dim=emb, ffn_dim=ffn, seed=0)), config),
            dev)["encoder"][0]
        for b, t in LAYER_SHAPES:
            gen.manual_seed(b * t + emb)
            x, enc_mask = layer_case(torch, gen, dev, b, t, emb)
            timed("encoder_layer", b, None,
                  lambda: ((lambda: enc.layer_kernel(x, enc_layer, enc_mask, HEADS)), None),
                  split=True, t=t, e=emb, f=ffn)
    attn_kernels = (None,)
    if "_kernel" in inspect.signature(dattn.decode_attention_kernel).parameters:
        attn_kernels += ("block", "warp")
    for b, t in ATTN_SHAPES if "decode_attention" in kernels else ():
        gen.manual_seed(b * t)
        attn_args = attention_case(torch, gen, dev, b, t, EMB)
        for kern in attn_kernels:
            extra = {} if kern is None else {"_kernel": kern}
            timed("decode_attention", b, kern,
                  lambda: ((lambda: dattn.decode_attention_kernel(*attn_args, HEADS, **extra)),
                           kern),
                  split=True, t=t, e=EMB)
    gen.manual_seed(3)

    for b in LAYOUT_BATCHES if set(kernels) & set(DECODER_LAYOUT_KERNELS) else ():
        args = step_case(torch, tfm, params, gen, b, 64, 0)
        x = torch.randn((b, EMB), device=dev, generator=gen)
        c = torch.randn((b, 1, EMB), device=dev, generator=gen)
        state = torch.randn((b, EMB), device=dev, generator=gen)
        kv = tuple(float_cache(torch, gen, (b, HEADS, 64, EMB // HEADS), "float32")
                   for _ in range(2))
        mask_add = args[3]
        for cs in (None,) + fblocks.CLUSTER_SIZES:
            extra = {} if cs is None else {"_cluster": cs}

            def step():
                plan = dstep.StepPlan(args[0], args[4], args[3], HEADS, *args[6:], **extra)
                used = getattr(plan, "cs", None)
                return (lambda: dstep.whole_step_kernel(*args, plan=plan)), used

            def ffn():
                used = fblocks.ffn_layout(b, EMB, FFN, 0, cs)[0] if forced else None
                return (lambda: fblocks.ffn_kernel(x, layer["ffn"], **extra)), used

            def layer_step():
                kind = dstep.SPLIT_KINDS[torch.float32]
                used = dstep.step_layout(b, EMB, FFN, HEADS, 64, kind, 0, cs)[0] if forced else None
                return (lambda: dstep.decoder_layer_step_kernel(
                    layer, c, x[:, None], mask_add, kv, HEADS, **extra)), used

            def ssru():
                used = fblocks.ssru_layout(b, EMB, 0, cs)[0] if ssru_forced else None
                return (lambda: fblocks.ssru_kernel(x, state, layer["rnn"], **extra)), used

            if cs is None or forced:
                timed("whole_decode_step", b, cs, step)
                timed("ffn_block", b, cs, ffn)
                timed("decoder_layer_step", b, cs, layer_step)
            if cs is None or ssru_forced:
                timed("ssru_block", b, cs, ssru)
    aq, inv = params["out"]["aq"], tfm.output_inv(params)
    for width in ARGMAX_WIDTHS if "argmax_affine" in kernels else ():
        w, bias = tfm.prepare_output_projection(params, None if not width else torch.randperm(
            VOCAB, device=dev, generator=gen)[:width].sort().values)
        for b in ARGMAX_BATCHES:
            y = torch.randn((b, EMB), device=dev, generator=gen)
            for method in ARGMAX_METHODS:
                timed("argmax_affine", b, None,
                      lambda: ((lambda: lam.argmax_affine_kernel(y, w, bias, aq, inv, method)),
                               None),
                      split=True, method=method, width=width or VOCAB)
    with open(out, "w") as handle:
        json.dump(record, handle, indent=1)
    log(f"layouts: {len(record['times'])} timings on {name} ({smi}) into {out}")


UNROLL_SWEEP = (1, 2, 4, 8, 16)


def unroll_times() -> None:
    """The --unroll mode: the graph loop at k in UNROLL_SWEEP (ascending,
    then descending) on the declared, fused_step and fused paths at the
    tiny11 widths: the B=1 T=32 latency line and the B=64 and B=512 T=64
    forward lines of each k."""
    import torch

    name, smi = probe(torch)
    from slimt_tpu_torch import Model, ModelConfig, Package
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models import decode, loop_graph
    from slimt_tpu_torch.ops import decoder_step as dstep
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    config = ModelConfig(encoder_layers=ENC, decoder_layers=DEC, num_heads=HEADS)
    package = Package(
        synthetic_model_bytes(config=config, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN,
                              seed=0),
        spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS, target_size=VOCAB)))
    configs = {"declared": config,
               "fused_step": dataclasses.replace(config, qmm_provider="fused_step"),
               "fused": dataclasses.replace(config, qmm_provider="fused", attn_kernel="on")}
    for path, path_config in configs.items():
        model = Model(path_config, package, device="cuda")
        for k in UNROLL_SWEEP + UNROLL_SWEEP[::-1]:
            model._loop_unroll = k
            got = latency(torch, model, dstep.whole_step_kernel, decode, loop_graph)
            log(latency_line(f"{path} k={k}", got, name, smi))
            for batch in (64, 512):
                wall, tokens = forward_rate(torch, model, batch, 64)
                log(f"forward {path} k={k} B={batch} T=64 full vocab: {wall * 1e3:.1f} ms, "
                    f"{tokens} tokens, {tokens / wall:.0f} tok/s on {name} ({smi})")
        graph_lines(path, model, name, smi)
        del model


def main() -> None:
    import torch

    name, smi = probe(torch)

    from slimt_tpu_torch import Model, ModelConfig, Package
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.io.shortlist import build_synthetic_shortlist
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.models import transformer as tfm
    from slimt_tpu_torch.models import decode, loop_graph
    from slimt_tpu_torch.models.continuous import ContinuousEngine
    from slimt_tpu_torch.ops import _build
    from slimt_tpu_torch.ops import attention as att
    from slimt_tpu_torch.ops import decode_attn as dattn
    from slimt_tpu_torch.ops import decoder_step as dstep
    from slimt_tpu_torch.ops import encoder_layer as enc
    from slimt_tpu_torch.ops import fused_blocks as fblocks
    from slimt_tpu_torch.ops import logits_argmax as lam
    from slimt_tpu_torch.ops import qmm
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model

    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - start:.2f} s into {_build.BUILD_DIR}")
    from slimt_tpu_torch import native

    start = time.perf_counter()
    if not native.available():
        raise RuntimeError("the port's native host library did not load")
    log(f"native host library: {native.library_path()} in "
        f"{time.perf_counter() - start:.2f} s")

    def load_host(emb, ffn, enc_layers, dec_layers, vocab=64):
        config = ModelConfig(encoder_layers=enc_layers, decoder_layers=dec_layers)
        return load_weights(load_items(synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0)),
            config)

    affine_err, affine_times = check_affine(torch, qmm, dev)
    layer_err, layer_ms = check_layer(torch, enc, dev, load_host, params_from_numpy)
    step_err, step_ms = check_step(torch, dstep, lam, tfm, qmm, dev, load_host,
                                   params_from_numpy)
    block_err, block_ms = check_blocks(torch, fblocks, dev, load_host, params_from_numpy)
    start = time.perf_counter()
    check_widths(torch, fblocks, dstep, tfm, dev, load_host, params_from_numpy, name, smi)
    log(f"widths phase: {time.perf_counter() - start:.1f} s")
    attn_err, attn_ms = check_attention(torch, dattn, dev)
    widths = [params_from_numpy(load_host(emb, ffn, 1, DEC, vocab=VOCAB), dev)
              for emb, ffn in ((EMB, FFN), (512, 2048))]
    # The crosscheck cells' widths too (32, 64), and one of neither path's
    # multiples (40).
    narrow = [params_from_numpy(load_host(emb, 2 * emb, 1, DEC, vocab=VOCAB), dev)
              for emb in (32, 40, 64)]
    argmax_err, argmax_ms = check_argmax(torch, lam, tfm, widths + narrow)
    del narrow
    sdpa_err, sdpa_ms = check_fused_sdpa(torch, att, enc, dev)
    blockwise_err, blockwise_ms = check_blockwise(torch, att, dev)
    layer_step_launches, layer_step_err, layer_step_ms = check_layer_steps(
        torch, dstep, dev, load_host, params_from_numpy)
    step_float_err, step_float_ms = check_step_float(torch, dstep, tfm, dev, widths)
    del widths
    log(f"kernel times above on {name} ({smi})")

    config = ModelConfig(encoder_layers=ENC, decoder_layers=DEC, num_heads=HEADS)
    fused_step = dataclasses.replace(config, qmm_provider="fused_step")
    fused = dataclasses.replace(config, qmm_provider="fused", attn_kernel="on")
    split = dataclasses.replace(config, encoder_layer_kernel="off", encoder_sdpa="on")
    # Per path, the config of each package's model.
    path_configs = {
        "declared": {"full vocab": config, "shortlist": config},
        "fused_step": {"full vocab": fused_step, "shortlist": fused_step},
        "fused": {"full vocab": fused,  # packed_int: the exact argmax under fused
                  "shortlist": dataclasses.replace(fused, argmax_method="packed_fp16")},
        "split": {"full vocab": split,
                  "shortlist": dataclasses.replace(split, qmm_provider="fused")},
    }
    model_bytes = synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=EMB, ffn_dim=FFN, seed=0)
    spm = spm_proto.serialize_model(
        build_spm_model(DEFAULT_WORDS, target_size=VOCAB))
    shortlist = build_synthetic_shortlist(VOCAB, best=20, frequent=100)
    packages = {"full vocab": Package(model_bytes, spm),
                "shortlist": Package(model_bytes, spm, shortlist)}
    rng = np.random.default_rng(0)
    lines = make_lines(rng, np.array(DEFAULT_WORDS), 96, 8, 120)
    long_lines = make_lines(rng, np.array(DEFAULT_WORDS), 4, 880, 920)
    counters = {"qmm_affine": qmm.affine_kernel,
                "encoder_layer": enc.layer_kernel,
                "whole_decode_step": dstep.whole_step_kernel,
                "ssru_block": fblocks.ssru_kernel,
                "ffn_block": fblocks.ffn_kernel,
                "decode_attention": dattn.decode_attention_kernel,
                "argmax_affine": lam.argmax_affine_kernel,
                "fused_sdpa": att.fused_sdpa_kernel,
                "blockwise_attention": att.blockwise_kernel}
    path_kernels = {"declared": ("qmm_affine", "encoder_layer"),
                    "fused_step": ("qmm_affine", "encoder_layer", "whole_decode_step"),
                    "fused": ("qmm_affine", "encoder_layer", "ssru_block", "ffn_block",
                              "decode_attention", "argmax_affine"),
                    "split": ("qmm_affine", "fused_sdpa", "ffn_block"),
                    "long": ("qmm_affine", "blockwise_attention", "whole_decode_step",
                             "ssru_block", "ffn_block", "decode_attention",
                             "argmax_affine"),
                    "kv": ("qmm_affine", "encoder_layer", "whole_decode_step",
                           "ssru_block", "ffn_block", "argmax_affine"),
                    "continuous": ("qmm_affine", "encoder_layer", "whole_decode_step")}

    def reset():
        for counter in counters.values():
            counter.launches = 0

    def read(path):
        counts = {key: counter.launches for key, counter in counters.items()}
        log(f"launches in the {path} serving phase: {counts}")
        missing = [key for key in path_kernels[path] if not counts[key]]
        if missing:
            raise RuntimeError(f"{path}: kernels never launched: {missing}")
        # The record takes each kernel's count from the first path it serves.
        for key in path_kernels[path]:
            launches.setdefault(key, counts[key])

    def compare(path, label, config, pkg, segments, limit_factor=1.5):
        """CUDA tokens against the plain CPU path (check_agreement): a near
        tie is allowed on the kv configs of TIE_CACHES and on the knobs,
        whose f32 sums (every product under f32; the half encoders' LN
        and softmax ahead of a rounding) run in another order on the card."""
        start = time.perf_counter()
        got = Model(config, pkg, limit_factor, device="cuda").forward(
            segments, need_alignment=False)
        plain = Model(config, pkg, limit_factor, device="cpu")
        with recording_logits(tfm, dstep, qmm) as logits:
            want = plain.forward(segments, need_alignment=False)
        share = agreement(got, want)
        gaps = parting_gaps(plain, segments, got, want, logits)
        log(f"tokens CUDA vs plain CPU ({path}, {label}, {len(segments)} segments, "
            f"T up to {max(len(s) for s in segments)}): {share:.6f}; plain logit gaps "
            f"where segments part: {gaps} ({time.perf_counter() - start:.1f} s)")
        check_agreement(f"{path}, {label}", share, gaps,
                        ties=path == "knobs" or (
                            path == "kv" and config.kv_cache_dtype in TIE_CACHES))

    launches = {}
    paths = {}
    path_models = {}
    for path, configs in path_configs.items():
        models = {label: Model(configs[label], pkg, device="cuda")
                  for label, pkg in packages.items()}
        reset()
        served = {}
        cold = {}
        for label, model in models.items():
            before = cache_counts(model)
            start = time.perf_counter()
            segments, hyps, sample = serve(model, lines)
            torch.cuda.synchronize()
            wall = time.perf_counter() - start
            served[label] = segments
            cold[label] = (wall, before, cache_counts(model))
            log(f"serve {path} {label}: {len(hyps)} segments in "
                f"{wall:.3f} s; e.g. {sample[0][:60]!r}")
        read(path)
        for label, model in models.items():
            phase_turns(torch, f"serve {path} {label}", model,
                        lambda m: serve(m, lines), cold[label], name, smi, thrash=True)
        for label, pkg in packages.items():
            compare(path, label, configs[label], pkg, served[label][:16])
        paths[path] = models["full vocab"]
        path_models[path] = models

    # The long path: the default config past the blockwise crossover, on
    # each decode path, the full vocabulary.
    long_models = {path: Model(path_configs[path]["full vocab"], packages["full vocab"],
                               device="cuda")
                   for path in ("declared", "fused_step", "fused")}
    reset()
    long_rows = {}
    cold = {}
    for path, model in long_models.items():
        before = cache_counts(model)
        start = time.perf_counter()
        long_segments, long_rows[path] = serve_long(model, long_lines)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        cold[path] = (wall, before, cache_counts(model))
        log(f"serve long {path}: {len(long_lines)} lines of "
            f"{[len(s) for s in long_segments]} tokens and 4 rows at T={LONG_T} in "
            f"{wall:.3f} s")
    read("long")
    for path, model in long_models.items():
        phase_turns(torch, f"serve long {path}", model,
                    lambda m: serve_long(m, long_lines), cold[path], name, smi)
    for path in long_models:
        compare(f"long, {path}", "full vocab", path_configs[path]["full vocab"],
                packages["full vocab"], long_segments[:2], limit_factor=0.1)
        indices, mask, lengths, tokens, steps = long_rows[path]
        plain = plain_rows(Model(path_configs[path]["full vocab"], packages["full vocab"],
                                 0.1, device="cpu"), tfm, dstep, qmm, indices, mask, lengths)
        share, gaps = row_agreement(plain, indices, tokens, steps)
        log(f"tokens CUDA vs plain CPU (long, {path}, forward_async_arrays, "
            f"{LONG_ROWS} rows at T={LONG_T}, decode capped at 0.1 x T on the CPU): "
            f"{share:.6f}; plain logit gaps where rows part: {gaps}")
        check_agreement(f"long, {path}, forward_async_arrays", share, gaps, ties=True)
    del long_models

    # The kv path: every kv_cache_dtype on the declared path, float32 and
    # int8 under `fused`, bfloat16 under fused_step (its only run of the
    # whole step in this phase, so each launch is its bfloat16 branch).
    # Model(config, package) with no device: the card.
    kv_configs = {f"declared {kv}": dataclasses.replace(config, kv_cache_dtype=kv)
                  for kv in ("float32", "bfloat16", "float16", "int8", "k8v16", "k16v8")}
    kv_configs.update({f"fused {kv}": dataclasses.replace(fused, kv_cache_dtype=kv)
                       for kv in ("float32", "int8")})
    kv_configs["fused_step bfloat16"] = dataclasses.replace(fused_step, kv_cache_dtype="bfloat16")
    kv_models = {}
    kv_served = {}
    reset()
    for label, kv_config in kv_configs.items():
        for pkg_label, pkg in packages.items():
            model = Model(kv_config, pkg)
            if model.device.type != "cuda":
                raise RuntimeError(f"Model's default device is {model.device}, not the card")
            start = time.perf_counter()
            segments, hyps, sample = serve(model, lines)
            torch.cuda.synchronize()
            kv_served[label, pkg_label] = segments
            log(f"serve kv {label} {pkg_label}: {len(hyps)} segments in "
                f"{time.perf_counter() - start:.3f} s; e.g. {sample[0][:60]!r}")
            if pkg_label == "full vocab":
                kv_models[label] = model
    read("kv")
    log(f"whole step launches over the bfloat16 cache (fused_step bfloat16): "
        f"{dstep.whole_step_kernel.launches}")
    for (label, pkg_label), segments in kv_served.items():  # the CPU's decode capped at 0.5 x T
        compare("kv", f"{label}, {pkg_label}", kv_configs[label], packages[pkg_label],
                segments[:16], limit_factor=0.5)

    # The loop: on every serving path and kv config, the graph loop's
    # tokens bit-equal to the eager loop's on the card (on the declared
    # path with alignments too), and equal across loop_unroll.
    start = time.perf_counter()
    segments = loop_segments(paths["declared"].vocabulary.eos_id)
    for path, models in path_models.items():
        for label, model in models.items():
            tokens = graph_against_eager(f"{path} {label}", model, segments)
            log(f"loop {path} {label}: graph tokens bit-equal to eager ({tokens} tokens)")
        graph_against_eager(f"{path} aligned", paths[path], segments, aligned=True)
        longest = across_unrolls(path, paths[path], segments)
        log(f"loop {path}: tokens bit-equal across k in {UNROLLS} at max_steps 41, "
            f"cap 29 (longest hypothesis {longest})")
    for label, model in kv_models.items():
        tokens = graph_against_eager(f"kv {label}", model, segments)
        log(f"loop kv {label}: graph tokens bit-equal to eager ({tokens} tokens)")
    log(f"loop checks: {time.perf_counter() - start:.1f} s")

    for path in paths:
        for batch in (64, 512):
            for loop in ("graph", "eager", "eager", "graph"):
                with eager_loop(paths[path], loop == "eager"):
                    wall, tokens = forward_rate(torch, paths[path], batch, 64)
                log(f"forward {path} {loop} loop B={batch} T=64 full vocab: "
                    f"{wall * 1e3:.1f} ms, {tokens} tokens, {tokens / wall:.0f} tok/s "
                    f"on {name} ({smi})")

    returned, wall = async_return(torch, paths["declared"], 512, 64)
    log(f"forward_async declared B=512 T=64 full vocab: returned after {returned:.3f} ms "
        f"of the batch's {wall:.1f} ms wall on {name} ({smi})")
    if not returned < wall / 2:
        raise RuntimeError("forward_async did not return before its batch was done")
    for path, batch, t in (("fused_step", 1, 32), ("declared", 1, 32), ("declared", 512, 64)):
        walls = dispatch_turns(torch, paths[path], batch, t)
        log(f"dispatch {path} B={batch} T={t} full vocab, in turns: worker median "
            f"{statistics.median(walls['worker']):.3f} ms of "
            f"{[round(w, 3) for w in walls['worker']]}, inline median "
            f"{statistics.median(walls['inline']):.3f} ms of "
            f"{[round(w, 3) for w in walls['inline']]} on {name} ({smi})")

    for path in ("declared", "fused_step", "fused", "split"):
        for loop in ("graph", "eager", "eager", "graph"):
            got = latency(torch, paths[path], dstep.whole_step_kernel, decode, loop_graph,
                          eager=loop == "eager")
            log(latency_line(f"{path} {loop} loop", got, name, smi))
    for path, model in paths.items():
        graph_lines(path, model, name, smi)
        log(f"graph cache {path} (every phase of its full-vocabulary Model): "
            f"{cache_counts(model)}, {len(model._graphs)} graphs kept of "
            f"{model._graphs.capacity}")

    # The exact float32 cache against the int16 default, and the whole
    # step's bfloat16 branch against its int16 one: in turns, one card.
    for label, model in (("int16", paths["declared"]), ("float32", kv_models["declared float32"]),
                         ("float32", kv_models["declared float32"]), ("int16", paths["declared"])):
        wall, tokens = forward_rate(torch, model, 512, 64)
        log(f"forward declared kv_cache_dtype={label} B=512 T=64 full vocab: "
            f"{wall * 1e3:.1f} ms, {tokens} tokens, {tokens / wall:.0f} tok/s on {name} ({smi})")
    for label, model in (("int16", paths["fused_step"]), ("bfloat16", kv_models["fused_step bfloat16"]),
                         ("bfloat16", kv_models["fused_step bfloat16"]),
                         ("int16", paths["fused_step"])):
        got = latency(torch, model, dstep.whole_step_kernel, decode, loop_graph)
        log(latency_line(f"fused_step kv_cache_dtype={label}", got, name, smi))
    del kv_models

    # Continuous batching at the full tiny11 width: the JAX engine's
    # defaults (256 slots, chunks of 16, t_slot 64) over 2048
    # length-skewed segments, on the declared path and under fused_step;
    # each segment's tokens against its decode alone through Model at
    # B=1, and the rate against Model.forward at B=256.
    rng = np.random.default_rng(7)
    eos = paths["declared"].vocabulary.eos_id
    segments = skewed_segments(rng, eos)
    engines = {}
    reset()
    for path in ("declared", "fused_step"):
        model = paths[path]
        engines[path] = ContinuousEngine(
            model.params, eos_id=eos, num_heads=HEADS, provider=model.config.qmm_provider,
            kv_dtype=model.config.kv_cache_dtype, argmax_method=model.config.argmax_method)
        continuous_run(torch, engines[path], segments[:300])  # captures the chunk
        engines[path].stats.update(dict.fromkeys(engines[path].stats, 0))
        wall, out = continuous_run(torch, engines[path], segments)
        engines[path] = (engines[path], wall, out)
    read("continuous")
    for path, (engine, wall, out) in engines.items():
        model = paths[path]
        start = time.perf_counter()
        want = one_at_a_time(model, segments)
        alone = time.perf_counter() - start
        continuous_agreement(f"continuous {path} against B=1", out, want)
        torch.cuda.synchronize()
        start = time.perf_counter()
        batched = [h.target for i in range(0, len(segments), 256)
                   for h in model.forward(segments[i:i + 256], need_alignment=False)]
        torch.cuda.synchronize()
        batch_wall = time.perf_counter() - start
        graph = next(iter(engine._graphs.items()))[1].stats()
        log(f"continuous {path}: {len(segments)} segments in {wall:.3f} s, "
            f"{len(segments) / wall:.1f} segments/s, {sum(map(len, out))} tokens, occupancy "
            f"{engine.occupancy():.4f}, {engine.stats['chunks']} chunks; Model.forward at "
            f"B=256: {batch_wall:.3f} s, {len(segments) / batch_wall:.1f} segments/s, "
            f"{sum(map(len, batched))} tokens; B=1 one at a time: {alone:.3f} s; chunk graph "
            f"capture {graph['capture_ms']:.1f} ms, pool {graph['pool_mb']:.1f} MB, buffers "
            f"{graph['buffers_mb']:.1f} MB on {name} ({smi})")
    del engines

    # The doors phase: the front doors a user starts, on the card.
    def counted(label, fn):
        reset()
        result = fn()
        torch.cuda.synchronize()
        counts = {key: counters[key].launches for key in DOOR_KERNELS}
        log(f"launches through the {label} door: {counts}")
        missing = [key for key, n in counts.items() if not n]
        if missing:
            raise RuntimeError(f"doors {label}: kernels never launched: {missing}")
        return result

    start = time.perf_counter()
    front_doors(torch, counted, model_bytes, spm, shortlist, lines, name, smi)
    log(f"doors phase: {time.perf_counter() - start:.1f} s")

    # The knobs phase: f32 and the half encoders through Model, then one
    # crosscheck cell against the reference.
    start = time.perf_counter()
    vocabulary = paths["declared"].vocabulary
    knob_segments = [vocabulary.encode(line, add_eos=True)[0][:128] for line in lines[:16]]
    for seg in knob_segments:
        seg[-1] = vocabulary.eos_id
    knob_counts = knobs(torch, counters, reset, compare, config, packages["full vocab"],
                        knob_segments, name, smi)
    reference_cell(torch, counters, reset, name, smi)
    log(f"knobs phase: {time.perf_counter() - start:.1f} s")

    # The parity phase, the full-width bleu leg and a traced forward.
    start = time.perf_counter()
    parity_phase(torch, counters, reset, name, smi)
    with tempfile.TemporaryDirectory(prefix="slimt_bleu_") as root:
        bleu_leg(torch, counters, reset, root, name, smi)
        trace_phase(root, name, smi)
    log(f"parity, bleu and trace phases: {time.perf_counter() - start:.1f} s")

    with torch.inference_mode():
        longctx(torch, tfm, paths["declared"].params, name, smi)

    loaded = [m for m in sys.modules if m.startswith("jax")
              or m == "slimt_tpu" or m.startswith("slimt_tpu.")]
    if loaded:
        raise RuntimeError(f"the run imported JAX or the JAX package: {loaded}")
    e, f, b, t = EMB, FFN, 64, 64
    rows = [
        ("qmm_affine", AFFINE_SOURCE, "slimt_tpu/ops/qmm_pallas.py:42", affine_err,
         {key: affine_times[0][key] for key in ("ms", "plain_ms", "graph_ms")},
         affine_bound(512 * 64, EMB, FFN)),
        ("encoder_layer", LAYER_SOURCE, "slimt_tpu/ops/encoder_layer_pallas.py:87",
         layer_err, layer_ms, layer_bound(512, 64, e, f)),
        ("whole_decode_step", STEP_SOURCE, "slimt_tpu/ops/decoder_step_pallas.py:497",
         max(step_err, step_float_err), step_ms, step_bound(1, 64, e, f, DEC, VOCAB)),
        ("ssru_block", BLOCKS_SOURCE, "slimt_tpu/ops/fused_blocks.py:145",
         block_err["ssru_block"], block_ms["ssru_block"],
         bound(16 * b * e + 2 * e * e + 12 * e, int8_ops=4 * b * e * e)),
        ("ffn_block", BLOCKS_SOURCE, "slimt_tpu/ops/fused_blocks.py:62",
         block_err["ffn_block"], block_ms["ffn_block"],
         bound(8 * b * e + 2 * e * f + 4 * (f + 3 * e), int8_ops=4 * b * e * f)),
        ("decode_attention", ATTN_SOURCE, "slimt_tpu/ops/decode_attn_pallas.py:66",
         attn_err, attn_ms,
         bound(8 * b * e + 4 * b * t * e + 12 * b * t, f32_ops=4 * b * t * e)),
        ("argmax_affine", ARGMAX_SOURCE, "slimt_tpu/ops/logits_argmax.py:70",
         argmax_err, argmax_ms,
         bound(4 * b * e + e * VOCAB + 4 * VOCAB + 4 * b, int8_ops=2 * b * e * VOCAB)),
        ("fused_sdpa", ATTENTION_SOURCE, "slimt_tpu/ops/attention.py:121",
         sdpa_err, sdpa_ms, sdpa_bound(512, 64, e)),
        ("blockwise_attention", ATTENTION_SOURCE, "slimt_tpu/ops/attention.py:219",
         blockwise_err, blockwise_ms,
         bound(16 * 128 * 1024 * 32 + 4 * 16 * 1024, f32_ops=4 * 128 * 1024 * 1024 * 32)),
        ("decoder_layer_step", STEP_SOURCE, "slimt_tpu/ops/decoder_step_pallas.py:148",
         layer_step_err["decoder_layer_step"], layer_step_ms["decoder_layer_step"],
         layer_step_bound(b, t, e, f)),
        ("decoder_layer_step_bte", STEP_SOURCE,
         "slimt_tpu/ops/decoder_step_pallas.py:286",
         layer_step_err["decoder_layer_step_bte"], layer_step_ms["decoder_layer_step_bte"],
         layer_step_bound(b, t, e, f)),
    ]
    # No serving path reaches #10 and #11, in the port as in the JAX
    # package: their launches are those of the kernels phase's checks.
    launches.update(layer_step_launches)
    record = {"kernels": [
        {"name": key, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[key],
         "launches_from": "kernels" if key in layer_step_launches else "serve",
         "max_abs_err": err, "ms": times["ms"],
         "plain_ms": times["plain_ms"], "bound_ms": bound_ms, "bound_by": by,
         "library_ms": times.get("library_ms"), "graph_ms": times["graph_ms"],
         **{k: times[k] for k in ("cs1_ms", "cs1_graph_ms", "graph_ms_by_b", "split_ms_by_b",
                                  "launches_per_layer", "split_ms")
            if k in times},
         **({"shapes": affine_times} if key == "qmm_affine" else {}),
         "knobs_launches": {label: counts.get(key, 0) for label, counts in knob_counts.items()}}
        for key, source, replaces, err, times, (bound_ms, by) in rows
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--layouts"]:
        layout_times(sys.argv[2], tuple(sys.argv[3:]) or LAYOUT_KERNELS)
    elif sys.argv[1:2] == ["--unroll"]:
        unroll_times()
    elif sys.argv[1:2] == ["--trace-once"]:
        trace_once(sys.argv[2])
    elif sys.argv[1:2] == ["--trace-sessions"]:
        trace_sessions(int(sys.argv[2]))
    else:
        main()
    sys.exit(0)
