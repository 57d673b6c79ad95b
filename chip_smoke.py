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
             every mode, the encoder layer within 2e-5 (the bound the
             JAX package holds its TPU kernel to) on >= 99% of
             positions, the whole decode step within 2e-5 on states and
             head-0 attention on >= 99% of rows (every position and row
             within 0.25: an int8 rounding flip moves one by up to
             ~0.06) with >= 99% of choices equal, its
             projection stage bit-equal given the same rows (a tie
             across vocab tiles included); the SSRU and FFN blocks
             within 2e-5 on >= 99% of rows and every row within 0.25,
             the decode attention within 2e-5, the projection argmax
             bit-equal in its three methods (exact, packed_fp16,
             packed_bf16; a tie across vocab tiles included), at tiny
             and base widths; times beside the plain versions';
4. serve   — a tiny11-width model (32k vocab, emb 256, ffn 1536, 6+2
             layers, 8 heads; random weights from seed 0) answers
             request batches of text through Model.forward_async,
             Model.forward_async_arrays and the runtime's
             Blocking(...).translate, with and without shortlist and
             alignment: on the declared path, then on the fused_step
             latency path, then on the `fused` path (qmm_provider
             "fused", attn_kernel "on"; the full-vocab model keeps
             packed_int, which falls to the exact argmax there, the
             shortlist model takes packed_fp16); the launch counts are
             set to 0 before each path and read after it, and every
             kernel of the path must have launched;
5. check   — outputs well formed; CUDA tokens against the plain CPU
             path on 16 segments (>= 99% equal) for every path; forward
             wall time and tokens/s at B=64 and B=512 (T=64) on each
             path; at B=1, T=32 the fused_step and fused forwards
             against the declared one (median of 5 runs, µs per step,
             device operations per step by torch.profiler); neither JAX
             nor the JAX package's models or ops were imported.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

from slimt_tpu.config import Config
from slimt_tpu.runtime.response import Options
from slimt_tpu.runtime.service import Blocking

VOCAB, EMB, FFN, ENC, DEC, HEADS = 32000, 256, 1536, 6, 2, 8
AFFINE_SOURCE = "slimt_tpu_torch/ops/csrc/qmm_affine.cu"
LAYER_SOURCE = "slimt_tpu_torch/ops/csrc/encoder_layer.cu"
STEP_SOURCE = "slimt_tpu_torch/ops/csrc/decoder_step.cu"
BLOCKS_SOURCE = "slimt_tpu_torch/ops/csrc/fused_blocks.cu"
ATTN_SOURCE = "slimt_tpu_torch/ops/csrc/decode_attn.cu"
ARGMAX_SOURCE = "slimt_tpu_torch/ops/csrc/logits_argmax.cu"
LAYER_TOL = 2e-5
STEP_TOL = 2e-5  # the encoder layer's bound, per row (steps and blocks)
ATTN_TOL = 2e-5
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
# Of the JAX package the port reuses only the JAX-free config, io, text
# and runtime modules; none of these may be imported.
JAX_PACKAGE_COMPUTE = ("slimt_tpu.models", "slimt_tpu.ops", "slimt_tpu.parallel")


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
        plain = cuda_ms(torch, lambda: qmm.affine_plain(x, w, b, 20.0, 1e-4, mode))
        tops = 2.0 * m * k * n / (kernel * 1e-3) / 1e12
        log(f"time affine {label} (M={m} K={k} N={n}): kernel {kernel:.4f} ms "
            f"({tops:.2f} TOP/s), plain {plain:.4f} ms")
        timings.append((kernel, plain))
    return worst, timings[0]


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
        for b, t in ((64, 64), (512, 64)):
            x = torch.randn((b, t, emb), device=dev)
            mask_add = torch.zeros((b, 1, 1, t), device=dev)
            kernel = cuda_ms(torch, lambda: enc.layer_kernel(x, layer, mask_add, HEADS), 10)
            plain = cuda_ms(torch, lambda: enc.layer_plain(x, layer, mask_add, HEADS), 10)
            log(f"time encoder layer E={emb} F={ffn} B={b} T={t}: kernel "
                f"{kernel:.4f} ms, plain {plain:.4f} ms")
            if (emb, b) == (EMB, 512):
                timing = (kernel, plain)
    log(f"encoder layer: {within}/{positions} positions within {LAYER_TOL} "
        f"({within / positions:.6f}), max |diff| {worst:.3g}")
    if within / positions < AGREEMENT_MIN:
        raise RuntimeError(f"encoder layer: positions within {LAYER_TOL} "
                           f"{within / positions} < {AGREEMENT_MIN}")
    return worst, timing


def step_case(torch, tfm, params, gen, b, t, width):
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
    return (layers, states, x, mask_add, caches, HEADS, projection,
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
    """Whole step vs plain at tiny and base widths: states and attn0 within
    STEP_TOL, >= 99% of choices equal, the projection stage bit-equal
    given the same rows; a tie across vocab tiles; times."""
    worst = 0.0
    rows = same = within = 0
    worst_gap = 0.0
    cases = 0
    tiny = None
    for emb, ffn in ((EMB, FFN), (512, 2048)):
        params = params_from_numpy(load_host(emb, ffn, 1, DEC, vocab=VOCAB), dev)
        if emb == EMB:
            tiny = params
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb)
        shapes = [(b, t, 0) for b in (1, 8, 33, 64, 512) for t in (16, 64, 128, 256)]
        shapes += [(b, 64, w) for b in (1, 8, 33, 64, 512) for w in (1024, 3072)]
        for b, t, width in shapes:
            args = step_case(torch, tfm, params, gen, b, t, width)
            choice, states, attn0 = dstep.whole_step_kernel(*args)
            y, want_states, want_attn0 = dstep.layers_plain(*args[:6])
            want = dstep.argmax_affine_plain(y, *args[6], args[7], args[8])
            stage = dstep.argmax_affine_kernel(y, *args[6], args[7], args[8])
            torch.cuda.synchronize()
            label = f"whole step E={emb} F={ffn} B={b} T={t} S={width or VOCAB}"
            if not all(bool(torch.isfinite(s).all()) for s in states + (attn0,)):
                raise RuntimeError(f"{label}: non-finite output")
            row_err = (attn0 - want_attn0).abs().amax(-1)
            for got, ref in zip(states, want_states):
                row_err = torch.maximum(row_err, (got - ref).abs().amax((1, 2)))
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
        f"where they differ {worst_gap:.3g}; projection stage bit-equal")
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
    first, second = 301, 20006  # tiles 1 and 78 of 256 columns
    emb[second] = emb[first]
    bias = params["out"]["b"].clone()
    bias[second] = bias[first]
    ids = torch.arange(0, VOCAB, 7, device=dev)  # holds both, in tiles 0 and 11
    for label, w, b, col in (
        ("full", emb.T, bias, first),
        ("shortlist", emb.index_select(0, ids).T, bias.index_select(0, ids),
         int((ids == first).nonzero())),
    ):
        y = (w[:, col].float() / 40.0).repeat(3, 1).contiguous()
        for method in lam.METHODS:
            got = lam.argmax_affine_kernel(y, w, b, 20.0, 1e-3, method)
            want = lam.argmax_affine_plain(y, w, b, 20.0, 1e-3, method)
            torch.cuda.synchronize()
            if got.tolist() != [col] * 3 or not torch.equal(got, want):
                raise RuntimeError(f"tie ({label}, {method}): kernel {got.tolist()}, "
                                   f"plain {want.tolist()}, first column {col}")
    log("projection tie across vocab tiles: the first column wins "
        f"(full, shortlist; {', '.join(lam.METHODS)})")


def time_step(torch, dstep, tfm, params):
    """Kernel (with its per-batch plan) vs plain, CUDA events, T=64,
    tiny widths. Returns the B=1 full-vocab pair."""
    gen = torch.Generator(device=params["emb"]["q"].device)
    gen.manual_seed(1)
    timing = None
    for width in (0, 1024):
        for b in (1, 8, 64):
            args = step_case(torch, tfm, params, gen, b, 64, width)
            plan = dstep.StepPlan(args[0], args[4], args[3], HEADS, args[6],
                                  args[7], args[8])
            kernel = cuda_ms(torch, lambda: dstep.whole_step_kernel(*args, plan=plan), 50)
            plain = cuda_ms(torch, lambda: dstep.whole_step_plain(*args), 20)
            log(f"time whole step E={EMB} F={FFN} B={b} T=64 S={width or VOCAB}: "
                f"kernel {kernel:.4f} ms, plain {plain:.4f} ms")
            if (b, width) == (1, 0):
                timing = (kernel, plain)
    return timing


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
    rows within STEP_TOL, every row within FLIP_BOUND; times at T=1 rows
    (decode), B in {1, 64, 512}."""
    worst = {"ssru_block": 0.0, "ffn_block": 0.0}
    rows = {"ssru_block": [0, 0], "ffn_block": [0, 0]}
    timing = {}
    for emb, ffn in ((EMB, FFN), (512, 2048)):
        layers = params_from_numpy(load_host(emb, ffn, 1, DEC), dev)["decoder"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb + 1)
        for b in (1, 8, 33, 64, 512):
            for layer in layers:
                x = torch.randn((b, emb), device=dev, generator=gen) * 2.0
                c = torch.randn((b, emb), device=dev, generator=gen)
                h, c_t = fblocks.ssru_kernel(x, c, layer["rnn"])
                want_h, want_c = fblocks.ssru_plain(x, c, layer["rnn"])
                y = fblocks.ffn_kernel(x, layer["ffn"])
                want_y = fblocks.ffn_plain(x, layer["ffn"])
                torch.cuda.synchronize()
                label = f"E={emb} F={ffn} B={b}"
                for name, err in (
                    ("ssru_block", torch.maximum((h - want_h).abs().amax(-1),
                                                 (c_t - want_c).abs().amax(-1))),
                    ("ffn_block", (y - want_y).abs().amax(-1)),
                ):
                    n, within, e = rows_check(f"{name} {label}", err, STEP_TOL, FLIP_BOUND)
                    rows[name][0] += n
                    rows[name][1] += within
                    worst[name] = max(worst[name], e)
        layer = layers[0]
        for b in (1, 64, 512):
            x = torch.randn((b, emb), device=dev, generator=gen)
            c = torch.randn((b, emb), device=dev, generator=gen)
            for name, kernel, plain in (
                ("ssru_block", lambda: fblocks.ssru_kernel(x, c, layer["rnn"]),
                 lambda: fblocks.ssru_plain(x, c, layer["rnn"])),
                ("ffn_block", lambda: fblocks.ffn_kernel(x, layer["ffn"]),
                 lambda: fblocks.ffn_plain(x, layer["ffn"])),
            ):
                pair = (cuda_ms(torch, kernel, 50), cuda_ms(torch, plain, 20))
                log(f"time {name} E={emb} F={ffn} B={b}: kernel {pair[0]:.4f} ms, "
                    f"plain {pair[1]:.4f} ms")
                if (emb, b) == (EMB, 64):
                    timing[name] = pair
    for name, (n, within) in rows.items():
        log(f"{name}: {within}/{n} rows within {STEP_TOL} ({within / n:.6f}), "
            f"max |diff| {worst[name]:.3g}")
        if within / n < AGREEMENT_MIN:
            raise RuntimeError(f"{name}: rows within {STEP_TOL} {within / n} "
                               f"< {AGREEMENT_MIN}")
    return worst, timing


def check_attention(torch, dattn, dev):
    """Decode attention vs plain within ATTN_TOL at E 256/512 (8 heads),
    B in {1, 8, 33, 64, 512}, T in {16, 64, 128}; row 0 padded from T/2
    and the last row fully masked; times at tiny width, T=64."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    worst = 0.0
    timing = None

    def case(b, t, e):
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

    cases = 0
    for e in (EMB, 512):
        for b in (1, 8, 33, 64, 512):
            for t in (16, 64, 128):
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
    for b in (1, 64, 512):
        args = case(b, 64, EMB)
        pair = (cuda_ms(torch, lambda: dattn.decode_attention_kernel(*args, HEADS), 50),
                cuda_ms(torch, lambda: dattn.attention_plain(*args, HEADS), 20))
        log(f"time decode attention E={EMB} B={b} T=64: kernel {pair[0]:.4f} ms, "
            f"plain {pair[1]:.4f} ms")
        if b == 64:
            timing = pair
    return worst, timing


def check_argmax(torch, lam, tfm, widths):
    """The argmax kernel bit-equal to plain in every method, at each
    width's params (tiny first), full vocab and shortlists of 1024 and
    3072, B in {1, 8, 33, 64, 512}; times at tiny width. Returns (most
    differing indices in a case, which must be 0; the B=64 exact
    times)."""
    cases = differ = 0
    for params in widths:
        dev = params["emb"]["q"].device
        emb = params["emb"]["q"].shape[1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(emb)
        projections = {"full": tfm.prepare_output_projection(params)}
        for width in (1024, 3072):
            ids = torch.randperm(VOCAB, device=dev, generator=gen)[:width].sort().values
            projections[f"shortlist {width}"] = tfm.prepare_output_projection(params, ids)
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
    log(f"argmax: {cases} cases at E in (256, 512) bit-equal to plain "
        f"({', '.join(lam.METHODS)})")
    timing = None
    params = widths[0]
    aq, inv = params["out"]["aq"], tfm.output_inv(params)
    w, b = tfm.prepare_output_projection(params)
    gen = torch.Generator(device=w.device)
    gen.manual_seed(5)
    for rows in (1, 64, 512):
        y = torch.randn((rows, EMB), device=dev, generator=gen)
        for method in lam.METHODS:
            pair = (cuda_ms(torch, lambda: lam.argmax_affine_kernel(y, w, b, aq, inv, method), 50),
                    cuda_ms(torch, lambda: lam.argmax_affine_plain(y, w, b, aq, inv, method), 20))
            log(f"time argmax {method} B={rows} V={VOCAB}: kernel {pair[0]:.4f} ms, "
                f"plain {pair[1]:.4f} ms")
            if (rows, method) == (64, "exact"):
                timing = pair
    return float(differ), timing


def executed_steps(valid: int, limit: int, every: int) -> int:
    """Decode steps a B=1 forward ran: the loop checks completion every
    `every` steps, so a row that ended after `valid` steps ran to the
    next check."""
    if valid >= limit:
        return limit
    return min(limit, -(-valid // every) * every)


def latency(torch, model, every, whole_step):
    """B=1, T=32: median wall of 5 forwards, µs per step, and device
    operations and kernel time per step from one profiled forward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eos = model.vocabulary.eos_id
    segment = [[3 + j for j in range(31)] + [eos]]
    hyps = model.forward(segment, need_alignment=False)
    launches = whole_step.launches
    model.forward(segment, need_alignment=False)
    launched = whole_step.launches - launches
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        model.forward(segment, need_alignment=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - start)
    steps = executed_steps(len(hyps[0].target), int(1.5 * 32), every)
    if launched and launched != steps:
        raise RuntimeError(f"whole step launched {launched} times for {steps} steps")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.forward(segment, need_alignment=False)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in device)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    log("  device time per step by kernel: " + "; ".join(
        f"{name[:40]} {us / steps:.1f} us" for name, us in top))
    return statistics.median(walls), walls, steps, len(device), busy_us


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
    # text processor needs): split, tokenize, batch, decode, detokenize.
    # The per-request lane calls model.forward_async; the bulk lane would
    # import the JAX package's model module for its bucket helpers.
    with Blocking(Config(prefer_bulk=False)) as service:
        responses = service.translate(model, list(lines[:32]))
        aligned = service.translate(model, list(lines[:8]), Options(alignment=True))
    if len(responses) != 32 or not all(r.target.text for r in responses):
        raise RuntimeError("Blocking.translate: malformed responses")
    if len(aligned) != 8 or not all(r.alignments for r in aligned):
        raise RuntimeError("Blocking.translate with alignment: no alignments")
    return segments, hyps, sample


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


def main() -> None:
    import torch

    name, smi = probe(torch)

    from slimt_tpu.config import ModelConfig
    from slimt_tpu.io import load_items
    from slimt_tpu.io.loader import load_weights
    from slimt_tpu.io.shortlist import build_synthetic_shortlist
    from slimt_tpu.io.synthetic import synthetic_model_bytes
    from slimt_tpu.text import spm_proto
    from slimt_tpu.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model
    from slimt_tpu_torch import Model, Package
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.models import transformer as tfm
    from slimt_tpu_torch.models.decode import CHECK_EVERY
    from slimt_tpu_torch.ops import _build
    from slimt_tpu_torch.ops import decode_attn as dattn
    from slimt_tpu_torch.ops import decoder_step as dstep
    from slimt_tpu_torch.ops import encoder_layer as enc
    from slimt_tpu_torch.ops import fused_blocks as fblocks
    from slimt_tpu_torch.ops import logits_argmax as lam
    from slimt_tpu_torch.ops import qmm

    dev = torch.device("cuda", 0)
    start = time.perf_counter()
    _build.library()
    log(f"build: {time.perf_counter() - start:.2f} s into {_build.BUILD_DIR}")

    def load_host(emb, ffn, enc_layers, dec_layers, vocab=64):
        config = ModelConfig(encoder_layers=enc_layers, decoder_layers=dec_layers)
        return load_weights(load_items(synthetic_model_bytes(
            config=config, vocab_size=vocab, emb_dim=emb, ffn_dim=ffn, seed=0)),
            config)

    affine_err, affine_ms = check_affine(torch, qmm, dev)
    layer_err, layer_ms = check_layer(torch, enc, dev, load_host, params_from_numpy)
    step_err, step_ms = check_step(torch, dstep, lam, tfm, qmm, dev, load_host,
                                   params_from_numpy)
    block_err, block_ms = check_blocks(torch, fblocks, dev, load_host, params_from_numpy)
    attn_err, attn_ms = check_attention(torch, dattn, dev)
    argmax_err, argmax_ms = check_argmax(torch, lam, tfm, [
        params_from_numpy(load_host(emb, ffn, 1, DEC, vocab=VOCAB), dev)
        for emb, ffn in ((EMB, FFN), (512, 2048))])
    log(f"kernel times above on {name} ({smi})")

    config = ModelConfig(encoder_layers=ENC, decoder_layers=DEC, num_heads=HEADS)
    fused_step = dataclasses.replace(config, qmm_provider="fused_step")
    fused = dataclasses.replace(config, qmm_provider="fused", attn_kernel="on")
    # Per path, the config of each package's model.
    path_configs = {
        "declared": {"full vocab": config, "shortlist": config},
        "fused_step": {"full vocab": fused_step, "shortlist": fused_step},
        "fused": {"full vocab": fused,  # packed_int: the exact argmax under fused
                  "shortlist": dataclasses.replace(fused, argmax_method="packed_fp16")},
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
    counters = {"qmm_affine": qmm.affine_kernel,
                "encoder_layer": enc.layer_kernel,
                "whole_decode_step": dstep.whole_step_kernel,
                "ssru_block": fblocks.ssru_kernel,
                "ffn_block": fblocks.ffn_kernel,
                "decode_attention": dattn.decode_attention_kernel,
                "argmax_affine": lam.argmax_affine_kernel}
    path_kernels = {"declared": ("qmm_affine", "encoder_layer"),
                    "fused_step": ("qmm_affine", "encoder_layer", "whole_decode_step"),
                    "fused": ("qmm_affine", "encoder_layer", "ssru_block", "ffn_block",
                              "decode_attention", "argmax_affine")}

    launches = {}
    paths = {}
    for path, configs in path_configs.items():
        models = {label: Model(configs[label], pkg, "cuda")
                  for label, pkg in packages.items()}
        for counter in counters.values():
            counter.launches = 0
        served = {}
        for label, model in models.items():
            start = time.perf_counter()
            segments, hyps, sample = serve(model, lines)
            torch.cuda.synchronize()
            served[label] = segments
            log(f"serve {path} {label}: {len(hyps)} segments in "
                f"{time.perf_counter() - start:.3f} s; e.g. {sample[0][:60]!r}")
        counts = {key: counter.launches for key, counter in counters.items()}
        log(f"launches in the {path} serving phase: {counts}")
        missing = [key for key in path_kernels[path] if not counts[key]]
        if missing:
            raise RuntimeError(f"{path}: kernels never launched: {missing}")
        # The record takes each kernel's count from the first path it serves.
        for key in path_kernels[path]:
            launches.setdefault(key, counts[key])

        for label, pkg in packages.items():
            cpu = Model(configs[label], pkg, "cpu")
            segments = served[label][:16]
            got = models[label].forward(segments, need_alignment=False)
            want = cpu.forward(segments, need_alignment=False)
            share = agreement(got, want)
            log(f"tokens CUDA vs plain CPU ({path}, {label}, 16 segments): {share:.6f}")
            if share < AGREEMENT_MIN:
                raise RuntimeError(f"token agreement {share} < {AGREEMENT_MIN}")
        paths[path] = models["full vocab"]

    for path in paths:
        for batch in (64, 512):
            wall, tokens = forward_rate(torch, paths[path], batch, 64)
            log(f"forward {path} B={batch} T=64 full vocab: {wall * 1e3:.1f} ms, "
                f"{tokens} tokens, {tokens / wall:.0f} tok/s on {name} ({smi})")

    for path in ("declared", "fused_step", "fused", "fused", "fused_step", "declared"):
        wall, walls, steps, ops, busy_us = latency(
            torch, paths[path], CHECK_EVERY, dstep.whole_step_kernel)
        log(f"latency {path} B=1 T=32 full vocab: median wall {wall * 1e3:.3f} ms "
            f"of {[round(w * 1e3, 3) for w in walls]}, {steps} steps, "
            f"{wall / steps * 1e6:.1f} us/step, {ops / steps:.1f} device ops/step, "
            f"device busy {busy_us / steps:.1f} us/step (profiled) on {name} ({smi})")

    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
              or m.startswith(JAX_PACKAGE_COMPUTE)]
    if loaded:
        raise RuntimeError(f"the run imported JAX or the JAX package's models: {loaded}")
    record = {"kernels": [
        {"name": "qmm_affine", "route": "cuda", "source": AFFINE_SOURCE,
         "replaces": "slimt_tpu/ops/qmm_pallas.py:42",
         "launches": launches["qmm_affine"], "max_abs_err": affine_err,
         "ms": affine_ms[0], "plain_ms": affine_ms[1]},
        {"name": "encoder_layer", "route": "cuda", "source": LAYER_SOURCE,
         "replaces": "slimt_tpu/ops/encoder_layer_pallas.py:87",
         "launches": launches["encoder_layer"], "max_abs_err": layer_err,
         "ms": layer_ms[0], "plain_ms": layer_ms[1]},
        {"name": "whole_decode_step", "route": "cuda", "source": STEP_SOURCE,
         "replaces": "slimt_tpu/ops/decoder_step_pallas.py:497",
         "launches": launches["whole_decode_step"], "max_abs_err": step_err,
         "ms": step_ms[0], "plain_ms": step_ms[1]},
        {"name": "ssru_block", "route": "cuda", "source": BLOCKS_SOURCE,
         "replaces": "slimt_tpu/ops/fused_blocks.py:145",
         "launches": launches["ssru_block"], "max_abs_err": block_err["ssru_block"],
         "ms": block_ms["ssru_block"][0], "plain_ms": block_ms["ssru_block"][1]},
        {"name": "ffn_block", "route": "cuda", "source": BLOCKS_SOURCE,
         "replaces": "slimt_tpu/ops/fused_blocks.py:62",
         "launches": launches["ffn_block"], "max_abs_err": block_err["ffn_block"],
         "ms": block_ms["ffn_block"][0], "plain_ms": block_ms["ffn_block"][1]},
        {"name": "decode_attention", "route": "cuda", "source": ATTN_SOURCE,
         "replaces": "slimt_tpu/ops/decode_attn_pallas.py:66",
         "launches": launches["decode_attention"], "max_abs_err": attn_err,
         "ms": attn_ms[0], "plain_ms": attn_ms[1]},
        {"name": "argmax_affine", "route": "cuda", "source": ARGMAX_SOURCE,
         "replaces": "slimt_tpu/ops/logits_argmax.py:70",
         "launches": launches["argmax_affine"], "max_abs_err": argmax_err,
         "ms": argmax_ms[0], "plain_ms": argmax_ms[1]},
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
