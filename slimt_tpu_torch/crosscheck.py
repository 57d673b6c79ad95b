"""The port's decode against the reference binary: the counterpart of
scripts/crosscheck.py, on the port's own modules.

The packages (marian .bin, SentencePiece .spm, binary shortlist) are
written by the port's copies of the JAX package's writers
(io/synthetic.py, io/marian.py, io/shortlist.py, text/spm_proto.py,
text/synthetic_vocab.py), byte for byte the packages the JAX script
writes, and are read by the compiled reference core,
crosscheck/bin/slimt_ref_harness, which this module runs as it is
(it never runs `make`). The port decodes the same sentences with
models/decode.translate_batch on `--device` (the card by default; on
CUDA through the CUDA-graph loop), batch for batch as the reference's
fixed-size flush batching groups them.

Modes:
  tokens    per-sentence exact match and token agreement over CELLS x
            {full vocabulary, shortlist} x B in (1, 8), with the exact
            numerics (split f32 KV cache, f32 first-max argmax); each
            divergence is re-decoded by the NumPy oracle
            tests/reference_impl.py with roundf activation rounding (the
            reference Ruy provider's), and counts as the providers'
            rounding delta where that equals the reference. Exit status
            1 below 98% of sentences in the worst cell.
  serving   every config of SERVING_CONFIGS over CELLS and PEAKED_CELL
            (full vocabulary and shortlist; the peaked cell full
            vocabulary only) at B=8 and --lines sentences a cell; writes
            crosscheck/serving_agreement_torch.json in the layout of
            crosscheck/serving_agreement.json, with the device's name and
            power limit, the digest of the port's sources it ran
            (source_digest) and where the reference's tokens came from
            (the harness, or RECORDED and its digest). --configs filters the rows ("exact" always
            runs) and then writes nothing. Exit status 1 below 98% of
            sentences on the exact row.
  shortlist ShortlistGenerator.generate against the reference's
            Shortlist.cc, batch for batch.
  partings  for each sentence where the exact row parts from the
            reference on a full-vocabulary serving leg: the first step
            where it parts, both choices, the plain CPU logit gap
            between them and whether the roundf oracle (see tokens)
            reproduces the reference.
  split     the port's splitter (text/splitter.py) against the
            reference's PCRE2 Splitter.cc (`slimt_ref_harness --split`)
            over SPLIT_DOCS: per-document byte-range boundaries.
  process   the port's TextProcessor (its native tokenizer, the port's
            own host library) against the reference's
            (`slimt_ref_harness --process`): segments and annotations.
  e2e       the reference's whole CLI (crosscheck/bin/slimt_ref_cli)
            against `python -m slimt_tpu_torch translate --exact
            --device ...` on the same text and synthetic package: exact
            string compare (HTML: tag skeleton and tokens where tags
            move on an attention tie); the declared serving config
            informational.
  bleu      corpus BLEU (slimt_tpu_torch/bleu.py) of the reference CLI,
            the port's serving config and its exact path on
            --bleu-lines of data/corpus.txt (or --bleu-source), against
            --bleu-reference or, without one, the reference CLI's own
            output; exit status 1 below 98% of lines equal on the exact
            path in that pseudo-reference mode.
  record    writes RECORDED (the harness's legs) and RECORDED_CLI (the
            reference CLI's lines for the e2e documents and the bleu
            legs at BLEU_WIDTHS), where both start.

split and process need the harness and exit 1, saying why, where it does
not start. e2e and bleu read the reference CLI's lines from RECORDED_CLI
where the CLI does not start (a machine without the libraries it links),
and say so.

Shortlist legs run with a zeroed logit bias: the reference's Ruy
provider adds the unselected bias under a shortlist (see
scripts/crosscheck.py's docstring).

Usage:
  python -m slimt_tpu_torch.crosscheck
      [tokens|serving|shortlist|partings|split|process|e2e|bleu|record]
      [--lines N] [--device cuda|cpu] [--configs a,b] [--verbose]
      [--bleu-package DIR --bleu-model F --bleu-vocab F --bleu-source F
       --bleu-reference F --bleu-lines N]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS = os.path.join(ROOT, "crosscheck", "bin", "slimt_ref_harness")
ORACLE = os.path.join(ROOT, "tests", "reference_impl.py")
SERVING_OUT = os.path.join(ROOT, "crosscheck", "serving_agreement_torch.json")
# The reference's tokens for every leg the modes and chip_smoke.py run,
# for machines where the harness cannot start (`record` writes it).
RECORDED = os.path.join(ROOT, "crosscheck", "reference_tokens.json")
REF_CLI = os.path.join(ROOT, "crosscheck", "bin", "slimt_ref_cli")
# The reference CLI's output lines for the e2e documents and the bleu
# legs, for machines where it cannot start (`record` writes it).
RECORDED_CLI = os.path.join(ROOT, "crosscheck", "reference_cli.json")
CORPUS = os.path.join(ROOT, "data", "corpus.txt")
# (E, F) of the synthetic packages whose bleu legs `record` keeps: the
# default, and the tiny preset at full width.
BLEU_WIDTHS = ((64, 128), (256, 1536))
BLEU_LINES = 128
BLEU_EXACT_MIN = 0.98  # lines equal on the exact path (the JAX mode's gate)

# (label, enc, dec, heads, emb, ffn, seed): scripts/crosscheck.py's.
CELLS = [
    ("tiny-ratio 3/2/4", 3, 2, 4, 64, 128, 0),
    ("base-ratio 6/2/8", 6, 2, 8, 64, 256, 1),
    ("narrow 2/2/2", 2, 2, 2, 32, 64, 2),
    ("deep-dec 2/4/4", 2, 4, 4, 64, 128, 4),
]
# The repeated-near-tie cell: a logit bias 40x wider, so the same top-2
# contest repeats every step (scripts/crosscheck.py's PEAKED_CELL note).
PEAKED_CELL = ("STRESS repeated-near-tie 3/2/4", 3, 2, 4, 64, 128, 9)
PEAKED_BIAS_SCALE = 40.0
VOCAB = 512
SERVING_BATCH = 8
EXACT_MIN = 98.0  # % of sentences the exact row keeps (the JAX sweep's gate)

# scripts/crosscheck.py's SERVING_CONFIGS: the options each row passes to
# translate_batch (kv_dtype "float32" and argmax "exact" where unset).
_NOALIGN = {"with_alignment": False}
SERVING_CONFIGS = [
    ("exact", {}),
    ("kv=int16", {"kv_dtype": "int16"}),
    ("kv=k8v16", {"kv_dtype": "k8v16"}),
    ("kv=k16v8", {"kv_dtype": "k16v8"}),
    ("kv=float16", {"kv_dtype": "float16"}),
    ("kv=bfloat16", {"kv_dtype": "bfloat16"}),
    ("kv=int8", {"kv_dtype": "int8"}),
    ("argmax=packed_fp16", {"argmax_method": "packed_fp16"}),
    ("argmax=packed_bf16", {"argmax_method": "packed_bf16"}),
    ("argmax=packed_int", {"argmax_method": "packed_int"}),
    # The declared serving config (ModelConfig's defaults).
    ("packedint+int16+noalign",
     {"kv_dtype": "int16", "argmax_method": "packed_int", **_NOALIGN}),
    ("int16+packedfp16+noalign",
     {"kv_dtype": "int16", "argmax_method": "packed_fp16", **_NOALIGN}),
    ("k8v16+packedfp16+noalign",
     {"kv_dtype": "k8v16", "argmax_method": "packed_fp16", **_NOALIGN}),
    ("k16v8+packedfp16+noalign",
     {"kv_dtype": "k16v8", "argmax_method": "packed_fp16", **_NOALIGN}),
    ("fp16+packedfp16+noalign",
     {"kv_dtype": "float16", "argmax_method": "packed_fp16", **_NOALIGN}),
    ("bf16+packedbf16+noalign",
     {"kv_dtype": "bfloat16", "argmax_method": "packed_bf16", **_NOALIGN}),
    ("int8+packedbf16+noalign",
     {"kv_dtype": "int8", "argmax_method": "packed_bf16", **_NOALIGN}),
    ("enc=float16", {"encoder_dtype": "float16"}),
    ("enc=bfloat16", {"encoder_dtype": "bfloat16"}),
    ("enc_sdpa=fused", {"fused_sdpa": True}),
    ("enc_layer=fused", {"fused_layer": True}),
    ("fusedlayer+int16+packedfp16+noalign",
     {"fused_layer": True, "kv_dtype": "int16", "argmax_method": "packed_fp16",
      **_NOALIGN}),
    ("fusedsdpa+int16+packedfp16+noalign",
     {"fused_sdpa": True, "kv_dtype": "int16", "argmax_method": "packed_fp16",
      **_NOALIGN}),
    ("encfp16+int16+packedfp16+noalign",
     {"encoder_dtype": "float16", "kv_dtype": "int16", "argmax_method": "packed_fp16",
      **_NOALIGN}),
]


def write_package(tmp, enc, dec, heads, emb, ffn, seed, bias_scale=None):
    """A synthetic .bin/.spm/.shortlist package both sides read, written
    to `tmp` as `{seed}-model.bin`, `{seed}-vocab.spm` and
    `{seed}-shortlist.bin`. `bias_scale` multiplies the logit bias (the
    peaked cell). Returns (config, model bytes, SpmModel, paths)."""
    from slimt_tpu_torch.config import ModelConfig
    from slimt_tpu_torch.io import marian
    from slimt_tpu_torch.io.shortlist import build_synthetic_shortlist
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.synthetic_vocab import build_spm_model

    config = ModelConfig(encoder_layers=enc, decoder_layers=dec, num_heads=heads)
    model_bytes = synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=emb, ffn_dim=ffn, seed=seed)
    if bias_scale is not None:
        items = marian.load_items(model_bytes)
        for item in items:
            if item.name == "decoder_ff_logit_out_b":
                item.array = (item.array * bias_scale).astype(np.float32)
        model_bytes = marian.save_items(items)
    # Exactly VOCAB pieces: the reference strides its logits by the
    # vocabulary's size (Transformer.cc:282).
    spm = build_spm_model([], target_size=0)
    base = list(spm.pieces)
    extra = [spm_proto.Piece(f"▁w{i}", -float(i + 2), spm_proto.PIECE_NORMAL)
             for i in range(VOCAB - len(base))]
    spm = dataclasses.replace(spm, pieces=base + extra)
    assert len(spm.pieces) == VOCAB, len(spm.pieces)
    paths = {}
    for name, payload in (
        ("model.bin", model_bytes),
        ("vocab.spm", spm_proto.serialize_model(spm)),
        ("shortlist.bin", build_synthetic_shortlist(VOCAB, seed=seed)),
    ):
        paths[name] = os.path.join(tmp, f"{seed}-{name}")
        with open(paths[name], "wb") as f:
            f.write(payload)
    return config, model_bytes, spm, paths


def zero_logit_bias(model_bytes: bytes) -> bytes:
    """The model re-serialized with decoder_ff_logit_out_b zeroed."""
    from slimt_tpu_torch.io import marian

    items = marian.load_items(model_bytes)
    for item in items:
        if item.name == "decoder_ff_logit_out_b":
            item.array = np.zeros_like(item.array)
    return marian.save_items(items)


def corpus(lines, eos, seed):
    """`lines` sentences of 4-19 random ids in [2, VOCAB), each + EOS."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(lines):
        n = int(rng.integers(4, 20))
        ids = rng.integers(2, VOCAB, n).astype(np.uint32).tolist()
        ids.append(eos)
        out.append(ids)
    return out


def serving_corpus(lines, eos, seed, lengths=(7, 11, 15), batch=SERVING_BATCH):
    """The serving sweep's corpus: each run of `batch` sentences shares a
    length, cycling through `lengths`, so the batch shapes repeat."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < lines:
        n = int(lengths[(len(out) // batch) % len(lengths)])
        for _ in range(batch):
            ids = rng.integers(2, VOCAB, n).astype(np.uint32).tolist()
            ids.append(eos)
            out.append(ids)
    return out[:lines]


@functools.cache
def harness_runs() -> bool:
    """Whether the reference harness starts here: run with no arguments it
    exits 2 asking for --model; where a library it links is missing, the
    loader exits 127 before it."""
    try:
        proc = subprocess.run([HARNESS], capture_output=True, text=True)
    except OSError:
        return False
    return proc.returncode == 2 and "required" in proc.stderr


def _harness_call(paths, config, sentences, batch, with_shortlist, dump_shortlist):
    """The harness's arguments (paths last, so a leg's key holds none of
    them) and its standard input for one leg."""
    args = ["--enc", str(config.encoder_layers), "--dec", str(config.decoder_layers),
            "--heads", str(config.num_heads), "--batch", str(batch)]
    if dump_shortlist:
        args += ["--dump-shortlist"]
    files = ["model.bin", "vocab.spm"]
    if with_shortlist or dump_shortlist:
        files.append("shortlist.bin")
    text = "\n".join(" ".join(str(w) for w in s) for s in sentences) + "\n"
    return args, files, text


def leg_key(paths, args, files, text) -> str:
    """SHA-256 of what the harness reads for a leg: its arguments, the
    bytes of each file it opens and its standard input."""
    digest = hashlib.sha256(" ".join(args).encode())
    for name in files:
        with open(paths[name], "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    digest.update(text.encode())
    return digest.hexdigest()


@functools.cache
def recorded_legs() -> dict:
    """RECORDED's legs, {key: token lists}; empty where it is absent."""
    if not os.path.exists(RECORDED):
        return {}
    with open(RECORDED) as f:
        legs = json.load(f)["legs"]
    return {key: [[int(t) for t in line.split()] for line in leg["tokens"]]
            for key, leg in legs.items()}


def run_reference(paths, config, sentences, batch, with_shortlist, dump_shortlist=False):
    """The reference harness's tokens (or, with `dump_shortlist`, its
    shortlists) for `sentences` in flushes of `batch`. Where the harness
    cannot start (a machine without the libraries it links), the leg's
    tokens come from RECORDED, written by the `record` mode on a machine
    where it runs; a leg that is in neither raises."""
    args, files, text = _harness_call(paths, config, sentences, batch, with_shortlist,
                                      dump_shortlist)
    if not harness_runs():
        key = leg_key(paths, args, files, text)
        legs = recorded_legs()
        if key not in legs:
            raise RuntimeError(
                f"the reference harness does not start here ({HARNESS}) and "
                f"{os.path.relpath(RECORDED, ROOT)} holds no leg {key[:16]}: run "
                "`python -m slimt_tpu_torch.crosscheck record` where it starts")
        return legs[key]
    cmd = [HARNESS, "--model", paths["model.bin"], "--vocab", paths["vocab.spm"], *args]
    if "shortlist.bin" in files:
        cmd += ["--shortlist", paths["shortlist.bin"]]
    proc = subprocess.run(cmd, input=text, capture_output=True, text=True, check=True)
    for line in proc.stderr.splitlines():
        if "warn" in line:
            raise RuntimeError(f"reference load warning: {line}")
    return [[int(tok) for tok in line.split()] for line in proc.stdout.splitlines()]


def padded_shortlist(gen, group) -> np.ndarray:
    """The group's shortlist padded to a multiple of 64 by duplicates of
    its first entry: a duplicate column has the same logit, and either
    copy of a tie maps to the same word."""
    sl = gen.generate([w for s in group for w in s]).astype(np.int32)
    want = -(-len(sl) // 64) * 64
    if want > len(sl):
        sl = np.concatenate([sl, np.full(want - len(sl), sl[0], np.int32)])
    return sl


def run_port(model_bytes, config, sentences, batch, eos, pad, shortlist_gen,
             device="cuda", kv_dtype="float32", argmax_method="exact",
             with_alignment=True, encoder_dtype=None, fused_sdpa=False,
             fused_layer=False, params=None):
    """The port's tokens for `sentences`, `batch` at a time, through
    translate_batch on `device` (on CUDA, the graph loop). The defaults
    are the exact numerics: the split f32 cache and the f32 first-max
    argmax. `params` (params_from_numpy of the model) skips the load."""
    import torch

    from slimt_tpu_torch.device import resolve_device
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.models import loop_graph
    from slimt_tpu_torch.models.decode import translate_batch

    device = resolve_device(device)
    if params is None:
        params = params_from_numpy(load_weights(load_items(model_bytes), config), device)
    graphs = loop_graph.GraphCache() if device.type == "cuda" else None
    out = []
    for start in range(0, len(sentences), batch):
        group = sentences[start:start + batch]
        t = max(len(s) for s in group)
        indices = np.full((len(group), t), pad, np.int32)
        mask = np.zeros((len(group), t), np.float32)
        for i, toks in enumerate(group):
            indices[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1.0
        shortlist = None
        if shortlist_gen is not None:
            shortlist = torch.from_numpy(padded_shortlist(shortlist_gen, group)).to(device)
        result = translate_batch(
            params, torch.from_numpy(indices).to(device), torch.from_numpy(mask).to(device),
            eos_id=eos, max_steps=int(1.5 * t), num_heads=config.num_heads,
            shortlist=shortlist, with_alignment=with_alignment,
            kv_dtype=kv_dtype, argmax_method=argmax_method, encoder_dtype=encoder_dtype,
            fused_sdpa=fused_sdpa, fused_layer=fused_layer, graphs=graphs,
        )
        tokens, valid = result.tokens.cpu().numpy(), result.valid.cpu().numpy()
        out.extend(tokens[i][valid[i]].tolist() for i in range(len(group)))
    return out


def agreement(ref, got):
    """(sentences exact, sentences, tokens agreeing, tokens): a token
    agrees where both lists hold the same id at its position, over the
    longer list's length."""
    se = st = ta = tt = 0
    for r, g in zip(ref, got):
        st += 1
        se += int(r == g)
        tt += max(len(r), len(g))
        ta += sum(1 for a, b in zip(r, g) if a == b)
    return se, st, ta, tt


def diff(name, ref, got, verbose=False):
    """Print and return (% sentences exact, % tokens agreeing, the
    indices of the sentences that differ)."""
    divergent = [i for i, (r, g) in enumerate(zip(ref, got)) if r != g]
    if verbose:
        for i in divergent:
            print(f"  line {i}: ref={ref[i]}\n          port={got[i]}")
    se, st, ta, tt = agreement(ref, got)
    pct_sent = 100.0 * se / max(1, st)
    pct_tok = 100.0 * ta / max(1, tt)
    print(f"{name:34s} sentences {se}/{st} ({pct_sent:.1f}%)  "
          f"tokens {ta}/{tt} ({pct_tok:.1f}%)", flush=True)
    return pct_sent, pct_tok, divergent


def load_oracle():
    """tests/reference_impl.py (it imports numpy only), loaded by path."""
    spec = importlib.util.spec_from_file_location("slimt_reference_impl", ORACLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def roundf_decode(model_bytes, config, sentence, eos, max_steps, shortlist):
    """One sentence through the NumPy oracle with roundf (half away from
    zero) activation rounding, the reference Ruy provider's; the port
    rounds half to even as the intgemm/gemmology providers do."""
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights

    ri = load_oracle()

    def quantize_roundf(x, mult):
        a = x.astype(np.float32) * mult
        half = np.where(a >= 0, np.float32(0.5), np.float32(-0.5))
        return np.clip(np.trunc(a + half), -127, 127).astype(np.int8)

    ri.quantize = quantize_roundf  # affine() looks it up in the module
    params = load_weights(load_items(model_bytes), config)
    indices = np.asarray(sentence)[None, :]
    mask_add = ri.make_additive_mask(np.ones_like(indices, np.float32))
    enc = ri.encoder_forward(
        params, ri.transform_embedding(ri.embed(params, indices)), mask_add,
        config.num_heads)
    toks, valid, _ = ri.greedy_decode(
        params, enc, mask_add, eos, max_steps, config.num_heads,
        shortlist=np.asarray(shortlist, np.int64) if shortlist is not None else None)
    return toks[0][valid[0]].tolist()


class Leg(NamedTuple):
    """One reference run: a cell's package (bias-free on shortlist legs)
    and a corpus, at one batch size."""

    what: str
    config: object
    model_bytes: bytes
    paths: dict
    sentences: list
    batch: int
    shortlist: bool
    generator: object  # the cell's ShortlistGenerator
    eos: int
    pad: int


def cell_legs(tmp, cell, sentences_of, batches=(SERVING_BATCH,), shortlist=(False, True),
              bias_scale=None, natural_bias=False):
    """The legs of `cell` written to `tmp`: for each shortlist flag and
    batch size, on `sentences_of(eos)`. Shortlist legs read the model
    with its logit bias zeroed, unless `natural_bias`."""
    from slimt_tpu_torch.io.shortlist import ShortlistGenerator

    label, enc, dec, heads, emb, ffn, seed = cell
    config, model_bytes, spm, paths = write_package(
        tmp, enc, dec, heads, emb, ffn, seed, bias_scale=bias_scale)
    with open(paths["shortlist.bin"], "rb") as f:
        gen = ShortlistGenerator(f.read(), VOCAB)
    nobias_bytes = zero_logit_bias(model_bytes)
    nobias_paths = dict(paths, **{"model.bin": paths["model.bin"] + ".nobias"})
    with open(nobias_paths["model.bin"], "wb") as f:
        f.write(nobias_bytes)
    eos = spm.eos_id
    sentences = sentences_of(eos)
    for with_shortlist in shortlist:
        zeroed = with_shortlist and not natural_bias
        for batch in batches:
            tag = "shortlist" if with_shortlist else "full-vocab"
            yield Leg(f"{label} {tag} B={batch}", config,
                      nobias_bytes if zeroed else model_bytes,
                      nobias_paths if zeroed else paths, sentences, batch, with_shortlist,
                      gen, eos, max(0, spm.pad_id))


def tokens_legs(tmp, lines):
    """The tokens mode's legs: every cell at B in (1, 8), full vocabulary
    and shortlist; then the natural-bias shortlist leg of CELLS[0]."""
    for cell in CELLS:
        yield from cell_legs(tmp, cell, lambda eos, c=cell: corpus(lines, eos, c[-1] + 100),
                             batches=(1, 8))
    yield from cell_legs(tmp, CELLS[0], lambda eos: corpus(lines, eos, CELLS[0][-1] + 100),
                         batches=(1,), shortlist=(True,), natural_bias=True)


def serving_legs(tmp, lines, cells=None):
    """The serving sweep's legs at B=8: each cell full vocabulary and
    shortlist, the peaked cell full vocabulary only (its bias is its
    point)."""
    for cell in (CELLS + [PEAKED_CELL]) if cells is None else cells:
        peaked = cell[0].startswith("STRESS")
        yield from cell_legs(
            tmp, cell, lambda eos, c=cell: serving_corpus(lines, eos, c[-1] + 300),
            shortlist=(False,) if peaked else (False, True),
            bias_scale=PEAKED_BIAS_SCALE if peaked else None)


def shortlist_legs(tmp, lines):
    """The shortlist mode's legs: CELLS[0] at B in (1, 8)."""
    yield from cell_legs(tmp, CELLS[0], lambda eos: corpus(lines, eos, CELLS[0][-1] + 200),
                         batches=(1, 8), shortlist=(True,), natural_bias=True)


def mode_tokens(args) -> float:
    """The exact numerics against the reference on every cell; returns
    the worst cell's % of sentences exact (roundf-attributed included),
    the natural-bias leg aside."""
    worst_sent = 100.0
    with tempfile.TemporaryDirectory() as tmp:
        legs = list(tokens_legs(tmp, args.lines))
        for leg in legs:
            ref = run_reference(leg.paths, leg.config, leg.sentences, leg.batch, leg.shortlist)
            got = run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch, leg.eos,
                           leg.pad, leg.generator if leg.shortlist else None,
                           device=args.device)
            if leg is legs[-1]:
                # The reference Ruy provider's unselected bias under a
                # shortlist, on the natural bias: informational.
                diff("ruy-bias-bug (informational)", ref, got, args.verbose)
                break
            pct_sent, _, divergent = diff(leg.what, ref, got, args.verbose)
            attributed = 0
            for i in divergent:
                # The sentence's batch: its shortlist and step cap.
                first = (i // leg.batch) * leg.batch
                group = leg.sentences[first:first + leg.batch]
                sl = (leg.generator.generate([w for s in group for w in s])
                      if leg.shortlist else None)
                cap = int(1.5 * max(len(s) for s in group))
                if roundf_decode(leg.model_bytes, leg.config, leg.sentences[i], leg.eos,
                                 cap, sl) == ref[i]:
                    attributed += 1
            if attributed:
                print(f"    {attributed}/{len(divergent)} divergences attributed to "
                      "provider rounding (roundf oracle == reference)")
            exact = int(round(pct_sent / 100.0 * len(ref))) + attributed
            worst_sent = min(worst_sent, 100.0 * exact / max(1, len(ref)))
    print(f"worst-cell sentence exact-match: {worst_sent:.1f}%")
    return worst_sent


def device_record(device) -> dict:
    """The device a sweep ran on: for a card, torch's name and
    `nvidia-smi`'s name and power limit; else the CPU."""
    import torch

    from slimt_tpu_torch.device import resolve_device

    device = resolve_device(device)
    record = {"platform": device.type, "torch": torch.__version__}
    if device.type == "cuda":
        record["kind"] = torch.cuda.get_device_name(device)
        record["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    return record


# The port's sources whose bytes source_digest covers.
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")


def source_digest() -> str:
    """SHA-256 over the relative path and bytes of every source file of
    the port (slimt_tpu_torch/, SOURCE_SUFFIXES, build outputs and caches
    left out), in path order: the same sources give the same digest on
    any machine, with or without git."""
    package = os.path.join(ROOT, "slimt_tpu_torch")
    digest = hashlib.sha256()
    paths = []
    for folder, dirs, files in os.walk(package):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        paths += [os.path.join(folder, name) for name in files
                  if name.endswith(SOURCE_SUFFIXES)]
    for path in sorted(paths, key=lambda p: os.path.relpath(p, ROOT)):
        with open(path, "rb") as f:
            digest.update(os.path.relpath(path, ROOT).encode() + b"\0" + f.read())
    return digest.hexdigest()


def reference_record() -> str:
    """Where run_reference takes the reference's tokens from here."""
    if harness_runs():
        return "harness"
    with open(RECORDED, "rb") as f:
        recorded = hashlib.sha256(f.read()).hexdigest()
    return f"recorded: {os.path.relpath(RECORDED, ROOT)} (sha256 {recorded})"


def select_configs(patterns: Optional[str]):
    """SERVING_CONFIGS, or the rows whose label holds one of the
    comma-separated `patterns` ("exact" always)."""
    if not patterns:
        return list(SERVING_CONFIGS)
    pats = [p.strip() for p in patterns.split(",") if p.strip()]
    return [(label, opts) for label, opts in SERVING_CONFIGS
            if label == "exact" or any(p in label for p in pats)]


def serving_sweep(configs, lines, device="cuda", cells=None, verbose=False):
    """Each config of `configs` against the reference on the serving legs
    of `cells` (CELLS and PEAKED_CELL): per config, each leg's counts and,
    over the legs of cells that are not the peaked one, the totals.
    Returns {label: row} in serving_agreement.json's row layout."""
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy

    totals = {label: [0, 0, 0, 0] for label, _ in configs}
    per_cell = {label: [] for label, _ in configs}
    with tempfile.TemporaryDirectory() as tmp:
        for leg in serving_legs(tmp, lines, cells):
            label = leg.what.rsplit(" ", 2)[0]
            peaked = label.startswith("STRESS")
            ref = run_reference(leg.paths, leg.config, leg.sentences, leg.batch, leg.shortlist)
            params = params_from_numpy(
                load_weights(load_items(leg.model_bytes), leg.config), device)
            for conf_label, opts in configs:
                got = run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch,
                               leg.eos, leg.pad, leg.generator if leg.shortlist else None,
                               device=device, params=params, **opts)
                counts = agreement(ref, got)
                if not peaked:
                    totals[conf_label] = [a + n for a, n in zip(totals[conf_label], counts)]
                se, st, ta, tt = counts
                per_cell[conf_label].append({
                    "cell": label, "shortlist": leg.shortlist, "sent_exact": se,
                    "sent_total": st, "tok_agree": ta, "tok_total": tt})
                if verbose:
                    print(f"  {label} shortlist={leg.shortlist} {conf_label}: "
                          f"{se}/{st} sentences, {100.0 * ta / max(1, tt):.2f}% tokens",
                          flush=True)
    report = {}
    for conf_label, _ in configs:
        se, st, ta, tt = totals[conf_label]
        cells_run = per_cell[conf_label]
        adversarial = [c for c in cells_run if not c["cell"].startswith("STRESS")]
        row = {
            "sentence_exact_pct": round(100.0 * se / max(1, st), 2),
            "token_agreement_pct": round(100.0 * ta / max(1, tt), 2),
            "worst_cell_token_pct": round(min(
                (100.0 * c["tok_agree"] / max(1, c["tok_total"]) for c in adversarial),
                default=100.0), 2),
            "sentences": st,
            "cells": cells_run,
        }
        stress = [c for c in cells_run if c["cell"].startswith("STRESS")]
        if stress:
            pc = stress[0]
            row["stress_cell_token_pct"] = round(
                100.0 * pc["tok_agree"] / max(1, pc["tok_total"]), 2)
            row["stress_cell_sentence_pct"] = round(
                100.0 * pc["sent_exact"] / max(1, pc["sent_total"]), 2)
        report[conf_label] = row
    return report


def mode_serving(args) -> float:
    """The serving sweep; writes SERVING_OUT unless filtered. Returns the
    exact row's % of sentences exact."""
    configs = select_configs(args.configs)
    report = serving_sweep(configs, args.lines, args.device, verbose=args.verbose)
    print(f"{'config':36s} {'sentences exact':>18s} {'tokens agree':>13s} "
          f"{'worst cell tok%':>16s}")
    for label, row in report.items():
        stress = (f"  stress {row['stress_cell_token_pct']:.2f}%"
                  if "stress_cell_token_pct" in row else "")
        exact = round(row["sentence_exact_pct"] * row["sentences"] / 100)
        print(f"{label:36s} {exact:>7d}/{row['sentences']} "
              f"({row['sentence_exact_pct']:5.1f}%) {row['token_agreement_pct']:12.2f}% "
              f"{row['worst_cell_token_pct']:15.2f}%{stress}")
    if args.configs:
        print("(filtered run: serving_agreement_torch.json not written)")
    else:
        with open(SERVING_OUT, "w") as f:
            json.dump({
                "batch": SERVING_BATCH,
                "lines_per_cell": args.lines,
                "reference": "crosscheck/bin/slimt_ref_harness "
                             "(verbatim reference core, Ruy provider)",
                "port": "slimt_tpu_torch.models.decode.translate_batch",
                "device": device_record(args.device),
                "port_source_sha256": source_digest(),
                "reference_tokens": reference_record(),
                "configs": report,
            }, f, indent=1)
        print(f"wrote {SERVING_OUT}")
    return report["exact"]["sentence_exact_pct"]


def mode_shortlist(args) -> int:
    """ShortlistGenerator.generate against the reference's, batch for
    batch at B in (1, 8); returns the mismatches."""
    mismatches = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        for leg in shortlist_legs(tmp, args.lines):
            ref_lists = run_reference(leg.paths, leg.config, leg.sentences, leg.batch, True,
                                      dump_shortlist=True)
            for idx, start in enumerate(range(0, len(leg.sentences), leg.batch)):
                group = leg.sentences[start:start + leg.batch]
                mine = leg.generator.generate([w for s in group for w in s]).tolist()
                total += 1
                if mine != ref_lists[idx]:
                    mismatches += 1
                    if args.verbose:
                        print(f"batch {idx}: ref={ref_lists[idx][:16]}...\n"
                              f"          port={mine[:16]}...")
    print(f"shortlist generation: {total - mismatches}/{total} batches identical")
    return mismatches


def step_logits(leg, group):
    """The plain CPU logits [B, V] of each decode step of `group` (one
    batch of the leg) under the exact numerics."""
    import torch

    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.models import decode
    from slimt_tpu_torch.models import transformer as tfm

    params = params_from_numpy(load_weights(load_items(leg.model_bytes), leg.config), "cpu")
    t = max(len(s) for s in group)
    indices = np.full((len(group), t), leg.pad, np.int32)
    mask = np.zeros((len(group), t), np.float32)
    for i, toks in enumerate(group):
        indices[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1.0
    logits, argmax = [], tfm.output_argmax

    def recording(p, x, provider=None, projection=None, *rest):
        logits.append(tfm.output_logits(p, x, projection=projection))
        return argmax(p, x, provider, projection, *rest)

    tfm.output_argmax = recording
    try:
        decode.translate_batch(params, torch.from_numpy(indices), torch.from_numpy(mask),
                               eos_id=leg.eos, max_steps=int(1.5 * t),
                               num_heads=leg.config.num_heads, kv_dtype="float32",
                               argmax_method="exact")
    finally:
        tfm.output_argmax = argmax
    return logits


def mode_partings(args) -> None:
    """Print the exact row's partings from the reference on the
    full-vocabulary serving legs, each with its step, choices, plain CPU
    logit gap and roundf attribution."""
    with tempfile.TemporaryDirectory() as tmp:
        for leg in serving_legs(tmp, args.lines):
            if leg.shortlist:
                continue
            ref = run_reference(leg.paths, leg.config, leg.sentences, leg.batch, False)
            got = run_port(leg.model_bytes, leg.config, leg.sentences, leg.batch, leg.eos,
                           leg.pad, None, device=args.device)
            parts = [i for i in range(len(ref)) if ref[i] != got[i]]
            print(f"{leg.what}: {len(parts)} partings", flush=True)
            for i in parts:
                first = (i // leg.batch) * leg.batch
                group = leg.sentences[first:first + leg.batch]
                k = next((j for j, (a, b) in enumerate(zip(ref[i], got[i])) if a != b), None)
                gap = None
                if k is not None:
                    row = step_logits(leg, group)[k][i - first]
                    gap = float(row[ref[i][k]] - row[got[i][k]])
                cap = int(1.5 * max(len(s) for s in group))
                roundf = roundf_decode(leg.model_bytes, leg.config, leg.sentences[i], leg.eos,
                                       cap, None) == ref[i]
                print(f"  sentence {i}: step {k}, reference {ref[i][k] if k is not None else None},"
                      f" port {got[i][k] if k is not None else None}, plain CPU logit gap "
                      f"(reference less port) {gap}, roundf oracle equals the reference: {roundf}",
                      flush=True)


# scripts/crosscheck.py's adversarial splitter corpus: abbreviations,
# NUMERIC_ONLY prefixes, CJK/Armenian stops, footnotes, quotes, ellipses,
# mixed newlines, unicode whitespace.
SPLIT_DOCS = [
    "Hello world. This is a test. Short! Done?",
    "Dr. Smith met Mr. Jones at 5 p.m. They talked. etc. And left.",
    "No. 5 is here. No. Five is not. Art. 12 applies.",
    "He said \u201cStop.\u201d Then left. She asked \u201cWhy?\u201d Nobody knew.",
    "This is v2.0 of the spec. Versions 1.5.2 and 3.10 differ.",
    "\u8fd9\u662f\u4e00\u4e2a\u53e5\u5b50\u3002\u8fd9\u662f\u53e6\u4e00\u4e2a\uff01"
    "\u4f60\u597d\u5417\uff1f\u518d\u89c1\u3002",
    "\u0531\u0575\u057d \u0574\u056b \u0576\u0561\u056d\u0561\u0564\u0561\u057d"
    "\u0578\u0582\u0569\u0575\u0578\u0582\u0576 \u0567\u0589 \u0535\u0582 "
    "\u0574\u0565\u056f \u0578\u0582\u0580\u056b\u0577\u0589",
    "A claim was made [12]. Another claim [3, 4] followed. See refs.",
    "Wait... what happened? An ellipsis\u2026 then more. The end.",
    "i.e. this stays together. E.g. so does this? Q.E.D. Done.",
    "Sentence one.\nSentence two on a new line. And three.\n\n"
    "New paragraph starts here. It continues! Done.",
    "Line with CRLF.\r\nNext line. More text?\r\n\r\nAfter blank.",
    "Ends with no punctuation and trailing spaces   ",
    "((Parenthetical.)) 'Quoted.' \u201cCurly.\u201d Next one.",
    "A.B. initials here. J. R. R. Tolkien wrote books. True.",
    "1. First item. 2. Second item. 10. Tenth item.",
]

# Moses-style nonbreaking prefix file (class 1 + NUMERIC_ONLY class 2),
# format per slimt/Splitter.cc:31-53: scripts/crosscheck.py's.
PREFIX_FILE = """# nonbreaking prefixes (crosscheck corpus)
Dr
Mr
Mrs
Prof
etc
i.e
e.g
vs
A
B
J
R
Q.E.D
No #NUMERIC_ONLY#
Art #NUMERIC_ONLY#
pp #NUMERIC_ONLY#
"""

# The e2e mode's HTML documents (scripts/crosscheck.py's).
HTML_DOCUMENTS = [
    "<b>Hello world.</b> This <i>is</i> a test of <a href='x'>"
    "markup transfer</a>. Done!",
    "<p>First paragraph here.</p><p>Second one, with "
    "<em>emphasis</em> and a <br/>void tag.</p>",
    "Text with &amp; entities &lt;escaped&gt; and trailing "
    "words after <span class='x'>spans</span> end.",
]


def harness_needed(mode: str) -> bool:
    """Print why `mode` cannot run where the harness does not start."""
    if harness_runs():
        return False
    print(f"{mode}: the reference harness does not start here ({HARNESS}); these "
          "host-side text checks need it and are not recorded")
    return True


def mode_split(args) -> int:
    """The port's splitter against the reference's PCRE2 Splitter.cc over
    SPLIT_DOCS, with and without PREFIX_FILE, in each split mode:
    per-document byte-range boundaries. Returns the mismatches (1 where
    the harness cannot start)."""
    from slimt_tpu_torch.text.splitter import SentenceStream, SplitMode, Splitter

    if harness_needed("split"):
        return 1
    mode_map = {
        "sentence": SplitMode.ONE_SENTENCE_PER_LINE,
        "paragraph": SplitMode.ONE_PARAGRAPH_PER_LINE,
        "wrapped": SplitMode.WRAPPED_TEXT,
    }
    mismatch = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        prefix_path = os.path.join(tmp, "prefixes.txt")
        with open(prefix_path, "w") as f:
            f.write(PREFIX_FILE)
        for use_prefixes in (False, True):
            splitter = Splitter()
            if use_prefixes:
                splitter.load(prefix_path)
            for mode_name, mode in mode_map.items():
                for doc_id, doc in enumerate(SPLIT_DOCS):
                    cmd = [HARNESS, "--split", mode_name]
                    if use_prefixes:
                        cmd += ["--prefix-file", prefix_path]
                    ref = subprocess.run(cmd, input=doc, capture_output=True, text=True,
                                         check=True).stdout.splitlines()
                    byte_of = [0]  # character offsets to byte offsets
                    for ch in doc:
                        byte_of.append(byte_of[-1] + len(ch.encode("utf-8")))
                    mine = ["para" if sent == "" else f"{byte_of[begin]} {byte_of[end]}"
                            for sent, begin, end in SentenceStream(doc, splitter, mode)]
                    # The reference may emit a trailing paragraph marker.
                    while ref and ref[-1] == "para":
                        ref.pop()
                    while mine and mine[-1] == "para":
                        mine.pop()
                    total += 1
                    if ref != mine:
                        mismatch += 1
                        if args.verbose:
                            print(f"doc {doc_id} mode={mode_name} prefixes={use_prefixes}:\n"
                                  f"  ref={ref}\n  port={mine}")
    print(f"splitter boundaries: {total - mismatch}/{total} documents identical")
    return mismatch


def mode_process(args) -> int:
    """The port's TextProcessor against the reference's on SPLIT_DOCS, the
    same tokenizer on both sides (the harness's shim vocabulary is the
    JAX package's host library; the port's vocabulary is forced to its
    own, backend="native"), so a difference is wrap, EOS or annotation
    semantics: segments (ids with EOS) and each sentence's and word's
    byte ranges. Returns the mismatches (1 where the harness cannot
    start)."""
    from slimt_tpu_torch.text import spm_proto
    from slimt_tpu_torch.text.processor import TextProcessor
    from slimt_tpu_torch.text.synthetic_vocab import DEFAULT_WORDS, build_spm_model
    from slimt_tpu_torch.text.vocabulary import Vocabulary

    if harness_needed("process"):
        return 1
    spm_bytes = spm_proto.serialize_model(build_spm_model(DEFAULT_WORDS))
    mismatch = total = 0
    with tempfile.TemporaryDirectory() as tmp:
        vocab_path = os.path.join(tmp, "vocab.spm")
        with open(vocab_path, "wb") as f:
            f.write(spm_bytes)
        prefix_path = os.path.join(tmp, "prefixes.txt")
        with open(prefix_path, "w") as f:
            f.write(PREFIX_FILE)
        vocabulary = Vocabulary(spm_bytes, backend="native")
        for mode in ("sentence", "paragraph", "wrapped_text"):
            processor = TextProcessor(mode, vocabulary, PREFIX_FILE)
            for wrap in (8, 128):
                for doc_id, doc in enumerate(SPLIT_DOCS):
                    ref = subprocess.run(
                        [HARNESS, "--process", mode, "--vocab", vocab_path,
                         "--wrap", str(wrap), "--prefix-file", prefix_path],
                        input=doc, capture_output=True, text=True, check=True,
                    ).stdout.splitlines()
                    ann, segments = processor.process(doc, wrap)
                    mine = ["ids " + " ".join(str(w) for w in segment) for segment in segments]
                    for s in range(ann.sentence_count()):
                        rng = ann.sentence_as_range(s)
                        words = " ".join(
                            f"{ann.word_as_range(s, w).begin}:{ann.word_as_range(s, w).end}"
                            for w in range(ann.word_count(s)))
                        mine.append(f"sent {rng.begin} {rng.end} :"
                                    + (f" {words}" if words else ""))
                    total += 1
                    if ref != mine:
                        mismatch += 1
                        if args.verbose:
                            print(f"doc {doc_id} mode={mode} wrap={wrap}:")
                            for a, b in zip(ref + [""] * 9, mine + [""] * 9):
                                if a != b:
                                    print(f"  ref={a}\n  port={b}")
    print(f"text pipeline: {total - mismatch}/{total} documents identical "
          "(segments + annotations)")
    return mismatch


@functools.cache
def cli_runs() -> bool:
    """Whether the reference CLI starts here (its --help exits 0; where a
    library it links is missing, the loader exits 127 before it)."""
    try:
        proc = subprocess.run([REF_CLI, "--help"], capture_output=True, text=True)
    except OSError:
        return False
    return proc.returncode == 0 and "Usage" in proc.stdout


def cli_key(pkg: str, args, text: str) -> str:
    """SHA-256 of what the reference CLI reads for one run: its arguments
    after --root, the bytes of each package file they name (--model,
    --vocabulary, --ssplit) and its standard input."""
    digest = hashlib.sha256(" ".join(args).encode())
    for flag, name in zip(args, args[1:]):
        if flag in ("--model", "--vocabulary", "--ssplit"):
            with open(os.path.join(pkg, name), "rb") as f:
                digest.update(name.encode() + b"\0" + f.read())
    digest.update(text.encode())
    return digest.hexdigest()


@functools.cache
def recorded_cli() -> dict:
    """RECORDED_CLI's runs, {key: output lines}; empty where it is absent."""
    if not os.path.exists(RECORDED_CLI):
        return {}
    with open(RECORDED_CLI) as f:
        return {key: run["lines"] for key, run in json.load(f)["runs"].items()}


def run_reference_cli(pkg: str, args, text: str):
    """The reference CLI's output lines (its 4-line config echo dropped)
    for `text` on the package at `pkg` with `args` (after --root). Where
    the CLI cannot start, the lines come from RECORDED_CLI (`record`
    writes it where the CLI starts); a run that is in neither raises."""
    if not cli_runs():
        key = cli_key(pkg, args, text)
        runs = recorded_cli()
        if key not in runs:
            raise RuntimeError(
                f"the reference CLI does not start here ({REF_CLI}) and "
                f"{os.path.relpath(RECORDED_CLI, ROOT)} holds no run {key[:16]}: run "
                "`python -m slimt_tpu_torch.crosscheck record` where it starts")
        return list(runs[key])
    proc = subprocess.run([REF_CLI, "--root", pkg, *args], input=text, capture_output=True,
                          text=True, check=True)
    return proc.stdout.splitlines()[4:]  # the config echo (app/main.cc:73-76)


def reference_cli_source() -> str:
    """Where run_reference_cli takes the reference CLI's lines from here."""
    if cli_runs():
        return "the reference CLI"
    return (f"recorded lines from {os.path.relpath(RECORDED_CLI, ROOT)} (the reference "
            "CLI does not start here)")


def synth_package(out: str, emb: int = 64, ffn: int = 128, prefixes: bool = True) -> str:
    """`python -m slimt_tpu_torch synth` (the tiny preset) into `out`, run
    in this process, with PREFIX_FILE as prefixes.txt where asked."""
    from slimt_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["synth", "--out", out, "--emb-dim", str(emb), "--ffn-dim", str(ffn)])
    if prefixes:
        with open(os.path.join(out, "prefixes.txt"), "w") as f:
            f.write(PREFIX_FILE)
    return out


def translate_subprocess(argv, text: str) -> str:
    """`python -m slimt_tpu_torch translate ARGV` on `text`: its stdout,
    with the native batch tokenizer (the reference's tokenization)."""
    env = dict(os.environ, SLIMT_TPU_BATCH_BACKEND="native")
    return subprocess.run([sys.executable, "-m", "slimt_tpu_torch", "translate", *argv],
                          input=text, capture_output=True, text=True, check=True,
                          env=env, cwd=ROOT).stdout


def e2e_documents():
    """(document, html) of the e2e mode: SPLIT_DOCS as one document, the
    first 32 lines of data/corpus.txt as another, then HTML_DOCUMENTS."""
    documents = ["\n".join(SPLIT_DOCS)]
    if os.path.exists(CORPUS):
        with open(CORPUS) as f:
            documents.append("\n".join([line.rstrip("\n") for line in f][:32]))
    return [(doc, False) for doc in documents] + [(doc, True) for doc in HTML_DOCUMENTS]


def e2e_cli_args(html: bool):
    return (["--model", "model.bin", "--vocabulary", "vocab.spm", "--ssplit", "prefixes.txt"]
            + (["--html"] if html else []))


def _skeleton(text: str):
    import re

    return re.findall(r"<[^>]+>", text), sorted(re.sub(r"<[^>]+>", " ", text).split())


def mode_e2e(args, translate=translate_subprocess) -> int:
    """The reference's whole CLI against `python -m slimt_tpu_torch
    translate --exact --device ...` (through `translate(argv, text)`) on
    the e2e documents and the synthetic package: exact string compare,
    or, for HTML, the tag skeleton and the token multiset where tags move
    on an attention tie; then the declared serving config
    (informational). Returns the mismatches."""
    mismatch = total = serving_same = 0
    print(f"reference CLI: {reference_cli_source()}")
    with tempfile.TemporaryDirectory() as tmp:
        pkg = synth_package(os.path.join(tmp, "pkg"))
        cases = e2e_documents()
        mine_args = ["--root", pkg, "--ssplit", "prefixes.txt", "--device", args.device]
        for doc_id, (doc, html) in enumerate(cases):
            ref_text = "\n".join(run_reference_cli(pkg, e2e_cli_args(html), doc)).strip()
            flag = ["--html"] if html else []
            mine_text = translate(mine_args + ["--exact"] + flag, doc).strip()
            total += 1
            if ref_text != mine_text:
                if html and _skeleton(ref_text) == _skeleton(mine_text):
                    if args.verbose:
                        print(f"document {doc_id}: tag placement differs on an attention "
                              "tie (skeleton + tokens identical)")
                else:
                    mismatch += 1
                    if args.verbose:
                        print(f"document {doc_id} html={html}:\n  ref: {ref_text[:400]}\n"
                              f"  port: {mine_text[:400]}")
            serving_same += int(ref_text == translate(mine_args + flag, doc).strip())
    print(f"e2e CLI text: {total - mismatch}/{total} documents identical")
    print(f"e2e serving-config (informational): {serving_same}/{total} documents "
          "byte-identical under the declared serving config")
    return mismatch


def bleu_report(args, translate=translate_subprocess) -> dict:
    """The bleu mode's JSON: corpus BLEU of the reference CLI, the port's
    serving config and its exact path (through `translate(argv, text)` on
    --device) on --bleu-lines sources, against --bleu-reference or the
    reference CLI's own output; the lines equal to the reference CLI's
    on each path."""
    from slimt_tpu_torch.bleu import corpus_bleu

    with tempfile.TemporaryDirectory() as tmp:
        pkg = args.bleu_package
        if pkg is None:
            pkg = synth_package(os.path.join(tmp, "pkg"))
        if args.bleu_source:
            with open(args.bleu_source, encoding="utf-8") as f:
                sources = [line.rstrip("\n") for line in f]
        else:
            with open(CORPUS) as f:
                sources = [line.rstrip("\n") for line in f if line.strip()]
        text = "\n".join(sources[:args.bleu_lines])
        ssplit = (["--ssplit", "prefixes.txt"]
                  if os.path.exists(os.path.join(pkg, "prefixes.txt")) else [])
        package_args = ["--model", args.bleu_model, "--vocabulary", args.bleu_vocab, *ssplit]
        ref_lines = run_reference_cli(pkg, package_args, text)
        mine_args = ["--root", pkg, *package_args, "--device", args.device]
        serving_lines = translate(mine_args, text).splitlines()  # the declared config
        exact_lines = translate(mine_args + ["--exact"], text).splitlines()
    pseudo = args.bleu_reference is None
    if pseudo:
        references = ref_lines
    else:
        with open(args.bleu_reference, encoding="utf-8") as f:
            references = [line.rstrip("\n") for line in f][:args.bleu_lines]
    n = min(len(references), len(ref_lines), len(serving_lines), len(exact_lines))
    rows = {}
    for label, lines in (("reference_cli", ref_lines),
                         ("slimt_tpu_torch_serving", serving_lines),
                         ("slimt_tpu_torch_exact", exact_lines)):
        rows[f"bleu_{label}"] = round(corpus_bleu(lines[:n], references[:n])[0], 2)
    return {
        **rows,
        "delta_serving": round(rows["bleu_slimt_tpu_torch_serving"]
                               - rows["bleu_reference_cli"], 2),
        "lines": n,
        "line_exact_vs_reference_serving": round(
            sum(a == b for a, b in zip(serving_lines[:n], ref_lines[:n])) / n, 4),
        "line_exact_vs_reference_exact": round(
            sum(a == b for a, b in zip(exact_lines[:n], ref_lines[:n])) / n, 4),
        "pseudo_reference": pseudo,
    }


def mode_bleu(args) -> int:
    """Print bleu_report's JSON; exit status 1 below BLEU_EXACT_MIN of
    lines equal on the exact path in pseudo-reference mode (with a real
    reference there is no gate: the BLEUs are the report)."""
    print(f"reference CLI: {reference_cli_source()}")
    out = bleu_report(args)
    print(json.dumps(out))
    return 1 if out["pseudo_reference"] and (
        out["line_exact_vs_reference_exact"] < BLEU_EXACT_MIN) else 0


def cli_runs_to_record():
    """(what, package dir, CLI args, text) of every reference CLI run that
    RECORDED_CLI keeps, in a temporary directory: the e2e documents and
    the bleu legs at BLEU_WIDTHS (the default package with prefixes.txt,
    as the mode makes it; the full-width one as --bleu-package, without)."""
    with tempfile.TemporaryDirectory() as tmp:
        pkg = synth_package(os.path.join(tmp, "pkg"))
        runs = [(f"e2e document {i} html={html}", pkg, e2e_cli_args(html), doc)
                for i, (doc, html) in enumerate(e2e_documents())]
        with open(CORPUS) as f:
            sources = [line.rstrip("\n") for line in f if line.strip()]
        text = "\n".join(sources[:BLEU_LINES])
        for emb, ffn in BLEU_WIDTHS:
            default = (emb, ffn) == BLEU_WIDTHS[0]
            leg = pkg if default else synth_package(
                os.path.join(tmp, f"pkg{emb}"), emb, ffn, prefixes=False)
            args = ["--model", "model.bin", "--vocabulary", "vocab.spm"]
            if default:
                args += ["--ssplit", "prefixes.txt"]
            runs.append((f"bleu E={emb} F={ffn} lines={BLEU_LINES}", leg, args, text))
        yield from runs


def record_cli() -> int:
    """Run the reference CLI on every run of cli_runs_to_record and write
    RECORDED_CLI: {key: its lines}."""
    if not cli_runs():
        raise SystemExit(f"the reference CLI does not start here: {REF_CLI}")
    runs = {}
    for what, pkg, args, text in cli_runs_to_record():
        start = time.perf_counter()
        runs[cli_key(pkg, args, text)] = {"what": what,
                                          "lines": run_reference_cli(pkg, args, text)}
        print(f"recorded {what} ({time.perf_counter() - start:.1f} s)", flush=True)
    with open(RECORDED_CLI, "w") as f:
        json.dump({"cli": "crosscheck/bin/slimt_ref_cli",
                   "written_by": "python -m slimt_tpu_torch.crosscheck record",
                   "runs": runs}, f, indent=0, ensure_ascii=False)
    print(f"wrote {len(runs)} runs to {RECORDED_CLI}")
    return 0


# chip_smoke.py's reference cell: the narrow cell's first 64 serving lines.
SMOKE_CELL, SMOKE_LINES = CELLS[2], 64


def mode_record(args) -> int:
    """Run the harness on every leg of the three modes at their default
    sizes and of chip_smoke.py's cell, and write RECORDED: {leg key:
    its tokens}; then record_cli. Where the harness starts, it is run;
    the files serve a machine where it does not."""
    if not harness_runs():
        raise SystemExit(f"the reference harness does not start here: {HARNESS}")
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(leg, False) for leg in tokens_legs(tmp, 48)]
        runs += [(leg, False) for leg in serving_legs(tmp, 256)]
        runs += [(leg, False) for leg in serving_legs(tmp, SMOKE_LINES, [SMOKE_CELL])]
        runs += [(leg, True) for leg in shortlist_legs(tmp, 48)]
        for leg, dump in runs:
            args_, files, text = _harness_call(leg.paths, leg.config, leg.sentences,
                                               leg.batch, leg.shortlist, dump)
            key = leg_key(leg.paths, args_, files, text)
            tokens = run_reference(leg.paths, leg.config, leg.sentences, leg.batch,
                                   leg.shortlist, dump_shortlist=dump)
            legs[key] = {"what": f"{leg.what} lines={len(leg.sentences)}"
                                 + (" shortlists" if dump else ""),
                         "tokens": [" ".join(map(str, line)) for line in tokens]}
    with open(RECORDED, "w") as f:
        json.dump({"harness": "crosscheck/bin/slimt_ref_harness",
                   "written_by": "python -m slimt_tpu_torch.crosscheck record",
                   "legs": legs}, f, indent=0)
    print(f"wrote {len(legs)} legs to {RECORDED}")
    return record_cli()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m slimt_tpu_torch.crosscheck")
    parser.add_argument("mode", choices=["tokens", "serving", "shortlist", "partings",
                                         "split", "process", "e2e", "bleu", "record"])
    parser.add_argument("--lines", type=int, default=None,
                        help="sentences a cell (tokens, shortlist: 48; serving: 256)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--configs", default=None,
                        help="serving: comma-separated substrings of the rows to run "
                             "('exact' always runs); a filtered run writes nothing")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--bleu-package", default=None,
                        help="bleu: a package dir (default: the synthetic package)")
    parser.add_argument("--bleu-model", default="model.bin")
    parser.add_argument("--bleu-vocab", default="vocab.spm")
    parser.add_argument("--bleu-source", default=None,
                        help="bleu: the test set's sources (default: data/corpus.txt)")
    parser.add_argument("--bleu-reference", default=None,
                        help="bleu: its reference translations; absent, the reference "
                             "CLI's own output is the reference")
    parser.add_argument("--bleu-lines", type=int, default=BLEU_LINES)
    args = parser.parse_args(argv)
    if args.lines is None:
        args.lines = 256 if args.mode in ("serving", "partings") else 48
    if args.mode == "tokens":
        return 1 if mode_tokens(args) < EXACT_MIN else 0
    if args.mode == "serving":
        return 1 if mode_serving(args) < EXACT_MIN else 0
    if args.mode == "record":
        return mode_record(args)
    if args.mode == "partings":
        mode_partings(args)
        return 0
    if args.mode in ("split", "process", "e2e"):
        modes = {"split": mode_split, "process": mode_process, "e2e": mode_e2e}
        return 1 if modes[args.mode](args) else 0
    if args.mode == "bleu":
        return mode_bleu(args)
    return 1 if mode_shortlist(args) else 0


if __name__ == "__main__":
    sys.exit(main())
