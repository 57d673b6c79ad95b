"""Translation parity of the port: the counterpart of scripts/parity.py's
modes on the port's own modules.

Modes:
  oracle     decode a corpus with the port (the exact numerics: split f32
             KV cache, f32 first-max argmax) and with the NumPy oracle
             tests/reference_impl.py (loaded by path; it imports numpy
             only); report exact-token agreement. Exit status 1 unless
             every sentence agrees.
  matrix     the oracle's verdict over a sweep of architectures x
             {full vocabulary, shortlist}.
  providers  xla_int8 against pallas (the same int8 product in the port:
             must agree on every sentence), and, reported beside them,
             fused, fused_step (int16 cache) and f32.
  reduced    token agreement of the reduced-precision options with the
             exact path over several random-weight models (a worst case:
             random weights give near-tied logits).
  bleu       corpus BLEU of a hypothesis file against a reference file,
             one segment a line, by slimt_tpu_torch/bleu.py (sacrebleu's
             scoring, which scripts/parity.py calls; neither machine has
             sacrebleu); prints its JSON.

`--device` picks where the port runs: the card (default) or the CPU.

Usage:
    python -m slimt_tpu_torch.parity oracle [--lines 64] [--device cpu]
    python -m slimt_tpu_torch.parity matrix [--lines 16]
    python -m slimt_tpu_torch.parity providers [--lines 64]
    python -m slimt_tpu_torch.parity reduced [--lines 32] [--models 5]
    python -m slimt_tpu_torch.parity bleu HYPOTHESES REFERENCES
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from slimt_tpu_torch.crosscheck import load_oracle

VOCAB = 512
EOS, MAX_STEPS = 2, 24
# (label, enc, dec, heads, emb, ffn, seed): scripts/parity.py's matrix.
MATRIX = [
    ("tiny-ratio 3/2/4", 3, 2, 4, 64, 128, 0),
    ("base-ratio 6/2/8", 6, 2, 8, 64, 256, 1),
    ("narrow 2/2/2", 2, 2, 2, 32, 64, 2),
    ("single 1/1/1", 1, 1, 1, 32, 64, 3),
    ("deep-dec 2/4/4", 2, 4, 4, 64, 128, 4),
]
REDUCED = [
    ("kv=int16", dict(kv_dtype="int16")),
    ("kv=float16", dict(kv_dtype="float16")),
    ("kv=bfloat16", dict(kv_dtype="bfloat16")),
    ("kv=int8", dict(kv_dtype="int8")),
    ("argmax=packed_fp16", dict(argmax_method="packed_fp16")),
    ("argmax=packed_bf16", dict(argmax_method="packed_bf16")),
    ("serving default", dict(kv_dtype="int16", argmax_method="packed_fp16",
                             with_alignment=False)),
]


def build(enc=3, dec=2, heads=4, emb=64, ffn=128, seed=0):
    """(config, the loader's numpy params) of a synthetic model."""
    from slimt_tpu_torch.config import ModelConfig
    from slimt_tpu_torch.io import load_items
    from slimt_tpu_torch.io.loader import load_weights
    from slimt_tpu_torch.io.synthetic import synthetic_model_bytes

    config = ModelConfig(encoder_layers=enc, decoder_layers=dec, num_heads=heads)
    items = load_items(synthetic_model_bytes(
        config=config, vocab_size=VOCAB, emb_dim=emb, ffn_dim=ffn, seed=seed))
    return config, load_weights(items, config)


def corpus(lines, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, VOCAB, int(rng.integers(4, 20))).astype(np.int32)
            for _ in range(lines)]


def decode_port(config, host_params, sentences, device, provider=None, shortlist=None,
                kv_dtype=None, argmax_method="exact", **options):
    """The port's tokens for `sentences` as one padded batch (the JAX
    script's _decode_jax): translate_batch on `device`, by default the
    exact numerics."""
    import torch

    from slimt_tpu_torch.device import resolve_device
    from slimt_tpu_torch.io.params import params_from_numpy
    from slimt_tpu_torch.models import loop_graph
    from slimt_tpu_torch.models.decode import translate_batch

    device = resolve_device(device)
    params = params_from_numpy(host_params, device, dequantize=provider == "f32")
    b, t = len(sentences), max(len(x) for x in sentences)
    indices = np.zeros((b, t), np.int32)
    mask = np.zeros((b, t), np.float32)
    for i, toks in enumerate(sentences):
        indices[i, :len(toks)] = toks
        mask[i, :len(toks)] = 1.0
    result = translate_batch(
        params, torch.from_numpy(indices).to(device), torch.from_numpy(mask).to(device),
        eos_id=EOS, max_steps=MAX_STEPS, num_heads=config.num_heads, provider=provider,
        shortlist=torch.from_numpy(shortlist).to(device) if shortlist is not None else None,
        kv_dtype=kv_dtype, argmax_method=argmax_method,
        graphs=loop_graph.GraphCache() if device.type == "cuda" else None, **options)
    tokens, valid = result.tokens.cpu().numpy(), result.valid.cpu().numpy()
    return [tokens[i][valid[i]].tolist() for i in range(b)]


def oracle_agree(config, host_params, sentences, shortlist, device, verbose=False):
    """(sentences the port and the oracle decode alike, sentences)."""
    ref = load_oracle()
    got = decode_port(config, host_params, sentences, device, shortlist=shortlist)
    agree = 0
    for i, toks in enumerate(sentences):
        indices = np.asarray(toks)[None, :]
        mask_add = ref.make_additive_mask(np.ones_like(indices, np.float32))
        enc = ref.encoder_forward(
            host_params, ref.transform_embedding(ref.embed(host_params, indices)), mask_add,
            config.num_heads)
        want_tokens, want_valid, _ = ref.greedy_decode(
            host_params, enc, mask_add, EOS, MAX_STEPS, config.num_heads, shortlist=shortlist)
        want = want_tokens[0][want_valid[0]].tolist()
        if want == got[i]:
            agree += 1
        elif verbose:
            print(f"line {i}: port={got[i]} oracle={want}")
    return agree, len(sentences)


def mode_oracle(args) -> int:
    if args.preset == "base":
        config, params = build(6, 2, 8, 64, 256, 0)
    else:
        config, params = build()
    shortlist = np.arange(0, VOCAB, 2, dtype=np.int32) if args.shortlist else None
    agree, total = oracle_agree(config, params, corpus(args.lines), shortlist, args.device,
                                args.verbose)
    print(f"oracle agreement: {agree}/{total} sentences exact-match")
    return 0 if agree == total else 1


def mode_matrix(args) -> int:
    failures = 0
    for label, enc, dec, heads, emb, ffn, seed in MATRIX:
        config, params = build(enc, dec, heads, emb, ffn, seed)
        sentences = corpus(args.lines, seed=seed + 10)
        for shortlist in (None, np.arange(0, VOCAB, 2, dtype=np.int32)):
            agree, total = oracle_agree(config, params, sentences, shortlist, args.device)
            tag = "shortlist" if shortlist is not None else "full-vocab"
            failures += agree != total
            print(f"{label:20s} {tag:10s} {agree}/{total} "
                  f"{'OK' if agree == total else 'FAIL'}")
    return 1 if failures else 0


def mode_providers(args) -> int:
    """xla_int8 against pallas gates; fused, fused_step (int16 cache) and
    f32 are reported."""
    sentences = corpus(args.lines)
    config, params = build()
    # fused_step takes the int16 cache for the exact split one, as in the
    # JAX package.
    outputs = {provider: decode_port(config, params, sentences, args.device, provider)
               for provider in ("xla_int8", "pallas", "fused", "fused_step", "f32")}
    mismatches = sum(a != b for a, b in zip(outputs["xla_int8"], outputs["pallas"]))
    print(f"provider agreement (xla_int8 vs pallas): "
          f"{len(sentences) - mismatches}/{len(sentences)}")
    for provider, what in (("fused", "fused blocks"), ("fused_step", "fused_step int16-KV"),
                           ("f32", "f32 dequantized")):
        agree = sum(a == b for a, b in zip(outputs["xla_int8"], outputs[provider]))
        print(f"provider agreement (xla_int8 vs {what}): {agree}/{len(sentences)}")
    return 0 if mismatches == 0 else 1


def mode_reduced(args) -> int:
    stats = {label: [] for label, _ in REDUCED}
    for seed in range(args.models):
        config, params = build(seed=seed)
        sentences = corpus(args.lines, seed=seed + 100)
        want = decode_port(config, params, sentences, args.device)
        for label, opts in REDUCED:
            got = decode_port(config, params, sentences, args.device, **opts)
            matched = sum(sum(a == b for a, b in zip(w, g)) for w, g in zip(want, got))
            total = sum(len(w) for w in want)
            stats[label].append(matched / max(total, 1))
    failures = 0
    for label, rates in stats.items():
        mean, worst = float(np.mean(rates)), float(np.min(rates))
        failures += worst < args.threshold
        print(f"{label:22s} mean {mean:.3f}  worst {worst:.3f} over {args.models} models "
              f"x {args.lines} lines  {'OK' if worst >= args.threshold else 'FAIL'}")
    return 1 if failures else 0


def mode_bleu(args) -> int:
    """Print the corpus BLEU of args.hypothesis against args.reference."""
    import json

    from slimt_tpu_torch.bleu import corpus_bleu

    with open(args.hypothesis, encoding="utf-8") as f:
        hyps = [line.rstrip("\n") for line in f]
    with open(args.reference, encoding="utf-8") as f:
        refs = [line.rstrip("\n") for line in f]
    score, detail = corpus_bleu(hyps, refs)
    print(json.dumps({"bleu": round(score, 4), **detail}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m slimt_tpu_torch.parity")
    sub = parser.add_subparsers(dest="mode", required=True)
    o = sub.add_parser("oracle")
    o.add_argument("--lines", type=int, default=64)
    o.add_argument("--verbose", action="store_true")
    o.add_argument("--shortlist", action="store_true")
    o.add_argument("--preset", choices=["tiny", "base"], default="tiny")
    o.set_defaults(fn=mode_oracle)
    p = sub.add_parser("providers")
    p.add_argument("--lines", type=int, default=64)
    p.set_defaults(fn=mode_providers)
    m = sub.add_parser("matrix")
    m.add_argument("--lines", type=int, default=16)
    m.set_defaults(fn=mode_matrix)
    r = sub.add_parser("reduced")
    r.add_argument("--lines", type=int, default=32)
    r.add_argument("--models", type=int, default=5)
    r.add_argument("--threshold", type=float, default=0.8)
    r.set_defaults(fn=mode_reduced)
    for sp in (o, p, m, r):
        sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    b = sub.add_parser("bleu")
    b.add_argument("hypothesis")
    b.add_argument("reference")
    b.set_defaults(fn=mode_bleu)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
