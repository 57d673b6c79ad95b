"""Self-contained corpus BLEU, sacrebleu-compatible: the port's own copy
of the JAX package's scripts/bleu.py (the same code), so that the
port's parity tooling (`python -m slimt_tpu_torch.crosscheck bleu`,
`python -m slimt_tpu_torch.parity bleu`) imports nothing of the JAX
package. tests/test_torch_bleu.py holds it equal to scripts/bleu.py,
which tests/test_bleu.py holds to the sacrebleu package to 4 decimals
where that package is installed.

Scoring definition implemented (the published mteval-v13a/sacrebleu
algorithm):
  - `13a` tokenization: normalize a handful of entities, then split
    punctuation as mteval's international tokenizer does;
  - modified n-gram precision p_n for n=1..4, counts clipped per
    sentence against the reference, summed over the corpus;
  - `exp` smoothing: every time a numerator is zero, the smoothing
    denominator doubles and p_n = 1 / (smooth * total_n);
  - BP = min(1, exp(1 - ref_len / sys_len));
  - BLEU = 100 * BP * exp(mean_n log p_n).

Usage: python -m slimt_tpu_torch.bleu HYPOTHESES REFERENCES
"""

from __future__ import annotations

import math
import re
from collections import Counter
from typing import Iterable, List, Sequence, Tuple

MAX_ORDER = 4

# mteval-v13a international punctuation split (the `13a` tokenizer's
# post-normalization stage): these four rules are the published
# algorithm definition.
_RULES = (
    (re.compile(r"([\{-\~\[-\` -\&\(-\+\:-\@\/])"), r" \1 "),
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),
)


def tokenize_13a(line: str) -> List[str]:
    line = line.replace("<skipped>", "")
    line = line.replace("-\n", "")
    line = line.replace("\n", " ")
    if "&" in line:
        line = (
            line.replace("&quot;", '"')
            .replace("&amp;", "&")
            .replace("&lt;", "<")
            .replace("&gt;", ">")
        )
    line = f" {line} "
    for pattern, repl in _RULES:
        line = pattern.sub(repl, line)
    return line.split()


def _ngrams(tokens: Sequence[str]) -> Counter:
    counts: Counter = Counter()
    n_tokens = len(tokens)
    for order in range(1, MAX_ORDER + 1):
        for i in range(n_tokens - order + 1):
            counts[tuple(tokens[i : i + order])] += 1
    return counts


def corpus_bleu(
    hypotheses: Iterable[str],
    references: Iterable[str],
    tokenize=tokenize_13a,
) -> Tuple[float, dict]:
    """Corpus BLEU of `hypotheses` against single `references`
    (sacrebleu.corpus_bleu(hyps, [refs]).score semantics). Returns
    (score_0_to_100, detail dict with precisions/BP/lengths)."""
    correct = [0] * MAX_ORDER
    total = [0] * MAX_ORDER
    sys_len = 0
    ref_len = 0
    n_pairs = 0
    for hyp, ref in zip(hypotheses, references):
        hyp_tokens = tokenize(hyp)
        ref_tokens = tokenize(ref)
        sys_len += len(hyp_tokens)
        ref_len += len(ref_tokens)
        n_pairs += 1
        ref_counts = _ngrams(ref_tokens)
        for ngram, count in _ngrams(hyp_tokens).items():
            order = len(ngram)
            total[order - 1] += count
            clipped = min(count, ref_counts.get(ngram, 0))
            correct[order - 1] += clipped

    bp = 1.0
    if sys_len < ref_len:
        bp = math.exp(1.0 - ref_len / sys_len) if sys_len > 0 else 0.0
    precisions = [0.0] * MAX_ORDER
    if not any(correct):
        # No matching n-gram of any order: BLEU is defined as 0 (no
        # smoothing applied — matches sacrebleu's early exit).
        score = 0.0
    else:
        smooth = 1.0
        for n in range(MAX_ORDER):
            if total[n] == 0:
                break
            if correct[n] == 0:
                smooth *= 2.0
                precisions[n] = 100.0 / (smooth * total[n])
            else:
                precisions[n] = 100.0 * correct[n] / total[n]
        log_sum = sum(
            math.log(p) if p > 0.0 else -9999999999.0 for p in precisions
        )
        score = bp * math.exp(log_sum / MAX_ORDER)
    detail = {
        "precisions": [round(p, 4) for p in precisions],
        "bp": round(bp, 4),
        "sys_len": sys_len,
        "ref_len": ref_len,
        "pairs": n_pairs,
    }
    return score, detail


def main() -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        description="corpus BLEU (sacrebleu-compatible: 13a + exp "
        "smoothing) of a hypothesis file against a reference file"
    )
    parser.add_argument("hypotheses", help="system output, one line per segment")
    parser.add_argument("references", help="reference, one line per segment")
    args = parser.parse_args()
    with open(args.hypotheses, encoding="utf-8") as f:
        hyps = [line.rstrip("\n") for line in f]
    with open(args.references, encoding="utf-8") as f:
        refs = [line.rstrip("\n") for line in f]
    if len(hyps) != len(refs):
        raise SystemExit(
            f"line count mismatch: {len(hyps)} hypotheses vs "
            f"{len(refs)} references"
        )
    score, detail = corpus_bleu(hyps, refs)
    print(json.dumps({"bleu": round(score, 4), **detail}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
