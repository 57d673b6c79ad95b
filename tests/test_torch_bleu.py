"""The port's corpus BLEU (slimt_tpu_torch/bleu.py) against the JAX
package's scripts/bleu.py, which tests/test_bleu.py holds to the
sacrebleu package: the same scores, details and tokens on test_bleu.py's
corpora, and the same CLI output."""

import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest

from slimt_tpu_torch import bleu

from .test_bleu import NATURAL

SCRIPT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "scripts", "bleu.py")
_spec = importlib.util.spec_from_file_location("jax_scripts_bleu", SCRIPT)
jax_bleu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_bleu)


def _random_corpus(seed):
    rng = random.Random(seed)
    words = "a b c d e f g h i j k .".split()
    hyps, refs = [], []
    for _ in range(rng.randint(2, 30)):
        hyps.append(" ".join(rng.choice(words) for _ in range(rng.randint(1, 18))))
        refs.append(" ".join(rng.choice(words) for _ in range(rng.randint(1, 18))))
    return hyps, refs


CORPORA = {
    "natural": ([h for h, _ in NATURAL], [r for _, r in NATURAL]),
    "perfect": ([r for _, r in NATURAL], [r for _, r in NATURAL]),
    "zero_overlap": (["aa bb cc dd ee", "ff gg hh"], ["xx yy zz ww vv", "uu tt ss"]),
    "short_hyps": (["the cat", "a dog sat", "x"],
                   ["the cat sat on the mat today", "a dog sat on a log by the river",
                    "x y z w"]),
    **{f"random{seed}": _random_corpus(seed) for seed in range(8)},
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_corpus_bleu_equals_the_jax_script(name):
    hyps, refs = CORPORA[name]
    assert bleu.corpus_bleu(hyps, refs) == jax_bleu.corpus_bleu(hyps, refs)


def test_tokenizer_equals_the_jax_script():
    cases = [h for h, _ in NATURAL] + [r for _, r in NATURAL] + [
        "dash-after-digit 7-8 but word-dash stays",
        "trailing dots... and {braces} [brackets] ~tilde~",
        "multi  spaces\tand\ttabs",
    ]
    for case in cases:
        assert bleu.tokenize_13a(case) == jax_bleu.tokenize_13a(case), case


def test_cli_equals_the_jax_script(tmp_path):
    hyp = tmp_path / "hyp.txt"
    ref = tmp_path / "ref.txt"
    hyp.write_text("hello world .\nsecond line here .\n")
    ref.write_text("hello world .\nsecond line there .\n")
    got = subprocess.run([sys.executable, "-m", "slimt_tpu_torch.bleu", str(hyp), str(ref)],
                         capture_output=True, text=True, check=True)
    want = subprocess.run([sys.executable, SCRIPT, str(hyp), str(ref)],
                          capture_output=True, text=True, check=True)
    assert json.loads(got.stdout) == json.loads(want.stdout)
