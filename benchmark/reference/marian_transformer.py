"""Marian's transformer (`--task transformer-big` and its kin): everything
of the benchmark that depends on the architecture, found through a
configuration's `"reference"` key ("reference/marian_transformer.py"). It
supplies what reference/bergamot.py supplies for the Bergamot student:

- `Reference`: the plain PyTorch reference of the model (below);
- `layout(cfg)`, `EMBEDDING`, `activation_name(name)`: its arrays under
  marian's names, which inputs.make_weights draws;
- `planted(name, init)`: the decoder settings planted in those draws;
- `WORK`: the work counts of each phase (`encoder`, `decode`), and
  `SELF_ATTENTION`, the work of the decoder's self-attention reads alone
  (the valid-length decode-attention kernel's).

The encoder is the Bergamot student's (post-LayerNorm self-attention and
ReLU feed-forward layers over sinusoidal positions). Each decoder layer
runs three blocks, each followed by the residual and a LayerNorm, in
marian's order: causal self-attention over every target position up to
its own (`decoder_l{i}_self_*`), cross-attention over the encoder's output
(`decoder_l{i}_context_*`) and the feed-forward block (`decoder_l{i}_ffn_*`);
the output projection is tied to the embedding (Vaswani et al. 2017;
marian-nmt src/models/transformer.h). The decoder adds the sinusoid of
each step's own position ("decoder_position": "step", marian's rule), or
position 0 at every step ("zero").

The reference computes in float32 against the dequantized int8 weights,
teacher-forced over the served tokens, as Bergamot's does, and
`precision="int4"` is the same control. It imports neither JAX nor the
program.
"""

from __future__ import annotations

import torch

from benchmark.reference.bergamot import (  # noqa: F401 -- the shared names
    EMBEDDING,
    Bergamot,
    activation_name,
    encoder_work,
    layout as _encoder_layout,
    sinusoid,
)

MASKED = -1e9


class MarianTransformer(Bergamot):
    """The model on `device`: Bergamot's embedding, encoder, attention,
    feed-forward block and logits, and marian's transformer decoder."""

    def self_mask(self, s: int) -> torch.Tensor:
        """The additive mask [1, 1, S, S] of the decoder's self-attention:
        step i reads positions 0..i."""
        future = torch.ones((s, s), dtype=torch.bool, device=self.device).triu(1)
        return torch.where(future, MASKED, 0.0)[None, None].to(torch.float32)

    def decode(self, memory: torch.Tensor, mask_add: torch.Tensor,
               tgt: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder over tgt [B, S] (the tokens served):
        step s reads the embedding of tgt[:, s - 1] (zeros at s = 0) plus
        the sinusoid of position s (0 under "zero"). Returns the last
        layer's output [B, S, E]."""
        b, s = tgt.shape
        prev = self.embed(tgt[:, :-1])
        y = torch.cat([torch.zeros((b, 1, self.emb_dim), device=self.device), prev], dim=1)
        positions = torch.zeros(s, device=self.device) if self.position_zero else \
            torch.arange(s, device=self.device)
        y = y + sinusoid(positions, self.emb_dim)
        causal = self.self_mask(s)
        for i in range(1, self.cfg["decoder_layers"] + 1):
            prefix = f"decoder_l{i}"
            y = self.attention(prefix + "_self", y, y, causal)
            y = self.attention(prefix + "_context", y, memory, mask_add)
            y = self.ffn(y, prefix)
        return y


Reference = MarianTransformer


# -- the weights ------------------------------------------------------------


def layout(cfg: dict):
    """(matrices, vectors) under marian's names, as bergamot.layout gives
    them: the embedding, the logits' bias and the encoder layers as the
    Bergamot student's, then per decoder layer its self-attention, its
    cross-attention and its feed-forward block."""
    matrices, vectors = _encoder_layout(dict(cfg, decoder_layers=0))
    emb, ffn = cfg["emb_dim"], cfg["ffn_dim"]

    def affine(name, rows, cols, bias):
        matrices.append((name, rows, cols))
        vectors.append((bias, cols, "bias"))

    def norm(prefix):
        vectors.extend([(prefix + "_ln_scale", emb, "scale"), (prefix + "_ln_bias", emb, "shift")])

    for i in range(1, cfg["decoder_layers"] + 1):
        prefix = f"decoder_l{i}"
        for block in ("_self", "_context"):
            for key in "qkvo":
                affine(f"{prefix}{block}_W{key}", emb, emb, f"{prefix}{block}_b{key}")
            norm(prefix + block + "_Wo")
        affine(prefix + "_ffn_W1", emb, ffn, prefix + "_ffn_b1")
        affine(prefix + "_ffn_W2", ffn, emb, prefix + "_ffn_b2")
        norm(prefix + "_ffn_ffn")
    return matrices, vectors


# The decoder's planted gains: init key by the suffix of the matrix's name.
PLANTED_GAINS = {"_self_Wq": "self_query_gain", "_self_Wk": "self_key_gain",
                 "_context_Wo": "context_output_gain", "_ffn_W2": "ffn_output_gain"}


def planted(name: str, init: dict) -> tuple:
    """(gain, mean) of a matrix or vector of the decoder.

    At gain 1 every row of a seed decodes to one or two tokens: random
    attention layers average their positions (the encoder's output is
    nearly one vector for every position, and so is what the
    cross-attention adds at each layer), so the decoder's output hardly
    depends on its input, and one token of the tied table wins every
    step. Four gains on the decoder's matrices undo that:
    `self_query_gain` and `self_key_gain` sharpen the self-attention so
    that it picks earlier positions rather than averaging them,
    `context_output_gain` (below 1) weakens the cross-attention's nearly
    constant addition, and `ffn_output_gain` makes the feed-forward
    block's map of its input outweigh the residual. Each served token then
    depends on the tokens before it (a reference whose self-attention reads
    the current position alone puts other tokens first), and 71-99% of
    the steps repeat the token before (CPU, at E = 512), where the
    Bergamot student's planted SSRU decodes about 75%.

    The gains are kept small: 2 on Wq and Wk scales the scores by 4.
    Larger ones make the self-attention a hard choice of one position,
    which an int8 rounding of the program flips where the reference's
    float32 does not, and the flip carries through the later layers: at
    gains of 4 (scores x 16) and an FFN gain of 4 the program's widest
    logit gap against the reference read about 4 times wider (CPU, E =
    256 and 512) and 0.17-1.36 on an H100 at E = 1024."""
    if name.startswith("decoder_l"):
        for suffix, key in PLANTED_GAINS.items():
            if name.endswith(suffix):
                return init[key], 0.0
    return 1.0, 0.0


# -- the work counts ----------------------------------------------------------


def _self_positions(steps) -> int:
    """Positions the self-attention reads over a row's steps: step s reads
    s + 1 of them."""
    return int((steps * (steps + 1) // 2).sum())


def decode_work(cfg: dict, forwards, shortlist_width=None) -> dict:
    """Every decode step's work in a set of forwards, counted for the steps
    each row served (a row that is done needs no further step).

    - int8 products: per row and step, each decoder layer's self-attention
      Q, K, V and O (4 E^2), the cross-attention's Q and O (2 E^2) and the
      FFN (2 E F), and the output projection over the batch's columns
      (E x the vocabulary, or x the shortlist's width); two operations a
      multiply-add.
    - float32 attention: per row and step s, 4 (s + 1) E a decoder layer
      for the self-attention and 4 L E for the cross-attention over the
      row's source length L.
    - bytes: each step of a batch reads the decoder layers' weights and
      the projection's columns once (int8); per row and step s each layer
      reads s + 1 positions of its self-attention cache and writes one,
      and reads L of the cross-attention cache: int16 K and V, E columns
      each, with their f32 scales.
    """
    e, f, vocab = cfg["emb_dim"], cfg["ffn_dim"], cfg["vocab_size"]
    dec = cfg["decoder_layers"]
    layer_macs = dec * (6 * e * e + 2 * e * f)
    position = e * 2 * 2 + 2 * 4
    int8_ops = f32_ops = n_bytes = 0
    for forward in forwards:
        steps = forward.steps
        width = vocab if shortlist_width is None else shortlist_width(forward)
        row_steps = int(steps.sum())
        self_read = _self_positions(steps)
        cross_read = int((forward.lengths * steps).sum())
        int8_ops += 2 * (layer_macs + e * width) * row_steps
        f32_ops += dec * 4 * e * (self_read + cross_read)
        n_bytes += int(steps.max(initial=0)) * (layer_macs + e * width)
        n_bytes += dec * position * (self_read + row_steps + cross_read)
    return {"int8_ops": int8_ops, "f32_ops": f32_ops, "bytes": n_bytes}


def self_attention_work(cfg: dict, forwards) -> dict:
    """The decoder self-attention's reads alone, the valid-length kernel's
    work: per row, step s and decoder layer, 4 (s + 1) E float32
    operations over s + 1 cache positions (int16 K and V with their
    scales), the f32 query read and the output written (8 E bytes)."""
    e, dec = cfg["emb_dim"], cfg["decoder_layers"]
    position = e * 2 * 2 + 2 * 4
    f32_ops = n_bytes = 0
    for forward in forwards:
        self_read = _self_positions(forward.steps)
        f32_ops += dec * 4 * e * self_read
        n_bytes += dec * (position * self_read + 8 * e * int(forward.steps.sum()))
    return {"int8_ops": 0, "f32_ops": f32_ops, "bytes": n_bytes}


WORK = {"encoder": encoder_work, "decode": decode_work}
SELF_ATTENTION = self_attention_work
