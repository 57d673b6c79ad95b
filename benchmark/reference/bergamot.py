"""The Bergamot student's architecture: everything of the benchmark that
depends on it, found through a configuration's `"reference"` key
("reference/bergamot.py"). It supplies

- `Reference`: the plain PyTorch reference of the model (below);
- `layout(cfg)`, `EMBEDDING`, `activation_name(name)`: its arrays under
  marian's names, which inputs.make_weights draws;
- `planted(name, init)`: the decoder settings planted in those draws;
- `WORK`: the work counts of each phase (`encoder`, `decode`), which the
  phase files in `work/` and the roofline and mfu readers use.

The model is a marian transformer encoder (post-LayerNorm layers of
multi-head self-attention and a ReLU feed-forward block over sinusoidal
positions) and a decoder of SSRU layers (simpler simple recurrent units)
with cross-attention and a feed-forward block, the output projection tied
to the embedding (Kim et al., "From Research to Production and Back", WNGT
2019; slimt's Transformer.cc and Modules.cc). The decoder adds the
position-0 sinusoid at every step where the configuration says
"decoder_position": "zero", as slimt does.

The reference computes everything in float32 against the weights
dequantized from the int8 matrices the benchmark made (w = q / multiplier),
with no activation quantization, no caches and no batching tricks: the
decoder is run teacher-forced over the tokens the program served.
`precision="int4"` is the control: every matrix re-quantized per tensor to
4 bits and every product's input quantized to 4 bits over the same range
as the model's 8-bit activation multiplier.

It imports neither JAX nor the program.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

LN_EPS = 1e-6  # marian's LayerNorm epsilon
INT4 = 7.0
EMBEDDING = "Wemb"  # the tied embedding and output projection, [vocabulary, emb]


def activation_name(name: str) -> str:
    """The name of a matrix's activation multiplier (marian's QuantMultA):
    the tied projection's is "none_QuantMultA"."""
    return "none_QuantMultA" if name == EMBEDDING else name + "_QuantMultA"


def sinusoid(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """marian's position signal: sin in the first half, cos in the second,
    timescales from 1 to 10000."""
    half = dim // 2
    rates = torch.exp(torch.arange(half, dtype=torch.float32, device=positions.device)
                      * (-math.log(10000.0) / (half - 1)))
    angles = positions.to(torch.float32)[:, None] * rates[None, :]
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def layer_norm(x: torch.Tensor, gain: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * gain + shift


class Bergamot:
    """The model on `device`; see the module docstring."""

    def __init__(self, weights, cfg: dict, device, precision: str = "float32"):
        if precision not in ("float32", "int4"):
            raise ValueError(f"precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(device)
        self.cfg = cfg
        self.heads = cfg["num_heads"]
        self.emb_dim = cfg["emb_dim"]
        self.int4 = precision == "int4"
        self.position_zero = cfg["decoder_position"] == "zero"
        self.w: Dict[str, torch.Tensor] = {}
        self.act: Dict[str, float] = {}
        for name, (q, mult) in weights.int8.items():
            w = torch.from_numpy(np.asarray(q)).to(self.device, torch.float32) / float(mult)
            if self.int4:
                scale = INT4 / w.abs().amax()
                w = torch.clamp(torch.round(w * scale), -INT4, INT4) / scale
            self.w[name] = w
            self.act[name] = float(np.asarray(weights.f32[activation_name(name)]).reshape(-1)[0])
        self.v = {name: torch.from_numpy(np.asarray(a).reshape(-1)).to(self.device, torch.float32)
                  for name, a in weights.f32.items()}

    @property
    def vocab_size(self) -> int:
        return self.w[EMBEDDING].shape[0]

    # -- pieces ------------------------------------------------------------

    def _input(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """A product's input: as it is, or under the control quantized to
        4 bits over the range of the model's activation multiplier."""
        if not self.int4:
            return x
        scale = self.act[name] * INT4 / 127.0
        return torch.clamp(torch.round(x * scale), -INT4, INT4) / scale

    def affine(self, x: torch.Tensor, name: str, bias: Optional[str]) -> torch.Tensor:
        y = self._input(x, name) @ self.w[name]
        return y if bias is None else y + self.v[bias]

    def norm(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        return layer_norm(x, self.v[prefix + "_ln_scale"], self.v[prefix + "_ln_bias"])

    def attention(self, prefix: str, query: torch.Tensor, memory: torch.Tensor,
                  mask_add: torch.Tensor) -> torch.Tensor:
        """Multi-head attention of `query` [B, S, E] over `memory` [B, T, E]
        with the residual and the post-LayerNorm; mask_add [B, 1, 1, T]."""
        b, s, e = query.shape
        t = memory.shape[1]
        d = e // self.heads

        def heads(x, n):
            return x.reshape(b, n, self.heads, d).transpose(1, 2)

        q = heads(self.affine(query, prefix + "_Wq", prefix + "_bq"), s)
        k = heads(self.affine(memory, prefix + "_Wk", prefix + "_bk"), t)
        v = heads(self.affine(memory, prefix + "_Wv", prefix + "_bv"), t)
        scores = q @ k.transpose(-1, -2) / math.sqrt(d) + mask_add
        context = torch.softmax(scores, dim=-1) @ v
        context = context.transpose(1, 2).reshape(b, s, e)
        out = self.affine(context, prefix + "_Wo", prefix + "_bo")
        return self.norm(query + out, prefix + "_Wo")

    def ffn(self, x: torch.Tensor, prefix: str) -> torch.Tensor:
        hidden = torch.relu(self.affine(x, prefix + "_ffn_W1", prefix + "_ffn_b1"))
        return self.norm(x + self.affine(hidden, prefix + "_ffn_W2", prefix + "_ffn_b2"),
                         prefix + "_ffn_ffn")

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w["Wemb"][ids] * math.sqrt(self.emb_dim)

    # -- the model ----------------------------------------------------------

    def encode(self, src: torch.Tensor, mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """src [B, T] ids, mask [B, T] bool → (encoder output, mask_add)."""
        t = src.shape[1]
        x = self.embed(src) + sinusoid(torch.arange(t, device=self.device), self.emb_dim)
        mask_add = torch.where(mask, 0.0, -1e9)[:, None, None, :].to(torch.float32)
        for i in range(1, self.cfg["encoder_layers"] + 1):
            x = self.attention(f"encoder_l{i}_self", x, x, mask_add)
            x = self.ffn(x, f"encoder_l{i}")
        return x, mask_add

    def decode(self, memory: torch.Tensor, mask_add: torch.Tensor,
               tgt: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder over tgt [B, S] (the tokens served):
        step s reads the embedding of tgt[:, s - 1] (zeros at s = 0).
        Returns the last layer's output [B, S, E]."""
        b, s = tgt.shape
        prev = self.embed(tgt[:, :-1])
        y = torch.cat([torch.zeros_like(prev[:, :1]), prev], dim=1) if s > 1 else \
            torch.zeros((b, 1, self.emb_dim), device=self.device)
        positions = torch.zeros(s, device=self.device) if self.position_zero else \
            torch.arange(s, device=self.device)
        y = y + sinusoid(positions, self.emb_dim)
        for i in range(1, self.cfg["decoder_layers"] + 1):
            prefix = f"decoder_l{i}"
            forget = torch.sigmoid(self.affine(y, prefix + "_rnn_Wf", prefix + "_rnn_bf"))
            candidate = self.affine(y, prefix + "_rnn_W", None)
            cell = torch.zeros_like(candidate[:, 0])
            cells = []
            for step in range(s):
                cell = forget[:, step] * cell + (1.0 - forget[:, step]) * candidate[:, step]
                cells.append(cell)
            h = self.norm(y + torch.relu(torch.stack(cells, dim=1)), prefix + "_rnn_ffn")
            a = self.attention(prefix + "_context", h, memory, mask_add)
            y = self.ffn(a, prefix)
        return y

    def logits(self, y: torch.Tensor, columns: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The tied projection y @ Wemb^T + b over `columns` (all if None)."""
        table, bias = self.w["Wemb"], self.v["decoder_ff_logit_out_b"]
        if columns is not None:
            table, bias = table[columns], bias[columns]
        return self._input(y, "Wemb") @ table.T + bias


Reference = Bergamot


# -- the weights ------------------------------------------------------------


def layout(cfg: dict) -> Tuple[list, list]:
    """(matrices, vectors) of a Bergamot student under marian's names:
    matrices as (name, rows, cols), vectors as (name, length, kind) with
    kind "bias", "scale" (LayerNorm gain) or "shift" (LayerNorm bias)."""
    emb, ffn, vocab = cfg["emb_dim"], cfg["ffn_dim"], cfg["vocab_size"]
    matrices, vectors = [("Wemb", vocab, emb)], [("decoder_ff_logit_out_b", vocab, "bias")]

    def affine(name, rows, cols, bias):
        matrices.append((name, rows, cols))
        if bias is not None:
            vectors.append((bias, cols, "bias"))

    def norm(prefix):
        vectors.extend([(prefix + "_ln_scale", emb, "scale"), (prefix + "_ln_bias", emb, "shift")])

    def attention(prefix):
        for key in "qkvo":
            affine(f"{prefix}_W{key}", emb, emb, f"{prefix}_b{key}")
        norm(prefix + "_Wo")

    def ffn_block(prefix):
        affine(prefix + "_ffn_W1", emb, ffn, prefix + "_ffn_b1")
        affine(prefix + "_ffn_W2", ffn, emb, prefix + "_ffn_b2")
        norm(prefix + "_ffn_ffn")

    for i in range(1, cfg["encoder_layers"] + 1):
        attention(f"encoder_l{i}_self")
        ffn_block(f"encoder_l{i}")
    for i in range(1, cfg["decoder_layers"] + 1):
        prefix = f"decoder_l{i}"
        attention(prefix + "_context")
        affine(prefix + "_rnn_W", emb, emb, None)
        affine(prefix + "_rnn_Wf", emb, emb, prefix + "_rnn_bf")
        norm(prefix + "_rnn_ffn")
        ffn_block(prefix)
    return matrices, vectors


def planted(name: str, init: dict) -> tuple:
    """(gain, mean) of a matrix or vector of the decoder's SSRU layers.

    At gain 1 every row decodes to one repeated token: the residual path
    carries the previous token's embedding to the tied projection, which
    picks it again, and the SSRU cell cannot change that. The candidate
    matrix W at `ssru_candidate_gain` makes relu(cell) outweigh the
    residual, and the forget gate's bias `ssru_forget_bias` keeps more of
    the cell a step, so that each served token depends on the token
    before it and on the cell carried through the steps."""
    if name.endswith("_rnn_W"):
        return init["ssru_candidate_gain"], 0.0
    if name.endswith("_rnn_bf"):
        return 1.0, init["ssru_forget_bias"]
    return 1.0, 0.0


# -- the work counts ----------------------------------------------------------


def encoder_work(cfg: dict, forwards, shortlist_width=None) -> dict:
    """The encoder phase's work in a set of forwards: the embedding, every
    encoder layer and the decoder layers' cross-attention K/V cache, counted
    for the tokens each row really holds (padding is waste, not work).

    - int8 products: per token, Q, K, V, O (4 E^2) and the FFN (2 E F) of
      each encoder layer and the cross K and V (2 E^2) of each decoder layer;
      two operations a multiply-add.
    - float32 attention: per row of length L, Q K^T and the weighted sum of
      V, 4 L^2 E operations a layer.
    - bytes: each weight once a forward, the embedding row of each token
      (int8), and the int16 cross K/V cache written.
    """
    e, f = cfg["emb_dim"], cfg["ffn_dim"]
    enc, dec = cfg["encoder_layers"], cfg["decoder_layers"]
    per_token_macs = enc * (4 * e * e + 2 * e * f) + dec * 2 * e * e
    weight_bytes = enc * (4 * e * e + 2 * e * f) + dec * 2 * e * e
    int8_ops = f32_ops = n_bytes = 0
    for forward in forwards:
        tokens = forward.real_tokens
        int8_ops += 2 * per_token_macs * tokens
        f32_ops += enc * 4 * e * int((forward.lengths ** 2).sum())
        n_bytes += weight_bytes + tokens * e + dec * 2 * tokens * e * 2
    return {"int8_ops": int8_ops, "f32_ops": f32_ops, "bytes": n_bytes}


def decode_work(cfg: dict, forwards, shortlist_width=None) -> dict:
    """Every decode step's work in a set of forwards, counted for the steps
    each row served (a row that is done needs no further step).

    - int8 products: per row and step, each decoder layer's SSRU (W and Wf,
      2 E^2), the cross-attention's Q and O (2 E^2) and the FFN (2 E F), and
      the output projection over the batch's columns (E x the vocabulary, or
      x the shortlist's width); two operations a multiply-add.
    - float32 attention: per row and step, 4 L E a decoder layer over the
      row's source length L.
    - bytes: each step of a batch reads the decoder layers' weights and the
      projection's columns once (int8), and each row's int16 cross K/V.
    """
    e, f, vocab = cfg["emb_dim"], cfg["ffn_dim"], cfg["vocab_size"]
    dec = cfg["decoder_layers"]
    layer_macs = dec * (4 * e * e + 2 * e * f)
    int8_ops = f32_ops = n_bytes = 0
    for forward in forwards:
        steps = forward.steps
        width = vocab if shortlist_width is None else shortlist_width(forward)
        row_steps = int(steps.sum())
        int8_ops += 2 * (layer_macs + e * width) * row_steps
        f32_ops += dec * 4 * e * int((forward.lengths * steps).sum())
        n_bytes += int(steps.max(initial=0)) * (layer_macs + e * width)
        n_bytes += dec * 2 * e * 2 * int((forward.lengths * steps).sum())
    return {"int8_ops": int8_ops, "f32_ops": f32_ops, "bytes": n_bytes}


WORK = {"encoder": encoder_work, "decode": decode_work}
