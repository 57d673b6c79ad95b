"""Build the model weight pytree from marian .bin items.

Mirrors the reference's parameter registration and load
(slimt/Transformer.cc:185-232, slimt/Modules.cc:336-406) but produces a
nested dict of numpy arrays (io/params.py carries it over to torch):

    params = {
      "emb":  {"q": int8 [V,E], "scale": f32[]},        # tied embedding
      "out":  {"aq": f32[], "b": f32 [V]},              # logit projection
      "encoder": [per-layer {
          "att": {"q"|"k"|"v"|"o": affine, "ln": ln},
          "ffn": {"w1": affine, "w2": affine, "ln": ln}}],
      "decoder": [per-layer {
          "rnn": {"w": linear, "wf": affine, "ln": ln},   # SSRU decoder
          "att": {...}, "ffn": {...}}],
    }

A self-attention decoder (marian's transformer, `decoder_l*_self_*`)
holds {"self": attention, "att": attention, "ffn": ffn} per layer in
place of the SSRU's "rnn"; load_weights reads which one a checkpoint
carries from its names, as marian's .bin carries it (and
transformer.decoder_kind from the params it made).
    affine = {"q": int8 [in,out], "bq": f32[], "aq": f32[], "b": f32 [out]}
    linear = affine without "b"
    ln     = {"scale": f32 [E], "bias": f32 [E]}

Quantization convention (slimt/QMM.hh:48-63, qmm/Gemmology.inl.cc):
`q = round(f32 * mult)`, `f32 = q / mult`; "aq" is the per-tensor
activation multiplier (`*_QuantMultA` items), "bq" the weight multiplier
stored as the trailing f32 of each intgemm8 payload.

The output projection reuses the transposed int8 embedding, with
`none_QuantMultA` as its activation multiplier (the reference's naming
quirk — slimt/Transformer.cc:104-117) and `decoder_ff_logit_out_b` bias.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from slimt_tpu_torch.config import ModelConfig
from slimt_tpu_torch.io.marian import Item, TYPE_FLOAT32, TYPE_INTGEMM8

log = logging.getLogger(__name__)


class MissingParameter(KeyError):
    pass


def _quantize(weights: np.ndarray) -> tuple:
    absmax = float(np.max(np.abs(weights))) or 1.0
    mult = 127.0 / absmax
    q = np.clip(np.rint(weights * mult), -127, 127).astype(np.int8)
    return q, np.float32(mult)


class _Items:
    def __init__(self, items: Sequence[Item]):
        self.by_name: Dict[str, Item] = {item.name: item for item in items}
        self.used = set()

    def take(self, name: str) -> Item:
        if name not in self.by_name:
            raise MissingParameter(name)
        self.used.add(name)
        return self.by_name[name]

    def matrix(self, name: str) -> dict:
        """int8 weight matrix + multiplier; quantizes f32 matrices."""
        item = self.take(name)
        if item.is_quantized:
            return {"q": item.array, "bq": np.float32(item.scale)}
        q, mult = _quantize(np.asarray(item.array, dtype=np.float32))
        return {"q": q, "bq": mult}

    def f32(self, name: str) -> np.ndarray:
        item = self.take(name)
        if item.is_quantized:
            # e.g. Wemb_QuantMultA is stored as a useless ig8 blob
            # (slimt/Io.cc:166-181); treat as absent.
            raise MissingParameter(name)
        return np.asarray(item.array, dtype=np.float32)

    def scalar(self, name: str) -> np.float32:
        return np.float32(self.f32(name).reshape(-1)[0])

    def vector(self, name: str) -> np.ndarray:
        return self.f32(name).reshape(-1)

    def unused(self) -> List[str]:
        return [n for n in self.by_name if n not in self.used]


def _affine(items: _Items, w: str, b: str, quant: str) -> dict:
    out = items.matrix(w)
    out["b"] = items.vector(b)
    out["aq"] = items.scalar(quant)
    return out


def _linear(items: _Items, w: str, quant: str) -> dict:
    out = items.matrix(w)
    out["aq"] = items.scalar(quant)
    return out


def _ln(items: _Items, prefix: str) -> dict:
    return {
        "scale": items.vector(prefix + "_ln_scale"),
        "bias": items.vector(prefix + "_ln_bias"),
    }


def _attention(items: _Items, prefix: str) -> dict:
    # prefix like "encoder_l1_self" or "decoder_l1_context"
    # (slimt/Modules.cc:336-372).
    att = {
        key: _affine(
            items,
            f"{prefix}_W{key}",
            f"{prefix}_b{key}",
            f"{prefix}_W{key}_QuantMultA",
        )
        for key in ("q", "k", "v", "o")
    }
    att["ln"] = _ln(items, f"{prefix}_Wo")
    return att


def _ffn(items: _Items, prefix: str) -> dict:
    # prefix like "encoder_l1" (slimt/Modules.cc:374-383).
    return {
        "w1": _affine(
            items, f"{prefix}_ffn_W1", f"{prefix}_ffn_b1",
            f"{prefix}_ffn_W1_QuantMultA",
        ),
        "w2": _affine(
            items, f"{prefix}_ffn_W2", f"{prefix}_ffn_b2",
            f"{prefix}_ffn_W2_QuantMultA",
        ),
        "ln": _ln(items, f"{prefix}_ffn_ffn"),
    }


# The decoder kinds, by the name of their first layer's first matrix.
SSRU, SELF_ATTENTION = "ssru", "self-attention"
DECODER_MARKERS = {SSRU: "decoder_l1_rnn_W", SELF_ATTENTION: "decoder_l1_self_Wq"}


def _kind_of_names(names) -> str:
    """The decoder kind of a checkpoint whose item names are `names`:
    "self-attention" where decoder_l1_self_Wq is among them, "ssru" where
    decoder_l1_rnn_W is. Both, or neither, raises ValueError naming what
    was found."""
    found = [kind for kind, marker in DECODER_MARKERS.items() if marker in names]
    if len(found) == 1:
        return found[0]
    markers = " and ".join(DECODER_MARKERS[kind] for kind in found)
    first = sorted(n for n in names if n.startswith("decoder_l1_"))[:6]
    raise ValueError(
        "cannot tell the decoder kind: the checkpoint holds "
        + (f"both {markers}" if found else
           f"neither {' nor '.join(DECODER_MARKERS.values())}; its decoder_l1_ items: {first}"))


def load_weights(items: Sequence[Item], config: ModelConfig) -> dict:
    """Assemble the params pytree; warns on unused items like the
    reference's load_parameters (slimt/Transformer.cc:216-225)."""
    if config.feed_forward_depth != 2:
        raise ValueError(
            "only feed_forward_depth=2 (W1/relu/W2) models are supported, "
            f"got {config.feed_forward_depth}"
        )
    pool = _Items(items)

    emb_item = pool.take("Wemb")
    if emb_item.is_quantized:
        emb = {"q": emb_item.array,
               "scale": np.float32(emb_item.scale)}
    else:
        q, mult = _quantize(np.asarray(emb_item.array, dtype=np.float32))
        emb = {"q": q, "scale": mult}

    # Output projection activation multiplier: none_QuantMultA when the
    # model was exported with a shortlist, Wemb_QuantMultA otherwise
    # (slimt/Transformer.cc:106-113).
    try:
        out_aq = pool.scalar("none_QuantMultA")
    except MissingParameter:
        out_aq = pool.scalar("Wemb_QuantMultA")
    # Mark the ig8 alias variant as consumed if present.
    if "Wemb_QuantMultA" in pool.by_name:
        pool.used.add("Wemb_QuantMultA")
    # A prepared "Wemb_intgemm8" from a re-serialized checkpoint would
    # also be redundant with emb["q"].
    if "Wemb_intgemm8" in pool.by_name:
        pool.used.add("Wemb_intgemm8")

    params = {
        "emb": emb,
        "out": {
            "aq": out_aq,
            "b": pool.vector("decoder_ff_logit_out_b"),
        },
        "encoder": [],
        "decoder": [],
    }

    for i in range(1, config.encoder_layers + 1):
        prefix = f"encoder_l{i}"
        params["encoder"].append(
            {
                "att": _attention(pool, f"{prefix}_self"),
                "ffn": _ffn(pool, prefix),
            }
        )

    self_attention = _kind_of_names(pool.by_name) == SELF_ATTENTION
    for i in range(1, config.decoder_layers + 1):
        prefix = f"decoder_l{i}"
        if self_attention:
            params["decoder"].append({
                "self": _attention(pool, f"{prefix}_self"),
                "att": _attention(pool, f"{prefix}_context"),
                "ffn": _ffn(pool, prefix),
            })
            continue
        rnn_prefix = f"{prefix}_rnn"
        params["decoder"].append(
            {
                "rnn": {
                    "w": _linear(
                        pool, f"{rnn_prefix}_W", f"{rnn_prefix}_W_QuantMultA"
                    ),
                    "wf": _affine(
                        pool,
                        f"{rnn_prefix}_Wf",
                        f"{rnn_prefix}_bf",
                        f"{rnn_prefix}_Wf_QuantMultA",
                    ),
                    "ln": _ln(pool, f"{rnn_prefix}_ffn"),
                },
                "att": _attention(pool, f"{prefix}_context"),
                "ffn": _ffn(pool, prefix),
            }
        )

    for name in pool.unused():
        log.warning("failed to ingest expected load of %s", name)
    return params


def model_dims(params: dict) -> tuple:
    """(vocab_size, emb_dim, ffn_dim) from a loaded pytree."""
    vocab, emb = params["emb"]["q"].shape
    encoder = params["encoder"]
    if isinstance(encoder, list):
        ffn = encoder[0]["ffn"]["w1"]["q"].shape[-1]
    else:  # stacked: leading layer axis
        ffn = encoder["ffn"]["w1"]["q"].shape[-1]
    return vocab, emb, ffn


def _stack(layers: List[dict]) -> dict:
    """Stack equal-shaped layer dicts leaf by leaf (numpy alone): each
    leaf gains a leading layer axis, a scalar scale becomes a float32 [L]
    array, as the JAX package's jax.tree.map over np.stack gives."""
    first = layers[0]
    if isinstance(first, dict):
        return {key: _stack([layer[key] for layer in layers]) for key in first}
    return np.stack(layers)


def _unstack(stacked, index: int):
    if isinstance(stacked, dict):
        return {key: _unstack(value, index) for key, value in stacked.items()}
    return stacked[index]


def _layer_count(stacked) -> int:
    while isinstance(stacked, dict):
        stacked = next(iter(stacked.values()))
    return stacked.shape[0]


def stack_layers(params: dict, decoder: bool = True) -> dict:
    """The per-layer lists as stacked pytrees (a leading layer axis): the
    layout of the native .npz checkpoint (io/checkpoint.py), which the JAX
    package scans over. `decoder=False` stacks only the encoder, as the
    JAX function does."""
    out = dict(params)
    out["encoder"] = _stack(params["encoder"])
    if decoder:
        out["decoder"] = _stack(params["decoder"])
    return out


def unstack_layers(params: dict) -> dict:
    """Inverse of stack_layers: stacked encoder and decoder back to
    per-layer lists (a list stays as it is). Indexing a float32 [L] scale
    gives an np.float32 scalar of the same bits, the type load_weights
    gives, so io/params.py's epilogue multipliers come out bit-equal."""
    out = dict(params)
    for key in ("encoder", "decoder"):
        stacked = params[key]
        if not isinstance(stacked, list):
            out[key] = [_unstack(stacked, i) for i in range(_layer_count(stacked))]
    return out
