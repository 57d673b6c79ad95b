"""The native checkpoint format, as the JAX package writes and reads it.

The reference's only model format is the marian v1 binary; the native
format is the loaded, layer-stacked weight pytree (io/loader.stack_layers)
saved as a single .npz: pre-quantized, loads with no parameter-name
matching. The port reads and writes the same files as the JAX package's
io/checkpoint.py, so each package serves the other's checkpoints.

Format: numpy .npz where keys are "/"-joined pytree paths
("encoder/att/q/q", list indices never appear since layers are
stacked), plus a "__meta__" JSON array carrying model dims/config.
Detected by the "PK" zip magic vs marian's u64 version header.
"""

from __future__ import annotations

import io as _io
import json
from typing import Dict, Optional, Tuple

import numpy as np

META_KEY = "__meta__"


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flatten(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_native(file, params: dict, meta: Optional[dict] = None) -> None:
    """Serialize a *stacked* params pytree (loader.stack_layers)."""
    if isinstance(params.get("encoder"), list):
        raise ValueError("save_native expects stacked layers")
    flat = _flatten(params)
    flat[META_KEY] = np.frombuffer(
        json.dumps(meta or {}).encode("utf-8"), dtype=np.uint8
    )
    np.savez(file, **flat)


def load_native(file) -> Tuple[dict, dict]:
    """Returns (stacked params pytree, metadata dict)."""
    data = np.load(file, allow_pickle=False)
    flat = {}
    meta = {}
    for key in data.files:
        if key == META_KEY:
            meta = json.loads(bytes(data[key]).decode("utf-8"))
        else:
            flat[key] = data[key]
    return _unflatten(flat), meta


def is_native(blob: bytes) -> bool:
    return blob[:2] == b"PK"  # zip magic (npz); marian starts with u64 1


def convert_marian(model_bytes: bytes, config) -> bytes:
    """marian .bin → native checkpoint bytes."""
    from slimt_tpu_torch.io.loader import load_weights, model_dims, stack_layers
    from slimt_tpu_torch.io.marian import load_items

    params = load_weights(load_items(model_bytes), config)
    vocab, emb, ffn = model_dims(params)
    stacked = stack_layers(params)
    buffer = _io.BytesIO()
    save_native(
        buffer,
        stacked,
        meta={
            "vocab_size": vocab,
            "emb_dim": emb,
            "ffn_dim": ffn,
            "encoder_layers": config.encoder_layers,
            "decoder_layers": config.decoder_layers,
            "num_heads": config.num_heads,
        },
    )
    return buffer.getvalue()
