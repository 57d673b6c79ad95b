"""Detect the JAX package's native checkpoint format.

That format is a numpy .npz of the layer-stacked weight pytree,
detected by the "PK" zip magic vs marian's u64 version header. The
port loads marian .bin models only, so it needs nothing but the test.
"""

from __future__ import annotations


def is_native(blob: bytes) -> bool:
    return blob[:2] == b"PK"  # zip magic (npz); marian starts with u64 1
