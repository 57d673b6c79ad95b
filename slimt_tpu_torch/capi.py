"""Object-table backend for the port's C embedding ABI
(slimt_tpu_torch/native/slimt_capi.cpp, built by
slimt_tpu_torch/ops/_capi_build.py into libslimt_torch_capi.so).

The reference ships native embedding surfaces — pybind11
(bindings/python/slimt.cpp:144-221) and JNI
(bindings/java/slimt.cpp) — that expose Model construction from a
Package of file paths plus a Service translate/pivot. This framework
is Python-native, so the equivalent embedding story is inverted: a
small C ABI (libslimt_torch_capi.so) embeds CPython and delegates to
this module. Any C/C++/JNI/FFI host links the .so and gets the same
surface the reference's JNI layer offered, without HTTP.

The C layer only ever passes ints and UTF-8 strings; objects live in
the table here, keyed by handle. All functions raise on error — the C
layer converts the exception to `slimt_last_error()`.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List

_objects: Dict[int, object] = {}
_next_id = 1
_lock = threading.Lock()


def _register(obj) -> int:
    global _next_id
    with _lock:
        handle = _next_id
        _next_id += 1
        _objects[handle] = obj
    return handle


def _get(handle: int):
    try:
        return _objects[handle]
    except KeyError:
        raise KeyError(f"unknown slimt handle {handle}")


def init() -> None:
    """Called once by slimt_init after the import; the port needs no
    set-up there (the models choose their device)."""


def service_create(workers: int, cache_size: int) -> int:
    """Async service facade, reference Service(workers, cache_size)
    (bindings/python/slimt.cpp:150-163)."""
    from slimt_tpu_torch.bindings import Service

    return _register(Service(workers=workers, cache_size=cache_size))


def model_create(spec_json: str) -> int:
    """Build a Model from a JSON spec mirroring the reference JNI
    Model.ncreate inputs (bindings/java/slimt.cpp: Config fields +
    Package paths):

    {"preset": "tiny",                       # or explicit config keys:
     "encoder_layers": 6, "decoder_layers": 2, "num_heads": 8,
     "split_mode": "sentence",
     "model": "/path/model.bin", "vocabulary": "/path/vocab.spm",
     "shortlist": null, "ssplit": null,
     "device": "cuda"}                       # optional; "cpu" on request

    The model runs on the card unless the spec names "cpu"; no card is
    an error.
    """
    import dataclasses

    from slimt_tpu_torch.config import preset
    from slimt_tpu_torch.models.model import Model, Package

    spec = json.loads(spec_json)
    config = getattr(preset, spec.get("preset", "tiny"))()
    overrides = {
        key: spec[key]
        for key in (
            "encoder_layers",
            "decoder_layers",
            "feed_forward_depth",
            "num_heads",
            "split_mode",
        )
        if key in spec
    }
    if overrides:
        config = dataclasses.replace(config, **overrides)
    package = Package(
        model=spec["model"],
        vocabulary=spec["vocabulary"],
        shortlist=spec.get("shortlist"),
        ssplit=spec.get("ssplit"),
    )
    return _register(Model(config, package, device=spec.get("device", "cuda")))


def translate(
    service: int,
    model: int,
    texts: List[str],
    html: bool = False,
    as_json: bool = False,
) -> List[str]:
    """Translate; returns target texts, or full Response JSON
    (bindings/python/utils.py to_json shape) when as_json — JSON
    responses always carry alignments, per the slimt_capi.h contract."""
    from slimt_tpu_torch.bindings import to_json

    responses = _get(service).translate(
        _get(model), texts, html=html, alignment=as_json or html
    )
    if as_json:
        return [to_json(r) for r in responses]
    return [r.target.text for r in responses]


def pivot(
    service: int,
    first: int,
    second: int,
    texts: List[str],
    html: bool = False,
    as_json: bool = False,
) -> List[str]:
    from slimt_tpu_torch.bindings import to_json

    responses = _get(service).pivot(
        _get(first), _get(second), texts, html=html
    )
    if as_json:
        return [to_json(r) for r in responses]
    return [r.target.text for r in responses]


def release(handle: int) -> None:
    with _lock:
        obj = _objects.pop(handle, None)
    if obj is not None and hasattr(obj, "close"):
        obj.close()


def shutdown() -> None:
    with _lock:
        handles = list(_objects)
    for handle in handles:
        release(handle)
