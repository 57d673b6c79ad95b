"""The kernel wrappers' launch counters.

Each wrapper keeps its count in its own `launches` attribute and adds to
it through `count` where it launches its kernel. Updates take one lock,
since several threads launch (a Model's dispatch worker, a pivot pair's
two). While a thread captures a CUDA graph (`tallied`), its launches
record nothing on the card: they go to that thread's tally, not to the
counters, and each replay of the graph adds the tally (`add`). Other
threads count as usual meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict

_lock = threading.Lock()
_local = threading.local()


def count(wrapper) -> None:
    """One launch of `wrapper`'s kernel: added to `wrapper.launches`, or to
    the calling thread's tally while it captures."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
        return
    with _lock:
        wrapper.launches += 1


def add(tally: Dict[object, int]) -> None:
    """The launches of `tally` (wrapper: n) added to the counters at once."""
    with _lock:
        for wrapper, n in tally.items():
            wrapper.launches += n


@contextlib.contextmanager
def tallied():
    """Within the block, this thread's launches go to the yielded dict
    (wrapper: n) in place of the counters."""
    if getattr(_local, "tally", None) is not None:
        raise RuntimeError("a launch tally is already open on this thread")
    _local.tally = {}
    try:
        yield _local.tally
    finally:
        _local.tally = None


# The serving paths' kernel wrappers, by the names of the smoke's kernels
# record: (module of slimt_tpu_torch.ops, attribute).
SERVING = {
    "qmm_affine": ("qmm", "affine_kernel"),
    "encoder_layer": ("encoder_layer", "layer_kernel"),
    "whole_decode_step": ("decoder_step", "whole_step_kernel"),
    "ssru_block": ("fused_blocks", "ssru_kernel"),
    "ffn_block": ("fused_blocks", "ffn_kernel"),
    "decode_attention": ("decode_attn", "decode_attention_kernel"),
    "decode_self_attention": ("decode_attn", "decode_self_attention_kernel"),
    "argmax_affine": ("logits_argmax", "argmax_affine_kernel"),
    "argmax_packed_int": ("logits_argmax", "argmax_packed_int_kernel"),
    "fused_sdpa": ("attention", "fused_sdpa_kernel"),
    "blockwise_attention": ("attention", "blockwise_kernel"),
}


def serving_wrappers() -> Dict[str, object]:
    """SERVING's wrappers by name (importing a wrapper's module builds
    nothing)."""
    import importlib

    return {name: getattr(importlib.import_module(f"slimt_tpu_torch.ops.{module}"), attr)
            for name, (module, attr) in SERVING.items()}


def snapshot() -> Dict[str, int]:
    """Each serving kernel's launches in this process so far."""
    wrappers = serving_wrappers()
    with _lock:
        return {name: w.launches for name, w in wrappers.items()}


def reset() -> None:
    """Set every serving kernel's count to 0."""
    wrappers = serving_wrappers()
    with _lock:
        for wrapper in wrappers.values():
            wrapper.launches = 0
