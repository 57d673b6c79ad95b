"""Build and load the port's CUDA kernels (`ops/csrc/*.cu`).

One `nvcc -c` per source, all started together, then one link make
one shared library with a plain C interface, written to
`slimt_tpu_torch/build/` (git-ignored)
under a name that carries the hash of the sources and flags, so an
edit rebuilds and an unchanged tree reuses the library. The library is
loaded with ctypes; every pointer and the stream pass as c_void_p.

Nothing is built when a module is imported: the first kernel launch
calls `library()`. Build failures raise with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # x, w, bias, y, m, k, n, w_stride_k, w_stride_n, aq, inv, mode, stream
    "slimt_affine": (_P, _P, _P, _P, _I, _I, _I, _L, _L, _F, _F, _I, _P),
    # x, mask, out, q, k, v, att, weights[16], scales[12], b, t, e, f,
    # heads, att_scale, qkv_rows, post_rows, cs, stream
    "slimt_encoder_layer": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P
    ),
    # rows, cs, e: clusters of the encoder layer's post-attention kernel
    # the card holds at once (0: none)
    "slimt_encoder_clusters": (_I, _I, _I),
    # ptrs, scales, layers, b, t, e, f, heads, s, w_stride_k, w_stride_n,
    # rows, cs, cache, x, c_in, c_out, attn0, choice, scratch, stream
    "slimt_whole_decode_step": (
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _I, _I, _I,
        _P, _P, _P, _P, _P, _P, _P,
    ),
    # ptrs, scales, b, t, e, f, heads, rows, cs, cache, x, c_in, c_out,
    # attn0, y, stream
    "slimt_decoder_layer_step": (
        _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
    ),
    # rows, cs, e, f, heads, t: the rows a block of the step takes (0: none)
    "slimt_whole_step_rows": (_I, _I, _I, _I, _I, _I),
    # rows, cs, e, f, heads, t, cache: clusters of the layers kernel the
    # card holds at once (0: none)
    "slimt_step_clusters": (_I, _I, _I, _I, _I, _I, _I),
    # y, w, bias, choice, scratch, b, e, s, w_stride_k, w_stride_n, aq,
    # inv, mode, stream
    "slimt_argmax_affine": (
        _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _F, _F, _I, _P
    ),
    # y, w, b_i32, choice, scratch, b, e, s, w_stride_k, w_stride_n, aq,
    # width_bits, shift, stream
    "slimt_argmax_packed_int": (
        _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _F, _I, _I, _P
    ),
    # b, s: floats of scratch slimt_argmax_affine takes
    "slimt_argmax_scratch": (_I, _I),
    # x, c, wf, bf, w, ln_scale, ln_bias, h, c_out, m, e, rows, cs, aq_f,
    # inv_f, aq_w, inv_w, stream
    "slimt_ssru_block": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _P
    ),
    # rows, cs, e: clusters of the SSRU block the card holds at once
    "slimt_ssru_clusters": (_I, _I, _I),
    # x, w1, b1, w2, b2, ln_scale, ln_bias, out, m, e, f, rows, cs, aq1,
    # inv1, aq2, inv2, stream
    "slimt_ffn_block": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P
    ),
    # rows, cs, e, f: clusters of the FFN block the card holds at once
    "slimt_ffn_clusters": (_I, _I, _I, _I),
    # q, k, v, kqi, vqi, mask, out, b, t, e, heads, scale, kernel, stream
    "slimt_decode_attention": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P
    ),
    # q, k, v, kqi, vqi, valid, out, b, cap, e, heads, scale, stream
    "slimt_decode_self_attention": (
        _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P
    ),
    # q, k, v, mask, out, b, t, e, heads, scale, stream
    "slimt_fused_sdpa": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, mask, out, bh, heads, t, d, scale, stream
    "slimt_blockwise_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # q, k, v, mask, out, b, q_rows, q0, tq, t, e, heads, scale, stream
    "slimt_fused_sdpa_rows": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # q, k, v, mask, out, bh, heads, q_rows, q0, tq, t, d, scale, stream
    "slimt_blockwise_attention_rows": (
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P
    ),
    # y, w, bias, choice, keys, scratch, b, e, s, w_stride_k, w_stride_n,
    # col0, aq, inv, mode, stream
    "slimt_argmax_keys": (
        _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I, _F, _F, _I, _P
    ),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    sources = sorted(_CSRC.glob("*.cu"))
    headers = sorted(_CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return sources, digest.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the output of any failure."""
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True))
        for cmd in cmds
    ]
    failures = []
    for cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}"
            )
    if failures:
        raise RuntimeError("\n".join(failures))


def _build(sources, target: Path) -> None:
    """One `nvcc -c` per source, all started together, then one link."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{target.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in sources]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    _run_all([
        [_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources, objects)
    ])
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    _run_all([[_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]])
    for obj in objects:
        obj.unlink()
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            sources, digest = _sources()
            target = BUILD_DIR / f"libslimt_kernels_{digest}.so"
            if not target.exists():
                _build(sources, target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.slimt_error_string.argtypes = [ctypes.c_int]
            lib.slimt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (cudaGetLastError)."""
    if code != 0:
        message = lib.slimt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code}: {message}")
