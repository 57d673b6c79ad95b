"""Build the port's host-side native code (`slimt_tpu_torch/native/`).

Each artifact is one `g++` call into `slimt_tpu_torch/build/`
(git-ignored), under a name that carries the hash of its sources, the
headers it includes and its flags, so an edit rebuilds and an unchanged
tree reuses it. Nothing is built when a module is imported: each
`*_path()` builds on first use, and a failed build raises with the
compiler's output. Nothing here reads or writes the JAX package's
top-level `native/` directory.

- `host_library_path()`: libslimt_torch_host (slimt_host.cpp), the
  tokenizer, ingest and hashing hot paths that `slimt_tpu_torch.native`
  loads;
- `jni_library_path()`: libslimt_torch_jni (slimt_jni.cpp), linked to
  the C ABI (`_capi_build.library_path()`) beside it by an rpath of
  $ORIGIN;
- `jni_host_path()`: the fake-JVM host (jni_host.cpp) that drives a JNI
  library the way a JVM does.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Sequence

from slimt_tpu_torch.ops._build import BUILD_DIR

NATIVE = Path(__file__).resolve().parents[1] / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")

_lock = threading.Lock()


def build(stem: str, suffix: str, sources: Sequence[Path], depends: Sequence[Path] = (),
          flags: Sequence[str] = ()) -> Path:
    """BUILD_DIR/<stem>_<hash><suffix>, compiled and linked by one g++
    call from `sources` (with -I slimt_tpu_torch/native/) on first use."""
    flags = list(flags)
    digest = hashlib.sha256(" ".join(flags).encode())
    for path in (*sources, *depends):
        digest.update(Path(path).read_bytes())
    target = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}{suffix}"
    with _lock:
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = ["g++", f"-I{NATIVE}", "-o", str(tmp), *map(str, sources), *flags]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
    return target


def host_library_path() -> Path:
    """The path of libslimt_torch_host.so, built on first use."""
    return build("libslimt_torch_host", ".so", [NATIVE / "slimt_host.cpp"],
                 flags=[*CXX_FLAGS, "-shared"])


def jni_library_path() -> Path:
    """The path of libslimt_torch_jni.so, built on first use (and the C
    ABI it links, which it finds beside itself)."""
    from slimt_tpu_torch.ops._capi_build import library_path

    capi = library_path()
    return build("libslimt_torch_jni", ".so", [NATIVE / "slimt_jni.cpp"],
                 [NATIVE / "slimt_capi.h", NATIVE / "jni_compat.h"],
                 [*CXX_FLAGS, "-shared", f"-L{capi.parent}", f"-l:{capi.name}",
                  "-Wl,-rpath,$ORIGIN"])


def jni_host_path() -> Path:
    """The path of the fake-JVM host, built on first use."""
    return build("slimt_torch_jni_host", "", [NATIVE / "jni_host.cpp"],
                 [NATIVE / "jni_compat.h"], [*CXX_FLAGS, "-ldl"])
