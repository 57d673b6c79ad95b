"""Build the port's C embedding ABI (`native/slimt_capi.cpp`).

One `g++` call, with the Python headers from `python3-config --includes`
and libpython from sysconfig (as the JAX package's native/Makefile
builds its libslimt_capi.so), makes `libslimt_torch_capi.so` in
`slimt_tpu_torch/build/` (git-ignored), under a name that carries the
hash of the sources, the flags and the Python build, so an edit
rebuilds and an unchanged tree reuses the library. Nothing is built
when a module is imported: `library_path()` builds on first use.
Build failures raise with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

from slimt_tpu_torch.ops._build import BUILD_DIR

NATIVE = Path(__file__).resolve().parents[1] / "native"
SOURCE = NATIVE / "slimt_capi.cpp"
HEADER = NATIVE / "slimt_capi.h"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_lock = threading.Lock()


def _python_flags() -> list:
    """Compile and link flags of the running Python: `python3-config
    --includes`, then -L/-rpath/-l of its libpython and -ldl."""
    config = shutil.which("python3-config")
    if config is None:
        raise RuntimeError("python3-config not found: the C ABI cannot be built")
    includes = subprocess.run(
        [config, "--includes"], capture_output=True, text=True, check=True
    ).stdout.split()
    libdir = sysconfig.get_config_var("LIBDIR")
    return [*includes, f"-L{libdir}", f"-Wl,-rpath,{libdir}",
            f"-lpython{sysconfig.get_config_var('LDVERSION')}", "-ldl"]


def library_path() -> Path:
    """The path of libslimt_torch_capi.so, built on first use."""
    with _lock:
        flags = [*CXX_FLAGS, *_python_flags()]
        digest = hashlib.sha256(" ".join(flags).encode())
        for path in (SOURCE, HEADER):
            digest.update(path.read_bytes())
        target = BUILD_DIR / f"libslimt_torch_capi_{digest.hexdigest()[:16]}.so"
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            cmd = ["g++", f"-I{NATIVE}", "-o", str(tmp), str(SOURCE), *flags]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, target)
        return target
