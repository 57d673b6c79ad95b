"""Build the port's C embedding ABI (`slimt_tpu_torch/native/slimt_capi.cpp`).

One `g++` call, with the Python headers from `python3-config --includes`
and libpython from sysconfig (as the JAX package's native/Makefile
builds its libslimt_capi.so), makes `libslimt_torch_capi.so` in
`slimt_tpu_torch/build/` (git-ignored) by `_native_build.build`, under a
name that carries the hash of the sources, the flags and the Python
build, so an edit rebuilds and an unchanged tree reuses the library.
Nothing is built when a module is imported: `library_path()` builds on
first use. Build failures raise with the compiler's output.
"""

from __future__ import annotations

import shutil
import subprocess
import sysconfig
from pathlib import Path

from slimt_tpu_torch.ops._native_build import CXX_FLAGS, NATIVE, build

SOURCE = NATIVE / "slimt_capi.cpp"
HEADER = NATIVE / "slimt_capi.h"


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
    return build("libslimt_torch_capi", ".so", [SOURCE], [HEADER],
                 [*CXX_FLAGS, "-shared", *_python_flags()])
