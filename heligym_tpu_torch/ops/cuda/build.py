"""Build the port's CUDA kernels from the sources in `csrc/`, at first use.

Each `csrc/<name>.cu` is compiled with `nvcc` into a shared library with a
plain C interface, `build/heligym_tpu_torch/<name>_<hash>.so` under the repo
root, and loaded with ctypes. The hash covers the source and the flags, so
an edited source is rebuilt and a stale library never loads. Several kernels
build in parallel: one `nvcc` per source, all started together.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "heligym_tpu_torch")

# -fmad=false: no contracted FMAs (they drift the chaotic dynamics away from
# the plain version); no --use_fast_math (it breaks the x != x NaN test and
# the IEEE divisions and square roots the parity rests on).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# name -> nvcc's output of the last build in this process ("" if the library
# was already built)
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[tuple, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, flags: Tuple[str, ...] = NVCC_FLAGS) -> str:
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}_{digest[:16]}.so")


def build(names: Iterable[str], flags: Tuple[str, ...] = NVCC_FLAGS) -> None:
    """Compile every named kernel whose library is missing, in parallel."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name, flags)
        if os.path.exists(path):
            BUILD_LOG.setdefault(name, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)
        BUILD_LOG[name] = log


def load(name: str, flags: Tuple[str, ...] = NVCC_FLAGS):
    """The ctypes library of kernel `name` built with `flags`, built first if
    needed."""
    lib = _LIBS.get((name, flags))
    if lib is None:
        import ctypes
        build([name], flags)
        lib = _LIBS[(name, flags)] = ctypes.CDLL(library_path(name, flags))
    return lib
