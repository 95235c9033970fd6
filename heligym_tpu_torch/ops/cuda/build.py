"""Build the port's CUDA kernels from the sources in `csrc/`, at first use.

Each `csrc/<name>.cu` is compiled with `nvcc` into a shared library with a
plain C interface, `build/heligym_tpu_torch/<name>_<hash>.so` under the repo
root, and loaded with ctypes. The hash covers the source and the flags, so
an edited source is rebuilt and a stale library never loads. Several kernels
build in parallel: one `nvcc` per source, all started together.
`ptxas_summary` reads each kernel's registers and spills from the build's
log, `sass_counts` counts its load and store instructions in the built
library (`cuobjdump -sass`).
"""
from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, Iterable, Optional, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "heligym_tpu_torch")

# -fmad=false: no contracted FMAs (they drift the chaotic dynamics away from
# the plain version); no --use_fast_math (it breaks the x != x NaN test and
# the IEEE divisions and square roots the parity rests on).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

# library path -> nvcc's output of its build in this process ("" if the
# library was already built)
BUILD_LOG: Dict[str, str] = {}
_LIBS: Dict[tuple, object] = {}


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", name)):
            return os.path.join(root, "bin", name)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def _source(name: str, src: Optional[str]) -> str:
    return src or os.path.join(CSRC_DIR, name + ".cu")


def library_path(name: str, flags: Tuple[str, ...] = NVCC_FLAGS,
                 src: Optional[str] = None) -> str:
    with open(_source(name, src), "rb") as f:
        digest = hashlib.sha256(f.read() + repr(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}_{digest[:16]}.so")


def build(names: Iterable[str], flags: Tuple[str, ...] = NVCC_FLAGS,
          src: Optional[str] = None) -> None:
    """Compile every named kernel whose library is missing, in parallel
    (`src`: the source of a single named kernel, instead of csrc/)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = library_path(name, flags, src)
        if os.path.exists(path):
            BUILD_LOG.setdefault(path, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_tool("nvcc"), *flags, "-o", tmp, _source(name, src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)
        BUILD_LOG[path] = log


def load(name: str, flags: Tuple[str, ...] = NVCC_FLAGS, src: Optional[str] = None):
    """The ctypes library of kernel `name` built with `flags` (from `src`,
    by default csrc/<name>.cu), built first if needed."""
    lib = _LIBS.get((name, flags, src))
    if lib is None:
        import ctypes
        build([name], flags, src)
        lib = _LIBS[(name, flags, src)] = ctypes.CDLL(library_path(name, flags, src))
    return lib


def kernel_label(mangled: str) -> str:
    """A short name for a mangled kernel symbol: its last name component,
    with an integer or bool template argument (e.g. `fused_step_kernel<2>`)."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        size = int(mangled[i:j])
        name, i = mangled[j:j + size], j + size
    arg = re.match(r"IL[bi](\d+)E", mangled[i:])
    return name + (f"<{arg.group(1)}>" if arg else "")


def ptxas_summary(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel, from `nvcc -Xptxas -v` output: registers, stack bytes,
    spill store and load bytes."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)), {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


SASS_OPS = ("LDG", "LDC", "LDL", "STG", "STL", "SHFL")


def sass_counts(path: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of the built library at `path`, its SASS instructions
    ("instructions") and the count of each op in SASS_OPS (cuobjdump -sass)."""
    res = subprocess.run([_tool("cuobjdump"), "-sass", path], capture_output=True,
                         text=True, check=True)
    out, cur = {}, None
    pat = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(kernel_label(m.group(1)),
                                 {"instructions": 0, **dict.fromkeys(SASS_OPS, 0)})
            continue
        if cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            cur["instructions"] += 1
            for op in pat.findall(line):
                cur[op] += 1
    return out
