"""Builds the package's CUDA kernels and loads them through ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for sm_90a into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), once per set of ``-D`` defines it is asked for (the path kernel
is built once per color mode, the volumetric kernel once). Libraries go into
``mitsuba2_tpu_torch/_build/``, named by the defines and a hash of every
source in ``csrc/``, the flags and the defines, and are built at first
use, or all at once in parallel nvcc processes with ``build_all``; each
build's compiler output (ptxas -v: registers, spills) is kept beside its
library as ``<library>.log``. A missing nvcc or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# ptxas -v reports registers, shared memory and spills on stderr
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# host libraries: the flags mitsuba2_tpu/ops/bvh.py builds the reference's
# copy of the BVH builder with, so the two give the same floats
CXX_FLAGS = ("-O2", "-fPIC", "-shared")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# compiler output of each build made in this process, by library name
# (kernel name and defines, e.g. "path_kernel-pk_nc4")
build_logs: dict[str, str] = {}


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix; None if there is none."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(Path(home) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    return None


def find_cxx() -> str | None:
    """The host C++ compiler: g++ (the reference builds its copy with
    it), else $CXX, else c++ on $PATH."""
    for c in ("g++", os.environ.get("CXX"), "c++"):
        path = c and shutil.which(c)
        if path:
            return path
    return None


def _is_host(name: str) -> bool:
    return (CSRC / f"{name}.cpp").is_file()


def _tag(defines) -> str:
    return "".join(f"-{k.lower()}{v}" for k, v in sorted(defines.items()))


def library_path(name: str, defines=None) -> Path:
    """Where the build of ``csrc/<name>.cu`` with ``defines`` ({macro:
    value}) for the current sources lives."""
    defines = defines or {}
    host = _is_host(name)
    h = hashlib.sha256(" ".join(CXX_FLAGS if host else NVCC_FLAGS).encode())
    h.update(repr(sorted(defines.items())).encode())
    for p in ([CSRC / f"{name}.cpp"] if host
              else sorted(CSRC.glob("*.cu*"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}{_tag(defines)}-{h.hexdigest()[:16]}.so"


def _start(name: str, defines):
    """Start the compiler for one library -> (output path, temp path,
    command, process), or None if the library exists already."""
    out = library_path(name, defines)
    if out.exists():
        return None
    if _is_host(name):
        compiler, flags, src = find_cxx(), CXX_FLAGS, CSRC / f"{name}.cpp"
        if compiler is None:
            raise RuntimeError("no C++ compiler: set CXX or put g++ on PATH "
                               f"to build {src.name}")
    else:
        compiler, flags, src = find_nvcc(), NVCC_FLAGS, CSRC / f"{name}.cu"
        if compiler is None:
            raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc "
                               "on PATH to build the CUDA kernels")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags,
           *(f"-D{k}={v}" for k, v in sorted((defines or {}).items())),
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return out, tmp, cmd, proc


def _finish(name: str, defines, started) -> Path:
    out, tmp, cmd, proc = started
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{stdout}{stderr}")
    log = stdout + stderr
    build_logs[name + _tag(defines or {})] = log
    # the compiler's report (ptxas -v) beside the library
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def build(name: str, defines=None) -> Path:
    """Compile ``csrc/<name>.cu`` with ``defines`` unless its library
    exists already."""
    started = _start(name, defines)
    if started is None:
        return library_path(name, defines)
    return _finish(name, defines, started)


def build_all(jobs) -> None:
    """Compile each (name, defines) library of ``jobs``, all nvcc
    processes at once; every process is waited for, and the first failure
    raises after that."""
    with _LOCK:
        started = []
        try:
            for name, d in jobs:
                started.append((name, d, _start(name, d)))
        finally:
            errors = []
            for name, d, st in started:
                if st is None:
                    continue
                try:
                    _finish(name, d, st)
                except RuntimeError as e:
                    errors.append(e)
        if errors:
            raise errors[0]


def load(name: str, defines=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (or ``.cpp``) with
    ``defines``, built on first use."""
    key = name + _tag(defines or {})
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            lib = _LIBS[key] = ctypes.CDLL(str(build(name, defines)))
        return lib


def ptxas_report(build_log, kernel="path_kernel"):
    """-> {template arguments: 'N registers, ... spill ...'} of ``kernel``'s
    instantiations from the compiler's -Xptxas=-v output of one library
    (its ``.log``): (flags, nc) for the path kernel, (flags,) for the
    volumetric one."""
    out, inst = {}, None
    for line in build_log.splitlines():
        m = re.search(kernel + r"ILi(\d+)E(?:Li(\d+)E)?", line)
        if m:
            inst = tuple(int(g) for g in m.groups() if g is not None)
        if inst is None:
            continue
        if "spill" in line or "stack frame" in line:
            out[inst] = line.strip()
        elif "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out[inst] = f"{regs} registers; {out.get(inst, '')}"
    return out
