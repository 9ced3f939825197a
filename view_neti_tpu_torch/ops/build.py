"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source in view_neti_tpu_torch/csrc/ is compiled on first use into a
shared library with a plain C interface under build/kernels/ at the root of
the checkout, with the compiler's output (ptxas registers and spills) in a
.log beside it. The library's name carries a hash of its source, the
headers it includes and the flags, so an edited source never loads a stale
build. `build()` starts one nvcc process per missing library, all at once,
and waits for them together.

`host_library` builds a host C++ helper of the same directory (the PNG
unfilter and the JPEG decoder of data/image_io.py, the crop's bilinear
resize of data/augment.py) with the host compiler, the same way, with
HOST_CXX_FLAGS or the helper's own entry in HOST_FLAGS. Host helpers are
not CUDA kernels and stay out of KERNEL_SOURCES.
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
from typing import Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("flash_attention_fwd_sm90", "flash_attention_fwd",
                  "flash_attention_bwd_dq_sm90", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv_sm90", "flash_attention_bwd_dkv",
                  "fused_conv_sm90", "fused_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
# helpers built with other flags: the crop's resize with native/Makefile's,
# so that its float32 sums contract into FMAs as the JAX package's do
HOST_FLAGS = {"bilinear_resize": ("-O3", "-march=native", "-fPIC",
                                  "-std=c++17", "-shared")}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
            "CUDA kernels of view_neti_tpu_torch are built on first use")
    return found


def _sources(name: str) -> List[Path]:
    """csrc/<name>.cu and the csrc headers it includes, directly or through
    another header."""
    found: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in re.findall(
            r'^#include "([^"]+)"', path.read_text(), re.MULTILINE)]
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in _sources(name))
        + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Sequence[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every library in `names` that is not built yet, in parallel.
    Returns the compiler's output (register and shared-memory use) of every
    library in `names` by name, from the log kept beside a library built
    earlier; raises with that output if a compile fails."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists() and out.with_suffix(".log").exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failed = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        tmp_log = tmp.with_suffix(".log.tmp")
        tmp_log.write_text(log)
        os.replace(tmp_log, out.with_suffix(".log"))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name).with_suffix(".log").read_text()
            for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if need be."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point `symbol` of csrc/<name>.cu, returning an int, with
    its argument types set once; the library is built and loaded first if
    need be."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _entries[(name, symbol)] = fn
    return fn


def check(name: str, err: int, what: str) -> None:
    """Raise if a C entry point of csrc/<name>.cu returned a non-zero
    cudaError_t."""
    if err != 0:
        msg = load(name).kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")


def _host_cxx() -> str:
    for cxx in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cxx and shutil.which(cxx):
            return shutil.which(cxx)
    raise RuntimeError("no host C++ compiler (g++, c++ or clang++) on PATH; "
                       "view_neti_tpu_torch's host helpers are built on "
                       "first use")


def _cpu_identity() -> bytes:
    """The CPU's model name and feature flags (Linux's /proc/cpuinfo), for
    the hash of a -march=native build: such a library runs only on the
    kind of CPU that built it."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.split(":")[0].strip() in
            ("model name", "flags", "Features", "CPU part")]
    return "\n".join(dict.fromkeys(keep)).encode()


def host_library(name: str) -> ctypes.CDLL:
    """The loaded host helper csrc/<name>.cpp, compiled first if need be
    into build/kernels/lib<name>-<hash>.so (the hash covers the source and
    the flags, and the CPU for a -march=native build; the file is renamed
    into place once complete). Raises if the build fails."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC / f"{name}.cpp"
        flags = HOST_FLAGS.get(name, HOST_CXX_FLAGS)
        key = src.read_bytes() + " ".join(flags).encode()
        if "-march=native" in flags:
            key += _cpu_identity()
        digest = hashlib.sha256(key).hexdigest()[:12]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.run([_host_cxx(), *flags, "-o", str(tmp),
                                   str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {src.name} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = _libs[name] = ctypes.CDLL(str(out))
        return lib
