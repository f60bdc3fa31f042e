"""Build and bind the port's CUDA kernel libraries.

Every kernel source under `csrc/` is compiled by its own nvcc process for
sm_90a into a shared library with a plain C entry point, bound with
ctypes.  `build()` starts the processes of all missing libraries together
and waits for them; it runs at the first launch of any kernel (or when a
caller asks), from the sources in this checkout only, into `build/` at the
repository root.  Each library is named by a hash of its source, the
headers it includes and the flags, so a changed source rebuilds.
Importing this module builds nothing and needs neither nvcc nor a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, NamedTuple, Tuple

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Library(NamedTuple):
    source: Path
    headers: Tuple[Path, ...]
    symbols: Dict[str, List]       # C entry point -> ctypes argtypes


# library -> (source, headers it includes, its C entry points); every entry
# point returns int
LIBS: Dict[str, Library] = {
    "paged_attention": Library(
        _CSRC / "paged_attention.cu", (_CSRC / "paged_attention.cuh",),
        {"kvnand_paged_attention": [_P] * 10 + [_I] * 12 + [_P]}),
    "paged_attention_shared": Library(
        _CSRC / "paged_attention_shared.cu",
        (_CSRC / "paged_attention.cuh",),
        {"kvnand_paged_attention_shared": [_P] * 11 + [_I] * 11 + [_P]}),
    "quant_gemv": Library(
        _CSRC / "quant_gemv.cu", (),
        {"kvnand_quant_gemv": [_P] * 6 + [_I] * 14 + [_P]}),
    "flash_attention": Library(
        _CSRC / "flash_attention.cu", (_CSRC / "mma_tf32.cuh",),
        {"kvnand_flash_attention": [_P] * 4 + [_LL] * 9 + [_I] * 10
         + [ctypes.c_float, _I, _P]}),
    "wkv6": Library(
        _CSRC / "wkv6.cu", (_CSRC / "mma_tf32.cuh",),
        {"kvnand_wkv6": [_P] * 11 + [_LL] * 12 + [_I] * 5 + [_P]}),
}

_lock = threading.Lock()
_fns: Dict[str, ctypes._CFuncPtr] = {}


class LaunchCount:
    """Kernel launches since the last `reset()` (one per wrapper call
    that reached the kernel)."""

    def __init__(self):
        self.value = 0

    def reset(self):
        self.value = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build the port's kernels")


def library_path(name: str) -> Path:
    lib = LIBS[name]
    h = hashlib.sha256(lib.source.read_bytes())
    for header in lib.headers:
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"{lib.source.stem}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, Path]:
    """Compile every kernel library whose build is missing, one nvcc
    process per source, all started together; returns their paths."""
    outs = {name: library_path(name) for name in LIBS}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, "-o", tmp, str(LIBS[name].source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{LIBS[name].source.name} ({proc.returncode}):"
                          f"\n{log}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return outs


def entry(symbol: str):
    """The C entry point `symbol` (building every library on first use)."""
    with _lock:
        if not _fns:
            paths = build()
            for lib_name, lib in LIBS.items():
                cdll = ctypes.CDLL(str(paths[lib_name]))
                for sym, argtypes in lib.symbols.items():
                    fn = getattr(cdll, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                    _fns[sym] = fn
    return _fns[symbol]
