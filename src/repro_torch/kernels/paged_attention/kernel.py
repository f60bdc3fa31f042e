"""CUDA paged decode-attention kernel: build, bind, launch.

The kernel (`csrc/paged_attention.cu`) replaces the TPU kernel
`repro/kernels/paged_attention/kernel.py::paged_attention_pallas`.  It is
compiled by nvcc for sm_90a into a shared library with a plain C entry
point and bound with ctypes.  The build runs at first use, from the
sources in this checkout only, into `build/` at the repository root,
named by a hash of the source and flags so a changed source rebuilds.
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
from typing import Optional, Tuple

import torch

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "paged_attention.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_FMT = {"none": None, "kv8": 2, "kv4": 3}
_POOL_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class LaunchCount:
    """Kernel launches since the last `reset()` (one per wrapper call
    that reached the kernel)."""

    def __init__(self):
        self.value = 0

    def reset(self):
        self.value = 0


launches = LaunchCount()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build the paged-attention kernel")


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes()
                            + " ".join(_NVCC_FLAGS).encode()).hexdigest()
    return _BUILD_DIR / f"paged_attention-{digest[:16]}.so"


def build() -> Path:
    """Compile the kernel library unless this source's build exists;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    proc = subprocess.Popen([_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.kvnand_paged_attention
            fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention_cuda: {msg}")


def paged_attention_cuda(
    q: torch.Tensor,          # [B, K, G, dh] float32
    k_pages: torch.Tensor,    # [B, K, NP, Ts, dh]
    v_pages: torch.Tensor,
    page_base: torch.Tensor,  # [B, NP] int32
    length: torch.Tensor,     # [B] int32
    *,
    window: Optional[int] = None,
    kv_quant: str = "none",
    k_scale: Optional[torch.Tensor] = None,   # [B, K, NP] float32
    v_scale: Optional[torch.Tensor] = None,
    partitions: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns partials o [B, K, P, G, dh], m / l
    [B, K, P, G] (float32).  Checks device, dtype, shape and contiguity
    and raises on anything the kernel does not take."""
    B, K, G, dh = q.shape
    _check(kv_quant in _FMT, f"unknown kv_quant {kv_quant!r}")
    _check(q.is_cuda, "tensors must be on a CUDA device")
    dev = q.device
    NP, Ts = k_pages.shape[2], k_pages.shape[3]
    T = 2 * Ts if kv_quant == "kv4" else Ts
    _check(dh in (32, 64, 128), f"head dim {dh} not in (32, 64, 128)")
    _check(1 <= G <= 8, f"query group {G} not in 1..8")
    _check(partitions >= 1 and NP % partitions == 0,
           f"partitions={partitions} must divide the page count {NP}")
    _check(window is None or window >= 0, f"bad window {window}")
    _check(q.dtype == torch.float32, "q must be float32")
    if kv_quant == "none":
        _check(k_pages.dtype in _POOL_DTYPE,
               f"pool dtype {k_pages.dtype} not float32/bfloat16")
        fmt = _POOL_DTYPE[k_pages.dtype]
    else:
        want = torch.int8 if kv_quant == "kv8" else torch.uint8
        _check(k_pages.dtype == want, f"{kv_quant} pool must be {want}")
        fmt = _FMT[kv_quant]
        for s in (k_scale, v_scale):
            _check(s is not None and s.dtype == torch.float32
                   and s.shape == (B, K, NP) and s.is_contiguous()
                   and s.device == dev,
                   "kv8/kv4 scales must be contiguous float32 [B, K, NP]")
    for t in (k_pages, v_pages):
        _check(t.shape == (B, K, NP, Ts, dh) and t.dtype == k_pages.dtype,
               f"pool shape {tuple(t.shape)} != {(B, K, NP, Ts, dh)}")
        _check(t.device == dev and t.is_contiguous()
               and t.data_ptr() % 16 == 0,
               "pools must be contiguous and 16-byte aligned on q's device")
    _check(q.is_contiguous(), "q must be contiguous")
    _check(page_base.shape == (B, NP) and page_base.dtype == torch.int32
           and page_base.is_contiguous() and page_base.device == dev,
           "page_base must be contiguous int32 [B, NP]")
    _check(length.shape == (B,) and length.dtype == torch.int32
           and length.is_contiguous() and length.device == dev,
           "length must be contiguous int32 [B]")

    P = partitions
    o = torch.empty((B, K, P, G, dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, K, P, G), dtype=torch.float32, device=dev)
    l = torch.empty((B, K, P, G), dtype=torch.float32, device=dev)
    if B == 0:
        return o, m, l
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.kvnand_paged_attention(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(k_scale), ptr(v_scale),
        ptr(page_base), ptr(length), ptr(o), ptr(m), ptr(l),
        B, K, NP, T, G, dh, P, -1 if window is None else int(window), fmt,
        stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches.value += 1
    return o, m, l
