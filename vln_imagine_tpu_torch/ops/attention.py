"""Fused multi-head attention forward: a hand-written CUDA kernel for Hopper
(`csrc/attention_fwd.cu`) and its plain PyTorch version.

The kernel replaces the JAX package's Pallas TPU kernel
`vln_imagine_tpu/ops/attention.py:_fwd_kernel`.  Both functions here take the
[B, L, H, D] projection layout that `models/bert.py:MHAttention` produces
and return [B, Lq, H, D], so the model needs no head transposes.

`fused_attention` runs the plain version only for tensors on the CPU.  For a
CUDA tensor it launches the kernel or raises; nothing falls back.

The kernel is built at first use with nvcc into `build/kernels/` at the root
of the checkout (a plain C entry point, loaded with ctypes) and launched on
PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "attention_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

SUPPORTED_HEAD_DIMS = (32, 64, 128)
MAX_LK = 1024  # the f32 score rows of a 16-query tile stay in shared memory
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Plain attention on [B, L, H, D]: the kernel's arithmetic in PyTorch.

    f32 scores, + bias, softmax in f32, P rounded to V's dtype, P V with f32
    accumulation, output in Q's dtype (as the TPU kernel and the JAX
    package's `reference_attention` / `attention_core_blhd`)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _build() -> Path:
    """Compile the kernel once per source content; returns the library path."""
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"attention_fwd_{digest}.so"
    if lib_path.exists():
        return lib_path
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, lib_path)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed to build {_SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def load_kernel() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            fn = lib.vln_attention_fwd
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                           + [ctypes.c_longlong] * 13
                           + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _launch(q, k, v, bias, scale) -> torch.Tensor:
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernel takes bf16 or f32 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Lk, H, D) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match [B, L, H, D]")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if not 0 < Lk <= MAX_LK:
        raise ValueError(f"Lk {Lk} outside (0, {MAX_LK}]")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("the last dim of q, k and v must be contiguous")
    if bias is None:
        bias_ptr, bstrides = None, (0, 0, 0, 0)
    else:
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError("bias must be f32 on the device of q")
        if bias.dim() != 4:
            raise ValueError(f"bias must be 4-d [B, 1|H, 1|Lq, Lk], got "
                             f"{tuple(bias.shape)}")
        bias = bias.expand(B, H, Lq, Lk)  # a view: stride 0 where broadcast
        bias_ptr, bstrides = bias.data_ptr(), bias.stride()
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    lib = load_kernel()
    err = lib.vln_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
        _DTYPE_CODE[q.dtype], B, H, Lq, Lk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        *bstrides, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
    fused_attention.launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D].

    bias: additive f32 [B, 1|H, 1|Lq, Lk] (the -10000 padding masks), or
    None.  CPU tensors take `attention_reference`; CUDA tensors launch the
    kernel, and `fused_attention.launches` counts those launches."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention for device {q.device}")
    return _launch(q, k, v, bias, scale)


fused_attention.launches = 0
