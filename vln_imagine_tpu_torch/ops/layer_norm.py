"""LayerNorm(x [+ residual]) in f32: a hand-written CUDA kernel
(`csrc/layer_norm.cu`) and its plain PyTorch version.

`fused_layer_norm` is the model's entry (models/bert.py:LayerNormF32).  It
computes

    s = x + residual  (or x);  F.layer_norm(s.float(), ...).to(s.dtype)

with the output in the promotion of x's and the residual's dtypes, which is
what `x + residual` gives.  The choice rests on what the call can see:

- a CUDA tensor without autograd (grad mode off, or nothing of x, the
  residual, the weight and the bias requires grad): the kernel, one pass, counted
  `launches.layer_norm` (utils/spans.py).  It takes bf16 or f32 x and
  residual, a residual of x's shape, f32 weight and bias [H] on x's device,
  H a multiple of 8 up to 4096, and raises on anything else, as the
  attention wrappers do: nothing falls back;
- a CUDA call under autograd (training): the plain expression, counted
  `layer_norm.plain`;
- a CPU tensor: the plain expression, uncounted.

So the CPU tests and every step under autograd run the plain expression,
and `launches.layer_norm / (launches.layer_norm + layer_norm.plain)` is the
share of a run's CUDA LayerNorms that took the kernel.  The kernel's numbers
are the plain expression's but for the order of its f32 sums (the source
says how).  Its C entry `vln_layer_norm` is declared here (`LAYER_NORM`)
and built, loaded and launched by `ops/kernels.py`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vln_imagine_tpu_torch.ops.kernels import DTYPE_CODE, Entry, stream
from vln_imagine_tpu_torch.utils import spans

MAX_H = 4096

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# x r w b out | xdtype rdtype | rows H sx sr | eps | stream
LAYER_NORM = Entry("vln_layer_norm",
                   [_PTR] * 5 + [_INT, _INT, _LL, _INT, _LL, _LL,
                                 ctypes.c_float, _PTR],
                   launches=("layer_norm",))


def layer_norm_reference(x: torch.Tensor, residual: torch.Tensor | None,
                         weight: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """The plain expression: the add in the promoted dtype, the LayerNorm in
    f32, the result in the sum's dtype."""
    if residual is not None:
        x = x + residual
    out = F.layer_norm(x.float(), weight.shape, weight, bias, eps=eps)
    return out.to(x.dtype)


def _rows(t: torch.Tensor, H: int) -> torch.Tensor:
    """t as [rows, H]: a view where one row stride reaches every row and
    rows start on 16 bytes, else a contiguous copy."""
    t = t.reshape(-1, H)
    if (t.stride(1) != 1 or t.data_ptr() % 16
            or (t.stride(0) * t.element_size()) % 16):
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _check(x, residual, weight, bias) -> None:
    """Raise unless the kernel takes these inputs (the module docstring)."""
    H = x.shape[-1]
    if x.dtype not in DTYPE_CODE or (residual is not None
                                     and residual.dtype not in DTYPE_CODE):
        raise ValueError(f"the layer norm kernel takes bf16 or f32 x and "
                         f"residual, got {x.dtype} and "
                         f"{None if residual is None else residual.dtype}")
    if H % 8 or not 0 < H <= MAX_H:
        raise ValueError(f"the layer norm kernel takes a last dim that is a "
                         f"multiple of 8 up to {MAX_H}, got {H}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.device != x.device):
        raise ValueError(f"the residual must have x's shape {tuple(x.shape)} "
                         f"and device, got {tuple(residual.shape)} on "
                         f"{residual.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t is None or t.shape != (H,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"the layer norm kernel takes a contiguous f32 "
                             f"{name} [{H}] on x's device")


def layer_norm(x: torch.Tensor, residual: torch.Tensor | None,
               weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """The kernel on CUDA tensors: a new contiguous tensor of x's shape, or
    a ValueError for inputs it does not take."""
    _check(x, residual, weight, bias)
    H = x.shape[-1]
    x2 = _rows(x, H)
    if residual is None:
        dtype, r_ptr, r_code, r_stride = x.dtype, None, 0, 0
    else:
        dtype = torch.promote_types(x.dtype, residual.dtype)
        r2 = _rows(residual, H)
        r_ptr, r_code, r_stride = (r2.data_ptr(), DTYPE_CODE[r2.dtype],
                                   r2.stride(0))
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    rows = x2.shape[0]
    if rows:
        LAYER_NORM(x2.data_ptr(), r_ptr, weight.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), DTYPE_CODE[x.dtype], r_code, rows, H,
                   x2.stride(0), r_stride, float(eps), stream(x))
        spans.count("launches.layer_norm")
    return out


def _needs_grad(x, residual, weight, bias) -> bool:
    """Whether the call runs under autograd: grad mode on and one of the
    tensors requiring grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, residual, weight, bias))


def fused_layer_norm(x: torch.Tensor, residual: torch.Tensor | None,
                     weight: torch.Tensor, bias: torch.Tensor,
                     eps: float) -> torch.Tensor:
    """LayerNorm(x [+ residual]) over the last dim in f32, in the sum's
    dtype: the kernel where the module docstring says, else the plain
    expression."""
    if x.is_cuda:
        if not _needs_grad(x, residual, weight, bias):
            return layer_norm(x, residual, weight, bias, eps)
        spans.count("layer_norm.plain")
    return layer_norm_reference(x, residual, weight, bias, eps)
