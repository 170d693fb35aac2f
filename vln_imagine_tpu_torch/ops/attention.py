"""Fused multi-head attention: hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

| kernel | wrapper                  | source                 | replaces (vln_imagine_tpu/ops/attention.py) |
|--------|--------------------------|------------------------|---------------------------------------------|
| K1     | `attention_fwd`          | `csrc/attention_fwd.cu` | `_fwd_kernel`                              |
| K2     | `attention_dropout_fwd`  | `csrc/attention_fwd.cu` | `_fwd_dropout_kernel`                      |
| K3     | `attention_dropout_bwd`  | `csrc/attention_bwd.cu` | `_bwd_dropout_kernel`                      |
| K4     | `attention_bwd`          | `csrc/attention_bwd.cu` | `_bwd_kernel`                              |

All of them take the [B, L, H, D] projection layout that
`models/bert.py:MHAttention` produces (strided views of the packed QKV
product) and return [B, L, H, D], so the model needs no head transposes.

Each wrapper runs its plain version only for tensors on the CPU.  For a CUDA
tensor it launches its kernel or raises; nothing falls back.  Each wrapper
counts its launches (`ops/kernels.py:launch_counts`).

Padded keys.  Where the bias is one key row an item (the [B, 1, 1, Lk]
padding mask) and the keys take more than one staged chunk, the forward
kernel sweeps only the 16-key sub-tiles that hold a valid key, packed
(`key_tile_plan` gives them for one row).  While spans are on
(`utils/spans.py`), K1 and K2 launches add their swept and total sub-tiles
to a counter on the device, which `key_tile_counts()` reads into the spans
counters `k1.key_tiles_live` and `k1.key_tiles`.

`fused_attention` is the model's entry: K1 (or K2 with attention-probs
dropout) under `torch.no_grad`, else `FusedAttention`, whose backward is K4
(or K3).  The backward recomputes P from q, k and the bias, as the TPU
kernels do: no [Lq, Lk] tensor is stored between the passes.  One backward
call (one count of K3 or K4) launches two CUDA kernels, the dQ kernel and
the dK/dV kernel, with the rows' max, 1 / sum and delta and the packed keep
bits as scratch between them.

Dropout bits.  An element of P is kept when its 32 random bits are
>= round(rate * 2^32) and kept values are scaled by 1 / (1 - rate), as the
TPU kernels' `_dropout_mask`.  Two sources, chosen per call, which the
kernels and the plain versions produce bit for bit:

- "hash": the JAX package's `_hash_mask_bits`, a function of the
  (h + head_offset, q, k) position within one batch item's [H, Lq, Lk]
  block only (the CPU stand-in for the TPU's per-core PRNG; tests hold the
  kernels' math against the interpret-mode Pallas kernels with it);
- "philox": Philox-4x32-10 keyed on the per-call 64-bit seed, counter
  (k, q, h + head_offset, b + row_offset), first output word: different
  masks across batch items and across calls.  The training source.
  `row_offset` is the global batch row of the call's row 0: under data
  parallelism a rank holds rows [row_offset, row_offset + B) of the global
  batch, and draws their bits.  `head_offset` is the model's head of the
  call's head 0: under tensor parallelism a rank holds heads
  [head_offset, head_offset + H), and draws their bits.

The C entries `vln_attention_fwd` and `vln_attention_bwd` are declared here
(`FWD`, `BWD`) and built, loaded and launched by `ops/kernels.py`, on
PyTorch's current stream without synchronising.
"""

from __future__ import annotations

import ctypes

import torch

from vln_imagine_tpu_torch.ops.kernels import DTYPE_CODE, Entry, stream
from vln_imagine_tpu_torch.ops.masks import NEG_INF_MASK
from vln_imagine_tpu_torch.utils import spans

SUPPORTED_HEAD_DIMS = (32, 64, 128)
MAX_LK = 1024  # the backward's packed keep bits of a row fit shared memory
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
BITS = {"hash": 1, "philox": 2}

_M32 = 0xFFFFFFFF


# ------------------------------------------------------------------ bits
def hash_bits(B: int, H: int, Lq: int, Lk: int, device=None,
              head_offset: int = 0) -> torch.Tensor:
    """The JAX package's `_hash_mask_bits` over each batch item's
    [H, Lq, Lk] block, heads counted from `head_offset`, as int64 holding
    uint32 values, [B, H, Lq, Lk]."""
    def iota(n, mult, start=0):
        return (torch.arange(start, start + n, dtype=torch.int64,
                             device=device) * mult) & _M32
    x = (iota(H, 2654435761, head_offset)[:, None, None]
         ^ iota(Lq, 40503)[None, :, None] ^ iota(Lk, 69069)[None, None, :])
    x = ((x ^ (x >> 15)) * 0x2C1B3C6D) & _M32
    x = ((x ^ (x >> 12)) * 0x297A2D39) & _M32
    x = x ^ (x >> 15)
    return x[None].expand(B, H, Lq, Lk)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product a * b for uint32 values
    held in int64 (b split in 16-bit halves so nothing overflows)."""
    t = a * (b & 0xFFFF)
    u = a * (b >> 16) + (t >> 16)
    return u >> 16, ((u & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(c0, c1, c2, c3, k0: int, k1: int, rounds: int = 10):
    """Philox-4x32-`rounds` (Salmon et al., SC'11) on int64 tensors holding
    uint32 values; returns the four output words."""
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
    return c0, c1, c2, c3


def philox_bits(B: int, H: int, Lq: int, Lk: int, seed: int,
                device=None, row_offset: int = 0,
                head_offset: int = 0) -> torch.Tensor:
    """First Philox-4x32-10 word for counter (k, q, h + head_offset,
    b + row_offset) under key (seed low 32 bits, seed high 32 bits),
    [B, H, Lq, Lk] int64."""
    def ar(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)
    shape = (B, H, Lq, Lk)
    c0, c1, c2, c3 = (ar(n, d).expand(shape)
                      for n, d in ((Lk, 3), (Lq, 2), (H, 1), (B, 0)))
    c2 = (c2 + head_offset) & _M32
    c3 = (c3 + row_offset) & _M32
    return philox4x32(c0, c1, c2, c3, seed & _M32, (seed >> 32) & _M32)[0]


def keep_threshold(rate: float) -> int:
    """Bits >= this are kept (the TPU kernels' round(rate * 2^32))."""
    return min(round(rate * 2 ** 32), _M32)


def keep_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to f32 as the TPU kernels compute it."""
    return float(torch.tensor(1.0) / torch.tensor(1.0 - rate))


def dropout_mask(shape, rate: float, seed: int, bits: str,
                 device=None, row_offset: int = 0,
                 head_offset: int = 0) -> torch.Tensor:
    """f32 [B, H, Lq, Lk]: 0 where dropped, 1 / (1 - rate) where kept."""
    B, H, Lq, Lk = shape
    if bits == "hash":
        b = hash_bits(B, H, Lq, Lk, device, head_offset)
    elif bits == "philox":
        b = philox_bits(B, H, Lq, Lk, seed, device, row_offset, head_offset)
    else:
        raise ValueError(f"bits must be one of {sorted(BITS)}, got {bits!r}")
    return (b >= keep_threshold(rate)).float() * keep_scale(rate)


# ------------------------------------------------------- plain versions
def _probs(q, k, bias, scale):
    """f32 softmax(QK^T * scale + bias), [B, H, Lq, Lk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    return torch.softmax(s, dim=-1)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor | None, scale: float) -> torch.Tensor:
    """Plain attention on [B, L, H, D]: K1's arithmetic in PyTorch.

    f32 scores, + bias, softmax in f32, P rounded to V's dtype, P V with f32
    accumulation, output in Q's dtype (as the TPU kernel and the JAX
    package's `reference_attention` / `attention_core_blhd`)."""
    p = _probs(q, k, bias, scale)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_dropout_reference(q, k, v, bias, scale: float, rate: float,
                                seed: int, bits: str, row_offset: int = 0,
                                head_offset: int = 0) -> torch.Tensor:
    """K2's arithmetic: K1 with P multiplied by the keep mask after the
    softmax, before the cast to V's dtype."""
    p = _probs(q, k, bias, scale)
    p = p * dropout_mask(p.shape, rate, seed, bits, q.device, row_offset,
                         head_offset)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def _sum_to(x: torch.Tensor, shape) -> torch.Tensor:
    """Sum a [B, H, Lq, Lk] gradient over the dims a bias broadcast."""
    dims = tuple(d for d, n in enumerate(shape) if n == 1 and x.shape[d] != 1)
    return x.sum(dim=dims, keepdim=True) if dims else x


def attention_bwd_reference(q, k, v, bias, do, scale: float, rate: float = 0.0,
                            seed: int = 0, bits: str = "philox",
                            row_offset: int = 0, head_offset: int = 0):
    """K3's arithmetic (K4's with rate 0), written out as the TPU kernel
    computes it rather than by autograd: P recomputed in f32,
    dP = (dO V^T) * m, dS = P * (dP - rowsum(dP * P)), dQ = dS K * scale,
    dK = dS^T Q * scale, dV = (P * m)^T dO, each in f32 and returned in the
    input's dtype as [B, L, H, D].  dBias (f32, the bias's shape) is dS
    summed over the broadcast dims, or None without a bias."""
    p = _probs(q, k, bias, scale)
    dof, vf = do.float(), v.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    pm = p
    if rate > 0.0:
        m = dropout_mask(p.shape, rate, seed, bits, q.device, row_offset,
                         head_offset)
        dp = dp * m
        pm = p * m
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pm, dof)
    dbias = None if bias is None else _sum_to(ds, bias.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ------------------------------------------------------------ C entries
_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q k v bias o | dtype B H Lq Lk D | 13 strides | scale | bits threshold
# keep_scale seed row_offset head_offset | stream | tile counters
FWD = Entry("vln_attention_fwd",
            [_PTR] * 5 + [_INT] * 6 + [_LL] * 13
            + [ctypes.c_float, _INT, ctypes.c_uint32, ctypes.c_float,
               ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, _PTR, _PTR],
            launches=("attention_fwd", "attention_dropout_fwd"))
# q k v bias do dq dk dv ds lse delta keep | dtype B H Lq Lk D |
# 16 strides | scale | bits threshold keep_scale seed row_offset
# head_offset | stream
BWD = Entry("vln_attention_bwd",
            [_PTR] * 12 + [_INT] * 6 + [_LL] * 16
            + [ctypes.c_float, _INT, ctypes.c_uint32, ctypes.c_float,
               ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32, _PTR],
            launches=("attention_dropout_bwd", "attention_bwd"))


# ------------------------------------------------------------ launching
def _check(q, k, v, bias):
    """Validate what the kernels take; returns bias expanded to
    [B, H, Lq, Lk] (a view, stride 0 where broadcast) or None."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attention kernels take bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
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
        return None
    if bias.dtype != torch.float32 or bias.device != q.device:
        raise TypeError("bias must be f32 on the device of q")
    if bias.dim() != 4:
        raise ValueError(f"bias must be 4-d [B, 1|H, 1|Lq, Lk], got "
                         f"{tuple(bias.shape)}")
    return bias.expand(B, H, Lq, Lk)


def _dropout_args(rate: float, seed: int, bits: str, row_offset: int = 0,
                  head_offset: int = 0):
    if rate <= 0.0:
        return 0, 0, 1.0, 0, 0, 0
    if not rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    if bits not in BITS:
        raise ValueError(f"bits must be one of {sorted(BITS)}, got {bits!r}")
    if not 0 <= row_offset < 2 ** 32:
        raise ValueError(f"row_offset {row_offset} outside [0, 2^32)")
    if not 0 <= head_offset < 2 ** 32:
        raise ValueError(f"head_offset {head_offset} outside [0, 2^32)")
    return (BITS[bits], keep_threshold(rate), keep_scale(rate),
            seed & (2**64 - 1), row_offset, head_offset)


def _check_aligned(**tensors) -> None:
    for name, t in tensors.items():
        if not _aligned(t):
            raise ValueError(f"{name} must start on 16 bytes and have batch, "
                             f"row and head strides of a multiple of 16 bytes "
                             f"(got strides {t.stride()})")


def fwd_args(q, k, v, bias, out, scale, rate=0.0, seed=0, bits="philox",
             row_offset=0, head_offset=0, tile_counts=None):
    """The arguments of the C entry `vln_attention_fwd` for one call, after
    the checks of `_launch_fwd`; `out` is the [B, Lq, H, D] output and
    `tile_counts` None or the int64 [TILE_COUNT_SLOTS, 2] counter."""
    bias = _check(q, k, v, bias)
    _check_aligned(q=q, k=k, v=v)
    B, Lq, H, D = q.shape
    bias_ptr, bstrides = (None, (0, 0, 0, 0)) if bias is None else (
        bias.data_ptr(), bias.stride())
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, out.data_ptr(),
            DTYPE_CODE[q.dtype], B, H, Lq, k.shape[1], D,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            *bstrides, float(scale),
            *_dropout_args(rate, seed, bits, row_offset, head_offset),
            stream(q), None if tile_counts is None else tile_counts.data_ptr())


# K1 / K2's sub-tile counters, one int64 [TILE_COUNT_SLOTS, 2] (swept, total)
# a device, made at the first launch with spans on; the kernel spreads its
# blocks' atomics over the slots
TILE_COUNT_SLOTS = 64
_tile_counts: dict[torch.device, torch.Tensor] = {}


def _tile_counter(device: torch.device) -> torch.Tensor:
    buf = _tile_counts.get(device)
    if buf is None:
        buf = torch.zeros((TILE_COUNT_SLOTS, 2), dtype=torch.int64,
                          device=device)
        _tile_counts[device] = buf
    return buf


def key_tile_counts() -> dict[str, int]:
    """Adds the key sub-tiles K1 and K2 swept (`k1.key_tiles_live`) and
    had (`k1.key_tiles`) while spans were on, since the last call, to the
    spans counters of those names, and returns them.  One host read a
    device: call it outside the rollout's steps."""
    for buf in _tile_counts.values():
        live, total = buf.sum(0).tolist()
        buf.zero_()
        spans.count("k1.key_tiles_live", live)
        spans.count("k1.key_tiles", total)
    n = spans.counts()
    return {name: n.get(name, 0)
            for name in ("k1.key_tiles_live", "k1.key_tiles")}


def _launch_fwd(q, k, v, bias, scale, rate=0.0, seed=0, bits="philox",
                row_offset=0, head_offset=0):
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    counts = _tile_counter(q.device) if spans.enabled() else None
    args = fwd_args(q, k, v, bias, out, scale, rate, seed, bits, row_offset,
                    head_offset, counts)
    FWD(*args)
    return out


# The backward's tiles (csrc/attention_bwd.cu): one block of four warps per
# 16 query rows (dq kernel) or 16 keys (dkdv kernel), the warps taking the
# score sub-tiles of 16 keys (queries) in turn; at most 128 keys or queries
# (64 at D 128) staged in shared memory at a time, whose room then takes the
# warps' f32 partial sums.  Rows of staged tiles and of the per-warp
# buffers carry 16 bytes of padding.
BWD_WARPS, BWD_ROWS, BWD_SUB = 4, 16, 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_tile_plan(Lq: int, Lk: int, D: int, dtype: torch.dtype) -> dict:
    """Tiles and shared memory per block of the backward's two kernels at one
    shape, as `launch` in the source computes them (whose static_asserts
    are what hold the kernels under the limit).  Shared memory is bounded by
    the tiles, whatever Lq and Lk."""
    elt = torch.empty((), dtype=dtype).element_size()
    ld, lds = D + 16 // elt, BWD_SUB + 16 // elt
    chunk = 128 if D <= 64 else 64
    kc = min(chunk, _round_up(Lk, BWD_SUB))  # keys staged by the dq kernel
    qc = min(chunk, _round_up(Lq, BWD_SUB))  # queries staged by the dkdv kernel
    rows = 2 * BWD_ROWS * ld * elt           # Q, dO (dq) or K, V (dkdv)
    partials = BWD_WARPS * BWD_ROWS * D * 4
    buf = BWD_WARPS * BWD_ROWS * lds * elt   # one [16, sub] buffer per warp
    return {"rows": BWD_ROWS, "sub": BWD_SUB, "staged_keys": kc,
            "staged_queries": qc,
            # + row statistics per warp, bias [16, kc], keep bits [16, 64],
            # S and dP of the first sweep [2, 16, kc]
            "smem_dq": (rows + max(2 * kc * ld * elt, partials) + buf
                        + 3 * BWD_WARPS * BWD_ROWS * 4 + BWD_ROWS * kc * 4
                        + BWD_ROWS * (MAX_LK // 16) * 2
                        + (2 * BWD_ROWS * kc * 4 if Lk <= chunk else 0)),
            # + max, 1 / sum, delta and keep word per query, bias [qc, 16]
            "smem_dkdv": (rows + max(2 * qc * ld * elt, partials) + 2 * buf
                          + (4 + BWD_ROWS) * qc * 4)}


# the forward's key sub-tile (csrc/attention_tiles.cuh: kSub)
FWD_SUB = 16


def key_tile_plan(mask_row: torch.Tensor, Lk: int, D: int) -> dict:
    """The key sub-tiles the forward kernel (K1, K2) sweeps for one batch
    item whose bias is one key row, as `attention_fwd_kernel` picks them.
    `mask_row` is the item's additive [Lk] row, where a key at or below
    NEG_INF_MASK is padding.  The keys are staged `staged_keys` at a time
    (128, 64 at D 128, or every key rounded up to a sub-tile where fewer).
    Where they take more than one chunk, a sub-tile of 16 keys is live
    where one of its keys is valid, and the live ones are staged packed in
    order (an item with no valid key sweeps them all); where they fit one,
    every sub-tile is swept.  `chunks` lists each chunk's sub-tiles, and
    `one_chunk` says whether sweep 1 reuses sweep 0's scores."""
    row = torch.as_tensor(mask_row).detach().cpu()
    if row.shape != (Lk,):
        raise ValueError(f"mask row of shape {tuple(row.shape)}, want ({Lk},)")
    total = -(-Lk // FWD_SUB)
    staged = min(128 if D <= 64 else 64, total * FWD_SUB)
    valid = torch.zeros(total * FWD_SUB, dtype=torch.bool)
    valid[:Lk] = row > NEG_INF_MASK
    tiles = valid.view(total, FWD_SUB).any(1).nonzero().flatten().tolist()
    if not tiles or Lk <= staged:
        tiles = list(range(total))
    per = staged // FWD_SUB
    chunks = [tiles[i:i + per] for i in range(0, len(tiles), per)]
    return {"tiles": tiles, "live": len(tiles), "total": total,
            "staged_keys": staged, "chunks": chunks,
            "one_chunk": len(chunks) == 1}


def _aligned(t: torch.Tensor) -> bool:
    """A contiguous last dim, a 16-byte aligned start and batch, row and head
    strides: what the kernels' 16-byte copies into shared memory take."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all((s * e) % 16 == 0 for s in t.stride()[:3]))


def _aligned_dout(do: torch.Tensor) -> torch.Tensor:
    """dO as the backward kernels take it: autograd's gradient as it is, or,
    where `_aligned` does not hold, a copy (never a fallback).  The copy is
    a fresh allocation: `contiguous()` would return a contiguous dO that
    starts off 16 bytes unchanged."""
    return do if _aligned(do) else do.clone(memory_format=torch.contiguous_format)


def _launch_bwd(q, k, v, bias, do, scale, need_dbias, rate=0.0, seed=0,
                bits="philox", row_offset=0, head_offset=0):
    """Both backward kernels on the current stream."""
    full_bias = _check(q, k, v, bias)
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q")
    do = _aligned_dout(do)
    _check_aligned(q=q, k=k, v=v)
    bias_ptr, bstrides = (None, (0, 0, 0, 0)) if full_bias is None else (
        full_bias.data_ptr(), full_bias.stride())
    dq = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty((B, Lk, H, D), dtype=q.dtype, device=q.device)
    # dS per (batch, head); summed over the bias's broadcast dims below
    ds = (torch.empty((B, H, Lq, Lk), dtype=torch.float32, device=q.device)
          if need_dbias and bias is not None else None)
    # the dq kernel's row max, 1 / row sum and delta, and keep bits, read by
    # the dkdv kernel
    stats = torch.empty((3, B, H, Lq), dtype=torch.float32, device=q.device)
    keep = (torch.empty((B, H, Lq, -(-Lk // 16)), dtype=torch.int32,
                        device=q.device) if rate > 0.0 else None)
    BWD(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        None if ds is None else ds.data_ptr(),
        stats[0].data_ptr(), stats[2].data_ptr(),
        None if keep is None else keep.data_ptr(),
        DTYPE_CODE[q.dtype], B, H, Lq, Lk, D,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        *bstrides, float(scale),
        *_dropout_args(rate, seed, bits, row_offset, head_offset), stream(q))
    dbias = None if ds is None else _sum_to(ds, bias.shape)
    return dq, dk, dv, dbias


def _on_card(q: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version), True for CUDA; raises for
    any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no attention for device {q.device}")
    return True


# ------------------------------------------------------------- wrappers
def attention_fwd(q, k, v, bias, scale: float) -> torch.Tensor:
    """K1: [B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D]."""
    if not _on_card(q):
        return attention_reference(q, k, v, bias, scale)
    out = _launch_fwd(q, k, v, bias, scale)
    spans.count("launches.attention_fwd")
    return out


def attention_dropout_fwd(q, k, v, bias, scale: float, rate: float, seed: int,
                          bits: str = "philox", row_offset: int = 0,
                          head_offset: int = 0) -> torch.Tensor:
    """K2: K1 with attention-probs dropout at `rate` from `bits`, the
    call's rows being global batch rows row_offset + b and its heads the
    model's heads head_offset + h."""
    if not _on_card(q):
        return attention_dropout_reference(q, k, v, bias, scale, rate, seed,
                                           bits, row_offset, head_offset)
    out = _launch_fwd(q, k, v, bias, scale, rate, seed, bits, row_offset,
                      head_offset)
    spans.count("launches.attention_dropout_fwd")
    return out


def attention_bwd(q, k, v, bias, do, scale: float, need_dbias: bool = False):
    """K4: (dQ, dK, dV, dBias or None) of K1."""
    if not _on_card(q):
        dq, dk, dv, db = attention_bwd_reference(q, k, v, bias, do, scale)
        return dq, dk, dv, db if need_dbias else None
    out = _launch_bwd(q, k, v, bias, do, scale, need_dbias)
    spans.count("launches.attention_bwd")
    return out


def attention_dropout_bwd(q, k, v, bias, do, scale: float, rate: float,
                          seed: int, bits: str = "philox",
                          need_dbias: bool = False, row_offset: int = 0,
                          head_offset: int = 0):
    """K3: (dQ, dK, dV, dBias or None) of K2, the mask regenerated."""
    if not _on_card(q):
        dq, dk, dv, db = attention_bwd_reference(q, k, v, bias, do, scale,
                                                 rate, seed, bits, row_offset,
                                                 head_offset)
        return dq, dk, dv, db if need_dbias else None
    out = _launch_bwd(q, k, v, bias, do, scale, need_dbias, rate, seed, bits,
                      row_offset, head_offset)
    spans.count("launches.attention_dropout_bwd")
    return out


KERNELS = {"attention_fwd": attention_fwd,
           "attention_dropout_fwd": attention_dropout_fwd,
           "attention_dropout_bwd": attention_dropout_bwd,
           "attention_bwd": attention_bwd}


# ------------------------------------------------------------ autograd
class FusedAttention(torch.autograd.Function):
    """Attention whose forward is K1 (rate 0) or K2 and whose backward is K4
    or K3.  Saves q, k, v and the bias (views, no copies) and the seed; P is
    recomputed in the backward."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale, rate, seed, bits, row_offset,
                head_offset=0):
        ctx.save_for_backward(q, k, v, bias)
        ctx.args = (scale, rate, seed, bits, row_offset, head_offset)
        if rate > 0.0:
            return attention_dropout_fwd(q, k, v, bias, scale, rate, seed, bits,
                                         row_offset, head_offset)
        return attention_fwd(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias = ctx.saved_tensors
        scale, rate, seed, bits, row_offset, head_offset = ctx.args
        need_dbias = bias is not None and ctx.needs_input_grad[3]
        if rate > 0.0:
            dq, dk, dv, db = attention_dropout_bwd(
                q, k, v, bias, do, scale, rate, seed, bits, need_dbias,
                row_offset, head_offset)
        else:
            dq, dk, dv, db = attention_bwd(q, k, v, bias, do, scale, need_dbias)
        return dq, dk, dv, db, None, None, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor | None, scale: float,
                    dropout_rate: float = 0.0, seed: int | None = None,
                    bits: str = "philox", row_offset: int = 0,
                    head_offset: int = 0) -> torch.Tensor:
    """[B, Lq, H, D] x [B, Lk, H, D] -> [B, Lq, H, D].

    bias: additive f32 [B, 1|H, 1|Lq, Lk] (the -10000 padding masks), or
    None.  dropout_rate > 0 drops attention probabilities with the mask of
    (`seed`, `bits`), row b drawing the bits of global batch row
    row_offset + b, head h those of the model's head head_offset + h.  Without autograd the forward kernel runs directly;
    with it, `FusedAttention` records the kernels' backward.  CPU tensors
    take the plain versions; CUDA tensors launch the kernels."""
    rate = float(dropout_rate)
    if rate > 0.0 and seed is None:
        raise ValueError("attention dropout needs a seed")
    seed = 0 if seed is None else int(seed)
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    if needs_grad:
        return FusedAttention.apply(q, k, v, bias, scale, rate, seed, bits,
                                    row_offset, head_offset)
    if rate > 0.0:
        return attention_dropout_fwd(q, k, v, bias, scale, rate, seed, bits,
                                     row_offset, head_offset)
    return attention_fwd(q, k, v, bias, scale)
