"""The port's attention against the JAX package's: the plain PyTorch versions
of K1-K4 against `reference_attention`, its autodiff, and the Pallas kernels
run in interpret mode, on the CPU; the CUDA kernels against the plain
versions on the card.

JAX is imported inside the CPU tests only, so that the card's tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import functools

import numpy as np
import pytest
import torch

from vln_imagine_tpu_torch.ops.attention import (
    MAX_LK,
    SMEM_LIMIT,
    FusedAttention,
    _aligned,
    _aligned_dout,
    attention_bwd,
    attention_bwd_reference,
    attention_dropout_bwd,
    attention_dropout_fwd,
    attention_dropout_reference,
    attention_fwd,
    attention_reference,
    bwd_tile_plan,
    dropout_mask,
    fused_attention,
    launch_counts,
    philox4x32,
)

torch.set_num_threads(2)

F32_TOL = 1e-5
# bf16 outputs: both sides round P and O to bf16 (8 significant bits); one
# bf16 ulp of an O entry near 1 is 2^-8, so allow about two ulps
BF16_TOL = 1e-2
# kernel vs plain in f32 on the card: the same products summed in another
# order differ by ~1e-6
CARD_F32_TOL = 1e-4


def _interp_fwd(q, k, v, bias, scale):
    """Pallas K1 in interpret mode, as tests/test_attention.py runs it."""
    import jax
    from jax.experimental import pallas as pl

    from vln_imagine_tpu.ops import attention as A

    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    return pl.pallas_call(
        functools.partial(A._fwd_kernel, scale=scale),
        out_shape=jax.ShapeDtypeStruct((B, H, Lq, D), q.dtype),
        grid=(B,),
        in_specs=A._specs(H, Lq, Lk, D, bias.shape[1]),
        out_specs=pl.BlockSpec((1, H, Lq, D), lambda i: (i, 0, 0, 0)),
        interpret=True,
    )(q, k, v, bias)


def _inputs(case, B=2, H=3, Lq=10, Lk=7, D=32, seed=0):
    """numpy q/k/v [B, L, H, D] and bias for one case."""
    rng = np.random.default_rng(seed)
    if case == "lq_ne_lk":
        Lq, Lk = 12, 5
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    if case == "packed":
        # q/k/v as strided views of one packed [B, L, 3*H*D] product
        packed = rng.standard_normal((B, Lq, 3 * H * D)).astype(np.float32)
        q = packed
        k = v = None
        Lk = Lq
    else:
        k = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
        v = rng.standard_normal((B, Lk, H, D)).astype(np.float32)
    if case == "per_head":
        bias = rng.standard_normal((B, H, Lq, Lk)).astype(np.float32)
    elif case == "graph":
        # DUET's graph self-attention: the key mask plus a bias that varies
        # along the queries, shared by the heads, [B, 1, Lq, Lk]
        keep = rng.random((B, Lk)) < 0.75
        keep[:, 0] = True
        bias = ((1.0 - keep[:, None, None, :]) * -10000.0
                + rng.standard_normal((B, 1, Lq, Lk))).astype(np.float32)
    elif case == "none":
        bias = None
    else:
        keep = rng.random((B, Lk)) < 0.75
        keep[:, 0] = True
        bias = ((1.0 - keep[:, None, None, :]) * -10000.0).astype(np.float32)
    return q, k, v, bias, (B, H, Lq, Lk, D)


def _torch_qkv(case, q, k, v, dims, dtype):
    B, H, Lq, Lk, D = dims
    if case == "packed":
        qkv = torch.from_numpy(q).to(dtype)
        tq, tk, tv = (x.unflatten(-1, (H, D)) for x in qkv.split(H * D, -1))
        assert tq.stride(1) == 3 * H * D  # views, not copies
    else:
        tq, tk, tv = (torch.from_numpy(x).to(dtype) for x in (q, k, v))
    return tq, tk, tv


def _bhld(x):
    import jax.numpy as jnp

    return jnp.asarray(x.float().numpy()).transpose(0, 2, 1, 3)


CASES = ["broadcast", "per_head", "none", "packed", "lq_ne_lk"]


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_reference_and_interpret_kernel(case):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    q, k, v, bias, dims = _inputs(case)
    B, H, Lq, Lk, D = dims
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = _torch_qkv(case, q, k, v, dims, torch.float32)
    tbias = None if bias is None else torch.from_numpy(bias)
    got = attention_reference(tq, tk, tv, tbias, scale).numpy()
    assert got.shape == (B, Lq, H, D)

    jq, jk, jv = _bhld(tq), _bhld(tk), _bhld(tv)
    jbias = None if bias is None else jnp.asarray(bias)
    want_ref = A.reference_attention(jq, jk, jv, jbias, scale)
    kbias = (jnp.zeros((B, 1, Lq, Lk), jnp.float32) if bias is None
             else jnp.broadcast_to(jbias, (B, jbias.shape[1], Lq, Lk)))
    want_k1 = _interp_fwd(jq, jk, jv, kbias, scale)
    for want in (want_ref, want_k1):
        np.testing.assert_allclose(
            got, np.asarray(want).transpose(0, 2, 1, 3),
            rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", ["broadcast", "per_head"])
def test_plain_bf16_matches_jax_bf16(case):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    q, k, v, bias, dims = _inputs(case, seed=4)
    D = dims[-1]
    scale = 1.0 / np.sqrt(D)
    tq, tk, tv = _torch_qkv(case, q, k, v, dims, torch.bfloat16)
    got = attention_reference(tq, tk, tv, torch.from_numpy(bias), scale)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  .transpose(0, 2, 1, 3) for x in (tq, tk, tv))
    want = A.reference_attention(jq, jk, jv, jnp.asarray(bias), scale)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(want.astype(jnp.float32)).transpose(0, 2, 1, 3),
        rtol=BF16_TOL, atol=BF16_TOL)


def test_fused_attention_takes_plain_version_only_on_cpu():
    q, k, v, bias, dims = _inputs("broadcast", seed=2)
    tq, tk, tv = _torch_qkv("broadcast", q, k, v, dims, torch.float32)
    before = launch_counts()
    out = fused_attention(tq, tk, tv, torch.from_numpy(bias), 0.125)
    want = attention_reference(tq, tk, tv, torch.from_numpy(bias), 0.125)
    assert torch.equal(out, want)
    assert launch_counts() == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        fused_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"), None, 0.125)


# ------------------------------------------------ K2-K4 on the CPU
# K2 and K3 with the "hash" bits are held bit for bit against the JAX
# package's interpret-mode dropout kernels, which draw the same bits
# (`_hash_mask_bits`); K4 against the interpret-mode `_bwd_kernel` as
# tests/test_attention.py runs it.  f32 throughout: the same products summed
# in another order differ by ~1e-7, so 1e-5 leaves room.

RATE = 0.25
GRAD_CASES = ["broadcast", "per_head", "lq_ne_lk"]


def _grad_inputs(case, seed=7):
    q, k, v, bias, dims = _inputs(case, seed=seed)
    B, H, Lq, Lk, D = dims
    rng = np.random.default_rng(seed + 100)
    do = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v, bias, do)]
    return t, dims


def _jax_kernel_inputs(t, dims):
    import jax.numpy as jnp

    B, H, Lq, Lk, D = dims
    tq, tk, tv, tbias, tdo = t
    jbias = jnp.broadcast_to(jnp.asarray(tbias.numpy()),
                             (B, tbias.shape[1], Lq, Lk))
    return _bhld(tq), _bhld(tk), _bhld(tv), jbias, _bhld(tdo)


def _interp_bwd(q, k, v, bias, g, scale):
    """Pallas K4 in interpret mode (tests/test_attention.py:60-89)."""
    import jax
    from jax.experimental import pallas as pl

    from vln_imagine_tpu.ops import attention as A

    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    in_specs = A._specs(H, Lq, Lk, D, bias.shape[1])
    in_specs.append(pl.BlockSpec((1, H, Lq, D), lambda i: (i, 0, 0, 0)))
    return pl.pallas_call(
        functools.partial(A._bwd_kernel, scale=scale),
        out_shape=(jax.ShapeDtypeStruct((B, H, Lq, D), q.dtype),
                   jax.ShapeDtypeStruct((B, H, Lk, D), k.dtype),
                   jax.ShapeDtypeStruct((B, H, Lk, D), v.dtype)),
        grid=(B,),
        in_specs=in_specs,
        out_specs=(pl.BlockSpec((1, H, Lq, D), lambda i: (i, 0, 0, 0)),
                   pl.BlockSpec((1, H, Lk, D), lambda i: (i, 0, 0, 0)),
                   pl.BlockSpec((1, H, Lk, D), lambda i: (i, 0, 0, 0))),
        interpret=True,
    )(q, k, v, bias, g)


def _close(got, want_bhld, what):
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want_bhld).transpose(0, 2, 1, 3),
                               rtol=F32_TOL, atol=F32_TOL, err_msg=what)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_hash_dropout_fwd_matches_interpret_kernel(case):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    t, dims = _grad_inputs(case)
    scale = 1.0 / np.sqrt(dims[-1])
    got = attention_dropout_fwd(*t[:4], scale, RATE, seed=0, bits="hash")
    jq, jk, jv, jbias, _ = _jax_kernel_inputs(t, dims)
    want, _ = A._pallas_attention_dropout_fwd(
        jq, jk, jv, jbias, jnp.asarray([7], jnp.int32), scale, RATE,
        bits_fn=A._hash_mask_bits, interpret=True)
    _close(got, want, f"K2 {case}")
    # the mask is applied: rate 0 would give K1's output
    assert not torch.allclose(got, attention_reference(*t[:4], scale))


@pytest.mark.parametrize("case", GRAD_CASES)
def test_hash_dropout_bwd_matches_interpret_kernel(case):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    t, dims = _grad_inputs(case)
    scale = 1.0 / np.sqrt(dims[-1])
    dq, dk, dv, _ = attention_dropout_bwd(*t[:4], t[4], scale, RATE, seed=0,
                                          bits="hash")
    jq, jk, jv, jbias, jdo = _jax_kernel_inputs(t, dims)
    res = (jq, jk, jv, jbias, jnp.asarray([7], jnp.int32))
    want = A._pallas_attention_dropout_bwd(
        scale, RATE, res, jdo, bits_fn=A._hash_mask_bits, interpret=True)
    for g, w, n in zip((dq, dk, dv), want[:3], "qkv"):
        _close(g, w, f"K3 {case} d{n}")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_bwd_matches_interpret_kernel(case):
    t, dims = _grad_inputs(case)
    scale = 1.0 / np.sqrt(dims[-1])
    dq, dk, dv, _ = attention_bwd(*t[:4], t[4], scale)
    want = _interp_bwd(*_jax_kernel_inputs(t, dims), scale)
    for g, w, n in zip((dq, dk, dv), want, "qkv"):
        _close(g, w, f"K4 {case} d{n}")


@pytest.mark.parametrize("case", ["broadcast", "per_head", "graph"])
def test_dbias_matches_jax_vjp(case):
    """dBias, which the TPU kernels drop, against the JAX package's own
    autodiff of `reference_attention` with respect to the bias."""
    import jax
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    t, dims = _grad_inputs(case)
    scale = 1.0 / np.sqrt(dims[-1])
    tq, tk, tv, tbias, tdo = t
    *_, dbias = attention_bwd(tq, tk, tv, tbias, tdo, scale, need_dbias=True)
    assert dbias.shape == tbias.shape
    jbias = jnp.asarray(tbias.numpy())
    _, vjp = jax.vjp(lambda b: A.reference_attention(
        _bhld(tq), _bhld(tk), _bhld(tv), b, scale), jbias)
    (want,) = vjp(_bhld(tdo))
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("bits", [None, "hash", "philox"])
@pytest.mark.parametrize("case", GRAD_CASES + ["packed"])
def test_fused_attention_backward_matches_autograd(case, bits):
    """FusedAttention's explicit backward (K4, or K3 with the mask
    regenerated from the seed) against autograd through the plain forward
    with the same mask, dBias included.  Agreement also shows that the
    backward uses the forward's mask."""
    q, k, v, bias, dims = _inputs(case, seed=3)
    B, H, Lq, Lk, D = dims
    tq, tk, tv = _torch_qkv(case, q, k, v, dims, torch.float32)
    rate, seed = (0.0, 0) if bits is None else (RATE, 1234567891011)
    scale = 1.0 / np.sqrt(D)
    do = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, Lq, H, D)).astype(np.float32))

    def grads(fn):
        leaves = [x.detach().clone().requires_grad_() for x in
                  (tq, tk, tv, torch.from_numpy(bias))]
        fn(*leaves).backward(do)
        return [x.grad for x in leaves]

    got = grads(lambda q_, k_, v_, b_: FusedAttention.apply(
        q_, k_, v_, b_, scale, rate, seed, bits or "philox"))
    want = grads(lambda q_, k_, v_, b_: attention_dropout_reference(
        q_, k_, v_, b_, scale, rate, seed, bits) if bits else
        attention_reference(q_, k_, v_, b_, scale))
    for g, w, n in zip(got, want, ("q", "k", "v", "bias")):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   msg=f"d{n}")


# ------------------------------------- the backward kernels' arithmetic
# csrc/attention_bwd.cu in bf16, emulated on the CPU: the first kernel
# sweeps the keys in sub-tiles of 16 with an online row max, keeping the row
# sum of exp(S - max) and of exp(S - max) * dP, and stores the max, 1 / the
# sum and delta = rowsum(dP * P); both kernels rebuild P = exp(S - max) *
# (1 / sum) and dS = P (dP - delta) in f32, round dS and P * M to bf16 for the tensor-core products dQ,
# dK and dV (f32 accumulation), and round the outputs to bf16.  The
# emulation is held against the plain version and the interpret-mode Pallas
# K3 (hash bits) at every training shape within BF16_TOL: the rounding of
# dS and P * M costs the kernel less than that.

# (Lq, Lk) of every attention call of a train step: the eval path's, and the
# IL rollout's x-layer shapes (8 steps keep 9 history slots: 60 visual
# tokens)
TRAIN_SHAPES = [(60, 60), (80, 80), (80, 67), (67, 80), (67, 67), (36, 36),
                (80, 60), (60, 80)]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulate_bwd_kernels(q, k, v, bias, do, scale, mask, sub=16):
    """The two backward kernels' arithmetic on bf16 q, k, v, dO [B, L, H, D]
    (f32 tensors holding bf16 values), the f32 bias and the dropout mask
    [B, H, Lq, Lk]; returns bf16-rounded dQ, dK, dV as f32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v) * mask
    mx = torch.full(s.shape[:-1], -torch.inf)
    total, dot = torch.zeros_like(mx), torch.zeros_like(mx)
    for j0 in range(0, s.shape[-1], sub):  # sweep 0: online statistics
        sj, dpj = s[..., j0:j0 + sub], dp[..., j0:j0 + sub]
        m = torch.maximum(mx, sj.amax(-1))
        corr = torch.exp(mx - m)
        e = torch.exp(sj - m[..., None])
        total = total * corr + e.sum(-1)
        dot = dot * corr + (e * dpj).sum(-1)
        mx = m
    delta = dot / total
    p = torch.exp(s - mx[..., None]) * (1.0 / total)[..., None]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), q) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p * mask), do)
    return _bf16(dq), _bf16(dk), _bf16(dv)


@pytest.mark.parametrize("lq,lk", TRAIN_SHAPES)
def test_bwd_kernel_arithmetic_within_bf16_tolerance(lq, lk):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    B, H, D = 2, 2, 64
    rng = np.random.default_rng(lq * 100 + lk)
    q, do = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, lq, H, D)).astype(np.float32))) for _ in range(2))
    k, v = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, lk, H, D)).astype(np.float32))) for _ in range(2))
    keep = rng.random((B, lk)) < 0.8
    keep[:, 0] = True
    bias = torch.from_numpy(
        ((1.0 - keep[:, None, None, :]) * -10000.0).astype(np.float32))
    scale, rate = 1.0 / np.sqrt(D), 0.1
    mask = dropout_mask((B, H, lq, lk), rate, 0, "hash")
    got = _emulate_bwd_kernels(q, k, v, bias, do, scale, mask)

    plain = attention_bwd_reference(q, k, v, bias, do, scale, rate, 0, "hash")
    jq, jk, jv, jdo = (_bhld(x) for x in (q, k, v, do))
    jbias = jnp.broadcast_to(jnp.asarray(bias.numpy()), (B, 1, lq, lk))
    pallas = A._pallas_attention_dropout_bwd(
        scale, rate, (jq, jk, jv, jbias, jnp.asarray([7], jnp.int32)), jdo,
        bits_fn=A._hash_mask_bits, interpret=True)
    for g, w, wp, n in zip(got, plain, pallas, "qkv"):
        torch.testing.assert_close(g, w, rtol=BF16_TOL, atol=BF16_TOL,
                                   msg=f"d{n} vs plain")
        np.testing.assert_allclose(
            g.numpy(), np.asarray(wp).transpose(0, 2, 1, 3), rtol=BF16_TOL,
            atol=BF16_TOL, err_msg=f"d{n} vs interpret-mode K3")


# ------------------------------------- the forward kernel's arithmetic
# csrc/attention_fwd.cu in bf16, emulated on the CPU: the keys are staged at
# most 128 at a time; the four warps of a block take the 16-key sub-tiles of
# each chunk in turn; sweep 0 keeps each warp's online row max and sum of
# exp(S - max), merged in warp order into the exact max and sum of the row;
# sweep 1 forms P = exp(S - max) * (1 / sum) (times the keep mask for K2),
# rounds it to bf16, and accumulates O += P V in f32 over the chunk's keys,
# 16 at a time in key order (each warp does so for its own columns of O),
# chunk after chunk; O is rounded to bf16.  With one chunk sweep 1 reuses
# sweep 0's S; past one chunk it stages K again and recomputes S the same
# way.  The emulation is held against the interpret-mode Pallas K1 and K2
# (hash bits) within BF16_TOL at main-path shapes, one key past a chunk, and
# long rows.

FWD_EMULATION_SHAPES = [(67, 80), (80, 80), (36, 36), (80, 129), (220, 220),
                        (40, 1024)]


def _emulate_fwd_kernel(q, k, v, bias, scale, mask=None, sub=16, warps=4,
                        chunk=128):
    """The forward kernel's order on bf16 q, k, v [B, L, H, D] (f32 tensors
    holding bf16 values), the f32 bias [B, 1|H, 1|Lq, Lk] and the keep mask
    [B, H, Lq, Lk] or None; returns the bf16-rounded O as f32."""
    B, Lq, H, _ = q.shape
    Lk = k.shape[1]
    chunks = [(c0, min(chunk, Lk - c0)) for c0 in range(0, Lk, chunk)]

    def scores(c0, n):  # S of one staged chunk
        return (torch.einsum("bqhd,bkhd->bhqk", q, k[:, c0:c0 + n]) * scale
                + bias[..., c0:c0 + n])

    def tiles(n):  # (first key in the chunk, warp) of each sub-tile
        return [(s0, (s0 // sub) % warps) for s0 in range(0, n, sub)]

    mx = [torch.full((B, H, Lq), -torch.inf) for _ in range(warps)]
    total = [torch.zeros(B, H, Lq) for _ in range(warps)]
    for c0, n in chunks:  # sweep 0
        s = scores(c0, n)
        for s0, w in tiles(n):
            sj = s[..., s0:s0 + sub]
            m = torch.maximum(mx[w], sj.amax(-1))
            total[w] = (total[w] * torch.exp(mx[w] - m)
                        + torch.exp(sj - m[..., None]).sum(-1))
            mx[w] = m
    row_max = torch.stack(mx).amax(0)
    row_sum = torch.zeros(B, H, Lq)
    for w in range(warps):  # a warp with no keys adds 0
        row_sum = row_sum + total[w] * torch.exp(mx[w] - row_max)

    inv = 1.0 / row_sum  # the kernel multiplies by the rounded reciprocal
    out = torch.zeros(q.shape)
    for c0, n in chunks:  # sweep 1
        s = scores(c0, n) if len(chunks) > 1 else s
        p = torch.exp(s - row_max[..., None]) * inv[..., None]
        if mask is not None:
            p = p * mask[..., c0:c0 + n]
        p = _bf16(p)
        for s0 in range(0, n, sub):
            out = out + torch.einsum("bhqk,bkhd->bqhd", p[..., s0:s0 + sub],
                                     v[:, c0 + s0:c0 + s0 + sub])
    return _bf16(out)


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("lq,lk", FWD_EMULATION_SHAPES)
def test_fwd_kernel_arithmetic_within_bf16_tolerance(lq, lk, kernel):
    import jax.numpy as jnp

    from vln_imagine_tpu.ops import attention as A

    B, H, D = 2, 2, 64
    rng = np.random.default_rng(lq * 10000 + lk)
    q = _bf16(torch.from_numpy(rng.standard_normal((B, lq, H, D)).astype(
        np.float32)))
    k, v = (_bf16(torch.from_numpy(rng.standard_normal(
        (B, lk, H, D)).astype(np.float32))) for _ in range(2))
    keep = rng.random((B, lk)) < 0.8
    keep[:, 0] = True
    bias = torch.from_numpy(
        ((1.0 - keep[:, None, None, :]) * -10000.0).astype(np.float32))
    scale, rate = 1.0 / np.sqrt(D), 0.1
    mask = (dropout_mask((B, H, lq, lk), rate, 0, "hash") if kernel == "K2"
            else None)
    got = _emulate_fwd_kernel(q, k, v, bias, scale, mask)

    jq, jk, jv = (jnp.asarray(x.numpy(), jnp.bfloat16).transpose(0, 2, 1, 3)
                  for x in (q, k, v))
    jbias = jnp.broadcast_to(jnp.asarray(bias.numpy()), (B, 1, lq, lk))
    if kernel == "K1":
        pallas = _interp_fwd(jq, jk, jv, jbias, scale)
        plain = attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                    bias, scale)
    else:
        pallas, _ = A._pallas_attention_dropout_fwd(
            jq, jk, jv, jbias, jnp.asarray([7], jnp.int32), scale, rate,
            bits_fn=A._hash_mask_bits, interpret=True)
        plain = attention_dropout_reference(
            q.bfloat16(), k.bfloat16(), v.bfloat16(), bias, scale, rate, 0,
            "hash")
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(pallas.astype(jnp.float32)).transpose(0, 2, 1, 3),
        rtol=BF16_TOL, atol=BF16_TOL, err_msg=f"{kernel} vs interpret mode")
    torch.testing.assert_close(got, plain.float(), rtol=BF16_TOL,
                               atol=BF16_TOL, msg=f"{kernel} vs plain")


@pytest.mark.parametrize("which", ["q", "k", "v"])
def test_launch_fwd_raises_on_unaligned_view_before_any_build(which,
                                                              monkeypatch):
    """q, k or v one element past 16 bytes is refused before the kernels
    are built or loaded: the forward's 16-byte copies cannot take it."""
    from vln_imagine_tpu_torch.ops import attention as A

    def no_build():
        raise AssertionError("the kernels were built or loaded")

    monkeypatch.setattr(A, "load_kernels", no_build)
    B, L, H, D = 2, 5, 3, 64
    t = {n: torch.randn(B, L, H, D).to(torch.bfloat16) for n in "qkv"}
    shifted = torch.zeros(t[which].numel() + 1,
                          dtype=torch.bfloat16)[1:].view(B, L, H, D)
    shifted.copy_(t[which])
    assert shifted.is_contiguous() and not _aligned(shifted)
    t[which] = shifted
    with pytest.raises(ValueError, match="16 bytes"):
        A._launch_fwd(t["q"], t["k"], t["v"], None, 0.125)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unaligned_dout_is_copied_to_an_aligned_allocation(dtype):
    """A dO the backward's 16-byte loads cannot take becomes a fresh copy:
    a contiguous view one element off 16 bytes as well as a view whose head
    stride is not a multiple of 16 bytes."""
    B, L, H, D = 2, 5, 3, 64
    flat = torch.randn(B * L * H * D + 1).to(dtype)
    shifted = flat[1:].view(B, L, H, D)  # contiguous, 2 or 4 bytes off
    strided = torch.randn(B, L, H, D + 1).to(dtype)[..., :D]
    aligned = torch.randn(B, L, H, D).to(dtype)
    assert shifted.is_contiguous() and not _aligned(shifted)
    for do in (shifted, strided):
        got = _aligned_dout(do)
        assert _aligned(got) and got.data_ptr() != do.data_ptr()
        assert torch.equal(got, do)
    assert _aligned_dout(aligned) is aligned


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_tile_plan_fits_shared_memory(D, dtype):
    """The backward's shared memory is bounded by its tiles: every Lq, Lk up
    to MAX_LK fits one block of an H100."""
    worst = 0
    for n in range(1, MAX_LK + 1):
        for lq, lk in ((n, n), (n, MAX_LK), (MAX_LK, n)):
            plan = bwd_tile_plan(lq, lk, D, dtype)
            assert plan["staged_keys"] >= min(lk, plan["sub"])
            worst = max(worst, plan["smem_dq"], plan["smem_dkdv"])
    assert worst <= SMEM_LIMIT
    # and it stops growing with L once a row takes more than one staged chunk
    # (at most 128 keys or queries)
    tail = {tuple(bwd_tile_plan(n, n, D, dtype)[key]
                  for key in ("smem_dq", "smem_dkdv"))
            for n in range(129, MAX_LK + 1)}
    assert len(tail) == 1


# ------------------------------------------------------- philox bits
def test_philox_known_answers():
    """Philox-4x32-10 against the known-answer vectors of Random123
    (Salmon et al., SC'11)."""
    vectors = [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
         (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
         (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for ctr, key, want in vectors:
        got = philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in ctr),
                         *key)
        assert tuple(int(w) for w in got) == want


def test_philox_mask_properties():
    shape = (4, 12, 160, 160)  # 1.2M draws
    rate = 0.1
    m = dropout_mask(shape, rate, seed=99, bits="philox")
    keep = (m > 0).double().mean().item()
    assert abs(keep - (1 - rate)) < 0.01
    torch.testing.assert_close(m[m > 0], torch.full_like(m[m > 0], 1 / 0.9))
    # masks differ across seeds and across batch items ...
    m2 = dropout_mask(shape, rate, seed=100, bits="philox")
    assert (m != m2).float().mean() > 0.1
    assert (m[0] != m[1]).float().mean() > 0.1
    # ... and repeat for one seed
    assert torch.equal(m, dropout_mask(shape, rate, seed=99, bits="philox"))
    # the hash source depends on the position within a batch item only
    h = dropout_mask(shape, rate, seed=1, bits="hash")
    assert torch.equal(h[0], h[1])
    assert torch.equal(h, dropout_mask(shape, rate, seed=2, bits="hash"))


# ------------------------------------------------------------ on the card
# The kernel has no CPU mode: these run only where torch finds a GPU.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (Lq, Lk) of every attention call on the HAMT eval path: language 60/60,
# x-layer cross 80/67 and 67/80, self 80/80 and 67/67, pano 36/36
MAIN_PATH_SHAPES = [(60, 60), (80, 80), (80, 67), (67, 80), (67, 67), (36, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("lq,lk", MAIN_PATH_SHAPES)
def test_kernel_matches_plain_on_card(cuda, lq, lk, per_head, dtype):
    B, H, D = 8, 12, 64
    g = torch.Generator(device="cuda").manual_seed(lq * 1000 + lk)
    qx = torch.randn(B, lq, 3 * H * D, device=cuda, generator=g).to(dtype)
    kv = torch.randn(B, lk, 3 * H * D, device=cuda, generator=g).to(dtype)
    q = qx[..., :H * D].unflatten(-1, (H, D))
    k, v = (x.unflatten(-1, (H, D)) for x in kv[..., H * D:].split(H * D, -1))
    if per_head:
        bias = torch.randn(B, H, lq, lk, device=cuda, generator=g)
    else:
        keep = torch.rand(B, lk, device=cuda, generator=g) < 0.8
        bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    before = attention_fwd.launches
    got = fused_attention(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    assert attention_fwd.launches == before + 1
    want = attention_reference(q, k, v, bias, 0.125)
    tol = CARD_F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _card_case(cuda, lq, lk, per_head, dtype, seed, D=64):
    B, H = 8, 12
    g = torch.Generator(device="cuda").manual_seed(seed)
    qx = torch.randn(B, lq, 3 * H * D, device=cuda, generator=g).to(dtype)
    kv = torch.randn(B, lk, 3 * H * D, device=cuda, generator=g).to(dtype)
    q = qx[..., :H * D].unflatten(-1, (H, D))
    k, v = (x.unflatten(-1, (H, D)) for x in kv[..., H * D:].split(H * D, -1))
    do = torch.randn(B, lq, H, D, device=cuda, generator=g).to(dtype)
    if per_head:
        bias = torch.randn(B, H, lq, lk, device=cuda, generator=g)
    else:
        keep = torch.rand(B, lk, device=cuda, generator=g) < 0.8
        bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    return q, k, v, bias, do


@pytest.mark.cuda
@pytest.mark.parametrize("bits", ["hash", "philox"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk", TRAIN_SHAPES)
def test_dropout_kernels_match_plain_on_card(cuda, lq, lk, dtype, bits):
    q, k, v, bias, do = _card_case(cuda, lq, lk, True, dtype, lq * 7 + lk)
    seed, tol = 2 ** 40 + 17, (CARD_F32_TOL if dtype == torch.float32
                               else BF16_TOL)
    before = (attention_dropout_fwd.launches, attention_dropout_bwd.launches)
    out = attention_dropout_fwd(q, k, v, bias, 0.125, 0.1, seed, bits)
    grads = attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1, seed, bits,
                                  need_dbias=True)
    torch.cuda.synchronize()
    assert (attention_dropout_fwd.launches,
            attention_dropout_bwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        out.float(), attention_dropout_reference(
            q, k, v, bias, 0.125, 0.1, seed, bits).float(), rtol=tol, atol=tol)
    want = attention_bwd_reference(q, k, v, bias, do, 0.125, 0.1, seed, bits)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("lq,lk", TRAIN_SHAPES)
def test_bwd_kernel_matches_plain_on_card(cuda, lq, lk, per_head):
    q, k, v, bias, do = _card_case(cuda, lq, lk, per_head, torch.float32,
                                   lq * 11 + lk)
    before = attention_bwd.launches
    grads = attention_bwd(q, k, v, bias, do, 0.125, need_dbias=per_head)
    torch.cuda.synchronize()
    assert attention_bwd.launches == before + 1
    want = attention_bwd_reference(q, k, v, bias, do, 0.125)
    for g, w in zip(grads, want if per_head else want[:3]):
        torch.testing.assert_close(g, w, rtol=CARD_F32_TOL, atol=CARD_F32_TOL)


# ragged and long calls: one row, tiles cut on both sides, past the 112 rows
# that one block per (batch, head) could hold, and the text stacks of DUET
# (200 + 20 tokens) and RxR HAMT (250 + 20)
LONG_SHAPES = [(1, 1), (17, 33), (113, 113), (220, 220), (270, 270)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("lq,lk", LONG_SHAPES)
def test_bwd_kernels_long_and_ragged_on_card(cuda, lq, lk, per_head, dtype):
    q, k, v, bias, do = _card_case(cuda, lq, lk, per_head, dtype,
                                   lq * 13 + lk)
    seed, tol = 2 ** 33 + 5, (CARD_F32_TOL if dtype == torch.float32
                              else BF16_TOL)
    before = (attention_dropout_bwd.launches, attention_bwd.launches)
    k3 = attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1, seed, "philox",
                               need_dbias=per_head)
    k4 = attention_bwd(q, k, v, bias, do, 0.125, need_dbias=per_head)
    torch.cuda.synchronize()
    assert (attention_dropout_bwd.launches,
            attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for got, want in ((k3, attention_bwd_reference(
            q, k, v, bias, do, 0.125, 0.1, seed, "philox")),
            (k4, attention_bwd_reference(q, k, v, bias, do, 0.125))):
        for g, w in zip(got, want if per_head else want[:3]):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_is_deterministic_on_card(cuda, dtype):
    """No atomics: two K3 calls with one seed give the same bits, dBias
    included."""
    q, k, v, bias, do = _card_case(cuda, 80, 67, True, dtype, 99)
    first, second = (attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1,
                                           12345, "philox", need_dbias=True)
                     for _ in range(2))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_takes_dout_off_16_bytes_on_card(cuda, dtype):
    """A contiguous dO that starts one element past 16 bytes is copied, not
    read with misaligned 16-byte loads."""
    q, k, v, bias, do = _card_case(cuda, 67, 80, True, dtype, 7)
    shifted = torch.empty(do.numel() + 1, dtype=dtype,
                          device=cuda)[1:].view(do.shape)
    shifted.copy_(do)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    tol = CARD_F32_TOL if dtype == torch.float32 else BF16_TOL
    got = attention_dropout_bwd(q, k, v, bias, shifted, 0.125, 0.1, 3,
                                "philox", need_dbias=True)
    torch.cuda.synchronize()
    want = attention_bwd_reference(q, k, v, bias, do, 0.125, 0.1, 3, "philox")
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)


# the forward past one staged chunk of 128 keys (the text stacks of DUET and
# RxR HAMT), one key past it, and at the head dims other than the model's
FWD_CARD_CASES = [(220, 220, 64), (270, 270, 64), (80, 129, 64), (67, 80, 32),
                  (67, 80, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("lq,lk,D", FWD_CARD_CASES)
def test_fwd_kernels_long_boundary_and_head_dims_on_card(cuda, lq, lk, D,
                                                         per_head, dtype):
    q, k, v, bias, _ = _card_case(cuda, lq, lk, per_head, dtype,
                                  lq * 17 + lk + D, D=D)
    scale, seed = D ** -0.5, 2 ** 35 + 3
    tol = CARD_F32_TOL if dtype == torch.float32 else BF16_TOL
    before = (attention_fwd.launches, attention_dropout_fwd.launches)
    k1 = attention_fwd(q, k, v, bias, scale)
    k2 = attention_dropout_fwd(q, k, v, bias, scale, 0.1, seed, "philox")
    torch.cuda.synchronize()
    assert (attention_fwd.launches,
            attention_dropout_fwd.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(
        k1.float(), attention_reference(q, k, v, bias, scale).float(),
        rtol=tol, atol=tol)
    torch.testing.assert_close(
        k2.float(), attention_dropout_reference(
            q, k, v, bias, scale, 0.1, seed, "philox").float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk", [(80, 67), (270, 270)])
def test_fwd_dropout_kernel_is_deterministic_on_card(cuda, lq, lk, dtype):
    """No atomics: two K2 calls with one seed give the same bits."""
    q, k, v, bias, _ = _card_case(cuda, lq, lk, True, dtype, 98)
    first, second = (attention_dropout_fwd(q, k, v, bias, 0.125, 0.1, 12345,
                                           "philox") for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# (Lq, Lk) of DUET's calls at the released config: language 200/200; per
# step the global branch's cross 97/220 and self 97/97 (key mask + graph
# bias), the local branch's cross 51/220 and self 51/51, and the pano
# encoder 50/50 with its -1e9 key padding
DUET_CASES = [(200, 200, "mask"), (97, 220, "mask"), (97, 97, "graph"),
              (51, 220, "mask"), (51, 51, "mask"), (50, 50, "pad")]


def _duet_bias(cuda, g, B, lq, lk, kind):
    keep = torch.rand(B, lk, device=cuda, generator=g) < 0.8
    keep[:, 0] = True
    if kind == "pad":
        return torch.where(keep, 0.0, -1e9)[:, None, None, :]
    bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    if kind == "graph":
        bias = bias + torch.randn(B, 1, lq, lk, device=cuda, generator=g)
    return bias


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,kind", DUET_CASES)
def test_kernels_at_duet_shapes_on_card(cuda, lq, lk, kind, dtype):
    """K1-K4 against plain at DUET's shapes and bias forms; dBias of the
    [B, 1, Lq, Lk] graph bias is dS summed over the heads."""
    q, k, v, _, do = _card_case(cuda, lq, lk, False, dtype, lq * 19 + lk)
    g = torch.Generator(device="cuda").manual_seed(lq + lk)
    bias = _duet_bias(cuda, g, q.shape[0], lq, lk, kind)
    need_db = kind == "graph"
    seed, tol = 2 ** 37 + 9, (CARD_F32_TOL if dtype == torch.float32
                              else BF16_TOL)
    before = launch_counts()
    got = {"k1": (attention_fwd(q, k, v, bias, 0.125),),
           "k2": (attention_dropout_fwd(q, k, v, bias, 0.125, 0.1, seed,
                                        "philox"),),
           "k3": attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1, seed,
                                       "philox", need_dbias=need_db),
           "k4": attention_bwd(q, k, v, bias, do, 0.125, need_dbias=need_db)}
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    want = {"k1": (attention_reference(q, k, v, bias, 0.125),),
            "k2": (attention_dropout_reference(q, k, v, bias, 0.125, 0.1,
                                               seed, "philox"),),
            "k3": attention_bwd_reference(q, k, v, bias, do, 0.125, 0.1, seed,
                                          "philox"),
            "k4": attention_bwd_reference(q, k, v, bias, do, 0.125)}
    for name in got:
        w = want[name] if need_db or name in ("k1", "k2") else want[name][:3]
        if need_db and name in ("k3", "k4"):
            assert got[name][3].shape == bias.shape
        for a, b in zip(got[name], w):
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                       msg=f"{name} {lq}x{lk} {kind}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_at_the_imagination_encoder_shape_on_card(cuda, dtype):
    """K1-K4 at the full imagination encoder's self-attention (Lq = Lk =
    max_imagination_len 20, the -10000 key mask), where one item has no
    imagination and every key of its rows is masked: finite, and what the
    plain version gives there."""
    q, k, v, _, do = _card_case(cuda, 20, 20, False, dtype, 2020)
    g = torch.Generator(device="cuda").manual_seed(20)
    keep = torch.rand(q.shape[0], 20, device=cuda, generator=g) < 0.8
    keep[0] = False
    bias = (1.0 - keep.float())[:, None, None, :] * -10000.0
    seed, tol = 2 ** 39 + 1, (CARD_F32_TOL if dtype == torch.float32
                              else BF16_TOL)
    before = launch_counts()
    got = {"k1": (attention_fwd(q, k, v, bias, 0.125),),
           "k2": (attention_dropout_fwd(q, k, v, bias, 0.125, 0.1, seed,
                                        "philox"),),
           "k3": attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1, seed,
                                       "philox")[:3],
           "k4": attention_bwd(q, k, v, bias, do, 0.125)[:3]}
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    want = {"k1": (attention_reference(q, k, v, bias, 0.125),),
            "k2": (attention_dropout_reference(q, k, v, bias, 0.125, 0.1,
                                               seed, "philox"),),
            "k3": attention_bwd_reference(q, k, v, bias, do, 0.125, 0.1, seed,
                                          "philox")[:3],
            "k4": attention_bwd_reference(q, k, v, bias, do, 0.125)[:3]}
    for name in got:
        for a, b in zip(got[name], want[name]):
            assert torch.isfinite(a).all(), name
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                       msg=f"{name} fully masked item")


# DUET pre-training's new calls: MLM's lang2visn, 200 text queries over the
# global branch's 97 and the local branch's 51 keys (-10000 key mask); and
# the pano encoder over every step of whole trajectories, 50/50 with the
# -1e9 key padding, where two thirds of the rows are padding steps with
# every key masked
DUET_PRETRAIN_CASES = [(200, 97, "mask"), (200, 51, "mask"),
                       (50, 50, "pad_rows")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq,lk,kind", DUET_PRETRAIN_CASES)
def test_kernels_at_duet_pretraining_shapes_on_card(cuda, lq, lk, kind,
                                                    dtype):
    """K1-K4 against plain at DUET pre-training's shapes; the fully masked
    rows at -1e9 give what the plain version gives there (uniform weights
    over the masked keys, as the JAX package's softmax), and finite."""
    q, k, v, bias, do = _card_case(cuda, lq, lk, False, dtype, lq * 23 + lk)
    if kind == "pad_rows":
        g = torch.Generator(device="cuda").manual_seed(lq)
        keep = torch.rand(q.shape[0], lk, device=cuda, generator=g) < 0.8
        keep[:2 * q.shape[0] // 3] = False
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    seed, tol = 2 ** 41 + 3, (CARD_F32_TOL if dtype == torch.float32
                              else BF16_TOL)
    before = launch_counts()
    got = {"k1": (attention_fwd(q, k, v, bias, 0.125),),
           "k2": (attention_dropout_fwd(q, k, v, bias, 0.125, 0.1, seed,
                                        "philox"),),
           "k3": attention_dropout_bwd(q, k, v, bias, do, 0.125, 0.1, seed,
                                       "philox")[:3],
           "k4": attention_bwd(q, k, v, bias, do, 0.125)[:3]}
    torch.cuda.synchronize()
    after = launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)
    want = {"k1": (attention_reference(q, k, v, bias, 0.125),),
            "k2": (attention_dropout_reference(q, k, v, bias, 0.125, 0.1,
                                               seed, "philox"),),
            "k3": attention_bwd_reference(q, k, v, bias, do, 0.125, 0.1, seed,
                                          "philox")[:3],
            "k4": attention_bwd_reference(q, k, v, bias, do, 0.125)[:3]}
    for name in got:
        for a, b in zip(got[name], want[name]):
            assert torch.isfinite(a).all(), name
            torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol,
                                       msg=f"{name} {lq}x{lk} {kind}")


# The ViT's attention (models/vit.py): 197 tokens (a [CLS] and 14 x 14
# patches at 224 px), no bias, q/k/v views of one packed qkv projection.
def _vit_qkv(cuda, B, dtype, seed):
    """q, k, v as the ViT block makes them: strided views of one packed
    [B, 197, 3, 12, 64] projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, 197, 3 * 768, device=cuda, generator=g).to(dtype)
    qkv = qkv.unflatten(-1, (3, 12, 64))
    do = torch.randn(B, 197, 12, 64, device=cuda, generator=g).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_attention_kernels_match_plain_on_card(cuda, dtype):
    tol = CARD_F32_TOL if dtype == torch.float32 else BF16_TOL
    q, k, v, do = _vit_qkv(cuda, 16, dtype, 197)
    before = (attention_fwd.launches, attention_bwd.launches)
    out = fused_attention(q, k, v, None, 0.125)
    dq, dk, dv, db = attention_bwd(q, k, v, None, do, 0.125)
    torch.cuda.synchronize()
    assert (attention_fwd.launches, attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert db is None
    torch.testing.assert_close(out.float(), attention_reference(
        q, k, v, None, 0.125).float(), rtol=tol, atol=tol)
    for got, want in zip((dq, dk, dv), attention_bwd_reference(
            q, k, v, None, do, 0.125)[:3]):
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.cuda
def test_vit_on_card_matches_cpu(cuda):
    """A full-width ViT (2 layers) in f32: the card (K1) against the CPU."""
    from vln_imagine_tpu_torch.models.vit import ViTConfig, VisionTransformer
    from vln_imagine_tpu_torch.train.trainer import init_params

    cfg = ViTConfig(image_size=32, patch_size=16, hidden_size=768,
                    num_layers=2, num_heads=12, compute_dtype="float32")
    vit = VisionTransformer(cfg)
    init_params(vit, torch.Generator().manual_seed(11))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        want, _ = vit(x)
        got, _ = vit.to(cuda)(x.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
