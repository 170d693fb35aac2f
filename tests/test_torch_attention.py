"""The port's attention against the JAX package's: the plain PyTorch version
against `reference_attention` and the Pallas `_fwd_kernel` run in interpret
mode, on the CPU; the CUDA kernel against the plain version on the card.

JAX is imported inside the CPU tests only, so that the card's tests run
where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_attention.py
"""

import functools

import numpy as np
import pytest
import torch

from vln_imagine_tpu_torch.ops.attention import (
    attention_reference,
    fused_attention,
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
    before = fused_attention.launches
    out = fused_attention(tq, tk, tv, torch.from_numpy(bias), 0.125)
    want = attention_reference(tq, tk, tv, torch.from_numpy(bias), 0.125)
    assert torch.equal(out, want)
    assert fused_attention.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError):
        fused_attention(tq.to("meta"), tk.to("meta"), tv.to("meta"), None, 0.125)


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
    before = fused_attention.launches
    got = fused_attention(q, k, v, bias, 0.125)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    want = attention_reference(q, k, v, bias, 0.125)
    tol = CARD_F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
