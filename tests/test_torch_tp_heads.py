"""The attention kernels' `head_offset`, which a rank of a model axis passes
when it runs K2 / K3 on its own heads [h0, h0 + H) of the model's: the
dropout bits of the call's head h are those of the model's head h0 + h, so
the call equals those heads of the call on every head, bit for bit.

- The plain versions on the CPU, for both bit sources: the forward, and
  every output of the backward (dQ, dK, dV, and dBias of a per-head bias);
  at head_offset 0 every bit is what it was before the offset existed.
- `fused_attention` passes the offset to both directions.
- On the card (marked `cuda`, skipped where torch finds no GPU): K2 and K3
  at a head offset against those heads of the whole call, and against the
  plain versions at the offset.

Run on the card: python -m pytest --noconftest -m cuda tests/test_torch_tp_heads.py
"""

import pytest
import torch

from vln_imagine_tpu_torch.ops.attention import (
    attention_bwd_reference,
    attention_dropout_bwd,
    attention_dropout_fwd,
    attention_dropout_reference,
    dropout_mask,
    fused_attention,
    hash_bits,
    philox_bits,
)


def _case(B, lq, lk, H, dtype, seed, D=32, device=None):
    g = torch.Generator(device=device or "cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(B, n, H, D, generator=g, device=device)
                   .to(dtype) for n in (lq, lk, lk, lq))
    bias = torch.randn(B, H, lq, lk, generator=g, device=device)
    return q, k, v, bias, do


@pytest.mark.parametrize("bits", ["philox", "hash"])
@pytest.mark.parametrize("H, h0", [(4, 2), (6, 3), (3, 1)])
def test_plain_dropout_at_a_head_offset_equals_the_full_calls_heads(H, h0,
                                                                     bits):
    q, k, v, bias, do = _case(3, 7, 9, H, torch.float32, H * 10 + h0)
    seed, rate = 2 ** 40 + 3, 0.3
    heads = slice(h0, H)
    full = attention_dropout_reference(q, k, v, bias, 0.25, rate, seed, bits)
    part = attention_dropout_reference(
        q[:, :, heads], k[:, :, heads], v[:, :, heads], bias[:, heads], 0.25,
        rate, seed, bits, head_offset=h0)
    assert torch.equal(part, full[:, :, heads])
    want = attention_bwd_reference(q, k, v, bias, do, 0.25, rate, seed, bits)
    got = attention_bwd_reference(
        q[:, :, heads], k[:, :, heads], v[:, :, heads], bias[:, heads],
        do[:, :, heads], 0.25, rate, seed, bits, head_offset=h0)
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w[:, :, heads])
    assert torch.equal(got[3], want[3][:, heads])
    # without the offset the part draws heads [0, H - h0) instead
    at0 = attention_dropout_reference(
        q[:, :, heads], k[:, :, heads], v[:, :, heads], bias[:, heads], 0.25,
        rate, seed, bits)
    assert not torch.equal(at0, part)


@pytest.mark.parametrize("bits", ["philox", "hash"])
def test_bits_at_a_head_offset_are_the_whole_blocks_heads(bits):
    B, H, Lq, Lk, h0 = 2, 5, 4, 6, 2
    if bits == "hash":
        whole, part = hash_bits(B, H, Lq, Lk), hash_bits(B, H - h0, Lq, Lk,
                                                         head_offset=h0)
    else:
        whole = philox_bits(B, H, Lq, Lk, 77, row_offset=3)
        part = philox_bits(B, H - h0, Lq, Lk, 77, row_offset=3,
                           head_offset=h0)
    assert torch.equal(part, whole[:, h0:])
    mask = dropout_mask((B, H - h0, Lq, Lk), 0.4, 77, bits, head_offset=h0)
    assert torch.equal(mask, dropout_mask((B, H, Lq, Lk), 0.4, 77, bits)[:, h0:])


def test_head_offset_0_keeps_the_bits():
    """The offset is added to the counter's head word: at 0 the bits are
    the ones of the calls that had no offset (known answers of
    `test_torch_attention.py` hold through both)."""
    a = philox_bits(2, 3, 4, 5, 9, row_offset=1)
    assert torch.equal(a, philox_bits(2, 3, 4, 5, 9, row_offset=1,
                                      head_offset=0))
    assert torch.equal(hash_bits(1, 3, 2, 2), hash_bits(1, 3, 2, 2,
                                                        head_offset=0))


def test_fused_attention_passes_the_head_offset_to_both_directions():
    q, k, v, bias, do = _case(2, 6, 6, 4, torch.float32, 3)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    heads = slice(2, 4)
    out = fused_attention(q[:, :, heads], k[:, :, heads], v[:, :, heads],
                          bias[:, heads], 0.5, dropout_rate=0.2, seed=11,
                          row_offset=1, head_offset=2)
    out.backward(do[:, :, heads])
    full = attention_dropout_reference(q.detach(), k.detach(), v.detach(),
                                       bias, 0.5, 0.2, 11, "philox",
                                       row_offset=1)
    assert torch.equal(out.detach(), full[:, :, heads])
    want = attention_bwd_reference(q.detach(), k.detach(), v.detach(), bias,
                                   do, 0.5, 0.2, 11, "philox", row_offset=1)
    for t, w in zip((q, k, v), want):
        assert torch.equal(t.grad[:, :, heads], w[:, :, heads])
        assert not t.grad[:, :, :2].any()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lq, lk", [(67, 67), (200, 97), (17, 33)])
@pytest.mark.parametrize("H, h0", [(12, 6), (12, 4), (4, 1)])
def test_dropout_kernels_at_a_head_offset_on_card(cuda, H, h0, lq, lk, dtype):
    """K2 and K3 on heads [h0, H) at head_offset h0 equal those heads of the
    call on every head bitwise, and the plain versions at that offset within
    the kernels' tolerances."""
    q, k, v, bias, do = _case(4, lq, lk, H, dtype, lq * 31 + lk + h0, D=64,
                              device=cuda)
    seed, rate, scale = 0x1234_5678_9A, 0.1, 0.125
    heads = slice(h0, H)
    part = [x[:, :, heads] for x in (q, k, v, do)] + [bias[:, heads]]
    full = (attention_dropout_fwd(q, k, v, bias, scale, rate, seed),
            *attention_dropout_bwd(q, k, v, bias, do, scale, rate, seed,
                                   need_dbias=True))
    got = (attention_dropout_fwd(*part[:3], part[4], scale, rate, seed,
                                 head_offset=h0),
           *attention_dropout_bwd(*part[:3], part[4], part[3], scale, rate,
                                  seed, need_dbias=True, head_offset=h0))
    torch.cuda.synchronize()
    for g, f in zip(got[:4], full[:4]):
        assert torch.equal(g, f[:, :, heads])
    assert torch.equal(got[4], full[4][:, heads])
    plain = (attention_dropout_reference(*part[:3], part[4], scale, rate,
                                         seed, "philox", head_offset=h0),
             *attention_bwd_reference(*part[:3], part[4], part[3], scale,
                                      rate, seed, "philox", head_offset=h0))
    tol = 1e-4 if dtype == torch.float32 else 1e-2  # the card tests' tolerances
    for g, w in zip(got, plain):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
