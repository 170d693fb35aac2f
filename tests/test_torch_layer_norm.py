"""The port's LayerNorm (ops/layer_norm.py, models/bert.py:LayerNormF32): on
the CPU its dispatch and the plain expression the blocks ran before the
residual moved into the LayerNorm, bit for bit; on the card the kernel
(csrc/layer_norm.cu) against the plain expression, and the share of the
eval path's LayerNorms that take it.  Imports nothing of JAX, so that the
card tests run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm.py
"""

import pytest
import torch
import torch.nn.functional as F

from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.models.bert import (
    BertOutput,
    LayerNormF32,
    PreNormEncoderLayer,
    SelfOutput,
)
from vln_imagine_tpu_torch.ops.layer_norm import (
    _check,
    _needs_grad,
    _rows,
    fused_layer_norm,
    layer_norm,
    layer_norm_reference,
)
from vln_imagine_tpu_torch.utils import spans

torch.set_num_threads(2)

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = {"f32": F32, "bf16": BF16}
# x's and the residual's dtypes (None: no residual)
PAIRS = [(x, r) for x in DTYPES for r in (None, *DTYPES)]
EPS = [1e-12, 1e-5, 1e-6]  # BERT blocks, DUET's pre-norm layers, the ViT


def _ln(H, seed=0, device="cpu"):
    """LayerNormF32 with weights and biases away from 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    ln = LayerNormF32(H, 1e-12)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.5 * torch.randn(H, generator=g))
        ln.bias.copy_(0.5 * torch.randn(H, generator=g))
    return ln.to(device)


def _inputs(shape, x_dt, r_dt, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = (2 * torch.randn(shape, generator=g) + 0.3).to(x_dt)
    r = None if r_dt is None else torch.randn(shape, generator=g).to(r_dt)
    return x.to(device), None if r is None else r.to(device)


def _launches():
    n = spans.counts()
    return n.get("launches.layer_norm", 0), n.get("layer_norm.plain", 0)


# ------------------------------------------------------------ on the CPU
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("x_dt,r_dt", PAIRS)
def test_cpu_takes_the_plain_path_and_counts_nothing(x_dt, r_dt, grad):
    ln = _ln(32)
    x, r = _inputs((3, 5, 32), DTYPES[x_dt], r_dt and DTYPES[r_dt])
    spans.reset_counts()
    with torch.set_grad_enabled(grad):
        out = ln(x, residual=r)
    assert _launches() == (0, 0)
    want = x.dtype if r is None else torch.promote_types(x.dtype, r.dtype)
    assert out.dtype == want and out.shape == x.shape


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("x_dt,r_dt", PAIRS)
def test_residual_in_the_layer_norm_is_the_add_before_it(x_dt, r_dt, eps):
    """LayerNormF32(x, residual) is, bit for bit, what the blocks ran
    before: the add, the upcast, the f32 LayerNorm, the cast to the sum's
    dtype."""
    ln = _ln(48)
    ln.eps = eps
    x, r = _inputs((4, 7, 48), DTYPES[x_dt], r_dt and DTYPES[r_dt])
    s = x if r is None else x + r
    before = F.layer_norm(s.float(), (48,), ln.weight, ln.bias,
                          eps=eps).to(s.dtype)
    with torch.no_grad():
        assert torch.equal(ln(x, residual=r), before)
        assert torch.equal(ln(s), before)
        assert torch.equal(layer_norm_reference(x, r, ln.weight, ln.bias, eps),
                           before)


def _block_before(block, x, residual):
    """The post-LN block's forward as it was written before: the add, then
    LayerNormF32's old body."""
    ln = block.LayerNorm
    s = block.dense(x) + residual
    return F.layer_norm(s.float(), ln.weight.shape, ln.weight, ln.bias,
                        eps=ln.eps).to(s.dtype)


def _prenorm_before(layer, src, key_padding_mask):
    def norm(m, t):
        return F.layer_norm(t.float(), m.weight.shape, m.weight, m.bias,
                            eps=m.eps).to(t.dtype)
    bias = torch.where(key_padding_mask[:, None, None, :], 0.0, -1e9)
    src = src + layer.self_attn(norm(layer.norm1, src), bias)
    return src + layer.linear2(layer.act(layer.linear1(norm(layer.norm2, src))))


# the post-LN blocks with the residual in the compute dtype (DUET's stream)
# or in f32 (HAMT's step loop); the pre-norm layer passes its norms none
BLOCK_CASES = [(block, compute, residual)
               for block in ("SelfOutput", "BertOutput")
               for compute in ("float32", "bfloat16")
               for residual in ("compute", "f32")] + [
    ("PreNormEncoderLayer", compute, "compute")
    for compute in ("float32", "bfloat16")]


@pytest.mark.parametrize("block,compute,residual_dt", BLOCK_CASES)
def test_blocks_give_the_bits_of_before(block, compute, residual_dt):
    """SelfOutput, BertOutput and PreNormEncoderLayer on fixed inputs give
    the bits of their forward before the residual moved into the
    LayerNorm."""
    cfg = _replace(tiny_test_config("duet"), "model",
                   compute_dtype=compute).model
    torch.manual_seed(3)
    dt = getattr(torch, compute)
    rdt = dt if residual_dt == "compute" else F32
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        if block == "PreNormEncoderLayer":
            layer = PreNormEncoderLayer(cfg)
            torch.nn.init.normal_(layer.self_attn.in_proj_weight, std=0.1)
            src = torch.randn(3, 6, cfg.hidden_size, generator=g).to(dt)
            mask = torch.ones(3, 6, dtype=torch.bool)
            mask[1, 4:] = False
            assert torch.equal(layer(src, mask), _prenorm_before(layer, src,
                                                                 mask))
            return
        mod = SelfOutput(cfg) if block == "SelfOutput" else BertOutput(cfg)
        width = mod.dense.in_features
        x = torch.randn(3, 6, width, generator=g).to(dt)
        res = torch.randn(3, 6, cfg.hidden_size, generator=g).to(rdt)
        out = mod(x, res)
        assert out.dtype == torch.promote_types(dt, rdt)
        assert torch.equal(out, _block_before(mod, x, res))


def _cpu_stand_in(**change):
    """Arguments of a LayerNorm call at H 64 on the CPU (the rule reads only
    what a CUDA call is decided by), with one changed."""
    ln = _ln(64)
    args = {"x": torch.randn(2, 3, 64).to(BF16),
            "residual": torch.randn(2, 3, 64), "weight": ln.weight,
            "bias": ln.bias}
    args.update(change)
    return args


@pytest.mark.parametrize("case,route", [
    ("released", "kernel"),
    ("no_residual", "kernel"),
    ("fp16", "raises"),
    ("width_not_multiple_of_8", "raises"),
    ("too_wide", "raises"),
    ("broadcast_residual", "raises"),
    ("bf16_weight", "raises"),
    ("weight_requires_grad_under_autograd", "plain"),
    ("x_requires_grad_under_autograd", "plain"),
])
def test_which_calls_take_the_kernel(case, route):
    """The rule `fused_layer_norm` applies to a CUDA call, read from the
    call's input alone: under autograd the plain expression; else the
    kernel, which raises on a dtype, width or shape it does not take."""
    grad = case.endswith("under_autograd")
    if case == "no_residual":
        args = _cpu_stand_in(residual=None)
    elif case == "fp16":
        args = _cpu_stand_in(x=torch.randn(2, 3, 64).half())
    elif case in ("width_not_multiple_of_8", "too_wide"):
        H = 60 if case == "width_not_multiple_of_8" else 4104
        ln = _ln(H)
        args = {"x": torch.randn(2, H), "residual": None,
                "weight": ln.weight, "bias": ln.bias}
    elif case == "broadcast_residual":
        args = _cpu_stand_in(residual=torch.randn(1, 3, 64))
    elif case == "bf16_weight":
        args = _cpu_stand_in(weight=torch.ones(64, dtype=BF16))
    elif case == "x_requires_grad_under_autograd":
        ln = _ln(64)
        args = _cpu_stand_in(weight=ln.weight.detach(), bias=ln.bias.detach(),
                             x=torch.randn(2, 3, 64, requires_grad=True))
    else:
        args = _cpu_stand_in()
    if case == "released":  # parameters that require grad, grad mode off
        assert args["weight"].requires_grad
    with torch.set_grad_enabled(grad):
        assert _needs_grad(**args) is (route == "plain")
    if route == "raises":
        with pytest.raises(ValueError):
            _check(**args)
    else:
        _check(**args)


@pytest.mark.parametrize("case,view", [
    ("contiguous", True),
    ("packed_slice", True),
    ("transposed", False),
    ("misaligned_start", False),
    ("odd_row_stride", False),
])
def test_rows_view_or_copy(case, view):
    """`_rows` hands the kernel a [rows, H] view where one 16-byte aligned
    row stride reaches every row, and a contiguous copy otherwise; either
    way the values of x."""
    H = 16
    if case == "contiguous":
        x = torch.randn(3, 4, H)
    elif case == "packed_slice":  # the middle third of a packed product
        x = torch.randn(3, 4, 3 * H)[..., H:2 * H]
    elif case == "transposed":
        x = torch.randn(4, 3, H).transpose(0, 1)
    elif case == "misaligned_start":
        x = torch.randn(12 * H + 1)[1:].view(3, 4, H)
    else:
        x = torch.randn(12, H + 1)[:, :H].reshape(3, 4, H)
    rows = _rows(x, H)
    assert rows.shape == (12, H) and rows.stride(1) == 1
    assert rows.data_ptr() % 16 == 0 and (rows.stride(0) * 4) % 16 == 0
    assert (rows.data_ptr() == x.data_ptr()) is view
    assert torch.equal(rows, x.reshape(12, H))


# ------------------------------------------------------------ on the card
# The kernel has no CPU mode: these run only where torch finds a GPU.

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |t| (f32), the smallest normal's below it."""
    a = t.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


F32_TOL = 2e-6  # relative and absolute


def _assert_near_plain(out, want):
    """f32: within F32_TOL.  bf16: 99 % of elements identical, each within
    one bf16 ulp of the plain chain, or, where the output is so near 0 that
    F32_TOL is the larger (|y| under about 5e-4), within F32_TOL.  The
    f32 statistics differ from ATen's in their last bits, which moves a
    bf16 rounding by one ulp near a rounding boundary; and an output that
    cancels, w * n + b with w * n near -b, keeps an error at the scale of
    the terms (about 1e-7 here), which at its own scale is many ulps."""
    assert out.dtype == want.dtype and out.shape == want.shape
    if out.dtype == BF16:
        diff = (out.float() - want.float()).abs()
        ulp = _bf16_ulp(torch.maximum(out.float().abs(), want.float().abs()))
        tol = torch.maximum(ulp, F32_TOL * (1 + want.float().abs()))
        assert bool((diff <= tol).all()), float((diff / tol).max())
        if out.numel():
            assert float((out == want).float().mean()) >= 0.99
    else:
        torch.testing.assert_close(out, want, rtol=F32_TOL, atol=F32_TOL)


def _card_case(cuda, shape, x_dt, r_dt, eps=1e-12, seed=5):
    H = shape[-1]
    ln = _ln(H, seed, cuda)
    ln.eps = eps
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(shape, device=cuda, generator=g) + 0.3).to(x_dt)
    r = (None if r_dt is None
         else torch.randn(shape, device=cuda, generator=g).to(r_dt))
    return ln, x, r


@pytest.mark.cuda
@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("x_dt,r_dt", PAIRS)
def test_kernel_matches_plain_on_card(cuda, x_dt, r_dt, eps):
    ln, x, r = _card_case(cuda, (1003, 768), DTYPES[x_dt],
                          r_dt and DTYPES[r_dt], eps)
    with torch.no_grad():
        spans.reset_counts()
        out = ln(x, residual=r)
        assert _launches() == (1, 0)
        want = layer_norm_reference(x, r, ln.weight, ln.bias, eps)
    torch.cuda.synchronize()
    _assert_near_plain(out, want)


# rows: none, one, not a multiple of a block's 8; the cells' shapes: HAMT's
# step loop (bf16 x + f32 residual), DUET's map stream and its text (bf16);
# widths from one chunk a lane to the largest
CARD_SHAPES = [
    ((0, 768), "bf16", "bf16"), ((1, 768), "bf16", "f32"),
    ((13, 768), "f32", None), ((512 * 80, 768), "bf16", "f32"),
    ((512 * 98, 768), "bf16", "bf16"), ((512 * 200, 768), "bf16", "bf16"),
    ((37, 8), "bf16", "bf16"), ((37, 64), "f32", "bf16"),
    ((37, 1000), "bf16", None), ((37, 1280), "f32", "f32"),
    ((37, 4096), "bf16", "f32"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,x_dt,r_dt", CARD_SHAPES)
def test_kernel_at_the_cells_shapes_and_edges(cuda, shape, x_dt, r_dt):
    ln, x, r = _card_case(cuda, shape, DTYPES[x_dt], r_dt and DTYPES[r_dt])
    with torch.no_grad():
        out = ln(x, residual=r)
        want = layer_norm_reference(x, r, ln.weight, ln.bias, ln.eps)
    torch.cuda.synchronize()
    _assert_near_plain(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed_slice", "misaligned", "batched"])
def test_kernel_reads_strided_inputs(cuda, case):
    """x as a slice of a packed product (read in place at its row stride),
    x starting off 16 bytes (copied first), and [B, L, H] x with a
    residual of another layout."""
    H, rows = 768, 517
    g = torch.Generator(device="cuda").manual_seed(7)
    ln = _ln(H, 7, cuda)
    r = torch.randn(rows, H, device=cuda, generator=g)
    if case == "packed_slice":
        x = torch.randn(rows, 3 * H, device=cuda, generator=g).to(BF16)[
            :, H:2 * H]
    elif case == "misaligned":
        x = torch.randn(rows * H + 1, device=cuda, generator=g).to(BF16)[
            1:].view(rows, H)
        assert x.data_ptr() % 16
    else:
        x = torch.randn(11, 47, H, device=cuda, generator=g).to(BF16)
        r = torch.randn(47, 11, H, device=cuda, generator=g).transpose(0, 1)
    with torch.no_grad():
        out = fused_layer_norm(x, r, ln.weight, ln.bias, 1e-12)
        want = layer_norm_reference(x, r, ln.weight, ln.bias, 1e-12)
    torch.cuda.synchronize()
    _assert_near_plain(out, want)
    assert out.is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fp16", "width_not_multiple_of_8",
                                  "broadcast_residual"])
def test_kernel_raises_where_it_does_not_take_the_input(cuda, case):
    """Without autograd a CUDA call the kernel does not take raises: no
    plain fallback, and nothing counted."""
    H = 60 if case == "width_not_multiple_of_8" else 64
    ln = _ln(H, 2, cuda)
    x = torch.randn(4, 5, H, device=cuda).to(
        torch.float16 if case == "fp16" else BF16)
    r = torch.randn(1 if case == "broadcast_residual" else 4, 5, H,
                    device=cuda)
    spans.reset_counts()
    with torch.no_grad(), pytest.raises(ValueError):
        ln(x, residual=r)
    assert _launches() == (0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dt,r_dt", PAIRS)
def test_two_calls_give_the_same_bits(cuda, x_dt, r_dt):
    ln, x, r = _card_case(cuda, (512 * 98, 768), DTYPES[x_dt],
                          r_dt and DTYPES[r_dt])
    first = layer_norm(x, r, ln.weight, ln.bias, ln.eps)
    second = layer_norm(x, r, ln.weight, ln.bias, ln.eps)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def _trainer(agent: str):
    """A trainer on the card at the tiny widths with two heads (the
    attention kernels' head size 32) and its episodes."""
    from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world
    from vln_imagine_tpu_torch.train.trainer import HamtTrainer
    from vln_imagine_tpu_torch.train.trainer_duet import DuetTrainer

    cfg = _replace(tiny_test_config(agent), "model", num_attention_heads=2)
    world, _ = synthetic_world(num_scans=2, num_nodes=20,
                               max_candidates=cfg.env.max_candidates,
                               views=cfg.env.views,
                               feat_dim=cfg.model.image_feat_size, seed=1)
    ep = synthetic_episodes(world, batch=4,
                            max_gt_path_len=cfg.env.max_gt_path_len,
                            max_instr_len=cfg.env.max_instr_len,
                            max_imaginations=cfg.model.max_imagination_len,
                            vocab_size=cfg.model.vocab_size,
                            feat_dim=cfg.model.hidden_size, seed=2)
    cls = HamtTrainer if agent == "hamt" else DuetTrainer
    trainer = cls(cfg, world, device="cuda")
    return trainer, ep.to(trainer.device)


@pytest.mark.cuda
@pytest.mark.parametrize("agent", ["hamt", "duet"])
def test_every_eval_layer_norm_takes_the_kernel(cuda, agent):
    """The share launches.layer_norm / (launches.layer_norm +
    layer_norm.plain) is 100 % over one greedy eval call of each agent."""
    trainer, ep = _trainer(agent)
    step = trainer.make_eval_step()
    spans.reset_counts()
    step(ep)
    torch.cuda.synchronize()
    kernel, plain = _launches()
    assert kernel > 0 and plain == 0


@pytest.mark.cuda
def test_no_layer_norm_takes_the_kernel_under_autograd(cuda):
    """Under autograd the blocks run the plain expression (share 0 %) and
    the gradient reaches the LayerNorms' parameters; the same forward
    without autograd takes the kernel every time."""
    cfg = _replace(tiny_test_config("duet"), "model", num_attention_heads=2,
                   compute_dtype="bfloat16").model
    torch.manual_seed(9)
    blocks = torch.nn.ModuleList([SelfOutput(cfg), PreNormEncoderLayer(cfg)])
    torch.nn.init.normal_(blocks[1].self_attn.in_proj_weight, std=0.1)
    blocks.to(cuda)
    g = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(4, 6, cfg.hidden_size, device=cuda, generator=g).to(BF16)
    res = torch.randn(4, 6, cfg.hidden_size, device=cuda, generator=g)
    mask = torch.ones(4, 6, dtype=torch.bool, device=cuda)

    def forward():
        return blocks[1](blocks[0](x, res).to(BF16), mask)

    spans.reset_counts()
    forward().float().sum().backward()
    kernel, plain = _launches()
    assert kernel == 0 and plain == 3
    assert blocks[0].LayerNorm.weight.grad is not None
    assert blocks[1].norm2.bias.grad is not None
    spans.reset_counts()
    with torch.no_grad():
        forward()
    assert _launches() == (3, 0)
