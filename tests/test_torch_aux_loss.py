"""The port's alignment losses (`contrastive_alignment_loss`: cosine, InfoNCE
and margin, with and without the fused batch's `groups`) against the JAX
package's on the same numpy inputs, values and gradients, in f32 on the
CPU; the twins of tests/test_aux_loss.py's per-item loops; and the edge
cases: no valid row, batch 1, and items without any valid negative give
finite losses and gradients.  Tolerance 1e-5 on values and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.models.hamt import (
    contrastive_alignment_loss as j_contrastive_alignment_loss,
)
from vln_imagine_tpu_torch.models.hamt import contrastive_alignment_loss

torch.set_num_threads(2)

TOL = 1e-5
KINDS = ("cosine", "infonce", "margin")


def _case(B=4, I=3, H=8, seed=0):
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((B, I, H)).astype(np.float32)
    mean_np = rng.standard_normal((B, I, H)).astype(np.float32)
    valid = rng.random((B, I)) < 0.7
    valid[0, 0] = True
    return proj, mean_np, valid


def _port(kind, proj, mean_np, valid, groups=None, **kw):
    p = torch.tensor(proj, requires_grad=True)
    m = torch.tensor(mean_np, requires_grad=True)
    g = None if groups is None else torch.tensor(groups)
    loss = contrastive_alignment_loss(p, m, torch.tensor(valid), kind,
                                      groups=g, **kw)
    loss.backward()
    return loss.detach().numpy(), p.grad.numpy(), m.grad.numpy()


def _jax(kind, proj, mean_np, valid, groups=None, **kw):
    g = None if groups is None else jnp.asarray(groups)

    def f(p, m):
        return j_contrastive_alignment_loss(p, m, jnp.asarray(valid), kind,
                                            groups=g, **kw)

    loss, (gp, gm) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(proj), jnp.asarray(mean_np))
    return np.asarray(loss), np.asarray(gp), np.asarray(gm)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_values_and_gradients_match_jax(kind, grouped):
    proj, mean_np, valid = _case(seed=3)
    groups = np.array([1, 0, 1, 0], np.int32) if grouped else None
    kw = {"temperature": 0.3} if kind == "infonce" else (
        {"margin": 1.0} if kind == "margin" else {})
    got = _port(kind, proj, mean_np, valid, groups, **kw)
    want = _jax(kind, proj, mean_np, valid, groups, **kw)
    for name, g, w in zip(("loss", "d proj", "d mean_np"), got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                   err_msg=f"{kind} {name}")
    assert float(got[0]) > 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_groups_sum_the_halves_and_keep_negatives_in_their_half(kind):
    """A fused batch's loss is the sum of the two halves' separate losses:
    negatives never cross halves, and each half has its own mean."""
    proj, mean_np, valid = _case(B=6, seed=4)
    groups = np.array([0, 0, 0, 1, 1, 1], np.int32)
    fused = _port(kind, proj, mean_np, valid, groups)[0]
    halves = [_port(kind, proj[s], mean_np[s], valid[s])[0]
              for s in (slice(0, 3), slice(3, 6))]
    np.testing.assert_allclose(fused, sum(halves), rtol=TOL, atol=TOL)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-8)


def _loop(kind, proj, mean_np, valid, temp=0.3, margin=1.0):
    """tests/test_aux_loss.py's per-item reference loops."""
    pn, mn = _unit(proj), _unit(mean_np)
    B, I = valid.shape
    losses = []
    for b in range(B):
        negs = [mn[c, j] for c in range(B) if c != b
                for j in range(I) if valid[c, j]]
        for i in range(I):
            if not valid[b, i]:
                continue
            pos = float(pn[b, i] @ mn[b, i])
            if kind == "cosine":
                losses.append(1.0 - pos)
            elif kind == "infonce":
                logits = np.asarray([pos] + [float(pn[b, i] @ n)
                                             for n in negs]) / temp
                top = logits.max()
                losses.append(np.log(np.sum(np.exp(logits - top))) + top
                              - logits[0])
            else:
                hinges = [max(margin + float(pn[b, i] @ n) - pos, 0.0)
                          for n in negs]
                losses.append((1.0 - pos)
                              + (np.mean(hinges) if hinges else 0.0))
    return np.mean(losses)


@pytest.mark.parametrize("kind", KINDS)
def test_matches_the_per_item_loop(kind):
    proj, mean_np, valid = _case(seed=1)
    got = _port(kind, proj, mean_np, valid)[0]
    np.testing.assert_allclose(got, _loop(kind, proj, mean_np, valid),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_edge_cases_are_finite(kind):
    """No valid row: loss 0.  Batch 1, and an item whose negatives are all
    invalid: finite losses and gradients, as the JAX package's."""
    proj, mean_np, _ = _case()
    none = np.zeros((4, 3), bool)
    loss, gp, gm = _port(kind, proj, mean_np, none)
    assert float(loss) == 0.0 and not gp.any() and not gm.any()
    one = _case(B=1, seed=5)
    lonely = np.zeros((4, 3), bool)
    lonely[1, :2] = True  # item 1 has no valid negative anywhere
    for p, m, v in (one, (proj, mean_np, lonely)):
        got = _port(kind, p, m, v)
        want = _jax(kind, p, m, v)
        for g, w in zip(got, want):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
