"""The port's ViT (models/vit.py) against the JAX package's, on the CPU in
f32 at a tiny geometry (16 px images, patch 8, width 64, 2 layers, 4
heads), the same numpy inputs through both:

- the forward (class token and every token) and the gradient of every
  parameter, within 1e-4 (tests/test_reference_parity_hamt.py:45);
- `extract_imagine_features` in both e2e modes ('frozen' keeps no graph);
- the timm bridge both ways: the port's `vit_torch_to_flax_path` and
  converters against the JAX package's `convert_state_dict`, every leaf
  covered (`verify_converted`), and the JAX init carried into the port
  computes what the JAX ViT computes;
- `preprocess`, bitwise; `FeatureExtractor` batching;
- the extract CLI's .npy against the JAX script's, from one timm file (the
  JAX script's ViTConfig patched to the tiny f32 geometry), and its
  `--bank` output through the port's native FeatureBank.

The ViT's kernel cases on the card (K1 and K4 at 197/197 with no bias)
are in tests/test_torch_attention.py, whose card tests import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vln_imagine_tpu.ckpt import convert as JC
from vln_imagine_tpu.config import tiny_test_config as j_tiny_test_config
from vln_imagine_tpu.models import vit as jvit_mod
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
    vit_torch_to_flax_path,
)
from vln_imagine_tpu_torch.config import tiny_test_config
from vln_imagine_tpu_torch.models.vit import (
    FeatureExtractor,
    ViTConfig,
    VisionTransformer,
    extract_imagine_features,
    make_imagine_vit,
    preprocess,
)
from vln_imagine_tpu_torch.scripts import extract_features as cli
from vln_imagine_tpu_torch.train.trainer import init_params

torch.set_num_threads(2)

TOL = 1e-4
TINY = dict(image_size=16, patch_size=8, hidden_size=64, num_layers=2,
            num_heads=4, compute_dtype="float32")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, np.asarray(v)


@pytest.fixture(scope="module")
def pair():
    port = VisionTransformer(ViTConfig(**TINY))
    init_params(port, torch.Generator().manual_seed(3))
    jvit = jvit_mod.VisionTransformer(jvit_mod.ViTConfig(**TINY))
    return port, jvit, flax_from_state_dict(port.state_dict(), "vit")


def _images(n, seed=0, side=16):
    return np.random.default_rng(seed).standard_normal(
        (n, side, side, 3)).astype(np.float32)


def test_vit_forward_matches_jax(pair):
    port, jvit, params = pair
    x = _images(5)
    jcls, jtok = jvit.apply(params, jnp.asarray(x))
    with torch.no_grad():
        cls, tok = port(torch.from_numpy(x))
    assert cls.dtype == torch.float32 and tok.shape == (5, 5, 64)
    np.testing.assert_allclose(cls.numpy(), np.asarray(jcls), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tok.numpy(), np.asarray(jtok), rtol=TOL,
                               atol=TOL)


def test_vit_gradients_match_jax(pair):
    """The trainable path: FusedAttention's backward (K4's plain version on
    the CPU) and every other op, against jax.grad."""
    port, jvit, params = pair
    x = _images(3, seed=1)
    w = np.random.default_rng(2).standard_normal((3, 64)).astype(np.float32)

    def loss(p):
        cls, tok = jvit.apply(p, jnp.asarray(x))
        return jnp.sum(cls * w) + 0.1 * jnp.sum(tok ** 2)

    jgrad = jax.grad(loss)(params)
    port.zero_grad()
    cls, tok = port(torch.from_numpy(x))
    (torch.sum(cls * torch.from_numpy(w)) + 0.1 * torch.sum(tok ** 2)).backward()
    got = dict(_leaves(flax_from_state_dict(
        {n: p.grad for n, p in port.named_parameters()}, "vit")["params"]))
    want = dict(_leaves(jgrad["params"]))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=TOL, atol=TOL,
                                   err_msg=path)
        assert np.abs(want[path]).max() > 0, path


@pytest.mark.parametrize("mode", ["frozen", "trainable"])
def test_extract_imagine_features_matches_jax(mode):
    pcfg = tiny_test_config("hamt").model
    jcfg = j_tiny_test_config("hamt").model
    pcfg = type(pcfg)(**{**pcfg.__dict__, "e2e_imagination": mode})
    jcfg = type(jcfg)(**{**jcfg.__dict__, "e2e_imagination": mode})
    vit = make_imagine_vit(pcfg)
    init_params(vit, torch.Generator().manual_seed(4))
    params = flax_from_state_dict(vit.state_dict(), "vit")
    imgs = np.random.default_rng(5).standard_normal(
        (2, 3, 16, 16, 3)).astype(np.float32)
    want = jvit_mod.make_imagine_vit(jcfg).apply(
        params, jnp.asarray(imgs),
        method=lambda m, x: jvit_mod.extract_imagine_features(m, x, jcfg))
    got = extract_imagine_features(vit, torch.from_numpy(imgs), pcfg)
    assert got.shape == (2, 3, 64) and got.dtype == torch.float32
    assert got.requires_grad == (mode == "trainable")
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_timm_bridge_both_ways(pair):
    port, jvit, params = pair
    sd = port.state_dict()  # timm key names
    for key in sd:
        assert vit_torch_to_flax_path(key) == JC.vit_torch_to_flax_path(key)
    jconv, skipped = JC.convert_state_dict(sd, JC.vit_torch_to_flax_path)
    assert skipped == []
    got, want = dict(_leaves(params["params"])), dict(_leaves(jconv["params"]))
    assert set(got) == set(want)
    for path in want:
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the classification head of a timm file is dropped by both maps
    for key in ("head.weight", "head.bias"):
        assert vit_torch_to_flax_path(key) is None
    # the JAX init covered leaf by leaf, and carried into the port
    x = _images(2, seed=6)
    jinit = jax.tree.map(np.asarray, jvit.init(jax.random.PRNGKey(1),
                                               jnp.asarray(x)))
    assert JC.verify_converted(params, jinit) == []
    back = state_dict_from_flax(jinit, "vit")
    assert set(back) == set(sd)
    other = VisionTransformer(ViTConfig(**TINY))
    other.load_state_dict(back, strict=True)
    with torch.no_grad():
        cls, _ = other(torch.from_numpy(x))
    np.testing.assert_allclose(cls.numpy(), np.asarray(
        jvit.apply(jinit, jnp.asarray(x))[0]), rtol=TOL, atol=TOL)
    # and back to flax unchanged
    again = dict(_leaves(flax_from_state_dict(back, "vit")["params"]))
    for path, v in _leaves(jinit["params"]):
        np.testing.assert_array_equal(again[path], v, err_msg=path)


def test_preprocess_matches_jax():
    u8 = np.random.default_rng(7).integers(0, 256, (2, 4, 5, 3), np.uint8)
    np.testing.assert_array_equal(preprocess(u8), jvit_mod.preprocess(u8))


def test_feature_extractor_batches(pair):
    port, _, _ = pair
    x = _images(5, seed=8)
    one = FeatureExtractor(port, batch_size=8, device="cpu").extract(x)
    many = FeatureExtractor(port, batch_size=2, device="cpu").extract(x)
    np.testing.assert_allclose(many, one, rtol=1e-6, atol=1e-6)
    pano = x[:4].reshape(2, 2, 16, 16, 3)
    out = FeatureExtractor(port, batch_size=3, device="cpu").extract_panoramas(
        pano)
    np.testing.assert_allclose(out.reshape(4, -1), one[:4], rtol=1e-6,
                               atol=1e-6)
    assert FeatureExtractor(port, device="cpu").extract(x[:0]).shape == (0, 64)


def test_extract_cli_matches_the_jax_script(pair, tmp_path, monkeypatch):
    """Both scripts read one timm file; each package's ViTConfig is patched
    to the tiny f32 geometry (the scripts build ViT-B/16 in bf16)."""
    import os
    import sys

    from vln_imagine_tpu_torch.models import vit as port_vit_mod

    port, _, _ = pair
    ckpt = tmp_path / "vit.pth"
    torch.save({**port.state_dict(), "head.weight": torch.zeros(3, 64),
                "head.bias": torch.zeros(3)}, ckpt)
    images = np.random.default_rng(9).integers(
        0, 256, (3, 2, 16, 16, 3), np.uint8)  # 3 nodes x 2 views
    np.save(tmp_path / "panos.npy", images)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.syspath_prepend(os.path.join(repo, "scripts"))
    import extract_features as jcli

    jax_config, port_config = jvit_mod.ViTConfig, port_vit_mod.ViTConfig
    monkeypatch.setattr(jvit_mod, "ViTConfig",
                        lambda *a, **kw: jax_config(**TINY))
    monkeypatch.setattr(port_vit_mod, "ViTConfig",
                        lambda *a, **kw: port_config(**TINY))
    monkeypatch.setattr(sys, "argv", [
        "extract_features.py", "--images", str(tmp_path / "panos.npy"),
        "--out", str(tmp_path / "jax.npy"), "--vit-ckpt", str(ckpt)])
    jcli.main()
    want = np.load(tmp_path / "jax.npy")

    argv = ["--images", str(tmp_path / "panos.npy"), "--vit-ckpt", str(ckpt),
            "--device", "cpu"]
    got = cli.main(argv + ["--out", str(tmp_path / "port.npy")])
    assert got.shape == want.shape == (3, 2, 64)
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), want,
                               rtol=TOL, atol=TOL)
    cli.main(argv + ["--out", str(tmp_path / "bank.f32"), "--bank"])
    from vln_imagine_tpu_torch.native import FeatureBank

    bank = FeatureBank(str(tmp_path / "bank.f32"), 3, 2 * 64)
    np.testing.assert_array_equal(bank.gather(np.array([2, 0])),
                                  got.reshape(3, -1)[[2, 0]])


def test_vit_config_is_vit_b16():
    full = ViTConfig()
    assert (full.image_size, full.patch_size, full.hidden_size,
            full.num_layers, full.num_heads, full.num_patches,
            full.compute_dtype) == (224, 16, 768, 12, 12, 196, "bfloat16")
