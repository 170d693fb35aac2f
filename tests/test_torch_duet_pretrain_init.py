"""The DUET pre-training on-ramps of the port (`load_pretrain_init` with
agent "duet": LXMERT, BERT, BERT-verbatim, auto; the xlm-roberta
token-type row) against the JAX package's, on the state_dicts that the JAX
package's tests/test_pretrain_init.py fabricates in the released files'
layouts: the same source, the same skipped keys, and the same leaves
transferred into the DUET pre-training model with the same values.  An
initialized pre-trainer then trains."""

import numpy as np
import pytest
import torch

from tests.test_pretrain_init import (
    _bert_layer,
    _cls_predictions,
    _embeddings,
    _lxrtx_layer,
    _t,
)
from tests.test_torch_pretrain import _leaves
from vln_imagine_tpu.ckpt.manager import load_pretrain_init as j_load_init
from vln_imagine_tpu.ckpt.transfer import (
    init_finetune_from_pretrain as j_transfer,
)
from vln_imagine_tpu_torch.ckpt.convert import (
    flax_from_state_dict,
    state_dict_from_flax,
)
from vln_imagine_tpu_torch.ckpt.manager import load_pretrain_init
from vln_imagine_tpu_torch.ckpt.transfer import init_finetune_from_pretrain
from vln_imagine_tpu_torch.config import _replace, tiny_test_config
from vln_imagine_tpu_torch.pretrain.trainer import DuetPretrainer
from tests.test_torch_duet_pretrain import P, _world_ep

torch.set_num_threads(2)

TASKS = ("mlm", "mrc", "sap")


@pytest.fixture(scope="module")
def pretrainer():
    cfg = _replace(tiny_test_config("duet"), "pretrain", tasks=TASKS,
                   mix_ratio=(1, 1, 1))
    world, ep = _world_ep(seed=5)
    pt = DuetPretrainer(cfg, world, ep, image_prob_size=P, device="cpu")
    return cfg, pt, flax_from_state_dict(pt.model.state_dict(),
                                         "duet_pretrain")


def _sizes(cfg):
    m = cfg.model
    return (m.hidden_size, m.intermediate_size, m.vocab_size,
            m.max_position_embeddings)


def _lxmert(cfg, rng):
    """model_LXRT.pth as DDP saved it: BERT embeddings and language layers,
    the x-layers (both sides), the MLM head, and a pooler."""
    H, I, V, Pn = _sizes(cfg)
    sd = _embeddings(rng, "bert.embeddings", H, V, Pn)
    for i in range(cfg.model.num_l_layers):
        sd.update(_bert_layer(rng, f"bert.encoder.layer.{i}", H, I))
    for i in range(cfg.model.num_x_layers):
        sd.update(_lxrtx_layer(rng, f"bert.encoder.x_layers.{i}", H, I))
    sd.update(_cls_predictions(rng, "cls.predictions", H, V))
    sd["bert.pooler.dense.weight"] = _t(rng, H, H)
    return {"module." + k: v for k, v in sd.items()}


def _bert(cfg, rng, token_types=2):
    """A Hugging Face BertForPreTraining layout (`bert.*`, the pooler and
    `cls.predictions.*`)."""
    H, I, V, Pn = _sizes(cfg)
    sd = _embeddings(rng, "bert.embeddings", H, V, Pn, T=token_types)
    for i in range(cfg.model.num_l_layers):
        sd.update(_bert_layer(rng, f"bert.encoder.layer.{i}", H, I))
    sd["bert.pooler.dense.weight"] = _t(rng, H, H)
    sd["bert.pooler.dense.bias"] = _t(rng, H)
    sd.update(_cls_predictions(rng, "cls.predictions", H, V))
    return sd


def _both(path, target, source):
    """Each package's load and transfer into the same target params."""
    got = load_pretrain_init(path, agent="duet", source=source)
    want = j_load_init(path, agent="duet", source=source)
    assert got["source"] == want["source"]
    assert sorted(got["skipped"]) == sorted(want["skipped"])
    new, n, missing = init_finetune_from_pretrain(
        target, flax_from_state_dict(got["state_dict"], "duet_pretrain"))
    jnew, jn, jmissing = j_transfer(target, want["params"])
    assert n == jn > 0 and missing == jmissing
    jleaves = dict(_leaves(jnew["params"]))
    for p, v in _leaves(new["params"]):
        np.testing.assert_array_equal(v, jleaves[p], err_msg=p)
    return got, new, n, missing


@pytest.mark.parametrize("source", ["auto", "lxmert"])
def test_lxmert_init_matches_jax(tmp_path, pretrainer, source):
    cfg, pt, target = pretrainer
    sd = _lxmert(cfg, np.random.default_rng(0))
    path = str(tmp_path / "model_LXRT.pth")
    torch.save(sd, path)
    got, new, n, _ = _both(path, target, source)
    assert got["source"] == "lxmert"  # auto: the x_layers keys
    assert all("decoder.weight" in k or "pooler" in k
               for k in got["skipped"]), got["skipped"]
    p = new["params"]
    np.testing.assert_array_equal(
        p["mlm_head"]["bias"], sd["module.cls.predictions.bias"].numpy())
    x = "module.bert.encoder.x_layers.0."
    for enc in ("local_encoder", "global_encoder"):  # duplicated into both
        layer = p[enc]["x_layer_0"]
        for block in ("visual_attention", "visn_self_att", "lang_self_att"):
            sub = "att" if block == "visual_attention" else "self"
            np.testing.assert_array_equal(
                layer[block][sub]["query"]["kernel"],
                sd[f"{x}{block}.{sub}.query.weight"].numpy().T)
    # the initialized pre-trainer trains: one step a task, finite losses
    model = pt.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state_dict_from_flax(new, "duet_pretrain"))
    state, summary = pt.train(pt.init_state(), 3, batch_size=2)
    assert all(np.isfinite(v) for v in summary.values()), summary
    model.load_state_dict(saved)


@pytest.mark.parametrize("source", ["bert", "bert-verbatim"])
def test_bert_init_matches_jax(tmp_path, pretrainer, source):
    """'bert' remaps the language layers onto lang_encoder; 'bert-verbatim'
    keeps the HF names, so the layers match nothing (the reference's
    embeddings-only transfer) and only the embeddings and the MLM head
    land."""
    cfg, _, target = pretrainer
    sd = _bert(cfg, np.random.default_rng(1))
    path = str(tmp_path / "bert.bin")
    torch.save(sd, path)
    got, new, n, missing = _both(path, target, source)
    absent = {m for m, _ in missing}  # target modules the source lacks
    if source == "bert":
        assert not any(m.startswith("lang_layer_") for m in absent)
        np.testing.assert_array_equal(
            new["params"]["lang_layer_1"]["output"]["dense"]["kernel"],
            sd["bert.encoder.layer.1.output.dense.weight"].numpy().T)
    else:
        assert any(k.startswith("bert.encoder.layer.")
                   for k in got["skipped"])
        assert any(m.startswith("lang_layer_") for m in absent)
    np.testing.assert_array_equal(
        new["params"]["embeddings"]["word_embeddings"]["embedding"],
        sd["bert.embeddings.word_embeddings.weight"].numpy())
    assert {"local_encoder", "global_encoder"} <= absent  # BERT has none


def test_xlm_roberta_token_type_duplication(tmp_path, pretrainer):
    """One token-type row (xlm-roberta-base, the RxR recipe) is duplicated,
    so the second row serves the image embeddings (train_r2r.py:115-118)."""
    cfg, _, target = pretrainer
    sd = _bert(cfg, np.random.default_rng(2), token_types=1)
    path = str(tmp_path / "xlm_roberta_base.bin")
    torch.save(sd, path)
    _, new, _, _ = _both(path, target, "auto")
    tt = new["params"]["embeddings"]["token_type_embeddings"]["embedding"]
    assert tt.shape[0] == 2
    np.testing.assert_array_equal(tt[0], tt[1])
    np.testing.assert_array_equal(
        tt[0], sd["bert.embeddings.token_type_embeddings.weight"][0].numpy())


def test_lxmert_is_the_duet_recipe(tmp_path, pretrainer):
    cfg, _, _ = pretrainer
    path = str(tmp_path / "model_LXRT.pth")
    torch.save(_lxmert(cfg, np.random.default_rng(3)), path)
    with pytest.raises(ValueError, match="DUET"):
        load_pretrain_init(path, agent="hamt")
