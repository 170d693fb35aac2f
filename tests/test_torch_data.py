"""The port's data layer against the JAX package's, on the same inputs:

- twins of tests/test_data.py on the port (annotations, samplers, metadata
  tools, feature scattering);
- port vs JAX on the same numpy inputs, all exactly equal: the items of
  `construct_instrs`, every array of `episodes_from_annotations` (aux
  metadata, midstop and target objects included), `build_feature_table`
  over an HDF5 store, `build_imagination_arrays(_v1)`, `np_weight_matrix`,
  the `RoundRobinSampler` / `EvalSampler` index streams for a few seeds,
  `HashTokenizer` / `BertWordPieceTokenizer` ids, the `nlp_tools` segments
  and the `write_submission` / `write_individual_metrics` JSON;
- what the port refuses or needs: raw imagination images, HDF5 without
  h5py.
"""

import dataclasses
import json

import h5py
import numpy as np
import pytest
import torch

from vln_imagine_tpu.data import annotations as JA
from vln_imagine_tpu.data import features as JF
from vln_imagine_tpu.data import nlp_tools as JN
from vln_imagine_tpu.data import tokenizer as JT
from vln_imagine_tpu.envx.synthetic import random_scan_graph as j_graph
from vln_imagine_tpu.eval import submission as JS
from vln_imagine_tpu_torch.data import annotations as A
from vln_imagine_tpu_torch.data import features as F
from vln_imagine_tpu_torch.data import nlp_tools as N
from vln_imagine_tpu_torch.data import tokenizer as T
from vln_imagine_tpu_torch.envx.synthetic import random_scan_graph
from vln_imagine_tpu_torch.eval import submission as S

torch.set_num_threads(2)


def _fields(ep):
    return {f.name: getattr(ep, f.name) for f in dataclasses.fields(ep)}


def _assert_episodes_equal(got, want):
    g, w = _fields(got), _fields(want)
    assert set(g) <= set(w)
    for name, value in w.items():
        if name not in g:  # imagine_images: not a field of the port
            assert value is None, name
            continue
        if value is None:
            assert g[name] is None, name
            continue
        a, b = np.asarray(g[name]), np.asarray(value)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ------------------------------------------------------ twins of test_data
def test_construct_instrs_splits_instructions(tmp_path):
    anno = [{
        "path_id": 4332, "scan": "sc1",
        "path": ["a", "b", "c"], "heading": 1.0,
        "instructions": ["go one", "go two", "go three", "go four"],
        "instr_encodings": [[1, 5, 6], [1, 7, 8], [1, 9, 10], [1, 11, 12]],
    }]
    with open(tmp_path / "R2R_val_seen_enc.json", "w") as f:
        json.dump(anno, f)
    items = A.construct_instrs(str(tmp_path), "r2r", ["val_seen"])
    # at most 3 instructions per path (data_utils.py:100-102)
    assert len(items) == 3
    assert items[0]["instr_id"] == "4332_0"
    assert items[2]["instr_encoding"] == [1, 9, 10]
    assert "instructions" not in items[0]
    # augmented data keeps every instruction; the JAX package agrees
    for aug in (False, True):
        assert A.construct_instrs(str(tmp_path), "r2r", ["val_seen"],
                                  aug_flag=aug) == \
            JA.construct_instrs(str(tmp_path), "r2r", ["val_seen"],
                                aug_flag=aug)


def test_episodes_from_annotations_arrays():
    g = random_scan_graph(np.random.default_rng(0), "sc1", 10)
    items = [{
        "instr_id": "1_0", "scan": "sc1",
        "path": [g.node_ids[0], g.node_ids[1]],
        "heading": 0.5, "instr_encoding": [1, 4, 5, 6],
    }]
    meta = A.AuxMetadata(
        sub_instr_segs={"1_0": [(1, 3)]},
        noun_phrase_segs={"1_0": [[(2, 3)]]},
        generated_flags={"1_0": ["True"]},
    )
    ep, ids = A.episodes_from_annotations(items, [g], meta,
                                          max_instr_len=8, max_gt_path_len=4,
                                          max_imaginations=2)
    assert ids == ["1_0"]
    assert ep.gt_len[0] == 2
    assert ep.txt_mask[0].sum() == 4
    # noun-phrase weights: 1/2 over tokens 2..3, imagination 0 flagged
    np.testing.assert_allclose(ep.np_weights[0, 0, 2:4], 0.5)
    assert ep.np_weights[0, 0].sum() == 1.0
    assert ep.imagine_mask[0, 0] and not ep.imagine_mask[0, 1]
    assert ep.midstop is None and ep.gt_obj_id is None


def test_round_robin_sampler_wraps_with_reshuffle():
    s = A.RoundRobinSampler(5, 2, seed=1)
    seen = []
    for _ in range(5):
        b = s.next_batch()
        assert len(b) == 2
        seen.extend(b.tolist())
    # 10 draws cover the 5 items exactly twice
    assert sorted(seen).count(0) == 2
    assert len(seen) == 10


def test_eval_sampler_looped_detection():
    picked = []
    for idxs, fresh in A.EvalSampler(5, 2):
        picked.extend(np.asarray(idxs)[fresh].tolist())
    assert sorted(picked) == [0, 1, 2, 3, 4]  # each item exactly once


def test_eval_sampler_batch_larger_than_split():
    batches = list(A.EvalSampler(3, 8))
    assert len(batches) == 1
    idxs, fresh = batches[0]
    assert sorted(np.asarray(idxs)[fresh].tolist()) == [0, 1, 2]


def test_find_best_segment_exact_match():
    instr = ["[CLS]", "walk", "past", "the", "sofa", ".", "stop", "[SEP]"]
    start, end, score = N.find_best_segment(instr, ["walk", "past", "the",
                                                    "sofa"])
    assert (start, end) == (1, 5)
    assert score == 100.0


def test_merge_subword_tokens():
    merged, mapping = N.merge_subword_tokens(["book", "##shelf", "near",
                                              "stair", "##case"])
    assert merged == ["bookshelf", "near", "staircase"]
    assert mapping == [0, 2, 3]


INSTR = ["[CLS]", "walk", "to", "the", "book", "##shelf", ".", "stop",
         "at", "the", "sofa", "[SEP]"]
SUBS = [["walk", "to", "the", "book", "##shelf"],
        ["stop", "at", "the", "sofa"]]


def test_noun_phrase_metadata_schema():
    rec = N.build_sub_instr_metadata("7_1", INSTR, SUBS, path_id=7)
    assert rec["instruction_id"] == "7_1"
    assert len(rec["instr_segmentation_indices"]) == 2
    assert len(rec["noun_phrase_indices"]) == 2
    lo, hi = rec["instr_segmentation_indices"][0]
    assert INSTR[lo:hi + 1] == SUBS[0]
    for spans, (slo, shi) in zip(rec["noun_phrase_indices"],
                                 rec["instr_segmentation_indices"]):
        for (a, b) in spans:
            assert slo <= a <= b <= shi


def test_imagination_scatter_matches_flags():
    db = F.InMemoryFeaturesDB({
        "i1": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i2": np.zeros((0, 3), np.float32),
    })
    flags = {"i1": ["True", "False", "True"], "i2": ["False", "False"]}
    feats, mask = F.build_imagination_arrays(db, ["i1", "i2"], flags,
                                             max_imaginations=4, feat_dim=3)
    np.testing.assert_array_equal(mask[0], [True, False, True, False])
    np.testing.assert_allclose(feats[0, 0], [0, 1, 2])
    np.testing.assert_allclose(feats[0, 2], [3, 4, 5])
    assert not mask[1].any()


def test_reverie_np_weights_uniform_over_tokens():
    mask = np.array([[True, True, True, False],
                     [True, False, False, False]])
    w = A.reverie_np_weights(mask, max_imaginations=3)
    np.testing.assert_array_equal(w, JA.reverie_np_weights(mask, 3))
    np.testing.assert_allclose(w[0, 0], [1 / 3, 1 / 3, 1 / 3, 0])
    assert (w[:, 1:] == 0).all()


def test_imagination_v1_dense_packing():
    db = F.InMemoryFeaturesDB({
        "i1": np.arange(6, dtype=np.float32).reshape(2, 3),
        "i2": np.arange(12, dtype=np.float32).reshape(4, 3),
    })
    feats, mask = F.build_imagination_arrays_v1(db, ["i1", "i2"],
                                                max_imaginations=3, feat_dim=3)
    np.testing.assert_array_equal(mask, [[True, True, False],
                                         [True, True, True]])
    np.testing.assert_allclose(feats[0, 2], [0, 0, 0])
    np.testing.assert_allclose(feats[1, 2], [6, 7, 8])


def test_episodes_respect_v1_mask_override():
    g = random_scan_graph(np.random.default_rng(0), "sc", 8)
    items = [{"instr_id": "1_0", "scan": "sc",
              "path": [g.node_ids[0], g.node_ids[1]],
              "instr_encoding": [1, 2, 3]}]
    override = np.array([[True, True, False, False]])
    ep, _ = A.episodes_from_annotations(
        items, [g], A.AuxMetadata(), max_instr_len=8, max_gt_path_len=4,
        max_imaginations=4, imagine_mask_override=override)
    np.testing.assert_array_equal(ep.imagine_mask, override)


def test_episodes_populate_midstop():
    g = random_scan_graph(np.random.default_rng(1), "sc", 8)
    items = [{"instr_id": "1_0", "scan": "sc",
              "path": [g.node_ids[0], g.node_ids[3], g.node_ids[0]],
              "midstop": g.node_ids[3], "instr_encoding": [1, 2]},
             {"instr_id": "2_0", "scan": "sc",
              "path": [g.node_ids[2], g.node_ids[4], g.node_ids[2]],
              "midstop": g.node_ids[4], "instr_encoding": [3]}]
    ep, _ = A.episodes_from_annotations(
        items, [g], A.AuxMetadata(), max_instr_len=8, max_gt_path_len=4,
        max_imaginations=2)
    np.testing.assert_array_equal(ep.midstop, [3, 4])


# ------------------------------------------------------- port vs the JAX one
def _items_and_meta(graphs, rng, n=9, midstop=False, objects=False):
    items, meta = [], A.AuxMetadata()
    for b in range(n):
        g = graphs[b % len(graphs)]
        hops = int(rng.integers(1, 5))
        path = [g.node_ids[int(i)] for i in rng.choice(g.num_nodes, hops + 1,
                                                       replace=False)]
        iid = f"{b}_{b % 3}"
        item = {"instr_id": iid, "scan": g.scan_id, "path": path,
                "heading": float(rng.uniform(-3, 3)),
                "instr_encoding": [101] + rng.integers(
                    1000, 2000, int(rng.integers(3, 14))).tolist() + [102]}
        if midstop:
            item["midstop"] = path[len(path) // 2]
        if objects and b % 2 == 0:
            item["objId"] = str(b + 40)
        items.append(item)
        n_sub = int(rng.integers(1, 4))
        meta.sub_instr_segs[iid] = [(1 + 2 * i, 2 + 2 * i)
                                    for i in range(n_sub)]
        meta.noun_phrase_segs[iid] = [[(1 + 2 * i, 2 + 2 * i)]
                                      for i in range(n_sub)]
        meta.generated_flags[iid] = [("True" if rng.random() < 0.7
                                      else "False") for _ in range(n_sub)]
    return items, meta


@pytest.mark.parametrize("variant", ["r2r", "midstop", "objects"])
def test_episodes_equal_the_jax_builders(variant):
    rng = np.random.default_rng(3)
    graphs = [random_scan_graph(rng, f"s{i}", 11) for i in range(2)]
    jrng = np.random.default_rng(3)
    jgraphs = [j_graph(jrng, f"s{i}", 11) for i in range(2)]
    items, meta = _items_and_meta(graphs, np.random.default_rng(4),
                                  midstop=variant == "midstop",
                                  objects=variant == "objects")
    jmeta = JA.AuxMetadata(meta.sub_instr_segs, meta.noun_phrase_segs,
                           meta.generated_flags)
    feats = np.random.default_rng(5).standard_normal(
        (len(items), 3, 8)).astype(np.float32)
    ep, ids = A.episodes_from_annotations(items, graphs, meta, 12, 6, 3,
                                          feats, imagine_feat_dim=8)
    jep, jids = JA.episodes_from_annotations(items, jgraphs, jmeta, 12, 6, 3,
                                             feats, imagine_feat_dim=8)
    assert ids == jids
    _assert_episodes_equal(ep, jep)
    for it in items:
        np.testing.assert_array_equal(
            A.np_weight_matrix(it["instr_id"], meta, 3, 12),
            JA.np_weight_matrix(it["instr_id"], jmeta, 3, 12))


def test_feature_tables_equal_the_jax_builders(tmp_path):
    rng = np.random.default_rng(6)
    graphs = [random_scan_graph(rng, f"s{i}", 7) for i in range(2)]
    path = str(tmp_path / "feats.hdf5")
    with h5py.File(path, "w") as f:
        for g in graphs:
            for vp in g.node_ids:
                f.create_dataset(f"{g.scan_id}_{vp}", data=rng.standard_normal(
                    (12, 40)).astype(np.float32))
        ids = [f"{k}_0" for k in range(5)]
        flags = {}
        for k, iid in enumerate(ids):
            flags[iid] = ["True", "False", "True", "True"][:k % 4 + 1]
            f.create_dataset(iid, data=rng.standard_normal(
                (sum(x == "True" for x in flags[iid]), 40)).astype(np.float32))
    table = F.build_feature_table(F.ImageFeaturesDB(path, 32), graphs, 12, 32)
    np.testing.assert_array_equal(table, JF.build_feature_table(
        JF.ImageFeaturesDB(path, 32), graphs, 12, 32))
    db, jdb = (F.ImaginationImageFeaturesDB(path, 32),
               JF.ImaginationImageFeaturesDB(path, 32))
    for got, want in ((F.build_imagination_arrays(db, ids, flags, 3, 32),
                       JF.build_imagination_arrays(jdb, ids, flags, 3, 32)),
                      (F.build_imagination_arrays_v1(db, ids, 3, 32),
                       JF.build_imagination_arrays_v1(jdb, ids, 3, 32))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sampler_streams_equal_the_jax_samplers(seed):
    n, bs = 23, 5 + seed
    s, js = A.RoundRobinSampler(n, bs, seed), JA.RoundRobinSampler(n, bs, seed)
    for _ in range(12):
        np.testing.assert_array_equal(s.next_batch(), js.next_batch())
    for bs in (4, 23, 30):
        for (i, f), (ji, jf) in zip(A.EvalSampler(n, bs),
                                    JA.EvalSampler(n, bs), strict=True):
            np.testing.assert_array_equal(i, ji)
            np.testing.assert_array_equal(f, jf)


TEXTS = ["Walk past the sofa, then turn left at the bookshelf.",
         "Go up the stairs; stop by the café's door (second one)!",
         "don't   exit\tthe room — wait near 2 chairs"]


def test_tokenizer_ids_equal_the_jax_tokenizers(tmp_path):
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "walk", "past",
             "the", "so", "##fa", ",", "then", "turn", "left", "at", "book",
             "##shelf", ".", "go", "up", "stair", "##s", ";", "stop", "by",
             "cafe", "'", "s", "door", "(", ")", "!", "don", "t", "room",
             "wait", "near", "2", "chair"]
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab) + "\n", encoding="utf-8")
    pairs = [(T.get_tokenizer(vocab_file=str(path)),
              JT.get_tokenizer(vocab_file=str(path))),
             (T.HashTokenizer("bert-base-uncased"),
              JT.HashTokenizer("bert-base-uncased"))]
    for tok, jtok in pairs:
        for text in TEXTS:
            assert tok.tokenize(text) == jtok.tokenize(text)
            for max_length in (None, 6):
                assert tok(text, max_length=max_length) == \
                    jtok(text, max_length=max_length)
    assert pairs[0][0].encode(TEXTS[0])[:3] == [2, 5, 6]


def test_nlp_tools_equal_the_jax_tools():
    assert N.build_sub_instr_metadata("7_1", INSTR, SUBS, path_id=7) == \
        JN.build_sub_instr_metadata("7_1", INSTR, SUBS, path_id=7)
    for sub in SUBS:
        assert N.find_best_segment(INSTR, sub) == JN.find_best_segment(INSTR,
                                                                      sub)
        assert N.noun_phrases_for_sub_instr(sub) == \
            JN.noun_phrases_for_sub_instr(sub)


def test_submission_json_equals_the_jax_writer(tmp_path):
    rng = np.random.default_rng(8)
    graphs = [random_scan_graph(rng, f"s{i}", 9) for i in range(2)]
    scans = np.array([0, 1, 1])
    paths = [[0, 3, 5], [2], [1, 4, 6, 7]]
    ids = ["a_0", "b_1", "c_2"]
    headings = np.array([0.3, -2.0, 5.9], np.float32)
    per = {"instr_id": ids, "spl": [0.5, 1, 0], "nav_error": [1.5, 0.0, 9]}
    for mod, sub in ((S, "port"), (JS, "jax")):
        (tmp_path / sub).mkdir()
        mod.write_submission(str(tmp_path / sub / "submit.json"), graphs,
                             scans, paths, ids, headings)
        mod.write_individual_metrics(str(tmp_path / sub / "ind.json"), per)
    for name in ("submit.json", "ind.json"):
        assert (tmp_path / "port" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


# ------------------------------------------------- refused and needed inputs
def test_raw_imagination_images_are_refused():
    g = random_scan_graph(np.random.default_rng(0), "sc", 6)
    items = [{"instr_id": "1_0", "scan": "sc", "path": g.node_ids[:2],
              "instr_encoding": [1, 2]}]
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        A.episodes_from_annotations(
            items, [g], A.AuxMetadata(), 8, 4, 2,
            imagine_images=np.zeros((1, 2, 4, 4, 3), np.float32))


def test_hdf5_stores_name_h5py_when_it_is_missing(monkeypatch):
    monkeypatch.setattr(F, "h5py", None)
    for cls in (F.ImageFeaturesDB, F.ImaginationImageFeaturesDB):
        with pytest.raises(ImportError, match="h5py"):
            cls("features.hdf5", 768)
