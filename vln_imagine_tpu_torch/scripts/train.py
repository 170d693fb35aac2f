"""Fine-tune entry point of the port (the reference's r2r/main.py +
scripts/run_r2r.sh), with the flags of the JAX package's scripts/train.py.

Real data, on the card:
  python -m vln_imagine_tpu_torch.scripts.train --agent hamt \\
      --connectivity-dir .../connectivity --anno-dir .../annotations \\
      --img-features .../vit_features.hdf5 --imagine-features .../imagine.hdf5 \\
      --generated-flag-file ... --sub-instr-file ... \\
      --splits train val_seen val_unseen

Synthetic smoke run (no datasets needed) on the CPU:
  python -m vln_imagine_tpu_torch.scripts.train --agent hamt --synthetic \\
      --iters 20 --log-every 10 --device cpu

Everything runs on the card unless `--device` names another device; with
no CUDA and no `--device` the CLI exits.  `--dataset` picks the task
variant's preset (`preset`); `--synthetic` takes the tiny test preset off
the card and the dataset's preset on it.  Flags whose branch is not ported
yet exit with the ROADMAP item that will port it.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", choices=["hamt", "duet"], default="hamt")
    p.add_argument("--dataset", default="r2r",
                   choices=["r2r", "r2r_back", "r4r", "rxr", "cvdn",
                            "reverie", "soon"])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--log-dir", default="logs/run")
    p.add_argument("--iters", type=int, default=None)
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="greedy-eval batch size (0 = train batch size); "
                        "eval items are independent, so large batches are "
                        "pure occupancy — presets default to 64")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    # model/objective knobs mirroring the reference parser
    # (VLN-HAMT/finetune_src/r2r/parser.py:107-129, VLN-DUET map_nav_src
    # parser): each released run-script config is one CLI line
    p.add_argument("--fusion", choices=["dynamic", "avg", "local", "global"],
                   default=None, help="DUET branch fusion (parser.py)")
    p.add_argument("--train-alg",
                   choices=["imitation", "dagger", "sample"], default=None,
                   help="imitation/dagger (DUET) or sample = IL+RL (HAMT)")
    p.add_argument("--aux-loss-type",
                   choices=["cosine", "infonce", "margin"], default=None)
    p.add_argument("--cosine-weight", type=float, default=None)
    p.add_argument("--infonce-temperature", type=float, default=None)
    p.add_argument("--contrastive-margin", type=float, default=None)
    p.add_argument("--act-pred-token", default=None,
                   choices=["ob", "ob_txt", "ob_hist", "ob_txt_hist",
                            "ob_imagine_text"])
    p.add_argument("--expl-sample", action="store_true",
                   help="DUET dagger exploration sampling (agent.py:555-565)")
    p.add_argument("--expl-max-ratio", type=float, default=None)
    p.add_argument("--ml-weight", type=float, default=None)
    p.add_argument("--ob-type", choices=["pano", "cand"], default=None,
                   help="HAMT observation tokens: candidates+stop+views "
                        "(pano, released) or candidates+stop only (cand)")
    p.add_argument("--no-cand-backtrack", action="store_true",
                   help="mask candidates leading to visited nodes "
                        "(agent_cmt.py:549-558)")
    p.add_argument("--act-visited-nodes", action="store_true",
                   help="DUET: allow acting on visited graph nodes "
                        "(agent.py:109)")
    p.add_argument("--detailed-output", action="store_true",
                   help="DUET: write per-node stop logits into the "
                        "submission 'details' field (main_nav.py:384)")
    p.add_argument("--no-lang-ca", action="store_true",
                   help="text is not updated by cross-modal attention "
                        "(parser.py --no_lang_ca; the released REVERIE "
                        "recipe and NavRefCMT semantics)")
    p.add_argument("--fix-lang-embedding", dest="fix_lang_embedding",
                   action="store_true", default=None,
                   help="freeze the language encoder output")
    p.add_argument("--train-lang-embedding", dest="fix_lang_embedding",
                   action="store_false",
                   help="fine-tune the language encoder (overrides a "
                        "preset's freeze)")
    p.add_argument("--no-cosine-aux-loss", action="store_true")
    p.add_argument("--no-imagination", action="store_true",
                   help="disable the imagination modality entirely")
    p.add_argument("--imagination-v1", action="store_true",
                   help="v1 imagination features: densely packed per "
                        "instruction, no generated-flag JSON "
                        "(_create_diffusion_imaginations, agent_cmt.py:217)")
    # data
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--connectivity-dir")
    p.add_argument("--anno-dir")
    p.add_argument("--img-features")
    # REVERIE/SOON object grounding data (reverie/data_utils.py:9-124)
    p.add_argument("--obj-features",
                   help="HDF5 '<scan>_<viewpoint>' object features")
    p.add_argument("--obj-bbox-file",
                   help="BBoxes json for obj2vps goal viewpoints")
    p.add_argument("--max-objects", type=int, default=20)
    p.add_argument("--imagine-features")
    p.add_argument("--sub-instr-file")
    p.add_argument("--generated-flag-file")
    # on-the-fly ViT extraction of raw imagination images (BASELINE config 4)
    p.add_argument("--e2e-imagination", choices=["off", "frozen", "trainable"],
                   default="off")
    p.add_argument("--imagine-image-bank",
                   help=".npy of preprocessed images (RawImaginationImageBank)")
    p.add_argument("--imagine-image-index",
                   help="json {instr_id: [lo, hi]} row ranges into the bank")
    p.add_argument("--aug", default=None,
                   help="augmented annotations (split name or direct json "
                        "path): training alternates one GT iteration with "
                        "one aug iteration (main.py:281-302); with "
                        "--synthetic any value enables a no-imagination "
                        "aug copy of the train split")
    p.add_argument("--splits", nargs="+",
                   default=["train", "val_seen", "val_unseen"])
    p.add_argument("--resume")
    p.add_argument("--init-from-reference",
                   help="released torch agent checkpoint (.pt) in the "
                        "{vln_bert, critic} x {epoch, state_dict, optimizer} "
                        "format (agent_cmt.py:837-875); loads weights, "
                        "keeps the optimizer state fresh")
    p.add_argument("--init-from-pretrain",
                   help="model_step_<N> snapshot of the port's pre-training "
                        "CLI (scripts/pretrain.py); "
                        "grafts the shared submodules into the fine-tune "
                        "model (vlnbert_init.py:20-31 init chain)")
    p.add_argument("--bert-ckpt-file",
                   help="released torch PRE-TRAIN checkpoint "
                        "(flat model_step_<N>.pt state_dict) — the "
                        "reference's --bert_ckpt_file on-ramp "
                        "(vlnbert_init.py:20-31)")
    # device mesh (replaces the reference's DDP world_size flag): batch
    # shards over 'data', large kernels over 'model' when >1
    p.add_argument("--mesh-data", type=int, default=0,
                   help="data-parallel axis size (0 = single device)")
    p.add_argument("--mesh-model", type=int, default=1)
    # inference mode (the reference's valid()-from-checkpoint entry,
    # main.py:370-421): evaluate every val split and exit
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--eval-first", action="store_true",
                   help="validate before training starts (main.py:167)")
    p.add_argument("--submit", action="store_true",
                   help="write submit_<env>.json + individual metrics during "
                        "validation (needs --connectivity-dir graphs)")
    return p.parse_args(argv)


def refuse_unported(args) -> None:
    """Exit, naming the ROADMAP Queue 1 item that will port it, for a flag
    whose branch the port does not have yet."""
    unported = [
        (args.mesh_data, "--mesh-data", 7),
    ]
    for bad, flag, item in unported:
        if bad:
            raise SystemExit(
                f"{flag} is not ported yet: ROADMAP Queue 1 item {item}")


def preset(args, device):
    """The config a run starts from: the per-dataset preset, which carries
    the right env capacities (gt-path buffer, action horizon, instruction
    length; the long-path variants overflow the R2R defaults), or with
    `--synthetic` off the card the tiny test preset.  On the card
    `--synthetic` keeps the dataset's preset, since the tiny preset's head
    dim (16) is not one the attention kernels take (32, 64, 128)."""
    from vln_imagine_tpu_torch.config import (
        cvdn_config,
        duet_r2r_config,
        hamt_r2r_config,
        r4r_config,
        reverie_config,
        rxr_config,
        soon_config,
        tiny_test_config,
    )

    if args.synthetic and device.type != "cuda":
        return tiny_test_config(args.agent)
    if args.dataset == "soon":
        return soon_config()
    if args.dataset == "reverie":
        return reverie_config(args.agent)
    if args.dataset == "rxr" and args.agent == "hamt":
        return rxr_config()
    if args.dataset == "r4r":
        return r4r_config(args.agent)
    if args.dataset == "cvdn":
        return cvdn_config()
    return hamt_r2r_config() if args.agent == "hamt" else duet_r2r_config()


def build_synthetic(cfg):
    from vln_imagine_tpu_torch.driver import SplitData
    from vln_imagine_tpu_torch.envx import synthetic_episodes, synthetic_world

    world, graphs = synthetic_world(
        num_scans=4, num_nodes=48, max_candidates=cfg.env.max_candidates,
        views=cfg.env.views, feat_dim=cfg.model.image_feat_size, seed=0)

    def split(name, n, seed):
        ep = synthetic_episodes(
            world, batch=n, max_gt_path_len=cfg.env.max_gt_path_len,
            max_instr_len=cfg.env.max_instr_len,
            max_imaginations=cfg.model.max_imagination_len,
            vocab_size=cfg.model.vocab_size,
            feat_dim=cfg.model.hidden_size, seed=seed,
            imagine_image_size=(cfg.model.e2e_vit_image_size
                                if cfg.model.e2e_imagination != "off"
                                else None))
        return SplitData(name, ep, [f"{name}_{i}" for i in range(n)])

    return world, split("train", 64, 1), [split("val_seen", 16, 2),
                                          split("val_unseen", 16, 3)], graphs


def build_real(cfg, args):
    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.data.annotations import (
        AuxMetadata,
        construct_instrs,
        episodes_from_annotations,
        ndh_episodes_from_annotations,
    )
    from vln_imagine_tpu_torch.data.features import (
        ImageFeaturesDB,
        ImaginationImageFeaturesDB,
        ObjectFeatureDB,
        build_feature_table,
        build_imagination_arrays,
        build_imagination_arrays_v1,
        build_object_tables,
    )
    from vln_imagine_tpu_torch.driver import SplitData
    from vln_imagine_tpu_torch.envx.compiler import (
        compile_world,
        load_connectivity,
    )

    all_items = {s: construct_instrs(args.anno_dir, args.dataset, [s])
                 for s in args.splits}
    # augmented instructions (main.py:98-101): a split name or a direct
    # path to an aug json; aug_flag keeps every instruction per path
    aug_items = None
    if getattr(args, "aug", None):
        aug_items = construct_instrs(args.anno_dir, args.dataset,
                                     [args.aug], aug_flag=True)
    # size the gt-path buffer from the data: the presets carry known caps,
    # but guide paths are not length-bounded in every dataset (RxR follows
    # annotator walks, not shortest paths), so an overflowing split
    # auto-raises the capacity instead of aborting at episode build.
    # cvdn is excluded: its supervision paths are resampled shortest paths
    # (ndh_episodes_from_annotations) with their own clamp semantics.
    if args.dataset != "cvdn":
        need = max((len(it["path"]) for items in all_items.values()
                    for it in items), default=0)
        if aug_items:
            need = max(need, max(len(it["path"]) for it in aug_items))
        if need > cfg.env.max_gt_path_len:
            print(f"auto-sizing env.max_gt_path_len "
                  f"{cfg.env.max_gt_path_len} -> {need} from the loaded "
                  f"annotations")
            cfg = _replace(cfg, "env", max_gt_path_len=need)
    scans = sorted({it["scan"] for items in all_items.values()
                    for it in items}
                   | ({it["scan"] for it in aug_items} if aug_items
                      else set()))
    graphs = load_connectivity(args.connectivity_dir, scans)

    feat_db = ImageFeaturesDB(args.img_features, cfg.model.image_feat_size)
    feat = build_feature_table(feat_db, graphs, cfg.env.views,
                               cfg.model.image_feat_size)
    world = compile_world(graphs, max_candidates=cfg.env.max_candidates,
                          views=cfg.env.views, feat=feat)
    obj_id_fn = None
    if args.obj_features and cfg.model.obj_feat_size > 0:
        # REVERIE/SOON grounding: dense object tables; table visibility
        # equals the reference's obj2vps map (reverie/data_utils.py:113-124)
        obj_db = ObjectFeatureDB(args.obj_features, cfg.model.obj_feat_size)
        o_feat, o_ang, o_valid, o_ids, o_pos, id_of = build_object_tables(
            obj_db, graphs, args.max_objects, cfg.model.obj_feat_size,
            max_nodes=world.node_xyz.shape[1],
            bbox_format="xyxy" if args.dataset == "soon" else "xywh")
        world = world.replace(obj_feat=o_feat, obj_ang=o_ang,
                              obj_valid=o_valid, obj_ids=o_ids, obj_pos=o_pos)

        def obj_id_fn(raw):
            try:
                return int(raw)
            except (TypeError, ValueError):
                return id_of.get(str(raw), 0)

    meta = AuxMetadata.load(args.sub_instr_file, args.generated_flag_file)
    imag_db = (ImaginationImageFeaturesDB(args.imagine_features,
                                          cfg.model.hidden_size)
               if args.imagine_features else None)
    image_bank = None
    if cfg.model.e2e_imagination != "off":
        import json

        from vln_imagine_tpu_torch.data.features import (
            RawImaginationImageBank,
        )
        if not (args.imagine_image_bank and args.imagine_image_index):
            raise SystemExit("--e2e-imagination needs --imagine-image-bank "
                             "and --imagine-image-index")
        with open(args.imagine_image_index) as f:
            index = {k: tuple(v) for k, v in json.load(f).items()}
        image_bank = RawImaginationImageBank(
            args.imagine_image_bank, index, cfg.model.e2e_vit_image_size)

    def make_split(name):
        items = all_items[name]
        if args.dataset == "cvdn":
            # NDH: sampled-goal shortest-path supervision + goal-pano list
            # for goal-progress eval (NDHNavBatch, cvdn/env.py:30-130)
            ep, ids, end_panos = ndh_episodes_from_annotations(
                items, graphs, cfg.env.max_instr_len,
                cfg.env.max_gt_path_len, cfg.model.max_imagination_len,
                rng=np.random.default_rng(cfg.train.seed),
                use_player_path=(name == "train"))
            return SplitData(name, ep, ids, end_panos=end_panos)
        instr_ids = [it["instr_id"] for it in items]
        imagine = images = mask_override = None
        if image_bank is not None and meta.generated_flags:
            images, _ = image_bank.batch_images(
                instr_ids, meta.generated_flags,
                cfg.model.max_imagination_len)
        elif imag_db is not None and not cfg.model.imagination_data_v2:
            # v1: densely packed features, first-n mask, no flag JSON
            imagine, mask_override = build_imagination_arrays_v1(
                imag_db, instr_ids, cfg.model.max_imagination_len,
                cfg.model.hidden_size)
        elif imag_db is not None and meta.generated_flags:
            imagine, _ = build_imagination_arrays(
                imag_db, instr_ids, meta.generated_flags,
                cfg.model.max_imagination_len, cfg.model.hidden_size)
        ep, ids = episodes_from_annotations(
            items, graphs, meta, cfg.env.max_instr_len,
            cfg.env.max_gt_path_len, cfg.model.max_imagination_len, imagine,
            imagine_images=images, imagine_mask_override=mask_override,
            obj_id_fn=obj_id_fn, imagine_feat_dim=cfg.model.hidden_size)
        return SplitData(name, ep, ids)

    train = make_split(args.splits[0])
    vals = [make_split(s) for s in args.splits[1:]]
    aug = None
    if aug_items:
        # aug data carries no imagination annotations: episodes get an
        # all-False imagine_mask, zeroing the modality through the additive
        # attention masks (the reference flips imagine_enc_pano instead,
        # main.py:289-300)
        ep, ids = episodes_from_annotations(
            aug_items, graphs, AuxMetadata(), cfg.env.max_instr_len,
            cfg.env.max_gt_path_len, cfg.model.max_imagination_len,
            obj_id_fn=obj_id_fn, imagine_feat_dim=cfg.model.hidden_size)
        aug = SplitData("aug", ep, ids)
    # cfg comes back too: the gt-path capacity may have been auto-sized
    # from the annotations above
    return cfg, world, train, vals, graphs, aug


def model_overrides(args, cfg) -> dict:
    """CLI flags -> ModelConfig overrides, with combination guards."""
    model_over = {}
    for k in ("fusion", "aux_loss_type", "act_pred_token", "cosine_weight"):
        v = getattr(args, k, None)
        if v is not None:
            model_over[k] = v
    if args.infonce_temperature is not None:
        model_over["infonce_temperature"] = args.infonce_temperature
    if args.contrastive_margin is not None:
        model_over["contrastive_margin_value"] = args.contrastive_margin
    if args.no_cosine_aux_loss:
        model_over["use_cosine_aux_loss"] = False
    if args.no_imagination:
        model_over["imagine_enc_pano"] = False
        model_over["use_cosine_aux_loss"] = False
    if args.no_lang_ca:
        if args.agent != "hamt":
            raise SystemExit(
                "--no-lang-ca is a HAMT-stack flag (the DUET model has no "
                "language cross-attention toggle)")
        imagine_on = model_over.get("imagine_enc_pano",
                                    cfg.model.imagine_enc_pano)
        concat = cfg.model.concat_imagine_with
        if imagine_on and concat == "language":
            raise SystemExit(
                "--no-lang-ca cannot combine with language-concatenated "
                "imagination (the reference path is inconsistent for this "
                "combo); pass --no-imagination, or a preset whose "
                "concat_imagine_with is 'visual'/'off'")
        aux_on = model_over.get("use_cosine_aux_loss",
                                cfg.model.use_cosine_aux_loss)
        if aux_on:
            raise SystemExit(
                "--no-lang-ca needs --no-cosine-aux-loss (the aux loss "
                "consumes single-tensor text embeddings; under no_lang_ca "
                "the language mode returns a per-layer stack)")
        model_over["no_lang_ca"] = True
    if args.fix_lang_embedding is not None:
        model_over["fix_lang_embedding"] = args.fix_lang_embedding
    if args.imagination_v1:
        model_over["imagination_data_v2"] = False
    if args.e2e_imagination != "off":
        model_over["e2e_imagination"] = args.e2e_imagination
    return model_over


def main(argv=None):
    args = parse_args(argv)
    refuse_unported(args)
    from vln_imagine_tpu_torch.config import _replace
    from vln_imagine_tpu_torch.driver import FinetuneDriver, SplitData
    from vln_imagine_tpu_torch.platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"train: {e} (pass --device cpu)") from None
    cfg = preset(args, device).replace(dataset=args.dataset)
    overrides = {}
    for k in ("iters", "log_every", "batch_size", "eval_batch_size", "lr",
              "train_alg", "ml_weight", "expl_max_ratio"):
        v = getattr(args, k, None)
        if v is not None:
            overrides[k] = v
    overrides["seed"] = args.seed
    if args.expl_sample:
        overrides["expl_sample"] = True
    if args.no_cand_backtrack:
        overrides["no_cand_backtrack"] = True
    if args.act_visited_nodes:
        overrides["act_visited_nodes"] = True
    if args.detailed_output:
        overrides["detailed_output"] = True
    if args.ob_type is not None:
        cfg = _replace(cfg, "env", ob_type=args.ob_type)
    # the reference maps train_alg='sample' to the HAMT IL+RL feedback
    # (agent_cmt.py:799); imitation/dagger are the DUET algorithms
    cfg = _replace(cfg, "train", **overrides)
    model_over = model_overrides(args, cfg)
    if model_over:
        cfg = _replace(cfg, "model", **model_over)

    if args.synthetic:
        tables, train, vals, graphs = build_synthetic(cfg)
        aug = None
        if args.aug:
            # synthetic smoke path: the train episodes with the imagination
            # modality masked off (aug data has no imaginations)
            aug = SplitData("aug", dataclasses.replace(
                train.episodes,
                imagine_mask=np.zeros_like(train.episodes.imagine_mask)),
                train.instr_ids)
    else:
        cfg, tables, train, vals, graphs, aug = build_real(cfg, args)

    driver = FinetuneDriver(cfg, tables, train, vals, args.log_dir,
                            graphs=graphs, aug_split=aug, device=device)
    driver.setup()
    if args.init_from_reference:
        info = driver.init_from_reference(args.init_from_reference)
        print(f"initialized from reference checkpoint "
              f"{args.init_from_reference} (epoch {info['epoch']}, "
              f"{len(info['skipped'])} keys skipped)")
    if args.init_from_pretrain:
        info = driver.init_from_pretrain(args.init_from_pretrain)
        print(f"initialized from pretrain snapshot "
              f"{args.init_from_pretrain} ({info['transferred']} leaves "
              f"transferred, {len(info['missing'])} finetune-only modules "
              f"at init)")
    if args.bert_ckpt_file:
        info = driver.init_from_bert_ckpt(args.bert_ckpt_file)
        print(f"initialized from torch pretrain checkpoint "
              f"{args.bert_ckpt_file} ({info['transferred']} leaves "
              f"transferred, {len(info['skipped'])} pretrain-only keys "
              f"skipped)")
    if args.resume:
        driver.load_checkpoint(args.resume)
    if args.eval_only:
        for split in vals:
            score = driver.validate(split, write_outputs=args.submit)
            print(f"{split.name}: "
                  + ", ".join(f"{k}={v:.2f}" for k, v in score.items()))
        return driver
    if args.eval_first:
        # validate the initial weights before any training (main.py:167)
        for split in vals:
            score = driver.validate(split)
            print(f"[eval_first] {split.name}: "
                  + ", ".join(f"{k}={v:.2f}" for k, v in score.items()))
    driver.run(iters=args.iters, log_every=args.log_every)
    return driver


if __name__ == "__main__":
    main()
