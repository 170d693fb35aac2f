"""Pre-training entry point of the port (the reference's
VLN-HAMT/pretrain_src/main_r2r.py and main_r2r_image.py, and
VLN-DUET/pretrain_src/train_r2r.py), with the flags of the JAX package's
scripts/pretrain.py.

HAMT's six-task mix (mlm/sap/sar/sprel/mrc/itm 5:1:1:1:2:2,
config/pretrain_r2r.json) over stored trajectories, on view features or,
with `--e2e`, on raw panorama images through the in-model ViT; DUET's
three-task mix (mlm/mrc/sap 1:1:1 at batch 64 for 100,000 steps,
config/r2r_pretrain.json; `--tasks ... og` on REVERIE / SOON) over the
same trajectories with their topological maps.  `--init-ckpt` starts
from BERT weights, or for DUET from LXMERT's (`--init-pretrained
lxmert`, the released recipe).  Snapshots
are `model_step_<N>` (the model's state_dict, the reference's ModelSaver
naming, pretrain_src/utils/save.py:23-46) beside `train_state_<N>` (step and
optimizer, for `--resume`); `scripts.train --init-from-pretrain` grafts a
snapshot into fine-tuning.

Real data, on the card (the features go through the native prefetching
bank unless `--no-prefetch`):
  python -m vln_imagine_tpu_torch.scripts.pretrain --agent hamt \\
      --connectivity-dir .../connectivity --anno-dir .../annotations \\
      --img-features .../vit_features.hdf5 --steps 200000
  python -m vln_imagine_tpu_torch.scripts.pretrain --agent duet \\
      --connectivity-dir .../connectivity --anno-dir .../annotations \\
      --img-features .../vit_features.hdf5 \\
      --init-ckpt .../model_LXRT.pth --init-pretrained lxmert

Synthetic smoke run on the CPU:
  python -m vln_imagine_tpu_torch.scripts.pretrain --agent duet --synthetic \\
      --steps 4 --log-steps 2 --valid-steps 2 --device cpu

Everything runs on the card unless `--device` names another device; with
no CUDA and no `--device` the CLI exits.  `--synthetic` takes the tiny test
preset off the card and the agent's released preset on it (the tiny
preset's head dim is not one the attention kernels take).  `--e2e` is
HAMT's driver alone (main_r2r_image.py has no DUET sibling).
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--agent", choices=["hamt", "duet"], default="hamt")
    p.add_argument("--dataset", default="r2r",
                   choices=["r2r", "r4r", "rxr", "reverie", "soon"])
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--log-dir", default="logs/pretrain")
    p.add_argument("--steps", type=int, default=None,
                   help="total optimizer updates (default: config budget)")
    p.add_argument("--log-steps", type=int, default=None)
    p.add_argument("--valid-steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tasks", nargs="+", default=None,
                   help="override the task list, e.g. --tasks mlm sap")
    p.add_argument("--mix-ratio", nargs="+", type=int, default=None)
    p.add_argument("--image-prob-size", type=int, default=1000,
                   help="ViT class-prob size of the MRC soft labels "
                        "(r2r_model_config.json image_prob_size)")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="gradient accumulation micro-steps per optimizer "
                        "update (main_r2r.py:240-280)")
    # E2E image pre-training (main_r2r_image.py); --raw-panorama-bank
    # implies --e2e
    p.add_argument("--e2e", action="store_true",
                   help="six-task E2E image pre-training with the ViT in "
                        "the loop; with --synthetic a random in-memory "
                        "panorama bank is made")
    p.add_argument("--raw-panorama-bank",
                   help="mmap'd .npy [S, N, V, h, w, 3] of preprocessed "
                        "panorama views aligned with the compiled world "
                        "(RawPanoramaBank)")
    p.add_argument("--image-size", type=int, default=224,
                   help="E2E input image side (ViT-B/16: 224)")
    p.add_argument("--vit-init",
                   help="timm vit_base_patch16_224 state_dict (.pth) to "
                        "initialize the in-model ViT from")
    p.add_argument("--vit-layers", type=int, default=12)
    p.add_argument("--vit-hidden", type=int, default=768)
    p.add_argument("--vit-heads", type=int, default=12)
    p.add_argument("--vit-patch", type=int, default=16)
    # data
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--connectivity-dir")
    p.add_argument("--anno-dir")
    p.add_argument("--img-features")
    p.add_argument("--split", default="train")
    p.add_argument("--no-prefetch", action="store_true",
                   help="read the features synchronously instead of through "
                        "the native prefetching feature bank (real data)")
    p.add_argument("--val-splits", nargs="*", default=None,
                   help="held-out validation splits (reference default: "
                        "val_seen val_unseen, main_r2r.py:303-316)")
    p.add_argument("--resume",
                   help="model_step_<N> snapshot to continue from (its "
                        "train_state_<N> beside it)")
    p.add_argument("--init-ckpt",
                   help="torch BERT weights (.pt/.pth/.bin state_dict) to "
                        "initialize pre-training from (main_r2r.py:131-147)")
    p.add_argument("--init-pretrained", default="auto",
                   choices=["auto", "bert", "bert-verbatim", "lxmert"],
                   help="format of --init-ckpt; 'lxmert' (model_LXRT.pth) "
                        "and 'bert-verbatim' (the reference's embeddings-"
                        "only BERT transfer, train_r2r.py:110-119) are DUET "
                        "sources")
    return p.parse_args(argv)


def config(args, device):
    """The run's config: the preset (see the module docstring) with the
    E2E image width, DUET's task set and the CLI's pre-training
    overrides."""
    from vln_imagine_tpu_torch.config import (
        _replace,
        duet_r2r_config,
        hamt_r2r_config,
        tiny_test_config,
    )

    if args.synthetic and device.type != "cuda":
        cfg = tiny_test_config(args.agent)
    else:
        cfg = hamt_r2r_config() if args.agent == "hamt" else duet_r2r_config()
    cfg = cfg.replace(dataset=args.dataset)
    if args.e2e:
        if args.agent != "hamt":
            raise SystemExit("--e2e is the HAMT image pre-training driver "
                             "(main_r2r_image.py has no DUET sibling)")
        # features come out of the in-model ViT: the image width is its
        cfg = _replace(cfg, "model", image_feat_size=args.vit_hidden)
    if args.agent == "duet":
        # DUET's task set (r2r_pretrain.json:43-50)
        cfg = _replace(cfg, "pretrain", tasks=("mlm", "mrc", "sap"),
                       mix_ratio=(1, 1, 1), batch_size=64,
                       num_train_steps=100_000)
    over = {"seed": args.seed}
    for flag, key in (("steps", "num_train_steps"), ("log_steps", "log_steps"),
                      ("valid_steps", "valid_steps"),
                      ("batch_size", "batch_size"), ("lr", "lr"),
                      ("grad_accum", "gradient_accumulation_steps")):
        if getattr(args, flag) is not None:
            over[key] = getattr(args, flag)
    if args.tasks is not None:
        over["tasks"] = tuple(args.tasks)
        over["mix_ratio"] = tuple(args.mix_ratio or [1] * len(args.tasks))
    elif args.mix_ratio is not None:
        over["mix_ratio"] = tuple(args.mix_ratio)
    return _replace(cfg, "pretrain", **over)


def graft_vit(model, path: str) -> int:
    """Load a timm ViT state_dict into `model` (the in-model ViT), every
    tensor shape-checked; returns the number of source keys skipped."""
    import torch

    from vln_imagine_tpu_torch.ckpt.convert import vit_torch_to_flax_path

    sd = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("state_dict", "model", "module"):
        if isinstance(sd, dict) and isinstance(sd.get(key), dict):
            sd = sd[key]
    sd = {k.removeprefix("module."): v for k, v in sd.items()}
    kept = {k: v for k, v in sd.items() if vit_torch_to_flax_path(k)}
    want = model.state_dict()
    for k, v in want.items():
        if k not in kept:
            raise ValueError(f"--vit-init {path} has no {k}")
        if tuple(kept[k].shape) != tuple(v.shape):
            raise ValueError(
                f"--vit-init shape mismatch at {k}: checkpoint "
                f"{tuple(kept[k].shape)} vs model {tuple(v.shape)} (wrong "
                "image_size / patch geometry?)")
    model.load_state_dict({k: kept[k] for k in want})
    return len(sd) - len(want)


def main(argv=None):
    args = parse_args(argv)
    from vln_imagine_tpu_torch.platform import resolve_device
    from vln_imagine_tpu_torch.scripts.train import build_real, build_synthetic
    from vln_imagine_tpu_torch.utils.logger import write_to_record_file

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"pretrain: {e} (pass --device cpu)") from None
    if args.raw_panorama_bank:
        args.e2e = True
    cfg = config(args, device)

    # trajectory source: the train split's episodes over the compiled world
    # (MultiStepNavData loads the same annotations, r2r_data.py:95)
    val_splits = []
    if args.synthetic:
        tables, train, vals, _ = build_synthetic(cfg)
        if args.val_splits is not None:
            val_splits = [v for v in vals if v.name in args.val_splits]
    else:
        val_names = (args.val_splits if args.val_splits is not None
                     else ["val_seen", "val_unseen"])
        args.splits = [args.split] + val_names
        args.imagine_features = None
        args.obj_features = None
        args.sub_instr_file = getattr(args, "sub_instr_file", None)
        args.generated_flag_file = getattr(args, "generated_flag_file", None)
        args.aug = None  # aug alternation is a fine-tune concept
        cfg, tables, train, val_splits, _, _ = build_real(cfg, args)

    from vln_imagine_tpu_torch.pretrain.trainer import (
        DuetPretrainer,
        E2EPretrainer,
        HamtPretrainer,
    )
    os.makedirs(args.log_dir, exist_ok=True)
    if args.e2e:
        from vln_imagine_tpu_torch.models.vit import ViTConfig

        vit_cfg = ViTConfig(image_size=args.image_size,
                            patch_size=args.vit_patch,
                            hidden_size=args.vit_hidden,
                            num_layers=args.vit_layers,
                            num_heads=args.vit_heads,
                            compute_dtype=cfg.model.compute_dtype)
        if args.raw_panorama_bank:
            from vln_imagine_tpu_torch.data.features import RawPanoramaBank
            images = RawPanoramaBank(args.raw_panorama_bank, args.image_size)
        elif args.synthetic:
            # a made-up in-memory panorama bank, indexed as the mmap one
            S, N, V = np.asarray(tables.feat).shape[:3]
            images = np.random.default_rng(args.seed).standard_normal(
                (S, N, V, args.image_size, args.image_size, 3)
            ).astype(np.float32)
        else:
            raise SystemExit("--e2e needs --raw-panorama-bank (or "
                             "--synthetic for a smoke run)")
        pt = E2EPretrainer(cfg, tables, train.episodes, images,
                           vit_config=vit_cfg,
                           image_prob_size=args.image_prob_size,
                           seed=args.seed, device=device)
    else:
        bank = None
        if not args.synthetic and not args.no_prefetch:
            # the real-data default: the feature table as an mmap bank whose
            # row gathers overlap the device step (loader.py:90-124)
            from vln_imagine_tpu_torch.native import FeatureBank
            feat = np.asarray(tables.feat)  # [S, N, V, Df]
            bank = FeatureBank.write(
                os.path.join(args.log_dir, "feature_bank.f32"),
                feat.reshape(feat.shape[0] * feat.shape[1], -1))
        cls = HamtPretrainer if args.agent == "hamt" else DuetPretrainer
        pt = cls(cfg, tables, train.episodes,
                 image_prob_size=args.image_prob_size, seed=args.seed,
                 feature_bank=bank, device=device)
    for v in val_splits:
        pt.add_validation_split(v.name, tables, v.episodes, seed=args.seed)
    state = pt.init_state()
    if args.e2e and args.vit_init:
        skipped = graft_vit(pt.model.vit, args.vit_init)
        print(f"initialized ViT from {args.vit_init}: "
              f"{len(pt.model.vit.state_dict())} tensors, {skipped} source "
              "keys skipped")
    if args.init_ckpt:
        from vln_imagine_tpu_torch.ckpt.convert import (
            flax_from_state_dict,
            state_dict_from_flax,
        )
        from vln_imagine_tpu_torch.ckpt.manager import load_pretrain_init
        from vln_imagine_tpu_torch.ckpt.transfer import (
            init_finetune_from_pretrain,
        )
        agent = ("hamt_e2e_pretrain" if args.e2e
                 else f"{args.agent}_pretrain")
        loaded = load_pretrain_init(args.init_ckpt, agent=args.agent,
                                    source=args.init_pretrained)
        new, transferred, _ = init_finetune_from_pretrain(
            flax_from_state_dict(pt.model.state_dict(), agent),
            flax_from_state_dict(loaded["state_dict"],
                                 f"{args.agent}_pretrain"))
        if transferred == 0:
            raise SystemExit(f"no subtree of {args.init_ckpt} matched the "
                             f"{args.agent} pretrain model")
        pt.model.load_state_dict(state_dict_from_flax(new, agent))
        print(f"initialized from {loaded['source']} weights "
              f"{args.init_ckpt}: {transferred} leaves transferred, "
              f"{len(loaded['skipped'])} source keys skipped")
    if args.resume:
        state = pt.resume(args.resume)
    record = os.path.join(args.log_dir, "pretrain.txt")

    def log(msg):
        write_to_record_file(str(msg), record)

    pcfg = cfg.pretrain
    # state.step counts micro-steps; the budget counts optimizer updates
    # (the reference's global_step), so it scales by the accumulation
    accum = max(pcfg.gradient_accumulation_steps, 1)
    total_micro = pcfg.num_train_steps * accum
    while state.step < total_micro:
        chunk = min(pcfg.valid_steps * accum, total_micro - state.step)
        state, _ = pt.train(state, chunk, log_every=pcfg.log_steps * accum,
                            log_fn=log)
        for vname in (pt.val_batchers or {None: None}):
            metrics = pt.validate(state, split=vname)
            tag = f" [{vname}]" if vname else ""
            log(f"valid @ step {state.step}{tag}: "
                + "  ".join(f"{t} loss={m['loss']:.4f} acc={m['acc']:.4f}"
                            for t, m in metrics.items()))
        log(f"saved {pt.save(state, os.path.abspath(args.log_dir))}")
    return pt, state


if __name__ == "__main__":
    main()
