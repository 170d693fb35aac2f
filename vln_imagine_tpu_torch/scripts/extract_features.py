"""ViT feature extraction (the reference's offline HDF5 feature precompute),
with the flags of the JAX package's scripts/extract_features.py.

Raw 36-view panorama images (or imagination images) are embedded by the
port's ViT and written as a feature table (.npy, [N_nodes, V, D], fed into
`WorldTables.feat`) or, with `--bank`, as a native mmap feature bank of one
row per image set:

  python -m vln_imagine_tpu_torch.scripts.extract_features \\
      --images panos.npy --out feats.npy [--vit-ckpt timm_vit.pth] [--bank]

`--images`: .npy of uint8 [N_nodes, V, H, W, 3] or [N, H, W, 3] (uint8 is
normalised with the ImageNet mean and std; float input is taken as already
normalised).  `--vit-ckpt` is a timm vit_base_patch16_224 state_dict;
without it a seeded random ViT-B/16 is used (a pipeline smoke run only).
Runs on the card unless `--device` names another device.
"""

from __future__ import annotations

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--vit-ckpt", help="timm vit_base_patch16_224 torch ckpt")
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--bank", action="store_true",
                   help="write a native mmap feature bank instead of .npy")
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' for the CPU)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from vln_imagine_tpu_torch.ckpt.convert import vit_torch_to_flax_path
    from vln_imagine_tpu_torch.models.vit import (
        FeatureExtractor,
        ViTConfig,
        VisionTransformer,
        preprocess,
    )
    from vln_imagine_tpu_torch.platform import resolve_device

    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"extract_features: {e} (pass --device cpu)") from None
    kw = dict(batch_size=args.batch_size, device=args.device)
    if args.vit_ckpt:
        sd = torch.load(args.vit_ckpt, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        sd = {k.removeprefix("module."): v for k, v in sd.items()}
        kept = {k: v for k, v in sd.items() if vit_torch_to_flax_path(k)}
        if len(kept) < len(sd):
            print(f"note: skipped {len(sd) - len(kept)} non-backbone keys")
        model = VisionTransformer(ViTConfig())
        model.load_state_dict(kept)
        extractor = FeatureExtractor(model, **kw)
    else:
        print("WARNING: no --vit-ckpt; using a randomly initialised ViT")
        extractor = FeatureExtractor.random_init(
            torch.Generator().manual_seed(0), ViTConfig(), **kw)

    images = np.load(args.images)
    x = preprocess(images) if images.dtype == np.uint8 else images
    feats = (extractor.extract_panoramas(x) if x.ndim == 5
             else extractor.extract(x))
    print(f"extracted {feats.shape} features")
    if args.bank:
        from vln_imagine_tpu_torch.native import FeatureBank

        FeatureBank.write(args.out, feats.reshape(feats.shape[0], -1))
        print(f"wrote mmap bank {args.out}")
    else:
        np.save(args.out, feats)
        print(f"wrote {args.out}")
    return feats


if __name__ == "__main__":
    main()
