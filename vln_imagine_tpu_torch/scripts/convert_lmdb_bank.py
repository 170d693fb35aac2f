"""Convert the reference's LMDB raw-image store into a RawPanoramaBank.

The port's copy of the JAX package's scripts/convert_lmdb_bank.py, over
the port's own LMDB reader, annotations and connectivity loader; its bank
is byte-for-byte the JAX script's.

The released E2E pre-training data (VLN-HAMT) is an LMDB environment whose
entries are "<scan>_<viewpoint>" -> raw uint8 (36, 248, 330, 3) panorama
views (VLN-HAMT/pretrain_src/data/image_data.py:20-22,60-66,225-231).  This
framework's E2E image stack reads an mmap .npy bank [S, N, V, h, w, 3]
float32 aligned with the compiled world's (scan, node) indexing
(data/features.py:RawPanoramaBank), so day one with the real data is:

    python -m vln_imagine_tpu_torch.scripts.convert_lmdb_bank \
        --lmdb <img_db_dir_or_file> --connectivity-dir <connectivity/> \
        --out panos.npy [--scans <scan> ... | --anno-dir <dir> \
        --dataset r2r --splits train val_seen val_unseen]

then `python -m vln_imagine_tpu_torch.scripts.pretrain --e2e
--raw-panorama-bank panos.npy`.

Each view is preprocessed exactly like the reference's *evaluation*
transform (image_data.py:70-80: timm create_transform with crop_pct 0.9,
bicubic, mean=std=0.5): resize the shorter side to floor(size/0.9), center
crop `size`, scale to [-1, 1].  At the released geometry (248x330 -> 224)
the resize is the identity and the crop is a pure slice, so conversion is
lossless up to the uint8->float scaling.  (The reference's train-time
random augmentation operates on raw pixels per step; bake-time
preprocessing trades that for zero per-step host work, which is the bank's
point — note the divergence if you need RandAugment parity.)

The LMDB file is parsed by the pure-python reader in
vln_imagine_tpu_torch/data/lmdb_reader.py (no `lmdb` package needed); scan
order follows the same rule as the trainer (scripts/train.py: sorted set
of annotation scans) so bank indices line up.  A store at another geometry
needs Pillow for the bicubic resize; without it the conversion stops and
says so.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from vln_imagine_tpu_torch.data.lmdb_reader import LmdbReader

VIEWS = 36
SRC_H, SRC_W = 248, 330  # image_data.py:20-21


def preprocess_view(frame: np.ndarray, size: int,
                    crop_pct: float = 0.9) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [size, size, 3] in [-1, 1], matching the
    reference eval transform (Resize(shorter->floor(size/crop_pct),
    bicubic) + CenterCrop(size) + Normalize(0.5, 0.5))."""
    h, w = frame.shape[:2]
    scale = int(math.floor(size / crop_pct))
    if min(h, w) != scale:
        try:
            from PIL import Image
        except ImportError:
            raise SystemExit(
                f"convert_lmdb_bank: views of {h}x{w} need a bicubic resize "
                f"to a shorter side of {scale}, which needs Pillow; it is "
                "not installed (the released 248x330 store at --image-size "
                "224 needs no resize)") from None
        if h <= w:
            nh, nw = scale, int(round(scale * w / h))
        else:
            nw, nh = scale, int(round(scale * h / w))
        frame = np.asarray(Image.fromarray(frame).resize(
            (nw, nh), Image.BICUBIC))
        h, w = frame.shape[:2]
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    crop = frame[top:top + size, left:left + size]
    return crop.astype(np.float32) / 127.5 - 1.0


def derive_scans(args) -> list[str]:
    if args.scans:
        return list(args.scans)
    if args.anno_dir:
        from vln_imagine_tpu_torch.data.annotations import construct_instrs
        scans = set()
        for s in args.splits:
            for it in construct_instrs(args.anno_dir, args.dataset, [s]):
                scans.add(it["scan"])
        return sorted(scans)
    # fall back to every scan present in the store
    with LmdbReader(args.lmdb) as db:
        return sorted({k.decode("ascii").rsplit("_", 1)[0]
                       for k in db.keys()})


def convert(args) -> dict:
    from vln_imagine_tpu_torch.envx.compiler import load_connectivity

    scans = derive_scans(args)
    graphs = load_connectivity(args.connectivity_dir, scans)
    N = max(g.num_nodes for g in graphs)
    S, V, size = len(graphs), args.views, args.image_size
    bank = np.lib.format.open_memmap(
        args.out, mode="w+", dtype=np.float32, shape=(S, N, V, size, size, 3))
    converted = missing = 0
    with LmdbReader(args.lmdb) as db:
        for s, g in enumerate(graphs):
            for i, vp in enumerate(g.node_ids):
                key = f"{g.scan_id}_{vp}".encode("ascii")
                buf = db.get(key)
                if buf is None:
                    if not args.allow_missing:
                        raise KeyError(
                            f"viewpoint {key.decode()} not in {args.lmdb} "
                            "(pass --allow-missing to zero-fill)")
                    missing += 1
                    continue
                frames = np.frombuffer(buf, np.uint8).reshape(
                    V, args.src_height, args.src_width, 3)
                for v in range(V):
                    bank[s, i, v] = preprocess_view(frames[v], size,
                                                    args.crop_pct)
                converted += 1
            print(f"# {g.scan_id}: {g.num_nodes} viewpoints",
                  file=sys.stderr)
    bank.flush()
    meta = {"out": args.out, "scans": scans, "shape": list(bank.shape),
            "image_size": size, "converted": converted, "missing": missing,
            "source": args.lmdb}
    with open(args.out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="LMDB raw-image store -> RawPanoramaBank mmap .npy")
    p.add_argument("--lmdb", required=True,
                   help="LMDB environment dir (with data.mdb) or the "
                        "data file itself")
    p.add_argument("--out", required=True, help="output .npy bank path")
    p.add_argument("--connectivity-dir", required=True)
    p.add_argument("--scans", nargs="*", default=None,
                   help="explicit scan order (default: from --anno-dir, "
                        "else every scan in the store, sorted)")
    p.add_argument("--anno-dir")
    p.add_argument("--dataset", default="r2r")
    p.add_argument("--splits", nargs="*",
                   default=["train", "val_seen", "val_unseen"])
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--crop-pct", type=float, default=0.9)
    p.add_argument("--views", type=int, default=VIEWS)
    p.add_argument("--src-height", type=int, default=SRC_H)
    p.add_argument("--src-width", type=int, default=SRC_W)
    p.add_argument("--allow-missing", action="store_true",
                   help="zero-fill viewpoints absent from the store "
                        "instead of raising")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    meta = convert(parse_args(argv))
    print(json.dumps(meta))
    return meta


if __name__ == "__main__":
    main()
