"""Offline grid-feature extraction CLI of the port, the port of
``vqa_tpu/cli/extract.py``.

  python -m vqa_tpu_torch.cli.extract --dir_images data/coco/val2014 \\
      --dir_out data/coco --arch resnet152 --mode att [--params resnet152.npz] \\
      [--batch 32] [--dtype bfloat16] [--platform cpu]

Reads images (jpg/png via PIL), runs the ResNet forward (models/convnets.py)
in batches on the card (``--platform cpu``: on the host), and writes the
HDF5 + names-json layout the FeatureStore consumes,
``<dir_out>/extract/<arch>_<mode>.h5`` and ``_names.json``, in float32
whatever the compute dtype. ``--params`` takes the flax variables npz
(``python -m vqa_tpu_torch.tools.import_torch --kind resnet152`` converts a
torchvision checkpoint into one); without it the weights are a seeded init.
``extract`` is the body without the decoding and the writing: decoded
images in, (names, features) out.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vqa_tpu_torch.models import convnets

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize(pixels) -> np.ndarray:
    """RGB pixels [H, W, 3] in 0..255 -> float32 normalized with ImageNet's
    mean and std, as the JAX CLI's ``load_image`` computes them."""
    arr = np.asarray(pixels, np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def load_image(path: str, size: int = 448) -> np.ndarray:
    from PIL import Image

    return normalize(Image.open(path).convert("RGB").resize((size, size)))


def extract(model: convnets.ResNet, names: Sequence[str], images: Iterable[np.ndarray],
            mode: str, batch: int, device, progress: bool = False
            ) -> Tuple[List[str], np.ndarray]:
    """Run ``model`` over ``images`` (normalized float32 [size, size, 3]
    arrays, one for each of ``names``, drawn one batch at a time) on
    ``device``; returns the names and the features [N, 196, 2048] ('att')
    or [N, 2048] ('noatt') in float32. The last batch is padded with zero
    images to ``batch``, as the JAX CLI keeps one compiled shape."""
    images, n, feats = iter(images), len(names), []
    with torch.inference_mode():
        for start in range(0, n, batch):
            take = min(batch, n - start)
            chunk = list(itertools.islice(images, take))
            if len(chunk) < take:
                raise ValueError(f"{n} names for {start + len(chunk)} images")
            chunk = np.stack(chunk)
            pad = batch - len(chunk)
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], np.float32)])
            grid = model(torch.from_numpy(chunk).to(device))
            feats.append(convnets.grid_features(grid, mode).float().cpu().numpy()[:batch - pad])
            if progress:
                print(f"\rextracted {start + batch - pad}/{n}", end="", flush=True)
    extra = sum(1 for _ in images)
    if extra:
        raise ValueError(f"{n} names for {n + extra} images")
    if progress:
        print()
    return list(names), np.concatenate(feats)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir_images", required=True)
    p.add_argument("--dir_out", required=True, help="coco dir (writes extract/ inside)")
    p.add_argument("--arch", default="resnet152", choices=sorted(convnets._DEPTHS))
    p.add_argument("--mode", default="att", choices=["att", "noatt"])
    p.add_argument("--params", default=None, help=".npz of flattened param tree")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=448)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"],
                   help="compute dtype for the conv forward (params stay f32). float32 on "
                        "the card runs cuDNN's convs under torch.backends.cudnn.allow_tf32, "
                        "which PyTorch sets true (TF32 products, 10-bit mantissas); this CLI "
                        "leaves it as it finds it. bfloat16 runs the tensor cores at full "
                        "rate, each BatchNorm in float32 rounded to bf16")
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to run: the card (default) or, with cpu, the host")
    args = p.parse_args(argv)
    from vqa_tpu_torch.cli.train import _device

    device = _device(args.platform)

    files = sorted(
        f for f in os.listdir(args.dir_images)
        if f.lower().endswith((".jpg", ".jpeg", ".png"))
    )
    if not files:
        print(f"no images under {args.dir_images}", file=sys.stderr)
        return 1

    compute_dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    model = convnets.factory(args.arch, dtype=compute_dtype)
    if args.params:
        with np.load(args.params) as flat:
            convnets.load_variables(model, flat)
        print(f"loaded params from {args.params}")
    else:
        convnets.init_variables(model, args.seed)
        print("warning: no --params given; extracting with random-init weights")
    model.to(device)

    from vqa_tpu_torch.datasets.features import write_features

    names, feats = extract(
        model, [os.path.splitext(f)[0] for f in files],
        (load_image(os.path.join(args.dir_images, f), args.size) for f in files),
        args.mode, args.batch, device, progress=True)
    path = write_features(args.dir_out, args.arch, args.mode, names, feats)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
