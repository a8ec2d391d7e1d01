"""Qualitative demo and attention visualization of the port, the port of
``vqa_tpu/cli/visu.py``.

  python -m vqa_tpu_torch.cli.visu --dir_logs logs/vqa2/mutan_att \\
      --image COCO_val2014_000000000042 \\
      --question "What color is the cat?" [--resume best] [--out attention.png] \\
      [--platform cpu]

Loads the run's checkpoint through the port's Predictor (config from the
run dir's options.yaml unless --path_opt overrides), prints the top-k
answers, and with --out writes a per-region attention heatmap (matplotlib,
imported only then): the glimpse maps of the attention and MFB families,
CoR's per-step object attention. The NoAtt family has no map.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch


def attention_map(predictor, question: str, image: str) -> Optional[np.ndarray]:
    """The arch's attention over the image's regions for one question,
    ``[R, G]`` in float32 (G glimpses; CoR: its chain steps), or None for an
    arch without one (the NoAtt family)."""
    from vqa_tpu_torch.ops.gather import gather_rows

    rows = predictor.dataset.index_of([image])
    visual = gather_rows(predictor.table, rows).to(predictor.device)
    q, lengths = predictor.encode_questions([question])
    with torch.inference_mode():
        try:
            _, alpha = predictor.model(visual, q, lengths, return_attention=True)
        except TypeError:  # archs without an attention map (the noatt family;
            return None    # att/MFB expose glimpse maps, CoR per-step object maps)
    return alpha[0].float().cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir_logs", required=True, help="run dir (holds options.yaml + ckpt/)")
    p.add_argument("--path_opt", default=None, help="optional config override path")
    p.add_argument("--resume", default="best")
    p.add_argument("--image", required=True, help="image name in the feature store")
    p.add_argument("--question", required=True)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--out", default=None, help="attention heatmap png path")
    p.add_argument("--opt", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to run: the card (default) or, with cpu, the host")
    args = p.parse_args(argv)
    if args.platform not in (None, "cuda", "gpu", "cpu"):
        p.error(f"--platform {args.platform!r}: the port runs on the card (cuda) or, with "
                "--platform cpu, on the host")

    from vqa_tpu_torch.predictor import Predictor

    predictor = Predictor.from_run(
        args.dir_logs, args.path_opt, resume=args.resume, overrides=args.opt,
        device="cpu" if args.platform == "cpu" else "cuda",
    )
    print(f"Q: {args.question}")
    for answer, prob in predictor.answer(args.question, args.image, topk=args.topk):
        print(f"  {answer:20s} {prob:.3f}")

    if args.out:
        a = attention_map(predictor, args.question, args.image)  # [R, G]
        if a is None:
            print("arch has no attention map; skipping --out")
            return 0

        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, a.shape[1], figsize=(4 * a.shape[1], 3))
        axes = np.atleast_1d(axes)
        for g, ax in enumerate(axes):
            side = int(np.sqrt(a.shape[0]))
            if side * side == a.shape[0]:  # grid features -> heatmap
                ax.imshow(a[:, g].reshape(side, side), cmap="viridis")
            else:  # region features -> bar chart
                ax.bar(np.arange(a.shape[0]), a[:, g])
            ax.set_title(f"glimpse {g}")
        fig.suptitle(args.question)
        fig.savefig(args.out, bbox_inches="tight", dpi=100)
        print(f"attention map -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
