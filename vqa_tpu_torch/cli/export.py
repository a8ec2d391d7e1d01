"""Export CLI of the port: freeze a run into a self-contained serving
artifact, the port of ``vqa_tpu/cli/export.py``.

  python -m vqa_tpu_torch.cli.export --dir_logs logs/vqa2/mutan_att --out exported/ \\
      [--path_opt options/vqa2/mutan_att.yaml] \\
      [--resume best | --no_resume | --params_npz weights.npz] [--batch 64] \\
      [--weights_dtype float32|bfloat16|int8] [--params baked|external] \\
      [--validate N] [--platform cpu]

Writes ``<out>/program.pt2`` (the ``torch.export`` program of the model's
forward at the fixed serving shape, its five forward kernels kept as the
registered ops ``torch.ops.vqa_tpu_torch.*``, weights baked in) and
``<out>/meta.json`` (vocabs, shapes, tokenizer flavor, the device it was
traced on, provenance). The program is traced on the card (or, with
``--platform cpu``, on the host) and serves on either: the card's kernels
take bf16, so a host-traced program serves on the card only if it computes
in bf16 (``--opt engine.dtype=bfloat16`` on the run). Serve it with

  python -m vqa_tpu_torch.cli.serve --exported exported/ [--coco_dir ...]

The flags are the original's; ``--params_npz`` (the port's own) exports the
weights of a '/'-keyed npz, as the serve CLI's ``--params`` serves them
(``--params`` here picks baked or external, as in the original). See
vqa_tpu_torch/export.py for the format.
"""

from __future__ import annotations

import argparse
from typing import List, Optional


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dir_logs", required=True)
    p.add_argument("--path_opt", default=None,
                   help="defaults to the run dir's own options.yaml")
    p.add_argument("--resume", default="best", help="best | latest | <epoch>")
    p.add_argument("--no_resume", action="store_true",
                   help="export model.pretrained_params (an npz, with the seq2vec.pretrained_* "
                        "grafts), not a checkpoint")
    p.add_argument("--params_npz", default=None, metavar="NPZ",
                   help="export this '/'-keyed params npz (with the seq2vec.pretrained_* "
                        "grafts) instead of the run's checkpoint")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--batch", type=int, default=64,
                   help="frozen serving batch (requests are padded/chunked)")
    p.add_argument("--weights_dtype", default=None,
                   choices=["float32", "bfloat16", "int8"],
                   help="cast the weights (the model computes in its own dtype). int8: "
                        "weight-only per-channel quantization, dequantized inside the program "
                        "(baked mode only)")
    p.add_argument("--params", default="baked", choices=["baked", "external"],
                   help="baked: the weights travel inside program.pt2. external: a "
                        "weight-free program + sidecar params.npz ('/'-keyed float32)")
    p.add_argument("--validate", type=int, default=0, metavar="N",
                   help="deployment gate: run N val-split questions through BOTH the live "
                        "model and the written artifact and report answer agreement (fails "
                        "the command if a same-dtype artifact disagrees; bf16/int8 exports "
                        "report without failing)")
    p.add_argument("--platform", default=None, metavar="cuda|cpu",
                   help="where to trace (and --validate): the card (default) or, with cpu, "
                        "the host; the artifact loads on either (on the card in bf16 only)")
    return p


def _validate(predictor, ep, n_wanted: int):
    """(answer agreement, questions) of the live model and the loaded
    artifact over ``n_wanted`` val questions drawn with ``default_rng(0)``,
    both run chunked and padded at the exported batch on the same stored
    encodings."""
    import numpy as np
    import torch

    split, store = predictor.val_set.split, predictor.val_set.features
    n = min(n_wanted, len(split.image_names))
    idx = np.random.default_rng(0).choice(len(split.image_names), size=n, replace=False)
    q, lengths = split.questions[idx], split.lengths[idx]
    visual = store.get(store.index_of([str(split.image_names[i]) for i in idx]))

    def pad_rows(a, start):
        chunk = np.asarray(a[start:start + ep.batch])
        need = ep.batch - chunk.shape[0]
        if need:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], need, 0)])
        return chunk

    live_rows, frozen_rows = [], []
    for start in range(0, n, ep.batch):
        m = min(ep.batch, n - start)
        v = torch.from_numpy(pad_rows(visual, start).astype(np.float32))
        qq = torch.from_numpy(pad_rows(q, start))
        ll = torch.from_numpy(pad_rows(lengths, start))
        dev = predictor.device
        with torch.inference_mode():
            live = predictor.model(v.to(dev), qq.to(dev), ll.to(dev))
        live_rows.append(live[:m].float().cpu().numpy())
        frozen_rows.append(ep.logits(v[:m], qq[:m], ll[:m]))
    live, frozen = np.concatenate(live_rows), np.concatenate(frozen_rows)
    return float((frozen.argmax(-1) == live.argmax(-1)).mean()), n


def main(argv: Optional[List[str]] = None) -> int:
    p = build_argparser()
    args = p.parse_args(argv)
    if args.weights_dtype == "int8" and args.params == "external":
        # refused before the checkpoint load: the quantized pairs live inside
        # the program as its own buffers
        p.error("--weights_dtype int8 requires --params baked")
    if args.params_npz is not None and args.no_resume:
        p.error("--params_npz and --no_resume both name an npz: pass one")
    if args.platform not in (None, "cuda", "gpu", "cpu"):
        p.error(f"--platform {args.platform!r}: the port exports on the card (cuda) or, with "
                "--platform cpu, on the host")

    from vqa_tpu_torch.export import load_export, save_export
    from vqa_tpu_torch.predictor import Predictor

    npz = args.params_npz is not None or args.no_resume
    predictor = Predictor.from_run(
        args.dir_logs, args.path_opt, params=args.params_npz,
        device="cpu" if args.platform == "cpu" else "cuda",
        resume=None if npz else args.resume,
    )
    meta = save_export(
        args.out, predictor, batch=args.batch,
        weights_dtype=args.weights_dtype, params_mode=args.params,
    )
    print(
        f"exported {meta['model_arch']} (batch {meta['batch']}, "
        f"seq {meta['maxlength']}, features {meta['feature_shape']}, "
        f"{meta['num_answers']} answers, weights {meta['weights_dtype']}, "
        f"on {meta['device']}) -> {args.out}",
        flush=True,
    )
    if args.validate:
        ep = load_export(args.out, features=predictor.val_set.features)
        agree, n = _validate(predictor, ep, args.validate)
        print(f"validate: answer agreement {agree:.4f} over {n} val questions", flush=True)
        # cast or quantized weights legitimately move near-tie argmaxes:
        # report, don't gate. Only a same-dtype artifact must agree exactly.
        if agree < 1.0 and args.weights_dtype in (None, "float32"):
            print("validate: FROZEN ARTIFACT DISAGREES WITH THE LIVE MODEL", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
