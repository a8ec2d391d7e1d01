"""Convert reference-lineage PyTorch weights into the port's formats, the
port of the repo-root ``tools/import_torch.py`` (converters in
vqa_tpu_torch/importers.py). The npz files it writes are the JAX tool's,
byte for byte, and load in either package.

  # torchvision ImageNet ResNet -> extract --params npz
  python -m vqa_tpu_torch.tools.import_torch resnet152.pth --kind resnet152 \
      --out r152.npz

  # the lineage's torch skip-thoughts port (embedding + GRU) -> a full
  # question-encoder npz (model.seq2vec.pretrained_encoder)
  python -m vqa_tpu_torch.tools.import_torch skipthoughts.pth --kind seq2vec \
      --cell gru --out encoder.npz

  # the PUBLISHED theano skip-thoughts weights (Kiros et al. uni_skip.npz)
  python -m vqa_tpu_torch.tools.import_torch uni_skip.npz --kind skipthoughts \
      --out enc.npz

  # pretrained word embeddings aligned to a run's vocab ->
  # model.seq2vec.pretrained_emb npz
  python -m vqa_tpu_torch.tools.import_torch skipthoughts.pth --kind embedding \
      --source_words dictionary.txt --vocab .../processed/<v>/vocab.json \
      --out emb_aligned.npz

  # a whole reference checkpoint -> model.pretrained_params npz, through
  # options/import_specs/<arch>.json (the template is the port model the
  # YAML builds, at --num_words and --num_answers)
  python -m vqa_tpu_torch.tools.import_torch mutan_att.pth --kind model \
      --path_opt options/vqa2/mutan_att.yaml --num_words 12000 \
      --num_answers 2000 --out params.npz

Accepts .pth/.pt (torch.load on CPU; DataParallel 'module.' prefixes and
{'state_dict': ...} checkpoint wrappers unwrapped) or a .npz of named
numpy arrays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

from vqa_tpu_torch import importers

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# the migration spec of each arch under options/import_specs/
SPECS = {
    "MutanAtt": "mutan_att", "MLBAtt": "mlb_att",
    "MutanNoAtt": "mutan_noatt", "MLBNoAtt": "mlb_noatt",
    "MFBCoAtt": "mfb_coatt", "MFHCoAtt": "mfh_coatt",
    "CoR": "cor", "ConcatAtt": "concat_att",
}


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    if path.endswith((".npz", ".npy")):
        data = np.load(path)
        return {k: data[k] for k in data.files} if hasattr(data, "files") else {"array": data}
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=False)
    # the lineage's checkpoints wrap the state_dict in an info dict
    for key in ("state_dict", "model_state", "model"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise TypeError(f"{path} does not contain a state_dict (got {type(obj)})")
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            out[k] = v.detach().cpu().numpy()
    return importers.strip_prefixes(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("checkpoint", help=".pth/.pt/.npz with torch weights")
    p.add_argument("--kind", required=True,
                   choices=["resnet50", "resnet101", "resnet152",
                            "seq2vec", "skipthoughts", "embedding", "model"])
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--path_opt", default=None,
                   help="model: YAML config of the target model")
    p.add_argument("--num_words", type=int, default=None, help="model: vocab size")
    p.add_argument("--num_answers", type=int, default=None, help="model: nans")
    p.add_argument("--regions", type=int, default=36)
    p.add_argument("--feature_dim", type=int, default=2048)
    p.add_argument("--spec", default=None,
                   help="model: migration-spec json (default: "
                        "options/import_specs/ by arch)")
    p.add_argument("--allow_unfilled", action="store_true",
                   help="model: keep init values for leaves the spec misses")
    p.add_argument("--show", action="store_true",
                   help="model: list torch keys and model leaves with shapes, "
                        "then exit (for spec authoring)")
    p.add_argument("--cell", default="gru", choices=["lstm", "gru"],
                   help="seq2vec: recurrent cell type")
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--embedding_key", default="embedding.weight")
    p.add_argument("--rnn_prefix", default="rnn")
    p.add_argument("--source_words", default=None,
                   help="embedding: text file, one word per line, row-aligned "
                        "to the source table")
    p.add_argument("--vocab", default=None,
                   help="embedding: the run's vocab.json (wid_to_word)")
    p.add_argument("--oov", default="zeros", choices=["zeros", "mean"])
    args = p.parse_args(argv)

    sd = load_state_dict(args.checkpoint)

    if args.kind == "model":
        if not (args.path_opt and args.num_words and args.num_answers):
            p.error("--kind model needs --path_opt, --num_words, --num_answers")
        import dataclasses

        from vqa_tpu_torch.config import load_options
        from vqa_tpu_torch.models.factory import factory as model_factory
        from vqa_tpu_torch.weights import init_params

        # flax infers the feature width from --regions x --feature_dim sample
        # inputs at init; the port model takes it as dim_v (--regions only
        # shapes the JAX tool's sample)
        opt = load_options(args.path_opt)
        model = model_factory(dataclasses.asdict(opt.model), args.num_words, args.num_answers,
                              dim_v=args.feature_dim)
        init_params(model, seed=0)  # what --allow_unfilled keeps: flax's distributions
        template = importers.model_template(model)

        if args.show:
            print("== torch state_dict ==")
            for k in sorted(sd):
                print(f"  {k}  {tuple(sd[k].shape)}")
            print("== model param leaves ==")
            for k, v in sorted(importers.flatten_tree(template).items()):
                print(f"  {k}  {tuple(v.shape)}")
            return 0

        spec_path = args.spec
        if spec_path is None:
            name = SPECS.get(opt.model.arch)
            if name is None:
                p.error(f"no default spec for arch {opt.model.arch!r}; pass --spec")
            spec_path = os.path.join(_REPO, "options/import_specs", f"{name}.json")
        with open(spec_path) as f:
            spec = json.load(f)
        entries = spec["entries"] if isinstance(spec, dict) else spec

        tree, report = importers.model_from_torch(sd, template, entries)
        if report["unfilled"] and not args.allow_unfilled:
            raise SystemExit(
                "spec left these leaves at their init values (pass "
                f"--allow_unfilled to accept): {report['unfilled']}"
            )
        importers.save_tree_npz(args.out, tree)
        print(f"wrote {args.out}: {len(report['filled'])} leaves imported"
              + (f", {len(report['unfilled'])} left at init" if report["unfilled"] else "")
              + " — use with model.pretrained_params")
    elif args.kind.startswith("resnet"):
        from vqa_tpu_torch.models.convnets import _DEPTHS

        tree = importers.resnet_from_torch(sd, _DEPTHS[args.kind])
        importers.save_tree_npz(args.out, tree)
        n = sum(v.size for v in importers.flatten_tree(tree).values())
        print(f"wrote {args.out}: {args.kind} params+batch_stats "
              f"({n/1e6:.1f}M values) — use with extract.py --params")
    elif args.kind == "skipthoughts":
        tree = importers.skipthoughts_from_theano(sd)
        importers.save_tree_npz(args.out, tree)
        print(f"wrote {args.out}: skip-thoughts GRU encoder params from the "
              "theano npz (model.seq2vec.pretrained_encoder; align word "
              "embeddings separately with --kind embedding)")
    elif args.kind == "seq2vec":
        tree = importers.seq_encoder_from_torch(
            sd, args.cell, args.num_layers,
            embedding_key=args.embedding_key, rnn_prefix=args.rnn_prefix,
        )
        importers.save_tree_npz(args.out, tree)
        print(f"wrote {args.out}: {args.cell} encoder params "
              f"(model.seq2vec.pretrained_encoder)")
    else:  # embedding
        if not (args.source_words and args.vocab):
            p.error("--kind embedding needs --source_words and --vocab")
        if args.embedding_key in sd:
            table = sd[args.embedding_key]
        elif len(sd) == 1:  # bare .npy / single-array npz: unambiguous
            table = next(iter(sd.values()))
        else:
            raise SystemExit(
                f"--embedding_key {args.embedding_key!r} not in the checkpoint; "
                f"available keys: {sorted(sd)}"
            )
        with open(args.source_words) as f:
            source_words = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        if len(source_words) != table.shape[0]:
            raise ValueError(
                f"--source_words has {len(source_words)} words but the table "
                f"has {table.shape[0]} rows"
            )
        with open(args.vocab) as f:
            target_words = json.load(f)["wid_to_word"]
        aligned, n_oov = importers.align_embedding_to_vocab(
            table, source_words, target_words, oov=args.oov
        )
        np.savez(args.out, embedding=aligned)
        print(f"wrote {args.out}: [{aligned.shape[0]}, {aligned.shape[1]}] "
              f"table, {n_oov} OOV rows ({args.oov} fill) — "
              f"model.seq2vec.pretrained_emb")
    return 0


if __name__ == "__main__":
    sys.exit(main())
