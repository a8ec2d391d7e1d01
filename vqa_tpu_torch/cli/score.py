"""Standalone VQA-accuracy scorer CLI, a copy of ``vqa_tpu/cli/score.py``.

  python -m vqa_tpu_torch.cli.score --results logs/.../results/xxx.json \
      --annotations data/vqa2/raw/v2_mscoco_val2014_annotations.json
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from vqa_tpu_torch.scorer import evaluate_files


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--results", required=True, help="OpenEnded results json")
    p.add_argument("--annotations", required=True, help="official annotations json")
    p.add_argument("--out", default=None, help="optional path to write the report json")
    args = p.parse_args(argv)
    report = evaluate_files(args.results, args.annotations)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
