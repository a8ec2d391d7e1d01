"""Top-k answer decoding, the port of ``vqa_tpu/utils/decode.py``: a float32
softmax, then the same argsort -> (answer, prob) contract."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def topk_answers(
    logits: torch.Tensor, aid_to_ans: Sequence[str], topk: int
) -> List[List[Tuple[str, float]]]:
    probs = torch.softmax(logits.float(), dim=-1).cpu().numpy()
    out = []
    for row in probs:
        top = np.argsort(-row)[:topk]
        out.append([(aid_to_ans[a], float(row[a])) for a in top])
    return out
