"""CoR (Chain of Reasoning for VQA, Wu et al., NeurIPS 2018): the regions
projected to objects, then a chain of steps, each relating every object
to every other under the question's guidance (``relation_attend``: the
scores and their weighted sum), moving the objects and pooling them into
a decision; gates over the steps mix the decisions into the classifier."""

from __future__ import annotations

import torch

from portbench.reference import params as P_
from portbench.reference.models import Dropout, Params, Precision, dense, tanh

_CHAIN = ("rel_src", "rel_dst", "rel_to_obj", "pool_hidden", "decision")


def params(cfg: dict, dim_q: int, dim_v: int) -> P_.Spec:
    model = cfg["model"]
    d, hidden = model["fusion"]["dim_h"], model["classif"]["dim_h"]
    spec = P_.dense("obj_proj", dim_v, d)
    for layer in _CHAIN:
        spec += P_.dense(f"chain/{layer}", d, d)
    spec += P_.dense("chain/rel_guide", dim_q, d) + P_.dense("chain/pool_logits", d, 1)
    spec += P_.dense("step_gates", dim_q, model["extra"]["chain"]["steps"])
    return (spec + P_.dense("classifier/hidden", d, hidden)
            + P_.dense("classifier/logits", hidden, cfg["num_answers"]))


def forward(cfg: dict, P: Params, q, visual, drop: Dropout, p: Precision) -> torch.Tensor:
    model = cfg["model"]
    rate = model["fusion"]["dropout"]
    classif = model["classif"]
    if model["extra"].get("l2norm_visual", True):
        visual = p.st(visual * torch.rsqrt((visual * visual).sum(-1, keepdim=True) + 1e-12))
    objects = tanh(dense(P, "obj_proj", visual, p), p)                     # [B, N, D]
    decisions = []
    for _ in range(model["extra"]["chain"]["steps"]):
        src = tanh(dense(P, "chain/rel_src", drop(objects, rate), p), p)
        r = tanh(dense(P, "chain/rel_dst", drop(objects, rate), p), p)
        g = tanh(dense(P, "chain/rel_guide", drop(q, rate), p), p)[:, None, :]
        pg = p.st(src * g)
        scores = p.mm(pg, r.transpose(1, 2)) * pg.shape[-1] ** -0.5        # [B, N, N]
        absorbed = p.st(p.mm(p.st(torch.softmax(scores, dim=-1)), r))
        moved = tanh(dense(P, "chain/rel_to_obj", p.st(absorbed * pg), p), p)
        objects = p.st(objects + moved)
        hidden = tanh(dense(P, "chain/pool_hidden", objects, p), p)
        pool = dense(P, "chain/pool_logits", p.st(hidden * g), p)
        beta = p.st(torch.softmax(pool, dim=1))                            # [B, N, 1]
        pooled = p.st((beta * objects).sum(dim=1))
        decisions.append(p.st(tanh(dense(P, "chain/decision", pooled, p), p) * g[:, 0]))
    gates = p.st(torch.softmax(dense(P, "step_gates", q, p), dim=-1))      # [B, steps]
    decision = p.st((gates.T[..., None] * torch.stack(decisions)).sum(0))
    z = tanh(dense(P, "classifier/hidden", drop(decision, classif["dropout"]), p), p)
    return dense(P, "classifier/logits", drop(z, classif["dropout"]), p)


def products(cfg: dict, regions: int, dim_q: int, dim_v: int) -> list:
    """(flops, backward products) of each matrix product of one question,
    counted as ``MutanAtt.products`` counts them."""
    model = cfg["model"]
    D, R = model["fusion"]["dim_h"], regions
    steps = model["extra"]["chain"]["steps"]
    out = [(2.0 * R * dim_v * D, 1)]                   # obj_proj over the features
    for _ in range(steps):
        out += [(2.0 * R * D * D, 2)] * 4              # rel_src, rel_dst, rel_to_obj, pool_hidden
        out += [(2.0 * dim_q * D, 2), (2.0 * R * D, 2), (2.0 * D * D, 2)]  # guide, pool, decision
        out += [(2.0 * R * R * D, 2)] * 2              # relation scores and weighted sum
    hidden = model["classif"]["dim_h"]
    return out + [(2.0 * dim_q * steps, 2), (2.0 * D * hidden, 2),
                  (2.0 * hidden * cfg["num_answers"], 2)]
