"""MutanAtt (MUTAN, Ben-younes et al., ICCV 2017, arXiv:1705.06676): a
MUTAN fusion of the question with each region scores the regions, a
softmax over the regions per glimpse weights them, and a second MUTAN
fusion of the question with the glimpses feeds the classifier."""

from __future__ import annotations

import torch

from portbench.reference import params as P_
from portbench.reference.models import Dropout, Params, Precision, dense, mutan


def params(cfg: dict, dim_q: int, dim_v: int) -> P_.Spec:
    model = cfg["model"]
    att, fus = model["attention"], model["fusion"]
    return (P_.mutan("attention/fusion", dim_q, dim_v, att)
            + P_.dense("attention/glimpse_logits", att["dim_mm"], att["nb_glimpses"])
            + P_.mutan("final_fusion", dim_q, att["nb_glimpses"] * dim_v, fus)
            + P_.dense("classifier/logits", fus["dim_mm"], cfg["num_answers"]))


def forward(cfg: dict, P: Params, q, visual, drop: Dropout, p: Precision) -> torch.Tensor:
    model = cfg["model"]
    att, fus, classif = model["attention"], model["fusion"], model["classif"]
    joint = mutan(P, "attention/fusion", att, q[:, None, :], visual, drop, p)
    joint = drop(joint, att.get("dropout_mm", 0.0))                        # [B, R, M]
    alpha = p.st(torch.softmax(dense(P, "attention/glimpse_logits", joint, p), dim=1))
    attended = p.st(p.mm(alpha.transpose(1, 2), visual).flatten(1))        # [B, G*Dv]
    z = mutan(P, "final_fusion", fus, q, attended, drop, p)
    return dense(P, "classifier/logits", drop(z, classif["dropout"]), p)


def products(cfg: dict, regions: int, dim_q: int, dim_v: int) -> list:
    """(flops, backward products) of each matrix product of one question:
    the backward count is 1 for a weight's gradient alone (its input needs
    none), 2 with the input's, and for a product of two activations the
    number of its operands that need a gradient."""
    model = cfg["model"]
    att, fus = model["attention"], model["fusion"]
    G, R = att["nb_glimpses"], regions
    out = []
    for opt, dv, n_v, v_grad in ((att, dim_v, R, False), (fus, G * dim_v, 1, True)):
        rm = opt["R"] * opt["dim_mm"]
        out += [(2.0 * dim_q * opt["dim_hq"], 2),
                (2.0 * n_v * dv * opt["dim_hv"], 2 if v_grad else 1),
                (2.0 * opt["dim_hq"] * rm, 2),
                (2.0 * n_v * opt["dim_hv"] * rm, 2)]
    return out + [(2.0 * R * att["dim_mm"] * G, 2),      # glimpse logits
                  (2.0 * R * G * dim_v, 1),              # weighted sums: alpha's gradient
                  (2.0 * fus["dim_mm"] * cfg["num_answers"], 2)]
