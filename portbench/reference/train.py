"""The train step in plain float32 PyTorch: the forward of ``models`` with
dropout, the mean softmax cross entropy over the batch, autograd's
gradients and adam (b1 0.9, b2 0.999, eps 1e-8, no bias in the square
root, optax's ``scale_by_adam`` followed by ``-lr``)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench.reference import models

B1, B2, EPS = 0.9, 0.999, 1e-8


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels.long()[:, None])[:, 0]).mean()


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches: Sequence[dict],
                seed: int, fp8: bool = False) -> dict:
    """Run ``batches`` (each ``tokens``, ``visual``, ``answer``, its train
    ``step`` index, which seeds its dropout, and ``parts``, the data ranks
    whose shards it joins) through adam from ``params``; returns ``loss``
    (one float a step), ``grad_norms`` (each step's norm of each leaf's
    gradient) and ``params`` (the leaves after the last)."""
    lr = cfg["optim"]["lr"]
    P = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    names = list(P)
    mu = [torch.zeros_like(P[k]) for k in names]
    nu = [torch.zeros_like(P[k]) for k in names]
    losses: List[float] = []
    norms: List[Dict[str, float]] = []
    for count, batch in enumerate(batches, start=1):
        # data parallel: each rank's equal part of the batch under its own
        # dropout stream; the loss the mean of the parts' means
        parts = batch.get("parts", 1)
        losses_ = []
        for part, rows in enumerate(torch.arange(len(batch["answer"])).chunk(parts)):
            gen = models.dropout_generator(seed, batch["step"], batch["visual"].device, part)
            logits = models.forward(cfg, P, batch["tokens"][rows], batch["visual"][rows],
                                    gen=gen, fp8=fp8)
            losses_.append(cross_entropy(logits, batch["answer"][rows]))
        loss = torch.stack(losses_).mean()
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        norms.append(dict(zip(names, torch.stack([g.norm() for g in grads]).tolist())))
        with torch.no_grad():
            c1, c2 = 1 - B1 ** count, 1 - B2 ** count
            for i, (k, g) in enumerate(zip(names, grads)):
                mu[i] = (1 - B1) * g + B1 * mu[i]
                nu[i] = (1 - B2) * g * g + B2 * nu[i]
                P[k] -= lr * (mu[i] / c1) / (torch.sqrt(nu[i] / c2) + EPS)
    return {"loss": losses, "grad_norms": norms, "params": {k: v.detach() for k, v in P.items()}}
