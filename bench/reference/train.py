"""Plain PyTorch reference of the benchmark's training steps.

One optimizer step, as the measured program states it for data
parallelism of one: every microbatch's float32 gradient passes, leaf by
leaf and layer by layer, through the gradient sync of the cell (LoCo,
arXiv:2407.04480, Algorithm 1, or none under ``fp``); the synced
gradients are averaged over the microbatches, clipped to a global norm
of ``clip_norm``, and applied by Adam with an L2 weight decay (not on the
norm scales) under a linear warm-up and a cosine decay.

LoCo at 4 bits on a leaf's flat gradient ``g`` (padded with zeros to a
multiple of 512), with its error ``e`` stored in float8_e4m3 under the
scale ``2**14`` (clipped at +-448 first):
``h = g + e``; per block of 256, ``s = 7 / absmax(h)`` and
``q = clamp(round_half_even(h * s), -8, 7)``; ``d = q / s`` is the synced
gradient; the new error is ``(1 - beta) * e + beta * (h - d)``.
Leaves of fewer than ``loco_min_numel`` elements per layer sync in full
precision.

Nothing here imports ``jax``, the JAX package or the program under test.
"""
from __future__ import annotations

import math

import torch

from bench.reference.model import Decoder, Leaf

GRAIN = 512
QBLOCK = 256


def lr_at(step: int, t: dict) -> float:
    """The cell's learning rate at ``step`` (from 0)."""
    warm = min((step + 1) / max(t["warmup_steps"], 1), 1.0)
    prog = min(max((step - t["warmup_steps"])
                   / max(t["total_steps"] - t["warmup_steps"], 1), 0.0), 1.0)
    cos = 0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog))
    return t["lr"] * warm * cos


def loco_roundtrip(g: torch.Tensor, e8: torch.Tensor, beta: float,
                   escale: float, bits: int = 4):
    """``g`` (n,) float32, ``e8`` (n,) float8 error -> (synced gradient,
    new float8 error)."""
    qmax = 2 ** (bits - 1) - 1
    e = e8.float() / escale
    h = (g + e).view(-1, QBLOCK)
    s = qmax / h.abs().amax(1, keepdim=True).clamp(min=1e-30)
    d = (torch.round(h * s).clamp(-qmax - 1, qmax) / s).view(-1)
    e_new = (1.0 - beta) * e + beta * (h.view(-1) - d)
    return d, (e_new * escale).clamp(-448.0, 448.0).to(torch.float8_e4m3fn)


def padded(n: int) -> int:
    return -(-n // GRAIN) * GRAIN


def train_steps(c: dict, t: dict, leaves: list[Leaf], W: dict,
                batches: list[torch.Tensor], fp8: bool = False) -> dict:
    """Run ``len(batches)`` optimizer steps from the float32 weights ``W``
    (``{(group, name): tensor}``, updated in place) on the global batches
    ``batches`` ((global_batch, seq_len + 1) each).  Returns the loss of
    each step, each leaf's clipped gradient norm at the first step
    (``grad1``) and its distance from where it started after the last
    (``change``), keyed ``(group, name, layer)``."""
    dec = Decoder(c, fp8=fp8)
    micro = t["microbatch"]
    loco = t["sync"] == "loco"
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, t["weight_decay"]
    W0 = {k: v.clone() for k, v in W.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    err = {}
    for lf in leaves:
        if loco and lf.numel >= t["loco_min_numel"]:
            err[(lf.group, lf.name)] = torch.zeros(
                lf.rows, padded(lf.numel), dtype=torch.float8_e4m3fn,
                device=W[(lf.group, lf.name)].device)
    losses, grad1 = [], {}
    for step, batch in enumerate(batches):
        acc = {k: torch.zeros_like(v) for k, v in W.items()}
        mb_losses = []
        for i in range(0, batch.shape[0], micro):
            P = {k: v.detach().requires_grad_() for k, v in W.items()}
            loss = dec.loss(P, batch[i:i + micro])
            loss.backward()
            mb_losses.append(float(loss.detach()))
            for lf in leaves:
                key = (lf.group, lf.name)
                g = P[key].grad.reshape(lf.rows, lf.numel)
                if key in err:
                    n = padded(lf.numel)
                    for r in range(lf.rows):
                        gr = torch.zeros(n, device=g.device)
                        gr[:lf.numel] = g[r]
                        d, err[key][r] = loco_roundtrip(
                            gr, err[key][r], t["beta"], t["error_scale"],
                            t["bits"])
                        acc[key].view(lf.rows, lf.numel)[r] += d[:lf.numel]
                else:
                    acc[key] += g.view_as(acc[key])
            del P, loss
        accum = batch.shape[0] // micro
        grads = {k: a / accum for k, a in acc.items()}
        gnorm = math.sqrt(sum(float((g.double() ** 2).sum())
                              for g in grads.values()))
        cs = min(1.0, t["clip_norm"] / max(gnorm, 1e-12))
        lr = lr_at(step, t)
        for lf in leaves:
            key = (lf.group, lf.name)
            g = grads[key] * cs
            if step == 0:
                rows = g.reshape(lf.rows, -1)
                for r in range(lf.rows):
                    grad1[(lf.group, lf.name, r)] = float(rows[r].double().norm())
            if lf.decay:
                g = g + wd * W[key]
            m[key].mul_(b1).add_((1 - b1) * g)
            v2[key].mul_(b2).add_((1 - b2) * g * g)
            mhat = m[key] / (1 - b1 ** (step + 1))
            vhat = v2[key] / (1 - b2 ** (step + 1))
            W[key] -= lr * (mhat / (vhat.sqrt() + eps))
        losses.append(sum(mb_losses) / len(mb_losses))
        del acc, grads
    change = {}
    for lf in leaves:
        key = (lf.group, lf.name)
        dlt = (W[key] - W0[key]).reshape(lf.rows, -1)
        for r in range(lf.rows):
            change[(lf.group, lf.name, r)] = float(dlt[r].double().norm())
    return {"losses": losses, "grad1": grad1, "change": change}
