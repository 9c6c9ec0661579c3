"""Learning-rate schedules: linear warmup + {constant, cosine, WSD}.

Port of ``repro.optim.schedules``; a schedule maps a step (int) to a 0-dim
f32 tensor, computed in f32 as the reference does.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[int], torch.Tensor]


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _warmup(s: torch.Tensor, warmup_steps: int) -> torch.Tensor:
    return torch.clamp((s + 1.0) / max(warmup_steps, 1), max=1.0)


def constant(lr: float, warmup_steps: int = 0) -> Schedule:
    def f(step):
        return lr * _warmup(_f32(step), warmup_steps)

    return f


def cosine(lr: float, total_steps: int, warmup_steps: int = 0,
           min_ratio: float = 0.1) -> Schedule:
    def f(step):
        s = _f32(step)
        w = _warmup(s, warmup_steps)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * w * cos

    return f


def wsd(lr: float, total_steps: int, warmup_steps: int = 0,
        decay_frac: float = 0.1, min_ratio: float = 0.01) -> Schedule:
    """Warmup -> Stable (constant lr) -> Decay (exponential tail)."""

    def f(step):
        s = _f32(step)
        w = _warmup(s, warmup_steps)
        decay_start = total_steps * (1.0 - decay_frac)
        prog = torch.clamp((s - decay_start)
                           / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = torch.exp(math.log(max(min_ratio, 1e-6)) * prog)
        return lr * w * decay

    return f


SCHEDULES = {"constant": constant, "cosine": cosine, "wsd": wsd}


def make_schedule(name: str, lr: float, total_steps: int,
                  warmup_steps: int) -> Schedule:
    if name == "constant":
        return constant(lr, warmup_steps)
    return SCHEDULES[name](lr, total_steps, warmup_steps)
