"""Per-group Adam with torch.optim.Adam's semantics, written out (port of
sixdgs_tpu/train/optim.py).

The reference optimizes six parameter groups with their own learning rates
and eps = 1e-15 (scene/gaussian_model.py:230-274). The moments are plain
tensors in dicts keyed like the parameters, so that densification's
optimizer-state surgery (gaussian_model.py:422-507) is a gather and a
concatenation, and a checkpoint is a flat list of arrays.

Bias-corrected: update = lr * m_hat / (sqrt(v_hat) + eps).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15


@dataclasses.dataclass
class AdamState:
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    step: torch.Tensor  # 0-d int32


def adam_init(params: Dict[str, torch.Tensor]) -> AdamState:
    some = next(iter(params.values()))
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()},
                     step=torch.zeros((), dtype=torch.int32, device=some.device))


@torch.no_grad()
def adam_update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                state: AdamState, lrs: Dict[str, float]):
    """One Adam step with a learning rate per parameter name: (new params,
    new state). Nothing is updated in place."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - BETA1 ** t
    bc2 = 1.0 - BETA2 ** t
    new_params, new_m, new_v = {}, {}, {}
    for name in params:
        g = grads[name]
        m = BETA1 * state.m[name] + (1.0 - BETA1) * g
        v = BETA2 * state.v[name] + (1.0 - BETA2) * torch.square(g)
        new_params[name] = params[name] - lrs[name] * (m / bc1) / (
            torch.sqrt(v / bc2) + EPS)
        new_m[name] = m
        new_v[name] = v
    return new_params, AdamState(m=new_m, v=new_v, step=step)


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000):
    """Log-linear learning-rate schedule (utils/general_utils.py:32-71)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
            0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = np.clip(step / max_steps, 0, 1)
    log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
    return float(delay_rate * log_lerp) if np.ndim(step) == 0 else delay_rate * log_lerp
