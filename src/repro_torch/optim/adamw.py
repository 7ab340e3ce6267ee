"""AdamW of the port (counterpart of ``repro/optim/adamw.py``), over the
port's ``{name: tensor}`` parameters, updated in place.

``torch.optim.AdamW`` orders its operations otherwise; this copies the
reference's arithmetic: gradients clipped by the float32 global norm
(``min(1, clip / max(gnorm, 1e-9))``), bias corrections from the
incremented step, the second moment's correction and square root in
float32 (``sqrt(vh) + eps``, no rsqrt), weight decay added to the update,
the new parameter computed in float32 and cast back to its dtype.  With
``moment_dtype="bfloat16"`` the moments are stored and updated in bf16,
their constants rounded to bf16 as the reference's ``jnp.asarray(c,
bf16)`` (adamw.py:59-75): the option that lets a 7B model's state fit one
80 GB card.  The step counter stays a host int, so an update issues no
device-to-host copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: int
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _moment_dtype(cfg: AdamWConfig):
    return torch.float32 if cfg.moment_dtype == "float32" else torch.bfloat16


def adamw_init(params: Dict[str, torch.Tensor], cfg: AdamWConfig = AdamWConfig()) -> AdamWState:
    dt = _moment_dtype(cfg)
    zeros = {n: torch.zeros(p.shape, dtype=dt, device=p.device) for n, p in params.items()}
    return AdamWState(0, zeros, {n: torch.zeros_like(z) for n, z in zeros.items()})


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every element's square, each tensor's sum in
    float32 (a 0-dim float32 tensor on the tensors' device)."""

    sums = [torch.sum(torch.square(t.float())) for t in tensors]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], cfg: AdamWConfig,
                 lr_scale=1.0) -> Tuple[AdamWState, dict]:
    """One step: ``params`` and the moments of ``state`` are updated in
    place -> (the new state, {"grad_norm"}).  ``grads`` is keyed like
    ``params`` (a missing or None gradient counts as zeros)."""

    step = state.step + 1
    grads = {n: torch.zeros_like(p) if grads.get(n) is None else grads[n]
             for n, p in params.items()}
    gnorm = global_norm(grads.values())
    f32 = np.float32
    if cfg.grad_clip:
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    else:
        clip = torch.ones((), dtype=torch.float32, device=gnorm.device)
    # float32 scalars, as the reference's step.astype(float32) arithmetic
    b1c = f32(1.0) - f32(cfg.b1) ** f32(step)
    b2c = f32(1.0) - f32(cfg.b2) ** f32(step)
    lr = f32(cfg.lr) * f32(lr_scale)
    cdt = _moment_dtype(cfg)

    def const(x):
        return torch.tensor(x, dtype=cdt, device=gnorm.device)

    b1, nb1, b2, nb2 = const(cfg.b1), const(1 - cfg.b1), const(cfg.b2), const(1 - cfg.b2)
    b1c_t, clip_c = const(float(b1c)), clip.to(cdt)
    for name, p in params.items():
        g = grads[name].to(cdt) * clip_c
        m, v = state.m[name], state.v[name]
        m_new = b1 * m.to(cdt) + nb1 * g
        v_new = b2 * v.to(cdt) + nb2 * g * g
        mh = m_new / b1c_t
        vh = v_new.float() / float(b2c)
        delta = mh.float() / (torch.sqrt(vh) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - float(lr) * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)
    return AdamWState(step, state.m, state.v), {"grad_norm": gnorm}
