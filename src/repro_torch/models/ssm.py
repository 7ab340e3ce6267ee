"""Mamba block of the port (counterpart of ``repro/models/ssm.py``): the
Mamba-2 / SSD formulation, one scalar decay per head.

Shapes (Mamba-2 conventions, a single B/C group):
  x  [B, S, H, P]   inner activations (H * P = expand * d_model)
  dt [B, S, H]      softplus-positive step sizes
  a  [H]            negative per-head decay rates
  bm, c [B, S, N]   input/output state projections
State: h [B, H, P, N] float32; the causal conv's carry [B, K-1, d_in].

Prefill runs the chunked scan through ``kernels.ops.mamba_scan`` (on a CUDA
tensor the hand-written kernel, on a CPU tensor ``kernels.ref
.mamba_scan_ref``, the twin of the reference's ``ssd_chunked``); decode
steps the recurrence one token at a time with ``ssd_step``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import _param, dense, normal_

HEAD_P = 64  # SSD head dim


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(d_in, SSD heads, state dim)."""

    s = cfg.ssm or SSMConfig()
    d_in = s.expand * cfg.d_model
    return d_in, max(d_in // HEAD_P, 1), s.state_dim


def _head_p(d_in: int) -> int:
    return HEAD_P if d_in >= HEAD_P else d_in


class Mamba(nn.Module):
    """Parameters as ``init_mamba`` lays them out; ``dt_bias``, ``a_log``
    and ``d_skip`` stay float32 in a bf16 model."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        s = cfg.ssm or SSMConfig()
        d = cfg.d_model
        d_in, nh, n = ssm_dims(cfg)
        f32 = torch.float32
        self.in_proj = _param((d, 2 * d_in), dtype, device)  # x and z (gate) branches
        self.conv_w = _param((s.conv_width, d_in), dtype, device)  # depthwise causal conv
        self.dt_proj = _param((d_in, nh), dtype, device)
        self.bc_proj = _param((d_in, 2 * n), dtype, device)
        self.dt_bias = _param((nh,), f32, device)
        self.a_log = _param((nh,), f32, device)
        self.d_skip = _param((nh,), f32, device)
        self.out_proj = _param((d_in, d), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        d, d_in = self.in_proj.shape[0], self.out_proj.shape[0]
        normal_(self.in_proj, d**-0.5, generator)
        normal_(self.conv_w, 0.5, generator)
        normal_(self.dt_proj, d_in**-0.5, generator)
        normal_(self.bc_proj, d_in**-0.5, generator)
        self.dt_bias.zero_()
        nh = self.a_log.shape[0]
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32)))
        self.d_skip.fill_(1.0)
        normal_(self.out_proj, d_in**-0.5, generator)


def _causal_conv(x, w, carry=None):
    """Depthwise causal conv + SiLU.  x [B,S,C], w [K,C], carry [B,K-1,C]
    or None -> (out [B,S,C], new carry)."""

    k = w.shape[0]
    if carry is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = carry.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i : i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    new_carry = xp[:, -(k - 1) :] if k > 1 else torch.zeros_like(pad)
    return F.silu(out), new_carry


def _project_dt_bc(xb, p: Mamba, n: int):
    """dt [.., H], bm / c [.., N], all float32."""

    dt = dense(xb, p.dt_proj).float()
    bc = dense(xb, p.bc_proj).float()
    return dt, bc[..., :n], bc[..., n:]


def ssd_step(x, dt, a, bm, c, h):
    """One decode step.  x [B,H,P], dt [B,H], bm/c [B,N], h [B,H,P,N]."""

    dec = torch.exp(dt * a)
    h = h * dec[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, bm, x)
    return torch.einsum("bn,bhpn->bhp", c, h), h


def mamba_forward(x_res, p: Mamba, cfg: ModelConfig, state=None):
    """Full-sequence Mamba block.  x_res [B,S,D] -> (out [B,S,D], state
    ``{"h", "conv"}``); ``state`` continues a stream."""

    d_in, nh, n = ssm_dims(cfg)
    b, s, _ = x_res.shape
    h = dense(x_res, p.in_proj)
    xb, z = h[..., :d_in], h[..., d_in:]
    xb, conv_carry = _causal_conv(xb, p.conv_w, None if state is None else state["conv"])
    dt, bm, c = _project_dt_bc(xb, p, n)
    dt = F.softplus(dt + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xb.float().reshape(b, s, nh, _head_p(d_in))
    y, h_t = ops.mamba_scan(xh, dt, a, bm.contiguous(), c.contiguous(),
                            h0=None if state is None else state["h"])
    y = y + p.d_skip[:, None] * xh
    y = y.reshape(b, s, d_in).to(x_res.dtype) * F.silu(z)
    return dense(y, p.out_proj), {"h": h_t, "conv": conv_carry}


def mamba_decode_step(x_res, p: Mamba, cfg: ModelConfig, state):
    """One-token decode.  x_res [B,1,D], state {h [B,H,P,N], conv [B,K-1,C]}."""

    d_in, nh, n = ssm_dims(cfg)
    b = x_res.shape[0]
    h = dense(x_res, p.in_proj)
    xb, z = h[..., :d_in], h[..., d_in:]
    xb, conv_carry = _causal_conv(xb, p.conv_w, state["conv"])
    dt, bm, c = _project_dt_bc(xb[:, 0], p, n)
    dt = F.softplus(dt + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xb.float().reshape(b, nh, _head_p(d_in))
    y, h_t = ssd_step(xh, dt, a, bm, c, state["h"])
    y = y + p.d_skip[:, None] * xh
    y = y.reshape(b, 1, d_in).to(x_res.dtype) * F.silu(z)
    return dense(y, p.out_proj), {"h": h_t, "conv": conv_carry}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cuda"):
    s = cfg.ssm or SSMConfig()
    d_in, nh, n = ssm_dims(cfg)
    return {
        "h": torch.zeros((batch, nh, _head_p(d_in), n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in), dtype=dtype, device=device),
    }
