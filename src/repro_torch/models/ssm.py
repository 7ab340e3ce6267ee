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

On a tensor-parallel rank (``Model(group=...)``, M ranks) a Mamba layer
runs the rank's H / M heads, which are its d_in / M inner channels
(``xh`` is ``xb`` reshaped): ``in_proj`` holds its block of each half,
x and z; ``conv_w`` its channels; ``dt_bias``, ``a_log`` and ``d_skip``
its heads; ``dt_proj``, ``bc_proj`` and ``out_proj`` their rows.  The
projections of ``xb`` onto ``dt_proj`` and ``bc_proj`` are partial sums:
they are taken in float32, concatenated and all-reduced once, then
rounded to the model's dtype and back (what one rank's ``dense(...)
.float()`` does), and the rank keeps its heads of ``dt`` and all of B and
C.  The scan runs over the rank's heads, and ``out_proj``'s partial
products take the layer's second all-reduce.  The state is the rank's:
``h`` [B, H/M, P, N], ``conv`` [B, K-1, d_in/M].
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import ops
from repro_torch.launch.dist import all_reduce_sum
from repro_torch.models.layers import _param, block_of, dense, global_shape, normal_

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
    and ``d_skip`` stay float32 in a bf16 model.  ``d_in`` and ``n_heads``
    are the channels and heads this module runs (a rank's share of them
    over ``tp``, the ranks of the model axis; all of them outside one)."""

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
        self.d_in, self.n_heads, self.tp = d_in, nh, None

    def init(self, generator: torch.Generator) -> None:
        d, d_in = global_shape(self.in_proj)[0], global_shape(self.out_proj)[0]
        normal_(self.in_proj, d**-0.5, generator)
        normal_(self.conv_w, 0.5, generator)
        normal_(self.dt_proj, d_in**-0.5, generator)
        normal_(self.bc_proj, d_in**-0.5, generator)
        self.dt_bias.zero_()
        (nh,), index = block_of(self.a_log)  # a rank: its heads of the global rates
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32))[index])
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
    """dt [.., H], bm / c [.., N], all float32; on a rank of ``p.tp`` its
    heads of dt, from the float32 partial products summed over the ranks
    in one all-reduce and rounded to xb's dtype."""

    if p.tp is None:
        dt = dense(xb, p.dt_proj).float()
        bc = dense(xb, p.bc_proj).float()
        return dt, bc[..., :n], bc[..., n:]
    w = torch.cat([p.dt_proj, p.bc_proj], dim=1).float()
    proj = all_reduce_sum(xb.float() @ w, p.tp).to(xb.dtype).float()
    nh = global_shape(p.dt_proj)[1]
    h0 = p.tp.rank * p.n_heads
    return proj[..., h0:h0 + p.n_heads], proj[..., nh:nh + n], proj[..., nh + n:]


def ssd_step(x, dt, a, bm, c, h):
    """One decode step.  x [B,H,P], dt [B,H], bm/c [B,N], h [B,H,P,N]."""

    dec = torch.exp(dt * a)
    h = h * dec[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, bm, x)
    return torch.einsum("bn,bhpn->bhp", c, h), h


def mamba_forward(x_res, p: Mamba, cfg: ModelConfig, state=None):
    """Full-sequence Mamba block.  x_res [B,S,D] -> (out [B,S,D], state
    ``{"h", "conv"}``); ``state`` continues a stream."""

    hp, n = _head_p(ssm_dims(cfg)[0]), ssm_dims(cfg)[2]
    d_in, nh = p.d_in, p.n_heads  # this rank's
    b, s, _ = x_res.shape
    h = dense(x_res, p.in_proj)
    xb, z = h[..., :d_in], h[..., d_in:]
    xb, conv_carry = _causal_conv(xb, p.conv_w, None if state is None else state["conv"])
    dt, bm, c = _project_dt_bc(xb, p, n)
    dt = F.softplus(dt + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xb.float().reshape(b, s, nh, hp)
    y, h_t = ops.mamba_scan(xh, dt, a, bm.contiguous(), c.contiguous(),
                            h0=None if state is None else state["h"])
    y = y + p.d_skip[:, None] * xh
    y = y.reshape(b, s, d_in).to(x_res.dtype) * F.silu(z)
    return all_reduce_sum(dense(y, p.out_proj), p.tp), {"h": h_t, "conv": conv_carry}


def mamba_decode_step(x_res, p: Mamba, cfg: ModelConfig, state):
    """One-token decode.  x_res [B,1,D], state {h [B,H,P,N], conv [B,K-1,C]}."""

    hp, n = _head_p(ssm_dims(cfg)[0]), ssm_dims(cfg)[2]
    d_in, nh = p.d_in, p.n_heads  # this rank's
    b = x_res.shape[0]
    h = dense(x_res, p.in_proj)
    xb, z = h[..., :d_in], h[..., d_in:]
    xb, conv_carry = _causal_conv(xb, p.conv_w, state["conv"])
    dt, bm, c = _project_dt_bc(xb[:, 0], p, n)
    dt = F.softplus(dt + p.dt_bias)
    a = -torch.exp(p.a_log)
    xh = xb.float().reshape(b, nh, hp)
    y, h_t = ssd_step(xh, dt, a, bm, c, state["h"])
    y = y + p.d_skip[:, None] * xh
    y = y.reshape(b, 1, d_in).to(x_res.dtype) * F.silu(z)
    return all_reduce_sum(dense(y, p.out_proj), p.tp), {"h": h_t, "conv": conv_carry}


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device="cuda",
                     ranks: int = 1):
    """A zero state of one Mamba layer: ``h`` [B, H, P, N] float32 and
    ``conv`` [B, K-1, d_in], a rank's H / ``ranks`` heads and d_in /
    ``ranks`` channels of them over a model axis."""

    s = cfg.ssm or SSMConfig()
    d_in, nh, n = ssm_dims(cfg)
    return {
        "h": torch.zeros((batch, nh // ranks, _head_p(d_in), n), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_in // ranks), dtype=dtype,
                            device=device),
    }
