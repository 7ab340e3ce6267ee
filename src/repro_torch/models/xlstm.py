"""xLSTM blocks of the port (counterpart of ``repro/models/xlstm.py``;
arXiv:2405.04517): mLSTM (a matrix memory, parallel over a chunk) and sLSTM
(a scalar memory, strictly sequential).

Neither reaches a kernel of the reference: both are XLA there, plain
PyTorch here.  The mLSTM's parallel form is evaluated chunkwise (quadratic
inside a chunk, recurrent across chunks), the sLSTM's recurrence one token
at a time (``h_{t-1}`` feeds the gates).

Numerics follow the reference: q, k, v and the gates in float32 (the
projections run in the activations' dtype and are cast), the gate biases
(``if_bias``, ``bias``) float32 parameters even in a bf16 stack, the sLSTM
gate matmuls in float32 on upcast weights (cast once a call: once a prompt
in a prefill, once a token in a decode step; the upcast is exact), log-space
stabilizers starting at -1e30 and clamped there, so that no ``-inf - -inf``
(NaN in torch and jax alike) is formed.

State (tuples, as the reference's): mLSTM ``(C [B,H,Dh,Dh], n [B,H,Dh],
m [B,H])``, sLSTM ``(c, n, h, m)`` each [B, D], all float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.models.layers import ACTIVATIONS, dense, normal_

M_FLOOR = -1e30  # the stabilizers' start and floor


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg: ModelConfig):
    """(d_in, heads, head size): the head is ``d_in // num_heads`` (384 at
    xlstm-125m), not ``head_dim``."""

    x = cfg.xlstm or XLSTMConfig()
    d_in = int(x.proj_factor_mlstm * cfg.d_model)
    return d_in, cfg.num_heads, d_in // cfg.num_heads


class MLSTM(nn.Module):
    """mLSTM parameters under the reference's names (``up_proj``, ``wq``,
    ``wk``, ``wv``, ``w_if``, ``if_bias``, ``out_proj``)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _ = mlstm_dims(cfg)
        self.nh = nh
        self.up_proj = _param((d, 2 * d_in), dtype, device)
        self.wq = _param((d_in, d_in), dtype, device)
        self.wk = _param((d_in, d_in), dtype, device)
        self.wv = _param((d_in, d_in), dtype, device)
        self.w_if = _param((d_in, 2 * nh), dtype, device)
        self.if_bias = _param((2 * nh,), torch.float32, device)
        self.out_proj = _param((d_in, d), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.up_proj, self.wq, self.wk, self.wv, self.w_if, self.out_proj):
            normal_(w, w.shape[0] ** -0.5, generator)
        # input gates 0, forget gates 3 (the reference's init)
        self.if_bias.copy_(torch.cat([torch.zeros(self.nh), torch.full((self.nh,), 3.0)]))


def _mlstm_gates(xi, p: MLSTM, nh: int):
    """-> (input gate, log forget gate) [..., H] float32."""

    gates = dense(xi, p.w_if).float() + p.if_bias
    return gates[..., :nh], F.logsigmoid(gates[..., nh:])


def mlstm_chunked(q, k, v, i_gate, logf, chunk: int = 256, state=None):
    """Chunkwise-parallel mLSTM.  q, k, v [B,S,H,Dh] float32; i_gate, logf
    [B,S,H] float32; ``state`` (C, n, m) or None (zeros, m = -1e30) ->
    (y [B,S,H,Dh], state).  ``min(chunk, S)`` must divide S."""

    b, s, nh, dh = q.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    qr = q.reshape(b, nc, chunk, nh, dh) * (dh**-0.5)
    kr = k.reshape(b, nc, chunk, nh, dh)
    vr = v.reshape(b, nc, chunk, nh, dh)
    ir = i_gate.reshape(b, nc, chunk, nh)
    cumf = torch.cumsum(logf.reshape(b, nc, chunk, nh), dim=2)  # inclusive
    # log weight of source s seen at target t: cumf[t] - cumf[s] + i[s], s <= t
    logd = cumf[:, :, :, None, :] - cumf[:, :, None, :, :] + ir[:, :, None, :, :]
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    logd = logd.masked_fill(~tril[None, None, :, :, None], float("-inf"))
    c, n, m = zero_mlstm_state(b, nh, dh, q.device) if state is None else state
    ys = []
    for j in range(nc):
        qc, kc, vc, ic = qr[:, j], kr[:, j], vr[:, j], ir[:, j]   # [B,L,H,*]
        logd_c, cumf_c = logd[:, j], cumf[:, j]                   # [B,t,s,H], [B,L,H]
        # stabilizer at each target t: the in-chunk and the carried weights
        m_carry = cumf_c + m[:, None, :]
        m_t = torch.maximum(logd_c.amax(dim=2), m_carry).clamp_min(M_FLOOR)
        w_intra = torch.exp(logd_c - m_t[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qc, kc) * w_intra
        y_num = torch.einsum("btsh,bshd->bthd", scores, vc)
        y_den = scores.sum(dim=2)
        w_carry = torch.exp(m_carry - m_t)
        y_num = y_num + torch.einsum("bthd,bhde,bth->bthe", qc, c, w_carry)
        y_den = y_den + torch.einsum("bthd,bhd,bth->bth", qc, n, w_carry)
        ys.append(y_num / torch.clamp(y_den.abs(), min=1.0)[..., None])
        # the state at the chunk's end
        f_total = cumf_c[:, -1]
        m_out = torch.maximum(f_total + m, (cumf_c[:, -1:, :] - cumf_c + ic).amax(dim=1))
        w_state = torch.exp(f_total[:, None] - cumf_c + ic - m_out[:, None])
        decay = torch.exp(f_total + m - m_out)
        c = c * decay[:, :, None, None] + torch.einsum("blh,blhd,blhe->bhde", w_state, kc, vc)
        n = n * decay[:, :, None] + torch.einsum("blh,blhd->bhd", w_state, kc)
        m = m_out
    return torch.stack(ys, dim=1).reshape(b, s, nh, dh), (c, n, m)


def mlstm_step(q, k, v, i_gate, logf, state):
    """One-token mLSTM update.  q, k, v [B,H,Dh]; i_gate, logf [B,H]."""

    c, n, m = state
    dh = q.shape[-1]
    m_new = torch.maximum(logf + m, i_gate)
    w_prev = torch.exp(logf + m - m_new)
    w_in = torch.exp(i_gate - m_new)
    c = c * w_prev[:, :, None, None] + torch.einsum("bhd,bhe->bhde", k, v) * w_in[:, :, None, None]
    n = n * w_prev[:, :, None] + k * w_in[:, :, None]
    q = q * (dh**-0.5)
    y_num = torch.einsum("bhd,bhde->bhe", q, c)
    y_den = torch.einsum("bhd,bhd->bh", q, n)
    return y_num / torch.clamp(y_den.abs(), min=1.0)[..., None], (c, n, m_new)


def mlstm_forward(x_res, p: MLSTM, cfg: ModelConfig, state=None, step: bool = False):
    """An mLSTM block's mixer over x [B,S,D] (``step``: one token, S = 1,
    from ``state``) -> (out [B,S,D], new state)."""

    d_in, nh, dh = mlstm_dims(cfg)
    b, s = x_res.shape[:2]
    h = dense(x_res, p.up_proj)
    xi, z = h[..., :d_in], h[..., d_in:]
    q, k, v = (dense(xi, w).float() for w in (p.wq, p.wk, p.wv))
    i_gate, logf = _mlstm_gates(xi, p, nh)
    if step:
        y, new_state = mlstm_step(q.reshape(b, nh, dh), k.reshape(b, nh, dh),
                                  v.reshape(b, nh, dh), i_gate[:, 0], logf[:, 0], state)
    else:
        y, new_state = mlstm_chunked(q.reshape(b, s, nh, dh), k.reshape(b, s, nh, dh),
                                     v.reshape(b, s, nh, dh), i_gate, logf, state=state)
    y = y.reshape(b, s, d_in).to(x_res.dtype) * F.silu(z)
    return dense(y, p.out_proj), new_state


def zero_mlstm_state(batch: int, nh: int, dh: int, device="cpu"):
    """(C, n, m) of ``batch`` rows: zeros, the stabilizer at -1e30."""

    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, nh, dh, dh), **z), torch.zeros((batch, nh, dh), **z),
            torch.full((batch, nh), M_FLOOR, **z))


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cpu"):
    _, nh, dh = mlstm_dims(cfg)
    return zero_mlstm_state(batch, nh, dh, device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """sLSTM parameters under the reference's names: the four gates' (i, f,
    z, o) input and recurrent weights ``w_in`` / ``w_rec``, their float32
    ``bias``, and the GLU projections ``up`` / ``down``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_up = int((cfg.xlstm or XLSTMConfig()).proj_factor_slstm * d)
        self.w_in = _param((d, 4 * d), dtype, device)
        self.w_rec = _param((d, 4 * d), dtype, device)
        self.bias = _param((4 * d,), torch.float32, device)
        self.up = _param((d, 2 * d_up), dtype, device)
        self.down = _param((d_up, d), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_in, self.w_rec, self.up, self.down):
            normal_(w, w.shape[0] ** -0.5, generator)
        self.bias.zero_()


def _slstm_cell(w_rec, bias, d: int, carry, x_in):
    """One step.  ``x_in`` [B, 4D]: the input's gate pre-activations (x_t
    @ w_in, float32); carry (c, n, h, m)."""

    c, n, h, m = carry
    pre = x_in + h @ w_rec + bias
    i_raw, f_raw, z_raw, o_raw = torch.split(pre, d, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_st = torch.exp(i_raw - m_new)
    f_st = torch.exp(logf + m - m_new)
    c_new = f_st * c + i_st * torch.tanh(z_raw)
    n_new = f_st * n + i_st
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new)


def slstm_forward(x_res, p: SLSTM, cfg: ModelConfig, state=None, step: bool = False):
    """An sLSTM block's mixer over x [B,S,D], token by token from ``state``
    (None: zeros, m = -1e30) -> (out [B,S,D], new state)."""

    d = cfg.d_model
    b, s = x_res.shape[:2]
    if state is None:
        state = init_slstm_state(cfg, b, x_res.device)
    # float32 gate matmuls on the upcast weights, cast once this call
    x_in = x_res.float() @ p.w_in.float()
    w_rec = p.w_rec.float()
    hs = []
    for t in range(1 if step else s):
        state = _slstm_cell(w_rec, p.bias, d, state, x_in[:, t])
        hs.append(state[2])
    h_seq = torch.stack(hs, dim=1).to(x_res.dtype)
    up = dense(h_seq, p.up)
    d_up = p.down.shape[0]
    gate, val = up[..., :d_up], up[..., d_up:]
    return dense(ACTIVATIONS["gelu"](gate) * val, p.down), state


def init_slstm_state(cfg: ModelConfig, batch: int, device="cpu"):
    z = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return (torch.zeros((batch, d), **z), torch.zeros((batch, d), **z),
            torch.zeros((batch, d), **z), torch.full((batch, d), M_FLOOR, **z))
