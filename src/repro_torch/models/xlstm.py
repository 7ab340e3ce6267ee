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

On a tensor-parallel rank (``Model(group=...)``, M ranks, ``tp`` the
group) each block runs its share and names the collectives it makes:

* mLSTM: the rank's H / M heads, which are its d_in / M inner channels.
  ``up_proj`` holds its block of each half (xi | z); its block of xi is
  all-gathered once (every head's q, k, v and gates read all of xi);
  ``wq`` / ``wk`` / ``wv`` hold the rank's heads' output columns,
  ``w_if`` / ``if_bias`` the rank's heads of each gate (i | f); the chunked
  and step recurrences run unchanged on H / M heads; ``out_proj`` holds
  its rows and its partial products are all-reduced once.  One
  all-gather and one all-reduce a call.  State: C [B, H/M, Dh, Dh], n
  [B, H/M, Dh], m [B, H/M].
* sLSTM: the rank's D / M hidden units.  ``w_in``, ``w_rec`` and ``bias``
  hold the rank's units of each of the four gates (i, f, z, o); ``w_rec``'s
  rows stay whole, since ``h_{t-1}`` is read whole.  Each step updates the
  rank's c, n and m [B, D/M], then all-gathers h [B, D] in float32 (the
  gather adds nothing, so it is exact): one all-gather a token, S in a
  prefill of S tokens.  ``up`` holds its block of each half (gate | val),
  ``down`` its rows, and the output takes one all-reduce.  State: c, n, m
  [B, D/M] and h [B, D] whole.

Both blocks' output partial products are taken in float32, summed over
the ranks and rounded to the activations' dtype once (``_sum_over``), as
one rank rounds its product once: summed in bf16, each partial and the sum
would round again, and over xlstm-125m's 12 blocks that moved the first
prompt's logits 0.1318 from the one rank's (past 2^-5 of their largest,
4.156) where float32 partials leave 0.1016 (one H100, ``python3
tools/model_axis_diag.py xlstm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.launch.dist import all_gather_cat, all_reduce_sum
from repro_torch.models.layers import ACTIVATIONS, block_of, dense, global_shape, normal_

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
    ``wk``, ``wv``, ``w_if``, ``if_bias``, ``out_proj``).  ``d_in`` and
    ``nh`` are the channels and heads this module runs (a rank's share of
    them over ``tp``, the ranks of the model axis; all of them outside
    one)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_in, nh, _ = mlstm_dims(cfg)
        self.up_proj = _param((d, 2 * d_in), dtype, device)
        self.wq = _param((d_in, d_in), dtype, device)
        self.wk = _param((d_in, d_in), dtype, device)
        self.wv = _param((d_in, d_in), dtype, device)
        self.w_if = _param((d_in, 2 * nh), dtype, device)
        self.if_bias = _param((2 * nh,), torch.float32, device)
        self.out_proj = _param((d_in, d), dtype, device)
        self.d_in, self.nh, self.tp = d_in, nh, None

    def init(self, generator: torch.Generator) -> None:
        for w in (self.up_proj, self.wq, self.wk, self.wv, self.w_if, self.out_proj):
            normal_(w, global_shape(w)[0] ** -0.5, generator)
        # input gates 0, forget gates 3 (the reference's init); a rank keeps
        # its heads of each
        (n2,), index = block_of(self.if_bias)
        bias = torch.cat([torch.zeros(n2 // 2), torch.full((n2 // 2,), 3.0)])
        self.if_bias.copy_(bias[index])


def _sum_over(y, w, tp):
    """``y @ w`` where ``w`` holds a rank's rows of a weight cut over the
    ranks of ``tp``: the partial product in float32, summed over the ranks,
    rounded to ``y``'s dtype once (outside a model axis, ``dense``)."""

    if tp is None:
        return dense(y, w)
    return all_reduce_sum(y.float() @ w.float(), tp).to(y.dtype)


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
    from ``state``) -> (out [B,S,D], new state).  On a rank of ``p.tp``:
    its heads, one all-gather of xi and one all-reduce of the output."""

    d_in, nh, dh = p.d_in, p.nh, mlstm_dims(cfg)[2]  # this rank's channels and heads
    b, s = x_res.shape[:2]
    h = dense(x_res, p.up_proj)
    xi, z = all_gather_cat(h[..., :d_in], -1, p.tp), h[..., d_in:]
    q, k, v = (dense(xi, w).float() for w in (p.wq, p.wk, p.wv))
    i_gate, logf = _mlstm_gates(xi, p, nh)
    if step:
        y, new_state = mlstm_step(q.reshape(b, nh, dh), k.reshape(b, nh, dh),
                                  v.reshape(b, nh, dh), i_gate[:, 0], logf[:, 0], state)
    else:
        y, new_state = mlstm_chunked(q.reshape(b, s, nh, dh), k.reshape(b, s, nh, dh),
                                     v.reshape(b, s, nh, dh), i_gate, logf, state=state)
    y = y.reshape(b, s, d_in).to(x_res.dtype) * F.silu(z)
    return _sum_over(y, p.out_proj, p.tp), new_state


def zero_mlstm_state(batch: int, nh: int, dh: int, device="cuda"):
    """(C, n, m) of ``batch`` rows: zeros, the stabilizer at -1e30."""

    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, nh, dh, dh), **z), torch.zeros((batch, nh, dh), **z),
            torch.full((batch, nh), M_FLOOR, **z))


def init_mlstm_state(cfg: ModelConfig, batch: int, device="cuda", ranks: int = 1):
    """A zero state of one mLSTM layer; a rank's H / ``ranks`` heads of it
    over a model axis."""

    _, nh, dh = mlstm_dims(cfg)
    return zero_mlstm_state(batch, nh // ranks, dh, device)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """sLSTM parameters under the reference's names: the four gates' (i, f,
    z, o) input and recurrent weights ``w_in`` / ``w_rec``, their float32
    ``bias``, and the GLU projections ``up`` / ``down``.  ``units`` are the
    hidden units this module runs (a rank's D / M over ``tp``; all D
    outside a model axis)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_up = int((cfg.xlstm or XLSTMConfig()).proj_factor_slstm * d)
        self.w_in = _param((d, 4 * d), dtype, device)
        self.w_rec = _param((d, 4 * d), dtype, device)
        self.bias = _param((4 * d,), torch.float32, device)
        self.up = _param((d, 2 * d_up), dtype, device)
        self.down = _param((d_up, d), dtype, device)
        self.units, self.tp = d, None

    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_in, self.w_rec, self.up, self.down):
            normal_(w, global_shape(w)[0] ** -0.5, generator)
        self.bias.zero_()


def _slstm_cell(w_rec, bias, units: int, carry, x_in, tp=None):
    """One step.  ``x_in`` [B, 4U]: the input's gate pre-activations (x_t
    @ w_in, float32) of this rank's U units; carry (c, n, m [B, U], h
    [B, D]).  The rank's new h [B, U] is all-gathered over ``tp``."""

    c, n, h, m = carry
    pre = x_in + h @ w_rec + bias
    i_raw, f_raw, z_raw, o_raw = torch.split(pre, units, dim=-1)
    logf = F.logsigmoid(f_raw)
    m_new = torch.maximum(logf + m, i_raw)
    i_st = torch.exp(i_raw - m_new)
    f_st = torch.exp(logf + m - m_new)
    c_new = f_st * c + i_st * torch.tanh(z_raw)
    n_new = f_st * n + i_st
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, all_gather_cat(h_new, -1, tp), m_new)


def slstm_forward(x_res, p: SLSTM, cfg: ModelConfig, state=None, step: bool = False):
    """An sLSTM block's mixer over x [B,S,D], token by token from ``state``
    (None: zeros, m = -1e30) -> (out [B,S,D], new state).  On a rank of
    ``p.tp``: its units, one all-gather of h a token and one all-reduce of
    the output."""

    b, s = x_res.shape[:2]
    if state is None:
        state = zero_slstm_state(b, p.units, cfg.d_model, x_res.device)
    # float32 gate matmuls on the upcast weights, cast once this call
    x_in = x_res.float() @ p.w_in.float()
    w_rec = p.w_rec.float()
    hs = []
    for t in range(1 if step else s):
        state = _slstm_cell(w_rec, p.bias, p.units, state, x_in[:, t], p.tp)
        hs.append(state[2])
    h_seq = torch.stack(hs, dim=1).to(x_res.dtype)
    up = dense(h_seq, p.up)
    d_up = p.down.shape[0]
    gate, val = up[..., :d_up], up[..., d_up:]
    return _sum_over(ACTIVATIONS["gelu"](gate) * val, p.down, p.tp), state


def zero_slstm_state(batch: int, units: int, d: int, device="cuda"):
    """(c, n, h, m): c, n, m [batch, units] and h [batch, d] (whole: every
    rank reads all of h), zeros, the stabilizer at -1e30."""

    z = dict(dtype=torch.float32, device=device)
    return (torch.zeros((batch, units), **z), torch.zeros((batch, units), **z),
            torch.zeros((batch, d), **z), torch.full((batch, units), M_FLOOR, **z))


def init_slstm_state(cfg: ModelConfig, batch: int, device="cuda", ranks: int = 1):
    """A zero state of one sLSTM layer; a rank's D / ``ranks`` units of c, n
    and m over a model axis (h whole)."""

    return zero_slstm_state(batch, cfg.d_model // ranks, cfg.d_model, device)
