"""Plain PyTorch versions of the kernels (CPU path and card oracle).

Each function computes what its CUDA kernel computes and is what
``kernels.ops`` runs for a tensor on the CPU.  The attention ones keep
scores, softmax and the value sum in float32 and cast the output to the
query dtype.  ``chip_smoke.py`` holds each
kernel against these on the card.  They mirror ``repro.kernels.ref``:

* masked logits are ``NEG_INF = -1e30`` as in the kernels (the model's
  ``_sdpa`` uses ``-2e38``; both exp to exactly 0);
* the reference model's dense decode (``_sdpa``, attention.py:95-112) takes
  the score einsum in the input dtype before casting to float32 and casts
  the probabilities back to the value dtype; the port's decode path keeps
  both in float32 — the same in float32 stacks, a rounding difference in
  bf16, where parity is held only by the greedy-margin rule;
* ``paged_decode_attention_ref`` returns **0** for a row with length 0, as
  the kernels do (the JAX oracle returns the uniform mean there), and keeps
  the probabilities in float32 (the JAX oracle casts them to the value
  dtype, a difference visible only in bf16).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention_ref(q, k, v, *, causal=True, window=0, logit_cap=0.0):
    """[B,S,H,D] x [B,S,KV,D]^2 -> [B,S,H,D]; materializes the score matrix."""

    b, s, h, d = q.shape
    g = h // k.shape[2]
    kr = k.float().repeat_interleave(g, dim=2)
    vr = v.float().repeat_interleave(g, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * d**-0.5
    logits = _softcap(logits, logit_cap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr).to(q.dtype)


BLK_Q = 128  # query rows a block of the training plain versions (the reference's blk_q)


def _acc_dtype(t):
    """float32, or float64 for float64 inputs (gradcheck)."""

    return torch.promote_types(t.dtype, torch.float32)


def _train_blocks(q, k, causal, window, blk_q):
    """Yield (q0, q1, visible [L, S] bool) for the query blocks of a
    training call."""

    s, sk = q.shape[1], k.shape[1]
    kp = torch.arange(sk, device=q.device)[None, :]
    for q0 in range(0, s, blk_q):
        q1 = min(q0 + blk_q, s)
        qp = torch.arange(q0, q1, device=q.device)[:, None]
        vis = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            vis &= qp >= kp
        if window:
            vis &= (qp - kp) < window
        yield q0, q1, vis


def _block_scores(qi, kf, vis, scale, logit_cap):
    """qi [B,L,KV,G,D]; kf [B,S,KV,D] -> (softcapped scores sc, masked
    scores) [B,KV,G,L,S]."""

    sc = _softcap(torch.einsum("blkgd,bskd->bkgls", qi, kf) * scale, logit_cap)
    return sc, torch.where(vis, sc, torch.full_like(sc, NEG_INF))


def flash_attention_lse_ref(q, k, v, *, causal=True, window=0, logit_cap=0.0, blk_q=BLK_Q):
    """The training forward: q [B,S,H,D], k/v [B,S,KV,D] -> (out [B,S,H,D]
    in q's dtype, lse [B,H,S] float32), the reference's ``_fwd_math``
    (repro/models/attention.py:225-241) a block of ``blk_q`` query rows at a
    time, so no [S, S] buffer forms.  lse is the log-sum-exp of each row's
    softcapped, scaled scores (the backward's softmax statistic)."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    acc = _acc_dtype(q)
    kf, vf = k.to(acc), v.to(acc)
    out = torch.empty((b, s, h, d), dtype=acc, device=q.device)
    lse = torch.empty((b, kv, g, s), dtype=acc, device=q.device)
    for q0, q1, vis in _train_blocks(q, k, causal, window, blk_q):
        qi = q[:, q0:q1].to(acc).reshape(b, q1 - q0, kv, g, d)
        _, sm = _block_scores(qi, kf, vis, d**-0.5, logit_cap)
        m = sm.amax(-1, keepdim=True).clamp_min(NEG_INF)
        p = torch.exp(sm - m)
        l = p.sum(-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bkgls,bskd->blkgd", p, vf) / l.permute(0, 3, 1, 2, 4)
        out[:, q0:q1] = o.reshape(b, q1 - q0, h, d)
        lse[..., q0:q1] = (m + torch.log(l))[..., 0]
    lse_dt = torch.float64 if acc == torch.float64 else torch.float32
    return out.to(q.dtype), lse.reshape(b, h, s).to(lse_dt)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal=True, window=0, logit_cap=0.0,
                            blk_q=BLK_Q):
    """The training backward -> (dq, dk, dv) in the inputs' dtypes, the
    reference's ``strip_bwd`` (repro/models/attention.py:261-285) a block
    of ``blk_q`` query rows at a time: P recomputed from ``lse`` [B,H,S],
    ``delta = rowsum(dout * out)``, ``ds = p * (dp - delta)`` times the
    softcap's derivative ``1 - (sc / cap)^2``, dk and dv summed over the G
    query heads of each KV head and over the blocks."""

    b, s, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    scale = d**-0.5
    acc = _acc_dtype(q)
    kf, vf = k.to(acc), v.to(acc)
    dq = torch.empty((b, s, h, d), dtype=acc, device=q.device)
    dk = torch.zeros(kf.shape, dtype=acc, device=q.device)
    dv = torch.zeros(vf.shape, dtype=acc, device=q.device)
    lse = lse.to(acc).reshape(b, kv, g, s)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)  # [B,S,H]
    delta = delta.permute(0, 2, 1).reshape(b, kv, g, s)
    for q0, q1, vis in _train_blocks(q, k, causal, window, blk_q):
        n = q1 - q0
        qi = q[:, q0:q1].to(acc).reshape(b, n, kv, g, d)
        doi = dout[:, q0:q1].to(acc).reshape(b, n, kv, g, d)
        sc, sm = _block_scores(qi, kf, vis, scale, logit_cap)
        p = torch.exp(sm - lse[..., q0:q1, None])
        dv += torch.einsum("bkgls,blkgd->bskd", p, doi)
        dp = torch.einsum("blkgd,bskd->bkgls", doi, vf)
        ds = p * (dp - delta[..., q0:q1, None])
        if logit_cap:
            ds = ds * (1.0 - torch.square(sc / logit_cap))
        ds = ds * scale
        dq[:, q0:q1] = torch.einsum("bkgls,bskd->blkgd", ds, kf).reshape(b, n, h, d)
        dk += torch.einsum("bkgls,blkgd->bskd", ds, qi)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _attend_rows(q, k, v, valid, logit_cap):
    """q [B,H,D]; k/v [B,S,KV,D]; valid [B,S] -> [B,H,D] (rows with no valid
    position give 0)."""

    b, h, d = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.float().reshape(b, kv, g, d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d**-0.5
    logits = _softcap(logits, logit_cap)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1) * valid[:, None, None, :]
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def _valid(lens, s, window, device):
    pos = torch.arange(s, device=device)[None, :]
    lens = lens[:, None]
    valid = pos < lens
    if window:
        valid &= pos >= lens - window
    return valid


def decode_attention_ref(q, cache_k, cache_v, *, cache_len, window=0, logit_cap=0.0):
    """q [B,H,D], cache [B,S,KV,D] -> [B,H,D] over cache[:cache_len].

    ``cache_len`` is an int shared by the batch or a [B] int tensor.
    """

    b, s = cache_k.shape[:2]
    lens = torch.as_tensor(cache_len, device=q.device).expand(b)
    return _attend_rows(q, cache_k, cache_v, _valid(lens, s, window, q.device), logit_cap)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, cache_lens, *,
                               window=0, logit_cap=0.0):
    """Ragged paged decode: gather each row's pages into a dense
    [MAXP*page] cache and attend over its first ``cache_lens[b]`` slots.

    q [B,H,D]; k/v pages [P,page,KV,D]; page_table [B,MAXP]; cache_lens [B].
    """

    _, page, kv, d = k_pages.shape
    b = q.shape[0]
    table = page_table.long()
    k = k_pages[table].reshape(b, -1, kv, d)
    v = v_pages[table].reshape(b, -1, kv, d)
    valid = _valid(cache_lens.long(), k.shape[1], window, q.device)
    return _attend_rows(q, k, v, valid, logit_cap)


def mamba_scan_ref(x, dt, a, bm, c, h0=None, chunk: int = 256, with_states: bool = False):
    """Chunked SSD scan; torch twin of ``repro.models.ssm.ssd_chunked``.

    x [B,S,H,P], dt [B,S,H] (post-softplus), a [H] (negative), bm/c
    [B,S,N], h0 [B,H,P,N] or None (zeros) -> (y [B,S,H,P], hT [B,H,P,N]),
    and with ``with_states`` also h_in [B,nc,H,P,N], the state entering each
    chunk (what the backward reads).  Materialises the [B, chunks, L, L, H]
    decay tensor.
    """

    b, s, nh, p = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    xr = x.reshape(b, nc, chunk, nh, p)
    dtr = dt.reshape(b, nc, chunk, nh)
    bmr = bm.reshape(b, nc, chunk, n)
    cr = c.reshape(b, nc, chunk, n)

    cum = torch.cumsum(dtr * a, dim=2)  # inclusive cumsum of the log-decay
    # ---- intra-chunk quadratic form ----
    g = torch.einsum("bctn,bcsn->bcts", cr, bmr)
    w = g[..., None] * _decay(cum) * dtr[:, :, None, :, :]
    y = torch.einsum("bctsh,bcshp->bcthp", w, xr)

    # ---- inter-chunk recurrence over chunk states ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    sc = torch.einsum("bcsh,bcsn,bcshp->bchpn", decay_to_end * dtr, bmr, xr)
    chunk_decay = torch.exp(cum[:, :, -1, :])
    h = torch.zeros((b, nh, p, n), dtype=x.dtype, device=x.device) if h0 is None else h0
    h_prev = []
    for ci in range(nc):
        h_prev.append(h)  # the state entering chunk ci
        h = h * chunk_decay[:, ci, :, None, None] + sc[:, ci]
    h_prev = torch.stack(h_prev, dim=1)
    y_carry = torch.einsum("bctn,bchpn,bcth->bcthp", cr, h_prev, torch.exp(cum))
    y = (y + y_carry).reshape(b, s, nh, p)
    return (y, h, h_prev) if with_states else (y, h)


def _decay(cum):
    """exp(cum[t] - cum[s]) for s <= t, else 0: [B, nc, t, s, H] from cum
    [B, nc, L, H]; masked BEFORE the exp, since above the diagonal the
    difference is > 0 and can overflow."""

    chunk = cum.shape[2]
    m = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # decay s -> t: cum[t] - cum[s]
    tril = torch.ones((chunk, chunk), dtype=torch.bool, device=cum.device).tril()
    return torch.exp(torch.where(tril[None, None, :, :, None], m, torch.full_like(m, -1e30)))


def mamba_scan_bwd_ref(x, dt, a, bm, c, h_in, dy, dh_t=None, chunk: int = 256):
    """The gradients of ``mamba_scan_ref`` -> (dx, ddt, da, dbm, dc, dh0),
    written out step by step in the scan's chunked form (not autograd).

    h_in [B,nc,H,P,N] is the state entering each chunk (``mamba_scan_ref(...,
    with_states=True)``); dy [B,S,H,P] and dh_t [B,H,P,N] (None: zeros) the
    cotangents of y and hT.  Per (batch row, chunk, head), with la = dt a,
    cum its inclusive prefix sum in the chunk, E[t,s] = exp(cum[t] - cum[s])
    for s <= t and G = C B^T:
      states, over the chunks in reverse: dh_in = exp(cum[L-1]) dh_out +
        sum_t exp(cum[t]) dy_t C_t^T, dh_out of the last chunk = dh_t, of
        chunk c - 1 = dh_in of chunk c, dh0 = dh_in of chunk 0;
      r_s = sum_{t>=s} G[t,s] E[t,s] dy_t + exp(cum[L-1] - cum[s]) dh_out B_s:
        dx_s = dt_s r_s and the direct part of ddt_s = x_s . r_s;
      with Q[t,s] = E[t,s] dt_s (dy_t . x_s): dC_t = sum_s Q[t,s] B_s +
        exp(cum[t]) h_in^T dy_t, dB_s = sum_t Q[t,s] C_t + exp(cum[L-1] -
        cum[s]) dt_s dh_out^T x_s, both summed over the heads;
      dcum: the in-chunk pairs W = G Q (+ at t, - at s), the carried state
        (+ exp(cum[t]) dy_t . h_in C_t), the chunk state (- V_s at s, with
        V_s = exp(cum[L-1] - cum[s]) dt_s x_s . dh_out B_s, and their sum at
        L-1) and the chunk decay (+ exp(cum[L-1]) <dh_out, h_in> at L-1); its
        reverse prefix sum in the chunk is dla, so ddt += dla a and da =
        sum dla dt.
    """

    t = mamba_bwd_terms(x, dt, a, bm, c, h_in, dy, dh_t, chunk)
    return mamba_bwd_finish(t, t["row"] - t["col"] + t["carry"] - t["v"], a)


def mamba_bwd_terms(x, dt, a, bm, c, h_in, dy, dh_t, chunk):
    """``mamba_scan_bwd_ref``'s terms: dx, dbm, dc, dh0 as it returns them,
    the direct part of ddt ([B,nc,L,H]), dcum's terms row (sum over s of W),
    col (over t), carry, v ([B,nc,L,H]) and the one at L-1 ("last",
    [B,nc,H]), dt in chunks, and the shapes."""

    b, s, nh, p = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    nc = s // chunk
    xr, dyr = x.reshape(b, nc, chunk, nh, p), dy.reshape(b, nc, chunk, nh, p)
    dtr = dt.reshape(b, nc, chunk, nh)
    bmr, cr = bm.reshape(b, nc, chunk, n), c.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dtr * a, dim=2)
    from_start = torch.exp(cum)  # [B,nc,L,H]
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B,nc,H]

    # ---- the states, over the chunks in reverse ----
    ds = torch.einsum("bcth,bcthp,bctn->bchpn", from_start, dyr, cr)
    dh = torch.zeros_like(h_in[:, 0]) if dh_t is None else dh_t
    dh_out = [None] * nc
    for ci in reversed(range(nc)):
        dh_out[ci] = dh
        dh = dh * chunk_decay[:, ci, :, None, None] + ds[:, ci]
    dh0, dh_out = dh, torch.stack(dh_out, dim=1)

    # ---- in-chunk: r, dx and the direct part of ddt ----
    g = torch.einsum("bctn,bcsn->bcts", cr, bmr)
    e = _decay(cum)  # [B,nc,t,s,H]
    dhb = torch.einsum("bchpn,bcsn->bcshp", dh_out, bmr)  # dh_out B_s
    r = torch.einsum("bcts,bctsh,bcthp->bcshp", g, e, dyr) + to_end[..., None] * dhb

    # ---- dC and dB, summed over the heads ----
    q = e * dtr[:, :, None, :, :] * torch.einsum("bcthp,bcshp->bctsh", dyr, xr)
    dc = (torch.einsum("bctsh,bcsn->bctn", q, bmr)
          + torch.einsum("bcth,bchpn,bcthp->bctn", from_start, h_in, dyr))
    dbm = (torch.einsum("bctsh,bctn->bcsn", q, cr)
           + torch.einsum("bcsh,bchpn,bcshp->bcsn", to_end * dtr, dh_out, xr))

    # ---- dcum's terms ----
    w = g[..., None] * q
    v = to_end * dtr * (xr * dhb).sum(-1)
    return dict(
        dx=(dtr[..., None] * r).reshape(b, s, nh, p), dbm=dbm.reshape(b, s, n),
        dc=dc.reshape(b, s, n), dh0=dh0, direct=(xr * r).sum(-1),
        row=w.sum(3), col=w.sum(2), v=v,
        carry=from_start * torch.einsum("bcthp,bchpn,bctn->bcth", dyr, h_in, cr),
        last=v.sum(2) + chunk_decay * (dh_out * h_in).sum((-1, -2)), dtr=dtr,
        shape=(b, s, nh))


def mamba_bwd_finish(t, dcum, a):
    """dcum [B,nc,L,H] (without its term at L-1) -> (dx, ddt, da, dbm, dc,
    dh0): dla is dcum's reverse prefix sum in each chunk, ddt = direct + dla
    a, da = sum dla dt."""

    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + t["last"][:, :, None]], dim=2)
    dla = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])
    ddt = t["direct"] + dla * a
    da = (dla * t["dtr"]).sum((0, 1, 2))
    return t["dx"], ddt.reshape(t["shape"]), da, t["dbm"], t["dc"], t["dh0"]


def rolling_stats_ref(m_acc, tau_pow, *, window_acc=64, window_tau=16, sigma_floor_acc=1.0,
                      sigma_floor_tau=0.05, eps=1e-6):
    """RAPID monitor over [N, T] streams; torch twin of
    ``repro.kernels.ref.rolling_stats_ref`` -> (score_acc, score_tau, m_tau).

    Tick by tick, as ``core.trigger`` updates its state: the acceleration
    window's mean and variance recomputed over the ring (the kernel keeps
    incremental sums instead), floored by a Welford running sigma; the Eq. 5
    moving average of the torque power and its running z-score.
    """

    n, t_len = m_acc.shape
    f32 = dict(dtype=torch.float32, device=m_acc.device)
    m_acc, tau_pow = m_acc.float(), tau_pow.float()
    abuf, tbuf = torch.zeros((n, window_acc), **f32), torch.zeros((n, window_tau), **f32)
    slots_a = torch.arange(window_acc, device=m_acc.device)
    slots_t = torch.arange(window_tau, device=m_acc.device)
    r_cnt, r_mean, r_m2 = (torch.zeros(n, **f32) for _ in range(3))
    tr_cnt, tr_mean, tr_m2 = (torch.zeros(n, **f32) for _ in range(3))
    outs = [torch.empty((n, t_len), **f32) for _ in range(3)]
    for t in range(t_len):
        ma, tp = m_acc[:, t], tau_pow[:, t]

        abuf[:, t % window_acc] = ma
        acnt = min(t + 1, window_acc)
        live = slots_a < acnt
        mean_a = torch.where(live, abuf, 0.0).sum(-1) / acnt
        var_a = torch.where(live, torch.square(abuf - mean_a[:, None]), 0.0).sum(-1) / acnt
        r_cnt = r_cnt + 1
        d1 = ma - r_mean
        r_mean = r_mean + d1 / r_cnt
        r_m2 = r_m2 + d1 * (ma - r_mean)
        sig_run = torch.sqrt(torch.clamp(r_m2 / torch.clamp(r_cnt, min=1), min=0))
        sig_a = torch.clamp(torch.maximum(torch.sqrt(torch.clamp(var_a, min=0)), sig_run),
                            min=sigma_floor_acc)
        outs[0][:, t] = (ma - mean_a) / (sig_a + eps)

        tbuf[:, t % window_tau] = tp
        tcnt = min(t + 1, window_tau)
        m_tau = torch.where(slots_t < tcnt, tbuf, 0.0).sum(-1) / tcnt
        tr_cnt = tr_cnt + 1
        d2 = m_tau - tr_mean
        tr_mean = tr_mean + d2 / tr_cnt
        tr_m2 = tr_m2 + d2 * (m_tau - tr_mean)
        sig_t = torch.clamp(torch.sqrt(torch.clamp(tr_m2 / torch.clamp(tr_cnt, min=1), min=0)),
                            min=sigma_floor_tau)
        outs[1][:, t] = (m_tau - tr_mean) / (sig_t + eps)
        outs[2][:, t] = m_tau
    return tuple(outs)
