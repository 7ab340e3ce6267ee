"""Launcher of the hand-written Mamba scan backward
(``csrc/mamba_scan_bwd.cu``; the port's own kernel: the JAX package trains
through XLA's autodiff of ``ssd_chunked``, ``repro/models/ssm.py:94``, with
no Pallas counterpart).

x [B, S, H, P], dt [B, S, H], a [H], bm/c [B, S, N], h_in [B, nc, H, P, N]
(the state entering each chunk, ``mamba_scan(..., with_states=True)``), dy
[B, S, H, P] and dh_t [B, H, P, N] or None (zeros, nothing launched for
them), all float32 -> (dx, ddt, da, dbm, dc, dh0), shaped like x, dt, a,
bm, c and dh_t.  ``ref.mamba_scan_bwd_ref`` is its plain version.

Three launches on the current stream, counted as one
(``_lib.mamba_bwd_plan``): the states (dS and dh_out of each chunk, over
the chunks in reverse, and dh0), the chunk blocks, their products on the
tensor cores in 3xTF32, and the reduce of their partials.  dB and dC
(summed over the heads) and da (over batch rows and steps) are summed from
per-block partials in a fixed order, with no atomics: a rerun gives the
same bits.  The workspaces are allocated here.  Only CUDA tensors are
accepted.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mamba_scan import MAX_CHUNK, MAX_N, MAX_P

NAME = "mamba_scan_bwd"


def mamba_scan_bwd(x, dt, a, bm, c, h_in, dy, dh_t=None, chunk: int = 256):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    extra = () if dh_t is None else (dh_t,)
    _lib.check_tensors(x, dt, a, bm, c, h_in, dy, *extra, align=4)
    if x.dtype != torch.float32:
        raise TypeError(f"mamba_scan_bwd takes float32, got {x.dtype}")
    nc = s // chunk
    want = {"dt": (b, s, h), "a": (h,), "bm": (b, s, n), "c": (b, s, n),
            "h_in": (b, nc, h, p, n), "dy": (b, s, h, p), "dh_t": (b, h, p, n)}
    for name, t in zip(want, (dt, a, bm, c, h_in, dy, dh_t)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if chunk > MAX_CHUNK or p > MAX_P or n > MAX_N:
        raise ValueError(f"kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_P} and N <= {MAX_N}; "
                         f"got chunk {chunk}, P {p}, N {n}")
    plan = _lib.mamba_bwd_plan(b, s, h, p, n, chunk)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, ddt, dbm, dc = (torch.empty_like(t) for t in (x, dt, bm, c))
    da = torch.empty((h,), **f32)
    dh0 = torch.empty((b, h, p, n), **f32)
    # dh_out of each chunk, cum (float64) and dt by (chunk, head), the decay
    # terms; the chunk blocks' partials: rows of dcum, dB, dC
    dho = torch.empty_like(h_in)
    cumw = torch.empty((b, nc, h, plan.chunk), dtype=torch.float64, device=x.device)
    dtw = torch.empty((b, nc, h, plan.chunk), **f32)
    dterm = torch.empty((b, nc, h), **f32)
    rowp = torch.empty((b * nc * plan.row_tiles * h * plan.chunk,), **f32)
    dbp = torch.empty((plan.groups * b * s * n,), **f32)
    dcp = torch.empty((b * nc * plan.row_tiles * plan.groups * plan.chunk * n,), **f32)
    status = _lib.load(NAME)(
        *(t.data_ptr() for t in (x, dt, a, bm, c, h_in, dy)),
        None if dh_t is None else dh_t.data_ptr(),
        *(t.data_ptr() for t in (dx, ddt, da, dbm, dc, dh0, dho, cumw, dtw, dterm, rowp, dbp,
                                 dcp)),
        b, s, h, p, n, plan.chunk, plan.heads,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    return dx, ddt, da, dbm, dc, dh0
