"""Launcher of the hand-written chunked SSD scan kernel
(``csrc/mamba_scan.cu``; replaces the TPU kernel
``repro/kernels/mamba_scan.py:85``, ``pallas_call`` at :106).

x [B, S, H, P], dt [B, S, H], a [H], bm/c [B, S, N], optional h0
[B, H, P, N], all float32 -> (y [B, S, H, P], hT [B, H, P, N]).  The scan
runs in chunks of ``min(chunk, S)`` steps, which must divide S, as the
reference's ``ssd_chunked`` asserts; it starts from ``h0`` when given and
from a zero state otherwise.  Only CUDA tensors are accepted.

Bound on an H100: bytes at Jamba's served prompt (S = 14: x, y and the
state, ~2.9 MB, 0.87 us); float32 operations from chunks of ~100 steps on.
The kernel is chunk-parallel, in the three stages of ``ssd_chunked``: chunk
states, the pass over the chunks, and the intra-chunk scan, whose G = C B^T
is built once per row tile and shared by a block's heads
(``_lib.mamba_plan``).  A prompt of one chunk takes one kernel launch;
longer ones take three (the pass's workspaces are allocated here).  Either
way a call counts one launch.  ``with_states=True`` (the training
forward) also returns h_in [B, nc, H, P, N], the state entering each chunk:
the pass's workspace, or, for one chunk, h0 (zeros without it); the
launches are the same.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _lib

NAME = "mamba_scan"
MAX_CHUNK, MAX_P, MAX_N = 256, 64, 32


def mamba_scan(x, dt, a, bm, c, h0=None, chunk: int = 256, with_states: bool = False):
    b, s, h, p = x.shape
    n = bm.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the chunk {chunk}")
    extra = () if h0 is None else (h0,)
    _lib.check_tensors(x, dt, a, bm, c, *extra, align=4)
    if x.dtype != torch.float32:
        raise TypeError(f"mamba_scan takes float32, got {x.dtype}")
    want = {"dt": (b, s, h), "a": (h,), "bm": (b, s, n), "c": (b, s, n), "h0": (b, h, p, n)}
    for name, t in zip(want, (dt, a, bm, c, h0)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
    if chunk > MAX_CHUNK or p > MAX_P or 256 % p or n > MAX_N:
        raise ValueError(f"kernel takes chunk <= {MAX_CHUNK}, P <= {MAX_P} dividing 256 and "
                         f"N <= {MAX_N}; got chunk {chunk}, P {p}, N {n}")
    plan = _lib.mamba_plan(b, s, h, p, n, chunk)
    y = torch.empty_like(x)
    h_t = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    sc = dec = h_in = None
    if not plan.fused:  # chunk states, their decays and the states entering each chunk
        sc = torch.empty((b, plan.chunks, h, p, n), dtype=torch.float32, device=x.device)
        dec = torch.empty((b, plan.chunks, h), dtype=torch.float32, device=x.device)
        h_in = torch.empty_like(sc)
    vec = int(p % 4 == 0 and x.data_ptr() % 16 == 0)
    status = _lib.load(NAME)(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bm.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_t.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (sc, dec, h_in)),
        b, s, h, p, n, plan.chunk, plan.rows, plan.heads, plan.threads, vec,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _lib.check(status, NAME)
    _lib.LAUNCHES[NAME] += 1
    if not with_states:
        return y, h_t
    if plan.fused:
        h_in = h0[:, None] if h0 is not None else torch.zeros(
            (b, 1, h, p, n), dtype=torch.float32, device=x.device)
    return y, h_t, h_in
