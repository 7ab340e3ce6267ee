"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it: ``python3 chip_smoke.py``.

Phases, in order; any failure exits nonzero and prints no result line:

1. environment: the card's name and power limit, the PyTorch and CUDA
   versions; TF32 is switched off for float32 matmuls and convolutions;
2. build: the three attention kernels from ``src/repro_torch/csrc/``;
3. kernels: each CUDA kernel against its plain PyTorch version on the same
   inputs (numpy, seeded), at the serving path's shapes and at harder ones,
   with times: the kernel, the plain version, one PyTorch library call of
   the same function (a yardstick the port never calls) and the least time
   the card could take (the bound);
4. model: the smoke-size stack in float32 on the card against the same
   weights on the CPU (plain attention), then the main path: openvla-7b at
   full width in bf16 serving one robot's closed loop with
   ``serve_episode`` twice, dense and paged, with the kernels' launch counts
   read around each run; the two runs' chunks must agree under the
   greedy-margin rule;
5. the result: a ``{"kernels": [...]}`` line and, last, the device line.

Needs one CUDA card; takes no arguments.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import EpisodeTokenizer  # noqa: E402
from repro_torch.kernels import _lib, ops, ref  # noqa: E402
from repro_torch.kernels import decode_attention as kdec  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import paged_attention as kpa  # noqa: E402
from repro_torch.launch.serve import CloudPolicy, serve_episode  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

# H100 SXM data-sheet peaks (dense): HBM bytes/s, and flop/s by input type
# (bf16 on the tensor cores; float32 outside them)
HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# float32: the same math summed in another order.  bf16: each output is a
# weighted mean of standard-normal v rows, so |out| reaches ~3 where a row
# sees few keys (the first rows of a prefill) and ~0.2 over 70+ keys.  The
# plain version rounds the probabilities to bf16 before P.V, as the reference
# does, and the kernel keeps them in float32; both round the output to bf16
# once.  So the two may differ by a bf16 step at |out| (2^-8 at 0.5-1, the
# 0.0039 that flash S=300 shows) plus the probability rounding, at most
# 2^-9 * max|v| ~ 0.009 and far less where signs cancel.  2e-2 holds a step
# plus that worst case up to |out| 2, and a step alone up to |out| 4; a
# limit of 1e-3 would fail the one-step difference seen at S=300.
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 0.0)}
# greedy-margin rule for the bf16 runs: two paths' tokens may differ only
# where the reference path's top-two logit gap is at most this (logits are
# O(1); 0.1 is ~13 bf16 steps there)
MARGIN_TOL = 0.1
# control ticks per served episode: the 64-tick trigger warm-up and 56 more
STEPS = 120
REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:92",
    "decode_attention": "src/repro/kernels/decode_attention.py:87",
    "paged_attention": "src/repro/kernels/paged_attention.py:100",
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype):
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _t(rng, shape, dtype):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32)).to("cuda", dtype)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def flash_case(rng, dtype, s, h, kv, window=0, cap=0.0, d=128):
    q, k, v = _t(rng, (1, s, h, d), dtype), _t(rng, (1, s, kv, d), dtype), _t(rng, (1, s, kv, d), dtype)
    kw = dict(causal=True, window=window, logit_cap=cap)
    pairs = sum(min(i + 1, window) if window else i + 1 for i in range(s))
    lib = None
    if not window and not cap and h == kv:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    return dict(
        kernel=lambda: kfa.flash_attention(q, k, v, **kw),
        plain=lambda: ref.flash_attention_ref(q, k, v, **kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * nbytes(k),
        flops=4.0 * h * d * pairs,
    )


def decode_case(rng, dtype, s, h, kv, cache_len, window=0, cap=0.0, b=1, d=128):
    q = _t(rng, (b, h, d), dtype)
    ck, cv = _t(rng, (b, s, kv, d), dtype), _t(rng, (b, s, kv, d), dtype)
    kw = dict(cache_len=cache_len, window=window, logit_cap=cap)
    lens = (cache_len.tolist() if isinstance(cache_len, torch.Tensor) else [cache_len] * b)
    live = sum(min(n, window) if window else n for n in lens)
    lib = None
    if not window and not cap and h == kv and not isinstance(cache_len, torch.Tensor):
        qt = q[:, :, None, :]
        kt, vt = ck[:, :cache_len].transpose(1, 2), cv[:, :cache_len].transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    return dict(
        kernel=lambda: kdec.decode_attention(q, ck, cv, **kw),
        plain=lambda: ref.decode_attention_ref(q, ck, cv, **kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * live * kv * d * ck.element_size(),
        flops=4.0 * live * h * d,
    )


def paged_case(rng, dtype, lens, page, h, kv, window=0, cap=0.0, identity=False, d=128):
    b = len(lens)
    maxp = max(1, -(-max(lens) // page))
    pool = b * maxp + 3
    kp, vp = _t(rng, (pool, page, kv, d), dtype), _t(rng, (pool, page, kv, d), dtype)
    q = _t(rng, (b, h, d), dtype)
    perm = np.arange(pool) if identity else rng.permutation(pool)
    table = torch.as_tensor(perm[: b * maxp].reshape(b, maxp).astype(np.int32), device="cuda")
    cl = torch.as_tensor(np.asarray(lens, np.int32), device="cuda")
    kw = dict(window=window, logit_cap=cap)
    live = sum(min(n, window) if window else n for n in lens)
    lib = None
    if identity and b == 1 and not window and not cap and h == kv:
        # identity page table: the pool is the row's dense cache
        qt = q[:, :, None, :]
        kt = kp.view(1, -1, kv, d)[:, : lens[0]].transpose(1, 2)
        vt = vp.view(1, -1, kv, d)[:, : lens[0]].transpose(1, 2)
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    return dict(
        kernel=lambda: kpa.paged_decode_attention(q, kp, vp, table, cl, **kw),
        plain=lambda: ref.paged_decode_attention_ref(q, kp, vp, table, cl, **kw),
        library=lib,
        bytes=2 * nbytes(q) + 2 * live * kv * d * kp.element_size() + nbytes(table, cl),
        flops=4.0 * live * h * d,
    )


def kernel_cases(rng):
    bf, f32 = torch.bfloat16, torch.float32
    ragged = [1, 1000, 0, 17, 250, 16, 999, 64]
    return [
        # (kernel, label, dtype, case, main-path shape?)
        ("flash_attention", "S=14 H=KV=32 D=128", bf, flash_case(rng, bf, 14, 32, 32), True),
        ("flash_attention", "S=14 H=KV=32 D=128", f32, flash_case(rng, f32, 14, 32, 32), False),
        ("flash_attention", "S=300 H=KV=32", bf, flash_case(rng, bf, 300, 32, 32), False),
        ("flash_attention", "S=300 H=KV=32", f32, flash_case(rng, f32, 300, 32, 32), False),
        ("flash_attention", "S=300 H=32 KV=8 win 64 cap 50", f32,
         flash_case(rng, f32, 300, 32, 8, window=64, cap=50.0), False),
        ("decode_attention", "S=70 len=70 H=KV=32", bf, decode_case(rng, bf, 70, 32, 32, 70), True),
        ("decode_attention", "S=70 len=70 H=KV=32", f32, decode_case(rng, f32, 70, 32, 32, 70), False),
        ("decode_attention", "S=4096 len=4096", bf, decode_case(rng, bf, 4096, 32, 32, 4096), False),
        ("decode_attention", "S=4096 len=4096", f32, decode_case(rng, f32, 4096, 32, 32, 4096), False),
        ("decode_attention", "S=4096 len=3000 H=32 KV=8 win 64 cap 50", f32,
         decode_case(rng, f32, 4096, 32, 8, 3000, window=64, cap=50.0), False),
        ("decode_attention", "B=4 S=70 per-row lens", f32,
         decode_case(rng, f32, 70, 32, 32, torch.tensor([70, 1, 33, 0], dtype=torch.int32,
                                                          device="cuda"), b=4), False),
        ("paged_attention", "B=1 len=70 page 16 identity", bf,
         paged_case(rng, bf, [70], 16, 32, 32, identity=True), True),
        ("paged_attention", "B=1 len=70 page 16 identity", f32,
         paged_case(rng, f32, [70], 16, 32, 32, identity=True), False),
        ("paged_attention", "B=8 ragged 0..1000 page 16 shuffled", bf,
         paged_case(rng, bf, ragged, 16, 32, 32), False),
        ("paged_attention", "B=8 ragged 0..1000 page 16 shuffled", f32,
         paged_case(rng, f32, ragged, 16, 32, 32), False),
        ("paged_attention", "B=8 ragged page 128 H=32 KV=8 win 64 cap 50", f32,
         paged_case(rng, f32, ragged, 128, 32, 8, window=64, cap=50.0), False),
    ]


def check_kernels():
    rng = np.random.default_rng(0)
    main = {}
    for name, label, dtype, case, is_main in kernel_cases(rng):
        out = case["kernel"]()
        want = case["plain"]()
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        atol, rtol = TOL[dtype]
        ok = bool((err <= atol + rtol * want.float().abs()).all()) and bool(torch.isfinite(out).all())
        row = dict(
            max_abs_err=float(err.max()),
            ms=time_ms(case["kernel"]),
            plain_ms=time_ms(case["plain"]),
            library_ms=time_ms(case["library"]) if case["library"] else None,
        )
        row["bound_ms"], row["bound_by"] = bound_ms(case["bytes"], case["flops"], dtype)
        log(f"  {name:17s} {label:42s} {str(dtype)[6:]:8s} err={row['max_abs_err']:.3g} "
            f"(atol {atol:g} rtol {rtol:g}) ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 4)} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
        if not ok:
            raise AssertionError(f"{name} [{label}, {dtype}] disagrees with its plain version: "
                                 f"max abs err {row['max_abs_err']:.3g}")
        if is_main:
            main[name] = row
    return main


# ---------------------------------------------------------------------------
# phase 4: the model
# ---------------------------------------------------------------------------


class RecordingPolicy(CloudPolicy):
    """A CloudPolicy that keeps each chunk's prompt and tokens."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.record = []

    def chunk_tokens(self, qd, tau):
        toks = super().chunk_tokens(qd, tau)
        self.record.append((np.array(qd), np.array(tau), toks))
        return toks


def check_small_model_against_cpu():
    """Smoke-size f32 stack: kernels on the card vs plain attention on the
    CPU, same weights; chunk tokens equal, prefill logits within 1e-4."""

    cfg = get_smoke_config("openvla-7b").replace(dtype="float32")
    cpu = Model(cfg, device="cpu")
    gpu = Model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    tok = EpisodeTokenizer(cfg.vocab_size)
    rng = np.random.default_rng(1)
    qd, tau = rng.normal(0, 0.5, (2, 7)), rng.normal(0, 0.5, (2, 7))
    obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    lg, _ = gpu.prefill({"tokens": torch.as_tensor(obs, device="cuda")})
    lc, _ = cpu.prefill({"tokens": torch.as_tensor(obs)})
    err = float((lg.cpu() - lc).abs().max())
    for paged in (False, True):
        tg = CloudPolicy(gpu, tok, paged=paged).chunk_tokens(qd, tau)
        tc = CloudPolicy(cpu, tok, paged=paged).chunk_tokens(qd, tau)
        if not np.array_equal(tg, tc):
            raise AssertionError(f"smoke f32 chunk tokens differ card vs CPU (paged={paged})")
    if err > 1e-4:
        raise AssertionError(f"smoke f32 prefill logits differ card vs CPU by {err:.3g}")
    log(f"  smoke f32 stack, card kernels vs CPU plain: logits max err {err:.3g}, "
        "dense and paged chunk tokens equal")


def top2_gap_at(model, tok, qd, tau, toks, step):
    """Dense path, teacher-forced with ``toks``: the top-two logit gap over
    the action bins at decode step ``step``."""

    obs = np.concatenate([tok.encode_state(qd), tok.encode_state(tau)], axis=1)
    logits, cache = model.prefill({"tokens": torch.as_tensor(obs, device="cuda")}, extra=step + 1)
    for j in range(step):
        nxt = torch.as_tensor(toks[:, j : j + 1], device="cuda")
        logits, cache = model.decode_step(nxt, cache)
    top = logits[0, -1, tok.action_base :].float().topk(2).values
    return float(top[0] - top[1])


def serve_main_path(model, tok, paged: bool):
    policy = RecordingPolicy(model, tok, paged=paged)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve_episode(policy, task="pick_place", max_steps=STEPS, verbose=False, device="cuda")
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    n_off, ms = out["offloads"], np.asarray(out["cloud_ms"])
    acts = out["actions"]
    if not (n_off > 0 and acts.shape == (STEPS, 7) and np.isfinite(acts).all()):
        raise AssertionError(f"bad serve output: offloads={n_off} actions {acts.shape}")
    chunk = policy.n_steps
    log(f"  {'paged' if paged else 'dense'}: offloads={n_off} cloud_ms mean={ms.mean():.2f} "
        f"median={np.median(ms):.2f} first={ms[0]:.2f} "
        f"chunk tokens/s={chunk * n_off / (ms.sum() / 1e3):.1f} "
        f"(steady, excluding the first chunk: {chunk * (n_off - 1) / (ms[1:].sum() / 1e3):.1f}) "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"launches={counts}")
    layers = model.cfg.num_layers
    want = {
        "flash_attention": layers * n_off,
        "decode_attention": 0 if paged else layers * chunk * n_off,
        "paged_attention": layers * chunk * n_off if paged else 0,
    }
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return policy.record, counts


def profile_chunk(model, tok):
    """One dense chunk under torch.profiler: wall ms, the device's busy share
    and the kernels that take the device's time."""

    from torch.profiler import ProfilerActivity, profile

    policy = CloudPolicy(model, tok)
    rng = np.random.default_rng(2)
    qd, tau = rng.normal(0, 0.5, (1, 7)), rng.normal(0, 0.5, (1, 7))
    policy.chunk_tokens(qd, tau)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        policy.chunk_tokens(qd, tau)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        log(f"  profiled dense chunk: wall {wall_ms:.1f} ms; device time not measured "
            "(the profiler recorded no CUDA kernels)")
        return
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us() / 1e3)
    log(f"  profiled dense chunk: wall {wall_ms:.1f} ms (profiler on), device kernels "
        f"{busy_ms:.1f} ms in {len(kernels)} launches, busy share {busy_ms / wall_ms:.3f}")
    for name, (n, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]:
        log(f"    {t:9.2f} ms {n:6d}x  {name[:110]}")


def check_greedy_margin(model, tok, dense_rec, paged_rec):
    if len(dense_rec) != len(paged_rec):
        raise AssertionError("dense and paged runs offloaded a different number of times")
    diverged = 0
    for (qd, tau, td), (qd2, tau2, tp) in zip(dense_rec, paged_rec):
        if not (np.array_equal(qd, qd2) and np.array_equal(tau, tau2)):
            raise AssertionError("dense and paged runs saw different observations")
        diff = np.flatnonzero(td[0] != tp[0])
        if diff.size:
            diverged += 1
            gap = top2_gap_at(model, tok, qd, tau, td, int(diff[0]))
            if gap > MARGIN_TOL:
                raise AssertionError(f"paged token differs at step {diff[0]} where the dense "
                                     f"top-two gap is {gap:.3g} > {MARGIN_TOL}")
    log(f"  greedy-margin rule: {len(dense_rec)} chunks, {diverged} diverged within the margin")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2

    log("== 1. environment")
    card = card_line()
    log(f"  card: {card}")
    log(f"  torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    log("== 2. build")
    secs = _lib.build_all(force=True)
    log(f"  built {list(_lib.KERNELS)} in {secs:.1f} s")
    for name, text in _lib.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    log("== 3. kernels against their plain versions")
    main_rows = check_kernels()

    log("== 4. model")
    check_small_model_against_cpu()
    cfg = get_config("openvla-7b")
    t0 = time.perf_counter()
    model = Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.param_count() / 1e9:.3f} B params, {cfg.dtype}, "
        f"built in {time.perf_counter() - t0:.1f} s")
    tok = EpisodeTokenizer(cfg.vocab_size)
    dense_rec, c_dense = serve_main_path(model, tok, paged=False)
    paged_rec, c_paged = serve_main_path(model, tok, paged=True)
    check_greedy_margin(model, tok, dense_rec, paged_rec)
    launches = {n: c_dense[n] + c_paged[n] for n in _lib.KERNELS}
    profile_chunk(model, tok)

    log("== 5. result")
    rows = []
    for name in _lib.KERNELS:
        rows.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=launches[name], **main_rows[name],
        ))
    print(f"card: {card}")
    print(f"kernels: {json.dumps(list(_lib.KERNELS))}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
