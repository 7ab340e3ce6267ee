"""The flash backward (``kernels/flash_attention_bwd.py``) at phase 8(a)'s
training shapes, timed beside SDPA's backward, with its device time split
by kernel (delta, dk / dv, the split reduce, dq) from a torch.profiler
trace.  Takes the tree whose ``src/repro_torch`` and ``chip_smoke.py`` to
use (default: this one), so that two versions of the kernel can be
compared on one card in one call: unpack the other into a gitignored
directory (``git archive <commit> | tar -x -C build/before``) and run, on a
machine with an H100,

    for t in build/before . . build/before; do python3 tools/flash_bwd_bench.py $t; done

Each run builds its tree's kernels into that tree's ``build/kernels``.
Prints one line a shape: ``device_ms`` (20 calls in a replayed CUDA graph,
chip_smoke.device_ms), SDPA's backward's (forward + backward graph minus a
forward graph), the kernels' mean device ms a call under the profiler,
and whether the result is within ``chip_smoke.BWD_TOL`` of the plain version.
"""

import re
import sys
import time
from collections import defaultdict
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402

if Path(cs.__file__).resolve().parent != root:
    raise SystemExit(f"imported {cs.__file__}, not the chip_smoke.py of {root}")
if not torch.cuda.is_available():
    raise SystemExit("flash_bwd_bench: no CUDA device")

CALLS = 20


def kernel_split(fn):
    """Mean device ms a call of each kernel ``fn`` launches, over CALLS calls."""

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    per = defaultdict(float)
    for name, ms in cs.device_events(prof):
        found = re.search(r"(bwd_\w+|flash_\w+)", name)
        per[found.group(1) if found else name[:40]] += ms / CALLS
    return dict(per)


def main():
    t0 = time.perf_counter()
    cs.log(f"== tree {root}")
    cs.log(f"  card: {cs.card_line()}")
    secs = _lib.build_all(force=True)
    cs.log(f"  built in {secs:.1f} s")
    for name, text in _lib.BUILD_LOG.items():
        if name != "flash_attention_bwd":
            continue
        fn = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                cs.log(f"  {fn}: {line.split(':', 1)[-1].strip()}")
    rng = np.random.default_rng(8)
    bf = torch.bfloat16
    shapes = [
        ("openvla-7b B=4 S=256 H=KV=32 D=128 causal", (4, 256, 32, 32, 128), {}),
        ("qwen3-moe heads B=1 S=256 H=64 KV=4 (G=16) D=128", (1, 256, 64, 4, 128), {}),
        ("gemma2-9b heads B=1 S=1024 H=16 KV=8 D=256 win 256 cap 50", (1, 1024, 16, 8, 256),
         dict(window=256, cap=50.0, q_scale=cs.CAP_Q_SCALE)),
        ("ragged B=1 S=300 H=KV=32 D=128 causal", (1, 300, 32, 32, 128), {}),
        ("seamless B=2 S=300 H=KV=16 D=64 non-causal", (2, 300, 16, 16, 64), dict(causal=False)),
    ]
    for label, shape, kw in shapes:
        case = cs.bwd_case(rng, bf, *shape, **kw)
        b, s, h, kv, d = shape
        plan = _lib.flash_bwd_plan(b, s, h, kv, d, bf)
        ms = cs.device_ms(case["kernel"])
        lib = case["library"]
        lib_ms = cs.device_ms(lib[1]) - cs.device_ms(lib[2]) if lib else None
        got, want = case["kernel"](), case["plain"]()
        args = [case[n] for n in ("q", "k", "v", "out", "lse", "dout")]
        terms = cs.bwd_abs_terms(*args, case["kw"]["causal"], case["kw"]["window"],
                                 case["kw"]["logit_cap"])
        err, ok = cs.compare(got, want, cs.bwd_limits(want, terms, bf))
        del got, want, terms
        split = kernel_split(case["kernel"])
        parts = " ".join(f"{k}={v:.5f}" for k, v in sorted(split.items(), key=lambda x: -x[1]))
        cs.log(f"  {label:58s} {'ok' if ok else 'DISAGREES'} err={err:.3g} "
               f"splits={plan.splits} device_ms={ms:.5f} "
               f"sdpa_bwd_device_ms={'-' if lib_ms is None else f'{lib_ms:.5f}'} "
               f"kernels: {parts} (sum {sum(split.values()):.5f})")
        del case
    cs.log(f"  [{time.perf_counter() - t0:.1f} s]")


if __name__ == "__main__":
    main()
