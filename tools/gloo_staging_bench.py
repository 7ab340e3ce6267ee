"""Where the time of a gloo collective between two ranks on one card goes.

Phase 7c of ``chip_smoke.py`` runs its two tensor-parallel ranks over gloo
when the machine has one card (NCCL takes no two ranks on one card), and
``repro_torch.launch.dist`` stages each CUDA tensor through pinned host
memory.  This script spawns two such ranks on ``cuda:0`` and times, per
call, at openvla-7b's decode shape ([8, 4096] bf16, the MLP half of a rank
at M = 2):

  host        gloo all_reduce of a pinned host tensor, no card work
  staged      ``dist.all_reduce_sum`` of a CUDA tensor, no other work
  mlp+staged  the rank's MLP matmuls, then ``all_reduce_sum``
  mlp+sync    the MLP matmuls and a ``torch.cuda.synchronize``, no gloo
              (both ranks at once: the cost of two processes on one card)

and ``mlp+sync`` in one process alone, before the spawn.  Each figure is
the median of ``--reps`` calls in microseconds.  With ``--threads N`` each
rank runs ``torch.set_num_threads(N)`` first.  Run on a machine with an
H100:

    PYTHONPATH=src python3 tools/gloo_staging_bench.py [--reps 300] [--threads 1]
"""

import argparse
import os
import socket
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
import torch  # noqa: E402

ROWS, D, FF = 8, 4096, 11008 // 2


def _mlp(x, up, down):
    return (x @ up) @ down


def _median_us(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e6


def rank_main(rank, init, reps, threads, queue):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    if threads:
        torch.set_num_threads(threads)
    from repro_torch.launch import dist

    group = dist.init_model_group(rank, 2, backend="gloo", init_method=init, device="cuda:0")
    import torch.distributed as tdist

    g = torch.Generator("cuda").manual_seed(rank)
    x = torch.randn(ROWS, D, device="cuda", generator=g).bfloat16()
    up = torch.randn(D, FF, device="cuda", generator=g).bfloat16() * D**-0.5
    down = torch.randn(FF, D, device="cuda", generator=g).bfloat16() * FF**-0.5
    host = torch.empty(ROWS, D, dtype=torch.bfloat16, pin_memory=True)
    out = {}

    def sync_both():
        tdist.barrier()

    for name, fn in (
        ("host", lambda: tdist.all_reduce(host)),
        ("staged", lambda: dist.all_reduce_sum(x, group)),
        ("mlp+staged", lambda: dist.all_reduce_sum(_mlp(x, up, down), group)),
        ("mlp+sync", lambda: (_mlp(x, up, down), torch.cuda.synchronize())),
    ):
        for _ in range(20):
            fn()
        sync_both()
        out[name] = _median_us(fn, reps)
        sync_both()
    queue.put((rank, out))
    dist.destroy_model_group(group)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--threads", type=int, default=0)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gloo_staging_bench: no CUDA device")
    import torch.multiprocessing as mp

    g = torch.Generator("cuda").manual_seed(0)
    x = torch.randn(ROWS, D, device="cuda", generator=g).bfloat16()
    up = torch.randn(D, FF, device="cuda", generator=g).bfloat16()
    down = torch.randn(FF, D, device="cuda", generator=g).bfloat16()
    for _ in range(20):
        _mlp(x, up, down)
    torch.cuda.synchronize()
    alone = _median_us(lambda: (_mlp(x, up, down), torch.cuda.synchronize()), a.reps)
    print(f"one process: mlp+sync {alone:.1f} us", flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(m, f"tcp://127.0.0.1:{port}", a.reps,
                                                  a.threads, q)) for m in range(2)]
    for p in procs:
        p.start()
    try:
        res = dict(q.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for m in sorted(res):
        print(f"rank {m} (threads {a.threads or torch.get_num_threads()}): "
              + ", ".join(f"{k} {v:.1f} us" for k, v in res[m].items()), flush=True)


if __name__ == "__main__":
    main()
