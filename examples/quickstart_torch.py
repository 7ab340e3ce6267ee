"""Quickstart with the PyTorch/CUDA port: the RAPID trigger + dispatcher on
synthetic episodes.

Runs the kinematic dual-threshold monitor over the LIBERO-style task suite,
compares it with the vision-based entropy baseline, and prints the
latency/accuracy row of each strategy (Table III) and the noise-immunity
rows (Table I), as ``examples/quickstart.py`` does over the JAX package.
The RAPID strategies step their decision core on ``--device`` (default
``cuda``; ``cpu`` runs it on the host).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

from repro_torch.runtime.engine import evaluate_strategy


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args(argv)

    print(f"decision core on {args.device}")
    print("== RAPID vs baselines (LIBERO-style simulation, Table III) ==")
    rows = {}
    for strategy in ("edge_only", "cloud_only", "vision", "rapid"):
        r = evaluate_strategy(strategy, device=args.device)
        rows[strategy] = r
        rep = r["report"]
        print(
            f"{strategy:12s} cloud={rep.cloud_ms:6.1f}ms ({rep.cloud_gb:4.1f}GB)  "
            f"edge={rep.edge_ms:6.1f}ms ({rep.edge_gb:4.1f}GB)  "
            f"total={r['total_ms']:6.1f}ms  accuracy={r['accuracy']:.3f}"
        )
    speedup = rows["vision"]["total_ms"] / rows["rapid"]["total_ms"]
    print(f"\nRAPID speedup vs vision-based partitioning: {speedup:.2f}x")
    print("\n== noise immunity (Table I) ==")
    for regime in ("standard", "visual_noise", "distraction"):
        # the standard regime's rows are the table above's (the reference
        # evaluates them again, to the same numbers)
        v, r = (evaluate_strategy(s, regime=regime, device=args.device)
                if regime != "standard" else rows[s] for s in ("vision", "rapid"))
        print(f"{regime:14s} vision={v['total_ms']:6.1f}ms   rapid={r['total_ms']:6.1f}ms")
    return rows


if __name__ == "__main__":
    main()
