"""Train a ~100M-class model end to end on the synthetic episode corpus,
with the PyTorch/CUDA port.

Uses the full substrate: episode generation -> tokenization -> AdamW ->
npz checkpointing (``repro_torch.launch.train``).  Default: xlstm-125m's
smoke config for 200 steps; ``--full`` for the published width, any
``--arch`` of ``repro_torch.configs.ARCH_IDS``; ``--device cuda`` (the
default) runs the attention through the flash forward and backward
kernels, ``--device cpu`` through their plain versions.

    PYTHONPATH=src python examples/train_vla_torch.py --steps 200 --device cpu
"""

import argparse
from pathlib import Path

from repro_torch.launch.train import main as train_main

CKPT_DIR = Path(__file__).resolve().parents[1] / "build" / "rapid_ckpt"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="xlstm-125m")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--smoke", action="store_true", default=True)
    p.add_argument("--full", dest="smoke", action="store_false")
    p.add_argument("--ckpt-dir", default=str(CKPT_DIR))
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = p.parse_args(argv)

    res = train_main([
        "--arch", args.arch,
        *(["--smoke"] if args.smoke else []),
        "--steps", str(args.steps),
        "--data", "episodes",
        "--ckpt-dir", args.ckpt_dir,
        "--device", args.device,
    ])
    drop = res["first_loss"] - res["final_loss"]
    print(f"loss drop over {args.steps} steps: {drop:.3f}")
    assert drop > 0, "training must reduce loss"


if __name__ == "__main__":
    main()
