"""Phase 7(b)'s split fleet (openvla-7b at full width and phase 7's depth,
``FLEET_LAYERS`` where the tree sets it, else 32; 16 robots x 300 ticks,
cold and warm) from the ``chip_smoke.py`` of a given tree, so that
two versions of the split lanes can be compared on one card in one call:
unpack the parent into a gitignored directory (``git archive <commit> |
tar -x -C build/before``) and run, on a machine with an H100,

    for t in build/before . . build/before; do python3 tools/split_fleet_ab.py $t; done

Each run builds its tree's kernels into that tree's ``build/kernels``.
"""

import sys
import time
from pathlib import Path

root = Path(sys.argv[1] if len(sys.argv) > 1 else ".").resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

if Path(cs.__file__).resolve().parent != root:
    raise SystemExit(f"imported {cs.__file__}, not the chip_smoke.py of {root}")
if not torch.cuda.is_available():
    raise SystemExit("split_fleet_ab: no CUDA device")
t0 = time.perf_counter()
cs.log(f"== tree {root}")
cs.log(f"  card: {cs.card_line()}")
torch.backends.cuda.matmul.allow_tf32 = False
cs._lib.build_all(force=True)
cfg = cs.get_config("openvla-7b")
model = cs.Model(cfg.replace(num_layers=getattr(cs, "FLEET_LAYERS", cfg.num_layers)),
                 device="cuda", generator=torch.Generator("cuda").manual_seed(0))
tok = cs.EpisodeTokenizer(model.cfg.vocab_size)
launches = {n: 0 for n in cs._lib.KERNELS}
cs.phase("7(b) split fleet")
cs.split_fleet_full_width(model, tok, launches)
cs.phase()
cs.log(f"  total {time.perf_counter() - t0:.1f} s")
