"""The port imports neither JAX nor anything of the reference package.

A fresh interpreter imports every ``repro_torch`` module and the
module-level code of ``chip_smoke.py`` and must end with no ``jax`` and no
``repro`` (or ``repro.*``) in ``sys.modules``; a source scan of the same
and of the port's examples (``examples/*_torch.py``) backs that up for
imports that only run inside functions.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(_modules())!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_never_import_jax_or_the_reference():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert {f.name for f in examples} >= {"quickstart_torch.py", "ecc_serving_torch.py",
                                          "train_vla_torch.py"}
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 20
    bad = {
        str(f.relative_to(ROOT)): root
        for f in files
        for root in _imported_roots(f)
        if root in ("jax", "jaxlib", "repro")
    }
    assert bad == {}


def test_the_scan_covers_the_partition_and_roofline_modules():
    mods = set(_modules())
    assert {"repro_torch.partition", "repro_torch.partition.graph",
            "repro_torch.partition.planner", "repro_torch.partition.executor",
            "repro_torch.roofline", "repro_torch.roofline.costmodel",
            "repro_torch.roofline.analysis", "repro_torch.launch.dryrun"} <= mods


def test_the_scan_covers_the_moe_configs():
    mods = set(_modules())
    assert {"repro_torch.configs.qwen3_moe", "repro_torch.configs.phi35_moe",
            "repro_torch.models.moe"} <= mods


# the rank scripts and the scenarios both sides run: torch (or numpy) only
RANK_SCRIPTS = ("torch_model_axis_cases", "torch_model_axis_rank", "torch_data_axis_rank")


@pytest.mark.parametrize("name", RANK_SCRIPTS)
def test_rank_scripts_load_no_jax_and_no_reference(name):
    """The port's rank scripts (``tests/torch_*_rank.py``) and the scenario
    file they share with the reference's recorder import neither JAX nor
    the reference, in source or when a fresh interpreter loads them."""

    path = ROOT / "tests" / f"{name}.py"
    assert not {r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")}
    code = (f"import importlib, json, sys\nimportlib.import_module({name!r})\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
