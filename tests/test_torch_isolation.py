"""The port stands alone: no ``repro_torch`` module, and not ``chip_smoke.py``,
imports ``jax`` or anything of the JAX package ``repro``.

Each check runs in a fresh interpreter where ``import jax`` fails
(``sys.modules["jax"] = None``), imports everything, then asserts that no
module named ``repro`` or ``repro.*`` was loaded.
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    sys.modules["jax"] = None
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {root!r})
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    new = {{"repro_torch.api", "repro_torch.calib", "repro_torch.calib.fit",
           "repro_torch.optim", "repro_torch.optim.adamw",
           "repro_torch.core.whatif", "repro_torch.core.tuner",
           "repro_torch.mapreduce.distributed",
           "repro_torch.cluster", "repro_torch.cluster.network",
           "repro_torch.cluster.workload", "repro_torch.cluster.sched",
           "repro_torch.cluster.vector_sim", "repro_torch.cluster.evaluator",
           "repro_torch.cloud", "repro_torch.cloud.pricing",
           "repro_torch.cloud.autoscaler", "repro_torch.cloud.evaluator",
           "repro_torch.cloud.report", "repro_torch.obs.destrace",
           "repro_torch.obs.profile_hooks", "repro_torch.data",
           "repro_torch.data.pipeline", "repro_torch.models.opt_flags",
           "repro_torch.configs.starcoder2_7b", "repro_torch.configs.granite_3_8b",
           "repro_torch.configs.stablelm_1_6b",
           "repro_torch.configs.internvl2_26b", "repro_torch.models.moe",
           "repro_torch.models.ssm", "repro_torch.models.rglru",
           "repro_torch.models.encdec", "repro_torch.configs.deepseek_moe_16b",
           "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.mamba2_130m",
           "repro_torch.configs.recurrentgemma_9b",
           "repro_torch.configs.seamless_m4t_large_v2"}}
    assert new <= set(names), sorted(new - set(names))
    bad = sorted(m for m in sys.modules
                 if m == "repro" or m.startswith("repro.") or m == "jaxlib"
                 or m.startswith("jax."))
    assert not bad, bad
    print(len(names))
""")


def test_every_port_module_imports_without_jax_or_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"),
                                             root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=str(ROOT), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 80


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_source_names_jax_or_repro_in_an_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots
