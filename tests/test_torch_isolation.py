"""The PyTorch port stands alone: no module of ``repro_torch``, and neither
``chip_smoke.py`` nor ``chip_ab.py``, imports JAX or the JAX package."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
print(json.dumps({"modules": names, "foreign": loaded}))
"""


def test_importing_every_port_module_loads_no_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True, text=True,
                         env=env, timeout=300, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["foreign"] == []
    assert {"repro_torch.qr.api", "repro_torch.kernels.ops", "repro_torch.collective.engine",
            "repro_torch.serve.buckets", "repro_torch.serve.planner",
            "repro_torch.serve.frontend", "repro_torch.launch.serve",
            "repro_torch.optim.powersgd", "repro_torch.optim.ftqr", "repro_torch.optim.lowrank",
            "repro_torch.optim.orthosgd", "repro_torch.optim.adamw",
            "repro_torch.checkpoint.manager", "repro_torch.checkpoint.replicated",
            "repro_torch.data.pipeline", "repro_torch.configs.base",
            "repro_torch.configs.qwen3_0_6b", "repro_torch.configs.tsqr_paper",
            "repro_torch.models.api", "repro_torch.models.layers", "repro_torch.models.moe",
            "repro_torch.models.transformer", "repro_torch.models.frontends",
            "repro_torch.models.ssm", "repro_torch.models.hybrid", "repro_torch.models.encdec",
            "repro_torch.runtime.trainer", "repro_torch.runtime.elastic",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.powersgd_dp", "repro_torch.collective.dist",
            "repro_torch.kernels.autotune",
            "repro_torch.kernels.backend", "repro_torch.bench.schema",
            "repro_torch.bench.registry", "repro_torch.bench.runner",
            "repro_torch.bench.compare", "repro_torch.bench.__main__",
            "repro_torch.bench.cases", "repro_torch.bench.cases.autotune",
            "repro_torch.bench.cases.kernels", "repro_torch.bench.cases.semantics",
            "repro_torch.bench.cases.robustness", "repro_torch.bench.cases.comm_volume",
            "repro_torch.bench.cases.tsqr_scaling", "repro_torch.bench.cases.coded",
            "repro_torch.bench.cases.general_qr", "repro_torch.bench.cases.dispatch",
            "repro_torch.bench.cases.overlap", "repro_torch.bench.cases.serving",
            "repro_torch.bench.cases.powersgd", "repro_torch.bench.cases.training",
            "repro_torch.bench.cases.roofline", "repro_torch.core",
            "repro_torch.core.tsqr", "repro_torch.core.ref"} <= set(
                report["modules"])


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
                                  *sorted(PACKAGE.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import_in_source(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}
