"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
(its compiler, faults and analysis modules included, and the port's
``scripts/torch_*.py``), and ``chip_smoke.py`` refuses to run without a
CUDA card or without the repository beside it."""

import os
import pkgutil
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)|"
    r"from\s+repro(\.|\s))", re.M)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PKG)], prefix="repro_torch."))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_every_port_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) >= 20
    assert {"repro_torch.models.moe", "repro_torch.configs.qwen2_7b",
            "repro_torch.configs.qwen3_14b",
            "repro_torch.configs.mistral_nemo_12b",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.models.scan", "repro_torch.models.ssm",
            "repro_torch.models.rwkv", "repro_torch.configs.hymba_1_5b",
            "repro_torch.configs.rwkv6_3b",
            "repro_torch.configs.whisper_medium",
            "repro_torch.configs.internvl2_26b",
            "repro_torch.models.attention", "repro_torch.models.layers",
            "repro_torch.models.mlp", "repro_torch.models.transformer",
            "repro_torch.serve.engine",
            "repro_torch.launch.serve"} <= set(mods)
    # the FQA compiler: its core modules, compiler, faults and analysis
    assert {"repro_torch.core.fixed_point", "repro_torch.core.remez",
            "repro_torch.core.searchspace", "repro_torch.core.quantize",
            "repro_torch.core.segmentation", "repro_torch.core.registry",
            "repro_torch.core.workflow", "repro_torch.compiler.memo",
            "repro_torch.compiler.compile", "repro_torch.compiler.store",
            "repro_torch.compiler.batch", "repro_torch.faults.registry",
            "repro_torch.analysis.intervals",
            "repro_torch.analysis.certify"} <= set(mods)
    # multi-tenant serving from one store: the tuner, the sweep, the FWL
    # flow and the cost model
    assert {"repro_torch.tune.config", "repro_torch.tune.autotune",
            "repro_torch.compiler.sweep", "repro_torch.serve.tenants",
            "repro_torch.core.fwl_search",
            "repro_torch.core.hwcost"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_no_jax_or_repro_import_in_source(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, hits


PORT_SCRIPTS = sorted(str(p.relative_to(ROOT))
                      for p in (ROOT / "scripts").glob("torch_*.py"))


@pytest.mark.parametrize("path", PORT_SCRIPTS)
def test_no_jax_or_repro_import_in_port_scripts(path):
    text = (ROOT / path).read_text()
    hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(text)]
    assert not hits, hits


def test_port_cli_scripts_load_without_jax_or_repro():
    """The sweep CLI and the chaos harness, loaded as their callers load
    them, bring in neither JAX nor the JAX package."""
    assert {"scripts/torch_sweep.py", "scripts/torch_chaos.py"} <= set(
        PORT_SCRIPTS)
    code = (
        "import importlib.util, sys\n"
        "for p in ('scripts/torch_sweep.py', 'scripts/torch_chaos.py'):\n"
        "    spec = importlib.util.spec_from_file_location('m', p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import repro_torch.analysis.__main__, repro_torch.analysis.lint\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_fails_without_a_card():
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
