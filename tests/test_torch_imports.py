"""The port stands alone: importing it loads no JAX, and no port file
imports the reference package."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_import_loads_no_jax():
    """Nor ``msgpack``: the recordings are framed by ``core/_msgpack``."""
    mods = _port_modules()
    assert {"repro_torch.kernels.flash_attention",
            "repro_torch.kernels.mamba_scan", "repro_torch.kernels.mlstm",
            "repro_torch.models.ssm", "repro_torch.models.xlstm",
            "repro_torch.core.attest", "repro_torch.core._msgpack",
            "repro_torch.core.recording", "repro_torch.core.recorder",
            "repro_torch.core.replay", "repro_torch.api.workload",
            "repro_torch.launch.record"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.')\n"
            "             or m == 'msgpack' or m.startswith('msgpack.'))\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


_IMPORTS_REPRO = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_port_file_imports_repro(path):
    src = path.read_text()
    assert not _IMPORTS_REPRO.search(src), path
    assert "import jax" not in src and "from jax" not in src, path
    assert "import msgpack" not in src, path


def test_serving_stack_loads_no_model_code():
    """The channel trust boundary: the serving stack reaches decode with
    no model, kernel or step code imported (a replay channel will run
    recorded programs only)."""
    code = ("import sys\n"
            "import repro_torch.serving.engine, repro_torch.serving.scheduler\n"
            "import repro_torch.core.channel\n"
            "bad = sorted(m for m in sys.modules if m.startswith(\n"
            "    ('repro_torch.models', 'repro_torch.kernels',\n"
            "     'repro_torch.training')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
