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
            "repro_torch.launch.record", "repro_torch.core.netem",
            "repro_torch.core.metasync", "repro_torch.core.replay_passes",
            "repro_torch.record", "repro_torch.record.session",
            "repro_torch.record.cloud", "repro_torch.record.device",
            "repro_torch.record.fanout", "repro_torch.attest.keys",
            "repro_torch.attest.log", "repro_torch.attest.quote",
            "repro_torch.attest.verifier", "repro_torch.registry.store",
            "repro_torch.registry.service", "repro_torch.registry.client",
            "repro_torch.registry.replica", "repro_torch.api.workspace",
            "repro_torch.obs.schema", "repro_torch.launch.attest",
            "repro_torch.examples.quickstart",
            "repro_torch.examples.secure_inference",
            "repro_torch.examples.serve_continuous_batching",
            "repro_torch.sharding", "repro_torch.launch.mesh",
            "repro_torch.runtime.elastic", "repro_torch.kernels._sharding",
            "repro_torch.fleet", "repro_torch.fleet.traffic",
            "repro_torch.fleet.balancer", "repro_torch.fleet.pool",
            "repro_torch.launch.fleet", "repro_torch.launch.fanout",
            "repro_torch.launch.trace", "repro_torch.training.optimizer",
            "repro_torch.training.grad_compress", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.runtime",
            "repro_torch.runtime.checkpoint",
            "repro_torch.runtime.straggler",
            "repro_torch.launch.train", "repro_torch.analysis",
            "repro_torch.analysis.cost", "repro_torch.analysis.roofline",
            "repro_torch.launch.dryrun"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.')\n"
            "             or m == 'msgpack' or m.startswith('msgpack.'))\n"
            "assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mods", [
    ("repro_torch.record", "repro_torch.core.metasync",
     "repro_torch.core.replay_passes"),
    ("repro_torch.core.netem",), ("repro_torch.record.fanout",),
    ("repro_torch.attest",), ("repro_torch.registry",),
    ("repro_torch.api",), ("repro_torch.fleet",),
    ("repro_torch.launch.fleet", "repro_torch.launch.fanout",
     "repro_torch.launch.trace"),
    ("repro_torch.launch.train", "repro_torch.training.grad_compress",
     "repro_torch.runtime.straggler"),
    ("repro_torch.sharding", "repro_torch.launch.mesh",
     "repro_torch.runtime.elastic"),
    ("repro_torch.analysis", "repro_torch.analysis.cost",
     "repro_torch.analysis.roofline"),
    ("repro_torch.launch.dryrun",)],
    ids=lambda m: m[0].removeprefix("repro_torch."))
def test_recording_session_modules_load_no_jax_or_msgpack(mods):
    """The CODY session's modules alone: metastate sync frames through
    ``core/_msgpack``, never the ``msgpack`` package, and no JAX."""
    code = (f"import importlib, sys\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'msgpack', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mods", [
    ("repro_torch",), ("repro_torch.sharding", "repro_torch.launch.mesh",
                       "repro_torch.runtime.elastic",
                       "repro_torch.kernels")],
    ids=["package", "sharding"])
def test_import_starts_no_process_group(mods):
    """Importing the port, its sharding modules or its kernels starts no
    process group (a mesh is made only when asked for), and the kernels
    do not load ``torch.distributed.tensor`` until a mesh or a placement
    registers their sharding strategies."""
    code = (f"import importlib, sys\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "assert 'torch.distributed.tensor' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("mods", [
    ("repro_torch", "repro_torch.analysis"),
    ("repro_torch.analysis.cost", "repro_torch.analysis.roofline",
     "repro_torch.launch.dryrun")], ids=["analysis", "dryrun"])
def test_import_loads_no_fake_process_group(mods):
    """The fake process group (``torch.testing._internal.distributed``)
    loads only when the dry run starts a world, never on import.  (Import
    of ``torch`` itself loads other parts of ``torch.testing._internal``
    in recent versions; none of them starts or fakes a world.)"""
    code = (f"import importlib, sys\nfor m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.startswith(\n"
            "    'torch.testing._internal.distributed'))\n"
            "assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_offline_verifier_imports_no_model_or_registry_code():
    """What a remote verifier runs: ``attest/verifier.py`` names no model,
    config, serving, registry or record module (nor torch), and importing
    it loads none of the port's (as the reference pins at
    ``tests/test_attest.py``)."""
    src = (PORT / "attest" / "verifier.py").read_text()
    banned = ("repro_torch.models", "repro_torch.configs",
              "repro_torch.training", "repro_torch.serving",
              "repro_torch.registry", "repro_torch.record",
              "repro_torch.api", "repro_torch.kernels", "jax")
    for name in banned + ("torch",):
        assert f"import {name}" not in src and f"from {name}" not in src
    code = ("import sys\nimport repro_torch.attest.verifier\n"
            f"bad = sorted(m for m in sys.modules if m.startswith({banned!r}))\n"
            "assert not bad, bad\n")
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
