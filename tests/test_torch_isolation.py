"""The port stands alone: no module of ``src/repro_torch``, no example of
the port (``examples/torch_*.py``) and not ``chip_smoke.py`` imports JAX or
the reference package ``repro``."""
import tests.torch_threads  # noqa: F401  (first: one thread)
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serving.diffusion_engine, "
            "repro_torch.launch.serve_diffusion, "
            "repro_torch.serving.engine, repro_torch.launch.serve, "
            "repro_torch.obs, repro_torch.obs.metrics_doc, "
            "repro_torch.launch.calibrate; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["obs/__init__.py", "obs/metrics.py",
                                    "obs/metrics_doc.py", "obs/tracing.py",
                                    "obs/audit.py", "obs/calibration.py",
                                    "launch/calibrate.py"])
def test_observability_modules_are_scanned(module):
    """The observability plane and the calibration launcher keep their own
    copies of what they need from the reference (the registry, the
    Prometheus parser, the trace event model, ``_splitmix64``): each is a
    port file the import scan above covers."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


TRAINING_MODULES = ("tree.py", "data/synthetic.py", "training/optimizer.py",
                    "training/loop.py", "checkpoint/io.py", "models/flags.py",
                    "launch/train.py", "distributed/collectives.py",
                    "training/sharded.py")


@pytest.mark.parametrize("module", TRAINING_MODULES)
def test_training_modules_are_scanned(module):
    """The training slice's modules keep their own copies of what they need
    from the reference (the tree walk, the streams, the optimizers): each
    is a port file the import scan covers."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


def test_training_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.train, repro_torch.training, "
            "repro_torch.training.sharded, "
            "repro_torch.distributed.collectives, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.bridge; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


DRYRUN_MODULES = ("models/params.py", "launch/specs.py", "launch/dryrun.py",
                  "launch/mesh.py")
EXAMPLES = ("torch_quickstart.py", "torch_generate_images.py",
            "torch_serve_images.py", "torch_serve_llm.py",
            "torch_train_dit.py")


@pytest.mark.parametrize("module", DRYRUN_MODULES)
def test_dryrun_modules_are_scanned(module):
    """The dry run's modules keep their own copies of what they need from
    the reference (``ParamDef``, the bundles, the roofline): each is a
    port file the import scan covers."""
    path = ROOT / "src" / "repro_torch" / module
    assert path in PORT_FILES
    assert not set(_imported_roots(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_are_scanned(name):
    path = ROOT / "examples" / name
    assert path in PORT_FILES
    roots = set(_imported_roots(path))
    assert "repro_torch" in roots and not roots & set(FORBIDDEN)


def test_dryrun_import_leaves_jax_unloaded():
    code = ("import sys, runpy, repro_torch.launch.dryrun, "
            "repro_torch.launch.specs, repro_torch.models.params; "
            "[runpy.run_path(p) for p in sys.argv[1:]]; "
            "assert 'jax' not in sys.modules, 'jax was imported'; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'repro was imported'")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", code] + [str(ROOT / "examples" / e)
                                        for e in EXAMPLES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
