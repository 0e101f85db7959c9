"""Every kernel wrapper of ``repro_torch.cuda_kernels`` has a plain twin of
the same name in ``cuda_kernels/ref.py``, and a ``tests/test_torch_*.py``
holds the one against the other (names both).

A kernel wrapper is a public function of a ``cuda_kernels`` module that
carries a ``launches`` counter (each wrapper adds one to it where it
launches its kernel); ``build.py`` and ``route.py`` hold no kernel."""
import tests.torch_threads  # noqa: F401  (first: one thread)
import importlib
import inspect
import re
from pathlib import Path

import pytest

from repro_torch.cuda_kernels import ref

ROOT = Path(__file__).resolve().parents[1]
KERNEL_DIR = ROOT / "src" / "repro_torch" / "cuda_kernels"
NOT_KERNELS = {"__init__", "build", "route", "ref"}
MODULES = sorted(p.stem for p in KERNEL_DIR.glob("*.py")
                 if p.stem not in NOT_KERNELS)


def _wrappers(module_name):
    mod = importlib.import_module(f"repro_torch.cuda_kernels.{module_name}")
    return [name for name, fn in inspect.getmembers(mod, inspect.isfunction)
            if fn.__module__ == mod.__name__ and not name.startswith("_")
            and hasattr(fn, "launches")]


WRAPPERS = [(m, name) for m in MODULES for name in _wrappers(m)]
TEST_SOURCES = {p.name: p.read_text()
                for p in sorted((ROOT / "tests").glob("test_torch_*.py"))
                if p.name != Path(__file__).name}


@pytest.mark.parametrize("module_name", MODULES)
def test_every_kernel_module_has_a_counted_wrapper(module_name):
    assert _wrappers(module_name), (
        f"cuda_kernels/{module_name}.py has no public function with a "
        "launches counter")


def test_the_seven_wrappers():
    assert sorted(name for _, name in WRAPPERS) == sorted([
        "flash_attention", "fused_gate", "knn_density", "linear_blend",
        "merge_assign", "saliency_delta", "unmerge_scatter"])


@pytest.mark.parametrize("module_name,name", WRAPPERS,
                         ids=[n for _, n in WRAPPERS])
def test_wrapper_has_a_plain_twin_and_a_test(module_name, name):
    twin = getattr(ref, name, None)
    assert inspect.isfunction(twin), f"ref.py has no {name}"
    wrapper = re.compile(rf"(?<!ref\.)\b{name}\(")
    plain = re.compile(rf"\bref\.{name}\(")
    holders = [f for f, src in TEST_SOURCES.items()
               if wrapper.search(src) and plain.search(src)]
    assert holders, f"no tests/test_torch_*.py calls {name} and ref.{name}"
