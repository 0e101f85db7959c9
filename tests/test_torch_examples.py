"""The port's five examples (``examples/torch_*.py``) at their smoke size on
the CPU: each runs through its ``main`` and prints the summary lines of
the reference's example (``examples/*.py``), at its default flags but the
training's step count (6 of 120), and with no write outside the test's
directory; the configs are the examples' own (the reduced models)."""
import tests.torch_threads  # noqa: F401  (first: one thread)
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core.policies.base import registered_policies

ROOT = Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(name, argv, capsys):
    _example(name).main(argv + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def test_quickstart(capsys):
    lines = _run("torch_quickstart", [], capsys)
    assert lines[0] == "model: dit-smoke (2L d=128)"
    assert re.fullmatch(r"exact    : \d+\.\d{3}s", lines[1])
    assert re.fullmatch(r"fastcache: \d+\.\d{3}s  \(block cache ratio "
                        r"\d+\.\d%, motion fraction \d+\.\d%\)", lines[2])
    m = re.fullmatch(r"relative deviation from exact sampler: "
                     r"(\d+\.\d{4})", lines[3])
    # adaLN-zero weights (the reference's init) make every block the
    # identity, so the cached sampler is the exact one
    assert m and float(m.group(1)) == 0.0


def test_generate_images(tmp_path, capsys):
    lines = _run("torch_generate_images", ["--out", str(tmp_path)], capsys)
    assert lines[0].split() == ["policy", "time_s", "cache%", "reused",
                                "rel_err"]
    rows = [ln.split() for ln in lines[1:-1]]
    assert [r[0] for r in rows] == list(registered_policies())
    assert rows[0][2:] == ["0.0%", "0", "0.0000"]           # nocache
    assert lines[-1] == f"latents saved under {tmp_path}/"
    x = np.load(tmp_path / "latents_fastcache.npy")
    assert x.shape == (2, 8, 8, 4) and np.isfinite(x).all()


def test_serve_images(tmp_path, capsys):
    lines = _run("torch_serve_images", ["--out", str(tmp_path)], capsys)
    assert lines[0].split() == ["rid", "label", "arrive", "admit", "finish",
                                "latency"]
    rows = [[int(v) for v in ln.split()] for ln in lines[1:7]]
    assert [r[0] for r in rows] == list(range(6))
    for rid, label, arrive, admit, finish, latency in rows:
        assert arrive <= admit < finish and latency == finish - arrive
    assert re.fullmatch(r"6 requests in \d+\.\d\ds over \d+ engine steps; "
                        r"cache: \d+\.\d% blocks skipped \(active slots\)",
                        lines[7])
    assert lines[8] == f"latents saved under {tmp_path}/"
    assert len(list(tmp_path.glob("latents_req*.npy"))) == 6


def test_serve_llm(capsys):
    lines = _run("torch_serve_llm", [], capsys)
    assert re.fullmatch(r"exact     : 144 tokens in \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", lines[0])
    assert re.fullmatch(r"fastcache : 144 tokens in \d+\.\d\ds \(\d+\.\d "
                        r"tok/s, block cache ratio \d+\.\d%\)", lines[1])
    assert re.fullmatch(r"greedy-token agreement vs exact: \d+\.\d%",
                        lines[2])


def test_train_dit(tmp_path, capsys):
    ckpt = tmp_path / "dit"
    lines = _run("torch_train_dit", ["--steps", "6", "--save", str(ckpt)],
                 capsys)
    assert lines[0] == "[train] dit-smoke: 0.7M params, 6 steps"
    assert re.fullmatch(r"\[train\] step    0 mse=\d+\.\d{4} "
                        r"\(\d+\.\ds\)", lines[1])
    m = re.fullmatch(r"\[train\] loss (\d+\.\d{4}) -> (\d+\.\d{4})",
                     lines[-3])
    assert m and float(m.group(2)) < float(m.group(1))
    assert lines[-2] == f"[train] checkpoint -> {ckpt}"
    assert re.fullmatch(r"\[sample\] \(2, 8, 8, 4\) finite=True "
                        r"cache_ratio=\d+\.\d%", lines[-1])
    assert Path(str(ckpt) + ".npz").exists()


class _Stop(Exception):
    pass


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_generate_images",
                                  "torch_serve_images", "torch_serve_llm",
                                  "torch_train_dit"])
def test_examples_default_to_the_card(name, monkeypatch):
    """Without ``--device`` an example asks ``resolve_device`` for the
    card (which raises where there is none) before it builds anything."""
    mod = _example(name)
    seen = []

    def resolve(dev):
        seen.append(dev)
        raise _Stop

    monkeypatch.setattr(mod, "resolve_device", resolve)
    with pytest.raises(_Stop):
        mod.main([])
    assert seen == ["cuda"]
