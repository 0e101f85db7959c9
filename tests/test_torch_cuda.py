"""Card-only tests of the port's CUDA kernels against their plain PyTorch
versions.  They skip without a CUDA card.  This file imports neither JAX
nor the reference, so it also runs on a machine with no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py

Tolerances: gate bits exact (the kernel rebuilds the gate in the plain
version's operation order and the decisions sit a factor 2 from the
threshold); diff/prevsq rtol 1e-4 (f32 sums in another order); out rtol and
atol 1e-4 in f32, 2e-2 in bf16 (one bf16 rounding of a value near 4).
"""
import pytest
import torch

from repro_torch.core.statcache import make_threshold
from repro_torch.cuda_kernels import ref
from repro_torch.cuda_kernels.fused_gate import fused_gate


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _gate_inputs(dev, dtype, b, c, d, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = randn(b, c, d).to(dtype)
    prev = (x.float() + randn(b, c, d, scale=0.01)).to(dtype)
    po = randn(b, c, d).to(dtype)
    w = torch.eye(d, device=dev) + randn(d, d, scale=0.01)
    bias = randn(d, scale=0.1)
    thr = make_threshold(0.05, c * d)
    diff = (x.double() - prev.double()).square().sum(dim=(1, 2))
    factor = torch.tensor([2.0, 0.5] * b, device=dev,
                          dtype=torch.float64)[:b]      # even samples gate
    sigma2 = (diff / (c * d * thr) * factor).float()
    eligible = torch.arange(b, device=dev) != b - 1       # last ineligible
    return (x, prev, po, w, bias, sigma2, eligible), thr


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_blend", [True, False])
@pytest.mark.parametrize("shape", [(8, 128, 1152), (3, 40, 100)])
def test_fused_gate_kernel_matches_plain(cuda_device, dtype, use_blend,
                                         shape):
    args, thr = _gate_inputs(cuda_device, dtype, *shape)
    kw = dict(threshold=thr, gamma=0.5, use_blend=use_blend)
    before = fused_gate.launches
    got = fused_gate(*args, **kw)
    torch.cuda.synchronize(cuda_device)
    assert fused_gate.launches == before + 1
    want = ref.fused_gate(*args, **kw)
    assert got[0].dtype == dtype and got[1].dtype == torch.bool
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)
    assert 0 < int(got[1].sum()) < shape[0]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=0)
    torch.testing.assert_close(got[3], want[3], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_fused_gate_kernel_is_deterministic(cuda_device):
    args, thr = _gate_inputs(cuda_device, torch.bfloat16, 8, 128, 1152)
    first = fused_gate(*args, threshold=thr)
    for _ in range(3):
        again = fused_gate(*args, threshold=thr)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_gate_raises_on_bad_cuda_input(cuda_device):
    args, thr = _gate_inputs(cuda_device, torch.float16, 2, 8, 16)
    with pytest.raises(TypeError):
        fused_gate(*args, threshold=thr)


@pytest.mark.cuda
def test_cached_step_kernel_matches_plain_path(cuda_device, monkeypatch):
    """The fastcache step on the card with the kernel and, with the plain
    version patched in, without it: the same gates at every step, eps
    within f32 rounding."""
    from repro_torch.configs.base import FastCacheConfig
    from repro_torch.configs.dit import reduced
    from repro_torch.core.policies import fastcache
    from repro_torch.core.runner import CachedDiT
    from repro_torch.models.dit import DiTModel

    cfg = reduced().replace(dtype="float32")
    model = DiTModel(cfg, device=cuda_device)
    model.init(torch.Generator(cuda_device).manual_seed(0))
    kernel, plain = (CachedDiT(model, FastCacheConfig()) for _ in range(2))
    states = [kernel.init_state(4), plain.init_state(4)]
    gen = torch.Generator(cuda_device).manual_seed(1)
    x = torch.randn((4, 8, 8, 4), generator=gen, device=cuda_device)
    labels = torch.arange(4, device=cuda_device)
    before = fused_gate.launches
    for i in range(6):
        t = torch.full((4,), 50 - i, device=cuda_device)
        outs = [kernel.step(states[0], x, t, labels)]
        with monkeypatch.context() as m:
            m.setattr(fastcache, "fused_gate", ref.fused_gate)
            outs.append(plain.step(states[1], x, t, labels))
        states = [o[1] for o in outs]
        for k in ("blocks_computed", "blocks_skipped", "motion_frac_sum"):
            assert torch.equal(states[0]["stats"][k], states[1]["stats"][k])
        torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-4,
                                   atol=1e-4)
        x = x - 0.02 * outs[1][0]
    assert fused_gate.launches - before == cfg.num_layers * 5
    assert float(states[0]["stats"]["blocks_skipped"].sum()) > 0
