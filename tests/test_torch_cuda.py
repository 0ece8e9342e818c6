"""The port's CUDA kernels on the card, against their plain versions.

Imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Tolerances: the scan and its adjoint 1e-5 in fp32 and 2e-2 in
bf16; the fused step's h 2e-5 and its gate codes equal away from a code
step; the fused sequence kernel bit for bit."""
import numpy as np
import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan import ref as scan_ref
from repro_torch.kernels.minimalist_block import ops as mb_ops
from repro_torch.kernels.minimalist_block import ref as mb_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(3, 77, 1000), (4, 256, 960),
                                   (1, 5, 3)])
def test_linear_scan_kernel_matches_plain(cuda, shape, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    z = torch.sigmoid(torch.randn(shape, device=cuda, generator=g))
    a = (1.0 - z).to(dtype)
    b = (z * torch.randn(shape, device=cuda, generator=g)).to(dtype)
    h0 = torch.randn(shape[0], shape[2], device=cuda, generator=g).to(dtype)
    n0 = scan_ops.linear_scan_kernel.launches
    got = scan_ops.linear_scan_kernel(a, b, h0)
    assert scan_ops.linear_scan_kernel.launches == n0 + 1
    want = scan_ref.linear_scan_associative(a, b, h0)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_linear_scan_kernel_rejects_bad_inputs(cuda):
    a = torch.zeros(2, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        scan_ops.linear_scan_kernel(a, a, torch.zeros(2, 8, device=cuda,
                                                      dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.linear_scan_kernel(a.transpose(1, 2).contiguous()
                                    .transpose(1, 2), a,
                                    torch.zeros(2, 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(8, 64, 64), (8, 1, 64), (8, 64, 10),
                                   (64, 1024, 1024), (3, 17, 130)])
def test_minimalist_step_kernel_matches_plain(cuda, B, K, N):
    g = torch.Generator(device=cuda).manual_seed(B + K + N)
    x = (torch.rand(B, K, device=cuda, generator=g) > 0.5).float()
    ch = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    cz = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    bh = torch.randn(N, device=cuda, generator=g) * 0.5
    bz = torch.randn(N, device=cuda, generator=g) * 0.5
    hp = torch.randn(B, N, device=cuda, generator=g)
    scale = 0.11 / max(1, K // 64)
    y, h, zc = mb_ops.minimalist_step_kernel(x, ch, cz, scale, bh, bz, hp,
                                             return_z_codes=True)
    yp, hpl, zcp = mb_ref.minimalist_step_ref(x, ch, cz, scale, bh, bz, hp,
                                              return_z_codes=True)
    torch.cuda.synchronize()
    v = quant.hard_sigmoid((x @ (cz.float() - 1.5)) * scale + bz) * 63
    near = ((v - torch.round(v)).abs() <= 1e-3).cpu().numpy()
    same = (zc == zcp).cpu().numpy()
    assert (same | near).all()
    np.testing.assert_allclose(h.cpu().numpy()[same],
                               hpl.cpu().numpy()[same], atol=2e-5)
    flips = ((y != yp) & (hpl.abs() > 1e-4)).cpu().numpy()
    assert not flips.any()


@pytest.mark.cuda
def test_streaming_engine_fused_equals_unfused_on_card(cuda):
    from repro_torch.core.mingru import MinimalistNetwork
    from repro_torch.core.quant import QuantConfig
    from repro_torch.serve import MinimalistStepModel, ServeEngine

    net = MinimalistNetwork((1, 64, 64, 10), qcfg=QuantConfig.hardware(),
                            device=cuda)
    net.reset_parameters(torch.Generator(device=cuda).manual_seed(3))
    rng = np.random.default_rng(3)
    streams = [(rng.random((T, 1)) < 0.3).astype(np.float32)
               for T in (50, 31, 64)]
    outs = []
    for fused in (True, False):
        eng = ServeEngine(MinimalistStepModel(net, use_fused_kernel=fused),
                          slots=2)
        reqs = [eng.submit(s) for s in streams]
        eng.run()
        outs.append([r.tokens for r in reqs])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=2e-5)


def _scan_inputs(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.sigmoid(torch.randn(shape, device=dev, generator=g))
    a = (1.0 - z).to(dtype)
    b = (z * torch.randn(shape, device=dev, generator=g)).to(dtype)
    h0 = torch.randn(shape[0], shape[2], device=dev, generator=g).to(dtype)
    gout = torch.randn(shape, device=dev, generator=g).to(dtype)
    return a, b, h0, gout


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(3, 77, 1000), (8, 256, 960), (1, 5, 3),
                                   (2, 1, 7)])
def test_linear_scan_bwd_kernel_matches_plain(cuda, shape, dtype, tol):
    a, b, h0, gout = _scan_inputs(shape, dtype, cuda)
    h = scan_ref.linear_scan_associative(a, b, h0)
    n0 = scan_ops.linear_scan_bwd_kernel.launches
    got = scan_ops.linear_scan_bwd_kernel(a, h, h0, gout)
    assert scan_ops.linear_scan_bwd_kernel.launches == n0 + 1
    want = scan_ref.linear_scan_bwd(a, h, h0, gout)
    torch.cuda.synchronize()
    for name, x, y in zip(("da", "db", "dh0"), got, want):
        assert x.dtype == dtype and x.shape == y.shape, name
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   y.float().cpu().numpy(), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_scan_is_differentiable_on_cuda(cuda, dtype):
    """The CUDA scan has a grad_fn, its backward launches the adjoint
    kernel, and a and b receive non-zero gradients."""
    a, b, h0, _ = _scan_inputs((2, 64, 130), dtype, cuda, seed=1)
    a.requires_grad_()
    b.requires_grad_()
    n_fwd = scan_ops.linear_scan_kernel.launches
    n_bwd = scan_ops.linear_scan_bwd_kernel.launches
    h = scan_ops.linear_scan(a, b, h0)
    assert h.grad_fn is not None
    h.float().sum().backward()
    torch.cuda.synchronize()
    assert scan_ops.linear_scan_kernel.launches == n_fwd + 1
    assert scan_ops.linear_scan_bwd_kernel.launches == n_bwd + 1
    assert a.grad is not None and a.grad.abs().sum() > 0
    assert b.grad is not None and b.grad.abs().sum() > 0
    a2 = a.detach().clone().requires_grad_()
    b2 = b.detach().clone().requires_grad_()
    scan_ops.linear_scan(a2, b2, h0, backend="assoc").float().sum() \
        .backward()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for x, y in ((a.grad, a2.grad), (b.grad, b2.grad)):
        np.testing.assert_allclose(x.float().cpu().numpy(),
                                   y.float().cpu().numpy(), atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,K,N", [(8, 784, 64, 64), (4, 98, 48, 48),
                                     (3, 60, 8, 130), (1, 8, 4, 8),
                                     (8, 98, 48, 10)])
def test_minimalist_block_kernel_matches_plain_bitwise(cuda, B, T, K, N):
    g = torch.Generator(device=cuda).manual_seed(B + T + K + N)
    x = (torch.rand(B, T, K, device=cuda, generator=g) > 0.5).float()
    ch = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    cz = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    bh = torch.randn(N, device=cuda, generator=g) * 0.5
    bz = torch.randn(N, device=cuda, generator=g) * 0.5
    h0 = torch.randn(B, N, device=cuda, generator=g)
    scale = 0.11 / max(1, K // 64)
    n0 = mb_ops.minimalist_block_kernel.launches
    y, h = mb_ops.minimalist_block(x, ch, cz, scale, bh, bz, h0)
    assert mb_ops.minimalist_block_kernel.launches == n0 + 1
    yp, hp = mb_ref.minimalist_block_ref(x, ch, cz, scale, bh, bz, h0)
    torch.cuda.synchronize()
    assert torch.equal(h, hp) and torch.equal(y, yp)


@pytest.mark.cuda
def test_lm_train_step_on_cuda_launches_both_scan_kernels(cuda):
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train import build_train_step

    cfg = get_config("minimalist-lm-360m-smoke")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    step = build_train_step(model, AdamW(param_groups(model), lr=1e-3))
    batch = {k: torch.from_numpy(v).to(cuda, torch.int64) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=32).sample(
                 4, 0).items()}
    n_fwd = scan_ops.linear_scan_kernel.launches
    n_bwd = scan_ops.linear_scan_bwd_kernel.launches
    _, met = step({}, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    assert scan_ops.linear_scan_kernel.launches - n_fwd == cfg.n_layers
    assert scan_ops.linear_scan_bwd_kernel.launches - n_bwd == cfg.n_layers
