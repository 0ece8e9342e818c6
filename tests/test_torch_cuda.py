"""The port's CUDA kernels on the card, against their plain versions.

Imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Tolerances: the scan 1e-5 in fp32 and 2e-2 in bf16; the fused
step's h 2e-5 and its gate codes equal away from a code step."""
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
