"""The port's CUDA kernels on the card, against their plain versions.

Imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode).  Tolerances: the scan and its adjoint 1e-5 in fp32 and 2e-2 in
bf16; the fused step's h 2e-5 and its gate codes equal away from a code
step; the fused sequence kernel bit for bit; the paged decode kernels
(GQA and MLA) 2e-6 of their plain version in fp32 and, for bf16 outputs,
one bf16 ulp plus that fp32 bound (both round fp32 results within 2e-6
of each other); the IMC projection the reference's 1e-5; the flash-attention forward 2e-5 in fp32 and one bf16 ulp plus
2e-6 in bf16, its gradients the reference's atol 5e-5 / rtol 5e-4 in
fp32 and one bf16 ulp on top of that in bf16; the fused selective scan
the reference's 2e-5 (forward) and atol 5e-5 / rtol 5e-4 (gradients),
with atol scaled by the largest magnitude of the plain result; the flash
kernels at whisper-small's and llava-next-34b's training shapes one bf16
ulp plus 2e-6 of the plain version, the gradients of its fp64 sums."""
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


# the chunked scan's edges (csrc/linear_scan.cuh: chunks of 8 or 16
# steps, blocks of up to 512 threads, several tiles of T walked in turn
# past that): T of one step, one below and one above a chunk of each
# length, T past a whole tile (at D 40, forward and backward, fp32 and
# bf16), a long T at a narrow D (the next tile's loads in flight), a D
# that two but not four divides and an odd D at sizes that would take
# the vector route, 4-element vectors over several tiles, B = 1 at the
# LM's prefill chunk
SCAN_EDGE_SHAPES = [(2, 1, 7), (1, 7, 33), (1, 9, 33), (1, 15, 33),
                    (1, 17, 33), (2, 513, 40), (2, 257, 40), (1, 1025, 40),
                    (2, 2048, 64), (2, 1024, 2050), (2, 1024, 2051),
                    (4, 512, 8192), (1, 256, 960)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(3, 77, 1000), (4, 256, 960),
                                   (1, 5, 3)] + SCAN_EDGE_SHAPES)
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
                                   (2, 1, 7)] + SCAN_EDGE_SHAPES[1:])
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
                                     (8, 98, 48, 10), (32, 98, 1, 48),
                                     (32, 98, 48, 10), (256, 784, 64, 64),
                                     (2, 1, 17, 24), (5, 130, 17, 70),
                                     (2, 70, 150, 24), (1, 65, 3100, 8)])
def test_minimalist_block_kernel_matches_plain_bitwise(cuda, B, T, K, N):
    """Binary x: equal bit for bit, including K of several 64-column panels
    (150) and K whose levels do not stay in shared memory (3100)."""
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


def _block_inputs(cuda, B, T, K, N, seed, *, binary=True):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.rand(B, T, K, device=cuda, generator=g)
    if binary:
        x = (x > 0.5).float()
    ch = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    cz = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                       dtype=torch.int8)
    bh = torch.randn(N, device=cuda, generator=g) * 0.5
    bz = torch.randn(N, device=cuda, generator=g) * 0.5
    h0 = torch.randn(B, N, device=cuda, generator=g)
    return x, ch, cz, 0.11, bh, bz, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,K,N", [(8, 784, 64, 64), (3, 70, 17, 130),
                                     (4, 98, 1, 48)])
def test_minimalist_block_kernel_analog_x_within_fp32_rounding(cuda, B, T,
                                                               K, N):
    """Analog x (x carried in three bf16 parts): h within 2e-5 of the
    plain version up to a chain's first gate value within 1e-3 of a code
    step, Θ flips only where |h| < 1e-4."""
    x, ch, cz, scale, bh, bz, h0 = _block_inputs(cuda, B, T, K, N,
                                                 seed=B + T + K + N,
                                                 binary=False)
    y, h = mb_ops.minimalist_block_kernel(x, ch, cz, scale, bh, bz, h0)
    yp, hp = mb_ref.minimalist_block_ref(x, ch, cz, scale, bh, bz, h0)
    v = quant.hard_sigmoid((x @ (cz.float() - 1.5)) * scale + bz) * 63
    tie = ((v - torch.round(v)).abs() <= 1e-3).int()
    clean = torch.cummax(tie, dim=1).values == 0
    assert clean.float().mean() > 0.5
    assert (h - hp).abs()[clean].max().item() <= 2e-5
    flips = (y != yp) & clean & (hp.abs() > 1e-4)
    assert not flips.any()


@pytest.mark.cuda
def test_minimalist_block_kernel_replays_in_a_cuda_graph(cuda):
    """Captured in a CUDA graph and replayed, the launch writes what an
    eager call writes (the per-launch shared-memory attribute is set
    outside the stream)."""
    args = _block_inputs(cuda, 16, 130, 64, 64, seed=5)
    want = mb_ops.minimalist_block_kernel(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        mb_ops.minimalist_block_kernel(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = mb_ops.minimalist_block_kernel(*args)
    for t in got:
        t.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_minimalist_block_kernel_raises_on_meta_and_mixed_devices(cuda):
    """No plain fallback off the CPU: the meta device and a meta input
    among CUDA tensors are refused before any launch."""
    x, ch, cz, scale, bh, bz, h0 = _block_inputs(cuda, 2, 5, 4, 8, seed=1)
    n0 = mb_ops.minimalist_block_kernel.launches
    args = [x, ch, cz, bh, bz, h0]
    for i in range(len(args)):
        mixed = [a.to("meta") if j == i else a for j, a in enumerate(args)]
        with pytest.raises(ValueError, match="different devices"):
            mb_ops.minimalist_block_kernel(*mixed[:3], scale, *mixed[3:])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        mb_ops.minimalist_block_kernel(*meta[:3], scale, *meta[3:])
    assert mb_ops.minimalist_block_kernel.launches == n0


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


# -- paged GQA decode: both kernels against their plain version ----------

def _paged_setup(dev, *, B=3, H=6, KV=2, hd=16, L=24, ps=8, num_pages=40,
                 seed=0, garbage=50.0):
    """Disjoint random chains over a pool whose other pages hold large
    garbage; the chains' pages hold dense K/V rows."""
    rng = np.random.default_rng(seed)
    n_chain = -(-L // ps)
    bt = rng.permutation(num_pages)[:B * n_chain].reshape(B, n_chain)
    pk = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    pv = rng.standard_normal((num_pages, ps, KV, hd)).astype(np.float32)
    pk *= garbage
    pv *= garbage
    for b in range(B):
        for j in range(L):
            pk[bt[b, j // ps], j % ps] = rng.standard_normal((KV, hd))
            pv[bt[b, j // ps], j % ps] = rng.standard_normal((KV, hd))
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    pos = rng.integers(0, 3 * L, size=B)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(q), t(pk), t(pv), t(bt, torch.int32), t(pos, torch.int32))


def _bf16_close(got, want):
    """bf16 outputs of two fp32 computations within 2e-6 of each other:
    equal to one bf16 ulp (of the larger magnitude), plus the fp32 bound
    where cancellation leaves an output near zero."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + 2e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 8, 16])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_kernel_matches_plain(cuda, ps, window, dtype):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    L = 24 if window is None else 7
    q, pk, pv, bt, pos = _paged_setup(cuda, L=L, ps=ps, seed=ps)
    if window is None:
        pos = pos.clamp(max=L - 1)
    q, pk, pv = q.to(dtype), pk.to(dtype), pv.to(dtype)
    n0 = pa_ops.paged_gqa_kernel.launches
    got = pa_ops.paged_gqa_kernel(q, pk, pv, bt, pos, length=L,
                                  window=window)
    assert pa_ops.paged_gqa_kernel.launches == n0 + 1
    want = pa_ref.paged_gqa_ref(q, pk, pv, bt, pos, length=L, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_gqa_q8_kernel_matches_plain(cuda, window, dtype):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq
    from repro_torch.kernels.paged_attention import ref as pa_ref

    L = 24 if window is None else 7
    q, pk, pv, bt, pos = _paged_setup(cuda, L=L, ps=4, seed=11)
    if window is None:
        pos = pos.clamp(max=L - 1)
    ks, vs = kvq.page_abs_scale(pk), kvq.page_abs_scale(pv)
    ck, cv = kvq.quantize(pk, ks), kvq.quantize(pv, vs)
    q = q.to(dtype)
    n0 = pa_ops.paged_gqa_q8_kernel.launches
    got = pa_ops.paged_gqa_q8_kernel(q, ck, cv, ks, vs, bt, pos, length=L,
                                     window=window)
    assert pa_ops.paged_gqa_q8_kernel.launches == n0 + 1
    want = pa_ref.paged_gqa_ref(q, ck, cv, bt, pos, length=L, window=window,
                                k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
def test_paged_gqa_kernel_chain_permutation_and_stale_pages(cuda):
    """Where a chain's pages sit in the pool does not matter (bitwise),
    and neither do foreign pages behind unallocated block-table entries
    past the live position (the reference's
    test_chain_permutation_invariance and
    test_stale_pages_and_unallocated_entries_ignored)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    q, pk, pv, bt, pos = _paged_setup(cuda, L=16, ps=4, seed=3)
    pos = pos.clamp(max=15)
    perm = torch.as_tensor(np.random.default_rng(4).permutation(40),
                           device=cuda)
    inv = torch.argsort(perm)
    # page i moves to slot perm[i]; the block table follows it
    bt2 = perm[bt.long()].to(torch.int32)
    pk2, pv2 = pk[inv], pv[inv]
    for fn in (lambda *a: pa_ops.paged_gqa_kernel(*a, length=16),):
        a = fn(q, pk, pv, bt, pos)
        b = fn(q, pk2, pv2, bt2, pos)
        assert torch.equal(a, b)
    short = pos.clamp(max=3)           # only chain entry 0 is live
    poison = bt.clone()
    poison[:, 1:] = (bt[:, 1:] + 1) % 40
    a = pa_ops.paged_gqa_kernel(q, pk, pv, bt, short, length=16)
    b = pa_ops.paged_gqa_kernel(q, pk, pv, poison, short, length=16)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_paged_gqa_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq

    q, pk, pv, bt, pos = _paged_setup(cuda, L=16, ps=4)
    with pytest.raises(ValueError, match="different devices"):
        pa_ops.paged_gqa_kernel(q, pk.cpu(), pv.cpu(), bt, pos, length=16)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_gqa_kernel(q.transpose(0, 1).contiguous()
                                .transpose(0, 1), pk, pv, bt, pos,
                                length=16)
    with pytest.raises(ValueError, match="int32"):
        pa_ops.paged_gqa_kernel(q, pk, pv, bt.long(), pos, length=16)
    with pytest.raises(ValueError, match="dtype"):
        pa_ops.paged_gqa_kernel(q, pk.to(torch.bfloat16),
                                pv.to(torch.bfloat16), bt, pos, length=16)
    ks = kvq.page_abs_scale(pk)
    ck = kvq.quantize(pk, ks)
    with pytest.raises(ValueError, match="int8"):
        pa_ops.paged_gqa_q8_kernel(q, pk, pv, ks, ks, bt, pos, length=16)
    with pytest.raises(ValueError, match="float32"):
        pa_ops.paged_gqa_q8_kernel(q, ck, ck, ks.double(), ks, bt, pos,
                                   length=16)


# (B, H, KV, hd, ps, length, window, pos) at the model shapes: smollm-360m
# at the serving path's shape (positions at and around page edges), a
# 2048-position chain (every cluster rank gets pages; then pos 0 and 17,
# where most ranks are empty), gemma3-4b's heads of 256 on a wrapped ring
# and on one not yet wrapped, G 8 x hd 128 (two query-row tiles), and
# qwen3-moe-30b-a3b's decode shape (32 query heads over 4 KV heads of 128,
# cache 512: chip_smoke's rows 5d/6d)
PAGED_MODEL_CASES = [
    (4, 15, 5, 64, 16, 256, None, [0, 15, 16, 17]),
    (4, 15, 5, 64, 16, 256, None, [200, 255, 17, 0]),
    (2, 15, 5, 64, 16, 2048, None, [2047, 1000]),
    (2, 15, 5, 64, 16, 2048, None, [0, 17]),
    (4, 8, 4, 256, 16, 1024, 1024, [4095, 3000, 1500, 1023]),
    (4, 8, 4, 256, 16, 1024, 1024, [1022, 500, 17, 0]),
    (4, 16, 2, 128, 16, 256, None, [255, 100, 31, 0]),
    (4, 32, 4, 128, 16, 512, None, [511, 511, 511, 511]),
    (4, 32, 4, 128, 16, 512, None, [511, 300, 17, 0]),
    # stablelm-12b's decode (32/8 heads of 160: the scalar route at bf16,
    # fp32 and int8; cache 544 = 512 + 32, chip_smoke's rows 5e/6e) and
    # mistral-large-123b's heads (96/8 of 128, group 12; rows 5f/6f)
    (4, 32, 8, 160, 16, 544, None, [543, 543, 543, 543]),
    (4, 32, 8, 160, 16, 544, None, [543, 300, 17, 0]),
    (4, 96, 8, 128, 16, 544, None, [543, 543, 543, 543]),
    (4, 96, 8, 128, 16, 544, None, [543, 200, 16, 1]),
]


def _paged_model_case(dev, case, dtype, q8, seed=0):
    """q and pools (dtype, or int8 codes with their scales) of disjoint
    random chains in a pool twice their size."""
    from repro_torch.kernels.paged_attention import quant as kvq

    B, H, KV, hd, ps, length, window, pos = case
    rng = np.random.default_rng(seed)
    n = -(-length // ps)
    num_pages = 2 * B * n
    bt = rng.permutation(num_pages)[:B * n].reshape(B, n)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    pk = t(rng.standard_normal((num_pages, ps, KV, hd)))
    pv = t(rng.standard_normal((num_pages, ps, KV, hd)))
    q = t(rng.standard_normal((B, H, hd))).to(dtype)
    sc = ()
    if q8:
        sc = (kvq.page_abs_scale(pk), kvq.page_abs_scale(pv))
        pk, pv = kvq.quantize(pk, sc[0]), kvq.quantize(pv, sc[1])
    else:
        pk, pv = pk.to(dtype), pv.to(dtype)
    kw = dict(length=length, window=window)
    return q, pk, pv, sc, t(bt, torch.int32), t(pos, torch.int32), kw


def _paged_kernel(q8):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    return pa_ops.paged_gqa_q8_kernel if q8 else pa_ops.paged_gqa_kernel


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("case", PAGED_MODEL_CASES, ids=str)
def test_paged_gqa_kernels_at_model_shapes(cuda, case, q8, dtype):
    from repro_torch.kernels.paged_attention import ref as pa_ref

    q, pk, pv, sc, bt, pos, kw = _paged_model_case(cuda, case, dtype, q8)
    kern = _paged_kernel(q8)
    n0 = kern.launches
    got = kern(q, pk, pv, *sc, bt, pos, **kw)
    assert kern.launches == n0 + 1
    sk = dict(zip(("k_scale", "v_scale"), sc))
    want = pa_ref.paged_gqa_ref(q, pk, pv, bt, pos, **kw, **sk)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
def test_paged_gqa_kernels_batch_independent_and_deterministic(cuda, q8):
    """A request decoded alone (B 1) equals, bit for bit, its row inside
    B 4 with other neighbours (the page ranges depend on the shape alone),
    and two calls on the same inputs are bitwise equal (fixed merge order,
    no atomics)."""
    case = (4, 15, 5, 64, 16, 2048, None, [1900, 5, 700, 2047])
    q, pk, pv, sc, bt, pos, kw = _paged_model_case(cuda, case,
                                                   torch.bfloat16, q8)
    kern = _paged_kernel(q8)
    full = kern(q, pk, pv, *sc, bt, pos, **kw)
    again = kern(q, pk, pv, *sc, bt, pos, **kw)
    # row 2 with other neighbours: rows 0 and 3 swapped, row 1 replaced
    perm = torch.tensor([3, 0, 2, 1], device=cuda)
    q2, bt2, pos2 = q[perm].clone(), bt[perm].clone(), pos[perm].clone()
    q2[3] = q2[3].flip(-1)
    pos2[3] = 33
    mixed = kern(q2, pk, pv, *sc, bt2, pos2, **kw)
    alone = kern(q[2:3].clone(), pk, pv, *sc, bt[2:3].clone(),
                 pos[2:3].clone(), **kw)
    torch.cuda.synchronize()
    assert torch.equal(full, again)
    assert torch.equal(alone[0], full[2])
    assert torch.equal(mixed[2], full[2])
    assert torch.equal(mixed[0], full[3]) and torch.equal(mixed[1], full[0])


# -- flash attention: forward and backward kernels against their plain
#    versions ---------------------------------------------------------------

# (B, H, KV, S, D, causal, window): head dims 16/32/64/128/256, ragged S
# (100, 255), the training path's shape, gemma3's local layers, windows 8
# and 1024, GQA groups 1, 3 and 8, non-causal with and without a window
FLASH_CASES = [
    (2, 3, 3, 100, 16, True, None),
    (1, 6, 2, 255, 64, True, 8),
    (1, 8, 1, 255, 256, False, None),
    (2, 4, 4, 100, 64, False, 8),
    (1, 3, 1, 128, 32, True, 16),
    (1, 2, 2, 64, 128, True, None),
    (4, 15, 5, 2048, 64, True, None),
    (1, 8, 4, 2048, 256, True, 1024),
    # head dims between the compiled ones: stablelm-12b's 160 (compiled)
    # and 80 (run at 128 with its extra columns zero), causal and windowed
    (1, 4, 2, 300, 160, True, None),
    (1, 4, 1, 300, 160, True, 64),
    (2, 3, 3, 130, 80, True, None),
    (1, 4, 2, 200, 80, True, 48),
]


# bf16 only, the tc route's edges: one row, one row past a tile, one row
# short of the path's length; GQA group 3
FLASH_TC_CASES = [
    (1, 3, 1, 1, 64, True, None),
    (2, 6, 2, 65, 32, True, 16),
    (1, 6, 2, 2047, 128, True, None),
]


def _tc_counts():
    from repro_torch.kernels.flash_attention import ops as fa_ops
    return (fa_ops.flash_fwd_kernel.launches_tc,
            fa_ops.flash_bwd_kernel.launches_dq_tc,
            fa_ops.flash_bwd_kernel.launches_dkv_tc)


def _flash_inputs(dev, B, H, KV, S, D, dtype, seed=0, g=None):
    if g is None:
        g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn(B, H, S, D, device=dev, generator=g) * 0.5).to(dtype)
    k = (torch.randn(B, KV, S, D, device=dev, generator=g) * 0.5).to(dtype)
    v = torch.randn(B, KV, S, D, device=dev, generator=g).to(dtype)
    do = torch.randn(B, H, S, D, device=dev, generator=g).to(dtype)
    return q, k, v, do


def _flash_check(got, want, dtype, atol, rtol):
    """fp32: within (atol, rtol) of the plain version.  bf16 outputs of
    two fp32 computations that agree to that bound: one bf16 ulp of the
    larger magnitude on top of it."""
    a, w = got.float(), want.float()
    bound = atol + rtol * w.abs()
    if dtype == torch.bfloat16:
        mag = torch.maximum(a.abs(), w.abs()).clamp(min=2.0 ** -126)
        bound = bound + torch.exp2(torch.floor(torch.log2(mag)) - 7)
    err = (a - w).abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_fwd_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, KV, S, D, causal, window = case
    q, k, v, _ = _flash_inputs(cuda, B, H, KV, S, D, dtype)
    n0, tc0 = fa_ops.flash_fwd_kernel.launches, _tc_counts()
    out, lse = fa_ops.flash_fwd_kernel(q, k, v, causal, window)
    assert fa_ops.flash_fwd_kernel.launches == n0 + 1
    tc = int(fa_ops.route(dtype, D) == "tc")
    assert _tc_counts() == (tc0[0] + tc,) + tc0[1:]
    want, want_lse = fa_ref.flash_attention_ref(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    # fp32: the reference's 2e-5; bf16: one ulp plus 2e-6 (chip_smoke's)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (2e-6, 0.0)
    _flash_check(out, want, dtype, atol, rtol)
    _flash_check(lse, want_lse, torch.float32, 2e-5, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_bwd_kernel_matches_plain(cuda, case, dtype):
    """Gradients at the reference's atol 5e-5 / rtol 5e-4; in bf16 one
    ulp on top (the fp32 sums over thousands of rows already part by a
    few 1e-6)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, KV, S, D, causal, window = case
    q, k, v, do = _flash_inputs(cuda, B, H, KV, S, D, dtype, seed=1)
    out, lse = fa_ref.flash_attention_ref(q, k, v, causal, window)
    n_dq = fa_ops.flash_bwd_kernel.launches_dq
    n_dkv = fa_ops.flash_bwd_kernel.launches_dkv
    tc0 = _tc_counts()
    got = fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, causal, window)
    assert fa_ops.flash_bwd_kernel.launches_dq == n_dq + 1
    assert fa_ops.flash_bwd_kernel.launches_dkv == n_dkv + 1
    tc = int(fa_ops.route(dtype, D) == "tc")
    assert _tc_counts() == (tc0[0], tc0[1] + tc, tc0[2] + tc)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                          window)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        _flash_check(g, w, dtype, 5e-5, 5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_TC_CASES, ids=str)
def test_flash_tc_edge_cases_match_plain(cuda, case):
    """bf16 on the tc route at S 1, 65 and 2047 (GQA group 3): out within
    one bf16 ulp + 2e-6 of the plain version, lse 2e-5 + 2e-5 |lse|, the
    gradients the bwd test's bound; each kernel launched once on the tc
    route."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, KV, S, D, causal, window = case
    bf = torch.bfloat16
    q, k, v, do = _flash_inputs(cuda, B, H, KV, S, D, bf, seed=S)
    tc0 = _tc_counts()
    out, lse = fa_ops.flash_fwd_kernel(q, k, v, causal, window)
    got = fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, causal, window)
    assert _tc_counts() == tuple(x + 1 for x in tc0)
    want, want_lse = fa_ref.flash_attention_ref(q, k, v, causal, window)
    wgrads = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal,
                                            window)
    torch.cuda.synchronize()
    _flash_check(out, want, bf, 2e-6, 0.0)
    _flash_check(lse, want_lse, torch.float32, 2e-5, 2e-5)
    for g, w in zip(got, wgrads):
        _flash_check(g, w, bf, 5e-5, 5e-4)


@pytest.mark.cuda
def test_flash_bwd_tc_within_one_bf16_ulp_of_fp64_sums(cuda):
    """chip_smoke's flash_bwd path row (B 4, H 15, KV 5, S 2048, D 64,
    causal, bf16: the tc route) on the inputs its generator drew there
    once every minimalist_block row shared it (seed 0 at Philox offset
    41004): dq, dk and dv within one bf16 ulp + 2e-6 of the plain
    version's sums taken in fp64.  Against the fp32 plain version dv[0,
    2, 0, 63] is 2.5e-6 off on these inputs (kernel -2.861e-5, fp32 plain
    -2.611e-5, fp64 -2.785e-5; its terms sum to 20.4 in magnitude): the
    fp32 plain version's own error, which chip_smoke's check no longer
    measures."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, KV, S, D = 4, 15, 5, 2048, 64
    g = torch.Generator(device=cuda).manual_seed(0)
    g.set_offset(41004)
    q, k, v, do = _flash_inputs(cuda, B, H, KV, S, D, torch.bfloat16, g=g)
    out, lse = fa_ops.flash_fwd_kernel(q, k, v, True, None)
    got = fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, True, None)
    want = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True, None,
                                          acc=torch.float64)
    torch.cuda.synchronize()
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _bf16_close(a, w), name


@pytest.mark.cuda
def test_flash_tc_wrappers_raise_on_misaligned_operands(cuda):
    """TMA reads 16-byte-aligned bases and strides: the low-level
    wrappers refuse a base one element off on the tc route (the op
    copies such an operand first, ``ops._rows``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, do = _flash_inputs(cuda, 1, 4, 2, 64, 64, torch.bfloat16)
    odd = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:]
    odd = odd.view(q.shape).copy_(q)
    n = fa_ops.flash_fwd_kernel.launches, _tc_counts()
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_fwd_kernel(odd, k, v)
    out, lse = fa_ops.flash_fwd_kernel(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        fa_ops.flash_bwd_kernel(odd, k, v, out, lse, do)
    assert (fa_ops.flash_fwd_kernel.launches, _tc_counts()) == (
        n[0] + 1, (n[1][0] + 1,) + n[1][1:])
    got = fa_ops.flash_attention(odd, k, v)
    torch.cuda.synchronize()
    assert torch.equal(got, out)


@pytest.mark.cuda
def test_flash_kernels_bitwise_repeatable_and_strided(cuda):
    """Two calls give bitwise the same outputs and gradients (no atomics);
    (B, S, H, D) tensors passed as (B, H, S, D) views give the same bits
    as contiguous copies, and the outputs keep the views' layout."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, do = _flash_inputs(cuda, 2, 6, 2, 300, 64, torch.bfloat16)
    runs = []
    for _ in range(2):
        out, lse = fa_ops.flash_fwd_kernel(q, k, v, True, None)
        runs.append((out, lse) + fa_ops.flash_bwd_kernel(
            q, k, v, out, lse, do, True, None))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, do)]
    out, lse = fa_ops.flash_fwd_kernel(*views[:3], True, None)
    assert out.stride() == views[0].stride()
    grads = fa_ops.flash_bwd_kernel(*views[:3], out, lse, views[3], True,
                                    None)
    torch.cuda.synchronize()
    assert torch.equal(out, runs[0][0]) and torch.equal(lse, runs[0][1])
    assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][2:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_is_differentiable_on_cuda(cuda, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, do = _flash_inputs(cuda, 2, 6, 3, 130, 32, dtype, seed=2)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n = (fa_ops.flash_fwd_kernel.launches,
         fa_ops.flash_bwd_kernel.launches_dq,
         fa_ops.flash_bwd_kernel.launches_dkv)
    out = fa_ops.flash_attention(q, k, v, True, 16)
    assert out.grad_fn is not None
    out.backward(do)
    torch.cuda.synchronize()
    assert (fa_ops.flash_fwd_kernel.launches,
            fa_ops.flash_bwd_kernel.launches_dq,
            fa_ops.flash_bwd_kernel.launches_dkv) == tuple(x + 1 for x in n)
    for t in (q, k, v):
        assert t.grad is not None and t.grad.dtype == dtype
        assert bool(torch.isfinite(t.grad).all()) and t.grad.abs().max() > 0


@pytest.mark.cuda
def test_attention_lm_train_step_on_cuda_launches_flash_kernels(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("gemma3-4b-smoke"),
                              attention_impl="flash")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    step = build_train_step(model, AdamW(param_groups(model), lr=1e-3))
    batch = {k: torch.from_numpy(v).to(cuda, torch.int64) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=40).sample(
                 2, 0).items()}
    n = (fa_ops.flash_fwd_kernel.launches,
         fa_ops.flash_bwd_kernel.launches_dq,
         fa_ops.flash_bwd_kernel.launches_dkv)
    _, met = step({}, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    assert (fa_ops.flash_fwd_kernel.launches - n[0],
            fa_ops.flash_bwd_kernel.launches_dq - n[1],
            fa_ops.flash_bwd_kernel.launches_dkv - n[2]) == (cfg.n_layers,) * 3


# (B, H, KV, S, D) of the decoder self-attention of whisper-small's
# training (chip_smoke phase whisper: batch 4 x 448 tokens) and of
# llava-next-34b's (phase vlm: batch 2, 576 patches + 512 tokens, GQA group
# 7), causal, bf16: the tc route
FLASH_MODEL_CASES = [(4, 12, 12, 448, 64), (2, 56, 8, 1088, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_MODEL_CASES, ids=str)
def test_flash_kernels_at_whisper_and_llava_shapes(cuda, case):
    """flash_fwd and flash_bwd on the tc route at the two new training
    shapes: out within one bf16 ulp + 2e-6 of the plain version, lse 2e-5
    + 2e-5 |lse|, dq/dk/dv within one bf16 ulp + 2e-6 of the plain
    version's sums in fp64 (chip_smoke's kernel-row bounds)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, H, KV, S, D = case
    bf = torch.bfloat16
    q, k, v, do = _flash_inputs(cuda, B, H, KV, S, D, bf, seed=S)
    tc0 = _tc_counts()
    out, lse = fa_ops.flash_fwd_kernel(q, k, v, True, None)
    got = fa_ops.flash_bwd_kernel(q, k, v, out, lse, do, True, None)
    assert _tc_counts() == tuple(x + 1 for x in tc0)
    want, want_lse = fa_ref.flash_attention_ref(q, k, v, True, None)
    wgrads = fa_ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True,
                                            None, acc=torch.float64)
    torch.cuda.synchronize()
    assert _bf16_close(out, want)
    _flash_check(lse, want_lse, torch.float32, 2e-5, 2e-5)
    for g, w in zip(got, wgrads):
        assert g.dtype == bf and _bf16_close(g, w)


@pytest.mark.cuda
def test_whisper_builds_on_cuda_and_trains_through_flash(cuda):
    """build_model with no device named puts whisper-small-smoke on the
    card; one train step with attention_impl="flash" launches the flash
    kernels once a decoder layer, the encoder none (its softmax is the
    reference's naive one); the cached decode runs on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("whisper-small-smoke"),
                              attention_impl="flash")
    model = build_model(cfg)
    assert {p.device.type for p in model.parameters()} == {"cuda"}
    step = build_train_step(model, AdamW(param_groups(model), lr=1e-3))
    batch = {k: torch.from_numpy(v).to(cuda, torch.int64) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=24).sample(
                 2, 0).items()}
    g = torch.Generator(device=cuda).manual_seed(0)
    batch["embeds"] = 0.1 * torch.randn(2, cfg.frontend_seq, cfg.d_model,
                                        device=cuda, generator=g)
    n = (fa_ops.flash_fwd_kernel.launches,
         fa_ops.flash_bwd_kernel.launches_dq,
         fa_ops.flash_bwd_kernel.launches_dkv)
    _, met = step({}, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    assert (fa_ops.flash_fwd_kernel.launches - n[0],
            fa_ops.flash_bwd_kernel.launches_dq - n[1],
            fa_ops.flash_bwd_kernel.launches_dkv - n[2]) == (cfg.n_layers,) * 3
    with torch.no_grad():
        cache = model.init_cache(2, 4, frame_embeds=batch["embeds"])
        logits, _ = model.decode_step(batch["tokens"][:, :1], cache, 0)
    assert logits.device.type == "cuda"
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_flash_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.flash_attention import ops as fa_ops

    q, k, v, _ = _flash_inputs(cuda, 1, 4, 2, 32, 64, torch.float32)
    with pytest.raises(ValueError, match="different devices"):
        fa_ops.flash_fwd_kernel(q, k.cpu(), v)
    with pytest.raises(ValueError, match="dtype"):
        fa_ops.flash_fwd_kernel(q, k.bfloat16(), v)
    # every head dim up to 256 runs (FLASH_CASES); above it the card
    # refuses, the one head-dim divergence from the CPU path
    wide = _flash_inputs(cuda, 1, 4, 2, 32, 264, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_fwd_kernel(*wide[:3])
    with pytest.raises(ValueError, match="head dim"):
        fa_ops.flash_bwd_kernel(*wide[:3], wide[0], torch.zeros(
            1, 4, 32, device=cuda), wide[3])
    with pytest.raises(ValueError, match="H % KV"):
        fa_ops.flash_fwd_kernel(q[:, :3], k, v)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_fwd_kernel(q.transpose(2, 3), k.transpose(2, 3),
                                v.transpose(2, 3))


# ---------------------------------------------------------------------------
# the fused selective scan (forward and backward kernels)

SSM_CASES = [
    (2, 16, 128, 4),      # falcon-mamba-7b-smoke
    (3, 77, 1000, 16),    # tail chunk and tail d-block at d_state 16
    (1, 33, 300, 5),      # d_state not a power of two
    (2, 64, 256, 1),
    (1, 40, 8, 32),       # one d a warp
    (1, 300, 8192, 16),   # the main path's width
    # falcon-mamba-7b at TP 2 (d_inner 8192 / 2): the carry form's prefill
    # chunk and the training step's shape
    (1, 256, 4096, 16),
    (4, 2048, 4096, 16),
    # the layout's edges: d_inner one channel below and above a block
    # (256 channels at n <= 16, 128 at n 32), T one step below and above
    # CHUNK (32) and a backward sub-chunk (8), a forward stage (16) + 1
    (2, 31, 255, 16),
    (1, 33, 257, 16),
    (2, 7, 127, 32),
    (1, 9, 129, 32),
    (3, 17, 513, 4),
]


def _ssm_inputs(dev, B, T, di, n, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, di, device=dev, generator=g)) * 0.2
    x = torch.randn(B, T, di, device=dev, generator=g)
    Bm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
    Cm = torch.randn(B, T, n, device=dev, generator=g) * 0.5
    A = -torch.exp(torch.randn(di, n, device=dev, generator=g) * 0.3)
    dy = torch.randn(B, T, di, device=dev, generator=g)
    return dt, x, Bm, Cm, A, dy


def _ssm_check(got, want, atol, rtol):
    """The reference's (atol, rtol) with atol scaled by the largest
    magnitude of the plain result (sums over T and d_inner grow with
    the size)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    err = (got - want).abs()
    bound = atol * want.abs().max() + rtol * want.abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_fused_ssm_fwd_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    dt, x, Bm, Cm, A, _ = _ssm_inputs(cuda, *case)
    n0 = ssm_ops.fused_ssm_fwd_kernel.launches
    y, entries = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A)
    assert ssm_ops.fused_ssm_fwd_kernel.launches == n0 + 1
    want, want_entries = ssm_ref.fused_ssm_fwd_ref(dt, x, Bm, Cm, A,
                                                   ssm_ops.CHUNK)
    torch.cuda.synchronize()
    _ssm_check(y, want, 2e-5, 2e-5)
    _ssm_check(entries, want_entries, 2e-5, 2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_fused_ssm_bwd_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    dt, x, Bm, Cm, A, dy = _ssm_inputs(cuda, *case, seed=1)
    _, entries = ssm_ref.fused_ssm_fwd_ref(dt, x, Bm, Cm, A, ssm_ops.CHUNK)
    n0 = ssm_ops.fused_ssm_bwd_kernel.launches
    got = ssm_ops.fused_ssm_bwd_kernel(dt, x, Bm, Cm, A, entries, dy)
    assert ssm_ops.fused_ssm_bwd_kernel.launches == n0 + 1
    want = ssm_ref.fused_ssm_bwd_ref(dt, x, Bm, Cm, A, entries, dy,
                                     ssm_ops.CHUNK)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _ssm_check(g, w, 5e-5, 5e-4)


@pytest.mark.cuda
def test_fused_ssm_kernels_bitwise_repeatable(cuda):
    """No atomics: two calls give bitwise the same outputs and
    gradients."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops

    dt, x, Bm, Cm, A, dy = _ssm_inputs(cuda, 2, 100, 1000, 16, seed=2)
    runs = []
    for _ in range(2):
        y, entries = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A)
        runs.append((y, entries) + ssm_ops.fused_ssm_bwd_kernel(
            dt, x, Bm, Cm, A, entries, dy))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
def test_fused_ssm_path_shape_partials_and_build(cuda):
    """At the main path's shape (4, 2048, 8192, 16) a backward call
    allocates at most 67 MB of dB/dC partials beyond its outputs; both
    kernels build without spills, at the wrapper's channels a block."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops

    for n in (1, 5, 16, 32):
        for which in ("fwd", "bwd"):
            info = ssm_ops.kernel_info(which, n)
            assert info["local_bytes"] == 0, (which, n, info)
            assert info["blocks_per_sm"] >= 1, (which, n, info)
            assert info["channels"] == ssm_ops.block_channels(n)
    B, T, di, n = 4, 2048, 8192, 16
    dt, x, Bm, Cm, A, dy = _ssm_inputs(cuda, B, T, di, n, seed=4)
    _, entries = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    grads = ssm_ops.fused_ssm_bwd_kernel(dt, x, Bm, Cm, A, entries, dy)
    torch.cuda.synchronize()
    outputs = sum(g.numel() * g.element_size() for g in grads)
    extra = torch.cuda.max_memory_allocated(cuda) - base - outputs
    assert ssm_ops.partial_bytes(B, T, di, n) <= 67e6
    assert extra <= 67e6, extra


@pytest.mark.cuda
def test_selective_scan_is_differentiable_on_cuda(cuda):
    from repro_torch.kernels.fused_ssm import ops as ssm_ops

    dt, x, Bm, Cm, A, dy = _ssm_inputs(cuda, 2, 45, 96, 16, seed=3)
    ins = [t.requires_grad_() for t in (dt, x, Bm, Cm, A)]
    n = (ssm_ops.fused_ssm_fwd_kernel.launches,
         ssm_ops.fused_ssm_bwd_kernel.launches)
    y = ssm_ops.selective_scan(*ins)
    assert y.grad_fn is not None
    y.backward(dy)
    torch.cuda.synchronize()
    assert (ssm_ops.fused_ssm_fwd_kernel.launches,
            ssm_ops.fused_ssm_bwd_kernel.launches) == (n[0] + 1, n[1] + 1)
    for t in ins:
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all()) and t.grad.abs().max() > 0


@pytest.mark.cuda
def test_mamba_lm_train_step_on_cuda_launches_fused_kernels(cuda):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.models import build_model
    from repro_torch.optim import AdamW, param_groups
    from repro_torch.train import build_train_step

    cfg = dataclasses.replace(get_config("falcon-mamba-7b-smoke"),
                              ssm_impl="fused")
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    step = build_train_step(model, AdamW(param_groups(model), lr=1e-3))
    batch = {k: torch.from_numpy(v).to(cuda, torch.int64) for k, v in
             SyntheticLMDataset(vocab=cfg.vocab, seq_len=40).sample(
                 2, 0).items()}
    n = (ssm_ops.fused_ssm_fwd_kernel.launches,
         ssm_ops.fused_ssm_bwd_kernel.launches,
         scan_ops.linear_scan_kernel.launches,
         scan_ops.linear_scan_bwd_kernel.launches)
    _, met = step({}, batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(met["loss"]))
    assert (ssm_ops.fused_ssm_fwd_kernel.launches - n[0],
            ssm_ops.fused_ssm_bwd_kernel.launches - n[1],
            scan_ops.linear_scan_kernel.launches - n[2],
            scan_ops.linear_scan_bwd_kernel.launches - n[3]) == (
                cfg.n_layers, cfg.n_layers, 0, 0)


@pytest.mark.cuda
def test_fused_ssm_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.fused_ssm import ops as ssm_ops

    dt, x, Bm, Cm, A, dy = _ssm_inputs(cuda, 1, 8, 16, 4)
    with pytest.raises(ValueError, match="different devices"):
        ssm_ops.fused_ssm_fwd_kernel(dt.cpu(), x, Bm, Cm, A)
    with pytest.raises(ValueError, match="different devices"):
        ssm_ops.fused_ssm_fwd_kernel(dt, x.cpu(), Bm, Cm, A)
    with pytest.raises(ValueError, match="float32"):
        ssm_ops.fused_ssm_fwd_kernel(dt, x.bfloat16(), Bm, Cm, A)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_ops.fused_ssm_fwd_kernel(
            dt, x.transpose(1, 2).contiguous().transpose(1, 2), Bm, Cm, A)
    big = torch.zeros(1, 8, 33, device=cuda)
    with pytest.raises(ValueError, match="state size"):
        ssm_ops.fused_ssm_fwd_kernel(dt, x, big, big,
                                     torch.zeros(16, 33, device=cuda))
    _, entries = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A)
    with pytest.raises(ValueError, match="h_entries"):
        ssm_ops.fused_ssm_bwd_kernel(dt, x, Bm, Cm, A, entries[:, :0], dy)


# ---------------------------------------------------------------------------
# paged MLA decode over latent pages (bf16/fp32 and int8 pools)

# (B, H, r, dr, ps, L): the serving path's width (H 128, r 512, dr 64,
# page 16), H off the 8-head block, partial last pages, tiny ranks
MLA_CASES = [
    (3, 4, 16, 8, 4, 20),
    (2, 13, 32, 8, 5, 23),
    (4, 128, 512, 64, 16, 1056),
    (3, 20, 512, 64, 16, 100),
    (1, 1, 8, 4, 2, 3),
]

# (B, H, ps, L) of the tc route (bf16 queries, r 512, dr 64): H 64 (one
# head tile) and H 128 (two) at the path's page 16; H around the 64-head
# tile and eight tiles; a partial last page; a length that is not a whole
# 32-row stage at page 8; a single live page at page 16 and page 32; long
# chains whose many ranges the combine merges (32 ranges at 2 x 4096);
# the tensor-parallel ranks' head counts
MLA_TC_CASES = [
    (2, 64, 16, 200),
    (4, 128, 16, 1056),
    (2, 65, 16, 200),
    (2, 127, 16, 200),
    (2, 129, 16, 200),
    (2, 512, 16, 300),
    (3, 128, 16, 40),
    (2, 32, 8, 52),
    (2, 128, 16, 16),
    (2, 16, 32, 30),
    (2, 128, 16, 4096),
    (1, 64, 16, 8192),
    # deepseek-v3-671b's 128 heads at TP 2 and TP 4 (a rank's heads) at the
    # mla_paged decode shape
    (4, 64, 16, 1056),
    (4, 32, 16, 1056),
]


def _mla_setup(dev, B, H, r, dr, ps, L, seed=0, garbage=50.0):
    """Disjoint random latent chains over a pool whose other pages hold
    large garbage; one request's pos < L - 1."""
    rng = np.random.default_rng(seed)
    n_chain = -(-L // ps)
    P = 2 * B * n_chain
    bt = rng.permutation(P)[:B * n_chain].reshape(B, n_chain)
    pc = rng.standard_normal((P, ps, r)).astype(np.float32) * garbage
    pr = rng.standard_normal((P, ps, dr)).astype(np.float32) * garbage
    for b in range(B):
        for j in range(L):
            pc[bt[b, j // ps], j % ps] = rng.standard_normal(r)
            pr[bt[b, j // ps], j % ps] = rng.standard_normal(dr)
    qa = rng.standard_normal((B, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, H, dr)).astype(np.float32)
    pos = np.full(B, L - 1)
    pos[0] = L // 3
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(qa), t(qr), t(pc), t(pr), t(bt, torch.int32),
            t(pos, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_paged_mla_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref

    B, H, r, dr, ps, L = case
    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, *case, seed=ps)
    qa, qr, pc, pr = (t.to(dtype) for t in (qa, qr, pc, pr))
    scale = 1.0 / (r + dr) ** 0.5
    n0 = pa_ops.paged_mla_kernel.launches
    got = pa_ops.paged_mla_kernel(qa, qr, pc, pr, bt, pos, length=L,
                                  scale=scale)
    assert pa_ops.paged_mla_kernel.launches == n0 + 1
    want = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos, length=L,
                                scale=scale)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == qa.shape
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MLA_CASES, ids=str)
def test_paged_mla_q8_kernel_matches_plain(cuda, case, dtype):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq
    from repro_torch.kernels.paged_attention import ref as pa_ref

    B, H, r, dr, ps, L = case
    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, *case, seed=ps + 1)
    cs, rs = kvq.page_abs_scale(pc), kvq.page_abs_scale(pr)
    cc, rc = kvq.quantize(pc, cs), kvq.quantize(pr, rs)
    qa, qr = qa.to(dtype), qr.to(dtype)
    scale = 1.0 / (r + dr) ** 0.5
    n0 = pa_ops.paged_mla_q8_kernel.launches
    got = pa_ops.paged_mla_q8_kernel(qa, qr, cc, rc, cs, rs, bt, pos,
                                     length=L, scale=scale)
    assert pa_ops.paged_mla_q8_kernel.launches == n0 + 1
    want = pa_ref.paged_mla_ref(qa, qr, cc, rc, bt, pos, length=L,
                                scale=scale, ckv_scale=cs, krope_scale=rs)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-6
    else:
        assert _bf16_close(got, want)


@pytest.mark.cuda
def test_paged_mla_kernel_stale_pages_and_repeatable(cuda):
    """Foreign pages behind block-table entries past the live position do
    not matter, and two calls are bitwise equal."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, 3, 16, 64, 16, 4, 24, seed=5)
    short = pos.clamp(max=3)           # only chain entry 0 is live
    poison = bt.clone()
    poison[:, 1:] = (bt[:, 1:] + 1) % pc.shape[0]
    a = pa_ops.paged_mla_kernel(qa, qr, pc, pr, bt, short, length=24,
                                scale=0.1)
    b = pa_ops.paged_mla_kernel(qa, qr, pc, pr, poison, short, length=24,
                                scale=0.1)
    c = pa_ops.paged_mla_kernel(qa, qr, pc, pr, bt, short, length=24,
                                scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
@pytest.mark.parametrize("case", MLA_TC_CASES, ids=str)
def test_paged_mla_tc_route_matches_plain(cuda, case, q8):
    """Both kernels on the tc route (counted in launches_tc) within one
    bf16 ulp + 2e-6 of the plain version, two calls bitwise equal; one
    request of each case reads only up to pos = L // 3."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq
    from repro_torch.kernels.paged_attention import ref as pa_ref

    B, H, ps, L = case
    r, dr = 512, 64
    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, B, H, r, dr, ps, L,
                                         seed=ps + H + q8)
    qa, qr = qa.bfloat16(), qr.bfloat16()
    kw = dict(length=L, scale=1.0 / (r + dr) ** 0.5)
    if q8:
        cs, rs = kvq.page_abs_scale(pc), kvq.page_abs_scale(pr)
        pc, pr, sc = kvq.quantize(pc, cs), kvq.quantize(pr, rs), (cs, rs)
        sk = dict(ckv_scale=cs, krope_scale=rs)
        kern = pa_ops.paged_mla_q8_kernel
    else:
        pc, pr, sc, sk = pc.bfloat16(), pr.bfloat16(), (), {}
        kern = pa_ops.paged_mla_kernel
    n0, t0 = kern.launches, kern.launches_tc
    a = kern(qa, qr, pc, pr, *sc, bt, pos, **kw)
    b = kern(qa, qr, pc, pr, *sc, bt, pos, **kw)
    want = pa_ref.paged_mla_ref(qa, qr, pc, pr, bt, pos, **kw, **sk)
    torch.cuda.synchronize()
    assert kern.launches == n0 + 2 and kern.launches_tc == t0 + 2
    assert a.dtype == torch.bfloat16 and a.shape == qa.shape
    assert torch.equal(a, b)
    assert _bf16_close(a, want)


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
def test_paged_mla_tc_stale_pages_and_repeatable(cuda, q8):
    """The tc route (page 16, a stage of two pages) reads no page past a
    request's last live page: foreign pages behind the later block-table
    entries do not matter, and two calls are bitwise equal."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq

    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, 3, 128, 512, 64, 16, 96,
                                         seed=6)
    qa, qr = qa.bfloat16(), qr.bfloat16()
    if q8:
        cs, rs = kvq.page_abs_scale(pc), kvq.page_abs_scale(pr)
        pc, pr, sc = kvq.quantize(pc, cs), kvq.quantize(pr, rs), (cs, rs)
        kern = pa_ops.paged_mla_q8_kernel
    else:
        pc, pr, sc = pc.bfloat16(), pr.bfloat16(), ()
        kern = pa_ops.paged_mla_kernel
    assert pa_ops.mla_route(qa.dtype, pc.dtype, 512, 64, 16, True) == "tc"
    short = torch.tensor([16, 40, 47], dtype=torch.int32, device=cuda)
    poison = bt.clone()
    poison[0, 2:] = (bt[0, 2:] + 1) % pc.shape[0]   # live: pages 0-1
    poison[1:, 3:] = (bt[1:, 3:] + 1) % pc.shape[0]   # live: pages 0-2
    n0 = kern.launches_tc
    a = kern(qa, qr, pc, pr, *sc, bt, short, length=96, scale=0.05)
    b = kern(qa, qr, pc, pr, *sc, poison, short, length=96, scale=0.05)
    c = kern(qa, qr, pc, pr, *sc, bt, short, length=96, scale=0.05)
    torch.cuda.synchronize()
    assert kern.launches_tc == n0 + 3
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.cuda
def test_paged_mla_route_counts_tc_launches(cuda):
    """The path shape (bf16, H 128, r 512, dr 64, page 16) counts in
    launches_tc on both kernels; fp32 queries take the simt route and do
    not; neither route falls back to the other."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq

    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, 2, 128, 512, 64, 16, 64)
    cs, rs = kvq.page_abs_scale(pc), kvq.page_abs_scale(pr)
    cc, rc = kvq.quantize(pc, cs), kvq.quantize(pr, rs)
    kw = dict(length=64, scale=0.05)
    for kern, pools in ((pa_ops.paged_mla_kernel, None),
                        (pa_ops.paged_mla_q8_kernel, (cc, rc, cs, rs))):
        for dtype, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
            q = (qa.to(dtype), qr.to(dtype))
            args = pools or (pc.to(dtype), pr.to(dtype))
            n0, t0 = kern.launches, kern.launches_tc
            kern(*q, *args, bt, pos, **kw)
            assert kern.launches == n0 + 1
            assert kern.launches_tc == t0 + tc


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
def test_paged_mla_tc_build_spills_nothing(cuda, q8):
    """Each tc instantiation keeps its running sums in registers: no
    local (spill or stack) bytes, one CTA resident an SM; its dynamic
    shared memory is Q (64 heads x 576 bf16), three 32-row page stages as
    they land (int8: and two stages widened to bf16) and 1 KB of
    alignment slack."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    info = pa_ops.mla_kernel_info(q8)
    rows, k = pa_ops.MLA_TC_ROWS, sum(pa_ops.MLA_TC_RANKS)
    q_bytes, tile = pa_ops.MLA_TC_HEADS * k * 2, rows * k * 2
    smem = q_bytes + 3 * (rows * k if q8 else tile) + (2 * tile if q8 else 0)
    assert info["local_bytes"] == 0, info
    assert info["blocks_per_sm"] >= 1 and info["threads"] == 256, info
    assert info["smem_bytes"] == smem + 1024 <= 232448, info


@pytest.mark.cuda
def test_paged_mla_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import quant as kvq

    qa, qr, pc, pr, bt, pos = _mla_setup(cuda, 2, 8, 16, 8, 4, 12)
    kw = dict(length=12, scale=0.1)
    with pytest.raises(ValueError, match="different devices"):
        pa_ops.paged_mla_kernel(qa, qr, pc.cpu(), pr, bt, pos, **kw)
    with pytest.raises(ValueError, match="int32"):
        pa_ops.paged_mla_kernel(qa, qr, pc, pr, bt.long(), pos, **kw)
    with pytest.raises(ValueError, match="dtype"):
        pa_ops.paged_mla_kernel(qa, qr, pc.bfloat16(), pr.bfloat16(), bt,
                                pos, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        pa_ops.paged_mla_kernel(qa.transpose(0, 1).contiguous()
                                .transpose(0, 1), qr, pc, pr, bt, pos, **kw)
    cs = kvq.page_abs_scale(pc)
    cc = kvq.quantize(pc, cs)
    with pytest.raises(ValueError, match="int8"):
        pa_ops.paged_mla_q8_kernel(qa, qr, pc, pr, cs, cs, bt, pos, **kw)
    with pytest.raises(ValueError, match=r"scales must be \("):
        pa_ops.paged_mla_q8_kernel(qa, qr, cc, kvq.quantize(pr, cs), cs,
                                   cs[:-1], bt, pos, **kw)


@pytest.mark.cuda
def test_mla_lm_paged_decode_on_cuda_launches_mla_kernels(cuda):
    """A dense smoke MLA stack served from bf16 and int8 latent pages on
    the card: every decode step of every layer launches the paged MLA
    kernel of its pool dtype, and the kernel read's greedy tokens equal
    the gather read's."""
    import dataclasses

    from repro_torch.configs.archs import DEEPSEEK_V3_671B, reduced
    from repro_torch.configs.base import MLA, LayerSpec
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.models import build_model
    from repro_torch.serve import DecoderStepModel, PagedConfig, ServeEngine

    cfg = dataclasses.replace(reduced(DEEPSEEK_V3_671B), n_layers=2,
                              head_layers=(LayerSpec(MLA),) * 2)
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=p) for p in (5, 13, 9)]

    def serve(kv_dtype, impl):
        m = build_model(dataclasses.replace(cfg, kv_dtype=kv_dtype,
                                            paged_impl=impl), device=cuda)
        m.load_state_dict(model.state_dict())
        eng = ServeEngine(DecoderStepModel(
            m, max_len=64, prefill_chunk=8, kv_layout="paged",
            paged=PagedConfig(page_size=4)), slots=2)
        reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
        eng.run()
        return [list(r.tokens) for r in reqs], eng.n_steps

    for kv_dtype, kern in (("bf16", pa_ops.paged_mla_kernel),
                           ("int8", pa_ops.paged_mla_q8_kernel)):
        n0 = kern.launches
        got, steps = serve(kv_dtype, "kernel")
        assert kern.launches - n0 == cfg.n_layers * steps > 0
        want, _ = serve(kv_dtype, "gather")
        assert got == want


# ---------------------------------------------------------------------------
# the paper's IMC projection (Eq. 6)

IMC_CASES = [(1, 1, 1), (3, 5, 7), (17, 70, 50), (5, 300, 129),
             (128, 256, 384), (4096, 1024, 1024), (64, 1000, 10)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", IMC_CASES, ids=str)
def test_imc_mvm_kernel_matches_plain(cuda, case):
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.imc_mvm import ref as imc_ref

    M, K, N = case
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    x = (torch.rand(M, K, device=cuda, generator=g) > 0.5).float()
    codes = torch.randint(0, 4, (K, N), device=cuda, generator=g,
                          dtype=torch.int8)
    scale = torch.rand(N, device=cuda, generator=g) * 0.3 + 0.01
    n0 = imc_ops.imc_mvm_kernel.launches
    got = imc_ops.imc_mvm_kernel(x, codes, scale)
    assert imc_ops.imc_mvm_kernel.launches == n0 + 1
    want = imc_ref.imc_mvm_ref(x, codes, scale)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and got.dtype == torch.float32
    assert bool(((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    # Eq. 6: all-ones x gives the column mean of the levels times Δ, x = 0
    # gives exactly 0
    ones = imc_ops.imc_mvm_kernel(torch.ones_like(x), codes, scale)
    mean = ((codes.float() - 1.5) * scale).mean(0)
    assert bool(((ones - mean).abs() <= 1e-6).all())
    zero = imc_ops.imc_mvm_kernel(torch.zeros_like(x), codes, scale)
    torch.cuda.synchronize()
    assert float(zero.abs().max()) == 0.0


@pytest.mark.cuda
def test_imc_mvm_entry_point_on_cuda(cuda):
    from repro_torch.kernels.imc_mvm import ops as imc_ops

    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.rand(3, 4, 30, device=cuda, generator=g) > 0.5).float()
    codes = torch.randint(0, 4, (30, 20), device=cuda, generator=g,
                          dtype=torch.int8)
    n0 = imc_ops.imc_mvm_kernel.launches
    got = imc_ops.imc_mvm(x, codes, 0.2)
    want = imc_ops.imc_mvm(x, codes, 0.2, backend="plain")
    torch.cuda.synchronize()
    assert imc_ops.imc_mvm_kernel.launches == n0 + 1
    assert got.shape == (3, 4, 20)
    assert bool(((got - want).abs() <= 1e-5).all())
    with pytest.raises(ValueError, match="different devices"):
        imc_ops.imc_mvm_kernel(x[0], codes.cpu(), torch.ones(20, device=cuda))
    with pytest.raises(ValueError, match="int8"):
        imc_ops.imc_mvm_kernel(x[0], codes.long(), torch.ones(20, device=cuda))


def _imc_case(dev, M, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.rand(M, K, device=dev, generator=g) > 0.5).float()
    codes = torch.randint(0, 4, (K, N), device=dev, generator=g,
                          dtype=torch.int8)
    scale = torch.rand(N, device=dev, generator=g) * 0.3 + 0.01
    return x, codes, scale


def _imc_simt(x, codes, scale):
    """The simt entry point of csrc/imc_mvm.cu, called directly: it takes
    any shape and alignment."""
    from repro_torch.kernels import build

    (M, K), N = x.shape, codes.shape[1]
    out = torch.empty(M, N, device=x.device)
    build.check(build.load("imc_mvm").imc_mvm_f32(
        x.data_ptr(), codes.data_ptr(), scale.data_ptr(), out.data_ptr(),
        M, K, N, torch.cuda.current_stream().cuda_stream), "imc_mvm")
    return out


#: aligned shapes (the tc route) with partial tiles in M, N and K
IMC_TC_CASES = [(4096, 1024, 1024), (4100, 1024, 1040), (130, 64, 48),
                (1, 4, 16), (257, 36, 272)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", IMC_TC_CASES, ids=str)
def test_imc_mvm_tc_route_equals_simt_bitwise(cuda, case):
    """The tc route (bf16 wgmma) equals the simt route (fp32 FMAs) bit for
    bit on binary x, and both lie within the reference's 1e-5 of the plain
    version; all-zero x gives +0 on both."""
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.imc_mvm import ref as imc_ref

    M, K, N = case
    x, codes, scale = _imc_case(cuda, M, K, N, M + K + N)
    assert imc_ops.route(M, K, N, x.data_ptr(), codes.data_ptr()) == "tc"
    kern = imc_ops.imc_mvm_kernel
    n0, t0 = kern.launches, kern.launches_tc
    tc = kern(x, codes, scale)
    simt = _imc_simt(x, codes, scale)
    assert (kern.launches, kern.launches_tc) == (n0 + 1, t0 + 1)
    want = imc_ref.imc_mvm_ref(x, codes, scale)
    torch.cuda.synchronize()
    assert torch.equal(tc.view(torch.int32), simt.view(torch.int32))
    assert bool(((tc - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    zero = [f(torch.zeros_like(x), codes, scale)
            for f in (imc_ops.imc_mvm_kernel, _imc_simt)]
    torch.cuda.synchronize()
    assert torch.equal(zero[0].view(torch.int32), zero[1].view(torch.int32))
    assert float(zero[0].abs().max()) == 0.0


@pytest.mark.cuda
def test_imc_mvm_route_rule_and_counters_on_card(cuda):
    """The wrapper takes ops.route's route: simt for a ragged shape or a
    misaligned operand, tc otherwise; only tc launches count in
    launches_tc."""
    from repro_torch.kernels.imc_mvm import ops as imc_ops

    x, codes, scale = _imc_case(cuda, 64, 32, 48, 5)
    t0 = imc_ops.imc_mvm_kernel.launches_tc
    imc_ops.imc_mvm_kernel(x, codes, scale)
    assert imc_ops.imc_mvm_kernel.launches_tc == t0 + 1
    # x starting 4 bytes into its storage: not 16-byte aligned
    xs = torch.empty(64 * 32 + 1, device=cuda)[1:].view(64, 32)
    xs.copy_(x)
    assert imc_ops.route(64, 32, 48, xs.data_ptr(), codes.data_ptr()) \
        == "simt"
    got = imc_ops.imc_mvm_kernel(xs, codes, scale)
    assert imc_ops.imc_mvm_kernel.launches_tc == t0 + 1
    want = imc_ops.imc_mvm_kernel(x, codes, scale)   # tc: bitwise as simt
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # a ragged shape: simt, counted in launches only
    xr, cr, sr = _imc_case(cuda, 17, 70, 50, 6)
    n0 = imc_ops.imc_mvm_kernel.launches
    imc_ops.imc_mvm_kernel(xr, cr, sr)
    assert imc_ops.imc_mvm_kernel.launches == n0 + 1
    assert imc_ops.imc_mvm_kernel.launches_tc == t0 + 2


@pytest.mark.cuda
def test_imc_mvm_tc_route_rounds_non_binary_x_to_bf16(cuda):
    """x outside {0, 1} is outside the op's domain: the tc route rounds it
    to bf16 before the exact product (within 1e-5 + 1e-5 rel of the plain
    version on bf16-rounded x), the simt route keeps fp32."""
    from repro_torch.kernels.imc_mvm import ops as imc_ops
    from repro_torch.kernels.imc_mvm import ref as imc_ref

    _x, codes, scale = _imc_case(cuda, 256, 128, 256, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.rand(256, 128, device=cuda, generator=g)
    tc = imc_ops.imc_mvm_kernel(x, codes, scale)
    simt = _imc_simt(x, codes, scale)
    want_bf16 = imc_ref.imc_mvm_ref(x.bfloat16().float(), codes, scale)
    want = imc_ref.imc_mvm_ref(x, codes, scale)
    torch.cuda.synchronize()
    assert bool(((tc - want_bf16).abs()
                 <= 1e-5 + 1e-5 * want_bf16.abs()).all())
    assert bool(((simt - want).abs() <= 1e-5 + 1e-5 * want.abs()).all())
    assert not torch.equal(tc, simt)


def _step_case(dev, B, K, N, seed, binary=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand(B, K, device=dev, generator=g)
    if binary:
        x = (x > 0.5).float()
    ch = torch.randint(0, 4, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    cz = torch.randint(0, 4, (K, N), device=dev, generator=g,
                       dtype=torch.int8)
    bh = torch.randn(N, device=dev, generator=g) * 0.5
    bz = torch.randn(N, device=dev, generator=g) * 0.5
    hp = torch.randn(B, N, device=dev, generator=g)
    return x, ch, cz, 0.11 / max(1, K // 64), bh, bz, hp


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(8, 64, 64), (64, 1024, 1024),
                                   (3, 17, 130), (9, 70, 10)])
def test_minimalist_step_kernel_analog_x_matches_plain(cuda, B, K, N):
    """Analog x (a first layer fed unbinarised frames): the split-K order
    keeps h within 2e-5 of the plain version and the gate codes equal
    away from a code step."""
    x, ch, cz, scale, bh, bz, hp = _step_case(cuda, B, K, N, B + K,
                                              binary=False)
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
def test_minimalist_step_five_layer_chain_in_a_cuda_graph(cuda):
    """The stream path's chain of layers (paper dims 1-64-64-64-64-10, 8
    slots) captured in one CUDA graph equals the same chain launched eagerly and
    the plain chain, bit for bit on binary frames."""
    dims = (1, 64, 64, 64, 64, 10)
    layers, hs = [], []
    for i, (K, N) in enumerate(zip(dims[:-1], dims[1:])):
        x0, ch, cz, _s, bh, bz, hp = _step_case(cuda, 8, K, N, 20 + i)
        layers.append((ch, cz, 0.11, bh, bz))
        hs.append(hp)
        if i == 0:
            x = x0

    def chain(step):
        out, new = x, []
        for i, layer in enumerate(layers):
            y, h = step(out, *layer, hs[i])
            new.append(h)
            out = h if i == len(layers) - 1 else y
        return [out] + new

    eager = chain(mb_ops.minimalist_step_kernel)
    plain = chain(mb_ref.minimalist_step_ref)
    n0 = mb_ops.minimalist_step_kernel.launches
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        chain(mb_ops.minimalist_step_kernel)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = chain(mb_ops.minimalist_step_kernel)
    graph.replay()
    torch.cuda.synchronize()
    assert mb_ops.minimalist_step_kernel.launches == n0 + 10
    for a, b, c in zip(captured, eager, plain):
        assert torch.equal(a, b)
        assert torch.equal(a, c)


# ---------------------------------------------------------------------------
# the rest of serving on the card: preemption on the kernel read, spec
# decoding with an all-accepting drafter, Mamba serving fused vs xla, the
# fused forward's carry, and the MLA simt route against fp64 sums


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSM_CASES, ids=str)
def test_fused_ssm_fwd_kernel_carry_matches_plain(cuda, case):
    """From a state h0, with the final state written out: y, the entry
    states and h_last within the forward's 2e-5 of the plain version, and
    two chained halves equal to one pass within the same bound."""
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.fused_ssm import ref as ssm_ref

    dt, x, Bm, Cm, A, _ = _ssm_inputs(cuda, *case, seed=5)
    B, T, di = x.shape
    n = A.shape[1]
    g = torch.Generator(device=cuda).manual_seed(6)
    h0 = torch.randn(B, di, n, device=cuda, generator=g)
    h_last, want_last = (torch.empty_like(h0) for _ in range(2))
    y, entries = ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A, h0=h0,
                                              h_last=h_last)
    want, want_entries = ssm_ref.fused_ssm_fwd_ref(
        dt, x, Bm, Cm, A, ssm_ops.CHUNK, h0=h0, h_last=want_last)
    torch.cuda.synchronize()
    _ssm_check(y, want, 2e-5, 2e-5)
    _ssm_check(entries, want_entries, 2e-5, 2e-5)
    _ssm_check(h_last, want_last, 2e-5, 2e-5)
    if T > 1:
        c = T // 2
        mid, end = torch.empty_like(h0), torch.empty_like(h0)
        parts = [(dt, x, Bm, Cm)[i][:, a:b].contiguous() for a, b in
                 ((0, c), (c, T)) for i in range(4)]
        y1, _ = ssm_ops.fused_ssm_fwd_kernel(*parts[:4], A, h0=h0,
                                             h_last=mid)
        y2, _ = ssm_ops.fused_ssm_fwd_kernel(*parts[4:], A, h0=mid,
                                             h_last=end)
        torch.cuda.synchronize()
        _ssm_check(torch.cat([y1, y2], 1), y, 2e-5, 2e-5)
        _ssm_check(end, h_last, 2e-5, 2e-5)
    with pytest.raises(ValueError, match="carry"):
        ssm_ops.fused_ssm_fwd_kernel(dt, x, Bm, Cm, A,
                                     h0=h0[:, :, :-1].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("q8", [False, True], ids=["pages", "int8"])
def test_paged_mla_simt_f32_within_fp64_sums(cuda, q8):
    """chip_smoke's MLA inputs at deepseek-v3's scale (kv_lora 512, rope
    64, page 16, softmax scale 1/sqrt(192)), path and odd rows, fp32
    queries (the simt route): within 2e-6 of the function evaluated in
    fp64 from the same operands."""
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    from repro_torch.launch.mla_shapes import MLA_SHAPES, mla_inputs

    g = torch.Generator(device=cuda).manual_seed(0)
    kern = pa_ops.paged_mla_q8_kernel if q8 else pa_ops.paged_mla_kernel
    for _label, B, H, length, pos in MLA_SHAPES[:2]:
        qa, qr, pc, pr, sc, bt, pos_t = mla_inputs(cuda, g, B, H, length,
                                                   pos, q8)
        qa, qr = qa.float(), qr.float()
        if not q8:
            pc, pr = pc.float(), pr.float()
        kw = dict(length=length, scale=1.0 / (128 + 64) ** 0.5)
        n0, tc0 = kern.launches, kern.launches_tc
        got = kern(qa, qr, pc, pr, *sc, bt, pos_t, **kw)
        assert (kern.launches - n0, kern.launches_tc - tc0) == (1, 0)
        want = pa_ref.paged_mla_ref(
            qa, qr, pc, pr, bt, pos_t, acc=torch.float64, **kw,
            **dict(zip(("ckv_scale", "krope_scale"), sc)))
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 2e-6


def _smollm_sharp(cuda, **cfg_kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("smollm-360m-smoke"), **cfg_kw)
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    with torch.no_grad():
        for layer in model.layers:
            layer.mixer.wo.mul_(4.0)
            layer.mlp.w_down.mul_(4.0)
    return model


def _paged_engine(model, slots=2, **kw):
    from repro_torch.serve import DecoderStepModel, PagedConfig, ServeEngine

    return ServeEngine(DecoderStepModel(
        model, max_len=64, prefill_chunk=8, kv_layout="paged",
        paged=PagedConfig(page_size=4)), slots=slots, **kw)


SERVE_LENS = [(7, 12), (13, 9), (5, 14), (9, 10)]


def _serve_streams(eng, disturb=None):
    from repro_torch.configs import SamplingParams

    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, eng.sm.vocab, p), max_new_tokens=g,
                       sampling=None if i % 2 == 0 else SamplingParams(
                           temperature=0.8, top_k=9, seed=5))
            for i, (p, g) in enumerate(SERVE_LENS)]
    if disturb is not None:
        disturb(eng)
    eng.run()
    assert eng.pool.pages_in_use == 0 and eng.pool.reserved_total == 0
    return [list(map(int, r.tokens)) for r in reqs]


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_preempt_resume_bitwise_on_the_kernel_read(cuda, kv_dtype):
    """Every active slot evicted mid-stream and resumed into other slots
    and fresh pages, decoding through paged_gqa / paged_gqa_q8: greedy and
    sampled streams bitwise the undisturbed run's (the kernels give a
    request the same bits whatever its slot and batch)."""
    from repro_torch.kernels.paged_attention import ops as pa_ops

    model = _smollm_sharp(cuda, kv_dtype=kv_dtype)
    kern = pa_ops.paged_gqa_q8_kernel if kv_dtype == "int8" \
        else pa_ops.paged_gqa_kernel
    ref = _serve_streams(_paged_engine(model, slots=3))

    def disturb(eng):
        for _ in range(3):
            eng.step()
        for s in np.flatnonzero(eng.active):
            eng._preempt(int(s))
    n0 = kern.launches
    eng = _paged_engine(model, slots=3)
    got = _serve_streams(eng, disturb)
    assert kern.launches > n0 and eng.n_preemptions >= 2
    assert got == ref


def _oracle_drafter(*args, **kw):
    """chip_smoke.py's drafter double (it proposes known streams)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import OracleDrafter

    return OracleDrafter(torch, *args, **kw)


@pytest.mark.cuda
def test_spec_all_accepting_drafter_bitwise_on_the_gather_read(cuda):
    """Greedy spec waves at k 4 with a drafter that proposes the
    target-only streams: every draft accepted, streams bitwise."""
    from repro_torch.configs import get_config

    model = _smollm_sharp(cuda, paged_impl="gather")
    lens = [(7, 12), (13, 9), (5, 14), (9, 10)]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, model.cfg.vocab, p) for p, _g in lens]

    def run(drafter=None):
        kw = {} if drafter is None else dict(drafter=drafter, spec_k=4)
        eng = _paged_engine(model, slots=2, **kw)
        if drafter is not None:
            drafter.eng = eng
        reqs = [eng.submit(p, max_new_tokens=g)
                for p, (_p, g) in zip(prompts, lens)]
        eng.run()
        return [list(map(int, r.tokens)) for r in reqs], eng

    ref, _ = run()
    got, eng = run(_oracle_drafter(4, get_config("smollm-360m-smoke").vocab,
                                   dict(enumerate(ref))))
    assert got == ref
    assert eng.n_drafts_accepted == eng.n_drafts_proposed > 0


@pytest.mark.cuda
def test_mamba_serve_fused_against_xla(cuda):
    """falcon-mamba-7b at full width cut to 2 layers, served dense: the
    fused run's prefill launches fused_ssm_fwd (never linear_scan), the
    xla run's linear_scan, once a chunk and layer; greedy tokens equal
    up to the first top-2 margin <= 0.1 of the xla model."""
    import dataclasses

    from repro_torch.configs import ServeConfig, get_config
    from repro_torch.kernels.fused_ssm import ops as ssm_ops
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.launch.serve import build_engine
    from repro_torch.models import build_model

    base = dataclasses.replace(get_config("falcon-mamba-7b"), n_layers=2)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, base.vocab, p) for p in (70, 300)]
    out = {}
    for impl in ("fused", "xla"):
        cfg = dataclasses.replace(base, ssm_impl=impl)
        model = build_model(cfg, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(0))
        eng = build_engine(model, ServeConfig(slots=2, max_len=320,
                                              prefill_chunk=128))
        f0 = ssm_ops.fused_ssm_fwd_kernel.launches
        s0 = scan_ops.linear_scan_kernel.launches
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run()
        launched = (ssm_ops.fused_ssm_fwd_kernel.launches - f0,
                    scan_ops.linear_scan_kernel.launches - s0)
        n = eng.sm.n_prefill_chunks * cfg.n_layers
        assert launched == ((n, 0) if impl == "fused" else (0, n))
        out[impl] = ([r.tokens for r in reqs], eng.sm)
    sm = out["xla"][1]
    for prompt, a, b in zip(prompts, out["fused"][0], out["xla"][0]):
        diff = np.flatnonzero(a != b)
        if len(diff):
            ctx = np.concatenate([prompt, b[:diff[0]]])[None]
            last, _ = sm.prefill(ctx)
            top2 = torch.topk(last[0, :base.vocab].float(), 2).values
            assert (top2[0] - top2[1]).item() <= 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch,route", [
    ("pooled", "train"), ("per_request", "prefill"), ("auto", "prefill"),
    ("auto", "decode")])
def test_moe_mlp_on_cuda_matches_its_cpu_run(cuda, dispatch, route):
    """MoEMLP (fp32, drops at capacity 0.5 on the pooled path, a shared
    expert) on the card against its own CPU run on the same weights and
    inputs: expert routing and dropped_frac equal, outputs within the
    reference's bounds (atol 1e-5, rtol 1e-4); no host sync is needed
    for it (the dispatch selects with a spare row, not a boolean mask)."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import MoEMLP

    moe = MoEConfig(n_experts=16, top_k=4, d_ff_expert=64, n_shared=1,
                    capacity_factor=0.5, dispatch=dispatch)
    cpu = MoEMLP(128, moe)
    torch.manual_seed(0)
    cpu.reset_parameters()
    dev = MoEMLP(128, moe, device=cuda)
    dev.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 1 if route == "decode" else 40, 128)
    with torch.no_grad():
        want, wa = cpu(x, route=route)
        got, ga = dev(x.to(cuda), route=route)
        _g, ids, _p = dev._route(x.reshape(-1, 128).to(cuda))
        _g, wids, _p = cpu._route(x.reshape(-1, 128))
    assert torch.equal(ids.cpu(), wids)
    assert ga["dropped_frac"].item() == wa["dropped_frac"].item()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_mesh_1x1_nccl_paged_streams_bitwise(cuda, kv_dtype, tmp_path):
    """A world-1 NCCL group and a 1x1 DeviceMesh on the card: the paged
    engine (output projections x4) serves from bf16 pages through
    paged_gqa and from int8 pages through paged_gqa_q8, greedy and
    sampled streams bitwise the no-mesh engine's."""
    import torch.distributed as dist

    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.launch.mesh import make_local_mesh

    kern = pa_ops.paged_gqa_q8_kernel if kv_dtype == "int8" \
        else pa_ops.paged_gqa_kernel
    ref = _serve_streams(_paged_engine(_smollm_sharp(cuda,
                                                     kv_dtype=kv_dtype)))
    torch.cuda.set_device(cuda.index or 0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(model=1, data=1, device="cuda")
        n0 = kern.launches
        eng = _paged_engine(_smollm_sharp(cuda, kv_dtype=kv_dtype),
                            mesh=mesh)
        got = _serve_streams(eng)
        assert kern.launches > n0
        assert eng.mesh is mesh
    finally:
        dist.destroy_process_group()
    assert got == ref


@pytest.mark.cuda
def test_remat_modes_bitwise_and_full_lower_peak(cuda):
    """remat none / full / dots_saveable on the card through flash:
    smollm-360m-smoke at 8 x 1024, the loss and every gradient bitwise
    equal across modes (recomputation reruns the same kernels on the same
    inputs), and full's peak below none's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import REMAT_MODES

    cfg = dataclasses.replace(get_config("smollm-360m-smoke"),
                              attention_impl="flash")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(8, 1024))).to(cuda)
    out = {}
    for remat in REMAT_MODES:
        m = build_model(cfg, device=cuda, remat=remat,
                        generator=torch.Generator(device=cuda).manual_seed(0))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        loss, _ = m.loss({"tokens": tok, "labels": tok})
        loss.backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(cuda) - base
        out[remat] = (loss.detach(), [p.grad for p in m.parameters()], peak)
        del m, loss
    for remat in ("full", "dots_saveable"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[remat][1], out["none"][1]))
    assert out["full"][2] < out["none"][2]


@pytest.mark.cuda
def test_dryrun_prediction_holds_on_the_card(cuda):
    """The dry-run's meta pass runs on the card's machine (no JAX) and
    predicts smollm-360m's dense decode cell at batch 4 x 544 on a 1x1
    mesh: the parameter bytes exactly, and the measured peak of one
    decode step (parameters, cache and temporaries) within 5 %."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ShapeMesh
    from repro_torch.models import build_model

    cfg = get_config("smollm-360m")
    pred = dryrun.lower_cell("smollm-360m", "decode_32k",
                             ShapeMesh(("data", "model"), (1, 1)),
                             batch_override=4, seq_override=544)
    mem = pred["memory_analysis"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    model = build_model(cfg, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(0))
    n_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert n_bytes == mem["argument_parts"]["params"]
    step = dryrun.build_serve_step(model)
    with torch.no_grad():
        cache = model.init_cache(4, 544)
        tok = torch.zeros(4, 1, dtype=torch.int32, device=cuda)
        pos = torch.full((4,), 543, dtype=torch.int32, device=cuda)
        nxt, cache = step(cache, tok, pos)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda) - base
    want = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert nxt.shape == (4,)
    assert abs(peak / want - 1) <= 0.05, (peak, want)
