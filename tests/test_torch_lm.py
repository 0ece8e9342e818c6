"""PyTorch port vs the JAX reference: the minGRU decoder LM
(minimalist-lm-360m-smoke and its hardware-mode twin -hw-smoke).

The reference is built with ``scan_layers=False`` and run eagerly, so
every op rounds to its own dtype as the port's ops do: inside a fused
``lax.scan`` body XLA keeps bf16 intermediates in fp32, and in the
hardware model a one-ulp move is enough to flip a Θ output.  Tolerance:
the repo's own bf16 bound (atol = rtol = 5e-2, test_serve_prefill.py:66);
greedy argmax must agree wherever the reference's top-2 margin > 0.1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import DecoderStepModel, chunked_prefill

torch.set_num_threads(1)

ARCHS = ["minimalist-lm-360m-smoke", "minimalist-lm-360m-hw-smoke"]
TOL = dict(atol=5e-2, rtol=5e-2)


def _pair(arch, seed=0, scan_layers=False):
    jcfg = jget(arch)
    jm = JLM(jcfg, scan_layers=scan_layers)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _argmax_agrees(got, want):
    """Greedy choice equal wherever the reference's margin > 0.1."""
    srt = np.sort(want, axis=-1)
    margin = srt[..., -1] - srt[..., -2]
    differ = got.argmax(-1) != want.argmax(-1)
    assert not (differ & (margin > 0.1)).any()


def _jax_chunked_prefill(jm, jp, toks, chunk):
    """The reference's grid-padded chunk loop (serve.prefill), eager."""
    B, P = toks.shape
    cache = jm.init_cache(B, 64)
    padded = np.pad(toks, ((0, 0), (0, (-P) % chunk)))
    last = None
    for s in range(0, padded.shape[1], chunk):
        last, cache = jm.prefill(jp, jnp.asarray(padded[:, s:s + chunk]),
                                 cache, s, length=min(P - s, chunk))
    return np.asarray(last[:, -1], np.float32), cache


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_logits_and_carry(arch):
    jcfg, jm, jp, tm = _pair(arch, seed=1)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, size=(2, 13))
    want, jcache = _jax_chunked_prefill(jm, jp, toks, chunk=8)
    sm = DecoderStepModel(tm, max_len=64, prefill_chunk=8)
    with torch.inference_mode():
        got, cache = chunked_prefill(sm, toks, chunk=8)
    assert got.dtype == torch.float32 and cache.dtype == torch.bfloat16
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    _argmax_agrees(got.numpy()[:, :jcfg.vocab], want[:, :jcfg.vocab])
    assert sm.n_prefill_chunks == 2
    for j in range(jcfg.n_layers):
        np.testing.assert_allclose(
            cache[j].float().numpy(),
            np.asarray(jcache[f"unit0_r{j}"]["h"], np.float32), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_logits(arch):
    jcfg, jm, jp, tm = _pair(arch, seed=2)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, size=(2, 12))
    jc, tc = jm.init_cache(2, 32), tm.init_cache(2)
    for t in range(toks.shape[1]):
        jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                jnp.int32(t))
        with torch.inference_mode():
            tl, tc = tm.decode_step(torch.as_tensor(toks[:, t:t + 1]), tc)
        want = np.asarray(jl, np.float32)[:, 0]
        np.testing.assert_allclose(tl.numpy()[:, 0], want, **TOL)
        _argmax_agrees(tl.numpy()[:, 0, :jcfg.vocab], want[:, :jcfg.vocab])


@pytest.mark.parametrize("arch", ARCHS)
def test_full_sequence_forward(arch):
    jcfg, jm, jp, tm = _pair(arch, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, size=(2, 10))
    want = np.asarray(jm(jp, jnp.asarray(toks)), np.float32)
    with torch.inference_mode():
        got = tm(torch.as_tensor(toks))
    assert got.shape == (2, 10, jcfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_bridge_unstacks_the_scanned_layer_axis():
    """The reference's default (scanned) tree stacks each unit layer's
    params on a leading axis; layer j of the port gets slice j."""
    jcfg, _jm, jp, tm = _pair(ARCHS[0], seed=4, scan_layers=True)
    assert jp["unit0"]["mixer"]["wh"].shape[0] == jcfg.n_layers
    for j, layer in enumerate(tm.layers):
        np.testing.assert_array_equal(
            layer.mixer.block.wz.detach().numpy(),
            np.asarray(jp["unit0"]["mixer"]["wz"][j]))
        np.testing.assert_array_equal(
            layer.mlp.w_down.detach().numpy(),
            np.asarray(jp["unit0"]["mlp"]["w_down"][j]))
    np.testing.assert_array_equal(tm.embed.table.detach().numpy(),
                                  np.asarray(jp["embed"]["table"]))


def test_seeded_port_init_is_reproducible_and_shaped_like_reference():
    cfg = get_config(ARCHS[0])
    a = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    b = build_model(cfg, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    for (na, pa), (_nb, pb) in zip(a.named_parameters(),
                                   b.named_parameters()):
        assert torch.equal(pa, pb), na
    w = a.layers[0].mixer.block.wh.detach()
    assert w.abs().max() <= 2.0 / np.sqrt(cfg.d_model) + 1e-6   # 2σ cut
    assert torch.equal(a.layers[0].mixer.block.bz.detach(),
                       torch.full((cfg.d_model,), -1.0))
