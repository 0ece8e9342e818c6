"""PyTorch port vs the JAX reference: the Whisper encoder-decoder
(models.whisper.EncDecLM) at whisper-small-smoke.

The reference runs eagerly with ``scan_layers=False`` (XLA keeps bf16
intermediates in fp32 inside a scanned body).  Bounds: the encoder's
output, the logits, the loss and the cached decode's logits at the
repo's bf16 bound atol = rtol = 5e-2 (tests/test_torch_lm.py); one
step's gradients at the train-step bounds, every tensor with cosine >
0.99 and relative L2 < 5e-2 (tests/test_torch_lm_grads.py); the cached
decode teacher-forced against the full forward at 2e-2
(tests/test_archs_smoke.py).  The decoder's self-attention runs naive
and flash in both packages (the reference's flash path is its Pallas
kernels in interpret mode; the port's the plain versions of its CUDA
kernels)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.whisper import EncDecLM as JEncDec
from repro_torch.bridge import load_jax_params, reference_ndim
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model
from repro_torch.models.whisper import EncDecLM

torch.set_num_threads(1)

ARCH = "whisper-small-smoke"
TOL = dict(atol=5e-2, rtol=5e-2)


def _pair(seed=0, **kw):
    jcfg = dataclasses.replace(jget(ARCH), **kw)
    jm = JEncDec(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(dataclasses.replace(get_config(ARCH), **kw),
                     device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    return jcfg, jm, jp, tm


def _frames(cfg, B, seed=0):
    """Stub frame embeddings, 0.1 x a seeded normal, rounded to bf16 (the
    dtype the reference's input_specs give them)."""
    rng = np.random.default_rng(seed)
    x = 0.1 * rng.standard_normal((B, cfg.frontend_seq, cfg.d_model))
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _batch(cfg, B=2, S=16, seed=0):
    b = SyntheticLMDataset(vocab=cfg.vocab, seq_len=S).sample(B, seed)
    b["embeds"] = _frames(cfg, B, seed)
    return b


def _jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _torch(b):
    return {k: torch.from_numpy(v) if v.dtype.kind == "f"
            else torch.from_numpy(v).long() for k, v in b.items()}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_build_model_builds_encdec_with_reference_layout():
    cfg = get_config(ARCH)
    m = build_model(cfg, device="cpu")
    assert isinstance(m, EncDecLM)
    assert (len(m.enc), len(m.dec)) == (cfg.n_enc_layers, cfg.n_layers)
    # the reference stacks every encoder and decoder leaf: all decayed
    ndim = reference_ndim(m)
    assert ndim["dec.0.n1.scale"] == 2 and ndim["enc.1.mlp.w_up"] == 3
    assert ndim["final_norm.scale"] == 1 and ndim["embed.table"] == 2


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_encode_forward_and_loss_match_reference(impl):
    jcfg, jm, jp, tm = _pair(seed=1, attention_impl=impl)
    b = _batch(jcfg, seed=1)
    b["labels"][0, :4] = -1                      # masked labels
    jb, tb = _jax(b), _torch(b)
    with torch.no_grad():
        mem = tm.encode(tb["embeds"])
        assert torch.equal(tm(embeds=tb["embeds"]), mem)   # encoder only
        logits = tm(tb["tokens"], embeds=tb["embeds"])
        loss, _ = tm.loss(tb)
    np.testing.assert_allclose(mem.float().numpy(),
                               _np(jm.encode(jp, jb["embeds"])), **TOL)
    want = _np(jm(jp, jb["tokens"], embeds=jb["embeds"]))
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    jl, _ = jm.loss(jp, jb)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_loss_and_grads_match_jax_grad(impl):
    jcfg, jm, jp, tm = _pair(seed=2, attention_impl=impl)
    b = _batch(jcfg, seed=2)
    (jl, _), jg = jax.value_and_grad(jm.loss, has_aux=True)(jp, _jax(b))
    loss, _ = tm.loss(_torch(b))
    loss.backward()
    assert abs(loss.item() - float(jl)) < 2e-2
    for name, p in tm.named_parameters():
        keys = name.replace("self_attn.", "self.").split(".")
        node, idx = jg, None
        if keys[0] in ("enc", "dec"):
            node, idx, keys = jg[keys[0]], int(keys[1]), keys[2:]
        for k in keys:
            node = node[k]
        want = np.asarray(node if idx is None else node[idx], np.float64)
        a = p.grad.double().flatten()
        w = torch.from_numpy(want).flatten()
        cos = float(a @ w / (a.norm() * w.norm()))
        rel = float((a - w).norm() / w.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)


def test_cached_decode_matches_reference():
    """init_cache(frame_embeds=...) computes each decoder layer's cross
    K/V from the encoder's output once; decode_step's logits then match
    the reference's over several positions."""
    jcfg, jm, jp, tm = _pair(seed=3)
    B, S = 2, 6
    frames = _frames(jcfg, B, seed=3)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (B, S))
    jc = jm.init_cache(B, 8, params=jp, frame_embeds=jnp.asarray(frames))
    with torch.no_grad():
        tc = tm.init_cache(B, 8, frame_embeds=torch.from_numpy(frames))
        for j, entry in enumerate(tc):
            assert entry["xk"].dtype == torch.bfloat16
            np.testing.assert_allclose(entry["xk"].float().numpy(),
                                       _np(jc["dec"]["xk"][j]), **TOL)
            np.testing.assert_allclose(entry["xv"].float().numpy(),
                                       _np(jc["dec"]["xv"][j]), **TOL)
        for t in range(S):
            jl, jc = jm.decode_step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                                    jnp.int32(t))
            tl, tc = tm.decode_step(torch.from_numpy(toks[:, t:t + 1]), tc,
                                    t)
            np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_cached_decode_teacher_forced_matches_full_forward():
    """Step-by-step decode against the cross K/V cache equals the full
    forward's logits (the reference's test_decode_matches_forward_causal,
    through the encoder-decoder)."""
    cfg = get_config(ARCH)
    tm = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(4))
    B, S = 2, 10
    frames = torch.from_numpy(_frames(cfg, B, seed=4))
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab, (B, S)))
    with torch.no_grad():
        full = tm(toks, embeds=frames)
        cache = tm.init_cache(B, S + 1, frame_embeds=frames)
        outs = []
        for t in range(S):
            lg, cache = tm.decode_step(toks[:, t:t + 1], cache, t)
            outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=2e-2, rtol=2e-2)


def test_zero_cache_without_frames_has_reference_shapes():
    jcfg, jm, jp, tm = _pair()
    jc = jm.init_cache(3, 7)
    tc = tm.init_cache(3, 7)
    assert len(tc) == jcfg.n_layers
    for j, entry in enumerate(tc):
        for key in ("xk", "xv"):
            assert tuple(entry[key].shape) == jc["dec"][key].shape[1:]
            assert not entry[key].any()
        for key in ("k", "v"):
            assert tuple(entry["self"][key].shape) == \
                jc["dec"]["self"][key].shape[1:]
