"""PyTorch port vs the JAX reference: the architecture table and the
archs the port added last (stablelm-12b, mistral-large-123b,
llava-next-34b with its patch-embedding prefix, whisper-small and the
100M minGRU LMs).

The port's ``ARCHS`` equals the reference's field by field for all 14
names and their smoke variants; the two fields that name a backend
(``scan_backend``, ``paged_impl``) carry the port's names for the
reference's defaults.  Every smoke arch builds in the port.  For each new
arch the smoke loss, the logits and one decode step match the
reference's eager model (``scan_layers=False``) at the repo's bf16 bound
atol = rtol = 5e-2 (tests/test_torch_lm.py), on the batch of
tests/test_archs_smoke.py: B 2, S 16, and for the VLM and audio archs
0.1 x normal stub embeddings in bf16."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as jarchs
from repro.models import build_model as jbuild
from repro_torch.bridge import load_jax_params
from repro_torch.configs import archs
from repro_torch.configs import get_config
from repro_torch.models import build_model

torch.set_num_threads(1)

TOL = dict(atol=5e-2, rtol=5e-2)
NEW = ["stablelm-12b", "mistral-large-123b", "llava-next-34b",
       "whisper-small", "minimalist-lm-100m", "minimalist-lm-100m-hw"]
# the port's names of the reference's default backends
BACKENDS = {"scan_backend": ("xla", "kernel"),
            "paged_impl": ("pallas", "kernel")}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    return {k: v for k, v in d.items() if k not in BACKENDS}, \
        {k: d[k] for k in BACKENDS}


def test_arch_tables_have_the_reference_names():
    assert list(archs.ARCHS) == list(jarchs.ARCHS)
    assert archs.ASSIGNED == jarchs.ASSIGNED


@pytest.mark.parametrize("name", list(jarchs.ARCHS))
def test_arch_equals_reference_field_by_field(name):
    for n in (name, name + "-smoke"):
        cfg, want = get_config(n), jarchs.get_config(n)
        got, got_backends = _fields(cfg)
        ref, ref_backends = _fields(want)
        assert got == ref, n
        assert got_backends == {k: BACKENDS[k][1] for k in BACKENDS}
        assert ref_backends == {k: BACKENDS[k][0] for k in BACKENDS}
        assert cfg.param_count() == want.param_count()
        assert cfg.active_param_count() == want.active_param_count()


@pytest.mark.parametrize("name", list(jarchs.ARCHS))
def test_every_smoke_arch_builds(name):
    cfg = get_config(name + "-smoke")
    model = build_model(cfg, device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n > 0 and model.device == torch.device("cpu")


def _batch(cfg, B=2, S=16):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S))
    b = {"tokens": toks, "labels": toks.copy()}
    if cfg.arch_type in ("vlm", "audio"):
        x = 0.1 * rng.standard_normal((B, cfg.frontend_seq, cfg.d_model))
        b["embeds"] = np.array(jnp.asarray(x, jnp.bfloat16)
                               .astype(jnp.float32))
    return b


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", NEW)
def test_new_arch_loss_logits_and_decode_step_match_reference(name):
    jcfg = jarchs.get_config(name + "-smoke")
    jm = jbuild(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(name + "-smoke"), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    b = _batch(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v) if v.dtype.kind == "f"
          else torch.from_numpy(v).long() for k, v in b.items()}
    emb = tb.get("embeds")
    with torch.no_grad():
        loss, _ = tm.loss(tb)
        logits = tm(tb["tokens"], embeds=emb)
        kw, jkw = {}, {}
        if jcfg.arch_type == "audio":
            kw, jkw = dict(frame_embeds=emb), dict(
                params=jp, frame_embeds=jb["embeds"])
        cache = tm.init_cache(2, 32, **kw)
        step, _ = tm.decode_step(tb["tokens"][:, :1], cache, 0)
    jl, _ = jm.loss(jp, jb)
    np.testing.assert_allclose(loss.item(), float(jl), **TOL)
    want = _np(jm(jp, jb["tokens"], embeds=jb.get("embeds")))
    if jcfg.arch_type == "vlm":      # the prefix's positions come first
        assert want.shape[1] == jcfg.frontend_seq + 16
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), want, **TOL)
    jc = jm.init_cache(2, 32, **jkw)
    jstep, _ = jm.decode_step(jp, jb["tokens"][:, :1], jc, jnp.int32(0))
    np.testing.assert_allclose(step.numpy(), _np(jstep), **TOL)


def test_vlm_prefix_logits_are_dropped_from_the_loss():
    """llava's loss reads only the token positions: the same loss as the
    NLL of the last S logits of the prefixed forward, and a prefix-only
    call (no tokens) gives the prefix's logits."""
    cfg = get_config("llava-next-34b-smoke")
    tm = build_model(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    b = _batch(cfg)
    emb = torch.from_numpy(b["embeds"])
    toks = torch.from_numpy(b["tokens"]).long()
    with torch.no_grad():
        loss, _ = tm.loss({"tokens": toks, "labels": toks, "embeds": emb})
        full = tm(toks, embeds=emb)
        prefix = tm(embeds=emb)
    tail = full[:, -toks.shape[1]:]
    nll = torch.logsumexp(tail, -1) - torch.gather(tail, -1,
                                                   toks[..., None])[..., 0]
    assert torch.allclose(loss, nll.mean(), atol=1e-6, rtol=1e-6)
    assert prefix.shape == (2, cfg.frontend_seq, cfg.vocab_padded)
    # causal: the prefix's logits do not see the tokens after it
    torch.testing.assert_close(prefix, full[:, :cfg.frontend_seq],
                               atol=0.0, rtol=0.0)
