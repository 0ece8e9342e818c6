"""PyTorch port vs the JAX reference: the LM's training loss and
gradients at head dims above 128, through flash attention.

Two-layer narrow stacks (smollm-360m-smoke's widths) at stablelm-12b's
head dim 160 (global causal attention) and gemma3-4b's 256 (sliding
window layers), both with ``attention_impl="flash"``: the loss and one
step's gradients held to ``jax.value_and_grad`` of the reference's
``DecoderLM(cfg, scan_layers=False).loss`` run eagerly, whose flash path
is its Pallas kernels in interpret mode (the port's, on the CPU, the
plain versions of its CUDA kernels), on the same parameters and tokens.
Bounds are tests/test_torch_lm_grads.py's: loss within 2e-2, every
gradient tensor with cosine > 0.99 and relative L2 error < 5e-2 (bf16
compute)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import base, get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "smollm-360m-smoke"


def _configs(head_dim, local):
    """The reference's and the port's two-layer flash stacks at
    ``head_dim``; ``local``: every layer a sliding window of 8."""
    out = []
    for pkg, get in ((jbase, jget), (base, get_config)):
        kw = dict(head_dim=head_dim, n_layers=2, attention_impl="flash")
        if local:
            kw.update(pattern=(pkg.LayerSpec(pkg.ATTN_LOCAL),),
                      sliding_window=8)
        out.append(dataclasses.replace(get(ARCH), **kw))
    return out


@pytest.mark.parametrize("head_dim,local", [(160, False), (256, True)],
                         ids=["d160-causal", "d256-window"])
def test_wide_head_lm_loss_and_grads_match_reference(head_dim, local):
    jcfg, cfg = _configs(head_dim, local)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg, device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    b = SyntheticLMDataset(vocab=jcfg.vocab, seq_len=32).sample(4, 0)
    b["labels"][0, :5] = -1                     # masked labels
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, met = tm.loss({k: torch.from_numpy(v).long()
                         for k, v in b.items()})
    loss.backward()
    assert abs(loss.item() - float(jl)) < 2e-2
    assert int(met["tokens"]) == int(jmet["tokens"]) == 4 * 32 - 5
    want = build_model(cfg, device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        a, w = p.grad.double().flatten(), q.detach().double().flatten()
        cos = float(a @ w / (a.norm() * w.norm()))
        rel = float((a - w).norm() / w.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)
