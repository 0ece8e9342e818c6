"""PyTorch port vs the JAX reference: the LM's training loss and
gradients (models.transformer.DecoderLM.loss).

The loss and one step's gradients are held to ``jax.value_and_grad`` of
the reference's ``DecoderLM(cfg, scan_layers=False).loss`` run eagerly,
on the same parameters and tokens (ROADMAP queue 3: the scanned or
jitted reference keeps bf16 intermediates in fp32, which flips Θ outputs
of the hardware LM): loss within 2e-2 and every gradient tensor with
cosine > 0.99 and relative L2 error < 5e-2 (bf16 compute)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.transformer import DecoderLM as JLM
from repro_torch.bridge import load_jax_params
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.models import build_model

torch.set_num_threads(1)

ARCH = "minimalist-lm-360m-smoke"


def _batch(vocab, seq=16, B=4, step=0):
    return SyntheticLMDataset(vocab=vocab, seq_len=seq).sample(B, step)


def _tensors(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


@pytest.mark.parametrize("arch", [ARCH, "minimalist-lm-360m-hw-smoke"])
def test_lm_loss_and_grads_match_reference(arch):
    jcfg = jget(arch)
    jm = JLM(jcfg, scan_layers=False)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch), device="cpu")
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    b = _batch(jcfg.vocab, seq=32)
    b["labels"][0, :5] = -1                     # masked labels
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, met = tm.loss(_tensors(b))
    loss.backward()
    assert abs(loss.item() - float(jl)) < 2e-2
    assert int(met["tokens"]) == int(jmet["tokens"]) == 4 * 32 - 5
    want = build_model(get_config(arch), device="cpu")
    load_jax_params(want, jax.tree_util.tree_map(
        lambda g: np.asarray(g, np.float32), jg))
    for (name, p), (_, q) in zip(tm.named_parameters(),
                                 want.named_parameters()):
        a, w = p.grad.double().flatten(), q.detach().double().flatten()
        cos = float(a @ w / (a.norm() * w.norm()))
        rel = float((a - w).norm() / w.norm())
        assert cos > 0.99 and rel < 5e-2, (name, cos, rel)
