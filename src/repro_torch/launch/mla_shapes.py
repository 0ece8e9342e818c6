"""The paged MLA kernel rows' shapes and inputs, shared by ``chip_smoke.py``'s
kernel phase and :mod:`repro_torch.launch.profile`'s ``mla`` section."""
from __future__ import annotations

import torch

#: (label, B, H, length, pos) of the paged MLA kernel rows (kv_lora 512,
#: rope 64, page 16): the mla_paged phase's decode shape (4 slots,
#: deepseek-v3-671b's 128 heads, cache 1056), an odd one (20 heads, a
#: partial last page, one request with pos < length - 1) and a long
#: context (32 slots x 4096 positions, all full: the pages exceed the
#: 50 MB L2)
MLA_SHAPES = [
    ("path", 4, 128, 1056, [1055] * 4),
    ("odd", 3, 20, 100, [99, 37, 99]),
    ("long", 32, 128, 4096, [4095] * 32),
]


def mla_inputs(dev, g, B, H, length, pos, q8, ps=16, r=512, dr=64):
    """Inputs of one paged MLA decode read: random disjoint latent chains
    in a pool twice the chains' size (the rest holds other tenants'
    pages), bf16 queries and pages (``q8``: int8 codes with per-page
    scales) -> (q_abs, q_rope, pool_ckv, pool_krope, scales, block tables,
    pos); scales is () for bf16 pages, (ckv_scale, krope_scale) for int8."""
    n = -(-length // ps)
    num_pages = 2 * B * n
    perm = torch.randperm(num_pages, device=dev, generator=g)
    bt = perm[:B * n].reshape(B, n).to(torch.int32).contiguous()
    bf = torch.bfloat16
    qa = torch.randn(B, H, r, device=dev, generator=g).to(bf)
    qr = torch.randn(B, H, dr, device=dev, generator=g).to(bf)
    pc = torch.randn(num_pages, ps, r, device=dev, generator=g)
    pr = torch.randn(num_pages, ps, dr, device=dev, generator=g)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    if not q8:
        return qa, qr, pc.to(bf), pr.to(bf), (), bt, pos
    from repro_torch.kernels.paged_attention import quant as kvq
    cs, rs = kvq.page_abs_scale(pc), kvq.page_abs_scale(pr)
    return qa, qr, kvq.quantize(pc, cs), kvq.quantize(pr, rs), (cs, rs), \
        bt, pos
