"""Tensor parallelism of Mamba, MLA and Whisper's cross attention, and
``remat`` on a bound model, on gloo ranks against the port's no-mesh
path (the reference shards these layers through GSPMD: Mamba
``d_inner``, MLA and cross-attention heads).

Each check spawns its ranks (``test_torch_serve_sharded.run_ranks``) and
builds every model on every rank from one seed.  The contract:

  * greedy streams on the mesh are the no-mesh engine's bit for bit:
    falcon-mamba-7b-smoke at TP 2 x DP 2 and TP 4 (xla and fused scans,
    d_inner 128 -> 64 / 32), jamba's paged hybrid stack at TP 2 x DP 2,
    deepseek-v3-smoke at TP 2 x DP 2 and TP 4 from bf16 and int8 latent
    pages, and whisper-small-smoke's greedy decode at TP 2;
  * one training step on a TP-only mesh: the loss is the no-mesh loss
    within 1e-6 relative, and every gradient within 1e-5 relative L2
    where the arithmetic after the sums over "model" stays in fp32
    (Mamba's fused scan), 1e-4 where the compute dtype (bf16) rounds the
    fp32-reassociated sums (a rare one-ulp flip moves a few entries; the
    largest seen is 4e-5), and 1e-3 for Mamba's xla path, whose scan
    runs in bf16 on the fp32-summed B, C and dt (8e-4 seen);
  * a rank's regrouped ``w_in`` halves (``Spmd.halves``) are the no-mesh
    product's columns bit for bit;
  * ``remat`` none, full and dots_saveable give bitwise equal losses and
    gradients at TP 2 x DP 2 (smollm-360m-smoke, falcon-mamba-7b-smoke).
"""
import textwrap

from test_torch_serve_sharded import run_ranks

HELPERS = r'''
from repro_torch.parallel import sharding as shd


def put(batch, mesh):
    return shd.distribute_tree(batch, shd.batch_specs(batch, mesh), mesh)


def lm_batch(vocab, seed=1, B=4, S=16):
    t = torch.as_tensor(np.random.default_rng(seed).integers(0, vocab,
                                                             (B, S + 1)))
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def grads_of(model, batch, mesh=None):
    """(loss, {name: whole fp32 gradient}) of one backward."""
    if mesh is not None:
        spmd.bind(model, mesh)
        batch = put(batch, mesh)
    loss, _ = model.loss(batch)
    loss.backward()
    spmd.sync_grads(model)
    out = {}
    for n, p in model.named_parameters():
        g = p.grad
        out[n] = (g.full_tensor() if spmd.is_dtensor(g) else g).double()
    return float(loss), out


def train_close(name, build, batch, mesh, grad_tol=1e-4):
    """One step's loss (1e-6 relative) and every gradient (``grad_tol``
    relative L2) on ``mesh`` against no mesh."""
    ref_l, ref_g = grads_of(build(), batch)
    got_l, got_g = grads_of(build(), batch, mesh)
    rel = {n: float((got_g[n] - w).norm() / w.norm().clamp(min=1e-30))
           for n, w in ref_g.items()}
    worst = max(rel, key=rel.get)
    OUT[name + "/loss_rel"] = abs(got_l - ref_l) / abs(ref_l)
    OUT[name + "/grad_rel"] = [worst, rel[worst]]
    OUT[name] = OUT[name + "/loss_rel"] <= 1e-6 and rel[worst] <= grad_tol


def tp_pairs():
    """A 1 x 2 mesh over ranks (0, 1) and one over (2, 3): this rank's."""
    a = make_local_mesh(model=2, data=1, device="cpu", ranks=[0, 1])
    b = make_local_mesh(model=2, data=1, device="cpu", ranks=[2, 3])
    return a if rank < 2 else b
'''


def _run(tmp_path, world, body):
    return run_ranks(tmp_path, world, HELPERS + textwrap.dedent(body))


def _check(res, keys):
    for r in res:
        for k in keys:
            assert r[k] is True, (k, {q: v for q, v in r.items()
                                      if q.startswith(k)})


def test_mamba_tp2_tp4_streams_regroup_and_train_step(tmp_path):
    res = _run(tmp_path, 4, r'''
    ARCH = "falcon-mamba-7b-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    m14 = make_local_mesh(model=4, data=1, device="cpu")
    for impl in ("xla", "fused"):
        eng = bitwise(f"greedy_2x2_{impl}", ARCH, m22, sharpen=False,
                      ssm_impl=impl)
        bitwise(f"greedy_1x4_{impl}", ARCH, m14, sharpen=False,
                ssm_impl=impl)
    mix = eng.sm.model.layers[0].mixer
    OUT["w_in_local"] = list(mix.w_in.to_local().shape)
    OUT["ssm_state_local"] = list(eng.state[0]["ssm"].shape)
    OUT["ssm_state_spec"] = list(eng.sm.sharding.state[0]["ssm"])

    # the regrouped halves against the no-mesh product's columns
    x = torch.randn(3, 5, 64, generator=torch.Generator().manual_seed(4))
    for tag, mesh in (("2x2", m22), ("1x4", m14)):
        for dt in (torch.float32, torch.bfloat16):
            model = model_for(ARCH, False)
            blk = model.layers[0].mixer
            want = blk._in(x.to(dt))
            spmd.bind(model, mesh)
            with spmd.local_view(model) as s:
                got = blk._in(x.to(dt))
                n = 128 // s.tp
                cut = slice(s.tp_rank * n, (s.tp_rank + 1) * n)
            OUT[f"regroup_{tag}_{str(dt)[6:]}"] = all(
                torch.equal(g, w[..., cut]) for g, w in zip(got, want))

    batch = lm_batch(512)
    m12 = tp_pairs()
    for impl, tol in (("xla", 1e-3), ("fused", 1e-5)):
        build = lambda: model_for(ARCH, False, ssm_impl=impl)  # noqa
        train_close(f"train_1x2_{impl}", build, batch, m12, tol)
        train_close(f"train_1x4_{impl}", build, batch, m14, tol)
    ''')
    _check(res, ["greedy_2x2_xla", "greedy_1x4_xla", "greedy_2x2_fused",
                 "greedy_1x4_fused", "regroup_2x2_float32",
                 "regroup_2x2_bfloat16", "regroup_1x4_float32",
                 "regroup_1x4_bfloat16", "train_1x2_xla", "train_1x4_xla",
                 "train_1x2_fused", "train_1x4_fused"])
    r = res[0]
    assert r["greedy_2x2_xla/distinct"] > 3
    # d_inner 128 over model 2: w_in (64, 2 x 128) holds 128 columns; the
    # carries shard d_inner over "model" and the 4 slots over "data"
    assert r["w_in_local"] == [64, 128]
    assert r["ssm_state_local"] == [2, 64, 4]
    assert r["ssm_state_spec"] == ["data", "model", None]


def test_mla_tp2_tp4_bf16_int8_pages_and_train_step(tmp_path):
    res = _run(tmp_path, 4, r'''
    ARCH = "deepseek-v3-671b-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    m14 = make_local_mesh(model=4, data=1, device="cpu")
    for tag, mesh in (("2x2", m22), ("1x4", m14)):
        eng = bitwise(f"greedy_{tag}_bf16", ARCH, mesh, layout="paged")
        bitwise(f"greedy_{tag}_int8", ARCH, mesh, layout="paged",
                kv_dtype="int8")
        mix = eng.sm.model.layers[0].mixer
        OUT[f"w_uq_local_{tag}"] = list(mix.w_uq.to_local().shape)
        OUT[f"w_dq_local_{tag}"] = list(mix.w_dq.to_local().shape)
        OUT[f"pool_spec_{tag}"] = list(eng.sm.sharding.state[0]["ckv"])
    bitwise("greedy_2x2_dense", ARCH, m22)
    batch = lm_batch(512)
    build = lambda: model_for(ARCH, False)  # noqa
    train_close("train_1x2", build, batch, tp_pairs())
    train_close("train_1x4", build, batch, m14)
    ''')
    _check(res, ["greedy_2x2_bf16", "greedy_2x2_int8", "greedy_1x4_bf16",
                 "greedy_1x4_int8", "greedy_2x2_dense", "train_1x2",
                 "train_1x4"])
    r = res[0]
    assert r["greedy_2x2_bf16/distinct"] > 8
    # 4 heads over model 2 and 4; the latent projection and pools whole
    assert r["w_uq_local_2x2"] == [32, 2, 24]
    assert r["w_uq_local_1x4"] == [32, 1, 24]
    assert r["w_dq_local_1x4"] == [64, 32]
    assert r["pool_spec_2x2"] == [None, None, None]


def test_jamba_paged_hybrid_tp2(tmp_path):
    res = _run(tmp_path, 4, r'''
    ARCH = "jamba-1.5-large-398b-smoke"
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    eng = bitwise("greedy_2x2_paged", ARCH, m22, layout="paged")
    bitwise("greedy_2x2_dense", ARCH, m22)
    mamba = next(l.mixer for l in eng.sm.model.layers
                 if hasattr(l.mixer, "w_in"))
    OUT["w_out_local"] = list(mamba.w_out.to_local().shape)
    ''')
    _check(res, ["greedy_2x2_paged", "greedy_2x2_dense"])
    assert res[0]["greedy_2x2_paged/distinct"] > 8
    assert res[0]["w_out_local"] == [64, 64]


def test_whisper_cross_attention_tp2_decode_and_train_step(tmp_path):
    res = _run(tmp_path, 2, r'''
    ARCH = "whisper-small-smoke"
    m12 = make_local_mesh(model=2, data=1, device="cpu")
    cfg = get_config(ARCH)
    g = torch.Generator().manual_seed(2)
    frames = 0.5 * torch.randn(4, cfg.frontend_seq, cfg.d_model, generator=g)
    start = torch.randint(0, cfg.vocab, (4, 1), generator=g)

    def build(sharpen=4.0):
        m = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            for layer in m.dec:
                for mod in (layer.self_attn, layer.cross):
                    mod.wo.mul_(sharpen)
                layer.mlp.w_down.mul_(sharpen)
        return m

    def decode(model, n=10):
        with torch.inference_mode():
            cache = model.init_cache(4, n, frame_embeds=frames)
            tok, toks = start, []
            for t in range(n):
                lg, cache = model.decode_step(tok, cache, t)
                tok = lg[:, :, :cfg.vocab].argmax(-1)
                toks.append(tok)
        return torch.cat(toks, 1), cache

    ref, _ = decode(build())
    model = build()
    spmd.bind(model, m12)
    got, cache = decode(model)
    OUT["greedy_1x2"] = torch.equal(got, ref)
    OUT["greedy_1x2/distinct"] = len(set(ref.flatten().tolist()))
    OUT["xk_local"] = list(cache[0]["xk"].shape)
    OUT["cross_wq_local"] = list(model.dec[0].cross.wq.to_local().shape)
    # the training step on the seeded init (as the other layers' checks)
    batch = dict(lm_batch(cfg.vocab), embeds=frames)
    train_close("train_1x2", lambda: build(1.0), batch, m12)
    ''')
    _check(res, ["greedy_1x2", "train_1x2"])
    r = res[0]
    assert r["greedy_1x2/distinct"] > 3
    # 4 heads over model 2: the cross K/V cache holds this rank's 2
    assert r["xk_local"] == [4, 12, 2, 16]
    assert r["cross_wq_local"] == [64, 2, 16]


def test_remat_modes_bitwise_on_a_tp2_dp2_mesh(tmp_path):
    res = _run(tmp_path, 4, r'''
    m22 = make_local_mesh(model=2, data=2, device="cpu")
    for arch in ("smollm-360m-smoke", "falcon-mamba-7b-smoke"):
        cfg = get_config(arch)
        batch = lm_batch(cfg.vocab, seed=3)
        runs = {}
        for remat in ("none", "full", "dots_saveable"):
            model = build_model(cfg, device="cpu", remat=remat,
                                generator=torch.Generator().manual_seed(0))
            runs[remat] = grads_of(model, batch, m22)
        (l0, g0) = runs["none"]
        for remat in ("full", "dots_saveable"):
            l, g = runs[remat]
            OUT[f"{arch}/{remat}"] = l == l0 and all(
                torch.equal(g[n], g0[n]) for n in g0)
    ''')
    _check(res, [f"{a}/{m}" for a in ("smollm-360m-smoke",
                                      "falcon-mamba-7b-smoke")
                 for m in ("full", "dots_saveable")])
