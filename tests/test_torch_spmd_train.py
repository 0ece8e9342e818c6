"""The SPMD train step and the elastic re-mesh on gloo ranks (the
reference's ``tests/test_sharding.py`` subprocess test, on the port), on
``qwen3-moe-30b-a3b-smoke`` at data 2 x model 2.

Parameters are DTensors placed by ``param_specs`` (``parallel.spmd.bind``)
and the batch by ``batch_specs``; ``DecoderLM.loss`` scores each rank's
rows, ``spmd.sync_grads`` sums the gradients over "data", and ``AdamW``
steps the shards with ZeRO-1 moments (``opt_state_specs(zero1=True)``).
Then: the first loss against the no-mesh loss, two steps lowering it,
``elastic_restart`` losing 2 of the 4 ranks (plan data 1, model 2,
accumulation 2) and a step on the new mesh, and a checkpoint saved on
2 x 2 restored onto 1 x 2 bitwise.  The ranks run as subprocesses
(``test_torch_serve_sharded.run_ranks``)."""
import numpy as np

from test_torch_serve_sharded import run_ranks

PROLOGUE = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ckpt_dir = sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world),
                        rank=rank, world_size=world)

from repro_torch.checkpoint import Checkpointer
from repro_torch.common.pytree import flatten_dict, module_tree
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW, param_groups
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import spmd
from repro_torch.train.elastic import elastic_restart
OUT = {}
'''


def test_spmd_train_step_elastic_remesh_and_resharding_restore(tmp_path):
    res = run_ranks(tmp_path, 4, r'''
    cfg = get_config("qwen3-moe-30b-a3b-smoke")

    def fresh():
        return build_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))

    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)))
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        loss_ref = float(fresh().loss(batch)[0])

    mesh = make_local_mesh(model=2, data=2, device="cpu")
    model = fresh()
    b = spmd.bind(model, mesh)
    zspec = shd.opt_state_specs(b.specs, module_tree(model), mesh,
                                zero1=True)
    opt = AdamW(param_groups(model), lr=1e-3)
    names = dict(model.named_parameters())
    opt.place_moments(names, {".".join(k): v for k, v in
                              flatten_dict(zspec["m"]).items()})

    def put(batch, mesh):
        return shd.distribute_tree(batch, shd.batch_specs(batch, mesh),
                                   mesh)

    def step(model, opt, batch):
        opt.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch)
        loss.backward()
        spmd.sync_grads(model)
        opt.step()
        return float(loss)

    loss1 = step(model, opt, put(batch, mesh))
    loss2 = step(model, opt, put(batch, mesh))
    OUT.update(loss_ref=loss_ref, loss1=loss1, loss2=loss2)
    OUT["sharded"] = sorted(
        n for n, p in names.items()
        if p.to_local().numel() < p.numel())
    m = opt.state[names["layers.0.mlp.w_gate"]]["m"]
    OUT["zero1_m"] = [str(pl) for pl in m.placements]
    OUT["zero1_m_local"] = list(m.to_local().shape)

    # a checkpoint of the 2x2 parameters (every rank saves; rank 0 writes)
    saved = {n: p.full_tensor().clone() for n, p in names.items()}
    ck = Checkpointer(ckpt_dir)
    ck.save(2, {"params": module_tree(model)})

    # lose 2 of the 4 ranks: TP kept, DP shrinks, accumulation doubles
    st = opt.state_tree(names)
    unflat = lambda d: {tuple(k.split(".")): v for k, v in d.items()}
    from repro_torch.common.pytree import unflatten_dict
    opt_state = {"m": unflatten_dict(unflat(st["m"])),
                 "v": unflatten_dict(unflat(st["v"])), "step": st["step"]}
    new_mesh, params2, opt2, plan = elastic_restart(
        model, module_tree(model), opt_state, lost_devices=2, mesh=mesh)
    OUT["plan"] = [plan.new_data, plan.new_model, plan.accum_multiplier]
    if new_mesh.get_coordinate() is not None:
        spmd.bind(model, new_mesh, placed=params2)
        opt_b = AdamW(param_groups(model), lr=1e-3)
        names2 = dict(model.named_parameters())
        opt_b.load_state_tree(
            {"m": {".".join(k): v for k, v in
                   flatten_dict(opt2["m"]).items()},
             "v": {".".join(k): v for k, v in
                   flatten_dict(opt2["v"]).items()},
             "step": opt2["step"]}, names2)
        OUT["loss3"] = step(model, opt_b, put(batch, new_mesh))
        # the 2x2 checkpoint restored onto the 1x2 mesh
        specs = shd.param_specs(model, module_tree(model), new_mesh)
        got = ck.restore(2, shardings={"params": shd.named_sharding_tree(
            specs, new_mesh)})["params"]
        flat = flatten_dict(got)
        OUT["restore_bitwise"] = all(
            torch.equal(flat[tuple(n.split("."))].full_tensor(), saved[n])
            for n in names)
        OUT["restore_sharded"] = any(
            flat[tuple(n.split("."))].to_local().numel() < saved[n].numel()
            for n in names)
    ''', str(tmp_path / "ckpt"), prologue=PROLOGUE)
    r = res[0]
    assert np.isfinite([r["loss1"], r["loss2"], r["loss3"]]).all()
    assert abs(r["loss1"] - r["loss_ref"]) <= 1e-5 * abs(r["loss_ref"])
    assert r["loss2"] < r["loss1"]
    assert all(x["loss1"] == r["loss1"] for x in res)
    # vocab, heads, KV heads, MLP hidden and experts shard over model
    assert "embed.table" in r["sharded"]
    assert any(n.endswith("mlp.w_gate") for n in r["sharded"])
    assert any(n.endswith("mixer.wq") for n in r["sharded"])
    # ZeRO-1: the expert moment shards over data on top of model
    assert r["zero1_m"] == ["S(1)", "S(0)"]
    assert r["plan"] == [1, 2, 2]
    assert r["restore_bitwise"] and r["restore_sharded"]
    assert res[1]["restore_bitwise"] and "loss3" not in res[2]
