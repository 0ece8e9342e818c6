"""Elastic scaling: re-mesh and reshard a running job's state (port of
``repro.train.elastic``).

When ranks are lost, the survivors build a smaller mesh and re-lay-out
the parameters and optimizer state onto it:

  * the "model" axis is kept (the TP degree is bound to the architecture);
  * the "data" (x "pod") product shrinks to the largest size the
    surviving ranks hold — DP is the elastic axis;
  * the global batch is kept by raising gradient accumulation on the
    survivors (tokens a step unchanged, so loss curves stay comparable).

State is a tree of DTensors placed by ``parallel.sharding``;
:func:`reshard_tree` gathers each leaf on the old mesh and distributes it
onto the new one (``Checkpointer.restore(shardings=...)`` takes the same
path across restarts).  The survivors are the first ranks of the world.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.common.pytree import tree_map2
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass
class ElasticPlan:
    new_data: int
    new_model: int
    accum_multiplier: int


def plan_remesh(n_devices_left: int, model_size: int,
                old_data: int) -> ElasticPlan:
    """Largest DP degree that fits the surviving devices (TP kept)."""
    assert n_devices_left >= model_size, "cannot keep TP degree"
    new_data = n_devices_left // model_size
    # keep the global batch: accumulate more on the fewer replicas
    mult = -(-old_data // new_data)
    return ElasticPlan(new_data=new_data, new_model=model_size,
                       accum_multiplier=mult)


def make_elastic_mesh(plan: ElasticPlan, device="cpu", ranks=None):
    """("data", "model") mesh of the plan over the first
    ``new_data * new_model`` ranks (or ``ranks``).  Every rank of the world
    calls it (sub-groups are created collectively); a rank outside the new
    mesh gets ``get_coordinate() is None``."""
    from repro_torch.launch.mesh import make_local_mesh

    return make_local_mesh(model=plan.new_model, data=plan.new_data,
                           device=device, ranks=ranks)


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def reshard_tree(tree, spec_tree, new_mesh):
    """Every leaf onto ``new_mesh`` per ``spec_tree``: gathered whole on
    its old mesh (all old ranks take part), then distributed on the new
    one.  Ranks outside the new mesh get None leaves."""
    from torch.distributed.tensor import DTensor

    def move(t, spec):
        full = t.full_tensor() if isinstance(t, DTensor) else t
        if not in_mesh(new_mesh):
            return None
        return shd.distribute(full, shd.NamedSharding(new_mesh, spec))

    return tree_map2(move, tree, spec_tree)


def elastic_restart(model, params, opt_state, *, lost_devices: int, mesh,
                    rules=None):
    """Lose ``lost_devices`` ranks of ``mesh`` and re-lay-out the state.

    ``params``: the model's tree of DTensors
    (``pytree.module_tree(model)``); ``opt_state``: {"m", "v", "step"}
    with m and v trees like ``params``.  Returns (new_mesh, params,
    opt_state, plan): m and v take the parameters' new placements, as in
    the reference."""
    info = shd.mesh_shape(mesh)
    model_size = info.get("model", 1)
    old_data = info.get("data", 1) * info.get("pod", 1)
    n_left = int(math.prod(info.values())) - lost_devices
    plan = plan_remesh(n_left, model_size, old_data)
    new_mesh = make_elastic_mesh(plan, device=mesh.device_type)
    p_spec = shd.param_specs(model, params, new_mesh, rules)
    params = reshard_tree(params, p_spec, new_mesh)
    opt_state = {"m": reshard_tree(opt_state["m"], p_spec, new_mesh),
                 "v": reshard_tree(opt_state["v"], p_spec, new_mesh),
                 "step": opt_state["step"]}
    return new_mesh, params, opt_state, plan
