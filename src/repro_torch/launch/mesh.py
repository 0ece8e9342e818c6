"""Mesh construction (port of ``repro.launch.mesh``).

Functions only: importing this module opens no process group and touches
no device.  :func:`make_local_mesh` builds a ("data", "model")
``DeviceMesh`` over the process group the caller has already opened —
one rank a device: gloo ranks with ``device="cpu"``, NCCL ranks with one
card each on ``cuda``.  :func:`make_production_mesh` gives the production
layouts (16 x 16 and 2 x 16 x 16) as a :class:`ShapeMesh`: axis names and
sizes only, which the rule tables (``parallel.sharding``) and
:func:`mesh_info` read as they read a ``DeviceMesh``; the dry-run
(``launch.dryrun``) places nothing on it.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh as the rule tables see it: dimension names and sizes, no
    devices and no ranks (``DeviceMesh``'s ``mesh_dim_names`` and
    ``shape``)."""

    mesh_dim_names: tuple
    shape: tuple

    def __post_init__(self):
        if len(self.mesh_dim_names) != len(self.shape) or any(
                int(n) < 1 for n in self.shape):
            raise ValueError(f"mesh axes {self.mesh_dim_names} need one "
                             f"size >= 1 each, got {self.shape}")

    @property
    def size(self) -> int:
        return int(math.prod(self.shape))


def make_production_mesh(*, multi_pod: bool = False) -> ShapeMesh:
    """16 x 16 single-pod (256 devices) or 2 x 16 x 16 two-pod (512
    devices) mesh, shape only."""
    if multi_pod:
        return ShapeMesh(("pod", "data", "model"), (2, 16, 16))
    return ShapeMesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1, data: int = 1, *, device="cuda",
                    ranks=None):
    """A (data, model) ``DeviceMesh`` over the first ``data * model``
    ranks of the current process group (or over ``ranks``).

    Raises the reference's ValueErrors when an axis is below 1 or when
    the mesh needs more ranks than the world has — or, on ``cuda`` under
    NCCL, more cards than this host shows (NCCL takes one card a rank;
    gloo ranks on ``cuda`` may share a card)."""
    if model < 1 or data < 1:
        raise ValueError(f"mesh axes must be >= 1, got data={data} "
                         f"model={model}")
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    device_type = torch.device(device).type
    need = model * data
    if not dist.is_initialized():
        raise RuntimeError(
            "make_local_mesh needs an open process group: call "
            "torch.distributed.init_process_group first (the serve "
            "launcher starts and joins its ranks itself)")
    if device_type == "cuda" and dist.get_backend() == "nccl":
        n_cards = torch.cuda.device_count()
        if need > n_cards:
            raise ValueError(
                f"mesh data={data} x model={model} needs {need} devices but "
                f"only {n_cards} are available (one card a rank)")
    n = dist.get_world_size()
    if need > n:
        raise ValueError(
            f"mesh data={data} x model={model} needs {need} devices but "
            f"only {n} are available (start {need} ranks)")
    ids = np.asarray(list(ranks) if ranks is not None else range(need))
    return DeviceMesh(device_type, torch.as_tensor(
        ids[:need].reshape(data, model)), mesh_dim_names=("data", "model"))


def mesh_info(mesh) -> dict:
    """Axis sizes plus the derived DP / TP degrees.  Meshes without a
    "pod" axis get pod=1 folded into ``dp``."""
    from repro_torch.parallel.sharding import mesh_shape

    axes = mesh_shape(mesh)
    return {"axes": axes,
            "n_devices": int(math.prod(axes.values())),
            "dp": int(axes.get("pod", 1)) * int(axes.get("data", 1)),
            "tp": int(axes.get("model", 1))}
