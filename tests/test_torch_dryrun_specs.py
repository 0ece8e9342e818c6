"""The dry-run's tables against the reference's: ``SHAPES``,
``input_specs`` (with and without overrides; ``meta`` tensors against
``jax.ShapeDtypeStruct``), ``shape_supported``, ``LONG_CONTEXT_OK`` and
``DECODE_OK`` for all 14 archs x 4 shapes; ``mesh_info`` of the
production meshes against the reference's on duck-typed meshes; and
``kernel_costs`` for every ``ASSIGNED`` cell on both production meshes,
with the raw and the optimized config, against the reference's — which
is imported only in a subprocess, since ``repro.launch.dryrun`` sets
``XLA_FLAGS`` at import.  All exact."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import LONG_CONTEXT_OK as J_LONG
from repro.configs import SHAPES as J_SHAPES
from repro.configs import archs as jarchs
from repro.configs import get_config as jget
from repro.configs import input_specs as j_input_specs
from repro.configs import shape_supported as j_supported
from repro.launch.mesh import mesh_info as j_mesh_info
from repro_torch.configs import (ARCHS, ASSIGNED, DECODE_OK, LONG_CONTEXT_OK,
                                 SHAPES, get_config, input_specs,
                                 shape_supported)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (ShapeMesh, make_production_mesh,
                                     mesh_info)

SRC = Path(__file__).resolve().parents[1] / "src"

_DTYPES = {torch.int32: "int32", torch.bfloat16: "bfloat16"}


class FakeMesh:
    """Duck-typed mesh exposing .shape only."""

    def __init__(self, **axes):
        self.shape = axes


PROD = {"single": dict(data=16, model=16),
        "multi": dict(pod=2, data=16, model=16)}


def test_shapes_and_arch_sets_are_the_reference_ones():
    assert SHAPES == J_SHAPES
    assert LONG_CONTEXT_OK == J_LONG
    assert DECODE_OK == jarchs.DECODE_OK
    assert set(ARCHS) == set(jarchs.ARCHS)


def _same(got, want):
    assert set(got) == set(want)
    for k, t in got.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(want[k].shape), k
        assert _DTYPES[t.dtype] == str(want[k].dtype), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_and_support_match_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    for shape in SHAPES:
        assert shape_supported(cfg, shape) == j_supported(jcfg, shape)
        _same(input_specs(cfg, shape), j_input_specs(jcfg, shape))
        kw = dict(batch_override=4, seq_override=544)
        _same(input_specs(cfg, shape, **kw), j_input_specs(jcfg, shape, **kw))


def test_input_specs_refuse_an_unknown_shape():
    with pytest.raises(KeyError):
        input_specs(get_config("smollm-360m"), "train_1k")


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_info_matches_reference(kind):
    mesh = make_production_mesh(multi_pod=kind == "multi")
    assert mesh_info(mesh) == j_mesh_info(FakeMesh(**PROD[kind]))
    assert dict(zip(mesh.mesh_dim_names, mesh.shape)) == PROD[kind]
    assert mesh.size == (512 if kind == "multi" else 256)


def test_shape_mesh_checks_its_axes():
    with pytest.raises(ValueError):
        ShapeMesh(("data", "model"), (16,))
    with pytest.raises(ValueError):
        ShapeMesh(("data", "model"), (0, 16))
    assert mesh_info(ShapeMesh(("data", "model"), (1, 1)))["n_devices"] == 1


_PROBE = """
import json, sys
from repro.configs import ASSIGNED, SHAPES, get_config, shape_supported
from repro.launch import dryrun

class FakeMesh:
    def __init__(self, **axes):
        self.shape = axes

PROD = {"single": dict(data=16, model=16),
        "multi": dict(pod=2, data=16, model=16)}
out = {}
for arch in ASSIGNED:
    for shape in SHAPES:
        if not shape_supported(get_config(arch), shape):
            continue
        for kind, axes in PROD.items():
            mesh = FakeMesh(**axes)
            for impl in ("baseline", "optimized"):
                cfg = get_config(arch)
                if impl == "optimized":
                    cfg = dryrun.optimized_cfg(cfg, mesh)
                out["|".join((arch, shape, kind, impl))] = list(
                    dryrun.kernel_costs(cfg, shape, mesh))
print(json.dumps(out))
"""


def test_kernel_costs_match_reference_on_every_assigned_cell():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = {}
    for arch, shape in dryrun.cells():
        for kind in PROD:
            mesh = make_production_mesh(multi_pod=kind == "multi")
            for impl in ("baseline", "optimized"):
                cfg = get_config(arch)
                if impl == "optimized":
                    cfg = dryrun.optimized_cfg(cfg, mesh)
                got["|".join((arch, shape, kind, impl))] = list(
                    dryrun.kernel_costs(cfg, shape, mesh))
    assert len(got) == 2 * 2 * sum(1 for a in ASSIGNED for s in SHAPES
                                   if shape_supported(get_config(a), s))
    assert got == want
    # the kernels' cost is there: every non-decode cell counts some
    assert all(f > 0 and b > 0 for k, (f, b) in got.items()
               if "decode" not in k and "long" not in k)
