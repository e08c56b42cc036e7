"""The mesh's axes over ranks (``parallel/mesh.create_mesh``) against the JAX
``create_mesh`` (parallel/mesh.py:24-46), and ``validate_spatial_extent``
against the JAX guard (tests/test_spatial.py:64-86), case for case.

* The layout: rank (d * spatial + s) * model + m is the device the JAX mesh
  puts at [d, s, m] (8 virtual CPU devices, tests/conftest.py), for every
  shape of 1, 2, 4 and 8 ranks, ``data=-1`` included; each axis's groups
  are the JAX mesh's rows along that axis.
* The JAX shape errors, with their messages.
* On 8 gloo ranks (one spawn, float-free): each rank's index on every axis
  and the ranks ``gather_rows`` collects over each axis's group.
* The extent guard refuses what the JAX guard refuses, with its message.
"""

import itertools

import numpy as np
import pytest

from sota_imagenet_tpu.parallel.mesh import create_mesh as jax_create_mesh
from sota_imagenet_tpu.parallel.mesh import validate_spatial_extent as jax_validate
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel.spatial import validate_spatial_extent
from sota_imagenet_tpu_torch.tools.ranks import run_ranks

import test_torch_mesh_workers as W

SHAPES = [(d, s, m) for n in (1, 2, 4, 8) for d, s, m in itertools.product((1, 2, 4, 8), repeat=3) if d * s * m == n]


def _jax_grid(data, spatial, model, n):
    import jax

    mesh = jax_create_mesh(data=data, model=model, spatial=spatial, devices=jax.devices()[:n])
    return np.vectorize(lambda dev: dev.id)(mesh.devices)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rank_layout_and_axis_groups_are_the_jax_mesh(shape):
    d, s, m = shape
    n = d * s * m
    grid = _jax_grid(d, s, m, n)
    for rank in range(n):
        mesh = par.Mesh(d, s, m, rank)
        i = mesh.index
        assert grid[i["data"], i["spatial"], i["model"]] == rank
        assert i["data_spatial"] == i["data"] * s + i["spatial"] and i["world"] == rank
    mesh = par.Mesh(d, s, m)
    axes = {"data": 0, "spatial": 1, "model": 2}
    for axis, k in axes.items():
        want = sorted(grid.transpose(k, *[a for a in range(3) if a != k]).reshape(grid.shape[k], -1).T.tolist())
        assert sorted(mesh.ranks(axis)) == want, axis
    assert sorted(mesh.ranks("data_spatial")) == sorted(grid.reshape(d * s, m).T.tolist())


@pytest.mark.parametrize("data,spatial,model,world", [(-1, 2, 1, 8), (-1, 2, 2, 8), (-1, 1, 1, 4), (2, 2, 2, 8)])
def test_data_minus_one_takes_the_rest(data, spatial, model, world):
    mesh = par.create_mesh(data=data, spatial=spatial, model=model, world=world)
    assert mesh.shape["data"] * spatial * model == world
    assert mesh.shape["data"] == np.asarray(_jax_grid(data, spatial, model, world)).shape[0]


@pytest.mark.parametrize("data,spatial,model,world", [(3, 3, 1, 8), (-1, 3, 1, 8), (2, 1, 1, 8), (-1, 1, 3, 4)])
def test_shape_errors_are_the_jax_errors(data, spatial, model, world):
    import jax

    with pytest.raises(ValueError) as want:
        jax_create_mesh(data=data, model=model, spatial=spatial, devices=jax.devices()[:world])
    with pytest.raises(ValueError) as got:
        par.create_mesh(data=data, spatial=spatial, model=model, world=world)
    assert str(got.value) == str(want.value)


def test_groups_on_eight_ranks(tmp_path):
    """Each rank's index and the members of its group on every axis, for
    2x2x2, as ``gather_rows`` over that group sees them."""
    out = run_ranks(W.layout, 8, (2, 2, 2), tmp_dir=str(tmp_path))
    for rank, r in enumerate(out):
        mesh = par.Mesh(2, 2, 2, rank)
        assert r["index"] == mesh.index
        for axis in ("data", "spatial", "model", "data_spatial"):
            group = next(g for g in mesh.ranks(axis) if rank in g)
            assert r["groups"][axis] == group and r["gather"][axis] == group, axis


class _M:
    """A mesh of the given shape, as both guards read it (``mesh.shape``)."""

    def __init__(self, data, spatial):
        self.shape = {"data": data, "spatial": spatial, "model": 1}


@pytest.mark.parametrize("data,spatial,size", [(2, 4, 512), (2, 4, 224), (1, 1, 32), (4, 2, 128), (4, 2, 64),
                                               (1, 2, 224), (1, 2, 96), (2, 2, 127), (1, 8, 512)])
def test_spatial_extent_guard_is_the_jax_guard(data, spatial, size):
    try:
        jax_validate(_M(data, spatial), size)
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        validate_spatial_extent(_M(data, spatial), size)
    else:
        with pytest.raises(ValueError) as got:
            validate_spatial_extent(_M(data, spatial), size)
        assert str(got.value) == want and "miscompiles" in want


def test_spatial_extent_guard_cases_of_the_jax_test():
    """JAX tests/test_spatial.py:64-86: 512 on 2x4 passes, 224 refuses, pure DP never refuses."""
    validate_spatial_extent(par.create_mesh(data=2, spatial=4, world=8), 512)
    with pytest.raises(ValueError, match="miscompiles"):
        validate_spatial_extent(par.create_mesh(data=2, spatial=4, world=8), 224)
    validate_spatial_extent(par.create_mesh(world=8), 32)
