"""The port's mesh (``jckx_torch/parallel/mesh.py``) and multi-process
bring-up (``jckx_torch/utils/device.py``) against jckx's, on the CPU.

- ``parse_mesh_shape`` and ``make_mesh`` over a list of 8 devices give
  jckx's shapes, axes and device counts for the same strings, and the same
  errors; a process mesh (no device list) counts ranks of the process
  group and names ``torchrun --nproc_per_node`` when the world is short.
- ``cluster_env_present`` / ``init_multihost`` on torch's and the
  schedulers' variables: a lone host degrades to ``(False, err)``, cluster
  env re-raises (tests/test_multihost.py:300-344 with jckx's variables), a
  complete ``env://`` set brings a world of one up.
- the model axis: a ``(D, M)`` process mesh passes ``check_ported`` with
  its knobs; the refusals are jckx's: a 2-D serving mesh, a model axis on
  a local mesh or on ``evaluate`` / the fine-tune, a batch the data axis
  does not divide, knobs out of their range.
- a local mesh's collectives: sums in device order, rows gathered in
  order, a member's error raised in the caller.
"""

import os
import socket

import jax
import pytest
import torch
import torch.distributed as dist

from jckx.parallel import make_mesh as jmake_mesh
from jckx.parallel import parse_mesh_shape as jparse
from jckx_torch.configs import check_ported, get_arg_parse
from jckx_torch.parallel import (LocalMesh, ProcessMesh, local_batch_size, make_mesh,
                                 parse_mesh_shape, process_mesh)
from jckx_torch.utils.device import cluster_env_present, init_multihost, multihost_barrier

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
        "SLURM_NPROCS", "OMPI_COMM_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for v in _ENV:
        monkeypatch.delenv(v, raising=False)
    assert not dist.is_initialized()
    return monkeypatch


@pytest.mark.parametrize("spec", ["", "4", "8", "4,2", "1,8", "2,2,2"])
def test_parse_mesh_shape_matches_jckx(spec):
    assert parse_mesh_shape(spec) == jparse(spec)


@pytest.mark.parametrize("spec", ["a", "4,", "2;2"])
def test_parse_mesh_shape_errors_match_jckx(spec):
    with pytest.raises(ValueError) as theirs:
        jparse(spec)
    with pytest.raises(ValueError) as ours:
        parse_mesh_shape(spec)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("shape,axes", [(None, ("data",)), ((8,), ("data",)), ((4,), ("data",)),
                                        ((2,), ("data",)), ((8, 1), ("data", "model")),
                                        ((4, 1), ("data", "model"))])
def test_make_mesh_over_devices_matches_jckx(shape, axes):
    theirs = jmake_mesh(shape, axes, devices=jax.devices())
    ours = make_mesh(shape, axes, devices=["cpu"] * len(jax.devices()))
    assert isinstance(ours, LocalMesh)
    assert ours.shape == dict(theirs.shape) and ours.axis_names == tuple(theirs.axis_names)
    assert len(ours.devices) == theirs.devices.size


@pytest.mark.parametrize("shape", [(16,), (9,), (4, 4)])
def test_make_mesh_errors_match_jckx(shape):
    axes = ("data",) if len(shape) == 1 else ("data", "model")
    with pytest.raises(ValueError) as theirs:
        jmake_mesh(shape, axes, devices=jax.devices())
    with pytest.raises(ValueError) as ours:
        make_mesh(shape, axes, devices=["cpu"] * 8)
    assert str(ours.value) == str(theirs.value)  # the device count, before the model axis


def test_process_mesh_counts_the_process_group(clean_env):
    one = make_mesh(None)
    assert isinstance(one, ProcessMesh) and one.shape == {"data": 1} and not one.distributed
    assert one.rank == 0 and one.lead and make_mesh((1,)).size == 1
    x = torch.arange(6.0)
    assert one.all_reduce(x) is x and one.all_gather_rows(x) is x and one.mean(x) is x
    assert one.any(True) and not one.any(False)
    with pytest.raises(ValueError, match=r"needs 2 ranks, have 1 .*torchrun --nproc_per_node 2"):
        make_mesh((2,))
    assert process_mesh("") is None and process_mesh("", multihost=True) is None
    assert process_mesh("1").size == 1
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 4"):
        process_mesh("4")  # no env: the group degrades, the mesh is larger than the world
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({}, False), ({"WORLD_SIZE": "2"}, True), ({"WORLD_SIZE": "1"}, False),
    ({"MASTER_ADDR": "10.0.0.1"}, False), ({"MASTER_ADDR": "10.0.0.1", "WORLD_SIZE": "4"}, True),
    ({"SLURM_NTASKS": "4"}, True), ({"SLURM_NPROCS": "1"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "2"}, True), ({"WORLD_SIZE": "x"}, False)])
def test_cluster_env_present(clean_env, env, want):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert cluster_env_present() is want


def test_init_multihost_lone_host_degrades(clean_env):
    """No cluster env at all: ``(False, err)``, and no group."""
    ok, err = init_multihost("cpu")
    assert not ok and err is not None and not dist.is_initialized()
    clean_env.setenv("MASTER_ADDR", "127.0.0.1")  # an address alone is no cluster
    ok, err = init_multihost("cpu")
    assert not ok and not dist.is_initialized()


@pytest.mark.parametrize("env", [{"WORLD_SIZE": "2"}, {"SLURM_NTASKS": "2"},
                                 {"OMPI_COMM_WORLD_SIZE": "2"},
                                 {"WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1"}])
def test_init_multihost_fails_fast_with_cluster_env(clean_env, env):
    """Cluster env present but the group cannot come up (no rank, no port):
    re-raise, never train a divergent solo run."""
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(ValueError):
        init_multihost("cpu")
    assert not dist.is_initialized()


def test_init_multihost_brings_up_a_world_of_one(clean_env):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port)}.items():
        clean_env.setenv(k, v)
    try:
        assert init_multihost("cpu") == (True, None)
        mesh = process_mesh("1", device="cpu")
        assert mesh.distributed and mesh.size == 1 and mesh.lead
        x = torch.arange(4.0, requires_grad=True)
        y = mesh.all_reduce(x)
        assert torch.equal(y, x.detach()) and y.requires_grad  # the collective ran, in autograd
        y.sum().backward()
        assert torch.equal(x.grad, torch.ones(4))
        multihost_barrier("test")
    finally:
        dist.destroy_process_group()


def test_refusals_name_their_item(tmp_path):
    for argv in (["--mesh_shape", "2", "--tp_min_dim", "0"], ["--spatial_replicate_grads", "2"]):
        with pytest.raises(SystemExit, match="tp_min_dim|spatial_replicate_grads"):
            check_ported(get_arg_parse(argv))
    for argv in (["--mesh_shape", "2"], ["--mesh_shape", "4,1", "--mesh_axes", "data,model"],
                 ["--multihost"], ["--mesh_shape", "2,2", "--mesh_axes", "data,model"],
                 ["--model_axis_mode", "spatial", "--spatial_replicate_grads", "0"],
                 ["--tp_min_dim", "64"]):
        check_ported(get_arg_parse(argv))  # both axes are ported for train
    for what in ("evaluate", "the fine-tune"):  # jckx runs them on a data axis
        with pytest.raises(ValueError, match=f"{what} runs on the 'data' axis only"):
            process_mesh("1,2", "data,model", what=what)
    with pytest.raises(ValueError, match="serving"):
        make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    with pytest.raises(SystemExit, match="mesh_axes"):
        check_ported(get_arg_parse(["--mesh_shape", "2,2"]))  # two sizes, one axis
    from jckx_torch.serve import serving_mesh

    with pytest.raises(SystemExit, match="1-D"):
        serving_mesh("2,2", "cpu")
    assert serving_mesh("", "cpu") is None and serving_mesh("3", "cpu").size == 3
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(8, make_mesh((3,), devices=["cpu"] * 3))
    from jckx_torch.train.gan_trainer import DCGANTrainer

    cfg = get_arg_parse(["--device", "cpu", "-b", "8", "--save_root", str(tmp_path)])
    with pytest.raises(ValueError, match="not divisible by the mesh 'data' axis"):
        DCGANTrainer(cfg, None, None, None, mesh=ProcessMesh((3,), ("data",)))
    assert os.listdir(tmp_path) == []


def test_trainer_refuses_eval_forwards_the_mesh_does_not_split(tmp_path):
    """64 eval rows do not split over 3 ranks: refused when the trainer is
    built, not at its first eval."""
    from jckx_torch.data.pipeline import DCGANDataPreprocessor
    from jckx_torch.models.dcgan import Discriminator, GANGeometry, Generator
    from jckx_torch.train.gan_trainer import DCGANTrainer
    from jckx_torch.logging.main_logger import MainLogger

    cfg = get_arg_parse(["--device", "cpu", "-b", "6", "--dataset", "synthetic",
                         "--synthetic_size", "12", "--image_size", "16", "--base_width", "8",
                         "--save_root", str(tmp_path), "--data_dir", str(tmp_path / "d")])
    geo = GANGeometry(image_size=16, base_width=8)
    try:
        with pytest.raises(ValueError, match=r"eval's G forwards of \[64\] rows"):
            DCGANTrainer(cfg, Generator(geo), Discriminator(geo), DCGANDataPreprocessor(cfg),
                         metrics=object(), mesh=ProcessMesh((3,), ("data",)))
    finally:
        MainLogger.reset()


def test_local_mesh_collectives_run_in_member_order():
    mesh = make_mesh((3,), devices=["cpu"] * 3)
    x = torch.arange(12.0).reshape(6, 2)

    def member(i, dev):
        assert mesh.rank == i and dev == torch.device("cpu")
        part = mesh.rows(x)
        return mesh.all_reduce(part.sum(0)), mesh.all_gather_rows(part * (i + 1))

    out = mesh.run(member)
    for total, rows in out:
        assert torch.equal(total, x.sum(0))
        assert torch.equal(rows, x * torch.tensor([1.0, 1, 2, 2, 3, 3])[:, None])
    with pytest.raises(RuntimeError, match="inside LocalMesh.run"):
        mesh.rank

    def failing(i, dev):
        if i == 1:
            raise KeyError("member 1")
        return mesh.all_reduce(torch.ones(1))  # the others must not wait forever

    with pytest.raises(KeyError, match="member 1"):
        mesh.run(failing)
    assert [t.item() for t in mesh.run(lambda i, dev: mesh.all_reduce(torch.ones(1)))] == [3.0] * 3
