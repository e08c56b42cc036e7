"""``cli.main`` of the port on two spawned gloo ranks (``configs/tiny_synthetic.yaml``,
debug mode, ``mesh.data=2``, ``mesh.zero1=true``, the optimizer saved):

  * rank 0 writes the run dir and one ``model_last.ckpt``, and both ranks end
    with the same parameters, bit for bit;
  * a ``run.evaluate=true`` resume of that checkpoint on two ranks reproduces
    the run's final val metrics exactly;
  * the ZeRO-1 checkpoint holds the whole optimizer state (the unsharded
    SGD's), which one process without ZeRO-1 loads and resumes: its eval
    scores the global val batches as the two ranks did;
  * ``mesh.data=3`` under a two-rank group raises ValueError naming both;
  * ``run.bn_stats=local`` on one rank runs, as one group;
  * torchrun's environment (``python -m torch.distributed.run``) starts the
    two ranks of the CLI on the CPU (``--device cpu``) over gloo.
"""

import glob
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.tools.ranks import cli_rank, run_ranks
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.checkpoint import load_checkpoint

import test_torch_dist_workers as W

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIG = os.path.join(ROOT, "configs", "tiny_synthetic.yaml")
OVERRIDES = ["mesh.data=2", "mesh.zero1=true", "log.save_optim=true", "log.tensorboard=false", "loader.batch_size=16",
             "val_loader.batch_size=16", "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]"]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("logs"))
    out = run_ranks(W.cli_train_eval, 2, (CONFIG, OVERRIDES, log_dir), tmp_dir=str(tmp_path_factory.mktemp("rdzv")))
    return log_dir, out


def test_rank_0_writes_once_and_the_ranks_agree(two_ranks):
    log_dir, (r0, r1) = two_ranks
    assert r0["ckpts"] == r1["ckpts"] and len(r0["ckpts"]) == 1
    assert not [f for f in r0["files"] if ".tmp-" in f]
    assert sum(f.endswith("model_last.ckpt") for f in r0["files"]) == 1
    for k, v in r0["train"]["model"].items():
        np.testing.assert_array_equal(v, r1["train"]["model"][k], err_msg=k)
    assert r0["train"]["val"] == r1["train"]["val"] and np.isfinite(r0["train"]["val"]["loss"])


def test_eval_resume_on_two_ranks_reproduces_the_val_metrics(two_ranks):
    _, (r0, r1) = two_ranks
    assert r0["eval"]["val"] == r0["train"]["val"] == r1["eval"]["val"]


def test_mesh_data_must_match_the_ranks(two_ranks):
    _, (r0, r1) = two_ranks
    assert r0["bad"] == r1["bad"] == "mesh.data=3 does not match the 2 ranks of this run (use -1 or 2)"


def test_a_zero1_checkpoint_resumes_in_one_process(two_ranks, tmp_path):
    _, (r0, _) = two_ranks
    ckpt = r0["ckpts"][0]
    disk = torch.load(ckpt, weights_only=True)["state"]
    params = dict(cli.build_model(cli.C.load(CONFIG, overrides=[], strict_env=False)).named_parameters())
    opt_state = disk["optimizer"]["state"]
    assert len(opt_state) == len(params) and disk["step"] == 10  # every parameter's momentum, from both shards
    # one process, a plain SGD over the unwrapped model: the state loads, and the eval scores as the two ranks did
    model = cli.build_model(cli.C.load(CONFIG, overrides=[], strict_env=False))
    state = steps.init_state(model, lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters()),
                             device="cpu")
    state, _ = load_checkpoint(ckpt, state)
    assert state.step == 10
    bufs = [state.optimizer.state[p]["momentum_buffer"] for p in state.optimizer.param_groups[0]["params"]]
    assert all(torch.equal(b, opt_state[i]["momentum_buffer"]) for i, b in enumerate(bufs))
    one = cli_rank(["-c", CONFIG, *[o for o in OVERRIDES if not o.startswith("mesh.data")], f"log.dir={tmp_path}",
                    "run.evaluate=true", f"run.resume={ckpt}"])
    two = r0["eval"]["val"]
    assert one["val"].keys() == two.keys()
    for k in two:
        np.testing.assert_allclose(one["val"][k], two[k], rtol=1e-5, err_msg=k)


def test_bn_stats_local_on_one_rank_runs(tmp_path):
    val = cli.main(["-c", CONFIG, "run.bn_stats=local", "model={_target_: resnet18}", "log.tensorboard=false",
                    "loader.batch_size=4", "val_loader.batch_size=4", "loader.image_size=16", f"log.dir={tmp_path}",
                    "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]"], device="cpu")
    assert np.isfinite(val["loss"])
    from sota_imagenet_tpu_torch.models.norms import bn_stats_groups

    assert bn_stats_groups() == 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_torchrun_launches_two_cpu_ranks(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.abspath(ROOT), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2", "--master_addr=127.0.0.1",
           f"--master_port={_free_port()}", "-m", "sota_imagenet_tpu_torch.cli", "--device", "cpu", "-c", CONFIG,
           "loader.batch_size=8", "val_loader.batch_size=8", "run.stages=[{start: 0, end: 1, lr: [0.05, 0]}]",
           "log.tensorboard=false",
           f"log.dir={tmp_path}"]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "Data parallel: 2 ranks over gloo" in out.stdout
    assert len(glob.glob(os.path.join(str(tmp_path), "*", "*", "model_last.ckpt"))) == 1
