"""The port's TensorBoard sinks (``train/callbacks.py``: TensorBoard,
WeightDistributionTB, SpectralDistributionTB, GradDistributionTB) against
the JAX package's (callbacks.py:473-616), each writing into a recording
writer: the same calls in the same order with the same tags and steps,
scalars and histogram statistics within 1e-6 (relative), the weight and
spectrum histograms' values and GradDistributionTB's bucket counts equal.
Both sides read the same weights: the port's model, and the JAX params tree
made of it by the weights plan (``flax_params``), a depth-cut
24.nf_conv-act trunk (conv, Dense and ECA kernels, gains, biases).

Then the real sink: a CLI run with ``log.tensorboard`` on writes event
files through ``torch.utils.tensorboard`` that read back with the scalars'
tags and steps and the parameter histogram; with the package missing, the
run logs one warning and finishes without them."""

import glob
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.train import callbacks as JCB
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.train import callbacks as TCB
from sota_imagenet_tpu_torch.utils.weights import flax_params

LAYERS = yaml.safe_load("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2, conv_kwargs: {gain_init: 1.0}}]
- [-1, 1, ConvActBlock, [8, 16], {conv_kwargs: {gain_init: 0.5}}]
- [-1, 1, VarEMA]
- [-1, 1, NormFreeBlockTimm, [16, 48, 32]]
- [-1, 1, scaled_conv1x1, [48, 64], {gamma: 2}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [64, 10]]
""")
EXTRA = {"NormFreeBlockTimm": {"groups_width": 8, "attention_type": "eca9", "regnet_attention": True}}


class RecordingWriter:
    """The SummaryWriter methods the sinks call, recorded in order."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step, float(value)))

    def add_histogram(self, tag, values, step):
        self.calls.append(("histogram", tag, step, np.asarray(values)))

    def add_histogram_raw(self, tag, min, max, num, sum, sum_squares, bucket_limits, bucket_counts, global_step):
        self.calls.append(("histogram_raw", tag, global_step, {
            "min": min, "max": max, "num": num, "sum": sum, "sum_squares": sum_squares,
            "bucket_limits": list(bucket_limits), "bucket_counts": list(bucket_counts)}))

    def close(self):
        pass


def _model():
    torch.manual_seed(0)
    return CModel(layer_config=LAYERS, extra_kwargs=EXTRA)


def _jax_params(model):
    tree = {}
    for path, v in flax_params(model).items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = jnp.asarray(v.detach().numpy())
    return tree


def _runners(model):
    """A JAX-side and a port-side stand-in for the Runner, each with a recording writer."""
    jrun = types.SimpleNamespace(state=types.SimpleNamespace(params=_jax_params(model)), tb_writer=RecordingWriter())
    trun = types.SimpleNamespace(state=types.SimpleNamespace(model=model), tb_writer=RecordingWriter())
    return jrun, trun


def _same_calls(got, want):
    assert [c[:3] for c in got] == [c[:3] for c in want]
    for g, w in zip(got, want):
        if g[0] == "scalar":
            np.testing.assert_allclose(g[3], w[3], rtol=1e-6, err_msg=str(g[:3]))
        elif g[0] == "histogram":
            np.testing.assert_allclose(g[3], w[3], rtol=1e-6, atol=0, err_msg=str(g[:3]))
        else:
            assert g[3]["bucket_counts"] == [float(c) for c in w[3]["bucket_counts"]], g[:3]
            assert g[3]["bucket_limits"] == w[3]["bucket_limits"] and g[3]["num"] == w[3]["num"]
            for k in ("min", "max", "sum", "sum_squares"):
                np.testing.assert_allclose(g[3][k], w[3][k], rtol=1e-6, err_msg=k)


def test_tensorboard_scalars_match_jax():
    steps = 5
    rng = np.random.default_rng(0)
    metrics = [{"loss": rng.uniform(1, 7), "Acc@1": rng.uniform(0, 100), "Acc@5": rng.uniform(0, 100),
                "grad_norm": rng.uniform(0, 3), "lr": 0.001 * (i + 1)} for i in range(steps)]
    val = {"loss": 6.5, "Acc@1": 1.25, "Acc@5": 5.0}
    jcb, tcb = JCB.TensorBoard(log_every=2), TCB.TensorBoard(log_every=2)
    jcb.writer, tcb.writer = RecordingWriter(), RecordingWriter()
    for epoch in range(2):
        for i, m in enumerate(metrics):
            step = epoch * steps + i
            jcb.on_batch_end(step, {k: (jnp.float32(v) if k != "lr" else v) for k, v in m.items()})
            tcb.on_batch_end(step, {k: (torch.tensor(v, dtype=torch.float32) if k != "lr" else v) for k, v in m.items()})
        jcb.on_epoch_end(epoch, {}, val)
        tcb.on_epoch_end(epoch, {}, val)
    _same_calls(tcb.writer.calls, jcb.writer.calls)
    assert len(tcb.writer.calls) == (3 + 2) * 5 + 2 * 3  # steps 0, 2, 4, 6, 8 of two epochs, five tags; val


@pytest.mark.parametrize("sink", ["WeightDistributionTB", "SpectralDistributionTB"])
def test_weight_and_spectrum_histograms_match_jax(sink):
    model = _model()
    jrun, trun = _runners(model)
    jcb, tcb = getattr(JCB, sink)(), getattr(TCB, sink)()
    jcb.set_runner(jrun)
    tcb.set_runner(trun)
    for epoch in range(2):
        jcb.on_epoch_begin(epoch)
        tcb.on_epoch_begin(epoch)
    _same_calls(trun.tb_writer.calls, jrun.tb_writer.calls)
    kernels = sum(1 for p in flax_params(model) if "kernel" in p and flax_params(model)[p].dim() >= 2)
    want = 2 * (len(list(model.parameters())) if sink == "WeightDistributionTB" else kernels)
    assert len(trun.tb_writer.calls) == want and kernels >= 8


def test_param_log_histogram_matches_jax():
    model = _model()
    jrun, trun = _runners(model)
    jcb, tcb = JCB.GradDistributionTB(log_every=3), TCB.GradDistributionTB(log_every=3)
    jcb.set_runner(jrun)
    tcb.set_runner(trun)
    for step in range(7):
        jcb.on_batch_end(step, {})
        tcb.on_batch_end(step, {})
    jcb.on_epoch_end(0, {}, {})
    tcb.on_epoch_end(0, {}, {})
    _same_calls(trun.tb_writer.calls, jrun.tb_writer.calls)
    calls = trun.tb_writer.calls
    assert [c[2] for c in calls] == [0, 3, 6]
    want_num = sum(-(-v.numel() // 10) for v in flax_params(model).values())
    assert all(c[3]["num"] == want_num for c in calls)


def test_bin_counts_match_jnp_histogram():
    """Values on the edges (each falls in the bin above it, the last edge in the last bin), inside the
    bins, and outside the edges (in none)."""
    edges = TCB.LOG_EDGES
    rng = np.random.default_rng(0)
    x = np.concatenate([edges, rng.uniform(-16, 6, 1000).astype(np.float32), np.float32([-30.0, 7.5])])
    got = TCB.bin_counts(torch.from_numpy(x), torch.from_numpy(edges))
    want, _ = jnp.histogram(jnp.asarray(x), bins=jnp.asarray(edges))
    assert got.tolist() == np.asarray(want).astype(int).tolist()
    assert int(got.sum()) == int(((x >= edges[0]) & (x <= edges[-1])).sum())


def test_param_log_histogram_clips_into_the_range():
    """0 becomes log10(1e-30) = -30, clipped to -15 (the first bin); 1e9 is clipped to 5 (the last)."""
    got = TCB.log_histogram([torch.tensor([0.0, 1e9, 1.0])], 1, torch.from_numpy(TCB.LOG_EDGES))
    assert int(got["counts"][0]) == 1 and int(got["counts"][-1]) == 1 and int(got["counts"].sum()) == 3
    assert float(got["min"]) == -15.0 and float(got["max"]) == 5.0


def test_grad_distribution_does_nothing_without_a_writer():
    model = _model()
    trun = types.SimpleNamespace(state=types.SimpleNamespace(model=model), tb_writer=None)
    tcb = TCB.GradDistributionTB(log_every=1)
    tcb.set_runner(trun)
    tcb.on_batch_end(0, {})
    assert tcb._buf == []


TB_OVERRIDES = [
    "loader.backend=synthetic", "val_loader.backend=synthetic", "model={_target_: resnet18}",
    "loader.image_size=32", "val_loader.image_size=32", "loader.batch_size=4", "val_loader.batch_size=4",
    "run.bf16=false", "debug=true", "run.stages=[{start: 0, end: 1, lr: [0, 0.001]}]", "log.tensorboard=true",
    "log.histogram=true", "run.extra_callbacks=[{_target_: GradDistributionTB, log_every: 5}]",
]


def test_cli_writes_event_files_that_read_back(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    torch.set_num_threads(1)
    cli.main(["-c", "configs/exp/51.r50_adamp.yaml", *TB_OVERRIDES, f"log.dir={tmp_path}"], device="cpu")
    (run_dir,) = glob.glob(os.path.join(tmp_path, "*", "*"))
    events = glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    assert len(events) == 1
    acc = EventAccumulator(run_dir, size_guidance={"scalars": 0, "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    assert {"train/loss", "train/grad_norm", "train/lr", "val/loss", "val/Acc@1"} <= set(tags["scalars"])
    assert [e.step for e in acc.Scalars("train/loss")] == [0]  # every 50 steps of a 10-step epoch
    assert [e.step for e in acc.Scalars("val/loss")] == [0]
    hist = acc.Histograms("optim/model_params_log")
    assert [h.step for h in hist] == [0, 5]
    resnet18_params = sum(p.numel() for p in flax_params(__import__(
        "sota_imagenet_tpu_torch.models", fromlist=["resnet18"]).resnet18()).values())
    assert hist[0].histogram_value.num > resnet18_params // 10
    assert any(t.startswith("model/") for t in tags["histograms"])  # log.histogram's WeightDistributionTB


def test_cli_without_tensorboard_warns_once_and_finishes(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import raises ImportError
    torch.set_num_threads(1)
    val = cli.main(["-c", "configs/exp/51.r50_adamp.yaml", *TB_OVERRIDES, f"log.dir={tmp_path}"], device="cpu")
    assert set(val) == {"loss", "Acc@1", "Acc@5"}
    (run_dir,) = glob.glob(os.path.join(tmp_path, "*", "*"))
    assert not glob.glob(os.path.join(run_dir, "events.out.tfevents.*"))
    assert os.path.exists(os.path.join(run_dir, "model_last.ckpt"))
    with open(os.path.join(run_dir, "logs.txt")) as f:
        assert f.read().count("TensorBoard sinks off") == 1
