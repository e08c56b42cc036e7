"""What the spatial-partitioning, head-TP and mesh tests run on each spawned
rank (tests/test_torch_mesh_axes.py, tests/test_torch_spatial.py,
tests/test_torch_tp.py). A rank imports torch and sota_imagenet_tpu_torch
only, never JAX, so this module does not either; the tests hold what comes
back against one process and the JAX package. It holds no test of its own."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel import spatial


def layout(data: int, spatial_: int, model: int) -> dict:
    """This rank's index on every axis and the world ranks of its groups."""
    mesh = par.create_mesh(data=data, spatial=spatial_, model=model)
    try:
        return {"index": dict(mesh.index), "groups": {a: next(r for r in mesh.ranks(a) if mesh.index["world"] in r)
                                                      for a in ("data", "spatial", "model", "data_spatial")},
                "gather": {a: par.gather_rows(torch.tensor([mesh.index["world"]]), "test", a).tolist()
                           for a in ("data", "spatial", "model", "data_spatial")}}
    finally:
        par.set_mesh(None)


def _op(kind: str, x: torch.Tensor, w: torch.Tensor, kw: dict) -> torch.Tensor:
    if kind == "conv":
        return F.conv2d(x, w, **kw)
    if kind == "max_pool":
        return F.max_pool2d(x, **kw)
    if kind == "avg_pool":
        return F.avg_pool2d(x, **kw)
    if kind == "blur":  # a pad, then a strided depthwise conv with no padding (BlurPool)
        return F.conv2d(F.pad(x, (1, 1, 1, 1), mode=kw.get("mode", "constant")), w, stride=2, groups=x.shape[1])
    if kind == "mean":
        return x.mean(dim=(2, 3), keepdim=True)
    if kind == "group_norm":
        return F.group_norm(x, 2, w.flatten()[: x.shape[1]], None, 1e-5)
    if kind == "subsample":
        return x[:, :, ::2, ::2] * 1.0
    if kind == "fused_stats":  # Conv1x1BNStats in train mode: conv1x1_stats's bf16 product and float32 sums
        from sota_imagenet_tpu_torch.models.resnet import Conv1x1BNStats

        mod = Conv1x1BNStats(w.shape[1], w.shape[0], **kw)
        mod._parameters["weight"] = w.float()
        return mod(x.float()).double()
    raise KeyError(kind)


def windowed_ops(cases: list) -> list:
    """Each (kind, x NCHW, w, kwargs, cotangent) on this rank's band of x,
    under spatial partitioning over every rank: the whole output (gathered)
    and the gradients of sum(output * cotangent) for x (gathered) and w
    (summed over the ranks)."""
    par.create_mesh(spatial=torch.distributed.get_world_size())
    out = []
    try:
        for kind, x, w, kw, cot in cases:
            xt = torch.from_numpy(x).requires_grad_(True)
            wt = torch.from_numpy(w).requires_grad_(True)
            with spatial._active():
                y = _op(kind, spatial.scatter(xt, 2), wt, kw)
                if par.band_of(y) is None:
                    full, cot_here = y.detach(), cot
                else:
                    lo, hi = par.band_of(y)[1][par.axis_index("spatial")]
                    full, cot_here = spatial.gather(y).detach(), cot[:, :, lo:hi]
                # the sum over a band is the whole sum on every rank: each backpropagates its 1/S (train/steps.py)
                (y * torch.from_numpy(cot_here)).sum().div(par.axis_size("spatial")).backward()
            gw = wt.grad if wt.grad is not None else torch.zeros_like(wt)
            out.append({"y": full.numpy(), "dx": par.all_reduce_(xt.grad.clone(), "test", "spatial").numpy(),
                        "dw": par.all_reduce_(gw.clone(), "test", "spatial").numpy()})
        return out
    finally:
        par.set_mesh(None)


def evaluate(spec: dict) -> dict:
    """The port's eval step on one global batch (``spec``: ``model`` config,
    ``init`` state dict, ``batch`` of numpy images/labels[/mask] the data
    ranks split, ``spatial``): its metrics and the whole logits."""
    import copy

    from sota_imagenet_tpu_torch.config import instantiate
    from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
    from sota_imagenet_tpu_torch.train import steps
    from sota_imagenet_tpu_torch.train.state import TrainState

    par.create_mesh(spatial=spec.get("spatial", 1) if torch.distributed.is_initialized() else 1)
    before = par.STATS.calls.get("spatial_gather", 0)
    try:
        model = instantiate(copy.deepcopy(spec["model"]))
        model.load_state_dict({k: torch.from_numpy(v) for k, v in spec["init"].items()})
        model.double().eval()
        b = spec["batch"]["image"].shape[0] // par.data_count()
        rows = slice(par.data_index() * b, (par.data_index() + 1) * b)
        batch = {k: torch.from_numpy(v[rows]) for k, v in spec["batch"].items()}
        state = TrainState(step=0, model=model, optimizer=None)
        m = steps.build_eval_step(CrossEntropyLoss(smoothing=0.1), input_dtype=torch.float64)(state, batch)
        with torch.no_grad():
            logits = spatial.forward(model, batch["image"])
        return {"metrics": {k: float(v) for k, v in m.items()}, "logits": logits.numpy(),
                "gathers": par.STATS.calls.get("spatial_gather", 0) - before}
    finally:
        par.set_mesh(None)


class _Cumsum(torch.nn.Module):
    def forward(self, x):
        return x.cumsum(1).mean((1, 2))


def unhandled() -> str:
    """The message of the error a row-mixing op the mode does not know raises on a band."""
    par.create_mesh(spatial=torch.distributed.get_world_size())
    try:
        spatial.forward(_Cumsum(), torch.zeros(2, 8, 8, 3, dtype=torch.float64))
    except spatial.SpatialError as e:
        return str(e)
    finally:
        par.set_mesh(None)
    return ""


def suite(cases: list, legs: list, evals: list, cli_argv=None) -> dict:
    """The spatial checks of one spawn: the windowed ops (over every rank),
    the train legs (``ranks.train_steps``), the evals, the unhandled op and,
    with ``cli_argv``, a ``cli.main`` run."""
    from sota_imagenet_tpu_torch.tools import ranks

    par.STATS.reset()
    out = {"ops": windowed_ops(cases) if cases else [], "legs": ranks.train_legs(legs),
           "evals": [evaluate(e) for e in evals], "unhandled": unhandled()}
    if cli_argv is not None:
        out["cli"] = ranks.cli_rank(cli_argv, "cpu")
    return out


def fused_resnet():
    """A depth-cut ResNet whose 1x1 convs take their BatchNorm statistics from ``conv1x1_stats``."""
    from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet

    return ResNet(block=Bottleneck, layers=(1, 1, 1, 1), num_classes=10, fused_stats=True)


def resnet10():
    """A resnet18 cut to one BasicBlock a stage, 10 classes (the JAX ``ResNet(BasicBlock, (1, 1, 1, 1))``)."""
    from sota_imagenet_tpu_torch.models.resnet import BasicBlock, ResNet

    return ResNet(block=BasicBlock, layers=(1, 1, 1, 1), num_classes=10)


def cli_then_legs(argv: list, legs: list) -> dict:
    """``cli.main(argv)`` on this rank (``ranks.cli_rank``), then ``ranks.train_legs(legs)``: one spawn for both."""
    from sota_imagenet_tpu_torch.tools import ranks

    return {"cli": ranks.cli_rank(argv, "cpu"), "legs": ranks.train_legs(legs)}
