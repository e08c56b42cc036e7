"""The data-parallel layer of the port (``parallel/mesh.py``) on spawned gloo
ranks, and the per-rank layout of the loaders:

  * the collectives on 2 and 3 ranks against numpy on the global array: the
    differentiable sum (its backward sums the ranks' cotangents), the
    zero-padded gather (float, int and bool rows, bit for bit), the mirror
    (global row B-1-i), the microbatch rows, the mean and ``global_mean``;
  * ``BatchNorm`` with 1, 2, 3 and 4 statistics groups over the ranks'
    rows, groups that straddle ranks included, against one process on the
    global batch within 1e-12 (float64): output, the input's gradient, the
    weight's and bias's gradients summed over the ranks, the running buffers;
  * ``resolve_bn_stats`` against the JAX package's, ``data_axis``,
    ``choose_backend``, ZeRO-1's ``deal``, and the run without a launcher
    environment being one rank;
  * rank r's batch of the synthetic and the folder loader is rows
    [r*B/N, (r+1)*B/N) of the batch one process loads (the val tail padded as
    one process pads it, a rank with no real row included), and each rank's
    augment draws from its own stream.

Each spawn (one per rank count) runs every check in one go; the ranks import
torch and the port only (tests/test_torch_dist_workers.py)."""

import os

import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models.norms import resolve_bn_stats as jax_resolve_bn_stats
from sota_imagenet_tpu_torch.data import pipeline as P
from sota_imagenet_tpu_torch.models.norms import BatchNorm, resolve_bn_stats
from sota_imagenet_tpu_torch.optim.zero1 import deal
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.tools.ranks import run_ranks

import test_torch_dist_workers as W

B, C = 12, 3
GROUPS = (1, 2, 3, 4)  # over 2 ranks, 3 groups straddle (rows 4-7 of 12); over 3 ranks, 2 do


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, C))
    bn_x = rng.standard_normal((B, C, 3, 2)) * 2.0 + 0.5
    bn_cot = rng.standard_normal((B, C, 3, 2))
    return x, bn_x, bn_cot


@pytest.fixture(scope="module", params=[2, 3], ids=["2_ranks", "3_ranks"])
def ranks(request, tmp_path_factory):
    x, bn_x, bn_cot = _data()
    out = run_ranks(W.checks, request.param, (x, bn_x, bn_cot, GROUPS), tmp_dir=str(tmp_path_factory.mktemp("rdzv")))
    return request.param, out


def test_sum_and_its_gradient(ranks):
    n, out = ranks
    x, _, _ = _data()
    b = B // n
    want = sum((r + 1.0) * x[r * b : (r + 1) * b].sum(0) for r in range(n))
    for r, res in enumerate(out):
        c = res["collectives"]
        np.testing.assert_allclose(c["sum"], want, rtol=1e-14)
        # every rank's loss sum(w * total) reaches rank r's rows through (r + 1): the cotangents of the n ranks summed
        np.testing.assert_array_equal(c["grad"], np.broadcast_to((r + 1.0) * n * np.arange(1.0, C + 1), (b, C)))


def test_gather_mirror_microbatches_and_means(ranks):
    n, out = ranks
    x, _, _ = _data()
    b = B // n
    ints = np.concatenate([np.arange(4) + 10 * r for r in range(n)])
    for r, res in enumerate(out):
        c = res["collectives"]
        np.testing.assert_array_equal(c["gather"], x)
        np.testing.assert_array_equal(c["gather_int"], ints)
        np.testing.assert_array_equal(c["gather_bool"], ints % 3 == 0)
        np.testing.assert_array_equal(c["mirror"], x[::-1][r * b : (r + 1) * b])
        parts = x.reshape(2, n, B // (2 * n), C)[:, r].reshape(b, C)  # rank r's share of each microbatch
        np.testing.assert_array_equal(c["microbatch"], parts)
        np.testing.assert_allclose(c["mean"], np.mean([x[q * b : (q + 1) * b] for q in range(n)], axis=0), rtol=1e-14)
        np.testing.assert_allclose(c["global_mean"], x.mean(0), rtol=1e-14)


@pytest.mark.parametrize("groups", GROUPS)
def test_grouped_batchnorm_over_ranks_equals_one_process(ranks, groups):
    n, out = ranks
    _, bn_x, bn_cot = _data()
    want = W.batchnorm(bn_x, groups, bn_cot)  # this process: no group, the global batch
    b = B // n
    for r, res in enumerate(out):
        got = res["bn"][groups]
        for k in ("y", "dx"):
            np.testing.assert_allclose(got[k], want[k][r * b : (r + 1) * b], rtol=0, atol=1e-12, err_msg=k)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


def test_grouped_batchnorm_in_one_process_is_per_group_batchnorm():
    """g groups in one process: each group normalised alone, as g BatchNorms on its rows (ghost BN)."""
    _, bn_x, _ = _data()
    x = torch.from_numpy(bn_x)
    y = BatchNorm(C, stats_groups=3).double()(x)
    for j in range(3):
        rows = x[4 * j : 4 * (j + 1)]
        ref = torch.nn.functional.batch_norm(rows, None, None, training=True, eps=1e-5)
        np.testing.assert_allclose(y[4 * j : 4 * (j + 1)].detach().numpy(), ref.numpy(), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="must divide the global batch"):
        BatchNorm(C, stats_groups=5).double()(x)


@pytest.mark.parametrize("spec", [None, "global", 1, "local", 2, 4, "3"])
@pytest.mark.parametrize("devices", [1, 2, 8])
def test_resolve_bn_stats_matches_jax(spec, devices):
    assert resolve_bn_stats(spec, devices) == jax_resolve_bn_stats(spec, devices)


def test_bn_stats_local_on_one_rank_is_one_group():
    assert resolve_bn_stats("local", 1) == 1


def test_data_axis_and_backend():
    assert par.data_axis(-1, 4) == 4 and par.data_axis(2, 2) == 2
    with pytest.raises(ValueError, match="mesh.data=3 does not match the 2 ranks"):
        par.data_axis(3, 2)
    assert par.choose_backend("cuda", 2, 2) == "nccl"
    assert par.choose_backend("cuda", 2, 1) == "gloo"  # two ranks on one card: NCCL refuses the duplicate device
    assert par.choose_backend("cpu", 4, 0) == "gloo"


def test_one_rank_without_a_launcher(monkeypatch):
    for k in par.LAUNCHER_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert par.init_distributed("cpu") is None and not par.distributed()
    t = torch.arange(3.0)
    assert par.all_reduce_sum(t) is t and torch.equal(par.mirror(t), t.flip(0))
    assert par.microbatch_rows(t, 3) is t and par.broadcast_object("x") == "x"


def test_deal_balances_whole_parameters():
    # largest first, each to the lighter rank: 100 to 0, 90 to 1, 50 to 1 (90 < 100), then 10, 5, 5 to 0
    assert deal([100, 10, 90, 5, 5, 50], 2) == [0, 0, 1, 0, 0, 1]
    assert deal([7, 7, 7], 3) == [0, 1, 2] and deal([3, 3], 1) == [0, 0]


# --------------------------------------------------------------------------- #
# The loaders' per-rank rows
# --------------------------------------------------------------------------- #


def _as_rank(monkeypatch, rank, world):
    monkeypatch.setattr(P, "process_index", lambda: rank)
    monkeypatch.setattr(P, "process_count", lambda: world)


@pytest.mark.parametrize("world", [2, 4])
def test_synthetic_loader_rows_of_the_global_batch(monkeypatch, world):
    whole = list(P.SyntheticLoader(8, 8, num_classes=10, length=5))
    for r in range(world):
        _as_rank(monkeypatch, r, world)
        mine = list(P.SyntheticLoader(8 // world, 8, num_classes=10, length=5))
        b = 8 // world
        for (im, lb), (wim, wlb) in zip(mine, whole):
            np.testing.assert_array_equal(im, wim[r * b : (r + 1) * b])
            np.testing.assert_array_equal(lb, wlb[r * b : (r + 1) * b])


def _tree(root, n_train=20, n_val=22):
    from PIL import Image

    rng = np.random.default_rng(1)
    for split, n in (("train", n_train), ("val", n_val)):
        for i in range(n):
            d = os.path.join(root, split, f"c{i % 3}")
            os.makedirs(d, exist_ok=True)
            Image.fromarray(rng.integers(0, 255, (20 + i % 5, 24, 3), dtype=np.uint8)).save(os.path.join(d, f"{i}.png"))
    return str(root)


@pytest.mark.parametrize("world", [2, 4])
def test_folder_loader_rows_of_the_global_batch(monkeypatch, tmp_path, world):
    """Train (shuffled, random crops) and val (22 images in batches of 8: the
    tail's 6 real rows; over 4 ranks the last rank's 2 rows are all padding)."""
    root = _tree(tmp_path)
    for split, is_train in (("train", True), ("val", False)):
        kw = dict(is_train=is_train, image_size=16, workers=1, drop_last=is_train, seed=3)
        whole = list(P.FolderLoader(os.path.join(root, split), batch_size=8, **kw))
        b = 8 // world
        for r in range(world):
            _as_rank(monkeypatch, r, world)
            loader = P.FolderLoader(os.path.join(root, split), batch_size=b, **kw)
            mine = list(loader)
            assert len(loader) == len(mine) == len(whole)
            for got, want in zip(mine, whole):
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w[r * b : (r + 1) * b])
        monkeypatch.undo()
    assert sum(int(m.sum()) for _, _, m in whole) == 22


def test_the_augment_stream_is_the_rank_s(monkeypatch):
    monkeypatch.setattr(par, "process_index", lambda: 0)
    assert par.rank_seed(5) == 5  # rank 0 draws as one process
    monkeypatch.setattr(par, "process_index", lambda: 1)
    feed = P.DeviceFeed(P.SyntheticLoader(2, 4, length=1), lambda g, *t: {}, device="cpu", seed=5)
    assert feed.generator.initial_seed() == par.rank_seed(5) != 5


def test_the_dryrun_gate_holds_on_two_ranks(capsys):
    """``python -m sota_imagenet_tpu_torch.tools.dryrun_multichip 2``: both legs within 1e-6 of the replay."""
    from sota_imagenet_tpu_torch.tools import dryrun_multichip

    assert dryrun_multichip.main(["2"]) == 0
    assert "dryrun_multichip OK: 2 ranks" in capsys.readouterr().out
