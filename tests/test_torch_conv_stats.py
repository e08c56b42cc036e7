"""The port's conv1x1 + BN-stats op (sota_imagenet_tpu_torch.ops.conv_stats)
and its Conv1x1BNStats module against the JAX package's, on the CPU, from
the same numpy inputs. The JAX side runs its Pallas kernel in interpret mode
(as tests/test_pallas_conv_stats.py does off the TPU); the port's CPU path
is the kernel's plain version.

Tolerances:
* y: both sides take bf16 products with f32 sums, in other orders, so where
  the two sums straddle a bf16 rounding boundary y may differ by one bf16
  ulp; where y is near 0, by the f32 summation-order bound
  2K * 2^-24 * (|x| @ |w|) on top. At most 1e-3 of the elements may differ.
* sums: rtol 1e-5, atol 1e-3 (tests/test_pallas_conv_stats.py), plus what
  the elements of y that differ account for (sum |dy|, sum |d(y^2)|).
* gradients: rtol 1e-3 of the largest gradient (same fold and bf16
  rounding on both sides; the products' f32 sums run in other orders).
* Conv1x1BNStats: inputs and weights on coarse binary grids, so every
  product and partial sum is exact in f32 and y is the same on both sides;
  then f32 outputs within rtol 1e-5 / atol 1e-5, bf16 outputs within one
  bf16 ulp (rtol 2^-7), running buffers within rtol 1e-5 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.models.resnet import Conv1x1BNStats as JConv1x1BNStats
from sota_imagenet_tpu.ops import pallas_conv_stats as jcs
from sota_imagenet_tpu_torch.models.resnet import Conv1x1BNStats
from sota_imagenet_tpu_torch.ops.conv_stats import conv1x1_stats, conv1x1_stats_nhwc, conv1x1_stats_reference

SHAPES = [(256, 64, 256), (384, 128, 512), (100, 32, 128), (1000, 40, 72)]
FLIP_FRACTION = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: under pytest-xdist several workers share the
    cores, and oversubscribed OpenMP threads slow these small CPU runs by
    one to two orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX Conv1x1BNStats calls conv1x1_stats_nhwc without ``interpret``;
    on the CPU it must run interpreted."""
    monkeypatch.setattr(jcs, "conv1x1_stats_nhwc", functools.partial(jcs.conv1x1_stats_nhwc, interpret=True))


def _inputs(m, k, n, seed):
    """x (M, K) and w in the JAX layout (K, N), f32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, k)).astype(np.float32), (rng.standard_normal((k, n)) * 0.1).astype(np.float32)


def _bf16(a):
    return np.asarray(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16).float())


def assert_y_close(y, y_ref, x, w_kn):
    """y, y_ref: (M, N) f32 holding bf16 values; x (M, K), w_kn (K, N)."""
    y, y_ref = np.asarray(y, np.float64), np.asarray(y_ref, np.float64)
    diff = np.abs(y - y_ref)
    _, exp = np.frexp(np.maximum(np.abs(y), np.abs(y_ref)))
    ulp = np.ldexp(1.0, exp - 8)
    slack = 2.0 * x.shape[1] * 2.0**-24 * (np.abs(_bf16(x)).astype(np.float64) @ np.abs(_bf16(w_kn)).astype(np.float64))
    assert int((diff > ulp + slack).sum()) == 0
    assert float((diff > 0).mean()) <= FLIP_FRACTION
    return diff


def assert_sums_close(s1, s2, js1, js2, y, jy):
    y, jy = np.asarray(y, np.float64), np.asarray(jy, np.float64)
    tol1 = 1e-5 * np.abs(js1) + 1e-3 + np.abs(y - jy).sum(0)
    tol2 = 1e-5 * np.abs(js2) + 1e-3 + np.abs(y * y - jy * jy).sum(0)
    assert np.all(np.abs(np.asarray(s1, np.float64) - js1) <= tol1)
    assert np.all(np.abs(np.asarray(s2, np.float64) - js2) <= tol2)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_forward_matches_jax_kernel(m, k, n):
    x, w = _inputs(m, k, n, seed=0)
    jy, js1, js2 = jcs.conv1x1_stats(jnp.asarray(x), jnp.asarray(w), True)
    jy = np.asarray(jy.astype(jnp.float32))
    y, s1, s2 = conv1x1_stats(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)))
    assert y.dtype == torch.bfloat16 and s1.dtype == s2.dtype == torch.float32
    assert tuple(y.shape) == (m, n) and tuple(s1.shape) == tuple(s2.shape) == (n,)
    assert_y_close(y.float().numpy(), jy, x, w)
    assert_sums_close(s1.numpy(), s2.numpy(), np.asarray(js1, np.float64), np.asarray(js2, np.float64), y.float().numpy(), jy)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x, w = _inputs(200, 48, 96, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T))
    before = conv1x1_stats.launches
    got = conv1x1_stats(tx, tw)
    want = conv1x1_stats_reference(tx, tw)
    assert conv1x1_stats.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _loss(y32, s1, s2, m, use_sums=True):
    """The loss of tests/test_pallas_conv_stats.py::test_grads_match_unfused
    (y32: y as f32; jnp or torch)."""
    out = (y32 * 0.01).sum()
    if use_sums:
        mean = s1 / m
        var = s2 / m - mean**2
        out = out + (mean * 0.5).sum() + (var * 0.25).sum()
    return out


@pytest.mark.parametrize("use_sums", [True, False], ids=["sums_used", "sums_unused"])
def test_grads_match_jax_vjp(use_sums):
    """The autograd.Function's backward against the JAX custom VJP; with the
    sums unused their cotangents are None here and zeros in JAX."""
    m, k, n = 256, 64, 128
    x, w = _inputs(m, k, n, seed=2)

    def jloss(x, w):
        y, s1, s2 = jcs.conv1x1_stats(x, w, True)
        return _loss(y.astype(jnp.float32), s1, s2, m, use_sums)

    jgx, jgw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_(True)
    y, s1, s2 = conv1x1_stats(tx, tw)
    _loss(y.float(), s1, s2, m, use_sums).backward()
    assert tx.grad.dtype == torch.float32 and tw.grad.dtype == torch.float32
    for got, want in ((tx.grad.numpy(), np.asarray(jgx)), (tw.grad.numpy().T, np.asarray(jgw))):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("stride", [1, 2])
def test_nhwc_wrapper_matches_jax(stride):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 32)).astype(np.float32)
    w = (rng.standard_normal((1, 1, 32, 128)) * 0.1).astype(np.float32)
    jy, js1, js2 = jcs.conv1x1_stats_nhwc(jnp.asarray(x), jnp.asarray(w), stride=stride, interpret=True)
    jy = np.asarray(jy.astype(jnp.float32))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)  # NCHW view of NHWC memory: channels_last
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    y, s1, s2 = conv1x1_stats_nhwc(tx, tw, stride=stride)
    side = 8 // stride
    assert tuple(y.shape) == (2, 128, side, side) and y.is_contiguous(memory_format=torch.channels_last)
    y_nhwc = y.permute(0, 2, 3, 1).float().numpy()
    x_sub = x[:, ::stride, ::stride, :].reshape(-1, 32)
    assert_y_close(y_nhwc.reshape(-1, 128), jy.reshape(-1, 128), x_sub, w.reshape(32, 128))
    assert_sums_close(
        s1.numpy(), s2.numpy(), np.asarray(js1, np.float64), np.asarray(js2, np.float64),
        y_nhwc.reshape(-1, 128), jy.reshape(-1, 128),
    )


BAD_OPERANDS = {
    "x_not_contiguous": (lambda: torch.zeros(64, 32).t(), lambda: torch.zeros(8, 64), "contiguous"),
    "w_not_contiguous": (lambda: torch.zeros(16, 32), lambda: torch.zeros(32, 8).t(), "contiguous"),
    "float64": (lambda: torch.zeros(16, 32, dtype=torch.float64), lambda: torch.zeros(8, 32), "bfloat16 or float32"),
    "k_mismatch": (lambda: torch.zeros(16, 32), lambda: torch.zeros(8, 31), r"\(M, K\)"),
    "not_2d": (lambda: torch.zeros(2, 16, 32), lambda: torch.zeros(8, 32), r"\(M, K\)"),
}


@pytest.mark.parametrize("case", sorted(BAD_OPERANDS))
def test_contract_is_checked_on_every_device(case):
    x, w, match = BAD_OPERANDS[case]
    with pytest.raises(ValueError, match=match):
        conv1x1_stats(x(), w())


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv1x1_stats(torch.zeros(16, 32, device="meta"), torch.zeros(8, 32, device="meta"))


def _grid(rng, shape, step, lim):
    """Values on a binary grid (multiples of ``step``, |v| <= lim): bf16-exact,
    and their products sum exactly in f32."""
    return np.clip(np.round(rng.standard_normal(shape) * lim / 3 / step) * step, -lim, lim).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_module_matches_jax(interpret, train, dtype, stride):
    """Conv1x1BNStats (ReLU) against the JAX module: output and running
    buffers, train mode (kernel + batch stats + EMA) and eval mode (plain
    conv + running stats)."""
    rng = np.random.default_rng(4)
    x = _grid(rng, (4, 8, 8, 32), 1 / 8, 4.0)
    kernel = _grid(rng, (1, 1, 32, 64), 1 / 64, 0.75)
    params = {
        "kernel": kernel,
        "scale": rng.uniform(0.5, 1.5, 64).astype(np.float32),
        "bias": rng.normal(0, 0.2, 64).astype(np.float32),
    }
    stats = {"mean": rng.normal(0, 0.2, 64).astype(np.float32), "var": rng.uniform(0.5, 1.5, 64).astype(np.float32)}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jmod = JConv1x1BNStats(out_chs=64, stride=stride, momentum=0.1, activation="relu", dtype=jdt)
    jout, jmut = jmod.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x).astype(jdt), train=train, mutable=["batch_stats"]
    )
    mod = Conv1x1BNStats(32, 64, stride, 0.1, activation="relu", dtype=tdt)
    mod.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
        "scale": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"]),
    })
    mod.train(train)
    with torch.no_grad():
        out = mod(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert out.dtype == tdt and out.is_contiguous(memory_format=torch.channels_last)
    got, want = out.permute(0, 2, 3, 1).float().numpy(), np.asarray(jout.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-7, atol=1e-6)
    for buf, leaf in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(mod, buf).numpy(), np.asarray(jmut["batch_stats"][leaf]), rtol=1e-5, atol=1e-6, err_msg=buf
        )
    if not train:  # eval mode leaves the buffers as they were
        assert torch.equal(mod.running_var, torch.from_numpy(stats["var"]))
