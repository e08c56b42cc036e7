"""The plain versions of the NFNet chain kernels (``ops/nf_fused.py``) on the
CPU: ``NFBlock.fused`` (``nf_ws``, ``nf_act`` and ``nf_tail``, whose CPU path
is the plain forward and the hand-derived backward) against autograd of the op
by op ``NFBlock.chain`` in float64, with the same drop mask; ``nf_ws`` against
autograd of ``ScaledStdConv.standardized_weight``; an NFNet through them
against its chain; a dropped sample whose branch holds NaN; the path choice;
and that the CPU launches no kernel. The kernels themselves are held against
these plain versions on the card (test_torch_nf_fused_cuda.py)."""

import itertools

import pytest
import torch

from sota_imagenet_tpu_torch.models import layers, nfnet
from sota_imagenet_tpu_torch.models.layers import ScaledStdConv
from sota_imagenet_tpu_torch.models.nfnet import NFBlock, NFNet
from sota_imagenet_tpu_torch.ops import nf_fused
from sota_imagenet_tpu_torch.parallel import spatial

MASK = torch.tensor([True, False, True, True, False, True])  # kept and dropped samples


def _params(module, gen):
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen, dtype=p.dtype))


def _run(module, path, x, monkeypatch, mask=MASK):
    """Output, input gradient and every parameter's gradient of ``path`` (a
    method of ``module``) against a fixed cotangent, the drop mask ``mask``."""
    monkeypatch.setattr(layers, "draw_keep_mask", lambda gen, keep, shape, device: mask.view(shape))
    module.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_()
    y = path(x)
    cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(1), dtype=y.dtype)
    (y * cot).sum().backward()
    return {"y": y.detach(), "dx": x.grad, **{n: p.grad for n, p in module.named_parameters()}}


@pytest.mark.parametrize(
    "stride,attn,gain,keep",
    list(itertools.product([1, 2], ["eca", None], [0.0, 0.5], [1.0, 0.85])),
    ids=lambda v: str(v),
)
def test_block_kernels_plain_version_matches_chain_autograd(stride, attn, gain, keep, monkeypatch):
    gen = torch.Generator().manual_seed(stride * 7 + (attn is None) + int(gain * 10) + int(keep * 100))
    out_chs = 32 if stride == 2 else 16
    blk = NFBlock(16, out_chs, stride=stride, beta=0.9, alpha=0.2, bottle_ratio=0.5, group_size=8, attn_type=attn,
                  keep_prob=keep).double().train()
    _params(blk, gen)
    with torch.no_grad():
        blk.skipinit_gain.fill_(gain)
    x = torch.randn((6, 16, 8, 8), generator=gen, dtype=torch.float64).contiguous(memory_format=torch.channels_last)
    want = _run(blk, blk.chain, x, monkeypatch)
    got = _run(blk, blk.fused, x, monkeypatch)
    assert set(got) == set(want)
    for name in want:
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], want[name], rtol=1e-10, atol=1e-12, msg=name)
    # the gain has a gradient even at 0, where the branch (every bias, the ECA taps) has none
    assert got["skipinit_gain"].abs().sum() > 0
    branch = ["conv1.bias", "conv2.bias", "conv2b.bias", "conv3.bias"] + (["attn.weight"] if attn else [])
    for name in branch:
        assert (got[name].abs().sum() > 0) == (gain != 0), name


def test_nfnet_kernels_plain_version_matches_chain_autograd(monkeypatch):
    gen = torch.Generator().manual_seed(5)
    net = NFNet(depths=(1, 1), channels=(32, 64), stem_chs=(8, 8, 16, 16), group_size=8, num_classes=10,
                drop_path_rate=0.2, dtype=torch.float64).double().train()
    _params(net, gen)
    x = torch.randn((6, 32, 32, 3), generator=gen, dtype=torch.float64)
    mask = torch.tensor([True, False, True, True, True, False])
    want = _run(net, net.forward, x, monkeypatch, mask)
    monkeypatch.setattr(nfnet, "kernel_path", lambda *a, **k: None)  # the kernels' path, plain versions on the CPU
    got = _run(net, net.forward, x, monkeypatch, mask)
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=1e-10, atol=1e-12, msg=name)


WS_CONVS = [(3, 2, True), (1, 1, True), (3, 1, False)]  # (kernel, groups, gain)


@pytest.mark.parametrize("specs", [[c] for c in WS_CONVS] + [WS_CONVS], ids=str)
def test_ws_plain_version_matches_standardized_weight_autograd(specs):
    """Each conv's nf_ws against autograd of its standardized_weight, alone or as one call over a group of
    convs (as NFBlock.fused standardises a block's)."""
    gen = torch.Generator().manual_seed(sum(k * 10 + g + gain for k, g, gain in specs))
    convs = []
    for kernel, groups, gain in specs:
        conv = ScaledStdConv(16, 24, kernel_size=kernel, groups=groups, gamma=1.7, gain_init=1.0 if gain else None)
        conv = conv.double().to(memory_format=torch.channels_last)
        _params(conv, gen)
        convs.append(conv)
    cots = [torch.randn(c.weight.shape, generator=gen, dtype=torch.float64) for c in convs]
    out = {}
    for path in ("chain", "plain"):
        for conv in convs:
            conv.zero_grad(set_to_none=True)
        if path == "chain":
            ws = [conv.standardized_weight() for conv in convs]
        else:
            ws = nf_fused.nf_ws([(c.weight, c.gain, c.scale, c.eps) for c in convs], torch.float64)
        sum((w * cot).sum() for w, cot in zip(ws, cots)).backward()
        out[path] = [t for w, c in zip(ws, convs) for t in [w.detach(), c.weight.grad] + (
            [c.gain.grad] if c.gain is not None else [])]
    for got, want in zip(out["plain"], out["chain"]):
        torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-12)


def test_dropped_sample_is_exactly_its_shortcut_even_when_its_branch_is_nan():
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((3, 8, 4, 4), generator=gen, dtype=torch.float64)
    h[1] = float("nan")
    shortcut = torch.randn((3, 8, 4, 4), generator=gen, dtype=torch.float64, requires_grad=True)
    h.requires_grad_()
    bias = torch.randn(8, generator=gen, dtype=torch.float64, requires_grad=True)
    eca = torch.randn((1, 1, 3), generator=gen, dtype=torch.float64, requires_grad=True)
    gain = torch.tensor(0.5, dtype=torch.float64, requires_grad=True)
    mask = torch.tensor([True, False, True])
    out = nf_fused.nf_tail(h, bias, shortcut, eca, gain, mask, 0.2 * 2.0 / 0.85)
    assert torch.equal(out[1], shortcut[1].detach())
    assert torch.isfinite(out).all()
    out.sum().backward()
    assert torch.equal(h.grad[1], torch.zeros_like(h.grad[1]))
    for t in (h.grad, shortcut.grad, bias.grad, eca.grad, gain.grad):
        assert torch.isfinite(t).all()
    assert torch.equal(shortcut.grad, torch.ones_like(shortcut))


@pytest.mark.parametrize("case", ["cpu", "spatial", "relu", "float32", "cuda_like"])
def test_path_choice(case):
    blk = NFBlock(16, 16, activation="relu" if case == "relu" else "silu").train()
    x = torch.zeros((2, 16, 4, 4), dtype=torch.float32 if case == "float32" else torch.bfloat16)
    if case == "spatial":
        with spatial._active():
            assert blk.kernel_path(x) == "spatial"
        return
    want = {"cpu": "device", "relu": "activation", "float32": "dtype", "cuda_like": "device"}[case]
    if case == "cuda_like":
        # every other condition holds: only the device keeps a CPU tensor on the chain
        assert nfnet.kernel_path(x, blk.base_act, [blk.conv1, blk.conv2, blk.conv2b, blk.conv3], blk.attn) == want
    assert blk.kernel_path(x) == want


def test_nfblock_on_cpu_launches_nothing():
    blk = NFBlock(16, 32, stride=2, keep_prob=0.8, group_size=8).to(torch.bfloat16).train()
    launches, fused, fallbacks = nf_fused.launches.copy(), nf_fused.fused.copy(), nf_fused.fallbacks.copy()
    x = torch.randn((2, 16, 8, 8)).to(torch.bfloat16).requires_grad_()
    blk(x).float().sum().backward()
    assert nf_fused.launches == launches
    # CPU calls are not counted among the card's fused calls and fallbacks
    assert (nf_fused.fused, nf_fused.fallbacks) == (fused, fallbacks)


@pytest.mark.parametrize("c,hw,batch", [(16, 112 * 112, 256), (64, 56 * 56, 256), (384, 14 * 14, 256),
                                        (2304, 49, 256), (1536, 49, 3), (24, 5, 1)])
def test_tiling_covers_every_row_and_channel(c, hw, batch):
    vectors = c // nf_fused.VEC
    tx = nf_fused.tile_x(vectors)
    assert vectors % tx == 0 and nf_fused.THREADS % tx == 0
    rtx = nf_fused.reduce_tile_x(vectors, batch)
    assert vectors % rtx == 0 and nf_fused.THREADS % rtx == 0
    for rows, across in ((batch * hw, vectors // tx), (hw, batch * (vectors // tx))):
        ty = nf_fused.THREADS // tx
        chunk, n = nf_fused.chunks(rows, ty, across)
        assert chunk % ty == 0 and (n - 1) * chunk < rows <= n * chunk and n <= 65535
