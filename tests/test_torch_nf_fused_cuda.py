"""The NFNet chain kernels (``csrc/nf_fused.cu``) on the card (marked
``cuda``; skipped without a GPU): each kernel against its plain version at
every distinct shape of eca_nfnet_l0's SiLU sites and block tails, at batch
256 and at an odd batch, and at every distinct conv weight; a train step of two microbatches through the
kernels against the op by op chain and a float32 chain; ``run.remat`` over
the kernels; the launches of a step against the count the model's structure
gives. tests/test_torch_nf_fused.py holds the plain versions against
autograd of the chain on the CPU.

This file imports no JAX, so it runs on a machine without it; the repo's
conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_nf_fused_cuda.py -q
"""

import math

import pytest
import torch
import torch.nn.functional as F

from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models import layers, nfnet
from sota_imagenet_tpu_torch.ops import nf_fused
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps

# eca_nfnet_l0 at 224 px: (C, H, W, bias) of every distinct SiLU site, (C, H, W) of every distinct block tail
L0_ACT_SITES = [
    (16, 112, 112, True), (32, 112, 112, True), (64, 112, 112, True),  # stem
    (128, 56, 56, False), (256, 56, 56, False), (512, 28, 28, False), (1536, 14, 14, False), (1536, 7, 7, False),
    (64, 56, 56, True), (128, 56, 56, True), (128, 28, 28, True), (384, 28, 28, True), (384, 14, 14, True),
    (384, 7, 7, True), (2304, 7, 7, True),
]
L0_TAILS = [(256, 56, 56), (512, 28, 28), (1536, 14, 14), (1536, 7, 7)]
BATCHES = [256, 3]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; the CPU tests hold their plain versions)")
    return torch.device("cuda")


def _nhwc(gen, shape, device, scale=1.0):
    b, c, h, w = shape
    x = torch.randn((b, h, w, c), generator=gen, device=device) * scale
    return x.to(torch.bfloat16).permute(0, 3, 1, 2)


def _within_one_ulp(got: torch.Tensor, want32: torch.Tensor, mag: torch.Tensor, rel: float = 2.0**-20) -> None:
    """bf16 ``got`` within one bf16 ulp of the float32 ``want32`` (the plain
    version rounded once), plus ``rel`` of ``mag``, the size of the terms
    that cancel to ``want32``: the two float32 evaluations (the kernel's with
    fused multiply-adds, its sums in another order) differ by that much before
    the rounding; 8 float32 ulps by default."""
    want32 = want32.float()
    exp = torch.floor(torch.log2(want32.abs().clamp_min(2.0**-126)))
    ulp = torch.exp2(exp - 7) + rel * mag.float()
    err = (got.float() - want32).abs()
    bad = err > ulp
    assert not bad.any(), f"{int(bad.sum())} values beyond one ulp; worst {float((err / ulp).max()):.3g} ulps"


def _close_sum(got: torch.Tensor, want: torch.Tensor) -> None:
    """float32 sums taken in another order: within 1e-4 of the largest term's scale."""
    torch.testing.assert_close(got, want.to(got.dtype), rtol=1e-4, atol=1e-4 * float(want.abs().max()) + 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("site", L0_ACT_SITES, ids=lambda s: f"{s[0]}x{s[1]}{'b' if s[3] else ''}")
def test_nf_act_matches_plain_version_on_card(cuda_device, site, batch):
    c, h, w, has_bias = site
    gen = torch.Generator(device=cuda_device).manual_seed(c * 1000 + h + batch)
    x = _nhwc(gen, (batch, c, h, w), cuda_device, 2.0)
    bias = torch.randn(c, generator=gen, device=cuda_device) if has_bias else None
    dy = _nhwc(gen, (batch, c, h, w), cuda_device)
    scale = 1.7881293296813965
    before = nf_fused.launches.copy()
    y = nf_fused._act_kernel(x.contiguous(memory_format=torch.channels_last), bias, scale)
    dx, db = nf_fused._act_grad_kernel(dy.contiguous(memory_format=torch.channels_last), x, bias, scale)
    torch.cuda.synchronize()
    assert nf_fused.launches - before == {"nf_act_fwd": 1, "nf_act_bwd": 1, **({"nf_colsum": 1} if has_bias else {})}
    z_mag = x.float().abs() + (0.0 if bias is None else bias.abs().view(1, -1, 1, 1))
    _within_one_ulp(y, nf_fused.nf_act_reference(x.float(), bias, scale), scale * z_mag)
    want_dx, want_db = nf_fused.nf_act_grad_reference(dy.float(), x.float(), bias, scale)
    _within_one_ulp(dx, want_dx, dy.float().abs() * scale * (1.0 + z_mag))
    if has_bias:
        _close_sum(db, want_db)
    else:
        assert db is None


@pytest.mark.cuda
@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("eca", [True, False], ids=["eca", "no_attn"])
@pytest.mark.parametrize("tail", L0_TAILS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_nf_tail_matches_plain_version_on_card(cuda_device, tail, eca, batch):
    c, h, w = tail
    gen = torch.Generator(device=cuda_device).manual_seed(c + h + batch + eca)
    shape = (batch, c, h, w)
    hh, sc, dy = _nhwc(gen, shape, cuda_device), _nhwc(gen, shape, cuda_device), _nhwc(gen, shape, cuda_device)
    bias = torch.randn(c, generator=gen, device=cuda_device) * 0.2
    wt = torch.randn((1, 1, 3), generator=gen, device=cuda_device) if eca else None
    gain = torch.full((), 0.5, device=cuda_device)
    mask = torch.rand(batch, generator=gen, device=cuda_device) < 0.85
    mask[0], mask[-1] = True, False
    k = 0.2 * (2.0 if eca else 1.0) / 0.85
    hh[-1, 0, 0, 0] = float("nan")  # a dropped sample's branch: the output is exactly its shortcut
    before = nf_fused.launches.copy()
    args = [t.contiguous(memory_format=torch.channels_last) for t in (hh, sc)]
    out, m = nf_fused._tail_kernel(args[0], bias, args[1], wt, gain, mask, k)
    dh, db, dw, dgain = nf_fused._tail_grad_kernel(dy.contiguous(memory_format=torch.channels_last), args[0], bias, m,
                                                    wt, gain, mask, k)
    torch.cuda.synchronize()
    want_launches = {"nf_tail_fwd": 1, "nf_tail_sums": 1, "nf_tail_gate_bwd": 1, "nf_tail_bwd": 1, "nf_colsum": 1}
    assert nf_fused.launches - before == ({"nf_tail_mean": 1, **want_launches} if eca else want_launches)
    want, want_m = nf_fused.nf_tail_reference(hh.float(), bias, sc.float(), wt, gain, mask, k)
    assert torch.equal(out[~mask], sc[~mask])
    kmax = k * float(gain)  # k_b g <= kmax
    mag = sc.float().abs() + kmax * (hh.float().abs() + bias.abs().view(1, -1, 1, 1))
    _within_one_ulp(out[mask], want[mask], mag[mask])
    if eca:
        torch.testing.assert_close(m, want_m, rtol=1e-5, atol=1e-5)
    wdh, wdb, wdw, wdgain = nf_fused.nf_tail_grad_reference(dy.float(), hh.float(), bias, want_m, wt, gain, mask, k)
    assert torch.equal(dh[~mask], torch.zeros_like(dh[~mask]))
    # dm / HW, in dh, comes from sums over H*W in another order: float32 tolerance
    _within_one_ulp(dh[mask], wdh[mask], (dy.float().abs() * kmax + wdh.abs())[mask], rel=1e-4)
    _close_sum(db, wdb)
    _close_sum(dgain, wdgain)
    if eca:
        _close_sum(dw, wdw)


@pytest.mark.cuda
@pytest.mark.parametrize("dy_layout", ["same", "other"])
def test_nf_ws_matches_plain_version_on_card(cuda_device, dy_layout):
    """Every distinct conv weight of eca_nfnet_l0 (channels-last, as the trainer holds it), alone and in
    groups of ``MAX_WS`` in one launch, the weight's gradient in its layout or in the other (copied to the
    weight's rows first)."""
    model = _model(cuda_device)
    convs = {}
    for mod in model.modules():
        if isinstance(mod, layers.ScaledStdConv):
            convs.setdefault(tuple(mod.weight.shape), mod)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    cases = []
    for shape, conv in convs.items():
        gain = torch.rand(shape[0], generator=gen, device=cuda_device) * 2.0 + 0.1
        dy = torch.randn(shape, generator=gen, device=cuda_device).to(torch.bfloat16)
        dy = dy.contiguous(memory_format=torch.contiguous_format if dy_layout == "other" else torch.channels_last)
        cases.append((conv, conv.weight.detach(), gain if len(cases) % 3 else None, dy))
    groups = [[c] for c in cases] + [cases[i : i + nf_fused.MAX_WS] for i in range(0, len(cases), nf_fused.MAX_WS)]
    for group in groups:
        convs_, ws, gains, dys = zip(*group)
        scales, epss = [c.scale for c in convs_], [c.eps for c in convs_]
        before = nf_fused.launches.copy()
        ys, stats = nf_fused._ws_kernel(ws, gains, scales, epss)
        dws, dgains = nf_fused._ws_grad_kernel(dys, ws, gains, stats, scales)
        torch.cuda.synchronize()
        assert nf_fused.launches - before == {"nf_ws_fwd": 1, "nf_ws_bwd": 1}, len(group)
        for conv, w, gain, dy, y, dw, dgain in zip(convs_, ws, gains, dys, ys, dws, dgains):
            shape = tuple(w.shape)
            assert y.stride() == w.stride() and dw.stride() == w.stride(), shape
            want = nf_fused.nf_ws_reference(w, gain, conv.scale, conv.eps)
            # w - mean cancels: the two float32 means (the kernel's and var_mean's) differ in their last bits
            var, mean = torch.var_mean(w, dim=(1, 2, 3), keepdim=True, correction=0)
            a = torch.rsqrt(var + conv.eps) * conv.scale * (1.0 if gain is None else gain.view(-1, 1, 1, 1))
            _within_one_ulp(y, want, (w.abs() + mean.abs()) * a)
            want_dw, want_dgain = nf_fused.nf_ws_grad_reference(dy.float(), w, gain, conv.scale, conv.eps)
            _close_sum(dw, want_dw)
            if gain is None:
                assert dgain is None
            else:
                _close_sum(dgain, want_dgain)


def _model(device, dtype=torch.bfloat16, drop_path_rate=0.15, seed=0):
    model = nfnet.eca_nfnet_l0(drop_rate=0.2, drop_path_rate=drop_path_rate, dtype=dtype)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for blk in model.blocks:
            blk.skipinit_gain.fill_(0.5)  # every branch trains, as the benchmark's seeded weights
    return model.to(device=device, memory_format=torch.channels_last).train()


def _grads(model, images, labels, gen_seed, device):
    """Loss and every leaf's gradient of two microbatches, the drop masks from a seeded generator."""
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    layers.bind_generator(model, gen)
    model.zero_grad(set_to_none=True)
    losses = []
    for im, lb in zip(images.chunk(2), labels.chunk(2)):
        loss = F.cross_entropy(model(im), lb)
        loss.backward()
        losses.append(float(loss.detach()))
    return sum(losses) / 2, {n: p.grad.float().clone() for n, p in model.named_parameters()}


def structural_launches(model) -> int:
    """nf_fused's launches in one forward and backward of ``model`` (an NFNet
    in training, every block dropping samples): each SiLU site 1 forward and
    1 backward, plus the bias's column sum where it has one (all but the
    pre-activations); each tail 2 forward with ECA (pool, apply), 1 without,
    and 4 backward (sums, gate, apply, column sum); the weight
    standardisation 1 forward and 1 backward for each block's convs, and
    once for the stem's and the final conv's together."""
    sites = 3 + 1  # the stem's three, the final conv's
    n = sites * (1 + 2) + 2 * (1 + len(model.blocks))
    for blk in model.blocks:
        n += (1 + 1) + 3 * (1 + 2)  # pre-activation, conv1/conv2/conv2b
        n += (2 if blk.attn is not None else 1) + 4
    return n


@pytest.mark.cuda
def test_nfnet_step_through_kernels_matches_chain_on_card(cuda_device, monkeypatch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    images = torch.randn((2 * 32, 224, 224, 3), generator=gen, device=cuda_device)
    labels = torch.randint(0, 1000, (64,), generator=gen, device=cuda_device)
    model = _model(cuda_device)
    nf_fused.fallbacks.clear()
    before = nf_fused.launches.copy()
    loss_k, g_k = _grads(model, images, labels, 11, cuda_device)
    torch.cuda.synchronize()
    assert sum((nf_fused.launches - before).values()) == 2 * structural_launches(model)
    assert not nf_fused.fallbacks
    monkeypatch.setattr(nfnet, "kernel_path", lambda *a, **k: "test")
    loss_c, g_c = _grads(model, images, labels, 11, cuda_device)
    f32 = _model(cuda_device, dtype=torch.float32)
    loss_f, g_f = _grads(f32, images.float(), labels, 11, cuda_device)
    # the kernels round once where the chain rounds after every op: at least as close to float32 as the chain
    err_k, err_c = abs(loss_k - loss_f), abs(loss_c - loss_f)
    print(f"loss: kernels {loss_k:.6f} chain {loss_c:.6f} float32 {loss_f:.6f}")
    assert err_k <= 1.5 * err_c + 1e-4 * abs(loss_f), (err_k, err_c)
    ratios = {}
    for n in g_f:
        ref = max(float(g_f[n].norm()), 1e-12)
        ek, ec = float((g_k[n] - g_f[n]).norm()) / ref, float((g_c[n] - g_f[n]).norm()) / ref
        ratios[n] = (ek, ec)
        assert float((g_k[n] - g_c[n]).norm()) / ref <= 2.0 * ec + 0.02, (n, ek, ec)
    worst = sorted(ratios.items(), key=lambda kv: -kv[1][0])[:5]
    print("leaf gaps to float32 (kernels, chain), worst five:", worst)
    med_k = sorted(v[0] for v in ratios.values())[len(ratios) // 2]
    med_c = sorted(v[1] for v in ratios.values())[len(ratios) // 2]
    print(f"median leaf gap to float32: kernels {med_k:.4g} chain {med_c:.4g}")
    assert med_k <= med_c


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "convs"])
def test_nfnet_remat_over_kernels_on_card(cuda_device, remat):
    sgd = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    batch = {"image": torch.randn((32, 224, 224, 3), generator=gen, device=cuda_device),
             "label": torch.eye(1000, device=cuda_device)[:32]}
    out = {}
    for r in (False, remat):
        model = nfnet.eca_nfnet_l0(drop_path_rate=0.15, dtype=torch.bfloat16)
        state = steps.init_state(model, lambda m: build_optimizer(sgd, m.named_parameters()), device=cuda_device)
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda s: 0.1, accumulate_steps=2, remat=r)
        nf_fused.fallbacks.clear()
        before = nf_fused.launches.copy()
        torch.cuda.reset_peak_memory_stats()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        assert not nf_fused.fallbacks
        out[r] = (float(metrics["loss"]), {n: p.grad.float().clone() for n, p in state.model.named_parameters()},
                  torch.cuda.max_memory_allocated(), sum((nf_fused.launches - before).values()))
        del state, step
    loss0, g0, peak0, n0 = out[False]
    loss1, g1, peak1, n1 = out[remat]
    assert math.isclose(loss0, loss1, rel_tol=1e-3), (loss0, loss1)
    for n in g0:
        ref = max(float(g0[n].norm()), 1e-12)
        assert float((g1[n] - g0[n]).norm()) / ref < 0.05, n
    assert n1 > n0  # the recompute launches the forward kernels again
    assert peak1 < peak0, (peak1, peak0)
