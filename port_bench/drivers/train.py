"""The training window: the port's own loop (``Runner.fit``) over the feed
that ``DataManager`` builds from the cell's config, fed by the benchmark's
seeded images.

Set-up builds one run as the port's CLI builds it, loads the weights the
benchmark made from the seed, and drives the first ``check_steps`` steps
through the window's own call and feed while spies record the program's
random draws and its outputs. Those steps' readings (each step's loss, the
first gradient as the optimizer's state holds it, the change of every leaf
after the steps) are kept; the same object then runs the window. Once the
window has closed and the program's state is freed, a plain PyTorch
reference follows the same steps from the benchmark's own images and
weights, and the two sets of readings are compared.

Traffic parameters (``traffic/<name>.json``):
  feed         "cache": the images are filled into the card through
               ``DeviceCacheFeed`` and gathered every step; "host": a pool of
               batches goes through ``DeviceFeed`` (pinned memory, a copy on
               a side stream) every step
  images       distinct images (cache: the whole cached set; host: the pool)
  check_steps  steps the reference follows (3)
  warm_steps   steps timed after them to size the window
  trace_skip   steps of the traced fit before the profiler starts (the feed's start)
  trace_steps  steps the profiler traces with --trace 1
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Dict, List

from port_bench import harness
from port_bench.drivers import common


HOST_TRACE_STEPS = 3  # steps traced with the host's ops (the profiler slows a launch-heavy host)

# ----------------------------------------------------------------- spying ---


class Spies:
    """Records, while ``on``, what the program drew and produced in each
    step: the uint8 rows the augment got, the augment's uniforms and blur
    sigmas, the augmented batch, the mixup draws, the drop masks, and the
    step's loss; and the optimizer's first moments after the first step."""

    def __init__(self):
        from sota_imagenet_tpu_torch.train.callbacks import Callback

        spies = self

        class Recorder(Callback):
            def on_batch_end(self, step, metrics):
                if spies.tick is not None:
                    spies.tick()
                if spies.on:
                    spies.pending["loss"] = metrics["loss"].detach().clone()
                    if not spies.steps:
                        spies.first = first_moments(self.runner.state)
                    spies.steps.append(spies.pending)
                    spies.pending = {"masks": []}

        self.callback = Recorder()
        self.tick = None  # the profiler's step, while a window is traced
        self.on = False
        self.steps: List[dict] = []
        self.pending: dict = {"masks": []}
        self.first: Dict[str, object] = {}

    @contextlib.contextmanager
    def recording(self, feed):
        from sota_imagenet_tpu_torch.models import layers
        from sota_imagenet_tpu_torch.ops import augment as aug_mod
        from sota_imagenet_tpu_torch.ops import fused_aug
        from sota_imagenet_tpu_torch.train import steps as steps_mod

        real_aug, real_u = feed.augment, fused_aug.scalars_from_uniform
        real_blur, real_mix = aug_mod._batch_gaussian_blur, steps_mod.draw_cutmix_mixup
        real_mask = layers.draw_keep_mask

        def augment(generator, images_u8, labels, *rest):
            self.pending["u8"], self.pending["labels"] = images_u8.clone(), labels.clone()
            out = real_aug(generator, images_u8, labels, *rest)
            self.pending["out"], self.pending["out_label"] = out["image"].clone(), out["label"].clone()
            return out

        def scalars_from_uniform(u, **kw):
            self.pending["u"] = u.clone()
            return real_u(u, **kw)

        def blur(images, sigmas, *a, **kw):
            self.pending["sigmas"] = sigmas.clone()
            return real_blur(images, sigmas, *a, **kw)

        def draw_mix(*a, **kw):
            d = real_mix(*a, **kw)
            self.pending["mix"] = {k: v.clone() for k, v in d.items()}
            return d

        def draw_mask(*a, **kw):
            m = real_mask(*a, **kw)
            self.pending["masks"].append(m.clone())
            return m

        feed.augment = augment
        fused_aug.scalars_from_uniform, aug_mod._batch_gaussian_blur = scalars_from_uniform, blur
        steps_mod.draw_cutmix_mixup, layers.draw_keep_mask = draw_mix, draw_mask
        self.on = True
        try:
            yield self
        finally:
            self.on = False
            feed.augment = real_aug
            fused_aug.scalars_from_uniform, aug_mod._batch_gaussian_blur = real_u, real_blur
            steps_mod.draw_cutmix_mixup, layers.draw_keep_mask = real_mix, real_mask


def first_moments(state) -> Dict[str, object]:
    """The first gradient as the optimizer holds it after one step: SGD's
    momentum buffer (gradient plus coupled decay), or Adam's first moment
    over (1 - beta1); a norm per named parameter."""
    import torch

    out = {}
    opt = state.optimizer
    groups = {id(p): g for g in opt.param_groups for p in g["params"]}
    for name, p in state.model.named_parameters():
        st = opt.state.get(p, {})
        if "momentum_buffer" in st:
            out[name] = torch.linalg.vector_norm(st["momentum_buffer"].float())
        elif "exp_avg" in st:
            out[name] = torch.linalg.vector_norm(st["exp_avg"].float()) / (1.0 - groups[id(p)]["betas"][0])
    return out


def leaf_changes(torch, model, ema, w0: dict) -> Dict[str, object]:
    out = {}
    for prefix, m in (("", model), ("ema.", ema)):
        if m is None:
            continue
        sd = m.state_dict()
        for n, v0 in w0.items():
            out[prefix + n] = torch.linalg.vector_norm(sd[n].float() - v0)
    return out


# ------------------------------------------------------------------ build ---


def build(ctx: dict):
    """Config, model, optimizer, Runner and DataManager as the port's CLI
    builds them; the benchmark's weights loaded; the feed's host loader
    replaced by the benchmark's seeded images."""
    import torch

    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.config import instantiate, parse_stages
    from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
    from sota_imagenet_tpu_torch.data.pipeline import DataManager, DeviceFeed
    from sota_imagenet_tpu_torch.models.norms import resolve_bn_stats, set_bn_stats_groups
    from sota_imagenet_tpu_torch.train.loop import Runner
    from sota_imagenet_tpu_torch.train.schedule import phases_from_stages

    seed, device, traffic = ctx["seed"], ctx["device"], ctx["traffic"]
    cfg, cspec = common.load_config(ctx["cell"]["config"], ctx.get("overrides", ()))
    common.backend_flags(torch, device)
    set_bn_stats_groups(resolve_bn_stats(cfg.run.bn_stats, 1))
    prog_seed = harness.sub_seed(seed, 2)
    input_dtype = torch.bfloat16 if cfg.run.bf16 else torch.float32
    model = cli.build_model(cfg)
    spies = Spies()
    runner = Runner(
        model, instantiate(cfg.criterion), cli.optimizer_factory(cfg, model),
        lr_phases=phases_from_stages(parse_stages(cfg.run.stages)),
        callbacks=[*(instantiate(c) for c in cfg.run.extra_callbacks or []), spies.callback],
        accumulate_steps=cfg.run.accumulate_steps, ema_decay=cfg.run.ema_decay, remat=cfg.run.remat,
        input_dtype=input_dtype, device=device, debug_nans=cfg.debug_nans, tp_params=cfg.mesh.tp_params,
    )
    runner.init_state(seed=prog_seed)
    marks = ctx.setdefault("marks", {})
    marks["model_built"] = time.time()
    arch = cspec["arch"]
    shapes = common.reference_shapes(arch, **cspec.get("reference_kwargs", {}))
    w0 = harness.make_weights(torch, shapes, seed, device, arch)
    if set(shapes) != set(runner.state.model.state_dict()):
        raise RuntimeError("the program's state dict names differ from the reference's")
    runner.state.model.load_state_dict(w0)
    if runner.state.ema is not None:
        runner.state.ema.load_state_dict(w0)
    marks["weights_loaded"] = time.time()
    dm = DataManager(cfg, device=device, seed=harness.sub_seed(seed, 3), out_dtype=input_dtype)
    dm.set_stage(0)
    marks["data_manager"] = time.time()
    feed = dm.loader
    accum = int(cfg.run.accumulate_steps or 1)
    batch = int(cfg.loader.batch_size) * accum
    size, n = int(cfg.loader.image_size), int(traffic["images"])
    if traffic["feed"] == "cache":
        # every cached image once, filled at the first fit as the recipe's packed records would be
        images = common.SeededImages(torch, n, batch, size, seed, device)
        if not isinstance(feed, DeviceCacheFeed) or feed.images is not None:
            raise RuntimeError("the config's train feed is not an unfilled DeviceCacheFeed")
        feed._host = images
    else:
        # a pool of batches in host memory, handed out round and round for as long as the window asks
        images = common.SeededImages(torch, n, batch, size, seed, device, length=10 ** 9, keep=True)
        if not isinstance(feed, DeviceFeed):
            raise RuntimeError("the config's train feed is not a DeviceFeed")
        feed.host = images
    return {"cfg": cfg, "cspec": cspec, "runner": runner, "feed": feed, "dm": dm, "spies": spies, "w0": w0,
            "arch": arch, "batch": batch, "images": images, "input_dtype": input_dtype}


# ------------------------------------------------------------------ window ---


def prove(b: dict, ctx: dict) -> dict:
    """The first steps through the window's own call and feed, recorded."""
    import torch

    runner, feed, spies = b["runner"], b["feed"], b["spies"]
    n = int(ctx["traffic"]["check_steps"])
    with spies.recording(feed), ctx.get("fault", contextlib.nullcontext)():
        runner.fit(feed, None, epochs=1, start_epoch=0, steps_per_epoch=n)
    if len(spies.steps) != n:
        raise RuntimeError(f"recorded {len(spies.steps)} steps of {n}")
    state = runner.state
    changes = leaf_changes(torch, state.model, state.ema, b["w0"])
    readings = {
        "losses": [float(s["loss"]) for s in spies.steps],
        "first": {k: float(v) for k, v in spies.first.items()},
        "change": {k: float(v) for k, v in changes.items()},
    }
    # the draws and outputs, to the host until the reference reads them
    steps = []
    for s in spies.steps:
        steps.append({k: (v.cpu() if hasattr(v, "cpu") else
                          [m.cpu() for m in v] if isinstance(v, list) else
                          {kk: vv.cpu() for kk, vv in v.items()} if isinstance(v, dict) else v)
                      for k, v in s.items()})
    spies.steps = []
    del b["w0"]
    return {"readings": readings, "steps": steps}


def window(b: dict, ctx: dict) -> dict:
    import torch

    runner, feed, traffic, dev = b["runner"], b["feed"], ctx["traffic"], ctx["device"]
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    epoch = [1]

    def fit(steps=None) -> int:
        runner.fit(feed, None, epochs=epoch[0] + 1, start_epoch=epoch[0], steps_per_epoch=steps)
        epoch[0] += 1
        return steps or len(feed)

    warm = int(traffic["warm_steps"])
    sync()
    t = time.perf_counter()
    fit(warm)
    sync()
    step_s = (time.perf_counter() - t) / warm
    common.settle()
    out = {"cache_fill_s": getattr(feed, "fill_s", None)}
    if ctx["trace"]:
        def traced(tick, steps):
            b["spies"].tick = tick
            try:
                fit(steps)
            finally:
                b["spies"].tick = None

        skip, n = int(traffic["trace_skip"]), int(traffic["trace_steps"])
        summary = harness.profile(torch, traced, ctx["trace_path"], False, skip, n)
        tm = dict(runner.train_metrics)
        # a few steps more with the host's ops, for the optimizer's scope and what the host did in the gaps
        summary["host"] = harness.profile(torch, traced, ctx["trace_path"], True, skip, HOST_TRACE_STEPS)
        summary.update(data_time_s=tm.get("data_time_s"), epoch_time_s=tm.get("epoch_time_s"),
                       images=n * b["batch"], img_per_s=n * b["batch"] / summary["window_s"])
        out["summary"] = summary
        return out
    seconds = ctx["seconds"]
    wall0 = time.time()
    t0 = time.perf_counter()
    steps = 0
    if traffic["feed"] == "cache":
        epochs = max(1, math.ceil(seconds / (step_s * len(feed))))
        for _ in range(epochs):
            steps += fit()
    else:
        steps = fit(max(1, math.ceil(seconds / step_s)))
    sync()
    t1 = time.perf_counter()
    out.update(window_start=wall0, window_s=t1 - t0, steps=steps, images=steps * b["batch"])
    return out


# --------------------------------------------------------------- reference ---


def reference_readings(ctx: dict, info: dict, proof: dict, quant=None) -> dict:
    """The reference's readings over the recorded steps (``quant``: the
    control's lower precision on every conv and linear). Steps whose
    recorded draws do not fit the reference's own (a batch of another size,
    masks of another shape) give no readings: every number is then inf."""
    try:
        return _reference_readings(ctx, info, proof, quant)
    except DrawMismatch as e:
        inf = float("inf")
        return {"losses": [inf], "first": {}, "change": {}, "rows_unmatched": 0, "augment_gap": inf, "error": str(e)}


class DrawMismatch(RuntimeError):
    pass


def _reference_readings(ctx: dict, info: dict, proof: dict, quant=None) -> dict:
    import torch

    from port_bench.reference import models
    from port_bench.reference import train as R

    dev, seed, cfg, cspec = ctx["device"], ctx["seed"], info["cfg"], info["cspec"]
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.benchmark = False  # heuristic picks: no autotuning of shapes used once
    arch = cspec["arch"]
    kw = cspec.get("reference_kwargs", {})
    model = models.build(arch, **kw).to(dev)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w0 = harness.make_weights(torch, shapes, seed, dev, arch)
    model.load_state_dict(w0)
    if quant is not None:
        models.set_quant(model, quant)
    params = dict(model.named_parameters())
    ema_decay = float(cfg.run.ema_decay or 0.0)
    ema = {k: v.clone() for k, v in model.state_dict().items()} if ema_decay else None
    wd = float(cfg.optim.get("weight_decay", 0.0))
    skip = [s.lower() for s in (cfg.filter_from_wd or [])] if cfg.filter_from_wd is not None else None
    decay = {n: (wd if skip is None or not (p.dim() <= 1 or any(s in n.lower() for s in skip)) else 0.0)
             for n, p in params.items()}
    kind = cfg.optim["_target_"].lower()
    hp = {"momentum": float(cfg.optim.get("momentum", 0.0)),
          "betas": tuple(cfg.optim.get("betas", (0.9, 0.999))), "eps": float(cfg.optim.get("eps", 1e-8))}
    opt = R.Optimizer("sgd" if kind == "sgd" else "adamw", params, decay, hp)
    phases = [dict(ep=(s["start"], s["end"]), lr=tuple(s["lr"]), mode=s.get("lr_mode", "linear"))
              for s in cfg.run.stages]
    smoothing = float(cfg.criterion.get("smoothing", 0.0))
    accum = int(cfg.run.accumulate_steps or 1)
    rows = int(cspec.get("reference_rows", 0))
    lcfg = cfg.loader
    aug = {"color_twist_prob": float(lcfg.color_twist_prob), "gray_prob": float(lcfg.gray_prob),
           "re_prob": float(lcfg.re_prob), "re_count": int(lcfg.re_count),
           "contrast_range": tuple(lcfg.contrast_range), "brightness_range": tuple(lcfg.brightness_range)}
    mix_cfg = next((c for c in cfg.run.extra_callbacks or [] if c["_target_"] == "CutmixMixup"), None)
    data = info["images"]
    # every distinct image's fingerprint, to find the rows the program fed
    fp_index: Dict[int, int] = {}
    for j in range(data.n_batches):
        imgs, _ = data.device_batch(j)
        for i, f in enumerate(common.fingerprints(torch, imgs).tolist()):
            fp_index[f] = j * data.batch_size + i
    losses, unmatched, aug_gap = [], 0, 0.0
    n_steps = len(proof["steps"])
    for k, st in enumerate(proof["steps"]):
        fed = st["u8"].to(dev)
        want = [fp_index.get(f, -1) for f in common.fingerprints(torch, fed).tolist()]
        raw = fed.clone()
        labels = st["labels"].to(dev).clone()
        made = {}
        for r, idx in enumerate(want):
            if idx < 0:
                unmatched += 1
                continue
            j = idx // data.batch_size
            if j not in made:
                made[j] = data.device_batch(j)
            raw[r], labels[r] = made[j][0][idx % data.batch_size], made[j][1][idx % data.batch_size]
        del made
        unmatched += int((raw != fed).flatten(1).any(1).sum()) + int((labels.cpu() != st["labels"].long()).sum())
        # the augment: blur (if drawn) and mirror are read off the program's output, row by row
        x = raw.to(torch.float32)
        u = st["u"].to(dev)
        cands = [R.twist_gray_erase_normalize(x, u, aug)]
        if "sigmas" in st:
            blurred = R.u8_round(R.gaussian_blur(x, st["sigmas"].to(dev)))
            cands.append(R.twist_gray_erase_normalize(blurred, u, aug))
        cands = [c2 for c in cands for c2 in (c, c.flip(2))]
        prog = st["out"].to(dev).float()
        dist = torch.stack([(c - prog).abs().flatten(1).amax(1) for c in cands])  # (cands, B)
        best = dist.argmin(0)
        images = torch.stack([cands[int(best[r])][r] for r in range(prog.shape[0])])
        aug_gap = max(aug_gap, float(dist.min(0).values.max()) * R.STD)
        soft = torch.nn.functional.one_hot(labels, int(lcfg.num_classes)).float()
        if mix_cfg is not None:
            images, soft = R.cutmix_mixup(images, soft, {kk: vv.to(dev) for kk, vv in st["mix"].items()})
        masks = list(st["masks"])
        per_forward = len(masks) // accum
        if hasattr(model, "set_masks"):
            model.set_masks(None)
        model.train()
        for p in params.values():
            p.grad = None
        mb = images.shape[0] // accum
        total = 0.0
        for a in range(accum):
            im, lb = images[a * mb:(a + 1) * mb], soft[a * mb:(a + 1) * mb]
            site_masks, masks = masks[:per_forward], masks[per_forward:]
            chunk = rows or mb
            for c in range(0, mb, chunk):
                if hasattr(model, "set_masks"):
                    model.set_masks(mask_reader(site_masks, c, chunk, dev))
                loss = R.smoothed_ce(model(im[c:c + chunk]), lb[c:c + chunk], smoothing) * (min(chunk, mb - c) / mb)
                loss.backward()
                total += float(loss.detach())
        if masks:
            raise DrawMismatch(f"{len(masks)} drop masks left over in step {k}")
        grads = {n: p.grad / accum for n, p in params.items()}
        losses.append(total / accum)
        with torch.no_grad():
            opt.step(grads, R.phase_lr(phases, k, n_steps))
            if ema is not None:
                for n, v in model.state_dict().items():
                    ema[n].mul_(ema_decay).add_(v, alpha=1.0 - ema_decay)
    with torch.no_grad():
        first = {n: float(torch.linalg.vector_norm(opt.state[n]["first"])) for n in params}
        change = {n: float(torch.linalg.vector_norm(v.float() - w0[n])) for n, v in model.state_dict().items()}
        if ema is not None:
            change.update({"ema." + n: float(torch.linalg.vector_norm(v - w0[n])) for n, v in ema.items()})
    return {"losses": losses, "first": first, "change": change, "rows_unmatched": unmatched, "augment_gap": aug_gap}


def mask_reader(site_masks: list, start: int, rows: int, dev):
    """The drop masks of one microbatch's forward, in the order the forward
    draws them, each cut to the rows [start, start + rows)."""
    queue = list(site_masks)

    def take(keep, shape):
        m = queue.pop(0)[start:start + rows].to(dev)
        if tuple(m.shape) != tuple(shape):
            raise DrawMismatch(f"drop mask of shape {tuple(m.shape)} where the reference draws {shape}")
        return m

    return take


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap; the worst
    leaf's gap of first-gradient norms and of change norms, each against the
    larger of that leaf's reference norm and the median leaf's. Parameters
    whose reference gradient is under a thousandth of the median leaf's are
    left out of both, with their EMA copies."""
    import numpy as np

    from port_bench.reference.train import worst_leaf_gap

    if "error" in ref or "error" in prog:
        inf = float("inf")
        return {k: inf for k in ("loss_gap", "loss_gap_first", "grad_gap", "change_gap", "grad_gap_median",
                                 "change_gap_median")} | {"error": ref.get("error", prog.get("error"))}
    med = float(np.median(list(ref["first"].values())))
    dead = {n for n, v in ref["first"].items() if v < 1e-3 * med}
    live = set(ref["first"]) - dead
    keep_change = {n for n in ref["change"] if n.split("ema.", 1)[-1] not in dead}
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    grad, grad_at = worst_leaf_gap(prog["first"], ref["first"], live)
    change, change_at = worst_leaf_gap(prog["change"], ref["change"], keep_change)
    return {"loss_gap": max(loss), "loss_gap_first": loss[0], "grad_gap": grad, "change_gap": change,
            "grad_gap_median": median_leaf_gap(prog["first"], ref["first"], live),
            "change_gap_median": median_leaf_gap(prog["change"], ref["change"], keep_change),
            "grad_gap_leaf": grad_at, "change_gap_leaf": change_at, "left_out": sorted(dead)}


def median_leaf_gap(prog: dict, ref: dict, keep: set) -> float:
    """The median over leaves of |prog - ref| / ref: a number that one small leaf cannot move."""
    import numpy as np

    return float(np.median([abs(prog[n] - ref[n]) / max(ref[n], 1e-30) for n in ref if n in keep]))


def run(ctx: dict) -> dict:
    import torch

    b = build(ctx)
    ctx["marks"]["built"] = time.time()
    proof = prove(b, ctx)
    ctx["marks"]["proved"] = time.time()
    win = window(b, ctx)
    ctx["marks"]["window_end"] = time.time()
    dev = ctx["device"]
    count = 1
    device = harness.device_info(torch, dev, count)
    info = {k: b[k] for k in ("cfg", "cspec", "images", "batch")}
    b.clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(ctx, info, proof)
    ctx["marks"]["reference_end"] = time.time()
    g = gaps(proof["readings"], ref)
    return {"window": win, "device": device, "gaps": g, "ref": ref, "prog": proof["readings"], "info": info,
            "proof": proof, "ctx": ctx}
