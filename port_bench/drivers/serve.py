"""The serving window: the artifact of the port's exporter, loaded by
``utils/export.load_exported``, driven by one client in a closed loop.

The exported program takes the weights as an input, so only the program is
cached (in the checkout, keyed by the port's model and export sources and
torch's version); the weights are made from the seed every run, written in
the artifact's format and loaded as a server loads them. Each request is a
batch of seeded uint8 images in pinned host memory, timed from the call to
its logits on the host. Requests drawn from the seed keep their logits;
once the window has closed, a plain float32 reference scores the same
images and the served logits are compared with its.

Traffic parameters (``traffic/<name>.json``):
  batch          images a request
  pool_batches   distinct request batches, sent round and round
  sample_every   about one request in this many keeps its logits
  warm_batches   requests before the window
  trace_batches  requests the profiler traces with --trace 1
"""

from __future__ import annotations

import gc
import hashlib
import os
import random
import shutil
import tempfile
import time
from pathlib import Path

from port_bench import harness
from port_bench.drivers import common


HOST_TRACE_BATCHES = 5  # requests traced with the host's ops as well


def program_dir(cfg, cspec: dict, batch: int, size: int, dtype_name: str) -> Path:
    """The exported program of this config and shape, made once a checkout."""
    import torch

    import sota_imagenet_tpu_torch as pkg

    src = Path(pkg.__file__).resolve().parent
    h = hashlib.sha256(torch.__version__.encode())
    for p in sorted([*(src / "models").glob("*.py"), src / "utils" / "export.py"]):
        h.update(p.read_bytes())
    out = harness.CACHE / "export" / f"{cspec['arch']}-b{batch}-s{size}-{dtype_name}-{h.hexdigest()[:12]}"
    if (out / "model.pt2").exists():
        return out
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch.utils.export import export_inference

    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    model = cli.build_model(cfg)
    export_inference(model, str(tmp), image_size=size, batch_size=batch,
                     input_dtype=getattr(torch, dtype_name))
    (tmp / "params.npz").unlink()  # the program only: weights come from the seed
    shutil.rmtree(out, ignore_errors=True)
    os.replace(tmp, out)
    return out


def load_served(torch, prog: Path, weights: dict, workdir: str, cfg, quantize=None):
    """The artifact as a server finds it: the cached program beside the
    seeded weights in the exporter's own format, loaded by ``load_exported``."""
    from sota_imagenet_tpu_torch.utils.export import load_exported, quantizable, save_params

    art = os.path.join(workdir, "artifact")
    os.makedirs(art, exist_ok=True)
    for name in ("model.pt2", "meta.json"):
        shutil.copyfile(prog / name, os.path.join(art, name))
    state = {k: v.detach().cpu() for k, v in weights.items()}
    dims = None
    if quantize:
        from sota_imagenet_tpu_torch import cli

        dims = quantizable(cli.build_model(cfg))
    save_params(os.path.join(art, "params.npz"), state, quantize=quantize, channel_dims=dims)
    return load_exported(art, device=weights[next(iter(weights))].device)


def run(ctx: dict) -> dict:
    import torch

    from port_bench.reference import models

    dev, seed, traffic = ctx["device"], ctx["seed"], ctx["traffic"]
    cfg, cspec = common.load_config(ctx["cell"]["config"], ctx.get("overrides", ()))
    common.backend_flags(torch, dev)
    batch, size = int(traffic["batch"]), int(cfg.loader.image_size)
    dtype_name = "bfloat16" if cfg.run.bf16 else "float32"
    arch = cspec["arch"]
    shapes = common.reference_shapes(arch, **cspec.get("reference_kwargs", {}))
    weights = harness.make_weights(torch, shapes, seed, dev, arch)
    prog = program_dir(cfg, cspec, batch, size, dtype_name)
    workdir = tempfile.mkdtemp(prefix="port_bench_serve_")
    try:
        serve, _ = load_served(torch, prog, weights, workdir, cfg, quantize=ctx.get("quantize"))
        fault = ctx.get("fault")
        if fault is not None:
            serve = fault(serve)
        del weights
        pool = common.SeededImages(torch, batch * int(traffic["pool_batches"]), batch, size, seed, dev, keep=True)
        reqs = [torch.from_numpy(x) for x, _ in pool._kept]
        if dev.type == "cuda":
            reqs = [r.pin_memory() for r in reqs]
        ctx["marks"]["loaded"] = time.time()
        for i in range(int(traffic["warm_batches"])):
            serve(reqs[i % len(reqs)]).cpu()
        rng = random.Random(harness.sub_seed(seed, 5))
        every = int(traffic["sample_every"])
        kept, lat = {}, []

        def loop(n=None, seconds=None, tick=None):
            wall0 = time.time()
            t0 = time.perf_counter()
            i = 0
            while (n is not None and i < n) or (seconds is not None and time.perf_counter() - t0 < seconds):
                j = i % len(reqs)
                t = time.perf_counter()
                logits = serve(reqs[j]).cpu()
                lat.append(time.perf_counter() - t)
                if rng.randrange(every) == 0 or i == 0:
                    kept.setdefault(j, []).append(logits)
                i += 1
                if tick is not None:
                    tick()
            return i, wall0, t0

        common.settle()
        out = {}
        if ctx["trace"]:
            n = int(traffic["trace_batches"])
            summary = harness.profile(torch, lambda tick, k: loop(n=k, tick=tick), ctx["trace_path"], False, 2, n)
            summary["host"] = harness.profile(torch, lambda tick, k: loop(n=k, tick=tick), ctx["trace_path"], True, 2,
                                              HOST_TRACE_BATCHES)
            summary.update(images=n * batch, img_per_s=n * batch / summary["window_s"])
            out["summary"] = summary
        else:
            n, wall0, t0 = loop(seconds=ctx["seconds"])
            t1 = time.perf_counter()
            out.update(window_start=wall0, window_s=t1 - t0, requests=n, images=n * batch,
                       p95_ms=1e3 * common.quantile(lat, 0.95))
        ctx["marks"]["window_end"] = time.time()
        device = harness.device_info(torch, dev, 1)
        del serve, reqs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        # the reference: float32, TF32 off, eval mode, the same weights and images
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = models.build(arch, **cspec.get("reference_kwargs", {})).to(dev).eval()
        model.load_state_dict(harness.make_weights(torch, shapes, seed, dev, arch))
        gap, n_rows, finite = 0.0, 0, True
        with torch.no_grad():
            for j, served in sorted(kept.items()):
                imgs, _ = pool.device_batch(j)
                ref = model((imgs.float() - 127.5) / 51.0).float().cpu()
                scale = ref.std(dim=1, keepdim=True).clamp(min=1e-12)
                for s in served:
                    finite = finite and bool(torch.isfinite(s).all())
                    gap = max(gap, float(((s - ref).abs() / scale).max()))
                    n_rows += s.shape[0]
        out.update(logit_gap=gap if finite else float("inf"), rows_compared=n_rows)
        ctx["marks"]["reference_end"] = time.time()
        return {"window": out, "device": device}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
