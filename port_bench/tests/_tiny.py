"""Cells cut to a size the CPU holds: the same drivers, at 32-64 px and a
few images, float32 (where the program and the reference agree closest)."""

from __future__ import annotations

import time

from port_bench import harness, run

SEED = 2 ** 31 + 4321

TINY = {
    # a small constant learning rate keeps the three steps of a 64 px ResNet-50 out of chaos
    "r50.cache": (["loader.image_size=64", "loader.batch_size=8", "run.bf16=false",
                   "run.stages=[{start: 0, end: 90, lr: [0.01, 0.01]}]"], {"images": 32}),
    "nfnet_l0.feed": (["loader.image_size=32", "loader.batch_size=2", "run.bf16=false"], {"images": 8}),
    "r50.serve": (["loader.image_size=32", "run.bf16=false"], {"batch": 4, "pool_batches": 2}),
}


def tiny_run(workload: str, trace: bool = False, seed: int = SEED, **extra) -> tuple:
    """(result, checks, driver output) of one CPU run of ``workload`` cut to size."""
    import torch

    found = harness.cell_spec(workload)
    cell, spec = found["cell"], found["spec"]
    overrides, cut = TINY[workload]
    traffic = dict(harness.load_json("traffic", cell["traffic"]), **cut)
    traffic.update(warm_steps=2, trace_skip=1, trace_steps=2, warm_batches=1, trace_batches=2)
    ctx = run.build_ctx(cell, spec, traffic, seed, 0.5, trace, torch.device("cpu"), overrides)
    ctx.update(extra)
    driver = __import__(f"port_bench.drivers.{traffic['driver']}", fromlist=["run"])
    t0 = time.time()
    out = driver.run(ctx)
    result, checks = run.result_of(ctx, out, t0)
    return result, checks, out
