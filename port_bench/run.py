"""The benchmark of the PyTorch and CUDA port, one cell a run.

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads the cell from BENCHMARK.json, its configuration from
``configs/<config>.json`` and its traffic from ``traffic/<traffic>.json``;
the traffic names the driver (``drivers/<driver>.py``) that builds the
cell, warms it, measures for ``--seconds`` and checks what the timed path
produced against the plain reference. With ``--trace 0`` the result carries
the cell's end-to-end metrics; with ``--trace 1`` a traced window's
per-layer metrics, each read by ``metrics/<metric>.py``. The last line of
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
Exits non-zero without a result when no card (or too few) is present, or
when JAX or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

from port_bench import harness


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def limits_of(workload: str) -> dict:
    return harness.load_json("limits", workload)


def result_of(ctx: dict, out: dict, t_start: float) -> tuple:
    """The result line and the compared numbers of a driver's output."""
    spec, workload, win = ctx["spec"], ctx["workload"], out["window"]
    limits = limits_of(workload)
    if "gaps" in out:
        g = out["gaps"]
        values = {k: v for k, v in g.items() if isinstance(v, float)}
        values["rows_unmatched"] = out["ref"]["rows_unmatched"]
    else:
        values = {"logit_gap": win["logit_gap"]}
    checks = [harness.check(k, values[k], limits[k]) for k in limits]
    correct = all(c["ok"] for c in checks)
    metrics = {}
    if ctx["trace"]:
        s = dict(win["summary"])
        s.update(cell=ctx["cell"], traffic=ctx["traffic"], arch=ctx["arch"], image_size=ctx["image_size"],
                 batch=ctx["batch"], cache_fill_s=win.get("cache_fill_s"), fwd_flops=ctx["fwd_flops"])
        for m in harness.cell_metrics(spec, workload, "per_layer"):
            v = harness.metric_reader(m["name"])(s)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        setup_s = win["window_start"] - t_start
        e2e = {"setup_s": setup_s}
        if "steps" in win:
            e2e["train_img_per_s"] = win["images"] / win["window_s"]
        else:
            e2e["serve_img_per_s"] = win["images"] / win["window_s"]
            e2e["serve_batch_ms_p95"] = win["p95_ms"]
        for m in harness.cell_metrics(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    attempted = win.get("requests", win.get("steps", 0)) if not ctx["trace"] else win["summary"]["steps"]
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": 0 if correct else int(attempted),
              "metrics": metrics, "device": out["device"]}
    if ctx["trace"]:
        s = win["summary"]
        result["device"] = dict(out["device"], busy_s=s["busy_s"], window_s=s["window_s"])
        bd = harness.breakdown(s)
        if bd:
            result["breakdown"] = bd
    return result, checks


def main(argv=None) -> int:
    t_start = harness.process_start_time()
    args = parse(argv)
    harness.cache_env()
    found = harness.cell_spec(harness.check_name(args.workload))
    cell, spec = found["cell"], found["spec"]
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")  # the card's context
    t_context = time.time()
    traffic = harness.load_json("traffic", cell["traffic"])
    ctx = build_ctx(cell, spec, traffic, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    ctx["marks"]["cuda_context"] = t_context
    driver = importlib.import_module(f"port_bench.drivers.{harness.check_name(traffic['driver'])}")
    out = driver.run(ctx)
    result, checks = result_of(ctx, out, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    detail = {k: out[k] for k in ("gaps",) if k in out}
    if "ref" in out:
        detail.update(prog_losses=out["prog"]["losses"], ref_losses=out["ref"]["losses"],
                      augment_gap_u8=out["ref"]["augment_gap"])
    detail.update({k: v for k, v in out["window"].items() if k not in ("summary",)})
    detail["marks_s"] = {k: round(v - t_start, 3) for k, v in ctx["marks"].items()}
    if "summary" in out["window"]:
        detail["top_kernels"] = out["window"]["summary"].get("top_kernels")
    print("detail " + json.dumps(detail, default=str), file=sys.stderr)
    harness.emit(result, checks)
    return 0


def build_ctx(cell, spec, traffic, seed, seconds, trace, device, overrides=()) -> dict:
    from port_bench import flops
    from port_bench.drivers import common

    cfg, cspec = common.load_config(cell["config"], overrides)
    batch = int(traffic.get("batch", 0)) or int(cfg.loader.batch_size) * int(cfg.run.accumulate_steps or 1)
    size = int(cfg.loader.image_size)
    tmp = os.environ.get("TMPDIR") or "/tmp"
    return {
        "cell": cell, "spec": spec, "workload": cell["name"], "traffic": traffic, "seed": int(seed),
        "seconds": float(seconds), "trace": trace, "device": device, "overrides": list(overrides),
        "arch": cspec["arch"], "image_size": size, "batch": batch,
        "fwd_flops": (flops.forward_flops(cspec["arch"], size, cspec.get("reference_kwargs", {})) if trace else None),
        "marks": {},
        "trace_path": os.path.join(tmp, f"port_bench_trace_{os.getpid()}_{int(time.time())}.json"),
    }


if __name__ == "__main__":
    sys.exit(main())
