"""The readings that the limits of ``correct`` are set from, in one process
on the card (the benchmark's own runs never run this).

    python3 -m port_bench.calibrate --workload <cell> --seeds <first> <count> [--faults N] [--control N]

For each seed it reads what a run compares at the cell's own size: the
program's numbers (its first steps against the reference, or its served
logits against the reference's) and, on the first ``--control`` seeds, the
control's (the reference itself in a lower precision put in the program's
place, and for serving also the program's own int8 path), and on the first
``--faults`` seeds each planted fault's. One JSON line a reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    from port_bench import harness

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True, metavar=("FIRST", "COUNT"))
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--witness", type=int, default=0, help="seeds that also read the reference in bfloat16")
    args = p.parse_args(argv)
    harness.cache_env()
    import torch

    from port_bench import faults, run
    from port_bench.reference.train import bf16_quant, fp8_quant

    found = harness.cell_spec(args.workload)
    cell, spec = found["cell"], found["spec"]
    traffic = harness.load_json("traffic", cell["traffic"])
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")

    def emit(**row):
        print(json.dumps(row, default=str), flush=True)

    for i in range(args.seeds[1]):
        seed = args.seeds[0] + i
        ctx = run.build_ctx(cell, spec, traffic, seed, args.seconds, False, device)
        t0 = time.time()
        if traffic["driver"] == "train":
            from port_bench.drivers import train as T

            legs = [("program", None)] + [(k, f) for k, f in faults.TRAIN.items()
                                          if i < args.faults and k != "unchanged_state"]
            for leg, fault in legs:
                c = dict(ctx, fault=fault) if fault else ctx
                b = T.build(c)
                proof = T.prove(b, c)
                info = {k: b[k] for k in ("cfg", "cspec", "images", "batch")}
                b.clear()
                gc.collect()
                torch.cuda.empty_cache() if device.type == "cuda" else None
                ref = T.reference_readings(c, info, proof)
                g = T.gaps(proof["readings"], ref)
                emit(seed=seed, leg=leg, **g, rows_unmatched=ref["rows_unmatched"],
                     augment_gap_u8=ref["augment_gap"], prog_losses=proof["readings"]["losses"],
                     ref_losses=ref["losses"], s=time.time() - t0)
                if leg == "program" and i < args.control:
                    ctl = T.reference_readings(c, info, proof, quant=fp8_quant)
                    emit(seed=seed, leg="control_fp8", **T.gaps(ctl, ref), ref_losses=ref["losses"],
                         ctl_losses=ctl["losses"], s=time.time() - t0)
                if leg == "program" and i < args.witness:
                    wit = T.reference_readings(c, info, proof, quant=bf16_quant)
                    emit(seed=seed, leg="witness_bf16", **T.gaps(wit, ref), s=time.time() - t0)
                    emit(seed=seed, leg="program_vs_witness", **T.gaps(proof["readings"], wit), s=time.time() - t0)
                    emit(seed=seed, leg="leaves", first=[(n, proof["readings"]["first"][n], ref["first"][n],
                                                          wit["first"][n]) for n in ref["first"]])
                del proof, info, ref
                gc.collect()
        else:
            from port_bench.drivers import serve as S

            legs = [("program", {})]
            if i < args.control:
                legs.append(("control_int8", {"quantize": "int8"}))
            if i < args.faults:
                legs += [(k, {"fault": f}) for k, f in faults.SERVE.items()]
            for leg, extra in legs:
                out = S.run(dict(ctx, **extra))
                emit(seed=seed, leg=leg, logit_gap=out["window"]["logit_gap"],
                     rows=out["window"]["rows_compared"], s=time.time() - t0)
            if i < args.control:
                emit(seed=seed, leg="control_fp8", logit_gap=serve_fp8_gap(ctx), s=time.time() - t0)
        gc.collect()
    return 0


def serve_fp8_gap(ctx: dict) -> float:
    """The served number of the float32 reference rounded to float8 on every
    conv and linear, against the float32 reference, on the cell's images."""
    import torch

    from port_bench import harness
    from port_bench.drivers import common
    from port_bench.reference import models
    from port_bench.reference.train import fp8_quant

    dev, seed, traffic = ctx["device"], ctx["seed"], ctx["traffic"]
    cfg, cspec = common.load_config(ctx["cell"]["config"])
    arch = cspec["arch"]
    shapes = common.reference_shapes(arch)
    ref = models.build(arch).to(dev).eval()
    ref.load_state_dict(harness.make_weights(torch, shapes, seed, dev, arch))
    ctl = models.build(arch).to(dev).eval()
    ctl.load_state_dict(ref.state_dict())
    models.set_quant(ctl, fp8_quant)
    batch, size = int(traffic["batch"]), int(cfg.loader.image_size)
    pool = common.SeededImages(torch, batch * int(traffic["pool_batches"]), batch, size, seed, dev)
    gap = 0.0
    with torch.no_grad():
        for j in range(pool.n_batches):
            x = (pool.device_batch(j)[0].float() - 127.5) / 51.0
            r, c = ref(x).float(), ctl(x).float()
            gap = max(gap, float(((c - r).abs() / r.std(dim=1, keepdim=True).clamp(min=1e-12)).max()))
    return gap


if __name__ == "__main__":
    sys.exit(main())
