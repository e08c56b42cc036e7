"""Crash-recovery soak of the port on the card (port of ``scripts/tpu_soak.sh``
on ``configs/tpu_soak.yaml`` as it stands: ResNet-50, EMA, CutmixMixup,
synthetic data, 6 epochs with a progressive resize from 160 px at batch 192
to 224 px at batch 128 after epoch 3).

Phase 1 trains the config through the port's CLI in a subprocess and kills
it with SIGKILL (a simulated preemption) as soon as the checkpoint that a
resume would pick holds epoch ``--kill-epoch`` (default 1) or a later one:
mid-run, before the resize boundary, and past epoch 0, where a resume that
ignored the checkpoint's epoch would look like a fresh start. (The JAX
script waits 20 s after the first checkpoint instead; an epoch lands at the
same point of the run on any host.) Phase 2 relaunches it with
``run.auto_resume=true`` into the same log dir: it must find that
checkpoint, load it and finish every stage. The verdict (``verdict``)
passes only when phase 1 was killed after writing a checkpoint, and phase
2 exited 0, logged "Loaded checkpoint" from that file and "Total time",
resumed at the epoch the checkpoint holds (above 0, before the resize
boundary), trained every epoch from there to the last, and rebuilt its
loader at the final stage's size. Extra ``key=value`` overrides (such as
``debug=true``, 10 steps an epoch, or ``loader.device_cache=true``) go to
both phases.

Usage: python -m sota_imagenet_tpu_torch.tools.soak [--kill-epoch N] [--device cpu] [key=value ...]
Prints one JSON line with the verdict; exits 0 iff it passed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import Iterable, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(ROOT, "configs", "tpu_soak.yaml")
TIMEOUT_S = 1800  # each phase's limit


def _cli(log_dir: str, overrides: Iterable[str], device: Optional[str]) -> List[str]:
    return [sys.executable, "-m", "sota_imagenet_tpu_torch.cli", *(["--device", device] if device else []),
            "-c", CONFIG, f"log.dir={log_dir}", *overrides]


def saved_epoch(path: str) -> int:
    """The epoch a checkpoint holds (read through a memory map: the weights stay on disk)."""
    import torch

    return int(torch.load(path, map_location="cpu", weights_only=True, mmap=True)["epoch"])


def stage_plan(overrides: Iterable[str] = ()) -> dict:
    """The config's resize boundary (the first epoch of its last stage), its
    last epoch (0-based) and the final stage's image size, under ``overrides``."""
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.utils.export import resolve_final_image_size

    cfg = C.load(CONFIG, overrides=list(overrides), strict_env=False)
    stages = list(cfg.run.stages)
    return {"boundary": int(stages[-1]["start"]), "last_epoch": int(stages[-1]["end"]) - 1,
            "final_size": resolve_final_image_size(cfg)}


def verdict(plan: dict, killed: bool, checkpoint: Optional[str], checkpoint_epoch: Optional[int], rc2: int,
            log2: str) -> dict:
    """Whether the soak passed, from phase 1's end (the checkpoint a resume
    picks and the epoch it holds) and phase 2's exit code and log."""
    epochs = sorted({int(e) for e in re.findall(r"Epoch\s+(\d+) \| Train", log2)})
    resumed_at = epochs[0] if epochs else None
    loaded = re.search(r"Loaded checkpoint from (\S+)", log2)
    checks = {
        "phase1_killed_after_a_checkpoint": killed and checkpoint is not None,
        "phase2_exit_0": rc2 == 0,
        "loaded_checkpoint": bool(loaded) and checkpoint is not None
        and os.path.realpath(loaded.group(1)) == os.path.realpath(checkpoint),
        "total_time": "Total time" in log2,
        # a resume that restarted the schedule, or ignored the checkpoint's epoch, starts elsewhere
        "resumed_at_the_checkpoints_epoch": checkpoint_epoch is not None and checkpoint_epoch > 0
        and resumed_at == checkpoint_epoch,
        "trained_to_the_last_epoch": bool(epochs) and epochs == list(range(epochs[0], plan["last_epoch"] + 1)),
        "resumed_before_the_boundary": resumed_at is not None and resumed_at < plan["boundary"],
        "resized": f"image_size={plan['final_size']}" in log2,
    }
    return {"ok": all(checks.values()), "checks": checks, "phase2_epochs": epochs, "resumed_at": resumed_at,
            "checkpoint_epoch": checkpoint_epoch}


def run(overrides: Iterable[str] = (), kill_epoch: int = 1, log_dir: Optional[str] = None,
        device: Optional[str] = None) -> dict:
    from sota_imagenet_tpu_torch import config as C
    from sota_imagenet_tpu_torch.cli import find_auto_resume

    overrides = list(overrides)
    plan = stage_plan(overrides)
    if not 0 < kill_epoch < plan["boundary"]:
        raise ValueError(f"kill_epoch must lie in (0, {plan['boundary']}), before the resize boundary")
    exp_name = C.load(CONFIG, overrides=overrides, strict_env=False).log.exp_name
    log_dir = log_dir or tempfile.mkdtemp(prefix="soak_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    log1, log2 = os.path.join(log_dir, "phase1.log"), os.path.join(log_dir, "phase2.log")
    t0 = time.perf_counter()
    with open(log1, "w") as out:
        proc = subprocess.Popen(_cli(log_dir, overrides, device), stdout=out, stderr=subprocess.STDOUT,
                                cwd=ROOT, env=env)
        deadline, seen = time.monotonic() + TIMEOUT_S, {}
        while proc.poll() is None and time.monotonic() < deadline:
            # the checkpoint auto_resume would pick; each version of it read once (saves are atomic renames)
            newest = find_auto_resume(log_dir, exp_name)
            if newest is not None:
                key = (newest, os.stat(newest).st_mtime_ns)
                if key not in seen:
                    seen[key] = saved_epoch(newest)
                if seen[key] >= kill_epoch:
                    break
            time.sleep(0.1)
        killed = proc.poll() is None
        if killed:
            proc.send_signal(signal.SIGKILL)
        proc.wait()
    phase1_s = time.perf_counter() - t0
    checkpoint = find_auto_resume(log_dir, exp_name)
    checkpoint_epoch = saved_epoch(checkpoint) if checkpoint else None
    t1 = time.perf_counter()
    with open(log2, "w") as out:
        rc2 = subprocess.run(_cli(log_dir, [*overrides, "run.auto_resume=true"], device), stdout=out,
                             stderr=subprocess.STDOUT, cwd=ROOT, env=env, timeout=TIMEOUT_S).returncode
    with open(log2) as f:
        text = f.read()
    result = verdict(plan, killed, checkpoint, checkpoint_epoch, rc2, text)
    result.update({"phase1_rc": proc.returncode, "phase2_rc": rc2, "checkpoint_at_kill": checkpoint,
                   "phase1_s": phase1_s, "phase2_s": time.perf_counter() - t1, "log_dir": log_dir,
                   "overrides": overrides})
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kill -9 after a checkpoint, then auto_resume to the end")
    ap.add_argument("--kill-epoch", type=int, default=1,
                    help="kill phase 1 once the checkpoint to resume from holds this epoch or a later one")
    ap.add_argument("--device", default=None, help="cpu to run both phases on the CPU (default: the card)")
    ap.add_argument("overrides", nargs="*", help="dotted overrides key=value for both phases")
    args = ap.parse_args(argv)
    result = run(args.overrides, args.kill_epoch, device=args.device)
    print(json.dumps(result), flush=True)
    if not result["ok"]:
        print(f"SOAK FAILED: {[k for k, v in result['checks'].items() if not v]}; logs in {result['log_dir']}",
              file=sys.stderr)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
