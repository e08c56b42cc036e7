"""The port's learning tools (``sota_imagenet_tpu_torch.tools``) against the
JAX package's scripts: the same corpora (pixel for pixel), the same curve
criterion and stage overrides; then each tool driven end to end on the CPU
at a toy size (a ResNet-18 at 32 px, debug epochs), which checks the wiring,
not the accuracy: that is measured on the card."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sota_imagenet_tpu_torch.tools import accuracy_proof as A
from sota_imagenet_tpu_torch.tools import recipe_rehearsal as RR

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_proof():
    return _script("tpu_accuracy_proof")


@pytest.fixture(scope="module")
def jax_rehearsal():
    return _script("tpu_recipe_rehearsal")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("corpus", ["hue", "texture"])
def test_accuracy_corpus_images_match_the_jax_script(jax_proof, corpus):
    make, jmake = (A._make_image, jax_proof._make_image) if corpus == "hue" else (
        A._make_texture_image, jax_proof._make_texture_image)
    assert (A.N_CLASSES, A.TRAIN_PER_CLASS, A.VAL_PER_CLASS, A.SRC_SIZE) == (
        jax_proof.N_CLASSES, jax_proof.TRAIN_PER_CLASS, jax_proof.VAL_PER_CLASS, jax_proof.SRC_SIZE)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    for cls in range(A.N_CLASSES):
        np.testing.assert_array_equal(make(rng, cls), jmake(jrng, cls))


def test_rehearsal_corpus_images_match_the_jax_script(jax_rehearsal):
    assert (RR.N_CLASSES, RR.TRAIN_PER_CLASS, RR.VAL_PER_CLASS, RR.SRC_SIZE) == (
        jax_rehearsal.N_CLASSES, jax_rehearsal.TRAIN_PER_CLASS, jax_rehearsal.VAL_PER_CLASS, jax_rehearsal.SRC_SIZE)
    for cls in range(0, RR.N_CLASSES, 7):
        rng, jrng = np.random.default_rng(cls), np.random.default_rng(cls)
        np.testing.assert_array_equal(RR._make_image(rng, cls), jax_rehearsal._make_image(jrng, cls))


CURVES = [
    [10, 50, 90, 96, 97, 97.5, 98, 98],
    [10, 50, 99, 80, 97, 97.5, 98, 98],  # a crater mid-run
    [10, 50, 90, 96, 97, 97.5, 99, 95],  # a late regression
    [10, 20, 30, 40],
    [99.0],
]


@pytest.mark.parametrize("curve", range(len(CURVES)))
def test_check_curve_matches_the_jax_script(jax_rehearsal, curve):
    accs = CURVES[curve]
    assert RR.check_curve(accs, 95.0) == jax_rehearsal.check_curve(accs, 95.0)


def test_rehearsal_recipes_and_stages_match_the_jax_script(jax_rehearsal):
    assert set(RR.RECIPES) == set(jax_rehearsal.RECIPES) == {"r50_baseline", "nfnet", "nf_lamb"}
    for name in RR.RECIPES:
        assert RR.RECIPES[name] == jax_rehearsal.RECIPES[name]
    # the string the JAX script builds for the r50 shape over 30 epochs (tpu_recipe_rehearsal.py:212-219)
    assert RR.stages_override(RR.RECIPES["r50_baseline"], 30) == (
        "run.stages=[{start: 0, end: 3, lr: [0.001, 1.0]}, {start: 3, end: 30, lr: [1.0, 0.0], lr_mode: cos}]"
    )
    # and for the nf_lamb shape, pure cosine (tpu_recipe_rehearsal.py:220-222)
    assert RR.stages_override(RR.RECIPES["nf_lamb"], 30) == "run.stages=[{start: 0, end: 30, lr: [0.001, 0.0], lr_mode: cos}]"


def test_nf_lamb_rehearsal_config_builds_its_model_optimizer_and_callbacks():
    """configs/tpu_rehearsal_nf_lamb.yaml: the full-width 24.nf_conv-act trunk with a
    100-class head, LAMB with the gain mask, CutmixMixup, OrthoInit and OrthoLoss."""
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as TC
    from sota_imagenet_tpu_torch.optim import build_optimizer
    from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

    recipe = RR.RECIPES["nf_lamb"]
    cfg = TC.load(os.path.join(A.CONFIGS, recipe["config"]), overrides=[RR.stages_override(recipe, 30)], strict_env=False)
    model = cli.build_model(cfg)
    assert model.layers[-1][0].weight.shape == (100, 2304)
    mask = filter_from_weight_decay(model.named_parameters(), cfg.filter_from_wd)
    opt = build_optimizer(dict(cfg.optim), model.named_parameters(), wd_mask=mask)
    assert type(opt).__name__ == "Lamb" and opt.param_groups[0]["weight_decay"] == 5e-3
    assert all(not mask[n] for n, _ in model.named_parameters() if n.endswith("gain"))
    names = [type(TC.instantiate(c)).__name__ for c in cfg.run.extra_callbacks]
    assert names == ["CutmixMixup", "OrthoInitClb", "OrthoLossClb"]


SMALL = ["model={_target_: resnet18, num_classes: 20}", "loader.image_size=32", "loader.batch_size=16",
         "val_loader.batch_size=20", "run.bf16=false", "debug=true"]


def test_accuracy_proof_drives_the_cli_and_reports_each_epoch(capsys):
    result = A.main(["--epochs", "3", "--threshold", "0"], device="cpu", overrides=SMALL)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert len(result["curve"]) == 3 and all(0 <= a <= 100 for a in result["curve"])
    assert result["final_acc1"] == result["curve"][-1] and result["best_acc1"] == max(result["curve"])
    assert 0 <= result["final_acc1_raw_weights"] <= 100  # the raw weights, scored after the EMA's val pass
    # the serving closure: the EMA weights exported on the CPU serve the val folder as the run scored it
    assert abs(result["artifact_acc1"] - result["final_acc1"]) <= 2.0 and result["export_s"] > 0
    assert result["ok"] and result["corpus"] == "hue" and result["config"] == "tpu_accuracy.yaml"


def test_recipe_rehearsal_packs_its_corpus_for_the_cached_run(tmp_path, monkeypatch):
    """--data reuses a corpus; the use_packed override packs it at the run's
    sizes first (a writer per core: one here, in this process), and the run
    reads the packed tree through the cache."""
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    for split, n in (("train", 16), ("val", 4)):
        for i in range(n):
            d = tmp_path / split / f"class_{i % 4:03d}"
            d.mkdir(parents=True, exist_ok=True)
            Image.fromarray(RR._make_image(np.random.default_rng(i), i % 4)).save(d / f"{i}.jpg", quality=92)
    overrides = [f"--override={o}" for o in ("model={_target_: resnet18, num_classes: 100}", "loader.batch_size=8",
                                               "val_loader.batch_size=4", "loader.image_size=32", "run.bf16=false",
                                               "loader.use_packed=true", "loader.device_cache=true",
                                               "val_loader.use_packed=true", "val_loader.device_cache=true")]
    result = RR.main(["--data", str(tmp_path), "--epochs", "2", "--threshold", "0", *overrides], device="cpu")
    assert result["train_size"] == result["val_size"] == 32 and result["pack_s"] > 0
    assert len(result["val_curve"]) == 2 and result["epochs"] == 2
    assert "corpus_s" not in result  # the corpus was reused, not written


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_bench_models_prints_one_json_line_per_model(capsys, mode):
    """tools/bench_models.py, the port of scripts/bench_models.py: the same
    five families at the same batches; here one family on the CPU at a toy
    size, 2 timed calls (the rates are the card's to measure)."""
    from sota_imagenet_tpu_torch.tools import bench_models as BM

    assert list(BM.FAMILIES) == ["resnet50", "bresnet50", "eca_nfnet_l0", "vgg16_bn", "vgg_cmodel"]
    assert BM.EVAL_BATCH == 250 and [BM.FAMILIES[n]()[2] for n in ("resnet50", "vgg16_bn")] == [128, 64]
    argv = ["resnet50", "--device", "cpu", "--batch", "2", "--size", "32", "--iters", "2"]
    results = BM.main(argv + (["--eval"] if mode == "eval" else []))
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert lines == json.loads(json.dumps(results)) and len(lines) == 1
    line = lines[0]
    assert line["model"] == "resnet50" and line["mode"] == mode and line["device"] == "cpu"
    assert (line["batch"], line["size"], line["iters"]) == (2, 32, 2) and line["img_per_sec"] > 0
    assert ("ms_per_step" if mode == "train" else "ms_per_batch") in line and "gpu" in line


SOAK_PLAN = {"boundary": 3, "last_epoch": 5, "final_size": 224}


def _soak_log(epochs=range(1, 6), loaded="logs/x/model.ckpt", finished=True):
    lines = ["Loader changed. New data config: image_size=160 batch_size=192"]
    if loaded:
        lines.append(f"Loaded checkpoint from {loaded}")
    for e in epochs:
        if e == 3:
            lines.append("Loader changed. New data config: image_size=224 batch_size=128")
        lines += [f"Epoch {e:3d} | Train loss: 6.9", f"Epoch {e:3d} | Val   loss: 6.9"]
    if finished:
        lines.append("Total time: 0h 1.0m")
    return "\n".join(lines)


@pytest.mark.parametrize("case", ["passes", "no_checkpoint_loaded", "not_finished", "not_killed", "rc",
                                  "resumed_past_the_boundary", "stopped_early", "restarted_at_epoch_0",
                                  "killed_with_epoch_0_saved", "loaded_another_checkpoint"])
def test_soak_verdict(case):
    """tools/soak.py's verdict: phase 2 must load the checkpoint phase 1
    left and finish (the JAX script's two greps, the first made exact),
    exit 0, resume at the epoch that checkpoint holds, above 0 (so a resume
    that restarts from scratch is told apart), and train every epoch from
    there, before the resize boundary, to the last, after phase 1 was
    killed with a checkpoint written."""
    from sota_imagenet_tpu_torch.tools import soak

    assert soak.stage_plan() == SOAK_PLAN  # configs/tpu_soak.yaml as it stands
    killed, ckpt, ckpt_epoch, rc2 = True, "logs/x/model.ckpt", 1, 0
    log = {"no_checkpoint_loaded": _soak_log(loaded=None), "not_finished": _soak_log(finished=False),
           "resumed_past_the_boundary": _soak_log(epochs=range(4, 6)),
           "stopped_early": _soak_log(epochs=range(1, 5)), "restarted_at_epoch_0": _soak_log(epochs=range(6)),
           "killed_with_epoch_0_saved": _soak_log(epochs=range(6)),
           "loaded_another_checkpoint": _soak_log(loaded="logs/y/model.ckpt")}.get(case, _soak_log())
    if case == "not_killed":
        killed = False
    if case == "rc":
        rc2 = 1
    if case == "killed_with_epoch_0_saved":
        ckpt_epoch = 0
    result = soak.verdict(SOAK_PLAN, killed, ckpt, ckpt_epoch, rc2, log)
    assert result["ok"] == (case == "passes"), result
    if case == "passes":
        assert result["resumed_at"] == 1 and result["phase2_epochs"] == [1, 2, 3, 4, 5]
