"""The port's cutmix_mixup against the JAX package's.

threefry and Philox cannot agree, so the port splits the transform into
``draw_cutmix_mixup`` (a generator) and ``apply_cutmix_mixup`` (tensors).
Here the JAX function's own draws, reproduced from the same key splits
(sota_imagenet_tpu/train/steps.py:66-103), are fed to the port's apply:
images exact in float32 (XLA on the CPU contracts no multiply-add here; a
last-bit difference would show), labels within 1e-6. Then the cases of
tests/test_mixup.py on the port's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.train.steps import cutmix_mixup as jax_cutmix_mixup
from sota_imagenet_tpu_torch.train.steps import apply_cutmix_mixup, cutmix_mixup, draw_cutmix_mixup


def _batch(b=16, s=32, c=10, seed=0, w=None):
    rng = np.random.default_rng(seed)
    imgs = rng.normal(size=(b, s, w or s, 3)).astype(np.float32)
    labels = np.eye(c, dtype=np.float32)[np.arange(b) % c]
    return imgs, labels


def jax_draws(key, h, w, cutmix_alpha, mixup_alpha, prob, choice_prob):
    """What jax cutmix_mixup draws from ``key``, as the port's draws dict."""
    if mixup_alpha <= 0:
        choice_prob = 1.0
    elif cutmix_alpha <= 0:
        choice_prob = 0.0
    k_apply, k_choice, k_lam_m, k_lam_c, k_box = jax.random.split(key, 5)
    lam_m = jax.random.beta(k_lam_m, mixup_alpha, mixup_alpha) if mixup_alpha > 0 else jnp.float32(1.0)
    lam_c = jax.random.beta(k_lam_c, cutmix_alpha, cutmix_alpha) if cutmix_alpha > 0 else jnp.float32(1.0)
    draws = {
        "apply": jax.random.bernoulli(k_apply, prob),
        "use_cutmix": jax.random.bernoulli(k_choice, choice_prob),
        "lam_m": lam_m,
        "lam_c": lam_c,
        "cy": jax.random.randint(k_box, (), 0, h),
        "cx": jax.random.randint(jax.random.fold_in(k_box, 1), (), 0, w),
    }
    return {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}


# (cutmix_alpha, mixup_alpha, prob, choice_prob)
CASES = {
    "cutmix_or_mixup": (1.0, 0.2, 1.0, 0.5),
    "recipe_prob_half": (1.0, 0.2, 0.5, 0.5),
    "cutmix_only": (1.0, 1.0, 1.0, 1.0),
    "mixup_only": (1.0, 0.4, 1.0, 0.0),
    "zero_mixup_alpha": (1.0, 0.0, 1.0, 0.5),
    "zero_cutmix_alpha": (0.0, 0.2, 1.0, 0.5),
    "never_applied": (1.0, 0.2, 0.0, 0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_matches_jax_on_the_jax_draws(case):
    ca, ma, prob, choice = CASES[case]
    imgs, labels = _batch(b=6, s=20, w=28)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        want_i, want_l = jax_cutmix_mixup(key, jnp.asarray(imgs), jnp.asarray(labels), ca, ma, prob, choice)
        draws = jax_draws(key, 20, 28, ca, ma, prob, choice)
        got_i, got_l = apply_cutmix_mixup(torch.from_numpy(imgs), torch.from_numpy(labels), draws, ca, ma)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=f"seed {seed}")
        np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0, atol=1e-6, err_msg=f"seed {seed}")
        seen.add((bool(draws["apply"]), bool(draws["use_cutmix"])))
    want_seen = {
        "cutmix_or_mixup": {(True, True), (True, False)},
        "recipe_prob_half": {(True, True), (True, False), (False, True), (False, False)},
        "cutmix_only": {(True, True)},
        "mixup_only": {(True, False)},
        "zero_mixup_alpha": {(True, True)},
        "zero_cutmix_alpha": {(True, False)},
        "never_applied": {(False, True), (False, False)},
    }[case]
    assert seen == want_seen  # the seeds reached every branch the case has


def test_bfloat16_images_blend_in_float32_and_keep_their_dtype():
    imgs, labels = _batch(b=4, s=8)
    key = jax.random.PRNGKey(1)
    xb = jnp.asarray(imgs).astype(jnp.bfloat16)
    want_i, _ = jax_cutmix_mixup(key, xb, jnp.asarray(labels), 1.0, 0.4, 1.0, 0.0)
    draws = jax_draws(key, 8, 8, 1.0, 0.4, 1.0, 0.0)
    got_i, _ = apply_cutmix_mixup(torch.from_numpy(imgs).to(torch.bfloat16), torch.from_numpy(labels), draws, 1.0, 0.4)
    assert got_i.dtype == torch.bfloat16 and want_i.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got_i.float().numpy(), np.asarray(want_i.astype(jnp.float32)))


# ---- the cases of tests/test_mixup.py, on the port's own draws ----


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _run(seed, imgs, labels, *args, **kw):
    mi, ml = cutmix_mixup(_gen(seed), torch.from_numpy(imgs), torch.from_numpy(labels), *args, **kw)
    return mi.numpy(), ml.numpy()


def test_labels_remain_distributions():
    imgs, labels = _batch()
    for seed in range(5):
        _, ml = _run(seed, imgs, labels, 1.0, 0.2, prob=1.0)
        np.testing.assert_allclose(ml.sum(-1), 1.0, atol=1e-5)
        assert ml.min() >= 0


def test_prob_zero_is_identity():
    imgs, labels = _batch()
    mi, ml = _run(0, imgs, labels, 1.0, 0.2, prob=0.0)
    np.testing.assert_array_equal(mi, imgs)
    np.testing.assert_array_equal(ml, labels)


def test_cutmix_label_weight_matches_pixel_fraction():
    imgs, labels = _batch(b=8, s=32)
    found = 0
    for seed in range(30):
        mi, ml = _run(seed, imgs, labels, 1.0, 0.2, prob=1.0)
        is_a = np.isclose(mi, imgs, atol=1e-6).all(-1)
        is_b = np.isclose(mi, imgs[::-1], atol=1e-6).all(-1)
        if not (is_a | is_b).all():
            continue  # this seed chose mixup
        found += 1
        frac_b = is_b[0].mean()  # fraction of pasted pixels, sample 0
        w_b = ml[0][np.argmax(labels[::-1][0])]  # label weight of the partner on sample 0
        if frac_b in (0.0, 1.0):
            continue
        assert abs(frac_b - w_b) < 1e-6, (frac_b, w_b)
    assert found >= 3  # cutmix chosen ~50% of seeds


def test_mixup_blend():
    imgs, labels = _batch(b=4, s=8)
    for seed in range(30):
        mi, _ = _run(seed, imgs, labels, 1.0, 0.5, prob=1.0)
        src_a, src_b = imgs, imgs[::-1]
        is_pure = np.isclose(mi, src_a, atol=1e-6).all(-1) | np.isclose(mi, src_b, atol=1e-6).all(-1)
        if is_pure.all():
            continue  # cutmix seed
        # mixup: every pixel is the same convex blend lam*a + (1-lam)*b
        lam_map = (mi - src_b) / np.where(np.abs(src_a - src_b) < 1e-6, np.nan, src_a - src_b)
        assert lam_map[np.isfinite(lam_map)].std() < 1e-3
        return
    raise AssertionError("no mixup seed found in 30 tries")


def test_choice_prob_selects_cutmix_or_mixup():
    images = np.stack([np.zeros((16, 16, 3), np.float32), np.ones((16, 16, 3), np.float32)])
    labels = np.eye(2, dtype=np.float32)
    for trial in range(4):
        a, cut_lab = _run(trial, images, labels, prob=1.0, choice_prob=1.0)
        assert np.all((np.abs(a) < 1e-6) | (np.abs(a - 1) < 1e-6)), trial  # cutmix: every pixel exactly 0 or 1
        np.testing.assert_allclose(cut_lab[0, 1], np.mean(a[0, ..., 0]), atol=1e-5)  # label weight = pasted area
        m, _ = _run(trial, images, labels, mixup_alpha=0.4, prob=1.0, choice_prob=0.0)
        assert np.allclose(m[0], m[0, 0, 0], atol=1e-6), trial  # mixup: spatially constant blend


def test_zero_alpha_disables_branch_without_nan():
    imgs, labels = _batch()
    for seed in range(8):
        mi, ml = _run(seed, imgs, labels, cutmix_alpha=1.0, mixup_alpha=0.0, prob=1.0)
        assert np.isfinite(mi).all() and np.isfinite(ml).all()
        np.testing.assert_allclose(ml.sum(-1), 1.0, atol=1e-5)
        mi, ml = _run(seed, imgs, labels, cutmix_alpha=0.0, mixup_alpha=0.2, prob=1.0)
        assert np.isfinite(mi).all() and np.isfinite(ml).all()
    mi, ml = _run(0, imgs, labels, cutmix_alpha=0.0, mixup_alpha=0.0, prob=1.0)  # both disabled: identity
    np.testing.assert_array_equal(mi, imgs)
    np.testing.assert_array_equal(ml, labels)


def test_draws_are_device_tensors_in_range_and_follow_the_generator():
    d = draw_cutmix_mixup(_gen(3), 20, 28, "cpu", 1.0, 0.2, 0.5, 0.5)
    assert {k: (v.dim(), v.dtype) for k, v in d.items()} == {
        "apply": (0, torch.bool), "use_cutmix": (0, torch.bool), "lam_m": (0, torch.float32),
        "lam_c": (0, torch.float32), "cy": (0, torch.int64), "cx": (0, torch.int64),
    }
    again = draw_cutmix_mixup(_gen(3), 20, 28, "cpu", 1.0, 0.2, 0.5, 0.5)
    assert all(torch.equal(d[k], again[k]) for k in d)
    lams, cys, applied = [], [], []
    g = _gen(0)
    for _ in range(400):
        d = draw_cutmix_mixup(g, 20, 28, "cpu", 1.0, 0.2, 0.5, 0.5)
        lams.append((float(d["lam_m"]), float(d["lam_c"])))
        cys.append((int(d["cy"]), int(d["cx"])))
        applied.append(bool(d["apply"]))
    lams, cys = np.asarray(lams), np.asarray(cys)
    assert np.isfinite(lams).all() and lams.min() >= 0 and lams.max() <= 1
    assert cys[:, 0].max() < 20 and cys[:, 1].max() < 28 and cys.min() >= 0 and cys[:, 1].max() >= 20
    # Beta(1, 1) is uniform (mean 1/2, var 1/12); Beta(0.2, 0.2) has var 1/(4 * 1.4): 5 sigma of 400 draws
    assert abs(lams[:, 1].mean() - 0.5) < 5 * (1 / 12 / 400) ** 0.5
    assert abs(lams[:, 0].mean() - 0.5) < 5 * (1 / 5.6 / 400) ** 0.5 and abs(lams[:, 0].var() - 1 / 5.6) < 0.04
    assert abs(np.mean(applied) - 0.5) < 5 * (0.25 / 400) ** 0.5
