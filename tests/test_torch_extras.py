"""The legacy one-off architectures (models/extras.py: Darknet53 and its CSP
form, DenseNet121, EfficientNetB0, TResNetM) in the port against the JAX
package, on the same inputs and weights.

Structure at full width: ``jax.eval_shape`` of each factory's ``init`` (and
of its config aliases) beside the port's model on the meta device; every
flax leaf maps to one state_dict entry of the converted shape, the
parameter counts are equal (tests/test_torch_bnet_family.py's
``check_structure``).

Numerics (``compare_model`` of that file: eval and train from one JAX
function, every leaf drawn from a numpy seed, float64): Darknet53, CSP
Darknet53 and DenseNet121 depth-cut through their ``layers``/``channels``
and ``blocks``/``growth`` fields at 32 px, batch 4; output within one
float32 rounding (the logits are float32 in both), gradients within 1e-9 of
the largest reference value, running statistics within 1e-6.
EfficientNetB0 and TResNetM, whose geometry is fixed, at full width, 64 px,
batch 4, in train mode only (eval mode differs by BatchNorm's running
statistics alone, which the other cases hold), with each kernel drawn
N(0, 2 / fan_in) so that the full depth keeps its scale: about 17 s and
12 s each on one CPU thread, the JAX trace and compile most of it.
Their SE gates are float32 in both packages, so they are held to that
file's F32_INSIDE_TOL. Not at 32 px, batch 2: there the last stages are
1 px wide, each BatchNorm normalizes two values, and the net is so
ill-conditioned that the port's float32 SE gates alone move its own logits
by 2.5e-3 of their largest against float64 gates (under 2.5e-7 at 64 px,
batch 4)."""

import pytest
import torch

from sota_imagenet_tpu import registry as JR
from sota_imagenet_tpu.models import extras as JX
from sota_imagenet_tpu_torch import registry as TR
from sota_imagenet_tpu_torch.models import extras as TX
from tests import test_torch_bnet_family as fam
from tests.test_torch_bnet_family import F32_INSIDE_TOL, check_structure, compare_model


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NAMES = ["darknet53", "timm_darknet53", "cspdarknet53", "timm_cspdarknet53", "densenet121", "efficientnet_b0",
            "effnetb0_tf", "tresnetm"]
# the published parameter counts of the canonical geometries, as the JAX factories give them
COUNTS = {"darknet53": 41_609_928, "cspdarknet53": 19_055_304, "densenet121": 7_978_856,
          "efficientnet_b0": 5_290_476, "tresnetm": 32_013_856}


@pytest.mark.parametrize("name", NAMES)
def test_factory_maps_every_flax_leaf_at_full_width(name):
    n = check_structure(JR.resolve(name)(), lambda: TR.resolve(name)())
    canonical = {"timm_darknet53": "darknet53", "timm_cspdarknet53": "cspdarknet53", "effnetb0_tf": "efficientnet_b0"}
    assert n == COUNTS[canonical.get(name, name)]


def test_factories_drop_the_torch_only_arguments_as_jax():
    with torch.device("meta"):
        TR.resolve("densenet121")(memory_efficient=True, pretrained=False)
        model = TR.resolve("efficientnet_b0")(pretrained=True, drop_rate=0.3, num_classes=10)
    assert model.dropout.rate == 0.3 and model.fc.weight.shape == (10, 1280)


CASES = {
    "darknet53": (dict(layers=(1, 2, 1), channels=(8, 16, 32), num_classes=10), False),
    "cspdarknet53": (dict(layers=(1, 2, 2), channels=(16, 32, 64), num_classes=10), True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_darknet_depth_cut_matches_jax_in_float64(case):
    kw, csp = CASES[case]
    jmod, tmod = JX.Darknet53(csp=csp, **kw), TX.Darknet53(csp=csp, **kw)
    compare_model(jmod, tmod)
    if csp:  # the one-block stage stays plain, the others are CSP
        assert tmod.csp == [False, True, True] and hasattr(tmod, "csp_out2") and not hasattr(tmod, "csp_out0")


def test_densenet121_depth_cut_matches_jax_in_float64():
    kw = dict(growth=4, blocks=(2, 3, 2), num_classes=10)
    compare_model(JX.DenseNet121(**kw), TX.DenseNet121(**kw))


@pytest.mark.parametrize("name", ["efficientnet_b0", "tresnetm"])
def test_fixed_geometry_model_matches_jax(name, monkeypatch):
    monkeypatch.setattr(fam, "BATCH", 4)
    monkeypatch.setattr(fam, "SIZE", 64)
    kw = {"num_classes": 10}
    if name == "efficientnet_b0":  # drop rates at 0: the parity runs hold no masks
        kw.update(drop_rate=0.0, drop_connect_rate=0.0)
    compare_model(JR.resolve(name)(**kw), TR.resolve(name)(**kw), tol=F32_INSIDE_TOL, modes=(True,),
                  draw=fam._fan_in_kernels)


def test_efficientnet_b0_drop_connect_ramp_and_se_widths_as_jax():
    """The drop-connect keep probabilities rise linearly over the 16 blocks,
    and each SE reduces from the block's input width (the JAX reduction
    int(1 / (se_ratio / expand)), at least 8 wide)."""
    with torch.device("meta"):
        model = TX.EfficientNetB0()
    blocks = [getattr(model, n) for n in model.block_names]
    assert len(blocks) == 16 and sum(b.residual for b in blocks) == 9
    for i, b in enumerate(blocks):
        assert b.drop_path is None if not b.residual else b.drop_path.keep_prob == pytest.approx(1 - 0.2 * i / 15)
    assert model.s0_b0.se.fc1.weight.shape == (8, 32)  # 32 // 4
    assert model.s1_b1.se.fc1.weight.shape == (8, 144)  # 144 // 24 = 6, at least 8
    assert model.s5_b1.se.fc1.weight.shape == (48, 1152)  # 1152 // 24
