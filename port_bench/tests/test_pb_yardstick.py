"""The yardstick's arithmetic: bytes and FLOPs from shapes, and the idle
share from the union of the device's intervals."""

import json

import pytest

from port_bench import flops, harness, rooflines


def test_fused_aug_bytes_at_256x224():
    assert rooflines.fused_aug_bytes(256, 224, 224) == 115_605_504
    assert rooflines.bound_seconds(nbytes=115_605_504) == pytest.approx(34.51e-6, rel=1e-3)


def test_resnet50_forward_is_4_1_gmac():
    assert flops.forward_flops("resnet50", 224) / 2e9 == pytest.approx(4.1, rel=0.01)


def test_nfnet_l0_forward_counts_its_convs():
    # timm reports 4.35 GMAC for eca_nfnet_l0 at 224 with every op; convs and the head are most of it
    assert 4.0 < flops.forward_flops("eca_nfnet_l0", 224) / 2e9 < 4.5


def test_mfu_of_the_peak_is_100():
    assert rooflines.mfu_percent(1.0, harness.PEAK_BF16_FLOPS) == pytest.approx(100.0)


def _trace(tmp_path, kernels, host=()):
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": d, "args": {"correlation": c}}
          for n, s, d, c in kernels]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": d, "tid": 1} for n, s, d in host]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_idle_share_is_from_the_union_not_the_sum(tmp_path):
    # two streams overlap for 50 us and the device idles 40 us: the sum of durations says 210 us busy of a
    # 200 us window, the union 160
    path = _trace(tmp_path, [("gemm_a", 0, 100, 1), ("memcpy_h2d", 50, 100, 2), ("gemm_b", 190, 10, 3)],
                  host=[("aten::copy_", 0, 200)])
    s = harness.summarize_trace(path, steps=1)
    assert s["device_s"] == pytest.approx(210e-6)
    assert s["busy_s"] == pytest.approx(160e-6)
    assert s["window_s"] == pytest.approx(200e-6)
    idle = harness.metric_reader("device_idle_share.train")(s)
    assert idle == pytest.approx(20.0)


def test_idle_gaps_are_tagged_with_the_host_op(tmp_path):
    path = _trace(tmp_path, [("k1", 0, 10, 1), ("k2", 110, 10, 2)],
                  host=[("Runner.wait", 0, 120), ("cudaStreamSynchronize", 20, 80)])
    s = harness.summarize_trace(path, steps=1)
    assert s["idle_gaps"][0][0] == "cudaStreamSynchronize"
    assert s["idle_gaps"][0][1] == pytest.approx(100e-6)


def test_kernel_groups_name_the_layers():
    assert harness.kernel_group("void fused_aug_kernel<bf16>") == "fused_aug"
    assert harness.kernel_group("sm90_xmma_fprop_implicit_gemm") == "conv/matmul"
    assert harness.kernel_group("ncclDevKernel_AllReduce_Sum") == "nccl"
    assert harness.kernel_group("multi_tensor_apply_kernel") == "optimizer/EMA"


def test_readers_never_report_a_zero_roofline():
    read = harness.metric_reader("fused_aug_roofline")
    assert read({"fused_aug_s": [], "batch": 256, "image_size": 224}) is None
    assert read({"fused_aug_s": [69.0e-6], "batch": 256, "image_size": 224}) == pytest.approx(50.0, rel=1e-2)
