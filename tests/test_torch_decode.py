"""The port's host decode (``sota_imagenet_tpu_torch/data/decode.py``) and its
ctypes binding to the native core (``data/native.py``) against the JAX
package's, on the same files and the same ``np.random.Generator`` seeds.

Everything here is exact: the crop sampler, the train decode (host resize
and the scaled canvas of the device-resample split), the square and the
rectangular val decode, through PIL and through the native library, and
every entry point of the two bindings, the batch executor included. The
files are a few dozen small JPEGs (32-96 px), one PNG and one grayscale
JPEG, so the PIL, non-JPEG and ``convert("RGB")`` branches all run. Native
cases skip only when ``native/libimgpipe.so`` cannot be built here."""

import io

import numpy as np
import pytest
from PIL import Image

from sota_imagenet_tpu.data import decode as JD
from sota_imagenet_tpu.data import native as jnative
from sota_imagenet_tpu_torch.data import decode as D
from sota_imagenet_tpu_torch.data import native

SEEDS = (0, 1, 2)


def _image(rng, w, h):
    """Low-frequency content (a 4x5 random image scaled up) plus a little noise."""
    small = Image.fromarray(rng.integers(0, 256, (4, 5, 3), np.uint8)).resize((w, h), Image.BILINEAR)
    noisy = np.asarray(small, np.int16) + rng.integers(-8, 9, (h, w, 3))
    return Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("decode")
    rng = np.random.default_rng(0)
    out = []
    for i in range(24):
        w, h = (int(v) for v in rng.integers(32, 97, 2))
        img = _image(rng, w, h)
        if i == 3:
            path = root / f"{i}.png"
            img.save(path)
        elif i == 4:
            path = root / f"{i}.jpg"
            img.convert("L").save(path, quality=90)
        else:
            path = root / f"{i}.jpg"
            img.save(path, quality=90)
        out.append(str(path))
    return out


@pytest.fixture(scope="module")
def native_ok():
    if not native.available():
        pytest.skip("native/libimgpipe.so cannot be built here")
    assert jnative.available(), "the port's native library loaded and the JAX package's did not"
    return True


@pytest.mark.parametrize("size, min_area", [((96, 64), 0.08), ((33, 90), 0.08), ((64, 64), 0.5), ((40, 2), 0.9)])
def test_sample_random_crop_matches_jax(size, min_area):
    for seed in range(20):
        got = D.sample_random_crop(np.random.default_rng(seed), *size, min_area=min_area)
        want = JD.sample_random_crop(np.random.default_rng(seed), *size, min_area=min_area)
        assert got == want


def test_sample_random_crop_falls_back_to_the_centre():
    # no crop of area >= 90% at aspect 0.75-1.25 fits a 40x2 image: 100 attempts, then the centre square
    assert D.sample_random_crop(np.random.default_rng(0), 40, 2, min_area=0.9) == (19, 0, 2, 2)


def test_size_helpers_match_jax():
    for size in (16, 32, 64, 128, 160, 224, 288):
        assert D.val_resize_size(size) == JD.val_resize_size(size)
        assert D.val_resize_size(size, full_crop=True) == JD.val_resize_size(size, full_crop=True)
        assert D.resample_canvas(size) == JD.resample_canvas(size)
        assert D.rect_buckets(size) == JD.rect_buckets(size)
    _, thresh = D.rect_buckets(32)
    for w, h in ((60, 100), (100, 60), (64, 64), (90, 70), (120, 50)):
        assert D.bucket_of(w, h, thresh) == JD.bucket_of(w, h, thresh)


def _valid_equal(canvas, want, sh, sw):
    """Canvases agree on their valid (sh, sw) extent; the native core leaves
    the rest of its buffer unwritten (the device resample gives it zero weight)."""
    assert canvas.shape == want.shape
    np.testing.assert_array_equal(canvas[:sh, :sw], want[:sh, :sw])


def _use_native(request, flag):
    if flag:
        request.getfixturevalue("native_ok")
    return flag


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize(
    "random_interpolation, interpolation", [(False, "triangular"), (True, "triangular"), (True, "cubic")]
)
def test_decode_train_matches_jax(files, use_native, random_interpolation, interpolation, request):
    use_native = _use_native(request, use_native)
    kw = dict(min_area=0.08, random_interpolation=random_interpolation, interpolation=interpolation, use_native=use_native)
    for path in files:
        for seed in SEEDS:
            got = D.decode_train(path, np.random.default_rng(seed), 24, **kw)
            want = JD.decode_train(path, np.random.default_rng(seed), 24, **kw)
            assert got.shape == (24, 24, 3) and got.dtype == np.uint8
            np.testing.assert_array_equal(got, want, err_msg=f"{path} seed {seed}")


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
def test_decode_train_scaled_matches_jax(files, use_native, request):
    """image_size 16: the canvas is 40 px, so crops of the larger files do not
    fit and take the host-resize branch."""
    use_native = _use_native(request, use_native)
    for path in files:
        for seed in SEEDS:
            got = D.decode_train_scaled(path, np.random.default_rng(seed), 16, random_interpolation=True, use_native=use_native)
            want = JD.decode_train_scaled(path, np.random.default_rng(seed), 16, random_interpolation=True, use_native=use_native)
            assert got[1:] == want[1:], f"{path} seed {seed}"
            _valid_equal(got[0], want[0], *got[1:3])


def test_decode_train_scaled_resizes_on_the_host_when_the_crop_overflows_the_canvas(files):
    extents = set()
    for path in files:
        for seed in SEEDS:
            _, sh, sw, _ = D.decode_train_scaled(path, np.random.default_rng(seed), 16, use_native=False)
            extents.add((sh, sw))
    assert (16, 16) in extents and any(e != (16, 16) for e in extents)


@pytest.mark.parametrize("use_native", [False, True], ids=["pil", "native"])
@pytest.mark.parametrize("full_crop", [False, True])
def test_decode_val_matches_jax(files, use_native, full_crop, request):
    use_native = _use_native(request, use_native)
    for path in files:
        got = D.decode_val(path, 32, full_crop=full_crop, use_native=use_native)
        assert got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, JD.decode_val(path, 32, full_crop=full_crop, use_native=use_native))


@pytest.mark.parametrize("bucket", ["tall", "square", "wide"])
def test_decode_val_rect_matches_jax(files, bucket):
    hw = D.rect_buckets(32)[0][bucket]
    for path in files:
        got = D.decode_val_rect(path, 32, hw)
        assert got.shape == (*hw, 3)
        np.testing.assert_array_equal(got, JD.decode_val_rect(path, 32, hw))


def test_decode_reads_bytes_as_well_as_paths(files):
    with open(files[0], "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(D.decode_val(data, 32, use_native=False), D.decode_val(files[0], 32, use_native=False))


def test_decoders_are_counted(files):
    before = dict(D.decoded)
    D.decode_val(files[0], 32, use_native=False)
    D.decode_train(files[3], np.random.default_rng(0), 16, use_native=True)  # the PNG: PIL either way
    assert D.decoded["pil"] == before["pil"] + 2 and D.decoded["native"] == before["native"]


# --------------------------------------------------------------------------- #
# The native binding, entry point by entry point
# --------------------------------------------------------------------------- #


def _jpeg_bytes(files):
    out = []
    for path in files:
        with open(path, "rb") as f:
            out.append(f.read())
    return out


def test_native_single_image_calls_match_jax(files, native_ok):
    for data in _jpeg_bytes(files):
        assert native.jpeg_dims(data) == jnative.jpeg_dims(data)
        if native.jpeg_dims(data) is None:  # the PNG
            assert native.decode_crop_resize(data, (0, 0, 0, 0), (16, 16)) is None
            continue
        w, h = native.jpeg_dims(data)
        crop = (1, 2, w - 3, h - 5)
        for filt in (native.FILT_TRIANGULAR, native.FILT_CUBIC):
            np.testing.assert_array_equal(
                native.decode_crop_resize(data, crop, (20, 12), filt), jnative.decode_crop_resize(data, crop, (20, 12), filt)
            )
        got, want = native.decode_crop_scaled(data, crop, 16, 40), jnative.decode_crop_scaled(data, crop, 16, 40)
        assert got[1:] == want[1:]
        _valid_equal(got[0], want[0], *got[1:])
        np.testing.assert_array_equal(native.decode_val(data, 36, 32), jnative.decode_val(data, 36, 32))
    assert native.jpeg_dims(b"not a jpeg") is None


def test_native_batch_executor_matches_jax(files, native_ok):
    datas = _jpeg_bytes(files)
    crops = [(0, 0, 0, 0)] * len(datas)
    filts = [i % 2 for i in range(len(datas))]
    ex, jex = native.BatchExecutor(workers=2), jnative.BatchExecutor(workers=2)
    try:
        # two tickets in flight at once (double buffering), waited in order
        t1 = ex.submit(datas, crops, filts, (24, 20))
        t2 = ex.submit_scaled(datas, crops, 16, 40)
        imgs, failed = ex.wait(t1)
        canv, failed_s, dims = ex.wait_scaled(t2)
        jimgs, jfailed = jex.wait(jex.submit(datas, crops, filts, (24, 20)))
        jcanv, jfailed_s, jdims = jex.wait_scaled(jex.submit_scaled(datas, crops, 16, 40))
    finally:
        ex.close()
        jex.close()
    assert failed == jfailed == failed_s == jfailed_s == [3]  # the PNG
    np.testing.assert_array_equal(imgs[np.arange(len(datas)) != 3], jimgs[np.arange(len(datas)) != 3])
    np.testing.assert_array_equal(dims[np.arange(len(datas)) != 3], jdims[np.arange(len(datas)) != 3])
    for i in range(len(datas)):
        if i != 3:
            _valid_equal(canv[i], jcanv[i], *dims[i])


def test_unknown_ticket_raises(native_ok):
    ex = native.BatchExecutor(workers=1)
    try:
        ex._inflight[99] = (None, (), 1)
        with pytest.raises(RuntimeError, match="unknown ticket"):
            ex.wait(99)
    finally:
        ex.close()


class _Log:
    def __init__(self):
        self.warnings = []

    def warning(self, msg):
        self.warnings.append(msg)


def test_a_failed_build_leaves_pil_and_says_why_once(tmp_path, monkeypatch):
    log = _Log()
    monkeypatch.setattr(native, "get_logger", lambda: log)
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libimgpipe.so"))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert not native.available() and not native.available()
    assert native.jpeg_dims(b"\xff\xd8") is None and native.decode_val(b"", 36, 32) is None
    with pytest.raises(RuntimeError, match="not available"):
        native.BatchExecutor(workers=1)
    assert len(log.warnings) == 1
    assert "PIL" in log.warnings[0] and "no Makefile" in log.warnings[0]


def test_a_build_that_fails_reports_make_s_error(tmp_path, monkeypatch):
    (tmp_path / "Makefile").write_text("all:\n\t@echo 'jpeglib.h: No such file or directory' >&2; exit 1\n")
    monkeypatch.setattr(native, "NATIVE_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libimgpipe.so"))
    lib, why = native._load_locked()
    assert lib is None and "make -C native failed" in why and "jpeglib.h" in why


def test_a_loaded_library_is_named_once(monkeypatch, native_ok):
    log = _Log()
    monkeypatch.setattr(native, "get_logger", lambda: log)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.available() and native.available()
    assert len(log.warnings) == 1 and "native libjpeg core" in log.warnings[0]


def test_concurrent_first_loads_load_once(monkeypatch):
    import threading

    calls = []
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "get_logger", lambda: _Log())
    monkeypatch.setattr(native, "_load_locked", lambda: (calls.append(1), (None, "stubbed"))[1])
    threads = [threading.Thread(target=native.load) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert calls == [1]


def test_decode_train_of_bytes_through_native_matches_jax(native_ok):
    rng = np.random.default_rng(3)
    buf = io.BytesIO()
    _image(rng, 90, 70).save(buf, "JPEG", quality=90)
    data = buf.getvalue()
    for seed in SEEDS:
        np.testing.assert_array_equal(
            D.decode_train(data, np.random.default_rng(seed), 32), JD.decode_train(data, np.random.default_rng(seed), 32)
        )


def test_process_index_and_count(monkeypatch):
    import torch

    from sota_imagenet_tpu_torch.utils import misc

    assert (misc.process_index(), misc.process_count()) == (0, 1)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 2)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 4)
    assert (misc.process_index(), misc.process_count()) == (2, 4)

