"""The port's TFRecord framing (``sota_imagenet_tpu_torch.data.records``)
against the JAX package's ``data/records.py``: the Example proto subset, the
framed file and its index, byte for byte; and the pure-Python crc32c, which
the port uses where ``google_crc32c`` is missing, against ``google_crc32c``
(installed here, so the fallback is called directly)."""

import numpy as np
import pytest

from sota_imagenet_tpu.data import records as JR
from sota_imagenet_tpu_torch.data import records as R

EXAMPLES = [
    {
        "image/raw": np.random.default_rng(0).integers(0, 256, 3 * 7 * 5, np.uint8).tobytes(),
        "image/height": 7,
        "image/width": 5,
        "image/class/label": 999,
        "image/filename": b"n01440764_10026.JPEG",
    },
    {"neg": -3, "list": [0, 1, 2**40, -(2**62)], "empty": b"", "one": [7]},
]


@pytest.mark.parametrize("i", range(len(EXAMPLES)))
def test_example_round_trips_and_matches_jax_bytes(i):
    ex = EXAMPLES[i]
    buf = R.encode_example(ex)
    assert buf == JR.encode_example(ex)
    want = {k: (v[0] if isinstance(v, list) and len(v) == 1 else v) for k, v in ex.items()}
    assert R.decode_example(buf) == want == JR.decode_example(buf)


def test_varints_match_jax():
    for n in (0, 1, 127, 128, 300, 2**35 + 17, 2**64 - 1):
        v = R._varint(n)
        assert v == JR._varint(n)
        assert R._read_varint(v + b"\x05", 0) == (n, len(v))
    assert R._len_delim(3, b"abc") == JR._len_delim(3, b"abc") and R._field(9, 0) == JR._field(9, 0)


def test_written_file_and_index_match_jax(tmp_path):
    payloads = [R.encode_example(EXAMPLES[0]), b"", R.encode_example(EXAMPLES[1])]
    n = R.write_tfrecord(str(tmp_path / "port"), iter(payloads), str(tmp_path / "port.idx"))
    JR.write_tfrecord(str(tmp_path / "jax"), iter(payloads), str(tmp_path / "jax.idx"))
    assert n == 3
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    assert (tmp_path / "port.idx").read_text() == (tmp_path / "jax.idx").read_text()
    index = R.read_index(str(tmp_path / "port.idx"))
    assert index == JR.read_index(str(tmp_path / "jax.idx")) and len(index) == 3
    assert list(R.read_tfrecord(str(tmp_path / "port"), verify_crc=True)) == payloads
    assert [R.read_record_at(str(tmp_path / "port"), off) for off, _ in index] == payloads
    assert sum(size for _, size in index) == (tmp_path / "port").stat().st_size


def test_corrupt_crc_is_caught_when_asked(tmp_path):
    path = tmp_path / "rec"
    R.write_tfrecord(str(path), iter([b"payload"]))
    data = bytearray(path.read_bytes())
    data[12] ^= 1  # a payload byte
    path.write_bytes(bytes(data))
    assert list(R.read_tfrecord(str(path))) == [b"qayload"]  # readers skip the crc by default
    with pytest.raises(ValueError, match="corrupt payload crc"):
        list(R.read_tfrecord(str(path), verify_crc=True))


@pytest.mark.parametrize("size", [0, 1, 3, 64, 1000, 150_528])
def test_pure_python_crc32c_matches_google_crc32c(size):
    import google_crc32c

    data = np.random.default_rng(size).integers(0, 256, size, np.uint8).tobytes()
    assert R._crc32c_python(data) == google_crc32c.value(data)
    assert R._crc32c(data) == google_crc32c.value(data)


def test_crc32c_known_answer_and_the_implementation_is_named():
    assert R._crc32c_python(b"123456789") == 0xE3069283  # the CRC-32C check value
    assert R.CRC32C in ("google_crc32c", "python")
    assert R._masked_crc(b"abc") == JR._masked_crc(b"abc")


def test_sharding_constants_match_jax():
    assert (R.TRAIN_SHARDS, R.VAL_SHARDS, R.SHUFFLE_SEED) == (JR.TRAIN_SHARDS, JR.VAL_SHARDS, JR.SHUFFLE_SEED)
