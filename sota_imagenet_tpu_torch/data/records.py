"""TFRecord framing and the tf.train.Example subset (port of the framing half
of ``sota_imagenet_tpu/data/records.py``: crc32c :31-58, the Example proto
:66-198, file IO :206-260, sharding constants :280-282).

Self-contained, as in the JAX package: a record is length (8 B, little
endian) + masked crc32c of the length (4 B) + payload + masked crc32c of the
payload (4 B), and an index file holds one "<offset> <size>" line per record
(DALI's ``tfrecord2idx`` format). crc32c comes from the ``google_crc32c``
wheel where it is installed, else from a pure-Python table (slow: ~40 ms for
a 150 KB record); ``CRC32C`` names the one this process uses. Readers never
check it (``read_record_at`` and the packed loader skip the header).

``TFRecordLoader`` and ``create_records`` (JPEG records and their decode)
are not ported yet: ROADMAP.md Queue 1 item 12.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

_CRC_POLY = 0x82F63B78


def _crc_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c_python(data: bytes) -> int:
    """crc32c (Castagnoli) one byte at a time: the fallback where
    ``google_crc32c`` is missing (records.py:37-53 of the JAX package)."""
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


try:
    import google_crc32c

    CRC32C = "google_crc32c"

    def _crc32c(data: bytes) -> int:
        return google_crc32c.value(data)

except ImportError:
    CRC32C = "python"
    _crc32c = _crc32c_python


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Minimal tf.train.Example proto (bytes_list / int64_list subset)
# --------------------------------------------------------------------------- #


def _varint(n: int) -> bytes:
    out = b""
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_delim(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, object]) -> bytes:
    """Encode {name: bytes|int|list[int]} as a tf.train.Example."""
    feats = b""
    for key, value in features.items():
        if isinstance(value, (bytes, bytearray)):
            # Feature{ bytes_list=1 { value=1 } }
            inner = _len_delim(1, _len_delim(1, bytes(value)))
        else:
            vals = value if isinstance(value, (list, tuple)) else [value]
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in vals)
            # Feature{ int64_list=3 { value=1 packed } }
            inner = _len_delim(3, _len_delim(1, packed))
        entry = _len_delim(1, key.encode()) + _len_delim(2, inner)
        feats += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, feats)  # Example.features


def decode_example(buf: bytes) -> Dict[str, object]:
    """Decode the subset written by encode_example (and by TF itself)."""
    out: Dict[str, object] = {}
    # Example -> features (field 1)
    pos = 0
    features_buf = b""
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        num, wire = tag >> 3, tag & 7
        if wire == 2:
            ln, pos = _read_varint(buf, pos)
            payload = buf[pos : pos + ln]
            pos += ln
            if num == 1:
                features_buf += payload
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        else:
            raise ValueError(f"unsupported wire type {wire}")
    # Features -> map entries (field 1)
    pos = 0
    while pos < len(features_buf):
        tag, pos = _read_varint(features_buf, pos)
        ln, pos = _read_varint(features_buf, pos)
        entry = features_buf[pos : pos + ln]
        pos += ln
        key, val = _decode_map_entry(entry)
        out[key] = val
    return out


def _decode_map_entry(entry: bytes):
    pos = 0
    key = ""
    value = None
    while pos < len(entry):
        tag, pos = _read_varint(entry, pos)
        num = tag >> 3
        ln, pos = _read_varint(entry, pos)
        payload = entry[pos : pos + ln]
        pos += ln
        if num == 1:
            key = payload.decode()
        else:
            value = _decode_feature(payload)
    return key, value


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        num = tag >> 3
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + ln]
        pos += ln
        if num == 1:  # bytes_list
            # BytesList{ value=1 }: may hold several values; return first/only
            p2 = 0
            vals = []
            while p2 < len(payload):
                _, p2 = _read_varint(payload, p2)
                l2, p2 = _read_varint(payload, p2)
                vals.append(payload[p2 : p2 + l2])
                p2 += l2
            return vals[0] if len(vals) == 1 else vals
        if num == 3:  # int64_list
            p2 = 0
            vals = []
            while p2 < len(payload):
                tag2, p2 = _read_varint(payload, p2)
                if tag2 & 7 == 2:  # packed
                    l2, p2 = _read_varint(payload, p2)
                    end = p2 + l2
                    while p2 < end:
                        v, p2 = _read_varint(payload, p2)
                        vals.append(_signed64(v))
                else:
                    v, p2 = _read_varint(payload, p2)
                    vals.append(_signed64(v))
            return vals if len(vals) != 1 else vals[0]
    return None


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# --------------------------------------------------------------------------- #
# TFRecord file IO
# --------------------------------------------------------------------------- #


def write_tfrecord(path: str, examples: Iterator[bytes], index_path: Optional[str] = None) -> int:
    """Write framed records; optionally a DALI-style .idx ("offset size")."""
    n = 0
    idx_lines = []
    with open(path, "wb") as f:
        for payload in examples:
            offset = f.tell()
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(payload)
            f.write(struct.pack("<I", _masked_crc(payload)))
            idx_lines.append(f"{offset} {f.tell() - offset}\n")
            n += 1
    if index_path:
        with open(index_path, "w") as f:
            f.writelines(idx_lines)
    return n


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            hcrc = f.read(4)
            if verify_crc and struct.unpack("<I", hcrc)[0] != _masked_crc(header):
                raise ValueError(f"{path}: corrupt header crc")
            payload = f.read(length)
            pcrc = f.read(4)
            if verify_crc and struct.unpack("<I", pcrc)[0] != _masked_crc(payload):
                raise ValueError(f"{path}: corrupt payload crc")
            yield payload


def read_index(index_path: str) -> List[Tuple[int, int]]:
    out = []
    with open(index_path) as f:
        for line in f:
            if line.strip():
                off, size = line.split()
                out.append((int(off), int(size)))
    return out


def read_record_at(path: str, offset: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(offset)
        header = f.read(8)
        (length,) = struct.unpack("<Q", header)
        f.read(4)
        return f.read(length)


TRAIN_SHARDS = 128  # reference create_records.py:55
VAL_SHARDS = 16  # reference create_records.py:56
SHUFFLE_SEED = 42  # reference create_records.py:37
