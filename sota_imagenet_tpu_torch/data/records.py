"""TFRecord framing, the tf.train.Example subset and the JPEG-record writer
(port of ``sota_imagenet_tpu/data/records.py``: crc32c :31-58, the Example
proto :66-198, file IO :206-260, ``create_records`` :267-349).

Self-contained, as in the JAX package: a record is length (8 B, little
endian) + masked crc32c of the length (4 B) + payload + masked crc32c of the
payload (4 B), and an index file holds one "<offset> <size>" line per record
(DALI's ``tfrecord2idx`` format). crc32c comes from the ``google_crc32c``
wheel where it is installed, else from a pure-Python table (slow: ~40 ms for
a 150 KB record); ``CRC32C`` names the one this process uses. Readers never
check it (``read_record_at`` and the packed loader skip the header).

``create_records`` writes the reference's JPEG records (``records
tfrecord``); ``data/pipeline.TFRecordLoader`` reads them, beside the
FolderLoader whose decode paths it shares.
"""

from __future__ import annotations

import io
import multiprocessing
import os
import shutil
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

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


BROKEN_IMAGES = {
    "n02105855_2933.JPEG",  # PNG saved as JPEG
    # CMYK jpegs
    "n01739381_1309.JPEG", "n02077923_14822.JPEG", "n02447366_23489.JPEG",
    "n02492035_15739.JPEG", "n02747177_10752.JPEG", "n03018349_4028.JPEG",
    "n03062245_4620.JPEG", "n03347037_9675.JPEG", "n03467068_12171.JPEG",
    "n03529860_11437.JPEG", "n03544143_17228.JPEG", "n03633091_5218.JPEG",
    "n03710637_5125.JPEG", "n03961711_5286.JPEG", "n04033995_2932.JPEG",
    "n04258138_17003.JPEG", "n04264628_27969.JPEG", "n04336792_7448.JPEG",
    "n04371774_5854.JPEG", "n04596742_4225.JPEG", "n07583066_647.JPEG",
    "n13037406_4650.JPEG", "ILSVRC2012_val_00019877.JPEG",
}

TRAIN_SHARDS = 128  # reference create_records.py:55
VAL_SHARDS = 16  # reference create_records.py:56
SHUFFLE_SEED = 42  # reference create_records.py:37


def _encode_one(path: str, label: int) -> bytes:
    """One image's Example: its JPEG bytes (the ImageNet files that are not
    JPEGs re-encoded, create_records.py:87-91), label and file name."""
    fname = os.path.basename(path)
    if fname in BROKEN_IMAGES:
        from PIL import Image

        buf = io.BytesIO()
        Image.open(path).convert("RGB").save(buf, "JPEG", quality=95)
        data = buf.getvalue()
    else:
        with open(path, "rb") as f:
            data = f.read()
    return encode_example({"image/encoded": data, "image/class/label": label, "image/filename": fname.encode()})


def _write_shard(args) -> int:
    shard_path, index_path, files, labels = args
    return write_tfrecord(shard_path, (_encode_one(p, l) for p, l in zip(files, labels)), index_path)


def create_records(
    data_dir: str,
    out_dir: Optional[str] = None,
    train_shards: int = TRAIN_SHARDS,
    val_shards: int = VAL_SHARDS,
    workers: int = 8,
) -> None:
    """ImageFolder tree (``data_dir/{train,val}/<synset>/*``) -> sharded
    TFRecords and their indexes under ``out_dir`` (default ``data_dir``):
    ``{split}_records/{split}-SSSSS-of-NNNNN`` and ``{split}_indexes/*.idx``
    (create_records.py:138-159). Each split's files are shuffled once by
    ``SHUFFLE_SEED`` and cut into shards at ``linspace`` bounds, so the
    files are byte for byte those of the JAX package for the same tree.
    ``workers`` > 1 writes shards in that many spawned processes."""
    from sota_imagenet_tpu_torch.data.pipeline import scan_image_folder

    out_dir = out_dir or data_dir
    for split, n_shards in (("val", val_shards), ("train", train_shards)):
        files, labels, _ = scan_image_folder(os.path.join(data_dir, split))
        order = np.arange(len(files))
        np.random.default_rng(SHUFFLE_SEED).shuffle(order)  # create_records.py:37,110-112
        files, labels = [files[i] for i in order], [labels[i] for i in order]
        rec_dir, idx_dir = os.path.join(out_dir, f"{split}_records"), os.path.join(out_dir, f"{split}_indexes")
        for d in (rec_dir, idx_dir):
            shutil.rmtree(d, ignore_errors=True)
            os.makedirs(d)
        bounds = np.linspace(0, len(files), n_shards + 1).astype(int)
        tasks = []
        for s in range(n_shards):
            lo, hi = bounds[s], bounds[s + 1]
            name = f"{split}-{s:05d}-of-{n_shards:05d}"
            tasks.append((os.path.join(rec_dir, name), os.path.join(idx_dir, name + ".idx"), files[lo:hi], labels[lo:hi]))
        if workers > 1:
            with multiprocessing.get_context("spawn").Pool(workers) as pool:
                pool.map(_write_shard, tasks)
        else:
            for t in tasks:
                _write_shard(t)
