"""A pure-Python TFRecord and tf.Example reader and writer, no TensorFlow
(the port's copy of `mcvd_tpu/data/tfrecord.py`, held to it by a CPU test:
each reads the other's records bit-equal).

The framing is length-prefixed records with masked CRC32C fields; of the
protobuf wire format it parses the subset Example needs:
features{map<string, Feature{bytes_list|float_list|int64_list}>}. FFHQ's
StyleGAN shards (`image_datasets.FFHQTFRecordsDataset`) are read with it,
and the tests and `chip_smoke.py` write synthetic shards with its writer.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value) from a protobuf message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes) -> FeatureValue:
    """Feature: bytes_list=1 / float_list=2 / int64_list=3, each with
    repeated value field 1."""
    for field, _, val in _fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _fields(val) if f == 1]
        if field == 2:  # FloatList (packed or not)
            out: List[float] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:  # packed
                    out.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:
                    out.append(struct.unpack("<f", v)[0])
            return out
        if field == 3:  # Int64List
            def _signed(x: int) -> int:
                # negative int64 arrives as 10-byte two's-complement varint
                return x - (1 << 64) if x >= (1 << 63) else x

            out_i: List[int] = []
            for f, w, v in _fields(val):
                if f != 1:
                    continue
                if w == 2:
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        out_i.append(_signed(x))
                else:
                    out_i.append(_signed(v))
            return out_i
    return []


def parse_example(buf: bytes) -> Dict[str, FeatureValue]:
    """tf.Example: features(field 1) -> Features: map<string,Feature>(field 1)
    where each map entry is a message {key=1: string, value=2: Feature}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _fields(buf):
        if field != 1:
            continue
        for f2, _, entry in _fields(features_buf):
            if f2 != 1:
                continue
            key = None
            value = None
            for f3, _, v3 in _fields(entry):
                if f3 == 1:
                    key = v3.decode("utf-8")
                elif f3 == 2:
                    value = _parse_feature(v3)
            if key is not None:
                out[key] = value
    return out


def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads (TFRecord framing: u64 length, u32 masked
    crc of the length, payload, u32 masked crc of the payload).

    ``verify_crc=True`` checks both masked CRC32C fields and raises
    ValueError on mismatch — the same check a real TensorFlow reader
    performs. Default off: bulk ingest of trusted local shards doesn't need
    the (pure-python, slow) CRC pass."""
    with open(path, "rb") as f:
        idx = 0
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (length,) = struct.unpack("<Q", header)
            len_crc = f.read(4)
            payload = f.read(length)
            payload_crc = f.read(4)
            if verify_crc:
                want = struct.unpack("<I", len_crc)[0]
                got = _masked_crc(header)
                if want != got:
                    raise ValueError(
                        f"{path}: record {idx} length-crc mismatch "
                        f"(file {want:#010x} != computed {got:#010x})")
                want = struct.unpack("<I", payload_crc)[0]
                got = _masked_crc(payload)
                if want != got:
                    raise ValueError(
                        f"{path}: record {idx} payload-crc mismatch "
                        f"(file {want:#010x} != computed {got:#010x})")
            idx += 1
            yield payload


def read_examples(path: str, verify_crc: bool = False
                  ) -> Iterator[Dict[str, FeatureValue]]:
    for rec in read_tfrecord(path, verify_crc=verify_crc):
        yield parse_example(rec)


# ---------------------------------------------------------------------------
# Writer — emits records a real TensorFlow reader accepts (CRC-verified
# framing), used to write synthetic shards.

_CRC32C_TABLE = None


def _crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli, reflected poly 0x82F63B78), table-driven."""
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC32C_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC: rot-right-15 then add a constant (mod 2^32)."""
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    # protobuf encodes negative int64 as 10-byte two's complement; mask to
    # 64 bits first (Python's arithmetic shift would loop forever on n<0)
    n &= 0xFFFFFFFFFFFFFFFF
    out = b""
    while True:
        b7 = n & 0x7F
        n >>= 7
        out += bytes([b7 | (0x80 if n else 0)])
        if not n:
            return out


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited protobuf field."""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode a tf.Example proto (inverse of parse_example).

    Type dispatch inspects the WHOLE list, not just element 0:
    any bytes element requires all-bytes; a list mixing ints and floats is
    promoted to FloatList (the reading side would otherwise see truncated
    ints); an empty list is ambiguous (BytesList/FloatList/Int64List all
    parse back as []) and is rejected — omit the key instead."""
    import numpy as _np

    entries = b""
    for key, val in features.items():
        if not val:
            raise ValueError(
                f"feature {key!r} is an empty list: the target list type is "
                "ambiguous; omit the key instead")
        any_bytes = any(isinstance(v, bytes) for v in val)
        any_float = any(isinstance(v, (float, _np.floating)) for v in val)
        if any_bytes:
            if not all(isinstance(v, bytes) for v in val):
                raise ValueError(f"feature {key!r} mixes bytes and non-bytes")
            feat = _ld(1, b"".join(_ld(1, v) for v in val))  # BytesList
        elif any_float:
            packed = struct.pack(f"<{len(val)}f", *(float(v) for v in val))
            feat = _ld(2, _ld(1, packed))  # FloatList, packed
        else:
            if not all(isinstance(v, (int, _np.integer)) for v in val):
                raise ValueError(
                    f"feature {key!r} has unsupported element types "
                    f"{sorted({type(v).__name__ for v in val})}")
            packed = b"".join(_varint(int(v)) for v in val)
            feat = _ld(3, _ld(1, packed))  # Int64List, packed
        entries += _ld(1, _ld(1, key.encode("utf-8")) + _ld(2, feat))
    return _ld(1, entries)


def write_tfrecord(path: str, payloads) -> None:
    """Write raw payloads with full TFRecord framing (masked CRC32C)."""
    with open(path, "wb") as f:
        for p in payloads:
            header = struct.pack("<Q", len(p))
            f.write(header)
            f.write(struct.pack("<I", _masked_crc(header)))
            f.write(p)
            f.write(struct.pack("<I", _masked_crc(p)))


def write_examples(path: str, examples) -> None:
    write_tfrecord(path, (encode_example(ex) for ex in examples))
