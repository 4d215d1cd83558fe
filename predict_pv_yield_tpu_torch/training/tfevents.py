"""First-party TensorBoard ``tfevents`` writer (a copy of the JAX
package's ``training/tfevents.py``).

TensorBoard's on-disk format is a TFRecord stream of ``Event`` protobufs.
The subset the loggers need (scalars and small text blobs) is tiny, so the
wire format is encoded by hand, with no TensorFlow or tensorboardX:

* TFRecord framing: ``uint64 length | masked crc32c(length) | payload |
  masked crc32c(payload)`` with the Castagnoli CRC and TensorFlow's mask.
* ``Event``: field 1 ``wall_time`` (double), field 2 ``step`` (int64),
  field 3 ``file_version`` (string), field 5 ``summary`` (message).
* ``Summary.Value``: field 1 ``tag`` (string), field 2 ``simple_value``
  (float), field 8 ``tensor``, field 9 ``metadata``.

Verified against TensorBoard's own reader conventions (first record must be a
``file_version: "brain.Event:2"`` event).
"""

from __future__ import annotations

import os
import socket
import struct
import time

# --- crc32c (Castagnoli), table-driven ------------------------------------
_CRC_TABLE = []
_POLY = 0x82F63B78
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ _POLY if _crc & 1 else _crc >> 1
    _CRC_TABLE.append(_crc)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding --------------------------------------------
def _varint(value: int) -> bytes:
    # protobuf encodes negative int64 as 10-byte two's complement; Python's
    # arithmetic shift would loop forever on a negative value otherwise
    if value < 0:
        value &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _varint_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    summary_value = _bytes_field(1, tag.encode()) + _float_field(2, value)
    summary = _bytes_field(1, summary_value)
    return _double_field(1, wall_time) + _varint_field(2, step) + _bytes_field(5, summary)


def _text_event(tag: str, text: str, step: int, wall_time: float) -> bytes:
    # TensorProto: dtype=DT_STRING(7), string_val=[text]
    tensor = _varint_field(1, 7) + _bytes_field(8, text.encode())
    plugin_data = _bytes_field(1, b"text")
    metadata = _bytes_field(1, plugin_data)
    summary_value = (
        _bytes_field(1, (tag + "/text_summary").encode())
        + _bytes_field(8, tensor)
        + _bytes_field(9, metadata)
    )
    summary = _bytes_field(1, summary_value)
    return _double_field(1, wall_time) + _varint_field(2, step) + _bytes_field(5, summary)


class TFEventWriter:
    """Append scalar/text events to a ``events.out.tfevents.*`` file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        filename = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._fh = open(os.path.join(log_dir, filename), "ab")
        self._write_record(_double_field(1, time.time()) + _bytes_field(3, b"brain.Event:2"))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(payload)
        self._fh.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def add_text(self, tag: str, text: str, step: int) -> None:
        self._write_record(_text_event(tag, text, step, time.time()))

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()
