"""CRC-32-framed wire protocol (the paper's lwIP + CRC-32 message layer).

The port's copy of ``repro.serving.protocol``: the same frames, byte for
byte. Two additions: a bfloat16 tensor crosses the wire as its uint16 bits
plus a ``__dtypes`` entry naming its dtype (every numpy dtype keeps the JAX
package's npz format), and large payloads are sent and received without
concatenating copies (``send_frame`` takes a list of parts; ``recv_frame_ex``
reads straight into one buffer).

v1 frame layout (little-endian):

  [0:4]  magic  b"AEGW"
  [4:5]  type   (Msg enum)
  [5:9]  payload length
  [9:..] payload
  [-4:]  CRC-32 (IEEE 0x04C11DB7 == zlib.crc32) over magic..payload

v2 keeps the same magic/type/length prefix but sets bit 7 of the type
byte and inserts an 8-byte extension word after the length:

  [9:13]  request_id  (u32) — correlates pipelined requests with their
                      out-of-order responses on one connection
  [13:17] flags       (u32) — F_SHED / F_BUSY / F_DRAINING on replies
  [17:..] payload
  [-4:]   CRC-32 over everything before it

A decoder that understands v2 accepts both versions (``decode_frame_ex``
/ ``recv_frame_ex``); v1-only peers never see the version bit unless
they send it. The length field is *payload* length in both versions and
is attacker-/corruption-controlled, so every receive path enforces
``MAX_FRAME`` BEFORE allocating the payload buffer.

The paper's design note applies verbatim: CRC detects accidental corruption;
confidentiality/authentication are explicitly out of scope (terminate TLS at
a gateway for untrusted networks — §5.5).
"""
from __future__ import annotations

import enum
import io
import json
import socket
import struct
import zlib
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.dtypes import BF16, from_host_bits, host_bits

MAGIC = b"AEGW"
HEADER = struct.Struct("<4sBI")
EXT = struct.Struct("<II")            # v2 extension: request_id, flags
V2_BIT = 0x80                         # set on the type byte for v2 frames

#: Hard ceiling on the payload length field. A corrupted / hostile length
#: would otherwise make the receiver try to allocate up to 4 GiB before
#: the CRC ever gets a chance to reject the frame.
MAX_FRAME = 64 << 20

# Reply flags (v2 flags word).
F_SHED = 1 << 0        # request shed by the admission policy (verdict in payload)
F_BUSY = 1 << 1        # bounded dispatch queue full — backpressure, retry later
F_DRAINING = 1 << 2    # server draining after SHUTDOWN; no new work accepted
F_CANARY = 1 << 3      # response bytes produced by a canary shadow binding


class Msg(enum.IntEnum):
    PROVISION = 1          # payload: RIMFS image (+ program blob)
    INFER_REQUEST = 2      # payload: npz tensors
    INFER_RESPONSE = 3
    TELEMETRY = 4          # payload: json
    HEARTBEAT = 5
    ERROR = 6
    SHUTDOWN = 7


class ProtocolError(ValueError):
    pass


class Frame(NamedTuple):
    kind: "Msg"
    payload: bytes
    request_id: int = 0
    flags: int = 0
    version: int = 1


def _kind(raw: int) -> Msg:
    try:
        return Msg(raw & ~V2_BIT)
    except ValueError:
        raise ProtocolError(f"unknown message type {raw & ~V2_BIT}")


def _check_len(n: int, max_frame: Optional[int]) -> None:
    cap = MAX_FRAME if max_frame is None else max_frame
    if n > cap:
        raise ProtocolError(f"frame payload {n}B exceeds MAX_FRAME {cap}B")


def frame_parts(kind: Msg, payload, request_id: Optional[int] = None,
                flags: int = 0) -> list:
    """[head, payload parts..., crc] of one frame, without joining them.
    ``payload`` is bytes-like or a sequence of bytes-like parts. v1 by
    default; passing a ``request_id`` (or flags) emits v2."""
    parts = [payload] if isinstance(payload, (bytes, bytearray, memoryview)) \
        else list(payload)
    n = sum(memoryview(p).nbytes for p in parts)
    if request_id is None and not flags:
        head = HEADER.pack(MAGIC, int(kind), n)
    else:
        head = HEADER.pack(MAGIC, int(kind) | V2_BIT, n) + \
            EXT.pack(request_id or 0, flags)
    crc = zlib.crc32(head)
    for p in parts:
        crc = zlib.crc32(p, crc)
    return [head, *parts, struct.pack("<I", crc & 0xFFFFFFFF)]


def encode_frame(kind: Msg, payload, request_id: Optional[int] = None,
                 flags: int = 0) -> bytes:
    """v1 frame by default; passing a ``request_id`` (or flags) emits v2."""
    return b"".join(frame_parts(kind, payload, request_id, flags))


def decode_frame_ex(data: bytes, max_frame: Optional[int] = None) -> Frame:
    """Decode one frame (either version) from a complete byte string."""
    if len(data) < HEADER.size:
        raise ProtocolError(f"truncated frame ({len(data)}B)")
    magic, raw_kind, n = HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    _check_len(n, max_frame)
    kind = _kind(raw_kind)
    rid, flags, version, off = 0, 0, 1, HEADER.size
    if raw_kind & V2_BIT:
        version = 2
        if len(data) < off + EXT.size:
            raise ProtocolError("truncated v2 extension")
        rid, flags = EXT.unpack_from(data, off)
        off += EXT.size
    end = off + n
    if len(data) < end + 4:
        raise ProtocolError(f"truncated frame body ({len(data)}B < {end + 4}B)")
    payload = data[off:end]
    (crc,) = struct.unpack_from("<I", data, end)
    if crc != (zlib.crc32(data[:end]) & 0xFFFFFFFF):
        raise ProtocolError("frame CRC mismatch")
    return Frame(kind, payload, rid, flags, version)


def decode_frame(data: bytes, max_frame: Optional[int] = None) -> tuple:
    f = decode_frame_ex(data, max_frame=max_frame)
    return f.kind, f.payload


# --------------------------------------------------------------- tensor io
DTYPES_KEY = "__dtypes"     # {name: dtype} for entries numpy cannot carry


def pack_tensors(tensors: dict) -> bytes:
    """npz payload. Numpy arrays (and tensors of numpy dtypes) travel as in
    the JAX package; a ``torch.bfloat16`` tensor travels as its uint16 bits
    and is named in the ``__dtypes`` entry."""
    arrays, special = {}, {}
    for k, v in tensors.items():
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                special[k] = BF16
            v = host_bits(v)
        arrays[k] = np.asarray(v)
    if special:
        arrays[DTYPES_KEY] = np.asarray(json.dumps(special))
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def unpack_tensors(payload) -> dict:
    """Inverse of ``pack_tensors``: numpy arrays, except bf16 entries,
    which come back as CPU ``torch.bfloat16`` tensors."""
    with np.load(io.BytesIO(payload)) as z:
        out = {k: z[k] for k in z.files}
    special = json.loads(str(out.pop(DTYPES_KEY))) if DTYPES_KEY in out \
        else {}
    for k, name in special.items():
        if name != BF16:
            raise ProtocolError(f"unsupported wire dtype {name!r} for {k!r}")
        out[k] = from_host_bits(np.ascontiguousarray(out[k]), BF16)
    return out


def pack_json(obj: Any) -> bytes:
    return json.dumps(obj).encode()


def unpack_json(payload) -> Any:
    return json.loads(bytes(payload).decode())


# --------------------------------------------------------------- socket io
def send_frame(sock: socket.socket, kind: Msg, payload,
               request_id: Optional[int] = None, flags: int = 0) -> None:
    """Send one frame; ``payload`` may be a sequence of parts, each sent
    as it is (a multi-GB PROVISION is never copied into one buffer)."""
    for part in frame_parts(kind, payload, request_id=request_id,
                            flags=flags):
        sock.sendall(part)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:], min(len(view) - got, 1 << 22))
        if not n:
            raise ConnectionError("peer closed")
        got += n


def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    _recv_into(sock, memoryview(buf))
    return buf


def recv_frame_ex(sock: socket.socket,
                  max_frame: Optional[int] = None) -> Frame:
    """Receive one frame (either version). The length cap is enforced
    before the payload is read — a hostile length field never triggers a
    multi-GiB allocation. The payload is a ``bytearray`` read in place."""
    head = bytes(_recv_exact(sock, HEADER.size))
    magic, raw_kind, n = HEADER.unpack(head)
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    _check_len(n, max_frame)
    kind = _kind(raw_kind)
    rid, flags, version = 0, 0, 1
    if raw_kind & V2_BIT:
        version = 2
        ext = bytes(_recv_exact(sock, EXT.size))
        rid, flags = EXT.unpack(ext)
        head += ext
    payload = _recv_exact(sock, n)
    (crc,) = struct.unpack("<I", _recv_exact(sock, 4))
    if crc != (zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF):
        raise ProtocolError("frame CRC mismatch")
    return Frame(kind, payload, rid, flags, version)


def recv_frame(sock: socket.socket, max_frame: Optional[int] = None) -> tuple:
    f = recv_frame_ex(sock, max_frame=max_frame)
    return f.kind, f.payload
