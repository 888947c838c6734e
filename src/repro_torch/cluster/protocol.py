"""Router <-> worker wire protocol (normative spec: docs/cluster.md; a
copy of ``repro.cluster.protocol``: the port's frames are the
reference's, byte for byte, so either side talks to the other).

One frame = a fixed little-endian prelude, a JSON header, and an opaque
binary payload:

    magic       4s   b"LPRC"
    version     B    1
    op          B    request/reply opcode (below)
    seq         I    client-chosen sequence number, echoed in the reply
    header_len  I    byte length of the JSON header
    payload_len Q    byte length of the binary payload
    header      header_len bytes of UTF-8 JSON (an object)
    payload     payload_len bytes

The codec (:func:`encode_frame` / :func:`decode_frame`) is pure bytes
in, bytes out — no sockets — so the docs' executable examples and a
third-party implementation exercise exactly what ships on the wire.
Arrays cross as raw C-order bytes next to a ``{"dtype", "shape",
"nbytes"}`` JSON meta (:func:`pack_arrays` / :func:`unpack_arrays`);
nothing on the wire is pickled.  :func:`pack_arrays` writes the bytes of
a C-contiguous copy, so a strided view (a tile cut out of a decoded
batch) crosses as its values in row-major order.

A worker answers every request frame with ``OP_REPLY`` (echoing
``seq``) or ``OP_ERROR`` whose header is ``{"error": type,
"message": str}`` — transport failures are the *absence* of a reply,
and are the router's failover trigger, never an in-band frame.
"""
from __future__ import annotations

import json
import socket
import struct

import numpy as np

MAGIC = b"LPRC"
VERSION = 1

# request opcodes
OP_PING = 1          # liveness probe                     -> {}
OP_PUT_SHARD = 2     # {name} + sparse v2 container       -> {}
OP_PUT_CHAIN = 3     # {name, entry} + chain frame bytes  -> {}
OP_APPEND_FRAME = 4  # {name, dtype, shape} + frame bytes -> {t}
OP_READ_TILES = 5    # {name, tile_ids}                   -> {tiles} + bytes
OP_READ_FRAME = 6    # {name, t}                          -> meta + bytes
OP_INFO = 7          # {name}                             -> {info}
OP_EXTRA = 8         # {name, tag}                        -> {present} + bytes
OP_METRICS = 9       # {}                                 -> {service, cache}
OP_NAMES = 10        # {}                                 -> {names}
OP_DELETE = 11       # {name}                             -> {}
# reply opcodes
OP_REPLY = 32
OP_ERROR = 33

_OP_NAMES = {v: k[3:] for k, v in list(globals().items())
             if k.startswith("OP_") and isinstance(v, int)}


def op_name(op: int) -> str:
    """Human-readable opcode name (``"READ_TILES"``), for spans/logs."""
    return _OP_NAMES.get(op, f"OP{op}")

_PRELUDE = struct.Struct("<4sBBIIQ")
PRELUDE_SIZE = _PRELUDE.size
MAX_HEADER_BYTES = 1 << 24  # corrupt-prelude guard, not a design limit


class NeedMore(Exception):
    """Frame incomplete — ``.needed`` more bytes are required (at
    least; re-check after the next read)."""

    def __init__(self, needed: int):
        super().__init__(f"need >= {needed} more bytes")
        self.needed = needed


def encode_frame(op: int, seq: int, header: dict,
                 payload: bytes = b"") -> bytes:
    """Serialize one protocol frame."""
    hb = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    return _PRELUDE.pack(MAGIC, VERSION, int(op), int(seq), len(hb),
                         len(payload)) + hb + bytes(payload)


def decode_frame(buf) -> tuple[int, int, dict, bytes, int]:
    """Parse one frame from the head of ``buf``.

    Returns ``(op, seq, header, payload, consumed)``; raises
    :class:`NeedMore` when ``buf`` does not yet hold a whole frame and
    ``ValueError`` on a corrupt prelude.
    """
    buf = memoryview(bytes(buf) if not isinstance(buf, (bytes, bytearray,
                                                        memoryview)) else buf)
    if len(buf) < PRELUDE_SIZE:
        raise NeedMore(PRELUDE_SIZE - len(buf))
    magic, version, op, seq, hlen, plen = _PRELUDE.unpack_from(buf)
    if magic != MAGIC:
        raise ValueError("bad frame magic")
    if version != VERSION:
        raise ValueError(f"unsupported protocol version {version}")
    if hlen > MAX_HEADER_BYTES:
        raise ValueError("corrupt frame (header length)")
    total = PRELUDE_SIZE + hlen + plen
    if len(buf) < total:
        raise NeedMore(total - len(buf))
    header = json.loads(bytes(buf[PRELUDE_SIZE:PRELUDE_SIZE + hlen]))
    if not isinstance(header, dict):
        raise ValueError("frame header must be a JSON object")
    payload = bytes(buf[PRELUDE_SIZE + hlen:total])
    return op, seq, header, payload, total


# ----------------------------------------------------- array marshalling

def pack_arrays(arrays) -> tuple[list[dict], bytes]:
    """ndarrays -> (metas, concatenated C-order bytes)."""
    metas, chunks = [], []
    for a in arrays:
        a = np.ascontiguousarray(a)
        b = a.tobytes()
        metas.append({"dtype": str(a.dtype), "shape": list(a.shape),
                      "nbytes": len(b)})
        chunks.append(b)
    return metas, b"".join(chunks)


def unpack_arrays(metas, payload: bytes) -> list[np.ndarray]:
    """Inverse of :func:`pack_arrays` (validates total length)."""
    out, off = [], 0
    for m in metas:
        n = int(m["nbytes"])
        seg = payload[off:off + n]
        if len(seg) != n:
            raise ValueError("array payload shorter than its meta")
        out.append(np.frombuffer(seg, dtype=np.dtype(m["dtype"]))
                   .reshape([int(d) for d in m["shape"]]))
        off += n
    if off != len(payload):
        raise ValueError("array payload has bytes past the last meta")
    return out


# --------------------------------------------------------- socket framing

def send_frame(sock: socket.socket, op: int, seq: int, header: dict,
               payload: bytes = b"") -> None:
    sock.sendall(encode_frame(op, seq, header, payload))


def recv_frame(sock: socket.socket) -> tuple[int, int, dict, bytes]:
    """Blocking read of exactly one frame (raises ConnectionError on a
    peer that closes mid-frame; an EOF on a frame boundary raises too —
    callers treat any failure here as the shard being down)."""
    buf = bytearray()
    need = PRELUDE_SIZE
    while True:
        while len(buf) < need:
            chunk = sock.recv(min(1 << 20, need - len(buf)))
            if not chunk:
                raise ConnectionError("peer closed mid-frame")
            buf += chunk
        try:
            op, seq, header, payload, consumed = decode_frame(buf)
        except NeedMore as e:
            need = len(buf) + e.needed
            continue
        if consumed != len(buf):  # pragma: no cover - exact reads above
            raise ValueError("trailing bytes after frame")
        return op, seq, header, payload
