"""AWS event-stream binary framing for SelectObjectContent responses.

Wire format (reference: ``internal/s3select/message.go``):

    message  := prelude crc(prelude) headers payload crc(message-so-far)
    prelude  := u32be(total_length) u32be(headers_length)
    header   := u8(name_len) name u8(7) u16be(value_len) value   -- type 7 = string

Message kinds: Records, Continuation, Progress, Stats, End, and error frames
(``:message-type`` = ``error``).
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterator, List, Optional, Tuple


def _encode_headers(headers: List[Tuple[str, str]]) -> bytes:
    out = bytearray()
    for name, value in headers:
        nb = name.encode()
        vb = value.encode()
        out.append(len(nb))
        out += nb
        out.append(7)  # string type
        out += struct.pack(">H", len(vb))
        out += vb
    return bytes(out)


def encode_message(headers: List[Tuple[str, str]], payload: bytes) -> bytes:
    hdr = _encode_headers(headers)
    total = 4 + 4 + 4 + len(hdr) + len(payload) + 4
    prelude = struct.pack(">II", total, len(hdr))
    prelude_crc = struct.pack(">I", zlib.crc32(prelude) & 0xFFFFFFFF)
    body = prelude + prelude_crc + hdr + payload
    msg_crc = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    return body + msg_crc


def records_message(payload: bytes) -> bytes:
    return encode_message(
        [
            (":message-type", "event"),
            (":event-type", "Records"),
            (":content-type", "application/octet-stream"),
        ],
        payload,
    )


def continuation_message() -> bytes:
    return encode_message(
        [(":message-type", "event"), (":event-type", "Cont")], b""
    )


def _progress_xml(scanned: int, processed: int, returned: int, root: str) -> bytes:
    return (
        f'<?xml version="1.0" encoding="UTF-8"?><{root}>'
        f"<BytesScanned>{scanned}</BytesScanned>"
        f"<BytesProcessed>{processed}</BytesProcessed>"
        f"<BytesReturned>{returned}</BytesReturned>"
        f"</{root}>"
    ).encode()


def progress_message(scanned: int, processed: int, returned: int) -> bytes:
    return encode_message(
        [
            (":message-type", "event"),
            (":event-type", "Progress"),
            (":content-type", "text/xml"),
        ],
        _progress_xml(scanned, processed, returned, "Progress"),
    )


def stats_message(scanned: int, processed: int, returned: int) -> bytes:
    return encode_message(
        [
            (":message-type", "event"),
            (":event-type", "Stats"),
            (":content-type", "text/xml"),
        ],
        _progress_xml(scanned, processed, returned, "Stats"),
    )


def end_message() -> bytes:
    return encode_message([(":message-type", "event"), (":event-type", "End")], b"")


def error_message(code: str, message: str) -> bytes:
    return encode_message(
        [
            (":message-type", "error"),
            (":error-code", code),
            (":error-message", message),
        ],
        b"",
    )


# ------------------------------------------------------------------ decoding
# (used by tests and any in-framework client)


def decode_messages(data: bytes) -> Iterator[dict]:
    """Parse a concatenated event-stream buffer into message dicts."""
    i = 0
    while i < len(data):
        if len(data) - i < 16:
            raise ValueError("truncated event-stream message")
        total, hdr_len = struct.unpack_from(">II", data, i)
        prelude_crc = struct.unpack_from(">I", data, i + 8)[0]
        if zlib.crc32(data[i:i + 8]) & 0xFFFFFFFF != prelude_crc:
            raise ValueError("prelude CRC mismatch")
        msg = data[i:i + total]
        if len(msg) < total:
            raise ValueError("truncated message body")
        body_crc = struct.unpack(">I", msg[-4:])[0]
        if zlib.crc32(msg[:-4]) & 0xFFFFFFFF != body_crc:
            raise ValueError("message CRC mismatch")
        headers = {}
        j = 12
        end = 12 + hdr_len
        while j < end:
            nlen = msg[j]
            j += 1
            name = msg[j:j + nlen].decode()
            j += nlen
            typ = msg[j]
            j += 1
            if typ != 7:
                raise ValueError(f"unsupported header type {typ}")
            vlen = struct.unpack_from(">H", msg, j)[0]
            j += 2
            headers[name] = msg[j:j + vlen].decode()
            j += vlen
        payload = msg[end:-4]
        yield {"headers": headers, "payload": payload}
        i += total
