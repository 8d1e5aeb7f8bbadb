"""RESP (Redis Serialization Protocol) parser and serializer.

The port's copy of `throttlecrab_tpu/server/resp.py`, the behavioral twin
of the reference's hand-rolled implementation (`transport/redis/resp.rs`),
including its hardening limits: bulk strings capped at 512 MB, arrays at
1 M elements, nesting at depth 128 (`resp.rs:8-10`); invalid type markers,
malformed lengths, and invalid UTF-8 are parse errors, and incomplete
frames return None so the connection loop can accumulate more bytes.

Values are small frozen dataclasses: SimpleString / Error / Integer /
BulkString (None = null) / Array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

MAX_BULK_STRING_SIZE = 512 * 1024 * 1024  # resp.rs:8
MAX_ARRAY_SIZE = 1024 * 1024  # resp.rs:9
MAX_ARRAY_DEPTH = 128  # resp.rs:10


class RespError(ValueError):
    """Malformed RESP input (protocol violation, not incomplete data)."""


@dataclass(frozen=True)
class SimpleString:
    value: str


@dataclass(frozen=True)
class Error:
    value: str


@dataclass(frozen=True)
class Integer:
    value: int


@dataclass(frozen=True)
class BulkString:
    value: Optional[str]  # None = null bulk string ($-1)


@dataclass(frozen=True)
class Array:
    value: Tuple["RespValue", ...]


RespValue = Union[SimpleString, Error, Integer, BulkString, Array]


class RespParser:
    """Incremental parser: parse() -> (value, consumed) or None if more
    data is needed (resp.rs:40-53)."""

    def __init__(self) -> None:
        self._depth = 0

    def parse(self, data: bytes):
        if not data:
            return None
        marker = data[0:1]
        if marker == b"+":
            return self._parse_line(data, SimpleString)
        if marker == b"-":
            return self._parse_line(data, Error)
        if marker == b":":
            return self._parse_integer(data)
        if marker == b"$":
            return self._parse_bulk_string(data)
        if marker == b"*":
            return self._parse_array(data)
        raise RespError(f"Invalid RESP type marker: {chr(data[0])}")

    # ------------------------------------------------------------------ #

    @staticmethod
    def _read_line(data: bytes):
        """(line_without_crlf, consumed) or None if incomplete."""
        idx = data.find(b"\r\n")
        if idx == -1:
            return None
        return data[:idx], idx + 2

    def _parse_line(self, data: bytes, ctor):
        r = self._read_line(data)
        if r is None:
            return None
        line, consumed = r
        return ctor(self._utf8(line[1:])), consumed

    def _parse_integer(self, data: bytes):
        r = self._read_line(data)
        if r is None:
            return None
        line, consumed = r
        return Integer(self._int(line[1:])), consumed

    def _parse_bulk_string(self, data: bytes):
        r = self._read_line(data)
        if r is None:
            return None
        line, consumed = r
        length = self._int(line[1:])
        if length == -1:
            return BulkString(None), consumed
        if not 0 <= length <= MAX_BULK_STRING_SIZE:
            raise RespError(f"Invalid bulk string length: {length}")
        if len(data) < consumed + length + 2:
            return None
        raw = data[consumed : consumed + length]
        return BulkString(self._utf8(raw)), consumed + length + 2

    def _parse_array(self, data: bytes):
        if self._depth >= MAX_ARRAY_DEPTH:
            raise RespError("Maximum array nesting depth exceeded")
        r = self._read_line(data)
        if r is None:
            return None
        line, consumed = r
        count = self._int(line[1:])
        if count == -1:
            return Array(()), consumed
        if not 0 <= count <= MAX_ARRAY_SIZE:
            raise RespError(f"Invalid array size: {count}")
        elements: List[RespValue] = []
        self._depth += 1
        try:
            for _ in range(count):
                res = self.parse(data[consumed:])
                if res is None:
                    return None
                value, n = res
                elements.append(value)
                consumed += n
        finally:
            self._depth -= 1
        return Array(tuple(elements)), consumed

    @staticmethod
    def _utf8(raw: bytes) -> str:
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError as e:
            raise RespError(f"invalid UTF-8: {e}") from e

    @staticmethod
    def _int(raw: bytes) -> int:
        try:
            text = raw.decode("ascii")
        except UnicodeDecodeError as e:
            raise RespError(f"invalid integer: {e}") from e
        # Rust's i64::parse: optional sign + digits only, no whitespace.
        body = text[1:] if text[:1] in ("+", "-") else text
        if not body or not body.isdigit():
            raise RespError(f"invalid integer: {text!r}")
        return int(text)


def serialize(value: RespValue) -> bytes:
    """resp.rs:188-232."""
    if isinstance(value, SimpleString):
        return b"+" + value.value.encode() + b"\r\n"
    if isinstance(value, Error):
        return b"-" + value.value.encode() + b"\r\n"
    if isinstance(value, Integer):
        return b":" + str(value.value).encode() + b"\r\n"
    if isinstance(value, BulkString):
        if value.value is None:
            return b"$-1\r\n"
        raw = value.value.encode()
        return b"$" + str(len(raw)).encode() + b"\r\n" + raw + b"\r\n"
    if isinstance(value, Array):
        out = b"*" + str(len(value.value)).encode() + b"\r\n"
        for element in value.value:
            out += serialize(element)
        return out
    raise TypeError(f"not a RespValue: {value!r}")
