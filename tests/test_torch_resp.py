"""The port's RESP parser and serializer against the JAX package's.

One case per frame of a corpus: the 24 cases of `tests/test_resp.py`
(basics, incomplete and partial frames, pipelined frames, the reference's
attack vectors: huge, negative and i64-overflowing lengths, nesting past
and under the depth cap, bad markers, invalid UTF-8, NUL bytes,
non-numeric lengths) and the attack vectors the native wire tests send
(`tests/test_native_wire.py::test_native_protocol_attack_vectors`).  Each
frame is parsed as a pipelined stream by both modules — every value,
every byte count, the same `None` for an incomplete tail, the same
RespError message — and each parsed value is serialized by both.  Then
the serializer cases.  Exact equality throughout.
"""

import pytest

from throttlecrab_tpu.server import resp as jax_resp
from throttlecrab_tpu_torch.server import resp as port_resp

_PING = b"*2\r\n$4\r\nPING\r\n$5\r\nhello\r\n"

FRAMES = {
    # basics (test_resp.py)
    "simple_string": b"+OK\r\n",
    "error": b"-ERR bad\r\n",
    "integer": b":42\r\n",
    "negative_integer": b":-7\r\n",
    "bulk_string": b"$6\r\nfoobar\r\n",
    "null_bulk_string": b"$-1\r\n",
    "empty_bulk_string": b"$0\r\n\r\n",
    "array": b"*2\r\n$3\r\nfoo\r\n$3\r\nbar\r\n",
    "null_array": b"*-1\r\n",
    # incomplete frames
    "empty": b"",
    "line_without_crlf": b"+OK",
    "short_bulk": b"$6\r\nfoo",
    "short_array": b"*2\r\n$3\r\nfoo\r\n",
    "short_array_element": b"*2\r\n$3\r\nfoo\r\n$3\r\nba",
    # incremental parse across chunks: the whole frame, then every prefix
    "incremental_whole": _PING,
    **{f"incremental_prefix_{cut}": _PING[:cut] for cut in (1, 4, 9, 20)},
    # pipelined
    "pipelined": b"+A\r\n+B\r\n",
    "pipelined_throttle": (
        b"*5\r\n$8\r\nTHROTTLE\r\n$2\r\npk\r\n$2\r\n10\r\n$3\r\n100\r\n"
        b"$2\r\n60\r\n" * 3 + b"*1\r\n$4\r\nPI"
    ),
    # security (test_resp.py)
    "huge_bulk_length": b"$999999999999\r\n",
    "negative_bulk_length": b"$-2\r\n",
    "huge_array_size": b"*999999999999\r\n",
    "negative_array_size": b"*-2\r\n",
    "i64_overflow_length": b"$92233720368547758070\r\n",
    "nesting_past_cap": b"*1\r\n" * 200 + b":1\r\n",
    "nesting_under_cap": b"*1\r\n" * (jax_resp.MAX_ARRAY_DEPTH - 1)
    + b":1\r\n",
    "invalid_marker": b"!bad\r\n",
    "invalid_utf8": b"$2\r\n\xff\xfe\r\n",
    "nul_bytes": b"$3\r\na\x00b\r\n",
    "non_numeric_length": b"$abc\r\n",
    "non_numeric_integer": b":12x\r\n",
    "unicode_digit_length": "$٣\r\nabc\r\n".encode(),
    # attack vectors of the native wire tests
    "wire_huge_array": b"*999999999999\r\n",
    "wire_inline": b"!inline\r\n",
    "wire_huge_bulk_in_array": b"*1\r\n$99999999999999\r\n",
}


def _plain(value):
    """A RESP value of either module as a comparable tuple."""
    kind = type(value).__name__
    if kind == "Array":
        return (kind, tuple(_plain(v) for v in value.value))
    return (kind, value.value)


def _parse_stream(mod, data):
    """Parse `data` as a pipelined stream: [(value, consumed, value
    re-serialized)...], then ("incomplete", rest) or ("error", message)."""
    out = []
    parser = mod.RespParser()
    while True:
        try:
            res = parser.parse(data)
        except mod.RespError as e:
            out.append(("error", str(e)))
            return out
        if res is None:
            out.append(("incomplete", data))
            return out
        value, consumed = res
        out.append((_plain(value), consumed, mod.serialize(value)))
        data = data[consumed:]


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_parse_and_reserialize_identical(name):
    data = FRAMES[name]
    assert _parse_stream(port_resp, data) == _parse_stream(jax_resp, data)


def _values(mod):
    return {
        "simple": mod.SimpleString("OK"),
        "error": mod.Error("ERR x"),
        "integer": mod.Integer(-123),
        "bulk": mod.BulkString("hello"),
        "null_bulk": mod.BulkString(None),
        "nested": mod.Array((
            mod.Integer(1), mod.BulkString("a"),
            mod.Array((mod.Integer(2),)),
        )),
        "throttle_reply": mod.Array(
            tuple(mod.Integer(n) for n in (1, 10, 9, 60, 0))
        ),
        "unicode_bulk": mod.BulkString("kéy☃"),
        "i64_extremes": mod.Array(
            (mod.Integer(-(1 << 63)), mod.Integer((1 << 63) - 1))
        ),
    }


@pytest.mark.parametrize("name", sorted(_values(port_resp)))
def test_serialize_identical_and_round_trips(name):
    value = _values(port_resp)[name]
    raw = port_resp.serialize(value)
    assert raw == jax_resp.serialize(_values(jax_resp)[name])
    parsed, consumed = port_resp.RespParser().parse(raw)
    assert parsed == value and consumed == len(raw)


def test_serialize_rejects_what_is_not_a_value_and_caps_match():
    for mod in (port_resp, jax_resp):
        with pytest.raises(TypeError):
            mod.serialize(("not", "a", "value"))
    assert (
        port_resp.MAX_BULK_STRING_SIZE,
        port_resp.MAX_ARRAY_SIZE,
        port_resp.MAX_ARRAY_DEPTH,
    ) == (
        jax_resp.MAX_BULK_STRING_SIZE,
        jax_resp.MAX_ARRAY_SIZE,
        jax_resp.MAX_ARRAY_DEPTH,
    )
