"""Proto2 wire codec for the agent protocol's 11 messages
(diral_tpu/interop/ma_messages.proto), written out by hand so that the
port needs no protobuf runtime, no ``protoc`` and no generated module.

The bytes are protobuf's own: fields in field-number order, every set
field written (proto2 presence: an optional field set to its default is
written too), repeated scalars unpacked, int32 as a varint sign-extended
to 64 bits (10 bytes when negative), float / double little-endian,
nested messages length-delimited.  Parsing also takes packed repeated
scalars and skips unknown fields, as protobuf's parser does.

The surface is the subset of the generated classes' that the bridge
uses: ``Msg(field=value, ...)``, attribute access (an unset optional
field reads as its default), ``SerializeToString()`` and
``Msg.FromString(data)``.  A float field holds the float32-rounded value
of what was set, as protobuf's does; ``==`` compares the set fields.
"""

from __future__ import annotations

import struct

INT32, BOOL, FLOAT, DOUBLE, MESSAGE = "int32", "bool", "float", "double", "message"
REQUIRED, OPTIONAL, REPEATED = "required", "optional", "repeated"

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")
_WIRE = {INT32: 0, BOOL: 0, FLOAT: 5, DOUBLE: 1, MESSAGE: 2}
_DEFAULT = {INT32: 0, BOOL: False, FLOAT: 0.0, DOUBLE: 0.0}


class DecodeError(ValueError):
    """Malformed or incomplete message bytes."""


class EncodeError(ValueError):
    """A required field is not set."""


def _varint(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= len(data):
            raise DecodeError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint longer than 10 bytes")


def _as_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _coerce(kind: str, sub, value):
    if kind == INT32:
        if isinstance(value, bool) or int(value) != value:
            raise TypeError(f"int32 field given {value!r}")
        value = int(value)
        if not -(1 << 31) <= value < 1 << 31:
            raise ValueError(f"{value} out of int32 range")
        return value
    if kind == BOOL:
        return bool(value)
    if kind == FLOAT:
        return _F32.unpack(_F32.pack(float(value)))[0]
    if kind == DOUBLE:
        return float(value)
    if not isinstance(value, sub):
        raise TypeError(f"expected {sub.__name__}, got {type(value).__name__}")
    return value


def _encode_one(kind: str, value) -> bytes:
    if kind in (INT32, BOOL):
        return _varint(int(value))
    if kind == FLOAT:
        return _F32.pack(value)
    if kind == DOUBLE:
        return _F64.pack(value)
    body = value.SerializeToString()
    return _varint(len(body)) + body


class Message:
    """Base of the schema classes below; ``FIELDS`` lists (number, name,
    kind, label, nested class or None)."""

    FIELDS: tuple = ()
    _BY_NAME: dict = {}
    _BY_NUM: dict = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._BY_NAME = {f[1]: f for f in cls.FIELDS}
        cls._BY_NUM = {f[0]: f for f in cls.FIELDS}

    def __init__(self, **values):
        object.__setattr__(self, "_values", {})
        for f in self.FIELDS:
            if f[3] == REPEATED:
                self._values[f[1]] = []
        for name, value in values.items():
            setattr(self, name, value)

    def __setattr__(self, name, value):
        f = self._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{type(self).__name__} has no field {name!r}")
        _, _, kind, label, sub = f
        if label == REPEATED:
            self._values[name] = [_coerce(kind, sub, v) for v in value]
        elif value is None:
            self._values.pop(name, None)
        else:
            self._values[name] = _coerce(kind, sub, value)

    def __getattr__(self, name):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(name)
        values = object.__getattribute__(self, "_values")
        return values[name] if name in values else _DEFAULT[f[2]]

    def __eq__(self, other):
        return type(other) is type(self) and other._values == self._values

    def __repr__(self):
        body = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"{type(self).__name__}({body})"

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for num, name, kind, label, _ in self.FIELDS:
            tag = _varint((num << 3) | _WIRE[kind])
            if label == REPEATED:
                for v in self._values[name]:
                    out += tag + _encode_one(kind, v)
            elif name in self._values:
                out += tag + _encode_one(kind, self._values[name])
            elif label == REQUIRED:
                raise EncodeError(
                    f"{type(self).__name__} is missing required field {name}")
        return bytes(out)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        values = msg._values
        data = bytes(data)
        pos, end = 0, len(data)
        while pos < end:
            key, pos = _read_varint(data, pos)
            num, wire = key >> 3, key & 7
            f = cls._BY_NUM.get(num)
            if f is not None and wire == _WIRE[f[2]]:
                kind, label, sub = f[2], f[3], f[4]
                if kind in (INT32, BOOL):
                    raw, pos = _read_varint(data, pos)
                    v = _as_int32(raw) if kind == INT32 else raw != 0
                elif kind == FLOAT:
                    if pos + 4 > end:
                        raise DecodeError("truncated float")
                    v = _F32.unpack_from(data, pos)[0]
                    pos += 4
                elif kind == DOUBLE:
                    if pos + 8 > end:
                        raise DecodeError("truncated double")
                    v = _F64.unpack_from(data, pos)[0]
                    pos += 8
                else:
                    n, pos = _read_varint(data, pos)
                    if pos + n > end:
                        raise DecodeError("truncated nested message")
                    v = sub.FromString(data[pos:pos + n])
                    pos += n
                if label == REPEATED:
                    values[f[1]].append(v)
                else:
                    values[f[1]] = v
            elif (f is not None and f[3] == REPEATED and wire == 2
                  and f[2] != MESSAGE):
                pos = _read_packed(data, pos, f[2], values[f[1]])
            else:
                pos = _skip(data, pos, wire)
        if pos != end:
            raise DecodeError("field runs past the end of the message")
        missing = [f[1] for f in cls.FIELDS
                   if f[3] == REQUIRED and f[1] not in values]
        if missing:
            raise DecodeError(f"{cls.__name__} is missing required fields "
                              f"{missing}")
        return msg


def _read_packed(data: bytes, pos: int, kind: str, into: list) -> int:
    n, pos = _read_varint(data, pos)
    stop = pos + n
    if stop > len(data):
        raise DecodeError("truncated packed field")
    while pos < stop:
        if kind in (INT32, BOOL):
            raw, pos = _read_varint(data, pos)
            into.append(_as_int32(raw) if kind == INT32 else raw != 0)
        else:
            s = _F32 if kind == FLOAT else _F64
            into.append(s.unpack_from(data, pos)[0])
            pos += s.size
    if pos != stop:
        raise DecodeError("packed field overruns its length")
    return pos


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == 0:
        return _read_varint(data, pos)[1]
    if wire == 1:
        return pos + 8
    if wire == 2:
        n, pos = _read_varint(data, pos)
        return pos + n
    if wire == 5:
        return pos + 4
    raise DecodeError(f"unsupported wire type {wire}")


# -- the schema (ma_messages.proto, field numbers as there) ---------------


class MA_SimInitMsg(Message):
    FIELDS = ((1, "total_users", INT32, REQUIRED, None),
              (2, "action_space", INT32, REQUIRED, None),
              (3, "state_space", INT32, REQUIRED, None),
              (4, "state_space_type", INT32, REQUIRED, None))


class MA_SimInitAck(Message):
    FIELDS = ((1, "done", BOOL, OPTIONAL, None),
              (2, "stopSimReq", BOOL, OPTIONAL, None))


class MA_SchedulingRequest(Message):
    FIELDS = ((1, "user_id", INT32, REQUIRED, None),
              (2, "state", INT32, REPEATED, None),
              (3, "SN", INT32, REQUIRED, None))


class MA_SchedulingRequestSyn(Message):
    FIELDS = ((1, "user_id", INT32, REQUIRED, None),
              (2, "state", INT32, REPEATED, None),
              (3, "SN", INT32, REQUIRED, None),
              (4, "reward", FLOAT, REQUIRED, None))


class MA_NeighborTableEntry(Message):
    FIELDS = ((1, "pos_x", FLOAT, REQUIRED, None),
              (2, "pos_y", FLOAT, REQUIRED, None),
              (3, "seq_num", INT32, REQUIRED, None),
              (4, "last_update", INT32, REQUIRED, None))


class MA_NeighborTable(Message):
    FIELDS = ((1, "neighbor_table", MESSAGE, REPEATED, MA_NeighborTableEntry),)


class MA_SchedulingRequestSynDist(Message):
    FIELDS = ((1, "user_id", INT32, REQUIRED, None),
              (2, "neighbor", MESSAGE, REPEATED, MA_NeighborTableEntry),
              (3, "SN", INT32, REQUIRED, None),
              (4, "reward", FLOAT, REQUIRED, None))


class SPS_SchedulingRequestSyn(Message):
    FIELDS = ((1, "user_id", INT32, REQUIRED, None),
              (2, "state", DOUBLE, REPEATED, None),
              (3, "SN", INT32, REQUIRED, None),
              (4, "reward", FLOAT, REQUIRED, None))


class MA_SchedulingGrant(Message):
    FIELDS = ((1, "time_stamp", INT32, REQUIRED, None),
              (2, "stop_simulation", BOOL, OPTIONAL, None))


class MA_RewardSent(Message):
    FIELDS = ((1, "user_id", INT32, REQUIRED, None),
              (2, "SN", INT32, REQUIRED, None),
              (3, "reward", FLOAT, REQUIRED, None))


class MA_RewardSentAll(Message):
    FIELDS = ((1, "all_rewards", MESSAGE, REPEATED, MA_RewardSent),)


MESSAGES = (MA_SimInitMsg, MA_SimInitAck, MA_SchedulingRequest,
            MA_SchedulingRequestSyn, MA_NeighborTableEntry, MA_NeighborTable,
            MA_SchedulingRequestSynDist, SPS_SchedulingRequestSyn,
            MA_SchedulingGrant, MA_RewardSent, MA_RewardSentAll)
