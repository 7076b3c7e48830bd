"""Typed-socket nodes (JAX counterpart: raytracingproject_tpu/models/node.py).

Every scene entity declares typed sockets with defaults; `set` coerces
values exactly as the JAX package does (python floats, float32 colors
and transforms), so the host compile sees the same numbers. XML IO and
modified-flag diffing are not part of this slice.
"""

from __future__ import annotations

import numpy as np


class SocketType:
    BOOLEAN = "boolean"
    FLOAT = "float"
    INT = "int"
    UINT = "uint"
    COLOR = "color"
    VECTOR = "vector"
    POINT = "point"
    NORMAL = "normal"
    ENUM = "enum"
    STRING = "string"
    TRANSFORM = "transform"
    BOOLEAN_ARRAY = "boolean[]"
    INT_ARRAY = "int[]"
    POINT_ARRAY = "point[]"

    FLOAT3_TYPES = (COLOR, VECTOR, POINT, NORMAL)

    def __init__(self, name, type, default=None, enum_values=None):
        self.name = name
        self.type = type
        self.default = default
        self.enum_values = enum_values  # {name: int} for ENUM

    def coerce(self, value):
        t = self.type
        if t == SocketType.BOOLEAN:
            return bool(value)
        if t == SocketType.FLOAT:
            return float(value)
        if t in (SocketType.INT, SocketType.UINT):
            return int(value)
        if t in SocketType.FLOAT3_TYPES:
            a = np.asarray(value, np.float32).reshape(-1)
            if a.size == 1:
                a = np.repeat(a, 3)
            assert a.size == 3, f"expected 3 floats, got {a.size}"
            return a
        if t == SocketType.STRING:
            return str(value)
        if t == SocketType.ENUM:
            if value not in self.enum_values:
                raise ValueError(
                    f"unknown enum value '{value}' for socket {self.name}; "
                    f"expected one of {sorted(self.enum_values)}")
            return value
        if t == SocketType.TRANSFORM:
            a = np.asarray(value, np.float32)
            if a.shape == (4, 4):
                a = a[:3]
            assert a.shape == (3, 4), f"transform must be 3x4, got {a.shape}"
            return a
        if t == SocketType.POINT_ARRAY:
            return np.asarray(value, np.float32).reshape(-1, 3)
        if t == SocketType.INT_ARRAY:
            return np.asarray(value, np.int32).reshape(-1)
        if t == SocketType.BOOLEAN_ARRAY:
            return np.asarray(value, bool).reshape(-1)
        raise ValueError(f"unhandled socket type {t}")


class Node:
    """Base scene node: `SOCKETS = [SocketType(...), ...]` gives keyword
    construction, typed `set`, attribute access and enum lookup."""

    SOCKETS = []

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        merged = {}
        for base in reversed(cls.__mro__):
            for s in getattr(base, "SOCKETS", []):
                merged[s.name] = s
        cls._socket_map = merged

    def __init__(self, name="", **kwargs):
        self.name = name
        for sname, sock in self._socket_map.items():
            default = sock.default
            if isinstance(default, (list, tuple)) \
                    and sock.type in SocketType.FLOAT3_TYPES:
                default = np.asarray(default, np.float32)
            elif isinstance(default, np.ndarray):
                default = default.copy()
            object.__setattr__(self, sname, default)
        for k, v in kwargs.items():
            self.set(k, v)

    def set(self, socket_name, value):
        sock = self._socket_map.get(socket_name)
        if sock is None:
            raise AttributeError(
                f"{type(self).__name__} has no socket '{socket_name}'")
        object.__setattr__(self, socket_name, sock.coerce(value))

    def get(self, socket_name):
        return getattr(self, socket_name)

    def get_enum_int(self, socket_name):
        return self._socket_map[socket_name].enum_values[
            getattr(self, socket_name)]

    def __repr__(self):
        return f"<{type(self).__name__} '{self.name}'>"
