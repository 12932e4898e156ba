"""Logical data types and field roles.

Equivalent surface to the reference's ``FieldSpec.DataType`` enum
(pinot-spi/.../data/FieldSpec.java:383-398) and the dimension/metric/datetime
field taxonomy, re-expressed with numpy/JAX storage mappings instead of Java
stored types.
"""

from __future__ import annotations

import enum

import numpy as np


class DataType(enum.Enum):
    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BIG_DECIMAL = "BIG_DECIMAL"
    BOOLEAN = "BOOLEAN"
    TIMESTAMP = "TIMESTAMP"  # millis since epoch, stored as LONG
    STRING = "STRING"
    JSON = "JSON"
    BYTES = "BYTES"

    # ---- classification -------------------------------------------------
    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self in (DataType.INT, DataType.LONG, DataType.BOOLEAN, DataType.TIMESTAMP)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT, DataType.DOUBLE, DataType.BIG_DECIMAL)

    @property
    def is_string_like(self) -> bool:
        return self in (DataType.STRING, DataType.JSON, DataType.BYTES)

    # ---- storage mappings ----------------------------------------------
    @property
    def np_dtype(self) -> np.dtype:
        """Host numpy storage dtype for raw (non-dict-encoded) values."""
        return _NP_DTYPES[self]

    @property
    def device_dtype(self) -> np.dtype:
        """On-device dtype for raw value columns.

        Integral types widen to int64 so block sums stay exact (TPU lowers
        int64 arithmetic to int32 pairs); floats compute in float32 with
        float64-on-host final reduction.
        """
        if self.is_integral:
            return np.dtype(np.int64)
        if self.is_floating:
            return np.dtype(np.float32)
        raise ValueError(f"{self} has no raw device representation (dict-encode it)")

    @property
    def default_null(self):
        """Default null placeholder, mirroring FieldSpec default null values."""
        return _NULL_DEFAULTS[self]

    def convert(self, value):
        """Coerce an ingested python value to this type's canonical python value."""
        if value is None:
            return self.default_null
        if self is DataType.BOOLEAN:
            if isinstance(value, str):
                return 1 if value.strip().lower() in ("true", "1") else 0
            return int(bool(value))
        if self.is_integral:
            return int(value)
        if self.is_floating:
            return float(value)
        if self is DataType.BYTES:
            if isinstance(value, str):
                return bytes.fromhex(value)
            return bytes(value)
        return str(value)


_NUMERIC = frozenset(
    {
        DataType.INT,
        DataType.LONG,
        DataType.FLOAT,
        DataType.DOUBLE,
        DataType.BIG_DECIMAL,
        DataType.BOOLEAN,
        DataType.TIMESTAMP,
    }
)

_NP_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.BIG_DECIMAL: np.dtype(np.float64),
    DataType.BOOLEAN: np.dtype(np.int32),
    DataType.TIMESTAMP: np.dtype(np.int64),
    DataType.STRING: np.dtype(object),
    DataType.JSON: np.dtype(object),
    DataType.BYTES: np.dtype(object),
}

_NULL_DEFAULTS = {
    DataType.INT: -(2**31),
    DataType.LONG: -(2**63),
    DataType.FLOAT: float("-inf"),
    DataType.DOUBLE: float("-inf"),
    DataType.BIG_DECIMAL: float("-inf"),
    DataType.BOOLEAN: 0,
    DataType.TIMESTAMP: 0,
    DataType.STRING: "null",
    DataType.JSON: "null",
    DataType.BYTES: b"",
}


class FieldRole(enum.Enum):
    """Dimension vs metric vs datetime, as in the reference's FieldSpec subclasses."""

    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    DATE_TIME = "DATE_TIME"
