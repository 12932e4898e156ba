"""Table schema: named, typed, role-tagged columns.

Equivalent surface to the reference's ``Schema`` / ``FieldSpec``
(pinot-spi/.../data/Schema.java, FieldSpec.java): dimension / metric /
datetime fields, single- or multi-value, JSON round-trip compatible with the
reference's schema JSON shape (dimensionFieldSpecs etc.) so existing table
definitions can be reused.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable

from pinot_tpu_torch.common.datatypes import DataType, FieldRole


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    data_type: DataType
    role: FieldRole = FieldRole.DIMENSION
    single_value: bool = True
    default_null: object = None
    # DATE_TIME only: format/granularity strings (kept opaque, as in
    # DateTimeFieldSpec).
    format: str | None = None
    granularity: str | None = None

    def null_value(self):
        if self.default_null is not None:
            return self.default_null
        # FieldSpec defaults: metrics null to ZERO (additive identity),
        # dimensions/datetimes to the type's sentinel
        # (DEFAULT_METRIC_NULL_VALUE_OF_* vs DEFAULT_DIMENSION_*)
        if self.role is FieldRole.METRIC and \
                self.data_type.np_dtype is not None and \
                not self.data_type.is_string_like:
            return self.data_type.np_dtype.type(0).item()
        return self.data_type.default_null

    def to_json(self) -> dict:
        d = {"name": self.name, "dataType": self.data_type.value}
        if not self.single_value:
            d["singleValueField"] = False
        if self.default_null is not None:
            d["defaultNullValue"] = self.default_null
        if self.format:
            d["format"] = self.format
        if self.granularity:
            d["granularity"] = self.granularity
        return d


@dataclasses.dataclass
class Schema:
    name: str
    fields: dict[str, FieldSpec]
    primary_key_columns: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def build(
        cls,
        name: str,
        dimensions: Iterable[tuple[str, DataType]] = (),
        metrics: Iterable[tuple[str, DataType]] = (),
        datetimes: Iterable[tuple[str, DataType]] = (),
        multi_value_dimensions: Iterable[tuple[str, DataType]] = (),
        primary_key_columns: Iterable[str] = (),
    ) -> "Schema":
        fields: dict[str, FieldSpec] = {}
        for n, t in dimensions:
            fields[n] = FieldSpec(n, t, FieldRole.DIMENSION)
        for n, t in multi_value_dimensions:
            fields[n] = FieldSpec(n, t, FieldRole.DIMENSION, single_value=False)
        for n, t in metrics:
            fields[n] = FieldSpec(n, t, FieldRole.METRIC)
        for n, t in datetimes:
            fields[n] = FieldSpec(n, t, FieldRole.DATE_TIME)
        return cls(name=name, fields=fields, primary_key_columns=list(primary_key_columns))

    # ---- accessors ------------------------------------------------------
    def field(self, name: str) -> FieldSpec:
        try:
            return self.fields[name]
        except KeyError:
            raise KeyError(f"column {name!r} not in schema {self.name!r}") from None

    def column_names(self) -> list[str]:
        return list(self.fields)

    @property
    def dimension_names(self) -> list[str]:
        return [f.name for f in self.fields.values() if f.role is FieldRole.DIMENSION]

    @property
    def metric_names(self) -> list[str]:
        return [f.name for f in self.fields.values() if f.role is FieldRole.METRIC]

    @property
    def datetime_names(self) -> list[str]:
        return [f.name for f in self.fields.values() if f.role is FieldRole.DATE_TIME]

    # ---- JSON (reference-compatible shape) ------------------------------
    def to_json(self) -> dict:
        return {
            "schemaName": self.name,
            "dimensionFieldSpecs": [
                f.to_json() for f in self.fields.values() if f.role is FieldRole.DIMENSION
            ],
            "metricFieldSpecs": [
                f.to_json() for f in self.fields.values() if f.role is FieldRole.METRIC
            ],
            "dateTimeFieldSpecs": [
                f.to_json() for f in self.fields.values() if f.role is FieldRole.DATE_TIME
            ],
            "primaryKeyColumns": self.primary_key_columns,
        }

    @classmethod
    def from_json(cls, obj: dict | str) -> "Schema":
        if isinstance(obj, str):
            obj = json.loads(obj)
        fields: dict[str, FieldSpec] = {}
        for key, role in (
            ("dimensionFieldSpecs", FieldRole.DIMENSION),
            ("metricFieldSpecs", FieldRole.METRIC),
            ("dateTimeFieldSpecs", FieldRole.DATE_TIME),
        ):
            for fs in obj.get(key) or []:
                fields[fs["name"]] = FieldSpec(
                    name=fs["name"],
                    data_type=DataType(fs["dataType"]),
                    role=role,
                    single_value=fs.get("singleValueField", True),
                    default_null=fs.get("defaultNullValue"),
                    format=fs.get("format"),
                    granularity=fs.get("granularity"),
                )
        return cls(
            name=obj.get("schemaName", "schema"),
            fields=fields,
            primary_key_columns=list(obj.get("primaryKeyColumns") or []),
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    @classmethod
    def load(cls, path) -> "Schema":
        with open(path) as f:
            return cls.from_json(json.load(f))
