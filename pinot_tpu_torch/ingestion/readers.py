"""Batch record readers: input files -> schema-coerced column arrays.

Equivalent of the reference's RecordReader SPI + input-format plugins
(pinot-spi/.../data/readers/RecordReader.java,
pinot-plugins/pinot-input-format/pinot-csv/.../CSVRecordReader.java,
pinot-json/.../JSONRecordReader.java), re-shaped column-first: instead of a
row iterator feeding a row-by-row segment creator, a reader returns whole
columns (the creator is vectorized numpy — storage/creator.py fuses stats +
write in column space, so materializing columns is the natural unit).

Formats are a plugin registry keyed by name; AVRO/Parquet register lazily
and raise a clear error when their optional deps are absent.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Optional

from pinot_tpu_torch.common.schema import Schema


class RecordReader:
    """SPI: subclass and register. ``read_columns`` returns
    {column: list} with values coerced to the schema's types; multi-value
    columns yield a list per row."""

    def __init__(self, **props):
        self.props = props

    def read_rows(self, path: str) -> list:
        """Format-specific: file -> list of {column: raw value} dicts."""
        raise NotImplementedError

    def read_columns(self, path: str, schema: Schema) -> dict:
        return rows_to_columns(self.read_rows(path), schema,
                               mv_delimiter=self.props.get("mv_delimiter", ";"))


def rows_to_columns(rows: list, schema: Schema, mv_delimiter: str = ";") -> dict:
    """Row dicts -> coerced columns. Missing/empty/JSON-null values stay
    ``None`` — the segment creator substitutes the field's default null AND
    records the doc in the column's null vector (CSVRecordReader treats
    empty cells as null the same way). MV cells accept lists or
    delimiter-joined strings (CSV multiValueDelimiter); an explicitly null
    MV ROW is null, an empty string is an empty row."""
    out: dict = {}
    for name in schema.column_names():
        spec = schema.field(name)
        dt = spec.data_type
        col = []
        for row in rows:
            v = row.get(name)
            if spec.single_value:
                col.append(None if v is None or v == "" else dt.convert(v))
            else:
                if v is None:
                    col.append(None)
                    continue
                if v == "":
                    vals = []
                elif isinstance(v, str):
                    vals = v.split(mv_delimiter)
                elif isinstance(v, (list, tuple)):
                    vals = list(v)
                else:
                    vals = [v]
                col.append([dt.convert(x) for x in vals])
        out[name] = col
    return out


class CSVRecordReader(RecordReader):
    """Header-row CSV (CSVRecordReader.java analog). Props: ``delimiter``
    (default ','), ``mv_delimiter`` (default ';')."""

    def read_rows(self, path: str) -> list:
        with open(path, newline="") as f:
            return list(csv.DictReader(f, delimiter=self.props.get("delimiter", ",")))


class JSONRecordReader(RecordReader):
    """JSON lines, or a single top-level JSON array of objects."""

    def read_rows(self, path: str) -> list:
        with open(path) as f:
            text = f.read()
        stripped = text.lstrip()
        if stripped.startswith("["):
            return json.loads(stripped)
        return [json.loads(line) for line in text.splitlines() if line.strip()]


class ParquetRecordReader(RecordReader):
    """Columnar Parquet via pyarrow (pinot-parquet analog); gated on the
    optional pyarrow dependency."""

    def read_rows(self, path: str) -> list:
        try:
            import pyarrow.parquet as pq
        except ImportError as e:
            raise RuntimeError(
                "parquet input requires pyarrow; convert to CSV/JSON or "
                "install pyarrow") from e
        return pq.read_table(path).to_pylist()


class ORCRecordReader(RecordReader):
    """ORC via pyarrow (pinot-orc analog); gated like Parquet."""

    def read_rows(self, path: str) -> list:
        try:
            import pyarrow.orc as orc
        except ImportError as e:
            raise RuntimeError(
                "orc input requires pyarrow; convert to CSV/JSON or "
                "install pyarrow") from e
        return orc.ORCFile(path).read().to_pylist()


class AvroRecordReader(RecordReader):
    """Avro Object Container Files (pinot-avro AvroRecordReader analog) —
    decoded by the in-tree pure-python codec (ingestion/avro_io.py), so no
    external avro dependency gates the canonical Pinot ingestion format."""

    def read_rows(self, path: str) -> list:
        from pinot_tpu_torch.ingestion.avro_io import read_container

        return read_container(path)


class ProtobufRecordReader(RecordReader):
    """Length-delimited protobuf files (pinot-protobuf analog), gated on
    the google.protobuf runtime. Props: ``descriptor_file`` (compiled
    FileDescriptorSet from protoc --descriptor_set_out) and
    ``message_name``."""

    def read_rows(self, path: str) -> list:
        from pinot_tpu_torch.ingestion.protobuf_io import read_delimited

        desc = self.props.get("descriptor_file", "")
        msg = self.props.get("message_name", "")
        if not desc or not msg:
            raise ValueError(
                "protobuf input needs descriptor_file + message_name props")
        return read_delimited(path, desc, msg)


_READERS = {
    "csv": CSVRecordReader,
    "json": JSONRecordReader,
    "parquet": ParquetRecordReader,
    "orc": ORCRecordReader,
    "avro": AvroRecordReader,
    "protobuf": ProtobufRecordReader,
}


def register_record_reader(fmt: str, cls) -> None:
    _READERS[fmt.lower()] = cls


def create_record_reader(fmt: str, **props) -> RecordReader:
    try:
        return _READERS[fmt.lower()](**props)
    except KeyError:
        raise ValueError(
            f"unknown input format {fmt!r}; registered: {sorted(_READERS)}"
        ) from None


def resolve_input_files(input_dir: str, include_pattern: str) -> list:
    """Expand the job's input glob, sorted for deterministic segment names
    (SegmentGenerationJobUtils#listMatchedFilesWithRecursiveOption)."""
    files = sorted(glob.glob(os.path.join(input_dir, include_pattern),
                             recursive=True))
    return [f for f in files if os.path.isfile(f)]
