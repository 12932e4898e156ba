"""Batch ingestion job: spec -> read -> build segments -> push.

Equivalent of the reference's standalone ingestion job
(pinot-spi/.../ingestion/batch/IngestionJobLauncher.java +
SegmentGenerationJobSpec + pinot-batch-ingestion-standalone's
SegmentGenerationJobRunner/SegmentTarPushJobRunner), collapsed to one
runner: each matched input file becomes one segment (the reference's
sequence-id naming), built with the vectorized creator and pushed to the
controller, which assigns replicas and records cluster metadata.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

from pinot_tpu_torch.ingestion.readers import create_record_reader, resolve_input_files
from pinot_tpu_torch.storage.creator import build_segment


@dataclasses.dataclass
class IngestionJobSpec:
    """The honored subset of SegmentGenerationJobSpec's YAML surface."""

    table_name: str                 # raw or physical name; controller resolves
    input_dir: str
    include_pattern: str = "*.csv"
    format: str = "csv"             # record reader plugin key
    reader_props: dict = dataclasses.field(default_factory=dict)
    output_dir: Optional[str] = None  # staging dir (default: alongside input)
    segment_name_prefix: Optional[str] = None  # default: table name
    push: bool = True               # False: build segments, don't push
    # >1: per-file segment builds fan out to spawned worker processes —
    # the standalone analog of the hadoop/spark batch runners' distribution
    parallelism: int = 1

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict | str) -> "IngestionJobSpec":
        if isinstance(obj, str):
            obj = json.loads(obj)
        return cls(**obj)

    @classmethod
    def load(cls, path: str) -> "IngestionJobSpec":
        with open(path) as f:
            return cls.from_json(json.load(f))


def _build_segment_file(schema, table_cfg, reader, transformer,
                        reader_props, path, name, out_root) -> str:
    """One input file → one built segment dir (shared by the in-process
    loop and the spawned workers)."""
    from pinot_tpu_torch.ingestion.readers import rows_to_columns

    if transformer.active:
        try:
            rows = reader.read_rows(path)
        except NotImplementedError:
            # column-only RecordReader plugins (the SPI's minimum
            # surface): reconstruct rows from the schema columns —
            # transforms then can't see source-only fields, which such
            # a reader could never expose anyway
            raw_cols = reader.read_columns(path, schema)
            names = list(raw_cols)
            rows = [dict(zip(names, vals))
                    for vals in zip(*raw_cols.values())] if names else []
        rows = transformer.apply_rows(rows)
        columns = rows_to_columns(
            rows, schema, mv_delimiter=reader_props.get("mv_delimiter", ";"))
    else:
        columns = reader.read_columns(path, schema)
    seg_dir = os.path.join(out_root, name)
    build_segment(schema, columns, seg_dir, table_cfg, name)
    return seg_dir


def _build_one_spawned(args) -> str:
    """Spawn-context worker: reconstruct job state from picklable pieces.
    The reader travels as its CLASS (pickled by reference), not a registry
    key — a custom reader registered only in the parent would not exist in
    the worker's freshly imported registry."""
    (schema_json, cfg_json, reader_cls, reader_props, path, name,
     out_root) = args
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.ingestion.transform import RecordTransformer

    schema = Schema.from_json(schema_json)
    table_cfg = TableConfig.from_json(cfg_json)
    reader = reader_cls(**reader_props)
    transformer = RecordTransformer(table_cfg)
    return _build_segment_file(schema, table_cfg, reader, transformer,
                               reader_props, path, name, out_root)


def run_ingestion_job(spec: IngestionJobSpec, controller) -> list:
    """Execute the job against a live controller; returns the built segment
    directories (and pushes each unless ``spec.push`` is False).

    ``spec.parallelism > 1`` runs the per-file builds in SPAWNED worker
    processes — the standalone analog of the reference's hadoop/spark
    batch runners (pinot-batch-ingestion-hadoop/-spark distribute exactly
    this per-input-file segment build; here the fan-out is a process pool
    on one host). Pushes stay in the parent, sequential through the
    uploader SPI, exactly like the runners' collect-and-push step."""
    table = controller.resolve(spec.table_name)
    schema = controller.registry.table_schema(table)
    table_cfg = controller.registry.table_config(table)
    if schema is None or table_cfg is None:
        raise KeyError(f"table {spec.table_name!r} not registered")
    files = resolve_input_files(spec.input_dir, spec.include_pattern)
    if not files:
        raise FileNotFoundError(
            f"no input files match {spec.include_pattern!r} in {spec.input_dir}"
        )
    reader = create_record_reader(spec.format, **spec.reader_props)
    out_root = spec.output_dir or os.path.join(spec.input_dir, "_segments")
    prefix = spec.segment_name_prefix or table_cfg.table_name
    names = [f"{prefix}_{seq}" for seq in range(len(files))]
    if spec.parallelism > 1 and len(files) > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        work = [
            (schema.to_json(), table_cfg.to_json(), type(reader),
             spec.reader_props, path, name, out_root)
            for path, name in zip(files, names)
        ]
        # spawn, not fork: the parent may hold a live JAX/TPU runtime that
        # must not be duplicated into build workers
        with ProcessPoolExecutor(
                max_workers=min(spec.parallelism, len(work)),
                mp_context=mp.get_context("spawn")) as pool:
            built = list(pool.map(_build_one_spawned, work))
    else:
        from pinot_tpu_torch.ingestion.transform import RecordTransformer

        transformer = RecordTransformer(table_cfg)
        built = [
            _build_segment_file(schema, table_cfg, reader, transformer,
                                spec.reader_props, path, name, out_root)
            for path, name in zip(files, names)
        ]
    if spec.push:
        # uploader SPI (segment-uploader-default role): retried with
        # backoff, pluggable via reader_props
        from pinot_tpu_torch.ingestion.uploader import create_uploader

        uploader = create_uploader(
            spec.reader_props.get("segment.uploader", "default"), controller)
        for seg_dir in built:
            uploader.upload(table, seg_dir)
    return built
