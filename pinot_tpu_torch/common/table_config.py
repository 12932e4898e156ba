"""Table configuration.

Equivalent surface to the reference's ``TableConfig`` + ``IndexingConfig`` +
``RoutingConfig`` + ``SegmentPartitionConfig`` + ``UpsertConfig``
(pinot-spi/.../config/table/*.java), trimmed to the knobs this engine
actually honors. JSON shape loosely follows the reference so configs are
recognizable.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


class TableType:
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclasses.dataclass
class StarTreeIndexConfig:
    """Mirrors StarTreeIndexConfig.java: split order + function-column pairs."""

    dimensions_split_order: list[str]
    function_column_pairs: list[str]  # e.g. ["SUM__revenue", "COUNT__*"]
    max_leaf_records: int = 10_000
    skip_star_node_creation: list[str] = dataclasses.field(default_factory=list)
    # PERCENTILETDIGEST__col pairs: digest compression the cube is built
    # with (queries at a different compression fall back to the scan path)
    tdigest_compression: float = 100.0


@dataclasses.dataclass
class IndexingConfig:
    inverted_index_columns: list[str] = dataclasses.field(default_factory=list)
    range_index_columns: list[str] = dataclasses.field(default_factory=list)
    bloom_filter_columns: list[str] = dataclasses.field(default_factory=list)
    json_index_columns: list[str] = dataclasses.field(default_factory=list)
    text_index_columns: list[str] = dataclasses.field(default_factory=list)
    # FST-index analog: trigram posting index accelerating LIKE/REGEXP_LIKE
    # on dictionary columns (storage/fstindex.py)
    fst_index_columns: list[str] = dataclasses.field(default_factory=list)
    # H3-index analog: grid-cell postings accelerating
    # ST_DISTANCE(col, point) < r on WKT POINT columns (storage/geoindex.py)
    h3_index_columns: list[str] = dataclasses.field(default_factory=list)
    sorted_column: Optional[str] = None
    no_dictionary_columns: list[str] = dataclasses.field(default_factory=list)
    star_tree_configs: list[StarTreeIndexConfig] = dataclasses.field(default_factory=list)
    # bit-pack dict-encoded SV forward indexes (FixedBitSVForwardIndex
    # analog, native codec in pinot_tpu/native): 4-32x smaller on disk,
    # decoded to int32 at load time instead of mmap'd
    enable_bit_packing: bool = False
    # chunk-compress RAW (no-dictionary) SV forward indexes with zlib
    # (io/compression analog: per-chunk LZ4/Snappy/zstd in the reference);
    # decoded by the native codec at load time
    compressed_columns: list[str] = dataclasses.field(default_factory=list)
    # per-column chunk codec override (reference ChunkCompressionType):
    # {"col": "zlib" | "zstd" | "lz4"}; listing a column here implies
    # compression even if it is absent from compressed_columns
    compression_codec: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SegmentPartitionConfig:
    """column -> (function_name, num_partitions); see
    pinot-segment-spi/.../partition/."""

    column_partition_map: dict[str, tuple[str, int]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TransformConfig:
    """One ingest-time derived column (ingestion TransformConfig analog):
    ``transform_function`` is a SQL expression over source record fields
    (which need not be schema columns), evaluated by the engine's own
    function registry instead of Groovy."""

    column_name: str
    transform_function: str


@dataclasses.dataclass
class IngestionConfig:
    """Ingestion-time record shaping (spi config/table/ingestion analog):
    transforms run first, then rows where ``filter_function`` evaluates
    true are DROPPED (FilterConfig semantics)."""

    transform_configs: list[TransformConfig] = dataclasses.field(
        default_factory=list)
    filter_function: Optional[str] = None


@dataclasses.dataclass
class QuotaConfig:
    """Per-table query quota (spi/config/table/QuotaConfig analog):
    max queries per second enforced broker-side."""

    max_queries_per_second: Optional[float] = None


@dataclasses.dataclass
class UpsertConfig:
    mode: str = "NONE"  # NONE | FULL | PARTIAL
    comparison_column: Optional[str] = None
    partial_upsert_strategies: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StreamConfig:
    """Realtime stream settings (pinot-spi/.../stream/StreamConfig.java)."""

    stream_type: str = "memory"  # plugin key: memory | file | kafka
    topic: str = ""
    decoder: str = "json"
    segment_flush_threshold_rows: int = 100_000
    segment_flush_threshold_seconds: int = 3600
    properties: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ChunkletConfig:
    """Consuming-segment chunklet promotion (realtime/chunklet.py): the
    frozen prefix of a consuming segment is sealed into immutable
    device-eligible blocks while only the unfrozen row tail stays on the
    host scan path.

    ``device_min_rows`` is the freshness/latency crossover knob: below it
    the whole consuming segment runs on the host (promotion overhead would
    dominate); above it, sealed chunklets query at device speed and only
    the tail pays host-scan latency. Lower it for query latency on large
    consuming segments, raise it (or disable) for pure-ingest tables."""

    enabled: bool = True
    rows_per_chunklet: int = 65_536
    # frozen rows required before chunklets route to the device path
    device_min_rows: int = 262_144


@dataclasses.dataclass
class TableConfig:
    table_name: str  # raw name, no type suffix
    table_type: str = TableType.OFFLINE
    schema_name: Optional[str] = None
    replication: int = 1
    # dimension table (isDimTable analog): small lookup table replicated to
    # every server so LOOKUP() resolves locally during fact-table execution
    is_dim_table: bool = False
    time_column: Optional[str] = None
    retention_days: Optional[int] = None
    indexing: IndexingConfig = dataclasses.field(default_factory=IndexingConfig)
    partition: SegmentPartitionConfig = dataclasses.field(default_factory=SegmentPartitionConfig)
    upsert: UpsertConfig = dataclasses.field(default_factory=UpsertConfig)
    quota: QuotaConfig = dataclasses.field(default_factory=QuotaConfig)
    ingestion: IngestionConfig = dataclasses.field(
        default_factory=IngestionConfig)
    stream: Optional[StreamConfig] = None
    chunklets: ChunkletConfig = dataclasses.field(
        default_factory=ChunkletConfig)
    # Minion task configs keyed by task type (TableTaskConfig analog), e.g.
    # {"MergeRollupTask": {"max_docs_per_segment": 1_000_000}}
    task_configs: dict = dataclasses.field(default_factory=dict)
    # Tier storage (TierConfig analog): ordered oldest-tier-last; segments
    # whose end-time age exceeds segment_age_ms relocate to servers carrying
    # server_tag, e.g. [{"name": "cold", "segment_age_ms": 86400000,
    # "server_tag": "cold_tier"}]
    tiers: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        # TableConfigUtils analog: star-trees pre-aggregate over all rows at
        # seal time, which an upsert validDocIds mask would silently falsify.
        if self.upsert.mode != "NONE" and self.indexing.star_tree_configs:
            raise ValueError(
                "star_tree_configs are not supported on upsert tables "
                "(pre-aggregated partials ignore validDocIds)"
            )
        mqps = self.quota.max_queries_per_second
        if mqps is not None and mqps <= 0:
            raise ValueError(
                "quota.max_queries_per_second must be positive "
                "(omit it for unlimited)")

    @property
    def table_name_with_type(self) -> str:
        return f"{self.table_name}_{self.table_type}"

    # ---- JSON ----------------------------------------------------------
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        return d

    @classmethod
    def from_json(cls, obj: dict | str) -> "TableConfig":
        if isinstance(obj, str):
            obj = json.loads(obj)
        obj = dict(obj)
        if "indexing" in obj and isinstance(obj["indexing"], dict):
            idx = dict(obj["indexing"])
            idx["star_tree_configs"] = [
                StarTreeIndexConfig(**c) for c in idx.get("star_tree_configs", [])
            ]
            obj["indexing"] = IndexingConfig(**idx)
        if "partition" in obj and isinstance(obj["partition"], dict):
            p = dict(obj["partition"])
            p["column_partition_map"] = {
                k: tuple(v) for k, v in p.get("column_partition_map", {}).items()
            }
            obj["partition"] = SegmentPartitionConfig(**p)
        if "upsert" in obj and isinstance(obj["upsert"], dict):
            obj["upsert"] = UpsertConfig(**obj["upsert"])
        if "quota" in obj and isinstance(obj["quota"], dict):
            obj["quota"] = QuotaConfig(**obj["quota"])
        if "ingestion" in obj and isinstance(obj["ingestion"], dict):
            ing = dict(obj["ingestion"])
            ing["transform_configs"] = [
                TransformConfig(**t) for t in ing.get("transform_configs", [])
            ]
            obj["ingestion"] = IngestionConfig(**ing)
        if obj.get("stream") is not None and isinstance(obj["stream"], dict):
            obj["stream"] = StreamConfig(**obj["stream"])
        if "chunklets" in obj and isinstance(obj["chunklets"], dict):
            obj["chunklets"] = ChunkletConfig(**obj["chunklets"])
        return cls(**obj)
