#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # the full run: 8 x 12.5M rows
    python3 chip_smoke.py --rows 400000 --event-rows 100000 \
        --rt-rows 300000 --rt-more 50000 --up-rows 100000  # a rehearsal

Phases, all on ``cuda:0``:

1. the card's name and power limit; the kernels built from
   ``pinot_tpu_torch/csrc/`` (one ``nvcc`` per source, started together),
   with each kernel's registers, shared memory and spills from
   ``-Xptxas -v``.
2. The SSB lineorder table is generated from seed 7 with bench.py's
   columns and distributions; it, with bench.py's two star-tree cubes
   (d_year x c_region x s_nation: SUM(lo_revenue), COUNT(*); lo_suppkey:
   COUNT(*), SUM(lo_quantity), DISTINCTCOUNTHLL(lo_custkey)), and a copy
   stably sorted by ``lo_orderdate`` without cubes
   (``lineorder_by_date``: Pinot's sorted-column layout for
   time-ordered ingestion) are written by the port's creator in worker
   processes (the cube build timed apart), while the GPU holds each
   kernel against its plain
   PyTorch version at the main paths' shapes: K1 group plane sums from
   the stored planes at q1's, q5's, q4_no_hll's, a wide float and the
   sorted HLL build's shapes through both entries (integer planes
   bit-exact, float planes within rtol 1e-6), K2 group min/max at q6's
   shape (an i32 and a FOR-offset u8 source, min and max each, in one
   launch; then f32 with signed zeros; bit-exact), K3 HLL register max
   from the hash plane at 1024, 35,840 and 2^20 slots (bit-exact) and K4
   fused filter + gather + aggregate at the full candidate bound
   (bit-exact), and K1 through ops/radix_groupby.py's
   ``bucket_histogram`` over 100M packed keys (bit-exact against
   ``torch.bincount``). CUDA-event times of the kernel, of the torch ops
   it absorbed (K1's channel build, K2's widening, K3's hash split), of
   its plain version and of one library call computing the same function
   (``index_add_`` / ``scatter_reduce_`` / ``bincount``; for K4, which no
   single call computes, the port's generic gathered form), beside the
   memory bound.
3. The seven tables are loaded into one ``QueryEngine(device="cuda")``
   (the third, ``lineorder_pairs``, is two of the unsorted segments with
   a d_year x c_region cube of t-digest, bitmap and decimal pairs, and
   the write pool also builds the overflow oracle's per-segment
   partials; the fourth and fifth are the mv and index paths' tables,
   below); K4 is
   held against its plain version once more at the block-skip path's
   own candidates, K1 and K2 at the selection path's own inputs
   (gb_expr's and gb_segment's factorized group-id planes and value
   planes, captured at the kernels' entries); K5, the port-only ordered
   cluster sum of the t-digest build, at pct_scalar's, pct_raw_month's
   and pct_tdigest_supp's sorted values and cluster offsets (long
   clusters and 816,000 short ones), captured at its entry, bit for bit
   against its plain version (the CPU's sequential cumsum), every
   cluster in the exact integer regime (``kernels.cluster_regimes``
   against ``cluster_regimes_plain``), beside ``torch.segment_reduce``
   (a parallel sum: the same sums where every cluster is exact), the
   bytes bound and the chain bound (the longest chained cluster times
   one DADD, ``kernels.dadd_chain_ns``); again at pct_scalar's values +
   0.5 (the chain regime alone) and at ``k5_adversarial``'s inputs
   (fractions, sums of |v| about 2^52 and 2^53, values past 2^53, one
   fraction in an integral cluster, +-inf, -0.0; each case's regime
   counts asserted), with each digest query's cluster sizes equal to
   ``compress``'s own loop (run in the write pool) on every (segment,
   group) run; K1 at sumprec_year's and sumprec_cust's byte planes and
   K3 at rawhll_year's hash plane, captured the same way, and K1 at
   hc_overflow's kept groups in the host path's shape and at
   st_sumprec_region's byte planes over cube rows. Nine paths run: the six SSB scan/filter/group-by
   queries, the five HLL and DISTINCTCOUNT queries, the six block-skip
   queries on the sorted table, the star-tree path (bench.py's
   q4_highcard_hll and q5_startree on the cubes, a filtered cube
   group-by, and the metadata-only COUNT/MIN/MAX), and the selection
   path (selection with and without ORDER BY, ties under OFFSET, CASE
   and ``$docId`` / ``$segmentName``; DISTINCT over dict and raw
   columns; group keys over an expression, a raw column and
   ``$segmentName``; DISTINCTCOUNT over a raw column; FIRST/LASTWITHTIME
   with massive time ties), its stats the reference's host path's where
   that path answers (index-served predicates scan nothing, entries
   after the filter per kept row), and the sketch path (PERCENTILE,
   PERCENTILETDIGEST by d_year and by lo_suppkey (2,000 groups) and
   PERCENTILERAWTDIGEST over a month; DISTINCTCOUNTTHETASKETCH by
   c_region and its set form; SUMPRECISION by d_year and by lo_custkey
   (100,000 groups); MODE; DISTINCTCOUNTRAWHLL; DISTINCTCOUNTSMARTHLL
   under and past its threshold), in the reference host path's shape
   with its stats, and the highcard path (``HC_QUERIES``: the
   lo_suppkey x lo_orderdate group-by past 2^22 keys in the sorted
   regime, trimmed, untrimmed and under a key-order numGroupsLimit; the
   lo_custkey x lo_suppkey group-by past the table's cap, run again in
   the host path's shape; the star-tree's digest, bitmap and decimal
   pairs on ``lineorder_pairs``, with cube rows scanned), the mv path
   (``MV_QUERIES`` over ``lineorder_mv``: two of the unsorted segments'
   rows with two MV columns after airlineStats' MV dimensions,
   ``lo_tags``, a dict STRING column of 0-8 entries a row drawn Zipf-like
   from 1,000 tags, and ``lo_codes``, a raw INT column of 1-24 entries a
   row; an ``mv_any`` filter in the reference device's shape under K1
   and K2; group-bys on ``lo_tags`` alone and with d_year, one row per
   entry; COUNTMV / SUMMV / AVGMV / MINMV / MAXMV over lo_codes' entries
   (K1, K2); DISTINCTCOUNTMV and DISTINCTCOUNTHLLMV (K3);
   PERCENTILETDIGESTMV (K5); a selection of each row's tags under a raw
   MV filter) and the index path (``IDX_QUERIES`` over ``events``, four
   segments shaped after the githubEvents quickstart: JSON_MATCH on a
   nested key and on an array wildcard, TEXT_MATCH on a term and a
   phrase, ST_DISTANCE within 200 km, REGEXP_LIKE on the FST-indexed
   repository name; each as a COUNT and as a group-by SUM (K1), and each
   again over the column's unindexed twin) and the values path
   (``VAL_QUERIES``: ``lineorder_v2``, the 8 lineorder segments loaded
   again behind a schema that adds SSB's LO_SHIPMODE, LO_TAX and an order
   timestamp, plus a new segment s8 with them, 5 % null: group-bys over
   the evolved key and metric (K1, K2), EQ on the defaults, IS NULL and
   IS NOT NULL, TIMECONVERT and DATETIMECONVERT to a date string over the
   raw timestamp, CAST to STRING over lineorder's raw lo_quantity; and
   over ``lineorder_mv`` ARRAYLENGTH, the per-doc ARRAYSUM / MIN / MAX /
   AVERAGE of lo_codes (K1, K2), VALUEIN's lists and an ARRAYLENGTH
   filter; K1 and K2 held at its captured inputs,
   ``check_values_kernels``) and the tail path (``TAIL_QUERIES`` over
   ``trips``: two segments of ``--rows`` rows after the NYC TLC
   yellow-taxi trip record's columns, sorted by pickup time, the raw
   columns compressed (the time and the fare zlib, the tip zstd where the
   build has it, the pickup coordinates lz4, the distance not): exact
   SUMPRECISION over the fares and over fare + tip (K1, K2), GEOTOH3
   cells (K1), ST_CONTAINS in a Manhattan polygon, STUNION over a
   20-second window, ROUNDDECIMAL and a CASE of string and numeric
   results as keys, LIKE over a number, DISTINCTCOUNTHLL over
   ``pickup_ts / 60000`` (K3), LASTWITHTIME over 'yyyyMMdd' STRING
   times, a group-by over the decoded columns (K1, K2), a one-hour time
   range by block skip on the compressed sorted time and a day's fused
   filter (K4); ``trips`` loaded twice more, wide and under
   ``PINOT_TPU_SUBBYTE=1``, where ``SUBBYTE_TWINS`` answer the same and
   the sub-byte load holds fewer bytes; K1, K2, K3 and K4 held at its
   captured inputs, ``check_tail_kernels``). Every answer is
   checked against a numpy oracle over the generated columns (HLL
   estimates from registers the oracle builds itself; for the block-skip
   path also the pruned segments, pruned blocks and entries scanned,
   from per-segment and per-block min/max, and the ``SET useBlockSkip =
   false`` twin's answer; for the star-tree path numDocsScanned equal to
   the cube rows read, the float32 rounding of the DOUBLE cube sums
   modelled, and no entry scanned by the metadata-only answer; for the
   sketch path the percentiles within rank 1.5/delta of the exact order
   statistic, PERCENTILERAWTDIGEST's string equal to a numpy fold of
   per-segment ``add_values`` digests, the theta sketches equal to the
   oracle's own per-segment sketches merged, exact integer sums, MODE
   from counts, raw HLL and past-threshold SMARTHLL from the oracle's
   registers, exact SMARTHLL sets; for the mv path the flat entries and
   offsets the generator drew, the reference device's stats for the
   ``mv_any`` filters and its host path's for the rest; for the index
   path the generator's structured fields behind each JSON string, the
   message's words, haversine in numpy, ``re`` over the repository names,
   with the index's stats: nothing scanned by the JSON and text indexes,
   the grid's candidate docs by the geo index, every row by a twin; for
   the values path the old segments' defaults, the null vectors the
   writer drew, Long.MIN's 106751991168 DAYS and '-292275055-05-17', and
   the per-doc reductions and VALUEIN lists from the MV offsets; for
   the tail path Python's decimal sums over the oracle's counts per
   distinct value, the grid formula, the even-odd ray cast and the
   murmur finalizer in numpy, and each range's block stats from
   per-block min/max), and the per-query p50 of 5 runs printed; q6 must make one
   K2 launch an execution, and no torch op may read its stored min/max
   planes (seen at the dispatcher); gb_expr and gb_segment one K1 and
   one K2 launch an execution, distinct_dict one K1 launch, each digest
   query one K5 launch, each SUMPRECISION query one K1 launch and each
   register query of the sketch path one K3 launch, and each mv and
   index query the launches ``QUERY_LAUNCHES`` names. K1, K2, K3 and K5
   are held against their plain versions at the mv path's captured
   inputs too (``check_mv_kernels``). The launch counts, per kernel and
   per entry, are zeroed just before each path and read just after;
   every kernel and entry of the path must have launched (the cube
   launches read too few rows to pass K1's gate: the star-tree path
   requires none). Then bench.py's gate: q4_highcard_hll equals both q4
   scan forms row for row. The on-device top-K trim: q1, q4_no_hll and
   q4_scan_hll equal their ``SET useDeviceReduce = false`` twins, with
   the bytes each form fetched; ``SET numGroupsLimit = 100`` on the
   lo_suppkey group-by answers in-band: by default run again in the host
   path's shape (each segment's first 100 groups in doc order), its
   untrimmed twin the first 100 group ids, each equal to its oracle.
   Then the cost block-skip eligibility adds to the unsorted
   table's filtered queries (the zone verdict and one scalar read before
   the dense form): p50 with and without ``SET useBlockSkip = false``.
   The thirteenth path, ``realtime`` (run before ``serving``; its
   queries ``RT_QUERIES``), at Pinot's documented realtime defaults on
   one server: ``lineorder_rt`` is lineorder's 8 sealed segments (the
   same objects, so the same device batch) and one consuming segment of
   ``--rt-rows`` (5,000,000, ``realtime.segment.flush.threshold.rows``)
   rows from the generator under seed 71, sorted by lo_orderdate as a
   stream delivers them, every 997th without lo_discount (its null
   default), indexed through ``consume_stream_batches`` in 8,192-row
   fetches, one ``index_batch`` and a chunklet promotion each
   (``ChunkletConfig``'s defaults: 65,536-row chunklets, 262,144 frozen
   rows before the split applies): 76 chunklets and a 19,264-row tail,
   rows a second printed. ``lineorder_up`` is a FULL-upsert table on
   ``lo_orderkey`` (1,000,000 keys drawn with repeats), comparison column
   lo_orderdate, behind the port's ``RealtimeTableDataManager``: two
   committed segments of ``--up-rows`` rows named in its checkpoint
   (written in the pool; the restart path replays their keys and
   publishes them, masks and all), then the consuming segment fed as JSON
   from the in-memory stream, a row at a time through the primary-key
   CAS. K1-K4 are held against their plain versions at the path's
   captured inputs (``check_realtime_kernels``: the sealed batch, the
   chunklet batch and the masked segments in the host path's shape).
   The path's queries (q1, q2, a month in K4's fused form, q4's HLL forms,
   q6, COUNT(*), IS NULL, a selection ORDER BY; q1's and q6's shapes and
   COUNT(*) on lineorder_up) must equal a numpy oracle over all the rows
   (latest-wins for the upsert table), stats included. Then each query's
   launches by part (sealed batch, chunklet batch, tail, masked sealed,
   dirty chunklet, a consuming segment run whole) with a traced run's
   device time and busy share; the tail alone in the host path's shape;
   ``--rt-more`` (500,000) more rows indexed by a writer thread while q1
   and COUNT(*) / SUM run 20 times each, every answer equal to the
   oracle at one published count between the counts read before and
   after it; and an update wave of 10 % of lineorder_up's keys, after
   which its answers follow the new masks.
   The fourteenth path, ``multistage`` (after ``realtime``; its queries
   ``MS_QUERIES``), joins SSB's star schema on the card: ``customer``
   (100,000 rows), ``supplier`` (2,000) and ``dates`` (2,557, 1992-1998)
   with SSB's column names and 1-based keys at ``generate``'s key spaces
   (so lo_custkey 0 and lo_suppkey 0 miss), nation = key % 25 and region
   = nation // 5, written by the port's creator as dimension tables
   (seed 41). The reference refuses a stage-1 leaf past 4,000,000 rows,
   so each lineorder leaf is a month or a quarter. Star joins grouped by
   nation and region (stage 2's COUNT and integer SUM / AVG on K1), SSB
   Q3.1's shape over a quarter (four leaves, three BROADCAST joins), a
   LEFT JOIN with its misses, a selection, RANK and a running SUM over
   2,000 partitions, a window over a join, LOOKUP grouped over all 100M
   rows (the host path's shape, K1 and K2) and its month twin equal to
   the LEFT JOIN row for row, a join over ``lineorder_rt``'s consuming
   segment; each against a numpy oracle (dense key arrays, lexsort), its
   leaves' and joined rows with it; a year-wide leaf refused in-band;
   EXPLAIN and EXPLAIN ANALYZE of the Q3.1 shape with each leaf's actual
   rows; per query the leaf, join, window and stage-2 span ms and a
   traced run's device time and busy share. K1 is held against its
   plain version at stage 2's captured inputs and K1 and K2 at the LOOKUP
   group-by's (``check_multistage_kernels``).
   The twelfth path, ``serving``, over lineorder and lineorder_by_date
   (the eleven paths run with the device partials cache off, so their
   repeats run the kernels): four cohorts (``SERVE_COHORTS``), each
   member first alone with the coalescer off, then all released together
   through a forced 50 ms window that closes when the last member has
   joined, then 9 more timed passes of each: q1's shape with 8 lo_quantity literals
   (K1's member-axis entry), q6's and hll_scalar's over 4 lo_discount
   ranges (K1 and K2; K3), and bs_month_fused over 4 months plus one
   range past the candidate bound (K4's member-axis entry for the skip
   sub-cohort, the dense sub-cohort's torch ops for the other). Every
   member must equal its solo answer, stats included, and the oracle;
   with the launch counts zeroed before and read after, each cohort must
   launch each member-axis entry it reaches exactly once and no solo
   entry; the first release must be one cohort that every member joined
   (``cohorts_launched`` +1, ``queries_coalesced`` + M - 1), and the
   walls are the p50 of the timed passes;
   each member-axis entry is held bit for bit against its plain version
   at the cohort's captured inputs, with CUDA-event times of the entry,
   of M solo launches of the same members and of the plain version,
   beside the bound and one library call over member-offset ids.
   ``serve_partials``: q1 run 6 times a round, three rounds, the cache
   emptied before each: the first run misses, the rest hit with
   ``partialsCacheHit``, the same rows and no kernel launched.
   ``serve_deadline``: an expired Deadline raises QueryTimeout before the
   fetch waits, leaving no pin. ``serve_trace``: a traced
   ``execute_segments_async`` of q1 fetched on another thread records
   gather, dispatch, device_fetch, kernel, link and merge.
   ``serve_analyze``: EXPLAIN ANALYZE of q1 and bs_month_fused, its
   ``analyzedResponse`` equal to the plain answer, every KERNEL line
   with GB/s and the percentage of the probed peak. The memory probe
   (a 512 MiB copy, best of 5) printed beside the card, within 1.05 x
   ``HBM_BYTES_PER_S``, no record above 105 % of it. Printed and not
   gated: the synchronizing calls one launch of each serving query
   makes (``torch.cuda.set_sync_debug_mode("warn")``), and q1-shaped
   queries with distinct literals, 320 for each of 1, 2, 4 and 8 threads
   with the coalescer on and off (queries per second, p50).
   The multistage path also runs stage 2's other aggregations over a
   month's joined rows (two digests by c_nation, K5 held bit for bit at
   their captured inputs with each group's ``compress`` schedule and its
   regime counts; theta and MODE, SUMPRECISION (K1), raw HLL (K3) and
   FIRSTWITHTIME by s_region), an MV column selected through a join and
   a number against a string literal after the join. The mesh path runs
   last: a second engine over the same segment objects whose executor
   shards the segment axis over ``[cuda:0] * 4`` (and any further card,
   ``mesh_devices``), SSB q1-q6, a block-skip, a sorted-regime and two
   HLL queries, rt_q1, a BROADCAST and a SHUFFLE star join and a cohort
   of four, each held to the single device's answer from the same run;
   each shard's K1-K4 launches are counted (``count_shards``) and every
   shard must launch each; per query the p50 on the mesh and on one
   device and the combine's ms.
   The sixteenth path, ``advisor`` (before ``mesh``; every other path
   runs with the plan advisor off, so its forms and launches are its
   own), turns a fresh ``PlanAdvisor`` on over ``lineorder_by_date``
   (8 x 3,052 zone blocks, the default candidate bound 1,526) with the
   launch counts zeroed before and read after: ``ADV_QUERIES``, each
   execution with new lo_orderdate literals so the template key holds,
   a day's COUNT / SUM and three days' (K4; from the fourth execution
   ``ADVISOR(candBound=1/64`` or ``1/32``, K4 launched at that bound),
   an unselective group-by over most of the seven years (K1; from the
   fourth execution ``ADVISOR(blockSkip=dense``: no zone verdict, no
   compaction, one device read fewer at the dispatcher, and the 16th
   decision a re-probe), and a server partial's top-K group-by
   (``execute_segments``, not terminal) over ~850 present customers
   (``ADVISOR(groupTrim=2048``: the fetch 4x smaller). Every execution
   equals the numpy oracle (rows, numDocsScanned, totalDocs) and its
   ``SET useAdvisor = false`` twin (rows and every stat); K4 is held
   bit for bit at an advised execution's captured inputs; each
   template's p50 advised and as its twin. Then the fault phase on its
   own engine over the table's first 2 segments (injected only: a
   ``device.launch`` failing once is retried and answers with K1 and K2
   launched, failing twice is quarantined and refused in-band until
   ``reset_quarantine()``, a ``device.fetch`` failure is refused in-band
   with the batch evicted and the next query rebuilds it; 8 failed
   ``chunklet.promote`` calls on ``lineorder_promo``, 1,000,000 rows of
   its own through the memory stream's fetch, with answers equal to the
   oracle throughout) and two tenants on threads through a
   ``TokenBucketScheduler`` over the card's engine, every answer equal
   to the oracle, each tenant's p50.
   The seventeenth path, ``cluster`` (last), is the cluster core: a
   ``ClusterRegistry``, a ``Controller``, two ``ServerInstance``s on
   cuda:0 (one card stands in for two servers) talking real gRPC on
   localhost, each with a 24 GiB batch budget, and a ``Broker`` (stage 2
   on cuda:0) behind ``BrokerHttpServer``. The tables the run wrote are
   pushed where they lie: lineorder at replication 2, lineorder_by_date
   at 1 (its segments split over the servers), customer and supplier on
   every server. SSB q1-q6, a scalar and a grouped DISTINCTCOUNTHLL,
   bs_month_fused and the same over a week (K4 under a server: the
   broker sends only the week's segment), q1 over the sorted copy (two
   servers' partials merged), PERCENTILE (K5) and ms_nation_region's
   star join over a week (stage 2 at the broker) are posted as SQL to
   ``/query/sql``, each equal to its oracle with the broker's stats,
   then an EXPLAIN and a day's selection streamed from
   ``/query/sql/stream``; each query's p50 through the front door and
   the embedded engine's, the broker's reduce ms and the DataTable bytes
   it decoded. ``lineorder_cl``, a REALTIME table of 1,000,000 rows
   (lineorder's generator, seed 83) fed as JSON through the in-memory
   stream at a 500,000-row flush threshold, commits twice through the
   controller's completion FSM while the broker counts its rows; at
   quiescence its answers equal the oracle. Kernel launches are counted
   by role (each server, the broker) while the queries run, and K1-K5
   are held against their plain versions at the cluster's captured
   inputs. Then one server stops and q1 is answered whole from the
   replica; the peak ``max_memory_allocated`` is printed.
4. A ``{"kernels": [...]}`` line (K1-K5 and the four member-axis
   entries; K5's with the clusters each regime summed over the paths,
   none chained on the sketch, mv and multistage paths' integer columns;
   K1-K4's launches by mesh shard), the card line, and as the last line
   ``{"ok": true, "device": {...}}``.

``--paths a,b`` runs those paths alone (``ALL_PATHS``; default every
one), writing and loading only the tables they read (``PATH_TABLES``:
``--paths advisor`` writes lineorder_by_date alone; ``--paths cluster``
lineorder, lineorder_by_date and the dimensions).
Exits non-zero, printing no result line, without a CUDA card, outside a
checkout of the repository, or when any phase fails. Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing as mp
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "_smoke_data")

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
BATCH_CACHE_BYTES = 48 << 30  # cached batches' device bytes, of 80 GB
FP32_OPS_PER_S = 67e12      # H100 SXM 32-bit rate outside the tensor cores

REGIONS = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDEAST"])
NATIONS = np.array([f"nation_{i:02d}" for i in range(25)])
IN_SUPP = (11, 234, 567, 890, 1203, 1456, 1789)

QUERIES = {
    "q1_scan_agg": (
        "SET useStarTree = false; "
        "SELECT lo_suppkey, SUM(lo_revenue) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) DESC LIMIT 10"),
    "q2_range_sum": (
        "SELECT SUM(lo_revenue) FROM lineorder WHERE "
        "lo_orderdate BETWEEN 19930101 AND 19931231 "
        "AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"),
    "q3_in_range": (
        "SELECT COUNT(*), SUM(lo_revenue) FROM lineorder WHERE "
        "lo_suppkey IN (11, 234, 567, 890, 1203, 1456, 1789) "
        "AND lo_discount BETWEEN 4 AND 6"),
    # the lo_suppkey cube would answer it: the scan form keeps its K1 check
    "q4_no_hll": (
        "SET useStarTree = false; "
        "SELECT lo_suppkey, COUNT(*), AVG(lo_quantity) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10"),
    "q5_scan": (
        "SET useStarTree = false; "
        "SELECT d_year, c_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "q6_minmax": (
        "SELECT d_year, s_nation, MIN(lo_revenue), MAX(lo_revenue), "
        "MINMAXRANGE(lo_quantity), COUNT(*) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year, s_nation "
        "ORDER BY d_year, s_nation LIMIT 200"),
}

Q4_HLL = ("SELECT lo_suppkey, COUNT(*), AVG(lo_quantity), "
          "DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
          "GROUP BY lo_suppkey ORDER BY COUNT(*) DESC, lo_suppkey LIMIT 10")
HLL_QUERIES = {
    # bench.py's q4 scan forms: the cached sorted projection, then a
    # per-query sort (chunked dedup) with the projection turned off
    "q4_scan_hll": "SET useStarTree = false; " + Q4_HLL,
    "q4_scan_hll_cold": ("SET useStarTree = false; "
                         "SET useSortedProjection = false; " + Q4_HLL),
    "hll_scalar": (
        "SELECT COUNT(*), DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3"),
    "hll_small_group": (
        "SELECT d_year, c_region, DISTINCTCOUNTHLL(lo_custkey) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "distinct_count": (
        "SELECT d_year, DISTINCTCOUNT(lo_suppkey) FROM lineorder "
        "WHERE lo_quantity < 10 GROUP BY d_year ORDER BY d_year"),
}
LOG2M = 10  # DISTINCTCOUNTHLL's default register count 2^10

# the block-skip path: the same rows stably sorted by lo_orderdate
BS_TABLE = "lineorder_by_date"
BS_QUERIES = {
    "bs_month_fused": (
        "SELECT COUNT(*), SUM(lo_quantity), MIN(lo_revenue), MAX(lo_revenue) "
        f"FROM {BS_TABLE} WHERE lo_orderdate BETWEEN 19930301 AND 19930328"),
    "bs_q12_shape": (
        "SELECT COUNT(*), SUM(lo_quantity), MAX(lo_revenue) "
        f"FROM {BS_TABLE} WHERE lo_orderdate BETWEEN 19940101 AND 19940128 "
        "AND lo_discount BETWEEN 4 AND 6 AND lo_quantity BETWEEN 26 AND 35"),
    "bs_or_in_not": (
        f"SELECT COUNT(*), MIN(lo_revenue) FROM {BS_TABLE} WHERE "
        "(lo_orderdate BETWEEN 19950601 AND 19950607 "
        "OR lo_orderdate IN (19970102, 19970215)) AND NOT lo_discount = 0"),
    "bs_sum_revenue": (
        f"SELECT COUNT(*), SUM(lo_revenue) FROM {BS_TABLE} "
        "WHERE lo_orderdate BETWEEN 19930301 AND 19930328"),
    "bs_group_month": (
        f"SELECT lo_discount, COUNT(*), SUM(lo_quantity) FROM {BS_TABLE} "
        "WHERE lo_orderdate BETWEEN 19960101 AND 19960228 "
        "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"),
    "bs_year_overflow": QUERIES["q2_range_sum"].replace(
        "FROM lineorder", f"FROM {BS_TABLE}"),
}
# the same filters as interval trees for the oracle: ("range", col, lo,
# hi) inclusive, ("in", col, values), ("and" | "or", ...), ("not", x)
BS_FILTERS = {
    "bs_month_fused": ("range", "lo_orderdate", 19930301, 19930328),
    "bs_q12_shape": ("and", ("range", "lo_orderdate", 19940101, 19940128),
                     ("range", "lo_discount", 4, 6),
                     ("range", "lo_quantity", 26, 35)),
    "bs_or_in_not": ("and", ("or",
                             ("range", "lo_orderdate", 19950601, 19950607),
                             ("in", "lo_orderdate", (19970102, 19970215))),
                     ("not", ("in", "lo_discount", (0,)))),
    "bs_sum_revenue": ("range", "lo_orderdate", 19930301, 19930328),
    "bs_group_month": ("range", "lo_orderdate", 19960101, 19960228),
    "bs_year_overflow": ("and", ("range", "lo_orderdate", 19930101, 19931231),
                         ("range", "lo_discount", 1, 3),
                         ("range", "lo_quantity", -2**31, 24)),
}
# the star-tree path: bench.py's two cubes on the unsorted table and the
# metadata-only answer
ST_QUERIES = {
    "q4_highcard_hll": Q4_HLL,
    "q5_startree": (
        "SELECT d_year, c_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
        "GROUP BY d_year, c_region ORDER BY d_year, c_region LIMIT 50"),
    "st_filtered": (
        "SELECT c_region, SUM(lo_revenue), COUNT(*) FROM lineorder "
        "WHERE d_year = 1995 GROUP BY c_region ORDER BY c_region"),
    "metadata_only": (
        "SELECT COUNT(*), MIN(lo_revenue), MAX(lo_revenue) FROM lineorder"),
}
# bench.py's StarTreeIndexConfigs for lineorder (split order, pairs)
STAR_TREES = (
    (["d_year", "c_region", "s_nation"], ["SUM__lo_revenue", "COUNT__*"]),
    (["lo_suppkey"], ["COUNT__*", "SUM__lo_quantity",
                      "DISTINCTCOUNTHLL__lo_custkey"]),
)
# the selection path: rows, keys and the aggregations the reference's host
# or device runs beyond the scan (engine/rows.py), on both tables
SEL_QUERIES = {
    "sel_top_revenue": (
        "SELECT lo_custkey, lo_suppkey, lo_revenue FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25 "
        "ORDER BY lo_revenue DESC, lo_custkey LIMIT 10"),
    "sel_ties_offset": (
        "SELECT lo_orderdate, lo_discount, lo_quantity, $docId "
        "FROM lineorder WHERE d_year = 1994 "
        "ORDER BY lo_discount, lo_quantity LIMIT 20 OFFSET 1000"),
    "sel_first_rows": (
        f"SELECT $segmentName, $docId, lo_revenue FROM {BS_TABLE} "
        "WHERE lo_orderdate BETWEEN 19930301 AND 19930328 LIMIT 15"),
    "sel_case_expr": (
        "SELECT lo_suppkey, lo_quantity * lo_discount, CASE WHEN "
        "lo_quantity > 25 THEN 'bulk' ELSE 'small' END FROM lineorder "
        "WHERE c_region = 'ASIA' AND d_year = 1997 "
        "ORDER BY lo_quantity * lo_discount DESC, lo_suppkey LIMIT 10"),
    "distinct_dict": ("SELECT DISTINCT d_year, c_region FROM lineorder "
                      "ORDER BY d_year, c_region LIMIT 100"),
    "distinct_raw": ("SELECT DISTINCT lo_quantity FROM lineorder "
                     "WHERE d_year = 1995 ORDER BY lo_quantity LIMIT 100"),
    "gb_expr": (
        "SELECT MOD(lo_custkey, 1000), COUNT(*), SUM(lo_revenue), "
        "MIN(lo_revenue), MAX(lo_revenue) FROM lineorder "
        "GROUP BY MOD(lo_custkey, 1000) ORDER BY SUM(lo_revenue) DESC "
        "LIMIT 10"),
    "gb_raw_key": (
        "SELECT lo_quantity, COUNT(*), SUM(lo_revenue) FROM lineorder "
        "GROUP BY lo_quantity ORDER BY lo_quantity LIMIT 100"),
    "gb_segment": (
        "SELECT $segmentName, COUNT(*), MAX(lo_revenue) FROM lineorder "
        "GROUP BY $segmentName ORDER BY $segmentName"),
    "dc_raw": (
        "SELECT d_year, DISTINCTCOUNT(lo_revenue) FROM lineorder "
        "WHERE lo_discount = 5 GROUP BY d_year ORDER BY d_year"),
    "first_last": (
        "SELECT c_region, FIRSTWITHTIME(lo_revenue, lo_orderdate, 'INT'), "
        "LASTWITHTIME(lo_quantity, lo_orderdate, 'INT') FROM lineorder "
        "GROUP BY c_region ORDER BY c_region"),
}
# the on-device trim's twins, and the numGroupsLimit case on the
# lo_suppkey group-by (2,000 groups, 100 kept)
# the digest and sketch path (engine/sketches.py): the reference answers
# these on its host; the port on the card in that path's shape
SK_MONTH = "lo_orderdate BETWEEN 19930301 AND 19930328"
SK_QUERIES = {
    "pct_scalar": "SELECT PERCENTILE(lo_revenue, 50) FROM lineorder",
    "pct_tdigest_year": (
        "SELECT d_year, PERCENTILETDIGEST(lo_revenue, 90) FROM lineorder "
        "GROUP BY d_year ORDER BY d_year"),
    "pct_raw_month": ("SELECT PERCENTILERAWTDIGEST(lo_revenue, 50) FROM "
                      f"lineorder WHERE {SK_MONTH}"),
    "theta_region": (
        "SELECT c_region, DISTINCTCOUNTTHETASKETCH(lo_custkey) FROM "
        "lineorder GROUP BY c_region ORDER BY c_region"),
    "theta_set": (
        "SELECT DISTINCTCOUNTTHETASKETCH(lo_custkey, 'nominalEntries=16384', "
        "'d_year = 1994', 'c_region = ''ASIA''', 'SET_INTERSECT($1, $2)') "
        "FROM lineorder"),
    "sumprec_year": (
        "SELECT d_year, SUMPRECISION(lo_revenue) FROM lineorder "
        "GROUP BY d_year ORDER BY d_year"),
    "mode_region": (
        "SELECT c_region, MODE(lo_discount) FROM lineorder "
        "GROUP BY c_region ORDER BY c_region"),
    "rawhll_year": (
        "SELECT d_year, DISTINCTCOUNTRAWHLL(lo_custkey) FROM lineorder "
        "GROUP BY d_year ORDER BY d_year"),
    "smarthll_region": (
        "SELECT c_region, DISTINCTCOUNTSMARTHLL(lo_suppkey) FROM lineorder "
        "GROUP BY c_region ORDER BY c_region"),
    # high-cardinality group-bys: 2,000 and 100,000 groups, 16,000 and
    # 800,000 (segment, group) runs for the host's schedule and fold
    "pct_tdigest_supp": (
        "SELECT lo_suppkey, PERCENTILETDIGEST(lo_revenue, 90) FROM lineorder "
        "GROUP BY lo_suppkey ORDER BY lo_suppkey LIMIT 20"),
    "sumprec_cust": (
        "SELECT lo_custkey, SUMPRECISION(lo_revenue) FROM lineorder "
        "GROUP BY lo_custkey ORDER BY lo_custkey LIMIT 20"),
    # each (segment, region) holds all 2,000 suppliers: past the threshold
    # every one becomes K3 registers
    "smarthll_low": (
        "SELECT c_region, DISTINCTCOUNTSMARTHLL(lo_suppkey, 1000) FROM "
        "lineorder GROUP BY c_region ORDER BY c_region"),
}
# (compression, percentile) of the digest queries
SK_DIGESTS = {"pct_scalar": (200.0, 50), "pct_tdigest_year": (100.0, 90),
              "pct_raw_month": (100.0, 50), "pct_tdigest_supp": (100.0, 90)}
SK_SUPP_ROWS = 20     # pct_tdigest_supp's and sumprec_cust's LIMIT

TRIM_TWINS = ("q1_scan_agg", "q4_no_hll", "q4_scan_hll")
GROUPS_LIMIT_SQL = QUERIES["q4_no_hll"].replace(
    "SELECT", "SET numGroupsLimit = 100; SELECT", 1)
NO_TRIM = "SET useDeviceReduce = false; "

# the high-cardinality path: dict group-bys past the dense regime's 2^22
# groups (lo_suppkey x lo_orderdate: 2,000 x 2,352 = 4,704,000 keys) in
# the sorted regime, a key-order numGroupsLimit truncation, and the
# table's overflow (lo_custkey x lo_suppkey, ~78.7M pairs past K =
# 100,000), which runs again in the host path's shape; then the
# star-tree's digest, bitmap and decimal pairs over a table of two of the
# unsorted segments, whose cube-side merges run in that shape too
HC_DAYS = "lo_orderdate BETWEEN 19930101 AND 19930128"
HC_SUPP_DAY = ("SELECT lo_suppkey, lo_orderdate, COUNT(*), SUM(lo_revenue), "
               "MINMAXRANGE(lo_quantity), AVG(lo_discount) FROM lineorder "
               f"WHERE {HC_DAYS} GROUP BY lo_suppkey, lo_orderdate")
HC_TOP = " ORDER BY SUM(lo_revenue) DESC, lo_suppkey, lo_orderdate LIMIT 100"
HC_KEYORDER_LIMIT, HC_KEYORDER_ROWS = 1000, 50
HC_OVERFLOW_ROWS = 10
HC_K = 100_000   # the engine's numGroupsLimit: the sorted table's cap K
PAIRS_TABLE = "lineorder_pairs"
PAIRS_SEGMENTS = 2
HC_QUERIES = {
    "hc_supp_day": HC_SUPP_DAY + HC_TOP,
    "hc_supp_day_untrimmed": NO_TRIM + HC_SUPP_DAY + HC_TOP,
    "hc_limit_keyorder": (
        f"{NO_TRIM}SET numGroupsLimit = {HC_KEYORDER_LIMIT}; {HC_SUPP_DAY} "
        f"LIMIT {HC_KEYORDER_ROWS}"),
    "hc_overflow": (
        "SELECT lo_custkey, lo_suppkey, COUNT(*), SUM(lo_revenue) FROM "
        "lineorder GROUP BY lo_custkey, lo_suppkey ORDER BY SUM(lo_revenue) "
        f"DESC, lo_custkey, lo_suppkey LIMIT {HC_OVERFLOW_ROWS}"),
    "st_tdigest_year": (
        "SELECT d_year, PERCENTILETDIGEST(lo_revenue, 90), "
        f"PERCENTILEEST(lo_revenue, 75) FROM {PAIRS_TABLE} GROUP BY d_year "
        "ORDER BY d_year"),
    "st_bitmap_region": (
        f"SELECT c_region, DISTINCTCOUNTBITMAP(lo_discount), COUNT(*) FROM "
        f"{PAIRS_TABLE} WHERE d_year != 1995 GROUP BY c_region "
        "ORDER BY c_region"),
    "st_sumprec_region": (
        f"SELECT c_region, SUMPRECISION(lo_revenue), COUNT(*) FROM "
        f"{PAIRS_TABLE} GROUP BY c_region ORDER BY c_region"),
}
# the pairs table's tree; (percentile, compression) of its digest queries
PAIR_TREES = (
    (["d_year", "c_region"], ["COUNT__*", "PERCENTILETDIGEST__lo_revenue",
                              "PERCENTILEEST__lo_revenue",
                              "DISTINCTCOUNTBITMAP__lo_discount",
                              "SUMPRECISION__lo_revenue"]),
)
ST_DIGESTS = ((90, 100.0), (75, 200.0))
# the exact pairs, whose cube answer must equal the scan's
# (tests/test_startree.py's bitmap and decimal pair tests)
CUBE_SCAN_TWINS = ("st_bitmap_region", "st_sumprec_region")
# per execution: sorted-regime tables built, host-path-shape re-runs
QUERY_ROUTES = {
    "hc_supp_day": (1, 0), "hc_supp_day_untrimmed": (1, 0),
    "hc_limit_keyorder": (1, 0), "hc_overflow": (1, 1),
    "st_tdigest_year": (0, 0), "st_bitmap_region": (0, 0),
    "st_sumprec_region": (0, 0),
}
SORTED_BUILDS = [0]   # chunked_group_aggregate calls (count_sorted_builds)

# the unsorted table's filtered queries, which are block-skip eligible and
# overflow the candidate bound: their cost against SET useBlockSkip=false
OVERFLOW_QUERIES = ("q2_range_sum", "q3_in_range", "q6_minmax",
                    "hll_scalar", "distinct_count")

# kernels each path must launch, and the entries (the TPU kernels they
# replace: pinot_tpu's Pallas rows) each path must reach
PATHS = {
    "ssb": (QUERIES, ("group_plane_sums", "group_minmax"),
            ((3, "group_scatter", "plane_group_sums"),
             (4, "group_scatter", "group_minmax"))),
    "hll": (HLL_QUERIES, ("group_plane_sums", "hll_register_max"),
            ((1, "groupby_mm", "group_sums"),
             (2, "groupby_mm", "hll_registers"),
             (5, "group_scatter", "hll_register_max"))),
    "blockskip": (BS_QUERIES, ("fused_filter_agg", "group_plane_sums"),
                  ((6, "group_scatter", "fused_filter_agg"),
                   (3, "group_scatter", "plane_group_sums"))),
    # the cubes hold 1,000-16,000 rows: below K1's 2^17-row gate their
    # launches take the torch scatters, as the reference's take XLA's
    "startree": (ST_QUERIES, (), ()),
    # group ids factorized on the card (gb_expr, gb_segment) and DISTINCT
    # over dict columns reach K1 and K2 as the dict group-bys do
    "selection": (SEL_QUERIES, ("group_plane_sums", "group_minmax"),
                  ((3, "group_scatter", "plane_group_sums"),
                   (4, "group_scatter", "group_minmax"))),
    # t-digests through K5, SUMPRECISION's byte planes through K1, the
    # raw HLL registers of d_year's 7 x 1024 slots and smarthll_low's
    # past-threshold runs through K3's group entry
    "sketch": (SK_QUERIES, ("cluster_sums", "group_plane_sums",
                            "hll_register_max"),
               ((3, "group_scatter", "plane_group_sums"),
                (2, "groupby_mm", "hll_registers"))),
    # the sorted regime is torch ops (XLA code in the reference); the
    # overflow's host-path shape sums its kept groups and the cube's
    # decimal pair its byte planes through K1
    "highcard": (HC_QUERIES, ("group_plane_sums",),
                 ((3, "group_scatter", "plane_group_sums"),)),
}

# timed runs of the queries that take seconds each, in place of --runs
# (0: no p50; the checked execution's time goes to FIRST_RUN_MS, and for
# the star join it includes building the broker's stage-2 executor):
# pct_tdigest_supp (~8.4-9.7 s a run on the host's digest fold) and the
# cluster path's star join (stage 1 over the wire, ~7 s); the run's time
# went to the cluster path
TIMED_RUNS = {"pct_tdigest_supp": 0, "cl_star_week": 0}
FIRST_RUN_MS = {}   # the untimed queries' checked executions, ms

# threads the paths' numpy oracles share beside the segment writes (the
# set-up's longest chain ran them one after another on the main thread)
ORACLE_THREADS = 3

# kernel launches that one execution of a query makes: q6's three min/max
# aggregates share one K2 launch
QUERY_LAUNCHES = {
    "q6_minmax": {"group_minmax": 1},
    "gb_expr": {"group_plane_sums": 1, "group_minmax": 1},
    "gb_segment": {"group_plane_sums": 1, "group_minmax": 1},
    "distinct_dict": {"group_plane_sums": 1},
    "pct_scalar": {"cluster_sums": 1},
    "pct_tdigest_year": {"cluster_sums": 1},
    "pct_raw_month": {"cluster_sums": 1},
    "pct_tdigest_supp": {"cluster_sums": 1},
    # the pipeline's group count, then SUMPRECISION's byte planes
    "sumprec_year": {"group_plane_sums": 2},
    "sumprec_cust": {"group_plane_sums": 2},
    "rawhll_year": {"hll_register_max": 1},
    "smarthll_low": {"hll_register_max": 1},
    # the sorted regime launches no kernel: its MINMAXRANGE is no K2 call
    "hc_supp_day": {"group_plane_sums": 0, "group_minmax": 0},
    "hc_supp_day_untrimmed": {"group_plane_sums": 0, "group_minmax": 0},
    "hc_limit_keyorder": {"group_plane_sums": 0, "group_minmax": 0},
    # the host path's shape over the kept groups: COUNT and SUM in one K1
    "hc_overflow": {"group_plane_sums": 1},
    "st_sumprec_region": {"group_plane_sums": 1},
}


# the serving path: cohorts of one template with different literals,
# released together through a forced coalescer window
SERVE_K1 = ("SET useStarTree = false; "
            "SELECT lo_suppkey, COUNT(*), SUM(lo_revenue) FROM lineorder "
            "WHERE lo_quantity > {lit} GROUP BY lo_suppkey "
            "ORDER BY SUM(lo_revenue) DESC, lo_suppkey LIMIT 10")
SERVE_K1_LITS = (1, 7, 13, 19, 25, 31, 37, 43)
SERVE_DISCOUNTS = (0, 2, 4, 6)   # lo_discount BETWEEN a AND a + 2
SERVE_K4_RANGES = ((19930301, 19930328), (19940401, 19940428),
                   (19950501, 19950528), (19960601, 19960628),
                   # past the candidate bound: the dense sub-cohort
                   (19930101, 19961231))
SERVE_K4_FILTERS = {f"serve_k4_{lo}": ("range", "lo_orderdate", lo, hi)
                    for lo, hi in SERVE_K4_RANGES}


def table_segs(eng, name: str) -> list:
    """The segments a port engine's table holds, in the order added."""
    return list(eng.tables[name].segments.values())


def _serve_sql(template: str, old: str, new: str) -> str:
    if old not in template:
        raise ValueError(f"{old!r} not in {template!r}")
    return template.replace(old, new)


# cohort -> (member queries, member-axis entries each launch of it makes)
SERVE_COHORTS = {
    "serve_cohort_k1": (
        {f"serve_k1_{lit}": SERVE_K1.format(lit=lit) for lit in SERVE_K1_LITS},
        {"group_plane_sums_members": 1}),
    # q6's COUNT(*) through K1, its MIN / MAX / MINMAXRANGE through K2
    "serve_cohort_k2": (
        {f"serve_k2_{a}": _serve_sql(QUERIES["q6_minmax"], "BETWEEN 1 AND 3",
                                     f"BETWEEN {a} AND {a + 2}")
         for a in SERVE_DISCOUNTS},
        {"group_plane_sums_members": 1, "group_minmax_members": 1}),
    "serve_cohort_k3": (
        {f"serve_k3_{a}": _serve_sql(HLL_QUERIES["hll_scalar"],
                                     "BETWEEN 1 AND 3",
                                     f"BETWEEN {a} AND {a + 2}")
         for a in SERVE_DISCOUNTS},
        {"hll_register_max_members": 1}),
    # four months by K4's member-axis entry, one range past the bound in
    # the dense sub-cohort (scalar torch ops, no kernel)
    "serve_cohort_k4": (
        {f"serve_k4_{lo}": _serve_sql(BS_QUERIES["bs_month_fused"],
                                      "BETWEEN 19930301 AND 19930328",
                                      f"BETWEEN {lo} AND {hi}")
         for lo, hi in SERVE_K4_RANGES},
        {"fused_filter_agg_members": 1}),
}
# the member-axis entries: (kernel, the solo entry, the TPU kernel rows)
SERVE_ENTRIES = {
    "group_plane_sums_members": (
        "group_plane_sums", "pinot_tpu/ops/pallas_scatter.py:244 (and "
        "pinot_tpu/ops/groupby_mm.py:225) under jax.vmap"),
    "group_minmax_members": (
        "group_minmax", "pinot_tpu/ops/pallas_scatter.py:349 under jax.vmap"),
    "hll_register_max_members": (
        "hll_register_max", "pinot_tpu/ops/pallas_scatter.py:455 (and "
        "pinot_tpu/ops/groupby_mm.py:225 in rho_mode) under jax.vmap"),
    "fused_filter_agg_members": (
        "fused_filter_agg", "pinot_tpu/ops/pallas_scatter.py:792 under "
        "jax.vmap"),
}
SERVE_REPEATS = 6      # serve_partials: one miss, then hits
SERVE_RELEASES = 9     # serve_cohort: timed releases (and solo passes)
SERVE_SWEEP_THREADS = (1, 2, 4, 8)
SERVE_SWEEP_QUERIES = 40   # per thread count and coalescer setting (320,
                           # then 80, until the cluster path and the m3
                           # phases needed the run's time)
PROBE_MAX_OF_PEAK = 1.05   # the probe against HBM_BYTES_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data: bench.py's SSB lineorder generator (seed 7), region and nation kept
# as their drawn indexes until a segment is written
# ---------------------------------------------------------------------------


def generate(segments: int, rows: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(segments):
        n = rows
        out.append({
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "c_region": rng.integers(0, 5, n).astype(np.int8),
            "s_nation": rng.integers(0, 25, n).astype(np.int8),
            "lo_suppkey": rng.integers(0, 2000, n).astype(np.int32),
            "lo_custkey": rng.integers(0, 100_000, n).astype(np.int32),
            "lo_orderdate": (
                19920101
                + (rng.integers(0, 7, n) * 10000)
                + (rng.integers(0, 12, n) * 100)
                + rng.integers(0, 28, n)
            ).astype(np.int32),
            "lo_discount": rng.integers(0, 11, n).astype(np.int32),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
            "lo_revenue": rng.integers(1000, 6_000_000, n).astype(np.int32),
        })
    return out


def sort_by_date(data: list) -> list:
    """The same rows stably sorted by lo_orderdate, cut into as many
    segments of the same sizes."""
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    order = np.argsort(c["lo_orderdate"], kind="stable")
    c = {k: v[order] for k, v in c.items()}
    cuts = np.cumsum([len(d["lo_orderdate"]) for d in data])[:-1]
    return [dict(zip(c, parts))
            for parts in zip(*(np.split(v, cuts) for v in c.values()))]


def write_segment(i: int, seg: dict, table: str = "lineorder",
                  star: bool = False) -> tuple:
    """Writes segment ``s<i>`` of ``table`` with the port's creator (run
    in a worker process), with the table's star-tree cubes when ``star``
    (bench.py's two for lineorder, ``PAIR_TREES`` for the pairs table).
    Returns (directory, seconds the cube build took)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import (
        IndexingConfig,
        StarTreeIndexConfig,
        TableConfig,
    )
    from pinot_tpu_torch.storage import startree
    from pinot_tpu_torch.storage.creator import build_segment

    schema = Schema.build(
        name="lineorder",
        dimensions=[
            ("d_year", DataType.INT), ("c_region", DataType.STRING),
            ("s_nation", DataType.STRING), ("lo_suppkey", DataType.INT),
            ("lo_custkey", DataType.INT), ("lo_orderdate", DataType.INT),
            ("lo_discount", DataType.INT),
        ],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT)])
    cols = dict(seg)
    cols["c_region"] = REGIONS[cols["c_region"]]
    cols["s_nation"] = NATIONS[cols["s_nation"]]
    out = os.path.join(DATA_DIR, table, f"s{i}")
    trees = [StarTreeIndexConfig(dimensions_split_order=d,
                                 function_column_pairs=p)
             for d, p in (PAIR_TREES if table == PAIRS_TABLE
                          else STAR_TREES)] if star else []
    cfg = TableConfig(table_name=table, indexing=IndexingConfig(
        star_tree_configs=trees))
    cube_s = [0.0]
    build = startree.build_star_trees

    def timed(*a):  # the creator's cube step, timed apart in this worker
        t = time.perf_counter()
        build(*a)
        cube_s[0] = time.perf_counter() - t
    startree.build_star_trees = timed
    try:
        build_segment(schema, cols, out, cfg, f"s{i}")
    finally:
        startree.build_star_trees = build
    return out, cube_s[0]


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------


def fmix32(keys: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer over the int32 bits of ``keys``."""
    h = keys.astype(np.int32).view(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def hll_idx_rho(h: np.ndarray, log2m: int):
    """Register index (top bits) and rank (leading zeros of the rest + 1,
    capped by a sentinel bit), rank exact from the float64 exponent."""
    idx = (h >> np.uint32(32 - log2m)).astype(np.int64)
    w = ((h.astype(np.uint64) << np.uint64(log2m)) & np.uint64(0xFFFFFFFF)) \
        | np.uint64(1 << (log2m - 1))
    _, e = np.frexp(w.astype(np.float64))
    return idx, (33 - e).astype(np.int8)


def hll_estimates(idx, rho, gid, num_groups: int, log2m: int) -> np.ndarray:
    """(G,) HLL estimates over rows with gid >= 0: registers by rank in
    ascending order (a later, larger rank overwrites), then the standard
    estimate with the small- and large-range corrections."""
    m = 1 << log2m
    keep = gid >= 0
    slot = gid[keep].astype(np.int64) * m + idx[keep]
    r = rho[keep]
    regs = np.zeros(num_groups * m, np.int8)
    for k in range(1, 34 - log2m):
        regs[slot[r == k]] = k
    regs = regs.reshape(num_groups, m)
    alpha = 0.7213 / (1 + 1.079 / m)
    raw = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)), axis=1)
    zeros = np.sum(regs == 0, axis=1)
    small = (raw <= 2.5 * m) & (zeros > 0)
    lin = m * np.log(m / np.maximum(zeros, 1))
    big = raw > (1 << 32) / 30.0
    large = -float(1 << 32) * np.log(1.0 - raw / float(1 << 32))
    est = np.where(small, lin, np.where(big, large, raw))
    return np.round(est).astype(np.int64)


def oracle(data: list) -> dict:
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    year, region, nation = c["d_year"], c["c_region"], c["s_nation"]
    supp, od, disc = c["lo_suppkey"], c["lo_orderdate"], c["lo_discount"]
    qty, rev = c["lo_quantity"], c["lo_revenue"].astype(np.int64)
    want = {}

    s = np.bincount(supp, weights=rev, minlength=2000)  # exact: < 2^53
    top = sorted(range(2000), key=lambda k: (-s[k], k))[:10]
    want["q1_scan_agg"] = ([[k, float(s[k])] for k in top], len(supp))

    m = (od >= 19930101) & (od <= 19931231) & (disc >= 1) & (disc <= 3) \
        & (qty < 25)
    want["q2_range_sum"] = ([[float(rev[m].sum())]], int(m.sum()))

    m = np.isin(supp, IN_SUPP) & (disc >= 4) & (disc <= 6)
    want["q3_in_range"] = ([[int(m.sum()), float(rev[m].sum())]],
                           int(m.sum()))

    cnt = np.bincount(supp, minlength=2000)
    qs = np.bincount(supp, weights=qty.astype(np.int64), minlength=2000)
    top = sorted((k for k in range(2000) if cnt[k]),
                 key=lambda k: (-cnt[k], k))[:10]
    want["q4_no_hll"] = ([[k, int(cnt[k]), float(qs[k]) / float(cnt[k])]
                          for k in top], len(supp))
    want["q4_counts"], want["q4_qsums"] = cnt, qs
    # SET numGroupsLimit = 100 on q4_no_hll as the reference's host path
    # answers it: per segment, the 100 keys met first in doc order keep
    # their rows; then the reduce
    kc, kq = np.zeros(2000, np.int64), np.zeros(2000, np.int64)
    for d in data:
        u, first = np.unique(d["lo_suppkey"], return_index=True)
        kept = np.isin(d["lo_suppkey"], u[np.argsort(first)[:100]])
        kc += np.bincount(d["lo_suppkey"][kept], minlength=2000)
        kq += np.bincount(d["lo_suppkey"][kept], minlength=2000,
                          weights=d["lo_quantity"][kept]).astype(np.int64)
    top = sorted(np.flatnonzero(kc).tolist(), key=lambda k: (-kc[k], k))[:10]
    want["q4_groups_limit_host"] = [[k, int(kc[k]), kq[k] / float(kc[k])]
                                    for k in top]

    g = (year - 1992).astype(np.int64) * 5 + region
    cnt = np.bincount(g, minlength=35)
    rs = np.bincount(g, weights=rev, minlength=35)
    want["q5_scan"] = ([[1992 + k // 5, str(REGIONS[k % 5]), float(rs[k]),
                         int(cnt[k])] for k in range(35) if cnt[k]],
                       len(supp))

    m = (disc >= 1) & (disc <= 3)
    g = (year[m] - 1992).astype(np.int64) * 25 + nation[m]
    r, q = rev[m], qty[m].astype(np.int64)
    cnt = np.bincount(g, minlength=175)
    rmin = np.full(175, np.iinfo(np.int64).max)
    rmax = np.full(175, np.iinfo(np.int64).min)
    qmin, qmax = rmin.copy(), rmax.copy()
    np.minimum.at(rmin, g, r)
    np.maximum.at(rmax, g, r)
    np.minimum.at(qmin, g, q)
    np.maximum.at(qmax, g, q)
    want["q6_minmax"] = ([[1992 + k // 25, str(NATIONS[k % 25]),
                           float(rmin[k]), float(rmax[k]),
                           float(qmax[k] - qmin[k]), int(cnt[k])]
                          for k in range(175) if cnt[k]], int(m.sum()))

    idx, rho = hll_idx_rho(fmix32(c["lo_custkey"]), LOG2M)
    est = hll_estimates(idx, rho, supp, 2000, LOG2M)
    q4 = [row + [int(est[row[0]])] for row in want["q4_no_hll"][0]]
    want["q4_scan_hll"] = want["q4_scan_hll_cold"] = (q4, len(supp))

    m = (disc >= 1) & (disc <= 3)
    est = hll_estimates(idx, rho, np.where(m, 0, -1), 1, LOG2M)
    want["hll_scalar"] = ([[int(m.sum()), int(est[0])]], int(m.sum()))

    g = (year - 1992).astype(np.int64) * 5 + region
    cnt = np.bincount(g, minlength=35)
    est = hll_estimates(idx, rho, g, 35, LOG2M)
    want["hll_small_group"] = ([[1992 + k // 5, str(REGIONS[k % 5]),
                                 int(est[k])] for k in range(35) if cnt[k]],
                               len(supp))

    m = qty < 10
    pairs = np.unique((year[m] - 1992).astype(np.int64) * 2000 + supp[m])
    dc = np.bincount(pairs // 2000, minlength=7)
    want["distinct_count"] = ([[1992 + y, int(dc[y])] for y in range(7)
                               if dc[y]], int(m.sum()))
    return want


def serve_oracle(data: list) -> dict:
    """The serving path's K1, K2 and K3 cohort members from the columns
    (the K4 members' come with ``bs_oracle``): per lo_quantity literal the
    top ten suppliers by revenue, per lo_discount range q6's extremes and
    hll_scalar's count and estimate."""
    c = {k: np.concatenate([d[k] for d in data]) for k in
         ("d_year", "s_nation", "lo_suppkey", "lo_discount", "lo_quantity",
          "lo_revenue", "lo_custkey")}
    supp, disc, qty = c["lo_suppkey"], c["lo_discount"], c["lo_quantity"]
    rev = c["lo_revenue"].astype(np.int64)
    want = {}
    for lit in SERVE_K1_LITS:
        m = qty > lit
        cnt = np.bincount(supp[m], minlength=2000)
        s = np.bincount(supp[m], weights=rev[m], minlength=2000)
        top = sorted(np.flatnonzero(cnt).tolist(),
                     key=lambda k: (-s[k], k))[:10]
        want[f"serve_k1_{lit}"] = ([[k, int(cnt[k]), float(s[k])]
                                    for k in top], int(m.sum()))
    idx, rho = hll_idx_rho(fmix32(c["lo_custkey"]), LOG2M)
    for a in SERVE_DISCOUNTS:
        m = (disc >= a) & (disc <= a + 2)
        g = (c["d_year"][m] - 1992).astype(np.int64) * 25 + c["s_nation"][m]
        r, q = rev[m], qty[m].astype(np.int64)
        cnt = np.bincount(g, minlength=175)
        ext = {}
        for key, v in (("r", r), ("q", q)):
            lo = np.full(175, np.iinfo(np.int64).max)
            hi = np.full(175, np.iinfo(np.int64).min)
            np.minimum.at(lo, g, v)
            np.maximum.at(hi, g, v)
            ext[key] = (lo, hi)
        want[f"serve_k2_{a}"] = (
            [[1992 + k // 25, str(NATIONS[k % 25]), float(ext["r"][0][k]),
              float(ext["r"][1][k]), float(ext["q"][1][k] - ext["q"][0][k]),
              int(cnt[k])] for k in range(175) if cnt[k]], int(m.sum()))
        est = hll_estimates(idx, rho, np.where(m, 0, -1), 1, LOG2M)
        want[f"serve_k3_{a}"] = ([[int(m.sum()), int(est[0])]],
                                 int(m.sum()))
    return want

def st_oracle(data: list, want: dict) -> dict:
    """The star-tree path's answers and the cube rows each query reads.
    The d_year x c_region x s_nation cube holds, per segment and present
    combination, the exact revenue sum in a DOUBLE column, which the card
    holds as float32 (the reference's value space for DOUBLE): the oracle
    rounds each cube row's sum to float32 and sums those in float64 per
    group (exact: every term is a multiple of its float32 spacing and the
    sums stay below 2^53). Also returns, under ``q5_exact``, q5's exact
    integer sums, which the run compares with the answer."""
    combos = 7 * 5 * 25
    q5_sum, q5_exact = np.zeros(35), np.zeros(35)
    q5_cnt = np.zeros(35, np.int64)
    f_sum, f_cnt = np.zeros(5), np.zeros(5, np.int64)
    rows5 = rows_f = rows4 = 0
    combo = np.arange(combos)
    yr, grp = combo // 125, combo // 25          # year index, year x region
    for d in data:
        key = (d["d_year"].astype(np.int64) - 1992) * 125 \
            + d["c_region"].astype(np.int64) * 25 + d["s_nation"]
        cnt = np.bincount(key, minlength=combos)
        exact = np.bincount(key, weights=d["lo_revenue"].astype(np.float64),
                            minlength=combos)  # integers below 2^53: exact
        dev = exact.astype(np.float32).astype(np.float64)
        present = cnt > 0
        rows5 += int(present.sum())
        q5_sum += np.bincount(grp[present], weights=dev[present],
                              minlength=35)
        q5_exact += np.bincount(grp, weights=exact, minlength=35)
        q5_cnt += np.bincount(grp, weights=cnt, minlength=35).astype(np.int64)
        in95 = present & (yr == 1995 - 1992)
        rows_f += int(in95.sum())
        f_sum += np.bincount(grp[in95] % 5, weights=dev[in95], minlength=5)
        f_cnt += np.bincount(grp[in95] % 5, weights=cnt[in95],
                             minlength=5).astype(np.int64)
        rows4 += len(np.unique(d["lo_suppkey"]))
    total = sum(len(d["lo_revenue"]) for d in data)
    rev_min = min(int(d["lo_revenue"].min()) for d in data)
    rev_max = max(int(d["lo_revenue"].max()) for d in data)
    return {
        "q4_highcard_hll": (want["q4_scan_hll"][0], rows4),
        "q5_startree": ([[1992 + k // 5, str(REGIONS[k % 5]), float(q5_sum[k]),
                          int(q5_cnt[k])] for k in range(35) if q5_cnt[k]],
                        rows5),
        "st_filtered": ([[str(REGIONS[r]), float(f_sum[r]), int(f_cnt[r])]
                         for r in range(5) if f_cnt[r]], rows_f),
        "metadata_only": ([[total, float(rev_min), float(rev_max)]], total,
                          {"numEntriesScannedPostFilter": 0}),
        "q5_exact": [float(q5_exact[k]) for k in range(35) if q5_cnt[k]],
    }


def hc_overflow_part(cust, supp, rev, limit: int = HC_K) -> tuple:
    """hc_overflow's partial of one segment as the reference's host path
    builds it (engine/host.py ``_group_by``): numGroupsLimit keeps the
    ``limit`` (lo_custkey, lo_suppkey) pairs met first in doc order, then
    (pair keys, counts, revenue sums, kept rows, whether the limit cut)
    over their rows. Runs in a worker process."""
    pair = cust.astype(np.int64) * 2000 + supp
    u, first, inv = np.unique(pair, return_index=True, return_inverse=True)
    keep = np.zeros(len(u), bool)
    keep[np.argsort(first, kind="stable")[:limit]] = True
    kept = keep[inv]
    ku, kinv = np.unique(pair[kept], return_inverse=True)
    return (ku, np.bincount(kinv), np.bincount(
        kinv, weights=rev[kept].astype(np.float64)).astype(np.int64),
        int(kept.sum()), len(u) > limit)


def hc_oracle(data: list, overflow_parts: list) -> dict:
    """The high-cardinality path's answers and stats: the sorted regime's
    groups over the filter (exact sums, counts, ranges, averages), the
    key-order truncation (the first ``HC_KEYORDER_LIMIT`` keys, lo_suppkey
    major), the overflow from ``hc_overflow_part``'s per-segment partials
    merged, and the pairs table's cube answers over its two segments,
    numDocsScanned counting cube rows."""
    import decimal  # noqa: F401  (SUMPRECISION renders exact integers)

    c = {k: np.concatenate([d[k] for d in data]) for k in
         ("lo_suppkey", "lo_orderdate", "lo_revenue", "lo_quantity",
          "lo_discount")}
    S, n = len(data), len(c["lo_suppkey"])
    seg = np.repeat(np.arange(S), [len(d["d_year"]) for d in data])
    od = c["lo_orderdate"]
    m = (od >= 19930101) & (od <= 19930128)
    m_rows = int(m.sum())
    key = c["lo_suppkey"][m].astype(np.int64) * 100_000_000 + od[m]
    u, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    rsum = np.bincount(inv, weights=c["lo_revenue"][m].astype(np.float64))
    dsum = np.bincount(inv, weights=c["lo_discount"][m].astype(np.float64))
    qmin = np.full(len(u), 1 << 30)
    qmax = np.zeros(len(u), np.int64)
    np.minimum.at(qmin, inv, c["lo_quantity"][m])
    np.maximum.at(qmax, inv, c["lo_quantity"][m])

    def row(j):
        return [int(u[j] // 100_000_000), int(u[j] % 100_000_000),
                int(cnt[j]), float(rsum[j]), float(qmax[j] - qmin[j]),
                dsum[j] / float(cnt[j])]

    stats = {"numEntriesScannedInFilter": n,
             "numEntriesScannedPostFilter": 3 * m_rows,
             "numGroupsLimitReached": False, "numBlocksPruned": 0}
    top = sorted(range(len(u)), key=lambda j: (-rsum[j], u[j]))[:100]
    want = {"hc_supp_day": ([row(j) for j in top], m_rows, stats),
            "hc_supp_day_untrimmed": ([row(j) for j in top], m_rows, stats),
            "hc_limit_keyorder": (
                [row(j) for j in range(HC_KEYORDER_ROWS)], m_rows,
                dict(stats, numGroupsLimitReached=True))}
    log(f"hc oracle: {len(u)} (lo_suppkey, lo_orderdate) groups over "
        f"{m_rows} rows")

    keys = np.concatenate([p[0] for p in overflow_parts])
    ou, oinv = np.unique(keys, return_inverse=True)
    ocnt = np.bincount(oinv, weights=np.concatenate(
        [p[1] for p in overflow_parts])).astype(np.int64)
    osum = np.bincount(oinv, weights=np.concatenate(
        [p[2] for p in overflow_parts]).astype(np.float64))
    kept = sum(p[3] for p in overflow_parts)
    top = np.lexsort((ou, -osum))[:HC_OVERFLOW_ROWS]
    want["hc_overflow"] = (
        [[int(ou[j] // 2000), int(ou[j] % 2000), int(ocnt[j]),
          float(osum[j])] for j in top], n,
        dict(host_stats(seg, np.ones(n, bool), n, S, 0, kept),
             numGroupsLimitReached=any(p[4] for p in overflow_parts),
             numBlocksPruned=0))

    # the pairs table: its first PAIRS_SEGMENTS segments
    pd_ = data[:PAIRS_SEGMENTS]
    p = {k: np.concatenate([d[k] for d in pd_]) for k in
         ("d_year", "c_region", "lo_revenue", "lo_discount")}
    total = len(p["d_year"])
    combos = [len(np.unique(d["d_year"].astype(np.int64) * 8
                            + d["c_region"])) for d in pd_]
    combos_95 = [len(np.unique((d["d_year"].astype(np.int64) * 8
                                + d["c_region"])[d["d_year"] != 1995]))
                 for d in pd_]
    years = np.unique(p["d_year"])
    checks = [_rank_checker(f"st_tdigest_year p{pp}",
                            [(int(y), p["lo_revenue"][p["d_year"] == y])
                             for y in years], pp / 100, delta)
              for pp, delta in ST_DIGESTS]

    def digests(got):
        for j, check in enumerate(checks):
            check([[r[0], r[1 + j]] for r in got])

    cube = {"totalDocs": total}
    want["st_tdigest_year"] = (digests, sum(combos), cube)
    not95 = p["d_year"] != 1995
    want["st_bitmap_region"] = (
        [[str(REGIONS[r]),
          len(np.unique(p["lo_discount"][not95 & (p["c_region"] == r)])),
          int((not95 & (p["c_region"] == r)).sum())] for r in range(5)],
        sum(combos_95), dict(cube, scan_docs=int(not95.sum())))
    want["st_sumprec_region"] = (
        [[str(REGIONS[r]), str(int(p["lo_revenue"][p["c_region"] == r]
                                   .astype(np.int64).sum())),
          int((p["c_region"] == r).sum())] for r in range(5)],
        sum(combos), dict(cube, scan_docs=total))
    return want


# ---------------------------------------------------------------------------
# multi-value columns (the mv path) and the index-backed filters (the index
# path)
# ---------------------------------------------------------------------------

MV_TABLE = "lineorder_mv"
# two of the eight segments: four (625M lo_codes entries) put the kernel
# checks' plain versions past the card's memory and the run past its time
MV_SEGMENTS = 2
TAGS = np.array([f"tag{k:03d}" for k in range(1000)])
MV_QUERIES = {
    # the reference device's shape: mv_any over the (S, L, K) id block
    "mv_tag_year": (
        f"SELECT d_year, COUNT(*), SUM(lo_revenue) FROM {MV_TABLE} "
        "WHERE lo_tags = 'tag007' GROUP BY d_year ORDER BY d_year"),
    "mv_in_ne_max": (
        f"SELECT c_region, COUNT(*), MAX(lo_quantity) FROM {MV_TABLE} "
        "WHERE lo_tags IN ('tag001', 'tag002') AND lo_tags <> 'tag000' "
        "GROUP BY c_region ORDER BY c_region"),
    # the host path's shape: one row per entry of each matched doc
    "mv_group_tags": (
        f"SELECT lo_tags, COUNT(*) FROM {MV_TABLE} GROUP BY lo_tags "
        "ORDER BY COUNT(*) DESC, lo_tags LIMIT 20"),
    "mv_group_tags_year": (
        f"SELECT lo_tags, d_year, COUNT(*), SUM(lo_quantity) FROM {MV_TABLE} "
        "WHERE lo_discount = 3 GROUP BY lo_tags, d_year "
        "ORDER BY SUM(lo_quantity) DESC, lo_tags, d_year LIMIT 20"),
    # the *MV aggregations over lo_codes' entries (raw, up to 24 a doc)
    "mv_codes_year": (
        "SELECT d_year, COUNTMV(lo_codes), SUMMV(lo_codes), AVGMV(lo_codes), "
        f"MINMV(lo_codes), MAXMV(lo_codes) FROM {MV_TABLE} GROUP BY d_year "
        "ORDER BY d_year"),
    "mv_distinct_region": (
        "SELECT c_region, DISTINCTCOUNTMV(lo_tags), "
        f"DISTINCTCOUNTHLLMV(lo_tags) FROM {MV_TABLE} GROUP BY c_region "
        "ORDER BY c_region"),
    "mv_pct_codes": (
        f"SELECT d_year, PERCENTILETDIGESTMV(lo_codes, 99) FROM {MV_TABLE} "
        "GROUP BY d_year ORDER BY d_year"),
    "mv_sel_codes": (
        f"SELECT lo_revenue, lo_custkey, lo_tags FROM {MV_TABLE} "
        "WHERE lo_codes = 4242 ORDER BY lo_revenue DESC, lo_custkey LIMIT 10"),
}
MV_PCT = 0.99
MV_DELTA = 100.0   # PERCENTILETDIGEST's default compression

EV_TABLE = "events"
EV_SEGMENTS = 4
EV_TYPES = np.array(["CreateEvent", "ForkEvent", "IssuesEvent",
                     "PullRequestEvent", "PushEvent", "WatchEvent"])
EV_REPOS = np.array([f"{('apache', 'torvalds', 'octo', 'kube')[k % 4]}"
                     f"/project-{k}" for k in range(20_000)])
EV_WORDS = np.array(["fix", "merge", "pull", "request", "update", "readme",
                     "bug", "add", "test", "docs", "refactor", "release"]
                    + [f"w{k:04d}" for k in range(1988)])
EV_POOLS = (5_000, 20_000, 50_000)   # distinct payloads, messages, places
EV_POINT = (2.35, 48.85)
EV_RADIUS = 200_000
# each index column and its unindexed twin (the same values)
EV_FILTERS = {
    "json_nested": "JSON_MATCH({payload}, "
                   "'\"$.repo.name\" = ''apache/project-0''')",
    "json_array": "JSON_MATCH({payload}, "
                  "'\"$.commits[*].author\" = ''user0007''')",
    "text_term": "TEXT_MATCH({message}, 'fix')",
    "text_phrase": "TEXT_MATCH({message}, '\"merge pull\"')",
    "geo_within": (f"ST_DISTANCE({{location}}, ST_POINT({EV_POINT[0]}, "
                   f"{EV_POINT[1]})) < {EV_RADIUS}"),
    "regexp_repo": "REGEXP_LIKE({repo}, '^apache/project-[0-9]*2$')",
}
EV_COLS = ("payload", "message", "location", "repo")
IDX_QUERIES = {}
for _name, _f in EV_FILTERS.items():
    for _twin in ("", "_plain"):
        _where = _f.format(**{c: c + _twin for c in EV_COLS})
        IDX_QUERIES[f"{_name}_count{_twin}"] = \
            f"SELECT COUNT(*) FROM {EV_TABLE} WHERE {_where}"
        IDX_QUERIES[f"{_name}_sum{_twin}"] = (
            f"SELECT etype, COUNT(*), SUM(size) FROM {EV_TABLE} WHERE {_where} "
            "GROUP BY etype ORDER BY etype")


def mv_generate(data: list, seed: int = 17) -> list:
    """The mv path's two MV columns for the first ``MV_SEGMENTS`` SSB
    segments, shaped after airlineStats' MV dimensions: ``lo_tags``, 0-8
    entries a row (mean 4) drawn Zipf-like (p ~ 1 / k^1.1) from 1,000
    strings, and ``lo_codes``, raw INT, 1-24 entries a row from 0-9,999.
    Each as (flat values, offsets)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 1001) ** 1.1
    p /= p.sum()
    out = []
    for d in data[:MV_SEGMENTS]:
        n = len(d["d_year"])
        t_len = rng.integers(0, 9, n)
        c_len = rng.integers(1, 25, n)
        out.append({
            "lo_tags": (rng.choice(1000, size=int(t_len.sum()), p=p)
                        .astype(np.int16), _offsets(t_len)),
            "lo_codes": (rng.integers(0, 10_000, int(c_len.sum()))
                         .astype(np.int32), _offsets(c_len)),
        })
    return out


def _offsets(lens) -> np.ndarray:
    off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=off[1:])
    return off


def _rows_of(flat, off) -> list:
    """Per-row arrays of an MV column: the creator's per-row MV input."""
    return np.split(flat, off[1:-1])


def write_mv_segment(i: int, seg: dict, mv: dict) -> str:
    """Segment ``s<i>`` of ``MV_TABLE``: the SSB columns of ``seg`` and the
    MV columns of ``mv``, ``lo_codes`` without a dictionary, written by
    the port's creator (run in a worker process)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import IndexingConfig, \
        TableConfig
    from pinot_tpu_torch.storage.creator import build_segment

    schema = Schema.build(
        name=MV_TABLE,
        dimensions=[("d_year", DataType.INT), ("c_region", DataType.STRING),
                    ("lo_custkey", DataType.INT),
                    ("lo_discount", DataType.INT)],
        multi_value_dimensions=[("lo_tags", DataType.STRING),
                                ("lo_codes", DataType.INT)],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT)])
    cols = {k: seg[k] for k in ("d_year", "lo_custkey", "lo_discount",
                                "lo_quantity", "lo_revenue")}
    cols["c_region"] = REGIONS[seg["c_region"]]
    tag_ids, tag_off = mv["lo_tags"]
    cols["lo_tags"] = _rows_of(TAGS[tag_ids], tag_off)
    cols["lo_codes"] = _rows_of(*mv["lo_codes"])
    out = os.path.join(DATA_DIR, MV_TABLE, f"s{i}")
    build_segment(schema, cols, out, TableConfig(
        table_name=MV_TABLE,
        indexing=IndexingConfig(no_dictionary_columns=["lo_codes"])),
        f"s{i}")
    return out


def murmur3_32(data: bytes) -> int:
    """murmur3's 32-bit hash (seed 0) of ``data``: the hash the register
    build applies to a string's UTF-8 bytes before ``fmix32``."""
    c1, c2, h = 0xCC9E2D51, 0x1B873593, 0
    n = len(data) & ~3

    def mix(k):
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        return (k * c2) & 0xFFFFFFFF

    for i in range(0, n, 4):
        h ^= mix(int.from_bytes(data[i:i + 4], "little"))
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n:]
    if tail:
        h ^= mix(int.from_bytes(tail, "little"))
    h ^= len(data)
    return int(fmix32(np.asarray([h], dtype=np.uint32).view(np.int32))[0])


def _tag_hash() -> np.ndarray:
    """(1000,) uint32 register hash of each tag string."""
    return fmix32(np.asarray([murmur3_32(t.encode()) for t in TAGS],
                             dtype=np.uint32).view(np.int32))


def mv_oracle(data: list, mv: list) -> dict:
    """The mv path's answers and stats: the reference device's for the two
    ``mv_any`` filters (every row of the filter's column scanned, entries
    after it per matched row), its host path's for the rest (an MV
    predicate reads every entry of its column, a dict SV predicate every
    row; after the filter, per expanded row for the single-value
    aggregations and per entry for each *MV aggregation)."""
    data = data[:MV_SEGMENTS]
    S = len(data)
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    sizes = [len(d["d_year"]) for d in data]
    n = len(c["d_year"])
    seg = np.repeat(np.arange(S), sizes)
    year = (c["d_year"] - 1992).astype(np.int64)
    region = c["c_region"].astype(np.int64)
    rev, qty = c["lo_revenue"].astype(np.int64), c["lo_quantity"]

    def flat(col):
        """(values, doc of each entry) over the table, segment-major."""
        vals = np.concatenate([m[col][0] for m in mv])
        lens = np.concatenate([np.diff(m[col][1]) for m in mv])
        return vals, np.repeat(np.arange(n, dtype=np.int32), lens), lens

    tags, tdoc, tlen = flat("lo_tags")
    codes, cdoc, clen = flat("lo_codes")
    tags = tags.astype(np.int64)
    want = {}

    def any_tag(pred):
        hit = np.zeros(n, bool)
        hit[tdoc[pred(tags)]] = True
        return hit

    def matched_segments(m):
        return int(len(np.unique(seg[m])))

    m = any_tag(lambda t: t == 7)
    cnt = np.bincount(year[m], minlength=7)
    rs = np.bincount(year[m], weights=rev[m], minlength=7)
    want["mv_tag_year"] = (
        [[1992 + y, int(cnt[y]), float(rs[y])] for y in range(7) if cnt[y]],
        int(m.sum()), {"numEntriesScannedInFilter": n,
                       "numEntriesScannedPostFilter": int(m.sum()),
                       "numSegmentsMatched": matched_segments(m)})

    m = any_tag(lambda t: (t == 1) | (t == 2)) & any_tag(lambda t: t != 0)
    cnt = np.bincount(region[m], minlength=5)
    qh = np.bincount(region[m] * 64 + qty[m], minlength=5 * 64).reshape(5, 64)
    qmax = np.asarray([np.flatnonzero(h)[-1] if h.any() else -1 for h in qh])
    want["mv_in_ne_max"] = (
        [[str(REGIONS[r]), int(cnt[r]), float(qmax[r])] for r in range(5)
         if cnt[r]], int(m.sum()),
        {"numEntriesScannedInFilter": n,
         "numEntriesScannedPostFilter": int(m.sum()),
         "numSegmentsMatched": matched_segments(m)})

    cnt = np.bincount(tags, minlength=1000)
    top = sorted(np.flatnonzero(cnt).tolist(), key=lambda k: (-cnt[k], k))
    want["mv_group_tags"] = (
        [[str(TAGS[k]), int(cnt[k])] for k in top[:20]], n,
        {"numEntriesScannedInFilter": 0, "numEntriesScannedPostFilter": 0,
         "numGroupsLimitReached": False})

    m = c["lo_discount"] == 3
    sel = m[tdoc]
    g = tags[sel] * 7 + year[tdoc[sel]]
    cnt = np.bincount(g, minlength=7000)
    qs = np.bincount(g, weights=qty[tdoc[sel]].astype(np.int64),
                     minlength=7000)
    top = sorted(np.flatnonzero(cnt).tolist(), key=lambda k: (-qs[k], k))
    want["mv_group_tags_year"] = (
        [[str(TAGS[k // 7]), 1992 + k % 7, int(cnt[k]), float(qs[k])]
         for k in top[:20]], int(m.sum()),
        {"numEntriesScannedInFilter": n,
         "numEntriesScannedPostFilter": int(sel.sum()),
         "numSegmentsMatched": matched_segments(m)})

    cy = year[cdoc]
    hist = np.bincount(cy * 10_000 + codes, minlength=70_000) \
        .reshape(7, 10_000)
    cnt = hist.sum(axis=1)
    cs = hist @ np.arange(10_000, dtype=np.int64)
    cmin = [np.flatnonzero(h)[0] if h.any() else 0 for h in hist]
    cmax = [np.flatnonzero(h)[-1] if h.any() else 0 for h in hist]
    ycnt = np.bincount(year, minlength=7)
    want["mv_codes_year"] = (
        [[1992 + y, int(cnt[y]), float(cs[y]), float(cs[y]) / float(cnt[y]),
          float(cmin[y]), float(cmax[y])] for y in range(7) if ycnt[y]], n,
        {"numEntriesScannedInFilter": 0,
         "numEntriesScannedPostFilter": 5 * len(codes)})

    # a register takes the largest rank of its tags: the (region, tag)
    # pairs present decide every estimate
    present = np.flatnonzero(np.bincount(region[tdoc] * 1000 + tags,
                                         minlength=5000))
    dc = np.bincount(present // 1000, minlength=5)
    idx, rho = hll_idx_rho(_tag_hash()[present % 1000], LOG2M)
    est = hll_estimates(idx, rho, present // 1000, 5, LOG2M)
    want["mv_distinct_region"] = (
        [[str(REGIONS[r]), int(dc[r]), int(est[r])] for r in range(5)
         if np.any(region == r)], n,
        {"numEntriesScannedInFilter": 0,
         "numEntriesScannedPostFilter": 2 * len(tags)})

    want["mv_pct_codes"] = (_hist_rank_checker(
        "mv_pct_codes", [(1992 + y, hist[y]) for y in range(7) if ycnt[y]],
        MV_PCT, MV_DELTA), n,
        {"numEntriesScannedInFilter": 0,
         "numEntriesScannedPostFilter": len(codes)})

    m = np.zeros(n, bool)
    m[cdoc[codes == 4242]] = True
    idx_m = _top_rows(c, m, [(rev, False), (c["lo_custkey"], True)], 10)
    toff = np.concatenate([[0], np.cumsum(tlen)])
    kept = sum(min(10, int(m[seg == s].sum())) for s in range(S))
    want["mv_sel_codes"] = (
        [[int(rev[i]), int(c["lo_custkey"][i]),
          TAGS[tags[toff[i]:toff[i + 1]]].tolist()] for i in idx_m],
        int(m.sum()),
        {"numEntriesScannedInFilter": len(codes),
         "numEntriesScannedPostFilter": 3 * kept,
         "numSegmentsMatched": matched_segments(m)})
    return want


def _hist_rank_checker(name: str, groups: list, p: float, delta: float):
    """``_rank_checker`` over integer values given as histograms (value ->
    count): each row's value must lie within rank 1.5 / delta of p."""
    def check(got):
        if len(got) != len(groups):
            raise AssertionError(f"{name}: {len(got)} rows, want "
                                 f"{len(groups)}")
        worst = 0.0
        for row, (key, hist) in zip(got, groups):
            if row[0] != key:
                raise AssertionError(f"{name}: key {row[0]}, want {key}")
            est, total = row[-1], hist.sum()
            cum = np.concatenate([[0], np.cumsum(hist)])
            below = cum[min(max(int(np.ceil(est)), 0), len(hist))]
            upto = cum[min(max(int(np.floor(est)) + 1, 0), len(hist))]
            lo, hi = below / total, upto / total
            off = 0.0 if lo <= p <= hi else min(abs(lo - p), abs(hi - p))
            worst = max(worst, off)
            if off > 1.5 / delta:
                raise AssertionError(f"{name}: {est} sits {off:.5f} of rank "
                                     f"from p = {p} (bound {1.5 / delta})")
        log(f"{name}: every value within rank {worst:.6f} of p = {p} "
            f"(bound 1.5/delta = {1.5 / delta:.4f})")
    return check


def ev_generate(segments: int, rows: int, seed: int = 23) -> list:
    """The index path's ``events`` table, shaped after the githubEvents
    quickstart: each row draws a payload (type, repo.name, actor.login,
    commits[].author; ``EV_POOLS[0]`` distinct documents), a commit
    message (3-9 words of a 2,000-word vocabulary; ``EV_POOLS[1]``
    distinct), a place (``EV_POOLS[2]`` distinct WKT points over Europe)
    and a repository name (20,000 distinct), plus ``etype`` (the
    payload's type) and ``size``. Kept as pool indexes, the structured
    fields the oracle reads; ``ev_columns`` renders the strings."""
    rng = np.random.default_rng(seed)
    n_pay, n_msg, n_loc = EV_POOLS
    w = np.ones(len(EV_WORDS))
    w[:12] = 40.0       # the common commit words
    w /= w.sum()
    pools = {
        "type": rng.integers(0, len(EV_TYPES), n_pay),
        "prepo": rng.integers(0, 200, n_pay),
        "actor": rng.integers(0, 5_000, n_pay),
        "commits": [rng.integers(0, 100, rng.integers(0, 4)).tolist()
                    for _ in range(n_pay)],
        "words": [rng.choice(len(EV_WORDS), size=rng.integers(3, 10), p=w)
                  for _ in range(n_msg)],
        "lon": rng.integers(-10_000_000, 30_000_000, n_loc) / 1e6,
        "lat": rng.integers(35_000_000, 60_000_000, n_loc) / 1e6,
    }
    segs = []
    for _ in range(segments):
        pay = rng.integers(0, n_pay, rows)
        segs.append({"pay": pay, "msg": rng.integers(0, n_msg, rows),
                     "loc": rng.integers(0, n_loc, rows),
                     "repo": rng.integers(0, len(EV_REPOS), rows),
                     "size": rng.integers(1, 1_000, rows).astype(np.int32)})
    return [pools, segs]


def ev_strings(pools: dict) -> tuple:
    """(payload JSON, message, WKT point) strings of each pool entry."""
    payloads = np.asarray([json.dumps({
        "type": str(EV_TYPES[t]), "repo": {"name": str(EV_REPOS[r])},
        "actor": {"login": f"user{a:04d}"},
        "commits": [{"author": f"user{x:04d}", "sha": f"{j:05x}{i}"}
                    for i, x in enumerate(cm)]})
        for j, (t, r, a, cm) in enumerate(zip(
            pools["type"], pools["prepo"], pools["actor"],
            pools["commits"]))])
    messages = np.asarray([" ".join(EV_WORDS[ws]) for ws in pools["words"]])
    points = np.asarray([f"POINT ({x:.6f} {y:.6f})"
                         for x, y in zip(pools["lon"], pools["lat"])])
    return payloads, messages, points


def write_ev_segment(i: int, pools: dict, seg: dict) -> str:
    """Segment ``s<i>`` of ``EV_TABLE`` with the JSON, text, geo and FST
    indexes on ``payload``, ``message``, ``location`` and ``repo``, and
    each one's unindexed twin (``<col>_plain``), written by the port's
    creator (run in a worker process)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.common.table_config import IndexingConfig, \
        TableConfig
    from pinot_tpu_torch.storage.creator import build_segment

    payloads, messages, points = ev_strings(pools)
    cols = {"payload": payloads[seg["pay"]], "message": messages[seg["msg"]],
            "location": points[seg["loc"]], "repo": EV_REPOS[seg["repo"]],
            "etype": EV_TYPES[pools["type"][seg["pay"]]],
            "size": seg["size"]}
    for c in EV_COLS:
        cols[c + "_plain"] = cols[c]
    schema = Schema.build(
        name=EV_TABLE,
        dimensions=[("payload", DataType.JSON),
                    ("payload_plain", DataType.JSON)]
        + [(c + t, DataType.STRING) for c in EV_COLS[1:] for t in ("",
                                                                "_plain")]
        + [("etype", DataType.STRING)],
        metrics=[("size", DataType.INT)])
    out = os.path.join(DATA_DIR, EV_TABLE, f"s{i}")
    build_segment(schema, cols, out, TableConfig(
        table_name=EV_TABLE, indexing=IndexingConfig(
            json_index_columns=["payload"], text_index_columns=["message"],
            h3_index_columns=["location"], fst_index_columns=["repo"])),
        f"s{i}")
    return out


def haversine(lon, lat, lon0: float, lat0: float) -> np.ndarray:
    """Great-circle metres on the WGS84 mean sphere."""
    p1, p0 = np.radians(lat), np.radians(lat0)
    a = np.sin((p0 - p1) / 2) ** 2 + np.cos(p1) * np.cos(p0) \
        * np.sin((np.radians(lon0) - np.radians(lon)) / 2) ** 2
    return 2 * 6_371_008.8 * np.arcsin(np.sqrt(np.clip(a, 0, 1)))


def idx_oracle(ev: list) -> dict:
    """The index path's answers from the generator's fields (not a parse
    of the strings): the payload's repo and commit authors, the message's
    words, the place's coordinates (haversine), the repository name
    (Python's ``re``). Stats: the host path's for JSON_MATCH, TEXT_MATCH
    and ST_DISTANCE (an indexed segment scans nothing, or the grid's
    candidate docs, which ``idx_geo_stats`` fills in once the segments
    are written; the twin every row), the reference device's for
    REGEXP_LIKE (its dict column's every row, with the FST index or
    not)."""
    pools, segs = ev
    pay = np.concatenate([s["pay"] for s in segs])
    n = len(pay)
    seg = np.repeat(np.arange(len(segs)), [len(s["pay"]) for s in segs])
    size = np.concatenate([s["size"] for s in segs]).astype(np.int64)
    etype = pools["type"][pay]
    words = pools["words"]
    fix = np.asarray([0 in ws for ws in words])
    merge_pull = np.asarray([any(a == 1 and b == 2 for a, b in
                                 zip(ws[:-1], ws[1:])) for ws in words])
    repo_pat = re.compile(r"^apache/project-[0-9]*2$")
    repo_ok = np.fromiter((bool(repo_pat.search(r)) for r in EV_REPOS),
                          dtype=bool, count=len(EV_REPOS))
    near = haversine(pools["lon"], pools["lat"], *EV_POINT) < EV_RADIUS
    masks = {
        "json_nested": (pools["prepo"] == 0)[pay],
        "json_array": np.asarray([7 in cm for cm in pools["commits"]])[pay],
        "text_term": fix[np.concatenate([s["msg"] for s in segs])],
        "text_phrase": merge_pull[np.concatenate([s["msg"] for s in segs])],
        "geo_within": near[np.concatenate([s["loc"] for s in segs])],
        "regexp_repo": repo_ok[np.concatenate([s["repo"] for s in segs])],
    }
    want = {}
    for name, m in masks.items():
        k = int(m.sum())
        cnt = np.bincount(etype[m], minlength=len(EV_TYPES))
        ss = np.bincount(etype[m], weights=size[m], minlength=len(EV_TYPES))
        for twin in ("", "_plain"):
            if name == "regexp_repo":
                scanned = n     # the device shape: every row of the column
            elif twin:
                scanned = n     # no index: every doc scanned
            elif name == "geo_within":
                scanned = None  # idx_geo_stats
            else:
                scanned = 0     # the JSON or text index serves it
            stats = {"numEntriesScannedInFilter": scanned,
                     "numSegmentsMatched": int(len(np.unique(seg[m])))}
            want[f"{name}_count{twin}"] = (
                [[k]], k, dict(stats, numEntriesScannedPostFilter=0))
            want[f"{name}_sum{twin}"] = (
                [[str(EV_TYPES[t]), int(cnt[t]), float(ss[t])]
                 for t in range(len(EV_TYPES)) if cnt[t]], k,
                dict(stats, numEntriesScannedPostFilter=k))
    return want


def idx_geo_stats(want: dict, counts: list) -> None:
    """The geo-indexed queries' numEntriesScannedInFilter: the grid's
    candidate docs, summed over the segments (``geo_candidate_counts``)."""
    for q in ("geo_within_count", "geo_within_sum"):
        want[q][2]["numEntriesScannedInFilter"] = int(sum(counts))


def geo_candidate_counts(dirs: list) -> list:
    """Per segment, the docs the geo grid offers for ``geo_within``'s
    circle: what the host path scans (read from each segment's index
    file through the storage layer's reader)."""
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    out = []
    for d in dirs:
        s = ImmutableSegment(d)
        cand = np.asarray(s.geo_index("location").candidate_docs(
            EV_POINT[0], EV_POINT[1], float(EV_RADIUS)))
        out.append(int((cand < s.n_docs).sum()))
    return out


def check_mv_kernels(engine, k1: dict, k2: dict, k3: dict,
                     k5_sizes: list, chain_ns: float) -> None:
    """K1, K2, K3 and K5 at the mv path's own inputs, captured at their
    entries and held against their plain versions: mv_group_tags' group
    ids over one row per tag entry (K1's count), mv_codes_year's over
    lo_codes' entries (K1's count and sums, K2's MIN and MAX),
    mv_distinct_region's entry hashes (K3) and mv_pct_codes' sorted
    entries and cluster offsets (K5). Adds the shapes to the dicts."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import kernels

    for name, what in (("mv_group_tags", "one row per lo_tags entry"),
                       ("mv_codes_year", "lo_codes' entries")):
        for (gid, sources, G), kw in capture_calls(
                engine, MV_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            if name == "mv_codes_year" and not sources:
                continue    # the rows' own count: K1 at the table's shape
            k1["shapes"].append(k1_shape(
                f"{name}: {what}, G={G}, {planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for (gid, srcs, G), _kw in capture_calls(
            engine, MV_QUERIES["mv_codes_year"], ps, "group_minmax_sources"):
        k2["shapes"].append(k2_shape(
            "mv_codes_year: lo_codes' entries, "
            + ", ".join(f"{s.values.dtype} {'+'.join(s.ops)}"
                        for s in srcs).replace("torch.", ""), gid, srcs, G))
    k3["sizes"].append(k3_captured(
        engine, MV_QUERIES["mv_distinct_region"], "mv_distinct_region's "
        "lo_tags entry hashes", mm))
    (args, _kw), = capture_calls(engine, MV_QUERIES["mv_pct_codes"], kernels,
                                 "cluster_sums")
    k5_sizes.append(check_k5("mv_pct_codes (lo_codes' entries)", *args,
                             chain_ns))


# the mv path: K1 counts and sums (the device shape, the expanded rows,
# the entries), K2 the MIN / MAX over rows and entries, K3 the MV HLL's
# registers, K5 the MV t-digest; the index path: K1 under each filter
PATHS["mv"] = (MV_QUERIES, ("group_plane_sums", "group_minmax",
                            "hll_register_max", "cluster_sums"),
               ((3, "group_scatter", "plane_group_sums"),
                (4, "group_scatter", "group_minmax"),
                (2, "groupby_mm", "hll_registers")))
PATHS["index"] = (IDX_QUERIES, ("group_plane_sums",),
                  ((3, "group_scatter", "plane_group_sums"),))
QUERY_LAUNCHES.update({
    "mv_tag_year": {"group_plane_sums": 1},
    "mv_in_ne_max": {"group_plane_sums": 1, "group_minmax": 1},
    "mv_group_tags": {"group_plane_sums": 1},
    "mv_group_tags_year": {"group_plane_sums": 1},
    # the rows' count, then the entries' count and sums in one launch
    "mv_codes_year": {"group_plane_sums": 2, "group_minmax": 1},
    "mv_distinct_region": {"group_plane_sums": 2, "hll_register_max": 1},
    "mv_pct_codes": {"group_plane_sums": 2, "cluster_sums": 1},
    "mv_sel_codes": {"group_plane_sums": 0},
})
QUERY_LAUNCHES.update({name: {"group_plane_sums": int("_sum" in name)}
                       for name in IDX_QUERIES})


# ---------------------------------------------------------------------------
# the values path: schema evolution, IS NULL, literal-parameter functions
# over raw columns, the MV array functions
# ---------------------------------------------------------------------------

V2_TABLE = "lineorder_v2"
V2_SEED = 29
# SSB's LO_SHIPMODE values and LO_TAX range
SHIPMODES = np.array(["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP",
                      "TRUCK"])
V2_NULLS = 0.05
LONG_MIN = -(1 << 63)
DAY_MS = 86_400_000
TC_DAYS = "TIMECONVERT(lo_orderts, 'MILLISECONDS', 'DAYS')"
DTC_SDF = ("DATETIMECONVERT(lo_orderts, '1:MILLISECONDS:EPOCH', "
           "'1:DAYS:SIMPLE_DATE_FORMAT:yyyy-MM-dd', '1:DAYS')")
CAST_Q = "CAST(lo_quantity AS STRING)"
ALEN = "ARRAYLENGTH(lo_tags)"
VALUEIN = "VALUEIN(lo_tags, 'tag001', 'tag002', 'tag003')"
VAL_QUERIES = {
    # lineorder_v2: 8 segments that predate the three columns and s8
    "ev_shipmode": (f"SELECT lo_shipmode, COUNT(*), SUM(lo_revenue) FROM "
                    f"{V2_TABLE} GROUP BY lo_shipmode ORDER BY lo_shipmode"),
    "ev_tax_year": (f"SELECT d_year, SUM(lo_tax), MAX(lo_tax) FROM {V2_TABLE} "
                    "GROUP BY d_year ORDER BY d_year"),
    "ev_eq_default": (f"SELECT COUNT(*) FROM {V2_TABLE} WHERE lo_shipmode = "
                      "'null' AND lo_tax = 0"),
    "null_shipmode": (f"SELECT COUNT(*) FROM {V2_TABLE} WHERE lo_shipmode "
                      "IS NULL"),
    "notnull_tax_region": (
        f"SELECT c_region, COUNT(*), SUM(lo_tax) FROM {V2_TABLE} WHERE "
        "lo_tax IS NOT NULL GROUP BY c_region ORDER BY c_region"),
    "tc_days": (f"SELECT {TC_DAYS}, COUNT(*) FROM {V2_TABLE} GROUP BY "
                f"{TC_DAYS} ORDER BY COUNT(*) DESC, {TC_DAYS} LIMIT 10"),
    "dtc_sdf": (f"SELECT {DTC_SDF}, SUM(lo_revenue) FROM {V2_TABLE} GROUP BY "
                f"{DTC_SDF} ORDER BY {DTC_SDF} LIMIT 10"),
    "cast_quantity": (f"SELECT {CAST_Q}, COUNT(*) FROM lineorder GROUP BY "
                      f"{CAST_Q} ORDER BY {CAST_Q} LIMIT 100"),
    # lineorder_mv
    "mv_len_tags": (f"SELECT {ALEN}, COUNT(*) FROM {MV_TABLE} GROUP BY "
                    f"{ALEN} ORDER BY {ALEN}"),
    "mv_arr_codes_year": (
        "SELECT d_year, SUM(ARRAYSUM(lo_codes)), MIN(ARRAYMIN(lo_codes)), "
        "MAX(ARRAYMAX(lo_codes)), AVG(ARRAYAVERAGE(lo_codes)) FROM "
        f"{MV_TABLE} GROUP BY d_year ORDER BY d_year"),
    "mv_valuein": (f"SELECT {VALUEIN}, COUNT(*) FROM {MV_TABLE} GROUP BY "
                   f"{VALUEIN} ORDER BY {VALUEIN} LIMIT 20"),
    "mv_len_filter": (f"SELECT COUNT(*), SUM(lo_revenue) FROM {MV_TABLE} "
                      f"WHERE {ALEN} >= 6"),
}


def v2_schema():
    """``lineorder``'s schema with SSB's LO_SHIPMODE (a STRING dimension),
    LO_TAX (an INT metric) and an order timestamp in epoch millis (a LONG
    dimension) added after its first segments were sealed."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema

    return Schema.build(
        name=V2_TABLE,
        dimensions=[
            ("d_year", DataType.INT), ("c_region", DataType.STRING),
            ("s_nation", DataType.STRING), ("lo_suppkey", DataType.INT),
            ("lo_custkey", DataType.INT), ("lo_orderdate", DataType.INT),
            ("lo_discount", DataType.INT), ("lo_shipmode", DataType.STRING),
            ("lo_orderts", DataType.LONG)],
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT),
                 ("lo_tax", DataType.INT)])


def epoch_days(orderdate: np.ndarray) -> np.ndarray:
    """Days since 1970-01-01 of YYYYMMDD dates (1992-1998, day <= 28)."""
    ym = np.arange(1992 * 12, 1999 * 12)
    first = (np.array([f"{m // 12:04d}-{m % 12 + 1:02d}-01" for m in ym],
                      dtype="datetime64[D]").astype(np.int64))
    y, md = orderdate // 10000, orderdate % 10000
    return first[(y * 12 + md // 100 - 1) - 1992 * 12] + md % 100 - 1


def v2_generate(rows: int, seed: int = V2_SEED) -> dict:
    """The new segment s8 of ``V2_TABLE``: ``generate``'s columns from its
    own seed, and the three new ones, each about 5 % null: lo_shipmode
    (index into ``SHIPMODES``), lo_tax 0-8, lo_orderts (lo_orderdate's
    midnight in epoch millis plus a time of day); ``*_null`` the masks."""
    seg = generate(1, rows, seed)[0]
    rng = np.random.default_rng(seed + 1)
    seg["lo_shipmode"] = rng.integers(0, 7, rows).astype(np.int8)
    seg["lo_tax"] = rng.integers(0, 9, rows).astype(np.int32)
    seg["lo_orderts"] = epoch_days(seg["lo_orderdate"]) * DAY_MS \
        + rng.integers(0, DAY_MS, rows)
    for c in ("lo_shipmode", "lo_tax", "lo_orderts"):
        seg[c + "_null"] = rng.random(rows) < V2_NULLS
    return seg


def write_v2_segment(i: int, seg: dict) -> str:
    """Segment ``s<i>`` of ``V2_TABLE`` with the v2 schema, the defaults in
    the null rows ('null', 0, Long.MIN) and the null vectors given,
    lo_orderts raw, and bench.py's two star-tree cubes (run in a worker
    process)."""
    from pinot_tpu_torch.common.table_config import (
        IndexingConfig,
        StarTreeIndexConfig,
        TableConfig,
    )
    from pinot_tpu_torch.storage.creator import build_segment

    cols = {k: v for k, v in seg.items() if not k.endswith("_null")}
    cols["c_region"] = REGIONS[cols["c_region"]]
    cols["s_nation"] = NATIONS[cols["s_nation"]]
    ship = SHIPMODES[cols["lo_shipmode"]].astype("<U7")
    ship[seg["lo_shipmode_null"]] = "null"
    cols["lo_shipmode"] = ship
    cols["lo_tax"] = np.where(seg["lo_tax_null"], 0, cols["lo_tax"]) \
        .astype(np.int32)
    cols["lo_orderts"] = np.where(seg["lo_orderts_null"], LONG_MIN,
                                  cols["lo_orderts"]).astype(np.int64)
    out = os.path.join(DATA_DIR, V2_TABLE, f"s{i}")
    trees = [StarTreeIndexConfig(dimensions_split_order=d,
                                 function_column_pairs=p)
             for d, p in STAR_TREES]
    build_segment(v2_schema(), cols, out, TableConfig(
        table_name=V2_TABLE, indexing=IndexingConfig(
            star_tree_configs=trees, no_dictionary_columns=["lo_orderts"])),
        f"s{i}", null_masks={c: seg[c + "_null"] for c in
                             ("lo_shipmode", "lo_tax", "lo_orderts")})
    return out


def _close_checker(name: str, want: list, rel: float):
    """A rows check for a float column the card and numpy sum in other
    orders: integers and strings exactly, floats within ``rel``."""
    def check(got):
        if len(got) != len(want) or any(len(a) != len(b)
                                        for a, b in zip(got, want)):
            raise AssertionError(f"{name}: rows {got[:3]} want {want[:3]}")
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                if isinstance(y, (str, list)) and x != y or not isinstance(
                        y, (str, list)) and abs(float(x) - float(y)) > \
                        rel * max(1.0, abs(float(y))):
                    raise AssertionError(f"{name}: row {a} want {b}")
    return check


def val_oracle(data: list, v2: dict, mv: list) -> dict:
    """The values path's answers and the reference host path's stats: the
    old segments read lo_shipmode as 'null', lo_tax as 0 and lo_orderts as
    Long.MIN; IS NULL reads the null vectors (all of an old segment) and
    scans nothing; a predicate on a column an old segment predates scans
    every doc; entries after the filter per kept row and argument
    (COUNT(*) has none)."""
    old = {k: np.concatenate([d[k] for d in data]) for k in
           ("d_year", "c_region", "lo_revenue", "lo_quantity")}
    n_old, n8 = len(old["d_year"]), len(v2["d_year"])
    total = n_old + n8
    S = len(data) + 1
    rev_old = int(old["lo_revenue"].astype(np.int64).sum())
    rev8 = v2["lo_revenue"].astype(np.int64)
    ship_null, tax_null, ts_null = (v2[c + "_null"] for c in
                                    ("lo_shipmode", "lo_tax", "lo_orderts"))
    ship = np.where(ship_null, 7, v2["lo_shipmode"]).astype(np.int64)
    tax = np.where(tax_null, 0, v2["lo_tax"]).astype(np.int64)
    want = {}
    base = {"numSegmentsProcessed": S, "numSegmentsPrunedByServer": 0}

    # 'null' sorts after the upper-case modes
    cnt = np.bincount(ship, minlength=8)
    rs = np.bincount(ship, weights=rev8, minlength=8)
    names = list(SHIPMODES) + ["null"]
    cnt[7] += n_old
    rows = [[names[k], int(cnt[k]), float(rs[k] + (rev_old if k == 7 else 0))]
            for k in range(8) if cnt[k]]
    want["ev_shipmode"] = (rows, total, dict(
        base, numEntriesScannedInFilter=0,
        numEntriesScannedPostFilter=total))

    y8 = (v2["d_year"] - 1992).astype(np.int64)
    ts = np.bincount(y8, weights=tax, minlength=7)
    tmax = [int(tax[y8 == y].max()) if np.any(y8 == y) else 0
            for y in range(7)]
    years = np.union1d(np.unique(old["d_year"]), np.unique(v2["d_year"]))
    want["ev_tax_year"] = (
        [[int(y), float(ts[y - 1992]), float(max(tmax[y - 1992], 0))]
         for y in years], total, dict(
            base, numEntriesScannedInFilter=0,
            numEntriesScannedPostFilter=2 * total))

    m8 = ship_null & (tax == 0)
    hits = n_old + int(m8.sum())
    want["ev_eq_default"] = ([[hits]], hits, dict(
        base, numEntriesScannedInFilter=2 * total,
        numEntriesScannedPostFilter=0, numSegmentsMatched=S))

    hits = n_old + int(ship_null.sum())
    want["null_shipmode"] = ([[hits]], hits, dict(
        base, numEntriesScannedInFilter=0,
        numEntriesScannedPostFilter=0, numSegmentsMatched=S))

    keep = ~tax_null
    r8 = v2["c_region"].astype(np.int64)
    cnt = np.bincount(r8[keep], minlength=5)
    tsum = np.bincount(r8[keep], weights=tax[keep], minlength=5)
    want["notnull_tax_region"] = (
        [[str(REGIONS[r]), int(cnt[r]), float(tsum[r])] for r in range(5)
         if cnt[r]], int(keep.sum()), dict(
            base, numEntriesScannedInFilter=0,
            numEntriesScannedPostFilter=int(keep.sum()),
            numSegmentsMatched=1))

    # Long.MIN ms -> DAYS as sign(v) * (|v| // d), |Long.MIN| wrapping
    day = np.where(ts_null, -1, v2["lo_orderts"] // DAY_MS)
    days, dcnt = np.unique(day[~ts_null], return_counts=True)
    groups = [(106751991168, n_old + int(ts_null.sum()))] + list(
        zip(days.tolist(), dcnt.tolist()))
    top = sorted(groups, key=lambda kv: (-kv[1], kv[0]))[:10]
    want["tc_days"] = ([[int(k), int(c)] for k, c in top], total, dict(
        base, numEntriesScannedInFilter=0, numEntriesScannedPostFilter=0))

    # the same Long.MIN, bucketed, formats as '-292275055-05-17'
    drev = np.bincount(np.searchsorted(days, day[~ts_null]),
                       weights=rev8[~ts_null], minlength=len(days))
    dates = (days.astype("datetime64[D]")).astype(str)
    first = [["-292275055-05-17",
              float(rev_old + int(rev8[ts_null].sum()))]]
    want["dtc_sdf"] = (first + [[str(d), float(r)] for d, r in
                                zip(dates[:9], drev[:9])], total, dict(
        base, numEntriesScannedInFilter=0,
        numEntriesScannedPostFilter=total))

    # string order: '1' < '10' < ... < '19' < '2' < '20'
    q = old["lo_quantity"]
    qc = np.bincount(q, minlength=51)
    keys = sorted(str(v) for v in range(51) if qc[v])
    want["cast_quantity"] = ([[k, int(qc[int(k)])] for k in keys], n_old,
                             dict(numEntriesScannedInFilter=0,
                                  numEntriesScannedPostFilter=0,
                                  numSegmentsProcessed=len(data),
                                  totalDocs=n_old))
    want.update(val_mv_oracle(data, mv))
    return want


def val_mv_oracle(data: list, mv: list) -> dict:
    """The values path's answers over ``lineorder_mv``: ARRAYLENGTH of
    lo_tags (0-8 entries, so some docs are empty), the per-doc
    reductions of lo_codes (1-24 entries: never empty, so ARRAYSUM stays
    an integer) and VALUEIN's per-doc lists of three tags in first-seen
    order."""
    data = data[:MV_SEGMENTS]
    n = sum(len(d["d_year"]) for d in data)
    S = len(data)
    year = np.concatenate([d["d_year"] for d in data]).astype(np.int64) \
        - 1992
    rev = np.concatenate([d["lo_revenue"] for d in data]).astype(np.int64)
    tlen = np.concatenate([np.diff(m["lo_tags"][1]) for m in mv])
    clen = np.concatenate([np.diff(m["lo_codes"][1]) for m in mv])
    codes = np.concatenate([m["lo_codes"][0] for m in mv]).astype(np.int64)
    tags = np.concatenate([m["lo_tags"][0] for m in mv]).astype(np.int64)
    base = {"numSegmentsProcessed": S, "numSegmentsPrunedByServer": 0,
            "totalDocs": n}
    want = {}
    lc = np.bincount(tlen, minlength=9)
    want["mv_len_tags"] = ([[k, int(lc[k])] for k in range(9) if lc[k]], n,
                           dict(base, numEntriesScannedInFilter=0,
                                numEntriesScannedPostFilter=0))

    start = np.concatenate([[0], np.cumsum(clen)[:-1]])
    dsum = np.add.reduceat(codes, start)
    dmin = np.minimum.reduceat(codes, start)
    dmax = np.maximum.reduceat(codes, start)
    davg = dsum / clen
    rows = []
    for y in range(7):
        m = year == y
        if m.any():
            rows.append([1992 + y, float(dsum[m].sum()), float(dmin[m].min()),
                         float(dmax[m].max()), float(davg[m].mean())])
    want["mv_arr_codes_year"] = (
        _close_checker("mv_arr_codes_year", rows, 1e-9), n,
        dict(base, numEntriesScannedInFilter=0,
             numEntriesScannedPostFilter=4 * n))

    # each doc's first position of tag001..tag003 (the ids 1..3)
    tdoc = np.repeat(np.arange(n), tlen)
    tstart = np.concatenate([[0], np.cumsum(tlen)[:-1]])
    rank = np.arange(len(tags)) - tstart[tdoc]
    first = np.full((n, 3), 99, dtype=np.int64)
    for j in range(3):
        hit = tags == j + 1
        np.minimum.at(first[:, j], tdoc[hit], rank[hit])
    order = np.argsort(first, axis=1, kind="stable")
    present = np.take_along_axis(first, order, axis=1) < 99
    # the list as base-4 digits (tag00k -> k), first entry first
    code = np.zeros(n, dtype=np.int64)
    for i in range(3):
        code += np.where(present[:, i], order[:, i] + 1, 0) * 4 ** (2 - i)
    ucode, ucnt = np.unique(code, return_counts=True)

    def as_list(c):
        out = []
        for i in range(3):
            d = c // 4 ** (2 - i) % 4
            if d == 0:
                break
            out.append(f"tag{d:03d}")
        return out
    want["mv_valuein"] = ([[as_list(c), int(k)] for c, k in
                           zip(ucode.tolist(), ucnt.tolist())], n,
                          dict(base, numEntriesScannedInFilter=0,
                               numEntriesScannedPostFilter=0))

    m = tlen >= 6
    want["mv_len_filter"] = ([[int(m.sum()), float(rev[m].sum())]],
                             int(m.sum()),
                             dict(base, numEntriesScannedInFilter=n,
                                  numEntriesScannedPostFilter=int(m.sum())))
    return want


def check_values_kernels(engine, k1: dict, k2: dict) -> None:
    """K1 and K2 at the values path's own inputs, captured at their entries
    and held against their plain versions: the group ids over an evolved
    key (ev_shipmode: 100M rows on the 'null' default, s8's nulls with
    them), over d_year with an evolved metric (ev_tax_year's SUM and MAX
    of lo_tax), and over an ARRAYLENGTH and a VALUEIN key and by d_year
    over lo_codes' per-doc reductions on lineorder_mv."""
    from pinot_tpu_torch.ops import group_scatter as ps

    for name, what in (("ev_shipmode", "evolved key lo_shipmode"),
                       ("ev_tax_year", "d_year, evolved metric lo_tax"),
                       ("mv_len_tags", "ARRAYLENGTH(lo_tags) key"),
                       ("mv_valuein", "VALUEIN(lo_tags, ...) list key"),
                       ("mv_arr_codes_year", "d_year, lo_codes' reductions")):
        for (gid, sources, G), kw in capture_calls(
                engine, VAL_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: {what}, G={G}, {planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for name in ("ev_tax_year", "mv_arr_codes_year"):
        for (gid, srcs, G), _kw in capture_calls(
                engine, VAL_QUERIES[name], ps, "group_minmax_sources"):
            k2["shapes"].append(k2_shape(
                f"{name}: " + ", ".join(
                    f"{s.values.dtype} {'+'.join(s.ops)}"
                    for s in srcs).replace("torch.", ""), gid, srcs, G))


PATHS["values"] = (VAL_QUERIES, ("group_plane_sums", "group_minmax"),
                   ((3, "group_scatter", "plane_group_sums"),
                    (4, "group_scatter", "group_minmax")))
# a group-by's count and sums in one K1 launch, its MIN and MAX in one K2;
# the scalar COUNT(*)s count their mask on the card
QUERY_LAUNCHES.update({
    name: {"group_plane_sums": int("GROUP BY" in sql),
           "group_minmax": int("MAX(" in sql)}
    for name, sql in VAL_QUERIES.items()})


# ---------------------------------------------------------------------------
# the tail path: the function and aggregation tail, exact SUMPRECISION
# over fractions, compressed raw forward indexes and the sub-byte tier,
# over the NYC TLC yellow-taxi trip record's columns
# ---------------------------------------------------------------------------

TRIPS_TABLE = "trips"
TRIPS_SEGMENTS = 2
TRIPS_SEED = 31
MONTH_MS = 1_577_836_800_000   # 2020-01-01T00:00:00Z
TRIP_DAYS = 31
# the five boroughs' box, and a Manhattan polygon inside it
BOROUGHS = ((-74.26, -73.70), (40.49, 40.92))
MANHATTAN = ("POLYGON ((-74.0200 40.7000, -73.9700 40.7100, -73.9280 40.7950, "
             "-73.9100 40.8720, -73.9350 40.8820, -74.0120 40.7580, "
             "-74.0200 40.7000))")
# the grid's resolution 14 has H3 resolution 7's cell area (~5 km^2)
GEO_RES = 14
HOUR = (MONTH_MS + 14 * DAY_MS + 10 * 3_600_000,
        MONTH_MS + 14 * DAY_MS + 11 * 3_600_000 - 1)
STUNION_WINDOW = (MONTH_MS + 20 * DAY_MS, MONTH_MS + 20 * DAY_MS + 20_000)
FUSED_DAY = "20200115"
TRIP_RAW = ("pickup_ts", "fare_amount", "tip_amount", "pickup_longitude",
            "pickup_latitude", "trip_distance")
GEO_KEY = f"GEOTOH3(pickup_longitude, pickup_latitude, {GEO_RES})"
ROUND_KEY = "ROUNDDECIMAL(fare_amount, 0)"
CASE_KEY = ("CASE WHEN passenger_count > 4 THEN 'group' ELSE passenger_count "
            "END")
POINT = "ST_POINT(pickup_longitude, pickup_latitude)"
TAIL_QUERIES = {
    "tail_sumprec_pay": (
        f"SELECT payment_type, SUMPRECISION(fare_amount) FROM {TRIPS_TABLE} "
        "GROUP BY payment_type ORDER BY payment_type"),
    "tail_sumprec_expr": (f"SELECT SUMPRECISION(fare_amount + tip_amount) "
                          f"FROM {TRIPS_TABLE}"),
    "tail_geo_cell": (
        f"SELECT {GEO_KEY}, COUNT(*), SUM(fare_amount) FROM {TRIPS_TABLE} "
        f"GROUP BY {GEO_KEY} ORDER BY COUNT(*) DESC, {GEO_KEY} LIMIT 10"),
    "tail_st_contains": (
        f"SELECT payment_type, COUNT(*) FROM {TRIPS_TABLE} WHERE ST_CONTAINS("
        f"ST_GEOGFROMTEXT('{MANHATTAN}'), {POINT}) = 1 GROUP BY payment_type "
        "ORDER BY payment_type"),
    "tail_stunion": (
        f"SELECT STUNION({POINT}) FROM {TRIPS_TABLE} WHERE pickup_ts "
        f"BETWEEN {STUNION_WINDOW[0]} AND {STUNION_WINDOW[1]}"),
    "tail_round_fare": (
        f"SELECT {ROUND_KEY}, COUNT(*) FROM {TRIPS_TABLE} GROUP BY "
        f"{ROUND_KEY} ORDER BY {ROUND_KEY} LIMIT 20"),
    "tail_case_mixed": (
        f"SELECT {CASE_KEY}, COUNT(*) FROM {TRIPS_TABLE} GROUP BY {CASE_KEY} "
        f"ORDER BY {CASE_KEY}"),
    "tail_like_num": (f"SELECT COUNT(*) FROM {TRIPS_TABLE} WHERE "
                      "passenger_count LIKE '1%'"),
    "tail_hll_minutes": (
        f"SELECT payment_type, DISTINCTCOUNTHLL(pickup_ts / 60000) FROM "
        f"{TRIPS_TABLE} GROUP BY payment_type ORDER BY payment_type"),
    "tail_last_day": (
        f"SELECT vendor_id, LASTWITHTIME(fare_amount, pickup_day, 'DOUBLE') "
        f"FROM {TRIPS_TABLE} GROUP BY vendor_id ORDER BY vendor_id"),
    "tail_decoded": (
        "SELECT passenger_count, COUNT(*), SUM(fare_amount), MIN(tip_amount), "
        f"MAX(trip_distance) FROM {TRIPS_TABLE} GROUP BY passenger_count "
        "ORDER BY passenger_count"),
    "tail_ts_range": (f"SELECT COUNT(*), SUM(fare_amount) FROM {TRIPS_TABLE} "
                      f"WHERE pickup_ts BETWEEN {HOUR[0]} AND {HOUR[1]}"),
    # K4's surface: an integer SUM (a float sum's order would show), a
    # float MAX, over a sorted dict column's blocks
    "tail_day_fused": (f"SELECT COUNT(*), SUM(passenger_count), "
                       f"MAX(tip_amount) FROM {TRIPS_TABLE} WHERE "
                       f"pickup_day = '{FUSED_DAY}'"),
}
# answered again by the sub-byte load (PINOT_TPU_SUBBYTE=1)
SUBBYTE_TWINS = ("tail_decoded", "tail_like_num", "tail_case_mixed")


def trips_generate(segments: int, rows: int, seed: int = TRIPS_SEED) -> list:
    """The trip records of January 2020, ``rows`` a segment, each segment
    sorted by pickup time as time-ordered ingestion writes it: fares in
    50-cent steps from $2.50, tips in whole cents (none for 40 %),
    pickups over the five boroughs' box at six decimals, distances at two,
    and the dict dimensions (``pickup_day`` the index of the day)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(segments):
        n = rows
        ts = np.sort(MONTH_MS + rng.integers(0, TRIP_DAYS * DAY_MS, n))
        tip = rng.integers(0, 2000, n)
        tip[rng.random(n) < 0.4] = 0
        out.append({
            "pickup_ts": ts.astype(np.int64),
            "pickup_day": ((ts - MONTH_MS) // DAY_MS).astype(np.int8),
            "vendor_id": rng.integers(1, 3, n).astype(np.int32),
            "store_and_fwd_flag": (rng.random(n) < 0.01).astype(np.int8),
            "payment_type": rng.choice(np.arange(1, 5, dtype=np.int32), n,
                                       p=[0.62, 0.34, 0.025, 0.015]),
            "passenger_count": rng.choice(np.arange(1, 7, dtype=np.int32), n,
                                          p=[0.7, 0.14, 0.05, 0.03, 0.05,
                                             0.03]),
            "fare_amount": 2.5 + 0.5 * rng.integers(0, 200, n),
            "tip_amount": tip / 100.0,
            "pickup_longitude": np.round(rng.uniform(*BOROUGHS[0], n), 6),
            "pickup_latitude": np.round(rng.uniform(*BOROUGHS[1], n), 6),
            "trip_distance": np.round(rng.gamma(2.0, 1.5, n), 2),
        })
    return out


def trips_schema():
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema

    D = DataType
    return Schema.build(
        name=TRIPS_TABLE,
        dimensions=[("vendor_id", D.INT), ("store_and_fwd_flag", D.STRING),
                    ("payment_type", D.INT), ("passenger_count", D.INT),
                    ("pickup_day", D.STRING), ("pickup_ts", D.LONG),
                    ("pickup_longitude", D.DOUBLE),
                    ("pickup_latitude", D.DOUBLE)],
        metrics=[("fare_amount", D.DOUBLE), ("tip_amount", D.DOUBLE),
                 ("trip_distance", D.DOUBLE)])


def trip_codecs(available: dict) -> dict:
    """The raw columns' codecs: zlib for the time and the fare, zstd for
    the tip where the build has zstd, lz4 for the pickup coordinates; the
    distance stays uncompressed."""
    out = {"pickup_ts": "zlib", "fare_amount": "zlib",
           "pickup_longitude": "lz4", "pickup_latitude": "lz4"}
    if available.get("zstd"):
        out["tip_amount"] = "zstd"
    return out


def write_trips_segment(i: int, seg: dict, codecs: dict) -> str:
    """Segment ``s<i>`` of ``TRIPS_TABLE`` through the port's creator, its
    raw columns compressed per ``codecs`` (run in a worker process)."""
    from pinot_tpu_torch.common.table_config import IndexingConfig, \
        TableConfig
    from pinot_tpu_torch.storage.creator import build_segment

    days = np.array([f"202001{d + 1:02d}" for d in range(TRIP_DAYS)])
    cols = dict(seg)
    cols["pickup_day"] = days[seg["pickup_day"]]
    cols["store_and_fwd_flag"] = np.array(["N", "Y"])[
        seg["store_and_fwd_flag"]]
    out = os.path.join(DATA_DIR, TRIPS_TABLE, f"s{i}")
    build_segment(trips_schema(), cols, out, TableConfig(
        table_name=TRIPS_TABLE, indexing=IndexingConfig(
            no_dictionary_columns=list(TRIP_RAW),
            compression_codec=dict(codecs))), f"s{i}")
    return out


def grid_cells(lon: np.ndarray, lat: np.ndarray, res: int) -> np.ndarray:
    """GEOTOH3's grid cell ids (the reference's ops/geo.py formula, in
    numpy): floor(lat / 360 * 2^res) and floor(lon / 360 * 2^res) packed
    under the resolution."""
    deg = 360.0 / (1 << res)
    ci = np.floor(lat / deg).astype(np.int64)
    cj = np.floor(lon / deg).astype(np.int64)
    return (np.int64(res) << 54) | ((ci & 0x3FFFFFF) << 27) | (cj & 0x7FFFFFF)


def in_ring(ring: list, lon: np.ndarray, lat: np.ndarray) -> np.ndarray:
    """The even-odd ray cast ST_CONTAINS answers with, in float64."""
    inside = np.zeros(len(lon), dtype=bool)
    x0, y0 = ring[-1]
    for x1, y1 in ring:
        crosses = (y1 > lat) != (y0 > lat)
        with np.errstate(divide="ignore", invalid="ignore"):
            xint = (x0 - x1) * (lat - y1) / (y0 - y1) + x1
        inside ^= crosses & (lon < xint)
        x0, y0 = x1, y1
    return inside


def _ring(wkt: str) -> list:
    body = wkt[wkt.index("((") + 2: wkt.index("))")]
    return [tuple(float(v) for v in p.split()) for p in body.split(",")]


def _exact_sum(values: np.ndarray, counts: np.ndarray):
    """SUMPRECISION's sum of ``values`` each ``counts`` times: an int
    where every value is integral, else the exact Decimal of their reprs
    (its exponent the least of theirs)."""
    import decimal

    with decimal.localcontext() as ctx:
        ctx.prec = 200
        tot = 0
        for v, k in zip(values.tolist(), counts.tolist()):
            tot += int(v) * k if float(v).is_integer() \
                else decimal.Decimal(repr(v)) * k
    return tot


def _block_stats(cols: list, sizes: list, lo_hi, pad_to: int,
                 n_cols: int = 1) -> dict:
    """The block-skip stats of one interval over sorted values: blocks of
    4096 rows whose [min, max] meets [lo, hi] are candidates, none pruned
    past the bound (1/16 of the batch's blocks)."""
    R, frac = 4096, 16
    starts = [np.arange(0, n, R) for n in sizes]
    blo = np.concatenate([np.minimum.reduceat(c, st)
                          for c, st in zip(cols, starts)])
    bhi = np.concatenate([np.maximum.reduceat(c, st)
                          for c, st in zip(cols, starts)])
    rows = np.concatenate([np.minimum(R, n - st)
                           for n, st in zip(sizes, starts)])
    cand = (bhi >= lo_hi[0]) & (blo <= lo_hi[1])
    total = len(cols) * (pad_to // R)
    bound = min(total, max(1, -(-total // frac)))
    if cand.sum() > bound:
        scanned, n = len(rows), int(rows.sum())
    else:
        scanned, n = int(cand.sum()), int(rows[cand].sum())
    return {"numSegmentsPrunedByServer": 0, "numBlocksPruned":
            len(rows) - scanned, "numEntriesScannedInFilter": n * n_cols}


def tail_oracle(trips: list, pad_to: int) -> dict:
    """The tail path's answers from the generated columns, with the stats
    of the reference's host path where it answers (every doc scanned by a
    predicate it evaluates over values, entries after the filter per
    kept row and argument) and of its device's block skip."""
    c = {k: np.concatenate([d[k] for d in trips]) for k in trips[0]}
    sizes = [len(d["pickup_ts"]) for d in trips]
    total = sum(sizes)
    S = len(trips)
    pay = c["payment_type"].astype(np.int64)
    pc = c["passenger_count"].astype(np.int64)
    fare, tip = c["fare_amount"], c["tip_amount"]
    fare_k = np.rint((fare - 2.5) * 2).astype(np.int64)   # 50-cent steps
    host = {"numSegmentsProcessed": S, "numSegmentsPrunedByServer": 0,
            "numEntriesScannedInFilter": 0}
    want = {}

    rows = []
    for p in range(1, 5):
        k = np.bincount(fare_k[pay == p], minlength=200)
        keep = k > 0
        rows.append([p, str(_exact_sum(2.5 + 0.5 * np.flatnonzero(keep),
                                       k[keep]))])
    want["tail_sumprec_pay"] = (rows, total, dict(
        host, numEntriesScannedPostFilter=total))

    both = fare + tip
    u, k = np.unique(both, return_counts=True)
    want["tail_sumprec_expr"] = ([[str(_exact_sum(u, k))]], total, dict(
        host, numEntriesScannedPostFilter=total))

    lon, lat = c["pickup_longitude"], c["pickup_latitude"]
    cells = grid_cells(lon, lat, GEO_RES)
    u, inv, cnt = np.unique(cells, return_inverse=True, return_counts=True)
    fs = np.bincount(inv, weights=fare)
    top = sorted(range(len(u)), key=lambda j: (-cnt[j], u[j]))[:10]
    want["tail_geo_cell"] = (
        _close_checker("tail_geo_cell", [[int(u[j]), int(cnt[j]),
                                          float(fs[j])] for j in top], 1e-9),
        total, dict(host, numEntriesScannedPostFilter=total))

    m = in_ring(_ring(MANHATTAN), lon, lat)
    cnt = np.bincount(pay[m], minlength=5)
    want["tail_st_contains"] = (
        [[p, int(cnt[p])] for p in range(1, 5) if cnt[p]], int(m.sum()),
        dict(host, numEntriesScannedInFilter=total,
             numEntriesScannedPostFilter=0))

    ts = c["pickup_ts"]
    m = (ts >= STUNION_WINDOW[0]) & (ts <= STUNION_WINDOW[1])
    pts = sorted({f"POINT ({x:.10g} {y:.10g})"
                  for x, y in zip(lon[m].tolist(), lat[m].tolist())})
    body = ", ".join(p[len("POINT ("):-1] for p in pts)
    want["tail_stunion"] = ([[f"MULTIPOINT ({body})"]], int(m.sum()), dict(
        host, numEntriesScannedInFilter=total,
        numEntriesScannedPostFilter=int(m.sum())))

    r = np.sign(fare) * np.floor(np.abs(fare) * 1.0 + 0.5) / 1.0
    u, cnt = np.unique(r, return_counts=True)
    want["tail_round_fare"] = ([[float(a), int(b)] for a, b in
                                zip(u[:20], cnt[:20])], total,
                               dict(host, numEntriesScannedPostFilter=0))

    cnt = np.bincount(pc, minlength=7)
    rows = [[str(p), int(cnt[p])] for p in range(1, 5) if cnt[p]] \
        + [["group", int(cnt[5] + cnt[6])]]
    want["tail_case_mixed"] = (rows, total, dict(
        host, numEntriesScannedPostFilter=0))

    # the reference's device answers a dict column's LIKE
    hits = int((pc == 1).sum())
    want["tail_like_num"] = ([[hits]], hits)

    minute = (ts / 60000).view(np.uint64)
    h = fmix32(((minute >> np.uint64(32)) ^ (minute & np.uint64(0xFFFFFFFF)))
               .astype(np.uint32).view(np.int32))
    idx, rho = hll_idx_rho(h, LOG2M)
    est = hll_estimates(idx, rho, pay, 5, LOG2M)
    want["tail_hll_minutes"] = (
        [[p, int(est[p])] for p in range(1, 5)], total,
        dict(host, numEntriesScannedPostFilter=total))

    day = c["pickup_day"].astype(np.int64)
    vendor = c["vendor_id"].astype(np.int64)
    rows = []
    for v in (1, 2):
        mv = vendor == v
        last = day[mv].max()
        rows.append([v, float(fare[mv & (day == last)].max())])
    want["tail_last_day"] = (rows, total, dict(
        host, numEntriesScannedPostFilter=2 * total))

    f32 = fare.astype(np.float32).astype(np.float64)
    rows = []
    for p in range(1, 7):
        mp = pc == p
        rows.append([p, int(mp.sum()), float(f32[mp].sum()),
                     float(np.float32(tip[mp].min())),
                     float(np.float32(c["trip_distance"][mp].max()))])
    want["tail_decoded"] = (_close_checker("tail_decoded", rows, 1e-9),
                            total)

    m = (ts >= HOUR[0]) & (ts <= HOUR[1])
    want["tail_ts_range"] = (
        _close_checker("tail_ts_range", [[int(m.sum()),
                                          float(f32[m].sum())]], 1e-9),
        int(m.sum()), _block_stats([d["pickup_ts"] for d in trips], sizes,
                                   HOUR, pad_to))

    target = int(FUSED_DAY[-2:]) - 1
    m = day == target
    want["tail_day_fused"] = (
        [[int(m.sum()), float(pc[m].sum()), float(np.float32(tip[m].max()))]],
        int(m.sum()), _block_stats([d["pickup_day"].astype(np.int64)
                                    for d in trips], sizes,
                                   (target, target), pad_to))
    return want


def check_tail_kernels(engine, sub_engine, k1: dict, k2: dict, k3: dict,
                       k4: dict) -> None:
    """K1, K2, K3 and K4 at the tail path's own inputs, captured at their
    entries and held against their plain versions: SUMPRECISION's scaled
    integers and their magnitudes at the batch's least exponent (K1) and
    its exponent plane (K2), the GEOTOH3 group ids (K1), the hashes of
    ``pickup_ts / 60000`` (K3), the sub-byte load's unpacked ids under
    tail_decoded (K1, K2) and tail_day_fused's candidates (K4)."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm

    for eng, name, what in (
            (engine, "tail_sumprec_pay", "SUMPRECISION's scaled integers"),
            (engine, "tail_geo_cell", "GEOTOH3 ids"),
            (sub_engine, "tail_decoded", "the sub-byte load's ids")):
        for (gid, sources, G), kw in capture_calls(
                eng, TAIL_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: {what}, G={G}, {planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for eng, name in ((engine, "tail_sumprec_pay"),
                      (sub_engine, "tail_decoded")):
        for (gid, srcs, G), _kw in capture_calls(
                eng, TAIL_QUERIES[name], ps, "group_minmax_sources"):
            k2["shapes"].append(k2_shape(
                f"{name}: " + ", ".join(
                    f"{s.values.dtype} {'+'.join(s.ops)}"
                    for s in srcs).replace("torch.", ""), gid, srcs, G))
    k3["sizes"].append(k3_captured(engine, TAIL_QUERIES["tail_hll_minutes"],
                                   "tail_hll_minutes' expression hashes",
                                   mm))
    k4["sizes"].append(check_k4("the tail path's tail_day_fused",
                                *capture_fused(
                                    engine, TAIL_QUERIES["tail_day_fused"])))


def subbyte_twins(dirs: list, want: dict, total: int, engine_cls) -> tuple:
    """``trips`` loaded twice more, wide and under ``PINOT_TPU_SUBBYTE=1``
    (read when the batch is built): ``SUBBYTE_TWINS`` answer the same rows
    and stats on both, as the oracle says, and the sub-byte load holds
    fewer bytes. Returns (sub-byte engine, its resident bytes, the wide
    load's)."""
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    loads = []
    for flag in ("", "1"):
        eng = engine_cls(device="cuda")
        # check_tail_kernels captures the sub-byte engine's kernel inputs
        # from queries run here: no repeat may be a partials-cache hit or
        # take an advised form
        eng.device.partials_cache_enabled = False
        eng.device.advisor = None
        segs = [ImmutableSegment(d) for d in dirs]
        for s in segs:
            eng.add_segment(TRIPS_TABLE, s)
        os.environ["PINOT_TPU_SUBBYTE"] = flag
        try:
            ctx = eng.device.batch_for(segs)
        finally:
            os.environ.pop("PINOT_TPU_SUBBYTE", None)
        loads.append((eng, ctx))
    (wide, wctx), (sub, sctx) = loads
    bits = {c: sctx.width_plan(c).bits for c in
            ("vendor_id", "store_and_fwd_flag", "payment_type",
             "passenger_count", "pickup_day")}
    for name in SUBBYTE_TWINS:
        a, b = wide.execute(TAIL_QUERIES[name]), sub.execute(
            TAIL_QUERIES[name])
        if a["exceptions"] or b["exceptions"]:
            raise AssertionError(f"{name}: {a['exceptions']} "
                                 f"{b['exceptions']}")
        for key in ("resultTable", "numDocsScanned", "totalDocs",
                    "numEntriesScannedInFilter",
                    "numEntriesScannedPostFilter"):
            if a[key] != b[key]:
                raise AssertionError(f"{name}: the sub-byte load's {key} "
                                     f"{b[key]} differs from {a[key]}")
        rows_want = want[name][0]
        got = b["resultTable"]["rows"]
        if callable(rows_want):
            rows_want(got)
        elif not rows_equal(got, rows_want):
            raise AssertionError(f"{name}: sub-byte rows {got} want "
                                 f"{rows_want}")
    if not sctx.resident_bytes < wctx.resident_bytes:
        raise AssertionError(f"the sub-byte load holds {sctx.resident_bytes}"
                             f" bytes, the wide load {wctx.resident_bytes}")
    log(f"{TRIPS_TABLE} sub-byte load (PINOT_TPU_SUBBYTE=1; bits {bits}): "
        f"{', '.join(SUBBYTE_TWINS)} equal the wide load's rows and stats; "
        f"resident bytes {sctx.resident_bytes} sub-byte, "
        f"{wctx.resident_bytes} wide ({total} rows; narrow_saved_bytes "
        f"{sctx.narrow_saved_bytes} and {wctx.narrow_saved_bytes})")
    return sub, sctx.resident_bytes, wctx.resident_bytes


PATHS["tail"] = (TAIL_QUERIES, ("group_plane_sums", "group_minmax",
                                "hll_register_max", "fused_filter_agg"),
                 ((3, "group_scatter", "plane_group_sums"),
                  (4, "group_scatter", "group_minmax"),
                  (2, "groupby_mm", "hll_registers"),
                  (6, "group_scatter", "fused_filter_agg")))
# SUMPRECISION over fractions: K1 over the scaled integers and their
# magnitudes (one 62-bit limb each here) and K2 over the exponents, and a
# group-by's count in one more K1 launch; every host-shaped group-by's
# pipeline one K1 launch; the expression's registers one K3 launch; the
# scalar queries with a filter on a dict column or a block-skip range
# count on the card without a kernel (a float SUM stays off K4), but
# tail_day_fused, in K4's surface
_TAIL_K1 = {"tail_sumprec_pay": 3, "tail_sumprec_expr": 2,
            "tail_geo_cell": 1, "tail_st_contains": 1, "tail_round_fare": 1,
            "tail_case_mixed": 1, "tail_hll_minutes": 1, "tail_last_day": 1,
            "tail_decoded": 1}
QUERY_LAUNCHES.update({
    name: {"group_plane_sums": _TAIL_K1.get(name, 0),
           "group_minmax": int(name in ("tail_sumprec_pay",
                                        "tail_sumprec_expr",
                                        "tail_decoded")),
           "hll_register_max": int(name == "tail_hll_minutes"),
           "fused_filter_agg": int(name == "tail_day_fused")}
    for name in TAIL_QUERIES})


def _rows_mask(tree, c) -> np.ndarray:
    kind = tree[0]
    if kind == "range":
        v = c[tree[1]]
        return (v >= tree[2]) & (v <= tree[3])
    if kind == "in":
        return np.isin(c[tree[1]], tree[2])
    if kind == "not":
        return ~_rows_mask(tree[1], c)
    ms = [_rows_mask(t, c) for t in tree[1:]]
    return np.logical_and.reduce(ms) if kind == "and" \
        else np.logical_or.reduce(ms)


def _may_match(tree, lo: dict, hi: dict) -> np.ndarray:
    """May an interval [lo, hi] per column hold a matching row: AND all,
    OR any, NOT always (the segment pruner's and the zone verdict's
    algebra)."""
    kind = tree[0]
    if kind == "range":
        return (hi[tree[1]] >= tree[2]) & (lo[tree[1]] <= tree[3])
    if kind == "in":
        return np.logical_or.reduce([(lo[tree[1]] <= v) & (hi[tree[1]] >= v)
                                     for v in tree[2]])
    if kind == "not":
        return np.ones(next(iter(lo.values())).shape, dtype=bool)
    ms = [_may_match(t, lo, hi) for t in tree[1:]]
    return np.logical_and.reduce(ms) if kind == "and" \
        else np.logical_or.reduce(ms)


def _tree_columns(tree) -> set:
    if tree[0] in ("range", "in"):
        return {tree[1]}
    return set().union(*(_tree_columns(t) for t in tree[1:]))


def bs_oracle(data: list, pad_to: int) -> dict:
    """The block-skip path's answers from the sorted columns, with the
    stats the engine must report: segments pruned from per-segment
    min/max, and blocks pruned and entries scanned from per-4096-row-block
    min/max under the candidate bound (none pruned past it)."""
    R, frac = 4096, 16
    sizes = [len(d["lo_orderdate"]) for d in data]
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    cols = ("lo_orderdate", "lo_discount", "lo_quantity")
    seg_lo = {k: np.array([d[k].min() for d in data]) for k in cols}
    seg_hi = {k: np.array([d[k].max() for d in data]) for k in cols}
    starts = [np.arange(0, n, R) for n in sizes]
    blk_lo = {k: np.concatenate([np.minimum.reduceat(d[k], st)
                                 for d, st in zip(data, starts)]) for k in cols}
    blk_hi = {k: np.concatenate([np.maximum.reduceat(d[k], st)
                                 for d, st in zip(data, starts)]) for k in cols}
    blk_seg = np.concatenate([np.full(len(st), i) for i, st in
                              enumerate(starts)])
    blk_rows = np.concatenate([np.minimum(R, n - st)
                               for n, st in zip(sizes, starts)])
    total = len(data) * (pad_to // R)
    bound = min(total, max(1, -(-total // frac)))
    qty, rev = c["lo_quantity"].astype(np.int64), \
        c["lo_revenue"].astype(np.int64)
    want = {}
    for name, tree in {**BS_FILTERS, **SERVE_K4_FILTERS}.items():
        m = _rows_mask(tree, c)
        alive = _may_match(tree, seg_lo, seg_hi)
        cand = _may_match(tree, blk_lo, blk_hi) & alive[blk_seg]
        blocks_total = int(alive[blk_seg].sum())
        if cand.sum() > bound:  # overflow: the dense form over alive rows
            scanned, rows = blocks_total, int(blk_rows[alive[blk_seg]].sum())
        else:
            scanned, rows = int(cand.sum()), int(blk_rows[cand].sum())
        stats = {"numSegmentsPrunedByServer": int((~alive).sum()),
                 "numBlocksPruned": blocks_total - scanned,
                 "numEntriesScannedInFilter": rows * len(_tree_columns(tree))}
        n = int(m.sum())
        if name == "bs_group_month":
            d = c["lo_discount"][m]
            cnt = np.bincount(d, minlength=11)
            qs = np.bincount(d, weights=qty[m], minlength=11)
            out = [[k, int(cnt[k]), float(qs[k])] for k in range(11) if cnt[k]]
        elif name == "bs_year_overflow":
            out = [[float(rev[m].sum())]]
        elif name == "bs_sum_revenue":
            out = [[n, float(rev[m].sum())]]
        elif name == "bs_or_in_not":
            out = [[n, float(rev[m].min())]]
        elif name == "bs_q12_shape":
            out = [[n, float(qty[m].sum()), float(rev[m].max())]]
        else:
            out = [[n, float(qty[m].sum()), float(rev[m].min()),
                    float(rev[m].max())]]
        want[name] = (out, n, stats)
    return want


def _top_rows(cols: dict, mask, keys, limit: int, offset: int = 0):
    """Matched rows (segment, doc order) stably ordered by ``keys`` (each
    (values, ascending)), then [offset, offset + limit): the host's
    per-segment order and trim merged across segments, as one sort (every
    row of the answer is in its segment's first offset + limit rows, and
    ties keep segment then doc order either way)."""
    idx = np.nonzero(mask)[0]
    cols_np = [(v[idx] if asc else -v[idx].astype(np.int64))
               for v, asc in keys]
    order = np.lexsort(list(reversed(cols_np)))
    return idx[order][offset:offset + limit]


def sel_oracle(data: list, bs_data: list) -> dict:
    """The selection path's answers and the stats the reference reports
    for them: selection, DISTINCT over a raw column, the group keys over
    an expression, a raw and a virtual column and DISTINCTCOUNT over a
    raw column run on its host path, which scans each dict predicate's
    column once per segment unless an index serves it (the sorted
    lo_orderdate of the sorted table: none), drops pruned segments and
    counts entries after the filter per kept row; DISTINCT over dict
    columns and FIRST/LASTWITHTIME run on its device."""
    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    sizes = [len(d["d_year"]) for d in data]
    n = len(c["d_year"])
    seg = np.repeat(np.arange(len(data)), sizes)
    doc = np.concatenate([np.arange(k) for k in sizes])
    year, region, supp, cust = (c["d_year"], c["c_region"], c["lo_suppkey"],
                                c["lo_custkey"])
    od, disc, qty = c["lo_orderdate"], c["lo_discount"], c["lo_quantity"]
    rev = c["lo_revenue"].astype(np.int64)
    S = len(data)
    want = {}

    def stats(mask, scanned_cols: int, kept: int, per_row: int,
              processed: int = S, pruned: int = 0) -> dict:
        return {"numEntriesScannedInFilter": scanned_cols * n,
                "numEntriesScannedPostFilter": kept * per_row,
                "numSegmentsProcessed": processed,
                "numSegmentsPrunedByServer": pruned,
                "numSegmentsMatched": len(np.unique(seg[mask])),
                "numGroupsLimitReached": False}

    def kept(mask, k):  # rows each segment keeps, summed
        return int(np.minimum(np.bincount(seg[mask], minlength=S), k).sum())

    m = (disc >= 1) & (disc <= 3) & (qty < 25)
    top = _top_rows(c, m, [(rev, False), (cust, True)], 10)
    want["sel_top_revenue"] = (
        [[int(cust[i]), int(supp[i]), int(rev[i])] for i in top],
        int(m.sum()), stats(m, 2, kept(m, 10), 3))

    m = year == 1994
    top = _top_rows(c, m, [(disc, True), (qty, True)], 20, 1000)
    want["sel_ties_offset"] = (
        [[int(od[i]), int(disc[i]), int(qty[i]), int(doc[i])] for i in top],
        int(m.sum()), stats(m, 1, kept(m, 1020), 4))

    m = (region == 2) & (year == 1997)
    prod = qty * disc
    top = _top_rows(c, m, [(prod, False), (supp, True)], 10)
    want["sel_case_expr"] = (
        [[int(supp[i]), int(prod[i]), "bulk" if qty[i] > 25 else "small"]
         for i in top], int(m.sum()), stats(m, 2, kept(m, 10), 3))

    # the sorted table: lo_orderdate is sorted in every segment, so the
    # host's sorted index serves the range; segments outside it are pruned
    bod = [d["lo_orderdate"] for d in bs_data]
    alive = [bool(v.max() >= 19930301 and v.min() <= 19930328) for v in bod]
    rows, matched, kept_rows = [], 0, 0
    for i, (v, d) in enumerate(zip(bod, bs_data)):
        hit = np.nonzero((v >= 19930301) & (v <= 19930328))[0]
        matched += len(hit)
        kept_rows += min(len(hit), 15)
        rows += [[f"s{i}", int(j), int(d["lo_revenue"][j])] for j in hit[:15]]
    want["sel_first_rows"] = (rows[:15], matched, {
        "numEntriesScannedInFilter": 0,
        "numEntriesScannedPostFilter": kept_rows * 3,
        "numSegmentsProcessed": sum(alive),
        "numSegmentsPrunedByServer": S - sum(alive),
        "numSegmentsMatched": sum(
            bool(((v >= 19930301) & (v <= 19930328)).any()) for v in bod),
        "numGroupsLimitReached": False})

    pairs = np.unique((year - 1992).astype(np.int64) * 5 + region)
    want["distinct_dict"] = (
        [[1992 + int(k) // 5, str(REGIONS[k % 5])] for k in pairs], n,
        stats(np.ones(n, bool), 0, 0, 0))

    m = year == 1995
    want["distinct_raw"] = ([[int(v)] for v in np.unique(qty[m])],
                            int(m.sum()), stats(m, 1, 0, 0))

    key = cust % 1000
    cnt = np.bincount(key, minlength=1000)
    sums = np.bincount(key, weights=rev, minlength=1000)
    rmin = np.full(1000, np.iinfo(np.int64).max)
    rmax = np.full(1000, np.iinfo(np.int64).min)
    np.minimum.at(rmin, key, rev)
    np.maximum.at(rmax, key, rev)
    top = sorted((k for k in range(1000) if cnt[k]),
                 key=lambda k: (-sums[k], k))[:10]
    want["gb_expr"] = ([[k, int(cnt[k]), float(sums[k]), float(rmin[k]),
                         float(rmax[k])] for k in top], n,
                       stats(np.ones(n, bool), 0, n, 3))

    cnt = np.bincount(qty, minlength=51)
    sums = np.bincount(qty, weights=rev, minlength=51)
    want["gb_raw_key"] = ([[k, int(cnt[k]), float(sums[k])]
                           for k in range(51) if cnt[k]], n,
                          stats(np.ones(n, bool), 0, n, 1))

    want["gb_segment"] = ([[f"s{i}", len(d["lo_revenue"]),
                            float(d["lo_revenue"].max())]
                           for i, d in enumerate(data)], n,
                          stats(np.ones(n, bool), 0, n, 1))

    m = disc == 5
    pairs = np.unique((year[m] - 1992).astype(np.int64) * (1 << 23) + rev[m])
    dc = np.bincount(pairs >> 23, minlength=7)
    want["dc_raw"] = ([[1992 + y, int(dc[y])] for y in range(7) if dc[y]],
                      int(m.sum()), stats(m, 1, int(m.sum()), 1))

    rows = []
    for r in range(5):
        mr = region == r
        t0, t1 = od[mr].min(), od[mr].max()
        rows.append([str(REGIONS[r]), int(rev[mr & (od == t0)].max()),
                     int(qty[mr & (od == t1)].max())])
    want["first_last"] = (rows, n, stats(np.ones(n, bool), 0, n, 4))
    return want


def host_stats(seg, mask, n: int, S: int, scanned_cols: int, post: int):
    """The host path's stats of a query over the unsorted table: a dict
    predicate is a full scan there (no sorted or inverted index), no
    segment is pruned, entries after the filter per kept row."""
    return {"numEntriesScannedInFilter": scanned_cols * n,
            "numEntriesScannedPostFilter": post,
            "numSegmentsProcessed": S, "numSegmentsPrunedByServer": 0,
            "numSegmentsMatched": len(np.unique(seg[mask])),
            "numGroupsLimitReached": False}


def compress_weights(n: int, delta: float) -> list:
    """The cluster sizes of ops/quantile_digest.py ``compress`` over ``n``
    unit-weight values: its loop value by value, its float64 test and its
    ``_k`` / ``_k_inv`` (the port's copy of the module)."""
    from pinot_tpu_torch.ops.quantile_digest import _k, _k_inv

    total, cum, acc, out = float(n), 0.0, 1.0, []
    q_limit = float(_k_inv(_k(np.float64(0.0), delta) + 1.0, delta))
    for _ in range(1, n):
        if (cum + acc + 1.0) / total <= q_limit:
            acc += 1.0
        else:
            out.append(acc)
            cum += acc
            q_limit = float(_k_inv(_k(np.float64(cum / total), delta) + 1.0,
                                   delta))
            acc = 1.0
    out.append(acc)
    return out


def _rank_checker(name: str, groups: list, p: float, delta: float,
                  col: int = -1):
    """A rows check for an approximate percentile: each row's value (the
    column ``col``, the last by default) must lie within rank 1.5 / delta
    of p in its group's values (``groups``: (key or None, values) in row
    order)."""
    def check(got):
        if len(got) != len(groups):
            raise AssertionError(f"{name}: {len(got)} rows, want "
                                 f"{len(groups)}")
        worst = 0.0
        for row, (key, vals) in zip(got, groups):
            if key is not None and row[0] != key:
                raise AssertionError(f"{name}: key {row[0]}, want {key}")
            est, n = row[col], len(vals)
            lo = np.count_nonzero(vals < est) / n
            hi = np.count_nonzero(vals <= est) / n
            off = 0.0 if lo <= p <= hi else min(abs(lo - p), abs(hi - p))
            worst = max(worst, off)
            if off > 1.5 / delta:
                exact = np.partition(vals, int(p * (n - 1)))[int(p * (n - 1))]
                raise AssertionError(
                    f"{name}: {est} sits {off:.5f} of rank from p = {p} "
                    f"(exact order statistic {exact}; bound {1.5 / delta})")
        log(f"{name}: every value within rank {worst:.6f} of p = {p} "
            f"(bound 1.5/delta = {1.5 / delta:.4f})")
    return check


def sk_runs(data: list) -> dict:
    """Per digest query, the row count of each (segment, group) run with
    rows, segment-major, groups ascending: the counts the card's cluster
    schedule is made from."""
    S = len(data)
    years = np.unique(np.concatenate([d["d_year"] for d in data]))
    month = [(d["lo_orderdate"] >= 19930301) & (d["lo_orderdate"] <= 19930328)
             for d in data]
    supp = [np.bincount(d["lo_suppkey"], minlength=2000) for d in data]
    return {
        "pct_scalar": [len(d["d_year"]) for d in data],
        "pct_tdigest_year": [int((data[i]["d_year"] == y).sum())
                             for i in range(S) for y in years],
        "pct_raw_month": [int(m.sum()) for m in month if m.any()],
        "pct_tdigest_supp": [int(k) for cnt in supp for k in cnt if k],
    }


def sk_oracle(data: list) -> dict:
    """The digest and sketch path's answers and stats, from the generated
    columns with the port's numpy copies of the reference's digest and
    theta modules: per segment (and group) the state the reference's
    host builds, folded in segment order as its merge does."""
    import base64
    import json

    from pinot_tpu_torch.ops import quantile_digest as qd
    from pinot_tpu_torch.ops import theta

    c = {k: np.concatenate([d[k] for d in data]) for k in data[0]}
    sizes = [len(d["d_year"]) for d in data]
    S, n = len(data), len(c["d_year"])
    seg = np.repeat(np.arange(S), sizes)
    year, region, cust = c["d_year"], c["c_region"], c["lo_custkey"]
    rev, disc, od = c["lo_revenue"], c["lo_discount"], c["lo_orderdate"]
    every = np.ones(n, bool)
    want = {}

    def stats(mask=every, cols=0, args=1):
        return host_stats(seg, mask, n, S, cols, int(mask.sum()) * args)

    delta, p = SK_DIGESTS["pct_scalar"]
    want["pct_scalar"] = (_rank_checker("pct_scalar", [(None, rev)],
                                        p / 100, delta), n, stats())
    delta, p = SK_DIGESTS["pct_tdigest_year"]
    years = np.unique(year)
    want["pct_tdigest_year"] = (_rank_checker(
        "pct_tdigest_year", [(int(y), rev[year == y]) for y in years],
        p / 100, delta), n, stats())

    # the month's digest, state for state: add_values per segment, then
    # the reference's fold (the first copied, the rest merged)
    delta, _p = SK_DIGESTS["pct_raw_month"]
    m = (od >= 19930301) & (od <= 19930328)
    means, weights = [], []
    for i in range(S):
        vals = rev[(seg == i) & m]
        if not len(vals):
            continue
        mi, wi = qd.add_values([], [], vals, delta)
        if not means:
            means, weights = mi.tolist(), wi.tolist()
        else:
            mm_, ww = qd.merge(means, weights, mi, wi, delta)
            means, weights = mm_.tolist(), ww.tolist()
    blob = json.dumps({"means": means, "weights": weights,
                       "compression": delta})
    want["pct_raw_month"] = (
        [[base64.b64encode(blob.encode("utf-8")).decode("ascii")]],
        int(m.sum()), stats(m, 1))

    # theta: each segment's sketch of the distinct values (duplicates do
    # not change a build), folded with theta.merge
    k = theta.DEFAULT_NOMINAL
    present = np.zeros((S * 5, 100_000), bool)
    present[seg * 5 + region, cust] = True

    def sketch(rows_of_segment) -> tuple:
        th, h = int(theta.MAX_HASH), np.zeros(0, np.int64)
        for i in range(S):
            vals = np.nonzero(rows_of_segment(i))[0].astype(np.int32)
            if len(vals):
                ti, hi = theta.build(vals, k)
                th, h = theta.merge(th, h, ti, hi, k)
        return th, h

    rows = []
    for r in range(5):
        th, h = sketch(lambda i: present[i * 5 + r])
        rows.append([str(REGIONS[r]), round(theta.estimate(th, h))])
    want["theta_region"] = (rows, n, stats())
    filt = []
    for fm in (year == 1994, region == 2):
        pres = np.zeros((S, 100_000), bool)
        pres[seg[fm], cust[fm]] = True
        filt.append(sketch(lambda i: pres[i]))
    th, h = theta.intersect(*filt[0], *filt[1])
    want["theta_set"] = ([[round(theta.estimate(th, h))]], n, stats(args=3))

    want["sumprec_year"] = ([[int(y), str(int(rev[year == y].astype(
        np.int64).sum()))] for y in years], n, stats())
    rows = []
    for r in range(5):
        cnt = np.bincount(disc[region == r], minlength=11)
        rows.append([str(REGIONS[r]), float(np.argmax(cnt))])
    want["mode_region"] = (rows, n, stats())
    idx, rho = hll_idx_rho(fmix32(cust), LOG2M)
    slot = np.searchsorted(years, year) * (1 << LOG2M) + idx
    regs = np.zeros(len(years) << LOG2M, np.int8)
    for r in range(1, 34 - LOG2M):   # a later, larger rank overwrites
        regs[slot[rho == r]] = r
    rows = [[int(y), base64.b64encode(regs.reshape(len(years), -1)[j]
                                      .tobytes()).decode("ascii")]
            for j, y in enumerate(years)]
    want["rawhll_year"] = (rows, n, stats())
    supp = c["lo_suppkey"]
    want["smarthll_region"] = ([[str(REGIONS[r]),
                                 len(np.unique(supp[region == r]))]
                                for r in range(5)], n, stats())

    # the high-cardinality group-bys: their first SK_SUPP_ROWS keys
    def first_keys(key):
        keys = np.flatnonzero(np.bincount(key))[:SK_SUPP_ROWS]
        rows = key <= keys[-1]
        return keys, key[rows], rev[rows]

    keys, k_of, r_of = first_keys(supp)
    delta, p = SK_DIGESTS["pct_tdigest_supp"]
    want["pct_tdigest_supp"] = (_rank_checker(
        "pct_tdigest_supp", [(int(k), r_of[k_of == k]) for k in keys],
        p / 100, delta), n, stats())
    keys, k_of, r_of = first_keys(cust)
    sums = np.zeros(keys[-1] + 1, np.int64)
    np.add.at(sums, k_of, r_of.astype(np.int64))
    want["sumprec_cust"] = ([[int(k), str(int(sums[k]))] for k in keys],
                            n, stats())
    # past the threshold in every (segment, region): the registers of
    # each region's values (an int64 below 2^31 hashes as its int32)
    idx, rho = hll_idx_rho(fmix32(supp), LOG2M)
    est = hll_estimates(idx, rho, region, 5, LOG2M)
    want["smarthll_low"] = ([[str(REGIONS[r]), int(est[r])]
                             for r in range(5)], n, stats())
    return want


def check_digest_schedules(engine, runs: dict, weights: dict) -> dict:
    """K5's inputs at the digest queries, captured at its entry: the
    cluster sizes the card used (the offsets' steps) equal ``compress``'s
    on each run's count (``runs``, ``sk_runs``; ``weights``: (count,
    delta) -> ``compress_weights``), run by run. Returns the captured
    (values, offsets) by query."""
    from pinot_tpu_torch.ops import kernels

    out = {}
    for name in SK_DIGESTS:
        (args, _kw), = capture_calls(engine, SK_QUERIES[name], kernels,
                                     "cluster_sums")
        values, offsets = args
        got = np.diff(offsets.cpu().numpy())
        delta = SK_DIGESTS[name][0]
        sched = [w for n in runs[name] for w in weights[(n, delta)]]
        if got.tolist() != sched:
            raise AssertionError(f"{name}: the card's clusters differ from "
                                 f"compress's schedule")
        log(f"{name}: {len(got)} clusters over {values.numel()} values, "
            f"sizes equal compress's on each of {len(runs[name])} runs; "
            f"largest {int(got.max())}")
        out[name] = (values, offsets)
    return out


def k5_same(got, want) -> bool:
    """K5's output against its plain version: the same bits, or NaN in
    both (+inf plus -inf: the card's DADD and the CPU's give NaNs of
    other payloads)."""
    import torch

    same = got.view(torch.int64) == want.view(torch.int64)
    return bool((same | (torch.isnan(got) & torch.isnan(want))).all())


def k5_regimes(values, offsets) -> tuple:
    """One K5 call on the card: (its output, the clusters each regime
    summed in it, those its plain choice of regime expects, the length of
    the longest cluster that choice chains)."""
    import torch
    from pinot_tpu_torch.ops import kernels

    kernels.reset_cluster_regimes()
    got = kernels.cluster_sums(values, offsets)
    regimes = kernels.cluster_regimes()
    choice = kernels.cluster_regimes_plain(values, offsets)
    plain = torch.bincount(choice, minlength=len(kernels.K5_REGIMES))
    chained = torch.diff(offsets.cpu())[choice != 0]
    longest = int(chained.max()) if chained.numel() else 0
    return got, regimes, dict(zip(kernels.K5_REGIMES, plain.tolist())), \
        longest


def check_k5(label: str, values, offsets, chain_ns: float,
             exact: bool = True) -> dict:
    """K5 against its plain version (the CPU's sequential cumsum) at one
    input, bit for bit, each cluster in the regime its plain choice
    names (every cluster exact at an integer column's, ``exact``). Times:
    the kernel (CUDA events), the plain version (host clock, copies
    included) and ``torch.segment_reduce`` over the same clusters, the
    nearest library call (a parallel reduction: the same sums where every
    cluster is exact, a yardstick elsewhere). Bounds: the bytes once, and
    the chain's: its longest cluster times one DADD (``chain_ns``)."""
    import torch
    from pinot_tpu_torch.ops import kernels

    got, regimes, plain, longest = k5_regimes(values, offsets)
    t = time.perf_counter()
    want = kernels.cluster_sums_plain(values, offsets)
    plain_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    err = float((got - want).abs().nan_to_num().max()) if got.numel() \
        else 0.0
    if not k5_same(got, want):
        raise AssertionError(f"K5 {label}: differs from its plain version, "
                             f"max abs err {err}")
    if regimes != plain or (exact and regimes["exact"] != got.numel()):
        raise AssertionError(f"K5 {label}: regimes {regimes}, its plain "
                             f"choice {plain}")
    ms = cuda_ms(lambda: kernels.cluster_sums(values, offsets), 10)
    lengths = torch.diff(offsets)
    lib_ms = cuda_ms(lambda: torch.segment_reduce(values, "sum",
                                                  lengths=lengths), 5)
    n, C = values.numel(), offsets.numel() - 1
    b, by = bound_ms(8 * n + 8 * (C + 1) + 8 * C, n)
    out = dict(shape=f"n={n} clusters={C} largest="
                     f"{int(lengths.max())} {label}",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib_ms, regimes=regimes,
               chain_bound_ms=longest * chain_ns * 1e-6)
    log(f"K5 {out['shape']}: {ms:.4f} ms, plain (CPU) {plain_ms:.2f} ms, "
        f"segment_reduce {lib_ms:.4f} ms, bound {b:.4f} ms, chain bound "
        f"{out['chain_bound_ms']:.4f} ms (longest chain {longest}); "
        f"regimes {regimes}; bit-exact")
    return out


def k5_adversarial(seed: int = 61) -> list:
    """K5's adversarial inputs, made with numpy from ``seed``: (label,
    values, offsets, start, the clusters each regime should sum), the
    values to be laid ``start`` doubles past a 16-byte boundary. About a
    million values over ~1,100 clusters, so the plain version stays
    quick."""
    rng = np.random.default_rng(seed)
    big = float(2 ** 44)

    def odd(k, lo=0):   # k odd integers past ``lo``
        return lo + 2.0 * rng.integers(0, 1 << 20, k) + 1.0

    def ints(k, hi):
        return rng.integers(-hi, hi, k).astype(np.float64)

    def frac(k):
        return np.sort(rng.normal(0.0, 1000.0, k))

    lane = [frac(int(rng.integers(1, 257))) for _ in range(40)]
    cases = [
        ("a 150,000-value cluster of fractions and 40 short ones",
         [frac(150_000)] + lane, 0, (0, 40, 1)),
        ("the same, 8 bytes past a 16-byte boundary",
         [frac(150_000)] + lane, 1, (0, 40, 1)),
        ("1,000 clusters of 300 fractions (past the chain grid)",
         [frac(300) for _ in range(1000)], 0, (0, 0, 1000)),
        ("integers, sum of |v| just above 2^53",
         [odd(520, big), odd(250, float(int(2.06 * big)))], 0, (0, 1, 1)),
        ("integers, sum of |v| just below 2^53 (past 2^52: the chain)",
         [odd(500, big)], 0, (0, 0, 1)),
        ("integers, sum of |v| just below 2^52, one over 25 tiles",
         [odd(250, big), ints(200_000, 22_000_000_000)], 0, (2, 0, 0)),
        ("integral values past 2^53",
         [np.concatenate([2.0 ** 60 + 256.0 * rng.integers(0, 99, 150),
                          ints(150, 1000)]),
          np.full(100, 2.0 ** 54)], 0, (0, 1, 1)),
        ("one fraction in a 100,000-value integral cluster",
         [np.concatenate([ints(50_000, 1_000_000), [0.5],
                          ints(49_999, 1_000_000)]),
          ints(100_000, 1_000_000)], 0, (1, 0, 1)),
        ("+inf, -inf and both",
         [np.append(ints(100, 50), np.inf), np.append(ints(100, 50), -np.inf),
          np.array([np.inf, 1.0, -np.inf]),
          np.append(ints(5000, 50), np.inf)], 0, (0, 3, 1)),
        ("-0.0 only, and mixed +-0.0",
         [np.array([-0.0]), np.full(200, -0.0), np.full(20_000, -0.0),
          np.array([0.0, -0.0]), np.array([-0.0, 0.0]),
          np.concatenate([np.full(10, -0.0), [0.0], np.full(10, -0.0)]),
          np.array([-0.0, 3.0, -3.0])], 0, (7, 0, 0)),
    ]
    out = []
    for label, clusters, start, expect in cases:
        sizes = [len(c) for c in clusters]
        out.append((label, np.concatenate(clusters).astype(np.float64),
                    np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                    start, expect))
    return out


def check_k5_adversarial(chain_ns: float) -> dict:
    """K5 at ``k5_adversarial``'s inputs on the card: bit for bit against
    its plain version, each case's clusters in the regimes it names (and
    its plain choice of regime agreeing). Returns the cases' records."""
    import torch
    from pinot_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    cases = []
    for label, vals, off, start, expect in k5_adversarial():
        buf = torch.empty(vals.size + 2, dtype=torch.float64, device=dev)
        head = (16 - buf.data_ptr() % 16) % 16 // 8 + start
        values = buf[head:head + vals.size]
        values.copy_(torch.from_numpy(vals))
        offsets = torch.from_numpy(off).to(dev)
        want_regimes = dict(zip(kernels.K5_REGIMES, expect))
        got, regimes, plain, longest = k5_regimes(values, offsets)
        want = kernels.cluster_sums_plain(values, offsets)
        if not k5_same(got, want):
            raise AssertionError(f"K5 {label}: differs from its plain "
                                 f"version")
        if regimes != want_regimes or plain != want_regimes:
            raise AssertionError(f"K5 {label}: regimes {regimes}, plain "
                                 f"choice {plain}, want {want_regimes}")
        ms = cuda_ms(lambda: kernels.cluster_sums(values, offsets), 5)
        cases.append({"case": label, "n": int(vals.size),
                      "clusters": int(off.size - 1), "regimes": regimes,
                      "ms": ms, "chain_bound_ms": longest * chain_ns * 1e-6})
        log(f"K5 adversarial, {label}: n={vals.size}, "
            f"{off.size - 1} clusters, regimes {regimes}, {ms:.4f} ms; "
            f"bit-exact")
    return {"cases": cases}


def check_sketch_kernels(engine, k1: dict, k3: dict) -> None:
    """K1 at sumprec_year's and sumprec_cust's byte-plane inputs and K3 at
    rawhll_year's hash plane and group ids, captured at their entries and
    held against their plain versions. Adds the shapes to ``k1`` and
    ``k3``."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm

    for name in ("sumprec_year", "sumprec_cust"):
        # the pipeline's group count is the other call
        (gid, sources, G), kw = next(
            c for c in capture_calls(engine, SK_QUERIES[name], ps,
                                     "plane_group_sums") if c[0][1])
        count = kw.get("count", True)
        k1["shapes"].append(k1_shape(
            f"{name}: SUMPRECISION's {planes_label(sources, count)}, G={G}",
            ps.plane_group_sums, G, sources, count, gid))
    k3["sizes"].append(k3_captured(engine, SK_QUERIES["rawhll_year"],
                                   "rawhll_year's captured input", mm))


def k3_captured(engine, sql: str, label: str, mm) -> dict:
    """K3 through ``groupby_mm.hll_registers`` at the hash plane and group
    ids ``sql`` hands it, captured at the entry and held against its
    plain version, bit for bit."""
    (args, kw), = capture_calls(engine, sql, mm, "hll_registers")
    h, gid, G, log2m = args
    return k3_held(h, gid, G, log2m, kw.get("mask"), label,
                   mm_registers(mm, h, gid, G, log2m, kw.get("mask")))


def mm_registers(mm, h, gid, G: int, log2m: int, mask):
    """``k3_held``'s launch through ``groupby_mm.hll_registers``."""
    def launch():
        return mm.hll_registers(h, gid, G, log2m, mask=mask)
    launch.via = "groupby_mm.hll_registers"
    return launch


def k3_held(h, gid, G: int, log2m: int, mask, label: str, launch) -> dict:
    """K3 at one captured input, launched by ``launch()`` (an entry's call
    with its ``via`` name), against its plain version, bit for bit, with
    its times, bound and one ``scatter_reduce_`` amax over the same
    slots."""
    import torch
    from pinot_tpu_torch.ops import hll as hll_ops
    from pinot_tpu_torch.ops import kernels

    got = launch().reshape(-1)
    want = kernels.hll_register_max_plain(h, log2m, G, gid, mask)
    torch.cuda.synchronize()
    err = float((got.to(torch.int32) - want).abs().max())
    if not torch.equal(got.to(torch.int32), want):
        raise AssertionError(f"K3 at {label} differs, max abs err {err}")
    ms = cuda_ms(launch, 10)
    plain_ms = cuda_ms(lambda: kernels.hll_register_max_plain(
        h, log2m, G, gid, mask), 3)
    n, nslots = h.numel(), G << log2m
    slot, rho = hll_ops.hll_slots(h, log2m, G, gid, mask)
    # a pipeline's (S, L) planes: one scatter over every row
    s64, rho = slot.reshape(-1).long(), rho.reshape(-1)
    lib = torch.zeros(nslots + 1, dtype=torch.int32, device=h.device)
    lib_ms = cuda_ms(lambda: lib.scatter_reduce_(0, s64, rho, "amax"), 5)
    del slot, rho, s64, lib
    # the hashes, the group ids and the mask where given, the registers
    b, by = bound_ms(4 * n * (1 + (gid is not None)) + n * (mask is not None)
                     + 4 * nslots, n)
    log(f"K3 at {label} ({nslots} slots): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scatter_reduce_ amax {lib_ms:.4f} ms, bound "
        f"{b:.4f} ms, bit-exact")
    return dict(shape=f"n={n} slots={nslots} via {launch.via} ({label})",
                nslots=nslots, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b, bound_by=by, library_ms=lib_ms)


def check_highcard_kernels(engine, k1: dict) -> None:
    """K1 at the highcard path's own inputs, captured at its entry and
    held against its plain version (``k1_shape``): hc_overflow's group ids
    in the host path's shape (the kept groups of every segment,
    re-factorized: several hundred thousand, K1's group-range partitions)
    with COUNT and SUM in one call, and st_sumprec_region's decimal byte
    planes over the cube rows. Adds the shapes to ``k1``."""
    from pinot_tpu_torch.ops import group_scatter as ps

    for name, what in (("hc_overflow", "the host path's shape over the "
                        "kept groups"),
                       ("st_sumprec_region", "SUMPRECISIONMERGE's byte "
                        "planes over cube rows")):
        for (gid, sources, G), kw in capture_calls(
                engine, HC_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: {what}, G={G}, {planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))


def rows_equal(got, want) -> bool:
    """Strings and integers exactly; every number here is an integer
    below 2^53 except AVG, which both sides divide the same exact sum and
    count for, so 1e-12 relative separates any integer difference."""
    if len(got) != len(want):
        return False
    for rg, rw in zip(got, want):
        if len(rg) != len(rw):
            return False
        for x, y in zip(rg, rw):
            if isinstance(y, (str, list)):   # an MV column's row: a list
                if x != y:
                    return False
            elif abs(float(x) - float(y)) > 1e-12 * max(1.0, abs(float(y))):
                return False
    return True


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _k1_shapes(n: int, dev) -> list:
    """K1's main-path shapes, as (label, entry, G, sources, count, ids):
    q1 and q5 (SUM of the stored i32 lo_revenue plane, query offset
    1000, three byte planes, with the count), q4_no_hll (AVG of the
    stored u8 lo_quantity plane, offset 1, one byte plane), the wide
    float shape (G = 6240: an f32 source and an i32 source of two byte
    planes) and the sorted HLL build's three bf16 power-of-two channels
    through the single-accumulator entry. Ids include the overflow id
    G."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops.kernels import PlaneSource

    gen = torch.Generator(device=dev).manual_seed(11)

    def ids(G):
        return torch.randint(0, G + 1, (n,), generator=gen,
                             dtype=torch.int32, device=dev)

    def off(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)

    rev = torch.randint(1000, 6_000_000, (n,), generator=gen,
                        dtype=torch.int32, device=dev)
    qty = torch.randint(1, 51, (n,), generator=gen, dtype=torch.int32,
                        device=dev).to(torch.uint8)
    fv = torch.rand((n,), generator=gen, device=dev) * 8
    iv = torch.randint(0, 65536, (n,), generator=gen, dtype=torch.int32,
                       device=dev)
    end = torch.rand((n,), generator=gen, device=dev) < 0.05
    pw = torch.exp2(torch.randint(0, 12, (n,), generator=gen,
                                  device=dev).float())
    lo = torch.rand((n,), generator=gen, device=dev) < 0.5
    hll_ch = [end.to(torch.bfloat16),
              torch.where(end & lo, pw, 0.0).to(torch.bfloat16),
              torch.where(end & ~lo, pw, 0.0).to(torch.bfloat16)]
    del end, pw, lo
    rev_src = PlaneSource(rev, "int", 3, minus=off(1000))
    return [
        ("q1: G=2000, i32 lo_revenue, 3 byte planes + count",
         ps.plane_group_sums, 2000, [rev_src], True, ids(2000)),
        ("q5: G=35, i32 lo_revenue, 3 byte planes + count",
         ps.plane_group_sums, 35, [rev_src], True, ids(35)),
        ("q4_no_hll: G=2000, u8 lo_quantity, 1 byte plane + count",
         ps.plane_group_sums, 2000,
         [PlaneSource(qty, "int", 1, minus=off(1))], True, ids(2000)),
        ("wide: G=6240, f32 (3 float planes) + i32 (2 byte planes) + count",
         ps.plane_group_sums, 6240,
         [PlaneSource(fv, "float"), PlaneSource(iv, "int", 2, minus=off(0))],
         True, ids(6240)),
        ("sorted HLL: G=2000, 3 bf16 power-of-two channels (single "
         "accumulator entry)", mm.group_sums, 2000,
         [PlaneSource(c, "bf16") for c in hll_ch], False, ids(2000)),
    ]


def absorbed_channels(sources, count: bool):
    """The (A, n) bf16 channel tensor the port built before K1 split the
    values itself, by the same torch ops: decode, ``int_planes`` /
    ``float_planes``, one copy per plane. Timed beside K1 as the passes
    it absorbed."""
    import torch
    from pinot_tpu_torch.ops import kernels

    n = sources[0].values.numel()
    rows = int(count) + sum(s.nplanes for s in sources)
    ch = torch.empty((rows, n), dtype=torch.bfloat16,
                     device=sources[0].values.device)
    r = 0
    if count:
        ch[0].fill_(1)
        r = 1
    for s in sources:
        for p in kernels.source_channels(s):
            ch[r].copy_(p.reshape(-1))
            r += 1
    return ch


def check_split_dtypes(dev, n: int = 1_000_003) -> None:
    """Every stored dtype K1 reads (u8, u16, u32, i8, i16, i32, i64, with
    an int32 or int64 FOR offset and a negative query offset, both ends of
    the dtype's range) and K3 with group ids and a mask together, at a
    row count that leaves a ragged last quad: bit-exact against the plain
    versions. The main-path shapes above use only i32, u8, f32 and bf16."""
    import torch
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.kernels import PlaneSource

    gen = torch.Generator(device=dev).manual_seed(29)
    G = 300
    gid = torch.randint(-1, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    for dt, fo in ((torch.uint8, -1000), (torch.uint16, 70_000),
                   (torch.uint32, -(1 << 33)), (torch.int8, None),
                   (torch.int16, None), (torch.int32, None),
                   (torch.int64, None)):
        lo, hi = (0, 255) if dt == torch.uint8 else \
            (0, (1 << 32) - 1) if dt == torch.uint32 else \
            (-(1 << 40), 1 << 40) if dt == torch.int64 else \
            (torch.iinfo(dt).min, torch.iinfo(dt).max)
        v = torch.randint(lo, hi + 1, (n,), generator=gen,
                          dtype=torch.int64, device=dev)
        v[:4] = torch.tensor([lo, hi, lo, hi], device=dev)
        stored = v.to(torch.int32).view(torch.uint32) \
            if dt == torch.uint32 else v.to(dt)
        plus = None if fo is None else torch.tensor(
            fo, dtype=torch.int64 if dt == torch.uint32 else torch.int32,
            device=dev)
        off = lo + (fo or 0) - 7
        nplanes = max(1, (hi - lo + 7).bit_length() + 7 >> 3)
        src = PlaneSource(stored, "int", nplanes, plus,
                          torch.tensor(off, dtype=torch.int64, device=dev))
        got = kernels.group_plane_sums(gid, [src], G, count=True)
        want = kernels.group_plane_sums_plain(gid, [src], G, True)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs on a stored {dt} plane")
    h = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < 0.5
    for log2m in (4, 12, 16):
        got = kernels.hll_register_max(h, log2m, 3, gid=gid, mask=mask)
        want = kernels.hll_register_max_plain(h, log2m, 3, gid, mask)
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs with ids and a mask at "
                                 f"log2m {log2m}")
    log(f"K1 on every stored dtype (u8 u16 u32 i8 i16 i32 i64, FOR and "
        f"query offsets) and K3 with ids and a mask at log2m 4/12/16, "
        f"n={n}: bit-exact")


def _distinct_bytes(planes) -> int:
    """Bytes of the value planes read once each: two sources over one
    plane (SUMMV and AVGMV of one column) read it once."""
    seen = {}
    for v in planes:
        seen[(v.data_ptr(), v.numel())] = v.numel() * v.element_size()
    return sum(seen.values())


def k1_shape(label: str, entry, G: int, sources, count: bool, gid) -> dict:
    """K1 at one shape against its plain version: integer rows bit-exact,
    float planes and their sum within rtol 1e-6. Times: the kernel, the
    channel build it absorbed, the plain version and one ``index_add_`` of
    the widened values; the bound is the ids' and the stored values'
    bytes read once and the output written once."""
    import torch
    from pinot_tpu_torch.ops import kernels

    n, dev = gid.numel(), gid.device
    got = entry(gid, sources, G, count=count)
    want = kernels.group_plane_sums_plain(gid, sources, G, count)
    torch.cuda.synchronize()
    layout = kernels.plane_layout(sources, count)
    int_rows = [a for a, (region, _r) in enumerate(layout)
                if region == "int" or any(s.kind == "bf16" for s in sources)]
    flt_rows = [a for a in range(len(layout)) if a not in int_rows]
    err = float((got - want).abs().max())
    if not torch.equal(got[int_rows], want[int_rows]):
        raise AssertionError(f"K1 {label}: integer rows differ, max abs "
                             f"err {err}")
    rel = 0.0
    if flt_rows:
        g, w = got[flt_rows], want[flt_rows]
        rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()),
                  float(((g.sum(0) - w.sum(0)).abs()
                         / w.sum(0).abs().clamp_min(1e-30)).max()))
        if not rel <= 1e-6:
            raise AssertionError(f"K1 {label}: float planes off by "
                                 f"{rel} relative (tolerance 1e-6)")
    if G == 35:
        seg = kernels.group_plane_sums(gid, sources, G, count=count,
                                       seg_rows=65536)
        if not torch.equal(seg, want):
            raise AssertionError("K1 q5 with a flush every 65,536 rows "
                                 "differs")
    del got, want
    ms = cuda_ms(lambda: entry(gid, sources, G, count=count), 10)
    absorbed_ms = cuda_ms(lambda: absorbed_channels(sources, count), 5) \
        if sources else 0.0
    plain_ms = cuda_ms(lambda: kernels.group_plane_sums_plain(
        gid, sources, G, count), 3)
    vals = ([torch.ones(n, dtype=torch.float64, device=dev)]
            if count else []) + [s.values.reshape(-1).to(torch.float64)
                                 for s in sources]
    V = torch.stack(vals)
    del vals
    lib_out = torch.zeros((V.shape[0], G + 1), dtype=torch.float64,
                          device=dev)
    g64 = gid.reshape(-1).long()
    lib_ms = cuda_ms(lambda: lib_out.index_add_(1, g64, V), 5)
    del V, lib_out, g64
    A = len(layout)
    nbytes = gid.element_size() * n + _distinct_bytes(
        s.values for s in sources) + 8 * A * G
    b, by = bound_ms(nbytes, n * A)
    out = dict(shape=f"n={n} {label}", max_abs_err=err,
               float_max_rel_err=rel, ms=ms, absorbed_ms=absorbed_ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms)
    log(f"K1 {out['shape']}: {ms:.4f} ms, absorbed channel build "
        f"{absorbed_ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ "
        f"{lib_ms:.4f} ms, bound {b:.4f} ms; integer rows bit-exact"
        + (f", float planes max rel err {rel:.3e}" if flt_rows else ""))
    return out


def check_k1(n: int, dev) -> dict:
    """K1 at each synthetic main-path shape (``_k1_shapes``) through
    ``k1_shape``, q5 once more with a flush every 65,536 rows. Returns
    q1's numbers with every shape's under ``shapes``."""
    shapes = [k1_shape(*shape) for shape in _k1_shapes(n, dev)]
    return dict(shapes[0], shapes=shapes)


def check_bucket_histogram(n: int, dev) -> dict:
    """K1 through ops/radix_groupby.py ``bucket_histogram`` (the radix
    histogram, Pallas row 1's count channel in the reference) over ``n``
    packed int32 keys of hc_supp_day's key space (4,704,000 keys), half of
    them masked to the sentinel, into 256 partitions: bit for bit against
    ``torch.bincount`` of the same buckets and K1's plain version. Times:
    the call, the plain version and ``torch.bincount``."""
    import torch
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops import radix_groupby as radix

    keyspace, nb = 2000 * 2352, 256
    gen = torch.Generator(device=dev).manual_seed(37)
    key = torch.randint(0, keyspace, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    key = torch.where(torch.rand((n,), generator=gen, device=dev) < 0.5,
                      key, radix.INT32_SENTINEL)
    shift = radix.bucket_shift(keyspace, nb)
    bucket = torch.where(key == radix.INT32_SENTINEL, nb, key >> shift)
    got = radix.bucket_histogram(key, keyspace, nb)
    want = torch.bincount(bucket.long(), minlength=nb + 1)[:nb]
    plain = kernels.group_plane_sums_plain(bucket, [], nb, True)[0]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want) or not torch.equal(
            torch.round(plain).to(torch.int64), want):
        raise AssertionError(f"bucket_histogram differs from bincount, max "
                             f"abs err {err}")
    ms = cuda_ms(lambda: radix.bucket_histogram(key, keyspace, nb), 10)
    plain_ms = cuda_ms(lambda: kernels.group_plane_sums_plain(
        bucket, [], nb, True), 3)
    b64 = bucket.long()
    lib_ms = cuda_ms(lambda: torch.bincount(b64, minlength=nb + 1), 10)
    b, by = bound_ms(4 * n + 8 * nb, n)
    out = dict(shape=f"n={n} bucket_histogram: int32 keys of 4,704,000, "
                     f"half masked, {nb} partitions (count channel only)",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib_ms)
    log(f"K1 {out['shape']}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bincount {lib_ms:.4f} ms, bound {b:.4f} ms; bit-exact")
    return out


def count_sorted_builds() -> None:
    """Counts the sorted regime's table builds in ``SORTED_BUILDS``: the
    executor reaches ops/radix_groupby.py's ``chunked_group_aggregate``
    through the module, so a wrapper there sees every call."""
    from pinot_tpu_torch.ops import radix_groupby as radix

    real = radix.chunked_group_aggregate

    def counted(*args, **kwargs):
        SORTED_BUILDS[0] += 1
        return real(*args, **kwargs)

    radix.chunked_group_aggregate = counted


def check_k3(n: int, dev) -> list:
    """K3 from 32-bit hashes at the HLL path's register spaces: 1024 slots
    (scalar HLL with a mask, through the small-slot entry, Pallas row 5),
    35,840 = 35 x 1024 (d_year x c_region, the group entry, row 2) and
    2^20 = 1024 x 1024 slots (the reference's bound for row 2, several
    partitions; no query reaches it, PERF.md). Ids include the overflow
    id. Bit-exact. Times: the kernel, the split it absorbed (``hll_slots``:
    ``hll_idx_rho`` and the where), the plain version and one
    ``scatter_reduce_`` over the split's slots and ranks."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import hll as hll_ops
    from pinot_tpu_torch.ops import kernels

    gen = torch.Generator(device=dev).manual_seed(19)
    h = torch.randint(-2**31, 2**31, (n,), generator=gen, dtype=torch.int32,
                      device=dev)
    mask = torch.rand((n,), generator=gen, device=dev) < 3 / 11
    out = []
    for G, entry, call_gid, use_mask, call in (
            (1, "group_scatter.hll_register_max", False, True,
             lambda g: ps.hll_register_max(h, LOG2M, mask=mask)),
            (35, "groupby_mm.hll_registers", True, False,
             lambda g: mm.hll_registers(h, g, 35, LOG2M)),
            (1024, "kernels.hll_register_max", True, False,
             lambda g: kernels.hll_register_max(h, LOG2M, 1024, gid=g))):
        nslots = G << LOG2M
        gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                            device=dev) if call_gid else None
        m = mask if use_mask else None
        got = call(gid).reshape(-1)
        want = kernels.hll_register_max_plain(h, LOG2M, G, gid, m)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"K3 differs at {nslots} slots, max abs "
                                 f"err {err}")
        ms = cuda_ms(lambda: call(gid), 10)
        absorbed_ms = cuda_ms(lambda: hll_ops.hll_slots(h, LOG2M, G, gid, m),
                              5)
        plain_ms = cuda_ms(lambda: kernels.hll_register_max_plain(
            h, LOG2M, G, gid, m), 3)
        slot, rho = hll_ops.hll_slots(h, LOG2M, G, gid, m)
        s64 = slot.long()
        lib = torch.zeros(nslots + 1, dtype=torch.int32, device=dev)
        lib_ms = cuda_ms(lambda: lib.scatter_reduce_(0, s64, rho, "amax"), 5)
        del slot, rho, s64, lib
        nbytes = 4 * n + (4 * n if call_gid else 0) + (n if use_mask else 0) \
            + 4 * nslots
        b, by = bound_ms(nbytes, n)
        out.append(dict(shape=f"n={n} slots={nslots} via {entry}"
                              + (" (masked)" if use_mask else ""),
                        nslots=nslots,
                        partitions=kernels.hll_partitions(nslots),
                        max_abs_err=err, ms=ms, absorbed_ms=absorbed_ms,
                        plain_ms=plain_ms, bound_ms=b, bound_by=by,
                        library_ms=lib_ms))
        log(f"K3 {out[-1]['shape']} ({out[-1]['partitions']} partitions): "
            f"{ms:.4f} ms, absorbed split {absorbed_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, scatter_reduce_ amax {lib_ms:.4f} ms, bound "
            f"{b:.4f} ms, bit-exact")
    return out


def q6_minmax_sources(n: int, dev, seed: int = 13) -> tuple:
    """K2's main-path shape, q6: G = 175 (7 years x 25 nations, ids with
    the overflow id), an i32 source (lo_revenue's stored plane) with MIN
    and MAX, and a u8 source with an int32 FOR offset (lo_quantity-like,
    decoded to int32) with MIN and MAX, as one launch takes them. Returns
    (gid, G, sources)."""
    import torch
    from pinot_tpu_torch.ops.kernels import MinMaxSource

    gen = torch.Generator(device=dev).manual_seed(seed)
    G = 175
    gid = torch.randint(0, G + 1, (n,), generator=gen, dtype=torch.int32,
                        device=dev)
    rev = torch.randint(1000, 6_000_000, (n,), generator=gen,
                        dtype=torch.int32, device=dev)
    qty = torch.randint(0, 50, (n,), generator=gen, dtype=torch.int32,
                        device=dev).to(torch.uint8)
    fo = torch.tensor(1, dtype=torch.int32, device=dev)
    imax, imin = 2**31 - 1, -2**31
    return gid, G, [
        MinMaxSource(rev, ("min", "max"), (imax, imin), dtype=torch.int32),
        MinMaxSource(qty, ("min", "max"), (imax, imin), fo, torch.int32)]


def k2_shape(label: str, gid, srcs, G: int) -> dict:
    """K2 at one shape, in one launch, against its plain version,
    bit-exact. Times: the kernel, the widening and FOR add it absorbed
    (``minmax_decode`` of each source it decodes, as engine/device.py
    ``_data_col`` ran it before each launch), the plain version and one
    ``scatter_reduce_`` a source and op over the decoded values; the bound
    is the ids' and the stored planes' bytes read once and the outputs
    written once."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import kernels

    n, dev = gid.numel(), gid.device
    before = kernels.launches["group_minmax"]
    got = ps.group_minmax_sources(gid, srcs, G)
    if kernels.launches["group_minmax"] - before != 1:
        raise AssertionError(f"K2 at {label} took more than one launch")
    want = kernels.group_minmax_plain(gid, srcs, G)
    torch.cuda.synchronize()
    pairs = [(a, b) for gs, ws in zip(got, want) for a, b in zip(gs, ws)]
    err = max(float((a.double() - b.double()).abs().max()) for a, b in pairs)
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"K2 at {label} differs, max abs err {err}")
    del got, want, pairs
    ms = cuda_ms(lambda: ps.group_minmax_sources(gid, srcs, G), 10)
    widened = [s for s in srcs
               if s.plus is not None or s.dtype != s.values.dtype]
    absorbed_ms = cuda_ms(lambda: [kernels.minmax_decode(s)
                                   for s in widened], 5) if widened else 0.0
    plain_ms = cuda_ms(lambda: kernels.group_minmax_plain(gid, srcs, G), 3)
    g64 = gid.reshape(-1).long()
    decoded = [kernels.minmax_decode(s) for s in srcs]
    outs = [torch.empty(G + 1, dtype=s.dtype, device=dev) for s in srcs]

    def library():
        for v, s, o in zip(decoded, srcs, outs):
            for op, fill in zip(s.ops, s.fills):
                o.fill_(fill).scatter_reduce_(0, g64, v, "a" + op)
    lib_ms = cuda_ms(library, 5)
    del g64, decoded, outs
    cells = sum(len(s.ops) for s in srcs)
    nbytes = gid.element_size() * n + _distinct_bytes(
        s.values for s in srcs) + 4 * cells * G
    b, by = bound_ms(nbytes, n * cells)
    out = dict(shape=f"n={n} G={G} {label}", max_abs_err=err, ms=ms,
               absorbed_ms=absorbed_ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, library_ms=lib_ms)
    log(f"K2 {out['shape']}: {ms:.4f} ms, absorbed widening "
        f"{absorbed_ms:.4f} ms, plain {plain_ms:.4f} ms, scatter_reduce_ "
        f"{lib_ms:.4f} ms, bound {b:.4f} ms, bit-exact")
    return out


def check_k2(n: int, dev) -> dict:
    """K2 at q6's shape (``q6_minmax_sources``) through ``k2_shape``, then
    forced into three group partitions, then f32 sources with signed
    zeros (one with MIN and MAX, one with MAX alone): bit-exact. Returns
    q6's numbers with the shape's under ``shapes``."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import kernels

    gid, G, srcs = q6_minmax_sources(n, dev)
    q6 = k2_shape("q6: i32 min+max, u8 + FOR min+max, one launch", gid,
                  srcs, G)
    # the group-range partitions of a G past the shared-memory budget: 64
    # groups a partition, three partitions
    split = ps.group_minmax_sources(gid, srcs, G, span=64)
    want = kernels.group_minmax_plain(gid, srcs, G)
    if not all(torch.equal(a, b) for gs, ws in zip(split, want)
               for a, b in zip(gs, ws)):
        raise AssertionError("K2 at q6's shape in three partitions differs")
    del split, want

    gen = torch.Generator(device=dev).manual_seed(17)
    fv = torch.randn((n,), generator=gen, device=dev)
    fv[::1000] = -0.0
    fv[1::1000] = 0.0
    fw = torch.randn((n,), generator=gen, device=dev).abs().neg()
    fsrcs = [kernels.MinMaxSource(fv, ("min", "max"),
                                  (float("inf"), float("-inf"))),
             kernels.MinMaxSource(fw, ("max",), (float("-inf"),))]
    got = ps.group_minmax_sources(gid, fsrcs, G)
    want = kernels.group_minmax_plain(gid, fsrcs, G)
    if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for gs, ws in zip(got, want) for a, b in zip(gs, ws)):
        raise AssertionError("K2 float32 differs")
    log(f"K2 float32 sources n={n} G={G}: bit-exact with signed zeros")
    return dict(q6, shapes=[q6])


def capture_calls(engine, sql: str, module, entry: str) -> list:
    """The arguments the engine hands ``module.entry`` for ``sql``, one
    (args, kwargs) a call."""
    seen, real = [], getattr(module, entry)

    def grab(*args, **kwargs):
        seen.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, entry, grab)
    try:
        resp = engine.execute(sql)
    finally:
        setattr(module, entry, real)
    if resp["exceptions"] or not seen:
        raise AssertionError(f"{module.__name__}.{entry} was not reached by "
                             f"{sql!r}: {resp['exceptions']}")
    return seen


def planes_label(sources, count: bool) -> str:
    """K1's channels at a captured input, as a shape's label names them."""
    return " + ".join(
        [f"{s.values.dtype} {s.nplanes} plane(s)".replace("torch.", "")
         for s in sources] + (["count"] if count else []))


def check_path_group_ids(engine, k1: dict, k2: dict) -> None:
    """K1 and K2 at the selection path's own inputs: the group-id plane
    the card factorized for gb_expr (G = 1000) and gb_segment (G = 8, one
    id a segment: the most contended regime) and the value planes the
    pipeline hands them, captured at their entries, each held against
    its plain version (``k1_shape``, ``k2_shape``). Adds the shapes to
    ``k1`` and ``k2``."""
    from pinot_tpu_torch.ops import group_scatter as ps

    for name in ("gb_expr", "gb_segment"):
        sql = SEL_QUERIES[name]
        for (gid, sources, G), kw in capture_calls(engine, sql, ps,
                                                   "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: G={G}, factorized int32 group ids, "
                + planes_label(sources, count), ps.plane_group_sums, G,
                sources, count, gid))
        for (gid, srcs, G), _kw in capture_calls(engine, sql, ps,
                                                 "group_minmax_sources"):
            k2["shapes"].append(k2_shape(
                f"{name}: factorized int32 group ids, "
                + ", ".join(f"{s.values.dtype} {'+'.join(s.ops)}"
                            for s in srcs).replace("torch.", ""),
                gid, srcs, G))


def kernel_device_ms(fn, reps: int, name_part: str):
    """Mean device time of the kernels whose name holds ``name_part`` over
    ``reps`` calls, from torch.profiler (a kernel of a few microseconds
    is shorter than its wrapper's host time, which CUDA events around
    back-to-back calls would measure); None when the trace shows none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and name_part in e.key]
    if not ev:
        return None
    return sum(e.self_device_time_total for e in ev) / 1e3 / reps


def gather_branch(cand, rows_in, col_arrays, par_arrays, plan):
    """The port's generic gathered form over K4's candidates, for its
    time: gather every plane's candidate blocks (ops/blockskip.py), the
    filter as torch ops (engine/device.py ``eval_filter``) and masked
    reductions (ops/agg.py). No single PyTorch call computes K4's
    function, so this stands as its yardstick."""
    import torch
    from pinot_tpu_torch.engine.device import eval_filter
    from pinot_tpu_torch.ops import agg as agg_ops
    from pinot_tpu_torch.ops import blockskip as bs

    R = bs.BLOCK_ROWS
    g = {}
    for k, v in col_arrays.items():
        x = bs.gather_blocks(v, cand, 1, R)
        g[k] = x if x.is_floating_point() else x.to(torch.int32)
    rowid = torch.arange(R, dtype=torch.int32, device=cand.device)
    mask = eval_filter(plan.filter_tpl, g, par_arrays,
                        (cand.shape[0], R), cand.device) \
        & (rowid[None, :] < rows_in[:, None])
    reduce = {"sum": agg_ops.agg_sum, "min": agg_ops.agg_min,
              "max": agg_ops.agg_max}
    return [mask.sum()] + [reduce[op](g[ck], mask)
                           for (_i, op, ck, _b, _s, _f) in plan.aggs]


def check_k4(label: str, cand, rows_in, col_arrays, par_arrays, plan) -> dict:
    """K4 against its plain version on one set of candidates, bit-exact;
    kernel device time (profiler), the plain version's and the generic
    gathered form's (CUDA events), and the bytes bound: each candidate
    row that holds data read once per plane, candidate ids and row counts
    read, the per-candidate partials written."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import kernels

    args = ps.lower_fused(plan, col_arrays, par_arrays)
    got_i, got_f = kernels.fused_filter_agg(cand, rows_in, *args)
    want_i, want_f = kernels.fused_filter_agg_plain(cand, rows_in, *args)
    torch.cuda.synchronize()
    err = float((got_i.long() - want_i.long()).abs().max())
    same = torch.equal(got_i, want_i)
    if want_f is not None:
        err = max(err, float((got_f - want_f).abs().max()))
        same = same and torch.equal(got_f.view(torch.int32),
                                    want_f.view(torch.int32))
    if not same:
        raise AssertionError(f"K4 differs at {label}, max abs err {err}")
    branch = gather_branch(cand, rows_in, col_arrays, par_arrays, plan)
    if int(branch[0]) != int(got_i[:, 0].sum()):
        raise AssertionError(f"K4 {label}: the gathered form counts "
                             f"{int(branch[0])} rows, K4 "
                             f"{int(got_i[:, 0].sum())}")

    def call():
        return kernels.fused_filter_agg(cand, rows_in, *args)

    event_ms = cuda_ms(call, 20)
    dev_ms = kernel_device_ms(call, 20, "fused_kernel")
    plain_ms = cuda_ms(lambda: kernels.fused_filter_agg_plain(
        cand, rows_in, *args), 3)
    lib_ms = cuda_ms(lambda: gather_branch(cand, rows_in, col_arrays,
                                           par_arrays, plan), 5)
    cols, _lits, prog, aggs, ki, kf = args
    rows = int(rows_in.sum())
    B = cand.shape[0]
    nbytes = rows * sum(c.element_size() for c in cols) + 8 * B \
        + 4 * B * (ki + kf)
    b, by = bound_ms(nbytes, rows * (len(prog) + len(aggs) + 1))
    n_valid = int((rows_in > 0).sum())
    res = dict(shape=f"{label}: B={B} candidates ({n_valid} holding "
                     f"{rows} rows), {len(cols)} planes "
                     f"({', '.join(str(c.dtype).replace('torch.', '') for c in cols)}), "
                     f"{len(prog)} instructions, {len(aggs)} aggregates",
               max_abs_err=err, ms=dev_ms if dev_ms is not None else event_ms,
               call_ms=event_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=lib_ms,
               library_is="the port's generic gathered form (no single "
                          "PyTorch call computes K4's function)")
    log(f"K4 {res['shape']}: kernel {res['ms']:.4f} ms (device, profiler), "
        f"call {event_ms:.4f} ms (CUDA events), plain {plain_ms:.4f} ms, "
        f"gathered form {lib_ms:.4f} ms, bound {b:.4f} ms, bit-exact")
    return res


def check_k4_bound(n_blocks: int, dev) -> dict:
    """K4 at the full static candidate bound B = ceil(n_blocks / 16) over
    a batch of n_blocks zone blocks: u16 and u8 dict-id planes, an i32
    decoded plane, a synthetic f32 plane (float MIN/MAX) and an i16 raw
    plane (raw-space predicates); random distinct candidates, the last
    one a partial block."""
    import torch
    from pinot_tpu_torch.ops import group_scatter as ps

    R = ps.FUSED_BLOCK_ROWS
    gen = torch.Generator(device=dev).manual_seed(23)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n_blocks, R), generator=gen,
                             dtype=torch.int32, device=dev).to(dtype)

    cols = {"lo_orderdate": ints(0, 2352, torch.uint16),
            "lo_discount": ints(0, 11, torch.uint8),
            "dv::lo_revenue": ints(1000, 6_000_000, torch.int32),
            "fv": torch.randn((n_blocks, R), generator=gen, device=dev),
            "r16": ints(-30000, 30000, torch.int16)}
    widths = {"lo_orderdate": ("<u2", 0, False, ""),
              "lo_discount": ("|u1", 0, False, ""),
              "dv::lo_revenue": ("<i4", 0, False, ""),
              "fv": ("<f4", 0, False, ""), "r16": ("<i2", 0, False, "")}
    ftpl = ("and", ("range_dict", "lo_orderdate", "p0", "p1"),
            ("in_dict", "lo_discount", "p2", 4),
            ("not", ("eq_raw", ("raw", "r16"), "p3")),
            ("range_raw", ("raw", "r16"), "p4", "p5", True, True, True, False))
    aggs = (("count", None, None),
            ("sum", ("raw", "lo_discount"), (1, 1 << 20)),
            ("minmaxrange", ("dictval", "lo_revenue"), None),
            ("minmaxrange", ("raw", "fv"), None),
            ("max", ("raw", "r16"), None))
    plan = ps.plan_fused(ftpl, aggs, widths)

    def lit(*v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    params = {"p0": lit(200), "p1": lit(1800), "p2": lit(1, 3, 5, 7),
              "p3": lit(0), "p4": lit(-20000), "p5": lit(20000)}
    if plan is None or not ps.fused_params_ok(plan, params):
        raise AssertionError("K4 bound shape: the fused plan declined")
    B = min(n_blocks, max(1, -(-n_blocks // 16)))
    cand = torch.randperm(n_blocks, generator=gen, device=dev)[:B] \
        .sort().values.to(torch.int32)
    rows_in = torch.full((B,), R, dtype=torch.int32, device=dev)
    rows_in[-1] = 1000
    return check_k4("full candidate bound", cand, rows_in,
                    {k: cols[k] for k in plan.cols}, params, plan)


def capture_fused(engine, sql: str) -> tuple:
    """The arguments the engine hands K4's entry for ``sql``: (cand,
    rows_in, col_arrays, par_arrays, plan)."""
    from pinot_tpu_torch.ops import group_scatter as ps

    seen = []
    entry = ps.fused_filter_agg

    def grab(*args):
        seen.append(args)
        return entry(*args)

    ps.fused_filter_agg = grab
    try:
        resp = engine.execute(sql)
    finally:
        ps.fused_filter_agg = entry
    if resp["exceptions"] or len(seen) != 1:
        raise AssertionError(f"K4 was not reached once by {sql!r}: "
                             f"{resp['exceptions']}, {len(seen)} calls")
    return seen[0]


def overflow_cost(engine, runs: int) -> dict:
    """The unsorted table's block-skip-eligible queries overflow the
    candidate bound: p50 with block skip on (zone verdict + one scalar
    read, then the dense form) and off, in alternating order."""
    out = {}
    sqls = dict(QUERIES, **HLL_QUERIES)
    for name in OVERFLOW_QUERIES:
        on, off = sqls[name], "SET useBlockSkip = false; " + sqls[name]
        r_on, r_off = engine.execute(on), engine.execute(off)
        if r_on["resultTable"] != r_off["resultTable"] \
                or r_on["numBlocksPruned"] != 0:
            raise AssertionError(f"{name}: block skip on and off differ")
        times = {on: [], off: []}
        for _ in range(runs):
            for sql in (on, off, off, on):
                t = time.perf_counter()
                engine.execute(sql)
                times[sql].append((time.perf_counter() - t) * 1e3)
        p_on = float(np.percentile(times[on], 50))
        p_off = float(np.percentile(times[off], 50))
        out[name] = {"skip_eligible_p50_ms": p_on, "forced_dense_p50_ms": p_off}
        log(f"overflow cost {name}: p50 {p_on:.3f} ms eligible, {p_off:.3f} "
            f"ms with useBlockSkip=false ({p_on - p_off:+.3f} ms over "
            f"{2 * runs} runs each)")
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def profile_query(engine, name: str, sql: str, top: int = 8) -> tuple:
    """One traced run: wall time, the summed device time of its kernels
    (their share of the wall time is the device's busy share, kernels not
    overlapping on one stream) and the operations that took most of it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.execute(sql)
        wall_ms = (time.perf_counter() - t) * 1e3
    torch.cuda.synchronize()
    # device-side events only: the aten ops that launched them repeat
    # their kernels' device time
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3
    ev.sort(key=lambda e: -e.self_device_time_total)
    parts = ", ".join(f"{e.key[:48]} x{e.count} "
                      f"{e.self_device_time_total / 1e3:.3f}" for e in ev[:top])
    # host side: the CUDA runtime calls and aten ops with the most self
    # time, where a host-bound query's wall time goes
    host = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total]
    host.sort(key=lambda e: -e.self_cpu_time_total)
    host_ms = sum(e.self_cpu_time_total for e in host) / 1e3
    hparts = ", ".join(f"{e.key[:32]} x{e.count} "
                       f"{e.self_cpu_time_total / 1e3:.3f}" for e in host[:6])
    log(f"profile {name}: wall {wall_ms:.3f} ms, device {dev_ms:.3f} ms "
        f"(busy {dev_ms / wall_ms:.1%}); top device ms: {parts}; traced "
        f"host ops {host_ms:.3f} ms, top host ms: {hparts}")
    return wall_ms, dev_ms


# aten ops that only make a view or read metadata of their input
_VIEW_OPS = ("aten::view", "aten::reshape", "aten::_reshape_alias",
             "aten::_unsafe_view", "aten::alias", "aten::as_strided",
             "aten::detach", "aten::expand", "aten::slice", "aten::select")


def plane_readers(engine, sql: str, planes: dict) -> dict:
    """The torch ops (other than views) that take one of ``planes`` (name
    -> device tensor, as the batch holds it) as an input while ``sql``
    runs once, by name: {plane: {op: count}}. Seen at the dispatcher, so a
    kernel launched through ctypes reads a plane without showing here."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    storages = {p.untyped_storage().data_ptr(): name
                for name, p in planes.items()}
    seen = {name: {} for name in planes}

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            op = "aten::" + func.__name__.split(".")[0]
            if op not in _VIEW_OPS:
                for a in torch.utils._pytree.tree_leaves((args, kwargs)):
                    if isinstance(a, torch.Tensor):
                        name = storages.get(a.untyped_storage().data_ptr())
                        if name is not None:
                            seen[name][op] = seen[name].get(op, 0) + 1
            return func(*args, **(kwargs or {}))

    with Spy():
        resp = engine.execute(sql)
    if resp["exceptions"]:
        raise AssertionError(f"{sql!r}: {resp['exceptions']}")
    return seen


# the paths whose K5 inputs are integer columns (lo_revenue, lo_codes):
# every cluster must take the exact regime; the clusters each regime
# summed over the main paths, for the kernels line
K5_INTEGER_PATHS = ("sketch", "mv", "multistage")
K5_PATH_REGIMES: dict = {}


def launch_tables() -> dict:
    """The launch counters: per kernel, and per entry of the two modules
    whose entries stand for different TPU kernels."""
    from pinot_tpu_torch.ops import group_scatter, groupby_mm, kernels

    return {"kernels": kernels.launches, "group_scatter": group_scatter.launches,
            "groupby_mm": groupby_mm.launches}


def run_path(engine, path: str, want: dict, total: int, runs: int,
             profile: bool) -> tuple:
    """One main path: zero every launch count, run each query once
    against the oracle and ``runs`` more times for its p50 (plus a traced
    run with ``profile``), read the counts. Fails when an answer differs
    or a kernel or entry of the path never launched. Returns (p50 by
    query, kernel launches)."""
    from pinot_tpu_torch.ops import kernels

    queries, kernel_names, entries = PATHS[path]
    tables = launch_tables()
    for table in tables.values():
        for key in table:
            table[key] = 0
    kernels.reset_cluster_regimes()
    p50 = {}
    for name, sql in queries.items():
        before = dict(tables["kernels"])
        routes = (SORTED_BUILDS[0], engine.device.host_shape_reruns)
        t = time.perf_counter()
        resp = engine.execute(sql)
        first_ms = (time.perf_counter() - t) * 1e3
        for kname, count in QUERY_LAUNCHES.get(name, {}).items():
            made = tables["kernels"][kname] - before[kname]
            if made != count:
                raise AssertionError(f"{name}: {made} launches of {kname} "
                                     f"in one execution, want {count}")
        if name in QUERY_ROUTES:
            made = (SORTED_BUILDS[0] - routes[0],
                    engine.device.host_shape_reruns - routes[1])
            if made != QUERY_ROUTES[name]:
                raise AssertionError(
                    f"{name}: {made[0]} sorted-regime tables and {made[1]} "
                    f"host-path-shape runs in one execution, want "
                    f"{QUERY_ROUTES[name]}")
        check_answer(name, resp, want, total)
        scanned = want[name][1]
        scan_docs = (want[name][2] if len(want[name]) > 2 else {}).get(
            "scan_docs")
        got = resp["resultTable"]["rows"]
        if name in CUBE_SCAN_TWINS:   # an exact pair: cube == scan
            twin = engine.execute("SET useStarTree = false; " + sql)
            if twin["resultTable"] != resp["resultTable"] \
                    or twin["numDocsScanned"] != scan_docs:
                raise AssertionError(f"{name}: the useStarTree = false twin "
                                     f"answers {twin}")
        if path == "blockskip":  # the force-dense twin
            twin = engine.execute("SET useBlockSkip = false; " + sql)
            if twin["resultTable"] != resp["resultTable"] \
                    or twin["numDocsScanned"] != scanned:
                raise AssertionError(f"{name}: the useBlockSkip = false twin "
                                     f"answers {twin['resultTable']}")
        times = []
        for _ in range(TIMED_RUNS.get(name, runs)):
            t = time.perf_counter()
            engine.execute(sql)
            times.append((time.perf_counter() - t) * 1e3)
        if times:
            p50[name] = float(np.percentile(times, 50))
            timing = f"p50 {p50[name]:.3f} ms over {len(times)} run(s)"
        else:
            FIRST_RUN_MS[name] = first_ms
            timing = f"no timed run, the checked one {first_ms:.3f} ms"
        log(f"{name}: matches the oracle ({len(got)} rows, "
            f"numDocsScanned {scanned}); {timing}")
        if profile:
            profile_query(engine, name, sql)
    counts = {k: dict(v) for k, v in tables.items()}
    log(f"{path} path launches: {json.dumps(counts)}")
    if counts["kernels"]["cluster_sums"]:
        regimes = kernels.cluster_regimes()
        log(f"{path} path: K5's clusters by regime {json.dumps(regimes)}")
        for name, n in regimes.items():
            K5_PATH_REGIMES[name] = K5_PATH_REGIMES.get(name, 0) + n
        if path in K5_INTEGER_PATHS and regimes["exact"] != sum(
                regimes.values()):
            raise AssertionError(f"K5 chained clusters of the {path} path's "
                                 f"integer columns: {regimes}")
    for name in kernel_names:
        if counts["kernels"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"{path} path")
    for row, module, entry in entries:
        if counts[module][entry] <= 0:
            raise AssertionError(f"{module}.{entry} (Pallas row {row}) never "
                                 f"launched on the {path} path")
    return p50, counts["kernels"]


def check_device_reduce(engine, want: dict) -> dict:
    """The on-device trim's twins: q1, q4_no_hll and q4_scan_hll answer
    the same rows with ``SET useDeviceReduce = false`` (the untrimmed
    fetch), each trimmed launch fetching fewer bytes; and the
    numGroupsLimit case (100 of 2,000 groups kept): by default in the
    host path's shape, as the reference's host keeps them (each
    segment's first 100 in doc order), untrimmed the first 100 gids, as
    the reference's device does. Returns the bytes fetched per query with
    and without the trim."""
    ex = engine.device
    sqls = dict(QUERIES, **HLL_QUERIES)
    out = {}
    for name in TRIM_TWINS:
        got = {}
        for form, sql in (("trimmed", sqls[name]),
                          ("untrimmed", NO_TRIM + sqls[name])):
            b0, d0 = ex.fetch_bytes_total, ex.device_reduce_queries
            resp = engine.execute(sql)
            if resp["exceptions"]:
                raise AssertionError(f"{name} {form}: {resp['exceptions']}")
            trimmed = ex.device_reduce_queries - d0
            if trimmed != (form == "trimmed"):
                raise AssertionError(f"{name} {form}: {trimmed} trimmed "
                                     f"fetches")
            got[form] = (resp["resultTable"], ex.fetch_bytes_total - b0)
        if got["trimmed"][0] != got["untrimmed"][0] \
                or not rows_equal(got["trimmed"][0]["rows"], want[name][0]):
            raise AssertionError(f"{name}: the useDeviceReduce = false twin "
                                 f"answers another table")
        if not got["trimmed"][1] < got["untrimmed"][1]:
            raise AssertionError(f"{name}: the trimmed fetch moved "
                                 f"{got['trimmed'][1]} bytes, untrimmed "
                                 f"{got['untrimmed'][1]}")
        out[name] = {"trimmed_bytes": got["trimmed"][1],
                     "untrimmed_bytes": got["untrimmed"][1]}
        log(f"device reduce {name}: the useDeviceReduce = false twin answers "
            f"the same rows; fetched {got['trimmed'][1]} bytes trimmed, "
            f"{got['untrimmed'][1]} untrimmed")
    # numGroupsLimit = 100 of 2,000 groups: the trimmed launch gives way
    # to the host path's shape (per segment, the first 100 groups in doc
    # order), as the reference leaves its device; untrimmed, the first
    # 100 gids, as the reference's device keeps them
    r0 = ex.host_shape_reruns
    resp = engine.execute(GROUPS_LIMIT_SQL)
    reran = ex.host_shape_reruns - r0
    twin = engine.execute(NO_TRIM + GROUPS_LIMIT_SQL)
    cnt = want["q4_counts"][:100]
    rows = [[k, int(cnt[k]), want["q4_qsums"][k] / float(cnt[k])]
            for k in sorted(range(100), key=lambda k: (-cnt[k], k))[:10]]
    if resp["exceptions"] or twin["exceptions"] \
            or not resp["numGroupsLimitReached"] \
            or not twin["numGroupsLimitReached"] \
            or not rows_equal(resp["resultTable"]["rows"],
                              want["q4_groups_limit_host"]) \
            or not rows_equal(twin["resultTable"]["rows"], rows) \
            or reran != 1 or ex.host_shape_reruns != r0 + 1:
        raise AssertionError(f"numGroupsLimit case: {resp}, twin {twin}")
    log("device reduce numGroupsLimit = 100 on the lo_suppkey group-by: "
        "numGroupsLimitReached; the default answer ran again in the host "
        "path's shape and equals the oracle's per-segment doc-order keep, "
        "the useDeviceReduce = false twin the first 100 groups")
    return out


# ---------------------------------------------------------------------------
# the realtime path: a consuming segment beside lineorder's sealed ones
# (lineorder_rt) and a FULL-upsert table (lineorder_up), at Pinot's
# documented realtime defaults on one server
# ---------------------------------------------------------------------------

RT_TABLE = "lineorder_rt"
RT_SEED = 71
RT_ROWS = 5_000_000     # realtime.segment.flush.threshold.rows (Pinot default)
RT_MORE = 500_000       # indexed while queries run
RT_FETCH = 8192         # consume_stream_batches' max_rows
RT_CHUNKLET = 65_536    # ChunkletConfig's defaults: rows a chunklet and
RT_DEVICE_MIN = 262_144  # the frozen rows the chunklet path needs
RT_NULL_EVERY = 997     # every 997th consuming row arrives without lo_discount
RT_WHILE_RUNS = 20
UP_TABLE = "lineorder_up"
UP_SEED = 73
UP_ROWS = 500_000       # each of 2 sealed segments, and the consuming one
                        # (1,000,000 until the m3 phases needed the run's
                        # time: the row-at-a-time upsert took 42 s)
UP_KEYS = 1_000_000     # lo_orderkey drawn from these, with repeats
UP_FLIP = 0.10          # the share of present keys a later wave updates
UP_NEWER = 19990101     # the wave's lo_orderdate: past every drawn date
LO_COLS = ("d_year", "c_region", "s_nation", "lo_suppkey", "lo_custkey",
           "lo_orderdate", "lo_discount", "lo_quantity", "lo_revenue")

_RT_Q1 = ("SET useStarTree = false; "
          "SELECT lo_suppkey, SUM(lo_revenue) FROM {t} "
          "GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) DESC, lo_suppkey "
          "LIMIT 10")
_RT_Q6 = ("SELECT d_year, s_nation, MIN(lo_revenue), MAX(lo_revenue), "
          "MINMAXRANGE(lo_quantity), COUNT(*) FROM {t} "
          "WHERE lo_discount BETWEEN 1 AND 3 GROUP BY d_year, s_nation "
          "ORDER BY d_year, s_nation LIMIT 200")
RT_QUERIES = {
    "rt_q1": _RT_Q1.format(t=RT_TABLE),
    # a year of lo_orderdate: the time-sorted chunklets skip blocks (its
    # SUM of lo_revenue could pass a block's int32 partial: the gathered
    # form), and a month in K4's fused form
    "rt_q2": QUERIES["q2_range_sum"].replace("lineorder", RT_TABLE),
    "rt_month_fused": BS_QUERIES["bs_month_fused"].replace(BS_TABLE,
                                                           RT_TABLE),
    "rt_q4_hll": "SET useStarTree = false; " + Q4_HLL.replace(
        "lineorder", RT_TABLE),
    "rt_hll_scalar": HLL_QUERIES["hll_scalar"].replace("lineorder",
                                                       RT_TABLE),
    "rt_q6": _RT_Q6.format(t=RT_TABLE),
    "rt_count": f"SELECT COUNT(*) FROM {RT_TABLE}",
    "rt_null": (f"SELECT COUNT(*), SUM(lo_quantity) FROM {RT_TABLE} "
                "WHERE lo_discount IS NULL"),
    "rt_select": (
        f"SELECT lo_revenue, lo_custkey, lo_suppkey, lo_orderdate FROM "
        f"{RT_TABLE} WHERE lo_discount = 10 ORDER BY lo_revenue DESC, "
        "lo_custkey, lo_suppkey, lo_orderdate LIMIT 10"),
    "up_q1": _RT_Q1.format(t=UP_TABLE),
    "up_q6": _RT_Q6.format(t=UP_TABLE),
    "up_count": f"SELECT COUNT(*) FROM {UP_TABLE}",
}
# the scan form: lineorder's d_year x c_region x s_nation cube would
# answer the sealed rows' SUM from its float32 rows
RT_COUNT_SUM = ("SET useStarTree = false; "
                f"SELECT COUNT(*), SUM(lo_revenue) FROM {RT_TABLE}")
# the sealed batch and the chunklet batch reach K1-K4 as lineorder's batch
# does; the masked sealed segments' host-path shape sums on K1 and takes
# its MIN / MAX on K2
PATHS["realtime"] = (RT_QUERIES, ("group_plane_sums", "group_minmax",
                                  "hll_register_max", "fused_filter_agg"),
                     ((3, "group_scatter", "plane_group_sums"),
                      (4, "group_scatter", "group_minmax"),
                      (2, "groupby_mm", "hll_registers"),
                      (5, "group_scatter", "hll_register_max"),
                      (6, "group_scatter", "fused_filter_agg")))


def rt_generate(rows: int, seed: int = RT_SEED) -> dict:
    """The consuming rows: lineorder's generator under its own seed,
    stably sorted by lo_orderdate (a stream delivers them in time order),
    every ``RT_NULL_EVERY``-th row without lo_discount."""
    (d,) = generate(1, rows, seed)
    order = np.argsort(d["lo_orderdate"], kind="stable")
    d = {k: v[order] for k, v in d.items()}
    d["null_discount"] = np.arange(rows) % RT_NULL_EVERY == 0
    return d


def up_generate(rows: int, seed: int = UP_SEED) -> dict:
    """lineorder_up's rows in arrival order: 3 x ``rows`` (two sealed
    segments, then the consuming one), ``lo_orderkey`` drawn from
    ``UP_KEYS`` keys with repeats, and the update wave: ``UP_FLIP`` of
    the keys present, each with a new row dated ``UP_NEWER``."""
    (d,) = generate(1, 3 * rows, seed)
    rng = np.random.default_rng(seed + 1)
    d["lo_orderkey"] = rng.integers(0, UP_KEYS, 3 * rows).astype(np.int32)
    keys = np.unique(d["lo_orderkey"])
    flip = np.sort(rng.choice(keys, int(len(keys) * UP_FLIP),
                              replace=False)).astype(np.int32)
    (w,) = generate(1, len(flip), seed + 2)
    w["lo_orderkey"] = flip
    w["lo_orderdate"] = np.full(len(flip), UP_NEWER, dtype=np.int32)
    return {"rows": d, "wave": w}


def lo_schema(table: str, orderkey: bool = False):
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema

    dims = [("d_year", DataType.INT), ("c_region", DataType.STRING),
            ("s_nation", DataType.STRING), ("lo_suppkey", DataType.INT),
            ("lo_custkey", DataType.INT), ("lo_orderdate", DataType.INT),
            ("lo_discount", DataType.INT)]
    return Schema.build(
        name=table, dimensions=dims + ([("lo_orderkey", DataType.INT)]
                                       if orderkey else []),
        metrics=[("lo_quantity", DataType.INT), ("lo_revenue", DataType.INT)],
        primary_key_columns=["lo_orderkey"] if orderkey else [])


def stored_columns(d: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of generated columns as the table stores them."""
    out = {k: d[k][lo:hi] for k in LO_COLS + ("lo_orderkey",) if k in d}
    out["c_region"] = REGIONS[out["c_region"]]
    out["s_nation"] = NATIONS[out["s_nation"]]
    return out


def records(d: dict, lo: int, hi: int) -> list:
    """Rows [lo, hi) as the decoded records a stream delivers: one dict a
    row, lo_discount absent where the generator nulled it."""
    cols = {k: v.tolist() for k, v in stored_columns(d, lo, hi).items()}
    rows = [dict(zip(cols, vals)) for vals in zip(*cols.values())]
    if "null_discount" in d:
        for i in np.flatnonzero(d["null_discount"][lo:hi]):
            del rows[i]["lo_discount"]
    return rows


def write_up_segment(i: int, up: dict, rows: int) -> str:
    """lineorder_up's committed segment ``i`` (rows [i * rows, (i + 1) *
    rows) of the stream), written by the port's creator into the realtime
    manager's data directory under its LLC name."""
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.realtime.manager import llc_segment_name
    from pinot_tpu_torch.storage.creator import build_segment

    name = llc_segment_name(UP_TABLE, 0, i, str(i * rows))
    out = os.path.join(DATA_DIR, UP_TABLE, name)
    build_segment(lo_schema(UP_TABLE, True),
                  stored_columns(up["rows"], i * rows, (i + 1) * rows), out,
                  TableConfig(table_name=UP_TABLE), name)
    return out


def _lo_columns(data: list, extra: dict, n: int) -> dict:
    """lineorder's columns with the first ``n`` consuming rows after them,
    lo_discount at its null default where the consuming row had none."""
    null = lo_schema(RT_TABLE).field("lo_discount").null_value()
    c = {}
    for k in LO_COLS:
        tail = extra[k][:n]
        if k == "lo_discount":
            tail = np.where(extra["null_discount"][:n], null, tail)
        c[k] = np.concatenate([d[k] for d in data]
                              + [tail.astype(data[0][k].dtype)])
    return c


def _q1_rows(sums) -> list:
    """q1's rows from the per-lo_suppkey revenue sums."""
    top = sorted(range(2000), key=lambda k: (-sums[k], k))[:10]
    return [[k, float(sums[k])] for k in top]


def _supp_sums(supp, rev) -> np.ndarray:
    return np.bincount(supp, weights=rev.astype(np.float64), minlength=2000)


def _q6_rows(c: dict, m) -> list:
    year, nation = c["d_year"][m], c["s_nation"][m]
    g = (year - 1992).astype(np.int64) * 25 + nation
    r, q = c["lo_revenue"][m].astype(np.int64), c["lo_quantity"][m]
    cnt = np.bincount(g, minlength=175)
    rmin = np.full(175, np.iinfo(np.int64).max)
    rmax = np.full(175, np.iinfo(np.int64).min)
    qmin, qmax = rmin.copy(), rmax.copy()
    np.minimum.at(rmin, g, r)
    np.maximum.at(rmax, g, r)
    np.minimum.at(qmin, g, q.astype(np.int64))
    np.maximum.at(qmax, g, q.astype(np.int64))
    return [[1992 + k // 25, str(NATIONS[k % 25]), float(rmin[k]),
             float(rmax[k]), float(qmax[k] - qmin[k]), int(cnt[k])]
            for k in range(175) if cnt[k]]


def rt_oracle(data: list, rt: dict, n: int) -> dict:
    """lineorder_rt's answers over lineorder's rows and the first ``n``
    consuming rows, each (rows, numDocsScanned, {"totalDocs": ...}), and
    the base the while-ingesting checks add the later rows to."""
    c = _lo_columns(data, rt, n)
    total = len(c["d_year"])
    extra = {"totalDocs": total}
    supp, od, disc = c["lo_suppkey"], c["lo_orderdate"], c["lo_discount"]
    qty, rev = c["lo_quantity"], c["lo_revenue"].astype(np.int64)
    want = {}
    sums = _supp_sums(supp, rev)
    want["rt_q1"] = (_q1_rows(sums), total, extra)
    m = (od >= 19930101) & (od <= 19931231) & (disc >= 1) & (disc <= 3) \
        & (qty < 25)
    want["rt_q2"] = ([[float(rev[m].sum())]], int(m.sum()), extra)
    m = (od >= 19930301) & (od <= 19930328)
    want["rt_month_fused"] = ([[int(m.sum()), float(qty[m].sum()),
                                float(rev[m].min()), float(rev[m].max())]],
                              int(m.sum()), extra)
    cnt = np.bincount(supp, minlength=2000)
    qs = np.bincount(supp, weights=qty.astype(np.int64), minlength=2000)
    idx, rho = hll_idx_rho(fmix32(c["lo_custkey"]), LOG2M)
    est = hll_estimates(idx, rho, supp, 2000, LOG2M)
    top = sorted((k for k in range(2000) if cnt[k]),
                 key=lambda k: (-cnt[k], k))[:10]
    want["rt_q4_hll"] = ([[k, int(cnt[k]), float(qs[k]) / float(cnt[k]),
                           int(est[k])] for k in top], total, extra)
    m = (disc >= 1) & (disc <= 3)
    est = hll_estimates(idx, rho, np.where(m, 0, -1), 1, LOG2M)
    want["rt_hll_scalar"] = ([[int(m.sum()), int(est[0])]], int(m.sum()),
                             extra)
    want["rt_q6"] = (_q6_rows(c, m), int(m.sum()), extra)
    want["rt_count"] = ([[total]], total, extra)
    nulls = np.zeros(total, bool)
    nulls[total - n:] = rt["null_discount"][:n]
    want["rt_null"] = ([[int(nulls.sum()), float(qty[nulls].sum())]],
                       int(nulls.sum()), extra)
    m = disc == 10
    keys = (c["lo_orderdate"][m], c["lo_suppkey"][m], c["lo_custkey"][m],
            -rev[m])
    order = np.lexsort(keys)[:10]
    want["rt_select"] = ([[float(rev[m][i]), int(c["lo_custkey"][m][i]),
                           int(supp[m][i]), int(od[m][i])] for i in order],
                         int(m.sum()), extra)
    want["rt_base"] = {"supp_sums": sums, "docs": total,
                       "revenue": int(rev.sum())}
    return want


def up_valid(key: np.ndarray, od: np.ndarray) -> np.ndarray:
    """The docs an upsert keeps: per key, the greatest lo_orderdate, a tie
    to the later arrival (the CAS rule)."""
    n = len(key)
    order = np.lexsort((np.arange(n), od, key))
    last = np.ones(n, dtype=bool)
    last[:-1] = key[order][1:] != key[order][:-1]
    valid = np.zeros(n, dtype=bool)
    valid[order[last]] = True
    return valid


def up_oracle(up: dict, wave: bool, suffix: str = "") -> dict:
    """lineorder_up's answers over its valid docs, before the update wave
    or after it (``wave``)."""
    d = up["rows"]
    if wave:
        d = {k: np.concatenate([d[k], up["wave"][k]]) for k in d}
    valid = up_valid(d["lo_orderkey"], d["lo_orderdate"])
    total = len(valid)
    c = {k: d[k][valid] for k in LO_COLS}
    extra = {"totalDocs": total}
    want = {}
    want["up_q1" + suffix] = (_q1_rows(_supp_sums(c["lo_suppkey"],
                                                  c["lo_revenue"])),
                              int(valid.sum()), extra)
    m = (c["lo_discount"] >= 1) & (c["lo_discount"] <= 3)
    want["up_q6" + suffix] = (_q6_rows(c, m), int(m.sum()), extra)
    want["up_count" + suffix] = ([[int(valid.sum())]], int(valid.sum()),
                                 extra)
    return want


class RowStream:
    """A stream partition of decoded records: the fetch that
    ``consume_stream_batches`` reads (the memory stream's
    ``fetch_payload_batch``), its JSON decode left out."""

    def __init__(self, rows: list):
        self.rows = rows

    def fetch_payload_batch(self, start, max_count: int):
        from pinot_tpu_torch.stream.spi import StreamPartitionMsgOffset

        got = self.rows[start.value:start.value + max_count]
        return got, StreamPartitionMsgOffset(start.value + len(got))


def rt_consume(seg, stream: RowStream, offset, upto: int):
    """Index the stream into ``seg`` through ``consume_stream_batches``
    (``RT_FETCH`` rows a fetch, one ``index_batch`` and a promotion
    after each) until ``upto``; returns the next offset."""
    from pinot_tpu_torch.realtime.chunklet import consume_stream_batches

    while offset.value < upto:
        _n, offset, got = consume_stream_batches(
            seg, stream, None, offset, batch_decoder=lambda p: p,
            max_rows=min(RT_FETCH, upto - offset.value))
        if not got:
            raise AssertionError(f"the stream ended at {offset.value}")
    return offset


def rt_segment(rt: dict, rows: int) -> tuple:
    """lineorder_rt's consuming segment with its first ``rows`` rows
    indexed: (segment, stream, next offset, seconds building the records,
    seconds indexing)."""
    from pinot_tpu_torch.common.table_config import (
        ChunkletConfig,
        StreamConfig,
        TableConfig,
        TableType,
    )
    from pinot_tpu_torch.realtime.manager import llc_segment_name
    from pinot_tpu_torch.storage.mutable import MutableSegment
    from pinot_tpu_torch.stream.spi import StreamPartitionMsgOffset

    t = time.perf_counter()
    stream = RowStream(records(rt, 0, len(rt["d_year"])))
    build_s = time.perf_counter() - t
    cfg = TableConfig(
        table_name=RT_TABLE, table_type=TableType.REALTIME,
        stream=StreamConfig(stream_type="memory", topic=RT_TABLE,
                            segment_flush_threshold_rows=RT_ROWS),
        chunklets=ChunkletConfig(enabled=True, rows_per_chunklet=RT_CHUNKLET,
                                 device_min_rows=RT_DEVICE_MIN))
    seg = MutableSegment(lo_schema(RT_TABLE),
                         llc_segment_name(RT_TABLE, 0, 0, "0"), cfg)
    t = time.perf_counter()
    offset = rt_consume(seg, stream, StreamPartitionMsgOffset(0), rows)
    return seg, stream, offset, build_s, time.perf_counter() - t


def up_manager(engine, up: dict, rows: int) -> tuple:
    """lineorder_up behind the port's RealtimeTableDataManager: the two
    committed segments named in its checkpoint (the restart path replays
    their keys through the upsert manager, in commit order, and publishes
    them), then the consuming segment fed from the in-memory stream as
    JSON, a row at a time through the primary-key CAS. Returns (manager,
    topic, seconds to consume ``rows`` rows)."""
    from pinot_tpu_torch.common.table_config import (
        ChunkletConfig,
        StreamConfig,
        TableConfig,
        TableType,
        UpsertConfig,
    )
    from pinot_tpu_torch.realtime.manager import (
        RealtimeTableDataManager,
        llc_segment_name,
    )
    from pinot_tpu_torch.stream.memory_stream import TopicRegistry

    data_dir = os.path.join(DATA_DIR, UP_TABLE)
    names = {str(i): llc_segment_name(UP_TABLE, 0, i, str(i * rows))
             for i in range(2)}
    with open(os.path.join(data_dir, "checkpoints.json"), "w") as f:
        json.dump({f"{UP_TABLE}/0": {"segment": names["1"],
                                     "offset": str(2 * rows), "sequence": 1,
                                     "names": names}}, f)
    TopicRegistry.delete(UP_TABLE)
    topic = TopicRegistry.create(UP_TABLE, 1)
    for _ in range(2 * rows):  # the committed segments' offsets
        topic.publish(b"")
    for r in records(up["rows"], 2 * rows, 3 * rows):
        topic.publish(json.dumps(r).encode())
    cfg = TableConfig(
        table_name=UP_TABLE, table_type=TableType.REALTIME,
        upsert=UpsertConfig(mode="FULL", comparison_column="lo_orderdate"),
        stream=StreamConfig(stream_type="memory", topic=UP_TABLE,
                            segment_flush_threshold_rows=RT_ROWS),
        chunklets=ChunkletConfig(enabled=True, rows_per_chunklet=RT_CHUNKLET,
                                 device_min_rows=RT_DEVICE_MIN))
    mgr = RealtimeTableDataManager(lo_schema(UP_TABLE, True), cfg,
                                   engine.table(UP_TABLE), data_dir)
    t = time.perf_counter()
    mgr.start()
    up_wait(mgr, topic)
    return mgr, topic, time.perf_counter() - t


def up_wait(mgr, topic, timeout: float = 600.0) -> None:
    pm = mgr.partition_managers[0]
    t0 = time.time()
    while pm._offset.value < topic.log_size(0):
        if pm.state == pm.ERROR or time.time() - t0 > timeout:
            raise AssertionError(f"{UP_TABLE}'s consume loop stopped at "
                                 f"{pm._offset.value} ({pm.state})")
        time.sleep(0.05)
    if pm.index_errors:
        raise AssertionError(f"{UP_TABLE}: {pm.index_errors} bad rows")


def part_kind(segs) -> str:
    """Which part of a query a launch runs: the sealed batch, the
    chunklet batch, or a host-path-shape part."""
    s = segs[0]
    d = str(getattr(s, "dir", ""))
    if d.startswith("<chunklet:"):
        return "chunklets" if getattr(s, "valid_docs_mask", None) is None \
            else "dirty chunklet"
    if d.startswith("<mutable-tail:"):
        return "tail"
    if getattr(s, "is_mutable", False):
        return "consuming, whole"
    if getattr(s, "valid_docs_mask", None) is not None:
        return "masked sealed"
    return "sealed"


class count_parts:
    """While entered, the kernel launches each part of a query makes
    (``part_kind``), by kernel, and the parts' launch calls."""

    def __init__(self, engine):
        self.dev, self.parts = engine.device, {}

    def __enter__(self):
        from pinot_tpu_torch.ops import kernels

        dev = self.dev

        def wrap(real, one):
            def spy(q, segs, *a, **kw):
                kind = part_kind([segs] if one else segs)
                before = dict(kernels.launches)
                try:
                    return real(q, segs, *a, **kw)
                finally:
                    rec = self.parts.setdefault(kind, {"calls": 0})
                    rec["calls"] += 1
                    for k, v in kernels.launches.items():
                        if v != before[k]:
                            rec[k] = rec.get(k, 0) + v - before[k]
            return spy

        dev.launch = wrap(type(dev).launch.__get__(dev), False)
        dev.launch_host_part = wrap(type(dev).launch_host_part.__get__(dev),
                                    True)
        return self

    def __exit__(self, *exc):
        del self.dev.launch, self.dev.launch_host_part
        return False


def rt_parts(engine, names, on_card: bool) -> dict:
    """Per query: one run's launches by part and by kernel, and on the
    card a traced run's device time and busy share (``profile_query``)."""
    out = {}
    for name in names:
        sql = RT_QUERIES[name]
        with count_parts(engine) as cp:
            resp = engine.execute(sql)
        if resp["exceptions"]:
            raise AssertionError(f"{name}: {resp['exceptions']}")
        out[name] = {"parts": cp.parts}
        if on_card:
            wall, dev_ms = profile_query(engine, name, sql)
            out[name].update(device_ms=dev_ms, busy=dev_ms / wall)
        log(f"{name}: launches by part {json.dumps(cp.parts)}")
    return out


def rt_tail_ms(engine, seg, runs: int) -> dict:
    """The consuming segment's tail alone in the host path's shape under
    rt_q1: launch and fetch, p50 of ``runs`` (host clock, the fetch
    waits for the card)."""
    from pinot_tpu_torch.realtime.chunklet import split_for_query

    split = split_for_query(seg)
    if split is None or not split[1]:
        raise AssertionError("lineorder_rt's consuming segment did not split")
    tail = split[1][-1]
    q = compile_query(engine, RT_QUERIES["rt_q1"])
    times = []
    for _ in range(runs + 1):
        t = time.perf_counter()
        engine.device.launch_host_part(q, tail).fetch()
        times.append((time.perf_counter() - t) * 1e3)
    p50 = float(np.percentile(times[1:], 50))
    log(f"lineorder_rt's tail ({tail.n_docs} rows) in the host path's shape "
        f"under rt_q1: p50 {p50:.3f} ms over {runs} runs; "
        f"{len(split[0])} clean chunklets of {RT_CHUNKLET} rows on the "
        f"device beside it")
    return {"rows": tail.n_docs, "p50_ms": p50, "chunklets": len(split[0])}


def rt_while_ingesting(engine, seg, stream, offset, base: dict,
                       more: dict) -> dict:
    """A writer thread indexes the stream's next rows (``RT_FETCH`` a
    fetch, promoting as it goes) while rt_q1 and COUNT(*) / SUM run
    ``RT_WHILE_RUNS`` times each: every answer must equal the oracle at
    one published count between the counts read before and after it
    (published counts: the start plus whole fetches, or the end)."""
    import threading

    end = len(stream.rows)
    start_docs = seg.n_docs
    supp = more["lo_suppkey"][start_docs:end]
    rev = more["lo_revenue"][start_docs:end].astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(rev)])
    sealed_docs = base["docs"] - start_docs
    errors, done = [], threading.Event()

    def writer():
        try:
            rt_consume(seg, stream, offset, end)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))
        finally:
            done.set()

    def published(lo: int, hi: int) -> list:
        return [c for c in range(lo, hi + 1)
                if (c - start_docs) % RT_FETCH == 0 or c == end]

    times = {"rt_q1": [], "rt_count_sum": []}
    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(RT_WHILE_RUNS):
            for name, sql in (("rt_q1", RT_QUERIES["rt_q1"]),
                              ("rt_count_sum", RT_COUNT_SUM)):
                lo = seg.n_docs
                t0 = time.perf_counter()
                resp = engine.execute(sql)
                times[name].append((time.perf_counter() - t0) * 1e3)
                hi = seg.n_docs
                if resp["exceptions"]:
                    raise AssertionError(f"{name}: {resp['exceptions']}")
                got = resp["resultTable"]["rows"]
                ok = []
                for c in published(lo, hi):
                    k = c - start_docs
                    if name == "rt_count_sum":
                        want = [[sealed_docs + c,
                                 float(base["revenue"] + csum[k])]]
                    else:
                        want = _q1_rows(base["supp_sums"]
                                        + _supp_sums(supp[:k], rev[:k]))
                    if rows_equal(got, want) \
                            and resp["numDocsScanned"] == sealed_docs + c:
                        ok.append(c)
                if not ok:
                    raise AssertionError(
                        f"{name} while ingesting: {got} matches no published "
                        f"count in [{lo}, {hi}]")
    finally:
        t.join()
    if errors:
        raise AssertionError(f"the writer failed: {errors}")
    if seg.n_docs != end:
        raise AssertionError(f"{seg.n_docs} docs after the writer, want {end}")
    out = {name: float(np.percentile(v, 50)) for name, v in times.items()}
    log(f"while indexing {end - start_docs} more rows: rt_q1 and "
        f"COUNT(*) / SUM each equal the oracle at a published count "
        f"({RT_WHILE_RUNS} runs each); p50 {json.dumps(out)} ms")
    return out


def check_realtime_kernels(engine, k1: dict, k2: dict, k3: dict,
                           k4: dict, up_rows: int) -> None:
    """K1, K2, K3 and K4 at the realtime path's own inputs, captured at
    their entries and held against their plain versions: rt_q1's and
    up_q1's group sums (the sealed batch, the chunklet batch, the masked
    sealed segments in the host path's shape), rt_q6's and up_q6's
    min/max sources, rt_q4_hll's registers and rt_month_fused's
    candidates over the chunklets. lineorder_up's segments reach the
    kernels only at ``up_rows`` past K1's gate (a rehearsal's do not)."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm

    up = ("up_q1", "up_q6") if up_rows >= engine.device.min_rows else ()
    for name in ("rt_q1",) + up[:1]:
        for (gid, sources, G), kw in capture_calls(
                engine, RT_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: n={gid.numel()}, G={G}, "
                f"{planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for name in ("rt_q6",) + up[1:]:
        for (gid, srcs, G), _kw in capture_calls(
                engine, RT_QUERIES[name], ps, "group_minmax_sources"):
            k2["shapes"].append(k2_shape(
                f"{name}: n={gid.numel()}, " + ", ".join(
                    f"{s.values.dtype} {'+'.join(s.ops)}"
                    for s in srcs).replace("torch.", ""), gid, srcs, G))
    for (h, gid, G, log2m), kw in capture_calls(
            engine, RT_QUERIES["rt_q4_hll"], mm, "hll_registers"):
        k3["sizes"].append(k3_held(
            h, gid, G, log2m, kw.get("mask"), f"rt_q4_hll, n={h.numel()}",
            mm_registers(mm, h, gid, G, log2m, kw.get("mask"))))
    for args, _kw in capture_calls(engine, RT_QUERIES["rt_month_fused"], ps,
                                   "fused_filter_agg"):
        k4["sizes"].append(check_k4(
            f"the realtime path's rt_month_fused, {args[0].numel()} "
            "candidates", *args))


def run_realtime(engine, seg, stream, offset, more: dict, want: dict,
                 mgr, topic, up: dict, runs: int, on_card: bool) -> dict:
    """The realtime path's measurements past ``run_path``: launches by
    part with device time and busy share, the tail's host-shape launch,
    the answers while indexing, then lineorder_up's update wave: its
    queries must follow the new masks."""
    from pinot_tpu_torch.common import freshness

    out = {"parts": rt_parts(engine, RT_QUERIES, on_card)}
    out["tail"] = rt_tail_ms(engine, seg, runs)
    epoch = freshness.epoch(RT_TABLE)
    out["while_ingesting_p50_ms"] = rt_while_ingesting(
        engine, seg, stream, offset, want["rt_base"], more)
    if freshness.epoch(RT_TABLE) <= epoch:
        raise AssertionError("indexing did not move lineorder_rt's epoch")
    for r in records(up["wave"], 0, len(up["wave"]["lo_orderkey"])):
        topic.publish(json.dumps(r).encode())
    t = time.perf_counter()
    up_wait(mgr, topic)
    wave_s = time.perf_counter() - t
    after = up_oracle(up, True)
    total = after["up_count"][2]["totalDocs"]
    for name in ("up_q1", "up_q6", "up_count"):
        resp = engine.execute(RT_QUERIES[name])
        check_answer(name, resp, after, total)
    log(f"{UP_TABLE}: after the update wave ({len(up['wave']['lo_orderkey'])}"
        f" keys, indexed in {wave_s:.2f} s) up_q1, up_q6 and up_count "
        f"follow the new masks ({after['up_count'][1]} valid docs of "
        f"{total})")
    out["wave_s"] = wave_s
    return out


# ---------------------------------------------------------------------------
# the multistage path: SSB's star schema joined on the card
# ---------------------------------------------------------------------------

MS_SEED = 41
CUSTOMERS = 100_000     # c_custkey 1..100,000: lo_custkey 0 misses
SUPPLIERS = 2_000       # s_suppkey 1..2,000: lo_suppkey 0 misses
MKT_SEGMENTS = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD",
                         "MACHINERY"])
MONTH_NAMES = np.array(["January", "February", "March", "April", "May",
                        "June", "July", "August", "September", "October",
                        "November", "December"])
DAY_NAMES = np.array(["Monday", "Tuesday", "Wednesday", "Thursday",
                      "Friday", "Saturday", "Sunday"])
# the reference refuses a stage-1 leaf past 4,000,000 rows: a month
# (~1.19M rows) or a quarter (~3.57M) of lineorder, never a year (~14.3M)
MS_MONTH = "lo.lo_orderdate BETWEEN 19930301 AND 19930328"
MS_QUARTER = "lo.lo_orderdate BETWEEN 19930101 AND 19930328"
MS_YEAR = "lo.lo_orderdate BETWEEN 19930101 AND 19931231"
_MS_CS = ("lineorder lo JOIN customer c ON lo.lo_custkey = c.c_custkey "
          "JOIN supplier s ON lo.lo_suppkey = s.s_suppkey")
_MS_LOOKUP = "LOOKUP('customer', 'c_nation', 'c_custkey', lo_custkey)"
_MS_ROWNUM = ("ROW_NUMBER() OVER (PARTITION BY c.c_region ORDER BY "
              "lo.lo_revenue DESC, lo.lo_orderdate, lo.lo_custkey, "
              "lo.lo_suppkey)")
MS_QUERIES = {
    # stage 2 on K1: COUNT, SUM and AVG of two integer columns, 125 groups
    "ms_nation_region": (
        f"SELECT c.c_nation, s.s_region, COUNT(*), SUM(lo.lo_revenue), "
        f"AVG(lo.lo_quantity) FROM {_MS_CS} WHERE {MS_MONTH} "
        f"GROUP BY c.c_nation, s.s_region ORDER BY SUM(lo.lo_revenue) DESC, "
        f"c.c_nation, s.s_region LIMIT 200"),
    # SSB Q3.1's shape over a quarter: four leaves, three BROADCAST joins
    "ms_q31": (
        f"SELECT c.c_nation, s.s_nation, d.d_year, SUM(lo.lo_revenue) "
        f"FROM {_MS_CS} JOIN dates d ON lo.lo_orderdate = d.d_datekey "
        f"WHERE c.c_region = 'ASIA' AND s.s_region = 'ASIA' AND "
        f"{MS_QUARTER} GROUP BY c.c_nation, s.s_nation, d.d_year "
        f"ORDER BY d.d_year, SUM(lo.lo_revenue) DESC, c.c_nation, "
        f"s.s_nation LIMIT 100"),
    "ms_left_supp": (
        f"SELECT s.s_nation, COUNT(*), SUM(lo.lo_revenue) FROM lineorder lo "
        f"LEFT JOIN supplier s ON lo.lo_suppkey = s.s_suppkey "
        f"WHERE {MS_MONTH} GROUP BY s.s_nation ORDER BY s.s_nation "
        f"LIMIT 30"),
    "ms_select": (
        f"SELECT lo.lo_orderdate, lo.lo_custkey, c.c_name, c.c_city, "
        f"lo.lo_revenue FROM lineorder lo JOIN customer c "
        f"ON lo.lo_custkey = c.c_custkey WHERE {MS_MONTH} "
        f"ORDER BY lo.lo_revenue DESC, lo.lo_orderdate, lo.lo_custkey, "
        f"lo.lo_suppkey LIMIT 100"),
    "ms_window": (
        f"SELECT lo_suppkey, lo_orderdate, lo_revenue, RANK() OVER "
        f"(PARTITION BY lo_suppkey ORDER BY lo_revenue DESC), "
        f"SUM(lo_revenue) OVER (PARTITION BY lo_suppkey ORDER BY "
        f"lo_orderdate) FROM lineorder WHERE "
        f"{MS_MONTH.replace('lo.', '')} ORDER BY lo_revenue DESC, "
        f"lo_suppkey, lo_orderdate LIMIT 100"),
    "ms_window_join": (
        f"SELECT c.c_region, lo.lo_revenue, lo.lo_orderdate, "
        f"lo.lo_custkey, COUNT(*) OVER (PARTITION BY c.c_region), "
        f"{_MS_ROWNUM} FROM lineorder lo JOIN customer c "
        f"ON lo.lo_custkey = c.c_custkey WHERE {MS_MONTH} "
        f"ORDER BY {_MS_ROWNUM}, c.c_region LIMIT 100"),
    # single-stage LOOKUP over all 100M rows: the host path's shape
    "ms_lookup": (
        f"SELECT {_MS_LOOKUP}, COUNT(*), SUM(lo_revenue), MAX(lo_revenue) "
        f"FROM lineorder GROUP BY {_MS_LOOKUP} ORDER BY {_MS_LOOKUP} "
        f"LIMIT 100"),
    # the twins: over one month the LOOKUP equals the LEFT JOIN
    "ms_lookup_month": (
        f"SELECT {_MS_LOOKUP}, COUNT(*), SUM(lo_revenue), MAX(lo_revenue) "
        f"FROM lineorder WHERE {MS_MONTH.replace('lo.', '')} "
        f"GROUP BY {_MS_LOOKUP} ORDER BY {_MS_LOOKUP} LIMIT 100"),
    "ms_left_cust": (
        f"SELECT c.c_nation, COUNT(*), SUM(lo.lo_revenue), "
        f"MAX(lo.lo_revenue) FROM lineorder lo LEFT JOIN customer c "
        f"ON lo.lo_custkey = c.c_custkey WHERE {MS_MONTH} "
        f"GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 100"),
    # sealed segments, the consuming segment's chunklets and tail
    "ms_consuming": (
        f"SELECT s.s_region, COUNT(*), SUM(lo.lo_revenue) FROM {RT_TABLE} lo "
        f"JOIN supplier s ON lo.lo_suppkey = s.s_suppkey WHERE {MS_MONTH} "
        f"GROUP BY s.s_region ORDER BY s.s_region"),
}
# stage 2's other aggregations over a month's joined rows (ROADMAP l2):
# the digests through K5 (their first joined-row inputs), SUMPRECISION's
# byte planes through K1, the raw HLL registers through K3's group entry
_MS_CM = ("lineorder lo JOIN customer c ON lo.lo_custkey = c.c_custkey "
          f"WHERE {MS_MONTH}")
_MS_SM = ("lineorder lo JOIN supplier s ON lo.lo_suppkey = s.s_suppkey "
          f"WHERE {MS_MONTH}")
# (p, compression) of ms_pct_nation's digests: PERCENTILETDIGEST's and
# PERCENTILE's defaults
MS_PCT = ((0.5, 100.0), (0.5, 200.0))
MS_QUERIES.update({
    "ms_pct_nation": (
        f"SELECT c.c_nation, PERCENTILETDIGEST(lo.lo_revenue, 50), "
        f"PERCENTILE(lo.lo_revenue, 50) FROM {_MS_CM} "
        f"GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 30"),
    "ms_theta_mode": (
        f"SELECT s.s_region, DISTINCTCOUNTTHETASKETCH(lo.lo_custkey), "
        f"MODE(lo.lo_quantity) FROM {_MS_SM} GROUP BY s.s_region "
        f"ORDER BY s.s_region"),
    "ms_sumprec_hll_first": (
        f"SELECT s.s_region, SUMPRECISION(lo.lo_revenue), "
        f"DISTINCTCOUNTRAWHLL(lo.lo_custkey), FIRSTWITHTIME(lo.lo_revenue, "
        f"lo.lo_orderdate, 'INT') FROM {_MS_SM} GROUP BY s.s_region "
        f"ORDER BY s.s_region"),
    # an MV column through the join, filtered in its leaf
    "ms_mv_select": (
        f"SELECT lo.lo_revenue, lo.lo_custkey, lo.lo_tags, c.c_nation "
        f"FROM {MV_TABLE} lo JOIN customer c ON lo.lo_custkey = c.c_custkey "
        f"WHERE lo.lo_codes = 4242 ORDER BY lo.lo_revenue DESC, "
        f"lo.lo_custkey LIMIT 10"),
    # a number against a string literal, after the join: numpy's answer
    # (no row equals 'abc')
    "ms_number_string": (
        f"SELECT COUNT(*), SUM(lo.lo_revenue) FROM {_MS_SM} AND "
        f"(lo.lo_quantity = 'abc' OR s.s_region = 'ASIA')"),
})
MS_TWINS = (("ms_lookup_month", "ms_left_cust"),)
MS_REFUSED = (f"SELECT COUNT(*) FROM lineorder lo JOIN dates d "
              f"ON lo.lo_orderdate = d.d_datekey WHERE {MS_YEAR}")
PATHS["multistage"] = (MS_QUERIES, ("group_plane_sums", "group_minmax",
                                    "hll_register_max", "cluster_sums"),
                       ((3, "group_scatter", "plane_group_sums"),
                        (4, "group_scatter", "group_minmax"),
                        (2, "groupby_mm", "hll_registers")))


def ms_dims(seed: int = MS_SEED) -> dict:
    """SSB's customer, supplier and date dimensions (O'Neil et al., Star
    Schema Benchmark rev. 3: their column names and 1-based keys) at the
    key spaces of ``generate``: nation = key % 25, region = nation // 5,
    so every joined count is an exact fraction; cities and market
    segments drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    ck = np.arange(1, CUSTOMERS + 1, dtype=np.int32)
    cn = ck % 25
    customer = {
        "c_custkey": ck,
        "c_name": np.char.add("Customer#", np.char.zfill(ck.astype(str), 9)),
        "c_city": np.char.add(NATIONS[cn],
                              rng.integers(0, 10, CUSTOMERS).astype(str)),
        "c_nation": NATIONS[cn],
        "c_region": REGIONS[cn // 5],
        "c_mktsegment": MKT_SEGMENTS[rng.integers(0, 5, CUSTOMERS)],
    }
    sk = np.arange(1, SUPPLIERS + 1, dtype=np.int32)
    sn = sk % 25
    supplier = {
        "s_suppkey": sk,
        "s_city": np.char.add(NATIONS[sn],
                              rng.integers(0, 10, SUPPLIERS).astype(str)),
        "s_nation": NATIONS[sn],
        "s_region": REGIONS[sn // 5],
    }
    days = np.arange(np.datetime64("1992-01-01"), np.datetime64("1999-01-01"))
    year = days.astype("datetime64[Y]").astype(np.int64) + 1970
    month = days.astype("datetime64[M]").astype(np.int64) % 12 + 1
    day = (days - days.astype("datetime64[M]")).astype(np.int64) + 1
    doy = (days - days.astype("datetime64[Y]")).astype(np.int64)
    dates = {
        "d_datekey": (year * 10000 + month * 100 + day).astype(np.int32),
        "d_year": year.astype(np.int32),
        "d_month": MONTH_NAMES[month - 1],
        "d_yearmonthnum": (year * 100 + month).astype(np.int32),
        "d_weeknuminyear": (doy // 7 + 1).astype(np.int32),
        # 1970-01-01 was a Thursday
        "d_dayofweek": DAY_NAMES[(days.astype(np.int64) + 3) % 7],
    }
    return {"customer": customer, "supplier": supplier, "dates": dates}


def ms_dim_schema(name: str, cols: dict):
    """A dimension table's schema: its first column the primary key."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema

    dims = [(k, DataType.INT if v.dtype.kind == "i" else DataType.STRING)
            for k, v in cols.items()]
    return Schema.build(name=name, dimensions=dims,
                        primary_key_columns=[dims[0][0]])


def write_ms_dim(name: str, cols: dict) -> str:
    """A dimension table's one segment, written with the port's creator,
    ``is_dim_table`` set."""
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.storage.creator import build_segment

    out = os.path.join(DATA_DIR, name, "d0")
    build_segment(ms_dim_schema(name, cols), cols, out,
                  TableConfig(table_name=name, is_dim_table=True), f"{name}0")
    return out


def _ms_stats(leaves: dict, totals: dict, joined: int) -> dict:
    """A multi-stage answer's stats: each leaf's matched rows, their sum
    scanned, every leaf table's docs in totalDocs, the joined rows."""
    return {"totalDocs": sum(totals[a] for a in leaves),
            "numJoinedRows": int(joined), "leafRows": dict(leaves)}


def _ms_nation_region(cn, sr, rev, qty, tot: dict) -> tuple:
    """ms_nation_region's answer from a month's customer nations and
    supplier regions by row (-1 where the key has no dimension row), its
    revenue and quantity; ``tot`` the leaf tables' docs."""
    keep = (cn >= 0) & (sr >= 0)
    g = cn[keep] * 5 + sr[keep]
    cnt = np.bincount(g, minlength=125)
    rs = np.bincount(g, weights=rev[keep].astype(np.float64), minlength=125)
    qs = np.bincount(g, weights=qty[keep].astype(np.float64), minlength=125)
    ks = sorted((k for k in range(125) if cnt[k]),
                key=lambda k: (-rs[k], NATIONS[k // 5], REGIONS[k % 5]))
    leaves = {"lo": len(cn), "c": tot["c"], "s": tot["s"]}
    return ([[str(NATIONS[k // 5]), str(REGIONS[k % 5]), int(cnt[k]),
              float(rs[k]), float(qs[k]) / float(cnt[k])] for k in ks],
            sum(leaves.values()), _ms_stats(leaves, tot, keep.sum()))


def ms_oracle(data: list, dims: dict, rt: dict, rt_rows: int,
              mv: list) -> dict:
    """The multistage path's answers from the generated columns: dense
    key -> attribute arrays gathered by key (-1 where the key has no
    dimension row), ``np.lexsort`` for the orders and the windows; the
    digests held within rank 1.5/delta, theta with the port's numpy copy
    of the reference's module over each group's joined rows at once (the
    reference's stage 2 builds one state from all of them), the raw HLL's
    registers by the host's hash; ``mv`` the MV table's columns."""
    c = {k: np.concatenate([d[k] for d in data])
         for k in ("lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue",
                   "lo_quantity")}
    cust, supp, od = c["lo_custkey"], c["lo_suppkey"], c["lo_orderdate"]
    rev, qty = c["lo_revenue"].astype(np.int64), c["lo_quantity"]
    n_lo = len(cust)
    cu, su, da = dims["customer"], dims["supplier"], dims["dates"]
    sizes = {"customer": len(cu["c_custkey"]), "supplier": len(su["s_suppkey"]),
             "dates": len(da["d_datekey"])}

    def dense(keys, values, size):
        out = np.full(size, -1, dtype=np.int64)
        out[keys] = values
        return out

    c_nat = dense(cu["c_custkey"], np.searchsorted(NATIONS, cu["c_nation"]),
                  CUSTOMERS + 1)
    c_reg = dense(cu["c_custkey"], np.searchsorted(REGIONS, cu["c_region"]),
                  CUSTOMERS + 1)
    s_nat = dense(su["s_suppkey"], np.searchsorted(NATIONS, su["s_nation"]),
                  SUPPLIERS + 1)
    s_reg = dense(su["s_suppkey"], np.searchsorted(REGIONS, su["s_region"]),
                  SUPPLIERS + 1)
    month = (od >= 19930301) & (od <= 19930328)
    quarter = (od >= 19930101) & (od <= 19930328)
    n_month, n_quarter = int(month.sum()), int(quarter.sum())
    tot = {"lo": n_lo, "c": sizes["customer"], "s": sizes["supplier"],
           "d": sizes["dates"], "lineorder": n_lo}
    want = {}

    want["ms_nation_region"] = _ms_nation_region(
        c_nat[cust[month]], s_reg[supp[month]], rev[month], qty[month], tot)

    # ms_q31: ASIA customers and suppliers over the quarter
    asia = int(np.searchsorted(REGIONS, "ASIA"))
    m = quarter & (c_reg[cust] == asia) & (s_reg[supp] == asia)
    year = od[m] // 10000
    g = (c_nat[cust[m]] * 25 + s_nat[supp[m]]) * 7 + (year - 1992)
    cnt = np.bincount(g, minlength=25 * 25 * 7)
    rs = np.bincount(g, weights=rev[m].astype(np.float64),
                     minlength=25 * 25 * 7)
    ks = sorted((k for k in range(len(cnt)) if cnt[k]),
                key=lambda k: (k % 7, -rs[k], NATIONS[k // 175],
                               NATIONS[k // 7 % 25]))[:100]
    leaves = {"lo": n_quarter, "c": int((c_reg[1:] == asia).sum()),
              "s": int((s_reg[1:] == asia).sum()), "d": tot["d"]}
    want["ms_q31"] = (
        [[str(NATIONS[k // 175]), str(NATIONS[k // 7 % 25]), 1992 + k % 7,
          float(rs[k])] for k in ks],
        sum(leaves.values()), _ms_stats(leaves, tot, m.sum()))

    # ms_left_supp: the misses group under ""
    sn = s_nat[supp[month]]
    cnt = np.bincount(sn + 1, minlength=26)
    rs = np.bincount(sn + 1, weights=rev[month].astype(np.float64),
                     minlength=26)
    names = [""] + [str(x) for x in NATIONS]
    leaves = {"lo": n_month, "s": tot["s"]}
    want["ms_left_supp"] = (
        [[names[k], int(cnt[k]), float(rs[k])] for k in range(26) if cnt[k]],
        sum(leaves.values()), _ms_stats(leaves, tot, n_month))

    # ms_select: the top 100 joined rows, no tie among them
    m = month & (c_nat[cust] >= 0)
    keys = (supp[m], cust[m], od[m], -rev[m])
    order = np.lexsort(keys)[:101]
    tops = list(zip(*(k[order].tolist() for k in keys)))
    if len(set(tops[:100])) < 100 or tops[99] == tops[100]:
        raise AssertionError("ms_select's top 100 rows tie")
    _s, ck, d, r = (k[order[:100]] for k in keys)
    at = np.searchsorted(cu["c_custkey"], ck)
    leaves = {"lo": n_month, "c": tot["c"]}
    want["ms_select"] = (
        [[int(a), int(b), str(nm), str(ct), int(-x)] for a, b, nm, ct, x in
         zip(d, ck, np.asarray(cu["c_name"])[at], np.asarray(cu["c_city"])[at],
             r)],
        sum(leaves.values()), _ms_stats(leaves, tot, m.sum()))

    # ms_window: RANK by revenue and a running SUM by date per supplier
    sp, r, d = supp[month], rev[month], od[month]
    n = len(sp)
    pos = np.arange(n)
    rank = np.empty(n, dtype=np.int64)
    o = np.lexsort((pos, -r, sp))
    ps_, rs_ = sp[o], r[o]
    start = np.r_[True, ps_[1:] != ps_[:-1]]
    peer = start | np.r_[True, rs_[1:] != rs_[:-1]]
    first = np.maximum.accumulate(np.where(start, pos, 0))
    rank[o] = np.maximum.accumulate(np.where(peer, pos, 0)) - first + 1
    run = np.empty(n, dtype=np.int64)
    o = np.lexsort((pos, d, sp))
    ps_, ds_ = sp[o], d[o]
    start = np.r_[True, ps_[1:] != ps_[:-1]]
    cs = np.cumsum(r[o])
    base = (cs - r[o])[np.maximum.accumulate(np.where(start, pos, 0))]
    csum = cs - base
    end = np.r_[(ps_[1:] != ps_[:-1]) | (ds_[1:] != ds_[:-1]), True]
    last = np.minimum.accumulate(np.where(end, pos, n)[::-1])[::-1]
    run[o] = csum[last]
    top = np.lexsort((d, sp, -r))[:100]
    want["ms_window"] = (
        [[int(sp[i]), int(d[i]), int(r[i]), int(rank[i]), float(run[i])]
         for i in top], n_month,
        _ms_stats({"lineorder": n_month}, tot, n_month))

    # ms_window_join: the region's row count and its row number
    m = month & (c_nat[cust] >= 0)
    reg = c_reg[cust[m]]
    rr, dd, cc, ss = rev[m], od[m], cust[m], supp[m]
    k = len(reg)
    o = np.lexsort((np.arange(k), ss, cc, dd, -rr, reg))
    rg = reg[o]
    start = np.r_[True, rg[1:] != rg[:-1]]
    rn = np.empty(k, dtype=np.int64)
    rn[o] = np.arange(k) - np.maximum.accumulate(
        np.where(start, np.arange(k), 0)) + 1
    per = np.bincount(reg, minlength=5)
    top = sorted(np.nonzero(rn <= 20)[0], key=lambda i: (rn[i],
                                                         REGIONS[reg[i]]))
    leaves = {"lo": n_month, "c": tot["c"]}
    want["ms_window_join"] = (
        [[str(REGIONS[reg[i]]), int(rr[i]), int(dd[i]), int(cc[i]),
          int(per[reg[i]]), int(rn[i])] for i in top[:100]],
        sum(leaves.values()), _ms_stats(leaves, tot, k))

    # LOOKUP's group-by and its twins
    def nation_groups(mask):
        cn = c_nat[cust[mask]]
        gg = cn + 1
        cnt = np.bincount(gg, minlength=26)
        rs = np.bincount(gg, weights=rev[mask].astype(np.float64),
                         minlength=26)
        mx = np.full(26, -1, dtype=np.int64)
        np.maximum.at(mx, gg, rev[mask])
        return [[names[k], int(cnt[k]), float(rs[k]), float(mx[k])]
                for k in range(26) if cnt[k]]

    every = np.ones(n_lo, dtype=bool)
    want["ms_lookup"] = (nation_groups(every), n_lo, {"totalDocs": n_lo})
    want["ms_lookup_month"] = (nation_groups(month), n_month,
                               {"totalDocs": n_lo})
    leaves = {"lo": n_month, "c": tot["c"]}
    want["ms_left_cust"] = (nation_groups(month), sum(leaves.values()),
                            _ms_stats(leaves, tot, n_month))

    # ms_consuming: lineorder's rows, then the consuming segment's first
    # rt_rows
    tail = (rt["lo_orderdate"][:rt_rows] >= 19930301) \
        & (rt["lo_orderdate"][:rt_rows] <= 19930328)
    sp2 = np.concatenate([supp[month], rt["lo_suppkey"][:rt_rows][tail]])
    rev2 = np.concatenate([rev[month], rt["lo_revenue"][:rt_rows][tail]])
    sr = s_reg[sp2]
    keep = sr >= 0
    cnt = np.bincount(sr[keep], minlength=5)
    rs = np.bincount(sr[keep], weights=rev2[keep].astype(np.float64),
                     minlength=5)
    leaves = {"lo": len(sp2), "s": tot["s"]}
    totals = dict(tot, lo=n_lo + rt_rows)
    want["ms_consuming"] = (
        [[str(REGIONS[k]), int(cnt[k]), float(rs[k])] for k in range(5)
         if cnt[k]], sum(leaves.values()), _ms_stats(leaves, totals,
                                                     keep.sum()))
    want["ms_explain"] = {"quarter": n_quarter, "year_rows": int(
        ((od >= 19930101) & (od <= 19931231)).sum())}
    want.update(ms_l2_oracle(c, c_nat, s_reg, month, n_month, tot, data, mv,
                             dims))
    return want


def ms_runs(data: list) -> list:
    """ms_pct_nation's digest runs: per nation (ascending) the month's
    joined rows, one run each (stage 2's rows are one segment)."""
    cust = np.concatenate([d["lo_custkey"] for d in data])
    od = np.concatenate([d["lo_orderdate"] for d in data])
    m = (od >= 19930301) & (od <= 19930328) & (cust >= 1)
    cnt = np.bincount(cust[m] % 25, minlength=25)
    return [int(x) for x in cnt if x]


def ms_l2_oracle(c: dict, c_nat, s_reg, month, n_month: int, tot: dict,
                 data: list, mv: list, dims: dict) -> dict:
    """The l2 queries' answers: stage 2's digests, sketches and the time
    pair over a month's joined rows, the MV selection through a join and
    the number-against-string OR."""
    import base64

    from pinot_tpu_torch.ops import theta

    cust, supp, od = c["lo_custkey"], c["lo_suppkey"], c["lo_orderdate"]
    rev, qty = c["lo_revenue"].astype(np.int64), c["lo_quantity"]
    want = {}
    mc = month & (c_nat[cust] >= 0)
    nat = c_nat[cust[mc]]
    leaves = {"lo": n_month, "c": tot["c"]}
    groups = [(str(NATIONS[k]), rev[mc][nat == k].astype(np.float64))
              for k in range(25) if (nat == k).any()]
    checks = [_rank_checker("ms_pct_nation", groups, p, delta, col=j + 1)
              for j, (p, delta) in enumerate(MS_PCT)]

    def pct_rows(got):
        for chk in checks:
            chk(got)

    want["ms_pct_nation"] = (pct_rows, sum(leaves.values()),
                             _ms_stats(leaves, tot, mc.sum()))

    ms = month & (s_reg[supp] >= 0)
    reg = s_reg[supp[ms]]
    leaves = {"lo": n_month, "s": tot["s"]}
    k = theta.DEFAULT_NOMINAL
    rows = []
    for r in range(5):
        vals = np.unique(cust[ms][reg == r]).astype(np.int32)
        th, h = theta.build(vals, k)
        cnt = np.bincount(qty[ms][reg == r], minlength=51)
        rows.append([str(REGIONS[r]), round(theta.estimate(th, h)),
                     float(np.argmax(cnt))])
    want["ms_theta_mode"] = (rows, sum(leaves.values()),
                             _ms_stats(leaves, tot, ms.sum()))

    idx, rho = hll_idx_rho(fmix32(cust[ms]), LOG2M)
    slot = reg * (1 << LOG2M) + idx
    regs = np.zeros(5 << LOG2M, np.int8)
    for r in range(1, 34 - LOG2M):   # a later, larger rank overwrites
        regs[slot[rho == r]] = r
    rows = []
    for r in range(5):
        sel = reg == r
        first = od[ms][sel].min()
        best = rev[ms][sel][od[ms][sel] == first].max()
        rows.append([str(REGIONS[r]), str(int(rev[ms][sel].sum())),
                     base64.b64encode(regs.reshape(5, -1)[r].tobytes())
                     .decode("ascii"), int(best)])
    want["ms_sumprec_hll_first"] = (rows, sum(leaves.values()),
                                    _ms_stats(leaves, tot, ms.sum()))

    asia = int(np.searchsorted(REGIONS, "ASIA"))
    hit = ms & (s_reg[supp] == asia)
    want["ms_number_string"] = (
        [[int(hit.sum()), float(rev[hit].sum())]], sum(leaves.values()),
        _ms_stats(leaves, tot, hit.sum()))

    # the MV table: its two segments' rows with code 4242, joined to
    # their customer, the top 10 by revenue
    mvd = data[:MV_SEGMENTS]
    mrev = np.concatenate([d["lo_revenue"] for d in mvd]).astype(np.int64)
    mcust = np.concatenate([d["lo_custkey"] for d in mvd])
    n_mv = len(mrev)
    tags = np.concatenate([m["lo_tags"][0] for m in mv]).astype(np.int64)
    tlen = np.concatenate([np.diff(m["lo_tags"][1]) for m in mv])
    codes = np.concatenate([m["lo_codes"][0] for m in mv])
    clen = np.concatenate([np.diff(m["lo_codes"][1]) for m in mv])
    hit = np.zeros(n_mv, bool)
    hit[np.repeat(np.arange(n_mv), clen)[codes == 4242]] = True
    joined = hit & (c_nat[mcust] >= 0)
    idx = np.lexsort((mcust, -mrev))
    idx = idx[joined[idx]][:11]
    top = [(int(mrev[i]), int(mcust[i])) for i in idx]
    if len(set(top)) < len(top) or (len(top) == 11 and top[9] == top[10]):
        raise AssertionError("ms_mv_select's top 10 rows tie")
    toff = np.concatenate([[0], np.cumsum(tlen)])
    cu = dims["customer"]
    at = np.searchsorted(cu["c_custkey"], mcust[idx[:10]])
    leaves = {"lo": int(hit.sum()), "c": tot["c"]}
    totals = dict(tot, lo=n_mv)
    want["ms_mv_select"] = (
        [[int(mrev[i]), int(mcust[i]), TAGS[tags[toff[i]:toff[i + 1]]]
          .tolist(), str(nm)]
         for i, nm in zip(idx[:10], np.asarray(cu["c_nation"])[at])],
        sum(leaves.values()), _ms_stats(leaves, totals, joined.sum()))
    return want


# the l2 queries' launches: the two digests a K5 launch each, SUMPRECISION's
# byte planes one K1 launch and the raw HLL one K3 launch at any size (the
# sketches have no gate), the rest none
MS_L2_LAUNCHES = {
    "ms_pct_nation": {"cluster_sums": 2, "group_plane_sums": 0},
    "ms_theta_mode": {"group_plane_sums": 0, "cluster_sums": 0},
    "ms_sumprec_hll_first": {"group_plane_sums": 1, "hll_register_max": 1},
    "ms_mv_select": {"group_plane_sums": 0},
    "ms_number_string": {"group_plane_sums": 0},
}


def ms_launches(want: dict, gate: int) -> dict:
    """The kernel launches one execution of each multistage query makes:
    stage 2's COUNT and integer sums one K1 launch when the joined rows
    reach K1's ``gate`` (none under it, nor for a selection or a window);
    LOOKUP's group-by, in the host path's shape over the batch, one K1
    and one K2 launch."""
    out = {}
    for name, sql in MS_QUERIES.items():
        if "LOOKUP" in sql:
            out[name] = {"group_plane_sums": 1, "group_minmax": 1}
            continue
        if name in MS_L2_LAUNCHES:
            out[name] = dict(MS_L2_LAUNCHES[name])
            continue
        joined = want[name][2]["numJoinedRows"]
        out[name] = {"group_plane_sums": int("GROUP BY" in sql
                                             and joined >= gate),
                     "group_minmax": 0}
    return out


def check_multistage_kernels(engine, k1: dict, k2: dict, k3: dict,
                             k5_sizes: list, chain_ns: float,
                             runs: list, weights: dict) -> None:
    """K1 at stage 2's own inputs (ms_nation_region's and ms_q31's group
    ids over the joined rows, their integer planes; ms_sumprec_hll_first's
    SUMPRECISION byte planes), K1 and K2 at the LOOKUP group-by's
    (ms_lookup, the host path's shape over 100M rows), K3 at
    ms_sumprec_hll_first's joined-row hashes and K5 at ms_pct_nation's
    two digests over the joined rows (the cluster sizes each group's
    ``compress`` gives, ``runs`` the groups' row counts, ``weights`` the
    schedules), captured at their entries and held against their plain
    versions, K5 with its regime counts."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import kernels

    calls = capture_calls(engine, MS_QUERIES["ms_pct_nation"], kernels,
                          "cluster_sums")
    if len(calls) != len(MS_PCT):
        raise AssertionError(f"ms_pct_nation: {len(calls)} K5 calls")
    for (args, _kw), (_p, delta) in zip(calls, MS_PCT):
        values, offsets = args
        got = np.diff(offsets.cpu().numpy())
        if got.tolist() != [w for n in runs for w in weights[(n, delta)]]:
            raise AssertionError(f"ms_pct_nation (delta {delta}): the "
                                 f"card's clusters differ from compress's")
        k5_sizes.append(check_k5(
            f"ms_pct_nation's joined rows (delta {delta:g}, {len(runs)} "
            f"groups)", values, offsets, chain_ns))
    sql = MS_QUERIES["ms_sumprec_hll_first"]
    for (gid, sources, G), kw in capture_calls(engine, sql, ps,
                                               "plane_group_sums"):
        count = kw.get("count", True)
        k1["shapes"].append(k1_shape(
            f"ms_sumprec_hll_first: SUMPRECISION over joined rows, n="
            f"{gid.numel()}, G={G}, {planes_label(sources, count)}",
            ps.plane_group_sums, G, sources, count, gid))
    k3["sizes"].append(k3_captured(
        engine, sql, "ms_sumprec_hll_first's joined-row lo_custkey hashes",
        mm))

    for name in ("ms_nation_region", "ms_q31", "ms_lookup"):
        if not QUERY_LAUNCHES[name]["group_plane_sums"]:
            log(f"{name}: its joined rows are below K1's gate at this size "
                f"(a rehearsal): K1 not captured")
            continue
        for (gid, sources, G), kw in capture_calls(
                engine, MS_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"{name}: n={gid.numel()}, G={G}, "
                f"{planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for (gid, srcs, G), _kw in capture_calls(
            engine, MS_QUERIES["ms_lookup"], ps, "group_minmax_sources"):
        k2["shapes"].append(k2_shape(
            f"ms_lookup: n={gid.numel()}, " + ", ".join(
                f"{s.values.dtype} {'+'.join(s.ops)}"
                for s in srcs).replace("torch.", ""), gid, srcs, G))


def _ms_spans(engine, sql: str) -> dict:
    """One EXPLAIN ANALYZE run's span ms: the leaves (``host_scan``), the
    join, the windows and the aggregation under ``stage2``."""
    resp = engine.execute("EXPLAIN ANALYZE " + sql)
    if resp["exceptions"]:
        raise AssertionError(f"EXPLAIN ANALYZE {sql!r}: {resp['exceptions']}")
    out = {"leaf": 0.0, "join": 0.0, "window": 0.0, "stage2": 0.0,
           "aggregate": 0.0}
    for s in resp["analyzedResponse"]["traceInfo"]["server"]:
        key = {"host_scan": "leaf", "stage2": "stage2",
               "stage2.join": "join", "stage2.window": "window",
               "stage2.aggregate": "aggregate"}.get(s["phase"])
        if key is not None:
            out[key] += s["durationMs"]
    return out


def ms_explain(engine, want: dict) -> dict:
    """EXPLAIN and EXPLAIN ANALYZE of ms_q31: the stage lines, BROADCAST
    for the three dimension builds, a local boundary, and each leaf's
    actual rows equal to the oracle's."""
    sql = MS_QUERIES["ms_q31"]
    lines = [r[0] for r in engine.execute(
        "EXPLAIN PLAN FOR " + sql)["resultTable"]["rows"]]
    stats = want["ms_q31"][2]
    need = ["  STAGE_2_AGGREGATE_GROUPBY_ORDERBY(", "[DEVICE(torch/cuda)]",
            "  STAGE_BOUNDARY(exchange:BROADCAST [local])",
            "  JOIN_INNER(strategy=BROADCAST, build=c=customer dim, "
            "probe=lo=lineorder)",
            "  JOIN_INNER(strategy=BROADCAST, build=s=supplier dim, ",
            "  JOIN_INNER(strategy=BROADCAST, build=d=dates dim, ",
            "  SCAN(lo=lineorder [probe])", "  SCAN(c=customer "
            "[build/broadcast])", "FILTER_PREDICATE(c_region = 'ASIA')"]
    text = "\n".join(lines)
    missing = [s for s in need if s not in text]
    if missing:
        raise AssertionError(f"ms_q31's EXPLAIN lacks {missing}: {lines}")
    resp = engine.execute("EXPLAIN ANALYZE " + sql)
    alines = [r[0] for r in resp["resultTable"]["rows"]]
    for alias, table in (("lo", "lineorder"), ("c", "customer"),
                         ("s", "supplier"), ("d", "dates")):
        n = stats["leafRows"][alias]
        if not any(ln.startswith(f"  SCAN({alias}={table} ")
                   and ln.endswith(f"(actual: out={n} rows)")
                   for ln in alines):
            raise AssertionError(f"ms_q31's EXPLAIN ANALYZE: SCAN({alias}) "
                                 f"is not {n} rows: {alines}")
    joined = stats["numJoinedRows"]
    if sum(ln.endswith(f"(actual: out={joined} rows)") for ln in alines
           if ln.strip().startswith("JOIN_")) != 3:
        raise AssertionError(f"ms_q31's EXPLAIN ANALYZE joins: {alines}")
    if resp["analyzedResponse"]["resultTable"]["rows"] \
            != engine.execute(sql)["resultTable"]["rows"]:
        raise AssertionError("ms_q31's analyzed rows differ")
    log(f"ms_explain: ms_q31's plan ({len(lines)} lines) and its ANALYZE "
        f"actuals match: leaves {stats['leafRows']}, {joined} joined rows")
    return {"plan_lines": len(lines),
            "phase": [ln.strip() for ln in alines if "PHASE(" in ln]}


def run_multistage(engine, want: dict, on_card: bool) -> dict:
    """The multistage path's measurements past ``run_path``: the LOOKUP ==
    LEFT JOIN twins, the stage-1 cap's refusal of a year-wide leaf, EXPLAIN
    and EXPLAIN ANALYZE of ms_q31, and per query the span breakdown
    (leaves, join, windows, aggregation) and, on the card, a traced run's
    device time and busy share."""
    out = {}
    for a, b in MS_TWINS:
        ra, rb = (engine.execute(MS_QUERIES[x])["resultTable"]["rows"]
                  for x in (a, b))
        if ra != rb:
            raise AssertionError(f"{a} differs from {b}: {ra[:3]} / {rb[:3]}")
    log(f"{', '.join(f'{a} == {b}' for a, b in MS_TWINS)}, row for row")
    from pinot_tpu_torch.query2 import runner

    year = want["ms_explain"]["year_rows"]
    resp = engine.execute(MS_REFUSED)
    msg = resp["exceptions"][0]["message"] if resp["exceptions"] else ""
    if year > runner.MAX_STAGE1_ROWS:
        if f"exceeds {runner.MAX_STAGE1_ROWS} rows" not in msg:
            raise AssertionError(f"a year-wide leaf ({year} rows) was not "
                                 f"refused: {resp}")
        log(f"a year-wide leaf ({year} rows) is refused in-band: {msg}")
    elif msg or resp["resultTable"]["rows"] != [[year]]:
        raise AssertionError(f"a year-wide leaf of {year} rows, under the "
                             f"stage-1 cap, answers {resp}")
    out["explain"] = ms_explain(engine, want)
    for name, sql in MS_QUERIES.items():
        rec = {}
        if " JOIN " in sql or " OVER " in sql:
            rec["spans_ms"] = _ms_spans(engine, sql)
        if on_card:
            rec["wall_ms"], rec["device_ms"] = profile_query(engine, name,
                                                             sql)
            rec["busy"] = rec["device_ms"] / rec["wall_ms"]
        out[name] = rec
        log(f"{name}: " + json.dumps(rec))
    return out


# ---------------------------------------------------------------------------
# the mesh path: the segment axis sharded over a mesh (ROADMAP item k)
# ---------------------------------------------------------------------------

MESH_REPEAT = 4      # shards on cuda:0 (one card standing in for four)
MESH_QUERIES = {
    **{f"mesh_{k}": v for k, v in QUERIES.items()},
    "mesh_bs_month_fused": BS_QUERIES["bs_month_fused"],
    "mesh_hc_supp_day": HC_QUERIES["hc_supp_day"],
    # K3's group entry, then its small-slot entry under a mask
    "mesh_hll_small_group": HLL_QUERIES["hll_small_group"],
    "mesh_hll_scalar": HLL_QUERIES["hll_scalar"],
    "mesh_rt_q1": RT_QUERIES["rt_q1"],
    "mesh_ms_broadcast": ("SET joinStrategy = 'broadcast'; "
                          + MS_QUERIES["ms_nation_region"]),
    "mesh_ms_shuffle": ("SET joinStrategy = 'shuffle'; "
                        + MS_QUERIES["ms_nation_region"]),
}
# the cohort: four of the serving path's K1 members
MESH_COHORT = {f"mesh_serve_k1_{lit}": SERVE_K1.format(lit=lit)
               for lit in SERVE_K1_LITS[:4]}
# each shard runs the solo pipeline: K1-K4 under every one
PATHS["mesh"] = (MESH_QUERIES, ("group_plane_sums", "group_minmax",
                                "hll_register_max", "fused_filter_agg"),
                 ((3, "group_scatter", "plane_group_sums"),
                  (4, "group_scatter", "group_minmax"),
                  (2, "groupby_mm", "hll_registers"),
                  (5, "group_scatter", "hll_register_max"),
                  (6, "group_scatter", "fused_filter_agg")))
MESH_SHARD_KERNELS = ("group_plane_sums", "group_minmax",
                      "hll_register_max", "fused_filter_agg")
# the launches of each shard (its place in the mesh) on the mesh path
MESH_SHARD_LAUNCHES: list = []

# ---------------------------------------------------------------------------
# the advisor path: the plan advisor over lineorder_by_date, device-error
# recovery and the quarantine breaker, a promotion fault, the scheduler
# ---------------------------------------------------------------------------

ADV_MIN_SAMPLES = 3      # PlanAdvisor's default: the 4th execution is advised
ADV_RUNS = 6             # executions of each selective template
ADV_DENSE_RUNS = 20      # the unselective one: its 16th decision re-probes
ADV_TOP = " ORDER BY SUM(lo_revenue) DESC, lo_custkey LIMIT 10"
# {lo} / {hi}: lo_orderdate literals, varied by run so the template key
# holds; a day is ~10 of a live segment's ~3,052 zone blocks, three days
# ~32: ratios under 1/160 and 1/80, which 1/64 and 1/32 take with the
# advisor's 2.5x headroom (a month, ~9.5 % of its segment's blocks, takes
# neither)
ADV_QUERIES = {
    "adv_day": ("SELECT COUNT(*), SUM(lo_quantity) FROM " + BS_TABLE
                + " WHERE lo_orderdate BETWEEN {lo} AND {hi}"),
    "adv_days3": ("SELECT COUNT(*), SUM(lo_quantity), MAX(lo_revenue) FROM "
                  + BS_TABLE + " WHERE lo_orderdate BETWEEN {lo} AND {hi}"),
    # most of the seven years: measured unselective, so the dense form
    "adv_dense": ("SELECT lo_discount, COUNT(*), SUM(lo_quantity) FROM "
                  + BS_TABLE + " WHERE lo_orderdate BETWEEN {lo} AND {hi} "
                  "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"),
    # a server's partial (execute_segments, not terminal): ~850 present
    # customers of 100,000 under the default trim of 5,000
    "adv_trim": ("SELECT lo_custkey, SUM(lo_revenue) FROM " + BS_TABLE
                 + " WHERE lo_orderdate BETWEEN {lo} AND {hi} AND "
                 "lo_quantity = 1 GROUP BY lo_custkey" + ADV_TOP),
}
ADV_STAMPS = {"adv_day": "ADVISOR(candBound=1/", "adv_days3":
              "ADVISOR(candBound=1/", "adv_dense": "ADVISOR(blockSkip=dense",
              "adv_trim": "ADVISOR(groupTrim="}
ADV_STATS = ("numDocsScanned", "numEntriesScannedInFilter",
             "numEntriesScannedPostFilter", "numSegmentsQueried",
             "numSegmentsProcessed", "numSegmentsMatched",
             "numSegmentsPrunedByServer", "numBlocksPruned", "totalDocs",
             "numGroupsLimitReached")
FAULT_SEGMENTS = 2       # the fault phase's batch: lineorder_by_date's first 2
FAULT_Q6 = QUERIES["q6_minmax"].replace("FROM lineorder", f"FROM {BS_TABLE}")
PROMO_TABLE = "lineorder_promo"
PROMO_SEED = 79
PROMO_ROWS = 1_000_000
PROMO_FAILS = 8          # the first 8 promotions fail: one chunklet's rows
PROMO_QUERIES = {
    "promo_count_sum": f"SELECT COUNT(*), SUM(lo_revenue) FROM {PROMO_TABLE}",
    "promo_year": (f"SELECT d_year, COUNT(*), MAX(lo_quantity) FROM "
                   f"{PROMO_TABLE} GROUP BY d_year ORDER BY d_year"),
}
SCHED_TENANTS = {"dashboard": "adv_day", "adhoc": "adv_dense"}
SCHED_THREADS = 2        # threads a tenant
SCHED_QUERIES = 6        # queries a thread


def adv_literals(name: str, i: int) -> tuple:
    """The i-th execution's (lo, hi) lo_orderdate literals of ``name``."""
    if name == "adv_dense":
        return 19920101 + i, 19981228
    lo = (1993 + i % 5) * 10000 + (1 + (3 * i) % 12) * 100 + 10 + i % 10
    return lo, lo + (2 if name == "adv_days3" else 0)


def adv_sql(name: str, i: int) -> str:
    lo, hi = adv_literals(name, i)
    return ADV_QUERIES[name].format(lo=lo, hi=hi)


def adv_oracle(bs_data: list) -> dict:
    """The advisor path's answers from the sorted table: per (query,
    execution) the rows and numDocsScanned, each a row range of the
    lo_orderdate order (searchsorted), and the fault phase's q6 over the
    first FAULT_SEGMENTS segments."""
    c = {k: np.concatenate([d[k] for d in bs_data])
         for k in ("lo_orderdate", "lo_discount", "lo_quantity",
                   "lo_revenue", "lo_custkey")}
    od = c["lo_orderdate"]
    qty = c["lo_quantity"].astype(np.int64)
    rev = c["lo_revenue"].astype(np.int64)
    want = {}
    n_dense = max(ADV_DENSE_RUNS, SCHED_THREADS * SCHED_QUERIES)
    n_sel = max(ADV_RUNS, SCHED_THREADS * SCHED_QUERIES)
    # the unselective ranges share their end: one bincount over the
    # widest range, less each run's short head
    lo0, hi = adv_literals("adv_dense", 0)
    a0, b = np.searchsorted(od, lo0, "left"), np.searchsorted(od, hi, "right")
    disc, q_ = c["lo_discount"][a0:b], qty[a0:b]
    cnt0 = np.bincount(disc, minlength=11)
    sum0 = np.bincount(disc, weights=q_, minlength=11)
    for i in range(n_dense):
        a = np.searchsorted(od, adv_literals("adv_dense", i)[0], "left")
        h = slice(0, a - a0)
        cnt = cnt0 - np.bincount(disc[h], minlength=11)
        sums = sum0 - np.bincount(disc[h], weights=q_[h], minlength=11)
        want[("adv_dense", i)] = (
            [[k, int(cnt[k]), float(sums[k])] for k in range(11) if cnt[k]],
            int(cnt.sum()))
    for name in ("adv_day", "adv_days3", "adv_trim"):
        for i in range(n_sel if name != "adv_trim" else ADV_RUNS):
            lo, hi = adv_literals(name, i)
            s = slice(np.searchsorted(od, lo, "left"),
                      np.searchsorted(od, hi, "right"))
            n = s.stop - s.start
            if name == "adv_day":
                rows = [[n, float(qty[s].sum())]]
            elif name == "adv_days3":
                rows = [[n, float(qty[s].sum()), float(rev[s].max())]]
            else:
                m = qty[s] == 1
                cust, r = c["lo_custkey"][s][m], rev[s][m]
                sums = np.bincount(cust, weights=r.astype(np.float64),
                                   minlength=100_000)
                keys = np.flatnonzero(np.bincount(cust, minlength=100_000))
                top = sorted(keys, key=lambda k: (-sums[k], k))[:10]
                rows, n = [[int(k), float(sums[k])] for k in top], int(m.sum())
            want[(name, i)] = (rows, n)
    f = {k: np.concatenate([d[k] for d in bs_data[:FAULT_SEGMENTS]])
         for k in ("d_year", "s_nation", "lo_revenue", "lo_quantity",
                   "lo_discount")}
    m = (f["lo_discount"] >= 1) & (f["lo_discount"] <= 3)
    want["fault_q6"] = (_q6_rows(f, m), int(m.sum()))
    return want


def adv_check(label: str, got_rows, got_docs: int, want: tuple) -> None:
    if not rows_equal(got_rows, want[0]) or got_docs != want[1]:
        raise AssertionError(f"{label}: rows {got_rows[:3]} "
                             f"numDocsScanned {got_docs}, want "
                             f"{want[0][:3]} / {want[1]}")


class count_syncs:
    """Counts the torch ops of a block that read the device from the host
    (a scalar read, or an op whose output shape depends on the data)
    while it is entered, at the dispatcher."""

    OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2")

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.__name__.split(".")[0] in outer.OPS:
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n = 0
        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def adv_partial(engine, sql: str) -> tuple:
    """A server's partial of ``sql`` over lineorder_by_date
    (``execute_segments``, not terminal): (rows after the server trim,
    numDocsScanned, the stats, the advisor's stamps)."""
    from pinot_tpu_torch.engine.reduce import finalize, trim_group_by

    q = compile_query(engine, sql)
    merged = engine.execute_segments(q, table_segs(engine, BS_TABLE),
                                     terminal=False)
    st = merged.stats
    stats = {k: getattr(st, k) for k in (
        "num_docs_scanned", "num_entries_scanned_in_filter",
        "num_entries_scanned_post_filter", "num_segments_queried",
        "num_segments_processed", "num_segments_matched",
        "num_segments_pruned", "num_blocks_pruned", "total_docs")}
    return (finalize(q, trim_group_by(q, merged)).rows,
            st.num_docs_scanned, stats, list(st.advisor_decisions))


def adv_drive(engine, want: dict, total: int, n_blocks: int) -> dict:
    """The advised executions, each against the oracle and its ``SET
    useAdvisor = false`` twin (rows and every stat): which execution
    carried which stamp, K4's candidate bound per execution, the dense
    form's verdict / compaction calls and device reads, the trim's
    fetched bytes."""
    from pinot_tpu_torch.ops import blockskip as bs
    from pinot_tpu_torch.ops import group_scatter as ps

    seen = {"k4_B": [], "verdict": 0, "compact": 0}
    real = {"fused_filter_agg": ps.fused_filter_agg,
            "zone_verdict": bs.zone_verdict,
            "compact_candidates": bs.compact_candidates}

    def spy_k4(cand, *a, **k):
        seen["k4_B"].append(int(cand.shape[0]))
        return real["fused_filter_agg"](cand, *a, **k)

    def spy_verdict(*a, **k):
        seen["verdict"] += 1
        return real["zone_verdict"](*a, **k)

    def spy_compact(*a, **k):
        seen["compact"] += 1
        return real["compact_candidates"](*a, **k)

    ps.fused_filter_agg = spy_k4
    bs.zone_verdict, bs.compact_candidates = spy_verdict, spy_compact
    out = {}
    try:
        for name in ("adv_day", "adv_days3", "adv_dense", "adv_trim"):
            runs = ADV_DENSE_RUNS if name == "adv_dense" else ADV_RUNS
            notes, bounds, forms, syncs, fetched = [], [], [], [], []
            for i in range(runs):
                sql = adv_sql(name, i)
                twin_sql = "SET useAdvisor = false; " + sql
                mark = (len(seen["k4_B"]), seen["verdict"], seen["compact"])
                b0 = engine.device.fetch_bytes_total

                def advised_form():
                    # K4's bounds, verdicts and compactions of the advised
                    # execution alone
                    k4_ = seen["k4_B"][mark[0]:]
                    bounds.append(k4_[0] if len(k4_) == 1 else None)
                    forms.append((seen["verdict"] - mark[1],
                                  seen["compact"] - mark[2]))

                if name == "adv_trim":
                    rows, docs, stats, stamps = adv_partial(engine, sql)
                    advised_form()
                    b1 = engine.device.fetch_bytes_total
                    t_rows, _d, t_stats, t_stamps = adv_partial(engine,
                                                                twin_sql)
                    fetched.append((b1 - b0,
                                    engine.device.fetch_bytes_total - b1))
                else:
                    with count_syncs() as sy:
                        resp = engine.execute(sql)
                    advised_form()
                    with count_syncs() as sy_twin:
                        twin = engine.execute(twin_sql)
                    syncs.append((sy.n, sy_twin.n))
                    for r in (resp, twin):
                        if r["exceptions"]:
                            raise AssertionError(f"{name}[{i}]: "
                                                 f"{r['exceptions']}")
                    rows, docs = resp["resultTable"]["rows"], \
                        resp["numDocsScanned"]
                    stats = {k: resp[k] for k in ADV_STATS}
                    t_rows, t_stats = twin["resultTable"]["rows"], \
                        {k: twin[k] for k in ADV_STATS}
                    stamps = resp.get("advisorDecisions") or []
                    t_stamps = twin.get("advisorDecisions") or []
                    if resp["totalDocs"] != total:
                        raise AssertionError(f"{name}[{i}]: totalDocs "
                                             f"{resp['totalDocs']}")
                adv_check(f"{name}[{i}]", rows, docs, want[(name, i)])
                if t_rows != rows or t_stats != stats or t_stamps:
                    raise AssertionError(
                        f"{name}[{i}]: its useAdvisor = false twin differs: "
                        f"{t_rows[:3]} {t_stats} {t_stamps} vs {rows[:3]} "
                        f"{stats}")
                stamp = next((s for s in stamps if ADV_STAMPS[name] in s),
                             None)
                notes.append(stamp)
            first = next((i for i, s in enumerate(notes) if s), None)
            if first != ADV_MIN_SAMPLES:
                raise AssertionError(f"{name}: first stamped at execution "
                                     f"{first}, want {ADV_MIN_SAMPLES}: "
                                     f"{notes}")
            out[name] = {"stamps": notes, "k4_B": bounds, "syncs": syncs,
                         "verdict_compact": forms, "fetched": fetched}
            log(f"{name}: {runs} executions equal the oracle and their "
                f"useAdvisor = false twins (rows and {len(ADV_STATS)} "
                f"stats); stamps {[s for s in notes if s][:1]} from "
                f"execution {first}")
    finally:
        ps.fused_filter_agg = real["fused_filter_agg"]
        bs.zone_verdict = real["zone_verdict"]
        bs.compact_candidates = real["compact_candidates"]
    # K4 at the default bound before the advice, at the advised one after
    default_B = -(-n_blocks // 16)
    for name in ("adv_day", "adv_days3"):
        r = out[name]
        frac = int(re.search(r"candBound=1/(\d+)", r["stamps"][-1]).group(1))
        want_B = [default_B] * ADV_MIN_SAMPLES + \
            [min(n_blocks, -(-n_blocks // frac))] * (ADV_RUNS - ADV_MIN_SAMPLES)
        if r["k4_B"] != want_B:
            raise AssertionError(f"{name}: K4's candidate bounds "
                                 f"{r['k4_B']}, want {want_B}")
        r["fraction"] = frac
        log(f"{name}: K4 launched at B = {r['k4_B']} (1/16, then the "
            f"advised 1/{frac} of {n_blocks} blocks)")
    # the dense form: no verdict, no compaction, one device read fewer
    d = out["adv_dense"]
    for i, s in enumerate(d["stamps"]):
        adv_s, twin_s = d["syncs"][i]
        if s and (d["verdict_compact"][i] != (0, 0) or adv_s >= twin_s):
            raise AssertionError(f"adv_dense[{i}]: verdict / compaction "
                                 f"calls {d['verdict_compact'][i]}, device "
                                 f"reads {adv_s} advised vs {twin_s}")
    probes = [i for i, s in enumerate(d["stamps"]) if i >= ADV_MIN_SAMPLES
              and not s]
    if probes != [ADV_MIN_SAMPLES + 15]:
        raise AssertionError(f"adv_dense: re-probes at {probes}, want the "
                             f"16th decision ({ADV_MIN_SAMPLES + 15})")
    log(f"adv_dense: device reads per query, advised vs twin: "
        f"{d['syncs'][ADV_MIN_SAMPLES]}; re-probe at execution {probes[0]}")
    t = out["adv_trim"]
    for i, s in enumerate(t["stamps"]):
        if s and not t["fetched"][i][0] < t["fetched"][i][1]:
            raise AssertionError(f"adv_trim[{i}]: fetched {t['fetched'][i]}")
    log(f"adv_trim: fetched bytes advised vs twin "
        f"{t['fetched'][ADV_MIN_SAMPLES]}")
    return out


def adv_p50(engine, runs: int) -> dict:
    """Each template's p50 advised and as its useAdvisor = false twin, in
    alternating order (the memos are converged)."""
    out = {}
    for name in ADV_QUERIES:
        sql = adv_sql(name, ADV_RUNS - 1)
        twin = "SET useAdvisor = false; " + sql
        run = (lambda s: adv_partial(engine, s)) if name == "adv_trim" \
            else engine.execute
        times = {sql: [], twin: []}
        for _ in range(runs):
            for s in (sql, twin, twin, sql):
                t = time.perf_counter()
                run(s)
                times[s].append((time.perf_counter() - t) * 1e3)
        out[name] = {"advised_p50_ms": float(np.percentile(times[sql], 50)),
                     "twin_p50_ms": float(np.percentile(times[twin], 50))}
        log(f"{name}: p50 {out[name]['advised_p50_ms']:.3f} ms advised, "
            f"{out[name]['twin_p50_ms']:.3f} ms its useAdvisor = false twin "
            f"({2 * runs} runs each)")
    return out


def fault_phase(bs_segs: list, want: dict, device: str = "cuda") -> dict:
    """Injected faults on q6's shape over lineorder_by_date's first
    FAULT_SEGMENTS segments (their own engine, so a rebuilt batch is
    small): a launch failing once is retried and answers (K1 and K2 run
    again on the rebuilt batch), failing twice quarantines the pair and
    is refused in-band until ``reset_quarantine()``, a fetch failure is
    refused in-band with the batch evicted and the next query rebuilds
    it. No real device error is provoked. (``device="cpu"`` rehearses it
    on the host, where no launch is counted.)"""
    from pinot_tpu_torch.common import faults
    from pinot_tpu_torch.engine.engine import QueryEngine

    eng = QueryEngine(device=device)
    if device == "cpu":
        eng.device.min_rows = 0
    eng.device.partials_cache_enabled = False
    eng.device.advisor = None
    for s in bs_segs[:FAULT_SEGMENTS]:
        eng.add_segment(BS_TABLE, s)
    dev = eng.device
    tables = launch_tables()
    out = {}

    def run():
        before = dict(tables["kernels"])
        resp = eng.execute(FAULT_Q6)
        made = {k: tables["kernels"][k] - before[k]
                for k in ("group_plane_sums", "group_minmax")}
        return resp, made

    def answers(label, resp, made):
        if resp["exceptions"]:
            raise AssertionError(f"{label}: {resp['exceptions']}")
        adv_check(label, resp["resultTable"]["rows"], resp["numDocsScanned"],
                  want["fault_q6"])
        if device != "cpu" and min(made.values()) < 1:
            raise AssertionError(f"{label}: launches {made}")

    def refused(label, resp, word):
        msg = " ".join(e["message"] for e in resp["exceptions"])
        if word not in msg:
            raise AssertionError(f"{label}: want an in-band refusal naming "
                                 f"{word!r}, got {resp}")
        return msg

    answers("fault_q6 (warm)", *run())
    faults.clear()
    try:
        # a launch failing once: evicted, rebuilt, retried on the card
        ev, miss = dev.batch_evictions, dev.batch_misses
        f = faults.install(faults.Fault(point="device.launch", times=1))
        resp, made = run()
        answers("fault_q6 (launch fails once)", resp, made)
        if (f.fired, dev.launch_failures, dev.batch_evictions - ev,
                dev.batch_misses - miss,
                dev.hbm_stats()["quarantined_pipelines"]) != (1, 1, 1, 1, 0):
            raise AssertionError(f"launch once: fired {f.fired}, failures "
                                 f"{dev.launch_failures}, evictions "
                                 f"{dev.batch_evictions - ev}, misses "
                                 f"{dev.batch_misses - miss}")
        out["launch_once"] = {"launch_failures": dev.launch_failures,
                              "k1_k2": made}
        # failing twice: quarantined, refused in-band, no further attempt
        faults.clear()
        f = faults.install(faults.Fault(point="device.launch", times=2))
        msg = refused("launch twice", run()[0], "quarantined")
        again = refused("quarantined", run()[0], "quarantined")
        if f.fired != 2 or dev.hbm_stats()["quarantined_pipelines"] != 1:
            raise AssertionError(f"launch twice: fired {f.fired}, "
                                 f"{dev.hbm_stats()}")
        dev.reset_quarantine()
        answers("fault_q6 (after reset_quarantine)", *run())
        out["launch_twice"] = {"launch_failures": dev.launch_failures,
                               "refusal": msg, "while_quarantined": again}
        # a fetch failure: refused in-band, the batch evicted, rebuilt
        faults.clear()
        ev, miss = dev.batch_evictions, dev.batch_misses
        f = faults.install(faults.Fault(point="device.fetch", times=1))
        msg = refused("fetch", run()[0], "device fetch failed")
        if dev.batch_evictions - ev != 1 \
                or dev.hbm_stats()["cached_batches"] != 0:
            raise AssertionError(f"fetch: evictions {dev.batch_evictions - ev}"
                                 f", {dev.hbm_stats()['cached_batches']} "
                                 f"batches cached")
        answers("fault_q6 (after the fetch failure)", *run())
        if dev.batch_misses - miss != 1:
            raise AssertionError("fetch: the next query did not rebuild")
        out["fetch"] = {"launch_failures": dev.launch_failures,
                        "refusal": msg}
    finally:
        faults.clear()
    out["promotion"] = promotion_fault(eng)
    log(f"fault phase: {json.dumps(out)}")
    return out


def promotion_fault(eng) -> dict:
    """A consuming table of its own fed PROMO_ROWS rows from the memory
    stream's fetch: the first PROMO_FAILS promotions fail, ingestion goes
    on and every answer equals the oracle; the next promotion catches the
    frozen prefix up."""
    from pinot_tpu_torch.common import faults
    from pinot_tpu_torch.common.table_config import (
        ChunkletConfig,
        StreamConfig,
        TableConfig,
        TableType,
    )
    from pinot_tpu_torch.realtime.manager import llc_segment_name
    from pinot_tpu_torch.storage.mutable import MutableSegment
    from pinot_tpu_torch.stream.spi import StreamPartitionMsgOffset

    d = rt_generate(PROMO_ROWS, PROMO_SEED)
    stream = RowStream(records(d, 0, PROMO_ROWS))
    cfg = TableConfig(
        table_name=PROMO_TABLE, table_type=TableType.REALTIME,
        stream=StreamConfig(stream_type="memory", topic=PROMO_TABLE,
                            segment_flush_threshold_rows=RT_ROWS),
        chunklets=ChunkletConfig(enabled=True, rows_per_chunklet=RT_CHUNKLET,
                                 device_min_rows=RT_DEVICE_MIN))
    seg = MutableSegment(lo_schema(PROMO_TABLE),
                         llc_segment_name(PROMO_TABLE, 0, 0, "0"), cfg)
    eng.add_segment(PROMO_TABLE, seg)

    def check(n):
        rev, year = d["lo_revenue"][:n].astype(np.int64), d["d_year"][:n]
        q = d["lo_quantity"][:n]
        want = {"promo_count_sum": [[n, float(rev.sum())]],
                "promo_year": [[int(y), int((year == y).sum()),
                                float(q[year == y].max())]
                               for y in np.unique(year)]}
        for name, sql in PROMO_QUERIES.items():
            resp = eng.execute(sql)
            if resp["exceptions"] or not rows_equal(
                    resp["resultTable"]["rows"], want[name]) \
                    or resp["numDocsScanned"] != n:
                raise AssertionError(f"{name} at {n} rows: {resp}")

    f = faults.install(faults.Fault(point="chunklet.promote",
                                    times=PROMO_FAILS))
    try:
        first = PROMO_FAILS * RT_FETCH
        offset = rt_consume(seg, stream, StreamPartitionMsgOffset(0), first)
        if f.fired != PROMO_FAILS or seg.chunklet_index.chunklets:
            raise AssertionError(f"promotion: fired {f.fired}, "
                                 f"{len(seg.chunklet_index.chunklets)} "
                                 f"chunklets")
        check(first)
        rt_consume(seg, stream, offset, PROMO_ROWS)
    finally:
        faults.clear()
    chunklets = len(seg.chunklet_index.chunklets)
    if chunklets != PROMO_ROWS // RT_CHUNKLET:
        raise AssertionError(f"promotion: {chunklets} chunklets after the "
                             f"faults cleared")
    check(PROMO_ROWS)
    return {"failed_promotions": PROMO_FAILS, "rows": PROMO_ROWS,
            "chunklets": chunklets}


def scheduler_phase(engine, want: dict) -> dict:
    """Two tenants on threads through a TokenBucketScheduler over the
    card's engine: every answer equals the oracle; each tenant's p50."""
    import threading

    from pinot_tpu_torch.engine.scheduler import TokenBucketScheduler

    sched = TokenBucketScheduler(max_concurrent=2, max_queued=64,
                                 rate_ms_per_s=500.0, burst_ms=1000.0)
    lat = {t: [] for t in SCHED_TENANTS}
    errors = []
    barrier = threading.Barrier(len(SCHED_TENANTS) * SCHED_THREADS)

    def tenant(name, query, k):
        try:
            barrier.wait(60)
            for j in range(SCHED_QUERIES):
                i = k * SCHED_QUERIES + j
                t = time.perf_counter()
                resp = sched.run(lambda: engine.execute(adv_sql(query, i)),
                                 group=name)
                lat[name].append((time.perf_counter() - t) * 1e3)
                if resp["exceptions"]:
                    raise AssertionError(f"{query}[{i}]: "
                                         f"{resp['exceptions']}")
                adv_check(f"{name}: {query}[{i}]",
                          resp["resultTable"]["rows"],
                          resp["numDocsScanned"], want[(query, i)])
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=tenant, args=(name, q, k))
               for name, q in SCHED_TENANTS.items()
               for k in range(SCHED_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    if errors:
        raise errors[0]
    gs = sched.group_stats()
    out = {name: {"p50_ms": float(np.percentile(lat[name], 50)),
                  "executed": gs[name]["executed"]} for name in SCHED_TENANTS}
    log(f"scheduler phase: {json.dumps(out)}")
    return out


def run_advisor(engine, bs_segs: list, want: dict, total: int,
                runs: int) -> tuple:
    """The advisor path: a fresh plan advisor on the engine, the advised
    executions with the launch counts zeroed before and read after (K1
    and K4 must launch), K4 held bit for bit at an advised execution's
    captured inputs, the p50s, then the fault and scheduler phases; the
    advisor is off again after. Returns (summary, launches, K4's check)."""
    from pinot_tpu_torch.engine.advisor import PlanAdvisor

    engine.device.advisor = PlanAdvisor()
    try:
        ctx = engine.device.batch_for(bs_segs)
        n_blocks = ctx.S * (ctx.pad_to // 4096)
        tables = launch_tables()
        for table in tables.values():
            for key in table:
                table[key] = 0
        drive = adv_drive(engine, want, total, n_blocks)
        counts = {k: dict(v) for k, v in tables.items()}
        log(f"advisor path launches: {json.dumps(counts)}")
        for name in ("group_plane_sums", "fused_filter_agg"):
            if counts["kernels"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"advisor path")
        frac = drive["adv_day"]["fraction"]
        args = capture_fused(engine, adv_sql("adv_day", ADV_RUNS))
        if args[0].shape[0] != min(n_blocks, -(-n_blocks // frac)):
            raise AssertionError(f"adv_day: K4 captured at B = "
                                 f"{args[0].shape[0]}, not the advised 1/"
                                 f"{frac} of {n_blocks} blocks")
        k4 = check_k4(f"the advisor path's adv_day at the advised 1/{frac}",
                      *args)
        p50 = adv_p50(engine, runs)
        scheduler = scheduler_phase(engine, want)
        snapshot = engine.device.advisor.snapshot()
    finally:
        engine.device.advisor = None
    fault = fault_phase(bs_segs, want)
    summary = {"drive": {k: {kk: v[kk] for kk in ("stamps", "k4_B",
                                                   "syncs", "fetched")}
                         for k, v in drive.items()},
               "p50": p50, "scheduler": scheduler, "faults": fault,
               "advisor": {k: snapshot[k] for k in ("memos", "observations",
                                                     "decisions",
                                                     "overrides")}}
    return summary, counts["kernels"], k4


# every path, in the order a run takes them (``--paths`` selects some);
# the serving, advisor and mesh paths run after the others
ALL_PATHS = [p for p in PATHS if p != "mesh"] + ["serving", "advisor", "mesh",
                                                 "cluster", "exchange",
                                                 "tier", "fleet", "minion"]
# the tables each path reads: lineorder ("lo") and the others
PATH_TABLES = {
    "ssb": {"lo"}, "hll": {"lo"}, "startree": {"lo"}, "sketch": {"lo"},
    "blockskip": {"lo", "bs"}, "selection": {"lo", "bs"},
    "highcard": {"lo", "pairs"}, "mv": {"lo", "mv"},
    "index": {"lo", "events"}, "values": {"lo", "v2", "mv"},
    "tail": {"lo", "trips"}, "realtime": {"lo", "rt", "up"},
    "multistage": {"lo", "rt", "dims", "mv"}, "serving": {"lo", "bs"},
    "advisor": {"bs"}, "mesh": {"lo", "bs", "rt", "dims"},
    "cluster": {"lo", "bs", "dims"},
    # ROADMAP m3's phases run on the cluster path's registry and tables
    "exchange": {"lo", "bs", "dims"}, "tier": {"lo", "bs", "dims"},
    "fleet": {"lo", "bs", "dims"}, "minion": {"lo", "bs", "dims"},
}


def mesh_devices() -> list:
    """The mesh the path runs on: cuda:0 MESH_REPEAT times, then every
    further visible card once."""
    import torch

    return [torch.device("cuda", 0)] * MESH_REPEAT + [
        torch.device("cuda", i) for i in range(1, torch.cuda.device_count())]


class count_shards:
    """While entered, attributes each kernel launch a mesh launch makes to
    the shard that made it (its place among the shards the launch runs:
    engine/device.py runs them in mesh order), into
    ``MESH_SHARD_LAUNCHES``."""

    def __init__(self, n: int):
        self.n = n

    def __enter__(self):
        from pinot_tpu_torch.engine import cohort as cohort_mod
        from pinot_tpu_torch.engine import device as device_mod
        from pinot_tpu_torch.ops import kernels

        self.mods = (device_mod, cohort_mod)
        self.real = (device_mod.build_pipeline, cohort_mod.run,
                     device_mod.DeviceExecutor._run_mesh)
        MESH_SHARD_LAUNCHES[:] = [{k: 0 for k in MESH_SHARD_KERNELS}
                                  for _ in range(self.n)]
        pos = [0]
        real_build, real_run, real_mesh = self.real

        active = [False]

        def attribute(fn, *a, **kw):
            if not active[0]:
                return fn(*a, **kw)
            before = dict(kernels.launches)
            out = fn(*a, **kw)
            shard = MESH_SHARD_LAUNCHES[pos[0] % self.n]
            for k in MESH_SHARD_KERNELS:
                shard[k] += kernels.launches[k] - before[k]
            pos[0] += 1
            return out

        def build(*a, **kw):
            pipe = real_build(*a, **kw)
            return lambda *x, **y: attribute(pipe, *x, **y)

        def run_mesh(ex, *a, **kw):
            pos[0], active[0] = 0, True
            try:
                return real_mesh(ex, *a, **kw)
            finally:
                active[0] = False

        device_mod.build_pipeline = build
        cohort_mod.run = lambda *a, **kw: attribute(real_run, *a, **kw)
        device_mod.DeviceExecutor._run_mesh = run_mesh
        return self

    def __exit__(self, *exc):
        device_mod, cohort_mod = self.mods
        (device_mod.build_pipeline, cohort_mod.run,
         device_mod.DeviceExecutor._run_mesh) = self.real
        return False


def mesh_want(engine) -> dict:
    """The single-device engine's answers to the mesh path's queries, run
    now, as the oracle entries the mesh engine is held to: rows, docs
    scanned, totalDocs and the join's stats."""
    want = {}
    for name, sql in {**MESH_QUERIES, **MESH_COHORT}.items():
        resp = engine.execute(sql)
        if resp["exceptions"]:
            raise AssertionError(f"{name} on one device: "
                                 f"{resp['exceptions']}")
        extra = {"totalDocs": resp["totalDocs"]}
        for key in ("numJoinedRows", "leafRows", "numSegmentsMatched"):
            if key in resp:
                extra[key] = resp[key]
        want[name] = (resp["resultTable"]["rows"], resp["numDocsScanned"],
                      extra)
    return want


def mesh_engine_for(engine, mesh):
    """A second engine over the single one's segment objects, its executor
    on ``mesh``: lineorder, the sorted copy, lineorder_rt (its consuming
    segment too) and SSB's dimensions."""
    from pinot_tpu_torch.engine.device import DeviceExecutor
    from pinot_tpu_torch.engine.engine import QueryEngine

    eng = QueryEngine(device_executor=DeviceExecutor(mesh=mesh))
    # as the single engine: every shard launches the forms it counts
    eng.device.partials_cache_enabled = False
    eng.device.advisor = None
    for table in ("lineorder", BS_TABLE, RT_TABLE, "customer", "supplier",
                  "dates"):
        for seg in table_segs(engine, table):
            eng.add_segment(table, seg)
        if engine.table(table).is_dim_table:
            eng.table(table).is_dim_table = True
    return eng


def mesh_cohort(mesh_eng, want: dict, on_card: bool = True) -> dict:
    """MESH_COHORT released together through a forced window on the mesh
    engine: one member-axis launch per shard (K1's member entry under each
    shard), then a combine, a trim and a fetch per member; each member
    equal to the single device's answer."""
    import threading

    from pinot_tpu_torch.ops import kernels

    co = mesh_eng.device.coalescer
    names = list(MESH_COHORT)
    got, errors = {}, []
    barrier = threading.Barrier(len(names))

    def member(name):
        try:
            barrier.wait()
            got[name] = mesh_eng.execute(MESH_COHORT[name])
        except BaseException as e:  # noqa: BLE001 — raised after join
            errors.append(e)

    before = dict(kernels.launches)
    c0 = (co.cohorts_launched, co.queries_coalesced)
    cap = co.max_cohort
    co.force, co.window_s, co.max_cohort = True, 0.05, len(names)
    try:
        threads = [threading.Thread(target=member, args=(n,)) for n in names]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        co.force, co.window_s, co.max_cohort = False, 0.003, cap
    if errors:
        raise errors[0]
    for name in names:
        check_answer(name, got[name], want, 0)
    launched = co.cohorts_launched - c0[0]
    joined = co.queries_coalesced - c0[1]
    member_launches = kernels.launches["group_plane_sums_members"] \
        - before["group_plane_sums_members"]
    if (launched, joined) != (1, len(names) - 1) or (
            on_card and member_launches <= 0):
        raise AssertionError(f"mesh cohort: cohorts_launched +{launched}, "
                             f"queries_coalesced +{joined} (want +1 and "
                             f"+{len(names) - 1}), {member_launches} "
                             f"member-axis K1 launches")
    log(f"mesh cohort: {len(names)} members in one cohort, "
        f"{member_launches} member-axis K1 launches (one a shard), "
        f"{wall:.3f} ms; every member equals the single device's answer")
    return {"members": len(names), "wall_ms": wall,
            "member_k1_launches": member_launches}


def combine_ms(mesh_eng, sql: str) -> float:
    """One more execution on the mesh, its combine timed: the summed
    wall of parallel/mesh.py ``combine_outs`` (the shards' accumulators
    copied to the first device and reduced), the card synchronized around
    each call."""
    import torch
    from pinot_tpu_torch.parallel import mesh as mesh_ops

    real, spent = mesh_ops.combine_outs, [0.0]

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        spent[0] += (time.perf_counter() - t) * 1e3
        return out

    mesh_ops.combine_outs = timed
    try:
        mesh_eng.execute(sql)
    finally:
        mesh_ops.combine_outs = real
    return spent[0]


def run_mesh(engine, runs: int, profile: bool) -> tuple:
    """The mesh path: a mesh engine over the single engine's segments, each
    query held to the single device's answer from this run (integers
    exact, floats within ``rows_equal``), the kernels' launches counted
    per shard (each shard must launch each kernel the path needs), the
    cohort, and per query the p50 on the mesh and on one device and the
    combine's ms. Returns (summary, kernel launches)."""
    from pinot_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(mesh_devices())
    t = time.perf_counter()
    want = mesh_want(engine)
    mesh_eng = mesh_engine_for(engine, mesh)
    log(f"mesh path: {mesh}, single-device answers in "
        f"{time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    with count_shards(mesh.size):
        p50, launches = run_path(mesh_eng, "mesh", want, 0, runs, profile)
        cohort = mesh_cohort(mesh_eng, want)
    for d, shard in enumerate(MESH_SHARD_LAUNCHES):
        if any(shard[k] <= 0 for k in MESH_SHARD_KERNELS):
            raise AssertionError(f"mesh shard {d} never launched every "
                                 f"kernel of the path: {shard}")
    log(f"mesh path: launches per shard {json.dumps(MESH_SHARD_LAUNCHES)}; "
        f"{time.perf_counter() - t:.2f} s")
    per_query = {}
    for name, sql in MESH_QUERIES.items():
        times = []
        for _ in range(runs):
            t = time.perf_counter()
            engine.execute(sql)
            times.append((time.perf_counter() - t) * 1e3)
        single = float(np.percentile(times, 50))
        rec = {"mesh_p50_ms": p50[name], "single_p50_ms": single,
               "combine_ms": combine_ms(mesh_eng, sql)}
        per_query[name] = rec
        log(f"{name}: mesh p50 {p50[name]:.3f} ms, one device "
            f"{single:.3f} ms, combine {rec['combine_ms']:.3f} ms")
    hbm = mesh_eng.device.hbm_stats()
    summary = {"mesh": list(mesh.key), "queries": per_query,
               "cohort": cohort, "shard_launches": MESH_SHARD_LAUNCHES,
               "resident_bytes": hbm["resident_bytes"]}
    return summary, launches


# ---------------------------------------------------------------------------
# the serving path: cohorts, the partials cache, deadlines, traces, ANALYZE
# ---------------------------------------------------------------------------


def compile_query(engine, sql: str):
    """``sql`` compiled as ``QueryEngine.execute`` compiles it."""
    from pinot_tpu_torch.query.optimizer import optimize_query
    from pinot_tpu_torch.query.rewrite import expand_star
    from pinot_tpu_torch.sql.compiler import compile_select
    from pinot_tpu_torch.sql.parser import parse_sql

    q = optimize_query(compile_select(parse_sql(sql)))
    return expand_star(q, table_segs(engine, q.table_name)[0].column_names())


def canonical(resp: dict) -> dict:
    """A response without its timing, cache and roofline fields: what a
    coalesced member must share with its solo run."""
    return {k: v for k, v in resp.items()
            if k not in ("timeUsedMs", "partialsCacheHit", "deviceBytesMoved",
                         "deviceKernelMs", "deviceLinkMs", "roofline")}


def check_answer(name: str, resp: dict, want: dict, total: int) -> None:
    """One response against the oracle ``want[name]`` = (rows or their
    own check, numDocsScanned[, extra stats]): rows, numDocsScanned,
    totalDocs (``total`` unless the extra stats name it) and the pruning
    and scan stats the oracle names (``scan_docs`` is a cube query's
    scan twin's, not checked here)."""
    if resp["exceptions"]:
        raise AssertionError(f"{name}: {resp['exceptions']}")
    rows_want, scanned = want[name][:2]
    extra = dict(want[name][2]) if len(want[name]) > 2 else {}
    extra.pop("scan_docs", None)
    want_total = extra.pop("totalDocs", total)
    got = resp["resultTable"]["rows"]
    if callable(rows_want):   # an approximate answer's own check
        rows_want(got)
    elif not rows_equal(got, rows_want):
        raise AssertionError(f"{name}: rows {got[:5]} want {rows_want[:5]}")
    if resp["numDocsScanned"] != scanned or resp["totalDocs"] != want_total:
        raise AssertionError(f"{name}: numDocsScanned {resp['numDocsScanned']}"
                             f" / totalDocs {resp['totalDocs']}, want "
                             f"{scanned} / {want_total}")
    for key, val in extra.items():
        if resp[key] != val:
            raise AssertionError(f"{name}: {key} {resp[key]}, want {val}")


class capture_members:
    """Records every call of the member-axis wrappers (ops/kernels.py
    ``*_members``) while it is entered: {entry: [(args, kwargs)]}."""

    def __init__(self):
        self.calls = {name: [] for name in SERVE_ENTRIES}
        self._saved = {}

    def __enter__(self):
        from pinot_tpu_torch.ops import kernels

        for name in SERVE_ENTRIES:
            real = self._saved[name] = getattr(kernels, name)

            def spy(*args, _real=real, _name=name, **kwargs):
                self.calls[_name].append((args, kwargs))
                return _real(*args, **kwargs)

            setattr(kernels, name, spy)
        return self

    def __exit__(self, *exc):
        from pinot_tpu_torch.ops import kernels

        for name, real in self._saved.items():
            setattr(kernels, name, real)
        return False


def _same_outputs(got, want, float_rows=()) -> tuple:
    """(bit-equal, max abs err) of two kernel outputs (nested tuples of
    tensors); ``float_rows`` of a K1 output are held to rtol 1e-6."""
    import torch

    if isinstance(got, (tuple, list)):
        pairs = [(g, w) for g, w in zip(got, want)
                 if g is not None or w is not None]
        res = [_same_outputs(g, w) for g, w in pairs]
        return all(r[0] for r in res), max((r[1] for r in res), default=0.0)
    err = float((got.double() - want.double()).abs().max()) \
        if got.numel() else 0.0
    if float_rows:
        ints = [a for a in range(got.shape[1]) if a not in float_rows]
        same = torch.equal(got[:, ints], want[:, ints]) and torch.allclose(
            got[:, list(float_rows)], want[:, list(float_rows)], rtol=1e-6,
            atol=0.0)
        return same, err
    if got.is_floating_point():
        return torch.equal(got.view(torch.int32), want.view(torch.int32)), err
    return torch.equal(got, want), err


def check_member_entry(name: str, args, kwargs) -> dict:
    """One member-axis entry at a cohort's captured inputs: against its
    plain version (integer rows bit for bit; K1's float planes rtol 1e-6),
    with CUDA-event times of the entry, of M solo launches over the same
    members and of the plain version, one PyTorch call of the same
    function over member-offset ids where there is one, and the bound:
    the members' own operands read once each, the shared planes once, the
    outputs written once."""
    import torch
    from pinot_tpu_torch.ops import kernels

    entry = getattr(kernels, name)
    plain = getattr(kernels, name + "_plain")
    got = entry(*args, **kwargs)
    want = plain(*args, **{k: v for k, v in kwargs.items() if k != "span"})
    torch.cuda.synchronize()
    float_rows = ()
    if name == "group_plane_sums_members":
        gid, sources, G = args
        count = kwargs.get("count", False)
        layout = kernels.plane_layout(sources, count)
        float_rows = tuple(a for a, (region, _r) in enumerate(layout)
                           if region == "flt" and not any(
                               s.kind == "bf16" for s in sources))
    same, err = _same_outputs(got, want, float_rows)
    if not same:
        raise AssertionError(f"{name} differs from its plain version at the "
                             f"cohort's inputs, max abs err {err}")
    del got, want
    ms = cuda_ms(lambda: entry(*args, **kwargs), 10)
    plain_ms = cuda_ms(lambda: plain(*args, **{
        k: v for k, v in kwargs.items() if k != "span"}), 2)
    lib_ms = None
    if name == "group_plane_sums_members":
        gid, sources, G = args
        M, n = gid.shape[0], gid[0].numel()

        def solo():
            for m in range(M):
                kernels.group_plane_sums(
                    gid[m], [kernels.PlaneSource(
                        kernels._member_slice(s.values, m, M, n), s.kind,
                        s.nplanes, s.plus, kernels._member_scalar(s.minus, m))
                        for s in sources], G, count=count)
        ids = (gid.reshape(M, -1).long() + torch.arange(
            M, device=gid.device)[:, None] * (G + 1)).reshape(-1)
        vals = ([torch.ones(M * n, dtype=torch.float64, device=gid.device)]
                if count else []) + [
            torch.broadcast_to(s.values.reshape(-1, n).to(torch.float64),
                               (M, n)).reshape(-1) for s in sources]
        V = torch.stack(vals)
        del vals
        lib_out = torch.zeros((V.shape[0], M * (G + 1)), dtype=torch.float64,
                              device=gid.device)
        lib_ms = cuda_ms(lambda: lib_out.index_add_(1, ids, V), 3)
        del V, lib_out, ids
        A = len(layout)
        nbytes = 4 * M * n + sum(s.values.numel() * s.values.element_size()
                                 for s in sources) + 8 * M * A * G
        ops = M * n * A
        shape = f"M={M} n={n} G={G} A={A}"
    elif name == "group_minmax_members":
        gid, sources, G = args
        M, n = gid.shape[0], gid[0].numel()

        def solo():
            for m in range(M):
                kernels.group_minmax_sources(gid[m].reshape(-1), [
                    dataclasses.replace(s, values=kernels._member_slice(
                        s.values, m, M, n)) for s in sources], G)
        ids = (gid.reshape(M, -1).long() + torch.arange(
            M, device=gid.device)[:, None] * (G + 1)).reshape(-1)
        decoded = [torch.broadcast_to(kernels.minmax_decode(s).reshape(-1, n),
                                      (M, n)).reshape(-1) for s in sources]
        outs = [torch.empty(M * (G + 1), dtype=s.dtype, device=gid.device)
                for s in sources]

        def library():
            for v, s, o in zip(decoded, sources, outs):
                for op, fill in zip(s.ops, s.fills):
                    o.fill_(fill).scatter_reduce_(0, ids, v, "a" + op)
        lib_ms = cuda_ms(library, 3)
        del decoded, outs, ids
        cells = sum(len(s.ops) for s in sources)
        nbytes = 4 * M * n + sum(s.values.numel() * s.values.element_size()
                                 for s in sources) + 4 * M * cells * G
        ops = M * n * cells
        shape = f"M={M} n={n} G={G} cells={cells}"
    elif name == "hll_register_max_members":
        h, log2m, M = args[:3]
        G = kwargs.get("num_groups", args[3] if len(args) > 3 else 1)
        gid, mask = kwargs.get("gid"), kwargs.get("mask")
        by = gid if gid is not None else mask
        n = by.numel() // M

        def solo():
            for m in range(M):
                kernels.hll_register_max(
                    kernels._member_slice(h, m, M, n), log2m, G,
                    gid=None if gid is None
                    else kernels._member_slice(gid, m, M, n),
                    mask=None if mask is None
                    else kernels._member_slice(mask, m, M, n))
        from pinot_tpu_torch.ops.hll import hll_slots

        slot, rho = hll_slots(torch.broadcast_to(h.reshape(-1, n), (M, n)),
                              log2m, G, gid, mask)
        nslots = G << log2m
        ids = (slot.long() + torch.arange(M, device=h.device)[:, None]
               * (nslots + 1)).reshape(-1)
        rho = rho.reshape(-1)
        lib_out = torch.zeros(M * (nslots + 1), dtype=torch.int32,
                              device=h.device)
        lib_ms = cuda_ms(lambda: lib_out.scatter_reduce_(0, ids, rho, "amax"),
                         3)
        del slot, rho, ids, lib_out
        nbytes = h.numel() * 4 + sum(t.numel() * t.element_size()
                                     for t in (gid, mask) if t is not None) \
            + 4 * M * nslots
        ops = M * n
        shape = f"M={M} n={n} slots={nslots}"
    else:   # fused_filter_agg_members
        cand, rows_in, cols, lits, prog, aggs, ki, kf = args
        M, B = cand.shape

        def solo():
            for m in range(M):
                kernels.fused_filter_agg(cand[m], rows_in[m], cols, lits[m],
                                         prog, aggs, ki, kf)
        rows = int(rows_in.sum())
        nbytes = rows * sum(c.element_size() for c in cols) + 8 * M * B \
            + 4 * M * B * (ki + kf) + lits.numel() * 4
        ops = rows * (len(prog) + len(aggs) + 1)
        shape = f"M={M} B={B} rows={rows} planes={len(cols)}"
    solo_ms = cuda_ms(solo, 3)
    b, by = bound_ms(nbytes, ops)
    out = dict(shape=shape, max_abs_err=err, ms=ms, solo_ms=solo_ms,
               plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms)
    if lib_ms is None:
        out["library_is"] = "none: no single PyTorch call computes K4's " \
                            "function"
    log(f"{name} at the cohort's inputs ({shape}): {ms:.4f} ms, {solo_ms:.4f} "
        f"ms for the same members as solo launches, plain {plain_ms:.4f} ms, "
        f"library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, bound "
        f"{b:.4f} ms ({by}); bit-exact" + (", float planes within rtol 1e-6"
                                           if float_rows else ""))
    return out


def serve_cohort(engine, cohort: str, want: dict, total: int,
                 on_card: bool) -> tuple:
    """One cohort: each member solo with the coalescer off, then all
    released together through a forced window that closes when the last
    member has joined (``max_cohort``), then SERVE_RELEASES more passes of
    each, timed: the solo members one after another, and the release.
    Every member must equal its solo answer (stats included) and the
    oracle on every release. The first release must be ONE cohort that
    every member joined, and on the card it must launch each member-axis
    entry it reaches exactly once (the counts zeroed before and read
    after); each entry is held against its plain version at the captured
    inputs. The p50 of the walls and of the leader's ``deviceKernelMs``
    (the CUDA-event span of the cohort's launch) are printed. Returns
    (summary, entry records)."""
    import threading

    queries, expected = SERVE_COHORTS[cohort]
    ex = engine.device
    co = ex.coalescer
    names = list(queries)
    co.enabled = False
    # the members' first runs upload what they read: the passes after
    # them are timed
    solo = {name: engine.execute(sql) for name, sql in queries.items()}
    solo_walls = []
    for _ in range(SERVE_RELEASES):
        t = time.perf_counter()
        for sql in queries.values():
            engine.execute(sql)
        solo_walls.append((time.perf_counter() - t) * 1e3)
    co.enabled = True
    for name, resp in solo.items():
        check_answer(name, resp, want, total)

    def release() -> tuple:
        """Every member at once through a forced window: (answers, wall
        ms)."""
        got, errors = {}, []
        barrier = threading.Barrier(len(names))

        def member(name):
            try:
                barrier.wait()
                got[name] = engine.execute(queries[name])
            except BaseException as e:  # noqa: BLE001 — raised after join
                errors.append(e)

        cap = co.max_cohort
        co.force, co.window_s, co.max_cohort = True, 0.05, len(names)
        try:
            threads = [threading.Thread(target=member, args=(n,))
                       for n in names]
            t0 = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            co.force, co.window_s, co.max_cohort = False, 0.003, cap
        if errors:
            raise errors[0]
        for name in names:
            if canonical(got[name]) != canonical(solo[name]):
                raise AssertionError(f"{name}: the coalesced answer differs "
                                     f"from its solo run: {got[name]} vs "
                                     f"{solo[name]}")
            check_answer(name, got[name], want, total)
        kernel = max(r["deviceKernelMs"] for r in got.values())
        return got, wall, kernel

    tables = launch_tables()
    for table in tables.values():
        for key in table:
            table[key] = 0
    c0 = (co.cohorts_launched, co.queries_coalesced)
    with capture_members() as cap:
        release()
    counts = {k: dict(v) for k, v in tables.items()}
    launched = co.cohorts_launched - c0[0]
    joined = co.queries_coalesced - c0[1]
    # one cohort, every member in it: a member that ran apart (say the
    # range past the candidate bound, whose dense form launches no
    # kernel) would leave the launch counts as they are
    if (launched, joined) != (1, len(names) - 1):
        raise AssertionError(f"{cohort}: cohorts_launched +{launched}, "
                             f"queries_coalesced +{joined}, want +1 and "
                             f"+{len(names) - 1}")
    walls, kernel_walls = [], []
    for _ in range(SERVE_RELEASES):
        _got, wall, kernel = release()
        walls.append(wall)
        kernel_walls.append(kernel)
    cohort_ms = float(np.percentile(walls, 50))
    kernel_ms = float(np.percentile(kernel_walls, 50))
    solo_ms = float(np.percentile(solo_walls, 50))
    records = {}
    if on_card:
        for entry in SERVE_ENTRIES:
            made = counts["kernels"][entry]
            if made != expected.get(entry, 0):
                raise AssertionError(f"{cohort}: {made} launches of {entry}, "
                                     f"want {expected.get(entry, 0)}")
        solo_made = {k: counts["kernels"][SERVE_ENTRIES[k][0]]
                     for k in expected}
        if any(solo_made.values()):
            raise AssertionError(f"{cohort}: solo launches beside the "
                                 f"cohort's: {solo_made}")
        for entry, calls in cap.calls.items():
            for args, kwargs in calls:
                records[entry] = check_member_entry(entry, args, kwargs)
    cap.calls.clear()
    summary = {"members": len(names), "cohorts_launched": launched,
               "queries_coalesced": joined, "releases": SERVE_RELEASES,
               "cohort_wall_p50_ms": cohort_ms,
               "cohort_kernel_p50_ms": kernel_ms,
               "solo_walls_p50_ms": solo_ms,
               "launches": {k: v for k, v in counts["kernels"].items() if v}}
    log(f"{cohort}: {len(names)} members equal their solo answers and the "
        f"oracle on {1 + SERVE_RELEASES} releases; the first one cohort "
        f"launch, {joined} members joined, launches {summary['launches']}; "
        f"over {SERVE_RELEASES} releases cohort wall p50 {cohort_ms:.3f} ms "
        f"(its launch's device span p50 {kernel_ms:.3f}), against p50 "
        f"{solo_ms:.3f} ms for the members one after another")
    return summary, records


def serve_partials(engine, want: dict, total: int, on_card: bool) -> dict:
    """q1 run SERVE_REPEATS times, three rounds, the cache emptied before
    each: the first run misses, the rest hit (partialsCacheHit, the same
    rows, no kernel launched). Returns the miss's and the hit's p50."""
    from pinot_tpu_torch.ops import kernels

    ex = engine.device
    sql = QUERIES["q1_scan_agg"]
    ex.partials_cache_enabled = True
    miss, hit = [], []
    try:
        for _round in range(3):
            ex.invalidate_partials("")
            h0, m0 = ex.partials_hits, ex.partials_misses
            for i in range(SERVE_REPEATS):
                before = sum(kernels.launches.values())
                t = time.perf_counter()
                resp = engine.execute(sql)
                ms = (time.perf_counter() - t) * 1e3
                made = sum(kernels.launches.values()) - before
                check_answer("q1_scan_agg", resp, want, total)
                if resp["partialsCacheHit"] != (i > 0):
                    raise AssertionError(f"serve_partials run {i}: "
                                         f"partialsCacheHit "
                                         f"{resp['partialsCacheHit']}")
                if on_card and (made == 0) != (i > 0):
                    raise AssertionError(f"serve_partials run {i}: {made} "
                                         f"kernel launches")
                (hit if i else miss).append(ms)
            if (ex.partials_hits - h0, ex.partials_misses - m0) \
                    != (SERVE_REPEATS - 1, 1):
                raise AssertionError("serve_partials: hits / misses "
                                     f"{ex.partials_hits - h0} / "
                                     f"{ex.partials_misses - m0}")
    finally:
        ex.partials_cache_enabled = False
    out = {"miss_p50_ms": float(np.percentile(miss, 50)),
           "hit_p50_ms": float(np.percentile(hit, 50)),
           "misses": len(miss), "hits": len(hit)}
    log(f"serve_partials: q1 misses once and hits {SERVE_REPEATS - 1} times "
        f"a round (3 rounds): miss p50 {out['miss_p50_ms']:.3f} ms, hit p50 "
        f"{out['hit_p50_ms']:.3f} ms, no kernel launched on a hit")
    return out


def serve_deadline(engine) -> None:
    """An already expired Deadline: the fetch raises QueryTimeout before
    it waits, and the batch pin is released."""
    from pinot_tpu_torch.common.deadline import Deadline, QueryTimeout

    ex = engine.device
    q = compile_query(engine, QUERIES["q1_scan_agg"])
    fetch = engine.execute_segments_async(q, table_segs(engine, "lineorder"),
                                          terminal=True,
                                          deadline=Deadline(0.0))
    try:
        fetch()
    except QueryTimeout:
        pass
    else:
        raise AssertionError("serve_deadline: an expired deadline fetched")
    if ex.inflight != 0 or ex._inflight_launches:
        raise AssertionError(f"serve_deadline: inflight {ex.inflight}, pins "
                             f"{ex._inflight_launches}")
    log("serve_deadline: an expired Deadline raised QueryTimeout before the "
        "fetch's wait; inflight 0, no batch pinned")


def serve_trace(engine) -> None:
    """A traced execute_segments_async of q1 fetched on another thread
    records the six phases."""
    import threading

    from pinot_tpu_torch.common.trace import Tracer

    q = compile_query(engine, QUERIES["q1_scan_agg"])
    tracer = Tracer("serve")
    fetch = engine.execute_segments_async(q, table_segs(engine, "lineorder"),
                                          terminal=True, tracer=tracer)
    box = []
    th = threading.Thread(target=lambda: box.append(fetch()))
    th.start()
    th.join(120)
    if not box:
        raise AssertionError("serve_trace: the fetch thread returned nothing")
    spans = tracer.to_json()
    phases = {s["phase"] for s in spans}
    for need in ("gather", "dispatch", "device_fetch", "kernel", "link",
                 "merge"):
        if not any(p == need or p.endswith("." + need) for p in phases):
            raise AssertionError(f"serve_trace: no {need} span in {phases}")
    log("serve_trace: " + ", ".join(f"{s['phase']} {s['durationMs']} ms"
                                    for s in spans))


def serve_analyze(engine, on_card: bool) -> list:
    """EXPLAIN ANALYZE of q1 and bs_month_fused: analyzedResponse equals
    the plain answer, and each KERNEL line carries GB/s and the percentage
    of the probed peak. Returns the roofline records."""
    records = []
    for name, sql in (("q1_scan_agg", QUERIES["q1_scan_agg"]),
                      ("bs_month_fused", BS_QUERIES["bs_month_fused"])):
        plain = engine.execute(sql)
        resp = engine.execute(sql.replace("SELECT", "EXPLAIN ANALYZE SELECT",
                                          1))
        if resp["exceptions"]:
            raise AssertionError(f"serve_analyze {name}: {resp['exceptions']}")
        lines = [r[0] for r in resp["resultTable"]["rows"]]
        analyzed = resp["analyzedResponse"]
        if analyzed["resultTable"] != plain["resultTable"]:
            raise AssertionError(f"serve_analyze {name}: analyzedResponse "
                                 f"differs from the plain answer")
        kernel_lines = [ln for ln in lines if ln.strip().startswith("KERNEL(")]
        recs = analyzed.get("roofline") or []
        if not kernel_lines or len(kernel_lines) != len(recs):
            raise AssertionError(f"serve_analyze {name}: KERNEL lines "
                                 f"{kernel_lines}, records {recs}")
        if on_card and not all("gbps" in r and "pctOfPeak" in r
                               and "% of HBM peak" in ln
                               for r, ln in zip(recs, kernel_lines)):
            raise AssertionError(f"serve_analyze {name}: {kernel_lines}")
        records.extend(recs)
        for ln in lines:
            log(f"serve_analyze {name}: {ln}")
    return records


def serve_probe(card: str, records: list) -> float:
    """The memory probe's GB/s beside the card, within PROBE_MAX_OF_PEAK
    of HBM_BYTES_PER_S; no record above 105 % of it."""
    from pinot_tpu_torch.ops import roofline

    peak = roofline.hbm_peak_gbps()
    limit = PROBE_MAX_OF_PEAK * HBM_BYTES_PER_S / 1e9
    if not 0 < peak <= limit:
        raise AssertionError(f"probe: {peak} GB/s, want (0, {limit}]")
    worst = max((r.get("pctOfPeak") or 0.0 for r in records), default=0.0)
    if worst > 100 * PROBE_MAX_OF_PEAK:
        raise AssertionError(f"probe: a record at {worst} % of the peak")
    log(f"probe: {peak:.3f} GB/s ({roofline.PROBE_BYTES >> 20} MiB a side, "
        f"best of 5 CUDA-event copies) on {card}; highest pctOfPeak of "
        f"{len(records)} records {worst}")
    return peak


def serve_syncs(engine) -> dict:
    """The synchronizations one launch of each serving query makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    import torch

    ex = engine.device
    out = {}
    sqls = {"q1_scan_agg": QUERIES["q1_scan_agg"]}
    for queries, _e in SERVE_COHORTS.values():
        name, sql = next(iter(queries.items()))
        sqls[name] = sql
    for name, sql in sqls.items():
        q = compile_query(engine, sql)
        segs = table_segs(engine, q.table_name)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                handle = ex.launch(q, segs, final=True,
                                   reduce_mode="terminal")
            finally:
                torch.cuda.set_sync_debug_mode(0)
        ex.fetch(handle)
        out[name] = sum(1 for w in seen if "synchroniz" in str(w.message))
    log(f"serve_syncs (synchronizing calls in one launch): {out}")
    return out


def serve_sweep(engine) -> dict:
    """Printed, not gated: q1-shaped queries with distinct literals from 1,
    2, 4 and 8 threads, with the coalescer on and off: queries per second
    and p50."""
    import threading

    ex = engine.device
    co = ex.coalescer
    out = {}
    for coalesce in (True, False):
        co.enabled = coalesce
        for T in SERVE_SWEEP_THREADS:
            lat, errors = [], []
            per = max(1, SERVE_SWEEP_QUERIES // T)

            def worker(k):
                try:
                    for j in range(per):
                        lit = 1 + (k * per + j) % 48
                        t = time.perf_counter()
                        r = engine.execute(SERVE_K1.format(lit=lit))
                        lat.append((time.perf_counter() - t) * 1e3)
                        if r["exceptions"]:
                            errors.append(r["exceptions"])
                except BaseException as e:  # noqa: BLE001
                    errors.append(e)

            c0 = co.cohorts_launched
            threads = [threading.Thread(target=worker, args=(k,))
                       for k in range(T)]
            t = time.perf_counter()
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            wall = time.perf_counter() - t
            if errors:
                raise AssertionError(f"serve_sweep: {errors[0]}")
            key = f"{'on' if coalesce else 'off'}_{T}"
            out[key] = {"qps": len(lat) / wall,
                        "p50_ms": float(np.percentile(lat, 50)),
                        "cohorts": co.cohorts_launched - c0}
            log(f"serve_sweep coalescer {'on' if coalesce else 'off'}, {T} "
                f"threads: {out[key]['qps']:.3f} queries/s, p50 "
                f"{out[key]['p50_ms']:.3f} ms, {out[key]['cohorts']} cohorts")
    co.enabled = True
    return out


def run_serving(engine, want: dict, totals: dict, card: str) -> tuple:
    """The serving path (see the module docstring): the four cohorts,
    serve_partials, serve_deadline, serve_trace, serve_analyze, the probe,
    the synchronizations and the sweep. Returns (summary, the member-axis
    entries' records, their launches on the path)."""
    on_card = engine.device.device.type == "cuda"
    engine.device.partials_cache_enabled = False
    summary, records = {}, {}
    launches = {name: 0 for name in SERVE_ENTRIES}
    for cohort in SERVE_COHORTS:
        table = BS_TABLE if cohort == "serve_cohort_k4" else "lineorder"
        s, recs = serve_cohort(engine, cohort, want, totals[table], on_card)
        summary[cohort] = s
        for name, rec in recs.items():
            records.setdefault(name, dict(rec, cohort=cohort))
        for name in launches:
            launches[name] += s["launches"].get(name, 0)
    summary["serve_partials"] = serve_partials(engine, want,
                                               totals["lineorder"], on_card)
    serve_deadline(engine)
    serve_trace(engine)
    roofs = serve_analyze(engine, on_card)
    if on_card:
        summary["probe_gbps"] = serve_probe(card, roofs)
        summary["syncs"] = serve_syncs(engine)
    summary["sweep"] = serve_sweep(engine)
    log(f"serving path: {json.dumps(summary)}")
    return summary, records, launches


# ---------------------------------------------------------------------------
# the cluster path: the registry, the controller, two servers and a broker
# behind its HTTP front door, every server's kernels on the card
# ---------------------------------------------------------------------------

CLUSTER_SERVERS = 2               # both on cuda:0: one card stands in for two
CLUSTER_BATCH_BYTES = 24 << 30    # each server's batch budget, 2 x 24 GiB
CL_RT_TABLE = "lineorder_cl"
CL_RT_ROWS = 1_000_000
CL_RT_FLUSH = 500_000             # the flush threshold: two commits
CL_RT_SEED = 83
CL_DAY = 19930315
# a week of the sorted copy: the broker sends its one segment, where the
# week's blocks stay under block skip's bound (a month's pass it on one
# segment of 3,052 blocks, and take the dense form): K4 under a server
CL_WEEK = (19930301, 19930307)
CL_QUERIES = {
    **QUERIES,
    "hll_scalar": HLL_QUERIES["hll_scalar"],
    "hll_small_group": HLL_QUERIES["hll_small_group"],
    "bs_month_fused": BS_QUERIES["bs_month_fused"],
    "cl_week_fused": BS_QUERIES["bs_month_fused"].replace(
        "19930301 AND 19930328", "%d AND %d" % CL_WEEK),
    # q1 over the sorted copy: its segments sit one replica each, half on
    # either server, so the broker merges two servers' partials
    "cl_bs_q1": QUERIES["q1_scan_agg"].replace("FROM lineorder",
                                               f"FROM {BS_TABLE}"),
    "pct_scalar": SK_QUERIES["pct_scalar"],
    # the multistage path's ms_nation_region over a week: stage 1 through
    # the servers, stage 2 at the broker on the card. Each stage-1 row
    # crosses the wire and the broker's selection reduce (~5 us a row on
    # the CPU), so a month's 1.19M rows would take ~10 s a query
    "cl_star_week": MS_QUERIES["ms_nation_region"].replace(
        MS_MONTH, "lo.lo_orderdate BETWEEN %d AND %d" % CL_WEEK),
}
CL_EXPLAIN = "EXPLAIN PLAN FOR " + QUERIES["q6_minmax"]
CL_STREAM = (f"SELECT lo_suppkey, lo_revenue FROM {BS_TABLE} "
             f"WHERE lo_orderdate = {CL_DAY} LIMIT 1000000")
CL_RT_QUERIES = {
    "cl_rt_q1": _RT_Q1.format(t=CL_RT_TABLE),
    "cl_rt_count": (f"SELECT COUNT(*), SUM(lo_revenue), MAX(lo_orderdate) "
                    f"FROM {CL_RT_TABLE}"),
}
CL_KERNELS = ("group_plane_sums", "group_minmax", "hll_register_max",
              "fused_filter_agg", "cluster_sums")
# the stats every broker answer is held to beside rows, numDocsScanned and
# totalDocs, where the oracle names them
CL_STATS = ("numEntriesScannedInFilter", "numBlocksPruned",
            "numJoinedRows", "leafRows")
BATCH_STATS = ("numEntriesScannedInFilter", "numBlocksPruned")


def cl_oracle(data: list, bs_data: list, dims: dict, pad: int,
              want: dict) -> dict:
    """The cluster path's answers: those no selected path's oracle gave
    (bs_month_fused, pct_scalar when their paths do not run), q1's over
    the sorted copy, the star join and the K4 form over a week, and the
    day the stream selects."""
    out = {}
    if "bs_month_fused" not in want:
        out["bs_month_fused"] = bs_oracle(bs_data, pad)["bs_month_fused"]
    rev = np.concatenate([d["lo_revenue"] for d in data])
    if "pct_scalar" not in want:
        delta, p = SK_DIGESTS["pct_scalar"]
        out["pct_scalar"] = (_rank_checker("pct_scalar", [(None, rev)],
                                           p / 100, delta), len(rev))
    cust = np.concatenate([d["lo_custkey"] for d in data])
    supp = np.concatenate([d["lo_suppkey"] for d in data])
    od = np.concatenate([d["lo_orderdate"] for d in data])
    qty = np.concatenate([d["lo_quantity"] for d in data])
    cu, su = dims["customer"], dims["supplier"]
    c_nat = np.full(CUSTOMERS + 1, -1, dtype=np.int64)
    c_nat[cu["c_custkey"]] = np.searchsorted(NATIONS, cu["c_nation"])
    s_reg = np.full(SUPPLIERS + 1, -1, dtype=np.int64)
    s_reg[su["s_suppkey"]] = np.searchsorted(REGIONS, su["s_region"])
    week = (od >= CL_WEEK[0]) & (od <= CL_WEEK[1])
    tot = {"lo": len(od), "c": len(cu["c_custkey"]),
           "s": len(su["s_suppkey"])}
    out["cl_star_week"] = _ms_nation_region(
        c_nat[cust[week]], s_reg[supp[week]], rev[week].astype(np.int64),
        qty[week], tot)
    q1 = want.get("q1_scan_agg") or oracle(data)["q1_scan_agg"]
    out["cl_bs_q1"] = q1
    od = np.concatenate([d["lo_orderdate"] for d in bs_data])
    m = od == CL_DAY
    supp = np.concatenate([d["lo_suppkey"] for d in bs_data])[m]
    r = np.concatenate([d["lo_revenue"] for d in bs_data])[m]
    out["cl_stream"] = sorted(zip(supp.tolist(), r.tolist()))
    m = (od >= CL_WEEK[0]) & (od <= CL_WEEK[1])
    qty = np.concatenate([d["lo_quantity"] for d in bs_data])[m]
    r = np.concatenate([d["lo_revenue"] for d in bs_data])[m]
    out["cl_week_fused"] = ([[int(m.sum()), float(qty.sum()),
                              float(r.min()), float(r.max())]], int(m.sum()))
    return out


def cl_rt_oracle(rt: dict) -> dict:
    """The realtime table's answers over every row the stream produced."""
    supp, rev = rt["lo_suppkey"], rt["lo_revenue"].astype(np.int64)
    n = len(supp)
    extra = {"totalDocs": n}
    return {"cl_rt_q1": (_q1_rows(_supp_sums(supp, rev)), n, extra),
            "cl_rt_count": ([[n, float(rev.sum()),
                              float(rt["lo_orderdate"].max())]], n, extra)}


class HttpFront:
    """The broker's HTTP front door as a user posts to it: SQL to
    ``/query/sql``, a selection streamed from ``/query/sql/stream``."""

    def __init__(self, url: str):
        self.url = url

    def _post(self, path: str, sql: str):
        import urllib.request

        req = urllib.request.Request(
            self.url + path, data=json.dumps({"sql": sql}).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=600)

    def execute(self, sql: str) -> dict:
        with self._post("/query/sql", sql) as r:
            return json.loads(r.read())

    def stream(self, sql: str) -> tuple:
        """(rows, the final line) of a streamed selection."""
        rows, final = [], None
        with self._post("/query/sql/stream", sql) as r:
            for line in r:
                msg = json.loads(line)
                if msg["type"] == "rows":
                    rows.extend(msg["rows"])
                elif msg["type"] == "final":
                    final = msg
        return rows, final


class count_roles:
    """While entered, attributes each kernel launch to the cluster role
    on whose thread it runs: a server (its query's launch and fetch run
    on its transport thread) or the broker (stage 2). ``kernels.launches``
    is replaced by a dict that also adds to ``per[role]``."""

    def __init__(self, servers):
        self.servers = servers
        self.per = {r: {k: 0 for k in CL_KERNELS}
                    for r in [s.instance_id for s in servers] + ["broker"]}

    def __enter__(self):
        import threading

        from pinot_tpu_torch.ops import kernels

        local, per = threading.local(), self.per

        class Counting(dict):
            def __setitem__(self, key, value):
                role = getattr(local, "role", None) or "broker"
                if key in per[role] and value > self.get(key, 0):
                    per[role][key] += value - self.get(key, 0)
                super().__setitem__(key, value)

        def tagged(role, fn):
            def run(*a, **kw):
                old, local.role = getattr(local, "role", None), role
                try:
                    return fn(*a, **kw)
                finally:
                    local.role = old
            return run

        self.real = kernels.launches
        kernels.launches = Counting(self.real)
        self.saved = []
        for s in self.servers:
            eng = s.engine
            real = eng.execute_segments_async

            def launch(*a, _real=real, _role=s.instance_id, **kw):
                return tagged(_role, tagged(_role, _real)(*a, **kw))

            self.saved.append((eng, real))
            eng.execute_segments_async = launch
            # a distributed stage-2 slice runs on the server's thread
            s._execute_stage_inner = tagged(s.instance_id,
                                            s._execute_stage_inner)
        return self

    def __exit__(self, *exc):
        from pinot_tpu_torch.ops import kernels

        self.real.update(kernels.launches)
        kernels.launches = self.real
        for eng, _real in self.saved:
            del eng.execute_segments_async
        for s in self.servers:
            del s._execute_stage_inner
        return False


class spy_broker:
    """While entered, the broker's reduce seconds (its merge and finalize)
    and the DataTable bytes it decodes, summed since ``reset``."""

    def __enter__(self):
        from pinot_tpu_torch.broker import broker as broker_mod

        self.mod, self.reduce_s, self.bytes = broker_mod, 0.0, 0
        self.real = (broker_mod.decode, broker_mod.merge_intermediates,
                     broker_mod.finalize)
        real_decode, real_merge, real_finalize = self.real

        def decode(data):
            self.bytes += len(data)
            return real_decode(data)

        def timed(fn):
            def run(*a, **kw):
                t = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.reduce_s += time.perf_counter() - t
            return run

        broker_mod.decode = decode
        broker_mod.merge_intermediates = timed(real_merge)
        broker_mod.finalize = timed(real_finalize)
        return self

    def reset(self) -> None:
        self.reduce_s, self.bytes = 0.0, 0

    def __exit__(self, *exc):
        (self.mod.decode, self.mod.merge_intermediates,
         self.mod.finalize) = self.real
        return False


def cl_check(name: str, resp: dict, want: dict, total: int,
             whole: bool = True) -> None:
    """A broker answer against the oracle: rows, numDocsScanned, totalDocs
    and ``CL_STATS``; a segment the oracle has pruned by the server may be
    pruned by the broker instead (its metadata), so those two add up, and
    totalDocs then counts the segments the broker sent. ``whole``: every
    server queried responded (a failover's retry answers for the one
    that did not)."""
    entry = want[name]
    extra = dict(entry[2]) if len(entry) > 2 else {}
    pruned = extra.pop("numSegmentsPrunedByServer", None)
    kept = {k: v for k, v in extra.items()
            if k in CL_STATS or k == "totalDocs"}
    by_broker = resp.get("numSegmentsPrunedByBroker", 0)
    if by_broker:
        # the broker sent the pruned segments nowhere: totalDocs counts
        # the others (the tables' segments hold the same rows each), and
        # block skip's bound and so its stats follow the smaller batch
        queried = resp["numSegmentsQueried"]
        total = total * queried // (queried + by_broker)
        for key in BATCH_STATS:
            kept.pop(key, None)
    check_answer(name, resp, {name: (entry[0], entry[1], kept)}, total)
    if pruned is not None:
        got = resp["numSegmentsPrunedByServer"] \
            + resp.get("numSegmentsPrunedByBroker", 0)
        if got != pruned:
            raise AssertionError(f"{name}: {got} segments pruned, want "
                                 f"{pruned}")
    if resp.get("partialResult") or (whole and resp["numServersResponded"]
                                     != resp["numServersQueried"]):
        raise AssertionError(f"{name}: partial answer {resp}")


def cl_tables(controller, dirs, bs_dirs, dim_dirs, dim_schemas) -> None:
    """The offline tables, as written: lineorder at replication 2,
    lineorder_by_date at 1, the dimensions replicated to every server;
    each segment pushed where it lies (no deep-store copy)."""
    from pinot_tpu_torch.common.table_config import (
        IndexingConfig,
        StarTreeIndexConfig,
        TableConfig,
    )

    trees = [StarTreeIndexConfig(dimensions_split_order=d,
                                 function_column_pairs=p)
             for d, p in STAR_TREES]
    for table, seg_dirs, repl, idx in (
            ("lineorder", dirs, 2, IndexingConfig(star_tree_configs=trees)),
            (BS_TABLE, bs_dirs, 1, IndexingConfig())):
        if not seg_dirs:
            continue
        controller.add_table(TableConfig(table_name=table, replication=repl,
                                         indexing=idx), lo_schema(table))
        for d in seg_dirs:
            controller.upload_segment(table, d, copy_to_deep_store=False)
    for name, d in dim_dirs.items():
        controller.add_table(TableConfig(table_name=name, is_dim_table=True),
                             dim_schemas[name])
        controller.upload_segment(name, d, copy_to_deep_store=False)


def cl_wait(cond, what: str, timeout: float = 300.0) -> float:
    t = time.perf_counter()
    while not cond():
        if time.perf_counter() - t > timeout:
            raise AssertionError(f"cluster: {what} not reached in "
                                 f"{timeout:.0f} s")
        time.sleep(0.05)
    return time.perf_counter() - t


def cl_realtime(controller, registry, front, rt: dict) -> dict:
    """A REALTIME table fed through the in-memory stream (JSON records,
    one partition) at a 500,000-row flush threshold: its segments commit
    through the controller's completion FSM while the broker queries it;
    at quiescence its answers must equal the oracle over every row."""
    from pinot_tpu_torch.common.table_config import (
        StreamConfig,
        TableConfig,
        TableType,
    )
    from pinot_tpu_torch.stream.memory_stream import TopicRegistry

    TopicRegistry.delete(CL_RT_TABLE)
    topic = TopicRegistry.create(CL_RT_TABLE, 1)
    cfg = TableConfig(
        table_name=CL_RT_TABLE, table_type=TableType.REALTIME,
        stream=StreamConfig(
            stream_type="memory", topic=CL_RT_TABLE, decoder="json",
            segment_flush_threshold_rows=CL_RT_FLUSH,
            segment_flush_threshold_seconds=3600))
    controller.add_table(cfg, lo_schema(CL_RT_TABLE))
    t = time.perf_counter()
    payloads = [json.dumps(r).encode() for r in
                records(rt, 0, len(rt["lo_suppkey"]))]
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    for p in payloads:
        topic.publish(p)
    sql = CL_RT_QUERIES["cl_rt_count"]
    n, seen, answers = len(payloads), [], 0

    def settled():
        nonlocal answers
        r = front.execute(sql)
        if r.get("exceptions"):
            return False
        answers += 1
        got = r["resultTable"]["rows"][0][0] if r["resultTable"]["rows"] \
            else 0
        if seen and got < seen[-1]:
            raise AssertionError(f"{CL_RT_TABLE}: COUNT(*) went back from "
                                 f"{seen[-1]} to {got}")
        seen.append(got)
        online = sum(rec.state == "ONLINE" for rec in registry.segments(
            f"{CL_RT_TABLE}_REALTIME").values())
        return got == n and online == n // CL_RT_FLUSH

    cl_wait(settled, f"{CL_RT_TABLE}'s {n} rows and commits", 600.0)
    ingest_s = time.perf_counter() - t
    segs = registry.segments(f"{CL_RT_TABLE}_REALTIME")
    log(f"cluster realtime: {n} rows published as JSON ({encode_s:.2f} s "
        f"to encode), consumed and committed in {ingest_s:.2f} s while the "
        f"broker answered {answers} COUNT(*) queries ({seen[0]} … "
        f"{seen[-1]} rows); segments "
        + ", ".join(f"{k} {v.state} {v.n_docs}" for k, v in
                    sorted(segs.items())))
    return {"rows": n, "ingest_s": ingest_s, "queries_while_ingesting":
            answers, "segments": {k: [v.state, v.n_docs]
                                  for k, v in segs.items()}}


def cl_timing(rec: dict) -> str:
    """A cluster query's time as the log gives it: the p50 of its timed
    runs, or its checked (first) execution where it has none."""
    if rec["timed_runs"]:
        return f"p50 {rec['p50_ms']:.3f} ms over {rec['timed_runs']} run(s)"
    return f"no timed run, the checked (first) one {rec['first_ms']:.3f} ms"


def cl_kernels(front, k1: dict, k2: dict, k3: dict, k4: dict, k5: dict,
               chain_ns: float) -> None:
    """K1-K5 at the inputs the servers' engines (and the broker's stage
    2) hand them for the cluster path's queries, captured at their entries
    while the query goes through the front door, each held against its
    plain version."""
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import kernels

    for name in ("q1_scan_agg", "cl_star_week"):
        for (gid, sources, G), kw in capture_calls(
                front, CL_QUERIES[name], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"cluster {name}: G={G}, {planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
    for (gid, srcs, G), _kw in capture_calls(
            front, CL_QUERIES["q6_minmax"], ps, "group_minmax_sources"):
        k2["shapes"].append(k2_shape(
            "cluster q6_minmax: " + ", ".join(
                f"{s.values.dtype} {'+'.join(s.ops)}"
                for s in srcs).replace("torch.", ""), gid, srcs, G))
    k3["sizes"].append(k3_captured(front, CL_QUERIES["hll_small_group"],
                                   "cluster hll_small_group", mm))
    (args, kw), = capture_calls(front, CL_QUERIES["hll_scalar"], ps,
                                "hll_register_max")

    def scalar():
        return ps.hll_register_max(*args, **kw)
    scalar.via = "group_scatter.hll_register_max"
    k3["sizes"].append(k3_held(args[0], kw.get("gid"),
                               kw.get("num_groups", 1), args[1],
                               kw.get("mask"), "cluster hll_scalar", scalar))
    k4["sizes"].append(check_k4(
        "the cluster's cl_week_fused",
        *capture_fused(front, CL_QUERIES["cl_week_fused"])))
    (args, _kw), = capture_calls(front, CL_QUERIES["pct_scalar"], kernels,
                                 "cluster_sums")
    k5["sizes"].append(check_k5("the cluster's pct_scalar", *args,
                                chain_ns))


def run_cluster(engine, dirs, bs_dirs, dim_dirs, dim_schemas: dict,
                want: dict, total: int, runs: int, kernel_records,
                chain_ns: float, device: str = "cuda",
                phases=("cluster",)) -> tuple:
    """The cluster path: a ``ClusterRegistry``, a ``Controller``, two
    ``ServerInstance``s on cuda:0 (real gRPC on localhost) and a ``Broker``
    (stage 2 on cuda:0) behind ``BrokerHttpServer``. The tables the run
    wrote are pushed where they lie; each query goes through the HTTP
    front door and must equal its oracle with the broker's stats; a
    selection streams; the realtime table commits; each kernel's launches
    are counted per server over the path (zeroed before, read after), and
    every kernel must launch; then each kernel is held at the cluster's
    captured inputs, and the failover: one server stops and q1 is
    answered whole from the replica. ``device="cpu"`` rehearses it
    without a card: no launch counts, kernel checks or device memory.

    ``phases``: the cluster path's own queries ("cluster") and ROADMAP
    item m3's phases on the same registry, servers, broker and tables
    (``M3_PATHS``: the exchange, the tiered server, the fleet, the
    minion), in that order, before the failover. Returns (summary,
    launches), the phases' launches added up."""
    import torch
    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.broker.http_api import BrokerHttpServer
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.server.server import ServerInstance

    import grpc

    t_path = time.perf_counter()
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    log(f"cluster path: the wire is gRPC {grpc.__version__} on localhost")
    root = os.path.join(DATA_DIR, "cluster")
    registry = ClusterRegistry()
    controller = Controller(registry, os.path.join(root, "deepstore"))
    servers = [ServerInstance(f"server_{i}", registry,
                              os.path.join(root, f"server_{i}"), device=dev)
               for i in range(CLUSTER_SERVERS)]
    for s in servers:
        s.engine.device.MAX_CACHED_BYTES = CLUSTER_BATCH_BYTES
        # as the embedded engine's paths: no partials cache, no advisor
        s.engine.device.partials_cache_enabled = False
        s.engine.device.advisor = None
        s.start()
    broker = Broker(registry, timeout_s=600.0, device=dev)
    http = BrokerHttpServer(broker)
    http.start()
    front = HttpFront(http.url)
    summary, launches = {"servers": CLUSTER_SERVERS}, {}
    try:
        t = time.perf_counter()
        cl_tables(controller, dirs, bs_dirs, dim_dirs, dim_schemas)
        n_segs = len(dirs) + len(bs_dirs) + len(dim_dirs)

        def loaded():
            ev = [registry.external_view(t) for t in
                  ("lineorder_OFFLINE", f"{BS_TABLE}_OFFLINE",
                   *(f"{d}_OFFLINE" for d in dim_dirs))]
            return sum(len(v) for v in ev) == n_segs and all(
                len(insts) == 2 for insts in ev[0].values())
        cl_wait(loaded, "every server's segments")
        summary["load_s"] = time.perf_counter() - t
        log(f"cluster: {len(dirs)} lineorder segments at replication 2, "
            f"{len(bs_dirs)} {BS_TABLE} segments at 1, "
            f"{len(dim_dirs)} dimension tables on every server, copied "
            f"and loaded in {summary['load_s']:.2f} s")
        launches, rt = {}, None
        if "cluster" in phases:
            _zeroed_launches()
            with count_roles(servers) as roles, spy_broker() as spy:
                tables = launch_tables()
                queries = {}
                for name, sql in CL_QUERIES.items():
                    spy.reset()
                    t = time.perf_counter()
                    resp = front.execute(sql)
                    first_ms = (time.perf_counter() - t) * 1e3
                    cl_check(name, resp, want, total)
                    reduce_ms, dt_bytes = spy.reduce_s * 1e3, spy.bytes
                    times = []
                    for _ in range(TIMED_RUNS.get(name, runs)):
                        t = time.perf_counter()
                        front.execute(sql)
                        times.append((time.perf_counter() - t) * 1e3)
                    queries[name] = {
                        "p50_ms": float(np.percentile(times, 50)) if times
                        else None, "timed_runs": len(times),
                        "first_ms": first_ms, "reduce_ms": reduce_ms,
                        "datatable_bytes": dt_bytes,
                        "servers": resp["numServersResponded"]}
                    if not times:
                        FIRST_RUN_MS[f"cluster {name}"] = first_ms
                    log(f"cluster {name}: matches the oracle through "
                        f"/query/sql ({len(resp['resultTable']['rows'])} rows, "
                        f"numDocsScanned {resp['numDocsScanned']}, "
                        f"{resp['numServersResponded']} server(s)); "
                        f"{cl_timing(queries[name])}"
                        f"; broker reduce {reduce_ms:.3f} ms, {dt_bytes} "
                        f"DataTable bytes")
                summary["queries"] = queries
                resp = front.execute(CL_EXPLAIN)
                rows = (resp.get("resultTable") or {}).get("rows") or []
                if resp.get("exceptions") or not rows \
                        or not rows[0][0].startswith("BROKER_REDUCE"):
                    raise AssertionError(f"cluster EXPLAIN: {resp}")
                log(f"cluster EXPLAIN: {len(rows)} plan rows, "
                    f"{rows[1][0].strip()}")
                t = time.perf_counter()
                rows, final = front.stream(CL_STREAM)
                stream_ms = (time.perf_counter() - t) * 1e3
                if final is None or final.get("exceptions") or sorted(
                        map(tuple, rows)) != want["cl_stream"]:
                    raise AssertionError(f"cluster stream: {len(rows)} rows, "
                                         f"final {final}")
                log(f"cluster stream: {len(rows)} rows of {CL_DAY} through "
                    f"/query/sql/stream in {stream_ms:.3f} ms, the multiset "
                    f"the oracle holds")
                summary["stream"] = {"rows": len(rows), "ms": stream_ms}
                (rt,) = generate(1, CL_RT_ROWS, CL_RT_SEED)
                want.update(cl_rt_oracle(rt))
                summary["realtime"] = cl_realtime(controller, registry, front,
                                                  rt)
                for name, sql in CL_RT_QUERIES.items():
                    resp = front.execute(sql)
                    cl_check(name, resp, want, CL_RT_ROWS)
                    log(f"cluster {name}: at quiescence equals the oracle over "
                        f"the {CL_RT_ROWS} rows produced")
                counts = {k: dict(v) for k, v in tables.items()}
                per_role = {r: dict(c) for r, c in roles.per.items()}
            log(f"cluster path launches: {json.dumps(counts)}; by role "
                f"{json.dumps(per_role)}")
            for name in CL_KERNELS if on_card else ():
                if counts["kernels"][name] <= 0:
                    raise AssertionError(f"kernel {name} never launched on the "
                                         f"cluster path")
            for s in servers if on_card else ():
                if sum(per_role[s.instance_id].values()) <= 0:
                    raise AssertionError(f"{s.instance_id} launched no kernel")
            launches = counts["kernels"]
            summary["launches_by_role"] = per_role
            # the embedded engine over the same tables, outside the counts
            for name, sql in CL_QUERIES.items():
                local = []
                for _ in range(max(1, TIMED_RUNS.get(name, runs))):
                    t = time.perf_counter()
                    engine.execute(sql)
                    local.append((time.perf_counter() - t) * 1e3)
                rec = queries[name]
                rec["embedded_p50_ms"] = float(np.percentile(local, 50))
                rec["embedded_runs"] = len(local)
                log(f"cluster {name}: through the broker {cl_timing(rec)}, "
                    f"embedded p50 {rec['embedded_p50_ms']:.3f} ms over "
                    f"{len(local)} warm run(s)")
            if on_card:
                cl_kernels(front, *kernel_records, chain_ns)
        if "minion" in phases and rt is None:
            # the minion's realtime-to-offline reads lineorder_cl
            (rt,) = generate(1, CL_RT_ROWS, CL_RT_SEED)
            summary["realtime"] = cl_realtime(controller, registry, front,
                                              rt)
        launches = dict(launches)
        records = kernel_records or (None,) * 5

        def add(counts):
            for name, count in counts.items():
                launches[name] = launches.get(name, 0) + count
        if "exchange" in phases:
            week = (summary.get("queries") or {}).get("cl_star_week") or {}
            summary["exchange"], counts = m3_exchange(
                front, broker, servers, want, runs,
                tuple(records[i] for i in (0, 2, 4)), chain_ns,
                week.get("first_ms"), on_card)
            add(counts)
        if "tier" in phases:
            summary["tier"], counts = m3_tier(
                bs_dirs, want, dev, runs, records[:4], on_card)
            add(counts)
        if "fleet" in phases:
            summary["fleet"] = m3_fleet(registry, broker, http, bs_dirs, want,
                                        on_card, dev)
        if "minion" in phases:
            summary["minion"], counts = m3_minion(registry, controller, rt,
                                                  want, dev, on_card)
            add(counts)
        if "cluster" in phases:
            # a server dies: lineorder's replicas answer q1 whole
            victim = servers[1]
            victim.transport.stop(grace=0)
            # the routing's round robin sends the next q1 to one of the two:
            # of two asks, one reaches the victim and is retried on the
            # replica, reported as the reference reports it (the victim
            # queried, the replica alone responded)
            summary["failover"] = []
            for _ in range(2):
                resp = front.execute(CL_QUERIES["q1_scan_agg"])
                cl_check("q1_scan_agg", resp, want, total, whole=False)
                summary["failover"].append({k: resp[k] for k in (
                    "numServersQueried", "numServersResponded", "numRetries")})
            if {"numServersQueried": 2, "numServersResponded": 1,
                    "numRetries": 1} not in summary["failover"]:
                raise AssertionError(f"cluster failover: no retry reached the "
                                     f"replica: {summary['failover']}")
            log(f"cluster failover: {victim.instance_id} stopped; q1 answered "
                f"whole twice: {json.dumps(summary['failover'])}")
        summary["peak_device_bytes"] = torch.cuda.max_memory_allocated() \
            if on_card else None
        summary["path_s"] = time.perf_counter() - t_path
        log(f"cluster path: peak torch.cuda.max_memory_allocated "
            f"{summary['peak_device_bytes']} bytes; "
            f"{summary['path_s']:.2f} s")
    finally:
        http.stop()
        broker.close()
        for s in servers:
            try:
                s.stop(drain_timeout_s=0)
            except Exception:  # noqa: BLE001 — the stopped victim's transport
                pass
    return summary, launches


# ---------------------------------------------------------------------------
# ROADMAP item m3's phases, on the cluster path's registry, tables and
# oracle answers: the distributed stage-2 exchange, the tiers, the broker
# fleet with an OS-process server, the minion
# ---------------------------------------------------------------------------

M3_PATHS = ("exchange", "tier", "fleet", "minion")
_XC = "SET joinStrategy = 'distributed'; "
# one join each (the exchange takes exactly one): a month of lineorder
# (~1.19M joined rows) against customer or supplier
XC_QUERIES = {
    "xc_nation": (
        f"{_XC}SELECT c.c_nation, COUNT(*), SUM(lo.lo_revenue), "
        f"SUM(lo.lo_quantity) FROM {_MS_CM} GROUP BY c.c_nation "
        f"ORDER BY c.c_nation LIMIT 30"),
    "xc_pct_nation": (
        f"{_XC}SELECT c.c_nation, PERCENTILETDIGEST(lo.lo_revenue, 50) "
        f"FROM {_MS_CM} GROUP BY c.c_nation ORDER BY c.c_nation LIMIT 30"),
    "xc_rawhll_region": (
        f"{_XC}SELECT s.s_region, COUNT(*), "
        f"DISTINCTCOUNTRAWHLL(lo.lo_custkey) FROM {_MS_SM} "
        f"GROUP BY s.s_region ORDER BY s.s_region"),
}
# held to the broker-local form bit for bit (their integer measures and
# the raw HLL's registers)
XC_LOCAL = ("xc_nation", "xc_rawhll_region")
XC_KERNELS = ("group_plane_sums", "hll_register_max", "cluster_sums")
XC_RUNS = 3   # timed runs of each distributed query
# the tiered server: lineorder_by_date's segments, sorted by date, are
# hot (the first TIER_HOT), warm (the next TIER_WARM) and cold (the rest)
TIER_HOT, TIER_WARM = 4, 2
TIER_KERNELS = ("group_plane_sums", "group_minmax", "hll_register_max",
                "fused_filter_agg")
# the fleet's OS-process server: lineorder_by_date's first segments (cut
# from 8, for the process's start and the copies it loads)
FLEET_SEGMENTS = 2
# the minion: the purged segment of lineorder_by_date and its filter, the
# realtime-to-offline windows over lineorder_cl (two years, merge-rolled
# up after)
MN_PURGE_SEGMENT = 7
MN_PURGE_FILTER = "lo_discount = 0"
MN_WINDOWS = ((19930101, 19940101), (19940101, 19950101))
MN_CHECK = ("SELECT lo_discount, COUNT(*), SUM(lo_revenue) FROM t "
            "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20")


def _discount_rows(disc, rev) -> list:
    """MN_CHECK's rows over the given rows."""
    cnt = np.bincount(disc, minlength=11)
    rs = np.bincount(disc, weights=rev.astype(np.float64), minlength=11)
    return [[k, int(cnt[k]), float(rs[k])] for k in range(11) if cnt[k]]


def m3_oracle(data: list, bs_data: list, dims: dict) -> dict:
    """The m3 phases' answers from the generated columns: the exchange's
    three joins over a month, the tiers' date bounds and their queries
    over the sorted copy, the fleet's q1 over its segments, the purge's
    check over the rows it keeps."""
    c = {k: np.concatenate([d[k] for d in data])
         for k in ("lo_custkey", "lo_suppkey", "lo_orderdate", "lo_revenue",
                   "lo_quantity")}
    od = c["lo_orderdate"]
    month = (od >= 19930301) & (od <= 19930328)
    cu, su = dims["customer"], dims["supplier"]
    c_nat = np.full(CUSTOMERS + 1, -1, dtype=np.int64)
    c_nat[cu["c_custkey"]] = np.searchsorted(NATIONS, cu["c_nation"])
    s_reg = np.full(SUPPLIERS + 1, -1, dtype=np.int64)
    s_reg[su["s_suppkey"]] = np.searchsorted(REGIONS, su["s_region"])
    rev = c["lo_revenue"][month].astype(np.int64)
    qty = c["lo_quantity"][month].astype(np.int64)
    cn = c_nat[c["lo_custkey"][month]]
    keep = cn >= 0
    cnt = np.bincount(cn[keep], minlength=25)
    rs = np.bincount(cn[keep], weights=rev[keep].astype(np.float64),
                     minlength=25)
    qs = np.bincount(cn[keep], weights=qty[keep].astype(np.float64),
                     minlength=25)
    out = {"xc_nation": [[str(NATIONS[k]), int(cnt[k]), float(rs[k]),
                          float(qs[k])] for k in range(25) if cnt[k]],
           "xc_nation_joined": int(keep.sum())}
    out["xc_pct_nation"] = _rank_checker(
        "xc_pct_nation", [(str(NATIONS[k]), rev[keep][cn[keep] == k])
                          for k in range(25) if cnt[k]], 0.5, 100.0)
    sr = s_reg[c["lo_suppkey"][month]]
    cnt = np.bincount(sr[sr >= 0], minlength=5)
    counts = [[str(REGIONS[k]), int(cnt[k])] for k in range(5) if cnt[k]]

    def rawhll(got):
        # the registers themselves are held to the broker-local form
        if [r[:2] for r in got] != counts:
            raise AssertionError(f"xc_rawhll_region: {[r[:2] for r in got]}"
                                 f" want {counts}")
    out["xc_rawhll_region"] = rawhll
    out["xc_rawhll_region_joined"] = int((sr >= 0).sum())

    # the tiers: segment i of the sorted copy holds a run of dates
    lo_of = [int(d["lo_orderdate"].min()) for d in bs_data]
    hi_of = [int(d["lo_orderdate"].max()) for d in bs_data]
    hot_hi = lo_of[TIER_HOT]   # dates below it lie in the hot segments only
    warm = (hi_of[TIER_HOT - 1], lo_of[TIER_HOT + TIER_WARM])  # exclusive
    if not CL_WEEK[0] >= lo_of[0] or not CL_WEEK[1] < hot_hi:
        raise AssertionError(f"the K4 week is not in the hot segments: "
                             f"{lo_of}, {hi_of}")
    b = {k: np.concatenate([d[k] for d in bs_data]) for k in bs_data[0]}
    bod, bsupp = b["lo_orderdate"], b["lo_suppkey"]
    brev = b["lo_revenue"].astype(np.int64)
    disc = b["lo_discount"]
    hot = bod < hot_hi
    wm = (bod > warm[0]) & (bod < warm[1])
    out["tier_bounds"] = {"hot_hi": hot_hi, "warm": warm, "lo": lo_of,
                          "hi": hi_of}
    out["tier_hot_q1"] = (_q1_rows(_supp_sums(bsupp[hot], brev[hot])),
                          int(hot.sum()))
    out["tier_hot_q6"] = (_q6_rows(b, hot & (disc >= 1) & (disc <= 3)),
                          int((hot & (disc >= 1) & (disc <= 3)).sum()))
    m = hot & (disc >= 1) & (disc <= 3)
    idx, rho = hll_idx_rho(fmix32(b["lo_custkey"]), LOG2M)
    est = hll_estimates(idx, rho, np.where(m, 0, -1), 1, LOG2M)
    out["tier_hot_hll"] = ([[int(m.sum()), int(est[0])]], int(m.sum()))
    m = (bod >= CL_WEEK[0]) & (bod <= CL_WEEK[1])
    q, r = b["lo_quantity"][m], brev[m]
    out["tier_hot_k4"] = ([[int(m.sum()), float(q.sum()), float(r.min()),
                            float(r.max())]], int(m.sum()))
    out["tier_warm_q1"] = (_q1_rows(_supp_sums(bsupp[wm], brev[wm])),
                           int(wm.sum()))
    out["tier_all_q1"] = (_q1_rows(_supp_sums(bsupp, brev)), len(bsupp))
    n_fleet = sum(len(d["lo_orderdate"]) for d in bs_data[:FLEET_SEGMENTS])
    out["fleet_q1"] = (_q1_rows(_supp_sums(bsupp[:n_fleet],
                                           brev[:n_fleet])), n_fleet)
    d = bs_data[MN_PURGE_SEGMENT]
    kept = d["lo_discount"] != 0
    out["mn_purge"] = _discount_rows(d["lo_discount"][kept],
                                     d["lo_revenue"][kept])
    return out


def m3_tier_queries(bounds: dict) -> dict:
    """The tiered server's queries: q1's and q6's shapes, a scalar HLL and
    the K4 week over the hot segments (dates below the first warm
    segment's), q1's shape over the warm segments' dates, and q1 over the
    whole table, which touches the cold segments."""
    hot = f"lo_orderdate < {bounds['hot_hi']}"
    lo, hi = bounds["warm"]
    t = BS_TABLE
    return {
        "tier_hot_q1": (f"SELECT lo_suppkey, SUM(lo_revenue) FROM {t} WHERE "
                        f"{hot} GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) "
                        f"DESC LIMIT 10"),
        "tier_hot_q6": QUERIES["q6_minmax"].replace(
            "FROM lineorder", f"FROM {t}").replace(
            "WHERE lo_discount", f"WHERE {hot} AND lo_discount"),
        "tier_hot_hll": (f"SELECT COUNT(*), DISTINCTCOUNTHLL(lo_custkey) "
                         f"FROM {t} WHERE {hot} AND lo_discount BETWEEN 1 "
                         f"AND 3"),
        # a week: on its one segment the blocks stay under block skip's
        # bound (a month's pass it there, and take the dense form)
        "tier_hot_k4": CL_QUERIES["cl_week_fused"],
        "tier_warm_q1": (f"SELECT lo_suppkey, SUM(lo_revenue) FROM {t} WHERE "
                         f"lo_orderdate > {lo} AND lo_orderdate < {hi} "
                         f"GROUP BY lo_suppkey ORDER BY SUM(lo_revenue) DESC "
                         f"LIMIT 10"),
        "tier_all_q1": QUERIES["q1_scan_agg"].replace(
            "FROM lineorder", f"FROM {t}"),
    }


def m3_check(name: str, resp: dict, rows_want, scanned=None) -> None:
    """A broker answer of an m3 phase: no exception, not partial, the rows
    (or their own check), numDocsScanned where given."""
    if resp.get("exceptions"):
        raise AssertionError(f"{name}: {resp['exceptions']}")
    if resp.get("partialResult"):
        raise AssertionError(f"{name}: partial answer {resp}")
    got = resp["resultTable"]["rows"]
    if callable(rows_want):
        rows_want(got)
    elif not rows_equal(got, rows_want):
        raise AssertionError(f"{name}: rows {got[:5]} want {rows_want[:5]}")
    if scanned is not None and resp["numDocsScanned"] != scanned:
        raise AssertionError(f"{name}: numDocsScanned "
                             f"{resp['numDocsScanned']}, want {scanned}")


def _zeroed_launches() -> dict:
    tables = launch_tables()
    for table in tables.values():
        for key in table:
            table[key] = 0
    return tables


def _timed(fn, runs: int) -> list:
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    return times


def m3_exchange(front, broker, servers, want: dict, runs: int, records,
                chain_ns: float, local_week_ms, on_card: bool) -> tuple:
    """The distributed stage-2 exchange on the cluster's two servers: the
    month's star join, a PERCENTILETDIGEST and a raw HLL by group through
    ``SET joinStrategy = 'distributed'``, held to the oracle (rows, joined
    rows) and to the broker-local form bit for bit; the stage-1 bytes that
    crossed server to server; K1 / K3 / K5 launches per server (each must
    launch on both), then each held at its captured inputs; a transfer
    fault on server_1 answered by one retry with the same rows. Returns
    (summary, launches)."""
    from pinot_tpu_torch.common import faults
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.ops import groupby_mm as mm
    from pinot_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    k1, k3, k5 = records
    _zeroed_launches()
    summary = {}
    with count_roles(servers) as roles:
        tables = launch_tables()
        for name, sql in XC_QUERIES.items():
            t = time.perf_counter()
            resp = front.execute(sql)
            first_ms = (time.perf_counter() - t) * 1e3
            m3_check(name, resp, want[name])
            if resp.get("joinStrategy") != "DISTRIBUTED":
                raise AssertionError(f"{name}: ran {resp.get('joinStrategy')}")
            joined = want.get(f"{name}_joined", want["xc_nation_joined"])
            if resp["numJoinedRows"] != joined:
                raise AssertionError(f"{name}: {resp['numJoinedRows']} joined "
                                     f"rows, want {joined}")
            times = _timed(lambda: front.execute(sql), min(runs, XC_RUNS))
            ex = resp["exchange"]
            summary[name] = {
                "first_ms": first_ms,
                "p50_ms": float(np.percentile(times, 50)),
                "timed_runs": len(times), "partitions": ex["partitions"],
                "exchange_bytes": resp["exchangeBytes"],
                "partitions_shipped": resp["numPartitionsShipped"],
                "stage2_rows": {w: v["stage2Rows"]
                                for w, v in ex["servers"].items()}}
            n_rows = len(resp["resultTable"]["rows"])
            log(f"exchange {name}: matches the oracle ({n_rows} "
                f"rows, {resp['numJoinedRows']} joined rows over "
                f"{ex['partitions']} partitions on {ex['numWorkers']} "
                f"servers); {resp['exchangeBytes']} stage-1 bytes crossed "
                f"server to server in {resp['numPartitionsShipped']} "
                f"payloads; stage-2 rows by server "
                f"{json.dumps(summary[name]['stage2_rows'])}; first "
                f"{first_ms:.3f} ms, p50 {summary[name]['p50_ms']:.3f} ms "
                f"over {len(times)} run(s)")
        counts = {k: dict(v) for k, v in tables.items()}
        per_role = {r: dict(c) for r, c in roles.per.items()}
    log(f"exchange launches: {json.dumps(counts['kernels'])}; by server "
        f"{json.dumps(per_role)}")
    if on_card:
        for s in servers:
            for name in XC_KERNELS:
                if per_role[s.instance_id][name] <= 0:
                    raise AssertionError(f"exchange: {s.instance_id} never "
                                         f"launched {name}")
    summary["launches_by_server"] = per_role
    for name in XC_LOCAL:
        local_sql = XC_QUERIES[name].replace(_XC, "SET joinStrategy = "
                                             "'shuffle'; ")
        t = time.perf_counter()
        local = front.execute(local_sql)
        local_ms = (time.perf_counter() - t) * 1e3
        dist = front.execute(XC_QUERIES[name])
        if local.get("exceptions") or local["resultTable"]["rows"] != \
                dist["resultTable"]["rows"]:
            raise AssertionError(f"{name}: distributed {dist['resultTable']} "
                                 f"!= broker-local {local.get('resultTable')}"
                                 f" {local.get('exceptions')}")
        summary[name]["local_ms"] = local_ms
        log(f"exchange {name}: equals the broker-local form bit for bit "
            f"(that form {local_ms:.3f} ms, its {local['numJoinedRows']} "
            f"joined rows through the broker)")
    log(f"exchange: the distributed star join's p50 "
        f"{summary['xc_nation']['p50_ms']:.3f} ms over a month beside the "
        f"cluster path's broker-local star join over a week "
        + (f"{local_week_ms:.3f} ms (its checked run)"
           if local_week_ms is not None else "(not run)"))
    summary["local_week_ms"] = local_week_ms
    if on_card:
        for (gid, sources, G), kw in capture_calls(
                front, XC_QUERIES["xc_nation"], ps, "plane_group_sums"):
            count = kw.get("count", True)
            k1["shapes"].append(k1_shape(
                f"exchange xc_nation partition: G={G}, "
                f"{planes_label(sources, count)}",
                ps.plane_group_sums, G, sources, count, gid))
        # the first owned partition's registers (each partition's join
        # builds its own)
        (h, gid, G, log2m), kw = capture_calls(
            front, XC_QUERIES["xc_rawhll_region"], mm, "hll_registers")[0]
        k3["sizes"].append(k3_held(
            h, gid, G, log2m, kw.get("mask"), "exchange xc_rawhll_region",
            mm_registers(mm, h, gid, G, log2m, kw.get("mask"))))
        (args, _kw), *_rest = capture_calls(
            front, XC_QUERIES["xc_pct_nation"], kernels, "cluster_sums")
        k5["sizes"].append(check_k5("the exchange's xc_pct_nation", *args,
                                    chain_ns))
    # every transfer to server_1 fails: the broker retries without it
    for inst in ("server_0", "server_1"):
        for _ in range(4):
            broker.failures.mark_success(inst)
    faults.install(faults.Fault(point="exchange.transfer", target="server_1",
                                mode="error"))
    try:
        resp = front.execute(XC_QUERIES["xc_nation"])
    finally:
        faults.clear()
    for inst in ("server_0", "server_1"):
        for _ in range(4):
            broker.failures.mark_success(inst)
    m3_check("xc_nation under a transfer fault", resp, want["xc_nation"])
    if resp.get("numRetries") != 1:
        raise AssertionError(f"exchange fault: numRetries "
                             f"{resp.get('numRetries')}, want 1")
    summary["fault"] = {k: resp.get(k) for k in (
        "numRetries", "numServersQueried", "numServersResponded")}
    log(f"exchange fault: exchange.transfer to server_1 failed; the "
        f"broker retried without it: {json.dumps(summary['fault'])}, the "
        f"same rows")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"exchange phase: {summary['phase_s']:.2f} s")
    return summary, counts["kernels"]


def m3_tier(bs_dirs, want: dict, dev, runs: int, records,
            on_card: bool) -> tuple:
    """A tiered server (``pinot.server.tier.enabled``) of its own registry
    over lineorder_by_date's segments, pushed through the controller's
    deep store on local disk: a hot budget of
    TIER_HOT segments by ``segment_plan_bytes``, TIER_WARM segments
    demoted to warm and the rest to cold. The hot segments' q1, q6, HLL
    and K4 week, a warm query (resident bytes unchanged by it), then q1
    over every segment: partial with the cold ones counted while their
    re-download runs, whole and equal to the oracle after it. Returns
    (summary, launches)."""
    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.cluster.registry import ClusterRegistry
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.controller.controller import Controller
    from pinot_tpu_torch.ops import group_scatter as ps
    from pinot_tpu_torch.server.server import ServerInstance
    from pinot_tpu_torch.server.tiering import Tier, segment_plan_bytes

    t_phase = time.perf_counter()
    k1, k2, k3, k4 = records
    root = os.path.join(DATA_DIR, "tier")
    registry = ClusterRegistry()
    controller = Controller(registry, os.path.join(root, "deepstore"))
    server = ServerInstance(
        "server_tier", registry, os.path.join(root, "server_tier"),
        device=dev, tier_overrides={
            "pinot.server.tier.enabled": True,
            # the phase drives each transition itself
            "pinot.server.tier.interval.ms": 3.6e9})
    server.engine.device.MAX_CACHED_BYTES = CLUSTER_BATCH_BYTES
    server.engine.device.partials_cache_enabled = False
    server.engine.device.advisor = None
    server.start()
    broker = Broker(registry, timeout_s=600.0, device=dev)
    queries = m3_tier_queries(want["tier_bounds"])
    summary = {}
    try:
        controller.add_table(TableConfig(table_name=BS_TABLE),
                             lo_schema(BS_TABLE))
        t = time.perf_counter()
        for d in bs_dirs:
            # copied into the controller's deep store on local disk: the
            # cold segments' only copy, the re-downloads' source
            controller.upload_segment(BS_TABLE, d)
        table = f"{BS_TABLE}_OFFLINE"
        cl_wait(lambda: len(registry.external_view(table)) == len(bs_dirs),
                "the tiered server's segments")
        summary["load_s"] = time.perf_counter() - t
        tdm = server.engine.tables[table]
        by_date = sorted(tdm.segments.values(),
                         key=lambda s: int(s.metadata.columns[
                             "lo_orderdate"].min_value))
        names = [s.name for s in by_date]
        costs = [segment_plan_bytes(s) for s in by_date]
        tiers = server.tiers
        tiers.hot_budget_bytes = sum(costs[:TIER_HOT])
        if sum(costs[:TIER_HOT + 1]) <= tiers.hot_budget_bytes:
            raise AssertionError("the hot budget holds more than "
                                 f"{TIER_HOT} segments")
        # every segment hot first: one batch of the eight, and q1 whole
        resp = broker.execute(queries["tier_all_q1"])
        m3_check("tier_all_q1 (all hot)", resp, *want["tier_all_q1"])
        evicted = []
        real_evict = server.engine.device.evict_segment_dir

        def evict(seg_dir, _real=real_evict):
            n = _real(seg_dir)
            evicted.append(n)
            return n
        server.engine.device.evict_segment_dir = evict
        warm_names = names[TIER_HOT:TIER_HOT + TIER_WARM]
        cold_names = names[TIER_HOT + TIER_WARM:]
        for name in warm_names:
            if not tiers.demote_to_warm(table, name):
                raise AssertionError(f"tier: {name} did not demote to warm")
        for name in cold_names:
            if not tiers.demote_to_cold(table, name):
                raise AssertionError(f"tier: {name} did not demote to cold")
        del server.engine.device.evict_segment_dir
        snap = tiers.snapshot()[table]
        want_tiers = {**{n: Tier.HOT for n in names[:TIER_HOT]},
                      **{n: Tier.WARM for n in warm_names},
                      **{n: Tier.COLD for n in cold_names}}
        if snap != want_tiers:
            raise AssertionError(f"tier map {snap}, want {want_tiers}")
        summary["plan_bytes"] = dict(zip(names, costs))
        summary["hot_budget_bytes"] = tiers.hot_budget_bytes
        summary["evicted_batches"] = sum(evicted)
        log(f"tier: {len(names)} segments loaded in {summary['load_s']:.2f} "
            f"s; hot budget {tiers.hot_budget_bytes} bytes = "
            f"segment_plan_bytes of the first {TIER_HOT} ({costs}); "
            f"{TIER_WARM} demoted to warm, {len(cold_names)} to cold (their "
            f"planes deleted, the deep store's copies their only ones); "
            f"evict_segment_dir dropped {sum(evicted)} batch(es) "
            f"({evicted})")
        tables = _zeroed_launches()
        p50 = {}
        for name in ("tier_hot_q1", "tier_hot_q6", "tier_hot_hll",
                     "tier_hot_k4"):
            resp = broker.execute(queries[name])
            m3_check(name, resp, *want[name])
            if resp.get("numSegmentsCold"):
                raise AssertionError(f"{name} touched a cold segment")
            p50[name] = float(np.percentile(_timed(
                lambda: broker.execute(queries[name]), runs), 50))
        counts = {k: dict(v) for k, v in tables.items()}["kernels"]
        log(f"tier hot launches: {json.dumps(counts)}")
        for name in TIER_KERNELS if on_card else ():
            if counts[name] <= 0:
                raise AssertionError(f"tier: {name} never launched over the "
                                     f"hot segments")
        before = server.engine.device.hbm_stats()
        resp = broker.execute(queries["tier_warm_q1"])
        m3_check("tier_warm_q1", resp, *want["tier_warm_q1"])
        p50["tier_warm_q1"] = float(np.percentile(_timed(
            lambda: broker.execute(queries["tier_warm_q1"]), runs), 50))
        after = server.engine.device.hbm_stats()
        if after["resident_bytes"] != before["resident_bytes"] or \
                after["cached_batches"] != before["cached_batches"]:
            raise AssertionError(f"tier: the warm query left planes on the "
                                 f"card: {before['resident_bytes']} -> "
                                 f"{after['resident_bytes']} bytes")
        log(f"tier warm: tier_warm_q1 matches the oracle; resident bytes "
            f"{before['resident_bytes']} before and after it, "
            f"{after['cached_batches']} cached batch(es)")
        t = time.perf_counter()
        resp = broker.execute(queries["tier_all_q1"])
        cold_ms = (time.perf_counter() - t) * 1e3
        if not resp.get("partialResult") or \
                resp.get("numSegmentsCold") != len(cold_names):
            stats = {k: v for k, v in resp.items() if k != "resultTable"}
            raise AssertionError(f"tier cold: want a partial answer with "
                                 f"{len(cold_names)} cold segments: "
                                 f"{stats}")
        t = time.perf_counter()
        for name in cold_names:
            if not tiers.wait_hydrated(table, name, 300.0):
                raise AssertionError(f"tier: {name} never re-downloaded")
        hydrate_s = time.perf_counter() - t
        resp = broker.execute(queries["tier_all_q1"])
        m3_check("tier_all_q1 (after the re-download)", resp,
                 *want["tier_all_q1"])
        if resp.get("numSegmentsCold"):
            raise AssertionError(f"tier: still cold after the re-download")
        p50["tier_all_q1"] = float(np.percentile(_timed(
            lambda: broker.execute(queries["tier_all_q1"]), runs), 50))
        summary.update({"p50_ms": p50, "cold_partial_ms": cold_ms,
                        "hydrate_s": hydrate_s,
                        "hydrations": tiers.hydrations,
                        "tiers_after": tiers.snapshot()[table]})
        log(f"tier cold: q1 over every segment answered partial "
            f"(numSegmentsCold {len(cold_names)}) in {cold_ms:.3f} ms; the "
            f"re-downloads landed warm in {hydrate_s:.2f} s; then whole and "
            f"equal to the oracle")
        log(f"tier p50 ms: {json.dumps(p50)}")
        if on_card:
            for (gid, sources, G), kw in capture_calls(
                    broker, queries["tier_hot_q1"], ps, "plane_group_sums"):
                count = kw.get("count", True)
                k1["shapes"].append(k1_shape(
                    f"tier tier_hot_q1: G={G}, "
                    f"{planes_label(sources, count)}",
                    ps.plane_group_sums, G, sources, count, gid))
            for (gid, srcs, G), _kw in capture_calls(
                    broker, queries["tier_hot_q6"], ps,
                    "group_minmax_sources"):
                k2["shapes"].append(k2_shape(
                    "tier tier_hot_q6: " + ", ".join(
                        f"{s.values.dtype} {'+'.join(s.ops)}"
                        for s in srcs).replace("torch.", ""), gid, srcs, G))
            (args, kw), = capture_calls(broker, queries["tier_hot_hll"], ps,
                                        "hll_register_max")

            def scalar():
                return ps.hll_register_max(*args, **kw)
            scalar.via = "group_scatter.hll_register_max"
            k3["sizes"].append(k3_held(args[0], kw.get("gid"),
                                       kw.get("num_groups", 1), args[1],
                                       kw.get("mask"), "tier tier_hot_hll",
                                       scalar))
            k4["sizes"].append(check_k4(
                "the tiered server's tier_hot_k4",
                *capture_fused(broker, queries["tier_hot_k4"])))
        summary["phase_s"] = time.perf_counter() - t_phase
        log(f"tier phase: {summary['phase_s']:.2f} s")
        return summary, counts
    finally:
        broker.close()
        server.stop(drain_timeout_s=0)


def m3_fleet(registry, broker, http, bs_dirs, want: dict, on_card: bool,
             dev) -> dict:
    """Two brokers behind the cluster's registry (``BrokerFleetMember``):
    ``client.connect(discover=True)`` alternates their ``brokerId`` and
    ``cursor.execute_stream`` returns q1 whole; then a server started as
    an OS process (``tools.admin start-server``, on the card) over a
    FileRegistry of its own serves FLEET_SEGMENTS of lineorder_by_date and
    answers q1's shape equal to the oracle."""
    import subprocess

    from pinot_tpu_torch import client
    from pinot_tpu_torch.broker.broker import Broker
    from pinot_tpu_torch.broker.fleet import (
        BrokerFleetMember,
        discover_broker_urls,
    )
    from pinot_tpu_torch.broker.http_api import BrokerHttpServer
    from pinot_tpu_torch.cluster.registry import FileRegistry
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.controller.controller import Controller

    t_phase = time.perf_counter()
    summary = {}
    broker2 = Broker(registry, broker_id="broker_1", timeout_s=600.0,
                     device=dev)
    http2 = BrokerHttpServer(broker2)
    http2.start()
    members = [BrokerFleetMember(registry, b, http_url=h.url, host=h.host,
                                 port=h.port) for b, h in ((broker, http),
                                                           (broker2, http2))]
    for m in members:
        m.start()
    sql = CL_QUERIES["q1_scan_agg"]
    try:
        cl_wait(lambda: len(discover_broker_urls(registry)) == 2,
                "two brokers in the registry")
        conn = client.connect(registry=registry, discover=True)
        ids = []
        for _ in range(4):
            cur = conn.cursor()
            cur.execute(sql)
            rows = [list(r) for r in cur.fetchall()]
            if not rows_equal(rows, want["q1_scan_agg"][0]):
                raise AssertionError(f"fleet: q1 rows {rows[:3]}")
            ids.append(cur.stats["brokerId"])
        if len(set(ids)) != 2 or any(a == b for a, b in zip(ids, ids[1:])):
            raise AssertionError(f"fleet: brokerId did not alternate: {ids}")
        cur = conn.cursor()
        cur.execute_stream(sql)
        rows = [list(r) for r in cur.fetchall()]
        if not rows_equal(rows, want["q1_scan_agg"][0]):
            raise AssertionError(f"fleet: streamed q1 rows {rows[:3]}")
        conn.close()
        summary["broker_ids"] = ids
        log(f"fleet: two brokers behind the registry; client.connect("
            f"discover=True) answered q1 through {ids}; execute_stream "
            f"returned its {len(rows)} rows whole")
    finally:
        for m in members:
            m.stop()
        http2.stop()
        broker2.close()

    # the OS-process server over a FileRegistry of its own
    root = os.path.join(DATA_DIR, "fleet")
    os.makedirs(root, exist_ok=True)
    reg_path = os.path.join(root, "cluster.json")
    file_reg = FileRegistry(reg_path)
    log_path = os.path.join(root, "server.log")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in [ROOT] + env.get("PYTHONPATH", "").split(os.pathsep) if p)
    t = time.perf_counter()
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "pinot_tpu_torch.tools.admin",
             "start-server", "--registry", reg_path, "--data-dir",
             os.path.join(root, "proc_server"), "--id", "proc_server"]
            + ([] if on_card else ["--device", "cpu"]),
            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    broker3 = None
    try:
        cl_wait(lambda: any(
            i.instance_id == "proc_server"
            for i in file_reg.instances(live_ttl_ms=6000))
            or proc.poll() is not None,
            "the OS-process server's registration", 300.0)
        if proc.poll() is not None:
            raise AssertionError(f"fleet: the server process exited "
                                 f"{proc.returncode}: "
                                 + open(log_path).read()[-2000:])
        start_s = time.perf_counter() - t
        controller = Controller(file_reg, os.path.join(root, "deepstore"))
        controller.add_table(TableConfig(table_name=BS_TABLE),
                             lo_schema(BS_TABLE))
        for d in bs_dirs[:FLEET_SEGMENTS]:
            controller.upload_segment(BS_TABLE, d, copy_to_deep_store=False)
        broker3 = Broker(file_reg, timeout_s=600.0, device=dev)
        q1 = QUERIES["q1_scan_agg"].replace("FROM lineorder",
                                            f"FROM {BS_TABLE}")
        resp = {}

        def served():
            nonlocal resp
            if proc.poll() is not None:
                raise AssertionError(f"fleet: the server process exited "
                                     f"{proc.returncode}")
            resp = broker3.execute("SET useResultCache = false; " + q1)
            return not resp.get("exceptions") and \
                resp.get("numSegmentsQueried") == FLEET_SEGMENTS
        cl_wait(served, "the OS-process server's segments", 300.0)
        ready_s = time.perf_counter() - t
        m3_check("fleet_q1", resp, *want["fleet_q1"])
        times = _timed(lambda: broker3.execute(q1), 3)
        summary.update({"process_start_s": start_s, "process_ready_s":
                        ready_s, "q1_p50_ms": float(np.percentile(times, 50))})
        log(f"fleet: tools.admin start-server as an OS process registered in "
            f"{start_s:.2f} s and answered q1 over its {FLEET_SEGMENTS} "
            f"segments ({want['fleet_q1'][1]} rows) {ready_s:.2f} s after "
            f"its start, equal to the oracle; p50 "
            f"{summary['q1_p50_ms']:.3f} ms")
    finally:
        if broker3 is not None:
            broker3.close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"fleet phase: {summary['phase_s']:.2f} s")
    return summary


def m3_minion(registry, controller, rt: dict, want: dict, dev,
              on_card: bool) -> tuple:
    """The minion worker on the card: purge one of lineorder_by_date's
    segments (its mask through the filter lowering on the card), move two
    years of lineorder_cl's committed rows to its OFFLINE table
    (realtime-to-offline), merge-roll-up those two segments; each output
    segment's COUNT / SUM by lo_discount (K1) held to numpy over the same
    rows, each task's wall time printed. Returns (summary, launches)."""
    from pinot_tpu_torch.common.table_config import TableConfig
    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.minion.worker import MinionWorker
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    t_phase = time.perf_counter()
    worker = MinionWorker(registry, controller,
                          os.path.join(DATA_DIR, "minion"), device=dev)
    summary = {}

    def run(task_type, table, config) -> tuple:
        tid = registry.submit_task(task_type, table, config)
        t = time.perf_counter()
        task = worker.run_one()
        wall = time.perf_counter() - t
        if task is None or task["id"] != tid or task["state"] != "DONE":
            raise AssertionError(f"minion {task_type}: {task}")
        return task, wall

    def held(label, seg_dirs, want_rows) -> None:
        eng = QueryEngine(device=dev)
        eng.device.partials_cache_enabled = False
        eng.device.advisor = None
        for d in seg_dirs:
            eng.add_segment("t", ImmutableSegment(d))
        resp = eng.execute(MN_CHECK)
        if resp["exceptions"] or not rows_equal(
                resp["resultTable"]["rows"], want_rows):
            raise AssertionError(f"minion {label}: {resp}")

    tables = _zeroed_launches()
    bs_table = f"{BS_TABLE}_OFFLINE"
    recs = registry.segments(bs_table)
    victim = sorted(recs.values(), key=lambda r: int(
        ImmutableSegment(r.location).metadata.columns[
            "lo_orderdate"].min_value))[MN_PURGE_SEGMENT].name
    task, wall = run("PurgeTask", bs_table,
                     {"filter": MN_PURGE_FILTER, "segments": [victim]})
    out = [r.location for n, r in registry.segments(bs_table).items()
           if n.startswith(f"{victim}_purged_")]
    if len(out) != 1:
        raise AssertionError(f"minion purge: outputs {out}")
    held("purge", out, want["mn_purge"])
    summary["purge"] = {"wall_s": wall, "output": task["output"]}
    log(f"minion purge: {victim} ({MN_PURGE_FILTER} dropped) in "
        f"{wall:.2f} s: {task['output']}; its COUNT / SUM by lo_discount "
        f"equal numpy over the rows it keeps")

    rt_table = f"{CL_RT_TABLE}_REALTIME"
    controller.add_table(TableConfig(table_name=CL_RT_TABLE,
                                     time_column="lo_orderdate"),
                         lo_schema(CL_RT_TABLE))
    cfg = registry.table_config(rt_table)
    cfg.time_column = "lo_orderdate"
    registry.set_table_config(rt_table, cfg)
    od, disc, rev = rt["lo_orderdate"], rt["lo_discount"], rt["lo_revenue"]
    off_table = f"{CL_RT_TABLE}_OFFLINE"
    moved = []
    for ws, we in MN_WINDOWS:
        task, wall = run("RealtimeToOfflineSegmentsTask", rt_table,
                         {"window_start_ms": ws, "window_end_ms": we})
        name = f"{CL_RT_TABLE}_{ws}_{we}"
        loc = registry.segments(off_table)[name].location
        m = (od >= ws) & (od < we)
        held(f"realtime-to-offline [{ws}, {we})", [loc],
             _discount_rows(disc[m], rev[m]))
        moved.append(name)
        summary[f"rt2o_{ws}"] = {"wall_s": wall, "output": task["output"],
                                 "rows": int(m.sum())}
        log(f"minion realtime-to-offline [{ws}, {we}): {task['output']} in "
            f"{wall:.2f} s; COUNT / SUM by lo_discount equal numpy over the "
            f"{int(m.sum())} rows")
    task, wall = run("MergeRollupTask", off_table,
                     {"segments": moved, "mode": "rollup"})
    merged = [r.location for n, r in registry.segments(off_table).items()
              if n.startswith("merged_")]
    m = (od >= MN_WINDOWS[0][0]) & (od < MN_WINDOWS[-1][1])
    held("merge-rollup", merged, _discount_rows(disc[m], rev[m]))
    summary["rollup"] = {"wall_s": wall, "output": task["output"]}
    log(f"minion merge-rollup: {task['output']} in {wall:.2f} s; COUNT / "
        f"SUM by lo_discount equal numpy over the {int(m.sum())} rows")
    counts = {k: dict(v) for k, v in tables.items()}["kernels"]
    log(f"minion launches: {json.dumps(counts)}")
    if on_card and counts["group_plane_sums"] <= 0:
        raise AssertionError("minion: K1 never launched on the outputs")
    summary["phase_s"] = time.perf_counter() - t_phase
    log(f"minion phase: {summary['phase_s']:.2f} s")
    return summary, counts


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--rows", type=int, default=12_500_000,
                    help="rows per segment")
    ap.add_argument("--event-rows", type=int, default=1_000_000,
                    help="rows per segment of the index path's table")
    ap.add_argument("--runs", type=int, default=5,
                    help="timed runs per query")
    ap.add_argument("--rt-rows", type=int, default=RT_ROWS,
                    help="rows of lineorder_rt's consuming segment")
    ap.add_argument("--rt-more", type=int, default=RT_MORE,
                    help="rows lineorder_rt indexes while queries run")
    ap.add_argument("--up-rows", type=int, default=UP_ROWS,
                    help="rows of each of lineorder_up's three segments")
    ap.add_argument("--profile", action="store_true",
                    help="after the timed runs, trace one more run of each "
                         "query with torch.profiler and print its device "
                         "time by operation")
    ap.add_argument("--paths", default=",".join(ALL_PATHS),
                    help="comma-separated paths to run (default: every "
                         "one): " + ", ".join(ALL_PATHS))
    args = ap.parse_args(argv)
    sel = [p for p in args.paths.split(",") if p]
    unknown = sorted(set(sel) - set(ALL_PATHS))
    if unknown or not sel:
        ap.error(f"unknown paths {unknown}; the paths: {ALL_PATHS}")
    need = set().union(*(PATH_TABLES[p] for p in sel))

    if not os.path.isdir(os.path.join(ROOT, "pinot_tpu_torch", "csrc")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(pinot_tpu_torch/ not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py runs on an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the batch LRU's byte budget (the reference's 6 GiB default sized for
    # a TPU's memory): the paths' tables fit the card's 80 GB at once, so
    # a path that mixes tables does not re-upload 100M-row batches
    os.environ.setdefault("PINOT_TPU_BATCH_CACHE_BYTES", str(BATCH_CACHE_BYTES))
    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.ops import kernels
    from pinot_tpu_torch.ops.group_scatter import PALLAS_MIN_ROWS
    from pinot_tpu_torch.storage.device import padded_len
    from pinot_tpu_torch.storage.segment import ZONE_BLOCK_ROWS, \
        ImmutableSegment

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t = time.perf_counter()
    kernels.build_all()
    log(f"kernel build: {time.perf_counter() - t:.2f} s "
        f"({', '.join(kernels.SOURCES.values())})")
    for name, out in kernels.build_log.items():
        for line in out.splitlines():
            if any(k in line for k in ("registers", "spill", "smem")):
                log(f"ptxas {name}: {line.strip()}")

    S, rows = args.segments, args.rows
    log(f"paths: {', '.join(sel)} (tables: {', '.join(sorted(need))})")
    log(f"table: SSB lineorder, {S} segments x {rows} rows = {S * rows} "
        f"rows, seed 7")
    t = time.perf_counter()
    data = generate(S, rows)
    mv = mv_generate(data) if "mv" in need else []
    ev = ev_generate(EV_SEGMENTS, args.event_rows) if "events" in need \
        else ({}, [])
    v2 = v2_generate(rows) if "v2" in need else {"d_year": []}
    trips = trips_generate(TRIPS_SEGMENTS, rows) if "trips" in need else []
    rt = rt_generate(args.rt_rows + args.rt_more) if "rt" in need else None
    up = up_generate(args.up_rows) if "up" in need else None
    dims = ms_dims() if "dims" in need else {}
    log(f"generate: {time.perf_counter() - t:.2f} s (with {MV_TABLE}'s MV "
        f"columns over {len(mv)} segments, {EV_TABLE}: {EV_SEGMENTS} x "
        f"{args.event_rows} rows, {V2_TABLE}'s new segment s{S}: "
        f"{rows} rows, seed {V2_SEED}, {TRIPS_TABLE}: {TRIPS_SEGMENTS} x "
        f"{rows} rows, seed {TRIPS_SEED}, {RT_TABLE}'s consuming rows: "
        f"{args.rt_rows} + {args.rt_more}, seed {RT_SEED}, {UP_TABLE}: "
        f"3 x {args.up_rows} rows over {UP_KEYS} keys, seed {UP_SEED}, and "
        f"SSB's dimensions, seed {MS_SEED}: "
        + ", ".join(f"{k} {len(next(iter(v.values())))} rows"
                    for k, v in dims.items()) + ")")
    from pinot_tpu_torch import native

    t = time.perf_counter()
    available = native.available_codecs()
    if not (available["zlib"] and available["lz4"]):
        raise AssertionError(f"zlib and lz4 have a Python codec at least: "
                             f"{available}")
    codecs = trip_codecs(available)
    log(f"codecs: {available} (library {native.library_path()}, built in "
        f"{time.perf_counter() - t:.2f} s); {TRIPS_TABLE}'s raw columns: "
        f"{codecs}, trip_distance uncompressed"
        + ("" if "tip_amount" in codecs else
           "; no zstd in this build: tip_amount uncompressed"))
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    os.makedirs(DATA_DIR)
    t_write = time.perf_counter()
    workers = min(S, os.cpu_count() or 1)
    pool = mp.get_context("spawn").Pool(workers)
    try:
        # the longest writes first; a table no selected path reads is
        # neither written nor loaded
        pending_trips = pool.starmap_async(
            write_trips_segment, [(i, seg, codecs) for i, seg in
                                  enumerate(trips)])
        pending_mv = pool.starmap_async(
            write_mv_segment, [(i, data[i], m) for i, m in enumerate(mv)])
        pending_ev = pool.starmap_async(
            write_ev_segment, [(i, ev[0], seg) for i, seg in
                               enumerate(ev[1])])
        pending_v2 = pool.apply_async(write_v2_segment, (S, v2)) \
            if "v2" in need else None
        pending_up = pool.starmap_async(
            write_up_segment, [(i, up, args.up_rows)
                               for i in range(2 if up is not None else 0)])
        pending_dims = pool.starmap_async(write_ms_dim, list(dims.items()))
        pending = pool.starmap_async(
            write_segment, [(i, seg, "lineorder", True) for i, seg in
                            enumerate(data if "lo" in need else [])])
        t = time.perf_counter()
        bs_data = sort_by_date(data) if "bs" in need else []
        log(f"sort by lo_orderdate: {time.perf_counter() - t:.2f} s")
        pending_bs = pool.starmap_async(
            write_segment, [(i, seg, BS_TABLE) for i, seg in
                            enumerate(bs_data)])
        pending_pairs = pool.starmap_async(
            write_segment, [(i, data[i], PAIRS_TABLE, True)
                            for i in range(min(S, PAIRS_SEGMENTS)
                                           if "pairs" in need else 0)])
        pending_hc = pool.starmap_async(
            hc_overflow_part, [(d["lo_custkey"], d["lo_suppkey"],
                                d["lo_revenue"]) for d in data
                               if "highcard" in sel])
        # compress's own loop over each digest run's count, value by
        # value: the schedules the card's clusters are held to (the
        # sketch path's runs, the multistage path's joined rows)
        runs = sk_runs(data) if "sketch" in sel else {}
        ms_runs_ = ms_runs(data) if "multistage" in sel else []
        pairs = sorted({(n, SK_DIGESTS[q][0]) for q, ns in runs.items()
                        for n in ns} | {(n, delta) for n in ms_runs_
                                        for _p, delta in MS_PCT})
        pending_w = pool.starmap_async(compress_weights, pairs)

        dev = torch.device("cuda", 0)
        pad = padded_len(rows, max(1024, ZONE_BLOCK_ROWS))
        n = S * pad
        check_split_dtypes(dev)
        k1 = check_k1(n, dev)
        k1["shapes"].append(check_bucket_histogram(n, dev))
        torch.cuda.empty_cache()
        k2 = check_k2(n, dev)
        torch.cuda.empty_cache()
        k3_sizes = check_k3(n, dev)
        # the kernel line's main numbers: the group entry's 35 x 1024 slots
        k3 = dict(k3_sizes[1], sizes=k3_sizes)
        torch.cuda.empty_cache()
        k4_bound = check_k4_bound(n // ZONE_BLOCK_ROWS, dev)
        torch.cuda.empty_cache()

        # the oracle runs here, beside the writes: the paths' oracles on
        # ORACLE_THREADS threads (numpy's loops release the GIL), the SSB
        # and cube answers on this one; the answers merge in the order
        # the paths are listed, the cluster's last (it reads the others)
        t = time.perf_counter()
        jobs = [fn for path, fn in (
                ("blockskip", lambda: bs_oracle(bs_data, pad)),
                ("selection", lambda: sel_oracle(data, bs_data)),
                ("sketch", lambda: sk_oracle(data)),
                ("mv", lambda: mv_oracle(data, mv)),
                ("index", lambda: idx_oracle(ev)),
                ("values", lambda: val_oracle(data, v2, mv)),
                ("tail", lambda: tail_oracle(trips, pad)),
                ("serving", lambda: serve_oracle(data)),
                ("realtime", lambda: rt_oracle(data, rt, args.rt_rows)),
                ("realtime", lambda: up_oracle(up, False)),
                ("multistage", lambda: ms_oracle(data, dims, rt,
                                                 args.rt_rows, mv)),
                ("advisor", lambda: adv_oracle(bs_data))) if path in sel]
        if "serving" in sel and "blockskip" not in sel:
            jobs.append(lambda: bs_oracle(bs_data, pad))
        with ThreadPoolExecutor(ORACLE_THREADS) as threads:
            futures = [threads.submit(fn) for fn in jobs]
            want = {}
            if "lo" in need:
                want = oracle(data)
                want.update(st_oracle(data, want))
            for future in futures:
                want.update(future.result())
        if "cluster" in sel:
            want.update(cl_oracle(data, bs_data, dims, pad, want))
        if set(M3_PATHS) & set(sel):
            want.update(m3_oracle(data, bs_data, dims))
        if "multistage" in sel:
            QUERY_LAUNCHES.update(ms_launches(want, PALLAS_MIN_ROWS))
        oracle_s = time.perf_counter() - t

        written = pending.get()
        dirs, cube_s = zip(*written) if written else ((), ())
        bs_dirs = [d for d, _s in pending_bs.get()]
        pairs_done = pending_pairs.get()
        pair_dirs, pair_s = zip(*pairs_done) if pairs_done else ((), ())
        weights = dict(zip(pairs, pending_w.get()))
        hc_parts = pending_hc.get()
        mv_dirs = pending_mv.get()
        ev_dirs = pending_ev.get()
        v2_dir = pending_v2.get() if pending_v2 is not None else None
        trips_dirs = pending_trips.get()
        pending_up.get()
        dim_dirs = dict(zip(dims, pending_dims.get()))
        log(f"write segments (port creator, {workers} processes, seven "
            f"tables): {time.perf_counter() - t_write:.2f} s, of which the "
            f"two star-tree cubes of lineorder took {sum(cube_s):.2f} s "
            f"summed over its {len(cube_s)} segments (at most "
            f"{max(cube_s, default=0.0):.2f} s "
            f"for one), the digest, bitmap and decimal cube of "
            f"{PAIRS_TABLE} {sum(pair_s):.2f} s over its "
            f"{len(pair_s)} segments")
    finally:
        pool.terminate()
        pool.join()

    t = time.perf_counter()
    if "highcard" in sel:
        want.update(hc_oracle(data, hc_parts))
    if "index" in sel:
        idx_geo_stats(want, geo_candidate_counts(ev_dirs))
    total = S * rows
    path_rows = {"mv": sum(len(d["d_year"]) for d in data[:MV_SEGMENTS]),
                 "index": EV_SEGMENTS * args.event_rows,
                 "values": total + len(v2["d_year"]),
                 "tail": TRIPS_SEGMENTS * rows,
                 "realtime": total + args.rt_rows}
    dim_schemas = {k: ms_dim_schema(k, v) for k, v in dims.items()}
    del data, bs_data, mv, ev, v2, trips, dims
    log(f"numpy oracle: {oracle_s:.2f} s beside the writes, "
        f"{time.perf_counter() - t:.2f} s after them")

    segs = [ImmutableSegment(d) for d in dirs]
    bs_segs = [ImmutableSegment(d) for d in bs_dirs]
    engine = QueryEngine(device="cuda")
    # the paths time repeated executions: the partials cache would serve
    # them (the serving path turns it on for serve_partials), and the plan
    # advisor would change the forms whose launches they count (the
    # advisor path turns it on)
    engine.device.partials_cache_enabled = False
    engine.device.advisor = None
    for s in segs:
        engine.add_segment("lineorder", s)
    for s in bs_segs:
        engine.add_segment(BS_TABLE, s)
    for d in pair_dirs:
        engine.add_segment(PAIRS_TABLE, ImmutableSegment(d))
    for d in mv_dirs:
        engine.add_segment(MV_TABLE, ImmutableSegment(d))
    for d in ev_dirs:
        engine.add_segment(EV_TABLE, ImmutableSegment(d))
    # the lineorder segments a second time, as their own segment objects
    # behind the v2 schema, and s8
    v2_segs = [ImmutableSegment(d) for d in list(dirs) + [v2_dir]] \
        if v2_dir is not None else []
    for seg in v2_segs:
        seg.table_schema = v2_schema()
        engine.add_segment(V2_TABLE, seg)
    for d in trips_dirs:
        engine.add_segment(TRIPS_TABLE, ImmutableSegment(d))
    rt_seg = None
    if "rt" in need:
        # lineorder_rt: lineorder's sealed segments (the same objects, so
        # the same device batch) and the consuming segment the stream
        # fills
        for s in segs:
            engine.add_segment(RT_TABLE, s)
        rt_seg, rt_stream, rt_offset, rt_build_s, rt_index_s = rt_segment(
            rt, args.rt_rows)
        engine.add_segment(RT_TABLE, rt_seg)
        ci = rt_seg.chunklet_index
        rt_index = {"rows": rt_seg.n_docs, "seconds": rt_index_s,
                    "rows_per_s": rt_seg.n_docs / rt_index_s,
                    "records_s": rt_build_s, "chunklets": len(ci.chunklets),
                    "tail_rows": rt_seg.n_docs - ci.frozen_docs}
        log(f"{RT_TABLE}: {rt_seg.n_docs} consuming rows indexed in "
            f"{rt_index_s:.2f} s ({rt_index['rows_per_s']:.0f} rows/s: "
            f"{RT_FETCH}-row fetches through consume_stream_batches, one "
            f"index_batch and a promotion each; the records built in "
            f"{rt_build_s:.2f} s before), {len(ci.chunklets)} chunklets of "
            f"{RT_CHUNKLET} rows and a {rt_index['tail_rows']}-row tail")
    # SSB's dimension tables, beside lineorder and lineorder_rt
    for name, d in dim_dirs.items():
        engine.add_segment(name, ImmutableSegment(d))
        engine.table(name).is_dim_table = True
    if up is not None:
        up_mgr, up_topic, up_s = up_manager(engine, up, args.up_rows)
        up_docs = sum(s.n_docs for s in table_segs(engine, UP_TABLE))
        masked = sum(int((~s.valid_docs_mask).sum())
                     for s in table_segs(engine, UP_TABLE)
                     if getattr(s, "valid_docs_mask", None) is not None)
        log(f"{UP_TABLE}: 2 committed segments replayed and {args.up_rows} "
            f"rows consumed a row at a time in {up_s:.2f} s "
            f"({args.up_rows / up_s:.0f} rows/s); {up_docs} docs, {masked} "
            f"of the sealed ones masked")
    t = time.perf_counter()
    ctx, lo_bytes = None, 0
    if segs:
        ctx = engine.device.batch_for(segs)
        for c in ("d_year", "c_region", "s_nation", "lo_suppkey",
                  "lo_orderdate", "lo_discount", "lo_quantity"):
            ctx.column(c)
        for c in ("lo_quantity", "lo_revenue"):
            ctx.decoded_column(c)
        ctx.prehashed_column("lo_custkey")
        lo_bytes = ctx.resident_bytes
    bs_bytes = 0
    if bs_segs:
        bs_ctx = engine.device.batch_for(bs_segs)
        for c in ("lo_orderdate", "lo_discount", "lo_quantity"):
            bs_ctx.column(c)
        for c in ("lo_quantity", "lo_revenue"):
            bs_ctx.decoded_column(c)
        bs_bytes = bs_ctx.resident_bytes
    torch.cuda.synchronize()
    log(f"upload (global dictionaries, zone maps + {lo_bytes} "
        f"+ {bs_bytes} device bytes): {time.perf_counter() - t:.2f} s")

    if "blockskip" in sel:
        k4 = check_k4("the block-skip path's bs_month_fused",
                      *capture_fused(engine, BS_QUERIES["bs_month_fused"]))
        k4["sizes"] = [dict(k4), k4_bound]
    else:
        k4 = dict(k4_bound, sizes=[k4_bound])
    if "selection" in sel:
        check_path_group_ids(engine, k1, k2)
    torch.cuda.empty_cache()
    dadd = kernels.dadd_chain_ns(torch.device("cuda", 0))
    log(f"DADD latency: {dadd['ns']:.4f} ns, {dadd['cycles']:.2f} cycles an "
        f"addition (one thread, {dadd['adds']} dependent additions)")
    k5_sizes = []
    if "sketch" in sel:
        digest_inputs = check_digest_schedules(engine, runs, weights)
        k5_sizes += [check_k5(name, *digest_inputs[name], dadd["ns"])
                     for name in ("pct_scalar", "pct_raw_month",
                                  "pct_tdigest_supp")]
        values, offsets = digest_inputs["pct_scalar"]
        k5_sizes.append(check_k5("pct_scalar's values + 0.5 (the chain "
                                 "regime)", values + 0.5, offsets,
                                 dadd["ns"], exact=False))
        del digest_inputs, values, offsets
        check_sketch_kernels(engine, k1, k3)
    if "highcard" in sel:
        check_highcard_kernels(engine, k1)
    torch.cuda.empty_cache()
    if "mv" in sel:
        check_mv_kernels(engine, k1, k2, k3, k5_sizes, dadd["ns"])
        torch.cuda.empty_cache()
    if "values" in sel:
        check_values_kernels(engine, k1, k2)
        torch.cuda.empty_cache()
    sub_bytes = wide_bytes = None
    if "tail" in sel:
        sub_engine, sub_bytes, wide_bytes = subbyte_twins(
            trips_dirs, want, path_rows["tail"], QueryEngine)
        check_tail_kernels(engine, sub_engine, k1, k2, k3, k4)
        del sub_engine
        torch.cuda.empty_cache()
    if "realtime" in sel:
        check_realtime_kernels(engine, k1, k2, k3, k4, args.up_rows)
        torch.cuda.empty_cache()
    if "multistage" in sel:
        check_multistage_kernels(engine, k1, k2, k3, k5_sizes, dadd["ns"],
                                 ms_runs_, weights)
        torch.cuda.empty_cache()
    adversarial = check_k5_adversarial(dadd["ns"])["cases"]
    if not k5_sizes:
        # no path of this run captured a digest: the first adversarial
        # input gives the kernel line's numbers
        label, vals, off, _start, _expect = k5_adversarial()[0]
        k5_sizes.append(check_k5(f"k5_adversarial's {label}",
                                 torch.from_numpy(vals).cuda(),
                                 torch.from_numpy(off).cuda(), dadd["ns"],
                                 exact=False))
    k5 = dict(k5_sizes[0], sizes=k5_sizes, dadd=dadd, adversarial=adversarial)

    count_sorted_builds()
    p50, launches = {}, {name: 0 for name in kernels.launches}
    for path in PATHS:
        if path not in sel or path == "mesh":
            continue
        path_p50, counts = run_path(engine, path, want,
                                    path_rows.get(path, total), args.runs,
                                    args.profile)
        p50.update(path_p50)
        for name, count in counts.items():
            launches[name] += count
    if "values" in sel:
        # the values path's second load of lineorder's planes, beside the
        # first: the bytes each batch holds on the card
        v2_bytes = engine.device.batch_for(v2_segs).resident_bytes
        log(f"{V2_TABLE} holds {v2_bytes} device bytes over {len(v2_segs)} "
            f"segments ({path_rows['values']} rows), beside "
            f"lineorder's {ctx.resident_bytes} over {S} (the same {total} "
            f"rows loaded once more as {V2_TABLE}'s first {S} segments)")
    f32_diff = reduce_bytes = overflow = None
    if "startree" in sel:
        # bench.py's exactness gate: the cube-routed q4 answers exactly
        # like both forced-scan forms
        cube_rows = engine.execute(ST_QUERIES["q4_highcard_hll"])
        for name in ("q4_scan_hll", "q4_scan_hll_cold"):
            if engine.execute(HLL_QUERIES[name])["resultTable"]["rows"] \
                    != cube_rows["resultTable"]["rows"]:
                raise AssertionError(f"q4_highcard_hll differs from {name}")
        # the f32 DOUBLE cube column against the exact integer sums
        q5 = engine.execute(ST_QUERIES["q5_startree"])["resultTable"]["rows"]
        f32_diff = max(abs(r[2] - e) for r, e in zip(q5, want["q5_exact"]))
        log(f"q4_highcard_hll equals q4_scan_hll and q4_scan_hll_cold row "
            f"for row; q5_startree's sums (float32 cube rows) differ from "
            f"the exact integer sums by at most {f32_diff:.1f}")
    if "ssb" in sel:
        reduce_bytes = check_device_reduce(engine, want)
        # q6's MIN / MAX / MINMAXRANGE planes reach K2 as stored: no torch
        # op (a widening, a FOR add) reads them
        q6_planes = {"dv::" + c: ctx.decoded_column(c)
                     for c in ("lo_revenue", "lo_quantity")}
        readers = plane_readers(engine, QUERIES["q6_minmax"], q6_planes)
        if any(readers.values()):
            raise AssertionError(f"q6: torch ops read its stored min/max "
                                 f"planes before K2: {readers}")
        log("q6: torch ops reading its stored min/max planes: none ("
            + ", ".join(f"{k} {str(v.dtype).replace('torch.', '')}"
                        for k, v in q6_planes.items()) + "); K2 reads them")
        overflow = overflow_cost(engine, args.runs)
    multistage = realtime = serving = mesh = None
    member_records, member_launches = {}, {}
    if "multistage" in sel:
        t = time.perf_counter()
        multistage = run_multistage(engine, want, True)
        log(f"multistage path extras: {time.perf_counter() - t:.2f} s")
    if "realtime" in sel:
        t = time.perf_counter()
        realtime = run_realtime(engine, rt_seg, rt_stream, rt_offset, rt,
                                want, up_mgr, up_topic, up, args.runs, True)
        up_mgr.stop(commit_remaining=False)
        realtime["index"] = rt_index
        realtime["upsert_rows_per_s"] = args.up_rows / up_s
        log(f"realtime path extras: {time.perf_counter() - t:.2f} s")
    elif up is not None:
        up_mgr.stop(commit_remaining=False)
    if "serving" in sel:
        t = time.perf_counter()
        serving, member_records, member_launches = run_serving(
            engine, want, {"lineorder": total, BS_TABLE: total}, card)
        log(f"serving path: {time.perf_counter() - t:.2f} s")
    advisor = None
    if "advisor" in sel:
        t = time.perf_counter()
        advisor, counts, adv_k4 = run_advisor(engine, bs_segs, want, total,
                                              args.runs)
        for name, count in counts.items():
            launches[name] += count
        k4["sizes"].append(adv_k4)
        log(f"advisor path: {time.perf_counter() - t:.2f} s")
    if "mesh" in sel:
        t = time.perf_counter()
        mesh, counts = run_mesh(engine, args.runs, args.profile)
        for name, count in counts.items():
            launches[name] += count
        log(f"mesh path: {time.perf_counter() - t:.2f} s")
    cluster = None
    cl_phases = [p for p in ("cluster",) + M3_PATHS if p in sel]
    if cl_phases:
        t = time.perf_counter()
        cluster, counts = run_cluster(
            engine, dirs, bs_dirs, dim_dirs, dim_schemas, want, total,
            args.runs, (k1, k2, k3, k4, k5), dadd["ns"], phases=cl_phases)
        for name, count in counts.items():
            launches[name] += count
        log(f"cluster path: {time.perf_counter() - t:.2f} s")
    hbm = engine.device.hbm_stats()
    log(f"batch LRU: {hbm['cached_batches']} batches, {hbm['resident_bytes']} "
        f"resident bytes of a {hbm['max_cached_bytes']}-byte budget; "
        f"{hbm['batch_hits']} hits, {hbm['batch_misses']} misses, "
        f"{hbm['batch_evictions']} evictions")

    entries = []
    for name, res, replaces in (
            ("group_plane_sums", k1, "pinot_tpu/ops/pallas_scatter.py:244 "
             "(and pinot_tpu/ops/groupby_mm.py:225)"),
            ("group_minmax", k2, "pinot_tpu/ops/pallas_scatter.py:349"),
            ("hll_register_max", k3, "pinot_tpu/ops/pallas_scatter.py:455 "
             "(and pinot_tpu/ops/groupby_mm.py:225 in rho_mode)"),
            ("fused_filter_agg", k4, "pinot_tpu/ops/pallas_scatter.py:792"),
            ("cluster_sums", k5, "none: port-only (the reference sums each "
             "cluster on its host, pinot_tpu/ops/quantile_digest.py:34 "
             "compress)")):
        entry = {"name": name, "route": "cuda",
                 "source": f"pinot_tpu_torch/csrc/{kernels.SOURCES[name]}",
                 "replaces": replaces, "launches": launches[name]}
        entry.update(res)
        if name == "cluster_sums":
            entry["path_regimes"] = dict(K5_PATH_REGIMES)
        if mesh is not None and name in MESH_SHARD_KERNELS:
            entry["mesh_shard_launches"] = [
                shard[name] for shard in MESH_SHARD_LAUNCHES]
        entries.append(entry)
    for name, (solo, replaces) in SERVE_ENTRIES.items():
        if "serving" not in sel:
            break
        if name not in member_records:
            raise AssertionError(f"{name} was never held at a cohort's inputs")
        entry = {"name": name, "route": "cuda",
                 "source": f"pinot_tpu_torch/csrc/{kernels.SOURCES[solo]}",
                 "replaces": replaces, "launches": member_launches[name]}
        entry.update(member_records[name])
        entries.append(entry)
    log(json.dumps({"query_p50_ms": p50, "rows": total,
                    "first_run_ms": FIRST_RUN_MS,
                    "paths": sel,
                    "serving": serving,
                    "realtime": realtime,
                    "multistage": multistage,
                    "advisor": advisor,
                    "mesh": mesh,
                    "cluster": cluster,
                    "trips_rows": path_rows["tail"],
                    "trips_resident_bytes": {"subbyte": sub_bytes,
                                             "wide": wide_bytes},
                    "overflow_cost": overflow,
                    "device_reduce_fetch_bytes": reduce_bytes,
                    "cube_build_s": list(cube_s),
                    "q5_startree_max_abs_diff_from_exact": f32_diff}))
    log(json.dumps({"kernels": entries}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:  # noqa: BLE001 — any failure fails the run
        traceback.print_exc()
        rc = 1
    finally:
        shutil.rmtree(DATA_DIR, ignore_errors=True)
    sys.exit(rc)
