"""The mesh's own dryrun: ``python -m pinot_tpu_torch.parallel.dryrun N``.

The checks of the reference's ``__graft_entry__.py dryrun_multichip``:

1. One pipeline template per cross-shard combine family (psum of count,
   sum and avg; pmin / pmax of min, max and minmaxrange; presence pmax;
   register pmax; the FIRST/LASTWITHTIME time pair; the scalar combine),
   each run sharded over an N-device mesh (engine/device.py
   ``build_pipeline`` per shard, parallel/mesh.py ``combine_outs``) and
   on one device over the same (S, L) columns: every leaf equal, bit for
   bit; the psum family's counts and sums also held to numpy.
2. Seven hard shapes at the engine level over real segments (N + 3 of
   them, mesh-unaligned, one upsert-masked): dense group-by, the time
   pair, the sorted high-cardinality regime, nulls, MV aggregations, the
   upsert-masked mixed batch and distinct presence, a mesh engine's rows
   equal to a single-device engine's and to numpy's where numpy has the
   exact answer.

The mesh is ``make_mesh(N)`` where N cards are visible, else the first
device repeated N times (the card, or the CPU without one). The tests
(tests/test_torch_mesh.py) run both parts on the CPU and hold the hard
shapes against the reference's host engine too.
"""

from __future__ import annotations

import math
import os
import shutil
import sys
import tempfile

import numpy as np
import torch


def dryrun_mesh(n: int):
    """The mesh the dryrun runs on: N cards where they are visible, else
    the first device N times."""
    from pinot_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.is_available():
        if torch.cuda.device_count() >= n:
            return make_mesh(n)
        return make_mesh(devices=[torch.device("cuda", 0)] * n)
    return make_mesh(n)


def family_templates(n_segments: int, device, seg_len: int = 256):
    """(templates by family, cols, n_docs, params, k1, v, n_docs numpy):
    toy columns on ``device`` and one template per combine family."""
    from pinot_tpu_torch.ops import hll as hll_ops

    rng = np.random.default_rng(0)
    k1 = rng.integers(0, 8, (n_segments, seg_len)).astype(np.int32)
    v = rng.integers(0, 100, (n_segments, seg_len)).astype(np.int32)
    t = rng.integers(0, 40, (n_segments, seg_len)).astype(np.int64)
    h = np.asarray(hll_ops.hash32_np(v.reshape(-1))).astype(np.uint32) \
        .view(np.int32).reshape(v.shape)
    cols = {k: torch.from_numpy(a).to(device)
            for k, a in (("k1", k1), ("v", v), ("t", t), ("hh::v", h))}
    nd = np.full(n_segments, seg_len - 16, dtype=np.int32)
    n_docs = torch.from_numpy(nd).to(device)
    params = {"pr0": torch.tensor(30, dtype=torch.int32, device=device)}
    filt = ("range_raw", ("raw", "v"), "pr0", "pr0", True, False, False,
            True)
    pair = (("raw", "v"), ("raw", "t"))
    fams = {
        "psum(count,sum,avg)": (
            "groupby", filt, ("k1",), (8,),
            (("count", None, None), ("sum", ("raw", "v"), (None, None)),
             ("avg", ("raw", "v"), (None, None))), 0, False),
        "pmin/pmax(min,max,minmaxrange)": (
            "groupby", filt, ("k1",), (8,),
            (("min", ("raw", "v"), None), ("max", ("raw", "v"), None),
             ("minmaxrange", ("raw", "v"), None)), 0, False),
        "presence-pmax(distinctcount)": (
            "groupby", filt, ("k1",), (8,),
            (("distinctcount", "k1", 8),), 0, False),
        "register-pmax(hll)": (
            "groupby", filt, ("k1",), (8,),
            (("distinctcounthll", "v", 10),), 0, False),
        "time-pair(first/lastwithtime)": (
            "groupby", filt, ("k1",), (8,),
            (("lastwithtime", pair, "pair"),
             ("firstwithtime", pair, "pair")), 0, False),
        "scalar-psum/pmin/pmax": (
            "agg", filt, (), (),
            (("count", None, None), ("sum", ("raw", "v"), (None, None)),
             ("min", ("raw", "v"), None), ("max", ("raw", "v"), None),
             ("lastwithtime", pair, "pair")), 0, False),
    }
    return fams, cols, n_docs, params, k1, v, nd


def check_families(mesh, min_rows: int = 0) -> list:
    """Each combine family sharded == single device, leaf for leaf; the
    psum family's groups and sums == numpy. Returns the families."""
    from pinot_tpu_torch.engine.device import build_pipeline
    from pinot_tpu_torch.parallel import mesh as mesh_ops

    dev = mesh.devices[0]
    fams, cols, n_docs, params, k1, v, nd = family_templates(
        2 * mesh.size, dev)
    S = int(n_docs.shape[0])
    ok, psum = [], None
    for name, template in fams.items():
        pipe = build_pipeline(template, None, min_rows)
        single = pipe(cols, n_docs, params)
        outs = []
        for d, (lo, hi) in enumerate(mesh_ops.shard_slices(S, mesh.size)):
            if hi <= lo:
                continue
            sd = mesh.devices[d]
            c = {k: x[lo:hi].to(sd) for k, x in cols.items()}
            p = mesh_ops.shard_params(params, lo, hi, sd)
            mesh_ops.check_placement(d, sd, {**c, **p})
            outs.append(pipe(c, n_docs[lo:hi].to(sd), p))
        sharded = mesh_ops.combine_outs(outs, template[4], dev)
        for key, want in single.items():
            got = sharded[key]
            assert got.shape == want.shape and torch.equal(
                got.cpu(), want.cpu()), (name, key, got, want)
        if name.startswith("psum"):
            psum = sharded
        ok.append(name)
    valid = np.arange(k1.shape[1])[None, :] < nd[:, None]
    mask = valid & (v > 30)
    want_count = np.bincount(k1[mask], minlength=8)
    assert np.array_equal(psum["gcount"].cpu().numpy(), want_count)
    want_sum = np.bincount(k1[mask], weights=v[mask], minlength=8)
    assert np.array_equal(psum["a1_sum"].cpu().numpy().astype(np.int64),
                          want_sum.astype(np.int64))
    return ok


HARD_SHAPES = {
    "dense-groupby": (
        "SELECT k, COUNT(*), SUM(v), MIN(v), MAX(v), AVG(v) FROM hard "
        "WHERE v > 100 GROUP BY k ORDER BY k"),
    "time-pair": (
        "SELECT k, LASTWITHTIME(v, ts, 'LONG'), "
        "FIRSTWITHTIME(v, ts, 'LONG') FROM hard GROUP BY k ORDER BY k"),
    "sorted-regime-highcard": (
        "SELECT hc1, hc2, COUNT(*), SUM(v) FROM hard "
        "GROUP BY hc1, hc2 ORDER BY COUNT(*) DESC, hc1, hc2 LIMIT 25"),
    "nulls": (
        "SELECT k, COUNT(*), SUM(nv) FROM hard WHERE nv IS NOT NULL "
        "GROUP BY k ORDER BY k"),
    "mv": (
        "SELECT k, COUNTMV(tags), DISTINCTCOUNTMV(tags) "
        "FROM hard GROUP BY k ORDER BY k"),
    "upsert-masked-mixed": (
        "SELECT k, COUNT(*), SUM(v) FROM hard GROUP BY k ORDER BY k"),
    "distinct-presence": (
        "SELECT COUNT(*), DISTINCTCOUNT(k), DISTINCTCOUNTHLL(hc1) "
        "FROM hard WHERE v > 0"),
}


def write_hard_segments(n_devices: int, out_dir: str) -> tuple:
    """The hard shapes' segments (the reference's dryrun's data, from
    the same seed): N + 3 sealed segments of ragged lengths, the first
    pinning hc1 and hc2 at 2,100 values each (2100^2 keys, past the dense
    regime), and an upsert-masked one. Returns (directories, the masked
    segment's valid-docs mask, the columns each segment holds)."""
    from pinot_tpu_torch.common.datatypes import DataType
    from pinot_tpu_torch.common.schema import Schema
    from pinot_tpu_torch.storage.creator import build_segment

    rng = np.random.default_rng(4)
    n_segments, rows = n_devices + 3, 1500
    schema = Schema.build(
        name="hard",
        dimensions=[("k", DataType.STRING), ("hc1", DataType.INT),
                    ("hc2", DataType.INT)],
        multi_value_dimensions=[("tags", DataType.STRING)],
        metrics=[("v", DataType.LONG), ("nv", DataType.DOUBLE),
                 ("ts", DataType.LONG)])

    def make_cols(n, full_card=False):
        hc1 = rng.integers(0, 2100, n).astype(np.int32)
        hc2 = rng.integers(0, 2100, n).astype(np.int32)
        if full_card:
            hc1[:2100] = np.arange(2100, dtype=np.int32)
            hc2[:2100] = np.arange(2100, dtype=np.int32)
        return {
            "k": np.array(["a", "b", "c", "d", "e"])[rng.integers(0, 5, n)],
            "hc1": hc1,
            "hc2": hc2,
            "tags": [list(np.array(["x", "y", "z"])[
                rng.choice(3, size=rng.integers(0, 3), replace=False)])
                for _ in range(n)],
            "v": rng.integers(-50, 10_000, n).astype(np.int64),
            "nv": rng.normal(0, 10, n),
            "ts": rng.integers(0, 30, n).astype(np.int64),
        }

    dirs, data = [], []
    for i in range(n_segments):
        n = 2400 if i == 0 else max(300, rows - 37 * i)
        cols = make_cols(n, full_card=(i == 0))
        nulls = {"nv": rng.random(n) < 0.2}
        d = os.path.join(out_dir, f"s{i}")
        build_segment(schema, cols, d, segment_name=f"s{i}",
                      null_masks=nulls)
        dirs.append(d)
        data.append((cols, nulls["nv"], None))
    cols = make_cols(700)
    d = os.path.join(out_dir, "masked")
    build_segment(schema, cols, d, segment_name="masked")
    valid = np.ones(700, dtype=bool)
    valid[::3] = False
    dirs.append(d)
    data.append((cols, np.zeros(700, dtype=bool), valid))
    return dirs, valid, data


def _numpy_rows(fam: str, data) -> list | None:
    """numpy's rows for the hard shapes it answers exactly."""
    def cat(name, sel=None):
        parts = []
        for cols, nulls, valid in data:
            m = np.ones(len(cols["v"]), dtype=bool) if valid is None \
                else valid.copy()
            if sel == "notnull":
                m &= ~nulls
            parts.append(np.asarray(cols[name], dtype=object
                                    if name == "tags" else None)[m])
        return np.concatenate(parts)

    k, v = cat("k"), cat("v")
    if fam in ("dense-groupby", "upsert-masked-mixed"):
        m = v > 100 if fam == "dense-groupby" else np.ones(len(v), bool)
        out = []
        for key in sorted(set(k[m].tolist())):
            x = v[m & (k == key)]
            out.append([key, len(x), float(x.sum())]
                       + ([float(x.min()), float(x.max()),
                           float(x.sum()) / len(x)]
                          if fam == "dense-groupby" else []))
        return out
    if fam == "mv":
        tags = cat("tags")
        out = []
        for key in sorted(set(k.tolist())):
            sel = [t for t, kk in zip(tags, k) if kk == key]
            out.append([key, sum(len(t) for t in sel),
                        len({x for t in sel for x in t})])
        return out
    return None


def check_hard_shapes(mesh, out_dir: str, n_devices: int,
                      device=None) -> dict:
    """The hard shapes over a mesh engine and a single-device engine:
    {family: rows}, mesh == single (integers exactly, floats to 1e-9
    relative) and == numpy where ``_numpy_rows`` answers."""
    from pinot_tpu_torch.engine.device import DeviceExecutor
    from pinot_tpu_torch.engine.engine import QueryEngine
    from pinot_tpu_torch.storage.segment import ImmutableSegment

    dirs, valid, data = write_hard_segments(n_devices, out_dir)
    segs = [ImmutableSegment(d) for d in dirs]
    segs[-1].valid_docs_mask = valid
    single = QueryEngine(device=device or mesh.devices[0])
    meshed = QueryEngine(device_executor=DeviceExecutor(mesh=mesh))
    for eng in (single, meshed):
        if device is not None and torch.device(device).type == "cpu":
            eng.device.min_rows = 0
        for s in segs:
            eng.add_segment("hard", s)
    out = {}
    for fam, sql in HARD_SHAPES.items():
        rs = {}
        for name, eng in (("mesh", meshed), ("single", single)):
            r = eng.execute(sql)
            assert not r.get("exceptions"), (fam, name, r["exceptions"])
            rs[name] = r["resultTable"]["rows"]
        assert rows_match(rs["mesh"], rs["single"]), (fam, rs)
        want = _numpy_rows(fam, data)
        if want is not None:
            assert rows_match(rs["single"], want), (fam, rs["single"][:3],
                                                     want[:3])
        out[fam] = rs["mesh"]
    return out


def rows_match(a, b, rel: float = 1e-9) -> bool:
    if len(a) != len(b):
        return False
    for ra, rb in zip(a, b):
        if len(ra) != len(rb):
            return False
        for x, y in zip(ra, rb):
            if isinstance(x, float) or isinstance(y, float):
                x, y = float(x), float(y)
                if not (math.isclose(x, y, rel_tol=rel, abs_tol=1e-9)
                        or (math.isnan(x) and math.isnan(y))):
                    return False
            elif x != y:
                return False
    return True


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    mesh = dryrun_mesh(n)
    device = "cpu" if mesh.devices[0].type == "cpu" else None
    fams = check_families(mesh)
    tmp = tempfile.mkdtemp(prefix="mesh_dryrun_")
    try:
        shapes = check_hard_shapes(mesh, tmp, n, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"mesh dryrun OK: {mesh}, {2 * n} segments, combine families "
          f"(sharded == single): {fams}; hard shapes (mesh == single): "
          f"{list(shapes)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
