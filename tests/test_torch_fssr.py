"""The port's FSSR modules against mve_tpu's, on the CPU.

Both packages get the same samples, made from a seed with numpy: a
sphere, two hemispheres at two scales, and two planes with a step. The
device programs of fssr/block_eval.py (plain PyTorch here, XLA there)
agree to float32 rounding: exp, log and the order of the sums over the
sample axis differ between the two. The host code (octree, voxel set,
dual contouring, marching tetrahedra, mesh cleanup, sample I/O) is a
numpy copy and is held to mve_tpu's output exactly: given mve_tpu's
implicit-function data the port writes byte-identical PLYs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mve_tpu.core import mesh_io as jmesh_io
from mve_tpu.core.mesh import TriangleMesh as JMesh
from mve_tpu.fssr import block_eval as jbe
from mve_tpu.fssr import dual_contouring as jdc
from mve_tpu.fssr import iso_octree as jio
from mve_tpu.fssr import mesh_clean as jclean
from mve_tpu.fssr import octree as joct
from mve_tpu.fssr import sample as jsample
from mve_tpu.fssr import streaming as jstream
from mve_tpu.fssr.iso_surface import IsoSurface as JIsoSurface

from mve_tpu_torch.core import mesh_io as pmesh_io
from mve_tpu_torch.core.mesh import TriangleMesh as PMesh
from mve_tpu_torch.fssr import block_eval as pbe
from mve_tpu_torch.fssr import dual_contouring as pdc
from mve_tpu_torch.fssr import iso_octree as pio
from mve_tpu_torch.fssr import mesh_clean as pclean
from mve_tpu_torch.fssr import octree as poct
from mve_tpu_torch.fssr import sample as psample
from mve_tpu_torch.fssr import streaming as pstream
from mve_tpu_torch.fssr.iso_surface import IsoSurface as PIsoSurface

torch.set_num_threads(1)


def _fields(s):
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)}


def _pair(pos, normal, scale, seed):
    """The same arrays as a SampleList of each package (jax, port)."""
    rng = np.random.RandomState(seed + 1000)
    n = len(pos)
    arrs = dict(pos=pos.astype(np.float32), normal=normal.astype(np.float32),
                color=rng.rand(n, 3).astype(np.float32),
                scale=scale.astype(np.float32),
                confidence=rng.uniform(0.3, 1.0, n).astype(np.float32))
    return jsample.SampleList(**arrs), psample.SampleList(**arrs)


def sphere(n=1500, radius=1.0, scale=0.12, seed=0):
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pos = v * radius * (1 + 0.003 * rng.randn(n, 1))
    return _pair(pos, v, scale * np.exp(0.1 * rng.randn(n)), seed)


def hemispheres(n=2000, seed=1):
    """A sphere whose upper half is sampled at scale 0.06 and lower half at
    0.15: the per-voxel scale filter drops coarse samples near the seam."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    scale = np.where(v[:, 2] > 0, 0.06, 0.15) * np.exp(0.05 * rng.randn(n))
    return _pair(v * (1 + 0.002 * rng.randn(n, 1)), v, scale, seed)


def step_planes(n=2000, seed=2):
    """z = 0 for x < 0 and z = 0.3 for x >= 0, over [-1, 1]^2, normals +z."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-1, 1, (n, 2))
    z = np.where(xy[:, 0] < 0, 0.0, 0.3) + 0.002 * rng.randn(n)
    nrm = np.tile([0.0, 0.0, 1.0], (n, 1)) + 0.02 * rng.randn(n, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    return _pair(np.c_[xy, z], nrm, 0.1 * np.exp(0.1 * rng.randn(n)), seed)


def scale_diverse(seed=3):
    """tests/test_fssr.py's octave-group set: the unit square at scale 0.1
    and a 0.05-wide patch at scale 0.001 (a span of 100)."""
    rng = np.random.RandomState(seed)
    parts = []
    for x0, x1, y0, y1, scale, n in ((0, 1, 0, 1, 0.1, 150), (0.2, 0.25, 0.2, 0.25, 0.001, 600)):
        parts.append((np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n),
                                rng.randn(n) * scale * 0.01], 1), np.full(n, scale)))
    pos = np.concatenate([p for p, _ in parts])
    return _pair(pos, np.tile([0.0, 0.0, 1.0], (len(pos), 1)),
                 np.concatenate([s for _, s in parts]), seed)


SETS = {"sphere": sphere, "hemispheres": hemispheres, "step_planes": step_planes}


# ---------------------------------------------------------------------------
# device programs on fixed padded inputs
# ---------------------------------------------------------------------------

def _fixed_inputs(seed=0, B=3, S=256):
    """One dispatch's inputs, as run_chunk builds them: voxels in a block,
    candidate samples around it (some rows padded), no pair within 1e-4
    of the influence radius and no log-scale within 1e-3 of a bin edge."""
    rng = np.random.RandomState(seed)
    n = 600
    p = rng.uniform(-0.3, 0.3, (n, 3))
    nrm = rng.randn(n, 3)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    # Scales in the middle fifths of histogram bins of [0.01, 0.3].
    log_lo, inv_width = float(np.log(0.01)), 64 / float(np.log(30.0))
    x = rng.randint(8, 56, n) + rng.uniform(0.2, 0.8, n)
    table = np.zeros((1024, 13), np.float32)
    table[:n, 0:3] = p
    table[:n, 3:6] = nrm
    table[:n, 6] = np.exp(log_lo + x / inv_width)
    table[:n, 7] = rng.uniform(0.2, 1.0, n)
    table[:n, 8:11] = rng.rand(n, 3)
    vox = rng.uniform(-0.1, 0.1, (B, 64, 3)).astype(np.float32)
    vmask = np.ones((B, 64), bool)
    vmask[-1, 40:] = False
    sidx = np.stack([rng.choice(n, S, replace=False) for _ in range(B)])
    smask = np.ones((B, S), bool)
    smask[1, 200:] = False
    # A sample with a pair within 1e-4 of q = 9 moves far away.
    d = vox[:, :, None, :].astype(np.float64) - table[sidx][:, None, :, 0:3]
    q = (d * d).sum(-1) / table[sidx][:, None, :, 6].astype(np.float64) ** 2
    table[np.unique(np.broadcast_to(sidx[:, None, :], q.shape)[np.abs(q - 9.0) < 1e-4]), 0] += 10.0
    thresh = rng.uniform(0.03, 0.12, (B, 64)).astype(np.float32)
    return (vox, vmask, table, sidx, smask), thresh, (log_lo, inv_width)


def _rel(a, b):
    """|a - b| over each column's largest |b|, per element."""
    scale = np.abs(b).reshape(-1, b.shape[-1]).max(axis=0)
    return np.abs(a - b) / np.where(scale > 0, scale, 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_dense_programs_agree(seed):
    args, thresh, _ = _fixed_inputs(seed)
    jargs = tuple(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in args)
    pargs = tuple(torch.from_numpy(a) for a in args)
    want = np.asarray(jbe._eval_dense(*jargs))
    got = pbe._eval_dense(*pargs).numpy()
    assert np.abs(want).max() > 0
    assert _rel(got, want).max() < 1e-5
    want = np.asarray(jbe._eval_dense_thresh(*jargs, jnp.asarray(thresh)))
    got = pbe._eval_dense_thresh(*pargs, torch.from_numpy(thresh)).numpy()
    assert _rel(got, want).max() < 1e-5
    # The masked rows and voxels are zero in both.
    assert not got[~args[1]].any() and not want[~args[1]].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_hist_dense_identical(seed):
    args, _, (log_lo, inv_width) = _fixed_inputs(seed)
    jargs = tuple(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a) for a in args)
    want = np.asarray(jbe._hist_dense(*jargs, jnp.asarray(log_lo), jnp.asarray(inv_width)))
    got = pbe._hist_dense(*(torch.from_numpy(a) for a in args),
                          float(np.float32(log_lo)), float(np.float32(inv_width))).numpy()
    assert want.sum() > 1000
    np.testing.assert_array_equal(got, want)


def test_scale_bisect_is_mve_tpus_filter():
    """The bisection keeps the same pairs as mve_tpu's _eval_dense: with
    keep forced to the port's, the port's accumulators reproduce
    mve_tpu's sums; and the threshold is the count//10-th smallest
    in-radius scale within 2^-24 of the block's largest scale."""
    args, _, _ = _fixed_inputs(2)
    pargs = tuple(torch.from_numpy(a) for a in args)
    t = pbe._pair_terms(pargs[0], pargs[2], pargs[3], pargs[4])
    hi = pbe._scale_bisect(t["in_rad"], t["s"], t["s_scale"], pargs[4]).numpy()
    in_rad = t["in_rad"].numpy()
    s = np.broadcast_to(t["s"].numpy(), in_rad.shape)
    smax = np.where(args[4], args[2][args[3], 6], 0).max(axis=1)
    for b, v in zip(*np.nonzero(in_rad.any(-1))):
        ss = np.sort(s[b, v][in_rad[b, v]])
        kth = ss[len(ss) // 10]
        assert kth <= hi[b, v] <= kth + smax[b] * 2.0 ** -24


# ---------------------------------------------------------------------------
# evaluate_positions_blocked
# ---------------------------------------------------------------------------

def _positions(js, n=4000, seed=5):
    rng = np.random.RandomState(seed)
    lo = js.pos.min(0) - 2 * js.scale.max()
    hi = js.pos.max(0) + 2 * js.scale.max()
    return rng.uniform(lo, hi, (n, 3)) * 0.5 + js.pos[rng.randint(len(js.pos), size=n)] * 0.5


def _threshold_moves(recorded):
    """Corners whose scale-filter threshold differs between the packages,
    over the recorded dispatches of the port's _eval_dense: the bisection
    is exact arithmetic on integer counts, so a threshold moves only where
    mve_tpu's influence test (q < 9) decides a pair the other way."""
    moved = total = 0
    for vox, vmask, samp, sidx, smask in recorded:
        t = pbe._pair_terms(vox, samp, sidx, smask)
        jt = jbe._pair_terms(*(jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64
                                           else a.numpy()) for a in (vox, samp, sidx, smask)))
        j_in = torch.from_numpy(np.array(jt["in_rad"]))
        a = pbe._scale_bisect(t["in_rad"], t["s"], t["s_scale"], smask)
        b = pbe._scale_bisect(j_in, t["s"], t["s_scale"], smask)
        moved += int(((a != b) & vmask).sum())
        total += int(vmask.sum())
    return moved, total


@pytest.mark.parametrize("name", sorted(SETS) + ["scale_diverse"])
def test_evaluate_positions_blocked(name, monkeypatch):
    """Sums within 1e-4 of each column's largest magnitude on at least
    99.9% of the corners. Measured: every corner, to about 3e-7; no
    corner's scale-filter threshold moved on these sets (no pair lies
    within a rounding of the influence radius), and on the scale-diverse
    set no voxel's histogram moved by a bin."""
    js, ps = (scale_diverse() if name == "scale_diverse" else SETS[name]())
    q = _positions(js)
    recorded = []
    real = pbe._eval_dense

    def record(*args):
        recorded.append(args)
        return real(*args)

    monkeypatch.setattr(pbe, "_eval_dense", record)
    want = jbe.evaluate_positions_blocked(js, q)
    got = pbe.evaluate_positions_blocked(ps, q, device="cpu")
    assert np.abs(want[:, 1]).max() > 0 and (want[:, 1] > 0).mean() > 0.2
    rel = _rel(got, want).max(axis=1)
    assert (rel < 1e-4).mean() >= 0.999, np.sort(rel)[-5:]
    assert rel.max() < 1e-5
    if name == "scale_diverse":
        assert pbe.STATS["path"] == "octave-hist" and not recorded
        # The histogram pass alone: every voxel's histogram identical.
        scale = js.scale.astype(np.float64)
        log_lo = np.log(scale.min())
        inv_width = pbe.HIST_BINS / (np.log(scale.max()) + 1e-9 - log_lo)
        part = pbe.partition_positions(q, 4.0 * 0.1)
        jpart = jbe.BlockPartition(**_fields(part))
        hj = np.zeros((len(q), pbe.HIST_BINS))
        hp = np.zeros((len(q), pbe.HIST_BINS))
        jbe.run_chunk(jpart, js, hj, mode="hist", hist_log_lo=log_lo, hist_inv_width=inv_width)
        pbe.run_chunk(part, ps, hp, mode="hist", hist_log_lo=log_lo, hist_inv_width=inv_width,
                      device="cpu")
        assert hj.sum() > 0
        assert (hj != hp).any(axis=1).sum() == 0
    else:
        assert pbe.STATS["path"] == "bisect" and recorded
        moved, total = _threshold_moves(recorded)
        assert total >= (want[:, 1] > 0).sum() and moved == 0


def test_borderline_pairs_are_counted(monkeypatch):
    """Every pair placed within about 1e-7 of the influence radius (q = 9):
    the packages could decide such a pair differently (dist2 is a
    three-term sum, which XLA's CPU backend may fuse into multiply-adds).
    Such a pair has weight w(9) = 0; it would move a corner's threshold
    through the count//10 only. Counted, not emulated: measured, all 7,980
    in-radius pairs are decided alike and no threshold moves; allowed, at
    most 0.1% of the pairs and 2 of the 64 corners. (The sums themselves
    are not compared here: with every pair at the radius they are made of
    w's cancellation noise, 1 - 6 + 8 - 3 at q = 9.)"""
    rng = np.random.RandomState(7)
    n = 256
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    scale = (0.05 * np.exp(0.3 * rng.randn(n))).astype(np.float32)
    pos = (dirs * (3.0 * scale[:, None]) * (1 + 1e-7 * rng.randn(n, 1))).astype(np.float32)
    _, ps = _pair(pos, dirs, scale, 7)
    q = 1e-7 * rng.randn(64, 3)
    recorded = []
    real = pbe._eval_dense

    def record(*args):
        recorded.append(args)
        return real(*args)

    monkeypatch.setattr(pbe, "_eval_dense", record)
    pbe.evaluate_positions_blocked(ps, q, device="cpu")
    vox, _, samp, sidx, smask = recorded[0]
    port = pbe._pair_terms(vox, samp, sidx, smask)["in_rad"].numpy()
    ref = np.asarray(jbe._pair_terms(*(jnp.asarray(a.numpy()) for a in (vox, samp)),
                                     jnp.asarray(sidx.numpy().astype(np.int32)),
                                     jnp.asarray(smask.numpy()))["in_rad"])
    moved, total = _threshold_moves(recorded)
    assert ref.sum() > 5000 and total == 64
    assert (port != ref).sum() <= 1e-3 * ref.sum() and moved <= 2


# ---------------------------------------------------------------------------
# host code: identical arrays and byte-identical PLYs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SETS) + ["scale_diverse"])
def test_octree_and_voxel_set_identical(name):
    js, ps = (scale_diverse() if name == "scale_diverse" else SETS[name]())
    max_level = 14 if name == "scale_diverse" else 10
    a, b = joct.build_octree(js, max_level=max_level), poct.build_octree(ps, max_level=max_level)
    for f in ("center", "leaf_level", "leaf_coord"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.root_size == b.root_size and len(a.leaf_level) > 100
    ja = jio.IsoOctree()._build_voxel_set(js)
    pa = pio.IsoOctree(device="cpu")._build_voxel_set(ps)
    for x, y in zip(ja, pa):
        np.testing.assert_array_equal(x, y)
    origin, h, dims = ja[:3]
    cells = jio.mark_active_cells(js.pos.astype(np.float64), js.scale.astype(np.float64),
                                  origin, h, dims)
    np.testing.assert_array_equal(
        cells, pio.mark_active_cells(ps.pos.astype(np.float64), ps.scale.astype(np.float64),
                                     origin, h, dims))
    for x, y in zip(jio.voxels_from_cells(cells, dims), pio.voxels_from_cells(cells, dims)):
        np.testing.assert_array_equal(x, y)


def _save_both(jmesh, pmesh, tmp_path):
    jmesh_io.save_mesh(jmesh, str(tmp_path / "j.ply"))
    pmesh_io.save_mesh(pmesh, str(tmp_path / "p.ply"))
    a, b = (tmp_path / "j.ply").read_bytes(), (tmp_path / "p.ply").read_bytes()
    return a, b


@pytest.mark.parametrize("name", sorted(SETS))
def test_dual_contouring_ply_identical_given_the_data(name, tmp_path, monkeypatch):
    """DualContouring.extract_mesh with the port's evaluation replaced by
    one that returns mve_tpu's data: the same corners are asked for, and
    the PLY (after fssrecon's zero-confidence deletion) is byte-identical."""
    js, ps = SETS[name]()
    seen = {}
    real = jdc.evaluate_at_positions

    def jax_eval(samples, positions, *a, **k):
        seen["positions"] = positions
        seen["data"] = real(samples, positions)
        return seen["data"]

    monkeypatch.setattr(jdc, "evaluate_at_positions", jax_eval)
    jd = jdc.DualContouring(js)
    jm = jd.extract_mesh()

    def replay(samples, positions, device="cuda"):
        np.testing.assert_array_equal(positions, seen["positions"])
        return seen["data"]

    monkeypatch.setattr(pio, "evaluate_at_positions", replay)
    pd = pdc.DualContouring(ps, device="cpu")
    pm = pd.extract_mesh()
    assert pd.stats["n_corners"] == jd.stats["n_corners"]
    for m in (jm, pm):
        m.delete_vertices_fix_faces(m.vertex_confidences <= 0.0)
    a, b = _save_both(jm, pm, tmp_path)
    assert a == b and jm.num_faces() > 500


@pytest.mark.parametrize("interp", ["linear", "scaling", "lsderiv", "cubic"])
def test_iso_surface_ply_identical_given_the_data(interp, tmp_path):
    js, _ = hemispheres()
    g = jio.IsoOctree().compute_voxels(js)
    pg = pio.VoxelGrid(**_fields(g))
    jm = JIsoSurface(g, interpolation=interp).extract_mesh()
    pm = PIsoSurface(pg, interpolation=interp).extract_mesh()
    a, b = _save_both(jm, pm, tmp_path)
    assert a == b and jm.num_faces() > 500


def test_streaming_grid_identical_given_the_data(monkeypatch):
    """compute_voxels_streaming with run_chunk replaced by mve_tpu's: the
    same voxel grid, field for field."""
    js, ps = hemispheres(seed=4)

    def chunks(cls, s):
        def gen():
            for a in range(0, len(s), 600):
                yield cls(**{k: v[a:a + 600] for k, v in _fields(s).items()})
        return gen

    def jax_chunk(part, samples, out, device="cuda", **kw):
        jbe.run_chunk(jbe.BlockPartition(**_fields(part)), jsample.SampleList(**_fields(samples)),
                      out, **kw)

    want = jstream.compute_voxels_streaming(chunks(jsample.SampleList, js))
    monkeypatch.setattr(pbe, "run_chunk", jax_chunk)
    got = pstream.compute_voxels_streaming(chunks(psample.SampleList, ps), device="cpu")
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name))


def test_sample_io_identical(tmp_path):
    """PLY point sets read the same: whole, in chunks, vertex count, and the
    cleaning rules (a zero normal, a non-positive scale, a zero
    confidence, a NaN position)."""
    js, _ = sphere(n=500)
    mesh = JMesh()
    mesh.vertices = js.pos.copy()
    mesh.vertices[3] = np.nan
    mesh.vertex_normals = js.normal.copy()
    mesh.vertex_normals[5] = 0.0
    mesh.vertex_values = js.scale.copy()
    mesh.vertex_values[7] = -1.0
    mesh.vertex_confidences = js.confidence.copy()
    mesh.vertex_confidences[9] = 0.0
    mesh.vertex_colors = np.c_[js.color, np.ones(500)].astype(np.float32)
    path = str(tmp_path / "pset.ply")
    jmesh_io.save_mesh(mesh, path)
    assert psample.ply_vertex_count(path) == jsample.ply_vertex_count(path) == 500
    a = jsample.load_samples_from_ply(path, 1.5)
    b = psample.load_samples_from_ply(path, 1.5)
    assert len(a) == 496
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
    ca = list(jsample.stream_samples_from_ply(path, chunk_size=128))
    cb = list(psample.stream_samples_from_ply(path, chunk_size=128))
    assert len(ca) == len(cb) == 4
    for x, y in zip(ca, cb):
        np.testing.assert_array_equal(x.pos, y.pos)
        np.testing.assert_array_equal(x.scale, y.scale)
    merged = psample.merge_samples(cb)
    np.testing.assert_array_equal(merged.confidence, a.confidence)
    pm = pmesh_io.load_mesh(path)
    sm = psample.samples_from_mesh(pm, 1.5)
    np.testing.assert_array_equal(sm.normal, jsample.samples_from_mesh(jmesh_io.load_mesh(path), 1.5).normal)


def _needle_mesh(seed):
    """A jittered triangulated grid with collapsed rows: needles and caps."""
    rng = np.random.RandomState(seed)
    n = 24
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64)
    xs[:, 5] = xs[:, 4] + 0.05                     # needle column
    ys[9] = ys[8] + 0.03                           # needle row
    z = 0.01 * rng.randn(n, n)
    verts = np.stack([xs, ys, z], -1)
    # Caps: a vertex moved next to the middle of the diagonal of the quad
    # below it, so that the triangle (a, d, c) is nearly flat at c.
    for r, c in ((14, 2), (16, 10), (18, 15), (20, 20)):
        verts[r + 1, c] = 0.5 * (verts[r, c] + verts[r + 1, c + 1]) + [0.004, -0.004, 0.0]
    verts = verts.reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    out = []
    for cls in (JMesh, PMesh):
        m = cls()
        m.vertices = verts.astype(np.float32)
        m.faces = faces.astype(np.int32)
        m.vertex_confidences = np.ones(len(verts), np.float32)
        out.append(m)
    return out


@pytest.mark.parametrize("fn", ["clean_needles", "clean_caps", "clean_mc_mesh"])
def test_mesh_clean_identical(fn, tmp_path):
    """The port's union-find fallback against mve_tpu (which takes its
    native mesh_collapse_edges where built): the same collapses and
    byte-identical meshes."""
    jm, pm = _needle_mesh(3)
    na, nb = getattr(jclean, fn)(jm), getattr(pclean, fn)(pm)
    assert na == nb and na > 0
    a, b = _save_both(jm, pm, tmp_path)
    assert a == b


def test_pairwise_path_raises(monkeypatch):
    """mve_tpu's pair-list evaluator is not ported: asking for it raises
    instead of silently taking the block path."""
    _, ps = sphere(n=300)
    monkeypatch.setenv("MVE_TPU_FSSR_PAIRWISE", "1")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pio.evaluate_at_positions(ps, np.zeros((4, 3)), device="cpu")
    with pytest.raises(NotImplementedError):
        pio.IsoOctree(device="cpu").compute_voxels(ps)
