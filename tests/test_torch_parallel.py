"""The port's meshes, process groups, sharded bundle adjustment and
sharded FSSR evaluation against mve_tpu's, on the CPU.

mve_tpu shards over the conftest's 8 virtual JAX devices; the port over
meshes of CPU shards (["cpu"] * k) in this process, and over a gloo
process group of two processes. The problem is
__graft_entry__._synthetic_ba_problem(n_cams=12, n_pts=400,
n_obs_per_pt=4) with LM and CG capped as in tests/test_parallel.py
(max_iters=5, cg_max_iter=40).

Limits:
- against mve_tpu's lm_optimize_distributed and distributed_ba_step:
  final MSE within 1e-4 (float32) or 1e-9 (float64) relative, LM step
  counts equal; parameters within 1e-6 absolute in float64. In float32
  the parameters are held to F32_TOLS, chip_smoke.py's limits for card
  against CPU: the sums add in another order in each package, and the
  k1 distortion of an end camera is weakly held (measured 3.4e-3 apart,
  translations 3.1e-4, points 2.6e-4, rotations 6.4e-5; the port with no
  mesh against the port with 2 or 4 shards lies as far apart).
- a one-shard mesh against no mesh, and two gloo processes against the
  in-process two-shard mesh: bit for bit (two terms add to the same bits
  in either order).
- 2 and 4 shards against no mesh in float64: final MSE within 1e-10
  relative, parameters within 1e-8 (measured 3.4e-12).
- FSSR: against mve_tpu, each element within 1e-5 of its column's
  largest magnitude (tests/test_torch_fssr.py's limit for the port
  against mve_tpu: tests/test_parallel.py's elementwise rtol 2e-5, atol
  1e-6 holds mve_tpu against itself, and 27 of the 9,000 sums here, of
  small magnitude, differ by more between exp and the sums' order in
  the two packages, with or without a mesh); against the port's own
  mesh=None bit for bit (rows are independent; one intra-op thread, as
  every test file here sets).
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mve_tpu_torch.fssr.block_eval import evaluate_positions_blocked
from mve_tpu_torch.fssr.sample import SampleList
from mve_tpu_torch.parallel import distributed_ba_step, get_mesh, multihost
from mve_tpu_torch.parallel.distributed_ba import lm_optimize_distributed
from mve_tpu_torch.parallel.mesh import Mesh, pad_to_multiple, shard_batch
from mve_tpu_torch.sfm.ba import BAOptions, core, lm

# mve_tpu is imported inside the tests: the gloo workers below import this
# module in fresh processes, which need neither jax nor mve_tpu.

torch.set_num_threads(1)

LM_KW = dict(max_iters=5, cg_max_iter=40)
F32_TOLS = dict(focal=1e-4, distortion=1e-2, translation=1e-3, rotation=1e-4, points=1e-3)


def _problem(k):
    """The synthetic problem, observations padded to a multiple of k."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from __graft_entry__ import _synthetic_ba_problem

    intr, trans, rot, pts, obs, ci, pi, valid = _synthetic_ba_problem(
        n_cams=12, n_pts=400, n_obs_per_pt=4)
    obs, ci, pi, valid = (pad_to_multiple(a, k) for a in (obs, ci, pi, valid))
    return intr, trans, rot, pts, obs, ci, pi, valid


def _args(k, dtype):
    intr, trans, rot, pts, obs, ci, pi, valid = _problem(k)
    return ([np.asarray(a, dtype) for a in (intr, trans, rot, pts, obs)]
            + [ci, pi, valid, np.asarray(float(valid.sum()), dtype)])


def _gaps(a, b):
    """Largest absolute differences of (intr, trans, rot, points) by
    quantity."""
    a = [np.asarray(x, np.float64) for x in a[:4]]
    b = [np.asarray(x, np.float64) for x in b[:4]]
    return dict(focal=np.abs(a[0][:, 0] - b[0][:, 0]).max(),
                distortion=np.abs(a[0][:, 1:] - b[0][:, 1:]).max(),
                translation=np.abs(a[1] - b[1]).max(), rotation=np.abs(a[2] - b[2]).max(),
                points=np.abs(a[3] - b[3]).max())


def _hold_params(got, want, dtype):
    gaps = _gaps(got, want)
    for name, gap in gaps.items():
        assert gap <= (1e-6 if dtype == np.float64 else F32_TOLS[name]), (name, gaps)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2, 4])
def test_lm_optimize_distributed_against_mve_tpu(k, dtype):
    import jax
    import jax.numpy as jnp
    from mve_tpu.parallel.distributed_ba import lm_optimize_distributed as jlm
    from mve_tpu.parallel.mesh import get_mesh as jmesh

    args = _args(k, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = [np.asarray(x) for x in jlm(jmesh(k), *(jnp.asarray(a) for a in args), **LM_KW)]
    got = [_np(x) for x in lm_optimize_distributed(get_mesh(devices=["cpu"] * k), *args,
                                                   **LM_KW)]
    sj, sp = want[4].astype(np.float64), got[4].astype(np.float64)
    assert sp[1] < sp[0]
    assert abs(sp[1] - sj[1]) <= (1e-9 if dtype == np.float64 else 1e-4) * sj[1]
    assert sp[2] == sj[2]  # LM steps
    _hold_params(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2, 4])
def test_distributed_ba_step_against_mve_tpu(k, dtype):
    import jax
    import jax.numpy as jnp
    from mve_tpu.parallel import distributed_ba_step as jstep
    from mve_tpu.parallel.mesh import get_mesh as jmesh

    args = _args(k, dtype)[:8] + [np.asarray(1000.0, dtype)]
    with jax.enable_x64(dtype == np.float64):
        want = [np.asarray(x) for x in jstep(jmesh(k), *(jnp.asarray(a) for a in args),
                                             cg_max_iter=20)]
    got = [_np(x) for x in distributed_ba_step(get_mesh(devices=["cpu"] * k), *args,
                                               cg_max_iter=20)]
    assert abs(float(got[4]) - float(want[4])) <= \
        (1e-9 if dtype == np.float64 else 1e-4) * float(want[4])
    _hold_params(got, want, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode", [3, 1, 2])
def test_one_shard_mesh_is_bit_identical(mode, dtype):
    intr, trans, rot, pts, obs, ci, pi, _ = _problem(1)
    arrays = tuple(np.asarray(a, np.float64) for a in (intr, trans, rot, pts, obs)) + (ci, pi)
    opts = dict(bundle_mode=mode, dtype=dtype, lm_max_iterations=5, cg_max_iterations=40)
    want = lm.optimize_arrays(*arrays, BAOptions(**opts), device="cpu")
    mesh = get_mesh(devices=["cpu"])
    got = lm.optimize_arrays(*arrays, BAOptions(mesh=mesh, **opts), device="cpu")
    for a, b in zip(want[:4], got[:4]):
        assert np.array_equal(a, b)
    for key in ("initial_mse", "final_mse", "num_lm_iterations", "num_cg_iterations"):
        assert getattr(got[4], key) == getattr(want[4], key)
    assert mesh.reductions > 0


@pytest.mark.parametrize("k", [2, 4])
def test_sharded_against_unsharded_float64(k):
    args = _args(k, np.float64)
    want = core.lm_optimize(*(torch.from_numpy(np.asarray(a)) for a in args), **LM_KW)
    got = lm_optimize_distributed(get_mesh(devices=["cpu"] * k), *args, **LM_KW)
    assert abs(float(got[4][1]) - float(want[4][1])) <= 1e-10 * float(want[4][1])
    assert float(got[4][2]) == float(want[4][2])
    for a, b in zip(got[:4], want[:4]):
        assert (a - b).abs().max() <= 1e-8


def test_optimize_arrays_pads_observations_to_the_mesh(monkeypatch):
    """BAOptions.mesh pads O to a multiple of the mesh size, as mve_tpu's
    does (3 shards: 1,600 observations padded to 2,048 become 2,049)."""
    import mve_tpu.parallel.distributed_ba as jdist
    from mve_tpu.parallel.mesh import get_mesh as jmesh
    from mve_tpu.sfm.ba import BAOptions as JOptions
    from mve_tpu.sfm.ba import lm as jlm
    import mve_tpu_torch.parallel.distributed_ba as pdist

    seen = {}

    def spy(name, real):
        def run(mesh, *args, **kwargs):
            seen[name] = args[4].shape[0]
            return real(mesh, *args, **kwargs)
        return run

    monkeypatch.setattr(jdist, "lm_optimize_distributed",
                        spy("jax", jdist.lm_optimize_distributed))
    monkeypatch.setattr(pdist, "lm_optimize_distributed",
                        spy("port", pdist.lm_optimize_distributed))
    intr, trans, rot, pts, obs, ci, pi, _ = _problem(1)
    arrays = tuple(np.asarray(a, np.float64) for a in (intr, trans, rot, pts, obs)) + (ci, pi)
    kw = dict(lm_max_iterations=5, cg_max_iterations=40)
    a = jlm.optimize_arrays(*arrays, JOptions(mesh=jmesh(3), **kw))
    b = lm.optimize_arrays(*arrays, BAOptions(mesh=get_mesh(devices=["cpu"] * 3), **kw),
                           device="cpu")
    assert seen["port"] == seen["jax"] == 2049
    assert abs(b[4].final_mse - a[4].final_mse) <= 1e-4 * a[4].final_mse


def test_mesh_collectives():
    """shard_batch splits rows in order (and refuses an uneven split),
    reduce_sum adds the partials in shard order on the first device,
    gather_rows concatenates in row order."""
    mesh = get_mesh(devices=["cpu"] * 3)
    x = np.arange(12.0).reshape(6, 2)
    parts = shard_batch(mesh, x)
    assert [p.tolist() for p in parts] == [x[0:2].tolist(), x[2:4].tolist(), x[4:6].tolist()]
    assert torch.equal(mesh.gather_rows(parts), torch.from_numpy(x))
    with pytest.raises(ValueError):
        shard_batch(mesh, np.zeros(7))
    p = [torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0], dtype=torch.float32),
         torch.tensor([-1e8], dtype=torch.float32)]
    assert mesh.reduce_sum(p).item() == ((p[0] + p[1]) + p[2]).item() == 0.0
    pair = mesh.reduce_sum([(t, 2 * t) for t in p])
    assert isinstance(pair, tuple) and pair[1].item() == 0.0
    assert mesh.reductions == 2


def test_get_mesh_has_no_cpu_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        get_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert get_mesh(2).devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


def test_initialize_and_backends(monkeypatch):
    """initialize is a no-op for one process; for several it takes the
    backend from the device (NCCL for cuda, gloo for the CPU) or from
    backend=, and a failing start-up raises (no switch of backend)."""
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert not dist.is_initialized()
    one = multihost.global_mesh(device="cpu")
    assert isinstance(one, Mesh) and one.size == 1
    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: calls.append(
        (backend, kw["init_method"], kw["world_size"], kw["rank"])))
    multihost.initialize("localhost:1234", 2, 1)
    multihost.initialize("file:///x/init", 2, 0, device="cpu")
    monkeypatch.setenv("JAX_COORDINATOR", "host:99")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "3")
    multihost.initialize(device="cuda", backend="gloo")
    assert calls == [("nccl", "tcp://localhost:1234", 2, 1), ("gloo", "file:///x/init", 2, 0),
                     ("gloo", "tcp://host:99", 4, 3)]

    def refuse(backend, **kw):
        raise RuntimeError(f"{backend} refused")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match="nccl refused"):
        multihost.initialize()


# ---------------------------------------------------------------------------
# FSSR
# ---------------------------------------------------------------------------

def _fssr_input():
    """tests/test_parallel.py's samples on a sphere and query points."""
    rng = np.random.RandomState(11)
    n = 700
    phi = rng.uniform(0, 2 * np.pi, n)
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    normal = np.stack([sinth * np.cos(phi), sinth * np.sin(phi), costh],
                      axis=1).astype(np.float32)
    fields = dict(pos=normal.copy(), normal=normal,
                  color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                  scale=rng.uniform(0.05, 0.3, n).astype(np.float32),
                  confidence=np.ones(n, np.float32))
    return fields, rng.uniform(-1.2, 1.2, (900, 3))


@pytest.mark.parametrize("diverse", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_fssr_sharded(k, diverse):
    """Against mve_tpu's evaluate_positions_blocked(mesh=get_mesh()), and
    bit for bit against the port's mesh=None; with diverse, a tenth of
    the samples at 100 times the scale takes the octave-grouped two-pass
    path."""
    from mve_tpu.fssr.block_eval import evaluate_positions_blocked as jeval
    from mve_tpu.fssr.sample import SampleList as JSampleList
    from mve_tpu.parallel.mesh import get_mesh as jmesh

    fields, q = _fssr_input()
    if diverse:
        fields["scale"][::10] *= 100.0
    want = jeval(JSampleList(**fields), q, mesh=jmesh())
    plain = evaluate_positions_blocked(SampleList(**fields), q, device="cpu")
    got = evaluate_positions_blocked(SampleList(**fields), q,
                                     mesh=get_mesh(devices=["cpu"] * k))
    scale = np.abs(want).max(axis=0)
    assert (np.abs(got - want) / np.where(scale > 0, scale, 1.0)).max() <= 1e-5
    assert np.abs(want).sum() > 0
    assert np.array_equal(got.view(np.uint64), plain.view(np.uint64))


# ---------------------------------------------------------------------------
# two gloo processes
# ---------------------------------------------------------------------------

def _gloo_worker(rank, world, init_method, out_dir, ba_args):
    """One rank: initialize, then the LM loop on ba_args and the FSSR
    evaluation over global_mesh(), each result written to out_dir."""
    torch.set_num_threads(1)
    multihost.initialize(init_method, world, rank, device="cpu")
    try:
        mesh = multihost.global_mesh(device="cpu")
        ba = lm_optimize_distributed(mesh, *ba_args, **LM_KW)
        fields, q = _fssr_input()
        sums = evaluate_positions_blocked(SampleList(**fields), q, mesh=mesh)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), *[x.numpy() for x in ba], sums=sums,
                 shard=np.asarray(multihost.my_shard(list(range(7)))),
                 group=np.asarray([dist.get_rank(), dist.get_world_size(),
                                   dist.get_backend() == "gloo", mesh.reductions]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo")
    mp.start_processes(_gloo_worker, args=(2, f"file://{out}/init", str(out),
                                           _args(2, np.float32)),
                       nprocs=2, start_method="spawn", join=True)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


def test_gloo_processes_lm_bit_identical(gloo_run):
    want = lm_optimize_distributed(get_mesh(devices=["cpu"] * 2), *_args(2, np.float32),
                                   **LM_KW)
    for res in gloo_run:
        for i, x in enumerate(want):
            assert np.array_equal(res[f"arr_{i}"], x.numpy()), i


def test_gloo_processes_fssr_bit_identical(gloo_run):
    fields, q = _fssr_input()
    want = evaluate_positions_blocked(SampleList(**fields), q,
                                      mesh=get_mesh(devices=["cpu"] * 2))
    for res in gloo_run:
        assert np.array_equal(res["sums"].view(np.uint64), want.view(np.uint64))


def test_gloo_processes_rank_and_shard(gloo_run):
    """After initialize, my_shard's defaults are the group's rank and
    size; the group runs on gloo."""
    for rank, res in enumerate(gloo_run):
        assert res["group"][:3].tolist() == [rank, 2, 1] and res["group"][3] > 0
        assert res["shard"].tolist() == list(range(rank, 7, 2))


# ---------------------------------------------------------------------------
# sfmrecon's automatic mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("count,device,want", [(2, "cuda", 2), (1, "cuda", None),
                                               (2, "cpu", None)])
def test_sfmrecon_mesh_over_local_cards(count, device, want, tmp_path, monkeypatch, capsys):
    """sfm_reconstruct sets ba_mesh over every local card when there are
    several and the device is CUDA, and prints mve_tpu's line; the work
    is stubbed (CUDA too, on the CPU)."""
    from mve_tpu_torch import synthetic
    from mve_tpu_torch.apps import sfmrecon

    scene = str(tmp_path / "scene")
    synthetic.make_two_plane_scene(scene, n_views=2, width=32, height=24)
    (tmp_path / "scene" / "prebundle.sfm").write_bytes(b"")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    monkeypatch.setattr(sfmrecon, "load_prebundle", lambda path: ([], [object()]))
    monkeypatch.setattr(sfmrecon, "Intrinsics", lambda opts: type(
        "NoIntrinsics", (), {"compute": lambda self, scene, vps: None})())
    seen = {}

    class Stop(Exception):
        pass

    def stop(viewports, matching, opts, dev):
        seen["mesh"] = opts.incremental_opts.ba_mesh
        raise Stop

    monkeypatch.setattr(sfmrecon, "run_incremental_sfm", stop)
    with pytest.raises(Stop):
        sfmrecon.sfm_reconstruct(scene, verbose=True, device=device)
    line = "BA: sharding observations over 2 devices."
    if want is None:
        assert seen["mesh"] is None and line not in capsys.readouterr().out
    else:
        assert seen["mesh"].devices == [torch.device("cuda", i) for i in range(want)]
        assert line in capsys.readouterr().out
