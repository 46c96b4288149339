"""The port's work-list sharding and multi-process sfmrecon against
mve_tpu's, on the CPU.

my_shard takes explicit ids or JAX_PROCESS_ID / JAX_NUM_PROCESSES, the
names mve_tpu reads, and so do the --process-id / --num-processes
defaults of sfmrecon, dmrecon and scene2pset. Two sfmrecon ranks run in
threads on one scene and meet over its directory; the merged prebundle
is held to mve_tpu's two-rank prebundle (not to a one-rank run: each rank
draws its RANSAC samples from its own RandomState over its own pairs),
with test_torch_sfmrecon.py's tolerances: per view, at least 99% of
mve_tpu's keypoints have a port keypoint within 0.5 px; the same
connected pairs; per pair, at least 99% of mve_tpu's verified matches
reproduced within 0.5 px.
"""

import importlib
import os
import threading

import numpy as np
import pytest
import torch

from mve_tpu.apps import sfmrecon as jax_sfmrecon
from mve_tpu.parallel import multihost as jmh
from mve_tpu.sfm.bundler.common import load_prebundle as jax_load

from mve_tpu_torch.apps import sfmrecon
from mve_tpu_torch.parallel import multihost as pmh
from mve_tpu_torch.sfm.bundler.common import load_prebundle

from tests.synthetic import make_two_plane_scene
from tests.test_torch_app_flags import parse

torch.set_num_threads(1)

W, H = 240, 180


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_my_shard(n, monkeypatch):
    items = list(range(11))
    shards = [pmh.my_shard(items, k, n) for k in range(n)]
    assert shards == [jmh.my_shard(items, k, n) for k in range(n)]
    assert sorted(sum(shards, [])) == items
    monkeypatch.setenv("JAX_PROCESS_ID", str(n - 1))
    monkeypatch.setenv("JAX_NUM_PROCESSES", str(n))
    assert pmh.my_shard(items) == shards[n - 1]


@pytest.mark.parametrize("app,argv", [("sfmrecon", ["s"]), ("dmrecon", ["s"]),
                                      ("scene2pset", ["s", "o.ply"])])
def test_environment_defaults(app, argv, monkeypatch):
    jmain = importlib.import_module(f"mve_tpu.apps.{app}").main
    pmain = importlib.import_module(f"mve_tpu_torch.apps.{app}").main
    for env, want in (({}, (0, 1)), ({"JAX_PROCESS_ID": "2", "JAX_NUM_PROCESSES": "3"}, (2, 3))):
        monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
        monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        _, jns = parse(jmain, argv, monkeypatch)
        _, pns = parse(pmain, argv, monkeypatch)
        assert (pns.process_id, pns.num_processes) == (jns.process_id, jns.num_processes) == want
        # An explicit flag wins over the environment.
        _, pns = parse(pmain, argv + ["--process-id", "1"], monkeypatch)
        assert pns.process_id == 1


def _two_ranks(run, scene):
    """Rank 1 in a thread, rank 0 here; returns rank 1's result."""
    out = {}
    worker = threading.Thread(target=lambda: out.setdefault("ret", run(scene, 1)))
    worker.start()
    run(scene, 0)
    worker.join(timeout=600)
    assert not worker.is_alive()
    return out["ret"]


@pytest.fixture(scope="module")
def two_rank_prebundles(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    for name in ("jax", "port"):
        make_two_plane_scene(str(root / name), n_views=4, width=W, height=H, seed=7,
                             with_cameras=False)
    jret = _two_ranks(lambda s, k: jax_sfmrecon.sfm_reconstruct(
        s, skip_sfm=True, verbose=False, process_id=k, num_processes=2), str(root / "jax"))
    pret = _two_ranks(lambda s, k: sfmrecon.sfm_reconstruct(
        s, skip_sfm=True, verbose=False, process_id=k, num_processes=2, device="cpu"),
        str(root / "port"))
    assert jret is None and pret is None   # the worker rank stops after its shard
    return root


def test_part_files_are_merged_and_removed(two_rank_prebundles):
    for name in ("jax", "port"):
        files = sorted(os.listdir(two_rank_prebundles / name))
        assert "prebundle.sfm" in files
        assert not [f for f in files if ".part" in f], files


def test_two_rank_prebundle_matches_mve_tpu(two_rank_prebundles):
    root = two_rank_prebundles
    jv, jm = jax_load(str(root / "jax" / "prebundle.sfm"))
    pv, pm = load_prebundle(str(root / "port" / "prebundle.sfm"))
    tol = 0.5 / max(W, H)
    assert len(pv) == len(jv) == 4
    for i, (j, p) in enumerate(zip(jv, pv)):
        d = np.linalg.norm(j.positions[:, None] - p.positions[None], axis=-1)
        assert float((d.min(axis=1) < tol).mean()) >= 0.99, f"view {i}"
    assert [(m.view_1_id, m.view_2_id) for m in pm] == [(m.view_1_id, m.view_2_id) for m in jm]
    assert len(pm) >= 5
    for m, o in zip(jm, pm):
        a, b = m.view_1_id, m.view_2_id
        d1 = np.linalg.norm(jv[a].positions[m.matches[:, 0]][:, None]
                            - pv[a].positions[o.matches[:, 0]][None], axis=-1)
        d2 = np.linalg.norm(jv[b].positions[m.matches[:, 1]][:, None]
                            - pv[b].positions[o.matches[:, 1]][None], axis=-1)
        rate = float(((d1 < tol) & (d2 < tol)).any(axis=1).mean())
        assert rate >= 0.99, f"pair {(a, b)}: {rate:.4f}"
