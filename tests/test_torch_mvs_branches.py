"""Branches of the solvers' shared rounds (mve_tpu_torch/mvs/rounds.py)
that the default settings do not take, held to mve_tpu on the CPU: no
local view selection (local_vs=False), and no slanted-plane rounds
(max_iterations == num_propagation_iters), each for the sweep solver (the
plane scene's views 0 and 2) and the warp solver (use_sweep=False, view
0), at test_torch_mvs.py's reduced settings and with its bounds: fill
within 0.005 of mve_tpu's per view, median relative depth difference at
most 2e-3 for the sweep solver and 1e-3 for the warp solver.

Measured on the CPU: fills 0.54-0.59 in both packages.
"""

import pytest
import torch

from mve_tpu.mvs import dmrecon as jdm
from mve_tpu_torch.mvs import dmrecon as pdm

from tests.synthetic import make_plane_scene
from tests.test_torch_mvs import SMALL, _both, _compare

# Test workers run side by side: one intra-op thread each.
torch.set_num_threads(1)

NO_LOCAL = dict(SMALL, local_vs=False)
NO_PLANE_ROUNDS = dict(SMALL, max_iterations=2, num_propagation_iters=2)
SOLVERS = {"sweep": ([0, 2], {}, 2e-3), "warp": ([0], dict(use_sweep=False), 1e-3)}


@pytest.fixture(scope="module")
def plane(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mvs_branches") / "plane")
    make_plane_scene(path, n_views=5, width=96, height=72)
    return path


@pytest.mark.parametrize("branch", ["no_local_vs", "no_plane_rounds"])
@pytest.mark.parametrize("solver", ["sweep", "warp"])
def test_branch_against_mve_tpu(plane, solver, branch):
    vids, switches, bound = SOLVERS[solver]
    settings = NO_LOCAL if branch == "no_local_vs" else NO_PLANE_ROUNDS
    js, jp, ps, pp = _both(plane, vids, **settings, **switches)
    params = pdm._solver_params(ps)[0]
    if branch == "no_local_vs":
        assert not params["use_local"]
    else:
        assert params["n_plane_rounds"] == 0
    assert all(pdm._sweep_capable(p, ps) == (solver == "sweep") for p in pp)
    assert all(jdm._sweep_capable(p, js) == (solver == "sweep") for p in jp)
    _compare(jdm._run_batch(jp, js), pdm._run_batch(pp, ps, "cpu"), *jp[0]["ref"].shape, bound)
