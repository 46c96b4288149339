"""The port's bundle adjustment against mve_tpu's, on the CPU, on
__graft_entry__._synthetic_ba_problem(8, 256) (8 cameras on an arc, 256
points, every point in every camera, perturbed parameters).

Tolerances, each relative to the largest magnitude of the quantity:
- build_system (f, Jc, Jp, B, Cb, v, w; float32): 1e-5. Both take
  forward-mode derivatives of the same residual; they differ in the
  order of float32 sums.
- solve_schur and solve_cameras_only (float32 PCG): 1e-3, and the CG
  counts within 5%: CG in float32 amplifies the rounding of its inputs,
  and the stop test is relative to machine precision.
- solve_points_only (direct 3x3 solves): 1e-5.
- optimize_arrays: final MSE 1e-4 (float32) / 1e-9 (float64); parameters
  1e-4 (float32) / 1e-6 (float64) absolute. LM step counts equal, except
  that in float32 one step more or fewer is allowed: a step whose MSE
  ratio lands on 1e-4 within float32 rounding ends the loop in one
  package and not the other (measured: 1 of the 6 float32 cases).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from mve_tpu.sfm.ba import core as jcore, lm as jlm
from mve_tpu.sfm.ba import BAOptions as JOptions, BundleAdjustment as JBA

from mve_tpu_torch.sfm.ba import core as tcore, lm as tlm
from mve_tpu_torch.sfm.ba import BAOptions as TOptions, BundleAdjustment as TBA

torch.set_num_threads(1)

MODES = [(3, False), (3, True), (1, False), (1, True), (2, False), (2, True)]


@pytest.fixture(scope="module")
def problem():
    return graft._synthetic_ba_problem(8, 256)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def _systems(problem, mode, fixed):
    j = jcore.build_system(*(jnp.asarray(a) for a in problem), mode=mode,
                           fixed_intrinsics=fixed)
    t = tcore.build_system(*(torch.from_numpy(np.asarray(a)) for a in problem), mode=mode,
                           fixed_intrinsics=fixed)
    return j, t


@pytest.mark.parametrize("mode,fixed", MODES)
def test_build_system(problem, mode, fixed):
    j, t = _systems(problem, mode, fixed)
    for key in ("f", "Jc", "Jp", "B", "Cb", "v", "w"):
        assert tuple(t[key].shape) == tuple(j[key].shape), key
        _close(t[key].numpy(), j[key], 1e-5)


def _T(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("trr", [1000.0, 1.0])
def test_solvers(problem, trr):
    _, _, _, _, _, ci, pi, _ = problem
    j, _ = _systems(problem, 3, False)
    a = jcore.solve_schur(j["Jc"], j["Jp"], jnp.asarray(ci), jnp.asarray(pi), j["B"], j["Cb"],
                          j["v"], j["w"], jnp.asarray(trr, jnp.float32))
    b = tcore.solve_schur(_T(j["Jc"]), _T(j["Jp"]), _T(ci), _T(pi), _T(j["B"]), _T(j["Cb"]),
                          _T(j["v"]), _T(j["w"]), torch.tensor(trr))
    for x, y in zip(a[:3], b[:3]):
        _close(y.numpy(), x, 1e-3)
    assert abs(int(b[3]) - int(a[3])) <= 0.05 * int(a[3])

    a = jcore.solve_cameras_only(j["Jc"], jnp.asarray(ci), j["B"], j["v"],
                                 jnp.asarray(trr, jnp.float32))
    b = tcore.solve_cameras_only(_T(j["Jc"]), _T(ci), _T(j["B"]), _T(j["v"]), torch.tensor(trr))
    for x, y in zip(a[:2], b[:2]):
        _close(y.numpy(), x, 1e-3)
    assert abs(int(b[2]) - int(a[2])) <= 0.05 * int(a[2])

    a = jcore.solve_points_only(j["Cb"], j["w"], jnp.asarray(trr, jnp.float32))
    b = tcore.solve_points_only(_T(j["Cb"]), _T(j["w"]), torch.tensor(trr))
    for x, y in zip(a, b):
        _close(y.numpy(), x, 1e-5)


def test_pcg_blocks_do_not_change_the_result(problem, monkeypatch):
    """PCG reads its stop flag once per CG_BLOCK iterations and freezes the
    iterate once the flag is set: the result and the count are those of
    a loop that checks after every iteration, bit for bit."""
    _, _, _, _, _, ci, pi, _ = problem
    j, _ = _systems(problem, 3, False)
    args = (_T(j["Jc"]), _T(j["Jp"]), _T(ci), _T(pi), _T(j["B"]), _T(j["Cb"]), _T(j["v"]),
            _T(j["w"]), torch.tensor(10.0))
    blocked = tcore.solve_schur(*args, cg_max_iter=37)
    monkeypatch.setattr(tcore, "CG_BLOCK", 1)
    single = tcore.solve_schur(*args, cg_max_iter=37)
    for x, y in zip(blocked, single):
        assert torch.equal(x, y)


def test_segment_sums_are_deterministic_and_exact():
    rng = np.random.RandomState(0)
    idx = rng.randint(0, 7, size=500)
    idx[idx == 3] = 4  # an empty segment
    x = rng.randn(500, 2, 3)
    seg = tcore.Segments(idx, 9, "cpu")
    got = seg.sum(torch.from_numpy(x))
    want = np.zeros((9, 2, 3))
    np.add.at(want, idx, x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12)
    assert torch.equal(got, seg.sum(torch.from_numpy(x)))
    assert not got[3].any() and not got[8].any()
    # Rows left out by `valid` do not count.
    valid = np.arange(500) < 400
    np.add.at(want, idx[400:], -x[400:])
    part = tcore.Segments(idx, 9, "cpu", valid).sum(torch.from_numpy(x))
    np.testing.assert_allclose(part.numpy(), want, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("mode,fixed", MODES)
def test_optimize_arrays(problem, mode, fixed, dtype):
    intr, trans, rot, pts, obs, ci, pi, _ = problem
    arrays = tuple(np.asarray(a, np.float64) for a in (intr, trans, rot, pts, obs)) + (ci, pi)
    with jax.enable_x64(dtype == np.float64):
        a = jlm.optimize_arrays(*arrays, JOptions(bundle_mode=mode, fixed_intrinsics=fixed,
                                                  dtype=dtype))
    b = tlm.optimize_arrays(*arrays, TOptions(bundle_mode=mode, fixed_intrinsics=fixed,
                                              dtype=dtype), device="cpu")
    sa, sb = a[4], b[4]
    f64 = dtype == np.float64
    assert sb.initial_mse > sb.final_mse
    assert abs(sb.final_mse - sa.final_mse) <= (1e-9 if f64 else 1e-4) * sa.final_mse
    steps = abs(sb.num_lm_iterations - sa.num_lm_iterations)
    assert steps == 0 if f64 else steps <= 1
    assert sb.num_lm_iterations == sb.num_lm_successful_iterations + \
        sb.num_lm_unsuccessful_iterations
    if mode == 2:
        assert sb.num_cg_iterations == sa.num_cg_iterations == 0
    for x, y in zip(a[:4], b[:4]):
        assert y.dtype == np.float64 and y.shape == x.shape
        np.testing.assert_allclose(y, x, atol=1e-6 if f64 else 1e-4)
    if fixed:
        np.testing.assert_array_equal(b[0], np.asarray(intr, dtype).astype(np.float64))


def test_ba_options_from_dict():
    """interop builds BAOptions from a dict and refuses a field the port
    has no use for (mve_tpu's lm_min_iterations is read only by its
    host-driven verbose loop, which is not ported)."""
    from mve_tpu_torch import interop

    *_, ba = interop.options_from_dict({"ba": {"lm_max_iterations": 7, "dtype": np.float64}})
    assert ba.lm_max_iterations == 7 and ba.dtype == np.float64
    with pytest.raises(ValueError):
        interop.options_from_dict({"ba": {"lm_min_iterations": 1}})


def test_bundle_adjustment_on_a_problem(problem):
    """BundleAdjustment.optimize on BAProblem containers, both packages."""
    from mve_tpu.sfm.ba import problem as jprob
    from mve_tpu_torch.sfm.ba import problem as tprob

    intr, trans, rot, pts, obs, ci, pi, _ = (np.asarray(a) for a in problem)

    def build(mod):
        cams = [mod.BACamera(focal_length=float(i[0]), distortion=i[1:3].astype(np.float64),
                             translation=t.astype(np.float64), rotation=r.astype(np.float64))
                for i, t, r in zip(intr, trans, rot)]
        points = [mod.BAPoint(pos=p.astype(np.float64)) for p in pts]
        observations = [mod.BAObservation(o.astype(np.float64), int(c), int(p))
                        for o, c, p in zip(obs, ci, pi)]
        return mod.BAProblem(cams, points, observations)

    pj, pt = build(jprob), build(tprob)
    sj = JBA(JOptions(lm_max_iterations=20)).optimize(pj)
    st = TBA(TOptions(lm_max_iterations=20), device="cpu").optimize(pt)
    assert abs(st.final_mse - sj.final_mse) <= 1e-4 * sj.final_mse
    for cj, ct in zip(pj.cameras, pt.cameras):
        assert abs(cj.focal_length - ct.focal_length) < 1e-4
        np.testing.assert_allclose(ct.rotation, cj.rotation, atol=1e-4)
