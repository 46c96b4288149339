#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and ends the run:
  1. environment: the card (nvidia-smi name and power limit), versions,
     the TF32 flags (must be off);
  2. build every hand-written kernel from mve_tpu_torch/csrc with nvcc;
     ptxas must report 0 spill bytes, and the top-2 library's machine
     code must hold tensor-core (HGMMA) and TMA (UTMALDG) instructions;
     then the native host library (mve_tpu_torch/native) with g++, which
     must load (a silent fallback would measure the wrong code);
  3. the top-2 kernels against their plain PyTorch versions on the card:
     the split pre-pass bit for bit; the product on exact, ragged,
     single-reference, tied, D=64 and batched-pair inputs, in float32 and
     bf16 under one rule, which must also reject a kernel run in the
     other precision, and in float32 against the emulated 3xTF32 scheme
     too; both matching directions bit for bit on mutual pairs; then
     timed beside the plain version and torch.topk(q @ r.T, 2) at
     8192 x 8192 x 128, and alone at the per-pair matcher's sizes;
  4. sfm_reconstruct(skip_sfm=True) on a small scene on the card and on
     the CPU: the two prebundles must agree; and the per-pair matcher on
     that scene's features, card against CPU;
  5. sfm_reconstruct(skip_sfm=True) on 40 views of 1600 x 1200 (the
     main path), with the launch counts read around it;
  6. the kernels at every one of the main path's own inputs: held against
     the plain version and timed beside it and a masked
     torch.topk(torch.bmm(...), 2); each pass's two directions bit for
     bit on mutual pairs; the matcher's mutual-match targets through the
     kernel against those through the plain version;
  7. the whole app, sfm_reconstruct(skip_sfm=False), on phase 4's scene
     from its prebundle, on the card and on the CPU: all 4 views
     registered by both, track counts within 1%, camera centres within 2%
     of the generator's true cameras after alignment, and synth_0.out
     read back;
  8. bundle adjustment (optimize_arrays, cameras and points) on 64
     cameras, 10,240 points and about four observations per point, on
     the card twice and on the CPU: LM steps, final MSE and parameters
     card against CPU, ms per LM step, CG iterations, the host syncs of
     one BA, and whether the two card runs are bit-identical;
  9. on phase 5's prebundle, the automatic initial-pair search on the
     card, which must reject every candidate by its homography inliers;
     then the whole app on phase 5's 40 views of 1600 x 1200 from that
     prebundle (phases 5 and 9 together are sfmrecon at full size), with
     the initial pair given (MAIN_INITIAL_PAIR): all 40 cameras
     registered and within 2% of the true cameras;
 10. dmrecon (reconstruct_views, Settings() but for 3 local neighbours,
     as a view there has 3) on phase 7's scene and cameras, with each
     solver: the rectified sweep (the default) at scale 1, the warp solver
     (use_sweep=False) and the warp solver with exact NCC (view 0) at
     scale 2; each on the card twice and on the CPU: the solver it was
     meant to take, the same embeddings for the same views, per-view fill
     within 0.005, the median relative depth difference on pixels both
     accept within DEPTH_TOL, and a second card run bit-identical to the
     first; then torch.argmax on an all-tied tensor returning index 0 on
     the card;
 11. dmrecon at full size: reconstruct_views(scale=2) on phase 9's 40
     views of 1600 x 1200 with the port's own synth_0.out (depth maps of
     400 x 300, 20 neighbours each): every view gets a depth map from the
     sweep solver, every fill at least FILL_FLOOR, and every view's
     accepted depths lie on the scene's two planes as the bundle's 3D
     points place them (median relative error within TRUTH_TOL, at most
     GROSS_TOL of the pixels more than GROSS_OFF off); per-view and mean
     fill, wall time split into host
     preparation, device solve and writes, peak device memory, one view's
     device busy share, its ten most expensive device ops and the time of
     each solver phase, and the same view with torch.cumsum and plain
     multiply-adds in place of the CPU's order (its time, and how far its
     depths move); then view 0 of this run card against CPU with phase
     10's limits: the CPU's view 0 runs in a second process while phases
     14 and 15 keep the card busy and leave the host's cores idle, and
     is held against the card's when phase 15 ends;
 12. scene2pset -F2 on phase 11's depth maps: point count, wall time, and
     the PLY read back with normals, values and confidences;
 13. fssrecon card against CPU on every FSSR_EVERY-th point of phase 12's
     point set (the default octree path, and the streaming path in
     several chunks) and on a scale-diverse set (a span of 100, which
     takes the octave groups and the histogram scale filter): corner and
     face counts, the corner sums' largest and median differences, and
     the corners whose value changes sign or whose confidence is > 0 on
     one side only (limits FACE_TOL, SUMS_TOL, CONF_FLIP_TOL, SIGN_TOL);
 14. fssrecon with default flags on phase 12's whole point set: samples,
     scale span and evaluation path, leaves, corners and SB buckets, the
     time split (load, octree, block expansion, device evaluation,
     extraction), peak device memory, the evaluation again under
     torch.profiler (busy share, top device ops; it must be bit-identical
     to the first), and the surface against the scene's two planes
     (SURF_TOL, SURF_GROSS_TOL);
 15. meshclean with default flags on phase 14's surface, through the
     native library: time, vertex, face and component counts before and
     after (no component under 1,000 vertices and no degenerate face may
     remain), the cleaned surface against the scene's planes (a reading),
     and mesh_components, clean_mc_mesh and the whole app again through
     the Python fallbacks: their times beside the native ones, with
     identical outputs;
 16. makescene: phase 5's 40 views written as photos (JPEG with an EXIF
     focal length, and PNG), imported with -i, then with -m at a quarter
     of the pixels, then a Bundler workspace of BUNDLER_VIEWS views of
     phase 9's synth_0.out and undistorted images (k2/k4 undistortion),
     each on the card and on the CPU: the two scene directories must be
     byte-identical, but for thumbnail pixels one level apart at a
     rounding tie, which are counted;
 17. sfmrecon --cascade-hashing --skip-sfm on phase 16's 40 views on the
     card (time, pairs kept, matches per pair) beside phase 5's batched
     prebundle, with the top2 launches of that path; then on phase 4's
     views the cascade's hash bits card against CPU (flips counted, each
     within 1e-5 of zero) and its matches (the same pairs, each with at
     least 99% of the CPU's matches);
 18. sfmrecon --skip-sfm --num-processes 2 as two processes on the card
     and as two ranks on the CPU, on phase 4's scene: the merged
     prebundles card against CPU with phase 4's limits;
 19. featurerecon on FEATURERECON_VIEWS of phase 9's views and their
     cameras: time, points, their distance to the scene's planes (median
     within TRUTH_TOL), the top2 launches of the per-pair matcher, and its
     first calls held against the plain version;
 20. the canonical command line from a folder of 4 photos of 480x360,
     each app as `python -m mve_tpu_torch.apps.<app>` on the card
     (makescene, sfmrecon, dmrecon, scene2pset, fssrecon, meshclean), then
     prebundle, bundle2pset, mesh2pset, meshconvert, meshalign,
     sceneupgrade, sceneinspect and meshview (two turntable frames on the
     card) on their outputs: each must exit 0;
 21. meshview at its default 1024x768 on phase 15's cleaned surface with
     --scene on phase 9's scene (frusta of 40 views, its SfM points):
     --view-id 0 and --turntable 4, each twice (without and under the
     profiler, bit-identical): each frame's wall time, render time,
     device kernel time and busy share, and peak memory; view 0's covered
     pixels, unprojected, against the scene's planes (phase 14's limits);
     then phase 13's surface at 256x192 card against CPU (the limits of
     tests/test_torch_render.py);
 22. SIFT with min_octave=-1 on SIFT_VIEWS views of 1600x1200 (octave -1
     images of 3200x2400, in which octave -1 finds next to nothing) and
     on a finely textured view of that size (in which it must find at
     least 1,000) beside min_octave=0: keypoints, time, peak memory; then
     card against CPU on a 480x360 view with tests/test_torch_features.py's
     keypoint agreement, over all keypoints and over octave -1's alone;
 23. tracing: IsoOctree.compute_voxels with the pair list and the dense
     path under MVE_TPU_TRACE_DIR: one Chrome trace per FSSR span, each
     naming its span; without the variable no file is written;
 24. fssrecon with MVE_TPU_FSSR_PAIRWISE=1 (the native influence pairs,
     the pair list on the device) on phase 13's point set: the pair
     count, the pairing and device times; the evaluation again on the
     card (bit-identical); card against CPU on every PAIR_CPU_EVERY-th
     corner with phase 13's limits, and against phase 13's dense card run
     with phase 13's limits at all but PAIR_RIM_SHARE of the corners and
     within PAIR_RIM_TOL there;
 25. bundle adjustment (optimize_arrays) at the size of the Dubrovnik
     problem of "Bundle Adjustment in the Large" (BAL_CAMS cameras,
     BAL_POINTS points, BAL_OBS_PER_POINT observations a point), LM steps
     and CG iterations capped (BAL_LM_STEPS, BAL_CG_ITERS), with no mesh
     and over meshes of BAL_SHARDS shards on cuda:0, in float32 and
     float64: wall time, LM steps, CG iterations, reductions per CG
     iteration and peak memory of each run; one shard bit-identical to no
     mesh, the others within SHARD_TOLS of it, every run lowering the MSE;
 26. two processes on the card in a gloo group (multihost.initialize,
     global_mesh): phase 25's float32 BA bit-identical to its in-process
     two-shard run, and an FSSR evaluation bit-identical to mesh=None;
     then one process in an NCCL group of one, its BA bit-identical to
     phase 25's unsharded float32 run; a failing rank fails the phase;
 27. phase 13's default card evaluation again over FSSR_SHARDS shards on
     cuda:0 and with no mesh: both bit-identical to phase 13's sums;
 28. the torch functions of core/image_color, math/geometry and
     math/intersect on the card against the CPU (LIBRARY_TOL, hit masks
     equal) on view 0's image and phase 15's surface;
 29. sfmrecon's incremental SfM from phase 5's prebundle with its BA
     mesh over two shards on cuda:0 (every BA sharded): 40/40 cameras,
     tracks within 1% of phase 9's, centres within 2%, BA totals beside
     phase 9's;
 30. the reference's step-by-step LM and fixed-margin rectification:
     (a) phase 8's problem through BundleAdjustment with verbose_output,
     float32 and float64: one printed line per LM step, at least the
     default run's steps + 3 with lm_min_iterations set so, and the
     float64 verbose run's final MSE within VERBOSE_MSE_TOL of the run
     without verbose_output; (b) the sweep solver on the legacy grid
     (rectify_pair(margin_yx=rect_margins(H, W)), solve_batch_sweep(
     rect_hw=None)) on phase 10's scene, card twice and CPU with phase
     10's limits; wall time and peak memory.
Each phase's header says how far into the script it starts.
It prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}. It exits non-zero without a result when
CUDA is unavailable. Scenes are written under build/chip_smoke/ and
removed when the phases that read them are done.
"""

import contextlib
import importlib.util
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import types
import warnings
from pathlib import Path

import numpy as np
import torch

import mve_tpu_torch
from mve_tpu_torch import native, synthetic
from mve_tpu_torch.apps import (dmrecon, featurerecon, fssrecon, makescene, meshclean, meshview,
                                scene2pset, sfmrecon)
from mve_tpu_torch.core import Scene, image_color, image_io, image_tools
from mve_tpu_torch.core.bundle_io import load_mve_bundle
from mve_tpu_torch.core.mesh import TriangleMesh
from mve_tpu_torch.core.mesh_io import load_mesh, save_mesh
from mve_tpu_torch.core.mesh_tools import mesh_components
from mve_tpu_torch.fssr import block_eval as fssr_block_eval
from mve_tpu_torch.fssr import dual_contouring as fssr_dc
from mve_tpu_torch.fssr import iso_octree as fssr_iso_octree
from mve_tpu_torch.fssr import streaming as fssr_streaming
from mve_tpu_torch.fssr.mesh_clean import clean_mc_mesh
from mve_tpu_torch.fssr.sample import SampleList, load_samples_from_ply
from mve_tpu_torch.math import geometry, intersect
from mve_tpu_torch.mvs import Settings as MvsSettings
from mve_tpu_torch.mvs import dmrecon as mvs_dmrecon
from mve_tpu_torch.mvs import patch as mvs_patch
from mve_tpu_torch.mvs import sweep_solver as mvs_sweep
from mve_tpu_torch.mvs import view_selection as mvs_vs
from mve_tpu_torch.ops import cuda_build, top2 as top2_mod
from mve_tpu_torch.ops.matching import descriptor_top2, descriptor_top2_pairs, split_tf32
from mve_tpu_torch.parallel import get_mesh, multihost
from mve_tpu_torch.render import rasterizer
from mve_tpu_torch.sfm import matching as sfm_matching
from mve_tpu_torch.sfm import sift
from mve_tpu_torch.sfm.ba import BAOptions, BundleAdjustment, optimize_arrays
from mve_tpu_torch.sfm.ba.problem import BACamera, BAObservation, BAPoint, BAProblem
from mve_tpu_torch.sfm.ba import core as ba_core, lm as ba_lm
from mve_tpu_torch.sfm.bundler import Intrinsics, IntrinsicsOptions, matching_batched
from mve_tpu_torch.sfm.bundler import init_pair as init_pair_mod
from mve_tpu_torch.sfm.bundler.common import Viewport, load_prebundle
from mve_tpu_torch.sfm.bundler.features import Features
from mve_tpu_torch.sfm.bundler.incremental import _determine_similarity
from mve_tpu_torch.sfm.bundler.init_pair import InitialPair
from mve_tpu_torch.sfm.bundler.matching import Matching, MatchingOptions
from mve_tpu_torch.sfm.bundler.pipeline import SfmOptions, run_incremental_sfm
from mve_tpu_torch.sfm.bundler.tracks import Tracks
from mve_tpu_torch.sfm.cascade_hashing import CascadeHashing
from mve_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_F32_FLOPS = 67e12       # CUDA cores
PEAK_TF32_FLOPS = 495e12     # tensor cores
PEAK_BF16_FLOPS = 989e12     # tensor cores
PEAK_BYTES = 3.35e12         # HBM3

# The main path's scene: sfmrecon is run on tens of photos of several
# megapixels. Neither is cut.
MAIN_VIEWS, MAIN_WIDTH, MAIN_HEIGHT = 40, 1600, 1200
# On that scene the automatic initial pair finds none: most matches lie on
# the background plane, and every candidate has more than 80% homography
# inliers (phase 9 checks this on the card; on a smaller scene of the same
# kind, tests/test_torch_incremental.py shows mve_tpu rejecting the same
# candidates). A user then names the pair, as --initial-pair does: views
# 1 and 21 sit on opposite sides of the generator's circle of cameras.
MAIN_INITIAL_PAIR = (1, 21)


START = time.perf_counter()


def phase(title):
    print(f"\n== {title}  [{time.perf_counter() - START:.1f} s into the script]", flush=True)


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over `reps` runs, after a warm-up."""
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


def top2_bound(flops, nbytes, bf16):
    """(bound ms, bound_by, CUDA-core ms) of the top-2 product. float32 is
    three TF32 tensor-core products (the fewest that keep float32 parity),
    bf16 one bf16 product; the CUDA-core figure is float32 FMA at 67
    TFLOP/s, the bound of a kernel that leaves the tensor cores unused."""
    ops = flops / PEAK_BF16_FLOPS if bf16 else 3 * flops / PEAK_TF32_FLOPS
    by = "operations" if ops >= nbytes / PEAK_BYTES else "bytes"
    return 1e3 * max(ops, nbytes / PEAK_BYTES), by, 1e3 * flops / PEAK_F32_FLOPS


def library_top2_pairs(desc, n_desc, pair_a, pair_b, bf16):
    """The yardstick at the pair inputs: masked torch.topk(torch.bmm(...), 2)
    over chunks of pairs. Timed only; the port never calls it."""
    V, N, D = desc.shape
    x = desc.to(torch.bfloat16) if bf16 else desc
    cols = torch.arange(N, device=desc.device)
    chunk = max(1, (1 << 31) // max(N * N * x.element_size(), 1))
    out = []
    for c0 in range(0, len(pair_a), chunk):
        a, b = pair_a[c0:c0 + chunk].long(), pair_b[c0:c0 + chunk].long()
        scores = torch.bmm(x[a], x[b].mT)
        scores.masked_fill_(cols[None, None, :] >= n_desc[b].long()[:, None, None], -math.inf)
        out.append(torch.topk(scores, 2, dim=2))
    return out


def unit_desc(rng, n, d, dev):
    x = rng.rand(n, d).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return torch.from_numpy(x).to(dev)


def agreement(got, want):
    """Hold a kernel result (idx, d1, d2) against the plain version's.

    One rule for float32 and bf16, since in both the kernel and the plain
    version multiply the same (rounded) inputs exactly in float32 and
    differ only in summation order: indices identical except where the
    plain best and runner-up are closer than 1e-5, distances within 1e-5.
    Returns (ok, max abs distance error, detail)."""
    gi, g1, g2 = (t.reshape(-1) for t in got)
    wi, w1, w2 = (t.reshape(-1) for t in want)
    err = 0.0
    for g, w in ((g1, w1), (g2, w2)):
        # An infinite distance (no runner-up) must be infinite in both.
        if not bool((torch.isinf(g) == torch.isinf(w)).all()):
            return False, math.inf, "infinite distances differ"
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    diff = gi != wi
    near_tie = (w2 - w1) < 1e-5
    bad = int((diff & ~near_tie).sum())
    ok = bad == 0 and err <= 1e-5
    detail = (f"idx mismatches {int(diff.sum())} ({bad} outside near-ties), "
              f"max |d err| {err:.3g} (<=1e-5)")
    return ok, err, detail


def compare(name, got, want, bf16):
    """agreement(), printed; raises if the kernel disagrees."""
    ok, err, detail = agreement(got, want)
    print(f"  {name:<34} {'bf16' if bf16 else 'f32 '}  {detail}", flush=True)
    if not ok:
        raise AssertionError(f"top2 {name}: kernel disagrees with the plain version: {detail}")
    return err


def check_split(x):
    """The split kernel against its plain version, bit for bit. Returns 0.0
    (the largest difference) or raises."""
    (hi, lo, _), _ = top2_mod.split(x, None, False)
    phi, plo = split_tf32(x)
    (b, _, _), _ = top2_mod.split(x, None, True)
    err = max(float((hi - phi).abs().max()), float((lo - plo).abs().max()),
              float((b.float() - x.to(torch.bfloat16).float()).abs().max()))
    if err != 0.0:
        raise AssertionError(f"split kernel differs from its plain version by {err}")
    return err


def check_symmetry(name, ab, ba, bf16):
    """ab and ba: (idx, dist1, dist2), each (P, N), of the same pairs in
    the two directions. The kernel computes dot(a, b) with the same bits
    whichever is the query (csrc/top2.cu), so on every mutual pair i <-> j
    dist1 must be bit-identical both ways; raises if any is not."""
    (i12, d12, _), (i21, d21, _) = ab, ba
    j = i12.long()
    mutual = torch.gather(i21.long(), 1, j) == torch.arange(j.shape[1], device=j.device)[None, :]
    n, same = int(mutual.sum()), int((mutual & (d12 == torch.gather(d21, 1, j))).sum())
    print(f"  symmetry {name:<25} {'bf16' if bf16 else 'f32 '}  {n} mutual pairs, {same} "
          f"with bit-identical dist1 in both directions", flush=True)
    if same != n:
        raise AssertionError(f"top2 {name}: the two directions differ on a mutual pair")


def phase_kernel_checks(dev):
    rng = np.random.RandomState(0)
    errs = [check_split(unit_desc(rng, 4096, 128, dev))]
    print("  split kernel                        bit-identical to split_tf32 and "
          "Tensor.to(bfloat16)", flush=True)
    cases = [("exact tiles 1024x512 D128", 1024, 512, 128),
             ("ragged 37x91 D128", 37, 91, 128),
             ("ragged 300x700 D128", 300, 700, 128),
             ("ragged 1025x511 D128", 1025, 511, 128),
             ("exact tiles 1024x512 D64", 1024, 512, 64),
             ("ragged 300x700 D64", 300, 700, 64)]
    for name, n1, n2, d in cases:
        q, r = unit_desc(rng, n1, d, dev), unit_desc(rng, n2, d, dev)
        for bf16 in (False, True):
            got = top2_mod.top2(q, r, n2, bf16)
            errs.append(compare(name, got, descriptor_top2(q, r, n_refs=n2, use_bf16=bf16), bf16))
            if not bf16:
                compare("  against emulated 3xTF32", got,
                        descriptor_top2(q, r, n_refs=n2, use_3xtf32=True), bf16)
    # The rule must fail a kernel run in the other precision.
    q, r = unit_desc(rng, 1024, 128, dev), unit_desc(rng, 512, 128, dev)
    for bf16 in (False, True):
        ok, _, detail = agreement(top2_mod.top2(q, r, 512, not bf16),
                                  descriptor_top2(q, r, n_refs=512, use_bf16=bf16))
        name = f"kernel {'f32' if bf16 else 'bf16'}, plain {'bf16' if bf16 else 'f32'}"
        if ok:
            raise AssertionError(f"{name}: the rule passed a kernel in the wrong precision: {detail}")
        print(f"  {name:<39} rejected as it must be: {detail}", flush=True)
    # A single real reference among padding rows: runner-up distance inf.
    q = unit_desc(rng, 5, 128, dev)
    r = torch.cat([q[:1], unit_desc(rng, 63, 128, dev)])
    for bf16 in (False, True):
        got = top2_mod.top2(q, r, 1, bf16)
        compare("single real reference", got, descriptor_top2(q, r, n_refs=1, use_bf16=bf16), bf16)
        if not (bool((got[0] == 0).all()) and bool(torch.isinf(got[2]).all())):
            raise AssertionError("single reference: expected idx 0 and an infinite runner-up")
    # All-equal references: the lowest index wins and second == best.
    r = unit_desc(rng, 1, 128, dev).repeat(300, 1)
    got = top2_mod.top2(q, r, 300, False)
    if not (bool((got[0] == 0).all()) and bool((got[1] == got[2]).all())):
        raise AssertionError("ties: expected idx 0 and equal best and runner-up")
    print("  all-equal references                f32   idx 0, second == best", flush=True)
    # Batched pairs: V=6, N=2048, varied counts, all 15 pairs.
    V, N = 6, 2048
    for d in (128, 64):
        desc = torch.stack([unit_desc(rng, N, d, dev) for _ in range(V)])
        n_desc = torch.tensor([2048, 1500, 1, 900, 2047, 64], dtype=torch.int32, device=dev)
        pairs = [(a, b) for b in range(V) for a in range(b)]
        pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device=dev)
        pb = torch.tensor([b for _, b in pairs], dtype=torch.int32, device=dev)
        for bf16 in (False, True):
            both = []
            for name, x, y in (("pairs V=6 N=2048 a->b D%d" % d, pa, pb),
                               ("pairs V=6 N=2048 b->a D%d" % d, pb, pa)):
                got = top2_mod.top2_pairs(desc, n_desc, x, y, bf16)
                want = descriptor_top2_pairs(desc, n_desc, x, y, use_bf16=bf16)
                # Query rows past n_desc[a] are padding the caller drops.
                rows = torch.arange(N, device=dev)[None, :] < n_desc[x.long()][:, None]
                errs.append(compare(name, tuple(t[rows] for t in got),
                                    tuple(t[rows] for t in want), bf16))
                both.append(got)
            check_symmetry(f"pairs V=6 N=2048 D{d}", *both, bf16)
    # One query set against one reference set (a smaller grid than the
    # pairs above, which top2_launch may give fewer warpgroups a block);
    # r is q permuted plus noise, so most rows are mutual.
    n = 3000
    for d in (128, 64):
        q = unit_desc(rng, n, d, dev)
        r = q[torch.from_numpy(rng.permutation(n)).to(dev)] + 0.05 * unit_desc(rng, n, d, dev)
        r = (r / r.norm(dim=1, keepdim=True)).contiguous()
        for bf16 in (False, True):
            ab, ba = (tuple(t[None] for t in top2_mod.top2(x, y, n, bf16))
                      for x, y in ((q, r), (r, q)))
            check_symmetry(f"{n}x{n} D{d}", ab, ba, bf16)
    torch.cuda.synchronize()
    return max(errs)


def phase_kernel_timing(dev):
    rng = np.random.RandomState(1)
    n, d = 8192, 128
    q, r = unit_desc(rng, n, d, dev), unit_desc(rng, n, d, dev)
    flops = 2.0 * n * n * d
    out = {}
    for bf16 in (False, True):
        qq, rr = (q.to(torch.bfloat16), r.to(torch.bfloat16)) if bf16 else (q, r)
        qo, ro = top2_mod.split(q, r, bf16)
        call = cuda_ms(lambda: top2_mod.top2(q, r, n, bf16), 20)
        product = cuda_ms(lambda: top2_mod.top2_on(qo, ro, n), 20)
        split = cuda_ms(lambda: top2_mod.split(q, r, bf16), 20)
        plain = cuda_ms(lambda: descriptor_top2(q, r, n_refs=n, use_bf16=bf16), 20)
        library = cuda_ms(lambda: torch.topk(qq @ rr.T, 2, dim=1), 20)
        bound, _, core = top2_bound(flops, 2 * n * d * 4 + n * 12, bf16)
        tag = "bf16" if bf16 else "f32"
        out[tag] = dict(ms=call, product_ms=product, split_ms=split, plain_ms=plain,
                        library_ms=library, bound_ms=bound)
        print(f"  8192x8192x128 {tag}: kernels {call:.4f} ms ({flops / call / 1e9:.2f} TFLOP/s; "
              f"product {product:.4f} ms, split {split:.4f} ms), plain {plain:.4f} ms "
              f"({flops / plain / 1e9:.2f}), torch.topk(q@r.T,2) {library:.4f} ms "
              f"({flops / library / 1e9:.2f}), bound {bound:.4f} ms "
              f"({'1 bf16' if bf16 else '3 TF32'} tensor-core products; float32 on the CUDA "
              f"cores {core:.4f} ms)", flush=True)
    # The per-pair matcher's calls at the main path's largest views: SIFT
    # (2974 rows, bf16) and SURF (2138 rows, 64-D, float32).
    for n, d, bf16 in ((2974, 128, True), (2138, 64, False)):
        q, r = unit_desc(rng, n, d, dev), unit_desc(rng, n, d, dev)
        qo, ro = top2_mod.split(q, r, bf16)
        product = cuda_ms(lambda: top2_mod.top2_on(qo, ro, n), 20)
        flops = 2.0 * n * n * d
        bound, _, _ = top2_bound(flops, 2 * n * d * 4 + n * 12, bf16)
        print(f"  per-pair {n}x{n}x{d} {'bf16' if bf16 else 'f32'}: product {product:.4f} ms "
              f"({flops / product / 1e9:.2f} TFLOP/s), bound {bound:.4f} ms", flush=True)
    return out


def load_scene_result(scene):
    return load_prebundle(os.path.join(scene, "prebundle.sfm"))


def compare_prebundles(card, cpu, width):
    """The prebundles of two scenes, card against CPU: per view, at least
    99% of the CPU's keypoints have a card keypoint within 0.5 px; the same
    connected pairs; per pair, at least 95% of the CPU's matches reproduced
    with both ends within 0.5 px. Raises if not."""
    gv, gm = load_scene_result(str(card))
    cv, cm = load_scene_result(str(cpu))
    tol = 0.5 / width  # 0.5 px in normalised coordinates
    for i, (g, c) in enumerate(zip(gv, cv)):
        dist = np.linalg.norm(c.positions[:, None] - g.positions[None], axis=-1)
        recall = float((dist.min(axis=1) < tol).mean())
        print(f"  view {i}: cpu {len(c.positions)} / cuda {len(g.positions)} features, "
              f"recall {recall:.4f} (>=0.99)", flush=True)
        if recall < 0.99:
            raise AssertionError(f"view {i}: keypoint recall {recall:.4f} < 0.99")
    gpairs = {(m.view_1_id, m.view_2_id): m for m in gm}
    cpairs = {(m.view_1_id, m.view_2_id): m for m in cm}
    if set(gpairs) != set(cpairs):
        raise AssertionError(f"connected pairs differ: cuda {sorted(gpairs)} cpu {sorted(cpairs)}")
    for key, c in cpairs.items():
        g = gpairs[key]
        a, b = key
        cp1, cp2 = cv[a].positions[c.matches[:, 0]], cv[b].positions[c.matches[:, 1]]
        gp1, gp2 = gv[a].positions[g.matches[:, 0]], gv[b].positions[g.matches[:, 1]]
        d1 = np.linalg.norm(cp1[:, None] - gp1[None], axis=-1)
        d2 = np.linalg.norm(cp2[:, None] - gp2[None], axis=-1)
        rate = float(((d1 < tol) & (d2 < tol)).any(axis=1).mean())
        print(f"  pair {key}: cpu {len(c.matches)} / cuda {len(g.matches)} matches, "
              f"reproduced {rate:.4f} (>=0.95)", flush=True)
        if rate < 0.95:
            raise AssertionError(f"pair {key}: match reproduction {rate:.4f} < 0.95")


def phase_card_vs_cpu():
    base = WORK / "small"
    shutil.rmtree(base, ignore_errors=True)
    synthetic.make_two_plane_scene(str(base / "cuda"), n_views=4, width=480, height=360,
                                   seed=7, with_cameras=False)
    shutil.copytree(base / "cuda", base / "cpu")
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sfmrecon.sfm_reconstruct(str(base / dev), skip_sfm=True, verbose=False, device=dev)
        print(f"  {dev}: {time.perf_counter() - t0:.3f} s, {sfmrecon.LAST_TIMINGS}", flush=True)
    compare_prebundles(base / "cuda", base / "cpu", 480)

    # The per-pair matcher (bundler.Matching: ops/top2.top2 per pair, bf16
    # for 128-D SIFT and float32 for 64-D SURF on the card) on the same
    # features, card against CPU. The images are the scene's own.
    tex_far = synthetic.make_texture(seed=7, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=107, smooth_sigma=3.0)
    imgs = [synthetic.render_two_plane_view(tex_far, tex_near, cam, 480, 360)
            for cam in synthetic.make_cameras(4, spread=0.55, seed=7)]
    vps = [Viewport() for _ in imgs]
    Features(device="cuda").compute_batched(imgs, vps)
    found = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        found[dev] = {(m.view_1_id, m.view_2_id): m.matches
                      for m in Matching(device=dev).compute(vps, seed=0)}
        print(f"  per-pair matcher, {dev}: {time.perf_counter() - t0:.3f} s, "
              f"{len(found[dev])} pairs", flush=True)
    if set(found["cuda"]) != set(found["cpu"]):
        raise AssertionError(f"per-pair matcher: connected pairs differ: cuda "
                             f"{sorted(found['cuda'])} cpu {sorted(found['cpu'])}")
    for key, c in sorted(found["cpu"].items()):
        want = set(map(tuple, c))
        got = set(map(tuple, found["cuda"][key]))
        rate = len(got & want) / max(len(want), 1)
        print(f"  per-pair pair {key}: cpu {len(want)} / cuda {len(got)} matches, "
              f"reproduced {rate:.4f} (>=0.95)", flush=True)
        if rate < 0.95:
            raise AssertionError(f"per-pair pair {key}: match reproduction {rate:.4f} < 0.95")


class _Recorder:
    """Wraps matching_batched.top2_pairs to keep the inputs of every call;
    every call still goes to the real wrapper."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, desc, n_desc, pair_a, pair_b, bf16):
        self.calls.append((desc, n_desc, pair_a, pair_b, bf16))
        return self.fn(desc, n_desc, pair_a, pair_b, bf16)


def phase_main_path():
    views, width, height = MAIN_VIEWS, MAIN_WIDTH, MAIN_HEIGHT
    scene = WORK / "main"
    shutil.rmtree(scene, ignore_errors=True)
    t0 = time.perf_counter()
    synthetic.make_two_plane_scene(str(scene), n_views=views, width=width, height=height,
                                   seed=7, with_cameras=False)
    print(f"  scene: {views} views of {width}x{height} written in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    recorder = _Recorder(matching_batched.top2_pairs)
    matching_batched.top2_pairs = recorder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    top2_mod.launches = top2_mod.split_launches = 0
    t0 = time.perf_counter()
    try:
        sfmrecon.sfm_reconstruct(str(scene), skip_sfm=True, verbose=False, device="cuda")
        torch.cuda.synchronize()
    finally:
        matching_batched.top2_pairs = recorder.fn
    wall = time.perf_counter() - t0
    launches, split_launches = top2_mod.launches, top2_mod.split_launches
    peak = torch.cuda.max_memory_allocated()
    t = dict(sfmrecon.LAST_TIMINGS)
    print(f"  sfm_reconstruct(skip_sfm=True, device='cuda'): {wall:.3f} s", flush=True)
    print(f"  features_ms {t['features_ms']}, matching_ms {t['matching_ms']} "
          f"(ransac: host sampling {t.get('ransac_sample_ms')} ms, device solve "
          f"{t.get('ransac_ms')} ms), n_features {t['n_features']}", flush=True)
    print(f"  sift bucket {t.get('sift_bucket')}, surf bucket {t.get('surf_bucket')}, "
          f"pairs {t.get('n_pairs')} -> low-res {t.get('n_lowres_pairs')} -> "
          f"ransac {t.get('n_ransac_pairs')} -> connected {t.get('n_connected_pairs')}", flush=True)
    print(f"  max_memory_allocated {peak} bytes, top2.launches {launches}, "
          f"top2.split_launches {split_launches}", flush=True)
    print("  top2_pairs calls (desc shape, pairs, bf16): "
          f"{[(tuple(c[0].shape), len(c[2]), c[4]) for c in recorder.calls]}", flush=True)
    if launches <= 0 or split_launches <= 0:
        raise AssertionError("the main path launched a top2 kernel no time")

    vps, matching = load_scene_result(str(scene))
    if len(vps) != views:
        raise AssertionError(f"prebundle has {len(vps)} viewports, expected {views}")
    for i, vp in enumerate(vps):
        if len(vp.positions) == 0 or not np.isfinite(vp.positions).all() \
                or np.abs(vp.positions).max() > 0.5:
            raise AssertionError(f"view {i}: bad feature positions")
    connected = set()
    for m in matching:
        n1, n2 = len(vps[m.view_1_id].positions), len(vps[m.view_2_id].positions)
        if len(m.matches) < 12 or m.matches[:, 0].max() >= n1 or m.matches[:, 1].max() >= n2:
            raise AssertionError(f"pair {m.view_1_id},{m.view_2_id}: bad matches")
        connected.update((m.view_1_id, m.view_2_id))
    if len(connected) != views:
        raise AssertionError(f"only {len(connected)} of {views} views are in a connected pair")
    return (dict(launches=launches, split_launches=split_launches, peak=peak, timings=t,
                 wall=wall), recorder.calls)


def phase_main_path_kernel(calls):
    """Every top2_pairs call of the main path, on its own inputs: held
    against the plain version, then timed, the product and the split
    apart, beside the plain version and the library yardstick. The totals
    are the kernels' work in one main-path run."""
    tot = dict(err=0.0, ms=0.0, split_ms=0.0, plain_ms=0.0, split_plain_ms=0.0,
               library_ms=0.0, flops=0.0, nbytes=0.0, split_bytes=0.0)
    split_err = 0.0
    results = []
    for desc, n_desc, pair_a, pair_b, bf16 in calls:
        V, N, D = desc.shape
        got = top2_mod.top2_pairs(desc, n_desc, pair_a, pair_b, bf16)
        results.append(got)
        want = descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16=bf16)
        rows = torch.arange(N, device=desc.device)[None, :] < n_desc[pair_a.long()][:, None]
        tot["err"] = max(tot["err"], compare(
            f"main path desc {V}x{N}x{D}, {len(pair_a)} pairs",
            tuple(t[rows] for t in got), tuple(t[rows] for t in want), bf16))
        split_err = max(split_err, check_split(desc))
        ops, _ = top2_mod.split(desc, None, bf16)
        call_ms = cuda_ms(lambda: top2_mod.top2_pairs_on(ops, n_desc, pair_a, pair_b), 5)
        call_split = cuda_ms(lambda: top2_mod.split(desc, None, bf16), 5)
        call_plain = cuda_ms(
            lambda: descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16=bf16), 2)
        call_split_plain = cuda_ms(lambda: split_tf32(desc), 5)
        call_library = cuda_ms(lambda: library_top2_pairs(desc, n_desc, pair_a, pair_b, bf16), 2)
        na = n_desc[pair_a.long()].double()
        nb = n_desc[pair_b.long()].double()
        call_flops = float(2.0 * D * (na * nb).sum())     # real rows x real columns
        print(f"    product {call_ms:.4f} ms ({call_flops / call_ms / 1e9:.2f} TFLOP/s on "
              f"real rows), split {call_split:.4f} ms, plain {call_plain:.4f} ms, "
              f"split_tf32 {call_split_plain:.4f} ms, masked torch.topk(torch.bmm) "
              f"{call_library:.4f} ms", flush=True)
        for k, v in (("ms", call_ms), ("split_ms", call_split), ("plain_ms", call_plain),
                     ("split_plain_ms", call_split_plain), ("library_ms", call_library),
                     ("flops", call_flops), ("nbytes", V * N * D * 4 + len(pair_a) * N * 12),
                     ("split_bytes", V * N * D * (4 + (2 if bf16 else 8)))):
            tot[k] += v
    # Each pass is two calls, a->b then b->a (matching_batched._match_pairs).
    for k in range(0, len(calls) - 1, 2):
        desc, _, pair_a, pair_b, bf16 = calls[k]
        if not (torch.equal(calls[k + 1][2], pair_b) and torch.equal(calls[k + 1][3], pair_a)):
            raise AssertionError("main path: calls do not come in a->b, b->a order")
        V, N, D = desc.shape
        check_symmetry(f"main path {V}x{N}x{D}", results[k], results[k + 1], bf16)
    bf16 = any(c[4] for c in calls)
    bound, bound_by, core = top2_bound(tot["flops"], tot["nbytes"], bf16)
    split_bound = 1e3 * tot["split_bytes"] / PEAK_BYTES
    print(f"  all {len(calls)} calls: product {tot['ms']:.4f} ms ({tot['flops'] / tot['ms'] / 1e9:.2f} "
          f"TFLOP/s on real rows), plain {tot['plain_ms']:.4f} ms, masked torch.topk(torch.bmm) "
          f"{tot['library_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}; 3 TF32 tensor-core "
          f"products; float32 on the CUDA cores {core:.4f} ms)", flush=True)
    print(f"  split: {tot['split_ms']:.4f} ms, split_tf32 {tot['split_plain_ms']:.4f} ms, "
          f"bound {split_bound:.4f} ms (bytes)", flush=True)
    return (dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                 bound_ms=bound, bound_by=bound_by, library_ms=tot["library_ms"]),
            dict(max_abs_err=split_err, ms=tot["split_ms"], plain_ms=tot["split_plain_ms"],
                 bound_ms=split_bound, bound_by="bytes", library_ms=None))


def phase_mutual_matches(calls):
    """matching_batched._match_pairs (Lowe ratio and the mutual check over
    both directions) at the main path's three passes, through the kernel
    and through the plain version: the share of real query rows whose
    mutual-match target (or none) is the same."""
    plain = lambda desc, n_desc, pa, pb, bf16: descriptor_top2_pairs(desc, n_desc, pa, pb,
                                                                     use_bf16=bf16)
    worst = 1.0
    for desc, n_desc, pair_a, pair_b, _ in calls[0::2]:    # the a->b call of each pass
        V, N, D = desc.shape
        lowe_sq = (0.7 if D == 64 else 0.8) ** 2
        got = matching_batched._match_pairs(desc, n_desc, pair_a, pair_b, lowe_sq)
        matching_batched.top2_pairs = plain
        try:
            want = matching_batched._match_pairs(desc, n_desc, pair_a, pair_b, lowe_sq)
        finally:
            matching_batched.top2_pairs = top2_mod.top2_pairs
        rows = torch.arange(N, device=desc.device)[None, :] < n_desc[pair_a.long()][:, None]
        same = int((got == want)[rows].sum()) / int(rows.sum())
        worst = min(worst, same)
        print(f"  _match_pairs desc {V}x{N}x{D}: {int((got >= 0).sum())} mutual matches "
              f"through the kernel, {int((want >= 0).sum())} through the plain version; "
              f"{same:.6f} of targets identical (>=0.999)", flush=True)
        if same < 0.999:
            raise AssertionError(f"mutual-match targets agree on {same:.6f} < 0.999")
    return worst


def true_centres(n_views):
    """Camera centres of the synthetic generator's cameras (seed 7)."""
    return np.array([-c.rot.astype(np.float64).T @ c.trans.astype(np.float64)
                     for c in synthetic.make_cameras(n_views, spread=0.55, seed=7)])


def aligned_error(est, ref):
    """Largest distance between est, moved onto ref by the best similarity
    (the port's Horn alignment), and ref, as a share of ref's extent (the
    norm of its bounding box's diagonal)."""
    R, s, t = _determine_similarity(est, ref)
    aligned = s * est @ R.T + t
    return float(np.linalg.norm(aligned - ref, axis=1).max()
                 / np.linalg.norm(ref.max(axis=0) - ref.min(axis=0)))


def bundle_centres(bundle):
    """(registered mask, centres of the registered cameras) of a bundle."""
    ok = np.array([c.flen > 0 for c in bundle.cameras])
    centres = np.array([-c.rot.astype(np.float64).T @ c.trans.astype(np.float64)
                        for c in bundle.cameras if c.flen > 0])
    return ok, centres


# Phase 7 and 9's limits: camera centres within 2% of the true cameras'
# extent (tests/test_sfm_pipeline.py:68 holds mve_tpu to the same), track
# counts card against CPU within 1%.
CENTRE_TOL, TRACK_TOL = 0.02, 0.01
# Phase 8's limits, card against CPU (float32 on both, the same port code;
# only the order of float32 sums differs): final MSE relative, the rest
# absolute. Measured on an H100 (PERF.md): MSE 1.85e-7, focal length
# 2.5e-5, distortion 2.2e-3 (k1 of an end camera, about -4.3 and weakly
# held), translation 2.4e-4, rotation 1.3e-5, points 2.7e-4. Each limit
# is 4-50 times its reading.
BA_TOLS = dict(mse=1e-5, focal=1e-4, distortion=1e-2, translation=1e-3, rotation=1e-4,
               points=1e-3)


def phase_sfm_card_vs_cpu():
    """The whole app from phase 4's scene and prebundle, card and CPU."""
    base = WORK / "small"
    truth = true_centres(4)
    found = {}
    for dev in ("cuda", "cpu"):
        scene = base / f"sfm_{dev}"
        shutil.rmtree(scene, ignore_errors=True)
        shutil.copytree(base / "cuda", scene)
        t0 = time.perf_counter()
        inc = sfmrecon.sfm_reconstruct(str(scene), verbose=False, device=dev)
        wall = time.perf_counter() - t0
        t = sfmrecon.LAST_TIMINGS
        ok, centres = bundle_centres(load_mve_bundle(str(scene / "synth_0.out")))
        err = aligned_error(centres, truth) if ok.all() else math.inf
        found[dev] = (t["n_tracks"], centres)
        print(f"  {dev}: {wall:.3f} s, {int(ok.sum())}/4 cameras, {t['n_tracks']} tracks, "
              f"centres {err:.5f} of the true extent (<={CENTRE_TOL}), last BA MSE "
              f"{inc.last_ba_status.final_mse:.6e}, incremental_ms {t['incremental_ms']} "
              f"{t['incremental_phases']}, BA {t['ba_totals']}, undistort_ms {t['undistort_ms']}",
              flush=True)
        if not ok.all() or t["n_cameras"] != 4:
            raise AssertionError(f"{dev}: only {int(ok.sum())} of 4 views registered")
        if err > CENTRE_TOL:
            raise AssertionError(f"{dev}: camera centres {err:.5f} of the extent from the truth")
    (nc, cc), (nk, ck) = found["cuda"], found["cpu"]
    print(f"  card against CPU: tracks {nc} / {nk}, centres {aligned_error(cc, ck):.2e} of "
          f"the extent apart", flush=True)
    if abs(nc - nk) > TRACK_TOL * nk:
        raise AssertionError(f"track counts differ by more than 1%: cuda {nc}, cpu {nk}")


def synthetic_ba_problem(n_cams, n_pts, n_obs_per_pt, seed=0):
    """A copy of __graft_entry__._synthetic_ba_problem (the BA problem of
    bench.py:170-181), which imports mve_tpu: points in a cube at z = 5,
    cameras on an arc looking at it, each point seen by a window of
    n_obs_per_pt cameras, observations with 1e-3 noise, then cameras and
    points perturbed. Returns float64 (intr, trans, rot, points, obs) and
    int32 (cam_idx, pt_idx), rounded through float32 as the original's."""
    rng = np.random.RandomState(seed)
    pts = rng.rand(n_pts, 3) * 2 - 1
    pts[:, 2] += 5.0
    intr = np.zeros((n_cams, 3))
    trans = np.zeros((n_cams, 3))
    rot = np.zeros((n_cams, 3, 3))
    target = np.array([0.0, 0.0, 5.0])
    for i in range(n_cams):
        intr[i] = [0.9, 0.0, 0.0]
        theta = (i / max(n_cams - 1, 1) - 0.5) * 1.2
        center = np.array([5.0 * np.sin(theta), 0.2 * rng.randn(), 5.0 - 5.0 * np.cos(theta)])
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        rot[i] = R
        trans[i] = -R @ center
    obs_l, ci_l, pi_l = [], [], []
    for c in range(n_cams):
        pc = (rot[c] @ pts.T).T + trans[c]
        uv = pc[:, :2] / pc[:, 2:] * intr[c, 0]
        first = (np.arange(n_pts) * 7919) % max(n_cams - n_obs_per_pt + 1, 1)
        sel = (c >= first) & (c < first + n_obs_per_pt)
        if not sel.any():
            continue
        obs_l.append(uv[sel] + rng.randn(int(sel.sum()), 2) * 1e-3)
        ci_l.append(np.full(int(sel.sum()), c))
        pi_l.append(np.nonzero(sel)[0])
    intr[:, 0] += rng.randn(n_cams) * 0.01
    trans += rng.randn(n_cams, 3) * 0.01
    pts += rng.randn(n_pts, 3) * 0.02
    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)
    return (f32(intr), f32(trans), f32(rot), f32(pts), f32(np.concatenate(obs_l)),
            np.concatenate(ci_l).astype(np.int32), np.concatenate(pi_l).astype(np.int32))


def count_syncs(fn):
    """(result, host syncs) of fn(), by torch.cuda's sync debug mode."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def device_profile(fn, top=0):
    """(result, wall ms, device kernel ms, top ops) of fn() under
    torch.profiler: the sum of the kernels' own time on the card against
    the host's clock, both inflated a little by the profiler, and the
    `top` device ops with the most time as (name, ms, calls). The device
    events are summed from the profiler's raw events, read through the
    private prof.profiler.kineto_results (torch 2.11): key_averages()
    builds a Python object per event, about 50 s for each of phases 8
    and 11 and minutes for the million events of phase 14's evaluation.
    Where a torch version lacks that attribute, key_averages() does it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    raw = getattr(prof.profiler, "kineto_results", None)
    if raw is not None:
        own = {}
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA:
                ms, calls = own.get(e.name(), (0.0, 0))
                own[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
        tops = [(name, ms, calls) for name, (ms, calls) in own.items()]
    else:
        tops = [(e.key, (getattr(e, "self_device_time_total", None) or e.self_cuda_time_total) / 1e3,
                 e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    tops.sort(key=lambda x: -x[1])
    return out, wall, sum(ms for _, ms, _ in tops), tops[:top]


def ba_gaps(a, b):
    """Final MSE (relative) and parameters (absolute) of two
    optimize_arrays results, apart at most."""
    gaps = dict(mse=abs(a[4].final_mse - b[4].final_mse) / b[4].final_mse)
    for name, x, y in (("focal", a[0][:, 0], b[0][:, 0]), ("distortion", a[0][:, 1:], b[0][:, 1:]),
                       ("translation", a[1], b[1]), ("rotation", a[2], b[2]),
                       ("points", a[3], b[3])):
        gaps[name] = float(np.abs(x - y).max())
    return gaps


def phase_ba():
    """optimize_arrays at the size of ROADMAP.md item 6 (bench.py's BA):
    card against CPU from the same arrays, float32 on both. Limits: LM
    steps equal or one apart (tests/test_torch_ba.py allows one step
    against mve_tpu), final MSE and parameters within BA_TOLS."""
    arrays = synthetic_ba_problem(64, 10_240, 4, seed=0)
    n_obs = len(arrays[4])
    opts = BAOptions()
    out = {}
    for name, dev in (("cuda", "cuda"), ("cuda, again", "cuda"), ("cpu", "cpu")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = optimize_arrays(*arrays, opts, device=dev)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        st = res[4]
        out[name] = res
        print(f"  {name}: {wall:.1f} ms, MSE {st.initial_mse:.6e} -> {st.final_mse:.6e}, "
              f"{st.num_lm_iterations} LM steps ({st.num_lm_successful_iterations} ok), "
              f"{st.num_cg_iterations} CG iterations, {wall / max(st.num_lm_iterations, 1):.2f} "
              f"ms per LM step, {wall / max(st.num_cg_iterations, 1):.3f} ms per CG iteration",
              flush=True)
    res, syncs = count_syncs(lambda: optimize_arrays(*arrays, opts, device="cuda"))
    st = res[4]
    print(f"  host syncs of one card BA: {syncs} ({st.num_lm_iterations} LM steps, "
          f"{st.num_cg_iterations} CG iterations)", flush=True)
    _, wall, busy, _ = device_profile(lambda: optimize_arrays(*arrays, opts, device="cuda"))
    print(f"  under torch.profiler: {wall:.1f} ms, of which device kernels {busy:.1f} ms "
          f"({100 * busy / wall:.1f}% busy, {100 - 100 * busy / wall:.1f}% idle)", flush=True)
    a, b, c = out["cuda"], out["cuda, again"], out["cpu"]
    identical = all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])) and \
        a[4].final_mse == b[4].final_mse and a[4].num_cg_iterations == b[4].num_cg_iterations
    print(f"  two card runs bit-identical: {identical}", flush=True)
    steps = abs(a[4].num_lm_iterations - c[4].num_lm_iterations)
    gaps = ba_gaps(a, c)
    print(f"  card against CPU: LM steps {a[4].num_lm_iterations} / {c[4].num_lm_iterations} "
          f"(<=1 apart), {n_obs} observations; apart at most (limit): "
          + ", ".join(f"{k} {v:.3e} ({BA_TOLS[k]:g})" for k, v in gaps.items())
          + " (final MSE relative)", flush=True)
    if steps > 1 or any(v > BA_TOLS[k] for k, v in gaps.items()) \
            or not a[4].final_mse < a[4].initial_mse:
        raise AssertionError("BA on the card disagrees with BA on the CPU")
    return dict(identical=identical, syncs=syncs, status=a[4], busy_share=busy / wall)


def initial_pair_search(scene):
    """The automatic initial-pair search of plain sfmrecon on the card, on
    the loaded prebundle with sfm_reconstruct's intrinsics, tracks and
    options: it must find no pair, every candidate it tests being over
    max_homography_inliers (MAIN_INITIAL_PAIR's comment)."""
    vps, matching = load_scene_result(str(scene))
    Intrinsics(IntrinsicsOptions()).compute(Scene(str(scene)), vps)
    tracks = Tracks().compute(matching, vps)
    opts = SfmOptions().init_pair_opts
    fractions = []
    real = init_pair_mod.ransac_homography

    def recorded(p1, p2, *args, **kwargs):
        res = real(p1, p2, *args, **kwargs)
        fractions.append(len(res.inliers) / len(p1))
        return res

    search = InitialPair(opts, device="cuda")
    search.initialize(vps, tracks)
    init_pair_mod.ransac_homography = recorded
    t0 = time.perf_counter()
    try:
        res = search.compute_pair()
    finally:
        init_pair_mod.ransac_homography = real
    torch.cuda.synchronize()
    print(f"  InitialPair.compute_pair() on the card: {time.perf_counter() - t0:.3f} s, "
          f"{len(tracks)} tracks, {len(fractions)} candidates tested, homography inlier "
          f"fractions {min(fractions, default=math.nan):.4f} (lowest) to "
          f"{max(fractions, default=math.nan):.4f}, limit {opts.max_homography_inliers}; "
          f"result ({res.view_1_id}, {res.view_2_id})", flush=True)
    if (res.view_1_id, res.view_2_id) != (-1, -1) or not fractions \
            or min(fractions) <= opts.max_homography_inliers:
        raise AssertionError("the automatic initial-pair search did not reject every candidate "
                             "by its homography inliers")


def phase_full_sfm():
    """The whole app on phase 5's scene, from phase 5's prebundle."""
    scene = WORK / "main"
    initial_pair_search(scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    top2_mod.launches = top2_mod.split_launches = 0
    t0 = time.perf_counter()
    inc = sfmrecon.sfm_reconstruct(str(scene), initial_pair=MAIN_INITIAL_PAIR, verbose=False,
                                   device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t = dict(sfmrecon.LAST_TIMINGS)
    ok, centres = bundle_centres(load_mve_bundle(str(scene / "synth_0.out")))
    err = aligned_error(centres, true_centres(MAIN_VIEWS)[ok])
    print(f"  sfm_reconstruct(initial_pair={MAIN_INITIAL_PAIR}, device='cuda') from the "
          f"prebundle: {wall:.3f} s "
          f"(top2 launches {top2_mod.launches}: the prebundle is loaded)", flush=True)
    print(f"  {int(ok.sum())}/{MAIN_VIEWS} cameras, n_tracks {t['n_tracks']}, centres {err:.5f} "
          f"of the true extent (<={CENTRE_TOL}), last BA MSE {inc.last_ba_status.final_mse:.6e}",
          flush=True)
    print(f"  incremental_ms {t['incremental_ms']}, incremental_phases {t['incremental_phases']}, "
          f"undistort_ms {t['undistort_ms']}", flush=True)
    bt = t["ba_totals"]
    print(f"  BAs {bt['n_ba']}, LM steps {bt['lm_iters']}, CG iterations {bt['cg_iters']}, BA ms "
          f"{bt['ms']} ({bt['ms'] / max(bt['lm_iters'], 1):.2f} ms per LM step), "
          f"max_memory_allocated {peak} bytes", flush=True)
    if not ok.all() or t["n_cameras"] != MAIN_VIEWS:
        raise AssertionError(f"only {int(ok.sum())} of {MAIN_VIEWS} views registered")
    if err > CENTRE_TOL:
        raise AssertionError(f"camera centres {err:.5f} of the extent from the truth")
    return dict(wall=wall, timings=t, peak=peak, err=err)


# Phases 10 and 11's limits, card against CPU (the same port code, float32
# on both; exp and arccos round differently on the two, and the solver's
# PatchMatch picks and parabolic steps turn such last-bit differences into
# moves of a polish step): per-view fill within FILL_TOL, median relative
# depth difference on pixels both accept within DEPTH_TOL. Measured on an
# H100 (PERF.md): fill 3e-4 apart at most, medians 1.9e-4 to 6.8e-4.
FILL_TOL, DEPTH_TOL = 0.005, 1e-3
DEPTH_EMBEDDINGS = ("depth", "conf", "dz", "undist")
# Phase 11's limits against the scene itself: every view's fill (lowest
# measured on an H100: 0.8635, PERF.md); every view's accepted depths
# against the scene's two planes (scene_planes): the median relative error
# within TRUTH_TOL, and at most GROSS_TOL of the pixels more than GROSS_OFF
# off. Measured on an H100 (PERF.md): medians 9.2e-4 to 1.44e-3, at most
# 0.2% of the pixels more than 5% off.
FILL_FLOOR, TRUTH_TOL, GROSS_OFF, GROSS_TOL = 0.85, 3e-3, 0.05, 0.005


def depth_maps(scene, name):
    """{view id: (H, W) depth map} of every view that has embedding name."""
    return {i: v.get_image(name)[..., 0] for i, v in enumerate(Scene(str(scene)).get_views())
            if v is not None and v.has_image(name)}


def compare_depths(card, cpu):
    """Per view, card against CPU: fill gap and median relative depth
    difference on pixels both accept, printed; raises outside FILL_TOL
    and DEPTH_TOL. Returns (worst fill gap, worst median)."""
    if set(card) != set(cpu) or not cpu:
        raise AssertionError(f"depth maps for views {sorted(card)} on the card, {sorted(cpu)} on the CPU")
    worst_fill = worst_med = 0.0
    for i in sorted(cpu):
        a, b = card[i], cpu[i]
        fa, fb = float((a > 0).mean()), float((b > 0).mean())
        both = (a > 0) & (b > 0)
        med = float(np.median(np.abs(a[both] - b[both]) / b[both])) if both.any() else math.inf
        worst_fill, worst_med = max(worst_fill, abs(fa - fb)), max(worst_med, med)
        print(f"  view {i}: fill card {fa:.4f} / cpu {fb:.4f}, median relative depth difference "
              f"{med:.3e}, {float((a == b).mean()):.4f} of pixels identical", flush=True)
    print(f"  worst: fill gap {worst_fill:.4f} (<={FILL_TOL}), median relative depth difference "
          f"{worst_med:.3e} (<={DEPTH_TOL:g})", flush=True)
    if worst_fill > FILL_TOL or worst_med > DEPTH_TOL:
        raise AssertionError("dmrecon on the card disagrees with dmrecon on the CPU")
    return worst_fill, worst_med


def check_embeddings(scenes, level):
    """The same depth/conf/dz/undist embeddings, shapes and dtypes for the
    same views in every scene."""
    names = [f"{e}-L{level}" for e in DEPTH_EMBEDDINGS]
    found = []
    for scene in scenes:
        found.append({(i, n): (v.get_image(n).shape, v.get_image(n).dtype)
                      for i, v in enumerate(Scene(str(scene)).get_views()) if v is not None
                      for n in names if v.has_image(n)})
    if any(f != found[0] for f in found[1:]) or not found[0]:
        raise AssertionError("the runs wrote different embeddings")
    return len({i for i, _ in found[0]})


def solvers_taken():
    """The solver of each batch of the last reconstruct_views call."""
    return {b[1] for b in mvs_dmrecon.LAST_TIMINGS["batches"]}


def phase_dmrecon_card_vs_cpu():
    """dmrecon on phase 7's scene (4 views of 480 x 360, cameras from
    phase 7's card run) with each solver: card twice and CPU. A view of
    this scene has 3 neighbours, so local view selection takes 3
    (nr_recon_neighbors=3); everything else is Settings()'s default but
    for the solver's switches. The sweep solver runs at scale 1; the warp
    solvers, which take the CPU 10 s a view at scale 1 and 40-75 s with
    exact NCC, run at scale 2, exact NCC for view 0 only."""
    base = WORK / "small"
    solvers = (("sweep", "sweep", dict(), 1, None),
               ("warp", "warp", dict(use_sweep=False), 2, None),
               ("warp, exact NCC", "warp", dict(use_sweep=False, exact_ncc=True), 2, {0}))
    for label, want, switches, level, view_ids in solvers:
        print(f"  -- {label} solver, scale {level}, views {sorted(view_ids or range(4))}",
              flush=True)
        settings = MvsSettings(nr_recon_neighbors=3, **switches)
        scenes = {}
        for name, dev in (("cuda", "cuda"), ("cuda, again", "cuda"), ("cpu", "cpu")):
            scene = base / f"dm_{name.replace(', ', '_')}"
            shutil.rmtree(scene, ignore_errors=True)
            shutil.copytree(base / "sfm_cuda", scene)
            t0 = time.perf_counter()
            n = dmrecon.reconstruct_views(str(scene), scale=level, settings=settings,
                                          verbose=False, view_ids=view_ids, device=dev)
            torch.cuda.synchronize()
            print(f"  {name}: {n} depth maps in {time.perf_counter() - t0:.3f} s, fills "
                  f"{dmrecon.LAST_STATS.get('per_view_fills')}, {mvs_dmrecon.LAST_TIMINGS}",
                  flush=True)
            if solvers_taken() != {want}:
                raise AssertionError(f"dmrecon took the {solvers_taken()} solver, not {want}")
            scenes[name] = scene
        n_views = check_embeddings(scenes.values(), level)
        card = depth_maps(scenes["cuda"], f"depth-L{level}")
        again = depth_maps(scenes["cuda, again"], f"depth-L{level}")
        identical = set(card) == set(again) and all(np.array_equal(card[i], again[i]) for i in card)
        print(f"  {n_views} views with depth, conf, dz and undist embeddings in all three runs; "
              f"two card runs bit-identical: {identical}", flush=True)
        if n_views != len(view_ids or range(4)) or not identical:
            raise AssertionError("dmrecon: views missing, or two card runs differ")
        compare_depths(card, depth_maps(scenes["cpu"], f"depth-L{level}"))
    tied = torch.full((21, 300, 400), -1.0, device="cuda")
    first = torch.argmax(tied, dim=0)
    tied[5:] = 0.5
    fifth = torch.argmax(tied, dim=0)
    ok = bool((first == 0).all()) and bool((fifth == 5).all())
    print(f"  torch.argmax on the card over all-tied (21, 300, 400): first index everywhere: {ok}",
          flush=True)
    if not ok:
        raise AssertionError("torch.argmax on the card does not return the first of tied maxima")
    for scene in base.glob("dm_*"):
        shutil.rmtree(scene, ignore_errors=True)  # sfm_cuda stays for phase 30


def scene_planes(scene):
    """The scene's two planes as the bundle's own 3D points (sfmrecon's
    triangulated tracks, which dmrecon does not touch) place them:
    (R, s, t, planes). R, s, t is the similarity that moves the bundle's
    camera centres onto the generator's (aligned = s R x + t); planes is
    ((a, b, c) of the near patch, (a, b, c) of the background), each
    z = a x + b y + c in the generator's frame, fitted by least squares
    to the aligned points of its side of a two-means split of their z,
    once and again without points more than three median residuals off.
    Planes fitted from the bundle rather than taken from the generator:
    sfmrecon estimates the focal length (1.0 without EXIF data, against
    the generator's 0.9), which stretches the scene along the viewing
    direction but keeps planes planar."""
    bundle = load_mve_bundle(str(scene / "synth_0.out"))
    ok, centres = bundle_centres(bundle)
    R, s, t = _determine_similarity(centres, true_centres(len(ok))[ok])
    p = s * bundle.feature_positions().astype(np.float64) @ R.T + t
    z = p[:, 2]
    split = float(np.median(z))
    for _ in range(50):
        split = 0.5 * (z[z < split].mean() + z[z >= split].mean())
    planes = []
    for side in (z < split, z >= split):
        q = p[side]
        A = np.c_[q[:, :2], np.ones(len(q))]
        coef = np.linalg.lstsq(A, q[:, 2], rcond=None)[0]
        res = np.abs(A @ coef - q[:, 2])
        keep = res <= 3 * np.median(res)
        planes.append(np.linalg.lstsq(A[keep], q[keep, 2], rcond=None)[0])
    return R, s, t, planes


def depth_truth_errors(scene, name):
    """{view id: (median relative error, share more than GROSS_OFF off)}
    of each view's accepted depths against the scene's two planes
    (scene_planes): each pixel's point, in the generator's frame, is off
    the nearer plane by its distance along z, taken over the point's ray
    length."""
    R, s, t, planes = scene_planes(scene)
    out = {}
    for i, view in enumerate(Scene(str(scene)).get_views()):
        if view is None or not view.has_image(name):
            continue
        depth = view.get_image(name)[..., 0].astype(np.float64)
        H, W = depth.shape
        cam = view.camera
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
        pix = np.stack([xs + 0.5, ys + 0.5, np.ones_like(xs)], axis=-1)[depth > 0]
        rays = (pix @ cam.inverse_calibration(W, H).T) @ cam.rot.astype(np.float64)
        rays /= np.linalg.norm(rays, axis=1, keepdims=True)
        d = depth[depth > 0]
        p = s * (cam.camera_pos() + d[:, None] * rays) @ R.T + t
        off = np.min([np.abs(p[:, 0] * a + p[:, 1] * b + c - p[:, 2]) for a, b, c in planes],
                     axis=0)
        rel = off / (s * d)
        out[i] = float(np.median(rel)), float((rel > GROSS_OFF).mean())
    return out


def prepare_view(scene_path, view_id, settings):
    """mvs.dmrecon's host preparation of one view, as reconstruct_batch
    runs it."""
    import dataclasses

    scene = Scene(str(scene_path))
    return mvs_dmrecon._prepare_view(scene, dataclasses.replace(settings, ref_view_nr=view_id),
                                     *mvs_dmrecon._scene_inputs(scene, settings), view_id)


# Phase 11's view 0 on the CPU: a second process with this many intra-op
# threads (of the host's 8), started when phase 14 starts (phases 14 and
# 15 leave most of the host's cores idle) and read when phase 15 ends.
CPU_VIEW0_THREADS = 6
# Processes started in the background; main() stops any still running.
BACKGROUND = []


def phase_full_dmrecon():
    """dmrecon -s2 on phase 9's scene with the app's default Settings."""
    scene = WORK / "main"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    n = dmrecon.reconstruct_views(str(scene), scale=2, settings=MvsSettings(), verbose=False,
                                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t = dict(mvs_dmrecon.LAST_TIMINGS)
    fills = dmrecon.LAST_STATS["per_view_fills"]
    shapes = {m.shape for m in depth_maps(scene, "depth-L2").values()}
    expect = (MAIN_HEIGHT + 3) // 4, (MAIN_WIDTH + 3) // 4
    print(f"  reconstruct_views(scale=2, device='cuda'): {n} depth maps of {sorted(shapes)} in "
          f"{wall:.3f} s: host preparation {t['prepare_ms'] / 1e3:.3f} s, device solve (synced) "
          f"{t['solve_ms'] / 1e3:.3f} s, writes {t['write_ms'] / 1e3:.3f} s, rest "
          f"{wall - (t['prepare_ms'] + t['solve_ms'] + t['write_ms']) / 1e3:.3f} s; batches "
          f"(views, solver, H, W, J) {t['batches']}", flush=True)
    print(f"  fill per view {[round(fills[i], 4) for i in sorted(fills)]}, mean "
          f"{dmrecon.LAST_STATS['depth_fill']:.4f}, lowest {dmrecon.LAST_STATS['depth_fill_min']:.4f}; "
          f"max_memory_allocated {peak} bytes", flush=True)
    if n != MAIN_VIEWS or len(fills) != MAIN_VIEWS or shapes != {expect}:
        raise AssertionError(f"dmrecon wrote {n} depth maps of {shapes}, expected {MAIN_VIEWS} of {expect}")
    if solvers_taken() != {"sweep"}:
        raise AssertionError(f"dmrecon took the {solvers_taken()} solver, not the sweep solver")
    if not all(np.isfinite(m).all() for m in depth_maps(scene, "depth-L2").values()) \
            or dmrecon.LAST_STATS["depth_fill_min"] < FILL_FLOOR:
        raise AssertionError(f"dmrecon: a depth map is not finite, or a fill is below {FILL_FLOOR}")
    truth = depth_truth_errors(scene, "depth-L2")
    worst = max(m for m, _ in truth.values())
    gross = max(g for _, g in truth.values())
    print(f"  accepted depths against the scene's planes (fitted to the bundle's points): median "
          f"relative error per view {[float(f'{truth[i][0]:.3e}') for i in sorted(truth)]}, worst "
          f"{worst:.3e} (<={TRUTH_TOL:g}); share more than {GROSS_OFF:g} off per view "
          f"{[round(truth[i][1], 5) for i in sorted(truth)]}, worst {gross:.5f} (<={GROSS_TOL:g})",
          flush=True)
    if len(truth) != MAIN_VIEWS or worst > TRUTH_TOL or gross > GROSS_TOL:
        raise AssertionError("dmrecon: depths off the scene's planes")

    # One view alone: its time, then under the profiler (the solver's
    # phases from the CUDA events of its mvs.solve.<phase> spans, busy
    # share and the ten most expensive device ops).
    settings = MvsSettings(scale=2)
    prep = prepare_view(scene, 0, settings)
    if not mvs_dmrecon._sweep_capable(prep, settings):
        raise AssertionError("view 0 does not take the sweep solver")
    mvs_dmrecon._run_batch([prep], settings, "cuda")      # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mvs_dmrecon._run_batch([prep], settings, "cuda")
    view_ms = 1e3 * (time.perf_counter() - t0)
    tracing.clear()
    _, pwall, busy, tops = device_profile(lambda: mvs_dmrecon._run_batch([prep], settings, "cuda"),
                                          top=10)
    phases = {r.name.removeprefix("mvs.solve."): r.device_ms for r in tracing.records()
              if r.name.startswith("mvs.solve.")}
    tracing.clear()
    print(f"  view 0 alone (sweep solver, {prep['n_selected']} neighbours): {view_ms:.1f} ms; "
          f"phases on the card under the profiler (ms) "
          + ", ".join(f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
    print(f"  under torch.profiler: {pwall:.1f} ms, of which device kernels {busy:.1f} ms "
          f"({100 * busy / pwall:.1f}% busy, {100 - 100 * busy / pwall:.1f}% idle); top device ops:",
          flush=True)
    for name, ms, calls in tops:
        print(f"    {ms:9.2f} ms {calls:6d} calls  {name[:110]}", flush=True)
    # The same view with one torch.cumsum per prefix sum and plain float32
    # multiply-adds in place of the CPU's order (mvs/patch.py): what that
    # order costs on the card, and how far the depths move without it.
    plain = {"_prefix_sum": torch.cumsum, "_fma": lambda a, b, c: a * b + c}
    swapped = [(m, name, getattr(m, name)) for m in (mvs_patch, mvs_sweep, mvs_vs)
               for name in plain if hasattr(m, name)]
    ordered = mvs_dmrecon._run_batch([prep], settings, "cuda")[0][0]
    for m, name, _ in swapped:
        setattr(m, name, plain[name])
    try:
        mvs_dmrecon._run_batch([prep], settings, "cuda")  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        unordered = mvs_dmrecon._run_batch([prep], settings, "cuda")[0][0]
        plain_ms = 1e3 * (time.perf_counter() - t0)
        _, xwall, xbusy, _ = device_profile(lambda: mvs_dmrecon._run_batch([prep], settings, "cuda"))
    finally:
        for m, name, fn in swapped:
            setattr(m, name, fn)
    both = (ordered > 0) & (unordered > 0)
    print(f"  view 0 alone with torch.cumsum and plain multiply-adds on the card: {plain_ms:.1f} ms; "
          f"under torch.profiler {xwall:.1f} ms, of which device kernels {xbusy:.1f} ms "
          f"({100 * xbusy / xwall:.1f}% busy); fill {float((unordered > 0).mean()):.4f} against "
          f"{float((ordered > 0).mean()):.4f}, median relative depth difference "
          f"{float(np.median(np.abs(unordered[both] - ordered[both]) / ordered[both])):.3e}",
          flush=True)

    # View 0 card against CPU: the CPU's run is made on a copy of the scene
    # by start_cpu_view0 and held against this run's view 0 by
    # finish_cpu_view0.
    cpu_scene = WORK / "main_cpu"
    shutil.rmtree(cpu_scene, ignore_errors=True)
    shutil.copytree(scene, cpu_scene)
    card_view0 = depth_maps(scene, "depth-L2")[0]
    return dict(wall=wall, timings=t, peak=peak, busy_share=busy / pwall, phases=phases,
                card_view0=card_view0)


def start_cpu_view0():
    """dmrecon -s2 of view 0 on the CPU (the app's default Settings, as
    phase 11's card run), on phase 11's copy of the scene, in a second
    process without the card. Returns (process, log path, start time)."""
    code = ("import sys, time, torch; torch.set_num_threads(int(sys.argv[2])); "
            "from mve_tpu_torch.apps import dmrecon; from mve_tpu_torch.mvs import Settings; "
            "t0 = time.perf_counter(); "
            "dmrecon.reconstruct_views(sys.argv[1], scale=2, view_ids={0}, force=True, "
            "settings=Settings(), verbose=False, device='cpu'); "
            "print(f'{time.perf_counter() - t0:.3f}')")
    log = WORK / "main_cpu.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", code, str(WORK / "main_cpu"), str(CPU_VIEW0_THREADS)],
            cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    BACKGROUND.append(proc)
    return proc, log, time.perf_counter()


def finish_cpu_view0(started, card_view0):
    """Waits for start_cpu_view0's process and holds phase 11's view 0
    against the CPU's with phase 10's limits."""
    proc, log, t_start = started
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("phase 11's view 0 on the CPU did not end within 900 s")
    waited = time.perf_counter() - t0
    out = log.read_text()
    if rc != 0:
        raise AssertionError(f"phase 11's view 0 on the CPU exited {rc}:\n{out[-3000:]}")
    cpu_scene = WORK / "main_cpu"
    print(f"  view 0 on the CPU ({CPU_VIEW0_THREADS} threads, in a second process started "
          f"{time.perf_counter() - t_start:.1f} s ago): reconstruct_views {out.split()[-1]} s; "
          f"waited for it {waited:.1f} s", flush=True)
    compare_depths({0: card_view0}, {0: depth_maps(cpu_scene, "depth-L2")[0]})
    shutil.rmtree(cpu_scene, ignore_errors=True)


def stop_background():
    """Kills every background process still running."""
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def phase_pointset():
    """scene2pset -F2 on phase 11's depth maps; then the scene goes."""
    scene = WORK / "main"
    out = scene / "pset-L2.ply"
    t0 = time.perf_counter()
    merged = scene2pset.scene_to_pointset(
        str(scene), str(out), dmname="depth-L2", image="undist-L2", with_normals=True,
        with_scale=True, with_conf=True, verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    mesh = load_mesh(str(out))
    n = merged.num_vertices()
    print(f"  scene_to_pointset(-F2): {n} points in {wall:.3f} s; {out.name} "
          f"{out.stat().st_size} bytes, read back {mesh.num_vertices()} vertices", flush=True)
    norms = np.linalg.norm(mesh.vertex_normals, axis=1) if mesh.has_vertex_normals() else None
    if not (mesh.num_vertices() == n > 0 and norms is not None and len(norms) == n
            and np.all(np.abs(norms - 1) < 1e-3) and mesh.has_vertex_values()
            and mesh.has_vertex_confidences() and np.isfinite(mesh.vertices).all()
            and (mesh.vertex_values > 0).all()
            and ((mesh.vertex_confidences >= 0) & (mesh.vertex_confidences <= 1)).all()):
        raise AssertionError("scene2pset: the point set lacks points, normals, values or confidences")
    return dict(points=n, wall=wall)


@contextlib.contextmanager
def recording(module, name):
    """While installed, keeps (args, kwargs, result) of every call of
    module.name; every call still goes to the real function."""
    real = getattr(module, name)
    calls = []

    def rec(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, rec)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def corner_sums_run(path, dev, **kw):
    """fssr_reconstruct(path, device=dev, **kw) with the (V, 10) corner sums
    its evaluation hands to _normalize_sums (the in-memory paths' or the
    streaming path's). Returns (mesh, sums, wall s, LAST_STATS, STATS)."""
    with recording(fssr_iso_octree, "_normalize_sums") as a, \
            recording(fssr_streaming, "_normalize_sums") as b:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh = fssrecon.fssr_reconstruct(str(path), verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    calls = a + b
    if len(calls) != 1:
        raise AssertionError(f"expected one evaluation, saw {len(calls)}")
    return (mesh, calls[0][0][0], wall, dict(fssrecon.LAST_STATS),
            dict(fssr_block_eval.STATS))


def compare_corner_sums(card, cpu):
    """(each column's largest relative difference (10,), the median
    relative difference, sign flips, flips outside the limit, corners
    with confidence > 0 on one side only) of two (V, 10) corner-sum
    arrays: each column's difference over that column's largest
    magnitude on the CPU. A flip is a corner with confidence > 0 on both
    sides whose value (sum 0 over sum 1) changes sign; it is allowed
    where the CPU's |value| is below SIGN_TOL of the median |value|."""
    scale = np.abs(cpu).max(axis=0)
    rel = np.abs(card - cpu) / np.where(scale > 0, scale, 1.0)
    ca, cb = card[:, 1], cpu[:, 1]
    both = (ca > 0) & (cb > 0)
    va = card[both, 0] / ca[both]
    vb = cpu[both, 0] / cb[both]
    flip = (va < 0) != (vb < 0)
    small = np.abs(vb) < SIGN_TOL * np.median(np.abs(vb))
    return (rel.max(axis=0), float(np.median(rel)), int(flip.sum()), int((flip & ~small).sum()),
            int(((ca > 0) != (cb > 0)).sum()))


def scale_diverse_pointset(path):
    """bench.py's fssr_scale_diverse point set (seed 5): the unit square
    sampled at scale 0.1, and a 0.05-wide patch of it at scale 0.001 (a
    span of 100), written as a PLY."""
    rng = np.random.RandomState(5)
    parts = []
    for x0, x1, y0, y1, scale in ((0, 1, 0, 1, 0.1), (0.2, 0.25, 0.2, 0.25, 0.001)):
        nx, ny = max(int((x1 - x0) / scale), 2), max(int((y1 - y0) / scale), 2)
        gx, gy = np.meshgrid(np.linspace(x0, x1, nx), np.linspace(y0, y1, ny), indexing="ij")
        parts.append((np.stack([gx.ravel(), gy.ravel(), rng.randn(gx.size) * scale * 0.01], 1),
                      np.full(gx.size, scale)))
    mesh = TriangleMesh()
    mesh.vertices = np.concatenate([p for p, _ in parts]).astype(np.float32)
    mesh.vertex_normals = np.tile(np.float32([0, 0, 1]), (len(mesh.vertices), 1))
    mesh.vertex_values = np.concatenate([s for _, s in parts]).astype(np.float32)
    mesh.vertex_confidences = np.ones(len(mesh.vertices), np.float32)
    save_mesh(mesh, str(path))
    return len(mesh.vertices)


# Phase 13: every FSSR_EVERY-th point of phase 12's point set (52,137
# points; the CPU's time on the default path goes with the density, and
# every 32nd point, 130,341, took it 147 s on the H100 machine's 8 cores),
# and its streaming chunk size (four chunks). Limits, card against CPU:
# face counts within FACE_TOL; every column of the corner sums (value,
# confidence, weights, derivative, colour) within SUMS_TOL of its largest
# magnitude; confidence > 0 on one side only at no more than CONF_FLIP_TOL
# of the corners; and a corner's sign may differ only where |value| is
# below SIGN_TOL of the median |value| (compare_corner_sums). The final
# card run of the first version read at most 3.740e-7 apart and 1 corner
# of 523,983 with confidence on one side only.
FSSR_EVERY, FSSR_STREAM_CHUNK = 80, 15_000
FACE_TOL, SIGN_TOL, SUMS_TOL, CONF_FLIP_TOL = 1e-3, 1e-6, 1e-5, 1e-5


def phase_fssr_card_vs_cpu():
    """fssrecon card against CPU on three paths: the default (octree, dual
    contouring), streaming, and a scale-diverse set (octave groups with the
    histogram scale filter)."""
    scene = WORK / "main"
    full = load_mesh(str(scene / "pset-L2.ply"))
    sub = TriangleMesh()
    for name in ("vertices", "vertex_normals", "vertex_colors", "vertex_confidences",
                 "vertex_values"):
        setattr(sub, name, getattr(full, name)[::FSSR_EVERY])
    save_mesh(sub, str(scene / "pset-sub.ply"))
    n_div = scale_diverse_pointset(scene / "pset-diverse.ply")
    print(f"  every {FSSR_EVERY}th point of pset-L2.ply: {sub.num_vertices()} of "
          f"{full.num_vertices()} points; scale-diverse set: {n_div} points (span 100)", flush=True)
    del full
    worst = {}
    for label, path, kw in (
            ("default", scene / "pset-sub.ply", {}),
            (f"stream, chunks of {FSSR_STREAM_CHUNK}", scene / "pset-sub.ply",
             dict(stream=True, stream_chunk_size=FSSR_STREAM_CHUNK)),
            ("scale-diverse, max_level 14", scene / "pset-diverse.ply", dict(max_level=14))):
        runs = {}
        for dev in ("cuda", "cpu"):
            with recording(fssr_block_eval, "evaluate_positions_blocked") as evals:
                runs[dev] = corner_sums_run(path, dev, **kw)
            if label == "default" and dev == "cuda":
                worst["default_eval"] = evals[0]            # phase 27's unsharded reference
        (mg, sg, wg, lg, bg), (mc, sc, wc, lc, _) = runs["cuda"], runs["cpu"]
        if sg.shape != sc.shape:
            raise AssertionError(f"{label}: {len(sg)} corners on the card, {len(sc)} on the CPU")
        cols, rmed, flips, bad, conf_flips = compare_corner_sums(sg, sc)
        rmax = float(cols.max())
        fg, fc = mg.num_faces(), mc.num_faces()
        print(f"  {label}: card {wg:.3f} s, CPU {wc:.3f} s ({torch.get_num_threads()} threads); "
              f"{lg['n_samples'] if 'n_samples' in lg else '-'} samples, path {bg['path']}, "
              f"{len(sc)} corners, SB buckets {bg['buckets']}; faces card {fg} / CPU {fc}; corner "
              f"sums apart at most {rmax:.3e} (<={SUMS_TOL:g}), median {rmed:.3e} (of each "
              f"column's largest; per column {[float(f'{c:.2e}') for c in cols]}); {conf_flips} "
              f"corners with confidence > 0 on one side only (<={CONF_FLIP_TOL * len(sc):.2f}); "
              f"{flips} sign flips with confidence on both sides, {bad} outside the limit",
              flush=True)
        if abs(fg - fc) > FACE_TOL * fc or bad or fc == 0 or rmax > SUMS_TOL \
                or conf_flips > CONF_FLIP_TOL * len(sc):
            raise AssertionError(f"fssrecon {label}: card and CPU disagree")
        worst[label] = (rmax, flips, fg, fc)
        if label == "default":
            save_mesh(mg, str(scene / "surf-sub.ply"))      # phase 21's small surface
            worst["default_card"] = (sg, fg)                # phase 24's dense reference
    return worst


# Phase 14's limits against the scene: each surface vertex's distance to
# the nearer of the scene's two planes (scene_planes) along z, over its
# distance to the nearest camera centre; the median within SURF_TOL and at
# most SURF_GROSS_TOL of the vertices more than GROSS_OFF off. The first
# card run read a median of 3.841e-4 and 3.1% more than 5% off; the limits
# are about twice that. Phase 15 reads the same of the cleaned surface.
SURF_TOL, SURF_GROSS_TOL = 1e-3, 0.06


def surface_truth_errors(scene, vertices):
    """(median, share more than GROSS_OFF off) of the vertices' relative
    distances to the scene's two planes."""
    R, s, t, planes = scene_planes(scene)
    _, centres = bundle_centres(load_mve_bundle(str(scene / "synth_0.out")))
    centres = s * centres @ R.T + t
    p = s * vertices.astype(np.float64) @ R.T + t
    off = np.min([np.abs(p[:, 0] * a + p[:, 1] * b + c - p[:, 2]) for a, b, c in planes], axis=0)
    near = np.full(len(p), np.inf)
    for c in centres:
        near = np.minimum(near, np.linalg.norm(p - c, axis=1))
    rel = off / near
    return float(np.median(rel)), float((rel > GROSS_OFF).mean())


def phase_full_fssr():
    """fssrecon with default flags on phase 12's whole point set."""
    scene = WORK / "main"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with recording(fssr_dc, "build_octree") as octrees, \
            recording(fssr_block_eval, "evaluate_positions_blocked") as evals:
        t0 = time.perf_counter()
        mesh = fssrecon.fssr_reconstruct(str(scene / "pset-L2.ply"), str(scene / "surf.ply"),
                                         verbose=False, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    st, bst = dict(fssrecon.LAST_STATS), dict(fssr_block_eval.STATS)
    octree = octrees[0][2]
    (samples, positions), _, sums = evals[0]
    scale = samples.scale.astype(np.float64)
    device_ms = bst["dispatch_ms"] + bst["sync_ms"]
    print(f"  fssr_reconstruct(device='cuda'): {wall:.3f} s; {st['n_samples']} samples, smax/smin "
          f"{scale.max() / scale.min():.3f} (median scale {np.median(scale):.6g}), evaluation path "
          f"{bst['path']}; {len(octree.leaf_level)} leaves (levels {np.unique(octree.leaf_level).tolist()}),"
          f" {st['n_voxels']} corners, {bst['rows']} eval rows, {bst['pairs']} (row, voxel, sample) "
          f"elements; SB buckets (SB: dispatches) {bst['buckets']}", flush=True)
    print(f"  time: load {st['load_ms']} ms, octree {st['octree_ms']} ms, evaluation {st['eval_ms']} "
          f"ms = block expansion (host) {bst['expand_ms']:.0f} ms + device evaluation (host tables "
          f"and launches {bst['dispatch_ms']:.0f} ms, then the wait and read back "
          f"{bst['sync_ms']:.0f} ms) + float64 sums (host) {bst['accumulate_ms']:.0f} ms + rest; "
          f"extraction {st['extract_ms']} ms; max_memory_allocated {peak} bytes", flush=True)
    sums2, pwall, busy, tops = device_profile(
        lambda: fssr_block_eval.evaluate_positions_blocked(samples, positions, device="cuda"),
        top=10)
    dev2 = fssr_block_eval.STATS["dispatch_ms"] + fssr_block_eval.STATS["sync_ms"]
    identical = np.array_equal(sums, sums2)
    print(f"  the evaluation again, under torch.profiler: {pwall:.1f} ms, of which device kernels "
          f"{busy:.1f} ms ({100 * busy / pwall:.1f}% busy over the whole evaluation, "
          f"{100 * busy / dev2:.1f}% over its device part of {dev2:.0f} ms); bit-identical to the "
          f"first: {identical}; top device ops:", flush=True)
    for name, ms, calls in tops:
        print(f"    {ms:9.2f} ms {calls:6d} calls  {name[:110]}", flush=True)
    surf = load_mesh(str(scene / "surf.ply"))
    med, gross = surface_truth_errors(scene, surf.vertices)
    print(f"  wrote surf.ply: {surf.num_vertices()} vertices, {surf.num_faces()} faces; against the "
          f"scene's planes (distance along z over the distance to the nearest camera): median "
          f"{med:.3e} (<={SURF_TOL:g}), share more than {GROSS_OFF:g} off {gross:.5f} "
          f"(<={SURF_GROSS_TOL:g})", flush=True)
    if not identical or surf.num_faces() == 0 or surf.num_faces() != mesh.num_faces() \
            or not np.isfinite(surf.vertices).all():
        raise AssertionError("fssrecon: two card evaluations differ, or the surface is empty")
    if med > SURF_TOL or gross > SURF_GROSS_TOL:
        raise AssertionError("fssrecon: the surface is off the scene's planes")
    return dict(wall=wall, stats=st, block_stats=bst, peak=peak, busy=busy, pwall=pwall,
                device_ms=device_ms)


def mesh_summary(mesh, labels):
    """(vertices, faces, component sizes, degenerate faces) of a mesh with
    its mesh_components labels: a face is degenerate where it repeats a
    vertex or has zero area."""
    sizes = np.bincount(np.unique(labels, return_inverse=True)[1]) if len(labels) else np.zeros(0)
    f, v = mesh.faces, mesh.vertices.astype(np.float64)
    area2 = np.linalg.norm(np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]), axis=1)
    repeat = (f[:, 0] == f[:, 1]) | (f[:, 1] == f[:, 2]) | (f[:, 0] == f[:, 2])
    return mesh.num_vertices(), mesh.num_faces(), sizes, int((repeat | (area2 == 0)).sum())


@contextlib.contextmanager
def python_fallbacks():
    """The port's callers with the native library unavailable (each takes
    its Python fallback)."""
    real = native.get_lib
    native.get_lib = lambda: None
    try:
        yield
    finally:
        native.get_lib = real


def timed_ms(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, 1e3 * (time.perf_counter() - t0)


def phase_meshclean():
    """meshclean with default flags on phase 14's surface, through the
    native library; its steps also through the Python fallbacks, which
    must give identical results."""
    scene = WORK / "main"
    before = load_mesh(str(scene / "surf.ply"))
    slow = load_mesh(str(scene / "surf.ply"))
    labels, comp_ms = timed_ms(mesh_components, before)
    with python_fallbacks():
        labels_py, comp_py_ms = timed_ms(mesh_components, slow)
    nv, nf, sizes, degenerate = mesh_summary(before, labels)
    collapsed, clean_ms = timed_ms(clean_mc_mesh, before)
    with python_fallbacks():
        collapsed_py, clean_py_ms = timed_ms(clean_mc_mesh, slow)
    same = (np.array_equal(labels, labels_py) and collapsed == collapsed_py
            and np.array_equal(before.vertices, slow.vertices)
            and np.array_equal(before.faces, slow.faces))
    print(f"  surf.ply: {nv} vertices, {nf} faces, {len(sizes)} components (smallest "
          f"{sizes.min() if len(sizes) else 0}, {(sizes < 1000).sum()} below 1,000 vertices), "
          f"{degenerate} degenerate faces; mesh_components native {comp_ms:.1f} ms / Python "
          f"union-find {comp_py_ms:.0f} ms, clean_mc_mesh alone native {clean_ms:.1f} ms / Python "
          f"{clean_py_ms:.0f} ms, {collapsed} collapses; native and Python outputs identical: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("meshclean: the native library and the Python fallbacks differ")
    t0 = time.perf_counter()
    meshclean.mesh_clean(str(scene / "surf.ply"), str(scene / "clean.ply"), verbose=False)
    wall = time.perf_counter() - t0
    with python_fallbacks():
        t0 = time.perf_counter()
        meshclean.mesh_clean(str(scene / "surf.ply"), str(scene / "clean-py.ply"), verbose=False)
        wall_py = time.perf_counter() - t0
    same = (scene / "clean.ply").read_bytes() == (scene / "clean-py.ply").read_bytes()
    clean = load_mesh(str(scene / "clean.ply"))
    nv, nf, sizes, degenerate = mesh_summary(clean, mesh_components(clean))
    med, gross = surface_truth_errors(scene, clean.vertices)
    print(f"  mesh_clean with the Python fallbacks: {wall_py:.3f} s; clean.ply byte-identical: "
          f"{same}", flush=True)
    if not same:
        raise AssertionError("meshclean: the native library and the Python fallbacks differ")
    print(f"  mesh_clean (default flags, native library): {wall:.3f} s; clean.ply {nv} vertices, {nf} faces, "
          f"{len(sizes)} components (smallest {sizes.min() if len(sizes) else 0}), {degenerate} "
          f"degenerate faces; against the scene's planes: median {med:.3e}, share more than "
          f"{GROSS_OFF:g} off {gross:.5f}", flush=True)
    if nf == 0 or (sizes < 1000).any() or degenerate:
        raise AssertionError("meshclean: a small component or a degenerate face remains")
    return dict(wall=wall, wall_py=wall_py, vertices=nv, faces=nf, components=len(sizes))



# ---------------------------------------------------------------------------
# Slice 6: makescene and the bundle importers, cascade hashing, several
# processes, featurerecon and the command line from a folder of photos.
# ---------------------------------------------------------------------------

# Views of phase 16's Bundler import (exported from phase 9's scene). Cut
# from 40 for time: each view's k2/k4 undistortion and PNG writes run on
# the card and on the CPU; the image size is not cut.
BUNDLER_VIEWS = 10
# Views of phase 19's featurerecon, the first of phase 9's scene. Cut
# from 40 for time (on an H100 60.1 s at 40 views, 17.2-21.6 s at 20:
# PERF.md; the pairs go with the square of the views); the image size is
# not cut. Its floor of triangulated points (6,206 were measured at 20
# views).
FEATURERECON_VIEWS = 10
FEATURERECON_MIN_POINTS = 1000
# A thumbnail pixel may round the other way, card against CPU, where its
# value lies within TIE of k + 0.5 (cuBLAS and the CPU sum the resize in
# other orders); any other difference between two scene trees fails.
TIE = 1e-3


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def compare_scene_trees(card, cpu):
    """Every file of two scene directories byte for byte; a thumbnail may
    differ by one level at a rounding tie. Returns (files, thumbnail pixels
    that differ); raises on any other difference."""
    files = tree_files(card)
    if files != tree_files(cpu):
        raise AssertionError(f"{card} and {cpu} hold different files")
    ties = 0
    for rel in files:
        if (Path(card) / rel).read_bytes() == (Path(cpu) / rel).read_bytes():
            continue
        if os.path.basename(rel) != "thumbnail.png":
            raise AssertionError(f"{rel} differs, card against CPU")
        view = Path(cpu) / os.path.dirname(rel)
        orig = next(view.glob("original.*"))
        a, b = (image_io.load_image(str(Path(d) / rel)).astype(int) for d in (card, cpu))
        bad = np.nonzero(a != b)
        value = image_tools.create_thumbnail(
            image_io.load_image(str(orig)).astype(np.float32), device="cpu")[bad]
        frac = value - np.floor(value)
        if np.abs(a - b).max() > 1 or not np.all(np.abs(frac - 0.5) < TIE):
            raise AssertionError(f"{rel}: thumbnail pixels differ away from a rounding tie")
        ties += len(bad[0])
    return len(files), ties


def export_bundler_workspace(scene, out, n_views):
    """A Noah Bundler workspace (bundle/bundle.out, list.txt, images/) of
    the first n_views views of a scene: their cameras from its synth_0.out
    and their undistorted images."""
    bundle = load_mve_bundle(str(scene / "synth_0.out"))
    (out / "bundle").mkdir(parents=True)
    (out / "images").mkdir()
    lines = ["# Bundle file v0.3"]
    feats = [f for f in bundle.features if any(r.view_id < n_views for r in f.refs)]
    lines.append(f"{n_views} {len(feats)}")
    for cam in bundle.cameras[:n_views]:
        lines += [f"{cam.flen:.9g} {cam.dist[0]:.9g} {cam.dist[1]:.9g}",
                  *(" ".join(f"{v:.9g}" for v in cam.rot.reshape(-1)[k:k + 3]) for k in (0, 3, 6)),
                  " ".join(f"{v:.9g}" for v in cam.trans)]
    for f in feats:
        refs = [r for r in f.refs if r.view_id < n_views]
        lines += [" ".join(f"{v:.9g}" for v in f.pos),
                  " ".join(str(int(c * 255.0 + 0.5)) for c in f.color),
                  f"{len(refs)} " + " ".join(f"{r.view_id} {r.feature_id} 0 0" for r in refs)]
    (out / "bundle" / "bundle.out").write_text("\n".join(lines) + "\n")
    names = []
    for i, view in enumerate(Scene(str(scene)).get_views()[:n_views]):
        name = f"view_{i:04d}.png"
        shutil.copyfile(Path(view.get_directory()) / "undistorted.png", out / "images" / name)
        names.append(f"images/{name}")
    (out / "list.txt").write_text("\n".join(names) + "\n")


def timed_import(fn, *args, **kwargs):
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(None):
        fn(*args, **kwargs)
    if kwargs.get("device") == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_makescene():
    """makescene -i, -m and a Bundler import, each on the card and on the
    CPU; the scene directories must be byte-identical (but for thumbnail
    pixels at rounding ties, counted)."""
    base = WORK / "makescene"
    shutil.rmtree(base, ignore_errors=True)
    photos = base / "photos"
    photos.mkdir(parents=True)
    t0 = time.perf_counter()
    # Phase 5's renders (synthetic.make_photo_folder's images, which take
    # about a second each to render on the host), as photos.
    for i, view in enumerate(Scene(str(WORK / "main")).get_views()):
        jpeg = i % 2 == 0
        synthetic.save_photo(view.get_image("original"),
                             str(photos / f"photo_{i:03d}.{'jpg' if jpeg else 'png'}"),
                             35.0 if jpeg else None)
    print(f"  {MAIN_VIEWS} photos of {MAIN_WIDTH}x{MAIN_HEIGHT} (JPEG with EXIF focal length "
          f"and PNG, alternately) written in {time.perf_counter() - t0:.3f} s", flush=True)
    out = {}
    max_pixels = MAIN_WIDTH * MAIN_HEIGHT // 4
    for label, run in (
            ("-i", lambda d: timed_import(makescene.import_images, str(photos),
                                          str(base / f"i_{d}"), device=d)),
            (f"-i -m {max_pixels}", lambda d: timed_import(
                makescene.import_images, str(photos), str(base / f"m_{d}"),
                max_pixels=max_pixels, device=d))):
        walls = {d: run(d) for d in ("cuda", "cpu")}
        key = "i" if label == "-i" else "m"
        n, ties = compare_scene_trees(base / f"{key}_cuda", base / f"{key}_cpu")
        out[key] = dict(card_s=walls["cuda"], cpu_s=walls["cpu"], files=n, tie_pixels=ties)
        print(f"  makescene {label}: card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s; "
              f"{n} files, byte-identical but for {ties} thumbnail pixels at rounding ties",
              flush=True)
    views = sorted(os.listdir(base / "i_cuda" / "views"))
    exif = sum((base / "i_cuda" / "views" / v / "exif.blob").is_file() for v in views)
    if len(views) != MAIN_VIEWS or exif != MAIN_VIEWS // 2:
        raise AssertionError(f"makescene -i: {len(views)} views, {exif} EXIF blobs")
    small = image_io.load_image(str(base / "m_cuda" / "views" / views[1] / "original.png"))
    if small.shape[0] * small.shape[1] > max_pixels:
        raise AssertionError(f"makescene -m: {small.shape} is above {max_pixels} pixels")

    ws = base / "bundler"
    export_bundler_workspace(WORK / "main", ws, BUNDLER_VIEWS)
    walls = {d: timed_import(makescene.import_bundle_noah_ps, str(ws), str(base / f"b_{d}"),
                             device=d) for d in ("cuda", "cpu")}
    n, ties = compare_scene_trees(base / "b_cuda", base / "b_cpu")
    out["b"] = dict(card_s=walls["cuda"], cpu_s=walls["cpu"], files=n, tie_pixels=ties)
    print(f"  makescene on a Bundler workspace of phase 9's first {BUNDLER_VIEWS} views "
          f"(k2/k4 undistortion): card {walls['cuda']:.3f} s, CPU {walls['cpu']:.3f} s; {n} "
          f"files, byte-identical but for {ties} thumbnail pixels", flush=True)
    if ties:
        raise AssertionError("a Bundler import writes no thumbnail, yet one differs")
    return out


def phase_cascade(main_run):
    """sfmrecon --cascade-hashing --skip-sfm on phase 16's 40 views on the
    card, beside phase 5's batched prebundle; then the cascade card against
    CPU on phase 4's views, on the same features."""
    scene = WORK / "makescene" / "i_cuda"
    torch.cuda.synchronize()
    top2_mod.launches = top2_mod.split_launches = 0
    t0 = time.perf_counter()
    sfmrecon.sfm_reconstruct(str(scene), skip_sfm=True, use_cascade_hashing=True, verbose=False,
                             device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, split_launches = top2_mod.launches, top2_mod.split_launches
    t = dict(sfmrecon.LAST_TIMINGS)
    if launches <= 0 or split_launches <= 0:
        raise AssertionError("the cascade-hashing path launched a top2 kernel no time")
    rows = {}
    for name, path, run in (("cascade (phase 16's scene)", scene, dict(wall=wall, timings=t)),
                            ("batched (phase 5)", WORK / "main", main_run)):
        vps, matching = load_scene_result(str(path))
        counts = np.array([len(m.matches) for m in matching])
        views = {v for m in matching for v in (m.view_1_id, m.view_2_id)}
        rows[name] = dict(wall_s=run["wall"], features_ms=run["timings"]["features_ms"],
                          matching_ms=run["timings"]["matching_ms"], pairs=len(matching),
                          matches_mean=float(counts.mean()), matches_median=float(np.median(counts)),
                          matches_min=int(counts.min()), views=len(views))
        print(f"  {name}: {run['wall']:.3f} s (features {run['timings']['features_ms']} ms, "
              f"matching {run['timings']['matching_ms']} ms), {len(matching)} of "
              f"{MAIN_VIEWS * (MAIN_VIEWS - 1) // 2} pairs kept, "
              f"matches per pair mean {counts.mean():.1f}, median {np.median(counts):.0f}, min "
              f"{counts.min()}; {len(views)} views in a pair", flush=True)
        if len(views) != MAIN_VIEWS or counts.min() < 12:
            raise AssertionError(f"{name}: {len(views)} views in a pair, fewest matches "
                                 f"{counts.min()}")
    print(f"  top2.launches {launches}, top2.split_launches {split_launches} (low-res "
          f"prefilter and SURF blocks, both directions)", flush=True)

    tex_far = synthetic.make_texture(seed=7, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=107, smooth_sigma=3.0)
    imgs = [synthetic.render_two_plane_view(tex_far, tex_near, cam, 480, 360)
            for cam in synthetic.make_cameras(4, spread=0.55, seed=7)]
    vps = [Viewport() for _ in imgs]
    Features(device="cuda").compute_batched(imgs, vps)
    hashers = {}
    for dev in ("cuda", "cpu"):
        hashers[dev] = CascadeHashing(device=dev)
        hashers[dev].init([vp.descriptors for vp in vps])
    flipped = bits = 0
    for i, vp in enumerate(vps):
        x = hashers["cuda"].codes(i) ^ hashers["cpu"].codes(i)
        rows_, lanes, pos = np.nonzero((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1)
        z = (vp.descriptors.astype(np.float64) - hashers["cpu"]._mean) @ \
            hashers["cpu"].proj.astype(np.float64)
        if len(rows_) and np.abs(z[rows_, lanes * 32 + pos]).max() >= 1e-5:
            raise AssertionError("a hash bit flipped, card against CPU, away from zero")
        flipped += len(rows_)
        bits += x.size * 32
    found = {}
    for dev in ("cuda", "cpu"):
        found[dev] = {(m.view_1_id, m.view_2_id): m.matches for m in Matching(
            MatchingOptions(use_cascade_hashing=True), device=dev).compute(vps, seed=0)}
    print(f"  cascade card against CPU on phase 4's views: {flipped} of {bits} hash bits "
          f"flipped (each within 1e-5 of zero); pairs cuda {sorted(found['cuda'])}, cpu "
          f"{sorted(found['cpu'])}", flush=True)
    if set(found["cuda"]) != set(found["cpu"]):
        raise AssertionError("cascade matcher: connected pairs differ, card against CPU")
    worst = 1.0
    for key, c in sorted(found["cpu"].items()):
        want, got = set(map(tuple, c)), set(map(tuple, found["cuda"][key]))
        rate = len(got & want) / max(len(want), 1)
        worst = min(worst, rate)
        print(f"  cascade pair {key}: cpu {len(want)} / cuda {len(got)} matches, identical "
              f"{rate:.4f} (>=0.99, tests/test_torch_cascade.py's tolerance)", flush=True)
        if rate < 0.99 or len(got) > 1.01 * len(want) + 1:
            raise AssertionError(f"cascade pair {key}: {rate:.4f} of the matches identical")
    return dict(launches=launches, split_launches=split_launches, rows=rows,
                flipped_bits=flipped, bits=bits, worst_pair_identical=worst)


def run_app(app, *argv, device=None, timeout=900):
    """python -m mve_tpu_torch.apps.<app> argv... from the checkout's root;
    raises unless it exits 0. Returns its wall time."""
    cmd = [sys.executable, "-m", f"mve_tpu_torch.apps.{app}", *map(str, argv)]
    if device:
        cmd += ["--device", device]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return time.perf_counter() - t0


def phase_two_processes():
    """sfmrecon --skip-sfm --num-processes 2: two processes on the one
    card, then two ranks on the CPU, on phase 4's scene; the merged
    prebundles card against CPU with phase 4's limits."""
    base = WORK / "two_processes"
    shutil.rmtree(base, ignore_errors=True)
    synthetic.make_two_plane_scene(str(base / "cuda"), n_views=4, width=480, height=360,
                                   seed=7, with_cameras=False)
    shutil.copytree(base / "cuda", base / "cpu")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mve_tpu_torch.apps.sfmrecon", "--skip-sfm", "--num-processes",
         "2", "--process-id", str(k), str(base / "cuda")], cwd=ROOT, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True) for k in range(2)]
    try:
        errs = [p.communicate(timeout=600)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    card_s = time.perf_counter() - t0
    for k, (p, err) in enumerate(zip(procs, errs)):
        if p.returncode != 0:
            raise AssertionError(f"sfmrecon process {k} exited {p.returncode}:\n{err[-3000:]}")
    t0 = time.perf_counter()
    ranks = [threading.Thread(target=sfmrecon.sfm_reconstruct, args=(str(base / "cpu"),),
                              kwargs=dict(skip_sfm=True, verbose=False, process_id=k,
                                          num_processes=2, device="cpu")) for k in (1, 0)]
    for r in ranks:
        r.start()
    for r in ranks:
        r.join(timeout=600)
    cpu_s = time.perf_counter() - t0
    left = [f for d in ("cuda", "cpu") for f in os.listdir(base / d) if ".part" in f]
    print(f"  two processes on the card {card_s:.3f} s (with their start-up), two CPU ranks "
          f"{cpu_s:.3f} s; part files left {left}", flush=True)
    if left or any(r.is_alive() for r in ranks):
        raise AssertionError("a rank did not finish, or its part files were not merged")
    compare_prebundles(base / "cuda", base / "cpu", 480)
    shutil.rmtree(base, ignore_errors=True)
    return dict(card_s=card_s, cpu_s=cpu_s)


class _Top2Recorder:
    """Wraps sfm.matching.top2 (the per-pair matcher's kernel wrapper):
    counts every call and keeps the inputs of the first `keep`."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls, self.n = fn, keep, [], 0

    def __call__(self, q, r, n_refs, bf16):
        self.n += 1
        if len(self.calls) < self.keep:
            self.calls.append((q, r, n_refs, bf16))
        return self.fn(q, r, n_refs, bf16)


def phase_featurerecon():
    """featurerecon on the first FEATURERECON_VIEWS of phase 9's views of
    1600x1200 and their cameras (a copy of each view's meta.ini and
    undistorted image)."""
    src, scene = WORK / "main", WORK / "featurerecon"
    shutil.rmtree(scene, ignore_errors=True)
    for view in sorted(os.listdir(src / "views"))[:FEATURERECON_VIEWS]:
        (scene / "views" / view).mkdir(parents=True)
        for name in ("meta.ini", "undistorted.png"):
            shutil.copyfile(src / "views" / view / name, scene / "views" / view / name)
    recorder = _Top2Recorder(sfm_matching.top2, keep=12)
    sfm_matching.top2 = recorder
    torch.cuda.synchronize()
    top2_mod.launches = top2_mod.split_launches = 0
    t0 = time.perf_counter()
    try:
        featurerecon.feature_reconstruct(str(scene), verbose=False, device="cuda")
        torch.cuda.synchronize()
    finally:
        sfm_matching.top2 = recorder.fn
    wall = time.perf_counter() - t0
    launches, split_launches = top2_mod.launches, top2_mod.split_launches
    if launches <= 0 or split_launches <= 0:
        raise AssertionError("featurerecon launched a top2 kernel no time")
    bundle = load_mve_bundle(str(scene / "synth_0.out"))
    truth = load_mve_bundle(str(src / "synth_0.out"))
    for c, want in zip(bundle.cameras, truth.cameras):
        if c.flen != want.flen or not np.array_equal(c.rot, want.rot):
            raise AssertionError("featurerecon moved a camera")
    pts = bundle.feature_positions()
    med, gross = surface_truth_errors(src, pts)
    print(f"  feature_reconstruct(device='cuda'): {wall:.3f} s, {len(pts)} points "
          f"({truth.get_num_features()} tracks in phase 9's bundle); against the scene's "
          f"planes: median {med:.3e} (<={TRUTH_TOL}), share more than {GROSS_OFF:g} off "
          f"{gross:.5f}", flush=True)
    print(f"  per-pair top2 calls {recorder.n}: top2.launches {launches}, "
          f"top2.split_launches {split_launches}", flush=True)
    if len(pts) < FEATURERECON_MIN_POINTS or not np.isfinite(pts).all() or med > TRUTH_TOL:
        raise AssertionError("featurerecon: too few points, or points off the scene's planes")
    err = 0.0
    for q, r, n_refs, bf16 in recorder.calls:
        err = max(err, compare(f"per-pair {q.shape[0]}x{r.shape[0]}x{q.shape[1]}",
                               top2_mod.top2(q, r, n_refs, bf16),
                               descriptor_top2(q, r, n_refs=n_refs, use_bf16=bf16), bf16))
    shutil.rmtree(scene, ignore_errors=True)
    return dict(wall=wall, points=len(pts), median=med, gross=gross, launches=launches,
                split_launches=split_launches, calls=recorder.n, max_abs_err=err)


def phase_cli():
    """The canonical pipeline from a folder of photos, each step as
    `python -m mve_tpu_torch.apps.<app>` on the card; then the host apps on
    its outputs."""
    base = WORK / "cli"
    shutil.rmtree(base, ignore_errors=True)
    photos, scene = base / "photos", base / "scene"
    synthetic.make_photo_folder(str(photos), n_views=4, width=480, height=360, seed=7)
    steps = [("makescene", "-i", photos, scene),
             ("sfmrecon", scene),
             ("dmrecon", "-s1", "--local-neighbors", "3", scene),
             ("scene2pset", "-F1", scene, base / "pset.ply"),
             ("fssrecon", base / "pset.ply", base / "surf.ply")]
    walls = {}
    for app, *argv in steps:
        walls[app] = run_app(app, *argv, device="cuda")
    walls["meshclean"] = run_app("meshclean", base / "surf.ply", base / "clean.ply")
    clean = load_mesh(str(base / "clean.ply"))
    print("  " + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items())
          + f": clean.ply {clean.num_vertices()} vertices, {clean.num_faces()} faces", flush=True)
    if clean.num_faces() == 0 or not (scene / "synth_0.out").is_file():
        raise AssertionError("the command-line pipeline made no surface")
    host = [("prebundle", scene), ("bundle2pset", scene, base / "points.ply"),
            ("mesh2pset", base / "clean.ply", base / "clean-pset.ply"),
            ("meshconvert", base / "clean.ply", base / "clean.off"),
            ("meshalign", base / "clean.ply", base / "surf.ply", base / "merged.ply"),
            ("sceneupgrade", scene), ("sceneinspect", "info", scene),
            ("sceneinspect", "report", scene, base / "report.html", "--device", "cuda"),
            ("meshview", base / "clean.ply", "--scene", scene, "--turntable", "2", "-o",
             base / "view.png", "--device", "cuda")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", f"mve_tpu_torch.apps.{app}", *map(str, a)],
                              cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                              text=True) for app, *a in host]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for (app, *_), p, err in zip(host, procs, errs):
        if p.returncode != 0:
            raise AssertionError(f"{app} exited {p.returncode}:\n{err[-3000:]}")
    walls["host apps"] = time.perf_counter() - t0
    outs = ("points.ply", "clean-pset.ply", "clean.off", "merged.ply", "report.html",
            "view_0000.png", "view_0001.png")
    missing = [o for o in outs if not (base / o).is_file()]
    names = [f"{app} {a[0]}" if app == "sceneinspect" else app for app, *a in host]
    print(f"  {', '.join(names)} (the report and meshview on the card): "
          f"side by side in {walls['host apps']:.1f} s; missing outputs {missing}", flush=True)
    if missing:
        raise AssertionError(f"host apps wrote no {missing}")
    shutil.rmtree(base, ignore_errors=True)
    return walls

# ---------------------------------------------------------------------------
# Slice 7: meshview, the pair-list FSSR with the native library, SIFT's
# upsampled first octave, tracing.
# ---------------------------------------------------------------------------

# meshview's default frame, at which users run it.
VIEW_W, VIEW_H = 1024, 768
# Card against CPU on phase 13's surface: the limits of
# tests/test_torch_render.py (at most RENDER_FAULT_SHARE of the covered
# pixels differ in coverage or owner; elsewhere depth within
# RENDER_DEPTH_TOL and colour within RENDER_RGB_TOL).
RENDER_FAULT_SHARE, RENDER_DEPTH_TOL, RENDER_RGB_TOL = 0.01, 1e-6, 1e-5


class _RenderRecorder:
    """Wraps meshview.render_mesh: keeps each frame's (view, proj, rgb,
    depth) and its synced wall time and peak device memory; with
    `profile`, runs each call under device_profile and keeps the kernel
    time too."""

    def __init__(self, fn, profile):
        self.fn, self.profile, self.frames = fn, profile, []

    def __call__(self, mesh, view, proj, *args, **kwargs):
        dev = torch.device(kwargs.get("device", "cuda"))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        if self.profile:
            (rgb, depth), wall, busy, _ = device_profile(
                lambda: self.fn(mesh, view, proj, *args, **kwargs))
        else:
            t0 = time.perf_counter()
            rgb, depth = self.fn(mesh, view, proj, *args, **kwargs)
            wall, busy = 1e3 * (time.perf_counter() - t0), None
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        self.frames.append(dict(view=view.copy(), proj=proj.copy(), rgb=rgb, depth=depth,
                                wall=wall, busy=busy, peak=peak))
        return rgb, depth


def run_meshview(argv, profile=False):
    """meshview.main(argv) in this process with its render_mesh recorded;
    returns (frames, wall s of each frame from the app's start or the
    previous frame's PNG to this frame's PNG)."""
    rec = _RenderRecorder(meshview.render_mesh, profile)
    real_save = meshview.save_image
    stamps = []

    def save(img, path):
        real_save(img, path)
        stamps.append(time.perf_counter())

    meshview.render_mesh, meshview.save_image = rec, save
    try:
        t0 = time.perf_counter()
        if meshview.main([str(a) for a in argv]) != 0:
            raise AssertionError(f"meshview {argv} failed")
    finally:
        meshview.render_mesh, meshview.save_image = rec.fn, real_save
    return rec.frames, np.diff([t0] + stamps)


def unproject(frame):
    """World points of the covered pixels of a frame (pixel centres at
    their NDC depth through the inverse of proj @ view)."""
    depth = frame["depth"]
    h, w = depth.shape
    ys, xs = np.nonzero(np.isfinite(depth))
    ndc = np.stack([(xs + 0.5) / w * 2 - 1, 1 - (ys + 0.5) / h * 2,
                    depth[ys, xs].astype(np.float64), np.ones(len(xs))], 1)
    hom = ndc @ np.linalg.inv(frame["proj"].astype(np.float64)
                              @ frame["view"].astype(np.float64)).T
    return hom[:, :3] / hom[:, 3:]


def compare_frames(card, cpu):
    """(pixels at fault, covered pixels, largest depth and colour
    difference elsewhere) of two frames of the same mesh and camera."""
    gc, cc = np.isfinite(card["depth"]), np.isfinite(cpu["depth"])
    both = gc & cc
    dd = np.zeros(card["depth"].shape)
    dd[both] = np.abs(card["depth"][both] - cpu["depth"][both])
    dc = np.abs(card["rgb"] - cpu["rgb"]).max(-1)
    owner = both & ((dd > 1e-5) | (dc > 1e-4))
    fault = (gc != cc) | owner
    return (int(fault.sum()), int((gc | cc).sum()), float(dd[both & ~owner].max(initial=0)),
            float(dc[~fault].max(initial=0)))


def phase_meshview():
    """meshview at its default 1024x768 on phase 15's cleaned surface with
    --scene on phase 9's scene (frusta of its 40 views and its SfM
    points): --view-id 0, then --turntable 4, each frame's wall time,
    rasterizer time, busy share and peak memory; view 0's covered pixels
    against the scene's planes; then card against CPU on phase 13's
    surface at 256x192."""
    scene, out = WORK / "main", WORK / "meshview"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    clean = load_mesh(str(scene / "clean.ply"))
    bundle = load_mve_bundle(str(scene / "synth_0.out"))
    print(f"  clean.ply {clean.num_faces()} faces; scene {len(bundle.cameras)} cameras, "
          f"{bundle.get_num_features()} SfM points; chunk on the card "
          f"{rasterizer._chunk_size(VIEW_W * VIEW_H)} triangles",
          flush=True)
    common = [scene / "clean.ply", "--scene", scene, "--device", "cuda"]
    runs = {}
    # Each run twice, without and under the profiler (the profiler's own
    # work triples a frame's wall time); the two renders must be
    # bit-identical.
    for label, argv in (("view-id 0", ["--view-id", "0", "-o", out / "view0.png"]),
                        ("turntable 4", ["--turntable", "4", "-o", out / "turn.png"])):
        frames, walls = run_meshview(common + argv)
        prof, _ = run_meshview(common + argv, profile=True)
        for i, (f, pf, wall) in enumerate(zip(frames, prof, walls)):
            print(f"  {label} frame {i}: wall {1e3 * wall:.1f} ms (render_mesh {f['wall']:.1f} ms); "
                  f"under the profiler render_mesh {pf['wall']:.1f} ms, device kernels "
                  f"{pf['busy']:.1f} ms ({100 * pf['busy'] / pf['wall']:.1f}% busy); "
                  f"max_memory_allocated {f['peak']} bytes; {int(np.isfinite(f['depth']).sum())} "
                  f"covered pixels", flush=True)
            if not np.array_equal(f["depth"], pf["depth"]) or not np.array_equal(f["rgb"], pf["rgb"]):
                raise AssertionError(f"meshview {label}: two renders of frame {i} differ")
        runs[label] = (frames, walls, prof)
    pngs = sorted(p.name for p in out.iterdir())
    frame0 = runs["view-id 0"][0][0]
    pts = unproject(frame0)
    med, gross = surface_truth_errors(scene, pts)
    print(f"  PNGs {pngs}; view 0: {len(pts)} covered pixels unprojected, against the scene's "
          f"planes: median {med:.3e} (<={SURF_TOL:g}), share more than {GROSS_OFF:g} off "
          f"{gross:.5f} (<={SURF_GROSS_TOL:g})", flush=True)
    if len(pngs) != 5 or len(pts) < 0.2 * VIEW_W * VIEW_H or med > SURF_TOL \
            or gross > SURF_GROSS_TOL:
        raise AssertionError("meshview: frames missing, or view 0 off the scene's planes")

    small = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        frames, _ = run_meshview([scene / "surf-sub.ply", "--scene", scene, "--view-id", "0",
                                  "--width", 256, "--height", 192, "-o", out / f"sub-{dev}.png",
                                  "--device", dev])
        small[dev] = (frames[0], time.perf_counter() - t0)
    fault, covered, dmax, cmax = compare_frames(small["cuda"][0], small["cpu"][0])
    sub_faces = load_mesh(str(scene / "surf-sub.ply")).num_faces()
    print(f"  phase 13's surface ({sub_faces} faces) at 256x192, view 0: card "
          f"{small['cuda'][1]:.3f} s, CPU {small['cpu'][1]:.3f} s; {fault} of {covered} covered "
          f"pixels at fault (<={RENDER_FAULT_SHARE * covered:.0f}); elsewhere depth apart at most "
          f"{dmax:.3e} (<={RENDER_DEPTH_TOL:g}), colour {cmax:.3e} (<={RENDER_RGB_TOL:g})",
          flush=True)
    if covered == 0 or fault > RENDER_FAULT_SHARE * covered or dmax > RENDER_DEPTH_TOL \
            or cmax > RENDER_RGB_TOL:
        raise AssertionError("meshview: card and CPU disagree")
    shutil.rmtree(out, ignore_errors=True)
    return runs


@contextlib.contextmanager
def environ(**values):
    """os.environ with `values` set (None: unset) for the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def pair_list_sums(samples, positions, dev):
    """((V, 10) corner sums, iso_octree.STATS, wall s) of the pair-list
    evaluation of samples at positions on dev."""
    with environ(MVE_TPU_FSSR_PAIRWISE="1"), \
            recording(fssr_iso_octree, "_normalize_sums") as sums:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fssr_iso_octree.evaluate_at_positions(samples, positions, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return sums[0][0][0], dict(fssr_iso_octree.STATS), wall


# Phase 24 holds the pair list card against CPU on every PAIR_CPU_EVERY-th
# corner: a corner's sums depend on its own pairs only, and the CPU takes
# 24-35 s for all 523,983.
PAIR_CPU_EVERY = 8
# Phase 24 holds the pair list against the dense path with phase 13's
# limits at all but at most PAIR_RIM_SHARE of the corners, and there
# within PAIR_RIM_TOL: where a sample lies within a float32 rounding of
# a corner's influence radius, the pair list (float64) and the dense
# path (float32) can decide it apart and move the scale filter, and
# mve_tpu's own two evaluators differ there alike (tests/test_torch_fssr.py::
# test_pairwise_and_dense_differ_alike_at_rim_decisions). On phase 13's
# point set 35 of 523,983 corners have such a decision, and there the
# sums were at most 4.816e-5 of a column's largest apart on the card
# (PERF.md, section 6).
PAIR_RIM_SHARE, PAIR_RIM_TOL = 1e-4, 1e-4


def phase_pairwise_fssr(dense_card_sums, dense_card_faces):
    """fssrecon with MVE_TPU_FSSR_PAIRWISE=1 on phase 13's point set: the
    native influence pairs, then the pair list on the device. The
    evaluation again on the card (bit-identical); card against CPU on
    every PAIR_CPU_EVERY-th corner with phase 13's limits; the card
    against phase 13's dense card run with phase 13's limits at all but
    PAIR_RIM_SHARE of the corners, and there within PAIR_RIM_TOL."""
    path = WORK / "main" / "pset-sub.ply"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with environ(MVE_TPU_FSSR_PAIRWISE="1"), \
            recording(fssr_iso_octree, "evaluate_at_positions") as evals:
        mg, sg, wg, _, _ = corner_sums_run(path, "cuda")
    peak = torch.cuda.max_memory_allocated()
    stg = dict(fssr_iso_octree.STATS)
    samples, positions = evals[0][0][:2]
    positions = np.asarray(positions, np.float64)
    sg2, stg2, wg2 = pair_list_sums(samples, positions, "cuda")
    identical = np.array_equal(sg, sg2)
    sub = positions[::PAIR_CPU_EVERY]
    sgs, stgs, wgs = pair_list_sums(samples, sub, "cuda")
    scs, stcs, wcs = pair_list_sums(samples, sub, "cpu")
    print(f"  {stg['pairs']} influence pairs ({stg['source']} list) for {len(sg)} corners: "
          f"pairing {stg['pairs_ms']:.0f} ms on the host, device evaluation {stg['device_ms']:.0f} "
          f"ms; fssr_reconstruct {wg:.3f} s, max_memory_allocated {peak} bytes; the evaluation "
          f"again {wg2:.3f} s (pairing {stg2['pairs_ms']:.0f} ms, device {stg2['device_ms']:.0f} "
          f"ms), bit-identical: {identical}; every {PAIR_CPU_EVERY}th corner ({len(sub)}, "
          f"{stgs['pairs']} pairs): card {wgs:.3f} s (device {stgs['device_ms']:.0f} ms), CPU "
          f"{wcs:.3f} s (device {stcs['device_ms']:.0f} ms, {torch.get_num_threads()} threads)",
          flush=True)
    if stg["source"] != "native" or not identical:
        raise AssertionError("pair-list FSSR: no native pairs, or two card runs differ")
    beyond = {}
    for label, got, other, share in (
            (f"card against CPU, every {PAIR_CPU_EVERY}th corner", sgs, scs, 0.0),
            ("pair list against the dense path, both on the card", sg, dense_card_sums,
             PAIR_RIM_SHARE)):
        if other.shape != got.shape:
            raise AssertionError(f"pair-list FSSR {label}: {len(got)} corners against {len(other)}")
        cols, rmed, flips, bad, conf_flips = compare_corner_sums(got, other)
        scale = np.abs(other).max(axis=0)
        corner = (np.abs(got - other) / np.where(scale > 0, scale, 1.0)).max(axis=1)
        rmax, over = float(cols.max()), int((corner > SUMS_TOL).sum())
        limit = PAIR_RIM_TOL if share else SUMS_TOL
        faces = f"; faces {mg.num_faces()} / {dense_card_faces}" if share else ""
        print(f"  {label}: corner sums apart at most {rmax:.3e} (<={limit:g}), median {rmed:.3e}; "
              f"{over} corners beyond {SUMS_TOL:g} (<={share * len(got):.2f}); {conf_flips} corners "
              f"with confidence > 0 on one side only (<={CONF_FLIP_TOL * len(got):.2f}); {flips} "
              f"sign flips, {bad} outside the limit{faces}", flush=True)
        if rmax > limit or over > share * len(got) or bad \
                or conf_flips > CONF_FLIP_TOL * len(got):
            raise AssertionError(f"pair-list FSSR {label}: disagree")
        beyond[label] = over
    if abs(mg.num_faces() - dense_card_faces) > FACE_TOL * dense_card_faces:
        raise AssertionError("pair-list FSSR: face counts differ from the dense path's")
    return dict(pairs=stg["pairs"], pairs_ms=stg["pairs_ms"], device_ms=stg["device_ms"],
                wall=wg, peak=peak, beyond=beyond)


# SIFT's upsampled first octave: views of the main scene (their octave -1
# images are 3200x2400; they are smooth at pixel scale, and octave -1
# finds next to nothing in them), one 1600x1200 view of the two planes
# with a fine texture, in which it does, and the card against the CPU on
# one 480x360 view with tests/test_torch_features.py's keypoint agreement.
SIFT_VIEWS = 4
# The fine texture: make_texture(size, smooth_sigma) of both planes.
SIFT_FINE_TEXTURE = (2048, 1.5)


def sift_agreement(ref, got):
    """(recall, median and 99th percentile of the descriptor differences)
    of test_torch_features._pair_up: each keypoint of ref has a partner in
    got within 0.5 px, of the nearest orientation."""
    pr, pg = np.stack([ref.x, ref.y], 1), np.stack([got.x, got.y], 1)
    recall, diffs = 0, []
    for i in range(len(pr)):
        d = np.linalg.norm(pg - pr[i], axis=1)
        near = np.nonzero(d < 0.5)[0]
        if len(near):
            dori = np.abs(np.angle(np.exp(1j * (ref.orientation[i] - got.orientation[near]))))
            j = near[np.argmin(dori)]
            recall += 1
            diffs.append(np.linalg.norm(ref.descriptors[i] - got.descriptors[j]))
    diffs = np.asarray(diffs) if diffs else np.ones(1)
    return recall / max(len(pr), 1), float(np.median(diffs)), float(np.percentile(diffs, 99))


def octave_minus_one(res):
    """The keypoints of a SiftResult at scale < 1.6 (octave -1's), as the
    fields sift_agreement reads."""
    keep = res.scale < 1.6
    return types.SimpleNamespace(x=res.x[keep], y=res.y[keep], orientation=res.orientation[keep],
                                 descriptors=res.descriptors[keep])


def phase_sift_upsampled():
    """SIFT with min_octave=-1 against min_octave=0 on SIFT_VIEWS views of
    1600x1200 and a finely textured view of that size, and card against
    CPU on a 480x360 view, where octave -1's keypoints must pair up too."""
    scene = Scene()
    scene.load_scene(str(WORK / "main"))
    cam = synthetic.make_cameras(2, spread=0.55, seed=0)[1]
    size, sigma = SIFT_FINE_TEXTURE
    fine = synthetic.render_two_plane_view(
        synthetic.make_texture(size=size, seed=0, smooth_sigma=sigma),
        synthetic.make_texture(size=size, seed=100, smooth_sigma=sigma), cam, MAIN_WIDTH,
        MAIN_HEIGHT)
    rows = []
    for vid in [*range(SIFT_VIEWS), "fine"]:
        img = fine if vid == "fine" else scene.get_view_by_id(vid).get_image("original")
        counts = {}
        for mo in (-1, 0):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = sift.detect_and_describe(img, sift.SiftOptions(min_octave=mo), device="cuda")
            torch.cuda.synchronize()
            counts[mo] = (len(res), time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
                          int((res.scale < 1.6).sum()),
                          bool(np.isfinite(res.descriptors).all() and np.isfinite(res.x).all()))
        (n1, t1, m1, fine1, ok1), (n0, t0_, m0, _, ok0) = counts[-1], counts[0]
        name = (f"the fine texture {size}/{sigma:g}" if vid == "fine" else f"view {vid}")
        print(f"  {name} ({img.shape[1]}x{img.shape[0]}): min_octave -1 {n1} keypoints "
              f"({fine1} at scale < 1.6, octave -1's), {t1:.3f} s, max_memory_allocated {m1} "
              f"bytes; min_octave 0 {n0} keypoints, {t0_:.3f} s, {m0} bytes", flush=True)
        # The per-image path keeps every localised keypoint of octaves 0 and
        # up, the batched path at most cap/2 of them: -1 finds no fewer. In
        # the fine texture octave -1 must find keypoints of its own.
        if not (ok1 and ok0) or n1 < n0 or (vid == "fine" and fine1 < 1000):
            raise AssertionError("SIFT min_octave=-1: fewer keypoints, none of octave -1 in the "
                                 "fine texture, or non-finite output")
        rows.append(counts)
    tex_far = synthetic.make_texture(seed=0, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=100, smooth_sigma=3.0)
    view = synthetic.render_two_plane_view(tex_far, tex_near, cam, 480, 360)
    res = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[dev] = sift.detect_and_describe(view, sift.SiftOptions(min_octave=-1), device=dev)
        res[dev + "_s"] = time.perf_counter() - t0
    recall, med, p99 = sift_agreement(res["cpu"], res["cuda"])
    back, _, _ = sift_agreement(res["cuda"], res["cpu"])
    # Octave -1's keypoints (scale < 1.6) alone, paired the same way.
    fine = {dev: octave_minus_one(res[dev]) for dev in ("cuda", "cpu")}
    f_recall, f_med, f_p99 = sift_agreement(fine["cpu"], fine["cuda"])
    f_back, _, _ = sift_agreement(fine["cuda"], fine["cpu"])
    print(f"  480x360, min_octave -1: card {len(res['cuda'])} keypoints in {res['cuda_s']:.3f} s, "
          f"CPU {len(res['cpu'])} in {res['cpu_s']:.3f} s; recall {recall:.4f} / {back:.4f} "
          f"(>=0.99), descriptor differences median {med:.3e} (<=1e-3), 99th percentile "
          f"{p99:.3e} (<=0.05); octave -1's alone: card {len(fine['cuda'].x)}, CPU "
          f"{len(fine['cpu'].x)} (>=100), recall {f_recall:.4f} / {f_back:.4f} (>=0.99), median "
          f"{f_med:.3e}, 99th percentile {f_p99:.3e}", flush=True)
    if recall < 0.99 or back < 0.99 or med > 1e-3 or p99 > 0.05 or len(res["cpu"]) < 100:
        raise AssertionError("SIFT min_octave=-1: card and CPU disagree")
    if min(len(fine["cuda"].x), len(fine["cpu"].x)) < 100 or f_recall < 0.99 or f_back < 0.99 \
            or f_med > 1e-3 or f_p99 > 0.05:
        raise AssertionError("SIFT min_octave=-1: octave -1's keypoints missing, or card and CPU "
                             "disagree on them")
    return rows


FSSR_SPANS = ("fssr.voxel_set", "fssr.block_eval", "fssr.influence_pairs", "fssr.device_eval")
# Phase 24 traces a tenth of phase 13's points: the spans, not the size,
# are what it checks (IsoOctree's uniform grid is far larger than the
# octree's corners at the same density).
TRACE_EVERY = 10


def phase_tracing():
    """IsoOctree.compute_voxels on every TRACE_EVERY-th point of phase 12's
    point set on the card, with the pair list and with the dense path,
    under MVE_TPU_TRACE_DIR: a Chrome trace under <dir>/<span>/ for each
    of the four FSSR spans, each naming its span; then once without the
    variable, which writes nothing."""
    trace_dir = WORK / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    samples = load_samples_from_ply(str(WORK / "main" / "pset-sub.ply"))
    samples = samples.subset(np.arange(0, len(samples), TRACE_EVERY))
    t0 = time.perf_counter()
    with environ(MVE_TPU_TRACE_DIR=str(trace_dir)):
        for pairwise in ("1", "0"):
            with environ(MVE_TPU_FSSR_PAIRWISE=pairwise):
                fssr_iso_octree.IsoOctree(device="cuda").compute_voxels(samples)
    traced_s = time.perf_counter() - t0
    found = {}
    for span in FSSR_SPANS:
        files = sorted((trace_dir / span).glob("*.json")) if (trace_dir / span).is_dir() else []
        names = set()
        for f in files:
            names |= {e.get("name") for e in json.loads(f.read_text())["traceEvents"]}
        kernels = sum(1 for f in files for e in json.loads(f.read_text())["traceEvents"]
                      if e.get("cat") == "kernel")
        found[span] = (len(files), span in names, kernels, sum(f.stat().st_size for f in files))
    before = sorted(p.relative_to(trace_dir) for p in trace_dir.rglob("*"))
    with environ(MVE_TPU_TRACE_DIR=None, MVE_TPU_FSSR_PAIRWISE="1"):
        t0 = time.perf_counter()
        fssr_iso_octree.IsoOctree(device="cuda").compute_voxels(samples)
        plain_s = time.perf_counter() - t0
    after = sorted(p.relative_to(trace_dir) for p in trace_dir.rglob("*"))
    print(f"  {len(samples)} samples: traced (pair list, then dense) {traced_s:.3f} s; "
          + "; ".join(f"{k}: {n} file(s), names the span {named}, {kern} kernel events, "
                      f"{size} bytes" for k, (n, named, kern, size) in found.items())
          + f"; untraced pair-list run {plain_s:.3f} s, files written without the variable: "
          f"{len(after) - len(before)}", flush=True)
    # compute_voxels runs twice (pair list, dense): two voxel-set traces.
    want = {span: 2 if span == "fssr.voxel_set" else 1 for span in FSSR_SPANS}
    if any(n != want[k] or not named for k, (n, named, _, _) in found.items()) or after != before:
        raise AssertionError("tracing: a span's trace is missing or unnamed, or a file was "
                             "written without MVE_TPU_TRACE_DIR")
    shutil.rmtree(trace_dir, ignore_errors=True)
    return found


# ---------------------------------------------------------------------------
# Slice 8: several devices (a mesh of shards on the one card, a process
# group of processes sharing it) and the last library modules.
# ---------------------------------------------------------------------------

# Phase 25: bundle adjustment at the size of the Dubrovnik problem of
# "Bundle Adjustment in the Large" (Agarwal et al., 2010: 356 cameras,
# 226,730 points, 1,255,268 observations), built by synthetic_ba_problem
# with six observations a point (1,360,380). The LM loop and each PCG
# solve are capped for time (BAL_LM_STEPS, BAL_CG_ITERS); sizes are not
# cut. Run with no mesh and over BAL_SHARDS shards on cuda:0, in float32
# and float64.
BAL_CAMS, BAL_POINTS, BAL_OBS_PER_POINT = 356, 226_730, 6
BAL_LM_STEPS, BAL_CG_ITERS = 5, 64
BAL_SHARDS = (1, 2, 4)
# Limits of the sharded runs against no mesh: tests/test_torch_parallel.py's
# (final MSE relative, parameters absolute). float64: its limits for the
# port's shards against the port's own unsharded loop; float32: those of
# the port against mve_tpu, BA_TOLS's parameters (the sums add in another
# order; an end camera's k1 is weakly held).
SHARD_TOLS = {
    np.float32: dict(mse=1e-4, **{k: v for k, v in BA_TOLS.items() if k != "mse"}),
    np.float64: dict(mse=1e-10, focal=1e-8, distortion=1e-8, translation=1e-8, rotation=1e-8,
                     points=1e-8)}


def same_ba(a, b):
    """Whether two optimize_arrays results have the same bits and status."""
    keys = ("initial_mse", "final_mse", "num_lm_iterations", "num_lm_successful_iterations",
            "num_cg_iterations")
    return all(np.array_equal(x, y) for x, y in zip(a[:4], b[:4])) and \
        all(getattr(a[4], k) == getattr(b[4], k) for k in keys)


@contextlib.contextmanager
def cg_reductions(mesh):
    """[reductions, Schur products] made inside PCG while the block runs:
    each product of the reduced camera system reads the mesh's reduction
    count before and after (ba_core._pcg's S_mul, wrapped)."""
    tally = [0, 0]
    real = ba_core._pcg

    def pcg(S_mul, precond, rhs, max_it):
        def counted(d):
            r0 = mesh.reductions
            out = S_mul(d)
            tally[0] += mesh.reductions - r0
            tally[1] += 1
            return out
        return real(counted, precond, rhs, max_it)

    ba_core._pcg = pcg
    try:
        yield tally
    finally:
        ba_core._pcg = real


def bal_options(dtype, mesh=None):
    return BAOptions(dtype=dtype, mesh=mesh, lm_max_iterations=BAL_LM_STEPS,
                     cg_max_iterations=BAL_CG_ITERS)


def phase_sharded_ba():
    """optimize_arrays on the Dubrovnik-sized problem with no mesh and over
    meshes of 1, 2 and 4 shards on cuda:0, float32 and float64: wall
    time, LM steps, CG iterations, reductions per CG iteration (each
    Schur product reduces E^T y and E z) and peak memory per run. The
    one-shard run must be bit-identical to no mesh, the others within
    SHARD_TOLS of it with as many LM steps, and every run must lower the
    MSE."""
    arrays = synthetic_ba_problem(BAL_CAMS, BAL_POINTS, BAL_OBS_PER_POINT, seed=0)
    print(f"  {BAL_CAMS} cameras, {BAL_POINTS} points, {len(arrays[4])} observations (padded "
          f"to {ba_lm._bucket(len(arrays[4]), 512)}); caps: {BAL_LM_STEPS} LM steps, "
          f"{BAL_CG_ITERS} CG iterations a solve", flush=True)
    runs = {}
    for dtype in (np.float32, np.float64):
        # A first run in each precision pays one-time costs (allocations,
        # the first use of a kernel); it is not reported.
        optimize_arrays(*arrays, bal_options(dtype), device="cuda")
        for shards in (None,) + BAL_SHARDS:
            mesh = None if shards is None else get_mesh(devices=["cuda:0"] * shards)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with cg_reductions(mesh or types.SimpleNamespace(reductions=0)) as tally:
                t0 = time.perf_counter()
                res = optimize_arrays(*arrays, bal_options(dtype, mesh), device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            st = res[4]
            per_cg = f"{tally[0] / tally[1]:.2f}" if mesh is not None and tally[1] else "-"
            print(f"  {np.dtype(dtype).name}, {'no mesh' if mesh is None else f'{shards} shard(s)'}: "
                  f"{wall:.3f} s, MSE {st.initial_mse:.6e} -> {st.final_mse:.6e}, "
                  f"{st.num_lm_iterations} LM steps, {st.num_cg_iterations} CG iterations "
                  f"({tally[1]} Schur products run), reductions {mesh.reductions if mesh else 0} "
                  f"in all, {per_cg} per CG iteration, max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} bytes", flush=True)
            if not st.final_mse < st.initial_mse:
                raise AssertionError("sharded BA: the MSE did not fall")
            runs[(dtype, shards)] = dict(res=res, wall=wall, peak=torch.cuda.max_memory_allocated(),
                                         per_cg=per_cg)
        base = runs[(dtype, None)]["res"]
        one = same_ba(runs[(dtype, 1)]["res"], base)
        print(f"  {np.dtype(dtype).name}: one shard bit-identical to no mesh: {one}", flush=True)
        if not one:
            raise AssertionError("a one-shard mesh differs from no mesh")
        for shards in BAL_SHARDS[1:]:
            res = runs[(dtype, shards)]["res"]
            gaps = ba_gaps(res, base)
            tols = SHARD_TOLS[dtype]
            print(f"  {np.dtype(dtype).name}, {shards} shards against no mesh, apart at most "
                  f"(limit): " + ", ".join(f"{k} {v:.3e} ({tols[k]:g})" for k, v in gaps.items()),
                  flush=True)
            if any(v > tols[k] for k, v in gaps.items()) \
                    or res[4].num_lm_iterations != base[4].num_lm_iterations:
                raise AssertionError(f"{shards} shards disagree with no mesh")
    return dict(arrays=arrays, runs=runs)


def fssr_sphere():
    """tests/test_parallel.py's FSSR input: 700 samples on a unit sphere
    and 900 query points (seed 11)."""
    rng = np.random.RandomState(11)
    n = 700
    phi = rng.uniform(0, 2 * np.pi, n)
    costh = rng.uniform(-1, 1, n)
    sinth = np.sqrt(1 - costh ** 2)
    normal = np.stack([sinth * np.cos(phi), sinth * np.sin(phi), costh], 1).astype(np.float32)
    samples = SampleList(pos=normal.copy(), normal=normal,
                         color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                         scale=rng.uniform(0.05, 0.3, n).astype(np.float32),
                         confidence=np.ones(n, np.float32))
    return samples, rng.uniform(-1.2, 1.2, (900, 3))


# Phase 26's process groups: (backend, processes). NCCL refuses two ranks on
# one device, so two processes share the card over gloo; rank 0 then joins
# an NCCL group of its own.
GROUPS = (("gloo", 2), ("nccl", 1))


def process_group_worker(rank, base):
    """One process of phase 26 (spawned): for each of GROUPS it belongs to,
    join the group, run phase 25's float32 BA twice and the sphere's FSSR
    evaluation over global_mesh() on the card, write the results to
    base/<backend>-<processes>-<rank>.npz and leave the group. A group of one process
    is joined directly: initialize() is a no-op for one process."""
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    arrays = tuple(np.load(Path(base) / "bal.npz")[f"arr_{i}"] for i in range(7))
    samples, q = fssr_sphere()
    for backend, world in GROUPS:
        if rank >= world:
            break
        init_method = f"file://{base}/{backend}-{world}-init"
        if world == 1:
            torch.distributed.init_process_group(backend, init_method=init_method,
                                                 world_size=1, rank=0)
        else:
            multihost.initialize(init_method, world, rank, device="cuda", backend=backend)
        try:
            mesh = multihost.global_mesh(device="cuda")
            runs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs.append(optimize_arrays(*arrays, bal_options(np.float32, mesh),
                                            device="cuda"))
                torch.cuda.synchronize()
                runs[-1] += (time.perf_counter() - t0,)
            res, again = runs
            ba_reductions = mesh.reductions // 2
            t0 = time.perf_counter()
            sums = fssr_block_eval.evaluate_positions_blocked(samples, q, mesh=mesh)
            fssr_s = time.perf_counter() - t0
            st = res[4]
            np.savez(Path(base) / f"{backend}-{world}-{rank}.npz", *res[:4], sums=sums,
                     status=[st.initial_mse, st.final_mse, st.num_lm_iterations,
                             st.num_lm_successful_iterations, st.num_cg_iterations],
                     info=[res[5], again[5], fssr_s, ba_reductions, mesh.size, mesh.rank,
                           str(torch.distributed.get_backend()) == backend
                           and same_ba(res, again)])
        finally:
            torch.distributed.destroy_process_group()


def run_processes(base, timeout=600):
    """Start process_group_worker in as many processes as the largest
    group and wait; a process that fails ends the others and fails the
    phase. Returns [(backend, [(BA result, FSSR sums, info) per rank])]
    in the order of GROUPS."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(process_group_worker, args=(str(base),),
                             nprocs=max(w for _, w in GROUPS), start_method="spawn", join=False)
    deadline = time.perf_counter() + timeout
    while not ctx.join(timeout=5):
        if time.perf_counter() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f"the process-group workers did not finish in {timeout} s")
    out = []
    for backend, world in GROUPS:
        out.append((backend, []))
        for rank in range(world):
            z = np.load(base / f"{backend}-{world}-{rank}.npz")
            st = z["status"]
            out[-1][1].append((tuple(z[f"arr_{i}"] for i in range(4)) + (types.SimpleNamespace(
                initial_mse=st[0], final_mse=st[1], num_lm_iterations=int(st[2]),
                num_lm_successful_iterations=int(st[3]), num_cg_iterations=int(st[4])),),
                z["sums"], z["info"]))
    return out


def phase_process_group(sharded):
    """Two processes on the one card in a gloo group (NCCL refuses two
    ranks on one device), through multihost.initialize and global_mesh:
    phase 25's float32 BA bit-identical to its in-process two-shard run,
    and the sphere's FSSR evaluation bit-identical to mesh=None on the
    card; then the first process in an NCCL group of one, its BA
    bit-identical to phase 25's float32 run with no mesh."""
    base = WORK / "process_group"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    np.savez(base / "bal.npz", *sharded["arrays"])
    samples, q = fssr_sphere()
    want_sums = fssr_block_eval.evaluate_positions_blocked(samples, q, device="cuda")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    groups = run_processes(base)
    wall = time.perf_counter() - t0
    # Phase 25's run with as many shards as the group has processes.
    refs = {2: ((np.float32, 2), "two-shard"), 1: ((np.float32, None), "unsharded")}
    for backend, ranks in groups:
        world = len(ranks)
        want = sharded["runs"][refs[world][0]]["res"]
        for rank, (res, sums, info) in enumerate(ranks):
            ba_same = same_ba(res, want)
            fssr_same = np.array_equal(sums.view(np.uint64), want_sums.view(np.uint64))
            print(f"  {backend}, rank {rank} of {world}: BA {float(info[0]):.3f} s, again "
                  f"{float(info[1]):.3f} s ({res[4].num_lm_iterations} LM steps, "
                  f"{res[4].num_cg_iterations} CG iterations, {int(info[3])} reductions), "
                  f"bit-identical to phase 25's {refs[world][1]} float32 run: {ba_same}; "
                  f"FSSR {float(info[2]):.3f} s, sums bit-identical to mesh=None: {fssr_same}; "
                  f"group backend {backend} and the two runs bit-identical: {bool(info[6])}",
                  flush=True)
            if not (ba_same and fssr_same and bool(info[6])):
                raise AssertionError(f"{backend} process group: rank {rank} disagrees")
    print(f"  {max(w for _, w in GROUPS)} processes in {wall:.3f} s with their start-up",
          flush=True)
    shutil.rmtree(base, ignore_errors=True)
    return wall


def phase_sfm_with_mesh(full_sfm):
    """sfmrecon's incremental SfM on phase 9's scene from phase 5's
    prebundle (sfm_reconstruct's intrinsics, options and initial pair)
    with IncrementalOptions.ba_mesh over two shards on cuda:0, so that
    every BA of the run is sharded. Held to phase 9's limits: 40/40
    cameras, tracks within 1% of phase 9's, centres within 2% of the
    true cameras; BA totals beside phase 9's. The undistortion and the
    writes that follow SfM in the app are phase 9's and not repeated."""
    scene = WORK / "main"
    vps, matching = load_scene_result(str(scene))
    Intrinsics(IntrinsicsOptions()).compute(Scene(str(scene)), vps)
    opts = SfmOptions(initial_pair=MAIN_INITIAL_PAIR)
    mesh = opts.incremental_opts.ba_mesh = get_mesh(devices=["cuda:0"] * 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inc = run_incremental_sfm(vps, matching, opts, "cuda")
    bundle = inc.create_bundle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t9 = full_sfm["timings"]
    ok, centres = bundle_centres(bundle)
    err = aligned_error(centres, true_centres(MAIN_VIEWS)[ok])
    n_tracks = bundle.get_num_features()
    bt, bt9 = inc.ba_totals, t9["ba_totals"]
    print(f"  mesh: {mesh.size} shards on {[str(d) for d in mesh.devices]}, {mesh.reductions} "
          f"reductions; incremental SfM {wall:.3f} s (phase 9: {t9['incremental_ms']} ms)",
          flush=True)
    print(f"  {int(ok.sum())}/{MAIN_VIEWS} cameras, n_tracks {n_tracks} (phase 9: "
          f"{t9['n_tracks']}), centres {err:.5f} of the true extent (<={CENTRE_TOL}; phase 9: "
          f"{full_sfm['err']:.5f})", flush=True)
    print(f"  BA totals: {bt['n_ba']} BAs, {bt['lm_iters']} LM steps, {bt['cg_iters']} CG "
          f"iterations, {bt['ms']} ms; phase 9: {bt9['n_ba']}, {bt9['lm_iters']}, "
          f"{bt9['cg_iters']}, {bt9['ms']} ms", flush=True)
    if mesh.reductions == 0:
        raise AssertionError("incremental SfM did not shard its BA")
    if not ok.all() or len(ok) != MAIN_VIEWS or err > CENTRE_TOL \
            or abs(n_tracks - t9["n_tracks"]) > TRACK_TOL * t9["n_tracks"]:
        raise AssertionError("incremental SfM with a BA mesh misses phase 9's limits")
    return dict(wall=wall, ba_totals=dict(bt))


FSSR_SHARDS = 4


def phase_sharded_fssr(recorded):
    """Phase 13's default card evaluation (its samples and corners) again,
    over FSSR_SHARDS shards on cuda:0 and with no mesh: both sums
    bit-identical to phase 13's."""
    (samples, positions), kwargs, want = recorded
    out = {}
    for label, kw in (("no mesh", dict(device="cuda")),
                      (f"{FSSR_SHARDS} shards", dict(mesh=get_mesh(devices=["cuda:0"] *
                                                                    FSSR_SHARDS)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fssr_block_eval.evaluate_positions_blocked(samples, positions, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = fssr_block_eval.STATS
        same = np.array_equal(got.view(np.uint64), want.view(np.uint64))
        print(f"  {label}: {wall:.3f} s (block expansion {st['expand_ms']:.1f} ms, dispatch "
              f"{st['dispatch_ms']:.1f} ms, sync {st['sync_ms']:.1f} ms), SB buckets "
              f"{st['buckets']}, {len(samples)} samples, {len(positions)} corners; sums "
              f"bit-identical to phase 13's card run: {same}", flush=True)
        if not same:
            raise AssertionError(f"FSSR evaluation, {label}: sums differ from phase 13's")
        out[label] = wall
    return out


def library_close(got, want, per_channel=False):
    """Largest |got - want| over max(1, |want|), or with per_channel over
    max(1, the largest |want| of its last-axis channel)."""
    got, want = got.double().cpu().numpy(), want.double().numpy()
    mag = np.abs(want).reshape(-1, want.shape[-1]).max(axis=0) if per_channel else np.abs(want)
    return float((np.abs(got - want) / np.maximum(1.0, mag)).max())


LIBRARY_TOL = 1e-6


def phase_library():
    """The torch functions of core/image_color, math/geometry and
    math/intersect on the card against the same calls on the CPU, float32,
    on the users' own data: phase 9's view 0 (1600x1200) for the colour
    conversions; phase 15's cleaned surface for the triangles; rays from
    view 0's camera centre to every triangle's centroid and to random
    points; the surface's bounding box. Within LIBRARY_TOL (relative
    where a value is above 1; colours of each channel's largest) and hit
    masks equal."""
    scene = WORK / "main"
    img = Scene(str(scene)).get_view_by_id(0).get_image("original")
    rgb = torch.from_numpy(np.asarray(img, np.float32) / 255.0)
    mesh = load_mesh(str(scene / "clean.ply"))
    tri = torch.from_numpy(mesh.vertices[mesh.faces].astype(np.float32)).permute(1, 0, 2)
    cam = bundle_centres(load_mve_bundle(str(scene / "synth_0.out")))[1][0].astype(np.float32)
    rng = np.random.RandomState(29)
    ends = np.concatenate([tri.mean(0).numpy(), rng.randn(len(mesh.faces), 3).astype(np.float32)])
    origin = torch.from_numpy(np.broadcast_to(cam, ends.shape).copy())
    direction = torch.from_numpy(ends) - origin
    lo = torch.from_numpy(mesh.vertices.min(0))
    hi = torch.from_numpy(mesh.vertices.max(0))
    tri2 = torch.cat([tri, tri], dim=1)
    xyz = image_color.rgb_to_xyz(rgb)
    calls = [(f"image_color.{name}", getattr(image_color, name), (x,), True)
             for name, x in (("srgb_to_linear", rgb), ("linear_to_srgb", rgb),
                             ("rgb_to_xyz", rgb), ("xyz_to_rgb", xyz), ("xyz_to_lab", xyz),
                             ("lab_to_xyz", image_color.xyz_to_lab(xyz)),
                             ("rgb_to_ycbcr", rgb),
                             ("ycbcr_to_rgb", image_color.rgb_to_ycbcr(rgb)))]
    calls += [("geometry.triangle_normal", geometry.triangle_normal, tuple(tri), False),
              ("geometry.triangle_area", geometry.triangle_area, tuple(tri), False),
              ("geometry.triangle_circumradius", geometry.triangle_circumradius, tuple(tri),
               False),
              ("geometry.normalize", geometry.normalize, (direction,), False),
              ("intersect.ray_box", intersect.ray_box, (origin, direction, lo, hi), False),
              ("intersect.ray_triangle", intersect.ray_triangle, (origin, direction, *tri2),
               False),
              ("intersect.point_in_box", intersect.point_in_box,
               (torch.from_numpy(ends), lo, hi), False)]
    worst = 0.0
    for name, fn, args, per_channel in calls:
        want = fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(*(a.to("cuda:0") for a in args))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        masks = [bool(torch.equal(g.cpu(), w)) for g, w in zip(got, want) if w.dtype == torch.bool]
        gaps = [library_close(g, w, per_channel) for g, w in zip(got, want)
                if w.dtype != torch.bool]
        hits = [int(w.sum()) for w in want if w.dtype == torch.bool]
        print(f"  {name}: {tuple(got[0].shape)}, card {ms:.3f} ms (with its copies), apart at most "
              f"{max(gaps, default=0.0):.3e}; masks equal {masks}, hits {hits}", flush=True)
        if not all(masks) or max(gaps, default=0.0) > LIBRARY_TOL \
                or not all(torch.isfinite(g.float()).all() for g in got):
            raise AssertionError(f"{name}: card and CPU disagree")
        worst = max([worst] + gaps)
    return worst


# Phase 30's limit: the float64 verbose BA's final MSE against the run
# without verbose_output, relative. Both take the same steps in float64
# on the CPU (tests/test_torch_ba.py); the trust region's host float64
# arithmetic and the tensor arithmetic of the other loop round apart.
VERBOSE_MSE_TOL = 1e-10


def ba_problem(arrays):
    """A BAProblem holding synthetic_ba_problem's arrays."""
    intr, trans, rot, pts, obs, cam_idx, pt_idx = arrays
    cameras = [BACamera(focal_length=float(i[0]), distortion=i[1:3].copy(),
                        translation=t.copy(), rotation=r.copy())
               for i, t, r in zip(intr, trans, rot)]
    observations = [BAObservation(o.copy(), int(c), int(p)) for o, c, p in zip(obs, cam_idx, pt_idx)]
    return BAProblem(cameras, [BAPoint(pos=p.copy()) for p in pts], observations)


def card_ba(arrays, **options):
    """(printed lines, status, wall ms) of BundleAdjustment(BAOptions(
    **options)).optimize on the card."""
    problem = ba_problem(arrays)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        status = BundleAdjustment(BAOptions(**options), device="cuda").optimize(problem)
    torch.cuda.synchronize()
    return out.getvalue().splitlines(), status, 1e3 * (time.perf_counter() - t0)


def phase_verbose_ba():
    """Phase 8's problem through BundleAdjustment with verbose_output (the
    host-driven loop, mve_tpu's verbose path), float32 and float64."""
    arrays = synthetic_ba_problem(64, 10_240, 4, seed=0)
    for dtype in (np.float32, np.float64):
        name = np.dtype(dtype).name
        _, quiet, quiet_ms = card_ba(arrays, dtype=dtype)
        lines, st, ms = card_ba(arrays, dtype=dtype, verbose_output=True)
        need = st.num_lm_iterations + 3
        lines_min, st_min, ms_min = card_ba(arrays, dtype=dtype, verbose_output=True,
                                            lm_min_iterations=need)
        gap = abs(st.final_mse - quiet.final_mse) / quiet.final_mse
        print(f"  {name}: without verbose_output {quiet_ms:.1f} ms, {quiet.num_lm_iterations} LM "
              f"steps, MSE {quiet.final_mse:.9e}; verbose {ms:.1f} ms, {st.num_lm_iterations} "
              f"steps, MSE {st.final_mse:.9e} (relative gap {gap:.3e}), {len(lines)} lines:",
              flush=True)
        for line in lines:
            print(f"    {line}")
        print(f"  {name}, lm_min_iterations={need}: {ms_min:.1f} ms, {st_min.num_lm_iterations} "
              f"steps ({st_min.num_lm_successful_iterations} ok), MSE {st_min.final_mse:.9e}; "
              f"last line: {lines_min[-1] if lines_min else None}", flush=True)
        for run_lines, run in ((lines, st), (lines_min, st_min)):
            steps = sum(line.startswith("BA: #") for line in run_lines)
            if steps != run.num_lm_iterations or len(run_lines) != steps + 1:
                raise AssertionError(f"{name}: {steps} step lines of {len(run_lines)} for "
                                     f"{run.num_lm_iterations} LM steps")
        if st_min.num_lm_iterations < need:
            raise AssertionError(f"{name}: {st_min.num_lm_iterations} LM steps with "
                                 f"lm_min_iterations={need}")
        if dtype == np.float64 and gap > VERBOSE_MSE_TOL:
            raise AssertionError(f"float64 verbose BA's final MSE {gap:.3e} from the other loop's")
        if not st.final_mse < st.initial_mse:
            raise AssertionError(f"{name}: the verbose BA did not lower the MSE")


def legacy_grid(*modules):
    """tests/torch_legacy_grid.legacy_grid, loaded from its file (the
    tests directory is not a package): dmrecon's host code with the
    legacy rectification swapped in."""
    path = ROOT / "tests" / "torch_legacy_grid.py"
    spec = importlib.util.spec_from_file_location("torch_legacy_grid", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.legacy_grid(*modules)


def phase_legacy_sweep():
    """The sweep solver on the legacy grid, on phase 10's scene and
    settings at scale 1: card twice and CPU, phase 10's limits."""
    base = WORK / "small"
    settings = MvsSettings(nr_recon_neighbors=3, scale=1)
    fitted = prepare_view(base / "sfm_cuda", 0, settings)["rect"][0]["H_fwd"]
    with legacy_grid(mvs_sweep) as handed:
        preps = [prepare_view(base / "sfm_cuda", i, settings) for i in range(4)]
        if np.array_equal(preps[0]["rect"][0]["H_fwd"], fitted):
            raise AssertionError("the legacy grid's H_fwd is the fitted grid's")
        if not all(mvs_dmrecon._sweep_capable(p, settings) for p in preps):
            raise AssertionError("a view of phase 10's scene does not rectify on the legacy grid")
        depths = {}
        for name, dev in (("cuda", "cuda"), ("cuda, again", "cuda"), ("cpu", "cpu")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth = mvs_dmrecon._run_batch(preps, settings, dev)[0]
            torch.cuda.synchronize()
            depths[name] = dict(enumerate(depth))
            print(f"  {name}: 4 views in {time.perf_counter() - t0:.3f} s, fills "
                  f"{[round(float((d > 0).mean()), 4) for d in depth]}", flush=True)
    H, W = preps[0]["ref"].shape
    my, mx = mvs_sweep.rect_margins(H, W)
    identical = all(np.array_equal(depths["cuda"][i], depths["cuda, again"][i]) for i in range(4))
    print(f"  views of {W}x{H}, legacy grid {W + 2 * mx}x{H + 2 * my} (rect_hw handed over: "
          f"{sorted(set(handed))}); two card runs bit-identical: {identical}", flush=True)
    if len(handed) != 3 or not identical \
            or any(float((d > 0).mean()) < 0.3 for d in depths["cpu"].values()):
        raise AssertionError("legacy grid: not three solves, two card runs differ, or a view's "
                             "fill is under 0.3")
    compare_depths(depths["cuda"], depths["cpu"])
    shutil.rmtree(base, ignore_errors=True)


def main() -> int:
    phase("1. environment")
    if not torch.cuda.is_available():
        print("CUDA is not available: this script runs on an NVIDIA GPU only.", file=sys.stderr)
        return 1
    smi = smi_line()
    print(smi)
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    print(f"  allow_tf32: matmul {tf32[0]}, cudnn {tf32[1]} (mve_tpu_torch {mve_tpu_torch.__version__})")
    if any(tf32):
        raise AssertionError("TF32 must be off")
    dev = torch.device("cuda")

    phase("2. build")
    t0 = time.perf_counter()
    logs = cuda_build.build(["top2"], force=True)
    print(f"  built {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)]
        print(f"  [{name}] spill bytes over all kernels: {sum(spills)}")
        if not spills or any(spills):
            raise AssertionError(f"{name}: ptxas reports spills (or no report)")
    sass = cuda_build.sass("top2").splitlines()
    counts = {op: sum(op in line for line in sass) for op in ("HGMMA", "UTMALDG")}
    print(f"  [top2] SASS: {counts['HGMMA']} HGMMA (wgmma), {counts['UTMALDG']} UTMALDG "
          f"(TMA loads)", flush=True)
    if not all(counts.values()):
        raise AssertionError("top2: no tensor-core or no TMA instruction in the machine code")
    t0 = time.perf_counter()
    log = native.build(force=True)
    print(f"  [native] g++ {' '.join(native.CXX_FLAGS)} {native.SOURCE.name} -> "
          f"{native.library_path().relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s; "
          f"compiler output: {log.strip() or '(none)'}", flush=True)
    if native.get_lib() is None:
        raise AssertionError("the native host library does not load")

    phase("3. top2 kernel against its plain version")
    check_err = phase_kernel_checks(dev)
    yard = phase_kernel_timing(dev)

    phase("4. card against CPU, 4 views of 480x360")
    phase_card_vs_cpu()

    phase(f"5. main path: sfm_reconstruct(skip_sfm=True), {MAIN_VIEWS} views of "
          f"{MAIN_WIDTH}x{MAIN_HEIGHT}")
    main_run, calls = phase_main_path()

    phase("6. top2 at the main path's inputs")
    at_main, split_at_main = phase_main_path_kernel(calls)
    mutual_same = phase_mutual_matches(calls)

    phase("7. whole app, card against CPU, 4 views of 480x360 from phase 4's prebundle")
    phase_sfm_card_vs_cpu()

    phase("8. bundle adjustment, 64 cameras, 10,240 points, 4 observations a point")
    phase_ba()

    phase(f"9. whole app, {MAIN_VIEWS} views of {MAIN_WIDTH}x{MAIN_HEIGHT} from phase 5's "
          f"prebundle, initial pair {MAIN_INITIAL_PAIR}")
    full_sfm = phase_full_sfm()

    phase("10. dmrecon with each solver, card against CPU, on phase 7's scene")
    phase_dmrecon_card_vs_cpu()

    phase(f"11. dmrecon -s2, {MAIN_VIEWS} views of {MAIN_WIDTH}x{MAIN_HEIGHT} (depth maps of "
          f"{MAIN_WIDTH // 4}x{MAIN_HEIGHT // 4})")
    full_dm = phase_full_dmrecon()

    phase("12. scene2pset -F2 on phase 11's depth maps")
    phase_pointset()

    phase(f"13. fssrecon card against CPU: every {FSSR_EVERY}th point of phase 12's point set "
          f"(default and streaming), and a scale-diverse set")
    fssr_sub = phase_fssr_card_vs_cpu()

    cpu_view0 = start_cpu_view0()
    phase("14. fssrecon on phase 12's whole point set (phase 11's view 0 on the CPU in a second "
          "process meanwhile)")
    phase_full_fssr()

    phase("15. meshclean on phase 14's surface")
    phase_meshclean()

    phase("11, continued. phase 11's view 0, card against CPU")
    finish_cpu_view0(cpu_view0, full_dm["card_view0"])

    phase(f"16. makescene on the card and on the CPU: -i and -m on {MAIN_VIEWS} photos of "
          f"{MAIN_WIDTH}x{MAIN_HEIGHT}, a Bundler workspace of {BUNDLER_VIEWS} views")
    phase_makescene()

    phase(f"17. sfmrecon --cascade-hashing --skip-sfm on phase 16's {MAIN_VIEWS} views; the "
          f"cascade card against CPU on phase 4's views")
    cascade = phase_cascade(main_run)

    phase("18. sfmrecon --skip-sfm --num-processes 2, two processes on the card, on phase 4's "
          "scene")
    phase_two_processes()

    phase(f"19. featurerecon on {FEATURERECON_VIEWS} of phase 9's views of "
          f"{MAIN_WIDTH}x{MAIN_HEIGHT} and their cameras")
    feat = phase_featurerecon()
    shutil.rmtree(WORK / "makescene", ignore_errors=True)

    phase("20. the command line from a folder of 4 photos of 480x360: makescene, sfmrecon, "
          "dmrecon, scene2pset, fssrecon, meshclean, then the host apps and meshview")
    phase_cli()

    phase(f"21. meshview at {VIEW_W}x{VIEW_H} on phase 15's surface with phase 9's scene; card "
          f"against CPU on phase 13's surface")
    phase_meshview()

    phase(f"22. SIFT with min_octave=-1 on {SIFT_VIEWS} views of {MAIN_WIDTH}x{MAIN_HEIGHT}; card "
          f"against CPU at 480x360")
    phase_sift_upsampled()

    phase("23. tracing: the four FSSR spans under MVE_TPU_TRACE_DIR")
    phase_tracing()

    phase(f"24. fssrecon with MVE_TPU_FSSR_PAIRWISE=1 on phase 13's point set: card twice, CPU, "
          f"and the dense path")
    phase_pairwise_fssr(*fssr_sub["default_card"])

    phase(f"25. bundle adjustment at the Dubrovnik problem's size ({BAL_CAMS} cameras, "
          f"{BAL_POINTS} points, {BAL_OBS_PER_POINT} observations a point): no mesh and "
          f"{', '.join(map(str, BAL_SHARDS))} shards on cuda:0, float32 and float64")
    sharded = phase_sharded_ba()

    phase("26. two processes on the card in a gloo group (phase 25's float32 BA, an FSSR "
          "evaluation), then one process in an NCCL group")
    phase_process_group(sharded)
    del sharded

    phase(f"27. phase 13's FSSR evaluation over {FSSR_SHARDS} shards on cuda:0")
    phase_sharded_fssr(fssr_sub.pop("default_eval"))

    phase("28. image_color, geometry and intersect, card against CPU")
    phase_library()

    phase(f"29. incremental SfM with its BA over two shards on cuda:0, {MAIN_VIEWS} views from "
          f"phase 5's prebundle")
    phase_sfm_with_mesh(full_sfm)
    shutil.rmtree(WORK / "main", ignore_errors=True)

    phase("30. verbose BA with lm_min_iterations on phase 8's problem; the sweep solver on the "
          "legacy grid (rect_hw=None) on phase 10's scene, card against CPU")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    phase_verbose_ba()
    phase_legacy_sweep()
    print(f"  phase 30: {time.perf_counter() - t0:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    replaces = "mve_tpu/ops/pallas_matching.py:27"
    kernels = [
        {"name": "top2", "route": "cuda", "source": "mve_tpu_torch/csrc/top2.cu",
         "replaces": replaces, "launches": main_run["launches"],
         **at_main, "max_abs_err": max(at_main["max_abs_err"], check_err, feat["max_abs_err"]),
         "launches_per_pair_paths": {"cascade_hashing": cascade["launches"],
                                     "featurerecon": feat["launches"]},
         "mutual_targets_identical": mutual_same, "yardstick_8192x8192x128": yard},
        {"name": "top2_split", "route": "cuda", "source": "mve_tpu_torch/csrc/top2.cu",
         "replaces": replaces, "launches": main_run["split_launches"], **split_at_main,
         "launches_per_pair_paths": {"cascade_hashing": cascade["split_launches"],
                                     "featurerecon": feat["split_launches"]}},
    ]
    print()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_background()
    sys.exit(code)
