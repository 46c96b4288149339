#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and ends the run:
  1. environment: the card (nvidia-smi name and power limit), versions,
     the TF32 flags (must be off);
  2. build every hand-written kernel from mve_tpu_torch/csrc with nvcc;
     ptxas must report 0 spill bytes, and the top-2 library's machine
     code must hold tensor-core (HGMMA) and TMA (UTMALDG) instructions;
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
     kernel against those through the plain version.
It prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}. It exits non-zero without a result when
CUDA is unavailable. Scenes are written under build/chip_smoke/.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import mve_tpu_torch
from mve_tpu_torch import synthetic
from mve_tpu_torch.apps import sfmrecon
from mve_tpu_torch.ops import cuda_build, top2 as top2_mod
from mve_tpu_torch.ops.matching import descriptor_top2, descriptor_top2_pairs, split_tf32
from mve_tpu_torch.sfm.bundler import matching_batched
from mve_tpu_torch.sfm.bundler.common import Viewport, load_prebundle
from mve_tpu_torch.sfm.bundler.features import Features
from mve_tpu_torch.sfm.bundler.matching import Matching

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


def phase(title):
    print(f"\n== {title}", flush=True)


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
    gv, gm = load_scene_result(str(base / "cuda"))
    cv, cm = load_scene_result(str(base / "cpu"))
    tol = 0.5 / 480.0  # 0.5 px in normalised coordinates
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
    shutil.rmtree(base, ignore_errors=True)

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
    shutil.rmtree(scene, ignore_errors=True)
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

    replaces = "mve_tpu/ops/pallas_matching.py:27"
    kernels = [
        {"name": "top2", "route": "cuda", "source": "mve_tpu_torch/csrc/top2.cu",
         "replaces": replaces, "launches": main_run["launches"],
         **at_main, "max_abs_err": max(at_main["max_abs_err"], check_err),
         "mutual_targets_identical": mutual_same, "yardstick_8192x8192x128": yard},
        {"name": "top2_split", "route": "cuda", "source": "mve_tpu_torch/csrc/top2.cu",
         "replaces": replaces, "launches": main_run["split_launches"], **split_at_main},
    ]
    print()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
