#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mve_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure raises and ends the run:
  1. environment: the card (nvidia-smi name and power limit), versions,
     the TF32 flags (must be off);
  2. build every hand-written kernel from mve_tpu_torch/csrc with nvcc;
  3. the top-2 kernel against its plain PyTorch version on the card, on
     exact, ragged, single-reference, tied, D=64 and batched-pair inputs,
     in float32 and bf16 under one rule, which must also reject a kernel
     run in the other precision; then timed beside the plain version and
     torch.topk(q @ r.T, 2) at 8192 x 8192 x 128;
  4. sfm_reconstruct(skip_sfm=True) on a small scene on the card and on
     the CPU: the two prebundles must agree;
  5. sfm_reconstruct(skip_sfm=True) on 40 views of 1600 x 1200 (the
     main path), with the launch counts read around it;
  6. the kernel at every one of the main path's own inputs: held against
     the plain version and timed.
It prints one JSON line describing every kernel, and as its last line
{"ok": true, "device": {...}}. It exits non-zero without a result when
CUDA is unavailable. Scenes are written under build/chip_smoke/.
"""

import json
import math
import os
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
from mve_tpu_torch.ops.matching import descriptor_top2, descriptor_top2_pairs
from mve_tpu_torch.sfm.bundler import matching_batched
from mve_tpu_torch.sfm.bundler.common import load_prebundle

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_F32_FLOPS = 67e12       # CUDA cores
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


def phase_kernel_checks(dev):
    rng = np.random.RandomState(0)
    errs = []
    cases = [("exact tiles 1024x512 D128", 1024, 512, 128),
             ("ragged 37x91 D128", 37, 91, 128),
             ("ragged 300x700 D128", 300, 700, 128),
             ("ragged 1025x511 D128", 1025, 511, 128),
             ("exact tiles 1024x512 D64", 1024, 512, 64),
             ("ragged 300x700 D64", 300, 700, 64)]
    for name, n1, n2, d in cases:
        q, r = unit_desc(rng, n1, d, dev), unit_desc(rng, n2, d, dev)
        for bf16 in (False, True):
            errs.append(compare(name, top2_mod.top2(q, r, n2, bf16),
                                descriptor_top2(q, r, n_refs=n2, use_bf16=bf16), bf16))
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
            for name, x, y in (("pairs V=6 N=2048 a->b D%d" % d, pa, pb),
                               ("pairs V=6 N=2048 b->a D%d" % d, pb, pa)):
                got = top2_mod.top2_pairs(desc, n_desc, x, y, bf16)
                want = descriptor_top2_pairs(desc, n_desc, x, y, use_bf16=bf16)
                # Query rows past n_desc[a] are padding the caller drops.
                rows = torch.arange(N, device=dev)[None, :] < n_desc[x.long()][:, None]
                errs.append(compare(name, tuple(t[rows] for t in got),
                                    tuple(t[rows] for t in want), bf16))
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
        kernel = cuda_ms(lambda: top2_mod.top2(q, r, n, bf16), 20)
        plain = cuda_ms(lambda: descriptor_top2(q, r, n_refs=n, use_bf16=bf16), 20)
        library = cuda_ms(lambda: torch.topk(qq @ rr.T, 2, dim=1), 20)
        peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
        bound = 1e3 * max(flops / peak, (2 * n * d * 4 + n * 12) / PEAK_BYTES)
        tag = "bf16" if bf16 else "f32"
        out[tag] = dict(ms=kernel, plain_ms=plain, library_ms=library, bound_ms=bound)
        print(f"  8192x8192x128 {tag}: kernel {kernel:.4f} ms ({flops / kernel / 1e9:.2f} TFLOP/s), "
              f"plain {plain:.4f} ms ({flops / plain / 1e9:.2f}), "
              f"torch.topk(q@r.T,2) {library:.4f} ms ({flops / library / 1e9:.2f}), "
              f"bound {bound:.4f} ms", flush=True)
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
    top2_mod.launches = 0
    t0 = time.perf_counter()
    try:
        sfmrecon.sfm_reconstruct(str(scene), skip_sfm=True, verbose=False, device="cuda")
        torch.cuda.synchronize()
    finally:
        matching_batched.top2_pairs = recorder.fn
    wall = time.perf_counter() - t0
    launches = top2_mod.launches
    peak = torch.cuda.max_memory_allocated()
    t = dict(sfmrecon.LAST_TIMINGS)
    print(f"  sfm_reconstruct(skip_sfm=True, device='cuda'): {wall:.3f} s", flush=True)
    print(f"  features_ms {t['features_ms']}, matching_ms {t['matching_ms']} "
          f"(ransac: host sampling {t.get('ransac_sample_ms')} ms, device solve "
          f"{t.get('ransac_ms')} ms), n_features {t['n_features']}", flush=True)
    print(f"  sift bucket {t.get('sift_bucket')}, surf bucket {t.get('surf_bucket')}, "
          f"pairs {t.get('n_pairs')} -> low-res {t.get('n_lowres_pairs')} -> "
          f"ransac {t.get('n_ransac_pairs')} -> connected {t.get('n_connected_pairs')}", flush=True)
    print(f"  max_memory_allocated {peak} bytes, top2.launches {launches}", flush=True)
    print("  top2_pairs calls (desc shape, pairs, bf16): "
          f"{[(tuple(c[0].shape), len(c[2]), c[4]) for c in recorder.calls]}", flush=True)
    if launches <= 0:
        raise AssertionError("the main path launched the top2 kernel no time")

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
    return dict(launches=launches, peak=peak, timings=t, wall=wall), recorder.calls


def phase_main_path_kernel(calls):
    """Every top2_pairs call of the main path, on its own inputs: held
    against the plain version, then timed. The totals are the kernel's
    work in one main-path run."""
    err = ms = plain_ms = flops = nbytes = 0.0
    for desc, n_desc, pair_a, pair_b, bf16 in calls:
        V, N, D = desc.shape
        got = top2_mod.top2_pairs(desc, n_desc, pair_a, pair_b, bf16)
        want = descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16=bf16)
        rows = torch.arange(N, device=desc.device)[None, :] < n_desc[pair_a.long()][:, None]
        err = max(err, compare(f"main path desc {V}x{N}x{D}, {len(pair_a)} pairs",
                               tuple(t[rows] for t in got), tuple(t[rows] for t in want), bf16))
        call_ms = cuda_ms(lambda: top2_mod.top2_pairs(desc, n_desc, pair_a, pair_b, bf16), 5)
        call_plain = cuda_ms(
            lambda: descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16=bf16), 2)
        na = n_desc[pair_a.long()].double()
        nb = n_desc[pair_b.long()].double()
        call_flops = float(2.0 * D * (na * nb).sum())     # real rows x real columns
        print(f"    kernel {call_ms:.4f} ms ({call_flops / call_ms / 1e9:.2f} TFLOP/s on "
              f"real rows), plain {call_plain:.4f} ms", flush=True)
        ms, plain_ms, flops = ms + call_ms, plain_ms + call_plain, flops + call_flops
        nbytes += V * N * D * 4 + len(pair_a) * N * 12
    peak = PEAK_BF16_FLOPS if any(c[4] for c in calls) else PEAK_F32_FLOPS
    bound_by = "operations" if flops / peak >= nbytes / PEAK_BYTES else "bytes"
    bound = 1e3 * max(flops / peak, nbytes / PEAK_BYTES)
    print(f"  all {len(calls)} calls: kernel {ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s on "
          f"real rows), plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by)


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
    logs = cuda_build.build(["top2"])
    print(f"  built {sorted(logs) or 'nothing (up to date)'} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  [{name}] {line}")

    phase("3. top2 kernel against its plain version")
    check_err = phase_kernel_checks(dev)
    yard = phase_kernel_timing(dev)

    phase("4. card against CPU, 4 views of 480x360")
    phase_card_vs_cpu()

    phase(f"5. main path: sfm_reconstruct(skip_sfm=True), {MAIN_VIEWS} views of "
          f"{MAIN_WIDTH}x{MAIN_HEIGHT}")
    main_run, calls = phase_main_path()

    phase("6. top2 at the main path's inputs")
    at_main = phase_main_path_kernel(calls)

    kernels = [{
        "name": "top2", "route": "cuda", "source": "mve_tpu_torch/csrc/top2.cu",
        "replaces": "mve_tpu/ops/pallas_matching.py:27",
        "launches": main_run["launches"], "max_abs_err": max(at_main["max_abs_err"], check_err),
        "ms": at_main["ms"], "plain_ms": at_main["plain_ms"], "bound_ms": at_main["bound_ms"],
        "bound_by": at_main["bound_by"], "library_ms": None,
        "yardstick_8192x8192x128": yard,
    }]
    print()
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
