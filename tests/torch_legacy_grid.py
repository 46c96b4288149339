"""The legacy fixed-margin rectification grid, driven through dmrecon's
host code.

No entry point of mve_tpu or of the port reaches the legacy grid
(rectify_pair(margin_yx=rect_margins(H, W)) with
solve_batch_sweep(rect_hw=None)): dmrecon fits the grid to each pair.
legacy_grid swaps it in for the sweep_solver modules it is given
(mve_tpu's and the port's have the same names). It relies on dmrecon's
_run_batch reading each pair's rect_wh for its grid packing, so the
rect_wh of a legacy pair (None) is set to (0, 0).

Used by tests/test_torch_mvs.py and by chip_smoke.py's phase 30(b).
"""

import contextlib


@contextlib.contextmanager
def legacy_grid(*modules):
    """Within the block, every pair is rectified with the fixed margins
    and every solve is handed rect_hw=None. Yields the list of the
    rect_hw values dmrecon handed over, one per solve."""
    handed = []
    saved = [(m, m.rectify_pair, m.solve_batch_sweep) for m in modules]

    def swap(mod, rectify, solve):
        def legacy_rectify(*args, image_wh, **kw):
            r = rectify(*args, margin_yx=mod.rect_margins(image_wh[1], image_wh[0]), **kw)
            if r is not None:
                r["rect_wh"] = (0, 0)
            return r

        def legacy_solve(*args, **kw):
            handed.append(kw.get("rect_hw"))
            return solve(*args, **{**kw, "rect_hw": None})

        mod.rectify_pair, mod.solve_batch_sweep = legacy_rectify, legacy_solve

    for mod, rectify, solve in saved:
        swap(mod, rectify, solve)
    try:
        yield handed
    finally:
        for mod, rectify, solve in saved:
            mod.rectify_pair, mod.solve_batch_sweep = rectify, solve
