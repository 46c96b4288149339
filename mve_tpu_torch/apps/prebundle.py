"""prebundle: inspect prebundle.sfm files (reference: apps/prebundle/;
port of mve_tpu/apps/prebundle.py, host numpy).

    python -m mve_tpu_torch.apps.prebundle <scene or prebundle.sfm>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..sfm.bundler import load_prebundle


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="prebundle",
                                description="Statistics for prebundle.sfm files.")
    p.add_argument("path", help="prebundle.sfm file or scene directory")
    p.add_argument("-g", "--graph-mode", type=str, default="",
                   metavar="FILE",
                   help="Output matching graph file for DOT")
    args = p.parse_args(argv)
    path = args.path
    if os.path.isdir(path):
        path = os.path.join(path, "prebundle.sfm")
    viewports, matching = load_prebundle(path)
    if args.graph_mode:
        # DOT matching graph (prebundle.cc graph_mode): one node per
        # viewport, one edge per verified pair labeled by match count.
        with open(args.graph_mode, "w") as f:
            f.write("graph matching {\n")
            for i in range(len(viewports)):
                f.write(f"  v{i};\n")
            for m in matching:
                f.write(f"  v{m.view_1_id} -- v{m.view_2_id} "
                        f"[label=\"{len(m.matches)}\"];\n")
            f.write("}\n")
        print(f"Wrote matching graph to {args.graph_mode}")
        return 0
    n_feats = [len(vp.positions) for vp in viewports]
    print(f"Viewports: {len(viewports)}")
    print(f"Features: total {sum(n_feats)}, "
          f"min {min(n_feats, default=0)}, max {max(n_feats, default=0)}, "
          f"mean {np.mean(n_feats) if n_feats else 0:.1f}")
    print(f"Matched pairs: {len(matching)}")
    if matching:
        counts = [len(m.matches) for m in matching]
        print(f"Matches per pair: min {min(counts)}, max {max(counts)}, "
              f"mean {np.mean(counts):.1f}")
        for m in matching[:20]:
            print(f"  pair ({m.view_1_id}, {m.view_2_id}): {len(m.matches)} matches")
        if len(matching) > 20:
            print(f"  ... and {len(matching) - 20} more pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
