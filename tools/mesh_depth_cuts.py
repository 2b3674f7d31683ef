#!/usr/bin/env python3
"""What the mesh phases' depth cuts save on the card: ``chip_smoke.py``'s
phase 24 (starcoder2-3b at MESH_DENSE_LAYERS = 2, cut from 4) and phase
28 (28c's jamba-v0.1-52b at 5 layers and whisper-large-v3 at 2 + 2, cut
from 8 and 4 + 4), each run alone at the cut and the uncut depths in
turns (cut, uncut, uncut, cut), on one card.

Run from the repo root on an H100: ``python3 tools/mesh_depth_cuts.py``
(about 17 min).  The rank processes are this script again (``--mesh-rank``,
the variant in ``MESH_DEPTH_VARIANT``); every phase's gates hold as in the
whole script.  Prints each run's wall seconds and the ranks' own seconds
(``[mesh ...] the ranks' phase N`` lines), then one JSON line: per phase
and variant the wall seconds of its runs."""
from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

#: variant -> (starcoder2-3b's layers, 28c jamba's, 28c whisper's a stack)
VARIANTS = {"cut": (2, 5, 2), "uncut": (4, 8, 4)}
ORDER = ("cut", "uncut", "uncut", "cut")


def apply(variant: str) -> None:
    dense, jamba, whisper = VARIANTS[variant]
    cs.MESH_DENSE_LAYERS = dense
    depth = {"jamba-v0.1-52b": jamba, "whisper-large-v3": whisper}
    cs.MESH_FAMILY_SERVE_RUNS = tuple(
        (part, name, mesh, depth.get(name, n) if part == "28c" else n, dt)
        for part, name, mesh, n, dt in cs.MESH_FAMILY_SERVE_RUNS)


def main() -> int:
    if "--mesh-rank" in sys.argv:
        apply(os.environ["MESH_DEPTH_VARIANT"])
        return cs.main()
    cs.MESH_RANK_CMD = (sys.executable, str(Path(__file__).resolve()))
    print(cs.phase_device(), flush=True)
    cs.phase_build()
    walls: dict[str, list[float]] = {}
    for phase in ("24", "28"):
        for variant in ORDER:
            os.environ["MESH_DEPTH_VARIANT"] = variant
            apply(variant)
            t0 = time.perf_counter()
            cs.phase_mesh_layouts((phase,))
            wall = time.perf_counter() - t0
            cs.log(f"[depth cuts] phase {phase} {variant} "
                   f"{VARIANTS[variant]}: {wall:.1f} s")
            walls.setdefault(f"{phase} {variant}", []).append(round(wall, 1))
    print(json.dumps(walls), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
