"""Phase 23's gloo step times on the card with and without the per-rank
kernel check (``chip_smoke.mesh_kernel_check``) before the fit, in the
order with, without, without, with, to tell the check's effect on the
step from run-to-run host noise.  Prints each run's median step ms by
rank and mesh.

Run from the repo root on a machine with one CUDA device:
``python3 tools/mesh_step_ab.py``.
"""
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

cs.MESH_RANK_CMD = (sys.executable, __file__)
if os.environ.get("AB_NO_KCHECK") == "1":
    cs.mesh_kernel_check = lambda ctx, cfg, w, h: {}

if __name__ == "__main__":
    if "--mesh-rank" in sys.argv:
        sys.exit(cs.main())
    cs.phase_device()
    cs.phase_build()
    for variant in ("with", "without", "without", "with"):
        os.environ["AB_NO_KCHECK"] = "1" if variant == "without" else "0"
        cs.phase_mesh()
        medians = []
        for r in range(cs.MESH_WORLD):
            res = json.loads((cs.MESH_DIR / f"rank{r}.json").read_text())
            medians.append({k: sorted(v["fit"]["step_ms"])[2]
                            for k, v in res.items() if isinstance(v, dict)})
        print(f"AB {variant}: step ms medians by rank {medians}", flush=True)
