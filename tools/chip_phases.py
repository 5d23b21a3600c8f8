#!/usr/bin/env python3
"""Run some of ``chip_smoke.py``'s phases alone on one CUDA card.

    python tools/chip_phases.py options      # phases 36-39
    python tools/chip_phases.py efb          # phase 38
    python tools/chip_phases.py scan         # phases 40-42
    python tools/chip_phases.py algos        # phases 43-47
    python tools/chip_phases.py composite    # phases 48-50
    python tools/chip_phases.py plane        # phases 51-54

Each line carries the card's name and power limit.  Run from the
repository root; it needs one CUDA card and nvcc.  To time the training
paths in turns with another version of the package, use
``chip_smoke.py --other DIR``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def smoke():
    """``chip_smoke.py`` of this checkout as a module."""
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def main() -> None:
    import torch
    if len(sys.argv) != 2 or sys.argv[1] not in ("options", "efb", "scan",
                                                  "algos", "composite",
                                                  "plane"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("chip_phases: no CUDA device")
    cs = smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    card = f"({smi})"
    cs.log(smi)
    from h2o3_tpu_torch import native
    from h2o3_tpu_torch.frame import Frame
    if sys.argv[1] == "algos":           # no kernel of the port on their path
        cs.algo_phases(Frame, card)
        return
    from h2o3_tpu_torch.models import DRF, GridSearch
    from h2o3_tpu_torch.models.tree import gbm, hist, shared
    from h2o3_tpu_torch.models.tree.gbm import GBM
    from h2o3_tpu_torch.models.tree.xgboost import XGBoost
    native.build_all([hist.HIST, hist.SPLIT_RECORDS, hist.FINE_HIST,
                      hist.SLOT_COMPACT])
    kernels = [hist.HIST, hist.SPLIT_RECORDS, hist.SPLIT_RECORDS_ROWS,
               hist.FINE_HIST, hist.HIST_WINDOWS, hist.SLOT_COMPACT,
               hist.SPLIT_RECORDS_MONO]
    what = sys.argv[1]
    if what == "plane":                  # writes its own 10M-row CSV
        cs.plane_phases(Frame, kernels[:6], card)
        return
    if what == "composite":
        cs.log(json.dumps({"kernels": cs.composite_phases(
            Frame, kernels[:6], hist, card)}))
        return
    if what == "options":
        row, _ = cs.option_phases(Frame, XGBoost, GBM, DRF, kernels, hist,
                                  shared, gbm, card)
        cs.log(str(row))
    elif what == "scan":
        cs.scan_phases(Frame, XGBoost, GridSearch, kernels, hist, shared,
                       card)
    else:
        cols, types, domains = cs.make_airlines_like(1_000_000)
        cs.efb_phase(cols, types, domains, kernels, GBM, DRF, Frame, hist,
                     shared, card)


if __name__ == "__main__":
    main()
