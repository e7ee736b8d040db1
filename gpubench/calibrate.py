"""The readings a cell's correctness limits are set from, on the card:

    python gpubench/calibrate.py --workload <cell> --seeds 1 2 3 ...

For every seed, in one process, without a measured window: the program's
readings (its set-up against the reference), the reference's against a
second run of itself (training: the floor that the card's unordered sums
set), the control's (the reference
computed with TF32 products in the program's place, against the reference in
float32), and the planted faults' (training: half of the batch's target
notes left out of the loss, the mean taken over the rest, in the reference
put in the program's place; serving: one served id moved off the best
class).  A state left unchanged reads 1 by the change measure and needs no
run.  One JSON line a seed on standard output.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_ROOT = Path(__file__).resolve().parents[1]
if str(BENCH_ROOT) not in sys.path:
    sys.path.insert(0, str(BENCH_ROOT))


def half_batch(weight):
    """The fault "half of the batch left out": every second target row's
    weight set to 0, so the means run over the rest."""
    w = weight.clone()
    w[1::2] = 0.0
    return w


def train_readings(run):
    from gpubench.harness import checks

    reference = run.reference()
    return {
        "program": checks.train_readings(run.checked, reference),
        "reference_again": checks.train_readings(run.reference(), reference),
        "control_tf32": checks.train_readings(run.reference(tf32=True), reference),
        "fault_half_batch": checks.train_readings(run.reference(weight_fn=half_batch), reference),
    }


def serve_readings(run, served):
    import numpy as np

    from gpubench.reference import decode as ref_decode
    from gpubench.reference import model as ref_model

    params = run.reference_params()
    out = {k: {"logit_gap": 0.0, "prob_gap": 0.0} for k in ("program", "control_tf32", "fault_altered_id")}

    def take(kind, gaps):
        for k, v in gaps.items():
            out[kind][k] = max(out[kind][k], v)

    for item, ids in served.items():
        with ref_model.precision(False):
            ref = run.reference_scores(item, params)
        with ref_model.precision(True):
            control = run.reference_scores(item, params)
        take("program", ref_decode.gaps(ref, ids))
        take("control_tf32", ref_decode.gaps(ref, {k: v.argmax(-1).numpy() for k, v in control.items()}))
        altered = {k: np.array(v) for k, v in ids.items()}
        for k in ("localkey", "quality"):  # one logit task and one RNA key, each moved off its best class at one note
            best = ref[k][0].argmax()
            altered[k][0] = int((best + 1) % ref[k].shape[1])
        take("fault_altered_id", ref_decode.gaps(ref, altered))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from gpubench.harness.manifest import load_cell, load_driver

    cell = load_cell(args.workload, BENCH_ROOT)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    driver = load_driver(cell.traffic)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t0 = time.perf_counter()
        run = driver.setup(cell, seed, device)
        if cell.traffic["driver"] == "serve":
            served = {i: run._serve(i) for i in range(len(run.pool))}
            run.release()
            readings = serve_readings(run, served)
        else:
            run.release()
            readings = train_readings(run)
        print(json.dumps({"workload": cell.name, "seed": seed, "seconds": time.perf_counter() - t0, **readings}),
              flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
