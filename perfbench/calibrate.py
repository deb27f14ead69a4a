#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds <n> ... [--control-seeds <n> ...] [--fault-seeds <n> ...]

For each of ``--seeds`` it runs the cell as a run does (set-up, a window of
``--seconds``, the check) and prints the program's compared numbers; for
those also in ``--control-seeds``, the control's too: the reference in
float8 put in the program's place (training: its first steps from the same
weights and batches; serving: the tokens it puts first at each position of
the sequences that run served).  For those in ``--fault-seeds`` (training)
also the readings of a planted fault, the reference on half of each
batch.  A state left unchanged reads 1 on ``grad_gap`` and ``change_gap``
and needs no run.  One JSON line a seed; the benchmark's own runs never
run the control.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, seconds: float, control: bool, device,
             fault: bool = False) -> dict:
    """A run's set-up, window and check for ``seed``: the program's
    compared numbers and, with ``control``, the control's; with ``fault``
    (training) those of the reference on half of each batch."""
    from perfbench.harness.checks import train_numbers
    from perfbench.harness.main import _runner
    from perfbench.reference.model import Precision

    drv = _runner(cell)(cell, seed, device)
    drv.setup()
    drv.window(seconds)
    drv.release()
    out = {"workload": cell.name, "seed": seed}
    if drv.kind == "train":
        ref = drv.reference()
        out["program"] = train_numbers(drv.program_readings(), ref)
        if control:
            out["control"] = train_numbers(
                drv.reference(Precision("fp8")), ref)
        if fault:
            out["half_batch"] = train_numbers(
                drv.reference(rows=cell.traffic["batch"] // 2), ref)
    else:
        out["program"] = drv.numbers()
        out["tokens_compared"] = drv.compared_tokens
        if control:
            out["control"] = drv.numbers(control=True)
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args()
    sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]
    import gc

    import torch

    from perfbench.harness.spec import load_cell
    from repro_torch.kernels.build import build_all

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = load_cell(args.workload)
    build_all(("ppa_fused", "softmax_ppa"))
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = readings(cell, seed, args.seconds, seed in args.control_seeds,
                       dev, seed in args.fault_seeds)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
