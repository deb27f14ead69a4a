"""Run the port's four examples on the card, one process each at their
default arguments (``torch_train_lm.py`` at ``--steps`` where given), and
print each one's output and wall time beside the card's name and power
limit.

The CUDA kernels are built first (and timed), so that no example's time
holds an ``nvcc`` run.  Checkpoints and metrics of the train example go to
a temporary directory, which is removed afterwards.

  PYTHONPATH=src python scripts/torch_run_examples.py [--steps 20]
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart.py", "torch_serve_lm.py", "torch_train_lm.py",
            "torch_accuracy_study.py")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="steps of torch_train_lm.py (default: its own, "
                         "120)")
    ap.add_argument("--timeout", type=int, default=900,
                    help="seconds each example may take")
    args = ap.parse_args(argv)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    print(f"card: {card()}")
    t0 = time.perf_counter()
    build = subprocess.run(
        [sys.executable, "-c", "from repro_torch.kernels.build import "
         "build_all; build_all()"], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=args.timeout)
    print(f"=== kernels built: exit {build.returncode}, "
          f"{time.perf_counter() - t0:.2f} s")
    if build.returncode:
        print(build.stderr[-4000:])
        return 1
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for name in EXAMPLES:
            cmd = [sys.executable, str(ROOT / "examples" / name)]
            if name == "torch_train_lm.py":
                cmd += ["--ckpt-dir", f"{tmp}/ckpt"]
                if args.steps:
                    cmd += ["--steps", str(args.steps)]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                                 text=True, timeout=args.timeout)
            wall = time.perf_counter() - t0
            shown = " ".join([f"examples/{name}", *cmd[2:]])
            print(f"=== {shown}: exit {out.returncode}, wall {wall:.2f} s "
                  f"({card()})")
            print(out.stdout.rstrip())
            if out.returncode:
                print(out.stderr[-4000:])
                failed += 1
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
