"""Quickstart on the PyTorch port: compile an FQA table, run it through the
hardware datapath, price it with the calibrated cost model, and drop it
into a model.

The table compiles on the host (the port's numpy compiler).  The float
path and the activation run on ``--device`` (default: the card) through
the fused CUDA kernel (``cuda_fused``; its plain version on a CPU tensor).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (FWLConfig, PPAScheme, compile_ppa_table,
                              estimate_cost, table_mae_report)
from repro_torch.device import resolve_device
from repro_torch.kernels import make_ppa_fn, pack_table, ppa_apply

BACKEND = "cuda_fused"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the float path and the activation run "
                         "(default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. Compile the paper's 8-bit sigmoid design point: FQA-O1, 18 segments
    cfg = FWLConfig(w_in=8, w_out=8, w_a=(7,), w_o=(8,), w_b=8)
    table = compile_ppa_table("sigmoid", cfg, PPAScheme(order=1,
                                                        quantizer="fqa"))
    print(f"sigmoid FQA-O1: {table.num_segments} segments "
          f"(paper: 18), MAE_hard={table.mae_hard:.3e} "
          f"(paper: 1.953e-3), MAE_0={table.stats['mae0']}")

    # 2. Verify against the exact function through the float path
    tc = pack_table(table, dev)
    x = torch.linspace(-0.99, 0.99, 512, device=dev)
    y = ppa_apply(tc, x, backend=BACKEND)   # fixed-point datapath inside
    err = float((torch.sigmoid(x) - y).abs().max())
    print(f"float-path max error vs exact sigmoid: {err:.3e}")

    # 3. Price it (unit-gate model calibrated on the paper's DC tables)
    cost = estimate_cost(table)
    print(f"estimated area {cost.area_um2:.0f} um^2 "
          f"(paper: 1581.2), power {cost.power_mw:.3f} mW, "
          f"delay {cost.delay_ns:.2f} ns, LUT {cost.lut_bits} bits")

    # 4. Use it as a model activation (all ten assigned archs accept
    #    act_impl="ppa"/"ppa8" — see examples/torch_serve_lm.py)
    act = make_ppa_fn(table, BACKEND, dev)
    h = act(torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (4, 8)).astype(np.float32)).to(dev))
    finite = bool(torch.isfinite(h).all())
    print(f"activation output shape {tuple(h.shape)}, finite: {finite}")
    report = table_mae_report(table)
    print("report:", report)
    return {"table": table, "err": err, "cost": cost, "finite": finite,
            "report": report}


if __name__ == "__main__":
    main()
