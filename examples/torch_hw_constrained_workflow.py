"""The paper's hardware-constrained PPA workflow (Fig. 7) on the PyTorch
port: silicon fixes the segment capacity SEG_t; the flow finds the
minimum-MAE coefficient set that fills it, then deploys it as an
activation through the port's CUDA kernels.

The candidate scan runs on ``--device`` (default: the card) through
``TorchSearchBackend``.  One :class:`CompilerSession` shares every window
fit across the MAE_t binary search, and the winner lands in a
content-addressed store, so a later resolution is a hit with no segment
evaluation.  The deployment packs the table onto the device
(``pack_table``) and runs ``ppa_apply`` on ``cuda_fused`` (its plain
version on a CPU tensor).

  PYTHONPATH=src python examples/torch_hw_constrained_workflow.py --seg-t 16
  PYTHONPATH=src python examples/torch_hw_constrained_workflow.py \\
      --device cpu --store $(mktemp -d)
"""

import argparse

import torch

from repro_torch.compiler import CompilerSession, TableStore, default_store
from repro_torch.core import (FWLConfig, PPAScheme, TorchSearchBackend,
                              hardware_constrained_ppa)
from repro_torch.core.functions import get_naf
from repro_torch.kernels import pack_table, ppa_apply


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--naf", default="sigmoid")
    ap.add_argument("--seg-t", type=int, default=16,
                    help="hardware segment capacity")
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="where the scan and the deployment run "
                         "(default: the card)")
    ap.add_argument("--store", default=None,
                    help="table store directory (default: "
                         "$REPRO_TORCH_TABLE_CACHE or "
                         "artifacts/ppa_tables_torch)")
    args = ap.parse_args()

    backend = TorchSearchBackend(args.device)
    dev = backend.device
    cfg = FWLConfig(w_in=8, w_out=8, w_a=(8,) * args.order,
                    w_o=(8,) * args.order, w_b=8)
    scheme = PPAScheme(order=args.order, quantizer="fqa")
    session = CompilerSession()
    res = hardware_constrained_ppa(args.naf, cfg, scheme, seg_t=args.seg_t,
                                   session=session, search_backend=backend)
    tab = res.table
    print(f"SEG_t={args.seg_t}: converged in {res.iterations} iterations "
          f"on {dev}")
    path = ", ".join(f"{m:.2e}" for m, _ in res.mae_t_path)
    print(f"  segments={tab.num_segments}  MAE_hard={tab.mae_hard:.3e}  "
          f"MAE_t path: [{path}]")
    c = session.counters()
    print(f"  compiler reuse: {c['calls']} window requests -> "
          f"{c['misses']} quantizer scans ({c['hits']} cache hits, "
          f"{c['pruned']} pruned, {c['warm_hits']} warm starts, "
          f"{c['cand_evals']} candidate evals)")

    store = TableStore(args.store) if args.store else default_store()
    # the session already holds every window fit of the winner on this
    # backend, so the compile into the store answers from its cache
    dep = store.compile_or_load(args.naf, cfg, scheme, mae_t=tab.mae_t,
                                tseg=args.seg_t, session=session,
                                search_backend=backend)
    store.compile_or_load(args.naf, cfg, scheme, mae_t=tab.mae_t,
                          tseg=args.seg_t)
    print(f"  store {store.root}: {store.stats()} (the second resolution "
          "was a pure hit)")

    tc = pack_table(dep, dev)
    x = torch.linspace(0.0, 0.999, 256, device=dev)
    y = ppa_apply(tc, x, backend="cuda_fused")
    f = torch.from_numpy(get_naf(args.naf)(x.cpu().numpy())).to(dev)
    print(f"  deployed on {dev} (cuda_fused): max|f-h| on grid = "
          f"{float((f - y.double()).abs().max()):.3e}")


if __name__ == "__main__":
    main()
