"""CLI for the port's analysis layer — one entrypoint for its engines.

A port of the JAX package's ``python -m repro.analysis``, with the same
modes, report format and exit codes:

  python -m repro_torch.analysis --lint [paths...]
      AST lint over the port's hot paths (default: DEFAULT_LINT_TARGETS).
      Exit 1 on any unsuppressed finding.

  python -m repro_torch.analysis --certify-grid [--smoke] [--store DIR]
      Compile (or load) every paper-grid config through the TableStore,
      prove per-intermediate bit-width safety, and persist the stamped
      certificates next to the artifacts.  Exit 1 if any config's proof
      fails (the concrete violating interval is reported).

  python -m repro_torch.analysis --certify-config NAF [--order N]
          [--quantizer Q]
      Pre-compile envelope estimate for one (naf, default-cfg) point.

  python -m repro_torch.analysis --diff [--smoke] [--store DIR]
      Recompute certificates for every stored paper-grid artifact and
      diff them against the stored ones (drift = exit 1).

  python -m repro_torch.analysis --hlo <arch> <shape> [variant]
      The dry run's memory / collective audit of one cell (analysis/hlo.py:
      the ops OpCosts counted on the fake mesh, not HLO text).

  --json switches every engine to the JSON-lines report format.

Compiles run on the numpy search backend unless
``$REPRO_TORCH_SEARCH_BACKEND`` or a tuned config next to the store says
otherwise.
"""

from __future__ import annotations

import argparse
import sys

from .report import render

_CERT_COLUMNS = ("naf", "scheme", "segments", "max_bits", "max_iwl",
                 "widest", "carrier", "ok")


def _grid_jobs(smoke: bool):
    from ..compiler.sweep import paper_grid
    return paper_grid("smoke" if smoke else "paper")


def _store(root):
    from ..compiler.store import TableStore
    return TableStore(root) if root else TableStore()


def _cert_row(job, table, cert) -> dict:
    return {"naf": job.naf, "scheme": job.scheme.tag,
            "segments": table.num_segments if table is not None else "",
            "max_bits": cert.max_bits, "max_iwl": cert.max_iwl,
            "widest": cert.widest_node(), "carrier": cert.carrier_bits,
            "ok": cert.ok}


def cmd_lint(paths, json_mode) -> int:
    from .lint import lint_paths
    findings = lint_paths(paths or None)
    render("lint", [f.as_dict() for f in findings],
           ("path", "line", "rule", "message"), json_mode=json_mode)
    if findings and not json_mode:
        print(f"\n{len(findings)} finding(s); suppress deliberate ones with "
              "`# analysis: allow(<rule>)` + an inline justification")
    return 1 if findings else 0


def cmd_certify_grid(smoke, store_root, json_mode) -> int:
    store = _store(store_root)
    rows, bad = [], []
    for job in _grid_jobs(smoke):
        table = store.compile_or_load(
            job.naf, job.cfg, job.scheme, mae_t=job.mae_t,
            interval=job.interval, tseg=job.tseg, final_mode=job.final_mode)
        cert = store.certify(job, table)
        rows.append(_cert_row(job, table, cert))
        if not cert.ok:
            bad.extend(f"{job.naf} {job.scheme.tag}: {v.describe()}"
                       for v in cert.violations)
    render(f"certify-grid ({'smoke' if smoke else 'paper'})", rows,
           _CERT_COLUMNS, json_mode=json_mode)
    for line in bad:
        print(f"VIOLATION: {line}", file=sys.stderr)
    return 1 if bad else 0


def cmd_certify_config(naf, order, quantizer, json_mode) -> int:
    from ..core.datapath import FWLConfig
    from ..core.schemes import PPAScheme
    from .certify import certify_config
    cfg = FWLConfig(w_in=8, w_out=8, w_a=(8,) * order, w_o=(8,) * order,
                    w_b=8)
    scheme = PPAScheme(order=order, quantizer=quantizer)
    cert = certify_config(naf, cfg, scheme)
    render("certify-config (envelope estimate)",
           [_cert_row(type("J", (), {"naf": naf, "scheme": scheme})(),
                      None, cert)],
           _CERT_COLUMNS, json_mode=json_mode)
    render("assumptions", [{"assumption": a} for a in cert.assumptions],
           ("assumption",), json_mode=json_mode)
    return 0 if cert.ok else 1


def cmd_diff(smoke, store_root, json_mode) -> int:
    from .certify import certify_table
    store = _store(store_root)
    rows, drift = [], 0
    for job in _grid_jobs(smoke):
        stored = store.load_certificate(job)
        table = store.lookup(job)
        if stored is None or table is None:
            rows.append({"naf": job.naf, "scheme": job.scheme.tag,
                         "status": "missing"})
            continue
        fresh = certify_table(table, carrier_bits=stored.carrier_bits)
        fresh.meta = stored.meta
        same = fresh.to_json() == stored.to_json()
        rows.append({"naf": job.naf, "scheme": job.scheme.tag,
                     "status": "ok" if same else "DRIFT"})
        drift += 0 if same else 1
    render("certificate diff", rows, ("naf", "scheme", "status"),
           json_mode=json_mode)
    return 1 if drift else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--lint", action="store_true")
    g.add_argument("--certify-grid", action="store_true")
    g.add_argument("--certify-config", metavar="NAF")
    g.add_argument("--diff", action="store_true")
    g.add_argument("--hlo", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="7-bit grid instead of the full paper grid")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="TableStore root (default: the port's artifact "
                         "dir, $REPRO_TORCH_TABLE_CACHE)")
    ap.add_argument("--order", type=int, default=1)
    ap.add_argument("--quantizer", default="fqa")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("rest", nargs="*",
                    help="paths (--lint) or arch/shape args (--hlo)")
    args = ap.parse_args(argv)

    if args.lint:
        return cmd_lint(args.rest, args.json)
    if args.certify_grid:
        return cmd_certify_grid(args.smoke, args.store, args.json)
    if args.certify_config:
        return cmd_certify_config(args.certify_config, args.order,
                                  args.quantizer, args.json)
    if args.diff:
        return cmd_diff(args.smoke, args.store, args.json)
    if args.hlo:
        from .hlo import main as hlo_main
        return hlo_main(args.rest, json_mode=args.json)
    return 2


if __name__ == "__main__":
    sys.exit(main())
