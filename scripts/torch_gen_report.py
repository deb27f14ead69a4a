"""The dry-run, roofline and collective-mix tables of the port's dry run.

Counterpart of ``scripts/gen_report.py``, over the records of
``python -m repro_torch.launch.dryrun`` (``artifacts/dryrun_torch/``), in
the same markdown.  Its "compile s" column is the seconds the counted step
took (``t_compile_s``).  The framework-headline section is left out: it
reads ``BENCH_*.json``, which the port's benchmarks do not write yet.  The
certificate table reads the port's own store
(``artifacts/ppa_tables_torch/*.cert.json``).

  python scripts/torch_gen_report.py [--variant baseline] [--dir DIR]
      [--merged]

``--merged`` prints the same figures as one table instead: a row a cell,
its pod and multipod dry-run columns side by side, then its single-pod
roofline and collective mix.
"""

import argparse
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ART = ROOT / "artifacts" / "dryrun_torch"
CERTS = ROOT / "artifacts" / "ppa_tables_torch"


def fmt_bytes(b):
    return f"{b / 2**30:.2f}"


def load(variant="baseline"):
    recs = {}
    for f in sorted(ART.glob("*.json")):
        r = json.loads(f.read_text())
        parts = f.stem.split("__")
        vtag = parts[3] if len(parts) > 3 else "baseline"
        if vtag != variant:
            continue
        pod = "multipod" if "multipod" in f.stem else "pod"
        recs[(r["arch"], r["shape"], pod)] = r
    return recs


def cert_table():
    """Per-config bit-width certificates stored next to the port's
    compiled tables: proven integer word lengths and the overflow-freedom
    verdict for each artifact."""
    rows = []
    for f in sorted(CERTS.glob("*.cert.json")):
        try:
            c = json.loads(f.read_text())
        except (OSError, ValueError):
            continue
        nodes = c.get("nodes", [])
        if not nodes:
            continue
        widest = max(nodes, key=lambda n: n.get("bits", 0))
        rows.append((c.get("naf", "?"), c.get("scheme_tag", "?"),
                     max(n.get("iwl", 0) for n in nodes),
                     widest.get("bits", 0), widest.get("name", "?"),
                     "ok" if not c.get("violations") else "OVERFLOW"))
    if not rows:
        return
    print("\n### Bit-width certificates (proven, per segment)\n")
    print("| naf | scheme | max IWL | max bits | widest node | verdict |")
    print("|---|---|---|---|---|---|")
    for naf, tag, iwl, bits, node, verdict in sorted(rows):
        print(f"| {naf} | {tag} | {iwl} | {bits} | {node} | {verdict} |")


_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
          "collective-permute")


def merged(recs):
    """One row a cell: its pod and multipod dry-run figures side by side,
    then its single-pod roofline and collective mix (GiB)."""
    cells = sorted({(a, s) for a, s, _ in recs})
    skips = [(a, s) for a, s in cells
             if recs.get((a, s, "pod"), {}).get("status") == "skip"]
    kinds = [k for k in _KINDS if any(
        r.get("roofline", {}).get("coll_bytes", {}).get(k)
        for r in recs.values())]
    print("### Dry run (pod / multipod) and roofline (pod)\n")
    print("| arch | shape | params | count s | args GiB/dev | peak GiB/dev "
          "| t_comp s | t_mem s | t_coll s | bottleneck | useful/HLO | "
          "roofline frac | " + " | ".join(f"{k} GiB" for k in kinds) + " |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|"
          + "---|" * len(kinds))
    for a, s in cells:
        pair = [recs.get((a, s, p)) for p in ("pod", "multipod")]
        if any(r is None or r.get("status") == "skip" for r in pair):
            continue
        secs = " / ".join(f"{r['t_compile_s']:.0f}" for r in pair)
        args = " / ".join(fmt_bytes(r["memory"]["argument_bytes"])
                          for r in pair)
        peak = " / ".join(fmt_bytes(r["memory"]["peak_bytes_per_device"])
                          for r in pair)
        rl = pair[0]["roofline"]
        coll = " | ".join(f"{rl['coll_bytes'].get(k, 0) / 2**30:.2f}"
                          for k in kinds)
        print(f"| {a} | {s} | {pair[0]['n_params']/1e9:.2f}B | {secs} | "
              f"{args} | {peak} | {rl['t_compute']:.3f} | "
              f"{rl['t_memory']:.3f} | {rl['t_collective']:.3f} | "
              f"{rl['bottleneck']} | {rl['useful_flops_ratio']:.2f} | "
              f"{rl['roofline_fraction']:.3f} | {coll} |")
    if skips:
        reason = recs[skips[0] + ("pod",)]["reason"]
        print(f"\nSkipped on both meshes ({reason}): "
              + ", ".join(f"{a} x {s}" for a, s in skips) + ".")
    others = [k for k in _KINDS if k not in kinds]
    if others:
        print(f"No cell moved {', '.join(others)} bytes.")


def main(argv=None):
    global ART
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--merged", action="store_true",
                    help="one table: pod beside multipod, then the "
                         "roofline and the collective mix")
    ap.add_argument("--dir", default=None,
                    help="records' directory (default artifacts/"
                         "dryrun_torch/)")
    args = ap.parse_args(argv)
    if args.dir:
        ART = Path(args.dir)
    recs = load(args.variant)
    if args.merged:
        merged(recs)
        return

    print("### Dry-run table (variant:", args.variant + ")\n")
    print("| arch | shape | mesh | status | params | compile s | "
          "args GiB/dev | peak GiB/dev |")
    print("|---|---|---|---|---|---|---|---|")
    for (arch, shape, pod), r in sorted(recs.items()):
        if r.get("status") == "skip":
            print(f"| {arch} | {shape} | {pod} | SKIP ({r['reason'][:45]}…)"
                  " | | | | |")
            continue
        m = r["memory"]
        print(f"| {arch} | {shape} | {pod} | ok | "
              f"{r['n_params']/1e9:.2f}B | {r['t_compile_s']:.0f} | "
              f"{fmt_bytes(m.get('argument_bytes', 0))} | "
              f"{fmt_bytes(m.get('peak_bytes_per_device', 0))} |")

    print("\n### Roofline table (single-pod, per step)\n")
    print("| arch | shape | t_comp s | t_mem s | t_coll s | bottleneck | "
          "useful/HLO | roofline frac | one-line fix |")
    print("|---|---|---|---|---|---|---|---|---|")
    fixes = {
        "memory": "cut PPA elementwise traffic (LUT path) / fuse scores",
        "collective": "reshard (kvseq) / overlap collectives",
        "compute": "already compute-bound: raise MXU util",
    }
    for (arch, shape, pod), r in sorted(recs.items()):
        if pod != "pod" or r.get("status") == "skip":
            continue
        rl = r["roofline"]
        print(f"| {arch} | {shape} | {rl['t_compute']:.3f} | "
              f"{rl['t_memory']:.3f} | {rl['t_collective']:.3f} | "
              f"{rl['bottleneck']} | {rl['useful_flops_ratio']:.2f} | "
              f"{rl['roofline_fraction']:.3f} | {fixes[rl['bottleneck']]} |")

    print("\n### Collective mix (single-pod)\n")
    print("| arch | shape | all-gather GiB | all-reduce GiB | "
          "reduce-scatter GiB | all-to-all GiB | permute GiB |")
    print("|---|---|---|---|---|---|---|")
    for (arch, shape, pod), r in sorted(recs.items()):
        if pod != "pod" or r.get("status") == "skip":
            continue
        cb = r["roofline"]["coll_bytes"]
        cols = [cb.get(k, 0) / 2**30 for k in
                ("all-gather", "all-reduce", "reduce-scatter",
                 "all-to-all", "collective-permute")]
        print(f"| {arch} | {shape} | " +
              " | ".join(f"{c:.2f}" for c in cols) + " |")

    print("\n(Framework bench headlines: left out; the port's benchmarks "
          "write no BENCH_*.json yet.)")
    cert_table()


if __name__ == "__main__":
    main()
