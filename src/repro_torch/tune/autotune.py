"""The autotuner: measure candidate execution configs, persist the winner.

A copy of the JAX package's ``tune/autotune.py`` for the port.  Three
staged sweeps, each timing the *real* code path: ``compile_table`` with a
fresh ``CompilerSession`` per measurement (so nothing is answered from a
warm cache), and the fused kernel's wrapper ``ppa_fused_apply``:

  1. (search backend × speculation depth) over a small compile grid —
     ``numpy`` on the host and ``torch`` (``TorchSearchBackend``) on the
     card, or on the CPU when asked for;
  2. ``TorchSearchBackend``'s padding floors (``K_FLOOR``/``G_FLOOR``/
     ``BATCH_ELEMS``), only when ``torch`` won stage 1;
  3. the fused kernel's launch shape (threads a block, blocks an SM), the
     counterpart of the reference's Pallas block: device ms a launch
     (CUDA events over a CUDA graph of back-to-back launches, repeats
     interleaved across candidates) at the served model's two fused
     shapes; the least median sum wins only by more than the spread of
     its repeats and the default's, else the default is kept; every
     candidate's output must equal the plain version's bit for bit.
     Where the tuned device is not a card there is no kernel to time,
     and the default shape is recorded.

The winner is persisted device-keyed next to the ``TableStore``
(:func:`repro_torch.tune.config.save_tuned`), where ``compile_or_load``
and ``ServeEngine(table_store=...)`` resolve it.  Every candidate is an
execution knob: the compiled tables are compared by ``table_identity``
across candidates, so a tuning run doubles as a bit-identity check.

CLI::

    python -m repro_torch.tune.autotune --store DIR [--smoke] [--verify]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..compiler.compile import CompilerSession, compile_table, table_identity
from ..core.datapath import FWLConfig
from ..core.schemes import PPAScheme
from ..core.searchspace import TorchSearchBackend
from ..kernels.fused import DEFAULT_LAUNCH, LAUNCH_CANDIDATES

from .config import TunedConfig, device_key, save_tuned

__all__ = ["autotune", "main"]

#: compile grid the candidates are timed on.  Smoke: two order-1 7-bit
#: NAFs (seconds).  Full: adds an order-2 point so floor tuning sees the
#: dispatch shapes that dominate real sweeps.
_CFG1 = FWLConfig(7, 7, (7,), (7,), 7)
_CFG2 = FWLConfig(7, 7, (7, 7), (7, 7), 7)
_SMOKE_GRID = [("sigmoid", _CFG1), ("tanh", _CFG1)]
_FULL_GRID = _SMOKE_GRID + [("gelu_inner", _CFG1), ("sigmoid", _CFG2)]

_SCHEME = PPAScheme(1, None, "fqa")

#: stage 3's inputs: the served model's SwiGLU gate (internlm2-1.8b, bf16
#: into the gated sigmoid_wide-16 table) at decode (4 slots x 1 token) and
#: at a prefill group of 4 x 128 tokens
FUSED_TABLE = ("sigmoid_wide", 16)
FUSED_SHAPES = {"decode": (4, 1, 8192), "prefill": (512, 8192)}
#: stage 3's candidates with ``smoke``
_SMOKE_LAUNCHES = ((128, 4), (256, 4))


def _time_compile_grid(grid, *, backend, speculate, repeats: int
                       ) -> Tuple[float, List[dict]]:
    """Median wall seconds to compile the grid cold (fresh session each
    repeat — the autotuner times compiles, not cache hits).  ``backend``
    is a name, or a zero-argument callable that makes a fresh instance."""
    times = []
    tables = None
    for _ in range(repeats):
        session = CompilerSession()
        be = backend() if callable(backend) else backend
        t0 = time.perf_counter()
        tabs = [compile_table(naf, cfg, _SCHEME, session=session,
                              search_backend=be, speculate=speculate)
                for naf, cfg in grid]
        if isinstance(be, TorchSearchBackend) and be.device.type == "cuda":
            import torch
            torch.cuda.synchronize(be.device)
        times.append(time.perf_counter() - t0)
        tables = tabs
    times.sort()
    return times[len(times) // 2], [table_identity(t) for t in tables]


def fused_launch_times(candidates: Sequence[Tuple[int, int]], dev, *,
                       repeats: int = 5, iters: int = 100
                       ) -> Dict[Tuple[int, int], Dict[str, List[float]]]:
    """{launch: {shape label: [device ms a launch, one a repeat]}} of the
    fused kernel at each of ``candidates`` on ``FUSED_SHAPES`` (inputs
    N(0, 4) from seed 0).  A repeat is one replay of a CUDA graph of
    ``iters`` launches, captured with that launch as the process default
    (the default in force before is restored).  The repeats are
    interleaved across the candidates, in an order rotated each round, so
    drift over the run falls on all of them alike.  Raises unless every
    candidate's output equals the plain version's bit for bit."""
    import torch

    from ..kernels import fused
    from ..kernels.ops import pack_table
    from ..tables import load_table

    tc = pack_table(load_table(*FUSED_TABLE), dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = {label: (torch.randn(shape, generator=gen, device=dev) * 4.0
                  ).to(torch.bfloat16)
          for label, shape in FUSED_SHAPES.items()}
    graphs = {}
    before = fused.default_launch()
    try:
        for launch in candidates:
            fused.set_default_launch(launch)
            for label, x in xs.items():
                got = fused.ppa_fused_apply(tc, x, True)
                if not torch.equal(got, fused.ppa_fused_plain(tc, x, True)):
                    raise AssertionError(
                        f"fused launch {launch} changed the output at "
                        f"{label} {tuple(x.shape)}: launch shapes must be "
                        f"bit-neutral")
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(iters):
                        fused.ppa_fused_apply(tc, x, True)
                graph.replay()
                graphs[launch, label] = graph
    finally:
        fused.set_default_launch(before)
    out = {launch: {label: [] for label in xs} for launch in candidates}
    order = list(candidates)
    for r in range(repeats):
        k = r % len(order)
        for launch in order[k:] + order[:k]:
            for label in xs:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graphs[launch, label].replay()
                end.record()
                end.synchronize()
                out[launch][label].append(start.elapsed_time(end) / iters)
    return out


def _median(values: Sequence[float]) -> float:
    return sorted(values)[len(values) // 2]


def pick_launch(sums: Dict[Tuple[int, int], List[float]]
                ) -> Tuple[Tuple[int, int], float, float]:
    """(winner, margin, spread) from each launch's summed time a repeat.

    The candidate with the least median sum wins only where it beats
    ``DEFAULT_LAUNCH``'s median by more than the spread (max - min) of
    either one's repeats; otherwise the default is kept, since a shape
    that wins within the noise would be a pick that no measurement backs.
    ``margin`` is the default's median less the best's."""
    best = min(sums, key=lambda lc: (_median(sums[lc]),
                                     lc != DEFAULT_LAUNCH))
    margin = _median(sums[DEFAULT_LAUNCH]) - _median(sums[best])
    spread = max(max(sums[lc]) - min(sums[lc])
                 for lc in (DEFAULT_LAUNCH, best))
    return (best if margin > spread else DEFAULT_LAUNCH), margin, spread


def tune_fused_launch(dev, candidates: Sequence[Tuple[int, int]],
                      score: Dict[str, float], *, repeats: int = 5,
                      log=print) -> Tuple[int, int]:
    """Stage 3: the fused kernel's launch shape on the card ``dev``, by
    :func:`pick_launch` over each candidate's summed device time on
    ``FUSED_SHAPES`` (the default is always timed).  Each median lands in
    ``score`` (``fused_ms/<threads>x<blocks>/<shape>``), with the best
    candidate's margin over the default and the spread it had to beat
    (``fused_margin_ms``, ``fused_spread_ms``).  Off a card there is no
    kernel to time: the default is returned."""
    if dev is None or dev.type != "cuda":
        log(f"[tune] stage 3: no card ({dev or 'none'}), so no fused "
            f"kernel to time; recording the default launch "
            f"{DEFAULT_LAUNCH[0]}x{DEFAULT_LAUNCH[1]}")
        return DEFAULT_LAUNCH
    launches = tuple(dict.fromkeys((DEFAULT_LAUNCH, *candidates)))
    times = fused_launch_times(launches, dev, repeats=repeats)
    sums = {}
    for launch, by_shape in times.items():
        tag = f"{launch[0]}x{launch[1]}"
        sums[launch] = [sum(rep) for rep in zip(*by_shape.values())]
        for label, ms in by_shape.items():
            score[f"fused_ms/{tag}/{label}"] = round(_median(ms), 6)
        log(f"[tune] fused launch {tag}: " + ", ".join(
            f"{label} {_median(ms) * 1e3:.3f} us"
            for label, ms in by_shape.items())
            + f" (sum {_median(sums[launch]) * 1e3:.3f} us, repeats "
            f"{min(sums[launch]) * 1e3:.3f}-{max(sums[launch]) * 1e3:.3f};"
            f" output equal to the plain version's)")
    winner, margin, spread = pick_launch(sums)
    score["fused_margin_ms"] = round(margin, 6)
    score["fused_spread_ms"] = round(spread, 6)
    log(f"[tune] fused launch winner {winner[0]}x{winner[1]}: the best "
        f"candidate beats the default {DEFAULT_LAUNCH[0]}x"
        f"{DEFAULT_LAUNCH[1]} by {margin * 1e3:.3f} us against a spread of "
        f"{spread * 1e3:.3f} us"
        + ("" if winner != DEFAULT_LAUNCH or margin <= 0 else
           " (within the noise: the default is kept)"))
    return winner


def autotune(root: "str | Path | None" = None, *, smoke: bool = False,
             repeats: Optional[int] = None, device=None,
             log=print) -> TunedConfig:
    """Measure the candidate configs and return (and persist) the winner.

    ``root=None`` measures without persisting.  ``smoke`` shrinks every
    stage to a seconds-scale run; the knobs it skips keep their defaults.
    ``device``: where the ``torch`` candidates scan (None: the card; where
    there is none, only ``numpy`` is tuned).
    """
    repeats = repeats if repeats is not None else (1 if smoke else 3)
    grid = _SMOKE_GRID if smoke else _FULL_GRID
    score: Dict[str, float] = {}

    backends = {"numpy": "numpy"}
    dev = None
    try:
        dev = TorchSearchBackend(device).device
        backends["torch"] = lambda: TorchSearchBackend(dev)
    except Exception as e:
        log(f"[tune] torch search backend unavailable ({e}); "
            f"tuning numpy only")
    speculates = [0, 3]

    # stage 1 — search backend × speculation depth
    best: Tuple[float, str, int] = (float("inf"), "numpy", 0)
    identity = None
    for name, backend in backends.items():
        for spec in speculates:
            wall, ident = _time_compile_grid(grid, backend=backend,
                                             speculate=spec,
                                             repeats=repeats)
            score[f"compile_s/{name}/spec{spec}"] = round(wall, 4)
            log(f"[tune] backend={name} speculate={spec}: {wall:.3f}s")
            if identity is None:
                identity = ident
            elif ident != identity:
                raise AssertionError(
                    f"tuning candidate backend={name} speculate={spec} "
                    f"changed the compiled tables — execution knobs must "
                    f"be bit-neutral")
            if wall < best[0]:
                best = (wall, name, spec)
    _, backend, speculate = best
    score["winner/backend_spec"] = best[0]

    # stage 2 — the torch backend's padding floors (only when it won)
    k_floor, g_floor, batch_elems = 64, 32, 1 << 23
    if backend == "torch":
        floor_grid: Sequence[Tuple[int, int, int]] = (
            [(32, 32, 1 << 23), (64, 32, 1 << 23)] if smoke else
            [(32, 16, 1 << 23), (32, 32, 1 << 23), (64, 32, 1 << 23),
             (64, 32, 1 << 21), (128, 32, 1 << 23), (64, 64, 1 << 23)])
        floor_best = (float("inf"), (k_floor, g_floor, batch_elems))
        for kf, gf, be in floor_grid:
            def make(kf=kf, gf=gf, be=be):
                return TorchSearchBackend(dev, k_floor=kf, g_floor=gf,
                                          batch_elems=be)
            wall, ident = _time_compile_grid(grid, backend=make,
                                             speculate=speculate,
                                             repeats=repeats)
            score[f"compile_s/torch/K{kf}-G{gf}-B{be}"] = round(wall, 4)
            log(f"[tune] floors K{kf}/G{gf}/B{be}: {wall:.3f}s")
            if ident != identity:
                raise AssertionError(
                    f"floor candidate K{kf}/G{gf}/B{be} changed the "
                    f"compiled tables — padding must be bit-neutral")
            if wall < floor_best[0]:
                floor_best = (wall, (kf, gf, be))
        k_floor, g_floor, batch_elems = floor_best[1]

    # stage 3 — the fused kernel's launch shape (on a card only)
    fused_launch = tune_fused_launch(
        dev, _SMOKE_LAUNCHES if smoke else LAUNCH_CANDIDATES, score,
        repeats=max(repeats, 3), log=log)

    # a config is keyed by the device its torch candidates scanned on
    key = "cpu/host" if dev is not None and dev.type == "cpu" \
        else device_key()
    cfg = TunedConfig(device=key, search_backend=backend, speculate=speculate,
                      k_floor=k_floor, g_floor=g_floor,
                      batch_elems=batch_elems, fused_launch=fused_launch,
                      score=score)
    log(f"[tune] winner: {cfg.summary()}")
    if root is not None:
        path = save_tuned(cfg, root)
        log(f"[tune] persisted {path}")
    return cfg


def verify(root: Path, cfg: TunedConfig, log=print) -> None:
    """Round-trip + pickup assertions: the persisted config reloads equal,
    ``compile_or_load`` picks it up, and the tuned compile's artifact is
    the untuned one's."""
    from ..compiler.store import TableStore

    from .config import load_tuned, resolve_tuned

    reloaded = load_tuned(root, cfg.device)
    assert reloaded == cfg, (
        f"persisted config did not round-trip:\n{reloaded}\n!=\n{cfg}")
    assert resolve_tuned(root) == cfg
    store = TableStore(root)
    naf, fcfg = _SMOKE_GRID[0]
    tuned_tab = store.compile_or_load(naf, fcfg, _SCHEME)
    assert store.tuned_applied >= 1, (
        "compile_or_load did not pick up the persisted tuned config")
    # tuned execution must not move the artifact: compare against an
    # untuned compile of the same job
    untuned = compile_table(naf, fcfg, _SCHEME, search_backend="numpy",
                            speculate=0)
    assert table_identity(tuned_tab) == table_identity(untuned), (
        "tuned compile produced a different artifact")
    log(f"[tune] verify OK: round-trip + compile_or_load pickup "
        f"(tuned_applied={store.tuned_applied})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", type=Path, default=None,
                    help="store root to persist the config next to "
                         "(default: measure only, do not persist)")
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale shape")
    ap.add_argument("--repeats", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="where the torch candidates scan (default: the "
                         "card; 'cpu' to tune on the host)")
    ap.add_argument("--verify", action="store_true",
                    help="after tuning, assert the persisted config "
                         "round-trips and is picked up by compile_or_load "
                         "(requires --store)")
    args = ap.parse_args(argv)
    if args.verify and args.store is None:
        ap.error("--verify requires --store")
    cfg = autotune(args.store, smoke=args.smoke, repeats=args.repeats,
                   device=args.device)
    if args.verify:
        verify(args.store, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
