"""The autotuner: measure candidate execution configs, persist the winner.

A copy of the JAX package's ``tune/autotune.py`` for the port.  Two staged
sweeps, each timing the *real* compile path (``compile_table`` with a
fresh ``CompilerSession`` per measurement, so nothing is answered from a
warm cache):

  1. (search backend × speculation depth) over a small compile grid —
     ``numpy`` on the host and ``torch`` (``TorchSearchBackend``) on the
     card, or on the CPU when asked for;
  2. ``TorchSearchBackend``'s padding floors (``K_FLOOR``/``G_FLOOR``/
     ``BATCH_ELEMS``), only when ``torch`` won stage 1.

The CUDA kernels fix their launch shapes when they are built, so the
reference's third stage (a Pallas block shape) has no counterpart yet.
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

    # a config is keyed by the device its torch candidates scanned on
    key = "cpu/host" if dev is not None and dev.type == "cpu" \
        else device_key()
    cfg = TunedConfig(device=key, search_backend=backend, speculate=speculate,
                      k_floor=k_floor, g_floor=g_floor,
                      batch_elems=batch_elems, score=score)
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
