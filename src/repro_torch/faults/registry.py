"""Deterministic failpoint registry — failure as a first-class input.

A copy of the JAX package's ``faults/registry.py`` with the same failpoint
names; its environment variables carry a ``REPRO_TORCH_`` prefix, so the
two registries are armed apart.  Any site in the store and batch tiers
may declare a named *failpoint*
by calling :func:`failpoint("tier.site", ...)`.  A failpoint is inert (a
single module-global bool check) until *armed* — via the
``REPRO_TORCH_FAILPOINTS`` environment variable or programmatically
(:func:`arm` / :func:`arm_spec` in tests) — at which point each
evaluation is counted and fires according to a deterministic policy.
Chaos runs are therefore reproducible: the same spec (plus
``REPRO_TORCH_FAULTS_SEED`` for probabilistic policies) replays the same
firing pattern bit-identically.

Spec grammar (one or more comma-separated entries)::

    REPRO_TORCH_FAILPOINTS = entry ["," entry]*
    entry  = name ":" policy [":" action]
    policy = "once" | "always" | "every=" N | "after=" N | "prob=" P
    action = "raise" | "raise=oserror" | "raise=json"
           | "exit" | "exit=" CODE | "sleep=" SECONDS | "count"

Policies (per-arm evaluation counter ``hits``):

* ``once``      fire on the 1st evaluation only
* ``always``    fire on every evaluation
* ``every=N``   fire on the Nth, 2Nth, ... evaluation
* ``after=N``   fire on every evaluation past the Nth
* ``prob=P``    fire with probability P, drawn from a ``random.Random``
  seeded by ``(REPRO_TORCH_FAULTS_SEED, name, arm-index)`` — deterministic

Actions:

* ``raise``           raise :class:`InjectedFault` (default)
* ``raise=oserror``   raise ``OSError`` — exercises transient-I/O retry
* ``raise=json``      raise ``json.JSONDecodeError`` — exercises torn-file
  handling
* ``exit[=CODE]``     ``os._exit(CODE)`` (default 86) — a hard crash that
  skips ``finally`` blocks and atexit, the honest mid-operation death the
  chaos harness injects into sweep workers
* ``sleep=S``         inject S seconds of latency, then continue
* ``count``           append one JSON line (name + payload) to the ledger
  file named by ``REPRO_TORCH_FAULTS_LEDGER`` (or :func:`set_ledger`) and
  continue — failpoints double as deterministic trace points, which is
  how the chaos harness proves exactly-once compiles

Examples::

    REPRO_TORCH_FAILPOINTS=store.put.before_rename:once
    REPRO_TORCH_FAILPOINTS=serve.decode.step:every=50,compile.job:after=1:exit
    REPRO_TORCH_FAILPOINTS=compile.job.done:always:count

The same name may be armed several times (e.g. a ``count`` trace plus an
``exit`` crash); arms are evaluated in arming order.  When nothing is
armed, :func:`failpoint` is one global-bool check — the zero-cost
contract the serving benchmarks hold it to.
"""

from __future__ import annotations

import functools
import json
import os
import random
import threading
import time
from typing import Dict, List, Optional

__all__ = ["InjectedFault", "failpoint", "wrap", "arm", "arm_spec",
           "disarm", "reset", "fired", "snapshot", "set_ledger",
           "ENV", "SEED_ENV", "LEDGER_ENV"]

ENV = "REPRO_TORCH_FAILPOINTS"
SEED_ENV = "REPRO_TORCH_FAULTS_SEED"
LEDGER_ENV = "REPRO_TORCH_FAULTS_LEDGER"

_POLICIES = ("once", "always", "every", "after", "prob")
_ACTIONS = ("raise", "exit", "sleep", "count")
_RAISE_KINDS = {
    "fault": lambda name: InjectedFault(f"injected fault at {name}"),
    "oserror": lambda name: OSError(f"injected I/O fault at {name}"),
    "json": lambda name: json.JSONDecodeError(
        f"injected torn read at {name}", doc="", pos=0),
}


class InjectedFault(RuntimeError):
    """The default fault an armed failpoint raises."""


class _Arm:
    __slots__ = ("name", "policy", "n", "p", "action", "arg",
                 "hits", "fires", "_rng")

    def __init__(self, name: str, policy: str, n: int, p: float,
                 action: str, arg: str, seed: Optional[int], index: int):
        self.name = name
        self.policy = policy
        self.n = n
        self.p = p
        self.action = action
        self.arg = arg
        self.hits = 0
        self.fires = 0
        # per-arm stream keyed by (seed, name, index): deterministic, and
        # independent of evaluation order at OTHER failpoints
        self._rng = random.Random(f"{seed}:{name}:{index}")

    def should_fire(self) -> bool:
        self.hits += 1
        if self.policy == "once":
            return self.hits == 1
        if self.policy == "always":
            return True
        if self.policy == "every":
            return self.hits % self.n == 0
        if self.policy == "after":
            return self.hits > self.n
        return self._rng.random() < self.p          # prob


_lock = threading.Lock()
_ARMED: Dict[str, List[_Arm]] = {}
_ledger_path: Optional[str] = None
#: hot-path flag — the ONLY thing an unarmed failpoint() call reads
_ACTIVE = False


def _parse_entry(entry: str, seed: Optional[int], index: int) -> _Arm:
    parts = entry.strip().split(":")
    if len(parts) < 2 or len(parts) > 3:
        raise ValueError(f"bad failpoint entry {entry!r} "
                         "(want name:policy[:action])")
    name, policy = parts[0].strip(), parts[1].strip()
    action = parts[2].strip() if len(parts) == 3 else "raise"
    if not name:
        raise ValueError(f"bad failpoint entry {entry!r}: empty name")
    n, p = 1, 1.0
    pol, _, pol_arg = policy.partition("=")
    if pol not in _POLICIES:
        raise ValueError(f"unknown failpoint policy {policy!r} "
                         f"(want one of {_POLICIES})")
    if pol == "every" or pol == "after":
        n = int(pol_arg)
        if pol == "every" and n < 1:
            raise ValueError(f"every=N needs N >= 1, got {n}")
    elif pol == "prob":
        p = float(pol_arg)
    elif pol_arg:
        raise ValueError(f"policy {pol!r} takes no argument")
    act, _, act_arg = action.partition("=")
    if act not in _ACTIONS:
        raise ValueError(f"unknown failpoint action {action!r} "
                         f"(want one of {_ACTIONS})")
    if act == "raise":
        kind = act_arg or "fault"
        if kind not in _RAISE_KINDS:
            raise ValueError(f"unknown raise kind {act_arg!r} "
                             f"(want one of {sorted(_RAISE_KINDS)})")
        act_arg = kind
    elif act == "exit":
        act_arg = str(int(act_arg) if act_arg else 86)
    elif act == "sleep":
        float(act_arg)      # validate now, not at fire time
    return _Arm(name, pol, n, p, act, act_arg, seed, index)


def arm_spec(spec: str, *, seed: Optional[int] = None) -> int:
    """Arm every entry of a ``REPRO_TORCH_FAILPOINTS``-grammar spec string.

    Entries append to (never replace) existing arms.  Returns the number
    of arms added.  ``seed`` defaults to ``$REPRO_TORCH_FAULTS_SEED`` (or 0).
    """
    global _ACTIVE
    if seed is None:
        seed = int(os.environ.get(SEED_ENV, "0"))
    added = 0
    with _lock:
        for entry in spec.split(","):
            if not entry.strip():
                continue
            arms = _ARMED.setdefault(entry.split(":", 1)[0].strip(), [])
            arms.append(_parse_entry(entry, seed, len(arms)))
            added += 1
        _ACTIVE = bool(_ARMED)
    return added


def arm(name: str, policy: str = "once", *, action: str = "raise",
        seed: Optional[int] = None) -> None:
    """Programmatically arm one failpoint (the in-test form)."""
    arm_spec(f"{name}:{policy}:{action}", seed=seed)


def disarm(name: Optional[str] = None) -> None:
    """Drop every arm on ``name`` (or on all failpoints when None)."""
    global _ACTIVE
    with _lock:
        if name is None:
            _ARMED.clear()
        else:
            _ARMED.pop(name, None)
        _ACTIVE = bool(_ARMED)


def reset() -> None:
    """Disarm everything and clear the ledger override (test teardown)."""
    global _ledger_path
    disarm()
    with _lock:
        _ledger_path = None


def set_ledger(path: Optional[str]) -> None:
    """Override the ledger file ``count`` actions append to
    (``$REPRO_TORCH_FAULTS_LEDGER`` is the cross-process form)."""
    global _ledger_path
    with _lock:
        _ledger_path = str(path) if path is not None else None


def fired(name: str) -> int:
    """Total fires across every arm of ``name`` so far."""
    with _lock:
        return sum(a.fires for a in _ARMED.get(name, ()))


def snapshot() -> Dict[str, List[Dict[str, object]]]:
    """Armed-state view for assertions: name -> per-arm counters."""
    with _lock:
        return {name: [{"policy": a.policy, "action": a.action,
                        "hits": a.hits, "fires": a.fires}
                       for a in arms]
                for name, arms in _ARMED.items()}


def _ledger() -> Optional[str]:
    return _ledger_path or os.environ.get(LEDGER_ENV) or None


def _fire(arm_: _Arm, payload: dict) -> None:
    arm_.fires += 1
    if arm_.action == "count":
        path = _ledger()
        if path:
            line = json.dumps({"fp": arm_.name, **payload}, sort_keys=True)
            # one short O_APPEND write per line: atomic enough on POSIX
            # for the chaos ledger's cross-process exactly-once audit
            with open(path, "a") as f:
                f.write(line + "\n")
        return
    if arm_.action == "sleep":
        time.sleep(float(arm_.arg))
        return
    if arm_.action == "exit":
        os._exit(int(arm_.arg))
    raise _RAISE_KINDS[arm_.arg](arm_.name)


def _eval(name: str, payload: dict) -> None:
    with _lock:
        arms = list(_ARMED.get(name, ()))
        due = [a for a in arms if a.should_fire()]
    # fire OUTSIDE the lock: actions may raise/sleep/exit, and a ledger
    # append must not serialize unrelated failpoints behind it
    for a in due:
        _fire(a, payload)


class _Guard:
    """No-op context manager / function wrapper returned by failpoint().

    The fault (if any) already fired inside the ``failpoint(...)`` call —
    i.e. at block entry for the ``with failpoint(...):`` form."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_GUARD = _Guard()


def failpoint(name: str, /, **payload) -> _Guard:
    """Evaluate the named failpoint now.

    Unarmed, this is one global-bool check.  Armed, each arm's policy
    decides whether to fire (raise / exit / sleep / ledger-count — see
    the module docstring).  ``payload`` keys land in ledger lines and
    fault messages.  Usable bare or as ``with failpoint("x"): ...``
    (fires at block entry); for the decorator form see :func:`wrap`.
    """
    if _ACTIVE:
        _eval(name, payload)
    return _GUARD


def wrap(name: str):
    """Decorator form: evaluate the failpoint on every call of ``fn``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _ACTIVE:
                _eval(name, {})
            return fn(*args, **kwargs)
        return wrapped
    return deco


# arm whatever the environment requests, once, at import: worker
# processes (sweep pools, chaos subprocesses) inherit the spec with
# their environment and need no further plumbing
if os.environ.get(ENV):
    arm_spec(os.environ[ENV])
