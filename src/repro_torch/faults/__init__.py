"""repro_torch.faults — deterministic failpoint registry.

``failpoint("tier.site")`` calls sit in the table store and the batch
compiler under the JAX package's names (``compile.job``,
``compile.job.done``, ``store.load.read``, ``store.put.before_rename``,
``store.merge.file``); they are inert (one global-bool check) until armed
via ``REPRO_TORCH_FAILPOINTS`` or :func:`arm`/:func:`arm_spec`, after
which each evaluation fires per a deterministic policy (raise /
process-exit / latency / ledger-count).  See :mod:`.registry` for the spec
grammar.
"""

from .registry import (ENV, LEDGER_ENV, SEED_ENV, InjectedFault, arm,
                       arm_spec, disarm, failpoint, fired, reset,
                       set_ledger, snapshot, wrap)

__all__ = ["InjectedFault", "failpoint", "wrap", "arm", "arm_spec",
           "disarm", "reset", "fired", "snapshot", "set_ledger",
           "ENV", "SEED_ENV", "LEDGER_ENV"]
