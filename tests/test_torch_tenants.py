"""The port's multi-tenant front and the engine's ``table_store=`` against
the JAX package's, on the CPU, on the smoke internlm2 config.

* a ``ppa`` + ``ppa8`` ``TenantFront`` over one seeded in-memory store
  gives the reference ``TenantFront``'s greedy tokens;
* fair share holds under ``max_active``;
* arming ``serve.tenant.warm`` or ``serve.tenant.build``, with and without
  ``fallback_exact``, degrades that one tenant and leaves the others'
  tokens and pins as a fault-free run has them;
* ``ServeEngine(table_store=...)`` equals the default engine, and reports
  the tuned config persisted next to its store.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as RCF  # noqa: E402
import repro.models as RM  # noqa: E402
import repro.serve as RS  # noqa: E402
from repro.compiler import CompileJob as RefJob  # noqa: E402
from repro.compiler import TableStore as RefStore  # noqa: E402
from repro.core import PPATable as RefPPATable  # noqa: E402
from repro.models.activations import \
    ppa_table_jobs as ref_table_jobs  # noqa: E402
from repro_torch import faults  # noqa: E402
from repro_torch.compiler import CompileJob, TableStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import TorchSearchBackend  # noqa: E402
from repro_torch.models import params_from_jax, ppa_table_jobs  # noqa: E402
from repro_torch.serve import (Request, ServeEngine,  # noqa: E402
                               TenantFront, TenantSpec)
from repro_torch.tables import load_table, table_path  # noqa: E402
from repro_torch.tune import TunedConfig, config, save_tuned  # noqa: E402

ARCH = "internlm2-1.8b"
#: (tenant, impl) of the two healthy tenants
TENANTS = (("a", "ppa"), ("b", "ppa8"))
N_REQ, MAX_NEW, N_SLOTS, CACHE_LEN = 3, 5, 2, 64


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _disarmed():
    faults.reset()
    yield
    faults.reset()


def _store() -> TableStore:
    """An in-memory port store holding the shipped 16- and 8-bit tables."""
    store = TableStore(persist=False)
    for impl in ("ppa", "ppa8"):
        for naf, cfg, scheme in ppa_table_jobs(impl):
            store.put(CompileJob(naf, cfg, scheme),
                      load_table(naf, cfg.w_out))
    return store


def _ref_store() -> RefStore:
    store = RefStore(persist=False)
    for impl in ("ppa", "ppa8"):
        for naf, cfg, scheme in ref_table_jobs(impl):
            d = json.loads(table_path(naf, cfg.w_out).read_text())
            store.put(RefJob(naf=naf, cfg=cfg, scheme=scheme),
                      RefPPATable.from_json(json.dumps({**d, "stats": {}})))
    return store


@pytest.fixture(scope="module")
def model():
    rcfg = RCF.get_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    rparams = RM.init_params(RM.param_specs(rcfg), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                             "cpu")
    return rcfg, rparams, cfg, params


def _prompts(vocab):
    """Interleaved (tenant, prompt) pairs: N_REQ a tenant, mixed lengths."""
    rng = np.random.default_rng(0)
    return [(TENANTS[i % 2][0], rng.integers(0, vocab, n).astype(np.int32))
            for i, n in enumerate((5, 9, 12, 7, 16, 4)[:2 * N_REQ])]


def _drive(front, pairs, request_cls, extra=()):
    reqs = []
    for i, (t, p) in enumerate(list(pairs) + list(extra)):
        r = request_cls(rid=i, prompt=p, max_new_tokens=MAX_NEW)
        front.submit(t, r)
        reqs.append(r)
    front.run_until_drained()
    return reqs


def _port_front(cfg, params, *, max_active=None, store=None):
    front = TenantFront(store or _store(), max_active=max_active,
                        device="cpu")
    for name, impl in TENANTS:
        front.add_tenant(TenantSpec(name, cfg.replace(act_impl=impl), params,
                                    n_slots=N_SLOTS, cache_len=CACHE_LEN))
    return front


def _outputs(reqs, tenant):
    return [r.output for r in reqs if r.tenant == tenant]


@pytest.fixture(scope="module")
def fault_free(model):
    """The port's a + b front without faults: its tokens and pins."""
    _, _, cfg, params = model
    front = _port_front(cfg, params)
    reqs = _drive(front, _prompts(cfg.vocab), Request)
    return ({t: _outputs(reqs, t) for t, _ in TENANTS},
            dict(front.store._pinned))


def test_front_matches_reference_front(model, fault_free):
    rcfg, rparams, cfg, _ = model
    rfront = RS.TenantFront(_ref_store(), max_active=None)
    for name, impl in TENANTS:
        rep = rfront.add_tenant(RS.TenantSpec(
            name, rcfg.replace(act_impl=impl), rparams, n_slots=N_SLOTS,
            cache_len=CACHE_LEN))
        assert rep["tables_pinned"] == 6 and rep["degraded"] is None
    rreqs = _drive(rfront, _prompts(cfg.vocab), RS.Request)
    want = {t: _outputs(rreqs, t) for t, _ in TENANTS}
    tokens, pins = fault_free
    assert tokens == want
    assert all(len(o) == MAX_NEW for outs in tokens.values() for o in outs)
    # one pin a key for each tenant's six tables: 12 keys, count 1 each
    assert sorted(pins.values()) == [1] * 12
    assert set(pins) == set(rfront.store._pinned)


def test_fair_share_under_max_active(model):
    """With a budget of 2 slots, each pass admits one request of each
    tenant in rotating order, never more than the budget in flight."""
    _, _, cfg, params = model
    front = _port_front(cfg, params, max_active=2)
    pairs = [(t, np.arange(1, 6, dtype=np.int32))
             for _ in range(3) for t in ("a", "a", "b")]
    for i, (t, p) in enumerate(pairs):
        front.submit(t, Request(rid=i, prompt=p, max_new_tokens=3))
    seen = []
    while not front.drained:
        front.step()
        active = {n: sum(r is not None for r in e.slot_req) + len(e.queue)
                  for n, e in front.engines.items()}
        assert sum(active.values()) <= 2
        seen.append(active)
    # a has twice b's requests queued, yet the first pass takes one of each
    assert seen[0] == {"a": 1, "b": 1}
    assert front.stats()["pending"] == {"a": 0, "b": 0}


CASES = [("serve.tenant.warm", True), ("serve.tenant.build", True),
         ("serve.tenant.build", False)]


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("site,warm", CASES)
def test_armed_failpoint_degrades_one_tenant(model, fault_free, site, warm,
                                             fallback):
    """Tenant c (``ppa``, the NAF set a pins) is admitted after a and b with
    one failpoint armed: c alone is degraded; a's and b's tokens and pins
    are the fault-free run's.  Without a fallback c's requests end
    ``tenant_degraded``; with one, c serves on exact floats."""
    _, _, cfg, params = model
    front = _port_front(cfg, params)
    faults.arm(site, "once")
    rep = front.add_tenant(TenantSpec(
        "c", cfg.replace(act_impl="ppa"), params, n_slots=N_SLOTS,
        cache_len=CACHE_LEN, fallback_exact=fallback), warm=warm)
    extra = [("c", np.arange(3, 11, dtype=np.int32)) for _ in range(2)]
    reqs = _drive(front, _prompts(cfg.vocab), Request, extra)
    assert faults.fired(site) == 1
    assert set(front.degraded) == {"c"}
    assert front.degraded["c"].startswith("fallback-exact") == fallback
    if warm:
        assert rep["degraded"] == front.degraded["c"]
    tokens, pins = fault_free
    assert {t: _outputs(reqs, t) for t, _ in TENANTS} == tokens
    assert dict(front.store._pinned) == pins
    c = [r for r in reqs if r.tenant == "c"]
    if fallback:
        assert all(r.rejected is None and len(r.output) == MAX_NEW
                   for r in c)
        assert front.engines["c"].cfg.act_impl == "exact"
        eng = ServeEngine(cfg.replace(act_impl="exact"), params,
                          n_slots=N_SLOTS, cache_len=CACHE_LEN,
                          device="cpu")
        want = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, (_, p) in enumerate(extra)]
        for r in want:
            eng.submit(r)
        eng.run_until_drained()
        assert [r.output for r in c] == [r.output for r in want]
    else:
        assert all(r.done and r.rejected == "tenant_degraded" for r in c)
        assert "c" not in front.engines
        late = Request(rid=99, prompt=extra[0][1])
        assert not front.submit("c", late)
        assert late.rejected == "tenant_degraded"


def test_remove_tenant_keeps_the_others_pins(model):
    _, _, cfg, params = model
    front = _port_front(cfg, params)
    front.add_tenant(TenantSpec("c", cfg.replace(act_impl="ppa"), params,
                                n_slots=N_SLOTS, cache_len=CACHE_LEN))
    shared = CompileJob(*ppa_table_jobs("ppa")[0]).key()
    assert front.store._pinned[shared] == 2
    front.submit("c", Request(rid=0, prompt=np.arange(1, 5, dtype=np.int32),
                              max_new_tokens=2))
    with pytest.raises(RuntimeError, match="in flight"):
        front.remove_tenant("c")
    front.run_until_drained()
    front.remove_tenant("c")
    assert front.store._pinned[shared] == 1
    assert sorted(front.specs) == ["a", "b"]


def test_store_fed_engine_equals_default_engine(model, tmp_path):
    """``table_store=`` (the seeded store, and a persisted store holding a
    tuned config) gives the shipped-JSON engine's tokens; the persisted
    store's tuned config is reported and its floors activated."""
    _, _, cfg, params = model
    saved = {k: getattr(TorchSearchBackend, k)
             for k in ("K_FLOOR", "G_FLOOR", "BATCH_ELEMS")}
    disk = TableStore(tmp_path)
    for naf, fcfg, scheme in ppa_table_jobs("ppa"):
        disk.put(CompileJob(naf, fcfg, scheme), load_table(naf, 16))
    tuned = TunedConfig(device="cpu/host", k_floor=32, g_floor=16)
    save_tuned(tuned, tmp_path)
    pcfg = cfg.replace(act_impl="ppa")
    prompts = [p for _, p in _prompts(cfg.vocab)]
    outs = []
    try:
        for store in (None, _store(), TableStore(tmp_path)):
            eng = ServeEngine(pcfg, params, n_slots=N_SLOTS,
                              cache_len=CACHE_LEN, table_store=store,
                              device="cpu")
            reqs = [Request(rid=i, prompt=p, max_new_tokens=MAX_NEW)
                    for i, p in enumerate(prompts)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            outs.append([r.output for r in reqs])
            assert eng.tuned == (tuned if store is not None and store.persist
                                 else None)
        assert TorchSearchBackend.K_FLOOR == 32
    finally:
        for k, v in saved.items():
            setattr(TorchSearchBackend, k, v)
        config._RESOLVE_CACHE.clear()
        config._ACTIVE = None
    assert outs[0] == outs[1] == outs[2]
    assert eng.table_store.stats()["compiles"] == 0


def test_decode_step_failpoint(model):
    """``serve.decode.step`` fires at the top of every engine step."""
    _, _, cfg, params = model
    eng = ServeEngine(cfg, params, n_slots=1, cache_len=CACHE_LEN,
                      device="cpu")
    eng.submit(Request(rid=0, prompt=np.arange(1, 4, dtype=np.int32),
                       max_new_tokens=2))
    faults.arm("serve.decode.step", "once")
    with pytest.raises(faults.InjectedFault):
        eng.step()
    eng.run_until_drained()
    assert faults.fired("serve.decode.step") == 1
