"""The port's MoE block against the JAX reference (its local path).

Seeded numpy inputs through ``repro.models.moe`` and ``repro_torch.models.
moe``: the router (softmax and sigmoid scores, with a tie between two
experts) gives the same ids exactly and weights and aux loss within 1e-6;
the dispatch gives each assignment the reference's buffer position and
drops the same ones, exactly (its per-slice loop, written out in numpy
below, is the oracle), and the same output within LOGIT_GAP_BOUND of its
largest magnitude, with a capacity that drops and assignments to a
remote expert; ``moe_block`` with two shared experts matches with exact
and PPA activations (the tables aligned by ``TableAlign``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.models as RM  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
from repro_torch.models import make_acts  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402

from test_torch_attention_options import TableAlign  # noqa: E402
from test_torch_models import LOGIT_GAP_BOUND, seeded_store  # noqa: E402

#: router weights and the aux loss, port against reference (float32
#: softmax or sigmoid and a sum, in another order)
ROUTER_TOL = 1e-6
S, D, F, E, K = 40, 16, 24, 8, 3


@pytest.fixture(scope="module")
def store():
    return seeded_store()


def _cfgs(router="softmax", **kw):
    kw = dict(d_model=D, d_ff=F, n_experts=E, top_k=K, router_score=router,
              **kw)
    return RMOE.MoECfg(**kw), M.MoECfg(**kw)


def _inputs(seed, n_shared=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (S, D)).astype(np.float32)
    params = {
        "router": rng.normal(0, 0.5, (D, E)).astype(np.float32),
        "w_gate": rng.normal(0, 0.3, (E, D, F)).astype(np.float32),
        "w_up": rng.normal(0, 0.3, (E, D, F)).astype(np.float32),
        "w_down": rng.normal(0, 0.3, (E, F, D)).astype(np.float32),
    }
    if n_shared:
        f = F * n_shared
        params["shared"] = {
            "w_gate": rng.normal(0, 0.3, (D, f)).astype(np.float32),
            "w_up": rng.normal(0, 0.3, (D, f)).astype(np.float32),
            "w_down": rng.normal(0, 0.3, (f, D)).astype(np.float32)}
    return x, params


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_route_matches_reference(router):
    rcfg, cfg = _cfgs(router)
    x, params = _inputs(0)
    params["router"][:, 5] = params["router"][:, 2]     # a tie on every row
    rids, rwts, raux = RMOE._route(jnp.asarray(x),
                                   jnp.asarray(params["router"]), rcfg)
    ids, wts, aux = M._route(torch.from_numpy(x),
                             torch.from_numpy(params["router"]), cfg)
    assert ids.dtype == torch.int32 and wts.dtype == torch.float32
    both = ((ids == 2).any(1) & (ids == 5).any(1)).sum()
    assert both > 0                     # the tie sits inside the top-k
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(wts.numpy(), np.asarray(rwts), rtol=0,
                               atol=ROUTER_TOL)
    assert abs(float(aux) - float(raux)) <= ROUTER_TOL * abs(float(raux))


def _reference_positions(ids_loc, e_loc):
    """The reference's dispatch loop (``moe.py::_dispatch_compute``):
    slice by slice, a token's position is its expert's running count plus
    its rank among the slice's tokens of that expert."""
    counts = np.zeros(e_loc + 1, np.int64)
    out = []
    for j in range(ids_loc.shape[1]):
        le = ids_loc[:, j]
        oh = np.eye(e_loc + 1, dtype=np.int64)[le]
        within = np.cumsum(oh, axis=0) - 1
        out.append(counts[le] + within[np.arange(len(le)), le])
        counts += oh.sum(0)
    return np.concatenate(out)


@pytest.mark.parametrize("cap", [24, 4], ids=["fits", "drops"])
def test_dispatch_compute_matches_reference(cap):
    rcfg, cfg = _cfgs()
    x, params = _inputs(1)
    rng = np.random.default_rng(2)
    ids = np.stack([rng.permutation(E + 1)[:K] for _ in range(S)]
                   ).astype(np.int32)           # E marks a remote expert
    wts = rng.uniform(0.1, 1.0, (S, K)).astype(np.float32)

    want_pos = _reference_positions(ids, E)
    got_pos = M._positions(torch.from_numpy(ids), E)
    assert got_pos.dtype == torch.int32
    np.testing.assert_array_equal(got_pos.numpy(), want_pos)
    kept = (ids.T.reshape(-1) < E) & (want_pos < cap)
    assert 0 < kept.sum() < kept.size if cap == 4 else kept.sum() == (
        ids < E).sum()

    racts = ref_make_acts("exact")
    want = np.asarray(RMOE._dispatch_compute(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(wts),
        *(jnp.asarray(params[k]) for k in ("w_gate", "w_up", "w_down")),
        E, cap, racts, "silu"))
    got = M._dispatch_compute(
        torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(wts),
        *(torch.from_numpy(params[k]) for k in ("w_gate", "w_up", "w_down")),
        E, cap, make_acts("exact", None, "cpu"), "silu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_GAP_BOUND * np.abs(want).max())
    # a token whose every assignment was dropped or remote gets zero
    dead = ~kept.reshape(K, S).any(0)
    assert np.all(got.numpy()[dead] == 0.0)


@pytest.mark.parametrize("impl", ["exact", "ppa"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_moe_block_with_shared_experts_matches_reference(store, impl, router,
                                                         monkeypatch):
    rcfg, cfg = _cfgs(router, n_shared=2, capacity_factor=1.0)
    x, params = _inputs(3, n_shared=2)
    x3 = x.reshape(4, S // 4, D)
    align = TableAlign(monkeypatch)
    want, raux = RMOE.moe_block(_j(params), jnp.asarray(x3), rcfg,
                                ref_make_acts(impl, "ref", store),
                                RM.ShardCtx())
    got, aux = M.moe_block(_t(params), torch.from_numpy(x3), cfg,
                           make_acts(impl, "ref", "cpu"))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_GAP_BOUND * np.abs(want).max())
    assert abs(float(aux) - float(raux)) <= ROUTER_TOL * abs(float(raux))
    align.check()
