"""The recurrent block kinds served by the port against the JAX reference:
the hymba-1.5b and rwkv6-3b smoke configs with ``act_impl="ppa"`` and a
parameter tree in the reference's layout carried across
(``test_torch_recurrent.ref_params``).

* The port's ``ServeEngine`` gives the reference engine's greedy tokens on
  prompts of mixed lengths, some of them equal.  Neither engine pads: an
  SSM or RWKV state would run on past the pads, so requests coalesce by
  exact prompt length (the 9-token pair prefills as one batch of 2).  Both
  engines keep a float32 cache (``init_cache`` and ``prefill`` patched in
  each engine module), as a bf16 one rounds the conv window, the token
  shifts and K/V, and an entry one float32 rounding from a bf16 boundary
  rounds one bf16 step apart.
* A slot reused after its request finished gives each request the tokens
  it gets served alone: every cache leaf (K/V, SSM, RWKV) of the slot is
  the new request's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as RM  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro.serve.engine as RSE  # noqa: E402
import repro_torch.models as M  # noqa: E402
import repro_torch.serve.engine as SE  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

from test_torch_models import seeded_store  # noqa: E402
from test_torch_recurrent import ARCHS, smoke_pair  # noqa: E402

#: one admission fills the 4 slots: 9 and 9 prefill together, 5 and 11
#: alone; 11 is prime and above the smoke configs' chunk of 8, so its
#: prefill runs 11 chunks of 1
LENS = (9, 5, 9, 11)
MAX_NEW = 6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return seeded_store()


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    return smoke_pair(request.param)


def _prompts(vocab, lens):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _drain(eng, mk, prompts, max_new):
    reqs = [mk(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and len(r.output) == n
               for r, n in zip(reqs, max_new))
    return [r.output for r in reqs]


def test_engine_matches_reference_engine(smoke, store, monkeypatch):
    rcfg, cfg, rparams = smoke
    monkeypatch.setattr(RSE, "init_cache", functools.partial(
        RM.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(RSE, "prefill", functools.partial(
        RM.prefill, cache_dtype=jnp.float32))
    monkeypatch.setattr(SE, "init_cache", functools.partial(
        M.init_cache, dtype=torch.float32))
    monkeypatch.setattr(SE, "prefill", functools.partial(
        M.prefill, cache_dtype=torch.float32))
    prompts = _prompts(cfg.vocab, LENS)
    reng = RS.ServeEngine(rcfg, jax.tree_util.tree_map(jnp.asarray, rparams),
                          n_slots=4, cache_len=32, table_store=store)
    eng = ServeEngine(cfg, params_from_jax(rparams, "cpu"), n_slots=4,
                      cache_len=32, device="cpu")
    assert not reng._paddable and not eng._paddable
    max_new = [MAX_NEW] * len(LENS)
    want = _drain(reng, RS.Request, prompts, max_new)
    got = _drain(eng, Request, prompts, max_new)
    assert got == want
    assert all(t.dtype in (torch.float32, torch.int32)
               for st in eng.cache.values() for leaf in st.values()
               for t in leaf.values())
    # exact lengths only, the equal pair batched
    assert eng.prefill_shapes == {(9, 2), (5, 1), (11, 1)}


def test_reused_slot_gives_the_tokens_served_alone(smoke):
    """2 slots, 5 requests of other lengths and lengths of output, so that
    slots free at different steps and each is reused mid-run; each
    request's tokens against the same request alone in a fresh engine."""
    _, cfg, rparams = smoke
    params = params_from_jax(rparams, "cpu")
    lens, max_new = (9, 5, 7, 12, 3), [3, 7, 4, 2, 5]
    prompts = _prompts(cfg.vocab, lens)

    def engine():
        return ServeEngine(cfg, params, n_slots=2, cache_len=32,
                           device="cpu")

    shared = _drain(engine(), Request, prompts, max_new)
    alone = [_drain(engine(), Request, [p], [n])[0]
             for p, n in zip(prompts, max_new)]
    assert shared == alone
