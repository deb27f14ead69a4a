"""The ``dec`` family served by the port against the JAX reference:
qwen2-7b, qwen3-14b, mistral-nemo-12b, moonshot-v1-16b-a3b and
kimi-k2-1t-a32b.

* Each smoke config with ``act_impl="ppa"``, the reference's parameters
  carried across: greedy outputs of the port's ``ServeEngine`` equal the
  reference engine's on prompts of mixed lengths.
* A windowed and a flash variant served by both engines.
* qwen2-7b, qwen3-14b and mistral-nemo-12b narrowed with their full
  configs' head ratios (``RATIO_CONFIGS``: GQA groups of 7, 5 and 4, and
  mistral-nemo's query width n_q x head_dim below d_model), the biases
  and qk-norm scales drawn at random, served by both engines.

Training, the spec trees and the initializer are in
``test_torch_families_train.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models as RM  # noqa: E402
import repro.serve as RS  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

from test_torch_attention_options import _randomize  # noqa: E402
from test_torch_models import seeded_store  # noqa: E402

NEW_ARCHS = ("qwen2-7b", "qwen3-14b", "mistral-nemo-12b",
             "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b")
LENS = (5, 9, 14, 3, 11, 7)
#: each full config narrowed to head_dim 16 with its ratios kept: n_q :
#: n_kv (the GQA group), n_q x head_dim : d_model and d_ff : d_model
#: (qwen2-7b 28 : 4, 3584 : 3584, 18944 : 3584; qwen3-14b 40 : 8, 5120 :
#: 5120, 17408 : 5120; mistral-nemo-12b 32 : 8, 4096 : 5120, 14336 : 5120)
RATIO_CONFIGS = {
    "qwen2-7b": dict(n_q=7, n_kv=1, head_dim=16, d_model=112, d_ff=592),
    "qwen3-14b": dict(n_q=5, n_kv=1, head_dim=16, d_model=80, d_ff=272),
    "mistral-nemo-12b": dict(n_q=4, n_kv=1, head_dim=16, d_model=80,
                             d_ff=224),
}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return seeded_store()


def _pair(arch, **kw):
    rcfg = RC.get_smoke_config(arch).replace(act_impl="ppa", **kw)
    cfg = get_smoke_config(arch).replace(act_impl="ppa", **kw)
    rparams = jax.tree_util.tree_map(
        np.asarray, RM.init_params(RM.param_specs(rcfg),
                                   jax.random.PRNGKey(0)))
    return rcfg, cfg, rparams


@pytest.fixture(scope="module", params=NEW_ARCHS)
def smoke(request):
    return _pair(request.param)


def ratio_pair(arch):
    """``_pair`` of ``arch`` at ``RATIO_CONFIGS[arch]``, the reference's
    biases and qk-norm scales drawn at random (they initialise to 0 and
    1)."""
    rcfg, cfg, rparams = _pair(arch, **RATIO_CONFIGS[arch])
    return rcfg, cfg, _randomize(rparams, np.random.default_rng(3))


@pytest.fixture(scope="module", params=list(RATIO_CONFIGS))
def ratio(request):
    return ratio_pair(request.param)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENS]


def _serve_both(rcfg, cfg, rparams, store, max_new=6):
    """Greedy outputs of the reference engine and the port's on LENS."""
    prompts = _prompts(cfg.vocab)
    reng = RS.ServeEngine(rcfg, jax.tree_util.tree_map(jnp.asarray, rparams),
                          n_slots=4, cache_len=32, table_store=store)
    eng = ServeEngine(cfg, params_from_jax(rparams, "cpu"), n_slots=4,
                      cache_len=32, device="cpu")
    outs = []
    for e, mk in ((reng, RS.Request), (eng, Request)):
        reqs = [mk(rid=i, prompt=p, max_new_tokens=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
        assert all(r.done and len(r.output) == max_new for r in reqs)
        outs.append([r.output for r in reqs])
    return outs


def test_smoke_engine_matches_reference_engine(smoke, store):
    rcfg, cfg, rparams = smoke
    want, got = _serve_both(rcfg, cfg, rparams, store)
    assert got == want


def test_head_ratio_engine_matches_reference_engine(ratio, store):
    """The full configs' GQA groups and query widths at a narrow width:
    the port's engine serves the reference engine's greedy tokens."""
    rcfg, cfg, rparams = ratio
    assert cfg.n_q * cfg.head_dim <= cfg.d_model
    want, got = _serve_both(rcfg, cfg, rparams, store)
    assert got == want


@pytest.mark.parametrize("variant", ["window", "flash"])
def test_windowed_and_flash_engines_match_reference_engine(store, variant):
    """internlm2's smoke config with a window of 8 on its stage (prompts
    up to 14 tokens), or flash attention with chunk 4: the port's engine
    pads only what the reference pads, and serves the same tokens."""
    if variant == "window":
        st = dataclasses.replace(RC.get_smoke_config(
            "internlm2-1.8b").stages[0], window=8)
        kw = dict(stages=(st,))
    else:
        kw = dict(attn_impl="flash", flash_chunk=4)
    rcfg, cfg, rparams = _pair("internlm2-1.8b", **kw)
    want, got = _serve_both(rcfg, cfg, rparams, store)
    assert got == want
