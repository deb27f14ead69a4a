"""The PyTorch port's ServeEngine against the JAX reference engine.

* greedy outputs equal the reference engine's on the ``examples/serve_lm.py``
  load (internlm2-1.8b smoke, act_impl="ppa": 6 requests, 16-token
  prompts, 4 slots, cache_len 64), with the reference's parameters;
* within the port, coalesced admission gives the same tokens as serial
  admission, greedy with mixed lengths and at temperature > 0;
* queue shedding, deadline reaping, and the card-by-default device rule.
"""

import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models as RM  # noqa: E402
import repro.serve as RS  # noqa: E402
from repro.compiler import CompileJob, TableStore  # noqa: E402
from repro.core import PPATable as RefPPATable  # noqa: E402
from repro.models.activations import \
    ppa_table_jobs as ref_table_jobs  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tables import table_path  # noqa: E402

ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _seeded_store() -> TableStore:
    """An in-memory reference store holding the shipped 16-bit tables."""
    store = TableStore(persist=False)
    for naf, cfg, scheme in ref_table_jobs("ppa"):
        d = json.loads(table_path(naf, cfg.w_out).read_text())
        store.put(CompileJob(naf=naf, cfg=cfg, scheme=scheme),
                  RefPPATable.from_json(json.dumps({**d, "stats": {}})))
    return store


@pytest.fixture(scope="module")
def model():
    rcfg = RC.get_smoke_config(ARCH).replace(act_impl="ppa")
    cfg = get_smoke_config(ARCH).replace(act_impl="ppa")
    rparams = RM.init_params(RM.param_specs(rcfg), jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                             "cpu")
    return rcfg, rparams, cfg, params


def _serve_lm_prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, 16).astype(np.int32) for _ in range(6)]


def test_engine_matches_reference_engine_on_serve_lm_load(model):
    rcfg, rparams, cfg, params = model
    prompts = _serve_lm_prompts(cfg.vocab)
    reng = RS.ServeEngine(rcfg, rparams, n_slots=4, cache_len=64,
                          table_store=_seeded_store())
    rreqs = [RS.Request(rid=i, prompt=p, max_new_tokens=12)
             for i, p in enumerate(prompts)]
    for r in rreqs:
        reng.submit(r)
    reng.run_until_drained()
    eng = ServeEngine(cfg, params, n_slots=4, cache_len=64, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    assert all(r.done and len(r.output) == 12 for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in rreqs]


def _run_both(cfg, params, lens, temps=(0.0,), max_new=5):
    outs = []
    for coalesce in (False, True):
        eng = ServeEngine(cfg, params, n_slots=4, cache_len=64,
                          coalesce=coalesce, rng_seed=3, device="cpu")
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n
                                                   ).astype(np.int32),
                        max_new_tokens=max_new,
                        temperature=temps[i % len(temps)])
                for i, n in enumerate(lens)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        assert all(r.done and len(r.output) == max_new for r in reqs)
        outs.append([r.output for r in reqs])
    return outs


def test_coalesced_matches_serial_greedy_mixed_lengths(model):
    _, _, cfg, params = model
    serial, coalesced = _run_both(cfg, params, [5, 8, 12, 16, 3, 9])
    assert coalesced == serial


def test_coalesced_matches_serial_temperature(model):
    _, _, cfg, params = model
    serial, coalesced = _run_both(cfg, params, [5, 8, 12, 8, 16, 6],
                                  temps=(0.0, 0.8, 1.3))
    assert coalesced == serial


def test_max_queue_sheds_and_deadline_reaps(model):
    _, _, cfg, params = model
    eng = ServeEngine(cfg, params, n_slots=1, cache_len=64, max_queue=2,
                      device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(4, dtype=np.int32) + i,
                    max_new_tokens=3) for i in range(3)]
    assert [eng.submit(r) for r in reqs] == [True, True, False]
    assert reqs[2].rejected == "queue_full" and reqs[2].done
    late = Request(rid=9, prompt=np.arange(4, dtype=np.int32),
                   max_new_tokens=3, deadline_s=1.0,
                   t_submit=time.perf_counter() - 10.0)
    eng.queue.clear()
    eng.submit(late)
    eng.step()
    assert late.timed_out and late.done and late.output == []
    assert eng.stats()["shed"] == 1 and eng.stats()["timed_out"] == 1


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--smoke", "--act-impl", "ppa", "--requests", "3",
          "--max-new", "4", "--prompt-len", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests / 12 tokens" in out and "on cpu" in out


def test_engine_needs_a_card_unless_told(model, monkeypatch):
    _, _, cfg, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, n_slots=1, cache_len=16)
