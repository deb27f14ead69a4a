"""The ``dec`` family trained by the port against the JAX reference, and
its parameter specs.

* Each smoke config (qwen2-7b, qwen3-14b, mistral-nemo-12b,
  moonshot-v1-16b-a3b, kimi-k2-1t-a32b) with ``act_impl="ppa"``, the
  reference's parameters carried across: ``loss_fn``'s loss, aux and
  gradients against ``jax.value_and_grad`` of the reference's (the tables
  aligned by ``TableAlign``; remat off on both sides, as recompute
  evaluates the tables again in the backward's order).
* The same on qwen2-7b, qwen3-14b and mistral-nemo-12b narrowed with
  their full configs' head ratios, random biases and qk-norm scales
  (``test_torch_families.RATIO_CONFIGS``).
* Recompute gives the same MoE gradients as none.
* Each full config: the port's spec tree equals the reference's in shape,
  axes and initializer, and in ``count_params``, without allocating.
* ``apply_shape`` and ``shape_skip_reason`` give the reference's knobs
  and skips for every arch and shape profile.
* ``init_params`` of a stacked leaf: one layer slice at a time,
  deterministic per seed, fan-in scaled.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.data as RD  # noqa: E402
import repro.models as RM  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
from repro_torch.configs import (ARCH_IDS, SHAPES,  # noqa: E402
                                 apply_shape, get_config, shape_skip_reason)
from repro_torch.models import (P, init_params, loss_fn,  # noqa: E402
                                make_acts, param_specs, params_from_jax)
from repro_torch.tree import leaves_with_path, map_tree  # noqa: E402

from test_torch_attention_options import TableAlign  # noqa: E402
from test_torch_families import (NEW_ARCHS, RATIO_CONFIGS,  # noqa: E402
                                 _pair, ratio_pair)
from test_torch_models import seeded_store  # noqa: E402
from test_torch_train import STEP_GRAD_REL, STEP_LOSS_RTOL  # noqa: E402

#: the backends a train parity test runs: the plain one and the kernel
#: backends, whose plain versions on CPU tensors take the card's autograd
BACKENDS = ("ref", "cuda_int", "cuda_fused")
#: the aux loss, port against reference (float32 means and a sum of
#: products, in another order)
AUX_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return seeded_store()


@pytest.fixture(scope="module", params=NEW_ARCHS)
def smoke(request):
    return _pair(request.param)


def _batch(vocab):
    return {k: np.asarray(v) for k, v in RD.SyntheticLM(
        vocab=vocab, seq_len=16, global_batch=4).batch_at(3).items()}


def _port_grads(cfg, rparams, batch, backend="ref"):
    params = map_tree(lambda p: p.requires_grad_(True),
                      params_from_jax(rparams, "cpu"))
    loss, aux = loss_fn(params, cfg, {k: torch.from_numpy(v)
                                      for k, v in batch.items()},
                        make_acts(cfg.act_impl, backend, "cpu"))
    loss.backward()
    return loss.detach(), aux, params


def reference_grads(rcfg, rparams, batch, store, align=TableAlign):
    """``jax.value_and_grad`` of the reference's ``loss_fn`` on the ``ref``
    backend over the shipped tables, recorded for ``align`` (its
    ``record``): ((loss, aux, grads as numpy), points)."""
    racts = ref_make_acts("ppa", "ref", store)

    def run():
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda p, b: RM.loss_fn(p, rcfg, b, racts, RM.ShardCtx()),
            has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, rparams),
            {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), float(aux["aux"]), dict(leaves_with_path(
            jax.tree_util.tree_map(np.asarray, grads)))
    return align.record(run)


@pytest.fixture(scope="module")
def reference(smoke, store):
    rcfg, cfg, rparams = smoke
    return reference_grads(rcfg.replace(remat="none"), rparams,
                           _batch(cfg.vocab), store)


@pytest.fixture(scope="module", params=list(RATIO_CONFIGS))
def ratio(request):
    return ratio_pair(request.param)


@pytest.fixture(scope="module")
def ratio_reference(ratio, store):
    rcfg, cfg, rparams = ratio
    return reference_grads(rcfg.replace(remat="none"), rparams,
                           _batch(cfg.vocab), store)


def _check_grads(pair, reference, backend, monkeypatch):
    """``pair``'s port ``loss_fn`` on ``backend`` against ``reference``
    (``reference_grads``), remat off: loss within STEP_LOSS_RTOL, aux
    within AUX_RTOL, each gradient leaf within STEP_GRAD_REL of its
    largest magnitude."""
    _, cfg, rparams = pair
    cfg = cfg.replace(remat="none")
    (rloss, raux, rflat), points = reference
    align = TableAlign(monkeypatch, backend, points)
    loss, aux, params = _port_grads(cfg, rparams, _batch(cfg.vocab),
                                    backend)
    align.check()
    assert abs(float(loss) - rloss) <= STEP_LOSS_RTOL * abs(rloss)
    if cfg.moe_experts:
        assert raux > 0
    got_aux = float(aux["aux"].detach())
    assert abs(got_aux - raux) <= AUX_RTOL * abs(raux)
    for k, p in leaves_with_path(params):
        want = rflat[k]
        scale = float(np.abs(want).max())
        if scale == 0:          # an expert no token reached
            assert float(p.grad.abs().max()) == 0.0, k
            continue
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= STEP_GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("backend", BACKENDS)
def test_smoke_loss_aux_and_grads_match_reference(smoke, reference, backend,
                                                  monkeypatch):
    """On every backend (the kernel backends' plain versions: ``_STE`` and
    ``_SoftmaxSTE``, the card's autograd path), against one recording of
    the reference."""
    _check_grads(smoke, reference, backend, monkeypatch)


@pytest.mark.parametrize("backend", BACKENDS)
def test_head_ratio_loss_and_grads_match_reference(ratio, ratio_reference,
                                                   backend, monkeypatch):
    """The full configs' GQA groups (7, 5, 4) and mistral-nemo's query
    width below d_model at a narrow width, with random biases and qk-norm
    scales, on every backend against one recording of the reference."""
    _check_grads(ratio, ratio_reference, backend, monkeypatch)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_moe_recompute_gives_the_same_grads(remat):
    rcfg, cfg, rparams = _pair("moonshot-v1-16b-a3b")
    batch = _batch(cfg.vocab)
    want = _port_grads(cfg.replace(remat="none"), rparams, batch)
    got = _port_grads(cfg.replace(remat=remat), rparams, batch)
    assert torch.equal(got[0], want[0])
    for (k, a), (_, b) in zip(leaves_with_path(got[2]),
                              leaves_with_path(want[2])):
        assert torch.equal(a.grad, b.grad), k


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_specs_match_reference(arch):
    rcfg, cfg = RC.get_config(arch), get_config(arch)
    ref, ours = RM.param_specs(rcfg), param_specs(cfg)
    flat = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, RM.P))[0]
    mine = dict(leaves_with_path(ours))
    assert len(mine) == len(flat)
    for path, spec in flat:
        node = mine["/".join(k.key for k in path)]
        assert (node.shape, node.axes, node.init, node.scale) == (
            spec.shape, spec.axes, spec.init, spec.scale), path
    assert sum(int(np.prod(p.shape)) for p in mine.values()) == (
        RM.count_params(jax.tree_util.tree_map(
            lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32), ref,
            is_leaf=lambda x: isinstance(x, RM.P))))


@pytest.mark.parametrize("shape", sorted(RC.SHAPES))
def test_apply_shape_matches_reference(shape):
    assert SHAPES[shape].__dict__ == RC.SHAPES[shape].__dict__
    for arch in ARCH_IDS:
        got = apply_shape(get_config(arch), SHAPES[shape])
        want = RC.apply_shape(RC.get_config(arch), RC.SHAPES[shape])
        for field in ("attn_impl", "moe_mode", "remat", "ce_chunks"):
            assert getattr(got, field) == getattr(want, field), (arch, field)
        assert shape_skip_reason(arch, shape) == RC.shape_skip_reason(
            arch, shape)


def test_init_params_draws_a_stacked_leaf_slice_by_slice():
    specs = {"w": P((3, 256, 64), ("layers", "embed", "mlp")),
             "b": P((3, 64), ("layers", "mlp"), init="zeros"),
             "e": P((128, 64), ("vocab", "embed"), scale=0.02)}
    a = init_params(specs, 0, device="cpu")
    b = init_params(specs, 0, device="cpu")
    c = init_params(specs, 1, dtype=torch.bfloat16, device="cpu")
    for k in specs:
        assert torch.equal(a[k], b[k]), k
    assert c["w"].dtype == torch.bfloat16 and not torch.equal(
        c["w"].float(), a["w"])
    assert not torch.equal(a["w"][0], a["w"][1])
    for w in (a["w"], c["w"].float()):
        std = w.flatten(1).std(1)                   # per layer slice
        assert torch.all((std - 1 / 16).abs() < 0.1 / 16), std
    assert float(a["e"].std()) == pytest.approx(0.02, rel=0.1)
    assert not a["b"].any()
