"""The recurrent block kinds trained by the port against the JAX
reference: the hymba-1.5b and rwkv6-3b smoke configs with
``act_impl="ppa"`` and a parameter tree in the reference's layout carried
across (``test_torch_recurrent.ref_params``).

* ``loss_fn``'s loss and gradients against ``jax.value_and_grad`` of the
  reference's, the tables aligned (``TableAlign``), on the ``ref`` backend
  and the kernel backends' plain versions.  Both recompute each SSM
  and time-mix chunk in the backward (``torch.utils.checkpoint``,
  ``jax.checkpoint``), so the tables are evaluated again there, in the same
  order; remat is off on both sides otherwise.
* A layer recomputed (remat "dots", "full") around the mixers' own
  recomputed chunks gives the gradients of none, bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import leaves_with_path  # noqa: E402

from test_torch_attention_options import TableAlign  # noqa: E402
from test_torch_families_train import (BACKENDS, _batch,  # noqa: E402
                                       _port_grads, reference_grads)
from test_torch_models import seeded_store  # noqa: E402
from test_torch_recurrent import ARCHS, smoke_pair  # noqa: E402
from test_torch_train import STEP_GRAD_REL, STEP_LOSS_RTOL  # noqa: E402


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


@pytest.fixture(scope="module")
def reference(smoke, store):
    rcfg, cfg, rparams = smoke
    return reference_grads(rcfg.replace(remat="none"), rparams,
                           _batch(cfg.vocab), store)


@pytest.mark.parametrize("backend", BACKENDS)
def test_smoke_loss_and_grads_match_reference(smoke, reference, backend,
                                              monkeypatch):
    """Loss within STEP_LOSS_RTOL, each gradient leaf within STEP_GRAD_REL
    of its largest magnitude (the train step's tolerances), on every
    backend: the kernel backends' plain versions run the card's autograd
    path (``_STE`` on the decays, ``_SoftmaxSTE``)."""
    _, cfg, rparams = smoke
    cfg = cfg.replace(remat="none")
    (rloss, _, rflat), points = reference
    align = TableAlign(monkeypatch, backend, points)
    loss, _, params = _port_grads(cfg, rparams, _batch(cfg.vocab), backend)
    align.check()
    assert abs(float(loss) - rloss) <= STEP_LOSS_RTOL * abs(rloss)
    for k, p in leaves_with_path(params):
        want = rflat[k]
        scale = float(np.abs(want).max())
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= STEP_GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_recompute_gives_the_same_grads(smoke, remat):
    """A layer recomputed around the mixers' own recomputed chunks."""
    _, cfg, rparams = smoke
    batch = _batch(cfg.vocab)
    want = _port_grads(cfg.replace(remat="none"), rparams, batch)
    got = _port_grads(cfg.replace(remat=remat), rparams, batch)
    assert torch.equal(got[0], want[0])
    for (k, a), (_, b) in zip(leaves_with_path(got[2]),
                              leaves_with_path(want[2])):
        assert torch.equal(a.grad, b.grad), k
