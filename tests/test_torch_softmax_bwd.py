"""The softmax backward's layout chooser, and its gradient on long rows
against the JAX reference.

``softmax_ppa.bwd_route`` picks the layout of the backward's row kernel
(one row across the warps of a block, a few float4 runs a lane) for rows of
a multiple of 4 scores up to 8192 that start 16-byte aligned, and today's
paths for the others.  On the CPU the wrapper runs its plain version, so
the gradient of ``ppa_softmax(backend="cuda_fused")`` at the rows the card
takes across several warps (768: 2 warps, 1500: 4) is held to ``jax.vjp``
of the reference's ``ppa_softmax``, masked with an all-masked row and a
three-way tie for a row's max.  test_torch_gpu.py holds the kernel itself
to that plain version on the card.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels as R  # noqa: E402
from repro.core import PPATable as RefPPATable  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import softmax_ppa  # noqa: E402
from repro_torch.tables import load_table, table_path  # noqa: E402

#: the backward against the reference, over the largest incoming gradient
#: (chip_smoke.py's SOFTMAX_BWD_REL): the sums c = sum g y and sum d are
#: taken in other orders
SOFTMAX_BWD_REL = 1e-6
#: the chooser's caps: warps a row, float4 runs a lane, and the threads a
#: block of each number of runs (16 warps only at 4 runs a lane)
WARPS, RUNS = (1, 2, 4, 8, 16), 4
THREADS = {1: 256, 2: 256, 3: 256, 4: 512}
LANE_VALUES = 16                      # scores a lane holds: 4 a run

#: row length: (warps, vec, runs a lane) the chooser gives aligned rows
LAYOUTS = {512: (1, 4, 4), 768: (2, 4, 3), 1500: (4, 4, 3),
           2048: (4, 4, 4), 4: (1, 4, 1), 1024: (2, 4, 4),
           1028: (4, 4, 3), 4096: (8, 4, 4), 8192: (16, 4, 4)}
#: rows the row kernel does not take: unaligned, of a length not a multiple
#: of 4, longer than 16 warps x 32 lanes x 4 runs x 4 scores
EARLIER = [(1500, False), (2048, False), (4, False), (1502, True),
           (3, True), (1, True), (8196, True), (16384, True)]


@pytest.mark.parametrize("n", list(LAYOUTS))
def test_bwd_route_takes_the_fewest_idle_runs(n):
    warps, vec, items = softmax_ppa.bwd_route(n, True)
    assert (warps, vec, items) == LAYOUTS[n]
    runs = n // 4
    assert 32 * warps * items >= runs
    assert vec * items <= LANE_VALUES
    fewest = min(32 * w * k - runs for w in WARPS for k in range(1, RUNS + 1)
                 if 32 * w * k >= runs and 32 * w <= THREADS[k])
    assert 32 * warps * items - runs == fewest


@pytest.mark.parametrize("n,aligned", EARLIER)
def test_bwd_route_keeps_the_earlier_paths(n, aligned):
    assert softmax_ppa.bwd_route(n, aligned) == (
        0, *softmax_ppa.route(n, aligned, softmax_ppa._BWD_LANE_VALUES))


LONG_ROWS = (768, 1500)


@pytest.fixture(scope="module")
def long_rows():
    """{(n, masked): (x, g, where, reference gradient)} on (4, 6, n) scores:
    row (1, 3) all masked, row (2, 5) with its max three times.  The
    reference runs once for each mask setting, on the rows padded to the
    longest length with masked columns (they take no part in the max, the
    sum or the ties, and get 0)."""
    d = json.loads(table_path("exp2_frac", 16).read_text())
    rtc = R.pack_table(RefPPATable.from_json(json.dumps({**d, "stats": {}})))
    width = max(LONG_ROWS)
    rng = np.random.default_rng(37)
    out = {}
    for masked in (False, True):
        xs, gs, ws = [], [], []
        for n in LONG_ROWS:
            x = np.zeros((4, 6, width), np.float32)
            x[..., :n] = rng.normal(0, 4, size=(4, 6, n))
            x[2, 5, :3] = x[2, 5, :n].max() + 1.0
            w = np.zeros((4, 6, width), bool)
            w[..., :n] = rng.random((4, 6, n)) < 0.7 if masked else True
            w[2, 5, :3] = True
            if masked:
                w[1, 3] = False
            xs.append(x)
            gs.append(rng.normal(size=x.shape).astype(np.float32))
            ws.append(w)
        x, g, w = (np.concatenate(a) for a in (xs, gs, ws))
        _, vjp = jax.vjp(lambda v: R.ppa_softmax(rtc, v,
                                                 where=jnp.asarray(w)),
                         jnp.asarray(x))
        (want,) = vjp(jnp.asarray(g))
        want = np.asarray(want)
        for i, n in enumerate(LONG_ROWS):
            sl = (slice(4 * i, 4 * i + 4), slice(None), slice(0, n))
            out[(n, masked)] = tuple(np.ascontiguousarray(a[sl])
                                     for a in (x, g, w, want))
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("n", LONG_ROWS)
def test_softmax_grad_on_rows_across_warps_is_reference_vjp(long_rows, n,
                                                            masked):
    x, g, where, want = long_rows[(n, masked)]
    assert softmax_ppa.bwd_route(n, True)[0] > 1
    tc = K.pack_table(load_table("exp2_frac", 16), "cpu")
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(where) if masked else None
    y = K.ppa_softmax(tc, tx, where=tw, backend="cuda_fused")
    y.backward(torch.from_numpy(g))
    got = tx.grad.numpy()
    lim = SOFTMAX_BWD_REL * float(np.abs(g).max())
    assert float(np.abs(got - want).max()) <= lim
    assert float(np.abs(got[2, 5, :3]).min()) > 0.0
    if masked:
        assert not got[1, 3].any()
