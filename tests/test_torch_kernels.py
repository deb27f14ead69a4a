"""The PyTorch port's PPA ops and kernel wrappers against the JAX reference.

Same inputs (seeded numpy) through ``repro.kernels`` and
``repro_torch.kernels``:

* the integer datapath and the float path (``ppa_apply`` / ``ppa_gate``)
  are bit-identical on every port backend, over the six deployment NAFs x
  16-bit and 8-bit x gated and ungated, with negatives and inputs outside
  the interval, in float32 and bfloat16;
* the reference's Pallas kernels in interpret mode (``ppa_eval_2d``,
  ``pallas_fused_interpret``) equal the port on the exp2_frac table;
* the softmax is within 1e-6 of ``softmax_ppa_2d`` (no mask) and of
  ``ppa_softmax(where=...)`` (masked);
* the straight-through gradients equal ``jax.vjp`` of the exact NAF;
* on CPU tensors the CUDA wrappers run their plain versions.

test_torch_gpu.py holds each CUDA kernel against its plain version on the
card.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.kernels as R  # noqa: E402
from repro.core import PPATable as RefPPATable  # noqa: E402
from repro.core import eval_table_int as ref_eval_table_int  # noqa: E402
from repro.kernels.ops import _exact as ref_exact  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import eval_table_int  # noqa: E402
from repro_torch.kernels import build, fused, ppa, softmax_ppa  # noqa: E402
from repro_torch.tables import BITS, NAFS, load_table, table_path  # noqa: E402

TABLES = [(naf, bits) for naf in NAFS for bits in BITS]
PORT_BACKENDS = ["ref", "lut_value", "lut_index", "cuda_int", "cuda_fused"]
SOFTMAX_ATOL = 1e-6       # the reference's own kernel-vs-wrapper bound
#: the exact derivatives are the same formulas in another op order
#: (e.g. tanh' as 1 - tanh^2): float32 rounding, not a wrong gradient
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _ref_table(naf, bits):
    """The shipped table as the reference's PPATable."""
    d = json.loads(table_path(naf, bits).read_text())
    return RefPPATable.from_json(json.dumps({**d, "stats": {}}))


def _pair(naf, bits):
    """(reference TableConsts, port TableConsts on the CPU)."""
    return (R.pack_table(_ref_table(naf, bits)),
            K.pack_table(load_table(naf, bits), "cpu"))


def _round_mults_tables():
    """exp2_frac-16's segments under a round_mults plan with down_out > 0:
    a datapath test of the half-ULP add and the final plain floor."""
    ref_tab = _ref_table("exp2_frac", 16)
    rcfg = dataclasses.replace(ref_tab.cfg, round_mults=True, w_out=12)
    ours = load_table("exp2_frac", 16)
    return (dataclasses.replace(ref_tab, cfg=rcfg),
            dataclasses.replace(ours, cfg=dataclasses.replace(
                ours.cfg, round_mults=True, w_out=12)))


def _float_inputs(tc, seed):
    xs, xe = tc.interval
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(xs - 0.5 - xe, xe + 0.5, size=7 * 153),
        rng.normal(0.0, 3.0, size=512),
        [0.0, -0.0, xe, -xe, xe - 2.0 ** -9, 2.0 ** -9, -(2.0 ** -9)],
    ]).astype(np.float32)


def _f32_bits(t):
    return t.to(torch.float32).numpy().view(np.uint32)


# ----------------------------------------------------------- integer path
@pytest.mark.parametrize("naf,bits", TABLES)
def test_integer_datapath_exact(naf, bits):
    """Every port backend's integer datapath == the reference golden model
    over the whole [lo, hi) grid.  Outside it (where the float path never
    goes: it clips) ref and cuda_int equal the reference's int32 op, whose
    arithmetic wraps as theirs does."""
    rtc, tc = _pair(naf, bits)
    grid = np.arange(tc.lo, tc.hi, dtype=np.int64)
    gold = ref_eval_table_int(_ref_table(naf, bits), grid)
    xg = torch.as_tensor(grid, dtype=torch.int32)
    for be in PORT_BACKENDS[:4]:
        got = K.get_backend(be).eval_int(tc, xg)
        np.testing.assert_array_equal(got.numpy(), gold, err_msg=be)
    wide = np.concatenate([grid + (tc.hi - tc.lo), -grid - 1]
                          ).astype(np.int32)
    want = np.asarray(R.get_backend("ref").eval_int(rtc, jnp.asarray(wide)))
    for be in ("ref", "cuda_int"):
        got = K.get_backend(be).eval_int(tc, torch.as_tensor(wide))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=be)


def test_round_mults_datapath_exact():
    ref_tab, ours = _round_mults_tables()
    tc = K.pack_table(ours, "cpu")
    assert tc.plan.round_mults and tc.plan.down_out > 0
    grid = np.arange(tc.lo, tc.hi, dtype=np.int64)
    gold = ref_eval_table_int(ref_tab, grid)
    np.testing.assert_array_equal(eval_table_int(ours, grid), gold)
    for be in ("ref", "lut_index", "cuda_int"):
        got = K.get_backend(be).eval_int(
            tc, torch.as_tensor(grid, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), gold, err_msg=be)


def test_plan_ints_layout():
    """The flat plan array decodes, as csrc/ppa_body.cuh reads it, to the
    plan's own shifts."""
    for naf, bits in TABLES:
        plan = K.pack_table(load_table(naf, bits), "cpu").plan
        v = K.plan_ints(plan)
        n = plan.order
        assert len(v) == 15
        assert (v[0], bool(v[1])) == (n, plan.round_mults)
        assert tuple(v[2:2 + n]) == plan.mult_shifts
        assert tuple(v[6:6 + n - 1]) == plan.up_g
        assert tuple(v[9:9 + n - 1]) == plan.up_a
        assert tuple(v[12:15]) == (plan.up_h, plan.up_b, plan.down_out)


# ------------------------------------------------------------- float path
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gated"])
@pytest.mark.parametrize("naf,bits", TABLES)
def test_float_path_exact(naf, bits, gate, dtype):
    """ppa_apply / ppa_gate: every port backend == the reference "ref"
    backend, bit for bit, in-interval, beyond it and negative."""
    rtc, tc = _pair(naf, bits)
    x = _float_inputs(tc, TABLES.index((naf, bits)))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert np.array_equal(np.asarray(jx.astype(jnp.float32)).view(np.uint32),
                          _f32_bits(tx))
    ref_fn = R.ppa_gate if gate else R.ppa_apply
    want = np.asarray(ref_fn(rtc, jx, backend="ref").astype(jnp.float32))
    fn = K.ppa_gate if gate else K.ppa_apply
    for be in PORT_BACKENDS:
        got = fn(tc, tx, backend=be)
        assert got.dtype == tx.dtype, be
        np.testing.assert_array_equal(_f32_bits(got), want.view(np.uint32),
                                      err_msg=be)


def test_pallas_interpret_int_kernel_matches_port():
    """The reference's integer Pallas kernel (interpret mode) == the port
    on exp2_frac's whole grid."""
    rtc, tc = _pair("exp2_frac", 16)
    grid = np.arange(tc.lo, tc.hi, dtype=np.int32)
    x2, blk = R.ppa.pad_to_tiles(jnp.asarray(grid), 8, 128)
    want = np.asarray(R.ppa_eval_2d(x2, rtc.starts, rtc.coefs, rtc.plan,
                                    block=blk, interpret=True)
                      ).reshape(-1)[:grid.size]
    got = ppa.ppa_eval_int(tc, torch.as_tensor(grid))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gate", [False, True], ids=["plain", "gated"])
def test_pallas_interpret_fused_kernel_matches_port(gate):
    rtc, tc = _pair("exp2_frac", 16)
    x = _float_inputs(tc, 5)
    ref_fn = R.ppa_gate if gate else R.ppa_apply
    want = np.asarray(ref_fn(rtc, jnp.asarray(x),
                             backend="pallas_fused_interpret"))
    got = fused.ppa_fused_apply(tc, torch.from_numpy(x), gate)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# ---------------------------------------------------------------- softmax
@pytest.mark.parametrize("backend", ["cuda_fused", "ref", "lut_value"])
def test_softmax_matches_pallas_kernel(backend):
    rtc, tc = _pair("exp2_frac", 16)
    rng = np.random.default_rng(11)
    x = rng.normal(0, 3, size=(10, 200)).astype(np.float32)
    want = np.asarray(R.softmax_ppa_2d(jnp.asarray(x), rtc, interpret=True))
    got = K.ppa_softmax(tc, torch.from_numpy(x), backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("backend", ["cuda_fused", "ref"])
def test_softmax_masked_matches_reference(backend, bits):
    """Attention-shaped scores (B, Hk, G, T, S) with a (B, 1, 1, T, S)
    mask, one row all masked."""
    rtc, tc = _pair("exp2_frac", bits)
    rng = np.random.default_rng(13)
    x = rng.normal(0, 4, size=(2, 2, 3, 5, 37)).astype(np.float32)
    where = rng.random((2, 1, 1, 5, 37)) < 0.7
    where[1, 0, 0, 2, :] = False
    want = np.asarray(R.ppa_softmax(rtc, jnp.asarray(x),
                                    where=jnp.asarray(where)))
    got = K.ppa_softmax(tc, torch.from_numpy(x),
                        where=torch.from_numpy(where), backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)
    assert not got.numpy()[1, :, :, 2].any()
    assert not got.numpy()[np.broadcast_to(~where, x.shape)].any()


@pytest.mark.parametrize("backend", ["cuda_fused", "ref"])
def test_softmax_masked_other_axis_matches_reference(backend):
    """Softmax over a middle axis, with a mask of fewer dims that is
    broadcast and moved along with the scores."""
    rtc, tc = _pair("exp2_frac", 16)
    rng = np.random.default_rng(17)
    x = rng.normal(0, 4, size=(3, 29, 4)).astype(np.float32)
    where = rng.random((29, 1)) < 0.6
    want = np.asarray(R.ppa_softmax(rtc, jnp.asarray(x), axis=1,
                                    where=jnp.asarray(where)))
    got = K.ppa_softmax(tc, torch.from_numpy(x), axis=1,
                        where=torch.from_numpy(where), backend=backend)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)


# -------------------------------------------------------------- gradients
@pytest.mark.parametrize("naf", NAFS)
def test_ppa_act_grad_is_exact_vjp(naf):
    _, tc = _pair(naf, 16)
    x = _float_inputs(tc, 3)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: ref_exact(naf, v), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    K.ppa_act(tc, tx, "cuda_fused").backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("naf", ["sigmoid_wide", "gelu_inner"])
def test_ppa_gate_act_grad_is_exact_vjp(naf):
    _, tc = _pair(naf, 16)
    x = _float_inputs(tc, 6)
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: v * ref_exact(naf, v), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    K.ppa_gate_act(tc, tx, "ref").backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("backend", ["ref", "cuda_int", "cuda_fused"])
def test_ppa_softmax_grad_is_reference_vjp(backend, masked):
    """A softmax input that needs a gradient gets the straight-through
    backward on every backend (on the kernel backends the softmax backward
    kernel's plain version, around the softmax kernel's forward): the
    gradient is jax.vjp of the reference's softmax, and the forward is bit
    for bit the one without a gradient."""
    rtc, tc = _pair("exp2_frac", 16)
    rng = np.random.default_rng(29)
    x = rng.normal(0, 3, size=(2, 3, 5, 40)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    where = rng.random((2, 1, 5, 40)) < 0.7 if masked else None
    if masked:
        where[1, 0, 2] = False
    jw = None if where is None else jnp.asarray(where)
    want_y, vjp = jax.vjp(lambda v: R.ppa_softmax(rtc, v, where=jw),
                          jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tw = None if where is None else torch.from_numpy(where)
    tx = torch.from_numpy(x).requires_grad_(True)
    y = K.ppa_softmax(tc, tx, where=tw, backend=backend)
    y.backward(torch.from_numpy(g))
    assert float(tx.grad.abs().max()) > 0.0
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=0, atol=SOFTMAX_ATOL)
    with torch.no_grad():
        plain = K.ppa_softmax(tc, tx, where=tw, backend=backend)
    assert torch.equal(y.detach(), plain)


# ------------------------------------------------------------------ select
INT32_EXTREMES = [-(1 << 31), -(1 << 31) + 1, (1 << 31) - 1]


@pytest.mark.parametrize("naf,bits", TABLES + [("exp2_frac-round", 12)])
def test_idx_lut_select_is_the_search(naf, bits):
    """csrc/ppa_int.cu selects the row of any int32 x as
    idx_lut[clamp(x, lo, hi - 1) - lo]: the search's row,
    clamp(searchsorted(starts, x, right) - 1, 0, S - 1), over a span
    beyond each end of the interval and at the int32 extremes."""
    if naf == "exp2_frac-round":
        tc = K.pack_table(_round_mults_tables()[1], "cpu")
    else:
        tc = K.pack_table(load_table(naf, bits), "cpu")
    span = tc.hi - tc.lo
    x = torch.cat([torch.arange(tc.lo - span, tc.hi + span),
                   torch.tensor(INT32_EXTREMES)]).to(torch.int32)
    lut_row = tc.idx_lut[(torch.clamp(x, tc.lo, tc.hi - 1) - tc.lo).long()]
    search_row = torch.clamp(
        torch.searchsorted(tc.starts, x, right=True) - 1, 0,
        tc.num_segments - 1)
    assert torch.equal(lut_row.long(), search_row)


@pytest.mark.parametrize("end", ["first", "last"])
def test_cuda_int_refuses_a_table_the_select_cannot_take(end):
    """A segment that starts before the interval (the idx_lut's first
    entry is not row 0) or after its end (the last entry is not row S - 1)
    would make the integer kernel's clamped select differ from the search
    outside the interval: its wrapper raises, on the CPU too, while the
    other backends, which search, take the table."""
    tab = load_table("exp2_frac", 16)
    hi = int(tab.interval[1] * (1 << tab.cfg.w_in))
    first = end == "first"

    def grow(a, new):
        return np.concatenate([new, a] if first else [a, new])

    bad = dataclasses.replace(
        tab, starts_int=grow(tab.starts_int, [-16] if first else [hi + 16]),
        a_int=grow(tab.a_int, tab.a_int[:1]),
        b_int=grow(tab.b_int, tab.b_int[:1]))
    tc = K.pack_table(bad, "cpu")
    assert not tc.lut_spans_rows
    assert K.pack_table(tab, "cpu").lut_spans_rows
    x = torch.arange(tc.lo - 32, tc.hi + 32, dtype=torch.int32)
    with pytest.raises(ValueError, match="clamped idx_lut select"):
        ppa.ppa_eval_int(tc, x)
    with pytest.raises(ValueError, match="clamped idx_lut select"):
        K.ppa_apply(tc, torch.linspace(0.0, 0.99, 64), backend="cuda_int")
    want = K.ppa_apply(tc, torch.linspace(0.0, 0.99, 64), backend="ref")
    for be in ("lut_value", "lut_index", "cuda_fused"):
        assert torch.equal(
            K.ppa_apply(tc, torch.linspace(0.0, 0.99, 64), backend=be), want)


# ---------------------------------------------------------------- wrappers
def test_wrappers_run_plain_versions_on_cpu():
    _, tc = _pair("exp2_frac", 16)
    K.reset_counts()
    x = torch.linspace(-2, 2, 301)
    K.ppa_apply(tc, x, backend="cuda_fused")
    K.ppa_apply(tc, x, backend="cuda_int")
    K.ppa_softmax(tc, x[None], backend="cuda_fused")
    c = K.read_counts()
    assert all(v["launches"] == 0 for k, v in c.items() if k != "ref")
    assert c["ppa_fused"]["plain"] >= 1
    assert c["softmax_ppa"]["plain"] >= 1
    assert c["ref"]["plain"] >= 3
    K.reset_counts()
    assert all(n == 0 for v in K.read_counts().values() for n in v.values())


def test_wrappers_reject_other_devices_and_dtypes():
    _, tc = _pair("exp2_frac", 16)
    meta_i = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ppa.ppa_eval_int(tc, meta_i)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.ppa_fused_apply(tc, meta_i.float())
    with pytest.raises(ValueError, match="CUDA tensor"):
        softmax_ppa.softmax_ppa(meta_i.float(), tc)
    with pytest.raises(ValueError, match="unknown backend"):
        K.ppa_apply(tc, torch.zeros(4), backend="pallas")


# ---------------------------------------------------------------- dispatch
ROUTE_LENGTHS = [(1, (1, 1)), (31, (1, 1)), (33, (1, 2)), (512, (4, 4)),
                 (1024, (4, 8)), (2048, (4, 16)), (2049, (0, 0)),
                 (4096, (0, 0))]
SPLIT_SIZES = [1, 7, 9, 1001, 3 * 1001, 8 * 1024]


@pytest.fixture(scope="module")
def route_cases():
    """{n: (x, where, reference)} for 3 rows of each length, the second
    all masked.  The reference runs once, on the rows padded to the
    longest length with masked columns (they give 0 and leave the max and
    the sum alone), so it compiles once."""
    rtc, _ = _pair("exp2_frac", 16)
    width = max(n for n, _ in ROUTE_LENGTHS)
    rng = np.random.default_rng(19)
    xs, ws = [], []
    for n, _ in ROUTE_LENGTHS:
        x = np.zeros((3, width), np.float32)
        x[:, :n] = rng.normal(0, 4, size=(3, n))
        w = np.zeros((3, width), bool)
        w[:, :n] = rng.random((3, n)) < 0.7
        w[1] = False
        xs.append(x)
        ws.append(w)
    want = np.asarray(R.ppa_softmax(rtc, jnp.asarray(np.concatenate(xs)),
                                    where=jnp.asarray(np.concatenate(ws))))
    return {n: (xs[i][:, :n], ws[i][:, :n], want[3 * i:3 * i + 3, :n])
            for i, (n, _) in enumerate(ROUTE_LENGTHS)}


@pytest.mark.parametrize("n,layout", ROUTE_LENGTHS)
def test_softmax_route_by_row_length(route_cases, n, layout):
    """Rows of up to 2048 scores take one warp each, held in registers
    (16-byte loads when the row length is a multiple of 4 and the row
    aligned), longer rows one block each.  At each length the CPU path
    matches the reference, masked, with an all-masked row."""
    assert softmax_ppa.route(n, True) == layout
    vec, items = softmax_ppa.route(n, False)
    assert vec in (0, 1) and (vec == 0) == (layout == (0, 0))
    for v, it in (layout, (vec, items)):
        if v:
            assert 32 * v * it >= n and (it == 1 or 16 * v * it < n)
    _, tc = _pair("exp2_frac", 16)
    x, where, want = route_cases[n]
    got = K.ppa_softmax(tc, torch.from_numpy(np.ascontiguousarray(x)),
                        where=torch.from_numpy(np.ascontiguousarray(where)),
                        backend="cuda_fused")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)
    assert not got.numpy()[1].any()


@pytest.fixture(scope="module")
def split_cases():
    """{dtype: (x, reference gate)} on the longest size; the gate is
    elementwise, so a prefix of the input gives that prefix of it."""
    rtc, _ = _pair("sigmoid_wide", 16)
    x = np.random.default_rng(23).normal(0, 4, max(SPLIT_SIZES)
                                         ).astype(np.float32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jx = jnp.asarray(x).astype(getattr(jnp, dtype))
        out[dtype] = (x, np.asarray(R.ppa_gate(rtc, jx, backend="ref")
                                    .astype(jnp.float32)))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", SPLIT_SIZES)
def test_fused_vector_split(split_cases, size, dtype):
    """The fused kernel loads whole 16-byte vectors of aligned inputs and
    takes the rest one element per thread: every element once, also for
    sizes that are not a multiple of 8.  At each size the CPU path equals
    the reference bit for bit."""
    t = getattr(torch, dtype)
    per = 16 // t.itemsize
    n_vec = build.vector_split(size, t.itemsize, True)
    assert n_vec * per <= size < (n_vec + 1) * per
    assert build.vector_split(size, t.itemsize, False) == 0
    _, tc = _pair("sigmoid_wide", 16)
    x, want = split_cases[dtype]
    got = fused.ppa_fused_apply(tc, torch.from_numpy(x[:size]).to(t), True)
    np.testing.assert_array_equal(_f32_bits(got),
                                  want[:size].view(np.uint32))
