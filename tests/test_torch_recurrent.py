"""The recurrent block kinds against the JAX reference: hymba's selective
SSM (``models/ssm.py``), RWKV6 (``models/rwkv.py``) and the scan they
share (``models/scan.py``).

* ``associative_scan`` is ``jax.lax.associative_scan`` bit for bit, on odd
  and even lengths, op by op (eager JAX).  Under ``jax.jit`` XLA on the CPU
  contracts ``a2 * b1 + b2`` into one fused multiply-add and flushes
  subnormals to zero, so the jitted reference below rounds otherwise and
  the module and model comparisons carry tolerances.
* ``ssm_mixer``, ``ssm_decode_step``, ``rwkv_time_mix`` and
  ``rwkv_channel_mix`` on the same seeded numpy inputs and parameters
  (every leaf drawn at random, ``a_log`` included), with ``exact`` and
  ``ppa`` activations (the shipped tables, ``ref`` backend; with ``ppa``
  :class:`TableAlign` replays the reference's table grid points), at a
  length of two chunks and at a prime one (the chunk rule shrinks the
  chunk to 1).
* Prefill's final carries against the same tokens fed one decode step at
  a time, in the port.
* The smoke configs' spec trees, and a parameter tree in the reference's
  layout carried across; prefill's packed carries are copies.

Training is in ``test_torch_recurrent_train.py``, serving in
``test_torch_recurrent_serve.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.models as RM  # noqa: E402
from repro.models import rwkv as RR  # noqa: E402
from repro.models import ssm as RS  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import (init_params, make_acts,  # noqa: E402
                                param_specs, params_from_jax,
                                prepare_params)
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.scan import associative_scan  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

from test_torch_attention_options import TableAlign  # noqa: E402
from test_torch_models import seeded_store  # noqa: E402

ARCHS = ("hymba-1.5b", "rwkv6-3b")
#: odd and even lengths, and powers of two; RWKV's broadcast form (a of
#: (.., Dk, 1) against b of (.., Dk, Dv)) at one odd length
SCAN_LENGTHS = (2, 7, 8, 64)
RWKV_SCAN_LENGTH = 5
#: a module's outputs and carries, port against reference, each against
#: its own largest magnitude.  exact: XLA's and torch's float32 exp,
#: logistic, softplus and tanh also differ in the last place; ppa: only
#: float32 contractions in another order (and XLA's fused multiply-adds),
#: the tables aligned.  Measured at most 5.4e-7 (exact) and 5.1e-7 (ppa).
MODULE_REL = 5e-6
#: prefill's carry and outputs against one decode step at a time (the
#: port alone): the scan composes the decays in another order than the
#: step-by-step recurrence; measured at most 2.2e-7
CARRY_REL = 2e-6
SSM = dict(d_model=32, d_inner=48, d_state=8, d_conv=4, dt_rank=8, chunk=8)
RWKV = dict(d_model=32, n_heads=2, head_dim=8, decay_lora=8, d_ff=64,
            chunk=8)
#: two chunks of 8, and a prime length: 13 chunks of 1
LENGTHS = (16, 13)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return seeded_store()


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("t", SCAN_LENGTHS + (RWKV_SCAN_LENGTH,))
def test_associative_scan_is_jax_bit_for_bit(t):
    """(a, b) scanned along time: of one shape as the SSM's, or at
    RWKV_SCAN_LENGTH a of (.., Dk, 1) against b of (.., Dk, Dv).  Decays in
    [0.6, 1): a product of 64 of them stays a normal float32, which XLA
    would flush to zero below."""
    rng = np.random.default_rng(t)
    a_shape, b_shape = (((2, t, 3, 4, 1), (2, t, 3, 4, 5))
                        if t == RWKV_SCAN_LENGTH else ((2, t, 6), (2, t, 6)))
    a = rng.uniform(0.6, 1.0, a_shape).astype(np.float32)
    b = rng.normal(0, 1, b_shape).astype(np.float32)
    want = jax.lax.associative_scan(
        _combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = associative_scan(_combine, (torch.from_numpy(a),
                                      torch.from_numpy(b)), axis=1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).view(np.uint32))


def _draw(specs, rng):
    """Every leaf of a reference spec tree drawn at random (numpy float32):
    fan-in scaled normals, normals of 0.5 for leaves that initialise to
    0 (``a_log``, ``dt_bias``, ``w0``...), uniform in [0.5, 1.5) for those
    that initialise to 1, so that every leaf matters."""
    def one(spec):
        if spec.init == "zeros":
            v = rng.normal(0, 0.5, spec.shape)
        elif spec.init == "ones":
            v = rng.uniform(0.5, 1.5, spec.shape)
        else:
            std = spec.scale or 1 / np.sqrt(spec.shape[-2] if len(
                spec.shape) >= 2 else spec.shape[-1])
            v = rng.normal(0, std, spec.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map(one, specs,
                                  is_leaf=lambda x: isinstance(x, RM.P))


def _t(tree):
    return params_from_jax(tree, "cpu")


def _acts(impl, store):
    return ref_make_acts(impl, "ref", store), make_acts(impl, "ref", "cpu")


def _close(got, want, rel, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_ssm_mixer_matches_reference(store, impl, t, monkeypatch):
    rng = np.random.default_rng(10 + t)
    params = _draw(RS.ssm_params(RS.SSMCfg(**SSM)), rng)
    x = rng.normal(0, 1, (2, t, SSM["d_model"])).astype(np.float32)
    racts, acts = _acts(impl, store)
    align = TableAlign(monkeypatch)
    want, wstate = jax.jit(lambda p, x: RS.ssm_mixer(
        p, RS.SSMCfg(**SSM), x, racts, RM.ShardCtx(), return_state=True))(
            params, jnp.asarray(x))
    with torch.no_grad():
        got, state = S.ssm_mixer(_t(params), S.SSMCfg(**SSM),
                                 torch.from_numpy(x), acts,
                                 return_state=True)
    align.check()
    _close(got, want, MODULE_REL, "y")
    for k in ("conv", "h"):
        _close(state[k], wstate[k], MODULE_REL, k)


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_ssm_decode_step_matches_reference(store, impl, monkeypatch):
    rng = np.random.default_rng(12)
    cfg = S.SSMCfg(**SSM)
    params = _draw(RS.ssm_params(RS.SSMCfg(**SSM)), rng)
    x = rng.normal(0, 1, (3, 1, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.normal(0, 1, (3, cfg.d_conv - 1, cfg.d_inner)),
          "h": rng.normal(0, 1, (3, cfg.d_inner, cfg.d_state))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    racts, acts = _acts(impl, store)
    align = TableAlign(monkeypatch)
    want, wst = jax.jit(lambda p, x, s: RS.ssm_decode_step(
        p, RS.SSMCfg(**SSM), x, s, racts, RM.ShardCtx()))(
            params, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, st))
    with torch.no_grad():
        got, new = S.ssm_decode_step(_t(params), cfg, torch.from_numpy(x),
                                     _t(st), acts)
    align.check()
    _close(got, want, MODULE_REL, "y")
    for k in ("conv", "h"):
        _close(new[k], wst[k], MODULE_REL, k)


@pytest.mark.parametrize("t", LENGTHS)
@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_rwkv_time_mix_matches_reference(store, impl, t, monkeypatch):
    rng = np.random.default_rng(20 + t)
    params = _draw(RR.rwkv_time_params(RR.RWKVCfg(**RWKV)), rng)
    x = rng.normal(0, 1, (2, t, RWKV["d_model"])).astype(np.float32)
    racts, acts = _acts(impl, store)
    align = TableAlign(monkeypatch)
    want, (wlast, ws) = jax.jit(lambda p, x: RR.rwkv_time_mix(
        p, RR.RWKVCfg(**RWKV), x, racts, RM.ShardCtx(),
        return_state=True))(params, jnp.asarray(x))
    with torch.no_grad():
        got, (last, s) = R.rwkv_time_mix(_t(params), R.RWKVCfg(**RWKV),
                                         torch.from_numpy(x), acts,
                                         return_state=True)
    align.check()
    _close(got, want, MODULE_REL, "y")
    np.testing.assert_array_equal(last.numpy(), np.asarray(wlast))
    _close(s, ws, MODULE_REL, "s")


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_rwkv_channel_mix_matches_reference(store, impl, monkeypatch):
    rng = np.random.default_rng(30)
    params = _draw(RR.rwkv_channel_params(RR.RWKVCfg(**RWKV)), rng)
    x = rng.normal(0, 1, (2, 5, RWKV["d_model"])).astype(np.float32)
    last = rng.normal(0, 1, (2, 1, RWKV["d_model"])).astype(np.float32)
    racts, acts = _acts(impl, store)
    align = TableAlign(monkeypatch)
    for x_last in (None, last):
        want = jax.jit(lambda p, x, xl: RR.rwkv_channel_mix(
            p, RR.RWKVCfg(**RWKV), x, racts, RM.ShardCtx(), x_last=xl))(
                params, jnp.asarray(x),
                None if x_last is None else jnp.asarray(x_last))
        with torch.no_grad():
            got = R.rwkv_channel_mix(
                _t(params), R.RWKVCfg(**RWKV), torch.from_numpy(x), acts,
                x_last=None if x_last is None else torch.from_numpy(x_last))
        _close(got, want, MODULE_REL, f"x_last {x_last is not None}")
    align.check()


@pytest.mark.parametrize("impl", ["exact", "ppa"])
@pytest.mark.parametrize("kind", ["ssm", "rwkv"])
def test_prefill_carry_is_decode_steps(kind, impl):
    """The mixer over 13 tokens (13 chunks of 1) and 16 (2 chunks of 8)
    against the same tokens one decode step at a time from the zero state:
    each output and the final carry."""
    rng = np.random.default_rng(40)
    _, acts = _acts(impl, None)
    for t in LENGTHS:
        if kind == "ssm":
            cfg = S.SSMCfg(**SSM)
            params = _t(_draw(RS.ssm_params(RS.SSMCfg(**SSM)), rng))
            state = S.init_ssm_state(2, cfg, torch.float32, "cpu")
        else:
            cfg = R.RWKVCfg(**RWKV)
            params = _t(_draw(RR.rwkv_time_params(RR.RWKVCfg(**RWKV)), rng))
            state = R.init_rwkv_state(2, cfg, cfg.d_model, torch.float32,
                                      "cpu")
            state = (state["tm_last"], state["s"])
        x = torch.from_numpy(
            rng.normal(0, 1, (2, t, cfg.d_model)).astype(np.float32))
        ys = []
        with torch.no_grad():
            if kind == "ssm":
                want, carry = S.ssm_mixer(params, cfg, x, acts,
                                          return_state=True)
                for i in range(t):
                    y, state = S.ssm_decode_step(params, cfg, x[:, i:i + 1],
                                                 state, acts)
                    ys.append(y)
                pairs = [(state[k], carry[k]) for k in ("conv", "h")]
            else:
                want, carry = R.rwkv_time_mix(params, cfg, x, acts,
                                              return_state=True)
                for i in range(t):
                    y, *state = R.time_core(params, cfg, x[:, i:i + 1],
                                            *state, acts)
                    ys.append(y)
                pairs = list(zip(state, carry))
        _close(torch.cat(ys, 1), want.numpy(), CARRY_REL, f"y at {t}")
        for got, ref in pairs:
            _close(got, ref.numpy(), CARRY_REL, f"carry at {t}")


def ref_params(rcfg, seed: int = 0):
    """A parameter tree of ``rcfg`` in the reference's layout, every leaf
    drawn at random with numpy (``_draw``): what ``params_from_jax``
    carries across.  The reference's own initializer would take 3-8 s to
    trace for a smoke config here."""
    return _draw(RM.param_specs(rcfg), np.random.default_rng(seed))


def smoke_pair(arch):
    """(reference cfg, port cfg, reference-layout params) of ``arch``'s
    smoke config with ``act_impl="ppa"``."""
    rcfg = RC.get_smoke_config(arch).replace(act_impl="ppa")
    cfg = get_smoke_config(arch).replace(act_impl="ppa")
    return rcfg, cfg, ref_params(rcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_params_carry_across(arch):
    """The smoke configs' spec trees equal the reference's, and a
    parameter tree in the reference's layout (``a_log``, ``u_bonus``,
    ``ln_x`` and the (5, d) and (2, d) ``mu`` leaves among them) carries
    across leaf for leaf, values and dtypes; ``init_params`` draws every
    leaf at its shape."""
    rcfg, cfg, rparams = smoke_pair(arch)
    flat = jax.tree_util.tree_flatten_with_path(
        RM.param_specs(rcfg), is_leaf=lambda x: isinstance(x, RM.P))[0]
    mine = dict(leaves_with_path(param_specs(cfg)))
    assert len(mine) == len(flat)
    for path, spec in flat:
        node = mine["/".join(k.key for k in path)]
        assert (node.shape, node.axes, node.init, node.scale) == (
            spec.shape, spec.axes, spec.init, spec.scale), path
    want = dict(leaves_with_path(rparams))
    got = dict(leaves_with_path(params_from_jax(rparams, "cpu")))
    drawn = dict(leaves_with_path(init_params(param_specs(cfg), 0,
                                              device="cpu")))
    assert set(got) == set(want) == set(drawn)
    names = {part for k in got for part in k.split("/")}
    new = ({"ssm", "a_log", "conv_w", "d_skip", "w_dt"} if rcfg.ssm_inner
           else {"tm", "cm", "u_bonus", "ln_x", "w_lora_b", "mu"})
    assert new <= names, new - names
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, k)
        assert got[k].dtype == torch.float32 and tuple(
            drawn[k].shape) == v.shape, k
    if not rcfg.ssm_inner:
        mu = {k: v.shape for k, v in want.items() if k.endswith("/mu")}
        assert sorted(mu.values()) == [(2, 2, cfg.d_model),
                                       (2, 5, cfg.d_model)], mu


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_carries_keep_no_chunk_alive(arch):
    """Prefill packs a layer's final carries as copies: a view of the
    chunk's whole (B, T, ...) state tensor would keep it alive until the
    last layer is packed (32 x 42 MB for one 64-token prompt at rwkv6-3b's
    width).  Each packed leaf owns just its own bytes."""
    from repro_torch.models import transformer as T
    _, cfg, rparams = smoke_pair(arch)
    params = prepare_params(params_from_jax(rparams, "cpu"), cfg)
    st = cfg.stages[0]
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    positions = torch.arange(16, dtype=torch.int32).expand(2, 16)
    with torch.no_grad():
        _, state, _ = T._layer(cfg, st, make_acts("ppa", "ref", "cpu"),
                               positions, h,
                               params["stages"][f"s0_{st.kind}"][0])
        packed = T._pack_state(state, positions, 32, torch.float32)
    for path, t in leaves_with_path(packed):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size(), (
            path, t.untyped_storage().nbytes())
