"""The PyTorch port's training path against the JAX reference.

Same inputs (seeded numpy, or the reference's own parameters carried
across) through ``repro`` and ``repro_torch``: the schedule, the four
optimizers, gradient clipping, the chunked cross entropy, the softmax's
backward, one train step of the internlm2-1.8b smoke config with
``act_impl="ppa"`` on the ``ref``, ``cuda_int`` and ``cuda_fused``
backends (plain versions on CPU tensors), gradient accumulation, the data
streams, checkpoints (each package restores the other's), the watchdog,
crash and resume, and the launcher's device rule.  The reference's PPA
tables come from the in-memory store of the shipped tables
(``test_torch_models.seeded_store``), so nothing compiles here.
"""

import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as RCK  # noqa: E402
import repro.configs as RC  # noqa: E402
import repro.data as RD  # noqa: E402
import repro.kernels as RK  # noqa: E402
import repro.models as RM  # noqa: E402
from repro.models import StageCfg as RStageCfg  # noqa: E402
import repro.train as RT  # noqa: E402
import repro.train.train_step as RTS  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
from repro.models.layers import \
    cross_entropy_chunked as ref_cross_entropy  # noqa: E402
from repro_torch import checkpoint as CK  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data import (SyntheticLM, TokenFileDataset,  # noqa: E402
                              write_token_file)
from repro_torch.kernels import softmax_ppa  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import make_acts, params_from_jax  # noqa: E402
from repro_torch.models.layers import cross_entropy_chunked  # noqa: E402
from repro_torch.runtime import StepHang, Watchdog  # noqa: E402
from repro_torch.train import (OptCfg, ScheduleCfg, TrainCfg,  # noqa: E402
                               clip_grads, global_norm, lr_at,
                               make_train_step, opt_init, opt_update,
                               train_init)
from repro_torch.tree import leaves_with_path, map_tree  # noqa: E402

from test_torch_kernels import _pair  # noqa: E402
from test_torch_models import seeded_store  # noqa: E402

ARCH = "internlm2-1.8b"
#: float32 elementwise arithmetic in the reference's order; XLA and torch
#: differ in the last place of pow, sqrt-and-divide chains and of means
#: (another summation order)
#: (adafactor's update clipping puts a mean over the whole leaf into every
#: update: one ulp of a parameter of size 0.1, 7.5e-9, where it is near 0)
OPT_RTOL, OPT_ATOL = 2e-6, 1e-8
#: XLA's float32 cos and torch's differ in the last place on about 4% of
#: inputs in [0, pi]: one ulp of a value up to 1, 2^-23, which the
#: schedule scales by 0.45 peak_lr; everything else in lr_at is exact (the
#: warmup ramp and the ends of the cosine are held bit for bit)
LR_ATOL_OF_PEAK = 2.0 ** -22
#: float32 logits and log-sum-exp, reduced in another order
CE_RTOL, CE_ATOL = 1e-5, 1e-6
#: the closed form against jax.vjp of the composition: 2^s against
#: T'(f) 2^k log2(e) with T' = 2^f ln 2, rounded at other places
SOFTMAX_GRAD_RTOL, SOFTMAX_GRAD_ATOL = 1e-5, 1e-6
#: one smoke train step, port against reference: the loss and grad norm
#: relative; each gradient leaf against its own largest magnitude.  Both
#: packages' float32 backward pass is this far from a float64 computation
#: of the same gradient: on this batch, with exact activations, the port
#: within 7.4e-5 of each leaf's largest magnitude and the reference within
#: 2.7e-5 (matmuls, the vocab log-sum-exp and RMSNorm reduced in other
#: orders); the measured gap between the two is 7.4e-5
STEP_LOSS_RTOL = 1e-6
STEP_GRAD_REL = 2e-4
#: parameters after one sgdm or adamw step, which moves each by lr times
#: a gradient or a normalised gradient (see the test for adamw's gradients
#: near 0)
STEP_PARAM_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got: torch.Tensor, want, rtol, atol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=what)


# ----------------------------------------------------------------- schedule
@pytest.mark.parametrize("cfg", [
    ScheduleCfg(), ScheduleCfg(peak_lr=3e-4, warmup_steps=20, decay_steps=100),
    ScheduleCfg(peak_lr=1e-3, warmup_steps=0, decay_steps=7)],
    ids=["default", "launcher", "no-warmup"])
def test_lr_at_matches_reference(cfg):
    rcfg = RT.ScheduleCfg(**dataclasses.asdict(cfg))
    steps = range(0, 260)
    got = np.array([lr_at(cfg, s).item() for s in steps], np.float32)
    want = np.array([np.float32(RT.lr_at(rcfg, s)) for s in steps])
    warm = np.array([s < cfg.warmup_steps for s in steps])
    ends = np.array([s in (cfg.warmup_steps, cfg.decay_steps)
                     or s > cfg.decay_steps for s in steps])
    exact = warm | ends
    np.testing.assert_array_equal(got[exact].view(np.uint32),
                                  want[exact].view(np.uint32))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LR_ATOL_OF_PEAK * cfg.peak_lr)
    assert lr_at(cfg, 0).item() == 0.0 or cfg.warmup_steps == 0
    assert lr_at(cfg, 0).dtype == torch.float32


# ---------------------------------------------------------------- optimizer
def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(2, 128, 136)).astype(np.float32),
            "b": {"scale": rng.normal(size=(136,)).astype(np.float32),
                  "m": rng.normal(size=(9, 5)).astype(np.float32)}}


@pytest.mark.parametrize("kind", ["sgdm", "adamw", "adamw8", "adafactor"])
def test_opt_update_matches_reference(kind):
    """Three updates from the same params, grads and state: params and
    every moment (int8 moments within one step of their grid, their scales
    and the float moments within OPT_RTOL)."""
    cfg = OptCfg(kind=kind)
    rcfg = RT.OptCfg(kind=kind)
    p_np = _opt_tree(0)
    rp = jax.tree_util.tree_map(jnp.asarray, p_np)
    rs = RT.opt_init(rcfg, rp)
    # each package its own buffers: jnp.asarray may alias an aligned numpy
    # array on the CPU, and opt_update writes the port's params in place
    tp = params_from_jax(p_np, "cpu")
    ts = params_from_jax(_np(rs), "cpu")
    for i in range(3):
        g_np = map_tree(lambda a: a * 0.1, _opt_tree(10 + i))
        lr = np.float32(1e-2 / (i + 1))
        rp, rs = RT.opt_update(rcfg, jax.tree_util.tree_map(jnp.asarray,
                                                            g_np),
                               rs, rp, jnp.float32(lr))
        tp, ts = opt_update(cfg, params_from_jax(g_np, "cpu"), ts, tp,
                            torch.tensor(lr))
    assert int(ts["count"]) == int(rs["count"]) == 3
    for (k, got), (_, want) in zip(leaves_with_path(tp),
                                   leaves_with_path(_np(rp))):
        _close(got, want, OPT_RTOL, OPT_ATOL, k)
    for (k, got), (_, want) in zip(leaves_with_path(ts),
                                   leaves_with_path(_np(rs))):
        want = np.array(want)
        assert got.dtype == torch.from_numpy(want).dtype, k
        if got.dtype == torch.int8:
            assert int((got.int() - torch.from_numpy(want).int()
                        ).abs().max()) <= 1, k
        else:
            _close(got, want, OPT_RTOL, OPT_ATOL, k)


#: adafactor's update clipping divides a leaf's update by the RMS of the
#: whole leaf, the mean of n positive float32 terms.  Summed in any order,
#: and divided by n, such a mean is within GAMMA(n) = n u / (1 - n u)
#: (u = 2^-24) of the exact one (Higham, Accuracy and Stability of
#: Numerical Algorithms, 2nd ed., (4.4)): two orders within 2 GAMMA(n) of
#: each other.  The square root halves a relative gap, so the clipped update
#: u~ = upd / max(rms, 1) moves by at most GAMMA(n) |u~|, and a parameter's
#: step lr u~ by GAMMA(n) lr |u~|, summed over the steps (the moments do not
#: read the parameters).  XLA and torch take the mean in other orders on
#: the CPU, and the card in a third, so this term is stated beside the
#: optimizer's tolerances for adafactor's leaves: on one unfactored (4, 64,
#: 32) leaf the port missed OPT_ATOL + OPT_RTOL |p| by up to 2.4e-7 on 15
#: of 8192 parameters near 0, each 1 ulp of the mean apart.
def rms_gamma(n: int) -> float:
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def rms_order_atol(trajectory, lrs, weight_decay):
    """GAMMA(n) x sum_i lr_i |u~_i| for one leaf, read off the reference's
    parameters before and after each step (``trajectory``: n_steps + 1
    arrays): lr u~ = -(p_i - p_{i-1}) - lr wd p_{i-1}."""
    p = [np.asarray(a, np.float64) for a in trajectory]
    steps = sum(np.abs(b - a + lr * weight_decay * a)
                for a, b, lr in zip(p, p[1:], lrs))
    return rms_gamma(p[0].size) * steps


def assert_opt_close(got, want, extra, what=""):
    """Within OPT_ATOL + OPT_RTOL |want| + ``extra`` (elementwise)."""
    got, want = np.asarray(got), np.asarray(want)
    gap = np.abs(got.astype(np.float64) - want)
    bad = gap > OPT_ATOL + OPT_RTOL * np.abs(want) + extra
    assert not bad.any(), (what, int(bad.sum()), float(gap.max()))


ADA_LEAF, ADA_SEED, ADA_STEPS = (4, 64, 32), 7, 3
#: the control's move of the port's whole-leaf mean: twice what the two
#: orders may differ by
ADA_CONTROL = 4.0


@pytest.mark.parametrize("control", [False, True], ids=["port", "control"])
def test_adafactor_large_unfactored_leaf_matches_reference(control,
                                                           monkeypatch):
    """One unfactored (4, 64, 32) leaf, N(0, 1) parameters, gradients
    0.1 N(0, 1), three adafactor steps at lr 1e-2 / (i + 1): the port
    within the optimizer's tolerances plus the RMS mean's order term
    (``rms_order_atol``), its moments within the optimizer's tolerances.
    The control moves the port's whole-leaf mean by ADA_CONTROL x
    GAMMA(n), beyond what the term allows, and must miss it."""
    from repro_torch.train import optimizer as O
    if control:
        means = O._means

        def moved(p=None):
            mean = means(p)

            def m(x, dim=None, keepdim=False, leaf_dim=None):
                out = mean(x, dim, keepdim, leaf_dim)
                return out * (1 + ADA_CONTROL * rms_gamma(x.numel())) \
                    if dim is None else out
            return m
        monkeypatch.setattr(O, "_means", moved)
    rng = np.random.default_rng(ADA_SEED)
    p0 = rng.normal(size=ADA_LEAF).astype(np.float32)
    grads = [(0.1 * rng.normal(size=ADA_LEAF)).astype(np.float32)
             for _ in range(ADA_STEPS)]
    cfg, rcfg = OptCfg(kind="adafactor"), RT.OptCfg(kind="adafactor")
    rp = {"w": jnp.array(p0, copy=True)}
    rs = RT.opt_init(rcfg, rp)
    tp = params_from_jax({"w": p0}, "cpu")
    ts = params_from_jax(_np(rs), "cpu")
    assert set(ts["mu"]["w"]) == {"v"}          # unfactored
    traj, lrs = [p0], []
    for i, g in enumerate(grads):
        lr = np.float32(1e-2 / (i + 1))
        rp, rs = RT.opt_update(rcfg, {"w": jnp.array(g, copy=True)}, rs, rp,
                               jnp.float32(lr))
        tp, ts = opt_update(cfg, params_from_jax({"w": g}, "cpu"), ts, tp,
                            torch.tensor(lr))
        traj.append(np.array(rp["w"]))
        lrs.append(float(lr))
    extra = rms_order_atol(traj, lrs, cfg.weight_decay)
    _close(ts["mu"]["w"]["v"], np.asarray(rs["mu"]["w"]["v"]), OPT_RTOL,
           OPT_ATOL, "v")
    if not control:
        assert_opt_close(tp["w"].numpy(), traj[-1], extra, "w")
    else:
        with pytest.raises(AssertionError):
            assert_opt_close(tp["w"].numpy(), traj[-1], extra, "w")


def _aligned(shape, seed):
    """A float32 numpy array whose buffer starts on a 64-byte boundary,
    which ``jnp.asarray`` on the CPU may wrap without a copy."""
    n = int(np.prod(shape)) * 4
    raw = np.empty(n + 64, np.uint8)
    off = -raw.ctypes.data % 64
    a = raw[off:off + n].view(np.float32).reshape(shape)
    a[...] = np.random.default_rng(seed).normal(size=shape)
    return a


def test_port_copy_does_not_share_the_reference_buffer():
    """What the optimizer test hands the port (``params_from_jax``) owns
    its memory: an in-place write by the port leaves the reference's array
    and the numpy source as they were."""
    a = _aligned((9, 5), 0)
    assert a.ctypes.data % 64 == 0
    want = a.copy()
    ref = jnp.asarray(a)
    got = params_from_jax({"m": a}, "cpu")["m"]
    assert not np.shares_memory(got.numpy(), a)
    assert got.data_ptr() != ref.unsafe_buffer_pointer()
    got.add_(1.0)
    np.testing.assert_array_equal(np.asarray(ref.block_until_ready()), want)
    np.testing.assert_array_equal(a, want)
    np.testing.assert_array_equal(got.numpy(), want + 1.0)


def test_clip_grads_and_global_norm_match_reference():
    g_np = _opt_tree(3)
    rg = jax.tree_util.tree_map(jnp.asarray, g_np)
    tg = params_from_jax(g_np, "cpu")
    _close(global_norm(tg), RT.global_norm(rg), 1e-6, 0)
    for max_norm in (1.0, 1e4):
        (got, n), (want, rn) = clip_grads(tg, max_norm), RT.clip_grads(
            rg, max_norm)
        _close(n, rn, 1e-6, 0)
        for (k, a), (_, b) in zip(leaves_with_path(got),
                                  leaves_with_path(_np(want))):
            _close(a, b, 1e-6, 0, k)
    assert torch.equal(clip_grads(tg, 1e4)[0]["w"], tg["w"])


def test_clip_grads_match_reference_where_the_sum_of_squares_overflows():
    """Gradients whose norm is beyond float32's square root of its largest
    value (whisper-medium's and hymba-1.5b's at their random init): the
    reference's float32 sum of squares overflows to inf and its clip
    scales every gradient to 0.  The port does the same: an inf norm and
    every clipped gradient 0, as the reference's."""
    rng = np.random.default_rng(5)
    g_np = {"w": (rng.normal(size=(64, 32)) * 1e19).astype(np.float32),
            "b": rng.normal(size=(32,)).astype(np.float32)}
    rg, rn = RT.clip_grads(jax.tree_util.tree_map(jnp.asarray, g_np), 1.0)
    assert float(rn) == np.inf
    got, n = clip_grads(params_from_jax(g_np, "cpu"), 1.0)
    assert float(n) == float(rn)
    for (k, a), (_, b) in zip(leaves_with_path(got),
                              leaves_with_path(_np(rg))):
        assert not b.any() and not a.any(), k
        assert a.shape == b.shape and a.dtype == torch.float32, k


def test_run_training_logs_a_gradient_norm_that_is_not_finite(monkeypatch,
                                                              capsys):
    """A step whose gradient norm is not finite is logged and returned, as
    the metrics logger records it (None in its JSON), not a formatting
    error."""
    def fake_step(cfg, tcfg, acts):
        def step(params, tstate, batch):
            return params, tstate, {"loss": torch.tensor(6.0),
                                    "grad_norm": torch.tensor(np.inf),
                                    "lr": torch.tensor(1e-4),
                                    "param_norm": torch.tensor(1.0)}
        return step
    monkeypatch.setattr(launch_train, "make_train_step", fake_step)
    out = launch_train.run_training(
        get_smoke_config(ARCH), steps=2, ckpt_dir=None, resume="none",
        ckpt_every=0, batch_override=2, seq_override=8, device="cpu")
    assert out["grad_norms"] == [np.inf, np.inf]
    assert out["param_norms"] == [1.0, 1.0]
    assert "gnorm inf" in capsys.readouterr().out


# ------------------------------------------------------------ cross entropy
def test_cross_entropy_chunked_value_and_grad():
    """A mask, and 14 positions that 4 chunks do not divide (7 of 2)."""
    rng = np.random.default_rng(4)
    b, t, e, v = 2, 14, 16, 37
    x = rng.normal(size=(b, t, e)).astype(np.float32)
    head = (rng.normal(size=(v, e)) * 0.3).astype(np.float32)
    labels = rng.integers(0, v, (b, t)).astype(np.int32)
    mask = (rng.random((b, t)) < 0.8).astype(np.float32)

    def ref(xx, hh):
        return ref_cross_entropy(xx, hh, jnp.asarray(labels),
                                 mask=jnp.asarray(mask), num_chunks=4)

    rl, (rgx, rgh) = jax.value_and_grad(
        lambda a, b_: ref(a, b_)[0], argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    loss, den = cross_entropy_chunked(tx, th, torch.from_numpy(labels),
                                      mask=torch.from_numpy(mask),
                                      num_chunks=4)
    loss.backward()
    _close(loss, rl, CE_RTOL, 0)
    assert float(den) == float(ref(jnp.asarray(x), jnp.asarray(head))[1])
    _close(tx.grad, rgx, CE_RTOL, CE_ATOL, "dx")
    _close(th.grad, rgh, CE_RTOL, CE_ATOL, "dhead")


# --------------------------------------------------------- softmax backward
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_softmax_bwd_plain_is_reference_vjp(bits, masked):
    """The closed form against jax.vjp of the reference's ppa_softmax, with
    a three-way tie for one row's max and, masked, an all-masked row."""
    rtc, tc = _pair("exp2_frac", bits)
    rng = np.random.default_rng(41)
    x = rng.normal(0, 3, size=(2, 3, 5, 40)).astype(np.float32)
    x[0, 1, 2, [3, 17, 30]] = x[0, 1, 2].max() + 1.0
    g = rng.normal(size=x.shape).astype(np.float32)
    where = rng.random((2, 1, 5, 40)) < 0.7 if masked else None
    if masked:
        where[1, 0, 2] = False
        where[0, 0, 2, [3, 17, 30]] = True
    jw = None if where is None else jnp.asarray(where)
    _, vjp = jax.vjp(lambda v: RK.ppa_softmax(rtc, v, where=jw),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tw = None if where is None else torch.from_numpy(where)
    got = softmax_ppa.softmax_ppa_bwd(torch.from_numpy(x),
                                      torch.from_numpy(g), tc, tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SOFTMAX_GRAD_RTOL,
                               atol=SOFTMAX_GRAD_ATOL)
    if masked:
        assert not got[1, :, 2].any()
    assert float(got[0, 1, 2, [3, 17, 30]].abs().min()) > 0.0


#: the longest rows of the card's training, each across 4 warps of a block
#: in the backward's row kernel, at batch 1 and a few heads: whisper's
#: encoder and cross attention (rows of 1500, every key valid) and hymba's
#: windowed layers (rows of 2048, keys within a window of 1024 of a causal
#: query), held at query rows across the sequence
LONG_ROWS = {"whisper 1500 unmasked": ((1, 3, 1, 40, 1500), None, None),
             "hymba 2048 window 1024": ((1, 2, 2, 40, 2048), 1024, True)}


@pytest.mark.parametrize("case", list(LONG_ROWS))
def test_softmax_bwd_plain_is_reference_vjp_on_long_rows(case):
    shape, window, causal = LONG_ROWS[case]
    rtc, tc = _pair("exp2_frac", 16)
    rng = np.random.default_rng(43)
    x = rng.normal(0, 4, size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    where = None
    if causal:
        t, s = shape[-2:]
        qp = np.linspace(0, s - 1, t).astype(np.int64)[:, None]
        kp = np.arange(s)[None, :]
        where = np.broadcast_to((kp <= qp) & (kp > qp - window),
                                (shape[0], 1, 1, t, s))
        assert where.sum(-1).max() == window and where.sum(-1).min() == 1
    jw = None if where is None else jnp.asarray(where)
    _, vjp = jax.vjp(lambda v: RK.ppa_softmax(rtc, v, where=jw),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tw = None if where is None else torch.from_numpy(where.copy())
    got = softmax_ppa.softmax_ppa_bwd_plain(torch.from_numpy(x),
                                            torch.from_numpy(g), tc, tw)
    assert softmax_ppa.bwd_route(shape[-1], True)[0] == 4
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SOFTMAX_GRAD_RTOL,
                               atol=SOFTMAX_GRAD_ATOL)


# ------------------------------------------------------------- train step
@pytest.fixture(scope="module")
def smoke():
    """The smoke config (ppa), the reference's params and a train_init
    state of each optimizer, and the same batch for both packages."""
    rcfg = RC.get_smoke_config(ARCH).replace(act_impl="ppa")
    cfg = get_smoke_config(ARCH).replace(act_impl="ppa")
    rparams = RM.init_params(RM.param_specs(rcfg), jax.random.PRNGKey(0))
    batch = {k: np.asarray(v) for k, v in
             RD.SyntheticLM(vocab=rcfg.vocab, seq_len=16,
                            global_batch=4).batch_at(3).items()}
    return rcfg, cfg, rparams, batch


@pytest.fixture(scope="module")
def ref_steps(smoke):
    """The reference's train step (jitted once per optimizer), its
    gradients, and the state after one step, from the reference's acts
    over the shipped tables."""
    rcfg, _, rparams, batch = smoke
    store = seeded_store()
    racts = ref_make_acts("ppa", "ref", store)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(RM.loss_fn, has_aux=True)(
        rparams, rcfg, jb, racts, RM.ShardCtx())
    out = {"loss": float(loss), "grads": _np(grads)}
    saved = RTS.make_model_acts
    RTS.make_model_acts = lambda cfg: racts
    try:
        for kind in ("sgdm", "adamw"):
            tcfg = RT.TrainCfg(opt=RT.OptCfg(kind=kind))
            state = RT.train_init(tcfg, rparams)
            step = jax.jit(RT.make_train_step(rcfg, tcfg, RM.ShardCtx()))
            p1, s1, m = step(rparams, state, jb)
            out[kind] = (_np(state), _np(p1), _np(s1), _np(m))
    finally:
        RTS.make_model_acts = saved
    return out


@pytest.mark.parametrize("backend", ["ref", "cuda_int", "cuda_fused"])
def test_train_step_loss_and_grads_match_reference(smoke, ref_steps,
                                                   backend):
    from repro_torch.models import loss_fn
    _, cfg, rparams, batch = smoke
    params = params_from_jax(_np(rparams), "cpu")
    leaf = map_tree(lambda p: p.requires_grad_(True), params)
    acts = make_acts("ppa", backend, "cpu")
    loss, aux = loss_fn(leaf, cfg, {k: torch.from_numpy(v)
                                    for k, v in batch.items()}, acts)
    loss.backward()
    assert abs(float(loss.detach()) - ref_steps["loss"]) <= STEP_LOSS_RTOL * abs(
        ref_steps["loss"])
    assert float(aux["denom"]) == batch["labels"].size
    for (k, p), (_, want) in zip(leaves_with_path(leaf),
                                 leaves_with_path(ref_steps["grads"])):
        scale = float(np.abs(want).max())
        assert scale > 0, k
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= STEP_GRAD_REL * scale, (k, err, scale)


@pytest.mark.parametrize("kind", ["sgdm", "adamw"])
@pytest.mark.parametrize("backend", ["ref", "cuda_int", "cuda_fused"])
def test_train_step_matches_reference(smoke, ref_steps, backend, kind):
    """make_train_step on state carried from the reference's train_init:
    loss, grad norm, lr, param norm, then every parameter and moment."""
    _, cfg, rparams, batch = smoke
    rstate, rp1, rs1, rm = ref_steps[kind]
    tcfg = TrainCfg(opt=OptCfg(kind=kind))
    params = params_from_jax(_np(rparams), "cpu")
    state = params_from_jax(rstate, "cpu")
    step = make_train_step(cfg, tcfg, make_acts("ppa", backend, "cpu"))
    params, state, m = step(params, state,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    for name, rtol in (("loss", STEP_LOSS_RTOL), ("grad_norm", STEP_GRAD_REL),
                       ("param_norm", STEP_LOSS_RTOL)):
        _close(m[name], rm[name], rtol, 0, name)
    assert m["lr"].numpy().view(np.uint32) == np.float32(rm["lr"]).view(
        np.uint32)
    assert int(state["step"]) == int(rs1["step"]) == 1
    lr = float(rm["lr"])
    for (k, got), (_, want), (_, g) in zip(
            leaves_with_path(params), leaves_with_path(rp1),
            leaves_with_path(ref_steps["grads"])):
        err = np.abs(got.numpy() - want)
        # adamw's first step moves a parameter by lr g / (|g| + eps): where
        # g is within its own bound (STEP_GRAD_REL of the leaf's largest) of
        # 0, its sign is not determined, and the two may move up to 2 lr
        # apart
        loose = (np.abs(g) <= STEP_GRAD_REL * np.abs(g).max()
                 if kind == "adamw" else np.zeros(g.shape, bool))
        assert float(err[~loose].max(initial=0)) <= STEP_PARAM_ATOL, k
        assert float(err[loose].max(initial=0)) <= 2 * lr * (1 + 1e-6), k
    for (k, got), (_, want) in zip(leaves_with_path(state),
                                   leaves_with_path(rs1)):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.numpy() - want).max()) <= (
            STEP_GRAD_REL * scale), k


# ------------------------------------------------------- published depth
#: The published depth, 24 layers, at the smoke width and at d_model 128.
#: At the reference's init (fan-in scaled, no residual scaling) the
#: gradient grows layer by layer toward the input, nearly all of it in the
#: embedding (norm 1.9e3 at the smoke width, 2.8e4 at d_model 128), and
#: the float32 pass is ill-conditioned there: moving the reference's own
#: parameters by a seeded +-2^-24 of themselves moves a layer's gradient by
#: up to 4e-1 of its norm, the gradient norm by up to 13% and the loss by
#: up to 7e-4.  The port is held to that sensitivity: the gap of each
#: layer's slice of each stacked gradient leaf (and of each other leaf),
#: over the reference's norm of it, within DEPTH_CTRL_RATIO times the
#: largest gap of DEPTH_CONTROLS such moves; the same for the gradient
#: norm and the loss.  Measured: at most 1.11 times.  Swapping layers 11
#: and 12 gives 23 to 437 times on a slice and 10 to 54 on the loss; the
#: 2-layer tests above do not see it.
DEPTH = 24
DEPTH_CONTROLS = 8
DEPTH_CTRL_RATIO = 4
DEPTH_WIDTHS = {"smoke": {},
                "d128": {"d_model": 128, "d_ff": 512, "head_dim": 32}}


def _nudged(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (x * (1 + 2.0 ** -24 * rng.choice([-1.0, 1.0], x.shape))
                   ).astype(x.dtype), tree)


def _depth_slices(tree):
    """(name, float64 array) of each layer of each stacked leaf, and of
    each other leaf."""
    for k, x in leaves_with_path(tree):
        x = np.asarray(x, np.float64)
        if k.startswith("stages/"):
            yield from ((f"{k}[{i}]", x[i]) for i in range(DEPTH))
        else:
            yield k, x


def _depth_gaps(got, want):
    return {k: float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for (k, a), (_, b) in zip(_depth_slices(got),
                                      _depth_slices(want))}


def _norm(tree):
    return float(np.sqrt(sum(np.square(x).sum()
                             for _, x in _depth_slices(tree))))


@pytest.fixture(scope="module")
def depth_refs():
    """The reference at the published depth, per (act_impl, width): its
    params, batch, loss and gradients, and the largest gap of its nudged
    controls per slice, in the gradient norm and in the loss."""
    cache, store = {}, seeded_store()

    def get(impl, width):
        if (impl, width) in cache:
            return cache[impl, width]
        rcfg = RC.get_smoke_config(ARCH).replace(
            act_impl=impl, stages=(RStageCfg("dec", DEPTH),),
            **DEPTH_WIDTHS[width])
        # the reference's init, jitted whole (one compile, not one a leaf)
        rparams = _np(jax.jit(functools.partial(
            RM.init_params, RM.param_specs(rcfg)))(jax.random.PRNGKey(0)))
        batch = {k: np.asarray(v) for k, v in
                 RD.SyntheticLM(vocab=rcfg.vocab, seq_len=16,
                                global_batch=4).batch_at(3).items()}
        racts = ref_make_acts(impl, "ref", store)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        f = jax.jit(lambda p: jax.value_and_grad(RM.loss_fn, has_aux=True)(
            p, rcfg, jb, racts, RM.ShardCtx()))
        (loss, _), grads = f(rparams)
        grads = _np(grads)
        env, norm_env, loss_env = {}, 0.0, 0.0
        for seed in range(1, DEPTH_CONTROLS + 1):
            (closs, _), cgrads = f(_nudged(rparams, seed))
            cgrads = _np(cgrads)
            loss_env = max(loss_env, abs(float(closs) - float(loss)))
            for k, v in _depth_gaps(cgrads, grads).items():
                env[k] = max(env.get(k, 0.0), v)
            norm_env = max(norm_env,
                           abs(_norm(cgrads) / _norm(grads) - 1.0))
        cache[impl, width] = (rparams, batch, float(loss), grads, env,
                              norm_env, loss_env)
        return cache[impl, width]
    return get


@pytest.mark.parametrize("impl,backend,width,remat", [
    ("ppa", "ref", "smoke", "none"),
    ("ppa", "cuda_int", "smoke", "none"),
    ("ppa", "cuda_fused", "smoke", "none"),
    ("ppa", "cuda_fused", "smoke", "dots"),
    ("ppa", "cuda_fused", "smoke", "full"),
    ("ppa", "cuda_fused", "d128", "dots")])
def test_published_depth_grads_match_reference(depth_refs, impl, backend,
                                               width, remat):
    """loss_fn at 24 layers against the reference, within the reference's
    own sensitivity at that depth (DEPTH_CTRL_RATIO)."""
    from repro_torch.models import StageCfg, loss_fn
    (rparams, batch, rloss, rgrads, env, norm_env,
     loss_env) = depth_refs(impl, width)
    cfg = get_smoke_config(ARCH).replace(
        act_impl=impl, stages=(StageCfg("dec", DEPTH),), remat=remat,
        **DEPTH_WIDTHS[width])
    leaf = map_tree(lambda p: p.requires_grad_(True),
                    params_from_jax(rparams, "cpu"))
    loss, _ = loss_fn(leaf, cfg, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                      make_acts(impl, backend, "cpu"))
    loss.backward()
    grads = map_tree(lambda p: p.grad.numpy(), leaf)
    gaps = _depth_gaps(grads, rgrads)
    ratio = {k: gaps[k] / env[k] for k in gaps}
    worst = max(ratio, key=ratio.get)
    norm_gap = abs(_norm(grads) / _norm(rgrads) - 1.0)
    loss = float(loss.detach())
    loss_gap = abs(loss - rloss)
    print(f"{impl}/{backend}/{width}/remat={remat}: loss {loss:.7f} "
          f"(ref {rloss:.7f}, gap {loss_gap:.2e}, controls {loss_env:.2e}); "
          f"grad norm {_norm(grads):.6e} (ref "
          f"{_norm(rgrads):.6e}, gap {norm_gap:.2e}, controls "
          f"{norm_env:.2e}); worst slice {worst} {gaps[worst]:.2e} = "
          f"{ratio[worst]:.2f} x its controls' {env[worst]:.2e}")
    assert loss_gap <= DEPTH_CTRL_RATIO * loss_env, (loss_gap, loss_env)
    assert ratio[worst] <= DEPTH_CTRL_RATIO, (worst, gaps[worst], env[worst])
    assert norm_gap <= DEPTH_CTRL_RATIO * norm_env, (norm_gap, norm_env)


def test_accum_steps_2_matches_1(smoke):
    """Two microbatches of 2 against one batch of 4: the mean of the two
    means is the whole batch's mean (every position counts)."""
    _, cfg, rparams, batch = smoke
    acts = make_acts("ppa", "cuda_fused", "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for accum in (1, 2):
        tcfg = TrainCfg(opt=OptCfg(kind="sgdm"), accum_steps=accum)
        params = params_from_jax(_np(rparams), "cpu")
        state = train_init(tcfg, params)
        outs.append(make_train_step(cfg, tcfg, acts)(params, state, tb))
    (p1, _, m1), (p2, _, m2) = outs
    _close(m2["loss"], m1["loss"].numpy(), 1e-6, 0)
    _close(m2["grad_norm"], m1["grad_norm"].numpy(), 1e-5, 0)
    for (k, a), (_, b) in zip(leaves_with_path(p2), leaves_with_path(p1)):
        _close(a, b.numpy(), 0, 1e-7, k)


# -------------------------------------------------------------------- data
def test_synthetic_batches_bit_for_bit():
    for kw in ({"vocab": 512, "seq_len": 64, "global_batch": 4},
               {"vocab": 92544, "seq_len": 33, "global_batch": 6,
                "host_id": 1, "num_hosts": 2, "seed": 3}):
        ours, ref = SyntheticLM(**kw), RD.SyntheticLM(**kw)
        for step in (0, 1, 7, 1000):
            a, b = ours.batch_at(step), ref.batch_at(step)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_memmap_cursor_round_trip(tmp_path):
    path = tmp_path / "toks.bin"
    write_token_file(path, np.arange(1000) % 97)
    ds = TokenFileDataset(str(path), seq_len=16, global_batch=4)
    rds = RD.TokenFileDataset(str(path), seq_len=16, global_batch=4)
    for _ in range(3):
        a, b = ds.next_batch(), rds.next_batch()
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    state = ds.state_dict()
    assert state == rds.state_dict()
    want = ds.next_batch()
    fresh = TokenFileDataset(str(path), seq_len=16, global_batch=4)
    fresh.load_state_dict(state)
    got = fresh.next_batch()
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["labels"], want["labels"])


# ------------------------------------------------------------- checkpoint
def _ckpt_tree():
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "b": torch.randn(4, generator=g).to(torch.bfloat16)}
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "opt": {"count": torch.tensor(7, dtype=torch.int32),
                     "mu": {"w": {"q": torch.randint(-127, 128, (3, 4),
                                                     generator=g,
                                                     dtype=torch.int8)}}}}
    return params, state


def test_checkpoint_round_trip_tmp_and_gc(tmp_path):
    tree = _ckpt_tree()
    for s in (1, 2, 3, 4):
        CK.save(tmp_path, s, tree, extra={"next_step": s}, keep=3)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003", "step_00000004"]
    (tmp_path / "step_00000009.tmp").mkdir()       # a crash mid-save
    assert CK.latest_step(tmp_path) == 4
    like = map_tree(torch.zeros_like, tree[0]), map_tree(torch.zeros_like,
                                                          tree[1])
    back, extra = CK.restore(tmp_path, 4, like)
    assert extra == {"next_step": 4}
    for (k, a), (_, b) in zip(leaves_with_path(back),
                              leaves_with_path(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_checkpoint_cross_restore(tmp_path):
    """The port writes, the reference reads; the reference writes, the
    port reads: equal leaves, bfloat16 included."""
    import ml_dtypes
    tree = _ckpt_tree()
    CK.save(tmp_path / "port", 5, tree, extra={"next_step": 5})
    jlike = jax.tree_util.tree_map(
        lambda t: np.zeros(tuple(t.shape),
                           ml_dtypes.bfloat16 if t.dtype == torch.bfloat16
                           else t.numpy().dtype), tree)
    rback, rextra = RCK.restore(tmp_path / "port", 5, jlike)
    assert rextra == {"next_step": 5}
    for (k, a), (_, b) in zip(leaves_with_path(rback),
                              leaves_with_path(tree)):
        bits = (b.view(torch.int16).numpy() if b.dtype == torch.bfloat16
                else b.numpy())
        a = np.asarray(a)
        np.testing.assert_array_equal(
            a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a, bits,
            err_msg=k)
    jtree = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a), rback)
    RCK.save(tmp_path / "ref", 6, jtree, extra={"next_step": 6})
    like = jax.tree_util.tree_map(torch.zeros_like, tree)
    back, extra = CK.restore(tmp_path / "ref", 6, like)
    assert extra == {"next_step": 6}
    for (k, a), (_, b) in zip(leaves_with_path(back),
                              leaves_with_path(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b), k


# --------------------------------------------------------------- watchdog
def test_watchdog_flags_stragglers_and_hangs():
    wd = Watchdog(straggler_factor=2.0, min_deadline_s=0.3,
                  deadline_factor=2.0)
    for _ in range(5):
        wd.step(time.sleep, 0.01)
    assert wd.stragglers == 0
    wd.step(time.sleep, 0.05)      # 5x median -> straggler
    assert wd.stragglers == 1
    with pytest.raises(StepHang):
        wd.step(time.sleep, 0.5)   # beyond the 0.3 s deadline
    assert wd.hangs == 1


def test_metrics_logger_takes_tensors(tmp_path):
    from repro_torch.runtime import MetricsLogger
    log = MetricsLogger(str(tmp_path / "m.jsonl"))
    rec = log.log(3, loss=torch.tensor(1.5), bad=torch.ones(2),
                  nan=torch.tensor(float("nan")))
    assert rec["loss"] == 1.5 and rec["nan"] is None
    assert isinstance(rec["bad"], str) and log.coerced == 2


# ------------------------------------------------------- crash and resume
def _run(tmp_path, **kw):
    cfg = get_smoke_config(ARCH).replace(act_impl="ppa")
    return launch_train.run_training(
        cfg, steps=6, ckpt_dir=str(tmp_path), ckpt_every=2,
        batch_override=2, seq_override=16, lr=3e-3, device="cpu", **kw)


def test_crash_and_resume_equals_uninterrupted(tmp_path):
    whole = _run(tmp_path / "whole")["losses"]
    with pytest.raises(SystemExit) as ex:
        _run(tmp_path / "crash", simulate_crash_at=3)
    assert ex.value.code == 42
    assert CK.latest_step(tmp_path / "crash") == 2
    resumed = _run(tmp_path / "crash")["losses"]
    assert len(whole) == 6 and len(resumed) == 4
    assert resumed == whole[2:]


def test_train_launcher_needs_a_card_unless_told(tmp_path, monkeypatch,
                                                 capsys):
    argv = ["--arch", ARCH, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "8", "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(argv)
    launch_train.main(argv + ["--device", "cpu", "--act-impl", "ppa"])
    assert "done: final loss" in capsys.readouterr().out
    assert CK.latest_step(tmp_path) == 2


def test_kernel_softmax_backward_runs_its_plain_version_on_cpu():
    """On CPU tensors the kernel backends' softmax backward is the
    backward's plain version: one call, and no plain forward composition
    in the backward."""
    tc = _pair("exp2_frac", 16)[1]
    x = torch.randn(2, 3, 9, generator=torch.Generator().manual_seed(0)
                    ).requires_grad_(True)
    K.reset_counts()
    y = K.ppa_softmax(tc, x, backend="cuda_fused")
    y.backward(torch.ones_like(y))
    c = K.read_counts()
    assert c["softmax_ppa"]["plain"] == 1
    assert c["softmax_ppa_bwd"]["plain"] == 1
    assert c["softmax_ppa_bwd"]["launches"] == 0
