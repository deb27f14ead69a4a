"""The port's attention options against the JAX reference.

A ``dec`` smoke variant of internlm2-1.8b (2 layers, d_model 64, float32)
with one option at a time: QKV bias, qk-norm, a sliding window of 8 with
prompts longer than it, and flash attention with a chunk that does not
divide the prompt at first (5 for 12 tokens: the reference shrinks it to
4).  The reference's parameters carry across (``params_from_jax``); the
biases and norm scales, which initialise to 0 and 1, are drawn at random
so that they matter.  Prefill logits and 8 greedy decode steps against
``repro.models.prefill`` / ``decode_step``, with ``exact`` and ``ppa``
activations (the shipped tables on both sides, the ``ref`` backend), with
a float32 decode cache: a bf16 cache would round K and V, and an entry one
float32 rounding from a bf16 boundary rounds one bf16 step apart.

With ``ppa``, float32 matmuls that reduce in another order put an input
that lies within that difference of a rounding boundary of a table's input
grid on the neighbouring grid point, and one such step moves the logits by
about 1e-4.  :class:`TableAlign` attributes those: the reference records
the grid point of every table evaluation, and the port
evaluates its tables on the recorded points, counting its own that
differ.  Each may differ by one step of the grid, on at most
``FLIP_SHARE`` of the inputs; everything else is held to
``LOGIT_GAP_BOUND``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as RC  # noqa: E402
import repro.kernels.ops as RKO  # noqa: E402
import repro.models as RM  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import fused as KF  # noqa: E402
from repro_torch.kernels import ops as KO  # noqa: E402
from repro_torch.kernels import softmax_ppa as KS  # noqa: E402
from repro_torch.models import (decode_step, make_acts,  # noqa: E402
                                params_from_jax, prefill, prepare_params)
from repro_torch.models import attention as A  # noqa: E402

from test_torch_models import LOGIT_GAP_BOUND, seeded_store  # noqa: E402

ARCH = "internlm2-1.8b"
#: the share of table inputs the two packages may quantize one grid step
#: apart (each one an input within a float32 rounding of a boundary)
FLIP_SHARE = 1e-3
#: max |logit gap| port vs reference: LOGIT_GAP_BOUND where only matmul
#: order differs (ppa: the softmax's exp is the table times an exact
#: power of two); with exact activations XLA's and torch's float32 exp and
#: logistic also differ in their last places, measured up to 3.4e-6 on
#: logits up to 0.65 (window and flash, which exponentiate most)
GAP_BOUND = {"ppa": LOGIT_GAP_BOUND, "exact": 1e-5}
PROMPT, CACHE_LEN, STEPS = 12, 32, 8
OPTIONS = {
    "qkv_bias": dict(qkv_bias=True),
    "qk_norm": dict(qk_norm=True),
    "window": dict(window=8),
    "flash": dict(attn_impl="flash", flash_chunk=5),
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


class TableAlign:
    """The reference's ``ref`` backend records the grid point of every
    table evaluation (an ordered host callback, so jitted code records in
    program order); the port's ``backend`` evaluates its table on the
    recorded points in the same order, and counts its own points that
    differ (``flips``) and by how many steps (``worst``).

    ``points``: a recording made before (``record``), replayed without
    recording again.  The kernel backends' plain versions replay where
    they evaluate a table: ``cuda_int`` its integer datapath, ``cuda_fused``
    its fused path, and both the softmax kernel's forward and backward.
    The backward recomputes the forward's exponentials from the same
    inputs, so its evaluations take the points its forward took, and
    consume none."""

    def __init__(self, monkeypatch, backend="ref", points=None):
        self.points, self.used = ([] if points is None else points), 0
        self.flips = self.inputs = self.worst = 0
        self._memo, self._rerun = {}, False
        if points is None:
            ref_eval = RKO.get_backend("ref").eval_int

            def record(tc, x_int):
                jax.debug.callback(
                    lambda v: self.points.append(np.asarray(v)), x_int,
                    ordered=True)
                return ref_eval(tc, x_int)

            monkeypatch.setitem(RKO._BACKENDS, "ref", dataclasses.replace(
                RKO.get_backend("ref"), eval_int=record))
        if backend in ("ref", "cuda_int"):
            be = KO.get_backend(backend)
            monkeypatch.setitem(KO._BACKENDS, backend, dataclasses.replace(
                be, eval_int=self._replayer(be.eval_int)))
        if backend == "cuda_fused":
            monkeypatch.setattr(KF, "eval_ref", self._replayer(KF.eval_ref))
        if backend != "ref":
            monkeypatch.setattr(KS, "eval_ref", self._replayer(KS.eval_ref))
            bwd = KS.softmax_ppa_bwd_plain

            def rerun(*args, **kwargs):
                self._rerun = True
                try:
                    return bwd(*args, **kwargs)
                finally:
                    self._rerun = False

            monkeypatch.setattr(KS, "softmax_ppa_bwd_plain", rerun)

    def _replayer(self, port_eval):
        def replay(tc, x_int):
            got = x_int.numpy().astype(np.int64)
            key = (tc.naf, got.shape, got.tobytes())
            if self._rerun:
                assert key in self._memo, "a backward evaluation that its " \
                    "forward did not make"
                return self._memo[key]
            want = self.points[self.used]
            self.used += 1
            assert want.shape == got.shape, (want.shape, got.shape)
            y = self._align(tc, got, want, port_eval)
            self._memo[key] = y
            return y
        return replay

    def _align(self, tc, got, want, port_eval):
        """The port's table at the reference's points ``want``, its own
        points ``got`` counted against them."""
        self._count(np.abs(got - want))
        return port_eval(tc, torch.from_numpy(np.array(want, np.int32)))

    def _count(self, d):
        self.flips += int(np.count_nonzero(d))
        self.inputs += d.size
        self.worst = max(self.worst, int(d.max(initial=0)))

    def check(self):
        """Every recorded evaluation replayed, each flip one grid step, at
        most FLIP_SHARE of the inputs."""
        assert self.used == len(self.points), (self.used, len(self.points))
        assert self.worst <= 1, self.worst
        assert self.flips <= FLIP_SHARE * max(self.inputs, 1), (
            self.flips, self.inputs)

    @classmethod
    def record(cls, fn):
        """``(fn(), points)``: ``fn`` run with the reference's table
        evaluations recorded, for replays into several backends."""
        with pytest.MonkeyPatch.context() as mp:
            align = cls(mp)
            out = fn()
        return out, align.points


def _variant(cfg, option):
    kw = dict(OPTIONS[option])
    window = kw.pop("window", None)
    if window is not None:
        kw["stages"] = tuple(dataclasses.replace(st, window=window)
                             for st in cfg.stages)
    return cfg.replace(**kw)


def _randomize(tree, rng):
    """The biases and qk-norm scales of a reference param tree drawn at
    random (they initialise to constants)."""
    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k in ("bq", "bk", "bv"):
                v = rng.normal(0, 0.5, v.shape).astype(np.float32)
            elif k in ("q_norm", "k_norm"):
                v = {"scale": rng.uniform(0.5, 1.5, v["scale"].shape
                                          ).astype(np.float32)}
            out[k] = walk(v)
        return out
    return walk(tree)


@pytest.fixture(scope="module", params=list(OPTIONS))
def model(request):
    option = request.param
    rcfg = _variant(RC.get_smoke_config(ARCH), option)
    cfg = _variant(get_smoke_config(ARCH), option)
    rparams = jax.tree_util.tree_map(
        np.asarray, RM.init_params(RM.param_specs(rcfg),
                                   jax.random.PRNGKey(0)))
    rparams = _randomize(rparams, np.random.default_rng(3))
    return option, rcfg, rparams, cfg, params_from_jax(rparams, "cpu")


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_prefill_decode_matches_reference(model, store, impl, monkeypatch):
    option, rcfg, rparams, cfg, params = model
    rcfg, cfg = rcfg.replace(act_impl=impl), cfg.replace(act_impl=impl)
    ctx = RM.ShardCtx()
    racts = ref_make_acts(impl, "ref", store)
    acts = make_acts(impl, "ref", "cpu")
    align = TableAlign(monkeypatch)
    prepared = prepare_params(params, cfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (3, PROMPT)).astype(np.int32)
    jp = jax.tree_util.tree_map(jnp.asarray, rparams)

    r_decode = jax.jit(lambda p, c, t, pos: RM.decode_step(
        p, rcfg, c, t, pos, racts, ctx))
    rl, rcache = jax.jit(lambda p, b: RM.prefill(
        p, rcfg, b, CACHE_LEN, racts, ctx, cache_dtype=jnp.float32))(
            jp, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        tl, tcache = prefill(prepared, cfg,
                             {"tokens": torch.from_numpy(tokens)},
                             CACHE_LEN, acts, cache_dtype=torch.float32)
    ring = 8 if option == "window" else CACHE_LEN
    for key, st in tcache.items():
        assert tuple(st["kv"]["k"].shape[:3]) == (2, 3, ring), key
        np.testing.assert_array_equal(st["kv"]["pos"].numpy(),
                                      np.asarray(rcache[key]["kv"]["pos"]))
    gaps = [float(np.abs(np.asarray(rl) - tl.numpy()).max())]
    rtok, ttok = np.asarray(jnp.argmax(rl, -1)), tl.argmax(-1).numpy()
    np.testing.assert_array_equal(ttok, rtok)
    pos = np.full((3,), PROMPT, np.int32)
    for _ in range(STEPS):
        rl, rcache = r_decode(jp, rcache, jnp.asarray(rtok[:, None]),
                              jnp.asarray(pos))
        with torch.inference_mode():
            tl, tcache = decode_step(
                prepared, cfg, tcache,
                torch.from_numpy(ttok[:, None].astype(np.int32)),
                torch.from_numpy(pos), acts)
        gaps.append(float(np.abs(np.asarray(rl) - tl.numpy()).max()))
        rtok, ttok = np.asarray(jnp.argmax(rl, -1)), tl.argmax(-1).numpy()
        np.testing.assert_array_equal(ttok, rtok)
        pos = pos + 1
    assert max(gaps) <= GAP_BOUND[impl], gaps
    align.check()


@pytest.mark.parametrize("impl", ["exact", "ppa"])
@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_matches_reference(store, impl, window,
                                           monkeypatch):
    """``_flash_attn`` alone (through ``attention(impl="flash")``) on 19
    tokens, chunk 8 (shrunk to 1, as 19 is prime), and 12 tokens, chunk 6:
    the output against the reference's, and against the port's own dense
    path, within GAP_BOUND of the output's largest magnitude (about 3)."""
    from repro.models import attention as RA
    rng = np.random.default_rng(4)
    params = {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in (
        ("wq", (32, 4, 8)), ("wk", (32, 2, 8)), ("wv", (32, 2, 8)),
        ("wo", (4, 8, 32)))}
    racts = ref_make_acts(impl, "ref", store)
    acts = make_acts(impl, "ref", "cpu")
    align = TableAlign(monkeypatch)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    for t, chunk in ((19, 8), (12, 6)):
        x = rng.normal(0, 1, (2, t, 32)).astype(np.float32)
        rcfg = RA.AttnCfg(d_model=32, n_q=4, n_kv=2, head_dim=8,
                          window=window, flash_chunk=chunk)
        cfg = A.AttnCfg(d_model=32, n_q=4, n_kv=2, head_dim=8,
                        window=window, flash_chunk=chunk)
        want = np.asarray(RA.attention(
            {k: jnp.asarray(v) for k, v in params.items()}, rcfg,
            jnp.asarray(x), racts, RM.ShardCtx(), impl="flash"))
        got = A.attention(tparams, cfg, torch.from_numpy(x), acts,
                          impl="flash")
        atol = GAP_BOUND[impl] * float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
        if impl == "exact":
            dense = A.attention(tparams, cfg, torch.from_numpy(x), acts)
            np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                                       atol=atol)
    align.check()
