"""The encoder-decoder kinds against the JAX reference: layernorm, the
plain MLP with biases, cross attention, the encoder (``_encode``) and the
whisper-medium smoke config (``enc`` encoder, ``xdec`` decoder) through
``forward_hidden``, ``loss_fn`` and its gradients, prefill and decode, and
the serving engine with per-request ``enc_feats``.

Every parameter leaf is drawn at random in the reference's layout
(``test_torch_recurrent.ref_params``: layernorm scales and biases, the
MLP's and the encoder's positions included) and carried across by
``params_from_jax``.  With ``ppa`` activations both sides use the shipped
tables and :class:`FracAlign` replays the reference's table grid points
into the port's ``ref`` backend.  On CPU tensors the kernel backends
(``cuda_int``, ``cuda_fused``) run their plain versions, which must give
the ``ref`` backend's results bit for bit.
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
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import mlp as RMLP  # noqa: E402
from repro.models import transformer as RTr  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
import repro_torch.models as M  # noqa: E402
import repro_torch.serve.engine as SE  # noqa: E402
from repro_torch.models import (decode_step, forward_hidden,  # noqa: E402
                                init_cache, loss_fn, make_acts, param_specs,
                                params_from_jax, prefill, prepare_params)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mlp as MLP  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.tree import leaves_with_path, map_tree  # noqa: E402

from test_torch_attention_options import TableAlign  # noqa: E402
from test_torch_models import LOGIT_GAP_BOUND, seeded_store  # noqa: E402
from test_torch_recurrent import MODULE_REL, _close, smoke_pair  # noqa: E402
from test_torch_train import STEP_GRAD_REL, STEP_LOSS_RTOL  # noqa: E402

ARCH = "whisper-medium"
BACKENDS = ("ref", "cuda_int", "cuda_fused")
#: layernorm, port against reference, in units of 2^-23 of the output's
#: largest magnitude.  Equality is not reachable: XLA's float32 rsqrt on
#: the CPU is not correctly rounded (1 ulp from the rounded 1/sqrt on 15%
#: of inputs, torch's on 29%, the two up to 2 ulp apart) and the row means
#: reduce in another order.  Measured at most 1.6 (float32, widths 64 and
#: 1024); in bfloat16 the output rounds once more, so a last-place
#: difference may cross a bfloat16 boundary: one bfloat16 step, at most
#: 2^-7 of the value, on at most LN_BF16_SHARE of the elements.
LN_ULPS = 4
LN_BF16_SHARE = 1e-3
PROMPT, CACHE_LEN, STEPS, BATCH = 12, 32, 8, 3


class FracAlign(TableAlign):
    """``TableAlign`` with the ``exp2_frac`` grid read modulo its period.

    The softmax splits s = (x - m) log2 e into k = floor(s) and f = s - k,
    and evaluates 2^k T(f).  When the packages' s lie a float32 rounding
    apart across an integer, one has (k, f near 0) and the other (k - 1,
    f near 1): grid points 0 and 2^w_in - 1, one step apart modulo the
    period.  The port then takes the reference's point scaled by 2 (its k
    is one lower) or 1/2 (one higher), an exact float, so that its
    2^k T(f) is the reference's; the flip counts as one step.  ``check``
    is ``TableAlign``'s."""

    wraps = 0

    def _align(self, tc, got, want, port_eval):
        d = np.abs(got - want)
        y = port_eval(tc, torch.from_numpy(np.array(want, np.int32)))
        if tc.naf == "exp2_frac":
            wrap = d > (tc.hi - tc.lo) // 2
            if wrap.any():
                d = np.where(wrap, tc.hi - tc.lo - d, d)
                self.wraps += int(np.count_nonzero(wrap))
                scale = np.where(wrap, 2.0 ** np.sign(got - want), 1.0)
                y = y.to(torch.float32) * torch.from_numpy(
                    scale.astype(np.float32))
        self._count(d)
        return y


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def store():
    return seeded_store()


@pytest.fixture(scope="module")
def smoke():
    return smoke_pair(ARCH)


def _feats(cfg, b=BATCH, seed=5):
    return np.random.default_rng(seed).normal(
        0, 0.1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b=BATCH, t=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, t)
                                                ).astype(np.int32)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("width", [64, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_layernorm_matches_reference(width, dtype, bias):
    rng = np.random.default_rng(width)
    x = (rng.normal(0, 3, (3, 50, width)) + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, width).astype(np.float32)}
    if bias:
        p["bias"] = rng.normal(0, 0.5, width).astype(np.float32)
    want = np.asarray(jax.jit(RL.layernorm)(
        jnp.asarray(x).astype(dtype), _j(p)).astype(jnp.float32))
    got = L.layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      params_from_jax(p, "cpu"))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=LN_ULPS * 2.0 ** -23
                                   * float(np.abs(want).max()))
        return
    d = np.abs(got - want)
    assert float((d / np.maximum(np.abs(want), 1e-30)).max()) <= 2.0 ** -7
    assert np.count_nonzero(d) <= LN_BF16_SHARE * d.size


def test_norm_specs_match_reference():
    for layers in (None, 3):
        for port, ref in ((L.layernorm_params, RL.layernorm_params),
                          (L.rmsnorm_params, RL.rmsnorm_params)):
            got, want = port(16, layers), ref(16, layers)
            assert got.keys() == want.keys()
            for k in got:
                assert (got[k].shape, got[k].axes, got[k].init) == (
                    want[k].shape, want[k].axes, want[k].init)


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_mlp_with_biases_matches_reference(store, impl, monkeypatch):
    rng = np.random.default_rng(7)
    d, f = 32, 96
    p = {"w_up": rng.normal(0, d ** -0.5, (d, f)),
         "w_down": rng.normal(0, f ** -0.5, (f, d)),
         "b_up": rng.normal(0, 0.5, (f,)), "b_down": rng.normal(0, 0.5, (d,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    spec = MLP.mlp_params(d, f, bias=True)
    rspec = RMLP.mlp_params(d, f, bias=True)
    assert {k: (s.shape, s.axes, s.init) for k, s in spec.items()} == {
        k: (s.shape, s.axes, s.init) for k, s in rspec.items()}
    x = rng.normal(0, 1, (2, 9, d)).astype(np.float32)
    align = FracAlign(monkeypatch)
    racts = ref_make_acts(impl, "ref", store)
    want = jax.jit(lambda p, x: RMLP.mlp(p, x, racts, RM.ShardCtx()))(
        _j(p), jnp.asarray(x))
    got = MLP.mlp(params_from_jax(p, "cpu"), torch.from_numpy(x),
                  make_acts(impl, "ref", "cpu"))
    _close(got, want, MODULE_REL, "mlp")
    if impl == "ppa":
        align.check()
        for backend in BACKENDS[1:]:
            assert torch.equal(MLP.mlp(params_from_jax(p, "cpu"),
                                       torch.from_numpy(x),
                                       make_acts(impl, backend, "cpu")),
                               got), backend


def _xattn_params(rng, d=32, hq=4, hk=2, dh=8):
    return {k: rng.normal(0, 0.3, s).astype(np.float32) for k, s in (
        ("wq", (d, hq, dh)), ("wk", (d, hk, dh)), ("wv", (d, hk, dh)),
        ("wo", (hq, dh, d)), ("bq", (hq, dh)), ("bk", (hk, dh)),
        ("bv", (hk, dh)))}


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_cross_attention_matches_reference(store, impl, monkeypatch):
    """``attention(x_kv=)`` (dense and flash), ``cross_kv`` and
    ``cross_attention_cached`` without and with ``enc_valid``, QKV bias on:
    no rope on either side, no causal mask.  The K/V ``attention`` returns
    are ``cross_kv``'s bit for bit."""
    rng = np.random.default_rng(11)
    p = _xattn_params(rng)
    kw = dict(d_model=32, n_q=4, n_kv=2, head_dim=8, qkv_bias=True,
              causal=False, flash_chunk=5)
    rcfg, cfg = RA.AttnCfg(**kw), A.AttnCfg(**kw)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 15, 32)).astype(np.float32)
    valid = rng.random((2, 15)) < 0.7
    racts, acts = ref_make_acts(impl, "ref", store), make_acts(impl, "ref",
                                                               "cpu")
    tp = params_from_jax(p, "cpu")
    align = FracAlign(monkeypatch)
    ctx = RM.ShardCtx()
    jp, jx, je = _j(p), jnp.asarray(x), jnp.asarray(enc)
    rk, rv = RA.cross_kv(jp, rcfg, je)
    wants = [RA.attention(jp, rcfg, jx, racts, ctx, x_kv=je, impl=i)
             for i in ("dense", "flash")]
    wants += [RA.cross_attention_cached(jp, rcfg, jx, rk, rv, racts),
              RA.cross_attention_cached(jp, rcfg, jx, rk, rv, racts,
                                        enc_valid=jnp.asarray(valid))]
    tx, te = torch.from_numpy(x), torch.from_numpy(enc)
    k, v = A.cross_kv(tp, cfg, te)
    _close(k, rk, MODULE_REL, "xk")
    _close(v, rv, MODULE_REL, "xv")
    got = [A.attention(tp, cfg, tx, acts, x_kv=te, impl="dense",
                       return_kv=True)]
    assert torch.equal(got[0][1][0], k) and torch.equal(got[0][1][1], v)
    got = [got[0][0], A.attention(tp, cfg, tx, acts, x_kv=te, impl="flash")]
    got += [A.cross_attention_cached(tp, cfg, tx, k, v, acts),
            A.cross_attention_cached(tp, cfg, tx, k, v, acts,
                                     enc_valid=torch.from_numpy(valid))]
    for i, (g, w) in enumerate(zip(got, wants)):
        _close(g, w, MODULE_REL, i)
    assert torch.equal(got[0], got[2])     # the cached path is the same op
    align.check()


def _ref_encode(rcfg, rparams, feats, racts):
    return jax.jit(lambda p, f: RTr._encode(
        RTr._cast_params(p, rcfg), rcfg, f, racts, RM.ShardCtx()))(
            _j(rparams), jnp.asarray(feats))


@pytest.mark.parametrize("impl", ["exact", "ppa"])
def test_encode_matches_reference(smoke, store, impl, monkeypatch):
    """The per-frame standardisation, the learned positions, two ``enc``
    layers (bidirectional attention with rope, the plain MLP with gelu)
    and the final layernorm, on features of scale 0.1."""
    rcfg, cfg, rparams = smoke
    rcfg, cfg = rcfg.replace(act_impl=impl), cfg.replace(act_impl=impl)
    feats = _feats(cfg)
    align = FracAlign(monkeypatch)
    want = _ref_encode(rcfg, rparams, feats, ref_make_acts(impl, "ref",
                                                           store))
    prepared = prepare_params(params_from_jax(rparams, "cpu"), cfg)
    enc = prepared["encoder"]
    with torch.inference_mode():
        got = T._encode(cfg, enc, enc["stack"], torch.from_numpy(feats),
                        make_acts(impl, "ref", "cpu"))
    _close(got, want, MODULE_REL, "encoder output")
    align.check()


def test_reference_params_carry_across(smoke):
    """The spec tree, the ``encoder`` subtree {pos, stack, ln_f} included,
    equals the reference's, and a tree in the reference's layout carries
    across leaf for leaf; ``prepare_params`` splits the encoder's stack
    into its layers."""
    rcfg, cfg, rparams = smoke
    flat = jax.tree_util.tree_flatten_with_path(
        RM.param_specs(rcfg), is_leaf=lambda x: isinstance(x, RM.P))[0]
    mine = dict(leaves_with_path(param_specs(cfg)))
    assert len(mine) == len(flat)
    assert {"encoder/pos", "encoder/ln_f/bias", "encoder/stack/mlp/b_up",
            "stages/s0_xdec/xattn/wq", "stages/s0_xdec/lnx/scale"} <= set(
                mine)
    for path, spec in flat:
        node = mine["/".join(k.key for k in path)]
        assert (node.shape, node.axes, node.init, node.scale) == (
            spec.shape, spec.axes, spec.init, spec.scale), path
    got = params_from_jax(rparams, "cpu")
    for k, want in leaves_with_path(rparams):
        t = dict(leaves_with_path(got))[k]
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want)
    stack = prepare_params(got, cfg)["encoder"]["stack"]
    assert len(stack) == cfg.enc_layers
    np.testing.assert_array_equal(
        stack[1]["mlp"]["b_up"].numpy(),
        rparams["encoder"]["stack"]["mlp"]["b_up"][1])


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "enc_feats": _feats(cfg, 2, 4)}


@pytest.fixture(scope="module")
def reference(smoke, store):
    """The reference's ``forward_hidden`` and ``jax.value_and_grad`` of its
    ``loss_fn`` on ``_batch``, remat off, its table evaluations recorded
    (``FracAlign.record``): ((hidden, loss, gradients), points)."""
    rcfg, cfg, rparams = smoke
    rcfg = rcfg.replace(remat="none")
    racts = ref_make_acts("ppa", "ref", store)
    jb = _j(_batch(cfg))

    def run():
        rh, _ = jax.jit(lambda p, b: RM.forward_hidden(
            p, rcfg, b, racts, RM.ShardCtx()))(_j(rparams), jb)
        (rloss, _), rgrads = jax.jit(jax.value_and_grad(
            lambda p, b: RM.loss_fn(p, rcfg, b, racts, RM.ShardCtx()),
            has_aux=True))(_j(rparams), jb)
        return np.asarray(rh), float(rloss), dict(leaves_with_path(
            jax.tree_util.tree_map(np.asarray, rgrads)))
    return FracAlign.record(run)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_loss_and_grads_match_reference(smoke, reference, backend,
                                                monkeypatch):
    """``forward_hidden`` within MODULE_REL; the loss within
    STEP_LOSS_RTOL and each gradient leaf (the encoder's included) within
    STEP_GRAD_REL of its largest magnitude, the tolerances of the train
    step; remat "full" gives the gradients of none bit for bit.  On every
    backend: the kernel backends' plain versions run the card's autograd
    path (``_STE`` on gelu, ``_SoftmaxSTE`` on the encoder's, the
    decoder's and the cross attention's softmax)."""
    _, cfg, rparams = smoke
    cfg = cfg.replace(remat="none")
    (rh, rloss, rflat), points = reference
    align = FracAlign(monkeypatch, backend, points)
    acts = make_acts("ppa", backend, "cpu")
    tb = params_from_jax(_batch(cfg), "cpu")
    with torch.inference_mode():
        h = forward_hidden(prepare_params(params_from_jax(rparams, "cpu"),
                                          cfg), cfg, tb, acts)
    _close(h, rh, MODULE_REL, "hidden")

    def grads(c):
        params = map_tree(lambda p: p.requires_grad_(True),
                          params_from_jax(rparams, "cpu"))
        loss, _ = loss_fn(params, c, tb, acts)
        loss.backward()
        return loss.detach(), params

    loss, params = grads(cfg)
    align.check()
    assert abs(float(loss) - rloss) <= STEP_LOSS_RTOL * abs(rloss)
    assert len(rflat) == len(list(leaves_with_path(params)))
    for k, p in leaves_with_path(params):
        want = rflat[k]
        scale = float(np.abs(want).max())
        assert scale > 0, k
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= STEP_GRAD_REL * scale, (k, err, scale)
    monkeypatch.undo()
    want_loss, want_params = grads(cfg)
    got_loss, got_params = grads(cfg.replace(remat="full"))
    assert torch.equal(got_loss, want_loss)
    for (k, a), (_, b) in zip(leaves_with_path(got_params),
                              leaves_with_path(want_params)):
        assert torch.equal(a.grad, b.grad), k


def _run_port(cfg, params, tokens, feats, backend):
    """Prefill + STEPS greedy decode steps of the port, float32 cache:
    (logits of every step, the cache after prefill, the final cache)."""
    acts = make_acts(cfg.act_impl, backend, "cpu")
    with torch.inference_mode():
        lg, cache = prefill(params, cfg, {
            "tokens": torch.from_numpy(tokens),
            "enc_feats": torch.from_numpy(feats)}, CACHE_LEN, acts,
            cache_dtype=torch.float32)
        first = map_tree(torch.clone, cache)
        out = [lg]
        pos = torch.full((tokens.shape[0],), tokens.shape[1],
                         dtype=torch.int32)
        for _ in range(STEPS):
            tok = out[-1].argmax(-1).to(torch.int32)[:, None]
            lg, cache = decode_step(params, cfg, cache, tok, pos, acts)
            out.append(lg)
            pos = pos + 1
    return torch.stack(out), first, cache


def test_prefill_decode_matches_reference(smoke, store, monkeypatch):
    """Prefill + 8 greedy decode steps against the reference's: equal
    tokens, logits within LOGIT_GAP_BOUND (float32 matmuls in another
    order through the 2-layer encoder and decoder, the tables aligned;
    measured 3.3e-7 on logits up to 0.70), the cache leaves ``kv``, ``xk``
    and ``xv`` after prefill within MODULE_REL; then each kernel backend's
    plain version gives the ``ref`` backend's logits and caches bit for
    bit."""
    rcfg, cfg, rparams = smoke
    ctx = RM.ShardCtx()
    racts = ref_make_acts("ppa", "ref", store)
    tokens, feats = _tokens(cfg), _feats(cfg)
    jp = _j(rparams)
    align = FracAlign(monkeypatch)
    rl, rcache = jax.jit(lambda p, b: RM.prefill(
        p, rcfg, b, CACHE_LEN, racts, ctx, cache_dtype=jnp.float32))(
            jp, {"tokens": jnp.asarray(tokens), "enc_feats":
                 jnp.asarray(feats)})
    rfirst = jax.tree_util.tree_map(np.asarray, rcache)
    r_decode = jax.jit(lambda p, c, t, pos: RM.decode_step(
        p, rcfg, c, t, pos, racts, ctx))
    want = [np.asarray(rl)]
    pos = np.full((BATCH,), PROMPT, np.int32)
    for _ in range(STEPS):
        tok = np.argmax(want[-1], -1).astype(np.int32)[:, None]
        rl, rcache = r_decode(jp, rcache, jnp.asarray(tok), jnp.asarray(pos))
        want.append(np.asarray(rl))
        pos = pos + 1
    want = np.stack(want)
    params = prepare_params(params_from_jax(rparams, "cpu"), cfg)
    got, first, _ = _run_port(cfg, params, tokens, feats, "ref")
    align.check()
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    gap = float(np.abs(got.numpy() - want).max())
    assert gap <= LOGIT_GAP_BOUND, (gap, float(np.abs(want).max()))
    key = "s0_xdec"
    assert set(first[key]) == set(rfirst[key]) == {"kv", "xk", "xv"}
    for name in ("xk", "xv"):
        assert tuple(first[key][name].shape) == (
            2, BATCH, cfg.enc_seq, cfg.n_kv, cfg.head_dim)
        _close(first[key][name], rfirst[key][name], MODULE_REL, name)
    for name in ("k", "v"):
        _close(first[key]["kv"][name], rfirst[key]["kv"][name], MODULE_REL,
               name)
    np.testing.assert_array_equal(first[key]["kv"]["pos"].numpy(),
                                  rfirst[key]["kv"]["pos"])
    monkeypatch.undo()
    base = _run_port(cfg, params, tokens, feats, "ref")
    for backend in BACKENDS[1:]:
        other = _run_port(cfg, params, tokens, feats, backend)
        assert torch.equal(other[0], base[0]), backend
        for (k, a), (_, b) in zip(leaves_with_path(other[2]),
                                  leaves_with_path(base[2])):
            assert torch.equal(a, b), (backend, k)


def test_init_cache_matches_reference(smoke):
    rcfg, cfg, _ = smoke
    want = dict(leaves_with_path(jax.tree_util.tree_map(
        np.asarray, RM.init_cache(rcfg, 3, 16))))
    got = dict(leaves_with_path(init_cache(cfg, 3, 16, device="cpu")))
    assert got.keys() == want.keys()
    for k, t in got.items():
        assert tuple(t.shape) == want[k].shape, k
        np.testing.assert_array_equal(t.float().numpy(),
                                      want[k].astype(np.float32))


#: prompts of mixed lengths: one admission of 4 slots pads 5 and 3 into
#: one group of 8; 9 carries an extra key the model does not read, so it
#: and 14 (both of the bucket of 16) prefill apart; 7 and 6 come later,
#: in slots freed together, and pad to 8 together
LENS = (5, 9, 14, 3, 7, 6)


def _requests(mk, cfg):
    rng = np.random.default_rng(0)
    out = []
    for i, n in enumerate(LENS):
        extra = {"enc_feats": rng.normal(0, 0.1, (cfg.enc_seq, cfg.d_model)
                                         ).astype(np.float32)}
        if n == 9:
            extra["tag"] = np.full((2,), i, np.float32)
        out.append(mk(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=5, extra=extra))
    return out


def test_engine_matches_reference_engine(smoke, store, monkeypatch):
    """Greedy tokens of the port's engine against the reference engine's,
    each request with its own ``enc_feats`` (float32 caches in both, as in
    ``test_torch_recurrent_serve``): padded prompts, a coalesced group,
    groups split by their extra keys as the reference splits them, and
    reused slots."""
    rcfg, cfg, rparams = smoke
    monkeypatch.setattr(RSE, "init_cache", functools.partial(
        RM.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(RSE, "prefill", functools.partial(
        RM.prefill, cache_dtype=jnp.float32))
    monkeypatch.setattr(SE, "init_cache", functools.partial(
        M.init_cache, dtype=torch.float32))
    monkeypatch.setattr(SE, "prefill", functools.partial(
        M.prefill, cache_dtype=torch.float32))
    reng = RS.ServeEngine(rcfg, _j(rparams), n_slots=4, cache_len=32,
                          table_store=store)
    eng = ServeEngine(cfg, params_from_jax(rparams, "cpu"), n_slots=4,
                      cache_len=32, device="cpu")
    outs = []
    for e, mk in ((reng, RS.Request), (eng, Request)):
        reqs = _requests(mk, cfg)
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
        assert all(r.done and len(r.output) == 5 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert eng.prefill_shapes == {s[:2] for s in reng._prefill_shapes} == {
        (8, 2), (16, 1)}
    assert len(reng._prefill_shapes) == 3       # (16, 1) with and without
    assert tuple(eng.cache["s0_xdec"]["xk"].shape) == (
        2, 4, cfg.enc_seq, cfg.n_kv, cfg.head_dim)


def test_serve_launcher_draws_the_extras():
    """The launcher serves the smoke config on the CPU, each request with
    frame embeddings N(0, 0.1) of (enc_seq, d_model) drawn from the seeded
    generator before its prompt."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launch_serve
    cfg = get_smoke_config(ARCH)
    extra = launch_serve.request_extras(cfg, np.random.default_rng(0))
    want = np.random.default_rng(0).normal(
        0, 0.1, (cfg.enc_seq, cfg.d_model)).astype(np.float32)
    assert list(extra) == ["enc_feats"]
    np.testing.assert_array_equal(extra["enc_feats"], want)
    launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                       "--max-new", "2", "--prompt-len", "5",
                       "--device", "cpu", "--cache-len", "32"])


def test_train_batch_draws_enc_feats_as_request_extras():
    """``chip_smoke.train_batch`` (the batch of the card's ``train_whisper``
    phase): the launcher's tokens at the step, and each row's
    ``enc_feats`` the draw ``launch.serve.request_extras`` makes of a
    request from the same generator, row after row."""
    import sys
    from pathlib import Path
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.serve import request_extras
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    cfg = get_smoke_config(ARCH)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=3)
    rng = np.random.default_rng(0)
    got = [chip_smoke.train_batch(cfg, data, step, rng) for step in (0, 5)]
    rng = np.random.default_rng(0)
    for step, batch in zip((0, 5), got):
        want = np.stack([request_extras(cfg, rng)["enc_feats"]
                         for _ in range(3)])
        assert batch["enc_feats"].dtype == np.float32
        assert batch["enc_feats"].shape == (3, cfg.enc_seq, cfg.d_model)
        np.testing.assert_array_equal(batch["enc_feats"], want)
        for k, v in data.batch_at(step).items():
            np.testing.assert_array_equal(batch[k], v)
    assert not np.array_equal(got[0]["enc_feats"], got[1]["enc_feats"])
