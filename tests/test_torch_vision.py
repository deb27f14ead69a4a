"""The vision prefix against the JAX reference: the internvl2-26b smoke
config (a ``dec`` decoder whose sequence starts with ``vision_tokens``
precomputed patch embeddings) through ``forward_hidden``, ``loss_fn``
(which drops the prefix's positions) and its gradients, prefill and
decode, and the serving engine with per-request ``vision_embeds``.

Parameters are drawn at random in the reference's layout
(``test_torch_recurrent.ref_params``) and carried across; with ``ppa``
activations :class:`test_torch_encdec.FracAlign` replays the reference's
table grid points into the port's ``ref`` backend, and the kernel
backends' plain versions must give the ``ref`` backend's results bit for
bit.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.models as RM  # noqa: E402
import repro.train as RT  # noqa: E402
import repro.train.train_step as RTS  # noqa: E402
import repro.serve as RS  # noqa: E402
import repro.serve.engine as RSE  # noqa: E402
from repro.models.activations import make_acts as ref_make_acts  # noqa: E402
import repro_torch.models as M  # noqa: E402
import repro_torch.serve.engine as SE  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import (decode_step, forward_hidden,  # noqa: E402
                                loss_fn, make_acts, params_from_jax,
                                prefill, prepare_params)
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import OptCfg, TrainCfg, make_train_step  # noqa: E402
from repro_torch.tree import leaves_with_path, map_tree  # noqa: E402

from test_torch_encdec import BACKENDS, FracAlign  # noqa: E402
from test_torch_models import LOGIT_GAP_BOUND, seeded_store  # noqa: E402
from test_torch_recurrent import MODULE_REL, _close, smoke_pair  # noqa: E402
from test_torch_train import (OPT_ATOL, OPT_RTOL,  # noqa: E402
                              STEP_GRAD_REL, STEP_LOSS_RTOL)

ARCH = "internvl2-26b"
CACHE_LEN, STEPS = 32, 8
#: right-padded prompts of a coalesced group: (lengths, padded length)
LENS, PADDED = (5, 9, 3), 9


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


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _vision(cfg, b, seed=6):
    return np.random.default_rng(seed).normal(
        0, 0.02, (b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def _batch(cfg):
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "vision_embeds": _vision(cfg, 2)}


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
    """``forward_hidden`` (B, vision_tokens + T, D) within MODULE_REL; the
    loss over the text positions only within STEP_LOSS_RTOL and each
    gradient leaf within STEP_GRAD_REL of its largest magnitude, the train
    step's tolerances.  On every backend (the kernel backends' plain
    versions: ``_STE`` on silu, ``_SoftmaxSTE`` on the attention over the
    prefix and the text), against one recording of the reference."""
    _, cfg, rparams = smoke
    cfg = cfg.replace(remat="none")
    batch = _batch(cfg)
    (rh, rloss, rflat), points = reference
    align = FracAlign(monkeypatch, backend, points)
    acts = make_acts("ppa", backend, "cpu")
    tb = params_from_jax(batch, "cpu")
    with torch.inference_mode():
        h = forward_hidden(prepare_params(params_from_jax(rparams, "cpu"),
                                          cfg), cfg, tb, acts)
    assert tuple(h.shape) == (2, cfg.vision_tokens + 16, cfg.d_model)
    _close(h, rh, MODULE_REL, "hidden")
    params = map_tree(lambda p: p.requires_grad_(True),
                      params_from_jax(rparams, "cpu"))
    loss, aux = loss_fn(params, cfg, tb, acts)
    loss.backward()
    align.check()
    assert float(aux["denom"]) == batch["labels"].size
    loss = float(loss.detach())
    assert abs(loss - rloss) <= STEP_LOSS_RTOL * abs(rloss)
    assert len(rflat) == len(list(leaves_with_path(params)))
    for k, p in leaves_with_path(params):
        want = rflat[k]
        scale = float(np.abs(want).max())
        assert scale > 0, k
        err = float(np.abs(p.grad.numpy() - want).max())
        assert err <= STEP_GRAD_REL * scale, (k, err, scale)


@pytest.fixture(scope="module")
def step_reference(smoke, store):
    """One adamw step of the reference's ``make_train_step`` (jitted, its
    acts over the shipped tables) on ``_batch`` from ``train_init``, remat
    off, its table evaluations recorded: ((state before, params after,
    state after, metrics), points)."""
    rcfg, cfg, rparams = smoke
    rcfg = rcfg.replace(remat="none")
    racts = ref_make_acts("ppa", "ref", store)
    tcfg = RT.TrainCfg(opt=RT.OptCfg(kind="adamw"))

    def run():
        saved = RTS.make_model_acts
        RTS.make_model_acts = lambda c: racts
        try:
            state = RT.train_init(tcfg, _j(rparams))
            p1, s1, m = jax.jit(RT.make_train_step(
                rcfg, tcfg, RM.ShardCtx()))(_j(rparams), state,
                                            _j(_batch(cfg)))
        finally:
            RTS.make_model_acts = saved
        return tuple(jax.tree_util.tree_map(np.asarray, t)
                     for t in (state, p1, s1, m))
    return FracAlign.record(run)


@pytest.mark.parametrize("backend", BACKENDS)
def test_adamw_step_matches_reference(smoke, step_reference, backend,
                                      monkeypatch):
    """One adamw step of the port's ``make_train_step`` on a batch with
    ``vision_embeds``, from the reference's ``train_init`` state, against
    the reference's step: the loss within STEP_LOSS_RTOL, the gradient and
    parameter norms within STEP_GRAD_REL and STEP_LOSS_RTOL, the rate bit
    for bit, each moment within STEP_GRAD_REL of its leaf's largest.

    Each parameter within OPT_ATOL + OPT_RTOL of the reference's, plus
    what the gradients' own gap moves it by.  The first step moves a
    parameter by lr (u(g) + wd p) with u(g) = g / (|g| + eps), g the
    clipped gradient (the reference's is m / (1 - b1)).  The port's g is
    within d = 2 STEP_GRAD_REL of the leaf's largest of it (the leaf's
    gap and the clip's scale, by the gradient norm's).  Where |g| <= d
    its sign is not determined and the two may move up to 2 lr apart;
    elsewhere u moves by at most d eps / (|g| - d + eps)^2, times lr
    (u' = eps / (|g| + eps)^2 falls with |g|)."""
    _, cfg, rparams = smoke
    cfg = cfg.replace(remat="none")
    (rstate, rp1, rs1, rm), points = step_reference
    align = FracAlign(monkeypatch, backend, points)
    step = make_train_step(cfg, TrainCfg(opt=OptCfg(kind="adamw")),
                           make_acts("ppa", backend, "cpu"))
    params, state, m = step(params_from_jax(rparams, "cpu"),
                            params_from_jax(rstate, "cpu"),
                            params_from_jax(_batch(cfg), "cpu"))
    align.check()
    for name, rtol in (("loss", STEP_LOSS_RTOL), ("grad_norm", STEP_GRAD_REL),
                       ("param_norm", STEP_LOSS_RTOL)):
        want = float(rm[name])
        assert abs(float(m[name]) - want) <= rtol * abs(want), name
    assert m["lr"].numpy().view(np.uint32) == np.float32(rm["lr"]).view(
        np.uint32)
    assert int(state["step"]) == int(rs1["step"]) == 1
    lr, ocfg = float(rm["lr"]), OptCfg(kind="adamw")
    want_p = dict(leaves_with_path(rp1))
    moments = dict(leaves_with_path(rs1["opt"]["mu"]))
    for k, got in leaves_with_path(params):
        want = want_p[k].astype(np.float64)
        g = np.abs(moments[f"{k}/m"].astype(np.float64)) / (1 - ocfg.b1)
        d = 2 * STEP_GRAD_REL * g.max()
        loose = g <= d
        moved = lr * d * ocfg.eps / np.maximum(g - d + ocfg.eps,
                                               ocfg.eps) ** 2
        err = np.abs(got.numpy().astype(np.float64) - want)
        bad = ~loose & (err > OPT_ATOL + OPT_RTOL * np.abs(want) + moved)
        assert not bad.any(), (k, int(bad.sum()), float(err[bad].max()))
        assert float(err[loose].max(initial=0)) <= 2 * lr * (1 + 1e-6), k
    for (k, got), (_, want) in zip(leaves_with_path(state),
                                   leaves_with_path(rs1)):
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got.numpy() - want).max()) <= (
            STEP_GRAD_REL * scale), k


def _padded(cfg):
    """A coalesced group's batch: LENS right-padded to PADDED tokens, each
    row's last real position after the prefix."""
    rng = np.random.default_rng(0)
    toks = np.zeros((len(LENS), PADDED), np.int32)
    for j, n in enumerate(LENS):
        toks[j, :n] = rng.integers(0, cfg.vocab, n)
    last = np.asarray([cfg.vision_tokens + n - 1 for n in LENS], np.int32)
    return toks, _vision(cfg, len(LENS)), last


def _run_port(cfg, params, toks, vis, last, backend):
    """Padded prefill + STEPS greedy decode steps, float32 cache, each
    row decoding from its own length: (logits of every step, cache)."""
    acts = make_acts(cfg.act_impl, backend, "cpu")
    with torch.inference_mode():
        lg, cache = prefill(params, cfg, {
            "tokens": torch.from_numpy(toks),
            "vision_embeds": torch.from_numpy(vis)}, CACHE_LEN, acts,
            cache_dtype=torch.float32, last_idx=torch.from_numpy(last))
        out = [lg]
        pos = torch.from_numpy(last + 1)
        for _ in range(STEPS):
            tok = out[-1].argmax(-1).to(torch.int32)[:, None]
            lg, cache = decode_step(params, cfg, cache, tok, pos, acts)
            out.append(lg)
            pos = pos + 1
    return torch.stack(out), cache


def test_padded_prefill_decode_matches_reference(smoke, store, monkeypatch):
    """A right-padded group after the vision prefix (``last_idx`` counts
    the prefix), then 8 greedy decode steps from each row's own position:
    equal tokens, logits within LOGIT_GAP_BOUND; each kernel backend's
    plain version gives the ``ref`` backend's logits and cache bit for
    bit."""
    rcfg, cfg, rparams = smoke
    ctx = RM.ShardCtx()
    racts = ref_make_acts("ppa", "ref", store)
    toks, vis, last = _padded(cfg)
    jp = _j(rparams)
    align = FracAlign(monkeypatch)
    rl, rcache = jax.jit(lambda p, b, li: RM.prefill(
        p, rcfg, b, CACHE_LEN, racts, ctx, cache_dtype=jnp.float32,
        last_idx=li))(jp, {"tokens": jnp.asarray(toks),
                           "vision_embeds": jnp.asarray(vis)},
                      jnp.asarray(last))
    r_decode = jax.jit(lambda p, c, t, pos: RM.decode_step(
        p, rcfg, c, t, pos, racts, ctx))
    want = [np.asarray(rl)]
    pos = last + 1
    for _ in range(STEPS):
        tok = np.argmax(want[-1], -1).astype(np.int32)[:, None]
        rl, rcache = r_decode(jp, rcache, jnp.asarray(tok), jnp.asarray(pos))
        want.append(np.asarray(rl))
        pos = pos + 1
    want = np.stack(want)
    params = prepare_params(params_from_jax(rparams, "cpu"), cfg)
    got, cache = _run_port(cfg, params, toks, vis, last, "ref")
    align.check()
    np.testing.assert_array_equal(got.argmax(-1).numpy(), want.argmax(-1))
    gap = float(np.abs(got.numpy() - want).max())
    assert gap <= LOGIT_GAP_BOUND, (gap, float(np.abs(want).max()))
    np.testing.assert_array_equal(cache["s0_dec"]["kv"]["pos"].numpy(),
                                  np.asarray(rcache["s0_dec"]["kv"]["pos"]))
    monkeypatch.undo()
    base = _run_port(cfg, params, toks, vis, last, "ref")
    for backend in BACKENDS[1:]:
        other = _run_port(cfg, params, toks, vis, last, backend)
        assert torch.equal(other[0], base[0]), backend
        for (k, a), (_, b) in zip(leaves_with_path(other[1]),
                                  leaves_with_path(base[1])):
            assert torch.equal(a, b), (backend, k)


#: one admission of 4 slots: 5 and 3 pad to 8 together, 9 and 14 to 16;
#: then 11 and 7 in slots freed together
ENGINE_LENS = (5, 9, 14, 3, 11, 7)


def _requests(mk, cfg, mixed):
    rng = np.random.default_rng(0)
    out = []
    for i, n in enumerate(ENGINE_LENS):
        extra = {"vision_embeds": rng.normal(
            0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(np.float32)}
        if mixed and i % 2:
            # a key the model does not read: a group of its own
            extra["tag"] = np.full((2,), i, np.float32)
        out.append(mk(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=5, extra=extra))
    return out


def _float32_caches(monkeypatch):
    monkeypatch.setattr(RSE, "init_cache", functools.partial(
        RM.init_cache, dtype=jnp.float32))
    monkeypatch.setattr(RSE, "prefill", functools.partial(
        RM.prefill, cache_dtype=jnp.float32))
    monkeypatch.setattr(SE, "init_cache", functools.partial(
        M.init_cache, dtype=torch.float32))
    monkeypatch.setattr(SE, "prefill", functools.partial(
        M.prefill, cache_dtype=torch.float32))


@pytest.mark.parametrize("mixed", [False, True], ids=["same_keys",
                                                      "mixed_keys"])
def test_engine_matches_reference_engine(smoke, store, mixed, monkeypatch):
    """Greedy tokens of the port's engine against the reference engine's,
    each request with its own ``vision_embeds``, float32 caches in both:
    padded prompts after the prefix, coalesced groups, decode positions
    past the prefix, and with mixed extra keys, groups split by keys as
    the reference splits them.  Warmup (zero extras) leaves the engine's
    state as it was."""
    rcfg, cfg, rparams = smoke
    _float32_caches(monkeypatch)
    reng = RS.ServeEngine(rcfg, _j(rparams), n_slots=4, cache_len=CACHE_LEN,
                          table_store=store)
    eng = ServeEngine(cfg, params_from_jax(rparams, "cpu"), n_slots=4,
                      cache_len=CACHE_LEN, device="cpu")
    assert eng.warmup([5, 9]) == 3 and not eng.prefill_shapes
    outs = []
    for e, mk in ((reng, RS.Request), (eng, Request)):
        reqs = _requests(mk, cfg, mixed)
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
        assert all(r.done and len(r.output) == 5 for r in reqs)
        outs.append([r.output for r in reqs])
    assert outs[1] == outs[0]
    assert eng.prefill_shapes == {s[:2] for s in reng._prefill_shapes}
    assert eng.prefill_shapes == ({(8, 1), (16, 1)} if mixed else
                                  {(8, 2), (16, 2), (8, 1), (16, 1)})


@pytest.mark.parametrize("cache_len", [16, 24, 32])
def test_bucket_counts_the_prefix_against_the_ring(smoke, cache_len):
    """A prompt pads to its bucket only if the prefix and the bucket fit
    the ring (8 + 16 tokens do not fit 16, fit 24 and 32), as in the
    reference."""
    rcfg, cfg, rparams = smoke
    reng = RS.ServeEngine(rcfg, _j(rparams), n_slots=1, cache_len=cache_len,
                          table_store=seeded_store())
    eng = ServeEngine(cfg, params_from_jax(rparams, "cpu"), n_slots=1,
                      cache_len=cache_len, device="cpu")
    for n in range(1, 16):
        assert eng._bucket_len(n) == reng._bucket_len(n), n


def _chip_smoke():
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


#: the scores' shapes (B, Hk, G, T, S) of one forward at batch 4 x seq 512
#: (hymba 2 x 2048) and the attention layers at each, by the full configs
#: and cut to 1 layer a stage: internvl's decoder over its 256 vision
#: tokens and 512 text tokens; whisper's decoder, its cross attention to
#: 1500 frames and its encoder; hymba's five stages
TRAIN_SCORES = {
    "internvl2-26b": (4, 512, {(4, 8, 6, 768, 768): (48, 1)}),
    "whisper-medium": (4, 512, {(4, 16, 1, 512, 512): (24, 1),
                                (4, 16, 1, 512, 1500): (24, 1),
                                (4, 16, 1, 1500, 1500): (24, 1)}),
    "hymba-1.5b": (2, 2048, {(2, 5, 5, 2048, 2048): (32, 5)}),
    "internlm2-1.8b": (4, 512, {(4, 8, 2, 512, 512): (24, 1)}),
}


@pytest.mark.parametrize("arch", list(TRAIN_SCORES))
def test_chip_smoke_attention_rows_count_the_prefix(arch):
    """``chip_smoke.attention_rows``, the train phases' launch gate of the
    softmax and its backward, counts the vision prefix's rows beside the
    text's, and the encoder's and the cross attention's scores, at full
    depth and cut to 1 layer a stage."""
    from repro_torch.configs import get_config
    cs = _chip_smoke()
    batch, seq, want = TRAIN_SCORES[arch]
    cfg = get_config(arch)
    for i, c in enumerate((cfg, cs._cut(cfg, 1))):
        assert dict(cs.attention_rows(c, batch, seq)) == {
            shape: n[i] for shape, n in want.items()}


def test_chip_smoke_train_batch_draws_vision_embeds_as_request_extras():
    """``chip_smoke.train_batch`` (the batch of the card's ``train_vlm``):
    the launcher's tokens at the step, and each row's ``vision_embeds`` the
    draw ``launch.serve.request_extras`` makes of a request from the same
    generator, row after row."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticLM
    cs = _chip_smoke()
    cfg = get_smoke_config(ARCH)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=16, global_batch=3)
    rng = np.random.default_rng(0)
    got = [cs.train_batch(cfg, data, step, rng) for step in (0, 5)]
    rng = np.random.default_rng(0)
    for step, batch in zip((0, 5), got):
        want = np.stack([launch_serve.request_extras(cfg, rng)[
            "vision_embeds"] for _ in range(3)])
        assert batch["vision_embeds"].dtype == np.float32
        assert batch["vision_embeds"].shape == (3, cfg.vision_tokens,
                                                cfg.d_model)
        np.testing.assert_array_equal(batch["vision_embeds"], want)
        for k, v in data.batch_at(step).items():
            np.testing.assert_array_equal(batch[k], v)
    assert not np.array_equal(got[0]["vision_embeds"],
                              got[1]["vision_embeds"])


def test_serve_launcher_draws_the_extras():
    """The launcher serves the smoke config on the CPU with a prefix of
    patch embeddings per request, drawn from the seeded generator before
    each prompt (N(0, 0.02) of (vision_tokens, d_model))."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(0)
    extra = launch_serve.request_extras(cfg, rng)
    want = np.random.default_rng(0).normal(
        0, 0.02, (cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    assert list(extra) == ["vision_embeds"]
    np.testing.assert_array_equal(extra["vision_embeds"], want)
    launch_serve.main(["--arch", ARCH, "--smoke", "--requests", "2",
                       "--max-new", "2", "--prompt-len", "5",
                       "--device", "cpu", "--cache-len", "32"])
