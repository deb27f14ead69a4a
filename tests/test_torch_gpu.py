"""Each CUDA kernel of the PyTorch port against its plain PyTorch version,
one train step against the plain versions, and the recurrent,
encoder-decoder and vision smoke configs served, on the card (they skip
where there is none).  No JAX here, so the file runs
on the machine with the card:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels as K  # noqa: E402
from repro_torch.kernels import fused, ppa, ref, softmax_ppa  # noqa: E402
from repro_torch.tables import BITS, NAFS, load_table  # noqa: E402

TABLES = [(naf, bits) for naf in NAFS for bits in BITS]
SOFTMAX_ATOL = 1e-6       # the reference's own kernel-vs-wrapper bound
#: the softmax backward against its plain version, over the largest
#: incoming gradient (chip_smoke.py's SOFTMAX_BWD_REL)
SOFTMAX_BWD_REL = 1e-6
#: a kernel arm's gradient gap to the plain arm, over each leaf's largest
#: gradient (chip_smoke.py's TRAIN_PARITY_LIMIT)
TRAIN_PARITY_LIMIT = 2.0 ** -8
#: the served model's decode shape and a full 4 x 128 prefill group; the
#: MLP gates of qwen2-7b, qwen3-14b and mistral-nemo-12b at decode (d_ff
#: 18944, 17408, 14336) and internvl2-26b's at a train step (4 x (256 +
#: 512) rows of 16384)
FUSED_SHAPES = [(4, 1, 8192), (512, 8192), (4, 1, 18944), (4, 1, 17408),
                (4, 1, 14336), (4, 768, 16384)]
#: the decode scores of internlm2 and of the GQA groups of 7, 5 and 4
#: (qwen2-7b, qwen3-14b, mistral-nemo-12b), a prefill group, and
#: internvl2-26b's train scores over its vision prefix and text
SOFTMAX_SHAPES = [(4, 8, 2, 1, 512), (4, 8, 2, 128, 128), (4, 4, 7, 1, 512),
                  (4, 8, 5, 1, 512), (4, 8, 4, 1, 512), (4, 8, 6, 768, 768)]
#: the training scores (batch 4 x seq 512; internvl's 256 + 512 rows) and
#: a decode row
TRAIN_SOFTMAX_SHAPES = [(4, 8, 2, 512, 512), (4, 8, 2, 1, 512),
                        (4, 8, 6, 768, 768)]
#: both layouts of the forward's warp-per-row path and its block-per-row
#: path; the backward's row kernel and, unaligned, its earlier paths
ROW_LENGTHS = [1, 31, 33, 512, 1024, 2048, 4096]
INT32_EXTREMES = [-(1 << 31), -(1 << 31) + 1, (1 << 31) - 1]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _float_inputs(tc, seed):
    xs, xe = tc.interval
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(xs - 0.5 - xe, xe + 0.5, size=7 * 153),
        rng.normal(0.0, 3.0, size=512),
        [0.0, -0.0, xe, -xe, xe - 2.0 ** -9, 2.0 ** -9, -(2.0 ** -9)],
    ]).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("naf,bits", TABLES)
def test_cuda_int_kernel_on_card(naf, bits):
    """Exact over a span beyond each end of the interval and at the int32
    extremes, on an aligned input, an unaligned view (no 16-byte vectors)
    and a length 3 past a multiple of 4 (a scalar tail)."""
    dev = _card()
    tc = K.pack_table(load_table(naf, bits), dev)
    span = tc.hi - tc.lo
    x = torch.cat([torch.arange(tc.lo - span, tc.hi + span, device=dev),
                   torch.tensor(INT32_EXTREMES, device=dev)]
                  ).to(torch.int32)
    n3 = (x.numel() - 1) // 4 * 4 - 1
    for xi in (x, x[1:], x[:n3]):
        assert torch.equal(ppa.ppa_eval_int(tc, xi),
                           ref.ppa_eval_ref(xi, tc.starts, tc.coefs,
                                            tc.plan))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("naf,bits", TABLES)
def test_cuda_fused_kernel_on_card(naf, bits, dtype):
    dev = _card()
    tc = K.pack_table(load_table(naf, bits), dev)
    x = torch.from_numpy(_float_inputs(tc, 1)).to(dev, getattr(torch, dtype))
    for gate in (False, True):
        assert torch.equal(fused.ppa_fused_apply(tc, x, gate),
                           fused.ppa_fused_plain(tc, x, gate))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("launch", fused.LAUNCH_CANDIDATES)
def test_cuda_fused_kernel_at_every_launch(launch, dtype):
    """Every launch shape the tuner may pick (threads a block, blocks an
    SM) gives the plain version's output bit for bit: at the served decode
    and prefill shapes, a size that is not a multiple of 8 and an
    unaligned input, gated and not, on every table."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    for naf, bits in TABLES:
        tc = K.pack_table(load_table(naf, bits), dev)
        for shape in FUSED_SHAPES + [(3, 1001), (8192,)]:
            x = torch.randn(shape, generator=gen, device=dev)
            if shape == (8192,):
                x = x[1:]           # not 16-byte aligned: no vectors
            x = (x * tc.interval[1]).to(getattr(torch, dtype))
            for gate in (False, True):
                fused.set_default_launch(launch)
                try:
                    got = fused.ppa_fused_apply(tc, x, gate)
                finally:
                    fused.set_default_launch(None)
                assert torch.equal(got, fused.ppa_fused_plain(tc, x, gate)
                                   ), (naf, bits, shape, gate)


@pytest.mark.gpu
def test_softmax_kernel_on_card():
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 4, (2, 2, 3, 7, 300)
                                    ).astype(np.float32)).to(dev)
    where = torch.from_numpy(rng.random((2, 1, 1, 7, 300)) < 0.6).to(dev)
    where[0, 0, 0, 3] = False
    cols = torch.from_numpy(rng.random((300, 2)) < 0.5).to(dev)[:, 0]
    for w in (None, where, where[:, :, :, :1], cols):
        got = softmax_ppa.softmax_ppa(x, tc, w)
        want = softmax_ppa.softmax_ppa_plain(x, tc, w)
        assert float((got - want).abs().max()) <= SOFTMAX_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", FUSED_SHAPES + [(3, 1001), "unaligned"])
def test_cuda_fused_kernel_at_launch_shapes(shape, dtype):
    """Exact at the served shapes, at a size that is not a multiple of 8
    (a scalar tail after the 16-byte vectors) and on an input that is not
    16-byte aligned (no vectors), gated and not, on every table."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    for naf, bits in TABLES:
        tc = K.pack_table(load_table(naf, bits), dev)
        if shape == "unaligned":
            x = torch.randn(8192, generator=gen, device=dev)[1:]
        else:
            x = torch.randn(shape, generator=gen, device=dev)
        x = (x * tc.interval[1]).to(getattr(torch, dtype))
        for gate in (False, True):
            assert torch.equal(fused.ppa_fused_apply(tc, x, gate),
                               fused.ppa_fused_plain(tc, x, gate)), (
                naf, bits, gate)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SOFTMAX_SHAPES)
def test_softmax_kernel_at_launch_shapes(shape):
    """Attention's scores with its (B, 1, 1, T, S) mask: causal, the last
    quarter of the ring still empty at decode, one row all masked."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 4, shape).astype(np.float32)).to(dev)
    b, t, s = shape[0], shape[-2], shape[-1]
    qp = np.arange(t)[:, None] + (s - t) - (s // 4 if t == 1 else 0)
    valid = np.broadcast_to(np.arange(s)[None, :] <= qp, (b, 1, 1, t, s))
    valid = valid.copy()
    valid[0, 0, 0, 0] = False
    where = torch.from_numpy(valid).to(dev)
    for w in (None, where):
        got = softmax_ppa.softmax_ppa(x, tc, w)
        want = softmax_ppa.softmax_ppa_plain(x, tc, w)
        assert float((got - want).abs().max()) <= SOFTMAX_ATOL
    assert not got[0, :, :, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_softmax_kernel_row_lengths(n):
    """Rows of every layout, masked and not, aligned and not; an
    all-masked row is exactly 0."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(n)
    flat = torch.from_numpy(rng.normal(0, 4, 16 * n + 1).astype(np.float32)
                            ).to(dev)
    where = torch.from_numpy(rng.random((16, n)) < 0.7).to(dev)
    where[3] = False
    for x in (flat[:16 * n].view(16, n), flat[1:].view(16, n)):
        for w in (None, where):
            got = softmax_ppa.softmax_ppa(x, tc, w)
            want = softmax_ppa.softmax_ppa_plain(x, tc, w)
            assert float((got - want).abs().max()) <= SOFTMAX_ATOL
        assert not got[3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_softmax_grad_on_card(masked):
    """With a gradient, the cuda_fused softmax runs the softmax kernel
    forward (bit for bit the output without a gradient) and the softmax
    backward kernel backward: one launch each, no plain version, and a
    gradient within SOFTMAX_BWD_REL of the backward's plain version."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.normal(0, 4, (2, 2, 3, 7, 300)
                                    ).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)
                         ).to(dev)
    where = None
    if masked:
        where = torch.from_numpy(rng.random((2, 1, 1, 7, 300)) < 0.6).to(dev)
        where[0, 0, 0, 3] = False
    tx = x.clone().requires_grad_(True)
    K.reset_counts()
    y = K.ppa_softmax(tc, tx, where=where, backend="cuda_fused")
    y.backward(g)
    c = K.read_counts()
    assert c["softmax_ppa"] == {"launches": 1, "plain": 0}
    assert c["softmax_ppa_bwd"] == {"launches": 1, "plain": 0}
    assert c["ref"]["plain"] == 0
    with torch.no_grad():
        kernel = K.ppa_softmax(tc, x, where=where, backend="cuda_fused")
    assert torch.equal(y.detach(), kernel)
    want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, where)
    assert float((tx.grad - want).abs().max()) <= (
        SOFTMAX_BWD_REL * float(g.abs().max()))
    if masked:
        assert not tx.grad[0, :, :, 3].any()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", TRAIN_SOFTMAX_SHAPES)
def test_softmax_bwd_kernel_at_launch_shapes(shape):
    """The training scores and a decode row, with attention's causal mask
    (one row all masked) and without."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 4, shape).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    b, t, s = shape[0], shape[-2], shape[-1]
    qp = np.arange(t)[:, None] + (s - t) - (s // 4 if t == 1 else 0)
    valid = np.broadcast_to(np.arange(s)[None, :] <= qp, (b, 1, 1, t, s))
    valid = valid.copy()
    valid[0, 0, 0, 0] = False
    where = torch.from_numpy(valid).to(dev)
    lim = SOFTMAX_BWD_REL * float(g.abs().max())
    for w in (None, where):
        got = softmax_ppa.softmax_ppa_bwd(x, g, tc, w)
        want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, w)
        assert float((got - want).abs().max()) <= lim
    assert not got[0, :, :, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("n", ROW_LENGTHS)
def test_softmax_bwd_kernel_row_lengths(n):
    """Rows of every path (aligned rows of a multiple of 4 across the
    warps of a block; unaligned ones one warp a row up to 1024 scores, one
    block a row beyond), masked and not, aligned and not, with a three-way
    tie for a row's max; an all-masked row gives exactly 0."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    rng = np.random.default_rng(n + 1)
    flat = rng.normal(0, 4, 16 * n + 1).astype(np.float32)
    flat[1 + 5 * n:1 + 5 * n + 3] = flat.max() + 1.0
    flat = torch.from_numpy(flat).to(dev)
    gflat = torch.from_numpy(rng.normal(size=16 * n + 1).astype(np.float32)
                             ).to(dev)
    where = torch.from_numpy(rng.random((16, n)) < 0.7).to(dev)
    where[3] = False
    where[5, :3] = True
    for x, g in ((flat[1:].view(16, n), gflat[1:].view(16, n)),
                 (flat[:16 * n].view(16, n), gflat[:16 * n].view(16, n))):
        lim = SOFTMAX_BWD_REL * float(g.abs().max())
        for w in (None, where):
            got = softmax_ppa.softmax_ppa_bwd(x, g, tc, w)
            want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, w)
            assert float((got - want).abs().max()) <= lim
        assert not got[3].any()


@pytest.mark.gpu
def test_train_step_on_card_matches_plain():
    """One train step of the full-width 2-layer cut (float32, batch 2 x
    seq 128): cuda_fused's loss and gradients against ref's (the plain
    versions on the card) within the train parity limit of chip_smoke.py,
    and make_train_step launches the three kernels and no plain version."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.train import (OptCfg, TrainCfg, make_train_step,
                                   train_init)
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves
    dev = _card()
    cfg = get_config("internlm2-1.8b").replace(act_impl="ppa",
                                               compute_dtype="float32")
    cfg = cfg.replace(stages=tuple(dataclasses.replace(st, n_layers=2)
                                   for st in cfg.stages))
    params = init_params(param_specs(cfg), 0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=128, global_batch=2).batch_at(0).items()}
    rl, rg = loss_and_grads(cfg, make_acts("ppa", "ref", dev), params, batch)
    acts = make_acts("ppa", "cuda_fused", dev)
    fl, fg = loss_and_grads(cfg, acts, params, batch)
    assert abs(float(fl) - float(rl)) <= 1e-6 * abs(float(rl))
    for a, b in zip(leaves(fg), leaves(rg)):
        assert float((a - b).abs().max()) <= (
            TRAIN_PARITY_LIMIT * float(b.abs().max()))
    tcfg = TrainCfg(opt=OptCfg(kind="sgdm"))
    step = make_train_step(cfg, tcfg, acts)
    K.reset_counts()
    params, state, m = step(params, train_init(tcfg, params), batch)
    c = K.read_counts()
    assert all(c[k]["launches"] >= 2 for k in ("ppa_fused", "softmax_ppa"))
    assert c["softmax_ppa_bwd"]["launches"] >= 2
    assert not any(v.get("plain", 0) for v in c.values())
    assert int(state["step"]) == 1 and torch.isfinite(m["loss"])


@pytest.mark.gpu
def test_round_mults_plan_on_card():
    dev = _card()
    tab = load_table("exp2_frac", 16)
    tc = K.pack_table(dataclasses.replace(tab, cfg=dataclasses.replace(
        tab.cfg, round_mults=True, w_out=12)), dev)
    x = torch.arange(-tc.hi, 2 * tc.hi, device=dev, dtype=torch.int32)
    assert torch.equal(ppa.ppa_eval_int(tc, x),
                       ref.ppa_eval_ref(x, tc.starts, tc.coefs, tc.plan))


@pytest.mark.gpu
def test_wrappers_count_launches_on_card():
    dev = _card()
    tc = K.pack_table(load_table("sigmoid_wide", 16), dev)
    K.reset_counts()
    x = torch.linspace(-9, 9, 1000, device=dev)
    K.ppa_gate(tc, x, backend="cuda_fused")
    K.ppa_apply(tc, x, backend="cuda_int")
    c = K.read_counts()
    assert c["ppa_fused"] == {"launches": 1, "plain": 0}
    assert c["ppa_int"] == {"launches": 1}
    assert c["ref"]["plain"] == 0


@pytest.mark.gpu
def test_moe_block_on_card_matches_plain():
    """moonshot's MoE block at a narrow width (d_model 256, 16 experts of
    128, top 6, 2 shared, float32) on the card through the fused kernel,
    against the same block on the CPU (the plain versions): the same
    routed ids, the output within 2^-8 of its largest magnitude (a silu
    input one float32 rounding from a grid boundary moves one step), the
    kernel launched and no plain version run."""
    from repro_torch.models import make_acts
    from repro_torch.models import moe as M
    dev = _card()
    cfg = M.MoECfg(d_model=256, d_ff=128, n_experts=16, top_k=6,
                   n_shared=2)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std
    params = {"router": rnd(256, 16, std=0.0625),
              "w_gate": rnd(16, 256, 128, std=0.0625),
              "w_up": rnd(16, 256, 128, std=0.0625),
              "w_down": rnd(16, 128, 256, std=0.088),
              "shared": {"w_gate": rnd(256, 256, std=0.0625),
                         "w_up": rnd(256, 256, std=0.0625),
                         "w_down": rnd(256, 256, std=0.0625)}}
    x = rnd(4, 32, 256)
    on_card = {k: ({n: t.to(dev) for n, t in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in params.items()}
    ids_cpu = M._route(x.reshape(-1, 256), params["router"], cfg)[0]
    ids_card = M._route(x.reshape(-1, 256).to(dev), on_card["router"],
                        cfg)[0]
    assert torch.equal(ids_card.cpu(), ids_cpu)
    want, aux_cpu = M.moe_block(params, x, cfg,
                                make_acts("ppa", "cuda_fused", "cpu"))
    K.reset_counts()
    got, aux = M.moe_block(on_card, x.to(dev), cfg,
                           make_acts("ppa", "cuda_fused", dev))
    c = K.read_counts()
    assert c["ppa_fused"]["launches"] == 2 and c["ppa_fused"]["plain"] == 0
    assert c["ref"]["plain"] == 0
    assert float((got.cpu() - want).abs().max()) <= (
        2.0 ** -8 * float(want.abs().max()))
    assert abs(float(aux) - float(aux_cpu)) <= 1e-6 * float(aux_cpu)


@pytest.mark.gpu
def test_fused_kernel_at_flash_chunk_shape():
    """exp_neg-16 on float32 without the gate at flash attention's chunk
    and rescale shapes (internlm2, one 16k prompt, chunks of 1024), with
    +inf where the causal mask hides a key and NaN where the first chunk
    rescales -inf: equal to the plain version."""
    dev = _card()
    tc = K.pack_table(load_table("exp_neg", 16), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape in ((1, 8, 2, 16384, 1024), (1, 8, 2, 16384)):
        x = torch.randn(shape, generator=gen, device=dev).abs() * 4.0
        if len(shape) == 5:
            hidden = (torch.arange(1024, device=dev)[None, :]
                      > torch.arange(16384, device=dev)[:, None])
            x = x.masked_fill(hidden, float("inf"))
        else:
            x[..., 0] = float("nan")
        got = fused.ppa_fused_apply(tc, x, False)
        assert torch.equal(got, fused.ppa_fused_plain(tc, x, False)), shape
        assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["hymba-1.5b", "rwkv6-3b"])
def test_recurrent_smoke_serves_on_card(arch):
    """The smoke config of a recurrent kind (hymba's attention + SSM,
    RWKV6) with act_impl="ppa" served on the card through cuda_fused:
    every request finishes; the fused kernel launches at least layers x
    engine steps times, the softmax kernel as often with hymba's attention
    and never without attention; no plain version runs; prompts prefill
    at their exact lengths."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import Request, ServeEngine
    dev = _card()
    cfg = get_smoke_config(arch).replace(act_impl="ppa")
    eng = ServeEngine(cfg, init_params(param_specs(cfg), 0, device=dev),
                      n_slots=4, cache_len=64, act_backend="cuda_fused",
                      device=dev)
    rng = np.random.default_rng(0)
    lens = (9, 5, 9, 11, 5, 9)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
        np.int32), max_new_tokens=6) for i, n in enumerate(lens)]
    K.reset_counts()
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step() or eng.queue:
        steps += 1
    assert all(r.done and len(r.output) == 6 for r in reqs)
    c = K.read_counts()
    need = cfg.n_layers * steps
    assert c["ppa_fused"]["launches"] >= need
    sm = c["softmax_ppa"]["launches"]
    assert sm >= need if arch == "hymba-1.5b" else sm == 0
    assert not any(v.get("plain", 0) for v in c.values())
    assert {n for n, _ in eng.prefill_shapes} == set(lens)


#: whisper-medium's rows of 1500 scores: the encoder's (g, 16, 1, 1500,
#: 1500), all valid; cross attention at decode (4 slots) and at prefill
WHISPER_SOFTMAX_SHAPES = [(1, 16, 1, 1500, 1500), (4, 16, 1, 1, 1500),
                          (2, 16, 1, 64, 1500)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WHISPER_SOFTMAX_SHAPES)
def test_softmax_kernel_at_whisper_rows(shape):
    """Rows of 1500 scores (6000 bytes, a multiple of 16): the 16-byte
    layout (vec 4, 16 items a lane) on a contiguous input, the scalar one
    (vec 1, 64 items) on a view one float off; unmasked, under the
    all-valid mask cross attention hands it, and under a random mask with
    an all-masked row."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    n = int(np.prod(shape))
    flat = torch.randn(n + 1, generator=gen, device=dev) * 4.0
    b, t, s = shape[0], shape[-2], shape[-1]
    ones = torch.ones((b, 1, 1, t, s), dtype=torch.bool, device=dev)
    rand = torch.rand((b, 1, 1, t, s), generator=gen, device=dev) < 0.7
    rand[0, 0, 0, 0] = False
    assert softmax_ppa.route(s, True) == (4, 16)
    assert softmax_ppa.route(s, False) == (1, 64)
    for x in (flat[:n].view(shape), flat[1:].view(shape)):
        for w in (None, ones, rand):
            got = softmax_ppa.softmax_ppa(x, tc, w)
            want = softmax_ppa.softmax_ppa_plain(x, tc, w)
            assert float((got - want).abs().max()) <= SOFTMAX_ATOL
        assert not got[0, :, :, 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fused_kernel_gelu_at_whisper_encoder_shape(dtype):
    """gelu_inner-16 gated, whisper's encoder MLP (1, 1500, 4096): bit for
    bit the plain version."""
    dev = _card()
    tc = K.pack_table(load_table("gelu_inner", 16), dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    x = (torch.randn((1, 1500, 4096), generator=gen, device=dev) * 3.0
         ).to(getattr(torch, dtype))
    assert torch.equal(fused.ppa_fused_apply(tc, x, True),
                       fused.ppa_fused_plain(tc, x, True))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_encdec_and_vision_smoke_serve_on_card(arch):
    """The whisper and internvl smoke configs with act_impl="ppa" served
    on the card through cuda_fused, each request with its own extras:
    every request finishes, the fused and softmax kernels launch at least
    layers x engine steps times, no plain version runs, and the tokens
    are the plain versions' (``ref``) on the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import request_extras
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import Request, ServeEngine
    dev = _card()
    cfg = get_smoke_config(arch).replace(act_impl="ppa")
    params = init_params(param_specs(cfg), 0, device=dev)
    outs = []
    for backend in ("cuda_fused", "ref"):
        eng = ServeEngine(cfg, params, n_slots=4, cache_len=64,
                          act_backend=backend, device=dev)
        rng = np.random.default_rng(0)
        reqs = []
        for i, n in enumerate((9, 5, 12, 3, 7, 9)):
            extra = request_extras(cfg, rng)
            reqs.append(Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, n).astype(np.int32), max_new_tokens=6,
                extra=extra))
        K.reset_counts()
        for r in reqs:
            eng.submit(r)
        steps = 0
        while eng.step() or eng.queue:
            steps += 1
        assert all(r.done and len(r.output) == 6 for r in reqs)
        outs.append([r.output for r in reqs])
        c = K.read_counts()
        if backend == "cuda_fused":
            need = cfg.n_layers * steps
            assert c["ppa_fused"]["launches"] >= need
            assert c["softmax_ppa"]["launches"] >= need
            assert not any(v.get("plain", 0) for v in c.values())
    assert outs[0] == outs[1]


def _fits_equal(a, b):
    for k in ("ok", "mae", "a_int", "b_int", "mae0", "n_satisfying",
              "evals", "warm_hit", "truncated"):
        assert getattr(a, k) == getattr(b, k), k
    if a.a_candidates is None:
        assert b.a_candidates is None
    else:
        assert np.array_equal(a.a_candidates, b.a_candidates)
        assert np.array_equal(a.b_candidates, b.b_candidates)


@pytest.mark.gpu
def test_torch_search_backend_on_card():
    """The card's candidate blocks (single, multi-window and batched) and
    ``fit_segment`` over CFG1/CFG2, the five quantizers and the
    feasible/best/full modes, bit-equal to the port's numpy backend."""
    from repro_torch.core import (FWLConfig, get_naf, grid_for_interval,
                                  make_quantizer)
    from repro_torch.core.searchspace import (NumpySearchBackend,
                                              TorchSearchBackend)
    dev = _card()
    card = TorchSearchBackend()
    assert card.device.type == "cuda"
    host = NumpySearchBackend()
    cfg1 = FWLConfig(7, 7, (7,), (7,), 7)
    cfg2 = FWLConfig(7, 7, (7, 7), (7, 7), 7)
    spec = get_naf("sigmoid")
    for cfg in (cfg1, cfg2):
        x = grid_for_interval(*spec.interval, cfg.w_in)
        f = spec(x.astype(np.float64) / (1 << cfg.w_in))
        rng = np.random.default_rng(cfg.order)
        ctxs = [host.context(x[s:e], f[s:e], cfg, flatten_b=fb, b_fixed=3)
                for s, e, fb in ((0, 24, True), (5, 70, True),
                                 (40, 41, False))]
        blocks = [[rng.integers(-300, 300, k) for _ in range(cfg.order)]
                  for k in (1, 77, 300)]
        want = [host.eval_block(c, b) for c, b in zip(ctxs, blocks)]
        # one multi-window dispatch shares the intercept mode
        got = card.eval_block_multi(list(zip(ctxs[:2], blocks[:2])))
        got += [card.eval_block(c, b) for c, b in zip(ctxs, blocks)]
        for c in (ctxs[1], ctxs[2]):
            got += list(card.eval_block_batch(c, blocks))
        want = (want[:2] + want + [host.eval_block(c, b)
                                   for c in (ctxs[1], ctxs[2])
                                   for b in blocks])
        for (m, bi, m0), (wm, wb, wm0) in zip(got, want):
            k = int(np.argmin(wm))
            assert np.array_equal(m, wm) and np.array_equal(bi, wb)
            assert m0[k] == wm0[k]
        for qname in ("fqa", "fqa_fast", "qpa", "plac", "mlplac"):
            for mode in ("feasible", "best", "full"):
                w = 24 if cfg.order == 2 else 37
                fits = [make_quantizer(qname, backend=b).fit_segment(
                    x[3:3 + w], f[3:3 + w], cfg, 0.5 ** 8, mode=mode)
                    for b in (host, card)]
                _fits_equal(*fits)


@pytest.mark.gpu
def test_run_shard_on_card_equals_numpy(tmp_path):
    """A two-host ``run_shard`` sweep of a small grid scanned on the card
    (``TorchSearchBackend``), merged, equals a serial numpy compile by
    ``table_identity``, each key compiled once; the batch pool's workers
    are spawned and compiled on the card."""
    from repro_torch.compiler import (CompileJob, TableStore, compile_batch,
                                      merge_shards, run_shard,
                                      table_identity)
    from repro_torch.core import FWLConfig, PPAScheme
    _card()
    cfg = FWLConfig(7, 7, (7,), (7,), 7)
    jobs = [CompileJob(naf, cfg, PPAScheme(1, None, q),
                       search_backend="torch")
            for naf in ("sigmoid", "tanh", "exp2_frac")
            for q in ("fqa", "qpa")]
    serial = TableStore(tmp_path / "numpy")
    want = compile_batch([CompileJob(j.naf, j.cfg, j.scheme,
                                     search_backend="numpy") for j in jobs],
                         store=serial, processes=1)
    reports = [run_shard(jobs, hosts=2, host_id=i,
                         store=TableStore(tmp_path / f"host{i}"),
                         processes=2) for i in range(2)]
    assert sorted(k for r in reports for k in r.compiled) == sorted(
        j.key() for j in jobs)
    workers = [w for r in reports for w in r.compiled_by.values()]
    assert {w["backend"] for w in workers} == {"torch@cuda"}
    assert all(w["dispatches"] > 0 for w in workers)
    merged = TableStore(tmp_path / "merged")
    merge_shards(merged, [tmp_path / "host0", tmp_path / "host1"])
    for job, w in zip(jobs, want):
        assert table_identity(merged.lookup(job)) == table_identity(w)


@pytest.mark.gpu
def test_store_fed_engine_launches_kernels_on_card():
    """``ServeEngine(table_store=...)`` on the card, the smoke internlm2
    config with its 16-bit tables from an in-memory store: the greedy
    tokens of the shipped-JSON engine, the fused and softmax kernels at
    least layers x engine steps times, no plain version."""
    from repro_torch.compiler import CompileJob, TableStore
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, param_specs, ppa_table_jobs
    from repro_torch.serve import Request, ServeEngine
    dev = _card()
    cfg = get_smoke_config("internlm2-1.8b").replace(act_impl="ppa")
    store = TableStore(persist=False)
    for naf, fcfg, scheme in ppa_table_jobs("ppa"):
        store.put(CompileJob(naf, fcfg, scheme), load_table(naf, 16))
    params = init_params(param_specs(cfg), 0, device=dev)
    outs = []
    for table_store in (None, store):
        eng = ServeEngine(cfg, params, n_slots=4, cache_len=64,
                          table_store=table_store, device=dev)
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=6) for i, n in enumerate((9, 5, 12))]
        K.reset_counts()
        for r in reqs:
            eng.submit(r)
        steps = 0
        while eng.step() or eng.queue:
            steps += 1
        c = K.read_counts()
        for k in ("ppa_fused", "softmax_ppa"):
            assert c[k]["launches"] >= cfg.n_layers * steps, k
        assert not any(v.get("plain", 0) for v in c.values())
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1]
    assert store.stats()["compiles"] == 0


@pytest.mark.gpu
def test_fused_launch_reports_its_bound_bytes():
    """A fused launch on the card reports to an ``OpCosts`` counter the
    bytes and operations of its bound's formula at its shape."""
    from repro_torch.roofline import OpCosts, bounds
    dev = _card()
    tc = K.pack_table(load_table("sigmoid_wide", 16), dev)
    x = torch.randn(4, 1, 8192, device=dev, dtype=torch.bfloat16)
    n0 = fused.counts["launches"]
    with OpCosts() as c:
        fused.ppa_fused_apply(tc, x, gate=True)
    assert fused.counts["launches"] == n0 + 1
    work = bounds.fused_work(x.numel(), 2, tc.num_segments, tc.plan.order,
                             tc.plan.round_mults, True)
    assert c.bytes == work[0] == 2 * 2 * x.numel() + 4 * tc.num_segments * (
        tc.plan.order + 2)
    assert [k["shape"] for k in c.kernels] == [(4, 1, 8192)]
    assert c.kernel_ops["ppa_fused"] == {"int32": work[1],
                                         "float32": work[2]}


#: the sharded MoE against the local path on the card (another summation
#: order over the model ranks: the reference's sharded-vs-local tolerance)
MOE_ATOL, MOE_RTOL = 2e-5, 1e-4


def _nccl_moe_rank(rank, init_file, out_dir):
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import make_ctx
    from repro_torch.models import make_acts
    from repro_torch.models import moe as M

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=2, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        rng = np.random.default_rng(0)
        d, f, e = 64, 128, 8
        params = {k: torch.from_numpy(rng.normal(0, s, shape).astype(
            np.float32)).to(dev) for k, s, shape in (
                ("router", 0.5, (d, e)), ("w_gate", 0.2, (e, d, f)),
                ("w_up", 0.2, (e, d, f)), ("w_down", 0.2, (e, f, d)))}
        x = torch.from_numpy(rng.normal(0, 1, (4, 16, d)).astype(
            np.float32)).to(dev)
        acts = make_acts("ppa", device=dev)
        res = {}
        for mode in ("weight_gather", "token_gather"):
            cfg = M.MoECfg(d_model=d, d_ff=f, n_experts=e, top_k=2,
                           capacity_factor=8.0, mode=mode)
            y0, a0 = M.moe_block(params, x, cfg, acts)
            n0 = fused.counts["launches"]
            y1, a1 = M.moe_block(params, x, cfg, acts, make_ctx(mesh))
            res[mode] = (y0.cpu().numpy(), y1.cpu().numpy(), float(a0),
                         float(a1), fused.counts["launches"] - n0)
        np.save(f"{out_dir}/rank{rank}.npy", np.array(res, dtype=object),
                allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_moe_over_nccl_on_two_cards(tmp_path):
    """The sharded MoE on a (1, 2) mesh over NCCL, each card holding half
    the experts, against the local path, in both modes; the expert
    products' gate launches the fused kernel on each card."""
    import time
    import torch.multiprocessing as mp
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ctx = mp.start_processes(_nccl_moe_rank, args=(
        str(tmp_path / "init"), str(tmp_path)), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the NCCL ranks did not finish in 300 s")
    for rank in range(2):
        res = np.load(tmp_path / f"rank{rank}.npy", allow_pickle=True).item()
        for mode, (y0, y1, a0, a1, launches) in res.items():
            np.testing.assert_allclose(y1, y0, atol=MOE_ATOL, rtol=MOE_RTOL)
            np.testing.assert_allclose(a1, a0, rtol=1e-6)
            assert launches >= 1, mode


def _nccl_tp_rank(rank, init_file, out_dir):
    """The smoke internlm2 (``ppa``) on one card, then tensor-parallel on a
    (1, 2) NCCL mesh: prefill logits and 4 greedy decode steps of each."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import make_ctx
    from repro_torch.models import (decode_step, init_params, make_acts,
                                    param_specs, prefill, prepare_params)
    from repro_torch.models.transformer import shard_params

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=2, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        cfg = get_smoke_config("internlm2-1.8b").replace(act_impl="ppa")
        params = prepare_params(init_params(param_specs(cfg), 0,
                                            device=dev), cfg)
        acts = make_acts("ppa", device=dev)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, (4, 12)).astype(np.int32)).to(dev)
        res = {}
        for name, ctx in (("local", None), ("tp", make_ctx(mesh))):
            p = params if ctx is None else shard_params(params, cfg, ctx)
            n0 = fused.counts["launches"]
            with torch.no_grad():
                logits, cache = prefill(p, cfg, {"tokens": tokens}, 32, acts,
                                        ctx=ctx)
                out = [logits]
                pos = torch.full((4,), 12, dtype=torch.int32, device=dev)
                for _ in range(4):
                    tok = out[-1].argmax(-1).to(torch.int32)[:, None]
                    if ctx is not None:
                        tok = tok.full_tensor()
                    logits, cache = decode_step(p, cfg, cache, tok, pos,
                                                acts, ctx)
                    out.append(logits)
                    pos = pos + 1
            res[name] = ([(o.full_tensor() if ctx is not None else o)
                          .cpu().numpy() for o in out],
                         fused.counts["launches"] - n0)
        np.save(f"{out_dir}/tp{rank}.npy", np.array(res, dtype=object),
                allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_tensor_parallel_internlm2_over_nccl_on_two_cards(tmp_path):
    """A 2-layer internlm2 at the smoke width, every parameter a DTensor
    on a (1, 2) NCCL mesh over 2 cards: its prefill and decode logits
    within the CPU test's tolerance of the one-card run
    (tests/test_torch_shard_hint.py::LOGIT_ATOL), its greedy tokens equal,
    the fused kernel launched on each card."""
    import time
    import torch.multiprocessing as mp
    from test_torch_shard_hint import LOGIT_ATOL
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ctx = mp.start_processes(_nccl_tp_rank, args=(
        str(tmp_path / "init"), str(tmp_path)), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the NCCL ranks did not finish in 300 s")
    for rank in range(2):
        res = np.load(tmp_path / f"tp{rank}.npy", allow_pickle=True).item()
        (local, _), (tp, launches) = res["local"], res["tp"]
        assert launches >= 1
        for a, b in zip(tp, local):
            np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))
            np.testing.assert_allclose(a, b, rtol=0, atol=LOGIT_ATOL)


#: adafactor on shards against one card's update: the optimizer parity's
#: tolerances (tests/test_torch_train.py::OPT_RTOL, OPT_ATOL; that file
#: imports JAX, which the card's machine has not)
OPT_RTOL, OPT_ATOL = 2e-6, 1e-8
#: (shape, spec on the (1, 2) mesh): factored and split on its columns, on
#: its rows, unfactored, a vector
NCCL_ADA_LEAVES = {"a": ((4, 256, 512), (None, None, "model")),
                   "b": ((512, 256), ("model", None)),
                   "c": ((4, 16, 8), (None, None, "model")),
                   "e": ((256,), ("model",))}


def _nccl_adafactor_rank(rank, init_file, out_dir):
    """Three adafactor steps of the same leaves on one card and as
    DTensors on a (1, 2) NCCL mesh; the gathers the sharded steps ran."""
    import datetime
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import distribute, placements
    from repro_torch.train import OptCfg, opt_init, opt_update

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{init_file}",
                            rank=rank, world_size=2, device_id=dev,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        rng = np.random.default_rng(0)
        params = {k: rng.normal(size=s).astype(np.float32)
                  for k, (s, _) in NCCL_ADA_LEAVES.items()}
        grads = [{k: (0.1 * rng.normal(size=s)).astype(np.float32)
                  for k, (s, _) in NCCL_ADA_LEAVES.items()}
                 for _ in range(3)]

        def place(tree):
            return {k: distribute(torch.from_numpy(v).to(dev), (
                mesh, placements(NCCL_ADA_LEAVES[k][1], mesh)))
                for k, v in tree.items()}

        cfg = OptCfg(kind="adafactor")
        local = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
        lstate = opt_init(cfg, local)
        dp = place(params)
        dstate = opt_init(cfg, dp)
        gathers = 0
        for i, g in enumerate(grads):
            lr = torch.tensor(np.float32(1e-2 / (i + 1)), device=dev)
            local, lstate = opt_update(
                cfg, {k: torch.from_numpy(v).to(dev) for k, v in g.items()},
                lstate, local, lr)
            dg = place(g)
            with CommDebugMode() as comms:
                dp, dstate = opt_update(cfg, dg, dstate, dp, lr)
            gathers += sum(n for op, n in comms.get_comm_counts().items()
                           if "gather" in str(op))
        res = {"gathers": gathers,
               "params": {k: (dp[k].full_tensor().cpu().numpy(),
                              local[k].cpu().numpy()) for k in params},
               "state": {(k, n): (v.full_tensor().cpu().numpy(),
                                  lstate["mu"][k][n].cpu().numpy())
                         for k, m in dstate["mu"].items()
                         for n, v in m.items()}}
        np.save(f"{out_dir}/ada{rank}.npy", np.array(res, dtype=object),
                allow_pickle=True)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_adafactor_over_nccl_on_two_cards(tmp_path):
    """Adafactor on leaves split over a (1, 2) NCCL mesh, each card
    updating its shard and all-reducing only the statistics: three steps
    equal to one card's update of the whole leaves within the optimizer's
    tolerances, with no gather in the update."""
    import time
    import torch.multiprocessing as mp
    _card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    ctx = mp.start_processes(_nccl_adafactor_rank, args=(
        str(tmp_path / "init"), str(tmp_path)), nprocs=2, join=False,
        start_method="spawn")
    deadline = time.monotonic() + 300
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the NCCL ranks did not finish in 300 s")
    for rank in range(2):
        res = np.load(tmp_path / f"ada{rank}.npy", allow_pickle=True).item()
        assert res["gathers"] == 0
        for key, (got, want) in [*res["params"].items(),
                                 *res["state"].items()]:
            np.testing.assert_allclose(got, want, rtol=OPT_RTOL,
                                       atol=OPT_ATOL, err_msg=str(key))


#: the longest training rows, each across the 4 warps of a block (the
#: backward's row kernel): whisper's encoder scores at batch 1, every key
#: valid, and hymba's at batch 1 under its window of 1024
BLOCK_BWD_CASES = {"whisper encoder": ((1, 16, 1, 1500, 1500), None),
                   "hymba window": ((1, 5, 5, 2048, 2048), 1024)}
BLOCK_BWD_LAYOUTS = {1500: (4, 4, 3), 2048: (4, 4, 4)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BLOCK_BWD_CASES))
def test_softmax_bwd_block_kernel_at_training_rows(case):
    """The softmax backward kernel on the longest training rows within
    SOFTMAX_BWD_REL of its plain version: unmasked and under the all-valid
    mask at whisper's rows of 1500, under hymba's causal window at rows of
    2048 (every row from 1 to 1024 valid keys), each row across 4 warps."""
    dev = _card()
    shape, window = BLOCK_BWD_CASES[case]
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(shape, generator=gen, device=dev) * 4.0
    g = torch.randn(shape, generator=gen, device=dev)
    b, t, s = shape[0], shape[-2], shape[-1]
    assert softmax_ppa.bwd_route(s, True) == BLOCK_BWD_LAYOUTS[s]
    if window is None:
        masks = (None, torch.ones((b, 1, 1, t, s), dtype=torch.bool,
                                  device=dev))
    else:
        qp = torch.arange(t, device=dev)[:, None]
        kp = torch.arange(s, device=dev)[None, :]
        masks = (((kp <= qp) & (kp > qp - window))[None, None, None]
                 .expand(b, 1, 1, t, s),)
    lim = SOFTMAX_BWD_REL * float(g.abs().max())
    K.reset_counts()
    for w in masks:
        got = softmax_ppa.softmax_ppa_bwd(x, g, tc, w)
        want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, w)
        assert float((got - want).abs().max()) <= lim
    assert K.read_counts()["softmax_ppa_bwd"]["launches"] == len(masks)


@pytest.mark.gpu
def test_ste_gradient_of_the_fused_kernel_on_decays():
    """``ppa_act`` on ``exp_neg`` (the decays) through cuda_fused with a
    gradient: the fused kernel's forward, bit for bit the plain path's
    (``ref``), and the straight-through backward equal to the plain path's,
    one launch and no plain call on the kernel path."""
    dev = _card()
    tc = K.pack_table(load_table("exp_neg", 16), dev)
    gen = torch.Generator(device=dev).manual_seed(12)
    x = torch.rand((2, 64, 320, 16), generator=gen, device=dev) * 6.0
    g = torch.randn(x.shape, generator=gen, device=dev)
    out = {}
    for backend in ("cuda_fused", "ref"):
        tx = x.clone().requires_grad_(True)
        K.reset_counts()
        y = K.ppa_act(tc, tx, backend)
        y.backward(g)
        out[backend] = (y.detach(), tx.grad, K.read_counts())
    (yk, gk, ck), (yr, gr, _) = out["cuda_fused"], out["ref"]
    assert ck["ppa_fused"] == {"launches": 1, "plain": 0}
    assert ck["ref"]["plain"] == 0
    assert torch.equal(yk, yr)
    assert torch.equal(gk, gr)


def _bwd_layout_rows():
    """The longest row of each layout the backward's chooser picks."""
    out = {}
    for n in range(4, 8193, 4):
        out[softmax_ppa.bwd_route(n, True)] = n
    return sorted(out.values())


#: the backward's row kernel: the training rows (512, 768, 1500, 2048), its
#: longest row, and the longest row of each layout its chooser picks
BWD_ROW_LENGTHS = sorted({512, 768, 1500, 2048, 8192, *_bwd_layout_rows()})
#: the masks and inputs each length is held under; "offset 4 B" moves x and
#: g off 16-byte alignment, onto the earlier paths
BWD_ROW_CASES = ["no mask", "causal", "window 1024", "all valid",
                 "all-masked row", "three-way tie", "strided mask",
                 "offset 4 B"]


def _bwd_row_case(dev, n, case, rows: int = 8):
    """(x, g, where) of scores (2, 3, 1, rows, n) for one case of
    BWD_ROW_CASES: the masks (2, 1, 1, rows, n) as attention's, with the
    query positions spread over the row; "strided mask" a view whose
    column stride is rows (so the kernel reads its bytes one at a time)."""
    gen = torch.Generator(device=dev).manual_seed(n)
    shape = (2, 3, 1, rows, n)
    flat = torch.randn(2 * 3 * rows * n + 1, generator=gen, device=dev) * 4
    gflat = torch.randn(flat.numel(), generator=gen, device=dev)
    lo = 1 if case == "offset 4 B" else 0
    x = flat[lo:lo + flat.numel() - 1].view(shape)
    g = gflat[lo:lo + flat.numel() - 1].view(shape)
    qp = torch.linspace(0, n - 1, rows, device=dev).long()[:, None]
    kp = torch.arange(n, device=dev)[None, :]
    rand = torch.rand((2, 1, 1, rows, n), generator=gen, device=dev) < 0.7
    where = {"no mask": None, "offset 4 B": rand,
             "causal": (kp <= qp).expand(2, 1, 1, rows, n),
             "window 1024": ((kp <= qp) & (kp > qp - 1024)
                             ).expand(2, 1, 1, rows, n),
             "all valid": torch.ones((2, 1, 1, rows, n), dtype=torch.bool,
                                     device=dev),
             "all-masked row": rand, "three-way tie": rand,
             "strided mask": (torch.rand((n, rows), generator=gen,
                                         device=dev) < 0.7).t()}[case]
    if case == "all-masked row":
        where[1, 0, 0, 3] = False
    if case == "three-way tie":
        x[1, 2, 0, 5, :3] = x[1, 2, 0, 5].max() + 1.0
        where[1, 0, 0, 5, :3] = True
    return x, g, where


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_ROW_CASES)
@pytest.mark.parametrize("n", BWD_ROW_LENGTHS)
def test_softmax_bwd_row_kernel(n, case):
    """The backward's row kernel (each row across the warps of a block) at
    every training row length, its longest row and every layout its
    chooser picks, held to the plain version within SOFTMAX_BWD_REL of the
    largest gradient, with one launch and no plain call; an all-masked row
    gives exactly 0, and an input 4 B off alignment takes the earlier
    paths."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 16), dev)
    x, g, where = _bwd_row_case(dev, n, case)
    warps, vec, items = softmax_ppa.bwd_route(n, x.data_ptr() % 16 == 0)
    assert (warps == 0) == (case == "offset 4 B")
    if warps:
        assert 32 * warps * items * vec >= n and vec * items <= 16
    K.reset_counts()
    got = softmax_ppa.softmax_ppa_bwd(x, g, tc, where)
    torch.cuda.synchronize()
    assert K.read_counts()["softmax_ppa_bwd"] == {"launches": 1, "plain": 0}
    want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, where)
    assert float((got - want).abs().max()) <= (
        SOFTMAX_BWD_REL * float(g.abs().max()))
    if case == "all-masked row":
        assert not got[1, :, 0, 3].any()
    if case == "three-way tie":
        assert float(got[1, 2, 0, 5, :3].abs().min()) > 0.0


@pytest.mark.gpu
@pytest.mark.parametrize("n", BWD_ROW_LENGTHS)
def test_softmax_bwd_row_kernel_8bit_table(n):
    """The row kernel on the 8-bit exp2_frac table (a polynomial of order
    1, another template entry; at 4 runs a lane it loads the next row's g
    after the exponentials) under a random mask with an all-masked row and
    a three-way tie, as ``test_softmax_bwd_row_kernel``."""
    dev = _card()
    tc = K.pack_table(load_table("exp2_frac", 8), dev)
    assert tc.plan.order == 1
    x, g, where = _bwd_row_case(dev, n, "three-way tie")
    where[1, 0, 0, 3] = False
    assert softmax_ppa.bwd_route(n, True)[0] > 0
    K.reset_counts()
    got = softmax_ppa.softmax_ppa_bwd(x, g, tc, where)
    torch.cuda.synchronize()
    assert K.read_counts()["softmax_ppa_bwd"] == {"launches": 1, "plain": 0}
    want = softmax_ppa.softmax_ppa_bwd_plain(x, g, tc, where)
    assert float((got - want).abs().max()) <= (
        SOFTMAX_BWD_REL * float(g.abs().max()))
    assert not got[1, :, 0, 3].any()
