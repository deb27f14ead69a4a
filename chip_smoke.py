#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card     name and power limit (nvidia-smi) and torch's device name
2. build    the three CUDA kernels from ``src/repro_torch/kernels/csrc``
            with nvcc for sm_90a, with the ``-Xptxas -v`` resource lines
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes: ``cuda_int`` and ``cuda_fused`` must be
            exactly equal on all 12 shipped tables, the softmax within
            1e-6; then each one's time (CUDA events), its plain version's
            time, its bound and, where one PyTorch call computes the same
            function, that call's time
4. serve    full-width internlm2-1.8b (random weights from seed 0, bf16,
            act_impl="ppa"), ServeEngine(n_slots=4, cache_len=512), 8
            requests of 32-128 prompt tokens and 32 new tokens each; every
            request must finish at its length, the fused and softmax
            kernels must have launched at least layers x engine steps times
            and no plain version may have run
5. serve_int the same config cut to 2 layers with act_backend="cuda_int"
6. parity   full width, 2 layers, float32: prefill + 8 greedy decode steps
            through the kernels and through the plain versions, both on the
            card; the greedy tokens must be equal

The last two lines are a JSON object with one entry per kernel, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import traceback
from pathlib import Path

# Published H100 SXM peaks at 700 W: device memory bandwidth, and the
# float32 rate outside the tensor cores, 67 TFLOP/s with an FMA counted as
# two.  These kernels issue no FMA, so one float32 operation is one lane
# instruction: 128 float32 lanes per SM per clock give 33.5 T op/s, which
# is also the rate at which the four schedulers of an SM issue lane
# instructions of any kind.  An SM has 64 int32 lanes, half the float32
# ones: 16.75 T op/s.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12 / 2
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
ISSUE_OPS_PER_S = FP32_OPS_PER_S

SERVE_SLOTS, SERVE_CACHE_LEN, SERVE_REQUESTS, SERVE_NEW = 4, 512, 8, 32
PREFILL_ROWS = 4 * 128          # B * T at the largest prefill bucket
SOFTMAX_ATOL = 1e-6             # reference bound, tests/test_kernels.py


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def datapath_ops(num_segments: int, order: int, round_mults: bool) -> int:
    """int32 operations of select + Horner for one element: a binary search
    (compare, select, add, shift per step) and the Horner chain (multiply
    and shift per stage, two aligning shifts and an add per concat adder
    and at the intercept, the final shift, a rounder add per stage)."""
    steps = math.ceil(math.log2(num_segments + 1))
    return (4 * steps + 2 * order + 3 * (order - 1) + 4
            + (order if round_mults else 0))


# Per element, around select + Horner.  fused: int32 sign fix (2), the
# out-of-interval compare (1), clamp (2), saturation and symmetry selects
# (2); float32 widen, abs, scale, +0.5, floor, to-int, to-float, /2^w_out,
# sign compare, symmetry restore, gate product, narrow (12).  softmax:
# int32 mask test (1) and clamp (2); float32 max, -m, *log2e, clamp, floor,
# -k, scale, +0.5, floor, to-int, to-float, /2^w_out, ldexp, sum, /sum (15).
FUSED_INT_OPS, FUSED_FP_OPS = 7, 12
SOFTMAX_INT_OPS, SOFTMAX_FP_OPS = 3, 15


def bound(nbytes: float, int_ops: float, fp_ops: float = 0.0):
    """Least time (ms) for the work, and whether bytes or operations set
    it: the int32 lanes, the float32 lanes and the issue rate each bound
    the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S,
                (int_ops + fp_ops) / ISSUE_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------- phases
def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.KERNELS)} kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s ({' '.join(build.NVCC_FLAGS)})")
    for name in build.KERNELS:
        for line in build.ptxas_log(name).splitlines():
            if any(k in line for k in ("Compiling entry", "Used",
                                       "bytes stack frame", "already built")):
                log(f"[build] {name}: {line.strip()}")


def phase_kernels(torch, dev):
    """Each kernel against its plain version; returns the kernel rows."""
    from repro_torch.kernels import fused, ppa, ref, softmax_ppa
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import BITS, NAFS, load_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tcs = {(n, b): pack_table(load_table(n, b), dev)
           for n in NAFS for b in BITS}
    # exp2_frac-16's segments under a round_mults plan with down_out > 0:
    # exercises the half-ULP add and the final plain floor of the body
    e2_tab = load_table("exp2_frac", 16)
    rounding = pack_table(dataclasses.replace(e2_tab, cfg=dataclasses.replace(
        e2_tab.cfg, round_mults=True, w_out=12)), dev)

    # ---- cuda_int: whole [lo, hi) grid + out-of-interval and negatives
    for (naf, bits), tc in [*tcs.items(), (("exp2_frac-round", 12),
                                           rounding)]:
        span = tc.hi - tc.lo
        x = torch.cat([
            torch.arange(tc.lo, tc.hi, device=dev),
            torch.arange(tc.hi, tc.hi + span, device=dev),
            torch.arange(tc.lo - span, tc.lo, device=dev),
            torch.randint(-(1 << 12), 0, (4096,), generator=gen, device=dev),
        ]).to(torch.int32)
        got = ppa.ppa_eval_int(tc, x)
        want = ref.ppa_eval_ref(x, tc.starts, tc.coefs, tc.plan)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:4].flatten().tolist()
            raise AssertionError(f"cuda_int != plain for {naf}-{bits} at "
                                 f"inputs {x[bad].tolist()}")
    log(f"[kernels] cuda_int == plain (exact) on {len(tcs)} tables and a "
        "round_mults plan, whole grid + out-of-interval + negative inputs")

    # ---- cuda_fused: gated/ungated, f32/bf16, 3-sigma spread
    for (naf, bits), tc in tcs.items():
        sigma = tc.interval[1]
        for dt in (torch.float32, torch.bfloat16):
            x = (torch.randn((PREFILL_ROWS, 8192), generator=gen, device=dev)
                 * sigma).to(dt)
            for gate in (False, True):
                got = fused.ppa_fused_apply(tc, x, gate)
                want = fused.ppa_fused_plain(tc, x, gate)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    d = (got.float() - want.float()).abs()
                    raise AssertionError(
                        f"cuda_fused != plain for {naf}-{bits} {dt} "
                        f"gate={gate}: {int((d > 0).sum())} elements, "
                        f"max |diff| {float(d.max())}")
    log(f"[kernels] cuda_fused == plain (exact) on {len(tcs)} tables x "
        "{f32,bf16} x {ungated,gated}, x ~ N(0, interval end) on "
        f"({PREFILL_ROWS}, 8192)")

    # ---- softmax: prefill and decode shapes, with and without the mask
    e2 = tcs[("exp2_frac", 16)]
    sm_err = 0.0
    cases = []
    for shape in ((4, 8, 2, 128, 128), (4, 8, 2, 1, SERVE_CACHE_LEN),
                  (4, 8, 2, 1, 1024)):
        x = torch.randn(shape, generator=gen, device=dev) * 4.0
        t, s = shape[-2], shape[-1]
        qp = torch.arange(t, device=dev)[:, None] + (s - t)
        kp = torch.arange(s, device=dev)[None, :]
        if t == 1:                  # decode: the last quarter of the ring
            qp = qp - s // 4        # is still empty (position -1)
        valid = (kp <= qp)[None, None, None].expand(shape[0], 1, 1, t, s)
        valid = valid.clone()
        valid[0, 0, 0, 0, :] = False           # one all-masked row
        cases += [(x, None), (x, valid)]
    # a mask read through a column stride other than 1
    strided = cases[1][1].transpose(-1, -2)
    for x, where in cases + [(cases[0][0], strided)]:
        got = softmax_ppa.softmax_ppa(x, e2, where)
        want = softmax_ppa.softmax_ppa_plain(x, e2, where)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not err <= SOFTMAX_ATOL:
            raise AssertionError(f"softmax kernel vs plain {tuple(x.shape)} "
                                 f"mask={where is not None}: {err}")
        if (where is not None and where is not strided
                and float(got[0, 0, 0, 0].abs().max()) != 0.0):
            raise AssertionError("all-masked row is not all zero")
        sm_err = max(sm_err, err)
    log(f"[kernels] softmax kernel vs plain: max |diff| {sm_err:.3e} "
        f"<= {SOFTMAX_ATOL} on {len(cases) + 1} cases (prefill/decode "
        "shapes, with/without mask, all-masked row, strided mask)")

    # ---- timings at main-path shapes
    rows = []
    sig = tcs[("sigmoid_wide", 16)]
    plan = sig.plan
    n = PREFILL_ROWS * 8192

    xq = torch.randint(sig.lo, sig.hi, (PREFILL_ROWS, 8192), generator=gen,
                       device=dev, dtype=torch.int32)
    ms = time_ms(lambda: ppa.ppa_eval_int(sig, xq))
    plain = time_ms(lambda: ref.ppa_eval_ref(xq, sig.starts, sig.coefs,
                                             plan), iters=10)
    lib = time_ms(lambda: sig.val_lut[(xq - sig.lo).long()], iters=20)
    table_bytes = sig.starts.numel() * 4 + sig.coefs.numel() * 4
    dp_ops = datapath_ops(sig.num_segments, plan.order, plan.round_mults)
    b_ms, b_by = bound(n * 8 + table_bytes, n * dp_ops)
    rows.append(dict(
        name="ppa_int", route="cuda",
        source="src/repro_torch/kernels/csrc/ppa_int.cu",
        replaces="src/repro/kernels/ppa.py:77", max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=[PREFILL_ROWS, 8192], table="sigmoid_wide-16"))

    xb = (torch.randn((PREFILL_ROWS, 8192), generator=gen, device=dev)
          * 3.0).to(torch.bfloat16)
    ms = time_ms(lambda: fused.ppa_fused_apply(sig, xb, True))
    plain = time_ms(lambda: fused.ppa_fused_plain(sig, xb, True), iters=10)
    ctx = time_ms(lambda: torch.nn.functional.silu(xb))
    b_ms, b_by = bound(n * 4 + table_bytes, n * (dp_ops + FUSED_INT_OPS),
                       n * FUSED_FP_OPS)
    rows.append(dict(
        name="ppa_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/ppa_fused.cu",
        replaces="src/repro/kernels/fused.py:40", max_abs_err=0.0, ms=ms,
        plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=[PREFILL_ROWS, 8192], dtype="bfloat16", gate=True,
        table="sigmoid_wide-16", context_silu_ms=ctx))

    x, where = cases[1]                       # prefill shape, masked
    mask = where.expand(x.shape)
    ms = time_ms(lambda: softmax_ppa.softmax_ppa(x, e2, where))
    plain = time_ms(lambda: softmax_ppa.softmax_ppa_plain(x, e2, where),
                    iters=10)
    ctx = time_ms(lambda: torch.softmax(
        x.masked_fill(~mask, float("-inf")), dim=-1))
    m = x.numel()                 # scores in and out, the unexpanded mask
    b_ms, b_by = bound(
        m * 8 + where.numel() + e2.starts.numel() * 4 + e2.coefs.numel() * 4,
        m * (datapath_ops(e2.num_segments, e2.plan.order,
                          e2.plan.round_mults) + SOFTMAX_INT_OPS),
        m * SOFTMAX_FP_OPS)
    rows.append(dict(
        name="softmax_ppa", route="cuda",
        source="src/repro_torch/kernels/csrc/softmax_ppa.cu",
        replaces="src/repro/kernels/softmax_ppa.py:44", max_abs_err=sm_err,
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None, shape=list(x.shape), masked=True,
        context_masked_softmax_ms=ctx))
    for r in rows:
        log(f"[kernels] {r['name']}: {r['ms']:.4f} ms (plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}, library "
            f"{'none' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}"
            f") at {r['shape']}")
    log(f"[kernels] context, not the same function: F.silu "
        f"{rows[1]['context_silu_ms']:.4f} ms, masked torch.softmax "
        f"{rows[2]['context_masked_softmax_ms']:.4f} ms")
    return rows


def _cut(cfg, layers: int):
    return cfg.replace(stages=tuple(
        dataclasses.replace(st, n_layers=layers) for st in cfg.stages))


def _serve(torch, dev, cfg, n_requests, max_new, lens):
    """Serve ``n_requests``; returns (engine, requests, step times)."""
    import numpy as np
    from repro_torch.kernels import reset_counts
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import Request, ServeEngine

    params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                         device=dev)
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      cache_len=SERVE_CACHE_LEN, device=dev)
    del params
    eng.warmup(sorted(set(lens)))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, lens[i]
                                               ).astype(np.int32),
                    max_new_tokens=max_new) for i in range(n_requests)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    for r in reqs:
        eng.submit(r)
    steps = []                       # (seconds, admitted requests)
    t0 = time.perf_counter()
    while eng.queue or any(r is not None for r in eng.slot_req):
        q0 = len(eng.queue)
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - ts, q0 - len(eng.queue)))
        if len(steps) > 10_000:
            raise RuntimeError("engine did not drain")
    wall = time.perf_counter() - t0
    for r in reqs:
        if not (r.done and len(r.output) == max_new
                and all(0 <= t < cfg.vocab for t in r.output)):
            raise AssertionError(f"request {r.rid}: done={r.done}, "
                                 f"{len(r.output)} tokens")
    return eng, reqs, steps, wall


def phase_serve(torch, dev, card):
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts

    cfg = get_config("internlm2-1.8b").replace(
        act_impl="ppa", compute_dtype="bfloat16")
    lens = [32, 128, 64, 96, 48, 128, 80, 112][:SERVE_REQUESTS]
    eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                    SERVE_NEW, lens)
    counts = read_counts()
    n_steps = len(steps)
    need = cfg.n_layers * n_steps
    for k in ("ppa_fused", "softmax_ppa"):
        if counts[k]["launches"] < need:
            raise AssertionError(f"{k} launched {counts[k]['launches']} "
                                 f"times < layers x steps = {need}")
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the main path: {plain}")
    decode = sorted(t for t, adm in steps if adm == 0)
    dec_ms = decode[len(decode) // 2] * 1e3
    adm_ms = [t * 1e3 - dec_ms for t, adm in steps if adm > 0]
    tokens = sum(len(r.output) for r in reqs)
    mem = torch.cuda.max_memory_allocated(dev)
    log(f"[serve] internlm2-1.8b 24L d_model 2048 bf16 act_impl=ppa "
        f"act_backend={eng.cfg.act_backend}: {len(reqs)} requests, {tokens}"
        f" tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s over "
        f"{n_steps} engine steps; decode {dec_ms:.2f} ms/step (median); "
        f"prefill {sum(adm_ms):.2f} ms in {len(adm_ms)} admission steps "
        f"(step time minus median decode); max_memory_allocated "
        f"{mem / 2**30:.2f} GiB; prefill shapes {sorted(eng.prefill_shapes)}"
        f"; card {card}")
    log(f"[serve] launches fused={counts['ppa_fused']['launches']} softmax="
        f"{counts['softmax_ppa']['launches']} (layers x steps = {need}); "
        f"plain calls {plain}")
    return {"ppa_fused": counts["ppa_fused"]["launches"],
            "softmax_ppa": counts["softmax_ppa"]["launches"]}


def phase_serve_int(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts

    cfg = _cut(get_config("internlm2-1.8b"), 2).replace(
        act_impl="ppa", compute_dtype="bfloat16", act_backend="cuda_int")
    eng, reqs, steps, wall = _serve(torch, dev, cfg, 4, 8,
                                    [32, 64, 48, 128])
    counts = read_counts()
    if counts["ppa_int"]["launches"] <= 0:
        raise AssertionError("cuda_int serve launched no integer kernel")
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the int path: {plain}")
    log(f"[serve_int] internlm2-1.8b 2L act_backend=cuda_int: {len(reqs)} "
        f"requests in {len(steps)} steps, {wall:.3f}s; launches "
        f"int={counts['ppa_int']['launches']} softmax="
        f"{counts['softmax_ppa']['launches']}")
    return counts["ppa_int"]["launches"]


def phase_parity(torch, dev):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import (decode_step, init_params, make_acts,
                                    param_specs, prefill, prepare_params)

    cfg = _cut(get_config("internlm2-1.8b"), 2).replace(
        act_impl="ppa", compute_dtype="float32")
    params = prepare_params(
        init_params(param_specs(cfg), 0, device=dev), cfg)
    rng = np.random.default_rng(1)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                             dtype=torch.int32, device=dev)
    runs = {}
    with torch.inference_mode():
        for name in ("cuda_fused", "ref"):
            acts = make_acts("ppa", name, dev)
            logits, cache = prefill(params, cfg, {"tokens": prompt}, 128,
                                    acts)
            toks, all_logits = [], [logits]
            pos = torch.full((4,), 64, dtype=torch.int32, device=dev)
            tok = torch.argmax(logits, -1)
            for _ in range(8):
                toks.append(tok)
                logits, cache = decode_step(params, cfg, cache,
                                          tok[:, None].to(torch.int32), pos,
                                          acts)
                all_logits.append(logits)
                tok = torch.argmax(logits, -1)
                pos = pos + 1
            toks.append(tok)
            runs[name] = (torch.stack(toks), torch.stack(all_logits))
    tk, lk = runs["cuda_fused"]
    tp, lp = runs["ref"]
    gap = float((lk - lp).abs().max())
    if not torch.equal(tk, tp):
        raise AssertionError(f"greedy tokens differ between kernel and "
                             f"plain paths (max logit gap {gap})")
    log(f"[parity] internlm2-1.8b 2L float32: prefill + 8 greedy decode "
        f"steps, kernel path == plain path tokens; max |logit gap| {gap:.3e}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    failed = []
    rows = []
    launches = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        try:
            out = fn(*args)
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s")
            return out
        except Exception:
            traceback.print_exc()
            log(f"[{name}] FAILED")
            failed.append(name)
            return None

    run("build", phase_build)
    if not failed:
        rows = run("kernels", phase_kernels, torch, dev) or []
        launches.update(run("serve", phase_serve, torch, dev, card) or {})
        launches["ppa_int"] = run("serve_int", phase_serve_int, torch, dev)
        run("parity", phase_parity, torch, dev)
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    for r in rows:
        r["launches"] = launches[r["name"]]
        r["path"] = ("serve internlm2-1.8b 2L cuda_int"
                     if r["name"] == "ppa_int"
                     else "serve internlm2-1.8b 24L cuda_fused")
    log(card_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
