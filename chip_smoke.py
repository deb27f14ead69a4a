#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. card     name and power limit (nvidia-smi) and torch's device name
2. build    the CUDA kernels from ``src/repro_torch/kernels/csrc`` (three
            sources: the softmax's holds its backward too) with nvcc for
            sm_90a; every entry of every kernel must report a 0-byte
            stack frame and no spills in its ``-Xptxas -v`` lines
3. kernels  each kernel against its plain PyTorch version on the card at
            the main path's shapes, decode and prefill: ``cuda_int`` and
            ``cuda_fused`` must be exactly equal on all 12 shipped tables
            (``cuda_int`` also at the int32 extremes, on an unaligned view
            and at a length that is not a multiple of 4), the softmax
            within 1e-6, also on rows of 1 to 4096 scores;
            then each one's device time per launch at each shape (a CUDA
            graph of back-to-back launches, timed with CUDA events), the
            host's time per call, its plain version's time, its bound and,
            where one PyTorch call computes the same function, that
            call's time
4. serve    full-width internlm2-1.8b (random weights from seed 0, bf16,
            act_impl="ppa"), ServeEngine(n_slots=4, cache_len=512), 8
            requests of 32-128 prompt tokens and 32 new tokens each; every
            request must finish at its length, the fused and softmax
            kernels must have launched at least layers x engine steps times
            and no plain version may have run; the launches are counted by
            input shape (decode and prefill)
5. serve_int the same config cut to 2 layers with act_backend="cuda_int";
            the integer kernel must have launched at least layers x engine
            steps times and no plain version may have run
6. parity   full width, 2 layers, float32: prefill + 8 greedy decode steps
            through three arms on the card: the plain versions ("ref"),
            the integer kernel with the softmax kernel ("cuda_int") and
            the fused kernel with the softmax kernel ("cuda_fused"); the
            greedy tokens must be equal and each pair's logit gap within
            the limit that ``phase_parity`` states, and the ref arm with
            its softmax moved beyond SOFTMAX_ATOL (``PARITY_CONTROLS``)
            must exceed that limit
7. train    full-width internlm2-1.8b (24 layers, float32 master weights
            from seed 0, bf16 compute, act_impl="ppa", cuda_fused,
            remat "dots"), adamw, batch 4 x seq 512 of the synthetic
            stream, 8 steps through ``launch/train.py::run_training``:
            every loss and gradient norm finite, no plain version run,
            and per step at least layers x (1 + recomputes) launches of
            the fused and softmax kernels and layers launches of the
            softmax backward kernel; step ms, tokens/s and peak memory
8. train_parity  full width, 2 layers, float32: one train step's loss and
            gradients through ref, cuda_int and cuda_fused on the same
            params and batch; cuda_int and cuda_fused must be equal, and
            each against ref within the limit ``phase_train_parity``
            states, which the ref arm with its softmax moved beyond
            SOFTMAX_ATOL must exceed
9. train_resume  ``launch/train.py`` on the smoke config with PPA
            activations, 30 steps of batch 4 x seq 64 (the README's
            recipe): the loss descends, and a run that crashes after step
            3 and resumes from its checkpoint gives the losses of a run
            without the crash
10. serve_moe  full-width moonshot-v1-16b-a3b (all 48 layers: 1 dense,
            47 MoE of 64 experts, top 6, 2 shared; random bf16 weights
            from seed 0, 52.9 GiB), act_impl="ppa", cuda_fused, the serve
            phase's engine and traffic: every request finishes at its
            length, the fused and softmax kernels launch at least layers x
            engine steps times and at each decode launch of every layer at
            every decode step (``decode_launches``: the expert buffer, the
            shared experts' and the dense layer's gates, the scores), no
            plain version runs; launches by shape, decode ms per step,
            tokens/s, peak memory
11. parity_moe  moonshot at full width, 2 layers (the dense one and one
            MoE), float32: the parity phase's three arms and controls; the
            routed expert ids of every layer and call equal in all arms
12. flash   internlm2-1.8b at full width, 2 layers, bf16, one prompt of
            16384 tokens, attn_impl="flash" with chunks of 1024: the
            cuda_fused arm's final hidden states and logits equal the ref
            arm's, the fused kernel launched at the chunk shape, no plain
            version in the kernel arm
13. serve_hybrid  full-width hymba-1.5b (32 layers in 5 stages: attention
            and a selective SSM in parallel, global attention at layers 0,
            15 and 31, windows of 1024 elsewhere; random bf16 weights from
            seed 0), act_impl="ppa", cuda_fused, the serve phase's engine
            and traffic: every request finishes at its length, prompts
            prefill at their exact lengths (no padding), the fused and
            softmax kernels launch at least layers x engine steps times
            and at each decode launch of every layer at every decode step
            (``decode_launches``), no plain version runs
14. parity_hybrid  hymba at full width, its first two stages (global
            and windowed attention) at 1 layer each, float32: the parity
            phase's three arms and controls (HYBRID_PARITY_STAGES)
15. serve_rwkv  full-width rwkv6-3b (32 layers, 40 heads of 64,
            attention-free) as serve_hybrid; the softmax never launches
16. parity_rwkv  rwkv at full width, 2 layers, float32: no softmax, so
            the three arms must be equal bit for bit
17. serve_whisper  full-width whisper-medium (a 24-layer encoder on 1500
            frames and 24 ``xdec`` layers: self-attention, cross attention
            to the encoder's output, a plain MLP with gelu; layernorm; random
            bf16 weights from seed 0), act_impl="ppa", cuda_fused, the serve
            phase's engine and traffic, each request with its own frame
            embeddings ``enc_feats`` N(0, 0.1) of (1500, 1024) from the
            seeded generator: as serve_hybrid, with the softmax at every
            self- and cross-attention launch of every decode step
18. parity_whisper  whisper at full width, 1 encoder and 1 decoder layer,
            float32, a float32 decode cache (WHISPER_PARITY_LAYERS): the
            parity phase's three arms and controls, the gelu table's
            inputs counted as the silu's are
19. serve_vlm  full-width internvl2-26b (48 ``dec`` layers of d_model 6144
            after 256 vision tokens, 36.99 GiB of bf16 weights), each
            request with its own patch embeddings ``vision_embeds`` N(0,
            0.02) of (256, 6144): as serve_whisper
20. parity_vlm  internvl at full width, 2 layers, float32, the vision
            prefix before each prompt: the parity phase's arms and controls
21. compile the FQA compiler on the card: the six 16-bit deployment tables
            (``ppa_table_jobs("ppa")``) compiled by ``TorchSearchBackend``
            through ``compile_or_load`` into a fresh store, each equal to
            the shipped JSON; then each compiled again by the port's numpy
            backend on the host (one spawned process a table), equal by
            ``table_identity`` with the same candidate evaluations; per
            table both wall times, candidate evaluations a second and the
            card's dispatches (one host sync each)
22. workflow  the paper's hardware-constrained flow (Fig. 7): sigmoid at
            SEG_t 16, order 1 and 2 (8-bit FWLs), on the card's backend
            through one CompilerSession; the winner resolved through a
            store twice, the second a disk hit with no session call, then
            packed on the card and run through ``ppa_apply``/``ppa_gate``
            on ``cuda_fused`` and ``cuda_int``, each equal to the plain
            version bit for bit
23. serve_store  the serve phase with ``make_acts(store=<the compile
            phase's store>)``: the packed constants equal the shipped
            tables', the greedy tokens the serve phase's, and the serve
            phase's launch gates hold; a stand-in
            until the engine takes ``table_store=``

The kernels phase also holds the softmax backward kernel to its plain
version (SOFTMAX_BWD_REL) at the training and decode shapes and on rows of
1 to 4096 scores, and times it.  After each of serve, serve_int, train,
serve_moe, flash, serve_hybrid, serve_rwkv, serve_whisper and serve_vlm,
every input shape at which
that run launched the integer, fused or softmax kernel (the fused kernel's
by dtype, table and gate too: ``launched_shapes``) is held to the plain
version and timed beside its bound (``path_rows``), and its row in the
kernels line carries those launches.  The last two lines are a JSON object with one entry per kernel, then ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import json
import re
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
PREFILL_ROWS = 4 * 128          # B * T of a full prefill group
SOFTMAX_ATOL = 1e-6             # reference bound, tests/test_kernels.py
# The softmax backward against its plain version, per case, as a fraction
# of the largest incoming gradient: the two sum c = sum g y and sum d in
# other orders and divide another way (row_divide), as the forward; for
# |g| <= 1 this is the forward's 1e-6.
SOFTMAX_BWD_REL = 1e-6
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 8
# The parity gate: the largest logit gap between the plain arm and a
# kernel arm, as a fraction of the largest logit (phase_parity).
PARITY_LIMIT = 2.0 ** -8
# The kernels' standing shapes, timed in every run so that runs compare:
# the SwiGLU gate input (B, T, 8192), bf16 into the fused kernel or
# quantized to int32 into the integer kernel, and the attention scores
# (B, Hk, G, T, S) float32, at decode (B = slots, T = 1, S = cache), which
# the serve phase launches, and at a full prefill group of 4 x 128 tokens,
# which its traffic does not form (its groups hold at most 3 x 128; those
# are ``path_rows``).
FUSED_SHAPES = {"decode": (SERVE_SLOTS, 1, 8192),
                "prefill": (PREFILL_ROWS, 8192)}
INT_SHAPES = FUSED_SHAPES
SOFTMAX_SHAPES = {"decode": (SERVE_SLOTS, 8, 2, 1, SERVE_CACHE_LEN),
                  "prefill": (4, 8, 2, 128, 128)}
# The softmax backward at the train phase's scores, (B, Hk, G, T, T), and
# at a decode-like row of the cache.
SOFTMAX_BWD_SHAPES = {"train": (TRAIN_BATCH, 8, 2, TRAIN_SEQ, TRAIN_SEQ),
                      "decode": SOFTMAX_SHAPES["decode"]}
MOE_ARCH = "moonshot-v1-16b-a3b"
HYBRID_ARCH, RWKV_ARCH = "hymba-1.5b", "rwkv6-3b"
WHISPER_ARCH, VLM_ARCH = "whisper-medium", "internvl2-26b"
# whisper's parity keeps one encoder and one decoder layer, its decode
# cache in float32.  At the random init its attention is nearly hard
# (scores of std about 64) over 1500 frames, and two layers each move the
# logits beyond the parity limit from a softmax inside the kernel's bound:
# +-1e-7 moved the prefill logits by 0.017 against a limit of 0.0125, and
# over the decode steps +-1e-6 by 4.35 of 3.46.  At one layer each a bf16
# cache still does: the cross K/V of 1500 frames rounds one bf16 step
# apart where the encoder's outputs differ in the last float32 place, and
# the +-1e-6 control moved the logits by 2.1e-2, the kernels' summation
# order by 2.0e-2, against 1.2e-2 (scripts/torch_whisper_parity_probe.py
# on an NVIDIA H100 80GB HBM3 at 700.00 W).
WHISPER_PARITY_LAYERS, WHISPER_PARITY_CACHE = 1, "float32"
# the PPA table of each MLP gate
GATE_TABLES = {"silu": "sigmoid_wide", "gelu": "gelu_inner"}
# hymba's parity keeps its first two stages (a global and a windowed one)
# at one layer each.  Deeper, the model moves a logit by more than the
# parity limit from a softmax move within the kernel's bound: at all five
# stages the +-1e-6 control moved the logits by 5.1 of 4.0 and the
# kernels' summation order by 0.18, against a limit of 0.016; at one stage
# no control exceeds the limit (scripts/torch_hybrid_parity_depth.py).
HYBRID_PARITY_STAGES = 2
# Flash attention's exponentials, float32 into the fused kernel without
# the gate on the exp_neg table: a chunk's scores (B, Hk, G, T, chunk) and
# the running-max rescale (B, Hk, G, T), internlm2 at one 16k prompt.
FLASH_T, FLASH_CHUNK = 16384, 1024
FLASH_FUSED_SHAPES = {"flash_chunk": (1, 8, 2, FLASH_T, FLASH_CHUNK),
                      "flash_rescale": (1, 8, 2, FLASH_T)}
# Row lengths the softmax is held to its plain version at: both layouts of
# the warp-per-row path and the block-per-row path beyond 2048; 1500 is
# whisper's encoder and cross attention (vec 4 x 16 items a lane aligned,
# 64 scalar items not: the forward's register limit).
SOFTMAX_ROW_LENGTHS = (1, 31, 33, 512, 1024, 1500, 2048, 4096)
INT32_EXTREMES = (-(1 << 31), -(1 << 31) + 1, (1 << 31) - 1)


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


def time_launch(fn, iters: int = 50, warmup: int = 5, replays: int = 4):
    """(device ms per call, host us per call) of a kernel wrapper.  The
    device time replays ``iters`` back-to-back calls captured in one CUDA
    graph, so it leaves out the host's launch cost; the host time is that
    of eager calls without a synchronise, the least of 5 batches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    batch = max(iters // 5, 1)
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        host.append((time.perf_counter() - t0) / batch)
        torch.cuda.synchronize()
    host_us = min(host) * 1e6
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays), host_us


def datapath_ops(order: int, round_mults: bool) -> int:
    """int32 operations of select + Horner for one element: the least any
    select needs (one index computation and one load), then the Horner
    chain (multiply and shift per stage, two aligning shifts and an add per
    concat adder and at the intercept, the final shift, a rounder add per
    stage).  The segment count and the select algorithm do not enter: a
    shorter search must not lower its own bound."""
    return (2 + 2 * order + 3 * (order - 1) + 4
            + (order if round_mults else 0))


# Per element, around select + Horner.  fused: int32 sign fix (2), the
# out-of-interval compare (1), clamp (2), saturation and symmetry selects
# (2); float32 widen, abs, scale, +0.5, floor, to-int, to-float, /2^w_out,
# sign compare, symmetry restore, gate product, narrow (12).  softmax:
# int32 mask test (1) and clamp (2); float32 max, -m, *log2e, clamp, floor,
# -k, scale, +0.5, floor, to-int, to-float, /2^w_out, ldexp, sum, /sum (15).
FUSED_INT_OPS, FUSED_FP_OPS = 7, 12
SOFTMAX_INT_OPS, SOFTMAX_FP_OPS = 3, 15
# The softmax backward does the forward's work, then per score: g y, its
# sum, the live test, g - c, / D, exp2, the product, the sum of d, the tie
# test and the share's subtraction (10 float32).
SOFTMAX_BWD_FP_OPS = SOFTMAX_FP_OPS + 10


def bound(nbytes: float, int_ops: float, fp_ops: float = 0.0):
    """Least time (ms) for the work, and whether bytes or operations set
    it: the int32 lanes, the float32 lanes and the issue rate each bound
    the operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(int_ops / INT32_OPS_PER_S, fp_ops / FP32_OPS_PER_S,
                (int_ops + fp_ops) / ISSUE_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def table_bytes(num_segments: int, order: int) -> int:
    """The table's starts and coefficient rows, int32."""
    return 4 * num_segments * (order + 2)


def int_bound(n: int, num_segments: int, order: int, round_mults: bool):
    """ppa_int on n int32 elements: 4 B in and 4 B out each."""
    return bound(8 * n + table_bytes(num_segments, order),
                 n * datapath_ops(order, round_mults))


def fused_bound(n: int, itemsize: int, num_segments: int, order: int,
                round_mults: bool, gate: bool = True):
    """ppa_fused on n elements of ``itemsize`` bytes, read and written.
    Without the gate there is no gate product, and a float32 input needs
    no widening or narrowing: 12, 11, 10 or 9 float32 operations."""
    fp_ops = FUSED_FP_OPS - (not gate) - 2 * (itemsize == 4)
    return bound(2 * itemsize * n + table_bytes(num_segments, order),
                 n * (datapath_ops(order, round_mults) + FUSED_INT_OPS),
                 n * fp_ops)


def softmax_bound(n: int, mask_bytes: int, num_segments: int, order: int,
                  round_mults: bool):
    """softmax_ppa on n float32 scores, read and written, and the mask at
    its unexpanded size."""
    return bound(8 * n + mask_bytes + table_bytes(num_segments, order),
                 n * (datapath_ops(order, round_mults) + SOFTMAX_INT_OPS),
                 n * SOFTMAX_FP_OPS)


def softmax_bwd_bound(n: int, mask_bytes: int, num_segments: int,
                      order: int, round_mults: bool):
    """The softmax backward on n float32 scores: x and g read and dx
    written, the mask at its unexpanded size."""
    return bound(12 * n + mask_bytes + table_bytes(num_segments, order),
                 n * (datapath_ops(order, round_mults) + SOFTMAX_INT_OPS),
                 n * SOFTMAX_BWD_FP_OPS)


# ---------------------------------------------------------------- phases
def ptxas_entries(text: str):
    """{entry: {"stack", "spill_stores", "spill_loads", "registers"}} for
    every kernel entry in the output of ``nvcc -Xptxas -v``."""
    entries, props, cur = [], {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entries.append(m.group(1))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            props.setdefault(cur, {}).update(
                stack=int(m[1]), spill_stores=int(m[2]),
                spill_loads=int(m[3]))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            props.setdefault(cur, {})["registers"] = int(m[1])
    return {e: props.get(e, {}) for e in entries}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    log(f"[build] {len(build.KERNELS)} kernels built and loaded in "
        f"{time.perf_counter() - t0:.1f}s ({' '.join(build.NVCC_FLAGS)})")
    bad = []
    for name in build.KERNELS:
        text = build.ptxas_log(name)
        if "already built" in text:
            log(f"[build] {name}: built before this run, so no ptxas report "
                "to check (a fresh checkout builds and checks it)")
            continue
        entries = ptxas_entries(text)
        if not entries:
            raise AssertionError(f"{name}: no kernel entry in the ptxas "
                                 f"report:\n{text}")
        for entry, pr in entries.items():
            if (pr.get("stack", -1) != 0 or pr.get("spill_stores", -1) != 0
                    or pr.get("spill_loads", -1) != 0):
                bad.append((name, entry, pr))
        regs = [pr.get("registers", 0) for pr in entries.values()]
        log(f"[build] {name}: {len(entries)} entries, stack frame max "
            f"{max(pr.get('stack', -1) for pr in entries.values())} bytes, "
            f"spill stores max "
            f"{max(pr.get('spill_stores', -1) for pr in entries.values())} "
            f"bytes, spill loads max "
            f"{max(pr.get('spill_loads', -1) for pr in entries.values())} "
            f"bytes, registers {min(regs)}-{max(regs)}")
    if bad:
        raise AssertionError(f"entries with a stack frame or spills: {bad}")


def _check_int(torch, gen, dev, ppa, ref, tcs):
    """cuda_int == plain, bit for bit, on every table: the whole [lo, hi)
    grid, a span beyond each end, random negatives and the int32 extremes
    (out-of-interval inputs wrap as the int32 tensors do), as one aligned
    input, an unaligned view of it (no 16-byte vectors) and a prefix whose
    length is 3 past a multiple of 4 (a scalar tail after the vectors)."""
    checks = 0
    for (naf, bits), tc in tcs.items():
        span = tc.hi - tc.lo
        x = torch.cat([
            torch.arange(tc.lo, tc.hi, device=dev),
            torch.arange(tc.hi, tc.hi + span, device=dev),
            torch.arange(tc.lo - span, tc.lo, device=dev),
            torch.randint(-(1 << 12), 0, (4096,), generator=gen, device=dev),
            torch.tensor(INT32_EXTREMES, device=dev),
        ]).to(torch.int32)
        n3 = (x.numel() - 1) // 4 * 4 - 1
        for label, xi in (("aligned", x), ("unaligned", x[1:]),
                          (f"length {n3}", x[:n3])):
            got = ppa.ppa_eval_int(tc, xi)
            want = ref.ppa_eval_ref(xi, tc.starts, tc.coefs, tc.plan)
            torch.cuda.synchronize()
            checks += 1
            if not torch.equal(got, want):
                bad = (got != want).nonzero()[:4].flatten().tolist()
                raise AssertionError(
                    f"cuda_int != plain for {naf}-{bits} {label} at inputs "
                    f"{xi[bad].tolist()}")
    log(f"[kernels] cuda_int == plain (exact) on {len(tcs)} tables "
        "(a round_mults plan among them): whole grid, out-of-interval, "
        f"negative and int32 extreme inputs {INT32_EXTREMES}, aligned, "
        f"unaligned and with a scalar tail: {checks} checks")


def _check_fused(torch, gen, dev, fused, tcs):
    """cuda_fused == plain, bit for bit, on every table x dtype x gate at
    the decode and prefill shapes, a size that is not a multiple of 8 and
    an input that is not 16-byte aligned."""
    checks = 0
    for (naf, bits), tc in tcs.items():
        sigma = tc.interval[1]
        for dt in (torch.float32, torch.bfloat16):
            def randn(*shape):
                return (torch.randn(shape, generator=gen, device=dev)
                        * sigma).to(dt)
            inputs = {name: randn(*shape)
                      for name, shape in FUSED_SHAPES.items()}
            inputs["(3, 1001)"] = randn(3, 1001)
            inputs["unaligned (8191,)"] = randn(8192)[1:]
            for label, x in inputs.items():
                for gate in (False, True):
                    got = fused.ppa_fused_apply(tc, x, gate)
                    want = fused.ppa_fused_plain(tc, x, gate)
                    torch.cuda.synchronize()
                    checks += 1
                    if not torch.equal(got, want):
                        d = (got.float() - want.float()).abs()
                        raise AssertionError(
                            f"cuda_fused != plain for {naf}-{bits} {dt} "
                            f"{label} gate={gate}: {int((d > 0).sum())} "
                            f"elements, max |diff| {float(d.max())}")
    log(f"[kernels] cuda_fused == plain (exact) on {len(tcs)} tables x "
        "{f32,bf16} x {ungated,gated} at decode "
        f"{FUSED_SHAPES['decode']}, prefill {FUSED_SHAPES['prefill']}, "
        f"(3, 1001) and an unaligned (8191,): {checks} checks, "
        "x ~ N(0, interval end)")


def attention_mask(torch, dev, shape):
    """The (B, 1, 1, T, S) validity mask of attention at ``shape``: causal,
    the last quarter of the ring still empty at decode, and one row all
    masked."""
    b, t, s = shape[0], shape[-2], shape[-1]
    qp = torch.arange(t, device=dev)[:, None] + (s - t)
    kp = torch.arange(s, device=dev)[None, :]
    if t == 1:
        qp = qp - s // 4
    valid = (kp <= qp)[None, None, None].expand(b, 1, 1, t, s).clone()
    valid[0, 0, 0, 0, :] = False
    return valid


def _check_softmax(torch, gen, dev, softmax_ppa, e2):
    """The softmax kernel within SOFTMAX_ATOL of the plain version, masked
    and not, at the main path's shapes and row lengths; an all-masked row
    exactly 0.  Returns the largest difference."""
    cases = []                  # (label, x, where, all-masked row or None)
    for name, shape in SOFTMAX_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev) * 4.0
        valid = attention_mask(torch, dev, shape)
        cases += [(name, x, None, None),
                  (f"{name} masked", x, valid, (0, 0, 0, 0))]
    x, valid = cases[3][1], cases[3][2]
    cases.append(("prefill, column stride 128", x,
                  valid.transpose(-1, -2), None))
    for n in SOFTMAX_ROW_LENGTHS:
        x = torch.randn((16, n), generator=gen, device=dev) * 4.0
        where = torch.rand((16, n), generator=gen, device=dev) < 0.7
        where[3] = False
        cases += [(f"rows of {n}", x, None, None),
                  (f"rows of {n} masked", x, where, (3,))]
    for n in (512, 1500):
        x = torch.randn(16 * n + 1, generator=gen, device=dev)[1:]
        where = torch.rand((16, n), generator=gen, device=dev) < 0.7
        where[3] = False
        cases += [(f"rows of {n}, unaligned", x.view(16, n), None, None),
                  (f"rows of {n}, unaligned, masked", x.view(16, n), where,
                   (3,))]
    err = 0.0
    for label, x, where, dead in cases:
        got = softmax_ppa.softmax_ppa(x, e2, where)
        want = softmax_ppa.softmax_ppa_plain(x, e2, where)
        torch.cuda.synchronize()
        d = float((got - want).abs().max())
        if not d <= SOFTMAX_ATOL:
            raise AssertionError(f"softmax kernel vs plain, {label} "
                                 f"{tuple(x.shape)}: {d}")
        if dead is not None and float(got[dead].abs().max()) != 0.0:
            raise AssertionError(f"{label}: all-masked row is not all zero")
        err = max(err, d)
    log(f"[kernels] softmax kernel vs plain: max |diff| {err:.3e} <= "
        f"{SOFTMAX_ATOL} on {len(cases)} cases (decode {SOFTMAX_SHAPES['decode']}"
        f" and prefill {SOFTMAX_SHAPES['prefill']}, with and without the "
        f"attention mask, a column-strided mask, rows of "
        f"{', '.join(map(str, SOFTMAX_ROW_LENGTHS))} masked and not, "
        "unaligned rows of 512 and 1500 masked and not); all-masked rows "
        "exactly 0")
    return err


def _table_args(tc):
    return tc.num_segments, tc.plan.order, tc.plan.round_mults


def int_row(torch, gen, dev, ppa, sig, shape, plain: bool = True):
    """The integer kernel on int32 inputs in [lo, hi) of table ``sig`` at
    ``shape``: held to its plain version bit for bit, then timed
    (``time_launch``) beside its bound; with ``plain``, also the plain
    version and the PyTorch call that computes the same function, a gather
    of the tabulated outputs.  Returns (row, input)."""
    from repro_torch.kernels.ref import ppa_eval_ref

    def eval_plain(xq):
        return ppa_eval_ref(xq, sig.starts, sig.coefs, sig.plan)

    xq = torch.randint(sig.lo, sig.hi, shape, generator=gen, device=dev,
                       dtype=torch.int32)
    if not torch.equal(ppa.ppa_eval_int(sig, xq), eval_plain(xq)):
        raise AssertionError(f"ppa_int != plain at {shape}")
    ms, host = time_launch(lambda: ppa.ppa_eval_int(sig, xq))
    b_ms, b_by = int_bound(xq.numel(), *_table_args(sig))
    row = dict(shape=list(shape), ms=ms, host_us=host, bound_ms=b_ms,
               bound_by=b_by)
    if plain:
        row["plain_ms"] = time_ms(lambda: eval_plain(xq), iters=10)
        row["library_ms"], _ = time_launch(
            lambda: sig.val_lut[(xq - sig.lo).long()])
    return row, xq


def fused_row(torch, fused, tc, x, gate: bool, plain: bool = True):
    """The fused kernel on ``x`` through table ``tc``: held to its plain
    version bit for bit, then timed beside its bound; with ``plain``, also
    the plain version and, gated, torch's silu or tanh-approximated gelu
    (context: not the same function)."""
    got = fused.ppa_fused_apply(tc, x, gate)
    if not torch.equal(got, fused.ppa_fused_plain(tc, x, gate)):
        raise AssertionError(f"ppa_fused != plain at {tuple(x.shape)} "
                             f"{x.dtype} {tc.naf} gate={gate}")
    del got
    iters = 10 if x.numel() > 1 << 26 else 50
    ms, host = time_launch(lambda: fused.ppa_fused_apply(tc, x, gate),
                           iters=iters)
    b_ms, b_by = fused_bound(x.numel(), x.element_size(), *_table_args(tc),
                             gate=gate)
    row = dict(shape=list(x.shape), ms=ms, host_us=host, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, table=f"{tc.naf}-16",
               dtype=str(x.dtype).replace("torch.", ""), gate=gate)
    if plain:
        row["plain_ms"] = time_ms(
            lambda: fused.ppa_fused_plain(tc, x, gate),
            iters=3 if iters == 10 else 10)
        if gate:
            act = (functools.partial(torch.nn.functional.gelu,
                                     approximate="tanh")
                   if tc.naf == "gelu_inner" else torch.nn.functional.silu)
            row["context_gate_ms"], _ = time_launch(lambda: act(x),
                                                    iters=iters)
    return row


def softmax_row(torch, gen, dev, softmax_ppa, e2, shape, plain: bool = True):
    """The softmax kernel on scores of ``shape`` under the attention mask:
    held to its plain version within SOFTMAX_ATOL, then timed beside its
    bound; with ``plain``, also the plain version and torch's masked
    softmax (context: not the same function)."""
    x = torch.randn(shape, generator=gen, device=dev) * 4.0
    where = attention_mask(torch, dev, shape)
    err = float((softmax_ppa.softmax_ppa(x, e2, where)
                 - softmax_ppa.softmax_ppa_plain(x, e2, where)
                 ).abs().max())
    if not err <= SOFTMAX_ATOL:
        raise AssertionError(f"softmax_ppa vs plain at {shape}: {err}")
    ms, host = time_launch(lambda: softmax_ppa.softmax_ppa(x, e2, where))
    b_ms, b_by = softmax_bound(x.numel(), where.numel(), *_table_args(e2))
    row = dict(shape=list(shape), ms=ms, host_us=host, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, masked=True, max_abs_err=err)
    if plain:
        mask = where.expand(x.shape)
        row["plain_ms"] = time_ms(
            lambda: softmax_ppa.softmax_ppa_plain(x, e2, where), iters=10)
        row["context_masked_softmax_ms"], _ = time_launch(
            lambda: torch.softmax(x.masked_fill(~mask, float("-inf")),
                                  dim=-1))
    return row


def kernel_times(torch, dev, gen, ppa, fused, softmax_ppa, sig, e2,
                 plain: bool = True):
    """{kernel: {"decode" | "prefill": row}}: the integer kernel (table
    ``sig``), the fused kernel (bf16 gated, table ``sig``) and the softmax
    kernel (attention mask, table ``e2``) of the wrapper modules given, at
    INT_SHAPES, FUSED_SHAPES and SOFTMAX_SHAPES (``int_row``,
    ``fused_row``, ``softmax_row``)."""
    out = {"ppa_int": {}, "ppa_fused": {}, "softmax_ppa": {}}
    for label, shape in INT_SHAPES.items():
        row, xq = int_row(torch, gen, dev, ppa, sig, shape, plain)
        if label == "prefill":
            # the launches cycle over 4 copies of the input, 67 MB at this
            # shape, more than the 50 MB L2: each finds its input in
            # device memory, not left in L2 by the launch before
            xs = itertools.cycle([xq.clone() for _ in range(4)])
            row["cold_ms"], _ = time_launch(
                lambda: ppa.ppa_eval_int(sig, next(xs)))
        out["ppa_int"][label] = row
    for label, shape in FUSED_SHAPES.items():
        xb = (torch.randn(shape, generator=gen, device=dev) * 3.0
              ).to(torch.bfloat16)
        out["ppa_fused"][label] = fused_row(torch, fused, sig, xb, True,
                                            plain)
    for label, shape in SOFTMAX_SHAPES.items():
        out["softmax_ppa"][label] = softmax_row(torch, gen, dev, softmax_ppa,
                                                e2, shape, plain)
    return out


def flash_input(torch, gen, dev, shape):
    """What flash attention hands the fused kernel, ``m - s`` >= 0: the
    scores' distance below the running max, +inf where the chunk's causal
    mask hides a key, and at the rescale shape NaN in one row (the first
    chunk's -inf - -inf, which the caller masks)."""
    x = torch.randn(shape, generator=gen, device=dev).abs() * 4.0
    if len(shape) == 5:
        t, c = shape[-2:]
        hidden = (torch.arange(c, device=dev)[None, :]
                  > torch.arange(t, device=dev)[:, None])
        x = x.masked_fill(hidden, float("inf"))
    else:
        x[..., 0] = float("nan")
    return x


def launched_shapes():
    """A run's launches by input shape, {kernel: {shape: n}}
    (``read_shape_counts``), and the fused kernel's by what it computed,
    {(shape, dtype, table, gate): n} under "ppa_fused_variants"
    (``read_variant_counts``): one shape may take several tables."""
    from repro_torch.kernels import read_shape_counts, read_variant_counts
    return {**read_shape_counts(),
            "ppa_fused_variants": read_variant_counts()}


def path_rows(torch, dev, path, by_shape):
    """{kernel: {label: row}} for every input shape at which the run of
    ``path`` launched the integer, fused and softmax kernels (its
    ``launched_shapes``), each with its launches there.  A row is
    ``int_row``, ``fused_row`` or ``softmax_row``: held to the plain
    version, then timed beside its bound.  The fused kernel's rows follow
    its variants: the run's dtype, table and gate at each shape, on inputs
    of the served model's scale, or on ``exp_neg`` the decays' and flash
    attention's nonnegative inputs (``flash_input``)."""
    from repro_torch.kernels import fused, ppa, softmax_ppa
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tcs = {n: pack_table(load_table(n, 16), dev)
           for n in ("sigmoid_wide", "exp2_frac")}
    sig, e2 = tcs["sigmoid_wide"], tcs["exp2_frac"]
    out = {"ppa_int": {}, "ppa_fused": {}, "softmax_ppa": {}}
    for shape, n in sorted(by_shape["ppa_int"].items()):
        row, _ = int_row(torch, gen, dev, ppa, sig, shape)
        out["ppa_int"][f"{path} {shape}"] = dict(row, launches=n)
    for (shape, dtype, naf, gate), n in sorted(
            by_shape["ppa_fused_variants"].items()):
        if naf not in tcs:
            tcs[naf] = pack_table(load_table(naf, 16), dev)
        if naf == "exp_neg":
            x = flash_input(torch, gen, dev, shape)
        else:
            x = torch.randn(shape, generator=gen, device=dev) * 3.0
        row = fused_row(torch, fused, tcs[naf], x.to(getattr(torch, dtype)),
                        gate)
        label = f"{path} {shape} {dtype} {naf}" + (" gated" if gate else "")
        out["ppa_fused"][label] = dict(row, launches=n)
    for shape, n in sorted(by_shape["softmax_ppa"].items()):
        row = softmax_row(torch, gen, dev, softmax_ppa, e2, shape)
        out["softmax_ppa"][f"{path} {shape}"] = dict(row, launches=n)
    _free(torch)
    return out


def _bwd_err(torch, softmax_ppa, e2, x, g, where):
    """(max |kernel - plain|, SOFTMAX_BWD_REL x max |g|) of the softmax
    backward on one case."""
    got = softmax_ppa.softmax_ppa_bwd(x, g, e2, where)
    want = softmax_ppa.softmax_ppa_bwd_plain(x, g, e2, where)
    torch.cuda.synchronize()
    return (float((got - want).abs().max()),
            SOFTMAX_BWD_REL * float(g.abs().max())), got


def _check_softmax_bwd(torch, gen, dev, softmax_ppa, e2):
    """The softmax backward kernel within SOFTMAX_BWD_REL of its plain
    version, masked (causal) and not, at the training and decode shapes and
    on rows of every layout of its two paths, with a three-way tie for a
    row's max; an all-masked row exactly 0.  Returns the largest
    difference."""
    cases = []
    for name, shape in SOFTMAX_BWD_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev) * 4.0
        cases += [(name, x, None, None),
                  (f"{name} masked", x, attention_mask(torch, dev, shape),
                   (0, 0, 0, 0))]
    for n in SOFTMAX_ROW_LENGTHS + (1025,):
        x = torch.randn((16, n), generator=gen, device=dev) * 4.0
        x[5, :3] = x[5].max() + 1.0
        where = torch.rand((16, n), generator=gen, device=dev) < 0.7
        where[3] = False
        where[5, :3] = True
        cases += [(f"rows of {n}", x, None, None),
                  (f"rows of {n} masked", x, where, (3,))]
    err = ratio = 0.0
    for label, x, where, dead in cases:
        g = torch.randn(x.shape, generator=gen, device=dev)
        (d, lim), got = _bwd_err(torch, softmax_ppa, e2, x, g, where)
        if not d <= lim:
            raise AssertionError(f"softmax backward kernel vs plain, {label}"
                                 f" {tuple(x.shape)}: {d} > {lim}")
        if dead is not None and float(got[dead].abs().max()) != 0.0:
            raise AssertionError(f"{label}: all-masked row's gradient is "
                                 "not all zero")
        err, ratio = max(err, d), max(ratio, d / lim * SOFTMAX_BWD_REL)
    log(f"[kernels] softmax backward kernel vs plain: max |diff| {err:.3e},"
        f" at most {ratio:.2e} x max |g| <= {SOFTMAX_BWD_REL}, on "
        f"{len(cases)} cases (train {SOFTMAX_BWD_SHAPES['train']} and decode"
        f" {SOFTMAX_BWD_SHAPES['decode']} with and without the attention "
        f"mask, rows of {', '.join(map(str, SOFTMAX_ROW_LENGTHS + (1025,)))}"
        " masked and not, with a three-way tie for a row's max); all-masked"
        " rows exactly 0")
    return err


def softmax_bwd_times(torch, dev, gen, softmax_ppa, e2, plain: bool = True):
    """{"train" | "decode": row} for the softmax backward kernel with the
    attention mask at SOFTMAX_BWD_SHAPES: held to its plain version, then
    timed beside its bound, as ``kernel_times`` does.  No one PyTorch call
    computes this function; torch's softmax backward, given as context,
    is another one."""
    out = {}
    for label, shape in SOFTMAX_BWD_SHAPES.items():
        x = torch.randn(shape, generator=gen, device=dev) * 4.0
        g = torch.randn(shape, generator=gen, device=dev)
        where = attention_mask(torch, dev, shape)
        (err, lim), _ = _bwd_err(torch, softmax_ppa, e2, x, g, where)
        if not err <= lim:
            raise AssertionError(f"softmax_ppa_bwd vs plain at {shape}: "
                                 f"{err} > {lim}")
        ms, host = time_launch(
            lambda: softmax_ppa.softmax_ppa_bwd(x, g, e2, where))
        b_ms, b_by = softmax_bwd_bound(x.numel(), where.numel(),
                                       e2.num_segments, e2.plan.order,
                                       e2.plan.round_mults)
        row = dict(shape=list(shape), ms=ms, host_us=host, bound_ms=b_ms,
                   bound_by=b_by, library_ms=None, masked=True,
                   max_abs_err=err)
        if plain:
            row["plain_ms"] = time_ms(
                lambda: softmax_ppa.softmax_ppa_bwd_plain(x, g, e2, where),
                iters=10)
            y = torch.softmax(x.masked_fill(~where.expand(shape),
                                            float("-inf")), dim=-1)
            row["context_softmax_backward_ms"], _ = time_launch(
                lambda: torch.ops.aten._softmax_backward_data(
                    g, y, -1, torch.float32))
        out[label] = row
    return out


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

    _check_int(torch, gen, dev, ppa, ref,
               {**tcs, ("exp2_frac-round", 12): rounding})
    _check_fused(torch, gen, dev, fused, tcs)
    e2 = tcs[("exp2_frac", 16)]
    sm_err = _check_softmax(torch, gen, dev, softmax_ppa, e2)
    bwd_err = _check_softmax_bwd(torch, gen, dev, softmax_ppa, e2)

    # ---- timings at the standing shapes; a kernel's own numbers in the
    # kernels line are those at decode, the shape its main path launches
    # most (the shapes a path launched are timed after it: path_rows)
    sig = tcs[("sigmoid_wide", 16)]
    times = kernel_times(torch, dev, gen, ppa, fused, softmax_ppa, sig, e2)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    int_k = dict(
        name="ppa_int", route="cuda",
        source="src/repro_torch/kernels/csrc/ppa_int.cu",
        replaces="src/repro/kernels/ppa.py:77", max_abs_err=0.0,
        **{k: times["ppa_int"]["decode"][k] for k in keys},
        dtype="int32", table="sigmoid_wide-16", shapes=times["ppa_int"])
    fused_k = dict(
        name="ppa_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/ppa_fused.cu",
        replaces="src/repro/kernels/fused.py:40", max_abs_err=0.0,
        **{k: times["ppa_fused"]["decode"][k] for k in keys},
        dtype="bfloat16", gate=True, table="sigmoid_wide-16",
        shapes=times["ppa_fused"])
    sm_k = dict(
        name="softmax_ppa", route="cuda",
        source="src/repro_torch/kernels/csrc/softmax_ppa.cu",
        replaces="src/repro/kernels/softmax_ppa.py:44", max_abs_err=sm_err,
        **{k: times["softmax_ppa"]["decode"][k] for k in keys},
        masked=True, table="exp2_frac-16", shapes=times["softmax_ppa"])

    bwd_times = softmax_bwd_times(torch, dev, gen, softmax_ppa, e2)
    bwd_k = dict(
        name="softmax_ppa_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/softmax_ppa.cu",
        replaces="src/repro/kernels/ops.py:391", max_abs_err=bwd_err,
        **{k: bwd_times["train"][k] for k in keys}, masked=True,
        table="exp2_frac-16", shapes=bwd_times)

    rows = [int_k, fused_k, sm_k, bwd_k]
    log_rows("kernels", {r["name"]: r["shapes"] for r in rows})
    return rows


def log_rows(tag, shapes):
    """One line for each row of {kernel: {label: row}}."""
    for name, by_label in shapes.items():
        for label, t in by_label.items():
            ctx = t.get("context_gate_ms", t.get(
                "context_masked_softmax_ms",
                t.get("context_softmax_backward_ms")))
            log(f"[{tag}] {name} {label} {t['shape']}"
                + ("" if "table" not in t else
                   f" {t['dtype']} {t['table']} gate={t['gate']}") + ": "
                f"{t['ms']:.5f} ms on the device (plain {t['plain_ms']:.5f}"
                f" ms, bound {t['bound_ms']:.7f} ms by {t['bound_by']}, "
                f"{100 * t['bound_ms'] / t['ms']:.1f}% of it; library "
                + ("none" if t["library_ms"] is None
                   else f"{t['library_ms']:.5f} ms")
                + ("" if ctx is None else
                   f"; context, not the same function: {ctx:.5f} ms")
                + ("" if "cold_ms" not in t else
                   f"; inputs not in L2: {t['cold_ms']:.5f} ms")
                + f"), host {t['host_us']:.1f} us per call"
                + ("" if "launches" not in t else
                   f"; {t['launches']} launches on the path"))


def _cut(cfg, layers: int):
    """Every stage, and the encoder, cut to ``layers`` layers."""
    return cfg.replace(stages=tuple(
        dataclasses.replace(st, n_layers=layers) for st in cfg.stages),
        enc_layers=min(cfg.enc_layers, layers))


def _serve(torch, dev, cfg, n_requests, max_new, lens, acts=None):
    """Serve ``n_requests``, each with the extras the launcher draws
    (``request_extras``: frame or patch embeddings from the seeded
    generator, before each prompt); returns (engine, requests, step
    times).  ``acts``: the engine's activation bundle in place of the one
    it builds from ``cfg``."""
    import numpy as np
    from repro_torch.kernels import reset_counts
    from repro_torch.launch.serve import request_extras
    from repro_torch.models import init_params, param_specs
    from repro_torch.serve import Request, ServeEngine

    params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                         device=dev)
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      cache_len=SERVE_CACHE_LEN, device=dev)
    del params
    if acts is not None:
        eng.acts = acts
    eng.warmup(sorted(set(lens)))
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(n_requests):
        extra = request_extras(cfg, rng) or None
        reqs.append(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, lens[i]).astype(np.int32),
            max_new_tokens=max_new, extra=extra))
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


def phase_serve(torch, dev, card, store=None):
    """``store``: serve with the tables of this ``TableStore``
    (``make_acts(store=...)``, the serve_store phase): its packed
    constants must be the shipped tables' and its greedy tokens the serve
    phase's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts
    from repro_torch.models import make_acts

    tag = "serve" if store is None else "serve_store"
    cfg = get_config("internlm2-1.8b").replace(
        act_impl="ppa", compute_dtype="bfloat16")
    acts = None
    if store is not None:
        _check_store_tables(torch, dev, store)
        acts = make_acts(cfg.act_impl, cfg.act_backend, dev, store=store)
    lens = [32, 128, 64, 96, 48, 128, 80, 112][:SERVE_REQUESTS]
    eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                    SERVE_NEW, lens, acts)
    TOKENS[tag] = [list(r.output) for r in reqs]
    if store is not None and TOKENS[tag] != TOKENS.get("serve"):
        raise AssertionError("the store-served greedy tokens differ from "
                             "the serve phase's")
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
    log(f"[{tag}] internlm2-1.8b 24L d_model 2048 bf16 act_impl=ppa "
        f"act_backend={eng.cfg.act_backend}: {len(reqs)} requests, {tokens}"
        f" tokens in {wall:.3f}s = {tokens / wall:.1f} tok/s over "
        f"{n_steps} engine steps; decode {dec_ms:.2f} ms/step (median); "
        f"prefill {sum(adm_ms):.2f} ms in {len(adm_ms)} admission steps "
        f"(step time minus median decode); max_memory_allocated "
        f"{mem / 2**30:.2f} GiB; prefill shapes {sorted(eng.prefill_shapes)}"
        f"; card {card}")
    by_shape = launched_shapes()
    # the launches in all and at each standing shape (kernel_times)
    out = {k: {"total": counts[k]["launches"],
               **{label: by_shape[k].get(shape, 0)
                  for label, shape in shapes.items()}}
           for k, shapes in (("ppa_fused", FUSED_SHAPES),
                             ("softmax_ppa", SOFTMAX_SHAPES))}
    log(f"[{tag}] launches fused={counts['ppa_fused']['launches']} softmax="
        f"{counts['softmax_ppa']['launches']} (layers x steps = {need}); "
        f"by shape {by_shape}; plain calls {plain}")
    if store is not None:
        log(f"[{tag}] the store's 6 tables pack to the shipped constants; "
            f"greedy tokens equal to the serve phase's ({tokens} tokens)")
        return out, {}
    rows = path_rows(torch, dev, "serve", by_shape)
    log_rows("serve", rows)
    return out, rows


def decode_launches(cfg):
    """{kernel: {launch: launches}} of one decode step of ``cfg`` (bf16)
    at SERVE_SLOTS sequences: the fused kernel's by (input shape, dtype,
    table, gate), the softmax's by scores shape.  Per layer: the softmax on
    each attention stage's ring; the MLP's gate, or an MoE's expert buffer
    (E, C, f) of SERVE_SLOTS tokens and its shared experts' gate; on
    ``hyb`` also the SSM's silu (conv output and z), softplus and float32
    decays (B, 1, di, N); on ``rwkv`` the tanh of the decay LoRA, the two
    chained float32 exponentials, silu(g) and the channel mix's sigmoid;
    on ``xdec`` the softmax over the encoder's frames too, and the plain
    MLP's gelu."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _moe_cfg, ring_len
    b, bf, f32 = SERVE_SLOTS, "bfloat16", "float32"
    fused, softmax = collections.Counter(), collections.Counter()
    for st in cfg.stages:
        n = st.n_layers
        if st.kind == "rwkv":
            h, dh = cfg.n_q, cfg.head_dim
            fused[((b, 1, cfg.rwkv_decay_lora), bf, "tanh_wide", False)] += n
            fused[((b, 1, h, dh), f32, "exp_neg", False)] += 2 * n
            fused[((b, 1, h, dh), bf, "sigmoid_wide", True)] += n
            fused[((b, 1, cfg.d_model), bf, "sigmoid_wide", False)] += n
            continue
        softmax[(b, cfg.n_kv, cfg.n_q // cfg.n_kv, 1,
                 ring_len(st, SERVE_CACHE_LEN))] += n
        if st.kind == "xdec":
            softmax[(b, cfg.n_kv, cfg.n_q // cfg.n_kv, 1, cfg.enc_seq)] += n
            fused[((b, 1, cfg.d_ff), bf, "gelu_inner", True)] += n
            continue
        if st.kind == "hyb":
            di = cfg.ssm_inner
            fused[((b, 1, di), bf, "sigmoid_wide", True)] += 2 * n
            fused[((b, 1, di), bf, "softplus", False)] += n
            fused[((b, 1, di, cfg.ssm_state), f32, "exp_neg", False)] += n
        if st.moe:
            mcfg = _moe_cfg(cfg)
            fused[((mcfg.n_experts, moe._capacity(b, mcfg), mcfg.d_ff), bf,
                   "sigmoid_wide", True)] += n
            if mcfg.n_shared:
                fused[((b, 1, mcfg.n_shared * mcfg.d_ff), bf,
                       "sigmoid_wide", True)] += n
        else:
            fused[((b, 1, cfg.d_ff), bf, GATE_TABLES[cfg.gate], True)] += n
    return {"ppa_fused": dict(fused), "softmax_ppa": dict(softmax)}


def phase_serve_full(torch, dev, card, arch, tag):
    """Full-width ``arch``, all its layers, through the serve phase's
    engine and traffic: every request finishes at its length; a recurrent
    model's prompts prefill at their exact lengths (its state forbids
    padding); the fused kernel launches at least layers x engine steps
    times, the softmax kernel as often where there is attention and never
    where there is none, and each at every launch of every decode step
    (``decode_launches``); no plain version runs.  Returns the launches and
    ``path_rows`` of this run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts
    from repro_torch.models.transformer import RECURRENT_KINDS

    _free(torch)
    cfg = get_config(arch).replace(act_impl="ppa", compute_dtype="bfloat16",
                                   act_backend="cuda_fused")
    lens = [32, 128, 64, 96, 48, 128, 80, 112][:SERVE_REQUESTS]
    eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                    SERVE_NEW, lens)
    counts, by_shape = read_counts(), launched_shapes()
    mem = torch.cuda.max_memory_allocated(dev)
    n_steps = len(steps)
    need = cfg.n_layers * n_steps
    attn = any(st.kind != "rwkv" for st in cfg.stages)
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    decode = sorted(t for t, adm in steps if adm == 0)
    dec_ms = decode[len(decode) // 2] * 1e3
    adm_ms = [t * 1e3 - dec_ms for t, adm in steps if adm > 0]
    tokens = sum(len(r.output) for r in reqs)
    shapes = sorted(eng.prefill_shapes)
    stages = [(st.kind, st.n_layers) + ((f"window {st.window}",)
                                        if st.window else ())
              + (("moe",) if st.moe else ()) for st in cfg.stages]
    front = ((f", encoder {cfg.enc_layers}L on {cfg.enc_seq} frames"
              if cfg.enc_layers else "")
             + (f", {cfg.vision_tokens} vision tokens"
                if cfg.vision_tokens else ""))
    log(f"[{tag}] {arch} {cfg.n_layers}L {stages}{front} d_model "
        f"{cfg.d_model} bf16 act_impl=ppa act_backend={eng.cfg.act_backend}: "
        f"{len(reqs)} requests, {tokens} tokens in {wall:.3f}s = "
        f"{tokens / wall:.1f} tok/s over {n_steps} engine steps; decode "
        f"{dec_ms:.2f} ms/step (median; each "
        f"{[round(t * 1e3, 2) for t in decode]}); prefill "
        f"{sum(adm_ms):.2f} ms in {len(adm_ms)} admission steps (step time "
        f"minus median decode); max_memory_allocated {mem / 2**30:.2f} GiB;"
        f" prefill shapes (tokens, batch) {shapes}; card {card}")
    log(f"[{tag}] launches fused={counts['ppa_fused']['launches']} softmax="
        f"{counts['softmax_ppa']['launches']} (layers x steps = {need}); "
        f"by shape {by_shape}; plain calls {plain}")
    del eng
    _free(torch)
    padded = [s for s in shapes if s[0] not in lens]
    if any(st.kind in RECURRENT_KINDS for st in cfg.stages) and padded:
        raise AssertionError(f"{arch}: padded prefill groups {padded}")
    if counts["ppa_fused"]["launches"] < need:
        raise AssertionError(f"ppa_fused launched "
                             f"{counts['ppa_fused']['launches']} times < "
                             f"layers x steps = {need}")
    sm = counts["softmax_ppa"]["launches"]
    if attn and sm < need:
        raise AssertionError(f"softmax_ppa launched {sm} times < {need}")
    if not attn and sm:
        raise AssertionError(f"softmax_ppa launched {sm} times in an "
                             "attention-free model")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the {tag} path: "
                             f"{plain}")
    launched = {"ppa_fused": by_shape["ppa_fused_variants"],
                "softmax_ppa": by_shape["softmax_ppa"]}
    for k, per_step in decode_launches(cfg).items():
        for key, n in per_step.items():
            if launched[k].get(key, 0) < n * len(decode):
                raise AssertionError(
                    f"{k} at the decode launch {key}: "
                    f"{launched[k].get(key, 0)} launches < {n} a step x "
                    f"{len(decode)} decode steps")
    rows = path_rows(torch, dev, tag, by_shape)
    log_rows(tag, rows)
    return {"ppa_fused": {"total": counts["ppa_fused"]["launches"]},
            "softmax_ppa": {"total": sm}}, rows


def phase_serve_int(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts

    cfg = _cut(get_config("internlm2-1.8b"), 2).replace(
        act_impl="ppa", compute_dtype="bfloat16", act_backend="cuda_int")
    eng, reqs, steps, wall = _serve(torch, dev, cfg, 4, 8,
                                    [32, 64, 48, 128])
    counts = read_counts()
    need = cfg.n_layers * len(steps)
    if counts["ppa_int"]["launches"] < need:
        raise AssertionError(f"cuda_int serve launched the integer kernel "
                             f"{counts['ppa_int']['launches']} times < "
                             f"layers x steps = {need}")
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran on the int path: {plain}")
    total = counts["ppa_int"]["launches"]
    by_shape = launched_shapes()
    at_decode = by_shape["ppa_int"].get(INT_SHAPES["decode"], 0)
    decode = sorted(t for t, adm in steps if adm == 0)
    log(f"[serve_int] internlm2-1.8b 2L act_backend=cuda_int: {len(reqs)} "
        f"requests in {len(steps)} steps, {wall:.3f}s; decode "
        f"{decode[len(decode) // 2] * 1e3:.2f} ms/step (median); launches "
        f"int={total} (layers x steps = {need}; {at_decode} at the decode "
        f"shape {INT_SHAPES['decode']}) softmax="
        f"{counts['softmax_ppa']['launches']}; plain calls {plain}")
    rows = path_rows(torch, dev, "serve_int", by_shape)
    log_rows("serve_int", rows)
    return {"ppa_int": {"total": total, "decode": at_decode, "prefill":
                        by_shape["ppa_int"].get(INT_SHAPES["prefill"], 0)},
            "softmax_ppa": {"total": counts["softmax_ppa"]["launches"]}
            }, rows


PARITY_ARMS = ("ref", "cuda_int", "cuda_fused")
# Controls for the parity gate: the ref arm with its softmax probabilities
# moved, each nonzero one by +-d (a seeded sign) or rounded to bf16.  Those
# beyond the softmax kernel's SOFTMAX_ATOL are a wrong or lower-precision
# softmax, which the gate must reject; +-1e-6, every probability at the
# edge of that bound, is only reported.
PARITY_CONTROLS = {"+-1e-6": 1e-6, "+-1e-5": 1e-5, "+-1e-4": 1e-4,
                   "bf16": None}


def _parity_run(torch, params, cfg, batch, acts, gate, gate_tc,
                cache_dtype):
    """Prefill + 8 greedy decode steps of ``batch`` (the prompts of 64
    tokens and their extras); returns (tokens, logits, the MLP gate's
    (``gate``: "silu" or "gelu", of table ``gate_tc``) quantized inputs and
    outputs per call, the routed expert ids of every MoE layer and call).
    A quantized input is the table grid point the float path evaluates,
    floor(|x| 2^w_in + 0.5), with every input at or beyond the interval's
    end counted as hi."""
    import dataclasses as dc
    from repro_torch.models import decode_step, moe, prefill

    qs, outs, routes = [], [], []
    act, route = getattr(acts, gate), moe._route

    def recorded(x):
        q = torch.floor(x.float().abs() * float(1 << gate_tc.w_in) + 0.5)
        qs.append(torch.clamp(q, max=gate_tc.hi).to(torch.int32))
        outs.append(act(x))
        return outs[-1]

    def recorded_route(x2, router, mcfg):
        out = route(x2, router, mcfg)
        routes.append(out[0].clone())
        return out

    acts = dc.replace(acts, **{gate: recorded})
    prompt = batch["tokens"]
    dev = prompt.device
    moe._route = recorded_route
    try:
        logits, cache = prefill(params, cfg, batch,
                                128 + cfg.vision_tokens, acts,
                                cache_dtype=cache_dtype)
        toks, all_logits = [], [logits]
        pos = torch.full((4,), prompt.shape[1] + cfg.vision_tokens,
                         dtype=torch.int32, device=dev)
        tok = torch.argmax(logits, -1)
        for _ in range(8):
            toks.append(tok)
            logits, cache = decode_step(params, cfg, cache,
                                        tok[:, None].to(torch.int32), pos,
                                        acts)
            all_logits.append(logits)
            tok = torch.argmax(logits, -1)
            pos = pos + 1
    finally:
        moe._route = route
    toks.append(tok)
    return torch.stack(toks), torch.stack(all_logits), qs, outs, routes


def _moved_softmax(torch, dev, softmax, d, seed: int = 2):
    """A control: ``softmax`` with each nonzero probability moved by +-d (a
    sign from ``seed``), or rounded to bf16 when ``d`` is None."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fn(x, axis=-1, where=None):
        p = softmax(x, axis=axis, where=where)
        if d is None:
            return p.to(torch.bfloat16).to(p.dtype)
        sign = torch.randint(0, 2, p.shape, generator=gen,
                             device=dev).to(p.dtype) * 2 - 1
        return torch.where(p > 0, p + d * sign, p)
    return fn


def phase_parity(torch, dev, arch="internlm2-1.8b", per_stage=2,
                 tag="parity", stages=None, cache_dtype="bfloat16"):
    """The three arms and the controls on ``arch`` at full width, each
    stage cut to ``per_stage`` layers and, with ``stages``, only the first
    ``stages`` stages kept, float32, the decode cache in ``cache_dtype``.
    An attention-free model (rwkv) runs no softmax, and the fused kernel is
    exact: there the arms must be equal bit for bit, and the softmax
    controls do not apply."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import pack_table
    from repro_torch.launch.serve import request_extras
    from repro_torch.models import (init_params, make_acts, param_specs,
                                    prepare_params)
    from repro_torch.tables import load_table

    _free(torch)
    cfg = _cut(get_config(arch), per_stage).replace(
        act_impl="ppa", compute_dtype="float32")
    cfg = cfg.replace(stages=cfg.stages[:stages])
    params = prepare_params(
        init_params(param_specs(cfg), 0, device=dev), cfg)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 64)),
                                       dtype=torch.int32, device=dev)}
    extras = [request_extras(cfg, rng) for _ in range(4)]
    for k in extras[0]:
        batch[k] = torch.as_tensor(np.stack([e[k] for e in extras]),
                                   device=dev)
    # the MLP's gate: gelu in whisper's encoder and decoder
    gate = "gelu" if any(st.kind in ("enc", "xdec")
                         for st in cfg.stages) else cfg.gate
    gate_tc = pack_table(load_table(GATE_TABLES[gate], 16), dev)
    moved = functools.partial(_moved_softmax, torch, dev)

    import dataclasses as dc
    with torch.inference_mode():
        cache_dt = getattr(torch, cache_dtype)
        runs = {name: _parity_run(torch, params, cfg, batch,
                                  make_acts("ppa", name, dev), gate, gate_tc,
                                  cache_dt)
                for name in PARITY_ARMS}
        ref_acts = make_acts("ppa", "ref", dev)
        attn = any(st.kind != "rwkv" for st in cfg.stages)
        controls = {
            name: _parity_run(torch, params, cfg, batch, dc.replace(
                ref_acts, softmax=moved(ref_acts.softmax, d)), gate,
                gate_tc, cache_dt)[1]
            for name, d in PARITY_CONTROLS.items() if attn}
    toks = {n: r[0] for n, r in runs.items()}
    scale = float(runs["ref"][1].abs().max())
    report = {}
    for a, b in (("ref", "cuda_int"), ("cuda_int", "cuda_fused"),
                 ("ref", "cuda_fused")):
        (_, la, qa, oa, _), (_, lb, qb, ob, _) = runs[a], runs[b]
        flips = [qx != qy for qx, qy in zip(qa, qb)]
        n_flips = sum(int(f.sum()) for f in flips)
        d_out = [(ox - oy).abs() for ox, oy in zip(oa, ob)]
        at_flips = max((float(d[f].max()) for d, f in zip(d_out, flips)
                        if f.any()), default=0.0)
        elsewhere = max(float(torch.where(f, 0.0, d).max())
                        for d, f in zip(d_out, flips))
        per_call = [int(f.sum()) for f in flips]
        report[f"{a}|{b}"] = dict(
            gap=float((la - lb).abs().max()), flips=n_flips,
            flips_per_call=per_call, gate_gap_at_flips=at_flips,
            gate_gap_elsewhere=elsewhere,
            tokens_equal=bool(torch.equal(toks[a], toks[b])))
        log(f"[{tag}] {a} vs {b}: max |logit gap| "
            f"{report[f'{a}|{b}']['gap']:.3e} (logits up to {scale:.3e}); "
            f"{n_flips} quantized {gate} inputs differ (per call, prefill "
            f"then decode, layer by layer: {per_call}); {gate} output gap "
            f"{at_flips:.3e} at them, {elsewhere:.3e} elsewhere")
    for pair, r in report.items():
        if not r["tokens_equal"]:
            raise AssertionError(f"greedy tokens differ between {pair} "
                                 f"(max logit gap {r['gap']})")
    routes = {n: r[4] for n, r in runs.items()}
    if cfg.moe_experts:
        for name in ("cuda_int", "cuda_fused"):
            if len(routes[name]) != len(routes["ref"]) or not all(
                    torch.equal(a, b)
                    for a, b in zip(routes[name], routes["ref"])):
                raise AssertionError(f"routed expert ids differ between ref"
                                     f" and {name}")
        log(f"[{tag}] routed expert ids equal in all three arms: "
            f"{len(routes['ref'])} calls of the router (prefill then decode"
            f"), {sum(r.numel() for r in routes['ref'])} assignments")
    # The bound, from the attribution.  cuda_int and cuda_fused share the
    # softmax kernel and differ only in the fused kernel, which is exact:
    # their logits must be equal.  Against ref, both differ only in the
    # softmax kernel, whose probabilities are within SOFTMAX_ATOL of the
    # plain version's (another summation order).  Such a difference moves
    # some of the model's quantized values by one step of their grid: silu
    # table inputs (counted above) by 2^-w_in = 2^-8, bf16 cache entries by
    # one unit in the last place, 2^-8 to 2^-7 of their value.  The logits
    # are held to PARITY_LIMIT of their largest magnitude.  Nothing here
    # bounds the model's gain from one quantized value to a logit, so the
    # controls calibrate the limit: each softmax moved beyond SOFTMAX_ATOL
    # must exceed it.  On an H100 the kernels gave 3.97e-3 against a limit
    # of 1.93e-2, the controls 5.4e-2 to 9.2e-2 beyond the bound and 2.1e-2
    # at its edge (PERF.md): the limit is tighter than the bound's worst
    # case, and looser than the kernels' gap by a factor of five.
    if not attn:
        unequal = {p: r for p, r in report.items()
                   if r["gap"] != 0.0 or r["flips"] != 0}
        if unequal:
            raise AssertionError(f"attention-free, the arms must be equal: "
                                 f"{unequal}")
        del runs, params
        _free(torch)
        log(f"[{tag}] {arch} {cfg.n_layers}L float32: prefill + 8 greedy "
            f"decode steps, equal tokens and logits bit for bit in all three"
            f" arms (no softmax; the fused and integer kernels are exact)")
        return
    fu = report["cuda_int|cuda_fused"]
    if fu["gap"] != 0.0 or fu["flips"] != 0:
        raise AssertionError(f"the fused kernel moved the logits: {fu}")
    limit = scale * PARITY_LIMIT
    gaps = {name: float((runs["ref"][1] - lc).abs().max())
            for name, lc in controls.items()}
    for name, gap in gaps.items():
        log(f"[{tag}] control ref with its softmax {name}: max |logit "
            f"gap| {gap:.3e} against ref")
    for pair in ("ref|cuda_int", "ref|cuda_fused"):
        if not report[pair]["gap"] <= limit:
            raise AssertionError(f"{pair}: logit gap {report[pair]['gap']}"
                                 f" > {PARITY_LIMIT} x {scale} = {limit}")
    for name, d in PARITY_CONTROLS.items():
        if (d is None or d > SOFTMAX_ATOL) and not gaps[name] > limit:
            raise AssertionError(
                f"control {name}: logit gap {gaps[name]} <= the limit "
                f"{limit}: the gate passes a softmax beyond {SOFTMAX_ATOL} "
                "of the plain one")
    del runs, controls, params
    _free(torch)
    log(f"[{tag}] {arch} {cfg.n_layers}L"
        + (f" + {cfg.enc_layers}L encoder" if cfg.enc_layers else "")
        + (f" after {cfg.vision_tokens} vision tokens"
           if cfg.vision_tokens else "")
        + f" float32, a {cache_dtype} cache: prefill + 8 greedy decode "
        f"steps, equal tokens in all three arms; cuda_int vs cuda_fused "
        f"logits equal (the fused kernel is exact); ref vs either "
        f"{report['ref|cuda_int']['gap']:.3e} <= {PARITY_LIMIT} x "
        f"max |logit| = {limit:.3e} (the softmax kernel's summation order); "
        f"every control beyond {SOFTMAX_ATOL} rejected")


def _free(torch):
    import gc
    gc.collect()
    torch.cuda.empty_cache()


# The full-depth gate of the train phase.  At the random init the gradient
# grows layer by layer toward the input (about 4e15 at 24 layers of full
# width in float32 as in bf16, PERF.md), and a move of 1e-7 in one softmax
# moves the loss and the input-side gradients far more than the 2-layer
# parity sees.  So step 0 of the kernel path is held to the plain versions
# (``ref``) at full depth within TRAIN_DEPTH_RATIO times the spread of
# TRAIN_DEPTH_CONTROLS controls: ``ref`` with its softmax moved by a
# seeded +-SOFTMAX_ATOL, the kernel's own bound.  Held: the loss, the
# gradient norm and the norm of each layer's gradients, the embedding's
# and the head's, each as the gap of its logarithm.
TRAIN_DEPTH_CONTROLS = 3
TRAIN_DEPTH_RATIO = 2.0


def _grad_norms(torch, grads):
    """log of the norms of each layer's gradients (over every stacked
    leaf), the embedding's, the head's and the whole tree's."""
    from repro_torch.train import global_norm
    from repro_torch.tree import leaves
    sq = sum(g.float().square().flatten(1).sum(1)
             for st in grads["stages"].values() for g in leaves(st))
    rest = [global_norm(grads[k]).view(1) ** 2
            for k in ("embed", "lm_head")] + [global_norm(grads).view(1) ** 2]
    return (0.5 * torch.cat([sq] + rest).log()).cpu()


def _train_depth_arms(torch, dev, cfg):
    """Step 0 of the train phase (its params and batch, full depth): loss
    and log norms (``_grad_norms``) under ``cuda_fused``, ``ref`` and the
    controls."""
    import dataclasses as dc
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.models.transformer import dtype_of
    from repro_torch.train.train_step import loss_and_grads

    params = init_params(param_specs(cfg), 0, dtype_of(cfg.param_dtype),
                         device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ,
        global_batch=TRAIN_BATCH).batch_at(0).items()}
    ref = make_acts("ppa", "ref", dev)
    arms = {"cuda_fused": make_acts("ppa", "cuda_fused", dev), "ref": ref}
    for seed in range(TRAIN_DEPTH_CONTROLS):
        arms[f"control {seed}"] = dc.replace(ref, softmax=_moved_softmax(
            torch, dev, ref.softmax, SOFTMAX_ATOL, seed))
    out = {}
    for name, acts in arms.items():
        loss, grads = loss_and_grads(cfg, acts, params, batch)
        out[name] = (float(loss), _grad_norms(torch, grads))
        del grads
        _free(torch)
    del params
    _free(torch)
    return out


def _check_train_depth(torch, arms, step0):
    """The full-depth gate: the ``cuda_fused`` arm, and the run's step 0
    (``step0``: loss, gradient norm), within TRAIN_DEPTH_RATIO times the
    controls' largest gap to ``ref``."""
    import math
    ref_loss, ref_norms = arms["ref"]
    ctrl = [v for k, v in arms.items() if k.startswith("control")]
    loss_env = max(abs(c[0] - ref_loss) for c in ctrl)
    norm_env = torch.stack([(c[1] - ref_norms).abs() for c in ctrl]).amax(0)
    loss, norms = arms["cuda_fused"]
    gap = (norms - ref_norms).abs()
    ratio = gap / norm_env
    run_gap = (abs(step0[0] - ref_loss),
               abs(math.log(step0[1]) - float(ref_norms[-1])))
    names = [f"layer {i}" for i in range(len(norms) - 3)] + [
        "embed", "lm_head", "all"]
    worst = int(ratio.argmax())
    log(f"[train] full depth, step 0: loss cuda_fused {loss:.6f}, run "
        f"{step0[0]:.6f}, ref {ref_loss:.6f}, controls "
        f"{[round(c[0], 6) for c in ctrl]}; gradient norm cuda_fused "
        f"{math.exp(norms[-1]):.4e}, run {step0[1]:.4e}, ref "
        f"{math.exp(ref_norms[-1]):.4e}, controls "
        f"{[f'{math.exp(c[1][-1]):.4e}' for c in ctrl]}")
    log(f"[train] full depth, |log| gaps of the norms to ref, input side "
        f"first: cuda_fused {[round(float(g), 4) for g in gap]}; controls' "
        f"largest {[round(float(e), 4) for e in norm_env]}; worst "
        f"{names[worst]} {float(ratio[worst]):.3f} x its controls'")
    bad = [names[i] for i in range(len(names))
           if not gap[i] <= TRAIN_DEPTH_RATIO * norm_env[i]]
    if abs(loss - ref_loss) > TRAIN_DEPTH_RATIO * loss_env:
        bad.append(f"loss {abs(loss - ref_loss):.3e}")
    if run_gap[0] > TRAIN_DEPTH_RATIO * loss_env:
        bad.append(f"the run's step-0 loss {run_gap[0]:.3e}")
    if not run_gap[1] <= TRAIN_DEPTH_RATIO * float(norm_env[-1]):
        bad.append(f"the run's step-0 gradient norm {run_gap[1]:.3e}")
    if bad:
        raise AssertionError(
            f"at full depth, beyond {TRAIN_DEPTH_RATIO} x the controls' "
            f"gap to ref (loss {loss_env:.3e}): {bad}")


def phase_train(torch, dev, card):
    """Full-width training through the launcher's ``run_training``, its
    step 0 held to the plain versions at full depth
    (``_check_train_depth``); returns the launches of each kernel, in all
    and at the training shapes, and ``path_rows`` of this run."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch.train import run_training
    from repro_torch.train import ScheduleCfg

    cfg = get_config("internlm2-1.8b").replace(act_impl="ppa",
                                               act_backend="cuda_fused")
    if (cfg.param_dtype, cfg.compute_dtype) != ("float32", "bfloat16"):
        raise AssertionError(f"train phase wants float32 master weights "
                             f"and bf16 compute, got {cfg}")
    _free(torch)
    arms = _train_depth_arms(torch, dev, cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    out = run_training(
        cfg, steps=TRAIN_STEPS, ckpt_dir=None, resume="none", ckpt_every=0,
        batch_override=TRAIN_BATCH, seq_override=TRAIN_SEQ,
        opt_kind="adamw", sched=ScheduleCfg(peak_lr=3e-4, warmup_steps=2),
        log_every=1, device=dev)
    counts, by_shape = read_counts(), launched_shapes()
    mem = torch.cuda.max_memory_allocated(dev)
    losses, gnorms = out["losses"], out["grad_norms"]
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    # the forward kernels run again in each layer's recompute (remat)
    forwards = 1 + (cfg.remat in ("dots", "full"))
    steps = len(losses)
    need = {"ppa_fused": cfg.n_layers * steps * forwards,
            "softmax_ppa": cfg.n_layers * steps * forwards,
            "softmax_ppa_bwd": cfg.n_layers * steps}
    step_ms = [t * 1e3 for t in out["step_s"]]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shapes = {"ppa_fused": (TRAIN_BATCH, TRAIN_SEQ, cfg.d_ff),
              "softmax_ppa": SOFTMAX_BWD_SHAPES["train"],
              "softmax_ppa_bwd": SOFTMAX_BWD_SHAPES["train"]}
    result = {k: {"total": counts[k]["launches"],
                  "train": by_shape[k].get(shape, 0)}
              for k, shape in shapes.items()}
    log(f"[train] internlm2-1.8b 24L d_model 2048 vocab {cfg.vocab}, float32"
        f" master weights, bf16 compute, act_impl=ppa act_backend="
        f"{cfg.act_backend} remat={cfg.remat}, adamw, batch {TRAIN_BATCH} x "
        f"seq {TRAIN_SEQ}: losses {losses}; grad norms before clipping "
        f"{[f'{g:.3e}' for g in gnorms]}")
    log(f"[train] step ms {[round(t, 2) for t in step_ms]}; median of steps"
        f" 2-{steps} {med:.2f} ms = {tokens / med * 1e3:.1f} tokens/s; "
        f"max_memory_allocated {mem / 2**30:.2f} GiB; card {card}")
    log(f"[train] launches {result} (at least {need}: layers x steps, the "
        f"forward kernels x{forwards} for the recompute under remat="
        f"{cfg.remat}); plain calls {plain}")
    # No descent gate at this depth: at the random init the gradient norm
    # is about 1e16, nearly all of it in the first layers (the reference's
    # own init does the same at every depth tests/test_torch_train.py
    # holds it to), so clipping to 1 leaves every other gradient below
    # adamw's eps and 8 steps move the loss by noise.  The depth is held
    # by _check_train_depth; the descent gate is the smoke run's
    # (phase_train_resume).
    _check_train_depth(torch, arms, (losses[0], gnorms[0]))
    if len(losses) != TRAIN_STEPS or not all(
            map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"train losses {losses}, grad norms {gnorms}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in training: {plain}")
    for k, n in need.items():
        if counts[k]["launches"] < n:
            raise AssertionError(f"{k} launched {counts[k]['launches']} "
                                 f"times in {steps} steps < {n}")
    _free(torch)
    rows = path_rows(torch, dev, "train", by_shape)
    log_rows("train", rows)
    return result, rows


# The train parity gates: the largest gradient gap between the plain arm
# and a kernel arm, each leaf's gap over its largest gradient, and their
# loss gap over the plain arm's loss (phase_train_parity).
TRAIN_PARITY_LIMIT = 2.0 ** -8
TRAIN_PARITY_LOSS_REL = 1e-6


def _grad_gap(torch, a, b) -> float:
    """The largest gap between two gradient trees, each leaf's over the
    largest magnitude of ``b``'s."""
    from repro_torch.tree import leaves
    return max(float((x - y).abs().max()) / float(y.abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def phase_train_parity(torch, dev):
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves

    cfg = _cut(get_config("internlm2-1.8b"), 2).replace(
        act_impl="ppa", compute_dtype="float32")
    params = init_params(param_specs(cfg), 0, device=dev)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch_at(0).items()}
    arms = {name: loss_and_grads(cfg, make_acts("ppa", name, dev), params,
                                 batch) for name in PARITY_ARMS}
    ref_acts = make_acts("ppa", "ref", dev)
    ref_loss, ref_grads = arms["ref"]
    gaps = {}
    for name in ("cuda_int", "cuda_fused"):
        loss, grads = arms[name]
        gaps[name] = (abs(float(loss) - float(ref_loss)),
                      _grad_gap(torch, grads, ref_grads))
    for name, d in PARITY_CONTROLS.items():
        acts = dc.replace(ref_acts, softmax=_moved_softmax(
            torch, dev, ref_acts.softmax, d))
        loss, grads = loss_and_grads(cfg, acts, params, batch)
        gaps[f"control {name}"] = (abs(float(loss) - float(ref_loss)),
                                   _grad_gap(torch, grads, ref_grads))
        del grads
    for name, (dl, dg) in gaps.items():
        log(f"[train_parity] {name} vs ref: loss gap {dl:.3e} (loss "
            f"{float(ref_loss):.6f}); largest gradient gap {dg:.3e} of its "
            "leaf's largest gradient")
    (li, gi), (lf, gf) = arms["cuda_int"], arms["cuda_fused"]
    same = bool(torch.equal(li, lf)) and all(
        torch.equal(x, y) for x, y in zip(leaves(gi), leaves(gf)))
    if not same:
        raise AssertionError(
            "cuda_int and cuda_fused differ: loss "
            f"{float(li)} vs {float(lf)}, gradient gap "
            f"{_grad_gap(torch, gi, gf)}")
    # The bound.  cuda_int and cuda_fused share every kernel but the PPA
    # activation's, which is exact: their loss and gradients must be
    # equal.  Against ref they differ in the softmax kernels (its forward
    # within SOFTMAX_ATOL, its backward within SOFTMAX_BWD_REL), which move
    # some quantized silu inputs by one step of their grid, as in the
    # serving parity.  Each gradient leaf is held to TRAIN_PARITY_LIMIT of
    # its largest magnitude, the loss to TRAIN_PARITY_LOSS_REL of ref's.
    # The controls (the ref arm with its softmax moved) calibrate the
    # limits, and those beyond SOFTMAX_ATOL must exceed both.  On an H100
    # the kernels gave gradient gaps of 1.48e-3 and loss gaps of 0, the
    # controls beyond the bound 3.8e-2 to 4.0e-1 and 2.3e-6 to 1.8e-5 of
    # the loss, at its edge 4.7e-3 and 2.4e-7 (PERF.md).
    loss_limit = TRAIN_PARITY_LOSS_REL * abs(float(ref_loss))
    for name in ("cuda_int", "cuda_fused"):
        if not gaps[name][1] <= TRAIN_PARITY_LIMIT:
            raise AssertionError(f"{name}: gradient gap {gaps[name][1]} > "
                                 f"{TRAIN_PARITY_LIMIT}")
        if not gaps[name][0] <= loss_limit:
            raise AssertionError(f"{name}: loss gap {gaps[name][0]} > "
                                 f"{loss_limit}")
    for name, d in PARITY_CONTROLS.items():
        dl, dg = gaps[f"control {name}"]
        if (d is None or d > SOFTMAX_ATOL) and not (
                dg > TRAIN_PARITY_LIMIT and dl > loss_limit):
            raise AssertionError(
                f"control {name}: gradient gap {dg} (limit "
                f"{TRAIN_PARITY_LIMIT}), loss gap {dl} (limit "
                f"{loss_limit}): not beyond both")
    log(f"[train_parity] internlm2-1.8b 2L float32, batch {TRAIN_BATCH} x "
        f"seq {TRAIN_SEQ}: cuda_int and cuda_fused equal (loss and every "
        f"gradient leaf); ref vs either {gaps['cuda_fused'][1]:.3e} <= "
        f"{TRAIN_PARITY_LIMIT} of each leaf's largest gradient and a loss "
        f"gap {gaps['cuda_fused'][0]:.3e} <= {TRAIN_PARITY_LOSS_REL} x loss"
        f" = {loss_limit:.3e}; every control beyond {SOFTMAX_ATOL} "
        "rejected by both")
    del arms
    _free(torch)


def phase_train_resume(torch, dev):
    """``launch/train.py`` (its ``main``) on the smoke config with PPA
    activations on the card: 30 steps, a checkpoint every 2.  The loss
    descends, and a run that exits after step 3 and then resumes gives the
    uninterrupted run's losses, bit for bit."""
    import shutil
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch.train import main as train_main

    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def run(name, *extra):
        return train_main(
            ["--arch", "internlm2-1.8b", "--smoke", "--act-impl", "ppa",
             "--steps", "30", "--batch", "4", "--seq", "64", "--opt",
             "adamw", "--ckpt-every", "2", "--device", str(dev),
             "--ckpt-dir", str(root / name), *extra])
    try:
        reset_counts()
        whole = run("whole")["losses"]
        try:
            run("crash", "--simulate-crash-at", "3")
        except SystemExit as e:
            if e.code != 42:
                raise
        else:
            raise AssertionError("the run did not crash at step 3")
        resumed = run("crash")["losses"]
        counts = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if not whole[-1] < whole[0]:
        raise AssertionError(f"the smoke run's loss did not descend: {whole}")
    if resumed != whole[2:]:
        raise AssertionError(f"resumed losses {resumed} != uninterrupted "
                             f"{whole[2:]}")
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    if any(plain.values()) or not all(
            counts[k]["launches"] for k in ("ppa_fused", "softmax_ppa",
                                            "softmax_ppa_bwd")):
        raise AssertionError(f"the smoke runs did not run the kernels "
                             f"alone: {counts}")
    log(f"[train_resume] smoke config, act_impl=ppa: uninterrupted losses "
        f"{whole[0]:.5f} -> {whole[-1]:.5f} over {len(whole)} steps; crashed"
        f" after step 3, resumed from step 2: {len(resumed)} losses equal "
        "to the uninterrupted run's bit for bit")


def phase_flash(torch, dev):
    """internlm2-1.8b at full width, 2 layers, bf16, one prompt of FLASH_T
    tokens through prefill with flash attention (chunks of FLASH_CHUNK),
    in the plain arm (``ref``) and the kernel arm (``cuda_fused``) on the
    same weights.  The fused kernel is exact and flash attention launches
    no softmax kernel, so the arms' final hidden states and logits must be
    equal.  Returns the kernel arm's launches of the fused kernel and its
    ``path_rows``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import (forward_hidden, init_params, make_acts,
                                    param_specs, prepare_params)
    from repro_torch.models.layers import lm_head_logits

    _free(torch)
    cfg = _cut(get_config("internlm2-1.8b"), 2).replace(
        act_impl="ppa", compute_dtype="bfloat16", attn_impl="flash",
        flash_chunk=FLASH_CHUNK)
    params = prepare_params(init_params(param_specs(cfg), 0,
                                        dtype=torch.bfloat16, device=dev),
                            cfg)
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, FLASH_T)), dtype=torch.int32, device=dev)
    out = {}
    with torch.inference_mode():
        for name in ("ref", "cuda_fused"):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            t0 = time.perf_counter()
            h = forward_hidden(params, cfg, {"tokens": prompt},
                               make_acts("ppa", name, dev))
            logits = lm_head_logits(h[:, -1], params["lm_head"])
            torch.cuda.synchronize()
            out[name] = (h, logits, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated(dev),
                         read_counts(), launched_shapes())
    (h_ref, l_ref, t_ref, m_ref, _, _), (h, lg, t_k, m_k, counts,
                                         by_shape) = out.values()
    gap_h = float((h.float() - h_ref.float()).abs().max())
    gap_l = float((lg - l_ref).abs().max())
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    chunk = by_shape["ppa_fused"].get(FLASH_FUSED_SHAPES["flash_chunk"], 0)
    rescale = by_shape["ppa_fused"].get(
        FLASH_FUSED_SHAPES["flash_rescale"], 0)
    need = cfg.n_layers * FLASH_T // FLASH_CHUNK
    log(f"[flash] internlm2-1.8b {cfg.n_layers}L bf16, one prompt of "
        f"{FLASH_T} tokens, chunks of {FLASH_CHUNK}: ref arm {t_ref:.3f}s, "
        f"{m_ref / 2**30:.2f} GiB peak; cuda_fused arm {t_k:.3f}s, "
        f"{m_k / 2**30:.2f} GiB peak; max |gap| hidden {gap_h:.3e}, last "
        f"logits {gap_l:.3e} (up to {float(l_ref.abs().max()):.3e}); fused "
        f"launches {counts['ppa_fused']['launches']}: {chunk} at the chunk "
        f"shape {FLASH_FUSED_SHAPES['flash_chunk']}, {rescale} at the "
        f"rescale shape; softmax kernel {counts['softmax_ppa']['launches']};"
        f" plain calls {plain}")
    del out, h, h_ref, params
    _free(torch)
    if gap_h != 0.0 or gap_l != 0.0:
        raise AssertionError(f"flash: cuda_fused differs from ref (hidden "
                             f"{gap_h}, logits {gap_l})")
    if chunk < need or rescale < need:
        raise AssertionError(f"flash: fused kernel launched {chunk} times "
                             f"at the chunk shape and {rescale} at the "
                             f"rescale shape, < layers x chunks = {need}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the kernel arm: "
                             f"{plain}")
    rows = path_rows(torch, dev, "flash", by_shape)
    log_rows("flash", rows)
    return {"ppa_fused": {"total": counts["ppa_fused"]["launches"]}}, rows


# -- the FQA compiler on the card ---------------------------------------------
#: the compile phase's store, under the checkout's ignored build/
STORE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_store"
#: worker processes of the numpy compiles, one table each
NUMPY_PROCESSES = 6
#: the workflow phase's hardware segment capacity and NAF
WORKFLOW_SEG_T = 16
WORKFLOW_NAF = "sigmoid"
#: the shipped JSON's field set (tests/test_torch_tables.py::FIELDS)
TABLE_FIELDS = ("naf", "interval", "cfg", "scheme", "starts_int", "a_int",
                "b_int", "mae_hard", "mae_t")
#: greedy tokens of the serve phases, by phase
TOKENS = {}


def _numpy_compile(naf: str, bits: int):
    """Compile one deployment table with the port's numpy backend in a
    worker process (spawned: it reaches no card), single-threaded;
    returns (JSON, seconds)."""
    import os
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"             # before numpy loads
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.compiler import CompileJob
    from repro_torch.models import ppa_table_jobs

    job = next(CompileJob(*j, search_backend="numpy")
               for j in ppa_table_jobs("ppa" if bits == 16 else "ppa8")
               if j[0] == naf)
    t0 = time.perf_counter()
    table = job.compile()
    return table.to_json(), time.perf_counter() - t0


def _numpy_compiles(jobs):
    """{naf: (table, seconds)} of ``jobs`` on the numpy backend, one
    single-threaded worker process a table (spawned, so that none inherits
    this process's CUDA context); every worker has ended on return."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.core import PPATable

    with ProcessPoolExecutor(
            max_workers=min(NUMPY_PROCESSES, len(jobs)),
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {naf: ex.submit(_numpy_compile, naf, cfg.w_out)
                for naf, cfg, _ in jobs}
        out = {}
        for naf, fut in futs.items():
            js, sec = fut.result()
            out[naf] = (PPATable.from_json(js), sec)
    return out


def phase_compile(torch, dev, card):
    """The six 16-bit deployment tables compiled on the card
    (``TorchSearchBackend``) through ``compile_or_load`` into a fresh
    store: each equal to the shipped JSON on its fields, and each equal
    (``table_identity``) to the port's numpy backend's compile of it on
    the host.  Returns the store."""
    import json as _json
    import shutil
    from repro_torch.compiler import (CompilerSession, TableStore,
                                      compile_table, table_identity)
    from repro_torch.core import FWLConfig, PPAScheme
    from repro_torch.core import searchspace
    from repro_torch.models import ppa_table_jobs
    from repro_torch.tables import table_path

    jobs = ppa_table_jobs("ppa")
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    store = TableStore(STORE_DIR)
    backend = searchspace.TorchSearchBackend(dev)
    # first use of the card's backend (allocator, library handles) outside
    # the timed compiles: a small order-2 table
    compile_table("sigmoid", FWLConfig(7, 7, (7, 7), (7, 7), 7),
                  PPAScheme(order=2), session=CompilerSession(),
                  search_backend=backend)
    torch.cuda.synchronize()
    card_tabs = {}
    for naf, cfg, scheme in jobs:
        before = dict(backend.counts)
        t0 = time.perf_counter()
        tab = store.compile_or_load(naf, cfg, scheme,
                                    search_backend=backend)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        cnt = {k: v - before[k] for k, v in backend.counts.items()}
        card_tabs[naf] = (tab, sec)
        shipped = _json.loads(table_path(naf, 16).read_text())
        got = _json.loads(tab.to_json())
        bad = [k for k in TABLE_FIELDS if got[k] != shipped[k]]
        if bad or sorted(shipped) != sorted(TABLE_FIELDS):
            raise AssertionError(f"{naf}-16 compiled on the card differs "
                                 f"from the shipped JSON in {bad}")
        evals = int(tab.stats["candidate_evals"])
        log(f"[compile] {naf}-16 FQA-O2 on the card (torch): "
            f"{tab.num_segments} segments, "
            f"{int(tab.stats['segment_evals'])} segment evaluations, "
            f"{evals} candidate evaluations in {sec:.3f} s = "
            f"{evals / sec:,.0f}/s; {cnt['dispatches']} dispatches "
            f"({cnt['blocks']} blocks, {cnt['lanes']} padded lanes); "
            f"equal to the shipped JSON; card {card}")
    if store.compiles != len(jobs):
        raise AssertionError(f"{store.compiles} compiles for {len(jobs)} "
                             "jobs into a fresh store")
    t0 = time.perf_counter()
    host = _numpy_compiles(jobs)
    wall = time.perf_counter() - t0
    total = {"torch": 0.0, "numpy": 0.0}
    for naf, _, _ in jobs:
        tab, sec = card_tabs[naf]
        ref, ref_sec = host[naf]
        if table_identity(ref) != table_identity(tab):
            raise AssertionError(f"{naf}-16: the numpy backend's table is "
                                 "not the card's")
        evals = int(tab.stats["candidate_evals"])
        if int(ref.stats["candidate_evals"]) != evals:
            raise AssertionError(f"{naf}-16: candidate evaluations differ "
                                 f"({evals} on the card, "
                                 f"{int(ref.stats['candidate_evals'])})")
        total["torch"] += sec
        total["numpy"] += ref_sec
        log(f"[compile] {naf}-16 on the host (numpy, one process of "
            f"{min(NUMPY_PROCESSES, len(jobs))}): {ref_sec:.3f} s = "
            f"{evals / ref_sec:,.0f} candidate evaluations/s; numpy's time "
            f"over the card's {ref_sec / sec:.2f}; table_identity equal")
    log(f"[compile] six 16-bit tables: card {total['torch']:.3f} s in all; "
        f"host numpy {total['numpy']:.3f} s summed over its processes, "
        f"{wall:.3f} s wall; store {store.stats()}; card {card}")
    return store


def phase_workflow(torch, dev, card):
    """The paper's Fig. 7 flow on the card's backend: sigmoid at SEG_t 16,
    order 1 and 2, through one ``CompilerSession``; the winner resolved
    twice through a store (the second a pure disk hit with no session
    call) and run through ``pack_table`` and ``ppa_apply`` on the card,
    ``cuda_fused`` and ``cuda_int`` each equal to its plain version."""
    import shutil
    from repro_torch.compiler import (CompilerSession, TableStore,
                                      table_identity)
    from repro_torch.core import (FWLConfig, PPAScheme, TorchSearchBackend,
                                  hardware_constrained_ppa)
    from repro_torch.kernels import pack_table, ppa_apply, ppa_gate
    from repro_torch.kernels import fused, ppa, ref

    root = STORE_DIR.parent / "chip_smoke_workflow"
    shutil.rmtree(root, ignore_errors=True)
    session = CompilerSession()
    backend = TorchSearchBackend(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    try:
        for order in (1, 2):
            cfg = FWLConfig(w_in=8, w_out=8, w_a=(8,) * order,
                            w_o=(8,) * order, w_b=8)
            scheme = PPAScheme(order=order, quantizer="fqa")
            t0 = time.perf_counter()
            res = hardware_constrained_ppa(
                WORKFLOW_NAF, cfg, scheme, seg_t=WORKFLOW_SEG_T,
                session=session, search_backend=backend)
            tab = res.table
            store = TableStore(root)
            dep = store.compile_or_load(
                WORKFLOW_NAF, cfg, scheme, mae_t=tab.mae_t,
                tseg=WORKFLOW_SEG_T, session=session, search_backend=backend)
            sec = time.perf_counter() - t0
            if table_identity(dep) != table_identity(tab):
                raise AssertionError(f"order {order}: the store's table is "
                                     "not the workflow's winner")
            before = session.counters()
            again = TableStore(root)
            hit = again.compile_or_load(
                WORKFLOW_NAF, cfg, scheme, mae_t=tab.mae_t,
                tseg=WORKFLOW_SEG_T, session=session)
            st = again.stats()
            if (session.counters() != before or st["hits_disk"] != 1
                    or st["misses"] or hit.to_json() != dep.to_json()):
                raise AssertionError(f"order {order}: the second resolution "
                                     f"was not a pure hit: {st}")
            tc = pack_table(dep, dev)
            span = tc.hi - tc.lo
            x_int = torch.arange(tc.lo - span, tc.hi + span, device=dev,
                                 dtype=torch.int32)
            if not torch.equal(ppa.ppa_eval_int(tc, x_int),
                               ref.ppa_eval_ref(x_int, tc.starts, tc.coefs,
                                                tc.plan)):
                raise AssertionError(f"order {order}: cuda_int != plain")
            x = torch.cat([torch.linspace(-1.5, 1.5, 4099, device=dev),
                           torch.randn(8192, generator=gen, device=dev)])
            checks = 0
            for dt in (torch.float32, torch.bfloat16):
                xd = x.to(dt)
                for op in (ppa_apply, ppa_gate):
                    want = op(tc, xd, backend="ref")
                    for be in ("cuda_fused", "cuda_int"):
                        got = op(tc, xd, backend=be)
                        checks += 1
                        if not torch.equal(got, want):
                            raise AssertionError(
                                f"order {order} {be} {op.__name__} {dt}: "
                                "!= plain")
                got = fused.ppa_fused_apply(tc, xd)
                if not torch.equal(got, fused.ppa_fused_plain(tc, xd)):
                    raise AssertionError(f"order {order} {dt}: fused != "
                                         "its plain version")
            xi = torch.linspace(-0.999, 0.999, 4096, device=dev)
            err = float((torch.sigmoid(xi) - ppa_apply(
                tc, xi, backend="cuda_fused")).abs().max())
            c = session.counters()
            log(f"[workflow] {WORKFLOW_NAF} order {order} {cfg} SEG_t="
                f"{WORKFLOW_SEG_T}: {tab.num_segments} segments, MAE_hard "
                f"{tab.mae_hard:.6e} in {res.iterations} iterations, "
                f"{sec:.3f} s on the card; session so far {c['calls']} "
                f"window requests, {c['misses']} scans, {c['hits']} hits, "
                f"{c['pruned']} pruned, {c['warm_hits']} warm, "
                f"{c['cand_evals']} candidate evaluations; second "
                f"resolution a disk hit with no session call; cuda_int "
                f"exact on {x_int.numel()} integers, cuda_fused and "
                f"cuda_int == plain in {checks} checks; max|sigmoid - T| on "
                f"[-0.999, 0.999] {err:.3e}; card {card}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_serve_store(torch, dev, card, store):
    """The serve phase through the compile phase's store.

    A stand-in until the serving engine takes ``table_store=``: the engine
    builds its own bundle from the shipped JSON, and ``_serve`` then puts
    the store's ``make_acts(store=...)`` bundle in its place.  Since
    ``_check_store_tables`` has already required the store's packed
    constants to equal the shipped ones, the token check can only pass;
    what this phase shows is that the store's tables pack identically and
    serve through the same kernels, not a store-fed engine."""
    if store is None:
        raise AssertionError("no store: the compile phase failed")
    return phase_serve(torch, dev, card, store)


def _check_store_tables(torch, dev, store):
    """The store's six 16-bit tables pack to the shipped tables'
    constants."""
    from repro_torch.compiler import CompileJob
    from repro_torch.kernels import pack_table
    from repro_torch.models import ppa_table_jobs
    from repro_torch.tables import load_table

    for naf, cfg, scheme in ppa_table_jobs("ppa"):
        tab = store.lookup(CompileJob(naf, cfg, scheme))
        if tab is None:
            raise AssertionError(f"{naf}-16 is not in the compile phase's "
                                 "store")
        a, b = pack_table(tab, dev), pack_table(load_table(naf, 16), dev)
        if (a.lo, a.hi, a.plan) != (b.lo, b.hi, b.plan) or not all(
                torch.equal(getattr(a, k), getattr(b, k))
                for k in ("starts", "coefs", "idx_lut", "val_lut")):
            raise AssertionError(f"{naf}-16: the store's packed constants "
                                 "differ from the shipped table's")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")
    failed = []
    rows = []

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
        paths = {
            "serve": run("serve", phase_serve, torch, dev, card),
            "serve_int": run("serve_int", phase_serve_int, torch, dev)}
        run("parity", phase_parity, torch, dev)
        paths["train"] = run("train", phase_train, torch, dev, card)
        run("train_parity", phase_train_parity, torch, dev)
        run("train_resume", phase_train_resume, torch, dev)
        paths["serve_moe"] = run("serve_moe", phase_serve_full, torch, dev,
                                 card, MOE_ARCH, "serve_moe")
        run("parity_moe", phase_parity, torch, dev, MOE_ARCH, 1,
            "parity_moe")
        paths["flash"] = run("flash", phase_flash, torch, dev)
        paths["serve_hybrid"] = run("serve_hybrid", phase_serve_full,
                                    torch, dev, card, HYBRID_ARCH,
                                    "serve_hybrid")
        run("parity_hybrid", phase_parity, torch, dev, HYBRID_ARCH, 1,
            "parity_hybrid", HYBRID_PARITY_STAGES)
        paths["serve_rwkv"] = run("serve_rwkv", phase_serve_full,
                                  torch, dev, card, RWKV_ARCH, "serve_rwkv")
        run("parity_rwkv", phase_parity, torch, dev, RWKV_ARCH, 2,
            "parity_rwkv")
        paths["serve_whisper"] = run("serve_whisper", phase_serve_full,
                                     torch, dev, card, WHISPER_ARCH,
                                     "serve_whisper")
        run("parity_whisper", phase_parity, torch, dev, WHISPER_ARCH,
            WHISPER_PARITY_LAYERS, "parity_whisper", None,
            WHISPER_PARITY_CACHE)
        paths["serve_vlm"] = run("serve_vlm", phase_serve_full, torch, dev,
                                 card, VLM_ARCH, "serve_vlm")
        run("parity_vlm", phase_parity, torch, dev, VLM_ARCH, 2,
            "parity_vlm")
        _free(torch)
        store = run("compile", phase_compile, torch, dev, card)
        run("workflow", phase_workflow, torch, dev, card)
        paths["serve_store"] = run("serve_store", phase_serve_store, torch,
                                   dev, card, store)
    log(f"[chip_smoke] all phases in {time.perf_counter() - t_start:.1f}s")
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    # each kernel's main path, whose run gives its "launches" and those at
    # its standing shapes; every path's launches are counted from 0 over
    # that path's run alone
    main_path = {"ppa_int": ("serve_int", "serve internlm2-1.8b 2L "
                             "cuda_int"),
                 "ppa_fused": ("serve", "serve internlm2-1.8b 24L "
                               "cuda_fused"),
                 "softmax_ppa": ("serve", "serve internlm2-1.8b 24L "
                                 "cuda_fused"),
                 "softmax_ppa_bwd": ("train", "train internlm2-1.8b 24L "
                                     "cuda_fused")}
    for r in rows:
        name = r["name"]
        path, r["path"] = main_path[name]
        launches = paths[path][0][name]
        r["launches"] = launches["total"]
        for label, t in r["shapes"].items():
            t["launches"] = launches.get(label, 0)
        r["launches_by_path"] = {p: out[name]["total"]
                                 for p, (out, _) in paths.items()
                                 if name in out}
        for _, path_shapes in paths.values():
            r["shapes"].update(path_shapes.get(name, {}))
    log(card_line())
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
