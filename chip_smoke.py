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
4b. serve_sharded  the serve phase's model cut to 4 layers at full
            width, served locally and with the same parameters and
            requests through ``ServeEngine(ctx=make_ctx(mesh))`` on a
            ("data", "model") DeviceMesh of (1, 1) over NCCL: every
            parameter a DTensor placed by the "serve" rules, the cache by
            ``cache_shardings``, the dense layers as DTensor ops between
            the reference's hints (``shard_hint``); the greedy tokens
            equal the local serve's exactly, the fused and softmax kernels
            launch at least layers x steps times, no plain version runs,
            the hints redistribute at least layers x steps times; decode
            ms beside the local serve's
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
            tokens/s, peak memory; then the same requests served again
            with the routed expert ids recorded (their tokens equal the
            timed run's; its decode ms is the sharded phase's yardstick)
11. serve_moe_sharded  moonshot at full width cut to its dense layer and
            3 MoE layers (random bf16 weights from seed 0), served locally
            with the routed expert ids recorded, then with the same
            parameters and requests through ``ServeEngine(ctx=make_ctx(
            mesh))`` on a ("data", "model") DeviceMesh of (1, 1) over an
            NCCL process group of one rank (a FileStore; no gloo), once
            with moe_mode="weight_gather" and once "token_gather": the
            greedy tokens and the routed expert ids of every MoE layer and
            call equal the local serve's exactly (its decode ms is the
            yardstick), every MoE layer of every step all-reduced over
            "model" and all-gathered over "data"
            (``distributed.collectives.counts``; one decode step's c10d
            ops seen under an ``OpCosts`` counter), the fused kernel
            launched at least layers x steps times, no plain version
12. roofline  untimed counting passes under ``roofline.OpCosts``: one
            decode step and one prefill group of the serve phase's
            internlm2-1.8b engine, one decode step of serve_moe's moonshot
            (and of serve_moe_sharded's 1 + 3-layer cut on the (1, 1)
            mesh) and the train phase's
            step 0: FLOPs, bytes, collective bytes, the three terms
            against the H100's published peaks (``HW_H100``), the
            bottleneck, model FLOPs and the decode's ideal bytes (active
            parameters in bf16 plus the KV cache), beside the phase's
            measured median step time and the share t_useful / measured;
            every kernel launch's self-reported bytes equal its bound's at
            its shape, as many reports as launches, and each decode's
            counted bytes at least its ideal bytes; no speed gate
12b. dryrun  the dry run (``launch/dryrun.py``, fake process groups and
            fake tensors; its four jobs run as CPU subprocesses from the
            start, beside the card's phases): the serve phase's decode step
            counted at mesh (1, 1) on fake tensors and on the card's real
            ones must agree exactly in FLOPs, bytes and each kernel's
            reported bytes; internlm2-1.8b decode_32k on the (16, 16) and
            (2, 16, 16) fake meshes must end ok, the multipod cell's
            argument bytes below the pod's; ``--hlo`` prints its tables
13. parity_moe  moonshot at full width, 2 layers (the dense one and one
            MoE), float32: the parity phase's three arms and controls; the
            routed expert ids of every layer and call equal in all arms
14. flash   internlm2-1.8b at full width, 2 layers, bf16, one prompt of
            16384 tokens, attn_impl="flash" with chunks of 1024: the
            cuda_fused arm's final hidden states and logits equal the ref
            arm's, the fused kernel launched at the chunk shape, no plain
            version in the kernel arm
15. serve_hybrid  full-width hymba-1.5b (32 layers in 5 stages: attention
            and a selective SSM in parallel, global attention at layers 0,
            15 and 31, windows of 1024 elsewhere; random bf16 weights from
            seed 0), act_impl="ppa", cuda_fused, the serve phase's engine
            and traffic: every request finishes at its length, prompts
            prefill at their exact lengths (no padding), the fused and
            softmax kernels launch at least layers x engine steps times
            and at each decode launch of every layer at every decode step
            (``decode_launches``), no plain version runs
16. parity_hybrid  hymba at full width, its first two stages (global
            and windowed attention) at 1 layer each, float32: the parity
            phase's three arms and controls (HYBRID_PARITY_STAGES)
17. serve_rwkv  full-width rwkv6-3b (32 layers, 40 heads of 64,
            attention-free) as serve_hybrid; the softmax never launches
18. parity_rwkv  rwkv at full width, 2 layers, float32: no softmax, so
            the three arms must be equal bit for bit
19. serve_whisper  full-width whisper-medium (a 24-layer encoder on 1500
            frames and 24 ``xdec`` layers: self-attention, cross attention
            to the encoder's output, a plain MLP with gelu; layernorm; random
            bf16 weights from seed 0), act_impl="ppa", cuda_fused, the serve
            phase's engine and traffic, each request with its own frame
            embeddings ``enc_feats`` N(0, 0.1) of (1500, 1024) from the
            seeded generator: as serve_hybrid, with the softmax at every
            self- and cross-attention launch of every decode step
20. parity_whisper  whisper at full width, 1 encoder and 1 decoder layer,
            float32, a float32 decode cache (WHISPER_PARITY_LAYERS): the
            parity phase's three arms and controls, the gelu table's
            inputs counted as the silu's are
21. serve_vlm  full-width internvl2-26b (48 ``dec`` layers of d_model 6144
            after 256 vision tokens, 36.99 GiB of bf16 weights), each
            request with its own patch embeddings ``vision_embeds`` N(0,
            0.02) of (256, 6144): as serve_whisper
22. parity_vlm  internvl at full width, 2 layers, float32, the vision
            prefix before each prompt: the parity phase's arms and controls
22b. train_hybrid, train_rwkv, train_whisper, train_moe  training at
            full width (float32 master weights from seed 0, bf16 compute,
            act_impl="ppa", cuda_fused, the config's remat "dots", adamw,
            4 steps): hymba-1.5b, all 32 layers, batch 2 x seq 2048 (its
            windows of 1024 mask; the softmax backward on the block path
            at (2, 5, 5, 2048, 2048)); rwkv6-3b, all 32 layers, 4 x 512
            (the decays through the fused kernel in the chunked scans
            under checkpoint; no softmax); whisper-medium, 24 + 24 layers,
            4 x 512 decoder tokens with ``enc_feats`` (4, 1500, 1024)
            drawn as the serving launcher draws a request's
            (``train_batch``, through ``make_train_step``; the block path
            at the encoder's (4, 16, 1, 1500, 1500) and the cross
            attention's (4, 16, 1, 512, 1500)); moonshot-v1-16b-a3b cut
            to 2 dense and 2 MoE layers of 64 experts, 4 x 512; the others
            through ``launch/train.py::run_training``.  Each: every loss
            and parameter norm finite, every gradient norm finite or inf
            as the reference's clip overflows (its float32 sum of
            squares; whisper's and hymba's at their random init: the
            update is then the weight decay only), no plain version run,
            per step at
            least layers x 2 launches of the fused kernel, and at each
            scores' shape attention layers x 2 of the softmax and
            attention layers of its backward; step ms, tokens/s, peak
            memory; step 0 counted under ``OpCosts`` (its roofline, every
            launch's reported bytes its bound's); then ``path_rows``
            under the masks the path's attention used
22c. train_parity_hybrid, _rwkv, _whisper, _moe  the train parity phase
            on each family at its serving parity's depth (hymba's first
            two stages of one layer, rwkv 2 layers, whisper 1 + 1,
            moonshot 1 dense + 1 MoE), float32, its train phase's batch:
            cuda_int equal to cuda_fused, each within the train parity
            limits of ref, and each control beyond them: the moved
            softmax, or on rwkv the decay table's outputs moved by a
            factor of 1 +- 1e-3 and 1 +- 1e-2 (``DECAY_CONTROLS``)
23. compile the FQA compiler on the card: the six 16-bit deployment tables
            (``ppa_table_jobs("ppa")``) compiled by ``TorchSearchBackend``
            through ``compile_or_load`` into a fresh store, each equal to
            the shipped JSON; then each compiled again by the port's numpy
            backend on the host (one spawned process a table), equal by
            ``table_identity`` with the same candidate evaluations; per
            table both wall times, candidate evaluations a second and the
            card's dispatches (one host sync each); the numpy compiles
            run in the three spawned processes that ``HostCompiles``
            starts after the build, beside the card's phases, and this
            phase waits for them
24. workflow  the paper's hardware-constrained flow (Fig. 7): sigmoid at
            SEG_t 16, order 1 and 2 (8-bit FWLs), on the card's backend
            through one CompilerSession; the winner resolved through a
            store twice, the second a disk hit with no session call, then
            packed on the card and run through ``ppa_apply``/``ppa_gate``
            on ``cuda_fused`` and ``cuda_int``, each equal to the plain
            version bit for bit
25. sweep   the six 8-bit deployment tables (``ppa_table_jobs("ppa8")``)
            compiled on ``TorchSearchBackend`` by ``run_shard`` on two
            simulated hosts at once (each its own store and a pool of
            spawned processes), merged, and by two spawned ``run_live``
            workers on one shared directory: each key compiled once in
            each mode by a spawned worker on the card (pid, backend and
            dispatches logged), every table equal to a serial numpy
            compile (``HostCompiles``, as the compile phase's) by
            ``table_identity`` and to the shipped ``*-8.json``;
            the tables are then merged into the compile phase's store;
            wall seconds, dispatches, candidate evaluations a second; then
            ``scripts/torch_sweep.py --preset smoke --hosts 2 --host-id
            {0,1} --backend torch`` as two subprocesses at once and its
            ``--merge-from``: the merged store equal to a serial numpy
            compile of the smoke grid by ``table_identity``, each key
            compiled on the card
26. tune    ``autotune(smoke=True)`` on the card into a fresh store and its
            verification, stage 3 included (the fused kernel's launch
            shape: each candidate's device time at the served model's
            decode and prefill gate, its output equal to the plain
            version's bit for bit); stage 3 again over all four
            candidates; the smoke grid through a store with and one
            without the tuned file: the same keys and tables (bytes equal
            but for the effort counters a speculation depth moves); a
            full-width internlm2-1.8b engine on the tuned store applies
            its ``fused_launch`` and gives the serve phase's tokens, the
            fused and softmax kernels launched at least layers x steps
            times and no plain version; the default launch is restored
27. serve_store  the serve phase through ``ServeEngine(table_store=<the
            compile phase's store>)``: the engine resolves its six tables
            there (hits, no compile), they pack to the shipped constants,
            the greedy tokens are the serve phase's and its launch gates
            hold
28. tenants one ``TenantFront`` on that store serving full-width
            internlm2-1.8b (24 layers, bf16) as tenant a (ppa) and b
            (ppa8), admitted warm, and c (ppa), admitted cold with
            ``serve.tenant.build`` armed and no exact fallback, on one set
            of parameters: 8 requests each to a and b interleaved, 2 to
            c, ``max_active`` 8; a and b give the greedy tokens of lone
            store-fed engines (a also the serve phase's), only c is
            degraded and its requests end ``tenant_degraded``, every pin
            of a and b survives, the fused and softmax kernels launch at
            least layers x steps times in each of a's and b's engines, no
            plain version runs; decode ms a step a tenant, warm admission
            seconds, peak memory
29. chaos   ``scripts/torch_chaos.py``'s three legs: the smoke grid's live
            sweep under three armed crash workers and a survivor, all
            spawned and scanning on the card (grid complete, artifacts
            byte-identical to a serial baseline, nothing quarantined, each
            key compiled exactly once on ``torch@cuda`` by the ledger); a
            merge worker killed mid-merge and a clean re-merge; full-width
            internlm2-1.8b (24 layers, bf16, ``ppa``) as tenants on the
            compile phase's store: a's greedy tokens equal a fault-free
            run's and the serve phase's, b (``serve.tenant.warm`` armed)
            alone degrades and rejects, c's expired request is reaped, the
            fused and softmax kernels launch at least layers x steps times
            in a's engine and no plain version runs; each leg's seconds

The kernels phase also holds the softmax backward kernel to its plain
version (SOFTMAX_BWD_REL) at the training and decode shapes and on rows of
1 to 4096 scores, and times it.  After each of serve, serve_int, train,
serve_moe, flash, serve_hybrid, serve_rwkv, serve_whisper, serve_vlm and
the four families' train phases, every input shape at which that run
launched the integer, fused or softmax kernel or the softmax's backward
(the fused kernel's by dtype, table and gate too: ``launched_shapes``) is
held to the plain version and timed beside its bound (``path_rows``), and
its row in the kernels line carries those launches (``launches_by_path``
adds the serve_moe_sharded, tune, serve_store, tenants and chaos runs).  The last two lines are a JSON
object with one entry per kernel, then ``{"ok": true, "device": {...}}``.
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

# The kernels' bounds on the H100 (its published peaks at 700 W) are the
# package's, whose formulas the kernel wrappers report their work to an
# OpCosts counter with (HBM_BYTES_PER_S is read by scripts/torch_*.py):
# this checkout's ``src`` first.
sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
from repro_torch.roofline.bounds import (  # noqa: E402,F401
    HBM_BYTES_PER_S, fused_bound, int_bound, softmax_bound,
    softmax_bwd_bound, table_bytes)

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
            f"bytes, registers {min(regs)}-{max(regs)} (entries by count: "
            f"{dict(sorted(collections.Counter(regs).items()))})")
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


def softmax_row(torch, gen, dev, softmax_ppa, e2, shape, plain: bool = True,
                masks=None):
    """The softmax kernel on scores of ``shape`` under each mask of
    ``masks`` ([(label, where)]; default: the attention mask): held to its
    plain version within SOFTMAX_ATOL under each, then timed beside its
    bound under the first; with ``plain``, also the plain version and
    torch's masked softmax (context: not the same function)."""
    x = torch.randn(shape, generator=gen, device=dev) * 4.0
    masks = masks or [("causal", attention_mask(torch, dev, shape))]
    err = 0.0
    for label, where in masks:
        d = float((softmax_ppa.softmax_ppa(x, e2, where)
                   - softmax_ppa.softmax_ppa_plain(x, e2, where)
                   ).abs().max())
        if not d <= SOFTMAX_ATOL:
            raise AssertionError(f"softmax_ppa vs plain at {shape}, "
                                 f"{label}: {d}")
        err = max(err, d)
    where = masks[0][1]
    big = x.numel() > 1 << 26
    ms, host = time_launch(lambda: softmax_ppa.softmax_ppa(x, e2, where),
                           iters=10 if big else 50)
    b_ms, b_by = softmax_bound(x.numel(), where.numel(), *_table_args(e2))
    row = dict(shape=list(shape), ms=ms, host_us=host, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, masked=True, max_abs_err=err,
               masks=[label for label, _ in masks])
    if plain:
        mask = where.expand(x.shape)
        row["plain_ms"] = time_ms(
            lambda: softmax_ppa.softmax_ppa_plain(x, e2, where),
            iters=3 if big else 10)
        row["context_masked_softmax_ms"], _ = time_launch(
            lambda: torch.softmax(x.masked_fill(~mask, float("-inf")),
                                  dim=-1), iters=10 if big else 50)
    return row


def softmax_bwd_row(torch, gen, dev, softmax_ppa, e2, shape,
                    plain: bool = True, masks=None):
    """The softmax backward kernel on scores of ``shape`` and a gradient
    under each mask of ``masks`` (as ``softmax_row``): held to its plain
    version within SOFTMAX_BWD_REL x max |g| under each, then timed beside
    its bound under the first; with ``plain``, also the plain version and
    torch's softmax backward (context: another function).  No one PyTorch
    call computes this one."""
    x = torch.randn(shape, generator=gen, device=dev) * 4.0
    g = torch.randn(shape, generator=gen, device=dev)
    masks = masks or [("causal", attention_mask(torch, dev, shape))]
    err = 0.0
    for label, where in masks:
        (d, lim), _ = _bwd_err(torch, softmax_ppa, e2, x, g, where)
        if not d <= lim:
            raise AssertionError(f"softmax_ppa_bwd vs plain at {shape}, "
                                 f"{label}: {d} > {lim}")
        err = max(err, d)
    where = masks[0][1]
    big = x.numel() > 1 << 26
    ms, host = time_launch(
        lambda: softmax_ppa.softmax_ppa_bwd(x, g, e2, where),
        iters=10 if big else 50)
    b_ms, b_by = softmax_bwd_bound(x.numel(), where.numel(),
                                   *_table_args(e2))
    row = dict(shape=list(shape), ms=ms, host_us=host, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, masked=True, max_abs_err=err,
               masks=[label for label, _ in masks])
    if plain:
        row["plain_ms"] = time_ms(
            lambda: softmax_ppa.softmax_ppa_bwd_plain(x, g, e2, where),
            iters=3 if big else 10)
        y = torch.softmax(x.masked_fill(~where.expand(shape),
                                        float("-inf")), dim=-1)
        row["context_softmax_backward_ms"], _ = time_launch(
            lambda: torch.ops.aten._softmax_backward_data(
                g, y, -1, torch.float32), iters=10 if big else 50)
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


def path_rows(torch, dev, path, by_shape, masks=None):
    """{kernel: {label: row}} for every input shape at which the run of
    ``path`` launched the integer, fused and softmax kernels and the
    softmax's backward (its ``launched_shapes``), each with its launches
    there.  A row is ``int_row``, ``fused_row``, ``softmax_row`` or
    ``softmax_bwd_row``: held to the plain version, then timed beside its
    bound.  The fused kernel's rows follow its variants: the run's dtype,
    table and gate at each shape, on inputs of the served model's scale,
    or on ``exp_neg`` the decays' and flash attention's nonnegative inputs
    (``flash_input``).  ``masks(shape)``: the masks the path's attention
    put on scores of that shape (default: the attention mask)."""
    from repro_torch.kernels import fused, ppa, softmax_ppa
    from repro_torch.kernels.ops import pack_table
    from repro_torch.tables import load_table

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tcs = {n: pack_table(load_table(n, 16), dev)
           for n in ("sigmoid_wide", "exp2_frac")}
    sig, e2 = tcs["sigmoid_wide"], tcs["exp2_frac"]
    out = {"ppa_int": {}, "ppa_fused": {}, "softmax_ppa": {},
           "softmax_ppa_bwd": {}}
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
    for name, row_fn in (("softmax_ppa", softmax_row),
                         ("softmax_ppa_bwd", softmax_bwd_row)):
        for shape, n in sorted(by_shape[name].items()):
            row = row_fn(torch, gen, dev, softmax_ppa, e2, shape,
                         masks=masks and masks(shape))
            out[name][f"{path} {shape}"] = dict(row, launches=n)
            _free(torch)
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
    attention mask at SOFTMAX_BWD_SHAPES (``softmax_bwd_row``), as
    ``kernel_times`` does."""
    return {label: softmax_bwd_row(torch, gen, dev, softmax_ppa, e2, shape,
                                   plain)
            for label, shape in SOFTMAX_BWD_SHAPES.items()}


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


def _requests(cfg, n_requests, max_new, lens, seed: int = 0):
    """``n_requests`` requests of ``lens`` prompt tokens from the seeded
    generator, each with the extras the launcher draws
    (``request_extras``: frame or patch embeddings, before each
    prompt)."""
    import numpy as np
    from repro_torch.launch.serve import request_extras
    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        extra = request_extras(cfg, rng) or None
        reqs.append(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, lens[i]).astype(np.int32),
            max_new_tokens=max_new, extra=extra))
    return reqs


def _serve(torch, dev, cfg, n_requests, max_new, lens, table_store=None,
           params=None, ctx=None):
    """Serve ``n_requests`` (``_requests``); returns (engine, requests,
    step times).  ``table_store``: the engine's ``TableStore`` (None: the
    shipped JSON); ``params``: the bf16 parameters (None: drawn from seed
    0); ``ctx``: the engine's ``ShardCtx``."""
    from repro_torch.distributed.collectives import \
        reset_counts as reset_collectives
    from repro_torch.kernels import reset_counts
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import hint_counts
    from repro_torch.serve import ServeEngine

    if params is None:
        params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                             device=dev)
    eng = ServeEngine(cfg, params, n_slots=SERVE_SLOTS,
                      cache_len=SERVE_CACHE_LEN, table_store=table_store,
                      ctx=ctx, device=dev)
    del params
    eng.warmup(sorted(set(lens)))
    reqs = _requests(cfg, n_requests, max_new, lens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    reset_collectives()
    hint_counts["redistributes"] = 0
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


#: the serve phases' prompt lengths
SERVE_LENS = [32, 128, 64, 96, 48, 128, 80, 112]


def phase_serve(torch, dev, card, store=None):
    """``store``: serve through ``ServeEngine(table_store=store)`` (the
    serve_store phase): the store's packed constants must be the shipped
    tables' and its greedy tokens the serve phase's."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts

    tag = "serve" if store is None else "serve_store"
    cfg = get_config("internlm2-1.8b").replace(
        act_impl="ppa", compute_dtype="bfloat16")
    if store is not None:
        _check_store_tables(torch, dev, store)
        before = store.stats()
    lens = SERVE_LENS[:SERVE_REQUESTS]
    eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                    SERVE_NEW, lens, store)
    if store is not None:
        st = store.stats()
        hits = sum(st[k] - before[k] for k in ("hits_mem", "hits_disk"))
        if hits < 6 or st["compiles"] != before["compiles"]:
            raise AssertionError(f"the engine did not resolve its six "
                                 f"tables through the store: {st}")
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
    if store is None:
        _count_serve(torch, eng, "internlm2-1.8b", dec_ms,
                     sorted(adm_ms)[len(adm_ms) // 2])
    if store is not None:
        log(f"[{tag}] ServeEngine(table_store=...) resolved its 6 tables "
            f"through the compile phase's store ({hits} hits, no compile); "
            f"they pack to the shipped constants; greedy tokens equal to "
            f"the serve phase's ({tokens} tokens); tuned {eng.tuned}")
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
    params = None
    if arch == MOE_ARCH:
        # kept for the second serve, which records the routes (52.9 GiB:
        # built once)
        from repro_torch.models import init_params, param_specs
        params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                             device=dev)
    eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                    SERVE_NEW, lens, params=params)
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
    if arch == MOE_ARCH:
        TOKENS[tag] = [list(r.output) for r in reqs]
        _count_serve(torch, eng, arch, dec_ms, None)
    del eng
    _free(torch)
    if arch == MOE_ARCH:
        ROUTES[tag], ROUTED_MS[tag] = _serve_routes(torch, dev, cfg, lens,
                                                    params, TOKENS[tag])
        log(f"[{tag}] served again with the routed ids recorded: "
            f"the same tokens, {ROUTES[tag].numel()} ids, decode "
            f"{ROUTED_MS[tag]:.2f} ms/step (median) with the recording on")
    del params
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


#: the routed expert ids of a serve run by tag and that run's median
#: decode ms with the recording on, and the roofline's counting passes by
#: name
ROUTES = {}
ROUTED_MS = {}
ROOFLINE = {}


class _recorded_routes:
    """Within the block, ``moe._route`` also records the routed expert ids
    of every MoE layer and call (on the card, one small copy each); the
    list is concatenated to one host tensor on exit."""

    def __init__(self, torch):
        self.torch, self.ids = torch, []

    def __enter__(self):
        from repro_torch.models import moe
        self.route = moe._route

        def recorded(x2, router, mcfg):
            out = self.route(x2, router, mcfg)
            self.ids.append(out[0].flatten().clone())
            return out

        moe._route = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._route = self.route
        if self.ids:
            self.ids = self.torch.cat(self.ids).cpu()
        return False


def _serve_routes(torch, dev, cfg, lens, params, tokens):
    """The routed expert ids of every MoE layer and call of a serve run,
    and its median decode ms with the recording on: the timed run's
    requests served again on a new engine with ``_recorded_routes`` on
    (so the timed run carries no recording); its greedy tokens must equal
    the timed run's ``tokens``."""
    with _recorded_routes(torch) as routes:
        eng, reqs, steps, _ = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                     SERVE_NEW, lens, params=params)
    del eng
    _free(torch)
    if [list(r.output) for r in reqs] != tokens:
        raise AssertionError("the untimed serve that records the routes "
                             "gave other tokens than the timed serve")
    decode = sorted(t for t, adm in steps if adm == 0)
    return routes.ids, decode[len(decode) // 2] * 1e3


def _cache_bytes(cache) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(cache))


def _count_serve(torch, eng, arch, dec_ms, prefill_ms, name=None):
    """The roofline's untimed counting passes over ``eng`` (drained): one
    decode step of all its slots on a fresh cache and, with
    ``prefill_ms``, one prefill of its largest group shape, each under an
    ``OpCosts`` counter; kept in ROOFLINE with the measured times and the
    decode's ideal bytes (active parameters in bf16 plus the KV cache, as
    the reference's dry run counts them)."""
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import (decode_step, init_cache, param_specs,
                                    prefill)
    from repro_torch.roofline import OpCosts, active_params
    cfg, dev = eng.cfg, eng.device
    name = name or arch
    n_active = active_params(cfg, param_specs(cfg))
    cache = eng._place_cache(init_cache(cfg, eng.n_slots, eng.cache_len,
                                        device=dev))
    toks = torch.zeros((eng.n_slots, 1), dtype=torch.int32, device=dev)
    pos = torch.full((eng.n_slots,), eng.cache_len // 2, dtype=torch.int32,
                     device=dev)
    reset_counts()
    with eng._no_grad(), OpCosts() as costs:
        decode_step(eng.params, cfg, cache, toks, pos, eng.acts, eng.ctx)
        torch.cuda.synchronize()
    ROOFLINE[f"{name} decode"] = dict(
        costs=costs, cfg=cfg, kind="decode", tokens=eng.n_slots,
        n_active=n_active, measured_ms=dec_ms, launches=read_counts(),
        ideal_bytes=n_active * 2 + _cache_bytes(cache),
        shape=f"decode {eng.n_slots} slots x cache {eng.cache_len}")
    del cache
    if prefill_ms is None:
        return
    blen, g = max(eng.prefill_shapes)
    feed = {"tokens": torch.zeros((g, blen), dtype=torch.int32, device=dev)}
    last = torch.full((g,), blen - 1, dtype=torch.long, device=dev)
    reset_counts()
    with eng._no_grad(), OpCosts() as costs:
        prefill(eng.params, cfg, feed, eng.cache_len, eng.acts,
                last_idx=last, ctx=eng.ctx)
        torch.cuda.synchronize()
    ROOFLINE[f"{name} prefill"] = dict(
        costs=costs, cfg=cfg, kind="prefill", tokens=g * blen,
        n_active=n_active, measured_ms=prefill_ms, launches=read_counts(),
        ideal_bytes=0.0, shape=f"prefill group {g} x {blen} tokens")


def _nccl_mesh(torch, dev):
    """A ("data", "model") DeviceMesh of shape (1, 1) over an NCCL process
    group of one rank, bootstrapped through a FileStore; NCCL's
    communicator is made at once (``device_id``), so a failed NCCL init
    fails here."""
    import os
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    path = STORE_DIR.parent / f"nccl_store_{os.getpid()}"
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.exists():
        path.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(path), 1),
                            rank=0, world_size=1, device_id=dev)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"process group backend {dist.get_backend()}")
    return init_device_mesh("cuda", (1, 1),
                            mesh_dim_names=("data", "model")), path


#: serve_sharded's cut of internlm2-1.8b at full width
SERVE_SHARDED_LAYERS = 4


def phase_serve_sharded(torch, dev, card):
    """internlm2-1.8b at full width cut to SERVE_SHARDED_LAYERS layers
    (parameters drawn from seed 0), served locally, then with the same
    parameters and requests through ``ServeEngine(ctx=make_ctx(mesh))`` on
    a ("data", "model") mesh of (1, 1) over NCCL: every parameter a
    DTensor placed by the "serve" rules, the cache by ``cache_shardings``,
    the dense layers as DTensor ops between the reference's hints
    (``shard_hint``).  Gates: the greedy tokens equal the local serve's
    exactly (at one rank every redistribute is the identity),
    ``ppa_fused`` and ``softmax_ppa`` launched at least layers x steps
    times and no plain version ran, the hints redistributed at least
    layers x steps times.  Returns the launches of each kernel."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_ctx
    from repro_torch.kernels import read_counts
    from repro_torch.models import init_params, param_specs
    from repro_torch.models.common import hint_counts

    cfg = _cut(get_config("internlm2-1.8b"), SERVE_SHARDED_LAYERS).replace(
        act_impl="ppa", compute_dtype="bfloat16")
    params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                         device=dev)
    lens = SERVE_LENS[:SERVE_REQUESTS]
    eng, local, steps, _ = _serve(torch, dev, cfg, SERVE_REQUESTS, SERVE_NEW,
                                  lens, params=params)
    decode = sorted(t for t, adm in steps if adm == 0)
    local_ms = decode[len(decode) // 2] * 1e3
    del eng
    mesh, store_path = _nccl_mesh(torch, dev)
    try:
        eng, reqs, steps, wall = _serve(torch, dev, cfg, SERVE_REQUESTS,
                                        SERVE_NEW, lens, params=params,
                                        ctx=make_ctx(mesh))
        counts, hints = read_counts(), hint_counts["redistributes"]
        placed = type(eng.params["embed"]).__name__
        del eng, params
        _free(torch)
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    toks = [list(r.output) for r in reqs]
    n_steps = len(steps)
    need = cfg.n_layers * n_steps
    decode = sorted(t for t, adm in steps if adm == 0)
    dec_ms = decode[len(decode) // 2] * 1e3
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    log(f"[serve_sharded] internlm2-1.8b {cfg.n_layers}L bf16 "
        f"act_backend={cfg.act_backend} on DeviceMesh (1, 1) ('data', "
        f"'model') over nccl, params as {placed}: {sum(map(len, toks))} "
        f"tokens in {wall:.3f}s over {n_steps} engine steps; decode "
        f"{dec_ms:.2f} ms/step (median) against the local serve's "
        f"{local_ms:.2f}; shard_hint redistributes {hints} "
        f"(layers x steps = {need}); launches fused="
        f"{counts['ppa_fused']['launches']} softmax="
        f"{counts['softmax_ppa']['launches']}; plain {plain}; card {card}")
    if placed != "DTensor":
        raise AssertionError(f"the parameters are {placed}, not DTensors")
    if toks != [list(r.output) for r in local]:
        raise AssertionError("greedy tokens differ from the local serve's")
    for k in ("ppa_fused", "softmax_ppa"):
        if counts[k]["launches"] < need:
            raise AssertionError(f"{k} launched {counts[k]['launches']} "
                                 f"times < layers x steps = {need}")
    if any(plain.values()):
        raise AssertionError(f"plain versions ran: {plain}")
    if hints < need:
        raise AssertionError(f"shard_hint redistributed {hints} times < "
                             f"layers x steps = {need}")
    return {k: {"total": counts[k]["launches"]}
            for k in ("ppa_fused", "softmax_ppa")}, {}


#: the dry run's decode cell on the card: the serve phase's slots and cache
DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 600
DRYRUN_JOBS = {
    "decode_fake": [
        "-c", "import json; from repro_torch.launch.dryrun import "
        f"decode_counts; print(json.dumps(decode_counts({DRYRUN_ARCH!r}, "
        f"{SERVE_SLOTS}, {SERVE_CACHE_LEN})))"],
    "pod": ["-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
            "--shape", "decode_32k", "--out", str(DRYRUN_DIR)],
    "multipod": ["-m", "repro_torch.launch.dryrun", "--arch", DRYRUN_ARCH,
                 "--shape", "decode_32k", "--multi-pod", "--out",
                 str(DRYRUN_DIR)],
    "hlo": ["-m", "repro_torch.analysis", "--hlo", DRYRUN_ARCH,
            "decode_32k"],
}


def dryrun_start():
    """Start the dry run's jobs, which need no card (a fake process
    group, fake tensors), as subprocesses beside the card's phases: the
    fake count of the serve phase's decode step at mesh (1, 1), the
    production cell on one pod and on two, and its ``--hlo`` audit.
    Returns {job: (process, start time, output file)}."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parent / "src"), CUDA_VISIBLE_DEVICES="")
    jobs = {}
    for name, argv in DRYRUN_JOBS.items():
        out = DRYRUN_DIR / f"{name}.log"
        f = open(out, "w")
        jobs[name] = (subprocess.Popen([sys.executable, *argv], stdout=f,
                                       stderr=subprocess.STDOUT, env=env),
                      time.perf_counter(), out, f)
    return jobs


def dryrun_stop(jobs) -> None:
    for p, _, _, f in jobs.values():
        if p.poll() is None:
            p.kill()
            p.wait()
        f.close()


def _dryrun_wait(jobs):
    """{job: (exit code, seconds, output)} once every job has ended."""
    out = {}
    for name, (p, t0, path, f) in jobs.items():
        try:
            rc = p.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S
                                    - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = "timeout"
        f.close()
        out[name] = (rc, time.perf_counter() - t0, path.read_text())
    return out


def phase_dryrun(torch, dev, card, jobs):
    """(a) The dry run against a real step: the serve phase's decode step
    of internlm2-1.8b (4 slots x cache 512) counted at mesh (1, 1) on
    fake tensors (a subprocess: a fake and an NCCL default group cannot
    share one process) and on the card's real tensors on an NCCL mesh of
    (1, 1), each under ``OpCosts``: FLOPs, bytes and each kernel's
    reported bytes equal exactly; the dry run's argument bytes are logged
    beside ``torch.cuda.memory_allocated`` for the same arguments.
    (b) The production cells: ``python -m repro_torch.launch.dryrun`` of
    internlm2-1.8b decode_32k on one pod and on two, and ``python -m
    repro_torch.analysis --hlo`` of it: exit 0, status ok, the multipod
    cell's argument bytes below the pod's."""
    import torch.distributed as dist
    from repro_torch.launch.dryrun import decode_counts

    res = _dryrun_wait(jobs)
    for name, (rc, sec, text) in res.items():
        log(f"[dryrun] {name}: exit {rc} in {sec:.1f}s (a subprocess "
            f"beside the card's phases)")
        if rc != 0:
            raise AssertionError(f"{name} failed:\n{text[-3000:]}")
    fake = json.loads(res["decode_fake"][2].strip().splitlines()[-1])
    _free(torch)
    mesh, store_path = _nccl_mesh(torch, dev)
    try:
        real = decode_counts(DRYRUN_ARCH, SERVE_SLOTS, SERVE_CACHE_LEN,
                             mesh=mesh, device=dev)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    _free(torch)
    log(f"[dryrun] (a) {DRYRUN_ARCH} decode {SERVE_SLOTS} slots x cache "
        f"{SERVE_CACHE_LEN} at mesh (1, 1): FLOPs fake {fake['flops']} "
        f"real {real['flops']}; bytes fake {fake['bytes']} real "
        f"{real['bytes']}; kernel launches fake {len(fake['kernels'])} real "
        f"{len(real['kernels'])}; counted in {fake['seconds']:.2f}s (fake, "
        f"CPU) and {real['seconds']:.2f}s (card); argument bytes "
        f"{fake['argument_bytes']} (dry run) beside "
        f"{real['allocated']} that placing the same arguments allocated on "
        f"the card (torch.cuda.memory_allocated; logged, no gate); card "
        f"{card}")
    for key in ("flops", "bytes", "kernels"):
        if fake[key] != real[key]:
            raise AssertionError(f"the dry run's {key} differ from the real "
                                 f"step's: {fake[key]!r:.300} against "
                                 f"{real[key]!r:.300}")
    recs = {tag: json.loads((DRYRUN_DIR / f"{DRYRUN_ARCH}__decode_32k__"
                             f"{tag}.json").read_text())
            for tag in ("pod", "multipod")}
    for tag, r in recs.items():
        if r["status"] != "ok":
            raise AssertionError(f"{tag}: status {r['status']}")
        rl, m = r["roofline"], r["memory"]
        log(f"[dryrun] (b) {DRYRUN_ARCH} decode_32k {tag} ({r['mesh']}, "
            f"{r['chips']} ranks): counted in {r['t_compile_s']:.1f}s; "
            f"args {m['argument_bytes'] / 2**30:.3f} GiB/dev, peak "
            f"{m['peak_bytes_per_device'] / 2**30:.3f} GiB/dev; FLOPs "
            f"{rl['hlo_flops']:.6e}, bytes {rl['hlo_bytes']:.6e}, "
            f"collectives {rl['coll_bytes']}; t_compute {rl['t_compute']:.6f}"
            f" s, t_memory {rl['t_memory']:.6f} s, t_collective "
            f"{rl['t_collective']:.6f} s -> {rl['bottleneck']}, roofline "
            f"fraction {rl['roofline_fraction']:.4f} (counted against the "
            f"H100's published peaks, not measured)")
    if not (recs["multipod"]["memory"]["argument_bytes"]
            < recs["pod"]["memory"]["argument_bytes"]):
        raise AssertionError("the multipod cell's argument bytes are not "
                             "below the pod's")
    hlo = res["hlo"][2]
    if "=== hlo memory:" not in hlo or "=== hlo collectives:" not in hlo:
        raise AssertionError(f"--hlo printed no tables:\n{hlo[-2000:]}")
    log("[dryrun] --hlo " + " | ".join(
        ln.strip() for ln in hlo.splitlines()[-16:] if ln.strip()))


#: serve_moe_sharded's cut of moonshot at full width: its dense layer and
#: this many MoE layers
MOE_SHARDED_MOE_LAYERS = 3


def _moe_sharded_cut(cfg):
    dense, moe = cfg.stages
    if dense.moe or dense.n_layers != 1 or not moe.moe:
        raise AssertionError(f"{cfg.arch}: not one dense stage of one "
                             f"layer and an MoE stage: {cfg.stages}")
    return cfg.replace(stages=(dense, dataclasses.replace(
        moe, n_layers=MOE_SHARDED_MOE_LAYERS)))


def phase_serve_moe_sharded(torch, dev, card):
    """moonshot at full width cut to its dense layer and
    MOE_SHARDED_MOE_LAYERS MoE layers (parameters drawn from seed 0),
    served locally with the routed expert ids recorded, then with the same
    parameters and requests through ``ServeEngine(ctx=make_ctx(mesh))``
    on a ("data", "model") mesh of (1, 1) over NCCL, once in each MoE
    mode: the greedy tokens and the routed expert ids equal the local
    serve's exactly (at one rank every collective is the identity), the
    collectives ran (their counts, and one decode step's c10d ops under an
    ``OpCosts`` counter), the fused kernel launched at least layers x steps
    times and no plain version ran.  The token_gather engine's decode step
    is counted for the roofline.  Returns the two runs' launches of each
    kernel."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import make_ctx
    from repro_torch.distributed import collectives
    from repro_torch.kernels import read_counts
    from repro_torch.models import init_params, param_specs

    _free(torch)
    base = _moe_sharded_cut(get_config(MOE_ARCH).replace(
        act_impl="ppa", compute_dtype="bfloat16", act_backend="cuda_fused"))
    params = init_params(param_specs(base), 0, dtype=torch.bfloat16,
                         device=dev)
    n_moe = sum(st.n_layers for st in base.stages if st.moe)
    lens = SERVE_LENS[:SERVE_REQUESTS]
    with _recorded_routes(torch) as local_routes:
        eng, reqs, steps, wall = _serve(torch, dev, base, SERVE_REQUESTS,
                                        SERVE_NEW, lens, params=params)
    local_toks = [list(r.output) for r in reqs]
    decode = sorted(t for t, adm in steps if adm == 0)
    local_ms = decode[len(decode) // 2] * 1e3
    del eng
    _free(torch)
    log(f"[serve_moe_sharded] {MOE_ARCH} cut to {base.n_layers}L (1 dense, "
        f"{n_moe} MoE) served locally, routes recorded: "
        f"{sum(map(len, local_toks))} tokens in {wall:.3f}s over "
        f"{len(steps)} engine steps, decode {local_ms:.2f} ms/step "
        f"(median), {local_routes.ids.numel()} routed expert ids; card "
        f"{card}")
    totals = collections.Counter()
    mesh, store_path = _nccl_mesh(torch, dev)
    try:
        ctx = make_ctx(mesh)
        for mode in ("weight_gather", "token_gather"):
            cfg = base.replace(moe_mode=mode)
            with _recorded_routes(torch) as routes:
                eng, reqs, steps, wall = _serve(
                    torch, dev, cfg, SERVE_REQUESTS, SERVE_NEW, lens,
                    params=params, ctx=ctx)
            counts, coll = read_counts(), dict(collectives.counts)
            for k in ("ppa_fused", "softmax_ppa"):
                totals[k] += counts[k]["launches"]
            n_steps = len(steps)
            decode = sorted(t for t, adm in steps if adm == 0)
            dec_ms = decode[len(decode) // 2] * 1e3
            toks = [list(r.output) for r in reqs]
            plain = {k: c["plain"] for k, c in counts.items()
                     if "plain" in c}
            log(f"[serve_moe_sharded] {MOE_ARCH} {cfg.n_layers}L moe_mode="
                f"{mode} on DeviceMesh {tuple(mesh.shape)} "
                f"{mesh.mesh_dim_names} over {dist.get_backend()}: "
                f"{sum(map(len, toks))} tokens in {wall:.3f}s over "
                f"{n_steps} engine steps, decode {dec_ms:.2f} ms/step "
                f"(median, routes recorded: the local serve's "
                f"{local_ms:.2f}); collectives {coll}; launches fused="
                f"{counts['ppa_fused']['launches']} softmax="
                f"{counts['softmax_ppa']['launches']}; plain {plain}; "
                f"card {card}")
            if toks != local_toks:
                raise AssertionError(f"{mode}: greedy tokens differ from "
                                     "the local serve's")
            need = cfg.n_layers * n_steps
            if counts["ppa_fused"]["launches"] < need:
                raise AssertionError(f"ppa_fused launched "
                                     f"{counts['ppa_fused']['launches']} "
                                     f"times < layers x steps = {need}")
            if any(plain.values()):
                raise AssertionError(f"plain versions ran: {plain}")
            # every MoE layer of every step all-reduces over "model" and
            # all-gathers over "data" (the weights, or the tokens)
            for kind in ("all-reduce", "all-gather"):
                if coll.get(kind, 0) < n_moe * n_steps:
                    raise AssertionError(
                        f"{mode}: {coll.get(kind, 0)} {kind} collectives "
                        f"< MoE layers x steps = {n_moe * n_steps}")
            if mode == "token_gather":
                name = f"{MOE_ARCH} {cfg.n_layers}L sharded (1, 1)"
                _count_serve(torch, eng, MOE_ARCH, dec_ms, None, name=name)
                seen = ROOFLINE[f"{name} decode"]["costs"].coll_bytes
                if not (seen.get("all-reduce") and seen.get("all-gather")):
                    raise AssertionError(f"the dispatcher saw no NCCL "
                                         f"collective: {dict(seen)}")
            del eng
            _free(torch)
            if not torch.equal(routes.ids, local_routes.ids):
                raise AssertionError(f"{mode}: routed expert ids differ "
                                     "from the local serve's")
            log(f"[serve_moe_sharded] {mode}: greedy tokens and "
                f"{routes.ids.numel()} routed expert ids equal to the local "
                f"serve's")
    finally:
        dist.destroy_process_group()
        store_path.unlink(missing_ok=True)
    del params
    _free(torch)
    # the two runs' launches, each counted from 0 over its own run
    return {k: {"total": n} for k, n in totals.items()}, {}


def _kernel_bytes_check(costs) -> int:
    """Each kernel launch's self-reported bytes against its bound's bytes
    at the launched shape; returns the launches checked."""
    for k in costs.kernels:
        n = 1
        for d in k["shape"]:
            n *= d
        table = table_bytes(k["segments"], k["order"])
        want = {"ppa_int": lambda: 8 * n + table,
                "ppa_fused": lambda: 2 * k["itemsize"] * n + table,
                "softmax_ppa": lambda: 8 * n + k["mask_bytes"] + table,
                "softmax_ppa_bwd":
                    lambda: 12 * n + k["mask_bytes"] + table}[k["kernel"]]()
        if k["bytes"] != want:
            raise AssertionError(f"{k['kernel']} at {k['shape']} reported "
                                 f"{k['bytes']} bytes, its bound's {want}")
    return len(costs.kernels)


def phase_roofline(torch, dev, card):
    """The roofline of the counted steps (``_count_serve``, the train
    phase's step 0): FLOPs, bytes, collective bytes, the three terms
    against the H100's published peaks, the bottleneck, model FLOPs, the
    decode's ideal bytes, beside the phase's measured step time and the
    share t_useful / measured.  Checks: every kernel launch of a pass
    reported bytes equal to its bound's at its shape, as many launches as
    the wrappers counted, and each decode's counted bytes at least its
    ideal bytes.  No speed gate."""
    from repro_torch.roofline import analyze_costs, model_flops

    want = {"internlm2-1.8b decode", "internlm2-1.8b prefill",
            f"{MOE_ARCH} decode", "internlm2-1.8b train"}
    if not want <= set(ROOFLINE):
        raise AssertionError(f"missing counting passes: "
                             f"{sorted(want - set(ROOFLINE))}")
    rows = []
    for name, e in ROOFLINE.items():
        costs = e["costs"]
        checked = _kernel_bytes_check(costs)
        launched = sum(c.get("launches", 0) for k, c in e["launches"].items()
                       if k != "ref")
        if checked != launched:
            raise AssertionError(f"{name}: {checked} kernel launches "
                                 f"reported, {launched} counted")
        r = analyze_costs(costs, arch=e["cfg"].arch, shape=e["shape"],
                          mesh_desc="1 card", chips=1,
                          model_fl=model_flops(e["n_active"], e["tokens"],
                                               e["kind"]),
                          ideal_bytes=e["ideal_bytes"])
        if e["kind"] == "decode" and costs.bytes < e["ideal_bytes"]:
            raise AssertionError(f"{name}: counted {costs.bytes} bytes < "
                                 f"ideal {e['ideal_bytes']}")
        d = r.as_dict()
        d.update(name=name, kernel_launches=checked,
                 kernel_ops=costs.kernel_ops,
                 t_useful=r.t_useful, measured_ms=e["measured_ms"],
                 measured_share=r.measured_share(e["measured_ms"] / 1e3),
                 top_bytes=collections.Counter(costs.op_bytes).most_common(6))
        rows.append(d)
        log(f"[roofline] {name} ({e['shape']}): FLOPs {costs.flops:.6e}, "
            f"bytes {costs.bytes:.6e}, collective bytes "
            f"{dict(costs.coll_bytes)}; t_compute {r.t_compute * 1e3:.4f} "
            f"ms, t_memory {r.t_memory * 1e3:.4f} ms, t_collective "
            f"{r.t_collective * 1e3:.4f} ms -> {r.bottleneck}; model_flops "
            f"{d['model_flops']:.6e}, ideal_bytes {e['ideal_bytes']:.6e}; "
            f"t_useful {r.t_useful * 1e3:.4f} ms against measured "
            f"{e['measured_ms']:.2f} ms = {d['measured_share']:.4f}; "
            f"{checked} kernel launches, bytes as their bounds'; "
            f"card {card}")
        log(f"[roofline] {name}: bytes by op {d['top_bytes']}; kernel "
            f"operations {costs.kernel_ops}")
    log(json.dumps({"roofline": rows, "card": card}, default=str))
    return rows


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
        log_every=1, device=dev, costs_step=0)
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
    # step 0 ran under the roofline's counter (not in the median); every
    # step launches the same kernels, so it launched a step's share
    c0 = out["costs"]
    from repro_torch.models import param_specs
    from repro_torch.roofline import active_params
    ROOFLINE["internlm2-1.8b train"] = dict(
        costs=c0, cfg=cfg, kind="train", tokens=tokens,
        n_active=active_params(cfg, param_specs(cfg)), measured_ms=med,
        ideal_bytes=0.0, shape=f"train batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, adamw", launches={
            k: {"launches": counts[k]["launches"] / len(losses)}
            for k in ("ppa_fused", "softmax_ppa", "softmax_ppa_bwd")})
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


# The train parity's controls on an attention-free model (rwkv): the ref
# arm with the decay table's outputs moved, each by a seeded factor of
# 1 +- d.  The fused kernel's decays equal its plain version's bit for bit,
# so every such move is beyond what the kernels may do, and the gate must
# reject each one.
DECAY_CONTROLS = {"x(1+-1e-3)": 1e-3, "x(1+-1e-2)": 1e-2}


def _moved_decay(torch, dev, decay, d, seed: int = 2):
    """A control: ``decay`` with each output moved by a factor of 1 +- d (a
    sign from ``seed``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def fn(x):
        y = decay(x)
        sign = torch.randint(0, 2, y.shape, generator=gen,
                             device=dev).to(y.dtype) * 2 - 1
        return y * (1 + d * sign)
    return fn


def train_batch(cfg, data, step: int, rng):
    """The train phases' batch at ``step``: the launcher's tokens
    (``data``, a ``SyntheticLM``) and, where the config has them, each
    row's stub frontend outputs drawn from ``rng`` as the serving launcher
    draws a request's (``launch.serve.request_extras``: whisper's frame
    embeddings N(0, 0.1) of (enc_seq, d_model)), stacked; numpy arrays."""
    import numpy as np
    from repro_torch.launch.serve import request_extras

    batch = dict(data.batch_at(step))
    rows = [request_extras(cfg, rng) for _ in range(data.global_batch)]
    for k in rows[0]:
        batch[k] = np.stack([r[k] for r in rows])
    return batch


def phase_train_parity(torch, dev, arch="internlm2-1.8b", per_stage=2,
                       tag="train_parity", stages=None, batch=TRAIN_BATCH,
                       seq=TRAIN_SEQ, catch="both"):
    """One train step's loss and gradients of ``arch`` at full width, each
    stage cut to ``per_stage`` layers and, with ``stages``, only the first
    ``stages`` stages kept, float32, through ref, cuda_int and cuda_fused
    on the same params and ``batch`` x ``seq`` (``train_batch``, seed 1
    for the frontend's extras): cuda_int and cuda_fused equal, each within
    the limits below of ref, and every control beyond the kernels' bounds
    (the moved softmax, PARITY_CONTROLS; on an attention-free model the
    moved decays, DECAY_CONTROLS) caught: with ``catch`` "both" beyond
    both limits, with "either" beyond at least one (the gate rejects it),
    and each limit exceeded by one of them at least."""
    import dataclasses as dc
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.train.train_step import loss_and_grads
    from repro_torch.tree import leaves

    _free(torch)
    cfg = _cut(get_config(arch), per_stage).replace(
        act_impl="ppa", compute_dtype="float32")
    cfg = cfg.replace(stages=cfg.stages[:stages])
    params = init_params(param_specs(cfg), 0, device=dev)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    feed = {k: torch.as_tensor(v, device=dev) for k, v in train_batch(
        cfg, data, 0, np.random.default_rng(1)).items()}
    arms = {name: loss_and_grads(cfg, make_acts("ppa", name, dev), params,
                                 feed) for name in PARITY_ARMS}
    ref_acts = make_acts("ppa", "ref", dev)
    ref_loss, ref_grads = arms["ref"]
    gaps = {}
    for name in ("cuda_int", "cuda_fused"):
        loss, grads = arms[name]
        gaps[name] = (abs(float(loss) - float(ref_loss)),
                      _grad_gap(torch, grads, ref_grads))
    attn = any(st.kind != "rwkv" for st in cfg.stages)
    if attn:
        controls = {name: (d is None or d > SOFTMAX_ATOL, dc.replace(
            ref_acts, softmax=_moved_softmax(torch, dev, ref_acts.softmax,
                                             d)))
            for name, d in PARITY_CONTROLS.items()}
    else:
        controls = {name: (True, dc.replace(ref_acts, exp_decay=_moved_decay(
            torch, dev, ref_acts.exp_decay, d)))
            for name, d in DECAY_CONTROLS.items()}
    for name, (_, acts) in controls.items():
        loss, grads = loss_and_grads(cfg, acts, params, feed)
        gaps[f"control {name}"] = (abs(float(loss) - float(ref_loss)),
                                   _grad_gap(torch, grads, ref_grads))
        del grads
    desc = (f"{arch} {[(st.kind, st.n_layers) for st in cfg.stages]}"
            + (f" + encoder {cfg.enc_layers}L" if cfg.enc_layers else "")
            + f" float32, batch {batch} x seq {seq}")
    for name, (dl, dg) in gaps.items():
        log(f"[{tag}] {desc}: {name} vs ref: loss gap {dl:.3e} (loss "
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
    # internlm2's kernels gave gradient gaps of 1.48e-3 and loss gaps of
    # 0, the controls beyond the bound 3.8e-2 to 4.0e-1 and 2.3e-6 to
    # 1.8e-5 of the loss, at its edge 4.7e-3 and 2.4e-7 (PERF.md).
    loss_limit = TRAIN_PARITY_LOSS_REL * abs(float(ref_loss))
    for name in ("cuda_int", "cuda_fused"):
        if not gaps[name][1] <= TRAIN_PARITY_LIMIT:
            raise AssertionError(f"{name}: gradient gap {gaps[name][1]} > "
                                 f"{TRAIN_PARITY_LIMIT}")
        if not gaps[name][0] <= loss_limit:
            raise AssertionError(f"{name}: loss gap {gaps[name][0]} > "
                                 f"{loss_limit}")
    over = {name: (gaps[f"control {name}"][1] > TRAIN_PARITY_LIMIT,
                   gaps[f"control {name}"][0] > loss_limit)
            for name, (beyond, _) in controls.items() if beyond}
    for name, (g_over, l_over) in over.items():
        dl, dg = gaps[f"control {name}"]
        if not (g_over and l_over if catch == "both" else g_over or l_over):
            raise AssertionError(
                f"control {name}: gradient gap {dg} (limit "
                f"{TRAIN_PARITY_LIMIT}), loss gap {dl} (limit "
                f"{loss_limit}): not beyond {catch}")
    if not (any(g for g, _ in over.values())
            and any(l_ for _, l_ in over.values())):
        raise AssertionError(f"no control beyond the gradient limit and "
                             f"one beyond the loss limit: {over}")
    log(f"[{tag}] {desc}: cuda_int and cuda_fused equal (loss and every "
        f"gradient leaf); ref vs either {gaps['cuda_fused'][1]:.3e} <= "
        f"{TRAIN_PARITY_LIMIT} of each leaf's largest gradient and a loss "
        f"gap {gaps['cuda_fused'][0]:.3e} <= {TRAIN_PARITY_LOSS_REL} x loss"
        f" = {loss_limit:.3e}; every control beyond the kernels' bounds "
        f"({', '.join(over)}) beyond {catch} limits")
    del arms, params
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


# The families' train phases: (arch, batch, seq, depth: None for every
# layer, or the layers each stage is cut to), TRAIN_FAMILY_STEPS steps of
# adamw each.  hymba's sequence of 2048 makes its windows of 1024 mask.
TRAIN_FAMILY_STEPS = 4
TRAIN_FAMILIES = {
    "train_hybrid": (HYBRID_ARCH, 2, 2048, None),
    "train_rwkv": (RWKV_ARCH, 4, 512, None),
    "train_whisper": (WHISPER_ARCH, 4, 512, None),
    "train_moe": (MOE_ARCH, 4, 512, 2),
}


def attention_rows(cfg, batch: int, seq: int):
    """{scores' shape (B, Hk, G, T, S): attention layers that take it} of
    one forward of ``cfg`` at ``batch`` x ``seq``: the decoder's
    self-attention, whisper's cross attention to its encoder's frames and
    the encoder's self-attention."""
    g = cfg.n_q // cfg.n_kv
    out = collections.Counter()
    for st in cfg.stages:
        if st.kind == "rwkv":
            continue
        out[(batch, cfg.n_kv, g, seq, seq)] += st.n_layers
        if st.kind == "xdec":
            out[(batch, cfg.n_kv, g, seq, cfg.enc_seq)] += st.n_layers
    if cfg.enc_layers:
        out[(batch, cfg.n_kv, g, cfg.enc_seq, cfg.enc_seq)] += cfg.enc_layers
    return out


def train_masks(torch, dev, cfg, shape):
    """[(label, mask)] of the masks ``cfg``'s attention puts on scores of
    ``shape`` (B, Hk, G, T, S), as (B, 1, 1, T, S) bool: every key valid
    against the encoder's frames, causal on the decoder's own tokens, and
    causal within each window its stages use."""
    b, t, s = shape[0], shape[-2], shape[-1]
    if s == cfg.enc_seq and cfg.enc_layers:
        return [("every key", torch.ones((b, 1, 1, t, s), dtype=torch.bool,
                                         device=dev))]
    qp = torch.arange(t, device=dev)[:, None]
    kp = torch.arange(s, device=dev)[None, :]
    out = []
    for w in sorted({st.window for st in cfg.stages},
                    key=lambda w: w or 0):
        valid = kp <= qp
        if w is not None:
            valid = valid & (kp > qp - w)
        out.append(("causal" if w is None else f"causal, window {w}",
                    valid[None, None, None].expand(b, 1, 1, t, s)))
    return out


def _train_loop(torch, dev, cfg, batch, seq, steps, tcfg):
    """``steps`` steps of ``make_train_step`` on ``train_batch`` (seed 0
    for the frontend's extras), step 0 under an ``OpCosts`` counter: what
    ``run_training`` returns, for a batch with the frontend's extras,
    which the launcher does not draw."""
    import numpy as np
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params, make_acts, param_specs
    from repro_torch.models.transformer import dtype_of
    from repro_torch.roofline import OpCosts
    from repro_torch.train import make_train_step, train_init

    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    rng = np.random.default_rng(0)
    params = init_params(param_specs(cfg), 0, dtype_of(cfg.param_dtype),
                         device=dev)
    tstate = train_init(tcfg, params)
    step_fn = make_train_step(cfg, tcfg, make_acts(cfg.act_impl,
                                                   cfg.act_backend, dev))
    out = {"losses": [], "grad_norms": [], "param_norms": [], "step_s": [],
           "costs": None}
    for step in range(steps):
        feed = {k: torch.as_tensor(v, device=dev)
                for k, v in train_batch(cfg, data, step, rng).items()}
        t0 = time.perf_counter()
        if step == 0:
            with OpCosts() as out["costs"]:
                params, tstate, metrics = step_fn(params, tstate, feed)
        else:
            params, tstate, metrics = step_fn(params, tstate, feed)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        out["param_norms"].append(float(metrics["param_norm"]))
        out["step_s"].append(time.perf_counter() - t0)
    return out


#: the families' train parity: (arch, layers a stage, stages kept) as
#: their serving parities cut them.  Their gate must catch each control
#: beyond the kernels' bounds by either limit (internlm2's ``train_parity``
#: by both): on moonshot's cut the +-1e-5 control moved the gradients by
#: 0.22 of a leaf's largest, the loss by 6.7e-6 of a limit of 1.24e-5
#: (NVIDIA H100 80GB HBM3, 700.00 W)
TRAIN_PARITY_FAMILIES = {
    "train_parity_hybrid": (HYBRID_ARCH, 1, HYBRID_PARITY_STAGES),
    "train_parity_rwkv": (RWKV_ARCH, 2, None),
    "train_parity_whisper": (WHISPER_ARCH, WHISPER_PARITY_LAYERS, None),
    "train_parity_moe": (MOE_ARCH, 1, None),
}


def _check_train_norms(tag, steps, out):
    """Every loss and parameter norm finite, and every gradient norm
    finite or +inf.  An inf norm is the reference's own clip at a norm
    beyond about 1.8e19 (whisper-medium's and hymba-1.5b's at their random
    init): its float32 sum of squares overflows and it scales every
    gradient to 0, so the step moves only the weight decay.  A NaN or inf
    gradient entry would make the norm NaN, or the clipped entry (inf x 0)
    and so the parameters after the step NaN: a finite parameter norm
    after the step shows the gradients were finite."""
    import math
    losses, gnorms, pnorms = (out["losses"], out["grad_norms"],
                              out["param_norms"])
    if (len(losses) != steps or len(pnorms) != steps
            or not all(map(math.isfinite, losses + pnorms))
            or not all(math.isfinite(g) or g == math.inf for g in gnorms)):
        raise AssertionError(f"{tag}: losses {losses}, grad norms {gnorms}, "
                             f"parameter norms after each step {pnorms}")
    zeroed = [i for i, g in enumerate(gnorms) if g == math.inf]
    log(f"[{tag}] parameter norms after each step {pnorms}, all finite; "
        f"steps whose float32 gradient norm overflowed (the reference's "
        f"clip: every gradient scaled to 0, the update only the weight "
        f"decay) {zeroed}")


def phase_train_family(torch, dev, card, tag):
    """Full-width training of TRAIN_FAMILIES[``tag``] (float32 master
    weights from seed 0, bf16 compute, act_impl="ppa", cuda_fused, the
    config's remat, adamw), TRAIN_FAMILY_STEPS steps through the
    launcher's ``run_training``, or, for a batch with the frontend's
    extras (whisper's ``enc_feats``), ``make_train_step`` on
    ``train_batch``: every loss finite and every gradient norm finite or
    the reference's float32 overflow (``_check_train_norms``), no plain
    version run, and per step at least layers x (1 + recomputes)
    launches of the fused kernel, attention layers x (1 + recomputes) of the softmax at
    each scores' shape and attention layers of its backward there; step
    ms, tokens/s, peak memory; step 0 under an ``OpCosts`` counter (the
    roofline of the step, every kernel launch's reported bytes its
    bound's).  Returns the launches of each kernel and ``path_rows`` of
    this run."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.launch.train import run_training
    from repro_torch.models import param_specs
    from repro_torch.roofline import active_params, analyze_costs, \
        model_flops
    from repro_torch.train import OptCfg, ScheduleCfg, TrainCfg

    arch, batch, seq, depth = TRAIN_FAMILIES[tag]
    cfg = get_config(arch).replace(act_impl="ppa", act_backend="cuda_fused")
    if depth is not None:
        cfg = _cut(cfg, depth)
    if (cfg.param_dtype, cfg.compute_dtype) != ("float32", "bfloat16"):
        raise AssertionError(f"{tag} wants float32 master weights and bf16 "
                             f"compute, got {cfg}")
    steps = TRAIN_FAMILY_STEPS
    sched = ScheduleCfg(peak_lr=3e-4, warmup_steps=2)
    _free(torch)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    if cfg.enc_layers or cfg.vision_tokens:
        out = _train_loop(torch, dev, cfg, batch, seq, steps, TrainCfg(
            opt=OptCfg(kind="adamw"), sched=sched))
        entry = "train/train_step.py::make_train_step on train_batch"
    else:
        out = run_training(
            cfg, steps=steps, ckpt_dir=None, resume="none", ckpt_every=0,
            batch_override=batch, seq_override=seq, opt_kind="adamw",
            sched=sched, log_every=1, device=dev, costs_step=0)
        entry = "launch/train.py::run_training"
    counts, by_shape = read_counts(), launched_shapes()
    mem = torch.cuda.max_memory_allocated(dev)
    losses, gnorms = out["losses"], out["grad_norms"]
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    forwards = 1 + (cfg.remat in ("dots", "full"))
    layers = cfg.n_layers + cfg.enc_layers
    rows_at = attention_rows(cfg, batch, seq)
    need = {"ppa_fused": layers * steps * forwards}
    need_at = {("softmax_ppa", shape): n * steps * forwards
               for shape, n in rows_at.items()}
    need_at.update({("softmax_ppa_bwd", shape): n * steps
                    for shape, n in rows_at.items()})
    step_ms = [t * 1e3 for t in out["step_s"]]
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    tokens = batch * seq
    stages = [(st.kind, st.n_layers) + ((f"window {st.window}",)
                                        if st.window else ())
              + (("moe",) if st.moe else ()) for st in cfg.stages]
    front = (f", encoder {cfg.enc_layers}L on {cfg.enc_seq} frames "
             f"(enc_feats ({batch}, {cfg.enc_seq}, {cfg.d_model}))"
             if cfg.enc_layers else "")
    log(f"[{tag}] {arch} {cfg.n_layers}L {stages}{front} d_model "
        f"{cfg.d_model} vocab {cfg.vocab}, float32 master weights, bf16 "
        f"compute, act_impl=ppa act_backend={cfg.act_backend} "
        f"remat={cfg.remat}, adamw, batch {batch} x seq {seq} through "
        f"{entry}: losses {losses}; grad norms before clipping "
        f"{[f'{g:.3e}' for g in gnorms]}")
    log(f"[{tag}] step ms {[round(t, 2) for t in step_ms]}; median of steps"
        f" 2-{steps} {med:.2f} ms = {tokens / med * 1e3:.1f} tokens/s; "
        f"max_memory_allocated {mem / 2**30:.2f} GiB; card {card}")
    log(f"[{tag}] launches {dict((k, c['launches']) for k, c in counts.items() if k != 'ref')}"
        f" by shape {dict((k, v) for k, v in by_shape.items() if k != 'ppa_fused_variants')};"
        f" at least {need} and per scores' shape {need_at} (layers x steps,"
        f" the forward kernels x{forwards} for the recompute under remat="
        f"{cfg.remat}); plain calls {plain}")
    # step 0 ran under the roofline's counter; every step launches the
    # same kernels
    costs = out["costs"]
    checked = _kernel_bytes_check(costs)
    launched = sum(counts[k]["launches"] for k in
                   ("ppa_fused", "softmax_ppa", "softmax_ppa_bwd"))
    r = analyze_costs(costs, arch=arch, shape=f"train batch {batch} x seq "
                      f"{seq}, adamw", mesh_desc="1 card", chips=1,
                      model_fl=model_flops(active_params(
                          cfg, param_specs(cfg)), tokens, "train"))
    log(f"[{tag}] step 0 counted: FLOPs {costs.flops:.6e}, bytes "
        f"{costs.bytes:.6e}; t_compute {r.t_compute * 1e3:.4f} ms, t_memory "
        f"{r.t_memory * 1e3:.4f} ms -> {r.bottleneck}; t_useful "
        f"{r.t_useful * 1e3:.4f} ms against the median step {med:.2f} ms = "
        f"{r.measured_share(med / 1e3):.4f}; {checked} kernel launches, "
        f"bytes as their bounds'; bytes by op "
        f"{collections.Counter(costs.op_bytes).most_common(6)}; card {card}")
    _check_train_norms(tag, steps, out)
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in {tag}: {plain}")
    if checked * steps != launched:
        raise AssertionError(f"{tag}: step 0 reported {checked} kernel "
                             f"launches, the run launched {launched} in "
                             f"{steps} steps")
    for k, n in need.items():
        if counts[k]["launches"] < n:
            raise AssertionError(f"{k} launched {counts[k]['launches']} "
                                 f"times in {steps} steps < {n}")
    for (k, shape), n in need_at.items():
        if by_shape[k].get(shape, 0) < n:
            raise AssertionError(f"{k} launched {by_shape[k].get(shape, 0)}"
                                 f" times at {shape} in {steps} steps < {n}")
    if not rows_at and (counts["softmax_ppa"]["launches"]
                        or counts["softmax_ppa_bwd"]["launches"]):
        raise AssertionError(f"{tag}: the softmax launched in an "
                             "attention-free model")
    del out, costs
    _free(torch)
    rows = path_rows(torch, dev, tag, by_shape, masks=functools.partial(
        train_masks, torch, dev, cfg))
    log_rows(tag, rows)
    return {k: {"total": counts[k]["launches"]}
            for k in ("ppa_fused", "softmax_ppa", "softmax_ppa_bwd")}, rows


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


#: spawned processes that compile the compile and sweep phases' host
#: references (the numpy backend) beside the card's phases, from the start
#: of the run; the tables in the order they are handed out, the longest
#: first (by their compile times on the numpy backend)
HOST_PROCESSES = 3
HOST_TABLES = (("exp_neg", 16), ("softplus", 16), ("sigmoid_wide", 16),
               ("tanh_wide", 16), ("gelu_inner", 16), ("softplus", 8),
               ("sigmoid_wide", 8), ("exp_neg", 8), ("gelu_inner", 8),
               ("tanh_wide", 8), ("exp2_frac", 16), ("exp2_frac", 8))
#: how long a phase waits for a host table
HOST_TIMEOUT_S = 600


class HostCompiles:
    """The numpy backend's compiles of the six 16-bit (compile phase) and
    six 8-bit (sweep phase) deployment tables, started after the build in
    HOST_PROCESSES spawned single-threaded processes (spawned: none
    inherits this process's CUDA context), beside the card's phases; a
    phase waits for its tables (``get``).  ``stop`` ends every process."""

    def __init__(self):
        import multiprocessing
        import os
        self.t0 = time.perf_counter()
        self.done = {}
        threads = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                   "MKL_NUM_THREADS")
        saved = {k: os.environ.get(k) for k in threads}
        os.environ.update({k: "1" for k in threads})   # the workers' own
        try:
            self.pool = multiprocessing.get_context("spawn").Pool(
                HOST_PROCESSES)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        self.res = {key: self.pool.apply_async(
            _numpy_compile, key, callback=functools.partial(self._done, key))
            for key in HOST_TABLES}
        log(f"[host] {HOST_PROCESSES} spawned processes compile the "
            f"{len(HOST_TABLES)} deployment tables on the numpy backend "
            f"beside the card's phases; os.cpu_count() {os.cpu_count()}")

    def _done(self, key, _):
        self.done[key] = time.perf_counter() - self.t0

    def get(self, jobs, bits):
        """({naf: (table, seconds)} of ``jobs`` at ``bits``, the seconds
        this call waited, and a log line of when each was done)."""
        from repro_torch.core import PPATable
        t0 = time.perf_counter()
        out = {}
        for naf, _, _ in jobs:
            js, sec = self.res[(naf, bits)].get(timeout=HOST_TIMEOUT_S)
            out[naf] = (PPATable.from_json(js), sec)
        waited = time.perf_counter() - t0
        line = (f"host arm ({HOST_PROCESSES} processes beside the card's "
                f"phases): the {bits}-bit tables done at "
                + ", ".join(f"{naf} {self.done.get((naf, bits), 0.0):.1f} s"
                            for naf, _, _ in jobs)
                + f" after their start, {sum(s for _, s in out.values()):.3f}"
                f" s of compiling; this phase waited {waited:.3f} s for them")
        return out, waited, line

    def stop(self) -> None:
        self.pool.terminate()
        self.pool.join()


#: the compile phase's tables compiled in a spawned process on the card
#: while this one compiles the others: about half the dispatches each
#: (52,084 against 62,964, the counts the phase logs).  The card serves two
#: processes' dispatches at about 1.4 times one's rate (the sweep phase's
#: two modes).
COMPILE_SPAWNED = ("exp_neg", "exp2_frac")


def _first_use(backend) -> None:
    """The card's backend's first use (allocator, library handles)
    outside the timed compiles: a small order-2 table."""
    from repro_torch.compiler import CompilerSession, compile_table
    from repro_torch.core import FWLConfig, PPAScheme
    compile_table("sigmoid", FWLConfig(7, 7, (7, 7), (7, 7), 7),
                  PPAScheme(order=2), session=CompilerSession(),
                  search_backend=backend)


def _card_compiles(nafs, store_dir):
    """The 16-bit deployment tables of ``nafs`` compiled on the card's
    ``TorchSearchBackend`` through ``compile_or_load`` into the store at
    ``store_dir`` (in this process or a spawned one); returns {"tables":
    {naf: (JSON, seconds, the backend's counts)}, "compiles": the
    store's}."""
    src = str(Path(__file__).resolve().parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import torch
    from repro_torch.compiler import TableStore
    from repro_torch.core import searchspace
    from repro_torch.models import ppa_table_jobs

    dev = torch.device("cuda", 0)
    backend = searchspace.TorchSearchBackend(dev)
    _first_use(backend)
    torch.cuda.synchronize()
    store = TableStore(store_dir)
    out = {}
    for naf, cfg, scheme in ppa_table_jobs("ppa"):
        if naf not in nafs:
            continue
        before = dict(backend.counts)
        t0 = time.perf_counter()
        tab = store.compile_or_load(naf, cfg, scheme, search_backend=backend)
        torch.cuda.synchronize()
        out[naf] = (tab.to_json(), time.perf_counter() - t0,
                    {k: v - before[k] for k, v in backend.counts.items()})
    return {"tables": out, "compiles": store.compiles}


def phase_compile(torch, dev, card, host):
    """The six 16-bit deployment tables compiled on the card
    (``TorchSearchBackend``) through ``compile_or_load`` into a fresh
    store, COMPILE_SPAWNED in a spawned process, the others in this one,
    at once: each equal to the shipped JSON on its fields, and each equal
    (``table_identity``) to the port's numpy backend's compile of it on
    the host (``host``: started with the run).  Returns the store."""
    import json as _json
    import multiprocessing
    import shutil
    from repro_torch.compiler import CompileJob, TableStore, table_identity
    from repro_torch.core import PPATable
    from repro_torch.models import ppa_table_jobs
    from repro_torch.tables import table_path

    jobs = ppa_table_jobs("ppa")
    shutil.rmtree(STORE_DIR, ignore_errors=True)
    t_phase = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(1)
    try:
        spawned = pool.apply_async(_card_compiles,
                                   (COMPILE_SPAWNED, str(STORE_DIR)))
        here = _card_compiles([naf for naf, _, _ in jobs
                               if naf not in COMPILE_SPAWNED], str(STORE_DIR))
        worker = spawned.get(timeout=HOST_TIMEOUT_S)
    finally:
        pool.terminate()
        pool.join()
    wall = time.perf_counter() - t_phase
    done = {naf: (PPATable.from_json(js), sec, cnt, where)
            for res, where in ((here, "this"), (worker, "a spawned"))
            for naf, (js, sec, cnt) in res["tables"].items()}
    card_tabs = {}
    for naf, _, _ in jobs:
        tab, sec, cnt, where = done[naf]
        card_tabs[naf] = (tab, sec)
        shipped = _json.loads(table_path(naf, 16).read_text())
        got = _json.loads(tab.to_json())
        bad = [k for k in TABLE_FIELDS if got[k] != shipped[k]]
        if bad or sorted(shipped) != sorted(TABLE_FIELDS):
            raise AssertionError(f"{naf}-16 compiled on the card differs "
                                 f"from the shipped JSON in {bad}")
        evals = int(tab.stats["candidate_evals"])
        log(f"[compile] {naf}-16 FQA-O2 on the card (torch, in {where} "
            f"process, one of two compiling on it at once): "
            f"{tab.num_segments} segments, "
            f"{int(tab.stats['segment_evals'])} segment evaluations, "
            f"{evals} candidate evaluations in {sec:.3f} s = "
            f"{evals / sec:,.0f}/s; {cnt['dispatches']} dispatches "
            f"({cnt['blocks']} blocks, {cnt['lanes']} padded lanes); "
            f"equal to the shipped JSON; card {card}")
    compiles = here["compiles"] + worker["compiles"]
    if compiles != len(jobs):
        raise AssertionError(f"{compiles} compiles for {len(jobs)} jobs "
                             "into a fresh store")
    store = TableStore(STORE_DIR)
    if any(store.lookup(CompileJob(*j)) is None for j in jobs):
        raise AssertionError("a table is missing from the store")
    host_tabs, _, line = host.get(jobs, 16)
    log(f"[compile] {line}")
    total = {"torch": 0.0, "numpy": 0.0}
    for naf, _, _ in jobs:
        tab, sec = card_tabs[naf]
        ref, ref_sec = host_tabs[naf]
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
            f"{HOST_PROCESSES}): {ref_sec:.3f} s = "
            f"{evals / ref_sec:,.0f} candidate evaluations/s; numpy's time "
            f"over the card's {ref_sec / sec:.2f}; table_identity equal")
    log(f"[compile] six 16-bit tables: card {total['torch']:.3f} s summed "
        f"over its two processes, {wall:.3f} s wall; "
        f"host numpy {total['numpy']:.3f} s summed over its processes; "
        f"store {store.stats()}; card {card}")
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
    """The serve phase through ``ServeEngine(table_store=<the compile
    phase's store>)``: the engine resolves its six tables through the
    store (hits, no compile), they pack to the shipped constants, and the
    greedy tokens and launch gates are the serve phase's."""
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


#: the sweep phase: simulated hosts and spawned compile processes a host
#: (more processes share the card's time slices: three a host took 57.8 s
#: against two's 61.5 s, at 2.6-5.2 ms a dispatch against 1.8-3.3;
#: scripts/torch_sweep_study.py)
SWEEP_HOSTS = 2
SWEEP_PROCESSES = 2
#: live workers (spawned, one compile at a time each)
SWEEP_LIVE_WORKERS = 2


def _sweep_check(tag, reports, st, jobs, host, shipped, wall):
    """Every key compiled exactly once over ``reports``, by spawned workers
    on the card; each table in ``st`` equal to the serial compile
    (``host``) by ``table_identity`` and to the shipped 8-bit JSON on its
    fields.  Returns the log line."""
    import os
    from repro_torch.compiler import table_identity

    compiled = sorted(k for r in reports for k in r.compiled)
    if compiled != sorted(j.key() for j in jobs):
        raise AssertionError(f"{tag}: keys compiled {compiled}, not each "
                             "key once")
    if any(r.deferred for r in reports):
        raise AssertionError(f"{tag}: deferred keys")
    workers = [w for r in reports for w in r.compiled_by.values()]
    if len(workers) != len(jobs) or any(
            w["backend"] != "torch@cuda" or w["pid"] == os.getpid()
            or w["dispatches"] <= 0 for w in workers):
        raise AssertionError(f"{tag}: not every key was compiled on the "
                             f"card in a spawned worker: {workers}")
    evals = 0
    for job in jobs:
        tab = st.lookup(job)
        if tab is None or table_identity(tab) != table_identity(
                host[job.naf][0]):
            raise AssertionError(f"{tag}: {job.naf}-8 is not the serial "
                                 "compile's table")
        got = json.loads(tab.to_json())
        bad = [k for k in TABLE_FIELDS if got[k] != shipped[job.naf][k]]
        if bad:
            raise AssertionError(f"{tag}: {job.naf}-8 differs from the "
                                 f"shipped JSON in {bad}")
        evals += int(tab.stats["candidate_evals"])
    by_pid = collections.defaultdict(list)
    for r in reports:
        for key, w in r.compiled_by.items():
            naf = next(j.naf for j in jobs if j.key() == key)
            by_pid[(r.owner, w["pid"])].append(
                f"{naf}({w['dispatches']})")
    dispatches = sum(w["dispatches"] for w in workers)
    return (f"[sweep] {tag}: {len(jobs)} keys each compiled once in "
            f"{wall:.3f} s wall, {dispatches} dispatches, {evals} candidate "
            f"evaluations = {evals / wall:,.0f}/s; workers (owner, pid): "
            + "; ".join(f"{o} pid {pid} on torch@cuda: {', '.join(v)}"
                        for (o, pid), v in sorted(by_pid.items())))


def phase_sweep(torch, dev, card, store, host):
    """The six 8-bit deployment tables (``ppa_table_jobs("ppa8")``)
    compiled on ``TorchSearchBackend`` twice: by ``run_shard`` on
    SWEEP_HOSTS simulated hosts at once (threads, each with its own store
    and a pool of SWEEP_PROCESSES spawned processes), merged; and by
    SWEEP_LIVE_WORKERS spawned ``run_live`` workers on one shared
    directory.  Each key compiled once in each mode, by spawned workers on
    the card; every table equal to a serial compile (the numpy backend,
    one spawned process a table, ``host``: started with the run) by
    ``table_identity`` and to the shipped ``*-8.json``; then
    ``merge_shards`` brings them into the compile phase's store."""
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.compiler import (CompileJob, TableStore, merge_shards,
                                      run_live_workers, run_shard)
    from repro_torch.models import ppa_table_jobs
    from repro_torch.tables import table_path

    if store is None:
        raise AssertionError("no store: the compile phase failed")
    triples = ppa_table_jobs("ppa8")
    jobs = [CompileJob(naf, cfg, scheme, search_backend="torch")
            for naf, cfg, scheme in triples]
    shipped = {naf: json.loads(table_path(naf, 8).read_text())
               for naf, _, _ in triples}
    root = STORE_DIR.parent / "chip_smoke_sweep"
    shutil.rmtree(root, ignore_errors=True)
    try:
        serial, _, line = host.get(triples, 8)
        log(f"[sweep] serial reference: the six 8-bit tables on the numpy "
            f"backend, one spawned process a table ("
            + ", ".join(f"{naf} {sec:.3f} s" for naf, (_, sec)
                        in serial.items()) + f"); {line}")

        def shard(i):
            return run_shard(jobs, hosts=SWEEP_HOSTS, host_id=i,
                             store=TableStore(root / f"host{i}"),
                             processes=SWEEP_PROCESSES,
                             owner=f"card-host{i}")

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SWEEP_HOSTS) as ex:
            reports = list(ex.map(shard, range(SWEEP_HOSTS)))
        wall = time.perf_counter() - t0
        merged = TableStore(root / "merged")
        mstats = merge_shards(merged, [root / f"host{i}"
                                       for i in range(SWEEP_HOSTS)])
        log(_sweep_check(f"run_shard x {SWEEP_HOSTS} hosts + merge", reports,
                         merged, jobs, serial, shipped, wall)
            + f"; merge {mstats}; card {card}")

        t0 = time.perf_counter()
        live = run_live_workers(jobs, root / "live",
                                workers=SWEEP_LIVE_WORKERS, processes=1,
                                claim_ttl_s=900.0)
        wall = time.perf_counter() - t0
        if list((root / "live").glob("*.claim")):
            raise AssertionError("run_live left claims behind")
        log(_sweep_check(f"run_live x {SWEEP_LIVE_WORKERS} spawned workers",
                         live, TableStore(root / "live"), jobs, serial,
                         shipped, wall) + f"; card {card}")

        stats = merge_shards(store, [root / "merged"])
        if any(store.lookup(j) is None for j in jobs):
            raise AssertionError("the merge left an 8-bit table out of the "
                                 "compile phase's store")
        log(f"[sweep] merged into the compile phase's store: {stats}")
        _sweep_cli(root / "cli", card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


SWEEP_CLI = Path(__file__).resolve().parent / "scripts" / "torch_sweep.py"
#: a sweep CLI subprocess's time limit
SWEEP_CLI_TIMEOUT_S = 600


def _run_cli(procs):
    """Wait for every ``Popen`` of ``procs`` (killing all at the time
    limit); returns their stdouts, and raises unless each exited 0."""
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=SWEEP_CLI_TIMEOUT_S)
            if p.returncode != 0:
                raise AssertionError(f"{p.args} exited {p.returncode}:\n"
                                     f"{out}\n{err}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _sweep_cli(root, card):
    """``scripts/torch_sweep.py --preset smoke --hosts 2 --host-id i
    --backend torch`` as two subprocesses at once (one serial compile
    process each, scanning on the card), then ``--merge-from`` both into
    a third store: every key of the smoke grid compiled once on
    ``torch@cuda``, and the merged store equal to a serial numpy compile
    by ``table_identity``."""
    from repro_torch.compiler import (TableStore, compile_batch, paper_grid,
                                      table_identity)

    def cli(*args):
        return subprocess.Popen(
            [sys.executable, str(SWEEP_CLI), *map(str, args)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    t0 = time.perf_counter()
    outs = _run_cli([cli("--preset", "smoke", "--hosts", 2, "--host-id", i,
                         "--backend", "torch", "--processes", 1, "--store",
                         root / f"host{i}", "--json") for i in range(2)])
    wall = time.perf_counter() - t0
    reports = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    t1 = time.perf_counter()
    _run_cli([cli("--store", root / "merged", "--merge-from",
                  root / "host0", root / "host1", "--json")])
    merge_s = time.perf_counter() - t1
    jobs = paper_grid("smoke")
    t1 = time.perf_counter()
    serial = compile_batch(jobs, store=TableStore(root / "serial"),
                           processes=1)
    serial_s = time.perf_counter() - t1
    merged = TableStore(root / "merged")
    for job, tab in zip(jobs, serial):
        got = merged.lookup(job)
        if got is None or table_identity(got) != table_identity(tab):
            raise AssertionError(f"{job.naf} {job.scheme.tag}: the CLI's "
                                 "merged store is not the serial compile")
    compiled = sorted(k for r in reports for k in r["compiled"])
    workers = [w for r in reports for w in r["compiled_by"].values()]
    if compiled != sorted(j.key() for j in jobs) or any(
            w["backend"] != "torch@cuda" for w in workers):
        raise AssertionError(f"the CLI hosts did not compile each key once "
                             f"on the card: {reports}")
    log(f"[sweep] scripts/torch_sweep.py --preset smoke --hosts 2 --backend "
        f"torch: {len(jobs)} keys in {wall:.3f} s wall (host 0 "
        f"{len(reports[0]['compiled'])} keys, host 1 "
        f"{len(reports[1]['compiled'])}; "
        f"{sum(w['dispatches'] for w in workers)} dispatches on torch@cuda), "
        f"--merge-from {merge_s:.3f} s, equal by table_identity to a serial "
        f"numpy compile ({serial_s:.3f} s); card {card}")


def phase_tune(torch, dev, card, store):
    """``autotune(smoke=True)`` on the card into a fresh store, then its
    verification (the file round-trips, ``compile_or_load`` picks it up,
    the tuned table is the untuned one); stage 3 (the fused kernel's
    launch shape, every candidate's output the plain version's bit for
    bit) again over all four candidates; the smoke grid compiled through a
    store with the tuned file and one without gives the same keys and
    tables, byte for byte but for the effort counters a speculation depth
    moves; a full-width internlm2-1.8b engine given the tuned store (the
    compile phase's tables merged in) applies the tuned ``fused_launch``
    and gives the serve phase's greedy tokens through the kernels.  The
    process defaults a tuned config sets are restored."""
    import shutil
    from repro_torch.compiler import EFFORT_STAT_KEYS, TableStore
    from repro_torch.configs import get_config
    from repro_torch.core import TorchSearchBackend
    from repro_torch.kernels import fused, read_counts
    from repro_torch.tune import autotune, config
    from repro_torch.tune.autotune import (_SCHEME, _SMOKE_GRID,
                                           tune_fused_launch, verify)

    if store is None:
        raise AssertionError("no store: the compile phase failed")
    root = STORE_DIR.parent / "chip_smoke_tune"
    shutil.rmtree(root, ignore_errors=True)
    floors = {k: getattr(TorchSearchBackend, k)
              for k in ("K_FLOOR", "G_FLOOR", "BATCH_ELEMS")}
    try:
        t0 = time.perf_counter()
        cfg = autotune(root / "tuned", smoke=True, log=log)
        verify(root / "tuned", cfg, log=log)
        sec = time.perf_counter() - t0
        if not any(k.startswith("fused_ms/") for k in cfg.score):
            raise AssertionError("stage 3 timed no fused launch on the card")
        t0 = time.perf_counter()
        every = {}
        best = tune_fused_launch(dev, fused.LAUNCH_CANDIDATES, every,
                                 repeats=5, log=log)
        log(f"[tune] stage 3 over all {len(fused.LAUNCH_CANDIDATES)} "
            f"candidates in {time.perf_counter() - t0:.3f} s: pick "
            f"{best[0]}x{best[1]}; device ms a launch {every}; card {card}")
        tuned, plain = TableStore(root / "tuned"), TableStore(root / "plain")
        for naf, fcfg in _SMOKE_GRID:
            tuned.compile_or_load(naf, fcfg, _SCHEME)
            plain.compile_or_load(naf, fcfg, _SCHEME)
        names = sorted(p.name for p in (root / "tuned").glob("*.json"))
        if names != sorted(p.name for p in (root / "plain").glob("*.json")):
            raise AssertionError("the tuned store's keys differ")
        moved = set()
        for n in names:
            a, b = (json.loads((root / d / n).read_text())
                    for d in ("tuned", "plain"))
            sa, sb = a.pop("stats"), b.pop("stats")
            diff = {k for k in set(sa) | set(sb) if sa.get(k) != sb.get(k)}
            del a["sha"], b["sha"]
            if a != b or not diff <= EFFORT_STAT_KEYS or (
                    diff and not cfg.speculate):
                raise AssertionError(f"{n}: the tuned compile moved the "
                                     f"artifact ({sorted(diff)})")
            moved |= diff
        est = TableStore(root / "tuned")
        est.merge(store.root)
        # another shape in force before the engine: its tuned store must
        # put the tuned one in force
        other = next(lc for lc in fused.LAUNCH_CANDIDATES
                     if lc != cfg.fused_launch)
        fused.set_default_launch(other)
        mcfg = get_config("internlm2-1.8b").replace(
            act_impl="ppa", compute_dtype="bfloat16")
        lens = SERVE_LENS[:SERVE_REQUESTS]
        eng, reqs, steps, wall = _serve(torch, dev, mcfg, SERVE_REQUESTS,
                                        SERVE_NEW, lens, est)
        counts = read_counts()
        if (eng.tuned != cfg or TorchSearchBackend.K_FLOOR != cfg.k_floor
                or fused.default_launch() != cfg.fused_launch):
            raise AssertionError(f"the engine reports tuned {eng.tuned}, "
                                 f"launch {fused.default_launch()}, not "
                                 f"{cfg}")
        if [list(r.output) for r in reqs] != TOKENS.get("serve"):
            raise AssertionError("the tuned engine's greedy tokens are not "
                                 "the serve phase's")
        need = mcfg.n_layers * len(steps)
        for k in ("ppa_fused", "softmax_ppa"):
            if counts[k]["launches"] < need:
                raise AssertionError(f"{k} launched {counts[k]['launches']}"
                                     f" times < layers x steps = {need}")
        plain_calls = {k: c["plain"] for k, c in counts.items()
                       if "plain" in c}
        if any(plain_calls.values()):
            raise AssertionError(f"plain versions ran: {plain_calls}")
        log(f"[tune] autotune(smoke) + verify in {sec:.3f} s: "
            f"{cfg.summary()}; scores {cfg.score}; the smoke grid through "
            f"the tuned and untuned stores: same {len(names)} keys, "
            + ("the bytes equal" if not moved else
               f"equal but for the effort counters {sorted(moved)}")
            + f"; internlm2-1.8b 24L bf16 on the tuned store applied "
            f"fused_launch {cfg.fused_launch} and gave the serve phase's "
            f"tokens in {wall:.3f} s ({len(steps)} steps, launches fused "
            f"{counts['ppa_fused']['launches']} softmax "
            f"{counts['softmax_ppa']['launches']}); card {card}")
        out = {k: {"total": counts[k]["launches"]}
               for k in ("ppa_fused", "softmax_ppa")}
        del eng
        _free(torch)
        return out, {}
    finally:
        for k, v in floors.items():
            setattr(TorchSearchBackend, k, v)
        fused.set_default_launch(None)
        config._ACTIVE = None
        config._RESOLVE_CACHE.clear()
        shutil.rmtree(root, ignore_errors=True)


#: the tenants phase: requests a healthy tenant, and to the armed one
TENANT_REQUESTS = 8
TENANT_ARMED_REQUESTS = 2
TENANT_MAX_ACTIVE = 8


def _count_steps(torch, eng, rec):
    """Wrap ``eng.step`` to record (seconds, requests admitted, fused and
    softmax launches) of each step."""
    from repro_torch.kernels import read_counts
    orig = eng.step

    def step():
        c0 = read_counts()
        q0 = len(eng.queue)
        ts = time.perf_counter()
        n = orig()
        torch.cuda.synchronize()
        c1 = read_counts()
        rec.append((time.perf_counter() - ts, q0 - len(eng.queue),
                    {k: c1[k]["launches"] - c0[k]["launches"]
                     for k in ("ppa_fused", "softmax_ppa")}))
        return n
    eng.step = step


def phase_tenants(torch, dev, card, store):
    """One ``TenantFront`` on the compile phase's store (16- and 8-bit
    tables) serving full-width internlm2-1.8b (24 layers, bf16) as three
    tenants on one set of parameters: ``a`` (ppa) and ``b`` (ppa8)
    admitted warm, ``c`` (ppa) admitted cold with ``serve.tenant.build``
    armed and no exact fallback.  TENANT_REQUESTS each to a and b,
    interleaved (the serve phase's prompts to a, another draw to b), and
    TENANT_ARMED_REQUESTS to c, under ``max_active`` TENANT_MAX_ACTIVE.
    a and b give the greedy tokens of a lone store-fed engine of their
    impl on the same requests (a also the serve phase's); c alone is
    degraded, its requests end ``tenant_degraded``, and every pin of a and
    b survives; the fused and softmax kernels launch at least layers x
    steps times in each of a's and b's engines, and no plain version
    runs."""
    from repro_torch import faults
    from repro_torch.compiler import CompileJob, TableStore
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params, param_specs, ppa_table_jobs
    from repro_torch.serve import ServeEngine, TenantFront, TenantSpec

    if store is None:
        raise AssertionError("no store: the compile phase failed")
    base = get_config("internlm2-1.8b").replace(compute_dtype="bfloat16")
    cfgs = {"a": base.replace(act_impl="ppa"),
            "b": base.replace(act_impl="ppa8"),
            "c": base.replace(act_impl="ppa")}
    lens = SERVE_LENS[:TENANT_REQUESTS]
    reqs = {"a": _requests(cfgs["a"], TENANT_REQUESTS, SERVE_NEW, lens, 0),
            "b": _requests(cfgs["b"], TENANT_REQUESTS, SERVE_NEW, lens, 1),
            "c": _requests(cfgs["c"], TENANT_ARMED_REQUESTS, SERVE_NEW,
                           lens, 2)}
    params = init_params(param_specs(base), 0, dtype=torch.bfloat16,
                         device=dev)
    faults.reset()
    front = TenantFront(store, max_active=TENANT_MAX_ACTIVE, device=dev)
    admit = {}
    for name in ("a", "b"):
        rep = front.add_tenant(TenantSpec(
            name, cfgs[name], params, n_slots=SERVE_SLOTS,
            cache_len=SERVE_CACHE_LEN, warm_prompt_lens=sorted(set(lens))))
        if rep["degraded"] or rep["tables_pinned"] != 6:
            raise AssertionError(f"tenant {name}: {rep}")
        admit[name] = rep["warmup_s"]
    pins = dict(store._pinned)
    want_pins = {CompileJob(*j).key() for impl in ("ppa", "ppa8")
                 for j in ppa_table_jobs(impl)}
    if set(pins) != want_pins:
        raise AssertionError(f"pins {pins} are not a's and b's tables")
    faults.arm("serve.tenant.build", "once")
    front.add_tenant(TenantSpec("c", cfgs["c"], params, n_slots=SERVE_SLOTS,
                                cache_len=SERVE_CACHE_LEN), warm=False)
    recs = {"a": [], "b": []}
    for name, rec in recs.items():
        _count_steps(torch, front.engines[name], rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    for i in range(TENANT_REQUESTS):
        for name in ("a", "b"):
            front.submit(name, reqs[name][i])
    for r in reqs["c"]:
        front.submit("c", r)
    t0 = time.perf_counter()
    front.run_until_drained()
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated(dev)
    counts = read_counts()
    faults.reset()
    if set(front.degraded) != {"c"} or front.degraded["c"].startswith(
            "fallback"):
        raise AssertionError(f"degraded tenants {front.degraded}: only c, "
                             "without a fallback, was armed")
    if not all(r.done and r.rejected == "tenant_degraded"
               for r in reqs["c"]):
        raise AssertionError("c's requests did not end tenant_degraded")
    if dict(store._pinned) != pins:
        raise AssertionError("c's degradation moved a's or b's pins")
    plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
    if any(plain.values()):
        raise AssertionError(f"plain versions ran in the front: {plain}")
    tokens = {n: [list(r.output) for r in reqs[n]] for n in ("a", "b")}
    for name in ("a", "b"):
        rec = recs[name]
        for k in ("ppa_fused", "softmax_ppa"):
            got = sum(c[k] for _, _, c in rec)
            if got < base.n_layers * len(rec):
                raise AssertionError(f"tenant {name}: {k} launched {got} "
                                     f"times < layers x steps = "
                                     f"{base.n_layers * len(rec)}")
        if not all(r.done and len(r.output) == SERVE_NEW
                   for r in reqs[name]):
            raise AssertionError(f"tenant {name}: unfinished requests")
    if tokens["a"] != TOKENS.get("serve"):
        raise AssertionError("tenant a's greedy tokens are not the serve "
                             "phase's")
    lone_s = {}
    for name in ("a", "b"):
        # a cold build: a new store object over the same directory, so the
        # engine's tables come from the disk tier and are packed anew
        t1 = time.perf_counter()
        eng = ServeEngine(cfgs[name], params, n_slots=SERVE_SLOTS,
                          cache_len=SERVE_CACHE_LEN,
                          table_store=TableStore(store.root), device=dev)
        torch.cuda.synchronize()
        lone_s[name] = time.perf_counter() - t1
        lone = _requests(cfgs[name], TENANT_REQUESTS, SERVE_NEW, lens,
                         0 if name == "a" else 1)
        for r in lone:
            eng.submit(r)
        eng.run_until_drained()
        if [list(r.output) for r in lone] != tokens[name]:
            raise AssertionError(f"tenant {name}'s greedy tokens are not a "
                                 "lone store-fed engine's")
        del eng
    n_tok = sum(len(r.output) for n in ("a", "b") for r in reqs[n])
    for name, rec in recs.items():
        decode = sorted(t for t, adm, _ in rec if adm == 0)
        launches = {k: sum(c[k] for _, _, c in rec)
                    for k in ("ppa_fused", "softmax_ppa")}
        log(f"[tenants] {name} ({cfgs[name].act_impl}): decode "
            f"{decode[len(decode) // 2] * 1e3:.2f} ms/step (median of "
            f"{len(decode)}, the other tenant's engine stepping between), "
            f"{len(rec)} engine steps, launches {launches} (layers x "
            f"steps = {base.n_layers * len(rec)}); warm admission "
            f"{admit[name]:.3f} s (pins and warm-up runs); a lone engine "
            f"built cold from the store's disk tier in {lone_s[name]:.3f} "
            f"s gives the same tokens; card {card}")
    log(f"[tenants] internlm2-1.8b 24L bf16 x 3 tenants on one store: "
        f"{n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} tok/s; c's "
        f"cold build raised at the armed failpoint in the first front step "
        f"and its {len(reqs['c'])} requests ended tenant_degraded "
        f"({front.degraded['c']}); pins of a and b kept ({len(pins)} "
        f"keys); max_memory_allocated {mem / 2**30:.2f} GiB; card {card}")
    out = {k: {"total": counts[k]["launches"]}
           for k in ("ppa_fused", "softmax_ppa")}
    del front, params
    _free(torch)
    return out, {}


CHAOS_SCRIPT = Path(__file__).resolve().parent / "scripts" / "torch_chaos.py"


def phase_chaos(torch, dev, card, store):
    """``scripts/torch_chaos.py``'s three legs in this process (its workers
    are fresh interpreters): the live sweep under three armed crash
    workers and a survivor, all scanning on the card; the killed merge
    and its clean retry; and, at full width, internlm2-1.8b (24 layers,
    bf16, ``ppa``) as tenant a beside b (``serve.tenant.warm`` armed) and
    c (a request past its deadline) on the compile phase's store, a
    served the serve phase's requests.  Beyond the legs' own gates: the
    sweep's keys compiled on ``torch@cuda``; a's tokens the serve phase's;
    the fused and softmax kernels launched at least layers x steps times
    in a's engine during the fault run, and no plain version."""
    import importlib.util
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels import read_counts, reset_counts
    from repro_torch.models import init_params, param_specs

    if store is None:
        raise AssertionError("no store: the compile phase failed")
    spec = importlib.util.spec_from_file_location("torch_chaos",
                                                  CHAOS_SCRIPT)
    chaos = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chaos)
    root = STORE_DIR.parent / "chip_smoke_chaos"
    shutil.rmtree(root, ignore_errors=True)
    try:
        sweep = chaos.sweep_leg(root, backend="torch", log=log)
        if sweep["backend"] != "torch@cuda":
            raise AssertionError(f"the sweep leg ran on {sweep['backend']}")
        merge = chaos.merge_leg(root, log=log)
        cfg = get_config("internlm2-1.8b").replace(
            act_impl="ppa", compute_dtype="bfloat16")
        params = init_params(param_specs(cfg), 0, dtype=torch.bfloat16,
                             device=dev)
        lens = SERVE_LENS[:SERVE_REQUESTS]
        rec = []

        def hook(front):
            _count_steps(torch, front.engines["a"], rec)
            torch.cuda.synchronize()
            reset_counts()

        serve = chaos.serve_leg(
            store, cfg, params, device=dev,
            requests=lambda: _requests(cfg, SERVE_REQUESTS, SERVE_NEW, lens),
            n_slots=SERVE_SLOTS, cache_len=SERVE_CACHE_LEN, hook=hook,
            log=log)
        counts = read_counts()
        if serve["tokens"] != TOKENS.get("serve"):
            raise AssertionError("tenant a's greedy tokens are not the serve "
                                 "phase's")
        need = cfg.n_layers * len(rec)
        got = {k: sum(c[k] for _, _, c in rec)
               for k in ("ppa_fused", "softmax_ppa")}
        if any(v < need for v in got.values()):
            raise AssertionError(f"a's engine launched {got} < layers x "
                                 f"steps = {need}")
        plain = {k: c["plain"] for k, c in counts.items() if "plain" in c}
        if any(plain.values()):
            raise AssertionError(f"plain versions ran in the front: {plain}")
        log(f"[chaos] sweep leg {sweep['seconds']:.3f} s ({sweep['keys']} "
            f"keys, 3 crashes and a survivor in {sweep['workers']} worker "
            f"processes on {sweep['backend']}); merge leg "
            f"{merge['seconds']:.3f} s; serve leg {serve['seconds']:.3f} s "
            f"(internlm2-1.8b 24L bf16: a's {SERVE_REQUESTS} requests the "
            f"serve phase's tokens, {len(rec)} steps, launches {got}, "
            f"layers x steps = {need}); card {card}")
        out = {k: {"total": counts[k]["launches"]}
               for k in ("ppa_fused", "softmax_ppa")}
        del serve, params
        _free(torch)
        return out, {}
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    jobs, host = {}, None
    try:
        if not failed:
            jobs = dryrun_start()
            host = HostCompiles()
            rows, paths = phases(run, failed, torch, dev, card, jobs, host)
    finally:
        dryrun_stop(jobs)
        if host is not None:
            host.stop()
    log(f"[chip_smoke] all phases in {time.perf_counter() - t_start:.1f}s")
    if failed:
        log(f"chip_smoke: FAILED phases {failed}")
        return 1
    return report(torch, rows, paths)


def phases(run, failed, torch, dev, card, jobs, host):
    """Every phase after the build, in order (``run`` each, which adds a
    failed one's name to ``failed``); returns the kernel rows and each
    path's launches."""
    rows = run("kernels", phase_kernels, torch, dev) or []
    paths = {
        "serve": run("serve", phase_serve, torch, dev, card)}
    paths["serve_sharded"] = run("serve_sharded", phase_serve_sharded,
                                 torch, dev, card)
    paths["serve_int"] = run("serve_int", phase_serve_int, torch, dev)
    run("parity", phase_parity, torch, dev)
    paths["train"] = run("train", phase_train, torch, dev, card)
    run("train_parity", phase_train_parity, torch, dev)
    run("train_resume", phase_train_resume, torch, dev)
    paths["serve_moe"] = run("serve_moe", phase_serve_full, torch, dev,
                             card, MOE_ARCH, "serve_moe")
    paths["serve_moe_sharded"] = run("serve_moe_sharded",
                                     phase_serve_moe_sharded, torch, dev,
                                     card)
    run("roofline", phase_roofline, torch, dev, card)
    _free(torch)
    run("dryrun", phase_dryrun, torch, dev, card, jobs)
    _free(torch)
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
    for tag in TRAIN_FAMILIES:
        paths[tag] = run(tag, phase_train_family, torch, dev, card, tag)
    # the train parity on each family at its serving parity's depth, its
    # train phase's batch
    for tag, (arch, per_stage, stages) in TRAIN_PARITY_FAMILIES.items():
        _, batch, seq, _ = TRAIN_FAMILIES[tag.replace("_parity", "")]
        run(tag, phase_train_parity, torch, dev, arch, per_stage, tag,
            stages, batch, seq, "either")
    store = run("compile", phase_compile, torch, dev, card, host)
    run("workflow", phase_workflow, torch, dev, card)
    run("sweep", phase_sweep, torch, dev, card, store, host)
    paths["tune"] = run("tune", phase_tune, torch, dev, card, store)
    paths["serve_store"] = run("serve_store", phase_serve_store, torch,
                               dev, card, store)
    paths["tenants"] = run("tenants", phase_tenants, torch, dev, card,
                           store)
    paths["chaos"] = run("chaos", phase_chaos, torch, dev, card, store)
    return rows, paths


def report(torch, rows, paths) -> int:
    """The kernels line and the last line."""
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
