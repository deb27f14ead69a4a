"""Multi-pod dry run: count one step of every (arch x shape x mesh) cell.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 placeholder devices and reads the
compiler's memory and cost analyses.  Eager PyTorch has no compiler to
ask, so here one step runs on fake tensors and is counted as it runs:

* the mesh is a ``DeviceMesh`` on a fake process group of 256 or 512
  ranks (``launch/mesh.py``), this process its rank 0;
* parameters, optimizer state, inputs and cache are ``DTensor`` s whose
  local shards are fake tensors of one ``FakeTensorMode`` (shapes, no
  storage), placed by ``param_shardings`` (the "train" or "serve" rules),
  ``cache_shardings`` and the batch's dp axes.  They live on the meta
  device: PyTorch built without CUDA cannot index a fake ``cuda`` tensor.
  A kernel wrapper given a fake tensor reports its work and launches
  nothing (``kernels/local.py``);
* one train step (loss, gradients, clip, optimizer update), prefill or
  decode step runs under :class:`~repro_torch.roofline.OpCosts`, which
  counts rank 0's local ops and collectives below DTensor (never
  DTensor's sharding propagation at the global shapes).

Each record has the reference's fields.  ``memory``: ``argument_bytes``
(the rank's shard bytes of every argument), ``output_bytes`` (of every
result), ``temp_bytes`` (the high-water mark of the live bytes the step's
ops allocated, ``OpCosts.peak_bytes``) and ``peak_bytes_per_device``
(arguments plus temporaries, as the reference sums them).  ``roofline``:
``analyze_costs`` against ``HW_H100`` with ``chips = mesh.size()``.  Its
``link_bw`` is NVLink's rate within one node of 8 cards; a (16, 16) mesh
spans 32 nodes, so ``t_collective`` is a lower bound there.
``t_lower_s`` and ``t_compile_s`` are the seconds the placement and the
counted step took.  ``VARIANTS`` keeps the reference's keys; ``fused``
selects ``act_backend="cuda_fused"``, already the port's default.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

from ..configs import (ARCH_IDS, SHAPES, ShapeProfile, apply_shape,
                       get_config, resolve_for_mesh, shape_skip_reason)
from ..distributed.sharding import (cache_specs, make_ctx, make_rules,
                                    spec_tree, to_dtensor)
from ..models import make_acts
from ..models.common import on_mesh
from ..models.config import ModelCfg
from ..models.transformer import (decode_step, dtype_of, param_specs,
                                  prefill, prepare_params)
from ..roofline import OpCosts, analyze_costs
from ..tree import leaves, map_tree, map_trees
from .mesh import fake_mesh, make_production_mesh, mesh_desc
from .specs import active_params, input_specs

__all__ = ["ART_DIR", "VARIANTS", "Cell", "cell_model_flops", "count_cell",
           "decode_counts", "local_bytes", "place_cell", "run_cell", "run_step",
           "main"]

ART_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
           / "dryrun_torch")

#: where the fake tensors live (see the module docstring)
DEVICE = "meta"


def _attn_flops(cfg: ModelCfg, shape) -> float:
    """Attention score/value matmul FLOPs (unpadded dims, fwd)."""
    b, t = shape.global_batch, shape.seq_len
    hq, dh = cfg.n_q, cfg.head_dim
    total = 0.0
    for st in cfg.stages:
        if st.kind in ("dec", "xdec", "hyb", "enc"):
            if shape.kind == "decode":
                s_eff = min(t, st.window or t)
                total += 4.0 * b * st.n_layers * s_eff * hq * dh
            else:
                s_eff = min(t, st.window or t)
                # causal: sum over rows of min(row, window) ~ t*s_eff - s^2/2
                pairs = t * s_eff - (s_eff * s_eff) / 2
                total += 4.0 * b * st.n_layers * pairs * hq * dh
    return total


def cell_model_flops(cfg_unpadded: ModelCfg, shape) -> float:
    n_active = active_params(cfg_unpadded, param_specs(cfg_unpadded))
    if shape.kind == "train":
        base = 6.0 * n_active * shape.global_batch * shape.seq_len
        return base + 3.0 * _attn_flops(cfg_unpadded, shape)
    if shape.kind == "prefill":
        base = 2.0 * n_active * shape.global_batch * shape.seq_len
        return base + _attn_flops(cfg_unpadded, shape)
    base = 2.0 * n_active * shape.global_batch
    return base + _attn_flops(cfg_unpadded, shape)


VARIANTS = {
    "baseline": {},
    # beyond-paper activation deployment modes (bit-exact)
    "lut_index": {"act_backend": "lut_index"},
    "lut_value": {"act_backend": "lut_value"},
    # the fused float->PPA->float kernel (csrc/ppa_fused.cu): the port's
    # default backend already
    "fused": {"act_backend": "cuda_fused"},
    # flash-decode-style KV: cache seq-sharded, kv heads unpadded
    "kvseq": {"kv_shard": "seq"},
    # exact float activations (ablation: PPA overhead isolation)
    "exact": {"act_impl": "exact"},
    # weight-stationary decode: no FSDP on dense weights (profile-level)
    "wstation": {"_profile": "serve_wstation"},
    # bf16 parameter storage
    "bf16w": {"param_dtype": "bfloat16"},
    # microbatch gradient accumulation (train peak-memory envelope)
    "accum4": {"_accum": 4},
    # larger flash KV chunk (fewer online-softmax rescale passes)
    "bigchunk": {"flash_chunk": 4096},
    # chunked online-softmax attention for training shapes too
    "flash": {"attn_impl": "flash"},
}


def _parse_variant(variant: str) -> dict:
    kw = {}
    for part in variant.split("+"):
        kw.update(VARIANTS[part])
    return kw


def local_bytes(tree) -> int:
    """The rank's bytes of every tensor leaf (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def _train_step(cfg, tcfg, acts, ctx, params, tstate, batch):
    """The train step of ``train/train_step.py`` without its host reads
    (the step count enters the rate as 1; the metrics stay on the
    device)."""
    from ..train.optimizer import clip_grads, opt_update
    from ..train.schedule import lr_at
    from ..train.train_step import loss_and_grads
    with on_mesh(ctx):
        return _train_body(cfg, tcfg, acts, ctx, params, tstate, batch,
                           clip_grads, opt_update, lr_at, loss_and_grads)


def _train_body(cfg, tcfg, acts, ctx, params, tstate, batch, clip_grads,
                opt_update, lr_at, loss_and_grads):
    n = tcfg.accum_steps
    if n == 1:
        loss, grads = loss_and_grads(cfg, acts, params, batch, ctx)
    else:
        loss, grads = None, None
        for i in range(n):
            mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]
                  for k, v in batch.items()}
            lv, g = loss_and_grads(cfg, acts, params, mb, ctx)
            grads = g if grads is None else map_trees(
                lambda a, b: a + b.to(a.dtype), grads, g)
            loss = lv if loss is None else loss + lv
        grads = map_tree(lambda g: g / n, grads)
        loss = loss / n
    grads, gnorm = clip_grads(grads, tcfg.grad_clip)
    params, opt = opt_update(tcfg.opt, grads, tstate["opt"], params,
                             lr_at(tcfg.sched, 1))
    return params, {"step": tstate["step"] + 1, "opt": opt}, (loss, gnorm)


@dataclasses.dataclass
class Cell:
    """One cell placed on its mesh: the step's arguments as DTensors."""

    arch: str
    cfg0: ModelCfg              # the published config
    cfg: ModelCfg               # padded for the mesh, the shape applied
    shape: ShapeProfile
    mesh: object
    ctx: object
    profile: str
    args: tuple                 # the step's arguments
    acts: object
    mode: object                # the fake mode (None: real tensors)
    n_params: int
    cache_abs: object = None    # decode: the abstract cache
    tcfg: object = None         # train: the TrainCfg
    seconds: float = 0.0        # the placement's


def place_cell(arch: str, shape: ShapeProfile, mesh,
               variant: str = "baseline", device=None, seed: int = 0
               ) -> Cell:
    """Place one cell's parameters, optimizer state, inputs and cache on
    ``mesh`` by the rules of its profile: fake tensors on the meta device
    (``device`` None), or real ones on ``device`` (parameters drawn from
    ``seed``, inputs zeros)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    tp = mesh.size(mesh.mesh_dim_names.index("model"))
    cfg0 = get_config(arch)
    overrides = _parse_variant(variant)
    profile_override = overrides.pop("_profile", None)
    accum = overrides.pop("_accum", 1)
    cfg = apply_shape(resolve_for_mesh(cfg0.replace(**overrides), tp=tp),
                      shape)
    batch_sharded = shape.global_batch >= 8   # long_500k (B=1): replicate
    ctx = make_ctx(mesh, batch_sharded=batch_sharded)
    profile = profile_override or (
        "train" if shape.kind == "train" else "serve")
    rules = make_rules(profile, mesh,
                       kv_heads_sharded=cfg.kv_shard != "seq")
    specs = param_specs(cfg)
    pdt = dtype_of(cfg.param_dtype)
    mode = FakeTensorMode(allow_non_fake_inputs=True) if device is None \
        else None
    dev = DEVICE if device is None else device

    def place(t, spec):
        if mode is None:
            return to_dtensor(t, mesh, spec)
        with mode:
            return to_dtensor(t, mesh, spec)

    def zeros(shape_, dtype, spec):
        if mode is None:
            return place(torch.zeros(shape_, dtype=dtype, device=dev), spec)
        with mode:
            return place(torch.zeros(shape_, dtype=dtype, device=dev), spec)

    if mode is None:
        from ..models.common import init_params
        raw = init_params(specs, seed, dtype=pdt, device=dev)
        params = map_trees(place, raw, spec_tree(specs, mesh, rules))
        del raw
    else:
        params = map_trees(lambda p, s: zeros(p.shape, p.dtype or pdt, s),
                           specs, spec_tree(specs, mesh, rules))
    n_params = sum(p.numel() for p in leaves(params))
    ins = input_specs(cfg, shape, mesh, batch_sharded)
    acts = make_acts(cfg.act_impl, cfg.act_backend, device=dev)
    cache_abs = ins.pop("cache", None)
    batch = {k: zeros(a.shape, a.dtype, a.spec) for k, a in ins.items()}
    tcfg = None
    if shape.kind == "train":
        from ..train.optimizer import OptCfg
        from ..train.train_step import TrainCfg, train_init
        okind = "adafactor" if n_params > 1e11 else "adamw"
        tcfg = TrainCfg(opt=OptCfg(kind=okind), accum_steps=accum)
        if mode is None:
            tstate = train_init(tcfg, params)
        else:
            with mode:
                tstate = train_init(tcfg, params)
        args = (params, tstate, batch)
    elif shape.kind == "prefill":
        args = (params, batch)
    else:
        cs = cache_specs(mesh, cache_abs, batch_sharded,
                         kv_shard=cfg.kv_shard)
        cache = map_trees(lambda a, s: zeros(a.shape, a.dtype, s),
                          cache_abs, cs)
        args = (params, cache, batch["tokens"], batch["pos"])
    return Cell(arch=arch, cfg0=cfg0, cfg=cfg, shape=shape, mesh=mesh,
                ctx=ctx, profile=profile, args=args, acts=acts, mode=mode,
                n_params=n_params, cache_abs=cache_abs, tcfg=tcfg,
                seconds=time.time() - t0)


def run_step(cell: Cell, where: bool = False):
    """The cell's step under ``OpCosts``: (costs, outputs, seconds)."""
    t0 = time.time()
    cfg, shape, ctx = cell.cfg, cell.shape, cell.ctx
    with OpCosts(fake_mode=cell.mode, where=where) as costs:
        if shape.kind == "train":
            out = _train_step(cfg, cell.tcfg, cell.acts, ctx, *cell.args)
        elif shape.kind == "prefill":
            params, batch = cell.args
            with torch.no_grad():
                out = prefill(prepare_params(params, cfg), cfg, batch,
                              shape.seq_len, cell.acts, ctx=ctx)
        else:
            params, cache, tokens, pos = cell.args
            with torch.no_grad():
                out = decode_step(prepare_params(params, cfg), cfg, cache,
                                  tokens, pos, cell.acts, ctx)
    return costs, out, time.time() - t0


def count_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", where: bool = False):
    """Place one cell on the fake production mesh and count one step;
    returns (OpCosts, meta, memory)."""
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = place_cell(arch, shape, mesh, variant)
    costs, out, t_count = run_step(cell, where)
    cfg, cfg0 = cell.cfg, cell.cfg0
    # decode scores against the bandwidth roof: active params + KV cache
    # read exactly once per step
    ideal_bytes = 0.0
    if shape.kind == "decode":
        n_active = active_params(cfg0, param_specs(cfg0))
        ideal_bytes = n_active * dtype_of(cfg.param_dtype).itemsize + sum(
            a.dtype.itemsize * math.prod(a.shape)
            for a in leaves(cell.cache_abs))
    arg_bytes = local_bytes(cell.args)
    memory = {"argument_bytes": arg_bytes,
              "output_bytes": local_bytes(out),
              "temp_bytes": costs.peak_bytes,
              "peak_bytes_per_device": arg_bytes + costs.peak_bytes}
    meta = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "mesh": mesh_desc(mesh), "chips": mesh.size(),
        "n_params": cell.n_params,
        "model_flops": cell_model_flops(cfg0, shape),
        "ideal_bytes": ideal_bytes,
        "pad_info": [list(p) for p in cfg.pad_info],
        "t_lower_s": cell.seconds, "t_compile_s": t_count,
        "profile": cell.profile,
        "optimizer": cell.tcfg.opt.kind if cell.tcfg else None,
    }
    return costs, meta, memory


def decode_counts(arch: str, slots: int, cache_len: int, mesh=None,
                  device=None) -> dict:
    """One decode step of ``arch`` (``slots`` sequences, a cache of
    ``cache_len``) placed on ``mesh`` (None: a fake (1, 1) mesh) and
    counted: on fake tensors (``device`` None) or on real ones on
    ``device``.  The dry run's numbers beside the ones a real step gives:
    FLOPs, bytes, collective bytes, each kernel's (kernel, shape, bytes)
    and the arguments' bytes; on a card also the bytes that placing them
    allocated there (``torch.cuda.memory_allocated``)."""
    if mesh is None:
        mesh = fake_mesh((1, 1), ("data", "model"))
    shape = ShapeProfile(f"decode_{cache_len}", "decode", cache_len, slots)
    cuda = device is not None and torch.device(device).type == "cuda"
    base = torch.cuda.memory_allocated(device) if cuda else 0
    cell = place_cell(arch, shape, mesh, device=device)
    allocated = torch.cuda.memory_allocated(device) - base if cuda else None
    costs, _, seconds = run_step(cell)
    return {"flops": costs.flops, "bytes": costs.bytes,
            "coll_bytes": dict(costs.coll_bytes),
            "kernels": [[k["kernel"], list(k["shape"]), k["bytes"]]
                        for k in costs.kernels],
            "argument_bytes": local_bytes(cell.args),
            "allocated": allocated, "seconds": seconds}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = ART_DIR, verbose: bool = True,
             variant: str = "baseline") -> dict:
    skip = shape_skip_reason(arch, shape_name)
    tag = "multipod" if multi_pod else "pod"
    if variant != "baseline":
        tag = f"{tag}__{variant}"
    rec: dict
    if skip:
        rec = {"arch": arch, "shape": shape_name, "mesh": tag,
               "status": "skip", "reason": skip}
    else:
        costs, meta, mem = count_cell(arch, shape_name, multi_pod, variant)
        rl = analyze_costs(
            costs, arch=arch, shape=shape_name, mesh_desc=meta["mesh"],
            chips=meta["chips"], model_fl=meta["model_flops"],
            ideal_bytes=meta["ideal_bytes"])
        rec = {"status": "ok", **meta, "memory": mem,
               "roofline": rl.as_dict()}
        if verbose:
            print(f"[{arch} x {shape_name} x {tag}] "
                  f"count {meta['t_compile_s']:.1f}s  "
                  f"params {meta['n_params']/1e9:.2f}B  "
                  f"args/dev {mem['argument_bytes']/2**30:.2f}GiB  "
                  f"bottleneck {rl.bottleneck}  "
                  f"roofline_frac {rl.roofline_fraction:.3f}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{arch}__{shape_name}__{tag}.json"
    path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="'+'-joined subset of " + ",".join(VARIANTS))
    ap.add_argument("--out", default=str(ART_DIR))
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in ARCH_IDS:
            for s in SHAPES:
                skip = shape_skip_reason(a, s)
                print(f"{a:24s} {s:12s} {'SKIP: ' + skip if skip else 'run'}")
        return

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    failures = []
    for a in archs:
        for s in shapes:
            try:
                run_cell(a, s, args.multi_pod, Path(args.out),
                         variant=args.variant)
            except Exception:
                failures.append((a, s))
                traceback.print_exc()
    if failures:
        raise SystemExit(f"FAILED cells: {failures}")
    print("dry-run complete")


if __name__ == "__main__":
    main()
