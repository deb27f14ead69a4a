"""The port's distribution layer against the JAX reference.

* Without processes: the rule tables and every parameter leaf's spec of
  every arch after ``resolve_for_mesh``, for the three profiles on both
  axis sets; ``resolve_for_mesh`` itself at tp=16; ``q8_encode`` and
  ``q8_decode`` bit for bit; placements and local shards as jax's
  ``NamedSharding`` cuts them.
* On gloo process groups: one spawn of RANKS ranks runs every multi-rank
  case (``_rank_main``), initialised through a ``file://`` store under
  ``tmp_path``, every wait with a time limit.  The ranks import torch and
  the port alone: this module imports JAX and the reference only inside
  the functions the parent runs, which compute the reference's outputs and
  hand them over as numpy arrays.  The cases: the sharded MoE on a (2, 4)
  mesh in both modes against the reference's local ``moe_block`` (the
  reference's own tolerance for sharded against local,
  ``tests/test_distributed.py``), and on a (1, 1) mesh exactly equal to
  the port's local path (global weights and DTensor shards);
  ``ef_allreduce`` on 4 ranks against the reference's q8 mean, and its
  error feedback over 20 steps; ``pipeline_apply`` on 4 stages against the
  reference's sequential loop; a checkpoint saved from a (4, 2) mesh and
  restored onto (2, 4); the smoke moonshot served on a (1, 2) mesh, its
  greedy tokens equal to the reference engine's; adafactor on leaves
  split over none, one, two and three mesh axes of a 2-D and a 3-D mesh,
  three steps equal to the local update and to the reference's, with no
  collective in ``opt_init`` and only the statistics' all-reduces in
  ``opt_update`` (``CommDebugMode`` and a dispatch recorder); the gather
  and the sum of ``collectives`` on tensors that need a gradient, their
  gradients the transposes, with no ``FutureWarning``.
"""

import datetime
import pickle
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

RANKS = 8
#: the whole spawn, and any one collective, may take no longer
SPAWN_TIMEOUT_S, COLLECTIVE_TIMEOUT_S = 240, 120
#: sharded against local MoE (the reference's tolerance,
#: tests/test_distributed.py::test_moe_sharded_matches_local)
MOE_ATOL, MOE_RTOL = 2e-5, 1e-4
#: the pipeline against the sequential loop (the reference's tolerance)
PP_ATOL, PP_RTOL = 1e-5, 1e-4
#: the q8 mean: the same decoded rows summed in another order
EF_RTOL = 1e-6
#: error feedback: the accumulated compressed mean against the exact one,
#: as the reference's test holds it
EF_ACCUM_REL = 0.02
MOE_KW = dict(d_model=32, d_ff=16, n_experts=8, top_k=2,
              capacity_factor=8.0)
PP_L, PP_B, PP_T, PP_D, PP_MICRO, PP_STAGES = 8, 8, 4, 16, 4, 4
EF_RANKS, EF_STEPS = 4, 20
SERVE_LENS, SERVE_NEW = (5, 7, 3, 6), 6
#: adafactor on shards: the meshes (8 ranks each) and the leaves, each
#: (shape, its spec on the 2-D mesh, on the 3-D one): factored and split
#: over two axes (three on the 3-D mesh, one dim over "pod" and "data"),
#: factored over one, factored and whole, unfactored over two, a vector.
#: The unfactored matrix's parameters are held to the optimizer's
#: tolerances plus its whole-leaf RMS mean's order term
#: (test_torch_train.py::rms_order_atol): its mean is summed in another
#: order on each mesh, off a mesh and in the reference
ADA_MESHES = {"2d": ((4, 2), ("data", "model")),
              "3d": ((2, 2, 2), ("pod", "data", "model"))}
ADA_LEAVES = {
    "a": ((4, 256, 512), (None, "data", "model"),
          (None, ("pod", "data"), "model")),
    "b": ((256, 128), ("model", None), ("model", None)),
    "c": ((128, 256), (None, None), (None, None)),
    "d": ((4, 64, 32), ("data", None, "model"), ("pod", None, "model")),
    "e": ((256,), ("model",), (("data", "model"),)),
}
ADA_STEPS = 3
#: the leaf held with the RMS mean's order term
ADA_UNFACTORED = "d"
ARCH = "moonshot-v1-16b-a3b"
MODES = ("weight_gather", "token_gather")


class FakeMesh:
    """Only ``axis_names``, as the reference's own rule test uses."""

    def __init__(self, names):
        self.axis_names = names


AXIS_SETS = (("data", "model"), ("pod", "data", "model"))
PROFILES = ("train", "serve", "serve_wstation")


def _arch_ids():
    from repro_torch.configs import ARCH_IDS
    return ARCH_IDS


# ----------------------------------------------------------- no processes
@pytest.mark.parametrize("axes", AXIS_SETS)
@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", _arch_ids())
def test_rules_and_param_specs_match_reference(arch, profile, axes):
    import repro.configs as RC
    import repro.models as RM
    from repro.distributed import sharding as RS
    from repro_torch.configs import get_config, resolve_for_mesh
    from repro_torch.distributed import sharding as S
    from repro_torch.models import param_specs
    from repro_torch.tree import leaves_with_path

    mesh = FakeMesh(axes)
    for kv in (True, False):
        assert S.make_rules(profile, mesh, kv) == \
            RS.make_rules(profile, mesh, kv)
    rules, rrules = S.make_rules(profile, mesh), RS.make_rules(profile, mesh)
    cfg = resolve_for_mesh(get_config(arch), tp=16)
    rcfg = RC.resolve_for_mesh(RC.get_config(arch), tp=16)
    ours = dict(leaves_with_path(param_specs(cfg)))
    ref_axes = RM.param_axes(RM.param_specs(rcfg))
    import jax
    theirs = {"/".join(str(getattr(k, "key", k)) for k in path): a
              for path, a in jax.tree_util.tree_flatten_with_path(
                  ref_axes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert sorted(ours) == sorted(theirs)
    for key, p in ours.items():
        assert p.axes == theirs[key], key
        assert S._spec_for(p.axes, rules) == tuple(
            RS._spec_for(theirs[key], rrules)), key


class SizedMesh(FakeMesh):
    """Axis names and sizes, as a ``DeviceMesh`` gives them."""

    def __init__(self, names, sizes):
        super().__init__(names)
        self.mesh_dim_names, self._sizes = names, sizes

    def size(self, i):
        return self._sizes[i]


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", _arch_ids())
def test_param_shardings_divide_on_the_production_meshes(arch, shape):
    """After ``resolve_for_mesh`` every sharded dim of every leaf divides
    over its mesh axes on the reference's production meshes, in all three
    profiles, and each leaf's placements are its spec's."""
    from repro_torch.configs import get_config, resolve_for_mesh
    from repro_torch.distributed import sharding as S
    from repro_torch.models import P, param_specs
    from repro_torch.tree import leaves, map_trees

    mesh = SizedMesh(AXIS_SETS[len(shape) - 2], shape)
    specs = param_specs(resolve_for_mesh(get_config(arch), tp=16))
    for profile in PROFILES:
        rules = S.make_rules(profile, mesh)
        checked = map_trees(
            lambda p, target: target == (mesh, S.placements(
                S._spec_for(p.axes, rules), mesh)),
            specs, S.param_shardings(specs, mesh, rules))
        assert all(leaves(checked))
    with pytest.raises(ValueError):
        S.param_shardings({"w": P((10, 16), ("embed", "mlp"))}, mesh,
                          S.make_rules("train", mesh))


@pytest.mark.parametrize("kv_shard", ["heads", "seq"])
@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hymba-1.5b", "rwkv6-3b",
                                  "whisper-medium"])
def test_cache_specs_match_reference(arch, kv_shard):
    """The decode cache's spec a leaf, by leaf name, equals the reference's
    ``cache_shardings`` on the same smoke cache (a one-device jax mesh
    carries the names)."""
    import jax
    import repro.configs as RC
    import repro.models as RM
    from repro.distributed import sharding as RS
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as S
    from repro_torch.models import init_cache
    from repro_torch.tree import leaves_with_path

    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    rcache = RM.init_cache(RC.get_smoke_config(arch), 2, 8)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(sh.spec)
            for path, sh in jax.tree_util.tree_flatten_with_path(
                RS.cache_shardings(rmesh, rcache, kv_shard=kv_shard))[0]}
    cache = init_cache(get_smoke_config(arch), 2, 8, device="cpu")
    got = {key: S.cache_spec(key.split("/")[-1], t.dim(), "data", kv_shard)
           for key, t in leaves_with_path(cache)}
    assert got == want


@pytest.mark.parametrize("arch", _arch_ids())
def test_resolve_for_mesh_matches_reference(arch):
    import dataclasses
    import repro.configs as RC
    from repro_torch.configs import get_config, resolve_for_mesh

    for kv_shard in ("heads", "seq"):
        ours = resolve_for_mesh(get_config(arch).replace(kv_shard=kv_shard),
                                tp=16)
        theirs = RC.resolve_for_mesh(
            RC.get_config(arch).replace(kv_shard=kv_shard), tp=16)
        got = dataclasses.asdict(ours)
        want = dataclasses.asdict(theirs)
        got.pop("act_backend"), want.pop("act_backend")
        assert got == want


def test_resolve_for_mesh_keeps_the_reference_asserts():
    from repro_torch.configs import get_config, resolve_for_mesh
    with pytest.raises(AssertionError):
        resolve_for_mesh(get_config("internlm2-1.8b"), tp=3)


@pytest.mark.parametrize("shape", [(), (7,), (5, 33), (2, 3, 64)])
def test_q8_encode_decode_equal_reference(shape):
    import jax.numpy as jnp
    from repro.distributed import compression as RCMP
    from repro_torch.distributed import q8_decode, q8_encode

    rng = np.random.default_rng(len(shape))
    x = np.asarray(rng.normal(0, 3, shape)
                   * 10.0 ** rng.integers(-3, 3, shape), np.float32)
    if shape:
        x.reshape(-1)[0] = 0.0          # a zero
        x[..., -1] = 0.0                # and a row of zeros
        x.reshape(-1, shape[-1])[0, 1] = 2.5 * np.abs(x).max() / 127
        x.reshape(-1, shape[-1])[0, 2] = np.abs(x).max()
    rq, rs = RCMP.q8_encode(jnp.asarray(x))
    q, s = q8_encode(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        q8_decode(q, s).numpy(), np.asarray(RCMP.q8_decode(rq, rs)))


def test_q8_rounds_half_to_even():
    from repro_torch.distributed import q8_encode
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, s = q8_encode(x)
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2]]


def test_placements_cut_as_named_sharding():
    """A dim split over ("pod", "data") is Shard on both mesh dims, and a
    rank's shard is the block jax's NamedSharding gives it (pod major)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import placements

    mesh = FakeMesh(("pod", "data", "model"))
    assert placements((("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert placements((None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError):
        placements((("data", "pod"),), mesh)


def test_bubble_fraction():
    from repro.distributed import bubble_fraction as ref
    from repro_torch.distributed import bubble_fraction
    for s, m in ((4, 4), (2, 8), (1, 3), (8, 16)):
        assert bubble_fraction(s, m) == ref(s, m)
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-12


# -------------------------------------------------------------- the ranks
def _moe_inputs(seed=0):
    rng = np.random.default_rng(seed)
    d, f, e = MOE_KW["d_model"], MOE_KW["d_ff"], MOE_KW["n_experts"]
    params = {
        "router": rng.normal(0, 0.5, (d, e)).astype(np.float32),
        "w_gate": rng.normal(0, 0.3, (e, d, f)).astype(np.float32),
        "w_up": rng.normal(0, 0.3, (e, d, f)).astype(np.float32),
        "w_down": rng.normal(0, 0.3, (e, f, d)).astype(np.float32),
    }
    return rng.normal(0, 1, (4, 8, d)).astype(np.float32), params


def _reference(tmp_path):
    """Everything the ranks are held to, computed with the reference (JAX
    on the CPU) in this process."""
    import jax
    import jax.numpy as jnp
    import repro.configs as RC
    import repro.serve as RSV
    from repro.distributed import compression as RCMP
    from repro.models import ShardCtx
    from repro.models import moe as RMOE
    from repro.models.activations import make_acts as ref_make_acts

    from test_torch_models import seeded_store
    from test_torch_recurrent import ref_params

    out = {}
    x, params = _moe_inputs()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    acts = ref_make_acts("exact")
    for mode in MODES:
        cfg = RMOE.MoECfg(**MOE_KW, mode=mode)
        y, aux = RMOE.moe_block(jp, jnp.asarray(x), cfg, acts, ShardCtx())
        out[f"moe_{mode}"] = np.asarray(y)
        out[f"moe_aux_{mode}"] = float(aux)
    # weight_gather on 2 data rows: each row's switch loss, averaged
    cfg = RMOE.MoECfg(**MOE_KW)
    halves = [RMOE._route(jnp.asarray(h.reshape(-1, MOE_KW["d_model"])),
                          jp["router"], cfg)[2] for h in np.split(x, 2)]
    out["moe_aux_weight_gather"] = float(np.mean(
        [float(a) for a in halves]))

    rng = np.random.default_rng(3)
    g = rng.normal(0, 1, (EF_RANKS, 64)).astype(np.float32)
    out["ef_g"] = g
    dec = [np.asarray(RCMP.q8_decode(*RCMP.q8_encode(jnp.asarray(r))))
           for r in g]
    out["ef_mean"] = np.asarray(jnp.mean(jnp.stack(dec), axis=0))
    out["ef_exact_accum"] = sum(
        (g * (1.0 + 0.1 * s)).mean(0) for s in range(EF_STEPS))

    w = (np.random.default_rng(4).normal(0, 1, (PP_L, PP_D, PP_D))
         * 0.1).astype(np.float32)
    h = np.random.default_rng(5).normal(
        0, 1, (PP_B, PP_T, PP_D)).astype(np.float32)
    ref = jnp.asarray(h)
    for i in range(PP_L):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    out.update(pp_w=w, pp_h=h, pp_ref=np.asarray(ref))

    rcfg = RC.get_smoke_config(ARCH).replace(act_impl="ppa")
    rparams = ref_params(rcfg)
    prompts = [np.random.default_rng(0).integers(0, rcfg.vocab, n).astype(
        np.int32) for n in SERVE_LENS]
    reng = RSV.ServeEngine(rcfg, jax.tree_util.tree_map(jnp.asarray,
                                                        rparams),
                           n_slots=4, cache_len=32,
                           table_store=seeded_store())
    reqs = [RSV.Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        reng.submit(r)
    reng.run_until_drained()
    out.update(serve_params=rparams, serve_prompts=prompts,
               serve_tokens=[list(r.output) for r in reqs])
    out["ckpt_dir"] = str(tmp_path / "ckpt")
    out.update(_adafactor_reference())
    return out


def _adafactor_inputs():
    rng = np.random.default_rng(7)
    params = {k: rng.normal(size=shape).astype(np.float32)
              for k, (shape, _, _) in ADA_LEAVES.items()}
    grads = [{k: (0.1 * rng.normal(size=shape)).astype(np.float32)
              for k, (shape, _, _) in ADA_LEAVES.items()}
             for _ in range(ADA_STEPS)]
    return params, grads


def _adafactor_reference():
    """The reference's adafactor over ADA_STEPS steps (as
    ``test_torch_train.py`` runs its four kinds)."""
    import jax
    import jax.numpy as jnp
    import repro.train as RT
    from test_torch_train import rms_order_atol
    params, grads = _adafactor_inputs()
    cfg = RT.OptCfg(kind="adafactor")
    # copies both ways: jnp.asarray and np.asarray may alias a buffer
    p = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params)
    st = RT.opt_init(cfg, p)
    traj = [params[ADA_UNFACTORED]]
    for i, g in enumerate(grads):
        p, st = RT.opt_update(
            cfg, jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), g),
            st, p, jnp.float32(1e-2 / (i + 1)))
        traj.append(np.array(p[ADA_UNFACTORED]))
    return {"ada_params": jax.tree_util.tree_map(np.array, p),
            "ada_state": jax.tree_util.tree_map(np.array, st["mu"]),
            "ada_extra": rms_order_atol(
                traj, [float(np.float32(1e-2 / (i + 1)))
                       for i in range(ADA_STEPS)], cfg.weight_decay)}


def _moe_cases(ref, rank):
    """The sharded MoE on (2, 4) against the reference, and on a (1, 1)
    sub-mesh against the port's local path."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import make_ctx
    from repro_torch.models import make_acts
    from repro_torch.models import moe as M

    x, params = _moe_inputs()
    x = torch.from_numpy(x)
    params = {k: torch.from_numpy(v) for k, v in params.items()}
    acts = make_acts("exact", device="cpu")
    res = {}
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for mode in MODES:
        cfg = M.MoECfg(**MOE_KW, mode=mode)
        y, aux = M.moe_block(params, x, cfg, acts, make_ctx(mesh))
        res[f"moe_{mode}"] = (y.numpy(), float(aux))
    one = init_device_mesh("cpu", (RANKS, 1, 1),
                           mesh_dim_names=("lane", "data", "model"))
    sub = one["data", "model"]
    ctx = make_ctx(sub)
    for mode in MODES:
        cfg = M.MoECfg(**MOE_KW, mode=mode)
        y0, a0 = M.moe_block(params, x, cfg, acts)
        y1, a1 = M.moe_block(params, x, cfg, acts, ctx)
        y2, a2 = M.moe_block(M.shard_experts(params, cfg, ctx), x, cfg,
                             acts, ctx)
        res[f"moe_one_{mode}"] = all(
            torch.equal(a, b) for a, b in ((y0, y1), (y0, y2), (a0, a1),
                                           (a0, a2)))
    return res


def _ef_case(ref, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import ef_allreduce

    mesh = init_device_mesh("cpu", (RANKS // EF_RANKS, EF_RANKS),
                            mesh_dim_names=("lane", "dp"))
    i = mesh.get_local_rank("dp")
    g = torch.from_numpy(ref["ef_g"][i])
    mean, err = ef_allreduce(g, "dp", mesh)
    err, accum = torch.zeros_like(g), torch.zeros_like(g)
    for step in range(EF_STEPS):
        m, err = ef_allreduce(g * (1.0 + 0.1 * step) + err, "dp", mesh)
        accum = accum + m
    return {"ef_mean": mean.numpy(), "ef_accum": accum.numpy()}


def _pipeline_case(ref, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import pipeline_apply
    from repro_torch.distributed.sharding import distribute, placements

    mesh = init_device_mesh("cpu", (RANKS // PP_STAGES, PP_STAGES),
                            mesh_dim_names=("lane", "pod"))
    w = distribute(torch.from_numpy(ref["pp_w"]),
                   (mesh, placements(("pod",), mesh)))
    held = tuple(w.to_local().shape)
    out = pipeline_apply(lambda x, wl: torch.tanh(x @ wl), w,
                         torch.from_numpy(ref["pp_h"]), mesh,
                         n_micro=PP_MICRO, axis="pod")
    return {"pp": out.numpy(), "pp_held": held}


def _checkpoint_case(ref, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint import restore, save
    from repro_torch.distributed.sharding import distribute, placements

    m1 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    m2 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    spec = ("data", "model")
    x1 = distribute(x, (m1, placements(spec, m1)))
    save(ref["ckpt_dir"], 1, {"w": x1}, extra={"next_step": 1})
    target = (m2, placements(spec, m2))
    restored, extra = restore(ref["ckpt_dir"], 1, {"w": x}, {"w": target})
    w = restored["w"]
    r, c = m2.get_local_rank("data"), m2.get_local_rank("model")
    return {"ckpt_placements": tuple(w.placements) == target[1],
            "ckpt_local": torch.equal(w.to_local(),
                                      x[r * 4:(r + 1) * 4, c * 2:(c + 1) * 2]),
            "ckpt_full": torch.equal(w.full_tensor(), x),
            "ckpt_extra": extra}


def _serve_case(ref, rank):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import make_ctx
    from repro_torch.models import params_from_jax
    from repro_torch.serve import Request, ServeEngine

    mesh = init_device_mesh("cpu", (RANKS // 2, 1, 2),
                            mesh_dim_names=("lane", "data", "model"))
    ctx = make_ctx(mesh["data", "model"])
    res = {}
    for mode in MODES:
        cfg = get_smoke_config(ARCH).replace(act_impl="ppa", moe_mode=mode)
        eng = ServeEngine(cfg, params_from_jax(ref["serve_params"], "cpu"),
                          n_slots=4, cache_len=32, ctx=ctx, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new_tokens=SERVE_NEW)
                for i, p in enumerate(ref["serve_prompts"])]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        shard = eng.params["stages"]["s1_dec"][0]["moe"]["w_gate"]
        res[f"serve_{mode}"] = [list(r.output) for r in reqs]
        res[f"serve_held_{mode}"] = tuple(shard.to_local().shape)
    return res


def _recorder():
    """A dispatch mode that keeps (op name, elements of its first tensor)
    of every c10d collective."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Collectives(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func._schema.name
            if name.startswith(("c10d::", "_c10d_functional::")):
                t = args[0]
                t = t[0] if isinstance(t, (list, tuple)) else t
                self.ops.append((name, t.numel()))
            return func(*args, **(kwargs or {}))

    return Collectives()


def _adafactor_case(ref, rank):
    """Adafactor on DTensor leaves on each mesh of ADA_MESHES against the
    local update of the same inputs; what it communicates."""
    import logging
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Partial
    from torch.distributed.tensor import _redistribute
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.distributed.sharding import distribute, placements
    from repro_torch.train import OptCfg, opt_init, opt_update

    class Seq(logging.Handler):
        def __init__(self):
            super().__init__()
            self.msgs = []

        def emit(self, record):
            if "sequential" in record.getMessage():
                self.msgs.append(record.getMessage())

    seq = Seq()
    logging.getLogger(_redistribute.__name__).addHandler(seq)
    params, grads = _adafactor_inputs()
    cfg = OptCfg(kind="adafactor")
    res = {}
    for name, (shape, names) in ADA_MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        col = 1 if len(shape) == 2 else 2

        def place(tree):
            return {k: distribute(torch.from_numpy(v.copy()), (
                mesh, placements(ADA_LEAVES[k][col], mesh)))
                for k, v in tree.items()}

        local = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        lstate = opt_init(cfg, local)
        dp = place(params)
        with CommDebugMode() as init_comms:
            dstate = opt_init(cfg, dp)
        # DTensor warns once per mesh and dims; forget what it warned
        getattr(_redistribute, "_warned_flatten_issues", set()).clear()
        seq.msgs.clear()
        gathers, reduced = 0, []
        for i, g in enumerate(grads):
            lr = torch.tensor(np.float32(1e-2 / (i + 1)))
            local, lstate = opt_update(
                cfg, {k: torch.from_numpy(v) for k, v in g.items()},
                lstate, local, lr)
            dg = place(g)
            with CommDebugMode() as comms, _recorder() as rec:
                dp, dstate = opt_update(cfg, dg, dstate, dp, lr)
            gathers += sum(n for op, n in comms.get_comm_counts().items()
                           if "gather" in str(op))
            reduced += [n for op, n in rec.ops if "allreduce" in op
                        or "all_reduce" in op]
        mom = {k: v for k, v in dstate["mu"].items()}
        shard_max = max(v.to_local().numel() for m in mom.values()
                        for key, v in m.items() if key in ("vr", "vc"))
        res[f"ada_{name}"] = {
            "init_comms": init_comms.get_total_counts(),
            "gathers": gathers, "reduced": reduced, "shard_max": shard_max,
            "partial": any(isinstance(pl, Partial) for m in mom.values()
                           for v in m.values() for pl in v.placements),
            "dtensors": all(isinstance(v, DTensor) for m in mom.values()
                            for v in m.values()),
            "sequential": list(seq.msgs),
            "params": {k: v.full_tensor().numpy() for k, v in dp.items()},
            "state": {k: {n: v.full_tensor().numpy() for n, v in m.items()}
                      for k, m in mom.items()},
            "local": {k: v.numpy() for k, v in local.items()},
            "local_state": {k: {n: v.numpy() for n, v in m.items()}
                            for k, m in lstate["mu"].items()},
        }
    logging.getLogger(_redistribute.__name__).removeHandler(seq)
    return res


def _collective_grad_case(ref, rank):
    """``all_gather`` and ``all_reduce`` of ``collectives`` on a tensor
    that needs a gradient, each rank's upstream gradient scaled by its
    rank + 1: the gather's gradient is the sum of the group's upstream
    gradients at this rank's block, the sum's the sum of them."""
    import warnings
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import all_gather, all_reduce

    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    w = torch.from_numpy(np.random.default_rng(11).normal(
        size=(8, 6)).astype(np.float32))
    x0 = torch.from_numpy(np.random.default_rng(12 + rank).normal(
        size=(2, 6)).astype(np.float32))
    res = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = x0.clone().requires_grad_(True)
        y = all_gather(x, mesh, "data", dim=0)
        (y * w * (rank + 1)).sum().backward()
        group = dist.get_process_group_ranks(mesh.get_group("data"))
        i = mesh.get_local_rank("data")
        want = sum(r + 1 for r in group) * w[2 * i:2 * i + 2]
        res["grad_gather"] = (x.grad.numpy(), want.numpy(),
                              y.detach().numpy())
        x = x0.clone().requires_grad_(True)
        y = all_reduce(x, mesh, "model")
        (y * w[:2] * (rank + 1)).sum().backward()
        group = dist.get_process_group_ranks(mesh.get_group("model"))
        want = sum(r + 1 for r in group) * w[:2]
        res["grad_sum"] = (x.grad.numpy(), want.numpy())
    res["future_warnings"] = [str(c.message) for c in caught
                              if issubclass(c.category, FutureWarning)]
    return res


def _rank_main(rank, init_file, ref_path, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=RANKS,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        with open(ref_path, "rb") as f:
            ref = pickle.load(f)
        res = {}
        for case in (_moe_cases, _ef_case, _pipeline_case, _checkpoint_case,
                     _serve_case, _adafactor_case, _collective_grad_case):
            res.update(case(ref, rank))
        with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(reference outputs, each rank's results) of one spawn."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dist")
    ref = _reference(tmp)
    ref_path = tmp / "ref.pkl"
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    ctx = mp.start_processes(_rank_main, args=(
        str(tmp / "init"), str(ref_path), str(tmp)), nprocs=RANKS,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {SPAWN_TIMEOUT_S} s")
    out = []
    for r in range(RANKS):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return ref, out


@pytest.mark.parametrize("mode", MODES)
def test_sharded_moe_on_2x4_matches_reference_local(ranks, mode):
    ref, out = ranks
    for res in out:
        y, aux = res[f"moe_{mode}"]
        np.testing.assert_allclose(y, ref[f"moe_{mode}"], atol=MOE_ATOL,
                                   rtol=MOE_RTOL)
        # weight_gather averages each data row's switch loss (the
        # reference's pmean), token_gather routes every token at once
        np.testing.assert_allclose(aux, ref[f"moe_aux_{mode}"], rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_moe_on_one_rank_equals_local_path(ranks, mode):
    _, out = ranks
    assert all(res[f"moe_one_{mode}"] for res in out)


def test_ef_allreduce_matches_reference_mean(ranks):
    ref, out = ranks
    for res in out:
        np.testing.assert_allclose(res["ef_mean"], ref["ef_mean"],
                                   rtol=EF_RTOL, atol=EF_RTOL * np.abs(
                                       ref["ef_mean"]).max())


def test_ef_allreduce_error_feedback_preserves_sum(ranks):
    ref, out = ranks
    exact = ref["ef_exact_accum"]
    for res in out:
        rel = np.abs(res["ef_accum"] - exact).max() / np.abs(exact).max()
        assert rel < EF_ACCUM_REL, rel


def test_pipeline_matches_reference_sequential(ranks):
    ref, out = ranks
    for res in out:
        assert res["pp_held"] == (PP_L // PP_STAGES, PP_D, PP_D)
        np.testing.assert_allclose(res["pp"], ref["pp_ref"], atol=PP_ATOL,
                                   rtol=PP_RTOL)


def test_checkpoint_restores_onto_another_mesh(ranks):
    _, out = ranks
    for res in out:
        assert res["ckpt_placements"] and res["ckpt_local"]
        assert res["ckpt_full"]
        assert res["ckpt_extra"] == {"next_step": 1}


@pytest.mark.parametrize("mode", MODES)
def test_sharded_engine_on_1x2_matches_reference_engine(ranks, mode):
    from repro_torch.configs import get_smoke_config
    ref, out = ranks
    cfg = get_smoke_config(ARCH)
    for res in out:
        assert res[f"serve_{mode}"] == ref["serve_tokens"]
        # each rank holds half the experts
        assert res[f"serve_held_{mode}"][0] == cfg.moe_experts // 2


@pytest.mark.parametrize("mesh", list(ADA_MESHES))
def test_sharded_adafactor_matches_local_and_reference(ranks, mesh):
    """Three steps on shards: the parameters and moments equal the local
    update's and the reference's within the optimizer's tolerances."""
    from test_torch_train import OPT_ATOL, OPT_RTOL, assert_opt_close
    ref, out = ranks
    for res in out:
        r = res[f"ada_{mesh}"]
        for k, want in ref["ada_params"].items():
            extra = ref["ada_extra"] if k == ADA_UNFACTORED else 0.0
            assert_opt_close(r["params"][k], r["local"][k], extra, k)
            assert_opt_close(r["params"][k], want, extra, k)
        for k, moments in ref["ada_state"].items():
            assert set(r["state"][k]) == set(moments), k
            for n, want in moments.items():
                np.testing.assert_allclose(r["state"][k][n],
                                           r["local_state"][k][n],
                                           rtol=OPT_RTOL, atol=OPT_ATOL)
                np.testing.assert_allclose(r["state"][k][n], want,
                                           rtol=OPT_RTOL, atol=OPT_ATOL)


@pytest.mark.parametrize("mesh", list(ADA_MESHES))
def test_sharded_adafactor_reduces_only_statistics(ranks, mesh):
    """No collective in ``opt_init``; in ``opt_update`` no gather, and no
    all-reduce larger than a ``vr`` / ``vc`` shard; the moments stored as
    DTensors with no ``Partial``; no sequential all-reduce of DTensor's."""
    _, out = ranks
    for res in out:
        r = res[f"ada_{mesh}"]
        assert r["init_comms"] == 0
        assert r["gathers"] == 0
        assert r["reduced"] and max(r["reduced"]) <= r["shard_max"]
        assert r["dtensors"] and not r["partial"]
        assert r["sequential"] == []


def test_collective_gradients_are_the_transposes(ranks):
    _, out = ranks
    for res in out:
        got, want, y = res["grad_gather"]
        assert y.shape == (8, 6)
        np.testing.assert_allclose(got, want, rtol=1e-6)
        got, want = res["grad_sum"]
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert res["future_warnings"] == []
