"""The port's dry run (``launch/dryrun.py``, ``launch/specs.py``,
``launch/mesh.py``), its ``--hlo`` audit and ``scripts/torch_gen_report.py``
against the JAX reference.

The reference's dry run imports with ``XLA_FLAGS`` set to 512 host devices
(``src/repro/launch/dryrun.py:1-2``), so it runs here only in one
subprocess (``_reference``).  Its ``ok`` cells raise ``ShardingTypeError``
under jax 0.9.0 (``src/repro/models/layers.py:93``), so parity rests on
what it computes before lowering: every cell's parameter count, model
FLOPs, padding and tokens; ``input_specs`` leaf for leaf; the shard bytes
of the arguments (``NamedSharding.shard_shape``, the optimizer moments
placed as their parameters, as the port places them) against the port's
``argument_bytes``; the skip record.  The port's cells run on fake
process groups in this process (each test destroys its group), cut to 2
layers a stage where they run a step; records go to ``tmp_path`` only.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
ARCH = "internlm2-1.8b"
#: the cells whose argument bytes are held to the reference's shard bytes
BYTE_CELLS = (("decode_32k", False), ("decode_32k", True),
              ("train_4k", False))
#: the depth a stage is cut to where a cell runs its step here
LAYERS = 2

_REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding
from repro.launch import dryrun as D
from repro.configs import (ARCH_IDS, SHAPES, apply_shape, get_config,
                           resolve_for_mesh, shape_skip_reason)
from repro.distributed import cache_shardings, make_rules, param_shardings
from repro.launch.mesh import make_production_mesh
from repro.launch.specs import input_specs, tokens_of_shape
from repro.models import abstract_params, count_params, param_specs

def norm(spec):
    return None if spec is None else [
        list(p) if isinstance(p, tuple) and len(p) > 1 else
        (p[0] if isinstance(p, tuple) else p) for p in spec]

def flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        sh = getattr(leaf, "sharding", None)
        out[key] = [list(leaf.shape), jnp.dtype(leaf.dtype).name,
                    norm(sh.spec) if sh is not None else None]
    return out

def nbytes(shape, dtype, sh):
    shape = sh.shard_shape(shape) if sh is not None else shape
    return int(np.prod(shape)) * jnp.dtype(dtype).itemsize

meshes = {False: make_production_mesh(),
          True: make_production_mesh(multi_pod=True)}
out = {"cells": {}, "specs": {}, "bytes": {}}
for arch in ARCH_IDS:
    cfg0 = get_config(arch)
    for name, shape in SHAPES.items():
        if shape_skip_reason(arch, name):
            continue
        cfg = apply_shape(resolve_for_mesh(cfg0, tp=16), shape)
        out["cells"][f"{arch}|{name}"] = {
            "n_params": count_params(abstract_params(param_specs(cfg))),
            "model_flops": D.cell_model_flops(cfg0, shape),
            "pad_info": [list(p) for p in cfg.pad_info],
            "tokens": tokens_of_shape(shape)}
        for mp, mesh in meshes.items():
            ins = input_specs(cfg, shape, mesh, shape.global_batch >= 8)
            out["specs"][f"{arch}|{name}|{mp}"] = flat(ins)

arch = %(arch)r
for name, mp in %(cells)r:
    mesh, shape = meshes[mp], SHAPES[name]
    cfg = apply_shape(resolve_for_mesh(get_config(arch), tp=16), shape)
    bsh = shape.global_batch >= 8
    profile = "train" if shape.kind == "train" else "serve"
    specs = param_specs(cfg)
    pabs = abstract_params(specs, jnp.dtype(cfg.param_dtype))
    psh = param_shardings(specs, mesh, make_rules(profile, mesh))
    pl = jax.tree_util.tree_leaves(pabs)
    sl = jax.tree_util.tree_leaves(psh)
    n = sum(nbytes(p.shape, p.dtype, s) for p, s in zip(pl, sl))
    ins = input_specs(cfg, shape, mesh, bsh)
    cache = ins.pop("cache", None)
    n += sum(nbytes(x.shape, x.dtype, x.sharding)
             for x in jax.tree_util.tree_leaves(ins))
    if cache is not None:
        csh = cache_shardings(mesh, cache, bsh, kv_shard=cfg.kv_shard)
        n += sum(nbytes(c.shape, c.dtype, s) for c, s in zip(
            jax.tree_util.tree_leaves(cache), jax.tree_util.tree_leaves(csh)))
    if shape.kind == "train":
        # adamw's two float32 moments placed as their parameters, the
        # step and the count replicated
        n += sum(2 * nbytes(p.shape, jnp.float32, s) for p, s in zip(pl, sl))
        n += 2 * 4
    out["bytes"][f"{name}|{mp}"] = n

D.run_cell("qwen2-7b", "long_500k", False,
           out_dir=__import__("pathlib").Path(sys.argv[1]), verbose=False)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ref_dryrun")
    script = _REFERENCE % {"arch": ARCH, "cells": BYTE_CELLS}
    r = subprocess.run(
        [sys.executable, "-c", script, str(tmp)], capture_output=True,
        text=True, timeout=300, env=dict(
            os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    out["skip"] = json.loads(
        (tmp / "qwen2-7b__long_500k__pod.json").read_text())
    return out


@pytest.fixture
def fake_group():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def cut(monkeypatch):
    """Every stage (and the encoder) cut to LAYERS layers where a step
    runs."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    def cut_config(arch):
        cfg = get_config(arch)
        return cfg.replace(stages=tuple(
            dataclasses.replace(st, n_layers=min(st.n_layers, LAYERS))
            for st in cfg.stages), enc_layers=min(cfg.enc_layers, LAYERS))
    monkeypatch.setattr(dryrun, "get_config", cut_config)


# --------------------------------------------------------- without a step
def test_cell_counts_match_reference(reference):
    from repro_torch.configs import (ARCH_IDS, SHAPES, apply_shape,
                                     get_config, resolve_for_mesh,
                                     shape_skip_reason)
    from repro_torch.launch.dryrun import cell_model_flops
    from repro_torch.launch.specs import tokens_of_shape
    from repro_torch.models import param_specs
    from repro_torch.tree import leaves

    n = 0
    for arch in ARCH_IDS:
        cfg0 = get_config(arch)
        for name, shape in SHAPES.items():
            if shape_skip_reason(arch, name):
                continue
            cfg = apply_shape(resolve_for_mesh(cfg0, tp=16), shape)
            got = {"n_params": sum(_numel(p.shape)
                                   for p in leaves(param_specs(cfg))),
                   "model_flops": cell_model_flops(cfg0, shape),
                   "pad_info": [list(p) for p in cfg.pad_info],
                   "tokens": tokens_of_shape(shape)}
            assert got == reference["cells"][f"{arch}|{name}"], (arch, name)
            n += 1
    assert n == len(reference["cells"]) == 32


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def _spec(spec):
    return None if spec is None else [
        list(p) if isinstance(p, tuple) else p for p in spec]


def test_input_specs_match_reference(reference, fake_group):
    from repro_torch.configs import (ARCH_IDS, SHAPES, apply_shape,
                                     get_config, resolve_for_mesh,
                                     shape_skip_reason)
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.tree import leaves_with_path

    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch in ARCH_IDS:
            for name, shape in SHAPES.items():
                if shape_skip_reason(arch, name):
                    continue
                cfg = apply_shape(resolve_for_mesh(get_config(arch), tp=16),
                                  shape)
                ins = input_specs(cfg, shape, mesh, shape.global_batch >= 8)
                got = {p: [list(a.shape), str(a.dtype).replace("torch.", ""),
                           _spec(a.spec)]
                       for p, a in leaves_with_path(ins)}
                assert got == reference["specs"][f"{arch}|{name}|{mp}"], (
                    arch, name, mp)


@pytest.mark.parametrize("name,mp", BYTE_CELLS)
def test_argument_bytes_match_reference_shard_bytes(reference, fake_group,
                                                    name, mp):
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import local_bytes, place_cell
    from repro_torch.launch.mesh import make_production_mesh
    cell = place_cell(ARCH, SHAPES[name], make_production_mesh(multi_pod=mp))
    assert local_bytes(cell.args) == reference["bytes"][f"{name}|{mp}"]


def test_skip_record_matches_reference(reference, tmp_path):
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("qwen2-7b", "long_500k", False, tmp_path, verbose=False)
    assert rec == reference["skip"]
    assert json.loads((tmp_path / "qwen2-7b__long_500k__pod.json")
                      .read_text()) == reference["skip"]


# ----------------------------------------------------------- with a step
@pytest.fixture
def records(tmp_path, cut, fake_group):
    """The CLI's records of one cell on one pod and on two."""
    from repro_torch.launch import dryrun
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for extra in ([], ["--multi-pod"]):
            dryrun.main(["--arch", ARCH, "--shape", "decode_32k", "--out",
                         str(tmp_path), *extra])
    assert out.getvalue().strip().endswith("dry-run complete")
    return tmp_path


def test_cli_cell_invariants(records):
    pod = json.loads((records / f"{ARCH}__decode_32k__pod.json").read_text())
    mp = json.loads((records / f"{ARCH}__decode_32k__multipod.json")
                    .read_text())
    assert pod["status"] == "ok" and mp["status"] == "ok"
    assert pod["chips"] == 256 and mp["chips"] == 512
    assert pod["mesh"] == "data:16xmodel:16"
    assert mp["mesh"] == "pod:2xdata:16xmodel:16"
    for r in (pod, mp):
        rl = r["roofline"]
        assert rl["t_memory"] > 0 and rl["hlo_flops"] > 0
        assert r["memory"]["peak_bytes_per_device"] > 0
        assert set(r) >= {"n_params", "model_flops", "ideal_bytes",
                          "pad_info", "t_lower_s", "t_compile_s",
                          "profile", "optimizer", "memory", "roofline"}
    assert mp["memory"]["argument_bytes"] < pod["memory"]["argument_bytes"]


def test_hlo_audit_tables(cut, fake_group, capsys):
    from repro_torch.analysis.hlo import main
    from repro_torch.launch.dryrun import count_cell
    assert main([ARCH, "decode_32k"], json_mode=True) == 0
    sections = [json.loads(ln) for ln in
                capsys.readouterr().out.strip().splitlines()]
    assert [s["section"] for s in sections] == [
        f"hlo {k}: {ARCH} x decode_32k x baseline (pod)"
        for k in ("memory", "collectives")]
    for s in sections:
        assert s["rows"]
        assert all(set(r) == {"gib", "x", "kind", "tag"} for r in s["rows"])
        gib = [float(r["gib"]) for r in s["rows"]]
        assert gib == sorted(gib, reverse=True)
    costs, _, _ = count_cell(ARCH, "decode_32k", False, where=True)
    assert sum(b for (coll, _, _), (b, _) in costs.rows.items()
               if not coll) == costs.bytes
    assert sum(b for (coll, _, _), (b, _) in costs.rows.items()
               if coll) == sum(costs.coll_bytes.values())
    assert main([ARCH]) == 2


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_report_tables_match_reference_report(records, monkeypatch):
    ref = _load(REPO / "scripts" / "gen_report.py", "ref_gen_report")
    port = _load(REPO / "scripts" / "torch_gen_report.py", "torch_report")
    outs = []
    for mod in (ref, port):
        monkeypatch.setattr(mod, "ART", records)
        monkeypatch.setattr(sys, "argv", ["gen_report.py"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main()
        outs.append(buf.getvalue().splitlines())
    want, got = outs
    assert want and "### Collective mix (single-pod)" in want
    assert got[:len(want)] == want
