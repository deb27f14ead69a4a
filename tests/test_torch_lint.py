"""The port's analysis CLI and its hot-path lint, on the CPU.

* each lint rule fires on a seeded snippet and is silenced by its
  ``# analysis: allow(<rule>)`` suppression (the reference's syntax);
  metadata reads, host-valued torch calls and host helpers do not fire;
* the port's tree lints clean, and ``golden_check`` finds no floating
  node in ``ppa_eval_ref`` but finds the one a seeded snippet has;
* ``render`` prints what the reference's does for the same rows, as text
  and as JSON;
* ``python -m repro_torch.analysis`` gives the reference CLI's rows for
  ``--certify-config sigmoid`` and ``--certify-grid --smoke``, and its exit
  codes.

Stores are written only under ``tmp_path``; only 7-bit tables compile."""

import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import __main__ as ref_cli  # noqa: E402
from repro.analysis.report import render as ref_render  # noqa: E402
from repro_torch.analysis import __main__ as cli  # noqa: E402
from repro_torch.analysis.lint import (DEFAULT_LINT_TARGETS,  # noqa: E402
                                       golden_check, lint_paths)
from repro_torch.analysis.report import render  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _lint(tmp_path, rel, body):
    p = tmp_path / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(body)
    return [f.rule for f in lint_paths([p])], p


#: (name, body of a hot function's statement) — each a host sync
HOST_SYNCS = [
    ("item", "    return y.item()\n"),
    ("cpu", "    return y.cpu()\n"),
    ("tolist", "    return y.tolist()\n"),
    ("numpy", "    return y.numpy()\n"),
    ("cpu-numpy", "    return y.cpu().numpy()\n"),
    ("int", "    return int(y)\n"),
    ("float", "    return float(y.sum())\n"),
    ("np.asarray", "    return np.asarray(y)\n"),
    ("synchronize", "    torch.cuda.synchronize()\n    return 0\n"),
    ("if", "    if y > 0:\n        return 1\n    return 0\n"),
    ("while", "    while y.any():\n        y = y - 1\n    return 0\n"),
    ("decode-taint", "    z, c = decode_step(p, cfg, c, t, q, a)\n"
                     "    return int(z[0])\n"),
]


@pytest.mark.parametrize("name,stmt", HOST_SYNCS,
                         ids=[n for n, _ in HOST_SYNCS])
def test_host_sync_fires_and_is_suppressed(tmp_path, name, stmt):
    body = ("import numpy as np\nimport torch\n"
            "def _sample_rows(x):\n"
            "    y = torch.argmax(x, dim=-1)\n" + stmt)
    rules, p = _lint(tmp_path, "serve/engine.py", body)
    assert rules == ["host-sync"]
    # the same function outside the hot set is not linted
    assert _lint(tmp_path, "serve/other.py", body)[0] == []
    # a suppression on the line above the flagged statement silences it
    line = lint_paths([p])[0].line
    lines = body.splitlines(keepends=True)
    lines.insert(line - 1, "    # the contract's sync.  "
                           "analysis: allow(host-sync)\n")
    p.write_text("".join(lines))
    assert lint_paths([p]) == []


@pytest.mark.parametrize("stmt", [
    # a host helper launders its argument (the callee is linted alone)
    "    rows = _to_host(y)\n    return int(rows[0])\n",
    # metadata reads and host-valued torch calls are host values
    "    if y.shape[0] > 1 and y.device.type == 'cuda':\n        return 1\n"
    "    return 0\n",
    "    if torch.is_grad_enabled() and y.dtype == torch.bool:\n"
    "        return 1\n    return 0\n",
    "    if y is not None:\n        return y.numel()\n    return 0\n",
    # an untainted name: the tenant front's and engine's host bookkeeping
    "    n = int(x.count)\n    return n\n",
])
def test_host_values_do_not_fire(tmp_path, stmt):
    body = ("import torch\n"
            "def _to_host(v):\n    return v\n"
            "def step(x):\n"
            "    y = torch.argmax(x, dim=-1)\n" + stmt)
    assert _lint(tmp_path, "serve/engine.py", body)[0] == []
    assert _lint(tmp_path, "serve/tenants.py", body)[0] == []


@pytest.mark.parametrize("test", ["torch.any(x > 0)", "y.any()", "y",
                                  "y.sum() > 0"])
def test_tracer_branch_fires_and_is_suppressed(tmp_path, test):
    body = ("import torch\n"
            "def f(x):\n"
            "    y = torch.abs(x)\n"
            f"    if {test}:\n"
            "        return x\n"
            "    return -x\n")
    for rel in ("kernels/ops.py", "kernels/new_module.py",
                "core/datapath.py"):
        assert _lint(tmp_path, rel, body)[0] == ["tracer-branch"]
    assert _lint(tmp_path, "models/mlp.py", body)[0] == []
    rules, p = _lint(tmp_path, "kernels/ops.py", body.replace(
        f"    if {test}:", f"    if {test}:  # analysis: allow(tracer-branch)"
        " by design"))
    assert rules == []


def test_tracer_branch_skips_metadata(tmp_path):
    body = ("import torch\n"
            "def f(x, where):\n"
            "    y = torch.abs(x)\n"
            "    if y.device.type == 'cpu' or y.numel() == 0:\n"
            "        return y\n"
            "    if where is not None and where.dtype != torch.bool:\n"
            "        raise TypeError\n"
            "    if torch.is_grad_enabled() and y.requires_grad:\n"
            "        return y\n"
            "    return -y\n")
    assert _lint(tmp_path, "kernels/fused.py", body)[0] == []


@pytest.mark.parametrize("expr", ["sel[0] * x / 2", "sel[0] * 0.5",
                                  "float(sel[0])", "x.to(torch.float32)",
                                  "x.float()", "x.to(torch.float)",
                                  "x.double()"])
def test_float_int_path_fires_and_is_suppressed(tmp_path, expr):
    body = ("import torch\n"
            "def horner_int(sel, x, plan):\n"
            f"    return {expr}\n")
    rules, p = _lint(tmp_path, "kernels/helper.py", body)
    assert set(rules) == {"float-int-path"}
    assert _lint(tmp_path, "kernels/helper2.py",
                 body.replace("horner_int", "not_golden"))[0] == []
    p.write_text(body.replace(
        f"    return {expr}",
        f"    # analysis: allow(float-int-path) a seeded case\n"
        f"    return {expr}"))
    assert lint_paths([p]) == []


def test_nondet_iteration_fires_and_is_fixed_or_suppressed(tmp_path):
    body = ("def merge(root):\n"
            "    out = []\n"
            "    for f in root.glob('*.json'):\n"
            "        out.append(f)\n"
            "    return out\n")
    rules, p = _lint(tmp_path, "compiler/store.py", body)
    assert rules == ["nondet-iter"]
    assert _lint(tmp_path, "compiler/other.py", body)[0] == []
    p.write_text(body.replace("root.glob('*.json')",
                              "sorted(root.glob('*.json'))"))
    assert lint_paths([p]) == []
    p.write_text(body.replace(
        "    for f", "    # order never reaches a key.  "
        "analysis: allow(nondet-iter)\n    for f"))
    assert lint_paths([p]) == []


def test_port_tree_lints_clean():
    """The default scope — the port's hot and keyed files — lints clean:
    every deliberate sync carries its suppression and reason, and the
    suppressions are the ones the design names."""
    found = lint_paths(root=ROOT)
    assert found == [], "\n".join(f.describe() for f in found)
    assert all((ROOT / t).exists() for t in DEFAULT_LINT_TARGETS)
    allows = {}
    for t in DEFAULT_LINT_TARGETS:
        for f in ([ROOT / t] if t.endswith(".py")
                  else sorted((ROOT / t).rglob("*.py"))):
            n = f.read_text().count("analysis: allow(")
            if n:
                allows[f.relative_to(ROOT / "src").as_posix()] = n
    assert allows == {"repro_torch/serve/engine.py": 2,
                      "repro_torch/core/searchspace.py": 1,
                      "repro_torch/compiler/store.py": 1}


def test_golden_check():
    assert golden_check() == []

    def leaky(x_int, starts, coefs, plan):
        return (x_int * coefs[0, 0]) / 2

    bad = golden_check(leaky)
    assert bad and all("float" in b for b in bad)


ROWS = [{"path": "a.py", "line": 3, "rule": "host-sync", "message": "m"},
        {"path": "bb/c.py", "line": 12, "rule": "nondet-iter",
         "message": "longer message"}]
COLS = ("path", "line", "rule", "message")


@pytest.mark.parametrize("json_mode", [False, True])
@pytest.mark.parametrize("rows", [ROWS, []])
def test_render_is_the_references(json_mode, rows):
    ours, ref = io.StringIO(), io.StringIO()
    render("lint", rows, COLS, json_mode=json_mode, out=ours)
    ref_render("lint", rows, COLS, json_mode=json_mode, out=ref)
    assert ours.getvalue() == ref.getvalue()


def _json_rows(text):
    return [json.loads(ln) for ln in text.strip().splitlines()]


def test_certify_config_rows_equal_the_references(capsys):
    assert cli.main(["--certify-config", "sigmoid", "--json"]) == 0
    ours = _json_rows(capsys.readouterr().out)
    assert ref_cli.main(["--certify-config", "sigmoid", "--json"]) == 0
    assert ours == _json_rows(capsys.readouterr().out)
    assert [s["section"] for s in ours] == [
        "certify-config (envelope estimate)", "assumptions"]


def test_certify_grid_smoke_rows_equal_the_references(tmp_path, capsys):
    """The port compiles the 7-bit grid into its store; the reference's
    CLI reads a copy of those artifacts (the stores are byte-compatible)
    and certifies them itself: the same rows.  ``--diff`` then finds no
    drift, and a missing certificate shows."""
    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    assert cli.main(["--certify-grid", "--smoke", "--store", str(ours_dir),
                     "--json"]) == 0
    ours = _json_rows(capsys.readouterr().out)
    ref_dir.mkdir()
    for p in sorted(ours_dir.glob("*.json")):
        if not p.name.endswith(".cert.json"):
            shutil.copy(p, ref_dir / p.name)
    assert ref_cli.main(["--certify-grid", "--smoke", "--store",
                         str(ref_dir), "--json"]) == 0
    assert ours == _json_rows(capsys.readouterr().out)
    assert len(ours[0]["rows"]) == 12 and all(r["ok"]
                                              for r in ours[0]["rows"])
    assert cli.main(["--diff", "--smoke", "--store", str(ours_dir),
                     "--json"]) == 0
    diff = _json_rows(capsys.readouterr().out)[0]["rows"]
    assert {r["status"] for r in diff} == {"ok"}
    next(ours_dir.glob("*.cert.json")).unlink()
    assert cli.main(["--diff", "--smoke", "--store", str(ours_dir),
                     "--json"]) == 0
    diff = _json_rows(capsys.readouterr().out)[0]["rows"]
    assert sorted(r["status"] for r in diff).count("missing") == 1


def test_lint_cli_exit_codes(tmp_path):
    """``--lint`` exits 0 on the port's tree and 1 on a finding, whose
    JSON report names it."""
    env_cmd = [sys.executable, "-m", "repro_torch.analysis", "--lint"]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run(env_cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    _, p = _lint(tmp_path, "serve/engine.py",
                 "import torch\ndef step(x):\n"
                 "    return torch.argmax(x).item()\n")
    out = subprocess.run(env_cmd + ["--json", str(p)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    rows = json.loads(out.stdout)["rows"]
    assert [(r["line"], r["rule"]) for r in rows] == [(3, "host-sync")]
