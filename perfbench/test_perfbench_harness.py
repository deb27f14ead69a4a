"""CPU tests of the benchmark harness: cells, metrics and configurations
found by name (one added as files only), the yardstick's arithmetic, the
trace summary and the tails, the import check, and whole smoke runs whose
timed path is broken underneath."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from perfbench.harness import spec as spec_mod  # noqa: E402
from perfbench.harness.checks import judge, train_numbers  # noqa: E402
from perfbench.harness.main import forbidden_modules, run_cell  # noqa: E402
from perfbench.harness.trace import (device_ops, gaps,  # noqa: E402
                                     idle_gaps, union_s)
from perfbench.harness.work import (causal_pairs, percentile,  # noqa: E402
                                    products, train_flops)

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CPU = torch.device("cpu")

SMOKE_MODELS = {
    "internlm2-1.8b": {
        "kind": "dec", "n_layers": 2, "d_model": 64, "n_q": 4, "n_kv": 2,
        "head_dim": 16, "d_ff": 128, "vocab": 512, "norm": "rmsnorm",
        "gate": "silu", "tie_embeddings": False, "rope_theta": 10000.0,
        "enc_layers": 0, "enc_seq": 0, "init_std": 0.02},
    "whisper-medium": {
        "kind": "xdec", "n_layers": 2, "d_model": 64, "n_q": 4, "n_kv": 4,
        "head_dim": 16, "d_ff": 128, "vocab": 512, "norm": "layernorm",
        "gate": "gelu", "tie_embeddings": True, "rope_theta": 10000.0,
        "enc_layers": 2, "enc_seq": 24, "init_std": 0.02},
}
SMOKE_TRAFFIC = {
    "train-8x1024": {"batch": 2, "seq": 16},
    "train-32x1500": {"batch": 2, "seq": 12, "enc_frames": 24},
    "serve-azconv64": {"slots": 4, "cache_len": 64, "clients": 4,
                     "prompt": {"median": 12, "sigma": 0.5, "min": 4,
                                "max": 40},
                     "output": {"median": 6, "sigma": 0.5, "min": 2,
                                "max": 20},
                     "pool": 64, "warmup_steps": 2, "sample_requests": 8,
                     "traced_steps": 2},
}


def smoke_bench(tmp: Path, workload: str) -> Path:
    """A copy of the benchmark in ``tmp`` whose cell ``workload`` runs
    the program's smoke config in float32 on the CPU, with its traffic
    cut to smoke sizes and the real cell's limits; returns its
    ``BENCHMARK.json``."""
    dst = tmp / "perfbench"
    shutil.copytree(ROOT / "perfbench", dst,
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    w = next(x for x in BENCH["workloads"] if x["name"] == workload)
    conf_path = dst / "configs" / f"{w['config']}.json"
    conf = json.loads(conf_path.read_text())
    conf.update(preset="smoke", model=SMOKE_MODELS[w["config"]])
    conf["program"]["compute_dtype"] = "float32"
    conf_path.write_text(json.dumps(conf))
    tr_path = dst / "traffic" / f"{w['traffic']}.json"
    tr = json.loads(tr_path.read_text())
    tr.update(SMOKE_TRAFFIC[w["traffic"]])
    tr_path.write_text(json.dumps(tr))
    (tmp / "BENCHMARK.json").write_text(json.dumps(BENCH))
    return tmp / "BENCHMARK.json"


class _SteadyClock:
    """A clock that moves 10 ms a reading, put in the serve runner's place:
    a smoke window then holds the same steps however loaded the CPU is."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self) -> float:
        self.t += 0.01
        return self.t


@pytest.fixture
def steady_clock(monkeypatch):
    from perfbench.harness import serve
    monkeypatch.setattr(serve, "time", _SteadyClock())


def smoke_cell(tmp: Path, workload: str):
    bench = smoke_bench(tmp, workload)
    return spec_mod.load_cell(workload, bench, bench.parent / "perfbench")


# ------------------------------------------------------------ the files
def test_benchmark_names_and_files():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    unit = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for e in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for w in BENCH["workloads"]:
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_cells_found_by_name(workload):
    cell = spec_mod.load_cell(workload)
    e2e = {m.name for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer and cell.limits
    assert cell.traffic["kind"] in ("train", "serve")
    kinds = {"train": "train_tok_s", "serve": "serve_tok_s"}
    assert kinds[cell.traffic["kind"]] in e2e


def test_cell_added_as_files_only(tmp_path):
    """A configuration, a traffic mix, a metric and a cell written only as
    new files are found and run."""
    bench_json = smoke_bench(tmp_path, "internlm2-1.8b.train-8x1024")
    pb = tmp_path / "perfbench"
    conf = json.loads((pb / "configs" / "internlm2-1.8b.json").read_text())
    (pb / "configs" / "tiny-lm.json").write_text(json.dumps(conf))
    (pb / "traffic" / "train-tiny.json").write_text(json.dumps(dict(
        json.loads((pb / "traffic" / "train-8x1024.json").read_text()),
        batch=1, seq=8)))
    (pb / "metrics" / "steps.count.train.py").write_text(
        "def read(run):\n    return float(len(run['steps']))\n")
    (pb / "limits" / "tiny-lm.train-tiny.json").write_text(
        (pb / "limits" / "internlm2-1.8b.train-8x1024.json").read_text())
    bench = json.loads(bench_json.read_text())
    bench["configs"].append({"name": "tiny-lm", "source": "test",
                             "file": "perfbench/configs/tiny-lm.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-lm.train-tiny",
                               "config": "tiny-lm", "traffic": "train-tiny",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "steps.count.train", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "train_tok_s",
        "workloads": ["tiny-lm.train-tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tok_s":
            m["workloads"].append("tiny-lm.train-tiny")
    bench_json.write_text(json.dumps(bench))
    cell = spec_mod.load_cell("tiny-lm.train-tiny", bench_json, pb)
    assert "steps.count.train" in {m.name for m in cell.per_layer}
    out = run_cell(cell, 5, 0.2, False, CPU, 0.0)
    assert out["correct"], out["checks"]
    assert out["metrics"]["train_tok_s"]["value"] > 0


# ------------------------------------------------------- the arithmetic
def test_products_by_hand():
    m = json.loads((ROOT / "perfbench/configs/internlm2-1.8b.json")
                   .read_text())["model"]
    p = products(m)
    per_layer = (2048 * 2048 * 2 + 2048 * 1024 * 2 + 3 * 2048 * 8192)
    assert p["dec"] == 24 * per_layer == 1509949440
    assert p["head"] == 92544 * 2048 and p["enc"] == 0
    fl = train_flops(m, 4, 1024, 0)
    lin = 6 * 4 * 1024 * (1509949440 + 189530112)
    att = 3 * 4 * 16 * 128 * 4 * 24 * (1024 * 1025 // 2)
    assert fl == pytest.approx(lin + att, rel=1e-12)
    w = json.loads((ROOT / "perfbench/configs/whisper-medium.json")
                   .read_text())["model"]
    pw = products(w)
    a = 1024 * 1024 * 4
    assert pw["enc"] == 24 * (a + 2 * 1024 * 4096) + 24 * 2 * 1024 * 1024
    assert pw["dec"] == 24 * (a + 2 * 1024 * 4096) + 24 * 2 * 1024 * 1024
    assert causal_pairs(4) == 10


def _reader(name):
    return spec_mod._reader(ROOT / "perfbench", name)


def test_kernel_rooflines_by_hand():
    m = json.loads((ROOT / "perfbench/configs/internlm2-1.8b.json")
                   .read_text())["model"]
    run = {"kind": "train", "model": m,
           "work": {"rows": 4, "seq": 1024, "enc": 0},
           "trace": {"steps": [{}, {}], "kernels": [
               ("void ppa_fused_kernel<bf16>", 0.0, 1000.0),
               ("void softmax_warp_kernel<4, 8>", 0.0, 500.0),
               ("void softmax_bwd_row_kernel<4, 2>", 0.0, 500.0),
               ("ampere_sgemm", 0.0, 9000.0)]}}
    fused = 2 * 2 * 8192 * 4 * 1024 * 24 * 2
    assert _reader("ppa_fused_roofline.train")(run) == pytest.approx(
        100 * fused / 3.35e12 / 1e-3)
    soft = 4 * 24 * (1024 * 1025 // 2) * (20 * 16 + 2) * 2
    assert _reader("softmax_ppa_roofline.train")(run) == pytest.approx(
        100 * soft / 3.35e12 / 1e-3)
    run["trace"]["kernels"] = [("ampere_sgemm", 0.0, 9000.0)]
    assert _reader("ppa_fused_roofline.train")(run) is None
    serve = {"kind": "serve", "model": m, "trace": {"kernels": [
        ("void ppa_fused_kernel<bf16>", 0.0, 10.0),
        ("void softmax_warp_kernel<4, 8>", 0.0, 10.0)],
        "steps": [{"prefill": [3], "decode": [5, 7]}]}}
    assert _reader("ppa_fused_roofline.serve")(serve) == pytest.approx(
        100 * 4 * 8192 * 24 * 5 / 3.35e12 / 1e-5)
    assert _reader("softmax_ppa_roofline.serve")(serve) == pytest.approx(
        100 * 24 * (6 + 12) * (8 * 16 + 1) / 3.35e12 / 1e-5)


def test_union_gaps_and_summary():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert union_s(iv) == 4.0
    assert gaps(iv, -1.0, 8.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0)]
    ks = [("k1", 0.0, 2.0), ("k2", 1.0, 3.0), ("k1", 5.0, 6.0)]
    assert device_ops(ks)[0] == ["k1", pytest.approx(3e-6)]
    g = idle_gaps(ks, [("outer", 0.0, 10.0), ("aten::inner", 3.5, 4.5)],
                  0.0, 10.0)
    assert g[0] == ["host: outer", pytest.approx(4e-6)]
    assert g[1] == ["host: aten::inner", pytest.approx(2e-6)]


def test_tails_on_synthetic_requests():
    assert percentile(list(range(101)), 95.0) == 95.0
    assert percentile([1.0, 2.0], 50.0) == 1.5
    run = {"kind": "serve", "window": {"t_open": 0.0, "t_close": 10.0},
           "requests": [
               {"t_submit": 1.0, "stamps": [1.5, 1.5, 2.0, 11.0]},
               {"t_submit": 2.0, "stamps": [2.1, 2.4]}],
           "steps": [{"t0": 0, "t1": 0.5, "admitted": 0, "prefill": [],
                      "decode": [1, 2]},
                     {"t0": 0.5, "t1": 0.6, "admitted": 1, "prefill": [9],
                      "decode": [4]}]}
    assert _reader("engine.ttft_p95_ms.serve")(run) == pytest.approx(
        percentile([500.0, 100.0], 95.0))
    assert _reader("engine.itl_p95_ms.serve")(run) == pytest.approx(
        percentile([0.0, 500.0, 300.0], 95.0))
    assert _reader("serve_tok_s")(run) == pytest.approx(4 / 10.0)
    assert _reader("engine.decode_step_ms.serve")(run) == pytest.approx(500)
    assert _reader("engine.admit_step_ms.serve")(run) == pytest.approx(100)


def test_every_seed_sends_the_same_sizes_block_by_block():
    from perfbench.harness.traffic import length_pool, requests
    tr = dict(json.loads((ROOT / "perfbench/traffic/serve-azconv64.json")
                         .read_text()), pool=200)
    prompts, outputs = length_pool(tr)
    block = tr["clients"]
    runs = []
    for seed in (1, 2 ** 33 + 5):
        src = requests({"vocab": 97}, tr, seed)
        runs.append([(len(p), n) for p, n in (next(src) for _ in range(200))])
    assert runs[0] != runs[1]
    for a in range(0, 200, block):
        want = sorted(zip(prompts[a:a + block].tolist(),
                          outputs[a:a + block].tolist()))
        assert sorted(runs[0][a:a + block]) == want
        assert sorted(runs[1][a:a + block]) == want


def test_judge():
    ok, lines = judge({"a": 0.1, "b": float("nan")}, {"a": 0.2})
    assert ok and lines == {"a": {"value": 0.1, "limit": 0.2}}
    assert not judge({"a": 0.3}, {"a": 0.2})[0]
    assert not judge({"b": float("nan")}, {"b": 0.2})[0]
    assert not judge({}, {"b": 0.2})[0]
    prog = {"loss": [2.0], "grad_norm": {"x": 1.0, "y": 0.0},
            "change_norm": {"x": 1.0, "y": 5.0}}
    ref = {"loss": [2.0], "grad_norm": {"x": 1.0, "y": 1e-9},
           "change_norm": {"x": 0.5, "y": 1.0}}
    n = train_numbers(prog, ref)
    assert n["loss_gap"] == 0.0
    # y's gradient is all but zero: its gap is taken against the median
    assert n["grad_gap"] == pytest.approx(1e-9 / 0.5)
    # and y is left out of the change, x's gap against its own norm
    assert n["change_gap"] == pytest.approx(1.0)


# -------------------------------------------------------- whole smoke runs
@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_smoke_run_is_correct(tmp_path, workload, steady_clock):
    cell = smoke_cell(tmp_path, workload)
    # the traced sub-windows once: on the CPU they trace host operations
    trace = cell.traffic["kind"] == "serve"
    out = run_cell(cell, 2 ** 31 + 7, 0.3, trace, CPU, 0.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-2:] == ["checks", "_numbers"]


def test_import_check_in_a_subprocess(tmp_path):
    bench = smoke_bench(tmp_path, "internlm2-1.8b.serve-azconv64")
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import torch\n"
        "from pathlib import Path\n"
        "from perfbench.harness.main import forbidden_modules, run_cell\n"
        "from perfbench.harness.spec import load_cell\n"
        f"b = Path({str(bench)!r})\n"
        "for w in ('internlm2-1.8b.serve-azconv64',):\n"
        "    cell = load_cell(w, b, b.parent / 'perfbench')\n"
        "    run_cell(cell, 3, 0.2, False, torch.device('cpu'), 0.0)\n"
        "print(json.dumps(forbidden_modules()))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []
    # and the check itself sees a forbidden top-level name
    sys.modules["repro"] = sys.modules.get("repro") or type(sys)("repro")
    try:
        assert "repro" in forbidden_modules()
    finally:
        if sys.modules["repro"].__dict__.get("__file__") is None:
            del sys.modules["repro"]


# ------------------------------------------------- faults and the control
def _unchanged_step(real):
    """A train step that returns its state unchanged."""
    def make(cfg, tcfg, acts=None, device=None):
        from repro_torch.models import make_acts
        from repro_torch.train.train_step import loss_and_grads
        acts = acts or make_acts(cfg.act_impl, cfg.act_backend, device)

        def step(params, tstate, batch):
            loss, _ = loss_and_grads(cfg, acts, params, batch)
            return params, tstate, {"loss": loss.detach().cpu()}
        return step
    return make


def _half_batch_step(real):
    """A train step that leaves out half of the batch."""
    def make(cfg, tcfg, acts=None, device=None):
        inner = real(cfg, tcfg, acts, device)

        def step(params, tstate, batch):
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return inner(params, tstate, half)
        return step
    return make


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("workload", ["internlm2-1.8b.train-8x1024",
                                      "whisper-medium.train-32x1500"])
def test_train_faults_are_not_correct(tmp_path, monkeypatch, workload,
                                      fault):
    import repro_torch.train as rt
    wrap = {"unchanged": _unchanged_step,
            "half_batch": _half_batch_step}[fault]
    monkeypatch.setattr(rt, "make_train_step", wrap(rt.make_train_step))
    cell = smoke_cell(tmp_path, workload)
    out = run_cell(cell, 11, 0.2, False, CPU, 0.0)
    assert not out["correct"], out["checks"]


def test_serve_altered_token_is_not_correct(tmp_path, monkeypatch,
                                            steady_clock):
    from repro_torch.serve import engine as eng
    real = eng.ServeEngine._sample_rows

    def altered(self, logits, temps, seeds):
        return (real(self, logits, temps, seeds) + 1) % logits.shape[-1]
    monkeypatch.setattr(eng.ServeEngine, "_sample_rows", altered)
    cell = smoke_cell(tmp_path, "internlm2-1.8b.serve-azconv64")
    out = run_cell(cell, 11, 0.3, False, CPU, 0.0)
    assert not out["correct"], out["checks"]
    gap = out["checks"]["served_gap"]
    assert gap["value"] is not None and gap["value"] > gap["limit"]


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_control_reads_far_above_the_program(tmp_path, workload,
                                             steady_clock):
    """At smoke size the float8 control reads each number at least 30
    times the program's (float32 here), so a limit ten times the
    program's reading fails it: on the card at the cell's size the limits
    sit between the program's dozen seeds and the control's
    (``calibrate.py``)."""
    from perfbench.calibrate import readings
    cell = smoke_cell(tmp_path, workload)
    prog, ctl = {}, {}
    for seed in (2, 3):
        r = readings(cell, seed, 0.3, True, CPU)
        for side, acc in (("program", prog), ("control", ctl)):
            for k, v in r[side].items():
                acc[k] = max(acc.get(k, 0.0), v)
    limits = {k: 10 * v for k, v in prog.items()}
    assert max(ctl[k] / max(prog[k], 1e-12) for k in prog) >= 30
    assert not judge(ctl, limits)[0]


# --------------------------------------------------------------- the card
@pytest.mark.gpu
@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_on_card(workload):
    """The command as the benchmark's check runs it, for a short window:
    one result line, correct, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 11), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_no_card_no_result():
    """Without a card the command prints no result and fails."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cmd = [sys.executable, "perfbench/run.py", "--workload",
           BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
