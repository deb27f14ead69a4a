"""The port's examples (``examples/torch_*.py``) against the reference's
examples, in one process on the CPU.

Each port example's ``main`` runs with ``--device cpu`` beside the
reference example at its smallest arguments, and the two are held to one
another: the quickstart's table, cost and float-path error; the served
greedy tokens; the accuracy study's losses, KL and argmax agreement; the
first training losses.  Where an example draws random weights, the
reference's draw is carried across (the reference example's
``init_params`` is wrapped to keep it, the port example's returns it).
The reference's tables resolve through an in-memory store of the shipped
tables, and every file either example writes goes to ``tmp_path``:
``artifacts/`` is left as it was.
"""

import ast
import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.models import params_from_jax  # noqa: E402

from test_torch_models import LOGIT_GAP_BOUND, seeded_store  # noqa: E402
from test_torch_train import STEP_LOSS_RTOL  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
#: the train example's batch and sequence here (its own: 8 x 256)
TRAIN_BATCH, TRAIN_SEQ = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(min(prev, 2))
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def ref_store():
    """The reference's default store: the shipped tables in memory."""
    from repro.compiler import set_default_store
    prev = set_default_store(seeded_store())
    yield
    set_default_store(prev)


#: paths under artifacts/ that this process wrote, created, removed or
#: touched while a test watched (``artifacts_unchanged``)
ARTIFACTS = REPO / "artifacts"
_TOUCHED = []
_WATCHING = [False]
_WRITE_FLAGS = (os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_TRUNC
                | os.O_APPEND)
_PATH_EVENTS = {"os.utime", "os.rename", "os.remove", "os.rmdir",
                "os.mkdir", "os.truncate", "os.chmod", "os.link",
                "os.symlink"}


def _audit(event, args):
    if not _WATCHING[0]:
        return
    if event == "open":
        path, mode, flags = args
        if not ((isinstance(mode, str) and any(c in mode for c in "wax+"))
                or (isinstance(flags, int) and flags & _WRITE_FLAGS)):
            return
        paths = (path,)
    elif event in _PATH_EVENTS:
        paths = args[:2]
    else:
        return
    for p in paths:
        if isinstance(p, (str, bytes, os.PathLike)):
            full = os.path.abspath(os.fsdecode(p))
            if full.startswith(str(ARTIFACTS) + os.sep):
                _TOUCHED.append(full)


sys.addaudithook(_audit)


@pytest.fixture
def artifacts_unchanged():
    """Nothing under artifacts/ is added, removed or modified during the
    test: each file's mtime as it was.  The one change excused is an mtime
    refreshed by another process on a file whose inode and bytes are as
    they were: the stores' LRU (``os.utime`` on a disk hit) in tests of
    other files running beside this one.  This process's own writes and
    touches there are caught by an audit hook, so an example that touches
    or rewrites a file in place still fails the check."""
    def snap():
        return {str(p): (p.stat().st_ino, p.stat().st_mtime_ns,
                         p.read_bytes() if p.is_file() else None)
                for p in ARTIFACTS.rglob("*")}
    before = snap()
    _TOUCHED.clear()
    _WATCHING[0] = True
    try:
        yield
    finally:
        _WATCHING[0] = False
    after = snap()
    assert sorted(after) == sorted(before)
    assert not _TOUCHED, f"the test wrote under artifacts/: {_TOUCHED}"
    changed = [p for p in before if after[p][1] != before[p][1]]
    assert all(after[p][0] == before[p][0] and after[p][2] == before[p][2]
               for p in changed), changed


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry_weights(monkeypatch, ref_mod, port_mod, ref_init):
    """The reference example's parameters, as it draws them, kept; the
    port example's ``init_params`` hands them over instead of its own."""
    held = {}

    def keep(*args, **kwargs):
        held["params"] = jax.tree_util.tree_map(
            np.asarray, ref_init(*args, **kwargs))
        return held["params"]

    def carry(specs, seed=0, dtype=torch.float32, device=None):
        return params_from_jax(held["params"], device)

    monkeypatch.setattr(ref_mod, "init_params", keep)
    monkeypatch.setattr(port_mod, "init_params", carry)


def test_quickstart_matches_reference(capsys, artifacts_unchanged):
    import dataclasses
    import runpy
    ref = runpy.run_path(str(EXAMPLES / "quickstart.py"))
    want = capsys.readouterr().out.splitlines()
    got = _load("torch_quickstart").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    table, rtable = got["table"], ref["table"]
    assert table.num_segments == rtable.num_segments == 18
    assert table.mae_hard == rtable.mae_hard
    assert table.stats["mae0"] == rtable.stats["mae0"]
    assert dataclasses.asdict(got["cost"]) == dataclasses.asdict(ref["cost"])
    assert f"{got['err']:.3e}" == f"{float(ref['err']):.3e}"
    from repro.core import table_mae_report
    assert got["report"] == table_mae_report(rtable)
    assert got["finite"]
    # every printed line but the report's (its numbers compared above)
    assert lines[:-1] == want[:-1]


def test_serve_lm_matches_reference(monkeypatch, capsys, ref_store,
                                    artifacts_unchanged):
    import repro.models as RM
    ref, port = _load("serve_lm"), _load("torch_serve_lm")
    _carry_weights(monkeypatch, ref, port, RM.init_params)
    args = ["--requests", "2", "--max-new", "3"]
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", *args])
    ref.main()
    want = [ast.literal_eval(ln.split(": ", 1)[1]) for ln in
            capsys.readouterr().out.splitlines() if ln.startswith("req ")]
    got = port.main([*args, "--device", "cpu"])
    assert len(want) == 2 and got == want
    out = capsys.readouterr().out
    assert "act_backend=cuda_fused" in out and "device=cpu" in out


def test_accuracy_study_matches_reference(monkeypatch, ref_store,
                                          artifacts_unchanged):
    import repro.models as RM
    ref, port = _load("accuracy_study"), _load("torch_accuracy_study")
    _carry_weights(monkeypatch, ref, port, RM.init_params)
    losses, logits = [], []
    head = ref.lm_head_logits

    def keep_loss(*args, **kwargs):
        out = RM.loss_fn(*args, **kwargs)
        losses.append(float(out[0]))
        return out

    def keep_logits(*args, **kwargs):
        logits.append(head(*args, **kwargs))
        return logits[-1]

    monkeypatch.setattr(ref, "loss_fn", keep_loss)
    monkeypatch.setattr(ref, "lm_head_logits", keep_logits)
    ref.main()
    got = port.main(["--device", "cpu"])
    assert list(got) == ["exact", "ppa", "ppa8"] and len(losses) == 3
    ref_lp = jax.nn.log_softmax(logits[0])
    for impl, loss, lg in zip(got, losses, logits):
        lp = jax.nn.log_softmax(lg)
        kl = float(jnp.mean(jnp.sum(jnp.exp(ref_lp) * (ref_lp - lp), -1)))
        agree = float(jnp.mean(
            (jnp.argmax(lp, -1) == jnp.argmax(ref_lp, -1))))
        assert abs(got[impl]["loss"] - loss) <= STEP_LOSS_RTOL * abs(loss)
        assert abs(got[impl]["kl"] - kl) <= LOGIT_GAP_BOUND, impl
        assert got[impl]["agree"] == agree, impl


def test_train_lm_first_losses_match_reference(monkeypatch, tmp_path,
                                               ref_store,
                                               artifacts_unchanged):
    """Two steps of the example's model (float32 compute, as the train
    tests hold it; batch and sequence cut to TRAIN_BATCH x TRAIN_SEQ):
    the losses of the first steps, which the warmup leaves at the initial
    weights, within the train tests' tolerance."""
    import repro.launch.train as RLT
    import repro.models as RM
    from repro_torch.launch import train as LT
    from repro_torch.checkpoint import latest_step

    ref, port = _load("train_lm"), _load("torch_train_lm")
    _carry_weights(monkeypatch, RLT, LT, RM.init_params)
    outs = {}

    def cut(name, run, **fixed):
        def wrapped(cfg, **kw):
            kw.update(batch_override=TRAIN_BATCH, seq_override=TRAIN_SEQ,
                      **fixed)
            outs[name] = run(cfg.replace(compute_dtype="float32"), **kw)
            return outs[name]
        return wrapped

    monkeypatch.setattr(ref, "run_training", cut(
        "ref", RLT.run_training,
        metrics_path=str(tmp_path / "ref_metrics.jsonl")))
    monkeypatch.setattr(port, "run_training", cut("port", LT.run_training))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "2",
                                      "--ckpt-dir", str(tmp_path / "ref")])
    ref.main()
    got = port.main(["--steps", "2", "--ckpt-dir", str(tmp_path / "port"),
                     "--metrics-path", str(tmp_path / "metrics.jsonl"),
                     "--device", "cpu"])
    assert got is outs["port"]
    want = outs["ref"]["losses"]
    assert len(got["losses"]) == len(want) == 2
    for a, b in zip(got["losses"], want):
        assert abs(a - b) <= STEP_LOSS_RTOL * abs(b), (a, b)
    assert latest_step(tmp_path / "port") == 2
    assert (tmp_path / "metrics.jsonl").read_text().strip()


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_serve_lm",
                                  "torch_train_lm", "torch_accuracy_study"])
def test_example_needs_a_card_unless_told(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main([])
