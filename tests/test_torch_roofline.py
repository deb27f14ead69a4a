"""The port's roofline against the JAX reference's, and ``OpCosts``'s counts.

* ``Roofline`` given the reference's ``HW_V5E`` numbers gives the
  reference's ``as_dict`` on the cases of ``tests/test_roofline.py`` and
  one collective-bound case; ``model_flops`` and ``active_params`` are
  exact.  Its own hardware defaults are the H100's published peaks.
* ``OpCosts`` over 12 (8, 16) @ (16, 16) products, each all-reduced on a
  gloo group of one rank, counts the FLOPs and all-reduce bytes the
  reference's HLO parser counts on the same program
  (``tests/test_roofline.py::SYNTH``); a view counts 0 bytes; an in-place
  write into a large buffer (``index_copy_``, ``index_put_``, ``copy_``
  into a slice) counts the slice it writes; a kernel's report adds its
  work; a decode step of the smoke model counts at least its ideal
  bytes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as RC  # noqa: E402
import repro.models as RM  # noqa: E402
from repro.roofline import HW_V5E, Roofline as RefRoofline  # noqa: E402
from repro.roofline import model_flops as ref_model_flops  # noqa: E402
from repro.roofline.hlo_costs import analyze_hlo_text  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config  # noqa: E402,E501
from repro_torch.roofline import (HW_H100, OpCosts, Roofline,  # noqa: E402
                                  active_params, analyze_costs, model_flops,
                                  report_kernel)

from test_roofline import SYNTH  # noqa: E402

CASES = [
    dict(arch="a", shape="s", mesh="m", chips=256, hlo_flops=197e12,
         hlo_bytes=819e9 * 2, coll_bytes={"all-reduce": int(50e9)},
         model_flops=0.5 * 197e12 * 256),
    dict(arch="a", shape="decode", mesh="m", chips=256, hlo_flops=1e9,
         hlo_bytes=819e9, coll_bytes={}, model_flops=1e9,
         ideal_bytes=0.5 * 819e9 * 256),
    dict(arch="b", shape="train", mesh="2x4", chips=8, hlo_flops=3e12,
         hlo_bytes=1e9, coll_bytes={"all-gather": 10**9,
                                    "reduce-scatter": 3 * 10**8},
         model_flops=1e13, ideal_bytes=2e9),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_as_dict_matches_reference(case):
    kw = CASES[case]
    want = RefRoofline(**kw).as_dict()
    got = Roofline(**kw, **HW_V5E).as_dict()
    assert got == want


def test_roofline_defaults_are_the_h100():
    assert HW_H100 == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                       "link_bw": 450e9}
    r = Roofline(arch="a", shape="s", mesh="m", chips=1, hlo_flops=989e12,
                 hlo_bytes=3.35e12 * 2, coll_bytes={}, model_flops=989e12)
    assert (r.t_compute, r.t_memory, r.bottleneck) == (1.0, 2.0, "memory")
    assert r.t_useful == 1.0 and r.roofline_fraction == 0.5
    assert r.measured_share(4.0) == 0.25


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_exact(kind):
    for n, d in ((1.8e9, 2048.0), (3.2e9, 1.0), (7, 3)):
        assert model_flops(n, d, kind) == ref_model_flops(n, d, kind)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_match_reference(arch):
    """The reference's ``launch/specs.py::active_params`` over the abstract
    params its dry run passes it: routed experts count top_k / E of
    themselves."""
    from repro.launch.specs import active_params as ref_active_params
    rcfg = RC.get_config(arch)
    want = ref_active_params(rcfg, RM.abstract_params(RM.param_specs(rcfg)))
    from repro_torch.models import param_specs
    cfg = get_config(arch)
    assert active_params(cfg, param_specs(cfg)) == want


@pytest.fixture
def one_rank(tmp_path):
    import datetime
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_op_costs_count_products_and_all_reduce_as_the_hlo_parser(one_rank):
    import torch.distributed as dist
    hc = analyze_hlo_text(SYNTH)
    x = torch.randn(8, 16)
    w = torch.randn(16, 16)
    with OpCosts() as c:
        for _ in range(12):
            x = x @ w
            dist.all_reduce(x, group=one_rank)
    assert c.flops == 12 * 2 * 8 * 16 * 16 == hc.flops
    assert dict(c.coll_bytes) == {"all-reduce": 12 * 8 * 16 * 4} \
        == hc.coll_bytes
    # each product reads x and w and writes x
    assert c.bytes == 12 * (8 * 16 + 16 * 16 + 8 * 16) * 4


def test_op_costs_see_gather_and_functional_collectives(one_rank):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    x = torch.ones(4, 8)
    out = torch.empty(4, 8)
    with OpCosts() as c:
        dist.all_gather_into_tensor(out, x, group=one_rank)
        fc.wait_tensor(fc.all_reduce(x, "sum", one_rank))
    assert c.coll_bytes["all-gather"] == 4 * 8 * 4
    assert c.coll_bytes["all-reduce"] == 4 * 8 * 4


def test_a_view_counts_zero_bytes():
    x = torch.randn(64, 32)
    with OpCosts() as c:
        x.view(32, 64).t()[1:].unsqueeze(0).expand(3, -1, -1).permute(
            1, 0, 2)
        x.transpose(0, 1).reshape(32, 64)[0].detach()
    assert c.bytes == 0 and c.flops == 0


def test_in_place_writes_count_the_slice_written():
    buf = torch.zeros(4096, 64)
    src = torch.randn(2, 64)
    idx = torch.tensor([7, 900])
    with OpCosts() as c:
        buf.index_copy_(0, idx, src)
    # the rows written, read from the source, and the index
    assert c.bytes == 2 * (2 * 64 * 4) + 2 * 8
    cache = torch.zeros(4, 512, 8, 16)
    b, slot = torch.arange(4), torch.tensor([3, 9, 9, 511])
    new = torch.randn(4, 8, 16)
    with OpCosts() as c:
        cache[b, slot] = new
    assert c.bytes == 2 * (4 * 8 * 16 * 4) + 2 * 4 * 8
    with OpCosts() as c:
        buf[100:102].copy_(src)
    assert c.bytes == 2 * (2 * 64 * 4)
    with OpCosts() as c:
        buf.add_(1.0)
    assert c.bytes == 2 * buf.numel() * 4


def test_a_gather_counts_the_rows_it_reads():
    table = torch.randn(1000, 64)
    ids = torch.tensor([[1, 5, 9]])
    with OpCosts() as c:
        torch.nn.functional.embedding(ids, table)
    assert c.bytes <= 2 * 3 * 64 * 4 + 3 * 8


def test_kernel_reports_add_their_work():
    from repro_torch.roofline import bounds
    work = bounds.fused_work(4 * 8192, 2, 461, 2, False, True)
    with OpCosts() as c:
        report_kernel("ppa_fused", (4, 1, 8192), work, itemsize=2)
    report_kernel("ppa_fused", (4, 1, 8192), work)       # no counter: none
    assert c.bytes == work[0] == 2 * 2 * 4 * 8192 + 461 * 4 * 4
    assert c.kernel_ops == {"ppa_fused": {"int32": work[1],
                                          "float32": work[2]}}
    assert c.kernels == [dict(kernel="ppa_fused", shape=(4, 1, 8192),
                              bytes=work[0], int_ops=work[1],
                              fp_ops=work[2], itemsize=2)]
    assert c.flops == 0


def test_decode_step_counts_at_least_its_ideal_bytes():
    """The smoke internlm2's decode step on the CPU (plain versions, seen
    by the dispatcher): its bytes cover every active parameter and the
    cache once; its FLOPs cover 2 x the matrix parameters x tokens."""
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    make_acts, param_specs, prepare_params)
    from repro_torch.tree import leaves
    cfg = get_smoke_config("internlm2-1.8b")
    specs = param_specs(cfg)
    params = prepare_params(init_params(specs, 0, device="cpu"), cfg, "cpu")
    acts = make_acts(cfg.act_impl, device="cpu")
    cache = init_cache(cfg, 4, 32, device="cpu")
    with torch.inference_mode(), OpCosts() as c:
        decode_step(params, cfg, cache, torch.zeros((4, 1), dtype=torch.int32),
                    torch.full((4,), 5, dtype=torch.int32), acts)
    n = active_params(cfg, specs)
    ideal = n * 4 + sum(t.numel() * t.element_size() for t in leaves(cache))
    r = analyze_costs(c, arch=cfg.arch, shape="decode", mesh_desc="cpu",
                      chips=1, model_fl=model_flops(n, 4, "decode"),
                      ideal_bytes=ideal)
    assert c.bytes >= ideal and not c.coll_bytes
    matrices = sum(float(np.prod(p.shape)) for p in leaves(specs)
                   if len(p.shape) >= 3)
    assert c.flops >= 2 * matrices * 4
    assert r.bottleneck == "memory" and 0 < r.roofline_fraction <= 1
