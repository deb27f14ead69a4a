"""Accuracy-degradation study on the PyTorch port: exact vs ppa16 vs ppa8
activations through a full model — the deployment question the paper's
FWL flow answers (which output precision / scheme does the accelerator
need?).

It runs on ``--device`` (default: the card, the PPA activations through
the fused CUDA kernel); ``--device cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python examples/torch_accuracy_study.py
  PYTHONPATH=src python examples/torch_accuracy_study.py --device cpu
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import (forward_hidden, init_params, loss_fn,
                                make_acts, param_specs, prepare_params)
from repro_torch.models.layers import lm_head_logits


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen3-14b")
    params = init_params(param_specs(cfg), 0, device=dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev),
             "labels": torch.from_numpy(rng.integers(
                 0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)}

    results = {}
    with torch.no_grad():
        for impl in ("exact", "ppa", "ppa8"):
            c = cfg.replace(act_impl=impl)
            acts = make_acts(impl, device=dev)
            loss, _ = loss_fn(params, c, batch, acts)
            h = forward_hidden(prepare_params(params, c), c, batch, acts)
            logits = lm_head_logits(h.to(torch.float32),
                                    params["lm_head"].to(torch.float32))
            results[impl] = (float(loss), torch.log_softmax(logits, -1))

    print(f"{'impl':8s} {'loss':>9s} {'Δloss':>9s} {'KL vs exact':>12s} "
          f"{'argmax agree':>13s}")
    ref_loss, ref_lp = results["exact"]
    out = {}
    for impl, (loss, lp) in results.items():
        kl = float(torch.mean(torch.sum(torch.exp(ref_lp) * (ref_lp - lp),
                                        -1)))
        agree = float(torch.mean(
            (lp.argmax(-1) == ref_lp.argmax(-1)).to(torch.float32)))
        out[impl] = {"loss": loss, "kl": kl, "agree": agree}
        print(f"{impl:8s} {loss:9.4f} {loss - ref_loss:+9.4f} "
              f"{kl:12.3e} {agree:12.1%}")

    print("\nReading: the 16-bit FQA-O2 tables (ppa) are loss-neutral at"
          "\ninit; the aggressive 8-bit FQA-S4-O1 point (ppa8) shows the"
          "\nprecision/area trade the paper's Tables VI vs VII quantify.")
    return out


if __name__ == "__main__":
    main()
