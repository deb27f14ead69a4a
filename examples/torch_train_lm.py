"""End-to-end LM training on the PyTorch port with FQA-PPA activations in
the loop.

Defaults to a ~20M-param qwen3-family model; --full trains a ~100M-param
variant for a few hundred steps.  It runs on ``--device`` (default: the
card); ``--device cpu`` runs the kernels' plain versions.  Checkpoints go
to ``--ckpt-dir`` and the metrics to ``--metrics-path``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 120
  PYTHONPATH=src python examples/torch_train_lm.py --full --steps 300
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 4 \\
      --ckpt-dir $(mktemp -d)
"""

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.train import run_training
from repro_torch.models import ModelCfg, StageCfg


def model(full: bool) -> ModelCfg:
    if full:   # ~100M params
        return ModelCfg(
            arch="qwen3-100m", family="dense", d_model=512, n_q=8, n_kv=4,
            head_dim=64, d_ff=1536, vocab=32768,
            stages=(StageCfg("dec", 8),), qk_norm=True,
            act_impl="ppa", ce_chunks=4, tie_embeddings=True)
    return ModelCfg(
        arch="qwen3-20m", family="dense", d_model=256, n_q=4, n_kv=2,
        head_dim=64, d_ff=768, vocab=8192,
        stages=(StageCfg("dec", 4),), qk_norm=True,
        act_impl="ppa", ce_chunks=4, tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/example_ckpt_torch")
    ap.add_argument("--metrics-path", default=None,
                    help="JSON-lines metrics (default: metrics.jsonl in "
                         "--ckpt-dir)")
    ap.add_argument("--act-impl", default="ppa",
                    choices=["exact", "ppa", "ppa8"])
    ap.add_argument("--device", default=None,
                    help="where the model trains (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model(args.full).replace(act_impl=args.act_impl)
    out = run_training(
        cfg, steps=args.steps, ckpt_dir=args.ckpt_dir, resume="auto",
        ckpt_every=max(20, args.steps // 4),
        batch_override=8, seq_override=256, lr=1e-3,
        metrics_path=args.metrics_path or f"{args.ckpt_dir}/metrics.jsonl",
        device=dev)
    first, last = out["losses"][0], out["final_loss"]
    print(f"\nloss {first:.3f} -> {last:.3f} over {args.steps} steps "
          f"with act_impl={cfg.act_impl} on {dev} "
          f"({'DESCENDING ✓' if last < first else 'NOT DESCENDING ✗'})")
    return out


if __name__ == "__main__":
    main()
