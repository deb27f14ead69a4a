"""The program's side of a run: its model configuration, held to the
configuration file's widths, and the check that its parameter tree is the
benchmark's.  Everything the harness takes from ``repro_torch`` is
imported here and in the runners; the reference imports none of it."""

from __future__ import annotations

from .weights import shapes

__all__ = ["model_cfg", "check_tree"]


def model_cfg(conf: dict):
    """The program's ``ModelCfg`` for a configuration file: its registered
    config (the smoke one where the file says ``"preset": "smoke"``),
    refused unless every size and option the file states is the one the
    program holds, then given the file's run settings (``program``)."""
    from repro_torch.configs import get_config, get_smoke_config

    arch = conf["arch"]
    base = (get_smoke_config(arch) if conf.get("preset") == "smoke"
            else get_config(arch))
    m = conf["model"]
    if len(base.stages) != 1:
        raise ValueError(f"{arch}: the harness runs one stage of layers")
    st = base.stages[0]
    held = {
        "kind": st.kind, "n_layers": st.n_layers, "d_model": base.d_model,
        "n_q": base.n_q, "n_kv": base.n_kv, "head_dim": base.head_dim,
        "d_ff": base.d_ff, "vocab": base.vocab, "norm": base.norm,
        "gate": base.gate, "tie_embeddings": base.tie_embeddings,
        "rope_theta": base.rope_theta, "enc_layers": base.enc_layers,
        "enc_seq": base.enc_seq,
    }
    bad = {k: (m[k], v) for k, v in held.items() if m[k] != v}
    extra = {"window": st.window, "moe": st.moe, "qkv_bias": base.qkv_bias,
             "qk_norm": base.qk_norm, "vision_tokens": base.vision_tokens}
    bad.update({k: ("absent", v) for k, v in extra.items() if v})
    if bad:
        raise ValueError(f"{arch}: the program's config departs from the "
                         f"configuration file (file, program): {bad}")
    return base.replace(**conf["program"])


def check_tree(conf: dict, cfg) -> None:
    """Refuse a program whose parameter tree is not the benchmark's."""
    from repro_torch.models import param_specs
    from repro_torch.tree import leaves_with_path

    theirs = {p: tuple(s.shape) for p, s in leaves_with_path(param_specs(cfg))}
    ours = {p: tuple(shape) for p, (shape, _) in shapes(conf["model"]).items()}
    if theirs != ours:
        diff = sorted(set(theirs.items()) ^ set(ours.items()))
        raise ValueError(f"{conf['arch']}: parameter tree differs: {diff}")
