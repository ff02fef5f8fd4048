"""The benchmark's weights, and the port's model and engine built on them.

The weights are the benchmark's own: drawn from ``--seed`` on the device
by one generator, a tensor per kind of weight with every layer stacked
on the first axis (a few large calls, in the dtype they are served in),
and handed both to the port and to the reference.  The port's ``Model``
is built on the ``meta`` device and takes each layer's view by
assignment, so the card holds one copy.

Norm weights are drawn as the port parameterises them, a ``scale``
applied as ``(1 + scale)``; the reference applies the same.
"""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the port's config fields, from the published config.json's keys
PORT_FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
               "num_attention_heads": "n_heads",
               "num_key_value_heads": "n_kv_heads",
               "intermediate_size": "d_ff", "vocab_size": "vocab_size",
               "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
               "tie_word_embeddings": "tie_embeddings"}
# stds of the weights that are not products' matrices (those are drawn
# with std 1/sqrt(fan_in); the head with 1/sqrt(d), so logits are O(1))
EMBED_STD, BIAS_STD, NORM_STD = 1.0, 0.1, 0.1


def shapes(cfg: dict) -> dict[str, tuple]:
    """Every weight's shape, layers stacked first; matrices are
    ``(in, out)`` (``x @ w``), the head ``(vocab, d)``."""
    L, d, f, v = (cfg["num_hidden_layers"], cfg["hidden_size"],
                  cfg["intermediate_size"], cfg["vocab_size"])
    hd = d // cfg["num_attention_heads"]
    qd, kvd = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    out = {"embed": (v, d), "final_norm": (d,),
           "wq": (L, d, qd), "wk": (L, d, kvd), "wv": (L, d, kvd),
           "wo": (L, qd, d), "ln1": (L, d), "ln2": (L, d),
           "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)}
    if cfg["architecture"]["qkv_bias"]:
        out.update(bq=(L, qd), bk=(L, kvd), bv=(L, kvd))
    if not cfg["tie_word_embeddings"]:
        out["head"] = (v, d)
    return out


def _std(name: str, shape: tuple) -> float:
    if name == "embed":
        return EMBED_STD
    if name in ("bq", "bk", "bv"):
        return BIAS_STD
    if name in ("ln1", "ln2", "final_norm"):
        return NORM_STD
    return shape[-1] ** -0.5 if name == "head" else shape[-2] ** -0.5


def draw_weights(cfg: dict, seed: int, device, into: dict = None) -> dict:
    """The weights of ``seed``, drawn on ``device`` in the config's dtype
    (into the tensors of ``into`` when given, so that a process can
    redraw them for another seed without a second copy)."""
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    out = {}
    for name, shape in shapes(cfg).items():
        t = (into[name] if into is not None else
             torch.empty(shape, dtype=dtype, device=device))
        torch.randn(shape, generator=gen, dtype=dtype, device=device, out=t)
        out[name] = t.mul_(_std(name, shape))
    return out


def port_config(cfg: dict):
    from repro_torch.configs.base import ModelConfig

    if cfg["hidden_act"] != "silu" or cfg["architecture"]["family"] != "dense":
        raise ValueError(f"{cfg['name']}: the port serves a dense SwiGLU "
                         f"decoder here, not {cfg['architecture']}")
    kw = {field: cfg[key] for key, field in PORT_FIELDS.items()}
    return ModelConfig(name=cfg["name"], family="dense",
                       qkv_bias=cfg["architecture"]["qkv_bias"],
                       source=cfg["source"], **kw)


def build_model(cfg: dict, weights: dict, device):
    """The port's ``Model`` over ``weights`` (no copy): built on ``meta``
    and given each layer's view.  The model keeps the device it was
    built for, which the engine reads for its caches: it is set to the
    weights' device."""
    from repro_torch.models.build import Model

    model = Model(port_config(cfg), dtype=DTYPES[cfg["dtype"]],
                  device="meta", use_kernels=True)
    state = {"embed": weights["embed"], "final_norm": weights["final_norm"]}
    if "head" in weights:
        state["head"] = weights["head"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
            if name in weights:
                state[p + "attn." + name] = weights[name][i]
        for name in ("w_gate", "w_up", "w_down"):
            state[p + "ffn." + name] = weights[name][i]
        state[p + "ln1"] = weights["ln1"][i]
        state[p + "ln2"] = weights["ln2"][i]
    model.load_state_dict(state, strict=True, assign=True)
    model.device = torch.device(device)
    return model


def build_engine(model, cfg: dict):
    from repro_torch.serving.engine import EngineConfig, InferenceEngine

    return InferenceEngine(model, EngineConfig(**cfg["engine"]))
