"""Weights from a seed for a model configuration: every parameter drawn
at once from one ``torch.Generator`` on the device, in one ``randn`` call
in the served dtype, then cut into each parameter in the order of
:func:`layout`. Matrices are normal with the configuration's
``initializer_range`` as their standard deviation; norm weights are ones.
The program and the plain reference each draw them from the seed, so
neither takes the other's."""

from __future__ import annotations

_DTYPES = {"bfloat16": "bfloat16", "float32": "float32", "float16": "float16"}


def layout(model: dict):
    """``[(name, shape, init)]`` of a GQA MoE language model in the port's
    parameter names (its ``state_dict``), init 'normal' or 'ones'."""
    d, h, kh, hd = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    v, moe = model["vocab_size"], model["moe"]
    e, de = moe["n_experts"], moe["d_expert"]
    w_in = 2 * de if model["mlp_gated"] else de
    out = [("embed", (v, d), "normal")]
    for i in range(model["n_layers"]):
        p = f"blocks.{i}."
        out += [(p + "ln1.w", (d,), "ones"),
                (p + "attn.wq", (d, h, hd), "normal"),
                (p + "attn.wk", (d, kh, hd), "normal"),
                (p + "attn.wv", (d, kh, hd), "normal"),
                (p + "attn.wo", (h, hd, d), "normal"),
                (p + "ln2.w", (d,), "ones"),
                (p + "moe.router", (d, e), "normal"),
                (p + "moe.w_in", (e, d, w_in), "normal"),
                (p + "moe.w_out", (e, de, d), "normal")]
    out += [("final_norm.w", (d,), "ones")]
    if not model.get("tie_embeddings", False):
        out += [("head", (d, v), "normal")]
    return out


def draw(config: dict, seed: int, device) -> dict:
    """``{name: tensor}`` of the configuration's weights for ``seed``."""
    import math

    import torch
    model = config["model"]
    dtype = getattr(torch, _DTYPES[model["param_dtype"]])
    std = config["init"]["std"]
    items = layout(model)
    total = sum(math.prod(s) for _, s, init in items if init == "normal")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    flat.mul_(std)
    out, at = {}, 0
    for name, shape, init in items:
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape)
        at += n
    return out
