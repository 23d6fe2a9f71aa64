"""Work counted from shapes for RDT-1B's plan (``perfbench/reference/rdt.py``):
each operation's floating-point operations and bytes, and from them the
plan's operations and the roofline bound, in seconds, of its two parts:

* ``vision``, what the program's ``plan.encode`` span runs: SigLIP over the
  plan's image slots and the three condition adaptors (the instruction's
  tokens, the image tokens, the state token);
* ``dit``, what ``plan.denoise`` runs: the DiT's forwards, one a solver
  step, each with the action tokens' adaptor and both timestep embedders.

Operations: 2 per multiply-add of every linear layer, convolution and
attention product (``q k^T`` and the weights times ``v``). Bytes, in the
compute dtype's element size: every weight and bias read once, every
linear layer's input read and output written once, attention's q, k, v and
output once each, every norm's input and output and its weight. Activation
functions, the position tables' additions, the preprocessing and the
solver's elementwise update are left out (under 1% of the bytes).

Each condition's keys and values (every cross-attention block's ``kv``
projection and its k norm) are counted once a plan, in ``dit``: they do not
change over the steps, so once is the least the mathematics needs, whatever
the program recomputes. A roofline share from these counts is the share of
that least time, and a program that computes them once a plan does not make
it stale.

An operation's bound is the larger of its operations over the card's dense
bfloat16 peak and its bytes over the memory bandwidth; a part's bound is
the sum of its operations' bounds.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

__all__ = ["Op", "linear", "attention", "norm", "siglip_layer", "rdt_block", "plan_ops", "plan_work"]

Op = Tuple[str, float, float]  # (name, operations, bytes)


def linear(name: str, tokens: int, fan_in: int, fan_out: int, elem: int = 2) -> Op:
    return (name, 2.0 * tokens * fan_in * fan_out,
            float(elem * (fan_in * fan_out + fan_out + tokens * fan_in + tokens * fan_out)))


def attention(name: str, batch: int, heads: int, queries: int, keys: int, head_dim: int, elem: int = 2) -> Op:
    return (name, 4.0 * batch * heads * queries * keys * head_dim,
            float(elem * batch * heads * head_dim * (2 * queries + 2 * keys)))


def norm(name: str, tokens: int, width: int, elem: int = 2) -> Op:
    return (name, 0.0, float(elem * (2 * tokens * width + width)))


def siglip_layer(r: dict, images: int) -> List[Op]:
    """One SigLIP encoder layer over ``images`` images."""
    w, mlp, heads = r["VISION_WIDTH"], r["VISION_MLP"], r["VISION_HEADS"]
    n = (r["IMAGE_SIZE"] // r["PATCH"]) ** 2
    m = images * n
    return [norm("siglip.ln1", m, w), *(linear(f"siglip.{p}_proj", m, w, w) for p in "qkv"),
            attention("siglip.attn", images, heads, n, n, w // heads), linear("siglip.out_proj", m, w, w),
            norm("siglip.ln2", m, w), linear("siglip.fc1", m, w, mlp), linear("siglip.fc2", m, mlp, w)]


def rdt_block(r: dict, tokens: int, keys: int) -> List[Op]:
    """One RDT block's work in one forward of ``tokens`` tokens whose
    cross-attention reads ``keys`` condition tokens (their k and v left
    out: :func:`plan_ops` counts them once a plan)."""
    d, heads = r["HIDDEN"], r["HEADS"]
    hd = d // heads
    return [norm("rdt.norm1", tokens, d), linear("rdt.qkv", tokens, d, 3 * d),
            norm("rdt.qk_norm", 2 * tokens * heads, hd), attention("rdt.self_attn", 1, heads, tokens, tokens, hd),
            linear("rdt.proj", tokens, d, d), norm("rdt.norm2", tokens, d), linear("rdt.cross_q", tokens, d, d),
            norm("rdt.cross_q_norm", tokens * heads, hd), attention("rdt.cross_attn", 1, heads, tokens, keys, hd),
            linear("rdt.cross_proj", tokens, d, d), norm("rdt.norm3", tokens, d), linear("rdt.fc1", tokens, d, d),
            linear("rdt.fc2", tokens, d, d)]


def _adaptor(name: str, tokens: int, fan_in: int, hidden: int, kind: str) -> List[Op]:
    depth = int(kind[len("mlp"):-len("x_gelu")])
    return [linear(f"{name}.0", tokens, fan_in, hidden)] + [
        linear(f"{name}.{2 * i}", tokens, hidden, hidden) for i in range(1, depth)]


def plan_ops(cfg: dict) -> Dict[str, List[Op]]:
    """The operations of one plan (one hypothesis), by part."""
    m = cfg["MODEL"]
    r = m["RDT"]
    d, heads, width = r["HIDDEN"], r["HEADS"], r["STATE_DIM"]
    images = m["N_OBS_STEPS"] * r["CAMERAS"]
    n_img = images * (r["IMAGE_SIZE"] // r["PATCH"]) ** 2
    lang = r["LANG_SLOTS"]
    patch = 3 * r["PATCH"] ** 2
    vision = [linear("siglip.patch_embedding", n_img, patch, r["VISION_WIDTH"])]
    for _ in range(r["VISION_DEPTH"]):
        vision += siglip_layer(r, images)
    vision.append(norm("siglip.post_layernorm", n_img, r["VISION_WIDTH"]))
    vision += _adaptor("img_adaptor", n_img, r["VISION_WIDTH"], d, r["IMG_ADAPTOR"])
    vision += _adaptor("lang_adaptor", lang, r["LANG_DIM"], d, r["LANG_ADAPTOR"])
    vision += _adaptor("state_adaptor", 1, 2 * width, d, r["STATE_ADAPTOR"])
    tokens = m["HORIZON"] + 3
    dit = []
    for i in range(r["DEPTH"]):  # each condition's keys and values, once a plan
        keys = lang if i % 2 == 0 else n_img
        dit += [linear("rdt.cross_kv", keys, d, 2 * d), norm("rdt.cross_k_norm", keys * heads, d // heads)]
    forward = _adaptor("state_adaptor", m["HORIZON"], 2 * width, d, r["STATE_ADAPTOR"])
    for name in ("t_embedder", "freq_embedder"):
        forward += [linear(f"{name}.0", 1, 256, d), linear(f"{name}.2", 1, d, d)]
    for i in range(r["DEPTH"]):
        forward += rdt_block(r, tokens, lang if i % 2 == 0 else n_img)
    forward += [norm("rdt.norm_final", tokens, d), linear("rdt.final_fc1", tokens, d, d),
                linear("rdt.final_fc2", tokens, d, width)]
    dit += forward * int(cfg["EVAL"]["SAMPLE_STEPS"])
    return {"vision": vision, "dit": dit}


def _bound(ops: List[Op], rates: Dict[str, float]) -> float:
    return sum(max(f / rates["bf16_flops"], b / rates["bytes_s"]) for _, f, b in ops)


def plan_work(cfg: dict, rates: Dict[str, float]) -> Dict[str, float]:
    """One plan's operations (``flops``, and by part ``vision_flops`` /
    ``dit_flops``), bytes, forwards, and each part's roofline bound in
    seconds (``vision_bound_s``, ``dit_bound_s``)."""
    ops = plan_ops(cfg)
    out = {"forwards": int(cfg["EVAL"]["SAMPLE_STEPS"])}
    for part, lst in ops.items():
        out[f"{part}_flops"] = sum(f for _, f, _ in lst)
        out[f"{part}_bytes"] = sum(b for _, _, b in lst)
        out[f"{part}_bound_s"] = _bound(lst, rates)
    out["flops"] = out["vision_flops"] + out["dit_flops"]
    return out
