"""The moe family (granite-moe-3b-a800m, deepseek-moe-16b): how the
benchmark lays out its weights, and how a configuration file and those
weights become the port's ``LMConfig`` and param tree.

The weights come in parts, each drawn in one call: the embedding, the head
(final norm and output table), each dense and each MoE layer.  Layouts are
``x @ w``: (fan_in, fan_out)."""
from __future__ import annotations

import dataclasses

import torch


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def parts(m: dict) -> list[str]:
    n_dense = m["first_k_dense_replace"]
    return (["embed", "head"] + [f"dense.{i}" for i in range(n_dense)]
            + [f"moe.{i}" for i in range(m["num_hidden_layers"] - n_dense)])


def part_leaves(m: dict, part: str) -> list[tuple[str, tuple[int, ...], float | None]]:
    """(name, shape, std) of each leaf of ``part``; std None is a norm's
    scale, all ones."""
    d, hd = m["hidden_size"], m["head_dim"]
    hq, hk = m["num_attention_heads"] * hd, m["num_key_value_heads"] * hd
    vp = padded_vocab(m)
    if part == "embed":
        return [("embed", (vp, d), d ** -0.5 if m["tie_word_embeddings"] else 1.0)]
    if part == "head":
        leaves = [("final_norm", (d,), None)]
        if not m["tie_word_embeddings"]:
            leaves.append(("lm_head", (vp, d), d ** -0.5))
        return leaves
    kind = part.split(".")[0]
    leaves = [("ln1", (d,), None), ("wq", (d, hq), d ** -0.5), ("wk", (d, hk), d ** -0.5),
              ("wv", (d, hk), d ** -0.5), ("wo", (hq, d), hq ** -0.5), ("ln2", (d,), None)]
    if kind == "dense":
        f = m["dense_intermediate_size"]
        return leaves + [("ffn.gate", (d, f), d ** -0.5), ("ffn.up", (d, f), d ** -0.5),
                         ("ffn.down", (f, d), f ** -0.5)]
    e, f = m["experts_padded_to"], m["intermediate_size"]
    leaves += [("router", (d, e), d ** -0.5), ("gate", (e, d, f), d ** -0.5),
               ("up", (e, d, f), d ** -0.5), ("down", (e, f, d), f ** -0.5)]
    if m["n_shared_experts"]:
        s = m["shared_intermediate_size"]
        leaves += [("shared.gate", (d, s), d ** -0.5), ("shared.up", (d, s), d ** -0.5),
                   ("shared.down", (s, d), s ** -0.5)]
    return leaves


def program_params(m: dict, drawn: dict[str, dict[str, torch.Tensor]]) -> dict:
    """The drawn parts as the port's param tree (``models/lm.py``: a list
    of per-layer dicts for each layer stack), holding the same tensors."""
    def nest(flat: dict) -> dict:
        out: dict = {}
        for name, t in flat.items():
            *path, leaf = name.split(".")
            node = out
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
        return out

    def block(flat: dict, kind: str) -> dict:
        b = {"ln1": flat["ln1"], "attn": {k: flat[k] for k in ("wq", "wk", "wv", "wo")}, "ln2": flat["ln2"]}
        rest = nest({k: v for k, v in flat.items() if k not in ("ln1", "ln2", "wq", "wk", "wv", "wo")})
        b["ffn" if kind == "dense" else "moe"] = rest["ffn"] if kind == "dense" else rest
        return b

    p = {"embed": drawn["embed"]["embed"], "final_norm": drawn["head"]["final_norm"]}
    if "lm_head" in drawn["head"]:
        p["lm_head"] = drawn["head"]["lm_head"]
    p["blocks"] = [block(drawn[k], "moe") for k in parts(m) if k.startswith("moe.")]
    dense = [block(drawn[k], "dense") for k in parts(m) if k.startswith("dense.")]
    if dense:
        p["dense_blocks"] = dense
    return p


def lm_config(cfg: dict):
    """The port's ``LMConfig`` of a configuration file: the registry's
    entry for ``cfg["arch"]`` with every size the file states."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import MoEConfig

    m = cfg["model"]
    d, h = m["hidden_size"], m["num_attention_heads"]
    e = m["num_local_experts"]
    moe = MoEConfig(d_model=d, n_experts=e, top_k=m["num_experts_per_tok"], d_expert=m["intermediate_size"],
                    n_shared=m["n_shared_experts"], d_shared=m["shared_intermediate_size"],
                    capacity_factor=m["capacity_factor"], group_size=m["dispatch_group"],
                    pad_to=m["experts_padded_to"] if m["experts_padded_to"] > e else 0)
    return dataclasses.replace(
        get_config(cfg["arch"]), n_layers=m["num_hidden_layers"], d_model=d, n_heads=h,
        n_kv=m["num_key_value_heads"], head_dim=None if m["head_dim"] * h == d else m["head_dim"],
        d_ff=m["intermediate_size"], vocab=m["vocab_size"], first_k_dense=m["first_k_dense_replace"],
        dense_d_ff=m["dense_intermediate_size"], moe=moe, tie_embeddings=m["tie_word_embeddings"],
        rope_theta=m["rope_theta"], dtype=getattr(torch, m["dtype"]),
    )
