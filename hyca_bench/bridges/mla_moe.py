"""The mla_moe family (DeepSeek-V3 and its chip's share of an expert
layout): how the benchmark lays out its weights, and how a configuration
file and those weights become the port's ``LMConfig`` and param tree.

The weights come in parts, each drawn in one call: the embedding, the head
(final norm and output table), each dense and each MoE layer.  Layouts are
``x @ w``: (fan_in, fan_out).  A layer's attention is MLA: ``wq_a``,
``q_norm``, ``wq_b`` (the query's LoRA pair), ``wkv_a`` (the latent and
the shared RoPE key), ``kv_norm``, ``wkv_b`` (the latent to the heads' keys
and values), ``wo``.  An MoE layer holds the router over every expert, the
score-correction ``bias``, the held experts' weights and the shared
expert."""
from __future__ import annotations

import dataclasses

import torch

BIAS_STD = 0.02  # the score-correction bias (the configuration's ``assumed``)


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def parts(m: dict) -> list[str]:
    n_dense = m["first_k_dense_replace"]
    return (["embed", "head"] + [f"dense.{i}" for i in range(n_dense)]
            + [f"moe.{i}" for i in range(m["num_hidden_layers"] - n_dense)])


def part_leaves(m: dict, part: str) -> list[tuple[str, tuple[int, ...], float | None]]:
    """(name, shape, std) of each leaf of ``part``; std None is a norm's
    scale, all ones."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    ql, kl = m["q_lora_rank"], m["kv_lora_rank"]
    dn, dr, dv = m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["v_head_dim"]
    vp = padded_vocab(m)
    if part == "embed":
        return [("embed", (vp, d), d ** -0.5 if m["tie_word_embeddings"] else 1.0)]
    if part == "head":
        leaves = [("final_norm", (d,), None)]
        if not m["tie_word_embeddings"]:
            leaves.append(("lm_head", (vp, d), d ** -0.5))
        return leaves
    leaves = [("ln1", (d,), None), ("wq_a", (d, ql), d ** -0.5), ("q_norm", (ql,), None),
              ("wq_b", (ql, h * (dn + dr)), ql ** -0.5), ("wkv_a", (d, kl + dr), d ** -0.5),
              ("kv_norm", (kl,), None), ("wkv_b", (kl, h * (dn + dv)), kl ** -0.5),
              ("wo", (h * dv, d), (h * dv) ** -0.5), ("ln2", (d,), None)]
    if part.split(".")[0] == "dense":
        f = m["intermediate_size"]
        return leaves + [("ffn.gate", (d, f), d ** -0.5), ("ffn.up", (d, f), d ** -0.5),
                         ("ffn.down", (f, d), f ** -0.5)]
    e, held, f = m["n_routed_experts"], m["experts_held"], m["moe_intermediate_size"]
    leaves += [("router", (d, e), d ** -0.5), ("bias", (e,), BIAS_STD), ("gate", (held, d, f), d ** -0.5),
               ("up", (held, d, f), d ** -0.5), ("down", (held, f, d), f ** -0.5)]
    s = m["n_shared_experts"] * f
    return leaves + [("shared.gate", (d, s), d ** -0.5), ("shared.up", (d, s), d ** -0.5),
                     ("shared.down", (s, d), s ** -0.5)]


ATTN = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")


def program_params(m: dict, drawn: dict[str, dict[str, torch.Tensor]]) -> dict:
    """The drawn parts as the port's param tree (``models/lm.py``: a list
    of per-layer dicts for each layer stack), holding the same tensors."""
    def block(flat: dict, kind: str) -> dict:
        b = {"ln1": flat["ln1"], "attn": {k: flat[k] for k in ATTN}, "ln2": flat["ln2"]}
        rest: dict = {}
        for name, t in flat.items():
            if name in ATTN or name in ("ln1", "ln2"):
                continue
            *path, leaf = name.split(".")
            node = rest
            for key in path:
                node = node.setdefault(key, {})
            node[leaf] = t
        b["ffn" if kind == "dense" else "moe"] = rest["ffn"] if kind == "dense" else rest
        return b

    p = {"embed": drawn["embed"]["embed"], "final_norm": drawn["head"]["final_norm"]}
    if "lm_head" in drawn["head"]:
        p["lm_head"] = drawn["head"]["lm_head"]
    p["blocks"] = [block(drawn[k], "moe") for k in parts(m) if k.startswith("moe.")]
    p["dense_blocks"] = [block(drawn[k], "dense") for k in parts(m) if k.startswith("dense.")]
    return p


def lm_config(cfg: dict):
    """The port's ``LMConfig`` of a configuration file: the registry's
    entry for ``cfg["arch"]`` with every size the file states."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import YarnScaling
    from repro_torch.models.moe import MoEConfig

    m = cfg["model"]
    d, h = m["hidden_size"], m["num_attention_heads"]
    rs = m["rope_scaling"]
    base = get_config(cfg["arch"])
    mla = dataclasses.replace(
        base.mla, d_model=d, n_heads=h, q_lora=m["q_lora_rank"], kv_lora=m["kv_lora_rank"],
        d_nope=m["qk_nope_head_dim"], d_rope=m["qk_rope_head_dim"], d_v=m["v_head_dim"], rope_theta=m["rope_theta"],
        rope_scaling=YarnScaling(factor=rs["factor"], beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
                                 mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"],
                                 original_max_position_embeddings=rs["original_max_position_embeddings"]),
        rope_interleave=m["rope_interleave"])
    f = m["moe_intermediate_size"]
    moe = MoEConfig(d_model=d, n_experts=m["n_routed_experts"], top_k=m["num_experts_per_tok"], d_expert=f,
                    n_shared=m["n_shared_experts"], d_shared=m["n_shared_experts"] * f,
                    capacity_factor=m["capacity_factor"], group_size=m["dispatch_group"],
                    scoring=m["scoring_func"], n_group=m["n_group"], topk_group=m["topk_group"],
                    routed_scale=m["routed_scaling_factor"], norm_topk=m["norm_topk_prob"],
                    experts_held=m["experts_held"], expert_offset=m["expert_offset"])
    return dataclasses.replace(
        base, n_layers=m["num_hidden_layers"], d_model=d, n_heads=h, n_kv=m["num_key_value_heads"], d_ff=f,
        vocab=m["vocab_size"], first_k_dense=m["first_k_dense_replace"], dense_d_ff=m["intermediate_size"],
        mla=mla, moe=moe, tie_embeddings=m["tie_word_embeddings"], rope_theta=m["rope_theta"],
        dtype=getattr(torch, m["dtype"]),
    )
