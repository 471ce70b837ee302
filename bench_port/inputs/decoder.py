"""A decoder-only transformer (Hugging Face config keys): weights in the
program's layout (the layers stacked on a leading axis; norms in fp32,
the rest in the configuration's type) and next-token batches."""

from __future__ import annotations

import torch

from bench_port import work
from bench_port.weights import generator, make_tree


def dtype(conf: dict) -> torch.dtype:
    return getattr(torch, conf["torch_dtype"])


def weight_specs(conf: dict) -> list:
    h, vocab = conf["hidden_size"], conf["vocab_size"]
    n, heads, kv = (conf["num_hidden_layers"], conf["num_attention_heads"],
                    conf["num_key_value_heads"])
    hd, inter = conf["head_dim"], conf["intermediate_size"]
    dt, f32 = dtype(conf), torch.float32
    std = h ** -0.5
    specs = [
        (("embed",), (vocab, h), conf["initializer_range"], dt),
        (("final_norm",), (h,), "ones", f32),
        (("layers", "attn_norm"), (n, h), "ones", f32),
        (("layers", "mlp_norm"), (n, h), "ones", f32),
        (("layers", "wq"), (n, h, heads * hd), std, dt),
        (("layers", "wk"), (n, h, kv * hd), std, dt),
        (("layers", "wv"), (n, h, kv * hd), std, dt),
        (("layers", "wo"), (n, heads * hd, h), std, dt),
        (("layers", "w_gate"), (n, h, inter), std, dt),
        (("layers", "w_up"), (n, h, inter), std, dt),
        (("layers", "w_down"), (n, inter, h), inter ** -0.5, dt),
    ]
    if not conf["tie_word_embeddings"]:
        specs.append((("unembed",), (h, vocab), std, dt))
    return specs


def make_weights(conf: dict, seed: int, device) -> dict:
    return make_tree(weight_specs(conf), seed, device)


def make_batch(conf: dict, traffic: dict, seed: int, step: int, device):
    """Step ``step``'s tokens [batch, seq + 1] (next-token targets)."""
    return torch.randint(
        0, conf["vocab_size"], (traffic["batch"], traffic["seq"] + 1),
        generator=generator(seed, f"batch/{step}", device), device=device)


def tokens_per_step(conf: dict, traffic: dict) -> int:
    return traffic["batch"] * traffic["seq"]


def train_flops(conf: dict, traffic: dict) -> int:
    return work.decoder_train_flops(conf, traffic["batch"], traffic["seq"])


def score_flops(conf: dict, length: int) -> int:
    return work.decoder_score_flops(conf, length)
