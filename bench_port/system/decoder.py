"""A decoder configuration through ``models/training.py``: the train
step of ``build_train_step`` and the inference forward of
``build_forward``, on ``ModelConfig`` at the file's sizes."""

from __future__ import annotations


def port_config(conf: dict, traffic: dict):
    import torch

    from ray_tpu_torch.models.transformer import ModelConfig

    remat = traffic.get("remat", "full")
    cfg = ModelConfig(
        vocab_size=conf["vocab_size"], hidden=conf["hidden_size"],
        layers=conf["num_hidden_layers"],
        heads=conf["num_attention_heads"],
        kv_heads=conf["num_key_value_heads"],
        intermediate=conf["intermediate_size"],
        max_seq=conf["max_position_embeddings"],
        rope_theta=conf["rope_theta"], norm_eps=conf["rms_norm_eps"],
        dtype=getattr(torch, conf["torch_dtype"]),
        remat=remat != "off",
        remat_policy="full" if remat == "off" else remat,
        tie_embeddings=conf["tie_word_embeddings"])
    if cfg.head_dim != conf["head_dim"]:
        raise ValueError(f"the port derives head dim {cfg.head_dim}, the "
                         f"configuration states {conf['head_dim']}")
    return cfg


def train_step(conf: dict, traffic: dict, device):
    """(step(params, state, tokens) -> loss, init_state(params),
    first_grads(state) -> the gradient the optimizer got at its first
    update, per leaf, read back from its first moment)."""
    from ray_tpu_torch.models.training import build_train_step, make_optimizer

    hp = traffic["optimizer"]
    opt = make_optimizer(**hp)
    step, _ = build_train_step(port_config(conf, traffic), device=device,
                               optimizer=opt)

    def run(params, state, tokens):
        return step(params, state, tokens)[2]["loss"]

    def first_grads(state):
        return [mu.float() / (1 - hp["b1"]) for mu in state["mu"]]

    return run, opt.init, first_grads


def train_attention_calls(conf: dict, traffic: dict) -> list:
    """(kernel, b, sq, sk, heads, head dim, causal, launches) of one step:
    K/V expanded to every query head, K1 twice a layer under remat."""
    shape = (traffic["batch"], traffic["seq"], traffic["seq"],
             conf["num_attention_heads"], conf["head_dim"], True)
    n = conf["num_hidden_layers"]
    fwd = 2 * n if traffic.get("remat", "full") != "off" else n
    return [("fwd", *shape, fwd), ("dq", *shape, n), ("dkdv", *shape, n)]


def forward(conf: dict, device):
    """fwd(params, tokens [B, S]) -> logits [B, S, V] fp32."""
    from ray_tpu_torch.models.training import build_forward

    return build_forward(port_config(conf, {"remat": "off"}), device=device)


def score_attention_calls(conf: dict, rows: int, padded: int) -> list:
    return [("fwd", rows, padded, padded, conf["num_attention_heads"],
             conf["head_dim"], True, conf["num_hidden_layers"])]
