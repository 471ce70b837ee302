"""Operations and bytes of the work the benchmark drives, from shapes.

The yardstick the per-layer metrics divide by: model FLOPs of a train
step or a served forward (recomputation is not counted), and each
attention kernel's least time on one H100, the larger of its operations
over the peak rate and its bytes over the HBM rate. Every input byte is
counted once and every output byte once, whatever a kernel reads again.
"""

from __future__ import annotations

# published peaks of one H100 SXM (NVIDIA data sheet; dense rates)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs the mask keeps (top-left causal alignment)."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


# products of d-long rows per kept pair: fwd S and P.V; dq S, dP and
# dS.K; dk/dv S, dP, P^T.dO and dS^T.Q
_PRODUCTS = {"fwd": 2, "dq": 3, "dkdv": 4}


def attention_kernel(kernel: str, b: int, sq: int, sk: int, h: int, d: int,
                     causal: bool, dtype: str = "bfloat16") -> dict:
    """FLOPs, bytes and the least seconds of one launch of ``kernel``
    (fwd, dq or dkdv) on [b, s, h, d] tensors."""
    elt = 2 if dtype == "bfloat16" else 4
    q_bytes = b * sq * h * d * elt
    kv_bytes = b * sk * h * d * elt
    row_bytes = b * h * sq * 4  # lse or delta, fp32
    nbytes = {
        "fwd": 2 * q_bytes + 2 * kv_bytes + row_bytes,
        "dq": 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
        "dkdv": 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
    }[kernel]
    flops = 2 * d * _PRODUCTS[kernel] * b * h * causal_pairs(sq, sk, causal)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# -- decoder (config file keys of a Hugging Face decoder) ------------------


def decoder_layer_matmul_params(conf: dict) -> int:
    h = conf["hidden_size"]
    heads, kv = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf["head_dim"]
    inter = conf["intermediate_size"]
    return h * heads * hd + 2 * h * kv * hd + heads * hd * h + 3 * h * inter


def decoder_attention_flops(conf: dict, b: int, s: int) -> int:
    """Forward attention products of all layers over b rows of s tokens,
    causal (S and P.V, 2 FLOPs a multiply-add)."""
    per_layer = 4 * b * conf["num_attention_heads"] * conf["head_dim"] \
        * causal_pairs(s, s, True)
    return conf["num_hidden_layers"] * per_layer


def decoder_train_flops(conf: dict, b: int, s: int) -> int:
    """Model FLOPs of one train step on b rows of s positions: 6 per
    matmul parameter and token (the layers and the output head; the
    embedding is a gather), and three times the forward attention."""
    n = conf["num_hidden_layers"] * decoder_layer_matmul_params(conf) \
        + conf["hidden_size"] * conf["vocab_size"]
    return 6 * n * b * s + 3 * decoder_attention_flops(conf, b, s)


def decoder_score_flops(conf: dict, length: int) -> int:
    """Useful FLOPs of scoring one prompt of ``length`` tokens: the layers
    over its real tokens and the output head at its last position."""
    layers = conf["num_hidden_layers"] * decoder_layer_matmul_params(conf)
    return 2 * layers * length + decoder_attention_flops(conf, 1, length) \
        + 2 * conf["hidden_size"] * conf["vocab_size"]


# -- ViT (config file keys of the paper's table) ----------------------------


def vit_tokens(conf: dict) -> int:
    return (conf["image_size"] // conf["patch_size"]) ** 2 + 1


def vit_train_flops(conf: dict, images: int) -> int:
    """Model FLOPs of one train step on ``images``: 6 per matmul parameter
    and position (patch embedding over the patches, the blocks over the
    patches and the class token, the head over the class token alone),
    and three times the forward attention (non-causal)."""
    d, mlp = conf["hidden_size"], conf["mlp_size"]
    patch_dim = conf["patch_size"] ** 2 * conf["channels"]
    s = vit_tokens(conf)
    block = 4 * d * d + 2 * d * mlp
    per_image = (patch_dim * d * (s - 1) + conf["num_layers"] * block * s
                 + d * conf["num_classes"])
    attention = conf["num_layers"] * 4 * s * s * d
    return images * (6 * per_image + 3 * attention)
