"""Flax variables -> reference torch state dicts, numpy only.

The port's own copy of ``semantic_to_torch`` and ``seq2seq_to_torch`` of
``eeg2video_tpu/convert/export_torch.py``: Flax trees arrive as nested dicts of
numpy arrays and leave as ``{torch key: numpy array}`` in the key space of the
reference's model classes, which the port's ``SemanticPredictor`` (through
``semantic_state_dict_from_reference``) and ``Seq2SeqTransformer`` load.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _t(x):
    return np.asarray(x)


def conv_to_torch(kernel):  # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.transpose(_t(kernel), (3, 2, 0, 1))


def dense_to_torch(kernel):  # (I, O) -> (O, I)
    return np.transpose(_t(kernel))


def _emit_dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = dense_to_torch(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _emit_bn(sd, prefix, params, stats):
    sd[f"{prefix}.weight"] = _t(params["scale"])
    sd[f"{prefix}.bias"] = _t(params["bias"])
    sd[f"{prefix}.running_mean"] = _t(stats["mean"])
    sd[f"{prefix}.running_var"] = _t(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.asarray(0, np.int64)


def semantic_to_torch(variables) -> Dict[str, np.ndarray]:
    """SemanticPredictor -> reference CLIP-MLP state dict (mlp.0/2/4/6/8,
    eeg_text.py:11-33)."""
    p = variables["params"]
    sd: Dict[str, np.ndarray] = {}
    for i, name in enumerate(["fc0", "fc1", "fc2", "fc3", "out"]):
        _emit_dense(sd, f"mlp.{2 * i}", p[name])
    return sd


def seq2seq_to_torch(variables) -> Dict[str, np.ndarray]:
    """Seq2SeqTransformer (``params`` and ``batch_stats``) -> reference
    myTransformer state dict (my_autoregressive_transformer.py:123-149); the
    unused nn.Embedding (reference L129) is emitted zero-filled for
    load_state_dict compatibility."""
    from ..models.seq2seq import sinusoidal_positions

    p = variables["params"]
    s = variables["batch_stats"]["eeg_embedding"]
    sd: Dict[str, np.ndarray] = {}

    ee = p["eeg_embedding"]
    sd["eeg_embedding.block_1.1.weight"] = conv_to_torch(ee["conv1"]["kernel"])
    _emit_bn(sd, "eeg_embedding.block_1.2", ee["bn1"], s["bn1"])
    sd["eeg_embedding.block_2.0.weight"] = conv_to_torch(ee["conv2"]["kernel"])
    _emit_bn(sd, "eeg_embedding.block_2.1", ee["bn2"], s["bn2"])
    sd["eeg_embedding.block_3.1.weight"] = conv_to_torch(ee["conv3"]["kernel"])
    sd["eeg_embedding.block_3.2.weight"] = conv_to_torch(ee["conv4"]["kernel"])
    _emit_bn(sd, "eeg_embedding.block_3.3", ee["bn3"], s["bn3"])
    _emit_dense(sd, "eeg_embedding.embedding", ee["embedding"])

    _emit_dense(sd, "img_embedding", p["img_embedding"])
    _emit_dense(sd, "txtpredictor", p["txtpredictor"])
    _emit_dense(sd, "predictor", p["predictor"])
    sd["embedding.weight"] = np.zeros((10, 512), np.float32)
    # PE buffer (reference registers it via register_buffer, L112)
    sd["positional_encoding.pe"] = sinusoidal_positions(5000, 512)[None]

    def emit_mha(prefix, m):
        qw = dense_to_torch(m["q_proj"]["kernel"])
        kw = dense_to_torch(m["k_proj"]["kernel"])
        vw = dense_to_torch(m["v_proj"]["kernel"])
        sd[f"{prefix}.in_proj_weight"] = np.concatenate([qw, kw, vw], axis=0)
        sd[f"{prefix}.in_proj_bias"] = np.concatenate(
            [_t(m["q_proj"]["bias"]), _t(m["k_proj"]["bias"]), _t(m["v_proj"]["bias"])])
        _emit_dense(sd, f"{prefix}.out_proj", m["out_proj"])

    def emit_ln(prefix, ln):
        sd[f"{prefix}.weight"] = _t(ln["scale"])
        sd[f"{prefix}.bias"] = _t(ln["bias"])

    for i in range(2):
        root = f"transformer_encoder.layers.{i}"
        layer = p[f"enc{i}"]
        emit_mha(f"{root}.self_attn", layer["self_attn"])
        _emit_dense(sd, f"{root}.linear1", layer["linear1"])
        _emit_dense(sd, f"{root}.linear2", layer["linear2"])
        emit_ln(f"{root}.norm1", layer["norm1"])
        emit_ln(f"{root}.norm2", layer["norm2"])
    for i in range(4):
        root = f"transformer_decoder.layers.{i}"
        layer = p[f"dec{i}"]
        emit_mha(f"{root}.self_attn", layer["self_attn"])
        emit_mha(f"{root}.multihead_attn", layer["cross_attn"])
        _emit_dense(sd, f"{root}.linear1", layer["linear1"])
        _emit_dense(sd, f"{root}.linear2", layer["linear2"])
        emit_ln(f"{root}.norm1", layer["norm1"])
        emit_ln(f"{root}.norm2", layer["norm2"])
        emit_ln(f"{root}.norm3", layer["norm3"])
    return sd
