"""Flax variables -> reference torch state dicts, numpy only.

The port's own copy of ``semantic_to_torch``, ``seq2seq_to_torch`` and
``encoder_to_torch`` of ``eeg2video_tpu/convert/export_torch.py`` (and of the
per-architecture tables of ``convert/torch_params.py`` it reads): Flax trees
arrive as nested dicts of numpy arrays and leave as ``{torch key: numpy
array}`` in the key space of the reference's model classes, which the port's
``SemanticPredictor`` (through ``semantic_state_dict_from_reference``),
``Seq2SeqTransformer`` and EEG encoders (``models.encoders``) load.
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


def _emit_conv(sd, prefix, p):
    sd[f"{prefix}.weight"] = conv_to_torch(p["kernel"])
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


# (flax name, kind, torch prefix) of each encoder's reference Sequential
# (reference models.py:105-390); kinds: conv / dense / bn
_SPECS = {
    "shallownet": [("conv1", "conv", "net.0"), ("conv2", "conv", "net.1"), ("bn", "bn", "net.2"),
                   ("out", "dense", "out")],
    "deepnet": [("conv1", "conv", "net.0"), ("conv2", "conv", "net.1"), ("bn1", "bn", "net.2"),
                ("conv3", "conv", "net.6"), ("bn2", "bn", "net.7"),
                ("conv4", "conv", "net.11"), ("bn3", "bn", "net.12"),
                ("conv5", "conv", "net.16"), ("bn4", "bn", "net.17"), ("out", "dense", "out")],
    "eegnet": [("conv1", "conv", "net.0"), ("bn1", "bn", "net.1"), ("conv2", "conv", "net.2"),
               ("bn2", "bn", "net.3"), ("conv3", "conv", "net.7"), ("bn3", "bn", "net.8"),
               ("out", "dense", "out")],
    "tsconv": [("conv1", "conv", "net.0"), ("bn1", "bn", "net.2"), ("conv2", "conv", "net.4"),
               ("bn2", "bn", "net.5"), ("out", "dense", "out")],
    "mlpnet": [("fc1", "dense", "net.1"), ("fc2", "dense", "net.3"), ("fc3", "dense", "net.5")],
}


def encoder_to_torch(name: str, variables) -> Dict[str, np.ndarray]:
    """An EEG encoder's Flax variables (``params``, and ``batch_stats`` where
    it has BatchNorms) -> its state dict in the reference's keys; ``glmnet``
    (which the reference tree lacks) in the port's: ``rawnet.`` a
    ShallowNetFlexible in ShallowNet's keys, ``featnet.`` an MLPNet, ``out``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}

    def emit_spec(spec, p, s, torch_root=""):
        for flax_name, kind, tprefix in spec:
            full = f"{torch_root}{tprefix}"
            if kind == "conv":
                _emit_conv(sd, full, p[flax_name])
            elif kind == "dense":
                _emit_dense(sd, full, p[flax_name])
            else:
                _emit_bn(sd, full, p[flax_name], s[flax_name])

    two = {"glfnet": ("shallownet", "globalnet", "occipital_localnet"),
           "glfnet_mlp": ("mlpnet", "globalnet", "occipital_localnet")}
    if name in _SPECS:
        emit_spec(_SPECS[name], params, stats)
    elif name in two:
        spec, *parts = two[name]
        for part in parts:
            emit_spec(_SPECS[spec], params[part], stats.get(part, {}), f"{part}.")
        _emit_dense(sd, "out", params["out"])
    elif name == "glmnet":
        emit_spec(_SPECS["shallownet"], params["rawnet"], stats["rawnet"], "rawnet.")
        emit_spec(_SPECS["mlpnet"], params["featnet"], {}, "featnet.")
        _emit_dense(sd, "out", params["out"])
    elif name == "conformer":
        sd.update(_conformer_to_torch(params, stats))
    else:
        raise ValueError(f"no exporter for encoder '{name}'")
    return sd


def _conformer_to_torch(p, s) -> Dict[str, np.ndarray]:
    """Reference models.py:343-350: Sequential of PatchEmbedding (0),
    TransformerEncoder (1), ClassificationHead (2). The head's ``clshead``
    branch is never used (models.py:337-340); it gets an identity LayerNorm
    and a zero Linear, so that the keys load."""
    sd: Dict[str, np.ndarray] = {}
    _emit_conv(sd, "0.shallownet.0", p["patch_conv1"])
    _emit_conv(sd, "0.shallownet.1", p["patch_conv2"])
    _emit_bn(sd, "0.shallownet.2", p["patch_bn"], s["patch_bn"])
    _emit_conv(sd, "0.projection.0", p["patch_proj"])
    _emit_dense(sd, "2.fc.0", p["fc"])
    emb_size = _t(p["patch_proj"]["kernel"]).shape[-1]
    out_dim = _t(p["fc"]["kernel"]).shape[-1]
    sd["2.clshead.1.weight"] = np.ones((emb_size,), np.float32)
    sd["2.clshead.1.bias"] = np.zeros((emb_size,), np.float32)
    sd["2.clshead.2.weight"] = np.zeros((out_dim, emb_size), np.float32)
    sd["2.clshead.2.bias"] = np.zeros((out_dim,), np.float32)
    depth = sum(1 for k in p if k.endswith("_mha"))
    for d in range(depth):
        root = f"1.{d}"
        for ln, at in ((f"block{d}_ln1", f"{root}.0.fn.0"), (f"block{d}_ln2", f"{root}.1.fn.0")):
            sd[f"{at}.weight"] = _t(p[ln]["scale"])
            sd[f"{at}.bias"] = _t(p[ln]["bias"])
        for part in ("queries", "keys", "values", "projection"):
            _emit_dense(sd, f"{root}.0.fn.1.{part}", p[f"block{d}_mha"][part])
        _emit_dense(sd, f"{root}.1.fn.1.0", p[f"block{d}_ff1"])
        _emit_dense(sd, f"{root}.1.fn.1.3", p[f"block{d}_ff2"])
    return sd
