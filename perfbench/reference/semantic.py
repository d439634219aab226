"""Plain reference of the served semantic predictor.

EEG2Video's ``CLIP`` MLP (EEG2Video_New/Semantic/eeg_text.py:11-33): 310 ->
hidden x 4 (ReLU) -> 77*768, with each layer's weight quantized once per
output row to int8 (absmax / 127, round half to even, clipped to +-127),
applied in float32 with the dequantized weights. The control quantizes to
int4 (absmax / 7) instead.
"""

from __future__ import annotations

import torch

LEVELS = {"int8": 127.0, "int4": 7.0}


def param_shapes(cfg):
    dims = [cfg["in_dim"]] + [cfg["hidden"]] * cfg["n_hidden"]
    out = {}
    for i in range(cfg["n_hidden"]):
        out[f"fc{i}.weight"] = (dims[i + 1], dims[i])
        out[f"fc{i}.bias"] = (dims[i + 1],)
    out["out.weight"] = (cfg["out_dim"], cfg["hidden"])
    out["out.bias"] = (cfg["out_dim"],)
    return out


def dequantized(w, bits: str = "int8"):
    """(O, I) float weight -> the float values its per-row quantization keeps."""
    levels = LEVELS[bits]
    scale = w.abs().amax(dim=1) / levels
    pos = scale > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale, torch.ones_like(scale)),
                      torch.zeros_like(scale))
    q = torch.clamp(torch.round(w * inv[:, None]), -levels, levels)
    return q * scale[:, None]


@torch.no_grad()
def predict(p, cfg, x, bits: str = "int8"):
    """(N, in_dim) features -> (N, out_dim) embeddings, float32."""
    names = [f"fc{i}" for i in range(cfg["n_hidden"])] + ["out"]
    for i, name in enumerate(names):
        x = x @ dequantized(p[f"{name}.weight"], bits).t() + p[f"{name}.bias"]
        if i < len(names) - 1:
            x = torch.relu(x)
    return x
