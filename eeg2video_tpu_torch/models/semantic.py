"""Semantic predictor: DE features -> CLIP text-embedding space.

Counterpart of ``eeg2video_tpu/models/semantic.py`` and of the int8 serving
runtime in ``eeg2video_tpu/train/semantic.py`` (:281-306) and
``eeg2video_tpu/serving/runtimes.py`` (:53-70). The reference ``CLIP`` MLP
(EEG2Video_New/Semantic/eeg_text.py:11-33): 310 -> 10000 -> 10000 -> 10000 ->
10000 -> 77*768 with ReLU, about 894M parameters.

``SemanticPredictor`` is the f32 module (``fc0..fc3``, ``out``).
``Int8SemanticPredictor`` is the weight-only-int8 runtime: each layer's
weight is quantized once (``ops.int8_dense.quantize_int8``), and a call is
five ``int8_dense`` launches with ReLU between. The tensor-parallel sharding
rules of the JAX package wait for the multi-GPU slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.int8_dense import int8_dense, quantize_dense_tree

CLIP_TOKENS = 77
CLIP_DIM = 768
HIDDEN = 10000
N_HIDDEN_LAYERS = 4
IN_DIM = 310  # 62 channels x 5 bands


def layer_names(n_hidden: int = N_HIDDEN_LAYERS):
    return [f"fc{i}" for i in range(n_hidden)] + ["out"]


class SemanticPredictor(nn.Module):
    """310-dim DE features (flattened 62x5) -> (77*768,) CLIP text embedding."""

    def __init__(self, hidden: int = HIDDEN, n_hidden: int = N_HIDDEN_LAYERS,
                 out_dim: int = CLIP_TOKENS * CLIP_DIM, in_dim: int = IN_DIM):
        super().__init__()
        self.n_hidden = n_hidden
        dims = [in_dim] + [hidden] * n_hidden
        for i in range(n_hidden):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
        self.out = nn.Linear(hidden, out_dim)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for i in range(self.n_hidden):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return self.out(x)


def semantic_state_dict_from_reference(sd):
    """The reference's eeg_text.py checkpoint (keys ``mlp.0/2/4/6/8.{weight,
    bias}``, already unwrapped from ``{'state_dict': ...}``) -> the port's
    ``fc0..fc3`` / ``out`` keys. A state dict already in the port's keys
    passes through."""
    if "fc0.weight" in sd:
        return dict(sd)
    out = {}
    for i, name in enumerate(layer_names()):
        out[f"{name}.weight"] = sd[f"mlp.{2 * i}.weight"]
        out[f"{name}.bias"] = sd[f"mlp.{2 * i}.bias"]
    return out


class Int8SemanticPredictor:
    """Weight-only-int8 serving of the semantic MLP: ``layers`` is a list of
    ``(w_q, scale, bias, n_out)``, the arguments of ``int8_dense``, in order.
    The layer is bound by the weight bytes it streams at serving batch sizes,
    and int8 weights are a quarter of the f32 bytes."""

    def __init__(self, layers):
        self.layers = list(layers)

    @classmethod
    def from_state_dict(cls, sd, device):
        """Quantize a ``SemanticPredictor`` state dict layer by layer on
        ``device`` (only one layer's f32 weight is there at a time)."""
        n_hidden = sum(1 for k in sd if k.startswith("fc") and k.endswith(".weight"))
        names = layer_names(n_hidden)
        # nn.Linear's (O, I) weight -> the (I, O) kernel the quantizer takes
        qt = quantize_dense_tree(
            {n: (torch.as_tensor(sd[f"{n}.weight"]).t(), sd[f"{n}.bias"]) for n in names},
            device=device)
        return cls([qt[n] for n in names])

    @property
    def device(self):
        return self.layers[0][0].device

    @torch.inference_mode()
    def __call__(self, x):
        x = x.reshape(x.shape[0], -1).float()
        for i, (w_q, scale, bias, n_out) in enumerate(self.layers):
            x = int8_dense(x, w_q, scale, bias, n_out)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
