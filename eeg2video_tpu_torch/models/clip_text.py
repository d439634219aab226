"""CLIP text encoder (the Stable Diffusion v1 text encoder: the CLIP ViT-L/14
text tower), plain PyTorch.

Counterpart of ``eeg2video_tpu/models/clip_text.py`` (:22-85): token and
position embeddings, pre-LN transformer layers with the additive causal mask
(-inf above the diagonal) and logits and softmax in f32, quick-gelu MLPs, the
final LayerNorm at eps 1e-5. No padding mask: the last hidden state of padded
ids is the JAX module's.

The submodules carry the key names of ``transformers.CLIPTextModel``
(``text_model.embeddings.token_embedding``,
``text_model.encoder.layers.{i}.self_attn.q_proj``, ...), so its state dict
(the ``--torch_clip`` file) loads with ``load_state_dict(strict=True)``.
Older files also hold ``text_model.embeddings.position_ids``, a fixed
``arange`` and no weight; it is dropped on load. The attention is JAX's
einsum path, which XLA runs (no Pallas kernel), so it is matmuls and a
softmax here too.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    max_positions: int = 77

    @classmethod
    def tiny(cls):
        return cls(vocab_size=100, hidden=32, layers=2, heads=4,
                   intermediate=64, max_positions=77)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden, heads):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)

    def forward(self, x, mask):
        b, n, c = x.shape
        h, hd = self.heads, c // self.heads
        split = lambda t: t.reshape(b, n, h, hd).transpose(1, 2)  # noqa: E731
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(hd)
        probs = torch.softmax(logits + mask, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden, intermediate):
        super().__init__()
        self.fc1 = nn.Linear(hidden, intermediate)
        self.fc2 = nn.Linear(intermediate, hidden)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden, eps=1e-5)
        self.self_attn = CLIPAttention(cfg.hidden, cfg.heads)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden, eps=1e-5)
        self.mlp = CLIPMLP(cfg.hidden, cfg.intermediate)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(cfg) for _ in range(cfg.layers))


def _drop_position_ids(state_dict, prefix, *args):
    state_dict.pop(prefix + "position_ids", None)


class CLIPTextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden)
        self._register_load_state_dict_pre_hook(_drop_position_ids)

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        return self.token_embedding(input_ids) + self.position_embedding(pos)[None]


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPTextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden, eps=1e-5)

    def forward(self, input_ids):
        x = self.embeddings(input_ids)
        n = input_ids.shape[1]
        causal = torch.full((n, n), float("-inf"), device=x.device).triu(1)
        for layer in self.encoder.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)


class CLIPTextModel(nn.Module):
    """(B, L) int token ids -> (B, L, hidden) last hidden state."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = CLIPTextTransformer(config)

    def forward(self, input_ids):
        return self.text_model(input_ids.long())


def encode_ids(model, ids):
    """Token ids (numpy or tensor) -> the model's last hidden state, run on
    the model's device without gradients."""
    dev = model.text_model.final_layer_norm.weight.device
    with torch.inference_mode():
        return model(torch.as_tensor(ids, device=dev))

