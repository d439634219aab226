"""Seq2Seq EEG -> video-latent transformer with a fixed-length rollout.

Counterpart of ``eeg2video_tpu/models/seq2seq.py``; the module tree carries
the key names of the reference ``myTransformer``
(reference EEG2Video_New/Seq2Seq/my_autoregressive_transformer.py:123-192),
so a reference ``.pt`` (or ``convert.export_torch.seq2seq_to_torch`` of a JAX
tree) loads with ``strict=True``:

- ``EEGNetEmbedding``: EEGNet-style depthwise/separable CNN embedding one
  (1, 62, 100) EEG window to d_model (reference L16-86).
- 2 post-LN encoder and 4 post-LN decoder layers with 4 heads, FFN 2048, ReLU,
  eps 1e-5: what torch's ``nn.TransformerEncoder`` / ``nn.TransformerDecoder``
  compute at their defaults, written out here (packed ``in_proj_weight`` /
  ``in_proj_bias`` and ``out_proj`` per attention) so that the numbers do not
  depend on which of torch's inference fast paths a build takes.
- Train mode (``model.train()``) has the dropouts of the reference at the JAX
  package's sites and rates: EEGNet 0.5 (0.25 cross-subject) after blocks 2
  and 3, 0.1 on the attention probabilities, after each attention and inside
  and after each feed-forward. Their draws come from ``set_dropout_generator``'s
  generator. The EEGNet BatchNorms normalize with the batch's biased variance
  and update their running statistics flax's way (see ``layers.BatchNorm2d``).
- The reference's decode loop is autoregressive: it starts from a zero token
  and feeds its own outputs back for ``n_frames`` steps with a causal mask
  (L176-181); the rollout tokens are raw decoder outputs and never receive an
  embedding or a positional encoding. The teacher ``tgt`` is unused.
- Dual heads: ``txtpredictor`` Linear(512 -> 13) on the mean encoder output
  and ``predictor`` Linear(512 -> C*H*W) (L145-149). ``img_embedding`` and the
  ``embedding`` table are never used; they are kept for checkpoint parity.

Input: ``src`` (B, 7, 62, 100) EEG windows. Output: ``(txt_logits (B, 13),
latents (B, n_frames + 1, C, H, W))``; the latents a caller wants are
``latents[:, :-1]`` (reference L369, L377-387).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data import meta
from .layers import BatchNorm2d, Dropout, set_dropout_generator

LATENT_DIM = meta.LATENT_CHANNELS * meta.LATENT_HEIGHT * meta.LATENT_WIDTH  # 9216
N_WINDOWS = 7
WINDOW_LEN = 100


class EEGNetEmbedding(nn.Module):
    """reference my_autoregressive_transformer.py:16-86 (MyEEGNet_embedding).

    (B, 1, C, T) -> (B, d_model)."""

    def __init__(self, d_model: int = 512, C: int = meta.N_CHANNELS, T: int = WINDOW_LEN,
                 F1: int = 16, D: int = 4, F2: int = 16, cross_subject: bool = False):
        super().__init__()
        drop = 0.25 if cross_subject else 0.5
        # the indices inside each Sequential are the reference's key names
        self.block_1 = nn.Sequential(
            nn.ZeroPad2d((31, 32, 0, 0)),
            nn.Conv2d(1, F1, (1, 64), bias=False),
            BatchNorm2d(F1, eps=1e-5))
        self.block_2 = nn.Sequential(
            nn.Conv2d(F1, F1 * D, (C, 1), groups=F1, bias=False),
            BatchNorm2d(F1 * D, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 4)),
            Dropout(drop))
        self.block_3 = nn.Sequential(
            nn.ZeroPad2d((7, 8, 0, 0)),
            nn.Conv2d(F1 * D, F1 * D, (1, 16), groups=F1 * D, bias=False),
            nn.Conv2d(F1 * D, F2, (1, 1), bias=False),
            BatchNorm2d(F2, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 8)),
            Dropout(drop))
        self.embedding = nn.Linear(F2 * (T // 32), d_model)

    def forward(self, x):
        x = self.block_3(self.block_2(self.block_1(x)))
        return self.embedding(x.flatten(1))  # NCHW order, as the reference flattens


def sinusoidal_positions(length: int, d_model: int) -> np.ndarray:
    """Standard sin/cos table (reference PositionalEncoding L89-120)."""
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    pe = np.zeros((length, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


class _PositionalEncoding(nn.Module):
    def __init__(self, d_model: int, max_len: int = 5000):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(sinusoidal_positions(max_len, d_model))[None])


class _MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in-projection) and math:
    per-head softmax(q k^T / sqrt(hd) + mask) v, then ``out_proj``; dropout on
    the probabilities in train mode."""

    def __init__(self, d_model: int, nhead: int, dropout: float = 0.1):
        super().__init__()
        self.nhead = nhead
        self.dropout = Dropout(dropout)
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = nn.Linear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, kv, mask=None):
        b, lq, e = q.shape
        h, hd = self.nhead, e // self.nhead
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, bias):  # (B, L, E) -> (B, h, L, hd)
            return F.linear(x, w, bias).reshape(b, x.shape[1], h, hd).transpose(1, 2)

        logits = heads(q, wq, bq) @ heads(kv, wk, bk).transpose(-1, -2) / math.sqrt(hd)
        if mask is not None:
            logits = logits + mask  # additive, -inf for disallowed
        out = self.dropout(torch.softmax(logits, dim=-1)) @ heads(kv, wv, bv)
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, e))


class _EncoderLayer(nn.Module):
    """nn.TransformerEncoderLayer at its defaults: post-LN, ReLU, FFN 2048,
    dropout 0.1."""

    def __init__(self, d_model: int, nhead: int = 4, dim_ff: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = _MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)

    def forward(self, x):
        x = self.norm1(x + self.dropout1(self.self_attn(x, x)))
        f = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm2(x + self.dropout2(f))


class _DecoderLayer(nn.Module):
    """nn.TransformerDecoderLayer at its defaults (post-LN, dropout 0.1)."""

    def __init__(self, d_model: int, nhead: int = 4, dim_ff: int = 2048, dropout: float = 0.1):
        super().__init__()
        self.self_attn = _MultiheadAttention(d_model, nhead, dropout)
        self.multihead_attn = _MultiheadAttention(d_model, nhead, dropout)
        self.linear1 = nn.Linear(d_model, dim_ff)
        self.linear2 = nn.Linear(dim_ff, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)

    def forward(self, x, memory, tgt_mask=None):
        x = self.norm1(x + self.dropout1(self.self_attn(x, x, tgt_mask)))
        x = self.norm2(x + self.dropout2(self.multihead_attn(x, memory)))
        f = self.linear2(self.dropout(F.relu(self.linear1(x))))
        return self.norm3(x + self.dropout3(f))


class _Layers(nn.Module):
    """Holds ``layers.<i>`` as nn.TransformerEncoder / Decoder name them."""

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Seq2SeqTransformer(nn.Module):
    """EEG windows -> video latents (reference myTransformer, L123-192).

    ``latent_shape``: (C, H, W) of one predicted latent frame. The default is
    the SEED-DV geometry the reference hardcodes (4*36*64 = 9216, L130);
    configurable so that a tiny pipeline can be paired with a matching
    Seq2Seq."""

    def __init__(self, d_model: int = 512, n_enc_layers: int = 2, n_dec_layers: int = 4,
                 nhead: int = 4, n_frames: int = 6,
                 latent_shape=(meta.LATENT_CHANNELS, meta.LATENT_HEIGHT, meta.LATENT_WIDTH)):
        super().__init__()
        self.d_model, self.n_frames = d_model, n_frames
        self.latent_shape = tuple(latent_shape)
        self.latent_dim = int(np.prod(self.latent_shape))
        self.eeg_embedding = EEGNetEmbedding(d_model=d_model)
        self.img_embedding = nn.Linear(self.latent_dim, d_model)  # unused (teacher path)
        self.embedding = nn.Embedding(10, d_model)  # unused (reference L129)
        self.positional_encoding = _PositionalEncoding(d_model)
        self.transformer_encoder = _Layers(
            _EncoderLayer(d_model, nhead) for _ in range(n_enc_layers))
        self.transformer_decoder = _Layers(
            _DecoderLayer(d_model, nhead) for _ in range(n_dec_layers))
        self.txtpredictor = nn.Linear(d_model, 13)
        self.predictor = nn.Linear(d_model, self.latent_dim)

    def set_dropout_generator(self, generator):
        """Make every dropout of the model draw from ``generator`` (a
        torch.Generator on the model's device; None: the default one)."""
        set_dropout_generator(self, generator)

    def forward(self, src, tgt=None):
        b = src.shape[0]
        # (B, 7, 62, 100) windows -> (B*7, 1, 62, 100) -> (B, 7, d)
        flat = src.reshape(b * N_WINDOWS, 1, src.shape[-2], src.shape[-1])
        emb = self.eeg_embedding(flat).reshape(b, N_WINDOWS, self.d_model)
        memory = emb + self.positional_encoding.pe[0, :N_WINDOWS]
        for layer in self.transformer_encoder.layers:
            memory = layer(memory)

        # autoregressive rollout from a zero token (L176-181): position i of
        # the decoder output becomes token i + 1, fed back as it is. The
        # causal mask makes position i depend only on positions <= i, so the
        # whole (B, n_frames + 1, d) buffer goes through the decoder each step
        length = self.n_frames + 1
        causal = torch.full((length, length), -torch.inf, device=src.device,
                            dtype=emb.dtype).triu(1)
        buf = torch.zeros((b, length, self.d_model), device=src.device, dtype=emb.dtype)
        for i in range(self.n_frames):
            dec = buf
            for layer in self.transformer_decoder.layers:
                dec = layer(dec, memory, causal)
            buf = torch.cat([buf[:, :i + 1], dec[:, i:i + 1], buf[:, i + 2:]], dim=1)

        txt = self.txtpredictor(memory.mean(dim=1))
        lat = self.predictor(buf).reshape(b, length, *self.latent_shape)
        return txt, lat
