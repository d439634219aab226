"""The EEG encoder family as ``nn.Module``s (reference
EEG2Video/models/models.py:105-413).

Counterpart of ``eeg2video_tpu/models/encoders.py``: the same architectures,
on the reference's NCHW layout, so the JAX package's ``_to_nhwc`` /
``_flatten_as_torch`` (:29-37) become plain flattening, and with the
reference's module names, so a reference state dict (or
``convert.from_jax.encoder_state_dict_from_jax`` of a JAX tree) loads with
``load_state_dict``. The BatchNorms and dropouts follow flax's train-mode
rules (``layers.BatchNorm2d``: momentum 0.9, the batch's biased variance;
``layers.Dropout``: keep with 1 - p); GELU is exact.

Raw-EEG encoders take (B, 1, C, T); DE/PSD encoders (B, C, 5) - the reference
forward() contracts. Unlike flax, torch sizes a Linear when it is built, so
the classes that flatten take the input's C and T (MLPNet its
``input_dim``); the defaults are the JAX classes'.
"""

from __future__ import annotations

import torch
from torch import nn

from ..data import meta
from .layers import BatchNorm2d, Dropout

OCCIPITAL = list(meta.OCCIPITAL_CHANNELS)  # channels 50..61


def _pooled(n: int, window: int, stride: int) -> int:
    """Length after a VALID pool (or conv, stride 1) of ``window``."""
    return (n - window) // stride + 1


class ShallowNet(nn.Module):
    """reference models.py:105-123: Conv(1->40,(1,25)) -> Conv(40->40,(C,1))
    -> BN -> ELU -> AvgPool((1,51),(1,5)) -> Dropout -> Linear."""

    def __init__(self, out_dim: int, C: int = meta.N_CHANNELS, T: int = 2 * meta.FS,
                 dropout: float = 0.5):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 40, (1, 25)),
            nn.Conv2d(40, 40, (C, 1)),
            BatchNorm2d(40, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 51), (1, 5)),
            Dropout(dropout))
        self.out = nn.Linear(40 * _pooled(T - 24, 51, 5), out_dim)

    def forward(self, x):
        return self.out(self.net(x).flatten(1))


class DeepNet(nn.Module):
    """reference models.py:125-161: 4x {Conv -> BN -> ELU -> MaxPool(1,2) -> Drop}."""

    def __init__(self, out_dim: int, C: int = meta.N_CHANNELS, T: int = 2 * meta.FS,
                 dropout: float = 0.5):
        super().__init__()
        layers = [nn.Conv2d(1, 25, (1, 10)), nn.Conv2d(25, 25, (C, 1))]
        w = (T - 9) // 2
        for cin, cout in ((25, 50), (50, 100), (100, 200)):
            layers += [BatchNorm2d(cin, eps=1e-5), nn.ELU(), nn.MaxPool2d((1, 2), (1, 2)),
                       Dropout(dropout), nn.Conv2d(cin, cout, (1, 10))]
            w = (w - 9) // 2
        layers += [BatchNorm2d(200, eps=1e-5), nn.ELU(), nn.MaxPool2d((1, 2), (1, 2)),
                   Dropout(dropout)]
        self.net = nn.Sequential(*layers)
        self.out = nn.Linear(200 * w, out_dim)

    def forward(self, x):
        return self.out(self.net(x).flatten(1))


class EEGNet(nn.Module):
    """reference models.py:163-187. The last dropout drops whole feature maps
    (the reference's Dropout2d; flax's ``broadcast_dims``)."""

    def __init__(self, out_dim: int, C: int = meta.N_CHANNELS, T: int = 2 * meta.FS,
                 dropout: float = 0.5):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 8, (1, 64)),
            BatchNorm2d(8, eps=1e-5),
            nn.Conv2d(8, 16, (C, 1)),
            BatchNorm2d(16, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 2), (1, 2)),
            Dropout(dropout),
            nn.Conv2d(16, 16, (1, 16)),
            BatchNorm2d(16, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 2), (1, 2)),
            Dropout(dropout, broadcast_dims=(2, 3)))
        self.out = nn.Linear(16 * (((T - 63) // 2 - 15) // 2), out_dim)

    def forward(self, x):
        return self.out(self.net(x).flatten(1))


class TSConv(nn.Module):
    """reference models.py:189-209: temporal conv -> pool -> BN -> ELU ->
    spatial conv -> BN -> ELU -> Dropout -> Linear."""

    def __init__(self, out_dim: int, C: int = meta.N_CHANNELS, T: int = 2 * meta.FS,
                 dropout: float = 0.5):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 40, (1, 25)),
            nn.AvgPool2d((1, 51), (1, 5)),
            BatchNorm2d(40, eps=1e-5),
            nn.ELU(),
            nn.Conv2d(40, 40, (C, 1)),
            BatchNorm2d(40, eps=1e-5),
            nn.ELU(),
            Dropout(dropout))
        self.out = nn.Linear(40 * _pooled(T - 24, 51, 5), out_dim)

    def forward(self, x):
        return self.out(self.net(x).flatten(1))


class _ConformerMHA(nn.Module):
    """The reference's hand-rolled MHA (models.py:240-266): it scales by
    sqrt(emb_size), the full embedding size, not the head dim."""

    def __init__(self, emb_size: int, num_heads: int, dropout: float):
        super().__init__()
        self.emb_size, self.num_heads = emb_size, num_heads
        self.queries = nn.Linear(emb_size, emb_size)
        self.keys = nn.Linear(emb_size, emb_size)
        self.values = nn.Linear(emb_size, emb_size)
        self.att_drop = Dropout(dropout)
        self.projection = nn.Linear(emb_size, emb_size)

    def forward(self, x):
        b, n, e = x.shape

        def heads(t):  # (B, N, E) -> (B, h, N, E / h)
            return t.reshape(b, n, self.num_heads, e // self.num_heads).transpose(1, 2)

        q, k, v = heads(self.queries(x)), heads(self.keys(x)), heads(self.values(x))
        att = torch.softmax(q @ k.transpose(-1, -2) / self.emb_size ** 0.5, dim=-1)
        out = (self.att_drop(att) @ v).transpose(1, 2).reshape(b, n, e)
        return self.projection(out)


class _Residual(nn.Module):
    """x + fn(x) (the reference's ResidualAdd: the key ``fn``)."""

    def __init__(self, *layers):
        super().__init__()
        self.fn = nn.Sequential(*layers)

    def forward(self, x):
        return x + self.fn(x)


class _PatchEmbedding(nn.Module):
    def __init__(self, emb_size: int, dropout: float):
        super().__init__()
        self.shallownet = nn.Sequential(
            nn.Conv2d(1, 40, (1, 25)),
            nn.Conv2d(40, 40, (meta.N_CHANNELS, 1)),
            BatchNorm2d(40, eps=1e-5),
            nn.ELU(),
            nn.AvgPool2d((1, 75), (1, 15)),
            Dropout(dropout))
        self.projection = nn.Sequential(nn.Conv2d(40, emb_size, (1, 1)))

    def forward(self, x):
        h = self.projection(self.shallownet(x))  # (B, emb, 1, W)
        return h.flatten(2).transpose(1, 2)  # tokens along (h w): (B, W, emb)


class _ClassificationHead(nn.Module):
    """``fc`` flattens the tokens into Linear(280 -> out); ``clshead`` is the
    reference's unused branch, kept for its keys."""

    def __init__(self, emb_size: int, n_tokens: int, out_dim: int):
        super().__init__()
        self.clshead = nn.Sequential(nn.Identity(), nn.LayerNorm(emb_size),
                                     nn.Linear(emb_size, out_dim))
        self.fc = nn.Sequential(nn.Linear(emb_size * n_tokens, out_dim))

    def forward(self, x):
        return self.fc(x.flatten(1))


class Conformer(nn.Sequential):
    """reference models.py:343-350: PatchEmbedding (a ShallowNet-style
    patcher, AvgPool(1,75)/stride 15) -> 3 pre-LN transformer blocks ->
    flatten -> Linear(280 -> out), 280 = 7 tokens of 40 at T = 200, the
    reference's size. Keys: ``0`` the patch embedding, ``1.<d>`` the blocks,
    ``2`` the head."""

    def __init__(self, out_dim: int, emb_size: int = 40, depth: int = 3, num_heads: int = 10,
                 dropout: float = 0.5, T: int = meta.FS):
        blocks = [nn.Sequential(
            _Residual(nn.LayerNorm(emb_size, eps=1e-5),
                      _ConformerMHA(emb_size, num_heads, dropout), Dropout(dropout)),
            _Residual(nn.LayerNorm(emb_size, eps=1e-5),
                      nn.Sequential(nn.Linear(emb_size, 4 * emb_size), nn.GELU(),
                                    Dropout(dropout), nn.Linear(4 * emb_size, emb_size)),
                      Dropout(dropout)))
            for _ in range(depth)]
        super().__init__(_PatchEmbedding(emb_size, dropout), nn.Sequential(*blocks),
                         _ClassificationHead(emb_size, _pooled(T - 24, 75, 15), out_dim))


class GLFNet(nn.Module):
    """reference models.py:352-373: a global ShallowNet on all channels and a
    local one on the occipital channels 50..61, concatenated -> Linear."""

    def __init__(self, out_dim: int, emb_dim: int, C: int = meta.N_CHANNELS,
                 T: int = 2 * meta.FS):
        super().__init__()
        self.globalnet = ShallowNet(emb_dim, C, T)
        self.occipital_localnet = ShallowNet(emb_dim, len(OCCIPITAL), T)
        self.out = nn.Linear(2 * emb_dim, out_dim)

    def forward(self, x):
        g = self.globalnet(x)
        loc = self.occipital_localnet(x[:, :, OCCIPITAL, :])
        return self.out(torch.cat([g, loc], dim=1))


class MLPNet(nn.Module):
    """reference models.py:375-390: Flatten -> 512 -> GELU -> 256 -> GELU ->
    out, for (B, C, 5) DE/PSD features (``input_dim`` = C * 5)."""

    def __init__(self, out_dim: int, input_dim: int = meta.N_CHANNELS * meta.N_BANDS):
        super().__init__()
        self.net = nn.Sequential(
            nn.Flatten(),
            nn.Linear(input_dim, 512),
            nn.GELU(),
            nn.Linear(512, 256),
            nn.GELU(),
            nn.Linear(256, out_dim))

    def forward(self, x):
        return self.net(x)


class GLFNetMLP(nn.Module):
    """reference models.py:392-413: a global MLPNet on all channels and an
    occipital one on 12 x 5 features -> concat -> Linear. Input (B, C, 5)."""

    def __init__(self, out_dim: int, emb_dim: int,
                 input_dim: int = meta.N_CHANNELS * meta.N_BANDS):
        super().__init__()
        self.globalnet = MLPNet(emb_dim, input_dim)
        self.occipital_localnet = MLPNet(emb_dim, len(OCCIPITAL) * meta.N_BANDS)
        self.out = nn.Linear(2 * emb_dim, out_dim)

    def forward(self, x):
        g = self.globalnet(x)
        loc = self.occipital_localnet(x[:, OCCIPITAL, :])
        return self.out(torch.cat([g, loc], dim=1))


class ShallowNetFlexible(nn.Module):
    """ShallowNet with adaptive average pooling, so any T works (the README
    branch, README.md:74): 26 time bins of torch's AdaptiveAvgPool2d (bin i
    averages [floor(i w / 26), ceil((i + 1) w / 26))), the T = 200 shape of
    the original."""

    def __init__(self, out_dim: int, C: int = meta.N_CHANNELS, pooled: int = 26):
        super().__init__()
        self.net = nn.Sequential(
            nn.Conv2d(1, 40, (1, 25)),
            nn.Conv2d(40, 40, (C, 1)),
            BatchNorm2d(40, eps=1e-5),
            nn.ELU(),
            nn.AdaptiveAvgPool2d((1, pooled)),
            Dropout(0.5))
        self.out = nn.Linear(40 * pooled, out_dim)

    def forward(self, x):
        return self.out(self.net(x).flatten(1))


class GLMNet(nn.Module):
    """The README branch's GLMNet (README.md:72-91): a ShallowNetFlexible on
    raw EEG windows and an MLPNet on their DE/PSD features, concatenated
    (the (B, 2 emb_dim) "EEG embedding", 512-d at emb_dim 256) into a Linear
    head. Inputs: raw (B, 1, C, T), feat (B, C, 5). T is unused (the pooling
    adapts), as in the JAX class."""

    def __init__(self, out_dim: int, emb_dim: int = 64, C: int = meta.N_CHANNELS,
                 T: int = meta.FS // 2):
        super().__init__()
        self.rawnet = ShallowNetFlexible(emb_dim, C)
        self.featnet = MLPNet(emb_dim, C * meta.N_BANDS)
        self.out = nn.Linear(2 * emb_dim, out_dim)

    def forward(self, raw, feat, return_embedding: bool = False):
        emb = torch.cat([self.rawnet(raw), self.featnet(feat)], dim=1)
        if return_embedding:
            return emb
        return self.out(emb)


_ENCODERS = {
    "shallownet": ShallowNet,
    "deepnet": DeepNet,
    "eegnet": EEGNet,
    "tsconv": TSConv,
    "conformer": Conformer,
    "glfnet": GLFNet,
    "mlpnet": MLPNet,
    "glfnet_mlp": GLFNetMLP,
    "glmnet": GLMNet,
}


def make_encoder(name: str, **kwargs) -> nn.Module:
    """Factory mirroring the reference's model-class names."""
    try:
        return _ENCODERS[name](**kwargs)
    except KeyError:
        raise ValueError(f"unknown encoder '{name}'; available: {sorted(_ENCODERS)}")
