"""One configuration tree, loadable from YAML and from dotted overrides.

Counterpart of ``eeg2video_tpu/config.py`` (:23-86): the data paths, the
generation defaults (the reference's inference_eeg2video.py:74-86) and the
port's ``UNet3DConfig``, ``VAEConfig`` and ``VideoDiffusionTrainConfig`` in
one dataclass tree. ``load_config`` applies a YAML file, then ``a.b.c=value``
overrides (each value parsed as YAML); a field that does not exist is refused
by name.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import yaml

from .models.unet3d import UNet3DConfig
from .models.vae import VAEConfig
from .train.videodiffusion import VideoDiffusionTrainConfig


@dataclasses.dataclass
class DataPaths:
    eeg_root: str = "./data/EEG"
    preprocessing_root: str = "./data/Preprocessing"
    video_gifs: str = "./data/Video_gifs"
    text_embeddings: str = "./data/Text_embeddings"
    train_latents: str = "./data/1200_latent.npy"
    test_latents: str = "./data/40classes_latents.pt"
    flow_scores: str = "./data/meta_info/All_video_optical_flow_score.npy"
    outputs: str = "./outputs"


@dataclasses.dataclass
class GenerationConfig:
    video_length: int = 6
    height: int = 288
    width: int = 512
    num_inference_steps: int = 100
    guidance_scale: float = 12.5
    seed: int = 114514


@dataclasses.dataclass
class Config:
    data: DataPaths = dataclasses.field(default_factory=DataPaths)
    generation: GenerationConfig = dataclasses.field(default_factory=GenerationConfig)
    unet: UNet3DConfig = dataclasses.field(default_factory=UNet3DConfig)
    vae: VAEConfig = dataclasses.field(default_factory=VAEConfig)
    train: VideoDiffusionTrainConfig = dataclasses.field(
        default_factory=VideoDiffusionTrainConfig)


def _apply(obj, updates: dict):
    """``obj`` with the fields of ``updates`` replaced, nested dicts applied to
    nested dataclasses; an unknown field raises ``KeyError`` naming it."""
    if not dataclasses.is_dataclass(obj):
        raise TypeError(f"cannot apply config dict to {type(obj)}")
    fields = {f.name for f in dataclasses.fields(obj)}
    kw = {}
    for k, v in updates.items():
        if k not in fields:
            raise KeyError(f"unknown config field '{k}' for {type(obj).__name__}")
        cur = getattr(obj, k)
        kw[k] = _apply(cur, v) if isinstance(v, dict) and dataclasses.is_dataclass(cur) else v
    return dataclasses.replace(obj, **kw)


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> Config:
    """YAML file + dotted ``a.b.c=value`` overrides -> ``Config``."""
    cfg = Config()
    if path:
        with open(path) as f:
            cfg = _apply(cfg, yaml.safe_load(f) or {})
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        val: Any = yaml.safe_load(raw)
        tree: dict = {}
        cur = tree
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = val
        cfg = _apply(cfg, tree)
    return cfg
