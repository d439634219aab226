"""Semantic-predictor trainer and predictors on one GPU (reference
EEG2Video_New/Semantic/eeg_text.py:108-175; the legacy data plumbing of
EEG2Video/models/train_semantic_predictor.py).

Counterpart of ``eeg2video_tpu/train/semantic.py``. The recipe: MSE to CLIP
text embeddings, Adam 5e-4 on a cosine decay over ``epochs * ceil(n / bs)``
steps (an epoch runs ``n // bs`` batches, so the schedule never reaches its
end, as in JAX), 200 epochs, batch 32, z-scored DE features; each epoch
shuffles with ``np.random.default_rng(seed).permutation(n)``. The JAX
trainer's tensor-parallel and pipelined forms (``tp``, ``pp``, ``n_micro``)
are multi-GPU and are refused by name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import meta
from ..models.init import lecun_init_
from ..models.semantic import (CLIP_DIM, CLIP_TOKENS, HIDDEN, Int8SemanticPredictor,
                               SemanticPredictor)
from ..utils import StandardScaler, get_logger, resolve_device
from .optim import Adam8bit, cosine_decay_schedule, set_lr

log = get_logger(__name__)

# Rows per dispatch of the predict paths and of the serving runtime
# (serving/runtimes.py): requests are zero-padded to a multiple of it, so the
# file chain and the warm server run one shape; a different batch shape may
# be summed in another order, and that drift can cross a uint8 GIF
# quantization boundary downstream.
PREDICT_CHUNK = 100


@dataclasses.dataclass
class SemanticTrainConfig:
    epochs: int = 200
    batch_size: int = 32
    lr: float = 5e-4
    hidden: int = HIDDEN
    out_dim: int = CLIP_TOKENS * CLIP_DIM
    # int8 Adam moments (train.optim.Adam8bit): a quarter of the f32 moments'
    # bytes for the 894M-parameter MLP
    use_8bit_adam: bool = False


def prepare_semantic_data(de_features: np.ndarray, text_embeddings):
    """Reference data plumbing (eeg_text.py:113-136): GT reorder blocks 0-5,
    flatten (62, 5) -> 310.

    de_features: (7, 40, 5, 62, 5) DE_1per2s; text_embeddings: 6 per-block
    (200, 77, 768) arrays already in the reference's block order. The
    reference reorders the text of every block with block 0's indices and
    subsamples [::5] then repeats (L130-131); kept."""
    eeg = np.stack([meta.reorder_by_gt(de_features[b], b) for b in range(6)])
    eeg = eeg.reshape(-1, meta.N_CHANNELS * meta.N_BANDS)  # (1200, 310)
    texts = []
    idx0 = meta.block_reorder_indices(0)
    for b in range(6):
        t = np.asarray(text_embeddings[b])
        t = t.reshape(40, 5, *t.shape[1:])
        t = t[idx0][:, ::5]  # (40, 1, ...)
        t = np.repeat(t, 5, axis=1)
        texts.append(t.reshape(200, -1))
    text = np.concatenate(texts)
    scaler = StandardScaler().fit(eeg)
    return scaler.transform(eeg), text.astype(np.float32), scaler


def prepare_semantic_data_legacy(de_1per1s: np.ndarray, text_embeddings: np.ndarray):
    """Legacy variant (reference EEG2Video_New/Generation/models/
    train_semantic_predictor.py:80-115): DE_1per1s features (7, 40, 5, 2, 62,
    5), GT-reordered blocks 0-5, averaged over the two 1 s windows -> (1200,
    310); targets are the first 1200 rows of one text_embeddings array."""
    eeg = np.stack([meta.reorder_by_gt(de_1per1s[b], b) for b in range(6)])
    eeg = eeg.reshape(6 * 40 * 5, 2, meta.N_CHANNELS * meta.N_BANDS).mean(axis=1)
    text = np.asarray(text_embeddings)[: 6 * 200].reshape(1200, -1)
    scaler = StandardScaler().fit(eeg)
    return scaler.transform(eeg), text.astype(np.float32), scaler


def _refuse_multi_gpu(tp, pp, n_micro):
    for name, value in (("tp", tp), ("pp", pp), ("n_micro", n_micro)):
        if value != 1:
            raise ValueError(f"{name}={value}: the semantic trainer's tensor-parallel and "
                             "pipelined forms are multi-GPU and not ported yet "
                             "(ROADMAP.md §1 item 7); this trainer "
                             "runs on one GPU")


def train_semantic(eeg, text, cfg: SemanticTrainConfig = SemanticTrainConfig(), seed: int = 0,
                   tp: int = 1, pp: int = 1, n_micro: int = 1, model=None, device="cuda",
                   on_step=None):
    """Train the semantic MLP on (N, 310) features and (N, out_dim) targets;
    returns ``(state_dict, losses)``: the trained ``SemanticPredictor``'s
    state dict (on ``device``) and each epoch's loss summed over its batches.

    ``model``: a built ``SemanticPredictor`` to start from (it is moved to
    ``device``); by default one at ``cfg.hidden`` / ``cfg.out_dim`` with
    flax's default initializers, drawn from ``seed``. ``on_step(step, loss,
    optimizer)`` is called after every step."""
    _refuse_multi_gpu(tp, pp, n_micro)
    device = resolve_device(device)
    if model is None:
        with torch.device("meta"):
            model = SemanticPredictor(hidden=cfg.hidden, out_dim=cfg.out_dim,
                                      in_dim=eeg.shape[-1])
        model = lecun_init_(model.to_empty(device=device),
                            torch.Generator(device=device).manual_seed(seed))
    model = model.to(device).train()

    n = len(eeg)
    bs = cfg.batch_size
    steps_per_epoch = int(np.ceil(n / bs))
    sched = cosine_decay_schedule(cfg.lr, cfg.epochs * steps_per_epoch)
    adam = Adam8bit if cfg.use_8bit_adam else torch.optim.Adam
    opt = adam(model.parameters(), lr=sched(0))
    x_all = torch.as_tensor(np.asarray(eeg, np.float32), device=device)
    y_all = torch.as_tensor(np.asarray(text, np.float32), device=device)
    n_batches = n // bs
    rng = np.random.default_rng(seed)
    losses = []
    step = 0
    for epoch in range(cfg.epochs):
        perm = torch.as_tensor(rng.permutation(n)[: n_batches * bs], device=device)
        ep_loss = torch.zeros((), device=device)
        for idx in perm.view(n_batches, bs):
            set_lr(opt, sched(step))
            loss = torch.mean((model(x_all[idx]) - y_all[idx]) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep_loss += loss.detach()
            step += 1
            if on_step is not None:
                on_step(step, loss.detach(), opt)
        losses.append(float(ep_loss))  # one host synchronization an epoch
        if (epoch + 1) % 10 == 0:
            log.info("semantic epoch %d loss %.5f", epoch + 1, losses[-1])
    return {k: v.detach() for k, v in model.state_dict().items()}, losses


def pad_rows(x, chunk):
    """Zero-pad axis 0 of ``x`` up to a multiple of ``chunk``."""
    pad = (-len(x)) % chunk
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def predict_in_chunks(apply, eeg, device, batch_size: int = PREDICT_CHUNK) -> np.ndarray:
    """``apply`` ((chunk, 310) tensor -> (chunk, D) tensor) over (N, 310)
    features, zero-padded to whole ``batch_size``-row chunks, one dispatch a
    chunk; returns (N, D) float32 numpy."""
    n = len(eeg)
    eeg = pad_rows(np.asarray(eeg, np.float32), batch_size)
    with torch.inference_mode():
        out = [apply(torch.from_numpy(eeg[s:s + batch_size]).to(device)).float().cpu().numpy()
               for s in range(0, len(eeg), batch_size)]
    return np.concatenate(out)[:n]


def semantic_from_state_dict(sd, device="cuda"):
    """A ``SemanticPredictor`` in eval mode on ``device`` holding ``sd`` (its
    widths read from the weights' shapes)."""
    device = resolve_device(device)
    n_hidden = sum(1 for k in sd if k.startswith("fc") and k.endswith(".weight"))
    hidden, in_dim = sd["fc0.weight"].shape
    with torch.device("meta"):
        model = SemanticPredictor(hidden=hidden, n_hidden=n_hidden,
                                  out_dim=sd["out.weight"].shape[0], in_dim=in_dim)
    model = model.to_empty(device=device).eval().requires_grad_(False)
    model.load_state_dict(sd, strict=True)
    return model


def predict_semantic(sd, eeg, device="cuda", batch_size: int = PREDICT_CHUNK) -> np.ndarray:
    """(N, 310) z-scored features -> (N, out_dim) embeddings through the f32
    MLP of state dict ``sd`` (the port's keys)."""
    device = resolve_device(device)
    return predict_in_chunks(semantic_from_state_dict(sd, device), eeg, device, batch_size)


def predict_semantic_int8(sd, eeg, device="cuda", batch_size: int = PREDICT_CHUNK) -> np.ndarray:
    """The same through the weight-only-int8 runtime: each layer's weight
    quantized once per column, each layer one ``int8_dense`` launch on the
    card (``models.semantic.Int8SemanticPredictor``)."""
    device = resolve_device(device)
    runtime = Int8SemanticPredictor.from_state_dict(sd, device)
    return predict_in_chunks(runtime, eeg, device, batch_size)
