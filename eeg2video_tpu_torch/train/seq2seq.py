"""The Seq2Seq stage's trainer and helpers (reference EEG2Video_New/Seq2Seq/
my_autoregressive_transformer.py:278-391, plus the README branch contract:
``--normalize`` / ``--stats_path`` producing stats.npz, README.md:129-138).

Counterpart of ``eeg2video_tpu/train/seq2seq.py``: the 100/50 windowing of
2 s segments, the reference's data plumbing, the trainer and the chunked
rollout. The recipe: Adam 5e-4 on a cosine decay over ``epochs * ceil(n /
bs)`` steps, batch 32, MSE(video latents, rollout[:, :-1]) (reference
L349-374); the model runs in train mode (dropout, batch statistics) and its
rollout stays autoregressive, as the reference's does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..data import meta
from ..models.init import lecun_init_
from ..models.seq2seq import Seq2SeqTransformer
from ..utils import StandardScaler, get_logger, resolve_device
from .optim import cosine_decay_schedule, set_lr
from .semantic import pad_rows
from .videodiffusion import step_generator

log = get_logger(__name__)

# Rows per dispatch in rollout_latents; the warm server's Seq2Seq runtime goes
# through the same function, so a file-chained run and the server run one
# shape: a different batch shape may be summed in another order.
ROLLOUT_CHUNK = 50


def windows_from_segments(seg: np.ndarray) -> np.ndarray:
    """(..., C, 400) 2 s raw segments -> (..., 7, C, 100) sliding windows
    (100 samples every 50, reference my_autoregressive_transformer.py:309-314):
    the Seq2Seq model's input contract."""
    if seg.shape[-1] != 400:
        raise ValueError(f"expected 400-sample segments, got {seg.shape}")
    return np.stack([seg[..., i:i + 100] for i in range(0, 301, 50)], axis=-3)


def prepare_seq2seq_data(raw_eeg: np.ndarray, train_latents: np.ndarray,
                         test_latents: np.ndarray):
    """Reproduces the reference data plumbing (L278-340): GT-label reorder of
    EEG and latents, 100/50 windowing of the 400-sample segments, blocks 0-5
    train / 6 test, StandardScaler fit on flattened train EEG applied to both.

    raw_eeg: (7, 40, 5, 62, 400); train_latents: (1200, 4, 6, 36, 64)
    (the 1200_latent.npy layout); test_latents: (200, 4, 6, 36, 64).
    Returns (train_eeg (1200,7,62,100), train_lat (1200,6,4,36,64),
             test_eeg (200,7,62,100), test_lat (200,6,4,36,64), scaler).
    """
    # reorder presentation order -> class order per block (L289-304)
    eeg = np.stack([meta.reorder_by_gt(raw_eeg[b], b) for b in range(7)])
    lat = train_latents.reshape(6, 40, 5, *train_latents.shape[1:])
    lat = np.stack([meta.reorder_by_gt(lat[b], b) for b in range(6)])
    lat = lat.reshape(-1, *train_latents.shape[1:])  # (1200, 4, 6, 36, 64)

    # 400 -> 7 windows of 100 every 50 (L309-314), window axis first
    win = windows_from_segments(eeg)
    # win: (7, 40, 5, 7w, 62, 100) -> flatten trials
    win = win.reshape(7, 40 * 5, 7, 62, 100)
    train_eeg = win[:6].reshape(-1, 7, 62, 100)
    test_eeg = win[6]

    scaler = StandardScaler().fit(train_eeg.reshape(len(train_eeg), -1))
    train_eeg = scaler.transform(train_eeg.reshape(len(train_eeg), -1)).reshape(-1, 7, 62, 100)
    test_eeg = scaler.transform(test_eeg.reshape(len(test_eeg), -1)).reshape(-1, 7, 62, 100)

    # latents 'b c f h w -> b f c h w' (L333-334)
    train_lat = np.transpose(lat, (0, 2, 1, 3, 4)).astype(np.float32)
    test_lat = np.transpose(np.asarray(test_latents), (0, 2, 1, 3, 4)).astype(np.float32)
    return train_eeg, train_lat, test_eeg, test_lat, scaler


@dataclasses.dataclass
class Seq2SeqTrainConfig:
    epochs: int = 200
    batch_size: int = 32
    lr: float = 5e-4
    normalize: bool = False  # latent z-scoring (README branch option)


def train_seq2seq(train_eeg, train_lat, cfg: Seq2SeqTrainConfig = Seq2SeqTrainConfig(),
                  seed: int = 0, model=None, device="cuda", on_step=None):
    """Train on (N, 7, 62, 100) windows and (N, F, C, H, W) latents; returns
    ``(state_dict, losses)``: the state dict in the reference's keys (what
    ``cli.inference_seq2seq_v2 --ckpt`` and ``cli.serve --seq2seq_ckpt``
    read), on ``device``, and each epoch's loss summed over its batches.

    ``model``: a built ``Seq2SeqTransformer`` to start from (moved to
    ``device``); by default ``Seq2SeqTransformer()`` with flax's default
    initializers, drawn from ``seed``. An epoch's dropout draws come from
    ``step_generator(seed, epoch)``, a function of those two only.
    ``on_step(step, loss, optimizer)`` is called after every step."""
    device = resolve_device(device)
    if model is None:
        model = lecun_init_(Seq2SeqTransformer().to(device),
                            torch.Generator(device=device).manual_seed(seed))
    model = model.to(device).train()

    n = len(train_eeg)
    bs = cfg.batch_size
    sched = cosine_decay_schedule(cfg.lr, cfg.epochs * int(np.ceil(n / bs)))
    opt = torch.optim.Adam(model.parameters(), lr=sched(0))
    x_all = torch.as_tensor(np.asarray(train_eeg, np.float32), device=device)
    y_all = torch.as_tensor(np.asarray(train_lat, np.float32), device=device)
    n_batches = n // bs
    rng = np.random.default_rng(seed)
    losses = []
    step = 0
    for epoch in range(cfg.epochs):
        model.set_dropout_generator(step_generator(seed, epoch, device))
        perm = torch.as_tensor(rng.permutation(n)[: n_batches * bs], device=device)
        ep_loss = torch.zeros((), device=device)
        for idx in perm.view(n_batches, bs):
            set_lr(opt, sched(step))
            _, out = model(x_all[idx])
            loss = torch.mean((out[:, :-1] - y_all[idx]) ** 2)  # reference L369
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep_loss += loss.detach()
            step += 1
            if on_step is not None:
                on_step(step, loss.detach(), opt)
        losses.append(float(ep_loss))  # one host synchronization an epoch
        if (epoch + 1) % 10 == 0:
            log.info("seq2seq epoch %d loss %.5f", epoch + 1, losses[-1])
    model.set_dropout_generator(None)
    return {k: v.detach() for k, v in model.state_dict().items()}, losses


def rollout_latents(model, eeg, batch_size: int = ROLLOUT_CHUNK) -> np.ndarray:
    """Inference rollout of a ``Seq2SeqTransformer`` (in eval mode, on its
    device) over (N, 7, 62, 100) windows -> (N, F, C, H, W) float32 latents,
    the latent_out_block7_40_classes.npy artifact (reference L377-387). The
    final ragged chunk is zero-padded to ``batch_size`` (batch elements are
    independent) so that every dispatch has one shape."""
    device = next(model.parameters()).device
    n = len(eeg)
    eeg = pad_rows(np.asarray(eeg, np.float32), batch_size)
    with torch.inference_mode():
        outs = [model(torch.from_numpy(eeg[s:s + batch_size]).to(device))[1][:, :-1]
                .float().cpu().numpy() for s in range(0, len(eeg), batch_size)]
    return np.concatenate(outs)[:n]
