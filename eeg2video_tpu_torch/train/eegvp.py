"""EEG-VP 40-class benchmark trainer (reference EEG-VP/EEG_VP_train_test.py).

Counterpart of ``eeg2video_tpu/train/eegvp.py``: leave-one-block-out
cross-validation on DE_1per1s features, test block b, validation block b - 1,
train the rest (reference L238-252); each split z-scored by its *own*
StandardScaler (L259-267, a reference quirk kept); Xavier-uniform for every
2-D Linear weight (L128-131); AdamW lr 1e-3, weight decay 1e-2, cross
entropy; epochs of shuffled full batches; the validation top-1 after every
epoch and the parameters of the best one kept (L149-167); top-1 / top-5,
predictions and a confusion matrix on the test block (L109-124, L300-331).

The step is functional (``torch.func``: ``functional_call``, ``grad_and_value``) and
AdamW is optax's ``adamw`` written as elementwise math, so that
``fold_parallel=True`` runs the seven folds as one batched program on one
card (parameters stacked along a fold axis, ``torch.func.vmap`` over the same
functions) and gives each fold the serial path's results.

Draws: a fold's initial parameters come from a ``torch.Generator`` keyed by
(seed, fold), its epoch's permutation from one keyed by (seed, fold, epoch);
the JAX package draws from ``jax.random`` keys (ROADMAP §3). ``train_fold``
takes ``init_params`` and ``perms`` from a caller that wants other draws.

The only encoder JAX's ``run_benchmark`` runs is ``glfnet_mlp``: its
``make_encoder(cfg.encoder, out_dim=..., emb_dim=...)`` gives every other
class an ``emb_dim`` it does not take, or (``glfnet``, ``glmnet``) inputs of
the wrong rank or count, and its step applies ``{"params": p}`` with no
mutable ``batch_stats``. Other encoders are refused by name before any step,
as is a ``mesh`` (more than one device: ROADMAP §1 item 10).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from ..data import meta
from ..models import make_encoder
from ..models.init import lecun_init_
from ..utils import StandardScaler, resolve_device

RUNNABLE_ENCODERS = ("glfnet_mlp",)
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults


@dataclasses.dataclass
class EEGVPConfig:
    out_dim: int = 40
    emb_dim: int = 64
    batch_size: int = 256
    epochs: int = 100
    lr: float = 1e-3
    weight_decay: float = 1e-2  # torch AdamW default (reference L134)
    encoder: str = "glfnet_mlp"


def make_fold_splits(test_block: int):
    """(train_blocks, val_block, test_block) - reference L238-241."""
    val_block = (test_block - 1) % meta.N_BLOCKS
    train = [b for b in range(meta.N_BLOCKS) if b not in (test_block, val_block)]
    return train, val_block, test_block


def block_labels(reps_per_concept: int) -> np.ndarray:
    """0-indexed labels per block, presentation order (reference L204-206)."""
    return meta.all_labels(reps_per_concept)


def _fold_arrays(features, labels, test_block):
    """Host-side split + per-split scaler for one fold -> dict of numpy
    ``{split: (x (n, C, 5), y (n,))}``."""
    tr_blocks, val_b, te_b = make_fold_splits(test_block)
    flat = lambda bs: features[bs].reshape(-1, features.shape[-2] * features.shape[-1])
    xs = {"train": flat(tr_blocks), "val": flat(val_b), "test": flat(te_b)}
    ys = {
        "train": labels[tr_blocks].reshape(-1),
        "val": labels[val_b].reshape(-1),
        "test": labels[te_b].reshape(-1),
    }
    # reference quirk: every split gets its OWN scaler (L259-267)
    C = features.shape[-2]
    data = {}
    for k in xs:
        scaled = StandardScaler().fit_transform(xs[k])
        data[k] = (scaled.reshape(-1, C, features.shape[-1]), ys[k].astype(np.int32))
    return data


def _refuse(cfg: EEGVPConfig, mesh=None):
    if mesh is not None:
        raise ValueError("mesh: the fold-parallel benchmark across devices is multi-GPU and "
                         "not ported yet (ROADMAP.md §1 item 7); fold_parallel=True batches "
                         "the folds on one GPU")
    if cfg.encoder not in RUNNABLE_ENCODERS:
        raise ValueError(
            f"encoder '{cfg.encoder}': the EEG-VP trainer runs {list(RUNNABLE_ENCODERS)}, the "
            "encoders the JAX package's run_benchmark runs (the others take no emb_dim, "
            "other inputs, or BatchNorm statistics its step does not update)")


def _generator(device, *key):
    """A generator that is a function of ``key`` (integers) only."""
    seed = 0
    for k in key:
        seed = (seed * 1_000_003 + int(k)) % (1 << 62)
    return torch.Generator(device=device).manual_seed(seed)


def _model(cfg: EEGVPConfig, n_channels: int):
    return make_encoder(cfg.encoder, out_dim=cfg.out_dim, emb_dim=cfg.emb_dim,
                        input_dim=n_channels * meta.N_BANDS)


def init_fold_params(cfg: EEGVPConfig, n_channels: int, seed: int, fold: int, device):
    """A fold's initial parameters: flax's default initializers, then
    Xavier-uniform for every 2-D Linear weight, from (seed, fold)."""
    model = _model(cfg, n_channels).to(device)
    g = _generator(device, seed, fold)
    lecun_init_(model, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                torch.nn.init.xavier_uniform_(m.weight, generator=g)
    return {k: v.detach().clone() for k, v in model.named_parameters()}


def _loss(model, params, x, y):
    logits = functional_call(model, params, (x,))
    return F.cross_entropy(logits, y.long())


def _adamw(params, grads, mu, nu, count, lr, wd):
    """optax.adamw (scale_by_adam, add_decayed_weights, scale by -lr) on
    dicts of tensors; ``count`` the step number after this update."""
    c1 = 1.0 - ADAM_B1 ** count
    c2 = 1.0 - ADAM_B2 ** count
    out_p, out_m, out_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = (1.0 - ADAM_B1) * g + ADAM_B1 * mu[k]
        v = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu[k]
        u = (m / c1) / (torch.sqrt(v / c2) + ADAM_EPS) + wd * p
        out_p[k], out_m[k], out_v[k] = p + (-lr) * u, m, v
    return out_p, out_m, out_v


def _top1(logits, y):
    return (logits.argmax(-1) == y).float().mean()


def _train_program(model, cfg, params, perms, x_all, y_all, xv, yv, batched: bool):
    """The whole fold (or, ``batched``, every fold at once along a leading
    axis): epochs of shuffled full batches, the validation top-1 after each,
    the parameters of the best epoch kept. Returns (best_params, best_val,
    losses, vals), the last three (epochs,) tensors ((folds, epochs) batched)."""
    step_fn = grad_and_value(lambda p, x, y: _loss(model, p, x, y))
    val_fn = lambda p, x, y: _top1(functional_call(model, p, (x,)), y)
    if batched:
        step_fn, val_fn = vmap(step_fn), vmap(val_fn)
    lead = x_all.shape[:1] if batched else ()
    folds = torch.arange(lead[0], device=x_all.device)[:, None] if batched else None
    bs = cfg.batch_size
    n_batches = max(x_all.shape[-3] // bs, 1)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    best_params = {k: v.clone() for k, v in params.items()}
    best_val = torch.full(lead, -1.0, device=x_all.device)
    losses, vals, count = [], [], 0
    for epoch in range(cfg.epochs):
        perm = perms[..., epoch, :n_batches * bs].reshape(*lead, n_batches, bs)
        ep_loss = torch.zeros(lead, device=x_all.device)
        for b in range(n_batches):
            idx = perm[..., b, :]
            sel = (folds, idx) if batched else idx
            g, loss = step_fn(params, x_all[sel], y_all[sel])
            ep_loss = ep_loss + loss.detach()
            count += 1
            params, mu, nu = _adamw(params, g, mu, nu, count, cfg.lr, cfg.weight_decay)
        with torch.no_grad():
            val = val_fn(params, xv, yv)
        better = val > best_val
        best_val = torch.where(better, val, best_val)
        for k, v in params.items():
            sel = better.reshape(*lead, *([1] * (v.dim() - len(lead))))
            best_params[k] = torch.where(sel, v, best_params[k])
        losses.append(ep_loss / n_batches)
        vals.append(val)
    return best_params, best_val, torch.stack(losses, -1), torch.stack(vals, -1)


def _eval(model, params, x, y, n_classes):
    """top-1, top-5, predictions and the confusion matrix (``_eval_fold`` :111)."""
    with torch.no_grad():
        logits = functional_call(model, params, (x,))
    preds = logits.argmax(-1)
    top5 = (logits.topk(5, dim=-1).indices == y[:, None]).any(dim=1).float().mean()
    conf = torch.zeros((n_classes, n_classes), dtype=torch.int64, device=x.device)
    conf.index_put_((y.long(), preds), torch.ones_like(preds), accumulate=True)
    # int32, as the JAX package's argmax and confusion give them
    return (float(_top1(logits, y)), float(top5), preds.cpu().numpy().astype(np.int32),
            conf.cpu().numpy().astype(np.int32))


def _fold_perms(n: int, epochs: int, seed: int, fold: int, device):
    return torch.stack([torch.randperm(n, generator=_generator(device, seed, fold, e),
                                       device=device) for e in range(epochs)])


def train_fold(features: np.ndarray, labels: np.ndarray, test_block: int,
               cfg: EEGVPConfig = EEGVPConfig(), seed: int = 0, verbose=False, device="cuda",
               init_params=None, perms=None):
    """features: (7, N, C, 5) per-block DE features (presentation order),
    labels: (7, N). Returns a dict with accuracies, predictions, confusion,
    the best epoch's parameters, and each epoch's loss and validation top-1.

    ``init_params`` ({name: tensor}) and ``perms`` ((epochs, n_train) int)
    replace the draws keyed by (seed, test_block)."""
    _refuse(cfg)
    device = resolve_device(device)
    data = _fold_arrays(features, labels, test_block)
    model = _model(cfg, features.shape[-2]).to(device)
    x_all, y_all, xv, yv, xt, yt = (torch.as_tensor(a, device=device) for a in
                                    (*data["train"], *data["val"], *data["test"]))
    if init_params is None:
        init_params = init_fold_params(cfg, features.shape[-2], seed, test_block, device)
    params = {k: torch.as_tensor(v).to(device, torch.float32) for k, v in init_params.items()}
    perms = (_fold_perms(len(y_all), cfg.epochs, seed, test_block, device) if perms is None
             else torch.as_tensor(np.asarray(perms), device=device))
    best, best_val, losses, vals = _train_program(model, cfg, params, perms, x_all, y_all, xv, yv,
                                                  batched=False)
    if verbose:
        for epoch in range(19, cfg.epochs, 20):
            print(f"  epoch {epoch + 1}: loss={float(losses[epoch]):.4f} "
                  f"val_top1={float(vals[epoch]):.3f}")
    top1, top5, preds, conf = _eval(model, best, xt, yt, cfg.out_dim)
    return {"test_top1": top1, "test_top5": top5, "val_top1": float(best_val),
            "predictions": preds, "confusion": conf, "params": best,
            "losses": losses.cpu().numpy(), "val_curve": vals.cpu().numpy()}


def _run_benchmark_parallel(features, labels, cfg, seed, device):
    """All 7 folds as one batched program on one device (``_train_program``
    under ``vmap``); per-fold draws and data as in the serial path."""
    model = _model(cfg, features.shape[-2]).to(device)
    datas = [_fold_arrays(features, labels, tb) for tb in range(meta.N_BLOCKS)]
    stack = lambda split, i: torch.as_tensor(np.stack([d[split][i] for d in datas]),
                                             device=device)
    x_all, y_all = stack("train", 0), stack("train", 1)
    xv, yv, xt, yt = stack("val", 0), stack("val", 1), stack("test", 0), stack("test", 1)
    inits = [init_fold_params(cfg, features.shape[-2], seed + tb, tb, device)
             for tb in range(meta.N_BLOCKS)]
    params = {k: torch.stack([p[k] for p in inits]) for k in inits[0]}
    perms = torch.stack([_fold_perms(x_all.shape[1], cfg.epochs, seed + tb, tb, device)
                         for tb in range(meta.N_BLOCKS)])
    best, best_vals, losses, vals = _train_program(model, cfg, params, perms, x_all, y_all, xv,
                                                   yv, batched=True)
    folds = []
    for tb in range(meta.N_BLOCKS):
        p = {k: v[tb] for k, v in best.items()}
        top1, top5, preds, conf = _eval(model, p, xt[tb], yt[tb], cfg.out_dim)
        folds.append({"test_top1": top1, "test_top5": top5, "val_top1": float(best_vals[tb]),
                      "predictions": preds, "confusion": conf, "params": p,
                      "losses": losses[tb].cpu().numpy(), "val_curve": vals[tb].cpu().numpy()})
    return folds


def run_benchmark(features, labels, cfg: EEGVPConfig = EEGVPConfig(), seed=0, verbose=False,
                  fold_parallel=False, mesh=None, device="cuda"):
    """Full 7-fold leave-one-block-out benchmark (reference L238-362): fold b
    is keyed by (seed + b, b), as JAX seeds fold b with seed + b. Returns the
    per-fold results + a mean/std summary.

    ``fold_parallel``: all 7 folds as one batched program on ``device``, the
    same results per fold as the serial path."""
    _refuse(cfg, mesh)
    device = resolve_device(device)
    if fold_parallel:
        folds = _run_benchmark_parallel(features, labels, cfg, seed, device)
    else:
        folds = [train_fold(features, labels, tb, cfg, seed=seed + tb, verbose=verbose,
                            device=device) for tb in range(meta.N_BLOCKS)]
    if verbose:
        for tb, r in enumerate(folds):
            print(f"fold test_block={tb}: top1={r['test_top1']:.3f} top5={r['test_top5']:.3f}")
    top1s = [f["test_top1"] for f in folds]
    top5s = [f["test_top5"] for f in folds]
    return {
        "folds": folds,
        "top1_mean": float(np.mean(top1s)), "top1_std": float(np.std(top1s)),
        "top5_mean": float(np.mean(top5s)), "top5_std": float(np.std(top5s)),
    }
