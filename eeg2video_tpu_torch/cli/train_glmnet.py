"""CLI: train GLMNet (a ShallowNet on raw 500 ms windows and an MLP on their
DE/PSD features) on one GPU or data-parallel over several.

Counterpart of ``eeg2video_tpu/cli/train_glmnet.py``, the README GLMNet
contract (README.md:68-91):

- inputs: Segmented_500ms_sw (7,40,5,7,62,100) + DE_1per500ms (7,40,5,7,62,5);
- raw EEG normalized per channel with TRAIN-split statistics, written to
  ``norm_stats.npz`` and reloaded at inference (README.md:88, 99);
- ``--scheduler {steplr,reducelronplateau,cosine}`` and ``--min_lr``
  (README.md:89-91); optax's AdamW (weight decay 1e-4), whole shuffled epochs
  (numpy's permutation from ``--seed``, as in the JAX CLI), BatchNorm
  statistics updated in train mode;
- 40-class objective on blocks 0..5, block 6 held out (its top-1 logged).

Writes ``<save_path>/ckpt/train_state_<epochs>.pt`` (the model's state dict,
in the port's checkpoint format: ``train/checkpoint.py``), which
``cli.inference_glmnet`` reads, and ``glmnet_metrics.jsonl``. Dropout draws
come from a generator keyed by (seed, epoch); the initial parameters from a
``torch.Generator`` seeded with ``--seed`` (JAX: ``model.init``). The loop is
``train_glmnet``, which also takes given initial parameters and permutations.
``--device`` defaults to ``cuda``.

``--dp N`` (JAX :114-160 there) trains on a mesh of the world's first N
ranks, one GPU each (``torchrun --nproc_per_node M``, M >= N; on the CPU,
gloo; ``--dp 1`` without a launcher is a mesh of one): the batch is clamped
to the data, then rounded down to a multiple of N, and a batch that holds no
multiple ends the run (JAX's ``SystemExit``); the parameters are replicated,
each rank computes on its rows of every global batch (the same permutation
on every rank), the gradients are averaged over dp, the BatchNorm statistics
and the dropout masks are the global batch's (``layers.set_data_parallel``)
and the epoch's loss is the global batch mean. Rank 0 writes
``norm_stats.npz``, the metrics and the checkpoint and computes the block-6
top-1; ranks past the mesh exit 0, and so do all ranks but 0 of a launcher's
world without ``--dp``.
"""

import argparse
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..data import meta
from ..data.io import load_array
from ..models import make_encoder
from ..models.init import lecun_init_
from ..models.layers import set_data_parallel, set_dropout_generator
from ..parallel import init_distributed, is_host0, make_mesh
from ..parallel.distributed import rank, world_size
from ..parallel.mesh import mean_over
from ..train.checkpoint import save_train_state
from ..train.optim import set_lr
from ..utils import get_logger, resolve_device
from ..utils.metrics_logger import MetricsLogger

log = get_logger(__name__)

PLATEAU_PATIENCE, PLATEAU_FACTOR = 10, 0.1  # epochs without a better loss; lr factor


def make_lr_schedule(name: str, lr: float, min_lr: float, total_steps: int):
    """The learning rate at each step, as the JAX CLI's optax schedules give it
    (float32): ``cosine`` optax.cosine_decay_schedule(lr, total_steps, alpha =
    min_lr / lr); ``steplr`` a staircase of 0.1 every total_steps // 3 steps,
    floored at min_lr; ``reducelronplateau`` constant (the plateau logic runs
    between epochs, on the host)."""
    f32 = np.float32
    if name == "cosine":
        t, alpha = f32(total_steps), f32(min_lr / lr)

        def cosine(step: int) -> float:
            c = np.minimum(f32(step), t)
            cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / t))
            return float(f32(lr) * ((f32(1.0) - alpha) * cos + alpha))

        return cosine
    if name == "steplr":
        every = total_steps // 3 or 1
        return lambda step: float(np.maximum(f32(lr) * f32(0.1) ** f32(step // every),
                                             f32(min_lr)))
    if name == "reducelronplateau":
        return lambda step: float(f32(lr))
    raise ValueError(f"unknown scheduler '{name}'")


def prepare_glmnet_data(raw_sw, de_sw, train_blocks, test_block):
    """Flatten (block, concept, rep, window) into samples; per-channel
    z-scoring from train statistics (README.md:88)."""
    n = int(np.prod(raw_sw.shape[1:4]))
    raw = raw_sw.reshape(7, n, *raw_sw.shape[4:])  # (7, N, 62, 100)
    de = de_sw.reshape(7, n, *de_sw.shape[4:])  # (7, N, 62, 5)
    labels = meta.all_labels(n // meta.N_CONCEPTS)

    tr_raw = raw[train_blocks].reshape(-1, *raw.shape[2:])
    mean = tr_raw.mean(axis=(0, 2), keepdims=True)
    std = tr_raw.std(axis=(0, 2), keepdims=True) + 1e-8

    def norm(x):
        return ((x - mean) / std).astype(np.float32)

    data = {
        "train": (norm(tr_raw)[:, None],
                  de[train_blocks].reshape(-1, *de.shape[2:]).astype(np.float32),
                  labels[train_blocks].reshape(-1)),
        "test": (norm(raw[test_block])[:, None], de[test_block].astype(np.float32),
                 labels[test_block]),
    }
    return data, {"mean": mean, "std": std}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--raw_dir", default="./data/Preprocessing/Segmented_500ms_sw")
    p.add_argument("--de_dir", default="./data/Preprocessing/DE_1per500ms")
    p.add_argument("--sub", type=int, default=1)
    p.add_argument("--save_path", default="./outputs/glmnet")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--min_lr", type=float, default=1e-5)
    p.add_argument("--scheduler", choices=["steplr", "reducelronplateau", "cosine"],
                   default="cosine")
    p.add_argument("--emb_dim", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dp", type=int, default=0,
                   help="shard each batch over the first N ranks, one GPU each (a (dp,) mesh; "
                        "torchrun starts the ranks). 0 = one GPU, no mesh (default)")
    p.add_argument("--device", default="cuda",
                   help="the card by default (fails where there is none); 'cpu' for a dry run")
    return p


def glmnet_batch_size(batch_size: int, n: int, dp: int = 1) -> int:
    """The batch JAX's CLI trains with (:124-141 there): clamped to the n
    samples, then, under dp > 1, rounded down to a multiple of dp;
    ``SystemExit`` where no positive multiple fits."""
    if n < batch_size:
        log.info("batch_size %d > %d samples; clamping", batch_size, n)
        batch_size = n
    if dp > 1 and batch_size % dp:
        bs = (batch_size // dp) * dp
        if bs == 0:
            raise SystemExit(f"--dp {dp} needs at least dp samples per batch; "
                             f"batch_size={batch_size} (dataset n={n}) cannot "
                             f"shard over {dp} devices")
        batch_size = bs
        log.info("clamped batch_size to %d (divisible by dp=%d)", batch_size, dp)
    return batch_size


def train_glmnet(train, *, emb_dim=256, epochs=100, batch_size=256, lr=1e-3, min_lr=1e-5,
                 scheduler="cosine", seed=0, device="cuda", init_params=None, perms=None,
                 metrics=None, mesh=None):
    """Train GLMNet on the ``train`` split of ``prepare_glmnet_data``: whole
    shuffled epochs of AdamW (optax.adamw's defaults, weight decay 1e-4), the
    learning rate from ``make_lr_schedule``, the plateau rule between epochs,
    BatchNorm statistics updated in train mode. Returns the model (train
    mode) and each epoch's summed loss.

    ``init_params`` (a state dict in the port's keys) replaces the draw from
    a ``torch.Generator`` seeded with ``seed``; ``perms`` ((epochs, n) ints)
    replaces the epochs' permutations from ``np.random.default_rng(seed)``,
    JAX's own.

    On a ``mesh`` (``parallel.make_mesh(dp=N)``; every rank of it calls this
    with the same arguments) the batch follows ``glmnet_batch_size``, each
    rank computes on its dp slice of every global batch, the gradients are
    averaged over dp, BatchNorm and dropout follow the global batch
    (``layers.set_data_parallel``) and each epoch's loss is the global batch's;
    every rank returns the same model. A mesh of one is the one-GPU run."""
    device = resolve_device(device) if mesh is None else mesh.device
    group, dp, r = (None, 1, 0) if mesh is None else (
        mesh.group("dp"), mesh.size("dp"), mesh.rank("dp"))
    model = make_encoder("glmnet", out_dim=40, emb_dim=emb_dim).to(device)
    if init_params is None:
        lecun_init_(model, torch.Generator(device=device).manual_seed(seed))
    else:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in init_params.items()})
    set_data_parallel(model, group)
    xr, xf, y = (torch.as_tensor(a, device=device) for a in train)
    y = y.long()
    n = len(y)
    bs = glmnet_batch_size(batch_size, n, dp)
    n_batches = max(n // bs, 1)
    sched = make_lr_schedule(scheduler, lr, min_lr, epochs * n_batches)
    opt = torch.optim.AdamW(model.parameters(), lr=sched(0), betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)  # optax.adamw's defaults
    rng = np.random.default_rng(seed)
    plateau_best, plateau_wait, lr_scale = np.inf, 0, 1.0
    step, losses = 0, []
    model.train()
    for epoch in range(epochs):
        set_dropout_generator(model, torch.Generator(device=device).manual_seed(
            (seed << 20) + epoch))
        order = rng.permutation(n) if perms is None else np.asarray(perms[epoch])
        perm = torch.as_tensor(order[: n_batches * bs], device=device)
        ep = torch.zeros((), device=device)
        for idx in perm.view(n_batches, bs):
            idx = idx.chunk(dp)[r]  # this rank's rows of the global batch
            set_lr(opt, sched(step) * lr_scale)
            loss = F.cross_entropy(model(xr[idx], xf[idx]), y[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if group is not None:  # the gradients' mean over dp
                grads = [p.grad for p in model.parameters()]
                for g, mean in zip(grads, mean_over(grads, group, dp)):
                    g.copy_(mean)
            opt.step()
            ep += loss.detach()
            step += 1
        if group is not None:  # the sum of the steps' global batch means
            ep = mean_over([ep], group, dp)[0]
        ep = float(ep)  # one host synchronization an epoch
        losses.append(ep)
        if scheduler == "reducelronplateau":
            if ep < plateau_best - 1e-4:
                plateau_best, plateau_wait = ep, 0
            else:
                plateau_wait += 1
                if plateau_wait >= PLATEAU_PATIENCE:
                    # torch ReduceLROnPlateau keeps the optimizer's moments
                    lr_scale = max(lr_scale * PLATEAU_FACTOR, min_lr / lr)
                    plateau_wait = 0
                    log.info("plateau: lr -> %.2e", lr * lr_scale)
        if metrics is not None:
            metrics.log(epoch, train_loss=ep)
        if (epoch + 1) % 10 == 0:
            log.info("epoch %d loss %.4f", epoch + 1, ep)
    return model, losses


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    init_distributed(args.device)  # a launcher's group, if any, before anything else
    if args.dp > world_size():
        p.error(f"--dp {args.dp}: the world holds {world_size()} rank(s), one GPU each "
                "(start them with torchrun --nproc_per_node)")
    device = resolve_device(args.device)
    mesh = None
    if args.dp >= 1:
        mesh = make_mesh(dp=args.dp, device=device, leave_idle=True)
        if not mesh.active:
            log.warning("rank %d idle: the mesh holds the first %d of %d ranks", rank(),
                        args.dp, world_size())
            return None
        device = mesh.device
        log.info("mesh: dp=%d on %s", args.dp, device)
    elif rank():
        return None  # a launcher's world without --dp: rank 0 trains alone

    raw_sw = load_array(os.path.join(args.raw_dir, f"sub{args.sub}.npy"))
    de_sw = load_array(os.path.join(args.de_dir, f"sub{args.sub}.npy"))
    data, stats = prepare_glmnet_data(raw_sw, de_sw, list(range(6)), 6)
    host0 = is_host0()
    if host0:
        os.makedirs(args.save_path, exist_ok=True)
        np.savez(os.path.join(args.save_path, "norm_stats.npz"), **stats)

    metrics = MetricsLogger(args.save_path, run_name="glmnet") if host0 else None
    model, _ = train_glmnet(data["train"], emb_dim=args.emb_dim, epochs=args.epochs,
                            batch_size=args.batch_size, lr=args.lr, min_lr=args.min_lr,
                            scheduler=args.scheduler, seed=args.seed, device=device,
                            metrics=metrics, mesh=mesh)
    if not host0:
        return None
    metrics.close()
    save_train_state(os.path.join(args.save_path, "ckpt"), args.epochs, model)

    # the held-out accuracy on rank 0 (JAX: eval is single-device everywhere)
    model.eval()
    xr_t, xf_t, y_t = data["test"]
    with torch.no_grad():
        logits = model(torch.as_tensor(xr_t, device=device), torch.as_tensor(xf_t, device=device))
    acc = float((logits.argmax(-1).cpu().numpy() == y_t).mean())
    log.info("block-6 top-1: %.3f; saved to %s", acc, args.save_path)
    return acc


if __name__ == "__main__":
    main()
