"""Semantic-predictor trainer and predictors on one GPU (reference
EEG2Video_New/Semantic/eeg_text.py:108-175; the legacy data plumbing of
EEG2Video/models/train_semantic_predictor.py).

Counterpart of ``eeg2video_tpu/train/semantic.py``. The recipe: MSE to CLIP
text embeddings, Adam 5e-4 on a cosine decay over ``epochs * ceil(n / bs)``
steps (an epoch runs ``n // bs`` batches, so the schedule never reaches its
end, as in JAX), 200 epochs, batch 32, z-scored DE features; each epoch
shuffles with ``np.random.default_rng(seed).permutation(n)``.

Across GPUs (JAX :82-237), one process a GPU, ``tp`` and ``pp`` exclusive:

- ``tp``: Megatron splits over a (dp 1, tp) mesh of the whole world, by JAX's
  ``semantic_sharding_rules`` (``semantic_tp_rules``): fc0, fc2 and out by
  columns, each with its bias; fc1 and fc3 by rows, their biases added once
  after the reduce; any further hidden layer whole. A width that tp does not
  divide is refused by name (``shard_params``), where JAX's placement fails;
- ``pp``: the hidden stack fc1..fc{n-1} in ``pp`` stages of consecutive
  layers, one a rank of the world's first ``pp`` ranks
  (``parallel.gpipe_apply``, ``n_micro`` microbatches), fc0 whole on every
  stage, the out head column-split over the stages where ``out_dim``
  divides (JAX :163), else whole; the other ranks idle;
- under a column-split head the loss is JAX's mean over the whole output:
  each rank's share over its columns, the shares summed over the group;
- 8-bit Adam's row maxima run along torch's dim 0, JAX's out axis, which a
  column split divides: those leaves reduce them over the split's group
  (``Adam8bit.row_groups``);
- initialization and shuffles draw as on one GPU, on every rank, and the
  result is the whole standard state dict on every rank of the mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..data import meta
from ..models.init import lecun_init_
from ..models.semantic import (CLIP_DIM, CLIP_TOKENS, HIDDEN, Int8SemanticPredictor,
                               SemanticPredictor, layer_names)
from ..parallel import (copy_to, gpipe_apply, init_distributed, make_mesh, reduce_from,
                        shard_params, tp_spec)
from ..parallel.distributed import backend_for, rank, world_size
from ..parallel.mesh import gather_pieces, split_piece
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


def semantic_tp_rules(name):
    """JAX's ``semantic_sharding_rules`` (models/semantic.py:41-60 there) on
    the port's names, for ``parallel.shard_params``: ``(dim, "tp")``, or None
    for a leaf kept whole. torch's weight is (out, in), so a column split is
    dim 0."""
    layer, _, leaf = name.rpartition(".")
    col = {"fc0": True, "fc1": False, "fc2": True, "fc3": False, "out": True}.get(layer)
    if col is None:
        return None
    if leaf == "weight":
        return (0 if col else 1, "tp")
    return (0, "tp") if col else None


def _tp_forward(model, x, mesh):
    """The MLP on this rank's tp shards (``semantic_tp_rules``): a column
    split takes a whole input and leaves its output split, a row split takes
    the split one and reduces; the output is this rank's columns of the head
    where tp > 1."""
    group = mesh.group("tp")
    x = x.reshape(x.shape[0], -1)
    for name in layer_names(model.n_hidden):
        lin = getattr(model, name)
        spec = tp_spec(model, f"{name}.weight")
        if spec is None:
            x = lin(x)
        elif spec[0] == 0:
            x = lin(copy_to(x, group))
        else:
            x = reduce_from(F.linear(x, lin.weight), group) + lin.bias
        if name != "out":
            x = F.relu(x)
    return x


def _stage_fn(layers, a):
    """One pipeline stage: its consecutive Linear + ReLU hidden layers."""
    for lin in layers:
        a = F.relu(lin(a))
    return a


def micro_batches(n_micro: int, batch: int) -> int:
    """JAX's microbatch count (:173-177): at most the batch, lowered to the
    largest divisor of the batch that is no larger."""
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    n_micro = min(n_micro, batch)
    while batch % n_micro:
        n_micro -= 1
    return n_micro


def _pp_setup(model, pp, device):
    """This rank's part of a pp-stage pipeline over the world's first pp
    ranks (a world of at least pp processes): (group, stage index or None on
    an idle rank, the stage's layers, whether the head is column-split).
    Frees the other stages' weights and slices the head. Every rank of the
    world calls it."""
    n_middle = model.n_hidden - 1
    if n_middle % pp:
        raise ValueError(f"pp={pp} must divide the {n_middle}-layer hidden stack")
    backend = backend_for(device)
    if dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, but a pipeline on "
                         f"{torch.device(device).type} needs {backend}")
    group = dist.new_group(list(range(pp)))
    if rank() >= pp:
        return group, None, [], False
    idx, k = rank(), n_middle // pp
    mine = range(1 + idx * k, 1 + (idx + 1) * k)
    for i in range(1, model.n_hidden):
        if i not in mine:
            for p in getattr(model, f"fc{i}").parameters():
                p.data = p.data.new_empty(0)
    split = model.out.weight.shape[0] % pp == 0
    if split:
        for p in model.out.parameters():
            p.data = split_piece(p.data, pp, idx, 0)
    return group, idx, [getattr(model, f"fc{i}") for i in mine], split


def _pp_state_dict(model, group, pp, split):
    """The whole standard state dict from the stages (JAX's
    ``_unstack_middle``): each hidden layer broadcast from its stage, the
    head's columns gathered."""
    k = (model.n_hidden - 1) // pp
    hidden = model.fc0.weight.shape[0]  # fc0 is whole on every stage
    sd = {}
    for name in layer_names(model.n_hidden):
        for leaf in ("weight", "bias"):
            t = getattr(getattr(model, name), leaf).detach()
            if name == "out" and split:
                t = gather_pieces(t, group, pp, 0)
            elif name not in ("fc0", "out"):
                owner = (int(name[2:]) - 1) // k
                if owner != rank():
                    shape = (hidden, hidden) if leaf == "weight" else (hidden,)
                    t = torch.empty(shape, device=t.device)
                t = t.contiguous()
                dist.broadcast(t, dist.get_global_rank(group, owner), group=group)
            sd[f"{name}.{leaf}"] = t
    return sd


def train_semantic(eeg, text, cfg: SemanticTrainConfig = SemanticTrainConfig(), seed: int = 0,
                   tp: int = 1, pp: int = 1, n_micro: int = 8, model=None, device="cuda",
                   on_step=None, mesh=None):
    """Train the semantic MLP on (N, 310) features and (N, out_dim) targets;
    returns ``(state_dict, losses)``: the trained ``SemanticPredictor``'s
    whole state dict (on ``device``) and each epoch's loss summed over its
    batches. A rank that a pipeline or a mesh leaves idle returns ``(None,
    [])``.

    ``model``: a built ``SemanticPredictor`` to start from (it is moved to
    ``device``); by default one at ``cfg.hidden`` / ``cfg.out_dim`` with
    flax's default initializers, drawn from ``seed``. ``tp`` > 1 trains on a
    (dp 1, tp) mesh of the whole world; ``mesh`` (from
    ``parallel.make_mesh``, dp and sp 1; with ``leave_idle`` the ranks past
    it return ``(None, [])``) takes that branch at its tp, 1 included.
    ``pp`` > 1 pipelines the hidden stack, ``n_micro`` microbatches a step
    (ignored at pp 1). ``on_step(step, loss, optimizer)`` is called after
    every step, with the whole loss."""
    if tp > 1 and pp > 1:
        raise ValueError("tp and pp are alternative shardings; pick one")
    device = resolve_device(device)
    if pp > 1:  # the world must hold the stages before a model is built
        init_distributed(device)
        if world_size() < pp:
            raise ValueError(f"pp={pp} needs {pp} processes, one a GPU; the world has "
                             f"{world_size()}")
    elif tp > 1 and mesh is None:
        init_distributed(device)
        mesh = make_mesh(dp=1, tp=tp, device=device)
    if mesh is not None and not mesh.active:
        return None, []
    if model is None:
        with torch.device("meta"):
            model = SemanticPredictor(hidden=cfg.hidden, out_dim=cfg.out_dim,
                                      in_dim=eeg.shape[-1])
        model = lecun_init_(model.to_empty(device=device),
                            torch.Generator(device=device).manual_seed(seed))
    model = model.to(device).train()

    bs = cfg.batch_size
    forward, group, split, specs = model, None, False, {}
    params, row_groups = list(model.parameters()), {}
    if pp > 1:
        n_micro = micro_batches(n_micro, bs)
        group, idx, stage, split = _pp_setup(model, pp, device)
        if idx is None:
            return None, []
        params = [p for lin in (model.fc0, *stage, model.out) for p in lin.parameters()]
        if split:  # the head's 8-bit scale rows run across its split columns
            row_groups = {p: (group,) for p in model.out.parameters()}

        def forward(x):
            h = F.relu(model.fc0(x.reshape(x.shape[0], -1)))
            return model.out(gpipe_apply(_stage_fn, stage, h, group, n_micro, out_split=split))
    elif mesh is not None:
        if mesh.size("dp") != 1 or mesh.size("sp") != 1:
            raise ValueError(f"the semantic trainer's mesh is (dp 1, tp); got {mesh!r}")
        if mesh.size("tp") > 1 and model.n_hidden in (1, 3):
            # the column-split fc0 / fc2 would feed the column-split head; JAX's
            # trainer builds the four-layer stack only
            raise ValueError(f"tp needs a hidden stack of 2 or at least 4 layers, got "
                             f"{model.n_hidden}")
        shard_params(model, mesh, semantic_tp_rules)
        group = mesh.group("tp")
        split = group is not None  # the head is column-split
        specs = {name: tp_spec(model, name) for name, _ in model.named_parameters()}
        row_groups = {p: (group,) for name, p in model.named_parameters()
                      if specs[name] is not None and specs[name][0] == 0}
        forward = lambda x: _tp_forward(model, x, mesh)  # noqa: E731
    size = 1 if group is None else dist.get_world_size(group)

    n = len(eeg)
    steps_per_epoch = int(np.ceil(n / bs))
    sched = cosine_decay_schedule(cfg.lr, cfg.epochs * steps_per_epoch)
    if cfg.use_8bit_adam:
        opt = Adam8bit(params, lr=sched(0))
        opt.row_groups = row_groups
    else:
        opt = torch.optim.Adam(params, lr=sched(0))
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
            pred, y = forward(x_all[idx]), y_all[idx]
            if split:  # this rank's columns' share of JAX's mean over the whole output
                y = y.chunk(size, -1)[dist.get_rank(group)]
                loss = ((pred - y) ** 2).sum() / (bs * y_all.shape[-1])
                whole = loss.detach().clone()
                dist.all_reduce(whole, group=group)
            else:
                loss = torch.mean((pred - y) ** 2)
                whole = loss.detach()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep_loss += whole
            step += 1
            if on_step is not None:
                on_step(step, whole, opt)
        losses.append(float(ep_loss))  # one host synchronization an epoch
        if (epoch + 1) % 10 == 0:
            log.info("semantic epoch %d loss %.5f", epoch + 1, losses[-1])
    if pp > 1:
        sd = _pp_state_dict(model, group, pp, split)
    else:
        sd = {name: p.detach() if specs.get(name) is None
              else gather_pieces(p.detach(), group, size, specs[name][0])
              for name, p in model.named_parameters()}
    return sd, losses


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
