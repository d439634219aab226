"""Video-diffusion fine-tune trainer (reference
EEG2Video_New/Generation/train_finetune_videodiffusion.py:66-397) on one GPU
or on a (dp, sp, tp) mesh of GPUs.

Counterpart of ``eeg2video_tpu/train/videodiffusion.py``:

- trainable modules restricted to ("attn1.to_q", "attn2.to_q", "attn_temp")
  (reference L72-76, L142-146): only those parameters require a gradient and
  only they are handed to the optimizer, so frozen weights get no gradient
  buffer and no Adam moments;
- AdamW lr 3e-5, betas (0.9, 0.999), wd 1e-2, eps 1e-8, global-norm clip 1.0
  over the trainable gradients (reference L77-87, L327-328); with
  ``use_8bit_adam`` the AdamW of ``train.optim`` with int8 moments (the
  reference's bitsandbytes AdamW8bit, L163-173);
- gradient accumulation (``gradient_accumulation_steps`` k, JAX
  ``optax.MultiSteps``): every micro step adds its gradient to a running mean,
  ``acc + (g - acc) / (n + 1)``, and every k-th one clips that mean and takes
  the optimizer step; ``step`` counts micro steps, as JAX's does;
- bf16 compute with f32 parameters (the reference's fp16 autocast, L99-102,
  L286): see ``TrainState``;
- gradient checkpointing (reference L154-155): ``remat`` / ``remat_min_hw``
  / ``remat_save_attn``, see ``models.unet3d``;
- the reference's DDP (L99-102, L240-242) becomes JAX's mesh (:42-57,
  :261-345): the batch split over dp, ring attention over sp
  (``attention3d.sp_scope`` open around the forward and the backward),
  Megatron tp, and fsdp of the masters, moments and working copy, each
  unit's weights gathered at its use; see ``TrainState`` and
  ``train_step``.

Training math (reference L288-319): VAE-encode pixels (or take precomputed
posteriors), sample the posterior x 0.18215, draw uniform timesteps and
noise, DDPM q-sample, UNet eps-prediction, f32 MSE. Every random draw comes
from a ``torch.Generator`` seeded from (seed, step), so a resumed run draws
what the uninterrupted one would have; each draw can also be passed in. On a
mesh the draws are the global batch's and each dp rank takes its slice, so
dp = 2 draws what dp = 1 does (JAX's ``fold_in(key, step)`` over the global
batch).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn

from ..diffusion.schedulers import DDPMSchedule
from ..models.attention3d import Transformer3DModel, sp_scope
from ..models.resnet3d import Downsample3D, ResnetBlock3D, Upsample3D
from ..models.vae import SD_VAE_SCALE
from ..parallel.mesh import (PerUseGather, gather_pieces, mean_over, shard_batch,
                             shard_params_fsdp, split_piece, tp_spec)
from ..utils.device import resolve_device
from .optim import Adam8bit, state_bytes, true_div


def trainable(name: str) -> bool:
    """Reference freeze rule (train L142-146) on a parameter name of the
    port's (diffusers) key space: every ``attn_temp`` parameter, and
    ``to_q`` of ``attn1`` and ``attn2``."""
    parts = name.split(".")
    if "attn_temp" in parts:
        return True
    return ("attn1" in parts or "attn2" in parts) and "to_q" in parts


def unet_fsdp_units(unet):
    """The modules whose weights fsdp gathers together where they run: every
    resnet block, transformer and down- or up-sampler; the UNet itself
    gathers the rest (the stem, the time embedding and the head)."""
    kinds = (ResnetBlock3D, Transformer3DModel, Downsample3D, Upsample3D)
    return [m for m in unet.modules() if isinstance(m, kinds)]


def unet_tp_rules(name: str):
    """Megatron tensor parallelism of every attention and feed-forward
    projection (JAX's rules, train/videodiffusion.py:75-86, over the port's
    names, for ``parallel.shard_params``): to_q/k/v and the GEGLU projection
    split by output features (dim 0 of the torch weight; the projection's
    weight and bias by halves, so that each rank keeps the same rows of the
    hidden and the gate half), to_out and the feed-forward's out by input
    features (dim 1); every other parameter, biases of the row splits
    included, whole."""
    parts = name.split(".")
    if parts[-1] == "weight" and parts[-2] in ("to_q", "to_k", "to_v"):
        return (0, "tp")
    if parts[-3:-1] == ["0", "proj"] and "ff" in parts:
        return (0, "tp", 2)
    if parts[-1] == "weight" and (parts[-3:-1] == ["to_out", "0"]
                                  or (parts[-3:-1] == ["net", "2"] and "ff" in parts)):
        return (1, "tp")
    return None


@dataclasses.dataclass(frozen=True)
class VideoDiffusionTrainConfig:
    learning_rate: float = 3e-5
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    weight_decay: float = 1e-2
    adam_eps: float = 1e-8
    max_grad_norm: float = 1.0
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # recompute only blocks whose input has H*W >= this many tokens per frame
    # (0 = everywhere): at 36x64 latents levels 0 and 1 are recomputed and
    # levels 2, 3 and mid keep their (small) activations
    remat_min_hw: int = 256
    # keep the attention, temporal and feed-forward kernels' outputs inside a
    # recomputed block instead of running those forwards again (JAX's
    # remat_save_attn; the model's remat_save_convs stays at its default, True)
    remat_save_attn: bool = True
    # False = the reference freeze rule; True = every parameter trains
    train_all: bool = False
    # micro steps per optimizer step (the running mean of their gradients)
    gradient_accumulation_steps: int = 1
    # int8 Adam moments (train.optim.Adam8bit)
    use_8bit_adam: bool = False


class TrainState:
    """Parameters, optimizer and step of a fine-tune, on one GPU or on a
    (dp, sp, tp) mesh.

    f32 is the stored truth of every parameter. With ``compute_dtype``
    float32 the model's own parameters are that truth. Otherwise the model is
    a working copy in the compute dtype: frozen weights are cast once (their
    f32 originals are kept on the host, untouched, for checkpoints), and each
    trainable parameter has an f32 master on the device that the optimizer
    updates; the working copy is re-cast from it after every step and its
    gradient is carried to the master in f32 (the cast's own backward).

    On a ``mesh`` (``parallel.make_mesh``) the model's tp-split parameters
    (``parallel.shard_params`` with ``unet_tp_rules``, before this state is
    made) hold this rank's tp shard, and so do their masters, frozen
    originals and optimizer moments. Trainable gradients are averaged over dp
    (one flattened all-reduce) and never reduced over sp or tp: the ring's
    and ``copy_to`` / ``reduce_from``'s backwards leave them whole or
    disjoint there. The clip's norm is global (squares summed over the ranks
    that split a tensor, a replicated one counted once).

    With ``fsdp`` the masters (and the kept frozen originals) hold, besides,
    only this rank's dp piece of every tensor that ``parallel.shard_params_fsdp``
    splits, on JAX's dimension (on top of tp's shard), and so do the
    optimizer's moments (AdamW's, or the 8-bit codes and the scales that run
    along a split axis) and the model's own parameters, the working copy in
    the compute dtype, trainable and frozen alike. Each unit
    (``unet_fsdp_units``) gathers its pieces into whole tensors over dp where
    it runs, again in its recomputation or where the backward reads them, and
    frees them after (``parallel.PerUseGather``); a trainable piece's
    gradient is reduce-scattered over dp, averaged, onto its master, and the
    update casts the master pieces into the working pieces. At dp 1 the
    pieces are whole and the same code runs without a collective.

    ``state_dict`` gathers whole tensors in the file layout of one GPU, and
    ``load_state_dict`` slices them back, so a checkpoint moves between
    meshes; on a mesh every rank calls both (they gather)."""

    def __init__(self, unet: nn.Module, cfg: VideoDiffusionTrainConfig, device="cuda",
                 mesh=None, fsdp=False):
        if fsdp and mesh is None:
            raise ValueError("fsdp needs a mesh")
        if mesh is not None and mesh.size("tp") > 1 and getattr(unet, "mesh", None) is not mesh:
            raise ValueError("tp > 1: slice the UNet on this mesh first (parallel.shard_params "
                             "with train.unet_tp_rules)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = getattr(torch, cfg.compute_dtype)
        self.mesh = mesh
        self.step = 0
        named = dict(unet.named_parameters())
        self.trainable_names = [n for n in named if cfg.train_all or trainable(n)]
        chosen = set(self.trainable_names)
        for n, p in named.items():
            if p.dtype != torch.float32:
                raise ValueError(f"{n}: the train state is built from f32 parameters, "
                                 f"got {p.dtype}")
            p.requires_grad_(n in chosen)
        # how each stored f32 tensor is split: tp as the model's parameter
        # (dim, axis, groups), fsdp's dp dim on top of that
        self.tp_specs, self.dp_dims = {}, {}
        if mesh is not None:
            self.tp_specs = {n: spec for n in named
                             if (spec := tp_spec(unet, n)) is not None and mesh.size(spec[1]) > 1}
        keeps_frozen = self.dtype != torch.float32
        self.frozen_f32 = None
        self.gather = None
        if self.dtype == torch.float32 and not fsdp:
            self.unet = unet.to(self.device)
            self.masters = {n: p for n, p in self.unet.named_parameters() if n in chosen}
        else:  # the model's parameters hold their tp shards already
            stored = {n: p.detach() for n, p in named.items()}
            if fsdp:  # fsdp's pieces of them, and the dim of each split
                split = shard_params_fsdp(stored, mesh, self.tp_specs.get)
                stored = {n: piece for n, (piece, _) in split.items()}
                self.dp_dims = {n: dim for n, (_, dim) in split.items() if dim is not None}
                for n in self.dp_dims:  # the working copy holds the pieces too
                    named[n].data = stored[n]
            if keeps_frozen:
                self.frozen_f32 = {n: t.cpu() for n, t in stored.items() if n not in chosen}
            self.masters = {n: nn.Parameter(stored[n].to(self.device, copy=True))
                            for n in self.trainable_names}
            self.unet = unet.to(device=self.device, dtype=self.dtype)
        if fsdp:
            pieces = {}
            for n, p in self.unet.named_parameters():
                if n not in self.dp_dims:
                    continue
                master = self.masters.get(n)
                if master is not None:
                    p.requires_grad_(False)  # its gradient lands on the master
                    if self.dtype == torch.float32:
                        p.data = master.detach()  # the working piece is the master
                pieces[n] = (self.dp_dims[n], master)
            dp = mesh.size("dp")
            self.gather = PerUseGather(self.unet, unet_fsdp_units(self.unet), pieces,
                                       mesh.group("dp") if dp > 1 else None, dp)
        self.working = {n: p for n, p in self.unet.named_parameters() if n in chosen}
        adamw = Adam8bit if cfg.use_8bit_adam else torch.optim.AdamW
        self.optimizer = adamw(
            list(self.masters.values()), lr=cfg.learning_rate,
            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)
        if cfg.use_8bit_adam:  # the 8-bit scales' maxima run over a whole first axis
            for n, master in self.masters.items():
                groups = [self.mesh.group(axis) for axis, dim in self._splits(n) if dim == 0]
                if groups:
                    self.optimizer.row_groups[master] = groups
        # the running mean of the micro steps' gradients and how many it holds
        # (JAX wraps its optimizer in MultiSteps for k > 1 only)
        self.accum = ({n: torch.zeros_like(p) for n, p in self.masters.items()}
                      if cfg.gradient_accumulation_steps > 1 else None)
        self.mini_step = 0

    # --- how the stored tensors are split over the mesh --------------------

    def _splits(self, n):
        """The live splits of stored tensor ``n``: [(axis, dim)], tp's first."""
        out = []
        if n in self.tp_specs:
            out.append((self.tp_specs[n][1], self.tp_specs[n][0]))
        if n in self.dp_dims and self.mesh.size("dp") > 1:
            out.append(("dp", self.dp_dims[n]))
        return out

    def _gathered(self, n):
        """Whether parameter n's gradient reaches its master through the
        per-use gather (fsdp), not through the working copy's ``grad``."""
        return self.gather is not None and n in self.dp_dims

    def _dp_piece(self, n, t, rows=True):
        """This rank's fsdp piece of ``t`` (parameter n's tp shard, or a
        tensor shaped as it); ``rows`` False keeps a split of the first axis
        out (the 8-bit scales, one a column of that axis)."""
        dim = self.dp_dims.get(n)
        if dim is None or (not rows and dim == 0):
            return t
        return split_piece(t, self.mesh.size("dp"), self.mesh.rank("dp"), dim)

    def _piece(self, n, t, rows=True):
        """This rank's stored piece of the whole tensor ``t`` of parameter n:
        tp's slicing, then fsdp's (``rows`` as for ``_dp_piece``)."""
        if self.mesh is None:
            return t
        spec = self.tp_specs.get(n)
        if spec is not None and (rows or spec[0] != 0):
            axis = spec[1]
            t = split_piece(t, self.mesh.size(axis), self.mesh.rank(axis), spec[0], spec[2])
        return self._dp_piece(n, t, rows)

    def _whole(self, n, t, rows=True):
        """The whole tensor from every rank's ``_piece`` (a collective over
        the groups that split it; host tensors go through the device)."""
        if self.mesh is None:
            return t
        dim = self.dp_dims.get(n)
        if dim is not None and (rows or dim != 0) and self.mesh.size("dp") > 1:
            t = gather_pieces(t.to(self.device), self.mesh.group("dp"), self.mesh.size("dp"), dim)
        spec = self.tp_specs.get(n)
        if spec is not None and (rows or spec[0] != 0):
            axis = spec[1]
            t = gather_pieces(t.to(self.device), self.mesh.group(axis), self.mesh.size(axis),
                              spec[0], spec[2])
        return t

    # --- the step ------------------------------------------------------------

    def _sync_working(self):
        """Re-make the working copy from the masters: a cast of each master
        into its working tensor, both whole or both this rank's fsdp piece
        (nothing where they are one tensor)."""
        with torch.no_grad():
            for n, master in self.masters.items():
                w = self.working[n]
                if w is not master and w.data_ptr() != master.data_ptr():
                    w.copy_(master)

    def _clip_grad_norm(self):
        """Clip the masters' gradients by their global norm: torch's
        ``clip_grad_norm_`` where no master is split; else the squares of
        each tensor's norm summed over the groups that split it, a
        replicated tensor's counted once, and the same factor
        ``max_norm / (norm + 1e-6)``, at most 1."""
        masters = list(self.masters.values())
        axes = [tuple(axis for axis, _ in self._splits(n)) for n in self.masters]
        if not any(axes):
            torch.nn.utils.clip_grad_norm_(masters, self.cfg.max_grad_norm)
            return
        sq = torch.stack([torch.linalg.vector_norm(m.grad, 2.0) for m in masters]) ** 2
        total = torch.zeros((), dtype=sq.dtype, device=sq.device)
        for key in sorted(set(axes)):  # the same order on every rank
            part = sq[[i for i, a in enumerate(axes) if a == key]].sum()
            for axis in key:
                dist.all_reduce(part, group=self.mesh.group(axis))
            total = total + part
        coef = torch.clamp(self.cfg.max_grad_norm / (total.sqrt() + 1e-6), max=1.0)
        for m in masters:
            m.grad.mul_(coef)

    def apply_gradients(self):
        """Take one micro step: average the trainable gradients over dp,
        clip them by their global norm, take one AdamW step on the f32
        masters and refresh the working copy; with gradient accumulation, add
        the gradients to the running mean instead and do that with the mean
        every k-th micro step."""
        if self.gather is not None:
            self.gather.release()
        for n, master in self.masters.items():
            if (master if self._gathered(n) else self.working[n]).grad is None:
                raise RuntimeError(f"{n}: trainable but received no gradient")
        # the gathered ones are on their masters, reduce-scattered over dp already
        whole = [n for n in self.masters if not self._gathered(n)]
        grads = [self.working[n].grad for n in whole]
        dp_group = None if self.mesh is None else self.mesh.group("dp")
        if dp_group is not None and grads:
            grads = mean_over(grads, dp_group, self.mesh.size("dp"))
        for n, g in zip(whole, grads):
            master, w = self.masters[n], self.working[n]
            if master is not w:
                master.grad = self._dp_piece(n, g).float()
                w.grad = None
            else:
                w.grad = g
        self.step += 1
        if self.accum is not None:
            with torch.no_grad():
                for n, master in self.masters.items():
                    acc = self.accum[n]
                    acc.add_(true_div(master.grad - acc, float(self.mini_step + 1)))
                    master.grad = None
            self.mini_step += 1
            if self.mini_step < self.cfg.gradient_accumulation_steps:
                return
            for n, master in self.masters.items():
                master.grad = self.accum[n]
        self._clip_grad_norm()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        if self.accum is not None:
            for acc in self.accum.values():
                acc.zero_()
            self.mini_step = 0
        self._sync_working()

    # --- checkpoints ---------------------------------------------------------

    def params_f32(self):
        """The stored truth: ``{name: f32 tensor on the host}`` in the
        model's key order, whole, frozen entries bit-equal to what was
        loaded. On a mesh every rank calls it (it gathers)."""
        out = {}
        for n, p in self.unet.named_parameters():
            if n in self.masters:
                t = self.masters[n].detach()
            elif self.frozen_f32 is not None:
                t = self.frozen_f32[n]
            else:
                t = p.detach()
            out[n] = self._whole(n, t).cpu()
        return out

    # state entries of an optimizer that are shaped as their parameter; the
    # 8-bit scales run along its first axis; the rest are counts
    _SHAPED, _SCALES = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "mq", "vq"), ("ms", "vs")

    def _map_opt_state(self, opt, convert):
        """An optimizer state dict with ``convert(name, tensor, rows)`` applied
        to each tensor shaped as its parameter (rows True) or its scales
        (rows False)."""
        names = list(self.masters)
        return {"state": {i: {k: convert(names[i], v, k in self._SHAPED)
                              if k in self._SHAPED + self._SCALES else v for k, v in st.items()}
                          for i, st in opt["state"].items()},
                "param_groups": opt["param_groups"]}

    def state_dict(self):
        opt = self.optimizer.state_dict()
        if self.mesh is not None:
            opt = self._map_opt_state(opt, lambda n, v, rows: self._whole(n, v, rows).cpu())
        sd = {"params": self.params_f32(), "opt_state": opt, "step": self.step,
              "trainable": list(self.trainable_names)}
        if self.accum is not None:
            sd["accum"] = {n: self._whole(n, a.detach()).cpu() for n, a in self.accum.items()}
            sd["mini_step"] = self.mini_step
        return sd

    def load_state_dict(self, sd):
        """Restore the trainable parameters, the optimizer state and the
        step from a file of any mesh (whole tensors, sliced here). The frozen
        parameters of ``sd`` must be this state's own: a fine-tune never
        changes them, so a difference means another model."""
        if list(sd["trainable"]) != self.trainable_names:
            raise ValueError("the checkpoint was written under another freeze rule")
        ours = self.params_f32()
        with torch.no_grad():
            for n, p in sd["params"].items():
                if n in self.masters:
                    self.masters[n].copy_(self._piece(n, p))
                elif not torch.equal(ours[n], p):
                    raise ValueError(f"{n}: frozen weight differs from the checkpoint's")
        opt = sd["opt_state"]
        if self.mesh is not None:
            opt = self._map_opt_state(opt, self._piece)
        self.optimizer.load_state_dict(opt)
        self.step = int(sd["step"])
        if self.accum is not None:
            with torch.no_grad():
                for n, a in sd.get("accum", {}).items():
                    self.accum[n].copy_(self._piece(n, a))
            self.mini_step = int(sd.get("mini_step", 0))
        self._sync_working()


    def resident_bytes(self):
        """Bytes this rank holds of the f32 masters and the optimizer's state
        (under fsdp about 1/dp of one GPU's)."""
        return (sum(m.numel() * m.element_size() for m in self.masters.values())
                + state_bytes(self.optimizer))


def init_video_train_state(unet, cfg=VideoDiffusionTrainConfig(), device="cuda", mesh=None,
                           fsdp=False):
    """Train state of ``unet`` (f32 parameters) on ``device``: the card
    unless the caller names the CPU; raises where there is no card. On a
    ``mesh`` (every rank calls it, with the UNet sliced by
    ``parallel.shard_params`` where tp > 1), with ``fsdp`` the masters and
    moments split over dp: see ``TrainState``."""
    return TrainState(unet, cfg, device, mesh=mesh, fsdp=fsdp)


def step_generator(seed: int, step: int, device):
    """The generator of one step's draws, a function of (seed, step) only."""
    return torch.Generator(device=device).manual_seed((int(seed) << 20) + int(step))


def video_loss(unet, vae, pixels, context, cfg, *, generator=None, t=None, noise=None,
               eps=None, ddpm=None, dp=1, rank=0):
    """The fine-tune loss of one batch (videodiffusion.py:180-214 of the JAX
    package). ``pixels`` (B, F, H, W, 3) in [-1, 1], or precomputed
    posteriors (B, F, H/8, W/8, 8), mean || logvar on the channels (see
    ``encode_posteriors``); ``context`` (B, 77, cross_attention_dim).
    ``t``, ``noise`` and the posterior's ``eps`` are the global batch's, dp
    times this one: (dp*B,), (dp*B, F, H/8, W/8, 4) and (dp*B*F, H/8, W/8, 4),
    drawn from ``generator`` unless given, and the batch is slice ``rank`` of
    them (dp 1: the batch is the global one)."""
    dtype = getattr(torch, cfg.compute_dtype)
    ddpm = ddpm or DDPMSchedule.create()
    b, f = pixels.shape[:2]
    dev = pixels.device
    if pixels.shape[-1] == 8:
        mean, logvar = pixels.flatten(0, 1).float().chunk(2, dim=-1)
    else:
        with torch.no_grad():
            mean, logvar = vae.encode(pixels.flatten(0, 1).to(dtype))
    lat = tuple(mean.shape[1:])
    if eps is None:
        eps = torch.randn((dp * b * f, *lat), generator=generator, device=dev)
    z = mean.float() + torch.exp(0.5 * logvar.float()) * eps[rank * b * f:(rank + 1) * b * f]
    latents = (z * SD_VAE_SCALE).reshape(b, f, *lat)
    if t is None:
        t = torch.randint(0, ddpm.num_train_timesteps, (dp * b,), generator=generator,
                          device=dev)
    if noise is None:
        noise = torch.randn((dp * b, f, *lat), generator=generator, device=dev)
    t, noise = t[rank * b:(rank + 1) * b], noise[rank * b:(rank + 1) * b]
    noisy = ddpm.add_noise(latents, noise, t)
    pred = unet(noisy.to(dtype), t, context.to(dtype), train=True, remat=cfg.remat,
                remat_min_hw=cfg.remat_min_hw, remat_save_attn=cfg.remat_save_attn).float()
    return torch.mean((pred - noise) ** 2)


@torch.no_grad()
def encode_posteriors(vae, pixels, batch: int = 8):
    """Precompute VAE posteriors for a clip set: (N, F, H, W, 3) pixels ->
    (N, F, H/8, W/8, 8) f32 ``mean || logvar`` on the VAE's device.

    Feed the result to the train step in place of pixels (the loss
    dispatches on the channel count): one encoder pass per dataset instead of
    one per step, the same training distribution because the posterior's
    parameters are deterministic and its sampling stays in the step. Frames
    go through the encoder one at a time, ``batch`` of them per transfer."""
    p = next(vae.parameters())
    pixels = torch.as_tensor(pixels)
    n, f = pixels.shape[:2]
    flat = pixels.reshape(n * f, *pixels.shape[2:])
    outs = []
    for s in range(0, n * f, batch):
        chunk = flat[s:s + batch].to(p.device, p.dtype)
        for frame in chunk:
            mean, logvar = vae.encode(frame[None])
            outs.append(torch.cat([mean[0].float(), logvar[0].float()], dim=-1))
    post = torch.stack(outs)
    return post.reshape(n, f, *post.shape[1:])


def train_step(state: TrainState, vae, pixels, context, seed, *, t=None, noise=None,
               eps=None):
    """One micro step on one batch (an optimizer step unless gradients
    accumulate); returns the loss (a 0-d tensor on the device, not
    synchronized). The step's draws come from
    ``step_generator(seed, state.step)``, and ``state.step`` counts micro
    steps, so each micro batch draws its own.

    On the state's mesh every rank calls it with its dp slice of the batch
    (``pixels``, ``context``); the draws, drawn or given, are the global
    batch's, of which it takes its slice; the forward and the backward run
    under ``sp_scope(mesh)``; the loss returned is the mean over dp."""
    mesh = state.mesh
    gen = step_generator(seed, state.step, state.device)
    pixels, context = pixels.to(state.device), context.to(state.device)
    dp, rank = (1, 0) if mesh is None else (mesh.size("dp"), mesh.rank("dp"))
    with sp_scope(mesh):  # a no-op without a mesh
        loss = video_loss(state.unet, vae, pixels, context, state.cfg, generator=gen, t=t,
                          noise=noise, eps=eps, dp=dp, rank=rank)
        loss.backward()
    state.apply_gradients()
    loss = loss.detach()
    if mesh is not None and mesh.group("dp") is not None:
        dist.all_reduce(loss, group=mesh.group("dp"))
        loss = true_div(loss, float(mesh.size("dp")))
    return loss


def train_epoch(state: TrainState, vae, pixels_all, context_all, perm, seed, on_step=None):
    """One epoch over ``perm`` (steps, B) integer indices into the resident
    clip set; returns the mean loss (one host synchronization, at the end).
    ``on_step(state, loss)`` is called after every (micro) step. On a mesh
    ``perm`` is the global one, and each rank gathers its dp slice of every
    row."""
    losses = []
    for idx in torch.as_tensor(perm, device=pixels_all.device).long():
        if state.mesh is not None:
            idx = shard_batch(idx, state.mesh)
        losses.append(train_step(state, vae, pixels_all[idx], context_all[idx], seed))
        if on_step is not None:
            on_step(state, losses[-1])
    return float(torch.stack(losses).mean())
