"""Warm model runtimes + request assembly for the serving surface.

Counterpart of ``eeg2video_tpu/serving/runtimes.py``: everything here is
transport-free. The loader builds a warm predict callable once at startup,
``_load_request`` turns one JSON request into arrays + identity metadata, and
the knob policy decides which per-request overrides are admissible. See
``cli/serve.py`` for the protocol.
"""

import os

import numpy as np
import torch

from ..data import meta
from ..data.io import load_array
from ..diffusion import dana as dana_mod
from ..diffusion.pipeline import latents_from_torch_layout
from ..dsp import de_psd
from ..train.semantic import PREDICT_CHUNK, predict_in_chunks, semantic_from_state_dict
from ..train.seq2seq import rollout_latents, windows_from_segments
from ..utils import StandardScaler, get_logger, resolve_device

log = get_logger(__name__)

def make_semantic_predict(apply, device, scaler=None):
    """Wrap a warm ``(chunk, 310) tensor -> (chunk, 77*768) tensor`` model
    into the ``(N, 310) features -> (N, 77*768) embeddings`` callable (numpy
    in and out) that requests go through: optional z-scoring, row padding to
    ``PREDICT_CHUNK``, one dispatch per chunk."""

    def predict(eeg):
        eeg = np.asarray(eeg, np.float32).reshape(-1, meta.N_CHANNELS * meta.N_BANDS)
        if scaler is not None:
            eeg = scaler.transform(eeg)
        return predict_in_chunks(apply, eeg, device, PREDICT_CHUNK)

    return predict


def _load_semantic(args):
    """Load the semantic predictor once at startup, on ``args.device``, and
    return the warm predict callable of ``make_semantic_predict``. With
    ``--semantic_int8`` the weights are quantized once, layer by layer.

    ``--torch_semantic`` reads the reference's eeg_text.py ``.pt``
    (``mlp.0/2/4/6/8`` keys); ``--semantic_ckpt`` reads a ``.pt`` state dict
    in the port's keys (``convert.from_jax.semantic_state_dict_from_jax``
    writes one from a JAX tree)."""
    from ..models.semantic import Int8SemanticPredictor

    device = resolve_device(args.device)
    path = args.torch_semantic or args.semantic_ckpt
    scaler = (StandardScaler.load(args.semantic_scaler)
              if args.semantic_scaler else None)
    if args.semantic_int8:  # the int8 runtime takes the widths of the weights
        apply = Int8SemanticPredictor.from_state_dict(load_semantic_state(path), device)
    else:
        apply = semantic_from_state_dict(load_semantic_state(path, args.hidden), device)
    return make_semantic_predict(apply, device, scaler)


def load_semantic_state(path, hidden=None):
    """The state dict (the port's keys) of a semantic-predictor ``.pt`` in
    either key space (the port's, or the reference's ``mlp.0/2/4/6/8``); its
    width must be ``hidden`` where that is given."""
    from ..convert.export_diffusion import load_torch_state_dict
    from ..models.semantic import semantic_state_dict_from_reference

    sd = semantic_state_dict_from_reference(load_torch_state_dict(
        _torch_file(path, "semantic", "semantic_state_dict_from_jax")))
    if hidden is not None and sd["fc0.weight"].shape[0] != hidden:
        raise ValueError(f"{path}: hidden width {sd['fc0.weight'].shape[0]}, "
                         f"--hidden says {hidden}")
    return sd


def _torch_file(path, what, converter):
    """``path`` must be a torch file: a directory is most likely an orbax
    checkpoint of the JAX package, which the port does not read."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the "
            f"port reads torch files; carry a JAX {what} tree across with "
            f"eeg2video_tpu_torch/convert/from_jax.py ({converter}) "
            "and torch.save the result")
    return path


def make_seq2seq_predict(model, scaler=None, stats=None):
    """Wrap a warm ``Seq2SeqTransformer`` (eval mode, on its device) into the
    ``(N, 7, 62, 100) windows -> (N, F, C, H, W) latents`` callable (numpy in
    and out) that raw requests go through: optional z-scoring with the
    persisted train-split scaler, the rollout in fixed ``ROLLOUT_CHUNK``-row
    dispatches, and un-normalising with the ``--normalize`` latent stats."""

    def predict(windows):
        windows = np.asarray(windows, np.float32)
        if scaler is not None:
            windows = scaler.transform(
                windows.reshape(len(windows), -1)).reshape(windows.shape)
        out = rollout_latents(model, windows)
        if stats is not None:
            out = out * stats["std_z"] + stats["mean_z"]
        return out  # (N, F, C, H, W)

    return predict


def _load_seq2seq(args):
    """Load the Seq2Seq EEG->latent transformer once at startup, on
    ``args.device``, and return the warm predict callable of
    ``make_seq2seq_predict``.

    Serving version of the inference_seq2seq_v2 -> add_noise ->
    inference_eeg2video file chain: requests carry raw EEG instead of
    precomputed latent artifacts. ``--torch_seq2seq`` reads the reference's
    myTransformer ``.pt``; ``--seq2seq_ckpt`` reads a ``.pt`` state dict in the
    same keys (``convert.from_jax.seq2seq_state_dict_from_jax`` writes one
    from a JAX tree)."""
    from ..convert.export_diffusion import load_torch_state_dict
    from ..models.seq2seq import Seq2SeqTransformer

    device = resolve_device(args.device)
    path = _torch_file(args.torch_seq2seq or args.seq2seq_ckpt, "Seq2Seq",
                       "seq2seq_state_dict_from_jax")
    model = Seq2SeqTransformer(
        n_frames=args.seq2seq_frames,
        latent_shape=tuple(int(d) for d in args.seq2seq_latent.split(",")))
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    model = model.to(device).eval().requires_grad_(False)
    scaler = (StandardScaler.load(args.seq2seq_scaler)
              if args.seq2seq_scaler else None)
    stats = np.load(args.seq2seq_stats) if args.seq2seq_stats else None
    return make_seq2seq_predict(model, scaler, stats)


def _latents_from_raw(args, req, raw=None):
    """Raw-EEG request -> channels-last latents, in-process: the warm
    Seq2Seq rollout plus (by default, when flow scores are configured)
    DANA dynamic noising: the reference's FULL-model latent source,
    produced there by three chained scripts + two disk artifacts
    (my_autoregressive_transformer.py:377-387 -> add_noise.py:100-129 ->
    inference_eeg2video.py:66-70); set {"dana": false} for the woDANA
    ablation (Seq2Seq latents straight into the pipeline).

    ``req["raw"]`` accepts the per-subject segmented ``(7, 40, 5, 62, 400)``
    file (GT-label-reordered for ``req["block"]``, default 6, as the latents
    the Seq2Seq was trained against are ordered), a caller-ordered
    ``(N, 62, 400)`` segment stack, or pre-windowed ``(N, 7, 62, 100)``
    arrays.  DANA is applied to the WHOLE decoded set before any ``indices``
    selection (matching the file chain, where the artifact is noised once and
    the generation script slices clips from it); its draws come from a
    ``torch.Generator`` on the server's device seeded by ``dana_seed``."""
    fn = getattr(args, "seq2seq_predict", None)
    if fn is None:
        raise ValueError(
            "server started without --seq2seq_ckpt/--torch_seq2seq: 'raw' "
            "requests are unavailable (send 'latents', or restart serve "
            "with a seq2seq checkpoint)")
    if raw is None:
        raw = np.asarray(load_array(req["raw"]), np.float32)
    block = int(req.get("block", 6))
    whole_subject = raw.ndim == 5
    if whole_subject:  # (7, 40, 5, 62, 400)
        seg = meta.reorder_by_gt(raw[block], block)
        windows = windows_from_segments(
            seg.reshape(-1, *seg.shape[-2:]))
    elif raw.ndim == 3 and raw.shape[-1] == 400:  # (N, 62, 400)
        windows = windows_from_segments(raw)
    elif raw.ndim == 4 and raw.shape[-1] == 100:  # (N, 7, 62, 100)
        windows = raw
    else:
        raise ValueError(f"unrecognized raw EEG shape {raw.shape}")

    lat = fn(windows)  # (N, F, C, H, W)

    flow_path = req.get("flow_scores") or args.flow_scores
    if req.get("dana", flow_path is not None):
        if flow_path is None:
            raise ValueError(
                "request asked for DANA but no flow scores are configured "
                "(pass 'flow_scores' in the request or start serve with "
                "--flow_scores)")
        flow = np.asarray(load_array(flow_path))
        if whole_subject:
            # the (7, 200) shipped table, presentation order: slice the
            # block and reorder labels into class order to match the latents
            if flow.ndim == 2:
                flow = flow[block]
            if flow.size != meta.N_CONCEPTS * meta.N_REPS:
                raise ValueError(
                    f"{flow.size} flow scores, expected "
                    f"{meta.N_CONCEPTS * meta.N_REPS} for a "
                    "whole-subject request")
            labels = flow >= args.dana_threshold
            idx = meta.block_reorder_indices(block)
            labels = labels.reshape(meta.N_CONCEPTS, meta.N_REPS)[idx]
            labels = labels.reshape(-1)
        else:
            # caller-ordered segments: scores are positional, used as-is
            labels = (flow.reshape(-1) >= args.dana_threshold)
        if len(labels) != len(lat):
            raise ValueError(f"{len(labels)} flow scores for "
                             f"{len(lat)} clips")
        betas = np.where(labels, dana_mod.BETA_FAST,
                         dana_mod.BETA_SLOW).astype(np.float32)
        device = resolve_device(args.device)
        gen = torch.Generator(device=device).manual_seed(
            int(req.get("dana_seed", args.dana_seed)))
        lat = dana_mod.dana_add_noise(
            gen, torch.from_numpy(lat).to(device), betas,
            time_steps=args.dana_time_steps).cpu().numpy()
    # the rollout layout is known (B, F, C, H, W) -> channels-last directly
    # (no latents_from_torch_layout shape heuristics at tiny test shapes)
    return np.transpose(lat, (0, 1, 3, 4, 2))


def _features_from_raw(args, req, raw):
    """2 s raw EEG segments -> DE features -> semantic embeddings, all
    in-process: the extract_de_psd_features --mode 1per2s stage
    (``dsp.de_psd`` on the server's device) chained into the warm semantic
    predictor.  With this, a request carrying ONLY ``raw`` drives both
    conditioning and (with --seq2seq_ckpt) latents."""
    fn = getattr(args, "semantic_predict", None)
    if fn is None:
        raise ValueError(
            "server started without --semantic_ckpt/--torch_semantic: "
            "deriving embeddings from 'raw' needs the semantic predictor "
            "(send 'embeddings'/'features', or restart serve with a "
            "semantic checkpoint)")
    if raw.ndim == 5:  # (7, 40, 5, 62, 400)
        block = int(req.get("block", 6))
        seg = meta.reorder_by_gt(raw[block], block)
    elif raw.ndim == 3 and raw.shape[-1] == 2 * meta.FS:  # (N, 62, 400)
        seg = raw
    else:
        raise ValueError(
            f"deriving DE features needs 2 s raw segments (..., 62, 400), "
            f"got {raw.shape} (pre-windowed 'raw' arrays can only feed the "
            f"latent branch — send 'features' or 'embeddings' alongside)")
    de, _ = de_psd(seg, device=args.device)
    return fn(de.cpu().numpy().reshape(-1, meta.N_CHANNELS * meta.N_BANDS))


def _encode_features(args, req):
    """EEG DE features -> semantic embeddings, in-process (the reference
    chains inference_semantic -> inference_eeg2video via an .npy file on
    disk; here one request carries the features and the warm predictor runs
    before the diffusion dispatch).

    Accepts the per-subject ``(7, 40, 5, 62, 5)`` DE_1per2s file (reordered
    by GT_label for ``block``, reference eeg_text.py:127-134 semantics) or a
    pre-flattened ``(N, 62*5)`` array."""
    fn = getattr(args, "semantic_predict", None)
    if fn is None:
        raise ValueError(
            "server started without --semantic_ckpt/--torch_semantic: "
            "'features' requests are unavailable (send 'embeddings', or "
            "restart serve with a semantic checkpoint)")
    feats = load_array(req["features"])
    if feats.ndim > 2:
        block = int(req.get("block", 6))
        feats = meta.reorder_by_gt(feats[block], block)
    return fn(feats)


def _load_request(args, req):
    """Parse one generation request into arrays + identity metadata."""
    _check_request_knobs(args, req)
    raw = (np.asarray(load_array(req["raw"]), np.float32)
           if req.get("raw") else None)  # loaded ONCE for both branches
    if req.get("features"):
        emb = _encode_features(args, req).reshape(-1, 77 * 768)
    elif req.get("embeddings"):
        emb = load_array(req["embeddings"]).reshape(
            -1, 77 * 768).astype(np.float32)
    elif raw is not None:
        emb = _features_from_raw(args, req, raw).reshape(-1, 77 * 768)
    else:
        raise ValueError(
            "request carries none of 'embeddings'/'features'/'raw'")
    if req.get("negative") or args.negative:
        negative = load_array(req.get("negative") or args.negative)
        negative = negative.reshape(-1).astype(np.float32)
    else:
        # reference behavior (inference_eeg2video.py L45): mean over the
        # WHOLE embedding file, computed before index selection so a
        # {"indices": [3]} request uses the same CFG negative as a
        # full-batch request (a subset mean would make a single-clip
        # request's negative equal its own embedding, cancelling guidance)
        negative = emb.mean(axis=0)
    idx = req.get("indices")
    if idx is not None:
        emb = emb[np.asarray(idx, np.int64)]
    latents = None
    # raw implies Seq2Seq latents unless {"seq2seq": false} opts into the
    # woSeq2Seq ablation (noise latents), e.g. on a semantic-only server
    if raw is not None and req.get("seq2seq", True):
        if req.get("latents"):
            raise ValueError(
                "request carries both 'raw' and 'latents' with seq2seq "
                "enabled — ambiguous latent source: drop 'latents' to "
                "roll them out from raw, or send {'seq2seq': false} to "
                "use the provided latents with raw-derived conditioning")
        latents = _latents_from_raw(args, req, raw)
    elif req.get("latents"):
        latents = latents_from_torch_layout(
            load_array(req["latents"]),
            frames=req.get("video_length", args.video_length))
    if latents is not None and idx is not None:
        latents = latents[np.asarray(idx, np.int64)]
    return {
        "emb": emb, "negative": negative, "latents": latents,
        "names": list(idx) if idx is not None else list(range(len(emb))),
        "out_dir": req.get("out_dir") or args.out_dir,
        "seed": int(req.get("seed", args.seed)),
    }


_KNOBS = ("num_inference_steps", "guidance_scale", "height", "width",
          "video_length", "sampler", "gif_encoder")

# Knobs that change the shape or structure of the device work. The JAX
# server compiles a new graph for each new value; the port runs eagerly, but
# a new shape still allocates anew and a larger one can exhaust the card for
# every client, so the policy is kept. guidance_scale is a scalar and
# gif_encoder is host-side; they stay per-request.
_COMPILE_KNOBS = ("num_inference_steps", "height", "width",
                  "video_length", "sampler")


def _check_request_knobs(args, req):
    """Reject per-request shape overrides unless the operator opted in with
    --allow_request_knobs. Sending a knob whose value equals the server's is
    always fine."""
    if getattr(args, "allow_request_knobs", False):
        return
    bad = [k for k in _COMPILE_KNOBS
           if k in req and req[k] != getattr(args, k)]
    if bad:
        raise ValueError(
            f"request overrides compile-shape knobs {bad} but the server "
            "was started without --allow_request_knobs (each new value "
            "changes the device work for every other client)")


def _knob_key(args, req):
    """Resolved generation knobs: requests batch together iff these match (a
    dispatch has one guidance value and one shape)."""
    return tuple(req.get(k, getattr(args, k)) for k in _KNOBS)
