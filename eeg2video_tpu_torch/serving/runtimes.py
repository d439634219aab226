"""Warm model runtimes + request assembly for the serving surface.

Counterpart of ``eeg2video_tpu/serving/runtimes.py``: everything here is
transport-free. The loader builds a warm predict callable once at startup,
``_load_request`` turns one JSON request into arrays + identity metadata, and
the knob policy decides which per-request overrides are admissible. Requests
that carry ``raw`` EEG (the Seq2Seq, DANA and DE-feature stages) are not
ported yet and get an error reply. See ``cli/serve.py`` for the protocol.
"""

import os

import numpy as np
import torch

from ..data import meta
from ..data.io import load_array
from ..diffusion.pipeline import latents_from_torch_layout
from ..utils import StandardScaler, get_logger, resolve_device

log = get_logger(__name__)

# Rows per dispatch of the semantic predictor. Requests are zero-padded to a
# multiple of it, so one shape serves every request size: a different batch
# shape may be summed in another order, and that drift can cross a uint8 GIF
# quantization boundary downstream (eeg2video_tpu/train/semantic.py:252-262).
PREDICT_CHUNK = 100


def pad_rows(x, chunk):
    """Zero-pad axis 0 of ``x`` up to a multiple of ``chunk``."""
    pad = (-len(x)) % chunk
    if pad:
        x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    return x


def make_semantic_predict(apply, device, scaler=None):
    """Wrap a warm ``(chunk, 310) tensor -> (chunk, 77*768) tensor`` model
    into the ``(N, 310) features -> (N, 77*768) embeddings`` callable (numpy
    in and out) that requests go through: optional z-scoring, row padding to
    ``PREDICT_CHUNK``, one dispatch per chunk."""

    def predict(eeg):
        eeg = np.asarray(eeg, np.float32).reshape(-1, meta.N_CHANNELS * meta.N_BANDS)
        if scaler is not None:
            eeg = scaler.transform(eeg)
        n = len(eeg)
        eeg = pad_rows(eeg, PREDICT_CHUNK)
        with torch.inference_mode():
            out = np.concatenate([
                apply(torch.from_numpy(eeg[s:s + PREDICT_CHUNK]).to(device)).float().cpu().numpy()
                for s in range(0, len(eeg), PREDICT_CHUNK)])
        return out[:n]

    return predict


def _load_semantic(args):
    """Load the semantic predictor once at startup, on ``args.device``, and
    return the warm predict callable of ``make_semantic_predict``. With
    ``--semantic_int8`` the weights are quantized once, layer by layer.

    ``--torch_semantic`` reads the reference's eeg_text.py ``.pt``
    (``mlp.0/2/4/6/8`` keys); ``--semantic_ckpt`` reads a ``.pt`` state dict
    in the port's keys (``convert.from_jax.semantic_state_dict_from_jax``
    writes one from a JAX tree)."""
    from ..convert.export_diffusion import load_torch_state_dict
    from ..models.semantic import (Int8SemanticPredictor, SemanticPredictor,
                                   semantic_state_dict_from_reference)

    device = resolve_device(args.device)
    path = args.torch_semantic or args.semantic_ckpt
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX package?): the "
            "port reads torch files; carry a JAX tree across with "
            "eeg2video_tpu_torch/convert/from_jax.py (semantic_state_dict_from_jax) "
            "and torch.save the result")
    sd = semantic_state_dict_from_reference(load_torch_state_dict(path))
    scaler = (StandardScaler.load(args.semantic_scaler)
              if args.semantic_scaler else None)
    if args.semantic_int8:
        apply = Int8SemanticPredictor.from_state_dict(sd, device)
    else:
        with torch.device("meta"):
            model = SemanticPredictor(hidden=args.hidden)
        model = model.to_empty(device=device).eval().requires_grad_(False)
        model.load_state_dict(sd, strict=True)
        apply = model
    return make_semantic_predict(apply, device, scaler)


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
    if req.get("raw"):
        raise ValueError(
            "raw-EEG requests (Seq2Seq latents, DANA noising, DE features "
            "from raw segments) are not ported yet: send 'features' or "
            "'embeddings', and 'latents' for a latent artifact")
    if req.get("features"):
        emb = _encode_features(args, req).reshape(-1, 77 * 768)
    elif req.get("embeddings"):
        emb = load_array(req["embeddings"]).reshape(
            -1, 77 * 768).astype(np.float32)
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
    if req.get("latents"):
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
