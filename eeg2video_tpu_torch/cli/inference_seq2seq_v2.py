"""CLI: Seq2Seq inference -> predicted latents
(reference README Seq2Seq inference contract incl. --stats_path restore).

Counterpart of ``eeg2video_tpu/cli/inference_seq2seq_v2.py``: writes the
latent_out_block7_40_classes.npy artifact that ``cli.add_noise`` and
``cli.inference_eeg2video --woDANA`` read. ``--ckpt`` is a ``.pt`` state dict
in the reference's keys (``convert.from_jax.seq2seq_state_dict_from_jax``
writes one from a JAX tree); ``--torch_ckpt`` is the reference's own
seq2seqmodel.pt. ``--device`` defaults to ``cuda``.
"""

import argparse

import numpy as np

from ..convert.export_diffusion import load_torch_state_dict
from ..data import meta
from ..data.io import load_array, save_array
from ..models.seq2seq import Seq2SeqTransformer
from ..serving.runtimes import _torch_file
from ..train.seq2seq import prepare_seq2seq_data, rollout_latents, windows_from_segments
from ..utils import StandardScaler, get_logger, resolve_device

log = get_logger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--eeg", default="./data/Preprocessing/Segmented_Rawf_200Hz_2s/sub1.npy")
    p.add_argument("--train_latents", default="./data/1200_latent.npy",
                   help="needed to refit the EEG scaler exactly as in training")
    p.add_argument("--test_latents", default="./data/40classes_latents.pt")
    p.add_argument("--ckpt", default="./outputs/seq2seq/seq2seq.pt")
    p.add_argument("--torch_ckpt", default=None,
                   help="load a reference seq2seqmodel.pt instead of --ckpt")
    p.add_argument("--stats_path", default=None,
                   help="stats.npz to restore latent scale (--normalize training)")
    p.add_argument("--eeg_scaler", default=None,
                   help="eeg_scaler.npz saved by train_seq2seq_v2: z-score "
                        "the test EEG with the stored train-split stats "
                        "instead of refitting from --train_latents/--eeg "
                        "(no training arrays needed at inference)")
    p.add_argument("--out", default="./outputs/seq2seq/latent_out_block7_40_classes.npy")
    p.add_argument("--device", default="cuda",
                   help="where the model lives: the card by default (fails "
                        "where there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before reading anything

    eeg = load_array(args.eeg)
    if args.eeg_scaler:
        scaler = StandardScaler.load(args.eeg_scaler)
        block = meta.reorder_by_gt(eeg[6], 6).reshape(-1, *eeg.shape[-2:])
        te_eeg = windows_from_segments(block)
        te_eeg = scaler.transform(
            te_eeg.reshape(len(te_eeg), -1)).reshape(te_eeg.shape)
    else:
        tr_lat = load_array(args.train_latents)
        te_lat = load_array(args.test_latents)
        _, _, te_eeg, _, _ = prepare_seq2seq_data(eeg, tr_lat, te_lat)

    path = _torch_file(args.torch_ckpt or args.ckpt, "Seq2Seq", "seq2seq_state_dict_from_jax")
    model = Seq2SeqTransformer()
    model.load_state_dict(load_torch_state_dict(path), strict=True)
    model = model.to(device).eval().requires_grad_(False)

    out = rollout_latents(model, te_eeg)
    if args.stats_path:
        z = np.load(args.stats_path)
        out = out * z["std_z"] + z["mean_z"]
    save_array(args.out, out)
    log.info("predicted latents %s -> %s", out.shape, args.out)


if __name__ == "__main__":
    main()
