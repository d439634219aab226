"""CLI: segment raw SEED-DV EEG into (7, 40, 5, 62, 400) arrays.

Counterpart of ``eeg2video_tpu/cli/segment_raw_signals_200hz.py``, the
contract of reference EEG_preprocessing/segment_raw_signals_200Hz.py (defaults
included): one gather a subject (``dsp.segment_subject``) instead of the triple
Python loop. ``--bandpass LOW HIGH`` first filters the raw signal with the
zero-phase Butterworth bandpass (``dsp.bandpass_filter``: the ``ops.iir``
kernel on the card) in float32, as the JAX CLI computes it (x64 off), and
casts the result back to the file's dtype; without it a float64 file's values
go through float32 too, as the JAX CLI's jnp gather takes them. ``--device`` defaults to ``cuda``; ``cpu`` is
a dry run through the plain version.
"""

import argparse

import numpy as np

from ..data.io import as_jax_float, save_array, subject_files
from ..dsp import bandpass_filter, segment_subject
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--eeg_root", default="./data/EEG")
    p.add_argument("--output_dir", default="./data/Preprocessing/Segmented_Rawf_200Hz_2s")
    p.add_argument("--fs", type=int, default=200)
    p.add_argument("--subs", type=int, nargs="*", default=None)
    p.add_argument(
        "--bandpass", type=float, nargs=2, metavar=("LOW", "HIGH"), default=None,
        help="optional zero-phase Butterworth bandpass (Hz) applied to the "
             "raw signal before segmentation")
    p.add_argument("--bandpass_order", type=int, default=4)
    p.add_argument("--mmap", action="store_true",
                   help="memory-map the raw file instead of loading it "
                        "(reference use_mmap, segment_raw_signals_200Hz.py:47)")
    p.add_argument("--device", default="cuda",
                   help="where the bandpass runs: the card by default (fails where "
                        "there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device) if args.bandpass is not None else None

    for sub, path in subject_files(args.eeg_root, args.subs):
        data = np.load(path, mmap_mode="r" if args.mmap else None)
        x = as_jax_float(data)
        if args.bandpass is not None:
            low, high = args.bandpass
            x = bandpass_filter(x, low, high, fs=args.fs, order=args.bandpass_order,
                                device=device).cpu().numpy()
        segs = segment_subject(x, fs=args.fs)
        out = f"{args.output_dir}/sub{sub}.npy"
        save_array(out, segs.astype(data.dtype))
        log.info("sub%d -> %s %s", sub, out, segs.shape)


if __name__ == "__main__":
    main()
