"""CLI: 500 ms sliding windows over 2 s segments -> (7, 40, 5, 7, 62, 100).

Counterpart of ``eeg2video_tpu/cli/segment_sliding_window.py``, the contract of
reference EEG_preprocessing/segment_sliding_window.py:24-57: one gather
(``dsp.sliding_windows``) a file, on the host. A float64 file's values go
through float32 on the way, as they do in the JAX CLI (its gather is a jnp
array, float32 with x64 off); the output keeps the file's dtype.
"""

import argparse
import os

import numpy as np

from ..data.io import as_jax_float, save_array
from ..dsp import sliding_windows
from ..utils import get_logger

log = get_logger(__name__)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input_dir", default="./data/Preprocessing/Segmented_Rawf_200Hz_2s")
    p.add_argument("--output_dir", default=None,
                   help="default: ./data/Preprocessing/Segmented_{win_ms}ms_sw")
    p.add_argument("--win_s", type=float, default=0.5)
    p.add_argument("--step_s", type=float, default=0.25)
    p.add_argument("--fs", type=int, default=200)
    args = p.parse_args(argv)

    out_dir = args.output_dir or f"./data/Preprocessing/Segmented_{int(1000 * args.win_s)}ms_sw"
    for fname in sorted(os.listdir(args.input_dir)):
        if not fname.endswith(".npy"):
            continue
        data = np.load(os.path.join(args.input_dir, fname))
        if data.ndim != 5 or data.shape[-1] != 2 * args.fs:
            log.warning("skipping %s: unexpected shape %s", fname, data.shape)
            continue
        w = sliding_windows(as_jax_float(data), args.win_s, args.step_s, args.fs)
        save_array(os.path.join(out_dir, fname), w.astype(data.dtype))
        log.info("%s -> %s", fname, w.shape)


if __name__ == "__main__":
    main()
