"""CLI: DE/PSD band-power features at 2 s / 1 s / 500 ms granularity.

Counterpart of ``eeg2video_tpu/cli/extract_de_psd_features.py``, the contracts
of the three reference scripts (extract_DE_PSD_features_1per2s.py, _1per1s.py
and _1per500ms.py, whose --raw_dir/--de_dir/--psd_dir/--subs interface is kept,
reference :33-39). The default path is the vectorised float64 pass on the host
(``dsp.de_psd_numpy``); ``--f32`` runs the port's ``dsp.de_psd`` on
``--device`` (the card by default).
"""

import argparse

import numpy as np

from ..data.io import save_array, subject_files
from ..dsp import de_psd, de_psd_numpy
from ..utils import get_logger, resolve_device

log = get_logger(__name__)

_MODES = {
    # mode: window seconds
    "1per2s": 2.0,
    "1per1s": 1.0,
    "1per500ms": 0.5,
}


def _windows(segs: np.ndarray, mode: str) -> np.ndarray:
    if mode == "1per2s":
        return segs  # (..., 62, 400)
    if mode == "1per1s":
        # two 1 s halves (reference _1per1s.py:46-47) -> (7,40,5,2,62,200)
        return np.stack([segs[..., :200], segs[..., 200:]], axis=3)
    if mode == "1per500ms":
        # expects pre-windowed Segmented_500ms_sw input (7,40,5,7,62,100)
        return segs
    raise ValueError(mode)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", choices=sorted(_MODES), default="1per2s")
    p.add_argument("--raw_dir", default=None,
                   help="default: Segmented_Rawf_200Hz_2s (2s/1s modes) or "
                        "Segmented_500ms_sw (500ms mode)")
    p.add_argument("--de_dir", default=None)
    p.add_argument("--psd_dir", default=None)
    p.add_argument("--subs", type=int, nargs="*", default=None)
    p.add_argument("--fs", type=int, default=200)
    p.add_argument("--f32", action="store_true",
                   help="use dsp.de_psd on --device instead of the float64 host path")
    p.add_argument("--device", default="cuda",
                   help="where --f32 runs: the card by default; 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device) if args.f32 else None

    if args.raw_dir is None:
        args.raw_dir = ("./data/Preprocessing/Segmented_500ms_sw"
                        if args.mode == "1per500ms"
                        else "./data/Preprocessing/Segmented_Rawf_200Hz_2s")
    de_dir = args.de_dir or f"./data/Preprocessing/DE_{args.mode}"
    psd_dir = args.psd_dir or f"./data/Preprocessing/PSD_{args.mode}"
    win_sec = _MODES[args.mode]

    for sub, path in subject_files(args.raw_dir, args.subs):
        segs = np.load(path)
        w = _windows(segs, args.mode)
        if args.f32:
            de, psd = (t.cpu().numpy() for t in de_psd(w, fs=args.fs, win_sec=win_sec,
                                                        device=device))
        else:
            de, psd = de_psd_numpy(w, args.fs, win_sec)
        save_array(f"{de_dir}/sub{sub}.npy", de.astype(np.float64))
        save_array(f"{psd_dir}/sub{sub}.npy", psd.astype(np.float64))
        log.info("sub%d %s -> de%s", sub, args.mode, de.shape)


if __name__ == "__main__":
    main()
