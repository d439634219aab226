"""CLI: CLIP text embeddings of the BLIP captions -> per-block block{i}.pt,
and the empty prompt's embedding -> negative.npy (float16), the CFG negative
the reference commits (pipeline_tuneavideo.py:230-233).

Counterpart of ``eeg2video_tpu/cli/generate_text_emb.py``, with the same
flags plus ``--device`` (default ``cuda``; ``cpu`` for a dry run). It needs
local files: ``--torch_clip`` a ``transformers.CLIPTextModel`` state dict
(the SD v1.4 text encoder's) and ``--tokenizer`` a ``CLIPTokenizer``
directory; ``transformers`` must be installed for the tokenizer.
``write_text_embeddings`` is the loop over caption files, for callers that
bring their own model and tokenizer."""

import argparse
import os

import numpy as np

from ..data.io import save_array
from ..diffusion.text_pipeline import tokenize
from ..models.clip_text import CLIPTextConfig, CLIPTextModel, encode_ids
from ..train import checkpoint as ckpt
from ..utils import get_logger, resolve_device

log = get_logger(__name__)


def write_text_embeddings(model, tokenizer, captions_dir, out_dir, negative_out,
                          caption_files=None):
    """Encode each caption file (one caption a line; blank lines skipped) into
    ``out_dir/block{i}.pt`` (f32, (n_captions, 77, hidden)), the files taken in
    ``caption_files`` order or sorted by name, then the empty prompt into
    ``negative_out`` as float16. Returns the block files' paths."""
    files = caption_files or sorted(
        f for f in os.listdir(captions_dir) if f.endswith(".txt"))
    written = []
    for i, fname in enumerate(files):
        with open(os.path.join(captions_dir, fname)) as f:
            prompts = [line.strip() for line in f if line.strip()]
        emb = encode_ids(model, tokenize(tokenizer, prompts)).cpu().numpy()
        path = os.path.join(out_dir, f"block{i}.pt")
        save_array(path, emb)
        written.append(path)
        log.info("%s -> block%d.pt %s", fname, i, emb.shape)

    # the unconditional embedding for classifier-free guidance
    neg = encode_ids(model, tokenize(tokenizer, [""])).cpu().numpy()
    save_array(negative_out, neg.astype(np.float16))
    log.info("negative embedding -> %s %s", negative_out, neg.shape)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--captions_dir", default="./data/BLIP",
                   help="dir with {i}st/nd/th_10min.txt caption files")
    p.add_argument("--caption_files", nargs="*", default=None)
    p.add_argument("--torch_clip", required=True,
                   help="local torch CLIPTextModel state dict (.bin/.pt)")
    p.add_argument("--tokenizer", required=True, help="local CLIPTokenizer path")
    p.add_argument("--out_dir", default="./data/Text_embeddings")
    p.add_argument("--negative_out", default="./data/negative.npy")
    p.add_argument("--device", default="cuda",
                   help="where the text encoder runs: the card by default (fails "
                        "where there is none); 'cpu' for a dry run")
    args = p.parse_args(argv)
    device = resolve_device(args.device)  # fail before reading anything

    from transformers import CLIPTokenizer

    tokenizer = CLIPTokenizer.from_pretrained(args.tokenizer)
    model = CLIPTextModel(CLIPTextConfig())
    model.load_state_dict(ckpt.load_torch_state_dict(args.torch_clip), strict=True)
    model = model.to(device).eval()
    return write_text_embeddings(model, tokenizer, args.captions_dir, args.out_dir,
                                 args.negative_out, args.caption_files)


if __name__ == "__main__":
    main()
