"""One-time data preparation: GloVe name embeddings, the predicate
frequency-bias matrix, soft classemes.

Counterpart of the JAX package's ``tools/prepare_data.py`` (capability-parity
with the reference's tools_draft/ scripts), through the port's
``data/prepare.py``.  Run as

    python -m vidsgg_big_tpu_torch.tools.prepare_data \\
        --glove_path glove.6B.300d.txt --output_dir prepared_data \\
        [--cfg_path experiments/exp2/config_.py --dataset_type vidvrd] \\
        [--logits_dir LOGITS --classeme_out_dir classeme]

``--glove_path`` writes the five name tables (``vidvrd_EntiNameEmb.npy``,
``vidvrd_EntiNameEmb_pku.npy``, ``vidvrd_PredNameEmb.npy``,
``vidor_EntiNameEmb.npy``, ``vidor_PredNameEmb.npy``); ``--cfg_path``
counts the triplets of its ``train_dataset_config`` split into
``pred_bias_matrix_{vidvrd,vidvrd_pku,vidor}.npy`` (``--synthetic N
--synthetic_root DIR`` writes that split first); ``--logits_dir`` turns
detector logits into soft classemes with the VidOR entity table.  Runs on
the host.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import prepare
from ..utils import categories as cats
from ..utils.config import parse_config_py
from .common import make_dataset

NAME_TABLES = (
    ("vidvrd_EntiNameEmb.npy", cats.VIDVRD_ENTITIES),
    ("vidvrd_EntiNameEmb_pku.npy", cats.PKU_VIDVRD_ENTITIES),
    ("vidvrd_PredNameEmb.npy", cats.VIDVRD_PREDICATES),
    ("vidor_EntiNameEmb.npy", cats.VIDOR_ENTITIES),
    ("vidor_PredNameEmb.npy", cats.VIDOR_PREDICATES),
)


def main(argv=None) -> list:
    """Write what the flags ask for; returns the paths written."""
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    written = []
    if args.glove_path:
        glove = prepare.load_glove(args.glove_path)
        for fname, names in NAME_TABLES:
            emb = prepare.build_name_embeddings(names, glove)
            written.append(os.path.join(args.output_dir, fname))
            np.save(written[-1], emb)
            print(f"saved {fname} {emb.shape}")

    if args.cfg_path:
        all_cfgs = parse_config_py(args.cfg_path)
        dataset, _ = make_dataset(all_cfgs["train_dataset_config"],
                                  args.dataset_type,
                                  synthetic=args.synthetic,
                                  synthetic_root=args.synthetic_root)
        if args.dataset_type == "vidvrd":
            e_i2n, p_i2n = cats.vidvrd_CatId2name, cats.vidvrd_PredId2name
            e_n2i, p_n2i = ((cats.PKU_vidvrd_CatName2Id,
                             cats.vidvrd_PredName2Id) if args.use_pku else
                            (cats.vidvrd_CatName2Id, cats.vidvrd_PredName2Id))
            tag = "vidvrd_pku" if args.use_pku else "vidvrd"
        else:
            e_i2n, p_i2n = cats.vidor_CatId2name, cats.vidor_PredId2name
            e_n2i, p_n2i = cats.vidor_CatName2Id, cats.vidor_PredName2Id
            tag = "vidor"
        gts = [it[-1] for it in dataset]
        trips = prepare.collect_triplet_names(gts, e_i2n, p_i2n)
        bias = prepare.build_bias_matrix(trips, e_n2i, p_n2i)
        written.append(os.path.join(args.output_dir,
                                    f"pred_bias_matrix_{tag}.npy"))
        np.save(written[-1], bias)
        print(f"saved {written[-1]} {bias.shape}")

    if args.logits_dir:
        # detector logits -> soft classeme (needs the VidOR entity table)
        emb = np.load(os.path.join(args.output_dir, "vidor_EntiNameEmb.npy"))
        os.makedirs(args.classeme_out_dir, exist_ok=True)
        for fname in sorted(os.listdir(args.logits_dir)):
            logits = np.load(os.path.join(args.logits_dir, fname))
            clsme = prepare.extract_classeme(logits, emb[1:])
            out = fname.split(".")[0].split("logits")[0] + "clsme.npy"
            written.append(os.path.join(args.classeme_out_dir, out))
            np.save(written[-1], clsme)
        print(f"classemes written to {args.classeme_out_dir}")
    return written


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--output_dir", type=str, default="prepared_data")
    parser.add_argument("--glove_path", type=str, default=None)
    parser.add_argument("--cfg_path", type=str, default=None)
    parser.add_argument("--dataset_type", type=str, default="vidvrd",
                        choices=("vidvrd", "vidor"))
    parser.add_argument("--use_pku", action="store_true")
    parser.add_argument("--logits_dir", type=str, default=None)
    parser.add_argument("--classeme_out_dir", type=str, default="classeme")
    parser.add_argument("--synthetic", type=int, default=0)
    parser.add_argument("--synthetic_root", type=str, default=None)
    return parser.parse_args(argv)


if __name__ == "__main__":
    main()
