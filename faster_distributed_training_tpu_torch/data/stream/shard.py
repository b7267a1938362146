"""Shard a text corpus into the stream format for the next-token LM.

    python -m faster_distributed_training_tpu_torch.data.stream.shard \\
        --out /tmp/lm_corpus --source synthetic --seq_len 8192

The text branch of the JAX package's ``scripts/shard_dataset.py``, with
its flags and defaults: the corpus is cleaned, tokenized through the
ladder of ``data.text`` (a real vocab.txt, else a WordPiece vocab trained
on the corpus and cached under ``<data_dir>/ag_news/``, else hashing),
split train/test by document and packed into ``[n, seq_len]`` rows under
``<out>/train`` and ``<out>/test``.  ``--source agnews`` falls back to the
synthetic corpus while the AG News CSVs are absent, as the JAX script
does; with the CSVs present it raises (the port has no CSV reader yet).
Then:

    python -m faster_distributed_training_tpu_torch.transformer_test \\
        --dataset stream --stream_dir /tmp/lm_corpus --task lm
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, log=print) -> dict:
    """Write the corpus; returns ``write_lm_corpus``'s result."""
    from faster_distributed_training_tpu_torch.data.stream.format import (
        synthetic_corpus, write_lm_corpus)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True,
                   help="output root (train/ + test/ written under it)")
    p.add_argument("--source", default="agnews",
                   choices=["agnews", "synthetic"])
    p.add_argument("--seq_len", default=256, type=int,
                   help="packed LM row length")
    p.add_argument("--rows_per_shard", default=4096, type=int)
    p.add_argument("--val_fraction", default=0.1, type=float,
                   help="document fraction held out as the test split")
    p.add_argument("--data_dir", default="./data",
                   help="where the source corpus and the vocab cache live")
    p.add_argument("--n_docs", default=4096, type=int,
                   help="synthetic text: corpus size in documents")
    p.add_argument("--seed", default=0, type=int)
    args = p.parse_args(argv)

    if args.source == "agnews":
        path = os.path.join(args.data_dir, "ag_news", "train.csv")
        if os.path.isfile(path):
            raise NotImplementedError(
                f"not ported yet: reading the AG News CSV ({path}); use "
                f"--source synthetic")
        log(f"[shard] AG News unavailable (no {path}); using the "
            f"synthetic corpus")
    texts = synthetic_corpus(args.n_docs, seed=args.seed)
    out = write_lm_corpus(args.out, texts, args.seq_len,
                          data_dir=args.data_dir,
                          val_fraction=args.val_fraction,
                          rows_per_shard=args.rows_per_shard,
                          seed=args.seed, log=log)
    log(f"[shard] LM corpus -> {args.out}: "
        f"train {out['train']['n']} x {args.seq_len} rows "
        f"({len(out['train']['shards'])} shard(s)), "
        f"test {out['test']['n']} rows, vocab {out['vocab_size']}")
    return out


if __name__ == "__main__":
    main()
