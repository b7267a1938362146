"""Shard a corpus or an image split into the stream format.

    python -m faster_distributed_training_tpu_torch.data.stream.shard \\
        --out /tmp/lm_corpus --source synthetic --seq_len 8192
    python -m faster_distributed_training_tpu_torch.data.stream.shard \\
        --out /tmp/cifar_stream --kind image --source cifar10

The port's copy of the JAX package's ``scripts/shard_dataset.py``, with
its flags and defaults.  Text (``--kind text``, the LM workload): the
corpus is cleaned, tokenized through the ladder of ``data.text`` (a real
vocab.txt, else a WordPiece vocab trained on the corpus and cached under
``<data_dir>/ag_news/``, else hashing), split train/test by document and
packed into ``[n, seq_len]`` rows under ``<out>/train`` and
``<out>/test``.  ``--source agnews`` reads
``<data_dir>/ag_news/train.csv`` through ``data.agnews`` (its cleaned
samples and its tokenizer) and falls back to the synthetic corpus when
the CSV is absent.  Images (``--kind image``): the (uint8 NHWC image,
int32 label) pairs of CIFAR-10's pickled batches under ``--data_dir``
(``--source cifar10``) or of ``synthetic_cifar`` (``--source
synthetic``: ``--n`` train images, a quarter of that for test), as they
are.  Then:

    python -m faster_distributed_training_tpu_torch.transformer_test \\
        --dataset stream --stream_dir /tmp/lm_corpus --task lm \\
        --data_path stream
    python -m faster_distributed_training_tpu_torch.resnet50_test \\
        --dataset stream --stream_dir /tmp/cifar_stream --data_path stream
"""

from __future__ import annotations

import argparse
import os


def main(argv=None, log=print) -> dict:
    """Write the dataset; returns ``write_lm_corpus``'s result (text) or
    {split: manifest} (images)."""
    from faster_distributed_training_tpu_torch.data.stream.format import (
        synthetic_corpus, write_array_dataset, write_lm_corpus)

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True,
                   help="output root (train/ + test/ written under it)")
    p.add_argument("--kind", default="text", choices=["text", "image"])
    p.add_argument("--source", default="agnews",
                   help="text: agnews | synthetic; image: cifar10 | "
                        "synthetic")
    p.add_argument("--seq_len", default=256, type=int,
                   help="packed LM row length (text)")
    p.add_argument("--rows_per_shard", default=4096, type=int)
    p.add_argument("--val_fraction", default=0.1, type=float,
                   help="document fraction held out as the test split "
                        "(text)")
    p.add_argument("--data_dir", default="./data",
                   help="where the source corpus and the vocab cache live")
    p.add_argument("--n_docs", default=4096, type=int,
                   help="synthetic text: corpus size in documents")
    p.add_argument("--n", default=8192, type=int,
                   help="synthetic image: train split size")
    p.add_argument("--seed", default=0, type=int)
    args = p.parse_args(argv)

    if args.kind == "text":
        tokenizer, clean = None, True
        if args.source == "agnews":
            from faster_distributed_training_tpu_torch.data.agnews import (
                AGNewsDataset)
            try:
                ds = AGNewsDataset(args.data_dir, train=True)
                # the reader's samples are cleaned already
                texts = [t for t, _ in ds.samples]
                tokenizer, clean = ds.tokenizer, False
            except FileNotFoundError as e:
                log(f"[shard] AG News unavailable ({e}); using the "
                    f"synthetic corpus")
                texts = synthetic_corpus(args.n_docs, seed=args.seed)
        elif args.source == "synthetic":
            texts = synthetic_corpus(args.n_docs, seed=args.seed)
        else:
            raise ValueError(f"--kind text takes --source agnews or "
                             f"synthetic, got {args.source!r}")
        out = write_lm_corpus(args.out, texts, args.seq_len,
                              tokenizer=tokenizer, data_dir=args.data_dir,
                              val_fraction=args.val_fraction,
                              rows_per_shard=args.rows_per_shard,
                              seed=args.seed, clean=clean, log=log)
        log(f"[shard] LM corpus -> {args.out}: "
            f"train {out['train']['n']} x {args.seq_len} rows "
            f"({len(out['train']['shards'])} shard(s)), "
            f"test {out['test']['n']} rows, vocab {out['vocab_size']}")
        return out

    if args.source == "cifar10":
        from faster_distributed_training_tpu_torch.data.cifar10 import (
            load_cifar10)
        splits = {s: load_cifar10(args.data_dir, train=(s == "train"))
                  for s in ("train", "test")}
    elif args.source == "synthetic":
        from faster_distributed_training_tpu_torch.data.synthetic import (
            synthetic_cifar)
        splits = {"train": synthetic_cifar(args.n, seed=args.seed),
                  "test": synthetic_cifar(max(args.n // 4, 1),
                                          seed=args.seed + 1)}
    else:
        raise ValueError(f"--kind image takes --source cifar10 or "
                         f"synthetic, got {args.source!r}")
    out = {}
    for split, (x, y) in splits.items():
        out[split] = write_array_dataset(
            os.path.join(args.out, split), {"image": x, "label": y},
            rows_per_shard=args.rows_per_shard,
            meta={"content": "image", "num_classes": 10, "split": split})
        log(f"[shard] image {split} -> {args.out}/{split}: "
            f"{out[split]['n']} rows, {len(out[split]['shards'])} shard(s)")
    return out


if __name__ == "__main__":
    main()
