"""The streaming data plane (the JAX package's ``data/stream/``): the
sharded on-disk format (``format.py``), its memory-mapped reader
(``reader.py``), the shard writer (``shard.py``: ``python -m
faster_distributed_training_tpu_torch.data.stream.shard``) and the
device window with its background refill (``window.py``).

``--dataset stream --stream_dir D`` reads a written dataset on any data
path; ``--data_path stream`` keeps the train split on disk and trains
through a fixed window of batches on the card, refilled while the
dispatches train (``build_stream``)."""

import os

from faster_distributed_training_tpu_torch.data.stream.format import (  # noqa: F401,E501
    FORMAT, MANIFEST, pack_lm_rows, synthetic_corpus, write_array_dataset,
    write_lm_corpus, write_stream_dataset)
from faster_distributed_training_tpu_torch.data.stream.reader import (  # noqa: F401,E501
    ShardedStreamDataset, open_stream_split)
from faster_distributed_training_tpu_torch.data.stream.window import (  # noqa: F401,E501
    DiskStreamSource)


def build_stream(cfg, device, dataset=None, process_index: int = 0,
                 process_count: int = 1):
    """None unless ``--data_path stream``; else a ``DiskStreamSource``
    over ``<stream_dir>/train`` on ``device`` (JAX ``build_stream``).
    ``dataset``: the open reader, reused (its mmaps)."""
    if getattr(cfg, "data_path", "host") != "stream":
        return None
    stream_dir = getattr(cfg, "stream_dir", "") or ""
    if not stream_dir:
        raise ValueError("--data_path stream requires --stream_dir (a "
                         "sharded dataset root with train/ + test/; python "
                         "-m faster_distributed_training_tpu_torch.data."
                         "stream.shard writes one)")
    ds = (dataset if isinstance(dataset, ShardedStreamDataset)
          else ShardedStreamDataset(os.path.join(stream_dir, "train")))
    return DiskStreamSource(
        ds, cfg.batch_size, seed=cfg.seed, device=device,
        window_batches=getattr(cfg, "stream_window", 8),
        steps_per_dispatch=getattr(cfg, "steps_per_dispatch", 1),
        max_len=cfg.seq_len, process_index=process_index,
        process_count=process_count)
