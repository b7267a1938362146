"""The sharded on-disk dataset format and its host reader (the JAX
package's ``data/stream/``, without the device window).

``shard.py`` writes a corpus (``python -m faster_distributed_training_tpu_
torch.data.stream.shard``); ``--dataset stream --stream_dir D`` reads it
through the host batch loader (``--data_path host``).  The JAX package's
device-resident window with its background refill (``window.py``,
``--data_path stream``) is not ported yet."""

from faster_distributed_training_tpu_torch.data.stream.format import (  # noqa: F401,E501
    FORMAT, MANIFEST, pack_lm_rows, synthetic_corpus, write_array_dataset,
    write_lm_corpus, write_stream_dataset)
from faster_distributed_training_tpu_torch.data.stream.reader import (  # noqa: F401,E501
    ShardedStreamDataset, open_stream_split)
