"""Paged-KV-cache decode serving for the LM.

Port of ``faster_distributed_training_tpu/serve/decode/``, layered like
the classifier ``serve/`` stack it extends:

  * :mod:`cache`     — PagedKVCache: the device K/V tensors and the host
    slot table (lengths, tokens, request ids, free slots);
  * :mod:`engine`    — DecodeEngine: prefill per bucket, and on the card
    one CUDA graph a page count for the decode step;
  * :mod:`scheduler` — DecodeScheduler: the slot-granular continuous
    batching loop (admit between steps, reclaim on finish);
  * :mod:`frontend`  — the multi-process front door: a worker process a
    replica behind a length-framed JSON socket, detached and respawned
    across process death (its entry point, :mod:`worker`, is not
    imported here).
"""

from faster_distributed_training_tpu_torch.serve.decode.cache import (  # noqa: F401
    PagedKVCache)
from faster_distributed_training_tpu_torch.serve.decode.engine import (  # noqa: F401
    DecodeEngine)
from faster_distributed_training_tpu_torch.serve.decode.frontend import (  # noqa: F401
    FrontDoor, GenScheduler, ProcReplica, WorkerClient)
from faster_distributed_training_tpu_torch.serve.decode.scheduler import (  # noqa: F401
    DecodeScheduler)

__all__ = ["PagedKVCache", "DecodeEngine", "DecodeScheduler", "FrontDoor",
           "GenScheduler", "ProcReplica", "WorkerClient"]
