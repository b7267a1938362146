"""serve/ — the batched-inference tier of the port.

A request queue with continuous batching into the bucket-padded lengths
(data.loader.select_bucket), a frozen-weight predict step, and
multi-replica dispatch with heartbeat liveness.  Layout:

  * :mod:`queue`      — ServeRequest + RequestQueue;
  * :mod:`engine`     — InferenceEngine, ServingState, pad_batch,
    load_serving_state;
  * :mod:`scheduler`  — BatchScheduler;
  * :mod:`replicas`   — Replica / ReplicaSet.
"""

from faster_distributed_training_tpu_torch.serve.engine import (  # noqa: F401
    InferenceEngine, ServingState, load_serving_state, pad_batch)
from faster_distributed_training_tpu_torch.serve.queue import (  # noqa: F401
    RequestQueue, ServeRequest)
from faster_distributed_training_tpu_torch.serve.replicas import (  # noqa: F401
    Replica, ReplicaSet)
from faster_distributed_training_tpu_torch.serve.scheduler import (  # noqa: F401
    BatchScheduler)

__all__ = ["InferenceEngine", "ServingState", "load_serving_state",
           "pad_batch", "RequestQueue", "ServeRequest", "Replica",
           "ReplicaSet", "BatchScheduler"]
