"""Decode worker process entry point.

``python -m faster_distributed_training_tpu_torch.serve.decode.worker
--cfg <json> --port <p> --name <n> --hb_dir <d>``: a module the package
``__init__`` does not import, so runpy runs it without importing it
twice.  The logic is :func:`frontend.worker_main`.
"""

import sys

from faster_distributed_training_tpu_torch.serve.decode.frontend import (
    worker_main)

if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[1:]))
