"""Data pipeline of the port: bucketing, the host batch loader, the
synthetic AG-News-shaped dataset, the AG News CSV reader (``agnews``) and
the LM corpus pipeline (``text``, ``wordpiece``, the ``stream`` format,
reader and shard writer)."""
