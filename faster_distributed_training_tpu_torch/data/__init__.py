"""Data pipeline of the port: bucketing, the host batch loader, the
synthetic AG-News-shaped dataset, and the LM corpus pipeline (``text``,
``wordpiece``, the ``stream`` format, reader and shard writer).  The real
AG News CSV reader comes when the data is in the repository."""
