"""Data pipeline of the port: bucketing, the host batch loader and the
synthetic AG-News-shaped dataset (the real AG News CSV reader comes when
the data is in the repository)."""
