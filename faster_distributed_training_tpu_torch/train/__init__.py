"""Training-side helpers of the port (metrics so far)."""
