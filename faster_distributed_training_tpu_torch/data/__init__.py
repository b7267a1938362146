"""Data-side helpers of the port (bucketing so far)."""
