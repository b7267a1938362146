"""Reporting helpers of the port."""
