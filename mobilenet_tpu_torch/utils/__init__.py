"""Shared utilities of the port: the per-layer golden comparison."""
