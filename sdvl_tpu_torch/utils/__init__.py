"""Tracing."""
