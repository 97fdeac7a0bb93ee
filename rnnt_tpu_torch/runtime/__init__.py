"""Serving runtimes that read only exported artifacts (no model code)."""
