"""Shared constants and math helpers."""
