"""Detector presets (``presets``)."""
