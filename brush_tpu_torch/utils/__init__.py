"""Utilities (port of brush_tpu/utils/, so far the profiler's stage marks)."""
