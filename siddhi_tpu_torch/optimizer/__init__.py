"""Whole-app optimizer passes (port of `siddhi_tpu/optimizer`)."""
from .mqo import MergedGroupRuntime, apply_merge, merge_enabled

__all__ = ["MergedGroupRuntime", "apply_merge", "merge_enabled"]
