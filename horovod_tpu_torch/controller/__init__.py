"""Fusion planning: the bucket planner and its plan cache."""
