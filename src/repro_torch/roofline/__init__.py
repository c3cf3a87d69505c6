"""Roofline of the dry run: per-chip counts of a step and their pricing on the H100."""
