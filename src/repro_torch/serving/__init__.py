"""Continuous-batching serving over a paged KV pool, through the Galaxy
HMP executor."""
