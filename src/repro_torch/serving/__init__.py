"""Serving: continuous batching over a paged KV pool (Galaxy HMP executor)
and waves over dense caches (the model zoo's ``TransformerExecutor``)."""
