"""Serving path of the port: paged KV bookkeeping, the continuous-batching
decode engine and the serving engine around it."""
