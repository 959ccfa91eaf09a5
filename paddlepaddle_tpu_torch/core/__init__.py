"""Core subset of the port: flags and the dtype map."""
