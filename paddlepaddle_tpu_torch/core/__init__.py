"""Core subset of the port: flags, the dtype map, the seeded random
streams and the not-ported error."""
