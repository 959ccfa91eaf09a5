"""Placements (counterpart of ``paddlepaddle_tpu/distributed/placement.py``
:11-72): ``Shard(dim)``, ``Replicate()`` and ``Partial(reduce_type)``, with
the reference's equality, hashing and repr."""

from __future__ import annotations


class Placement:
    def is_shard(self, dim=None):
        return False

    def is_replicate(self):
        return False

    def is_partial(self):
        return False


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def get_dim(self):
        return self.dim

    def is_shard(self, dim=None):
        return dim is None or dim == self.dim

    def __eq__(self, other):
        return isinstance(other, Shard) and other.dim == self.dim

    def __hash__(self):
        return hash(("shard", self.dim))

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def is_replicate(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Replicate)

    def __hash__(self):
        return hash("replicate")

    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    """A value that is the partial result of a pending reduction across a
    mesh axis."""

    def __init__(self, reduce_type="sum"):
        self.reduce_type = reduce_type

    def is_partial(self):
        return True

    def __eq__(self, other):
        return isinstance(other, Partial) and other.reduce_type == self.reduce_type

    def __hash__(self):
        return hash(("partial", self.reduce_type))

    def __repr__(self):
        return f"Partial({self.reduce_type})"
