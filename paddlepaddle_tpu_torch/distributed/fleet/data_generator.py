"""fleet.data_generator (counterpart of
``paddlepaddle_tpu/distributed/fleet/data_generator.py``; reference:
python/paddle/distributed/fleet/data_generator/data_generator.py) — the
streaming slot-format producers the parameter-server DataFeed consumes.
The generator protocol is plain text processing that scripts use on its
own: ``generate_sample`` yields ``[(slot, values), ...]`` records,
``run_from_stdin`` / ``run_from_memory`` emit the MultiSlot DataFeed line
format (``count v1 v2 ...`` per slot)."""

from __future__ import annotations

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator",
           "MultiSlotStringDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        """Override: map one raw input line to a generator of
        [(slot_name, [values...]), ...] records (or None to skip)."""
        raise NotImplementedError(
            "Please rewrite this function to return a list or tuple: "
            "[(name, [feasign, ...]), ...]")

    def generate_batch(self, samples):
        """Override for batch-level processing; default passthrough."""

        def local_iter():
            for sample in samples:
                yield sample

        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "pls use MultiSlotDataGenerator or PairWiseDataGenerator")

    def run_from_stdin(self):
        batch_samples = []
        for line in sys.stdin:
            line_iter = self.generate_sample(line)
            for user_parsed_line in line_iter():
                if user_parsed_line is None:
                    continue
                batch_samples.append(user_parsed_line)
                if len(batch_samples) == self.batch_size_:
                    batch_iter = self.generate_batch(batch_samples)
                    for sample in batch_iter():
                        sys.stdout.write(self._gen_str(sample))
                    batch_samples = []
        if batch_samples:
            batch_iter = self.generate_batch(batch_samples)
            for sample in batch_iter():
                sys.stdout.write(self._gen_str(sample))

    def run_from_memory(self, memory_data=None):
        """Like run_from_stdin but over an in-memory iterable; returns the
        emitted lines (the reference writes to stdout — kept for parity
        when memory_data is None... the reference's memory variant uses
        self.mem_data); here the lines are returned for testability."""
        out = []
        batch_samples = []
        for line in (memory_data or []):
            line_iter = self.generate_sample(line)
            for user_parsed_line in line_iter():
                if user_parsed_line is None:
                    continue
                batch_samples.append(user_parsed_line)
                if len(batch_samples) == self.batch_size_:
                    batch_iter = self.generate_batch(batch_samples)
                    out.extend(self._gen_str(s) for s in batch_iter())
                    batch_samples = []
        if batch_samples:
            batch_iter = self.generate_batch(batch_samples)
            out.extend(self._gen_str(s) for s in batch_iter())
        return out


class MultiSlotDataGenerator(DataGenerator):
    """Emits ``count v1 v2 ...`` per slot (reference _gen_str output
    format, data_generator.py:238), validating a consistent slot order
    across samples."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type")
        if self._proto_info is None:
            self._proto_info = [name for name, _ in line]
        elif [name for name, _ in line] != self._proto_info:
            raise ValueError(
                "the slot order of the sample must be consistent")
        parts = []
        for _, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotStringDataGenerator(MultiSlotDataGenerator):
    """String-feasign variant (reference MultiSlotStringDataGenerator):
    same wire format, values passed through as strings."""
