"""MultiSlot data generators (the port's copy of
``paddle_tpu/incubate/data_generator.py``: ``DataGenerator``,
``MultiSlotDataGenerator``, ``MultiSlotStringDataGenerator``).

Subclass, implement ``generate_sample(line)`` yielding ``[(slot_name,
[values]), ...]`` samples (a generator method, or a callable returning one),
optionally override ``generate_batch`` (called with each ``set_batch``-sized
group), then ``run_from_stdin()`` in a preprocessing job or
``run_from_files`` / ``run_from_memory`` locally. Each sample becomes one
line of the dataset text format that ``dataset_factory`` reads: slot values
space-separated, slots ``;``-separated, in ``set_use_var`` order. The output
is byte-equal to the JAX package's.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Tuple


class DataGenerator:
    def __init__(self):
        self._batch = 1

    def set_batch(self, batch_size):
        """Group size handed to ``generate_batch``."""
        self._batch = max(1, int(batch_size))

    def generate_sample(self, line):
        """Samples for one input line, each [(name, [values...]), ...]: a
        generator method, or a callable returning an iterator."""
        raise NotImplementedError(
            "implement generate_sample(self, line) yielding [(name, [values]), ...] samples")

    def generate_batch(self, samples):
        """Batch hook: a list of ``set_batch`` samples in, an iterable (or a
        callable yielding) of samples to write out."""
        def local_iter():
            yield from samples
        return local_iter

    @staticmethod
    def _as_iter(obj):
        if obj is None:
            return iter(())
        return iter(obj() if callable(obj) else obj)

    def _process(self, lines, write):
        """line -> generate_sample -> generate_batch per group -> one line out per sample."""
        buf: List = []

        def flush():
            for sample in self._as_iter(self.generate_batch(buf)):
                write(self._gen_str(sample))
            buf.clear()

        for line in lines:
            for sample in self._as_iter(self.generate_sample(line)):
                buf.append(sample)
                if len(buf) >= self._batch:
                    flush()
        if buf:
            flush()

    def run_from_stdin(self):
        self._process(sys.stdin, sys.stdout.write)

    def run_from_files(self, filelist, output_path):
        """Every input file through the generator into one dataset file."""
        with open(output_path, "w") as out:
            for path in filelist:
                with open(path) as f:
                    self._process(f, out.write)
        return output_path

    def run_from_memory(self, lines=None, output_path=None):
        """In-memory lines through the generator: the formatted lines, also
        written to ``output_path`` when given."""
        outs: List[str] = []
        self._process(lines if lines is not None else [None], outs.append)
        if output_path:
            with open(output_path, "w") as f:
                f.writelines(outs)
        return outs

    def _gen_str(self, sample: Iterable[Tuple[str, list]]) -> str:
        return ";".join(" ".join(str(v) for v in values) for _name, values in sample) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Numeric slots."""


class MultiSlotStringDataGenerator(DataGenerator):
    """Pre-tokenized string slots; the same output format."""
