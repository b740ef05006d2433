"""Native (C++) host data layer and the scalar single-thread overlapper.

Copy of ``mecat_tpu.native``.  ``get()`` returns the data layer
(``api.NativeLib``): FASTA/FASTQ parsing, 2-bit packing, padded batches,
M4 / candidate / FASTA text, numeric tables, the streaming partition
writer of the correction input and banded edit statistics; the host paths
of the port call it where the original calls its native layer.  Unlike the
original, a failed build raises and nothing switches the library off.
``scalar.ScalarEngine`` is the scalar overlapper (oracle and the bench's
one-core denominator).
"""
from .api import NativeLib, ParsedDB, get

__all__ = ["NativeLib", "ParsedDB", "get"]
