"""Algorithm constants of the overlap path.

The values equal those of ``mecat_tpu.constants`` (the reference, where each
carries its provenance notes); ``tests/test_torch_host.py`` holds them equal.
Only the constants the port uses are copied: importing ``mecat_tpu`` runs its
JAX configuration, and the port never imports JAX.
"""

#: code used for non-ACGT input characters before packing
INVALID_BASE_CODE = 0

# k-mer index
KMER_SIZE = 13
KMER_SCAN_STRIDE = 10
#: k-mers more frequent than this multiple of the mean count leave the index
KMER_FREQ_CUTOFF_MULTIPLE = 128.0
#: occurrences gathered per probed k-mer (fixed-shape gather)
MAX_OCC_PER_KMER = 32

# DDF candidate filter
DDF_DIAG_BIN = 256
DEFAULT_NUM_CANDIDATES = 100
MIN_BLOCK_SCORE = 2

# banded aligner
ALIGN_SEGMENT = 512
ALIGN_BAND = 128
MIN_SEGMENT_IDENTITY = 0.65
MIN_OVERLAP_IDENTITY = 70.0
DEFAULT_MIN_ALIGN_SIZE = 2000
#: per-error penalty in the local endpoint score (r + j - 2*penalty*dist)
ALIGN_TRIM_PENALTY = 2

# volumes and device batching
DEFAULT_VOLUME_BASES = 1 << 27  # 128 Mbases
DEFAULT_SCAN_BATCH = 256
DEFAULT_EXTEND_BATCH = 512

M4_IDENTITY_DECIMALS = 2
