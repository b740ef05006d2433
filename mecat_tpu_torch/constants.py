"""Algorithm constants of the overlap and correction paths.

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

# consensus (mecat2cns)
DEFAULT_MIN_COVERAGE = 4              # -c
DEFAULT_MIN_CORRECTED_LENGTH = 500    # -l
DEFAULT_MIN_MAPPING_RATIO = 0.6       # -r
DEFAULT_CNS_MIN_OVERLAP = 500         # -a
#: cap on supporting reads per template pile (highest-scoring kept)
MAX_SUPPORTS_PER_TEMPLATE = 64
#: inserted bases between two template positions that the vote tells apart
MAX_INS_DELTA = 15

# volumes and device batching
DEFAULT_VOLUME_BASES = 1 << 27  # 128 Mbases
#: mecat2cns -p: templates per consensus partition
DEFAULT_PARTITION_BATCH = 100_000

# technology presets (mecat2cns -x): defaults for any flag left unset
TECH_PACBIO = 0
TECH_NANOPORE = 1
CNS_TECH_PRESETS = {
    TECH_PACBIO: dict(min_mapping_ratio=0.9, min_align_size=2000,
                      min_coverage=6, min_length=5000, min_identity=70.0,
                      del_bias=0.65, ins_bias=0.6, pool_min_cov_ins=8,
                      win_radius=4, win_mass_frac=0.6, win_peak_frac=0.35),
    TECH_NANOPORE: dict(min_mapping_ratio=0.4, min_align_size=400,
                        min_coverage=6, min_length=2000, min_identity=60.0,
                        del_bias=0.5, ins_bias=0.7, pool_min_cov_ins=5,
                        win_radius=4, win_mass_frac=0.4, win_peak_frac=0.2),
}
DEFAULT_SCAN_BATCH = 256
DEFAULT_EXTEND_BATCH = 512

M4_IDENTITY_DECIMALS = 2
