"""Assembly of corrected reads: overlap store, error adjustment, unitigs,
contig consensus and the staged driver."""
