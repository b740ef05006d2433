"""Host data layer: FASTA/FASTQ, the packed read database, M4 text."""
