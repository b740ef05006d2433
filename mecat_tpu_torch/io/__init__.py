"""Host data layer: FASTA/FASTQ, the packed read database, M4 and SAM text
(the hot paths in the native C++ layer, ``mecat_tpu_torch.native``)."""
