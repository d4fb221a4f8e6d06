"""FASTA/FASTQ readers and the device-buffer packer (host numpy)."""
