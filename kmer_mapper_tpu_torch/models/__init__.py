"""The k-mer mapper."""
