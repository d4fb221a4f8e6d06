"""torch ops: 32-bit hashing, k-mer hashing, sort + stream count."""
