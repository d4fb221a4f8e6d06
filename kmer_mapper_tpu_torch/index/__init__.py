"""Index loading and the block-chained table layout (host numpy)."""
