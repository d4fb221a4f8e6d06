"""Host-side observability: wall-clock spans, memory logging, device traces."""
